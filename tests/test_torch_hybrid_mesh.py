"""The port's hybrid (zamba2) trained under a mesh against the JAX
package, on the CPU: the Mamba2 block tensor parallel by ssm heads (the
segmented in_proj and conv_w, the gated norm over the gathered row, the
row-parallel out_proj), the weight-tied shared block's split attention
and MLP, and the smoke zamba2 trained under `--mesh` at (1, 2) and (2, 2)
(`family_mesh`: one JAX subprocess, one gloo world of 4 ranks).

Tolerances, f32, as the dense family's mesh tests: the block's output
and gradients, the model's loss and every gradient leaf at atol 1e-5 /
rtol 1e-4; loss curves at rtol 1e-4 (grad norms 1e-3), params after 3
AdamW steps at atol 1e-3.
"""

import os
import sys

import numpy as np
import pytest
import torch

import family_mesh as fm
import torch_mesh_worlds as worlds
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.parallel import mesh as mesh_lib
from repro_torch.parallel import sharding
from repro_torch.runtime.trainer import (TrainLayout, full_shapes,
                                         init_train_state, value_and_grad)
from repro_torch.tree import leaves_with_path

ARCH = "zamba2_2_7b"
MESHES = fm.MESHES
SSM_KEYS = ["y", "dx", "d_norm1_scale", "d_ssm_in_proj", "d_ssm_conv_w",
            "d_ssm_a_log", "d_ssm_dt_bias", "d_ssm_d_skip", "d_ssm_norm",
            "d_ssm_out_proj"]
#: (component, kind, axis) sites a recorded mesh step must hold: the
#: Mamba2 block's gather of y and its reduces, the shared block's
FLOW_SITES = (("ssm", "all-reduce", "model"), ("ssm", "all-gather", "model"),
              ("attention", "all-reduce", "model"),
              ("mlp", "all-reduce", "model"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs many small ops: one intra-op thread, so that
    they do not contend with the other test workers' threads for the
    cores (the ranks run single-threaded too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hybrid_mesh"))
    inp, ref, ranks = fm.start(ARCH, "hybrid_mesh", d)
    return inp, ref, ranks, d


def cfg():
    return torch_smoke(ARCH)


# ---------------------------------------------------------------- block ----
@pytest.mark.parametrize("key", SSM_KEYS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mamba_block_matches_the_reference(run, mesh, key):
    """The first Mamba2 block, split by ssm heads: its output and the
    gradients of sum(y ct) (x, and each leaf summed over 'data' and
    gathered over 'model' in the reference's column order)."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close(r[mesh]["layer"]["ssm"][key], ref[mesh]["layer"]["ssm"][key],
                 what=f"rank {i} {key}")


# ---------------------------------------------------------------- model ----
@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_grads_match_the_reference(run, mesh):
    """The smoke model's loss and every gradient leaf (the shared block's
    summed over its two calls) at the reference's mesh of the same
    shape."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close_grads(r[mesh]["grads"], ref[mesh], what=f"rank {i}")


@pytest.mark.parametrize("mesh", MESHES)
def test_static_costs_are_the_global_ones(run, mesh):
    """Every rank registers the one-device loss's costs: in_proj,
    out_proj and ssd_scan at all ssm heads, the shared block's at all
    heads, the global batch."""
    _, _, ranks, _ = run
    c = cfg()
    model = build_model(c, device="cpu")
    STATIC_COSTS.reset()
    value_and_grad(model, model.init(0), SyntheticLMData(
        c, *worlds.FAMILY_BATCH, seed=3).generate(0), None)
    want = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    for r in ranks:
        fm.static_costs_equal(r[mesh]["grads"]["costs"], want)


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_loss_curve_matches_the_reference(run, mesh):
    """Three steps of the port's Trainer under the mesh (ZeRO-1 slices the
    segmented leaves on another dim; B and C count once in the grad
    norm) against the reference's step jitted at the same mesh."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close_curve(r[mesh]["curve"], ref[mesh]["curve"],
                       what=f"rank {i}")


@pytest.mark.parametrize("mesh", MESHES)
def test_recorded_step_has_no_flow_under_app(run, mesh):
    """The recorded step's collectives all resolve to the component that
    issued them (the Mamba2 block's under `ssm`), none to `app`, and one
    per counted call."""
    _, _, ranks, _ = run
    for r in ranks:
        curve = r[mesh]["curve"]
        sites = fm.flow_sites(curve)
        assert not [s for s in sites if s[0] == "app"], sites
        for site in FLOW_SITES:
            assert sites[site] > 0, (site, sites)
        assert len(curve["flows"]) == sum(
            mesh_lib.flow_kind_counts(curve["counts"]).values())


def test_checkpoint_written_at_1x2_restores_on_one_device(run):
    """The 1x2 Trainer's checkpoint holds full leaves: one device restores
    the state the ranks gathered, and its in_proj and conv_w are in the
    reference's column order (the reference's state after the same
    steps)."""
    _, ref, ranks, d = run
    like = init_train_state(build_model(cfg(), device="cpu"), 5,
                            TrainConfig())
    ck = CheckpointManager(os.path.join(d, f"ck-{ARCH}-1x2-row0"))
    assert ck.list_steps() == [fm.STEPS - 1]
    state, extra = ck.restore(like)
    assert extra == {"next_step": fm.STEPS}
    written = dict(leaves_with_path(ranks[0]["1x2"]["curve"]["state"]))
    want = ref["1x2"]["curve"]["state"]
    for n, x in leaves_with_path(state):
        assert torch.equal(x, written[n]), n
        if n.endswith(("ssm/in_proj", "ssm/conv_w")):
            fm.close(x, want[n], atol=1e-3, rtol=1e-3, what=n)


class _Rank:
    """A mesh's sizes and one rank's coordinates, for shard_leaf."""

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.sizes.get(a, 1) for a in axes]))

    def coord(self, axes):
        return self.coords.get(axes, 0)


def test_layout_splits_the_mamba2_block_by_heads():
    """At 1x2 the in_proj columns [z | x | B | C | dt] and conv_w
    channels [x | B | C] are Segmented: each rank its heads' z, x and dt
    and the whole B and C, in order; the gated norm's scale whole; a_log
    and out_proj by heads.  B and C are the parts of a rank's slice held
    whole (counted once in the grad norm)."""
    c = cfg()
    model = build_model(c, device="cpu")
    m12 = mesh_lib.Mesh((1, 2), ("data", "model"))
    lay = TrainLayout(model, full_shapes(c), m12)
    ssm = lay.param["stack"]["stack"]["ssm"]
    di, n, H = c.d_inner_, c.ssm_state, c.n_ssm_heads
    seg = ssm["in_proj"][-1]
    assert seg == sharding.Segmented("model", (di, di, n, n, H),
                                     (True, True, False, False, True))
    assert ssm["conv_w"][-1] == sharding.Segmented(
        "model", (di, n, n), (True, False, False))
    assert ssm["norm"] == (None, None, None)
    assert ssm["a_log"] == (None, None, "model")
    assert ssm["out_proj"] == (None, None, "model", None)
    cols = torch.arange(2 * di + 2 * n + H)
    z, x, b, cc, dt = cols.split([di, di, n, n, H])
    for r in range(2):
        got = sharding.shard_leaf(cols, (seg,), _Rank({"model": 2},
                                                      {"model": r}))
        half, hh = di // 2, H // 2
        want = torch.cat([z[r * half:(r + 1) * half],
                          x[r * half:(r + 1) * half], b, cc,
                          dt[r * hh:(r + 1) * hh]])
        assert torch.equal(got, want), r
    assert sharding.replicated_parts((seg,), m12) == [(0, di, n, 2),
                                                    (0, di + n, n, 2)]
    assert sharding.local_shape((7, len(cols)), (None, seg), m12) == \
        (7, di + 2 * n + H // 2)
    zero = lay.opt["stack"]["stack"]["ssm"]["in_proj"]
    assert zero[-1] == seg


def test_train_layout_refuses_the_other_families():
    """Only an MoE mesh whose model axis does not split the experts still
    raises (naming ROADMAP and the a2a dispatch it needs); the vlm,
    enc-dec and xlstm build their layouts at (1, 2) now."""
    m12 = mesh_lib.Mesh((1, 2), ("data", "model"))
    for arch in ("internvl2_1b", "seamless_m4t_large_v2", "xlstm_1_3b"):
        model = build_model(torch_smoke(arch), device="cpu")
        TrainLayout(model, full_shapes(model.cfg), m12)
    ds = build_model(torch_smoke("deepseek_v2_lite_16b"), device="cpu")
    with pytest.raises(NotImplementedError, match="a2a") as err:
        TrainLayout(ds, full_shapes(ds.cfg),
                    mesh_lib.Mesh((2, 1), ("data", "model")))
    assert "ROADMAP" in str(err.value)


def test_launcher_takes_whole_super_blocks(monkeypatch, capsys):
    """--layers for the hybrid must be a multiple of attn_every."""
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--smoke", "--device", "cpu", "--layers",
        "3", "--steps", "1"])
    with pytest.raises(SystemExit) as err:
        train.main()
    assert err.value.code == 2
    assert "multiple of 2" in capsys.readouterr().err
