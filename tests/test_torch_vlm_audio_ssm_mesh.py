"""The port's vlm (internvl2), audio enc-dec (seamless) and ssm (xlstm)
families trained under a mesh against the JAX package, on the CPU: the
vlm's frontend projection split by columns and gathered over 'model',
then the dense decoder layer; the enc-dec's decoder layer with its
cross-attention against the encoder output; the mLSTM block split by
heads (the segmented w_up, each rank's heads' gates, the row-parallel
w_down) and the sLSTM block (its loop on the rank's heads, y gathered
before the residual, the FFN split or whole by its width); and each
smoke model trained under `--mesh` at (1, 2) and (2, 2) (`family_mesh`:
one JAX subprocess and one gloo world of 4 ranks for the module).

Tolerances, f32, as the other families' mesh tests: each layer's output
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
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model
from repro_torch.parallel import mesh as mesh_lib
from repro_torch.parallel import sharding
from repro_torch.parallel.axes import runtime_mesh
from repro_torch.runtime.trainer import (TrainLayout, full_shapes,
                                         init_train_state, value_and_grad)
from repro_torch.tree import leaves_with_path

MESHES = fm.MESHES
CASES = worlds.VLM_AUDIO_SSM
FULL = [k for k in CASES if worlds.FAMILY_CASES[k].full]
#: (case, layer) of every checked layer
LAYERS = [(k, name) for k in CASES
          for name, _ in worlds.case_layers(worlds.FAMILY_CASES[k])]
#: (component, kind, axis) sites a recorded mesh step must hold
FLOW_SITES = {
    # the frontend projection's gather (the reference's `embed` scope)
    "internvl2_1b": (("embed", "all-gather", "model"),
                     ("attention", "all-reduce", "model"),
                     ("mlp", "all-reduce", "model")),
    "seamless_m4t_large_v2": (("embed", "all-gather", "model"),
                              ("attention", "all-reduce", "model"),
                              ("mlp", "all-reduce", "model")),
    "xlstm_1_3b": (("mlstm", "all-reduce", "model"),
                   ("slstm", "all-gather", "model"),
                   ("slstm", "all-reduce", "model")),
}
#: the leaves a 1x2 checkpoint must hold in the reference's order
RESTORED = {"internvl2_1b": ("frontend/w",),
            "seamless_m4t_large_v2": ("frontend/w", "cross/attn/wq"),
            "xlstm_1_3b": ("mlstm/w_up", "mlstm/w_q", "slstm/r_i",
                           "slstm/w_i")}


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
    d = str(tmp_path_factory.mktemp("vlm_audio_ssm_mesh"))
    inps, ref, ranks = fm.start_cases(
        [worlds.FAMILY_CASES[k] for k in CASES], "vlm_audio_ssm_mesh", d)
    return inps, ref, ranks, d


def cfg(key):
    return worlds._family_cfg(worlds.FAMILY_CASES[key])


# --------------------------------------------------------------- layers ----
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case,layer", LAYERS)
def test_layer_matches_the_reference(run, case, layer, mesh):
    """The checked layer under the mesh: its output and the gradients of
    sum(y ct) (x, a decoder layer's cross source, and each leaf summed
    over 'data' and gathered over 'model' in the reference's order)."""
    _, ref, ranks, _ = run
    want = ref[case][mesh]["layer"][layer]
    for i, r in enumerate(ranks):
        got = r[case][mesh]["layer"][layer]
        assert sorted(k for k in got if k != "table") == sorted(
            k for k in want if k not in ("aux", "table")), sorted(got)
        for key, x in got.items():
            fm.close(x, want[key], what=f"rank {i} {case} {layer} {key}")


# ---------------------------------------------------------------- model ----
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", FULL)
def test_loss_and_grads_match_the_reference(run, case, mesh):
    """The smoke model's loss and every gradient leaf at the reference's
    mesh of the same shape."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close_grads(r[case][mesh]["grads"], ref[case][mesh],
                       what=f"rank {i} {case}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", FULL)
def test_static_costs_are_the_global_ones(run, case, mesh):
    """Every rank registers the one-device loss's costs: all heads, the
    whole widths, the global batch."""
    _, _, ranks, _ = run
    c = cfg(case)
    model = build_model(c, device="cpu")
    STATIC_COSTS.reset()
    value_and_grad(model, model.init(0), SyntheticLMData(
        c, *worlds.FAMILY_CASES[case].batch, seed=3).generate(0), None)
    want = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    for r in ranks:
        fm.static_costs_equal(r[case][mesh]["grads"]["costs"], want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", FULL)
def test_trainer_loss_curve_matches_the_reference(run, case, mesh):
    """Three steps of the port's Trainer under the mesh (ZeRO-1, the
    whole leaves counted once in the grad norm) against the reference's
    step jitted at the same mesh."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close_curve(r[case][mesh]["curve"], ref[case][mesh]["curve"],
                       what=f"rank {i} {case}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", FULL)
def test_recorded_step_has_no_flow_under_app(run, case, mesh):
    """The recorded step's collectives all resolve to the component that
    issued them (the frontend gather under `embed`, the xLSTM blocks'
    under `mlstm` and `slstm`), none to `app`, one per counted call."""
    _, _, ranks, _ = run
    for r in ranks:
        curve = r[case][mesh]["curve"]
        sites = fm.flow_sites(curve)
        assert not [s for s in sites if s[0] == "app"], sites
        for site in FLOW_SITES[case]:
            assert sites[site] > 0, (site, sites)
        assert len(curve["flows"]) == sum(
            mesh_lib.flow_kind_counts(curve["counts"]).values())


@pytest.mark.parametrize("case", FULL)
def test_checkpoint_written_at_1x2_restores_on_one_device(run, case):
    """The 1x2 Trainer's checkpoint holds full leaves: one device restores
    the state the ranks gathered, and the leaves the port places
    otherwise than the reference (the mLSTM's w_up [x | z] by heads, the
    per-head matrices on their head dim) or gathers (the frontend) are
    the reference's after the same steps."""
    _, ref, ranks, d = run
    like = init_train_state(build_model(cfg(case), device="cpu"), 5,
                            TrainConfig())
    ck = CheckpointManager(os.path.join(d, f"ck-{case}-1x2-row0"))
    assert ck.list_steps() == [fm.STEPS - 1]
    state, extra = ck.restore(like)
    assert extra == {"next_step": fm.STEPS}
    written = dict(leaves_with_path(ranks[0][case]["1x2"]["curve"]["state"]))
    want = ref[case]["1x2"]["curve"]["state"]
    checked = 0
    for n, x in leaves_with_path(state):
        assert torch.equal(x, written[n]), n
        if n.endswith(RESTORED[case]):
            fm.close(x, want[n], atol=1e-3, rtol=1e-3, what=n)
            checked += 1
    assert checked >= len(RESTORED[case]), checked


# --------------------------------------------------------------- layout ----
class _Rank:
    """A mesh's sizes and one rank's coordinates, for shard_leaf."""

    def __init__(self, sizes, coords):
        self.sizes, self.coords = sizes, coords

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.sizes.get(a, 1) for a in axes]))

    def coord(self, axes):
        return self.coords.get(axes, 0)


def test_layout_splits_the_xlstm_blocks_by_heads(monkeypatch):
    """At 1x2 the mLSTM's w_up columns [x | z] are Segmented, each half
    split by heads; w_q/k/v and the sLSTM's r_* are split on their head
    dim (the reference's rules split the first p dim); w_gates whole; the
    sLSTM FFN's 2730 columns split at 'model' 2 and whole at 4.
    gather_leaf rebuilds w_up in the reference's [x | z] order."""
    c = get_config("xlstm_1_3b")
    m12 = mesh_lib.Mesh((1, 2), ("data", "model"))
    lay = TrainLayout(build_model(c, device="cpu"), full_shapes(c), m12)
    ml = lay.param["stack_mlstm"]["stack"]["mlstm"]
    sl = lay.param["stack_slstm"]["stack"]["slstm"]
    di = int(c.d_model * c.mlstm_proj_factor)
    seg = sharding.Segmented("model", (di, di), (True, True))
    assert ml["w_up"] == (None, None, None, seg)
    for k in ("w_q", "w_k", "w_v"):
        assert ml[k] == (None, None, "model", None, None), k
    assert sl["r_i"] == (None, "model", None, None)
    assert ml["w_gates"] == (None,) * 4
    assert ml["w_down"] == (None, None, "model", None)
    assert sl["ffn_gate"] == (None, None, "model")      # 2730 = 2 x 1365
    m14 = mesh_lib.Mesh((1, 4), ("data", "model"))
    at4 = TrainLayout(build_model(c, device="cpu"), full_shapes(c), m14)
    assert at4.param["stack_slstm"]["stack"]["slstm"]["ffn_gate"] == \
        (None, None, None), "2730 does not split 4 ways: held whole"
    cols = torch.arange(2 * di)
    x, z = cols.split([di, di])
    half = di // 2
    shards = [sharding.shard_leaf(cols, (seg,), _Rank({"model": 2},
                                                      {"model": r}))
              for r in range(2)]
    for r in range(2):
        assert torch.equal(shards[r], torch.cat(
            [x[r * half:(r + 1) * half], z[r * half:(r + 1) * half]])), r
    monkeypatch.setattr(sharding.mesh_lib, "all_gather",
                        lambda t, mesh, axis, dim=0: torch.cat(shards, dim))
    assert torch.equal(sharding.gather_leaf(
        shards[0], (seg,), _Rank({"model": 2}, {"model": 0})), cols)
    assert sharding.replicated_parts((seg,), m12) == []


@pytest.mark.parametrize("arch", ["internvl2_1b", "seamless_m4t_large_v2",
                                  "xlstm_1_3b"])
def test_train_layout_builds_at_published_widths(arch):
    """TrainLayout admits each family at its published widths on (1, 2)
    and (2, 2): internvl2's 14 q over 2 kv heads give 7 over 1 a rank,
    seamless's 16 and 16 give 8 and 8, xlstm's 4 heads 2."""
    c = get_config(arch)
    model = build_model(c, device="cpu")
    shapes = full_shapes(c)
    for shape in ((1, 2), (2, 2)):
        m = mesh_lib.Mesh(shape, ("data", "model"))
        with runtime_mesh(m):
            lay = TrainLayout(model, shapes, m)
        specs = dict(leaves_with_path(lay.param))
        n = sum(int(np.prod(sharding.local_shape(x.shape, specs[k], m)))
                for k, x in leaves_with_path(shapes))
        assert 0.5 * c.n_params() <= n < c.n_params(), (arch, n)
        assert lay.data_size == shape[0]


# ------------------------------------------------------------- launcher ----
@pytest.mark.parametrize("arch,layers,what", [
    ("seamless_m4t_large_v2", "7", "must be even"),
    ("xlstm_1_3b", "12", "multiple of 8")])
def test_launcher_refuses_a_depth_it_cannot_cut(monkeypatch, capsys, arch,
                                                layers, what):
    """--layers must be even for the enc-dec (half encoder, half decoder
    layers) and a multiple of slstm_every (8) for xlstm-1.3b: a usage
    error, before any model is built."""
    from repro_torch.launch import train
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", arch, "--device", "cpu", "--layers", layers,
        "--steps", "1"])
    with pytest.raises(SystemExit) as err:
        train.main()
    assert err.value.code == 2
    assert what in capsys.readouterr().err


def test_launcher_cuts_the_enc_dec_in_halves():
    """--layers 8 on seamless gives 4 encoder and 4 decoder layers."""
    from repro_torch.launch import train
    c = train.cut_depth(get_config("seamless_m4t_large_v2"), 8)
    assert (c.enc_layers, c.dec_layers, c.n_layers) == (4, 4, 8)
