"""The port's deepseek (MLA + MoE) trained under a mesh against the JAX
package, on the CPU: the MLA layer tensor parallel by heads, the MoE
layers on the a2a dispatch with the shared experts split column/row,
the first dense layer's split MLP, and the smoke deepseek-v2-lite trained
under `--mesh` at (1, 2) and (2, 2) (`family_mesh`: one JAX subprocess,
one gloo world of 4 ranks).

Tolerances, f32, as the MoE family's mesh tests: each layer's output and
gradients, the model's loss and every gradient leaf at atol 1e-5 / rtol
1e-4; the fold table (expert loads and drops exactly, the router losses
at rtol 1e-4); loss curves at rtol 1e-4 (grad norms 1e-3), params after
3 AdamW steps at atol 1e-3.  The config's capacity factor 1.25 binds per
shard in both packages, which drop the same choices of each shard.
"""

import os

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
from repro_torch.runtime.trainer import (TrainLayout, full_shapes,
                                         init_train_state, value_and_grad)
from repro_torch.tree import leaves_with_path

ARCH = "deepseek_v2_lite_16b"
MESHES = fm.MESHES
MLA_KEYS = ["y", "dx", "d_attn_wq", "d_attn_wkv_a", "d_attn_wkv_b",
            "d_attn_wo"]
#: (component, kind, axis) sites a recorded mesh step must hold
FLOW_SITES = {"1x2": (("attention", "all-reduce", "model"),
                      ("mlp", "all-reduce", "model"),
                      ("moe", "all-to-all", "model"),
                      ("moe", "all-gather", "model")),
              "2x2": (("attention", "all-reduce", "model"),
                      ("moe", "all-to-all", "model"),
                      ("grads", "all-reduce", "data"))}


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
    d = str(tmp_path_factory.mktemp("mla_mesh"))
    inp, ref, ranks = fm.start(ARCH, "mla_mesh", d)
    return inp, ref, ranks, d


def cfg():
    return torch_smoke(ARCH)


# --------------------------------------------------------------- layers ----
@pytest.mark.parametrize("key", MLA_KEYS)
@pytest.mark.parametrize("mesh", MESHES)
def test_mla_layer_matches_the_reference(run, mesh, key):
    """The first layer's MLA attention, tensor parallel by heads: its
    output and the gradients of sum(y ct) (x, and each projection
    summed over 'data', gathered over 'model')."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close(r[mesh]["layer"]["mla"][key], ref[mesh]["layer"]["mla"][key],
                 what=f"rank {i} {key}")


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_layer_matches_the_reference(run, mesh):
    """The first MoE layer on the a2a dispatch (64 a shard at (2, 2) with
    E 8, top 2: the capacity binds) with its two shared experts split
    column/row: output, aux loss, every gradient and the fold."""
    _, ref, ranks, _ = run
    want = ref[mesh]["layer"]["moe"]
    for i, r in enumerate(ranks):
        got = r[mesh]["layer"]["moe"]
        keys = sorted(k for k in want if k != "table")
        assert sorted(k for k in got if k != "table") == keys
        for k in keys:
            fm.close(got[k], want[k], what=f"rank {i} {k}")
        fm.close_fold(got["table"], want["table"], cfg().n_experts,
                      what=f"rank {i}")


# ---------------------------------------------------------------- model ----
@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_grads_match_the_reference(run, mesh):
    """The smoke model's loss, aux loss, fold table and every gradient
    leaf at the reference's mesh of the same shape."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close_grads(r[mesh]["grads"], ref[mesh], what=f"rank {i}")
        fm.close_fold(r[mesh]["grads"]["table"], ref[mesh]["table"],
                      cfg().n_experts, what=f"rank {i}")


@pytest.mark.parametrize("mesh", MESHES)
def test_static_costs_are_the_global_ones(run, mesh):
    """Every rank registers the one-device loss's costs: the global
    batch, all 4 heads (the mla_proj and flash edges), the whole d_ff,
    shared experts and vocab."""
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
    """Three steps of the port's Trainer under the mesh against the
    reference's step jitted at the same mesh: losses, aux losses, grad
    norms, the final params and master weights."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        fm.close_curve(r[mesh]["curve"], ref[mesh]["curve"],
                       what=f"rank {i}")


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_fold_invariant_under_a_mesh(run, mesh):
    """Σ expert_load = top_k x tokens x MoE layers x steps on every rank,
    one count a MoE layer and step, and the ranks' tables are equal."""
    _, _, ranks, _ = run
    c = cfg()
    B, S = worlds.FAMILY_BATCH
    moe_layers = c.n_layers - c.first_dense_layers
    tables = []
    for r in ranks:
        edges = {tuple(e[k] for k in ("caller", "component", "api")): e
                 for e in r[mesh]["curve"]["fold"]["edges"]}
        d = edges[("decoder", "moe", "dispatch")]
        loads = [d["metrics"][f"expert_load[{e}]"]
                 for e in range(c.n_experts)]
        assert sum(loads) == c.top_k * B * S * moe_layers * fm.STEPS
        assert d["count"] == moe_layers * fm.STEPS
        tables.append(r[mesh]["curve"]["fold"])
    assert all(t == tables[0] for t in tables)


@pytest.mark.parametrize("mesh", MESHES)
def test_recorded_step_has_no_flow_under_app(run, mesh):
    """The recorded step's collectives all resolve to the component that
    issued them (the MLA layer's under `attention`, the MoE layer's
    under `moe`), none to `app`, and one per counted call."""
    _, _, ranks, _ = run
    for r in ranks:
        curve = r[mesh]["curve"]
        sites = fm.flow_sites(curve)
        assert not [s for s in sites if s[0] == "app"], sites
        for site in FLOW_SITES[mesh]:
            assert sites[site] > 0, (site, sites)
        assert len(curve["flows"]) == sum(
            mesh_lib.flow_kind_counts(curve["counts"]).values())


def test_checkpoint_written_at_1x2_restores_on_one_device(run):
    """The 1x2 Trainer's checkpoint holds full leaves: one device restores
    the state the ranks gathered."""
    _, _, ranks, d = run
    like = init_train_state(build_model(cfg(), device="cpu"), 5,
                            TrainConfig())
    ck = CheckpointManager(os.path.join(d, f"ck-{ARCH}-1x2-row0"))
    assert ck.list_steps() == [fm.STEPS - 1]
    state, extra = ck.restore(like)
    assert extra == {"next_step": fm.STEPS}
    written = dict(leaves_with_path(ranks[0]["1x2"]["curve"]["state"]))
    for n, x in leaves_with_path(state):
        assert torch.equal(x, written[n]), n


def test_layout_splits_mla_by_heads():
    """At 1x2: wq and wkv_b by head-major columns, wo by rows, wkv_a
    whole; the experts over 'model', the shared experts column/row, the
    router whole."""
    model = build_model(cfg(), device="cpu")
    m12 = mesh_lib.Mesh((1, 2), ("data", "model"))
    lay = TrainLayout(model, full_shapes(model.cfg), m12)
    attn = lay.param["stack_moe"]["stack"]["attn"]
    assert attn == {"wq": (None, None, "model"), "wkv_a": (None, None, None),
                    "wkv_b": (None, None, "model"),
                    "wo": (None, "model", None)}
    moe = lay.param["stack_moe"]["stack"]["moe"]
    assert moe["w_up"] == (None, "model", None, None)
    assert moe["shared"]["w_up"] == (None, None, "model")
    assert moe["shared"]["w_down"] == (None, "model", None)
    assert moe["router"] == (None, None, None)
