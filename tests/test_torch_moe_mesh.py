"""The port's MoE family under a mesh against the JAX package, on the CPU:
the expert-parallel a2a dispatch of `models/moe.py` and phi3.5-moe
trained under `--mesh`.

The JAX side runs in ONE subprocess with 8 host devices and meshes of
Auto axes (as tests/test_torch_parallel.py builds them); the port's in
one gloo world of 4 ranks (`torch_mesh_worlds.moe_mesh`), whose (1, 2)
mesh runs over the model axis of each data row of its (2, 2) mesh.  Both
start once per module.  Inputs: the smoke phi3.5-moe (E 8, top 2, d
128), the reference's initial train state (carried through numpy) and
its batches.

Tolerances, f32, as the training parity tests: the MoE layer's output,
aux loss and gradients, the model's loss and every gradient leaf at
atol 1e-5 / rtol 1e-4; the fold table (expert loads and drops exactly,
the router losses at rtol 1e-4); loss curves at rtol 1e-4, params after
3 AdamW steps at atol 1e-3 (a third of the learning rate).  The layer
runs at the config's capacity factor 1.25 (binding: both packages drop
the same choices of each shard, at the per-shard capacity) and at 64
(nothing drops), where the a2a layer also equals the one-device dense
layer's output.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worlds as worlds
from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models import build_model as jax_build
from repro.runtime import trainer as jax_trainer
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.models import build_model
from repro_torch.parallel import mesh as mesh_lib
from repro_torch.runtime.trainer import (TrainLayout, full_shapes,
                                         init_train_state)
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4
MESHES = ["1x2", "2x2"]
CFS = list(worlds.MOE_CFS)
STEPS = 3

JAX_SCRIPT = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.ckpt.manager import _flatten
    from repro.configs import get_smoke
    from repro.configs.base import TrainConfig
    from repro.data.pipeline import SyntheticLMData
    from repro.models import build_model
    from repro.models import moe as moe_mod
    from repro.models.layers import Runtime
    from repro.parallel.axes import named_sharding, runtime_mesh
    from repro.runtime import trainer as jt

    CFS, (B, S), STEPS = %(cfs)r, %(batch)r, %(steps)d

    def mesh(shape):
        devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
        return jax.sharding.Mesh(devs, ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)

    inp = dict(np.load(sys.argv[1]))
    x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])
    lp = {"moe": {k: jnp.asarray(inp["moe_" + k])
                  for k in ("router", "w_gate", "w_up", "w_down")}}
    out = {}
    for cf in CFS:
        cfg = dataclasses.replace(get_smoke("phi3_5_moe_42b"),
                                  capacity_factor=cf)
        jm = build_model(cfg, impl="ref")
        rt = Runtime(cfg=cfg, fold_spec=jm.fold_spec)
        for tag, shape, mode in (("1x2", (1, 2), "a2a"),
                                 ("2x2", (2, 2), "a2a"),
                                 ("dense", None, "dense")):
            def run(lp, x, mode=mode, rt=rt, jm=jm):
                def f(lp, x):
                    y, table, aux = moe_mod.moe(lp, x, rt, jm.table(),
                                                mode=mode)
                    return (y, aux), table
                (y, aux), vjp, table = jax.vjp(f, lp, x, has_aux=True)
                g = vjp((ct, jnp.ones((), jnp.float32)))
                return y, aux, table, g
            if shape is None:
                y, aux, table, g = jax.jit(run)(lp, x)
            else:
                with runtime_mesh(mesh(shape)):
                    y, aux, table, g = jax.jit(run)(lp, x)
            res = {"y": y, "aux": aux, "table": table, "dx": g[1]}
            for k in ("router", "w_gate", "w_up", "w_down"):
                res["d_" + k] = g[0]["moe"][k]
            out[(tag, cf)] = {k: np.asarray(v) for k, v in res.items()}

    cfg = get_smoke("phi3_5_moe_42b")
    jm = build_model(cfg, impl="ref")
    params = jm.init(jax.random.key(0))
    batch = {k: jnp.asarray(v)
             for k, v in SyntheticLMData(cfg, B, S, seed=3).generate(0).items()}
    for tag, shape in (("1x2", (1, 2)), ("2x2", (2, 2))):
        def lg(p):
            (loss, (met, table)), g = jax.value_and_grad(
                lambda p: jm.loss_fn(p, batch, jm.table()),
                has_aux=True)(p)
            return loss, met["aux_loss"], table, g
        m = mesh(shape)
        with runtime_mesh(m):
            loss, aux, table, g = jax.jit(lg)(params)
            jcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                               total_steps=STEPS, ckpt_interval=0)
            js = jt.init_train_state(jm, jax.random.key(0), jcfg)
            # the state's shardings in and out, as the reference's
            # Trainer compiles its step: one compile a mesh
            ss = jt.state_shardings(js, m, jcfg.zero1)
            step = jax.jit(jt.make_train_step(jm, jcfg),
                           in_shardings=(ss, jt.batch_shardings(batch, m),
                                         named_sharding()),
                           out_shardings=(ss, None, named_sharding()))
            losses, auxes, norms = [], [], []
            for i in range(STEPS):
                b = {k: jnp.asarray(v) for k, v in SyntheticLMData(
                    cfg, B, S, seed=3).generate(i).items()}
                js, m, _ = step(js, b, jm.table())
                losses.append(float(m["loss"]))
                auxes.append(float(m["aux_loss"]))
                norms.append(float(m["grad_norm"]))
        out[tag] = {"loss": float(loss), "aux_loss": float(aux),
                    "table": np.asarray(table),
                    "grads": {n: np.asarray(a) for n, a in _flatten(g)[0]},
                    "curve": {"loss": losses, "aux_loss": auxes,
                              "grad_norm": norms,
                              "state": {n: np.asarray(a)
                                        for n, a in _flatten(js)[0]}}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("OK")
""") % {"cfs": tuple(CFS), "batch": worlds.MOE_BATCH, "steps": STEPS}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs many small ops: one intra-op thread, so that
    they do not contend with the other test workers' threads for the
    cores (the ranks run single-threaded too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def _inputs(path):
    """The first MoE layer's weights of the reference's initial params, a
    layer input of 256 tokens (64 a shard at (2, 2), where the default
    capacity binds), its output's cotangent (that of a mean over the
    tokens), and the initial train state."""
    rng = np.random.default_rng(0)
    jm = jax_build(jax_smoke("phi3_5_moe_42b"), impl="ref")
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0),
                                          JaxTrainConfig())
    state = flat_np(jstate)
    arrays = {"x": rng.standard_normal((4, 64, 128)).astype(np.float32),
              "ct": (rng.standard_normal((4, 64, 128)) / 256).astype(
                  np.float32),
              **{f"s/{n}": a for n, a in state.items()}}
    for k in ("router", "w_gate", "w_up", "w_down"):
        arrays[f"moe_{k}"] = state[f"params/stack_moe/stack/moe/{k}"][0]
    np.savez(path, **arrays)
    return arrays


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the JAX subprocess's results, the port ranks' results,
    the world's directory)."""
    d = str(tmp_path_factory.mktemp("moe_mesh"))
    inp = _inputs(os.path.join(d, "inputs.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, os.path.join(d, "inputs.npz"),
         os.path.join(d, "jax.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs = worlds.start_world("moe_mesh", 4, d)
    try:
        worlds.join(procs, d, "moe_mesh")
        _, err = jax_proc.communicate(timeout=worlds.JOIN_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    with open(os.path.join(d, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    ranks = [torch.load(os.path.join(d, f"moe_mesh-rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    return inp, ref, ranks, d


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def close_fold(got, want, what=""):
    """Fold tables: expert loads, drops and counts exactly; the router
    losses (slots E + 1 and E + 2) at rtol 1e-4."""
    got = torch.as_tensor(got).double().numpy()
    want = np.asarray(want, np.float64)
    E = torch_smoke("phi3_5_moe_42b").n_experts
    exact = np.r_[np.arange(E + 1), np.arange(E + 3, len(want))]
    np.testing.assert_array_equal(got[exact], want[exact], err_msg=what)
    np.testing.assert_allclose(got[E + 1:E + 3], want[E + 1:E + 3],
                               rtol=RTOL, err_msg=what)


LAYER_KEYS = ["y", "aux", "dx", "d_router", "d_w_gate", "d_w_up",
              "d_w_down"]


# --------------------------------------------------------------- layer ----
@pytest.mark.parametrize("key", LAYER_KEYS)
@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mesh", MESHES)
def test_a2a_layer_matches_the_reference(run, mesh, cf, key):
    """The a2a MoE layer's output, aux loss and gradients (of sum(y ct) +
    aux) equal the reference's a2a layer at the same mesh: at 1.25 both
    drop the same choices of each shard."""
    _, ref, ranks, _ = run
    for i, r in enumerate(ranks):
        close(r[mesh]["layer"][cf][key], ref[(mesh, cf)][key],
              what=f"rank {i} {key}")


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("mesh", MESHES)
def test_a2a_fold_matches_the_reference(run, mesh, cf):
    """The fold: loads and drops summed over every token shard, aux and z
    averaged over them; every rank holds the global table."""
    _, ref, ranks, _ = run
    for r in ranks:
        close_fold(r[mesh]["layer"][cf]["table"], ref[(mesh, cf)]["table"])


def test_default_capacity_binds_per_shard(run):
    """At 1.25 the shards' capacity (max(8, int(t_loc k / E cf))) binds,
    and it is not the one-device dense capacity, so a2a and dense drop
    different numbers of choices (the reason a mesh run is compared with
    a one-device run only drop-free); the port drops the reference's.
    At 64 nothing drops."""
    _, ref, ranks, _ = run
    E = torch_smoke("phi3_5_moe_42b").n_experts
    drops = {tag: ref[(tag, 1.25)]["table"][E] for tag in MESHES + ["dense"]}
    assert all(n > 0 for n in drops.values()), drops
    assert drops["2x2"] != drops["dense"], drops
    for mesh in MESHES:
        assert float(ranks[0][mesh]["layer"][1.25]["table"][E]) == \
            drops[mesh]
    for tag in MESHES + ["dense"]:
        assert ref[(tag, 64.0)]["table"][E] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_a2a_equals_dense_drop_free(run, mesh):
    """Nothing dropped, the a2a layer computes the dense layer's function:
    the port's a2a output equals the reference's one-device dense output
    and the port's own dense layer's."""
    _, ref, ranks, _ = run
    got = ranks[0][mesh]["layer"][64.0]["y"]
    close(got, ref[("dense", 64.0)]["y"], what="vs the reference's dense")
    close(got, ranks[0]["dense"][64.0]["y"], what="vs the port's dense")


def test_dense_layer_matches_the_reference(run):
    _, ref, ranks, _ = run
    for cf in CFS:
        for key in LAYER_KEYS:
            close(ranks[0]["dense"][cf][key], ref[("dense", cf)][key],
                  what=f"{cf} {key}")
        close_fold(ranks[0]["dense"][cf]["table"], ref[("dense", cf)]["table"])


# --------------------------------------------------------------- model ----
@pytest.mark.parametrize("mesh", MESHES)
def test_loss_and_grads_match_the_reference(run, mesh):
    """The smoke model's loss, aux loss, fold table and every gradient
    leaf (summed over 'data', gathered over 'model') at the reference's
    mesh of the same shape."""
    _, ref, ranks, _ = run
    for r in ranks:
        got, want = r[mesh]["grads"], ref[mesh]
        close(got["loss"], want["loss"], what="loss")
        close(got["aux_loss"], want["aux_loss"], what="aux_loss")
        close_fold(got["table"], want["table"])
        grads = dict(leaves_with_path(got["grads"]))
        assert sorted(grads) == sorted(want["grads"])
        for name, g in grads.items():
            close(g, want["grads"][name], what=name)


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_loss_curve_matches_the_reference(run, mesh):
    """Three steps of the port's Trainer under the mesh against the
    reference's jitted step at the same mesh shape: losses, aux losses,
    grad norms, the final params and master weights."""
    _, ref, ranks, _ = run
    want = ref[mesh]["curve"]
    for r in ranks:
        got = r[mesh]["curve"]
        close(got["loss"], want["loss"], atol=0, what="loss")
        close(got["aux_loss"], want["aux_loss"], atol=0, what="aux_loss")
        close(got["grad_norm"], want["grad_norm"], atol=0, rtol=1e-3,
              what="grad_norm")
        state = dict(leaves_with_path(got["state"]))
        for n, x in state.items():
            if n.startswith(("params/", "opt/master/")):
                close(x, want["state"][n], atol=1e-3, rtol=1e-3, what=n)
        assert int(state["opt/step"]) == STEPS


@pytest.mark.parametrize("mesh", MESHES)
def test_trainer_fold_invariant_under_a_mesh(run, mesh):
    """Σ expert_load = top_k x tokens x MoE layers x steps, on every rank,
    and the ranks' tables are equal (rank 0's shard is the run's)."""
    _, _, ranks, _ = run
    cfg = torch_smoke("phi3_5_moe_42b")
    B, S = worlds.MOE_BATCH
    tables = []
    for r in ranks:
        edges = {tuple(e[k] for k in ("caller", "component", "api")): e
                 for e in r[mesh]["curve"]["fold"]["edges"]}
        d = edges[("decoder", "moe", "dispatch")]
        loads = [d["metrics"][f"expert_load[{e}]"]
                 for e in range(cfg.n_experts)]
        assert sum(loads) == cfg.top_k * B * S * cfg.n_layers * STEPS
        assert d["count"] == cfg.n_layers * STEPS
        tables.append(r[mesh]["curve"]["fold"])
    assert all(t == tables[0] for t in tables)


def test_checkpoint_written_at_1x2_restores_on_one_device(run):
    """The 1x2 Trainer's checkpoint holds full leaves: one device restores
    the state the ranks gathered."""
    _, _, ranks, d = run
    cfg = torch_smoke("phi3_5_moe_42b")
    like = init_train_state(build_model(cfg, device="cpu"), 5, TrainConfig())
    ck = CheckpointManager(os.path.join(d, "ck-1x2-row0"))
    assert ck.list_steps() == [2]
    state, extra = ck.restore(like)
    assert extra == {"next_step": 3}
    written = dict(leaves_with_path(ranks[0]["1x2"]["curve"]["state"]))
    for n, x in leaves_with_path(state):
        assert torch.equal(x, written[n]), n


# ------------------------------------------------------------- layouts ----
def test_train_layout_admits_moe_and_refuses_the_rest():
    """phi3.5-moe and deepseek (MLA) train under a mesh whose model axis
    splits their experts; one rank there raises.  The vlm family, refused
    before its tensor-parallel hooks, builds its layout now (its frontend
    projection split by columns)."""
    m12 = mesh_lib.Mesh((1, 2), ("data", "model"))
    m21 = mesh_lib.Mesh((2, 1), ("data", "model"))
    moe = build_model(torch_smoke("phi3_5_moe_42b"), device="cpu")
    lay = TrainLayout(moe, full_shapes(moe.cfg), m12)
    assert lay.param["stack_moe"]["stack"]["moe"]["w_up"] == \
        (None, "model", None, None)
    assert lay.param["stack_moe"]["stack"]["moe"]["router"] == (None, None,
                                                                None)
    with pytest.raises(NotImplementedError, match="a2a"):
        TrainLayout(moe, full_shapes(moe.cfg), m21)
    mla = build_model(torch_smoke("deepseek_v2_lite_16b"), device="cpu")
    lay = TrainLayout(mla, full_shapes(mla.cfg), m12)
    assert lay.param["stack_moe"]["stack"]["attn"]["wkv_b"] == \
        (None, None, "model")
    vlm = build_model(torch_smoke("internvl2_1b"), device="cpu")
    lay = TrainLayout(vlm, full_shapes(vlm.cfg), m12)
    assert lay.param["frontend"]["w"] == (None, "model")


def test_dense_dispatch_under_a_splitting_mesh_raises():
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel.axes import runtime_mesh
    cfg = torch_smoke("phi3_5_moe_42b")
    model = build_model(cfg, device="cpu")
    p = {"moe": {k: v[0] for k, v in model.init(0)["stack_moe"]["stack"]
                 ["moe"].items()}}
    x = torch.zeros(2, 4, cfg.d_model)
    with runtime_mesh(mesh_lib.Mesh((2, 1), ("data", "model"))):
        with pytest.raises(NotImplementedError, match="a2a"):
            moe_lib.moe(p, x, model.rt, None)
    with pytest.raises(ValueError, match="mode"):
        moe_lib.moe(p, x, model.rt, None, mode="ep")


def test_a2a_mode_without_a_mesh_is_one_shard():
    """mode='a2a' without a mesh: one shard, its capacity max(8, int(T k
    / E cf)); drop-free it equals the dense layer."""
    import dataclasses
    from repro_torch.models import moe as moe_lib
    cfg = dataclasses.replace(torch_smoke("phi3_5_moe_42b"),
                              capacity_factor=64.0)
    model = build_model(cfg, device="cpu")
    p = {"moe": {k: v[0] for k, v in model.init(0)["stack_moe"]["stack"]
                 ["moe"].items()}}
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    ya, ta, aa = moe_lib.moe(p, x, model.rt, model.table(), mode="a2a")
    yd, td, ad = moe_lib.moe(p, x, model.rt, model.table(), mode="dense")
    close(ya, yd.detach())
    assert torch.equal(ta, td) and torch.equal(aa, ad)
