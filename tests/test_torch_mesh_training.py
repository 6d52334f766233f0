"""The port's training under a mesh against the JAX package's one-device
training, on the CPU.

Two gloo worlds run once per module (`torch_mesh_worlds.training`): 2
ranks at 1x2 (tensor parallel) then 2x1 (data parallel, ZeRO-1), and 4
ranks at 2x2.  Each takes the reference's initial train state (carried
through numpy, as tests/test_torch_training.py does) and the reference's
batches, and its results are held to the JAX package's one-device run on
the same global batch.  Tolerances, f32, as the training parity tests:
the loss and every gradient leaf at atol 1e-5 / rtol 1e-4; loss curves
at rtol 1e-4 (grad norms 1e-3); params after 3 AdamW steps at atol
1e-3 (a third of the learning rate: AdamW moves every element by up to
lr whatever its gradient's size).  Static costs must be the global
batch's.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worlds as worlds
from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import build_model as jax_build
from repro.parallel import sharding as jax_sharding
from repro.runtime import trainer as jax_trainer
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model, train_state_from_numpy
from repro_torch.parallel import mesh as mesh_lib
from repro_torch.runtime.trainer import (Trainer, TrainLayout, full_shapes,
                                         init_train_state, value_and_grad)
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4
MESHES = ["1x2", "2x1", "2x2"]
STEPS = 3


def tiny(getter, **kw):
    return dataclasses.replace(getter("tinyllama_1_1b"), n_layers=2,
                               vocab=256, **kw)


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def batch_of(cfg, B=4, S=16, step=0):
    return JaxData(cfg, B, S, seed=3).generate(step)


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def close_tree(port, ref, atol=ATOL, rtol=RTOL):
    got = dict(leaves_with_path(port))
    assert sorted(got) == sorted(ref)
    for name, leaf in got.items():
        close(leaf, ref[name], atol, rtol, what=name)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs many small ops (tiny layers): one intra-op
    thread, so that they do not contend with the other test workers'
    threads for the cores (the ranks run single-threaded too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def initial(jm):
    """The reference's initial train state and the loss batch (a masked
    tail counts nothing)."""
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0),
                                          JaxTrainConfig())
    batch = batch_of(jm.cfg, B=4, S=12)
    batch["mask"][1, 5:] = 0.0
    return jstate, batch


@pytest.fixture(scope="module")
def worlds_started(tmp_path_factory):
    """The two gloo worlds, started on the reference's initial state (they
    run while the `ref` fixture computes the JAX side)."""
    jstate, batch = initial(jax_build(tiny(jax_smoke), impl="ref"))
    dirs = {w: str(tmp_path_factory.mktemp(f"training{w}")) for w in (2, 4)}
    for d in dirs.values():
        np.savez(os.path.join(d, "inputs.npz"),
                 **{f"s/{n}": a for n, a in flat_np(jstate).items()},
                 **{f"batch_{n}": a for n, a in batch.items()})
    procs = {w: worlds.start_world("training", w, d)
             for w, d in dirs.items()}
    yield dirs, procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ref(worlds_started):
    """The JAX package's one-device results: the initial train state, the
    loss and gradients of one batch, and each curve's losses, grad norms
    and final state."""
    jm = jax_build(tiny(jax_smoke), impl="ref")
    jstate, batch = initial(jm)
    (loss, (met, _)), g = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        jm.table())
    curves = {}
    for mode, kw in worlds.CURVES.items():
        if mode == "deferred":
            # the reference's deferred step differs from its per-microbatch
            # one only in where a mesh would reduce: one device computes
            # the same numbers either way
            continue
        jcfg = JaxTrainConfig(learning_rate=3e-3, warmup_steps=2,
                              total_steps=STEPS, ckpt_interval=0, **kw)
        js = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
        step = jax.jit(jax_trainer.make_train_step(jm, jcfg))
        losses, norms = [], []
        for i in range(STEPS):
            js, m, _ = step(js, {k: jnp.asarray(v) for k, v in
                                 batch_of(jm.cfg, step=i).items()},
                            jm.table())
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        curves[mode] = {"loss": losses, "grad_norm": norms,
                        "state": flat_np(js)}
    curves["deferred"] = curves["micro2"]
    # the port's one-device static costs of the same loss
    cfg = tiny(torch_smoke)
    STATIC_COSTS.reset()
    value_and_grad(build_model(cfg, device="cpu"), train_state_from_numpy(
        flat_np(jstate), cfg, "cpu")["params"], batch, None)
    costs = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    return {"state": flat_np(jstate), "batch": batch, "loss": float(loss),
            "tokens": float(met["tokens"]), "grads": flat_np(g),
            "curves": curves, "costs": costs}


@pytest.fixture(scope="module")
def run(worlds_started, ref):
    """Each world's rank-0 results (ranks agree: every gathered value is
    the same on each), and the run directories."""
    dirs, procs = worlds_started
    for w, d in dirs.items():
        worlds.join(procs[w], d, "training")
    out = {}
    for w, d in dirs.items():
        ranks = [torch.load(os.path.join(d, f"training-rank{r}.pt"))
                 for r in range(w)]
        out.update(ranks[0])
        out[f"ranks{w}"] = ranks
    out["dirs"] = dirs
    return out


# ------------------------------------------------------ loss and grads ----
@pytest.mark.parametrize("mesh,manual", [("1x2", 0), ("2x1", 0), ("2x2", 0),
                                         ("1x2", 1), ("2x2", 1)])
def test_loss_and_grads_match_jax(run, ref, mesh, manual):
    """The global batch's loss, token count and every gradient leaf
    (summed over 'data', gathered over 'model') equal the one device's;
    manual=1 runs the MLPs through col_row_mlp."""
    got = run[mesh][f"grads_manual{manual}"]
    close(got["loss"], ref["loss"], what="loss")
    assert float(got["tokens"]) == ref["tokens"] == 4 * 12 - 7
    close_tree(got["grads"], ref["grads"])


@pytest.mark.parametrize("mesh", MESHES)
def test_static_costs_are_the_global_batchs(run, ref, mesh):
    """Every rank registers the costs one trace of the reference's SPMD
    program does: the global batch, all heads, the whole d_ff and vocab."""
    want = ref["costs"]
    got = run[mesh]["grads_manual0"]["costs"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]), k
        for m in want[k]:
            assert got[k][m] == pytest.approx(want[k][m], rel=1e-12), (k, m)


# -------------------------------------------------------------- curves ----
@pytest.mark.parametrize("mode", list(worlds.CURVES))
@pytest.mark.parametrize("mesh", MESHES)
def test_loss_curve_matches_the_reference_step(run, ref, mesh, mode):
    """Three steps of the port's step under the mesh against the
    reference's jitted step on one device: losses, grad norms, and the
    final params and optimizer state (gathered)."""
    got, want = run[mesh]["curves"][mode], ref["curves"][mode]
    close(got["loss"], want["loss"], atol=0, what="loss")
    close(got["grad_norm"], want["grad_norm"], atol=0, rtol=1e-3,
          what="grad_norm")
    state = dict(leaves_with_path(got["state"]))
    assert sorted(state) == sorted(want["state"])
    for n, x in state.items():
        if n.startswith(("params/", "opt/master/")):
            close(x, want["state"][n], atol=1e-3, rtol=1e-3, what=n)
    assert int(state["opt/step"]) == STEPS


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_zero1_slices_follow_the_reference_rule(run, mesh):
    """Each rank holds master, mu and nu sliced over 'data' as the
    reference's `state_shardings` places them (`_apply_fsdp` on the
    params' spec): the local shape is the full shape cut by every axis
    of the reference's fsdp spec."""
    shape = tuple(int(x) for x in mesh.split("x"))

    class Duck:
        axis_names = ("data", "model")
        devices = np.zeros(shape)
    jm = jax_build(tiny(jax_smoke), impl="ref")
    abstract = jax.eval_shape(jm.init, jax.random.key(0))
    specs = jax.tree_util.tree_flatten_with_path(
        jax_sharding.spec_tree(abstract, Duck(), fsdp=True),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    sizes = dict(zip(Duck.axis_names, shape))
    full = {n: tuple(a.shape) for n, a in _flatten(abstract)[0]}
    for ranks in (run["ranks2"] if mesh == "2x1" else run["ranks4"],):
        for r in ranks:
            got = r[mesh]["curves"]["plain"]["master_shapes"]
            for path, spec in specs:
                name = jax_sharding._path_str(path)[1:]
                want = tuple(
                    n // (sizes[p] if isinstance(p, str) else
                          int(np.prod([sizes[a] for a in p])))
                    if p is not None else n
                    for n, p in zip(full[name], tuple(spec) + (None,) * (
                        len(full[name]) - len(spec))))
                assert got[name] == want, (name, got[name], want)
    # ZeRO over 2 data ranks halves every master leaf of this model
    assert all(any(p == "data" for p in tuple(s)) for _, s in specs)


@pytest.mark.parametrize("mesh", ["2x1", "2x2"])
def test_deferred_reduce_sums_the_gradient_once(run, mesh):
    """Per microbatch: one all-reduce a leaf after each of the 2
    microbatches; deferred: one a leaf after the loop.  Everything else
    in the step is the same."""
    curves = run[mesh]["curves"]
    n = curves["micro2"]["n_leaves"]
    for i in range(STEPS):
        per = curves["micro2"]["counts"][i]["all_reduce"]
        once = curves["deferred"]["counts"][i]["all_reduce"]
        assert per - once == n, (per, once, n)
        assert curves["micro2"]["counts"][i]["all_gather"] == \
            curves["deferred"]["counts"][i]["all_gather"] > 0


def test_tensor_parallel_step_reduces_no_gradient_over_data(run):
    """At 1x2 there is no data axis: the step's all-reduces are the
    layers' own (and the norm's), the same with and without deferral,
    and ZeRO gathers nothing."""
    curves = run["1x2"]["curves"]
    assert curves["micro2"]["counts"] == curves["deferred"]["counts"]
    assert all(c["all_gather"] == 0 for c in curves["plain"]["counts"])


# ---------------------------------------------------------- checkpoint ----
def test_checkpoint_written_at_1x2_restores_at_2x1(run):
    written = dict(leaves_with_path(run["1x2"]["ckpt_state"]))
    restored = dict(leaves_with_path(run["restored_2x1"]["state"]))
    assert sorted(written) == sorted(restored)
    for n in written:
        assert torch.equal(written[n], restored[n]), n
    assert run["restored_2x1"]["extra"] == {"next_step": 2}


def test_checkpoint_written_at_1x2_restores_on_one_device(run):
    """The files hold full leaves in the reference's layout: the one
    device's restore (and the reference's naming) reads them whole."""
    cfg = tiny(torch_smoke)
    model = build_model(cfg, device="cpu")
    like = init_train_state(model, 5, TrainConfig())
    ck = CheckpointManager(os.path.join(run["dirs"][2], "ck"))
    assert ck.list_steps() == [1]
    state, extra = ck.restore(like)
    assert extra == {"next_step": 2}
    written = dict(leaves_with_path(run["1x2"]["ckpt_state"]))
    for n, x in leaves_with_path(state):
        assert torch.equal(x, written[n]), n


# ------------------------------------------------------------- profile ----
def test_profile_shards_hold_replicated_folds_on_rank0_only(run):
    from repro_torch.profile import ProfileSnapshot, RunManifest
    prof = os.path.join(run["dirs"][2], "prof")
    shards = sorted(f for f in os.listdir(prof) if f.endswith(".xfa.npz"))
    assert [s.split("-")[0] + "-" + s.split("-")[1] for s in shards] == \
        ["train-r0", "train-r1"]
    snaps = [ProfileSnapshot.load(os.path.join(prof, s)) for s in shards]
    edges = [set(snap.to_folded().edges) for snap in snaps]
    # the device fold's train_step count and the static optimizer cost
    for replicated in (("app", "loss", "train_step"),
                       ("optimizer", "optimizer", "adamw")):
        assert replicated in edges[0] and replicated not in edges[1]
    # each rank's own host edges are in its own shard
    assert ("app", "runtime", "dispatch_step") in edges[1]
    assert [s.meta["rank"] for s in snaps] == [0, 1]
    m = RunManifest.load(prof)
    assert tuple(m.mesh_shape) == (1, 2)
    assert tuple(m.mesh_axes) == ("data", "model")
    assert sorted(w["label"] for w in m.writers) == ["train-r0", "train-r1"]


def test_report_merges_both_rank_shards(run):
    prof = os.path.join(run["dirs"][2], "prof")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    rep = subprocess.run([sys.executable, "-m", "repro_torch.profile",
                          "report", prof, "--json"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert rep.returncode == 0, rep.stderr[-2000:]
    meta = json.loads(rep.stdout)["meta"]
    assert meta["n_shards"] == 2
    assert sorted(meta["merged_from"]) == ["train-r0", "train-r1"]


# ------------------------------------------------------------- trainer ----
def test_other_families_raise_under_a_mesh():
    """What still raises under a mesh: an MoE model whose 'model' axis
    does not split its experts (2x1: the dense dispatch over split
    tokens is not ported), naming ROADMAP.  Every family builds its
    layout at (1, 2) (the vlm, enc-dec and xlstm since their tensor
    parallel hooks, tests/test_torch_vlm_audio_ssm_mesh.py)."""
    m12 = mesh_lib.Mesh((1, 2), ("data", "model"))
    for arch in ("internvl2_1b", "seamless_m4t_large_v2", "xlstm_1_3b",
                 "tinyllama_1_1b", "zamba2_2_7b", "phi3_5_moe_42b"):
        model = build_model(torch_smoke(arch), device="cpu")
        lay = TrainLayout(model, full_shapes(model.cfg), m12)
        assert lay.data_size == 1, arch
    moe = build_model(torch_smoke("phi3_5_moe_42b"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP") as err:
        TrainLayout(moe, full_shapes(moe.cfg),
                    mesh_lib.Mesh((2, 1), ("data", "model")))
    assert "dense dispatch" in str(err.value), str(err.value)


def test_one_device_int8_trainer_follows_the_reference_trainer(ref,
                                                               tmp_path):
    """No mesh: the port's Trainer with int8 compression (2 microbatches,
    deferred) against the reference's jitted step, from the same state:
    the losses, and the error-feedback residues after the run."""
    cfg = tiny(torch_smoke)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=STEPS,
                       ckpt_interval=0, **worlds.CURVES["deferred_int8"])
    want = ref["curves"]["deferred_int8"]
    state = train_state_from_numpy(ref["state"], cfg, "cpu")
    from repro_torch.optim import adamw
    state["grad_err"] = adamw.init_error_state(state["params"])
    t = Trainer(build_model(cfg, device="cpu"), tcfg,
                CheckpointManager(str(tmp_path / "ck")))
    final, _ = t.run(0, SyntheticLMData(cfg, 4, 16, seed=3), STEPS,
                     resume=False, state=state)
    close([h["loss"] for h in t.history], want["loss"], atol=0, what="loss")
    # the residues: f32 noise between the two sides moves an element
    # sitting at a rounding boundary of the quantizer by one quantum (the
    # residue spans one quantum, so its range sets it); any other element
    # agrees to f32 rounding
    got = final["grad_err"]["stack"]["stack"]["mlp"]["w_up"].numpy()
    want_err = want["state"]["grad_err/stack/stack/mlp/w_up"]
    quantum = float(want_err.max() - want_err.min())
    off = np.abs(got - want_err)
    assert off.max() <= quantum * 1.01
    assert np.mean(off > 1e-6 + 1e-3 * np.abs(want_err)) < 1e-3


def test_train_launcher_under_a_mesh_on_the_cpu(tmp_path):
    """torchrun, 2 ranks at 2x1 over gloo, through the launcher (2
    microbatches, deferred reduce, int8): each rank's history has the
    losses of the one-device Trainer from the same seed and batches."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    two = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
         "--steps", "2", "--batch", "4", "--seq", "16",
         "--ckpt-interval", "0", "--microbatches", "2",
         "--grad-compression", "int8", "--deferred-grad-reduce",
         "--mesh", "2x1", "--ckpt-dir", str(tmp_path / "ck"),
         "--metrics-out", str(tmp_path / "m")], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    cfg = torch_smoke("tinyllama_1_1b")
    t = Trainer(build_model(cfg, device="cpu"), TrainConfig(
        total_steps=2, warmup_steps=1, ckpt_interval=0, microbatches=2,
        deferred_grad_reduce=True, grad_compression="int8"),
        CheckpointManager(str(tmp_path / "one")))
    t.run(0, SyntheticLMData(cfg, 4, 16), 2, resume=False)
    want = [h["loss"] for h in t.history]
    for r in range(2):
        with open(tmp_path / "m" / f"rank{r}.json") as f:
            got = json.load(f)
        assert got["mesh"] == "2x1" and got["collectives"]["all_reduce"] > 0
        close([h["loss"] for h in got["history"]], want, atol=0, rtol=1e-5)
