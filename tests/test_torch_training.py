"""The port's training path against the JAX package, on the CPU.

The JAX model's initial params (or a whole reference train state) are
flattened to numpy by the reference checkpoint naming and carried into
the port; both sides then see the same batches (`SyntheticLMData` is the
same numpy code on both sides).  Tolerances, f32: the loss and every
gradient leaf at atol 1e-5 / rtol 1e-4 (the sides sum in different
orders; the f32 noise at these sizes is ~1e-7); optimizer states after
AdamW steps on the same gradients at atol 1e-6 / rtol 1e-4; N-step loss
curves at rtol 1e-4, and the params after them at atol 1e-3 (a third of
the learning rate: see the test).
The remat policies must give the very same bits on one side.
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

from repro.ckpt.manager import CheckpointManager as JaxCkpt
from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import build_model as jax_build
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.optim import adamw as jax_adamw
from repro.runtime import trainer as jax_trainer
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import (build_model, load_reference_train_state,
                                params_from_numpy, train_state_from_numpy)
from repro_torch.models.layers import cross_entropy, grad_barrier
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import (Trainer, init_train_state,
                                         make_train_step, value_and_grad)
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE_ARCHS = ["tinyllama_1_1b", "qwen3_14b", "starcoder2_7b",
               "granite_20b"]
ATOL, RTOL = 1e-5, 1e-4


def tiny(getter, arch, **kw):
    return dataclasses.replace(getter(arch), n_layers=2, vocab=256, **kw)


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def both(arch="tinyllama_1_1b", **kw):
    """(jax model, jax params, port model, port params), equal weights."""
    jm = jax_build(tiny(jax_smoke, arch, **kw), impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(tiny(torch_smoke, arch, **kw), device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


def batch_of(cfg, B=2, S=12, step=0):
    return JaxData(cfg, B, S, seed=3).generate(step)


def close_tree(port, ref, atol=ATOL, rtol=RTOL):
    """Every leaf of a port tree against a flat reference dict."""
    got = leaves_with_path(port)
    assert sorted(n for n, _ in got) == sorted(ref)
    for name, leaf in got:
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   np.asarray(ref[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


# ----------------------------------------------------------------- model ----
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grads_match_jax(arch):
    jm, jp, tm, tp = both(arch)
    batch = batch_of(jm.cfg)
    batch["mask"][1, 5:] = 0.0              # a masked tail counts nothing
    (jl, (jmet, _)), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    loss, metrics, _, grads = value_and_grad(tm, tp, batch, tm.table())
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    assert float(metrics["tokens"]) == float(jmet["tokens"]) == 17.0
    close_tree(grads, flat_np(jg))


def test_remat_changes_memory_not_the_loss():
    """none / full / dots_saveable: the same loss, the same gradient bits,
    and the same static costs (one forward's worth: the recompute in the
    backward registers nothing)."""
    cfg = tiny(torch_smoke, "qwen3_14b")
    batch = batch_of(cfg)
    params = build_model(cfg, device="cpu").init(0)
    out = {}
    for remat in ("none", "full", "dots_saveable"):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device="cpu")
        STATIC_COSTS.reset()
        loss, _, _, grads = value_and_grad(model, params, batch, None)
        out[remat] = (loss, leaves_with_path(grads),
                      {k: dict(v) for k, v in STATIC_COSTS.costs.items()})
    (l0, g0, c0) = out["none"]
    for remat in ("full", "dots_saveable"):
        l1, g1, c1 = out[remat]
        assert torch.equal(l0, l1), remat
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(g0, g1)), remat
        assert c1 == c0, remat


def test_loss_fn_static_costs_match_one_jax_trace():
    jm, jp, tm, tp = both("qwen3_14b")
    batch = batch_of(jm.cfg)
    JAX_COSTS.reset()
    jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    value_and_grad(tm, tp, batch, None)
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 4
    labels = rng.integers(0, 33, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_grad_barrier_rounds_f32_grads_to_bf16_when_asked():
    cfg = torch_smoke("tinyllama_1_1b")
    x = torch.tensor([1.0 + 2 ** -12, 3.0], requires_grad=True)
    for flag, want in ((False, [1.0 + 2 ** -12, 1.0]), (True, [1.0, 1.0])):
        c = dataclasses.replace(cfg, bf16_grad_reduce=flag)
        y = grad_barrier(x, c)
        assert torch.equal(y, x)
        (g,) = torch.autograd.grad((y * torch.tensor([1.0 + 2 ** -12,
                                                      1.0])).sum(), x)
        assert g.tolist() == want


def test_batch_spec_matches_jax():
    jm, _, tm, _ = both()
    shape = ShapeConfig("t", 64, 4, "train")
    spec = tm.batch_spec(shape)
    for name, s in jm.batch_spec(shape).items():
        assert spec[name][0] == s.shape
        assert str(spec[name][1]).split(".")[-1] == str(s.dtype)


# ------------------------------------------------------------------ data ----
@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 7, 1)])
def test_synthetic_batches_identical(seed, step, shard):
    cfg = torch_smoke("tinyllama_1_1b")
    a = SyntheticLMData(cfg, 4, 32, seed=seed, shard=shard,
                        n_shards=2).generate(step)
    b = JaxData(jax_smoke("tinyllama_1_1b"), 4, 32, seed=seed, shard=shard,
                n_shards=2).generate(step)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# ------------------------------------------------------------- optimizer ----
def test_warmup_cosine_matches_jax():
    cfg = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=20)
    jcfg = JaxTrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=20)
    fn, jfn = adamw.warmup_cosine(cfg), jax_adamw.warmup_cosine(jcfg)
    for step in range(0, 25):
        np.testing.assert_allclose(
            float(fn(torch.tensor(step, dtype=torch.int32))),
            float(jfn(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, 0.0, 1e-3])
def test_adamw_steps_match_jax(clip):
    """Three AdamW steps from carried params and the same gradients:
    params, master, moments and metrics; norms and scales are not
    decayed (the mask by leaf-path token)."""
    jm, jp, tm, tp = both("qwen3_14b")
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                      grad_clip=clip, weight_decay=0.5)
    jcfg = JaxTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                          grad_clip=clip, weight_decay=0.5)
    jstate, state = jax_adamw.init_state(jp), adamw.init_state(tp)
    rng = np.random.default_rng(1)
    for _ in range(3):
        g = {n: rng.standard_normal(x.shape).astype(np.float32)
             for n, x in flat_np(jp).items()}
        jg = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jp),
            [jnp.asarray(g[n]) for n, _ in _flatten(jp)[0]])
        tg = params_from_numpy(g, tm.cfg, "cpu")
        jp, jstate, jmet = jax_adamw.apply_updates(jp, jstate, jg, jcfg)
        tp, state, met = adamw.apply_updates(tp, state, tg, cfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-6)
    close_tree(tp, flat_np(jp), atol=1e-6)
    for kind in ("master", "mu", "nu"):
        close_tree(state[kind], flat_np(jstate[kind]), atol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert adamw._decay_mask("stack/stack/norm1/scale") == 0.0
    assert adamw._decay_mask("stack/stack/attn/q_norm") == 0.0
    assert adamw._decay_mask("stack/stack/attn/wq") == 1.0


def test_int8_grad_compression_is_not_ported():
    """The name is from when int8 compression raised.  It is ported now
    (held to the reference in tests/test_torch_parallel.py and
    tests/test_torch_mesh_training.py): the state carries zero f32
    residues, and a kind the reference lacks raises."""
    tm = build_model(tiny(torch_smoke, "tinyllama_1_1b"), device="cpu")
    state = init_train_state(tm, 0, TrainConfig(grad_compression="int8"))
    assert all(float(e.abs().max()) == 0.0 and e.dtype == torch.float32
               for _, e in leaves_with_path(state["grad_err"]))
    make_train_step(tm, TrainConfig(grad_compression="int8"))
    with pytest.raises(ValueError, match="int4"):
        make_train_step(tm, TrainConfig(grad_compression="int4"))
    with pytest.raises(ValueError, match="int4"):
        init_train_state(tm, 0, TrainConfig(grad_compression="int4"))


# --------------------------------------------------------------- trainer ----
def carried_state(jm, jkey=0):
    """A reference train state and the port's copy of it."""
    tcfg = JaxTrainConfig()
    jstate = jax_trainer.init_train_state(jm, jax.random.key(jkey), tcfg)
    return jstate, flat_np(jstate)


@pytest.mark.parametrize("micro", [1, 2])
def test_loss_curve_tracks_the_reference_trainer(micro, tmp_path):
    """Five steps from carried weights on the same batches: the per-step
    losses of the two step functions, then the reference Trainer's and
    the port Trainer's final metrics and train states."""
    steps = 5
    jm, _, tm, _ = both("tinyllama_1_1b")
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=steps,
              microbatches=micro, ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate, flat = carried_state(jm)
    state = train_state_from_numpy(flat, tm.cfg, "cpu")

    jstep = jax.jit(jax_trainer.make_train_step(jm, jcfg))
    tstep = make_train_step(tm, tcfg)
    js, ts = jstate, state
    for step in range(steps):
        batch = batch_of(jm.cfg, B=4, S=16, step=step)
        js, jmet, _ = jstep(js, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jm.table())
        ts, met, _ = tstep(ts, batch, None)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=RTOL, err_msg=f"step {step}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-3)

    jt = jax_trainer.Trainer(jm, jcfg, JaxCkpt(str(tmp_path / "j")))
    jfinal, jlast = jt.run(jax.random.key(0), JaxData(jm.cfg, 4, 16),
                           steps, resume=False, state=jstate)
    tt = Trainer(tm, tcfg, CheckpointManager(str(tmp_path / "t")))
    tfinal, tlast = tt.run(0, SyntheticLMData(tm.cfg, 4, 16), steps,
                           resume=False,
                           state=train_state_from_numpy(flat, tm.cfg, "cpu"))
    for k in ("loss", "grad_norm", "lr", "tokens"):
        np.testing.assert_allclose(tlast[k], jlast[k], rtol=1e-3, err_msg=k)
    # AdamW moves every element by up to lr per step whatever its gradient's
    # size, so where a gradient element is near 0 the two sides' f32 noise
    # can move that element differently by a fraction of lr (3e-3)
    close_tree(tfinal["params"], {n[len("params/"):]: v for n, v in
                                  flat_np(jfinal).items()
                                  if n.startswith("params/")},
               atol=1e-3, rtol=1e-3)


def test_trainer_resumes_from_its_checkpoint(tmp_path):
    """Four steps in one run equal two steps, then a new Trainer resumed
    from the step-2 checkpoint for two more; the checkpoint is async and
    pruned to keep_last."""
    cfg = tiny(torch_smoke, "tinyllama_1_1b")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4,
                       ckpt_interval=1)

    def run(d, n, resume):
        t = Trainer(build_model(cfg, device="cpu"), tcfg,
                    CheckpointManager(str(tmp_path / d), keep_last=2,
                                      async_save=True))
        return t.run(0, SyntheticLMData(cfg, 2, 8), n, resume=resume)

    whole, m_whole = run("a", 4, False)
    run("b", 2, False)
    resumed, m_res = run("b", 4, True)
    assert m_res == m_whole
    for (n, a), (_, b) in zip(leaves_with_path(whole),
                              leaves_with_path(resumed)):
        assert torch.equal(a, b), n
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000002",
                                                  "step_00000003"]


def test_trainer_streams_its_profile_ring_to_a_collector(tmp_path):
    """xfa_collector with profile_dir: every shard refresh of a 2-step run
    ships to an in-process collector under ("runtime", "profile_publish");
    the spool reduces to the local profile dir's edges and counts."""
    from repro_torch.profile import Collector, load_profile
    cfg = tiny(torch_smoke, "tinyllama_1_1b")
    local = str(tmp_path / "train-run")
    with Collector(str(tmp_path / "spool"), timeout=10.0) as col:
        t = Trainer(build_model(cfg, device="cpu"),
                    TrainConfig(ckpt_interval=0),
                    CheckpointManager(str(tmp_path / "ck")),
                    profile_dir=local, profile_interval=1,
                    xfa_collector="127.0.0.1:%d" % col.port)
        published = []
        publish = t._publisher.publish
        t._publisher.publish = lambda: published.append(publish()) \
            or published[-1]
        t.run(0, SyntheticLMData(cfg, 2, 8), 2, resume=False)
        assert not t._publisher.connected           # closed at run end
    assert [st["errors"] for st in published] == [0, 0, 0]
    assert all(st["pending"] == 0 for st in published)
    spool = str(tmp_path / "spool" / "train-run")
    got, want = (load_profile(d).to_folded() for d in (spool, local))
    assert {k: (e.count, e.total_ns) for k, e in got.edges.items()} == \
        {k: (e.count, e.total_ns) for k, e in want.edges.items()}
    assert want.edges[("app", "runtime", "profile_publish")].count >= 2
    assert os.path.exists(os.path.join(spool, "manifest.json"))


# ----------------------------------------------------------- checkpoints ----
def test_checkpoints_cross_restore_f32(tmp_path):
    """A reference train-state checkpoint restores into the port, and the
    port's checkpoint restores into the reference, leaf for leaf, with
    the same names and files."""
    jm, _, tm, _ = both("qwen3_14b")
    jstate, flat = carried_state(jm, jkey=1)
    JaxCkpt(str(tmp_path / "ref")).save(7, jstate, extra={"next_step": 8})
    like = init_train_state(tm, 5, TrainConfig())
    state, extra = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert extra == {"next_step": 8}
    close_tree(state, flat, atol=0, rtol=0)
    close_tree(load_reference_train_state(str(tmp_path / "ref"), tm.cfg,
                                          "cpu"), flat, atol=0, rtol=0)

    CheckpointManager(str(tmp_path / "port")).save(3, state,
                                                   extra={"next_step": 4})
    back, extra = JaxCkpt(str(tmp_path / "port")).restore(jstate)
    assert extra == {"next_step": 4}
    assert flat_np(back).keys() == flat.keys()
    for name, arr in flat_np(back).items():
        assert arr.dtype == flat[name].dtype and np.array_equal(
            arr, flat[name]), name
    names = lambda d: [e["name"] for e in json.load(open(
        tmp_path / d / os.listdir(tmp_path / d)[0] / "manifest.json"))
        ["leaves"]]
    assert names("port") == names("ref")


def test_port_restores_a_reference_bf16_checkpoint(tmp_path):
    """The reference writes bf16 leaves that its own restore cannot read
    back (ROADMAP.md section 3); the port reads them bit for bit, and its
    own bf16 checkpoints round-trip."""
    cfg_kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jm, _, tm, _ = both("tinyllama_1_1b", **cfg_kw)
    jstate, flat = carried_state(jm)
    JaxCkpt(str(tmp_path / "ref")).save(0, jstate)
    like = init_train_state(tm, 5, TrainConfig())
    state, _ = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert state["params"]["embed"]["table"].dtype == torch.bfloat16
    for name, leaf in leaves_with_path(state):
        want = flat[name]
        if leaf.dtype == torch.bfloat16:
            assert np.array_equal(leaf.view(torch.int16).numpy(),
                                  want.view(np.int16)), name
        else:
            assert np.array_equal(leaf.numpy(), want), name
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(1, state)
    again, _ = mgr.restore(like)
    for (n, a), (_, b) in zip(leaves_with_path(state),
                              leaves_with_path(again)):
        assert a.dtype == b.dtype and torch.equal(a, b), n


# -------------------------------------------------------------- launcher ----
def test_train_launcher_on_the_cpu_and_the_reference_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    prof = tmp_path / "prof"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama_1_1b", "--smoke", "--device", "cpu", "--steps", "3",
         "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-interval", "2", "--profile-dir", str(prof)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: {'loss'" in out.stdout
    assert os.listdir(tmp_path / "ck") == ["step_00000001"]
    rep = subprocess.run(
        [sys.executable, "-m", "repro.profile", "report", str(prof)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert rep.returncode == 0, rep.stderr[-3000:]
    assert "runtime" in rep.stdout and "optimizer" in rep.stdout
