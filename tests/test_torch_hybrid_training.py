"""The port's hybrid training path (zamba2: Mamba2 layers + a shared
attention block) against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages; the
JAX side runs as its own tests run it (`impl="ref"`: it differentiates
`ref.ssd_chunked` with JAX autodiff).  The port runs its default
`impl="auto"`, so on the CPU the SSD scan goes through `SSDScan` with the
plain backward `ref.ssd_scan_backward`.  Tolerances:

* SSD backward, f32: 1e-5 rel, and 1e-5 abs relative to each gradient's
  largest entry, against torch autograd of the port's `ref.ssd_chunked`
  and against `jax.vjp` of the reference's.  Every version computes in
  f32; they differ by the order of their sums.  ddt sums terms of its
  row's scale (up to ~260 here), so an entry near 0 carries their
  rounding: autograd and jax.vjp themselves differ by 6.1e-5 there.
* Loss and every gradient leaf: atol 1e-5 / rtol 1e-4, loss curves rtol
  1e-4, as tests/test_torch_training.py holds the dense family.
* Flash attention's plain versions at head dim 80 against the JAX
  oracle and its VJP: 1e-5 abs + rel (f32).
"""

import dataclasses
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
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build
from repro.runtime import trainer as jax_trainer
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops, ref
from repro_torch.models import (build_model, params_from_numpy,
                                train_state_from_numpy)
from repro_torch.runtime.trainer import Trainer, make_train_step, \
    value_and_grad
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "zamba2_2_7b"
SSD_TOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
F32_LEAVES = ("stack/stack/ssm/a_log", "stack/stack/ssm/dt_bias",
              "stack/stack/ssm/d_skip")


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params) on equal weights:
    the smoke config (4 Mamba2 layers, the shared block after every 2,
    ssm_chunk 32)."""
    jm = jax_build(jax_smoke(ARCH), impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(torch_smoke(ARCH), device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


def batch_of(cfg, B=2, S=80, step=0):
    """S = 80 at ssm_chunk 32: the third chunk is ragged (ops.ssd_scan
    pads it); the second row's tail is masked."""
    batch = JaxData(cfg, B, S, seed=3).generate(step)
    batch["mask"][1, S - 30:] = 0.0
    return batch


def close_tree(port, want, atol=ATOL, rtol=RTOL):
    got = leaves_with_path(port)
    assert sorted(n for n, _ in got) == sorted(want)
    for name, leaf in got:
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   np.asarray(want[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


# ---------------------------------------------------------- SSD backward ----
def ssd_inputs(B, L, H, P, N, seed, h0, dh):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, b, c = f(B, L, H, P), f(B, L, N), f(B, L, N)
    dt = np.abs(f(B, L, H)) * 0.1
    a = -np.exp(0.5 * f(H))
    return (x, dt, a, b, c, f(B, H, N, P) if h0 else None, f(B, L, H, P),
            f(B, H, N, P) if dh else None)


# B, L, H, P, N, chunk (at least 3 chunks), carried state, gradient of h
SSD_BWD_CASES = [(1, 96, 2, 16, 8, 32, False, False),
                 (2, 128, 3, 32, 16, 32, True, True),
                 (2, 48, 2, 8, 4, 16, True, False),
                 (1, 64, 2, 16, 8, 16, False, True),
                 (2, 9, 2, 8, 4, 3, True, True)]


@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_backward_matches_autograd_and_jax_vjp(case):
    B, L, H, P, N, chunk, with_h0, with_dh = case
    x, dt, a, b, c, h0, dy, dh = ssd_inputs(B, L, H, P, N, 0, with_h0,
                                            with_dh)
    t = lambda v: None if v is None else torch.from_numpy(v)
    got = ref.ssd_scan_backward(t(x), t(dt), t(a), t(b), t(c), t(h0),
                                t(dy), t(dh), chunk=chunk)
    assert (got[5] is None) == (h0 is None)
    got = [g for g in got if g is not None]

    ins = [t(v).requires_grad_() for v in (x, dt, a, b, c, h0)
           if v is not None]
    y, h = ref.ssd_chunked(*ins[:5], chunk=chunk,
                           h0=ins[5] if with_h0 else None)
    want_t = torch.autograd.grad(
        (y, h), ins, (t(dy), t(dh) if with_dh else torch.zeros_like(h)))

    def jfn(x, dt, a, b, c, *h0):
        return jax_ref.ssd_chunked(x, dt, a, b, c, chunk=chunk,
                                   h0=h0[0] if h0 else None)
    jins = [jnp.asarray(v) for v in (x, dt, a, b, c, h0) if v is not None]
    (jy, jh), vjp = jax.vjp(jfn, *jins)
    want_j = vjp((jnp.asarray(dy), jnp.asarray(dh) if with_dh
                  else jnp.zeros_like(jh)))
    names = ["dx", "ddt", "da", "db", "dc", "dh0"]
    for name, g, wt, wj in zip(names, got, want_t, want_j):
        for w in (wt.numpy(), np.asarray(wj)):
            np.testing.assert_allclose(
                g.numpy(), w, atol=SSD_TOL * np.abs(w).max(), rtol=SSD_TOL,
                err_msg=name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_function_gradcheck(with_h0):
    """SSDScan on the CPU (ref.ssd_scan, ref.ssd_scan_backward), f64
    finite differences, 3 chunks of 4."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s))
    x, b, c = f(1, 12, 2, 8), f(1, 12, 4), f(1, 12, 4)
    dt, a = 0.3 * f(1, 12, 2).abs(), -torch.exp(0.5 * f(2))
    ins = [v.requires_grad_() for v in (x, dt, a, b, c)]
    if with_h0:
        ins.append(f(1, 2, 4, 8).requires_grad_())
    fn = lambda *v: ms.SSDScan.apply(*v[:5], v[5] if with_h0 else None, 4)
    assert torch.autograd.gradcheck(fn, ins)


def test_ssd_backward_of_the_rounded_function_in_bf16():
    """In bf16 the scan kernel computes round(dt·x); its backward passes
    the gradient through that rounding as the identity, in f32: torch
    autograd of the same function with a straight-through rounding
    (which autograd of a cast would round to bf16 instead)."""
    x, dt, a, b, c, h0, dy, _ = ssd_inputs(2, 64, 3, 16, 8, 2, True, False)
    bf = lambda v: torch.from_numpy(v).to(torch.bfloat16)
    xb, bb, cb, dyb = bf(x), bf(b), bf(c), bf(dy)
    dtt, at, h0t = (torch.from_numpy(v) for v in (dt, a, h0))
    got = ref.ssd_scan_backward(xb, dtt, at, bb, cb, h0t, dyb, None,
                                chunk=16)
    ins = [v.float().clone().requires_grad_()
           for v in (xb, dtt, at, bb, cb, h0t)]
    xf, dtf, af, bf32, cf, h0f = ins
    dtx = dtf[..., None] * xf
    dtx = dtx + (dtx.to(torch.bfloat16).float() - dtx).detach()
    y, _ = ref._ssd_chunks(dtx, af * dtf, bf32, cf, 16, h0f)
    want = torch.autograd.grad(y, ins, dyb.float())
    for g, w, v in zip(got, want, (xb, dtt, at, bb, cb, h0t)):
        assert g.dtype == v.dtype
        if g.dtype == torch.bfloat16:   # one rounding of the f32 result
            w = w.to(torch.bfloat16)
        np.testing.assert_allclose(
            g.float().numpy(), w.float().numpy(),
            atol=SSD_TOL * w.float().abs().max().item(), rtol=SSD_TOL)


def test_ops_ssd_scan_takes_the_function_only_for_a_gradient():
    """A gradient wanted: SSDScan (padded L too); none wanted: the
    wrapper alone, no graph."""
    x, dt, a, b, c, _, _, _ = ssd_inputs(1, 40, 2, 8, 4, 3, False, False)
    xt, dtt, at, bt, ct = (torch.from_numpy(v) for v in (x, dt, a, b, c))
    y, _ = ops.ssd_scan(xt, dtt, at, bt, ct, chunk=16)
    assert y.grad_fn is None
    ins = [v.clone().requires_grad_() for v in (xt, dtt, at, bt, ct)]
    y, _ = ops.ssd_scan(*ins, chunk=16)
    assert "SSDScan" in type(y.grad_fn).__name__ or any(
        "SSDScan" in type(f).__name__ for f, _ in y.grad_fn.next_functions
        if f is not None)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        y.shape).astype(np.float32))
    got = torch.autograd.grad(y, ins, dy)
    ins_r = [v.clone().requires_grad_() for v in (xt, dtt, at, bt, ct)]
    y_r, _ = ops.ssd_scan(*ins_r, chunk=16, impl="ref")
    for g, w in zip(got, torch.autograd.grad(y_r, ins_r, dy)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=SSD_TOL,
                                   rtol=SSD_TOL)


# ----------------------------------------------------------------- model ----
@pytest.mark.parametrize("S", [80, 32])
def test_loss_and_grads_match_jax(models, S):
    jm, jp, tm, tp = models
    batch = batch_of(jm.cfg, S=S)
    (jl, (jmet, _)), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    loss, metrics, _, grads = value_and_grad(tm, tp, batch, tm.table())
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmet["loss"]),
                               rtol=RTOL)
    assert float(metrics["tokens"]) == float(batch["mask"].sum())
    close_tree(grads, flat_np(jg))


def test_remat_changes_memory_not_the_loss(models):
    """none / full / dots_saveable over the super-blocks: the same loss,
    the same gradient bits, the same static costs (the recompute in the
    backward registers nothing)."""
    _, _, tm, params = models
    batch = batch_of(tm.cfg)
    out = {}
    for remat in ("none", "full", "dots_saveable"):
        model = build_model(dataclasses.replace(tm.cfg, remat=remat),
                            device="cpu")
        STATIC_COSTS.reset()
        loss, _, _, grads = value_and_grad(model, params, batch, None)
        out[remat] = (loss, leaves_with_path(grads),
                      {k: dict(v) for k, v in STATIC_COSTS.costs.items()})
    l0, g0, c0 = out["none"]
    for remat in ("full", "dots_saveable"):
        l1, g1, c1 = out[remat]
        assert torch.equal(l0, l1), remat
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(g0, g1)), remat
        assert c1 == c0, remat


def test_loss_fn_static_costs_match_one_jax_trace(models):
    jm, jp, tm, tp = models
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


def test_f32_leaves_stay_f32_through_adamw():
    """In a bf16 config a_log, dt_bias and d_skip keep f32 params and
    gradients, and AdamW writes its f32 master into them exactly."""
    cfg = dataclasses.replace(torch_smoke(ARCH), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    tm = build_model(cfg, device="cpu")
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=2)
    state = {"params": tm.init(0)}
    from repro_torch.optim import adamw
    state["opt"] = adamw.init_state(state["params"])
    before = {n: v.clone() for n, v in leaves_with_path(state["params"])}
    batch = batch_of(cfg, S=64)
    _, _, _, grads = value_and_grad(tm, state["params"], batch, None)
    state, metrics, _ = make_train_step(tm, tcfg)(state, batch, None)
    assert np.isfinite(float(metrics["loss"]))
    g = dict(leaves_with_path(grads))
    master = dict(leaves_with_path(state["opt"]["master"]))
    for name, leaf in leaves_with_path(state["params"]):
        f32 = name in F32_LEAVES
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), name
        assert g[name].dtype == leaf.dtype, name
        if f32:
            assert torch.equal(leaf, master[name]), name
            assert not torch.equal(leaf, before[name]), name


# --------------------------------------------------------------- trainer ----
@pytest.mark.parametrize("micro", [1, 2])
def test_loss_curve_tracks_the_reference_trainer(models, micro, tmp_path):
    """Four steps from the reference's initial train state on the same
    batches: the per-step losses of the two step functions; with one
    microbatch, also the reference Trainer's and the port Trainer's last
    metrics."""
    steps = 4
    jm, _, tm, _ = models
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=steps,
              microbatches=micro, ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
    flat = flat_np(jstate)
    jstep = jax.jit(jax_trainer.make_train_step(jm, jcfg))
    tstep = make_train_step(tm, tcfg)
    js, ts = jstate, train_state_from_numpy(flat, tm.cfg, "cpu")
    for step in range(steps):
        batch = JaxData(jm.cfg, 4, 40, seed=0).generate(step)
        js, jmet, _ = jstep(js, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, jm.table())
        ts, met, _ = tstep(ts, batch, None)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=RTOL, err_msg=f"step {step}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-3)
    if micro > 1:
        return
    jt = jax_trainer.Trainer(jm, jcfg, JaxCkpt(str(tmp_path / "j")))
    _, jlast = jt.run(jax.random.key(0), JaxData(jm.cfg, 4, 40), steps,
                      resume=False, state=jstate)
    tt = Trainer(tm, tcfg, CheckpointManager(str(tmp_path / "t")))
    _, tlast = tt.run(0, SyntheticLMData(tm.cfg, 4, 40), steps, resume=False,
                      state=train_state_from_numpy(flat, tm.cfg, "cpu"))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tlast[k], jlast[k], rtol=1e-3, err_msg=k)


def test_train_launcher_trains_the_hybrid_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "40", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-interval", "0", "--profile-dir", str(tmp_path / "prof")],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: {'loss'" in out.stdout
    assert "ssm" in out.stdout or os.listdir(tmp_path / "prof")


# ------------------------------------------------------ flash at head 80 ----
@pytest.mark.parametrize("Hq,Hkv,Sq,Sk,causal", [(4, 4, 40, 40, True),
                                                  (4, 2, 24, 56, True),
                                                  (2, 2, 16, 40, False)])
def test_flash_plain_versions_at_head_dim_80_match_jax(Hq, Hkv, Sq, Sk,
                                                        causal):
    """zamba2's shared-block head dim: the plain forward and backward the
    kernels are held against on the card, against the JAX oracle and its
    VJP."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, do = f(2, Hq, Sq, 80), f(2, Hkv, Sk, 80), f(2, Hkv, Sk, 80), \
        f(2, Hq, Sq, 80)
    off = Sk - Sq if causal else 0
    t = torch.from_numpy
    o, lse = ref.attention(t(q), t(k), t(v), causal=causal, q_offset=off,
                           return_lse=True)
    grads = ref.attention_backward(t(q), t(k), t(v), o, lse, t(do),
                                   causal=causal, q_offset=off)
    jo, vjp = jax.vjp(lambda *a: jax_ref.attention(
        *a, causal=causal, q_offset=off), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=SSD_TOL,
                               rtol=SSD_TOL)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSD_TOL,
                                   rtol=SSD_TOL)
