"""The port's training attention and norm gradients against the JAX
package, on the CPU.

Same numpy inputs (from a seed) through `repro_torch.kernels` and through
the JAX package: the forward against `repro.kernels.ref.attention` (the
oracle, with its q_offset = Sk - Sq) and the Pallas kernel in interpret
mode (which masks on the diagonal, so only where Sq == Sk or non-causal);
the gradients (the plain backward `ref.attention_backward`, torch
autograd of the plain `attention`, and the FlashAttention Function, which
runs the plain versions on the CPU) against `jax.grad` of the oracle and
of its custom-VJP flash path `ref.attention_chunked`.  Tolerances are
those of tests/test_kernels.py: 2e-5 for f32 values, atol 5e-5 /
rtol 5e-4 for f32 gradients.

One case is pinned to the Pallas kernel, not the oracle: a causal row
that sees no column (Sq > Sk) gives zeros, where the oracle's finite
mask gives the mean of v.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4

# causal, g, softcap, Sq, Sk
FWD_CASES = [(c, g, cap, sq, sk)
             for c in (True, False) for g in (1, 2, 4) for cap in (0.0, 30.0)
             for sq, sk in ((16, 16), (12, 20))]


def inputs(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                      (B, Hq, Sq, D))]


def t(x, grad=False):
    return torch.from_numpy(x).requires_grad_(grad)


def close(got, want, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("causal,g,cap,Sq,Sk", FWD_CASES)
def test_attention_forward_matches_jax(causal, g, cap, Sq, Sk):
    q, k, v, _ = inputs(0, 2, 4, 4 // g, Sq, Sk, 16)
    off = Sk - Sq if causal else 0
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, logit_softcap=cap, q_offset=off)
    for impl in ("ref", "auto"):
        got = tops.attention(t(q), t(k), t(v), causal=causal,
                             logit_softcap=cap, impl=impl)
        close(got, want)
    if Sq == Sk or not causal:     # the Pallas kernel takes no offset
        pallas = jops.attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                logit_softcap=cap, impl="pallas",
                                interpret=True)
        close(got, pallas)


def test_fully_masked_rows_give_zeros_as_the_pallas_kernel():
    """Causal Sq > Sk: the first Sq - Sk rows see no column.  They are
    zeros (lse -1e30); the other rows match the oracle."""
    q, k, v, _ = inputs(1, 1, 4, 2, 20, 12, 16)
    o, lse, _ = tfa.flash_attention(t(q), t(k), t(v), causal=True)
    assert torch.all(o[:, :, :8] == 0) and torch.all(lse[:, :, :8] == -1e30)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, q_offset=-8)
    close(o[:, :, 8:], np.asarray(want)[:, :, 8:])
    # the oracle's finite mask averages v over those rows instead
    assert not np.allclose(np.asarray(want)[:, :, :8], 0)


def jax_grads(fn, q, k, v, do):
    f = lambda q, k, v: jnp.sum(fn(q, k, v) * jnp.asarray(do))
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("causal,g,cap,Sq,Sk", FWD_CASES)
def test_attention_grads_match_jax(causal, g, cap, Sq, Sk):
    q, k, v, do = inputs(2, 2, 4, 4 // g, Sq, Sk, 16)
    off = Sk - Sq if causal else 0
    opts = dict(causal=causal, logit_softcap=cap)
    want = jax_grads(lambda q, k, v: jref.attention(q, k, v, q_offset=off,
                                                    **opts), q, k, v, do)
    chunked = jax_grads(lambda q, k, v: jref.attention_chunked(
        q, k, v, block_k=4, q_offset=off, **opts), q, k, v, do)
    # the plain backward from the plain forward's (o, lse)
    o, lse = tref.attention(t(q), t(k), t(v), q_offset=off, return_lse=True,
                            **opts)
    plain = tref.attention_backward(t(q), t(k), t(v), o, lse, t(do),
                                    q_offset=off, **opts)
    # torch autograd through the plain forward, and the Function
    auto = {}
    for impl in ("ref", "auto"):
        ins = [t(x, grad=True) for x in (q, k, v)]
        out = tops.attention(*ins, impl=impl, **opts)
        auto[impl] = torch.autograd.grad(out, ins, t(do))
    for got in (plain, auto["ref"], auto["auto"]):
        for a, w, c in zip(got, want, chunked):
            close(a, w, GRAD_ATOL, GRAD_RTOL)
            close(a, c, GRAD_ATOL, GRAD_RTOL)


def test_attention_grads_with_sm_scale_and_offset():
    """An explicit sm_scale, causal Sq < Sk (q_offset 6), G = 4."""
    q, k, v, do = inputs(3, 1, 8, 2, 10, 16, 32)
    want = jax_grads(lambda q, k, v: jref.attention(
        q, k, v, causal=True, sm_scale=0.3, q_offset=6), q, k, v, do)
    ins = [t(x, grad=True) for x in (q, k, v)]
    out = tfa.FlashAttention.apply(*ins, True, 0.3, 0.0)
    for a, w in zip(torch.autograd.grad(out, ins, t(do)), want):
        close(a, w, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (5, 2048)])
def test_rmsnorm_backward_matches_jax(shape):
    rng = np.random.default_rng(4)
    x, dy = (rng.standard_normal(shape).astype(np.float32) for _ in "ab")
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    f = lambda x, w: jnp.sum(jref.rmsnorm(x, w, eps=1e-5) * jnp.asarray(dy))
    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    dx, dw = tref.rmsnorm_backward(t(x), t(w), t(dy), eps=1e-5)
    close(dx, jdx, GRAD_ATOL, GRAD_RTOL)
    close(dw, jdw, GRAD_ATOL, GRAD_RTOL)
    # the Function (plain versions on the CPU) gives the same
    xi, wi = t(x, grad=True), t(w, grad=True)
    out = tops.rmsnorm(xi, wi, eps=1e-5)
    fdx, fdw = torch.autograd.grad(out, (xi, wi), t(dy))
    assert torch.equal(fdx, dx) and torch.equal(fdw, dw)


def test_rmsnorm_backward_bf16_rounds_as_the_forward():
    """In bf16, dw uses the normalized row rounded as the forward rounds
    it, and the sums run in f32: within one bf16 ulp of the f32 oracle's
    gradient on the same (bf16-representable) inputs."""
    rng = np.random.default_rng(5)
    x, dy = (torch.from_numpy(rng.standard_normal((6, 256)).astype(
        np.float32)).to(torch.bfloat16) for _ in "ab")
    w = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(
        torch.bfloat16)
    dx, dw = tref.rmsnorm_backward(x, w, dy)
    assert dx.dtype == dw.dtype == torch.bfloat16
    f = lambda x, w: jnp.sum(jref.rmsnorm(x, w) * jnp.asarray(
        dy.float().numpy()))
    jdx, jdw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x.float().numpy()),
                                           jnp.asarray(w.float().numpy()))
    close(dx, jdx, 2e-2, 2e-2)
    close(dw, jdw, 2e-2, 2e-2)


def test_attention_static_cost_matches_jax():
    """ops.attention registers the reference's edge and formula."""
    q, k, v, _ = inputs(6, 2, 4, 2, 16, 16, 16)
    JAX_COSTS.reset()
    jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, impl="ref")
    STATIC_COSTS.reset()
    tops.attention(t(q), t(k), t(v), causal=True)
    assert STATIC_COSTS.costs.keys() == JAX_COSTS.costs.keys()
    for key, want in JAX_COSTS.costs.items():
        assert STATIC_COSTS.costs[key] == pytest.approx(want), key
    assert STATIC_COSTS.costs[("app", "attention", "flash_attention")][
        "flops"] == 4.0 * 2 * 4 * 16 * 16 * 16 * 0.5


def test_kernel_wrappers_on_the_cpu_run_the_plain_versions():
    """A CPU tensor never reaches a kernel: the counters stay at 0."""
    q, k, v, do = inputs(7, 1, 4, 2, 8, 8, 16)
    tops.reset_launch_counts()
    ins = [t(x, grad=True) for x in (q, k, v)]
    torch.autograd.grad(tops.attention(*ins), ins, t(do))
    x = t(q, grad=True)
    torch.autograd.grad(tops.rmsnorm(x, t(np.ones(16, np.float32))).sum(), x)
    assert not any(tops.launch_counts().values())
    with pytest.raises(ValueError, match="CUDA"):
        tops.attention(t(q), t(k), t(v), impl="kernel")


def common_component_inputs(dtype, B=1, H=2, S=256, D=64, seed=11):
    """q, k, v, dO whose K (and Q, V) rows share one large component, as
    a cross-attention's K from an encoder whose near-uniform attention
    adds one vector to every position."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen)
    common = 4.0 * rnd(1, 1, 1, D)
    q = 0.3 * rnd(B, H, S, D) + 0.5 * common
    k = 0.3 * rnd(B, H, S, D) + common
    v = rnd(B, H, S, D) + common
    return [a.to(dtype) for a in (q, k, v, rnd(B, H, S, D))]


def test_bf16_backward_takes_delta_from_o_before_its_rounding():
    """delta = rowsum(dO * o) from o rounded to bf16 leaves each row's dS
    summing to ~2^-9 |dO| |o| instead of 0, and that times the K rows'
    common component is dQ's error: 1.25 relative here.  FlashAttention
    keeps o in f32 for its backward (flash_attention(keep_f32=True)), so
    its bf16 gradients stay within 2x the plain bf16 path's distance from
    the f64 ones; flash_attention_backward with the rounded o shows the
    error it avoids."""
    q, k, v, do = common_component_inputs(torch.bfloat16)
    ins64 = [a.double().requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(tref.attention(*ins64, causal=False), ins64,
                               do.double())
    rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
    ins = [a.clone().requires_grad_() for a in (q, k, v)]
    plain = torch.autograd.grad(tref.attention(*ins, causal=False), ins, do)
    ins = [a.clone().requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tfa.FlashAttention.apply(*ins, False, None,
                                                       0.0), ins, do)
    for g, p, w in zip(got, plain, want):
        assert rel(g, w) <= 2.0 * rel(p, w), (rel(g, w), rel(p, w))
    o, lse, o32 = tfa.flash_attention(q, k, v, causal=False, keep_f32=True)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(o.dtype), o)
    assert tfa.flash_attention(q, k, v, causal=False)[2] is None
    with pytest.raises(ValueError, match="o must be f32"):
        tfa.flash_attention_backward(q, k, v, o, lse, do, causal=False)
    rounded = tfa.flash_attention_backward(q, k, v, o.float(), lse, do,
                                           causal=False)
    assert rel(rounded[0], want[0]) > 0.5 > 50 * rel(got[0], want[0])
