"""MLA training's attention at its own v width, against the JAX package,
on the CPU.

deepseek-v2's expanded (training) branch attends at q/k head dim
dn + dr = 192 with v at dv = 128.  The reference pads v to 192 so that its
Pallas flash kernel sees equal head dims and keeps the first 128 columns
of o; the port passes v at 128 and its flash pair (plain versions here,
the CUDA kernels on the card) returns o and dv at 128.  The same numpy
inputs (from a seed) go through both: o against `repro.kernels.ops.attention`
on the padded v (impl "ref", and the Pallas kernel in interpret mode where
it masks as the oracle does, Sq == Sk), the gradients against `jax.vjp`
of the oracle and of its custom-VJP flash path `ref.attention_chunked`,
all in f32 to 1e-5.  Then the model: the smoke config with v narrower than
q/k (dv 16 against dn + dr 32, as deepseek's 128 against 192) through the
expanded branch, the loss, every gradient leaf and the static costs
against the reference, as tests/test_torch_mla.py holds the equal-width
smoke config.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models import layers as jax_layers
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as torch_layers
from repro_torch.models.transformer import _layer
from repro_torch.runtime.trainer import value_and_grad
from repro_torch.tree import leaves_with_path

ARCH = "deepseek_v2_lite_16b"
TOL = 1e-5
#: deepseek-v2-lite's training attention: 16 heads (2 here) of q/k 192,
#: v 128, sm_scale 192 ** -0.5
DQK, DV = 192, 128
SCALE = DQK ** -0.5
#: model tests: atol/rtol 1e-4 in f32, as tests/test_torch_mla.py
ATOL = RTOL = 1e-4
#: the smoke config with v narrower than q/k: dn 16 + dr 16 = 32, dv 16
NARROW = dict(v_head_dim=16)


def inputs(seed, Sq, Sk, B=1, H=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, DQK), (B, H, Sk, DQK), (B, H, Sk, DV),
                      (B, H, Sq, DV))]


def pad(v):
    return jnp.pad(jnp.asarray(v), ((0, 0), (0, 0), (0, 0), (0, DQK - DV)))


def t(x, grad=False):
    return torch.from_numpy(x).requires_grad_(grad)


def close(got, want, atol=TOL, rtol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


# ------------------------------------------------------------ attention ----
@pytest.mark.parametrize("Sq,Sk", [(256, 256), (128, 256)])
def test_narrow_v_forward_matches_padded_jax(Sq, Sk):
    """o at v's width equals the reference's attention on v zero-padded
    to q's head dim, first 128 columns; the other 64 are zeros there."""
    q, k, v, _ = inputs(0, Sq, Sk)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    want = np.asarray(jops.attention(jq, jk, pad(v), causal=True,
                                     sm_scale=SCALE, impl="ref"))
    assert np.all(want[..., DV:] == 0)
    for impl in ("ref", "auto"):
        got = tops.attention(t(q), t(k), t(v), causal=True, sm_scale=SCALE,
                             impl=impl)
        assert got.shape == (1, 2, Sq, DV)
        close(got, want[..., :DV], what=impl)
    o, lse, _ = tfa.flash_attention(t(q), t(k), t(v), sm_scale=SCALE)
    o_p, lse_p = tref.attention(t(q), t(k), torch.from_numpy(
        np.array(pad(v))), sm_scale=SCALE, q_offset=Sk - Sq,
        return_lse=True)
    close(o, o_p[..., :DV].numpy())
    close(lse, lse_p.numpy())
    if Sq == Sk:               # the Pallas kernel masks on the diagonal
        pallas = jops.attention(jq, jk, pad(v), causal=True, sm_scale=SCALE,
                                impl="pallas", interpret=True)
        close(o, np.asarray(pallas)[..., :DV], what="pallas")


@pytest.mark.parametrize("Sq,Sk", [(256, 256), (128, 256)])
def test_narrow_v_grads_match_padded_jax_vjp(Sq, Sk):
    """dq, dk, and dv at v's width against jax.vjp of the padded-v
    attention (the oracle and its custom-VJP flash path): the plain
    backward from the plain forward's (o, lse), torch autograd through the
    plain attention, and the FlashAttention Function."""
    q, k, v, do = inputs(1, Sq, Sk)
    off = Sk - Sq
    do_p = np.concatenate([do, np.zeros(do.shape[:3] + (DQK - DV,),
                                        np.float32)], axis=-1)
    want = {}
    for name, fn in (
            ("oracle", lambda q, k, v: jref.attention(
                q, k, v, causal=True, sm_scale=SCALE, q_offset=off)),
            ("chunked", lambda q, k, v: jref.attention_chunked(
                q, k, v, causal=True, sm_scale=SCALE, q_offset=off,
                block_k=64))):
        _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), pad(v))
        dq, dk, dv = vjp(jnp.asarray(do_p))
        want[name] = (dq, dk, np.asarray(dv)[..., :DV])
    o, lse = tref.attention(t(q), t(k), t(v), sm_scale=SCALE, q_offset=off,
                            return_lse=True)
    got = {"plain": tref.attention_backward(t(q), t(k), t(v), o, lse, t(do),
                                            sm_scale=SCALE, q_offset=off)}
    for impl in ("ref", "auto"):
        ins = [t(x, grad=True) for x in (q, k, v)]
        out = tops.attention(*ins, causal=True, sm_scale=SCALE, impl=impl)
        got[impl] = torch.autograd.grad(out, ins, t(do))
    for g_name, grads in got.items():
        assert grads[2].shape == v.shape
        for w_name, w in want.items():
            for what, a, b in zip(("dq", "dk", "dv"), grads, w):
                close(a, b, what=f"{g_name} {what} vs {w_name}")


def test_flash_pair_compiles_mla_training_and_not_a_padded_v():
    """The flash kernels take (192, 128); an equal 192 is not compiled."""
    assert (DQK, DV) in tfa.HEAD_DIMS
    assert (DQK, DQK) not in tfa.HEAD_DIMS


# ----------------------------------------------------------------- model ----
def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


@pytest.fixture(scope="module")
def narrow():
    """(jax model, jax params, port model, port params) of the smoke
    config at dv 16 < dn + dr 32, equal weights."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), **NARROW)
    tcfg = dataclasses.replace(torch_smoke(ARCH), remat="none", **NARROW)
    jm = jax_build(jcfg, impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


def test_expanded_branch_calls_attention_with_v_unpadded(narrow,
                                                         monkeypatch):
    """mla_attention without a cache hands ops.attention v at dv columns
    (no pad), q and k at dn + dr, and gets o back at dv; y equals the
    reference's, which pads v and slices o."""
    jm, jp, tm, tp = narrow
    cfg = tm.cfg
    seen = []
    attention = tops.attention

    def spy(q, k, v, **kw):
        seen.append((q.shape, k.shape, v.shape))
        o = attention(q, k, v, **kw)
        seen.append(o.shape)
        return o
    monkeypatch.setattr(torch_layers.ops, "attention", spy)
    rng = np.random.default_rng(3)
    B, S = 2, 11
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    positions = np.arange(S, dtype=np.int32)
    ty, _ = torch_layers.mla_attention(
        _layer(tp["stack_moe"]["stack"], 0), torch.from_numpy(x), tm.rt,
        torch.from_numpy(positions))
    dqk, dv, nh = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim, \
        cfg.n_heads
    assert dv < dqk
    assert seen == [((B, nh, S, dqk), (B, nh, S, dqk), (B, nh, S, dv)),
                    (B, nh, S, dv)]
    jlp = jax.tree.map(lambda a: a[0], jp["stack_moe"]["stack"])
    jy, _ = jax_layers.mla_attention(jlp, jnp.asarray(x), jm.rt,
                                     jnp.asarray(positions))
    close(ty, jy, ATOL, RTOL)


def batch_of(cfg):
    batch = JaxData(cfg, 2, 12, seed=3).generate(0)
    batch["mask"][1, 5:] = 0.0
    return batch


def test_loss_and_grads_match_jax_at_a_narrow_v(narrow):
    """One loss_fn + backward through the expanded branch at dv < dn + dr:
    the loss, its aux part and every gradient leaf (wkv_b's v columns
    included) against jax.value_and_grad."""
    jm, jp, tm, tp = narrow
    batch = batch_of(jm.cfg)
    (jl, (jmet, _)), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    loss, metrics, _, grads = value_and_grad(tm, tp, batch, tm.table())
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=RTOL)
    want = flat_np(jg)
    got = leaves_with_path(grads)
    assert sorted(n for n, _ in got) == sorted(want)
    for name, leaf in got:
        close(leaf, want[name], ATOL, RTOL, what=name)


def test_static_costs_match_one_jax_trace_at_a_narrow_v(narrow):
    """The flash_attention edge the port registers with v at its own
    width equals the reference's with v padded (FLOPs at D = dn + dr,
    bytes with v counted at D), and so does every other edge."""
    jm, jp, tm, tp = narrow
    batch = batch_of(jm.cfg)
    JAX_COSTS.reset()
    jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    value_and_grad(tm, tp, batch, tm.table())
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    assert any(k[2] == "flash_attention" for k in got)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("v_head_dim", [None, 16])
def test_mfu_flops_match_the_static_cost_layer(v_head_dim):
    """chip_smoke.py's model-FLOPs count of an MLA model (what its
    static-cost edges register: mla_proj and flash at dn + dr) equals the
    port's static-cost FLOPs of one loss_fn without the norms, as its
    phase 14 holds it on the card at full width; the two products the
    reference registers no cost for (the wkv_b expansion and o_proj) are
    counted apart."""
    smoke = chip_smoke()
    kw = {} if v_head_dim is None else dict(v_head_dim=v_head_dim)
    cfg = dataclasses.replace(torch_smoke(ARCH), remat="none", **kw)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 12
    batch = SyntheticLMData(cfg, B, S, seed=1).generate(0)
    STATIC_COSTS.reset()
    with torch.no_grad():
        model.loss_fn(params, batch, model.table())
    registered = sum(v.get("flops", 0.0) for k, v in
                     STATIC_COSTS.costs.items() if k[2] != "rmsnorm")
    assert smoke.moe_model_flops(cfg, B, S) / 3 \
        == pytest.approx(registered, rel=1e-12)
    nh, d, dv = cfg.n_heads, cfg.d_model, cfg.v_head_dim
    assert smoke.mla_unregistered_flops(cfg, B, S) == pytest.approx(
        3.0 * B * S * cfg.n_layers * (2 * cfg.kv_lora_rank * nh
                                      * (cfg.qk_nope_dim + dv)
                                      + 2 * nh * dv * d))
