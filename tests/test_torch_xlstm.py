"""The port's ssm family (xlstm-1.3b's wiring) against the JAX package, on
the CPU, same weights.

A tiny config at the published grouping: 4 heads, 6 blocks as 2
super-blocks of 2 mLSTM + 1 sLSTM (the published 7:1 needs 8 blocks a
super-block), d_model 128 (mLSTM head width 64 at proj factor 2), chunk
16, sequences of at most 48 tokens.  The JAX model (impl="ref") is
initialised, flattened to numpy by the reference checkpoint naming and
loaded into the port through `params_from_numpy`.  Tolerances, f32:
logits and carried state at atol = rtol = 1e-4; the loss and every
gradient leaf at atol 1e-5 / rtol 1e-4 and N-step loss curves at rtol
1e-4, as the dense family's (tests/test_torch_training.py); the chunked
cell against the sequential oracle at 1e-4 too (one function, summed in
another order, and divided by the normalizer |n . q|, which amplifies
the f32 rounding of the sums up to ~1e-4 relative at gates ~3).
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

from repro.ckpt.manager import _flatten
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import build_model as jax_build
from repro.models import xlstm as jax_xlstm
from repro.runtime import trainer as jax_trainer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ServeConfig, ShapeConfig, TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model, params_from_numpy, xlstm
from repro_torch.runtime.trainer import make_train_step, value_and_grad
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "xlstm_1_3b"
ATOL, RTOL = 1e-5, 1e-4
TOL = 1e-4
CELL_TOL = 1e-4


def tiny(getter, **kw):
    """xlstm's wiring, narrow: 4 heads, 2 super-blocks of 2 mLSTM + 1
    sLSTM, d_model 128, chunk 16, a 256-word vocabulary."""
    return dataclasses.replace(getter(ARCH), vocab=256, n_heads=4,
                               n_kv_heads=4, n_layers=6, slstm_every=3,
                               ssm_chunk=16, **kw)


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs many small ops (the cells' loops): one intra-op
    thread, so that they do not contend with the other test workers'
    threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params), equal weights."""
    jm = jax_build(tiny(jax_smoke), impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(tiny(get_smoke), device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def close_tree(port, ref, atol=ATOL, rtol=RTOL):
    got = leaves_with_path(port)
    assert sorted(n for n, _ in got) == sorted(ref)
    for name, leaf in got:
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   np.asarray(ref[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


def close_state(port, ref):
    """The port's cache against the reference's (C, n, m) stacked
    [n_super, n_m, B, ...] and (c, n, m, h) stacked [n_super, B, d]."""
    for i, k in enumerate("Cnm"):
        want = np.asarray(ref["mlstm"][i])
        close(port["mlstm"][k].numpy(), want.reshape((-1,) + want.shape[2:]))
    for i, k in enumerate("cnmh"):
        close(port["slstm"][k].numpy(), ref["slstm"][i])


def jnp_tree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def batch_of(cfg, B=2, S=32, step=0, seed=3):
    return JaxData(cfg, B, S, seed=seed).generate(step)


def test_tiny_config_runs_the_published_grouping():
    cfg = tiny(get_smoke)
    assert cfg.family == "ssm" and cfg.n_heads == 4 and cfg.d_ff == 0
    full = build_model(get_config(ARCH), device="cpu").cfg
    assert (full.n_layers, full.slstm_every, full.n_heads) == (48, 8, 4)
    assert full.d_model * full.mlstm_proj_factor / full.n_heads == 1024


# ---------------------------------------------------------------- params ----
def test_param_names_and_shapes_match_the_reference(models):
    jm, jp, tm, tp = models
    want = {n: a.shape for n, a in flat_np(jp).items()}
    got = {n: tuple(t.shape) for n, t in leaves_with_path(tp)}
    assert got == want
    assert got["stack_mlstm/stack/mlstm/w_q"] == (2, 2, 4, 64, 64)
    assert got["stack_slstm/stack/slstm/r_i"] == (2, 4, 32, 32)
    init = dict(leaves_with_path(tm.init(0)))
    assert {n: tuple(t.shape) for n, t in init.items()} == want


def test_full_config_specs_match_the_reference():
    """xlstm-1.3b at its published widths: the reference's leaf names and
    shapes (jax.eval_shape, nothing allocated) and 2.019B parameters."""
    jm = jax_build(jax_config(ARCH), impl="ref")
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = {n: tuple(a.shape) for n, a in _flatten(shapes)[0]}
    got = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                got[path] = tuple(v[0])
    walk(xlstm.param_specs(get_config(ARCH)))
    assert got == want
    assert got["stack_mlstm/stack/mlstm/w_q"] == (6, 7, 4, 1024, 1024)
    total = sum(int(np.prod(s)) for s in got.values())
    # the config's count leaves out the final norm
    assert total == get_config(ARCH).n_params() + 2048 == 2018932736


def test_params_from_numpy_is_strict_for_the_xlstm(models):
    jm, jp, tm, _ = models
    flat = flat_np(jp)
    for name in ("stack_mlstm/stack/mlstm/skip",
                 "stack_slstm/stack/slstm/r_o"):
        with pytest.raises(KeyError, match=f"missing leaf '{name}'"):
            params_from_numpy({k: v for k, v in flat.items() if k != name},
                              tm.cfg, "cpu")
    name = "stack_mlstm/stack/mlstm/w_gates"
    with pytest.raises(ValueError, match="w_gates: shape"):
        params_from_numpy(dict(flat, **{name: flat[name][0]}), tm.cfg, "cpu")
    with pytest.raises(KeyError, match="does not use"):
        params_from_numpy(dict(flat, extra=np.zeros(1)), tm.cfg, "cpu")


# ----------------------------------------------------------------- cells ----
def cell_inputs(B, H, L, ph, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, H, L, ph), f(B, H, L, ph) * ph ** -0.5, f(B, H, L, ph)
    gates = f(B, H, L, 2) * scale
    logf = -np.log1p(np.exp(-gates[..., 0]))          # log sigmoid
    return q, k, v, logf.astype(np.float32), gates[..., 1] + 1.0


# B, H, L, ph, chunk, gate scale
CELL_CASES = [(2, 2, 32, 16, 16, 1.0), (1, 3, 40, 8, 16, 3.0),
              (2, 1, 7, 16, 4, 1.0), (1, 2, 48, 32, 48, 2.0)]


@pytest.mark.parametrize("case", CELL_CASES)
def test_chunked_cell_matches_the_sequential_oracle_and_jax(case):
    """The chunked cell (padded where L is no chunk multiple) against the
    sequential oracle, output and final (C, n, m), and against the
    reference's chunked cell on the same inputs."""
    B, H, L, ph, chunk, scale = case
    ins = cell_inputs(B, H, L, ph, scale=scale)
    y, st = xlstm._mlstm_cell_chunked(*map(t, ins), chunk=chunk)
    ys, sts = xlstm._mlstm_cell_seq(*map(t, ins))
    close(y.numpy(), ys.numpy(), CELL_TOL)
    for a, b in zip(st, sts):
        close(a.numpy(), b.numpy(), CELL_TOL)
    jy, jst = jax_xlstm._mlstm_cell_chunked(*map(jnp.asarray, ins),
                                            chunk=chunk)
    close(y.numpy(), jy, CELL_TOL)
    for a, b in zip(st, jst):
        close(a.numpy(), b, CELL_TOL)


def test_step_cell_and_resumed_chunks_match_the_whole():
    """The decode step cell, step by step, and the chunked cell resumed
    from a carried state, against the whole sequence's oracle."""
    B, H, L, ph = 2, 2, 24, 16
    ins = [t(a) for a in cell_inputs(B, H, L, ph, seed=1)]
    ys, sts = xlstm._mlstm_cell_seq(*ins)
    st = xlstm._zero_mlstm(B, H, ph, "cpu")
    outs = []
    for i in range(L):
        y, st = xlstm._mlstm_cell_step(*(a[:, :, i] for a in ins), st)
        outs.append(y)
    close(torch.stack(outs, 2).numpy(), ys.numpy(), CELL_TOL)
    y1, st1 = xlstm._mlstm_cell_chunked(*(a[:, :, :10] for a in ins),
                                        chunk=8)
    y2, st2 = xlstm._mlstm_cell_chunked(*(a[:, :, 10:] for a in ins),
                                        chunk=8, state=st1)
    close(torch.cat([y1, y2], 2).numpy(), ys.numpy(), CELL_TOL)
    for a, b, c in zip(st, st2, sts):
        close(a.numpy(), c.numpy(), CELL_TOL)
        close(b.numpy(), c.numpy(), CELL_TOL)


def test_slstm_scan_matches_jax_with_a_pad_mask(models):
    """The sLSTM loop against the reference's scan, from a carried state,
    with pad steps in one row: output and (c, n, m, h)."""
    jm, jp, tm, tp = models
    sp = {k: v[1] for k, v in tp["stack_slstm"]["stack"]["slstm"].items()}
    jsp = {k: v[1] for k, v in jp["stack_slstm"]["stack"]["slstm"].items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 128)).astype(np.float32)
    state = [rng.standard_normal((2, 128)).astype(np.float32) * 0.1
             for _ in range(4)]
    mask = np.arange(12)[None, :] < np.array([12, 7])[:, None]
    y, st = xlstm._slstm_scan(sp, t(x), tm.cfg, tuple(map(t, state)),
                              t(mask))
    jy, jst = jax_xlstm._slstm_scan(jsp, jnp.asarray(x), jm.cfg,
                                    tuple(map(jnp.asarray, state)),
                                    mask=jnp.asarray(mask))
    close(y.numpy(), jy)
    for a, b in zip(st, jst):
        close(a.numpy(), b)
    assert torch.equal(y[1, 7:], y[1, 6:7].expand(5, -1))


def test_slstm_backward_is_autograd_through_the_loop():
    """_SLSTMScan's written-out backward: gradcheck in f64, and equal to
    torch autograd through the same loop for every input (the gates'
    pre-activations, the recurrent weights, the carried state); a pad
    mask with a gradient wanted raises."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64)

    def inputs(H, B, L, ph):
        ins = [rnd(L, H, B, 4, ph), 0.3 * rnd(H, ph, 4 * ph),
               *(0.1 * rnd(H, B, ph) for _ in range(4))]
        ins[4] = ins[4] - 1.0                               # m
        return [a.requires_grad_() for a in ins]
    assert torch.autograd.gradcheck(xlstm._SLSTMScan.apply,
                                    inputs(2, 1, 4, 3))
    ins = inputs(3, 2, 9, 5)
    out = xlstm._SLSTMScan.apply(*ins)
    ys, st, _ = xlstm._slstm_loop(ins[0], ins[1], tuple(ins[2:]))
    w = [rnd(*o.shape) for o in out]
    got = torch.autograd.grad(sum((o * v).sum() for o, v in zip(out, w)),
                              ins)
    want = torch.autograd.grad(sum((o * v).sum() for o, v in
                                   zip((ys,) + st, w)), ins)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
    cfg = tiny(get_smoke)
    sp = {k: v.requires_grad_() for k, v in build_model(
        cfg, device="cpu").init(0)["stack_slstm"]["stack"]["slstm"].items()}
    sp = {k: v[0] for k, v in sp.items()}
    with pytest.raises(ValueError, match="pad mask"):
        xlstm._slstm_scan(sp, torch.zeros(1, 3, 128), cfg,
                          xlstm._zero_slstm(1, 128, "cpu"),
                          torch.ones(1, 3, dtype=torch.bool))


def test_pad_steps_pass_the_state_through(models):
    """A chunk bucket-padded past each row's valid count leaves the state
    (mLSTM and sLSTM) where the real tokens alone take it, and gives the
    last real token's logits."""
    _, _, tm, tp = models
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 16)).astype(np.int32)
    valid = np.array([16, 9], np.int32)
    lp, cp, _ = tm.forward_chunk(tp, toks, None, tm.init_cache(2, 0), 0,
                                 valid)
    for r in range(2):
        lr, cr, _ = tm.forward_chunk(tp, toks[r:r + 1, :valid[r]], None,
                                     tm.init_cache(1, 0), 0)
        close(lp[r].numpy(), lr[0].numpy())
        for g in ("mlstm", "slstm"):
            for k, leaf in cp[g].items():
                close(leaf[:, r].numpy(), cr[g][k][:, 0].numpy())


# --------------------------------------------------------------- serving ----
@pytest.mark.parametrize("B,T", [(1, 1), (2, 9), (3, 40)])
def test_prefill_matches_jax(models, B, T):
    """Bulk prefill from a fresh state: the last token's logits and the
    carried state of every block."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(B).integers(0, 256, (B, T)).astype(np.int32)
    jl, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.table(),
                           jm.init_cache(B, 64))
    tl, tc, _ = tm.prefill(tp, {"tokens": toks}, tm.table(),
                           tm.init_cache(B, 64))
    close(tl.numpy(), jl)
    close_state(tc, jc)


def test_decode_ticks_and_a_padded_continuation_match_jax(models):
    """After a prefill, a continuation chunk bucket-padded under valid,
    then three decode ticks: logits and state at each."""
    jm, jp, tm, tp = models
    B = 2
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (B, 8)).astype(np.int32)
    _, jc, jt = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jm.table(),
                           jm.init_cache(B, 64))
    _, tc, tt = tm.prefill(tp, {"tokens": toks}, tm.table(),
                           tm.init_cache(B, 64))
    cont = rng.integers(0, 256, (B, 16)).astype(np.int32)
    valid = np.array([16, 5], np.int32)
    cont[1, 5:] = 0
    pos = np.array([8, 8], np.int32)
    jl, jc, jt = jm.forward_chunk(jp, jnp.asarray(cont), jt, jc,
                                  jnp.asarray(pos), jnp.asarray(valid))
    tl, tc, tt = tm.forward_chunk(tp, cont, tt, tc, pos, valid)
    close(tl.numpy(), jl)
    close_state(tc, jc)
    at = pos + valid
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc, jt = jm.decode_step(jp, jnp.asarray(tok), jt, jc,
                                    jnp.asarray(at))
        tl, tc, tt = tm.decode_step(tp, tok, tt, tc, at)
        close(tl.numpy(), jl)
        at = at + 1
    close_state(tc, jc)


@pytest.mark.parametrize("split", [(5,), (3, 17, 33), (16, 32)])
def test_prompt_whole_or_in_chunks_gives_the_same_tokens(models, split):
    """A 40-token prompt prefilled whole, or in chunks (the last
    bucket-padded to 16 under valid), then 6 greedy ticks: the same
    tokens; logits and carried state within 1e-4."""
    _, _, tm, tp = models
    B, S = 2, 40
    toks = np.random.default_rng(5).integers(0, 256, (B, S)).astype(np.int32)

    def greedy(logits, cache):
        out = []
        for i in range(6):
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
            logits, cache, _ = tm.decode_step(tp, tok, None, cache, S + i)
        return torch.stack(out, 1), logits

    lw, cw, _ = tm.prefill(tp, {"tokens": toks}, None, tm.init_cache(B, 0))
    cuts = [0] + list(split) + [S]
    cache = tm.init_cache(B, 0)
    for a, b in zip(cuts, cuts[1:]):
        chunk, valid = toks[:, a:b], None
        if b - a < 16:
            valid = np.full((B,), b - a, np.int32)
            chunk = np.pad(chunk, ((0, 0), (0, 16 - (b - a))))
        lc, cache, _ = tm.forward_chunk(tp, chunk, None, cache, a, valid)
    close(lc.numpy(), lw.numpy())
    for g in ("mlstm", "slstm"):
        for k in cw[g]:
            close(cache[g][k].numpy(), cw[g][k].numpy())
    chunked, whole = greedy(lc, cache), greedy(lw, cw)
    assert torch.equal(chunked[0], whole[0])
    close(chunked[1].numpy(), whole[1].numpy())


def test_cache_layout_is_position_free_with_the_batch_on_axis_1():
    tm = build_model(tiny(get_smoke), device="cpu")
    c = tm.init_cache(3, 4096)
    assert c["mlstm"]["C"].shape == (4, 3, 4, 64, 64)
    assert c["mlstm"]["n"].shape == (4, 3, 4, 64)
    assert c["mlstm"]["m"].shape == (4, 3, 4)
    assert {k: tuple(v.shape) for k, v in c["slstm"].items()} == {
        k: (2, 3, 128) for k in "cnmh"}
    assert all(leaf.dtype == torch.float32 for _, leaf in
               leaves_with_path(c))
    assert bool((c["mlstm"]["m"] == -1e30).all())
    assert tm.init_paged_cache is None and tm.forward_chunk_paged is None


@pytest.mark.parametrize("T", [1, 9])
def test_serving_static_costs_match_one_jax_trace(models, T):
    jm, jp, tm, tp = models
    toks = np.arange(2 * T, dtype=np.int32).reshape(2, T)
    JAX_COSTS.reset()
    jm.forward_chunk(jp, jnp.asarray(toks), jm.table(), jm.init_cache(2, 0),
                     jnp.zeros((2,), jnp.int32))
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    tm.forward_chunk(tp, toks, None, tm.init_cache(2, 0), 0)
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def staggered_run(engine, prompts, max_new):
    """Mixed-length prompts submitted at staggered ticks (the schedule of
    tests/test_torch_serving.py); returns the token streams."""
    reqs = [engine.submit(prompts[0], max_new[0])]
    engine.step()
    engine.step()
    reqs.append(engine.submit(prompts[1], max_new[1]))
    reqs.append(engine.submit(prompts[2], max_new[2]))
    engine.step()
    reqs.append(engine.submit(prompts[3], max_new[3]))
    engine.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs]


PROMPTS = [np.random.default_rng(1).integers(0, 256, n).astype(np.int32)
           for n in (3, 7, 5, 9)]
MAX_NEW = [6, 5, 6, 4]


@pytest.mark.parametrize("chunk,prefill_batch", [(3, 1), (3, 4), (64, 1),
                                                 (64, 4)])
def test_greedy_tokens_match_reference_engine(models, chunk, prefill_batch):
    """The port's continuous-batching engine (per-slot stashes of the
    recurrent state) against the reference engine: the same streams."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=4, max_seq_len=64, eos_token=-1, prefill_chunk=chunk,
              min_chunk_bucket=4, prefill_batch=prefill_batch)
    want = staggered_run(JaxEngine(jm, jp, JaxServeConfig(**kw)), PROMPTS,
                         MAX_NEW)
    engine = ServingEngine(tm, tp, ServeConfig(**kw))
    assert staggered_run(engine, PROMPTS, MAX_NEW) == want
    if prefill_batch > 1:
        assert max(b for b, _ in engine.chunk_programs) > 1


def test_pages_requested_keep_the_dense_layout(models):
    """With max_cache_pages > 0 the engine keeps the recurrent state (no
    paged entry points), as the reference's does, with the same tokens."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=4, max_seq_len=64, eos_token=-1, prefill_chunk=64,
              min_chunk_bucket=4, max_cache_pages=16, page_size=8)
    ref_engine = JaxEngine(jm, jp, JaxServeConfig(**kw))
    engine = ServingEngine(tm, tp, ServeConfig(**kw))
    assert not ref_engine.paged and not engine.paged
    assert engine.allocator is None and set(engine.cache) == {"mlstm",
                                                              "slstm"}
    assert staggered_run(engine, PROMPTS, MAX_NEW) == \
        staggered_run(ref_engine, PROMPTS, MAX_NEW)


def test_bf16_state_stays_f32_and_finite():
    """In bf16 the cells compute in f32 (q, k, v cast inside) and the
    carried state is f32: a prefill and ticks stay finite and within
    bf16 rounding of the f32 model's logits."""
    cfg16 = tiny(get_smoke, param_dtype="bfloat16", compute_dtype="bfloat16")
    m32, m16 = build_model(tiny(get_smoke), device="cpu"), \
        build_model(cfg16, device="cpu")
    p32 = m32.init(0)
    p16 = params_from_numpy({n: v.to(torch.bfloat16) for n, v in
                             leaves_with_path(p32)}, cfg16, "cpu")
    toks = np.random.default_rng(6).integers(0, 256, (2, 24)).astype(np.int32)
    out = {}
    for name, m, p in (("f32", m32, p32), ("bf16", m16, p16)):
        logits, cache, _ = m.prefill(p, {"tokens": toks}, None,
                                     m.init_cache(2, 0))
        for i in range(2):
            logits, cache, _ = m.decode_step(p, np.array([1, 2], np.int32),
                                             None, cache, 24 + i)
        assert all(leaf.dtype == torch.float32 for _, leaf in
                   leaves_with_path(cache))
        assert torch.isfinite(logits).all()
        out[name] = logits.float()
    rel = (out["bf16"] - out["f32"]).norm() / out["f32"].norm()
    assert rel < 0.1, rel


# -------------------------------------------------------------- training ----
@pytest.fixture(scope="module")
def jax_grads(models):
    """One JAX loss_fn + gradient over a length that is no chunk multiple
    (24 = 16 + 8) with a masked tail: (batch, loss, metrics, gradients,
    the static costs of the trace)."""
    jm, jp, _, _ = models
    batch = batch_of(jm.cfg, S=24)
    batch["mask"][1, 5:] = 0.0
    JAX_COSTS.reset()
    (jl, (jmet, _)), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jnp_tree(batch), jm.table())
    costs = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    return batch, jl, jmet, flat_np(jg), costs


def test_loss_and_grads_match_jax(models, jax_grads):
    """The loss and every gradient leaf; a masked tail counts nothing."""
    _, _, tm, tp = models
    batch, jl, jmet, jg, _ = jax_grads
    loss, metrics, _, grads = value_and_grad(tm, tp, batch, tm.table())
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmet["loss"]),
                               rtol=RTOL)
    assert float(metrics["tokens"]) == 29.0
    close_tree(grads, jg)


def test_remat_changes_memory_not_the_loss(models):
    """none / full / dots_saveable over the super-blocks: the same loss,
    the same gradient bits, the same static costs."""
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


def test_loss_fn_static_costs_match_one_jax_trace(models, jax_grads):
    _, _, tm, tp = models
    batch, _, _, _, want = jax_grads
    STATIC_COSTS.reset()
    value_and_grad(tm, tp, batch, None)
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def test_batch_spec_matches_jax(models):
    jm, _, tm, _ = models
    spec = tm.batch_spec(ShapeConfig("t", 64, 4, "train"))
    want = jm.batch_spec(JaxShape("t", 64, 4, "train"))
    assert spec.keys() == want.keys() == {"tokens", "labels", "mask"}
    for name, s in want.items():
        assert spec[name][0] == s.shape
        assert str(spec[name][1]).split(".")[-1] == str(s.dtype)


@pytest.mark.parametrize("micro", [1, 2])
def test_loss_curve_tracks_the_reference_trainer(models, micro):
    """Four steps from a carried reference train state on the same
    batches: the per-step losses and grad norms.  (The final params are
    not compared: AdamW moves an entry whose gradient is f32 noise by
    the learning rate either way.)"""
    from repro_torch.models import train_state_from_numpy
    steps = 4
    jm, _, tm, _ = models
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=steps,
              microbatches=micro, ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
    state = train_state_from_numpy(flat_np(jstate), tm.cfg, "cpu")
    jstep = jax.jit(jax_trainer.make_train_step(jm, jcfg))
    tstep = make_train_step(tm, tcfg)
    for step in range(steps):
        batch = batch_of(jm.cfg, B=4, S=16, step=step)
        jstate, jmet, _ = jstep(jstate, jnp_tree(batch), jm.table())
        state, met, _ = tstep(state, batch, None)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=RTOL, err_msg=f"step {step}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-3)


def test_jax_gradients_move_as_much_as_the_ports_when_the_norms_move():
    """xLSTM's gradients are sensitive to the last bit of its norms, and
    the sensitivity is the model's, not the port's: two super-blocks at
    the published 7 mLSTM + 1 sLSTM, every norm scale moved by one f32
    ulp (seeded signs), both packages on the same weights.  Each leaf of
    JAX's gradient moves within 2x as far as the port's, and the port's
    own distance from JAX is of that size too (f32 sum order alone)."""
    cfg_kw = dict(n_layers=16, slstm_every=8)
    jm = jax_build(dataclasses.replace(tiny(jax_smoke), **cfg_kw),
                   impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(dataclasses.replace(tiny(get_smoke), **cfg_kw),
                     device="cpu")
    flat, (paths, treedef) = flat_np(jp), _flatten(jp)
    rng = np.random.default_rng(5)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    moved = {n: np.nextafter(v, np.where(rng.random(v.shape) < 0.5, up,
                                         down)) if "norm" in n else v
             for n, v in flat.items()}
    batch = batch_of(jm.cfg, S=48)

    grad = jax.jit(jax.grad(
        lambda p: jm.loss_fn(p, jnp_tree(batch), jm.table())[0]))

    def jax_g(f):
        return flat_np(grad(jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(f[n]) for n, _ in paths])))

    def port_g(f):
        g = value_and_grad(tm, params_from_numpy(f, tm.cfg, "cpu"), batch,
                           None)[3]
        return {n: v.numpy() for n, v in leaves_with_path(g)}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    j0, j1, t0, t1 = jax_g(flat), jax_g(moved), port_g(flat), port_g(moved)
    for n in j0:
        move_j, move_t = rel(j1[n], j0[n]), rel(t1[n], t0[n])
        assert 0.5 * move_t <= move_j <= 2.0 * move_t, (n, move_j, move_t)
        assert rel(t0[n], j0[n]) <= 2.0 * max(move_j, move_t), n


def test_trainer_run_folds_its_steps(tmp_path):
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.runtime.trainer import Trainer
    cfg = tiny(get_smoke)
    t_ = Trainer(build_model(cfg, device="cpu"),
                 TrainConfig(ckpt_interval=0),
                 CheckpointManager(str(tmp_path / "ck")))
    _, last = t_.run(0, SyntheticLMData(cfg, 2, 16), 2, resume=False)
    assert np.isfinite(last["loss"]) and last["tokens"] == 2 * 16
    folded = t_.session.folded_all()
    assert folded.edges[("app", "loss", "train_step")].count == 2


def test_train_launcher_runs_the_arch_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-interval", "0"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: {'loss'" in out.stdout
