"""The port's hybrid family (zamba2: Mamba2 layers + a shared attention
block) against the JAX package, on the CPU, same weights and inputs.

Inputs are made from a seed with numpy; the JAX side runs as its own
tests run it: `impl="ref"`, and the Pallas SSD kernel through
`ops.ssd_scan(impl="pallas", interpret=True)`.  Tolerances:

* SSD scan, f32: 1e-5 abs + rel.  Every version computes in f32; they
  differ by the order of their sums (the step-by-step recurrence against
  the chunked products), a few ulp of values up to ~10.
* Mamba block and forward_chunk logits: 1e-4 abs + rel, as the dense
  tests (tests/test_torch_models.py); the SSD state h, which sums over
  every step, 1e-4 relative to its largest entry.
* Greedy serving: identical tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import build_model as jax_build
from repro.models import mamba as jax_mamba
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ServeConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import mamba
from repro_torch.models.transformer import _layer
from repro_torch.serving import ServingEngine

ARCH = "zamba2_2_7b"
SSD_TOL = 1e-5
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params) on equal weights."""
    jm = jax_build(jax_smoke(ARCH), impl="ref")
    jp = jm.init(jax.random.key(0))
    flat = {name: np.asarray(leaf) for name, leaf in _flatten(jp)[0]}
    tm = build_model(torch_smoke(ARCH), device="cpu")
    return jm, jp, tm, params_from_numpy(flat, tm.cfg, "cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- SSD scan ----
def ssd_inputs(B, L, H, P, N, seed=0, h0=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, b, c = f(B, L, H, P), f(B, L, N), f(B, L, N)
    dt = np.abs(f(B, L, H)) * 0.1
    a = -np.exp(0.5 * f(H))
    return x, dt, a, b, c, (f(B, H, N, P) if h0 else None)


# B, L, H, P, N, chunk, carried state
SSD_CASES = [(1, 64, 1, 16, 8, 32, False), (2, 128, 3, 32, 16, 32, True),
             (1, 96, 2, 16, 8, 32, False), (2, 16, 2, 8, 4, 16, True),
             (2, 9, 2, 8, 4, 3, True), (1, 50, 2, 8, 4, 16, False)]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_matches_jax(case):
    """The port's plain versions (ops impl='ref' = ref.ssd_chunked; the
    kernel wrapper on the CPU = ref.ssd_scan, dtx rounded to x's dtype,
    which in f32 is no rounding; the step-by-step ref.ssd_naive) against
    the JAX recurrence, the JAX chunked oracle and the Pallas kernel in
    interpret mode.  L = 50 is padded to a chunk multiple by ops."""
    B, L, H, P, N, chunk, with_h0 = case
    x, dt, a, b, c, h0 = ssd_inputs(B, L, H, P, N, seed=L, h0=with_h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = [jax_ref.ssd_naive(x, dt, a, b, c, h0=jh0),
            jax_ops.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=jh0,
                             impl="pallas", interpret=True)]
    if L % chunk == 0:
        want.append(jax_ref.ssd_chunked(x, dt, a, b, c, chunk=chunk, h0=jh0))
    th0 = None if h0 is None else t(h0)
    got = [ops.ssd_scan(t(x), t(dt), t(a), t(b), t(c), chunk=chunk, h0=th0,
                        impl=impl) for impl in ("ref", "auto")]
    got.append(ref.ssd_naive(t(x), t(dt), t(a), t(b), t(c), h0=th0))
    for y, h in got:
        assert y.shape == (B, L, H, P) and h.dtype == torch.float32
        for wy, wh in want:
            close(y, wy, SSD_TOL)
            close(h, wh, SSD_TOL)


def test_ssd_h0_resume_matches_the_whole_scan():
    """Two halves, the second resuming from the first's state, give the
    whole scan's outputs and state: the chunked-prefill contract."""
    x, dt, a, b, c, _ = ssd_inputs(2, 64, 2, 16, 8, seed=7)
    args = [t(v) for v in (x, dt, a, b, c)]
    y_all, h_all = ops.ssd_scan(*args, chunk=16)
    half = lambda v, s: v[:, s] if v.dim() > 1 else v
    y1, h1 = ops.ssd_scan(*(half(v, slice(0, 32)) for v in args), chunk=16)
    y2, h2 = ops.ssd_scan(*(half(v, slice(32, 64)) for v in args), chunk=16,
                          h0=h1)
    close(torch.cat([y1, y2], 1), y_all, SSD_TOL)
    close(h2, h_all, SSD_TOL)
    jy, jh = jax_ref.ssd_naive(x, dt, a, b, c)
    close(y_all, jy, SSD_TOL)
    close(h2, jh, SSD_TOL)


def test_ssd_kernel_function_in_bf16_matches_the_pallas_path():
    """In bf16 the kernel's function (ref.ssd_scan, what the CPU wrapper
    runs) rounds dt*x to bf16 before the scan, as the reference's
    ops.ssd_scan does before its Pallas kernel: against that path in
    interpret mode on the same bf16 inputs, h (f32 in both) agrees to
    1e-5 and y to one bf16 rounding (2e-2, the bf16 tolerance of
    tests/test_kernels.py)."""
    x, dt, a, b, c, h0 = ssd_inputs(2, 64, 2, 16, 8, seed=9, h0=True)
    bf = lambda v: jnp.asarray(v, jnp.bfloat16)
    jy, jh = jax_ops.ssd_scan(bf(x), dt, a, bf(b), bf(c), chunk=32,
                              h0=jnp.asarray(h0), impl="pallas",
                              interpret=True)
    tb = lambda v: t(v).to(torch.bfloat16)
    y, h = ops.ssd_scan(tb(x), t(dt), t(a), tb(b), tb(c), chunk=32,
                        h0=t(h0))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    close(h, jh, SSD_TOL)
    close(y.float(), np.asarray(jy, np.float32), 2e-2)


# ------------------------------------------------------------ rmsnorm_add ----
@pytest.mark.parametrize("shape", [(64, 128), (2, 5, 40)])
def test_rmsnorm_add_matches_jax(shape):
    """ops.rmsnorm_add against the reference's, plain and Pallas
    (interpret); f32, 2e-5 as tests/test_kernels.py holds the Pallas
    kernel to its oracle."""
    rng = np.random.default_rng(3)
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in "xr")
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    y, s = ops.rmsnorm_add(t(x), t(r), t(w), eps=1e-5)
    for impl in ("ref", "pallas"):
        jy, js = jax_ops.rmsnorm_add(jnp.asarray(x), jnp.asarray(r),
                                     jnp.asarray(w), eps=1e-5, impl=impl,
                                     interpret=True)
        close(y, jy, 2e-5)
        close(s, js, 2e-5)


# ------------------------------------------------------------ mamba block ----
def block_params(jp, tp):
    jl = jax.tree.map(lambda a: a[0, 1], jp["stack"]["stack"])
    return jl, _layer(_layer(tp["stack"]["stack"], 0), 1)


@pytest.mark.parametrize("mode", ["full", "chunk", "decode"])
def test_mamba_block_matches_jax(models, mode):
    """The three modes of mamba_block on carried weights: the full
    sequence (no state, return_state), a positioned chunk resuming a
    random carried state with a bucket-padded row (valid), and the L = 1
    decode recurrence."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    jl, tl = block_params(jp, tp)
    rng = np.random.default_rng(11)
    L = {"full": 9, "chunk": 6, "decode": 1}[mode]
    x = rng.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    state = valid = None
    if mode != "full":
        conv_ch = cfg.d_inner_ + 2 * cfg.ssm_state
        state = {"conv": rng.standard_normal(
                     (2, cfg.conv_kernel - 1, conv_ch)).astype(np.float32),
                 "h": rng.standard_normal(
                     (2, cfg.n_ssm_heads, cfg.ssm_state,
                      cfg.ssm_head_dim)).astype(np.float32)}
    if mode == "chunk":
        valid = np.array([6, 4], np.int32)
    jy, jst = jax_mamba.mamba_block(
        jl, jnp.asarray(x), jm.rt,
        state=None if state is None else jax.tree.map(jnp.asarray, state),
        return_state=True,
        valid=None if valid is None else jnp.asarray(valid))
    ty, tst = mamba.mamba_block(
        tl, t(x), tm.rt,
        state=None if state is None else {k: t(v) for k, v in state.items()},
        return_state=True, valid=None if valid is None else t(valid))
    close(ty, jy)
    close(tst["conv"], jst["conv"])
    jh = np.asarray(jst["h"])
    close(tst["h"].numpy() / np.abs(jh).max(), jh / np.abs(jh).max())


# ---------------------------------------------------------- forward_chunk ----
@pytest.mark.parametrize("width,pad_to", [(1, None), (3, None), (3, 4),
                                          (9, None)])
def test_forward_chunk_matches_jax(models, width, pad_to):
    """Logits at every chunk, and the carried SSM state and shared-block
    K/V rows at the end, at widths {1, 3, 3 padded to 4, whole prompt}
    with mixed per-row depths."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tm.cfg.vocab, (2, 9)).astype(np.int32)
    pos = np.array([0, 11], np.int32)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    for start in range(0, 9, width):
        seg = tokens[:, start:start + width]
        n = seg.shape[1]
        chunk = np.zeros((2, max(pad_to or n, n)), np.int32)
        chunk[:, :n] = seg
        valid = np.full((2,), n, np.int32)
        jl, jc, _ = jm.forward_chunk(jp, jnp.asarray(chunk), None, jc,
                                     jnp.asarray(pos), jnp.asarray(valid))
        tl, tc, _ = tm.forward_chunk(tp, t(chunk), None, tc, t(pos),
                                     t(valid))
        close(tl, jl)
        pos = pos + n
    close(tc["ssm"]["conv"], jc["ssm"]["conv"])
    jh = np.asarray(jc["ssm"]["h"])
    close(tc["ssm"]["h"].numpy() / np.abs(jh).max(), jh / np.abs(jh).max())
    for name in ("attn_k", "attn_v"):
        for b, end in enumerate(pos):
            close(tc[name][:, b, :, :end], np.asarray(jc[name])[:, b, :, :end])


def test_prefill_and_decode_step_match_jax(models):
    jm, jp, tm, tp = models
    prompt = np.arange(1, 8, dtype=np.int32)[None]
    jl, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, None,
                           jm.init_cache(1, 16))
    tl, tc, _ = tm.prefill(tp, {"tokens": t(prompt)}, None,
                           tm.init_cache(1, 16))
    close(tl, jl)
    tok, at = np.array([5], np.int32), np.array([7], np.int32)
    jl, _, _ = jm.decode_step(jp, jnp.asarray(tok), None, jc,
                              jnp.asarray(at))
    tl, _, _ = tm.decode_step(tp, t(tok), None, tc, t(at))
    close(tl, jl)


@pytest.mark.parametrize("width", [1, 4])
def test_static_costs_match_one_jax_trace(models, width):
    """One port forward_chunk registers the reference's STATIC_COSTS edges
    and totals for one trace of the same call (the JAX scans trace their
    bodies once, scaled by their lengths; the port's loops run them)."""
    jm, jp, tm, tp = models
    tokens = np.ones((2, width), np.int32)
    pos = np.array([0, 3], np.int32)
    JAX_COSTS.reset()
    jm.forward_chunk(jp, jnp.asarray(tokens), None, jm.init_cache(2, 16),
                     jnp.asarray(pos))
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    tm.forward_chunk(tp, t(tokens), None, tm.init_cache(2, 16), t(pos))
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    ssd = [k for k in got if k[2] == "ssd_scan"]
    assert (len(ssd) == 1) == (width > 1)


# ----------------------------------------------------------------- weights ----
def test_params_from_numpy_is_strict_for_the_hybrid(models):
    jm, jp, tm, _ = models
    flat = {name: np.asarray(leaf) for name, leaf in _flatten(jp)[0]}
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "stack/stack/ssm/a_log"}, tm.cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(dict(flat, **{
            "shared_attn/attn/wq": flat["shared_attn/attn/wq"][:3]}),
            tm.cfg, "cpu")
    with pytest.raises(KeyError, match="does not use"):
        params_from_numpy(dict(flat, **{"stack/stack/attn/wq": np.zeros(1)}),
                          tm.cfg, "cpu")


def test_f32_leaves_stay_f32_in_a_bf16_config():
    """a_log, dt_bias and d_skip are f32 in the reference whatever
    param_dtype is; the port's init and its weight loader keep them so
    and put every other leaf in bf16, as the reference's init does."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), param_dtype="bfloat16")
    jp = jax_build(jcfg, impl="ref").init(jax.random.key(2))
    flat = dict(_flatten(jp)[0])
    tm = build_model(dataclasses.replace(torch_smoke(ARCH),
                                         param_dtype="bfloat16"),
                     device="cpu")
    f32 = {"stack/stack/ssm/a_log", "stack/stack/ssm/dt_bias",
           "stack/stack/ssm/d_skip"}
    for params in (tm.init(0), params_from_numpy(
            {k: np.asarray(v) for k, v in flat.items()}, tm.cfg, "cpu")):
        for name, leaf in flat.items():
            got = params
            for part in name.split("/"):
                got = got[part]
            want = torch.float32 if name in f32 else torch.bfloat16
            assert got.dtype == want, name
            assert str(leaf.dtype) == ("float32" if name in f32
                                       else "bfloat16"), name
    init = tm.init(0)["stack"]["stack"]["ssm"]
    assert torch.all(init["dt_bias"] == -2.0) and torch.all(init["a_log"] == 0)
    assert torch.all(init["d_skip"] == 1.0)


def test_hybrid_has_no_paged_entry_points(models):
    """As in the reference: the hybrid's recurrent state is O(1) in
    sequence length, so the engine keeps the dense layout.  (Its loss_fn
    is ported: tests/test_torch_hybrid_training.py.)"""
    _, _, tm, _ = models
    assert tm.init_paged_cache is None and tm.forward_chunk_paged is None \
        and tm.decode_step_paged is None


# ----------------------------------------------------------------- serving ----
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


PROMPTS = [np.random.default_rng(1).integers(0, 512, n).astype(np.int32)
           for n in (3, 7, 5, 9)]
MAX_NEW = [6, 5, 6, 4]


@pytest.mark.parametrize("chunk,prefill_batch", [(3, 1), (3, 4), (64, 1),
                                                 (64, 4)])
def test_greedy_tokens_match_reference_engine(models, chunk, prefill_batch):
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
    """With max_cache_pages > 0 the hybrid engine keeps its contiguous
    cache (no paged entry points), as the reference's does, and serves
    the same tokens."""
    jm, jp, tm, tp = models
    kw = dict(max_batch=4, max_seq_len=64, eos_token=-1, prefill_chunk=64,
              min_chunk_bucket=4, max_cache_pages=16, page_size=8)
    ref_engine = JaxEngine(jm, jp, JaxServeConfig(**kw))
    engine = ServingEngine(tm, tp, ServeConfig(**kw))
    assert not ref_engine.paged and not engine.paged
    assert engine.allocator is None and set(engine.cache) == {
        "ssm", "attn_k", "attn_v"}
    assert staggered_run(engine, PROMPTS, MAX_NEW) == \
        staggered_run(ref_engine, PROMPTS, MAX_NEW)
