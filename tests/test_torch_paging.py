"""The port's paged KV-cache pool against the reference package, on the CPU.

Same numpy inputs and weights through both packages:

* PageAllocator: one reserve/grant/release/cancel sequence gives equal
  page ids, `in_use` and `hwm` in the port's copy and the reference's.
* update_cache_pages: the in-place scatter equals the reference's
  functional one on every page but scratch page 0 (where pad rows of
  several batch rows collide, in no specified order), including pad rows
  with zero tables and a write past NB * page_size (the clip).
* The plain paged attention versions against the JAX oracles and the
  Pallas kernels in interpret mode, at tests/test_kernels.py::tol (2e-5
  in f32, 2e-2 in bf16); scratch-page garbage cannot leak; a decode row
  with kv_len == 0 gives zeros, as the Pallas kernel does.
* forward_chunk_paged logits within 1e-4 of the JAX model's at chunk
  widths {1, 3, 3 padded to 4, whole}.
* The paged engine: greedy tokens identical to the port's contiguous
  engine and to the reference paged engine, FCFS back-pressure, the
  structured rejection at submit, page recycling, the (batch, width)
  program set, and the page gauges in a shard the reference reads.
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
from repro.kernels import decode_attention as jdec
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models.layers import update_cache_pages as jax_update_pages
from repro.profile import load_profile as jax_load_profile
from repro.serving import PageAllocator as JaxPageAllocator
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ServeConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import update_cache_pages
from repro_torch.serving import PageAllocator, ServingEngine

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
PAGE_GAUGES = ("cache_pages_in_use", "cache_page_hwm",
               "cache_pages_capacity")


def tol(name):
    return 2e-2 if name == "bf16" else 2e-5


def pair(x, dt="f32"):
    """One numpy array as (jax array, torch tensor) in dtype `dt`."""
    jd, td = DTYPES[dt]
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x.copy()).to(td)


def close(t, j, dt):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol(dt), rtol=tol(dt))


def tiny(getter):
    return dataclasses.replace(getter("tinyllama_1_1b"), n_layers=2,
                               vocab=256)


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params) on equal weights."""
    jm = jax_build(tiny(jax_smoke), impl="ref")
    jp = jm.init(jax.random.key(0))
    flat = {name: np.asarray(leaf) for name, leaf in _flatten(jp)[0]}
    tm = build_model(tiny(torch_smoke), device="cpu")
    yield jm, jp, tm, params_from_numpy(flat, tm.cfg, "cpu")
    jax.clear_caches()


def mixed_prompts(seed=1, lengths=(3, 7, 5, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def paged_kw(chunk, pages=40, **kw):
    return dict(max_batch=3, max_seq_len=64, eos_token=-1,
                prefill_chunk=chunk, min_chunk_bucket=4, page_size=8,
                max_cache_pages=pages, **kw)


# ------------------------------------------------------------ allocator ----
def test_allocator_matches_reference_sequence():
    ours, theirs = PageAllocator(12, 4), JaxPageAllocator(12, 4)

    def both(method, *args):
        a, b = getattr(ours, method)(*args), getattr(theirs, method)(*args)
        assert a == b, (method, args, a, b)
        assert (ours.in_use, ours.hwm) == (theirs.in_use, theirs.hwm)
        return a

    assert both("pages_needed", 9) == 3
    assert both("try_reserve", 1, 5)
    assert both("try_reserve", 2, 4)
    assert not both("try_reserve", 3, 3)       # 9 committed of 11
    both("grant", 1, 2)
    both("grant", 2, 4)
    both("grant", 1, 3)
    both("release", 2)
    assert both("try_reserve", 3, 6)
    both("cancel", 3)
    both("grant", 1, 0)
    both("release", 1)
    assert both("try_reserve", 4, 11)
    both("grant", 4, 11)
    assert ours.hwm == 11 and ours.in_use == 11
    with pytest.raises(RuntimeError):
        ours.grant(4, 1)                       # over-draws its reservation


@pytest.mark.parametrize("n_pages,page_size", [(1, 4), (0, 4), (4, 0)])
def test_allocator_rejects_degenerate_pools(n_pages, page_size):
    for cls in (PageAllocator, JaxPageAllocator):
        with pytest.raises(ValueError):
            cls(n_pages, page_size)


# ----------------------------------------------------- update_cache_pages ----
@pytest.mark.parametrize("pos,T", [([0, 7, 19], 5),    # straddles pages
                                   ([30, 2, 0], 5),    # past NB*ps: clip
                                   ([3, 11, 24], 1)])  # decode width
def test_update_cache_pages_matches_reference(pos, T):
    rng = np.random.default_rng(2)
    P, Hkv, ps, D, NB = 13, 2, 8, 4, 4
    arena = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    src = rng.standard_normal((3, Hkv, T, D)).astype(np.float32)
    bt = np.zeros((3, NB), np.int32)
    bt[0] = [5, 1, 9, 3]
    bt[1] = [12, 2, 0, 0]          # last two slots ungranted: scratch page
    # row 2 is a pad row: an all-zero table routes every write to page 0
    p = np.asarray(pos, np.int32)
    want = np.asarray(jax_update_pages(jnp.asarray(arena), jnp.asarray(src),
                                       jnp.asarray(p), jnp.asarray(bt)))
    t = torch.from_numpy(arena.copy())
    got = update_cache_pages(t, torch.from_numpy(src), torch.from_numpy(p),
                             torch.from_numpy(bt))
    assert got is t                # in place: the port's donation
    np.testing.assert_array_equal(t.numpy()[1:], want[1:])
    # pages no table points at are untouched
    for page in (4, 6, 7, 8, 10, 11):
        np.testing.assert_array_equal(t.numpy()[page], arena[page])


# ---------------------------------------------------- attention oracles ----
def arena_case(rng, B, Hkv, NB, ps, D, limits):
    """A page arena (numpy, f32) whose block tables are a permutation of
    pages 1..B*NB; slots past each row's limit point at scratch page 0,
    which holds large finite garbage."""
    P = 1 + B * NB
    k = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    v = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    k[0], v[0] = 1e4, -1e4
    bt = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    for b, lim in enumerate(limits):
        bt[b, -(-lim // ps):] = 0
    return k, v, bt


CHUNK_CASES = [
    # B, Hq, Hkv, T, NB, ps, D, pos
    (3, 4, 2, 5, 4, 8, 64, (0, 9, 22)),       # GQA
    (2, 4, 1, 8, 3, 16, 32, (40, 3)),         # MQA, pages of 16
    (2, 4, 4, 6, 5, 16, 80, (0, 77)),         # G 1, head dim 80, past NB*ps
    (3, 8, 2, 1, 3, 8, 64, (0, 23, 11)),      # T 1, the last column
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_attention_paged_matches_reference(dt, case):
    B, Hq, Hkv, T, NB, ps, D, pos = case
    rng = np.random.default_rng(3)
    k, v, bt = arena_case(rng, B, Hkv, NB, ps, D, [p + T for p in pos])
    (jq, tq), (jk, tk), (jv, tv) = (pair(x, dt) for x in (
        rng.standard_normal((B, Hq, T, D)), k, v))
    jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
    jpos, tpos = jnp.asarray(pos, jnp.int32), torch.tensor(pos,
                                                          dtype=torch.int32)
    got = tops.chunk_attention_paged(tq, tk, tv, block_table=tbt, pos=tpos,
                                     impl="ref")
    close(got, jref.chunk_attention_paged(jq, jk, jv, block_table=jbt,
                                          pos=jpos), dt)
    close(got, jdec.chunk_attention_paged(jq, jk, jv, block_table=jbt,
                                          pos=jpos, interpret=True), dt)


DECODE_CASES = [
    # B, Hq, Hkv, NB, ps, D, kv_len
    (3, 8, 2, 4, 8, 64, (1, 13, 32)),
    (3, 4, 1, 3, 16, 32, (48, 17, 5)),        # MQA, pages of 16
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_paged_matches_reference(dt, case):
    B, Hq, Hkv, NB, ps, D, lens = case
    rng = np.random.default_rng(4)
    k, v, bt = arena_case(rng, B, Hkv, NB, ps, D, lens)
    (jq, tq), (jk, tk), (jv, tv) = (pair(x, dt) for x in (
        rng.standard_normal((B, Hq, D)), k, v))
    jbt, tbt = jnp.asarray(bt), torch.from_numpy(bt)
    jl, tl = jnp.asarray(lens, jnp.int32), torch.tensor(lens,
                                                        dtype=torch.int32)
    got = tops.decode_attention_paged(tq, tk, tv, block_table=tbt,
                                      kv_len=tl, impl="ref")
    close(got, jref.decode_attention_paged(jq, jk, jv, block_table=jbt,
                                           kv_len=jl), dt)
    close(got, jdec.decode_attention_paged(jq, jk, jv, block_table=jbt,
                                           kv_len=jl, interpret=True), dt)


def test_scratch_page_garbage_cannot_leak():
    """What scratch page 0 holds never reaches an output: the plain
    versions give the same result with page 0 zeroed or full of
    garbage."""
    rng = np.random.default_rng(5)
    B, Hq, Hkv, T, NB, ps, D = 3, 4, 2, 2, 4, 8, 32
    pos = [1, 9, 17]
    k, v, bt = arena_case(rng, B, Hkv, NB, ps, D, [p + T for p in pos])
    q = torch.from_numpy(rng.standard_normal((B, Hq, T, D)).astype(
        np.float32))
    tbt, tpos = torch.from_numpy(bt), torch.tensor(pos, dtype=torch.int32)
    clean_k, clean_v = k.copy(), v.copy()
    clean_k[0] = clean_v[0] = 0.0
    outs = []
    for kk, vv in ((k, v), (clean_k, clean_v)):
        kk, vv = torch.from_numpy(kk), torch.from_numpy(vv)
        outs.append((tref.chunk_attention_paged(q, kk, vv, block_table=tbt,
                                                pos=tpos),
                     tref.decode_attention_paged(q[:, :, 0], kk, vv,
                                                 block_table=tbt,
                                                 kv_len=tpos + 1)))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_empty_decode_row_gives_zeros_as_the_pallas_kernel():
    """kv_len == 0: zeros, held against the Pallas kernel (the JAX oracle
    gives the mean of v there, ROADMAP section 3)."""
    rng = np.random.default_rng(6)
    B, Hq, Hkv, NB, ps, D = 2, 4, 2, 4, 8, 32
    lens = (0, 19)
    k, v, bt = arena_case(rng, B, Hkv, NB, ps, D, lens)
    (jq, tq), (jk, tk), (jv, tv) = (pair(x) for x in (
        rng.standard_normal((B, Hq, D)), k, v))
    got = tops.decode_attention_paged(
        tq, tk, tv, block_table=torch.from_numpy(bt),
        kv_len=torch.tensor(lens, dtype=torch.int32), impl="ref")
    want = jdec.decode_attention_paged(
        jq, jk, jv, block_table=jnp.asarray(bt),
        kv_len=jnp.asarray(lens, jnp.int32), interpret=True)
    close(got, want, "f32")
    assert torch.all(got[0] == 0)


def test_kernel_impl_on_cpu_raises_and_auto_launches_nothing():
    rng = np.random.default_rng(7)
    k, v, bt = arena_case(rng, 2, 2, 4, 8, 32, (8, 20))
    tk, tv, tbt = (torch.from_numpy(x) for x in (k, v, bt))
    q = torch.from_numpy(rng.standard_normal((2, 4, 3, 32)).astype(
        np.float32))
    pos = torch.tensor([5, 17], dtype=torch.int32)
    lens = pos + 1
    with pytest.raises(ValueError, match="CUDA"):
        tops.chunk_attention_paged(q, tk, tv, block_table=tbt, pos=pos,
                                   impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tops.decode_attention_paged(q[:, :, 0], tk, tv, block_table=tbt,
                                    kv_len=lens, impl="kernel")
    tops.reset_launch_counts()
    tops.chunk_attention_paged(q, tk, tv, block_table=tbt, pos=pos)
    tops.decode_attention_paged(q[:, :, 0], tk, tv, block_table=tbt,
                                kv_len=lens)
    assert not any(tops.launch_counts().values())


# --------------------------------------------------------------- model ----
@pytest.mark.parametrize("width,pad_to", [(1, None), (3, None), (3, 4),
                                          (9, None)])
def test_forward_chunk_paged_matches_jax(models, width, pad_to):
    """Two rows at mixed depths through permuted block tables (pages of
    8, 4 per row); row 1 starts mid-page at depth 11."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 256, (2, 9)).astype(np.int32)
    pos = np.array([0, 11], np.int32)
    bt = np.array([[3, 7, 1, 5], [2, 8, 6, 4]], np.int32)
    jc, tc = jm.init_paged_cache(9, 8), tm.init_paged_cache(9, 8)
    jt, tt = jm.table(), tm.table()
    for start in range(0, 9, width):
        seg = tokens[:, start:start + width]
        n = seg.shape[1]
        w = max(pad_to or n, n)
        chunk = np.zeros((2, w), np.int32)
        chunk[:, :n] = seg
        valid = np.full((2,), n, np.int32)
        jl, jc, jt = jm.forward_chunk_paged(
            jp, jnp.asarray(chunk), jt, jc, jnp.asarray(pos),
            jnp.asarray(bt), jnp.asarray(valid))
        tl, tc, tt = tm.forward_chunk_paged(
            tp, torch.from_numpy(chunk), tt, tc, torch.from_numpy(pos),
            torch.from_numpy(bt), torch.from_numpy(valid))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        pos = pos + n
    # the arenas agree on every page a row wrote (pad rows aside: page 0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy()[:, 1:],
                                   np.asarray(jc[name], np.float32)[:, 1:],
                                   atol=1e-4, rtol=1e-4)


def test_decode_step_paged_matches_jax(models):
    jm, jp, tm, tp = models
    bt = np.array([[4, 2], [0, 0]], np.int32)       # row 1: a pad row
    tok = np.array([5, 0], np.int32)
    at = np.array([9, 0], np.int32)
    rng = np.random.default_rng(9)
    shape = (tm.cfg.n_layers, 5, tm.cfg.n_kv_heads, 4, tm.cfg.head_dim_)
    arena = {n: rng.standard_normal(shape).astype(np.float32)
             for n in ("k", "v")}
    jl, _, _ = jm.decode_step_paged(
        jp, jnp.asarray(tok), jm.table(),
        {n: jnp.asarray(a) for n, a in arena.items()}, jnp.asarray(at),
        jnp.asarray(bt))
    tl, _, _ = tm.decode_step_paged(
        tp, torch.from_numpy(tok), tm.table(),
        {n: torch.from_numpy(a.copy()) for n, a in arena.items()},
        torch.from_numpy(at), torch.from_numpy(bt))
    np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0], atol=1e-4,
                               rtol=1e-4)


# -------------------------------------------------------------- engine ----
def staggered_run(engine, prompts, max_new):
    reqs = [engine.submit(prompts[0], max_new[0])]
    engine.step()
    engine.step()
    reqs.append(engine.submit(prompts[1], max_new[1]))
    reqs.append(engine.submit(prompts[2], max_new[2]))
    engine.step()
    reqs.append(engine.submit(prompts[3], max_new[3]))
    engine.run_until_drained()
    return reqs


@pytest.mark.parametrize("chunk", [64, 3, 1])
def test_paged_engine_tokens_match_contiguous_and_reference(models, chunk):
    """chunk 64: whole-prompt admissions; 3 (bucketed to 4): padded chunks
    whose pad rows write through zero table slots onto scratch page 0;
    1: token-at-a-time prefill crossing a page edge every 8th step."""
    jm, jp, tm, tp = models
    prompts = mixed_prompts(lengths=(3, 17, 5, 9))
    max_new = [6, 5, 6, 4]
    kw = paged_kw(chunk, pages=12)
    want = staggered_run(JaxEngine(jm, jp, JaxServeConfig(**kw)), prompts,
                         max_new)
    paged = ServingEngine(tm, tp, ServeConfig(**kw))
    assert paged.paged
    got = staggered_run(paged, prompts, max_new)
    dense = staggered_run(ServingEngine(tm, tp, ServeConfig(
        **dict(kw, max_cache_pages=0))), prompts, max_new)
    for g, d, w in zip(got, dense, want):
        assert g.done and g.output == d.output == w.output, \
            (g.output, d.output, w.output)
    assert paged.allocator.in_use == 0 and not paged.block_tables.any()


def test_page_exhaustion_backpressures_fcfs_without_reorder(models):
    """3 free slots but pages for about one long request: the queue head
    waits on pages, younger requests do not jump it, and all complete
    with the contiguous engine's tokens."""
    _, _, tm, tp = models
    rng = np.random.default_rng(11)
    long = rng.integers(0, 256, 40).astype(np.int32)
    shorts = [rng.integers(0, 256, 6).astype(np.int32) for _ in range(2)]
    # 40+6-1 rows -> 6 pages of 8; 7 usable pages fit one long OR both
    # shorts (2 pages each), never a long plus anything
    eng = ServingEngine(tm, tp, ServeConfig(**paged_kw(64, pages=8)))
    r_long = eng.submit(long, max_new_tokens=6)
    r_shorts = [eng.submit(s, max_new_tokens=6) for s in shorts]
    eng.step()
    assert len(eng.scheduler.active()) == 1
    for _ in range(8):
        eng.step()
        if not r_long.done:
            assert len(eng.scheduler.active()) == 1
            assert [r.uid for r in eng.scheduler.waiting] == \
                [r.uid for r in r_shorts]
    eng.run_until_drained()
    assert eng.allocator.hwm <= eng.allocator.usable
    dense = ServingEngine(tm, tp, ServeConfig(**paged_kw(64, pages=0)))
    want = [dense.submit(p, 6) for p in [long] + shorts]
    dense.run_until_drained()
    for r, w in zip([r_long] + r_shorts, want):
        assert r.done and r.output == w.output
    assert eng.allocator.in_use == 0


def test_request_larger_than_the_pool_fails_at_submit(models):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, ServeConfig(**paged_kw(64, pages=4)))
    prompt = np.arange(40, dtype=np.int32)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(prompt, max_new_tokens=8)
    assert eng.allocator.in_use == 0 and not eng.scheduler.waiting
    r = eng.submit(prompt[:10], max_new_tokens=4)
    eng.run_until_drained()
    assert r.done and len(r.output) == 4


def test_two_waves_recycle_pages_and_drain_clean(models):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, ServeConfig(**paged_kw(64, pages=24)))
    prompts = mixed_prompts(seed=9, lengths=(9, 5, 12, 7))

    def wave():
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run_until_drained()
        assert all(r.done for r in reqs)

    wave()
    hwm = eng.allocator.hwm
    assert 0 < hwm <= eng.allocator.usable
    wave()
    assert eng.allocator.hwm == hwm
    assert eng.allocator.in_use == 0
    assert not eng.block_tables.any()
    assert eng._pad_stashes == {}


def test_paging_keeps_the_chunk_program_set(models):
    _, _, tm, tp = models
    prompts = mixed_prompts(seed=6, lengths=(3, 7, 5, 9, 11, 4))

    def programs(pages):
        eng = ServingEngine(tm, tp, ServeConfig(**paged_kw(4, pages=pages)))
        for p in prompts:
            eng.submit(p, 3)
        eng.run_until_drained()
        return eng.chunk_programs

    assert programs(40) == programs(0)


def test_failure_releases_every_page(models):
    _, _, tm, tp = models
    eng = ServingEngine(tm, tp, ServeConfig(**paged_kw(64, pages=24)))

    def boom(*a, **k):
        raise RuntimeError("injected decode failure")
    eng._decode = boom
    reqs = [eng.submit(p, 4) for p in mixed_prompts()]
    with pytest.raises(RuntimeError, match="injected"):
        eng.step()
    assert all(r.error is not None for r in reqs)
    assert eng.allocator.in_use == 0 and not eng.block_tables.any()


def test_page_gauges_load_in_reference_profile(models, tmp_path):
    _, _, tm, tp = models
    run_dir = str(tmp_path / "paged-run")
    eng = ServingEngine(tm, tp, ServeConfig(**paged_kw(
        64, profile_dir=run_dir, profile_interval_ticks=1)))
    for p in mixed_prompts(seed=8, lengths=(5, 9)):
        eng.submit(p, 4)
    eng.run_until_drained()
    folded = jax_load_profile(run_dir).to_folded()
    serve = {k[2]: e for k, e in folded.edges.items() if k[1] == "serve"}
    for gauge in PAGE_GAUGES:
        assert gauge in serve and serve[gauge].count > 0, gauge
