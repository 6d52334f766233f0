"""The port's serving engine, sampler and profile shards against the
reference package, on the CPU.

* Greedy serving: staggered, mixed-length requests through the port's
  ServingEngine give the SAME tokens as the reference ServingEngine on the
  same weights, for prefill_chunk 3 and 64 and prefill_batch 1 and 4.
* Sampling: the reference's jax.random bits cannot be reproduced, so the
  port's sampler is held to the properties instead — each token a pure
  function of (seed, position), independent of batch composition and
  chunking, with top-k / top-p keeping the right support.
* Profile plane: a serve shard written by the port loads in the
  reference `repro.profile.load_profile` with the serve edges, and the
  port's snapshot writer re-saves the golden snapshots byte for byte.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import build_model as jax_build
from repro.profile import load_profile as jax_load_profile
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ServeConfig
from repro_torch.models import build_model, params_from_numpy
from repro_torch.profile import ProfileSnapshot
from repro_torch.serving import (PooledSampler, SamplingParams,
                                 ServingEngine, sample_tokens)

DATA = os.path.join(os.path.dirname(__file__), "data")
SERVE_PHASES = ("queue_wait", "ttft", "decode_token", "e2e",
                "prefill_request", "prefill_chunk", "decode_tick")


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
    return jm, jp, tm, params_from_numpy(flat, tm.cfg, "cpu")


def mixed_prompts(seed=1, lengths=(3, 7, 5, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.int32) for n in lengths]


def staggered_run(engine, prompts, max_new, sampling=None):
    """Submit mixed-length prompts at staggered ticks; drain; return reqs
    (the same schedule as tests/test_serving_engine.py)."""
    reqs = [engine.submit(prompts[0], max_new[0], sampling=sampling)]
    engine.step()
    engine.step()
    reqs.append(engine.submit(prompts[1], max_new[1], sampling=sampling))
    reqs.append(engine.submit(prompts[2], max_new[2], sampling=sampling))
    engine.step()
    reqs.append(engine.submit(prompts[3], max_new[3], sampling=sampling))
    engine.run_until_drained()
    return reqs


@pytest.mark.parametrize("chunk,prefill_batch", [(3, 1), (3, 4), (64, 1),
                                                 (64, 4)])
def test_greedy_tokens_match_reference_engine(models, chunk, prefill_batch):
    jm, jp, tm, tp = models
    kw = dict(max_batch=4, max_seq_len=64, eos_token=-1, prefill_chunk=chunk,
              min_chunk_bucket=4, prefill_batch=prefill_batch)
    prompts = mixed_prompts()
    max_new = [6, 5, 6, 4]
    want = staggered_run(JaxEngine(jm, jp, JaxServeConfig(**kw)), prompts,
                         max_new)
    engine = ServingEngine(tm, tp, ServeConfig(**kw))
    got = staggered_run(engine, prompts, max_new)
    for g, w in zip(got, want):
        assert g.done and g.output == w.output, (g.output, w.output)
    if prefill_batch > 1:
        assert max(b for b, _ in engine.chunk_programs) > 1


@pytest.mark.parametrize("bucket", [True, False])
def test_chunk_widths_match_reference_engine(models, bucket):
    """The reference's prompt-length sweep (12 lengths 3..25,
    prefill_chunk 32, min_chunk_bucket 8; its unbucketed case takes the
    first four): the port schedules the same chunk widths as the JAX
    engine, bounded with bucketing and one per length without."""
    jm, jp, tm, tp = models
    lengths = list(range(3, 27, 2))
    if not bucket:
        lengths = lengths[:4]
    kw = dict(max_batch=2, max_seq_len=64, eos_token=-1, prefill_chunk=32,
              min_chunk_bucket=8, bucket_chunks=bucket)
    widths = []
    for engine in (JaxEngine(jm, jp, JaxServeConfig(**kw)),
                   ServingEngine(tm, tp, ServeConfig(**kw))):
        rng = np.random.default_rng(4)
        for n in lengths:
            engine.submit(rng.integers(0, 256, n).astype(np.int32), 2)
        assert len(engine.run_until_drained()) == len(lengths)
        widths.append(engine.chunk_widths)
    assert widths[1] == widths[0], widths
    if bucket:
        assert widths[1] <= {8, 16, 32}
    else:
        assert len(widths[1]) == len(lengths)


# ------------------------------------------------------------- sampling ----
def _params(B, temperature=1.0, top_k=0, top_p=1.0, seed=0, step=0):
    full = lambda v, dt: torch.full((B,), v, dtype=dt)
    return (full(temperature, torch.float32), full(top_k, torch.int64),
            full(top_p, torch.float32), full(seed, torch.int64),
            full(step, torch.int64))


class TestSampler:
    def test_token_is_a_pure_function_of_seed_and_step(self):
        logits = torch.randn(1, 64, generator=torch.Generator().manual_seed(0))
        draw = lambda seed, step: int(sample_tokens(
            logits, *_params(1, seed=seed, step=step))[0])
        assert all(draw(7, s) == draw(7, s) for s in range(20))
        assert len({draw(7, s) for s in range(40)}) > 5
        assert [draw(7, s) for s in range(40)] != \
            [draw(8, s) for s in range(40)]

    def test_rows_are_independent_of_batch_composition(self):
        gen = torch.Generator().manual_seed(1)
        logits = torch.randn(5, 50, generator=gen)
        temp = torch.tensor([0.0, 1.0, 0.7, 1.3, 1.0])
        top_k = torch.tensor([0, 0, 5, 0, 3])
        top_p = torch.tensor([1.0, 0.9, 1.0, 0.5, 1.0])
        seed = torch.tensor([1, 2, 3, 4, 5])
        step = torch.tensor([10, 11, 12, 13, 14])
        batched = sample_tokens(logits, temp, top_k, top_p, seed, step)
        for i in range(5):
            one = sample_tokens(logits[i:i + 1], temp[i:i + 1],
                                top_k[i:i + 1], top_p[i:i + 1],
                                seed[i:i + 1], step[i:i + 1])
            assert int(one[0]) == int(batched[i])

    def test_top_k_and_top_p_keep_the_right_support(self):
        logits = torch.tensor([[4.0, 3.0, 2.5, 1.0, 0.0, -1.0, -2.0, -3.0]])
        top3 = {int(sample_tokens(logits, *_params(1, top_k=3, step=s))[0])
                for s in range(300)}
        assert top3 == {0, 1, 2}
        probs = torch.softmax(logits, -1)[0]
        nucleus = int(torch.searchsorted(torch.cumsum(probs, 0), 0.9)) + 1
        topp = {int(sample_tokens(logits, *_params(1, top_p=0.9, step=s))[0])
                for s in range(300)}
        assert topp == set(range(nucleus))
        greedy = {int(sample_tokens(logits, *_params(1, top_p=1e-6,
                                                     step=s))[0])
                  for s in range(50)}
        assert greedy == {0}

    def test_draws_follow_the_softmax(self):
        logits = torch.log(torch.tensor([[0.5, 0.25, 0.125, 0.125]]))
        n = 4000
        toks = [int(sample_tokens(logits, *_params(1, seed=3, step=s))[0])
                for s in range(n)]
        freq = np.bincount(toks, minlength=4) / n
        np.testing.assert_allclose(freq, [0.5, 0.25, 0.125, 0.125],
                                   atol=0.03)

    def test_pooled_and_single_row_paths_agree(self):
        sampler = PooledSampler(3)
        sp = SamplingParams(temperature=0.8, top_k=10, seed=5)
        sampler.bind(1, sp)
        logits = torch.randn(3, 40, generator=torch.Generator().manual_seed(2))
        step = np.array([4, 9, 2])
        pooled = sampler(logits, step)
        assert pooled[1] == sampler.sample_one(logits[1], sp, step=9)
        assert pooled[0] == int(torch.argmax(logits[0]))   # released: greedy

    def test_sampled_serving_is_batch_and_chunk_independent(self, models):
        _, _, tm, tp = models
        sp = SamplingParams(temperature=1.0, top_k=20, seed=11)
        prompts = mixed_prompts(seed=3)
        max_new = [5, 6, 4, 5]
        outs = []
        for batch, chunk in ((4, 3), (1, 64)):
            eng = ServingEngine(tm, tp, ServeConfig(
                max_batch=batch, max_seq_len=64, eos_token=-1,
                prefill_chunk=chunk, min_chunk_bucket=4))
            outs.append([r.output for r in
                         staggered_run(eng, prompts, max_new, sampling=sp)])
        assert outs[0] == outs[1]


# -------------------------------------------------------- profile plane ----
def test_port_serve_shard_loads_in_reference_load_profile(models, tmp_path):
    _, _, tm, tp = models
    run_dir = str(tmp_path / "serve-run")
    engine = ServingEngine(tm, tp, ServeConfig(
        max_batch=2, max_seq_len=64, eos_token=-1, profile_dir=run_dir))
    for p in mixed_prompts()[:3]:
        engine.submit(p, 4)
    done = engine.run_until_drained()
    assert len(done) == 3 and all(r.ttft_s > 0 for r in done)
    folded = jax_load_profile(run_dir).to_folded()
    serve = {k[2]: e for k, e in folded.edges.items() if k[1] == "serve"}
    for phase in SERVE_PHASES:
        assert phase in serve, f"missing serve phase {phase}"
    assert serve["ttft"].count >= 3 and serve["e2e"].count >= 3
    assert serve["decode_token"].count >= sum(len(r.output)
                                              for r in done) - 3


@pytest.mark.parametrize("version", [1, 2, 3])
def test_golden_snapshots_resave_byte_identically(version, tmp_path):
    golden = os.path.join(DATA, f"golden_v{version}.xfa.npz")
    snap = ProfileSnapshot.load(golden)
    assert snap.schema == version
    out = str(tmp_path / "resaved.xfa.npz")
    snap.save(out, compress=False)
    with open(golden, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


class TestEngineSemantics:
    """The engine's client-facing behaviour, ported with it: truncation
    and clamping as the reference does them, EOS, deadlines, the
    background thread, and failures that never strand a client."""

    @staticmethod
    def pair(models, **kw):
        jm, jp, tm, tp = models
        return (JaxEngine(jm, jp, JaxServeConfig(**kw)),
                ServingEngine(tm, tp, ServeConfig(**kw)))

    @staticmethod
    def count(edge):
        from repro_torch.profile import tracer_folded
        return sum(e.count for k, e in tracer_folded().edges.items()
                   if k[2] == edge)

    @pytest.mark.parametrize("plen,max_new,max_seq", [(40, 4, 32),
                                                      (5, 64, 16)])
    def test_truncation_and_clamping_match_reference(self, models, plen,
                                                     max_new, max_seq):
        prompt = np.random.default_rng(0).integers(0, 256, plen)
        before = self.count("truncated_prompt") + self.count("clamped_max_new")
        outs = []
        for engine in self.pair(models, max_batch=1, max_seq_len=max_seq,
                                eos_token=-1):
            req = engine.submit(prompt, max_new_tokens=max_new)
            engine.run_until_drained()
            assert req.done and req.truncated
            assert max(s.pos for s in engine.scheduler.slots) <= max_seq
            outs.append(req.output)
        assert outs[0] == outs[1]
        assert self.count("truncated_prompt") \
            + self.count("clamped_max_new") > before

    def test_first_token_eos_finishes_at_admission(self, models):
        _, _, tm, tp = models
        prompt = mixed_prompts()[1]
        probe = ServingEngine(tm, tp, ServeConfig(max_batch=1, max_seq_len=64,
                                                  eos_token=-1))
        first = probe.submit(prompt, 3)
        probe.run_until_drained()
        engine = ServingEngine(tm, tp, ServeConfig(
            max_batch=1, max_seq_len=64, eos_token=first.output[0]))
        req = engine.submit(prompt, 8)
        engine.run_until_drained()
        assert req.output == [first.output[0]]

    def test_deadlines_fold_met_and_miss(self, models):
        _, _, tm, tp = models
        engine = ServingEngine(tm, tp, ServeConfig(max_batch=2,
                                                   max_seq_len=64))
        met0, miss0 = self.count("deadline_met"), self.count("deadline_miss")
        ok = engine.submit(mixed_prompts()[0], 2, deadline_ms=1e9)
        late = engine.submit(mixed_prompts()[1], 2, deadline_ms=1e-6)
        engine.run_until_drained()
        assert ok.deadline_missed is False and late.deadline_missed is True
        assert self.count("deadline_met") == met0 + 1
        assert self.count("deadline_miss") == miss0 + 1

    @pytest.mark.parametrize("prompt", [np.zeros((0,), np.int32),
                                        np.zeros((2, 3), np.int32)])
    def test_malformed_requests_rejected_per_request(self, models, prompt):
        _, _, tm, tp = models
        engine = ServingEngine(tm, tp, ServeConfig(max_batch=1,
                                                   max_seq_len=64))
        with pytest.raises(ValueError):
            engine.submit(prompt, 2)
        with pytest.raises(ValueError):
            engine.submit(np.ones((3,), np.int32), max_new_tokens=0)

    def test_background_thread_streams_and_restarts(self, models):
        _, _, tm, tp = models
        engine = ServingEngine(tm, tp, ServeConfig(
            max_batch=2, max_seq_len=64, eos_token=-1)).start()
        streamed = []
        try:
            h1 = engine.submit(mixed_prompts()[0], 5,
                               on_token=lambda r, t: streamed.append(t))
            h2 = engine.submit(mixed_prompts()[1], 4)
            assert h1.result(timeout=60).done and h2.result(timeout=60).done
            assert streamed == h1.output and len(h2.output) == 4
        finally:
            assert engine.stop()
        engine.start()
        try:
            h3 = engine.submit(mixed_prompts()[2], 3)
            assert len(h3.result(timeout=60).output) == 3
        finally:
            assert engine.stop()

    @pytest.mark.parametrize("threaded", [False, True])
    def test_failure_wakes_every_waiter(self, models, threaded):
        _, _, tm, tp = models
        engine = ServingEngine(tm, tp, ServeConfig(max_batch=2,
                                                   max_seq_len=64))

        def boom(*a, **k):
            raise RuntimeError("injected decode failure")
        engine._decode = boom
        if threaded:
            engine.start()
        try:
            bad = engine.submit(mixed_prompts()[0], 4)
            if not threaded:
                with pytest.raises(RuntimeError, match="injected"):
                    engine.step()
            with pytest.raises(RuntimeError, match="failed"):
                bad.result(timeout=60)
            with pytest.raises(RuntimeError, match="failed"):
                engine.submit(np.ones((3,), np.int32), 2)
        finally:
            engine.stop()


def test_paged_engine_option_builds(models):
    """max_cache_pages builds the paged pool (tests/test_torch_paging.py)."""
    _, _, tm, tp = models
    assert ServingEngine(tm, tp, ServeConfig(max_cache_pages=16)).paged


def spool_matches_local(spool_run, local):
    """The spooled run reduces to the local run's edges and counts, and
    every local ring entry was spooled byte for byte."""
    from repro_torch.profile import ProfileStore, load_profile
    got = load_profile(spool_run).to_folded()
    want = load_profile(local).to_folded()
    assert {k: (e.count, e.total_ns) for k, e in got.edges.items()} == \
        {k: (e.count, e.total_ns) for k, e in want.edges.items()}
    spooled = {}
    for d, _, files in os.walk(spool_run):
        for f in files:
            if f.endswith(".xfa.npz"):
                spooled[f] = os.path.join(d, f)
    ring = [p for r in ProfileStore(local).shards().values() for _, p in r]
    assert ring and len(spooled) >= len(ring)
    for p in ring:
        with open(p, "rb") as a, open(spooled[os.path.basename(p)],
                                      "rb") as b:
            assert a.read() == b.read(), p


def test_engine_streams_its_profile_ring_to_a_collector(models, tmp_path):
    """xfa_collector with profile_dir: the open-loop engine ships every
    shard refresh to an in-process collector, acked; the spool equals the
    local profile dir, and stop() closes the stream."""
    from repro_torch.profile import Collector
    _, _, tm, tp = models
    local = str(tmp_path / "serve-run")
    with Collector(str(tmp_path / "spool"), timeout=10.0) as col:
        engine = ServingEngine(tm, tp, ServeConfig(
            max_batch=2, max_seq_len=64, profile_dir=local,
            profile_interval_ticks=2,
            xfa_collector="127.0.0.1:%d" % col.port))
        published = []
        publish = engine._publisher.publish
        engine._publisher.publish = lambda: published.append(publish()) \
            or published[-1]
        engine.start()
        try:
            for p in mixed_prompts():
                engine.submit(p, 4)
            engine.run_until_drained()
        finally:
            assert engine.stop()
        assert not engine._publisher.connected      # closed with the engine
    assert len(published) >= 2
    assert all(st["errors"] == 0 and st["pending"] == 0
               for st in published), published
    assert sum(st["shipped"] for st in published) >= 2
    spool_matches_local(str(tmp_path / "spool" / "serve-run"), local)


def test_engine_serves_on_with_a_dead_collector(models, tmp_path):
    """publish() never raises: a collector that is gone leaves the local
    ring written and every request served."""
    from repro_torch.profile import Collector, load_profile
    _, _, tm, tp = models
    col = Collector(str(tmp_path / "spool")).start()
    port = col.port
    col.shutdown()
    local = str(tmp_path / "serve-run")
    engine = ServingEngine(tm, tp, ServeConfig(
        max_batch=2, max_seq_len=64, profile_dir=local,
        xfa_collector="127.0.0.1:%d" % port))
    for p in mixed_prompts():
        engine.submit(p, 3)
    done = engine.run_until_drained()
    assert len(done) == 4 and all(len(r.output) == 3 for r in done)
    assert engine._publisher.last_error and not engine._publisher.connected
    edges = load_profile(local).to_folded().edges
    assert set(SERVE_PHASES) <= {k[2] for k in edges if k[1] == "serve"}
