"""Serving engine: iteration-level continuous batching behind a client API.

The PyTorch counterpart of `repro/serving/engine.py`:

    scheduler.py  admission + prefill planning (a copy of the reference)
    sampling.py   per-request sampling params as per-slot vectors, one
                  pooled sampler (greedy/temperature/top-k/top-p)
    paging.py     page accounting of the paged pool (a copy of the
                  reference)
    engine.py     the slot pool + positioned-chunk forward, the
                  background serving thread, and the client handles

EVERY model step is one `forward_chunk` — a T-token chunk written at
per-slot cache offsets: admission prefill, mid-prompt continuation
chunks and the pooled decode tick are the same operation at different
widths.  Prefill is batched ACROSS slots: each tick's selected chunks
group by width (scheduler.batched_prefill_plan) and every group runs as
ONE multi-row forward_chunk — the slots' batch=1 cache stashes are
concatenated into a [B]-row cache, advanced at per-row `pos` with
per-row `valid`, and split back (rows whose prompt completes are copied
into the pool and sample their first token).  Decode then runs ONE
width-1 chunk over the whole pool at per-slot positions.  Chunk widths
and group batch dims round up to power-of-two buckets (pad masked
in-model via `valid`), so the set of launched shapes stays
O(log prefill_batch x log max_seq_len).

Where the reference donates the cache to a jitted call, the port updates
it IN PLACE: forward_chunk writes the fresh K/V rows into the tensors it
is given (the pool for the decode tick, the gathered stash copy for a
prefill group).  Logits stay on the device; only token ids cross to the
host.  On a CUDA device the engine synchronizes before a prefill chunk's
end timestamp, so the `prefill_chunk` fold times the work, not the
enqueue.

A cache is a nested dict of tensors whose batch axis is BATCH_AXIS in
every leaf (the dense KV rows; the hybrid's SSM state and shared-block
KV); stashes gather, split and scatter leaf by leaf.  At admission a
slot's stash is a fresh zero cache, so a recurrent family's state starts
from zero.

Paged KV-cache pool (ServeConfig.max_cache_pages > 0): the contiguous
[max_batch, max_seq_len] cache becomes a fixed arena of pages plus
per-slot block tables (paging.PageAllocator owns the accounting).
Admission is gated by FREE PAGES: the scheduler's page gate reserves a
request's worst-case pages (prompt + max_new - 1 rows) or back-pressures
the FCFS queue, and pages are granted lazily as a slot's `pos` crosses
page boundaries, recycled at finish.  Prefill groups and the decode tick
write straight into the shared arena through the tables (no batch=1
stashes, no scatter); the tables stay on the host as numpy and cross to
the device once per forward call.  Pages in use, their high-water mark
and the capacity fold as `serve.cache_pages_*` gauges.  A model without
paged entry points (the hybrid family) keeps the contiguous cache.

Fleet stream (ServeConfig.xfa_collector, with profile_dir set): every
shard refresh also ships the ring's unacked entries to a collector
(`python -m repro_torch.profile collect`, or the reference's) through
profile.FleetPublisher; a dead collector degrades to local-only rings.

Client API: `submit()` returns a Request handle immediately; tokens
stream through an optional `on_token` callback and `handle.result()`
blocks until completion.  `start()` runs the engine on a background
thread (open-loop serving); without it, `run_until_drained()` drives the
same loop synchronously (closed-loop benchmarks, tests).

XFA instrumentation ('serve'), as in the reference: prefill_request and
decode_tick are traced boundaries, every batched chunk step folds a
`prefill_chunk` duration and a `prefill_batch_occupancy` gauge;
queue_wait (Wait kind), ttft, decode_token and e2e latency phases fold
via tracer.record_duration; queue_depth is a gauge; truncated_prompt,
clamped_max_new, deadline_met/deadline_miss and engine_error are count
events.  Shards land in the profile store as the reference's do, so the
port's CLI (`python -m repro_torch.profile`) and the reference's
(`python -m repro.profile`) both read them.  The device fold table
(`engine.table`, from `Model.table()`) stays on the device and is
carried through every forward call, warm-up, prefill groups and decode
ticks, contiguous and paged: an MoE model folds each expert's load,
the dropped tokens and the router losses into it
(`model.fold_spec.fold(engine.table)` reads it).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..configs.base import ServeConfig
from ..core import tracer as xfa
from ..core.shadow import KIND_WAIT
from ..models.api import Model
from ..tree import leaves_with_path, tree_map

from .paging import PageAllocator
from .sampling import GREEDY, PooledSampler, SamplingParams
from .scheduler import Scheduler

#: batch axis of every cache leaf of the ported families: the dense KV
#: rows [L, B, Hkv, S, h]; the hybrid's conv tails [L, B, K-1, ch], SSD
#: states [L, B, H, N, P] and shared-block KV [n_super, B, Hkv, S, h]
#: (checked when the engine builds its pool)
BATCH_AXIS = 1


@dataclasses.dataclass
class Request:
    """Client handle for one generation request.

    Returned by ServingEngine.submit; safe to read from other threads.
    `result()` blocks until the request finishes; `on_token` (if given)
    is invoked from the engine thread for every generated token."""
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 32
    sampling: SamplingParams = GREEDY
    submitted_at: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False            # prompt cut to fit the cache row
    #: e2e latency contract in ms (None: untracked); at finish the engine
    #: folds deadline_met/deadline_miss and sets `deadline_missed`
    deadline_ms: Optional[float] = None
    deadline_missed: Optional[bool] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    on_token: Optional[Callable[["Request", int], None]] = None
    error: Optional[BaseException] = None      # engine failure, if any
    _done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def result(self, timeout: Optional[float] = None) -> "Request":
        """Block until the request completes; raises TimeoutError, or
        RuntimeError if the engine failed while this request was live."""
        if not self._done_event.wait(timeout):
            raise TimeoutError(f"request {self.uid} not done in {timeout}s")
        if self.error is not None:
            raise RuntimeError(
                f"serving engine failed while request {self.uid} was "
                f"in flight") from self.error
        return self

    # -- latency accessors (None until the phase happened) ------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        return None if self.admitted_at is None \
            else self.admitted_at - self.submitted_at

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.first_token_at is None \
            else self.first_token_at - self.submitted_at

    @property
    def e2e_s(self) -> Optional[float]:
        return None if self.finished_at is None \
            else self.finished_at - self.submitted_at


def _scatter_slot(pool, one, slot_idx: int) -> None:
    """Copy a batch=1 cache (a nested dict of tensors) into row
    `slot_idx` of the pool, leaf by leaf, in place."""
    tree_map(lambda p, o: p.narrow(BATCH_AXIS, slot_idx, 1).copy_(o),
             pool, one)


class ServingEngine:
    def __init__(self, model: Model, params, scfg: ServeConfig) -> None:
        self.model = model
        self.params = params
        self.scfg = scfg
        self.device = model.device
        if scfg.xfa_overhead_budget > 0:
            # adaptive overhead governor: per-tick boundaries back off to
            # 1-in-k timing under load, counting stays exact (core.sampler)
            xfa.TRACER.set_overhead_budget(scfg.xfa_overhead_budget)
        self.scheduler = Scheduler(scfg)
        self.sampler = PooledSampler(scfg.max_batch)
        self.table = model.table()
        #: forward_chunk calls and the tokens they ran (rows x width, pad
        #: rows and columns included: every one is routed) since the
        #: engine was built, warm-up included
        self.forward_calls = 0
        self.forward_tokens = 0
        # paged pool: a page arena + per-slot block tables in place of the
        # contiguous [max_batch, max_seq_len] cache, admission gated by
        # free pages.  A family without paged entry points (the hybrid:
        # its recurrent state is O(1) in sequence length) keeps the dense
        # layout even when max_cache_pages is set, as in the reference.
        self.paged = bool(scfg.max_cache_pages > 0
                          and model.forward_chunk_paged is not None)
        self.allocator = None
        if self.paged:
            self.allocator = PageAllocator(scfg.max_cache_pages,
                                           scfg.page_size)
            # virtual pages per slot: a full max_seq_len row (unassigned
            # entries point at scratch page 0)
            self._n_blocks = -(-scfg.max_seq_len // scfg.page_size)
            self.block_tables = np.zeros(
                (scfg.max_batch, self._n_blocks), np.int32)
            self.cache = model.init_paged_cache(scfg.max_cache_pages,
                                                scfg.page_size)
            self._decode = model.decode_step_paged
            self._chunk = model.forward_chunk_paged
            self.scheduler.page_gate = self._page_gate
        else:
            self.cache = model.init_cache(scfg.max_batch, scfg.max_seq_len)
            for path, leaf in leaves_with_path(self.cache):
                if leaf.shape[BATCH_AXIS] != scfg.max_batch:
                    raise ValueError(
                        f"cache leaf {path} {tuple(leaf.shape)}: the "
                        f"engine takes the batch on axis {BATCH_AXIS}")
            self._decode = model.decode_step
            self._chunk = model.forward_chunk
        # (batch bucket, width) pairs scheduled so far — bounded
        # regardless of how many distinct prompt lengths arrive
        self._chunk_programs: set = set()
        self._pad_stashes: dict = {}
        self._uid = 0
        self.completed: List[Request] = []
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._error: Optional[BaseException] = None   # terminal loop failure
        self._profile_store = None
        self._publisher = None
        self._ticks = 0
        if scfg.profile_dir:
            from ..profile import ProfileStore, RetentionPolicy, register_run
            self._profile_store = ProfileStore(
                scfg.profile_dir,
                retention=RetentionPolicy(
                    keep_last=scfg.profile_keep_last,
                    max_age_s=scfg.profile_max_age_s,
                    max_bytes=scfg.profile_max_bytes))
            # one device, no mesh: the manifest records none
            register_run(
                scfg.profile_dir,
                config=model.cfg.name, arch=model.cfg.family,
                mesh_shape=None, mesh_axes=None,
                label=scfg.profile_label, kind="serve",
                meta={"max_batch": scfg.max_batch,
                      "max_seq_len": scfg.max_seq_len,
                      "device": str(self.device),
                      **({"page_size": scfg.page_size,
                          "max_cache_pages": scfg.max_cache_pages}
                         if self.paged else {}),
                      **dict(scfg.profile_meta)})
            if scfg.xfa_collector:
                from ..profile import FleetPublisher
                self._publisher = FleetPublisher(scfg.xfa_collector,
                                                 scfg.profile_dir)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _forwarded(self, rows: int, width: int) -> None:
        self.forward_calls += 1
        self.forward_tokens += rows * width

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               sampling: Optional[SamplingParams] = None,
               on_token: Optional[Callable[[Request, int], None]] = None,
               deadline_ms: Optional[float] = None) -> Request:
        """Enqueue a request; returns its handle immediately.

        `deadline_ms` sets this request's e2e latency contract (falls
        back to ServeConfig.deadline_ms when that is > 0): at finish the
        engine folds a deadline_met/deadline_miss count event and flags
        the handle.  The deadline is observational — a late request still
        completes."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the engine "
                             "always samples at least the first token)")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            # reject per-request: a malformed prompt failing inside
            # _admit would kill the engine loop and every other client
            raise ValueError(f"prompt must be a non-empty 1-D token "
                             f"array, got shape {prompt.shape}")
        if sampling is None:
            sampling = SamplingParams(
                temperature=self.scfg.temperature, top_k=self.scfg.top_k,
                top_p=self.scfg.top_p, seed=self.scfg.sample_seed)
        if deadline_ms is None and self.scfg.deadline_ms > 0:
            deadline_ms = self.scfg.deadline_ms
        # fit the request to the cache row AT SUBMIT: keep at least one
        # prompt token even when max_new_tokens alone (nearly) fills the
        # row — matches Scheduler.admit_cost
        truncated = False
        limit = max(1, self.scfg.max_seq_len - max_new_tokens - 1)
        if prompt.size > limit:
            prompt = prompt[:limit]
            truncated = True
            xfa.count_event("serve", "truncated_prompt")
        cap = self.scfg.max_seq_len - prompt.size
        if max_new_tokens > cap:
            # generation budget clamped so the slot's pos can never run
            # off the end of its cache row
            max_new_tokens = cap
            truncated = True
            xfa.count_event("serve", "clamped_max_new")
        if self.paged:
            # a request whose worst case exceeds the whole pool could never
            # pass the page gate: reject it here instead of deadlocking the
            # head of the FCFS queue
            rows = int(prompt.size) + max_new_tokens - 1
            need = self.allocator.pages_needed(rows)
            if need > self.allocator.usable:
                raise ValueError(
                    f"request needs {need} cache pages ({rows} rows at "
                    f"page_size={self.scfg.page_size}) but the pool has "
                    f"only {self.allocator.usable} usable pages "
                    f"(max_cache_pages={self.scfg.max_cache_pages}, "
                    f"page 0 reserved)")
        # timestamp BEFORE taking the lock: a tick in progress holds it,
        # and that wait is queueing delay the client really experienced
        submitted_at = time.monotonic()
        with self._work:
            if self._error is not None:
                raise RuntimeError("serving engine has failed; no further "
                                   "requests accepted") from self._error
            self._uid += 1
            req = Request(self._uid, prompt,
                          max_new_tokens, sampling=sampling,
                          submitted_at=submitted_at, on_token=on_token,
                          deadline_ms=deadline_ms, truncated=truncated)
            self.scheduler.add(req)
            self._work.notify_all()
        return req

    def start(self) -> "ServingEngine":
        """Run the engine loop on a background daemon thread.  After a
        timed-out stop() this blocks until the old loop finishes its tick
        and is reaped — there is never a second loop over the same pool."""
        while True:
            with self._lock:
                if self._error is not None:
                    raise RuntimeError("serving engine has failed; it "
                                       "cannot be restarted") from self._error
                t = self._thread
                if t is None:
                    self._stop = False
                    self._thread = threading.Thread(
                        target=self._serve_loop, name="serve-engine",
                        daemon=True)
                    self._thread.start()
                    return self
                if t.is_alive() and not self._stop:
                    return self            # genuinely running
            t.join()
            with self._lock:
                if self._thread is t:
                    self._thread = None

    def stop(self, timeout: float = 30.0) -> bool:
        """Stop the background thread (in-flight requests stay in place).
        Returns False if the loop is still finishing its current tick."""
        with self._work:
            if self._thread is None:
                return True
            self._stop = True
            self._work.notify_all()
            t = self._thread
        t.join(timeout)
        if t.is_alive():
            return False
        with self._lock:
            if self._thread is t:
                self._thread = None
        if self._publisher is not None:
            self._publisher.close()
        return True

    # -- engine internals ---------------------------------------------------
    def chunk_buckets(self) -> list:
        """Every chunk width this engine schedules under bucketing — the
        warmup surface for benchmarks."""
        scfg = self.scfg
        if not scfg.bucket_chunks:
            return []                  # unbounded: one shape per length
        out, w = [], max(scfg.min_chunk_bucket, 1)
        top = max(scfg.prefill_chunk or 1, scfg.tail_chunk or 1)
        while w < top:
            out.append(w)
            w *= 2
        out.append(w)
        return out

    def batch_buckets(self) -> list:
        """Every batch dimension batched prefill can schedule (powers of
        two up to the effective prefill_batch cap)."""
        if not self.scfg.bucket_chunks:
            return []
        out, b = [], 1
        while b < self.scheduler.prefill_batch:
            out.append(b)
            b *= 2
        out.append(b)
        return out

    def warm_chunk_programs(self) -> None:
        """Run every (batch bucket, width) prefill shape once on scratch
        caches, so a timed window measures serving, not the kernels'
        first-use build or the allocator's growth.  Warm shapes do NOT
        count toward chunk_programs; they run through the fold table, as
        in the reference, and count in forward_calls and
        forward_tokens."""
        scfg = self.scfg
        # paged: a scratch arena of the same size; the all-zero block
        # tables route every write to its scratch page
        arena = self.model.init_paged_cache(
            scfg.max_cache_pages, scfg.page_size) if self.paged else None
        for w in self.chunk_buckets() or [scfg.prefill_chunk or 1]:
            for b in self.batch_buckets() or [1]:
                tokens = self._to_device(np.zeros((b, w), np.int32))
                pos = self._to_device(np.zeros((b,), np.int32))
                valid = self._to_device(np.ones((b,), np.int32))
                if self.paged:
                    bt = self._to_device(
                        np.zeros((b, self._n_blocks), np.int32))
                    _, _, self.table = self._chunk(
                        self.params, tokens, self.table, arena, pos, bt,
                        valid)
                else:
                    cache = self.model.init_cache(b, scfg.max_seq_len)
                    _, _, self.table = self._chunk(
                        self.params, tokens, self.table, cache, pos, valid)
                self._forwarded(b, w)
        self._sync()

    @property
    def chunk_widths(self) -> frozenset:
        """Chunk widths scheduled so far: the width projection of
        chunk_programs, bounded however many distinct prompt lengths
        arrive."""
        return frozenset(w for _, w in self._chunk_programs)

    @property
    def chunk_programs(self) -> frozenset:
        """(batch_bucket, width) pairs scheduled so far."""
        return frozenset(self._chunk_programs)

    # -- paged pool ---------------------------------------------------------
    def _page_gate(self, req: Request) -> bool:
        """Scheduler admission gate: reserve the request's WORST-CASE
        pages (prompt + max_new - 1 rows; submit already fitted both to
        the row) or report back-pressure.  True has committed pages: the
        slot draws them through lazy grants, rollback paths cancel them."""
        rows = len(req.prompt) + req.max_new_tokens - 1
        return self.allocator.try_reserve(
            req.uid, self.allocator.pages_needed(rows))

    def _grant_rows(self, slot_idx: int, rows: int) -> None:
        """Ensure slot `slot_idx` owns pages covering its first `rows`
        cache rows, drawing from the allocator as the frontier crosses
        page boundaries (page 0 is never granted, so count_nonzero is the
        number of pages held)."""
        have = int(np.count_nonzero(self.block_tables[slot_idx]))
        need = self.allocator.pages_needed(rows) - have
        if need > 0:
            uid = self.scheduler.slots[slot_idx].request.uid
            pages = self.allocator.grant(uid, need)
            self.block_tables[slot_idx, have:have + need] = pages

    def _release_pages(self, slot_idx: int, req: Request) -> None:
        """Recycle a finished or failed slot's pages and clear its table."""
        if self.paged:
            self.allocator.release(req.uid)
            self.block_tables[slot_idx, :] = 0

    # -- batched cross-slot prefill -----------------------------------------
    def _pad_stash(self, rows: int):
        """Zero cache rows padding a group up to its batch bucket (valid
        masks them in-model).  Cached per size within a tick: the gather
        concatenates it (a copy), so the cached rows stay zero."""
        if rows not in self._pad_stashes:
            self._pad_stashes[rows] = self.model.init_cache(
                rows, self.scfg.max_seq_len)
        return self._pad_stashes[rows]

    def _gather_stashes(self, stashes: list, pad: int):
        """Concatenate B batch=1 stashes (+ `pad` zero rows) into one
        [B+pad]-row cache.  A single stash with no pad passes through
        untouched: prefill_batch=1 IS the per-slot path, same buffers."""
        if len(stashes) == 1 and pad == 0:
            return stashes[0]
        parts = stashes + ([self._pad_stash(pad)] if pad else [])
        return tree_map(lambda *ls: torch.cat(ls, dim=BATCH_AXIS), *parts)

    def _take_row(self, gathered, row: int):
        """Row `row` of a gathered stash as a batch=1 cache (a copy, so a
        live slot stash never aliases the gathered buffer)."""
        return tree_map(lambda t: t.narrow(BATCH_AXIS, row, 1).clone(),
                        gathered)

    def _prefill_group(self, idxs: list, ns: list, width: int) -> None:
        """One batched prefill chunk: advance the B slots in `idxs` by
        their next ns[r] tokens through a SINGLE forward_chunk at per-row
        cache offsets (width bucket-padded in T, group padded to the
        batch bucket in B, both masked via `valid`).  Rows whose prompt
        completes are copied into the pool and sample their FIRST token
        from this chunk's last-valid logits."""
        slots = self.scheduler.slots
        B = len(idxs)
        Bb = self.scheduler.batch_bucket(B)
        tokens = np.zeros((Bb, width), np.int32)
        pos = np.zeros((Bb,), np.int32)
        valid = np.zeros((Bb,), np.int32)
        for r, (i, n) in enumerate(zip(idxs, ns)):
            slot = slots[i]
            tokens[r, :n] = [slot.pending.popleft() for _ in range(n)]
            pos[r] = slot.pos
            valid[r] = n
        if self.paged:
            # grant the pages this chunk's frontier crosses, then run the
            # group straight against the shared arena: the block table IS
            # the slot's cache row.  Pad rows carry all-zero tables (their
            # writes land on the scratch page).
            for i, n in zip(idxs, ns):
                self._grant_rows(i, slots[i].pos + n)
            bt = np.zeros((Bb, self._n_blocks), np.int32)
            bt[:B] = self.block_tables[idxs]
            gathered = None
            t0 = time.perf_counter_ns()
            logits, self.cache, self.table = self._chunk(
                self.params, self._to_device(tokens), self.table, self.cache,
                self._to_device(pos), self._to_device(bt),
                self._to_device(valid))
        else:
            gathered = self._gather_stashes([slots[i].stash for i in idxs],
                                            Bb - B)
            t0 = time.perf_counter_ns()
            logits, gathered, self.table = self._chunk(
                self.params, self._to_device(tokens), self.table, gathered,
                self._to_device(pos), self._to_device(valid))
        self._forwarded(Bb, width)
        # sync before the end timestamp: kernels return before the device
        # finishes, and mid-prompt chunks have no host read to wait on
        self._sync()
        xfa.record_duration("serve", "prefill_chunk",
                            time.perf_counter_ns() - t0)
        xfa.record_gauge("serve", "prefill_batch_occupancy",
                         100.0 * B / Bb)
        self._chunk_programs.add((Bb, width))
        for r, (i, n) in enumerate(zip(idxs, ns)):
            slot = slots[i]
            slot.pos += n
            if self.paged:
                if slot.pending:
                    continue           # the arena already holds the chunk
            else:
                row = gathered if B == 1 and Bb == 1 \
                    else self._take_row(gathered, r)
                if slot.pending:
                    slot.stash = row
                    continue
                _scatter_slot(self.cache, row, i)
                slot.stash = None
            # the first token is EOS-checked — a first-token EOS finishes
            # without any decode ticks
            tok = self.sampler.sample_one(logits[r], slot.request.sampling,
                                          step=slot.pos)
            self._emit(i, tok, time.monotonic())

    @xfa.api("serve", "prefill_request")
    def _admit(self, slot_idx: int, req: Request) -> int:
        """Bind `req` to slot `slot_idx` (truncation accounting, fresh
        batch=1 stash, sampler row) and return its first prefill chunk's
        token count — the chunk itself runs in this tick's batched
        prefill groups."""
        model, scfg = self.model, self.scfg
        now = time.monotonic()
        req.admitted_at = now
        xfa.record_duration("serve", "queue_wait",
                            (now - req.submitted_at) * 1e9, kind=KIND_WAIT)
        # safety-net truncation for requests bound without going through
        # submit() (which already fitted prompt and max_new to the row)
        limit = max(1, scfg.max_seq_len - req.max_new_tokens - 1)
        prompt = req.prompt
        if len(prompt) > limit:
            prompt = prompt[:limit]
            req.truncated = True
            xfa.count_event("serve", "truncated_prompt")
        cap = scfg.max_seq_len - len(prompt)
        if req.max_new_tokens > cap:
            req.max_new_tokens = cap
            req.truncated = True
            xfa.count_event("serve", "clamped_max_new")
        # a fresh zero batch=1 stash (a recurrent family's SSM state
        # starts from zero); the paged pool writes straight into the
        # shared arena through the slot's block table, no stash
        self.scheduler.bind(slot_idx, req, pos=0, pending=prompt,
                            stash=None if self.paged
                            else model.init_cache(1, scfg.max_seq_len))
        self.sampler.bind(slot_idx, req.sampling)
        return self.scheduler.admit_cost(req)

    @xfa.api("serve", "decode_tick")
    def _tick(self) -> int:
        """One pooled width-1 forward_chunk at per-slot positions over the
        slots past prefill; returns #decoding."""
        slots = self.scheduler.slots
        active = self.scheduler.decoding()
        if not active:
            return 0
        tokens = np.zeros((self.scfg.max_batch,), np.int32)
        pos = self.scheduler.pos_vector()
        for i in active:
            tokens[i] = slots[i].request.output[-1]
        extra = ()
        if self.paged:
            # the write frontier (row `pos`) may cross into a new page
            for i in active:
                self._grant_rows(i, slots[i].pos + 1)
            extra = (self._to_device(self.block_tables),)
        t0 = time.perf_counter_ns()
        logits, self.cache, self.table = self._decode(
            self.params, self._to_device(tokens), self.table, self.cache,
            self._to_device(pos), *extra)
        self._forwarded(self.scfg.max_batch, 1)
        nxt = self.sampler(logits, step=pos + 1)     # waits for the device
        tick_ns = time.perf_counter_ns() - t0
        now = time.monotonic()
        for i in active:
            slots[i].pos += 1
            self._emit(i, int(nxt[i]), now)
        xfa.record_duration("serve", "decode_token",
                            tick_ns / len(active), n=len(active))
        return len(active)

    def _emit(self, slot_idx: int, tok: int, now: float) -> None:
        """Accept one generated token for the request in `slot_idx`."""
        req = self.scheduler.slots[slot_idx].request
        first = not req.output
        req.output.append(tok)
        if first:
            req.first_token_at = now
            xfa.record_duration("serve", "ttft",
                                (now - req.submitted_at) * 1e9)
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception:
                xfa.count_event("serve", "callback_error")
        if tok == self.scfg.eos_token or len(req.output) >= req.max_new_tokens:
            self._finish(slot_idx, now)

    def _finish(self, slot_idx: int, now: float) -> None:
        req = self.scheduler.slots[slot_idx].request
        req.done = True
        req.finished_at = now
        e2e_ns = (now - req.submitted_at) * 1e9
        xfa.record_duration("serve", "e2e", e2e_ns)
        if req.deadline_ms is not None:
            req.deadline_missed = e2e_ns > req.deadline_ms * 1e6
            xfa.count_event("serve", "deadline_miss" if req.deadline_missed
                            else "deadline_met")
        self.completed.append(req)
        self._release_pages(slot_idx, req)
        self.scheduler.release(slot_idx)
        self.sampler.release(slot_idx)
        req._done_event.set()

    def step(self) -> int:
        """One engine iteration: continuation prefill chunks for
        mid-prompt slots (oldest first), admissions under the leftover
        budget, then one pooled decode tick.  Returns the number of slots
        still active afterwards.  An error marks the engine dead and
        wakes every waiter before the exception propagates."""
        with self._lock:
            try:
                # queue depth at tick start, folded as a gauge (the
                # saturation signal `diagnose` reads)
                xfa.record_gauge("serve", "queue_depth",
                                 len(self.scheduler.waiting))
                if self.paged:
                    # pages are the admission resource: occupancy, its
                    # high-water mark and capacity fold as gauges
                    xfa.record_gauge("serve", "cache_pages_in_use",
                                     self.allocator.in_use)
                    xfa.record_gauge("serve", "cache_page_hwm",
                                     self.allocator.hwm)
                    xfa.record_gauge("serve", "cache_pages_capacity",
                                     self.allocator.usable)
                cont, deferred = self.scheduler.continuation_plan()
                # strict FCFS: if any mid-prefill slot was deferred by the
                # budget, nothing younger may spend the leftover this tick
                picked = [] if deferred else self.scheduler.schedule(
                    spent=sum(n for _, n in cont))
                items = list(cont)
                for k, (idx, req) in enumerate(picked):
                    try:
                        items.append((idx, self._admit(idx, req)))
                    except Exception as e:
                        # the failing request errors out, later ones go
                        # back to the queue head (FCFS preserved)
                        req.error = e
                        req._done_event.set()
                        self._release_pages(idx, req)
                        self.scheduler.release(idx)
                        for _, later in reversed(picked[k + 1:]):
                            if self.paged:
                                # the gate reserved pages for them; back in
                                # the queue they re-reserve at their next
                                # gate pass
                                self.allocator.cancel(later.uid)
                            self.scheduler.waiting.appendleft(later)
                        raise
                # continuations AND admissions batch together: one
                # forward_chunk per same-width group of selected chunks
                for idxs, ns, width in \
                        self.scheduler.batched_prefill_plan(items):
                    self._prefill_group(idxs, ns, width)
                # pad stashes are per-tick scratch
                self._pad_stashes.clear()
                self._tick()
                self._ticks += 1
                interval = self.scfg.profile_interval_ticks
                if self._profile_store is not None and interval \
                        and self._ticks % interval == 0:
                    self.write_profile_shard()
                return len(self.scheduler.active())
            except Exception as e:      # noqa: BLE001 — fail loud AND clean
                self._fail_outstanding(e)
                raise

    def _serve_loop(self) -> None:
        xfa.set_thread_group("serve")
        while True:
            with self._work:
                while not self._stop and not self.scheduler.has_work():
                    self._work.wait(0.05)
                if self._stop:
                    break
            try:
                self.step()
            except Exception:               # noqa: BLE001 — must not die mute
                break                       # step() already failed waiters
        self.write_profile_shard()

    def _fail_outstanding(self, exc: BaseException) -> None:
        """A serve-loop error must not strand clients on result(): mark
        every live request failed and wake its waiters."""
        xfa.count_event("serve", "engine_error")
        with self._lock:
            self._error = exc
            live = [s.request for s in self.scheduler.slots
                    if s.request is not None]
            live += list(self.scheduler.waiting)
            self.scheduler.waiting.clear()
            if self.paged:
                # recycle every page and reservation, so the allocator
                # shows the true terminal state
                for req in live:
                    self.allocator.release(req.uid)
                self.block_tables[:] = 0
            for i in self.scheduler.active():
                self.scheduler.release(i)
            for req in live:
                req.error = exc
                req._done_event.set()
            self._stop = True

    # -- profiling ----------------------------------------------------------
    def write_profile_shard(self) -> None:
        """Refresh this replica's profile shard (host tracer folds)."""
        if self._profile_store is None:
            return
        from ..profile import tracer_folded
        self._profile_store.write_shard(
            tracer_folded(), label=self.scfg.profile_label,
            meta={"ticks": self._ticks, "completed": len(self.completed)})
        if self._publisher is not None:
            # local ring first, then the delta stream; publish() never
            # raises — a dead collector degrades to local-only profiling
            with xfa.scope("serve", "profile_publish"):
                self._publisher.publish()

    # -- synchronous driver -------------------------------------------------
    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Serve until queue and pool are empty.  With a background thread
        running this just waits for quiescence; otherwise it drives the
        loop inline (closed-loop mode)."""
        t = self._thread
        if t is not None and t.is_alive():
            deadline = time.monotonic() + max_ticks * 0.1
            while True:
                with self._lock:
                    if not self.scheduler.has_work():
                        break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.002)
            return self.completed
        for _ in range(max_ticks):
            n = self.step()
            if n == 0 and not self.scheduler.has_waiting():
                break
        self.write_profile_shard()
        return self.completed
