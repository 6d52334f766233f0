"""Adaptive overhead governor — per-edge sampling with unbiased scale-up.

Scaler's pitch is profiling cheap enough to leave on in production
(~20% at 100% tracing, paper Tables 1/3).  This module makes that claim
*adaptive* in the ScALPEL shape (PAPERS.md: scalable adaptive
lightweight performance evaluation — back instrumentation off where it
costs the most) without giving up the paper's Table 6 argument against
naive sampling:

  * COUNTING IS ALWAYS ON.  Back-off only ever drops the *timing
    bracket* (two timestamps + the five-column record); every call still
    folds an exact `count` increment.  Short-burst edges are therefore
    never lost — the failure mode benchmarks/sampling.py reproduces for
    time-based samplers cannot happen here.
  * Back-off is COUNT-PROPORTIONAL and PER-EDGE: each edge keeps one
    timed sample in `k` calls (`k` a power of two, decided per edge), so
    an edge firing 10x as often still contributes 10x the samples, and a
    cold edge stays at sample-every-call.
  * Scale-up is UNBIASED: a timed sample standing for `k` calls folds
    `total_ns`/`child_ns` (and, where the edge carries one, histogram
    bucket increments) scaled by `k`, while `count` stays exact from the
    always-on counter.  Averaged over the `k` sampling phases the scaled
    fold equals the full-trace fold exactly (property-tested in
    tests/test_sampler.py).

The controller's self-cost estimate is deliberately cheap: every
`recalc_every` events of an edge it divides the elapsed wall time into
the window to get the edge's event rate, multiplies by the calibrated
per-bracket cost, and compares the *sum over edges* against the
configured budget (`TrainConfig.xfa_overhead_budget` /
`ServeConfig.xfa_overhead_budget`).  All hot edges then converge to the
smallest power-of-two stride that brings estimated total bracket
overhead back under budget; when load drops they relax back toward
stride 1.  Per-slot state lives in plain python lists — increments are
GIL-serialized in CPython, and a lost controller increment under racing
threads only perturbs the *heuristic*, never the authoritative shadow
table counts.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

perf_ns = time.perf_counter_ns

#: floor for the calibrated bracket cost — a degenerate 0 estimate would
#: disable back-off entirely on very fast clocks.
MIN_BRACKET_NS = 50.0


def estimate_bracket_ns(iters: int = 4000) -> float:
    """Measure the cost of one timing bracket (enter + exit + record) on
    a scratch tracer: the difference between a traced no-op and a plain
    no-op call, per invocation.  Runs in ~a few ms at import-of-governor
    time, never on the hot path."""
    from .tracer import Tracer

    t = Tracer()

    @t.api("xfa_calibrate")
    def _traced() -> None:
        return None

    def _plain() -> None:
        return None

    for _ in range(256):          # warm caches, intern the slot
        _traced()
        _plain()
    t0 = perf_ns()
    for _ in range(iters):
        _plain()
    base = perf_ns() - t0
    t1 = perf_ns()
    for _ in range(iters):
        _traced()
    traced = perf_ns() - t1
    return max((traced - base) / iters, MIN_BRACKET_NS)


class SamplerController:
    """Per-edge sampling decisions for the tracer's timing brackets.

    `observe(slot)` is the hot-path entry: it counts the event and
    returns the scale `k` to time this call with (fold stats * k), or 0
    when the call should fold a count only.  Strides start at 1
    (sample every call) and move in powers of two.
    """

    def __init__(self, budget_fraction: float, recalc_every: int = 256,
                 bracket_ns: Optional[float] = None,
                 max_stride: int = 1 << 16,
                 clock: Callable[[], int] = perf_ns) -> None:
        if budget_fraction <= 0:
            raise ValueError("budget_fraction must be > 0 (use "
                             "Tracer.set_overhead_budget(0) to detach)")
        self.budget = float(budget_fraction)
        self.recalc_every = int(recalc_every)
        self.max_stride = int(max_stride)
        self._clock = clock
        self.bracket_ns = float(bracket_ns) if bracket_ns \
            else estimate_bracket_ns()
        self._lock = threading.Lock()      # slot-state growth only
        self._stride = []                  # current 1-in-k stride per slot
        self._seen = []                    # cumulative events per slot
        self._timed = []                   # cumulative timed samples per slot
        self._window_start = []            # wall ns at last recalc per slot
        self._full_cost = []               # est. overhead fraction at k=1
        self._total_full = 0.0             # sum of _full_cost over slots

    # -- hot path ---------------------------------------------------------
    def observe(self, slot: int) -> int:
        """Count one event on `slot`; return the scale to time it with
        (>= 1), or 0 to skip the timing bracket for this call."""
        if slot >= len(self._stride):
            self._ensure(slot)
        n = self._seen[slot] + 1
        self._seen[slot] = n
        if n % self.recalc_every == 0:
            self._recalc(slot)
        k = self._stride[slot]
        if k <= 1 or n % k == 0:
            self._timed[slot] += 1
            return k
        return 0

    # -- slow paths -------------------------------------------------------
    def _ensure(self, slot: int) -> None:
        with self._lock:
            now = self._clock()
            while len(self._stride) <= slot:
                self._stride.append(1)
                self._seen.append(0)
                self._timed.append(0)
                self._window_start.append(now)
                self._full_cost.append(0.0)

    def _recalc(self, slot: int) -> None:
        """Re-estimate this edge's full-trace cost (bracket cost x event
        rate over the window just closed) and re-derive its stride from
        the total estimated overhead vs the budget.  Cold edges recalc
        rarely and keep a stale (tiny) cost contribution — acceptable
        for a governor whose decisions only move timing fidelity."""
        now = self._clock()
        dt = now - self._window_start[slot]
        self._window_start[slot] = now
        if dt <= 0:
            return
        full = self.bracket_ns * self.recalc_every / dt
        self._total_full += full - self._full_cost[slot]
        self._full_cost[slot] = full
        need = self._total_full / self.budget
        k = 1
        while k < need and k < self.max_stride:
            k <<= 1
        self._stride[slot] = k

    # -- read-out ---------------------------------------------------------
    def rates(self) -> Dict[int, float]:
        """Effective per-slot sampling rate (timed / seen) for every slot
        that was actually subsampled; fully-timed slots are omitted
        (rate 1.0 is the implicit default everywhere downstream)."""
        out: Dict[int, float] = {}
        for slot, seen in enumerate(self._seen):
            if seen and self._timed[slot] < seen:
                out[slot] = self._timed[slot] / seen
        return out

    def strides(self) -> Dict[int, int]:
        """Slots currently backed off (stride > 1) -> their stride."""
        return {s: k for s, k in enumerate(self._stride) if k > 1}

    def stride(self, slot: int) -> int:
        return self._stride[slot] if slot < len(self._stride) else 1

    def set_stride(self, slot: int, k: int) -> None:
        """Pin a slot's stride (tests / manual override).  `k` must be a
        power of two; the next `_recalc` may move it again."""
        if k < 1 or (k & (k - 1)):
            raise ValueError(f"stride must be a power of two, got {k}")
        self._ensure(slot)
        self._stride[slot] = k

    def reset(self) -> None:
        """Forget all counters and strides (paired with Tracer.reset —
        slot ids survive, so state arrays keep their length)."""
        with self._lock:
            n = len(self._stride)
            now = self._clock()
            self._stride = [1] * n
            self._seen = [0] * n
            self._timed = [0] * n
            self._window_start = [now] * n
            self._full_cost = [0.0] * n
            self._total_full = 0.0


def fold_event(table, slot: int, dur_ns: int, k: int,
               hist: bool = False) -> None:
    """Fold one governed event into a ShadowTable given the sampling
    decision `k` from `SamplerController.observe`: k == 0 counts only,
    k == 1 is a plain full fold, k > 1 folds the sample scaled by k
    (counts stay exact either way).  This is the clock-free, thread-free
    twin of the tracer hot path — tests and benchmarks replay synthetic
    event streams through it deterministically."""
    if k == 0:
        table.record_count(slot)
    elif k == 1:
        table.record(slot, dur_ns, 0)
        if hist:
            table.record_hist(slot, dur_ns)
    else:
        table.record_scaled(slot, dur_ns, 0, k)
        if hist:
            table.record_hist(slot, dur_ns, k)
