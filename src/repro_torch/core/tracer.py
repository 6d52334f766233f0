"""Interceptor + Tracer — host-level cross-flow interception.

Paper mapping (Scaler §3.1–§3.3): the interceptor redirects every API
invocation to the Universal Shadow Table; the tracer brackets the real call
with two timestamps and folds (count, duration) into the callee's shadow
entry, keyed by the *calling component*.

TPU/JAX adaptation of the mechanisms:

  .plt entry rewrite            ->  @xfa.api decorator on framework boundaries
                                    (selective: only registered boundaries,
                                    never whole-program instrumentation)
  return-address inspection     ->  an explicit per-thread caller stack; the
   (who called me?)                 top frame's component is the caller
  lazy PLT address resolution   ->  slot id resolved on first invocation and
                                    cached on the wrapper (no dict lookup on
                                    the steady-state hot path)
  rdtsc                         ->  time.perf_counter_ns (user-space, no
                                    syscall on Linux vDSO)
  initial-exec TLS              ->  threading.local with __slots__-style use
  dlsym interposition           ->  xfa.wrap(fn, component=...) for callables
                                    resolved at runtime (e.g. a jit'd step fn
                                    chosen from a registry)
  __noreturn handling           ->   'finally' blocks — Python exceptions are
                                    the host analogue of abnormal control flow
                                    and the frame is always popped

Wait separation (Scaler §3.5): boundaries tagged kind='wait' (blocking joins,
queue gets, device sync) fold into a separate Wait category so views can
report not-useful time distinctly.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

from .shadow import (APP_COMPONENT, KIND_CALL, KIND_WAIT, ShadowTableSet,
                     SlotInfo)

perf_ns = time.perf_counter_ns


class _Frame:
    __slots__ = ("component", "api", "start_ns", "child_ns")

    def __init__(self, component: str, api: str, start_ns: int) -> None:
        self.component = component
        self.api = api
        self.start_ns = start_ns
        self.child_ns = 0


class _Stack(threading.local):
    def __init__(self) -> None:
        self.frames: List[_Frame] = []


class Tracer:
    """Process-wide tracer: caller stack + shadow tables + enable switch.

    ``enabled=False`` reduces every instrumented call to a single attribute
    load + branch — the analogue of Scaler's "timing off, counting only"
    configuration knob, except we also allow full off for baseline runs
    (paper Table 3 measures against an uninstrumented baseline).
    """

    def __init__(self) -> None:
        self.tables = ShadowTableSet()
        self.enabled = True
        self.timing = True  # paper: counting always on, timing configurable
        #: optional adaptive overhead governor (core.sampler); None means
        #: every boundary is timed on every call
        self.sampler = None
        self._stack = _Stack()

    # -- caller identity ----------------------------------------------------
    def current_component(self) -> str:
        frames = self._stack.frames
        return frames[-1].component if frames else APP_COMPONENT

    def stack_depth(self) -> int:
        return len(self._stack.frames)

    # -- core bracket ---------------------------------------------------------
    def enter(self, component: str, api: str) -> _Frame:
        f = _Frame(component, api, perf_ns())
        self._stack.frames.append(f)
        return f

    def exit(self, frame: _Frame, slot: SlotInfo, scale: int = 1) -> int:
        end = perf_ns()
        frames = self._stack.frames
        frames.pop()
        dur = end - frame.start_ns
        if frames:
            # the parent observes the RAW elapsed time of this call (its
            # bracket measures true wall, so child <= total must hold);
            # scale-up applies only to THIS edge's folded columns
            frames[-1].child_ns += dur
        t = self.tables.table()
        if scale == 1:
            t.record(slot.slot, dur, frame.child_ns)
        else:
            t.record_scaled(slot.slot, dur, frame.child_ns, scale)
        return dur

    # -- public API -----------------------------------------------------------
    def api(self, component: str, name: Optional[str] = None,
            kind: int = KIND_CALL) -> Callable:
        """Decorator: declare `fn` a cross-flow boundary into `component`.

        Slot resolution is per-(caller, callee) edge and cached in a tiny
        dict on the wrapper; after the first call from a given caller the
        hot path does no interning (lazy-PLT analogue).
        """

        def deco(fn: Callable) -> Callable:
            api_name = name or fn.__name__
            slot_cache: Dict[str, SlotInfo] = {}

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if not self.enabled:
                    return fn(*args, **kwargs)
                caller = self.current_component()
                slot = slot_cache.get(caller)
                if slot is None:
                    slot = self.tables.registry.resolve(
                        caller, component, api_name, kind)
                    slot_cache[caller] = slot
                scale = 1
                if not self.timing:
                    scale = 0
                elif self.sampler is not None:
                    scale = self.sampler.observe(slot.slot)
                if scale == 0:
                    # counting-only / sampled-out: exact count, plus a
                    # lightweight NO-TIMESTAMP frame so nested boundaries
                    # still fold with the true caller (Relation-Aware
                    # Data Folding holds in every mode)
                    self.tables.table().record_count(slot.slot)
                    frames = self._stack.frames
                    frames.append(_Frame(component, api_name, 0))
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        frames.pop()
                frame = self.enter(component, api_name)
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.exit(frame, slot, scale)

            wrapper.__xfa__ = (component, api_name, kind)  # type: ignore
            return wrapper

        return deco

    def wait(self, component: str, name: Optional[str] = None) -> Callable:
        """Decorator for blocking boundaries (paper's Wait category)."""
        return self.api(component, name, kind=KIND_WAIT)

    def wrap(self, fn: Callable, component: str,
             name: Optional[str] = None, kind: int = KIND_CALL) -> Callable:
        """Interpose a callable obtained at runtime (the dlsym analogue)."""
        return self.api(component, name or getattr(fn, "__name__", "anon"),
                        kind)(fn)

    @contextmanager
    def scope(self, component: str, api: str = "scope", kind: int = KIND_CALL):
        """Context-manager boundary for regions that are not function calls."""
        if not self.enabled:
            yield
            return
        caller = self.current_component()
        slot = self.tables.registry.resolve(caller, component, api, kind)
        frame = self.enter(component, api)
        try:
            yield
        finally:
            self.exit(frame, slot)

    def count_event(self, component: str, api: str, n: int = 1,
                    kind: int = KIND_CALL) -> None:
        """Count-only event (no timing bracket)."""
        if not self.enabled:
            return
        caller = self.current_component()
        slot = self.tables.registry.resolve(caller, component, api, kind)
        self.tables.table().record_count(slot.slot, n)

    def record_duration(self, component: str, api: str, dur_ns: float,
                        kind: int = KIND_CALL, n: int = 1) -> None:
        """Fold an externally-measured span into the caller->component.api
        edge — for latency phases whose start and end are observed on
        different control paths and so cannot be bracketed by a decorator
        (a request's queue wait is known only at admit time, its TTFT only
        at first-token time).  `n` > 1 folds n events of dur_ns each (e.g.
        per-token decode latency attributed from one pooled tick).

        Unlike the bracketed decorators, these edges also fold a bounded
        log-bucket latency histogram (core.histogram), so latency-phase
        edges get p50/p95/p99 read-out for free; ordinary call edges stay
        at the five-column v1 footprint.  `record_gauge` deliberately does
        NOT feed histograms — gauge samples are not durations."""
        if not self.enabled:
            return
        caller = self.current_component()
        slot = self.tables.registry.resolve(caller, component, api, kind)
        t = self.tables.table()
        if not self.timing:
            t.record_count(slot.slot, n)
            return
        d = int(dur_ns)
        t.record_n(slot.slot, d, n)
        t.record_hist(slot.slot, d, n)

    def record_gauge(self, component: str, api: str, value: float,
                     kind: int = KIND_CALL) -> None:
        """Fold a dimensionless SAMPLE through the duration columns: count
        accumulates #observations, total_ns the sum, min/max the extremes
        — so mean_ns of the edge is the mean gauge value and the timeline
        view differences per-interval means for free.  Used for state the
        bracket model can't time (serve queue depth at each tick); the
        diagnosis layer reads it as saturation evidence."""
        if not self.enabled:
            return
        caller = self.current_component()
        slot = self.tables.registry.resolve(caller, component, api, kind)
        t = self.tables.table()
        if not self.timing:
            t.record_count(slot.slot)
            return
        t.record(slot.slot, int(value), 0)

    # -- overhead governor --------------------------------------------------
    def set_overhead_budget(self, budget_fraction: float,
                            recalc_every: int = 256,
                            bracket_ns: Optional[float] = None):
        """Attach (or detach, with budget <= 0) the adaptive overhead
        governor: `@api` boundaries whose estimated bracket cost pushes
        total tracer overhead past `budget_fraction` of wall time back
        off to 1-in-k timing (counting stays exact).  Returns the
        attached SamplerController (or None)."""
        if budget_fraction and budget_fraction > 0:
            from .sampler import SamplerController
            self.sampler = SamplerController(budget_fraction,
                                             recalc_every=recalc_every,
                                             bracket_ns=bracket_ns)
        else:
            self.sampler = None
        return self.sampler

    def sample_rates(self) -> Optional[Dict[int, float]]:
        """Per-slot effective sampling rates from the governor (only the
        subsampled slots; None when no governor is attached)."""
        return self.sampler.rates() if self.sampler is not None else None

    # -- lifecycle ----------------------------------------------------------
    def reset(self) -> None:
        """Zero every shadow table IN PLACE, preserving the registry: the
        `@api` wrappers cache SlotInfos interned there, so replacing the
        ShadowTableSet would leave every already-decorated boundary
        recording at indices the fresh registry re-assigns to other
        edges (stale-slot misattribution).  The governor's counters
        reset with the tables."""
        self.tables.reset()
        if self.sampler is not None:
            self.sampler.reset()

    def set_thread_group(self, group: str) -> None:
        """Tag this thread's table with a group (pipeline stage, pool name)."""
        self.tables.table(group=group)


#: process-global tracer — mirrors Scaler being LD_PRELOADed process-wide.
TRACER = Tracer()

api = TRACER.api
wait = TRACER.wait
wrap = TRACER.wrap
scope = TRACER.scope
count_event = TRACER.count_event
record_duration = TRACER.record_duration
record_gauge = TRACER.record_gauge
current_component = TRACER.current_component
set_thread_group = TRACER.set_thread_group


def set_enabled(on: bool) -> None:
    TRACER.enabled = on


def set_timing(on: bool) -> None:
    TRACER.timing = on


def set_overhead_budget(budget_fraction: float, **kwargs):
    return TRACER.set_overhead_budget(budget_fraction, **kwargs)


def reset() -> None:
    TRACER.reset()
