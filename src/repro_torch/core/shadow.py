"""Universal Shadow Table — the host-side slot store for Cross Flow Analysis.

Paper mapping (Scaler §3.2, Figure 2): every interceptable API, regardless of
how it is linked (.rela.plt / .rela.dyn / dlsym), maps to ONE fixed-size
*shadow entry* that carries everything the interceptor needs, so attribution
is O(1), allocation-free and uniform across API kinds.

TPU/JAX adaptation: the "APIs" are framework boundaries (host framework calls,
in-graph module applications, HLO collectives).  A shadow entry is a row in a
set of preallocated flat numpy arrays.  Slot resolution happens ONCE per
(caller-component, callee-component, api) edge — the analogue of lazy PLT
resolution — after which the hot path is two integer loads and a few adds,
with no hashing and no allocation (the paper explicitly rejects hash tables on
the hot path; we intern to dense ids instead).

Relation-awareness (Scaler §3.4): the slot key *includes the caller
component*, so the same callee API invoked from two different components folds
into two distinct slots.  That is exactly the paper's Relation-Aware Data
Folding invariant and is what keeps per-component views accurate.

Threading (Scaler §3.3): every thread owns its own ShadowTable (lock-free hot
path, no false sharing); the SlotRegistry is shared so slot ids agree across
threads, and per-thread tables are merged offline (views.py / folding.py).
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .histogram import HIST_BUCKETS, bucket_index

# Slot kinds — 'wait' is separated per Scaler §3.5 ("Wait" pseudo-category:
# condvar/barrier/lock time means the program is not doing useful work).
KIND_CALL = 0
KIND_WAIT = 1
KIND_NAMES = {KIND_CALL: "call", KIND_WAIT: "wait"}

#: the component attributed when nothing is on the caller stack — the paper's
#: "application itself" island.
APP_COMPONENT = "app"

SlotKey = Tuple[str, str, str]  # (caller_component, callee_component, api)


def edge_label(key: SlotKey) -> str:
    """Canonical printable form of an edge key, 'caller -> comp.api'.

    THE one definition: timeline JSON keys, rendered tables, and the
    thresholds-JSON band index all use it — a divergence would silently
    orphan every saved calibration, so nobody re-spells this format."""
    caller, comp, api = key
    return f"{caller} -> {comp}.{api}"


@dataclass(frozen=True)
class SlotInfo:
    """Static metadata of one shadow entry (the paper's per-API struct)."""

    slot: int
    caller: str
    component: str
    api: str
    kind: int = KIND_CALL

    @property
    def key(self) -> SlotKey:
        return (self.caller, self.component, self.api)


class SlotRegistry:
    """Interns (caller, component, api) edges to dense slot ids.

    Shared across threads; the lock is taken only on FIRST resolution of an
    edge (the slow path — mirroring the dynamic linker resolving a PLT entry
    once).  Steady-state lookups go through a plain dict read, which is
    GIL-atomic in CPython; the returned id is then cached by the call site so
    even the dict read disappears from the hot path.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_key: Dict[SlotKey, SlotInfo] = {}
        self._infos: List[SlotInfo] = []

    def resolve(self, caller: str, component: str, api: str,
                kind: int = KIND_CALL) -> SlotInfo:
        key = (caller, component, api)
        info = self._by_key.get(key)
        if info is not None:
            return info
        with self._lock:
            info = self._by_key.get(key)
            if info is None:
                info = SlotInfo(len(self._infos), caller, component, api, kind)
                self._infos.append(info)
                self._by_key[key] = info
        return info

    def __len__(self) -> int:
        return len(self._infos)

    def info(self, slot: int) -> SlotInfo:
        return self._infos[slot]

    def infos(self) -> List[SlotInfo]:
        return list(self._infos)


class ShadowTable:
    """One thread's shadow entries: preallocated flat arrays, grown by doubling.

    Per-slot stats (the fold): count, total_ns, child_ns (time spent inside
    callees of this call — used to compute self time), min_ns, max_ns.
    ``record`` is the entire hot path: bounds check + 5 array updates.

    An optional ``hist`` block ([cap, HIST_BUCKETS] uint64 bucket counts,
    see core.histogram) is allocated lazily on the first ``record_hist``:
    call sites that never ask for distributions pay nothing, and the cost
    is bounded per slot, never per event.
    """

    __slots__ = ("count", "total_ns", "child_ns", "min_ns", "max_ns",
                 "hist", "_cap", "thread_name", "group", "group_explicit")

    INITIAL_CAPACITY = 256

    def __init__(self, thread_name: str = "main", group: str = "main",
                 capacity: int = INITIAL_CAPACITY) -> None:
        self._cap = int(capacity)
        self.thread_name = thread_name
        #: thread *group* (e.g. pipeline stage name) for imbalance analysis
        self.group = group
        #: True once the group was set deliberately (vs the thread-name
        #: default) — retired accumulators key on explicit groups only
        self.group_explicit = False
        self.count = np.zeros(self._cap, dtype=np.int64)
        self.total_ns = np.zeros(self._cap, dtype=np.int64)
        self.child_ns = np.zeros(self._cap, dtype=np.int64)
        self.min_ns = np.full(self._cap, np.iinfo(np.int64).max, dtype=np.int64)
        self.max_ns = np.zeros(self._cap, dtype=np.int64)
        #: lazily-allocated [cap, HIST_BUCKETS] uint64 block; None until the
        #: first record_hist keeps hist-less tables at the v1 footprint
        self.hist: Optional[np.ndarray] = None

    # -- hot path ---------------------------------------------------------
    def record(self, slot: int, dur_ns: int, child_ns: int = 0) -> None:
        if slot >= self._cap:
            self._grow(slot + 1)
        self.count[slot] += 1
        self.total_ns[slot] += dur_ns
        self.child_ns[slot] += child_ns
        if dur_ns < self.min_ns[slot]:
            self.min_ns[slot] = dur_ns
        if dur_ns > self.max_ns[slot]:
            self.max_ns[slot] = dur_ns

    def record_count(self, slot: int, n: int = 1) -> None:
        """Count-only fold (paper: counting is always on; timing is optional)."""
        if slot >= self._cap:
            self._grow(slot + 1)
        self.count[slot] += n

    def record_n(self, slot: int, dur_ns: int, n: int) -> None:
        """Fused fold of `n` events of `dur_ns` each — exactly equivalent
        to `n` calls of ``record(slot, dur_ns, 0)`` but O(1): the pooled
        serving tick attributes one tick across its active requests
        without a per-token python loop."""
        if n <= 0:
            return
        if slot >= self._cap:
            self._grow(slot + 1)
        self.count[slot] += n
        self.total_ns[slot] += n * dur_ns
        if dur_ns < self.min_ns[slot]:
            self.min_ns[slot] = dur_ns
        if dur_ns > self.max_ns[slot]:
            self.max_ns[slot] = dur_ns

    def record_scaled(self, slot: int, dur_ns: int, child_ns: int,
                      scale: int) -> None:
        """Fold one TIMED SAMPLE standing for `scale` calls (overhead
        governor, core.sampler): count moves by 1 — the other scale-1
        calls were already counted exactly by ``record_count`` — while
        total/child fold scaled by `scale` (the unbiased estimate of the
        untimed calls' contribution).  Extrema update from the RAW
        sample: min/max are observations, never estimates."""
        if slot >= self._cap:
            self._grow(slot + 1)
        self.count[slot] += 1
        self.total_ns[slot] += dur_ns * scale
        self.child_ns[slot] += child_ns * scale
        if dur_ns < self.min_ns[slot]:
            self.min_ns[slot] = dur_ns
        if dur_ns > self.max_ns[slot]:
            self.max_ns[slot] = dur_ns

    def record_hist(self, slot: int, dur_ns: int, n: int = 1) -> None:
        """Fold `n` events of one duration into the slot's latency
        histogram (n > 1: the fused pooled-tick fold, or a subsampled
        edge's bucket increment scaled by its stride).  Callers pair
        this with ``record``/``record_n`` (it does not touch
        count/total) — only durations belong here, never gauge
        samples."""
        if n <= 0:
            return
        if slot >= self._cap:
            self._grow(slot + 1)
        if self.hist is None:
            self.hist = np.zeros((self._cap, HIST_BUCKETS), dtype=np.uint64)
        self.hist[slot, bucket_index(dur_ns)] += n

    # -- slow paths -------------------------------------------------------
    def _grow(self, needed: int) -> None:
        new_cap = self._cap
        while new_cap < needed:
            new_cap *= 2
        for name in ("count", "total_ns", "child_ns", "max_ns"):
            arr = getattr(self, name)
            new = np.zeros(new_cap, dtype=np.int64)
            new[: self._cap] = arr
            setattr(self, name, new)
        new_min = np.full(new_cap, np.iinfo(np.int64).max, dtype=np.int64)
        new_min[: self._cap] = self.min_ns
        self.min_ns = new_min
        if self.hist is not None:
            new_hist = np.zeros((new_cap, HIST_BUCKETS), dtype=np.uint64)
            new_hist[: self._cap] = self.hist
            self.hist = new_hist
        self._cap = new_cap

    @property
    def capacity(self) -> int:
        return self._cap

    def nbytes(self) -> int:
        """Memory footprint — O(#slots), never O(#events) (paper Table 5)."""
        base = sum(getattr(self, n).nbytes
                   for n in ("count", "total_ns", "child_ns", "min_ns", "max_ns"))
        return base + (self.hist.nbytes if self.hist is not None else 0)

    def active_slots(self) -> np.ndarray:
        return np.nonzero(self.count[: self._cap])[0]

    def snapshot_copy(self) -> "ShadowTable":
        """Deep copy of the stats arrays (taken under the set's lock so a
        concurrent retire-sweep can't mutate data already handed out)."""
        t = ShadowTable(self.thread_name, self.group, capacity=self._cap)
        t.group_explicit = self.group_explicit
        t.count[:] = self.count
        t.total_ns[:] = self.total_ns
        t.child_ns[:] = self.child_ns
        t.min_ns[:] = self.min_ns
        t.max_ns[:] = self.max_ns
        if self.hist is not None:
            t.hist = self.hist.copy()
        return t

    def absorb(self, other: "ShadowTable") -> None:
        """Fold another table's slots into this one (sums + extrema).  Used
        to retire dead threads' tables: slot ids are registry-global, so the
        columns align and the merge is exact."""
        if other.capacity > self._cap:
            self._grow(other.capacity)
        n = other.capacity
        self.count[:n] += other.count
        self.total_ns[:n] += other.total_ns
        self.child_ns[:n] += other.child_ns
        np.minimum(self.min_ns[:n], other.min_ns, out=self.min_ns[:n])
        np.maximum(self.max_ns[:n], other.max_ns, out=self.max_ns[:n])
        if other.hist is not None:
            if self.hist is None:
                self.hist = np.zeros((self._cap, HIST_BUCKETS),
                                     dtype=np.uint64)
            self.hist[:n] += other.hist

    def reset(self) -> None:
        self.count[:] = 0
        self.total_ns[:] = 0
        self.child_ns[:] = 0
        self.min_ns[:] = np.iinfo(np.int64).max
        self.max_ns[:] = 0
        if self.hist is not None:
            self.hist[:] = 0


class ShadowTableSet:
    """All per-thread tables of one process + the shared registry.

    The paper persists each thread's data at thread exit and merges offline;
    we keep tables addressable here and let folding.py do the merge.  Tables
    for exited threads are retained (the paper's __cxa_thread_atexit handler
    keeps the data alive until the main thread persists it).
    """

    #: dead tables tolerated before a sweep folds them into the per-group
    #: retired accumulators (keeps short-lived-thread churn — e.g. one ckpt
    #: writer thread per save — from growing the table list without bound,
    #: while preserving per-thread granularity for small thread counts).
    RETIRE_SWEEP_THRESHOLD = 32

    def __init__(self) -> None:
        self.registry = SlotRegistry()
        # list, NOT a dict keyed on thread ident: CPython recycles `th.ident`
        # once a thread exits, so an ident-keyed map silently overwrites a
        # dead thread's table — losing its folds before the offline merge.
        self._live: List[Tuple[weakref.ref, ShadowTable]] = []
        self._retired: Dict[str, ShadowTable] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    def table(self, group: Optional[str] = None) -> ShadowTable:
        t = getattr(self._tls, "table", None)
        if t is None:
            th = threading.current_thread()
            t = ShadowTable(thread_name=th.name, group=group or th.name)
            t.group_explicit = group is not None
            with self._lock:
                self._live.append((weakref.ref(th), t))
                if len(self._live) > self.RETIRE_SWEEP_THRESHOLD:
                    self._sweep_locked()
            self._tls.table = t
        elif group is not None:
            t.group = group
            t.group_explicit = True
        return t

    def _sweep_locked(self) -> None:
        """Fold dead threads' tables into per-group accumulators (the
        paper's persist-at-thread-exit, done lazily under the lock)."""
        live = []
        for ref, t in self._live:
            th = ref()
            if th is not None and th.is_alive():
                live.append((ref, t))
                continue
            # unnamed threads' default group is their (unique) thread name —
            # pool them, or uniquely-named churn would defeat the sweep
            key = t.group if t.group_explicit else "retired"
            acc = self._retired.get(key)
            if acc is None:
                acc = self._retired[key] = ShadowTable(
                    thread_name=f"retired:{key}", group=key)
            acc.absorb(t)
        self._live = live

    def tables(self) -> List[ShadowTable]:
        # retired accumulators are COPIED under the lock: a later sweep
        # absorbs dead live-tables into them in place, and a caller holding
        # both a dead table and a post-sweep accumulator would double-count
        with self._lock:
            return [t for _, t in self._live] + \
                [r.snapshot_copy() for r in self._retired.values()]

    def iter_edges(self) -> Iterator[Tuple[SlotInfo, ShadowTable]]:
        for t in self.tables():
            for slot in t.active_slots():
                yield self.registry.info(int(slot)), t

    def nbytes(self) -> int:
        return sum(t.nbytes() for t in self.tables())

    def reset(self) -> None:
        # operate on the real tables, not the copies tables() hands out
        with self._lock:
            for _, t in self._live:
                t.reset()
            for r in self._retired.values():
                r.reset()
