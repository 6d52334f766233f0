"""Relation-Aware Data Folding — the fold/merge algebra over shadow tables.

Paper mapping (Scaler §3.4 "Online Data Folder"): events are never appended
to a log; they are folded online into per-(caller → callee API) accumulators.
Memory is O(#edges), not O(#events).  The fold keeps the *relation* — the same
API invoked from two components stays two edges — so per-component accuracy
survives the folding.

This module provides the pure-data half:

  * `EdgeStats` — one folded edge: count/total/child/min/max, optional
    folded metrics, and an optional bounded latency histogram
    (core.histogram) from which p50/p95/p99 and jitter derive.
  * `FoldedTable` — edge → stats mapping with a commutative, associative
    merge, plus constructors from per-thread ShadowTables and device
    fold vectors.
  * `EdgeColumns` — the struct-of-arrays twin of FoldedTable: aligned
    numpy columns (plus the optional [N, HIST_BUCKETS] histogram block),
    row projections (`select`), key-part grouping for graph aggregation
    (`group_rows`), and round-trips to/from FoldedTable.  This is the
    shape the snapshot format serializes.
  * `merge_columns` — the vectorized N-way merge over EdgeColumns that
    the snapshot reducer uses instead of per-edge boxing.

The merge algebra is property-tested (tests/test_xfa_properties.py,
tests/test_histograms.py):

    merge(a, merge(b, c)) == merge(merge(a, b), c)      (associativity)
    merge(a, b) == merge(b, a)                          (commutativity)
    merge(a, empty) == a                                (identity)
    total_ns / count conservation under arbitrary splits of an event stream
    histogram merge = exact bucket-wise add (loss-free, order-independent)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from .histogram import HIST_BUCKETS, jitter_ns as _hist_jitter, percentile_ns
from .shadow import (KIND_CALL, KIND_NAMES, KIND_WAIT, ShadowTable,
                     ShadowTableSet, SlotInfo, SlotKey)

_I64_MAX = np.iinfo(np.int64).max


def merge_rates(rate_a: Optional[float], count_a: int,
                rate_b: Optional[float], count_b: int) -> Optional[float]:
    """Count-weighted merge of two effective sampling rates.

    `None` means fully sampled (rate 1.0).  With rate = timed/seen per
    shard, the count-weighted arithmetic mean is exactly the merged
    shard's timed/seen — so the merged rate stays the true effective
    rate.  A merge that lands back at >= 1.0 normalizes to None so
    fully-sampled data never grows a redundant column."""
    if rate_a is None and rate_b is None:
        return None
    ra = 1.0 if rate_a is None else rate_a
    rb = 1.0 if rate_b is None else rate_b
    total = count_a + count_b
    if total <= 0:
        return None
    rate = (ra * count_a + rb * count_b) / total
    return None if rate >= 1.0 else rate


@dataclass
class EdgeStats:
    """Folded statistics of one cross-flow edge (caller → component.api)."""

    count: int = 0
    total_ns: int = 0
    child_ns: int = 0
    min_ns: int = _I64_MAX
    max_ns: int = 0
    kind: int = KIND_CALL
    # extra folded metrics from the device layer (flops, bytes, tokens, ...)
    metrics: Dict[str, float] = field(default_factory=dict)
    #: optional [HIST_BUCKETS] uint64 latency histogram (core.histogram);
    #: compare=False keeps dataclass == well-defined (ndarray eq is
    #: elementwise) — conftest.assert_tables_equal compares hists explicitly
    hist: Optional[np.ndarray] = field(default=None, compare=False,
                                       repr=False)
    #: effective timing-sample rate in (0, 1) when the overhead governor
    #: subsampled this edge (core.sampler): counts are exact, time columns
    #: are unbiased scale-ups.  None means fully sampled (rate 1.0) —
    #: compare=False because None and a merged-back 1.0 are the same fact
    sample_rate: Optional[float] = field(default=None, compare=False)

    @property
    def self_ns(self) -> int:
        """Time in the callee itself, excluding its own callees (paper 'Self')."""
        return self.total_ns - self.child_ns

    @property
    def mean_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0

    # -- histogram read-out (0.0 when the edge carries no histogram) ------
    def percentile_ns(self, q: float) -> float:
        return percentile_ns(self.hist, q)

    @property
    def p50_ns(self) -> float:
        return percentile_ns(self.hist, 0.50)

    @property
    def p95_ns(self) -> float:
        return percentile_ns(self.hist, 0.95)

    @property
    def p99_ns(self) -> float:
        return percentile_ns(self.hist, 0.99)

    @property
    def jitter_ns(self) -> float:
        """Tail jitter as a percentile delta: p99 - p50."""
        return _hist_jitter(self.hist)

    @property
    def effective_rate(self) -> float:
        """sample_rate with the None == fully-sampled default resolved."""
        return 1.0 if self.sample_rate is None else self.sample_rate

    def merge(self, other: "EdgeStats") -> "EdgeStats":
        metrics = dict(self.metrics)
        for k, v in other.metrics.items():
            metrics[k] = metrics.get(k, 0.0) + v
        hist = None
        if self.hist is not None or other.hist is not None:
            hist = np.zeros(HIST_BUCKETS, dtype=np.uint64)
            if self.hist is not None:
                hist += self.hist
            if other.hist is not None:
                hist += other.hist
        return EdgeStats(
            count=self.count + other.count,
            total_ns=self.total_ns + other.total_ns,
            child_ns=self.child_ns + other.child_ns,
            min_ns=min(self.min_ns, other.min_ns),
            max_ns=max(self.max_ns, other.max_ns),
            kind=self.kind if self.count else other.kind,
            metrics=metrics,
            hist=hist,
            sample_rate=merge_rates(self.sample_rate, self.count,
                                    other.sample_rate, other.count),
        )

    def to_json(self) -> dict:
        out = {
            "count": int(self.count),
            "total_ns": int(self.total_ns),
            "child_ns": int(self.child_ns),
            "min_ns": int(self.min_ns) if self.count else None,
            "max_ns": int(self.max_ns),
            "kind": KIND_NAMES[self.kind],
            "metrics": self.metrics,
        }
        if self.hist is not None and self.hist.any():
            # sparse {bucket: count} — 160 mostly-zero ints don't belong in
            # a human-inspected json dump
            out["hist"] = {str(int(b)): int(self.hist[b])
                           for b in np.nonzero(self.hist)[0]}
        if self.sample_rate is not None:
            out["sample_rate"] = float(self.sample_rate)
        return out

    @staticmethod
    def from_json(d: dict) -> "EdgeStats":
        kind = KIND_WAIT if d.get("kind") == "wait" else KIND_CALL
        hist = None
        if d.get("hist"):
            hist = np.zeros(HIST_BUCKETS, dtype=np.uint64)
            for b, c in d["hist"].items():
                hist[int(b)] = int(c)
        return EdgeStats(
            count=d["count"],
            total_ns=d["total_ns"],
            child_ns=d["child_ns"],
            min_ns=d["min_ns"] if d.get("min_ns") is not None else _I64_MAX,
            max_ns=d["max_ns"],
            kind=kind,
            metrics=dict(d.get("metrics", {})),
            hist=hist,
            sample_rate=d.get("sample_rate"),
        )


class FoldedTable:
    """Edge → EdgeStats mapping; the offline-mergeable form of a shadow table.

    `group` tags which thread-group / host / device shard the fold came from —
    kept so attribution (serial vs parallel, imbalance) can run *before* the
    final cross-group merge, exactly like the paper merges per-thread files in
    the offline visualizer.
    """

    def __init__(self, edges: Optional[Dict[SlotKey, EdgeStats]] = None,
                 group: str = "main") -> None:
        self.edges: Dict[SlotKey, EdgeStats] = edges or {}
        self.group = group

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_shadow(table: ShadowTable, infos: Iterable[SlotInfo],
                    rates: Optional[Mapping[int, float]] = None
                    ) -> "FoldedTable":
        """`rates` attaches the governor's per-slot effective sampling
        rate (core.sampler — only subsampled slots appear) to the folded
        edges; omitted slots stay at the implicit rate-1.0 None."""
        edges: Dict[SlotKey, EdgeStats] = {}
        for info in infos:
            s = info.slot
            if s >= table.capacity or table.count[s] == 0:
                continue
            hist = None
            if table.hist is not None and table.hist[s].any():
                hist = table.hist[s].copy()
            edges[info.key] = EdgeStats(
                count=int(table.count[s]),
                total_ns=int(table.total_ns[s]),
                child_ns=int(table.child_ns[s]),
                min_ns=int(table.min_ns[s]),
                max_ns=int(table.max_ns[s]),
                kind=info.kind,
                hist=hist,
                sample_rate=rates.get(s) if rates else None,
            )
        return FoldedTable(edges, group=table.group)

    @staticmethod
    def from_set(tables: ShadowTableSet,
                 rates: Optional[Mapping[int, float]] = None
                 ) -> List["FoldedTable"]:
        infos = tables.registry.infos()
        return [FoldedTable.from_shadow(t, infos, rates=rates)
                for t in tables.tables()]

    # -- algebra --------------------------------------------------------------
    def merge(self, other: "FoldedTable") -> "FoldedTable":
        edges = {k: v for k, v in self.edges.items()}
        for k, v in other.edges.items():
            edges[k] = edges[k].merge(v) if k in edges else v
        group = self.group if self.group == other.group else "merged"
        return FoldedTable(edges, group=group)

    @staticmethod
    def merge_all(tables: Iterable["FoldedTable"]) -> "FoldedTable":
        """Pairwise per-edge merge: right for a handful of small in-memory
        tables (per-thread host folds).  Bulk N-way aggregation of already
        -columnar shards goes through merge_columns instead — the snapshot
        reducer (repro.profile) never boxes per-edge EdgeStats at all."""
        out = FoldedTable()
        for t in tables:
            out = out.merge(t)
        return out

    @staticmethod
    def merge_all_columnar(tables: Iterable["FoldedTable"]) -> "FoldedTable":
        """N-way merge via the column algebra; same per-edge stats as
        merge_all (property-tested — the `group` label can differ:
        merge_all's left fold starts from an empty 'main' table), faster
        once tables are large AND already columnar — from FoldedTable
        inputs the conversion cost eats the win, which is exactly why
        snapshots *store* columns (benchmarks/merge.py)."""
        tables = list(tables)
        if not tables:
            return FoldedTable()
        cols = merge_columns([EdgeColumns.from_folded(t) for t in tables])
        return cols.to_folded()

    def to_columns(self) -> "EdgeColumns":
        return EdgeColumns.from_folded(self)

    # -- queries --------------------------------------------------------------
    def components(self) -> List[str]:
        names = set()
        for (caller, component, _api) in self.edges:
            names.add(caller)
            names.add(component)
        return sorted(names)

    def edges_from(self, caller: str) -> Dict[SlotKey, EdgeStats]:
        return {k: v for k, v in self.edges.items() if k[0] == caller}

    def edges_into(self, component: str) -> Dict[SlotKey, EdgeStats]:
        return {k: v for k, v in self.edges.items() if k[1] == component}

    def total_ns(self) -> int:
        return sum(e.total_ns for e in self.edges.values())

    def scale_time(self, factor: float) -> "FoldedTable":
        """Scale all times (serial/parallel attribution divides by #threads).

        Histograms are DROPPED: scaling is an attribution heuristic over
        aggregates, and a per-sample distribution whose buckets no longer
        match its values would be worse than none."""
        edges = {
            k: EdgeStats(
                count=v.count,
                total_ns=int(v.total_ns * factor),
                child_ns=int(v.child_ns * factor),
                min_ns=int(v.min_ns * factor) if v.count else v.min_ns,
                max_ns=int(v.max_ns * factor),
                kind=v.kind,
                metrics=dict(v.metrics),
                sample_rate=v.sample_rate,
            )
            for k, v in self.edges.items()
        }
        return FoldedTable(edges, group=self.group)

    # -- persistence ------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "group": self.group,
            "edges": [
                {"caller": k[0], "component": k[1], "api": k[2], **v.to_json()}
                for k, v in sorted(self.edges.items())
            ],
        }

    @staticmethod
    def from_json(d: dict) -> "FoldedTable":
        edges = {
            (e["caller"], e["component"], e["api"]): EdgeStats.from_json(e)
            for e in d["edges"]
        }
        return FoldedTable(edges, group=d.get("group", "main"))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @staticmethod
    def load(path: str) -> "FoldedTable":
        with open(path) as f:
            return FoldedTable.from_json(json.load(f))

    def __len__(self) -> int:
        return len(self.edges)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FoldedTable(group={self.group!r}, edges={len(self.edges)})"


@dataclass
class EdgeColumns:
    """Struct-of-arrays form of a FoldedTable: one aligned column per stat.

    This is both the merge hot path (whole-column numpy sums/min/max after
    re-interning keys into a union index — no per-edge EdgeStats allocation)
    and the shape the profile snapshot format (repro.profile.snapshot)
    serializes.  `metric_mask` preserves metric *presence*: an edge that
    never emitted metric m stays absent after a round-trip, it does not
    become m=0.0.

    `hist` is the optional latency-histogram block ([N, HIST_BUCKETS]
    uint64, schema v2): None when no edge carries a distribution; an
    all-zero row means *that* edge carries none (every recorded sample
    lands in a bucket, so a zero row cannot be a real distribution —
    no presence mask needed).
    """

    keys: List[SlotKey]
    count: np.ndarray                  # int64 [N]
    total_ns: np.ndarray               # int64 [N]
    child_ns: np.ndarray               # int64 [N]
    min_ns: np.ndarray                 # int64 [N] (_I64_MAX when count == 0)
    max_ns: np.ndarray                 # int64 [N]
    kind: np.ndarray                   # int8  [N]
    metric_names: List[str]
    metric_values: np.ndarray          # float64 [M, N]
    metric_mask: np.ndarray            # bool    [M, N]
    group: str = "main"
    hist: Optional[np.ndarray] = None  # uint64 [N, HIST_BUCKETS] or None
    #: optional float64 [N] effective timing-sample rate column (schema
    #: v3): None when every edge is fully sampled; rows at exactly 1.0
    #: mean *that* edge is fully sampled (the None of EdgeStats)
    sample_rate: Optional[np.ndarray] = None

    @staticmethod
    def empty(group: str = "main") -> "EdgeColumns":
        z = np.zeros(0, dtype=np.int64)
        return EdgeColumns([], z, z.copy(), z.copy(), z.copy(), z.copy(),
                           np.zeros(0, dtype=np.int8), [],
                           np.zeros((0, 0), dtype=np.float64),
                           np.zeros((0, 0), dtype=bool), group=group)

    @staticmethod
    def from_folded(table: "FoldedTable") -> "EdgeColumns":
        keys = sorted(table.edges)
        n = len(keys)
        count = np.empty(n, dtype=np.int64)
        total_ns = np.empty(n, dtype=np.int64)
        child_ns = np.empty(n, dtype=np.int64)
        min_ns = np.empty(n, dtype=np.int64)
        max_ns = np.empty(n, dtype=np.int64)
        kind = np.empty(n, dtype=np.int8)
        mnames: Dict[str, int] = {}
        for k in keys:
            for m in table.edges[k].metrics:
                mnames.setdefault(m, len(mnames))
        mvals = np.zeros((len(mnames), n), dtype=np.float64)
        mmask = np.zeros((len(mnames), n), dtype=bool)
        hist = None
        if any(e.hist is not None for e in table.edges.values()):
            hist = np.zeros((n, HIST_BUCKETS), dtype=np.uint64)
        rate = None
        if any(e.sample_rate is not None for e in table.edges.values()):
            rate = np.ones(n, dtype=np.float64)  # 1.0 == fully sampled
        for j, k in enumerate(keys):
            e = table.edges[k]
            count[j] = e.count
            total_ns[j] = e.total_ns
            child_ns[j] = e.child_ns
            min_ns[j] = e.min_ns
            max_ns[j] = e.max_ns
            kind[j] = e.kind
            if hist is not None and e.hist is not None:
                hist[j] = e.hist
            if rate is not None and e.sample_rate is not None:
                rate[j] = e.sample_rate
            for m, v in e.metrics.items():
                i = mnames[m]
                mvals[i, j] = v
                mmask[i, j] = True
        return EdgeColumns(keys, count, total_ns, child_ns, min_ns, max_ns,
                           kind, list(mnames), mvals, mmask,
                           group=table.group, hist=hist, sample_rate=rate)

    # -- graph projections ---------------------------------------------------
    @property
    def self_ns(self) -> np.ndarray:
        """Derived per-edge self time column (total - child)."""
        return self.total_ns - self.child_ns

    def select(self, rows) -> "EdgeColumns":
        """Row-subset projection (bool mask or index array) keeping every
        column — including the metric matrix — aligned: the vectorized
        way to slice a profile (one component's inbound edges, one kind,
        one caller, ...) without re-boxing EdgeStats."""
        rows = np.asarray(rows)
        if rows.dtype == bool:
            rows = np.nonzero(rows)[0]
        else:
            # an empty python list arrives float64; indexing needs ints
            rows = rows.astype(np.int64)
        keys = [self.keys[int(i)] for i in rows]
        m = self.metric_values[:, rows] if len(self.metric_names) \
            else self.metric_values[:, :0]
        mm = self.metric_mask[:, rows] if len(self.metric_names) \
            else self.metric_mask[:, :0]
        h = self.hist[rows] if self.hist is not None else None
        r = self.sample_rate[rows] if self.sample_rate is not None else None
        return EdgeColumns(keys, self.count[rows], self.total_ns[rows],
                           self.child_ns[rows], self.min_ns[rows],
                           self.max_ns[rows], self.kind[rows],
                           list(self.metric_names), m, mm, group=self.group,
                           hist=h, sample_rate=r)

    def group_rows(self, by: str = "component") -> Dict[str, np.ndarray]:
        """Edge-row indices grouped by one key part: 'caller' (0),
        'component' (1) or 'api' (2).  One pass over the keys; the returned
        index arrays drive whole-column numpy reductions (np.sum over a
        fancy-indexed column), which is how FlowGraph aggregates nodes
        without boxing per-edge EdgeStats."""
        part = {"caller": 0, "component": 1, "api": 2}[by]
        groups: Dict[str, List[int]] = {}
        for j, k in enumerate(self.keys):
            groups.setdefault(k[part], []).append(j)
        return {name: np.asarray(rows, dtype=np.int64)
                for name, rows in groups.items()}

    def to_folded(self) -> "FoldedTable":
        n = len(self.keys)
        metrics: List[Dict[str, float]] = [{} for _ in range(n)]
        for i, name in enumerate(self.metric_names):
            for j in np.nonzero(self.metric_mask[i])[0]:
                metrics[j][name] = float(self.metric_values[i, j])
        edges: Dict[SlotKey, EdgeStats] = {}
        for j, k in enumerate(self.keys):
            hist = None
            if self.hist is not None and self.hist[j].any():
                hist = self.hist[j].copy()   # zero row == no distribution
            rate = None
            if self.sample_rate is not None and self.sample_rate[j] < 1.0:
                rate = float(self.sample_rate[j])  # 1.0 row == rate None
            edges[k] = EdgeStats(
                count=int(self.count[j]),
                total_ns=int(self.total_ns[j]),
                child_ns=int(self.child_ns[j]),
                min_ns=int(self.min_ns[j]),
                max_ns=int(self.max_ns[j]),
                kind=int(self.kind[j]),
                metrics=metrics[j],
                hist=hist,
                sample_rate=rate,
            )
        return FoldedTable(edges, group=self.group)

    def __len__(self) -> int:
        return len(self.keys)


def merge_columns(parts: List[EdgeColumns]) -> EdgeColumns:
    """Commutative/associative N-way merge over aligned columns.

    Keys are re-interned into one union index (the only per-edge python
    loop); every statistic then merges as one whole-column numpy scatter
    (add/min/max `.at`), matching EdgeStats.merge semantics exactly over
    the full field set:

      count / total_ns / child_ns     sum            (np.add.at)
      min_ns / max_ns                 extrema        (np.minimum/maximum.at)
      kind                            first part that actually observed
                                      the edge (count > 0) decides
      metric_values + metric_mask     sum where present; presence ORs
      hist                            exact bucket-wise add ([N, B] row
                                      scatter) — output has a hist block
                                      iff any input part has one, and a
                                      hist-less part contributes zeros
      sample_rate                     count-weighted mean (merge_rates
                                      semantics) — present iff any part
                                      carries rates; rate-less parts
                                      contribute rate 1.0 per count

    The output row order is first-seen order over `parts` (NOT sorted);
    `group` is the common group label of ALL parts — including empty
    shards, which still carry provenance — or 'merged'.
    """
    # group label from ALL parts (empty shards still carry provenance)
    groups = {p.group for p in parts}
    group = "main" if not groups else \
        (groups.pop() if len(groups) == 1 else "merged")
    parts = [p for p in parts if len(p)]
    if not parts:
        return EdgeColumns.empty(group=group)
    index: Dict[SlotKey, int] = {}
    for p in parts:
        for k in p.keys:
            if k not in index:
                index[k] = len(index)
    u = len(index)
    count = np.zeros(u, dtype=np.int64)
    total_ns = np.zeros(u, dtype=np.int64)
    child_ns = np.zeros(u, dtype=np.int64)
    min_ns = np.full(u, _I64_MAX, dtype=np.int64)
    max_ns = np.zeros(u, dtype=np.int64)
    kind = np.zeros(u, dtype=np.int8)
    decided = np.zeros(u, dtype=bool)
    mnames: Dict[str, int] = {}
    for p in parts:
        for m in p.metric_names:
            mnames.setdefault(m, len(mnames))
    mvals = np.zeros((len(mnames), u), dtype=np.float64)
    mmask = np.zeros((len(mnames), u), dtype=bool)
    hist = np.zeros((u, HIST_BUCKETS), dtype=np.uint64) \
        if any(p.hist is not None for p in parts) else None
    rate_w = np.zeros(u, dtype=np.float64) \
        if any(p.sample_rate is not None for p in parts) else None
    for p in parts:
        inv = np.fromiter((index[k] for k in p.keys), dtype=np.int64,
                          count=len(p.keys))
        np.add.at(count, inv, p.count)
        np.add.at(total_ns, inv, p.total_ns)
        np.add.at(child_ns, inv, p.child_ns)
        np.minimum.at(min_ns, inv, p.min_ns)
        np.maximum.at(max_ns, inv, p.max_ns)
        if hist is not None and p.hist is not None:
            np.add.at(hist, inv, p.hist)
        if rate_w is not None:
            prate = p.sample_rate if p.sample_rate is not None \
                else np.ones(len(p), dtype=np.float64)
            np.add.at(rate_w, inv, prate * p.count)
        und = ~decided[inv]
        kind[inv[und]] = p.kind[und]
        decided[inv] = decided[inv] | (p.count > 0)
        for i, name in enumerate(p.metric_names):
            g = mnames[name]
            present = p.metric_mask[i]
            if present.any():
                tgt = inv[present]
                np.add.at(mvals[g], tgt, p.metric_values[i][present])
                mmask[g][tgt] = True
    rate = None
    if rate_w is not None:
        rate = rate_w / np.maximum(count, 1)
        rate[count == 0] = 1.0   # a never-counted edge is trivially full
    return EdgeColumns(list(index), count, total_ns, child_ns, min_ns,
                       max_ns, kind, list(mnames), mvals, mmask, group=group,
                       hist=hist, sample_rate=rate)


def fold_event_log(events: Iterable[Tuple[str, str, str, int]],
                   kinds: Optional[Mapping[SlotKey, int]] = None) -> FoldedTable:
    """Fold an append-style event log [(caller, component, api, dur_ns), ...].

    Exists for the paper's comparison (Table 5 / §4.3.2): benchmarks build the
    same table from a raw log and from the online fold and assert equality,
    then compare memory/time.  Not used on any hot path.
    """
    edges: Dict[SlotKey, EdgeStats] = {}
    for caller, component, api, dur in events:
        key = (caller, component, api)
        e = edges.get(key)
        if e is None:
            kind = (kinds or {}).get(key, KIND_CALL)
            e = edges[key] = EdgeStats(kind=kind)
        e.count += 1
        e.total_ns += dur
        e.min_ns = min(e.min_ns, dur)
        e.max_ns = max(e.max_ns, dur)
    return FoldedTable(edges)
