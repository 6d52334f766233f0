"""Cross Flow Graph — the typed graph form of a folded XFA profile.

Scaler's views (component view / API view / flow matrix) answer "where
did the time go" for a human; automated diagnosis needs the same data as
a *graph*: components as nodes, caller -> callee.api relations as typed
edges, with the count/total/self/wait aggregates precomputed on both.
ScalAna (PAPERS.md) builds exactly such a program-performance graph to
localize scaling losses; this module is the XFA analogue built from
merged `EdgeColumns`, so construction is whole-column numpy reductions
over `EdgeColumns.group_rows`, never per-edge python loops over stats.

Two projections matter for diagnosis:

  * the MERGED graph of a run (all shards reduced) — what wait-dominance,
    hot-edge and call-amplification detectors read;
  * PER-SHARD graphs (one per trainer rank / serving replica, from the
    newest ring entry of each shard) — comparable subgraphs of one run,
    which is what rank/replica imbalance detection needs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.folding import EdgeColumns, FoldedTable
from ..core.histogram import jitter_ns as _hist_jitter, percentile_ns
from ..core.shadow import KIND_NAMES, KIND_WAIT, SlotKey, edge_label


@dataclass(frozen=True)
class FlowEdge:
    """One typed caller -> component.api relation with folded aggregates."""

    key: SlotKey
    kind: int
    count: int
    total_ns: int
    child_ns: int
    min_ns: int
    max_ns: int
    metrics: Dict[str, float] = field(default_factory=dict)
    #: optional latency histogram (schema v2); compare=False keeps the
    #: frozen dataclass' == well-defined despite the ndarray
    hist: Optional[np.ndarray] = field(default=None, compare=False,
                                       repr=False)
    #: effective timing-sample rate (schema v3) when the overhead governor
    #: subsampled this edge; None == fully sampled.  Counts stay exact,
    #: time columns are unbiased scale-ups — detectors can weigh evidence
    #: from subsampled edges accordingly
    sample_rate: Optional[float] = field(default=None, compare=False)

    @property
    def caller(self) -> str:
        return self.key[0]

    @property
    def component(self) -> str:
        return self.key[1]

    @property
    def api(self) -> str:
        return self.key[2]

    @property
    def self_ns(self) -> int:
        return self.total_ns - self.child_ns

    @property
    def mean_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0

    # -- histogram read-out (0.0 for hist-less edges) ---------------------
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
        return _hist_jitter(self.hist)

    def to_json(self) -> dict:
        return {
            "key": list(self.key),
            "kind": KIND_NAMES[self.kind],
            "count": int(self.count),
            "total_ns": int(self.total_ns),
            "self_ns": int(self.self_ns),
            "metrics": dict(self.metrics),
        }


@dataclass
class FlowNode:
    """One component with inbound/outbound aggregates.

    `in_*` sums every edge INTO the component (time spent inside it, by
    caller); `wait_ns` is the inbound wait-kind share of that (Scaler
    §3.5's Wait category); `self_ns` is inbound total minus inbound child
    — the time the component spent in its own body.  `out_*` sums edges
    FROM the component (time it spent calling into others)."""

    name: str
    in_count: int = 0
    in_total_ns: int = 0
    in_child_ns: int = 0
    wait_count: int = 0
    wait_ns: int = 0
    out_count: int = 0
    out_total_ns: int = 0

    @property
    def self_ns(self) -> int:
        return max(self.in_total_ns - self.in_child_ns, 0)

    @property
    def wait_share(self) -> float:
        return self.wait_ns / self.in_total_ns if self.in_total_ns else 0.0

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "in_count": int(self.in_count),
            "in_total_ns": int(self.in_total_ns),
            "self_ns": int(self.self_ns),
            "wait_ns": int(self.wait_ns),
            "wait_share": self.wait_share,
            "out_total_ns": int(self.out_total_ns),
        }


class FlowGraph:
    """Typed cross-flow graph of one profile (or one shard of one run)."""

    def __init__(self, edges: Dict[SlotKey, FlowEdge],
                 nodes: Dict[str, FlowNode], group: str = "main",
                 meta: Optional[Dict] = None) -> None:
        self.edges = edges
        self.nodes = nodes
        self.group = group
        self.meta = dict(meta or {})
        self._out: Dict[str, List[SlotKey]] = {}
        self._in: Dict[str, List[SlotKey]] = {}
        for k in sorted(edges):
            self._out.setdefault(k[0], []).append(k)
            self._in.setdefault(k[1], []).append(k)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_columns(cols: EdgeColumns,
                     meta: Optional[Dict] = None) -> "FlowGraph":
        """Build nodes/edges from aligned columns: per-node aggregates are
        fancy-indexed whole-column sums (EdgeColumns.group_rows), mirroring
        how merge_columns avoids per-edge boxing."""
        folded_metrics: List[Dict[str, float]] = [
            {} for _ in range(len(cols))]
        for i, name in enumerate(cols.metric_names):
            for j in np.nonzero(cols.metric_mask[i])[0]:
                folded_metrics[j][name] = float(cols.metric_values[i, j])
        edges: Dict[SlotKey, FlowEdge] = {}
        for j, k in enumerate(cols.keys):
            hist = None
            if cols.hist is not None and cols.hist[j].any():
                hist = cols.hist[j]
            rate = None
            if cols.sample_rate is not None and cols.sample_rate[j] < 1.0:
                rate = float(cols.sample_rate[j])
            edges[k] = FlowEdge(
                key=k, kind=int(cols.kind[j]), count=int(cols.count[j]),
                total_ns=int(cols.total_ns[j]),
                child_ns=int(cols.child_ns[j]),
                min_ns=int(cols.min_ns[j]), max_ns=int(cols.max_ns[j]),
                metrics=folded_metrics[j], hist=hist, sample_rate=rate)
        nodes: Dict[str, FlowNode] = {}
        wait = cols.kind == KIND_WAIT
        for name, rows in cols.group_rows("component").items():
            w = rows[wait[rows]]
            nodes[name] = FlowNode(
                name=name,
                in_count=int(cols.count[rows].sum()),
                in_total_ns=int(cols.total_ns[rows].sum()),
                in_child_ns=int(cols.child_ns[rows].sum()),
                wait_count=int(cols.count[w].sum()),
                wait_ns=int(cols.total_ns[w].sum()))
        for name, rows in cols.group_rows("caller").items():
            n = nodes.setdefault(name, FlowNode(name=name))
            n.out_count = int(cols.count[rows].sum())
            n.out_total_ns = int(cols.total_ns[rows].sum())
        return FlowGraph(edges, nodes, group=cols.group, meta=meta)

    @staticmethod
    def from_folded(table: FoldedTable,
                    meta: Optional[Dict] = None) -> "FlowGraph":
        return FlowGraph.from_columns(table.to_columns(), meta=meta)

    @staticmethod
    def from_snapshot(snap) -> "FlowGraph":
        return FlowGraph.from_columns(snap.columns, meta=snap.meta)

    # -- queries ------------------------------------------------------------
    def components(self) -> List[str]:
        return sorted(self.nodes)

    def in_edges(self, component: str,
                 kind: Optional[int] = None) -> List[FlowEdge]:
        out = [self.edges[k] for k in self._in.get(component, ())]
        return out if kind is None else [e for e in out if e.kind == kind]

    def out_edges(self, component: str,
                  kind: Optional[int] = None) -> List[FlowEdge]:
        out = [self.edges[k] for k in self._out.get(component, ())]
        return out if kind is None else [e for e in out if e.kind == kind]

    def successors(self, component: str) -> List[str]:
        return sorted({k[1] for k in self._out.get(component, ())})

    def total_ns(self) -> int:
        return sum(e.total_ns for e in self.edges.values())

    def total_count(self) -> int:
        return sum(e.count for e in self.edges.values())

    def __len__(self) -> int:
        return len(self.edges)

    def to_json(self) -> dict:
        return {
            "group": self.group,
            "nodes": [self.nodes[c].to_json() for c in self.components()],
            "edges": [self.edges[k].to_json() for k in sorted(self.edges)],
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FlowGraph(nodes={len(self.nodes)}, edges={len(self.edges)},"
                f" group={self.group!r})")


def shard_graphs(run_dir: str) -> Dict[str, FlowGraph]:
    """Per-shard projection of one run: stem -> FlowGraph built from the
    NEWEST ring entry of each shard (the shard's cumulative truth).  One
    trainer rank / serving replica each becomes a comparable subgraph —
    the input to straggler/imbalance detection.  Stems come from the
    store (host-qualified `host/shard` in a collector spool run dir), so
    two hosts' same-named rank-0 rings stay two subgraphs instead of
    silently aliasing.  Merge products that were written into the run
    dir are excluded, mirroring the reducer."""
    from ..profile.snapshot import ProfileSnapshot
    from ..profile.store import ProfileStore
    out: Dict[str, FlowGraph] = {}
    for stem, ring in sorted(ProfileStore(run_dir).shards().items()):
        snap = ProfileSnapshot.load(ring[-1][1])
        if "merged_from" in snap.meta:
            continue
        out[stem] = FlowGraph.from_snapshot(snap)
    return out


def run_graph(run_dir: str) -> FlowGraph:
    """The merged graph of a run dir (newest-per-shard reduce)."""
    from ..profile.store import ProfileStore
    snap = ProfileStore(run_dir).reduce()
    g = FlowGraph.from_snapshot(snap)
    g.meta.setdefault("run_dir", os.path.abspath(run_dir))
    return g
