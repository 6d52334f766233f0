"""Component view / API view / flow matrix — the paper's two reports.

Paper mapping (Scaler §2.2, §3.5, Figure 1):

 * component view: for one component, the share of its time spent on itself
   ('Self'), on every other component it calls into, and on 'Wait'.
 * API view: inside one component, the time distribution over its APIs.
 * (ours, implied by XFA) flow matrix: component × component totals — the
   cross-flow picture at a glance; on TPU it additionally exists for
   collective wire bytes (hlo_flows.CollectiveSummary).

All views are computed from FoldedTables — the online fold already did the
heavy lifting, which is why the paper's offline visualizer runs in 0.43 s vs
perf's 33 s (§4.3.2); benchmarks/offline.py reproduces that comparison.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .folding import EdgeStats, FoldedTable
from .shadow import KIND_WAIT, edge_label


@dataclass
class ViewRow:
    label: str
    time_ns: float
    pct: float
    count: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)


@dataclass
class View:
    title: str
    rows: List[ViewRow]
    total_ns: float

    def render(self, max_rows: int = 30) -> str:
        lines = [self.title, f"{'-'*len(self.title)}"]
        lines.append(f"{'entry':<42}{'time_ms':>12}{'%':>8}{'count':>12}")
        for r in self.rows[:max_rows]:
            lines.append(f"{r.label:<42}{r.time_ns/1e6:>12.3f}"
                         f"{r.pct:>7.1f}%{r.count:>12}")
        if len(self.rows) > max_rows:
            lines.append(f"... ({len(self.rows)-max_rows} more)")
        return "\n".join(lines)

    def top(self) -> Optional[ViewRow]:
        return self.rows[0] if self.rows else None

    def find(self, label: str) -> Optional[ViewRow]:
        for r in self.rows:
            if r.label == label:
                return r
        return None


def component_view(folded: FoldedTable, component: str,
                   total_ns: Optional[float] = None) -> View:
    """Time `component` spends on itself vs on each callee component.

    Self = sum over edges INTO `component` of self_ns (its own body time),
    callee rows = sum over edges FROM `component` of total time into each
    target, Wait separated.  If the component has no inbound edges (it is the
    app, the root), `total_ns` supplies the denominator (wall time).
    """
    spent_on: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    wait_ns = 0.0
    wait_count = 0
    for (caller, callee, api), e in folded.edges.items():
        if caller != component:
            continue
        if e.kind == KIND_WAIT:
            wait_ns += e.total_ns
            wait_count += e.count
        else:
            spent_on[callee] = spent_on.get(callee, 0.0) + e.total_ns
            counts[callee] = counts.get(callee, 0) + e.count

    inbound_total = sum(e.total_ns for (c, t, a), e in folded.edges.items()
                        if t == component)
    inbound_child = sum(e.child_ns for (c, t, a), e in folded.edges.items()
                        if t == component)
    self_ns = max(inbound_total - inbound_child, 0.0)
    outbound = sum(spent_on.values()) + wait_ns
    if total_ns is None:
        total = max(inbound_total, outbound + self_ns)
    else:
        # components can legitimately exceed the observed wall (e.g. compile
        # happened outside the observed steps) — keep pct <= 100
        total = max(total_ns, outbound)
        self_ns = max(total - outbound, 0.0)
    if total == 0:
        total = 1.0

    rows = [ViewRow("Self", self_ns, 100.0 * self_ns / total)]
    if wait_ns:
        rows.append(ViewRow("Wait", wait_ns, 100.0 * wait_ns / total,
                            wait_count))
    for callee, t in spent_on.items():
        rows.append(ViewRow(callee, t, 100.0 * t / total, counts[callee]))
    rows.sort(key=lambda r: -r.time_ns)
    return View(f"Component view: {component}", rows, total)


def api_view(folded: FoldedTable, component: str) -> View:
    """Runtime distribution over APIs inside `component` (all callers merged,
    but available per-caller via api_view_by_caller — relation preserved)."""
    per_api: Dict[str, EdgeStats] = {}
    for (caller, callee, api), e in folded.edges.items():
        if callee != component:
            continue
        cur = per_api.get(api)
        per_api[api] = e if cur is None else cur.merge(e)
    total = sum(e.total_ns for e in per_api.values()) or 1.0
    rows = [ViewRow(api, e.total_ns, 100.0 * e.total_ns / total, e.count,
                    dict(e.metrics))
            for api, e in per_api.items()]
    rows.sort(key=lambda r: -r.time_ns)
    return View(f"API view: {component}", rows, total)


def api_view_by_caller(folded: FoldedTable, component: str) -> View:
    """API view keyed by (caller -> api): the relation-aware drill-down."""
    total = sum(e.total_ns for (c, t, a), e in folded.edges.items()
                if t == component) or 1.0
    rows = [ViewRow(f"{caller} -> {api}", e.total_ns,
                    100.0 * e.total_ns / total, e.count, dict(e.metrics))
            for (caller, callee, api), e in folded.edges.items()
            if callee == component]
    rows.sort(key=lambda r: -r.time_ns)
    return View(f"API view (by caller): {component}", rows, total)


def flow_matrix(folded: FoldedTable) -> Tuple[List[str], List[List[float]]]:
    """Dense component×component matrix of total_ns (caller rows)."""
    comps = folded.components()
    idx = {c: i for i, c in enumerate(comps)}
    mat = [[0.0] * len(comps) for _ in comps]
    for (caller, callee, _api), e in folded.edges.items():
        mat[idx[caller]][idx[callee]] += e.total_ns
    return comps, mat


def render_flow_matrix(folded: FoldedTable, unit: float = 1e6,
                       unit_name: str = "ms") -> str:
    comps, mat = flow_matrix(folded)
    w = max(10, max((len(c) for c in comps), default=10) + 1)
    head = " " * w + "".join(f"{c:>{w}}" for c in comps)
    lines = [f"Flow matrix ({unit_name}, rows=caller)", head]
    for i, c in enumerate(comps):
        lines.append(f"{c:>{w}}" + "".join(
            f"{mat[i][j]/unit:>{w}.2f}" for j in range(len(comps))))
    return "\n".join(lines)


def render_percentiles(folded: FoldedTable, max_rows: int = 30) -> str:
    """Latency-percentile table over the edges that carry histograms
    (schema v2); empty string when none do, so report output is unchanged
    for v1 profiles.  Jitter is the p99 - p50 percentile delta."""
    rows = [(edge_label(k), e) for k, e in folded.edges.items()
            if e.hist is not None]
    if not rows:
        return ""
    rows.sort(key=lambda r: -r[1].p99_ns)
    title = "Latency percentiles (ms, log-bucket histograms)"
    lines = [title, "-" * len(title),
             f"{'edge':<42}{'count':>8}{'p50':>10}{'p95':>10}"
             f"{'p99':>10}{'jitter':>10}"]
    for label, e in rows[:max_rows]:
        n = int(e.hist.sum())
        lines.append(f"{label:<42}{n:>8}{e.p50_ns/1e6:>10.3f}"
                     f"{e.p95_ns/1e6:>10.3f}{e.p99_ns/1e6:>10.3f}"
                     f"{e.jitter_ns/1e6:>10.3f}")
    if len(rows) > max_rows:
        lines.append(f"... ({len(rows)-max_rows} more)")
    return "\n".join(lines)


def render_sampling(folded: FoldedTable, max_rows: int = 30) -> str:
    """Sampling-confidence table over the edges the overhead governor
    subsampled (schema v3); empty string when none were, so report
    output is unchanged for fully-sampled profiles.  Counts are always
    exact; the time columns of listed edges are unbiased 1-in-k
    scale-ups at the shown effective rate."""
    rows = [(edge_label(k), e) for k, e in folded.edges.items()
            if e.sample_rate is not None]
    if not rows:
        return ""
    rows.sort(key=lambda r: r[1].sample_rate)
    title = "Sampling back-off (governor; counts exact, times scaled)"
    lines = [title, "-" * len(title),
             f"{'edge':<42}{'count':>10}{'rate':>10}{'~1-in-k':>10}"]
    for label, e in rows[:max_rows]:
        k = round(1.0 / e.sample_rate) if e.sample_rate > 0 else 0
        lines.append(f"{label:<42}{e.count:>10}{e.sample_rate:>10.4f}"
                     f"{k:>10}")
    if len(rows) > max_rows:
        lines.append(f"... ({len(rows)-max_rows} more)")
    return "\n".join(lines)


def metric_view(folded: FoldedTable, metric: str) -> View:
    """Rank edges by a folded device/static metric (flops, wire_bytes, ...)."""
    rows = []
    total = sum(e.metrics.get(metric, 0.0) for e in folded.edges.values()) or 1.0
    for (caller, callee, api), e in folded.edges.items():
        v = e.metrics.get(metric, 0.0)
        if v:
            rows.append(ViewRow(f"{caller} -> {callee}.{api}", v,
                                100.0 * v / total, e.count, dict(e.metrics)))
    rows.sort(key=lambda r: -r.time_ns)
    return View(f"Metric view: {metric}", rows, total)
