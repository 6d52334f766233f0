"""Built-in cross-flow detectors — automated findings over the FlowGraph.

Scaler's claim is that XFA *detects* performance issues, not just renders
flow matrices; each detector here encodes one pathology as a deterministic
rule over the diagnosis context (merged graph, per-shard graphs, snapshot
rings, optional baseline run and calibrated noise bands) and emits
structured `Finding`s with a severity and the evidence that fired it.

Detectors are small and independent (the ScALPEL argument: adaptive,
lightweight probes, not one monolithic analysis); adding one means
implementing the two-member `Detector` protocol and appending to
`builtin_detectors()`.

Built-ins:

  wait-dominance       a component's inbound Wait share exceeds bound
                       (Scaler §3.5 Wait category)
  hot-edge             one edge owns almost all of a component's self time
  rank-imbalance       straggler rank/replica across a run's shards
  queue-saturation     serve queue_wait per-interval mean grows along the
                       ring (admission can't keep up with arrivals)
  cache-pressure       the paged KV-cache pool is the bottleneck: the
                       cache_pages_in_use gauge approaches capacity while
                       queue depth grows — PAGES, not slots, are the
                       saturation resource (add pages or shrink max_new,
                       not max_batch)
  drift-regression     per-interval delta-of-deltas vs a baseline run
                       trends up (cost grows run-over-run AND over time)
  call-amplification   count blowup along a caller -> B -> callee chain
  slo-violation        deadline-miss rate against the per-request deadlines
                       the serving engine folds (deadline_met/deadline_miss
                       count edges), with e2e latency percentiles from the
                       schema-v2 histograms as evidence
  sampling-backoff     informational: which edges the adaptive overhead
                       governor (core.sampler) subsampled, at what
                       effective rate — time columns on those edges are
                       unbiased scale-ups, counts stay exact
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Sequence

import numpy as np

from ..core.histogram import jitter_ns as _hist_jitter, percentile_ns
from ..core.shadow import KIND_CALL, KIND_WAIT
from .calibrate import Thresholds
from .graph import FlowGraph, edge_label

SEVERITIES = ("info", "warn", "crit")


def severity_rank(sev: str) -> int:
    return SEVERITIES.index(sev)


@dataclass(frozen=True)
class Finding:
    """One structured diagnosis result."""

    detector: str
    severity: str          # info | warn | crit
    subject: str           # "component:runtime" / "edge:app -> x.y" / ...
    message: str
    evidence: Dict[str, Any] = field(default_factory=dict)

    def sort_key(self):
        return (-severity_rank(self.severity), self.detector, self.subject)

    def to_json(self) -> dict:
        return {"detector": self.detector, "severity": self.severity,
                "subject": self.subject, "message": self.message,
                "evidence": self.evidence}


@dataclass
class DiagnosisContext:
    """Everything the profile store holds for one run, in analyzable form."""

    graph: FlowGraph
    shard_graphs: Dict[str, FlowGraph] = field(default_factory=dict)
    timelines: List = field(default_factory=list)       # [ShardTimeline]
    baseline_graph: Optional[FlowGraph] = None
    baseline_timelines: List = field(default_factory=list)
    thresholds: Optional[Thresholds] = None
    run_dir: str = ""

    def noise_ns(self, key, fld: str = "total_ns") -> float:
        return self.thresholds.noise_ns(key, fld) if self.thresholds else 0.0


class Detector(Protocol):
    name: str

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        ...  # pragma: no cover - protocol


def _pct(x: float) -> str:
    return f"{100.0 * x:.0f}%"


def _ms(ns: float) -> str:
    return f"{ns / 1e6:.2f}ms"


@dataclass
class WaitDominance:
    """Component whose inbound time is mostly Wait (not useful work)."""

    name: str = "wait-dominance"
    warn_share: float = 0.4
    crit_share: float = 0.7
    min_total_ns: int = 1_000_000

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        out = []
        for comp in ctx.graph.components():
            node = ctx.graph.nodes[comp]
            if node.in_total_ns < self.min_total_ns:
                continue
            share = node.wait_share
            if share < self.warn_share:
                continue
            waits = sorted(ctx.graph.in_edges(comp, kind=KIND_WAIT),
                           key=lambda e: -e.total_ns)
            top = waits[0]
            out.append(Finding(
                self.name,
                "crit" if share >= self.crit_share else "warn",
                f"component:{comp}",
                f"{_pct(share)} of component '{comp}' time "
                f"({_ms(node.in_total_ns)}) is Wait; top wait edge "
                f"{edge_label(top.key)} ({_ms(top.total_ns)})",
                evidence={"wait_share": share,
                          "wait_ns": node.wait_ns,
                          "in_total_ns": node.in_total_ns,
                          "top_wait_edge": list(top.key),
                          "top_wait_ns": top.total_ns}))
        return out


@dataclass
class HotEdgeConcentration:
    """One edge owns (almost) all of a component's self time."""

    name: str = "hot-edge"
    warn_share: float = 0.8
    crit_share: float = 0.95
    min_edges: int = 2
    min_self_ns: int = 1_000_000

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        out = []
        for comp in ctx.graph.components():
            calls = ctx.graph.in_edges(comp, kind=KIND_CALL)
            if len(calls) < self.min_edges:
                continue
            total_self = sum(max(e.self_ns, 0) for e in calls)
            if total_self < self.min_self_ns:
                continue
            top = max(calls, key=lambda e: e.self_ns)
            share = max(top.self_ns, 0) / total_self
            if share < self.warn_share:
                continue
            out.append(Finding(
                self.name,
                "crit" if share >= self.crit_share else "warn",
                f"edge:{edge_label(top.key)}",
                f"edge {edge_label(top.key)} holds {_pct(share)} of "
                f"component '{comp}' self time ({_ms(top.self_ns)} of "
                f"{_ms(total_self)}) across {len(calls)} edges",
                evidence={"share": share, "self_ns": top.self_ns,
                          "component_self_ns": total_self,
                          "count": top.count, "n_edges": len(calls)}))
        return out


@dataclass
class RankImbalance:
    """Straggler detection across a run's shards (ranks / replicas)."""

    name: str = "rank-imbalance"
    warn_rel: float = 0.25
    crit_rel: float = 0.5
    min_shards: int = 2
    min_total_ns: int = 1_000_000

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        shards = ctx.shard_graphs
        if len(shards) < self.min_shards:
            return []
        totals = {stem: g.total_ns() for stem, g in sorted(shards.items())}
        mean = sum(totals.values()) / len(totals)
        if mean < self.min_total_ns:
            return []
        straggler = max(sorted(totals), key=lambda s: totals[s])
        rel = (totals[straggler] - mean) / mean if mean else 0.0
        if rel < self.warn_rel:
            return []
        # the component with the widest per-shard spread localizes WHERE
        # the straggler loses its time
        comps = sorted({c for g in shards.values() for c in g.components()})
        spread = {}
        for c in comps:
            per = [shards[s].nodes[c].in_total_ns if c in shards[s].nodes
                   else 0 for s in sorted(shards)]
            spread[c] = max(per) - min(per)
        culprit = max(comps, key=lambda c: (spread[c], c)) if comps else ""
        return [Finding(
            self.name,
            "crit" if rel >= self.crit_rel else "warn",
            f"shard:{straggler}",
            f"shard '{straggler}' folded {_ms(totals[straggler])}, "
            f"{_pct(rel)} above the {len(totals)}-shard mean "
            f"({_ms(mean)}); widest spread in component '{culprit}'",
            evidence={"rel_above_mean": rel, "shard_total_ns": totals,
                      "mean_ns": mean, "widest_component": culprit})]


@dataclass
class QueueSaturation:
    """Serving queue wait growing along a ring's sequence numbers."""

    name: str = "queue-saturation"
    api: str = "queue_wait"
    warn_ratio: float = 2.0
    crit_ratio: float = 4.0
    min_intervals: int = 3
    tolerance: float = 0.1     # per-interval dips smaller than this are ok
    min_mean_ns: float = 1_000.0

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        out = []
        for tl in ctx.timelines:
            # a trimmed ring's first "delta" is a cumulative fold, not an
            # interval (cf. calibrate_ring) — it would dilute the ratio
            start = 0 if (tl.seqs and tl.seqs[0] == 1) else 1
            for key in tl.edges():
                if key[2] != self.api:
                    continue
                means = [m for m in tl.deltas(key, "mean_ns")[start:]
                         if m > 0]
                if len(means) < self.min_intervals:
                    continue
                if means[0] < self.min_mean_ns:
                    continue
                rising = all(b >= a * (1.0 - self.tolerance)
                             for a, b in zip(means, means[1:]))
                ratio = means[-1] / means[0]
                if not rising or ratio < self.warn_ratio:
                    continue
                # queue_depth gauge as corroborating evidence; its caller
                # differs from queue_wait's (engine loop vs admit bracket)
                # so match on (component, api) only
                depth = None
                for dkey in tl.edges():
                    if dkey[1] == key[1] and dkey[2] == "queue_depth":
                        depth = tl.deltas(dkey, "mean_ns")
                        break
                out.append(Finding(
                    self.name,
                    "crit" if ratio >= self.crit_ratio else "warn",
                    f"edge:{edge_label(key)}",
                    f"per-interval mean of {edge_label(key)} grew "
                    f"{ratio:.1f}x across {len(means)} intervals of ring "
                    f"'{tl.stem}' ({_ms(means[0])} -> {_ms(means[-1])}): "
                    f"admission is falling behind arrivals",
                    evidence={"ratio": ratio, "means_ns": means,
                              "shard": tl.stem,
                              "queue_depth_means": depth}))
        return out


@dataclass
class CachePressure:
    """Paged serving cache near exhaustion while the queue backs up.

    Reads the engine's paged-pool gauges (per-interval means along the
    snapshot ring): `cache_pages_in_use` against `cache_pages_capacity`
    — the usable arena the allocator reports — corroborated by a growing
    `queue_depth`.  Fires only when BOTH hold: high page utilization
    with a draining queue is a healthy full pipe, and a growing queue
    with free pages is some other bottleneck (see queue-saturation).
    The point of the finding is the RESOURCE: admission stalls on pages,
    so the fix is more pages / smaller max_new_tokens, not more slots."""

    name: str = "cache-pressure"
    in_use_api: str = "cache_pages_in_use"
    capacity_api: str = "cache_pages_capacity"
    depth_api: str = "queue_depth"
    warn_util: float = 0.80
    crit_util: float = 0.95
    min_intervals: int = 3
    tolerance: float = 0.1     # queue dips smaller than this still "grow"

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        out = []
        for tl in ctx.timelines:
            # a trimmed ring's first "delta" is a cumulative fold, not an
            # interval (cf. calibrate_ring)
            start = 0 if (tl.seqs and tl.seqs[0] == 1) else 1
            for key in tl.edges():
                if key[2] != self.in_use_api:
                    continue
                used = [m for m in tl.deltas(key, "mean_ns")[start:]
                        if m >= 0]
                if len(used) < self.min_intervals:
                    continue
                # capacity/queue gauges fold from the engine loop like
                # in_use but under their own api; match on component
                capacity = depth = None
                for okey in tl.edges():
                    if okey[1] != key[1]:
                        continue
                    if okey[2] == self.capacity_api:
                        caps = [m for m in tl.deltas(okey, "mean_ns")[start:]
                                if m > 0]
                        capacity = caps[-1] if caps else None
                    elif okey[2] == self.depth_api:
                        depth = tl.deltas(okey, "mean_ns")[start:]
                if not capacity:
                    continue
                util = used[-1] / capacity
                if util < self.warn_util:
                    continue
                growing = (depth is not None
                           and len(depth) >= self.min_intervals
                           and all(b >= a * (1.0 - self.tolerance)
                                   for a, b in zip(depth, depth[1:]))
                           and depth[-1] > depth[0])
                if not growing:
                    continue
                out.append(Finding(
                    self.name,
                    "crit" if util >= self.crit_util else "warn",
                    f"edge:{edge_label(key)}",
                    f"KV-cache pages are the saturation resource on ring "
                    f"'{tl.stem}': {_pct(util)} of {capacity:.0f} usable "
                    f"pages in use while queue depth grew "
                    f"{depth[0]:.1f} -> {depth[-1]:.1f} — admission is "
                    f"gated by free pages, not slots (grow "
                    f"max_cache_pages or cut max_new_tokens; adding "
                    f"max_batch slots will not help)",
                    evidence={"util": util, "capacity_pages": capacity,
                              "in_use_means": used,
                              "queue_depth_means": list(depth),
                              "shard": tl.stem}))
        return out


@dataclass
class DriftRegression:
    """Cross-run drift: per-interval cost grows vs baseline, and keeps
    growing over the run (delta-of-deltas trending up)."""

    name: str = "drift-regression"
    warn_growth: float = 0.25
    crit_growth: float = 1.0
    min_intervals: int = 3
    min_total_ns: float = 1_000_000.0

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        if not ctx.baseline_timelines or not ctx.timelines:
            return []
        from ..profile.timeline import pair_timelines
        out = []
        for td in pair_timelines(ctx.baseline_timelines, ctx.timelines):
            if len(td) < self.min_intervals:
                continue
            for key in td.edges():
                da = td.deltas(td.a, key, "total_ns")     # baseline
                db = td.deltas(td.b, key, "total_ns")     # candidate
                dd = [y - x for x, y in zip(da, db)]
                base_total = sum(da)
                if max(base_total, sum(db)) < self.min_total_ns:
                    continue
                noise = ctx.noise_ns(key, "total_ns")
                if any(v < -noise for v in dd):
                    continue                      # not a consistent growth
                if dd[-1] <= dd[0] + noise:
                    continue                      # flat offset, not a trend
                growth = (sum(dd) / base_total) if base_total > 0 \
                    else float("inf")
                if growth < self.warn_growth:
                    continue
                out.append(Finding(
                    self.name,
                    "crit" if growth >= self.crit_growth else "warn",
                    f"edge:{edge_label(key)}",
                    f"{edge_label(key)} per-interval cost is "
                    f"{_pct(growth)} above baseline across {len(dd)} "
                    f"aligned intervals and TRENDING UP "
                    f"({_ms(dd[0])} -> {_ms(dd[-1])} extra per interval)",
                    evidence={"growth": growth if growth != float("inf")
                              else None,
                              "delta_of_deltas_ns": dd,
                              "baseline_deltas_ns": da,
                              "candidate_deltas_ns": db,
                              "noise_floor_ns": noise,
                              "shards": [td.a.stem, td.b.stem]}))
        return out


@dataclass
class CallAmplification:
    """Count ratio blowup along a caller -> B -> callee chain: each call
    into B fans out into `ratio` calls out of B (N+1-query-style)."""

    name: str = "call-amplification"
    warn_ratio: float = 100.0
    crit_ratio: float = 1000.0
    min_count: int = 1000

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        out = []
        for mid in ctx.graph.components():
            ins = [e for e in ctx.graph.in_edges(mid, kind=KIND_CALL)
                   if e.count > 0]
            if not ins:
                continue
            in_total = sum(e.count for e in ins)
            # the ratio denominator is ALL calls into B — pairing each
            # outbound edge with its single smallest inbound edge would
            # manufacture blowups out of rare side entrances
            top_in = max(ins, key=lambda e: (e.count, e.key))
            worst = None
            for e2 in ctx.graph.out_edges(mid, kind=KIND_CALL):
                if e2.count < self.min_count or e2.key == top_in.key:
                    continue
                ratio = e2.count / in_total
                if ratio >= self.warn_ratio and \
                        (worst is None or ratio > worst[0]):
                    worst = (ratio, e2)
            if worst is None:
                continue
            ratio, e2 = worst
            out.append(Finding(
                self.name,
                "crit" if ratio >= self.crit_ratio else "warn",
                f"chain:{edge_label(top_in.key)} => {e2.component}.{e2.api}",
                f"{in_total} calls into '{mid}' (top: "
                f"{edge_label(top_in.key)}) amplify into {ratio:.0f}x "
                f"calls {edge_label(e2.key)} ({e2.count} total)",
                evidence={"ratio": ratio, "in_count": in_total,
                          "out_count": e2.count,
                          "top_in_edge": list(top_in.key),
                          "out_edge": list(e2.key)}))
        return out


@dataclass
class SloViolation:
    """Deadline-miss rate against per-request deadlines.

    The serving engine (serving/engine.py) folds one `deadline_met` or
    `deadline_miss` count event per finished request that carried a
    deadline (Request.deadline_ms / ServeConfig.deadline_ms); this
    detector reads those counts off the merged graph and converts the
    miss RATE into severity — an SLO is a rate contract, not a one-off.
    The component's e2e latency histogram (schema v2) supplies the
    percentile spread as evidence, so a firing finding shows WHERE the
    tail sits, not just that it crossed."""

    name: str = "slo-violation"
    component: str = "serve"
    miss_api: str = "deadline_miss"
    met_api: str = "deadline_met"
    latency_api: str = "e2e"
    warn_rate: float = 0.01
    crit_rate: float = 0.05
    min_tracked: int = 10

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        ins = ctx.graph.in_edges(self.component)
        missed = sum(e.count for e in ins if e.api == self.miss_api)
        met = sum(e.count for e in ins if e.api == self.met_api)
        tracked = missed + met
        if tracked < self.min_tracked:
            return []
        rate = missed / tracked
        if rate < self.warn_rate:
            return []
        evidence: Dict[str, Any] = {"miss_rate": rate, "missed": missed,
                                    "tracked": tracked}
        spread = ""
        lat = [e.hist for e in ins
               if e.api == self.latency_api and e.hist is not None]
        if lat:
            h = np.sum(lat, axis=0, dtype=np.uint64) if len(lat) > 1 \
                else lat[0]
            p50, p95, p99 = (percentile_ns(h, q)
                             for q in (0.50, 0.95, 0.99))
            evidence.update({"e2e_p50_ns": p50, "e2e_p95_ns": p95,
                             "e2e_p99_ns": p99,
                             "e2e_jitter_ns": _hist_jitter(h)})
            spread = (f"; e2e p50/p95/p99 = {_ms(p50)}/{_ms(p95)}/"
                      f"{_ms(p99)} (jitter {_ms(p99 - p50)})")
        return [Finding(
            self.name,
            "crit" if rate >= self.crit_rate else "warn",
            f"component:{self.component}",
            f"{missed} of {tracked} deadline-tracked requests "
            f"({_pct(rate)}) missed their deadline in component "
            f"'{self.component}'{spread}",
            evidence=evidence)]


@dataclass
class SamplingBackoff:
    """Informational read-out of the overhead governor's sampling state.

    Never warns on its own — back-off is the governor doing its job —
    but every diagnosis that reasons about time columns should see when
    those columns are scaled estimates rather than full traces.  Fires
    one info finding per subsampled edge (rate below `max_rate`), with
    the effective rate and the exact count as evidence."""

    name: str = "sampling-backoff"
    max_rate: float = 1.0
    min_count: int = 1

    def detect(self, ctx: DiagnosisContext) -> List[Finding]:
        out = []
        for key in sorted(ctx.graph.edges):
            e = ctx.graph.edges[key]
            if e.sample_rate is None or e.sample_rate >= self.max_rate \
                    or e.count < self.min_count:
                continue
            k = round(1.0 / e.sample_rate) if e.sample_rate > 0 else 0
            out.append(Finding(
                self.name, "info", f"edge:{edge_label(key)}",
                f"overhead governor subsampled {edge_label(key)} at "
                f"effective rate {e.sample_rate:.4f} (~1-in-{k}); its "
                f"{e.count} calls counted exactly, time columns are "
                f"unbiased scale-ups",
                evidence={"sample_rate": e.sample_rate, "count": e.count,
                          "total_ns": e.total_ns}))
        return out


def detector_classes() -> Dict[str, type]:
    """Shipped detector classes keyed by their canonical name."""
    classes = (WaitDominance, HotEdgeConcentration, RankImbalance,
               QueueSaturation, CachePressure, DriftRegression,
               CallAmplification, SloViolation, SamplingBackoff)
    return {cls().name: cls for cls in classes}


def builtin_detectors(**overrides) -> List[Detector]:
    """The shipped detector set.  `overrides` maps a detector name (with
    '-' or '_') to a dict of constructor kwargs, so CLI/config can retune
    any rule without redefining it.  Unknown detector names or constructor
    parameters raise ValueError — the CLI contract surfaces them as usage
    errors (exit 2), never as a silently-ignored misspelled threshold."""
    classes = detector_classes()
    norm = {k.replace("_", "-"): v for k, v in overrides.items()}
    unknown = sorted(set(norm) - set(classes))
    if unknown:
        raise ValueError(
            f"unknown detector(s): {', '.join(unknown)}; "
            f"valid: {', '.join(sorted(classes))}")
    out = []
    for name, cls in classes.items():
        kwargs = dict(norm.get(name, {}))
        params = {f.name for f in dataclasses.fields(cls)} - {"name"}
        bad = sorted(set(kwargs) - params)
        if bad:
            raise ValueError(
                f"detector {name!r}: unknown parameter(s) "
                f"{', '.join(bad)}; valid: {', '.join(sorted(params))}")
        out.append(cls(**kwargs))
    return out


def run_detectors(ctx: DiagnosisContext,
                  detectors: Optional[Sequence[Detector]] = None
                  ) -> List[Finding]:
    """Run detectors and return findings in deterministic order (severity
    desc, then detector name, then subject)."""
    findings: List[Finding] = []
    for det in (builtin_detectors() if detectors is None else detectors):
        found = det.detect(ctx)
        for f in found:
            if f.severity not in SEVERITIES:
                raise ValueError(f"{det.name}: bad severity {f.severity!r}")
        findings.extend(found)
    findings.sort(key=Finding.sort_key)
    return findings
