"""Fleet-level diagnosis — ranking findings across runs and hosts.

A collector spool (profile/collector.py) turns one registry root into a
fleet view: every run dir may now hold shards from SEVERAL hosts, with
host-qualified stems (`host/shard`) keeping two hosts' same-named rank-0
rings apart.  This module is the analysis layer over that: it diagnoses
every selected run with the existing detector set, adds cross-host
detectors that the single-run context cannot express, and ranks the
union so `diagnose --fleet` answers "which host, in which run, is
hurting the fleet" in one report.

Cross-host detection mirrors RankImbalance but one level up: per-HOST
merged graphs (all of one host's shards reduced) are the comparable
subgraphs, so a straggler *host* shows up even when its individual
ranks are internally balanced.  Cross-run ranking reuses each run's
Diagnosis verbatim — findings are tagged with (run_id, host) and sorted
by the same (severity, detector, subject) key, then grouped by
(severity, detector, host) for the JSON report.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .detectors import SEVERITIES, Finding, severity_rank
from .diagnose import Diagnosis, _is_run_dir, diagnose
from .graph import FlowGraph


def stem_host(stem: str, meta: Optional[Dict[str, Any]] = None) -> str:
    """The host a shard stem belongs to.

    Spooled stems are host-qualified (`host/shard` — collector layout);
    flat local stems fall back to the snapshot's recorded `host` meta
    (store.write_shard records it), then to the hostname embedded in the
    `label-host-pid` stem convention, then to '-'."""
    if "/" in stem:
        return stem.split("/", 1)[0]
    if meta and meta.get("host"):
        return str(meta["host"])
    parts = stem.rsplit("-", 2)
    if len(parts) == 3 and parts[2].isdigit():
        return parts[1]
    return "-"


def host_graphs(run_dir: str) -> Dict[str, FlowGraph]:
    """Per-host merged graphs of one run: host -> FlowGraph reducing the
    newest ring entry of every shard that host wrote.  These are the
    comparable units for cross-host straggler detection — a whole host
    that runs hot is visible here even when its own ranks agree with
    each other."""
    from ..profile.snapshot import ProfileSnapshot
    from ..profile.store import ProfileStore
    by_host: Dict[str, List[ProfileSnapshot]] = {}
    for stem, ring in sorted(ProfileStore(run_dir).shards().items()):
        snap = ProfileSnapshot.load(ring[-1][1])
        if "merged_from" in snap.meta:
            continue
        by_host.setdefault(stem_host(stem, snap.meta), []).append(snap)
    out: Dict[str, FlowGraph] = {}
    for host, snaps in sorted(by_host.items()):
        merged = snaps[0] if len(snaps) == 1 \
            else ProfileSnapshot.merge(snaps, meta={"host": host})
        out[host] = FlowGraph.from_snapshot(merged)
    return out


def fleet_straggler_findings(hosts: Dict[str, FlowGraph], *,
                             warn_rel: float = 0.25,
                             crit_rel: float = 0.5,
                             min_hosts: int = 2,
                             min_total_ns: int = 1_000_000) -> List[Finding]:
    """Cross-host rank-imbalance: the host whose merged graph folded the
    most time, measured against the fleet mean, localized to the
    component with the widest per-host spread (same math as the
    rank-imbalance detector, with hosts as the comparable shards)."""
    if len(hosts) < min_hosts:
        return []
    totals = {h: g.total_ns() for h, g in sorted(hosts.items())}
    mean = sum(totals.values()) / len(totals)
    if mean < min_total_ns:
        return []
    straggler = max(sorted(totals), key=lambda h: totals[h])
    rel = (totals[straggler] - mean) / mean if mean else 0.0
    if rel < warn_rel:
        return []
    comps = sorted({c for g in hosts.values() for c in g.components()})
    spread = {}
    for c in comps:
        per = [hosts[h].nodes[c].in_total_ns if c in hosts[h].nodes else 0
               for h in sorted(hosts)]
        spread[c] = max(per) - min(per)
    culprit = max(comps, key=lambda c: (spread[c], c)) if comps else ""
    return [Finding(
        "fleet-straggler",
        "crit" if rel >= crit_rel else "warn",
        f"host:{straggler}",
        f"host '{straggler}' folded {totals[straggler] / 1e6:.2f}ms, "
        f"{100.0 * rel:.0f}% above the {len(totals)}-host mean "
        f"({mean / 1e6:.2f}ms); widest spread in component '{culprit}'",
        evidence={"rel_above_mean": rel, "host_total_ns": totals,
                  "mean_ns": mean, "widest_component": culprit})]


def fleet_run_outlier_findings(run_totals: Dict[str, int], *,
                               warn_rel: float = 0.5,
                               crit_rel: float = 1.0,
                               min_runs: int = 3,
                               min_total_ns: int = 1_000_000
                               ) -> List[Finding]:
    """Cross-RUN outlier: with three or more comparable runs of one
    config, a run whose merged total sits far above the mean of the
    others is flagged — the fleet-level 'this launch is not like the
    rest' signal that no single-run detector can produce."""
    if len(run_totals) < min_runs:
        return []
    mean = sum(run_totals.values()) / len(run_totals)
    if mean < min_total_ns:
        return []
    out = []
    for run_id in sorted(run_totals):
        rel = (run_totals[run_id] - mean) / mean if mean else 0.0
        if rel < warn_rel:
            continue
        out.append(Finding(
            "fleet-run-outlier",
            "crit" if rel >= crit_rel else "warn",
            f"run:{run_id}",
            f"run '{run_id}' folded {run_totals[run_id] / 1e6:.2f}ms, "
            f"{100.0 * rel:.0f}% above the {len(run_totals)}-run mean "
            f"({mean / 1e6:.2f}ms)",
            evidence={"rel_above_mean": rel, "run_total_ns": run_totals,
                      "mean_ns": mean}))
    return out


def finding_host(f: Finding) -> str:
    """Best-effort host attribution of a finding for report grouping:
    `host:` subjects name it directly, `shard:` subjects carry it when
    the stem is host-qualified; everything else groups under '-'."""
    if f.subject.startswith("host:"):
        return f.subject.split(":", 1)[1]
    if f.subject.startswith("shard:"):
        stem = f.subject.split(":", 1)[1]
        if "/" in stem:
            return stem.split("/", 1)[0]
    return "-"


@dataclass
class FleetDiagnosis:
    """Findings from every selected run, ranked and grouped fleet-wide."""

    root: str
    runs: List[Diagnosis] = field(default_factory=list)
    fleet_findings: List[Tuple[str, Finding]] = field(default_factory=list)
    hosts_by_run: Dict[str, List[str]] = field(default_factory=dict)
    config: Optional[str] = None
    run_pattern: Optional[str] = None

    def ranked(self) -> List[Tuple[str, Finding]]:
        """(run_id, finding) pairs, fleet findings and per-run findings
        together, by the shared (severity, detector, subject) key."""
        rows = list(self.fleet_findings)
        for d in self.runs:
            run_id = os.path.basename(os.path.normpath(d.run_dir))
            rows.extend((run_id, f) for f in d.findings)
        rows.sort(key=lambda rf: rf[1].sort_key() + (rf[0],))
        return rows

    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for _run, f in self.ranked():
            c[f.severity] += 1
        return c

    def worst(self) -> Optional[str]:
        return max((f.severity for _r, f in self.ranked()),
                   key=severity_rank, default=None)

    def should_fail(self, fail_on: Optional[str]) -> bool:
        if not fail_on or fail_on == "none":
            return False
        bar = severity_rank(fail_on)
        return any(severity_rank(f.severity) >= bar
                   for _r, f in self.ranked())

    def groups(self) -> List[Dict[str, Any]]:
        """Findings grouped by (severity, detector, host), most severe
        group first — the JSON report's spine."""
        grouped: Dict[Tuple[str, str, str], List[Dict[str, Any]]] = {}
        for run_id, f in self.ranked():
            key = (f.severity, f.detector, finding_host(f))
            grouped.setdefault(key, []).append(
                dict(f.to_json(), run=run_id))
        out = []
        for (sev, det, host) in sorted(
                grouped, key=lambda k: (-severity_rank(k[0]), k[1], k[2])):
            out.append({"severity": sev, "detector": det, "host": host,
                        "findings": grouped[(sev, det, host)]})
        return out

    def to_json(self) -> dict:
        return {
            "root": self.root,
            "config": self.config,
            "run_pattern": self.run_pattern,
            "runs": [{"run_dir": d.run_dir,
                      "hosts": self.hosts_by_run.get(
                          os.path.basename(os.path.normpath(d.run_dir)), []),
                      "counts": d.counts(),
                      "graph": dict(d.graph_stats)} for d in self.runs],
            "counts": self.counts(),
            "groups": self.groups(),
        }

    def render(self, top: int = 50) -> str:
        c = self.counts()
        n_hosts = len({h for hs in self.hosts_by_run.values() for h in hs})
        lines = [
            f"fleet diagnosis: {self.root}"
            + (f" (config={self.config})" if self.config else "")
            + (f" (run={self.run_pattern})" if self.run_pattern else ""),
            f"  {len(self.runs)} run(s), {n_hosts} host(s); findings: "
            f"{c['crit']} crit, {c['warn']} warn, {c['info']} info",
        ]
        rows = self.ranked()
        for run_id, f in rows[:top]:
            lines.append(f"  [{f.severity.upper():4s}] {run_id} "
                         f"{f.detector}: {f.message}")
        if len(rows) > top:
            lines.append(f"  ... ({len(rows) - top} more)")
        if not rows:
            lines.append("  no findings — every run looks healthy to every "
                         "detector")
        return "\n".join(lines)


def diagnose_fleet(root: str, *, config: Optional[str] = None,
                   run: Optional[str] = None,
                   thresholds_path: Optional[str] = None,
                   overrides: Optional[Dict[str, Dict]] = None,
                   detector_config: Optional[str] = None) -> FleetDiagnosis:
    """Diagnose every registered run under `root` (filtered by `config`
    and/or a `run` id/label glob), add cross-host and cross-run fleet
    findings, and rank the union.

    Unlike single-run `diagnose`, selection is a QUERY, not a find —
    matching several runs is the point.  A root that is itself a run dir
    degrades to a one-run fleet (cross-host detection still applies if
    its shards are host-qualified)."""
    import fnmatch
    run_dirs: List[str]
    if _is_run_dir(root):
        run_dirs = [root]
    else:
        from ..profile.index import RunRegistry
        manifests = RunRegistry(root).query(config=config)
        if run:
            manifests = [m for m in manifests
                         if fnmatch.fnmatchcase(m.run_id, run)
                         or fnmatch.fnmatchcase(m.label, run)
                         or fnmatch.fnmatchcase(m.config, run)]
        run_dirs = [m.run_dir for m in manifests
                    if _is_run_dir(m.run_dir)]
        if not run_dirs:
            what = [f"config={config!r}" if config else "",
                    f"run={run!r}" if run else ""]
            sel = " ".join(w for w in what if w) or "any run"
            raise LookupError(
                f"no registered run with snapshots under {root!r} "
                f"matches {sel}")
    fleet = FleetDiagnosis(root=os.path.abspath(root), config=config,
                           run_pattern=run)
    run_totals: Dict[str, int] = {}
    for run_dir in run_dirs:
        d = diagnose(run_dir, thresholds_path=thresholds_path,
                     overrides=overrides, detector_config=detector_config)
        fleet.runs.append(d)
        run_id = os.path.basename(os.path.normpath(run_dir))
        hosts = host_graphs(run_dir)
        fleet.hosts_by_run[run_id] = sorted(hosts)
        fleet.fleet_findings.extend(
            (run_id, f) for f in fleet_straggler_findings(hosts))
        run_totals[run_id] = sum(g.total_ns() for g in hosts.values())
    fleet.fleet_findings.extend(
        ("*", f) for f in fleet_run_outlier_findings(run_totals))
    return fleet
