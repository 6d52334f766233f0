"""Diagnosis orchestration: run selection -> context -> findings -> report.

This is the layer behind `python -m repro_torch.profile diagnose` — it
resolves what to analyze (a run dir, or a registry root plus `--run`
pattern), assembles the DiagnosisContext from everything the profile
store knows (merged reduce, per-shard newest snapshots, snapshot rings,
an optional baseline run and calibrated thresholds), runs the detector
set, and renders the findings as deterministic text or JSON with
CI-composable exit semantics (`--fail-on warn|crit`).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .calibrate import Thresholds
from .detectors import (SEVERITIES, Detector, DiagnosisContext, Finding,
                        builtin_detectors, run_detectors, severity_rank)
from .graph import run_graph, shard_graphs


def _is_run_dir(path: str) -> bool:
    from ..profile.store import ProfileStore
    return os.path.isdir(path) and bool(ProfileStore(path).snapshot_paths())


def resolve_run_dir(root: str, run: Optional[str] = None) -> str:
    """Resolve what `diagnose ROOT [--run PATTERN]` points at.

    ROOT that directly holds snapshots is the run dir (PATTERN must then
    be absent).  Otherwise ROOT is a registry root and PATTERN selects by
    run id / label / config glob via RunRegistry.find — ambiguity is an
    error that lists the candidates, never a silent first-match."""
    if _is_run_dir(root):
        if run:
            raise LookupError(
                f"{root!r} is itself a run dir; --run {run!r} does not "
                f"apply (point ROOT at the registry root instead)")
        return root
    from ..profile.index import RunRegistry
    return RunRegistry(root).find(run)


def load_baseline(spec: str, root: str) -> str:
    """A baseline can be a run dir path, or a run id/label/config pattern
    resolved against the same registry root."""
    if _is_run_dir(spec):
        return spec
    if os.path.isdir(root) and not os.path.isdir(spec):
        from ..profile.index import RunRegistry
        return RunRegistry(root).find(spec)
    raise LookupError(f"baseline {spec!r}: not a run dir and no registry "
                      f"match under {root!r}")


def load_detector_config(path: str) -> Dict[str, Dict]:
    """Parse a `--detector-config` JSON file: a top-level object mapping
    detector names ('-' or '_' accepted) to constructor-parameter objects,
    e.g. {"wait-dominance": {"warn_share": 0.5}}.

    This is the file surface for tuning detector thresholds without code:
    the result feeds builtin_detectors(**overrides), which rejects unknown
    detector names and unknown parameters (ValueError -> the CLI exits 2,
    same contract as a corrupt --thresholds file)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict) \
            or not all(isinstance(v, dict) for v in data.values()):
        raise ValueError(
            f"detector config {path!r} must be a JSON object mapping "
            f"detector names to parameter objects")
    return data


def build_context(run_dir: str, *, baseline_dir: Optional[str] = None,
                  thresholds: Optional[Thresholds] = None
                  ) -> DiagnosisContext:
    """Assemble everything the detectors read for one run."""
    from ..profile.timeline import build_timelines
    ctx = DiagnosisContext(
        graph=run_graph(run_dir),
        shard_graphs=shard_graphs(run_dir),
        timelines=build_timelines(run_dir),
        thresholds=thresholds,
        run_dir=os.path.abspath(run_dir))
    if baseline_dir:
        ctx.baseline_graph = run_graph(baseline_dir)
        ctx.baseline_timelines = build_timelines(baseline_dir)
    return ctx


@dataclass
class Diagnosis:
    """The result object: findings + enough context to render/gate."""

    run_dir: str
    findings: List[Finding]
    detectors: List[str]
    graph_stats: Dict[str, int] = field(default_factory=dict)
    manifest: Dict[str, Any] = field(default_factory=dict)
    baseline_dir: Optional[str] = None
    thresholds_path: Optional[str] = None
    detector_config_path: Optional[str] = None

    def counts(self) -> Dict[str, int]:
        c = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            c[f.severity] += 1
        return c

    def worst(self) -> Optional[str]:
        return max((f.severity for f in self.findings),
                   key=severity_rank, default=None)

    def should_fail(self, fail_on: Optional[str]) -> bool:
        """True when any finding is at/above `fail_on` ('warn'|'crit')."""
        if not fail_on or fail_on == "none":
            return False
        bar = severity_rank(fail_on)
        return any(severity_rank(f.severity) >= bar for f in self.findings)

    def to_json(self) -> dict:
        return {
            "run_dir": self.run_dir,
            "baseline_dir": self.baseline_dir,
            "thresholds": self.thresholds_path,
            "detector_config": self.detector_config_path,
            "detectors": list(self.detectors),
            "graph": dict(self.graph_stats),
            "manifest": self.manifest,
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
        }

    def render(self, top: int = 50) -> str:
        c = self.counts()
        what = self.manifest
        desc = ""
        if what:
            desc = (f" (config={what.get('config') or '-'} "
                    f"kind={what.get('kind') or '-'})")
        g = self.graph_stats
        lines = [
            f"diagnosis: {self.run_dir}{desc}",
            f"  graph: {g.get('components', 0)} components, "
            f"{g.get('edges', 0)} edges, {g.get('shards', 0)} shard(s), "
            f"{g.get('rings', 0)} ring(s); "
            f"{len(self.detectors)} detectors"
            + (f"; baseline: {self.baseline_dir}" if self.baseline_dir
               else "")
            + (f"; thresholds: {self.thresholds_path}"
               if self.thresholds_path else "")
            + (f"; detector-config: {self.detector_config_path}"
               if self.detector_config_path else ""),
            f"  findings: {c['crit']} crit, {c['warn']} warn, "
            f"{c['info']} info",
        ]
        for f in self.findings[:top]:
            lines.append(f"  [{f.severity.upper():4s}] {f.detector}: "
                         f"{f.message}")
        if len(self.findings) > top:
            lines.append(f"  ... ({len(self.findings) - top} more)")
        if not self.findings:
            lines.append("  no findings — profile looks healthy to every "
                         "detector")
        return "\n".join(lines)


def diagnose(root: str, *, run: Optional[str] = None,
             baseline: Optional[str] = None,
             thresholds_path: Optional[str] = None,
             detectors: Optional[Sequence[Detector]] = None,
             overrides: Optional[Dict[str, Dict]] = None,
             detector_config: Optional[str] = None) -> Diagnosis:
    """End-to-end diagnosis of one run (the CLI body, importable).

    detector_config: path to a JSON file of per-detector constructor
    parameters (see load_detector_config); programmatic `overrides` win
    over file values key-by-key."""
    run_dir = resolve_run_dir(root, run)
    baseline_dir = load_baseline(baseline, root) if baseline else None
    thr = Thresholds.load(thresholds_path) if thresholds_path else None
    ctx = build_context(run_dir, baseline_dir=baseline_dir, thresholds=thr)
    # normalize '-'/'_' spellings BEFORE merging: keyed raw, a file's
    # "wait-dominance" and a caller's "wait_dominance" would survive as
    # two entries and builtin_detectors' own normalization would keep
    # only one of them, silently dropping the other's values
    norm = lambda k: k.replace("_", "-")
    over: Dict[str, Dict] = {}
    if detector_config:
        over.update({norm(k): dict(v)
                     for k, v in load_detector_config(detector_config).items()})
    for name, kwargs in (overrides or {}).items():
        merged = dict(over.get(norm(name), {}))
        merged.update(kwargs)
        over[norm(name)] = merged
    dets = list(detectors) if detectors is not None \
        else builtin_detectors(**over)
    findings = run_detectors(ctx, dets)
    manifest: Dict[str, Any] = {}
    try:
        from ..profile.index import RunManifest
        manifest = RunManifest.load(run_dir).to_json()
    except (FileNotFoundError, json.JSONDecodeError, ValueError):
        pass                       # unregistered dirs still diagnose
    return Diagnosis(
        run_dir=os.path.abspath(run_dir),
        findings=findings,
        detectors=[d.name for d in dets],
        graph_stats={"components": len(ctx.graph.nodes),
                     "edges": len(ctx.graph.edges),
                     "shards": len(ctx.shard_graphs),
                     "rings": len(ctx.timelines)},
        manifest=manifest,
        baseline_dir=os.path.abspath(baseline_dir) if baseline_dir else None,
        thresholds_path=thresholds_path,
        detector_config_path=detector_config)
