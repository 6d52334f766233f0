"""repro_torch.analysis — automated cross-flow diagnosis over XFA profiles.

Everything repro_torch.profile collects (shadow-table folds -> columnar shards
-> snapshot rings -> run registry) becomes *interpretable* here: a typed
Cross Flow Graph, a set of pathology detectors with structured findings,
noise-band calibration for variance-aware thresholds, and the
orchestration behind `python -m repro_torch.profile diagnose`.

  graph.py      FlowGraph (typed nodes/edges from EdgeColumns) + per-shard
                projections (one comparable subgraph per rank/replica)
  detectors.py  Detector protocol, Finding, and the 9 built-in detectors
  calibrate.py  per-edge noise bands (mean/std/p95) from baseline runs or
                a ring, serialized as a thresholds JSON
  diagnose.py   run selection -> DiagnosisContext -> findings -> report
  fleet.py      cross-run/cross-host ranking behind `diagnose --fleet`:
                per-host merged graphs, fleet-straggler + run-outlier
                findings, reports grouped by (severity, detector, host)
"""

from .graph import (FlowEdge, FlowGraph, FlowNode, edge_label, run_graph,
                    shard_graphs)
from .calibrate import (CALIBRATE_FIELDS, EdgeBand, Thresholds,
                        calibrate_ring, calibrate_runs)
from .detectors import (SEVERITIES, CachePressure, CallAmplification,
                        Detector, DiagnosisContext, DriftRegression,
                        Finding, HotEdgeConcentration, QueueSaturation,
                        RankImbalance, SamplingBackoff, SloViolation,
                        WaitDominance, builtin_detectors, detector_classes,
                        run_detectors, severity_rank)
from .diagnose import (Diagnosis, build_context, diagnose,
                       load_detector_config, resolve_run_dir)
from .fleet import (FleetDiagnosis, diagnose_fleet, fleet_straggler_findings,
                    host_graphs, stem_host)

__all__ = [
    "FlowEdge", "FlowGraph", "FlowNode", "edge_label", "run_graph",
    "shard_graphs",
    "CALIBRATE_FIELDS", "EdgeBand", "Thresholds", "calibrate_ring",
    "calibrate_runs",
    "SEVERITIES", "CachePressure", "CallAmplification", "Detector",
    "DiagnosisContext",
    "DriftRegression", "Finding", "HotEdgeConcentration", "QueueSaturation",
    "RankImbalance", "SamplingBackoff", "SloViolation", "WaitDominance",
    "builtin_detectors", "detector_classes", "run_detectors",
    "severity_rank",
    "Diagnosis", "build_context", "diagnose", "load_detector_config",
    "resolve_run_dir",
    "FleetDiagnosis", "diagnose_fleet", "fleet_straggler_findings",
    "host_graphs", "stem_host",
]
