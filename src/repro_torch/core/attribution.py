"""Runtime attribution — serial/parallel phases, wait separation, imbalance.

Paper mapping (Scaler §3.4–§3.5):

 * An API invoked in a serial phase costs its full duration; in a parallel
   phase its end-to-end impact is duration / #active-threads.  Scaler divides
   at recording time; we divide at fold time (the fold keeps raw durations, so
   the division is reversible and testable).
 * Waiting time (condvar/barrier/lock) is separated into a 'Wait' pseudo
   category — time where the program does no useful work.
 * Thread groups with significantly different wait/exec ratios indicate load
   imbalance (learned from SyncPerf; the paper's ferret/dedup-2 case studies).

TPU adaptation: "threads" generalize to parallel lanes of the system —
host threads (pipeline stages, data workers) and device shards (DP replicas,
pipeline stages).  `attribute_parallel` divides a fold by its lane count;
`imbalance_report` compares groups; both run on folded tables, never on logs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .folding import EdgeStats, FoldedTable
from .shadow import KIND_WAIT


@dataclass
class PhaseAttribution:
    """A fold re-weighted for end-to-end impact."""

    folded: FoldedTable
    n_lanes: int
    phase: str  # 'serial' | 'parallel'


def attribute_serial(folded: FoldedTable) -> PhaseAttribution:
    return PhaseAttribution(folded, 1, "serial")


def attribute_parallel(folded: FoldedTable, n_lanes: int) -> PhaseAttribution:
    """Divide durations by the number of active lanes (paper §3.4)."""
    if n_lanes <= 0:
        raise ValueError("n_lanes must be positive")
    return PhaseAttribution(folded.scale_time(1.0 / n_lanes), n_lanes, "parallel")


def combine_phases(phases: Sequence[PhaseAttribution]) -> FoldedTable:
    out = FoldedTable()
    for p in phases:
        out = out.merge(p.folded)
    return out


def wait_split(folded: FoldedTable) -> Tuple[FoldedTable, FoldedTable]:
    """Split a fold into (useful, wait) sub-folds (paper's Wait category)."""
    useful = {k: v for k, v in folded.edges.items() if v.kind != KIND_WAIT}
    wait = {k: v for k, v in folded.edges.items() if v.kind == KIND_WAIT}
    return (FoldedTable(useful, folded.group), FoldedTable(wait, folded.group))


@dataclass
class GroupStats:
    group: str
    n_tables: int
    exec_ns: int
    wait_ns: int

    @property
    def wait_frac(self) -> float:
        tot = self.exec_ns + self.wait_ns
        return self.wait_ns / tot if tot else 0.0


@dataclass
class ImbalanceReport:
    groups: List[GroupStats]
    max_exec_ratio: float   # max(exec)/min(exec) across groups
    imbalanced: bool
    threshold: float

    def render(self) -> str:
        lines = [f"{'group':<16}{'tables':>7}{'exec_ms':>12}{'wait_ms':>12}"
                 f"{'wait%':>8}"]
        for g in self.groups:
            lines.append(f"{g.group:<16}{g.n_tables:>7}"
                         f"{g.exec_ns/1e6:>12.2f}{g.wait_ns/1e6:>12.2f}"
                         f"{100*g.wait_frac:>7.1f}%")
        verdict = ("IMBALANCED" if self.imbalanced else "balanced")
        lines.append(f"exec max/min ratio: {self.max_exec_ratio:.2f}x -> {verdict}"
                     f" (threshold {self.threshold:.1f}x)")
        return "\n".join(lines)


def imbalance_report(per_group_folds: Dict[str, List[FoldedTable]],
                     threshold: float = 4.0) -> ImbalanceReport:
    """Compare effective exec time across thread/lane groups.

    The paper flags ferret when rank threads' effective exec is ~16x seg's;
    we flag when max/min exec across groups exceeds `threshold`.
    """
    groups: List[GroupStats] = []
    for name, folds in sorted(per_group_folds.items()):
        exec_ns = 0
        wait_ns = 0
        for f in folds:
            useful, wait = wait_split(f)
            exec_ns += sum(e.self_ns for e in useful.edges.values())
            wait_ns += sum(e.total_ns for e in wait.edges.values())
        groups.append(GroupStats(name, len(folds), exec_ns, wait_ns))
    execs = [g.exec_ns for g in groups if g.exec_ns > 0]
    ratio = (max(execs) / min(execs)) if len(execs) >= 2 else 1.0
    return ImbalanceReport(groups, ratio, ratio > threshold, threshold)


def expert_imbalance(loads: Sequence[float], threshold: float = 4.0
                     ) -> Tuple[bool, float]:
    """Device-fold analogue of thread imbalance: MoE expert loads.

    Returns (imbalanced?, max/mean ratio).  Mirrors the ferret diagnosis —
    'different thread groups have very different effective execution time' —
    with experts as the lanes and routed token counts as the work."""
    loads = [float(x) for x in loads]
    if not loads or sum(loads) == 0:
        return (False, 1.0)
    mean = sum(loads) / len(loads)
    ratio = max(loads) / mean if mean else 1.0
    return (ratio > threshold, ratio)
