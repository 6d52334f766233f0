"""Profile diff — run-over-run comparison with per-edge regression flags.

Compares two profiles (baseline vs candidate) edge by edge on the
relation-aware key and flags edges whose count / total_ns / self_ns grew
beyond a relative threshold — the persisted-profile analogue of the scaling
-loss detection that per-run performance graphs enable (ScalAna): once every
run leaves a snapshot behind, a regression is one `diff` away.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.folding import EdgeStats, FoldedTable
from ..core.shadow import SlotKey

#: fields a regression can be flagged on; self_ns/mean_ns are derived, and
#: the percentile/jitter fields read the edge's latency histogram (schema
#: v2) — they evaluate to 0.0 on hist-less edges, so gating on p99_ns
#: drift is a no-op over v1 profiles rather than an error.
DIFF_FIELDS = ("count", "total_ns", "self_ns", "mean_ns",
               "p50_ns", "p95_ns", "p99_ns", "jitter_ns")


def _value(e: EdgeStats, fld: str) -> float:
    return float(getattr(e, fld))


@dataclass
class EdgeDelta:
    key: SlotKey
    base: Optional[EdgeStats]
    cand: Optional[EdgeStats]
    #: field -> (base value, candidate value, relative delta); rel is inf
    #: when the baseline value is 0 and the candidate is not.
    deltas: Dict[str, Tuple[float, float, float]] = field(default_factory=dict)
    #: fields whose relative growth exceeded the threshold
    flagged: List[str] = field(default_factory=list)

    @property
    def regressed(self) -> bool:
        return bool(self.flagged)

    def describe(self) -> str:
        caller, comp, api = self.key
        if self.base is None:
            return f"{caller} -> {comp}.{api}: NEW edge"
        if self.cand is None:
            return f"{caller} -> {comp}.{api}: edge DISAPPEARED"
        parts = []
        for fld in self.flagged:
            b, c, rel = self.deltas[fld]
            parts.append(f"{fld} {b:.0f} -> {c:.0f} ({rel:+.1%})")
        out = f"{caller} -> {comp}.{api}: " + ", ".join(parts)
        # confidence marker: when the overhead governor subsampled either
        # side, time columns are scaled estimates — counts stay exact
        rates = [r for r in (self.base.sample_rate, self.cand.sample_rate)
                 if r is not None]
        if rates:
            out += (f"  [subsampled: rate {min(rates):.3f} — "
                    f"time deltas are scaled estimates]")
        return out


@dataclass
class ProfileDiff:
    threshold: float
    fields: Tuple[str, ...]
    regressions: List[EdgeDelta]
    improvements: List[EdgeDelta]
    added: List[EdgeDelta]
    removed: List[EdgeDelta]
    unchanged: int
    #: whether significant NEW edges count as regressions (a rename/refactor
    #: can shift a hot edge's time into an added key — without this, such a
    #: slowdown would slip past the exit-code gate)
    flag_added: bool = True
    #: True when per-edge calibrated noise bands decided the flags (the
    #: global `threshold` then only covers uncalibrated edges)
    calibrated: bool = False

    @property
    def has_regressions(self) -> bool:
        return bool(self.regressions) or (self.flag_added
                                          and bool(self.added))

    def render(self, max_rows: int = 30) -> str:
        how = f"calibrated bands, fallback {self.threshold:.0%}" \
            if self.calibrated else f"threshold {self.threshold:.0%}"
        lines = [f"profile diff ({how} on "
                 f"{'/'.join(self.fields)}): "
                 f"{len(self.regressions)} regressed, "
                 f"{len(self.improvements)} improved, "
                 f"{len(self.added)} new, {len(self.removed)} gone, "
                 f"{self.unchanged} unchanged"]
        if self.regressions:
            lines.append("regressions:")
            for d in self.regressions[:max_rows]:
                lines.append(f"  REG  {d.describe()}")
            if len(self.regressions) > max_rows:
                lines.append(f"  ... ({len(self.regressions)-max_rows} more)")
        for title, rows in (("new edges:", self.added),
                            ("disappeared edges:", self.removed)):
            if rows:
                lines.append(title)
                for d in rows[:10]:
                    lines.append(f"       {d.describe()}")
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "threshold": self.threshold,
            "calibrated": self.calibrated,
            "fields": list(self.fields),
            "unchanged": self.unchanged,
            "regressions": [
                {"caller": d.key[0], "component": d.key[1], "api": d.key[2],
                 "flagged": {f: {"base": d.deltas[f][0],
                                 "cand": d.deltas[f][1],
                                 "rel": d.deltas[f][2]} for f in d.flagged}}
                for d in self.regressions
            ],
            "added": [list(d.key) for d in self.added],
            "removed": [list(d.key) for d in self.removed],
        }


def diff_profiles(base: FoldedTable, cand: FoldedTable,
                  threshold: float = 0.25,
                  fields: Sequence[str] = ("total_ns", "self_ns", "count"),
                  min_count: int = 1,
                  min_total_ns: int = 0,
                  flag_added: bool = True,
                  thresholds=None) -> ProfileDiff:
    """Per-edge comparison; an edge regresses when any requested field grew
    by more than its threshold relative to baseline.  Edges below
    `min_count` / `min_total_ns` in BOTH profiles are ignored (noise
    floor).  With `flag_added` (default), significant new edges also fail
    the gate — raise `min_total_ns` to tolerate small new edges.

    `thresholds` (repro_torch.analysis.Thresholds, from `calibrate`) switches
    the gate to MEASURED variance: each calibrated edge tolerates
    k_sigma standard deviations of its own band instead of the global
    `threshold`, which stays the fallback for never-calibrated edges."""
    for fld in fields:
        if fld not in DIFF_FIELDS:
            raise ValueError(f"unknown diff field {fld!r}; "
                             f"choose from {DIFF_FIELDS}")
    regressions: List[EdgeDelta] = []
    improvements: List[EdgeDelta] = []
    added: List[EdgeDelta] = []
    removed: List[EdgeDelta] = []
    unchanged = 0

    def significant(e: Optional[EdgeStats]) -> bool:
        return e is not None and e.count >= min_count \
            and e.total_ns >= min_total_ns

    for key in sorted(base.edges.keys() | cand.edges.keys()):
        b = base.edges.get(key)
        c = cand.edges.get(key)
        if not (significant(b) or significant(c)):
            continue
        if b is None:
            added.append(EdgeDelta(key, None, c))
            continue
        if c is None:
            removed.append(EdgeDelta(key, b, None))
            continue
        d = EdgeDelta(key, b, c)
        improved = False
        for fld in fields:
            thr = threshold if thresholds is None \
                else thresholds.rel_threshold(key, fld, threshold)
            bv, cv = _value(b, fld), _value(c, fld)
            if bv == 0.0:
                rel = float("inf") if cv > 0 else 0.0
            else:
                rel = (cv - bv) / bv
            d.deltas[fld] = (bv, cv, rel)
            if rel > thr:
                d.flagged.append(fld)
            elif rel < -thr:
                improved = True
        if d.flagged:
            regressions.append(d)
        elif improved:
            improvements.append(d)
        else:
            unchanged += 1
    regressions.sort(
        key=lambda d: -max(d.deltas[f][2] for f in d.flagged))
    return ProfileDiff(threshold=threshold, fields=tuple(fields),
                       regressions=regressions, improvements=improvements,
                       added=added, removed=removed, unchanged=unchanged,
                       flag_added=flag_added,
                       calibrated=thresholds is not None)
