"""Noise-band calibration — measured per-edge variance instead of a
hand-picked global threshold.

The profile-diff CI gate (and any cross-run comparison) needs to know how
much an edge's count/total/self wobbles between *healthy* runs before a
growth can be called a regression.  ScALPEL's argument applies directly:
diagnostics must adapt their sensitivity to the measured behaviour, not to
one magic constant.  This module fits per-(edge, field) bands from either

  * a set of BASELINE RUNS (each profile one sample — e.g. the synthetic
    CI workload at several seeds, or last week's nightly runs), or
  * one run's snapshot RING (each per-interval delta one sample — in-run
    variance, for drift detectors).

and serializes them as a thresholds JSON that both `diff --thresholds`
and `diagnose --thresholds` consume: the allowed relative growth of an
edge becomes max(floor, k_sigma * std / mean) of ITS OWN band, falling
back to the global `--threshold` for edges never seen in calibration.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

from ..core.folding import FoldedTable
from ..core.shadow import SlotKey
from .graph import edge_label

#: fields a band can be fitted on (self_ns/mean_ns derive per sample; the
#: percentile/jitter fields read schema-v2 latency histograms and fit 0.0
#: bands over hist-less edges, matching diff's 0.0-valued percentiles).
CALIBRATE_FIELDS = ("count", "total_ns", "self_ns", "mean_ns",
                    "p50_ns", "p95_ns", "p99_ns", "jitter_ns")

THRESHOLDS_SCHEMA = 1


@dataclass(frozen=True)
class EdgeBand:
    """Summary statistics of one (edge, field) across calibration samples."""

    n: int
    mean: float
    std: float
    p95: float
    lo: float
    hi: float

    @staticmethod
    def fit(values: Sequence[float]) -> "EdgeBand":
        # pure python on purpose: samples are a handful of floats per
        # edge, and numpy's percentile/std dispatch overhead dominated a
        # fleet-sized calibration (10k+ edges) by >2x
        vals = sorted(float(v) for v in values)
        n = len(vals)
        if n == 0:
            raise ValueError("EdgeBand.fit needs at least one sample")
        mean = sum(vals) / n
        std = (sum((v - mean) ** 2 for v in vals) / n) ** 0.5
        h = 0.95 * (n - 1)                 # numpy's 'linear' interpolation
        i = int(h)
        p95 = vals[i] + (vals[min(i + 1, n - 1)] - vals[i]) * (h - i)
        return EdgeBand(n=n, mean=mean, std=std, p95=p95,
                        lo=vals[0], hi=vals[-1])

    def to_json(self) -> dict:
        return {"n": self.n, "mean": self.mean, "std": self.std,
                "p95": self.p95, "lo": self.lo, "hi": self.hi}

    @staticmethod
    def from_json(d: dict) -> "EdgeBand":
        return EdgeBand(n=int(d["n"]), mean=float(d["mean"]),
                        std=float(d["std"]), p95=float(d["p95"]),
                        lo=float(d["lo"]), hi=float(d["hi"]))


@dataclass
class Thresholds:
    """Per-edge noise bands + the rule turning them into rel thresholds."""

    bands: Dict[str, Dict[str, EdgeBand]] = field(default_factory=dict)
    k_sigma: float = 3.0
    floor: float = 0.05
    fields: tuple = CALIBRATE_FIELDS
    meta: Dict[str, Any] = field(default_factory=dict)
    schema: int = THRESHOLDS_SCHEMA

    def band(self, key: SlotKey, fld: str) -> Optional[EdgeBand]:
        return self.bands.get(edge_label(key), {}).get(fld)

    def rel_threshold(self, key: SlotKey, fld: str,
                      default: float) -> float:
        """Allowed relative growth for (edge, field): k_sigma standard
        deviations of its own band, floored so a zero-variance edge (e.g.
        a deterministic count) still tolerates rounding-level change.
        Edges without a band keep the caller's `default`."""
        b = self.band(key, fld)
        if b is None or b.mean <= 0:
            return default
        return max(self.floor, self.k_sigma * b.std / b.mean)

    def noise_ns(self, key: SlotKey, fld: str = "total_ns") -> float:
        """Absolute per-sample noise scale (k_sigma * std); 0 when unknown.
        Drift detectors use it as an evidence floor."""
        b = self.band(key, fld)
        return self.k_sigma * b.std if b is not None else 0.0

    def __len__(self) -> int:
        return len(self.bands)

    # -- persistence --------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "schema": self.schema,
            "k_sigma": self.k_sigma,
            "floor": self.floor,
            "fields": list(self.fields),
            "meta": self.meta,
            "edges": {label: {fld: b.to_json() for fld, b in sorted(
                per.items())} for label, per in sorted(self.bands.items())},
        }

    @staticmethod
    def from_json(d: dict) -> "Thresholds":
        schema = int(d.get("schema", -1))
        if schema > THRESHOLDS_SCHEMA or schema < 1:
            raise ValueError(f"thresholds schema {schema} not supported "
                             f"(supports <= {THRESHOLDS_SCHEMA})")
        return Thresholds(
            bands={label: {fld: EdgeBand.from_json(b)
                           for fld, b in per.items()}
                   for label, per in d.get("edges", {}).items()},
            k_sigma=float(d.get("k_sigma", 3.0)),
            floor=float(d.get("floor", 0.05)),
            fields=tuple(d.get("fields", CALIBRATE_FIELDS)),
            meta=dict(d.get("meta", {})), schema=schema)

    def save(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @staticmethod
    def load(path: str) -> "Thresholds":
        with open(path) as f:
            return Thresholds.from_json(json.load(f))


def _edge_value(e, fld: str) -> float:
    return float(getattr(e, fld))


def calibrate_runs(tables: Iterable[FoldedTable], *,
                   fields: Sequence[str] = CALIBRATE_FIELDS,
                   k_sigma: float = 3.0, floor: float = 0.05,
                   meta: Optional[Dict[str, Any]] = None) -> Thresholds:
    """Fit bands treating each profile as one independent sample of the
    same workload.  An edge absent from a run contributes 0.0 — presence
    variance IS variance (a sometimes-there edge gets a wide band)."""
    tables = list(tables)
    if not tables:
        raise ValueError("calibrate_runs needs at least one profile")
    for fld in fields:
        if fld not in CALIBRATE_FIELDS:
            raise ValueError(f"unknown calibration field {fld!r}; "
                             f"choose from {CALIBRATE_FIELDS}")
    keys = sorted({k for t in tables for k in t.edges})
    bands: Dict[str, Dict[str, EdgeBand]] = {}
    for key in keys:
        per: Dict[str, EdgeBand] = {}
        for fld in fields:
            vals = [(_edge_value(t.edges[key], fld)
                     if key in t.edges else 0.0) for t in tables]
            per[fld] = EdgeBand.fit(vals)
        bands[edge_label(key)] = per
    m = {"mode": "runs", "n_samples": len(tables)}
    m.update(meta or {})
    return Thresholds(bands=bands, k_sigma=k_sigma, floor=floor,
                      fields=tuple(fields), meta=m)


def calibrate_ring(timelines, *, fields: Sequence[str] = CALIBRATE_FIELDS,
                   k_sigma: float = 3.0, floor: float = 0.05,
                   meta: Optional[Dict[str, Any]] = None) -> Thresholds:
    """Fit bands from one (or more) shard rings: every per-interval delta
    of an edge is one sample of its steady-state activity.  Negative
    deltas (writer restarts) are excluded — a restart is not noise."""
    timelines = list(timelines)
    for fld in fields:
        if fld not in CALIBRATE_FIELDS:
            raise ValueError(f"unknown calibration field {fld!r}; "
                             f"choose from {CALIBRATE_FIELDS}")

    def diffs(s: List[float]) -> List[float]:
        return [s[0]] + [b - a for a, b in zip(s, s[1:])]

    samples: Dict[SlotKey, Dict[str, List[float]]] = {}
    n_intervals = 0
    for tl in timelines:
        n_intervals += max(len(tl) - 1, 0)
        # a retention-trimmed ring's first snapshot is a CUMULATIVE fold
        # of everything before it, not one interval — sampling it would
        # inflate every band (and silently blind the gate).  Only a ring
        # that still holds seq 1 contributes its first value as a sample.
        start = 0 if (tl.seqs and tl.seqs[0] == 1) else 1
        for key in tl.edges():
            # one pass per edge: every field's per-interval deltas derive
            # from the three base cumulative series (a fleet-sized ring
            # has 10k+ edges; re-walking the ring per field dominated)
            counts = tl.series(key, "count")
            totals = tl.series(key, "total_ns")
            childs = tl.series(key, "child_ns")
            dc, dt = diffs(counts), diffs(totals)
            derived = {
                "count": dc,
                "total_ns": dt,
                "self_ns": diffs([t - c for t, c in zip(totals, childs)]),
                # per-interval TRUE mean, matching ShardTimeline.deltas
                "mean_ns": [t / c if c > 0 else (-1.0 if c < 0 else 0.0)
                            for t, c in zip(dt, dc)],
            }
            for fld in fields:
                if fld not in derived:
                    # percentile/jitter: per-interval quantiles off the
                    # differenced histograms (ShardTimeline handles the
                    # hist algebra; restarts come back as -1.0 and are
                    # dropped by the v >= 0 filter below)
                    derived[fld] = tl.deltas(key, fld)
            per = samples.setdefault(key, {f: [] for f in fields})
            for fld in fields:
                per[fld].extend(v for v in derived[fld][start:] if v >= 0)
    if not samples:
        raise ValueError("calibrate_ring: no ring intervals to sample")
    bands = {edge_label(k): {fld: EdgeBand.fit(vs)
                             for fld, vs in per.items() if vs}
             for k, per in sorted(samples.items())}
    m = {"mode": "ring", "n_shards": len(timelines),
         "n_intervals": n_intervals}
    m.update(meta or {})
    return Thresholds(bands=bands, k_sigma=k_sigma, floor=floor,
                      fields=tuple(fields), meta=m)
