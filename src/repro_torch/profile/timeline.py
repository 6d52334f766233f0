"""Timeline — per-edge trajectories across a shard's snapshot ring.

A shard's ring entries are cumulative folds taken at increasing sequence
numbers, so differencing consecutive snapshots yields the per-interval
activity of every edge: count/total_ns/self_ns between step K and step
K+N.  Rendering those deltas side by side is the in-run drift detector —
an edge whose per-interval time creeps up (garbage accumulation, a cache
filling, a slot pool fragmenting) is flat in any single snapshot and
obvious on the timeline.

TimelineDiff extends the same idea ACROSS runs: two rings of the same
config align by ring index and render per-edge delta-of-deltas (how the
per-interval activity changed between run A and run B, interval by
interval) — `python -m repro_torch.profile timeline RUN_A --diff RUN_B`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.folding import FoldedTable
from ..core.histogram import jitter_ns as _hist_jitter, percentile_ns
from ..core.shadow import SlotKey, edge_label as _edge_key_str
from .snapshot import ProfileSnapshot
from .store import ProfileStore

#: fields a timeline can plot; self_ns/mean_ns derive per snapshot, and
#: the percentile/jitter fields need schema-v2 histograms (0.0 where a
#: snapshot has none for the edge).
TIMELINE_FIELDS = ("count", "total_ns", "self_ns", "mean_ns",
                   "p50_ns", "p95_ns", "p99_ns", "jitter_ns")

#: histogram-derived fields: per-interval values come from DIFFERENCED
#: cumulative histograms (exact — bucket counts are cumulative sums),
#: not from differencing the percentile series (meaningless).
_PCT_FIELDS = ("p50_ns", "p95_ns", "p99_ns", "jitter_ns")


def _pct_of(hist: Optional[np.ndarray], fld: str) -> float:
    if fld == "jitter_ns":
        return _hist_jitter(hist)
    return percentile_ns(hist, {"p50_ns": 0.50, "p95_ns": 0.95,
                                "p99_ns": 0.99}[fld])


@dataclass
class ShardTimeline:
    """One shard's ring, loaded: aligned (seq, meta, folded) triples."""

    stem: str
    seqs: List[int]
    metas: List[Dict[str, Any]]
    tables: List[FoldedTable]

    def __len__(self) -> int:
        return len(self.seqs)

    def edges(self) -> List[SlotKey]:
        keys = set()
        for t in self.tables:
            keys.update(t.edges)
        return sorted(keys)

    def series(self, key: SlotKey, fld: str = "total_ns") -> List[float]:
        """Cumulative value of `fld` at each snapshot (0 while absent)."""
        out = []
        for t in self.tables:
            e = t.edges.get(key)
            out.append(float(getattr(e, fld)) if e is not None else 0.0)
        return out

    def deltas(self, key: SlotKey, fld: str = "total_ns") -> List[float]:
        """Per-interval activity: first snapshot's value, then successive
        differences of the cumulative series.  A negative delta means the
        writer restarted (a new cumulative fold began) — rendered with a
        '!' marker.

        `mean_ns` is not cumulative, so differencing it would alias any
        ordinary speedup into a fake restart; instead each interval gets
        its TRUE mean, delta(total_ns) / delta(count) (0 for an idle
        interval, negative only on an actual counter regression).

        The percentile/jitter fields difference the cumulative HISTOGRAMS
        and read the quantile off each interval's exact distribution
        (bucket counts are cumulative, so the subtraction is loss-free);
        -1.0 marks a bucket-count regression (writer restart)."""
        if fld in _PCT_FIELDS:
            hists = self._hist_series(key)
            out = [_pct_of(hists[0], fld)]
            for i in range(1, len(hists)):
                prev, cur = hists[i - 1], hists[i]
                if cur is None:
                    out.append(0.0)
                elif prev is None:
                    out.append(_pct_of(cur, fld))
                else:
                    dh = cur.astype(np.int64) - prev.astype(np.int64)
                    out.append(-1.0 if (dh < 0).any() else _pct_of(dh, fld))
            return out
        if fld == "mean_ns":
            counts = self.series(key, "count")
            totals = self.series(key, "total_ns")
            out = [totals[0] / counts[0] if counts[0] else 0.0]
            for i in range(1, len(counts)):
                dc = counts[i] - counts[i - 1]
                dt = totals[i] - totals[i - 1]
                out.append(dt / dc if dc > 0 else (-1.0 if dc < 0 else 0.0))
            return out
        s = self.series(key, fld)
        return [s[0]] + [b - a for a, b in zip(s, s[1:])]

    def _hist_series(self, key: SlotKey) -> List[Optional[np.ndarray]]:
        """Each snapshot's cumulative histogram for `key` (None if absent)."""
        out: List[Optional[np.ndarray]] = []
        for t in self.tables:
            e = t.edges.get(key)
            out.append(e.hist if e is not None else None)
        return out

    def steps(self) -> List[Any]:
        """Per-snapshot progress marker from writer meta (step/ticks/seq)."""
        out = []
        for seq, meta in zip(self.seqs, self.metas):
            out.append(meta.get("step", meta.get("ticks", seq)))
        return out

    def kind_of(self, key: SlotKey) -> str:
        """'call' or 'wait' for `key` (from the newest table holding it)."""
        from ..core.shadow import KIND_NAMES
        for t in reversed(self.tables):
            e = t.edges.get(key)
            if e is not None:
                return KIND_NAMES[e.kind]
        return KIND_NAMES[0]

    def to_json(self, fld: str = "total_ns") -> dict:
        """Machine-readable ring: each edge carries its STRUCTURED key
        ([caller, component, api]) and kind alongside the rendered label,
        so calibration and external tooling consume rings without parsing
        'a -> b.c' strings back apart."""
        return {
            "stem": self.stem,
            "seqs": self.seqs,
            "steps": self.steps(),
            "field": fld,
            "edges": {
                _edge_key_str(k): {"key": list(k),
                                   "kind": self.kind_of(k),
                                   "series": self.series(k, fld),
                                   "deltas": self.deltas(k, fld)}
                for k in self.edges()
            },
        }


def build_timelines(root: str, shard: Optional[str] = None,
                    min_len: int = 1) -> List[ShardTimeline]:
    """Load every shard ring under run dir `root` (optionally filtered by a
    `shard` substring of the stem) with at least `min_len` snapshots."""
    store = ProfileStore(root)
    out = []
    for stem, ring in sorted(store.shards().items()):
        if shard is not None and shard not in stem:
            continue
        if len(ring) < min_len:
            continue
        seqs, metas, tables = [], [], []
        for seq, path in ring:
            snap = ProfileSnapshot.load(path)
            if "merged_from" in snap.meta:   # merge products are not shards
                continue
            seqs.append(seq)
            metas.append(snap.meta)
            tables.append(snap.to_folded())
        if len(seqs) >= min_len:
            out.append(ShardTimeline(stem, seqs, metas, tables))
    return out


@dataclass
class TimelineDiff:
    """Two shard rings (same config, two runs) aligned by SEQUENCE NUMBER.

    Both rings are written on the same cadence (profile_interval
    steps/ticks), so equal sequence numbers mark the same phase of each
    run.  Alignment uses the *intersection* of the two rings' seq sets:
    each aligned column is the interval between consecutive common seqs
    (plus a from-run-start column when both rings still hold seq 1), and
    each ring's per-interval value is differenced between exactly those
    two snapshots.  This stays correct when retention trimmed the rings
    differently — naive ring-position alignment would pair a trimmed
    ring's first entry (a CUMULATIVE fold of everything before it) with
    the other run's single-interval delta and rank the artifact as the
    top drift.  The payload is the per-edge delta-of-deltas: how much
    more (or less) per-interval count/time an edge spent in B than in A,
    interval by interval — the cross-run drift detector (run-level `diff`
    compares only cumulative totals and cannot see WHEN a regression
    develops)."""

    a: ShardTimeline
    b: ShardTimeline

    def columns(self) -> List[Tuple[Optional[int], int]]:
        """Aligned intervals as (prev_seq, seq); prev None = run start."""
        common = sorted(set(self.a.seqs) & set(self.b.seqs))
        cols: List[Tuple[Optional[int], int]] = []
        if common and common[0] == 1:    # both rings begin at the true start
            cols.append((None, 1))
        cols += list(zip(common[:-1], common[1:]))
        return cols

    def __len__(self) -> int:
        return len(self.columns())

    def edges(self) -> List[SlotKey]:
        return sorted(set(self.a.edges()) | set(self.b.edges()))

    def deltas(self, tl: ShardTimeline, key: SlotKey,
               fld: str = "total_ns") -> List[float]:
        """One ring's per-aligned-interval activity for `key` (one pass:
        the seq->index map and series are built once per call)."""
        cols = self.columns()
        idx = {s: i for i, s in enumerate(tl.seqs)}
        if fld in _PCT_FIELDS:           # interval quantile from hist diffs
            hists = tl._hist_series(key)
            out = []
            for prev, cur in cols:
                hc = hists[idx[cur]]
                hp = hists[idx[prev]] if prev is not None else None
                if hc is None:
                    out.append(0.0)
                elif hp is None:
                    out.append(_pct_of(hc, fld))
                else:
                    dh = hc.astype(np.int64) - hp.astype(np.int64)
                    out.append(-1.0 if (dh < 0).any() else _pct_of(dh, fld))
            return out
        if fld == "mean_ns":             # true per-interval mean (cf. deltas)
            tot = tl.series(key, "total_ns")
            cnt = tl.series(key, "count")
            out = []
            for prev, cur in cols:
                dt = tot[idx[cur]] - (tot[idx[prev]] if prev is not None
                                      else 0.0)
                dc = cnt[idx[cur]] - (cnt[idx[prev]] if prev is not None
                                      else 0.0)
                out.append(dt / dc if dc > 0 else (-1.0 if dc < 0 else 0.0))
            return out
        s = tl.series(key, fld)
        return [s[idx[cur]] - (s[idx[prev]] if prev is not None else 0.0)
                for prev, cur in cols]

    def delta_of_deltas(self, key: SlotKey, fld: str = "total_ns"
                        ) -> List[float]:
        """Per-aligned-interval activity of B minus A."""
        return [y - x for x, y in zip(self.deltas(self.a, key, fld),
                                      self.deltas(self.b, key, fld))]

    def to_json(self, fld: str = "total_ns") -> dict:
        cols = self.columns()
        edges = {}
        b_keys = set(self.b.edges())
        for k in self.edges():
            da = self.deltas(self.a, k, fld)
            db = self.deltas(self.b, k, fld)
            edges[_edge_key_str(k)] = {
                "key": list(k),
                "kind": (self.b if k in b_keys else self.a).kind_of(k),
                "deltas_a": da,
                "deltas_b": db,
                "delta_of_deltas": [y - x for x, y in zip(da, db)],
            }
        return {
            "a": {"stem": self.a.stem, "seqs": self.a.seqs},
            "b": {"stem": self.b.stem, "seqs": self.b.seqs},
            "aligned": len(cols),
            "columns": [[p, c] for p, c in cols],
            "field": fld,
            "edges": edges,
        }


def pair_timelines(a: List[ShardTimeline], b: List[ShardTimeline]
                   ) -> List[TimelineDiff]:
    """Pair two runs' shards for diffing: by stem-order (stems embed the
    label, so replicas labelled serve-0/serve-1 pair with their cross-run
    counterparts; host/pid parts differ across runs by construction)."""
    aa = sorted(a, key=lambda t: t.stem)
    bb = sorted(b, key=lambda t: t.stem)
    return [TimelineDiff(x, y) for x, y in zip(aa, bb)]


def render_timeline_diff(td: TimelineDiff, fld: str = "total_ns",
                         top: int = 12, edge: Optional[str] = None) -> str:
    """Tabular per-edge delta-of-deltas, largest absolute drift first.

    Cells are signed B-minus-A per-interval increments; a consistently
    positive row is an edge whose per-interval cost GREW between runs."""
    if fld not in TIMELINE_FIELDS:
        raise ValueError(f"unknown timeline field {fld!r}; "
                         f"choose from {TIMELINE_FIELDS}")
    cols = td.columns()
    if not cols:
        return (f"timeline diff {td.a.stem} -> {td.b.stem}: no common "
                f"sequence numbers (A holds {td.a.seqs}, B holds "
                f"{td.b.seqs}) — rings were retained past each other; "
                f"nothing comparable")
    n = len(cols)
    keys = td.edges()
    if edge:
        keys = [k for k in keys if edge in _edge_key_str(k)]
    dd = {k: td.delta_of_deltas(k, fld) for k in keys}   # computed once
    keys.sort(key=lambda k: -sum(abs(v) for v in dd[k]))
    shown = keys[:top]
    head = [f"timeline diff {td.a.stem} -> {td.b.stem}: {n} aligned "
            f"intervals, field={fld} (per-interval B-minus-A)"]
    marks = [f"s{0 if p is None else p}>s{c}" for p, c in cols]
    if len(td.a) != len(td.b):
        head.append(f"  (ring lengths differ: {len(td.a)} vs {len(td.b)} "
                    f"snapshots; only common seqs are compared)")
    width = max([len(m) for m in marks] + [10])
    label_w = max([len(_edge_key_str(k)) for k in shown] + [20])
    head.append("  ".join([" " * label_w] + [m.rjust(width) for m in marks]))
    for k in shown:
        cells = [f"{v:+.0f}".rjust(width) for v in dd[k]]
        head.append("  ".join([_edge_key_str(k).ljust(label_w)] + cells))
    if len(keys) > top:
        head.append(f"  ... ({len(keys) - top} more edges)")
    return "\n".join(head)


def render_timeline(tl: ShardTimeline, fld: str = "total_ns",
                    top: int = 12, edge: Optional[str] = None) -> str:
    """Tabular per-edge deltas across the ring, hottest edges first.

    First column is the value at the first snapshot, later columns the
    per-interval increments ('+N'); '!' marks a negative delta (writer
    restart).  `edge` filters rows by substring.
    """
    if fld not in TIMELINE_FIELDS:
        raise ValueError(f"unknown timeline field {fld!r}; "
                         f"choose from {TIMELINE_FIELDS}")
    keys = tl.edges()
    if edge:
        keys = [k for k in keys if edge in _edge_key_str(k)]
    keys.sort(key=lambda k: -tl.series(k, fld)[-1])
    shown = keys[:top]
    what = "per-interval means" if fld == "mean_ns" \
        else "per-interval deltas"
    head = [f"timeline {tl.stem}: {len(tl)} snapshots, field={fld} "
            f"(first value, then {what})"]
    marks = [f"seq{s}" + (f"@{st}" if st != s else "")
             for s, st in zip(tl.seqs, tl.steps())]
    width = max([len(m) for m in marks] + [10])
    label_w = max([len(_edge_key_str(k)) for k in shown] + [20])
    head.append("  ".join([" " * label_w] + [m.rjust(width) for m in marks]))
    for k in shown:
        d = tl.deltas(k, fld)
        cells = [f"{d[0]:.0f}".rjust(width)]
        for v in d[1:]:
            cell = f"{v:+.0f}" + ("!" if v < 0 else "")
            cells.append(cell.rjust(width))
        head.append("  ".join([_edge_key_str(k).ljust(label_w)] + cells))
    if len(keys) > top:
        head.append(f"  ... ({len(keys) - top} more edges)")
    return "\n".join(head)
