"""Profile store — a run directory of per-process snapshot rings + reducer.

The paper persists one file per *thread* at thread exit and merges offline;
a ProfileStore is the per-*process* analogue for fleets: every process (one
trainer rank, one serving replica, one host of a mesh) owns a shard named
after (label, host, pid).  Since v2 a shard is not a single atomically
-replaced file but a bounded ring of *sequence-numbered* snapshots

    <label>-<host>-<pid>.000001.xfa.npz
    <label>-<host>-<pid>.000002.xfa.npz ...

written on each periodic refresh.  Folds are cumulative, so the NEWEST
snapshot of a shard supersedes the older ones for aggregation (reduce /
report / merge all use only the newest per shard), while the older ring
entries are the shard's *time series* — `python -m repro.profile timeline`
renders per-edge trajectories across them, which is how drift inside one
run becomes visible (ScalAna's per-run performance-graph argument).

The ring is bounded by a RetentionPolicy (keep-last-N per shard, max-age,
max-bytes per run dir) enforced in the writer on every refresh and offline
via `python -m repro.profile gc`.  The newest snapshot of a shard is never
deleted — a live shard always keeps its latest cumulative fold.

Legacy v1 shards (`<label>-<host>-<pid>.xfa.npz`, no sequence number) load
as sequence 0 of their shard, so old run dirs keep reducing.
"""

from __future__ import annotations

import glob
import os
import re
import socket
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..core.folding import FoldedTable
from .snapshot import SNAPSHOT_SUFFIX, ProfileSnapshot

#: sequence-numbered ring entry: <stem>.<seq:06d>.xfa.npz
_SEQ_RE = re.compile(r"^(?P<stem>.+)\.(?P<seq>\d{6})$")

#: manifest filename (canonically index.MANIFEST_NAME; repeated here as a
#: literal because index imports store — host_label — and a module cycle
#: is worse than one duplicated constant)
_MANIFEST_NAME = "manifest.json"

#: process-wide host identity override (``--xfa-host-label``): shard
#: stems, snapshot/writer metadata and the fleet transport all derive
#: the host from here, so tests and containers with meaningless
#: hostnames can give every publisher a distinct, stable identity.
_HOST_LABEL: Optional[str] = None


def set_host_label(label: Optional[str]) -> None:
    """Override the host identity recorded by every profile writer in
    this process (None restores `socket.gethostname()`)."""
    global _HOST_LABEL
    _HOST_LABEL = label or None


def host_label() -> str:
    """The host identity profile writers record (override or hostname)."""
    return _HOST_LABEL or socket.gethostname()


def split_snapshot_name(path: str) -> Tuple[str, int]:
    """(shard stem, sequence number) of a snapshot path; legacy un-numbered
    snapshots are sequence 0 of their stem."""
    name = os.path.basename(path)
    if name.endswith(SNAPSHOT_SUFFIX):
        name = name[: -len(SNAPSHOT_SUFFIX)]
    m = _SEQ_RE.match(name)
    if m:
        return m.group("stem"), int(m.group("seq"))
    return name, 0


def snapshot_name(stem: str, seq: int) -> str:
    return f"{stem}.{seq:06d}{SNAPSHOT_SUFFIX}"


def ring_entries(root: str) -> List[Tuple[str, int, str]]:
    """Every ring entry under a run dir as (qualified stem, seq, path).

    A run dir is either flat (each writer's ring directly inside) or the
    collector's spool layout with one subdirectory per HOST
    (`<run>/<host>/<shard>.<seq>.xfa.npz`, docs/fleet.md).  Subdir
    entries get host-qualified stems (`<host>/<shard>`) so two hosts'
    same-named rings never alias in reduce/shard_graphs/timeline.  A
    subdirectory carrying its own manifest is its OWN run dir (a nested
    registry), not a host of this one, and is skipped.
    """
    out = []
    for p in glob.glob(os.path.join(root, f"*{SNAPSHOT_SUFFIX}")):
        stem, seq = split_snapshot_name(p)
        out.append((stem, seq, p))
    for p in glob.glob(os.path.join(root, "*", f"*{SNAPSHOT_SUFFIX}")):
        sub = os.path.dirname(p)
        if os.path.exists(os.path.join(sub, _MANIFEST_NAME)):
            continue
        stem, seq = split_snapshot_name(p)
        out.append((f"{os.path.basename(sub)}/{stem}", seq, p))
    out.sort()
    return out


def tracer_folded(tracer=None) -> FoldedTable:
    """Merge every per-thread shadow table of `tracer` (default: the process
    tracer) into one raw FoldedTable — the process's current host-layer fold."""
    if tracer is None:
        from ..core import tracer as xfa
        tracer = xfa.TRACER
    return FoldedTable.merge_all(
        FoldedTable.from_set(tracer.tables, rates=tracer.sample_rates()))


@dataclass(frozen=True)
class RetentionPolicy:
    """Bounded-footprint rules for one run directory.

    keep_last   ring length per shard (0: unbounded)
    max_age_s   delete snapshots older than this (0: unbounded)
    max_bytes   total snapshot bytes per run dir; oldest-first eviction
                across shards until under budget (0: unbounded)

    Whatever the rule, the newest snapshot of every shard survives: a live
    shard's latest cumulative fold is the one file aggregation needs.
    """

    keep_last: int = 8
    max_age_s: float = 0.0
    max_bytes: int = 0

    @property
    def unbounded(self) -> bool:
        return not (self.keep_last or self.max_age_s or self.max_bytes)

    def doomed(self, root: str, now: Optional[float] = None) -> List[str]:
        """Paths under `root` this policy would delete (oldest-first)."""
        if self.unbounded:
            return []
        now = time.time() if now is None else now
        entries = []  # (stem, seq, path, size, mtime); stems are host-
        # qualified in the collector's spool layout, so keep-last applies
        # per (host, shard) ring, exactly as the publishers wrote them
        for stem, seq, p in ring_entries(root):
            try:
                st = os.stat(p)
            except FileNotFoundError:      # concurrent writer GC'd it
                continue
            entries.append((stem, seq, p, st.st_size, st.st_mtime))
        newest = {}  # stem -> max seq
        for stem, seq, *_ in entries:
            newest[stem] = max(newest.get(stem, -1), seq)
        protected = {p for stem, seq, p, *_ in entries
                     if seq == newest[stem]}
        doomed: Dict[str, float] = {}  # path -> mtime (dict keeps order out)
        by_stem: Dict[str, List] = {}
        for e in entries:
            by_stem.setdefault(e[0], []).append(e)
        for stem, es in by_stem.items():
            es.sort(key=lambda e: (-e[1], -e[4]))  # newest first
            if self.keep_last:
                for e in es[self.keep_last:]:
                    if e[2] not in protected:
                        doomed[e[2]] = e[4]
            if self.max_age_s:
                for e in es:
                    if now - e[4] > self.max_age_s and e[2] not in protected:
                        doomed[e[2]] = e[4]
        if self.max_bytes:
            live = [e for e in entries if e[2] not in doomed]
            total = sum(e[3] for e in live)
            # oldest first: (mtime, seq) — never the newest of a stem
            for e in sorted(live, key=lambda e: (e[4], e[1])):
                if total <= self.max_bytes:
                    break
                if e[2] in protected:
                    continue
                doomed[e[2]] = e[4]
                total -= e[3]
        return sorted(doomed, key=doomed.get)

    def enforce(self, root: str, now: Optional[float] = None,
                dry_run: bool = False) -> List[str]:
        """Delete (or with dry_run just report) out-of-policy snapshots."""
        victims = self.doomed(root, now=now)
        if not dry_run:
            for p in victims:
                try:
                    os.unlink(p)
                except FileNotFoundError:  # lost a race with another writer
                    pass
        return victims


class ProfileStore:
    """One run directory: per-process shard rings; anyone can reduce."""

    def __init__(self, root: str,
                 retention: Optional[RetentionPolicy] = None) -> None:
        # NO makedirs here: readers (query -v, timeline, reduce) construct
        # stores too, and a typo'd path must error, not leave empty dirs
        # behind to pollute later registry scans.  write_shard creates it.
        self.root = root
        self.retention = RetentionPolicy() if retention is None else retention

    # -- writer side --------------------------------------------------------
    def shard_stem(self, label: str = "shard") -> str:
        host = host_label().split(".")[0]
        return f"{label}-{host}-{os.getpid()}"

    def next_seq(self, stem: str) -> int:
        seqs = [seq for s, seq, _ in ring_entries(self.root) if s == stem]
        return max(seqs, default=0) + 1

    def write_shard(self, folded: FoldedTable, label: str = "shard",
                    meta: Optional[Dict[str, Any]] = None) -> str:
        """Append the next ring snapshot for this process's shard and
        enforce retention.  Folds are cumulative: each snapshot holds the
        whole run so far, so the newest alone is enough to aggregate and
        consecutive snapshots difference into per-interval activity."""
        os.makedirs(self.root, exist_ok=True)
        stem = self.shard_stem(label)
        seq = self.next_seq(stem)
        shard_meta: Dict[str, Any] = {
            "label": label,
            "host": host_label(),
            "pid": os.getpid(),
            "seq": seq,
            "written_at": time.time(),
        }
        shard_meta.update(meta or {})
        snap = ProfileSnapshot.from_folded(folded, meta=shard_meta)
        path = snap.save(os.path.join(self.root, snapshot_name(stem, seq)))
        self.retention.enforce(self.root)
        return path

    # -- reader side ----------------------------------------------------------
    def snapshot_paths(self) -> List[str]:
        """Every ring entry of every shard in this run dir (including the
        per-host subdirectories of a collector spool run)."""
        return sorted(p for _stem, _seq, p in ring_entries(self.root))

    def shards(self) -> Dict[str, List[Tuple[int, str]]]:
        """stem -> [(seq, path), ...] ascending — each shard's time series.
        Stems of spool-layout entries are host-qualified (`host/shard`)."""
        out: Dict[str, List[Tuple[int, str]]] = {}
        for stem, seq, p in ring_entries(self.root):
            out.setdefault(stem, []).append((seq, p))
        for ring in out.values():
            ring.sort()
        return out

    def shard_paths(self) -> List[str]:
        """The NEWEST snapshot of each shard — what aggregation consumes
        (cumulative folds: the latest ring entry supersedes the others)."""
        return sorted(ring[-1][1] for ring in self.shards().values())

    def load_shards(self) -> List[ProfileSnapshot]:
        """Load newest-per-shard snapshots, EXCLUDING merged outputs:
        `merge -o` into the shard dir must not make the next reduce count
        everything twice."""
        shards = []
        skipped = []
        for p in self.shard_paths():
            snap = ProfileSnapshot.load(p)
            if "merged_from" in snap.meta:
                skipped.append(os.path.basename(p))
            else:
                shards.append(snap)
        if skipped:
            warnings.warn(
                f"profile dir {self.root!r}: ignoring already-merged "
                f"snapshot(s) {skipped} when reducing shards", stacklevel=2)
        return shards

    def reduce(self, meta: Optional[Dict[str, Any]] = None) -> ProfileSnapshot:
        shards = self.load_shards()
        if not shards:
            raise FileNotFoundError(f"no profile shards under {self.root!r}")
        # two shards with the same (label, host) but different pids are
        # either a stale shard from a previous run (double-counts every
        # edge) or replicas sharing a label — either way worth surfacing
        by_writer: Dict[Tuple[str, str], int] = {}
        for s in shards:
            k = (str(s.meta.get("label", "?")), str(s.meta.get("host", "?")))
            by_writer[k] = by_writer.get(k, 0) + 1
        dups = [k for k, n in by_writer.items() if n > 1]
        if dups:
            warnings.warn(
                f"profile dir {self.root!r} holds multiple shards with the "
                f"same (label, host) {dups}; the reduce SUMS them. If these "
                "are stale shards from a previous run, use a fresh "
                "--profile-dir per run; if they are concurrent replicas, "
                "give each a distinct label (e.g. --profile-label serve-0)",
                stacklevel=2)
        if len(shards) == 1 and not meta:
            return shards[0]
        return ProfileSnapshot.merge(shards, meta=meta)

    def __len__(self) -> int:
        return len(self.shard_paths())


def find_run_dirs(root: str) -> List[str]:
    """Directories under `root` (inclusive) holding profile snapshots —
    the unit `gc` applies a RetentionPolicy to.  A directory whose
    PARENT carries a manifest is a per-host subdirectory of a collector
    spool run (docs/fleet.md), not a run of its own: it collapses into
    the parent so retention sees the whole run (host-qualified rings,
    one byte budget) exactly as the reducer does."""
    dirs = set()
    for p in glob.glob(os.path.join(root, "**", f"*{SNAPSHOT_SUFFIX}"),
                       recursive=True):
        d = os.path.dirname(p)
        parent = os.path.dirname(d)
        if not os.path.exists(os.path.join(d, _MANIFEST_NAME)) and \
                os.path.exists(os.path.join(parent, _MANIFEST_NAME)):
            d = parent
        dirs.add(d)
    return sorted(dirs)


def load_profile(path: str) -> ProfileSnapshot:
    """Load a profile from a snapshot file, a shard directory (reduced), or
    a legacy FoldedTable json dump."""
    if os.path.isdir(path):
        return ProfileStore(path).reduce()
    if path.endswith(".json"):
        return ProfileSnapshot.from_folded(FoldedTable.load(path),
                                           meta={"label": path})
    return ProfileSnapshot.load(path)
