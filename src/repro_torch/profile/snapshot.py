"""Columnar profile snapshots — the on-disk form of a FoldedTable.

This module WRITES schema version 3 (current, SCHEMA_VERSION) and READS
schemas 1–3.  The writer is *minimal-schema*: it emits the LOWEST
version that represents the content — no histogram block and no
sampling rates is the exact schema-1 byte layout; histograms without
sampling rates is the exact schema-2 layout; the schema-3 layout (an
optional `sample_rate` column from the adaptive overhead governor,
core.sampler) appears only when at least one edge was actually
subsampled.  Old files stay readable by new readers, rate-less files
stay byte-identical to their v1/v2 goldens.  See docs/schema.md for
the full layout reference.

One snapshot file is a compressed npz holding:

  __header__        uint8 bytes of a json document: schema version, group,
                    free-form meta (host/pid/label/...), the interned string
                    table, the metric name list, and (v2) n_hist_buckets —
                    the SlotRegistry half of the serialization
  caller/component/api   int32 [N] indices into the string table (the
                    relation-aware (caller, callee, api) key, columnar)
  kind              int8  [N]
  count/total_ns/child_ns/min_ns/max_ns   int64 [N] aligned stat columns
  metric_values     float64 [M, N]
  metric_mask       bool    [M, N]  (presence — absent metric != 0.0 metric)
  hist              uint64 [N, HIST_BUCKETS] latency histograms — schema 2+
                    only; an all-zero row means "no distribution" for
                    that edge (core.histogram)
  sample_rate       float64 [N] effective timing-sample rate — schema 3
                    only; a 1.0 row means "fully sampled" for that edge
                    (counts are always exact; time columns of a row with
                    rate < 1.0 are unbiased scale-ups, core.sampler)

The columns are exactly core.folding.EdgeColumns, so loading a snapshot
drops straight into the vectorized merge path without re-boxing per-edge
EdgeStats objects.  Round-trip is lossless: FoldedTable -> snapshot ->
FoldedTable preserves every stat, kind, metric, metric-presence bit and
histogram bucket.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from numpy.lib import format as _npformat

from ..core.folding import EdgeColumns, FoldedTable, merge_columns
from ..core.histogram import HIST_BUCKETS

#: bump on any incompatible layout change; loaders reject newer majors.
#: v1: stat columns + metrics.  v2: adds the optional uint64 [N, B]
#: `hist` member (+ `n_hist_buckets` header key).  v3: adds the optional
#: float64 [N] `sample_rate` member.  The writer emits the LOWEST
#: version that represents the content (see module docstring).
SCHEMA_VERSION = 3

SNAPSHOT_SUFFIX = ".xfa.npz"

_HEADER_KEY = "__header__"

#: fixed zip member timestamp (the zip epoch) — snapshot bytes must be a
#: function of their CONTENT only, so identical profiles hash/compare equal
#: and the golden-file schema test can pin the v1 layout byte-for-byte.
_ZIP_EPOCH = (1980, 1, 1, 0, 0, 0)


def _write_npz(f, arrays: Dict[str, np.ndarray], compress: bool) -> None:
    """np.savez_compressed replacement with deterministic output: fixed
    member timestamps/attributes and caller-controlled member order.  The
    result is a regular npz that np.load reads unchanged."""
    method = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
    with zipfile.ZipFile(f, "w", method) as zf:
        for name, arr in arrays.items():
            zi = zipfile.ZipInfo(name + ".npy", date_time=_ZIP_EPOCH)
            zi.compress_type = method
            zi.external_attr = 0o644 << 16
            with zf.open(zi, "w") as member:
                _npformat.write_array(member, np.asanyarray(arr),
                                      allow_pickle=False)


@dataclass
class ProfileSnapshot:
    """A FoldedTable in columnar form + provenance metadata."""

    columns: EdgeColumns
    meta: Dict[str, Any] = field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    # -- constructors -------------------------------------------------------
    @staticmethod
    def from_folded(folded: FoldedTable,
                    meta: Optional[Dict[str, Any]] = None) -> "ProfileSnapshot":
        return ProfileSnapshot(EdgeColumns.from_folded(folded),
                               meta=dict(meta or {}))

    @staticmethod
    def merge(snaps: Sequence["ProfileSnapshot"],
              meta: Optional[Dict[str, Any]] = None) -> "ProfileSnapshot":
        """Reduce N shards into one snapshot (columnar, order-insensitive)."""
        cols = merge_columns([s.columns for s in snaps])
        merged_meta: Dict[str, Any] = {
            "merged_from": [s.meta.get("label", "?") for s in snaps],
            "n_shards": len(snaps),
        }
        merged_meta.update(meta or {})
        return ProfileSnapshot(cols, meta=merged_meta)

    # -- views ----------------------------------------------------------------
    @property
    def group(self) -> str:
        return self.columns.group

    def to_folded(self) -> FoldedTable:
        return self.columns.to_folded()

    def __len__(self) -> int:
        return len(self.columns)

    # -- disk -----------------------------------------------------------------
    def save(self, path: str, compress: bool = True) -> str:
        """Atomic write (tmp + rename): periodic snapshotters overwrite their
        shard in place and a crashed writer never leaves a torn file.  The
        bytes are deterministic in the snapshot content (fixed zip metadata);
        `compress=False` additionally removes the zlib dependence, which is
        what checked-in golden/baseline files use."""
        cols = self.columns
        strings: Dict[str, int] = {}

        def intern(parts: List[str]) -> np.ndarray:
            return np.fromiter((strings.setdefault(s, len(strings))
                                for s in parts), dtype=np.int32,
                               count=len(parts))

        caller = intern([k[0] for k in cols.keys])
        component = intern([k[1] for k in cols.keys])
        api = intern([k[2] for k in cols.keys])
        # minimal-schema rule: bytes are a function of CONTENT — content
        # without histograms/rates is exactly a v1 file, without rates a
        # v2 file — old readers keep working and the v1/v2 goldens stay
        # pinned.  An all-1.0 rate column IS rate-less content (every
        # edge fully sampled), so merges that normalize back to full
        # sampling shed the column on disk.
        rates = cols.sample_rate
        if rates is not None and not (rates < 1.0).any():
            rates = None
        schema_out = 3 if rates is not None else \
            (2 if cols.hist is not None else 1)
        header = {
            "schema": schema_out,
            "group": cols.group,
            "meta": self.meta,
            "strings": list(strings),
            "metric_names": list(cols.metric_names),
            "n_edges": len(cols),
        }
        if cols.hist is not None:
            header["n_hist_buckets"] = int(cols.hist.shape[1])
        header_bytes = np.frombuffer(
            json.dumps(header, sort_keys=True).encode("utf-8"), dtype=np.uint8)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                arrays = {
                    _HEADER_KEY: header_bytes,
                    "caller": caller, "component": component, "api": api,
                    "kind": cols.kind, "count": cols.count,
                    "total_ns": cols.total_ns, "child_ns": cols.child_ns,
                    "min_ns": cols.min_ns, "max_ns": cols.max_ns,
                    "metric_values": cols.metric_values,
                    "metric_mask": cols.metric_mask,
                }
                if cols.hist is not None:
                    arrays["hist"] = cols.hist
                if rates is not None:
                    arrays["sample_rate"] = rates.astype(np.float64)
                _write_npz(f, arrays, compress=compress)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    @staticmethod
    def load(path: str) -> "ProfileSnapshot":
        with np.load(path) as z:
            if _HEADER_KEY not in z:
                raise ValueError(f"{path}: not an XFA profile snapshot")
            header = json.loads(bytes(z[_HEADER_KEY]).decode("utf-8"))
            schema = int(header.get("schema", -1))
            if schema > SCHEMA_VERSION or schema < 1:
                raise ValueError(
                    f"{path}: snapshot schema {schema} not supported by this "
                    f"reader (supports <= {SCHEMA_VERSION})")
            strings = header["strings"]
            caller = z["caller"]
            component = z["component"]
            api = z["api"]
            keys = [(strings[c], strings[m], strings[a])
                    for c, m, a in zip(caller, component, api)]
            hist = None
            if "hist" in z.files:
                hist = z["hist"].astype(np.uint64)
                nb = int(header.get("n_hist_buckets", hist.shape[1]))
                if hist.shape != (len(keys), nb) or nb != HIST_BUCKETS:
                    raise ValueError(
                        f"{path}: hist block {hist.shape} does not match "
                        f"{len(keys)} edges x {HIST_BUCKETS} buckets")
            rate = None
            if "sample_rate" in z.files:
                rate = z["sample_rate"].astype(np.float64)
                if rate.shape != (len(keys),):
                    raise ValueError(
                        f"{path}: sample_rate column {rate.shape} does not "
                        f"match {len(keys)} edges")
            cols = EdgeColumns(
                keys=keys,
                count=z["count"].astype(np.int64),
                total_ns=z["total_ns"].astype(np.int64),
                child_ns=z["child_ns"].astype(np.int64),
                min_ns=z["min_ns"].astype(np.int64),
                max_ns=z["max_ns"].astype(np.int64),
                kind=z["kind"].astype(np.int8),
                metric_names=list(header["metric_names"]),
                metric_values=z["metric_values"].astype(np.float64),
                metric_mask=z["metric_mask"].astype(bool),
                group=header.get("group", "main"),
                hist=hist,
                sample_rate=rate,
            )
        if len(cols) != int(header.get("n_edges", len(cols))):
            raise ValueError(f"{path}: edge count mismatch vs header")
        return ProfileSnapshot(cols, meta=dict(header.get("meta", {})),
                               schema=schema)
