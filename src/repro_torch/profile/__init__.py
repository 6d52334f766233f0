"""repro_torch.profile — persistence, indexing + cross-process aggregation
of XFA profiles.

  snapshot.py   schema-versioned columnar serialization of a FoldedTable
                (the same byte layout as the reference package)
  store.py      run dir of per-process snapshot rings + the reducer
  index.py      run manifests + RunRegistry.query (metadata predicates)
  timeline.py   per-edge count/total_ns/self_ns trajectories across a
                shard's ring; TimelineDiff aligns two runs' rings
  diff.py       run-over-run comparison with per-edge regression flagging
  transport.py  framed TCP wire protocol and FleetPublisher (the same
                protocol version and frame layout as the reference)
  collector.py  threaded collector daemon + spool layout
                (SPOOL/<run_id>/<host>/<shard>.seq<N>.xfa.npz)
  __main__.py   CLI: python -m repro_torch.profile
                {report,merge,diff,query,gc,timeline,calibrate,diagnose,
                 collect}

Interpretation (the Cross Flow Graph, the detectors, noise-band
calibration) lives in repro_torch.analysis.  Shards, spools and
thresholds written here load in the reference CLI
(`python -m repro.profile`), and the other way round.
"""

from .snapshot import SCHEMA_VERSION, SNAPSHOT_SUFFIX, ProfileSnapshot
from .store import (ProfileStore, RetentionPolicy, find_run_dirs,
                    host_label, load_profile, ring_entries, set_host_label,
                    split_snapshot_name, tracer_folded)
from .index import (MANIFEST_NAME, RunManifest, RunRegistry, kv_pair,
                    parse_mesh, register_run)
from .timeline import (ShardTimeline, TimelineDiff, build_timelines,
                       pair_timelines, render_timeline, render_timeline_diff)
from .diff import EdgeDelta, ProfileDiff, diff_profiles
from .transport import (PROTO_VERSION, Disconnect, FleetPublisher,
                        FrameError, frame_checksum, parse_addr, recv_frame,
                        send_frame)
from .collector import Collector, collect_main

__all__ = [
    "SCHEMA_VERSION", "SNAPSHOT_SUFFIX", "ProfileSnapshot",
    "ProfileStore", "RetentionPolicy", "find_run_dirs", "host_label",
    "load_profile", "ring_entries", "set_host_label",
    "split_snapshot_name", "tracer_folded",
    "MANIFEST_NAME", "RunManifest", "RunRegistry", "kv_pair", "parse_mesh",
    "register_run",
    "ShardTimeline", "TimelineDiff", "build_timelines", "pair_timelines",
    "render_timeline", "render_timeline_diff",
    "EdgeDelta", "ProfileDiff", "diff_profiles",
    "PROTO_VERSION", "Disconnect", "FleetPublisher", "FrameError",
    "frame_checksum", "parse_addr", "recv_frame", "send_frame",
    "Collector", "collect_main",
]
