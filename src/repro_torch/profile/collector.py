"""Central fleet collector — spool daemon for streamed snapshot rings.

`python -m repro_torch.profile collect --spool DIR --port P` runs a threaded
TCP server speaking the framed transport (transport.py).  Every client
session is one `(run_id, host)` pair; acknowledged ring entries land in
the spool as

    SPOOL/<run_id>/manifest.json                      (merged run manifest)
    SPOOL/<run_id>/<host>/<shard>.<seq:06d>.xfa.npz   (host's ring entries)

which is exactly a run directory the rest of the profile plane already
understands: `ProfileStore`/`merge`/`report` reduce the newest entry of
every `<host>/<shard>` ring (host-qualified stems, so two hosts' rank-0
rings never collide), `timeline` walks each ring, `query` indexes the
manifests, and `gc` applies retention per host subdirectory.

Durability contract: a snapshot is acked only after its sha256 matched
and the bytes were written via tmp + rename into the host directory —
the spool NEVER holds a torn file, and the ack state IS the spool (a
restarted collector rebuilds it by listing the run's host dir), so
resume needs no side journal.

The collector folds its own ingest metrics through the process tracer
(`collector.frame` / `collector.ingest_bytes` / `collector.dedup_hit` /
`collector.reject` counts, per-frame `collector.ingest` durations, a
`collector.client_lag` gauge of how far behind each hello's resume
point was) — the profile plane observes itself; `--self-profile` spools
those folds as a run of their own (`SPOOL/_collector`).
"""

from __future__ import annotations

import json
import os
import socketserver
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from ..core import tracer as xfa
from .index import MANIFEST_NAME, RunManifest, register_run
from .snapshot import SNAPSHOT_SUFFIX
from .store import snapshot_name, split_snapshot_name
from .transport import (MAX_FRAME_BYTES, PROTO_VERSION, Disconnect,
                        FrameError, frame_checksum, recv_frame, send_frame)

#: collector-side run id for the collector's own profile shard ring
SELF_RUN_ID = "_collector"


def _safe_part(name: str, what: str) -> str:
    """Reject path-escaping run/host/shard names from the wire: the
    spool layout is attacker-adjacent input, '../' must die here."""
    if (not name or name != os.path.basename(name) or name.startswith(".")
            or "/" in name or "\\" in name or os.sep in name):
        raise FrameError(f"illegal {what} {name!r} in frame")
    return name


class _Handler(socketserver.BaseRequestHandler):
    """One client connection: hello -> ack_state, then a frame loop."""

    def handle(self) -> None:  # noqa: C901 - one dispatch loop
        col: Collector = self.server.collector        # type: ignore
        sock = self.request
        sock.settimeout(col.timeout)
        run_id = host = None
        try:
            header, _ = recv_frame(sock, col.max_frame_bytes)
            if header.get("type") != "hello":
                raise FrameError(f"expected hello, got {header.get('type')!r}")
            if int(header.get("proto", 0)) != PROTO_VERSION:
                raise FrameError(
                    f"protocol {header.get('proto')!r} != {PROTO_VERSION}")
            run_id = _safe_part(str(header.get("run_id", "")), "run_id")
            host = _safe_part(str(header.get("host", "")), "host")
            acked = col.ack_state(run_id, host)
            send_frame(sock, {"type": "ack_state", "acked": acked})
            xfa.TRACER.count_event("collector", "session")
            while True:
                header, payload = recv_frame(sock, col.max_frame_bytes)
                kind = header.get("type")
                if kind == "bye":
                    return
                t0 = time.perf_counter_ns()
                if kind == "snapshot":
                    reply = col.ingest_snapshot(header, payload, acked)
                elif kind == "manifest":
                    reply = col.ingest_manifest(header, payload)
                else:
                    raise FrameError(f"unexpected frame type {kind!r}")
                xfa.TRACER.record_duration(
                    "collector", "ingest", time.perf_counter_ns() - t0)
                send_frame(sock, reply)
        except Disconnect:
            pass            # client went away; acked state is durable
        except (FrameError, OSError, ValueError) as e:
            xfa.TRACER.count_event("collector", "protocol_error")
            try:
                send_frame(sock, {"type": "error", "reason": str(e)})
            except OSError:
                pass


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class Collector:
    """The spool daemon body (the `collect` subcommand, importable)."""

    def __init__(self, spool: str, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 30.0,
                 max_frame_bytes: int = MAX_FRAME_BYTES) -> None:
        self.spool = spool
        self.timeout = timeout
        self.max_frame_bytes = max_frame_bytes
        os.makedirs(spool, exist_ok=True)
        self._server = _Server((host, port), _Handler)
        self._server.collector = self        # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None
        self._manifest_locks: Dict[str, threading.Lock] = {}
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    @property
    def port(self) -> int:
        return self.address[1]

    def start(self) -> "Collector":
        """Serve on a daemon thread (tests / in-process embedding)."""
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="xfa-collector", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "Collector":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- spool state --------------------------------------------------------
    def host_dir(self, run_id: str, host: str) -> str:
        return os.path.join(self.spool, run_id, host)

    def ack_state(self, run_id: str, host: str) -> Dict[str, int]:
        """shard stem -> max spooled seq for one (run_id, host) — rebuilt
        from the spool itself, so a collector restart resumes exactly."""
        acked: Dict[str, int] = {}
        d = self.host_dir(run_id, host)
        try:
            names = os.listdir(d)
        except (FileNotFoundError, NotADirectoryError):
            return acked
        for name in names:
            if not name.endswith(SNAPSHOT_SUFFIX):
                continue
            stem, seq = split_snapshot_name(name)
            acked[stem] = max(acked.get(stem, 0), seq)
        return acked

    # -- frame ingestion ----------------------------------------------------
    def ingest_snapshot(self, header: Dict, payload: bytes,
                        acked: Dict[str, int]) -> Dict:
        run_id = _safe_part(str(header.get("run_id", "")), "run_id")
        host = _safe_part(str(header.get("host", "")), "host")
        shard = _safe_part(str(header.get("shard", "")), "shard")
        seq = int(header.get("seq", 0))
        if seq < 1:
            return {"type": "reject", "shard": shard, "seq": seq,
                    "reason": f"sequence {seq} out of range"}
        want = str(header.get("sha256", ""))
        if len(payload) != int(header.get("length", -1)) \
                or frame_checksum(payload) != want:
            xfa.TRACER.count_event("collector", "reject")
            return {"type": "reject", "shard": shard, "seq": seq,
                    "reason": "checksum/length mismatch — re-send"}
        # per-client resume lag: how far beyond the previous ack this
        # frame lands (1 == in-order next entry, more == catching up)
        xfa.TRACER.record_gauge("collector", "client_lag",
                                float(seq - acked.get(shard, 0)))
        xfa.TRACER.count_event("collector", "frame")
        xfa.TRACER.count_event("collector", "ingest_bytes", n=len(payload))
        d = self.host_dir(run_id, host)
        path = os.path.join(d, snapshot_name(shard, seq))
        if os.path.exists(path):
            # dedup (a replayed frame after an ack the client never saw,
            # or two publishers sharing a run dir): the spool entry is
            # content-addressed by (run, host, shard, seq) + checksum
            with open(path, "rb") as f:
                have = f.read()
            if frame_checksum(have) == want:
                xfa.TRACER.count_event("collector", "dedup_hit")
                acked[shard] = max(acked.get(shard, 0), seq)
                return {"type": "ack", "shard": shard, "seq": seq,
                        "dedup": True}
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        acked[shard] = max(acked.get(shard, 0), seq)
        return {"type": "ack", "shard": shard, "seq": seq, "dedup": False}

    def ingest_manifest(self, header: Dict, payload: bytes) -> Dict:
        run_id = _safe_part(str(header.get("run_id", "")), "run_id")
        _safe_part(str(header.get("host", "")), "host")
        if len(payload) != int(header.get("length", -1)) or \
                frame_checksum(payload) != str(header.get("sha256", "")):
            xfa.TRACER.count_event("collector", "reject")
            return {"type": "reject", "shard": MANIFEST_NAME, "seq": 0,
                    "reason": "checksum/length mismatch — re-send"}
        try:
            doc = json.loads(payload.decode("utf-8"))
            incoming = RunManifest.from_json(doc)
        except (UnicodeDecodeError, json.JSONDecodeError, ValueError) as e:
            return {"type": "reject", "shard": MANIFEST_NAME, "seq": 0,
                    "reason": f"manifest does not parse: {e}"}
        run_dir = os.path.join(self.spool, run_id)
        # serialize per-run merges locally; register_run's flock guards
        # against OTHER processes touching the same spool
        with self._lock:
            lock = self._manifest_locks.setdefault(run_id, threading.Lock())
        with lock:
            m = register_run(
                run_dir, config=incoming.config, arch=incoming.arch,
                mesh_shape=incoming.mesh_shape, mesh_axes=incoming.mesh_axes,
                label=incoming.label, kind=incoming.kind,
                meta=incoming.meta,
                started_at=incoming.started_at or None)
            # union the publishers' writer entries into the spool manifest
            # (register_run above only appended the collector itself)
            known = {(w.get("label"), w.get("host"), w.get("pid"))
                     for w in m.writers}
            extra = [w for w in incoming.writers
                     if (w.get("label"), w.get("host"), w.get("pid"))
                     not in known]
            if extra:
                m.writers.extend(extra)
                m.save()
        xfa.TRACER.count_event("collector", "manifest")
        return {"type": "ack", "shard": MANIFEST_NAME, "seq": 0,
                "dedup": False}

    # -- self-observation ---------------------------------------------------
    def write_self_shard(self) -> Optional[str]:
        """Spool the collector's own tracer folds as a run of their own
        (`SPOOL/_collector`): the profile plane observes itself."""
        from .store import ProfileStore, tracer_folded
        folded = tracer_folded()
        if not len(folded):
            return None
        run_dir = os.path.join(self.spool, SELF_RUN_ID)
        register_run(run_dir, label="collector", kind="collect",
                     meta={"spool": os.path.abspath(self.spool)})
        return ProfileStore(run_dir).write_shard(folded, label="collector")


def collect_main(spool: str, host: str, port: int, timeout: float,
                 max_frame_bytes: int, max_seconds: float,
                 self_profile: bool, self_profile_interval_s: float) -> int:
    """The `collect` subcommand body: serve until SIGINT/SIGTERM (or
    `max_seconds`, for CI lanes), periodically spooling self metrics."""
    import signal
    col = Collector(spool, host=host, port=port, timeout=timeout,
                    max_frame_bytes=max_frame_bytes)
    bind_host, bind_port = col.address
    print(f"collector listening on {bind_host}:{bind_port} "
          f"spool={os.path.abspath(spool)}", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:           # not the main thread (embedded use)
            break
    col.start()
    deadline = time.monotonic() + max_seconds if max_seconds > 0 else None
    next_self = time.monotonic() + self_profile_interval_s
    try:
        while not stop.is_set():
            if deadline is not None and time.monotonic() >= deadline:
                break
            stop.wait(timeout=0.2)
            if self_profile and time.monotonic() >= next_self:
                col.write_self_shard()
                next_self = time.monotonic() + self_profile_interval_s
    finally:
        if self_profile:
            col.write_self_shard()
        col.shutdown()
    print(f"collector stopped; spool={os.path.abspath(spool)}", flush=True)
    return 0
