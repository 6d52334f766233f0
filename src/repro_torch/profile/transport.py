"""Fleet shard transport — framed snapshot-ring deltas over TCP.

Every process of a fleet (trainer rank, serving replica) owns a local
snapshot ring (store.py) whose entries are byte-deterministic and
sequence-numbered.  That makes incremental shipping nearly free: a
publisher only ever needs to send ring entries NEWER than what the
collector has already acknowledged, and resume after a disconnect or a
collector restart is just "ask what you have" — no journals, no client
state files.

Wire protocol (version 1; see docs/fleet.md for the normative frame and
failure-matrix reference):

    frame := u32_be header_len | header_json utf-8 | payload bytes

The header is a small JSON object carrying `type` plus type-specific
fields; `length` (payload byte count, 0 when absent) and `sha256` (hex
digest of the payload) ride in the header so the receiver can validate
before touching its spool.  Client -> collector types:

    hello     {proto, run_id, host}                open a session; the
                                                   collector answers
                                                   ack_state
    snapshot  {run_id, host, shard, seq,           one raw .xfa.npz ring
               length, sha256} + payload           entry
    manifest  {run_id, host, length, sha256}       the run's
              + payload                            manifest.json bytes
    bye       {}                                   graceful close

Collector -> client types:

    ack_state {acked: {shard: max_seq}}            resume point for the
                                                   (run_id, host) session
    ack       {shard, seq, dedup}                  payload spooled (or
                                                   already present)
    reject    {shard, seq, reason}                 checksum/length
                                                   mismatch — re-send
    error     {reason}                             protocol error; the
                                                   collector closes

Every socket operation runs under a timeout; an EOF inside a frame
raises `Disconnect`, malformed bytes raise `FrameError`.  The publisher
(`FleetPublisher`) NEVER raises out of `publish()` — a dead collector
degrades the fleet to local-only rings, it must not kill a train or
serve loop.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import struct
import time
from typing import Dict, Optional, Tuple

PROTO_VERSION = 1

#: refuse frames beyond this unless the caller raises it — a fleet
#: snapshot is a few KiB to a few MiB; 256 MiB is a corrupt length
#: prefix, not a profile.
MAX_FRAME_BYTES = 256 * 1024 * 1024

_LEN = struct.Struct("!I")


class FrameError(ValueError):
    """Malformed frame: bad length prefix, bad JSON, missing fields."""


class Disconnect(ConnectionError):
    """Peer closed the connection (possibly mid-frame)."""


def frame_checksum(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def parse_addr(addr: str) -> Tuple[str, int]:
    """'host:port' -> (host, port); the launcher flag surface."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"collector address {addr!r} is not HOST:PORT")
    return host, int(port)


def send_frame(sock: socket.socket, header: Dict,
               payload: bytes = b"") -> None:
    """One atomic-ish send: length-prefixed header, then the payload.
    `length`/`sha256` are filled in from the payload when absent."""
    h = dict(header)
    h.setdefault("length", len(payload))
    if payload and "sha256" not in h:
        h["sha256"] = frame_checksum(payload)
    raw = json.dumps(h, sort_keys=True).encode("utf-8")
    sock.sendall(_LEN.pack(len(raw)) + raw + payload)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise Disconnect on EOF mid-read."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise Disconnect(f"peer closed after {len(buf)}/{n} bytes")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket,
               max_bytes: int = MAX_FRAME_BYTES) -> Tuple[Dict, bytes]:
    """Read one (header, payload) frame.  Raises Disconnect on EOF at a
    frame boundary or inside a frame, FrameError on malformed bytes."""
    head = sock.recv(_LEN.size)
    if not head:
        raise Disconnect("peer closed between frames")
    if len(head) < _LEN.size:
        head += recv_exact(sock, _LEN.size - len(head))
    (hlen,) = _LEN.unpack(head)
    if not 0 < hlen <= 1 << 20:
        raise FrameError(f"header length {hlen} out of range")
    try:
        header = json.loads(recv_exact(sock, hlen).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise FrameError(f"bad frame header: {e}") from e
    if not isinstance(header, dict) or "type" not in header:
        raise FrameError(f"frame header missing 'type': {header!r}")
    plen = int(header.get("length", 0))
    if not 0 <= plen <= max_bytes:
        raise FrameError(f"payload length {plen} exceeds {max_bytes}")
    payload = recv_exact(sock, plen) if plen else b""
    return header, payload


class FleetPublisher:
    """Ships one run dir's snapshot-ring deltas to a collector.

    Tracks the collector's acked `(shard, seq)` state (seeded by the
    `ack_state` reply to `hello`, updated by every `ack`) and on each
    `publish()` sends only ring entries strictly newer than that —
    reconnect (or a collector restart) re-seeds the state, so exactly
    the unacked suffix is re-sent, never the whole ring.

    Failure policy: `publish()` never raises.  Any socket/protocol
    error closes the connection, records `last_error`, and the next
    publish retries (rate-limited by `retry_interval_s`).  The local
    ring is always written first by the caller, so a dead collector
    degrades to local-only profiling.
    """

    def __init__(self, addr, run_dir: str, run_id: Optional[str] = None,
                 host: Optional[str] = None, timeout: float = 5.0,
                 retry_interval_s: float = 5.0) -> None:
        self.addr = parse_addr(addr) if isinstance(addr, str) else tuple(addr)
        self.run_dir = run_dir
        self.run_id = run_id or \
            os.path.basename(os.path.normpath(run_dir)) or "run"
        if host is None:
            from .store import host_label
            host = host_label()
        self.host = host
        self.timeout = timeout
        self.retry_interval_s = retry_interval_s
        self._sock: Optional[socket.socket] = None
        self._acked: Dict[str, int] = {}      # shard stem -> max acked seq
        self._manifest_sig: Optional[Tuple[int, int]] = None
        self._next_retry = 0.0
        self.last_error: Optional[str] = None

    # -- connection ---------------------------------------------------------
    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _connect(self) -> bool:
        if self._sock is not None:
            return True
        now = time.monotonic()
        if now < self._next_retry:
            return False
        try:
            sock = socket.create_connection(self.addr, timeout=self.timeout)
            sock.settimeout(self.timeout)
            send_frame(sock, {"type": "hello", "proto": PROTO_VERSION,
                              "run_id": self.run_id, "host": self.host})
            header, _ = recv_frame(sock)
            if header.get("type") != "ack_state":
                raise FrameError(f"expected ack_state, got {header!r}")
            self._acked = {str(k): int(v)
                           for k, v in dict(header.get("acked", {})).items()}
            self._sock = sock
            self._manifest_sig = None     # collector may have restarted
            self.last_error = None
            return True
        except (OSError, ValueError) as e:
            self._drop(e)
            return False

    def _drop(self, err: Optional[BaseException] = None) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        if err is not None:
            self.last_error = f"{type(err).__name__}: {err}"
            self._next_retry = time.monotonic() + self.retry_interval_s

    def close(self) -> None:
        if self._sock is not None:
            try:
                send_frame(self._sock, {"type": "bye"})
            except OSError:
                pass
        self._drop()
        self._next_retry = 0.0

    # -- shipping -----------------------------------------------------------
    def _pending(self):
        """Ring entries newer than the collector's ack, oldest first, so
        a partial publish leaves a resumable prefix."""
        from .store import ProfileStore
        out = []
        for stem, ring in sorted(ProfileStore(self.run_dir).shards().items()):
            for seq, path in ring:
                if seq > self._acked.get(stem, 0):
                    out.append((stem, seq, path))
        out.sort(key=lambda e: (e[1], e[0]))
        return out

    def _ship_one(self, sock, header: Dict, payload: bytes,
                  what: str) -> bool:
        """Send one frame and wait for its ack; on `reject` (checksum or
        length mismatch seen by the collector — a torn read, a corrupt
        wire) re-send ONCE with freshly read bytes."""
        for attempt in (0, 1):
            send_frame(sock, header, payload)
            reply, _ = recv_frame(sock)
            kind = reply.get("type")
            if kind == "ack":
                return True
            if kind == "reject" and attempt == 0:
                continue
            raise FrameError(
                f"collector refused {what}: {reply.get('reason', reply)}")
        return False

    def publish(self) -> Dict[str, int]:
        """Ship every unacked ring entry (and the run manifest when it
        changed).  Returns counters; NEVER raises."""
        stats = {"shipped": 0, "bytes": 0, "pending": 0, "errors": 0}
        if not self._connect():
            stats["errors"] = 1
            stats["pending"] = len(self._pending())
            return stats
        sock = self._sock
        try:
            manifest = os.path.join(self.run_dir, "manifest.json")
            if os.path.exists(manifest):
                st = os.stat(manifest)
                sig = (st.st_mtime_ns, st.st_size)
                if sig != self._manifest_sig:
                    with open(manifest, "rb") as f:
                        doc = f.read()
                    self._ship_one(sock, {"type": "manifest",
                                          "run_id": self.run_id,
                                          "host": self.host}, doc,
                                   "manifest")
                    self._manifest_sig = sig
                    stats["bytes"] += len(doc)
            for stem, seq, path in self._pending():
                try:
                    with open(path, "rb") as f:
                        blob = f.read()
                except FileNotFoundError:
                    continue              # retention beat us to it
                ok = self._ship_one(
                    sock, {"type": "snapshot", "run_id": self.run_id,
                           "host": self.host, "shard": stem, "seq": seq},
                    blob, f"{stem} seq {seq}")
                if not ok:
                    stats["errors"] += 1
                    continue
                self._acked[stem] = max(self._acked.get(stem, 0), seq)
                stats["shipped"] += 1
                stats["bytes"] += len(blob)
        except (OSError, ValueError) as e:
            self._drop(e)
            stats["errors"] += 1
        stats["pending"] = len(self._pending())
        return stats
