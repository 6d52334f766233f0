"""The port's fleet transport and collector against the reference, on the
CPU: the wire bytes, publishers and collectors of either package talking
to each other, the collector's replies to scripted sessions, a dead
collector and a collector restart.  Collectors run in threads of this
process; every socket has its own timeout."""

import contextlib
import importlib
import json
import os
import socket
import struct
import threading
import types

import pytest

PKGS = {name: types.SimpleNamespace(
    name=name, profile=importlib.import_module(f"{name}.profile"),
    transport=importlib.import_module(f"{name}.profile.transport"),
    folding=importlib.import_module(f"{name}.core.folding"))
    for name in ("repro", "repro_torch")}
REF, PORT = PKGS["repro"], PKGS["repro_torch"]
PAIRS = [(a, b) for a in sorted(PKGS) for b in sorted(PKGS)]
TIMEOUT = 10.0

EVENTS = [
    ("app", "runtime", "step", 3_000_000),
    ("app", "runtime", "step", 3_000_000),
    ("app", "io", "load", 1_000_000),
    ("moe", "pthread", "lock", 500_000),
]


@pytest.fixture(autouse=True)
def _reset_host_labels():
    yield
    for P in PKGS.values():
        P.profile.set_host_label(None)


def build_ring(P, run_dir, host, n=3, scale=1.0, label="trainer"):
    """A registered run dir with an n-deep ring written by P as `host`."""
    P.profile.set_host_label(host)
    try:
        P.profile.register_run(str(run_dir), config="fleetcfg", kind="train",
                               label=host)
        store = P.profile.ProfileStore(str(run_dir))
        t = P.folding.fold_event_log(EVENTS).scale_time(scale)
        for _ in range(n):
            store.write_shard(t, label=label)
    finally:
        P.profile.set_host_label(None)
    return store


def tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _dirs, files in os.walk(str(root)):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, str(root))] = fh.read()
    return out


@contextlib.contextmanager
def collecting(P, spool):
    """P's Collector serving on a thread that polls for shutdown every
    20 ms (Collector.start polls every 0.5 s)."""
    col = P.profile.Collector(str(spool), timeout=TIMEOUT)
    t = threading.Thread(target=col._server.serve_forever,
                         kwargs={"poll_interval": 0.02}, daemon=True)
    t.start()
    try:
        yield col
    finally:
        col.shutdown()
        t.join(timeout=TIMEOUT)


def comparable(spool_tree):
    """A spool with each manifest parsed and its jax_version dropped: the
    collector re-registers the run, and the reference's index records its
    jax version where the port's records "" (profile/index.py)."""
    out = {}
    for rel, blob in spool_tree.items():
        if os.path.basename(rel) == "manifest.json":
            doc = json.loads(blob)
            doc.pop("jax_version")
            out[rel] = doc
        else:
            out[rel] = blob
    return out


def publisher(P, port, run_dir, **kw):
    return P.profile.FleetPublisher("127.0.0.1:%d" % port, str(run_dir),
                                    run_id="runX", host="hosta",
                                    timeout=TIMEOUT, **kw)


# ------------------------------------------------------------ the wire ----
FRAMES = [
    ({"type": "hello", "proto": 1, "run_id": "runX", "host": "hosta"}, b""),
    ({"type": "snapshot", "run_id": "r", "host": "h", "shard": "s",
      "seq": 7}, b"x" * 1000),
    ({"type": "bye"}, b""),
    ({"type": "manifest", "run_id": "r", "host": "h"},
     json.dumps({"config": "c", "é": "ü"}).encode()),
]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_are_byte_equal_and_cross_decode(i):
    header, payload = FRAMES[i]
    wire = {}
    for P in PKGS.values():
        a, b = socket.socketpair()
        a.settimeout(TIMEOUT)
        b.settimeout(TIMEOUT)
        try:
            P.transport.send_frame(a, dict(header), payload)
            a.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                c = b.recv(1 << 16)
                if not c:
                    break
                chunks.append(c)
            wire[P.name] = b"".join(chunks)
        finally:
            a.close()
            b.close()
    assert wire["repro_torch"] == wire["repro"]
    # each package decodes the other's bytes to the same (header, payload)
    decoded = {}
    for P in PKGS.values():
        a, b = socket.socketpair()
        b.settimeout(TIMEOUT)
        try:
            other = wire["repro" if P is PORT else "repro_torch"]
            a.sendall(other)
            decoded[P.name] = P.transport.recv_frame(b)
        finally:
            a.close()
            b.close()
    assert decoded["repro_torch"] == decoded["repro"]
    assert decoded["repro"][1] == payload
    assert decoded["repro"][0]["sha256"] == \
        PORT.transport.frame_checksum(payload) if payload else True


BAD_WIRE = {
    "eof_between_frames": b"",
    "eof_mid_frame": struct.pack("!I", 29) + json.dumps(
        {"type": "snapshot", "length": 100}).encode()[:29] + b"only",
    "headerless_garbage": struct.pack("!I", 4) + b"not{",
    "oversized_payload": (lambda h: struct.pack("!I", len(h)) + h)(
        json.dumps({"type": "snapshot", "length": 1 << 30}).encode()),
    "no_type": (lambda h: struct.pack("!I", len(h)) + h)(b'{"a": 1}'),
    "header_too_long": struct.pack("!I", (1 << 20) + 1),
}


@pytest.mark.parametrize("case", sorted(BAD_WIRE))
def test_malformed_wire_raises_the_same(case):
    raised = {}
    for P in PKGS.values():
        a, b = socket.socketpair()
        b.settimeout(TIMEOUT)
        try:
            a.sendall(BAD_WIRE[case])
            a.close()
            try:
                P.transport.recv_frame(b, max_bytes=1 << 20)
                raised[P.name] = None
            except Exception as e:  # noqa: BLE001 — the raise is compared
                raised[P.name] = (type(e).__name__, str(e))
        finally:
            b.close()
    assert raised["repro"] is not None
    assert raised["repro_torch"] == raised["repro"]


def test_protocol_constants_and_addresses_agree():
    R, T = REF.transport, PORT.transport
    assert T.PROTO_VERSION == R.PROTO_VERSION
    assert T.MAX_FRAME_BYTES == R.MAX_FRAME_BYTES
    for blob in (b"", b"abc", bytes(range(256)) * 9):
        assert T.frame_checksum(blob) == R.frame_checksum(blob)
    for addr in ("127.0.0.1:9000", "localhost:1", "no-port", ":9000",
                 "h:notaport"):
        got = []
        for M in (R, T):
            try:
                got.append(M.parse_addr(addr))
            except ValueError as e:
                got.append(("ValueError", str(e)))
        assert got[1] == got[0], addr


# ------------------------------------------- publisher <-> collector ----
@pytest.mark.parametrize("pub_pkg,col_pkg", PAIRS)
def test_cross_package_streams_give_equal_spools(pub_pkg, col_pkg,
                                                 tmp_path):
    """A ring streamed by either package's publisher into either
    package's collector: the same spool, byte for byte, as the
    reference's own pair; a second publish ships nothing, a new ring
    entry ships alone."""
    run = tmp_path / "runA"
    build_ring(REF, run, "hosta", n=3)
    spools, stats = {}, {}
    for name, (pp, cp) in (("pair", (pub_pkg, col_pkg)),
                           ("ref", ("repro", "repro"))):
        spool = tmp_path / f"spool-{name}"
        with collecting(PKGS[cp], str(spool)) as col:
            pub = publisher(PKGS[pp], col.port, run)
            stats[name] = [pub.publish(), pub.publish()]
            pub.close()
        spools[name] = tree(spool)
    assert stats["pair"] == stats["ref"]
    assert stats["pair"][0]["shipped"] == 3
    assert stats["pair"][0]["errors"] == stats["pair"][0]["pending"] == 0
    assert stats["pair"][1]["shipped"] == 0
    assert comparable(spools["pair"]) == comparable(spools["ref"])
    manifest = json.loads(spools["pair"]["runX/manifest.json"])
    assert (manifest["jax_version"] == "") == (col_pkg == "repro_torch")
    local = tree(run)
    for rel, blob in spools["pair"].items():
        if rel.endswith(".xfa.npz"):
            assert local[os.path.basename(rel)] == blob, rel
    assert "runX/manifest.json" in spools["pair"]


@pytest.mark.parametrize("first,second", PAIRS)
def test_collector_restart_resumes_from_ack_state(first, second, tmp_path):
    """A spool written by one package's collector; a restarted collector
    (either package) seeds a FRESH publisher with the acked seqs, so only
    the unacked suffix ships."""
    run, spool = tmp_path / "runA", str(tmp_path / "spool")
    build_ring(PORT, run, "hosta", n=2)
    with collecting(PKGS[first], spool) as col:
        pub = publisher(PKGS[first], col.port, run)
        assert pub.publish()["shipped"] == 2
        pub.close()
    store = build_ring(PORT, run, "hosta", n=1)     # a third ring entry
    with collecting(PKGS[second], spool) as col:
        assert col.ack_state("runX", "hosta") == {
            s: ring[-2][0] for s, ring in store.shards().items()}
        pub = publisher(PKGS[second], col.port, run)
        s = pub.publish()
        pub.close()
    assert s["shipped"] == 1 and s["errors"] == 0, s
    names = [n for n in tree(os.path.join(spool, "runX"))
             if n.endswith(".xfa.npz")]
    assert len(names) == 3


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_dead_collector_publish_returns_and_ring_stays(pkg, tmp_path):
    run = tmp_path / "runA"
    build_ring(PORT, run, "hosta", n=2)
    before = tree(run)
    with collecting(PORT, tmp_path / "spool") as col:
        port = col.port                   # nobody listening after this
    pub = publisher(PKGS[pkg], port, run, retry_interval_s=0.0)
    pub.timeout = 1.0
    stats = pub.publish()                 # must not raise
    assert stats == {"shipped": 0, "bytes": 0, "pending": 2, "errors": 1}
    assert pub.last_error and not pub.connected
    pub.close()
    assert tree(run) == before            # the local ring is untouched


# --------------------------------------------- scripted collector sessions --
def hello(run_id="runX", host="hosta", proto=None):
    return ("send", {"type": "hello", "proto": proto or 1,
                     "run_id": run_id, "host": host}, b"")


def snap(payload, seq=1, shard="rank0", **extra):
    return ("send", {"type": "snapshot", "run_id": "runX", "host": "hosta",
                     "shard": shard, "seq": seq, **extra}, payload)


RECV = ("recv",)
SCRIPTS = {
    "checksum_reject_then_ack": [
        hello(), RECV,
        snap(b"corrupted-on-the-wire", length=21, sha256="0" * 64), RECV,
        snap(b"corrupted-on-the-wire"), RECV,
        snap(b"corrupted-on-the-wire"), RECV,          # dedup
        ("send", {"type": "bye"}, b"")],
    "path_escaping_run_id": [hello(run_id=".."), RECV],
    "path_escaping_host": [hello(host="a/b"), RECV],
    "wrong_protocol": [hello(proto=99), RECV],
    "snapshot_before_hello": [snap(b"x"), RECV],
    "unknown_frame_type": [hello(), RECV,
                           ("send", {"type": "nope"}, b""), RECV],
    "mid_frame_disconnect": [
        hello(), RECV,
        ("raw", (lambda h: struct.pack("!I", len(h)) + h + b"torn")(
            json.dumps({"type": "snapshot", "run_id": "runX",
                        "host": "hosta", "shard": "rank0", "seq": 1,
                        "length": 10_000, "sha256": "0" * 64}).encode()))],
    "two_hosts_same_shard": [
        hello(), RECV, snap(b"host-a-bytes"), RECV,
        ("reconnect",), hello(host="hostb"), RECV,
        ("send", {"type": "snapshot", "run_id": "runX", "host": "hostb",
                  "shard": "rank0", "seq": 1}, b"host-b-bytes-different"),
        RECV],
}


def run_script(P, spool, script):
    replies = []
    with collecting(P, spool) as col:
        T = P.transport

        def connect():
            s = socket.create_connection(("127.0.0.1", col.port),
                                         timeout=TIMEOUT)
            s.settimeout(TIMEOUT)
            return s
        sock = connect()
        try:
            for step in script:
                if step[0] == "send":
                    T.send_frame(sock, dict(step[1]), step[2])
                elif step[0] == "raw":
                    sock.sendall(step[1])
                elif step[0] == "reconnect":
                    sock.close()
                    sock = connect()
                else:
                    replies.append(T.recv_frame(sock))
        finally:
            sock.close()
    return replies, tree(spool)


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_collector_replies_equal_to_scripted_sessions(case, tmp_path):
    out = {P.name: run_script(P, tmp_path / P.name, SCRIPTS[case])
           for P in PKGS.values()}
    assert out["repro_torch"] == out["repro"]
    replies, spool = out["repro"]
    assert all(".tmp" not in p for p in spool), spool
    if case.startswith(("path_escaping", "wrong", "snapshot_before",
                        "unknown")):
        assert replies[-1][0]["type"] == "error"


def test_host_graphs_of_a_cross_streamed_spool(tmp_path):
    """Two hosts, one streamed by each package's publisher into the
    port's collector: the spool reduces, per host and merged, the same
    through both packages' analysis."""
    spool = str(tmp_path / "spool")
    with collecting(PORT, spool) as col:
        for P, host, scale in ((REF, "hosta", 1.0), (PORT, "hostb", 2.0)):
            run = tmp_path / ("local_" + host)
            build_ring(P, run, host, n=2, scale=scale)
            pub = P.profile.FleetPublisher(
                "127.0.0.1:%d" % col.port, str(run), run_id="runX",
                host=host, timeout=TIMEOUT)
            assert pub.publish()["errors"] == 0
            pub.close()
    got = {}
    for name in PKGS:
        an = importlib.import_module(f"{name}.analysis")
        got[name] = json.dumps({h: g.to_json() for h, g in
                                an.host_graphs(spool + "/runX").items()},
                               sort_keys=True)
    assert got["repro_torch"] == got["repro"]
    assert sorted(json.loads(got["repro"])) == ["hosta", "hostb"]


def test_collect_main_serves_and_self_profiles(tmp_path):
    """The port's `collect` body: bound port printed, a ring streamed in,
    its own ingest metrics spooled under _collector at exit."""
    import contextlib
    import io
    import time

    spool = str(tmp_path / "spool")
    run = tmp_path / "runA"
    build_ring(PORT, run, "hosta", n=2)
    out = io.StringIO()
    rc = []

    def serve():
        with contextlib.redirect_stdout(out):
            rc.append(PORT.profile.collect_main(
                spool, host="127.0.0.1", port=0, timeout=TIMEOUT,
                max_frame_bytes=1 << 20, max_seconds=1.5,
                self_profile=True, self_profile_interval_s=60.0))
    t = threading.Thread(target=serve)
    t.start()
    deadline = time.monotonic() + TIMEOUT
    while "listening on" not in out.getvalue():
        assert time.monotonic() < deadline, out.getvalue()
        time.sleep(0.02)
    port = int(out.getvalue().split("listening on ")[1].split()[0]
               .rsplit(":", 1)[1])
    pub = publisher(PORT, port, run)
    stats = pub.publish()
    pub.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and rc == [0]
    assert stats["shipped"] == 2 and stats["errors"] == 0
    files = tree(spool)
    assert any(p.startswith("_collector" + os.sep) for p in files), files
    assert sum(p.startswith("runX" + os.sep + "hosta" + os.sep)
               for p in files) == 2
