"""Diagnosis in the PyTorch port against the reference package, on the CPU.

The port's `repro_torch.analysis` (calibration, the nine detectors,
diagnose, the fleet ranking) and its `profile.diff` / `profile.timeline`
must give the reference's results on the same inputs (the Cross Flow
Graph itself: tests/test_torch_flow_graph.py).  Each case below is a case
of tests/test_diagnose.py, run through both packages:

* in-memory cases build their tables with each package's own FoldedTable
  (or `fold_event_log`) from the same numbers and compare the results'
  `to_json`, field for field, exceptions by type and message;
* on-disk cases write a run dir (rings, manifests, a collector spool) with
  ONE package, the reference or the port, and analyse that same dir with
  both; every case runs once per writer.
"""

import importlib
import json
import os
import types

import numpy as np
import pytest

MS = 1_000_000
EVENTS = [
    ("app", "glibc", "read", 18), ("app", "glibc", "write", 35),
    ("app", "alloc", "malloc", 10), ("moe", "pthread", "lock", 900),
]


def package(name):
    mod = lambda m: importlib.import_module(f"{name}.{m}")   # noqa: E731
    return types.SimpleNamespace(
        name=name, folding=mod("core.folding"), shadow=mod("core.shadow"),
        histogram=mod("core.histogram"), analysis=mod("analysis"),
        profile=mod("profile"), diff=mod("profile.diff"))


REF, PORT = package("repro"), package("repro_torch")
WRITERS = {"ref": REF, "port": PORT}


def dumps(x, root=None):
    s = json.dumps(x, sort_keys=True, default=repr)
    return s.replace(str(root), "<root>") if root is not None else s


def outcome(fn, *a, **kw):
    """The JSON of a call's result, or the exception it raised."""
    try:
        return {"ok": fn(*a, **kw)}
    except Exception as e:  # noqa: BLE001 — the raise is the result
        return {"raises": type(e).__name__, "message": str(e)}


def js(findings):
    return [f.to_json() for f in findings]


# --------------------------------------------------------------- tables ----
def edge(P, count, total_ns, *, child_ns=0, kind=0):
    return P.folding.EdgeStats(count=count, total_ns=total_ns,
                               child_ns=child_ns, min_ns=1,
                               max_ns=max(total_ns, 1), kind=kind)


def table(P, spec):
    """{key: (count, total_ns[, kind[, child_ns]])} -> P's FoldedTable."""
    edges = {}
    for k, v in spec.items():
        count, total = v[0], v[1]
        kind = v[2] if len(v) > 2 else 0
        child = v[3] if len(v) > 3 else 0
        edges[k] = edge(P, count, total, child_ns=child, kind=kind)
    return P.folding.FoldedTable(edges)


def healthy(P, scale=1):
    W = P.shadow.KIND_WAIT
    return table(P, {
        ("app", "runtime", "dispatch"): (100, 90 * MS * scale, 0,
                                         10 * MS * scale),
        ("app", "runtime", "sync"): (100, 10 * MS * scale, W),
        ("app", "glibc", "read"): (500, 30 * MS * scale),
        ("app", "glibc", "write"): (400, 25 * MS * scale),
        ("runtime", "alloc", "malloc"): (200, 5 * MS * scale),
    })


def ctx(P, t, **kw):
    A = P.analysis
    return A.DiagnosisContext(graph=A.FlowGraph.from_folded(t), **kw)


# --------------------------------------------------------- in-memory cases --
MEMORY = {}


def memory(fn):
    MEMORY[fn.__name__] = fn
    return fn


@memory
def wait_dominance(P, tmp):
    W, D = P.shadow.KIND_WAIT, P.analysis.WaitDominance()
    crit = table(P, {("app", "runtime", "dispatch"): (100, 100 * MS),
                     ("app", "runtime", "device_sync"): (100, 900 * MS, W)})
    warn = table(P, {("app", "runtime", "dispatch"): (100, 500 * MS),
                     ("app", "runtime", "device_sync"): (100, 500 * MS, W)})
    tiny = table(P, {("app", "x", "w"): (1, 900, W), ("app", "x", "c"):
                     (1, 100)})
    return [js(D.detect(ctx(P, t))) for t in (crit, warn, tiny,
                                              healthy(P))]


@memory
def hot_edge(P, tmp):
    W, D = P.shadow.KIND_WAIT, P.analysis.HotEdgeConcentration()
    hot = table(P, {("app", "glibc", "read"): (1000, 95 * MS),
                    ("app", "glibc", "write"): (10, 5 * MS)})
    solo = table(P, {("app", "glibc", "read"): (10, 50 * MS)})
    wait = table(P, {("app", "runtime", "sync"): (10, 900 * MS, W),
                     ("app", "runtime", "a"): (10, 3 * MS),
                     ("app", "runtime", "b"): (10, 3 * MS)})
    return [js(D.detect(ctx(P, t))) for t in (hot, solo, wait, healthy(P))]


@memory
def rank_imbalance(P, tmp):
    A = P.analysis
    out = []
    for scales in ((1, 1, 2), (1, 1, 1, 3), (1, 1, 1), (5,)):
        shards = {f"train-r{i}": A.FlowGraph.from_folded(healthy(P, s))
                  for i, s in enumerate(scales)}
        out.append(js(A.RankImbalance().detect(
            ctx(P, healthy(P), shard_graphs=shards))))
    return out


@memory
def call_amplification(P, tmp):
    D = P.analysis.CallAmplification()
    blowup = table(P, {("app", "db", "query"): (10, 10 * MS),
                       ("db", "net", "send"): (100_000, 50 * MS)})
    side = table(P, {("app", "db", "query"): (100_000, 10 * MS),
                     ("cron", "db", "query"): (10, MS),
                     ("db", "net", "send"): (200_000, 50 * MS)})
    floor = table(P, {("app", "db", "query"): (1, MS),
                      ("db", "net", "send"): (500, MS)})
    return [js(D.detect(ctx(P, t))) for t in (blowup, side, floor,
                                              healthy(P))]


def serve_table(P, missed, met, e2e_ms=()):
    t = table(P, {("app", "serve", "prefill_chunk"): (50, 40 * MS),
                  ("serve", "serve", "deadline_miss"): (missed, 0),
                  ("serve", "serve", "deadline_met"): (met, 0)})
    if e2e_ms:
        e = edge(P, len(e2e_ms), int(sum(e2e_ms) * MS))
        e.hist = P.histogram.hist_of([int(ms * MS) for ms in e2e_ms])
        t.edges[("serve", "serve", "e2e")] = e
    return t


@memory
def slo_violation(P, tmp):
    D = P.analysis.SloViolation()
    cases = (serve_table(P, 8, 92, e2e_ms=[10] * 95 + [50] * 5),
             serve_table(P, 2, 98), serve_table(P, 0, 500, e2e_ms=[10] * 20),
             serve_table(P, 1, 3), healthy(P))
    return [js(D.detect(ctx(P, t))) for t in cases]


@memory
def ordering_severity_first(P, tmp):
    W, A = P.shadow.KIND_WAIT, P.analysis
    t = table(P, {("app", "runtime", "sync"): (10, 900 * MS, W),
                  ("app", "runtime", "dispatch"): (10, 100 * MS),
                  ("app", "glibc", "read"): (10, 85 * MS),
                  ("app", "glibc", "write"): (10, 15 * MS)})
    dets = A.builtin_detectors(hot_edge={"warn_share": 0.8,
                                         "crit_share": 0.99})
    return {"names": [d.name for d in A.builtin_detectors()],
            "classes": sorted(A.detector_classes()),
            "findings": js(A.run_detectors(ctx(P, t), dets))}


@memory
def builtin_overrides_reject(P, tmp):
    b = P.analysis.builtin_detectors
    return [outcome(lambda: len(b(**kw))) for kw in (
        {"wait_dominance": {"nope": 1}},
        {"wait_dominanse": {"warn_share": 0.5}},
        {"hot_edge": {"name": "other"}},
        {"wait-dominance": {"warn_share": 0.5}})]


@memory
def calibrate_runs_bands(P, tmp):
    A = P.analysis
    thr = A.calibrate_runs([healthy(P) for _ in range(4)])
    key = ("app", "glibc", "read")
    a, b = healthy(P), healthy(P)
    b.edges[("app", "ckpt", "save")] = edge(P, 5, 10 * MS)
    absent = A.calibrate_runs([a, b])
    return {"bands": thr.to_json(), "absent": absent.to_json(),
            "rel": [thr.rel_threshold(key, "total_ns", 0.25),
                    thr.rel_threshold(("x", "y", "z"), "total_ns", 0.25)],
            "noise": thr.noise_ns(key)}


@memory
def thresholds_json_bytes(P, tmp):
    A = P.analysis
    thr = A.calibrate_runs([healthy(P), healthy(P, 2), healthy(P, 3)],
                           meta={"who": "test"}, k_sigma=2.0, floor=0.1)
    os.makedirs(tmp, exist_ok=True)
    path = thr.save(os.path.join(tmp, "thr.json"))
    with open(path) as f:
        text = f.read()
    back = A.Thresholds.load(path)
    return {"text": text, "round_trip": back.to_json() == thr.to_json(),
            "future": outcome(A.Thresholds.from_json, {"schema": 99})}


def scaled(P, factor_of):
    t = healthy(P)
    for i, k in enumerate(sorted(t.edges)):
        t.edges[k].total_ns = int(t.edges[k].total_ns * factor_of(i))
    return t


@memory
def diff_with_calibrated_bands(P, tmp):
    A, D = P.analysis, P.diff
    runs = [scaled(P, lambda _i, i=i: 0.9 + 0.2 * (i % 2)) for i in range(4)]
    thr = A.calibrate_runs(runs, k_sigma=3.0)
    within = scaled(P, lambda _i: 1.15)
    beyond = scaled(P, lambda _i: 1.8)
    out = []
    for cand in (within, beyond):
        for bands in (None, thr):
            d = D.diff_profiles(healthy(P), cand, threshold=0.10,
                                fields=("total_ns",), thresholds=bands)
            out.append({"json": d.to_json(), "text": d.render(),
                        "regressed": d.has_regressions})
    return out


@memory
def diff_profile_fields(P, tmp):
    F, D = P.folding, P.diff
    base = F.fold_event_log(EVENTS)
    cand = F.fold_event_log(EVENTS * 2 + [("app", "new", "edge", 5_000)])
    cand.edges[("app", "glibc", "write")].total_ns *= 3
    out = {"fields": list(D.DIFF_FIELDS)}
    for kw in ({}, {"flag_added": False}, {"min_count": 3},
               {"fields": ("count", "mean_ns"), "threshold": 0.1}):
        d = D.diff_profiles(base, cand, **kw)
        out[repr(sorted(kw.items()))] = {"json": d.to_json(),
                                         "text": d.render()}
    return out


@memory
def fleet_straggler(P, tmp):
    A, fleet = P.analysis, importlib.import_module(
        f"{P.name}.analysis.fleet")
    hosts = {h: A.FlowGraph.from_folded(healthy(P, s))
             for h, s in (("hosta", 1), ("hostb", 3), ("hostc", 1))}
    return {"straggler": js(A.fleet_straggler_findings(hosts)),
            "balanced": js(A.fleet_straggler_findings(
                {"a": hosts["hosta"], "c": hosts["hostc"]})),
            "outlier": js(fleet.fleet_run_outlier_findings(
                {"r1": 10 * MS, "r2": 11 * MS, "r3": 40 * MS})),
            "stems": [A.stem_host(s, m) for s, m in (
                ("hosta/train-r0", None), ("train-r0", {"host": "h9"}),
                ("serve-box-123", None), ("odd", None))]}


@pytest.mark.parametrize("case", sorted(MEMORY))
def test_in_memory_parity(case, tmp_path):
    fn = MEMORY[case]
    ref = dumps(outcome(fn, REF, str(tmp_path / "r")), tmp_path / "r")
    port = dumps(outcome(fn, PORT, str(tmp_path / "p")), tmp_path / "p")
    assert "raises" not in json.loads(ref), ref
    assert port == ref


# ----------------------------------------------------------- on-disk cases --
def write_ring(P, root, tables, label="t", **store_kw):
    store = P.profile.ProfileStore(str(root), **store_kw)
    for i, t in enumerate(tables, start=1):
        store.write_shard(t, label=label, meta={"step": i})
    return str(root)


def cumulative(P, spec_of, n):
    """n cumulative tables: spec_of(i) for i = 1..n."""
    return [table(P, spec_of(i)) for i in range(1, n + 1)]


def queue_ring(P, root, means):
    W, total, specs = P.shadow.KIND_WAIT, 0, []
    for i, m in enumerate(means, start=1):
        total += int(m)
        specs.append({("serve", "serve", "queue_wait"): (i, total, W),
                      ("app", "serve", "queue_depth"): (10 * i, 30 * i),
                      ("app", "serve", "decode_tick"): (10 * i,
                                                        10 * i * MS)})
    return write_ring(P, root, [table(P, s) for s in specs])


def page_ring(P, root, in_use, depth, capacity=100):
    specs, iu, d = [], 0, 0
    for i, (u, q) in enumerate(zip(in_use, depth), start=1):
        iu, d = iu + int(u), d + int(q)
        specs.append({("app", "serve", "cache_pages_in_use"): (i, iu),
                      ("app", "serve", "cache_pages_capacity"):
                          (i, capacity * i),
                      ("app", "serve", "queue_depth"): (i, d),
                      ("app", "serve", "decode_tick"): (10 * i,
                                                        10 * i * MS)})
    return write_ring(P, root, [table(P, s) for s in specs])


def drift_ring(P, root, deltas):
    tot, tables = 0, []
    for d in deltas:
        tot += d
        tables.append(table(P, {("app", "runtime", "dispatch"): (1, tot)}))
    return write_ring(P, root, tables)


def registered(P, root, t, label="train-r0", config="c", kind="train"):
    P.profile.ProfileStore(str(root)).write_shard(t, label=label)
    P.profile.register_run(str(root), config=config, kind=kind, label=label)
    return str(root)


def timelines_json(A, root, **kw):
    T = importlib.import_module(f"{A.name}.profile.timeline")
    tls = T.build_timelines(str(root), **kw)
    return [{"json": tl.to_json(f), "text": T.render_timeline(tl, fld=f)}
            for tl in tls for f in T.TIMELINE_FIELDS]


def detect_on(A, det, root, baseline=None, thresholds=None):
    """One detector over a run dir through A's own build_context."""
    c = A.analysis.build_context(str(root), baseline_dir=baseline,
                                 thresholds=thresholds)
    return js(det(A).detect(c))


DISK = {}


def disk(write):
    def register(analyse):
        DISK[analyse.__name__] = (write, analyse)
        return analyse
    return register


QUEUE_MEANS = {"grow": [10_000, 25_000, 60_000],
               "flat": [50_000, 52_000, 49_000],
               "down": [80_000, 40_000, 20_000],
               "spike": [10_000, 90_000, 11_000, 30_000]}


@disk(lambda W, root: [queue_ring(W, root / n, m)
                       for n, m in QUEUE_MEANS.items()])
def queue_saturation(A, root):
    return {n: detect_on(A, lambda A: A.analysis.QueueSaturation(), root / n)
            for n in QUEUE_MEANS}


def trimmed_queue_ring(W, root):
    store = W.profile.ProfileStore(
        str(root), retention=W.profile.RetentionPolicy(keep_last=4))
    total = 0
    for i, m in enumerate([10_000, 10_000, 20_000, 40_000, 80_000], 1):
        total += m
        store.write_shard(table(W, {("serve", "serve", "queue_wait"):
                                    (i, total, W.shadow.KIND_WAIT)}),
                          label="t")


@disk(trimmed_queue_ring)
def queue_saturation_trimmed_head(A, root):
    return {"findings": detect_on(
        A, lambda A: A.analysis.QueueSaturation(), root),
        "timelines": timelines_json(A, root)}


PAGE_CASES = {"crit": ([70, 88, 96], [2, 5, 9]),
              "warn": ([60, 75, 85], [1, 2, 4]),
              "draining": ([96, 96, 96], [9, 4, 1]),
              "free": ([20, 30, 40], [2, 5, 9])}


def page_rings(W, root):
    for n, (iu, d) in PAGE_CASES.items():
        page_ring(W, root / n, iu, d)
    write_ring(W, root / "nocap", cumulative(W, lambda i: {
        ("app", "serve", "cache_pages_in_use"): (i, 90 * i),
        ("app", "serve", "queue_depth"): (i, 3 * i * i)}, 3))


@disk(page_rings)
def cache_pressure(A, root):
    return {n: detect_on(A, lambda A: A.analysis.CachePressure(), root / n)
            for n in list(PAGE_CASES) + ["nocap"]}


DRIFT = {"base": [MS, MS, MS], "trend": [MS + MS // 5, MS + MS // 2, 2 * MS],
         "offset": [2 * MS] * 3, "same": [MS] * 3,
         "slow": [MS, MS + 3 * MS // 100, MS + 6 * MS // 100],
         "steep": [MS, 2 * MS, 4 * MS]}


@disk(lambda W, root: [drift_ring(W, root / n, d) for n, d in DRIFT.items()])
def drift_regression(A, root):
    an = A.analysis
    band = an.Thresholds(bands={"app -> runtime.dispatch": {
        "total_ns": an.EdgeBand(n=8, mean=MS, std=MS / 10, p95=1.2 * MS,
                                lo=0.8 * MS, hi=1.2 * MS)}})
    base = str(root / "base")
    out = {n: detect_on(A, lambda A: A.analysis.DriftRegression(),
                        root / n, baseline=base)
           for n in ("trend", "offset", "same")}
    loose = lambda A: A.analysis.DriftRegression(warn_growth=0.01)  # noqa
    out["slow"] = detect_on(A, loose, root / "slow", baseline=base)
    out["slow_banded"] = detect_on(A, loose, root / "slow", baseline=base,
                                   thresholds=band)
    T = importlib.import_module(f"{A.name}.profile.timeline")
    pairs = T.pair_timelines(T.build_timelines(str(root / "steep")),
                             T.build_timelines(base))
    out["timeline_diff"] = [{"json": td.to_json(),
                             "text": T.render_timeline_diff(td)}
                            for td in pairs]
    return out


@disk(lambda W, root: write_ring(W, root, [healthy(W, 1), healthy(W, 2),
                                           healthy(W, 3)]))
def every_builtin_silent_on_healthy(A, root):
    c = A.analysis.build_context(str(root))
    return {d.name: js(d.detect(c)) for d in A.analysis.builtin_detectors()}


def wait_heavy(W, root):
    K = W.shadow.KIND_WAIT
    write_ring(W, root / "run", [table(W, {
        ("app", "runtime", "sync"): (10, 500 * MS, K),
        ("app", "runtime", "dispatch"): (10, 500 * MS)})])
    for name, doc in (("crit", {"wait-dominance": {"crit_share": 0.4}}),
                      ("relaxed", {"wait_dominance": {"warn_share": 0.9}}),
                      ("warn06", {"wait-dominance": {"warn_share": 0.6}}),
                      ("list", [1, 2]),
                      ("scalar", {"wait-dominance": 0.5}),
                      ("unknown", {"wait-dominance": {"bogus": 1}})):
        (root / f"{name}.json").write_text(json.dumps(doc))


@disk(wait_heavy)
def detector_config(A, root):
    an, run = A.analysis, str(root / "run")
    cfg = lambda n: str(root / f"{n}.json")   # noqa: E731
    out = {n: outcome(lambda n=n: an.diagnose(
        run, detector_config=cfg(n)).to_json())
        for n in ("crit", "relaxed", "warn06", "unknown")}
    out["default"] = an.diagnose(run).to_json()
    out["load"] = {n: outcome(an.load_detector_config, cfg(n))
                   for n in ("crit", "list", "scalar")}
    out["override_wins"] = an.diagnose(
        run, detector_config=cfg("warn06"),
        overrides={"wait-dominance": {"warn_share": 0.3}}).to_json()
    out["spellings_merge"] = an.diagnose(
        run, detector_config=cfg("warn06"),
        overrides={"wait_dominance": {"crit_share": 0.95}}).to_json()
    return out


def calibration_rings(W, root):
    write_ring(W, root / "restart", [healthy(W, 3), healthy(W, 1)])
    write_ring(W, root / "trimmed", [healthy(W, i) for i in range(1, 7)],
               retention=W.profile.RetentionPolicy(keep_last=3))


@disk(calibration_rings)
def calibrate_ring(A, root):
    out = {}
    for n in ("restart", "trimmed"):
        thr = A.analysis.calibrate_ring(
            A.profile.build_timelines(str(root / n)), meta={"run": n})
        path = thr.save(str(root / f"{n}-{A.name}.json"))
        with open(path) as f:
            out[n] = f.read()
    return out


def pathological(W, root):
    K = W.shadow.KIND_WAIT
    registered(W, root / "bad", table(W, {
        ("app", "runtime", "dispatch"): (100, 100 * MS),
        ("app", "runtime", "device_sync"): (100, 900 * MS, K)}))
    for name in ("r1", "r2"):
        registered(W, root / "reg" / name, healthy(W), label=name,
                   config="cfg")


@disk(pathological)
def diagnose_end_to_end(A, root):
    an, bad = A.analysis, str(root / "bad")
    d = an.diagnose(bad)
    reg = str(root / "reg")
    return {"json": d.to_json(), "text": d.render(),
            "counts": d.counts(), "worst": d.worst(),
            "fail": [d.should_fail(x) for x in ("crit", "warn", "none",
                                                None)],
            "select": [outcome(lambda r=r: an.diagnose(reg, run=r).to_json())
                       for r in ("r2", "r*", "nope")],
            "direct": an.diagnose(str(root / "reg" / "r1")).to_json(),
            "resolve": outcome(an.resolve_run_dir, reg, "r1")}


@disk(lambda W, root: [drift_ring(W, root / "base", DRIFT["base"]),
                       drift_ring(W, root / "cand", DRIFT["steep"])])
def diagnose_with_baseline(A, root):
    an = A.analysis
    return {"clean": an.diagnose(str(root / "cand")).to_json(),
            "drift": an.diagnose(str(root / "cand"),
                                 baseline=str(root / "base")).to_json()}


def fleet_spool(W, root):
    """Two hosts of one run streamed into W's collector (hostb a 3x
    straggler), as tests/test_fleet.py builds it."""
    P = W.profile
    events = [("app", "runtime", "step", 3_000_000)] * 2 + [
        ("app", "io", "load", 1_000_000), ("moe", "pthread", "lock", 500_000)]
    with P.Collector(str(root / "spool"), timeout=10.0) as col:
        for host, scale in (("hosta", 1.0), ("hostb", 3.0)):
            run = str(root / ("local_" + host))
            P.set_host_label(host)
            try:
                P.register_run(run, config="fleetcfg", kind="train",
                               label=host)
                t = W.folding.fold_event_log(events).scale_time(scale)
                for _ in range(2):
                    P.ProfileStore(run).write_shard(t, label="trainer")
            finally:
                P.set_host_label(None)
            pub = P.FleetPublisher("127.0.0.1:%d" % col.port, run,
                                   run_id="runX", host=host, timeout=10.0)
            assert pub.publish()["errors"] == 0
            pub.close()


@disk(fleet_spool)
def diagnose_fleet(A, root):
    an, spool = A.analysis, str(root / "spool")
    fd = an.diagnose_fleet(spool)
    return {"json": fd.to_json(), "text": fd.render(),
            "ranked": [[r, f.to_json()] for r, f in fd.ranked()],
            "one_run": an.diagnose_fleet(
                os.path.join(spool, "runX")).to_json(),
            "config": an.diagnose_fleet(spool, config="fleetcfg").to_json(),
            "no_config": outcome(an.diagnose_fleet, spool, config="nope")}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("case", sorted(DISK))
def test_on_disk_parity(case, writer, tmp_path):
    write, analyse = DISK[case]
    write(WRITERS[writer], tmp_path)
    ref = dumps(outcome(analyse, REF, tmp_path), tmp_path)
    port = dumps(outcome(analyse, PORT, tmp_path), tmp_path)
    assert "raises" not in json.loads(ref), ref
    assert port == ref


# ------------------------------------------- runs written by the port ----
@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """A smoke serve run (profile ring refreshed every 2 ticks) and a 2-step
    Trainer run (a shard every step), both through the port on the CPU."""
    import dataclasses

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ServeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.serving import ServingEngine

    root = tmp_path_factory.mktemp("port-runs")
    cfg = dataclasses.replace(get_smoke("tinyllama_1_1b"), n_layers=2,
                              vocab=256)
    model = build_model(cfg, device="cpu")
    engine = ServingEngine(model, model.init(0), ServeConfig(
        max_batch=2, max_seq_len=64, profile_dir=str(root / "serve"),
        profile_label="serve-0", profile_interval_ticks=2))
    rng = np.random.default_rng(0)
    for n in (5, 9, 3):
        engine.submit(rng.integers(0, 256, n).astype(np.int32), 4)
    engine.run_until_drained()
    Trainer(model, TrainConfig(ckpt_interval=0),
            CheckpointManager(str(root / "ckpt")),
            profile_dir=str(root / "train"), profile_interval=1).run(
        0, SyntheticLMData(cfg, 2, 16), n_steps=2, resume=False)
    return root


@pytest.mark.parametrize("run", ["serve", "train"])
def test_port_written_runs_diagnose_equal(port_runs, run):
    """diagnose, the context's graph and timelines of a real port run are
    the same through both packages, and deterministic."""
    out = {}
    for A in (REF, PORT):
        d = A.analysis.diagnose(str(port_runs / run))
        c = A.analysis.build_context(str(port_runs / run))
        out[A.name] = dumps({"diagnosis": d.to_json(),
                             "graph": c.graph.to_json(),
                             "timelines": timelines_json(A, port_runs / run)})
    assert out["repro_torch"] == out["repro"]
    doc = json.loads(out["repro"])
    assert doc["diagnosis"]["manifest"]["kind"] == run
    assert doc["diagnosis"]["graph"]["rings"] >= 1
    assert len(doc["timelines"]) >= 1
    if run == "serve":
        keys = {tuple(e["key"]) for e in doc["graph"]["edges"]}
        assert {("serve", "serve", "queue_wait"),
                ("app", "serve", "queue_depth")} <= keys
