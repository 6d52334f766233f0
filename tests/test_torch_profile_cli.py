"""The port's profile CLI (`python -m repro_torch.profile`) against the
reference CLI (`python -m repro.profile`), on the CPU.

* The parsers have the same subcommands and long flags (docs/cli.md
  covers both).
* Each package folds the same event lists to the same FoldedTable and
  snapshot bytes, and reads the checked-in tests/data/*.xfa.npz the same.
* Every subcommand on the cases of tests/test_profile_cli_e2e.py (one
  test per subcommand and writer): each package's `main(argv)` runs in
  process on its own copy of one input tree, written by the reference
  or by the port, with the same relative argv; stdout and stderr (the
  `prog` name and the copy's root normalised), exit codes and every file
  left in the tree (merge output, thresholds JSON, gc deletions) must be
  equal.
* The port's `collect` daemon as a real `python -m` process, fed by the
  reference's publisher.

Real serve and train runs through both CLIs: tests/test_torch_profile_runs.py.
"""

import contextlib
import glob
import importlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
DATA = os.path.join(ROOT, "tests", "data")
CLI = {name: importlib.import_module(f"{name}.profile.__main__")
       for name in ("repro", "repro_torch")}
PROFILE = {name: importlib.import_module(f"{name}.profile")
           for name in ("repro", "repro_torch")}
FOLDING = {name: importlib.import_module(f"{name}.core.folding")
           for name in ("repro", "repro_torch")}

EVENTS = [
    ("app", "glibc", "read", 18), ("app", "glibc", "write", 35),
    ("app", "alloc", "malloc", 10), ("moe", "pthread", "lock", 900),
]


def run_main(name, argv):
    """(exit code, stdout, stderr) of one package's CLI main(argv), with
    the port's prog name spelled as the reference's.  Usage text is not
    wrapped (COLUMNS), so the longer prog name moves no line break."""
    out, err = io.StringIO(), io.StringIO()
    columns = os.environ.get("COLUMNS")
    os.environ["COLUMNS"] = "1000"
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = CLI[name].main(list(argv))
        except SystemExit as e:
            rc = e.code
        except Exception as e:  # noqa: BLE001 — the raise is the result
            rc = f"{type(e).__name__}: {e}"
        finally:
            if columns is None:
                del os.environ["COLUMNS"]
            else:
                os.environ["COLUMNS"] = columns
    norm = lambda s: s.replace("repro_torch.profile", "repro.profile")  # noqa
    return rc, norm(out.getvalue()), norm(err.getvalue())


# --------------------------------------------------------------- parser ----
def parser_surface(ap):
    subs = next(a for a in ap._actions if a.dest == "cmd")
    return {cmd: sorted((tuple(o for o in a.option_strings), a.dest,
                         repr(a.default), repr(a.choices), a.nargs)
                        for a in sp._actions)
            for cmd, sp in subs.choices.items()}


def test_parsers_have_the_same_subcommands_and_flags():
    ref = parser_surface(CLI["repro"].build_parser())
    port = parser_surface(CLI["repro_torch"].build_parser())
    assert sorted(ref) == ["calibrate", "collect", "diagnose", "diff", "gc",
                           "merge", "query", "report", "timeline"]
    assert port == ref
    assert CLI["repro_torch"].build_parser().prog == \
        "python -m repro_torch.profile"


# ------------------------------------------------- folds and snapshots ----
FOLD_CASES = {
    "events": EVENTS,
    "repeated": EVENTS * 7,
    "one": [("app", "x", "y", 1)],
    "wide": [(f"c{i % 5}", f"m{i % 7}", f"api{i % 3}", 10 + i * i)
             for i in range(200)],
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_event_log_and_snapshot_bytes_equal(case, tmp_path):
    blobs, docs = {}, {}
    for name in FOLDING:
        t = FOLDING[name].fold_event_log(FOLD_CASES[case])
        docs[name] = json.dumps(t.to_json(), sort_keys=True)
        p = str(tmp_path / f"{name}.xfa.npz")
        PROFILE[name].ProfileSnapshot.from_folded(
            t, meta={"case": case}).save(p)
        with open(p, "rb") as f:
            blobs[name] = f.read()
    assert docs["repro_torch"] == docs["repro"]
    assert blobs["repro_torch"] == blobs["repro"]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    DATA, "*.xfa.npz"))), ids=os.path.basename)
def test_checked_in_snapshots_load_equal(path):
    docs = {}
    for name in PROFILE:
        snap = PROFILE[name].ProfileSnapshot.load(path)
        docs[name] = json.dumps({"meta": snap.meta,
                                 **snap.to_folded().to_json()},
                                sort_keys=True)
    assert docs["repro_torch"] == docs["repro"]


# ------------------------------------------------------- input trees ----
def registry(P, F, root):
    """The e2e registry: 'train' (3-deep ring, 4x2 mesh) + 'serve', plus
    snapshots and bands files the diff/calibrate cases read."""
    store = P.ProfileStore(str(root / "train"))
    for i in range(1, 4):
        store.write_shard(F.fold_event_log(EVENTS * i), label="train-r0",
                          meta={"step": i})
    P.register_run(str(root / "train"), config="tinyllama_1_1b",
                   arch="dense", mesh_shape="4x2", label="train-r0",
                   kind="train")
    P.ProfileStore(str(root / "serve")).write_shard(F.fold_event_log(EVENTS),
                                                    label="serve-0")
    P.register_run(str(root / "serve"), config="qwen3_14b", arch="dense",
                   mesh_shape=(8,), label="serve-0", kind="serve")
    other = P.ProfileStore(str(root / "other"))
    for i in range(1, 4):
        other.write_shard(F.fold_event_log(EVENTS * (i + i // 2)),
                          label="train-r0")
    t = F.fold_event_log(EVENTS)
    P.ProfileSnapshot.from_folded(t).save(str(root / "base.xfa.npz"))
    for i in (1, 2, 3):
        P.ProfileSnapshot.from_folded(F.fold_event_log(EVENTS * i)).save(
            str(root / f"run{i}.xfa.npz"))
    t.edges[("app", "glibc", "write")].total_ns *= 3
    P.ProfileSnapshot.from_folded(t).save(str(root / "slow.xfa.npz"))
    os.makedirs(root / "data")
    for f in glob.glob(os.path.join(DATA, "*")):
        shutil.copy(f, root / "data")
    (root / "bad.json").write_text("{not json")
    (root / "future.json").write_text(json.dumps({"schema": 99}))
    (root / "relaxed.json").write_text(json.dumps(
        {"wait-dominance": {"warn_share": 0.95, "crit_share": 0.99}}))
    (root / "bogus.json").write_text(json.dumps(
        {"wait-dominance": {"bogus": 1}}))
    (root / "nodet.json").write_text(json.dumps(
        {"not-a-detector": {"warn_share": 0.5}}))
    diag = root / "diag"
    bad = F.FoldedTable({
        ("app", "runtime", "dispatch"): F.EdgeStats(
            count=100, total_ns=100_000_000, min_ns=1, max_ns=2_000_000),
        ("app", "runtime", "device_sync"): F.EdgeStats(
            count=100, total_ns=900_000_000, min_ns=1, max_ns=9_000_000,
            kind=1)})
    for name, table in (("bad", bad), ("good", F.fold_event_log(EVENTS))):
        P.ProfileStore(str(diag / name)).write_shard(table, label="train-r0")
        P.register_run(str(diag / name), config="cfg", kind="train",
                       label="train-r0")
    spool = root / "spool"
    with P.Collector(str(spool), timeout=10.0) as col:
        for host, scale in (("hosta", 1.0), ("hostb", 3.0)):
            run = str(root / ("local_" + host))
            P.set_host_label(host)
            try:
                P.register_run(run, config="fleetcfg", kind="train",
                               label=host)
                for _ in range(2):
                    P.ProfileStore(run).write_shard(
                        F.fold_event_log(EVENTS * 1000).scale_time(scale),
                        label="trainer")
            finally:
                P.set_host_label(None)
            pub = P.FleetPublisher("127.0.0.1:%d" % col.port, run,
                                   run_id="runX", host=host, timeout=10.0)
            assert pub.publish()["errors"] == 0
            pub.close()


CASES = {
    "report_text": ["report", "train"],
    "report_json": ["report", "train", "--json"],
    "report_two": ["report", "train", "serve", "--component", "app", "moe",
                   "--top", "3"],
    "report_missing": ["report", "nope"],
    "report_golden": ["report", "data/golden_v1.xfa.npz",
                      "data/golden_v2.xfa.npz", "data/golden_v3.xfa.npz"],
    "report_ci_baseline_json": ["report", "data/ci_baseline.xfa.npz",
                                "--json"],
    "merge": ["merge", "train", "serve", "-o", "merged.xfa.npz"],
    "merge_one": ["merge", "train", "-o", "m1.xfa.npz"],
    "merge_no_output": ["merge", "train"],
    "diff_clean": ["diff", "base.xfa.npz", "base.xfa.npz", "--threshold",
                   "0.5"],
    "diff_regressed": ["diff", "base.xfa.npz", "slow.xfa.npz",
                       "--threshold", "0.5"],
    "diff_run_dir": ["diff", "base.xfa.npz", "train", "--threshold", "0.5"],
    "diff_json_fields": ["diff", "base.xfa.npz", "train", "--json",
                         "--fields", "count,mean_ns", "--min-count", "2",
                         "--no-flag-added"],
    "diff_thresholds": ["diff", "data/ci_baseline.xfa.npz",
                        "data/ci_baseline.xfa.npz", "--thresholds",
                        "data/ci_thresholds.json"],
    "diff_thresholds_json": ["diff", "base.xfa.npz", "slow.xfa.npz",
                             "--thresholds", "data/ci_thresholds.json",
                             "--json"],
    "query_filters": ["query", ".", "--config", "tinyllama_1_1b", "--mesh",
                      "4x2", "--label", "train-*"],
    "query_none": ["query", ".", "--label", "nope"],
    "query_json": ["query", ".", "--kind", "serve", "--json"],
    "query_where_verbose": ["query", ".", "--where", "arch=dense", "-v"],
    "query_malformed_where": ["query", ".", "--where", "archdense"],
    "gc_keep_last": ["gc", ".", "--keep-last", "1"],
    "gc_dry_json": ["gc", ".", "--keep-last", "1", "--dry-run", "--json"],
    "gc_dry_text": ["gc", "train", "serve", "--keep-last", "1", "-n"],
    "gc_bytes": ["gc", ".", "--max-bytes", "1"],
    "timeline_count": ["timeline", "train", "--field", "count"],
    "timeline_json": ["timeline", "train", "--json", "--field", "count"],
    "timeline_default_json": ["timeline", "train", "--json"],
    "timeline_empty": ["timeline", "serve"],
    "timeline_filters": ["timeline", "train", "--edge", "glibc", "--top",
                         "2", "--field", "self_ns"],
    "timeline_diff_json": ["timeline", "train", "--diff", "other", "--json"],
    "timeline_diff_text": ["timeline", "train", "--diff", "other"],
    "timeline_diff_empty": ["timeline", "train", "--diff", "serve"],
    "calibrate_runs": ["calibrate", "run1.xfa.npz", "run2.xfa.npz",
                       "run3.xfa.npz", "-o", "thr.json"],
    "calibrate_ring": ["calibrate", "train", "-o", "ring.json", "--mode",
                       "ring", "--k-sigma", "2", "--floor", "0.1"],
    "calibrate_empty": ["calibrate", "nope", "-o", "x.json", "--mode",
                        "ring"],
    "calibrate_bad_mode": ["calibrate", "train", "-o", "x.json", "--mode",
                           "nope"],
    "diagnose_text": ["diagnose", "diag/bad"],
    "diagnose_fail_crit": ["diagnose", "diag/bad", "--fail-on", "crit"],
    "diagnose_fail_warn_good": ["diagnose", "diag/good", "--fail-on",
                                "warn"],
    "diagnose_fail_bad_choice": ["diagnose", "diag/bad", "--fail-on",
                                 "nope"],
    "diagnose_corrupt_thresholds": ["diagnose", "diag/bad", "--thresholds",
                                    "bad.json", "--fail-on", "crit"],
    "diagnose_future_thresholds": ["diagnose", "diag/bad", "--thresholds",
                                   "future.json"],
    "diagnose_relaxed_config": ["diagnose", "diag/bad", "--fail-on", "crit",
                                "--detector-config", "relaxed.json"],
    "diagnose_bogus_config": ["diagnose", "diag/bad", "--detector-config",
                              "bogus.json"],
    "diagnose_unknown_detector": ["diagnose", "diag/bad",
                                  "--detector-config", "nodet.json"],
    "diagnose_corrupt_config": ["diagnose", "diag/bad", "--detector-config",
                                "bad.json"],
    "diagnose_json": ["diagnose", "diag/bad", "--json", "--fail-on", "crit"],
    "diagnose_run_selection": ["diagnose", "diag", "--run", "good"],
    "diagnose_ambiguous": ["diagnose", "diag", "--run", "*d*"],
    "diagnose_missing": ["diagnose", "void"],
    "diagnose_baseline": ["diagnose", "diag/bad", "--baseline", "diag/good",
                          "--json"],
    "diagnose_top": ["diagnose", "diag/bad", "--top", "1"],
    "diagnose_fleet": ["diagnose", "spool", "--fleet"],
    "diagnose_fleet_json": ["diagnose", "spool", "--fleet", "--json",
                            "--config", "fleetcfg"],
    "diagnose_fleet_one_run": ["diagnose", "spool/runX", "--fleet"],
    "diagnose_fleet_no_match": ["diagnose", "spool", "--fleet", "--config",
                                "nope"],
    "diagnose_config_without_fleet": ["diagnose", "diag", "--config", "x"],
    "diagnose_fleet_with_baseline": ["diagnose", "spool", "--fleet",
                                     "--baseline", "diag/good"],
    "no_subcommand": [],
}


@pytest.fixture(scope="module", params=["repro", "repro_torch"])
def input_tree(request, tmp_path_factory):
    """The input tree, written once per module by one package."""
    root = tmp_path_factory.mktemp(f"tree-{request.param}")
    registry(PROFILE[request.param], FOLDING[request.param], root)
    return root


def copy_tree(src, dst):
    shutil.copytree(src, dst, copy_function=shutil.copy2)
    return dst


def tree_files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


#: the cases by subcommand (the usage error without one on its own)
GROUPS = {}
for _case, _argv in sorted(CASES.items()):
    GROUPS.setdefault(_argv[0] if _argv else "usage", []).append(_case)


def run_case(case, input_tree, root, monkeypatch):
    """Both CLIs on their own copy of the tree, with the same argv."""
    got = {}
    for name in CLI:
        copy = copy_tree(input_tree, root / name)
        monkeypatch.chdir(copy)
        rc, out, err = run_main(name, CASES[case])
        real = os.path.realpath(copy)
        got[name] = {"rc": rc,
                     "out": out.replace(real, "<root>").replace(
                         str(copy), "<root>"),
                     "err": err.replace(real, "<root>").replace(
                         str(copy), "<root>"),
                     "files": tree_files(copy)}
    return got["repro"], got["repro_torch"]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_every_subcommand_gives_equal_output(group, input_tree, tmp_path,
                                            monkeypatch):
    for case in GROUPS[group]:
        ref, port = run_case(case, input_tree, tmp_path / case, monkeypatch)
        assert (port["rc"], port["out"], port["err"]) == \
            (ref["rc"], ref["out"], ref["err"]), case
        assert sorted(port["files"]) == sorted(ref["files"]), case
        for rel in ref["files"]:
            assert port["files"][rel] == ref["files"][rel], (case, rel)
        # an in-process raise is a traceback and exit 1 from `python -m`
        assert isinstance(ref["rc"], str) or ref["rc"] in (0, 1, 2), \
            (case, ref)
        if ref["rc"] == 0 and "--json" in CASES[case]:
            json.loads(ref["out"])


def nojax_env(tmp_path):
    """PYTHONPATH whose `jax` cannot be imported: a port process that
    reached for jax would fail."""
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('jax is not installed here')\n")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path / "nojax"), SRC]))


def test_python_m_collect_takes_a_reference_publisher(tmp_path):
    """`python -m repro_torch.profile collect` as a process: it prints its
    bound port, spools what the reference's publisher ships, and stops on
    SIGTERM with exit 0."""
    from repro.core.folding import fold_event_log
    from repro.profile import (FleetPublisher, ProfileStore, register_run,
                               set_host_label)

    run, spool = str(tmp_path / "runA"), str(tmp_path / "spool")
    set_host_label("hosta")
    try:
        register_run(run, config="fleetcfg", kind="train", label="hosta")
        for i in (1, 2):
            ProfileStore(run).write_shard(fold_event_log(EVENTS * i),
                                          label="trainer")
    finally:
        set_host_label(None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.profile", "collect", "--spool",
         spool, "--port", "0", "--max-seconds", "60", "--timeout", "10",
         "--no-self-profile"], env=nojax_env(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        assert m, line + proc.stderr.read()
        pub = FleetPublisher(f"127.0.0.1:{m.group(1)}", run, run_id="runX",
                             host="hosta", timeout=10.0)
        stats = pub.publish()
        pub.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert "collector stopped" in out
    assert stats["shipped"] == 2 and stats["errors"] == 0
    spooled = sorted(os.listdir(os.path.join(spool, "runX", "hosta")))
    local = sorted(f for f in os.listdir(run) if f.endswith(".xfa.npz"))
    assert spooled == local
