"""CLI for the profile store.

    python -m repro_torch.profile report    RUN_DIR_OR_SNAPSHOT... [--component app]
    python -m repro_torch.profile merge     SHARD_OR_DIR... -o merged.xfa.npz
    python -m repro_torch.profile diff      BASELINE CANDIDATE [--threshold 0.25]
                                            [--thresholds bands.json]
    python -m repro_torch.profile query     ROOT [--config C] [--mesh 4x2]
    python -m repro_torch.profile gc        ROOT... [--keep-last N] [--dry-run]
    python -m repro_torch.profile timeline  RUN_DIR [--field total_ns] [--shard S]
    python -m repro_torch.profile calibrate INPUT... -o bands.json [--mode ring]
    python -m repro_torch.profile diagnose  ROOT [--run GLOB] [--baseline B]
                                            [--thresholds T] [--detector-config C]
                                            [--fail-on warn|crit]
                                            [--fleet [--config GLOB]]
    python -m repro_torch.profile collect   --spool DIR [--bind H] [--port P]
                                            [--max-seconds S]

`report` reduces every given shard/dir into one profile and renders the
paper's component/API views + flow matrix.  `merge` persists that reduction.
`diff` compares two profiles and exits 1 when any per-edge regression
exceeds its threshold (global, or per-edge calibrated bands via
`--thresholds`) — wire it into CI as a perf gate.  `query` filters the
run registry by metadata predicates (exit 1 when nothing matches, so it
composes in shell pipelines).  `gc` applies a retention policy offline;
`timeline` renders per-edge count/total_ns/self_ns trajectories across
one run's sequence-numbered snapshots.  `calibrate` fits per-edge noise
bands from baseline profiles (or ring intervals) into a thresholds JSON;
`diagnose` runs the cross-flow detectors (repro_torch.analysis) over a run and
exits 1 when findings reach `--fail-on` severity; `--detector-config`
loads per-detector constructor parameters from JSON so projects tune
thresholds without code (unknown keys exit 2); `diagnose --fleet`
diagnoses every run matching `--config`/`--run`, adds cross-host
fleet-straggler and cross-run outlier findings, and ranks the union.
`collect` runs the fleet collector daemon: publishers (trainers/servers
launched with `--xfa-collector HOST:PORT`) stream snapshot-ring deltas
to it and it spools them under `SPOOL/<run_id>/<host>/` — a registry
root the other subcommands read directly (see docs/fleet.md).

Full reference with flag tables, worked examples and the exit-code
contract (0 ok / 1 gated finding / 2 usage error): docs/cli.md.  This
CLI has the reference CLI's (`python -m repro.profile`) subcommands,
flags, output and exit codes, so that page covers both.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

from ..core.views import (api_view_by_caller, component_view,
                          render_flow_matrix, render_percentiles,
                          render_sampling)
from .diff import DIFF_FIELDS, diff_profiles
from .index import RunRegistry, kv_pair
from .snapshot import ProfileSnapshot
from .store import (ProfileStore, RetentionPolicy, find_run_dirs,
                    load_profile)
from .timeline import (TIMELINE_FIELDS, build_timelines, pair_timelines,
                       render_timeline, render_timeline_diff)


def _load_many(paths: List[str]) -> ProfileSnapshot:
    snaps = [load_profile(p) for p in paths]
    return snaps[0] if len(snaps) == 1 else ProfileSnapshot.merge(snaps)


def _cmd_report(args: argparse.Namespace) -> int:
    snap = _load_many(args.inputs)
    folded = snap.to_folded()
    if args.json:
        print(json.dumps({"meta": snap.meta, **folded.to_json()}, indent=1))
        return 0
    total = folded.total_ns()
    print(f"profile: {len(folded)} edges, {total/1e9:.3f}s folded total, "
          f"group={folded.group!r}")
    if snap.meta:
        print(f"meta: {json.dumps(snap.meta, sort_keys=True)}")
    for comp in args.component:
        print()
        print(component_view(folded, comp).render(args.top))
        print()
        print(api_view_by_caller(folded, comp).render(args.top))
    pct = render_percentiles(folded, max_rows=args.top)
    if pct:   # only schema-v2+ profiles carry histograms
        print()
        print(pct)
    smp = render_sampling(folded, max_rows=args.top)
    if smp:   # only schema-v3 profiles carry governor sampling rates
        print()
        print(smp)
    print()
    print(render_flow_matrix(folded))
    return 0


def _cmd_merge(args: argparse.Namespace) -> int:
    merged = _load_many(args.inputs)
    # mark the output as a merge product even for a single input, so a
    # store reduce over a dir containing it knows to skip it
    merged.meta.setdefault("merged_from",
                           [str(merged.meta.get("label", "?"))])
    merged.save(args.output)
    print(f"merged {len(args.inputs)} input(s), {len(merged)} edges "
          f"-> {args.output}")
    return 0


def _cmd_diff(args: argparse.Namespace) -> int:
    base = load_profile(args.baseline).to_folded()
    cand = load_profile(args.candidate).to_folded()
    bands = None
    if args.thresholds:
        from ..analysis import Thresholds
        bands = Thresholds.load(args.thresholds)
    d = diff_profiles(base, cand, threshold=args.threshold,
                      fields=tuple(args.fields.split(",")),
                      min_count=args.min_count,
                      min_total_ns=args.min_total_ns,
                      flag_added=not args.no_flag_added,
                      thresholds=bands)
    if args.json:
        print(json.dumps(d.to_json(), indent=1))
    else:
        print(d.render())
    return 1 if d.has_regressions else 0


def _cmd_query(args: argparse.Namespace) -> int:
    where = dict(args.where)
    since = None
    if args.max_age_s:
        import time
        since = time.time() - args.max_age_s
    runs = RunRegistry(args.root).query(
        config=args.config, arch=args.arch, mesh=args.mesh or None,
        label=args.label, kind=args.kind, since=since, where=where)
    if args.json:
        print(json.dumps([{**m.to_json(), "run_dir": m.run_dir}
                          for m in runs], indent=1))
    else:
        for m in runs:
            line = m.describe()
            if args.verbose:
                store = ProfileStore(m.run_dir)
                line += (f" shards={len(store)} "
                         f"snapshots={len(store.snapshot_paths())}")
            print(line)
        if not runs:
            print("no runs matched", file=sys.stderr)
    return 0 if runs else 1


def _cmd_gc(args: argparse.Namespace) -> int:
    import os
    policy = RetentionPolicy(keep_last=args.keep_last,
                             max_age_s=args.max_age_s,
                             max_bytes=args.max_bytes)
    report = {}
    for root in args.roots:
        for run_dir in find_run_dirs(root):
            # size up the victims BEFORE enforcement so both the dry-run
            # preview and the real pass report the bytes at stake
            victims = policy.doomed(run_dir)
            sized = []
            for v in victims:
                try:
                    sized.append({"path": v, "bytes": os.path.getsize(v)})
                except OSError:        # lost a race with another writer
                    sized.append({"path": v, "bytes": 0})
            if not args.dry_run:
                # delete exactly the sized set: re-running the policy scan
                # could doom additional files (age crossing the bound,
                # concurrent ring growth) that the report would then miss
                for e in sized:
                    try:
                        os.unlink(e["path"])
                    except FileNotFoundError:
                        pass
            if sized:
                report[run_dir] = sized
    verb = "would delete" if args.dry_run else "deleted"
    total = sum(e["bytes"] for v in report.values() for e in v)
    if args.json:
        print(json.dumps({"dry_run": args.dry_run, "deleted": report,
                          "bytes": total}, indent=1))
    else:
        n = sum(len(v) for v in report.values())
        print(f"gc: {verb} {n} snapshot(s) ({total/1024:.1f} KiB) "
              f"across {len(report)} run dir(s)")
        tag = "DRY" if args.dry_run else "DEL"
        for run_dir, victims in sorted(report.items()):
            for e in victims:
                print(f"  {tag}  {e['path']} ({e['bytes']} B)")
    return 0


def _cmd_timeline(args: argparse.Namespace) -> int:
    tls = build_timelines(args.run_dir, shard=args.shard,
                          min_len=args.min_snapshots)
    if not tls:
        print(f"no shard under {args.run_dir!r} has "
              f">= {args.min_snapshots} snapshots", file=sys.stderr)
        return 1
    if args.diff:
        # cross-run drift: align two runs' rings by sequence index and
        # render per-edge delta-of-deltas (see timeline.TimelineDiff)
        other = build_timelines(args.diff, shard=args.shard,
                                min_len=args.min_snapshots)
        if not other:
            print(f"no shard under {args.diff!r} has "
                  f">= {args.min_snapshots} snapshots", file=sys.stderr)
            return 1
        pairs = pair_timelines(tls, other)
        if len(tls) != len(other):
            print(f"warning: {len(tls)} vs {len(other)} shards; diffing "
                  f"the {len(pairs)} stem-ordered pair(s)", file=sys.stderr)
        if not any(len(td) for td in pairs):
            print("no pair of shards shares sequence numbers; the rings "
                  "were retained past each other", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps([td.to_json(args.field) for td in pairs],
                             indent=1))
            return 0
        for td in pairs:
            print(render_timeline_diff(td, fld=args.field, top=args.top,
                                       edge=args.edge))
            print()
        return 0
    if args.json:
        print(json.dumps([tl.to_json(args.field) for tl in tls], indent=1))
        return 0
    for tl in tls:
        print(render_timeline(tl, fld=args.field, top=args.top,
                              edge=args.edge))
        print()
    return 0


def _cmd_calibrate(args: argparse.Namespace) -> int:
    from ..analysis import calibrate_ring, calibrate_runs
    fields = tuple(args.fields.split(","))
    if args.mode == "ring":
        tls = []
        for root in args.inputs:
            tls.extend(build_timelines(root, min_len=2))
        if not tls:
            print("no input holds a ring with >= 2 snapshots",
                  file=sys.stderr)
            return 1
        thr = calibrate_ring(tls, fields=fields, k_sigma=args.k_sigma,
                             floor=args.floor,
                             meta={"inputs": list(map(str, args.inputs))})
    else:
        tables = [load_profile(p).to_folded() for p in args.inputs]
        thr = calibrate_runs(tables, fields=fields, k_sigma=args.k_sigma,
                             floor=args.floor,
                             meta={"inputs": list(map(str, args.inputs))})
    thr.save(args.output)
    print(f"calibrated {len(thr)} edge band(s) from {len(args.inputs)} "
          f"input(s) ({thr.meta['mode']} mode) -> {args.output}")
    return 0


def _cmd_diagnose(args: argparse.Namespace) -> int:
    from ..analysis import diagnose, diagnose_fleet
    try:
        if args.fleet:
            if args.baseline:
                raise ValueError("--baseline does not apply to --fleet "
                                 "(cross-run comparison is built in)")
            diag = diagnose_fleet(args.root, config=args.config,
                                  run=args.run,
                                  thresholds_path=args.thresholds,
                                  detector_config=args.detector_config)
        else:
            if args.config:
                raise ValueError("--config selects runs for --fleet; use "
                                 "--run to pick the single run to diagnose")
            diag = diagnose(args.root, run=args.run, baseline=args.baseline,
                            thresholds_path=args.thresholds,
                            detector_config=args.detector_config)
    except (FileNotFoundError, LookupError, ValueError) as e:
        # bad inputs (missing run, ambiguous --run, corrupt/unsupported
        # --thresholds json, unknown --detector-config keys) are usage
        # errors: exit 2, never 1 — exit 1 is reserved for real findings
        # under --fail-on
        print(f"diagnose: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({**diag.to_json(), "fail_on": args.fail_on,
                          "failed": diag.should_fail(args.fail_on)},
                         indent=1))
    else:
        print(diag.render(top=args.top))
    return 1 if diag.should_fail(args.fail_on) else 0


def _cmd_collect(args: argparse.Namespace) -> int:
    from .collector import collect_main
    return collect_main(args.spool, host=args.bind, port=args.port,
                        timeout=args.timeout,
                        max_frame_bytes=args.max_frame_bytes,
                        max_seconds=args.max_seconds,
                        self_profile=not args.no_self_profile,
                        self_profile_interval_s=args.self_profile_interval_s)


def build_parser() -> argparse.ArgumentParser:
    """The full CLI parser — separate from main() so tooling can
    enumerate every subcommand and flag without spawning processes."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profile",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    rep = sub.add_parser("report", help="render merged profile views")
    rep.add_argument("inputs", nargs="+",
                     help="snapshot files and/or shard directories")
    rep.add_argument("--component", nargs="*", default=["app"],
                     help="components to render views for")
    rep.add_argument("--top", type=int, default=20)
    rep.add_argument("--json", action="store_true")
    rep.set_defaults(fn=_cmd_report)

    mrg = sub.add_parser("merge", help="reduce shards into one snapshot")
    mrg.add_argument("inputs", nargs="+")
    mrg.add_argument("-o", "--output", required=True)
    mrg.set_defaults(fn=_cmd_merge)

    dif = sub.add_parser("diff", help="flag per-edge regressions")
    dif.add_argument("baseline")
    dif.add_argument("candidate")
    dif.add_argument("--threshold", type=float, default=0.25,
                     help="relative growth beyond which an edge is flagged")
    dif.add_argument("--fields", default="total_ns,self_ns,count",
                     help=f"comma list from {DIFF_FIELDS}")
    dif.add_argument("--min-count", type=int, default=1)
    dif.add_argument("--min-total-ns", type=int, default=0)
    dif.add_argument("--no-flag-added", action="store_true",
                     help="do not fail the gate on significant NEW edges")
    dif.add_argument("--thresholds", metavar="BANDS_JSON",
                     help="per-edge calibrated noise bands (from the "
                          "`calibrate` subcommand); --threshold stays the "
                          "fallback for uncalibrated edges")
    dif.add_argument("--json", action="store_true")
    dif.set_defaults(fn=_cmd_diff)

    qry = sub.add_parser("query", help="filter the run registry by metadata")
    qry.add_argument("root", help="registry root (tree of run dirs)")
    qry.add_argument("--config", help="config name (fnmatch glob ok)")
    qry.add_argument("--arch", help="model arch/family (glob ok)")
    qry.add_argument("--mesh", default="", help="mesh shape, e.g. 4x2")
    qry.add_argument("--label", help="run label (glob ok)")
    qry.add_argument("--kind", help="train | serve (glob ok)")
    qry.add_argument("--max-age-s", type=float, default=0.0,
                     help="only runs started within the last S seconds")
    qry.add_argument("--where", action="append", default=[], type=kv_pair,
                     metavar="KEY=VALUE",
                     help="match a manifest field or free-form meta key")
    qry.add_argument("-v", "--verbose", action="store_true",
                     help="also count each run's shards/snapshots")
    qry.add_argument("--json", action="store_true")
    qry.set_defaults(fn=_cmd_query)

    gcp = sub.add_parser("gc", help="apply a retention policy offline")
    gcp.add_argument("roots", nargs="+",
                     help="run dirs or registry roots (recursed)")
    gcp.add_argument("--keep-last", type=int, default=8,
                     help="ring length kept per shard (0: unbounded)")
    gcp.add_argument("--max-age-s", type=float, default=0.0,
                     help="delete snapshots older than S seconds")
    gcp.add_argument("--max-bytes", type=int, default=0,
                     help="per-run-dir snapshot byte budget")
    gcp.add_argument("-n", "--dry-run", action="store_true")
    gcp.add_argument("--json", action="store_true")
    gcp.set_defaults(fn=_cmd_gc)

    tml = sub.add_parser("timeline",
                         help="per-edge deltas across a shard's snapshots")
    tml.add_argument("run_dir")
    tml.add_argument("--diff", metavar="OTHER_RUN_DIR",
                     help="second run of the same config: align rings by "
                          "sequence index, render per-edge delta-of-deltas")
    tml.add_argument("--field", default="total_ns",
                     help=f"one of {TIMELINE_FIELDS}")
    tml.add_argument("--shard", help="substring filter on shard stems")
    tml.add_argument("--edge", help="substring filter on edge keys")
    tml.add_argument("--top", type=int, default=12)
    tml.add_argument("--min-snapshots", type=int, default=2,
                     help="skip shards with fewer ring entries")
    tml.add_argument("--json", action="store_true")
    tml.set_defaults(fn=_cmd_timeline)

    cal = sub.add_parser("calibrate",
                         help="fit per-edge noise bands -> thresholds json")
    cal.add_argument("inputs", nargs="+",
                     help="runs mode: one profile (snapshot/run dir) per "
                          "sample; ring mode: run dirs whose ring "
                          "intervals are the samples")
    cal.add_argument("-o", "--output", required=True)
    cal.add_argument("--mode", choices=("runs", "ring"), default="runs")
    cal.add_argument("--fields", default="count,total_ns,self_ns,mean_ns",
                     help=f"comma list from {DIFF_FIELDS}")
    cal.add_argument("--k-sigma", type=float, default=3.0,
                     help="band width: allowed growth = k*std/mean")
    cal.add_argument("--floor", type=float, default=0.05,
                     help="minimum relative threshold even for "
                          "zero-variance edges")
    cal.set_defaults(fn=_cmd_calibrate)

    dia = sub.add_parser("diagnose",
                         help="run cross-flow detectors over one run "
                              "(or a whole fleet with --fleet)")
    dia.add_argument("root", help="a run dir, or a registry root "
                                  "(then select with --run)")
    dia.add_argument("--run", help="run-id/label/config glob under ROOT "
                                   "(must match exactly one run; with "
                                   "--fleet, selects every match)")
    dia.add_argument("--fleet", action="store_true",
                     help="diagnose EVERY matching run, add cross-host "
                          "fleet-straggler and cross-run outlier findings, "
                          "rank the union; JSON output groups findings by "
                          "(severity, detector, host)")
    dia.add_argument("--config", help="with --fleet: config-name glob "
                                      "selecting which runs to include")
    dia.add_argument("--baseline", metavar="RUN",
                     help="baseline run dir or registry glob: enables the "
                          "cross-run drift-regression detector")
    dia.add_argument("--thresholds", metavar="BANDS_JSON",
                     help="calibrated noise bands; detectors use them as "
                          "per-edge noise floors")
    dia.add_argument("--detector-config", metavar="CONFIG_JSON",
                     help="per-detector constructor parameters, e.g. "
                          '{"wait-dominance": {"warn_share": 0.5}} — '
                          "tune thresholds without code; unknown detector "
                          "names or parameters exit 2")
    dia.add_argument("--fail-on", choices=("none", "warn", "crit"),
                     default="none",
                     help="exit 1 when any finding is at/above this "
                          "severity (CI gate); default: always exit 0")
    dia.add_argument("--top", type=int, default=50,
                     help="max findings rendered in text mode")
    dia.add_argument("--json", action="store_true")
    dia.set_defaults(fn=_cmd_diagnose)

    col = sub.add_parser("collect",
                         help="run the fleet collector daemon (spool "
                              "snapshot deltas shipped by publishers)")
    col.add_argument("--spool", required=True,
                     help="spool root: SPOOL/<run_id>/<host>/<shard>."
                          "seq<N>.xfa.npz — a registry root that query/"
                          "merge/diagnose understand directly")
    col.add_argument("--bind", default="127.0.0.1",
                     help="interface to listen on")
    col.add_argument("--port", type=int, default=0,
                     help="TCP port (0: ephemeral; the bound port is "
                          "printed on startup)")
    col.add_argument("--timeout", type=float, default=30.0,
                     help="per-socket-operation timeout in seconds")
    col.add_argument("--max-frame-bytes", type=int,
                     default=256 * 1024 * 1024,
                     help="reject frames with larger payloads")
    col.add_argument("--max-seconds", type=float, default=0.0,
                     help="exit after S seconds (0: serve until "
                          "SIGINT/SIGTERM) — CI lanes use this")
    col.add_argument("--no-self-profile", action="store_true",
                     help="do not spool the collector's own ingest "
                          "metrics into SPOOL/_collector")
    col.add_argument("--self-profile-interval-s", type=float, default=30.0,
                     help="seconds between self-metric snapshots")
    col.set_defaults(fn=_cmd_collect)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
