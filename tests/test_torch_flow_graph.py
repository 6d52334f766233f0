"""The Cross Flow Graph in the PyTorch port against the reference
package, on the CPU: `repro_torch.analysis.FlowGraph` and its projections
on the cases of tests/test_flow_graph.py.  Each table is built with each
package's own FoldedTable (or `fold_event_log`) from the same numbers, the
hypothesis-drawn tables of the reference test replaced by tables drawn
from numpy's generator at fixed seeds; the graphs must agree field for
field (`to_json`, totals, adjacency, percentiles).  Run dirs are written
by ONE package and projected by both, once per writer.
"""

import importlib
import json
import types

import numpy as np
import pytest

EVENTS = [
    ("app", "glibc", "read", 18), ("app", "glibc", "write", 35),
    ("app", "alloc", "malloc", 10), ("moe", "pthread", "lock", 900),
]


def package(name):
    mod = lambda m: importlib.import_module(f"{name}.{m}")   # noqa: E731
    return types.SimpleNamespace(
        name=name, folding=mod("core.folding"), shadow=mod("core.shadow"),
        analysis=mod("analysis"), profile=mod("profile"))


REF, PORT = package("repro"), package("repro_torch")
WRITERS = {"ref": REF, "port": PORT}


def dumps(x, root=None):
    s = json.dumps(x, sort_keys=True, default=repr)
    return s.replace(str(root), "<root>") if root is not None else s


def random_table(P, seed):
    """A FoldedTable drawn from numpy's generator at `seed`: count-0
    (declared) edges, wait kind, child time and metric dicts included —
    the envelope tests/test_flow_graph.py draws with hypothesis."""
    rng = np.random.default_rng(seed)
    callers, comps = ("app", "moe", "optimizer"), ("glibc", "alloc",
                                                   "pthread")
    apis = ("read", "write", "malloc", "lock")
    edges = {}
    for _ in range(int(rng.integers(0, 13))):
        key = (str(rng.choice(callers)), str(rng.choice(comps)),
               str(rng.choice(apis)))
        kind = int(rng.integers(0, 2))
        metrics = {str(m): float(rng.uniform(0, 1e6))
                   for m in ("flops", "bytes") if rng.random() < 0.3}
        count = int(rng.integers(0, 51))
        if count == 0:
            edges[key] = P.folding.EdgeStats(kind=kind, metrics=metrics)
            continue
        total = int(rng.integers(1, 10**6))
        edges[key] = P.folding.EdgeStats(
            count=count, total_ns=total,
            child_ns=int(rng.integers(0, total + 1)),
            min_ns=int(rng.integers(1, total + 1)),
            max_ns=int(rng.integers(1, total + 1)), kind=kind,
            metrics=metrics)
    return P.folding.FoldedTable(edges)


def handmade(P, which):
    F, S = P.folding, P.shadow
    if which == "empty":
        return F.FoldedTable()
    if which == "events":
        return F.fold_event_log(EVENTS)
    if which == "wait-heavy":
        return F.FoldedTable({
            ("app", "runtime", "dispatch"): F.EdgeStats(
                count=10, total_ns=100, child_ns=40, min_ns=1, max_ns=20),
            ("app", "runtime", "sync"): F.EdgeStats(
                count=10, total_ns=900, min_ns=1, max_ns=100,
                kind=S.KIND_WAIT),
            ("runtime", "alloc", "malloc"): F.EdgeStats(
                count=3, total_ns=40, min_ns=1, max_ns=30),
        })
    return F.FoldedTable({            # count-0 edge + metrics
        ("app", "moe", "dispatch"): F.EdgeStats(
            kind=S.KIND_CALL, metrics={"flops": 0.0}),
        ("app", "glibc", "read"): F.EdgeStats(
            count=2, total_ns=7, min_ns=3, max_ns=4,
            metrics={"bytes": 128.0}),
    })


def graph_view(P, t):
    """Everything a FlowGraph exposes, for a field-for-field comparison."""
    A, S = P.analysis, P.shadow
    g = A.FlowGraph.from_columns(t.to_columns())
    return {
        "json": g.to_json(),
        "total_ns": g.total_ns(), "total_count": g.total_count(),
        "components": g.components(),
        "adjacency": {c: {"in": [list(e.key) for e in g.in_edges(c)],
                          "in_wait": [list(e.key) for e in
                                      g.in_edges(c, kind=S.KIND_WAIT)],
                          "out": [list(e.key) for e in g.out_edges(c)],
                          "succ": g.successors(c)}
                      for c in g.components()},
        "percentiles": {A.edge_label(k): [e.mean_ns, e.p50_ns, e.p95_ns,
                                          e.p99_ns, e.jitter_ns]
                        for k, e in sorted(g.edges.items())},
        "equal_from_folded": g.to_json() == A.FlowGraph.from_folded(
            t).to_json(),
    }


# --------------------------------------------------------- in-memory cases --
MEMORY = {}


def memory(fn):
    MEMORY[fn.__name__] = fn
    return fn


for _which in ("empty", "events", "wait-heavy", "count0"):
    MEMORY[f"graph_{_which}"] = \
        lambda P, w=_which: graph_view(P, handmade(P, w))
for _seed in range(8):
    MEMORY[f"graph_random_{_seed}"] = \
        lambda P, s=_seed: graph_view(P, random_table(P, s))


@memory
def columns_projection(P):
    t = P.folding.fold_event_log(EVENTS)
    t.edges[("app", "glibc", "read")].metrics = {"flops": 2.0}
    cols = t.to_columns()
    mask = np.array([k[1] == "glibc" for k in cols.keys])
    sub = cols.select(mask)
    by = {f: {k: [int(i) for i in v] for k, v in cols.group_rows(f).items()}
          for f in ("component", "caller")}
    return {"sub": [list(k) for k in sub.keys],
            "sub_total": int(sub.total_ns.sum()),
            "metric_names": list(sub.metric_names),
            "metric_values": sub.metric_values.tolist(),
            "empty": len(cols.select([])), "groups": by}


@memory
def two_hop_adjacency(P):
    t = P.folding.fold_event_log([("app", "db", "query", 10),
                                  ("db", "net", "send", 1)])
    return graph_view(P, t)


@memory
def edge_label(P):
    return P.analysis.edge_label(("app", "glibc", "read"))


@pytest.mark.parametrize("case", sorted(MEMORY))
def test_graph_parity(case):
    ref, port = dumps(MEMORY[case](REF)), dumps(MEMORY[case](PORT))
    assert port == ref


# ----------------------------------------------------------- run dirs ----
def projections(W, root):
    F = W.folding
    store = W.profile.ProfileStore(str(root / "run"))
    store.write_shard(F.fold_event_log(EVENTS), label="train-r0")
    store.write_shard(F.fold_event_log(EVENTS), label="train-r0")
    store.write_shard(F.fold_event_log(EVENTS * 3), label="train-r1")
    W.profile.ProfileStore(str(root / "merged")).write_shard(
        F.fold_event_log(EVENTS), label="t")
    W.profile.ProfileSnapshot.from_folded(
        F.fold_event_log(EVENTS * 9), meta={"merged_from": ["x"]}).save(
        str(root / "merged" / "merged-out.xfa.npz"))


def shard_and_run_graphs(A, root):
    an = A.analysis
    return {"shards": {s: g.to_json() for s, g in
                       an.shard_graphs(str(root / "run")).items()},
            "run": an.run_graph(str(root / "run")).to_json(),
            "run_meta": an.run_graph(str(root / "run")).meta,
            "merged_excluded": sorted(an.shard_graphs(str(root / "merged"))),
            "hosts": {h: g.to_json() for h, g in
                      an.host_graphs(str(root / "run")).items()}}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_run_projections_parity(writer, tmp_path):
    projections(WRITERS[writer], tmp_path)
    ref = dumps(shard_and_run_graphs(REF, tmp_path), tmp_path)
    port = dumps(shard_and_run_graphs(PORT, tmp_path), tmp_path)
    assert port == ref
    assert len(json.loads(ref)["shards"]) == 2
