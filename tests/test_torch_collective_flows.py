"""XFA's L3 collective flows in the port against the JAX package, on the
CPU: the port's copy of the HLO parser (`repro_torch/core/hlo_flows.py`)
and the recorder of `repro_torch/parallel/mesh.py`.

The JAX side compiles two programs in ONE subprocess with 8 host devices
and meshes of Auto axes (as tests/test_torch_parallel.py builds them):
the reference's a2a MoE layer and the smoke phi3.5-moe's loss gradient,
at (2, 2), and hands their optimized HLO text back.  The port records
its collectives in one gloo world of 4 ranks at (2, 2)
(`torch_mesh_worlds.flows`): one call of each kind, then the smoke
phi3.5-moe's second Trainer step.

Byte counts are exact integers and wire bytes follow the ring model
exactly, so everything here is held to equality.
"""

import collections
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import torch_mesh_worlds as worlds
from repro.core import hlo_analysis as ref_analysis
from repro.core import hlo_flows as ref_flows
from repro.core.folding import FoldedTable as RefFoldedTable
from repro.core.session import KNOWN_COMPONENTS as REF_KNOWN
from repro.core.session import XFAReport as RefReport
from repro_torch.configs import get_smoke
from repro_torch.core import hlo_flows
from repro_torch.core.session import KNOWN_COMPONENTS, XFASession
from repro_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"data": 2, "model": 2}

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_smoke
    from repro.data.pipeline import SyntheticLMData
    from repro.models import build_model
    from repro.models import moe as moe_mod
    from repro.models.layers import Runtime
    from repro.parallel.axes import runtime_mesh

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = jax.sharding.Mesh(devs, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
    cfg = get_smoke("phi3_5_moe_42b")
    model = build_model(cfg, impl="ref")
    params = model.init(jax.random.key(0))
    layer = jax.tree_util.tree_map(lambda a: a[0],
                                   params["stack_moe"]["stack"])
    x = jnp.zeros((4, 16, cfg.d_model), jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLMData(cfg, 4, 16, seed=3).generate(0).items()}
    rt = Runtime(cfg=cfg)
    with runtime_mesh(mesh):
        a2a = jax.jit(lambda p, x: moe_mod.moe(p, x, rt, None,
                                               mode="a2a")[0])
        grad = jax.jit(jax.grad(
            lambda p: model.loss_fn(p, batch, model.table())[0]))
        texts = {"a2a": a2a.lower(layer, x).compile().as_text(),
                 "grad": grad.lower(params).compile().as_text()}
    for name, text in texts.items():
        with open(os.path.join(sys.argv[1], name + ".hlo"), "w") as f:
            f.write(text)
    print("OK")
""")

#: HLO whose operands carry inline types (the older text form): every
#: collective kind, iota and explicit replica groups, an async
#: all-gather, operands defined in the module and operands that are not,
#: and a `broadcast`, which in HLO is a shape op, not a collective
TYPED_HLO = textwrap.dedent("""
    HloModule typed, entry_computation_layout={(f32[8,128]{1,0}, bf16[4,64]{1,0})->f32[8,128]{1,0}}

    ENTRY %main.10 (p0: f32[8,128], p1: bf16[4,64]) -> f32[8,128] {
      %p0 = f32[8,128]{1,0} parameter(0)
      %p1 = bf16[4,64]{1,0} parameter(1)
      %all-reduce.1 = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %p0), channel_id=1, replica_groups={{0,1},{2,3}}, use_global_device_ids=true, to_apply=%add, metadata={op_name="jit(f)/jit(main)/attention/dot_general"}
      %all-gather.2 = bf16[8,64]{1,0} all-gather(bf16[4,64]{1,0} %p1), channel_id=2, replica_groups=[2,2]<=[2,2]T(1,0), dimensions={0}, use_global_device_ids=true, metadata={op_name="jit(f)/jit(main)/mlp/w_up"}
      %all-gather-start.3 = (bf16[4,64]{1,0}, bf16[16,64]{1,0}) all-gather-start(bf16[4,64]{1,0} %p1), channel_id=3, replica_groups=[1,4]<=[4], dimensions={0}, metadata={op_name="jit(f)/transpose(jvp(moe))/gather"}
      %all-gather-done.3 = bf16[16,64]{1,0} all-gather-done((bf16[4,64]{1,0}, bf16[16,64]{1,0}) %all-gather-start.3)
      %reduce-scatter.4 = f32[4,128]{1,0} reduce-scatter(f32[8,128]{1,0} %p0), channel_id=4, replica_groups=[2,2]<=[4], dimensions={0}, to_apply=%add, metadata={op_name="jit(f)/grads/psum_scatter"}
      %all-to-all.5 = (f32[4,128]{1,0}, f32[4,128]{1,0}) all-to-all(f32[4,128]{1,0} %a, f32[4,128]{1,0} %b), channel_id=5, replica_groups={{0,1},{2,3}}, metadata={op_name="jit(f)/moe/moe_a2a_fwd/all_to_all"}
      %collective-permute.6 = f32[8,128]{1,0} collective-permute(f32[8,128]{1,0} %p0), channel_id=6, source_target_pairs={{0,1},{1,2},{2,3},{3,0}}, metadata={op_name="jit(f)/pipeline/ppermute"}
      %broadcast.7 = f32[8,128]{1,0} broadcast(f32[] %c), dimensions={}
      ROOT %add.8 = f32[8,128]{1,0} add(f32[8,128]{1,0} %all-reduce.1, f32[8,128]{1,0} %collective-permute.6)
    }
""")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the JAX programs' HLO texts, the port ranks' results)."""
    d = str(tmp_path_factory.mktemp("flows"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, d],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    procs = worlds.start_world("flows", 4, d)
    try:
        worlds.join(procs, d, "flows")
        _, err = jax_proc.communicate(timeout=worlds.JOIN_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    texts = {}
    for name in ("a2a", "grad"):
        with open(os.path.join(d, f"{name}.hlo")) as f:
            texts[name] = f.read()
    ranks = [torch.load(os.path.join(d, f"flows-rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    return texts, ranks


def _key(f):
    return (f.kind, f.component, f.axis, f.wire_bytes)


# -------------------------------------------------------------- parser ----
def test_known_components_are_the_references():
    assert KNOWN_COMPONENTS == REF_KNOWN


def test_parser_equals_the_reference_on_typed_operands():
    got = hlo_flows.parse_collective_flows(TYPED_HLO, KNOWN_COMPONENTS, AXES)
    want = ref_flows.parse_collective_flows(TYPED_HLO, REF_KNOWN, AXES)
    assert [dataclasses.asdict(f) for f in got] == \
        [dataclasses.asdict(f) for f in want]
    assert [f.kind for f in got] == [
        "all-reduce", "all-gather", "all-gather", "reduce-scatter",
        "all-to-all", "collective-permute"]
    assert [f.input_bytes for f in got] == [4096, 512, 512, 4096, 4096,
                                            4096]
    got_s = hlo_flows.CollectiveSummary.build(got)
    want_s = ref_flows.CollectiveSummary.build(want)
    assert (got_s.by_component, got_s.by_kind, got_s.by_axis,
            got_s.total_wire_bytes) == (want_s.by_component, want_s.by_kind,
                                        want_s.by_axis,
                                        want_s.total_wire_bytes)
    assert hlo_flows.find_redundant_gathers(got) == \
        ref_flows.find_redundant_gathers(want)


@pytest.mark.parametrize("program", ["a2a", "grad"])
def test_parser_reads_the_bytes_hlo_analysis_reads(run, program):
    """Optimized HLO carries no operand types: the port takes each
    operand's bytes from its definition, as the reference's
    `hlo_analysis` does, so every flow's wire bytes are its."""
    text = run[0][program]
    got = hlo_flows.parse_collective_flows(text, KNOWN_COMPONENTS, AXES)
    costs = ref_analysis.analyze_module(text, REF_KNOWN, AXES)
    want = [(k, c, a, w) for k, c, a, w, _ in costs.collectives]
    assert collections.Counter(map(_key, got)) == collections.Counter(want)
    assert all(f.input_bytes > 0 for f in got)


def test_reference_reads_zero_operand_bytes(run):
    """The reference's parser takes the input bytes from the operand text,
    untyped in optimized HLO: it reads 0 for every collective of both
    programs, so its all-to-all and all-reduce wire bytes are 0.  The
    port reads the a2a program's all-to-all operands at E x C_loc x d x 4
    bytes (E 8, C_loc 8, d 128, f32)."""
    a2a, grad = run[0]["a2a"], run[0]["grad"]
    for text in (a2a, grad):
        ref = ref_flows.parse_collective_flows(text, REF_KNOWN, AXES)
        assert ref and all(f.input_bytes == 0 for f in ref)
        assert all(f.wire_bytes == 0 for f in ref
                   if f.kind in ("all-to-all", "all-reduce"))
    ref_grad = ref_flows.parse_collective_flows(grad, REF_KNOWN, AXES)
    assert any(f.kind == "all-reduce" for f in ref_grad)
    got = hlo_flows.parse_collective_flows(a2a, KNOWN_COMPONENTS, AXES)
    a2as = [f for f in got if f.kind == "all-to-all"]
    assert len(a2as) == 2
    assert all(f.input_bytes == 8 * 8 * 128 * 4 and f.component == "moe"
               and f.axis == "model" for f in a2as)


def test_attach_hlo_summarises_the_parsed_flows(run):
    text = run[0]["a2a"]
    sess = XFASession()
    sess.attach_hlo(text, AXES)
    costs = ref_analysis.analyze_module(text, REF_KNOWN, AXES)
    got = sess.report().to_json()["collectives"]
    assert got["by_kind"] == pytest.approx(costs.by_kind_wire)
    assert got["total_wire_bytes"] == pytest.approx(costs.wire_bytes)


# ------------------------------------------------------------ recorder ----
def _ring(f) -> float:
    """The ring model, written out again."""
    n = f["group_size"]
    if n == 1:
        return 0.0
    if f["kind"] == "all-gather":
        return (n - 1) / n * f["output_bytes"]
    if f["kind"] == "all-reduce":
        return 2 * (n - 1) / n * f["input_bytes"]
    if f["kind"] == "all-to-all":
        return (n - 1) / n * f["input_bytes"]
    return float(f["input_bytes"])


def test_recorder_records_each_kind(run):
    """One call of each kind at (2, 2): the reference's kind names, this
    rank's bytes, the group's size and row-major stride, the axis named,
    the open scope's component; an all-reduce over two axes is one flow
    an axis; nothing outside the window."""
    for rank, r in enumerate(run[1]):
        d = r["direct"]
        rows = [(f["kind"], f["axis"], f["input_bytes"], f["output_bytes"],
                 f["group_size"], f["group_stride"]) for f in d["flows"]]
        assert rows[:6] == [
            ("all-reduce", "data", 12, 12, 2, 2),
            ("all-reduce", "model", 12, 12, 2, 1),
            ("all-gather", "model", 8, 16, 2, 1),
            ("all-to-all", "model", 16, 16, 2, 1),
            ("broadcast", "data", 20, 20, 2, 2),
            ("all-reduce", "data", 16, 16, 2, 2)]
        permutes = sorted(rows[6:])
        assert permutes == [("collective-permute", "model", 0, 24, 2, 1),
                            ("collective-permute", "model", 24, 0, 2, 1)]
        assert {(f["component"], f["op_name"]) for f in d["flows"]} == \
            {("collective", "collective")}
        assert [f["wire_bytes"] for f in d["flows"]] == \
            [_ring(f) for f in d["flows"]]
        assert collections.Counter(f["kind"] for f in d["flows"]) == \
            mesh_lib.flow_kind_counts(d["counts"])
        assert not d["armed_after"]
        # chunk j of model rank i's [0, 1, 2, 3] + 10 x global rank
        row, me = divmod(rank, 2)
        src = [2 * row, 2 * row + 1]
        assert d["a2a"].tolist() == [2 * me + 10 * src[0],
                                     2 * me + 1 + 10 * src[0],
                                     2 * me + 10 * src[1],
                                     2 * me + 1 + 10 * src[1]]


def test_recorded_step_counts_equal_collective_counts(run):
    for r in run[1]:
        s = r["step"]
        assert s["step"] == 1
        assert collections.Counter(f["kind"] for f in s["flows"]) == \
            mesh_lib.flow_kind_counts(s["counts"])
        assert [f["wire_bytes"] for f in s["flows"]] == \
            [_ring(f) for f in s["flows"]]


def test_recorded_step_components_and_axes(run):
    """The smoke phi3.5-moe step at (2, 2): every all-to-all under `moe`
    on 'model' at E x C_loc x d x 4 bytes, two a layer forward and two
    backward (no remat in the smoke config); the gradient's reduce over
    'data' (one a leaf) and the int8 path under `grads`; the ZeRO-1
    gathers over 'data' under `optimizer`; nothing resolves to `app`."""
    cfg = get_smoke("phi3_5_moe_42b")
    t_loc = 4 * 16 // 4
    c_loc = max(8, int(t_loc * cfg.top_k / cfg.n_experts
                       * cfg.capacity_factor))
    for r in run[1]:
        flows = r["step"]["flows"]
        a2a = [f for f in flows if f["kind"] == "all-to-all"]
        assert len(a2a) == 4 * cfg.n_layers
        assert {(f["component"], f["axis"], f["input_bytes"])
                for f in a2a} == {("moe", "model",
                                   cfg.n_experts * c_loc * cfg.d_model * 4)}
        assert not [f for f in flows if f["component"] == "app"]
        assert {f["component"] for f in flows} <= set(KNOWN_COMPONENTS)
        grads = [f for f in flows if f["component"] == "grads"
                 and f["kind"] == "all-reduce" and f["axis"] == "data"]
        assert len(grads) >= 13          # one a leaf, and the int8 maxes
        zero = [f for f in flows if f["component"] == "optimizer"
                and f["kind"] == "all-gather"]
        assert zero and {f["axis"] for f in zero} == {"data"}
        assert {(f["axis"], f["group_stride"]) for f in flows} <= \
            {("data", 2), ("model", 1)}
        for comp in ("attention", "moe", "embed", "lm_head", "loss"):
            assert any(f["component"] == comp for f in flows), comp


def test_redundant_collectives_of_the_step(run):
    """The a2a pair repeats at one shape and site every layer, forward
    and backward: find_redundant_gathers names it."""
    cfg = get_smoke("phi3_5_moe_42b")
    for r in run[1]:
        red = dict(r["step"]["redundant"])
        assert red[f"all-to-all {cfg.n_experts * 8 * cfg.d_model * 4}B "
                   f"moe@model"] == 4 * cfg.n_layers


def test_report_collectives_equal_the_references(run):
    """XFAReport's collectives section (to_json and render) built from
    one summary is the reference's, keys and values."""
    for r in run[1]:
        s = r["step"]
        flows = [ref_flows.CollectiveFlow(**{k: v for k, v in f.items()
                                             if k != "wire_bytes"})
                 for f in s["flows"]]
        ref = RefReport(RefFoldedTable(), ref_flows.CollectiveSummary.build(
            flows), 0.0, 1)
        assert s["collectives"] == ref.to_json()["collectives"]
        head = "Collective flows (wire bytes/device/step):"
        mine = s["render"][s["render"].index(head):]
        theirs = ref.render(components=())
        assert mine == theirs[theirs.index(head):]
