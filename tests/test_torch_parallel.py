"""The port's `repro_torch.parallel` against the JAX package, on the CPU.

The JAX side runs its parallel functions in ONE subprocess with 8 host
devices and meshes of Auto axes (`jax.make_mesh(..., axis_types=(Auto,)
* n)`: under jax 0.9 `jax.make_mesh` makes Explicit axes, which the
reference's sharding constraints and GPipe slices refuse).  The port
runs them in one gloo world of 4 ranks (`torch_mesh_worlds.parallel`).
Both are started once per module and read by many small tests.

Tolerances, f32: col_row_mlp's output and gradients at atol 1e-5 / rtol
1e-4; gpipe_apply's output at 1e-5 and its gradient at 1e-4 (as the
reference's own test); context-parallel decode at 2e-5 (as the
reference's own test; bf16: 2e-2 abs + rel); the smoke tinyllama's loss
and gradients at atol 1e-5 / rtol 1e-4, as the training parity tests.
spec_tree must give every leaf of all ten configs the reference's
PartitionSpec entries exactly, and the int8 functions must equal the
reference's to f32 rounding.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_mesh_worlds as worlds
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.ckpt.manager import _flatten
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import build_model as jax_build
from repro.optim import adamw as jax_adamw
from repro.parallel import sharding as jax_sharding
from repro_torch.configs import get_config
from repro_torch.launch import mesh as launch_mesh
from repro_torch.optim import adamw
from repro_torch.parallel import axes, mesh as mesh_lib, sharding
from repro_torch.runtime.trainer import full_shapes
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["tinyllama_1_1b", "granite_20b", "qwen3_14b", "starcoder2_7b",
         "internvl2_1b", "zamba2_2_7b", "phi3_5_moe_42b",
         "deepseek_v2_lite_16b", "seamless_m4t_large_v2", "xlstm_1_3b"]
ATOL, RTOL = 1e-5, 1e-4

JAX_SCRIPT = textwrap.dedent("""
    import os, sys, pickle
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_smoke
    from repro.models import build_model
    from repro.parallel.axes import runtime_mesh
    from repro.parallel.context import context_parallel_decode
    from repro.parallel.pipeline import gpipe_apply, split_stages
    from repro.parallel.tp import col_row_mlp
    from repro.kernels import ref

    def mesh(shape, names):
        return jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape))

    inp = dict(np.load(sys.argv[1]))
    out = {}
    m24 = mesh((2, 4), ("data", "model"))
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    m22 = jax.sharding.Mesh(devs, ("data", "model"),
                            axis_types=(AxisType.Auto,) * 2)
    x, wu, wg, wd, ct = (jnp.asarray(inp["mlp_" + n])
                         for n in ("x", "wu", "wg", "wd", "ct"))

    def plain(x, wu, wd, wg, gated):
        if gated:
            return (jax.nn.silu(x @ wg) * (x @ wu)) @ wd
        return jax.nn.gelu(x @ wu) @ wd

    for gated in (True, False):
        for tag, m in (("", m22), ("_2x4", m24), ("_plain", None)):
            def f(x, wu, wd, wg):
                if m is None:
                    return plain(x, wu, wd, wg, gated)
                with runtime_mesh(m):
                    return col_row_mlp(x, wu, wd, wg if gated else None,
                                       gated)
            y, vjp = jax.vjp(jax.jit(f), x, wu, wd, wg)
            g = vjp(ct)
            res = {"y": y, "dx": g[0], "dwu": g[1], "dwd": g[2]}
            if gated:
                res["dwg"] = g[3]
            out["mlp_gated%d%s" % (gated, tag)] = {
                k: np.asarray(v) for k, v in res.items()}

    m4 = mesh((4,), ("stage",))
    layer_w = jnp.asarray(inp["pipe_w"])
    mbs = jnp.asarray(inp["pipe_mbs"])

    def stage_fn(w_stack, x):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, w_stack)
        return y

    def pipelined(w8):
        st = split_stages({"w": w8}, 4)
        return gpipe_apply(lambda p, x: stage_fn(p["w"], x), st, mbs, m4)
    out["pipe"] = {"y": np.asarray(jax.jit(pipelined)(layer_w)),
                   "grad": np.asarray(jax.jit(jax.grad(
                       lambda w: jnp.sum(jnp.sin(pipelined(w)))))(layer_w))}

    m8 = mesh((8,), ("data",))
    q, k, v = (jnp.asarray(inp["cp_" + n]) for n in "qkv")
    cp = jax.jit(lambda q, k, v, p: context_parallel_decode(
        q, k, v, p, m8, context_axis="data", head_axis=None, impl="ref"))
    for pos in inp["cp_pos"]:
        out["cp_pos%d" % pos] = np.asarray(cp(q, k, v, jnp.int32(pos)))

    cfg = get_smoke("tinyllama_1_1b")
    model = build_model(cfg, impl="ref")
    params = model.init(jax.random.key(0))
    batch = {n: jnp.asarray(inp["batch_" + n])
             for n in ("tokens", "labels", "mask")}
    with runtime_mesh(m24):
        (loss, (met, _)), g = jax.jit(jax.value_and_grad(
            lambda p: model.loss_fn(p, batch, model.table()),
            has_aux=True))(params)
    from repro.ckpt.manager import _flatten
    out["tinyllama"] = {"loss": float(loss), "tokens": float(met["tokens"]),
                        "grads": {n: np.asarray(a)
                                  for n, a in _flatten(g)[0]}}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("OK")
""")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs many small ops (tiny layers): one intra-op
    thread, so that they do not contend with the other test workers'
    threads for the cores (the ranks run single-threaded too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(path):
    rng = np.random.default_rng(0)
    f32 = np.float32
    cfg = jax_smoke("tinyllama_1_1b")
    params = jax_build(cfg, impl="ref").init(jax.random.key(0))
    batch = JaxData(cfg, 4, 32, seed=5).generate(0)
    batch["mask"][3, 20:] = 0.0                 # a masked tail counts nothing
    B, Hq, Hkv, S, D = 2, 8, 4, 256, 32
    arrays = {
        "mlp_x": rng.standard_normal((2, 16, 32)).astype(f32),
        "mlp_wu": (rng.standard_normal((32, 64)) * 0.1).astype(f32),
        "mlp_wg": (rng.standard_normal((32, 64)) * 0.1).astype(f32),
        "mlp_wd": (rng.standard_normal((64, 32)) * 0.1).astype(f32),
        "mlp_ct": rng.standard_normal((2, 16, 32)).astype(f32),
        "pipe_w": (rng.standard_normal((8, 16, 16)) * 0.3).astype(f32),
        "pipe_mbs": rng.standard_normal((6, 2, 16)).astype(f32),
        "cp_q": rng.standard_normal((B, Hq, D)).astype(f32),
        "cp_k": rng.standard_normal((B, Hkv, S, D)).astype(f32),
        "cp_v": rng.standard_normal((B, Hkv, S, D)).astype(f32),
        "cp_pos": np.array([S - 1, 100, 63, 0], np.int32),
        # per-row positions: row 0 sees shard 0 only (shards 1-3 empty)
        "cp_rows": np.array([40, 200], np.int32),
        **{f"batch_{n}": a for n, a in batch.items()},
        **{f"p/{n}": np.asarray(a) for n, a in _flatten(params)[0]},
    }
    np.savez(path, **arrays)
    return arrays


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, the JAX subprocess's results, the port ranks' results)."""
    d = str(tmp_path_factory.mktemp("parallel"))
    inp = _inputs(os.path.join(d, "inputs.npz"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, os.path.join(d, "inputs.npz"),
         os.path.join(d, "jax.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    procs = worlds.start_world("parallel", 4, d)
    try:
        worlds.join(procs, d, "parallel")
        _, err = jax_proc.communicate(timeout=worlds.JOIN_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    import pickle
    with open(os.path.join(d, "jax.pkl"), "rb") as f:
        ref = pickle.load(f)
    ranks = [torch.load(os.path.join(d, f"parallel-rank{r}.pt"))
             for r in range(4)]
    return inp, ref, ranks


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


# ------------------------------------------------------------- tensor ----
@pytest.mark.parametrize("gated", [True, False])
def test_col_row_mlp_matches_reference(run, gated):
    """At (2, 2), gloo against the reference: the output and the
    gradients of x and every weight (gathered), which are also the plain
    unsharded function's."""
    _, ref, ranks = run
    want = ref[f"mlp_gated{int(gated)}"]
    for r in ranks:
        got = r[f"mlp_gated{int(gated)}"]
        assert sorted(got) == sorted(want)
        for k in want:
            close(got[k], want[k], what=k)
            close(got[k], ref[f"mlp_gated{int(gated)}_plain"][k], what=k)


def test_reference_col_row_mlp_weight_grads_scale_with_data_over_model(run):
    """A fault of the reference the port does not share (ROADMAP §3): at a
    mesh whose data and model extents differ its col_row_mlp's weight
    gradients come out times data / model (0.5 at (2, 4)); dx and y are
    right.  The port's equal the plain function's at every mesh."""
    _, ref, _ = run
    for gated in (True, False):
        want = ref[f"mlp_gated{int(gated)}_plain"]
        got = ref[f"mlp_gated{int(gated)}_2x4"]
        for k in want:
            scale = 0.5 if k.startswith("dw") else 1.0
            close(got[k], scale * want[k], what=k)


def test_smoke_tinyllama_at_2x2_matches_the_reference_at_2x4(run):
    _, ref, ranks = run
    want = ref["tinyllama"]
    for r in ranks:
        got = r["tinyllama"]
        close(got["loss"], want["loss"], what="loss")
        assert float(got["tokens"]) == want["tokens"] == 4 * 32 - 12
        grads = dict(leaves_with_path(got["grads"]))
        assert sorted(grads) == sorted(want["grads"])
        for n, g in grads.items():
            close(g, want["grads"][n], what=n)


# ----------------------------------------------------------- pipeline ----
def test_gpipe_apply_matches_reference(run):
    """Four stages of two layers, six microbatches: the outputs on every
    rank, and each stage's gradient of sum(sin(y))."""
    _, ref, ranks = run
    for r in ranks:
        close(r["pipe"]["y"], ref["pipe"]["y"], atol=1e-5, rtol=1e-5)
    grad = torch.cat([r["pipe"]["grad"] for r in ranks])
    close(grad, ref["pipe"]["grad"], atol=1e-4, rtol=1e-4)


def test_gpipe_sends_each_microbatch_once_each_way(run):
    """Stage s receives six activations (s > 0) and sends six (s < 3)
    forward; the backward sends and receives as many the other way; one
    broadcast of the outputs."""
    _, _, ranks = run
    for s, r in enumerate(ranks):
        c = r["pipe"]["counts"]
        assert c["send"] == 6 * ((s < 3) + (s > 0)), (s, c)
        assert c["recv"] == c["send"], (s, c)
        assert c["broadcast"] == 1


def test_bubble_fraction_and_split_stages():
    from repro_torch.parallel.pipeline import bubble_fraction, split_stages
    assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-12
    st = split_stages({"a": {"w": torch.arange(24.).reshape(8, 3)}}, 4)
    assert st["a"]["w"].shape == (4, 2, 3)
    assert torch.equal(st["a"]["w"][1], torch.arange(6., 12.).reshape(2, 3))


# ------------------------------------------------------------ context ----
@pytest.mark.parametrize("pos", [255, 100, 63, 0])
def test_context_parallel_decode_matches_reference(run, pos):
    """4 shards (port) against 8 (reference); at pos 63 and 0 every shard
    past the first is empty."""
    _, ref, ranks = run
    for r in ranks:
        close(r["cp"][f"shards4_pos{pos}"], ref[f"cp_pos{pos}"], atol=2e-5,
              rtol=2e-5)


def test_context_parallel_decode_per_row_and_sharded_heads(run):
    """Per-row positions (row 0 sees only shard 0 of 4), f32 and bf16,
    and 2 sequence shards with the heads over the model axis, against the
    one-rank plain decode of the whole cache."""
    inp, _, ranks = run
    want = ranks[0]["cp"]["one_rank_rows"]
    q, k, v = (torch.from_numpy(inp[f"cp_{n}"]) for n in "qkv")
    from repro_torch.kernels import ref
    want16 = ref.decode_attention(
        q.bfloat16(), k.bfloat16(), v.bfloat16(),
        kv_len=torch.from_numpy(inp["cp_rows"] + 1))
    for r in ranks:
        close(r["cp"]["shards4_rows"], want, atol=2e-5, rtol=2e-5)
        close(r["cp"]["data2_heads2_rows"], want, atol=2e-5, rtol=2e-5)
        close(r["cp"]["shards4_rows_bf16"], want16.float(), atol=2e-2,
              rtol=2e-2)


def test_combine_decode_partials_matches_reference():
    from repro.kernels import ref as jax_ref
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3)
    o = rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
    m = rng.standard_normal((3, 2, 4)).astype(np.float32)
    m[1, 0] = -1e30                              # an empty shard
    l = rng.uniform(0.5, 2.0, (3, 2, 4)).astype(np.float32)
    l[1, 0] = 0.0
    got = ref.combine_decode_partials(*map(torch.from_numpy, (o, m, l)))
    close(got, jax_ref.combine_decode_partials(o, m, l), atol=1e-6,
          rtol=1e-6)


# ---------------------------------------------------------- sharding ----
class DuckMesh:
    """What spec_tree reads of a mesh: axis_names and devices.shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_reference(arch):
    """Full widths, jax.eval_shape params: per leaf the port's placements
    equal the reference's PartitionSpec entries, with and without the
    ZeRO (fsdp) transform, at (2, 4) and (2, 2, 2)."""
    jm = jax_build(jax_config(arch), impl="ref")
    abstract = jax.eval_shape(jm.init, jax.random.key(0))
    flat_shapes = {n: a for n, a in _flatten(abstract)[0]}
    assert jax_sharding.validate_rules(abstract) == []
    port_shapes = dict(leaves_with_path(full_shapes(get_config(arch))))
    assert {n: tuple(a.shape) for n, a in flat_shapes.items()} == \
        {n: tuple(a.shape) for n, a in port_shapes.items()}
    for shape, names in MESHES:
        mesh = DuckMesh(shape, names)
        for fsdp in (False, True):
            ref_specs = jax.tree_util.tree_flatten_with_path(
                jax_sharding.spec_tree(abstract, mesh, fsdp=fsdp),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            want = {jax_sharding._path_str(p)[1:]: tuple(s)
                    for p, s in ref_specs[0]}
            got = dict(leaves_with_path(sharding.spec_tree(
                abstract, mesh, fsdp=fsdp)))
            assert sorted(got) == sorted(want)
            for n in want:
                assert got[n] == want[n], (arch, shape, fsdp, n)


def test_validate_rules_covers_every_config():
    for arch in ARCHS:
        assert sharding.validate_rules(full_shapes(get_config(arch))) == []
    assert sharding.validate_rules({"mystery": {"w": torch.empty(2)}}) == \
        ["/mystery/w"]


def test_layout_tree_keeps_mqa_kv_whole_and_checks_heads():
    mesh = DuckMesh((1, 2), ("data", "model"))
    granite = get_config("granite_20b")
    lay = dict(leaves_with_path(sharding.layout_tree(
        full_shapes(granite), mesh, granite)))
    spec = dict(leaves_with_path(sharding.spec_tree(
        full_shapes(granite), mesh)))
    assert spec["stack/stack/attn/wk"] == (None, None, "model")
    assert lay["stack/stack/attn/wk"] == lay["stack/stack/attn/wv"] == \
        (None, None, None)
    assert lay["stack/stack/attn/wq"] == spec["stack/stack/attn/wq"]
    tiny = get_config("tinyllama_1_1b")              # 4 kv heads
    with pytest.raises(ValueError, match="kv heads"):
        sharding.layout_tree(full_shapes(tiny), DuckMesh(
            (1, 8), ("data", "model")), tiny)
    zero = dict(leaves_with_path(sharding.layout_tree(
        full_shapes(tiny), DuckMesh((2, 2), ("data", "model")), tiny,
        zero1=True)))
    assert zero["embed/table"] == ("model", "data")
    assert zero["stack/stack/attn/wq"] == (None, "data", "model")


def test_resolve_spec_and_axis_size_follow_the_installed_mesh():
    assert axes.resolve_spec("batch", None, "model") == (None, None, None)
    assert axes.axis_size("batch") == 1
    m = mesh_lib.Mesh((1, 1), ("data", "model"))
    with axes.runtime_mesh(m):
        assert axes.get_runtime_mesh() is m
        assert axes.resolve_spec("batch", "seq", "vocab") == \
            ("data", None, "model")
        x = torch.ones(2)
        assert axes.shard(x, "batch") is x
        assert axes.shard_dims(x, {0: "batch"}) is x
    assert axes.get_runtime_mesh() is None


# ------------------------------------------------------------ process ----
def test_collective_counts_and_results(run):
    """Collectives over axes of extent 1 do nothing and count nothing;
    the others count one per axis they reduce over."""
    _, _, ranks = run
    for r in ranks:
        c = r["counters"]
        assert c["trivial"] == dict.fromkeys(c["trivial"], 0)
        assert c["after"]["all_reduce"] == 3
        assert c["after"]["all_gather"] == 1
        assert c["after"]["broadcast"] == 1
        assert torch.equal(c["sum"], torch.full((3,), 4.0))
        dc, mc = c["coord"]
        base = 2 * dc
        assert torch.equal(c["gathered"], torch.tensor(
            [base, base, base + 1, base + 1], dtype=torch.float32))
        assert float(c["broadcast"]) == 2 + mc


def test_make_mesh_needs_the_world_size():
    with pytest.raises(ValueError, match="world has 1"):
        mesh_lib.make_mesh((2, 1), ("data", "model"))
    m = mesh_lib.make_mesh((1, 1), ("data", "model"))
    t = torch.ones(2)
    assert mesh_lib.all_reduce(t, m, "data") is t
    assert m.size("model") == 1 and m.coord(("data", "model")) == 0


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        mesh_lib.init_distributed("nccl", "cuda", rank=0, world_size=2)
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        mesh_lib.init_distributed("nccl", "cpu", rank=0, world_size=1)
    assert mesh_lib.default_backend("cpu") == "gloo"
    assert mesh_lib.default_backend("cuda") == "nccl"


def test_launch_mesh_parses_and_names_the_card():
    assert launch_mesh.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    assert launch_mesh.parse_mesh("2x2x2") == ((2, 2, 2),
                                                ("pod", "data", "model"))
    with pytest.raises(ValueError):
        launch_mesh.parse_mesh("8")
    assert launch_mesh.PEAK_FLOPS_BF16 == 989e12
    assert launch_mesh.HBM_BW == 3.35e12
    assert launch_mesh.NVLINK_BW == 900e9
    m = mesh_lib.Mesh((2, 4), ("data", "model"))
    assert launch_mesh.mesh_axis_sizes(m) == {"data": 2, "model": 4}


# --------------------------------------------------------------- int8 ----
def test_int8_quantize_dequantize_match_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    jq, js = jax_adamw.quantize_int8(x)
    q, s = adamw.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    close(s, js, atol=0, rtol=1e-7)
    close(adamw.dequantize_int8(q, s), jax_adamw.dequantize_int8(jq, js),
          atol=0, rtol=1e-7)


def test_compress_grads_with_feedback_matches_reference():
    """Two rounds of error feedback on the same numpy gradients: the
    compressed gradients (in each leaf's dtype) and the f32 residues."""
    rng = np.random.default_rng(2)
    grads = {"a": {"w": rng.standard_normal((16, 8)).astype(np.float32)},
             "b": rng.standard_normal((5,)).astype(np.float32) * 1e-3}
    jerr = jax_adamw.init_error_state(grads)
    terr = adamw.init_error_state(
        {"a": {"w": torch.zeros(16, 8)}, "b": torch.zeros(5)})
    for _ in range(2):
        jg, jerr = jax_adamw.compress_grads_with_feedback(grads, jerr)
        tg, terr = adamw.compress_grads_with_feedback(
            {"a": {"w": torch.from_numpy(grads["a"]["w"])},
             "b": torch.from_numpy(grads["b"])}, terr)
        close(tg["a"]["w"], jg["a"]["w"], atol=1e-7, rtol=1e-6)
        close(tg["b"], jg["b"], atol=1e-10, rtol=1e-6)
        close(terr["a"]["w"], jerr["a"]["w"], atol=1e-7, rtol=1e-5)
        close(terr["b"], jerr["b"], atol=1e-10, rtol=1e-5)
