"""Rank programs of the port's gloo worlds on the CPU, for
tests/test_torch_parallel.py, tests/test_torch_mesh_training.py,
tests/test_torch_moe_mesh.py, tests/test_torch_collective_flows.py,
tests/test_torch_mla_mesh.py, tests/test_torch_hybrid_mesh.py,
tests/test_torch_vlm_audio_ssm_mesh.py and the card's
tests/test_torch_cuda.py.

Each test module starts one world per mesh size once (a module fixture):
`start_world` launches one process per rank running `main`, which joins
a gloo group through a file:// path with a timeout, runs the named
program and writes what it found to <dir>/<program>-rank<r>.pt for the
tests to read.  `join` waits with a time limit and kills every rank of a
world that did not finish, so a dead rank fails its tests and never
hangs the run.  Nothing here imports jax: the JAX side of each
comparison runs in the test process or in its own subprocess.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
#: the process group's timeout and a world's time limit, seconds
PG_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 240


def start_world(program: str, world: int, out_dir: str):
    """Launch the `world` ranks of `program`; returns their processes."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    procs = []
    for r in range(world):
        path = os.path.join(out_dir, f"{program}-rank{r}.log")
        with open(path, "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import torch_mesh_worlds as w; w.main()", program, str(r),
                 str(world), out_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def join(procs, out_dir: str, program: str,
         timeout_s: float = JOIN_TIMEOUT_S) -> None:
    """Wait for every rank; raise with the logs' tails if one failed or
    the world outlived its time limit (its ranks are killed)."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            break
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        p.kill()
        p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if alive or bad:
        tails = []
        for r in range(len(procs)):
            with open(os.path.join(out_dir, f"{program}-rank{r}.log")) as f:
                tails.append(f"--- rank {r} ---\n{f.read()[-3000:]}")
        raise RuntimeError(f"world {program}: ranks {bad} failed"
                           f"{' (time limit)' if alive else ''}\n"
                           + "\n".join(tails))


def main() -> None:
    program, rank, world, out_dir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    from repro_torch.parallel import mesh as mesh_lib
    mesh_lib.init_distributed(
        "gloo", "cuda" if program.endswith("_cuda") else "cpu",
        init_method=f"file://{out_dir}/{program}.init",
        rank=rank, world_size=world, timeout_s=PG_TIMEOUT_S)
    out = PROGRAMS[program](rank, world, out_dir)
    torch.save(out, os.path.join(out_dir, f"{program}-rank{rank}.pt"))
    mesh_lib.shutdown()


# ------------------------------------------------------------ helpers ----
def _gather_rows(t, mesh, axis):
    from repro_torch.parallel import mesh as mesh_lib
    return mesh_lib.all_gather(t, mesh, axis, dim=0)


def _tiny(manual_tp=False, **kw):
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke("tinyllama_1_1b"), n_layers=2,
                               vocab=256, manual_tp=manual_tp, **kw)


# ----------------------------------------------------------- parallel ----
def parallel(rank, world, d):
    """col_row_mlp at (2, 2), gpipe_apply over 4 stages, context-parallel
    decode over 4 shards and over (2, 2), the smoke tinyllama's loss and
    gradients at (2, 2), and the collective counters."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.context import context_parallel_decode
    from repro_torch.parallel.pipeline import gpipe_apply, split_stages
    from repro_torch.parallel.sharding import gather_tree, shard_leaf
    from repro_torch.parallel.tp import col_row_mlp
    from repro_torch.runtime.trainer import (TrainLayout, full_shapes,
                                             local_value_and_grad)
    from repro_torch.tree import leaves_with_path
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out = {}
    m22 = mesh_lib.make_mesh((2, 2), ("data", "model"))
    dc, mc = m22.coord("data"), m22.coord("model")

    # col_row_mlp: x rows over data, w_up / w_gate columns and w_down rows
    # over model
    for gated in (True, False):
        x = torch.from_numpy(inp["mlp_x"])[dc:dc + 1].requires_grad_()
        ws = {k: shard_leaf(torch.from_numpy(inp[f"mlp_{k}"]), s, m22)
              .clone().requires_grad_()
              for k, s in (("wu", (None, "model")), ("wg", (None, "model")),
                           ("wd", ("model", None)))}
        with runtime_mesh(m22):
            y = col_row_mlp(x, ws["wu"], ws["wd"],
                            ws["wg"] if gated else None, gated)
        ct = torch.from_numpy(inp["mlp_ct"])[dc:dc + 1]
        (y * ct).sum().backward()
        got = {"y": _gather_rows(y.detach(), m22, "data"),
               "dx": _gather_rows(x.grad, m22, "data")}
        for k, s in (("wu", (None, "model")), ("wd", ("model", None)),
                     ("wg", (None, "model"))):
            if k == "wg" and not gated:
                continue
            g = mesh_lib.all_reduce(ws[k].grad, m22, "data")
            got[f"d{k}"] = gather_tree({"g": g}, m22, {"g": s})["g"]
        out[f"mlp_gated{int(gated)}"] = got

    # gpipe over 4 stages of 2 layers each
    m4 = mesh_lib.make_mesh((4,), ("stage",))
    s = m4.coord("stage")
    layer_w = torch.from_numpy(inp["pipe_w"])
    w = split_stages({"w": layer_w}, 4)["w"][s].clone().requires_grad_()

    def stage_fn(p, x):
        for i in range(p.shape[0]):
            x = torch.tanh(x @ p[i])
        return x
    mbs = torch.from_numpy(inp["pipe_mbs"])
    mesh_lib.reset_collective_counts()
    y = gpipe_apply(stage_fn, w, mbs, m4)
    torch.sin(y).sum().backward()
    out["pipe"] = {"y": y.detach(), "grad": w.grad,
                   "counts": mesh_lib.collective_counts()}

    # context-parallel decode: 4 shards of the sequence; then 2 shards
    # (data) with the heads over model (each rank passes its heads)
    q, k, v = (torch.from_numpy(inp[f"cp_{n}"]) for n in "qkv")
    S = k.shape[2]
    m41 = mesh_lib.make_mesh((4, 1), ("data", "model"))
    c4 = m41.coord("data")
    cp = {}
    for pos in inp["cp_pos"]:
        kl = k[:, :, c4 * S // 4:(c4 + 1) * S // 4]
        vl = v[:, :, c4 * S // 4:(c4 + 1) * S // 4]
        cp[f"shards4_pos{int(pos)}"] = context_parallel_decode(
            q, kl, vl, int(pos), m41, impl="ref")
    rows = torch.from_numpy(inp["cp_rows"])
    kl = k[:, :, c4 * S // 4:(c4 + 1) * S // 4]
    vl = v[:, :, c4 * S // 4:(c4 + 1) * S // 4]
    cp["shards4_rows"] = context_parallel_decode(q, kl, vl, rows, m41,
                                                 impl="ref")
    qb, kb, vb = (t[:, :, c4 * S // 4:(c4 + 1) * S // 4] if t.dim() == 4
                  else t for t in (q.bfloat16(), k.bfloat16(), v.bfloat16()))
    cp["shards4_rows_bf16"] = context_parallel_decode(qb, kb, vb, rows, m41,
                                                      impl="ref")
    Hq, Hkv = q.shape[1], k.shape[1]
    hq = slice(mc * Hq // 2, (mc + 1) * Hq // 2)
    hk = slice(mc * Hkv // 2, (mc + 1) * Hkv // 2)
    half = slice(dc * S // 2, (dc + 1) * S // 2)
    o = context_parallel_decode(q[:, hq], k[:, hk, half], v[:, hk, half],
                                rows, m22, impl="ref")
    cp["data2_heads2_rows"] = mesh_lib.all_gather(o, m22, "model", dim=1)
    cp["one_rank_rows"] = ref.decode_attention(
        q, k, v, kv_len=(rows + 1).to(torch.int32))
    out["cp"] = cp

    # the smoke tinyllama at (2, 2): loss and gradients on the global batch
    cfg = get_smoke("tinyllama_1_1b")
    model = build_model(cfg, device="cpu")
    flat = {n[len("p/"):]: a for n, a in inp.items() if n.startswith("p/")}
    params = params_from_numpy(flat, cfg, "cpu", mesh=m22)
    batch = {n: inp[f"batch_{n}"] for n in ("tokens", "labels", "mask")}
    with runtime_mesh(m22):
        lay = TrainLayout(model, full_shapes(cfg), m22)
        loss, met, _, g = local_value_and_grad(
            model, params, lay.local_rows(batch, 1), None, lay)
        for _, x in leaves_with_path(g):
            mesh_lib.all_reduce(x, m22, lay.batch_axes)
        out["tinyllama"] = {"loss": loss, "tokens": met["tokens"],
                            "grads": gather_tree(g, m22, lay.param)}

    # counters: an axis of extent 1 costs nothing and counts nothing
    mesh_lib.reset_collective_counts()
    t = torch.ones(3)
    mesh_lib.all_reduce(t, m41, "model")
    mesh_lib.all_gather(t, m41, "model")
    mesh_lib.broadcast(t, m41, "model")
    trivial = mesh_lib.collective_counts()
    mesh_lib.all_reduce(t, m22, ("data", "model"))
    mesh_lib.all_reduce(t, m22, "model", op="max")
    g2 = mesh_lib.all_gather(torch.full((2,), float(rank)), m22, "model")
    b = mesh_lib.broadcast(torch.full((1,), float(rank)), m22, "data", src=1)
    out["counters"] = {"trivial": trivial,
                       "after": mesh_lib.collective_counts(),
                       "sum": t, "gathered": g2, "broadcast": b,
                       "coord": (dc, mc)}
    return out


# ----------------------------------------------------------- training ----
#: the trainer settings of the loss curves each training world runs
CURVES = {"plain": {}, "micro2": {"microbatches": 2},
          "deferred": {"microbatches": 2, "deferred_grad_reduce": True},
          "deferred_int8": {"microbatches": 2, "deferred_grad_reduce": True,
                            "grad_compression": "int8"}}


def training(rank, world, d):
    """The tiny tinyllama under every mesh this world holds (2 ranks:
    1x2 then 2x1; 4 ranks: 2x2): loss and gradients (and with manual
    TP), the static costs, three 3-step loss curves, ZeRO-1 slices,
    collective counts; with 2 ranks also a checkpoint written at 1x2 and
    restored at 2x1, and a Trainer run's profile shards."""
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.device_fold import STATIC_COSTS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import (build_model, params_from_numpy,
                                    train_state_from_numpy)
    from repro_torch.optim import adamw
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.runtime.trainer import (
        Trainer, TrainLayout, full_shapes, init_train_state,
        local_value_and_grad, make_train_step)
    from repro_torch.tree import leaves_with_path
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    flat_state = {n[len("s/"):]: a for n, a in inp.items()
                  if n.startswith("s/")}
    batch = {n: inp[f"batch_{n}"] for n in ("tokens", "labels", "mask")}
    shapes = [(1, 2), (2, 1)] if world == 2 else [(2, 2)]
    out = {}
    for shape in shapes:
        tag = "x".join(map(str, shape))
        mesh = mesh_lib.make_mesh(shape, ("data", "model"))
        res = {}
        for manual in ((False, True) if shape[1] > 1 else (False,)):
            cfg = _tiny(manual)
            model = build_model(cfg, device="cpu")
            params = params_from_numpy(
                {n[len("params/"):]: a for n, a in flat_state.items()
                 if n.startswith("params/")}, cfg, "cpu", mesh=mesh)
            with runtime_mesh(mesh):
                lay = TrainLayout(model, full_shapes(cfg), mesh)
                STATIC_COSTS.reset()
                loss, met, _, g = local_value_and_grad(
                    model, params, lay.local_rows(batch, 1), None, lay)
                costs = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
                for _, x in leaves_with_path(g):
                    mesh_lib.all_reduce(x, mesh, lay.batch_axes)
                res[f"grads_manual{int(manual)}"] = {
                    "loss": loss, "tokens": met["tokens"],
                    "grads": gather_tree(g, mesh, lay.param),
                    "costs": costs}
        cfg = _tiny()
        model = build_model(cfg, device="cpu")
        curves = {}
        for mode, kw in CURVES.items():
            tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                               total_steps=3, ckpt_interval=0, **kw)
            state = train_state_from_numpy(flat_state, cfg, "cpu")
            if tcfg.grad_compression == "int8":
                state["grad_err"] = adamw.init_error_state(state["params"])
            with runtime_mesh(mesh):
                lay = TrainLayout(model, full_shapes(cfg), mesh)
                state = lay.shard_state(state)
                step = make_train_step(model, tcfg, lay)
                losses, norms, counts = [], [], []
                for i in range(3):
                    mesh_lib.reset_collective_counts()
                    state, m, _ = step(state, SyntheticLMData(
                        cfg, 4, 16, seed=3).generate(i), None)
                    counts.append(mesh_lib.collective_counts())
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                curves[mode] = {
                    "loss": losses, "grad_norm": norms, "counts": counts,
                    "state": lay.gather_state(state),
                    "master_shapes": {n: tuple(x.shape) for n, x in
                                      leaves_with_path(
                                          state["opt"]["master"])},
                    "n_leaves": len(leaves_with_path(state["params"]))}
        res["curves"] = curves
        if tag == "1x2":
            tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                               total_steps=2, ckpt_interval=2)
            with runtime_mesh(mesh):
                t = Trainer(model, tcfg, CheckpointManager(
                    os.path.join(d, "ck")), profile_dir=os.path.join(
                        d, "prof"))
                st, last = t.run(0, SyntheticLMData(cfg, 4, 16, seed=3), 2,
                                 resume=False)
                lay = TrainLayout(model, full_shapes(cfg), mesh)
                res["ckpt_state"] = lay.gather_state(st)
                res["ckpt_last"] = last
        out[tag] = res
        if tag == "2x1":
            # restore the checkpoint the 1x2 run wrote, at 2x1
            tcfg = TrainConfig(ckpt_interval=0)
            with runtime_mesh(mesh):
                lay = TrainLayout(model, full_shapes(cfg), mesh)
                fresh = init_train_state(model, 7, tcfg, lay)
                restored, extra = CheckpointManager(
                    os.path.join(d, "ck")).restore(
                        fresh, specs=lay.state_specs(fresh), mesh=mesh)
                out["restored_2x1"] = {
                    "state": lay.gather_state(restored), "extra": extra,
                    "master_shapes": {n: tuple(x.shape) for n, x in
                                      leaves_with_path(
                                          restored["opt"]["master"])}}
    return out


# --------------------------------------------------------------- card ----
def layer_cuda(rank, world, d):
    """Two ranks sharing one card over gloo: tinyllama_1_1b's embedding,
    first decoder layer and final norm at its published widths (bf16,
    the kernels), tensor parallel 2, against rank 0's one-rank forward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, transformer
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.sharding import layout_tree, shard_tree
    cfg = dataclasses.replace(get_config("tinyllama_1_1b"), n_layers=1)
    model = build_model(cfg, device="cuda")
    full = model.init(0)
    tokens = torch.randint(0, cfg.vocab, (2, 256),
                           generator=torch.Generator().manual_seed(1))
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    ops.reset_launch_counts()
    with runtime_mesh(mesh), torch.no_grad():
        local = shard_tree(full, mesh, layout_tree(full, mesh, cfg))
        got, _, _ = transformer.forward(local, tokens, model.rt, None)
    counts = ops.launch_counts()
    want = None
    if rank == 0:
        with torch.no_grad():
            want, _, _ = transformer.forward(full, tokens, model.rt, None)
        want = want.float().cpu()
    torch.cuda.synchronize()
    return {"got": got.float().cpu(), "want": want, "launches": counts}


#: p2p_cuda's tensors: (name, dtype, a transposed view)
P2P_CASES = (("bfloat16", "bfloat16", False), ("float32", "float32", False),
             ("bfloat16_transposed", "bfloat16", True))


def p2p_cuda(rank, world, d):
    """Two ranks sharing one card over gloo: each sends a bf16 and an f32
    CUDA tensor, and a transposed bf16 view, to the other (`mesh.send` /
    `mesh.recv`, both ways; the view is received into a transposed
    buffer).  Returns what each rank sent and received, on the host
    (strides kept)."""
    import torch
    from repro_torch.parallel import mesh as mesh_lib
    mesh = mesh_lib.make_mesh((1, 2), ("data", "model"))
    other = 1 - mesh.coord("model")
    out = {}
    for name, dtype, transposed in P2P_CASES:
        gen = torch.Generator(device="cuda").manual_seed(11 + rank)
        sent = torch.randn(257, 3, generator=gen,
                           device="cuda").to(getattr(torch, dtype)).t()
        if not transposed:
            sent = sent.contiguous()
        got = torch.empty_like(sent)
        if rank == 0:
            req = mesh_lib.send(sent, mesh, "model", other)
            mesh_lib.recv(got, mesh, "model", other)
            req.wait()
        else:
            mesh_lib.recv(got, mesh, "model", other)
            mesh_lib.send(sent, mesh, "model", other).wait()
        out[name] = {"sent": sent.cpu(), "got": got.cpu(),
                     "device": str(got.device)}
    return out


# ---------------------------------------------------------------- moe ----
#: the capacity factors of the MoE layer checks: the config's (binding:
#: the same per-shard drops) and one at which nothing drops
MOE_CFS = (1.25, 64.0)
#: the batch of the MoE model checks and curves: 64 tokens, 16 a shard
#: at (2, 2)
MOE_BATCH = (4, 16)


def _moe_cfg(cf=None):
    from repro_torch.configs import get_smoke
    cfg = get_smoke("phi3_5_moe_42b")
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def _sub_mesh(m22):
    """(1, 2) over the model axis of each data row of the (2, 2) world:
    both rows run it, each on its own."""
    from repro_torch.parallel import mesh as mesh_lib
    return mesh_lib.Mesh((1, 2), ("data", "model"),
                         device_mesh=m22.device_mesh)


def _moe_layer(inp, mesh, cf, mode="a2a"):
    """The first MoE layer of the smoke phi3.5-moe on x [B, S, 128]:
    y, aux_total and the fold table, and the gradients of sum(y ct) +
    aux_total, gathered (x over 'data', the experts over 'model', the
    router's summed over 'data')."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.sharding import shard_leaf
    cfg = _moe_cfg(cf)
    model = build_model(cfg, device="cpu")
    dp = mesh.size("data") if mesh is not None else 1
    dc = mesh.coord("data") if mesh is not None else 0
    B = inp["x"].shape[0]
    rows = slice(dc * B // dp, (dc + 1) * B // dp)
    x = torch.from_numpy(inp["x"])[rows].clone().requires_grad_()
    ct = torch.from_numpy(inp["ct"])[rows]
    w = {}
    for k in ("router", "w_gate", "w_up", "w_down"):
        full = torch.from_numpy(inp[f"moe_{k}"])
        spec = (None, None) if k == "router" else ("model", None, None)
        w[k] = (shard_leaf(full, spec, mesh) if mesh is not None
                else full).clone().requires_grad_()
    with runtime_mesh(mesh):
        y, table, aux = moe_lib.moe({"moe": w}, x, model.rt, model.table(),
                                    mode=mode)
    ((y * ct).sum() + aux).backward()
    out = {"y": y.detach(), "aux": aux.detach(), "table": table,
           "dx": x.grad, "d_router": w["router"].grad}
    for k in ("w_gate", "w_up", "w_down"):
        out[f"d_{k}"] = w[k].grad
    if mesh is not None:
        out["y"] = _gather_rows(out["y"], mesh, "data")
        out["dx"] = _gather_rows(out["dx"], mesh, "data")
        out["d_router"] = mesh_lib.all_reduce(out["d_router"], mesh, "data")
        for k in ("w_gate", "w_up", "w_down"):
            g = mesh_lib.all_reduce(out[f"d_{k}"], mesh, "data")
            out[f"d_{k}"] = mesh_lib.all_gather(g, mesh, "model", dim=0)
    return out


def moe_mesh(rank, world, d):
    """The smoke phi3.5-moe's a2a MoE layer at (1, 2) and (2, 2) at each
    of MOE_CFS, and the dense layer on one rank; the model's loss and
    gradients and a 3-step Trainer run at each mesh, the (1, 2) run
    writing a checkpoint."""
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import (build_model, params_from_numpy,
                                    train_state_from_numpy)
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.runtime.trainer import (Trainer, TrainLayout,
                                             full_shapes,
                                             local_value_and_grad)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    flat_state = {n[len("s/"):]: a for n, a in inp.items()
                  if n.startswith("s/")}
    m22 = mesh_lib.make_mesh((2, 2), ("data", "model"))
    meshes = {"1x2": _sub_mesh(m22), "2x2": m22}
    out = {"dense": {cf: _moe_layer(inp, None, cf, "dense")
                     for cf in MOE_CFS}}
    cfg = _moe_cfg()
    model = build_model(cfg, device="cpu")
    B, S = MOE_BATCH
    batch = SyntheticLMData(cfg, B, S, seed=3).generate(0)
    row = m22.coord("data")
    for tag, mesh in meshes.items():
        res = {"layer": {cf: _moe_layer(inp, mesh, cf) for cf in MOE_CFS}}
        params = params_from_numpy(
            {n[len("params/"):]: a for n, a in flat_state.items()
             if n.startswith("params/")}, cfg, "cpu", mesh=mesh)
        with runtime_mesh(mesh):
            lay = TrainLayout(model, full_shapes(cfg), mesh)
            loss, met, table, g = local_value_and_grad(
                model, params, lay.local_rows(batch, 1), model.table(), lay)
            for _, x in _leaves(g):
                mesh_lib.all_reduce(x, mesh, lay.batch_axes)
            res["grads"] = {"loss": loss, "aux_loss": met["aux_loss"],
                            "table": table,
                            "grads": gather_tree(g, mesh, lay.param)}
            tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                               total_steps=3, ckpt_interval=3)
            state = lay.shard_state(train_state_from_numpy(flat_state, cfg,
                                                           "cpu"))
            t = Trainer(model, tcfg, CheckpointManager(
                os.path.join(d, f"ck-{tag}-row{row}")))
            st, _ = t.run(0, SyntheticLMData(cfg, B, S, seed=3), 3,
                          resume=False, state=state)
            res["curve"] = {"loss": [h["loss"] for h in t.history],
                            "aux_loss": [h["aux_loss"] for h in t.history],
                            "grad_norm": [h["grad_norm"] for h in t.history],
                            "state": lay.gather_state(st),
                            "fold": t.session.device_fold.to_json()}
        out[tag] = res
    return out


def _leaves(tree):
    from repro_torch.tree import leaves_with_path
    return leaves_with_path(tree)


# --------------------------------------------------------------- flows ----
#: the Trainer settings of the recorded smoke phi3.5-moe step at (2, 2)
FLOWS_TRAIN = {"learning_rate": 3e-3, "warmup_steps": 2, "total_steps": 2,
               "ckpt_interval": 0, "grad_compression": "int8"}


def _flow_dicts(flows):
    return [dict(dataclasses.asdict(f), wire_bytes=f.wire_bytes)
            for f in flows]


def flows(rank, world, d):
    """XFA's L3 flows as the port records them at (2, 2): one call of each
    collective kind inside a `collective` scope, and the smoke
    phi3.5-moe's second Trainer step (int8 compression, ZeRO-1): each
    flow, the step's counts, its report's collectives section and the
    redundant collectives."""
    import torch
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import hlo_flows
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.runtime.trainer import Trainer
    m22 = mesh_lib.make_mesh((2, 2), ("data", "model"))
    out = {}
    mesh_lib.reset_collective_counts()
    mesh_lib.all_reduce(torch.ones(3), m22, "model")   # not recorded
    before = mesh_lib.collective_counts()
    with hlo_flows.component("collective"), mesh_lib.recording() as fl:
        mesh_lib.all_reduce(torch.ones(3), m22, ("data", "model"))
        mesh_lib.all_gather(torch.ones(2), m22, "model")
        a2a = mesh_lib.all_to_all(torch.arange(4.0) + 10 * rank, m22,
                                  "model")
        mesh_lib.broadcast(torch.ones(5), m22, "data")
        mesh_lib.all_reduce(torch.ones(4), m22, "data", op="max")
        me = m22.coord("model")
        buf = torch.empty(6)
        if me == 0:
            mesh_lib.send(torch.ones(6), m22, "model", 1).wait()
            mesh_lib.recv(buf, m22, "model", 1)
        else:
            mesh_lib.recv(buf, m22, "model", 0)
            mesh_lib.send(torch.ones(6), m22, "model", 0).wait()
    after = mesh_lib.collective_counts()
    out["direct"] = {"flows": _flow_dicts(fl), "a2a": a2a,
                     "counts": {k: after[k] - before[k] for k in after},
                     "armed_after": mesh_lib._FLOWS is not None}

    from repro_torch.configs import get_smoke
    cfg = get_smoke("phi3_5_moe_42b")
    model = build_model(cfg, device="cpu")
    t = Trainer(model, TrainConfig(**FLOWS_TRAIN),
                CheckpointManager(os.path.join(d, f"ck-r{rank}")))
    with runtime_mesh(m22):
        t.run(0, SyntheticLMData(cfg, 4, 16, seed=3), 2, resume=False)
    rep = t.session.report()
    out["step"] = {"step": t.recorded["step"],
                   "flows": _flow_dicts(t.recorded["flows"]),
                   "counts": t.recorded["counts"],
                   "collectives": rep.to_json()["collectives"],
                   "render": rep.render(components=("app",)),
                   "redundant": hlo_flows.find_redundant_gathers(
                       t.recorded["flows"])}
    return out


# ---------------------------------------------- family meshes (PRs 30-31) ----
#: the batch of the family checks and curves, and the curves' steps
FAMILY_BATCH = (4, 16)
FAMILY_STEPS = 3
#: per layers key: each checked layer's (name, its params' sources: (stack
#: path, leading stacked dims, the param groups it takes) each)
FAMILY_LAYERS = {
    "deepseek_v2_lite_16b": (
        ("mla", ((("stack_dense", "stack"), 1, ("attn",)),)),
        ("moe", ((("stack_moe", "stack"), 1, ("moe",)),))),
    "zamba2_2_7b": (("ssm", ((("stack", "stack"), 2, ("norm1", "ssm")),)),),
    # the patches' projection, then the first decoder layer on [prefix, x]
    "internvl2_1b": (("vlm", ((("stack", "stack"), 1,
                               ("norm1", "norm2", "attn", "mlp")),
                              ((), 0, ("frontend",)))),),
    # the first decoder layer: self-attention, cross-attention, MLP
    "seamless_m4t_large_v2": (("dec", ((("dec_stack", "stack"), 1,
                                        ("norm1", "norm2", "norm3", "attn",
                                         "cross", "mlp")),)),),
    "xlstm_1_3b": (("mlstm", ((("stack_mlstm", "stack"), 2,
                               ("norm1", "mlstm")),)),
                   ("slstm", ((("stack_slstm", "stack"), 1,
                               ("norm1", "norm2", "slstm")),))),
    "xlstm_slstm": (("slstm", ((("stack_slstm", "stack"), 1,
                                ("norm1", "norm2", "slstm")),)),),
}


@dataclasses.dataclass(frozen=True)
class FamilyCase:
    """One smoke model of a family mesh module: `arch`'s smoke config
    with the overrides `over`, its checked layers (FAMILY_LAYERS[layers],
    by default the arch's), the batch of its model checks and curves,
    and whether the model's loss, gradients and curve are checked
    (`full`) or only its layers."""
    key: str
    arch: str
    over: tuple = ()
    layers: str = ""
    batch: tuple = FAMILY_BATCH
    full: bool = True


FAMILY_CASES = {c.key: c for c in (
    FamilyCase("deepseek_v2_lite_16b", "deepseek_v2_lite_16b"),
    FamilyCase("zamba2_2_7b", "zamba2_2_7b"),
    # the smoke vlm's 16 patches go before 16 text tokens
    FamilyCase("internvl2_1b", "internvl2_1b", batch=(4, 32)),
    FamilyCase("seamless_m4t_large_v2", "seamless_m4t_large_v2"),
    FamilyCase("xlstm_1_3b", "xlstm_1_3b"),
    # d 100: the sLSTM FFN's int(100 * 4 / 3) = 133 columns do not split
    # over 'model' 2, so every rank runs it whole
    FamilyCase("xlstm_whole_ffn", "xlstm_1_3b", over=(("d_model", 100),),
               layers="xlstm_slstm", full=False))}


def case_layers(case):
    return FAMILY_LAYERS[case.layers or case.arch]


def _family_cfg(case):
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke(case.arch), **dict(case.over))


def _sub_tree(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rows(a, mesh):
    """This data rank's rows of a global array (its block over 'data')."""
    import torch
    dp, dc = mesh.size("data"), mesh.coord("data")
    B = a.shape[0]
    return torch.from_numpy(a)[dc * B // dp:(dc + 1) * B // dp]


def _apply_layer(name, tree, x, extra, model, mesh, inp):
    """(y, aux or None, table) of one checked layer at `mesh`."""
    import torch
    from repro_torch.models import encdec, layers, transformer
    from repro_torch.models import mamba as mamba_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import xlstm
    from repro_torch.parallel.axes import runtime_mesh
    rt, table = model.rt, model.table()
    positions = torch.arange(x.shape[1])
    with runtime_mesh(mesh):
        if name == "mla":
            return layers.attention(tree, x, rt, positions)[0], None, table
        if name == "moe":
            y, table, aux = moe_lib.moe(tree, x, rt, table, mode="a2a")
            return y, aux, table
        if name == "ssm":
            return mamba_lib.mamba_block(tree, x, rt)[0], None, table
        if name == "vlm":
            pre = transformer._project_patches(
                tree, _rows(inp["patches"], mesh), rt)
            h = transformer._with_prefix(x, pre)
            return transformer.decoder_layer(
                tree, h, rt, torch.arange(h.shape[1]))[0], None, table
        if name == "dec":
            return encdec._decoder_layer(tree, x, extra["src"], rt,
                                         positions), None, table
        if name == "mlstm":
            return xlstm.mlstm_block(tree, x, rt)[0], None, table
        return xlstm.slstm_block(tree, x, rt)[0], None, table


def _family_layer(inp, cfg, lay, mesh, name, sources):
    """One layer of the smoke model at `mesh` on x [B, S, d] (rows over
    'data'): y (and the MoE layer's aux and fold table) and the
    gradients of sum(y ct) (+ aux), each summed over 'data' and gathered
    to the full leaf (x's, and a decoder layer's source's, over
    'data')."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.sharding import gather_leaf, shard_leaf
    model = build_model(cfg, device="cpu")
    x = _rows(inp["x"], mesh).clone().requires_grad_()
    ct = _rows(inp.get("ct_" + name, inp["ct"]), mesh)
    extra = ({"src": _rows(inp["src"], mesh).clone().requires_grad_()}
             if name == "dec" else {})
    specs, local = {}, {}
    for path, lead, groups in sources:
        prefix = "s/params/" + "/".join(path) + ("/" if path else "")
        for n, a in inp.items():
            rel = n[len(prefix):]
            if n.startswith(prefix) and rel.split("/")[0] in groups:
                specs[rel] = _sub_tree(lay, path + tuple(rel.split("/")))[
                    lead:]
                local[rel] = shard_leaf(torch.from_numpy(a)[(0,) * lead],
                                        specs[rel], mesh
                                        ).clone().requires_grad_()
    tree = {}
    for k, v in local.items():
        node = tree
        *up, last = k.split("/")
        for u in up:
            node = node.setdefault(u, {})
        node[last] = v
    y, aux, table = _apply_layer(name, tree, x, extra, model, mesh, inp)
    loss = (y * ct).sum() + (aux if aux is not None else 0.0)
    loss.backward()
    out = {"y": y.detach(), "dx": x.grad}
    if aux is not None:
        out["aux"], out["table"] = aux.detach(), table
    for k, v in local.items():
        out["d_" + k.replace("/", "_")] = gather_leaf(mesh_lib.all_reduce(
            v.grad, mesh, "data"), specs[k], mesh)
    for k, v in extra.items():
        out["d" + k] = _gather_rows(v.grad, mesh, "data")
    out["y"] = _gather_rows(out["y"], mesh, "data")
    out["dx"] = _gather_rows(out["dx"], mesh, "data")
    return out


def _family_mesh(case, rank, world, d, meshes):
    """The smoke model of `case` at (1, 2) and (2, 2) (`meshes`): each
    checked layer's output and gradients and, for a full case, the
    model's loss, gradients and static costs and a FAMILY_STEPS-step
    Trainer run (its fold, its recorded step's flows; at (1, 2) a
    checkpoint)."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.device_fold import STATIC_COSTS
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import (build_model, params_from_numpy,
                                    train_state_from_numpy)
    from repro_torch.parallel import mesh as mesh_lib
    from repro_torch.parallel.axes import runtime_mesh
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.runtime.trainer import (Trainer, TrainLayout,
                                             full_shapes,
                                             local_value_and_grad)
    inp = dict(np.load(os.path.join(d, f"inputs-{case.key}.npz")))
    flat_state = {n[len("s/"):]: a for n, a in inp.items()
                  if n.startswith("s/")}
    cfg = _family_cfg(case)
    model = build_model(cfg, device="cpu")
    B, S = case.batch
    batch = SyntheticLMData(cfg, B, S, seed=3).generate(0)
    row = meshes["2x2"].coord("data")
    out = {}
    for tag, mesh in meshes.items():
        with runtime_mesh(mesh):
            lay = TrainLayout(model, full_shapes(cfg), mesh)
        res = {"layer": {name: _family_layer(inp, cfg, lay.param, mesh,
                                             name, sources)
                         for name, sources in case_layers(case)}}
        out[tag] = res
        if not case.full:
            continue
        params = params_from_numpy(
            {n[len("params/"):]: a for n, a in flat_state.items()
             if n.startswith("params/")}, cfg, "cpu", mesh=mesh)
        with runtime_mesh(mesh):
            STATIC_COSTS.reset()
            loss, met, table, g = local_value_and_grad(
                model, params, lay.local_rows(batch, 1), model.table(), lay)
            costs = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
            for _, x in _leaves(g):
                mesh_lib.all_reduce(x, mesh, lay.batch_axes)
            res["grads"] = {"loss": loss, "aux_loss": met["aux_loss"],
                            "table": table, "costs": costs,
                            "grads": gather_tree(g, mesh, lay.param)}
            tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2,
                               total_steps=FAMILY_STEPS,
                               ckpt_interval=FAMILY_STEPS)
            state = lay.shard_state(train_state_from_numpy(flat_state, cfg,
                                                           "cpu"))
            t = Trainer(model, tcfg, CheckpointManager(
                os.path.join(d, f"ck-{case.key}-{tag}-row{row}")))
            st, _ = t.run(0, SyntheticLMData(cfg, B, S, seed=3),
                          FAMILY_STEPS, resume=False, state=state)
            res["curve"] = {"loss": [h["loss"] for h in t.history],
                            "aux_loss": [h["aux_loss"] for h in t.history],
                            "grad_norm": [h["grad_norm"] for h in t.history],
                            "state": lay.gather_state(st),
                            "fold": t.session.device_fold.to_json(),
                            "flows": _flow_dicts(t.recorded["flows"]),
                            "counts": t.recorded["counts"]}
    return out


def _family_meshes():
    from repro_torch.parallel import mesh as mesh_lib
    m22 = mesh_lib.make_mesh((2, 2), ("data", "model"))
    return {"1x2": _sub_mesh(m22), "2x2": m22}


def mla_mesh(rank, world, d):
    return _family_mesh(FAMILY_CASES["deepseek_v2_lite_16b"], rank, world,
                        d, _family_meshes())


def hybrid_mesh(rank, world, d):
    return _family_mesh(FAMILY_CASES["zamba2_2_7b"], rank, world, d,
                        _family_meshes())


#: the cases of tests/test_torch_vlm_audio_ssm_mesh.py, in order
VLM_AUDIO_SSM = ("internvl2_1b", "seamless_m4t_large_v2", "xlstm_1_3b",
                 "xlstm_whole_ffn")


def vlm_audio_ssm_mesh(rank, world, d):
    meshes = _family_meshes()
    return {key: _family_mesh(FAMILY_CASES[key], rank, world, d, meshes)
            for key in VLM_AUDIO_SSM}


PROGRAMS = {"parallel": parallel, "training": training,
            "layer_cuda": layer_cuda, "p2p_cuda": p2p_cuda,
            "moe_mesh": moe_mesh, "flows": flows,
            "mla_mesh": mla_mesh, "hybrid_mesh": hybrid_mesh,
            "vlm_audio_ssm_mesh": vlm_audio_ssm_mesh}
