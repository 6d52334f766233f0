"""Mixture-of-Experts layer: top-k routing, capacity dispatch and the
expert-parallel all-to-all, on torch.

The port of `repro/models/moe.py`: the same param names and layouts
(`moe/{router, w_gate, w_up, w_down}` and `moe/shared/*`), the same
routing (f32 router logits, softmax, top-k, renormalised gates, the
Switch load-balance aux loss over all k choices, the router z-loss) and
the same static cost edges, in the reference's two modes:

  * 'dense' (one device): the capacity C = max(4, int(T top_k / E
    capacity_factor)) over the T = B S tokens of the call, pad rows
    included;
  * 'a2a' (the default under a mesh whose expert axis, 'model', has
    ep > 1 ranks): each model rank takes its 1/ep block of its data
    rank's tokens (the activations are replicated over 'model'; the
    shard of the reference's token axes (pod, data, model)), routes
    them into [E, C_loc, d] at the per-shard capacity C_loc = max(8,
    int(t_loc top_k / E capacity_factor)), sends each expert's rows to
    the rank holding it with one all-to-all over 'model', runs its E / ep
    experts on [E / ep, ep C_loc, d], returns the results by the inverse
    all-to-all, combines them and all-gathers its rows over 'model', so
    the next layer again gets the replicated activation
    (`parallel/tp.py`: `split_rows`, `all_to_all`, `gather_rows`).  The
    router is replicated: its gradient is summed over 'model' (`copy_to`).
    As in the reference, the fold's load and drops are summed over all
    token shards and aux and z averaged over them (with aux and z's
    gradients, one all-reduce a mesh axis), so every rank holds the
    global fold.  The two modes drop different choices at a binding
    capacity; drop-free they compute one function.

Dispatch is the reference's sort + scatter form (`_local_dispatch` /
`_local_combine`, which its tests hold equal to the GShard one-hot
einsums of `_moe_dense`): the T k choices in flattened (t, k) order are
stably sorted by expert, each takes its rank inside its expert, and a
choice of rank >= C is dropped.  Every shape is fixed ([E, C, d]
buffers, one sink row for the dropped choices) and nothing waits for
the device: the per-expert counts are a scatter-add, the ranks a
cumsum, and no size depends on the data.  Routing is deterministic
(torch.topk, a stable sort), so a recompute under remat routes exactly
as the first run did.

The expert products are batched matmuls over [E, C, d], as the
reference computes them with einsum outside any Pallas kernel.  The
reference's dense mode under a mesh that splits the tokens or the
experts (GSPMD's global capacity over sharded tokens) is not ported: it
raises, naming the a2a mode.

XFA: the layer emits the data-dependent signals into the device fold
table (`DeviceFoldSpec`): per-expert load (choices routed, before
capacity), dropped choices, the router's aux and z losses, and one
count per call, all detached.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import hlo_flows
from ..core.device_fold import DeviceFoldSpec, annotate_cost
from ..parallel import tp
from ..parallel.axes import axis_size, get_runtime_mesh, mesh_axes
from .layers import Params, Runtime, linear

MOE_CALLER = "decoder"


def declare_moe_slots(spec: DeviceFoldSpec, cfg: ModelConfig) -> None:
    spec.declare(MOE_CALLER, "moe", "dispatch", "expert_load", cfg.n_experts)
    spec.declare(MOE_CALLER, "moe", "dispatch", "dropped_tokens")
    spec.declare(MOE_CALLER, "moe", "router", "aux_loss")
    spec.declare(MOE_CALLER, "moe", "router", "z_loss")
    spec.declare(MOE_CALLER, "moe", "dispatch", "count")


def param_specs(cfg: ModelConfig, L: int) -> Dict[str, Any]:
    """Spec leaves (shape, scale) of the MoE params of a stack of L
    layers, with the reference's inits: its `_init` takes fan_in as a
    weight's FIRST dim, so the router is drawn at d ** -0.5, the expert
    weights [E, d, f] and [E, f, d] at E ** -0.5, and the shared
    experts' at their input width ** -0.5."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    p: Dict[str, Any] = {"router": ((L, d, e), d ** -0.5),
                         "w_gate": ((L, e, d, f), e ** -0.5),
                         "w_up": ((L, e, d, f), e ** -0.5),
                         "w_down": ((L, e, f, d), e ** -0.5)}
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"w_gate": ((L, d, fs), d ** -0.5),
                       "w_up": ((L, d, fs), d ** -0.5),
                       "w_down": ((L, fs, d), fs ** -0.5)}
    return {"moe": p}


def _router(router_w: torch.Tensor, x2: torch.Tensor, cfg: ModelConfig):
    """x2: [T, d] -> (gates [T, K] f32, idx [T, K], per-expert counts [E]
    int64, aux, z)."""
    logits = torch.matmul(x2.float(), router_w.float())          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)              # renormalise
    # Switch-style load-balance aux (over all K choices) + router z-loss
    T, E = probs.shape
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=x2.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    f_e = counts.float() / T
    p_e = probs.mean(dim=0)
    aux = E * torch.sum(f_e * p_e) / cfg.top_k
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, idx, counts, aux, z


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """xb: [E, C, d] -> [E, C, d]; SwiGLU per expert, silu in f32."""
    g = torch.bmm(xb, w_gate.to(xb.dtype))
    u = torch.bmm(xb, w_up.to(xb.dtype))
    h = (F.silu(g.float()) * u.float()).to(xb.dtype)
    return torch.bmm(h, w_down.to(xb.dtype))


def _dispatch(idx: torch.Tensor, counts: torch.Tensor, C: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity slots of the T K choices idx [T, K]: each choice's rank
    inside its expert in flattened (t, k) order (a stable sort by expert),
    its buffer row e C + rank when rank < C, else the sink row E C.
    Returns (rows [T K] int64, keep [T K] bool)."""
    E = counts.shape[0]
    flat = idx.reshape(-1)
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    offsets = torch.cumsum(counts, 0) - counts                   # exclusive
    rank_sorted = torch.arange(n, device=flat.device) - offsets[flat[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < C
    rows = torch.where(keep, flat * C + rank, E * C)
    return rows, keep


def _capacity_dispatch(router_w, x2: torch.Tensor, cfg: ModelConfig,
                       C: int, ffn):
    """Route x2 [T, d], dispatch into [E, C, d] (plus the sink row),
    run ffn on the buffer and combine.  Returns (y [T, d] f32, counts
    [E], dropped choices, aux, z)."""
    T, d = x2.shape
    E, K = cfg.n_experts, cfg.top_k
    gates, idx, counts, aux, z = _router(router_w, x2, cfg)
    rows, keep = _dispatch(idx, counts, C)
    # the [E, C, d] buffer plus the sink row the dropped choices write
    xk = x2[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = x2.new_zeros((E * C + 1, d)).index_copy(0, rows, xk)
    yb = ffn(buf[:E * C].view(E, C, d))
    # combine in f32, weighted by the gates; a dropped choice reads the
    # zero sink row with weight 0
    yflat = torch.cat([yb.reshape(E * C, d), yb.new_zeros((1, d))])
    w = torch.where(keep, gates.reshape(-1), 0.0).view(T, K, 1)
    y2 = (yflat.index_select(0, rows).view(T, K, d).float() * w).sum(dim=1)
    return y2, counts, (~keep).sum(), aux, z


def _a2a_experts(mp, xb: torch.Tensor, mesh, axis: str, ep: int
                 ) -> torch.Tensor:
    """xb [E, C, d] (this shard's capacity buffer, experts in order) ->
    [E, C, d]: each expert's rows run by the rank of `axis` holding it,
    there and back by all-to-all."""
    E, C, d = xb.shape
    e_loc = E // ep
    recv = tp.all_to_all(xb, mesh, axis)          # [ep (source), e_loc, C, d]
    xl = recv.view(ep, e_loc, C, d).transpose(0, 1).reshape(e_loc, ep * C, d)
    yl = _expert_ffn(mp["w_gate"], mp["w_up"], mp["w_down"], xl)
    back = yl.view(e_loc, ep, C, d).transpose(0, 1).reshape(E, C, d)
    return tp.all_to_all(back, mesh, axis)


@hlo_flows.scoped("moe")
def moe(p: Params, x: torch.Tensor, rt: Runtime, table, mode: str = "auto"
        ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """x: [B, S, d] -> (y, updated fold table, aux loss).  `table` None
    folds nothing.  mode: auto (a2a under a mesh with an expert axis of
    more than one rank that divides the experts and this rank's tokens,
    else dense), a2a or dense (see the module docstring)."""
    cfg = rt.cfg
    mp = p["moe"]
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    mesh = get_runtime_mesh()
    ep, dp = axis_size("expert"), axis_size("batch")
    if mode not in ("auto", "a2a", "dense"):
        raise ValueError(f"mode must be auto, a2a or dense, got {mode!r}")
    fits = E % ep == 0 and T % ep == 0
    use_a2a = mode == "a2a" or (mode == "auto" and mesh is not None
                                and ep > 1 and fits)
    x2 = x.reshape(T, d)
    if use_a2a:
        if not fits:
            raise ValueError(f"the a2a mode splits {E} experts and {T} "
                             f"tokens {ep} ways")
        ep_axes = mesh_axes("expert")
        axis = ep_axes[0] if ep_axes else "model"
        t_loc = T // ep
        C = max(8, int(t_loc * cfg.top_k / E * cfg.capacity_factor))
        router = tp.copy_to(mp["router"], mesh, axis) if ep > 1 \
            else mp["router"]
        y_loc, counts, dropped, aux, z = _capacity_dispatch(
            router, tp.split_rows(x2, mesh, axis), cfg, C,
            lambda xb: _a2a_experts(mp, xb, mesh, axis, ep))
        y2 = tp.gather_rows(y_loc.to(x2.dtype), mesh, axis)
        # the global fold: load and drops summed over every token shard,
        # aux and z averaged (with their gradients)
        token_axes = tuple(a for a in ("pod", "data", "model")
                           if mesh is not None and a in mesh.axis_names)
        fold = tp.reduce_from(torch.cat([
            counts.float(), dropped.float()[None], aux[None], z[None]]),
            mesh, token_axes)
        n_shards = dp * ep
        counts, dropped = fold[:E].detach(), fold[E].detach()
        aux, z = fold[E + 1] / n_shards, fold[E + 2] / n_shards
    else:
        if mesh is not None and (ep > 1 or dp > 1):
            raise NotImplementedError(
                f"the dense MoE dispatch over tokens or experts split by a "
                f"mesh (expert axis {ep}, batch {dp}) is not ported: under "
                f"a mesh the port runs the a2a mode (an expert axis of more "
                f"than one rank dividing {E} experts and {T} tokens)")
        C = max(4, int(T * cfg.top_k / E * cfg.capacity_factor))
        y2, counts, dropped, aux, z = _capacity_dispatch(
            mp["router"], x2, cfg, C,
            lambda xb: _expert_ffn(mp["w_gate"], mp["w_up"], mp["w_down"],
                                   xb))
        y2 = y2.to(x2.dtype)
    annotate_cost(MOE_CALLER, "moe", "expert_ffn",
                  flops=6.0 * T * cfg.top_k * d * cfg.moe_d_ff)

    if cfg.n_shared_experts:
        sp = mp["shared"]
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        split = tp.split_over_model(sp["w_up"].shape[-1], fs)
        xs = tp.copy_to_model(x2) if split else x2
        g = F.silu(linear(sp["w_gate"], xs).float())
        u = linear(sp["w_up"], xs).float()
        h = (g * u).to(x2.dtype)
        y2 = y2 + (tp.row_parallel(h, sp["w_down"]) if split
                   else linear(sp["w_down"], h))
        annotate_cost(MOE_CALLER, "moe", "shared_ffn",
                      flops=6.0 * T * d * fs)

    if rt.fold_spec is not None and table is not None:
        emit = rt.fold_spec.emit
        table = emit(table, MOE_CALLER, "moe", "dispatch", "expert_load",
                     counts)
        table = emit(table, MOE_CALLER, "moe", "dispatch", "dropped_tokens",
                     dropped)
        table = emit(table, MOE_CALLER, "moe", "router", "aux_loss", aux)
        table = emit(table, MOE_CALLER, "moe", "router", "z_loss", z)
        table = emit(table, MOE_CALLER, "moe", "dispatch", "count", 1.0)
    aux_total = (cfg.router_aux_weight * aux + 1e-4 * z).float()
    return y2.reshape(B, S, d), table, aux_total
