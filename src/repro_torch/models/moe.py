"""Mixture-of-Experts layer: top-k routing and capacity dispatch, on torch.

The port of `repro/models/moe.py`, single-device path: the same param
names and layouts (`moe/{router, w_gate, w_up, w_down}` and
`moe/shared/*`), the same routing (f32 router logits, softmax, top-k,
renormalised gates, the Switch load-balance aux loss over all k choices,
the router z-loss), the same capacity C = max(4, int(T top_k / E
capacity_factor)) over the T = B S tokens of the call, pad rows
included, and the same static cost edges.

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
reference's all-to-all mode (`shard_map` over an expert-parallel mesh)
is not ported: the port runs on one device.

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
from ..core.device_fold import DeviceFoldSpec, annotate_cost
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


def moe(p: Params, x: torch.Tensor, rt: Runtime, table
        ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """x: [B, S, d] -> (y, updated fold table, aux loss).  `table` None
    folds nothing."""
    cfg = rt.cfg
    mp = p["moe"]
    B, S, d = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    C = max(4, int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    x2 = x.reshape(T, d)
    gates, idx, counts, aux, z = _router(mp["router"], x2, cfg)
    rows, keep = _dispatch(idx, counts, C)
    # the [E, C, d] buffer plus the sink row the dropped choices write
    xk = x2[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = x2.new_zeros((E * C + 1, d)).index_copy(0, rows, xk)
    yb = _expert_ffn(mp["w_gate"], mp["w_up"], mp["w_down"],
                     buf[:E * C].view(E, C, d))
    # combine in f32, weighted by the gates; a dropped choice reads the
    # zero sink row with weight 0
    yflat = torch.cat([yb.reshape(E * C, d), yb.new_zeros((1, d))])
    w = torch.where(keep, gates.reshape(-1), 0.0).view(T, K, 1)
    y2 = (yflat.index_select(0, rows).view(T, K, d).float() * w).sum(dim=1)
    annotate_cost(MOE_CALLER, "moe", "expert_ffn",
                  flops=6.0 * T * cfg.top_k * d * cfg.moe_d_ff)

    y2 = y2.to(x2.dtype)
    if cfg.n_shared_experts:
        sp = mp["shared"]
        g = F.silu(linear(sp["w_gate"], x2).float())
        u = linear(sp["w_up"], x2).float()
        y2 = y2 + linear(sp["w_down"], (g * u).to(x2.dtype))
        annotate_cost(MOE_CALLER, "moe", "shared_ffn",
                      flops=6.0 * T * d * cfg.moe_d_ff * cfg.n_shared_experts)

    if rt.fold_spec is not None and table is not None:
        emit = rt.fold_spec.emit
        table = emit(table, MOE_CALLER, "moe", "dispatch", "expert_load",
                     counts)
        table = emit(table, MOE_CALLER, "moe", "dispatch", "dropped_tokens",
                     (~keep).sum())
        table = emit(table, MOE_CALLER, "moe", "router", "aux_loss", aux)
        table = emit(table, MOE_CALLER, "moe", "router", "z_loss", z)
        table = emit(table, MOE_CALLER, "moe", "dispatch", "count", 1.0)
    aux_total = (cfg.router_aux_weight * aux + 1e-4 * z).float()
    return y2.reshape(B, S, d), table, aux_total
