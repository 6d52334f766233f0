"""Decoder-only dense transformer LM: params, cache and forward_chunk.

The PyTorch counterpart of `repro/models/transformer.py` for
family="dense".  Layer params are stacked [L, ...] under
p["stack"]["stack"], as the reference's scan-over-layers lays them out,
and the KV cache is stacked [L, B, Hkv, S, h].  Where the reference scans
one traced layer body (and scales its static costs by L), the port runs
an explicit loop over the L layers: each layer registers its own costs,
so the loop is NOT wrapped in scan_multiplier.

Prefill and decode share ONE positioned-chunk body (forward_chunk): a
chunk of T tokens lands at per-row cache offsets, T = 1 being the pooled
decode tick and pos = 0, T = S bulk prefill.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import (Params, Runtime, attention, embed, init_kv_cache,
                     last_valid, lm_head, mlp, norm, torch_dtype)

#: init scale marker: ones (norm scales) instead of a scaled normal
ONES = "ones"


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict mirroring the params: each leaf is (shape, scale), with
    scale the normal's std (fan_in ** -0.5 by default, 1.0 for the
    embedding — the reference's layers._init) or ONES for norm scales.
    Stacked layer leaves carry the leading L."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported "
                                  f"yet (dense only)")
    d, h, L, f = cfg.d_model, cfg.head_dim_, cfg.n_layers, cfg.d_ff

    def w(fan_in, *shape):
        return (shape, fan_in ** -0.5)

    attn = {"wq": w(d, L, d, cfg.n_heads * h),
            "wk": w(d, L, d, cfg.n_kv_heads * h),
            "wv": w(d, L, d, cfg.n_kv_heads * h),
            "wo": w(cfg.n_heads * h, L, cfg.n_heads * h, d)}
    if cfg.qk_norm:
        attn["q_norm"] = ((L, h), ONES)
        attn["k_norm"] = ((L, h), ONES)
    mlp_p = {"w_up": w(d, L, d, f), "w_down": w(f, L, f, d)}
    if cfg.mlp_gated:
        mlp_p["w_gate"] = w(d, L, d, f)
    specs: Dict[str, Any] = {
        "embed": {"table": ((cfg.vocab, d), 1.0)},
        "final_norm": {"scale": ((d,), ONES)},
        "stack": {"stack": {"norm1": {"scale": ((L, d), ONES)},
                            "norm2": {"scale": ((L, d), ONES)},
                            "attn": attn, "mlp": mlp_p}},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": w(d, d, cfg.vocab)}
    return specs


def map_specs(fn, specs, path: str = ""):
    """Apply fn(path, (shape, scale)) to every leaf of a spec tree."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, f"{path}/{k}" if path else k)
                for k, v in specs.items()}
    return fn(path, specs)


def init_params(cfg: ModelConfig, seed: int, device: torch.device) -> Params:
    """Seeded random params with the reference's distributions: normal
    draws in f32 times the leaf's scale, cast to cfg.param_dtype."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = torch_dtype(cfg.param_dtype)

    def leaf(_, spec):
        shape, scale = spec
        if scale == ONES:
            return torch.ones(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale).to(dtype)
    return map_specs(leaf, param_specs(cfg))


def _layer(stack: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def decoder_layer(p: Params, x: torch.Tensor, rt: Runtime,
                  positions: torch.Tensor, cache: Params, pos: torch.Tensor
                  ) -> torch.Tensor:
    """Pre-norm block; writes this layer's cache rows in place."""
    h = norm(p["norm1"], x, rt)
    a, _ = attention(p, h, rt, positions, cache, pos)
    x = x + a
    h = norm(p["norm2"], x, rt)
    return x + mlp(p, h, rt)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype: Optional[torch.dtype] = None
               ) -> Params:
    dtype = dtype or torch_dtype(cfg.compute_dtype)
    return init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, device)


def forward_chunk(p: Params, tokens: torch.Tensor, rt: Runtime, table,
                  cache: Params, pos: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Params, Any]:
    """THE serving entry point: write a T-token chunk at per-slot offsets.

    tokens: [B, T]; pos: [B] int32 per-slot cache depths (a scalar
    broadcasts); valid: [B] real tokens of the chunk (None = T;
    bucket-padded chunks mask the pad).  The cache is updated in place.
    `table` is the device fold table, passed through unchanged (the
    in-graph fold is not ported yet).
    Returns (last-valid-token logits [B, V], cache, table)."""
    dev = rt.device
    tokens = torch.as_tensor(tokens, device=dev)
    x = embed(p, tokens, rt)
    B, T = x.shape[:2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B) \
        .contiguous()
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev)
    stack = p["stack"]["stack"]
    for i in range(rt.cfg.n_layers):
        x = decoder_layer(_layer(stack, i), x, rt, positions,
                          {"k": cache["k"][i], "v": cache["v"][i]}, pos)
    x = norm(p["final_norm"], x, rt)
    logits = lm_head(p, last_valid(x, valid), rt)[:, 0]
    return logits, cache, table


def prefill(p: Params, tokens: torch.Tensor, rt: Runtime, table,
            cache: Params):
    """Bulk prefill = forward_chunk at offset 0 with T = prompt length."""
    zero = torch.zeros((tokens.shape[0],), dtype=torch.int32,
                       device=rt.device)
    return forward_chunk(p, tokens, rt, table, cache, zero)


def decode_step(p: Params, token: torch.Tensor, rt: Runtime, table,
                cache: Params, pos: torch.Tensor):
    """Pooled decode = forward_chunk at width T = 1.  token: [B]."""
    token = torch.as_tensor(token, device=rt.device)
    return forward_chunk(p, token[:, None], rt, table, cache, pos)
