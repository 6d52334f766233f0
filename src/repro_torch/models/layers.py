"""Dense-transformer building blocks on torch tensors, params as dicts.

The PyTorch counterpart of `repro/models/layers.py` for the dense family:
the same param names and layouts (the reference's leaf names load as
they are), the same dtype policy (params in cfg.param_dtype, compute in
cfg.compute_dtype, reductions and softmax in f32) and the same static
cost edges.  Kernel hot spots route through `repro_torch.kernels.ops`.

KV caches are updated IN PLACE: `update_cache_rows` writes the fresh
rows into the cache tensor it is given, where the reference returns a
new array that jit donation lets XLA write in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.device_fold import annotate_cost
from ..kernels import ops

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Per-call runtime knobs threaded alongside the config."""
    cfg: ModelConfig
    device: torch.device
    impl: str = "auto"            # kernel impl: auto | kernel | ref

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)


# ------------------------------------------------------------------ misc ----
def linear(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p.to(x.dtype))


def norm(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps=rt.cfg.norm_eps, impl=rt.impl)


# ------------------------------------------------------------------ rope ----
def rope_tables(cfg: ModelConfig, positions: torch.Tensor, dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [S] (or [B, S]) -> cos/sin [..., S, dim//2], f32."""
    half = dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                   device=positions.device), -idx / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., S, D]; cos/sin broadcastable to [..., S, D//2]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention ----
def update_cache_rows(dst: torch.Tensor, src: torch.Tensor,
                      pos: torch.Tensor, seq_axis: int = 2) -> torch.Tensor:
    """Row-range cache scatter at per-row offsets, IN PLACE: row b of
    `src` (length T along `seq_axis`) lands at [start[b], start[b]+T) of
    `dst`'s seq_axis, with start = clamp(pos[b], 0, S - T) — the start
    clamp of the reference's dynamic_update_slice, so an overrun shifts
    the write onto earlier entries exactly as there (callers keep
    pos[b] + T within the row).  dst: [B, ...]; src: [B, ...]; pos: [B].
    Returns dst."""
    B, S, T = dst.shape[0], dst.shape[seq_axis], src.shape[seq_axis]
    start = torch.clamp(pos.long(), 0, S - T)
    idx = start[:, None] + torch.arange(T, device=dst.device)[None, :]
    rows = torch.arange(B, device=dst.device)[:, None]
    # seq axis next to batch: advanced indices [B, T] pick (row, position)
    dst.movedim(seq_axis, 1)[rows, idx] = src.movedim(seq_axis, 1).to(
        dst.dtype)
    return dst


def last_valid(x: torch.Tensor, valid: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """x: [B, T, d] -> [B, 1, d] at each row's last VALID position (a
    bucket-padded chunk carries valid: [B] real-token counts)."""
    if valid is None:
        return x[:, -1:]
    last = torch.clamp(valid.long() - 1, 0, x.shape[1] - 1)
    return torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[2]))


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int, dtype: torch.dtype,
                  device: torch.device) -> Params:
    """Stacked KV cache: k, v [n_layers, batch, Hkv, max_len, head_dim]."""
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention(p: Params, x: torch.Tensor, rt: Runtime,
              positions: torch.Tensor, cache: Params, pos: torch.Tensor
              ) -> Tuple[torch.Tensor, Params]:
    """GQA/MQA (optionally qk-norm) self-attention in positioned-chunk
    mode.  x: [B, S, d]; positions: [B, S] per-row rope positions; cache:
    one layer's {"k", "v"} [B, Hkv, S_max, h], updated in place at
    [pos, pos+S) per row; pos: [B] int32.  S == 1 is the pooled decode
    step (decode kernel), S > 1 a prefill chunk (chunk kernel).
    Returns (y [B, S, d], cache)."""
    cfg = rt.cfg
    ap = p["attn"]
    B, S, d = x.shape
    h = cfg.head_dim_
    q = linear(ap["wq"], x).reshape(B, S, cfg.n_heads, h)
    k = linear(ap["wk"], x).reshape(B, S, cfg.n_kv_heads, h)
    v = linear(ap["wv"], x).reshape(B, S, cfg.n_kv_heads, h)
    annotate_cost("attention", "attention", "qkv_proj",
                  flops=2.0 * B * S * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * h)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, ap["q_norm"], eps=cfg.norm_eps, impl=rt.impl)
        k = ops.rmsnorm(k, ap["k_norm"], eps=cfg.norm_eps, impl=rt.impl)
    cos, sin = rope_tables(cfg, positions, h)
    cos, sin = cos[:, None], sin[:, None]                # [B, 1, S, h/2]
    q = apply_rope(q.transpose(1, 2), cos, sin)          # [B, Hq, S, h]
    k = apply_rope(k.transpose(1, 2), cos, sin)
    v = v.transpose(1, 2)
    ck = update_cache_rows(cache["k"], k, pos)
    cv = update_cache_rows(cache["v"], v, pos)
    if S == 1:                 # decode width: flash-decode kernel
        o = ops.decode_attention(q[:, :, 0], ck, cv, kv_len=pos + 1,
                                 impl=rt.impl)
        o = o.reshape(B, 1, cfg.n_heads * h)
    else:                      # prefill chunk at per-row offsets
        o = ops.chunk_attention(q, ck, cv, pos=pos, impl=rt.impl)
        o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * h)
    y = linear(ap["wo"], o)
    annotate_cost("attention", "attention", "o_proj",
                  flops=2.0 * B * S * cfg.n_heads * h * d)
    return y, {"k": ck, "v": cv}


# ------------------------------------------------------------------- mlp ----
def mlp(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    mp = p["mlp"]
    cfg = rt.cfg
    up = linear(mp["w_up"], x)
    if cfg.mlp_gated:
        act = F.silu(linear(mp["w_gate"], x).float())
        hidden = (act * up.float()).to(x.dtype)
    else:
        hidden = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    y = linear(mp["w_down"], hidden)
    f = mp["w_up"].shape[-1]
    nmat = 3 if cfg.mlp_gated else 2
    annotate_cost("mlp", "mlp", "ffn",
                  flops=2.0 * x.shape[0] * x.shape[1] * cfg.d_model * f * nmat)
    return y


# ----------------------------------------------------------------- embed ----
def embed(p: Params, tokens: torch.Tensor, rt: Runtime) -> torch.Tensor:
    x = p["embed"]["table"][tokens.long()].to(rt.cdtype)
    annotate_cost("embed", "embed", "lookup", bytes=float(x.numel() * 2))
    return x


def lm_head(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    w = (p["embed"]["table"].T if rt.cfg.tie_embeddings
         else p["lm_head"]["w"])
    logits = torch.matmul(x, w.to(x.dtype))
    annotate_cost("lm_head", "lm_head", "proj",
                  flops=2.0 * x.shape[0] * x.shape[1] * rt.cfg.d_model
                  * rt.cfg.vocab)
    return logits
