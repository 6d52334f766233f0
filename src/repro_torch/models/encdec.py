"""Encoder-decoder transformer (seamless-m4t-large-v2's backbone): params,
training loss, cache and forward_chunk.

The PyTorch counterpart of `repro/models/encdec.py` (family="audio"): the
same param names, layouts and dtypes (the reference's leaf names load as
they are), the same cache layout and the same static cost edges.

The speech frontend is a stub, as in the reference: a batch carries
precomputed frame features, frames [B, S_src, frontend_dim], and one
learned projection p["frontend"]["w"] [frontend_dim, d_model] maps them
into the model (it registers no static cost, as there).  Encoder:
bidirectional self-attention with rope, then the MLP, over
p["enc_stack"]["stack"] [enc_layers, ...], and a final norm
p["enc_norm"].  Decoder: causal self-attention, cross-attention over the
encoder output (p["dec_stack"]["stack"]["cross"]["attn"], no rope, never
causal), then the MLP, over p["dec_stack"]["stack"] [dec_layers, ...].
Where the reference scans one traced layer body and scales its static
costs by the layer count, the port runs a loop over the layers, each
registering its own costs.

Training (`forward`, `loss_fn`) runs both stacks without a cache: the
encoder and the cross-attention through the flash pair non-causal, the
decoder's self-attention causal; each layer rematerialized per cfg.remat
(transformer._remat), each stacked leaf taken apart once
(transformer._unstack).

Serving: `init_cache(cfg, batch, max_len, src_len)` holds, per decoder
layer, the self-attention K/V {"k", "v"} [L, B, Hkv, max_len, hd] and the
cross-attention K/V {"xk", "xv"} [L, B, Hkv, src_len, hd].
`forward_chunk` with `frames` (the pos = 0 chunk of fresh requests)
encodes the source once and writes every row's cross K/V of every layer
IN PLACE; later chunks and decode ticks read them as they lie.  The
cross-attention of a T > 1 chunk runs non-causal `ops.attention`
against them, a T = 1 tick `ops.decode_attention` at kv_len = src_len for
every row.  There are no paged entry points, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.device_fold import DeviceFoldSpec
from ..kernels import ops
from .layers import (Params, Runtime, attention, embed, last_valid, linear,
                     lm_head, mlp, norm, torch_dtype)
from .transformer import (ONES, _layer, _layer_specs, _project_patches,
                          _remat, _unstack, init_from_specs, lm_loss)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Spec tree of the enc-dec params (see transformer.param_specs): the
    embedding and lm head, the final and encoder norms, the frontend
    projection at frontend_dim ** -0.5, the encoder stack (norm1, norm2,
    attn, mlp) and the decoder stack, which adds norm3 and the
    cross-attention's own projections under "cross"."""
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name}: not an enc-dec (audio) config")
    d, f = cfg.d_model, cfg.frontend_dim
    enc = _layer_specs(cfg, "dense", cfg.enc_layers)
    dec = _layer_specs(cfg, "dense", cfg.dec_layers)
    dec["norm3"] = {"scale": ((cfg.dec_layers, d), ONES)}
    dec["cross"] = {"attn": _layer_specs(cfg, "dense",
                                         cfg.dec_layers)["attn"]}
    specs: Dict[str, Any] = {
        "embed": {"table": ((cfg.vocab, d), 1.0)},
        "final_norm": {"scale": ((d,), ONES)},
        "enc_norm": {"scale": ((d,), ONES)},
        "frontend": {"w": ((f, d), f ** -0.5)},
        "enc_stack": {"stack": enc},
        "dec_stack": {"stack": dec},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ((d, cfg.vocab), d ** -0.5)}
    return specs


def init_params(cfg: ModelConfig, seed: int, device: torch.device) -> Params:
    return init_from_specs(param_specs(cfg), cfg, seed, device)


# ------------------------------------------------------------- encoder ----
def _encoder_layer(layer_p: Params, x: torch.Tensor, rt: Runtime,
                   positions: torch.Tensor) -> torch.Tensor:
    h = norm(layer_p["norm1"], x, rt)
    a, _ = attention(layer_p, h, rt, positions, causal=False)
    x = x + a
    h = norm(layer_p["norm2"], x, rt)
    return x + mlp(layer_p, h, rt)


def encode(p: Params, frames, rt: Runtime) -> torch.Tensor:
    """frames [B, S_src, frontend_dim] (numpy or a tensor) -> the encoder
    output [B, S_src, d] after enc_norm."""
    cfg = rt.cfg
    x = _project_patches(p, frames, rt)
    positions = torch.arange(x.shape[1], device=rt.device)
    body = _remat(lambda lp, h: _encoder_layer(lp, h, rt, positions), cfg)
    for layer_p in _unstack(p["enc_stack"]["stack"], cfg.enc_layers):
        x = body(layer_p, x)
    return norm(p["enc_norm"], x, rt)


# ------------------------------------------------------------- training ----
def _decoder_layer(layer_p: Params, x: torch.Tensor, enc_out: torch.Tensor,
                   rt: Runtime, positions: torch.Tensor) -> torch.Tensor:
    h = norm(layer_p["norm1"], x, rt)
    a, _ = attention(layer_p, h, rt, positions, causal=True)
    x = x + a
    h = norm(layer_p["norm2"], x, rt)
    a, _ = attention(layer_p["cross"], h, rt, positions, kv=enc_out,
                     causal=False)
    x = x + a
    h = norm(layer_p["norm3"], x, rt)
    return x + mlp(layer_p, h, rt)


def decode_train(p: Params, tokens, enc_out: torch.Tensor, rt: Runtime,
                 table) -> Tuple[torch.Tensor, Any]:
    """tokens [B, S] against the encoder output -> (hidden [B, S, d]
    after the final norm, table)."""
    cfg = rt.cfg
    x = embed(p, torch.as_tensor(tokens, device=rt.device), rt)
    positions = torch.arange(x.shape[1], device=rt.device)
    body = _remat(lambda lp, h, e: _decoder_layer(lp, h, e, rt, positions),
                  cfg)
    for layer_p in _unstack(p["dec_stack"]["stack"], cfg.dec_layers):
        x = body(layer_p, x, enc_out)
    return norm(p["final_norm"], x, rt), table


def forward(p: Params, tokens, rt: Runtime, table, frames):
    """(hidden [B, S, d], table, aux = 0) of the decoder over tokens
    [B, S] against the encoded frames."""
    x, table = decode_train(p, tokens, encode(p, frames, rt), rt, table)
    return x, table, torch.zeros((), dtype=torch.float32, device=rt.device)


def loss_fn(p: Params, batch: Dict[str, Any], rt: Runtime, table):
    """The decoder's causal LM loss (see `transformer.lm_loss`) on
    batch tokens, labels, mask [B, S] and frames [B, S_src,
    frontend_dim]."""
    frames = batch["frames"]
    return lm_loss(lambda p_, tokens, rt_, table_: forward(
        p_, tokens, rt_, table_, frames), p, batch, rt, table)


# -------------------------------------------------------------- serving ----
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, src_len: int = 0,
               dtype: Optional[torch.dtype] = None) -> Params:
    """{"k", "v": [dec_layers, B, Hkv, max_len, hd], "xk", "xv":
    [dec_layers, B, Hkv, src_len or max_len, hd]}."""
    dtype = dtype or torch_dtype(cfg.compute_dtype)
    L, hd, src = cfg.dec_layers, cfg.head_dim_, src_len or max_len

    def z(n):
        return torch.zeros((L, batch, cfg.n_kv_heads, n, hd), dtype=dtype,
                           device=device)
    return {"k": z(max_len), "v": z(max_len), "xk": z(src), "xv": z(src)}


def _cross_kv(layer_p: Params, enc_out: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K/V from the encoder output: [B, Hkv,
    S_src, hd] each (views; no static cost, as in the reference)."""
    B, Sk, _ = enc_out.shape
    hd = cfg.head_dim_
    ap = layer_p["cross"]["attn"]
    k = linear(ap["wk"], enc_out).reshape(B, Sk, cfg.n_kv_heads, hd)
    v = linear(ap["wv"], enc_out).reshape(B, Sk, cfg.n_kv_heads, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def _cross_attention(layer_p: Params, h: torch.Tensor, xk: torch.Tensor,
                     xv: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """h [B, T, d] against one layer's cross cache xk, xv [B, Hkv, S_src,
    hd]: the decode kernel at kv_len = S_src for T = 1, non-causal
    attention otherwise.  Returns [B, T, d]."""
    cfg = rt.cfg
    B, T, _ = h.shape
    hd = cfg.head_dim_
    ap = layer_p["cross"]["attn"]
    q = linear(ap["wq"], h).reshape(B, T, cfg.n_heads, hd)
    if T == 1:
        src_len = torch.full((B,), xk.shape[2], dtype=torch.int32,
                             device=h.device)
        o = ops.decode_attention(q[:, 0], xk, xv, kv_len=src_len,
                                 impl=rt.impl)[:, None]   # [B, 1, Hq, hd]
    else:
        o = ops.attention(q.transpose(1, 2).contiguous(), xk, xv,
                          causal=False, impl=rt.impl).transpose(1, 2)
    return linear(ap["wo"], o.reshape(B, T, cfg.n_heads * hd))


def forward_chunk(p: Params, tokens, rt: Runtime, table, cache: Params,
                  pos, valid=None, frames=None
                  ) -> Tuple[torch.Tensor, Params, Any]:
    """Positioned-chunk decoder forward: tokens [B, T] written at per-row
    self-attention cache offsets pos [B] (a scalar broadcasts); valid [B]
    masks a bucket-padded chunk.  With frames [B, S_src, frontend_dim]
    (the pos = 0 chunk of fresh requests) the source is encoded once and
    every row's cross K/V of every layer is written into the cache, whose
    xk/xv must hold S_src rows; without them the cached xk/xv are read
    unchanged.  The cache is updated in place.  Returns (last-valid-token
    logits [B, V], cache, table)."""
    cfg = rt.cfg
    dev = rt.device
    enc_out = encode(p, frames, rt) if frames is not None else None
    if enc_out is not None and enc_out.shape[1] != cache["xk"].shape[3]:
        raise ValueError(f"frames give {enc_out.shape[1]} source rows, the "
                         f"cross cache holds {cache['xk'].shape[3]}")
    x = embed(p, torch.as_tensor(tokens, device=dev), rt)
    B, T = x.shape[:2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B) \
        .contiguous()
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev)
    stack = p["dec_stack"]["stack"]
    for i in range(cfg.dec_layers):
        layer_p = _layer(stack, i)
        h = norm(layer_p["norm1"], x, rt)
        a, _ = attention(layer_p, h, rt, positions,
                         {"k": cache["k"][i], "v": cache["v"][i]}, pos)
        x = x + a
        xk, xv = cache["xk"][i], cache["xv"][i]
        if enc_out is not None:
            k, v = _cross_kv(layer_p, enc_out, cfg)
            xk.copy_(k)
            xv.copy_(v)
        h = norm(layer_p["norm2"], x, rt)
        x = x + _cross_attention(layer_p, h, xk, xv, rt)
        h = norm(layer_p["norm3"], x, rt)
        x = x + mlp(layer_p, h, rt)
    x = norm(p["final_norm"], x, rt)
    logits = lm_head(p, last_valid(x, valid), rt)[:, 0]
    return logits, cache, table


def prefill(p: Params, tokens, rt: Runtime, table, cache: Params,
            frames=None):
    """Encode the source and bulk-prefill the decoder prompt =
    forward_chunk at offset 0 with T = prompt length and the frames."""
    zero = torch.zeros((len(tokens),), dtype=torch.int32, device=rt.device)
    return forward_chunk(p, tokens, rt, table, cache, zero, frames=frames)


def decode_step(p: Params, token, rt: Runtime, table, cache: Params, pos):
    """Pooled decode = forward_chunk at width T = 1.  token: [B]."""
    token = torch.as_tensor(token, device=rt.device)
    return forward_chunk(p, token[:, None], rt, table, cache, pos)


def declare_fold_slots(spec: DeviceFoldSpec, cfg: ModelConfig) -> None:
    spec.declare("app", "loss", "train_step", "count")
