"""Mamba2 (SSD) blocks and the Zamba2 hybrid backbone: serving and
training.

The PyTorch counterpart of `repro/models/mamba.py` (family="hybrid"):
the same param names, layouts and dtypes (the reference's leaf names load
as they are), the same cache layout and the same static cost edges.

Mamba2 block [arXiv:2405.21060]: in_proj -> (z, x, B, C, dt); causal
depthwise conv over (x, B, C); silu; SSD scan (`ops.ssd_scan`: the CUDA
kernel on the card, the plain chunked version on the CPU); D skip;
silu(z) gate; RMSNorm over d_inner; out_proj.

Zamba2 [arXiv:2411.15242]: a stack of Mamba2 layers with ONE weight-tied
attention + MLP block applied after every `attn_every` layers.  Layer
params are stacked [n_super, attn_every, ...] under p["stack"]["stack"],
the shared block's under p["shared_attn"].  Where the reference scans
over super-blocks and layers, the port runs a Python loop over the
[n_super][attn_every] views; each layer registers its own static costs,
so the loops are not wrapped in scan_multiplier.

Serving state: per Mamba layer a conv tail [B, K-1, ch] (the last K-1
PRE-silu conv inputs) and the SSD state h [B, H, N, P] in f32, stacked
over the n_layers layers; the shared block keeps one KV cache per
invocation, [n_super, B, Hkv, S, hd].  `forward_chunk` updates all of it
IN PLACE (the reference returns a new cache that jit donation lets XLA
write in place).  The hybrid has no paged entry points: its recurrent
state is O(1) in sequence length, so the engine keeps the dense layout.

Training: `forward` runs every Mamba layer in full-sequence mode (a
zero state; the SSD scan goes through `ops.ssd_scan`, whose autograd
Function pairs the scan kernel with its backward kernel) and the shared
block as causal attention without a cache (`ops.attention`: the flash
kernels, head dim 80 at zamba2's width).  Each super-block (attn_every
Mamba layers, then the shared block) is rematerialized per cfg.remat, as
the reference checkpoints its `super_body`; `loss_fn` is the causal LM
loss of `transformer.lm_loss`.

Under a model axis (training; `parallel.sharding.layout_tree`) the
Mamba2 block is tensor parallel by ssm heads: in_proj gives this rank's
z, x and dt columns and the whole B and C (one group), the depthwise conv
runs on its x channels and all of B and C, a_log, dt_bias and d_skip
hold its heads, and the SSD scan runs on its H / tp heads.  The weight
parts every rank holds whole (in_proj's and conv_w's B and C) meet only
this rank's heads, so their gradients are summed over 'model' once
(`tp.copy_to_model(part=...)`), and x enters the block's projection
through `copy_to_model`.  The gated RMSNorm runs over all of d_inner,
mixing heads: y is gathered over 'model', normed whole (the rounding of
one device), and this rank's columns of it enter the row-parallel
out_proj.  The shared block runs the split `attention` and `mlp`; its
weight-tied gradients add up over the super-blocks.  Each Mamba2 block
runs inside XFA's `ssm` component scope, so its collectives are
recorded under it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import hlo_flows
from ..core.device_fold import DeviceFoldSpec, annotate_cost
from ..kernels import ops
from ..parallel import tp
from ..parallel.axes import get_runtime_mesh
from .layers import (Params, Runtime, attention, embed, last_valid, linear,
                     lm_head, mlp, norm, torch_dtype)
from .transformer import (F32, ONES, ZEROS, _layer, _remat, init_from_specs,
                          lm_loss)


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Spec tree of the hybrid's params (see transformer.param_specs):
    the Mamba stack [n_super, attn_every, ...] and the one shared
    attention + MLP block, with the reference's inits: fan_in ** -0.5
    normals, conv_w at conv_kernel ** -0.5, a_log 0, dt_bias -2 and
    d_skip 1 in f32, norm scales 1."""
    if cfg.family != "hybrid" or not cfg.attn_every:
        raise ValueError(f"{cfg.name}: not a hybrid config with attn_every")
    d, di, n = cfg.d_model, cfg.d_inner_, cfg.ssm_state
    H, K, h, f = cfg.n_ssm_heads, cfg.conv_kernel, cfg.head_dim_, cfg.d_ff
    st = (cfg.n_layers // cfg.attn_every, cfg.attn_every)

    def w(fan_in, *shape):
        return (shape, fan_in ** -0.5)

    ssm = {"in_proj": w(d, *st, d, 2 * di + 2 * n + H),
           "conv_w": (st + (K, di + 2 * n), K ** -0.5),
           "out_proj": w(di, *st, di, d),
           "a_log": (st + (H,), ZEROS, F32),          # A = -exp(a_log)
           "dt_bias": (st + (H,), ("fill", -2.0), F32),
           "d_skip": (st + (H,), ONES, F32),
           "norm": (st + (di,), ONES)}
    attn = {"wq": w(d, d, cfg.n_heads * h),
            "wk": w(d, d, cfg.n_kv_heads * h),
            "wv": w(d, d, cfg.n_kv_heads * h),
            "wo": w(cfg.n_heads * h, cfg.n_heads * h, d)}
    if cfg.qk_norm:
        attn["q_norm"] = ((h,), ONES)
        attn["k_norm"] = ((h,), ONES)
    mlp_p = {"w_up": w(d, d, f), "w_down": w(f, f, d)}
    if cfg.mlp_gated:
        mlp_p["w_gate"] = w(d, d, f)
    specs: Dict[str, Any] = {
        "embed": {"table": ((cfg.vocab, d), 1.0)},
        "final_norm": {"scale": ((d,), ONES)},
        "stack": {"stack": {"norm1": {"scale": (st + (d,), ONES)},
                            "ssm": ssm}},
        "shared_attn": {"norm1": {"scale": ((d,), ONES)},
                        "norm2": {"scale": ((d,), ONES)},
                        "attn": attn, "mlp": mlp_p},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": w(d, d, cfg.vocab)}
    return specs


def init_params(cfg: ModelConfig, seed: int, device: torch.device) -> Params:
    return init_from_specs(param_specs(cfg), cfg, seed, device)


# ------------------------------------------------------------ mamba block ----
def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: [B, L, ch]; w: [K, ch]; state:
    [B, K-1, ch] tail of the previous tokens (None = zeros).  Returns
    (y [B, L, ch], the last K-1 inputs)."""
    K = w.shape[0]
    B, L, ch = x.shape
    pad = (x.new_zeros((B, K - 1, ch)) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                      # [B, L+K-1, ch]
    y = sum(xp[:, i:i + L] * w[i][None, None] for i in range(K))
    return y, xp[:, -(K - 1):]


def _conv_tail(raw_xbc: torch.Tensor, conv_state: Optional[torch.Tensor],
               K: int, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The K-1 PRE-silu conv inputs ending at each row's valid frontier.

    raw_xbc: [B, L, ch] this chunk's raw conv inputs; conv_state: the
    previous chunk's tail (None = a fresh sequence), needed when
    L < K-1; valid: [B] real-token counts (None = L).  Row b takes
    positions [v, v + K-1) of [tail, chunk], v = valid[b] clamped to
    [0, L] as the reference's dynamic_slice clamps it."""
    B, L, ch = raw_xbc.shape
    pad = (raw_xbc.new_zeros((B, K - 1, ch)) if conv_state is None
           else conv_state.to(raw_xbc.dtype))
    xp = torch.cat([pad, raw_xbc], dim=1)                # [B, K-1+L, ch]
    if valid is None:
        return xp[:, -(K - 1):]
    start = torch.clamp(valid.long(), 0, L)
    idx = start[:, None] + torch.arange(K - 1, device=xp.device)[None, :]
    return torch.gather(xp, 1, idx[..., None].expand(-1, -1, ch))


@hlo_flows.scoped("ssm")
def mamba_block(p: Params, x: torch.Tensor, rt: Runtime,
                state: Optional[Params] = None, return_state: bool = False,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: [B, L, d] -> (y [B, L, d], new state or None).

    state None is full-sequence mode (a fresh prefill); state with
    L == 1 the O(1) decode recurrence (plain torch, as in the reference:
    there is no kernel for one step); state with L > 1 a positioned
    prefill chunk: the SSD scan resumes from the carried h and the conv
    from the carried tail, so a prompt fed in chunks is the same
    recurrence as the prompt fed whole.  valid: [B] real-token counts of
    a bucket-padded chunk: pad steps get dt = 0 (decay 1, nothing
    injected: the state is untouched) and the conv tail is taken at each
    row's own frontier.  return_state=True returns the post-sequence
    state in full-sequence mode too.  The new state is returned, not
    written: the caller owns the cache.  Under a model axis (training
    only) the block runs this rank's heads (see the module docstring)."""
    cfg = rt.cfg
    sp = p["ssm"]
    B, L, d = x.shape
    n, P, K = cfg.ssm_state, cfg.ssm_head_dim, cfg.conv_kernel
    # local heads from the weights: a model axis holds H / tp a rank
    H = sp["a_log"].shape[-1]
    di = H * P
    split = tp.split_over_model(H, cfg.n_ssm_heads)
    if split and state is not None:
        raise NotImplementedError("the Mamba2 block's serving path under "
                                  "a model axis is not ported")
    h = norm(p["norm1"], x, rt)
    w_in, conv_w = sp["in_proj"], sp["conv_w"]
    if split:
        # B and C are whole on every rank: their weights' gradients (this
        # rank's heads' part) summed over 'model' once
        h = tp.copy_to_model(h)
        w_in = tp.copy_to_model(w_in, part=(w_in.dim() - 1, 2 * di, 2 * n))
        conv_w = tp.copy_to_model(conv_w, part=(conv_w.dim() - 1, di, 2 * n))
    proj = linear(w_in, h)
    z = proj[..., :di]
    raw_xbc = proj[..., di:di + di + 2 * n]
    dt_raw = proj[..., -H:]
    annotate_cost("ssm", "ssm", "in_proj",
                  flops=2.0 * B * L * d * (2 * cfg.d_inner_ + 2 * n
                                           + cfg.n_ssm_heads))

    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(raw_xbc, conv_w.to(x.dtype), conv_state)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs = xbc[..., :di].reshape(B, L, H, P)
    b_mat = xbc[..., di:di + n]
    c_mat = xbc[..., di + n:]

    dt = F.softplus(dt_raw.float() + sp["dt_bias"].float()[None, None])
    if valid is not None:
        # pad steps must not advance the state: dt = 0 decays by exp(0) = 1
        # and injects 0 (ops.ssd_scan pads to a chunk multiple the same way)
        real = torch.arange(L, device=x.device)[None, :, None] \
            < valid.to(x.device)[:, None, None]
        dt = torch.where(real, dt, 0.0)
    a = -torch.exp(sp["a_log"].float())

    conv_tail = new_conv
    if state is None or L > 1:
        y, new_ssm = ops.ssd_scan(
            xs, dt, a, b_mat, c_mat, chunk=min(cfg.ssm_chunk, L),
            h0=state["h"] if state is not None else None, impl=rt.impl,
            heads=cfg.n_ssm_heads)
        if return_state or state is not None:
            conv_tail = _conv_tail(raw_xbc, conv_state, K, valid)
    else:
        # single-step recurrence (decode): L == 1
        dt1 = dt[:, 0]                                    # [B, H]
        decay = torch.exp(a[None] * dt1)
        dbx = torch.einsum("bh,bn,bhp->bhnp", dt1, b_mat[:, 0].float(),
                           xs[:, 0].float())
        new_ssm = decay[..., None, None] * state["h"] + dbx
        y = torch.einsum("bn,bhnp->bhp", c_mat[:, 0].float(),
                         new_ssm)[:, None].to(x.dtype)

    y = y.float() + sp["d_skip"].float()[None, None, :, None] * xs.float()
    y = (y.reshape(B, L, di) * F.silu(z.float())).to(x.dtype)
    if split:
        # the norm mixes every head: over the whole row, then this rank's
        # columns into the row-parallel out_proj
        axis = tp.model_axes()[0]
        y = tp.gather_rows(y, get_runtime_mesh(), axis, dim=-1)
        y = ops.rmsnorm(y, sp["norm"], eps=cfg.norm_eps, impl=rt.impl)
        y = tp.split_rows(y, get_runtime_mesh(), axis, dim=-1)
        out = tp.row_parallel(y, sp["out_proj"])
    else:
        y = ops.rmsnorm(y, sp["norm"], eps=cfg.norm_eps, impl=rt.impl)
        out = linear(sp["out_proj"], y)
    annotate_cost("ssm", "ssm", "out_proj",
                  flops=2.0 * B * L * cfg.d_inner_ * d)
    if state is not None:
        return out, {"conv": conv_tail.to(state["conv"].dtype),
                     "h": new_ssm}
    if return_state:
        return out, {"conv": conv_tail, "h": new_ssm}
    return out, None


def init_mamba_state(cfg: ModelConfig, batch: int, n_layers: int,
                     dtype: torch.dtype, device: torch.device) -> Params:
    """Zero state of n_layers Mamba layers: conv [n_layers, B, K-1, ch] in
    `dtype`, h [n_layers, B, H, N, P] in f32."""
    di, n = cfg.d_inner_, cfg.ssm_state
    return {"conv": torch.zeros((n_layers, batch, cfg.conv_kernel - 1,
                                 di + 2 * n), dtype=dtype, device=device),
            "h": torch.zeros((n_layers, batch, cfg.n_ssm_heads, n,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------- zamba2 hybrid ----
def _shared_block(shared: Params, x: torch.Tensor, rt: Runtime,
                  positions: torch.Tensor, cache: Optional[Params] = None,
                  pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The weight-tied attention + MLP block.  With a cache it writes its
    cache rows in place (serving); without one it attends causally over
    the sequence (training)."""
    h = norm(shared["norm1"], x, rt)
    a, _ = attention(shared, h, rt, positions, cache=cache, pos=pos)
    x = x + a
    h = norm(shared["norm2"], x, rt)
    return x + mlp(shared, h, rt)


def forward(p: Params, tokens: torch.Tensor, rt: Runtime, table):
    """tokens: [B, S] -> (hidden [B, S, d] after the final norm, table,
    aux_total = 0).  Full-sequence mode, no cache; each super-block
    rematerialized per cfg.remat."""
    cfg = rt.cfg
    x = embed(p, torch.as_tensor(tokens, device=rt.device), rt)
    positions = torch.arange(x.shape[1], device=rt.device)

    def super_body(seg: Params, shared: Params, x: torch.Tensor):
        for j in range(cfg.attn_every):
            y, _ = mamba_block(_layer(seg, j), x, rt)
            x = x + y
        return _shared_block(shared, x, rt, positions)

    body = _remat(super_body, cfg)
    stack = p["stack"]["stack"]
    for s in range(cfg.n_layers // cfg.attn_every):
        x = body(_layer(stack, s), p["shared_attn"], x)
    x = norm(p["final_norm"], x, rt)
    return x, table, torch.zeros((), dtype=torch.float32, device=rt.device)


def loss_fn(p: Params, batch: Dict[str, Any], rt: Runtime, table):
    """The hybrid's causal LM loss (see `transformer.lm_loss`)."""
    return lm_loss(forward, p, batch, rt, table)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype: Optional[torch.dtype] = None
               ) -> Params:
    """{"ssm": {"conv", "h"} over the n_layers Mamba layers, "attn_k",
    "attn_v": [n_super, B, Hkv, max_len, hd]}; every leaf's batch axis is
    1."""
    dtype = dtype or torch_dtype(cfg.compute_dtype)
    shape = (cfg.n_layers // cfg.attn_every, batch, cfg.n_kv_heads, max_len,
             cfg.head_dim_)
    return {"ssm": init_mamba_state(cfg, batch, cfg.n_layers, dtype, device),
            "attn_k": torch.zeros(shape, dtype=dtype, device=device),
            "attn_v": torch.zeros(shape, dtype=dtype, device=device)}


def forward_chunk(p: Params, tokens: torch.Tensor, rt: Runtime, table,
                  cache: Params, pos: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Params, Any]:
    """Positioned-chunk forward: tokens [B, T] at per-row offsets pos [B]
    (a scalar broadcasts); valid [B] masks a bucket-padded chunk.

    The Mamba layers resume their recurrences from the carried (conv, h)
    state, which is position-free and row-independent; the shared
    attention block writes T K/V rows at each row's own offset and
    attends offset-causally.  T = 1 is the pooled decode step, pos = 0
    with T = prompt length bulk prefill.  The cache is updated in place.
    Returns (last-valid-token logits [B, V], cache, table)."""
    cfg = rt.cfg
    dev = rt.device
    tokens = torch.as_tensor(tokens, device=dev)
    x = embed(p, tokens, rt)
    B, T = x.shape[:2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B) \
        .contiguous()
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev)
    k = cfg.attn_every
    stack, ssm = p["stack"]["stack"], cache["ssm"]
    for s in range(cfg.n_layers // k):
        seg = _layer(stack, s)
        for j in range(k):
            i = s * k + j
            st = {"conv": ssm["conv"][i], "h": ssm["h"][i]}
            y, new = mamba_block(_layer(seg, j), x, rt, state=st,
                                 valid=valid)
            st["conv"].copy_(new["conv"])
            st["h"].copy_(new["h"])
            x = x + y
        x = _shared_block(p["shared_attn"], x, rt, positions,
                          {"k": cache["attn_k"][s], "v": cache["attn_v"][s]},
                          pos)
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


def declare_fold_slots(spec: DeviceFoldSpec, cfg: ModelConfig) -> None:
    spec.declare("app", "loss", "train_step", "count")
