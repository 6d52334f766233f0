"""Dense-transformer building blocks on torch tensors, params as dicts.

The PyTorch counterpart of `repro/models/layers.py` for the dense and MoE
families, with GQA attention and DeepSeek-V2's multi-head latent
attention (`mla_attention`):
the same param names and layouts (the reference's leaf names load as
they are), the same dtype policy (params in cfg.param_dtype, compute in
cfg.compute_dtype, reductions and softmax in f32) and the same static
cost edges.  Kernel hot spots route through `repro_torch.kernels.ops`.

KV caches are updated IN PLACE: `update_cache_rows` (contiguous rows) and
`update_cache_pages` (page arena through a block table) write the fresh
rows into the cache tensor they are given, where the reference returns a
new array that jit donation lets XLA write in place.

Training runs `attention` without a cache (causal flash attention over
the whole sequence) and differentiates with torch autograd; the kernels'
autograd Functions supply the attention and norm backward passes.

Under a mesh with a model axis (`repro_torch.parallel`) the dense path
is tensor parallel, Megatron-style: each layer reads its local widths
from its weights' shapes (heads, d_ff, vocab rows) and communicates
through `parallel/tp.py` where a weight is split.  `attention` and `mlp`
run column-parallel in and row-parallel out; `embed` and `lm_head` are
vocab-parallel, and `token_nll` takes the max, the sum of exponentials
and the gold logit across the vocab shards, so the full logits never
exist on one rank.  The static costs stay the global operation's, as
one trace of the reference's SPMD program registers them; MLA's
training branch splits its heads too (`mla_attention`).  Each of
`attention` (GQA and MLA), `mlp`, `embed` and `lm_head` runs inside its
XFA component scope (`core.hlo_flows.scoped`), so the collectives it
calls are recorded under it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core import hlo_flows
from ..core.device_fold import annotate_cost, shard_scale
from ..kernels import ops
from ..parallel import mesh as mesh_lib
from ..parallel import tp
from ..parallel.axes import get_runtime_mesh

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
    fold_spec: Any = None         # DeviceFoldSpec or None

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)


# ------------------------------------------------------------------ misc ----
def linear(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p.to(x.dtype))


class _BF16GradBarrier(torch.autograd.Function):
    """Identity whose f32 cotangent is rounded through bf16, as the
    reference's `_bf16_grad_barrier` does (there: to halve the bytes of
    the tensor-parallel gradient all-reduces)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        if ct.dtype == torch.float32:
            return ct.to(torch.bfloat16).to(ct.dtype)
        return ct


def grad_barrier(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The identity; with cfg.bf16_grad_reduce its f32 gradient is rounded
    to bf16 on the way back."""
    if getattr(cfg, "bf16_grad_reduce", False):
        return _BF16GradBarrier.apply(x)
    return x


def norm(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps=rt.cfg.norm_eps, impl=rt.impl)


# ------------------------------------------------------------------ rope ----
def rope_tables(cfg: ModelConfig, positions: torch.Tensor, dim: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [S] (or [B, S]) -> cos/sin [..., S, dim//2], f32."""
    half = dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    # torch.full fills on the device: torch.tensor(x, device=cuda) would be
    # a host-to-device copy that waits for the stream, once per layer
    freqs = torch.pow(torch.full((), cfg.rope_theta, dtype=torch.float32,
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


def update_cache_pages(arena: torch.Tensor, src: torch.Tensor,
                       pos: torch.Tensor, block_table: torch.Tensor,
                       seq_axis: int = 2) -> torch.Tensor:
    """Paged cache scatter, IN PLACE: the page-arena twin of
    update_cache_rows.  arena: [P, ..., page_size, ...] (the page id
    replaces the batch dim; `seq_axis` is the row-within-page axis);
    src: [B, ..., T, ...] fresh rows; pos: [B] per-row virtual offsets;
    block_table: [B, NB] page ids.

    Virtual row pos[b]+t of batch row b lands at
    (block_table[b, clip((pos[b]+t) // page_size, 0, NB-1)],
     (pos[b]+t) % page_size), as in the reference: the clip keeps a
    past-end pad write inside the table.  Pad rows carry all-zero tables,
    so their writes land on scratch page 0.  Returns arena."""
    ps = arena.shape[seq_axis]
    NB = block_table.shape[1]
    B, T = src.shape[0], src.shape[seq_axis]
    abs_pos = (pos.long()[:, None]
               + torch.arange(T, device=arena.device)[None, :])
    blk = torch.clamp(abs_pos // ps, 0, NB - 1)
    pg = torch.gather(block_table.long(), 1, blk)
    row = abs_pos % ps
    # [B, ..., T, ...] -> [B*T, ...rest], the shape the advanced indices
    # (page, row) select: broadcast index dims go to the front
    srcf = src.movedim(seq_axis, 1).reshape(
        (B * T,) + src.shape[1:seq_axis] + src.shape[seq_axis + 1:])
    index = [slice(None)] * arena.ndim
    index[0] = pg.reshape(-1)
    index[seq_axis] = row.reshape(-1)
    arena[tuple(index)] = srcf.to(arena.dtype)
    return arena


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
    """Stacked KV cache: k, v [n_layers, batch, Hkv, max_len, head_dim];
    with MLA the latent cache, ckv [n_layers, batch, max_len, r] and
    krope [n_layers, batch, max_len, dr], as the reference lays it out."""
    if cfg.mla:
        def z(width):
            return torch.zeros((n_layers, batch, max_len, width), dtype=dtype,
                               device=device)
        return {"ckv": z(cfg.kv_lora_rank), "krope": z(cfg.qk_rope_dim)}
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention(p: Params, x: torch.Tensor, rt: Runtime,
              positions: torch.Tensor, cache: Optional[Params] = None,
              pos: Optional[torch.Tensor] = None,
              block_table: Optional[torch.Tensor] = None, *,
              kv: Optional[torch.Tensor] = None, causal: bool = True
              ) -> Tuple[torch.Tensor, Optional[Params]]:
    """GQA/MQA (optionally qk-norm) attention.  x: [B, S, d].

    Without a cache (training, the encoder): attention over the S
    positions, causal unless `causal` is False, positions [S] the shared
    rope positions; returns (y, None).  kv: [B, Sk, d], a cross-attention
    source: K/V are projected from it, no rope is applied, and the
    attention is never causal (the reference's `causal and kv is None`).
    The qkv_proj cost counts the query length S for K/V too, as the
    reference's does.

    With a cache, positioned-chunk mode: positions [B, S] per-row rope
    positions; cache: one layer's {"k", "v"} [B, Hkv, S_max, h], updated
    in place at [pos, pos+S) per row; pos: [B] int32.  S == 1 is the
    pooled decode step (decode kernel), S > 1 a prefill chunk (chunk
    kernel).  block_table: [B, NB] int32 page ids — when given, `cache`
    is one layer's PAGE ARENA [P, Hkv, page_size, h]: writes scatter and
    reads go through the table, so a row only touches the pages it was
    granted.  With cfg.mla the layer is `mla_attention`.  Returns
    (y [B, S, d], cache)."""
    if rt.cfg.mla:
        return mla_attention(p, x, rt, positions, cache, pos, block_table)
    return _gqa_attention(p, x, rt, positions, cache, pos, block_table,
                          kv=kv, causal=causal)


@hlo_flows.scoped("attention")
def _gqa_attention(p: Params, x: torch.Tensor, rt: Runtime,
                   positions: torch.Tensor, cache: Optional[Params],
                   pos: Optional[torch.Tensor],
                   block_table: Optional[torch.Tensor], *,
                   kv: Optional[torch.Tensor], causal: bool
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    cfg = rt.cfg
    ap = p["attn"]
    B, S, d = x.shape
    h = cfg.head_dim_
    src = x if kv is None else kv
    Sk = src.shape[1]
    # local heads from the weights: a model axis holds Hq / tp q heads
    # and Hkv / tp kv heads a rank (MQA: the one kv head on every rank)
    Hq, Hkv = ap["wq"].shape[-1] // h, ap["wk"].shape[-1] // h
    split = tp.split_over_model(Hq, cfg.n_heads)
    wk, wv = ap["wk"], ap["wv"]
    q_scale = k_scale = None
    if cfg.qk_norm:
        q_scale, k_scale = ap["q_norm"], ap["k_norm"]
    if split:
        x = tp.copy_to_model(x)
        src = x if kv is None else tp.copy_to_model(kv)
        if not tp.split_over_model(Hkv, cfg.n_kv_heads):
            # whole K/V weights see only this rank's q heads' gradient
            wk, wv = tp.copy_to_model(wk), tp.copy_to_model(wv)
        if cfg.qk_norm:
            q_scale, k_scale = (tp.copy_to_model(q_scale),
                                tp.copy_to_model(k_scale))
    q = linear(ap["wq"], x).reshape(B, S, Hq, h)
    k = linear(wk, src).reshape(B, Sk, Hkv, h)
    v = linear(wv, src).reshape(B, Sk, Hkv, h)
    annotate_cost("attention", "attention", "qkv_proj",
                  flops=2.0 * B * S * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * h)
    if cfg.qk_norm:
        with shard_scale(cfg.n_heads / Hq):
            q = ops.rmsnorm(q, q_scale, eps=cfg.norm_eps, impl=rt.impl)
        with shard_scale(cfg.n_kv_heads / Hkv):
            k = ops.rmsnorm(k, k_scale, eps=cfg.norm_eps, impl=rt.impl)
    if kv is None:             # rope on self-attention only
        cos, sin = rope_tables(cfg, positions, h)
        if cos.dim() == 3:                               # per-row positions
            cos, sin = cos[:, None], sin[:, None]        # [B, 1, S, h/2]
        q = apply_rope(q.transpose(1, 2), cos, sin)      # [B, Hq, S, h]
        k = apply_rope(k.transpose(1, 2), cos, sin)
    else:
        q, k = q.transpose(1, 2), k.transpose(1, 2)
    v = v.transpose(1, 2)
    new_cache = None
    if cache is None:          # over the S positions (causal or not)
        with shard_scale(cfg.n_heads / Hq):
            o = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal and kv is None, impl=rt.impl)
    elif block_table is not None:
        # paged positioned chunk: scatter the S fresh rows through the
        # block table into the shared arena, read the row's visible
        # prefix back through the same indirection
        ck = update_cache_pages(cache["k"], k, pos, block_table)
        cv = update_cache_pages(cache["v"], v, pos, block_table)
        new_cache = {"k": ck, "v": cv}
        if S == 1:             # decode width: paged flash-decode kernel
            o = ops.decode_attention_paged(
                q[:, :, 0], ck, cv, block_table=block_table,
                kv_len=pos + 1, impl=rt.impl)
        else:                  # prefill chunk at per-row offsets
            o = ops.chunk_attention_paged(q, ck, cv, block_table=block_table,
                                          pos=pos, impl=rt.impl)
    else:
        ck = update_cache_rows(cache["k"], k, pos)
        cv = update_cache_rows(cache["v"], v, pos)
        new_cache = {"k": ck, "v": cv}
        if S == 1:             # decode width: flash-decode kernel
            o = ops.decode_attention(q[:, :, 0], ck, cv, kv_len=pos + 1,
                                     impl=rt.impl)
        else:                  # prefill chunk at per-row offsets
            o = ops.chunk_attention(q, ck, cv, pos=pos, impl=rt.impl)
    if o.dim() == 3:           # decode: [B, Hq, h]
        o = o.reshape(B, 1, Hq * h)
    else:
        o = o.transpose(1, 2).reshape(B, S, Hq * h)
    y = tp.row_parallel(o, ap["wo"]) if split else linear(ap["wo"], o)
    annotate_cost("attention", "attention", "o_proj",
                  flops=2.0 * B * S * cfg.n_heads * h * d)
    return y, new_cache


@hlo_flows.scoped("attention")
def mla_attention(p: Params, x: torch.Tensor, rt: Runtime,
                  positions: torch.Tensor, cache: Optional[Params] = None,
                  pos: Optional[torch.Tensor] = None,
                  block_table: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Multi-head latent attention (DeepSeek-V2), as the reference's
    `mla_attention`.  x: [B, S, d].

    Without a cache (training): the latent is expanded into per-head K/V,
    k = [k_nope | k_rope broadcast over the heads] at D = dn + dr and v at
    dv, causal attention at sm_scale (dn + dr) ** -0.5 with v at its own
    width (the reference pads v to dn + dr for its kernel and keeps o's
    first dv columns: the same values); returns (y, None).

    With a cache: the matrix-absorbed latent path.  The cache holds only
    one layer's {"ckv" [B, S_max, r], "krope" [B, S_max, dr]} (a page
    arena [P, page_size, r] / [P, page_size, dr] with block_table), and
    the chunk's latent rows are written in place at [pos, pos+S).  The
    queries are absorbed through wk_b in f32 into the latent space, and
    the latent decode (S == 1) or chunk attention, or its paged twin,
    reads the cache as it lies: one latent kv head whose K rows are
    [ckv | krope] (D = r + dr) and V rows ckv, sm_scale (dn + dr) ** -0.5,
    r output columns (the reference builds k = [ckv | krope] and v = ckv
    zero-padded to r + dr, and keeps the same r columns).  They are
    un-absorbed through wv_b in f32.  Returns (y, cache).

    Under a model axis (training only) the layer is tensor parallel by
    heads: wq and wkv_b hold this rank's heads' columns (head-major, so
    the contiguous split keeps heads whole) and wo their rows
    (`tp.row_parallel`); wkv_a is whole on every rank, so x enters it as
    it is and the latent (c_kv, k_rope) goes through `tp.copy_to_model`
    (its gradient is this rank's heads' part), while x enters wq through
    `copy_to_model` too.  The latent serving path runs on one device."""
    cfg = rt.cfg
    ap = p["attn"]
    B, S, d = x.shape
    nh, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                      cfg.v_head_dim)
    r = cfg.kv_lora_rank
    # local heads from the weights: a model axis holds nh / tp a rank
    nh_loc = ap["wq"].shape[-1] // (dn + dr)
    split = tp.split_over_model(nh_loc, nh)
    if split and cache is not None:
        raise NotImplementedError("MLA's latent serving path under a "
                                  "model axis is not ported")
    kv_a = linear(ap["wkv_a"], x)                        # [B, S, r + dr]
    if split:
        kv_a, x = tp.copy_to_model(kv_a), tp.copy_to_model(x)
    q = linear(ap["wq"], x).reshape(B, S, nh_loc, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    c_kv, k_rope = kv_a[..., :r], kv_a[..., r:]
    cos, sin = rope_tables(cfg, positions, dr)
    if cos.dim() == 3:                                   # per-row positions
        cos, sin = cos[:, None], sin[:, None]
    q_rope = apply_rope(q_rope.transpose(1, 2), cos, sin)   # [B, nh, S, dr]
    k_rope = apply_rope(k_rope[:, None], cos, sin)          # [B, 1, S, dr]
    annotate_cost("attention", "attention", "mla_proj",
                  flops=2.0 * B * S * d * (nh * (dn + dr) + r + dr))
    wkv_b = ap["wkv_b"].reshape(r, nh_loc, dn + dv)
    wk_b, wv_b = wkv_b[..., :dn], wkv_b[..., dn:]        # [r,nh,dn], [r,nh,dv]
    scale = (dn + dr) ** -0.5
    if cache is None:          # training: expand the latent
        k_nope = torch.einsum("bsr,rhd->bhsd", c_kv, wk_b.to(c_kv.dtype))
        v = torch.einsum("bsr,rhd->bhsd", c_kv, wv_b.to(c_kv.dtype))
        k = torch.cat([k_nope, k_rope.expand(B, nh_loc, S, dr)], dim=-1)
        qq = torch.cat([q_nope.transpose(1, 2), q_rope], dim=-1)
        with shard_scale(nh / nh_loc):
            o = ops.attention(qq, k, v.contiguous(), causal=True,
                              sm_scale=scale, impl=rt.impl)
        o = o.transpose(1, 2).reshape(B, S, nh_loc * dv)
        y = tp.row_parallel(o, ap["wo"]) if split else linear(ap["wo"], o)
        return y, None
    if block_table is not None:
        cc = update_cache_pages(cache["ckv"], c_kv, pos, block_table,
                                seq_axis=1)
        cr = update_cache_pages(cache["krope"], k_rope[:, 0], pos,
                                block_table, seq_axis=1)
    else:
        cc = update_cache_rows(cache["ckv"], c_kv, pos, seq_axis=1)
        cr = update_cache_rows(cache["krope"], k_rope[:, 0], pos, seq_axis=1)
    # absorb: q_latent = q_nope wk_b^T, in f32 -> [B, nh, S, r]
    q_lat = torch.einsum("bhtd,rhd->bhtr", q_nope.transpose(1, 2).float(),
                         wk_b.float()).to(x.dtype)
    q_full = torch.cat([q_lat, q_rope], dim=-1)          # [B, nh, S, r + dr]
    # one latent kv head, read in place: cc [B, S_max, r] and cr
    # [B, S_max, dr] dense, [P, page, r] and [P, page, dr] paged
    if S == 1:                 # decode width: the decode kernel
        if block_table is not None:
            o_lat = ops.decode_attention_latent_paged(
                q_full[:, :, 0], cc, cr, block_table=block_table,
                kv_len=pos + 1, sm_scale=scale, impl=rt.impl)
        else:
            o_lat = ops.decode_attention_latent(
                q_full[:, :, 0], cc, cr, kv_len=pos + 1, sm_scale=scale,
                impl=rt.impl)
        o_lat = o_lat[:, None]                           # [B, 1, nh, r]
    else:                      # prefill chunk at per-row offsets
        if block_table is not None:
            o_lat = ops.chunk_attention_latent_paged(
                q_full, cc, cr, block_table=block_table, pos=pos,
                sm_scale=scale, impl=rt.impl)
        else:
            o_lat = ops.chunk_attention_latent(q_full, cc, cr, pos=pos,
                                               sm_scale=scale, impl=rt.impl)
        o_lat = o_lat.transpose(1, 2)                    # [B, S, nh, r]
    # un-absorb through wv_b, in f32
    o = torch.einsum("bthr,rhd->bthd", o_lat.float(),
                     wv_b.float()).to(x.dtype)
    y = linear(ap["wo"], o.reshape(B, S, nh * dv))
    return y, {"ckv": cc, "krope": cr}


# ------------------------------------------------------------------- mlp ----
@hlo_flows.scoped("mlp")
def mlp(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """The (gated) MLP.  With d_ff split over a model axis: through
    `tp.col_row_mlp` when cfg.manual_tp (bf16 partials reduced once each
    way), else column-parallel in and f32 partials reduced after w_down,
    as the reference's pjit path computes it."""
    mp = p["mlp"]
    cfg = rt.cfg
    f = mp["w_up"].shape[-1]
    split = tp.split_over_model(f, cfg.d_ff)
    if split and cfg.manual_tp:
        y = tp.col_row_mlp(x, mp["w_up"], mp["w_down"], mp.get("w_gate"),
                           cfg.mlp_gated)
    else:
        if split:
            x = tp.copy_to_model(x)
        up = linear(mp["w_up"], x)
        if cfg.mlp_gated:
            act = F.silu(linear(mp["w_gate"], x).float())
            hidden = (act * up.float()).to(x.dtype)
        else:
            hidden = F.gelu(up.float(), approximate="tanh").to(x.dtype)
        y = (tp.row_parallel(hidden, mp["w_down"]) if split
             else linear(mp["w_down"], hidden))
    if split:
        f = cfg.d_ff
    nmat = 3 if cfg.mlp_gated else 2
    annotate_cost("mlp", "mlp", "ffn",
                  flops=2.0 * x.shape[0] * x.shape[1] * cfg.d_model * f * nmat)
    return y


# ----------------------------------------------------------------- embed ----
def _vocab_start(local: int, rt: Runtime) -> Optional[int]:
    """The first vocab row this rank holds when the vocab is split over
    the model axis, else None."""
    if tp.split_over_model(local, rt.cfg.vocab):
        return tp.model_coord() * local
    return None


@hlo_flows.scoped("embed")
def embed(p: Params, tokens: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Token embeddings; vocab-parallel when the table's rows are split:
    ids outside this rank's rows give zeros, then one sum over the
    model axis."""
    table = p["embed"]["table"]
    start = _vocab_start(table.shape[0], rt)
    if start is None:
        x = table[tokens.long()].to(rt.cdtype)
    else:
        ids = tokens.long() - start
        inside = (ids >= 0) & (ids < table.shape[0])
        rows = table[ids.clamp(0, table.shape[0] - 1)]
        x = torch.where(inside[..., None], rows,
                        torch.zeros((), dtype=rows.dtype,
                                    device=rows.device)).to(rt.cdtype)
        x = tp.reduce_from_model(x)
    annotate_cost("embed", "embed", "lookup", bytes=float(x.numel() * 2))
    return x


@hlo_flows.scoped("lm_head")
def lm_head(p: Params, x: torch.Tensor, rt: Runtime) -> torch.Tensor:
    """Logits; with the vocab split over the model axis, this rank's
    vocab columns only."""
    w = (p["embed"]["table"].T if rt.cfg.tie_embeddings
         else p["lm_head"]["w"])
    if _vocab_start(w.shape[-1], rt) is not None:
        logits = tp.vocab_parallel(x, w)
    else:
        logits = torch.matmul(x, w.to(x.dtype))
    annotate_cost("lm_head", "lm_head", "proj",
                  flops=2.0 * x.shape[0] * x.shape[1] * rt.cfg.d_model
                  * rt.cfg.vocab)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in f32; mask: [B, S] 1 = count."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def token_nll(logits: torch.Tensor, labels: torch.Tensor, rt: Runtime
              ) -> torch.Tensor:
    """Per-token NLL [B, S] in f32.  Vocab-parallel logits (this rank's
    columns of the vocab): the max, the sum of exponentials and the gold
    logit are each reduced over the model axis, so every rank gets the
    full NLL without the full logits."""
    lf = logits.float()
    start = _vocab_start(lf.shape[-1], rt)
    if start is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        return lse - gold
    mx = mesh_lib.all_reduce(lf.detach().amax(dim=-1), get_runtime_mesh(),
                             tp.model_axes(), op="max")
    sumexp = tp.reduce_from_model(torch.exp(lf - mx[..., None]).sum(dim=-1))
    ids = labels.long() - start
    inside = (ids >= 0) & (ids < lf.shape[-1])
    gold = torch.gather(lf, -1, ids.clamp(0, lf.shape[-1] - 1)[..., None])
    gold = tp.reduce_from_model(
        torch.where(inside, gold[..., 0], torch.zeros_like(gold[..., 0])))
    return mx + torch.log(sumexp) - gold
