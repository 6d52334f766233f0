"""Decoder-only transformer LM (dense, MoE and vlm): params, training
loss, cache and forward_chunk.

The PyTorch counterpart of `repro/models/transformer.py` for
family="dense", family="moe" and family="vlm", with GQA attention or
(cfg.mla) DeepSeek-V2's multi-head latent attention.  The vlm is the
dense stack behind a patch projection, p["frontend"]["w"] [frontend_dim,
d_model]: the projected patches are a prefix of the text (`forward`,
`forward_chunk(prefix_embeds=...)`), and the loss counts the text
positions only.  Layer params are stacked [L, ...] under
p["stack"]["stack"], as the reference's scan-over-layers lays them
out; an MoE model has one stack per layer kind,
p["stack_dense"]["stack"] (its first_dense_layers) and
p["stack_moe"]["stack"], whose layers run the MoE layer of `moe.py` in
place of the MLP.  The KV cache is stacked [L, B, Hkv, S, h] over all
layers ({"k", "v"}; MLA: the latent {"ckv" [L, B, S, r], "krope" [L, B,
S, dr]}).  Where the reference scans one traced layer body (and scales its
static costs by L), the port runs an explicit loop over the layers: each
layer registers its own costs, so the loop is NOT wrapped in
scan_multiplier.  The device fold table goes through every layer, as
the reference's scan carry takes it: the MoE layers emit into it.

Training (`forward`, `loss_fn`) runs the same layers without a cache and
is differentiated by torch autograd.  `cfg.remat` is honoured per layer
with torch.utils.checkpoint: "full" recomputes the whole layer in the
backward, "dots_saveable" saves the matmul outputs and recomputes the
rest.  Remat changes memory, never the loss or the gradients.  Under a
model axis the frontend projection (the vlm's, and the enc-dec's in
`encdec.encode`) is column-split: each rank projects the whole patches
onto its d_model / tp columns and the projection is all-gathered over
'model' (`_project_patches`), so every rank holds the whole prefix, as
the residual stream needs.

Prefill and decode share ONE positioned-chunk body (forward_chunk): a
chunk of T tokens lands at per-row cache offsets, T = 1 being the pooled
decode tick and pos = 0, T = S bulk prefill.  The paged entry points
(`init_paged_cache`, `forward_chunk_paged`, `decode_step_paged`) run the
same body against a page arena [L, P, Hkv, page_size, h] (MLA:
[L, P, page_size, r] and [L, P, page_size, dr]) through per-row block
tables.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..core import hlo_flows
from ..core.device_fold import DeviceFoldSpec, scan_multiplier
from . import moe as moe_lib
from ..parallel import mesh as mesh_lib
from ..parallel import tp
from ..parallel.axes import get_runtime_mesh, mesh_axes
from .layers import (Params, Runtime, attention, cross_entropy, embed,
                     init_kv_cache, last_valid, linear, lm_head, mlp,
                     norm, token_nll, torch_dtype)

#: init markers: a constant fill in place of a scaled normal draw
ONES = ("fill", 1.0)
ZEROS = ("fill", 0.0)
#: dtype marker of a leaf kept in f32 whatever cfg.param_dtype is (the
#: reference's Mamba2 a_log, dt_bias and d_skip)
F32 = "float32"


def _layer_kinds(cfg: ModelConfig) -> Tuple[Tuple[str, int], ...]:
    """Layer stacks in order: ((kind, count), ...).  An MoE model runs its
    first_dense_layers dense layers, then the MoE layers."""
    if cfg.moe:
        k = cfg.first_dense_layers
        return ((("dense", k),) if k else ()) + (("moe", cfg.n_layers - k),)
    return (("dense", cfg.n_layers),)


def _stack_name(cfg: ModelConfig, kind: str) -> str:
    return f"stack_{kind}" if cfg.moe else "stack"


def _layer_specs(cfg: ModelConfig, kind: str, L: int) -> Dict[str, Any]:
    """Spec leaves of a stack of L layers of `kind` ("dense": attention +
    MLP; "moe": attention + the MoE layer)."""
    d, h, f = cfg.d_model, cfg.head_dim_, cfg.d_ff

    def w(fan_in, *shape):
        return (shape, fan_in ** -0.5)

    if cfg.mla:
        nh, r = cfg.n_heads, cfg.kv_lora_rank
        qd, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        attn = {"wq": w(d, L, d, nh * qd),
                "wkv_a": w(d, L, d, r + cfg.qk_rope_dim),
                "wkv_b": w(r, L, r, nh * (cfg.qk_nope_dim + dv)),
                "wo": w(nh * dv, L, nh * dv, d)}
    else:
        attn = {"wq": w(d, L, d, cfg.n_heads * h),
                "wk": w(d, L, d, cfg.n_kv_heads * h),
                "wv": w(d, L, d, cfg.n_kv_heads * h),
                "wo": w(cfg.n_heads * h, L, cfg.n_heads * h, d)}
    if cfg.qk_norm and not cfg.mla:
        attn["q_norm"] = ((L, h), ONES)
        attn["k_norm"] = ((L, h), ONES)
    layer: Dict[str, Any] = {"norm1": {"scale": ((L, d), ONES)},
                             "norm2": {"scale": ((L, d), ONES)},
                             "attn": attn}
    if kind == "moe":
        layer.update(moe_lib.param_specs(cfg, L))
    else:
        layer["mlp"] = {"w_up": w(d, L, d, f), "w_down": w(f, L, f, d)}
        if cfg.mlp_gated:
            layer["mlp"]["w_gate"] = w(d, L, d, f)
    return layer


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict mirroring the params: each leaf is (shape, scale), with
    scale the normal's std (fan_in ** -0.5 by default, 1.0 for the
    embedding — the reference's layers._init) or ONES for norm scales; a
    third entry F32 keeps the leaf in f32 (`leaf_dtype`).  Stacked layer
    leaves carry the leading L: p["stack"]["stack"] for the dense family,
    p["stack_dense"]["stack"] (first_dense_layers) and
    p["stack_moe"]["stack"] for the MoE family, as the reference names
    them."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                         f"decoder-only transformer (dense, moe, vlm)")
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": {"table": ((cfg.vocab, d), 1.0)},
        "final_norm": {"scale": ((d,), ONES)},
    }
    for kind, count in _layer_kinds(cfg):
        specs[_stack_name(cfg, kind)] = {
            "stack": _layer_specs(cfg, kind, count)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ((d, cfg.vocab), d ** -0.5)}
    if cfg.family == "vlm":
        f = cfg.frontend_dim
        specs["frontend"] = {"w": ((f, d), f ** -0.5)}
    return specs


def map_specs(fn, specs, path: str = ""):
    """Apply fn(path, (shape, scale)) to every leaf of a spec tree."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, f"{path}/{k}" if path else k)
                for k, v in specs.items()}
    return fn(path, specs)


def leaf_dtype(spec, cfg: ModelConfig) -> torch.dtype:
    """The dtype of a spec leaf: f32 where it is marked F32, else
    cfg.param_dtype."""
    return torch.float32 if spec[2:] == (F32,) \
        else torch_dtype(cfg.param_dtype)


#: a normal draw larger than this in f32 is drawn slice by slice along
#: the leaf's leading (layer) dim: phi3.5-moe's stacked expert weights
#: at 24 layers are 40 GB in f32, which do not fit beside the model
SLICED_DRAW_BYTES = 8 << 30


def init_from_specs(specs, cfg: ModelConfig, seed: int,
                    device: torch.device) -> Params:
    """Seeded random params with the reference's distributions: normal
    draws in f32 times the leaf's scale, or the leaf's constant fill, in
    the leaf's dtype.  Which leaves are drawn by slices follows their
    shapes alone, so a model's draws in f32 and in bf16 are the same."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device) * scale

    def leaf(_, spec):
        shape, scale = spec[:2]
        dtype = leaf_dtype(spec, cfg)
        if isinstance(scale, tuple):
            return torch.full(shape, scale[1], dtype=dtype, device=device)
        if 4 * math.prod(shape) <= SLICED_DRAW_BYTES:
            return draw(shape, scale).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in out:
            part.copy_(draw(part.shape, scale))
        return out
    return map_specs(leaf, specs)


def init_params(cfg: ModelConfig, seed: int, device: torch.device) -> Params:
    return init_from_specs(param_specs(cfg), cfg, seed, device)


def _layer(stack: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def _unstack(stack: Params, n: int) -> List[Params]:
    """The [L, ...] stacked layer params as L per-layer dicts (views, by
    one unbind per leaf: autograd stacks their gradients back once)."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in stack.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def decoder_layer(p: Params, x: torch.Tensor, rt: Runtime,
                  positions: torch.Tensor, kind: str = "dense", table=None,
                  cache: Optional[Params] = None,
                  pos: Optional[torch.Tensor] = None,
                  block_table: Optional[torch.Tensor] = None):
    """Pre-norm block; with a cache, writes this layer's cache rows in
    place.  Returns (x, table, aux): an MoE layer emits into the fold
    table and returns its router loss, a dense layer returns the table
    as given and aux None."""
    h = norm(p["norm1"], x, rt)
    a, _ = attention(p, h, rt, positions, cache, pos, block_table)
    x = x + a
    h = norm(p["norm2"], x, rt)
    if kind == "moe":
        y, table, aux = moe_lib.moe(p, h, rt, table)
    else:
        y, aux = mlp(p, h, rt), None
    return x + y, table, aux


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots_saveable": keep the
    matmul outputs, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """fn wrapped per cfg.remat.  The static costs register once, on the
    first run of the layer: the recompute in the backward runs under a
    zero multiplier, so one loss_fn call counts one forward, as one trace
    does in the reference.  A fold table passed in and returned by fn
    counts once too: the recompute's outputs are thrown away."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots_saveable"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    kw = {}
    if cfg.remat == "dots_saveable":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_matmuls)

    def run(*args):
        calls = []

        def body(*a):
            calls.append(None)
            if len(calls) == 1:
                return fn(*a)
            with scan_multiplier(0):
                return fn(*a)
        return ckpt.checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def _stacks(p: Params, cfg: ModelConfig):
    """(kind, count, stacked params) of each layer stack, in order."""
    for kind, count in _layer_kinds(cfg):
        yield kind, count, p[_stack_name(cfg, kind)]["stack"]


@hlo_flows.scoped("embed")
def _project_patches(p: Params, patches, rt: Runtime) -> torch.Tensor:
    """The frontend's features [B, P, frontend_dim] (the vlm's patches,
    the enc-dec's frames; numpy or a tensor) -> embeddings [B, P, d] in
    the compute dtype.  With p["frontend"]["w"]'s columns split over a
    model axis, this rank's columns of the projection are gathered over
    'model' (its backward takes this rank's block of the gradient).
    Like the reference's, the projection registers no static cost."""
    x = torch.as_tensor(patches, device=rt.device).to(rt.cdtype)
    w = p["frontend"]["w"]
    y = linear(w, x)
    if tp.split_over_model(w.shape[-1], rt.cfg.d_model):
        y = tp.gather_rows(y, get_runtime_mesh(), tp.model_axes()[0],
                           dim=-1)
    return y


def _with_prefix(x: torch.Tensor, prefix_embeds: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The token embeddings x [B, T, d] behind the prefix [B, P, d]."""
    if prefix_embeds is None:
        return x
    return torch.cat([prefix_embeds.to(x.dtype), x], dim=1)


def forward(p: Params, tokens: torch.Tensor, rt: Runtime, table,
            prefix_embeds: Optional[torch.Tensor] = None):
    """tokens: [B, S] -> (hidden [B, P + S, d] after the final norm,
    table, aux_total: the MoE layers' router losses summed, 0 for the
    dense family).  prefix_embeds: [B, P, d], the vlm's projected patches
    put before the text (P = 0 without).  Causal attention over the
    P + S positions, no cache; each layer rematerialized per cfg.remat.
    The fold table goes in and out of each layer's checkpointed body, so
    the recompute in the backward emits into a table nobody keeps."""
    cfg = rt.cfg
    x = _with_prefix(embed(p, torch.as_tensor(tokens, device=rt.device), rt),
                     prefix_embeds)
    positions = torch.arange(x.shape[1], device=rt.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=rt.device)
    for kind, count, stack in _stacks(p, cfg):
        body = _remat(lambda lp, h, t, kind=kind: decoder_layer(
            lp, h, rt, positions, kind, t), cfg)
        for layer_p in _unstack(stack, count):
            x, table, aux = body(layer_p, x, table)
            if aux is not None:
                aux_total = aux_total + aux
    x = norm(p["final_norm"], x, rt)
    return x, table, aux_total


def lm_loss(forward_fn, p: Params, batch: Dict[str, Any], rt: Runtime,
            table, prefix_embeds: Optional[torch.Tensor] = None):
    """The causal LM loss of a family's `forward_fn(p, tokens, rt,
    table[, prefix_embeds]) -> (hidden, table, aux)`.  batch: tokens
    [B, S], labels [B, S], mask [B, S] (numpy or tensors) -> (loss + aux,
    (metrics, table)), metrics holding loss, aux_loss and the count of
    tokens.  With prefix_embeds [B, P, d] the hidden states of the P
    prefix positions are dropped before the lm head: the loss counts the
    text positions only."""
    labels = torch.as_tensor(batch["labels"], device=rt.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=rt.device)
    if prefix_embeds is None:
        x, table, aux = forward_fn(p, batch["tokens"], rt, table)
    else:
        x, table, aux = forward_fn(p, batch["tokens"], rt, table,
                                   prefix_embeds)
        x = x[:, prefix_embeds.shape[1]:]
    logits = lm_head(p, x, rt)
    mesh = get_runtime_mesh()
    if mesh is None:
        loss = cross_entropy(logits, labels, mask)
        tokens = (mask.float().sum() if mask is not None
                  else torch.full((), float(labels.numel()),
                                  device=rt.device))
    else:
        with hlo_flows.component("loss"):
            loss, tokens = _mesh_loss(logits, labels, mask, rt, mesh)
    metrics = {"loss": loss, "aux_loss": aux, "tokens": tokens}
    return loss + aux, (metrics, table)


def _mesh_loss(logits, labels, mask, rt: Runtime, mesh):
    """(loss, tokens) of this rank's rows under a mesh."""
    # this rank's rows of the global batch: the NLL summed here and
    # the masked-token count, each summed over the batch axes, so the
    # loss (and, through reduce_from's identity backward, the
    # gradient once the trainer sums it over 'data') is the one
    # device's on the global batch
    nll = token_nll(logits, labels, rt)
    m = (mask.float() if mask is not None else torch.ones_like(nll))
    batch = mesh_axes("batch")
    tokens = mesh_lib.all_reduce(m.sum(), mesh, batch)
    loss = (tp.reduce_from((nll * m).sum(), mesh, batch)
            / torch.clamp(tokens, min=1.0))
    return loss, tokens


def loss_fn(p: Params, batch: Dict[str, Any], rt: Runtime, table):
    """The decoder's causal LM loss (see `lm_loss`); the vlm's batch also
    holds patches [B, P, frontend_dim], projected into its prefix."""
    prefix = (_project_patches(p, batch["patches"], rt)
              if rt.cfg.family == "vlm" else None)
    return lm_loss(forward, p, batch, rt, table, prefix)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype: Optional[torch.dtype] = None
               ) -> Params:
    dtype = dtype or torch_dtype(cfg.compute_dtype)
    return init_kv_cache(cfg, batch, max_len, cfg.n_layers, dtype, device)


def forward_chunk(p: Params, tokens: torch.Tensor, rt: Runtime, table,
                  cache: Params, pos: torch.Tensor,
                  valid: Optional[torch.Tensor] = None,
                  block_table: Optional[torch.Tensor] = None,
                  prefix_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Params, Any]:
    """THE serving entry point: write a T-token chunk at per-slot offsets.

    tokens: [B, T]; pos: [B] int32 per-slot cache depths (a scalar
    broadcasts); valid: [B] real tokens of the chunk (None = T;
    bucket-padded chunks mask the pad).  The cache is updated in place.
    block_table: [B, NB] page ids when `cache` is a page arena (one int32
    copy to the device per call).  `table` is the device fold table,
    carried layer by layer: each MoE layer emits into it (None folds
    nothing).  prefix_embeds: [B, P, d] (the vlm's projected patches) go
    before the tokens: the chunk is then P + T rows written from pos, and
    valid counts its rows, prefix included.
    Returns (last-valid-token logits [B, V], cache, table)."""
    dev = rt.device
    tokens = torch.as_tensor(tokens, device=dev)
    x = _with_prefix(embed(p, tokens, rt), prefix_embeds)
    B, T = x.shape[:2]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev).expand(B) \
        .contiguous()
    positions = pos[:, None] + torch.arange(T, device=dev)[None, :]
    if valid is not None:
        valid = torch.as_tensor(valid, device=dev)
    if block_table is not None:
        block_table = torch.as_tensor(block_table, dtype=torch.int32,
                                      device=dev).contiguous()
    i = 0                       # layer index into the stacked [L] cache
    for kind, count, stack in _stacks(p, rt.cfg):
        for j in range(count):
            x, table, _ = decoder_layer(
                _layer(stack, j), x, rt, positions, kind, table,
                {name: leaf[i] for name, leaf in cache.items()}, pos,
                block_table)
            i += 1
    x = norm(p["final_norm"], x, rt)
    logits = lm_head(p, last_valid(x, valid), rt)[:, 0]
    return logits, cache, table


def prefill(p: Params, tokens: torch.Tensor, rt: Runtime, table,
            cache: Params, prefix_embeds: Optional[torch.Tensor] = None):
    """Bulk prefill = forward_chunk at offset 0 with T = prompt length
    (behind the vlm's prefix, when given)."""
    zero = torch.zeros((tokens.shape[0],), dtype=torch.int32,
                       device=rt.device)
    return forward_chunk(p, tokens, rt, table, cache, zero,
                         prefix_embeds=prefix_embeds)


def decode_step(p: Params, token: torch.Tensor, rt: Runtime, table,
                cache: Params, pos: torch.Tensor):
    """Pooled decode = forward_chunk at width T = 1.  token: [B]."""
    token = torch.as_tensor(token, device=rt.device)
    return forward_chunk(p, token[:, None], rt, table, cache, pos)


# ------------------------------------------------------- paged serving ----
def init_paged_cache(cfg: ModelConfig, pages: int, page_size: int,
                     device: torch.device,
                     dtype: Optional[torch.dtype] = None) -> Params:
    """Page-arena KV cache: init_cache's per-slot batch dim becomes the
    PAGE dim, k, v [L, P, Hkv, page_size, h] (MLA: ckv [L, P, page_size,
    r], krope [L, P, page_size, dr]).  The engine's block tables
    map (slot, virtual page) -> arena page; page 0 is reserved scratch."""
    return init_cache(cfg, pages, page_size, device, dtype)


def forward_chunk_paged(p: Params, tokens: torch.Tensor, rt: Runtime, table,
                        cache: Params, pos: torch.Tensor,
                        block_table: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        prefix_embeds: Optional[torch.Tensor] = None):
    """forward_chunk against the page arena: the same math, every cache
    write and read through block_table [B, NB]."""
    return forward_chunk(p, tokens, rt, table, cache, pos, valid=valid,
                         block_table=block_table,
                         prefix_embeds=prefix_embeds)


def decode_step_paged(p: Params, token: torch.Tensor, rt: Runtime, table,
                      cache: Params, pos: torch.Tensor,
                      block_table: torch.Tensor):
    """Pooled paged decode = forward_chunk_paged at width T = 1."""
    token = torch.as_tensor(token, device=rt.device)
    return forward_chunk_paged(p, token[:, None], rt, table, cache, pos,
                               block_table)


def declare_fold_slots(spec: DeviceFoldSpec, cfg: ModelConfig) -> None:
    if cfg.moe:
        moe_lib.declare_moe_slots(spec, cfg)
    spec.declare("app", "loss", "train_step", "count")
