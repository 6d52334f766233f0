"""Multi-head latent attention (MLA) over the latent cache, read in place:
the CUDA kernels' wrappers (csrc/mla_attention.cu).

The reference's `mla_attention` (DeepSeek-V2's matrix-absorbed serving
path) runs the Pallas TPU kernels `repro/kernels/decode_attention.py::
decode_attention`, `::chunk_attention` and their paged twins against one
latent kv head built from the cache on every call: k = [ckv | krope] and
v = ckv zero-padded to the same width, keeping the first r output
columns.  These wrappers compute that function from the cache as it lies,
ckv [B, S_max, 512] and krope [B, S_max, 64] (paged: arenas
[P, page_size, 512] and [P, page_size, 64] through one block table),
without building k or v: the kernel's K tile is its V tile.  They return
the 512 latent columns.  For CUDA tensors a wrapper launches its kernel or
raises; for CPU tensors it runs the plain version in `ref`, at any latent
widths.  Launches count into the `decode_attention` module's four
counters, one per TPU kernel replaced.

bf16 runs one wgmma kernel for decode and chunk (64 query rows a block;
decode's G q heads of one token padded to 64), f32 an FMA kernel.  The
split plans are `decode_attention.decode_splits` and `chunk_splits` at
head dim 576: they follow S, or (G, T, S), alone, so a row's output does
not depend on the rows beside it; the ranges merge in the launch, with
the per-device scratch of `decode_attention.scratch`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build, ref
from . import decode_attention as _dec
from .rmsnorm import DTYPES, check_cuda, stream

LATENT = 512        # ckv columns: the latent, V's and the output's width
ROPE = 64           # krope columns
ROWS = 64           # query rows a block of the bf16 kernel
HEAD_DIM = LATENT + ROPE
_ptr = _dec._ptr
#: dynamic shared memory of a bf16 block (csrc Smem::kBytes): Q, two ring
#: stages, P, the rows' rescales and sums, the barriers and the 1024-byte
#: alignment
SMEM_BYTES = 2 * HEAD_DIM * ROWS * 3 + 2 * ROWS * 64 + 4 * 2 * ROWS \
    + 8 * 4 + 4 + 1024


def plan(B: int, G: int, T: int, S: int, decode: bool,
         dtype: torch.dtype = torch.bfloat16):
    """(blocks before the split, nsplit, split_cols, partial values) of a
    launch over a (virtual) length S: one block per (row, tile of ROWS
    query rows) and range; bf16 takes its ranges from `decode_splits` (S
    alone) or `chunk_splits` (G, T, S alone) at head dim 576, and a split
    block writes ROWS rows of (acc [512], m, l); f32 does not split."""
    blocks = B * -(-G * T // ROWS)
    if dtype != torch.bfloat16:
        return blocks, *_dec._whole(S), 0
    nsplit, cols = (_dec.decode_splits(S, HEAD_DIM) if decode
                    else _dec.chunk_splits(1, G, T, S, HEAD_DIM))
    part = blocks * nsplit * ROWS * (LATENT + 2) if nsplit > 1 else 0
    return blocks, nsplit, cols, part


def _check(q: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor,
           lens: torch.Tensor, what: str,
           block_table: Optional[torch.Tensor] = None) -> None:
    """Operands the kernels take: q [B, G, (T,) 576]; ckv, krope
    [B, S, 512] / [B, S, 64], or with a block table [P, page_size, 512] /
    [P, page_size, 64] arenas and block_table [B, NB] int32."""
    check_cuda(q, what)
    if q.shape[-1] != HEAD_DIM or ckv.dim() != 3 or krope.dim() != 3 \
            or ckv.shape[-1] != LATENT or krope.shape[-1] != ROPE \
            or ckv.shape[:2] != krope.shape[:2] or (
                block_table is None and ckv.shape[0] != q.shape[0]):
        raise ValueError(
            f"{what}: the kernel takes q [..., {HEAD_DIM}] against ckv "
            f"[.., S, {LATENT}] and krope [.., S, {ROPE}] of one shape; got "
            f"q {tuple(q.shape)}, ckv {tuple(ckv.shape)}, krope "
            f"{tuple(krope.shape)}")
    if block_table is not None and (
            block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != q.shape[0]
            or block_table.shape[1] < 1
            or block_table.device != q.device
            or not block_table.is_contiguous()):
        raise ValueError(f"{what}: block_table must be contiguous int32 "
                         f"[{q.shape[0]}, NB >= 1] on {q.device}, got "
                         f"{block_table.dtype} {tuple(block_table.shape)} "
                         f"on {block_table.device}")
    for t in (ckv, krope):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: q, ckv, krope must share dtype and "
                             f"device")
    for t in (q, ckv, krope, lens):
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous operands")
    if lens.dtype != torch.int32 or lens.shape != (q.shape[0],) \
            or lens.device != q.device:
        raise ValueError(f"{what}: lengths must be int32 [B] on {q.device}")


def _scratch(q: torch.Tensor, G: int, T: int, S: int, decode: bool
             ) -> Tuple[int, int, Optional[torch.Tensor],
                        Optional[torch.Tensor]]:
    """(nsplit, split_cols, partials or None, arrival counters or None)."""
    blocks, nsplit, cols, n_part = plan(q.shape[0], G, T, S, decode, q.dtype)
    if nsplit == 1:
        return nsplit, cols, None, None
    part, done = _dec.scratch(q.device, n_part, blocks)
    return nsplit, cols, part, done


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)


def decode_attention_latent(q: torch.Tensor, ckv: torch.Tensor,
                            krope: torch.Tensor, *,
                            kv_len: Optional[torch.Tensor] = None,
                            sm_scale: Optional[float] = None,
                            return_residuals: bool = False):
    """q: [B, G, 576]; ckv: [B, S, 512]; krope: [B, S, 64]; kv_len: [B]
    int32 (None = S) -> [B, G, 512] (+ (m, l) [B, G] f32 with
    return_residuals).  K row j is [ckv[:, j] | krope[:, j]], V row j
    ckv[:, j]."""
    if q.device.type == "cpu":
        return ref.decode_attention_latent(q, ckv, krope, kv_len=kv_len,
                                           sm_scale=sm_scale,
                                           return_residuals=return_residuals)
    B, G, _ = q.shape
    S = ckv.shape[1]
    if kv_len is None:
        kv_len = torch.full((B,), S, dtype=torch.int32, device=q.device)
    _check(q, ckv, krope, kv_len, "decode_attention_latent")
    o = q.new_empty((B, G, LATENT))
    m = l = None
    if return_residuals:
        m = torch.empty((B, G), dtype=torch.float32, device=q.device)
        l = torch.empty((B, G), dtype=torch.float32, device=q.device)
    nsplit, rows, part, done = _scratch(q, G, 1, S, True)
    err = build.load("mla_attention").mla_decode_attention_launch(
        q.data_ptr(), ckv.data_ptr(), krope.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), _ptr(m), _ptr(l), _ptr(part), _ptr(done), B, G, S,
        nsplit, rows, _scale(q, sm_scale), DTYPES[q.dtype], stream(q))
    build.check(err, "decode_attention_latent")
    _dec.decode_attention.launches += 1
    return (o, (m, l)) if return_residuals else o


def chunk_attention_latent(q: torch.Tensor, ckv: torch.Tensor,
                           krope: torch.Tensor, *, pos: torch.Tensor,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, G, T, 576] at per-row offsets pos [B] int32; ckv, krope:
    [B, S, 512] / [B, S, 64] the full cache -> [B, G, T, 512].  Query t of
    row b attends cache columns <= pos[b] + t."""
    if q.device.type == "cpu":
        return ref.chunk_attention_latent(q, ckv, krope, pos=pos,
                                          sm_scale=sm_scale)
    B, G, T, _ = q.shape
    S = ckv.shape[1]
    _check(q, ckv, krope, pos, "chunk_attention_latent")
    o = q.new_empty((B, G, T, LATENT))
    nsplit, cols, part, done = _scratch(q, G, T, S, False)
    err = build.load("mla_attention").mla_chunk_attention_launch(
        q.data_ptr(), ckv.data_ptr(), krope.data_ptr(), pos.data_ptr(),
        o.data_ptr(), _ptr(part), _ptr(done), B, G, T, S, nsplit, cols,
        _scale(q, sm_scale), DTYPES[q.dtype], stream(q))
    build.check(err, "chunk_attention_latent")
    _dec.chunk_attention.launches += 1
    return o


def decode_attention_latent_paged(q: torch.Tensor, ckv_pages: torch.Tensor,
                                  krope_pages: torch.Tensor, *,
                                  block_table: torch.Tensor,
                                  kv_len: Optional[torch.Tensor] = None,
                                  sm_scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """q: [B, G, 576]; ckv_pages, krope_pages: [P, page_size, 512] /
    [P, page_size, 64]; block_table: [B, NB] int32 page ids of both;
    kv_len: [B] int32 (None = NB*page_size) -> [B, G, 512]."""
    if q.device.type == "cpu":
        return ref.decode_attention_latent_paged(
            q, ckv_pages, krope_pages, block_table=block_table,
            kv_len=kv_len, sm_scale=sm_scale)
    B, G, _ = q.shape
    P, ps, _ = ckv_pages.shape
    NB = block_table.shape[-1]
    if kv_len is None:
        kv_len = torch.full((B,), NB * ps, dtype=torch.int32,
                            device=q.device)
    _check(q, ckv_pages, krope_pages, kv_len, "decode_attention_latent_paged",
           block_table=block_table)
    o = q.new_empty((B, G, LATENT))
    nsplit, rows, part, done = _scratch(q, G, 1, NB * ps, True)
    err = build.load("mla_attention").mla_decode_attention_paged_launch(
        q.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        block_table.data_ptr(), kv_len.data_ptr(), o.data_ptr(), _ptr(part),
        _ptr(done), B, G, P, NB, ps, nsplit, rows, _scale(q, sm_scale),
        DTYPES[q.dtype], stream(q))
    build.check(err, "decode_attention_latent_paged")
    _dec.decode_attention_paged.launches += 1
    return o


def chunk_attention_latent_paged(q: torch.Tensor, ckv_pages: torch.Tensor,
                                 krope_pages: torch.Tensor, *,
                                 block_table: torch.Tensor, pos: torch.Tensor,
                                 sm_scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """q: [B, G, T, 576] at per-row offsets pos [B] int32; the arenas and
    block_table as `decode_attention_latent_paged` -> [B, G, T, 512].
    Query t of row b attends virtual columns <= pos[b] + t of its pages."""
    if q.device.type == "cpu":
        return ref.chunk_attention_latent_paged(
            q, ckv_pages, krope_pages, block_table=block_table, pos=pos,
            sm_scale=sm_scale)
    B, G, T, _ = q.shape
    P, ps, _ = ckv_pages.shape
    NB = block_table.shape[-1]
    _check(q, ckv_pages, krope_pages, pos, "chunk_attention_latent_paged",
           block_table=block_table)
    o = q.new_empty((B, G, T, LATENT))
    nsplit, cols, part, done = _scratch(q, G, T, NB * ps, False)
    err = build.load("mla_attention").mla_chunk_attention_paged_launch(
        q.data_ptr(), ckv_pages.data_ptr(), krope_pages.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), o.data_ptr(), _ptr(part),
        _ptr(done), B, G, T, P, NB, ps, nsplit, cols, _scale(q, sm_scale),
        DTYPES[q.dtype], stream(q))
    build.check(err, "chunk_attention_latent_paged")
    _dec.chunk_attention_paged.launches += 1
    return o
