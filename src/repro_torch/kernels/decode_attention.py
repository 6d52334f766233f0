"""Flash-decode and positioned-chunk attention, over a contiguous cache or
a page arena: the CUDA kernels' wrappers (csrc/decode_attention.cu).

Replace the Pallas TPU kernels `repro/kernels/decode_attention.py::
decode_attention`, `::chunk_attention`, `::decode_attention_paged` and
`::chunk_attention_paged`.  For CUDA tensors a wrapper launches its
kernel or raises; for CPU tensors it runs the plain version in `ref`.
Each wrapper's `.launches` counts its kernel launches, nothing else.

Unlike the Pallas kernels, S needs no tile multiple: the kernels mask the
ragged tail.  Head dims 32, 64, 80 and 128 are compiled.  MLA's latent
attention (head dim 576: 512 latent + 64 rope columns over one latent kv
head) has its own entry points in `mla_attention`, which read the latent
cache in place; on the card these wrappers refuse head dim 576 and name
them (their plain versions, on the CPU, take every head dim).  bf16 runs
on the tensor cores (chunk attention: wgmma; decode: mma.sync), f32 on the
FMA pipes.  Decode cuts S into the ranges of `decode_splits`, which follow
(S, D) alone; when a chunk gives a row few query tiles, `chunk_splits`
cuts its columns too, by a plan that follows (Hkv, G, T, S, D) alone (at
D 576 both plan the latent kernel's ranges).
Neither plan reads B or the offsets, so a row's output does not depend on
the rows beside it.  Either kernel merges its ranges in the same launch,
with per-device scratch (`scratch`) whose arrival counters every launch
leaves at 0: no call allocates or clears anything but its outputs, once
the scratch has grown to its size.

The paged kernels read K/V row j of batch row b from
`pages[block_table[b, j // page_size], :, j % page_size]`, any
page_size >= 1 (bf16 chunk attention copies its 64-row tiles by TMA when
the page size is a multiple of 64, and gathers 16-byte chunks
otherwise).  Each row stops at its own limit (kv_len, or pos + t),
clamped to NB * page_size as the plain version's gather is, so no table
slot past it is read.  Page ids are not range-checked on the device: a
block table holds only pages the engine granted (or scratch page 0), and
that is the engine's contract.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import build, ref
from .rmsnorm import DTYPES, check_cuda, check_vectors, stream

HEAD_DIMS = (32, 64, 80, 128)
LATENT_DIM = 576    # MLA's latent head dim: `mla_attention`'s entry points
TILE = 64           # K/V rows per tile in the kernels (the split ranges' unit)
MAX_SPLITS = 64     # S ranges per (row, kv head) the merges take
CHUNK_ROWS = 128    # query rows per block of the bf16 chunk kernel
WIDE_CHUNK_ROWS = 64   # ... at a wide head dim (D 576)
DECODE_RANGE = 8 * TILE   # rows per decode split range (more past MAX_SPLITS)
#: ... at a wide head dim (the latent kernel, one block an SM): each range
#: adds a partial to the row's in-launch merge; at S 2048 and B 8, 8 ranges
#: of 256 ran 7% faster on the card than 16 of 128, and 4 of 512 17%
#: slower (chip_ab.py phase mla)
WIDE_DECODE_RANGE = 4 * TILE
DECODE_ROWS = 16    # q heads per block of the bf16 decode kernel
#: blocks below which one row's chunk gets split columns: a full prefill
#: group (8 rows, the engine's max_batch) then puts two blocks on each of
#: an H100's 132 SMs
CHUNK_ROW_BLOCKS = 33
#: ... at a wide head dim: the latent kernel runs one block an SM, and
#: each range it adds costs its tile's merge (at T 8, 8 ranges of 256 ran
#: 27% faster on the card than 16 of 128, and 4 of 512 2% slower;
#: chip_ab.py phase mla)
WIDE_ROW_BLOCKS = 16


def _whole(S: int) -> Tuple[int, int]:
    """One range of whole tiles covering S."""
    return 1, max(1, -(-S // TILE)) * TILE


def wide(D: int) -> bool:
    """True for a head dim past 128: D 576, the latent kernel's plans."""
    return D > 128


def decode_splits(S: int, D: int = 64) -> Tuple[int, int]:
    """(nsplit, split_rows) for the decode kernels at head dim D: S cut
    into ranges of DECODE_RANGE rows (WIDE_DECODE_RANGE at a wide D;
    whole tiles, longer when S needs more than MAX_SPLITS of them).  The
    plan follows (S, D) alone, never the batch or kv_len, so a row's
    output does not depend on the rows beside it, and planning needs no
    host sync."""
    tiles = max(1, -(-S // TILE))
    rng = WIDE_DECODE_RANGE if wide(D) else DECODE_RANGE
    per = max(rng // TILE, -(-tiles // MAX_SPLITS))
    return -(-tiles // per), per * TILE


def chunk_rows(D: int) -> int:
    """Query rows per block of the bf16 chunk kernel at head dim D."""
    return WIDE_CHUNK_ROWS if wide(D) else CHUNK_ROWS


def chunk_splits(Hkv: int, G: int, T: int, S: int, D: int = 64
                 ) -> Tuple[int, int]:
    """(nsplit, split_cols) for the bf16 chunk kernel at head dim D.  It
    runs one block per (row, kv head, tile of chunk_rows(D) query rows),
    so one row gives Hkv * ceil(G*T / chunk_rows(D)) blocks, each walking
    the columns its rows see.  A short chunk deep in the cache gives few
    blocks with long walks: below CHUNK_ROW_BLOCKS of them, S is cut into
    ceil(CHUNK_ROW_BLOCKS / blocks) ranges of whole tiles (at most
    MAX_SPLITS), one block each, and the kernel merges them in range
    order; otherwise one range covers S.  The plan follows (Hkv, G, T, S,
    D) alone, never B or pos, so a row's output is the same alone and in
    any batch, and planning needs no host sync."""
    per_row = Hkv * -(-G * T // chunk_rows(D))
    target = WIDE_ROW_BLOCKS if wide(D) else CHUNK_ROW_BLOCKS
    if per_row >= target:
        return _whole(S)
    tiles = max(1, -(-S // TILE))
    per = -(-tiles // min(MAX_SPLITS, -(-target // per_row)))
    return -(-tiles // per), per * TILE


def chunk_plan(B: int, Hkv: int, G: int, T: int, S: int, D: int):
    """(grid blocks before the split, nsplit, split_cols, partial values)
    of a bf16 chunk launch: one block per (row, kv head, query tile) and
    range, the ranges from `chunk_splits`; a split block writes
    chunk_rows(D) rows of (acc [D], m, l)."""
    rows = chunk_rows(D)
    blocks = B * Hkv * -(-G * T // rows)
    nsplit, cols = chunk_splits(Hkv, G, T, S, D)
    part = blocks * nsplit * rows * (D + 2) if nsplit > 1 else 0
    return blocks, nsplit, cols, part


#: per device: (f32 partials, int32 arrival counters), grown on demand
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(device: torch.device, n_part: int, n_done: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split merges' scratch on `device`: f32 partials of at least
    n_part values and at least n_done int32 arrival counters, kept from
    call to call and grown when a launch needs more.  The counters are
    zeroed once, when allocated: the block that merges a unit resets its
    counter, so every launch leaves them all 0 and no call pays a memset.
    Launches that share them run in stream order."""
    part, done = _SCRATCH.get(device, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1), dtype=torch.float32, device=device)
    if done is None or done.numel() < n_done:
        done = torch.zeros(max(n_done, 1), dtype=torch.int32, device=device)
    _SCRATCH[device] = (part, done)
    return part, done


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lens: torch.Tensor, what: str,
           block_table: Optional[torch.Tensor] = None) -> None:
    """Operands the kernels take: k/v are [B, Hkv, S, D] rows, or with a
    block table [P, Hkv, page_size, D] pages and block_table [B, NB]."""
    check_cuda(q, what)
    D = q.shape[-1]
    if D == LATENT_DIM:
        latent = what.replace("_attention", "_attention_latent")
        raise ValueError(
            f"{what}: head dim {D} is MLA's latent attention; on the card "
            f"call mla_attention.{latent} with the latent cache (ckv, "
            f"krope), which the kernel reads in place")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what} kernel compiles head dims {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape != v.shape or k.shape[-1] != D or (
            block_table is None and k.shape[0] != q.shape[0]):
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
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
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"{what}: {q.shape[1]} q heads not a multiple of "
                         f"{k.shape[1]} kv heads")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: q, k, v must share dtype and device")
    for t in (q, k, v, lens):
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous operands")
    if lens.dtype != torch.int32 or lens.shape != (q.shape[0],) \
            or lens.device != q.device:
        raise ValueError(f"{what}: lengths must be int32 [B] on {q.device}")
    check_vectors(D, q, k, v)


def decode_plan(B: int, Hkv: int, G: int, S: int, D: int):
    """(grid units, nsplit, split_rows, partial values) of a decode launch
    over a virtual length S: one unit per (row, kv head, group of
    DECODE_ROWS q heads), split_rows from `decode_splits`; a unit's range
    writes min(G, DECODE_ROWS) rows of (acc [D], m, l)."""
    units = B * Hkv * -(-G // DECODE_ROWS)
    nsplit, split_rows = decode_splits(S, D)
    part = units * nsplit * min(G, DECODE_ROWS) * (D + 2) if nsplit > 1 else 0
    return units, nsplit, split_rows, part


def _decode_scratch(B: int, Hq: int, Hkv: int, S: int, D: int,
                    device: torch.device):
    """(nsplit, split_rows, partials, arrival counters) for a decode
    launch over a virtual length S."""
    units, nsplit, split_rows, n_part = decode_plan(B, Hkv, Hq // Hkv, S, D)
    part, done = scratch(device, n_part, units)
    return nsplit, split_rows, part, done


def _chunk_scratch(q: torch.Tensor, Hkv: int, S: int):
    """(nsplit, split_cols, partials or None, arrival counters or None)
    for a chunk launch over a length S.  bf16 plans its split
    (chunk_plan); the f32 FMA kernel does not split."""
    B, Hq, T, D = q.shape
    if q.dtype != torch.bfloat16:
        return (*_whole(S), None, None)
    blocks, nsplit, cols, n_part = chunk_plan(B, Hkv, Hq // Hkv, T, S, D)
    if nsplit == 1:
        return nsplit, cols, None, None
    part, done = scratch(q.device, n_part, blocks)
    return nsplit, cols, part, done


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return t.data_ptr() if t is not None else None


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     kv_len: Optional[torch.Tensor] = None,
                     sm_scale: Optional[float] = None,
                     return_residuals: bool = False):
    """q: [B, Hq, D]; k, v: [B, Hkv, S, D]; kv_len: [B] int32 (None = S)
    -> [B, Hq, D] (+ (m, l) [B, Hq] f32 with return_residuals)."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, kv_len=kv_len,
                                    sm_scale=sm_scale,
                                    return_residuals=return_residuals)
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    if kv_len is None:
        kv_len = torch.full((B,), S, dtype=torch.int32, device=q.device)
    _check(q, k, v, kv_len, "decode_attention")
    scale = sm_scale if sm_scale is not None else D ** -0.5
    o = torch.empty_like(q)
    m = l = None
    if return_residuals:
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    nsplit, split_rows, part, done = _decode_scratch(B, Hq, Hkv, S, D,
                                                     q.device)
    err = build.load("decode_attention").decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), _ptr(m), _ptr(l), _ptr(part), done.data_ptr(),
        B, Hkv, Hq // Hkv, S, D, nsplit, split_rows, float(scale),
        DTYPES[q.dtype], stream(q))
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return (o, (m, l)) if return_residuals else o


decode_attention.launches = 0


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    pos: torch.Tensor, sm_scale: Optional[float] = None
                    ) -> torch.Tensor:
    """q: [B, Hq, T, D] at per-row offsets pos [B] int32; k, v:
    [B, Hkv, S, D] the full cache -> [B, Hq, T, D].  Query t of row b
    attends cache columns <= pos[b] + t."""
    if q.device.type == "cpu":
        return ref.chunk_attention(q, k, v, pos=pos, sm_scale=sm_scale)
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    _check(q, k, v, pos, "chunk_attention")
    scale = sm_scale if sm_scale is not None else D ** -0.5
    o = torch.empty_like(q)
    nsplit, cols, part, done = _chunk_scratch(q, Hkv, S)
    err = build.load("decode_attention").chunk_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), _ptr(part), _ptr(done), B, Hkv, Hq // Hkv, T, S, D,
        nsplit, cols, float(scale), DTYPES[q.dtype], stream(q))
    build.check(err, "chunk_attention")
    chunk_attention.launches += 1
    return o


chunk_attention.launches = 0


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, *,
                           block_table: torch.Tensor,
                           kv_len: Optional[torch.Tensor] = None,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, D]; k_pages, v_pages: [P, Hkv, page_size, D];
    block_table: [B, NB] int32; kv_len: [B] int32 (None = NB*page_size)
    -> [B, Hq, D].  The decode kernel's split-S design over the virtual
    length NB*page_size: one launch per tick."""
    if q.device.type == "cpu":
        return ref.decode_attention_paged(q, k_pages, v_pages,
                                          block_table=block_table,
                                          kv_len=kv_len, sm_scale=sm_scale)
    B, Hq, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    NB = block_table.shape[-1]
    if kv_len is None:
        kv_len = torch.full((B,), NB * ps, dtype=torch.int32,
                            device=q.device)
    _check(q, k_pages, v_pages, kv_len, "decode_attention_paged",
           block_table=block_table)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    o = torch.empty_like(q)
    nsplit, split_rows, part, done = _decode_scratch(B, Hq, Hkv, NB * ps, D,
                                                     q.device)
    err = build.load("decode_attention").decode_attention_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), kv_len.data_ptr(), o.data_ptr(),
        _ptr(part), done.data_ptr(), B, Hkv, Hq // Hkv, k_pages.shape[0],
        NB, ps, D, nsplit, split_rows, float(scale),
        DTYPES[q.dtype], stream(q))
    build.check(err, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return o


decode_attention_paged.launches = 0


def chunk_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, *, block_table: torch.Tensor,
                          pos: torch.Tensor,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Hq, T, D] at per-row offsets pos [B] int32; k_pages,
    v_pages: [P, Hkv, page_size, D]; block_table: [B, NB] int32 ->
    [B, Hq, T, D].  Query t of row b attends virtual columns
    <= pos[b] + t of its pages."""
    if q.device.type == "cpu":
        return ref.chunk_attention_paged(q, k_pages, v_pages,
                                         block_table=block_table, pos=pos,
                                         sm_scale=sm_scale)
    B, Hq, T, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    NB = block_table.shape[-1]
    _check(q, k_pages, v_pages, pos, "chunk_attention_paged",
           block_table=block_table)
    scale = sm_scale if sm_scale is not None else D ** -0.5
    o = torch.empty_like(q)
    nsplit, cols, part, done = _chunk_scratch(q, Hkv, NB * ps)
    err = build.load("decode_attention").chunk_attention_paged_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), pos.data_ptr(), o.data_ptr(), _ptr(part),
        _ptr(done), B, Hkv, Hq // Hkv, T, k_pages.shape[0], NB, ps, D, nsplit,
        cols, float(scale), DTYPES[q.dtype], stream(q))
    build.check(err, "chunk_attention_paged")
    chunk_attention_paged.launches += 1
    return o


chunk_attention_paged.launches = 0
