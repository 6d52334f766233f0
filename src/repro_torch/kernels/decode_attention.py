"""Flash-decode and positioned-chunk attention: the CUDA kernels' wrappers
(csrc/decode_attention.cu).

Replace the Pallas TPU kernels `repro/kernels/decode_attention.py::
decode_attention` and `::chunk_attention`.  For CUDA tensors a wrapper
launches its kernel or raises; for CPU tensors it runs the plain version
in `ref`.  `decode_attention.launches` and `chunk_attention.launches`
count kernel launches, nothing else.

Unlike the Pallas kernels, S needs no tile multiple: the kernels mask the
ragged tail.  Head dims 32, 64 and 128 are compiled.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build, ref
from .rmsnorm import DTYPES, check_cuda, check_vectors, stream

HEAD_DIMS = (32, 64, 128)
TILE = 64           # K/V rows per tile in the kernels
MAX_SPLITS = 64     # S ranges per (row, kv head) the decode merge takes


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_splits(B: int, Hkv: int, S: int, sms: int) -> Tuple[int, int]:
    """(nsplit, split_rows) for the decode kernel: S cut into whole tiles
    so that B*Hkv*nsplit blocks give about two per SM, at most MAX_SPLITS
    ranges."""
    tiles = -(-S // TILE)
    want = min(MAX_SPLITS, max(1, -(-2 * sms // max(B * Hkv, 1))))
    per = -(-tiles // want)
    return -(-tiles // per), per * TILE


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lens: torch.Tensor, what: str) -> None:
    check_cuda(q, what)
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"{what} kernel compiles head dims {HEAD_DIMS}, "
                         f"got {D}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[-1] != D:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
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
    m = l = part = None
    if return_residuals:
        m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    nsplit, split_rows = decode_splits(B, Hkv, S, _sm_count(q.get_device()))
    if nsplit > 1:   # per-range (acc, m, l) partials and arrival counters
        part = torch.empty(B * Hq * nsplit * (D + 2), dtype=torch.float32,
                           device=q.device)
    done = torch.zeros(B * Hkv, dtype=torch.int32, device=q.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = build.load("decode_attention").decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
        o.data_ptr(), ptr(m), ptr(l), ptr(part), done.data_ptr(),
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
    err = build.load("decode_attention").chunk_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), B, Hkv, Hq // Hkv, T, S, D, float(scale),
        DTYPES[q.dtype], stream(q))
    build.check(err, "chunk_attention")
    chunk_attention.launches += 1
    return o


chunk_attention.launches = 0
