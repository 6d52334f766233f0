"""Flash attention forward and backward: the CUDA kernels' wrappers
(csrc/flash_attention.cu).

`flash_attention` replaces the Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`;
`flash_attention_backward` computes what the reference's custom VJP
`repro/kernels/ref.py::_flash_chunked_bwd_impl` computes (the Pallas
kernel is forward-only).  `FlashAttention` is the autograd Function that
pairs them: it saves (q, k, v, o, lse) and recomputes p in the backward.
For CUDA tensors a wrapper launches its kernel or raises; for CPU tensors
it runs the plain version in `ref`.  Each wrapper's `.launches` counts its
kernel launches, nothing else.

Causal masking follows the reference oracle: query t sees columns
<= t + Sk - Sq.  A row that sees no column (Sq > Sk) gives zeros and
lse = -1e30.  S needs no tile multiple.  The compiled (q/k, v) head dims
are HEAD_DIMS: equal at 32, 64, 80 and 128 (80 on the 128-column tile
layout), and MLA training's (192, 128), where v keeps its own width: the
reference pads v to 192 and drops o's zero columns, and o and dv here
are that function's first 128 columns.  bf16 runs on the tensor cores
(P and dS rounded to bf16 for their products, as FlashAttention-2 does;
o kept in f32 for the backward's delta), f32 on the FMA pipes in f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build, ref
from .rmsnorm import DTYPES, check_cuda, check_vectors, stream

#: compiled (q/k head dim, v head dim) pairs
HEAD_DIMS = ((32, 32), (64, 64), (80, 80), (128, 128), (192, 128))


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *rest: torch.Tensor) -> None:
    """q [B, Hq, Sq, D]; k [B, Hkv, Sk, D]; v [B, Hkv, Sk, Dv]; `rest`
    [B, Hq, Sq, Dv] (o, dO)."""
    check_cuda(q, what)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or k.shape[:3] != v.shape[:3] or k.shape[0] != q.shape[0] \
            or k.shape[-1] != q.shape[-1] or q.shape[1] % k.shape[1]:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if (q.shape[-1], v.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f"{what} kernel compiles (q/k, v) head dims "
                         f"{HEAD_DIMS}, got ({q.shape[-1]}, {v.shape[-1]})")
    for t in (k, v) + rest:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: operands must share dtype and device")
    want = q.shape[:3] + v.shape[-1:]
    for t in rest:
        if t.shape != want:
            raise ValueError(f"{what}: {tuple(t.shape)} is not o's shape "
                             f"{tuple(want)}")
    for t in (q, k, v) + rest:
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel needs contiguous operands")
    check_vectors(q.shape[-1], q, k)
    check_vectors(v.shape[-1], v, *rest)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    logit_softcap: float = 0.0, keep_f32: bool = False):
    """q: [B, Hq, Sq, D]; k: [B, Hkv, Sk, D]; v: [B, Hkv, Sk, Dv] ->
    (o [B, Hq, Sq, Dv] in q's dtype, lse [B, Hq, Sq] f32, o32): o32 is
    None, or with keep_f32 o in f32 before its rounding to q's dtype,
    which flash_attention_backward takes."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    if q.device.type == "cpu":
        # the plain version computes in f32 and rounds o at its end
        o32, lse = ref.attention(q.float(), k.float(), v.float(),
                                 causal=causal, sm_scale=sm_scale,
                                 logit_softcap=logit_softcap,
                                 q_offset=Sk - Sq if causal else 0,
                                 return_lse=True)
        return o32.to(q.dtype), lse, o32 if keep_f32 else None
    _check("flash_attention", q, k, v)
    Hkv, Dv = k.shape[1], v.shape[-1]
    o = q.new_empty((B, Hq, Sq, Dv))
    o32 = torch.empty_like(o, dtype=torch.float32) \
        if keep_f32 and q.dtype != torch.float32 else None
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = build.load("flash_attention").flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        0 if o32 is None else o32.data_ptr(), lse.data_ptr(), B, Hkv,
        Hq // Hkv, Sq, Sk, D, Dv, int(causal), _scale(q, sm_scale),
        float(logit_softcap), DTYPES[q.dtype], stream(q))
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    if keep_f32 and o32 is None:
        o32 = o
    return o, lse, o32


flash_attention.launches = 0


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True,
                             sm_scale: Optional[float] = None,
                             logit_softcap: float = 0.0):
    """The backward of flash_attention from its inputs, its output in f32
    (its o32) and lse: do like o -> (dq, dk, dv) like (q, k, v).  delta =
    rowsum(dO * o) is taken from o as given: only o before its rounding
    makes each row's dS sum to zero over its columns, as the plain
    version's autograd does.  On the card: a delta pre-pass, then one
    dK/dV kernel and one dQ kernel (no atomics; the same bits on every
    run), counted as one launch of the backward."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    if o.dtype != torch.float32 or o.shape != do.shape \
            or o.device != q.device:
        raise ValueError(f"flash_attention_backward: o must be f32 "
                         f"{tuple(do.shape)} on {q.device}, got {o.dtype} "
                         f"{tuple(o.shape)} on {o.device}")
    if q.device.type == "cpu":
        return ref.attention_backward(q, k, v, o, lse, do, causal=causal,
                                      sm_scale=sm_scale,
                                      logit_softcap=logit_softcap,
                                      q_offset=Sk - Sq if causal else 0)
    _check("flash_attention_backward", q, k, v, do)
    o = o.contiguous()
    check_vectors(o.shape[-1], o)
    if lse.dtype != torch.float32 or lse.shape != (B, Hq, Sq) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_backward: lse must be contiguous "
                         f"f32 [{B}, {Hq}, {Sq}] on {q.device}")
    Hkv = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = build.load("flash_attention").flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Hkv, Hq // Hkv, Sq, Sk, D,
        v.shape[-1], int(causal), _scale(q, sm_scale), float(logit_softcap),
        DTYPES[q.dtype], stream(q))
    build.check(err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention whose backward recomputes p from the saved
    (q, k, v, o, lse), as the FlashAttention-2 backward does, with o
    saved in f32 before its rounding.
    apply(q, k, v, causal, sm_scale, logit_softcap) -> o."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, logit_softcap):
        o, lse, o32 = flash_attention(q, k, v, causal=causal,
                                      sm_scale=sm_scale,
                                      logit_softcap=logit_softcap,
                                      keep_f32=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.opts = dict(causal=causal, sm_scale=sm_scale,
                        logit_softcap=logit_softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse,
                                              do.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None
