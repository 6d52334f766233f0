"""Public wrappers for the port's kernels, with impl dispatch.

impl='auto'   -> the kernel wrapper: the CUDA kernel for a CUDA tensor,
                 the plain version for a CPU tensor; `attention` and
                 `rmsnorm` go through their autograd Functions, whose
                 backward is a kernel too
impl='kernel' -> the CUDA kernel; a CPU tensor raises
impl='ref'    -> the plain PyTorch version (tests and chip_smoke.py)

The reference picks by `jax.default_backend()`; the port picks by the
tensor's device.  Every wrapper registers its analytic FLOPs/bytes with
the XFA static-cost layer under the component that calls it, with the
reference's edges and formulas.
"""

from __future__ import annotations

import torch

from ..core import tracer as xfa
from ..core.device_fold import annotate_cost
from . import decode_attention as _dec
from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rms

IMPLS = ("auto", "kernel", "ref")


def _plain(impl: str, x: torch.Tensor) -> bool:
    """True for the plain version, False for the kernel wrapper."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel" and x.device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA tensor, got {x.device}")
    return impl == "ref"


def _bytes(*ts: torch.Tensor) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def attention(q, k, v, *, causal: bool = True, sm_scale=None,
              logit_softcap: float = 0.0, impl: str = "auto",
              component: str = "attention") -> torch.Tensor:
    """Training / no-cache attention: q [B, Hq, Sq, D] against k, v
    [B, Hkv, Sk, D]; causal rows see columns <= t + Sk - Sq, as the
    reference oracle's q_offset puts them."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    flops = 4.0 * B * Hq * Sq * Sk * D * (0.5 if causal and Sq == Sk else 1.0)
    annotate_cost(xfa.current_component(), component, "flash_attention",
                  flops=flops, bytes=_bytes(q, k, v) * 2)
    if _plain(impl, q):
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale,
                             logit_softcap=logit_softcap,
                             q_offset=Sk - Sq if causal else 0)
    return _fa.FlashAttention.apply(q, k, v, causal, sm_scale, logit_softcap)


def decode_attention(q, k, v, *, kv_len=None, sm_scale=None,
                     impl: str = "auto", return_residuals: bool = False,
                     component: str = "attention"):
    B, Hq, D = q.shape
    S = k.shape[2]
    annotate_cost(xfa.current_component(), component, "decode_attention",
                  flops=4.0 * B * Hq * S * D, bytes=_bytes(k, v))
    fn = ref.decode_attention if _plain(impl, q) else _dec.decode_attention
    return fn(q, k, v, kv_len=kv_len, sm_scale=sm_scale,
              return_residuals=return_residuals)


def chunk_attention(q, k, v, *, pos, sm_scale=None, impl: str = "auto",
                    component: str = "attention") -> torch.Tensor:
    """Positioned-chunk attention: q [B, Hq, T, D] at per-row cache
    offsets pos [B]; k, v [B, Hkv, S, D] the full cache (this chunk's rows
    already written at [pos, pos+T)).  Query t of row b attends columns
    <= pos[b] + t."""
    B, Hq, T, D = q.shape
    S = k.shape[2]
    annotate_cost(xfa.current_component(), component, "chunk_attention",
                  flops=4.0 * B * Hq * T * S * D, bytes=_bytes(k, v))
    fn = ref.chunk_attention if _plain(impl, q) else _dec.chunk_attention
    return fn(q, k, v, pos=pos, sm_scale=sm_scale)


def decode_attention_paged(q, k_pages, v_pages, *, block_table, kv_len,
                           sm_scale=None, impl: str = "auto",
                           component: str = "attention") -> torch.Tensor:
    """Paged single-token decode: q [B, Hq, D] against a page arena
    k_pages/v_pages [P, Hkv, page_size, D] addressed through block_table
    [B, NB] (int32 page ids; unassigned slots point at the reserved
    scratch page 0 and are masked by kv_len [B])."""
    B, Hq, D = q.shape
    _, _, ps, _ = k_pages.shape
    NB = block_table.shape[1]
    # cost model charges the VISIBLE prefix, not the arena: each row
    # streams at most NB pages of its own table
    annotate_cost(xfa.current_component(), component, "decode_attention_paged",
                  flops=4.0 * B * Hq * NB * ps * D,
                  bytes=2.0 * B * NB * ps * D * k_pages.element_size())
    fn = ref.decode_attention_paged if _plain(impl, q) \
        else _dec.decode_attention_paged
    return fn(q, k_pages, v_pages, block_table=block_table, kv_len=kv_len,
              sm_scale=sm_scale)


def chunk_attention_paged(q, k_pages, v_pages, *, block_table, pos,
                          sm_scale=None, impl: str = "auto",
                          component: str = "attention") -> torch.Tensor:
    """Paged positioned-chunk attention: q [B, Hq, T, D] at per-row
    offsets pos [B]; KV lives in the page arena [P, Hkv, page_size, D]
    and each row's visible prefix is read through block_table [B, NB].
    Same offset-causal mask as chunk_attention."""
    B, Hq, T, D = q.shape
    _, _, ps, _ = k_pages.shape
    NB = block_table.shape[1]
    annotate_cost(xfa.current_component(), component, "chunk_attention_paged",
                  flops=4.0 * B * Hq * T * NB * ps * D,
                  bytes=2.0 * B * NB * ps * D * k_pages.element_size())
    fn = ref.chunk_attention_paged if _plain(impl, q) \
        else _dec.chunk_attention_paged
    return fn(q, k_pages, v_pages, block_table=block_table, pos=pos,
              sm_scale=sm_scale)


def rmsnorm(x, w, *, eps: float = 1e-5, impl: str = "auto",
            component: str = "norm") -> torch.Tensor:
    annotate_cost(xfa.current_component(), component, "rmsnorm",
                  flops=4.0 * x.numel(), bytes=2.0 * _bytes(x))
    if _plain(impl, x):
        return ref.rmsnorm(x, w, eps=eps)
    return _rms.RMSNorm.apply(x, w, eps)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the counters were last reset."""
    return {fn.__name__: fn.launches for fn in _KERNELS}


def reset_launch_counts() -> None:
    for fn in _KERNELS:
        fn.launches = 0


#: every kernel wrapper of the port (each carries `.launches`)
_KERNELS = (_rms.rmsnorm, _dec.decode_attention, _dec.chunk_attention,
            _dec.decode_attention_paged, _dec.chunk_attention_paged,
            _fa.flash_attention, _fa.flash_attention_backward,
            _rms.rmsnorm_backward)
