"""Public wrappers for the serving path's kernels, with impl dispatch.

impl='auto'   -> the kernel wrapper: the CUDA kernel for a CUDA tensor,
                 the plain version for a CPU tensor
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


def rmsnorm(x, w, *, eps: float = 1e-5, impl: str = "auto",
            component: str = "norm") -> torch.Tensor:
    annotate_cost(xfa.current_component(), component, "rmsnorm",
                  flops=4.0 * x.numel(), bytes=2.0 * _bytes(x))
    fn = ref.rmsnorm if _plain(impl, x) else _rms.rmsnorm
    return fn(x, w, eps=eps)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the counters were last reset."""
    return {"rmsnorm": _rms.rmsnorm.launches,
            "decode_attention": _dec.decode_attention.launches,
            "chunk_attention": _dec.chunk_attention.launches}


def reset_launch_counts() -> None:
    _rms.rmsnorm.launches = 0
    _dec.decode_attention.launches = 0
    _dec.chunk_attention.launches = 0
