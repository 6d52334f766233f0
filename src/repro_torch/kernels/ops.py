"""Public wrappers for the port's kernels, with impl dispatch.

impl='auto'   -> the kernel wrapper: the CUDA kernel for a CUDA tensor,
                 the plain version for a CPU tensor; `attention`,
                 `rmsnorm` and `ssd_scan` go through their autograd
                 Functions, whose backward is a kernel too, when a
                 gradient is wanted.  The kernels with no backward (decode and
                 chunk attention, their paged twins and latent forms,
                 rmsnorm_add) raise
                 on a CUDA tensor when a gradient is wanted, rather than
                 return outputs cut from the graph
impl='kernel' -> the CUDA kernel; a CPU tensor raises
impl='ref'    -> the plain PyTorch version (tests and chip_smoke.py)

The reference picks by `jax.default_backend()`; the port picks by the
tensor's device.  Every wrapper registers its analytic FLOPs/bytes with
the XFA static-cost layer under the component that calls it, with the
reference's edges and formulas.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import tracer as xfa
from ..core.device_fold import annotate_cost
from . import decode_attention as _dec
from . import flash_attention as _fa
from . import mamba_scan as _ssd
from . import mla_attention as _mla
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


def _grad_wanted(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _no_backward(what: str, *ts) -> None:
    """A kernel without a backward, on the card, must not be asked for a
    gradient: its outputs would carry none, and every gradient upstream
    of it would silently be zero."""
    if ts[0].device.type == "cuda" and _grad_wanted(*ts):
        raise RuntimeError(f"{what}: the kernel has no backward; call it "
                           f"under torch.no_grad() or with impl='ref'")


def _bytes(*ts: torch.Tensor) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def attention(q, k, v, *, causal: bool = True, sm_scale=None,
              logit_softcap: float = 0.0, impl: str = "auto",
              component: str = "attention") -> torch.Tensor:
    """Training / no-cache attention: q [B, Hq, Sq, D] against k
    [B, Hkv, Sk, D] and v [B, Hkv, Sk, Dv] (Dv <= D: MLA's v at its own
    width, where the reference pads it to D) -> [B, Hq, Sq, Dv]; causal
    rows see columns <= t + Sk - Sq, as the reference oracle's q_offset
    puts them.  The registered cost is the reference's: its FLOPs at D,
    its bytes with v counted at D (padded)."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    flops = 4.0 * B * Hq * Sq * Sk * D * (0.5 if causal and Sq == Sk else 1.0)
    v_bytes = _bytes(v) * D / v.shape[-1]
    annotate_cost(xfa.current_component(), component, "flash_attention",
                  flops=flops, bytes=(_bytes(q, k) + v_bytes) * 2)
    if _plain(impl, q):
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale,
                             logit_softcap=logit_softcap,
                             q_offset=Sk - Sq if causal else 0)
    if not _grad_wanted(q, k, v):
        # inference: the forward kernel alone, without the f32 o that
        # the autograd Function saves for its backward
        return _fa.flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                   logit_softcap=logit_softcap)[0]
    return _fa.FlashAttention.apply(q, k, v, causal, sm_scale, logit_softcap)


def decode_attention(q, k, v, *, kv_len=None, sm_scale=None,
                     impl: str = "auto", return_residuals: bool = False,
                     component: str = "attention"):
    B, Hq, D = q.shape
    S = k.shape[2]
    annotate_cost(xfa.current_component(), component, "decode_attention",
                  flops=4.0 * B * Hq * S * D, bytes=_bytes(k, v))
    if _plain(impl, q):
        fn = ref.decode_attention
    else:
        _no_backward("decode_attention", q, k, v)
        fn = _dec.decode_attention
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
    if _plain(impl, q):
        fn = ref.chunk_attention
    else:
        _no_backward("chunk_attention", q, k, v)
        fn = _dec.chunk_attention
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
    if _plain(impl, q):
        fn = ref.decode_attention_paged
    else:
        _no_backward("decode_attention_paged", q, k_pages, v_pages)
        fn = _dec.decode_attention_paged
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
    if _plain(impl, q):
        fn = ref.chunk_attention_paged
    else:
        _no_backward("chunk_attention_paged", q, k_pages, v_pages)
        fn = _dec.chunk_attention_paged
    return fn(q, k_pages, v_pages, block_table=block_table, pos=pos,
              sm_scale=sm_scale)


# MLA's latent attention: q against one latent kv head whose K rows are
# [ckv | krope] and V rows ckv, read from the cache in place; the first r
# output columns of the reference's k/v form (`ref.*_latent`).  Each
# registers the reference's cost of the k/v call it stands for (k and its
# zero-padded v at D = r + dr) under the same edge.
def _latent_cost(component: str, kernel: str, flops: float, rows: float,
                 D: int, elem: int) -> None:
    annotate_cost(xfa.current_component(), component, kernel, flops=flops,
                  bytes=2.0 * rows * D * elem)


def decode_attention_latent(q, ckv, krope, *, kv_len=None, sm_scale=None,
                            impl: str = "auto", return_residuals: bool = False,
                            component: str = "attention"):
    """Latent decode: q [B, Hq, r + dr]; ckv [B, S, r], krope [B, S, dr];
    kv_len [B] -> [B, Hq, r] (+ (m, l) with return_residuals)."""
    B, Hq, D = q.shape
    S = ckv.shape[1]
    _latent_cost(component, "decode_attention", 4.0 * B * Hq * S * D, B * S,
                 D, ckv.element_size())
    if _plain(impl, q):
        fn = ref.decode_attention_latent
    else:
        _no_backward("decode_attention_latent", q, ckv, krope)
        fn = _mla.decode_attention_latent
    return fn(q, ckv, krope, kv_len=kv_len, sm_scale=sm_scale,
              return_residuals=return_residuals)


def chunk_attention_latent(q, ckv, krope, *, pos, sm_scale=None,
                           impl: str = "auto",
                           component: str = "attention") -> torch.Tensor:
    """Latent positioned chunk: q [B, Hq, T, r + dr] at per-row offsets
    pos [B]; ckv [B, S, r], krope [B, S, dr] the full cache ->
    [B, Hq, T, r].  Query t of row b attends columns <= pos[b] + t."""
    B, Hq, T, D = q.shape
    S = ckv.shape[1]
    _latent_cost(component, "chunk_attention", 4.0 * B * Hq * T * S * D,
                 B * S, D, ckv.element_size())
    if _plain(impl, q):
        fn = ref.chunk_attention_latent
    else:
        _no_backward("chunk_attention_latent", q, ckv, krope)
        fn = _mla.chunk_attention_latent
    return fn(q, ckv, krope, pos=pos, sm_scale=sm_scale)


def decode_attention_latent_paged(q, ckv_pages, krope_pages, *, block_table,
                                  kv_len, sm_scale=None, impl: str = "auto",
                                  component: str = "attention"
                                  ) -> torch.Tensor:
    """Paged latent decode: q [B, Hq, r + dr] against the arenas
    ckv_pages [P, page_size, r], krope_pages [P, page_size, dr] through
    block_table [B, NB]; kv_len [B] -> [B, Hq, r]."""
    B, Hq, D = q.shape
    ps = ckv_pages.shape[1]
    NB = block_table.shape[1]
    _latent_cost(component, "decode_attention_paged",
                 4.0 * B * Hq * NB * ps * D, B * NB * ps, D,
                 ckv_pages.element_size())
    if _plain(impl, q):
        fn = ref.decode_attention_latent_paged
    else:
        _no_backward("decode_attention_latent_paged", q, ckv_pages,
                     krope_pages)
        fn = _mla.decode_attention_latent_paged
    return fn(q, ckv_pages, krope_pages, block_table=block_table,
              kv_len=kv_len, sm_scale=sm_scale)


def chunk_attention_latent_paged(q, ckv_pages, krope_pages, *, block_table,
                                 pos, sm_scale=None, impl: str = "auto",
                                 component: str = "attention"
                                 ) -> torch.Tensor:
    """Paged latent chunk: q [B, Hq, T, r + dr] at per-row offsets pos
    [B] against the arenas of `decode_attention_latent_paged` ->
    [B, Hq, T, r]."""
    B, Hq, T, D = q.shape
    ps = ckv_pages.shape[1]
    NB = block_table.shape[1]
    _latent_cost(component, "chunk_attention_paged",
                 4.0 * B * Hq * T * NB * ps * D, B * NB * ps, D,
                 ckv_pages.element_size())
    if _plain(impl, q):
        fn = ref.chunk_attention_latent_paged
    else:
        _no_backward("chunk_attention_latent_paged", q, ckv_pages,
                     krope_pages)
        fn = _mla.chunk_attention_latent_paged
    return fn(q, ckv_pages, krope_pages, block_table=block_table, pos=pos,
              sm_scale=sm_scale)


def rmsnorm(x, w, *, eps: float = 1e-5, impl: str = "auto",
            component: str = "norm") -> torch.Tensor:
    annotate_cost(xfa.current_component(), component, "rmsnorm",
                  flops=4.0 * x.numel(), bytes=2.0 * _bytes(x))
    if _plain(impl, x):
        return ref.rmsnorm(x, w, eps=eps)
    if _grad_wanted(x, w):
        return _rms.RMSNorm.apply(x, w, eps)
    # no gradient wanted: the kernel wrapper itself, one launch as before,
    # without the autograd Function's host cost
    return _rms.rmsnorm(x, w, eps=eps)


def rmsnorm_add(x, residual, w, *, eps: float = 1e-5, impl: str = "auto",
                component: str = "norm"):
    """Fused residual add and RMSNorm: (rmsnorm(x + residual), x +
    residual).  No model of either package calls it."""
    annotate_cost(xfa.current_component(), component, "rmsnorm_add",
                  flops=5.0 * x.numel(), bytes=3.0 * _bytes(x))
    if _plain(impl, x):
        fn = ref.rmsnorm_add
    else:
        _no_backward("rmsnorm_add", x, residual, w)
        fn = _rms.rmsnorm_add
    return fn(x, residual, w, eps=eps)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128, h0=None,
             impl: str = "auto", component: str = "ssm",
             heads: Optional[int] = None):
    """Mamba2 SSD: x [B, L, H, P], dt [B, L, H], a [H], b/c [B, L, N];
    h0 [B, H, N, P] the carried state (None = a fresh sequence), so a
    prompt fed in chunks resumes where the previous chunk stopped.
    Returns (y [B, L, H, P] in x's dtype, h_final [B, H, N, P] f32).

    L is zero-padded to a multiple of `chunk`: dt = 0 rows decay by
    exp(0) = 1 and inject 0, so the state and the real rows are
    untouched.  The plain path is `ref.ssd_chunked`, as the reference's;
    the kernel path forms dtx = dt·x rounded to x's dtype, as the
    reference does before its Pallas kernel (`ref.ssd_scan`).  When a
    gradient is wanted the kernel path goes through `SSDScan` (the scan
    backward kernel); otherwise it calls the wrapper, one launch with no
    autograd host cost.  `heads`: the global head count when x, dt and
    a hold one rank's heads (tensor parallel; b and c are whole): the
    static cost registered is the global scan's."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    share = (heads or H) / H
    # 2 matmul pairs of [T,T]x[T,*] per chunk ~ 6*B*H*L*chunk*(N+P) flops
    annotate_cost(xfa.current_component(), component, "ssd_scan",
                  flops=float(6 * B * H * L * chunk * (N + P)) * share,
                  bytes=(_bytes(x, dt) * share + _bytes(b, c)) * 2)
    pad = (-L) % chunk
    if pad:
        def zp(t):
            return torch.cat([t, t.new_zeros((t.shape[0], pad)
                                             + tuple(t.shape[2:]))], dim=1)
        x, dt, b, c = zp(x), zp(dt), zp(b), zp(c)
    if _plain(impl, x):
        y, h = ref.ssd_chunked(x, dt, a, b, c, chunk=chunk, h0=h0)
    elif _grad_wanted(x, dt, a, b, c, h0):
        y, h = _ssd.SSDScan.apply(x.contiguous(), dt, a, b.contiguous(),
                                  c.contiguous(), h0, chunk)
    else:
        y, h = _ssd.ssd_scan(x.contiguous(), dt, a, b.contiguous(),
                             c.contiguous(), chunk=chunk, h0=h0)
    if pad:
        y = y[:, :L]
    return y, h


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
            _rms.rmsnorm_backward, _rms.rmsnorm_add, _ssd.ssd_scan,
            _ssd.ssd_scan_backward)
