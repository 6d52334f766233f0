"""RMSNorm and its gradient: the CUDA kernels' wrappers (csrc/rmsnorm.cu).

`rmsnorm` replaces the Pallas TPU kernel `repro/kernels/rmsnorm.py::
rmsnorm` and `rmsnorm_add` its fused residual twin `::rmsnorm_add`;
`rmsnorm_backward` is its gradient, which the Pallas kernel does
not have.  `RMSNorm` is the autograd Function that pairs them.  For a
CUDA tensor a wrapper launches its kernel or raises; for a CPU tensor it
runs the plain version (`ref.rmsnorm`, `ref.rmsnorm_backward`).  Each
wrapper's `.launches` counts its kernel launches, nothing else.
"""

from __future__ import annotations

import functools

import torch

from . import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """x: [..., D]; w: [D] -> [..., D] in x's dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps=eps)
    check_cuda(x, "rmsnorm")
    D = x.shape[-1]
    w = w.to(x.dtype)
    if not x.is_contiguous() or not w.is_contiguous() or w.shape != (D,):
        raise ValueError(f"rmsnorm kernel needs contiguous x [..., {D}] and "
                         f"w [{D}], got {tuple(x.shape)} / {tuple(w.shape)}")
    check_vectors(D, x, w)
    y = torch.empty_like(x)
    err = build.load("rmsnorm").rmsnorm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // max(D, 1), D,
        float(eps), DTYPES[x.dtype], stream(x))
    build.check(err, "rmsnorm")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def rmsnorm_add(x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor, *,
                eps: float = 1e-5):
    """x, residual: [..., D]; w: [D] -> (rmsnorm(s), s) with s = x +
    residual, both in x's dtype."""
    if x.device.type == "cpu":
        return ref.rmsnorm_add(x, residual, w, eps=eps)
    check_cuda(x, "rmsnorm_add")
    D = x.shape[-1]
    w = w.to(x.dtype)
    if residual.shape != x.shape or residual.dtype != x.dtype \
            or residual.device != x.device or w.device != x.device \
            or not (x.is_contiguous() and residual.is_contiguous()
                    and w.is_contiguous()) or w.shape != (D,):
        raise ValueError(f"rmsnorm_add kernel needs contiguous x, residual "
                         f"[..., {D}] of one dtype and w [{D}] on one "
                         f"device, got {tuple(x.shape)} {x.dtype} / "
                         f"{tuple(residual.shape)} {residual.dtype} / "
                         f"{tuple(w.shape)}")
    check_vectors(D, x, residual, w)
    y, s = torch.empty_like(x), torch.empty_like(x)
    err = build.load("rmsnorm").rmsnorm_add_launch(
        x.data_ptr(), residual.data_ptr(), w.data_ptr(), y.data_ptr(),
        s.data_ptr(), x.numel() // max(D, 1), D, float(eps),
        DTYPES[x.dtype], stream(x))
    build.check(err, "rmsnorm_add")
    rmsnorm_add.launches += 1
    return y, s


rmsnorm_add.launches = 0


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                     eps: float = 1e-5):
    """Gradient of rmsnorm: x, dy [..., D]; w [D] -> (dx like x, dw like
    w).  On the card: one pass over the rows that writes dx and per-block
    f32 partials of dw, then a second launch that sums the partials per
    column (deterministic, no atomics)."""
    if x.device.type == "cpu":
        return ref.rmsnorm_backward(x, w, dy, eps=eps)
    check_cuda(x, "rmsnorm_backward")
    D = x.shape[-1]
    wt = w.to(x.dtype)
    dy = dy.to(x.dtype)
    if not (x.is_contiguous() and dy.is_contiguous() and wt.is_contiguous()) \
            or wt.shape != (D,) or dy.shape != x.shape \
            or dy.device != x.device or wt.device != x.device:
        raise ValueError(f"rmsnorm_backward kernel needs contiguous x, dy "
                         f"[..., {D}] and w [{D}] on one device, got "
                         f"{tuple(x.shape)} / {tuple(dy.shape)} / "
                         f"{tuple(w.shape)}")
    check_vectors(D, x, wt, dy)
    rows = x.numel() // max(D, 1)
    nblk = max(1, min(rows, 4 * sm_count(x.device.index)))
    dx = torch.empty_like(x)
    dw = torch.empty((D,), dtype=x.dtype, device=x.device)
    part = torch.empty((nblk, D), dtype=torch.float32, device=x.device)
    err = build.load("rmsnorm").rmsnorm_bwd_launch(
        x.data_ptr(), wt.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), rows, D, nblk, float(eps),
        DTYPES[x.dtype], stream(x))
    build.check(err, "rmsnorm_backward")
    rmsnorm_backward.launches += 1
    return dx, dw.to(w.dtype)


rmsnorm_backward.launches = 0


class RMSNorm(torch.autograd.Function):
    """rmsnorm with its backward: the forward kernel (or, for a CPU
    tensor, the plain version) and `rmsnorm_backward`.  Under
    torch.no_grad, or when neither input needs a gradient, it launches
    exactly the forward kernel and saves nothing."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return rmsnorm(x, w, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, w, dy.contiguous(), eps=ctx.eps)
        return dx, dw, None


def check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.get_device() != torch.cuda.current_device():
        raise ValueError(f"{what} kernel: tensor on {x.device} but the "
                         f"current device is {torch.cuda.current_device()}")


def check_vectors(d: int, *ts: torch.Tensor) -> None:
    """The kernels move 16 bytes per load: rows must be a whole number of
    16-byte vectors and every base pointer 16-byte aligned."""
    vec = 16 // ts[0].element_size()
    if d % vec:
        raise ValueError(f"kernel rows must be a multiple of {vec} "
                         f"elements, got {d}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("kernel operands must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
