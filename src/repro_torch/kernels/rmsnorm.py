"""RMSNorm and its gradient: the CUDA kernels' wrappers (csrc/rmsnorm.cu).

`rmsnorm` replaces the Pallas TPU kernel `repro/kernels/rmsnorm.py::
rmsnorm` and `rmsnorm_add` its fused residual twin `::rmsnorm_add`;
`rmsnorm_backward` is its gradient, which the Pallas kernel does
not have.  `RMSNorm` is the autograd Function that pairs them.  For a
CUDA tensor a wrapper launches its kernel or raises; for a CPU tensor it
runs the plain version (`ref.rmsnorm`, `ref.rmsnorm_backward`).  Each
wrapper's `.launches` counts its kernel launches, nothing else.

All three are bound by bytes (a few FLOPs a byte).  In `rmsnorm` and
`rmsnorm_backward` a kernel thread holds a few 16-byte vectors of a row in
registers, a group of `row_threads` threads a row: x and w are loaded
together (one round trip), the row sums reduced with shuffles, and the
result stored once.  `forward_plan` follows the width alone (2 vectors a
thread, a row a block); at a decode tick's 8 rows the call is the launch,
not the arithmetic.  `backward_plan` runs one
block per SM over a contiguous range of rows, 8 vectors a thread and
several rows in flight, dw accumulated in registers; the blocks' f32
partials (at most one per SM) are summed per column in a fixed order by a
second launch, so dw is deterministic.  `rmsnorm_add` (no model path)
keeps one block a row.
"""

from __future__ import annotations

import functools

import torch

from . import build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VPTS = (2, 4, 8)    # 16-byte vectors a forward thread may hold of one row
MAX_THREADS = 256   # threads a block, at most (csrc/rmsnorm.cu kMaxThreads)
FWD_VPT = 2         # forward: vectors a thread (more only for wide rows)
BWD_VPT = 8         # backward: vectors a thread (csrc/rmsnorm.cu kRowVecs)


def row_threads(D: int, elem: int, vpt: int) -> int:
    """Threads that hold one row of D values of `elem` bytes at vpt
    16-byte vectors a thread: a power of two up to a warp while a warp
    holds the row, whole warps above (2048 bf16 at vpt 2: 128; at vpt 8:
    32; 2560 at vpt 2: 160)."""
    need = -(-(D * elem // 16) // vpt)
    if need <= 32:
        return 1 << max(0, need - 1).bit_length()
    return 32 * -(-need // 32)


def fit_vpt(D: int, elem: int, vpt: int) -> int:
    """vpt, or the fewest of VPTS above it that fit a row in MAX_THREADS
    threads (VPTS[-1] if none does)."""
    return next((v for v in VPTS if v >= vpt
                 and row_threads(D, elem, v) <= MAX_THREADS), VPTS[-1])


@functools.lru_cache(maxsize=512)
def forward_plan(D: int, elem: int):
    """(vectors a thread, threads a row, rows a block) of the forward
    kernel: FWD_VPT vectors a thread (the row spread over 128 threads at
    2048 bf16, 160 at 2560), one row a block (a decode tick's 8 rows on 8
    SMs), or a warp's worth of rows for narrow rows.  The plan follows the
    width alone."""
    vpt = fit_vpt(D, elem, FWD_VPT)
    tpr = row_threads(D, elem, vpt)
    return vpt, tpr, max(1, 32 // tpr)


@functools.lru_cache(maxsize=512)
def backward_plan(rows: int, D: int, elem: int, sms: int):
    """(threads a row, rows in flight a block, rows a block, blocks) of
    the backward kernel: BWD_VPT vectors a thread, at most one block per
    SM, each over a contiguous range of rows with MAX_THREADS threads; the
    blocks' dw partials number at most `sms`."""
    tpr = row_threads(D, elem, BWD_VPT)
    per = max(1, -(-rows // sms))
    return tpr, max(1, MAX_THREADS // tpr), per, -(-rows // per)


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
    check_width(D, x)
    rows = x.numel() // max(D, 1)
    vpt, tpr, groups = forward_plan(D, x.element_size())
    y = torch.empty_like(x)
    err = build.load("rmsnorm").rmsnorm_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, D, vpt, tpr, groups,
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
    w).  On the card: one pass over the rows (`backward_plan`) that writes
    dx and per-block f32 partials of dw, then a second launch that sums
    the partials per column in a fixed order (deterministic, no
    atomics)."""
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
    check_width(D, x)
    rows = x.numel() // max(D, 1)
    tpr, groups, per, nblk = backward_plan(rows, D, x.element_size(),
                                           sm_count(x.device.index))
    dx = torch.empty_like(x)
    dw = torch.empty((D,), dtype=x.dtype, device=x.device)
    part = torch.empty((nblk, D), dtype=torch.float32, device=x.device)
    err = build.load("rmsnorm").rmsnorm_bwd_launch(
        x.data_ptr(), wt.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        dw.data_ptr(), part.data_ptr(), rows, D, tpr, groups, per, nblk,
        float(eps), DTYPES[x.dtype], stream(x))
    build.check(err, "rmsnorm_backward")
    rmsnorm_backward.launches += 1
    return dx, dw.to(w.dtype)


rmsnorm_backward.launches = 0


class RMSNorm(torch.autograd.Function):
    """rmsnorm with its backward: the forward kernel (or, for a CPU
    tensor, the plain version) and `rmsnorm_backward`.  `ops.rmsnorm`
    takes it only when a gradient is wanted; otherwise it calls `rmsnorm`
    directly, which spares the Function's host cost on the serving
    path."""

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


def check_width(D: int, x: torch.Tensor) -> None:
    """The rmsnorm kernels hold a row in the registers of at most
    MAX_THREADS threads."""
    if row_threads(D, x.element_size(), BWD_VPT) > MAX_THREADS:
        raise ValueError(f"rmsnorm kernels hold rows of at most "
                         f"{MAX_THREADS * BWD_VPT * 16 // x.element_size()}"
                         f" {x.dtype} values, got {D}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
