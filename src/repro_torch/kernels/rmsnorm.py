"""RMSNorm: the CUDA kernel's wrapper (csrc/rmsnorm.cu).

Replaces the Pallas TPU kernel `repro/kernels/rmsnorm.py::rmsnorm`.  For
a CUDA tensor the wrapper launches the kernel or raises; for a CPU tensor
it runs the plain version (`ref.rmsnorm`).  `rmsnorm.launches` counts
kernel launches, nothing else.
"""

from __future__ import annotations

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


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
