"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper (csrc/mamba_scan.cu).

Replaces the Pallas TPU kernel `repro/kernels/mamba_scan.py::ssd_scan`.
The Pallas kernel takes dtx = dt·x and ldec = a·dt, pre-built by the
reference's `ops.ssd_scan` in a head-major layout; this kernel reads x and
dt in their own layout and forms both itself (dtx rounded to x's dtype as
there), so the function is `ref.ssd_scan`.  bf16 runs on the tensor
cores, one block per (batch row, group of heads, 32 columns of P) as
`ssd_plan` lays out; f32 keeps the FMA kernel, one block per (row,
head).  For a CUDA tensor the wrapper launches the kernel or raises; for
a CPU tensor it runs `ref.ssd_scan`.  `.launches` counts kernel
launches, nothing else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build, ref
from .rmsnorm import DTYPES, check_cuda, check_vectors, sm_count, stream

#: (N, P) pairs the kernel compiles (state size, head dim)
SHAPES = ((16, 32), (16, 64), (32, 32), (32, 64), (64, 32), (64, 64))
MAX_CHUNK = 128
HEAD_COLS = 32      # head-dim columns per block of the bf16 kernel
MAX_HEADS = 4       # heads per block of the bf16 kernel


def ssd_plan(B: int, H: int, P: int, sms: int) -> Tuple[int, int, int]:
    """(heads per block, head groups, P slices) of the bf16 kernel: one
    block per (batch row, group of heads, HEAD_COLS columns of P), two
    blocks per SM.  A block's time grows with its heads, plus about a
    third of a head for C B^T (formed once per chunk for the group): the
    group is the one with the fewest waves x (heads + 1/3), the larger
    on a tie (B 8, H 80: 3 heads, 432 blocks; B 1: 1 head, 160 blocks,
    so even one row fills the card).  The last group may hold fewer
    heads.  Sizes only: no host sync."""
    slices = max(1, P // HEAD_COLS)

    def cost(hg):
        return -(-B * -(-H // hg) * slices // (2 * sms)) * (3 * hg + 1)
    hg = min(range(MAX_HEADS, 0, -1), key=cost)
    return hg, -(-H // hg), slices


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, H, P]; dt: [B, L, H] (read as f32); a: [H]; b, c:
    [B, L, N] in x's dtype; h0: [B, H, N, P] (None = zeros).  L must be a
    multiple of `chunk` (ops.ssd_scan pads).  Returns (y [B, L, H, P] in
    x's dtype, h_final [B, H, N, P] f32)."""
    if x.device.type == "cpu":
        return ref.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    check_cuda(x, "ssd_scan")
    B, L, H, P = x.shape
    N = b.shape[-1]
    if (N, P) not in SHAPES:
        raise ValueError(f"ssd_scan kernel compiles (N, P) in {SHAPES}, got "
                         f"({N}, {P})")
    if not 1 <= chunk <= MAX_CHUNK or L % chunk:
        raise ValueError(f"ssd_scan kernel needs 1 <= chunk <= {MAX_CHUNK} "
                         f"dividing L = {L}, got chunk {chunk}")
    dt = dt.float().contiguous()
    a = a.float().contiguous()
    if h0 is not None:
        h0 = h0.float().contiguous()
    want = {"dt": (dt, (B, L, H)), "a": (a, (H,)), "b": (b, (B, L, N)),
            "c": (c, (B, L, N))}
    if h0 is not None:
        want["h0"] = (h0, (B, H, N, P))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} must be {shape} on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    for t in (b, c):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan: b and c must be {x.dtype}, got "
                             f"{t.dtype}")
    if not all(t.is_contiguous() for t in (x, b, c)):
        raise ValueError("ssd_scan kernel needs contiguous x, b, c")
    check_vectors(P, x)
    check_vectors(N, b, c)
    y = torch.empty_like(x)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=x.device)
    hg, _, _ = ssd_plan(B, H, P, sm_count(x.device.index))
    err = build.load("mamba_scan").ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        h.data_ptr(), B, L, H, P, N, chunk, hg, DTYPES[x.dtype], stream(x))
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0
