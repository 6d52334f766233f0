"""Mamba2 SSD chunked scan and its gradient: the CUDA kernels' wrappers
(csrc/mamba_scan.cu).

`ssd_scan` replaces the Pallas TPU kernel
`repro/kernels/mamba_scan.py::ssd_scan`.  The Pallas kernel takes
dtx = dt·x and ldec = a·dt, pre-built by the reference's `ops.ssd_scan`
in a head-major layout; this kernel reads x and dt in their own layout
and forms both itself (dtx rounded to x's dtype as there), so the
function is `ref.ssd_scan`.  bf16 runs on the tensor cores, one block per
(batch row, group of heads, 32 columns of P) as `ssd_plan` lays out; f32
keeps the FMA kernel, one block per (row, head).

`ssd_scan_backward` is its gradient, which the Pallas kernel does not
have (the reference differentiates `ref.ssd_chunked` with JAX autodiff);
its plain version is `ref.ssd_scan_backward`.  bf16 runs chunk-parallel
on the tensor cores (chunk states, state passing, chunk gradients, fixed-
order sums; `ssd_bwd_plan` picks the head group); f32 keeps the FMA
kernel, one block per (row, head).  `SSDScan` is the autograd Function
that pairs the two kernels.

For a CUDA tensor a wrapper launches its kernel or raises; for a CPU
tensor it runs the plain version.  Each wrapper's `.launches` counts its
kernel launches, nothing else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import build, ref
from .rmsnorm import DTYPES, check_cuda, check_vectors, sm_count, stream

#: (N, P) pairs the kernel compiles (state size, head dim)
SHAPES = ((16, 32), (16, 64), (32, 32), (32, 64), (64, 32), (64, 64))
MAX_CHUNK = 128
HEAD_COLS = 32      # head-dim columns per block of the bf16 kernel
MAX_HEADS = 4       # heads per block of the bf16 kernel
MAX_BWD_HEADS = 8   # heads per block of the bf16 backward (csrc kMaxHeads)


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


def ssd_bwd_plan(B: int, L: int, H: int, chunk: int,
                 sms: int) -> Tuple[int, int]:
    """(heads per block, head groups) of the bf16 backward: its states and
    chunk-gradient launches run one block per (batch row, chunk, group of
    heads), two blocks per SM.  A block's time grows with its heads, plus
    about a head and a half for what it does once per chunk (b, c and
    their products G^T, dB and dC over the summed dG, and its syncs; fitted
    to the H100 times of every group at the training shape, which
    chip_ab.py's kernels phase logs): the group is the one with the fewest
    waves x (heads + 3/2), the larger on a tie (B 4, L 2048, chunk 128,
    H 80: 7 heads, 768 blocks).  The last group may hold fewer heads."""
    nc = L // chunk

    def cost(hg):
        return -(-B * nc * -(-H // hg) // (2 * sms)) * (2 * hg + 3)
    hg = min(range(MAX_BWD_HEADS, 0, -1), key=cost)
    return hg, -(-H // hg)


def ssd_bwd_scratch(B: int, L: int, H: int, P: int, N: int, chunk: int,
                    hg: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the bf16 backward's f32 scratch: the chunk states s / h
    and u / dh (the state-passing launch writes h and dh over s and u),
    each chunk's decay and dA part, and each head group's dB and dC
    parts."""
    nc, groups = L // chunk, -(-H // hg)
    return {"states": (B, nc, H, N, P), "dstates": (B, nc, H, N, P),
            "decay": (B, nc, H), "dap": (B, nc, H),
            "dbp": (B, groups, L, N), "dcp": (B, groups, L, N)}


def _check_inputs(what: str, x, dt, a, b, c, h0, chunk: int):
    """The kernels' input rules; returns (dt, a, h0) as contiguous f32."""
    check_cuda(x, what)
    B, L, H, P = x.shape
    N = b.shape[-1]
    if (N, P) not in SHAPES:
        raise ValueError(f"{what} kernel compiles (N, P) in {SHAPES}, got "
                         f"({N}, {P})")
    if not 1 <= chunk <= MAX_CHUNK or L % chunk:
        raise ValueError(f"{what} kernel needs 1 <= chunk <= {MAX_CHUNK} "
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
            raise ValueError(f"{what}: {name} must be {shape} on "
                             f"{x.device}, got {tuple(t.shape)} on {t.device}")
    for t in (b, c):
        if t.dtype != x.dtype:
            raise ValueError(f"{what}: b and c must be {x.dtype}, got "
                             f"{t.dtype}")
    if not all(t.is_contiguous() for t in (x, b, c)):
        raise ValueError(f"{what} kernel needs contiguous x, b, c")
    check_vectors(P, x)
    check_vectors(N, b, c)
    return dt, a, h0


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
    dt, a, h0 = _check_inputs("ssd_scan", x, dt, a, b, c, h0, chunk)
    B, L, H, P = x.shape
    N = b.shape[-1]
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


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor,
                      h0: Optional[torch.Tensor], dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor], *, chunk: int = 128):
    """The gradient of `ssd_scan` at its inputs, from dy (like x) and
    dh_final ([B, H, N, P] or None for zeros): (dx, ddt, da, db, dc, dh0)
    in the dtypes of (x, dt, a, b, c), dh0 f32 (None when h0 is None).
    Inputs as `ssd_scan`.  On the card, bf16: four launches (chunk
    states, state passing, chunk gradients, the sums over head groups and
    rows); f32: the FMA kernel, then its sums over heads and rows.  No
    atomics: the same bits on every run.  Counted as one launch."""
    if x.device.type == "cpu":
        return ref.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh_final,
                                     chunk=chunk)
    dtf, af, h0f = _check_inputs("ssd_scan_backward", x, dt, a, b, c, h0,
                                 chunk)
    B, L, H, P = x.shape
    N = b.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan_backward: dy must be {x.dtype} "
                         f"{tuple(x.shape)}, got {dy.dtype} "
                         f"{tuple(dy.shape)}")
    dy = dy.contiguous()
    if dh_final is not None:
        dh_final = dh_final.float().contiguous()
        if dh_final.shape != (B, H, N, P) or dh_final.device != x.device:
            raise ValueError(f"ssd_scan_backward: dh_final must be "
                             f"{(B, H, N, P)} on {x.device}")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((B, L, H), **f32)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty((H,), **f32)
    dh0 = torch.empty((B, H, N, P), **f32) if h0 is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = build.load("mamba_scan")
    ins = (x.data_ptr(), dtf.data_ptr(), af.data_ptr(), b.data_ptr(),
           c.data_ptr(), ptr(h0f), dy.data_ptr(), ptr(dh_final))
    outs = (dx.data_ptr(), ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
            da.data_ptr(), ptr(dh0))
    if x.dtype == torch.bfloat16:
        hg, _ = ssd_bwd_plan(B, L, H, chunk, sm_count(x.device.index))
        scratch = {k: torch.empty(s, **f32) for k, s in
                   ssd_bwd_scratch(B, L, H, P, N, chunk, hg).items()}
        err = lib.ssd_scan_bwd_tc_launch(
            *ins, *(scratch[k].data_ptr() for k in (
                "states", "dstates", "decay", "dbp", "dcp", "dap")),
            *outs, B, L, H, P, N, chunk, hg, stream(x))
    else:
        hs = torch.empty((B, H, L // chunk, N, P), **f32)   # chunk states
        dbp = torch.empty((B, H, L, N), **f32)              # per-head parts
        dcp = torch.empty((B, H, L, N), **f32)
        dap = torch.empty((B, H), **f32)
        err = lib.ssd_scan_bwd_launch(
            *ins, hs.data_ptr(), dbp.data_ptr(), dcp.data_ptr(),
            dap.data_ptr(), *outs, B, L, H, P, N, chunk, DTYPES[x.dtype],
            stream(x))
    build.check(err, "ssd_scan_backward")
    ssd_scan_backward.launches += 1
    return (dx, ddt.to(dt.dtype), da.to(a.dtype), db, dc, dh0)


ssd_scan_backward.launches = 0


def ssd_bwd_occupancy(N: int, P: int, hg: int) -> int:
    """Resident blocks per SM of the bf16 backward's chunk-gradient launch
    at hg heads a block, as the CUDA occupancy calculator gives it (for
    the tests, which hold it to two at every group)."""
    return build.load("mamba_scan").ssd_scan_bwd_occupancy(N, P, hg)


class SSDScan(torch.autograd.Function):
    """The SSD scan with its backward kernel; the chunk states are
    recomputed in the backward from the saved inputs.
    apply(x, dt, a, b, c, h0, chunk) -> (y, h_final)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, h0, chunk):
        y, h = ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
        ctx.save_for_backward(x, dt, a, b, c, h0)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, b, c, h0 = ctx.saved_tensors
        dx, ddt, da, db, dc, dh0 = ssd_scan_backward(
            x, dt, a, b, c, h0, dy.contiguous(), dh, chunk=ctx.chunk)
        return dx, ddt, da, db, dc, dh0, None
