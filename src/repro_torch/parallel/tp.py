"""Megatron-style tensor parallelism on torch.distributed, the port of
the reference's `parallel/tp.py`.

The reference runs one SPMD program and lets GSPMD place the
collectives (or, for `col_row_mlp`, places them itself inside
shard_map).  The port's ranks hold their shards and call the collectives
eagerly, through the Megatron pair of autograd Functions:

  copy_to     identity forward, all-reduce of the gradient backward:
              where a replicated activation enters column-parallel
              weights (each rank's dx is a partial sum), or a weight
              (or, with `part`, a block of its columns) that every rank
              holds whole meets this rank's heads only
  reduce_from all-reduce forward, identity backward: where row-parallel
              partial outputs become one replicated activation (or a
              data-parallel loss becomes the global one)

`col_row_mlp` is the reference's manual-TP MLP with its custom backward
(`ModelConfig.manual_tp`): up/gate column-parallel, the activation
local, down row-parallel with ONE forward all-reduce in the compute
dtype; backward ONE dx all-reduce, the up and gate dx partials summed
locally first, and the weight gradients accumulated in f32.  The
reference also sums the weight gradients over the batch axes inside
that backward; the port's trainer reduces every leaf's gradient over
'data' once (`runtime/trainer.py`), so the backward here leaves them
local.

The Functions take the mesh, and the XFA component of the open scope
(`core.hlo_flows.component`), when the forward runs: the backward runs
on autograd's threads, and records its collectives under the
component of the forward that made them (as the reference's HLO names
`transpose(jvp(attention))` ops after their forward's scope).

The expert-parallel MoE adds three (`models/moe.py`'s a2a mode):

  all_to_all  the all-to-all over one mesh axis, its backward the
              inverse all-to-all (the same call)
  split_rows  this rank's block of rows of an activation held whole on
              every rank of the axis; backward, the blocks' gradients
              all-gathered, so each rank again holds the whole gradient
  gather_rows every rank's block of rows, all-gathered; backward, this
              rank's block of the gradient, NOT summed: downstream of a
              replicated activation each rank of the axis already holds
              the same whole gradient (`copy_to` summed it), and a sum
              would scale it by the axis' size

`vocab_parallel` is the lm head's product with its vocab-split columns:
identity-forward input like `copy_to`, but its backward computes this
rank's share of dx in f32 and sums the shares in f32 before rounding.

`split_rows` and `gather_rows` take a `dim`: the Mamba2 block
(`models/mamba.py`) gathers its
heads' columns of y over 'model' (`gather_rows(dim=-1)`) for the gated
norm over all of d_inner, then takes its own columns of the normed row
for the row-parallel out_proj (`split_rows(dim=-1)`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import hlo_flows
from . import mesh as mesh_lib
from .axes import get_runtime_mesh, mesh_axes


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, part):
        ctx.mesh, ctx.axes, ctx.part = mesh, axes, part
        ctx.component = hlo_flows.current_component()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        with hlo_flows.component(ctx.component):
            if ctx.part is None:
                mesh_lib.all_reduce(g, ctx.mesh, ctx.axes)
            else:
                block = g.narrow(*ctx.part)
                block.copy_(mesh_lib.all_reduce(block.contiguous(),
                                                ctx.mesh, ctx.axes))
        return g, None, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh_lib.all_reduce(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to(x: torch.Tensor, mesh, axes,
            part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """x unchanged; its gradient summed over `axes` on the way back, or
    with part = (dim, start, length) only that block of it."""
    if mesh is None or mesh.size(axes) == 1:
        return x
    return _CopyTo.apply(x, mesh, axes, part)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """x summed over `axes`; its gradient passed back unchanged."""
    if mesh is None or mesh.size(axes) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axes)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.component = hlo_flows.current_component()
        return mesh_lib.all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        with hlo_flows.component(ctx.component):
            g = mesh_lib.all_to_all(g, ctx.mesh, ctx.axis)
        return g, None, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.component = hlo_flows.current_component()
        n = x.shape[dim] // mesh.size(axis)
        return x.narrow(dim, mesh.coord(axis) * n, n).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        with hlo_flows.component(ctx.component):
            g = mesh_lib.all_gather(g, ctx.mesh, ctx.axis, dim=ctx.dim)
        return g, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.rows = mesh, axis, dim, x.shape[dim]
        return mesh_lib.all_gather(x, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coord(ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.rows, ctx.rows), None, None,
                None)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x's size(axis) blocks of rows exchanged over `axis` (block j to
    the rank at index j); differentiable, its backward the same
    exchange."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)


def split_rows(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """This rank's block of the rows (entries of `dim`) of x, held whole
    on every rank of `axis`: the i-th of size(axis) equal blocks at
    index i."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    if x.shape[dim] % mesh.size(axis):
        raise ValueError(f"{x.shape[dim]} rows do not split "
                         f"{mesh.size(axis)} ways over {axis!r}")
    return _SplitRows.apply(x, mesh, axis, dim % x.dim())


def gather_rows(x: torch.Tensor, mesh, axis: str, dim: int = 0
                ) -> torch.Tensor:
    """Every rank's block of rows (of `dim`), in the axis' order: the
    inverse of `split_rows`."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    return _GatherRows.apply(x, mesh, axis, dim % x.dim())


def model_axes() -> Tuple[str, ...]:
    return mesh_axes("model")


def model_size() -> int:
    mesh = get_runtime_mesh()
    return mesh.size(model_axes()) if mesh is not None else 1


def model_coord() -> int:
    """This rank's index along the tensor-parallel axis."""
    mesh = get_runtime_mesh()
    return mesh.coord(model_axes()) if mesh is not None else 0


def copy_to_model(x: torch.Tensor,
                  part: Optional[Tuple[int, int, int]] = None
                  ) -> torch.Tensor:
    return copy_to(x, get_runtime_mesh(), model_axes(), part)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return reduce_from(x, get_runtime_mesh(), model_axes())


def split_over_model(local: int, full: int) -> bool:
    """True when a dim of `full` entries is split over the installed
    model axis (this rank holds `local` of them), False when it is held
    whole; any other width under a model axis raises."""
    n = model_size()
    if n == 1 or local == full:
        return False
    if local * n == full:
        return True
    raise ValueError(f"a dim of {full} held as {local} under tensor "
                     f"parallelism {model_size()}")


class _VocabParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        ctx.component = hlo_flows.current_component()
        ctx.save_for_backward(x, w)
        return torch.matmul(x, w.to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        d, v = x.shape[-1], w.shape[-1]
        dy = dy.to(x.dtype)
        dw = torch.matmul(x.reshape(-1, d).T, dy.reshape(-1, v))
        # this rank's vocab columns' share of dx in f32, summed over the
        # model axis in f32, rounded once
        dx = _mm_f32_out(dy.reshape(-1, v), w.to(x.dtype).T).reshape(
            *x.shape[:-1], d)
        with hlo_flows.component(ctx.component):
            dx = mesh_lib.all_reduce(dx, ctx.mesh, ctx.axes)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def vocab_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for this rank's vocab columns w [d, V / tp] of the lm head,
    x replicated over the model axis.  The backward sums the ranks'
    shares of dx in f32 and rounds once, as one rank's product over the
    whole vocab rounds it: summed as bf16-rounded shares, seamless's
    final-norm gradient at 1 + 1 layers sat 2.4x further from its f32
    value than one rank's (chip_smoke.py, NVIDIA H100 80GB HBM3)."""
    return _VocabParallel.apply(x, w, get_runtime_mesh(), model_axes())


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w for row-parallel weights, as the reference's pjit path
    computes it: each rank's partial product accumulated in f32, summed
    over the model axis in f32, then rounded to x's dtype once."""
    y = torch.matmul(x.float(), w.float())
    return reduce_from_model(y).to(x.dtype)


def _act(h_up, h_gate, gated: bool):
    if gated:
        return (F.silu(h_gate.float()) * h_up.float()).to(h_up.dtype)
    return F.gelu(h_up.float(), approximate="tanh").to(h_up.dtype)


def _mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of 2-D a and b, the products accumulated and returned in
    f32.  On the card a bf16 / f16 pair is one GEMM with f32 output
    (aten's mm.dtype, which has no CPU kernel); elsewhere the operands
    are upcast, which gives the same exact products."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation of the (exact) products."""
    return torch.matmul(a.float(), b.float())


class _ColRowMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_up, w_down, w_gate, gated, mesh, axes):
        h_up = torch.matmul(x, w_up.to(x.dtype))
        h_gate = torch.matmul(x, w_gate.to(x.dtype)) if gated else None
        h = _act(h_up, h_gate, gated)
        y = mesh_lib.all_reduce(torch.matmul(h, w_down.to(x.dtype)), mesh,
                                axes)           # ONE forward all-reduce
        ctx.gated, ctx.mesh, ctx.axes = gated, mesh, axes
        ctx.component = hlo_flows.current_component()
        ctx.save_for_backward(x, w_up, w_down,
                              w_gate if gated else None, h_up, h_gate)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_up, w_down, w_gate, h_up, h_gate = ctx.saved_tensors
        gated = ctx.gated
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        dy = dy.to(x.dtype)
        h = _act(h_up, h_gate, gated)
        dw_down = _f32_mm(h.reshape(-1, h.shape[-1]).T, dy.reshape(-1, d))
        dh = torch.matmul(dy, w_down.to(dy.dtype).T)
        dhf = dh.float()
        if gated:
            g32 = h_gate.float()
            sg = torch.sigmoid(g32)
            d_up = dhf * (g32 * sg)
            d_gate = dhf * h_up.float() * sg * (1 + g32 * (1 - sg))
        else:
            with torch.enable_grad():
                t = h_up.float().detach().requires_grad_()
                (d_up,) = torch.autograd.grad(
                    F.gelu(t, approximate="tanh"), t, dhf)
            d_gate = None
        d_up = d_up.to(x.dtype)
        f = d_up.shape[-1]
        dw_up = _f32_mm(x2.T, d_up.reshape(-1, f))
        dx = torch.matmul(d_up, w_up.to(x.dtype).T)
        dw_gate = None
        if gated:
            d_gate = d_gate.to(x.dtype)
            dw_gate = _f32_mm(x2.T, d_gate.reshape(-1, f)).to(w_gate.dtype)
            # the up and gate dx partials summed locally, then ONE reduce
            dx = dx + torch.matmul(d_gate, w_gate.to(x.dtype).T)
        with hlo_flows.component(ctx.component):
            dx = mesh_lib.all_reduce(dx, ctx.mesh, ctx.axes)
        return (dx, dw_up.to(w_up.dtype), dw_down.to(w_down.dtype), dw_gate,
                None, None, None)


def col_row_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                w_gate: Optional[torch.Tensor], gated: bool) -> torch.Tensor:
    """x: [B, S, d] replicated over the model axis; w_up / w_gate: this
    rank's [d, f / tp] columns; w_down: its [f / tp, d] rows.  Returns
    [B, S, d], replicated."""
    return _ColRowMLP.apply(x, w_up, w_down, w_gate, gated,
                            get_runtime_mesh(), model_axes())
