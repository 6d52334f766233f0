"""GPipe-style pipeline parallelism over a 'stage' mesh axis with
point-to-point sends, the port of the reference's `parallel/pipeline.py`.

Layers split into S stages, one per rank of the axis; M microbatches
stream through the classic GPipe schedule (microbatch i reaches stage s
once stage s - 1 has sent it).  The reference runs a scan over
T = M + S - 1 ticks with one collective-permute a tick; here each stage
loops over its microbatches, receiving each from the stage before and
sending its output to the stage after, and the idle ticks are the
waits of those receives: the standard (S - 1) / (M + S - 1) bubble.

The pipeline is differentiable.  The receive's backward sends the
input's gradient to the stage before; the send's backward receives the
output's gradient from the stage after; the last stage's outputs are
broadcast to every stage, and only the last stage's gradient of them
enters its graph.  Every stage computes the same loss from the
broadcast outputs and calls backward on it.  Each stage's backward
walks its microbatches in reverse order of their forward (autograd runs
later nodes first), the same order on every stage, so the blocking
sends of the backward always meet their receives.

A building block: no model path calls it in either package.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import hlo_flows
from ..tree import tree_map
from . import mesh as mesh_lib


class _Recv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, like, mesh, axis, src, tag):
        ctx.mesh, ctx.axis, ctx.src, ctx.tag = mesh, axis, src, tag
        ctx.component = hlo_flows.current_component()
        return mesh_lib.recv(torch.empty_like(like), mesh, axis, src, tag)

    @staticmethod
    def backward(ctx, g):
        with hlo_flows.component(ctx.component):
            mesh_lib.send(g, ctx.mesh, ctx.axis, ctx.src, ctx.tag).wait()
        return None, None, None, None, None, None


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axis, dst, tag, pending):
        ctx.mesh, ctx.axis, ctx.dst, ctx.tag = mesh, axis, dst, tag
        ctx.shape, ctx.dtype, ctx.device = y.shape, y.dtype, y.device
        ctx.component = hlo_flows.current_component()
        pending.append(mesh_lib.send(y, mesh, axis, dst, tag))
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        with hlo_flows.component(ctx.component):
            mesh_lib.recv(g, ctx.mesh, ctx.axis, ctx.dst, ctx.tag)
        return g, None, None, None, None, None


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, mesh, axis, last, *tokens):
        ctx.last, ctx.n = last, len(tokens)
        return mesh_lib.broadcast(out.clone(), mesh, axis,
                                  src=mesh.size(axis) - 1)

    @staticmethod
    def backward(ctx, g):
        if ctx.last:
            return (g, None, None, None)
        return (None, None, None, None) + tuple(
            g.new_zeros(()) for _ in range(ctx.n))


def gpipe_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                stage_params: Any, microbatches: torch.Tensor, mesh, *,
                axis: str = "stage") -> torch.Tensor:
    """Run `microbatches` [M, B, ...] through the S stages of `axis`.

    stage_fn(params, x) -> x must keep x's shape and dtype; stage_params
    are THIS rank's stage's params (`split_stages(...)[s]` of the
    reference's stacked [S, ...] tree).  Returns the [M, B, ...] outputs
    (microbatch i = stage_{S-1}(...stage_0(mb_i))) on every rank of the
    axis."""
    S, s = mesh.size(axis), mesh.coord(axis)
    M = microbatches.shape[0]
    anchor = microbatches.new_zeros((), requires_grad=True)
    outs, tokens, pending = [], [], []
    for i in range(M):
        x = (microbatches[i] if s == 0 else
             _Recv.apply(anchor, microbatches[i], mesh, axis, s - 1, i))
        y = stage_fn(stage_params, x)
        if s < S - 1:
            tokens.append(_Send.apply(y, mesh, axis, s + 1, i, pending))
        else:
            outs.append(y)
    for req in pending:
        req.wait()
    last = s == S - 1
    out = torch.stack(outs) if last else torch.zeros_like(microbatches)
    return _FromLast.apply(out, mesh, axis, last, *tokens)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The GPipe idle fraction, fed to the XFA 'Wait' attribution."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def split_stages(stacked_layer_params: Any, n_stages: int) -> Any:
    """[L, ...] stacked layer params -> [S, L/S, ...] per-stage stacks."""
    def re(a):
        L = a.shape[0]
        assert L % n_stages == 0, (L, n_stages)
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return tree_map(re, stacked_layer_params)
