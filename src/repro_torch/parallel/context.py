"""Context parallelism for long-context decode: distributed split-K, the
port of the reference's `parallel/context.py`.

When one query token attends a long cache and neither batch nor heads
can absorb the mesh, the cache's SEQUENCE is the dim to split.  Each
rank of the context axis holds one contiguous range of the cache:

  1. it runs the decode kernel over its own range with
     `return_residuals=True`, giving (o, m, l) per (row, head); a rank
     whose range holds no valid position gives l = 0, and its m is set
     to -1e30 so the merge weighs it zero;
  2. ONE all-gather of the packed (o, m, l) over the context axis
     ([shards, B, H, D + 2] floats: kilobytes, not the cache);
  3. the stable merge `kernels.ref.combine_decode_partials`.
"""

from __future__ import annotations

import torch

from ..kernels import ops, ref
from . import mesh as mesh_lib


def context_parallel_decode(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, pos, mesh, *,
                            context_axis: str = "data",
                            impl: str = "auto") -> torch.Tensor:
    """Decode attention over a cache split on `context_axis`.

    q: [B, Hq, D], the same on every rank of the axis; k, v: this rank's
    range [B, Hkv, S / shards, D] of the cache (rank i holds positions
    [i S / shards, (i + 1) S / shards)); pos: the global decode position,
    a scalar or [B] per row (position pos attends 0..pos).  A head axis
    is whatever heads the caller passes.  Returns [B, Hq, D], the same on
    every rank of the axis."""
    B, Hq, D = q.shape
    s_loc = k.shape[2]
    start = mesh.coord(context_axis) * s_loc if mesh is not None else 0
    pos = torch.as_tensor(pos, device=q.device)
    kv_len = torch.clamp(pos.long() + 1 - start, 0, s_loc)
    kv_len = torch.broadcast_to(kv_len, (B,)).to(torch.int32).contiguous()
    o, (m, l) = ops.decode_attention(q, k, v, kv_len=kv_len, impl=impl,
                                     return_residuals=True)
    m = torch.where(kv_len[:, None] > 0, m, torch.full_like(m, -1e30))
    packed = torch.cat([o.float(), m[..., None], l[..., None]], dim=-1)
    parts = mesh_lib.all_gather(packed[None], mesh, context_axis, dim=0)
    return ref.combine_decode_partials(parts[..., :D].to(o.dtype),
                                       parts[..., D], parts[..., D + 1])
