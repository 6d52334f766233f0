"""Processes, device meshes and collectives of the port, on
torch.distributed.

The reference's parallelism is one SPMD program over a `jax.make_mesh`
mesh; the port runs one eager process per rank (torchrun's contract) and
does the collectives itself.  This module is the process layer the rest
of `repro_torch.parallel` stands on:

- `init_distributed(backend, device)` joins the process group that
  torchrun's environment describes (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `MASTER_ADDR`, `MASTER_PORT`), or one given explicitly, always with a
  timeout, so a dead rank fails the run instead of hanging it.  The
  backend defaults to `nccl` on CUDA and `gloo` on the CPU.  NCCL takes
  one rank per card: a world larger than the CUDA device count under
  `nccl` raises, and several ranks sharing one card ask for `gloo`
  explicitly (it then carries CUDA tensors).
- `make_mesh(shape, axes)` is the counterpart of `jax.make_mesh`, over
  `torch.distributed.device_mesh.init_device_mesh`.  A mesh of one rank
  needs no process group: its collectives are no-ops.
- `all_reduce`, `all_gather`, `all_to_all`, `broadcast`, `send` and
  `recv` over mesh axes, each counted per kind (`collective_counts()`,
  as `kernels.ops.launch_counts()` counts kernel launches).  A
  collective over axes of extent 1 does nothing and counts nothing.
- `recording()`: while armed, every collective also appends one
  `core.hlo_flows.CollectiveFlow` (XFA's L3 flows): its kind in the
  reference's HLO vocabulary (`FLOW_KIND`), this rank's input and
  output bytes, the group's size and its stride in the mesh's row-major
  rank numbering (the reference's device-id layout), the mesh axis the
  call named, and the component of the open scope
  (`hlo_flows.component`).  Wire bytes follow hlo_flows' ring model.

gloo's support for CUDA tensors differs across PyTorch builds.  With
gloo and a CUDA device, `init_distributed` checks each collective on
each dtype the port reduces (f32, bf16, int64) once, on small CUDA
tensors, values included; a collective that gloo refuses for CUDA
tensors is then run on an explicit host copy, and rank 0 prints which
ran directly and which through host copies.  A collective that runs but gives a
wrong value raises.  `send` and `recv` are not probed: gloo's
point-to-point calls take CPU tensors only, so under gloo a CUDA
tensor is always sent from, and received into, a host copy.
"""

from __future__ import annotations

import datetime
import math
import os
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core import hlo_flows

#: the process-group timeout: a rank that stops answering fails the
#: collectives of the others after this long
DEFAULT_TIMEOUT_S = 600.0

Axes = Union[str, Sequence[str]]

_COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                           "all_to_all": 0, "broadcast": 0, "send": 0,
                           "recv": 0}
#: each counted kind's name in the reference's HLO vocabulary
FLOW_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "all_to_all": "all-to-all", "broadcast": "broadcast",
             "send": "collective-permute", "recv": "collective-permute"}
#: the recorder's list while armed (`recording`), else None
_FLOWS: Optional[List[hlo_flows.CollectiveFlow]] = None
#: (collective, dtype) pairs gloo refused on CUDA tensors: run on a host copy
_HOST_COPIED: Set[Tuple[str, torch.dtype]] = set()
_PROBE_DTYPES = (torch.float32, torch.bfloat16, torch.int64)


def collective_counts() -> Dict[str, int]:
    """Collectives called per kind since the counters were last reset."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def flow_kind_counts(counts: Dict[str, int]) -> Dict[str, int]:
    """`collective_counts()` in the flows' vocabulary (send and recv are
    both collective-permutes), kinds of count 0 left out: what a
    recording of the same window counts per kind."""
    out: Dict[str, int] = {}
    for k, n in counts.items():
        if n:
            out[FLOW_KIND[k]] = out.get(FLOW_KIND[k], 0) + n
    return out


@contextmanager
def recording():
    """Record every collective called inside the window: yields the list
    the flows are appended to (in call order)."""
    global _FLOWS
    prev, _FLOWS = _FLOWS, []
    try:
        yield _FLOWS
    finally:
        _FLOWS = prev


def _count(kind: str, mesh: "Mesh", axis: str, in_bytes: int,
           out_bytes: int) -> None:
    """Count one collective of `kind` over `axis`; record it if armed."""
    _COUNTS[kind] += 1
    if _FLOWS is None:
        return
    flow_kind = FLOW_KIND[kind]
    _FLOWS.append(hlo_flows.CollectiveFlow(
        kind=flow_kind, hlo_name=f"{flow_kind}.{len(_FLOWS)}",
        input_bytes=in_bytes, output_bytes=out_bytes,
        group_size=2 if flow_kind == "collective-permute" else
        mesh.size(axis),
        group_stride=mesh.stride(axis), op_name=hlo_flows.scope_path(),
        component=hlo_flows.current_component(), axis=axis))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ----------------------------------------------------------- processes ----
def default_backend(device: Union[str, torch.device]) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(backend: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda", *,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device.

    rank / world_size default to torchrun's RANK / WORLD_SIZE and
    init_method to "env://" (MASTER_ADDR, MASTER_PORT).  On CUDA the rank
    takes card LOCAL_RANK under nccl; under gloo the ranks of a host
    share its cards round-robin (one card: all of them on cuda:0)."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, got {backend!r}")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = (int(os.environ["WORLD_SIZE"]) if world_size is None
             else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda asked for, but CUDA is not "
                               "available")
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and world > n_cards:
            raise RuntimeError(
                f"nccl takes one rank per card: a world of {world} ranks "
                f"exceeds the {n_cards} CUDA device(s) here; ranks that "
                f"share a card need --dist-backend gloo")
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("nccl needs CUDA tensors: use gloo on the CPU")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "gloo" and device.type == "cuda":
        _probe_gloo_cuda(device)
    return device


def shutdown() -> None:
    """Leave the process group (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _probe_gloo_cuda(device: torch.device) -> None:
    """Which collectives gloo runs on CUDA tensors of each dtype: the rest
    go through explicit host copies.  Every rank runs the same checks in
    the same order, so a refusal (raised before any message is sent) is
    seen by all of them."""
    world, rank = dist.get_world_size(), dist.get_rank()
    direct = []
    for dtype in _PROBE_DTYPES:
        for kind in ("all_reduce", "all_reduce_max", "all_gather",
                     "all_to_all", "broadcast"):
            t = torch.full((4,), rank + 1, dtype=dtype, device=device)
            try:
                if kind == "all_reduce":
                    dist.all_reduce(t)
                    want = world * (world + 1) // 2
                elif kind == "all_reduce_max":
                    dist.all_reduce(t, op=dist.ReduceOp.MAX)
                    want = world
                elif kind == "all_gather":
                    parts = [torch.empty_like(t) for _ in range(world)]
                    dist.all_gather(parts, t)
                    t = torch.cat(parts)
                    want = None
                elif kind == "all_to_all":
                    # chunk j of each rank goes to rank j: every rank
                    # receives 1..world in order, as all_gather gives
                    t = torch.full((4 * world,), rank + 1, dtype=dtype,
                                   device=device)
                    got = torch.empty_like(t)
                    dist.all_to_all_single(got, t)
                    t, want = got, None
                else:
                    dist.broadcast(t, 0)
                    want = 1
            except RuntimeError:
                _HOST_COPIED.add((kind, dtype))
                continue
            got = t.cpu().float()
            ok = (torch.equal(got, torch.arange(1, world + 1).float()
                              .repeat_interleave(4)) if want is None
                  else bool((got == want).all()))
            if not ok:
                raise RuntimeError(f"gloo {kind} on CUDA {dtype} gave "
                                   f"{got.tolist()}")
            direct.append(f"{kind} {str(dtype)[6:]}")
    if rank == 0:
        staged = sorted(f"{k} {str(d)[6:]}" for k, d in _HOST_COPIED)
        print(f"[mesh] gloo on CUDA tensors: direct: {', '.join(direct)}; "
              f"through host copies: {', '.join(staged) or 'none'}",
              flush=True)


# --------------------------------------------------------------- meshes ----
class Mesh:
    """A named grid of ranks.  `devices` holds the global rank at each
    position (the duck type of a jax Mesh that `sharding.spec_tree`
    reads: `axis_names`, `devices.shape`)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 device_mesh=None) -> None:
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axes)}")
        self.axis_names = tuple(axes)
        self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self.device_mesh = device_mesh

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.devices.shape)

    def size(self, axes: Axes = None) -> int:
        """Extent of one axis or the product over several (1 for an axis
        the mesh lacks); the whole mesh for None."""
        if axes is None:
            return int(self.devices.size)
        sizes = dict(zip(self.axis_names, self.shape))
        return math.prod(sizes.get(a, 1) for a in _as_tuple(axes))

    def stride(self, axis: str) -> int:
        """The rank-number distance between neighbours along `axis` in
        the row-major numbering (1 for the last axis)."""
        i = self.axis_names.index(axis)
        return math.prod(self.shape[i + 1:])

    def coord(self, axes: Axes) -> int:
        """This rank's index along one axis, or its row-major index over
        several (0 on axes the mesh lacks)."""
        idx = 0
        for a in _as_tuple(axes):
            n = self.size(a)
            i = (self.device_mesh.get_local_rank(a)
                 if n > 1 else 0)
            idx = idx * n + i
        return idx

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"


def _as_tuple(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """The mesh over the process group's ranks (row-major, as
    `jax.make_mesh` lays devices out).  Its size must equal the world's;
    a mesh of one rank needs no process group."""
    shape = tuple(int(s) for s in shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, "
                         f"the world has {world}")
    if world == 1:
        return Mesh(shape, axes)
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, axes, init_device_mesh(
        device_type, shape, mesh_dim_names=tuple(axes)))


# ---------------------------------------------------------- collectives ----
def _run(kind: str, t: torch.Tensor, fn) -> None:
    """fn(t) in place, on a host copy where gloo refuses CUDA tensors."""
    if t.is_cuda and (kind, t.dtype) in _HOST_COPIED:
        host = t.cpu()
        fn(host)
        t.copy_(host)
    else:
        fn(t)


def all_reduce(t: torch.Tensor, mesh: Optional[Mesh], axes: Axes,
               op: str = "sum") -> torch.Tensor:
    """Sum (or max) `t` IN PLACE over the ranks along `axes`, one axis
    after the other; returns t."""
    if mesh is None:
        return t
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    kind = "all_reduce" if op == "sum" else "all_reduce_max"
    for a in _as_tuple(axes):
        if mesh.size(a) > 1:
            _count("all_reduce", mesh, a, _nbytes(t), _nbytes(t))
            _run(kind, t, lambda x, a=a: dist.all_reduce(
                x, op=rop, group=mesh.group(a)))
    return t


def all_gather(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
               dim: int = 0) -> torch.Tensor:
    """The shards of every rank along `axis`, concatenated on `dim` in
    the axis' order."""
    if mesh is None or mesh.size(axis) == 1:
        return t
    _count("all_gather", mesh, axis, _nbytes(t),
           _nbytes(t) * mesh.size(axis))
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    group = mesh.group(axis)
    if t.is_cuda and ("all_gather", t.dtype) in _HOST_COPIED:
        host = [p.cpu() for p in parts]
        dist.all_gather(host, t.cpu(), group=group)
        parts = [h.to(t.device) for h in host]
    else:
        dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_to_all(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
               dim: int = 0) -> torch.Tensor:
    """`t` split into size(axis) equal chunks along `dim`, chunk j sent
    to the rank at index j along `axis`; returns the chunks received,
    concatenated along `dim` in the axis' order (chunk i from index i).
    Split and concat on one dim: the call is its own inverse."""
    if mesh is None or mesh.size(axis) == 1:
        return t
    _count("all_to_all", mesh, axis, _nbytes(t), _nbytes(t))
    x = t.movedim(dim, 0).contiguous()
    group = mesh.group(axis)
    if x.is_cuda and ("all_to_all", x.dtype) in _HOST_COPIED:
        host = torch.empty(x.shape, dtype=x.dtype)
        dist.all_to_all_single(host, x.cpu(), group=group)
        out = host.to(x.device)
    else:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
    return out.movedim(0, dim)


def broadcast(t: torch.Tensor, mesh: Optional[Mesh], axis: str,
              src: int = 0) -> torch.Tensor:
    """t IN PLACE from the rank at index `src` along `axis`."""
    if mesh is None or mesh.size(axis) == 1:
        return t
    _count("broadcast", mesh, axis, _nbytes(t), _nbytes(t))
    group = mesh.group(axis)
    _run("broadcast", t, lambda x: dist.broadcast(
        x, dist.get_global_rank(group, src), group=group))
    return t


class _HostSend:
    """An isend's request together with the host copy it sends: the copy
    lives until the request is waited on."""

    def __init__(self, work, host: torch.Tensor) -> None:
        self.work, self.host = work, host

    def wait(self, *args, **kwargs):
        out = self.work.wait(*args, **kwargs)
        self.host = None
        return out

    def is_completed(self) -> bool:
        return self.work.is_completed()


def _host_p2p(t: torch.Tensor, group) -> bool:
    """True where gloo carries the point-to-point message: its send and
    recv take CPU tensors only, so a CUDA tensor goes through a host
    copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def send(t: torch.Tensor, mesh: Mesh, axis: str, dst: int, tag: int = 0):
    """Start sending t to the rank at index `dst` along `axis`; returns
    the request (wait on it before t is changed).  Under gloo a CUDA
    tensor is sent from a host copy, which the request keeps alive until
    it is waited on."""
    _count("send", mesh, axis, _nbytes(t), 0)
    group = mesh.group(axis)
    peer = dist.get_global_rank(group, dst)
    if _host_p2p(t, group):
        # contiguous: `.cpu()` keeps a transposed view's strides, and
        # gloo sends a dense buffer only
        host = t.detach().contiguous().cpu()
        return _HostSend(dist.isend(host, peer, group=group, tag=tag), host)
    return dist.isend(t.contiguous(), peer, group=group, tag=tag)


def recv(out: torch.Tensor, mesh: Mesh, axis: str, src: int,
         tag: int = 0) -> torch.Tensor:
    """Receive into `out` from index `src` along `axis`; returns out
    (under gloo a CUDA `out` is filled from a host buffer)."""
    _count("recv", mesh, axis, 0, _nbytes(out))
    group = mesh.group(axis)
    peer = dist.get_global_rank(group, src)
    if _host_p2p(out, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        dist.recv(host, peer, group=group, tag=tag)
        out.copy_(host)
    else:
        dist.recv(out, peer, group=group, tag=tag)
    return out
