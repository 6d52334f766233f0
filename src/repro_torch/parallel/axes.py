"""The ambient mesh and the logical-axis rules, as the reference's
`parallel/axes.py` keeps them.

Model code never names a concrete mesh: it asks for logical axes
('batch', 'model', 'vocab', ...), and the launch layer installs a mesh
and a logical -> mesh translation once per run.  Without a mesh every
query answers as one device does, so the same model code runs
everywhere.

Logical axes:
  batch    data-parallel batch dim      -> ('pod', 'data') when present
  seq      sequence (context/SP dim)    -> 'data' for long-decode CP, or None
  model    tensor-parallel dim          -> 'model'
  expert   MoE expert dim               -> 'model' (EP shares the TP axis)
  kv_seq   KV-cache sequence dim        -> 'model' when heads unshardable
  vocab    embedding / lm-head rows     -> 'model'

The mesh is held per process, not per thread (the reference's is
thread-local): torch runs a backward pass, and the recompute of a
checkpointed layer inside it, on its own autograd threads, which must
see the mesh the forward saw.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

from .mesh import Mesh

#: default logical -> mesh translation; a tuple composes mesh axes
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "model": ("model",),
    "expert": ("model",),
    "kv_seq": (),
    "vocab": ("model",),
}

_state = {"mesh": None, "rules": DEFAULT_RULES}

#: a placement per dim: None (whole), a mesh axis, or a tuple of axes
Placement = Optional[object]


def set_runtime_mesh(mesh: Optional[Mesh],
                     rules: Optional[Dict[str, Tuple[str, ...]]] = None
                     ) -> None:
    _state["mesh"] = mesh
    _state["rules"] = dict(DEFAULT_RULES, **(rules or {}))


def get_runtime_mesh() -> Optional[Mesh]:
    return _state["mesh"]


def get_rules() -> Dict[str, Tuple[str, ...]]:
    return _state["rules"]


@contextmanager
def runtime_mesh(mesh: Optional[Mesh],
                 rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    prev = dict(_state)
    set_runtime_mesh(mesh, rules)
    try:
        yield
    finally:
        _state.update(prev)


def mesh_axes(logical: str) -> Tuple[str, ...]:
    """The installed mesh's axes a logical axis maps to (() without a
    mesh)."""
    mesh = get_runtime_mesh()
    if mesh is None:
        return ()
    return tuple(m for m in get_rules().get(logical, ())
                 if m in mesh.axis_names)


def resolve_spec(*logical_axes: Optional[str]) -> Tuple[Placement, ...]:
    """Logical axis names -> the placement of each dim under the current
    rules (the reference returns a PartitionSpec of the same entries),
    dropping mesh axes the installed mesh lacks."""
    parts = []
    for ax in logical_axes:
        mapped = mesh_axes(ax) if ax is not None else ()
        parts.append(None if not mapped else
                     mapped[0] if len(mapped) == 1 else mapped)
    return tuple(parts)


def shard(x, *logical_axes: Optional[str]):
    """The identity.  In the reference this is a GSPMD layout constraint
    (`with_sharding_constraint`): it tells XLA's partitioner where a
    value should live, and the partitioner moves it.  The port's ranks
    hold their shards explicitly and communicate where the math needs
    it (`parallel/tp.py`), so there is nothing to constrain, and no
    redistribution is made up in its place."""
    return x


def shard_dims(x, dim_axes: Dict[int, str]):
    """The identity, for the reason `shard` gives."""
    return x


def axis_size(logical: str) -> int:
    """Product of the mesh-axis sizes a logical axis maps to (1 without a
    mesh)."""
    mesh = get_runtime_mesh()
    return mesh.size(mesh_axes(logical)) if mesh is not None else 1
