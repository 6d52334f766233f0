"""Nested dicts of tensors (params, optimizer state, train state) as the
reference's pytrees: leaves in JAX's flattening order (dict keys sorted,
depth first) and named by their '/'-joined key path, as
`repro/ckpt/manager.py::_flatten` names them."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Tree = Dict[str, Any]


def leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's order: sorted keys, depth first."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out += leaves_with_path(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any,
                  prefix: str = "") -> Any:
    """fn(path, leaf, *leaves of `rest` at the same path) over `tree`."""
    if not isinstance(tree, dict):
        return fn(prefix, tree, *rest)
    return {k: map_with_path(fn, v, *(r[k] for r in rest),
                             prefix=f"{prefix}/{k}" if prefix else k)
            for k, v in tree.items()}


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """fn(leaf, *leaves of `rest` at the same path) over `tree`."""
    return map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)
