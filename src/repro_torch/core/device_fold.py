"""Static per-call costs — the zero-overhead fold of the XFA static layer.

Model code calls `annotate_cost` as it runs; the registry accumulates
analytic FLOPs/bytes per (caller, component, api) edge.  The reference
package registers costs while JAX TRACES a step, so one trace is one
step's worth of applications; PyTorch runs eagerly, so here one CALL of
the forward pass registers the same edges and totals as one trace of the
reference.

`scan_multiplier` keeps the reference's interface for code that executes
a body once on behalf of `length` applications.  The port's layer loop
runs every layer, so it does NOT wrap that loop in a multiplier — the
costs would count twice.

The in-graph device fold (`DeviceFoldSpec`) is not part of this package
yet; the model threads its `table` argument through unchanged (None).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .folding import EdgeStats, FoldedTable
from .shadow import KIND_CALL, SlotKey


@dataclass
class StaticCostRegistry:
    costs: Dict[SlotKey, Dict[str, float]] = field(default_factory=dict)
    #: multiplier stack: a body executed once on behalf of `length`
    #: applications pushes `length` so its analytic costs keep their true
    #: per-step multiplicity.
    _mult_stack: List[float] = field(default_factory=lambda: [1.0])

    def push_multiplier(self, m: float) -> None:
        self._mult_stack.append(self._mult_stack[-1] * m)

    def pop_multiplier(self) -> None:
        self._mult_stack.pop()

    @property
    def multiplier(self) -> float:
        return self._mult_stack[-1]

    def annotate(self, caller: str, component: str, api: str,
                 **metrics: float) -> None:
        key = (caller, component, api)
        d = self.costs.setdefault(key, {})
        m = self.multiplier
        for name, v in metrics.items():
            d[name] = d.get(name, 0.0) + float(v) * m
        d["count"] = d.get("count", 0.0) + m

    def reset(self) -> None:
        self.costs.clear()
        self._mult_stack[:] = [1.0]

    def as_folded(self, group: str = "static") -> FoldedTable:
        edges: Dict[SlotKey, EdgeStats] = {}
        for key, metrics in self.costs.items():
            e = EdgeStats(kind=KIND_CALL, metrics=dict(metrics))
            e.count = int(round(metrics.get("count", 0.0)))
            edges[key] = e
        return FoldedTable(edges, group=group)


STATIC_COSTS = StaticCostRegistry()


class scan_multiplier:
    """Context manager: costs registered inside are multiplied by
    `length` (a body executed once on behalf of `length` applications)."""

    def __init__(self, length: float, registry: Optional[StaticCostRegistry] = None):
        self.length = float(length)
        self.registry = registry or STATIC_COSTS

    def __enter__(self):
        self.registry.push_multiplier(self.length)
        return self

    def __exit__(self, *exc):
        self.registry.pop_multiplier()
        return False


def annotate_cost(caller: str, component: str, api: str, **metrics: float) -> None:
    STATIC_COSTS.annotate(caller, component, api, **metrics)
