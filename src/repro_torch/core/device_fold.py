"""The XFA device layer: the in-graph fold table and the static costs.

`DeviceFoldSpec` is the port of the reference's Relation-Aware Data
Folding inside the step: a fixed-shape f32 tensor rides through the
model's `forward`, `loss_fn` and `forward_chunk` on the model's device,
and every instrumented site adds its metrics at an offset resolved when
the site is declared.  What it folds is the data-dependent signal that
static costs cannot see: the MoE layer's per-expert load, dropped
tokens and router losses, and the trainer's step count.  `emit` returns
a NEW table (the reference returns the updated vector), so a site run
again by activation recompute adds nothing to the table the caller
keeps; it is a device add with no host sync.  The table crosses to the
host once, at the end of a run (`XFASession.finish_device`), and
`fold` turns it into a FoldedTable in f64, as in the reference.
torch is imported where a table is made or added to, so the profile
plane, which folds on the host only, starts without it.

Static per-call costs: model code calls `annotate_cost` as it runs; the
registry accumulates analytic FLOPs/bytes per (caller, component, api)
edge.  The reference package registers costs while JAX TRACES a step, so
one trace is one step's worth of applications; PyTorch runs eagerly, so
here one CALL of the forward pass registers the same edges and totals as
one trace of the reference.

`scan_multiplier` keeps the reference's interface for code that executes
a body once on behalf of `length` applications.  The port's layer loop
runs every layer, so it does NOT wrap that loop in a multiplier — the
costs would count twice.  `shard_scale` is its counterpart for a call
that does one shard of a global operation (a rank's batch rows or its
heads under a mesh): its metrics are scaled to the global operation's,
its count is not, so every rank registers the numbers one trace of the
reference's SPMD program registers.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .folding import EdgeStats, FoldedTable
from .shadow import KIND_CALL, SlotKey

DeviceSlotKey = Tuple[str, str, str, str]  # (caller, component, api, metric)


@dataclass(frozen=True)
class DeviceSlot:
    key: DeviceSlotKey
    offset: int
    width: int


class DeviceFoldSpec:
    """Declared-upfront slot layout for one model family's device fold.

    Model builders declare every metric they will emit (they know E,
    top_k, ... from the config), the spec freezes, and `init_table`
    returns the zeroed tensor.  Declaring after freeze or emitting an
    undeclared key raises — an unresolved shadow entry is a bug, not a
    fallback."""

    def __init__(self) -> None:
        self._slots: Dict[DeviceSlotKey, DeviceSlot] = {}
        self._order: List[DeviceSlot] = []
        self._size = 0
        self._frozen = False
        self._lock = threading.Lock()

    def declare(self, caller: str, component: str, api: str, metric: str,
                width: int = 1) -> DeviceSlot:
        key = (caller, component, api, metric)
        with self._lock:
            if key in self._slots:
                existing = self._slots[key]
                if existing.width != width:
                    raise ValueError(f"slot {key} re-declared with width "
                                     f"{width} != {existing.width}")
                return existing
            if self._frozen:
                raise RuntimeError(f"DeviceFoldSpec frozen; cannot declare {key}")
            slot = DeviceSlot(key, self._size, width)
            self._slots[key] = slot
            self._order.append(slot)
            self._size += width
            return slot

    def freeze(self) -> "DeviceFoldSpec":
        self._frozen = True
        return self

    @property
    def size(self) -> int:
        return max(self._size, 1)

    def slots(self) -> List[DeviceSlot]:
        return list(self._order)

    # -- device ops ----------------------------------------------------------
    def init_table(self, device=None, dtype=None):
        """The zeroed f32 table on `device`."""
        import torch
        return torch.zeros((self.size,), dtype=dtype or torch.float32,
                           device=device)

    def emit(self, table, caller: str, component: str, api: str,
             metric: str, value):
        """Fold `value` (a Python number, or a tensor of `width` elements
        on the table's device) into its slot; returns a new table.  A
        tensor is detached: observability must not perturb training."""
        import torch
        key = (caller, component, api, metric)
        slot = self._slots.get(key)
        if slot is None:
            raise KeyError(f"device fold slot not declared: {key}")
        out = table.clone()
        seg = out.narrow(0, slot.offset, slot.width)
        if isinstance(value, torch.Tensor):
            v = value.detach().to(table.dtype).reshape(-1)
            if v.shape[0] != slot.width:
                raise ValueError(f"slot {key} width {slot.width}, got "
                                 f"{v.shape[0]}")
            seg.add_(v)
        else:
            # a host number adds as a kernel argument: no copy to the card
            v = np.asarray(value, dtype=np.float64).reshape(-1)
            if v.shape[0] != slot.width:
                raise ValueError(f"slot {key} width {slot.width}, got "
                                 f"{v.shape[0]}")
            if slot.width == 1:
                seg.add_(float(v[0]))
            else:
                seg.add_(torch.as_tensor(v, dtype=table.dtype,
                                         device=table.device))
        return out

    def read(self, table, caller: str, component: str, api: str,
             metric: str):
        slot = self._slots[(caller, component, api, metric)]
        return table.narrow(0, slot.offset, slot.width)

    # -- host-side fold ------------------------------------------------------
    def fold(self, table_np, group: str = "device") -> FoldedTable:
        """Convert a fetched fold vector into a FoldedTable whose edges
        carry the metrics; vector slots expand to metric[i] entries."""
        if hasattr(table_np, "detach"):        # a torch tensor
            table_np = table_np.detach().cpu().numpy()
        table_np = np.asarray(table_np, dtype=np.float64)
        edges: Dict[SlotKey, EdgeStats] = {}
        for slot in self._order:
            caller, component, api, metric = slot.key
            ekey: SlotKey = (caller, component, api)
            e = edges.get(ekey)
            if e is None:
                e = edges[ekey] = EdgeStats(kind=KIND_CALL)
            span = table_np[slot.offset: slot.offset + slot.width]
            if slot.width == 1:
                e.metrics[metric] = e.metrics.get(metric, 0.0) + float(span[0])
            else:
                for i, v in enumerate(span):
                    k = f"{metric}[{i}]"
                    e.metrics[k] = e.metrics.get(k, 0.0) + float(v)
            if metric == "count":
                e.count += int(round(float(span.sum())))
        return FoldedTable(edges, group=group)


# ---------------------------------------------------------------------------
# Static per-call costs: the zero-overhead fold.  Model code calls
# annotate_cost as it runs; the registry accumulates analytic FLOPs/bytes
# per edge.  One call of the forward pass == one reference trace.
# ---------------------------------------------------------------------------


@dataclass
class StaticCostRegistry:
    costs: Dict[SlotKey, Dict[str, float]] = field(default_factory=dict)
    #: multiplier stack: a body executed once on behalf of `length`
    #: applications pushes `length` so its analytic costs keep their true
    #: per-step multiplicity.
    _mult_stack: List[float] = field(default_factory=lambda: [1.0])
    #: shard-scale stack: metrics (not counts) of a call that computes
    #: 1/scale of a global operation are scaled up to the global numbers
    _scale_stack: List[float] = field(default_factory=lambda: [1.0])

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
        scale = m * self._scale_stack[-1]
        for name, v in metrics.items():
            d[name] = d.get(name, 0.0) + float(v) * scale
        d["count"] = d.get("count", 0.0) + m

    def reset(self) -> None:
        self.costs.clear()
        self._mult_stack[:] = [1.0]
        self._scale_stack[:] = [1.0]

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


class shard_scale:
    """Context manager: costs registered inside are those of one of
    `factor` equal shards of a global operation; their metrics count
    `factor` times, their call count once."""

    def __init__(self, factor: float,
                 registry: Optional[StaticCostRegistry] = None):
        self.factor = float(factor)
        self.registry = registry or STATIC_COSTS

    def __enter__(self):
        st = self.registry._scale_stack
        st.append(st[-1] * self.factor)
        return self

    def __exit__(self, *exc):
        self.registry._scale_stack.pop()
        return False


def annotate_cost(caller: str, component: str, api: str, **metrics: float) -> None:
    STATIC_COSTS.annotate(caller, component, api, **metrics)
