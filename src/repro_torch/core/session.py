"""XFASession — wire the XFA layers around a training/serving step.

The port's copy of `repro/core/session.py`.  The device layer is the
port's `DeviceFoldSpec`: the model's fold table is a torch tensor on its
device, fetched and folded once by `finish_device`, and the fold merges
into `report()` and into the shards the run writes, as in the
reference.  The collective flows come from HLO text (`attach_hlo`,
through the port's copy of the parser, `hlo_flows.py`) or, for a torch
run, from the recorder of `repro_torch.parallel.mesh`
(`attach_collectives`): one step's collectives, each with its
component, mesh axis and bytes.

The session is the user-facing object (the paper's 'Scaler runtime' +
'offline visualizer' pair):

  L1 host layer    TRACER records every framework boundary around dispatch
  L2 device layer  a DeviceFoldSpec table threads through the jitted step
  L3 static layer  trace-time analytic costs + compiled-HLO collective flows

`report()` merges everything into one FoldedTable and renders the paper's
component view / API view / flow matrix, plus the TPU-specific collective
flow summary that feeds the roofline collective term.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from . import tracer as xfa
from .attribution import (attribute_parallel, attribute_serial,
                          combine_phases, imbalance_report, wait_split)
from .device_fold import STATIC_COSTS, DeviceFoldSpec
from .folding import FoldedTable
from .hlo_flows import (CollectiveFlow, CollectiveSummary,
                        find_redundant_gathers, parse_collective_flows)
from .views import (View, api_view, api_view_by_caller, component_view,
                    flow_matrix, metric_view, render_flow_matrix)

#: component vocabulary used to resolve HLO op_name scopes; model code uses
#: jax.named_scope with these names.
KNOWN_COMPONENTS = (
    "embed", "attention", "mlp", "moe", "ssm", "mlstm", "slstm", "norm",
    "rope", "lm_head", "loss", "optimizer", "grads", "collective", "data",
    "ckpt", "serve", "decode", "prefill", "encoder", "decoder", "cross",
    "runtime", "pipeline", "app",
)


@dataclass
class XFAReport:
    folded: FoldedTable
    collectives: Optional[CollectiveSummary]
    wall_ns: float
    n_steps: int

    def component_view(self, component: str,
                       total_ns: Optional[float] = None) -> View:
        if component == "app" and total_ns is None:
            total_ns = self.wall_ns
        return component_view(self.folded, component, total_ns)

    def api_view(self, component: str) -> View:
        return api_view(self.folded, component)

    def api_view_by_caller(self, component: str) -> View:
        return api_view_by_caller(self.folded, component)

    def metric_view(self, metric: str) -> View:
        return metric_view(self.folded, metric)

    def render(self, components: Sequence[str] = ("app",)) -> str:
        parts = [f"XFA report: {self.n_steps} steps, "
                 f"wall {self.wall_ns/1e9:.3f}s"]
        for c in components:
            parts.append(self.component_view(c).render())
            parts.append(self.api_view(c).render())
        parts.append(render_flow_matrix(self.folded))
        if self.collectives and self.collectives.flows:
            parts.append("Collective flows (wire bytes/device/step):")
            for comp, b in sorted(self.collectives.by_component.items(),
                                  key=lambda kv: -kv[1]):
                parts.append(f"  {comp:<20} {b/1e6:>12.3f} MB")
            for axis, b in sorted(self.collectives.by_axis.items()):
                parts.append(f"  axis {axis:<15} {b/1e6:>12.3f} MB")
            red = find_redundant_gathers(self.collectives.flows)
            if red:
                parts.append("  redundant collectives (same shape+site):")
                for desc, n in red[:10]:
                    parts.append(f"    {n}x {desc}")
        return "\n\n".join(parts)

    def to_json(self) -> dict:
        return {
            "wall_ns": self.wall_ns,
            "n_steps": self.n_steps,
            "folded": self.folded.to_json(),
            "collectives": {
                "by_component": self.collectives.by_component,
                "by_kind": self.collectives.by_kind,
                "by_axis": self.collectives.by_axis,
                "total_wire_bytes": self.collectives.total_wire_bytes,
            } if self.collectives else None,
        }


class XFASession:
    """Profiles a run: host folds + device fold table + HLO collective flows.

    Usage:
        spec = DeviceFoldSpec(); model declares slots; spec.freeze()
        sess = XFASession(device_spec=spec, dp_degree=16)
        table = sess.init_device_table()
        ... step = jit(step_fn) ; table carried through ...
        sess.observe_step(wall_ns)       # per dispatched step
        sess.finish_device(table)        # fetch + fold once at the end
        sess.attach_hlo(compiled.as_text(), mesh_axes={...})
        report = sess.report()
    """

    def __init__(self, device_spec: Optional[DeviceFoldSpec] = None,
                 dp_degree: int = 1, tracer=None) -> None:
        self.device_spec = device_spec
        self.dp_degree = dp_degree
        self.tracer = tracer or xfa.TRACER
        self.n_steps = 0
        self.wall_ns = 0.0
        self._device_fold: Optional[FoldedTable] = None
        self._collectives: Optional[CollectiveSummary] = None
        self._static_snapshot: Optional[FoldedTable] = None

    # -- device table ------------------------------------------------------
    def init_device_table(self, device=None):
        if self.device_spec is None:
            raise RuntimeError("no DeviceFoldSpec attached")
        return self.device_spec.init_table(device)

    def finish_device(self, table) -> None:
        """Fetch the fold table (one copy to the host) and fold it."""
        if hasattr(table, "detach"):           # a torch tensor
            table = table.detach().cpu().numpy()
        arr = np.asarray(table, dtype=np.float64)
        self._device_fold = self.device_spec.fold(arr, group="device")

    # -- step accounting -----------------------------------------------------
    def observe_step(self, wall_ns: float, n: int = 1) -> None:
        self.n_steps += n
        self.wall_ns += wall_ns

    # -- static layers -------------------------------------------------------
    def snapshot_static(self) -> None:
        """Capture trace-time analytic costs; call right after tracing/jit."""
        self._static_snapshot = STATIC_COSTS.as_folded()

    def attach_hlo(self, hlo_text: str,
                   mesh_axes: Optional[Dict[str, int]] = None) -> None:
        flows = parse_collective_flows(hlo_text, KNOWN_COMPONENTS, mesh_axes)
        self._collectives = CollectiveSummary.build(flows)

    def attach_collectives(self, flows: Sequence[CollectiveFlow]) -> None:
        """One step's collectives, as `parallel.mesh.recording()` recorded
        them on this rank."""
        self._collectives = CollectiveSummary.build(list(flows))

    @property
    def device_fold(self) -> Optional[FoldedTable]:
        """The folded device table (after `finish_device`)."""
        return self._device_fold

    # -- report --------------------------------------------------------------
    def host_folds(self) -> List[FoldedTable]:
        return FoldedTable.from_set(self.tracer.tables,
                                    rates=self.tracer.sample_rates())

    def folded_all(self, include_replicated: bool = True) -> FoldedTable:
        """Raw merge of host + device + static folds — no attribution, no
        step scaling.  This is what persists to profile shards: host totals
        stay additive, so shards from N processes reduce to exactly the
        profile one process doing all the work would have written.

        The device and static folds hold *replicated* (globally identical)
        values in SPMD: every rank traces the same program and fetches the
        same fold vector.  In a multi-process run only one rank should shard
        them (`include_replicated=False` on the others), or the cross-rank
        reduce would count them once per rank."""
        merged = FoldedTable.merge_all(self.host_folds())
        if not include_replicated:
            return merged
        if self._device_fold is not None:
            merged = merged.merge(self._device_fold)
        static = self._static_snapshot
        if static is None:
            static = STATIC_COSTS.as_folded()
        if len(static):
            merged = merged.merge(static)
        return merged

    def snapshot(self, path: str, meta: Optional[Dict[str, Any]] = None,
                 include_replicated: bool = True) -> str:
        """Persist the current raw profile as one snapshot shard (atomic)."""
        from ..profile import ProfileSnapshot  # avoid import cycle
        snap_meta: Dict[str, Any] = {"n_steps": self.n_steps,
                                     "wall_ns": self.wall_ns}
        snap_meta.update(meta or {})
        return ProfileSnapshot.from_folded(
            self.folded_all(include_replicated), meta=snap_meta).save(path)

    def report(self, parallel_groups: Optional[Dict[str, int]] = None
               ) -> XFAReport:
        """Merge host (per-thread), device, and static folds.

        `parallel_groups`: thread-group name -> lane count; groups listed are
        attributed as parallel phases (duration / lanes), others serial.
        """
        phases = []
        for fold in self.host_folds():
            lanes = (parallel_groups or {}).get(fold.group, 1)
            phases.append(attribute_parallel(fold, lanes) if lanes > 1
                          else attribute_serial(fold))
        merged = combine_phases(phases)
        if self._device_fold is not None:
            merged = merged.merge(self._device_fold)
        static = self._static_snapshot
        if static is None:
            static = STATIC_COSTS.as_folded()
        # static costs are per traced step; scale to the observed step count
        if self.n_steps > 1 and len(static):
            scaled = FoldedTable(group="static")
            for k, e in static.edges.items():
                e2 = e.merge(type(e)())  # copy
                e2.metrics = {m: v * self.n_steps for m, v in e.metrics.items()}
                e2.count = e.count * self.n_steps
                scaled.edges[k] = e2
            static = scaled
        merged = merged.merge(static)
        return XFAReport(merged, self._collectives, self.wall_ns, self.n_steps)

    def imbalance(self, threshold: float = 4.0):
        by_group: Dict[str, List[FoldedTable]] = {}
        for fold in self.host_folds():
            by_group.setdefault(fold.group, []).append(fold)
        return imbalance_report(by_group, threshold)

    def dump(self, path: str) -> None:
        rep = self.report()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rep.to_json(), f, indent=1)
