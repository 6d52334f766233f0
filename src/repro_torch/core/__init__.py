"""repro_torch.core — the Cross Flow Analysis (XFA) host layer.

  tracer.py + shadow.py   @xfa.api boundaries, Universal Shadow Table
                          slots, per-thread lock-free folds
  folding.py              Relation-Aware Data Folding algebra
  histogram.py            bounded log-bucket latency histograms
  sampler.py              adaptive 1-in-k timing governor
  device_fold.py          the device fold table (DeviceFoldSpec) and
                          static per-call costs (annotate_cost)
  views.py, attribution.py, session.py
                          component / API views, serial-parallel
                          attribution, and XFASession (report, shards)

These are the reference package's numpy/stdlib modules, kept here as the
port's own copies so that nothing of the JAX package is imported.
"""

from .shadow import (APP_COMPONENT, KIND_CALL, KIND_WAIT, ShadowTable,
                     ShadowTableSet, SlotInfo, SlotRegistry)
from .folding import EdgeStats, FoldedTable, fold_event_log
from .tracer import (TRACER, Tracer, api, count_event, current_component,
                     reset, scope, set_enabled, set_thread_group, set_timing,
                     wait, wrap)
from .device_fold import (STATIC_COSTS, DeviceFoldSpec, annotate_cost,
                          scan_multiplier)
