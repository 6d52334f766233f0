"""Training: step construction and the run loop, on torch.

The port of `repro/runtime/trainer.py`.  `make_train_step` builds

  (train_state, batch, table) -> (train_state, metrics, table)

with gradient microbatching (accumulation in f32), torch autograd for the
gradients, the port's AdamW and the XFA device fold table threaded
through (the model's layers emit into it; the step adds one
("app", "loss", "train_step") count); `Trainer.run` is the loop:
prefetching data, the `runtime/dispatch_step` and `runtime/device_sync`
scopes, periodic (async) checkpoints, resume from the latest one, and XFA
profile shards through the port's ProfileStore and run manifest.  The
table is fetched and folded once, at the end of the run, so the final
shard carries the `device` group, as in the reference.

PyTorch runs eagerly: there is no compile step, and a step is dispatched
op by op.  `deferred_grad_reduce` changes only where the reference's
gradient all-reduce happens across devices; on one device it is the same
arithmetic as the per-microbatch accumulation, which both settings run.
With `profile_dir` and `xfa_collector` set, every shard refresh also
streams the ring's unacked entries to a fleet collector.
Not ported: int8 gradient compression raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..ckpt.manager import CheckpointManager
from ..configs.base import TrainConfig
from ..core import tracer as xfa
from ..core.session import XFASession
from ..data.pipeline import SyntheticLMData
from ..models.api import Model
from ..optim import adamw
from ..tree import leaves_with_path, map_with_path, tree_map


def _no_compression(tcfg: TrainConfig) -> None:
    if tcfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={tcfg.grad_compression!r} is not ported to "
            f"PyTorch yet (ROADMAP.md)")


def init_train_state(model: Model, seed: int, tcfg: TrainConfig
                     ) -> Dict[str, Any]:
    _no_compression(tcfg)
    params = model.init(seed)
    return {"params": params, "opt": adamw.init_state(params)}


def value_and_grad(model: Model, params, batch, table):
    """(loss, metrics, table, grads) of model.loss_fn at params: grads a
    tree like params (each leaf in its param's dtype); loss and metrics
    detached."""
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, (metrics, table) = model.loss_fn(req, batch, table)
    named = leaves_with_path(req)
    grads = dict(zip((n for n, _ in named),
                     torch.autograd.grad(loss, [t for _, t in named])))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            table, map_with_path(lambda path, _: grads[path], req))


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """The step.  Microbatching splits the batch on axis 0 into
    tcfg.microbatches parts and accumulates their gradients in f32, each
    divided by the count, as the reference does; the fold table runs
    through every microbatch.  A `table` of None folds nothing."""
    _no_compression(tcfg)

    def step(state, batch, table):
        params = state["params"]
        n_micro = tcfg.microbatches
        if n_micro <= 1:
            loss, metrics, table, grads = value_and_grad(model, params,
                                                         batch, table)
        else:
            rows = len(batch["tokens"]) // n_micro
            grads, loss = None, 0.0
            for i in range(n_micro):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, metrics, table, g = value_and_grad(model, params, mb,
                                                      table)
                g = tree_map(lambda x: x.float() / n_micro, g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l / n_micro
            metrics["loss"] = loss
        params, opt, opt_metrics = adamw.apply_updates(params, state["opt"],
                                                       grads, tcfg)
        metrics.update(opt_metrics)
        if table is not None:
            table = model.fold_spec.emit(table, "app", "loss", "train_step",
                                         "count", 1.0)
        return dict(state, params=params, opt=opt), metrics, table

    return step


@dataclasses.dataclass
class Trainer:
    model: Model
    tcfg: TrainConfig
    ckpt: CheckpointManager
    session: Optional[XFASession] = None
    #: when set, this process registers the run in `profile_dir`'s manifest
    #: and writes a ring of sequence-numbered profile snapshots there
    #: (reduce with `python -m repro_torch.profile report DIR`)
    profile_dir: Optional[str] = None
    #: steps between shard refreshes; 0 -> only the final shard at run end
    profile_interval: int = 0
    #: snapshot-ring retention (profile.RetentionPolicy); None keeps the
    #: store default
    profile_retention: Optional[Any] = None
    #: extra key=value metadata for the run manifest
    profile_meta: Optional[Dict[str, Any]] = None
    #: collector address 'HOST:PORT' — when set (and profile_dir is set),
    #: every shard refresh also streams the ring's unacked entries to the
    #: fleet collector (profile.FleetPublisher).  Publish failures degrade
    #: to local-only rings; they never interrupt the train loop.
    xfa_collector: str = ""
    #: one record per step run: {"step", "step_s" (dispatch + device
    #: sync, host clock), and the step's metrics as floats}
    history: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.session is None:
            self.session = XFASession(device_spec=self.model.fold_spec)
        if self.tcfg.xfa_overhead_budget > 0:
            xfa.TRACER.set_overhead_budget(self.tcfg.xfa_overhead_budget)
        self._profile_store = None
        self._publisher = None
        if self.profile_dir:
            from ..profile import ProfileStore
            self._profile_store = ProfileStore(
                self.profile_dir, retention=self.profile_retention)
            if self.xfa_collector:
                from ..profile import FleetPublisher
                self._publisher = FleetPublisher(self.xfa_collector,
                                                 self.profile_dir)

    def _register_run(self, n_steps: int) -> None:
        if self._profile_store is None:
            return
        from ..profile import register_run
        cfg = self.model.cfg
        register_run(
            self.profile_dir, config=cfg.name, arch=cfg.family,
            label="train-r0", kind="train",
            meta={"n_steps_planned": n_steps,
                  "microbatches": self.tcfg.microbatches,
                  "device": str(self.model.device),
                  **(self.profile_meta or {})})

    def _write_profile_shard(self, step: int) -> None:
        if self._profile_store is None:
            return
        with xfa.scope("runtime", "profile_snapshot"):
            self._profile_store.write_shard(
                self.session.folded_all(), label="train-r0",
                meta={"step": step, "n_steps": self.session.n_steps,
                      "wall_ns": self.session.wall_ns, "rank": 0})
        if self._publisher is not None:
            # local ring first, then stream the delta; a dead collector
            # costs one rate-limited connect attempt, nothing else
            with xfa.scope("runtime", "profile_publish"):
                self._publisher.publish()

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def run(self, seed: int, data: SyntheticLMData, n_steps: int,
            resume: bool = True, state: Optional[Dict] = None
            ) -> Tuple[Dict, Dict[str, float]]:
        """The loop: data -> dispatch -> sync -> ckpt -> profile shard.
        Returns (state, the last step's metrics as floats)."""
        model, tcfg = self.model, self.tcfg
        step_fn = make_train_step(model, tcfg)
        start_step = 0

        if state is None:
            with xfa.scope("runtime", "init_state"):
                state = init_train_state(model, seed, tcfg)
            if resume:
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, extra = self.ckpt.restore(state)
                    start_step = int(extra.get("next_step", latest + 1))

        self._register_run(n_steps)
        table = model.table()
        data.start(at_step=start_step)
        last_metrics: Dict[str, float] = {}
        try:
            for step in range(start_step, n_steps):
                batch = next(data)
                t0 = time.perf_counter_ns()
                with xfa.scope("runtime", "dispatch_step"):
                    state, metrics, table = step_fn(state, batch, table)
                with xfa.scope("runtime", "device_sync", xfa.KIND_WAIT):
                    self._sync()
                dt = time.perf_counter_ns() - t0
                self.session.observe_step(dt)
                if step == start_step:
                    # one step's static costs, as one trace registers them
                    # in the reference (the report scales them by steps)
                    self.session.snapshot_static()

                if tcfg.ckpt_interval and (step + 1) % tcfg.ckpt_interval == 0:
                    self.ckpt.save(step, state, extra={"next_step": step + 1})

                if self.profile_interval and \
                        (step + 1) % self.profile_interval == 0:
                    self._write_profile_shard(step + 1)

                last_metrics = {k: float(v) for k, v in metrics.items()}
                self.history.append(dict(last_metrics, step=step,
                                         step_s=dt / 1e9))
        finally:
            data.stop()
        self.ckpt.wait()
        self.session.finish_device(table)
        self._write_profile_shard(n_steps)
        if self._publisher is not None:
            self._publisher.close()
        return state, last_metrics
