"""Training: step construction and the run loop, on torch.

The port of `repro/runtime/trainer.py`.  `make_train_step` builds

  (train_state, batch, table) -> (train_state, metrics, table)

with gradient microbatching (accumulation in f32), torch autograd for the
gradients, optional int8 error-feedback gradient compression, the port's
AdamW and the XFA device fold table threaded through (the model's layers
emit into it; the step adds one ("app", "loss", "train_step") count);
`Trainer.run` is the loop: prefetching data, the `runtime/dispatch_step`
and `runtime/device_sync` scopes, periodic (async) checkpoints, resume
from the latest one, and XFA profile shards through the port's
ProfileStore and run manifest.  The table is fetched and folded once, at
the end of the run, so the final shard carries the `device` group, as in
the reference.

PyTorch runs eagerly: there is no compile step, and a step is dispatched
op by op.  With `profile_dir` and `xfa_collector` set, every shard
refresh also streams the ring's unacked entries to a fleet collector.

Under a mesh (`parallel.axes.runtime_mesh`; every family: the MoE
layers run the expert-parallel a2a mode of `models/moe.py`, so an MoE
model's 'model' axis must split its experts) the step is the
reference's SPMD step run by each rank on its part (`TrainLayout`):
- params are held as `parallel.sharding.layout_tree` places them (tensor
  parallel over 'model'); master, mu, nu and the int8 residues are also
  sliced over 'data' by `_apply_fsdp`'s rule when tcfg.zero1 (ZeRO-1);
  the parts of a leaf every model rank holds whole (the hybrid's B and
  C columns) count once in the global gradient norm, and so does a leaf
  held whole;
- each data rank takes its rows of the SAME global batch (of microbatch
  i, the i-th block of the global rows, as the reference's reshape then
  data sharding gives them), so the tokens are the one device's, and the
  loss normalises by the global token count (`transformer.lm_loss`);
- the gradient is summed over 'data' in f32 after each microbatch, or,
  with tcfg.deferred_grad_reduce, once after the microbatch loop on the
  f32 accumulator (`parallel.mesh.collective_counts()` shows which ran);
  the two differ only in the order of sums;
- each rank then compresses (int8) and updates its ZeRO slice, and the
  params are all-gathered over 'data'.
Every rank writes its own profile shard (`train-r{rank}`); the device and
static folds are replicated, and only rank 0 writes them.  The gradient
reduce and the int8 path run in XFA's `grads` component, the AdamW
update and the ZeRO gathers in `optimizer`.  `Trainer.run` records the
collectives of one step (the second it runs, or the only one) with
`parallel.mesh.recording()` and attaches them to its session (XFA's L3
flows; `Trainer.recorded` keeps them and that step's counts).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ckpt.manager import CheckpointManager
from ..configs.base import TrainConfig
from ..core import hlo_flows
from ..core import tracer as xfa
from ..core.device_fold import shard_scale
from ..core.session import XFASession
from ..data.pipeline import SyntheticLMData
from ..models.api import Model
from ..optim import adamw
from ..parallel import mesh as mesh_lib
from ..parallel.axes import get_runtime_mesh, mesh_axes
from ..parallel.sharding import (gather_leaf, gather_tree, layout_tree,
                                 replicated_parts, shard_tree, split_axes,
                                 sub_slice)
from ..tree import leaves_with_path, map_with_path, tree_map


def _check_compression(tcfg: TrainConfig) -> None:
    if tcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression must be none or int8, got "
                         f"{tcfg.grad_compression!r}")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class TrainLayout:
    """Where each leaf of a train state lives under `mesh`: `param`, the
    params' placements; `opt`, those of master, mu, nu and the int8
    residues (ZeRO-1: also over 'data' when zero1).  Built from the full
    params' shapes."""

    def __init__(self, model: Model, full_params, mesh, zero1: bool = True):
        cfg = model.cfg
        if cfg.family == "moe":
            ep = mesh.size("model")
            if ep < 2 or cfg.n_experts % ep:
                raise NotImplementedError(
                    f"training {cfg.name} under a mesh runs the a2a MoE "
                    f"dispatch over the 'model' axis, which must split its "
                    f"{cfg.n_experts} experts (it has {ep} ranks); the "
                    f"dense dispatch over split tokens is not ported "
                    f"(ROADMAP.md §1 item 1)")
        self.mesh = mesh
        self.param = layout_tree(full_params, mesh, cfg)
        self.opt = layout_tree(full_params, mesh, cfg, zero1=zero1)
        self.n_params = sum(x.numel() for _, x in leaves_with_path(
            full_params))
        self.opt_split = tree_map(split_axes, self.opt)
        self.opt_replicated = {
            path: parts for path, parts in leaves_with_path(tree_map(
                lambda s: replicated_parts(s, mesh), self.opt)) if parts}
        self.batch_axes = mesh_axes("batch")
        self.data_size = mesh.size(self.batch_axes)

    def state_specs(self, state) -> Dict[str, Any]:
        """Placements of every leaf of a train state like `state`."""
        out = {"params": self.param,
               "opt": {"master": self.opt, "mu": self.opt, "nu": self.opt,
                       "step": ()}}
        if "grad_err" in state:
            out["grad_err"] = self.opt
        return out

    def shard_state(self, state):
        """A full train state (one device's) -> this rank's slices."""
        return shard_tree(state, self.mesh, self.state_specs(state))

    def gather_state(self, state):
        """This rank's slices -> the full train state (a collective)."""
        return gather_tree(state, self.mesh, self.state_specs(state))

    def zero_views(self, tree):
        """Views of this rank's ZeRO slices of a tree held like params."""
        return map_with_path(lambda _, x, p, o: sub_slice(x, p, o, self.mesh),
                             tree, self.param, self.opt)

    def gather_params(self, params) -> None:
        """After each rank updated its ZeRO slice of every param: the
        whole (tensor-parallel) param on every data rank, in place."""
        def fill(_, x, p, o):
            for d, (a, b) in enumerate(zip(p, o)):
                if a is None and b is not None and self.mesh.size(b) > 1:
                    view = sub_slice(x, p, o, self.mesh)
                    x.copy_(gather_leaf(view, (None,) * d + (b,),
                                        self.mesh))
        map_with_path(fill, params, self.param, self.opt)

    def local_rows(self, batch, n_micro: int):
        """This data rank's rows of the global batch: of each of the
        n_micro microbatches (consecutive blocks of rows), its block."""
        n, i = self.data_size, self.mesh.coord(self.batch_axes)

        def rows(x):
            x = torch.as_tensor(x)
            B = x.shape[0]
            if B % (n_micro * n):
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"{n_micro} microbatches x {n} data ranks")
            per = B // (n_micro * n)
            x = x.reshape((n_micro, n * per) + tuple(x.shape[1:]))
            return x[:, i * per:(i + 1) * per].reshape(
                (n_micro * per,) + tuple(x.shape[2:]))
        return {k: rows(v) for k, v in batch.items()}


def full_shapes(cfg) -> Any:
    """The params' tree at full size, as meta tensors (shapes only)."""
    from ..models.api import FAMILIES
    from ..models.transformer import map_specs
    return map_specs(lambda _, sp: torch.empty(sp[0], device="meta"),
                     FAMILIES[cfg.family].param_specs(cfg))


def init_train_state(model: Model, seed: int, tcfg: TrainConfig,
                     layout: Optional[TrainLayout] = None
                     ) -> Dict[str, Any]:
    """Params from `seed`, a fresh optimizer state (and int8 residues);
    under a layout, this rank's slices of them."""
    _check_compression(tcfg)
    params = model.init(seed)
    owned = params              # the slices whose optimizer state we hold
    if layout is not None:
        params = shard_tree(params, layout.mesh, layout.param)
        owned = layout.zero_views(params)
    state = {"params": params, "opt": adamw.init_state(owned)}
    if tcfg.grad_compression == "int8":
        state["grad_err"] = adamw.init_error_state(owned)
    return state


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


def local_value_and_grad(model: Model, params, batch, table,
                         layout: Optional[TrainLayout] = None):
    """`value_and_grad` of this rank's rows (its gradient not yet summed
    over 'data'); their static costs are registered as the global
    batch's."""
    if layout is None:
        return value_and_grad(model, params, batch, table)
    with shard_scale(layout.data_size):
        return value_and_grad(model, params, batch, table)


def make_train_step(model: Model, tcfg: TrainConfig,
                    layout: Optional[TrainLayout] = None) -> Callable:
    """The step.  Microbatching splits the batch on axis 0 into
    tcfg.microbatches parts and accumulates their gradients in f32, each
    divided by the count, as the reference does; the fold table runs
    through every microbatch.  A `table` of None folds nothing.  Under a
    layout the step takes the GLOBAL batch and runs this rank's part (see
    the module docstring)."""
    _check_compression(tcfg)
    mesh = layout.mesh if layout is not None else None

    @hlo_flows.scoped("grads")
    def reduce(grads):
        # in f32, as the reference's partitioner sums the dw products'
        # f32 accumulators before rounding them to the params' dtype
        return tree_map(lambda g: mesh_lib.all_reduce(
            g.float(), mesh, layout.batch_axes), grads)

    def step(state, batch, table):
        params = state["params"]
        n_micro = tcfg.microbatches
        if layout is not None:
            batch = layout.local_rows(batch, max(n_micro, 1))
        if n_micro <= 1:
            loss, metrics, table, grads = local_value_and_grad(
                model, params, batch, table, layout)
            if layout is not None:
                grads = reduce(grads)
        else:
            rows = len(batch["tokens"]) // n_micro
            grads, loss = None, 0.0
            for i in range(n_micro):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, metrics, table, g = local_value_and_grad(
                    model, params, mb, table, layout)
                if layout is not None and not tcfg.deferred_grad_reduce:
                    g = reduce(g)
                g = tree_map(lambda x: x.float() / n_micro, g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss = loss + l / n_micro
            if layout is not None and tcfg.deferred_grad_reduce:
                grads = reduce(grads)
            metrics["loss"] = loss
        new_state = dict(state)
        split, views, n_params, replicated = None, params, None, None
        if layout is not None:
            grads = layout.zero_views(grads)
            views = layout.zero_views(params)
            split, n_params = layout.opt_split, layout.n_params
            replicated = layout.opt_replicated
        if tcfg.grad_compression == "int8":
            with hlo_flows.component("grads"):
                grads, new_state["grad_err"] = \
                    adamw.compress_grads_with_feedback(
                        grads, state["grad_err"], split, mesh)
        with hlo_flows.component("optimizer"):
            _, opt, opt_metrics = adamw.apply_updates(
                views, state["opt"], grads, tcfg, split=split, mesh=mesh,
                n_params=n_params, replicated=replicated)
            if layout is not None:
                layout.gather_params(params)
        metrics.update(opt_metrics)
        if table is not None:
            table = model.fold_spec.emit(table, "app", "loss", "train_step",
                                         "count", 1.0)
        return dict(new_state, params=params, opt=opt), metrics, table

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
    #: under a mesh, the recorded step: {"step", "flows" (this rank's
    #: CollectiveFlows in call order), "counts" (its collective_counts)}
    recorded: Optional[Dict[str, Any]] = None

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
        mesh = get_runtime_mesh()
        register_run(
            self.profile_dir, config=cfg.name, arch=cfg.family,
            mesh_shape=mesh.shape if mesh is not None else None,
            mesh_axes=mesh.axis_names if mesh is not None else None,
            label=f"train-r{rank()}", kind="train",
            meta={"n_steps_planned": n_steps,
                  "microbatches": self.tcfg.microbatches,
                  "device": str(self.model.device),
                  **(self.profile_meta or {})})

    def _write_profile_shard(self, step: int) -> None:
        if self._profile_store is None:
            return
        # the device and static folds are replicated across the ranks:
        # only rank 0 shards them, or the cross-rank reduce would count
        # them once per rank
        r = rank()
        with xfa.scope("runtime", "profile_snapshot"):
            self._profile_store.write_shard(
                self.session.folded_all(include_replicated=r == 0),
                label=f"train-r{r}",
                meta={"step": step, "n_steps": self.session.n_steps,
                      "wall_ns": self.session.wall_ns, "rank": r})
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
        mesh = get_runtime_mesh()
        layout = (TrainLayout(model, full_shapes(model.cfg), mesh,
                              tcfg.zero1) if mesh is not None else None)
        step_fn = make_train_step(model, tcfg, layout)
        start_step = 0
        where = {}

        if state is None:
            with xfa.scope("runtime", "init_state"):
                state = init_train_state(model, seed, tcfg, layout)
            if layout is not None:
                where = {"specs": layout.state_specs(state), "mesh": mesh}
            if resume:
                latest = self.ckpt.latest_step()
                if latest is not None:
                    state, extra = self.ckpt.restore(state, **where)
                    start_step = int(extra.get("next_step", latest + 1))
        elif layout is not None:
            where = {"specs": layout.state_specs(state), "mesh": mesh}

        self._register_run(n_steps)
        table = model.table()
        data.start(at_step=start_step)
        last_metrics: Dict[str, float] = {}
        # under a mesh: the collectives of one step after the first
        record_at = (min(start_step + 1, n_steps - 1) if mesh is not None
                     else None)
        try:
            for step in range(start_step, n_steps):
                batch = next(data)
                t0 = time.perf_counter_ns()
                if step == record_at:
                    before = mesh_lib.collective_counts()
                with xfa.scope("runtime", "dispatch_step"), \
                        (mesh_lib.recording() if step == record_at
                         else contextlib.nullcontext()) as flows:
                    state, metrics, table = step_fn(state, batch, table)
                if step == record_at:
                    after = mesh_lib.collective_counts()
                    self.recorded = {"step": step, "flows": list(flows),
                                     "counts": {k: after[k] - before[k]
                                                for k in after}}
                    self.session.attach_collectives(flows)
                with xfa.scope("runtime", "device_sync", xfa.KIND_WAIT):
                    self._sync()
                dt = time.perf_counter_ns() - t0
                self.session.observe_step(dt)
                if step == start_step:
                    # one step's static costs, as one trace registers them
                    # in the reference (the report scales them by steps)
                    self.session.snapshot_static()

                if tcfg.ckpt_interval and (step + 1) % tcfg.ckpt_interval == 0:
                    self.ckpt.save(step, state, extra={"next_step": step + 1},
                                   **where)

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
