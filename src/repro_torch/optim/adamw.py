"""AdamW with mixed-precision master weights, global-norm clipping, decay
masking and a warmup-cosine schedule, on torch tensors.

The port of `repro/optim/adamw.py` (not `torch.optim.AdamW`): the same
state layout and the same arithmetic, leaf by leaf in f32.

State layout (nested dicts mirroring params):
  master  f32 master copy of the (possibly bf16) params
  mu, nu  f32 first/second moments
  step    int32 scalar tensor

The reference is functional; here `apply_updates` updates master, mu, nu
and the params IN PLACE (it returns the same tensors), so a step holds no
second copy of the state.

Under a mesh (`runtime/trainer.py`) every leaf here may be one rank's
slice of the global leaf: `split` names, per leaf, the mesh axes it is
split over (`parallel.sharding.split_axes`).  `global_norm` then sums
each leaf's squares across its slices before the root, and the int8
compression takes each leaf's amax over the whole leaf (a max across
its slices), so both equal the reference's single program's.  A part
of a slice that every rank of a split axis holds whole (`replicated`:
the hybrid's B and C columns, `parallel.sharding.replicated_parts`)
counts once in the norm.  ZeRO-1 needs nothing more: the update is
elementwise, and a rank updates the slice of master, mu and nu it holds.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import TrainConfig
from ..core.device_fold import annotate_cost
from ..parallel import mesh as mesh_lib
from ..tree import leaves_with_path, map_with_path, tree_map


def warmup_cosine(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> learning rate (f32 tensor): linear warmup to
    cfg.learning_rate, then a cosine decay to a tenth of it."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / max(cfg.warmup_steps, 1)
        prog = (step - cfg.warmup_steps) / max(
            cfg.total_steps - cfg.warmup_steps, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        lr = torch.where(step < cfg.warmup_steps, warm, 0.1 + 0.9 * cos)
        return cfg.learning_rate * lr
    return schedule


def _decay_mask(path: str) -> float:
    """No weight decay on norms / scalars / biases (1-D leaves)."""
    for token in ("norm", "scale", "bias", "a_log", "dt_bias", "d_skip",
                  "skip"):
        if token in path:
            return 0.0
    return 1.0


def init_state(params) -> Dict[str, Any]:
    """f32 master (a distinct copy even for f32 params), zero moments,
    step 0."""
    def f32(x):
        return x.detach().to(torch.float32, copy=True)

    def zeros(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    some = leaves_with_path(params)[0][1]
    return {"master": tree_map(f32, params), "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def _by_split(tree, split, mesh):
    """{axes: [(path, leaf)]}: the leaves grouped by the mesh axes (of
    extent > 1) that split them; one group () without a mesh."""
    groups: Dict[Tuple[str, ...], list] = {}
    splits = dict(leaves_with_path(split)) if split is not None else {}
    for path, x in leaves_with_path(tree):
        axes = tuple(sorted(a for a in splits.get(path, ())
                            if mesh is not None and mesh.size(a) > 1))
        groups.setdefault(axes, []).append((path, x))
    return groups


def global_norm(tree, split=None, mesh=None, replicated=None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (leaves summed in
    the reference's order).  With `split` (per leaf, the mesh axes it is
    split over) the squares of each group of leaves split alike are
    summed over their axes first: one all-reduce a group.  `replicated`
    {path: [(dim, start, length, n)]}: parts of a leaf held whole on the
    n ranks of one of its axes, whose squares count 1/n a rank."""
    total = None
    replicated = replicated or {}
    for axes, items in _by_split(tree, split, mesh).items():
        part = None
        for path, x in items:
            sq = torch.sum(torch.square(x.float()))
            for dim, start, length, n in replicated.get(path, ()):
                sq = sq - (1 - 1 / n) * torch.sum(torch.square(
                    x.narrow(dim, start, length).float()))
            part = sq if part is None else part + sq
        part = mesh_lib.all_reduce(part, mesh, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, state, grads, cfg: TrainConfig, *, split=None,
                  mesh=None, n_params: Optional[int] = None,
                  replicated=None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics
    {grad_norm, lr}).  Under a mesh the leaves are this rank's slices,
    `split` their axes and `replicated` their parts held whole (see
    `global_norm`), and `n_params` the global count of the static
    cost."""
    step = state["step"] + 1
    lr = warmup_cosine(cfg)(step)
    gnorm = global_norm(grads, split, mesh, replicated)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    stepf = step.to(torch.float32)
    # torch.full, not torch.tensor: no host-to-device copy, no stream wait
    bc1 = 1.0 - torch.pow(torch.full((), b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.full((), b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(path, g, mu, nu, master, p):
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        mask = _decay_mask(path)
        if mask:
            delta = delta + cfg.weight_decay * mask * master
        master.sub_(lr * delta)
        p.copy_(master)
    map_with_path(upd, grads, state["mu"], state["nu"], state["master"],
                  params)
    if n_params is None:
        n_params = sum(x.numel() for _, x in leaves_with_path(params))
    annotate_cost("optimizer", "optimizer", "adamw",
                  flops=12.0 * n_params, bytes=16.0 * n_params)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Gradient compression (int8 with error feedback), as the reference's: an
# in-graph quantize-dequantize of the reduced gradient, the residue fed
# back into the next step's gradient.
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): q = round(x / scale) in [-127, 127], scale =
    (max |x| + 1e-12) / 127; `amax` overrides max |x| (the max over a
    leaf's slices on other ranks)."""
    amax = (torch.max(torch.abs(x)) if amax is None else amax) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads_with_feedback(grads, error_state, split=None, mesh=None):
    """Error-feedback int8 compression: g' = Q(g + e); e' = (g + e) - g'.
    Returns (g' in each gradient's dtype, e' in f32).  Under a mesh each
    leaf's amax is the max over all its slices: one all-reduce (max) for
    each group of leaves split alike."""
    gf = map_with_path(lambda _, g, e: g.float() + e, grads, error_state)
    amax = {}
    for axes, items in _by_split(gf, split, mesh).items():
        local = torch.stack([torch.max(torch.abs(x)) for _, x in items])
        local = mesh_lib.all_reduce(local, mesh, axes, op="max")
        amax.update((path, local[i]) for i, (path, _) in enumerate(items))

    out = {path: dequantize_int8(*quantize_int8(x, amax[path]))
           for path, x in leaves_with_path(gf)}
    new_grads = map_with_path(lambda path, g: out[path].to(g.dtype), grads)
    new_err = map_with_path(lambda path, x: x - out[path], gf)
    return new_grads, new_err


def init_error_state(params):
    """Zero f32 residues, one per param leaf."""
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), params)
