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
second copy of the state.  Gradient compression (`grad_compression=
"int8"`) is not ported: it raises NotImplementedError.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import TrainConfig
from ..core.device_fold import annotate_cost
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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (leaves summed in
    the reference's order)."""
    total = None
    for _, x in leaves_with_path(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, state, grads, cfg: TrainConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics
    {grad_norm, lr})."""
    if cfg.grad_compression != "none":
        raise NotImplementedError(
            f"grad_compression={cfg.grad_compression!r} is not ported yet "
            f"(ROADMAP.md)")
    step = state["step"] + 1
    lr = warmup_cosine(cfg)(step)
    gnorm = global_norm(grads)
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
    n_params = sum(x.numel() for _, x in leaves_with_path(params))
    annotate_cost("optimizer", "optimizer", "adamw",
                  flops=12.0 * n_params, bytes=16.0 * n_params)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
