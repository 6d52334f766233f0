"""build_model(cfg) — the uniform model handle of the port.

    model.init(seed=0)                          -> params on model.device
    model.init_cache(batch, max_len)            -> {"k", "v"} [L,B,Hkv,S,h]
    model.forward_chunk(params, tokens, table, cache, pos[, valid])
                                                -> (logits, cache, table)
        THE serving entry point: tokens [B, T] written at per-slot cache
        offsets pos [B] int32, offset-causal against existing cache
        content; valid [B] masks a bucket-padded chunk.  The cache is
        updated in place and returned.
    model.prefill(params, batch, table, cache)  -> (logits, cache, table)
    model.decode_step(params, tok, table, cache, pos)
    model.table()                               -> None (device fold not
                                                   ported yet)

Only family="dense" is ported; the other families raise
NotImplementedError (and the engine refuses max_cache_pages > 0: the
paged entry points are not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from ..configs.base import ModelConfig
from ..kernels.ops import IMPLS
from . import transformer
from .layers import Runtime


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rt: Runtime
    init: Callable
    init_cache: Callable
    forward_chunk: Callable
    prefill: Callable
    decode_step: Callable

    @property
    def device(self) -> torch.device:
        return self.rt.device

    def table(self):
        return None


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means `cuda`.  A CUDA device without CUDA raises: the port
    never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_model(cfg: ModelConfig, impl: str = "auto",
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """impl: 'auto' (kernels on CUDA, plain versions on the CPU),
    'kernel' or 'ref'; device: None means cuda."""
    cfg = cfg.validate()
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet (dense "
            f"only; see ROADMAP.md)")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    rt = Runtime(cfg=cfg, device=resolve_device(device), impl=impl)

    def init(seed: int = 0):
        return transformer.init_params(cfg, seed, rt.device)

    def init_cache(batch, max_len):
        return transformer.init_cache(cfg, batch, max_len, rt.device)

    def forward_chunk(params, tokens, table, cache, pos, valid=None):
        return transformer.forward_chunk(params, tokens, rt, table, cache,
                                         pos, valid=valid)

    def prefill(params, batch, table, cache):
        tokens = torch.as_tensor(batch["tokens"], device=rt.device)
        return transformer.prefill(params, tokens, rt, table, cache)

    def decode_step(params, token, table, cache, pos):
        return transformer.decode_step(params, token, rt, table, cache, pos)

    return Model(cfg=cfg, rt=rt, init=init, init_cache=init_cache,
                 forward_chunk=forward_chunk, prefill=prefill,
                 decode_step=decode_step)
