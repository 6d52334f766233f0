"""build_model(cfg) — the uniform model handle of the port.

    model.init(seed=0)                          -> params on model.device
    model.loss_fn(params, batch, table)         -> (loss, (metrics, table))
        causal LM loss over batch tokens/labels/mask [B, S] (numpy or
        tensors; the vlm's also patches); differentiable by torch
        autograd (the kernels carry their own backward passes)
    model.batch_spec(shape)                     -> {name: (shape, dtype)}
        of a training batch for a ShapeConfig (the vlm's: tokens,
        labels, mask [B, S - n_patches] and patches [B, n_patches,
        frontend_dim] f32)
    model.init_cache(batch, max_len[, src_len]) -> the serving cache:
        dense {"k", "v"} [L,B,Hkv,S,h]; MLA {"ckv" [L,B,S,r], "krope"
        [L,B,S,dr]}; hybrid {"ssm": {"conv", "h"}, "attn_k", "attn_v"};
        audio {"k", "v", "xk", "xv"} (the cross K/V [L,B,Hkv,src_len or
        max_len,h]); ssm {"mlstm": {"C", "n", "m"}, "slstm": {"c", "n",
        "m", "h"}} (O(1) in max_len) (batch axis 1 in every leaf)
    model.forward_chunk(params, tokens, table, cache, pos[, valid,
                        prefix_embeds, frames]) -> (logits, cache, table)
        THE serving entry point: tokens [B, T] written at per-slot cache
        offsets pos [B] int32, offset-causal against existing cache
        content; valid [B] masks a bucket-padded chunk.  The cache is
        updated in place and returned.  The enc-dec's frames [B, S_src,
        frontend_dim] (the first chunk of fresh rows) are encoded and
        written into the cross cache; later chunks read it.
    model.prefill(params, batch, table, cache)  -> (logits, cache, table)
        = forward_chunk at pos 0 over batch["tokens"]; the vlm's prefill
        projects batch["patches"] [B, P, frontend_dim] and writes them
        before the tokens, so the cache then holds P + T rows a row; the
        enc-dec's encodes batch["frames"]
    model.project_patches(params, patches)      -> [B, P, d] (vlm; None
        elsewhere): the prefix embeddings that forward_chunk and
        forward_chunk_paged take as prefix_embeds=
    model.decode_step(params, tok, table, cache, pos)
    model.init_paged_cache(pages, page_size)    -> {"k", "v"}
                                                   [L,P,Hkv,page_size,h]
                                                   (MLA: {"ckv", "krope"}
                                                   [L,P,page_size,r|dr])
    model.forward_chunk_paged(params, tokens, table, cache, pos,
                              block_table[, valid, prefix_embeds])
    model.decode_step_paged(params, tok, table, cache, pos, block_table)
        the same steps against a page arena: block_table [B, NB] int32
        maps row b's virtual page i to arena page block_table[b, i]
        (page 0 is reserved scratch); the engine's paged pool
        (ServeConfig.max_cache_pages > 0) runs through these.  None for
        the hybrid, ssm and audio families, as in the reference, which
        pages the transformer families only: the hybrid's and ssm's
        recurrent state is O(1) in sequence length, and the engine keeps
        the dense layout.
    model.table()                               -> the zeroed device fold
                                                   table on model.device
    model.fold_spec                             -> the frozen
                                                   DeviceFoldSpec whose
                                                   slots the family emits

Every family is ported, serving and training: "dense", "moe" (with or
without multi-head latent attention), "hybrid", "vlm" (the dense stack
behind a patch projection), "audio" (the encoder-decoder, `encdec.py`)
and "ssm" (xLSTM, `xlstm.py`).  MLA serves through its latent kernels at
head dim r + dr (576) and trains through the flash pair at q/k head dim
dn + dr (192) and v head dim dv (128).  The serving engine's clients send
token prompts only, in both packages: the vlm serves its patches through
prefill or forward_chunk(prefix_embeds=...), the enc-dec its frames
through prefill or forward_chunk(frames=...).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.device_fold import DeviceFoldSpec
from ..kernels.ops import IMPLS
from . import encdec, mamba, transformer, xlstm
from .layers import Runtime


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rt: Runtime
    fold_spec: DeviceFoldSpec
    init: Callable
    loss_fn: Callable
    init_cache: Callable
    forward_chunk: Callable
    prefill: Callable
    decode_step: Callable
    init_paged_cache: Optional[Callable]
    forward_chunk_paged: Optional[Callable]
    decode_step_paged: Optional[Callable]
    project_patches: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return self.rt.device

    def table(self) -> torch.Tensor:
        return self.fold_spec.init_table(self.device)

    def batch_spec(self, shape: ShapeConfig
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of each entry of a training batch."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        text_s = S - cfg.n_patches if cfg.family == "vlm" else S
        spec = {"tokens": ((B, text_s), torch.int32),
                "labels": ((B, text_s), torch.int32),
                "mask": ((B, text_s), torch.float32)}
        if cfg.family == "vlm":
            spec["patches"] = ((B, cfg.n_patches, cfg.frontend_dim),
                               torch.float32)
        if cfg.family == "audio":
            spec["frames"] = ((B, S, cfg.frontend_dim), torch.float32)
        return spec


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


def _fold_spec(cfg: ModelConfig, declare) -> DeviceFoldSpec:
    spec = DeviceFoldSpec()
    declare(spec, cfg)
    return spec.freeze()


#: the module of each family
FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "hybrid": mamba, "ssm": xlstm, "audio": encdec}


def build_model(cfg: ModelConfig, impl: str = "auto",
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """impl: 'auto' (kernels on CUDA, plain versions on the CPU),
    'kernel' or 'ref'; device: None means cuda."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    cfg = cfg.validate()
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    mod = FAMILIES[cfg.family]
    spec = _fold_spec(cfg, mod.declare_fold_slots)
    rt = Runtime(cfg=cfg, device=resolve_device(device), impl=impl,
                 fold_spec=spec)

    def init(seed: int = 0):
        return mod.init_params(cfg, seed, rt.device)

    def loss_fn(params, batch, table):
        return mod.loss_fn(params, batch, rt, table)

    def init_cache(batch, max_len, **extra):
        return mod.init_cache(cfg, batch, max_len, rt.device, **extra)

    vlm = cfg.family == "vlm"

    def forward_chunk(params, tokens, table, cache, pos, valid=None,
                      prefix_embeds=None, frames=None):
        extra = {} if prefix_embeds is None else {
            "prefix_embeds": prefix_embeds}
        if frames is not None:
            extra["frames"] = frames
        return mod.forward_chunk(params, tokens, rt, table, cache, pos,
                                 valid=valid, **extra)

    def project_patches(params, patches):
        return transformer._project_patches(params, patches, rt)

    def prefill(params, batch, table, cache):
        tokens = torch.as_tensor(batch["tokens"], device=rt.device)
        if vlm:
            return mod.prefill(params, tokens, rt, table, cache,
                               project_patches(params, batch["patches"]))
        extra = {"frames": batch["frames"]} if "frames" in batch else {}
        return mod.prefill(params, tokens, rt, table, cache, **extra)

    def decode_step(params, token, table, cache, pos):
        return mod.decode_step(params, token, rt, table, cache, pos)

    paged: Dict[str, Optional[Callable]] = dict.fromkeys(
        ("init_paged_cache", "forward_chunk_paged", "decode_step_paged"))
    if mod is transformer:
        def init_paged_cache(pages, page_size):
            return transformer.init_paged_cache(cfg, pages, page_size,
                                                rt.device)

        def forward_chunk_paged(params, tokens, table, cache, pos,
                                block_table, valid=None, prefix_embeds=None):
            return transformer.forward_chunk_paged(
                params, tokens, rt, table, cache, pos, block_table,
                valid=valid, prefix_embeds=prefix_embeds)

        def decode_step_paged(params, token, table, cache, pos, block_table):
            return transformer.decode_step_paged(params, token, rt, table,
                                                 cache, pos, block_table)

        paged = {"init_paged_cache": init_paged_cache,
                 "forward_chunk_paged": forward_chunk_paged,
                 "decode_step_paged": decode_step_paged}

    return Model(cfg=cfg, rt=rt, fold_spec=spec, init=init, loss_fn=loss_fn,
                 init_cache=init_cache, forward_chunk=forward_chunk,
                 prefill=prefill, decode_step=decode_step,
                 project_patches=project_patches if vlm else None, **paged)
