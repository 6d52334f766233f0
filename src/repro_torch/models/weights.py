"""Carry weights across from the reference package.

The reference names every param leaf by its path, as
`repro/ckpt/manager.py::_flatten` writes them (`embed/table`,
`lm_head/w`, `final_norm/scale`, `stack/stack/attn/wq`, ...), with layer
leaves stacked [L, ...].  `params_from_numpy` turns such a flat dict into
the port's params; `load_reference_checkpoint` reads a reference
checkpoint directory (`manifest.json` + `<i>.npy`).

A bf16 leaf saved by `np.save` reads back in plain numpy as void `|V2`
(numpy has no bfloat16): its bytes are reinterpreted as uint16 and then
as torch.bfloat16.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import Params, torch_dtype
from .transformer import map_specs, param_specs

Array = Union[np.ndarray, torch.Tensor]


def to_tensor(arr: Array, dtype_name: str = "") -> torch.Tensor:
    """numpy (incl. bf16 as void |V2 or an ml_dtypes bfloat16) -> CPU
    tensor.  `dtype_name` is the manifest's dtype string when known."""
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if dtype_name == "bfloat16" or arr.dtype.name == "bfloat16" \
            or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        bits = np.array(arr, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def params_from_numpy(flat: Dict[str, Array], cfg: ModelConfig,
                      device: Union[str, torch.device]) -> Params:
    """Reference leaf names -> the port's params on `device`, in
    cfg.param_dtype.  Every leaf the config needs must be present with its
    exact shape; a missing, extra or mis-shaped leaf raises."""
    dtype = torch_dtype(cfg.param_dtype)
    specs = param_specs(cfg)
    need = set()

    def leaf(path, spec):
        need.add(path)
        if path not in flat:
            raise KeyError(f"weights missing leaf {path!r}")
        t = to_tensor(flat[path])
        if tuple(t.shape) != tuple(spec[0]):
            raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                             f"{tuple(spec[0])}")
        return t.to(device=device, dtype=dtype)

    params = map_specs(leaf, specs)
    extra = set(flat) - need
    if extra:
        raise KeyError(f"weights have leaves this config does not use: "
                       f"{sorted(extra)}")
    return params


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference checkpoint: `path` is a step directory holding
    manifest.json, or a checkpoint root whose newest step_* is read.
    Returns {leaf name: CPU tensor} with bf16 leaves as torch.bfloat16
    (names as saved: a train state's params carry a 'params/' prefix)."""
    if not os.path.exists(os.path.join(path, "manifest.json")):
        steps = sorted(n for n in os.listdir(path)
                       if n.startswith("step_") and not n.endswith(".tmp")
                       and os.path.exists(os.path.join(path, n,
                                                       "manifest.json")))
        if not steps:
            raise FileNotFoundError(f"no checkpoint manifest under {path}")
        path = os.path.join(path, steps[-1])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for e in manifest["leaves"]:
        arr = np.load(os.path.join(path, e["file"]), allow_pickle=False)
        t = to_tensor(arr, e.get("dtype", ""))
        if list(t.shape) != list(e["shape"]):
            raise ValueError(f"{e['name']}: file shape {tuple(t.shape)} != "
                             f"manifest {e['shape']}")
        out[e["name"]] = t
    return out
