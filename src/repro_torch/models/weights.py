"""Carry weights across from the reference package.

The reference names every param leaf by its path, as
`repro/ckpt/manager.py::_flatten` writes them (`embed/table`,
`lm_head/w`, `final_norm/scale`, `stack/stack/attn/wq`, ...; an MoE
model's `stack_moe/stack/moe/{router,w_gate,w_up,w_down}`,
`stack_moe/stack/moe/shared/*` and `stack_dense/stack/...`; an MLA
model's `stack_*/stack/attn/{wq,wkv_a,wkv_b,wo}`; a vlm's patch
projection `frontend/w`; an enc-dec's `enc_stack/stack/...`,
`dec_stack/stack/{attn,cross/attn,norm1..3,mlp}/...`, `enc_norm/scale`
and `frontend/w`; an xLSTM's `stack_mlstm/stack/...` [n_super, n_m, ...]
and `stack_slstm/stack/...` [n_super, ...]), with layer leaves
stacked [L, ...].  `params_from_numpy` turns such a flat dict into
the port's params; `load_reference_checkpoint` reads a reference
checkpoint directory (`manifest.json` + `<i>.npy`).  A reference TRAIN
STATE (`params/...`, `opt/{master,mu,nu}/...`, `opt/step`) carries across
whole with `train_state_from_numpy` / `load_reference_train_state`.

A bf16 leaf saved by `np.save` reads back in plain numpy as void `|V2`
(numpy has no bfloat16): its bytes are reinterpreted as uint16 and then
as torch.bfloat16.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from .api import FAMILIES
from .layers import Params
from .transformer import leaf_dtype, map_specs

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


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The spec tree of a family's params."""
    return FAMILIES[cfg.family].param_specs(cfg)


def params_from_numpy(flat: Dict[str, Array], cfg: ModelConfig,
                      device: Union[str, torch.device],
                      dtype: Optional[torch.dtype] = None,
                      mesh=None) -> Params:
    """Reference leaf names -> the port's params on `device`, each in
    `dtype` or, by default, in its own dtype: cfg.param_dtype, except the
    leaves the reference keeps in f32 whatever param_dtype is (the
    hybrid's a_log, dt_bias, d_skip).  Every leaf the config needs must
    be present with its exact shape; a missing, extra or mis-shaped leaf
    raises.  With a `mesh`, this rank's slices of the full leaves, as
    `parallel.sharding.layout_tree` places them."""
    if mesh is not None:
        from ..parallel.sharding import layout_tree, shard_tree
        from ..tree import tree_map
        full = params_from_numpy(flat, cfg, "cpu", dtype)
        local = shard_tree(full, mesh, layout_tree(full, mesh, cfg))
        return tree_map(lambda t: t.to(device), local)
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
        return t.to(device=device, dtype=dtype or leaf_dtype(spec, cfg))

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


def train_state_from_numpy(flat: Dict[str, Array], cfg: ModelConfig,
                           device: Union[str, torch.device]
                           ) -> Dict[str, Any]:
    """A reference train state by leaf name -> the port's train state
    {"params", "opt": {"master", "mu", "nu", "step"}} on `device`: params
    in cfg.param_dtype, master and moments in f32, step int32.  A missing
    or unknown leaf raises (an int8 `grad_err` state is not ported)."""
    groups: Dict[str, Dict[str, Array]] = {}
    for name, arr in flat.items():
        for prefix in ("params/", "opt/master/", "opt/mu/", "opt/nu/"):
            if name.startswith(prefix):
                groups.setdefault(prefix, {})[name[len(prefix):]] = arr
                break
        else:
            if name != "opt/step":
                raise KeyError(f"train state has a leaf the port does not "
                               f"hold: {name!r}")
    if "opt/step" not in flat:
        raise KeyError("train state missing leaf 'opt/step'")
    opt = {kind: params_from_numpy(groups.get(f"opt/{kind}/", {}), cfg,
                                   device, torch.float32)
           for kind in ("master", "mu", "nu")}
    opt["step"] = to_tensor(flat["opt/step"]).to(device=device,
                                                 dtype=torch.int32)
    return {"params": params_from_numpy(groups.get("params/", {}), cfg,
                                        device),
            "opt": opt}


def load_reference_train_state(path: str, cfg: ModelConfig,
                               device: Union[str, torch.device]
                               ) -> Dict[str, Any]:
    """A reference checkpoint directory of a train state (a step dir, or
    a root whose newest step is read) -> the port's train state."""
    return train_state_from_numpy(load_reference_checkpoint(path), cfg,
                                  device)
