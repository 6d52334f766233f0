"""Checkpoint manager: atomic, async-capable, restart-friendly.

The reference's on-disk layout (`repro/ckpt/manager.py`), so each side
restores the other's checkpoints.  Per checkpoint:  <dir>/step_<k>/
    manifest.json   step, leaf paths, shapes, dtypes, extra
    <leaf-idx>.npy  one file per leaf, in the reference's leaf order
                    (sorted dict keys, depth first) and names
Written to step_<k>.tmp then renamed, so a crash mid-save never corrupts
the latest checkpoint; `keep_last` old checkpoints are pruned after a
successful save.

Tensors are copied to the host when `save` is called; async mode hands
the host arrays to a writer thread.

Under a mesh (`specs` and `mesh` given: each leaf's placement, as
`parallel.sharding.layout_tree` gives it) a checkpoint still holds FULL
leaves in the reference's layout: `save` gathers every leaf (a
collective: every rank calls it) and rank 0 writes; `restore` reads the
full leaves on every rank and keeps each rank's slice.  So a checkpoint
written on one mesh restores on any other, and on one device.

A bf16 leaf is written as numpy writes an ml_dtypes bfloat16 array
(void `|V2`, manifest dtype "bfloat16"), and read back as
`models/weights.py::to_tensor` reads one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import tracer as xfa
from ..models.weights import to_tensor
from ..parallel.sharding import (gather_tree, global_shape, shard_leaf)
from ..tree import leaves_with_path, map_with_path


def to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype name) of a tensor."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = False) -> None:
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._writer: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    @xfa.api("ckpt", "save")
    def save(self, step: int, tree: Any,
             extra: Optional[Dict[str, Any]] = None, *, specs: Any = None,
             mesh: Any = None) -> str:
        if mesh is not None:
            tree = gather_tree(tree, mesh, specs)
            if mesh.devices.size > 1 and dist.get_rank() != 0:
                return self._path(step)
        host = [(name,) + to_numpy(leaf)
                for name, leaf in leaves_with_path(tree)]
        if self.async_save:
            self.wait()  # one in-flight save at a time
            self._writer = threading.Thread(
                target=self._write, args=(step, host, extra or {}),
                daemon=True, name=f"ckpt-writer-{step}")
            self._writer.start()
            return self._path(step)
        self._write(step, host, extra or {})
        return self._path(step)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, host, extra) -> None:
        try:
            xfa.set_thread_group("ckpt_writers")
            final = self._path(step)
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": [], "extra": extra}
            for i, (name, arr, dtype) in enumerate(host):
                np.save(os.path.join(tmp, f"{i}.npy"), arr)
                manifest["leaves"].append(
                    {"name": name, "file": f"{i}.npy",
                     "shape": list(arr.shape), "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._prune()
        except BaseException as e:  # surfaced on next wait()
            self._last_error = e

    @xfa.wait("ckpt", "wait_async")
    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def _prune(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._path(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    @xfa.api("ckpt", "restore")
    def restore(self, tree_like: Any, step: Optional[int] = None, *,
                specs: Any = None, mesh: Any = None
                ) -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of `tree_like`: every leaf by name,
        with its shape checked, on the like leaf's device and in its
        dtype.  Under a mesh `tree_like` holds this rank's slices: the
        full leaf's shape is checked and the slice kept.  Returns (tree,
        the manifest's extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {e["name"]: e for e in manifest["leaves"]}

        spec_of = dict(leaves_with_path(specs)) if mesh is not None else {}

        def leaf(name, like):
            entry = by_name.get(name)
            if entry is None:
                raise KeyError(f"checkpoint {step} missing leaf {name}")
            arr = np.load(os.path.join(path, entry["file"]))
            spec = spec_of.get(name)
            want = (global_shape(like.shape, spec, mesh) if spec is not None
                    else tuple(like.shape))
            if list(arr.shape) != list(want):
                raise ValueError(f"{name}: ckpt shape {arr.shape} != "
                                 f"{tuple(want)}")
            t = to_tensor(arr, entry.get("dtype", ""))
            if spec is not None:
                t = shard_leaf(t, spec, mesh)
            return t.to(device=like.device, dtype=like.dtype)
        return (map_with_path(leaf, tree_like),
                manifest.get("extra", {}))
