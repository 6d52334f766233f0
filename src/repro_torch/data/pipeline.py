"""Deterministic synthetic LM data pipeline — host-sharded, prefetching.

A copy of the reference's `repro/data/pipeline.py` (numpy only), so the
port's trainer reads the very batches the reference's does: the same
(seed, step, shard) gives the same tokens on both sides.

Production posture without a corpus: tokens are a splittable counter-based
hash (Philox-like mix of (seed, step, position, shard)), so every host
generates exactly its own shard with no coordination, any step is
reproducible in O(1) (restart-friendly: resume at step k without replaying),
and the stream differs across DP shards.

The pipeline is XFA-instrumented (@xfa.api('data')): per-batch generation
time and the host->device feed boundary both appear in the component view —
the paper's dedup-1 (I/O-bound application) case study is reproduced against
exactly these edges in benchmarks/effectiveness.py.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig
from ..core import tracer as xfa


def _mix(x: np.ndarray) -> np.ndarray:
    """64-bit splitmix-style stateless mix."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


class SyntheticLMData:
    """Iterator of host-local training batches."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, shard: int = 0, n_shards: int = 1,
                 prefetch: int = 2) -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.shard = shard
        self.n_shards = n_shards
        self.step = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- synchronous generation (also used directly by tests) ---------------
    @xfa.api("data", "generate_batch")
    def generate(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        text_s = self.seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
        b, s = self.batch, text_s + 1
        base = (np.uint64(self.seed) << np.uint64(40)) \
            + (np.uint64(step) << np.uint64(20)) \
            + (np.uint64(self.shard) << np.uint64(56))
        idx = np.arange(b * s, dtype=np.uint64) + base
        toks = (_mix(idx) % np.uint64(self.cfg.vocab)).astype(np.int32)
        toks = toks.reshape(b, s)
        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((b, s - 1), np.float32),
        }
        if cfg.family == "vlm":
            fidx = np.arange(b * cfg.n_patches * cfg.frontend_dim,
                             dtype=np.uint64) + base
            batch["patches"] = (
                (_mix(fidx) % np.uint64(2000)).astype(np.float32) / 1000.0
                - 1.0).reshape(b, cfg.n_patches, cfg.frontend_dim)
        if cfg.family == "audio":
            fidx = np.arange(b * self.seq_len * cfg.frontend_dim,
                             dtype=np.uint64) + base + np.uint64(7)
            batch["frames"] = (
                (_mix(fidx) % np.uint64(2000)).astype(np.float32) / 1000.0
                - 1.0).reshape(b, self.seq_len, cfg.frontend_dim)
        return batch

    # -- prefetching iterator ------------------------------------------------
    def _worker(self):
        xfa.set_thread_group("data_workers")
        step = self.step
        while not self._stop.is_set():
            batch = self.generate(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, at_step: int = 0) -> "SyntheticLMData":
        self.step = at_step
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="data-prefetch")
        self._thread.start()
        return self

    @xfa.wait("data", "next_batch")
    def __next__(self) -> Dict[str, np.ndarray]:
        if self._thread is None:
            batch = self.generate(self.step)
            self.step += 1
            return batch
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def make_batch_fn(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0):
    """Stateless batch constructor for a (cfg, shape) cell."""
    data = SyntheticLMData(cfg, shape.global_batch, shape.seq_len, seed=seed)
    return data.generate
