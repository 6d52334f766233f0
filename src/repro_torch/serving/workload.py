"""Workload drivers + latency aggregation shared by the serve launcher
and benchmarks.

Two canonical ways to load a serving engine:

  * closed-loop — submit everything up front, drain synchronously: a
    throughput measurement (queue wait is dominated by the backlog).
  * open-loop — Poisson arrivals against the engine's background thread:
    the latency-under-load measurement (TTFT and queue wait reflect an
    arrival process, not a backlog artifact).

Keeping the drive loop and the stats math in ONE place means the
launcher's human summary and the benchmark's CSV can never drift apart.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from .engine import Request, ServingEngine
from .sampling import SamplingParams


def run_workload(engine: ServingEngine, prompts: Sequence[np.ndarray],
                 max_new_tokens: int, mode: str = "closed",
                 rate: float = 4.0, rng: Optional[np.random.Generator] = None,
                 sampling: Optional[SamplingParams] = None) -> List[Request]:
    """Drive `engine` with `prompts` and drain; returns completed requests.

    mode='open' starts the background thread and spaces submissions by
    exponential inter-arrival times (mean 1/rate seconds)."""
    if mode not in ("open", "closed"):
        raise ValueError(f"unknown workload mode {mode!r}")
    if mode == "open":
        rng = rng or np.random.default_rng(0)
        engine.start()
        for p in prompts:
            engine.submit(p, max_new_tokens, sampling=sampling)
            time.sleep(float(rng.exponential(1.0 / max(rate, 1e-6))))
        done = engine.run_until_drained()
        engine.stop()
        return done
    for p in prompts:
        engine.submit(p, max_new_tokens, sampling=sampling)
    return engine.run_until_drained()


def latency_stats(done: Sequence[Request], wall_s: float) -> Dict[str, float]:
    """Aggregate a drained run into the canonical serve metrics (seconds)."""
    tokens = sum(len(r.output) for r in done)
    out: Dict[str, float] = {
        "requests": float(len(done)),
        "tokens": float(tokens),
        "wall_s": wall_s,
        "throughput_tok_s": tokens / wall_s if wall_s > 0 else 0.0,
        "truncated": float(sum(1 for r in done if r.truncated)),
    }
    ttft = [r.ttft_s for r in done if r.ttft_s is not None]
    qw = [r.queue_wait_s for r in done if r.queue_wait_s is not None]
    decode = [(r.finished_at - r.first_token_at) / max(len(r.output) - 1, 1)
              for r in done
              if r.finished_at is not None and r.first_token_at is not None]
    for name, xs in (("ttft", ttft), ("queue_wait", qw)):
        if xs:
            out[f"{name}_mean_s"] = float(np.mean(xs))
            out[f"{name}_p50_s"] = float(np.percentile(xs, 50))
            out[f"{name}_p95_s"] = float(np.percentile(xs, 95))
    if decode:
        out["decode_s_per_tok"] = float(np.mean(decode))
    return out
