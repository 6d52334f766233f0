"""Continuous-batching serving on the PyTorch port (contiguous cache)."""

from .engine import Request, ServingEngine
from .sampling import GREEDY, PooledSampler, SamplingParams, sample_tokens
from .scheduler import Scheduler, Slot
from .workload import latency_stats, run_workload

__all__ = ["Request", "ServingEngine", "GREEDY", "PooledSampler",
           "SamplingParams", "sample_tokens", "Scheduler", "Slot",
           "latency_stats", "run_workload"]
