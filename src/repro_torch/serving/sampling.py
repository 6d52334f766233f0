"""Pooled per-slot sampling — greedy / temperature / top-k / top-p.

Per-REQUEST sampling params live as per-SLOT vectors, so one sampler call
covers the whole pool every tick whichever requests occupy which slots.
Logits stay on the device; only the chosen token ids cross to the host.

Determinism: a sampled token is a pure function of (request seed,
absolute context length).  The noise is a counter-based hash of (seed,
step, vocab index) turned into Gumbel noise, so a request's continuation
is identical whether it decodes alone, batched with arbitrary
neighbours, or with its prompt chunked differently.  The reference draws
its bits from `jax.random`, which PyTorch cannot reproduce: greedy output
is token-identical to the reference engine, sampled output keeps the
same properties with other bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding strategy (all combinable; greedy by default)."""
    temperature: float = 0.0         # 0 -> greedy (argmax)
    top_k: int = 0                   # 0 -> full vocab
    top_p: float = 1.0               # nucleus mass; 1.0 -> no nucleus cut
    seed: int = 0                    # noise stream for this request


GREEDY = SamplingParams()


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 lanes holding uint32 values, in halves so
    no product leaves int64."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 lanes holding uint32 values."""
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_noise(seed: torch.Tensor, step: torch.Tensor, vocab: int
                  ) -> torch.Tensor:
    """[B, V] uniforms in (0, 1), each a pure function of (seed[b],
    step[b], vocab index)."""
    s = _mix32(_mul32(seed.long() & _MASK32, 0x9E3779B1))
    s = _mix32(s ^ _mul32(step.long() & _MASK32, 0x85EBCA77))
    idx = torch.arange(vocab, device=seed.device, dtype=torch.int64)
    x = _mix32(s[:, None] ^ _mul32(idx, 0xC2B2AE3D)[None, :])
    return ((x >> 8).float() + 0.5) / float(1 << 24)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seed: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Sample one token per pool row.  logits: [B, V]; params [B] on the
    logits' device.  Rows with temperature <= 0 take the argmax."""
    B, V = logits.shape
    lf = logits.float()
    greedy = torch.argmax(lf, dim=-1)
    lg = lf / torch.clamp(temperature, min=1e-6)[:, None]
    # top-k: drop logits below each row's k-th largest (k = 0 keeps all)
    srt = torch.sort(lg, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, V).long()
    kth = torch.gather(srt, 1, (k - 1)[:, None])
    lg = torch.where(lg < kth, NEG_INF, lg)
    # top-p nucleus on the post-top-k distribution; the top token always
    # survives, so top_p -> 0 degenerates to greedy, never empty support
    probs = torch.softmax(lg, dim=-1)
    ps = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(ps, dim=-1)
    keep = (cum - ps) < top_p[:, None]               # exclusive-cum mass
    keep[:, 0] = True
    thresh = torch.where(keep, ps, torch.inf).amin(dim=-1)
    lg = torch.where(probs < thresh[:, None], NEG_INF, lg)
    gumbel = -torch.log(-torch.log(uniform_noise(seed, step, V)))
    sampled = torch.argmax(lg + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


class PooledSampler:
    """Host-side mirror of per-slot sampling state + the pooled sampler.

    bind/release keep [B] param vectors in step with slot occupancy;
    __call__ runs the whole pool through one sample_tokens call (or one
    argmax when every slot is greedy)."""

    def __init__(self, max_batch: int) -> None:
        self.max_batch = max_batch
        self.temperature = np.zeros((max_batch,), np.float32)
        self.top_k = np.zeros((max_batch,), np.int32)
        self.top_p = np.ones((max_batch,), np.float32)
        self.seed = np.zeros((max_batch,), np.uint32)

    def bind(self, i: int, sp: SamplingParams) -> None:
        self.temperature[i] = sp.temperature
        self.top_k[i] = sp.top_k
        self.top_p[i] = sp.top_p
        self.seed[i] = np.uint32(sp.seed)

    def release(self, i: int) -> None:
        self.bind(i, GREEDY)

    @staticmethod
    def _run(logits: torch.Tensor, temperature, top_k, top_p, seed, step
             ) -> np.ndarray:
        if not np.any(temperature > 0):
            return torch.argmax(logits, dim=-1).cpu().numpy()
        dev = logits.device
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        out = sample_tokens(logits, t(temperature, torch.float32),
                            t(top_k, torch.int64), t(top_p, torch.float32),
                            t(np.asarray(seed, np.int64), torch.int64),
                            t(np.asarray(step, np.int64), torch.int64))
        return out.cpu().numpy()

    def __call__(self, logits: torch.Tensor, step) -> np.ndarray:
        """logits: [B, V]; step: [B] context length per row -> tokens [B]."""
        return self._run(logits, self.temperature, self.top_k, self.top_p,
                         self.seed, step)

    def sample_one(self, logits_row: torch.Tensor, sp: SamplingParams,
                   step: int) -> int:
        """Single-sequence sampling (prefill's first token) through the
        SAME semantics as the pooled path."""
        out = self._run(logits_row[None],
                        np.full((1,), sp.temperature, np.float32),
                        np.full((1,), sp.top_k, np.int32),
                        np.full((1,), sp.top_p, np.float32),
                        np.full((1,), np.uint32(sp.seed)),
                        np.full((1,), step, np.int64))
        return int(out[0])
