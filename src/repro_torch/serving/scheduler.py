"""Slot admission + chunked-prefill budgeting for the serving engine.

The scheduler owns the WAITING side of continuous batching: the FCFS
queue of submitted requests, the fixed slot pool's occupancy bookkeeping
(which request holds which cache row, at what depth, with how much
prompt left to feed), and the per-tick prefill plan.

Admission is iteration-level (vLLM-style): any tick with free slots may
admit, bounded by a chunked-prefill token budget so a burst of long
prompts cannot stall slots that are already decoding (Sarathi-style
prefill/decode interference control).  Prefill is IN-MODEL chunked: the
admission chunk and every continuation chunk of a longer prompt's tail
run through the same positioned `forward_chunk` step at the slot's cache
offset, up to `prefill_chunk` (continuations: `tail_chunk`) tokens per
step — one code path from first prompt token to pooled decode.

Fairness: strict FCFS.  Continuation chunks belong to requests admitted
BEFORE anything still waiting, so each tick plans continuations first
(oldest admission first), then admissions with whatever budget remains.
The budget never reorders the queue, and the first prefill step of a
tick always fits, so one huge prompt is delayed (by the budget) but
never starved — and neither is a long tail mid-prefill.

Batched prefill plan: once a tick's chunks are SELECTED (continuations
then admissions, under the budget), `batched_prefill_plan` groups them
by compiled chunk width into at most `prefill_batch`-row groups — each
group one multi-row `forward_chunk` call in the engine.  Grouping only
changes HOW the selected chunks execute, never WHO was selected, so the
FCFS/budget guarantees above are untouched by batching.  The scheduler
also owns the compiled-shape discipline: chunk widths and group batch
dims both round to power-of-two buckets (`chunk_width`, `batch_bucket`),
keeping the engine's program set O(log batch x log seq_len).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from ..configs.base import ServeConfig


@dataclasses.dataclass
class Slot:
    """One row of the batched cache pool."""
    request: Optional[object] = None   # serving.engine.Request (duck-typed)
    pos: int = 0                       # next cache position to write
    pending: Deque[int] = dataclasses.field(default_factory=deque)
    seq: int = 0                       # admission order (continuation FCFS)
    stash: Any = None                  # batch=1 cache pytree while prefilling

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def prefilling(self) -> bool:
        """Still owed prompt chunks (not yet in the pooled decode)."""
        return self.request is not None and bool(self.pending)


class Scheduler:
    """Iteration-level admission + chunk planning over a fixed slot pool."""

    def __init__(self, scfg: ServeConfig) -> None:
        self.scfg = scfg
        self.waiting: Deque = deque()
        self.slots: List[Slot] = [Slot() for _ in range(scfg.max_batch)]
        self._admit_seq = 0
        # paged-cache admission gate: callable(req) -> bool, set by the
        # engine when the pool is paged.  True = the pool RESERVED the
        # request's worst-case pages (the gate has side effects — the
        # engine must consume or cancel the reservation); False = not
        # enough free pages, and because admission is strict FCFS the
        # whole queue waits behind its head rather than letting a short
        # request jump a long one (no out-of-order admission, no
        # starvation).  None = slot count is the only admission resource.
        self.page_gate = None

    # -- queue side ---------------------------------------------------------
    def add(self, req) -> None:
        self.waiting.append(req)

    def has_waiting(self) -> bool:
        return bool(self.waiting)

    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.active())

    # -- pool side ----------------------------------------------------------
    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.request is not None]

    def decoding(self) -> List[int]:
        """Slots past prefill: they join the pooled decode tick."""
        return [i for i, s in enumerate(self.slots)
                if s.request is not None and not s.pending]

    def prefilling_slots(self) -> List[int]:
        """Slots owed continuation chunks, oldest admission first."""
        out = [i for i, s in enumerate(self.slots) if s.prefilling]
        return sorted(out, key=lambda i: self.slots[i].seq)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def admit_cost(self, req) -> int:
        """Prefill tokens the ADMISSION chunk will actually consume —
        after the engine's truncation to fit the cache row (charging the
        raw prompt length would overbill truncated requests and block
        cheap neighbours for no real work)."""
        limit = self.scfg.max_seq_len \
            - getattr(req, "max_new_tokens", 0) - 1
        plen = min(len(req.prompt), max(limit, 1))
        chunk = self.scfg.prefill_chunk or plen
        return max(1, min(plen, chunk))

    @property
    def tail_chunk(self) -> int:
        """Continuation chunk width (tokens per forward_chunk step)."""
        return self.scfg.tail_chunk or self.scfg.prefill_chunk or 1

    # -- compiled-shape discipline ------------------------------------------
    def chunk_width(self, n: int, pos: int) -> int:
        """Compiled width for a chunk of <= n tokens starting at cache
        offset `pos`: the next power-of-two bucket (>= min_chunk_bucket),
        bucketed DOWN while a padded write would run past the row end (a
        clamped scatter would shift garbage onto valid entries).  May
        return less than n — the caller then consumes fewer tokens and
        leaves the rest pending, keeping every width a power of two: the
        compiled-program set stays O(log) even for non-power-of-two
        max_seq_len rows."""
        scfg = self.scfg
        if not scfg.bucket_chunks:
            return n
        w = max(scfg.min_chunk_bucket, 1)
        while w < n:
            w *= 2
        room = scfg.max_seq_len - pos          # >= n: the engine clamps
        while w > room and w > 1:
            w //= 2
        return w

    def batch_bucket(self, rows: int) -> int:
        """Compiled batch dimension for a `rows`-row prefill group: the
        next power of two (pad rows masked via `valid`) under bucketing,
        exact otherwise — with widths also bucketed, group shapes come
        from an O(log prefill_batch x log max_seq_len) set."""
        if not self.scfg.bucket_chunks:
            return rows
        b = 1
        while b < rows:
            b *= 2
        return b

    @property
    def prefill_batch(self) -> int:
        """Effective rows-per-group cap (never more than the pool)."""
        return max(1, min(self.scfg.prefill_batch, self.scfg.max_batch))

    def batched_prefill_plan(self, items: List[Tuple[int, int]]
                             ) -> List[Tuple[List[int], List[int], int]]:
        """Group this tick's SELECTED prefill chunks [(slot_idx, n)] —
        continuations first, then admissions, exactly as the budget
        picked them — into (slot_indices, n_tokens, width) groups of at
        most `prefill_batch` same-width rows: each group is ONE
        multi-row forward_chunk call.  Selection already enforced FCFS
        and the token budget; grouping only changes how the chunks run,
        never who runs, so an older mid-prefill slot can never be
        displaced by a batch of younger admissions.  An item's width may
        bucket DOWN near its row end (it then consumes min(n, width)
        tokens); items group by that final width."""
        cap = self.prefill_batch
        groups: List[Tuple[List[int], List[int], int]] = []
        open_group = {}                # width -> index of its open group
        for idx, n in items:
            slot = self.slots[idx]
            w = self.chunk_width(min(n, len(slot.pending)), slot.pos)
            n = min(n, w)
            g = open_group.get(w)
            if g is None or len(groups[g][0]) >= cap:
                open_group[w] = len(groups)
                groups.append(([idx], [n], w))
            else:
                groups[g][0].append(idx)
                groups[g][1].append(n)
        return groups

    def continuation_plan(self) -> Tuple[List[Tuple[int, int]], bool]:
        """((slot_idx, n_tokens) continuation chunks for this tick,
        deferred?): every mid-prefill slot advances by up to `tail_chunk`
        tokens, oldest admission first, under the per-tick prefill token
        budget.  The first chunk of the tick always fits (a long tail can
        be slowed by the budget, never starved); an oversized chunk is
        skipped, not a barrier, so smaller chunks of LATER-admitted
        (but still older-than-any-waiting) slots may consume the
        leftover.  `deferred` reports whether any mid-prefill slot got
        nothing — admissions must then wait a tick (every mid-prefill
        request predates everything in the waiting queue)."""
        budget = self.scfg.prefill_budget_tokens
        out: List[Tuple[int, int]] = []
        spent = 0
        deferred = False
        for idx in self.prefilling_slots():
            n = min(len(self.slots[idx].pending), self.tail_chunk)
            if out and budget and spent + n > budget:
                deferred = True
                continue
            out.append((idx, n))
            spent += n
        return out, deferred

    def schedule(self, spent: int = 0) -> List[Tuple[int, object]]:
        """Admissions for this tick: FCFS into free slots under the
        prefill token budget.  `spent` is what this tick's continuation
        chunks already consumed — waiting requests arrived after every
        mid-prefill request, so they only see the leftover budget.  The
        first prefill step of a tick (spent == 0, nothing admitted yet)
        always fits regardless of cost (no starvation of long prompts)."""
        budget = self.scfg.prefill_budget_tokens
        out: List[Tuple[int, object]] = []
        free = self.free_slots()
        while free and self.waiting:
            cost = self.admit_cost(self.waiting[0])
            if (out or spent) and budget and spent + cost > budget:
                break
            if self.page_gate is not None \
                    and not self.page_gate(self.waiting[0]):
                break                      # page back-pressure: FCFS waits
            out.append((free.pop(0), self.waiting.popleft()))
            spent += cost
        return out

    def bind(self, idx: int, req, pos: int, pending, stash: Any = None
             ) -> None:
        """Occupy slot `idx`: cache holds `pos` tokens, `pending` is the
        not-yet-prefilled prompt remainder (fed through forward_chunk
        steps), `stash` the batch=1 cache being filled until the prompt
        completes and scatters into the pool."""
        self._admit_seq += 1
        self.slots[idx] = Slot(request=req, pos=pos, pending=deque(pending),
                               seq=self._admit_seq, stash=stash)

    def release(self, idx: int) -> None:
        self.slots[idx] = Slot()

    def pos_vector(self) -> np.ndarray:
        """[max_batch] int32 per-slot cache depths (free slots at 0)."""
        return np.asarray([s.pos for s in self.slots], np.int32)
