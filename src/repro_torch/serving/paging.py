"""Page allocator for the paged KV-cache pool.

The serving cache is a fixed arena of `n_pages` pages of `page_size` rows
(page 0 reserved as scratch — bucket-pad and past-frontier writes resolve
there and are masked on read), plus one block table per slot mapping
virtual page -> arena page.  This module owns the page *accounting*; the
engine owns the tables and the device arrays.

Admission is reservation-based: the scheduler's page gate calls
`try_reserve(uid, pages_needed(rows))` with the request's WORST-CASE row
count (prompt + max_new - 1) before granting a slot, and the engine then
draws pages lazily via `grant` as the slot's frontier crosses page
boundaries.  Because a grant can never exceed its reservation, the free
list cannot underflow mid-flight — admission is the only place that can
say no, which is what makes page exhaustion back-pressure (a queue the
diagnose plane can watch) instead of a mid-decode deadlock.
"""

from __future__ import annotations

import threading
from typing import Dict, List


class PageAllocator:
    """Reservation-then-grant page accounting (thread-safe).

    Physical pages move free -> granted(uid) -> free; reservations are a
    pure counter (committed pages a uid may still draw).  `in_use` counts
    granted pages only — it is the real footprint the
    `serve.cache_pages_in_use` gauge reports; `hwm` is its high-water
    mark, the number a right-sized arena actually needs.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("paged cache needs >= 2 pages "
                             "(page 0 is reserved scratch)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        # page 0 is the scratch page: never granted, so an all-zero block
        # table row means "nothing allocated" and stray writes are inert
        self._free: List[int] = list(range(1, n_pages))
        self._granted: Dict[object, List[int]] = {}
        self._reserved: Dict[object, int] = {}
        self._lock = threading.Lock()
        self.hwm = 0

    # ------------------------------------------------------------ queries --
    @property
    def usable(self) -> int:
        """Pages that can ever be granted (arena minus the scratch page)."""
        return self.n_pages - 1

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.usable - len(self._free)

    def pages_needed(self, rows: int) -> int:
        """Pages covering `rows` cache rows (>= 1 so every slot owns one)."""
        return max(1, -(-int(rows) // self.page_size))

    # ------------------------------------------------------- reservations --
    def try_reserve(self, uid, pages: int) -> bool:
        """Commit `pages` to `uid` if the pool can honour it; False = the
        caller must wait (FCFS back-pressure).  Committed = granted +
        outstanding reservations, so several admits in one scheduling pass
        cannot oversubscribe the arena."""
        with self._lock:
            committed = (self.usable - len(self._free)
                         + sum(self._reserved.values()))
            if committed + pages > self.usable:
                return False
            self._reserved[uid] = self._reserved.get(uid, 0) + int(pages)
            return True

    def cancel(self, uid) -> None:
        """Drop an unused reservation (admission rollback path)."""
        with self._lock:
            self._reserved.pop(uid, None)

    # -------------------------------------------------------------- pages --
    def grant(self, uid, pages: int) -> List[int]:
        """Draw `pages` physical pages against uid's reservation; returns
        the page ids (the engine writes them into the slot's block
        table).  Raises if the reservation is exhausted — that is a
        caller bug (reserve must cover the worst case), not a wait."""
        if pages <= 0:
            return []
        with self._lock:
            held = self._reserved.get(uid, 0)
            if pages > held:
                raise RuntimeError(
                    f"page grant over-draws reservation: uid={uid!r} "
                    f"wants {pages}, holds {held}")
            # reservation accounting guarantees the free list covers this
            got = [self._free.pop() for _ in range(pages)]
            self._reserved[uid] = held - pages
            self._granted.setdefault(uid, []).extend(got)
            self.hwm = max(self.hwm, self.usable - len(self._free))
            return got

    def release(self, uid) -> int:
        """Recycle all of uid's pages and drop any leftover reservation.
        Returns the number of physical pages freed."""
        with self._lock:
            pages = self._granted.pop(uid, [])
            self._free.extend(pages)
            self._reserved.pop(uid, None)
            return len(pages)
