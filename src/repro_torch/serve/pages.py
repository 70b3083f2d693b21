"""Paged KV cache: global page pools, host free-list allocator, page tables
(port of ``repro/serve/pages.py``, one pool per engine).

**Page pool**: one ``(L, num_pages + 1, page_size, Hkv, Dh)`` tensor per K
and V on the device. Page ``num_pages`` is the trash page: writes for
padded prefill tokens and inactive batch rows go there, so every step
writes unconditionally and garbage never lands in a live page.

**Page table**: ``(max_batch, max_pages_per_row)`` int32, host-owned
(numpy) and uploaded per step. Entry ``j`` of row ``b`` names the page
holding that row's positions ``[j * page_size, (j+1) * page_size)``;
unallocated entries point at the trash page, and a per-row length is the
only validity signal attention needs.

**Allocator**: a host-side free list with per-owner bookkeeping (alloc,
extend, truncate, free), pinning, and a youngest-first victim scan.
"""
from __future__ import annotations

from typing import Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.models.common import init_paged_kv_pool
from repro_torch.obs import MetricsRegistry


class PageAllocator:
    """Free-list page allocator with ownership, pinning, and victim scan.

    Gauges ``{name}.free`` / ``{name}.owners`` / ``{name}.pinned`` track
    the live state; counters ``{name}.allocs`` / ``.extends`` / ``.freed``
    / ``.truncated`` count page traffic."""

    def __init__(self, num_pages: int, *,
                 metrics: Optional[MetricsRegistry] = None,
                 name: str = "pages"):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = int(num_pages)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.name = str(name)
        # Stack of free ids; low ids come off first.
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._owned: Dict[Hashable, List[int]] = {}
        self._pinned: set = set()
        self._clock = 0
        self._born: Dict[Hashable, int] = {}   # owner -> admission order
        self._sync()

    def _sync(self) -> None:
        m, n = self.metrics, self.name
        m.gauge(f"{n}.free").set(len(self._free))
        m.gauge(f"{n}.owners").set(len(self._owned))
        m.gauge(f"{n}.pinned").set(len(self._pinned))

    @property
    def free_count(self) -> int:
        return len(self._free)

    def owners(self) -> List[Hashable]:
        return list(self._owned)

    def pages_of(self, owner: Hashable) -> List[int]:
        return list(self._owned.get(owner, ()))

    def alloc(self, owner: Hashable, n: int) -> Optional[List[int]]:
        """Give ``owner`` its first ``n`` pages; None (state unchanged) if
        the pool cannot cover them."""
        if owner in self._owned:
            raise ValueError(f"owner {owner!r} already holds pages")
        if n < 0:
            raise ValueError(f"negative page count {n}")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned[owner] = pages
        self._born[owner] = self._clock
        self._clock += 1
        self.metrics.counter(f"{self.name}.allocs").inc(n)
        self._sync()
        return pages

    def extend(self, owner: Hashable, n: int = 1) -> Optional[List[int]]:
        """Append ``n`` more pages to a live owner; None if the pool is dry
        (state unchanged: the caller decides whether to preempt)."""
        if owner not in self._owned:
            raise KeyError(f"unknown owner {owner!r}")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned[owner].extend(pages)
        self.metrics.counter(f"{self.name}.extends").inc(n)
        self._sync()
        return pages

    def free(self, owner: Hashable) -> List[int]:
        """Return all of ``owner``'s pages to the pool."""
        pages = self._owned.pop(owner, [])
        self._born.pop(owner, None)
        self._pinned.discard(owner)
        self._free.extend(pages)
        self.metrics.counter(f"{self.name}.freed").inc(len(pages))
        self._sync()
        return pages

    def truncate(self, owner: Hashable, keep: int) -> List[int]:
        """Shrink a live owner to its first ``keep`` pages, returning the
        freed suffix; ``keep >= held`` is a no-op."""
        if owner not in self._owned:
            raise KeyError(f"unknown owner {owner!r}")
        if keep < 0:
            raise ValueError(f"negative keep {keep}")
        pages = self._owned[owner]
        if keep >= len(pages):
            return []
        freed = pages[keep:]
        del pages[keep:]
        self._free.extend(freed)
        self.metrics.counter(f"{self.name}.truncated").inc(len(freed))
        self._sync()
        return freed

    def pin(self, owner: Hashable) -> None:
        """Protect an in-flight owner from the victim scan."""
        if owner not in self._owned:
            raise KeyError(f"unknown owner {owner!r}")
        self._pinned.add(owner)
        self._sync()

    def unpin(self, owner: Hashable) -> None:
        self._pinned.discard(owner)
        self._sync()

    def victims(self, n_needed: int) -> Optional[List[Hashable]]:
        """Youngest-first un-pinned owners whose pages, with the free list,
        cover ``n_needed``; None if even all of them would not. Does not
        free."""
        if n_needed <= len(self._free):
            return []
        chosen: List[Hashable] = []
        covered = len(self._free)
        for owner in sorted(self._owned, key=lambda o: -self._born[o]):
            if owner in self._pinned:
                continue
            chosen.append(owner)
            covered += len(self._owned[owner])
            if covered >= n_needed:
                return chosen
        return None

    def check(self) -> None:
        """Every page is either free or owned by exactly one owner."""
        seen = list(self._free)
        for pages in self._owned.values():
            seen.extend(pages)
        if sorted(seen) != list(range(self.num_pages)):
            raise AssertionError(
                f"page conservation violated: {sorted(seen)}")


class PagedKV:
    """Device page pools + host allocator + host page tables, as one unit.
    Rows are identified by their batch index; the trash page id is
    ``num_pages``."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 max_pages_per_row: int, max_batch: int, kv_heads: int,
                 head_dim: int, dtype=torch.float32, device=None,
                 metrics: Optional[MetricsRegistry] = None,
                 name: str = "pages"):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages_per_row = int(max_pages_per_row)
        self.max_batch = int(max_batch)
        self.trash = self.num_pages
        self.pools = init_paged_kv_pool(num_layers, self.num_pages,
                                        self.page_size, kv_heads, head_dim,
                                        dtype=dtype, device=device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.allocator = PageAllocator(self.num_pages, metrics=self.metrics,
                                       name=str(name))
        self.tables = np.full((max_batch, max_pages_per_row), self.trash,
                              np.int32)

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_size)

    def row_capacity(self) -> int:
        """Tokens one row can ever hold (the paged analogue of max_seq)."""
        return min(self.max_pages_per_row, self.num_pages) * self.page_size

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.pools.values())

    def admit(self, row: int, n_pages: int) -> bool:
        pages = self.allocator.alloc(row, n_pages)
        if pages is None:
            return False
        self.tables[row, :n_pages] = pages
        return True

    def extend(self, row: int, n_pages: int = 1) -> bool:
        held = len(self.allocator.pages_of(row))
        pages = self.allocator.extend(row, n_pages)
        if pages is None:
            return False
        self.tables[row, held:held + n_pages] = pages
        return True

    def release(self, row: int) -> None:
        self.allocator.free(row)
        self.tables[row, :] = self.trash

    def truncate(self, row: int, new_len: int) -> int:
        """Roll a row back to ``new_len`` valid tokens, freeing every page
        past the one its next write lands in (``new_len // page_size``).
        Freed table entries turn back into trash, so stale KV in returned
        pages is never read through this row again; stale slots inside the
        kept pages are dead by the length mask and are overwritten in place
        as decode goes on. Returns the number of pages freed."""
        if new_len < 0:
            raise ValueError(f"negative length {new_len}")
        keep = min(new_len // self.page_size + 1, self.allocated(row))
        freed = self.allocator.truncate(row, keep)
        if freed:
            self.tables[row, keep:keep + len(freed)] = self.trash
        return len(freed)

    def allocated(self, row: int) -> int:
        return len(self.allocator.pages_of(row))
