"""Host-memory swap store for preempted requests' KV pages.

When the engine preempts a live request it parks that request's written
pages somewhere cheaper than the device pool.  The cheap path hands full
pages to the radix prefix tree (copy-free: the tree takes a pool
reference), but tree pages still occupy the pool and are first in line
for eviction under the very pressure that caused the preemption.
``PageSwapStore`` is the other path: the engine gathers the victim's
pages off every cache leaf into host tensors (pinned memory when the
pools live on the card), stores them here under an opaque handle and
frees the device pages outright.  On resume the engine scatters the
stored tensors into freshly allocated pages and continues prefill at
the swapped edge: a restore instead of a recompute.

The store never touches device memory (the engine owns the gather and
the scatter, which need the pools' page axis) and enforces only a byte
budget, counted as ``Tensor.nbytes``.  ``put`` returns ``None`` when an
entry would exceed the budget: the engine then falls back to the radix
tree or to recompute, so preemption never deadlocks on its own escape
hatch.

Entries survive engine exceptions and ``drain()`` on purpose (they are
the resumable state a drained request needs); they are dropped when a
resume consumes them, or through ``drop`` when the owning request
retires without resuming (timeout while waiting, retry budget spent).

The JAX package's store holds numpy arrays; numpy has no bfloat16, so
this one holds ``torch.Tensor`` leaves.  Its counters and ``stats()``
keys are the JAX store's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch


class PageSwapStore:
    """Bounded host-memory store of per-request page snapshots.

    One entry is the list of per-cache-leaf tensors for ``n_pages``
    pages, in the engine's leaf order.  Keys are integer handles minted
    by ``put``.
    """

    def __init__(self, capacity_bytes: int = 1 << 30):
        if capacity_bytes < 0:
            raise ValueError("capacity_bytes must be >= 0")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: Dict[int, List[torch.Tensor]] = {}
        self._entry_pages: Dict[int, int] = {}
        self._next_handle = 0
        self.bytes_used = 0
        # lifetime counters (monotonic; surfaced in stats)
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.rejected_puts = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def nbytes(leaves: List[torch.Tensor]) -> int:
        return sum(int(t.nbytes) for t in leaves)

    def admits(self, size: int) -> bool:
        """Whether an entry of ``size`` bytes fits the budget now; a
        refusal counts as a rejected put.  The engine asks before it
        copies pages off the card, so a full store costs no copy."""
        if self.bytes_used + size <= self.capacity_bytes:
            return True
        self.rejected_puts += 1
        return False

    def put(self, leaves: List[torch.Tensor], n_pages: int) -> Optional[int]:
        """Store one request's page snapshot; returns a handle, or
        ``None`` if the entry would exceed the byte budget (the caller
        falls back to the tree or to recompute)."""
        size = self.nbytes(leaves)
        if not self.admits(size):
            return None
        handle = self._next_handle
        self._next_handle += 1
        self._entries[handle] = leaves
        self._entry_pages[handle] = int(n_pages)
        self.bytes_used += size
        self.swapped_out_pages += int(n_pages)
        return handle

    def get(self, handle: int) -> List[torch.Tensor]:
        """Consume an entry (the resume path): returns the leaf tensors
        and removes the entry from the store."""
        leaves = self._entries.pop(handle)
        self.swapped_in_pages += self._entry_pages.pop(handle)
        self.bytes_used -= self.nbytes(leaves)
        return leaves

    def drop(self, handle: int) -> None:
        """Discard an entry whose request will never resume (dropping an
        unknown or consumed handle does nothing)."""
        leaves = self._entries.pop(handle, None)
        if leaves is None:
            return
        self._entry_pages.pop(handle, None)
        self.bytes_used -= self.nbytes(leaves)

    def stats(self) -> Dict[str, object]:
        return {
            "entries": len(self._entries),
            "bytes_used": self.bytes_used,
            "capacity_bytes": self.capacity_bytes,
            "swapped_out_pages": self.swapped_out_pages,
            "swapped_in_pages": self.swapped_in_pages,
            "rejected_puts": self.rejected_puts,
        }
