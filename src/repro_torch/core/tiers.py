"""Storage-tier cache models: Linux buffer-cache and Spectrum-Scale pagepool.

The paper's Section 4.2 (Figure 4) studies how the *memory/dataset ratio*
(MDR) changes training throughput for the three data paths.  The controlling
mechanism is block/page LRU caching in host RAM:

* REM      -> Linux buffer cache over NFS reads,
* NVMe     -> Linux buffer cache over local NVMe reads,
* Hoard    -> Spectrum Scale *pagepool* (dedicated, fixed-size).

Deep-learning epochs access the full dataset in a fresh random permutation,
which is the pathological case for LRU (the paper's Requirement-2 argument).

Exact vectorised model (``LRUStackModel``): LRU hits iff the *stack distance*
(number of DISTINCT items touched since the previous access) is below the
cache capacity ``C``.  For per-epoch random permutations, an item at position
``p`` in epoch ``e`` and ``p'`` in epoch ``e+1`` sees

    D = (N - p) + p' - (N - p) * p' / N          (expected distinct count)

because the two access windows are independent uniform subsets whose overlap
is hypergeometric with mean ``(N - p) p' / N``.  Notably ``D <= N`` always
(equality iff the windows are disjoint and exhaustive), so ``C >= N`` gives a
100% hit rate after the first epoch — exactly the paper's MDR > 1.1 regime —
while ``C = f N`` for ``f < 1`` integrates to a hit rate of roughly ``f^2/2``:
LRU keeps *some* value under contention, but far less than ``f`` (the cache
"thrashing" the paper describes).  ``tests/test_tiers.py`` validates the model
against an exact ``OrderedDict`` LRU.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


class LRUCache:
    """Exact LRU over item ids (reference implementation for tests)."""

    def __init__(self, capacity_items: int):
        self.capacity = int(capacity_items)
        self._od: OrderedDict[int, None] = OrderedDict()
        self.hits = 0
        self.accesses = 0

    def access(self, item: int) -> bool:
        self.accesses += 1
        hit = item in self._od
        if hit:
            self.hits += 1
            self._od.move_to_end(item)
        else:
            if self.capacity <= 0:
                return False
            self._od[item] = None
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)
        return hit

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.accesses)


class LRUStackModel:
    """Vectorised LRU hit model for epoch-permutation access patterns.

    ``access_epoch_batch`` is called once per training step with the item ids
    and their positions inside the current epoch's permutation; it returns a
    boolean hit mask.  State per item: epoch index + position of last access.
    """

    def __init__(self, n_items: int, capacity_items: int):
        self.n = int(n_items)
        self.capacity = float(capacity_items)
        self._last_epoch = np.full(self.n, -(10**9), dtype=np.int64)
        self._last_pos = np.zeros(self.n, dtype=np.int64)

    def set_capacity(self, capacity_items: int) -> None:
        self.capacity = float(capacity_items)

    def warm(self, item_ids: np.ndarray, epoch: int = -1) -> None:
        """Mark items as resident as-if read at the end of ``epoch``."""
        self._last_epoch[item_ids] = epoch
        self._last_pos[item_ids] = self.n - 1

    def access_epoch_batch(
        self, item_ids: np.ndarray, epoch: int, positions: np.ndarray
    ) -> np.ndarray:
        gap = epoch - self._last_epoch[item_ids]
        lp = self._last_pos[item_ids].astype(np.float64)
        p = positions.astype(np.float64)

        # distinct items touched since the previous access of each item
        same_epoch = p - lp                                   # gap == 0
        next_epoch = (self.n - lp) + p - (self.n - lp) * p / self.n  # gap == 1
        dist = np.where(gap == 0, same_epoch, np.where(gap == 1, next_epoch, float(self.n)))
        cold = self._last_epoch[item_ids] < -(10**8)          # never accessed
        hits = (dist < self.capacity) & ~cold
        if self.capacity <= 0:
            hits = np.zeros_like(hits)

        self._last_epoch[item_ids] = epoch
        self._last_pos[item_ids] = positions
        return hits


class PagePool(LRUStackModel):
    """Spectrum-Scale pagepool: same LRU dynamics, dedicated capacity.

    Unlike the opportunistic buffer cache, the pagepool size is fixed by
    configuration (the paper tunes it to set Hoard's MDR), so third-party
    memory pressure does not shrink it.
    """


def buffer_cache_items(mdr: float, dataset_items: int, reserve_fraction: float = 0.0) -> int:
    """Capacity (in items) of an MDR-controlled cache.

    MDR = free-memory / dataset-size (paper 4.2); ``reserve_fraction`` models
    memory the OS keeps for other purposes and is 0 in the paper's stress-tool
    methodology (stress already accounts for it).
    """
    eff = max(0.0, mdr - reserve_fraction)
    return int(eff * dataset_items)
