"""Per-handle sequential readahead: the non-clairvoyant fill planner.

The clairvoyant :class:`~repro_torch.core.prefetch.PrefetchScheduler` needs the
epoch permutation ahead of time — an iterator-world luxury.  A POSIX consumer
gives Hoard nothing but a stream of ``(offset, size)`` reads, which is the
configuration the paper actually runs: the filesystem must *infer* what to
prefetch.  ``Readahead`` does what a kernel readahead window does — detect a
sequential streak per open file handle, then predict "the rest of this file,
in order" and feed that prediction to the *existing* ``PrefetchScheduler``
as if it were a known permutation.  The scheduler machinery (bounded
in-flight transfers, consumer-paced window, resume-skips-filled-chunks) is
reused unchanged; only the source of the order differs:

    clairvoyant:      EpochPlan.order(e)        -> first-touch chunk schedule
    non-clairvoyant:  observed sequential reads -> predicted remaining items

A seek breaks the prediction: the running schedule is stopped (chunks
already demanded were correctly predicted and still land; the *rest* of the
prediction was speculation) and the streak detector starts over from the new
position.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.prefetch import FillTracker, PrefetchScheduler
from .metadata import FileAttr


class Readahead:
    """Sequential-window readahead for one open HoardFS file handle.

    ``observe(offset, size, first_item)`` is called by the VFS on every
    scalar read *before* the read is served, so a confirmed streak starts
    filling ahead of the reader rather than behind it.  With no fill plane
    (dataset fully cached) the detector still runs — the hit/seek statistics
    feed ``fsbench`` — but nothing is scheduled.
    """

    def __init__(
        self,
        tracker: Optional[FillTracker],
        attr: FileAttr,
        *,
        min_streak: int = 2,
        window_chunks: Optional[int] = 8,
        max_inflight: int = 4,
    ):
        self.tracker = tracker
        self.attr = attr
        self.min_streak = max(1, int(min_streak))
        self.window_chunks = window_chunks
        self.max_inflight = max_inflight
        self.scheduler: Optional[PrefetchScheduler] = None
        self._next_offset: Optional[int] = None    # None until the first read
        self._streak = 0
        self._pred_start_chunk = 0                 # chunk the prediction began at
        # ---- statistics (aggregated by HoardFS into readahead_stats())
        self.sequential_reads = 0
        self.seeks = 0
        self.windows_started = 0

    # ---------------------------------------------------------------- observe
    def observe(self, offset: int, size: int, first_item: int) -> None:
        """Feed one read's position to the streak detector (pre-service)."""
        if self._next_offset is not None and offset != self._next_offset:
            self.seeks += 1
            self._streak = 0
            self.stop()                            # prediction invalidated
        else:
            self._streak += 1
            if self._next_offset is not None:
                self.sequential_reads += 1
        self._next_offset = offset + size

        if self.tracker is None or self.tracker.cancelled or self.tracker.complete:
            return
        if self.scheduler is None and self._streak >= self.min_streak:
            self._start(first_item)
        elif self.scheduler is not None:
            # heartbeat: chunks consumed *within the prediction* pace the window
            chunk = first_item // self.tracker._manifest().items_per_chunk
            self.scheduler.note_progress(chunk - self._pred_start_chunk + 1)

    def _start(self, first_item: int) -> None:
        """Predict sequential access to EOF and hand it to the scheduler."""
        man = self.tracker._manifest()
        end_item = self.attr.item_lo + self.attr.n_items
        predicted = np.arange(first_item, end_item, dtype=np.int64)
        if len(predicted) == 0:
            return
        self.scheduler = PrefetchScheduler(
            self.tracker,
            max_inflight=self.max_inflight,
            window_chunks=self.window_chunks,
        )
        self._pred_start_chunk = int(first_item // man.items_per_chunk)
        self.windows_started += 1
        self.scheduler.start(predicted)

    # ------------------------------------------------------------------- stop
    def stop(self) -> None:
        """Abandon the current prediction (seek, or handle close)."""
        if self.scheduler is not None:
            self.scheduler.stop()
            self.scheduler = None
