"""On-demand fill data plane + clairvoyant prefetch scheduler.

The paper's second usage model (Section 3): Hoard "can cache the data from a
central storage system before the start of the job **or during the initial
execution of the job**".  This module implements the *during* path:

* :class:`FillTracker` — the shared, chunk-granular fill control plane for
  one dataset.  Exactly one remote fetch per chunk is ever issued, no matter
  how many jobs (or the prefetcher) want it: later demands join the
  in-flight transfer's completion event.  Landed chunks are written into the
  :class:`~repro_torch.core.stripestore.StripeStore` (``put_chunk``) so every
  subsequent reader takes the stripe path — the cold dataset transparently
  converges to fully cached during epoch 1.

* :class:`PrefetchScheduler` — a clairvoyant (NoPFS-style, arXiv 2101.08734)
  scheduler.  Deep-learning input pipelines draw from a *known* per-epoch
  permutation (:class:`~repro_torch.core.loader.EpochPlan`), so the exact
  first-touch order of chunks is computable before the epoch starts.  The
  scheduler walks that order ahead of the consumer, keeping a bounded number
  of remote->stripe transfers in flight, optionally pacing itself against
  consumer progress so it never runs more than ``window_chunks`` ahead.

Every byte is booked as flows on the simulated fabric (remote NIC, core,
rack up-links, node NICs, NVMe write queues), so fill traffic contends with
training ingest honestly — the epoch-1 cost of an on-demand fill is an
*output* of the flow network, not a constant.

Fill fan-out with replication r > 1 is modelled as it is implemented in AFM:
one remote fetch to the chunk's primary replica, then peer copies from the
primary to the remaining replicas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .cache import CacheManager
from .metrics import JobMetrics
from .simclock import Event, Resource, SimClock
from .telemetry import FlowTag
from .topology import Topology


class FillTracker:
    """Shared chunk-fill bookkeeping + remote read-through for one dataset.

    ``demand(chunk)`` is the single entry point for both the prefetcher and
    the miss path of :class:`~repro_torch.core.loader.HoardBackend`:

    * chunk already filled            -> ``None`` (read from the stripes),
    * chunk fill in flight            -> the existing completion event,
    * otherwise                       -> start the remote->stripe transfer
                                         and return its completion event.

    An optional ``ingest_bw`` resource models a per-dataset AFM-gateway
    service ceiling; by default only the physical fabric (remote NIC, links,
    NVMe) limits fill throughput, which matches the paper's asynchronous
    pre-population mode.
    """

    def __init__(
        self,
        clock: SimClock,
        topology: Topology,
        cache: CacheManager,
        dataset_id: str,
        *,
        ingest_bw: Optional[float] = None,
        metrics: Optional[JobMetrics] = None,
    ):
        self.clock = clock
        self.topology = topology
        self.cache = cache
        self.store = cache.store
        self.dataset_id = dataset_id
        self.inflight: dict[int, Event] = {}
        self.ingest = (
            Resource(f"fill_ingest.{dataset_id}", float(ingest_bw), created_at=clock.now)
            if ingest_bw
            else None
        )
        self.metrics = metrics
        self.filled_events = 0          # chunks this tracker landed (for tests)
        self.cancelled = False          # set by CacheManager.evict via cancel()
        # register with the cache entry so evicting a FILLING dataset can
        # cancel this tracker's outstanding transfers
        cache.attach_fill_plane(dataset_id, self)

    # ------------------------------------------------------------- queries
    def _manifest(self):
        return self.store.manifests[self.dataset_id]

    def filled_mask_for_items(self, item_ids: np.ndarray) -> np.ndarray:
        """Per-item bool mask: is the item's chunk resident in the stripes?"""
        man = self._manifest()
        return self.store.chunk_filled_mask(self.dataset_id, item_ids // man.items_per_chunk)

    def chunks_of(self, item_ids: np.ndarray) -> np.ndarray:
        return item_ids // self._manifest().items_per_chunk

    @property
    def complete(self) -> bool:
        # of the *resident* subset: a partial admission's fill is done when
        # every chunk that has a stripe to land on has landed — non-resident
        # chunks are the read-through plane's job, not the fill plane's
        return self.store.resident_filled_fraction(self.dataset_id) >= 1.0

    # -------------------------------------------------------------- cancel
    def cancel(self) -> None:
        """Abort the fill: outstanding transfers land as no-ops.

        Called by :meth:`CacheManager.evict` when a FILLING dataset is the
        eviction victim.  The simulated bytes already in flight still cross
        the fabric (they were sent), but nothing is written into the stripe
        store — the manifest is about to be deleted, and a later re-admission
        lays out a *new* manifest that must start fully unfilled.  A
        cancelled tracker refuses further demands; re-admission creates a
        fresh tracker.
        """
        self.cancelled = True
        self.inflight.clear()

    # -------------------------------------------------------------- demand
    def demand(self, chunk: int) -> Optional[Event]:
        """Need ``chunk`` resident: join or start its fill; None if filled."""
        if self.cancelled:
            raise RuntimeError(
                f"fill plane for {self.dataset_id!r} was cancelled by eviction"
            )
        man = self._manifest()
        if man.is_filled(chunk):
            return None
        if not man.chunk_nodes[chunk]:
            # non-resident (partial admission): there is no stripe replica
            # to land the bytes on — the data plane serves the chunk by
            # remote read-through instead, so a fill here would be wasted
            # remote bandwidth.  None = "nothing for the fill plane to do".
            return None
        if chunk in self.inflight:
            return self.inflight[chunk]
        return self._start_fill(chunk)

    def _start_fill(self, chunk: int) -> Event:
        man = self._manifest()
        if self.store.is_migrating(self.dataset_id, chunk):
            # invariant, not a race to tolerate: only *filled* chunks ever
            # migrate as flows (unfilled moves are instant metadata
            # retargets), and filled chunks are never demanded — so a fill
            # starting on a mid-move chunk means the fill/rebalance planes
            # disagree about fill state.  Fail loudly.
            raise RuntimeError(
                f"{self.dataset_id}:{chunk} is mid-migration but was demanded "
                f"for fill (fill plane and rebalancer out of sync)"
            )
        replicas = man.chunk_nodes[chunk]
        primary = self.topology.node(replicas[0])
        head = [self.ingest] if self.ingest else []
        owner = self.metrics.job_id if self.metrics else f"fill:{self.dataset_id}"
        flows = [
            self.clock.transfer(
                [*head, *self.topology.path_from_remote(primary), primary.nvme],
                man.chunk_bytes,
                FlowTag("fill", owner, self.dataset_id, chunk),
            )
        ]
        # replica fan-out: peer copies from the primary (never re-fetched).
        # The source side is a *read* of the just-landed chunk, so it crosses
        # the primary's per-disk read queue (readsched) like any stripe read.
        for node_id in replicas[1:]:
            peer = self.topology.node(node_id)
            flows.append(
                self.clock.transfer(
                    [
                        self.store.readsched.disk(primary.node_id, chunk),
                        *self.topology.path(primary, peer),
                        peer.nvme,
                    ],
                    man.chunk_bytes,
                    FlowTag("fill-replica", owner, self.dataset_id, chunk),
                )
            )
        done = self.clock.event()
        self.inflight[chunk] = done
        if self.metrics:
            self.metrics.count("remote_bytes", man.chunk_bytes)
            self.metrics.count("fill_bytes", man.chunk_bytes * len(replicas))

        def _landed(_v):
            if self.cancelled:
                # eviction raced the transfer: the dataset's manifest is gone
                # (or belongs to a re-admission); drop the chunk on the floor
                # and leave `done` unfired — nobody may read through a
                # cancelled plane, and a hung waiter is a loud bug signal
                return
            self.store.put_chunk(self.dataset_id, chunk)
            self.inflight.pop(chunk, None)
            self.filled_events += 1
            self.cache.note_chunk_filled(self.dataset_id)
            done.set()

        self.clock.all_of(flows).on_fire(_landed)
        return done


class PrefetchScheduler:
    """Clairvoyant remote->stripe prefetcher over a known epoch permutation.

    ``start(order)`` launches a simulated process that fills chunks in the
    permutation's *first-touch* order, keeping at most ``max_inflight``
    transfers outstanding.  With ``window_chunks`` set, the scheduler also
    paces itself against consumer progress (``note_progress``), never
    running more than that many chunks ahead — the NoPFS buffer-bound.  A
    restarted scheduler (interrupted fill) skips already-filled chunks, so
    fills resume instead of repeating.
    """

    def __init__(
        self,
        tracker: FillTracker,
        *,
        max_inflight: int = 8,
        window_chunks: Optional[int] = None,
    ):
        self.tracker = tracker
        self.clock = tracker.clock
        self.max_inflight = max(1, int(max_inflight))
        self.window_chunks = window_chunks
        self.cursor = 0                      # consumer progress, in chunks consumed
        self._progress_evt: Optional[Event] = None
        self.issued = 0                      # fills this scheduler initiated
        self.stopped = False                 # set by stop(); the schedule exits

    def stop(self) -> None:
        """Abandon the remaining schedule (already-issued fills still land).

        The non-clairvoyant fill planner (:class:`repro_torch.fs.Readahead`) calls this
        when the access pattern it predicted from breaks — a seek invalidates
        the rest of a sequential prediction, so continuing to fill it would
        be speculation, not prefetch.  Unlike :meth:`FillTracker.cancel`,
        chunks already demanded are NOT dropped: they were correctly
        predicted when issued and land normally.
        """
        self.stopped = True
        if self._progress_evt is not None:     # unblock a paced, parked run
            evt, self._progress_evt = self._progress_evt, None
            evt.set()

    # ------------------------------------------------------------- schedule
    @staticmethod
    def first_touch_sequence(order: np.ndarray, items_per_chunk: int) -> np.ndarray:
        """Chunk indices in the order the permutation first touches them."""
        chunks = order // items_per_chunk
        _, first_idx = np.unique(chunks, return_index=True)
        return chunks[np.sort(first_idx)]

    def start(self, order: np.ndarray) -> Event:
        """Run the fill schedule for one epoch permutation; Event on done."""
        man = self.tracker._manifest()
        seq = self.first_touch_sequence(np.asarray(order), man.items_per_chunk)
        return self.clock.process(self._run(seq))

    def note_progress(self, chunks_consumed: int) -> None:
        """Consumer heartbeat: monotonic count of distinct chunks consumed."""
        self.cursor = max(self.cursor, int(chunks_consumed))
        if self._progress_evt is not None:
            evt, self._progress_evt = self._progress_evt, None
            evt.set()

    def _run(self, seq: np.ndarray):
        pending: list[Event] = []
        for k, chunk in enumerate(seq):
            if self.tracker.cancelled or self.stopped:
                return                   # dataset evicted / schedule abandoned
            while self.window_chunks is not None and k - self.cursor >= self.window_chunks:
                self._progress_evt = self.clock.event()
                yield self._progress_evt
                if self.tracker.cancelled or self.stopped:
                    return
            ev = self.tracker.demand(int(chunk))
            if ev is None:
                continue
            self.issued += 1
            pending.append(ev)
            pending = [e for e in pending if not e.fired]
            while len(pending) >= self.max_inflight:
                yield pending[0]
                pending = [e for e in pending if not e.fired]
        for ev in pending:
            yield ev
