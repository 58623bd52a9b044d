"""Transparent data loaders + the simulated training-job process.

Requirement 4 adapted to JAX: the paper exposes cached data through POSIX so
frameworks need no changes; here the training loop consumes a plain iterator
(`HoardLoader`) and cannot tell whether a batch came from the remote store,
a peer's stripe, local NVMe or RAM.  Three interchangeable backends implement
the paper's three data paths:

* ``RemoteBackend``  (REM)   — NFS streams + host buffer cache,
* ``LocalCopyBackend`` (NVMe) — pre-staged local copy + buffer cache,
* ``HoardBackend``            — stripe store + pagepool + AFM-style fill.

Every backend classifies each step's items into service classes and books the
bytes as flows on the simulated fabric; `TrainingJob` overlaps IO for step
``i+1`` with compute for step ``i`` (double buffering), which is how real
input pipelines behave and why throughput is ``max(io, compute)``-bound.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from .cache import CacheManager, CacheState
from .calibration import ComputeModel, ConstantCompute, WorkloadCalibration, validate_compute
from .metrics import JobMetrics
from .simclock import Event, Resource, SimClock
from .stripestore import StripeError
from .telemetry import FlowTag
from .tiers import LRUStackModel, PagePool, buffer_cache_items
from .topology import Node, Topology


@dataclass
class EpochPlan:
    """Deterministic per-epoch permutation of item indices."""

    n_items: int
    seed: int

    def order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self.n_items)


class _Backend:
    """Common plumbing: per-job client-service resources."""

    name = "base"
    #: stall class charged for startup staging time (telemetry taxonomy)
    startup_stall_class = "remote-NIC"

    def __init__(self, clock: SimClock, topology: Topology, node: Node, cal: WorkloadCalibration):
        self.clock = clock
        self.topology = topology
        self.node = node
        self.cal = cal
        self.ram = Resource(f"{node.name}.ram_client", cal.ram_bw, created_at=clock.now)
        self.metrics: Optional[JobMetrics] = None
        # dominant stall class of the most recent batch_io call; TrainingJob
        # snapshots it at issue time to attribute the wait on that batch
        self.last_io_class = "compute"

    def _owner(self) -> str:
        return self.metrics.job_id if self.metrics else ""

    def epoch_start(self, epoch: int) -> None:  # pragma: no cover - default
        pass

    def startup(self) -> float:
        """Seconds of one-off staging before step 0 (e.g. NVMe copy)."""
        return 0.0

    def batch_io(self, item_ids: np.ndarray, epoch: int, positions: np.ndarray) -> Event:
        raise NotImplementedError


class RemoteBackend(_Backend):
    """REM: every miss streams from the central NFS server."""

    name = "REM"

    def __init__(
        self, clock, topology, node, cal, *,
        mdr: Optional[float] = None, metrics: Optional[JobMetrics] = None,
    ):
        super().__init__(clock, topology, node, cal)
        self.stream = Resource(f"{node.name}.nfs_stream", cal.rem_miss_bw, created_at=clock.now)
        mdr = cal.default_mdr if mdr is None else mdr
        self.buffer_cache = LRUStackModel(
            cal.dataset_items, buffer_cache_items(mdr, cal.dataset_items)
        )
        self.metrics = metrics

    def batch_io(self, item_ids, epoch, positions) -> Event:
        hits = self.buffer_cache.access_epoch_batch(item_ids, epoch, positions)
        miss_bytes = float((~hits).sum()) * self.cal.item_bytes
        hit_bytes = float(hits.sum()) * self.cal.item_bytes
        flows = []
        owner = self._owner()
        if miss_bytes:
            path = [self.stream, *self.topology.path_from_remote(self.node)]
            flows.append(
                self.clock.transfer(path, miss_bytes, FlowTag("remote-miss", owner))
            )
            if self.metrics:
                self.metrics.count("remote_bytes", miss_bytes)
        if hit_bytes:
            flows.append(self.clock.transfer([self.ram], hit_bytes, FlowTag("ram-hit", owner)))
            if self.metrics:
                self.metrics.count("ram_bytes", hit_bytes)
        self.last_io_class = (
            "remote-NIC" if miss_bytes else ("disk-queue" if hit_bytes else "compute")
        )
        return self.clock.all_of(flows)


class LocalCopyBackend(_Backend):
    """NVMe: dataset copied to the node's local disks before the job."""

    name = "NVMe"

    def __init__(
        self,
        clock,
        topology,
        node,
        cal,
        *,
        mdr: Optional[float] = None,
        physical_copy: bool = False,
        metrics: Optional[JobMetrics] = None,
    ):
        super().__init__(clock, topology, node, cal)
        mdr = cal.default_mdr if mdr is None else mdr
        self.buffer_cache = LRUStackModel(
            cal.dataset_items, buffer_cache_items(mdr, cal.dataset_items)
        )
        self.physical_copy = physical_copy
        self.metrics = metrics

    def startup(self) -> float:
        if not self.physical_copy:
            # the paper's Table-3 projection amortises the copy (see
            # calibration.py); keep their constant for the faithful repro
            return self.cal.nvme_prestage_s
        # honest mode: stream the dataset from NFS through the fabric now
        return -1.0  # sentinel: TrainingJob books a real flow instead

    def startup_flow(self) -> Event:
        path = [*self.topology.path_from_remote(self.node), self.node.nvme]
        if self.metrics:
            self.metrics.count("remote_bytes", self.cal.dataset_bytes)
        return self.clock.transfer(
            path, self.cal.dataset_bytes, FlowTag("prestage", self._owner())
        )

    def batch_io(self, item_ids, epoch, positions) -> Event:
        hits = self.buffer_cache.access_epoch_batch(item_ids, epoch, positions)
        miss_bytes = float((~hits).sum()) * self.cal.item_bytes
        hit_bytes = float(hits.sum()) * self.cal.item_bytes
        flows = []
        owner = self._owner()
        if miss_bytes:
            flows.append(
                self.clock.transfer([self.node.nvme], miss_bytes, FlowTag("nvme-read", owner))
            )
            if self.metrics:
                self.metrics.count("nvme_bytes", miss_bytes)
        if hit_bytes:
            flows.append(self.clock.transfer([self.ram], hit_bytes, FlowTag("ram-hit", owner)))
            if self.metrics:
                self.metrics.count("ram_bytes", hit_bytes)
        self.last_io_class = "disk-queue" if flows else "compute"
        return self.clock.all_of(flows)


class StripeDataPlane:
    """Shared tri-state read engine: stripe hit / fill join / remote fall-through.

    One instance serves one (dataset, reader node) pair.  Two consumers
    resolve reads through it so they book *byte-identical* flows on the
    simulated fabric:

    * :class:`HoardBackend` — the iterator-transparency surface (R4 adapted
      to JAX),
    * :class:`repro_torch.fs.HoardFS` — the POSIX-façade filesystem, whose
      ``pread``/``pread_batch`` paths translate byte ranges into the same
      item arrays.

    Classification per item (tri-state + the partial-caching fourth class):

    1. *stripe hit* — the item's chunk is filled; read from the closest
       replica (local NVMe, or a peer's stripe across the fabric),
    2. *fill join* — the chunk's remote->stripe transfer is already in
       flight; wait for it, then stripe-read,
    3. *remote fall-through* — start the chunk's fill now via the shared
       :class:`~repro_torch.core.prefetch.FillTracker`; the fetched chunk lands in
       the StripeStore so the dataset converges to fully cached,
    4. *remote read-through* — the chunk is *non-resident* (a
       partial admission gave it no stripe replicas): stream the items
       straight from the remote store at the calibrated NFS miss rate,
       without landing anything — these chunks stay remote until
       ``CacheManager.promote_chunks`` grants them a stripe.

    ``fill_plane=None`` is the fully-cached / partial-terminal
    configuration: every *resident* chunk must already be filled (a read of
    an unfilled resident chunk with no fill plane is a loud error, not a
    silent remote fetch); non-resident chunks still read through.
    ``positions=None`` skips the pagepool stack-distance model — the POSIX
    scalar-read path uses this, since that model is calibrated for
    epoch-permutation batch access.
    """

    def __init__(
        self,
        clock: SimClock,
        topology: Topology,
        node: Node,
        cal: WorkloadCalibration,
        *,
        cache: CacheManager,
        dataset_id: str,
        pagepool: PagePool,
        metrics: Optional[JobMetrics] = None,
        fill_plane=None,
        prefetcher=None,
    ):
        self.clock = clock
        self.topology = topology
        self.node = node
        self.cal = cal
        self.cache = cache
        self.dataset_id = dataset_id
        # seconds/second of client-daemon CPU
        self.client = Resource(f"{node.name}.gpfs_client", 1.0, created_at=clock.now)
        self.pagepool = pagepool
        self.metrics = metrics
        # dominant stall class of the most recent ondemand_io call (telemetry)
        self.last_io_class = "compute"
        # on-demand fill plane (prefetch.FillTracker) + optional scheduler
        # to heartbeat consumer progress to (prefetch.PrefetchScheduler)
        self.fill_plane = fill_plane
        self.prefetcher = prefetcher
        self._chunks_seen: Optional[np.ndarray] = None
        # remote read-through stream for non-resident chunks (partial
        # caching): same per-reader NFS service model as RemoteBackend,
        # created lazily so fully-cached planes pay nothing
        self._rt_stream: Optional[Resource] = None

    def _manifest(self):
        return self.cache.store.manifests[self.dataset_id]

    def _owner(self) -> str:
        return self.metrics.job_id if self.metrics else ""

    # ---------------------------------------------------------- flow booking
    def stripe_flows(self, items: np.ndarray) -> tuple[list[Event], float]:
        """Book stripe reads (local disk or peer replica) for ``items``.

        Replica selection is contention-aware (``locate_batch`` scores live
        queue depth + locality, hash tie-break), and every read crosses its
        chunk's *per-disk* read queue (:mod:`repro_torch.core.readsched`) plus the
        network path — a hot replica's backlog slows its readers through
        max-min fair sharing instead of being served instantaneously.
        """
        flows: list[Event] = []
        if len(items) == 0:
            return flows, 0.0
        store = self.cache.store
        sched = store.readsched
        total = float(len(items)) * self.cal.item_bytes
        src_nodes, slots, width = store.locate_batch_with_slots(
            self.dataset_id, items, self.node
        )
        sched.note_slot_reads(
            self.dataset_id,
            np.bincount(slots, minlength=width) * self.cal.item_bytes,
        )
        chunks = items // self._manifest().items_per_chunk
        disk_idx = chunks % sched.n_disks
        # one flow per (source node, source disk) so disk queues are honest
        group = src_nodes * sched.n_disks + disk_idx
        for g in np.unique(group):
            src_id, disk = divmod(int(g), sched.n_disks)
            nbytes = float((group == g).sum()) * self.cal.item_bytes
            src = self.topology.node(src_id)
            path = [sched.disks[src_id][disk], *self.topology.path(src, self.node)]
            flows.append(
                self.clock.transfer(
                    path, nbytes, FlowTag("stripe-read", self._owner(), self.dataset_id)
                )
            )
            sched.note_read(self.dataset_id, src_id, nbytes)
            if self.metrics:
                if src.node_id == self.node.node_id:
                    self.metrics.count("local_stripe_bytes", nbytes)
                else:
                    self.metrics.count("peer_bytes", nbytes)
                    self.metrics.count_link(src.node_id, self.node.node_id, nbytes)
        if self.metrics:
            self.metrics.count("stripe_bytes", total)
        return flows, total

    def client_flow(self, served_bytes: float, stripe_bytes: float) -> Optional[Event]:
        """GPFS-client CPU: RPC cost on every byte served from the stripes
        or the pagepool, plus data-move cost on stripe misses (class doc)."""
        client_seconds = (
            served_bytes / self.cal.stripe_rpc_bw + stripe_bytes / self.cal.stripe_move_bw
        )
        if client_seconds > 0:
            return self.clock.transfer(
                [self.client], client_seconds,
                FlowTag("client-cpu", self._owner(), self.dataset_id),
            )
        return None

    # ----------------------------------------------------------------- reads
    def filled_mask(self, item_ids: np.ndarray) -> np.ndarray:
        """Per-item bool mask: is the item's chunk resident in the stripes?"""
        if self.fill_plane is not None:
            return self.fill_plane.filled_mask_for_items(item_ids)
        man = self._manifest()
        return self.cache.store.chunk_filled_mask(
            self.dataset_id, item_ids // man.items_per_chunk
        )

    def _readthrough_stream(self) -> Resource:
        if self._rt_stream is None:
            self._rt_stream = Resource(
                f"{self.node.name}.remote_miss", self.cal.rem_miss_bw,
                created_at=self.clock.now,
            )
        return self._rt_stream

    def _readthrough_flow(self, n_items: int) -> Event:
        """Book a remote read-through stream for items of non-resident chunks."""
        nbytes = float(n_items) * self.cal.item_bytes
        if self.metrics:
            self.metrics.count("remote_bytes", nbytes)
            self.metrics.count("readthrough_bytes", nbytes)
        return self.clock.transfer(
            [self._readthrough_stream(), *self.topology.path_from_remote(self.node)],
            nbytes,
            FlowTag("read-through", self._owner(), self.dataset_id),
        )

    def ondemand_io(self, item_ids, epoch, positions) -> Event:
        """Four-class batch IO over the shared fill plane (see class doc).

        ``positions=None`` disables the pagepool model (POSIX byte streams);
        otherwise identical to what :meth:`HoardBackend.batch_io` books in
        on-demand mode.
        """
        if positions is None:
            hits = np.zeros(len(item_ids), dtype=bool)
        else:
            hits = self.pagepool.access_epoch_batch(item_ids, epoch, positions)
        filled = self.filled_mask(item_ids)
        blocked = (~filled) & (~hits)
        # partial caching: a blocked item whose chunk holds no stripe
        # replicas is served by remote read-through — there is nothing to
        # fill and nowhere to land it
        chunks = item_ids // self._manifest().items_per_chunk
        resident = self.cache.store.chunk_resident_mask(self.dataset_id, chunks)
        fill_items = item_ids[blocked & resident]
        if len(fill_items) and self.fill_plane is None:
            raise StripeError(
                f"{self.dataset_id}: read of unfilled chunk(s) with no fill "
                f"plane attached (dataset not fully cached?)"
            )

        flows, stripe_now = self.stripe_flows(item_ids[filled & (~hits)])
        # pagepool hits are served inside the client daemon: client RPC cost
        # only, same as the AFM-mode model (no separate RAM flow)
        hit_bytes = float(hits.sum()) * self.cal.item_bytes
        if hit_bytes and self.metrics:
            self.metrics.count("ram_bytes", hit_bytes)
        client = self.client_flow(stripe_now + hit_bytes, stripe_now)
        if client is not None:
            flows.append(client)

        rt_mask = blocked & (~resident)
        if rt_mask.any():
            flows.append(self._readthrough_flow(int(rt_mask.sum())))
            # stripe reads feed chunk heat through locate_batch; read-through
            # items never get there, so note them here — their heat is what
            # argues a remote chunk into the resident subset on promotion
            self.cache.store.note_chunk_access(self.dataset_id, chunks[rt_mask])

        fill_events = []
        if len(fill_items):
            for c in np.unique(self.fill_plane.chunks_of(fill_items)):
                ev = self.fill_plane.demand(int(c))
                if ev is not None:
                    fill_events.append(ev)
        self.heartbeat(item_ids)

        # dominant stall class, worst first: a batch blocked on a fill is a
        # fill-wait even if it also read stripes; read-through beats local
        # stripe/client service; pure pagepool hits cost client CPU only
        if len(fill_items):
            self.last_io_class = "fill-wait"
        elif rt_mask.any():
            self.last_io_class = "remote-NIC"
        elif flows:
            self.last_io_class = "disk-queue"
        else:
            self.last_io_class = "compute"

        if not len(fill_items):
            return self.clock.all_of(flows)

        def two_phase():
            # phase A: immediate stripe/pagepool/read-through service +
            # in-flight fills
            if flows or fill_events:
                yield self.clock.all_of([*flows, *fill_events])
            # phase B: the just-landed chunks are served from the stripes.
            # Re-check residency — a chunk demoted while its fill was in
            # flight (put_chunk no-ops on replica-less chunks) falls back to
            # remote read-through instead of a lost-chunk StripeError.
            b_res = self.cache.store.chunk_resident_mask(
                self.dataset_id, fill_items // self._manifest().items_per_chunk
            )
            b_flows, stripe_b = self.stripe_flows(fill_items[b_res])
            if (~b_res).any():
                b_flows.append(self._readthrough_flow(int((~b_res).sum())))
            b_client = self.client_flow(stripe_b, stripe_b)
            if b_client is not None:
                b_flows.append(b_client)
            if b_flows:
                yield self.clock.all_of(b_flows)

        return self.clock.process(two_phase())

    def heartbeat(self, item_ids: np.ndarray) -> None:
        """Pace the clairvoyant prefetcher with distinct-chunks-consumed."""
        if self.prefetcher is None or self.fill_plane is None:
            return
        if self._chunks_seen is None:
            self._chunks_seen = np.zeros(self._manifest().n_chunks, dtype=bool)
        self._chunks_seen[self.fill_plane.chunks_of(item_ids)] = True
        self.prefetcher.note_progress(int(self._chunks_seen.sum()))


class HoardBackend(_Backend):
    """Hoard: stripe-store reads + pagepool; two miss-path models.

    **AFM mode** (default, the paper's measured configuration): first access
    to an uncached item takes the per-job *fill* path — fetch from the
    remote store, write back to the owning stripe node, serve the reader —
    all booked at the calibrated AFM miss-service rate.  Each job fills its
    own residency, so N cold jobs stream the dataset N times.

    **On-demand mode** (``fill_plane`` given): delegates each step to the
    shared :class:`StripeDataPlane`, which classifies every item tri-state
    (stripe hit / fill join / remote fall-through) over the chunk-granular
    fill data plane of :mod:`repro_torch.core.prefetch`.

    The GPFS client is modelled as a per-job *service-time* resource: every
    read (hit or miss — pagepool hits are served inside the client daemon)
    costs ``1/stripe_rpc_bw`` seconds/byte of client CPU, and stripe misses
    additionally cost ``1/stripe_move_bw``.  We book those seconds as a flow
    on a 1-unit/s resource so queueing across pipelined steps is preserved.
    This is why Hoard is almost flat in MDR (paper Fig. 4): the client CPU,
    not the data path, is the steady-state bottleneck.
    """

    name = "Hoard"

    def __init__(
        self,
        clock,
        topology,
        node,
        cal,
        *,
        cache: CacheManager,
        dataset_id: str,
        mdr: Optional[float] = None,
        metrics: Optional[JobMetrics] = None,
        fill_plane=None,
        prefetcher=None,
    ):
        super().__init__(clock, topology, node, cal)
        self.cache = cache
        self.dataset_id = dataset_id
        self.fill_client = Resource(f"{node.name}.afm_fill", cal.fill_bw, created_at=clock.now)
        mdr = cal.default_mdr if mdr is None else mdr
        n = self.cache.entries[dataset_id].spec.n_items
        self.plane = StripeDataPlane(
            clock, topology, node, cal,
            cache=cache, dataset_id=dataset_id,
            pagepool=PagePool(n, buffer_cache_items(mdr, n)),
            metrics=metrics, fill_plane=fill_plane, prefetcher=prefetcher,
        )
        # item-granular residency: AFM fetches exactly what a miss touches;
        # striping (chunk) granularity is a separate, placement-only concept
        self._resident = np.zeros(n, dtype=bool)
        self.metrics = metrics

    # convenience views into the shared data plane (tests, examples)
    @property
    def pagepool(self) -> PagePool:
        return self.plane.pagepool

    @property
    def fill_plane(self):
        return self.plane.fill_plane

    @property
    def prefetcher(self):
        return self.plane.prefetcher

    def _manifest(self):
        return self.cache.store.manifests[self.dataset_id]

    def epoch_start(self, epoch: int) -> None:
        entry = self.cache.entries[self.dataset_id]
        if entry.state is CacheState.CACHED:
            self._resident[:] = True
        self.cache.touch(self.dataset_id)

    # ------------------------------------------------------------------- io
    def batch_io(self, item_ids, epoch, positions) -> Event:
        self.cache.touch(self.dataset_id)
        entry = self.cache.entries[self.dataset_id]
        if self.plane.fill_plane is not None or entry.state is CacheState.PARTIAL:
            # on-demand fill in progress, or terminal partial residency:
            # both need the four-class data plane (fill joins / read-through)
            ev = self.plane.ondemand_io(item_ids, epoch, positions)
            self.last_io_class = self.plane.last_io_class
            return ev
        hits = self.plane.pagepool.access_epoch_batch(item_ids, epoch, positions)
        # chunk residency bounds per-job residency: an AFM fill can only
        # write back where a stripe replica exists, so items of non-resident
        # chunks (partial admission) re-stream from remote every epoch
        chunk_res = self.cache.store.chunk_resident_mask(
            self.dataset_id, item_ids // self._manifest().items_per_chunk
        )
        resident = self._resident[item_ids] & chunk_res

        fill_mask = (~resident) & (~hits)
        flows = []

        fill_bytes = float(fill_mask.sum()) * self.cal.item_bytes
        if fill_bytes:
            # AFM miss path: remote stream -> stripe write-back -> serve.
            # The calibrated fill-client service rate dominates; remote NIC
            # and target NVMe are also booked so cluster-level contention
            # (many filling jobs) appears mechanistically.
            path = [self.fill_client, *self.topology.path_from_remote(self.node)]
            flows.append(
                self.clock.transfer(
                    path, fill_bytes, FlowTag("afm-fill", self._owner(), self.dataset_id)
                )
            )
            self._resident[item_ids[fill_mask & chunk_res]] = True
            if self.metrics:
                self.metrics.count("remote_bytes", fill_bytes)
                self.metrics.count("fill_bytes", fill_bytes)

        stripe_flows, stripe_total = self.plane.stripe_flows(item_ids[resident & (~hits)])
        flows.extend(stripe_flows)

        served_bytes = stripe_total + float(hits.sum()) * self.cal.item_bytes
        client = self.plane.client_flow(served_bytes, stripe_total)
        if client is not None:
            flows.append(client)
        if self.metrics and hits.any():
            self.metrics.count("ram_bytes", float(hits.sum()) * self.cal.item_bytes)

        # dominant stall class (worst first) for the AFM miss-path model
        if fill_bytes:
            self.last_io_class = "fill-wait"
        elif flows:
            self.last_io_class = "disk-queue"
        else:
            self.last_io_class = "compute"

        if self._resident.all():
            entry = self.cache.entries[self.dataset_id]
            # per-job residency implies dataset-wide residency only when the
            # stripe manifest agrees: an AFM job sharing an on-demand-admitted
            # dataset must not flip it CACHED while the shared fill plane is
            # still streaming chunks (CACHED => every chunk filled, and
            # mark_filled detaches the fill plane, disarming cancellation)
            if (
                entry.state is CacheState.FILLING
                and self.cache.store.filled_fraction(self.dataset_id) >= 1.0
            ):
                self.cache.mark_filled(self.dataset_id)
        return self.clock.all_of(flows)


class HoardLoader:
    """The transparent iterator: ``for batch_meta in loader`` per epoch.

    Requirement 4's POSIX transparency becomes iterator transparency: the
    training loop sees ``(item_ids, positions)`` batches drawn from a
    deterministic per-epoch permutation (:class:`EpochPlan`) and cannot tell
    which tier serves them.  Because the permutation is seeded and known
    before the epoch runs, the same plan object also drives the clairvoyant
    :class:`~repro_torch.core.prefetch.PrefetchScheduler` — loader and prefetcher
    agree on the exact first-touch order by construction.
    """

    def __init__(
        self,
        backend: _Backend,
        cal: WorkloadCalibration,
        *,
        epochs: int,
        seed: int = 0,
        batch_items: Optional[int] = None,
    ):
        self.backend = backend
        self.cal = cal
        self.epochs = epochs
        self.batch = batch_items or cal.batch_items
        self.plan = EpochPlan(cal.dataset_items, seed)

    def steps_per_epoch(self) -> int:
        return (self.cal.dataset_items + self.batch - 1) // self.batch

    def epoch_batches(self, epoch: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = self.plan.order(epoch)
        positions = np.arange(len(order))
        for s in range(0, len(order), self.batch):
            yield order[s : s + self.batch], positions[s : s + self.batch]


@dataclass
class JobResult:
    job_id: str
    epoch_times: list[float] = field(default_factory=list)
    step_times: list[float] = field(default_factory=list)
    startup_s: float = 0.0
    # seconds per stall class (telemetry.STALL_CLASSES); every accounted
    # second of the job lands in exactly one class — GPU-busy time is
    # "compute", everything else names the stage the GPU waited on
    stall_breakdown: dict[str, float] = field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return self.startup_s + sum(self.epoch_times)

    def stall_fractions(self) -> dict[str, float]:
        """Per-class fraction of accounted time; sums to 1.0 when nonempty."""
        total = sum(self.stall_breakdown.values())
        if total <= 0:
            return {}
        return {cls: s / total for cls, s in sorted(self.stall_breakdown.items())}

    @property
    def stalled_s(self) -> float:
        """Accounted seconds the accelerator sat idle (everything non-compute)."""
        return sum(s for cls, s in self.stall_breakdown.items() if cls != "compute")

    def fps_timeline(self, batch_items: int) -> np.ndarray:
        dt = np.asarray(self.step_times)
        return batch_items / np.maximum(dt, 1e-9)

    def gpu_utilization(self, compute_s_per_step: float) -> float:
        """Fraction of post-startup wall time the accelerators were busy.

        The paper's §5 companion claim to the 2.1x headline: cached reads
        roughly double utilization because steps stop stalling on ingest.
        """
        run_s = sum(self.epoch_times)
        if run_s <= 0:
            return 0.0
        return min(1.0, len(self.step_times) * compute_s_per_step / run_s)


class TrainingJob:
    """Simulated DL job: prefetch-pipelined IO + compute, per-step metrics.

    ``prefetch_depth`` batches are kept in flight ahead of compute (tf.data
    style).  Depth 1 is classic double-buffering; deeper queues bank IO slack
    from cache-hit-rich phases of an epoch against the all-miss tail, which is
    what real input pipelines do and what the paper's steady rates reflect.
    """

    def __init__(
        self,
        job_id: str,
        clock: SimClock,
        loader: HoardLoader,
        cal: WorkloadCalibration,
        *,
        metrics: Optional[JobMetrics] = None,
        prefetch_depth: int = 16,
        compute: Optional[ComputeModel] = None,
    ):
        validate_compute(compute, "TrainingJob(compute=...)")
        self.job_id = job_id
        self.clock = clock
        self.loader = loader
        self.cal = cal
        # the compute plane: GPU time per step.  None keeps the paper's
        # AlexNet constant (bit-identical to the pre-plane simulator).
        self.compute: ComputeModel = compute if compute is not None else ConstantCompute(cal)
        self.metrics = metrics
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.result = JobResult(job_id)

    def start(self) -> Event:
        return self.clock.process(self._run())

    def _run(self):
        clock = self.clock
        backend = self.loader.backend
        # price the accelerator via the compute plane; the step consumes the
        # loader's calibrated batch (cal.batch_items — the per-job GPU batch,
        # independent of any loader batching override)
        compute_s = self.compute.step_time_s(self.cal.batch_items)
        tel = clock.telemetry
        tracer = tel.tracer if tel is not None else None
        breakdown = self.result.stall_breakdown

        def account(cls: str, dt: float) -> None:
            if dt > 0:
                breakdown[cls] = breakdown.get(cls, 0.0) + dt

        t0 = clock.now
        startup = backend.startup()
        if startup == -1.0:  # physical staging flow
            yield backend.startup_flow()
        elif startup > 0:
            yield clock.sleep(startup)
        self.result.startup_s = clock.now - t0
        account(getattr(backend, "startup_stall_class", "remote-NIC"), self.result.startup_s)

        def batch_stream():
            for epoch in range(self.loader.epochs):
                for ids, pos in self.loader.epoch_batches(epoch):
                    yield epoch, ids, pos

        stream = batch_stream()
        issued_epoch = -1

        def issue(item):
            nonlocal issued_epoch
            epoch, ids, pos = item
            if epoch != issued_epoch:
                backend.epoch_start(epoch)
                issued_epoch = epoch
            io = backend.batch_io(ids, epoch, pos)
            # snapshot the batch's dominant service class now: any wait on
            # this event is attributed to the stage that served the batch
            return epoch, io, getattr(backend, "last_io_class", "disk-queue")

        pending: deque = deque()

        def top_up():
            while len(pending) < self.prefetch_depth:
                item = next(stream, None)
                if item is None:
                    return
                pending.append(issue(item))

        top_up()
        if not pending:
            return self.result
        epoch_t0 = clock.now
        last_step_end = clock.now
        while pending:
            cur_epoch, io, io_cls = pending.popleft()
            wait_t0 = clock.now
            yield io                      # this step's data is ready
            wait = clock.now - wait_t0    # GPU idle: attribute to the io class
            if wait > 0:
                account(io_cls, wait)
                if tracer is not None:
                    tracer.add_span(
                        "stall", t0=wait_t0, dur=wait, kind=io_cls, owner=self.job_id
                    )
            top_up()                      # keep the pipeline full
            yield clock.sleep(compute_s)  # accelerator consumes the batch
            account("compute", compute_s)
            if tracer is not None:
                tracer.add_span(
                    "step", t0=clock.now - compute_s, dur=compute_s,
                    kind="compute", owner=self.job_id,
                )
            now = clock.now
            self.result.step_times.append(now - last_step_end)
            last_step_end = now
            if self.metrics:
                self.metrics.record_step(now, self.cal.batch_items)
            epoch_over = not pending or pending[0][0] != cur_epoch
            if epoch_over:
                self.result.epoch_times.append(now - epoch_t0)
                epoch_t0 = now
                if self.metrics:
                    self.metrics.mark_epoch(now)
        return self.result
