"""Multi-tenant workload engine: declarative job mixes over one shared cache.

The paper's value proposition is *cross-job* reuse: "subsequent epochs of the
same job and different invocations of jobs that share the same data
requirements, e.g. hyper-parameter tuning" (Section 1).  ``run_scenario``
exercises one dataset and N identical jobs; this module drives the regime the
paper actually targets — many jobs over a *catalog* of datasets, arriving
over time, contending for GPUs and cache capacity:

* :class:`WorkloadJob` — a declarative job spec: dataset, arrival time,
  epochs, node/GPU demand, backend and fill mode.
* :class:`ClusterScheduler` — the engine.  Each submitted job becomes a
  simulated process that (1) waits for its arrival time, (2) queues for free
  GPUs, (3) ensures its dataset is admitted — which may trigger real LRU
  eviction of idle datasets mid-simulation — then (4) runs a
  :class:`~repro_torch.core.loader.TrainingJob` and (5) releases GPUs and its
  dataset reader pin on exit, waking queued jobs.

Safety under concurrency comes from two CacheManager extensions this engine
relies on: *reader pins* (``acquire``/``release`` — a dataset some job is
iterating is never an eviction victim) and *fill-plane cancellation*
(evicting a FILLING dataset cancels its
:class:`~repro_torch.core.prefetch.FillTracker`, so in-flight remote transfers
cannot write into a freed or re-admitted stripe layout).

Determinism: everything runs on the :class:`~repro_torch.core.simclock.SimClock`
event heap, and per-job seeds default to :func:`stable_seed` (CRC32 of the
job id) — *not* Python's ``hash``, which is randomized per process and would
make benchmark numbers irreproducible across runs.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from .cache import CacheEvent, CacheFullError, CacheManager, CacheState
from .calibration import PAPER, ComputeModel, WorkloadCalibration, validate_compute
from .loader import (
    HoardBackend,
    HoardLoader,
    JobResult,
    LocalCopyBackend,
    RemoteBackend,
    TrainingJob,
)
from .metrics import ClusterMetrics
from .placement import JobSpec, PlacementEngine
from .prefetch import FillTracker, PrefetchScheduler
from .simclock import Event, SimClock
from .stripestore import StripeStore
from .telemetry import rollup_stalls
from .topology import Node, Topology
from .writeplane import WRITE_POLICIES, ChunkCodec, WritePlane

BACKENDS = ("hoard", "posix", "rem", "nvme")
FILL_MODES = ("afm", "ondemand", "prepopulated")

#: backends that read through the Hoard cache (admission + reader pins)
CACHED_BACKENDS = ("hoard", "posix")


def stable_seed(job_id: str) -> int:
    """Per-job seed component that survives process restarts.

    ``hash(str)`` is randomized by PYTHONHASHSEED, so two invocations of the
    same scenario in different processes would draw different epoch
    permutations — benchmark numbers would not reproduce.  CRC32 is stable.
    """
    return zlib.crc32(job_id.encode()) % 1000


@dataclass
class WorkloadJob:
    """Declarative job spec consumed by :class:`ClusterScheduler`."""

    job_id: str
    dataset_id: str
    arrival: float = 0.0                 # submission time (sim seconds)
    epochs: int = 2
    n_nodes: int = 1
    gpus_per_node: int = 4
    backend: str = "hoard"               # "hoard" | "rem" | "nvme"
    fill: str = "ondemand"               # "afm" | "ondemand" | "prepopulated"
    seed: Optional[int] = None           # None -> stable_seed(job_id)
    mdr: Optional[float] = None
    physical_copy: bool = False          # nvme backend: stream the copy for real
    cache_node_ids: Optional[Sequence[int]] = None    # explicit stripe placement
    compute_node_ids: Optional[Sequence[int]] = None  # forced compute placement
    prefetch_inflight: int = 8
    # None: this job drives the clairvoyant fill iff it cold-admitted the
    # dataset; True/False overrides (run_scenario pins job0 as the driver)
    fill_driver: Optional[bool] = None
    cal: Optional[WorkloadCalibration] = None  # None -> derived from the dataset
    # ---- compute plane: GPU-time model for this job's steps.
    # None keeps the paper's AlexNet constant (ConstantCompute); pass
    # RooflineCompute.from_roofline(arch, shape, mesh) for per-model time.
    compute: Optional[ComputeModel] = None
    # ---- checkpoint bursts: every compute node of the job
    # periodically writes ckpt_bytes through the write plane and fsyncs,
    # so checkpoint traffic contends with foreground ingest on the same
    # disks/NICs/up-links.  0 disables.
    ckpt_interval_s: float = 0.0
    ckpt_bytes: float = 0.0
    ckpt_policy: str = "writeback"       # "writeback" | "writethrough"
    # ---- partial caching: cache only the hottest fraction of the
    # dataset's chunks (None = whole dataset), and/or let an over-capacity
    # admission degrade to the largest chunk subset that fits instead of
    # failing; the rest of the dataset reads through to the remote store
    cache_fraction: Optional[float] = None
    allow_partial: bool = False

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.fill not in FILL_MODES:
            raise ValueError(f"unknown fill mode {self.fill!r}")
        if self.backend == "posix" and self.fill == "afm":
            # the AFM miss path models per-job residency inside the iterator
            # backend; the filesystem's miss fall-through is the shared
            # chunk-granular fill plane (use "ondemand" or "prepopulated")
            raise ValueError('backend "posix" supports fill="ondemand"|"prepopulated"')
        if self.ckpt_policy not in WRITE_POLICIES:
            raise ValueError(f"unknown ckpt_policy {self.ckpt_policy!r} (want {WRITE_POLICIES})")
        if self.ckpt_interval_s > 0:
            if self.backend not in CACHED_BACKENDS:
                raise ValueError(
                    "checkpoint bursts write through the cache; "
                    f'backend must be one of {CACHED_BACKENDS}, got {self.backend!r}'
                )
            if self.ckpt_bytes <= 0:
                raise ValueError("ckpt_interval_s > 0 requires ckpt_bytes > 0")
        if self.cache_fraction is not None and not 0.0 < self.cache_fraction <= 1.0:
            raise ValueError(
                f"cache_fraction must be in (0, 1], got {self.cache_fraction}"
            )
        validate_compute(self.compute, "WorkloadJob.compute")


@dataclass
class JobRecord:
    """Lifecycle + outcome of one submitted job."""

    spec: WorkloadJob
    phase: str = "submitted"   # submitted|queued-gpus|queued-cache|running|done
    nodes: list[int] = field(default_factory=list)
    taken: list[tuple[int, int]] = field(default_factory=list)  # (node, gpus held)
    started: Optional[float] = None      # when the TrainingJob began running
    finished: Optional[float] = None
    admitted_cold: bool = False          # this job triggered the dataset admission
    dataset_state_at_start: Optional[str] = None  # hoard: cache state when job began
    result: Optional[JobResult] = None
    ckpt_bursts: int = 0                 # completed checkpoint bursts (all nodes)

    @property
    def queued_s(self) -> float:
        """Seconds between arrival and the job actually starting."""
        if self.started is None:
            return float("inf")
        return self.started - self.spec.arrival


@dataclass
class WorkloadResult:
    records: list[JobRecord]
    metrics: ClusterMetrics
    sim_seconds: float
    cache_events: list[CacheEvent]

    @property
    def jobs(self) -> list[JobResult]:
        return [r.result for r in self.records if r.result is not None]

    def record(self, job_id: str) -> JobRecord:
        for r in self.records:
            if r.spec.job_id == job_id:
                return r
        raise KeyError(job_id)

    # ------------------------------------------------------ churn accounting
    def evictions(self) -> list[tuple[float, str]]:
        return [(e.t, e.dataset_id) for e in self.cache_events if e.op == "evict"]

    def readmissions(self) -> list[tuple[float, str]]:
        return [(e.t, e.dataset_id) for e in self.cache_events if e.op == "readmit"]

    def churned_datasets(self) -> set[str]:
        """Datasets evicted mid-simulation and later admitted again.

        A ``readmit`` event implies a prior ``evict`` (REGISTERED is only
        reachable again via eviction), so the readmission set IS the churn.
        """
        return {ds for _t, ds in self.readmissions()}

    # ------------------------------------------------------ stall telemetry
    def stall_rollup(self) -> dict:
        """Cluster-wide GPU-stall attribution over every finished job.

        Aggregates each job's ``JobResult.stall_breakdown`` into
        ``{"jobs", "seconds", "fractions"}`` (see telemetry.rollup_stalls).
        """
        return rollup_stalls(j.stall_breakdown for j in self.jobs)


class ClusterScheduler:
    """Drives a mix of :class:`WorkloadJob` s over one simulated cluster.

    The engine owns nothing the single-scenario path does not already have:
    it composes SimClock (time), PlacementEngine (GPUs + locality),
    CacheManager (dataset lifecycle) and the loader backends.  What it adds
    is the *contention protocol* between jobs: queueing for GPUs, waiting out
    cache pressure, reader pins and fill-plane handoff.
    """

    def __init__(
        self,
        clock: SimClock,
        topology: Topology,
        store: StripeStore,
        cache: CacheManager,
        placement: PlacementEngine,
        *,
        cal: WorkloadCalibration = PAPER,
        metrics: Optional[ClusterMetrics] = None,
    ):
        self.clock = clock
        self.topology = topology
        self.store = store
        self.cache = cache
        self.placement = placement
        self.cal = cal
        self.metrics = metrics if metrics is not None else ClusterMetrics()
        self.records: list[JobRecord] = []
        # one clairvoyant scheduler per filling dataset, shared by every job
        # reading that dataset (heartbeats pace it; see prefetch.py)
        self._schedulers: dict[str, PrefetchScheduler] = {}
        self._wake: Optional[Event] = None
        # one POSIX namespace per cluster, shared by every "posix" job's mount
        self._meta = None
        # elastic membership (repro_torch.core.rebalance): created lazily by
        # scale_event / the rebalancer property; None until the first use so
        # fixed-membership scenarios stay byte-identical to the pre-elastic
        # engine (an attached rebalancer changes placement scoring inputs)
        self._rebalancer = None

    def _metadata(self):
        if self._meta is None:
            from ..fs import MetadataService   # local: avoid import cycle

            self._meta = MetadataService(self.store)
        return self._meta

    # --------------------------------------------------- elastic membership
    @property
    def rebalancer(self):
        """The cluster's elastic-membership controller (created on demand)."""
        if self._rebalancer is None:
            from .rebalance import Rebalancer      # local: avoid import cycle

            self._rebalancer = Rebalancer(self.clock, self.topology, self.cache)
        return self._rebalancer

    def configure_rebalancer(self, **kw):
        """Create the rebalancer with explicit knobs (bw cap, membership)."""
        from .rebalance import Rebalancer

        if self._rebalancer is not None:
            raise RuntimeError("rebalancer already created")
        self._rebalancer = Rebalancer(self.clock, self.topology, self.cache, **kw)
        return self._rebalancer

    def scale_event(
        self,
        at: float,
        *,
        add: Sequence[int] = (),
        remove: Sequence[int] = (),
        fail: Sequence[int] = (),
    ) -> Event:
        """Schedule a cache-tier membership change at sim time ``at``.

        ``add``/``remove``/``fail`` are node ids; at ``at`` the rebalancer
        applies them in that order, each kicking off background re-striping
        that contends with (and is throttled against) whatever jobs are
        running.  Returns an event fired when every triggered rebalance has
        committed — the workload-engine surface for scale-out/scale-in
        scenarios (``benchmarks/rebalance.py``, ``examples/elastic_cache.py``).
        """
        rb = self.rebalancer
        done = self.clock.event()

        def fire():
            events = []
            for nid in add:
                events.append(rb.add_node(nid))
            for nid in remove:
                events.append(rb.remove_node(nid))
            for nid in fail:
                events.append(rb.fail_node(nid))
            self.clock.all_of(events).on_fire(done.set)

        self.clock.schedule(max(0.0, at - self.clock.now), fire)
        return done

    # ------------------------------------------------------ stall telemetry
    def stall_rollup(self) -> dict:
        """Cluster-wide GPU-stall attribution over jobs finished so far."""
        return rollup_stalls(
            r.result.stall_breakdown for r in self.records if r.result is not None
        )

    # ----------------------------------------------------------- wake-up bus
    def _turnstile(self) -> Event:
        """Event fired whenever a job exits (GPUs and a reader pin freed)."""
        if self._wake is None or self._wake.fired:
            self._wake = self.clock.event()
        return self._wake

    def _notify(self) -> None:
        if self._wake is not None and not self._wake.fired:
            self._wake.set()

    # -------------------------------------------------------------- plumbing
    def job_cal(self, spec: WorkloadJob) -> WorkloadCalibration:
        """Per-job calibration: dataset geometry comes from the catalog."""
        if spec.cal is not None:
            return spec.cal
        dspec = self.cache.entries[spec.dataset_id].spec
        if (
            self.cal.dataset_items == dspec.n_items
            and self.cal.dataset_bytes == float(dspec.total_bytes)
        ):
            return self.cal
        return replace(
            self.cal,
            dataset_bytes=float(dspec.total_bytes),
            dataset_items=dspec.n_items,
        )

    def submit(self, spec: WorkloadJob) -> JobRecord:
        if spec.dataset_id not in self.cache.entries:
            raise KeyError(
                f"job {spec.job_id!r}: dataset {spec.dataset_id!r} not in the "
                f"catalog; CacheManager.register() it first"
            )
        rec = JobRecord(spec=spec)
        self.records.append(rec)
        self.clock.process(self._job_proc(spec, rec))
        return rec

    def run(
        self, jobs: Optional[Sequence[WorkloadJob]] = None, *, strict: bool = True
    ) -> WorkloadResult:
        """Submit ``jobs``, drain the simulation, return per-job records."""
        for spec in jobs or ():
            self.submit(spec)
        self.clock.run()
        stuck = [r for r in self.records if r.phase != "done"]
        if stuck and strict:
            detail = ", ".join(f"{r.spec.job_id}[{r.phase}]" for r in stuck)
            raise RuntimeError(
                f"simulation drained with {len(stuck)} unfinished jobs: {detail} "
                f"(starved for GPUs or cache capacity?)"
            )
        return WorkloadResult(
            records=list(self.records),
            metrics=self.metrics,
            sim_seconds=self.clock.now,
            cache_events=list(self.cache.events),
        )

    # ------------------------------------------------------- the job process
    def _job_proc(self, spec: WorkloadJob, rec: JobRecord):
        clock = self.clock
        if spec.arrival > clock.now:
            yield clock.sleep(spec.arrival - clock.now)

        # ---- phases 1+2: GPUs, then dataset residency.  If the dataset
        # cannot be admitted yet (cache full, nothing evictable), the GPUs
        # are RELEASED while waiting — holding them in queued-cache would
        # head-of-line-block jobs whose data is already resident.
        tracker = scheduler = None
        while True:
            rec.phase = "queued-gpus"
            nodes = yield from self._acquire_nodes(spec, rec)
            if spec.backend not in CACHED_BACKENDS:
                break
            wired = self._try_ensure_dataset(spec, rec, nodes)
            if wired is not None:
                tracker, scheduler = wired
                break
            self._release_nodes(rec)
            rec.phase = "queued-cache"
            yield self._turnstile()                    # a job exit may unpin
        rec.nodes = [n.node_id for n in nodes]

        # ---- phase 3: run the training job
        rec.phase = "running"
        rec.started = clock.now
        cal = self.job_cal(spec)
        jm = self.metrics.job(spec.job_id)
        node = nodes[0]
        if spec.backend == "rem":
            be = RemoteBackend(clock, self.topology, node, cal, mdr=spec.mdr, metrics=jm)
        elif spec.backend == "nvme":
            be = LocalCopyBackend(
                clock, self.topology, node, cal, mdr=spec.mdr,
                physical_copy=spec.physical_copy, metrics=jm,
            )
        elif spec.backend == "posix":
            # the POSIX-façade path: same cache, same fill plane, but the job
            # reads /hoard/... shard files through a per-node HoardFS mount
            from ..fs import FileDataset, HoardFS   # local: avoid import cycle

            fs = HoardFS(
                clock, self.topology, self.cache, self._metadata(), node,
                cal=cal, mdr=spec.mdr, metrics=jm,
            )
            be = FileDataset(
                fs, f"/hoard/{spec.dataset_id}", cal=cal, mdr=spec.mdr,
                fill_plane=tracker,
                prefetcher=self._schedulers.get(spec.dataset_id),
            )
        else:
            be = HoardBackend(
                clock, self.topology, node, cal, cache=self.cache,
                dataset_id=spec.dataset_id, mdr=spec.mdr, metrics=jm,
                fill_plane=tracker, prefetcher=self._schedulers.get(spec.dataset_id),
            )
        seed = spec.seed if spec.seed is not None else stable_seed(spec.job_id)
        loader = HoardLoader(be, cal, epochs=spec.epochs, seed=seed)
        job = TrainingJob(
            spec.job_id, clock, loader, cal, metrics=jm, compute=spec.compute
        )
        if scheduler is not None:
            # clairvoyant: this job cold-admitted the dataset, so its epoch-0
            # permutation defines the fill's first-touch order (NoPFS)
            scheduler.start(loader.plan.order(0))
        if spec.ckpt_interval_s > 0:
            # checkpoint bursts from every compute node: each node
            # gets its own WritePlane and a disjoint chunk lane; each burst
            # proc holds its own reader pin until its dirty data has flushed
            codec = ChunkCodec.from_calibration(cal)
            for lane, wn in enumerate(nodes):
                wp = WritePlane(
                    clock, self.topology, self.cache, spec.dataset_id, wn,
                    policy=spec.ckpt_policy, codec=codec, metrics=jm,
                )
                clock.process(self._ckpt_proc(spec, rec, wp, lane, len(nodes)))
        rec.result = yield job.start()

        # ---- phase 4: teardown — free GPUs + reader pin, wake queued jobs
        rec.finished = clock.now
        # stall attribution: time between submission and actually starting
        # (GPU queue + cache-admission retries) is the GPUs never running at
        # all — the "admission-block" class of the telemetry taxonomy
        queued = rec.started - spec.arrival
        if queued > 0 and rec.result is not None:
            bd = rec.result.stall_breakdown
            bd["admission-block"] = bd.get("admission-block", 0.0) + queued
        self._release_nodes(rec)
        if spec.backend == "posix":
            be.close()                      # drop per-handle reader pins
        if spec.backend in CACHED_BACKENDS:
            self.cache.release(spec.dataset_id)
        rec.phase = "done"
        self._notify()

    # ---------------------------------------------------- checkpoint bursts
    def _ckpt_proc(self, spec: WorkloadJob, rec: JobRecord, wplane, lane: int, n_lanes: int):
        """Periodic checkpoint bursts from one compute node of a running job.

        Holds an extra reader pin for its whole lifetime: a dataset with
        buffered or dirty checkpoint bytes must not become an eviction victim
        (the CacheManager guard would refuse anyway, but the pin keeps the
        engine's queued-cache retry loop from spinning on it).  On job exit
        the proc drains the write-back flusher before unpinning, so the
        dataset is evictable again only once every fsync'd byte reached the
        remote store.
        """
        clock = self.clock
        ds = spec.dataset_id
        self.cache.acquire(ds)
        # write-path latency attribution: seconds this proc spent blocked on
        # write_burst (buffer+fsync) and the final drain.  Bursts overlap the
        # foreground job's compute, so these are *accounted* write-drain
        # seconds, not extra wall-clock — the stall rollup normalises.
        wait_s = 0.0
        try:
            while rec.finished is None:
                yield clock.sleep(spec.ckpt_interval_s)
                if rec.finished is not None or ds not in self.store.manifests:
                    break
                if not self.cache.is_cached(ds):
                    continue                   # no checkpoints into a mid-fill stripe
                t0 = clock.now
                yield wplane.write_burst(spec.ckpt_bytes, lane=lane, n_lanes=n_lanes)
                wait_s += clock.now - t0
                rec.ckpt_bursts += 1
            t0 = clock.now
            yield wplane.drain()
            wait_s += clock.now - t0
        finally:
            if wait_s > 0 and rec.result is not None:
                bd = rec.result.stall_breakdown
                bd["write-drain"] = bd.get("write-drain", 0.0) + wait_s
            self.cache.release(ds)
            self._notify()

    def _release_nodes(self, rec: JobRecord) -> None:
        for node_id, gpus in rec.taken:
            self.placement.inventory.release(self.topology.node(node_id), gpus)
        rec.taken = []

    # ------------------------------------------------------------ GPU queue
    def _acquire_nodes(self, spec: WorkloadJob, rec: JobRecord):
        if spec.compute_node_ids is not None:
            # forced placement (misplacement studies): take what is free and
            # proceed regardless — the caller is overriding the scheduler
            nodes = [self.topology.node(i) for i in spec.compute_node_ids]
            for n in nodes:
                if self.placement.inventory.take(n, spec.gpus_per_node):
                    rec.taken.append((n.node_id, spec.gpus_per_node))
            return nodes
        jspec = JobSpec(
            spec.job_id, spec.dataset_id,
            n_nodes=spec.n_nodes, gpus_per_node=spec.gpus_per_node,
        )
        while True:
            placement = self.placement.try_place(jspec)
            if placement is not None:
                rec.taken = [
                    (n.node_id, spec.gpus_per_node) for n in placement.compute_nodes
                ]
                return placement.compute_nodes
            yield self._turnstile()                    # a job exit frees GPUs

    # -------------------------------------------------------- dataset admit
    def _try_ensure_dataset(self, spec: WorkloadJob, rec: JobRecord, nodes: list[Node]):
        """One attempt to make the dataset resident and pin it for reading.

        Returns ``(tracker, scheduler)`` on success (reader pin taken), or
        ``None`` when the cache is full and nothing on the target nodes is
        evictable right now — the caller releases its GPUs and retries after
        the next job exit.  No yields: admission + reader pin are atomic
        within one process step.
        """
        ds = spec.dataset_id
        entry = self.cache.entries[ds]
        if entry.state is CacheState.REGISTERED:
            if spec.cache_node_ids is not None:
                cnodes = [self.topology.node(i) for i in spec.cache_node_ids]
            else:
                # chunk-rounded, replication-inclusive — what admit() charges
                # (scaled down when the job asks for fractional caching)
                need = self.cache.bytes_needed(ds)
                if spec.cache_fraction is not None:
                    need *= spec.cache_fraction
                cnodes = self.placement.choose_cache_nodes(need, near=nodes)
                if not cnodes:
                    # every node is full: stripe over the whole cluster and
                    # let admit() evict its way to capacity
                    cnodes = list(self.topology.nodes)
            try:
                self.cache.admit(
                    ds, cnodes,
                    on_demand=(spec.fill == "ondemand"),
                    fraction=spec.cache_fraction,
                    degrade_to_partial=spec.allow_partial,
                )
                rec.admitted_cold = True
                if spec.fill == "prepopulated":
                    self.cache.mark_filled(ds)
            except CacheFullError:
                return None

        tracker = scheduler = None
        if self.cache.is_cached(ds):
            # fill already complete: jobs take the plain cached read path;
            # drop any finished clairvoyant scheduler for this dataset
            self._schedulers.pop(ds, None)
        elif spec.fill == "ondemand":
            plane = entry.fill_plane
            if plane is not None and not plane.cancelled:
                tracker = plane
            elif entry.state is CacheState.FILLING:
                tracker = FillTracker(
                    self.clock, self.topology, self.cache, ds,
                    metrics=self.metrics.job(f"fill:{ds}"),
                )
            drive = spec.fill_driver if spec.fill_driver is not None else rec.admitted_cold
            if tracker is not None and drive:
                scheduler = PrefetchScheduler(tracker, max_inflight=spec.prefetch_inflight)
                self._schedulers[ds] = scheduler
        self.cache.acquire(ds)                         # reader pin: no eviction
        rec.dataset_state_at_start = entry.state.value
        return tracker, scheduler
