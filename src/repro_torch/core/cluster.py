"""Scenario harness: build the paper's cluster and run REM/NVMe/Hoard jobs.

The JAX package's ``core/cluster.py``, copied bit for bit in its arithmetic
(``build_cluster``, ``ScenarioConfig``, ``ScenarioResult``,
``run_scenario``), so the same scenario gives the same epoch times and
stall breakdowns; with ``compute=RooflineCompute(...)`` its GPU time is the
port's H100 price of a step, or a step measured on the card.

One call — ``run_scenario(ScenarioConfig(backend="hoard", epochs=2))`` —
constructs the 4-node/4-GPU-per-node cluster of Table 2 (or any other
topology), registers the ImageNet-like dataset and hands N identical jobs to
the multi-tenant workload engine (:mod:`repro_torch.core.workload`), which places
them, runs the discrete-event simulation and returns per-job results +
metrics.  Every benchmark module is a thin wrapper over this; this, in turn,
is a thin single-dataset wrapper over
:class:`~repro_torch.core.workload.ClusterScheduler`.

:class:`ScenarioConfig` is the typed scenario description (every knob is a
field with a default); the legacy flat-kwargs call form
``run_scenario("hoard", epochs=2, ...)`` still works but emits a
``DeprecationWarning`` — see docs/api.md for the migration table.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from .cache import CacheManager, DatasetSpec, EvictionPolicy
from .calibration import PAPER, ComputeModel, WorkloadCalibration, validate_compute
from .loader import JobResult
from .metrics import ClusterMetrics
from .placement import PlacementEngine
from .simclock import SimClock
from .stripestore import StripeStore
from .telemetry import Telemetry
from .topology import Topology, TopologyConfig
from .workload import (
    CACHED_BACKENDS,
    ClusterScheduler,
    WorkloadJob,
    WorkloadResult,
    stable_seed,
)


@dataclass
class ScenarioResult:
    backend: str
    jobs: list[JobResult]
    metrics: ClusterMetrics
    sim_seconds: float
    cal: WorkloadCalibration = field(default_factory=lambda: PAPER)
    workload: Optional[WorkloadResult] = None   # full engine records/events
    # the scenario's stripe store — benchmarks read its contention-aware
    # read scheduler (per-replica served bytes, queue telemetry) post-run
    store: Optional[StripeStore] = None
    # attached telemetry hub (run_scenario(telemetry=True)): flow spans,
    # resource timelines; None when the scenario ran un-instrumented
    telemetry: Optional[Telemetry] = None

    @property
    def mean_epoch_times(self) -> list[float]:
        """Element-wise mean epoch time across jobs."""
        n_ep = min(len(j.epoch_times) for j in self.jobs)
        return [
            sum(j.epoch_times[e] for j in self.jobs) / len(self.jobs) for e in range(n_ep)
        ]

    @property
    def total_time(self) -> float:
        return max(j.total_s for j in self.jobs)


@dataclass
class ScenarioConfig:
    """Typed description of one scenario run (the knobs of ``run_scenario``).

    Every field mirrors a knob of the legacy flat-kwargs signature under the
    same name (plus ``engine``, new with the vectorized simclock); defaults
    reproduce the paper's measured configuration.  See the ``run_scenario``
    docstring for the semantics of each knob and docs/api.md for the
    kwargs-to-field migration table.
    """

    backend: str                               # "hoard" | "posix" | "rem" | "nvme"
    epochs: int = 2
    n_jobs: int = 4
    topo_cfg: Optional[TopologyConfig] = None  # None -> paper's 4-node cluster
    cal: WorkloadCalibration = PAPER
    mdr: Optional[float] = None                # memory/dataset ratio (Figure 4)
    remote_bw_scale: float = 1.0               # NFS throttle (Figure 5 x-axis)
    physical_copy: bool = False                # nvme: stream the staging copy
    cache_nodes: Optional[Sequence[int]] = None
    job_nodes: Optional[Sequence[int]] = None
    prefetch: bool = False                     # paper's async pre-fetch model
    fill: str = "afm"                          # "afm" | "prepopulated" | "ondemand"
    prefetch_inflight: int = 8
    seed: int = 0
    replication: int = 1
    capacity_per_node: float = 1e12            # NVMe cache bytes per node
    cache_fraction: Optional[float] = None     # partial caching
    allow_partial: bool = False
    items_per_chunk: Optional[int] = None
    telemetry: bool = False                    # attach a Telemetry hub
    engine: Optional[str] = None               # simclock flow engine ("vector")
    # compute plane: GPU-time model applied to every job.  None
    # keeps the paper's AlexNet constant (bit-identical baselines); pass
    # RooflineCompute.from_roofline(arch, shape, mesh) for per-model time.
    compute: Optional[ComputeModel] = None

    def __post_init__(self):
        if self.fill not in ("afm", "prepopulated", "ondemand"):
            raise ValueError(f"unknown fill mode {self.fill!r}")
        if self.prefetch and self.fill != "afm":
            # prefetch books a whole-dataset transfer + mark_filled of its
            # own; combining it with another fill model double-streams
            raise ValueError(f"prefetch=True conflicts with fill={self.fill!r}")
        validate_compute(self.compute, "ScenarioConfig.compute")


def build_cluster(
    topo_cfg: Optional[TopologyConfig] = None,
    *,
    cal: WorkloadCalibration = PAPER,
    capacity_per_node: float = 1e12,
    policy: EvictionPolicy = EvictionPolicy.LRU,
    replication: int = 1,
    items_per_chunk: Optional[int] = None,
    engine: Optional[str] = None,
):
    clock = SimClock(engine=engine)
    topo = Topology(topo_cfg or TopologyConfig(), clock)
    store = StripeStore(topo)
    kw = {} if items_per_chunk is None else {"items_per_chunk": items_per_chunk}
    cache = CacheManager(
        topo,
        store,
        clock,
        capacity_per_node=capacity_per_node,
        policy=policy,
        fill_bw=cal.fill_bw,
        replication=replication,
        **kw,
    )
    engine = PlacementEngine(topo, cache)
    return clock, topo, store, cache, engine


def run_scenario(config=None, /, **kwargs) -> ScenarioResult:
    """Run ``cfg.n_jobs`` identical jobs over the chosen data path.

    Primary form: ``run_scenario(ScenarioConfig(backend="hoard", ...))``.
    The legacy flat form ``run_scenario("hoard", epochs=2, ...)`` (or
    ``run_scenario(backend="hoard", ...)``) still works — it builds the same
    :class:`ScenarioConfig` and emits a ``DeprecationWarning`` — and is
    bit-identical to the typed form (the equivalence suite asserts it).

    ``remote_bw_scale`` scales the NFS stream+NIC rates (Figure 5's x-axis);
    ``mdr`` sets the memory/dataset ratio (Figure 4); ``cache_nodes`` /
    ``job_nodes`` override placement (Section 4.5 misplacement study);
    ``prefetch`` pre-populates the cache before the jobs start (the paper's
    asynchronous pre-fetch usage model); ``replication`` stripes each chunk
    onto that many nodes — the contention-aware read scheduler then spreads
    replica reads by live queue depth (headline reproduction runs r=2).

    ``fill`` selects the Hoard cold-start model (ignored for rem/nvme):

    * ``"afm"``          — per-job AFM miss path, the paper's measured
                           configuration (each cold job streams the dataset),
    * ``"prepopulated"`` — cache warmed before t=0 (prefetch completed ahead
                           of job submission; epoch 1 == steady state),
    * ``"ondemand"``     — shared chunk-granular fill during epoch 1:
                           clairvoyant prefetch scheduler + read-through
                           (remote store touched once per chunk, cluster-wide).

    Partial caching: ``capacity_per_node`` bounds the NVMe cache
    (the benchmarks' cache:dataset-ratio knob), ``cache_fraction`` caches
    only the hottest fraction of chunks, and ``allow_partial`` degrades an
    over-capacity admission to the largest chunk subset that fits instead of
    raising ``CacheFullError``; non-resident chunks read through to remote.
    ``items_per_chunk`` overrides the cache's chunk granularity (sweeps over
    small cache:dataset ratios need finer chunks than the 4096-item default).

    ``telemetry=True`` attaches a :class:`~repro_torch.core.telemetry.Telemetry`
    hub before any job runs: every flow becomes a traced span, the shared
    fabric links (remote NIC, core, up-links, node NICs/NVMe, disk queues)
    get busy/queued timelines, and each ``JobResult`` carries its
    ``stall_breakdown``; the hub is returned on ``ScenarioResult.telemetry``.

    ``engine`` selects the simclock flow engine (``"vector"`` default,
    ``"scalar"`` reference — see :mod:`repro_torch.core.simclock`); results are
    bit-identical either way.
    """
    if isinstance(config, ScenarioConfig):
        if kwargs:
            raise TypeError(
                f"run_scenario(ScenarioConfig, ...) takes no extra keyword "
                f"arguments, got {sorted(kwargs)}; set them as config fields"
            )
        cfg = config
    else:
        warnings.warn(
            "run_scenario(backend, **kwargs) is deprecated; pass a "
            "ScenarioConfig instead: run_scenario(ScenarioConfig(backend=..., "
            "...)) — see docs/api.md for the field mapping",
            DeprecationWarning,
            stacklevel=2,
        )
        if config is not None:
            kwargs["backend"] = config
        cfg = ScenarioConfig(**kwargs)
    return _run_config(cfg)


def _run_config(cfg: ScenarioConfig) -> ScenarioResult:
    backend = cfg.backend
    cal = cfg.cal
    fill = cfg.fill
    cache_fraction = cfg.cache_fraction
    allow_partial = cfg.allow_partial
    job_nodes = cfg.job_nodes
    topo_cfg = cfg.topo_cfg or TopologyConfig()
    if cfg.remote_bw_scale != 1.0:
        # Figure 5: the tc tool throttles the NFS NIC; per-stream service and
        # the AFM fill path (remote-fed) scale with it, local paths do not
        cal = replace(
            cal,
            rem_miss_bw=cal.rem_miss_bw * cfg.remote_bw_scale,
            fill_bw=cal.fill_bw * cfg.remote_bw_scale,
        )
        topo_cfg = replace(
            topo_cfg, remote_nic_bw=topo_cfg.remote_nic_bw * cfg.remote_bw_scale
        )
    clock, topo, store, cache, engine = build_cluster(
        topo_cfg, cal=cal, replication=cfg.replication,
        capacity_per_node=cfg.capacity_per_node,
        items_per_chunk=cfg.items_per_chunk, engine=cfg.engine,
    )
    metrics = ClusterMetrics()
    tel = None
    if cfg.telemetry:
        sample = [topo.remote_nic, topo.core]
        sample += [topo.rack_uplink_tx[r] for r in sorted(topo.rack_uplink_tx)]
        sample += [topo.rack_uplink_rx[r] for r in sorted(topo.rack_uplink_rx)]
        for n in topo.nodes:
            sample += [n.nic_tx, n.nic_rx, n.nvme]
        for nid in sorted(store.readsched.disks):
            sample += store.readsched.disks[nid]
        tel = Telemetry(clock, sample=sample)

    spec = DatasetSpec("imagenet", "nfs://store/imagenet", cal.dataset_items, int(cal.item_bytes))
    cache.register(spec)

    # ---- placement: paper default = 1 job per node, dataset striped on all
    cached_backend = backend in CACHED_BACKENDS
    cache_nodes = cfg.cache_nodes
    if cache_nodes is None:
        cache_nodes = [n.node_id for n in topo.nodes[:4]] if cached_backend else []
    cnodes = [topo.node(i) for i in cache_nodes] if cache_nodes else []

    # fill-mode validation lives in ScenarioConfig.__post_init__
    if cached_backend:
        # the scenario contract: the dataset is admitted at t=0, before any
        # job runs.  For fill="ondemand" the engine wires the fill plane:
        # job0 (fill_driver) creates the FillTracker + clairvoyant schedule
        # when it finds the dataset FILLING with no plane attached.
        cache.admit(
            "imagenet", cnodes,
            on_demand=(fill == "ondemand"),
            fraction=cache_fraction,
            degrade_to_partial=allow_partial,
        )
        if fill == "prepopulated":
            cache.mark_filled("imagenet")
        if cfg.prefetch:
            cache.prefetch("imagenet", cnodes)

    scheduler = ClusterScheduler(clock, topo, store, cache, engine, cal=cal, metrics=metrics)
    jobs = []
    for j in range(cfg.n_jobs):
        job_id = f"job{j}"
        jobs.append(
            WorkloadJob(
                job_id=job_id,
                dataset_id="imagenet",
                arrival=0.0,
                epochs=cfg.epochs,
                n_nodes=1,
                gpus_per_node=4,
                backend=backend,
                fill=fill,
                seed=cfg.seed + stable_seed(job_id),
                mdr=cfg.mdr,
                physical_copy=cfg.physical_copy,
                compute_node_ids=(
                    [job_nodes[j % len(job_nodes)]] if job_nodes is not None else None
                ),
                prefetch_inflight=cfg.prefetch_inflight,
                fill_driver=(j == 0 and fill == "ondemand"),
                cal=cal,
                cache_fraction=cache_fraction,
                allow_partial=allow_partial,
                compute=cfg.compute,
            )
        )
    wl = scheduler.run(jobs)
    return ScenarioResult(
        backend, wl.jobs, metrics, clock.now, cal, workload=wl, store=store,
        telemetry=tel,
    )
