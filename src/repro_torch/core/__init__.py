"""Hoard core, ported: the dataset-granular cache that feeds training.

The framework-free modules of ``repro.core`` copied unchanged in their
arithmetic, hashes and float order, so the same calls give the same chunk
files, CRCs, manifests, replica choices and simulated clock times:

* ``SimClock`` / ``Resource``             — discrete-event fabric (both flow engines)
* ``Topology`` / ``TopologyConfig``        — nodes, racks, links, remote store
* ``StripeStore``                          — chunked, striped, replicated store
* ``CacheManager`` / ``DatasetSpec``       — dataset-granularity lifecycle
* ``PlacementEngine`` / ``JobSpec``        — data/compute co-scheduling
* ``HoardLoader`` + backends               — transparent iterators
* ``FillTracker`` / ``WritePlane``         — fill and write planes under HoardFS
* ``Telemetry`` / ``Tracer``               — flow spans, timelines, stall classes
* ``Rebalancer`` / ``MembershipEpoch``     — elastic membership + online re-striping
* ``ClusterScheduler`` / ``WorkloadJob``   — the multi-tenant workload engine
* ``run_scenario`` / ``build_cluster``     — one-call experiment harness
* ``ConstantCompute`` / ``RooflineCompute`` — the compute plane: the paper's
  AlexNet constant, or a step priced by the port's H100 roofline table (or
  measured on the card)
"""

from .cache import (
    CacheEntry,
    CacheEvent,
    CacheFullError,
    CacheManager,
    CacheState,
    DatasetSpec,
    DatasetStat,
    EvictionPolicy,
)
from .calibration import (
    PAPER,
    ComputeModel,
    ConstantCompute,
    RooflineCompute,
    WorkloadCalibration,
)
from .cluster import ScenarioConfig, ScenarioResult, build_cluster, run_scenario
from .loader import (
    HoardBackend,
    HoardLoader,
    JobResult,
    LocalCopyBackend,
    RemoteBackend,
    StripeDataPlane,
    TrainingJob,
)
from .metrics import ClusterMetrics, JobMetrics
from .placement import JobSpec, Placement, PlacementEngine
from .prefetch import FillTracker, PrefetchScheduler
from .readsched import ReadScheduler
from .rebalance import (
    ChunkMove,
    MembershipEpoch,
    RebalanceError,
    RebalancePlan,
    Rebalancer,
)
from .simclock import AllOf, Event, Resource, SimClock
from .stripestore import (
    MANIFEST_SCHEMA_VERSION,
    ChunkCorruption,
    StripeError,
    StripeManifest,
    StripeStore,
)
from .telemetry import (
    STALL_CLASSES,
    FlowTag,
    ResourceSampler,
    Telemetry,
    Tracer,
    rollup_stalls,
)
from .tiers import LRUCache, LRUStackModel, PagePool, buffer_cache_items
from .topology import Node, Topology, TopologyConfig
from .workload import (
    ClusterScheduler,
    JobRecord,
    WorkloadJob,
    WorkloadResult,
    stable_seed,
)
from .writeplane import (
    WRITE_BACK,
    WRITE_POLICIES,
    WRITE_THROUGH,
    ChunkCodec,
    WritePlane,
)

__all__ = [
    "AllOf", "CacheEntry", "CacheEvent", "CacheFullError", "CacheManager",
    "CacheState", "ChunkCodec", "ChunkCorruption", "ChunkMove", "ClusterMetrics",
    "ClusterScheduler", "ComputeModel", "ConstantCompute", "DatasetSpec", "DatasetStat",
    "Event", "EvictionPolicy", "FillTracker", "FlowTag", "HoardBackend", "HoardLoader",
    "JobMetrics", "JobRecord", "JobResult", "JobSpec", "LRUCache", "LRUStackModel",
    "LocalCopyBackend", "MANIFEST_SCHEMA_VERSION", "MembershipEpoch", "Node", "PAPER",
    "PagePool", "Placement", "PlacementEngine", "PrefetchScheduler", "ReadScheduler",
    "RebalanceError", "RebalancePlan", "Rebalancer", "RemoteBackend", "Resource",
    "ResourceSampler", "RooflineCompute", "STALL_CLASSES", "ScenarioConfig", "ScenarioResult",
    "SimClock", "StripeDataPlane", "StripeError", "StripeManifest", "StripeStore", "Telemetry",
    "Topology", "TopologyConfig", "Tracer", "TrainingJob", "WRITE_BACK", "WRITE_POLICIES",
    "WRITE_THROUGH", "WorkloadCalibration", "WorkloadJob", "WorkloadResult", "WritePlane",
    "buffer_cache_items", "build_cluster", "rollup_stalls", "run_scenario", "stable_seed",
]
