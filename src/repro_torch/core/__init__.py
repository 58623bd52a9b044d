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
* ``build_cluster``                        — the paper's cluster in one call

Not ported yet: the elastic rebalancer, the multi-tenant workload engine
with ``run_scenario``, and ``RooflineCompute``.
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
from .calibration import PAPER, ComputeModel, ConstantCompute, WorkloadCalibration
from .cluster import build_cluster
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
from .writeplane import (
    WRITE_BACK,
    WRITE_POLICIES,
    WRITE_THROUGH,
    ChunkCodec,
    WritePlane,
)

__all__ = [
    "AllOf", "CacheEntry", "CacheEvent", "CacheFullError", "CacheManager",
    "CacheState", "ChunkCodec", "ChunkCorruption", "ClusterMetrics",
    "ComputeModel", "ConstantCompute", "DatasetSpec", "DatasetStat", "Event",
    "EvictionPolicy", "FillTracker", "FlowTag", "HoardBackend", "HoardLoader",
    "JobMetrics", "JobResult", "JobSpec", "LRUCache", "LRUStackModel",
    "LocalCopyBackend", "MANIFEST_SCHEMA_VERSION", "Node", "PAPER", "PagePool",
    "Placement", "PlacementEngine", "PrefetchScheduler", "ReadScheduler",
    "RemoteBackend", "Resource", "ResourceSampler", "STALL_CLASSES", "SimClock",
    "StripeDataPlane", "StripeError", "StripeManifest", "StripeStore", "Telemetry",
    "Topology", "TopologyConfig", "Tracer", "TrainingJob", "WRITE_BACK",
    "WRITE_POLICIES", "WRITE_THROUGH", "WorkloadCalibration", "WritePlane",
    "buffer_cache_items", "build_cluster", "rollup_stalls",
]
