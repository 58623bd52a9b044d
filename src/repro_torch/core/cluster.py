"""The paper's cluster in one call: ``build_cluster``.

Builds the 4-node/4-GPU-per-node cluster of Table 2 (or any other topology):
the simulated clock, the topology, the stripe store, the cache manager and
the placement engine, as ``repro.core.cluster.build_cluster`` builds them,
so the same arguments give the same objects, chunk files and clock times.
The scenario harness of that module (``run_scenario``, ``ScenarioConfig``)
drives the multi-tenant workload engine and is not part of the port yet.
"""

from __future__ import annotations

from typing import Optional

from .cache import CacheManager, EvictionPolicy
from .calibration import PAPER, WorkloadCalibration
from .placement import PlacementEngine
from .simclock import SimClock
from .stripestore import StripeStore
from .topology import Topology, TopologyConfig


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
