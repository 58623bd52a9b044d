"""Placement engine: co-scheduling of datasets and DL jobs (Requirement 3).

The scheduler picks (a) the cache-node subset for a dataset and (b) the
compute nodes for each job *together*, maximising locality in the order
node-local > rack-local > pod-local > cross-pod, exactly the policy the paper
argues for in Section 4.5.  It also provides the rack-uplink analysis behind
Table 5: the fraction of TOR up-link bandwidth consumed by jobs scheduled on
racks that do not hold their dataset's stripes.

Like the paper, placement emits *decisions* (labels); executing them is the
runtime's business.  GPU inventory is tracked so multi-tenant contention
(space-sharing a node's GPUs while its disk is full — the problem story of
Section 1) is representable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from .cache import CacheManager
from .topology import Gb, Node, Topology


@dataclass
class JobSpec:
    job_id: str
    dataset_id: str
    n_nodes: int = 1
    gpus_per_node: int = 4
    # average ingest demand of the job, bytes/s (used for uplink accounting);
    # Table-5 calibration: the paper assumes ~2.67 Gb/s per misplaced job
    ingest_bw: float = 2.67 * Gb


@dataclass
class Placement:
    job: JobSpec
    compute_nodes: list[Node]
    cache_nodes: list[Node]
    locality: dict[str, int] = field(default_factory=dict)  # node-name -> distance

    @property
    def misplaced(self) -> bool:
        """True when no compute node shares a rack with any stripe."""
        racks = {n.rack_id for n in self.cache_nodes}
        return all(n.rack_id not in racks for n in self.compute_nodes)


class GPUInventory:
    def __init__(self, topology: Topology, gpus_per_node: int = 4):
        self.free = {n.node_id: gpus_per_node for n in topology.nodes}
        self.gpus_per_node = gpus_per_node

    def take(self, node: Node, gpus: int) -> bool:
        if self.free[node.node_id] < gpus:
            return False
        self.free[node.node_id] -= gpus
        return True

    def release(self, node: Node, gpus: int) -> None:
        self.free[node.node_id] = min(self.gpus_per_node, self.free[node.node_id] + gpus)


class PlacementEngine:
    def __init__(self, topology: Topology, cache: CacheManager, gpus_per_node: int = 4):
        self.topology = topology
        self.cache = cache
        self.inventory = GPUInventory(topology, gpus_per_node)

    # ------------------------------------------------------------ cache nodes
    def _members(self) -> Optional[set]:
        """Live cache-tier membership, or None when the tier is not elastic."""
        rb = getattr(self.cache, "rebalancer", None)
        return rb.members if rb is not None else None

    def choose_cache_nodes(
        self,
        total_bytes: float,
        *,
        count: Optional[int] = None,
        near: Optional[Sequence[Node]] = None,
    ) -> list[Node]:
        """Pick a cache-node subset with enough aggregate free capacity.

        Prefers nodes near ``near`` (a job's compute nodes), then nodes with
        the least *serving pressure* — pending fill bytes, in-flight
        migration bytes targeting the node, and the live read-queue backlog
        the contention-aware read scheduler reports (all of it crosses the
        node's disks and NIC, so stacking a new dataset there serialises
        with that traffic) — then emptiest nodes first so stripes spread
        across the cluster's free capacity.  With an elastic rebalancer
        attached, only live membership-view nodes qualify.
        """
        need = float(total_bytes)
        members = self._members()
        anchor_racks = {n.rack_id for n in near} if near else set()
        anchor_pods = {n.pod_id for n in near} if near else set()

        def key(n: Node):
            # write-path pressure counts too: dirty chunks will
            # cross the node's disks/NIC when the flusher drains them, and
            # un-fsync'd buffers are NVMe occupancy node_usage cannot see
            return (
                0 if n.rack_id in anchor_racks else (1 if n.pod_id in anchor_pods else 2),
                self.cache.store.pending_fill_bytes(n.node_id)
                + self.cache.store.migration_in_bytes(n.node_id)
                + self.cache.store.read_load_bytes(n.node_id)
                + self.cache.store.dirty_bytes(n.node_id)
                + self.cache.store.write_buffer_bytes(n.node_id),
                self.cache.store.bytes_on_node(n.node_id),
                n.node_id,
            )

        picked: list[Node] = []
        free_total = 0.0
        candidates = [
            n for n in self.topology.nodes if members is None or n.node_id in members
        ]
        for n in sorted(candidates, key=key):
            free = (
                self.cache.capacity_per_node
                - self.cache.store.bytes_on_node(n.node_id)
                - self.cache.store.write_buffer_bytes(n.node_id)
            )
            if free <= 0:
                continue
            picked.append(n)
            free_total += free
            if count is not None and len(picked) >= count:
                break
            if count is None and free_total >= need and len(picked) >= 2:
                break
        if free_total < need and count is None:
            # caller decides whether to evict; we report the best subset found
            pass
        return picked

    # ------------------------------------------------------------------ jobs
    def place(self, job: JobSpec, *, allow_misplaced: bool = True) -> Placement:
        """Co-schedule a job with its dataset (node > rack > pod order).

        Raises when the cluster lacks free GPUs; callers that queue instead
        (the workload engine) use :meth:`try_place`.
        """
        placement = self.try_place(job, allow_misplaced=allow_misplaced)
        if placement is None:
            raise RuntimeError(
                f"job {job.job_id}: need {job.n_nodes} nodes with "
                f"{job.gpus_per_node} free GPUs"
            )
        return placement

    def try_place(self, job: JobSpec, *, allow_misplaced: bool = True) -> Optional[Placement]:
        """Like :meth:`place`, but returns None when free GPUs are short.

        GPU inventory is only taken on success, so a queued job (multi-tenant
        engine) can retry when a running job releases its nodes.
        """
        entry = self.cache.entries.get(job.dataset_id)
        cached_nodes = (
            [self.topology.node(nid) for nid in entry.nodes]
            if entry is not None and entry.nodes
            else []
        )

        def score(n: Node):
            # locality first (node > rack > pod, Section 4.5); among equals,
            # avoid nodes still ingesting an on-demand fill, carrying
            # in-flight migration chunks, or with a deep read-serving
            # backlog — their NIC and disk queues are already busy
            ingest = (
                self.cache.store.pending_fill_bytes(n.node_id)
                + self.cache.store.migration_in_bytes(n.node_id)
                + self.cache.store.read_load_bytes(n.node_id)
                + self.cache.store.dirty_bytes(n.node_id)
                + self.cache.store.write_buffer_bytes(n.node_id)
            )
            if not cached_nodes:
                return (3, ingest, n.node_id)
            d = min(self.topology.distance(n, c) for c in cached_nodes)
            return (d, ingest, n.node_id)

        candidates = sorted(
            (n for n in self.topology.nodes if self.inventory.free[n.node_id] >= job.gpus_per_node),
            key=score,
        )
        chosen = candidates[: job.n_nodes]
        if len(chosen) < job.n_nodes:
            return None
        if not allow_misplaced and cached_nodes:
            racks = {c.rack_id for c in cached_nodes}
            if all(n.rack_id not in racks for n in chosen):
                raise RuntimeError(f"job {job.job_id}: no rack-local capacity")
        for n in chosen:
            self.inventory.take(n, job.gpus_per_node)

        if not cached_nodes:
            # size the subset from what admit() will actually charge —
            # chunk-rounded and replication-weighted — not spec.total_bytes,
            # which undercounts by up to one chunk per replica (the
            # bytes_needed docstring's warning, finally applied here)
            cache_nodes = self.choose_cache_nodes(
                self.cache.bytes_needed(job.dataset_id)
                if job.dataset_id in self.cache.entries
                else 0.0,
                near=chosen,
            )
        else:
            cache_nodes = cached_nodes
        return Placement(
            job=job,
            compute_nodes=chosen,
            cache_nodes=cache_nodes,
            locality={
                n.name: min((self.topology.distance(n, c) for c in cache_nodes), default=4)
                for n in chosen
            },
        )

    def release(self, placement: Placement) -> None:
        for n in placement.compute_nodes:
            self.inventory.release(n, placement.job.gpus_per_node)

    # ----------------------------------------------------------- Table 5 math
    def uplink_usage(
        self,
        n_jobs: int,
        misplaced_fraction: float,
        *,
        per_job_bw: float = 2.67 * Gb,
        coordination_overhead: float = 0.01,
        migration_bw: Optional[float] = None,
    ) -> float:
        """Fraction of a rack's TOR up-link consumed by misplaced jobs.

        A misplaced job streams its full ingest demand across the up-link;
        rack-local jobs contribute only cache-coordination chatter (the paper
        measures it as negligible; we book 1% as the observed floor).

        ``migration_bw`` is the cross-rack bandwidth an *online rebalance* is
        drawing concurrently.  It defaults to the attached rebalancer's live
        draw (its cap while transfers are in flight, zero otherwise), so
        admission decisions made mid-rebalance budget for the redistribution
        traffic instead of oversubscribing the up-link.
        """
        uplink = self.topology.cfg.tor_uplink_bw
        if migration_bw is None:
            rb = getattr(self.cache, "rebalancer", None)
            migration_bw = rb.active_migration_bw() if rb is not None else 0.0
        misplaced_jobs = n_jobs * misplaced_fraction
        return coordination_overhead + (misplaced_jobs * per_job_bw + migration_bw) / uplink
