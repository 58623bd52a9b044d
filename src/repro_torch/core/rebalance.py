"""Elastic cache membership: online re-striping with bounded movement.

On the cloud the cache tier is whatever fast-disk nodes the job happens to
hold *right now* — autoscalers grow it, spot reclaims shrink it, hardware
eats nodes whole.  The paper's striping (Requirement 1) fixes the node set
at dataset-creation time; this module makes membership a first-class,
*versioned* runtime quantity:

* :class:`MembershipEpoch` — a monotonic cluster-view generation.  Every
  ``add_node`` / ``remove_node`` / ``fail_node`` bumps it, and the new view
  is stamped into each affected :class:`~repro_torch.core.stripestore.StripeManifest`
  (schema v3, ``membership_epoch``) so any reader — iterator, HoardFS
  ``statfs``, an operator — can tell which generation a placement belongs to.

* :class:`Rebalancer` — computes a **minimal-movement** re-striping plan per
  membership change and executes it as *background flows* on the simulated
  fabric.  Adding 1 node to an N-node view moves at most ``1/(N+1)`` of each
  dataset's cached bytes (the consistent-hashing bound: only the new node's
  fair share relocates, nothing shuffles between survivors).  Removing a
  node moves exactly that node's bytes.  Node *failure* makes repair a real
  timed operation: surviving replicas re-copy peer-to-peer, wholly-lost
  chunks re-fetch from the remote store — both as flows, both restoring the
  replication target, neither instantaneous.

Correctness while jobs keep reading comes from a two-phase transfer protocol
in the stripe store (``begin_transfer`` / ``commit_transfer``): the manifest
placement only changes when a chunk's bytes have fully landed, so every read
issued mid-move resolves against the old placement (the source replica keeps
serving) and every read after the commit resolves against the new one —
dual-epoch lookup with zero cost on the read path.  Migration traffic is
throttled by an optional ``migration_bw`` cap (a shared
:class:`~repro_torch.core.simclock.Resource` on every migration flow), the
FanStore/hierarchical-storage lesson that redistribution must not starve
foreground training ingest.  Destination capacity is reserved at
``begin_transfer`` and datasets under rebalance hold a CacheManager reader
pin, so admission control can neither oversubscribe a mid-rebalance node nor
evict a dataset whose chunks are mid-flight.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from .cache import CacheManager
from .metrics import JobMetrics
from .simclock import Event, Resource, SimClock
from .stripestore import StripeStore
from .telemetry import FlowTag
from .topology import Topology


class RebalanceError(RuntimeError):
    pass


@dataclass
class MembershipEpoch:
    """Monotonic cluster-view generation + audit trail of view changes."""

    value: int = 0
    history: list[tuple[int, str, int]] = field(default_factory=list)  # (epoch, op, node)

    def bump(self, op: str, node_id: int) -> int:
        self.value += 1
        self.history.append((self.value, op, node_id))
        return self.value


@dataclass
class ChunkMove:
    """One planned chunk transfer (executed as a flow on the fabric)."""

    dataset_id: str
    chunk: int
    src: Optional[int]  # None for remote refetch of a lost chunk
    dst: int
    nbytes: int
    kind: str  # "move" | "repair" | "refetch"


@dataclass
class RebalancePlan:
    """Per-(operation, dataset) plan: flow moves + instant metadata ops.

    Unfilled chunks are pure metadata (no bytes exist yet), so their
    retargets/grants are applied at plan time and counted in ``meta_ops``;
    only filled chunks appear in ``moves`` and cross the fabric.
    """

    op: str  # "add" | "remove" | "fail"
    node_id: int
    epoch: int
    dataset_id: str
    moves: list[ChunkMove] = field(default_factory=list)
    meta_ops: int = 0
    committed: int = 0
    skipped: int = 0
    committed_bytes: int = 0
    started_at: float = 0.0
    finished_at: Optional[float] = None
    done: Optional[Event] = None

    @property
    def planned_bytes(self) -> int:
        return sum(mv.nbytes for mv in self.moves)


class Rebalancer:
    """Online membership changes over one cluster's stripe store.

    ``members`` is the live cache-tier node set (defaults to every topology
    node); the placement engine consults it via the ``cache.rebalancer``
    attach point, so nodes outside the view stop receiving new stripes the
    instant the epoch bumps, while data movement happens in the background.
    """

    def __init__(
        self,
        clock: SimClock,
        topology: Topology,
        cache: CacheManager,
        *,
        migration_bw: Optional[float] = None,
        max_inflight: int = 8,
        members: Optional[Sequence[int]] = None,
        metrics: Optional[JobMetrics] = None,
    ):
        self.clock = clock
        self.topology = topology
        self.cache = cache
        self.store: StripeStore = cache.store
        self.members: set[int] = (
            set(members) if members is not None else {n.node_id for n in topology.nodes}
        )
        self.epoch = MembershipEpoch()
        self.migration = (
            Resource("rebalance.migration_cap", float(migration_bw), created_at=clock.now)
            if migration_bw
            else None
        )
        self.max_inflight = max(1, int(max_inflight))
        self.metrics = metrics if metrics is not None else JobMetrics("rebalance")
        self.plans: list[RebalancePlan] = []
        cache.rebalancer = self  # attach point: placement + statfs read it

    # ------------------------------------------------------------- utilities
    def _fired(self) -> Event:
        ev = self.clock.event()
        ev.set()
        return ev

    def active_migration_bw(self) -> float:
        """Bandwidth the live migration can draw across shared links (B/s).

        Zero when nothing is in flight; the configured cap when one is set;
        otherwise bounded by a single node NIC (one destination drains at
        most its own ingest rate).  ``PlacementEngine.uplink_usage`` adds
        this to the TOR up-link budget so co-scheduling decisions made
        mid-rebalance see the redistribution traffic.
        """
        if not self.store._migrating:
            return 0.0
        if self.migration is not None:
            return self.migration.bw
        return self.topology.cfg.nic_bw

    def _ensure_pool(self, man, new_ids: list[int]) -> list[int]:
        """Top a shrunken membership back up to the replication factor.

        Cascading removals/failures can leave a dataset with fewer member
        nodes than replicas per chunk; repair would then have nowhere to put
        the missing copies.  Recruit the least-loaded live members until the
        pool can hold a full replica set again.
        """
        want = max(1, man.replication)
        if len(new_ids) >= want:
            return new_ids
        extras = sorted(
            self.members - set(new_ids),
            key=lambda nid: (self.store.node_usage[nid], nid),
        )
        return [*new_ids, *extras[: want - len(new_ids)]]

    def _least_loaded(self, candidates: Sequence[int], extra: dict[int, int]) -> Optional[int]:
        cands = [c for c in candidates]
        if not cands:
            return None
        return min(
            cands,
            key=lambda nid: (
                self.store.node_usage[nid] + extra.get(nid, 0),
                nid,
            ),
        )

    # ------------------------------------------------------------ operations
    def add_node(self, node_id: int) -> Event:
        """Grow the cache tier: re-stripe every dataset with bounded movement.

        Each dataset hands the new node its fair share —
        ``floor(replicas / (N+1))`` chunk replicas, drawn from the currently
        most-loaded members — so at most ``1/(N+1) <= 1/N + eps`` of cached
        bytes relocate.  Returns an event fired when every dataset's
        background re-striping has committed.
        """
        if node_id in self.members:
            return self._fired()
        self.members.add(node_id)
        e = self.epoch.bump("add", node_id)
        events = []
        for ds, man in list(self.store.manifests.items()):
            if node_id in man.node_ids:
                continue
            plan = self._plan_expand(ds, node_id, e)
            self.store.update_membership(ds, [*man.node_ids, node_id], e)
            events.append(self._launch(plan))
        return self.clock.all_of(events) if events else self._fired()

    def remove_node(self, node_id: int) -> Event:
        """Graceful scale-in: evacuate the node's stripes, then forget it."""
        if node_id not in self.members:
            return self._fired()
        if len(self.members) <= 1:
            raise RebalanceError("cannot remove the last cache-tier member")
        e = self.epoch.bump("remove", node_id)
        self.members.discard(node_id)
        # in-flight transfers *targeting* the node would land replicas on a
        # non-member after this epoch; abort them now (their flows still
        # finish crossing the fabric — bytes already sent — but the commit
        # becomes a no-op).  Transfers sourced *from* the node keep running:
        # they drain it, which is exactly what removal wants.
        doomed = [
            (ds, c)
            for (ds, c), (_src, dst, _k) in self.store._migrating.items()
            if dst == node_id
        ]
        for ds, c in doomed:
            self.store.abort_transfer(ds, c)
        events = []
        for ds, man in list(self.store.manifests.items()):
            holds = node_id in man.node_ids or any(node_id in reps for reps in man.chunk_nodes)
            if not holds:
                continue
            new_ids = [nid for nid in man.node_ids if nid != node_id]
            if not new_ids:
                new_ids = sorted(self.members)
            new_ids = self._ensure_pool(man, new_ids)
            plan = self._plan_evacuate(ds, node_id, e, new_ids, op="remove")
            self.store.update_membership(ds, new_ids, e)
            events.append(self._launch(plan))
        return self.clock.all_of(events) if events else self._fired()

    def fail_node(self, node_id: int) -> Event:
        """Node loss: instant data drop, *timed* re-replication repair.

        The loss itself is immediate (the disks are gone); recovery is not:
        under-replicated chunks re-copy from a surviving replica and
        wholly-lost filled chunks re-fetch from the remote store, all as
        throttled flows.  Returns an event fired when the replication target
        is restored everywhere it can be.
        """
        e = self.epoch.bump("fail", node_id)
        self.members.discard(node_id)
        self.store.fail_node(node_id)  # instant loss; aborts its transfers
        events = []
        for ds, man in list(self.store.manifests.items()):
            if node_id in man.node_ids:
                new_ids = [nid for nid in man.node_ids if nid != node_id]
                if not new_ids:
                    new_ids = sorted(self.members - {node_id})
                new_ids = self._ensure_pool(man, new_ids)
                if new_ids:
                    self.store.update_membership(ds, new_ids, e)
            events.append(self.clock.process(self._repair_rounds(ds, e, node_id)))
        return self.clock.all_of(events) if events else self._fired()

    # --------------------------------------------------------------- planning
    def _plan_expand(self, ds: str, new_node: int, epoch: int) -> RebalancePlan:
        man = self.store.manifests[ds]
        plan = RebalancePlan("add", new_node, epoch, ds)
        old_nodes = [nid for nid in man.node_ids if nid != new_node]
        counts = {nid: 0 for nid in old_nodes}
        by_node: dict[int, list[int]] = {nid: [] for nid in old_nodes}
        total = 0
        for c, reps in enumerate(man.chunk_nodes):
            total += len(reps)
            for nid in reps:
                if nid in counts:
                    counts[nid] += 1
                    by_node[nid].append(c)
        # the consistent-hashing bound: the newcomer takes exactly its fair
        # share, floor(total/(N+1)) replicas, from the most-loaded members
        target = total // (len(old_nodes) + 1)
        cursor = {nid: 0 for nid in old_nodes}
        chosen: set[int] = set()
        exhausted: set[int] = set()
        moved = 0
        while moved < target and len(exhausted) < len(old_nodes):
            src = max(
                (nid for nid in old_nodes if nid not in exhausted),
                key=lambda nid: (counts[nid], nid),
            )
            lst, i = by_node[src], cursor[src]
            while i < len(lst) and (
                lst[i] in chosen
                or new_node in man.chunk_nodes[lst[i]]
                or self.store.is_migrating(ds, lst[i])
            ):
                i += 1
            cursor[src] = i
            if i >= len(lst):
                exhausted.add(src)
                continue
            c = lst[i]
            cursor[src] = i + 1
            chosen.add(c)
            counts[src] -= 1
            if man.is_filled(c):
                plan.moves.append(ChunkMove(ds, c, src, new_node, man.chunk_bytes, "move"))
            else:
                self.store.retarget_replica(ds, c, src, new_node)
                plan.meta_ops += 1
            moved += 1
        return plan

    def _plan_evacuate(
        self, ds: str, node_id: int, epoch: int, new_ids: list[int], *, op: str
    ) -> RebalancePlan:
        man = self.store.manifests[ds]
        plan = RebalancePlan(op, node_id, epoch, ds)
        extra: dict[int, int] = {}
        for c, reps in enumerate(man.chunk_nodes):
            if node_id not in reps:
                continue
            if self.store.is_migrating(ds, c):
                # a foreign (expansion) transfer owns this chunk; were we to
                # skip it, the node's replica would never be evacuated —
                # removal outranks re-striping, so take the chunk over
                self.store.abort_transfer(ds, c)
            dst = self._least_loaded([n for n in new_ids if n not in reps], extra)
            if dst is None:
                plan.skipped += 1
                continue
            extra[dst] = extra.get(dst, 0) + man.chunk_bytes
            if man.is_filled(c):
                plan.moves.append(ChunkMove(ds, c, node_id, dst, man.chunk_bytes, "move"))
            else:
                self.store.retarget_replica(ds, c, node_id, dst)
                plan.meta_ops += 1
        return plan

    def _plan_repair(self, ds: str, epoch: int, node_id: int) -> RebalancePlan:
        man = self.store.manifests[ds]
        plan = RebalancePlan("fail", node_id, epoch, ds)
        want = man.replication
        extra: dict[int, int] = {}
        # repair only onto live members: after cascading failures a
        # manifest's node_ids can momentarily reference dead nodes
        pool = [nid for nid in man.node_ids if nid in self.members]
        for c, reps in enumerate(man.chunk_nodes):
            if self.store.is_migrating(ds, c):
                if not reps or len(reps) >= want:
                    continue
                # under-replicated AND owned by a foreign (expansion)
                # transfer, which moves but never adds replicas — skipping
                # would leave the chunk under-replicated forever once the
                # repair rounds end.  Repair outranks re-striping: take over.
                self.store.abort_transfer(ds, c)
            if not reps:
                # every replica gone.  Filled: the data existed — re-fetch it
                # from the remote store.  Unfilled: nothing was lost; re-grant
                # a placement and let the fill plane stream it as usual.
                dst = self._least_loaded(pool, extra)
                if dst is None:
                    plan.skipped += 1
                    continue
                extra[dst] = extra.get(dst, 0) + man.chunk_bytes
                if man.is_filled(c):
                    plan.moves.append(ChunkMove(ds, c, None, dst, man.chunk_bytes, "refetch"))
                else:
                    self.store.assign_replica(ds, c, dst)
                    plan.meta_ops += 1
                continue
            missing = want - len(reps)
            for _ in range(missing):
                cands = [n for n in pool if n not in reps]
                # avoid double-assigning the same dst to this chunk across
                # the loop: extra makes repeats more expensive but not
                # impossible, so filter planned dsts for this chunk
                planned_here = {
                    mv.dst for mv in plan.moves if mv.chunk == c and mv.dataset_id == ds
                }
                cands = [n for n in cands if n not in planned_here]
                dst = self._least_loaded(cands, extra)
                if dst is None:
                    plan.skipped += 1
                    break
                extra[dst] = extra.get(dst, 0) + man.chunk_bytes
                if man.is_filled(c):
                    plan.moves.append(ChunkMove(ds, c, reps[0], dst, man.chunk_bytes, "repair"))
                else:
                    self.store.assign_replica(ds, c, dst)
                    plan.meta_ops += 1
        return plan

    def _repair_rounds(self, ds: str, epoch: int, node_id: int, max_rounds: int = 4):
        """Repair until the replication target is restored (or stable).

        A wholly-lost chunk under replication > 1 needs two waves: the remote
        refetch lands one replica, then peer copies restore the rest — the
        second wave's source does not exist until the first commits, so the
        planner runs in rounds over the live manifest state.
        """
        for _ in range(max_rounds):
            if ds not in self.store.manifests:
                return
            plan = self._plan_repair(ds, epoch, node_id)
            if not plan.moves:
                if plan.meta_ops:
                    self.plans.append(plan)
                return
            yield self._launch(plan)

    # -------------------------------------------------------------- execution
    def _book_flow(self, mv: ChunkMove) -> Event:
        dst_node = self.topology.node(mv.dst)
        head = [self.migration] if self.migration is not None else []
        if mv.kind == "refetch":
            path = [*head, *self.topology.path_from_remote(dst_node), dst_node.nvme]
            self.metrics.count("remote_bytes", mv.nbytes)
        else:
            # the source side of a move/repair is a chunk *read*: it crosses
            # the per-disk read queue (readsched) so repair traffic contends
            # with — and is slowed by — foreground stripe reads honestly
            src_node = self.topology.node(mv.src)
            path = [
                *head,
                self.store.readsched.disk(mv.src, mv.chunk),
                *self.topology.path(src_node, dst_node),
                dst_node.nvme,
            ]
            self.metrics.count_link(mv.src, mv.dst, mv.nbytes)
        self.metrics.count("migration_bytes", mv.nbytes)
        return self.clock.transfer(
            path, mv.nbytes, FlowTag("migration", "rebalance", mv.dataset_id, mv.chunk)
        )

    def _launch(self, plan: RebalancePlan) -> Event:
        """Execute a plan's flow moves with bounded concurrency.

        The dataset holds a CacheManager reader pin for the whole execution,
        so LRU churn can never evict a dataset whose chunks are mid-flight
        (the victim-side mirror of the workload engine's per-job pins).
        """
        self.plans.append(plan)
        plan.started_at = self.clock.now
        done = self.clock.event()
        plan.done = done
        if not plan.moves:
            plan.finished_at = self.clock.now
            done.set()
            return done
        ds = plan.dataset_id
        pinned = ds in self.cache.entries
        if pinned:
            self.cache.acquire(ds)

        def run():
            pending: list[Event] = []
            for mv in plan.moves:
                # re-validate against live membership and the live manifest:
                # a remove/fail since planning may have retired the
                # destination (begin_transfer rejects manifest-stale moves,
                # but only the rebalancer knows the membership view)
                if mv.dst not in self.members:
                    plan.skipped += 1
                    continue
                if not self.store.begin_transfer(mv.dataset_id, mv.chunk, mv.src, mv.dst, mv.kind):
                    plan.skipped += 1
                    continue
                flow = self._book_flow(mv)
                landed = self.clock.event()

                def commit(_v, mv=mv, landed=landed):
                    if self.store.commit_transfer(mv.dataset_id, mv.chunk):
                        plan.committed += 1
                        plan.committed_bytes += mv.nbytes
                    else:
                        plan.skipped += 1
                    landed.set()

                flow.on_fire(commit)
                pending.append(landed)
                pending = [e for e in pending if not e.fired]
                while len(pending) >= self.max_inflight:
                    yield pending[0]
                    pending = [e for e in pending if not e.fired]
            for ev in pending:
                yield ev

        def finish(_v):
            if pinned:
                self.cache.release(ds)
            plan.finished_at = self.clock.now
            done.set()

        self.clock.process(run()).on_fire(finish)
        return done
