"""CacheManager: dataset-granularity cache lifecycle (the paper's Requirement 2).

The unit of admission, eviction, pinning and prefetch is the *dataset* —
never a file or block.  Rationale (paper Section 2): every epoch touches the
full dataset in a fresh permutation, so block-LRU merely thrashes.  Dataset
lifecycle is decoupled from job lifecycle: a dataset stays cached after its
jobs exit, so repeated runs (think-time iteration) and parallel
hyper-parameter sweeps hit warm stripes.

Beyond the paper (following NoPFS / Krichevsky et al.): admission
may be *fractional*.  ``admit(fraction=0.5)`` — or ``degrade_to_partial=True``
when the dataset exceeds reclaimable capacity — reserves stripes for the
hottest k% of chunks only (per-chunk decayed access heat, see
``StripeStore.note_chunk_access``); the rest read through to the remote
store.  The matching eviction surface is :meth:`CacheManager.evict_chunks`,
a chunk-granular LRU that demotes cold chunks instead of destroying whole
datasets.  Both preserve the paper's contract when unused: the default
``admit()`` is still all-or-nothing.

Mirrors the paper's Kubernetes surface without Kubernetes:

* ``DatasetSpec``           <-> the `dataset` custom resource (name, remote
                                URL, credentials, size metadata),
* ``CacheManager.create``   <-> the dataset controller + dynamic provisioner,
* ``CacheManager.prefetch`` <-> AFM asynchronous pre-population,
* ``CacheManager.mount``    <-> the persistent-volume-claim handed to a job
                                (returns a reader handle; POSIX transparency
                                becomes iterator transparency in JAX).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Sequence

import numpy as np

from .simclock import Event, SimClock
from .stripestore import StripeStore
from .telemetry import FlowTag
from .topology import Node, Topology


class EvictionPolicy(str, Enum):
    MANUAL = "manual"        # refuse new datasets until user evicts (paper opt i)
    LRU = "lru"              # evict whole least-recently-used datasets (opt ii)


class CacheState(str, Enum):
    REGISTERED = "registered"    # known remote dataset, nothing cached
    FILLING = "filling"          # prefetch/first-epoch fill in progress
    CACHED = "cached"            # every chunk resident and filled
    # terminal state of a fractional admission (or a CACHED dataset after
    # evict_chunks): the resident subset is fully filled, everything else
    # reads through to remote.  Distinct from CACHED so statfs/ls never
    # report a partially-resident dataset as fully cached.
    PARTIAL = "partial"
    EVICTING = "evicting"


@dataclass
class DatasetSpec:
    """User-facing dataset descriptor (the 'custom resource')."""

    dataset_id: str
    remote_url: str
    n_items: int
    item_bytes: int
    credentials: Optional[str] = None

    @property
    def total_bytes(self) -> int:
        return self.n_items * self.item_bytes


@dataclass
class DatasetStat:
    """One dataset's row in :meth:`CacheManager.ls` (typed, not a dict).

    Attribute access is the API (``stat.resident_fraction``); callers that
    need a plain mapping — JSON dumps, the statfs wire shape — use
    :meth:`as_dict`, which reproduces the pre-typed dict key-for-key.
    """

    dataset: str
    state: str                       # CacheState value ("cached", "partial", ...)
    bytes: float                     # logical dataset size
    nodes: list[int]                 # member cache nodes
    pinned: bool
    active_readers: int              # reader pins (eviction guard)
    last_access: float
    fill_progress: float
    # partial caching: fraction of chunks holding stripe replicas and mean
    # decayed chunk heat — 1.0/quiet for CACHED, the honest sub-1.0 figure
    # for PARTIAL (statfs surfaces both)
    resident_fraction: float
    chunk_heat_mean: float
    admissions: int
    migrating_chunks: int            # elastic rebalancer's in-flight chunks
    # write-path state: unflushed write-back debt + un-fsync'd buffers; both
    # make the dataset eviction-immune (data loss)
    dirty_chunks: int
    dirty_bytes: float
    pending_write_bytes: float
    membership_epoch: Optional[int]
    # live telemetry: flows in flight for this dataset and bytes
    # traced so far — 0 when no Telemetry hub is attached
    live_flows: int
    traced_bytes: float

    def as_dict(self) -> dict:
        """Back-compat mapping, key-identical to the pre-typed ``ls()`` rows."""
        return {
            "dataset": self.dataset,
            "state": self.state,
            "bytes": self.bytes,
            "nodes": list(self.nodes),
            "pinned": self.pinned,
            "active_readers": self.active_readers,
            "last_access": self.last_access,
            "fill_progress": self.fill_progress,
            "resident_fraction": self.resident_fraction,
            "chunk_heat_mean": self.chunk_heat_mean,
            "admissions": self.admissions,
            "migrating_chunks": self.migrating_chunks,
            "dirty_chunks": self.dirty_chunks,
            "dirty_bytes": self.dirty_bytes,
            "pending_write_bytes": self.pending_write_bytes,
            "membership_epoch": self.membership_epoch,
            "live_flows": self.live_flows,
            "traced_bytes": self.traced_bytes,
        }


@dataclass
class CacheEntry:
    spec: DatasetSpec
    state: CacheState = CacheState.REGISTERED
    nodes: list[int] = field(default_factory=list)
    pinned: bool = False
    last_access: float = 0.0
    created_at: float = 0.0
    fill_done: Optional[Event] = None
    access_seq: int = 0          # tie-break for LRU at equal times
    # multi-tenant safety (workload engine): datasets with live readers are
    # never eviction victims; FILLING datasets carry their fill data plane so
    # eviction can cancel outstanding remote transfers
    active_readers: int = 0
    fill_plane: Optional[object] = None   # prefetch.FillTracker (untyped: no cycle)
    admissions: int = 0                   # how many times admit() ran (re-admission telemetry)


@dataclass
class CacheEvent:
    """One cache-lifecycle transition, for churn accounting and tests."""

    t: float
    op: str              # "admit" | "readmit" | "filled" | "evict"
    dataset_id: str


class CacheFullError(RuntimeError):
    pass


class CacheManager:
    """Whole-dataset cache admission/eviction over the stripe store."""

    def __init__(
        self,
        topology: Topology,
        store: StripeStore,
        clock: SimClock,
        *,
        capacity_per_node: float = 1e12,          # 1 TB NVMe cache per node (paper)
        policy: EvictionPolicy = EvictionPolicy.LRU,
        fill_bw: float = 87.5e6,                  # calibration.PAPER.fill_bw
        items_per_chunk: int = 4096,
        replication: int = 1,
    ):
        self.topology = topology
        self.store = store
        self.clock = clock
        self.capacity_per_node = float(capacity_per_node)
        self.policy = policy
        self.fill_bw = float(fill_bw)
        self.items_per_chunk = int(items_per_chunk)
        self.replication = int(replication)
        self.entries: dict[str, CacheEntry] = {}
        self._seq = itertools.count()
        # attach point for the elastic rebalancer (repro.core.rebalance):
        # placement and HoardFS.statfs consult it for the live membership
        # view; None means the pre-elastic world (every node is a member)
        self.rebalancer = None
        # lifecycle event log: every admit/readmit/filled/evict with sim time,
        # in order.  The workload engine and the churn benchmarks read this to
        # count evictions and re-admissions mid-simulation.
        self.events: list[CacheEvent] = []

    def _log(self, op: str, dataset_id: str) -> None:
        self.events.append(CacheEvent(self.clock.now, op, dataset_id))

    # ------------------------------------------------------------- lifecycle
    def register(self, spec: DatasetSpec) -> CacheEntry:
        if spec.dataset_id in self.entries:
            raise ValueError(f"dataset {spec.dataset_id!r} already registered")
        entry = CacheEntry(spec=spec, created_at=self.clock.now)
        self.entries[spec.dataset_id] = entry
        return entry

    def free_bytes(self, nodes: Sequence[Node]) -> float:
        """Admittable capacity: raw free space minus un-fsync'd write buffers.

        Write buffers (``StripeStore.write_buffer_bytes``) occupy NVMe
        *outside* ``bytes_on_node`` — the committed chunk copy is what
        ``node_usage`` charges — so ignoring them would let admission
        oversubscribe a node mid-checkpoint (a write-path fix).
        """
        return sum(
            self.capacity_per_node
            - self.store.bytes_on_node(n.node_id)
            - self.store.write_buffer_bytes(n.node_id)
            for n in nodes
        )

    def bytes_needed(self, dataset_id: str, *, items_per_chunk: Optional[int] = None) -> float:
        """Capacity :meth:`admit` will charge for the dataset.

        Chunk-granular: the stripe store allocates whole chunks, so a partial
        last chunk still occupies ``items_per_chunk * item_bytes`` (a
        hypothesis-found invariant, tests/test_cache.py).  Callers sizing a
        cache-node subset (the workload engine) must use this, not
        ``spec.total_bytes``, or the subset can be short by up to one chunk
        per replica.
        """
        entry = self._require(dataset_id)
        ipc = items_per_chunk or self.items_per_chunk
        n_chunks = -(-entry.spec.n_items // ipc)
        return n_chunks * ipc * entry.spec.item_bytes * self.replication

    def _require(self, dataset_id: str) -> CacheEntry:
        if dataset_id not in self.entries:
            raise KeyError(f"unknown dataset {dataset_id!r}; register() it first")
        return self.entries[dataset_id]

    def _dirty_held_bytes(self, node_ids: set, exclude: Optional[str]) -> int:
        """Bytes on the target nodes that eviction cannot reclaim *solely*
        because the owning dataset holds unflushed writes.

        Datasets also excluded for another reason (pinned, live readers,
        wrong state, off-node) are not counted — naming their bytes as
        drain-recoverable in a ``CacheFullError`` would mislead the caller.
        """
        total = 0
        for e in self.entries.values():
            if (
                e.spec.dataset_id == exclude
                or e.state not in (CacheState.CACHED, CacheState.FILLING, CacheState.PARTIAL)
                or e.pinned
                or e.active_readers > 0
                or not node_ids.intersection(e.nodes)
            ):
                continue
            if self._holds_unflushed_writes(e.spec.dataset_id):
                total += self.store.bytes_on_nodes(e.spec.dataset_id, node_ids)
        return total

    @staticmethod
    def _dirty_note(dirty_held: int) -> str:
        if not dirty_held:
            return ""
        return (
            f"; {dirty_held:.2e} B more is held by unflushed writes "
            f"(flush via WritePlane.drain to release it)"
        )

    def admit(
        self,
        dataset_id: str,
        nodes: Sequence[Node],
        *,
        materialize: bool = False,
        payload=None,
        items_per_chunk: Optional[int] = None,
        on_demand: bool = False,
        fraction: Optional[float] = None,
        degrade_to_partial: bool = False,
    ) -> CacheEntry:
        """Reserve stripe space for the dataset (all-or-nothing by default).

        Evicts LRU datasets when the policy allows; raises ``CacheFullError``
        when MANUAL policy is active and space is insufficient (the paper's
        "wait for the user to evict" behaviour).

        ``on_demand=True`` reserves the stripe layout with every chunk
        *unfilled*: the dataset is warmed during the first epoch of the job
        itself (remote read-through + clairvoyant prefetch, see
        :mod:`repro_torch.core.prefetch`) instead of by an up-front
        :meth:`prefetch` pass.  Capacity accounting is identical.

        Partial caching: ``fraction=k`` caches only the hottest
        ``floor(k * n_chunks)`` chunks (>= 1) by decayed access heat, ties
        broken by ascending chunk index so a cold dataset caches a
        deterministic prefix.  ``degrade_to_partial=True`` lets an admission
        that cannot fit — even after evicting every idle victim — shrink to
        the largest chunk subset that does fit instead of raising.  The
        entry converges to ``PARTIAL`` instead of ``CACHED``; the rest of
        the dataset reads through to the remote store.
        """
        entry = self._require(dataset_id)
        if entry.state in (CacheState.CACHED, CacheState.FILLING, CacheState.PARTIAL):
            return entry
        ipc = items_per_chunk or self.items_per_chunk
        n_chunks = -(-entry.spec.n_items // ipc)
        chunk_charge = ipc * entry.spec.item_bytes * self.replication
        if fraction is not None:
            if not 0.0 < fraction <= 1.0:
                raise ValueError(f"fraction must be in (0, 1], got {fraction}")
            k = max(1, int(fraction * n_chunks))
        else:
            k = n_chunks
        need = k * chunk_charge
        node_ids = {n.node_id for n in nodes}
        if self.free_bytes(nodes) < need:
            # dry-run first: evicting is destructive (victims must re-stream
            # from remote), so refuse up front when even evicting EVERY idle
            # dataset on the target nodes cannot free enough — a doomed
            # admission must not leave warm datasets destroyed behind it
            reclaimable = (
                sum(
                    self.store.bytes_on_nodes(e.spec.dataset_id, node_ids)
                    for e in self._evictable(exclude=dataset_id, node_ids=node_ids)
                )
                if self.policy is EvictionPolicy.LRU
                else 0.0
            )
            if degrade_to_partial and self.free_bytes(nodes) + reclaimable < need:
                k_fit = int((self.free_bytes(nodes) + reclaimable) // chunk_charge)
                if k_fit >= 1:
                    k = min(k, k_fit)
                    need = k * chunk_charge
            if (
                self.policy is EvictionPolicy.LRU
                and self.free_bytes(nodes) + reclaimable < need
            ):
                dirty_held = self._dirty_held_bytes(node_ids, exclude=dataset_id)
                raise CacheFullError(
                    f"{dataset_id}: need {need:.2e} B on {len(nodes)} nodes; "
                    f"evicting every idle dataset on the target nodes frees only "
                    f"{reclaimable:.2e} B on top of {self.free_bytes(nodes):.2e} free"
                    f"{self._dirty_note(dirty_held)}"
                )
        while self.free_bytes(nodes) < need:
            if self.policy is EvictionPolicy.MANUAL:
                raise CacheFullError(
                    f"{dataset_id}: need {need:.2e} B on {len(nodes)} nodes, "
                    f"have {self.free_bytes(nodes):.2e}; evict something first"
                )
            # only victims holding stripes on the TARGET nodes free capacity
            # toward this admission — evicting the global LRU could destroy a
            # dataset on disjoint nodes for zero gain
            victim = self._lru_victim(exclude=dataset_id, nodes=nodes)
            if victim is None:
                dirty_held = self._dirty_held_bytes(node_ids, exclude=dataset_id)
                raise CacheFullError(
                    f"{dataset_id}: cache exhausted and nothing evictable "
                    f"on the target nodes (all pinned or in use)"
                    f"{self._dirty_note(dirty_held)}"
                )
            self.evict(victim)
        resident_chunks = None
        if k < n_chunks:
            heat = self.store.chunk_heat(dataset_id, n_chunks=n_chunks)
            # hottest k chunks win a stripe; equal heat (a never-read
            # dataset) degrades to the ascending-index prefix, deterministic
            # under PYTHONHASHSEED by construction
            order = np.lexsort((np.arange(n_chunks), -heat))
            resident_chunks = sorted(int(c) for c in order[:k])
        self.store.create(
            dataset_id,
            entry.spec.n_items,
            entry.spec.item_bytes,
            nodes,
            items_per_chunk=ipc,
            replication=self.replication,
            materialize=materialize,
            payload=payload,
            prefill=not on_demand,
            resident_chunks=resident_chunks,
        )
        entry.nodes = [n.node_id for n in nodes]
        entry.state = CacheState.FILLING
        entry.fill_done = self.clock.event()
        entry.admissions += 1
        # a freshly-admitted dataset counts as just-used: a concurrent admit's
        # LRU scan must not pick the dataset another job is about to read
        entry.last_access = self.clock.now
        entry.access_seq = next(self._seq)
        self._log("readmit" if entry.admissions > 1 else "admit", dataset_id)
        return entry

    def mark_filled(self, dataset_id: str) -> None:
        """Fill complete: FILLING -> CACHED (or PARTIAL when only a chunk
        subset is resident) and wake waiters on ``fill_done``."""
        entry = self._require(dataset_id)
        fully_resident = (
            dataset_id not in self.store.manifests
            or self.store.resident_fraction(dataset_id) >= 1.0
        )
        entry.state = CacheState.CACHED if fully_resident else CacheState.PARTIAL
        # the fill is over: detach the fill plane so later jobs take the
        # plain cached read path instead of threading every batch through
        # nothing-to-do fill-mask bookkeeping (jobs already holding the
        # tracker keep their reference and see every chunk filled)
        entry.fill_plane = None
        self._log("filled", dataset_id)
        if entry.fill_done is not None:
            entry.fill_done.set()

    def fill_progress(self, dataset_id: str) -> float:
        """Fraction of the dataset's chunks resident in the stripes [0, 1]."""
        entry = self._require(dataset_id)
        if entry.state is CacheState.CACHED:
            return 1.0
        if dataset_id not in self.store.manifests:
            return 0.0
        return self.store.filled_fraction(dataset_id)

    def note_chunk_filled(self, dataset_id: str) -> None:
        """Fill-plane callback after ``StripeStore.put_chunk``.

        Flips the entry to its terminal state the moment the last *resident*
        chunk lands, so an on-demand fill converges to exactly the same
        steady state as an up-front :meth:`prefetch`.  The fraction is of
        the resident subset — a fractionally-admitted dataset whose subset
        is full lands in ``PARTIAL`` (``mark_filled`` decides), never in
        ``CACHED`` with most of its chunks remote (a partial-caching fix).
        """
        entry = self._require(dataset_id)
        if (
            entry.state is CacheState.FILLING
            and self.store.resident_filled_fraction(dataset_id) >= 1.0
        ):
            self.mark_filled(dataset_id)

    def prefetch(self, dataset_id: str, nodes: Sequence[Node], **admit_kw) -> Event:
        """Asynchronously pull the dataset from remote into the stripes.

        Books the remote->stripe transfer on the simulated fabric (remote NIC
        shared with everyone else, node NICs, NVMe write queues) and resolves
        the returned event when the fill completes.  Jobs starting before
        completion fall back to the miss path for not-yet-resident chunks.
        """
        entry = self.admit(dataset_id, nodes, **admit_kw)
        if entry.state in (CacheState.CACHED, CacheState.PARTIAL):
            done = self.clock.event()
            done.set()
            return done
        # chunk-padded, replication- and residency-aware: the stripe store
        # allocates (and an on-demand fill streams) whole chunks, so sizing
        # these flows from spec.total_bytes undercounted by the last chunk's
        # padding — prepop fills finished early and moved fewer remote bytes
        # than the equivalent on-demand fill
        per_node = self.store.dataset_resident_bytes(dataset_id) / max(1, len(nodes))

        flows = []
        for node in nodes:
            path = [self.topology.remote_nic, *self.topology.path_from_remote(node)[1:], node.nvme]
            flows.append(
                self.clock.transfer(
                    path, per_node, FlowTag("prefetch", f"fill:{dataset_id}", dataset_id)
                )
            )
        done = self.clock.all_of(flows)
        # generation guard: a FILLING dataset is evictable (workload engine
        # LRU churn), so by the time this transfer lands the dataset may have
        # been evicted — or evicted AND re-admitted with a fresh, unfilled
        # layout.  A stale completion must not flip either to CACHED.
        admission_gen = entry.admissions
        done.on_fire(lambda _v: self._finish_prefetch(dataset_id, admission_gen))
        return done

    def _finish_prefetch(self, dataset_id: str, admission_gen: int) -> None:
        entry = self.entries.get(dataset_id)
        if (
            entry is not None
            and entry.state is CacheState.FILLING
            and entry.admissions == admission_gen
            and dataset_id in self.store.manifests
        ):
            self.mark_filled(dataset_id)

    # ---------------------------------------------------------------- access
    def touch(self, dataset_id: str) -> None:
        entry = self._require(dataset_id)
        entry.last_access = self.clock.now
        entry.access_seq = next(self._seq)

    def pin(self, dataset_id: str) -> None:
        self._require(dataset_id).pinned = True

    def unpin(self, dataset_id: str) -> None:
        self._require(dataset_id).pinned = False

    def acquire(self, dataset_id: str) -> CacheEntry:
        """Register a live reader (a running job): blocks eviction.

        Reader pins are how eviction stays safe while other jobs are live —
        a dataset some job is actively iterating can never be the LRU victim,
        without the user having to ``pin`` it manually.
        """
        entry = self._require(dataset_id)
        entry.active_readers += 1
        self.touch(dataset_id)
        return entry

    def release(self, dataset_id: str) -> None:
        """Drop a reader pin (job exit).  Dataset stays cached (Req 2)."""
        entry = self._require(dataset_id)
        if entry.active_readers <= 0:
            raise ValueError(f"dataset {dataset_id!r} has no active readers")
        entry.active_readers -= 1

    def attach_fill_plane(self, dataset_id: str, plane) -> None:
        """Remember the dataset's fill data plane so evict() can cancel it."""
        self._require(dataset_id).fill_plane = plane

    def is_cached(self, dataset_id: str) -> bool:
        """True only for *fully* cached datasets — a PARTIAL dataset still
        needs the read-through data plane, so it must not take the plain
        cached fast path."""
        e = self.entries.get(dataset_id)
        return e is not None and e.state is CacheState.CACHED

    def ls(self) -> list[DatasetStat]:
        """The `query cached datasets` API — one :class:`DatasetStat` per entry.

        Reports the reader-pin count (``active_readers``, the workload
        engine's eviction guard) and live fill progress per dataset, so an
        operator — or :meth:`repro_torch.fs.HoardFS.statfs` — can see a FILLING
        dataset converge and which datasets are eviction-immune right now.
        ``migrating_chunks``/``membership_epoch`` expose the elastic
        rebalancer's live state: chunks mid-flight count toward the node
        capacity they are moving onto, so an operator sizing an admission
        must see them here rather than discovering the reservation by
        hitting ``CacheFullError``.  (``DatasetStat.as_dict()`` reproduces
        the pre-typed dict rows for serialization.)
        """
        tracer = self.clock.telemetry.tracer if self.clock.telemetry is not None else None
        stats = []
        for e in self.entries.values():
            did = e.spec.dataset_id
            in_store = did in self.store.manifests
            heat = self.store.chunk_heat(did)
            stats.append(
                DatasetStat(
                    dataset=did,
                    state=e.state.value,
                    bytes=e.spec.total_bytes,
                    nodes=list(e.nodes),
                    pinned=e.pinned,
                    active_readers=e.active_readers,
                    last_access=e.last_access,
                    fill_progress=self.fill_progress(did),
                    resident_fraction=(
                        self.store.resident_fraction(did) if in_store else 0.0
                    ),
                    chunk_heat_mean=float(heat.mean()) if len(heat) else 0.0,
                    admissions=e.admissions,
                    migrating_chunks=self.store.migrating_chunks(did),
                    dirty_chunks=(
                        len(self.store.dirty_chunks(did)) if in_store else 0
                    ),
                    dirty_bytes=(
                        self.store.dataset_dirty_bytes(did) if in_store else 0
                    ),
                    pending_write_bytes=self.store.pending_write_bytes(did),
                    membership_epoch=(
                        self.store.manifests[did].membership_epoch if in_store else None
                    ),
                    live_flows=tracer.live_flows(did) if tracer is not None else 0,
                    traced_bytes=tracer.traced_bytes(did) if tracer is not None else 0,
                )
            )
        return stats

    # --------------------------------------------------------------- eviction
    def _evictable(
        self, exclude: Optional[str] = None, node_ids: Optional[set] = None
    ) -> list[CacheEntry]:
        """Entries eviction may target (shared by victim pick and dry-run)."""
        return [
            e
            for e in self.entries.values()
            if e.state in (CacheState.CACHED, CacheState.FILLING, CacheState.PARTIAL)
            and not e.pinned
            and e.active_readers == 0
            and e.spec.dataset_id != exclude
            and (node_ids is None or node_ids.intersection(e.nodes))
            and not self._holds_unflushed_writes(e.spec.dataset_id)
        ]

    def _holds_unflushed_writes(self, dataset_id: str) -> bool:
        """True when evicting the dataset would lose written data.

        Dirty chunks (committed, not yet flushed to remote) and un-fsync'd
        write buffers both exist only in the cache tier — the read path's
        datasets can always re-stream from remote, written ones cannot until
        the flusher drains them.
        """
        if dataset_id not in self.store.manifests:
            return False
        return bool(
            self.store.dirty_chunks(dataset_id)
            or self.store.pending_write_bytes(dataset_id)
        )

    def _lru_victim(
        self, exclude: Optional[str] = None, nodes: Optional[Sequence[Node]] = None
    ) -> Optional[str]:
        """Least-recently-used evictable dataset, or None.

        Pinned datasets and datasets with live readers are never victims
        (eviction must be safe while other jobs run).  An idle FILLING
        dataset *is* evictable — its fill is cancelled — but only after
        every evictable CACHED dataset, since an in-progress fill is work
        already paid for.  With ``nodes`` given, only datasets holding
        stripes on at least one of those nodes qualify (evicting anything
        else frees no capacity there).
        """
        node_ids = {n.node_id for n in nodes} if nodes is not None else None
        candidates = self._evictable(exclude=exclude, node_ids=node_ids)
        if not candidates:
            return None
        victim = min(
            candidates,
            key=lambda e: (e.state is CacheState.FILLING, e.last_access, e.access_seq),
        )
        return victim.spec.dataset_id

    def evict(self, dataset_id: str) -> None:
        """Whole-dataset eviction (never partial; see module docstring).

        Evicting a FILLING dataset cancels its fill data plane first, so
        in-flight remote transfers land as no-ops instead of writing into a
        freed (or re-admitted) stripe layout.
        """
        entry = self._require(dataset_id)
        if entry.pinned:
            raise ValueError(f"dataset {dataset_id!r} is pinned")
        if entry.active_readers > 0:
            raise ValueError(
                f"dataset {dataset_id!r} has {entry.active_readers} active readers"
            )
        if self._holds_unflushed_writes(dataset_id):
            raise ValueError(
                f"dataset {dataset_id!r} holds unflushed writes "
                f"({len(self.store.dirty_chunks(dataset_id))} dirty chunks, "
                f"{self.store.pending_write_bytes(dataset_id)} buffered bytes); "
                f"flush (WritePlane.drain) before evicting"
            )
        entry.state = CacheState.EVICTING
        if entry.fill_plane is not None:
            entry.fill_plane.cancel()
            entry.fill_plane = None
        self.store.delete(dataset_id)
        entry.nodes = []
        entry.state = CacheState.REGISTERED
        self._log("evict", dataset_id)

    def evict_chunks(self, dataset_id: str, n_bytes: float) -> int:
        """Chunk-granular LRU: demote the *coldest* resident chunks
        until ``n_bytes`` of cache are freed; returns the bytes actually
        freed (possibly 0, never raises for "nothing demotable").

        The non-destructive counterpart of :meth:`evict`: the dataset
        survives — CACHED degrades to PARTIAL, demoted chunks read through
        to the remote store and can be re-promoted by
        :meth:`promote_chunks`.  Safety mirrors whole-dataset eviction at
        chunk granularity: pinned datasets and datasets with live readers
        are refused outright, and dirty (unflushed write-back), un-fsync'd
        or mid-migration chunks are never victims (``demote_chunks`` skips
        them), so written data can never be shed to remote-less oblivion.
        """
        entry = self._require(dataset_id)
        if dataset_id not in self.store.manifests:
            return 0
        if entry.pinned or entry.active_readers > 0:
            return 0
        man = self.store.manifests[dataset_id]
        heat = self.store.chunk_heat(dataset_id)
        resident = [c for c in range(man.n_chunks) if man.chunk_nodes[c]]
        # coldest first; equal heat falls back to ascending chunk index so
        # the victim order is deterministic under PYTHONHASHSEED
        resident.sort(key=lambda c: (heat[c], c))
        freed = 0
        for c in resident:
            if freed >= n_bytes:
                break
            freed += self.store.demote_chunks(dataset_id, [c])
        if freed:
            if (
                entry.state is CacheState.CACHED
                and self.store.resident_fraction(dataset_id) < 1.0
            ):
                entry.state = CacheState.PARTIAL
            self._log("demote", dataset_id)
        return freed

    def promote_chunks(
        self, dataset_id: str, n_chunks: Optional[int] = None
    ) -> list[int]:
        """Re-grant stripe replicas to the hottest non-resident chunks.

        Grants up to ``n_chunks`` chunks (default: as many as free capacity
        on the dataset's member nodes allows), flips a terminal PARTIAL
        entry back to FILLING with a fresh ``fill_done`` event, and leaves
        the byte movement to the fill plane: a ``FillTracker`` /
        ``PrefetchScheduler`` lands the granted chunks through
        ``put_chunk`` -> :meth:`note_chunk_filled`, which re-promotes the
        entry to PARTIAL or — at full residency — CACHED.  Returns the
        chunk indices granted.
        """
        entry = self._require(dataset_id)
        if dataset_id not in self.store.manifests:
            raise ValueError(f"dataset {dataset_id!r} is not admitted")
        man = self.store.manifests[dataset_id]
        non_resident = [c for c in range(man.n_chunks) if not man.chunk_nodes[c]]
        if not non_resident:
            return []
        chunk_charge = man.chunk_bytes * man.replication
        members = [self.topology.node(nid) for nid in man.node_ids]
        fit = int(self.free_bytes(members) // max(1, chunk_charge))
        want = len(non_resident) if n_chunks is None else min(int(n_chunks), len(non_resident))
        want = min(want, fit)
        if want <= 0:
            return []
        heat = self.store.chunk_heat(dataset_id)
        non_resident.sort(key=lambda c: (-heat[c], c))     # hottest first
        granted = self.store.grant_chunks(dataset_id, non_resident[:want])
        if granted and entry.state in (CacheState.CACHED, CacheState.PARTIAL):
            entry.state = CacheState.FILLING
            entry.fill_done = self.clock.event()
            self._log("promote", dataset_id)
        return granted

    def delete(self, dataset_id: str) -> None:
        """Remove the dataset from the cache *and* the registry."""
        entry = self.entries.get(dataset_id)
        if entry and entry.state in (
            CacheState.CACHED,
            CacheState.FILLING,
            CacheState.PARTIAL,
        ):
            self.evict(dataset_id)
        self.entries.pop(dataset_id, None)
