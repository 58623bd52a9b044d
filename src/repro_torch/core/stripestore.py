"""Real-bytes stripe store: datasets chunked + striped across node-local dirs.

This is Requirement 1 made concrete: a dataset is split into fixed-size
chunks, and chunks are placed round-robin (optionally replicated ``r`` ways —
a beyond-paper fault-tolerance extension) across the NVMe directories of the
*cache-node subset* chosen by the placement engine.  The aggregate capacity
of the subset, not any single node, bounds dataset size.

Two modes share all metadata logic:

* ``materialize=True``  — chunks are real files under ``root/<node>/...`` with
  CRC32 integrity; reads return real bytes.  Used by tests and the real
  training examples.
* ``materialize=False`` — accounting-only (paper-scale simulations move ~TBs;
  we book the bytes on the simulated fabric instead of the container disk).

The manifest maps ``chunk -> [replica nodes]`` and records item geometry so a
reader can locate the chunk (and the best replica) for any item index.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from .readsched import ReadScheduler, stable_mix
from .topology import Node, Topology


class StripeError(RuntimeError):
    pass


# On-disk manifest schema.  v1 (implicit, pre-versioning) blobs carry no
# ``schema_version`` key and may omit ``chunk_filled`` entirely — an empty
# fill mask means "fully filled at create time" (see ``is_filled``).  v2 adds
# the explicit version field so HoardFS metadata can evolve safely.  v3 adds
# ``membership_epoch``, the monotonic cluster-view generation stamped by the
# elastic rebalancer (:mod:`repro.core.rebalance`); v1/v2 blobs load as
# epoch 0 (the pre-elastic world had exactly one membership view).  v4 adds
# ``chunk_dirty``, the write-back mask for the bidirectional data plane: a
# dirty chunk holds committed (fsync'd) writes that have not yet been flushed
# to the remote store; pre-write-path blobs load with an empty (all-clean)
# mask.
MANIFEST_SCHEMA_VERSION = 4


class ChunkCorruption(StripeError):
    pass


@dataclass
class StripeManifest:
    dataset_id: str
    n_items: int
    item_bytes: int
    items_per_chunk: int
    replication: int
    node_ids: list[int]                      # cache-node subset, in stripe order
    chunk_nodes: list[list[int]] = field(default_factory=list)  # chunk -> replicas
    chunk_crc: list[int] = field(default_factory=list)
    materialized: bool = False
    # per-chunk fill state for the on-demand (first-epoch) fill path; empty
    # list (old manifests) means fully filled at create time
    chunk_filled: list[bool] = field(default_factory=list)
    # cluster-view generation (schema v3): bumped by the rebalancer whenever
    # this dataset's membership changes (add/remove/fail); readers use it to
    # detect that placements moved under them
    membership_epoch: int = 0
    # write-back state (schema v4): chunk holds committed writes not yet
    # flushed to remote; empty list (pre-write-path manifests) = all clean
    chunk_dirty: list[bool] = field(default_factory=list)

    def is_filled(self, chunk: int) -> bool:
        return not self.chunk_filled or self.chunk_filled[chunk]

    def is_dirty(self, chunk: int) -> bool:
        return bool(self.chunk_dirty) and self.chunk_dirty[chunk]

    def is_resident(self, chunk: int) -> bool:
        """True when the chunk holds (or is reserved to hold) cache replicas.

        Partial caching distinguishes two zero-byte situations:
        an *unfilled* resident chunk (replicas reserved, fill pending) and a
        *non-resident* chunk (no replicas at all — reads fall through to the
        remote store).  A chunk that is ``filled`` but replica-less is data
        *lost* to node failure, a third, error-surfacing state.
        """
        return bool(self.chunk_nodes[chunk])

    @property
    def n_resident(self) -> int:
        return sum(1 for reps in self.chunk_nodes if reps)

    @property
    def n_dirty(self) -> int:
        return int(sum(self.chunk_dirty)) if self.chunk_dirty else 0

    @property
    def n_filled(self) -> int:
        return self.n_chunks if not self.chunk_filled else int(sum(self.chunk_filled))

    @property
    def n_chunks(self) -> int:
        return (self.n_items + self.items_per_chunk - 1) // self.items_per_chunk

    @property
    def chunk_bytes(self) -> int:
        return self.items_per_chunk * self.item_bytes

    @property
    def total_bytes(self) -> int:
        return self.n_items * self.item_bytes

    def chunk_of_item(self, item: int) -> int:
        return item // self.items_per_chunk

    def to_json(self) -> str:
        return json.dumps({"schema_version": MANIFEST_SCHEMA_VERSION, **self.__dict__})

    @classmethod
    def from_json(cls, blob: str) -> "StripeManifest":
        d = json.loads(blob)
        version = d.pop("schema_version", 1)   # pre-versioning blobs are v1
        if version > MANIFEST_SCHEMA_VERSION:
            raise StripeError(
                f"manifest schema v{version} is newer than this reader "
                f"(v{MANIFEST_SCHEMA_VERSION}); refusing to guess"
            )
        if version < 2:
            # legacy layout: the fill plane did not exist, so any missing
            # fill mask means "fully filled at create time"
            d.setdefault("chunk_filled", [])
        if version < 3:
            # pre-elastic manifests were written under the one-and-only
            # membership view; epoch 0 by definition
            d.setdefault("membership_epoch", 0)
        if version < 4:
            # the write path did not exist: nothing can be dirty
            d.setdefault("chunk_dirty", [])
        return cls(**d)


@dataclass
class _PendingWrite:
    """Un-fsync'd write buffer for one chunk, owned by one writer node.

    The overlay lives on the writer's NVMe (charged via
    ``write_buffer_bytes``) until ``commit_writes`` replicates + applies it
    atomically, or the writer fails and the whole buffer vanishes — a torn
    write is never partially visible (crash-consistency contract).
    """

    writer: int
    segs: list = field(default_factory=list)     # merged (lo, hi) intervals
    nbytes: int = 0                              # total covered bytes
    data: Optional[bytearray] = None             # full chunk image (materialized)

    def add(self, lo: int, hi: int) -> int:
        """Merge ``[lo, hi)`` into the covered set; return newly covered bytes."""
        segs = sorted(self.segs + [(lo, hi)])
        merged: list[tuple[int, int]] = []
        for s_lo, s_hi in segs:
            if merged and s_lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], s_hi))
            else:
                merged.append((s_lo, s_hi))
        total = sum(h - l for l, h in merged)
        delta = total - self.nbytes
        self.segs, self.nbytes = merged, total
        return delta


class StripeStore:
    """Chunk placement, IO accounting and (optionally) real file IO."""

    def __init__(self, topology: Topology, root: Optional[str] = None):
        self.topology = topology
        self.root = root
        self.manifests: dict[str, StripeManifest] = {}
        # contention-aware read scheduler: per-disk read queues, live load
        # signal for replica scoring, per-replica served-byte telemetry
        self.readsched = ReadScheduler(topology)
        # per-dataset replica matrix (n_chunks x max-replicas node ids, short
        # rows -1-padded, an all--1 row = data lost), cached for
        # locate_batch's per-batch hot path; invalidated whenever
        # fail_node/repair/drain/delete rewrite chunk placements
        self._replica_mat: dict[str, np.ndarray] = {}
        # per-reader distance row over all nodes (topology is immutable)
        self._dist_rows: dict[int, np.ndarray] = {}
        # replicas rewritten in place after a CRC/missing-file fallback
        self.corruption_repairs = 0
        # bytes of cache data resident per node (for capacity accounting)
        self.node_usage: dict[int, int] = {n.node_id: 0 for n in topology.nodes}
        # reserved-but-unfilled bytes per node (incremental mirror of the
        # manifests' chunk_filled state; placement reads this per candidate
        # node, so it must stay O(1))
        self._pending_fill: dict[int, int] = {n.node_id: 0 for n in topology.nodes}
        # in-flight chunk transfers (elastic rebalancing, repro.core.rebalance):
        # (dataset, chunk) -> (src or None, dst, kind).  The destination's
        # capacity is reserved at begin_transfer so admission control cannot
        # oversubscribe a node mid-rebalance; the manifest itself only changes
        # at commit_transfer (dual-epoch reads: old placement serves until the
        # move commits).
        self._migrating: dict[tuple[str, int], tuple[Optional[int], int, str]] = {}
        self._migration_in: dict[int, int] = {n.node_id: 0 for n in topology.nodes}
        self._migration_out: dict[int, int] = {n.node_id: 0 for n in topology.nodes}
        # ---- write plane (bidirectional data plane) ----
        # un-fsync'd write buffers: (dataset, chunk) -> overlay owned by one
        # writer node; invisible to durability until commit_writes
        self._pending_writes: dict[tuple[str, int], _PendingWrite] = {}
        # O(1) per-node bytes of un-fsync'd buffers on the writer's NVMe
        # (extra bytes beyond node_usage — placement/admission must see them)
        self._write_buffer: dict[int, int] = {n.node_id: 0 for n in topology.nodes}
        # O(1) per-node bytes of committed-but-unflushed (dirty) chunk
        # replicas; each replica copy counts chunk_bytes
        self._dirty: dict[int, int] = {n.node_id: 0 for n in topology.nodes}
        # modeled remote object store: flushed chunk blobs survive eviction
        # (delete keeps this map), so an overwrite->evict->refetch round-trip
        # returns the written bytes, not the synthetic default payload
        self._remote: dict[tuple[str, int], bytes] = {}
        # ---- per-chunk access heat (partial caching) ----
        # exponentially-decayed access counter per chunk:
        #   heat(t) = heat(t0) * 2^(-(t - t0) / halflife) + new accesses.
        # Decay is applied lazily (per dataset, at read time), so the hot
        # path is one np.add.at.  Heat survives delete() like _remote: a
        # re-admission under pressure should cache the chunks history says
        # are hot, not the first k by index.
        self.heat_halflife: float = 60.0
        self._heat: dict[str, np.ndarray] = {}
        self._heat_t: dict[str, float] = {}

    # ----------------------------------------------------------------- create
    def create(
        self,
        dataset_id: str,
        n_items: int,
        item_bytes: int,
        nodes: Sequence[Node],
        *,
        items_per_chunk: int = 4096,
        replication: int = 1,
        materialize: bool = False,
        payload: Optional[Callable[[int], bytes]] = None,
        prefill: bool = True,
        resident_chunks: Optional[Sequence[int]] = None,
    ) -> StripeManifest:
        """Lay out (and optionally write) a dataset across ``nodes``.

        ``payload(chunk_idx) -> bytes`` supplies real chunk contents when
        materializing; defaults to a deterministic pseudo-random fill.

        ``prefill=False`` reserves the stripe layout (placement + capacity)
        but marks every chunk *unfilled*: the on-demand fill path
        (:mod:`repro_torch.core.prefetch`) later lands chunks one at a time via
        :meth:`put_chunk` while epoch 1 of the training job is running.
        Capacity is charged up front for every *resident* chunk.

        ``resident_chunks`` (partial caching) restricts the stripe
        to a subset of chunk indices: chunks outside the subset get an empty
        replica list, no capacity charge, and stay permanently unfilled until
        :meth:`grant_chunks` promotes them — reads fall through to the remote
        store.  ``None`` (the default) keeps the all-or-nothing contract.
        """
        if dataset_id in self.manifests:
            raise StripeError(f"dataset {dataset_id!r} already striped")
        if replication > len(nodes):
            raise StripeError("replication factor exceeds cache-node subset size")
        man = StripeManifest(
            dataset_id=dataset_id,
            n_items=int(n_items),
            item_bytes=int(item_bytes),
            items_per_chunk=int(items_per_chunk),
            replication=int(replication),
            node_ids=[n.node_id for n in nodes],
            materialized=materialize,
        )
        resident = None
        if resident_chunks is not None:
            resident = {int(c) for c in resident_chunks}
            if not resident:
                raise StripeError("resident_chunks must name at least one chunk")
            if min(resident) < 0 or max(resident) >= man.n_chunks:
                raise StripeError("resident_chunks outside [0, n_chunks)")
        nn = len(nodes)
        for c in range(man.n_chunks):
            if resident is not None and c not in resident:
                # non-resident: no replicas, no bytes, reads fall through to
                # the remote store via the data plane's read-through path
                man.chunk_nodes.append([])
                man.chunk_filled.append(False)
                man.chunk_crc.append(0)
                continue
            replicas = [man.node_ids[(c + r) % nn] for r in range(replication)]
            man.chunk_nodes.append(replicas)
            man.chunk_filled.append(bool(prefill))
            if materialize and prefill:
                # remote_payload, not _default_payload: a re-admission after
                # flushed overwrites must deliver what the remote store holds
                blob = payload(c) if payload else self.remote_payload(man, c)
                crc = zlib.crc32(blob)
                man.chunk_crc.append(crc)
                for node_id in replicas:
                    path = self._chunk_path(dataset_id, node_id, c)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "wb") as fh:
                        fh.write(blob)
            else:
                man.chunk_crc.append(0)
            for node_id in replicas:
                self.node_usage[node_id] += man.chunk_bytes
                if not prefill:
                    self._pending_fill[node_id] += man.chunk_bytes
        self.manifests[dataset_id] = man
        if materialize and self.root:
            with open(os.path.join(self.root, f"{dataset_id}.manifest.json"), "w") as fh:
                fh.write(man.to_json())
        return man

    def _default_payload(self, man: StripeManifest, chunk: int) -> bytes:
        # CRC32, not hash(): payload bytes must not vary with PYTHONHASHSEED
        # (the crash-consistency suite fingerprints content across fresh
        # interpreters; hash() is randomized per process)
        seed = zlib.crc32(f"{man.dataset_id}:{chunk}".encode())
        rng = np.random.default_rng(seed)
        return rng.bytes(man.chunk_bytes)

    def remote_payload(self, man: StripeManifest, chunk: int) -> bytes:
        """Chunk content as the remote store would serve it.

        A chunk that was flushed (write-back/write-through) serves the
        flushed blob; anything never written serves the deterministic
        synthetic payload.  Refetch and on-demand re-fill both resolve
        through here, so written bytes survive eviction round-trips.
        """
        blob = self._remote.get((man.dataset_id, chunk))
        return blob if blob is not None else self._default_payload(man, chunk)

    def _chunk_path(self, dataset_id: str, node_id: int, chunk: int) -> str:
        if not self.root:
            raise StripeError("materialized store needs a root directory")
        return os.path.join(self.root, f"node{node_id}", dataset_id, f"chunk_{chunk:06d}")

    # ------------------------------------------------------------- fill plane
    def put_chunk(
        self, dataset_id: str, chunk: int, payload: Optional[Callable[[int], bytes]] = None
    ) -> bool:
        """Land one remote chunk into its stripe replicas (on-demand fill).

        Marks the chunk filled (idempotent; returns ``True`` only on the
        filling transition) and, in materialized mode, writes the real bytes
        + CRC to every replica.  Called by the fill data plane
        (:class:`repro_torch.core.prefetch.FillTracker`) when a remote->stripe
        transfer completes, never directly by readers.  Replicas are
        resolved *now*, not at demand time, so a fill that raced an elastic
        metadata retarget lands at the chunk's post-move placement.
        """
        man = self.manifests[dataset_id]
        if man.is_filled(chunk):
            return False
        if not man.chunk_nodes[chunk]:
            # non-resident (partial admission) or wholly lost while the fill
            # was in flight: there is nowhere to land the bytes, and flipping
            # the filled bit here would fabricate a lost-data state
            return False
        if man.materialized:
            blob = payload(chunk) if payload else self.remote_payload(man, chunk)
            man.chunk_crc[chunk] = zlib.crc32(blob)
            for node_id in man.chunk_nodes[chunk]:
                path = self._chunk_path(dataset_id, node_id, chunk)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(blob)
        man.chunk_filled[chunk] = True
        for node_id in man.chunk_nodes[chunk]:
            self._pending_fill[node_id] -= man.chunk_bytes
        return True

    def filled_fraction(self, dataset_id: str) -> float:
        man = self.manifests[dataset_id]
        return man.n_filled / max(1, man.n_chunks)

    def unfilled_chunks(self, dataset_id: str) -> np.ndarray:
        man = self.manifests[dataset_id]
        if not man.chunk_filled:
            return np.empty(0, dtype=np.int64)
        return np.flatnonzero(~np.asarray(man.chunk_filled, dtype=bool))

    def chunk_filled_mask(self, dataset_id: str, chunks: np.ndarray) -> np.ndarray:
        """Vectorised fill state for an array of chunk indices."""
        man = self.manifests[dataset_id]
        if not man.chunk_filled:
            return np.ones(len(chunks), dtype=bool)
        return np.asarray(man.chunk_filled, dtype=bool)[chunks]

    def pending_fill_bytes(self, node_id: int) -> int:
        """Bytes a node still expects from remote (reserved, unfilled chunks).

        The placement engine uses this as ingest-pressure scoring: during an
        on-demand fill these bytes will cross the node's NIC and NVMe write
        queue, so compute placed there competes with the fill.  O(1): an
        incremental counter maintained by create/put_chunk/repair/drain/
        fail_node/delete, never a manifest scan.
        """
        return self._pending_fill[node_id]

    # ------------------------------------- partial residency + heat
    def chunk_resident_mask(self, dataset_id: str, chunks: np.ndarray) -> np.ndarray:
        """Vectorised residency (has >= 1 replica) for an array of chunk idx."""
        mat = self._replica_matrix(dataset_id)
        return mat[np.asarray(chunks, dtype=np.int64), 0] >= 0

    def resident_fraction(self, dataset_id: str) -> float:
        man = self.manifests[dataset_id]
        return man.n_resident / max(1, man.n_chunks)

    def resident_filled_fraction(self, dataset_id: str) -> float:
        """Filled fraction *of the resident subset* — the fill plane's notion
        of done for a partially-admitted dataset (a fill is complete when
        every chunk that has somewhere to land has landed)."""
        man = self.manifests[dataset_id]
        return man.n_filled / max(1, man.n_resident)

    def dataset_resident_bytes(self, dataset_id: str) -> int:
        """Replica bytes this dataset occupies (or has reserved) cluster-wide.

        Chunk-padded and replication-weighted: the exact capacity charge,
        and — divided across the stripe nodes — the exact per-node byte
        count an on-demand fill will stream through ``put_chunk``.
        """
        man = self.manifests[dataset_id]
        return sum(len(reps) * man.chunk_bytes for reps in man.chunk_nodes)

    def note_chunk_access(self, dataset_id: str, chunks: np.ndarray) -> None:
        """Bump the decayed per-chunk access counter (one hit per entry).

        ``chunks`` may repeat (per-item chunk indices of a batch); repeats
        accumulate.  Decay is applied lazily per dataset:
        ``heat *= 2 ** (-(now - t_last) / halflife)`` before the bump.
        """
        man = self.manifests.get(dataset_id)
        if man is None:
            return
        now = self.topology.clock.now
        heat = self._heat.get(dataset_id)
        if heat is None or len(heat) != man.n_chunks:
            heat = np.zeros(man.n_chunks, dtype=np.float64)
            self._heat[dataset_id] = heat
            self._heat_t[dataset_id] = now
        dt = now - self._heat_t[dataset_id]
        if dt > 0:
            heat *= 2.0 ** (-dt / self.heat_halflife)
            self._heat_t[dataset_id] = now
        np.add.at(heat, np.asarray(chunks, dtype=np.int64), 1.0)

    def chunk_heat(self, dataset_id: str, n_chunks: Optional[int] = None) -> np.ndarray:
        """Current decayed heat per chunk (a copy; zeros when never touched).

        ``n_chunks`` lets admission consult the surviving heat history of a
        dataset that is not currently striped (heat outlives :meth:`delete`,
        so a re-admission under pressure caches the historically hot subset).
        """
        man = self.manifests.get(dataset_id)
        if n_chunks is None:
            n_chunks = man.n_chunks if man is not None else 0
        n = int(n_chunks)
        heat = self._heat.get(dataset_id)
        if heat is None or len(heat) != n:
            return np.zeros(n, dtype=np.float64)
        dt = self.topology.clock.now - self._heat_t[dataset_id]
        if dt > 0:
            return heat * 2.0 ** (-dt / self.heat_halflife)
        return heat.copy()

    def demote_chunks(self, dataset_id: str, chunks: Sequence[int]) -> int:
        """Drop the cache replicas of the given chunks (chunk-granular LRU).

        A demoted chunk becomes *non-resident*: no replicas, not filled,
        reads fall through to the remote store, and :meth:`grant_chunks` can
        re-promote it later.  Chunks that are dirty (unflushed write-back),
        carry un-fsync'd overlays, or are mid-migration are silently skipped
        — demotion must never discard bytes the remote store doesn't hold.
        Returns the cache bytes freed (summed across replicas).
        """
        man = self.manifests[dataset_id]
        freed = 0
        touched = False
        for chunk in chunks:
            c = int(chunk)
            replicas = man.chunk_nodes[c]
            if not replicas:
                continue
            if man.is_dirty(c) or self.is_migrating(dataset_id, c):
                continue
            if (dataset_id, c) in self._pending_writes:
                continue
            for node_id in replicas:
                self.node_usage[node_id] -= man.chunk_bytes
                if not man.is_filled(c):
                    self._pending_fill[node_id] -= man.chunk_bytes
                if man.materialized:
                    path = self._chunk_path(dataset_id, node_id, c)
                    if os.path.exists(path):
                        os.remove(path)
                freed += man.chunk_bytes
            man.chunk_nodes[c] = []
            if not man.chunk_filled:
                man.chunk_filled = [True] * man.n_chunks
            man.chunk_filled[c] = False
            touched = True
        if touched:
            self._replica_mat.pop(dataset_id, None)
        return freed

    def grant_chunks(self, dataset_id: str, chunks: Sequence[int]) -> list[int]:
        """Reserve replicas for non-resident chunks (promotion / re-admission).

        Each granted chunk gets ``man.replication`` replicas on the
        least-loaded members of the dataset's node set, charged as
        reserved-but-unfilled capacity; the fill plane later lands the bytes
        through :meth:`put_chunk`.  Already-resident chunks are skipped.
        Returns the chunk indices actually granted.
        """
        man = self.manifests[dataset_id]
        granted: list[int] = []
        for chunk in chunks:
            c = int(chunk)
            if man.chunk_nodes[c]:
                continue
            picks: list[int] = []
            for _ in range(man.replication):
                candidates = [nid for nid in man.node_ids if nid not in picks]
                if not candidates:
                    break
                picks.append(min(candidates, key=lambda nid: self.node_usage[nid]))
            if not picks:
                continue
            man.chunk_nodes[c] = picks
            if not man.chunk_filled:
                man.chunk_filled = [True] * man.n_chunks
            man.chunk_filled[c] = False
            for node_id in picks:
                self.node_usage[node_id] += man.chunk_bytes
                self._pending_fill[node_id] += man.chunk_bytes
            granted.append(c)
        if granted:
            self._replica_mat.pop(dataset_id, None)
        return granted

    # ------------------------------------------------------------ write plane
    # Bidirectional data plane.  Writes move through three states:
    #
    #   buffered  — ``write_pending`` stages bytes in a per-(dataset, chunk)
    #               overlay on the *writer's* NVMe.  Readers see them
    #               (read-your-writes) but durability does not: a writer
    #               failure discards whole overlays, never partial bytes.
    #   committed — ``commit_writes`` (the fsync point) applies an overlay to
    #               every replica atomically and marks the chunk *dirty*
    #               under write-back: durable against any single node loss
    #               (the flow layer guarantees >= 2 independent copies —
    #               peer replicas or the remote store — before committing).
    #   flushed   — ``mark_flushed`` clears the dirty bit once the chunk's
    #               committed content lands in the remote store; the blob is
    #               retained in ``_remote`` so refetch/re-fill round-trips
    #               return written bytes.
    #
    # Timing (NVMe/NIC/uplink flows, policies, compression) lives in
    # :mod:`repro_torch.core.writeplane`; this layer is pure metadata + bytes.

    def write_pending(
        self, dataset_id: str, chunk: int, offset: int, data, writer: int
    ) -> int:
        """Stage bytes into a chunk's un-fsync'd overlay; returns newly
        buffered bytes (0 when rewriting an already-buffered range).

        ``data`` is ``bytes`` (materialized mode) or an ``int`` byte count
        (accounting-only simulations).  One writer owns a chunk's overlay at
        a time — checkpoint shards are per-node files, so concurrent writers
        on one chunk indicate a layering bug, not a workload.
        """
        man = self.manifests[dataset_id]
        nbytes = len(data) if isinstance(data, (bytes, bytearray, memoryview)) else int(data)
        if nbytes <= 0:
            return 0
        if not man.is_filled(chunk):
            raise StripeError(
                f"{dataset_id} chunk {chunk} not filled; writable datasets must "
                "be admitted prefilled"
            )
        if offset < 0 or offset + nbytes > man.chunk_bytes:
            raise StripeError(f"write [{offset}, {offset + nbytes}) outside chunk")
        key = (dataset_id, chunk)
        p = self._pending_writes.get(key)
        if p is None:
            p = self._pending_writes[key] = _PendingWrite(writer=writer)
        elif p.writer != writer:
            raise StripeError(
                f"{dataset_id}:{chunk} has a pending write from node {p.writer}; "
                f"node {writer} cannot interleave"
            )
        if man.materialized and isinstance(data, (bytes, bytearray, memoryview)):
            if p.data is None:
                # seed the image from committed content so unwritten ranges
                # read back exactly what durability would serve
                p.data = bytearray(
                    self.read_chunk_verified(dataset_id, chunk, self.topology.node(writer))
                )
            p.data[offset : offset + nbytes] = bytes(data)
        delta = p.add(offset, offset + nbytes)
        self._write_buffer[writer] += delta
        return delta

    def pending_chunks(self, dataset_id: str, writer: Optional[int] = None) -> list[int]:
        """Chunk indices holding un-fsync'd overlays (optionally one writer's)."""
        return sorted(
            c
            for (ds, c), p in self._pending_writes.items()
            if ds == dataset_id and (writer is None or p.writer == writer)
        )

    def pending_write_bytes(self, dataset_id: str) -> int:
        """Un-fsync'd buffered bytes for one dataset (CacheManager.ls)."""
        return sum(
            p.nbytes for (ds, _c), p in self._pending_writes.items() if ds == dataset_id
        )

    def write_buffer_bytes(self, node_id: int) -> int:
        """Un-fsync'd overlay bytes buffered on a node's NVMe.

        These sit *outside* ``node_usage`` (the committed chunk copy is
        already charged), so admission control and placement scoring must
        add them explicitly or a node whose NVMe holds write buffers looks
        emptier than it is.  O(1) incremental counter.
        """
        return self._write_buffer[node_id]

    def commit_writes(
        self, dataset_id: str, chunks: Sequence[int], writer: int
    ) -> list[int]:
        """Atomically apply a writer's overlays to every replica (the fsync
        commit point); returns the chunk indices actually committed.

        All listed chunks commit in one metadata step — an fsync is
        all-or-nothing even when the write straddled chunk boundaries,
        matching :mod:`repro_torch.train.checkpoint`'s atomic-rename contract.
        Overlays discarded by an earlier writer failure simply no longer
        exist, so a commit callback racing a crash commits nothing.
        """
        man = self.manifests.get(dataset_id)
        if man is None:
            return []
        committed: list[int] = []
        for chunk in chunks:
            key = (dataset_id, int(chunk))
            p = self._pending_writes.get(key)
            if p is None or p.writer != writer:
                continue
            replicas = man.chunk_nodes[key[1]]
            if not replicas:
                continue                         # wholly lost mid-fsync: keep buffering
            if man.materialized and p.data is not None:
                blob = bytes(p.data)
                man.chunk_crc[key[1]] = zlib.crc32(blob)
                for node_id in replicas:
                    path = self._chunk_path(dataset_id, node_id, key[1])
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "wb") as fh:
                        fh.write(blob)
            if not man.chunk_dirty:
                man.chunk_dirty = [False] * man.n_chunks
            if not man.chunk_dirty[key[1]]:
                man.chunk_dirty[key[1]] = True
                for node_id in replicas:
                    self._dirty[node_id] += man.chunk_bytes
            del self._pending_writes[key]
            self._write_buffer[writer] -= p.nbytes
            committed.append(key[1])
        return committed

    def discard_pending(
        self, dataset_id: Optional[str] = None, writer: Optional[int] = None
    ) -> int:
        """Drop un-fsync'd overlays (crash semantics / eviction cleanup).

        Whole overlays vanish — never a byte range — so a torn write is
        all-invisible after the writer fails.  Returns overlays discarded.
        """
        doomed = [
            key
            for key, p in self._pending_writes.items()
            if (dataset_id is None or key[0] == dataset_id)
            and (writer is None or p.writer == writer)
        ]
        for key in doomed:
            p = self._pending_writes.pop(key)
            self._write_buffer[p.writer] -= p.nbytes
        return len(doomed)

    def mark_flushed(self, dataset_id: str, chunk: int) -> bool:
        """Clear a chunk's dirty bit after its bytes land in the remote store.

        Retains the flushed blob in the modeled remote store (materialized
        mode) so a later eviction + refetch serves the written content.
        Returns ``True`` only on the dirty->clean transition.
        """
        man = self.manifests[dataset_id]
        if not man.is_dirty(chunk):
            return False
        if man.materialized and man.chunk_nodes[chunk]:
            reader = self.topology.node(man.chunk_nodes[chunk][0])
            self._remote[(dataset_id, chunk)] = self.read_chunk_verified(
                dataset_id, chunk, reader
            )
        man.chunk_dirty[chunk] = False
        for node_id in man.chunk_nodes[chunk]:
            self._dirty[node_id] -= man.chunk_bytes
        return True

    def dirty_chunks(self, dataset_id: str) -> list[int]:
        """Committed-but-unflushed chunk indices, ascending (flush order)."""
        man = self.manifests[dataset_id]
        if not man.chunk_dirty:
            return []
        return [c for c, d in enumerate(man.chunk_dirty) if d]

    def dataset_dirty_bytes(self, dataset_id: str) -> int:
        """Logical unflushed bytes of one dataset (one copy, not x replicas)."""
        man = self.manifests[dataset_id]
        return man.n_dirty * man.chunk_bytes

    def dirty_bytes(self, node_id: int) -> int:
        """Bytes of dirty (unflushed write-back) chunk replicas on a node.

        Counterpart of :meth:`pending_fill_bytes` for the write path: these
        bytes will cross the node's read disks, NIC-tx and the shared uplink
        when the flusher drains them, so placement scoring treats them as
        pressure.  O(1) incremental counter.
        """
        return self._dirty[node_id]

    # -------------------------------------------------------- elastic moves
    # The rebalancer's two-phase chunk-transfer protocol.  ``begin_transfer``
    # reserves the destination (capacity + migration counters) while the
    # bytes cross the simulated fabric; ``commit_transfer`` is the *only*
    # point at which the manifest placement changes, so every read issued
    # mid-move resolves against the old placement (the source replica keeps
    # serving) and every read after the commit resolves against the new one —
    # the dual-epoch lookup the elastic tier needs with zero read-path cost.

    TRANSFER_KINDS = ("move", "repair", "refetch")

    def is_migrating(self, dataset_id: str, chunk: int) -> bool:
        return (dataset_id, chunk) in self._migrating

    def migrating_chunks(self, dataset_id: str) -> int:
        """In-flight transfer count for one dataset (CacheManager.ls)."""
        return sum(1 for ds, _c in self._migrating if ds == dataset_id)

    def migration_in_bytes(self, node_id: int) -> int:
        """Bytes of in-flight migration traffic *targeting* a node.

        Reserved at ``begin_transfer`` time: the destination's NVMe write
        queue and NIC will carry these bytes, and its capacity is already
        charged (``node_usage``), so placement scoring and admission control
        see a mid-rebalance node as busy/full rather than free.  O(1).
        """
        return self._migration_in[node_id]

    def migration_out_bytes(self, node_id: int) -> int:
        """Bytes of in-flight migration traffic *sourced from* a node."""
        return self._migration_out[node_id]

    def read_load_bytes(self, node_id: int) -> float:
        """Live *read-serving* backlog of a node (readsched queue depth).

        The read-side analogue of :meth:`pending_fill_bytes`: bytes queued
        on the node's read disks and NIC-tx right now — NVMe *write*
        backlog is excluded, because fill/migration landings are already
        priced by ``pending_fill_bytes``/``migration_in_bytes`` and must
        not be double-counted.  The placement engine folds this into its
        serving-pressure scoring so compute and new stripes steer away from
        nodes that are busy serving replica reads.
        """
        return self.readsched.queue_bytes(node_id)

    def begin_transfer(
        self, dataset_id: str, chunk: int, src: Optional[int], dst: int, kind: str = "move"
    ) -> bool:
        """Reserve ``dst`` for an in-flight chunk transfer; False = invalid.

        ``kind``: ``"move"`` replaces the ``src`` replica with ``dst`` at
        commit, ``"repair"`` adds ``dst`` as a new replica (copy from the
        surviving ``src``), ``"refetch"`` re-fetches a wholly-lost chunk from
        the remote store into ``dst`` (``src`` is None).  Only *filled*
        chunks move as flows — unfilled chunks are pure metadata and use
        :meth:`retarget_replica` / :meth:`assign_replica` instead.
        """
        if kind not in self.TRANSFER_KINDS:
            raise StripeError(f"unknown transfer kind {kind!r}")
        man = self.manifests.get(dataset_id)
        key = (dataset_id, chunk)
        if man is None or key in self._migrating:
            return False
        replicas = man.chunk_nodes[chunk]
        if kind == "refetch":
            # refetch is for *lost* chunks only: data existed (filled) and
            # every replica is gone; an unfilled lost chunk is re-granted via
            # assign_replica and re-fetched by the fill plane instead
            if replicas or src is not None or not man.is_filled(chunk):
                return False
        else:
            if src not in replicas or dst in replicas:
                return False
            if not man.is_filled(chunk):
                return False                     # unfilled = metadata-only ops
        self._migrating[key] = (src, dst, kind)
        self.node_usage[dst] += man.chunk_bytes
        self._migration_in[dst] += man.chunk_bytes
        if src is not None:
            self._migration_out[src] += man.chunk_bytes
        return True

    def commit_transfer(self, dataset_id: str, chunk: int) -> bool:
        """Land an in-flight transfer: the manifest flips to the new placement.

        Returns False when the transfer was aborted under us (node failure,
        dataset eviction, a concurrent maintenance op invalidating the move)
        — the caller simply drops the completion on the floor.
        """
        key = (dataset_id, chunk)
        entry = self._migrating.get(key)
        if entry is None:
            return False
        src, dst, kind = entry
        man = self.manifests[dataset_id]
        replicas = man.chunk_nodes[chunk]
        # re-validate against concurrent maintenance (drain/repair/fail ran
        # while the bytes were in flight): abort instead of corrupting
        if dst in replicas or (kind != "refetch" and src not in replicas):
            self.abort_transfer(dataset_id, chunk)
            return False
        del self._migrating[key]
        cb = man.chunk_bytes
        self._migration_in[dst] -= cb
        if src is not None:
            self._migration_out[src] -= cb
        self._replica_mat.pop(dataset_id, None)
        if kind == "refetch":
            replicas.append(dst)
            if man.chunk_filled:
                man.chunk_filled[chunk] = True
            # a refetched chunk carries the *remote* content by definition:
            # clean with respect to the remote store, whatever its old mask
            # said before the loss (dirty accounting for the lost replicas
            # was already released in fail_node)
            if man.chunk_dirty:
                man.chunk_dirty[chunk] = False
            if man.materialized:
                blob = self.remote_payload(man, chunk)
                man.chunk_crc[chunk] = zlib.crc32(blob)
                path = self._chunk_path(dataset_id, dst, chunk)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(blob)
            return True
        if man.materialized and man.is_filled(chunk):
            blob = self._read_chunk(man, src, chunk)
            path = self._chunk_path(dataset_id, dst, chunk)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as fh:
                fh.write(blob)
        if kind == "move":
            replicas[replicas.index(src)] = dst
            self.node_usage[src] -= cb
            if man.is_dirty(chunk):              # dirty debt moves with the copy
                self._dirty[src] -= cb
                self._dirty[dst] += cb
            if man.materialized:
                old = self._chunk_path(dataset_id, src, chunk)
                if os.path.exists(old):
                    os.remove(old)
        else:                                    # repair: dst joins the set
            replicas.append(dst)
            if man.is_dirty(chunk):
                self._dirty[dst] += cb
        return True

    def abort_transfer(self, dataset_id: str, chunk: int) -> bool:
        """Release an in-flight transfer's destination reservation."""
        entry = self._migrating.pop((dataset_id, chunk), None)
        if entry is None:
            return False
        src, dst, _kind = entry
        man = self.manifests[dataset_id]
        self.node_usage[dst] -= man.chunk_bytes
        self._migration_in[dst] -= man.chunk_bytes
        if src is not None:
            self._migration_out[src] -= man.chunk_bytes
        return True

    def _abort_transfers_touching(self, node_id: int) -> None:
        """Abort every in-flight transfer whose src or dst just failed."""
        doomed = [
            (ds, c)
            for (ds, c), (src, dst, _k) in self._migrating.items()
            if src == node_id or dst == node_id
        ]
        for ds, c in doomed:
            self.abort_transfer(ds, c)

    def retarget_replica(self, dataset_id: str, chunk: int, src: int, dst: int) -> None:
        """Metadata-only move of an *unfilled* chunk replica (no bytes exist).

        The eventual ``put_chunk`` writes every replica at its then-current
        placement, so a fill started before the retarget still lands at the
        post-move node — the prefetch plane needs no special casing.
        """
        man = self.manifests[dataset_id]
        if man.is_filled(chunk):
            raise StripeError(f"{dataset_id}:{chunk} is filled; move it as a flow")
        replicas = man.chunk_nodes[chunk]
        replicas[replicas.index(src)] = dst
        self._replica_mat.pop(dataset_id, None)
        self.node_usage[src] -= man.chunk_bytes
        self.node_usage[dst] += man.chunk_bytes
        self._pending_fill[src] -= man.chunk_bytes
        self._pending_fill[dst] += man.chunk_bytes

    def assign_replica(self, dataset_id: str, chunk: int, dst: int) -> None:
        """Metadata-only replica grant for an *unfilled* chunk (repair path)."""
        man = self.manifests[dataset_id]
        if man.is_filled(chunk):
            raise StripeError(f"{dataset_id}:{chunk} is filled; repair it as a flow")
        replicas = man.chunk_nodes[chunk]
        if dst in replicas:
            raise StripeError(f"{dataset_id}:{chunk} already has a replica on {dst}")
        replicas.append(dst)
        self._replica_mat.pop(dataset_id, None)
        self.node_usage[dst] += man.chunk_bytes
        self._pending_fill[dst] += man.chunk_bytes

    def update_membership(self, dataset_id: str, node_ids: Sequence[int], epoch: int) -> None:
        """Stamp a new membership view into the manifest (schema v3)."""
        man = self.manifests[dataset_id]
        if epoch < man.membership_epoch:
            raise StripeError(
                f"{dataset_id}: membership epoch must be monotonic "
                f"({epoch} < {man.membership_epoch})"
            )
        man.node_ids = list(node_ids)
        man.membership_epoch = int(epoch)

    # ------------------------------------------------------------------ reads
    def _replica_matrix(self, dataset_id: str) -> np.ndarray:
        """Cached chunk -> candidate-replica matrix (an all--1 row = lost).

        Short rows (heterogeneous replica counts mid-repair) are padded with
        -1; the scorer masks pads to infinite cost, so a replica never
        appears twice in one row (cycling pads would win a hash tie twice as
        often, re-skewing the very slot balance this scheduler gates).
        Replaces the old per-call O(chunks x replication) Python loops over
        ``chunk_nodes`` — the matrix is built once per placement generation
        and batches resolve with pure numpy indexing.
        """
        mat = self._replica_mat.get(dataset_id)
        if mat is None:
            man = self.manifests[dataset_id]
            width = max((len(r) for r in man.chunk_nodes), default=1) or 1
            mat = np.full((man.n_chunks, width), -1, dtype=np.int64)
            for c, reps in enumerate(man.chunk_nodes):
                mat[c, : len(reps)] = reps
            self._replica_mat[dataset_id] = mat
        return mat

    def _dist_row(self, reader: Node) -> np.ndarray:
        """Cached reader -> per-node locality-class vector (topology is static)."""
        row = self._dist_rows.get(reader.node_id)
        if row is None:
            row = np.asarray(
                [self.topology.distance(reader, n) for n in self.topology.nodes],
                dtype=np.float64,
            )
            self._dist_rows[reader.node_id] = row
        return row

    def locate(self, dataset_id: str, item: int, reader: Node) -> Node:
        """Best replica for ``item`` read from ``reader`` (see locate_batch)."""
        nid = self.locate_batch(dataset_id, np.asarray([int(item)]), reader)[0]
        return self.topology.node(int(nid))

    def locate_batch(self, dataset_id: str, items: np.ndarray, reader: Node) -> np.ndarray:
        """Vectorised contention-aware replica selection per item.

        Each candidate replica scores ``locality_class + queued_bytes /
        queue_hop_bytes`` (:mod:`repro_torch.core.readsched`): closeness wins until
        a replica's serving backlog costs it a locality hop, so hot replicas
        shed readers.  Exact cost ties break by a stable hash of (reader,
        chunk) — equidistant readers spread across the replica set instead
        of all hammering the lowest node id.  ``locate`` delegates here, so
        scalar and batch resolution agree by construction.
        """
        return self.locate_batch_with_slots(dataset_id, items, reader)[0]

    def locate_batch_with_slots(
        self, dataset_id: str, items: np.ndarray, reader: Node
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """:meth:`locate_batch` + the chosen replica *slot* per item + width.

        The slot (the source's position in ``chunk_nodes``) falls out of the
        selection for free — column index == list index under -1 padding —
        and feeds the read scheduler's per-slot balance telemetry, the
        observable that catches a tie-break hotspot (per-node totals stay
        flat under one; see :meth:`ReadScheduler.read_imbalance`).
        """
        man = self.manifests[dataset_id]
        chunks = np.asarray(items, dtype=np.int64) // man.items_per_chunk
        # every located read is an access: feed the decayed per-chunk heat
        # that partial admission and chunk-granular eviction rank by
        self.note_chunk_access(dataset_id, chunks)
        cand = self._replica_matrix(dataset_id)[chunks]      # (batch, width)
        if np.any(cand[:, 0] < 0):
            # some requested chunk has zero replicas (unrepaired node loss);
            # batches touching only healthy chunks are served normally
            lost = np.unique(chunks[cand[:, 0] < 0])
            raise StripeError(f"{dataset_id}: chunk(s) {lost.tolist()} have no replicas")
        width = cand.shape[1]
        if width == 1:                           # single candidate: no scoring
            return cand[:, 0], np.zeros(len(cand), dtype=np.int64), 1
        safe = np.maximum(cand, 0)               # -1 pads: index safely, then
        cost = self._dist_row(reader)[safe] + self.readsched.queue_vector()[safe]
        cost[cand < 0] = np.inf                  # ...price them out entirely
        tied = cost == cost.min(axis=1, keepdims=True)
        # rotate slot preference by the (reader, chunk) hash, modulo each
        # row's LIVE replica count (pads sit at the row tail): a hash modulo
        # the padded width would favour slot 0 by 2:1 on short rows, the
        # same skew the hash exists to remove.  Among tied candidates the
        # smallest rotated rank wins.
        n_live = (cand >= 0).sum(axis=1).astype(np.uint64)
        h = (stable_mix(chunks, reader.node_id) % n_live).astype(np.int64)
        rank = (np.arange(width, dtype=np.int64)[None, :] - h[:, None]) % n_live[
            :, None
        ].astype(np.int64)
        choice = np.where(tied, rank, width).argmin(axis=1)
        return cand[np.arange(len(cand)), choice], choice, width

    def read_item(self, dataset_id: str, item: int, reader: Node) -> bytes:
        """Real-bytes read (materialized mode) with CRC verification."""
        man = self.manifests[dataset_id]
        if not man.materialized:
            raise StripeError("read_item on a non-materialized dataset")
        chunk = man.chunk_of_item(item)
        if not man.is_filled(chunk):
            if not man.chunk_nodes[chunk]:
                # non-resident (partial caching): remote read-through — serve
                # the remote store's copy without landing anything locally
                blob = self.remote_payload(man, chunk)
                off = (item - chunk * man.items_per_chunk) * man.item_bytes
                return blob[off : off + man.item_bytes]
            raise StripeError(
                f"{dataset_id} chunk {chunk} not filled yet (on-demand fill in progress)"
            )
        pending = self._pending_writes.get((dataset_id, chunk))
        if pending is not None and pending.data is not None:
            # read-your-writes: the un-fsync'd overlay is the freshest image
            # (committed content + buffered writes applied); no CRC — the
            # checksum describes committed bytes only
            off = (item - chunk * man.items_per_chunk) * man.item_bytes
            return bytes(pending.data[off : off + man.item_bytes])
        src = self.locate(dataset_id, item, reader)
        try:
            blob = self._read_chunk(man, src.node_id, chunk)
        except (ChunkCorruption, FileNotFoundError):
            # the chosen replica is corrupt or gone: fall back through the
            # verified path, which serves from a healthy copy AND rewrites
            # the bad replica in place — readers (HoardFS.pread included)
            # must never hard-fail while a healthy copy exists
            blob = self.read_chunk_verified(
                dataset_id, chunk, reader, skip_replica=src.node_id
            )
        off = (item - chunk * man.items_per_chunk) * man.item_bytes
        return blob[off : off + man.item_bytes]

    def _read_chunk(self, man: StripeManifest, node_id: int, chunk: int) -> bytes:
        path = self._chunk_path(man.dataset_id, node_id, chunk)
        with open(path, "rb") as fh:
            blob = fh.read()
        if zlib.crc32(blob) != man.chunk_crc[chunk]:
            raise ChunkCorruption(f"{man.dataset_id} chunk {chunk} on node {node_id}")
        return blob

    def read_chunk_verified(
        self,
        dataset_id: str,
        chunk: int,
        reader: Node,
        *,
        skip_replica: Optional[int] = None,
    ) -> bytes:
        """Read a chunk, repairing from a healthy replica on corruption.

        A replica that fails its CRC (or whose file vanished) is *rewritten
        in place* from the healthy copy that served the fallback — leaving
        the corrupt bytes there would make every subsequent nearby reader
        re-read and re-CRC the bad copy before falling through again.

        ``skip_replica`` marks a replica the caller already saw fail
        (``read_item``'s fallback): it is treated as failed without the
        wasted second read+CRC, and still healed from the good copy.
        """
        man = self.manifests[dataset_id]
        if not man.is_filled(chunk):
            raise StripeError(
                f"{dataset_id} chunk {chunk} not filled yet (on-demand fill in progress)"
            )
        last_err: Optional[Exception] = None
        failed: list[int] = []
        replicas = sorted(
            man.chunk_nodes[chunk],
            key=lambda nid: self.topology.distance(reader, self.topology.node(nid)),
        )
        # seed the known-bad replica BEFORE the scan: the heal loop below
        # only rewrites replicas collected before the first healthy read, so
        # a skip_replica sorting after that read would otherwise never heal
        if skip_replica in replicas and len(replicas) > 1:
            failed.append(skip_replica)
        for node_id in replicas:
            if node_id == skip_replica and len(replicas) > 1:
                continue
            try:
                blob = self._read_chunk(man, node_id, chunk)
            except (ChunkCorruption, FileNotFoundError) as err:
                last_err = err
                failed.append(node_id)
                continue
            for bad in failed:          # heal the replicas the fallback skipped
                path = self._chunk_path(dataset_id, bad, chunk)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(blob)
                self.corruption_repairs += 1
            return blob
        raise ChunkCorruption(
            f"all {man.replication} replicas of {dataset_id}:{chunk} failed: {last_err}"
        )

    # ---------------------------------------------------------- node failure
    def fail_node(self, node_id: int) -> None:
        """Drop a node's chunks (simulated node loss).

        Crash-consistency contract: every un-fsync'd overlay *owned* by the
        dead writer vanishes whole (torn writes are never partially
        visible), while committed (fsync'd) data survives on the chunk's
        other replicas or, once flushed, in the remote store.  In-flight
        fsyncs whose writer died commit nothing — ``commit_writes`` finds
        the overlays gone and no-ops.
        """
        self._replica_mat.clear()                    # placements change below
        # in-flight transfers sourced from or targeting the dead node can
        # never complete; release their reservations so capacity accounting
        # stays exact (the rebalancer re-plans from the post-failure state)
        self._abort_transfers_touching(node_id)
        self.discard_pending(writer=node_id)
        for man in self.manifests.values():
            for c, replicas in enumerate(man.chunk_nodes):
                if node_id in replicas:
                    replicas.remove(node_id)
                    self.node_usage[node_id] -= man.chunk_bytes
                    if not man.is_filled(c):
                        self._pending_fill[node_id] -= man.chunk_bytes
                    if man.is_dirty(c):
                        self._dirty[node_id] -= man.chunk_bytes
                    if man.materialized:
                        path = self._chunk_path(man.dataset_id, node_id, c)
                        if os.path.exists(path):
                            os.remove(path)

    def repair(self, dataset_id: str, target_replication: Optional[int] = None) -> int:
        """Re-replicate under-replicated chunks onto the least-loaded nodes.

        Returns the number of chunk copies created.  Beyond-paper: at 1000+
        nodes, cache-node loss must not force a remote re-fetch.
        """
        man = self.manifests[dataset_id]
        self._replica_mat.pop(dataset_id, None)      # placements change below
        want = target_replication or man.replication
        created = 0
        for c, replicas in enumerate(man.chunk_nodes):
            while 0 < len(replicas) < want:
                if self.is_migrating(dataset_id, c):
                    break                         # the rebalancer owns this chunk
                candidates = [nid for nid in man.node_ids if nid not in replicas]
                if not candidates:
                    break
                dst = min(candidates, key=lambda nid: self.node_usage[nid])
                # an unfilled chunk has no bytes yet: re-replicate metadata
                # only; the eventual put_chunk writes every replica
                if man.materialized and man.is_filled(c):
                    blob = self.read_chunk_verified(dataset_id, c, self.topology.node(dst))
                    path = self._chunk_path(dataset_id, dst, c)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    with open(path, "wb") as fh:
                        fh.write(blob)
                replicas.append(dst)
                self.node_usage[dst] += man.chunk_bytes
                if not man.is_filled(c):
                    self._pending_fill[dst] += man.chunk_bytes
                if man.is_dirty(c):
                    self._dirty[dst] += man.chunk_bytes
                created += 1
        return created

    # ------------------------------------------------------------- rebalance
    def drain(self, dataset_id: str, node_id: int) -> int:
        """Move a straggling node's chunk replicas to the least-loaded peers.

        The data-plane straggler response (DESIGN.md beyond-paper): when the
        step-loop monitor flags a cache node, its stripes migrate so peer
        reads stop waiting on it.  Returns chunks moved.
        """
        man = self.manifests[dataset_id]
        self._replica_mat.pop(dataset_id, None)      # placements change below
        moved = 0
        for c, replicas in enumerate(man.chunk_nodes):
            if node_id not in replicas or self.is_migrating(dataset_id, c):
                continue
            candidates = [n for n in man.node_ids if n not in replicas]
            if not candidates:
                continue
            dst = min(candidates, key=lambda nid: self.node_usage[nid])
            # unfilled chunks are a pure metadata retarget (no bytes on disk)
            if man.materialized and man.is_filled(c):
                blob = self._read_chunk(man, node_id, c)
                path = self._chunk_path(dataset_id, dst, c)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as fh:
                    fh.write(blob)
                old = self._chunk_path(dataset_id, node_id, c)
                if os.path.exists(old):
                    os.remove(old)
            replicas[replicas.index(node_id)] = dst
            self.node_usage[node_id] -= man.chunk_bytes
            self.node_usage[dst] += man.chunk_bytes
            if not man.is_filled(c):
                self._pending_fill[node_id] -= man.chunk_bytes
                self._pending_fill[dst] += man.chunk_bytes
            if man.is_dirty(c):
                self._dirty[node_id] -= man.chunk_bytes
                self._dirty[dst] += man.chunk_bytes
            moved += 1
        return moved

    # ----------------------------------------------------------------- delete
    def delete(self, dataset_id: str) -> None:
        # abort in-flight transfers first (while the manifest still exists,
        # so abort_transfer can release the dst reservations it charged)
        for ds, c in [k for k in self._migrating if k[0] == dataset_id]:
            self.abort_transfer(ds, c)
        # un-fsync'd overlays die with the cache copy; flushed blobs persist
        # in the modeled remote store (that is the point of flushing)
        self.discard_pending(dataset_id=dataset_id)
        man = self.manifests.pop(dataset_id, None)
        self._replica_mat.pop(dataset_id, None)
        if man is None:
            return
        touched_nodes = set()
        for c, replicas in enumerate(man.chunk_nodes):
            for node_id in replicas:
                self.node_usage[node_id] -= man.chunk_bytes
                if not man.is_filled(c):
                    self._pending_fill[node_id] -= man.chunk_bytes
                if man.is_dirty(c):
                    self._dirty[node_id] -= man.chunk_bytes
                touched_nodes.add(node_id)
                if man.materialized:
                    path = self._chunk_path(man.dataset_id, node_id, c)
                    if os.path.exists(path):
                        os.remove(path)
        if man.materialized and self.root:
            for node_id in touched_nodes:
                d = os.path.join(self.root, f"node{node_id}", dataset_id)
                shutil.rmtree(d, ignore_errors=True)
            mf = os.path.join(self.root, f"{dataset_id}.manifest.json")
            if os.path.exists(mf):
                os.remove(mf)

    def bytes_on_node(self, node_id: int) -> int:
        return self.node_usage[node_id]

    def bytes_on_nodes(self, dataset_id: str, node_ids: set) -> int:
        """Bytes this dataset holds on the given nodes (eviction dry-run)."""
        man = self.manifests.get(dataset_id)
        if man is None:
            return 0
        return sum(
            man.chunk_bytes
            for reps in man.chunk_nodes
            for nid in reps
            if nid in node_ids
        )
