"""Write data plane: timed dirty-chunk lifecycle over the simulated fabric.

The bidirectional half of Hoard's POSIX façade.  The metadata and
byte state machine — buffered overlay -> committed replicas -> flushed to
remote — lives in :class:`~repro_torch.core.stripestore.StripeStore`; this module
books every transition as *flows* on the same Resources foreground reads
cross (per-disk read queues, node NICs, rack up-links, the remote-store NIC),
so a checkpoint burst mechanically contends with training ingest instead of
completing for free:

* ``write``      — stage bytes into the writer's NVMe buffer
  (``node.nvme`` write queue; overlay registered immediately, so readers get
  read-your-writes while the flow drains).
* ``fsync``      — replicate the overlay to every replica of each touched
  chunk (source read through the writer's per-disk *read* queue, exactly
  like fill fan-out), then commit all chunks atomically in one callback.
  Durability rule: an fsync only returns once the committed data can survive
  any single node failure — chunks with fewer than two cache replicas are
  flushed to the remote store *inside* the fsync.
* background flusher (write-back, the default) — streams committed-dirty
  chunks to the remote store with bounded in-flight chunks, crossing the
  primary replica's disk read queue + NIC + shared up-link; write-through
  instead flushes synchronously inside every fsync.

Transparent per-chunk compression à la FanStore: an optional
:class:`ChunkCodec` charges compression CPU on the writer once per fsync'd
chunk and scales every wire flow (replication + flush) by the compression
ratio.  Cache capacity stays uncompressed (chunks are stored hot); only
transfers shrink — the FanStore trade of CPU for wire bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

from .metrics import JobMetrics
from .simclock import Event, Resource, SimClock
from .telemetry import FlowTag
from .topology import Node, Topology

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .cache import CacheManager
    from .calibration import WorkloadCalibration

#: dirty chunks buffer locally and flush to remote asynchronously (default)
WRITE_BACK = "writeback"
#: every fsync pushes the committed chunks to the remote store synchronously
WRITE_THROUGH = "writethrough"
WRITE_POLICIES = (WRITE_BACK, WRITE_THROUGH)


@dataclass(frozen=True)
class ChunkCodec:
    """Compression cost model: wire-byte ratio + CPU service rates.

    ``ratio`` is wire/remote bytes per payload byte (1.0 disables the codec);
    ``compress_bw``/``decompress_bw`` are per-writer CPU service rates in
    payload bytes per second.
    """

    ratio: float = 1.0
    compress_bw: float = 600e6
    decompress_bw: float = 1800e6

    def __post_init__(self):
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"compression ratio must be in (0, 1], got {self.ratio}")

    @property
    def enabled(self) -> bool:
        return self.ratio < 1.0

    def wire_bytes(self, nbytes: float) -> float:
        return nbytes * self.ratio

    @classmethod
    def from_calibration(cls, cal: "WorkloadCalibration") -> "ChunkCodec":
        return cls(
            ratio=cal.compress_ratio,
            compress_bw=cal.compress_bw,
            decompress_bw=cal.decompress_bw,
        )


class WritePlane:
    """Timed write path for one ``(dataset, writer node)`` pair.

    Mirrors :class:`~repro_torch.core.loader.StripeDataPlane` on the read side:
    one plane per writer, sharing the store's global overlay/dirty state, so
    several nodes can checkpoint into one namespace concurrently while each
    plane books its own NVMe/NIC flows.
    """

    def __init__(
        self,
        clock: SimClock,
        topology: Topology,
        cache: "CacheManager",
        dataset_id: str,
        writer: Node,
        *,
        policy: str = WRITE_BACK,
        codec: Optional[ChunkCodec] = None,
        metrics: Optional[JobMetrics] = None,
        max_flush_inflight: int = 4,
    ):
        if policy not in WRITE_POLICIES:
            raise ValueError(f"unknown write policy {policy!r} (want {WRITE_POLICIES})")
        self.clock = clock
        self.topology = topology
        self.cache = cache
        self.store = cache.store
        self.dataset_id = dataset_id
        self.writer = writer
        self.policy = policy
        self.codec = codec or ChunkCodec()
        self.metrics = metrics
        self.max_flush_inflight = max(1, int(max_flush_inflight))
        # per-writer compression CPU: a dedicated service, not a fabric link —
        # FanStore burns client cores, not the network, to shrink transfers
        self._cpu = (
            Resource(
                f"{writer.name}.codec.{dataset_id}", self.codec.compress_bw,
                created_at=clock.now,
            )
            if self.codec.enabled
            else None
        )
        # owner string for this plane's flow tags (telemetry)
        self._tag_owner = metrics.job_id if metrics else f"write:{dataset_id}"
        self._flusher_active = False
        self._drain_waiters: list[Event] = []
        self._burst_cursor = 0
        self.fsyncs = 0
        self.flushed_chunks = 0

    # ------------------------------------------------------------------ write
    def _manifest(self):
        return self.store.manifests[self.dataset_id]

    def write(self, chunk_ranges) -> Event:
        """Stage writes into the NVMe buffer; Event fires when buffered.

        ``chunk_ranges`` is an iterable of ``(chunk, offset, data)`` where
        ``data`` is ``bytes`` (materialized) or an ``int`` byte count.  The
        overlay is registered *now* (readers immediately see the new bytes),
        while the returned event models the local NVMe buffer write — the
        POSIX ``write(2)`` completion, not durability.
        """
        total = 0.0
        for chunk, offset, data in chunk_ranges:
            nbytes = len(data) if isinstance(data, (bytes, bytearray, memoryview)) else int(data)
            self.store.write_pending(
                self.dataset_id, int(chunk), int(offset), data, self.writer.node_id
            )
            total += nbytes
        if self.metrics:
            self.metrics.count("write_bytes", total)
        return self.clock.transfer(
            [self.writer.nvme], total, FlowTag("write-buffer", self._tag_owner, self.dataset_id)
        )

    # ------------------------------------------------------------------ fsync
    def fsync(self) -> Event:
        """Replicate + atomically commit this writer's pending chunks.

        Fires with the list of committed chunk indices (empty when the
        writer failed mid-fsync and its overlays were discarded — the
        crash-consistency contract makes that fsync a loud no-op, exactly
        like an fsync returning EIO after a device loss).
        """
        chunks = self.store.pending_chunks(self.dataset_id, self.writer.node_id)
        done = self.clock.event()
        if not chunks:
            done.set([])
            return done
        man = self._manifest()
        sched = self.store.readsched
        inline_flush: set[int] = set()
        flows: list[Event] = []
        for c in chunks:
            replicas = man.chunk_nodes[c]
            wire = self.codec.wire_bytes(man.chunk_bytes)
            if self._cpu is not None:
                # compress once per chunk on the writer's CPU (payload bytes)
                flows.append(
                    self.clock.transfer(
                        [self._cpu], man.chunk_bytes,
                        FlowTag("compress", self._tag_owner, self.dataset_id, c),
                    )
                )
            for node_id in replicas:
                if node_id == self.writer.node_id:
                    # local commit: buffer -> chunk file on the same NVMe
                    flows.append(
                        self.clock.transfer(
                            [self.writer.nvme], man.chunk_bytes,
                            FlowTag("write-commit", self._tag_owner, self.dataset_id, c),
                        )
                    )
                else:
                    # peer replication: a *read* of the buffered chunk from
                    # the writer's per-disk read queue, across the network,
                    # into the peer's NVMe write queue — same shape as fill
                    # fan-out, so it contends with foreground reads
                    peer = self.topology.node(node_id)
                    flows.append(
                        self.clock.transfer(
                            [
                                sched.disk(self.writer.node_id, c),
                                *self.topology.path(self.writer, peer),
                                peer.nvme,
                            ],
                            wire,
                            FlowTag("write-replicate", self._tag_owner, self.dataset_id, c),
                        )
                    )
            if self.metrics:
                self.metrics.count("replicate_bytes", wire * max(0, len(replicas) - 1))
            # durability floor: fsync'd bytes must survive any single node
            # loss.  Under write-through every chunk flushes now; under
            # write-back a chunk with < 2 cache replicas has no surviving
            # copy after its one node dies, so it flushes inside the fsync.
            if self.policy == WRITE_THROUGH or len(replicas) < 2:
                inline_flush.add(c)
                flows.append(self._flush_flow(c, src_id=self.writer.node_id))

        def _commit(_v):
            if self.dataset_id not in self.store.manifests:
                done.set([])                     # evicted under us: nothing to commit
                return
            committed = self.store.commit_writes(
                self.dataset_id, chunks, self.writer.node_id
            )
            for c in committed:
                if c in inline_flush:
                    self.store.mark_flushed(self.dataset_id, c)
                    self.flushed_chunks += 1
            self.fsyncs += 1
            done.set(committed)
            if committed and self.policy == WRITE_BACK:
                self._ensure_flusher()

        self.clock.all_of(flows).on_fire(_commit)
        return done

    # ------------------------------------------------------------------ flush
    def _flush_flow(self, chunk: int, *, src_id: Optional[int] = None) -> Event:
        """Book one chunk's cache -> remote-store flush on the fabric.

        Source read through the serving replica's per-disk read queue, out
        its NIC, up the shared rack up-link and DC core, into the remote
        store's NIC — the reverse of ``path_from_remote``, which is exactly
        why checkpoint flushes inflate foreground epochs: they queue on the
        same disks and up-links the readers use.
        """
        man = self._manifest()
        if src_id is None:
            src_id = man.chunk_nodes[chunk][0]
        src = self.topology.node(src_id)
        wire = self.codec.wire_bytes(man.chunk_bytes)
        if self.metrics:
            self.metrics.count("flush_bytes", wire)
        return self.clock.transfer(
            [
                self.store.readsched.disk(src_id, chunk),
                src.nic_tx,
                self.topology.rack_uplink_tx[src.rack_id],
                self.topology.core,
                self.topology.remote_nic,
            ],
            wire,
            FlowTag("write-back-flush", self._tag_owner, self.dataset_id, chunk),
        )

    def _ensure_flusher(self) -> None:
        if not self._flusher_active:
            self._flusher_active = True
            self.clock.process(self._flush_proc())

    def _flush_proc(self):
        """Background write-back flusher: drain dirty chunks, bounded batch."""
        while True:
            if self.dataset_id not in self.store.manifests:
                break                            # dataset evicted: overlay state is gone
            man = self._manifest()
            dirty = [
                c for c in self.store.dirty_chunks(self.dataset_id) if man.chunk_nodes[c]
            ]
            if not dirty:
                break
            batch = dirty[: self.max_flush_inflight]
            yield self.clock.all_of([self._flush_flow(c) for c in batch])
            if self.dataset_id not in self.store.manifests:
                break
            for c in batch:
                if self.store.mark_flushed(self.dataset_id, c):
                    self.flushed_chunks += 1
        self._flusher_active = False
        waiters, self._drain_waiters = self._drain_waiters, []
        for ev in waiters:
            ev.set()

    def drain(self) -> Event:
        """Event fired when no dirty chunk of this dataset remains unflushed."""
        ev = self.clock.event()
        if (
            self.dataset_id not in self.store.manifests
            or not self.store.dirty_chunks(self.dataset_id)
        ) and not self._flusher_active:
            ev.set()
            return ev
        self._drain_waiters.append(ev)
        self._ensure_flusher()
        return ev

    # ------------------------------------------------------------------ burst
    def write_burst(self, nbytes: float, *, lane: int = 0, n_lanes: int = 1) -> Event:
        """One checkpoint burst: write ``nbytes`` chunk-by-chunk, then fsync.

        Successive bursts cycle through the dataset (steady-state checkpoint
        overwrite, ``keep=1`` semantics), so capacity stays bounded while
        every burst pays full write + replicate + flush traffic.  Fires with
        the committed chunk list.

        ``lane``/``n_lanes`` partition the chunk space when several writer
        nodes burst into one dataset concurrently: lane ``i`` of ``n`` only
        ever touches chunks ``[i*n_chunks//n, (i+1)*n_chunks//n)``, so
        concurrent bursts never trip the single-writer-per-chunk rule.
        """
        man = self._manifest()
        lo = (lane * man.n_chunks) // n_lanes
        hi = max(lo + 1, ((lane + 1) * man.n_chunks) // n_lanes)
        width = hi - lo
        n_chunks = max(1, min(width, int(-(-nbytes // man.chunk_bytes))))

        def _proc():
            ranges = []
            for k in range(n_chunks):
                c = lo + (self._burst_cursor + k) % width
                if man.is_filled(c):           # mid-fill chunks are not writable yet
                    ranges.append((c, 0, man.chunk_bytes))
            self._burst_cursor = (self._burst_cursor + n_chunks) % width
            if not ranges:
                return []
            yield self.write(ranges)
            ev = self.fsync()
            yield ev
            return ev.value

        return self.clock.process(_proc())
