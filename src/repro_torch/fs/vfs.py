"""HoardFS: POSIX-façade file handles over the stripe store.

This is the paper's Requirement 4 made literal: an unmodified, path-reading
consumer ``open``s ``/hoard/<dataset>/shard-XXXXXX.bin``, ``read``s bytes and
``close``s — and underneath, every byte resolves through exactly the same
machinery as the iterator backends:

* byte range -> item ids via :class:`~repro_torch.fs.metadata.MetadataService`,
* item ids -> tri-state classification (stripe hit / fill join / remote
  fall-through) via the shared
  :class:`~repro_torch.core.loader.StripeDataPlane`, which books local-NVMe, peer
  and remote flows on the simulated fabric *byte-identically* to
  ``HoardBackend.batch_io``,
* cold chunks fall through to the remote store via the dataset's
  :class:`~repro_torch.core.prefetch.FillTracker` (join-in-flight dedup included),
* sequential handles drive the non-clairvoyant
  :class:`~repro_torch.fs.readahead.Readahead` window.

Open handles take :meth:`CacheManager.acquire` reader pins for their whole
lifetime, so LRU churn can never evict a dataset somebody has a file open
in — the VFS equivalent of the workload engine's per-job pins.

In materialized mode (``StripeStore(root=...)``) reads deliver the real
bytes: ``ReadResult.data`` is populated when the simulated transfer lands.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from ..core.cache import CacheManager, CacheState, DatasetStat
from ..core.calibration import PAPER, WorkloadCalibration
from ..core.loader import StripeDataPlane
from ..core.metrics import JobMetrics
from ..core.prefetch import FillTracker
from ..core.simclock import Event, SimClock
from ..core.tiers import PagePool, buffer_cache_items
from ..core.topology import Node, Topology
from ..core.writeplane import WRITE_BACK, ChunkCodec, WritePlane
from .metadata import ROOT, FileAttr, MetadataService
from .readahead import Readahead


@dataclass
class ReadResult:
    """Outcome of one ``read``/``pread``.

    ``event`` fires when the bytes have crossed the simulated fabric (the
    POSIX call "returns").  ``nbytes`` is the EOF-clamped byte count.  In
    materialized mode ``data`` is filled in when the event fires — never
    before, because an unfilled chunk's bytes do not exist yet.
    """

    event: Event
    nbytes: int
    data: Optional[bytes] = None


@dataclass
class WriteResult:
    """Outcome of one ``write``/``pwrite``/``ftruncate``.

    ``event`` fires when the bytes are buffered on the writer's NVMe (the
    POSIX call "returns") — durability needs a subsequent :meth:`HoardFS.fsync`.
    """

    event: Event
    nbytes: int


@dataclass
class StatFS:
    """Filesystem-wide view returned by :meth:`HoardFS.statfs` (typed).

    Capacity figures aggregate over the live membership view; ``datasets``
    is :meth:`CacheManager.ls` verbatim (a list of
    :class:`~repro_torch.core.cache.DatasetStat`).  :meth:`as_dict` reproduces
    the pre-typed dict shape key-for-key — nested dataset rows included —
    for JSON dumps and older tooling.
    """

    capacity_bytes: float
    used_bytes: float
    # un-fsync'd buffers sit OUTSIDE used_bytes (the committed copy is what
    # node_usage charges), so free_bytes subtracts them — otherwise admission
    # oversubscribes a node whose NVMe holds unflushed writes
    free_bytes: float
    dirty_bytes: float               # unflushed write-back debt (inside used)
    write_buffer_bytes: float
    # live read-serving backlog across member nodes (contention-aware read
    # scheduler): bytes queued on the read disks and NIC-tx
    read_queue_bytes: float
    open_handles: int
    membership_epoch: int
    members: list[int]
    migrating_chunks: int            # elastic rebalancer's in-flight chunks
    # partial caching: datasets resident as a chunk subset — the
    # per-dataset rows carry the honest resident_fraction / chunk_heat_mean
    partial_datasets: int
    datasets: list[DatasetStat]
    # live telemetry snapshot when a hub is attached, else None
    telemetry: Optional[dict]

    def as_dict(self) -> dict:
        """Back-compat mapping, key-identical to the pre-typed ``statfs()``."""
        return {
            "capacity_bytes": self.capacity_bytes,
            "used_bytes": self.used_bytes,
            "free_bytes": self.free_bytes,
            "dirty_bytes": self.dirty_bytes,
            "write_buffer_bytes": self.write_buffer_bytes,
            "read_queue_bytes": self.read_queue_bytes,
            "open_handles": self.open_handles,
            "membership_epoch": self.membership_epoch,
            "members": list(self.members),
            "migrating_chunks": self.migrating_chunks,
            "partial_datasets": self.partial_datasets,
            "datasets": [d.as_dict() for d in self.datasets],
            "telemetry": self.telemetry,
        }


@dataclass
class OpenFile:
    fd: int
    attr: FileAttr
    plane: StripeDataPlane
    readahead: Readahead
    pos: int = 0
    writable: bool = False


@dataclass
class _RAStats:
    hits: int = 0            # reads fully served from resident chunks
    blocked: int = 0         # reads that waited on at least one fill
    seeks: int = 0
    sequential_reads: int = 0
    windows_started: int = 0

    def fold(self, ra: Readahead) -> None:
        self.seeks += ra.seeks
        self.sequential_reads += ra.sequential_reads
        self.windows_started += ra.windows_started


class HoardFS:
    """One node's mount of the Hoard namespace (think: a FUSE mount).

    Reads issued through this instance originate at ``node`` — locality,
    peer-stripe traffic and NIC contention are all computed from that
    vantage point, exactly as for an iterator job placed on the node.
    """

    def __init__(
        self,
        clock: SimClock,
        topology: Topology,
        cache: CacheManager,
        meta: MetadataService,
        node: Node,
        *,
        cal: WorkloadCalibration = PAPER,
        mdr: Optional[float] = None,
        metrics: Optional[JobMetrics] = None,
        readahead_window: Optional[int] = 8,
        readahead_inflight: int = 4,
        readahead_min_streak: int = 2,
        write_policy: str = WRITE_BACK,
        write_codec: Optional[ChunkCodec] = None,
    ):
        self.clock = clock
        self.topology = topology
        self.cache = cache
        self.meta = meta
        self.node = node
        self.cal = cal
        self.mdr = cal.default_mdr if mdr is None else mdr
        self.metrics = metrics if metrics is not None else JobMetrics(f"hoardfs:{node.name}")
        self.readahead_window = readahead_window
        self.readahead_inflight = readahead_inflight
        self.readahead_min_streak = readahead_min_streak
        self.write_policy = write_policy
        self.write_codec = write_codec
        self._handles: dict[int, OpenFile] = {}
        self._next_fd = 3                     # 0/1/2 taken, as tradition demands
        # data plane per dataset, keyed by admission generation so a plane
        # never outlives an evict/re-admit cycle of its dataset
        self._planes: dict[str, tuple[int, StripeDataPlane]] = {}
        # write plane per dataset, admission-keyed like the read planes
        self._wplanes: dict[str, tuple[int, WritePlane]] = {}
        self._ra = _RAStats()
        # stall class of the most recent pread/pread_batch (telemetry plane):
        # consumers (FileDataset, TrainingJob) snapshot it right after issuing
        self.last_io_class = "compute"

    # ------------------------------------------------------------- data plane
    def mount(
        self,
        dataset_id: str,
        *,
        fill_plane: Optional[FillTracker] = None,
        prefetcher=None,
        mdr: Optional[float] = None,
        cal: Optional[WorkloadCalibration] = None,
    ) -> str:
        """Wire (or rewire) a dataset's data plane; returns its directory path.

        Explicit mounting is optional — ``open`` auto-mounts with defaults —
        but it is how a caller shares a fill plane / clairvoyant prefetcher
        with other consumers (the workload engine does this), or overrides
        the pagepool MDR and calibration per dataset.
        """
        entry = self._entry(dataset_id)
        plane = self._build_plane(
            dataset_id, fill_plane=fill_plane, prefetcher=prefetcher,
            mdr=mdr, cal=cal,
        )
        self._planes[dataset_id] = (entry.admissions, plane)
        return f"{ROOT}/{dataset_id}"

    def _entry(self, dataset_id: str):
        if dataset_id not in self.cache.entries:
            raise FileNotFoundError(
                2, "dataset striped but not registered with the CacheManager",
                f"{ROOT}/{dataset_id}",
            )
        return self.cache.entries[dataset_id]

    def _build_plane(
        self, dataset_id, *, fill_plane=None, prefetcher=None, mdr=None, cal=None
    ) -> StripeDataPlane:
        entry = self._entry(dataset_id)
        spec = entry.spec
        if cal is None:
            cal = self.cal
            if (
                cal.dataset_items != spec.n_items
                or cal.dataset_bytes != float(spec.total_bytes)
            ):
                cal = replace(
                    cal,
                    dataset_bytes=float(spec.total_bytes),
                    dataset_items=spec.n_items,
                )
        if fill_plane is None and entry.state is CacheState.FILLING:
            plane = entry.fill_plane
            if plane is not None and not plane.cancelled:
                fill_plane = plane
            else:
                fill_plane = FillTracker(
                    self.clock, self.topology, self.cache, dataset_id,
                    metrics=self.metrics,
                )
        n = spec.n_items
        mdr = self.mdr if mdr is None else mdr
        return StripeDataPlane(
            self.clock, self.topology, self.node, cal,
            cache=self.cache, dataset_id=dataset_id,
            pagepool=PagePool(n, buffer_cache_items(mdr, n)),
            metrics=self.metrics, fill_plane=fill_plane, prefetcher=prefetcher,
        )

    def _plane(self, dataset_id: str) -> StripeDataPlane:
        entry = self._entry(dataset_id)
        got = self._planes.get(dataset_id)
        if got is not None and got[0] == entry.admissions:
            return got[1]
        plane = self._build_plane(dataset_id)
        self._planes[dataset_id] = (entry.admissions, plane)
        return plane

    def _write_plane(self, dataset_id: str) -> WritePlane:
        entry = self._entry(dataset_id)
        got = self._wplanes.get(dataset_id)
        if got is not None and got[0] == entry.admissions:
            return got[1]
        plane = WritePlane(
            self.clock, self.topology, self.cache, dataset_id, self.node,
            policy=self.write_policy, codec=self.write_codec, metrics=self.metrics,
        )
        self._wplanes[dataset_id] = (entry.admissions, plane)
        return plane

    # ---------------------------------------------------------- POSIX surface
    def stat(self, path: str) -> FileAttr:
        return self.meta.stat(path)

    def readdir(self, path: str) -> list[str]:
        return self.meta.readdir(path)

    def open(self, path: str, flags: str = "r") -> int:
        """Open a shard file; takes a reader pin for the handle's lifetime.

        ``flags``: ``"r"`` (default) read-only, ``"w"``/``"rw"``/``"r+"``
        writable.  Shard geometry is fixed by the stripe manifest, so a
        writable open never creates or extends a file — it overwrites in
        place, the checkpoint/ingest pattern the write path exists for.
        """
        if flags not in ("r", "w", "rw", "r+"):
            raise ValueError(f"bad flags {flags!r} (want r, w, rw or r+)")
        attr = self.meta.lookup(path)
        if attr.is_dir:
            raise IsADirectoryError(21, "is a directory", path)
        plane = self._plane(attr.dataset_id)
        self.cache.acquire(attr.dataset_id)   # pin: LRU churn can't evict us
        fd = self._next_fd
        self._next_fd += 1
        self._handles[fd] = OpenFile(
            fd=fd, attr=attr, plane=plane,
            readahead=Readahead(
                plane.fill_plane, attr,
                min_streak=self.readahead_min_streak,
                window_chunks=self.readahead_window,
                max_inflight=self.readahead_inflight,
            ),
            writable=flags != "r",
        )
        return fd

    def close(self, fd: int) -> None:
        h = self._handle(fd)
        h.readahead.stop()
        self._ra.fold(h.readahead)
        self.cache.release(h.attr.dataset_id)
        del self._handles[fd]

    def _handle(self, fd: int) -> OpenFile:
        if fd not in self._handles:
            raise OSError(9, "bad file descriptor", str(fd))
        return self._handles[fd]

    def lseek(self, fd: int, offset: int, whence: int = 0) -> int:
        h = self._handle(fd)
        base = {0: 0, 1: h.pos, 2: h.attr.size}.get(whence)
        if base is None:
            raise ValueError(f"bad whence {whence}")
        new = base + offset
        if new < 0:
            raise OSError(22, "invalid seek", h.attr.path)
        h.pos = new
        return new

    def read(self, fd: int, size: int) -> ReadResult:
        """Sequential read at the handle offset (advances it)."""
        h = self._handle(fd)
        res = self.pread(fd, size, h.pos)
        h.pos += res.nbytes
        return res

    def pread(self, fd: int, size: int, offset: int) -> ReadResult:
        """Positional read; the handle offset is not moved (POSIX pread)."""
        h = self._handle(fd)
        attr = h.attr
        nbytes = min(max(0, size), max(0, attr.size - offset))
        items = self.meta.items_for_range(attr, offset, nbytes)
        if len(items) == 0:
            done = self.clock.event()
            done.set()
            return ReadResult(event=done, nbytes=0, data=b"" if self._materialized(attr) else None)
        # hit/blocked accounting BEFORE readahead may react to this read
        if bool(h.plane.filled_mask(items).all()):
            self._ra.hits += 1
        else:
            self._ra.blocked += 1
        h.readahead.observe(offset, nbytes, int(items[0]))
        self.cache.touch(attr.dataset_id)
        ev = h.plane.ondemand_io(items, 0, None)   # positions=None: no pagepool
        self.last_io_class = h.plane.last_io_class
        res = ReadResult(event=ev, nbytes=nbytes)
        if self._materialized(attr):
            # the payload exists only once the fills land; bind it at fire time
            ev.on_fire(
                lambda _v, r=res: setattr(r, "data", self._read_bytes(attr, offset, r.nbytes))
            )
        return res

    def pread_batch(
        self,
        fds: Sequence[int],
        offsets: np.ndarray,
        *,
        epoch: int = 0,
        positions: Optional[np.ndarray] = None,
    ) -> Event:
        """Vectored positional read of one item per ``(fd, offset)`` pair.

        The framework-adapter fast path (:class:`repro_torch.fs.dataset.FileDataset`):
        a DL input pipeline reads one sample per record, so the batch maps
        1:1 onto item ids and the whole step books flows in one
        ``StripeDataPlane.ondemand_io`` call — byte-identical to
        ``HoardBackend.batch_io`` on the same ``(item_ids, epoch,
        positions)``.  Per-handle readahead is not engaged here; batch
        consumers bring their own fill planner (clairvoyant or none).
        """
        fds = np.asarray(fds, dtype=np.int64)
        offsets = np.asarray(offsets, dtype=np.int64)
        if len(fds) != len(offsets):
            raise ValueError("fds and offsets length mismatch")
        if len(fds) == 0:
            done = self.clock.event()
            done.set()
            return done
        item_ids = np.empty(len(fds), dtype=np.int64)
        dataset_id = None
        plane = None
        for fd in np.unique(fds):
            h = self._handle(int(fd))
            if dataset_id is None:
                dataset_id, plane = h.attr.dataset_id, h.plane
            elif h.attr.dataset_id != dataset_id:
                raise ValueError("pread_batch spans datasets; split the batch")
            mask = fds == fd
            item_ids[mask] = h.attr.item_lo + offsets[mask] // h.attr.item_bytes
        self.cache.touch(dataset_id)
        ev = plane.ondemand_io(item_ids, epoch, positions)
        self.last_io_class = plane.last_io_class
        return ev

    # ------------------------------------------------------------ write surface
    def _writable_handle(self, fd: int) -> OpenFile:
        h = self._handle(fd)
        if not h.writable:
            raise OSError(9, "file descriptor opened read-only", h.attr.path)
        return h

    def write(self, fd: int, data) -> WriteResult:
        """Sequential write at the handle offset (advances it)."""
        h = self._writable_handle(fd)
        res = self.pwrite(fd, data, h.pos)
        h.pos += res.nbytes
        return res

    def pwrite(self, fd: int, data, offset: int) -> WriteResult:
        """Positional write; handle offset unmoved (POSIX pwrite).

        ``data`` is ``bytes`` (materialized stores get real read-your-writes
        content) or an ``int`` byte count (accounting-only simulations).
        Writes past EOF raise ``EFBIG`` — shard geometry is fixed by the
        stripe manifest, the façade's documented divergence from growable
        POSIX files.  The result's event fires when the bytes are buffered
        on this mount's node; durability needs :meth:`fsync`.
        """
        h = self._writable_handle(fd)
        attr = h.attr
        nbytes = len(data) if isinstance(data, (bytes, bytearray, memoryview)) else int(data)
        if nbytes < 0:
            raise ValueError(f"negative write size {nbytes}")
        if offset < 0:
            raise OSError(22, "invalid write offset", attr.path)
        if offset + nbytes > attr.size:
            raise OSError(
                27, "write past EOF: shard size is fixed by stripe geometry", attr.path
            )
        if nbytes == 0:
            done = self.clock.event()
            done.set()
            return WriteResult(event=done, nbytes=0)
        man = self.cache.store.manifests[attr.dataset_id]
        wplane = self._write_plane(attr.dataset_id)
        ranges = []
        for chunk, chunk_off, file_lo, seg_len in self.meta.chunk_segments(
            attr, man.chunk_bytes, offset, nbytes
        ):
            if isinstance(data, (bytes, bytearray, memoryview)):
                seg = bytes(data[file_lo - offset : file_lo - offset + seg_len])
            else:
                seg = seg_len
            ranges.append((chunk, chunk_off, seg))
        self.cache.touch(attr.dataset_id)
        return WriteResult(event=wplane.write(ranges), nbytes=nbytes)

    def fsync(self, fd: int) -> Event:
        """Commit this node's buffered writes to the dataset durably.

        Fires with the committed chunk list once every touched chunk is
        replicated (and, under write-through or replication < 2, flushed to
        the remote store).  Commit is atomic across all chunks of the fsync
        — a crash mid-fsync leaves either all of them or none of them
        committed, mirroring ``CheckpointManager``'s atomic-rename contract.
        """
        h = self._writable_handle(fd)
        return self._write_plane(h.attr.dataset_id).fsync()

    # fdatasync carries no extra metadata in this façade; same barrier
    fdatasync = fsync

    def ftruncate(self, fd: int, length: int) -> WriteResult:
        """Truncate-to-length as overwrite: zero-fill ``[length, size)``.

        Shard geometry is fixed, so ``ftruncate`` cannot shrink or grow the
        file's stat size; it implements POSIX's *visible* contract — bytes
        past ``length`` read back as zeros — as a buffered zero write
        (fsync to make it durable).  ``length > size`` raises ``EFBIG``.
        """
        h = self._writable_handle(fd)
        if length < 0:
            raise OSError(22, "negative length", h.attr.path)
        if length > h.attr.size:
            raise OSError(
                27, "cannot extend: shard size is fixed by stripe geometry", h.attr.path
            )
        tail = h.attr.size - length
        if tail == 0:
            done = self.clock.event()
            done.set()
            return WriteResult(event=done, nbytes=0)
        man = self.cache.store.manifests[h.attr.dataset_id]
        data = b"\x00" * tail if man.materialized else tail
        return self.pwrite(fd, data, length)

    # ------------------------------------------------------------- statistics
    def statfs(self) -> "StatFS":
        """Filesystem-wide view: capacity + per-dataset cache state.

        Capacity figures aggregate over the *live membership view* — with an
        elastic rebalancer attached, only member nodes can hold stripes, so
        a node mid-removal stops being counted the instant the epoch bumps
        (its data is still draining, which ``used_bytes`` reflects).  Without
        a rebalancer every node is a member, the pre-elastic behaviour.  A
        specific admission is still bounded by the free bytes of its target
        subset, so ``free_bytes > 0`` does not promise the next ``admit``
        fits — check per-dataset ``nodes`` for locality.  The dataset table
        is :meth:`CacheManager.ls` verbatim — reader pins, live
        ``fill_progress`` and per-dataset ``migrating_chunks``/
        ``membership_epoch`` included, so ``statfs`` during a fill or a
        rebalance shows the cache converging.
        """
        rb = getattr(self.cache, "rebalancer", None)
        if rb is not None:
            nodes = [n for n in self.topology.nodes if n.node_id in rb.members]
        else:
            nodes = self.topology.nodes
        capacity = self.cache.capacity_per_node * len(nodes)
        used = float(sum(self.cache.store.bytes_on_node(n.node_id) for n in nodes))
        # write-path occupancy (a write-path fix): un-fsync'd buffers
        # sit OUTSIDE used_bytes (the committed copy is what node_usage
        # charges), so free_bytes must subtract them or admission oversubscribes
        # a node whose NVMe holds unflushed writes; dirty bytes are inside
        # used_bytes but reported so operators can see unflushed write-back debt
        write_buffer = float(
            sum(self.cache.store.write_buffer_bytes(n.node_id) for n in nodes)
        )
        dirty = float(sum(self.cache.store.dirty_bytes(n.node_id) for n in nodes))
        return StatFS(
            capacity_bytes=capacity,
            used_bytes=used,
            free_bytes=capacity - used - write_buffer,
            dirty_bytes=dirty,
            write_buffer_bytes=write_buffer,
            read_queue_bytes=float(
                sum(self.cache.store.read_load_bytes(n.node_id) for n in nodes)
            ),
            open_handles=len(self._handles),
            membership_epoch=rb.epoch.value if rb is not None else 0,
            members=sorted(rb.members) if rb is not None else [n.node_id for n in nodes],
            migrating_chunks=sum(
                self.cache.store.migrating_chunks(ds) for ds in self.cache.store.manifests
            ),
            partial_datasets=sum(
                1
                for ds in self.cache.store.manifests
                if self.cache.store.resident_fraction(ds) < 1.0
            ),
            datasets=self.cache.ls(),
            telemetry=(
                self.clock.telemetry.snapshot() if self.clock.telemetry is not None else None
            ),
        )

    def readahead_stats(self) -> dict:
        """Aggregate readahead effectiveness across closed + live handles."""
        agg = _RAStats(
            hits=self._ra.hits, blocked=self._ra.blocked, seeks=self._ra.seeks,
            sequential_reads=self._ra.sequential_reads,
            windows_started=self._ra.windows_started,
        )
        for h in self._handles.values():
            agg.fold(h.readahead)
        reads = agg.hits + agg.blocked
        return {
            "reads": reads,
            "hits": agg.hits,
            "blocked": agg.blocked,
            "hit_rate": agg.hits / reads if reads else 1.0,
            "seeks": agg.seeks,
            "sequential_reads": agg.sequential_reads,
            "windows_started": agg.windows_started,
        }

    # ------------------------------------------------------------- real bytes
    def _materialized(self, attr: FileAttr) -> bool:
        man = self.cache.store.manifests.get(attr.dataset_id)
        return bool(man is not None and man.materialized)

    def _read_bytes(self, attr: FileAttr, offset: int, nbytes: int) -> bytes:
        """Materialized payload for a byte range (post-fill; CRC-verified)."""
        store = self.cache.store
        ib = attr.item_bytes
        out = bytearray()
        start = offset
        end = offset + nbytes
        for item in MetadataService.items_for_range(attr, offset, nbytes):
            blob = store.read_item(attr.dataset_id, int(item), self.node)
            item_start = (int(item) - attr.item_lo) * ib   # file-relative
            lo = max(0, start - item_start)
            hi = min(ib, end - item_start)
            out += blob[lo:hi]
        return bytes(out)
