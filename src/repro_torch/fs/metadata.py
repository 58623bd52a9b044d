"""MetadataService: the POSIX namespace over stripe manifests.

The paper's Requirement 4 — "Hoard exposes a POSIX file system interface so
the existing deep learning frameworks can take advantage of the cache
without any modifications" — starts with a namespace.  Every admitted
dataset appears as a directory of fixed-geometry shard files:

    /hoard/                      the mount root (readdir -> dataset dirs)
    /hoard/<dataset>/            one directory per stripe manifest
    /hoard/<dataset>/shard-000042.bin
                                 shard file i covers items
                                 [i*items_per_file, (i+1)*items_per_file)

The namespace is *derived* from ``StripeStore.manifests`` on every call, so
it can never drift from the cache: evicting a dataset removes its directory,
re-admission restores it, and a ``stat`` during an on-demand fill sees the
same manifest the fill plane is writing into.  The only state the service
owns is the file-layout *policy* (items per shard file, per dataset), and
that is exactly what the schema-versioned on-disk format persists — a
remounted HoardFS must lay out byte-identical files or every consumer's
offsets go stale.

Shard size defaults to one stripe chunk per file, which makes the
file -> chunk mapping the identity; any positive ``items_per_file`` works
because the VFS resolves byte ranges through items, not chunks.
"""

from __future__ import annotations

import json
import posixpath
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.stripestore import StripeError, StripeManifest, StripeStore

#: On-disk layout-policy schema.  Bump when the serialized format changes;
#: readers refuse blobs newer than they understand instead of guessing.
FS_SCHEMA_VERSION = 1

ROOT = "/hoard"
_SHARD_RE = re.compile(r"^shard-(\d{6})\.bin$")


def _enoent(path: str) -> FileNotFoundError:
    return FileNotFoundError(2, "no such file or directory", path)


@dataclass(frozen=True)
class FileAttr:
    """``stat`` result: enough geometry for a reader to plan byte IO."""

    path: str
    kind: str                      # "dir" | "file"
    size: int                      # bytes (directories report 0)
    dataset_id: Optional[str] = None
    file_index: int = -1           # shard index within the dataset (-1 for dirs)
    item_lo: int = 0               # first dataset item this shard covers
    n_items: int = 0               # items in this shard (files) / dataset (ds dir)
    item_bytes: int = 0
    # cluster-view generation the placement behind this attr belongs to
    # (StripeManifest.membership_epoch, schema v3); a consumer holding two
    # attrs with different epochs knows the stripes re-balanced in between
    membership_epoch: int = 0

    @property
    def is_dir(self) -> bool:
        return self.kind == "dir"


class MetadataService:
    """``stat`` / ``readdir`` / ``lookup`` over ``/hoard/<dataset>/<shards>``."""

    def __init__(self, store: StripeStore, *, items_per_file: Optional[int] = None):
        self.store = store
        # None -> chunk-sized shards (manifest.items_per_chunk at lookup time)
        self.default_items_per_file = (
            None if items_per_file is None else int(items_per_file)
        )
        self._items_per_file: dict[str, int] = {}    # per-dataset overrides

    # ------------------------------------------------------------ layout policy
    def set_items_per_file(self, dataset_id: str, items_per_file: int) -> None:
        """Pin a dataset's shard geometry (before any consumer opens paths)."""
        if items_per_file <= 0:
            raise ValueError(f"items_per_file must be positive, got {items_per_file}")
        self._items_per_file[dataset_id] = int(items_per_file)

    def items_per_file(self, dataset_id: str) -> int:
        ipf = self._items_per_file.get(dataset_id, self.default_items_per_file)
        if ipf is not None:
            return ipf
        return self._manifest(dataset_id).items_per_chunk

    def _manifest(self, dataset_id: str) -> StripeManifest:
        man = self.store.manifests.get(dataset_id)
        if man is None:
            raise _enoent(f"{ROOT}/{dataset_id}")
        return man

    def n_files(self, dataset_id: str) -> int:
        man = self._manifest(dataset_id)
        ipf = self.items_per_file(dataset_id)
        return (man.n_items + ipf - 1) // ipf

    @staticmethod
    def file_name(index: int) -> str:
        return f"shard-{index:06d}.bin"

    def file_path(self, dataset_id: str, index: int) -> str:
        return f"{ROOT}/{dataset_id}/{self.file_name(index)}"

    # ------------------------------------------------------------- POSIX surface
    @staticmethod
    def _split(path: str) -> list[str]:
        norm = posixpath.normpath("/" + path.strip())
        parts = [p for p in norm.split("/") if p]
        return parts

    def lookup(self, path: str) -> FileAttr:
        """Resolve ``path`` to attributes; raises ``FileNotFoundError``."""
        parts = self._split(path)
        if not parts or parts[0] != ROOT.lstrip("/"):
            raise _enoent(path)
        if len(parts) == 1:
            return FileAttr(path=ROOT, kind="dir", size=0)
        dataset_id = parts[1]
        man = self.store.manifests.get(dataset_id)
        if man is None:
            raise _enoent(path)
        if len(parts) == 2:
            return FileAttr(
                path=f"{ROOT}/{dataset_id}", kind="dir", size=0,
                dataset_id=dataset_id, n_items=man.n_items,
                item_bytes=man.item_bytes,
                membership_epoch=man.membership_epoch,
            )
        if len(parts) > 3:
            raise _enoent(path)
        m = _SHARD_RE.match(parts[2])
        if m is None:
            raise _enoent(path)
        index = int(m.group(1))
        ipf = self.items_per_file(dataset_id)
        item_lo = index * ipf
        if item_lo >= man.n_items:
            raise _enoent(path)
        n_items = min(ipf, man.n_items - item_lo)    # last shard may be short
        return FileAttr(
            path=self.file_path(dataset_id, index), kind="file",
            size=n_items * man.item_bytes, dataset_id=dataset_id,
            file_index=index, item_lo=item_lo, n_items=n_items,
            item_bytes=man.item_bytes,
            membership_epoch=man.membership_epoch,
        )

    # POSIX spelling: stat is lookup that follows no links (we have none)
    stat = lookup

    def readdir(self, path: str) -> list[str]:
        """Directory listing (names only, sorted), like ``os.listdir``."""
        attr = self.lookup(path)
        if not attr.is_dir:
            raise NotADirectoryError(20, "not a directory", path)
        if attr.dataset_id is None:
            return sorted(self.store.manifests)
        return [self.file_name(i) for i in range(self.n_files(attr.dataset_id))]

    # --------------------------------------------------- byte-range resolution
    @staticmethod
    def chunk_segments(
        attr: FileAttr, chunk_bytes: int, offset: int, size: int
    ) -> list[tuple[int, int, int, int]]:
        """Split a shard-file byte range into per-stripe-chunk segments.

        The write path's dual of :meth:`items_for_range`: a ``pwrite`` may
        straddle chunk boundaries (shard geometry is independent of chunk
        geometry), and each segment lands in a different chunk's overlay.
        Returns ``(chunk, chunk_offset, file_lo, seg_len)`` tuples where
        ``file_lo`` is the segment's offset within the *caller's* buffer
        coordinates (file offset space) — so ``data[file_lo - offset :
        file_lo - offset + seg_len]`` is the segment payload.
        """
        if attr.is_dir:
            raise IsADirectoryError(21, "is a directory", attr.path)
        if offset < 0:
            raise ValueError(f"negative offset {offset}")
        end = offset + max(0, size)
        segs: list[tuple[int, int, int, int]] = []
        file_base = attr.item_lo * attr.item_bytes     # dataset byte offset of file[0]
        pos = offset
        while pos < end:
            ds_off = file_base + pos
            chunk = ds_off // chunk_bytes
            chunk_off = ds_off % chunk_bytes
            seg_len = min(end - pos, chunk_bytes - chunk_off)
            segs.append((int(chunk), int(chunk_off), int(pos), int(seg_len)))
            pos += seg_len
        return segs

    @staticmethod
    def items_for_range(attr: FileAttr, offset: int, size: int) -> np.ndarray:
        """Dataset item ids a byte range ``[offset, offset+size)`` touches."""
        if attr.is_dir:
            raise IsADirectoryError(21, "is a directory", attr.path)
        if offset < 0:
            raise ValueError(f"negative offset {offset}")
        end = min(offset + max(0, size), attr.size)
        if offset >= end:
            return np.empty(0, dtype=np.int64)
        first = attr.item_lo + offset // attr.item_bytes
        last = attr.item_lo + (end - 1) // attr.item_bytes
        return np.arange(first, last + 1, dtype=np.int64)

    # ----------------------------------------------------------- on-disk format
    def to_json(self) -> str:
        """Serialize the layout policy (NOT the namespace, which is derived)."""
        return json.dumps(
            {
                "schema_version": FS_SCHEMA_VERSION,
                "default_items_per_file": self.default_items_per_file,
                "items_per_file": dict(self._items_per_file),
            }
        )

    @classmethod
    def from_json(cls, store: StripeStore, blob: str) -> "MetadataService":
        d = json.loads(blob)
        version = d.get("schema_version", 1)
        if version > FS_SCHEMA_VERSION:
            raise StripeError(
                f"HoardFS metadata schema v{version} is newer than this reader "
                f"(v{FS_SCHEMA_VERSION}); refusing to guess"
            )
        svc = cls(store, items_per_file=d.get("default_items_per_file"))
        for ds, ipf in d.get("items_per_file", {}).items():
            svc.set_items_per_file(ds, int(ipf))
        return svc
