"""HoardFS: the POSIX-façade filesystem subsystem (paper Requirement 4).

"Hoard exposes a POSIX file system interface so the existing deep learning
frameworks can take advantage of the cache without any modifications" —
this package is that interface, ported from ``repro.fs`` unchanged in
what it reads, writes and books on the simulated clock:

* :class:`MetadataService` — ``stat``/``readdir``/``lookup`` over the
  ``/hoard/<dataset>/<shard-files>`` namespace, derived live from stripe
  manifests, with a schema-versioned on-disk layout-policy format.
* :class:`HoardFS`        — the VFS: ``open``/``read``/``pread``/
  ``readdir``/``close``/``statfs`` file handles whose reads resolve
  tri-state (stripe hit / fill join / remote fall-through) through the
  shared :class:`~repro_torch.core.loader.StripeDataPlane`, taking CacheManager
  reader pins for the lifetime of every handle.  Writable handles
  (``open(path, "w")``) add ``write``/``pwrite``/``fsync``/``ftruncate``
  over the :class:`~repro_torch.core.writeplane.WritePlane` dirty-chunk
  lifecycle — the bidirectional data plane.
* :class:`Readahead`      — per-handle sequential windows feeding the
  existing :class:`~repro_torch.core.prefetch.PrefetchScheduler` from *observed
  file offsets* (the non-clairvoyant mode the paper actually runs).
* :class:`FileDataset` / :func:`posix_loader` — the adapter that lets
  ``TrainingJob`` workloads be declared as path-reading jobs with zero
  loader changes (``backend="posix"``), and whose ``read_item_bytes`` hands
  the stored bytes of a batch to a train step.

See ``docs/architecture.md`` ("HoardFS") for the VFS -> stripe-store call
path.
"""

from .dataset import FileDataset, posix_loader
from .metadata import FS_SCHEMA_VERSION, ROOT, FileAttr, MetadataService
from .readahead import Readahead
from .vfs import HoardFS, OpenFile, ReadResult, StatFS, WriteResult

__all__ = [
    "FS_SCHEMA_VERSION",
    "FileAttr",
    "FileDataset",
    "HoardFS",
    "MetadataService",
    "OpenFile",
    "ROOT",
    "ReadResult",
    "Readahead",
    "StatFS",
    "WriteResult",
    "posix_loader",
]
