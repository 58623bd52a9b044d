"""FileDataset / posix_loader: path-reading training jobs, zero loader changes.

The last mile of Requirement 4: a :class:`~repro_torch.core.loader.TrainingJob`
(and so a workload of the JAX package's ``ClusterScheduler``)
can be declared over ``/hoard/...`` *paths* instead of a ``HoardBackend``.
``FileDataset`` implements the backend protocol (``startup`` /
``epoch_start`` / ``batch_io``) by translating each step's item ids into
``(shard file, byte offset)`` pairs and issuing them through
:meth:`HoardFS.pread_batch` over real open file handles — the namespace,
handle table and reader pins are all exercised for every batch.

Because ``pread_batch`` resolves the offsets back to item ids and hands the
batch to the same :class:`~repro_torch.core.loader.StripeDataPlane` the iterator
backend uses, a job trained through paths produces **bit-identical epoch
metrics** to the same job on ``HoardBackend`` (asserted by
``tests/test_fs.py`` and ``benchmarks/fsbench.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.calibration import WorkloadCalibration
from ..core.loader import HoardLoader
from ..core.simclock import Event
from .vfs import HoardFS


class FileDataset:
    """Backend adapter: a dataset directory consumed as shard files.

    ``path`` is a dataset directory (``/hoard/<dataset>``).  Shard handles
    are opened lazily on first touch and each holds a CacheManager reader
    pin until :meth:`close` — a training job reading through paths is
    exactly as eviction-safe as one reading through the iterator.
    """

    name = "HoardFS"

    def __init__(
        self,
        fs: HoardFS,
        path: str,
        *,
        fill_plane=None,
        prefetcher=None,
        mdr: Optional[float] = None,
        cal: Optional[WorkloadCalibration] = None,
    ):
        self.fs = fs
        attr = fs.stat(path)
        if not attr.is_dir or attr.dataset_id is None:
            raise NotADirectoryError(20, "not a dataset directory", path)
        self.dataset_id = attr.dataset_id
        fs.mount(
            self.dataset_id,
            fill_plane=fill_plane, prefetcher=prefetcher, mdr=mdr, cal=cal,
        )
        self.item_bytes = int(attr.item_bytes)
        self.items_per_file = fs.meta.items_per_file(self.dataset_id)
        # fd lookup table indexed by shard number; -1 = not open yet
        self._fd_table = np.full(fs.meta.n_files(self.dataset_id), -1, dtype=np.int64)
        self.last_io_class = "compute"

    # ------------------------------------------------------ backend protocol
    def startup(self) -> float:
        return 0.0

    def epoch_start(self, epoch: int) -> None:
        self.fs.cache.touch(self.dataset_id)

    def batch_io(self, item_ids: np.ndarray, epoch: int, positions: np.ndarray) -> Event:
        file_idx = item_ids // self.items_per_file
        for i in np.unique(file_idx):
            if self._fd_table[i] < 0:
                self._fd_table[i] = self.fs.open(
                    self.fs.meta.file_path(self.dataset_id, int(i))
                )
        offsets = (item_ids % self.items_per_file) * self.item_bytes
        ev = self.fs.pread_batch(
            self._fd_table[file_idx], offsets, epoch=epoch, positions=positions
        )
        self.last_io_class = self.fs.last_io_class
        return ev

    def read_item_bytes(self, item_ids: np.ndarray) -> list:
        """Materialized-store path: one :class:`ReadResult` per item.

        The compute-plane integration hook: issues a positional
        read per item through the same handle table / reader pins as
        :meth:`batch_io`, but returns the per-item results so a *real*
        training step can consume the actual payload bytes — each result's
        ``.data`` is populated once the clock has run the transfers (the
        store must be materialized; see ``StripeStore(root=...)``).
        """
        item_ids = np.asarray(item_ids)
        file_idx = item_ids // self.items_per_file
        for i in np.unique(file_idx):
            if self._fd_table[i] < 0:
                self._fd_table[i] = self.fs.open(
                    self.fs.meta.file_path(self.dataset_id, int(i))
                )
        results = []
        for item, fi in zip(item_ids, file_idx):
            offset = int(item % self.items_per_file) * self.item_bytes
            results.append(
                self.fs.pread(int(self._fd_table[fi]), self.item_bytes, offset)
            )
        return results

    # -------------------------------------------------------------- teardown
    @property
    def open_files(self) -> int:
        return int((self._fd_table >= 0).sum())

    def close(self) -> None:
        """Close every shard handle (drops the per-handle reader pins)."""
        for i in np.flatnonzero(self._fd_table >= 0):
            self.fs.close(int(self._fd_table[i]))
            self._fd_table[i] = -1


def posix_loader(
    fs: HoardFS,
    path: str,
    cal: WorkloadCalibration,
    *,
    epochs: int,
    seed: int = 0,
    batch_items: Optional[int] = None,
    fill_plane=None,
    prefetcher=None,
    mdr: Optional[float] = None,
) -> HoardLoader:
    """A :class:`HoardLoader` whose backend reads ``/hoard/...`` paths.

    Drop-in for the iterator construction — ``TrainingJob(job_id, clock,
    posix_loader(...), cal)`` needs no loader changes at all.
    """
    backend = FileDataset(
        fs, path, fill_plane=fill_plane, prefetcher=prefetcher, mdr=mdr, cal=cal
    )
    return HoardLoader(backend, cal, epochs=epochs, seed=seed, batch_items=batch_items)
