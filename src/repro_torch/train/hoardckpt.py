"""Checkpointing through HoardFS: the write path's first-class consumer.

:class:`~repro_torch.train.checkpoint.CheckpointManager` targets a real
POSIX directory and gets crash consistency from tmp-dir + atomic rename.
Shard files under ``/hoard/<dataset>/`` have fixed stripe-derived geometry —
no ``mkdir``, no ``rename`` — so :class:`HoardCheckpointManager` rebuilds the
same contract from the two primitives HoardFS does have, ``pwrite`` and
``fsync``:

1. serialize the state into one payload blob (``np.save`` of each leaf of
   ``{"opt": ..., "params": ...}`` in sorted-key order) and ``pwrite`` it at
   offset 0 of a slot file (``step % n_slots``: fixed slots are the
   ``keep=N`` rotation),
2. ``fsync`` — the payload bytes are now replicated and crash-durable,
3. ``pwrite`` a *trailer* at the end of the file: manifest JSON, the
   payload and JSON lengths as ``>QQ``, and the magic ``HOARDCK1``,
4. ``fsync`` — the commit point.

The format is ``repro.train.hoardckpt``'s, so an fp32 state gives the same
payload bytes in both packages.  numpy has no bfloat16: a bf16 leaf is
written as 2-byte void records (``V2``), as :mod:`.checkpoint` writes it,
and the manifest's ``leaf_dtypes`` — the port's one addition to the JAX
trailer — names each leaf's type for restore.  ``treedef`` describes the
tree as the port's ``CheckpointManager`` does.

The trailer is the ``_COMMITTED`` marker: :meth:`latest_step` only believes
slots whose trailer magic and JSON check out.  A crash before step 4 leaves
the trailer overlay un-fsync'd, which the store's crash contract makes
wholly invisible — readers see the slot's *previous* trailer (an older
committed checkpoint) or no magic at all, never a torn one.

Every byte of save and restore crosses the simulated fabric and, on a
materialised store, the chunk files on disk.  Methods are blocking: they
drive ``clock.run()`` internally, so use them standalone or between
workload runs, not from inside a live simulation process.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from dataclasses import asdict
from typing import Optional

import numpy as np

from ..models import params as PM
from .checkpoint import SamplerState, _from_numpy, _to_numpy

#: trailer magic: 8 bytes, versioned
_MAGIC = b"HOARDCK1"
#: trailer fixed part: payload_len (u64) + json_len (u64) + magic
_FIXED = struct.Struct(">QQ8s")


class HoardCheckpointManager:
    """Sharded checkpoint save/restore over one HoardFS mount.

    ``dataset_id`` names a registered, admitted, *filled* dataset whose
    shard files are the checkpoint slots.  One manager per writing node;
    restore may use a manager on any node that can read the namespace (the
    writer dies, a survivor restores from the replicas its fsyncs left).
    """

    def __init__(self, fs, dataset_id: str, *, slots: Optional[int] = None):
        self.fs = fs
        self.dataset_id = dataset_id
        self.root = f"/hoard/{dataset_id}"
        names = fs.readdir(self.root)
        if not names:
            raise FileNotFoundError(f"no shard files under {self.root}")
        if slots is not None:
            names = names[: int(slots)]
        self.slot_paths = [f"{self.root}/{n}" for n in names]

    @property
    def keep(self) -> int:
        """Checkpoints retained = slot files (fixed-slot rotation)."""
        return len(self.slot_paths)

    # ------------------------------------------------------------------ save
    def _encode(self, step, params, opt_state, *, sampler, config_digest, mesh_shape):
        tree = {"params": params, "opt": opt_state}
        host = [_to_numpy(t) for t in PM.tree_leaves(tree)]
        bio = io.BytesIO()
        for leaf, _ in host:
            np.save(bio, leaf)
        payload = bio.getvalue()
        manifest = {
            "step": int(step),
            "n_leaves": len(host),
            "treedef": str(PM.tree_map(lambda _: "*", tree)),
            "config_digest": config_digest,
            "mesh_shape": mesh_shape or {},
            "sampler": asdict(sampler or SamplerState()),
            "payload_crc": zlib.crc32(payload),
            "leaf_dtypes": [dt for _, dt in host],
        }
        blob = json.dumps(manifest, sort_keys=True).encode()
        trailer = blob + _FIXED.pack(len(payload), len(blob), _MAGIC)
        return payload, trailer, manifest

    def save(
        self,
        step: int,
        params,
        opt_state,
        *,
        sampler: Optional[SamplerState] = None,
        config_digest: str = "",
        mesh_shape: Optional[dict] = None,
        blocking: bool = True,
    ):
        """Write a checkpoint into slot ``step % keep``.

        ``blocking=True`` (default) drains the clock and returns the slot
        path.  ``blocking=False`` books the whole save as a simulation
        process and returns its completion event: it fires with the path on
        commit, or ``None`` when the writer died mid-save.
        """
        path = self.slot_paths[int(step) % len(self.slot_paths)]
        payload, trailer, _ = self._encode(
            step, params, opt_state,
            sampler=sampler, config_digest=config_digest, mesh_shape=mesh_shape,
        )
        attr = self.fs.stat(path)
        if len(payload) + len(trailer) > attr.size:
            raise ValueError(
                f"checkpoint needs {len(payload) + len(trailer)} B but slot "
                f"{path} holds {attr.size} B; use a larger checkpoint dataset"
            )
        fd = self.fs.open(path, "r+")

        def _proc():
            try:
                yield self.fs.pwrite(fd, payload, 0).event
                ev = self.fs.fsync(fd)
                yield ev
                if not ev.value:
                    return None          # writer died: payload never committed
                yield self.fs.pwrite(fd, trailer, attr.size - len(trailer)).event
                ev = self.fs.fsync(fd)
                yield ev
                return path if ev.value else None
            finally:
                self.fs.close(fd)

        done = self.fs.clock.process(_proc())
        if not blocking:
            return done
        self.fs.clock.run()
        return done.value

    # --------------------------------------------------------------- restore
    def _read(self, fd: int, size: int, offset: int) -> bytes:
        res = self.fs.pread(fd, size, offset)
        self.fs.clock.run()
        if res.data is None:
            raise RuntimeError("HoardCheckpointManager needs a materialized store")
        return res.data

    def _slot_manifest(self, path: str) -> Optional[dict]:
        """The committed manifest in ``path``, or None (no/invalid trailer)."""
        attr = self.fs.stat(path)
        if attr.size < _FIXED.size:
            return None
        fd = self.fs.open(path)
        try:
            fixed = self._read(fd, _FIXED.size, attr.size - _FIXED.size)
            payload_len, json_len, magic = _FIXED.unpack(fixed)
            if magic != _MAGIC:
                return None
            if json_len <= 0 or json_len + _FIXED.size + payload_len > attr.size:
                return None
            blob = self._read(fd, json_len, attr.size - _FIXED.size - json_len)
            try:
                manifest = json.loads(blob.decode())
            except (UnicodeDecodeError, json.JSONDecodeError):
                return None
            manifest["_payload_len"] = payload_len
            return manifest
        finally:
            self.fs.close(fd)

    def latest_step(self) -> Optional[int]:
        """Newest committed step across all slots (torn saves invisible)."""
        steps = [
            m["step"] for p in self.slot_paths
            if (m := self._slot_manifest(p)) is not None
        ]
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, *, template=None, device=None):
        """Load a committed checkpoint bit-identically through HoardFS reads.

        ``template``: a ``{"params": ..., "opt": ...}`` tree; each restored
        leaf takes the type the manifest's ``leaf_dtypes`` records and lands
        on ``device``, or on its template leaf's device when ``device`` is
        None.  Returns ``(step, params, opt_state, SamplerState)``.  The
        payload CRC recorded at save time is re-verified, so a violated
        durability contract fails loudly instead of deserializing garbage.
        """
        if template is None:
            raise ValueError("restore requires a structure template")
        want = step
        found = None
        for path in self.slot_paths:
            m = self._slot_manifest(path)
            if m is None:
                continue
            if want is not None:
                if m["step"] == want:
                    found = (path, m)
                    break
            elif found is None or m["step"] > found[1]["step"]:
                found = (path, m)
        if found is None:
            raise FileNotFoundError(
                f"no committed checkpoint{f' for step {want}' if want is not None else ''} "
                f"under {self.root}"
            )
        path, manifest = found
        fd = self.fs.open(path)
        try:
            payload = self._read(fd, manifest["_payload_len"], 0)
        finally:
            self.fs.close(fd)
        if zlib.crc32(payload) != manifest["payload_crc"]:
            raise IOError(
                f"checkpoint {path} step {manifest['step']}: payload CRC mismatch "
                f"(durability contract violated)"
            )
        slots = PM.tree_leaves(template)
        if len(slots) != manifest["n_leaves"]:
            raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, the template "
                             f"{len(slots)}")
        bio = io.BytesIO(payload)
        leaves = iter([
            _from_numpy(np.load(bio), dtype, slot.device if device is None else device)
            for dtype, slot in zip(manifest["leaf_dtypes"], slots)
        ])
        tree = PM.tree_map(lambda _: next(leaves), template)
        sampler = SamplerState(**manifest["sampler"])
        return manifest["step"], tree["params"], tree["opt"], sampler
