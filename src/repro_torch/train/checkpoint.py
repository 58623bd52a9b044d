"""Checkpoints in the JAX package's on-disk format, written off the step loop.

Layout on disk, one directory per step, as ``repro.train.checkpoint`` writes
it, so that a checkpoint written by either package restores in the other:

    ckpt_dir/step_000420/
        manifest.json          # step, config digest, leaf shapes and dtypes,
                               # sampler state (epoch, step-in-epoch, seed)
        leaf_00000.npy ...     # one file per leaf of {"opt": ..., "params": ...}
                               # in sorted-key order (jax.tree.flatten's)
        _COMMITTED             # written last: crash-consistent marker

numpy has no bfloat16: a bf16 leaf is stored as 2-byte void records (``V2``),
the bytes the JAX manager writes for one, and ``leaf_dtypes`` names it
``bfloat16``; restore takes the type from ``leaf_dtypes``.  Leaves are
copied to the host before ``save`` returns, and the files are written on a
background thread unless ``blocking``.  ``latest_step`` only ever returns
committed checkpoints, so torn writes are invisible; ``prune`` keeps the
newest ``keep``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from dataclasses import asdict, dataclass
from typing import Optional

import numpy as np
import torch

from ..models import params as PM


@dataclass
class SamplerState:
    epoch: int = 0
    step_in_epoch: int = 0
    seed: int = 0


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (never a view: the step loop updates leaves in place
    while the copy is written) and the dtype name the manifest records."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, dtype=np.dtype(dtype))).to(device)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    # ------------------------------------------------------------------ save
    def save(
        self,
        step: int,
        params,
        opt_state,
        *,
        sampler: Optional[SamplerState] = None,
        config_digest: str = "",
        mesh_shape: Optional[dict] = None,
        blocking: bool = False,
    ) -> str:
        self.wait()                                # one in-flight write max
        tree = {"params": params, "opt": opt_state}
        host = [_to_numpy(t) for t in PM.tree_leaves(tree)]
        manifest = {
            "step": int(step),
            "n_leaves": len(host),
            "treedef": str(PM.tree_map(lambda _: "*", tree)),
            "config_digest": config_digest,
            "mesh_shape": mesh_shape or {},
            "sampler": asdict(sampler or SamplerState()),
            "leaf_shapes": [list(a.shape) for a, _ in host],
            "leaf_dtypes": [dt for _, dt in host],
        }
        path = self._step_dir(step)

        def write():
            try:
                tmp = path + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, (leaf, _) in enumerate(host):
                    np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), leaf)
                with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                    json.dump(manifest, fh)
                with open(os.path.join(tmp, "_COMMITTED"), "w") as fh:
                    fh.write("ok")
                if os.path.exists(path):
                    shutil.rmtree(path)
                os.rename(tmp, path)
                self._prune()
            except Exception as err:  # surfaced on the next wait()
                self._error = err

        if self.async_write and not blocking:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                os.path.join(self.dir, name, "_COMMITTED")
            ):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: Optional[int] = None, *, template=None):
        """Load a checkpoint into the structure of ``template``.

        ``template``: ``{"params": ..., "opt": ...}`` tree; each restored leaf
        lands on its template leaf's device, in the dtype the manifest
        records.  Returns ``(step, params, opt_state, SamplerState)``.
        """
        if template is None:
            raise ValueError("restore requires a structure template")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {self.dir}")
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as fh:
            manifest = json.load(fh)
        slots = PM.tree_leaves(template)
        if len(slots) != manifest["n_leaves"]:
            raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, the template "
                             f"{len(slots)}")
        leaves = iter([
            _from_numpy(np.load(os.path.join(path, f"leaf_{i:05d}.npy")), dtype, slot.device)
            for i, (dtype, slot) in enumerate(zip(manifest["leaf_dtypes"], slots))
        ])
        tree = PM.tree_map(lambda _: next(leaves), template)
        sampler = SamplerState(**manifest["sampler"])
        return step, tree["params"], tree["opt"], sampler

    # ----------------------------------------------------------------- misc
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:06d}")

    def _prune(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def config_digest(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]
