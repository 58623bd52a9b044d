"""Token data pipeline: Hoard-cached real-bytes datasets -> int32 batches.

Bridges :mod:`repro_torch.core` (the paper's cache) to training: a synthetic
token corpus is materialised as real chunk files striped across node
directories (:func:`materialize_token_dataset`), and :class:`TokenLoader`
reads items back through the stripe store (``StripeStore.read_item``:
CRC-verified, closest replica, a corrupt replica healed in place) into
``(tokens, labels)`` int32 batches.  The training loop sees a plain
iterator; per-epoch order is a seeded permutation with resumable state
(epoch, step), which the checkpoint managers persist for a deterministic
restart.  Both are ``repro.data.tokens``'s, so the same spec and store give
the same chunk files and the same batches in either package.

``chunk_payload`` / :func:`read_item` / :func:`read_items` compute the
corpus from the seed alone: chunk ``c`` holds ``items_per_chunk`` rows of
``seq_len`` int32 tokens drawn from ``default_rng((seed, c))``.  They are
the oracle that the store's reads are held against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from ..core import CacheManager, DatasetSpec, Node, StripeStore
from ..train.checkpoint import SamplerState


@dataclass
class TokenDatasetSpec:
    dataset_id: str
    n_sequences: int
    seq_len: int
    vocab: int
    seed: int = 0

    @property
    def item_bytes(self) -> int:
        return self.seq_len * 4              # int32 tokens


def chunk_payload(spec: TokenDatasetSpec, chunk_idx: int, items_per_chunk: int) -> np.ndarray:
    """The ``(items_per_chunk, seq_len)`` int32 rows of one chunk."""
    rng = np.random.default_rng((spec.seed, chunk_idx))
    return rng.integers(0, spec.vocab, (items_per_chunk, spec.seq_len), dtype=np.int32)


def read_item(spec: TokenDatasetSpec, item: int, *, items_per_chunk: int) -> bytes:
    """The bytes of item ``item``: one row of ``seq_len`` int32 tokens."""
    if not 0 <= item < spec.n_sequences:
        raise IndexError(f"item {item} outside {spec.dataset_id!r} of {spec.n_sequences} items")
    chunk = item // items_per_chunk
    return chunk_payload(spec, chunk, items_per_chunk)[item - chunk * items_per_chunk].tobytes()


def read_items(spec: TokenDatasetSpec, items, *, items_per_chunk: int) -> np.ndarray:
    """Items stacked as a ``(len(items), seq_len)`` int32 array."""
    return np.stack([
        np.frombuffer(read_item(spec, int(i), items_per_chunk=items_per_chunk), np.int32)
        for i in items
    ])


def materialize_token_dataset(
    store: StripeStore,
    cache: CacheManager,
    spec: TokenDatasetSpec,
    nodes: list[Node],
    *,
    items_per_chunk: int = 64,
) -> DatasetSpec:
    """Generate + stripe the corpus as real chunk files under ``store.root``.

    Registers the dataset, admits it over ``nodes`` with
    :func:`chunk_payload` as each chunk's bytes, and marks it filled; the
    cache's replication factor decides the copies.
    """
    dspec = DatasetSpec(
        spec.dataset_id, f"synthetic://{spec.dataset_id}", spec.n_sequences, spec.item_bytes
    )
    if spec.dataset_id not in cache.entries:
        cache.register(dspec)
    cache.admit(
        spec.dataset_id, nodes, materialize=True,
        payload=lambda c: chunk_payload(spec, c, items_per_chunk).tobytes(),
        items_per_chunk=items_per_chunk,
    )
    cache.mark_filled(spec.dataset_id)
    return dspec


class TokenLoader:
    """Iterates ``(tokens, labels)`` int32 batches from striped chunks; resumable.

    Each epoch visits the items in the order ``default_rng((seed, epoch))``
    permutes them, ``batch`` at a time (a ragged tail is dropped), every item
    read as ``reader`` through ``store.read_item``; labels are the next
    tokens, the first token wrapping around to the end.  ``last_ids`` holds
    the item ids of the batch last yielded.
    """

    def __init__(
        self,
        store: StripeStore,
        spec: TokenDatasetSpec,
        reader: Node,
        *,
        batch: int,
        state: Optional[SamplerState] = None,
    ):
        self.store = store
        self.spec = spec
        self.reader = reader
        self.batch = batch
        self.state = state or SamplerState(seed=spec.seed)
        self.last_ids: Optional[np.ndarray] = None

    def _order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.spec.seed, epoch))
        return rng.permutation(self.spec.n_sequences)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        while True:
            order = self._order(self.state.epoch)
            steps = len(order) // self.batch
            while self.state.step_in_epoch < steps:
                s = self.state.step_in_epoch
                ids = order[s * self.batch : (s + 1) * self.batch]
                self.last_ids = ids
                toks = np.stack([self._read_item(i) for i in ids])
                self.state.step_in_epoch += 1
                labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
                yield toks, labels
            self.state.epoch += 1
            self.state.step_in_epoch = 0

    def _read_item(self, item: int) -> np.ndarray:
        raw = self.store.read_item(self.spec.dataset_id, int(item), self.reader)
        return np.frombuffer(raw, np.int32).reshape(self.spec.seq_len).copy()
