"""Synthetic token corpus, as the JAX package's Hoard-striped datasets hold it,
and the resumable training loader over it.

``chunk_payload`` is the payload ``repro.data.tokens.materialize_token_dataset``
stripes into the cache, copied exactly: chunk ``c`` holds ``items_per_chunk``
rows of ``seq_len`` int32 tokens drawn from ``default_rng((seed, c))``.  So
:func:`read_item` returns, byte for byte, what the stripe store's
``read_item`` returns for a corpus materialised with the same spec and
``items_per_chunk``.  :class:`TokenLoader` is ``repro.data.tokens.TokenLoader``
reading through :func:`read_item`: the same seeded epoch order, the same
labels, so its batches are byte for byte the JAX loader's.  The stripe
store, the cache and HoardFS themselves are host-side code that a later
slice of the port brings over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

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


class TokenLoader:
    """Iterates ``(tokens, labels)`` int32 batches; resumable from a :class:`SamplerState`.

    Each epoch visits the items in the order ``default_rng((seed, epoch))``
    permutes them, ``batch`` at a time (a ragged tail is dropped); labels
    are the next tokens, the first token wrapping around to the end.
    """

    def __init__(self, spec: TokenDatasetSpec, *, batch: int, items_per_chunk: int,
                 state: Optional[SamplerState] = None):
        self.spec = spec
        self.batch = batch
        self.items_per_chunk = items_per_chunk
        self.state = state or SamplerState(seed=spec.seed)

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
                toks = read_items(self.spec, ids, items_per_chunk=self.items_per_chunk)
                self.state.step_in_epoch += 1
                labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
                yield toks, labels
            self.state.epoch += 1
            self.state.step_in_epoch = 0
