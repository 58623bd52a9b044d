"""The token corpus and its epoch order, worked out from the seed alone.

A frozen copy of ``repro_torch.data.tokens``: ``chunk_payload`` (chunk ``c``
holds ``items_per_chunk`` rows of ``seq_len`` int32 tokens drawn from
``numpy.random.default_rng((seed, c))``) and ``TokenLoader``'s order (epoch
``e`` visits the items as ``default_rng((seed, e)).permutation(n)`` orders
them, ``batch`` at a time, a ragged tail dropped; labels are the next tokens,
the first wrapping to the end).  The reference reads its batches from here,
and the harness holds every batch the program's loader yields against them.
"""

from __future__ import annotations

import functools

import numpy as np


def chunk_payload(seed: int, chunk: int, items_per_chunk: int, seq_len: int,
                  vocab: int) -> np.ndarray:
    """The ``(items_per_chunk, seq_len)`` int32 rows of one chunk."""
    rng = np.random.default_rng((seed, chunk))
    return rng.integers(0, vocab, (items_per_chunk, seq_len), dtype=np.int32)


class Corpus:
    """The corpus of one run: ``n_items`` rows of ``seq_len`` tokens below ``vocab``."""

    def __init__(self, seed: int, n_items: int, seq_len: int, vocab: int,
                 items_per_chunk: int):
        self.seed, self.n_items, self.seq_len = seed, n_items, seq_len
        self.vocab, self.items_per_chunk = vocab, items_per_chunk
        self._chunk = functools.lru_cache(maxsize=64)(self._make_chunk)

    def _make_chunk(self, c: int) -> np.ndarray:
        return chunk_payload(self.seed, c, self.items_per_chunk, self.seq_len, self.vocab)

    def item(self, i: int) -> np.ndarray:
        c, r = divmod(int(i), self.items_per_chunk)
        return self._chunk(c)[r]

    def order(self, epoch: int) -> np.ndarray:
        return np.random.default_rng((self.seed, epoch)).permutation(self.n_items)

    def batch_ids(self, step: int, batch: int) -> np.ndarray:
        """The item ids of the ``step``-th batch (0-based, across epochs)."""
        per_epoch = self.n_items // batch
        epoch, s = divmod(step, per_epoch)
        return self.order(epoch)[s * batch:(s + 1) * batch]

    def batch(self, step: int, batch: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(ids, tokens, labels)`` of the ``step``-th batch."""
        ids = self.batch_ids(step, batch)
        toks = np.stack([self.item(i) for i in ids])
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        return ids, toks, labels
