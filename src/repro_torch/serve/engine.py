"""Batched serving engine: warm-cache decode over a batch of prompts.

The port of ``repro.serve.engine``, for every model the port serves: the
``DecoderLM`` (a KV cache, a ring buffer with a sliding window, or MLA's
latent cache; a VLM decodes text alone), ``EncDecLM`` (self K and V, and
a cross cache of ``enc_len or 64`` zero frames, as in JAX: nothing runs the
encoder), ``Hymba`` (KV caches, a ring buffer in the sliding-window layers,
and the SSM state) and ``XLSTM`` (the recurrent state alone).  Each model's
``init_cache`` gives its cache and ``decode_step`` updates it in place.
The engine runs: (1) cache init, (2) prefill that fills the cache token by
token through ``decode_step``, (3) a decode loop producing one token per
step for the whole batch, greedy or by temperature sampling from a
``torch.Generator`` seeded by ``ServeConfig.seed``.
The sampled tokens stay on the device until the loop ends, so the host never
waits for the device inside the loop.

A ``DecoderLM`` built over a mesh whose ``model`` axis is above 1 serves
tensor-parallel, as JAX's engine serves a sharded model: the engine takes the
global prompts, keeps this rank's rows by its coordinates on the data axes
(all of them where the batch does not divide over those axes; the cache is
then whole there too), decodes them inside ``model.rows_split`` (the experts
route the global batch) and gathers the sampled tokens over the data axes, so
every rank's :meth:`ServingEngine.generate` returns the global ``(B, new)``
tokens.  The ranks of one model group see the same logits, so greedy
decoding and the seeded generator give them the same tokens; a data rank
samples its own rows with its own generator of the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import contextlib

import numpy as np
import torch

from ..parallel import tp_size

#: the batch axes of a mesh, as ``models.params.DP`` names them
DATA_AXES = ("pod", "data")


def data_rows(mesh, batch: int) -> tuple[tuple, slice]:
    """``(axes, rows)``: the data axes of ``mesh`` that a batch of ``batch``
    rows is cut over and this rank's rows of it, or ``((), every row)`` where
    the mesh has none of size above 1 or their size does not divide the batch."""
    axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    n = mesh.axis_size(axes) if axes else 1
    if n == 1 or batch % n:
        return (), slice(0, batch)
    i = mesh.index_in(axes)
    return axes, slice(i * batch // n, (i + 1) * batch // n)


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0         # 0 = greedy
    seed: int = 0


class ServingEngine:
    def __init__(self, model, params, *, cache_len: int, batch: int, enc_len: int = 0):
        self.model = model
        self.params = params
        self.batch = batch
        self.cache_len = cache_len
        #: over a ``model`` axis: the data axes this rank's rows are cut over
        #: (empty where the batch does not divide), and its slice of the batch
        mesh = getattr(model, "mesh", None)
        self.mesh = mesh if tp_size(mesh) > 1 else None
        self.data_axes, self.rows = (), slice(0, batch)
        if self.mesh is not None:
            self.data_axes, self.rows = data_rows(self.mesh, batch)
        if model.cfg.family == "encdec":
            self.cache = model.init_cache(batch, cache_len, enc_len or 64)
        else:
            self.cache = model.init_cache(batch, cache_len)

    def _step(self, tokens: torch.Tensor, index: int) -> torch.Tensor:
        batch = {"tokens": tokens, "cache": self.cache, "index": index}
        logits, self.cache = self.model.decode_step(self.params, batch)
        return logits

    def _split(self):
        """The model's rows cut over the data axes while decoding (a no-op without)."""
        if not self.data_axes:
            return contextlib.nullcontext()
        return self.model.rows_split(self.data_axes)

    def prefill_tokens(self, prompts: np.ndarray) -> torch.Tensor:
        """Feed prompts token by token through ``decode_step`` (cache warm-up);
        the last step's logits of this rank's rows."""
        B, S = prompts.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for an engine of batch {self.batch}")
        toks = torch.as_tensor(np.asarray(prompts, np.int64)[self.rows]).to(self.model.device)
        logits = None
        with self._split():
            for t in range(S):
                logits = self._step(toks[:, t : t + 1], t)
        return logits

    def generate(self, prompts: np.ndarray, cfg: Optional[ServeConfig] = None) -> np.ndarray:
        """``(B, max_new_tokens)`` int32 tokens following each prompt (every
        prompt's, on every rank of a mesh)."""
        cfg = cfg or ServeConfig()
        gen = torch.Generator(device=self.model.device).manual_seed(cfg.seed)
        logits = self.prefill_tokens(prompts)
        pos = prompts.shape[1]
        out = []
        tok = self._sample(logits, cfg, gen)
        with self._split():
            for i in range(cfg.max_new_tokens):
                out.append(tok[:, 0])
                logits = self._step(tok, pos + i)
                tok = self._sample(logits, cfg, gen)
        tokens = torch.stack(out, dim=1).to(torch.int32)
        if self.data_axes:
            tokens = torch.cat(self.mesh.all_gather(tokens, self.data_axes), 0)
        return tokens.cpu().numpy()

    @staticmethod
    def _sample(logits, cfg: ServeConfig, gen: torch.Generator) -> torch.Tensor:
        last = logits[:, -1]
        if cfg.temperature <= 0:
            return last.argmax(dim=-1, keepdim=True)
        probs = torch.softmax(last / cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
