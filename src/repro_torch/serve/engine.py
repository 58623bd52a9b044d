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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


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
        if model.cfg.family == "encdec":
            self.cache = model.init_cache(batch, cache_len, enc_len or 64)
        else:
            self.cache = model.init_cache(batch, cache_len)

    def _step(self, tokens: torch.Tensor, index: int) -> torch.Tensor:
        batch = {"tokens": tokens, "cache": self.cache, "index": index}
        logits, self.cache = self.model.decode_step(self.params, batch)
        return logits

    def prefill_tokens(self, prompts: np.ndarray) -> torch.Tensor:
        """Feed prompts token by token through ``decode_step`` (cache warm-up)."""
        B, S = prompts.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for an engine of batch {self.batch}")
        toks = torch.as_tensor(np.asarray(prompts, np.int64)).to(self.model.device)
        logits = None
        for t in range(S):
            logits = self._step(toks[:, t : t + 1], t)
        return logits

    def generate(self, prompts: np.ndarray, cfg: Optional[ServeConfig] = None) -> np.ndarray:
        """``(B, max_new_tokens)`` int32 tokens following each prompt."""
        cfg = cfg or ServeConfig()
        gen = torch.Generator(device=self.model.device).manual_seed(cfg.seed)
        logits = self.prefill_tokens(prompts)
        pos = prompts.shape[1]
        out = []
        tok = self._sample(logits, cfg, gen)
        for i in range(cfg.max_new_tokens):
            out.append(tok[:, 0])
            logits = self._step(tok, pos + i)
            tok = self._sample(logits, cfg, gen)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    @staticmethod
    def _sample(logits, cfg: ServeConfig, gen: torch.Generator) -> torch.Tensor:
        last = logits[:, -1]
        if cfg.temperature <= 0:
            return last.argmax(dim=-1, keepdim=True)
        probs = torch.softmax(last / cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
