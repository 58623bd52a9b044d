"""Model configuration schema (the port's copy of ``repro.configs.base``).

The fields and their defaults are those of the JAX package, so that a config
built here describes the same model, including ``rope_theta=10000`` and
``norm_eps=1e-5``, on which parity depends, and ``repr`` (hence
``config_digest``) is the JAX config's.  Of the family-specific blocks,
``ssm`` (:class:`SSMConfig`, xLSTM) is ported; ``moe``, ``mla``, ``encdec``,
``vlm`` and ``hybrid`` are kept as fields and stay ``None`` until the slices
that port those families define them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional


@dataclass(frozen=True)
class SSMConfig:
    """Matrix-memory recurrences: xLSTM mLSTM/sLSTM and Mamba-style heads."""

    state_dim: int = 16                # hymba per-head SSM state
    conv_width: int = 4
    expand: int = 2                    # up-projection factor (mLSTM / mamba)
    slstm_every: int = 8               # xLSTM: one sLSTM block per this many
    chunk: int = 128                   # chunked-scan length


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                        # dense | moe | encdec | ssm | vlm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qk_norm: bool = False              # qwen3
    qkv_bias: bool = False             # qwen1.5
    sliding_window: int = 0            # 0 = full attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[Any] = None
    vlm: Optional[Any] = None
    hybrid: Optional[Any] = None
    # runtime knobs (overridable per run, not architecture identity)
    dtype: str = "bfloat16"
    q_block: int = 512
    kv_block: int = 512
    use_pallas: bool = False
    remat: str = "dots"
    causal_pairs: bool = False
    mask_mode: str = "where"
    moe_token_shard: bool = False
    ssm_factored: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config for CPU tests (dense and xLSTM families)."""
        blocks = ("moe", "mla", "encdec", "vlm", "hybrid")
        if any(getattr(self, f) is not None for f in blocks):
            raise NotImplementedError(f"{self.arch}: family {self.family!r} is not ported yet")
        cfg = replace(
            self,
            n_layers=min(self.n_layers, 2 if self.family != "ssm" else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            head_dim=32,
            vocab=512,
            q_block=64,
            kv_block=64,
            dtype="float32",
        )
        if cfg.ssm:
            cfg = replace(cfg, ssm=replace(cfg.ssm, chunk=32, slstm_every=4))
        if self.sliding_window:
            cfg = replace(cfg, sliding_window=64)
        return cfg
