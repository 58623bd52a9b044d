"""Model configuration schema (the port's copy of ``repro.configs.base``).

The fields and their defaults are those of the JAX package, so that a config
built here describes the same model, including ``rope_theta=10000`` and
``norm_eps=1e-5``, on which parity depends, and ``repr`` (hence
``config_digest``) is the JAX config's.  Every family-specific block is
ported: ``moe`` (:class:`MoEConfig`, mixtral-8x7b and deepseek-v2-lite-16b),
``mla`` (:class:`MLAConfig`, deepseek-v2-lite-16b), ``ssm``
(:class:`SSMConfig`, xLSTM and Hymba's SSM heads), ``encdec``
(:class:`EncDecConfig`, whisper-large-v3), ``vlm`` (:class:`VLMConfig`,
internvl2-2b) and ``hybrid`` (:class:`HybridConfig`, Hymba).  The four
shape cells of the dry-run and the roofline table (:class:`ShapeConfig`,
``ALL_SHAPES``) and ``shape_applicable`` are JAX's, field for field.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_dense: bool = False          # DeepSeek: layer 0 keeps a dense FFN
    first_dense_ff: int = 0
    capacity_factor: float = 1.25      # dispatch capacity per expert
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Matrix-memory recurrences: xLSTM mLSTM/sLSTM and Mamba-style heads."""

    state_dim: int = 16                # hymba per-head SSM state
    conv_width: int = 4
    expand: int = 2                    # up-projection factor (mLSTM / mamba)
    slstm_every: int = 8               # xLSTM: one sLSTM block per this many
    chunk: int = 128                   # chunked-scan length


@dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 32
    cross_attention: bool = True
    # the conv/patch frontend is a stub: inputs arrive as frame embeddings


@dataclass(frozen=True)
class VLMConfig:
    n_image_tokens: int = 256          # patch embeddings prepended to text


@dataclass(frozen=True)
class HybridConfig:
    """Hymba: parallel attention + SSM heads in every block."""

    n_ssm_heads: int = 8
    global_layers: tuple[int, ...] = (0, 15, 31)   # full attention; rest SWA
    meta_tokens: int = 128
    sliding_window: int = 1024


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
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    hybrid: Optional[HybridConfig] = None
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
        """A reduced same-family config for CPU tests."""
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
        if cfg.moe:
            cfg = replace(
                cfg,
                moe=replace(
                    cfg.moe, n_experts=4, top_k=2, d_expert=64,
                    first_dense_ff=128 if cfg.moe.first_dense else 0,
                ),
            )
        if cfg.mla:
            cfg = replace(
                cfg,
                mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32),
            )
        if cfg.ssm:
            cfg = replace(cfg, ssm=replace(cfg.ssm, chunk=32, slstm_every=4))
        if cfg.encdec:
            cfg = replace(cfg, encdec=replace(cfg.encdec, n_encoder_layers=2))
        if cfg.vlm:
            cfg = replace(cfg, vlm=VLMConfig(n_image_tokens=16))
        if cfg.hybrid:
            cfg = replace(
                cfg,
                hybrid=replace(
                    cfg.hybrid, n_ssm_heads=2, meta_tokens=8, sliding_window=64,
                    global_layers=(0, cfg.n_layers - 1),
                ),
            )
        if self.sliding_window:
            cfg = replace(cfg, sliding_window=64)
        return cfg


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape x step-kind) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention: SSM, hybrid, or a sliding window."""
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or (cfg.sliding_window > 0 and cfg.family in ("moe", "dense"))
        )
        if not sub_quadratic:
            return (
                False,
                "pure full-attention arch: 512k-token decode reserved for SSM/hybrid/windowed",
            )
    return True, ""
