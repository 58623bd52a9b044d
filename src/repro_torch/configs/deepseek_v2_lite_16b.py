"""deepseek-v2-lite-16b [moe]: MLA attention + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MLA kv_lora=512;
64 routed experts top-6 + 2 shared, first layer dense (d_ff 10944).
[arXiv:2405.04434; hf]. The assignment header says "64e top-6" while its note
says "160 routed" (that is full V2); we follow the header + HF card.
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,                # MLA: latent KV shared; kv heads == heads
    d_ff=1408,                    # routed-expert width
    vocab=102400,
    head_dim=192,                 # qk_nope(128) + qk_rope(64)
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        first_dense=True,
        first_dense_ff=10944,
    ),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
)
