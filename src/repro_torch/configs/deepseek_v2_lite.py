"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 (expert)
vocab=102400, MoE 64e top-6, MLA kv_lora=512, 2 shared experts.
[arXiv:2405.04434; hf]

Pool-note reconciliation: the header says "MoE 64e top-6"; the free-text
note says "160 routed" which describes DeepSeek-V3 — we follow the header
(64 routed experts, top-6, 2 shared), matching the actual V2-Lite HF
config. V2-Lite additionally runs its FIRST layer as a dense MLP
(intermediate 10944) — modeled via first_dense_layers below.
"""

from .base import MLASettings, ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,              # per-expert FFN width (pool header)
    vocab_size=102400,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10000.0,
    moe=MoESettings(num_experts=64, top_k=6, d_ff_expert=1408,
                    num_shared=2, d_ff_shared=1408,
                    first_dense_layers=1, first_dense_d_ff=10944),
    mla=MLASettings(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                    v_head_dim=128),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=512, norm="rmsnorm", activation="swiglu",
        dtype="float32", attn_chunk=64, remat=False,
        moe=MoESettings(num_experts=4, top_k=2, d_ff_expert=64,
                        num_shared=1, d_ff_shared=64,
                        first_dense_layers=1, first_dense_d_ff=128,
                        capacity_factor=8.0),
        mla=MLASettings(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                        v_head_dim=16),
    )
