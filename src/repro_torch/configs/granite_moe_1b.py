"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from .base import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,               # per-expert FFN width
    vocab_size=49155,
    tie_embeddings=True,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10000.0,
    moe=MoESettings(num_experts=32, top_k=8, d_ff_expert=512),
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=512, tie_embeddings=True, norm="rmsnorm",
        activation="swiglu", dtype="float32", attn_chunk=64, remat=False,
        # capacity_factor high enough that smoke tests never drop tokens
        # (keeps prefill and per-token decode bit-consistent).
        moe=MoESettings(num_experts=4, top_k=2, d_ff_expert=64,
                        capacity_factor=8.0),
    )
