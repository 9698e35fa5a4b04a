"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2(Qwen2-0.5B) backbone.
[arXiv:2404.16821; hf]

The InternViT-300M vision tower is a STUB per the pool: input_specs
provide precomputed patch embeddings (B, 256, 1024); the mlp1 projector
(1024 -> d_model) and the full LM backbone are real.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1000000.0,
    frontend="vision_patches",
    frontend_dim=1024,       # InternViT-300M hidden size
    frontend_tokens=256,     # patch tokens per image tile
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-smoke", family="vlm",
        n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, d_ff=112,
        vocab_size=512, qkv_bias=True, tie_embeddings=True,
        norm="rmsnorm", activation="swiglu", dtype="float32",
        attn_chunk=64, remat=False,
        frontend="vision_patches", frontend_dim=32, frontend_tokens=8,
    )
