"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attn, 1:2.  [arXiv:2402.19427;
unverified]

Layer pattern (rec, rec, attn) — one local-attention layer per two
RG-LRU layers; 38 = 12 full macro-units + 2 trailing recurrent layers.
Local attention window 2048, MQA (kv=1). Sub-quadratic: runs long_500k.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,           # MQA
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    norm="rmsnorm",
    activation="geglu",     # gemma-style GeGLU
    rope_theta=10000.0,
    block_pattern=("rec", "rec", "attn"),
    window=2048,
    lru_width=4096,
    conv_width=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke", family="hybrid",
        n_layers=5,          # 1 macro-unit + 2 trailing rec layers
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
        vocab_size=512, norm="rmsnorm", activation="geglu",
        dtype="float32", attn_chunk=64, remat=False,
        block_pattern=("rec", "rec", "attn"), window=16, lru_width=64,
        conv_width=4,
    )
