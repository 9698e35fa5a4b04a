"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1000000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160,
        vocab_size=512, qkv_bias=True, norm="rmsnorm",
        activation="swiglu", dtype="float32", attn_chunk=64, remat=False,
    )
