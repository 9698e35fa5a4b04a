"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,          # kv == heads -> plain MHA expressed as GQA
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",       # StableLM family uses LayerNorm
    activation="swiglu",
    rope_theta=10000.0,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, norm="layernorm", activation="swiglu",
        dtype="float32", attn_chunk=64, remat=False,
    )
