"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay.  [arXiv:2404.05892; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,             # d_model / head_size
    n_kv_heads=40,
    d_ff=8960,              # channel-mix width
    vocab_size=65536,
    norm="layernorm",
    activation="relu2",     # squared ReLU channel mix
    rwkv_head_size=64,
    rwkv_ddlora=32,
    rwkv_decay_lora=64,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, norm="layernorm", activation="relu2",
        dtype="float32", remat=False,
        rwkv_head_size=16, rwkv_ddlora=8, rwkv_decay_lora=8,
    )
