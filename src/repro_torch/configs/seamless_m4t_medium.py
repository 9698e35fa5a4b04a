"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (GQA kv=16)
d_ff=4096 vocab=256206 — enc-dec, multimodal.  [arXiv:2308.11596; hf]

The speech frontend (conformer feature extractor) is a STUB per the pool:
input_specs provide precomputed frame embeddings (B, S, d_model). The
transformer backbone (12L encoder + 12L decoder with cross-attention) is
fully real.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,            # decoder layers
    n_enc_layers=12,        # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    activation="gelu",
    rope_theta=10000.0,
    frontend="audio_frames",
    frontend_dim=1024,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, norm="layernorm", activation="gelu",
        dtype="float32", attn_chunk=64, remat=False,
        frontend="audio_frames", frontend_dim=64,
    )
