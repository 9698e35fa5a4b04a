"""Config dataclasses: model architecture, shapes, meshes, runs.

One ``ModelConfig`` per assigned architecture lives in its own module in
this package (exact dims from the public pool) together with a reduced
``smoke()`` variant for CPU tests. Shape configs implement the pool's
four workload cells (train_4k / prefill_32k / decode_32k / long_500k).
The records are the JAX package's, field for field; ``np_dtype`` names a
torch dtype here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoESettings:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    d_ff_shared: Optional[int] = None
    capacity_factor: float = 1.25
    # Routing group size (GShard group dim): capacity is per group, so
    # dispatch tensors scale linearly in tokens. 0 -> all tokens one group.
    group_size: int = 4096
    # DeepSeek-V2: leading dense layers before the MoE stack begins.
    first_dense_layers: int = 0
    first_dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class MLASettings:
    kv_lora_rank: int
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | encdec | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_chunk: int = 1024         # flash-attention KV chunk
    remat: bool = True             # activation checkpointing per layer
    remat_policy: str = "nothing"  # "nothing" | "dots" — what remat saves
    # MoE / MLA
    moe: Optional[MoESettings] = None
    mla: Optional[MLASettings] = None
    # hybrid (RecurrentGemma / Griffin)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    window: int = 0                # sliding-window size for "attn" blocks
    lru_width: int = 0
    conv_width: int = 4
    # rwkv
    rwkv_head_size: int = 64
    rwkv_ddlora: int = 32
    rwkv_decay_lora: int = 64
    # encoder-decoder
    n_enc_layers: int = 0
    # frontend stubs ([audio]/[vlm]: precomputed embeddings per the pool)
    frontend: Optional[str] = None        # "audio_frames" | "vision_patches"
    frontend_dim: int = 0                 # raw stub embedding dim
    frontend_tokens: int = 0              # tokens contributed by frontend

    # ---- derived ---------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def np_dtype(self) -> torch.dtype:
        """The activation and weight dtype, as a torch dtype (the JAX
        package's name)."""
        return _DTYPES[self.dtype]

    @property
    def sub_quadratic(self) -> bool:
        """True iff a 512k-token decode state is O(1) or O(window)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # no encoder-only arch in the assigned pool

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k / prefill_32k / ...
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.seq_len * self.global_batch


LM_SHAPES = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


def get_shape(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False

    @property
    def shape(self):
        return (2, 16, 16) if self.multi_pod else (16, 16)

    @property
    def axes(self):
        return ("pod", "data", "model") if self.multi_pod else (
            "data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run hyperparameters (launch/train.py)."""
    steps: int = 100
    schedule_horizon: int = 0      # 0 = use `steps`; set explicitly when
    # a run is split across restarts so the LR schedule stays consistent
    microbatch: int = 0            # 0 = no gradient accumulation
    lr: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    grad_compression: bool = False  # int8 error-feedback all-reduce
    log_every: int = 10
