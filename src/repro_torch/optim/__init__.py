"""Optimizer, learning-rate schedule and gradient machinery of the LM
trainer (the JAX package's ``optim``): AdamW with float32 state keyed by
parameter name, the cosine-warmup schedule, microbatch accumulation and
int8 compression."""

from .optimizer import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, clip_by_global_norm, sgd_update,
)
from .schedule import cosine_warmup  # noqa: F401
from .grad import (  # noqa: F401
    accumulate_gradients,
    compress_int8,
    decompress_int8,
)
