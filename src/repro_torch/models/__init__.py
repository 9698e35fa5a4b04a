"""LM model substrate: the serving path of every architecture family.

Parameters live in ``nn.Module``s (``models.model.build_model``): dense,
moe (with MLA and lead dense layers), encdec, hybrid (RG-LRU and local
attention), ssm (RWKV-6) and vlm. The stacks, attention, experts,
recurrences and decode states mirror the JAX package's functions.
"""

from .model import (  # noqa: F401
    abstract_params,
    build_model,
    init_params,
)
