"""LM model substrate: every architecture family, served and trained.

Parameters live in ``nn.Module``s (``models.model.build_model``): dense,
moe (with MLA and lead dense layers), encdec, hybrid (RG-LRU and local
attention), ssm (RWKV-6) and vlm. The stacks, attention, experts,
recurrences and decode states mirror the JAX package's functions; each
module's ``loss`` is the family's training objective.
"""

from .model import (  # noqa: F401
    abstract_params,
    build_model,
    init_params,
)
