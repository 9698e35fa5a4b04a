"""LM model substrate: the dense family's serving path.

Parameters live in ``nn.Module``s (``models.model.build_model``); the
stack, attention and caches mirror the JAX package's functions.
"""

from .model import (  # noqa: F401
    abstract_params,
    build_model,
    init_params,
)
