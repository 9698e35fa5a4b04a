"""Atomic, asynchronous, self-describing checkpoints (the JAX package's
layout and guarantees)."""

from .checkpointer import Checkpointer  # noqa: F401
