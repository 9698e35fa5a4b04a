"""Data sources: the LM token pipeline, the CT projection source and the
byte tokenizer."""

from .pipeline import CTProjectionSource, TokenPipeline  # noqa: F401
from .tokenizer import ByteTokenizer  # noqa: F401
