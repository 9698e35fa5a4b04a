"""Data sources: the CT projection source and the byte tokenizer."""

from .pipeline import CTProjectionSource  # noqa: F401
from .tokenizer import ByteTokenizer  # noqa: F401
