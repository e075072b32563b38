"""Paged-attention decode: the Hopper kernel K1 and its plain version."""
from .ops import paged_decode, paged_decode_plain  # noqa: F401
