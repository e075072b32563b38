"""Ragged paged prefill: the Hopper kernel K2 and its plain version."""
from .ops import ragged_prefill, ragged_prefill_plain  # noqa: F401
