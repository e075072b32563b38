"""Ragged paged prefill: the Hopper kernels K2 (full attention) and K4
(sliding-window ring) and their plain versions."""
from .ops import (ragged_prefill, ragged_prefill_plain,  # noqa: F401
                  windowed_prefill, windowed_prefill_plain)
