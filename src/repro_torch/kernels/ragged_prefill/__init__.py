"""Ragged paged prefill: the Hopper kernels K2 (full attention), K4
(sliding-window ring) and K6 (MLA latent pages, with its K/V-building
stage A) and their plain versions."""
from .ops import (mla_build_kv, mla_build_kv_plain,  # noqa: F401
                  mla_ragged_prefill, mla_ragged_prefill_plain,
                  ragged_prefill, ragged_prefill_plain, windowed_prefill,
                  windowed_prefill_plain)
