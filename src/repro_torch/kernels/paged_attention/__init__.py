"""Paged attention: the Hopper kernels K1 (decode), K3 (speculative
verify) and K5 (MLA latent decode) and their plain versions."""
from .ops import (mla_paged_decode, mla_paged_decode_plain,  # noqa: F401
                  paged_decode, paged_decode_plain, paged_verify,
                  paged_verify_plain)
