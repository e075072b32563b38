"""Paged attention: the Hopper kernels K1 (decode), K3 (speculative
verify), K5 (MLA latent decode) and K7 (MLA latent verify) and their plain
versions."""
from .ops import (mla_paged_decode, mla_paged_decode_plain,  # noqa: F401
                  mla_paged_verify, mla_paged_verify_plain, paged_decode,
                  paged_decode_plain, paged_verify, paged_verify_plain)
