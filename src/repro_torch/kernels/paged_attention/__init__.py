"""Paged attention: the Hopper kernels K1 (decode) and K3 (speculative
verify) and their plain versions."""
from .ops import (paged_decode, paged_decode_plain,  # noqa: F401
                  paged_verify, paged_verify_plain)
