"""Causal GQA flash attention of the training forward: the Hopper kernel K9,
its plain version and its differentiable form."""
from .ops import (attention_plain, flash_attention,  # noqa: F401
                  flash_attention_train)
