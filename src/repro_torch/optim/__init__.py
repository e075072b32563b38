"""Optimizer-side pieces of the port: the LM optimizers (AdamW, SGD with
momentum, an fp32 master copy, clipping and schedules) and the int8 +
error-feedback gradient compression of the MapReduce reducer."""
from .optimizers import (OptConfig, apply_updates, global_norm,  # noqa: F401
                         init_opt_state, lr_at, opt_state_defs)
from . import compression  # noqa: F401
