"""Optimizer-side pieces of the port: the int8 + error-feedback gradient
compression of the MapReduce reducer.  The LM optimizers arrive with
training (ROADMAP queue 1 item 15)."""
from . import compression  # noqa: F401
