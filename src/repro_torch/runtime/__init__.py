"""The fault-tolerant training loop and restore onto another device."""
from .fault_tolerance import LoopConfig, TrainLoop  # noqa: F401
from .elastic import degraded_mesh, restore_on_mesh  # noqa: F401
