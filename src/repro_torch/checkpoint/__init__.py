"""Checkpoints of the trainer's state: atomic, async, garbage-collected."""
from .ckpt import all_steps, latest_step, restore, save  # noqa: F401
