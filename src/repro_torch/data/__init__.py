"""Data for the paper's path: procedural MNIST-like digits and the paper's
diversity-based dedup (numpy only; copies of ``repro.data``'s modules).
The LM token pipeline arrives with training (ROADMAP queue 1 item 15)."""
from .synthetic_mnist import dataset, train_test  # noqa: F401
from .dedup import dedup, duplicate_stats  # noqa: F401
