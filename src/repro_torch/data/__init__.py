"""Data: procedural MNIST-like digits and the paper's diversity-based dedup
for the paper's path, and the deterministic LM token pipeline of the
trainer (numpy only; copies of ``repro.data``'s modules)."""
from .synthetic_mnist import dataset, train_test  # noqa: F401
from .dedup import dedup, duplicate_stats  # noqa: F401
from .pipeline import Prefetcher, ShardedBatches, token_batches  # noqa: F401
