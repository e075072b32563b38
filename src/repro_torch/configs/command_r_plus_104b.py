"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-plus; unverified] — dense GQA, no bias."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    mlp_gated=True,
    act="silu",
    qkv_bias=False,
    rope_theta=75e6,
    sliding_window=4096,      # interleaved local attention (modeled uniformly)
    norm="layernorm",
    tie_embeddings=True,      # cohere ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-plus; unverified",
)
