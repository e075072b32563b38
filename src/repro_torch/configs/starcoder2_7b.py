"""StarCoder2-7B [arXiv:2402.19173; hf] — dense GQA + RoPE code LM."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    mlp_gated=False,          # starcoder2 uses a plain gelu MLP (c_fc/c_proj)
    act="gelu",
    qkv_bias=True,            # starcoder2 uses bias on attention + mlp
    rope_theta=1e5,
    sliding_window=4096,      # starcoder2 attends within a 4k sliding window
    norm="layernorm",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
)
