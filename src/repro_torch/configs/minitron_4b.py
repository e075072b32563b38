"""Minitron-4B [arXiv:2407.14679; hf] — pruned Nemotron: GQA, squared-relu plain MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    mlp_gated=False,          # nemotron family: plain MLP with relu^2
    act="relu2",
    qkv_bias=False,
    rope_theta=1e4,
    norm="layernorm",
    source="arXiv:2407.14679; hf:nvidia/Minitron-4B-Base",
)
