"""DBRX-132B [hf:databricks/dbrx-base; unverified] — fine-grained MoE, 16 experts top-4."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,               # per-expert ffn hidden
    vocab=100352,
    mlp_gated=True,
    act="silu",
    qkv_bias=False,
    rope_theta=5e5,
    norm="layernorm",
    n_experts=16,
    top_k=4,
    d_ff_expert=10752,
    capacity_factor=1.25,
    source="hf:databricks/dbrx-base; unverified",
)
