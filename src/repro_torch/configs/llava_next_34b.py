"""LLaVA-NeXT-34B backbone [hf:llava-hf; unverified] — dense GQA LM; vision frontend
stubbed as precomputed patch embeddings + projector (anyres tiling out of backbone scope)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    mlp_gated=True,
    act="silu",
    qkv_bias=False,
    rope_theta=5e6,
    norm="rmsnorm",
    n_image_tokens=576,
    frontend_dim=1024,        # CLIP-L patch-embedding dim (stub)
    source="hf:llava-hf/llava-v1.6-34b-hf; unverified",
)
