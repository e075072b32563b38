"""SeamlessM4T-large-v2 backbone [arXiv:2308.11596; hf] — enc-dec transformer; audio
frontend stubbed (``input_specs`` provides precomputed frame embeddings)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,              # 24 enc + 24 dec of this geometry
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,            # MHA
    d_ff=8192,
    vocab=256206,
    mlp_gated=False,
    act="relu",
    qkv_bias=True,
    rope_theta=1e4,
    norm="layernorm",
    enc_dec=True,
    n_enc_layers=24,
    n_dec_layers=24,
    cross_attn=True,
    audio_frontend=True,
    frontend_dim=1024,
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
)
