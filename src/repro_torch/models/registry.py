"""Model registry: ``build_model(cfg)``, parameter and cache init."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .params import init_tree
from .transformer import DecoderLM

# where each arch that the port does not build yet arrives (ROADMAP queue 1)
_NOT_YET = (
    (lambda c: c.enc_dec or bool(c.n_image_tokens),
     "enc-dec and vlm families arrive with ROADMAP queue 1 item 14"),
    (lambda c: c.family not in ("dense", "moe", "ssm", "hybrid"),
     "only the dense, MoE and state-slot decoder families are ported "
     "(ROADMAP queue 1)"),
    (lambda c: bool(c.attn_logit_softcap),
     "the attention logit softcap is not ported (no registered arch sets "
     "it; ROADMAP queue 2, K1 modes)"),
)


def build_model(cfg: ArchConfig, attn_backend: str = "reference"):
    """Model for ``cfg``; ``attn_backend`` is a concrete backend name
    (``models.attn_backend.resolve_backend`` turns ``auto`` into one)."""
    for test, why in _NOT_YET:
        if test(cfg):
            raise NotImplementedError(f"{cfg.name}: {why}")
    return DecoderLM(cfg, attn_backend)


def init_params(cfg: ArchConfig, seed: int, device):
    """Random parameters drawn from ``seed`` on ``device`` (see
    ``models.params`` for how the draw depends on the device)."""
    return init_tree(build_model(cfg).param_defs(), seed, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    """A zeroed contiguous cache for the static path."""
    return init_tree(build_model(cfg).cache_defs(batch, max_len), 0, device)
