"""Model registry: ``build_model(cfg)``, parameter and cache init."""
from __future__ import annotations

from ..configs.base import ArchConfig
from .encdec import EncDecLM
from .params import init_tree
from .transformer import DecoderLM

# where each arch that the port does not build yet arrives (ROADMAP queues)
_NOT_YET = (
    (lambda c: not c.enc_dec
     and c.family not in ("dense", "moe", "ssm", "hybrid", "vlm"),
     "only the dense, MoE, state-slot, vlm and enc-dec LM families are "
     "ported (ROADMAP queue 1)"),
)


def build_model(cfg: ArchConfig, attn_backend: str = "reference"):
    """Model for ``cfg``: ``EncDecLM`` for enc-dec archs, ``DecoderLM``
    otherwise; ``attn_backend`` is a concrete backend name
    (``models.attn_backend.resolve_backend`` turns ``auto`` into one)."""
    for test, why in _NOT_YET:
        if test(cfg):
            raise NotImplementedError(f"{cfg.name}: {why}")
    if cfg.enc_dec:
        return EncDecLM(cfg, attn_backend)
    return DecoderLM(cfg, attn_backend)


def init_params(cfg: ArchConfig, seed: int, device):
    """Random parameters drawn from ``seed`` on ``device`` (see
    ``models.params`` for how the draw depends on the device)."""
    return init_tree(build_model(cfg).param_defs(), seed, device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device, **kw):
    """A zeroed contiguous cache for the static path (``kw``: the enc-dec
    cache's ``enc_len``)."""
    return init_tree(build_model(cfg).cache_defs(batch, max_len, **kw), 0,
                     device)
