"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape is a
``ShapeConfig``.  A (arch x shape) pair is a *cell* of the dry-run / roofline matrix.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

BF16 = "bfloat16"


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MLP ---
    mlp_gated: bool = True
    act: str = "silu"                # silu | gelu | relu | relu2

    # --- attention ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0          # 0 = full attention

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0           # leading dense layers (deepseek style)
    d_ff_dense: int = 0              # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # --- hybrid (recurrentgemma / griffin) ---
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    d_rnn: int = 0                   # RG-LRU width
    conv_width: int = 4
    attn_window: int = 0             # local-attention window in hybrid blocks

    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_n_groups: int = 1

    # --- encoder-decoder ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    cross_attn: bool = False

    # --- modality frontends (stubs per assignment) ---
    n_image_tokens: int = 0          # vlm: number of patch-embedding tokens
    frontend_dim: int = 0            # dim of precomputed patch/frame embeddings
    audio_frontend: bool = False     # audio: encoder consumes frame embeddings

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = BF16
    remat: str = "full"              # full | dots | none
    unroll: bool = False             # unroll layer/chunk scans (dry-run accounting)
    loss_chunk: int = 512            # CE loss sequence-chunk size
    attn_q_block: int = 512          # chunked-attention query-block size
    pad_heads_to: int = 0            # pad q-heads for TP divisibility (perf knob;
                                     # padded heads are zero-inert at deploy)
    seq_parallel: bool = False       # Megatron-SP style: residual stream (and
                                     # remat residuals) sequence-sharded over
                                     # the model axis between blocks
    norm_fp32: bool = True           # False: norm elementwise math stays bf16
                                     # (fp32 only for mean/var stats) so the
                                     # TP gradient all-reduces stay bf16
    source: str = ""                 # provenance note

    # ---------------- derived ----------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        return max(self.pad_heads_to, self.n_heads) if self.pad_heads_to else self.n_heads

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state does not grow linearly with an *unbounded* full-
        attention KV cache (SSM state / bounded local window)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # -------- parameter counts (for MODEL_FLOPS = 6 N D) --------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count. ``active_only`` counts MoE experts at top_k."""
        d, v = self.d_model, self.vocab_padded
        n = v * d                                   # embedding
        if not self.tie_embeddings:
            n += d * v                              # lm head

        def attn_params() -> int:
            if self.use_mla:
                h = self.n_heads
                qd = h * (self.nope_head_dim + self.rope_head_dim)
                p = 0
                if self.q_lora_rank:
                    p += d * self.q_lora_rank + self.q_lora_rank * qd
                else:
                    p += d * qd
                p += d * (self.kv_lora_rank + self.rope_head_dim)
                p += self.kv_lora_rank * self.n_heads * (self.nope_head_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            hd = self.head_dim_
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            m = (3 if self.mlp_gated else 2) * d * ff
            return m

        if self.family == "ssm":
            # mamba2 block: in_proj (z,x,B,C,dt) + conv + A,D + norm + out_proj
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_n_heads
            proj_in = d * (2 * di + 2 * self.ssm_n_groups * ns + nh)
            conv = self.conv_width * (di + 2 * self.ssm_n_groups * ns)
            block = proj_in + conv + 2 * nh + di + di * d + d
            return n + self.n_layers * block

        if self.family == "hybrid":
            pat = self.block_pattern or ("rec",)
            n_attn = sum(1 for i in range(self.n_layers) if pat[i % len(pat)] == "attn")
            n_rec = self.n_layers - n_attn
            dr = self.d_rnn or d
            rec = d * dr * 2 + dr * d + self.conv_width * dr + 4 * dr  # branches+proj+conv+lru
            blk_mlp = mlp_params(self.d_ff)
            return n + n_attn * (attn_params() + blk_mlp) + n_rec * (rec + blk_mlp)

        layers = self.n_layers if not self.enc_dec else (self.n_enc_layers + self.n_dec_layers)
        per_layer = attn_params()
        if self.enc_dec:
            per_layer += attn_params() // 2          # rough: cross-attn on decoder half
        if self.is_moe:
            n_dense = self.first_k_dense
            n_moe = self.n_layers - n_dense
            e = self.top_k if active_only else self.n_experts
            moe_ff = e * mlp_params(self.d_ff_expert)
            moe_ff += self.n_shared_experts * mlp_params(self.d_ff_expert)
            router = self.d_model * self.n_experts
            total = n + self.n_layers * per_layer
            total += n_dense * mlp_params(self.d_ff_dense or self.d_ff)
            total += n_moe * (moe_ff + router)
            return total
        return n + layers * (per_layer + mlp_params(self.d_ff))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving knobs (consumed by ``repro.serving``).

    The engine decodes at a single fixed batch shape (``max_slots``) and
    prefills at a small set of bucketed prompt lengths, so the whole serving
    loop compiles a handful of programs regardless of traffic mix.  KV lives
    in a paged pool: ``num_pages`` fixed-size pages of ``page_size`` tokens,
    with physical page 0 reserved as a write sink for idle slots.
    """
    page_size: int = 16          # tokens per KV page
    max_slots: int = 8           # concurrent decode slots (fixed jit batch dim)
    max_len: int = 96            # per-request prompt + generation cap (tokens)
    num_pages: int = 0           # 0 -> auto, family-aware: max_slots *
                                 # table_width + 1 (see PagedKVPool)
    prefill_buckets: Tuple[int, ...] = ()   # () -> pow2 multiples of page_size
    eos_id: int = -1             # -1: no EOS; requests run to max_new tokens
    prefix_cache: bool = False   # radix-tree prompt-prefix KV sharing
    cache_eviction: str = "lru"  # lru | none (no eviction under pressure)
    enc_len: int = 16            # enc-dec: synthetic encoder frames per request
                                 # (fixed so results are batch-shape independent)
    attn_backend: str = "auto"   # paged-attention backend (models.attn_backend
                                 # registry): auto -> the hand-written Hopper
                                 # kernels for CUDA tensors, the plain torch
                                 # reference gather+attend for CPU tensors
    prefill_chunk_tokens: int = 0  # per-step prefill token budget: 0 = one
                                 # monolithic (bucketed) prefill per admission;
                                 # > 0 = long prompts split into page-aligned
                                 # chunks of at most this many tokens that
                                 # interleave with decode steps (Sarathi-style)
    kv_dtype: str = "bf16"       # paged-KV storage dtype: bf16 (token-exact
                                 # vs static) or int8 (absmax-quantized pages
                                 # with per-token-per-head bf16 scales and
                                 # in-kernel dequant; parity contract becomes
                                 # bounded logit error + high-margin greedy
                                 # match, see serving/quant_verify)
    speculate_tokens: int = 0    # n-gram speculative decoding: draft length K
                                 # per verify step (0 = off).  Each step checks
                                 # K drafted tokens plus the usual next token
                                 # in one fixed-shape launch; accepted tokens
                                 # stay token-exact vs the non-speculative
                                 # greedy stream (serving/speculate)
    admission_control: bool = False  # deadline-aware shedding + mid-flight
                                 # deadline eviction (serving/admission).  Off:
                                 # deadlines attached to requests are inert
                                 # metadata, nothing is shed or evicted
    default_deadline_s: float = 0.0   # default total deadline applied to
                                 # requests that don't carry one (0 = none)
    default_ttft_deadline_s: float = 0.0  # default TTFT deadline (0 = none)

    def __post_init__(self):
        assert self.page_size > 0 and self.max_slots > 0
        assert self.max_len % self.page_size == 0, \
            "max_len must be a multiple of page_size (page-table geometry)"
        assert self.cache_eviction in ("lru", "none"), self.cache_eviction
        assert self.attn_backend in ("auto", "reference", "hopper"), \
            self.attn_backend
        assert self.prefill_chunk_tokens >= 0, self.prefill_chunk_tokens
        assert self.kv_dtype in ("bf16", "int8"), self.kv_dtype
        assert 0 <= self.speculate_tokens < self.page_size, \
            "speculate_tokens must fit inside one page (windowed-ring slack)"
        assert self.default_deadline_s >= 0, self.default_deadline_s
        assert self.default_ttft_deadline_s >= 0, self.default_ttft_deadline_s

    @property
    def chunk_tokens(self) -> int:
        """Effective page-aligned per-step prefill budget (0 = chunking off).

        An unaligned ``prefill_chunk_tokens`` is rounded down to a whole
        number of pages, never below one page — chunk boundaries always land
        on page boundaries so the radix cache can publish completed pages
        mid-prefill."""
        if not self.prefill_chunk_tokens:
            return 0
        return max(self.page_size,
                   (self.prefill_chunk_tokens // self.page_size)
                   * self.page_size)

    @property
    def pages_per_request(self) -> int:
        return self.max_len // self.page_size

    @property
    def total_pages(self) -> int:
        """Pool size for a plain token-addressable KV family (+1 reserved
        null page).  ``PagedKVPool.total_pages`` is the authoritative,
        family-aware figure — it caps the per-request table at the sliding-
        window ring horizon and widens it for the vlm image prefix."""
        # +1 for the reserved null page
        return self.num_pages or self.max_slots * self.pages_per_request + 1

    @property
    def buckets(self) -> Tuple[int, ...]:
        """Prefill length buckets (each a multiple of page_size, <= max_len).

        User-supplied buckets are rounded up to page multiples, clamped to
        max_len, and max_len itself is always present so every admissible
        prompt (< max_len) has a bucket."""
        if self.prefill_buckets:
            bs = {min(round_up(b, self.page_size), self.max_len)
                  for b in self.prefill_buckets}
            bs.add(self.max_len)
            return tuple(sorted(bs))
        out, b = [], self.page_size
        while b < self.max_len:
            out.append(b)
            b *= 2
        out.append(self.max_len)
        return tuple(out)

    def bucket_of(self, n: int) -> int:
        """Smallest prefill bucket covering ``n`` tokens."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt len {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def supports(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether the (arch, shape) cell is runnable; else a skip reason."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention; arch is full-attention"
    return True, ""


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 if not cfg.block_pattern else len(cfg.block_pattern) or 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else cfg.n_kv_heads,
        head_dim=32 if cfg.head_dim else 0,
        d_ff=256,
        vocab=512,
        remat="none",
    )
    if cfg.sliding_window:
        small.update(sliding_window=32)   # window binds within CPU-size prompts
    if cfg.is_moe:
        small.update(n_experts=4, top_k=2, d_ff_expert=64,
                     n_shared_experts=min(cfg.n_shared_experts, 1),
                     first_k_dense=min(cfg.first_k_dense, 1), d_ff_dense=256)
    if cfg.use_mla:
        small.update(kv_lora_rank=32, q_lora_rank=64, rope_head_dim=16,
                     nope_head_dim=32, v_head_dim=32, head_dim=0)
    if cfg.family == "ssm":
        small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32, n_heads=1, n_kv_heads=0,
                     d_ff=0, head_dim=0)
    if cfg.family == "hybrid":
        small.update(d_rnn=128, attn_window=32, n_layers=len(cfg.block_pattern) or 3,
                     n_kv_heads=1, head_dim=32)
    if cfg.enc_dec:
        small.update(n_enc_layers=2, n_dec_layers=2, n_layers=2)
    if cfg.audio_frontend:
        small.update(frontend_dim=small["d_model"])
    if cfg.n_image_tokens:
        small.update(n_image_tokens=8, frontend_dim=64)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
