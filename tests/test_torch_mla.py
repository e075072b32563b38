"""Multi-head latent attention (deepseek-v2) in the port, on the CPU.

1. *Kernel plain versions* -- ``mla_paged_decode_plain`` (kernel K5's) and
   ``mla_ragged_prefill_plain`` (kernel K6's) against the Pallas
   ``mla_paged_decode_fwd`` and ``mla_ragged_prefill_fwd`` in interpret
   mode, on bf16 inputs drawn with numpy, and on int8 latent pages
   quantized from them by the port's ``quantize_int8`` (the same payload
   and scales on both sides): ragged positions over shuffled
   tables, idle rows (position 0, null table), a cached prefix (chunks at
   ``start > 0``) and a partial chunk (padding rows, computed on both
   sides).  Each output element within one bf16 ulp of the largest
   magnitude in its row (one head of one token), never below 2^-14, the
   rule of ``test_torch_kernels``: both sides take fp32 sums of the same
   bf16 operands in another order.
2. *Engine* -- reduced deepseek-v2's continuous engine (latent pages, the
   radix prefix cache and chunked prefill on) against the port's static
   baseline token for token, and against the JAX engine with the same
   seeded parameters under the dual gate (max |dlogit| <= 0.25, no
   high-margin mismatch; see ``test_torch_moe`` for why the bf16 MoE is
   held by the gate, not token for token); and through the CLI.
3. *Weights* -- ``params_from_numpy`` maps the JAX tree's MLA and MoE
   leaves (``dense_blocks`` and ``blocks`` stacked apart, the router fp32)
   leaf for leaf and back.

MLA speculation (kernel K7) and int8 latent pages in the engine are in
``test_torch_mla_spec``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    mla_paged_decode_fwd)
from repro.kernels.ragged_prefill.ops import (  # noqa: E402
    mla_ragged_prefill_attend)
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving.quant_verify import replay_logits as j_replay  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    mla_paged_decode, mla_paged_decode_plain)
from repro_torch.kernels.ragged_prefill import (  # noqa: E402
    mla_ragged_prefill, mla_ragged_prefill_plain)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.attention import quantize_int8  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving import (Engine, dual_gate,  # noqa: E402
                                 generate_static, replay_logits)
from test_torch_engine import seeded_params  # noqa: E402
from test_torch_kernels import _bf16, _within_one_ulp  # noqa: E402

TOL = 0.25
ARCH = "deepseek-v2-236b"


from _torch_common import one_thread  # noqa: E402, F401


def _latent_pool(rng, lengths, ps, L, R, width):
    """Shuffled latent pages for requests of ``lengths`` tokens; table
    entries past a request's pages (and idle rows) point at page 0."""
    need = [-(-n // ps) for n in lengths]
    P = sum(need) + 3
    perm = rng.permutation(P - 1) + 1
    tables = np.zeros((len(lengths), width), np.int32)
    at = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[at:at + n]
        at += n
    return _bf16(rng.randn(P, ps, L)), _bf16(rng.randn(P, ps, R)), tables


def _int8_pages(pages):
    """Quantize a torch bf16 latent pool with the port's ``quantize_int8``:
    ((jax int8 payload, torch int8 payload), (jax bf16 scales, torch bf16
    scales)), the same values on both sides."""
    q8, s = quantize_int8(pages)
    return ((jnp.asarray(q8.numpy()), q8),
            (jnp.asarray(s.float().numpy(), jnp.bfloat16), s))


def _pools(rng, lengths, ps, L, R, width, int8):
    """(jax, torch) latent pools -- ckv, krope and their scales (None for
    bf16) -- and the tables."""
    (cj, ct), (rj, rt), tables = _latent_pool(rng, lengths, ps, L, R, width)
    if not int8:
        return (cj, rj, None, None), (ct, rt, None, None), tables
    (cj, ct), (csj, cst) = _int8_pages(ct)
    (rj, rt), (rsj, rst) = _int8_pages(rt)
    return (cj, rj, csj, rsj), (ct, rt, cst, rst), tables


DECODE_CASES = [
    # (ps, H, L, R, width): positions 0, a page's last and first slot, the
    # table's last slot, and an idle row
    (8, 4, 32, 16, 4),
    (16, 8, 64, 16, 3),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ps,H,L,R,width", DECODE_CASES)
def test_mla_decode_plain_matches_pallas(ps, H, L, R, width, int8):
    rng = np.random.RandomState(ps + H)
    pos = np.array([0, ps - 1, ps, width * ps - 1, 0], np.int32)
    lengths = list(pos + 1)
    lengths[-1] = 0                                        # idle row
    (cj, rj, csj, rsj), (ct, rt, cst, rst), tables = _pools(
        rng, lengths, ps, L, R, width, int8)
    B = len(pos)
    (qj, qt), (qrj, qrt) = _bf16(rng.randn(B, H, L)), _bf16(rng.randn(B, H, R))
    scale = 1.0 / math.sqrt(48)
    ref = np.asarray(mla_paged_decode_fwd(
        qj, qrj, cj, rj, jnp.asarray(tables), jnp.asarray(pos), scale=scale,
        ckv_scale=csj, krope_scale=rsj, interpret=True), np.float32)
    args = (qt, qrt, ct, rt, torch.from_numpy(tables), torch.from_numpy(pos))
    kw = dict(scale=scale, ckv_scale=cst, krope_scale=rst)
    got = mla_paged_decode_plain(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, L)
    assert _within_one_ulp(got.float().numpy(), ref)
    # the wrapper runs the plain version for CPU tensors, and counts nothing
    n = mla_paged_decode.launches
    assert torch.equal(mla_paged_decode(*args, **kw), got)
    assert mla_paged_decode.launches == n


PREFILL_CASES = [
    # (ps, H, nope, R, v, L, T, q_blk, starts, n_live): a first chunk, a
    # chunk after a cached prefix, a partial chunk
    (8, 4, 32, 16, 32, 32, 16, 8, (0, 24, 8), (16, 16, 5)),
    (16, 2, 32, 16, 16, 64, 32, 16, (48, 0, 16), (20, 32, 32)),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("ps,H,nope,R,vd,L,T,q_blk,starts,n_live",
                         PREFILL_CASES)
def test_mla_prefill_plain_matches_pallas(ps, H, nope, R, vd, L, T, q_blk,
                                          starts, n_live, int8):
    rng = np.random.RandomState(ps + T)
    B = len(starts)
    width = -(-(max(starts) + T) // ps)
    (cj, rj, csj, rsj), (ct, rt, cst, rst), tables = _pools(
        rng, [s + n for s, n in zip(starts, n_live)], ps, L, R, width, int8)
    qj, qt = _bf16(rng.randn(B, T, H, nope + R))
    wj, wt = _bf16(rng.randn(L, H, nope + vd) / np.sqrt(L))
    st, nl = np.asarray(starts, np.int32), np.asarray(n_live, np.int32)
    ref = np.asarray(mla_ragged_prefill_attend(
        qj, cj, rj, wj, jnp.asarray(tables), jnp.asarray(st),
        jnp.asarray(nl), nope=nope, q_blk=q_blk, ckv_scale=csj,
        krope_scale=rsj, interpret=True), np.float32)
    args = (qt, ct, rt, wt, torch.from_numpy(tables), torch.from_numpy(st))
    kw = dict(nope=nope, ckv_scale=cst, krope_scale=rst)
    got = mla_ragged_prefill_plain(*args, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, vd)
    assert _within_one_ulp(got.float().numpy(), ref)
    assert torch.equal(mla_ragged_prefill(*args, **kw), got)


# ------------------------------------------------------------------- engine

SCFG = dict(page_size=8, max_slots=4, max_len=64, prefix_cache=True,
            prefill_chunk_tokens=16)


def _cfgs():
    return reduced(get_arch(ARCH)), tconfigs.reduced(tconfigs.get_arch(ARCH))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    rng = np.random.RandomState(0)
    shared = rng.randint(1, jcfg.vocab, size=16).tolist()
    prompts = [shared + rng.randint(1, jcfg.vocab, size=n).tolist()
               for n in (3, 17, 30, 1)]
    return jcfg, tcfg, jparams, tparams, prompts, [6, 9, 4, 12]


def _run(tcfg, tparams, prompts, budgets):
    eng = Engine(tcfg, tconfigs.ServeConfig(**SCFG), tparams, device="cpu")
    with torch.no_grad():
        results, m = eng.run_offline(prompts, budgets)
    return eng, [r.tokens for r in results], m


@pytest.fixture(scope="module")
def engine_run(setup):
    """The port's engine over the module's prompts, run once and shared by
    the static and the JAX comparisons."""
    _, tcfg, _, tparams, prompts, budgets = setup
    return _run(tcfg, tparams, prompts, budgets)


def test_mla_engine_matches_static(setup, engine_run):
    _, tcfg, _, tparams, prompts, budgets = setup
    eng, tokens, m = engine_run
    assert eng.spec.kinds[0].kind == "paged_mla" and eng.radix is not None
    assert m["cached_tokens"] > 0 and m["chunked_prefill_steps"] > 0
    with torch.no_grad():
        ref, _ = generate_static(tcfg, tparams, prompts, budgets,
                                 tconfigs.ServeConfig(**SCFG))
    assert tokens == ref
    assert eng.pool.conservation_ok()
    # one token's latent pages: (kv_lora + rope) bf16 values per layer
    assert eng.pool.kv_bytes_per_token == \
        tcfg.n_layers * (tcfg.kv_lora_rank + tcfg.rope_head_dim) * 2


def test_mla_engine_matches_jax_engine_by_dual_gate(setup, engine_run):
    jcfg, tcfg, jparams, tparams, prompts, budgets = setup
    _, tokens, _ = engine_run
    jeng = JEngine(jcfg, JServeConfig(**SCFG), jparams)
    jtokens = [r.tokens for r in jeng.run_offline(prompts, budgets)[0]]
    assert [len(t) for t in jtokens] == [len(t) for t in tokens] == budgets
    jscfg, tscfg = JServeConfig(**SCFG), tconfigs.ServeConfig(**SCFG)
    pick = [1, 3]           # a cache hit whose tail spans a chunk, the longest
    ref = [j_replay(jcfg, jscfg, jparams, prompts[i], tokens[i],
                    kv_dtype="bf16") for i in pick]
    with torch.no_grad():
        test = [replay_logits(tcfg, tscfg, tparams, prompts[i], tokens[i])
                for i in pick]
    rep = dual_gate(ref, test, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}


def test_cli_serves_deepseek_on_cpu(capsys):
    tokens = tserve.main([
        "--device", "cpu", "--arch", ARCH, "--reduced", "--requests", "6",
        "--mixed", "--prompt-len", "48", "--prefix-cache", "--shared-prefix",
        "2", "--prefill-chunk-tokens", "16", "--verify"])
    assert len(tokens) == 6
    assert "verify OK: 6 requests" in capsys.readouterr().out


# ------------------------------------------------------------------ weights

def test_params_from_numpy_maps_mla_and_moe_leaves(setup):
    jcfg, tcfg, jparams, tparams, _, _ = setup
    jtree = jax.device_get(jparams)
    k = tcfg.first_k_dense
    assert k == 1
    dense, blocks = tparams["dense_blocks"], tparams["blocks"]
    assert dense["attn"]["wkv_b"].shape == (k, tcfg.kv_lora_rank,
                                            tcfg.n_heads,
                                            tcfg.nope_head_dim
                                            + tcfg.v_head_dim)
    assert dense["mlp"]["up"].shape == (k, tcfg.d_model, tcfg.d_ff_dense)
    assert blocks["moe"]["up"].shape == (tcfg.n_layers - k, tcfg.n_experts,
                                         tcfg.d_model, tcfg.d_ff_expert)
    assert blocks["moe"]["router"].dtype == torch.float32
    assert blocks["attn"]["wq_b"].dtype == torch.bfloat16
    back = dict(tree_leaves(tparams))
    want = dict(tree_leaves(jtree))
    assert set(back) == set(want)
    for path, leaf in back.items():
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(want[path], np.float32),
                                      err_msg=path)
    bad = dict(jtree, blocks=dict(jtree["blocks"], extra=np.zeros(1)))
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(tcfg, bad)
