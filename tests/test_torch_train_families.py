"""The training forward and loss of the last four families on the CPU,
against the JAX package: reduced mamba2-780m (SSD), recurrentgemma-2b
(RG-LRU + local attention of window 32, the gemma embedding scale),
seamless-m4t-large-v2 (enc-dec: frames through the encoder, cross-
attention in the decoder) and llava-next-34b (an image prefix of 8
positions before the text).

Parameters are drawn with numpy from a seed (``seeded_params``), tokens and
the frontend inputs (standard normals rounded to bf16, as the engine's
``_synthetic_frontend`` draws them) with numpy too.  Where a test holds the
port to JAX "in fp32", both sides run the same bf16-drawn values cast to
fp32, and the enc-dec encoders run in fp32 (the port's follows its
parameters' dtype; ``fp32_encoders`` loops JAX's encoder blocks in fp32,
since JAX's ``encode`` casts its frames to bf16 whatever the parameters'
dtype).  Tolerances, each with
its reason:

* ``loss`` and every gradient leaf against ``jax.value_and_grad`` of JAX's
  ``loss`` (jitted once a module): fp32 |dloss| <= 1e-5 and 1e-5 relative
  L2 a leaf (the two frameworks differ only in the order of fp32 sums);
  bf16 |dloss| <= 1e-3 and 0.05 relative L2 a leaf (they round the bf16
  products of the forward and the backward at other points), as
  ``tests/test_torch_train.py`` holds qwen2-0.5b; 0.1 for seamless-m4t in
  bf16, whose two bf16 encoders part by ~1 bf16 ulp of their output
  (0.4 % relative L2) and the cross-attention carries that into every
  gradient (worst leaf 0.064 measured).  The cross-attention's key bias,
  whose gradient is zero in exact arithmetic, is held below 1e-6 (fp32)
  and 1e-3 (bf16) on both sides instead.  ``metrics["tokens"]``
  equals JAX's: B * (S - 1) positions, and B * S for the vlm, whose last
  image position is scored against label 0 by the reference's mask.
* Each package's bf16 gradients against its own fp32 ones: the port's
  median and worst leaf within 1.25x JAX's (seamless-m4t's bf16
  gradients sit ~6x further from fp32 than llava's in both packages).
* Two ``make_train_step`` steps (pjit; mapreduce with no group; pjit with
  two microbatches, every batch tensor split on dim 0), fp32 (the
  encoders too): the loss history within 1e-5 of JAX's.
* ``ssd_chunked``, which now multiplies out of place (``exp`` saves its
  output for the backward), gives the in-place version's outputs bit for
  bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.encdec import EncDecLM as JEncDecLM  # noqa: E402
from repro.models.registry import build_model as j_build  # noqa: E402
from repro.models.steps import make_train_step as j_train_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core.mapreduce import value_and_grad  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.steps import make_train_step  # noqa: E402
from test_torch_engine import seeded_params  # noqa: E402

ARCHS = ["mamba2-780m", "recurrentgemma-2b", "seamless-m4t-large-v2",
         "llava-next-34b"]
B, S, S_ENC = 2, 40, 24     # S: text tokens (mamba2's chunk is 32)
# the cross-attention's key bias adds q . bk to every key's score alike,
# which the softmax cancels: its gradient is zero in exact arithmetic, and
# roundoff (4e-9 in fp32, 6e-5 in bf16, against 0.02 for the query bias's)
ZERO_LEAVES = ("dec_blocks/cross_attn/bk",)
ZERO_GRAD = {True: 1e-6, False: 1e-3}
# the port's bf16 rounding may move its gradients from its fp32 ones by at
# most a quarter more than JAX's moves JAX's (measured: 0.90-1.08x)
BF16_GAP_RATIO = 1.25

from _torch_common import one_thread  # noqa: E402, F401


@functools.lru_cache(maxsize=None)
def _cfgs(arch):
    return reduced(get_arch(arch)), tconfigs.reduced(tconfigs.get_arch(arch))


@functools.lru_cache(maxsize=None)
def _params(arch, fp32):
    """(jax params, torch params): the same bf16-drawn values, both cast
    to fp32 when ``fp32``."""
    jcfg, tcfg = _cfgs(arch)
    jp = seeded_params(jcfg, 0)
    tp = params_from_numpy(tcfg, jax.device_get(jp))
    if fp32:
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = tree_map(lambda t: t.float(), tp)
    return jp, tp


def _jax_encode_fp32(self, params, frames, mesh=None):
    """JAX ``EncDecLM.encode`` (``encdec.py:73-90``) in fp32: the same
    blocks in the same order, looped instead of scanned, without the cast
    of the frames to bf16 (the scan's bf16 carry refuses fp32 layers)."""
    cfg = self.cfg
    freqs = j_layers.rope_freqs(cfg, cfg.head_dim_)
    x = frames.astype(jnp.float32)
    for i in range(cfg.n_enc_layers):
        p = jax.tree.map(lambda a: a[i], params["enc_blocks"])
        h = j_layers.apply_norm(cfg, p["ln1"], x)
        x = x + j_attention.full_attention_block(
            cfg, p["attn"], h, freqs, causal=False, q_block=cfg.attn_q_block)
        x = x + j_layers.apply_mlp(cfg, p["mlp"],
                                   j_layers.apply_norm(cfg, p["ln2"], x))
    return j_layers.apply_norm(cfg, params["enc_norm"], x)


@pytest.fixture
def fp32_encoders(monkeypatch):
    """JAX's enc-dec encoder in fp32 for the fp32 comparisons, as the
    port's runs on fp32 parameters: JAX's casts its frames to bf16 whatever
    the parameters' dtype, and the ~1 bf16 ulp by which the two bf16
    encoders part (``test_torch_encdec``) reaches every gradient through
    the cross-attention."""
    monkeypatch.setattr(JEncDecLM, "encode", _jax_encode_fp32)


def _batch(cfg, seed, n=B):
    """numpy tokens [n, S] and the arch's frontend input (bf16-rounded
    standard normals) under its model key."""
    rng = np.random.default_rng([seed, 31])
    out = {"tokens": rng.integers(0, cfg.vocab, (n, S)).astype(np.int32)}
    shape = (n, S_ENC, cfg.frontend_dim) if cfg.enc_dec else \
        (n, cfg.n_image_tokens, cfg.frontend_dim) if cfg.n_image_tokens \
        else None
    if shape:
        x = torch.from_numpy(rng.standard_normal(shape, np.float32))
        key = "frames" if cfg.enc_dec else "image_embeds"
        out[key] = x.bfloat16().float().numpy()
    return out


def _jax_batch(b):
    return {k: jnp.asarray(v) if k == "tokens"
            else jnp.asarray(v, jnp.bfloat16) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(v) if k == "tokens"
            else torch.from_numpy(v).bfloat16() for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, fp32):
    """JAX's loss and gradients, jitted once a module for each arch and
    dtype (traced at the first call: under ``fp32_encoders`` for fp32)."""
    jm = j_build(_cfgs(arch)[0])
    return jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b),
                                      has_aux=True))


def _np(tree):
    return {p: np.asarray(v, np.float32) for p, v in tree_leaves(tree)}


# ------------------------------------------------------------- loss / grads

@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, fp32, request):
    jcfg, tcfg = _cfgs(arch)
    if fp32:
        request.getfixturevalue("fp32_encoders")
    jp, tp = _params(arch, fp32)
    b = _batch(jcfg, 0)
    (jl, jaux), jg = _jax_value_and_grad(arch, fp32)(jp, _jax_batch(b))
    tl, taux, tg = value_and_grad(build_model(tcfg).loss, tp,
                                  _torch_batch(b))
    assert abs(tl.item() - float(jl)) <= (1e-5 if fp32 else 1e-3)
    assert float(taux["nll"]) == pytest.approx(float(jaux["nll"]),
                                               abs=1e-5 if fp32 else 1e-3)
    want_tokens = B * S if tcfg.n_image_tokens else B * (S - 1)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == want_tokens
    want = _np(jax.device_get(jg))
    got = dict(tree_leaves(tg))
    dtypes = {p: t.dtype for p, t in tree_leaves(tp)}
    assert set(got) == set(want)
    tol = 1e-5 if fp32 else 0.1 if tcfg.enc_dec else 0.05
    for p, g in got.items():
        g, w = g.float().numpy(), want[p]
        assert got[p].dtype == dtypes[p]
        if p in ZERO_LEAVES:
            assert max(np.linalg.norm(g), np.linalg.norm(w)) \
                < ZERO_GRAD[fp32], p
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= tol, (p, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gradients_as_close_to_fp32_as_jax(arch, request):
    """Each package's bf16 gradients against its own fp32 ones, per leaf
    (relative L2, the zero leaves left out): the port's median and worst
    leaf within ``BF16_GAP_RATIO`` of JAX's.  How far bf16 moves a
    family's gradients is the model's (seamless-m4t's ~6x llava's in both
    packages), and the port must not add to it."""
    jcfg, tcfg = _cfgs(arch)
    b = _batch(jcfg, 0)
    grads = {}
    for fp32 in (False, True):
        if fp32:
            request.getfixturevalue("fp32_encoders")
        jp, tp = _params(arch, fp32)
        jg = _jax_value_and_grad(arch, fp32)(jp, _jax_batch(b))[1]
        tg = value_and_grad(build_model(tcfg).loss, tp, _torch_batch(b))[2]
        grads[fp32] = (_np(jax.device_get(jg)),
                       {p: t.float().numpy() for p, t in tree_leaves(tg)})
    gaps = []
    for i in (0, 1):                                 # JAX, then the port
        low, high = grads[False][i], grads[True][i]
        rel = [np.linalg.norm(low[p] - w) / np.linalg.norm(w)
               for p, w in high.items() if p not in ZERO_LEAVES]
        gaps.append((np.median(rel), max(rel)))
    (j_med, j_worst), (t_med, t_worst) = gaps
    assert t_med <= BF16_GAP_RATIO * j_med, (t_med, j_med)
    assert t_worst <= BF16_GAP_RATIO * j_worst, (t_worst, j_worst)


def test_vlm_labels_score_the_last_image_position():
    """The reference's vlm mask: with the image positions' labels 0, the
    loss moves when the logit of token 0 at position n_img - 1 moves, and
    not when the logits of the earlier image positions move."""
    _, tcfg = _cfgs("llava-next-34b")
    _, tp = _params("llava-next-34b", True)
    model = build_model(tcfg)
    b = _torch_batch(_batch(tcfg, 2, n=1))
    n_img = tcfg.n_image_tokens
    hidden, _ = model.forward_hidden(tp, model._with_image(
        tp, model._embed(tp, b["tokens"]), b))
    base = model.loss(tp, b)[0]
    seen = []
    for pos in (0, n_img - 2, n_img - 1, n_img):
        def bumped(params, x, pos=pos):
            h = hidden.clone()
            h[:, pos] = h[:, pos] * 3.0
            return h, torch.zeros(())
        model.forward_hidden = bumped
        seen.append(abs(model.loss(tp, b)[0].item() - base.item()) > 1e-6)
        del model.forward_hidden
    assert seen == [False, False, True, True]


# ------------------------------------------------------------- train steps

@pytest.mark.parametrize("engine,n_micro", [("pjit", 1), ("mapreduce", 1),
                                            ("pjit", 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, engine, n_micro, fp32_encoders):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch, True)
    ocfg = dict(lr=1e-3, schedule="linear_warmup_cosine", warmup=1,
                total_steps=2)
    jo, to = joptim.OptConfig(**ocfg), toptim.OptConfig(**ocfg)
    mesh = make_host_mesh(data=1) if engine == "mapreduce" else None
    jstep = jax.jit(j_train_step(jcfg, mesh, jo, engine=engine,
                                 n_micro=n_micro))
    tstep = make_train_step(tcfg, to, engine=engine, n_micro=n_micro)
    js, ts = joptim.init_opt_state(jp, jo), toptim.init_opt_state(tp, to)
    jl, tl = [], []
    for seed in (5, 6):
        b = _batch(jcfg, seed)
        jp, js, jm = jstep(jp, js, _jax_batch(b))
        tp, ts, tm = tstep(tp, ts, _torch_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_train_cli_names_the_missing_frontend_input(arch):
    """``launch/train.py`` feeds tokens alone, as JAX's CLI: an arch that
    also takes frames or image embeddings is refused up front."""
    need = "frames" if arch.startswith("seamless") else "image_embeds"
    with pytest.raises(ValueError, match=f"{need}.*make_train_step"):
        train_main(["--device", "cpu", "--reduced", "--arch", arch,
                    "--steps", "1"])


# ------------------------------------------------------------------- SSD

def _ssd_chunked_in_place(xd, dtA, B, C, chunk, init_state=None):
    """``ssm.ssd_chunked`` as it was before its products went out of place
    (``L.mul_``, ``y +=``): the serving paths' bits to keep."""
    b, s, h, p = xd.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    c = (s + pad) // Q
    xf = xd.reshape(b, c, Q, h, p).float()
    dtA = dtA.reshape(b, c, Q, h).permute(0, 3, 1, 2)
    Bc = B.reshape(b, c, Q, n).float()
    Cc = C.reshape(b, c, Q, n).float()
    A_cs = torch.cumsum(dtA, -1)
    L = torch.exp(ssm.segsum(dtA))
    L.mul_(torch.einsum("bcqn,bckn->bcqk", Cc, Bc)[:, None])
    y = torch.einsum("bhcqk,bckhp->bcqhp", L, xf)
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)
    states = torch.einsum(
        "bckn,bckhp->bchpn", Bc,
        xf * decay_states.permute(0, 2, 3, 1)[..., None])
    chunk_decay = torch.exp(A_cs[..., -1])
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32)
             if init_state is None else init_state.float())
    prev = []
    for i in range(c):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, i, None, None] + states[:, i]
    prev = torch.stack(prev, 1)
    state_decay = torch.exp(A_cs).permute(0, 2, 3, 1)[..., None]
    y += torch.einsum("bcqn,bchpn->bcqhp", Cc, prev) * state_decay
    y = y.to(xd.dtype).reshape(b, c * Q, h, p)
    return y[:, :s], carry


@pytest.mark.parametrize("s,with_init,dtype", [
    (45, False, torch.bfloat16), (64, True, torch.bfloat16),
    (7, True, torch.float32), (100, False, torch.float32)])
def test_ssd_chunked_out_of_place_is_bit_equal(s, with_init, dtype):
    """Chunk 16; bf16 inputs as the serving prefill gives them, fp32 as
    the fp32 tests do; the out-of-place version also differentiates."""
    g = torch.Generator().manual_seed(s)
    b, h, p, n = 2, 3, 8, 16
    xd = torch.randn((b, s, h, p), generator=g).to(dtype)
    dtA = -torch.rand((b, s, h), generator=g) * 1.5 - 0.05
    Bm, Cm = (torch.randn((b, s, n), generator=g).to(dtype)
              for _ in range(2))
    s0 = torch.randn((b, h, p, n), generator=g) if with_init else None
    with torch.no_grad():
        got = ssm.ssd_chunked(xd, dtA, Bm, Cm, 16, s0)
        want = _ssd_chunked_in_place(xd, dtA, Bm, Cm, 16, s0)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    leaves = [t.float().requires_grad_(True) for t in (xd, dtA, Bm, Cm)]
    y, fin = ssm.ssd_chunked(*leaves, 16, s0)
    grads = torch.autograd.grad(y.sum() + fin.sum(), leaves)
    assert all(bool(torch.isfinite(t).all()) for t in grads)

