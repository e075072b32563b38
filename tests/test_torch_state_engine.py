"""The state-slot families served on the CPU: reduced mamba2-780m (SSD)
and recurrentgemma-2b (RG-LRU + a local-attention ring of window 32) through
the port's continuous-batching engine over a ``StateSlotPool``.

1. ``StateSlotPool`` invariants (claim, release, checkpoint, restore, the
   JAX test's assertions), its byte count, and its scrub and poison rows.
2. The engine against the port's own ``generate_static(batch_size=1)``,
   token for token (bucketed, length-masked prefill; prompts of 2 to 40
   tokens, two past the window; decoding past the ring's wrap), the
   CLI's ``--verify`` included; ``pump()`` equal to ``step()``.
3. Checkpoint-on-preempt: a mid-decode preemption snapshots the slot,
   the scheduler's ``restore`` action writes it back (into the slot it
   left, or, with two requests preempted at once, into each other's
   slots), ``engine.state_restores`` counts it, the tokens still equal the
   baseline, and every slot is released after the drain.
4. The prefix cache is refused with a warning and the engine serves
   uncached; a NaN poison of one state row quarantines only its request.
5. The port's engine against the JAX engine on the same numpy-drawn
   parameters: tokens equal, or each request's streams part first at a
   position where JAX's top-two margin lies within twice the observed
   logit error; and the dual gate along the port's tokens against the JAX
   model's static path (max |dlogit| <= 0.25, no greedy mismatch where the
   JAX margin exceeds twice the observed error).  The JAX engine and its
   replays run once a module, at these reduced sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serving import (Engine, FaultPlan,  # noqa: E402
                                 StateSlotPool, dual_gate, generate_static,
                                 replay_logits)
from test_torch_engine import seeded_params  # noqa: E402
from test_torch_window_engine import _jax_static_logits  # noqa: E402

TOL = 0.25
ARCHS = ["mamba2-780m", "recurrentgemma-2b"]
SCFG = dict(page_size=8, max_slots=3, max_len=80)
# 40 and 35 > the window of 32: their prefills wrap the ring; two prefill
# buckets (8, 64) keep the JAX engine's compiles few
LENS = (5, 40, 7, 2, 35)
BUDGETS = (12, 10, 8, 6, 9)


from _torch_common import one_thread  # noqa: E402, F401


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """Both frameworks on one arch: configs, parameters, prompts, the port's
    static baseline and the JAX engine's tokens (run once a module)."""
    jcfg = reduced(get_arch(request.param))
    tcfg = tconfigs.reduced(tconfigs.get_arch(request.param))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, tcfg.vocab, size=n).tolist() for n in LENS]
    with torch.no_grad():
        base, _ = generate_static(tcfg, tparams, prompts, list(BUDGETS),
                                  tconfigs.ServeConfig(**SCFG))
    jeng = JEngine(jcfg, JServeConfig(**SCFG), jparams)
    jtokens = [r.tokens for r in jeng.run_offline(prompts,
                                                  list(BUDGETS))[0]]
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                prompts=prompts, base=base, jtokens=jtokens)


def _engine(a, **kw):
    return Engine(a["tcfg"], tconfigs.ServeConfig(**{**SCFG, **kw}),
                  a["tparams"], device="cpu")


def _leak_free(eng):
    return (eng.pool.num_allocated == 0 and eng.pool.conservation_ok()
            and all(s is None for s in eng.sched.slots)
            and eng.states.num_claimed == 0)


# ------------------------------------------------------------ the pool

def test_state_slot_pool_claim_release_invariants():
    cfg = tconfigs.reduced(tconfigs.get_arch("recurrentgemma-2b"))
    pool = StateSlotPool(cfg, tconfigs.ServeConfig(page_size=8, max_slots=3,
                                                   max_len=32))
    pool.claim(0)
    pool.claim(2)
    assert pool.num_claimed == 2 and pool.claimed == {0, 2}
    with pytest.raises(AssertionError):
        pool.claim(0)                     # double claim
    with pytest.raises(AssertionError):
        pool.release(1)                   # release of unclaimed
    with pytest.raises(AssertionError):
        pool.checkpoint(1)                # checkpoint of unclaimed
    leaves = [leaf for _, leaf in tree_leaves(pool.state)]
    assert pool.slot_nbytes == sum(x.numel() * x.element_size()
                                   for x in leaves) // 3
    for x in leaves:
        x[:, 0] = torch.arange(x[:, 0].numel()).reshape(x[:, 0].shape)
    snap = pool.checkpoint(0)
    assert all(s.device.type == "cpu" for _, s in tree_leaves(snap))
    pool.release(0)
    pool.scrub(0)                         # the snapshot is a copy
    assert all(not x[:, 0].any() for x in leaves)
    pool.restore(2, snap)                 # into another slot
    assert all(torch.equal(x[:, 2], s) for x, (_, s) in
               zip(leaves, tree_leaves(snap)))
    pool.poison(2)
    assert all(x[:, 2].isnan().all() for x in leaves)
    assert not any(x[:, 1].isnan().any() for x in leaves)
    pool.release(2)
    assert pool.num_claimed == 0
    assert pool.metrics.value("states.checkpoints") == 1
    assert pool.metrics.value("states.restores") == 1


# ------------------------------------------------- engine = static baseline

def test_engine_matches_static_baseline(arch):
    eng = _engine(arch)
    with torch.no_grad():
        results, m = eng.run_offline(arch["prompts"], list(BUDGETS))
    assert [r.tokens for r in results] == arch["base"]
    assert m["new_tokens"] == sum(BUDGETS) and m["state_restores"] == 0
    assert _leak_free(eng)


def test_pump_equals_step(arch):
    eng = _engine(arch)
    with torch.no_grad():
        results, _ = eng.run_offline(arch["prompts"], list(BUDGETS),
                                     overlap=True)
    assert [r.tokens for r in results] == arch["base"]
    staged = eng.metrics.value("engine.overlap_staged")
    assert staged > 0 and eng.metrics.value("engine.overlap_used") \
        + eng.metrics.value("engine.overlap_dropped") == staged
    assert _leak_free(eng)


@pytest.mark.parametrize("swap", [False, True], ids=["same", "swapped"])
def test_checkpoint_restore_mid_decode(arch, swap):
    """alloc -> checkpoint-on-preempt -> restore -> free, at two slots for
    five requests.  ``same``: one mid-decode preemption (the JAX test's),
    restored into the slot it left.  ``swapped``: slot 0's request, then
    slot 1's, preempted at once, so each is restored into the other's
    slot.  Earlier tokens survive the checkpoint, every request's tokens
    equal the baseline's, and every slot is released after the drain."""
    eng = _engine(arch, max_slots=2)
    steps, victims = 0, {}
    with torch.no_grad():
        for p, b in zip(arch["prompts"], BUDGETS):
            eng.add_request(p, b)
        while eng.step():
            steps += 1
            active = eng.sched.active_slots()
            assert eng.states.claimed == set(active)   # one slot a request
            if steps == 4 and not victims:
                assert len(active) == 2
                for i in (active if swap else active[-1:]):
                    req = eng.sched.slots[i].req
                    before = list(req.generated)
                    assert eng.sched.preempt(i) is req
                    assert req.checkpoint is not None \
                        and req.generated == before
                    victims[req.rid] = i
            for i in eng.sched.active_slots():
                rid = eng.sched.slots[i].req.rid
                if rid in victims and steps > 4:
                    assert (i != victims[rid]) == swap, (rid, i)
            assert steps < 500
        results = sorted(eng.collect(), key=lambda r: r.rid)
    assert eng._restores == len(victims) == (2 if swap else 1)
    assert eng.metrics.value("states.checkpoints") == len(victims)
    assert sum(r.n_preemptions for r in results) == len(victims)
    assert [r.tokens for r in results] == arch["base"]
    assert _leak_free(eng)


def test_prefix_cache_warns_and_serves_uncached(arch, capsys):
    eng = _engine(arch, prefix_cache=True)
    assert "prefix cache disabled" in capsys.readouterr().out
    assert eng.radix is None
    with torch.no_grad():
        results, m = eng.run_offline(arch["prompts"], list(BUDGETS))
    assert m["cached_tokens"] == 0
    assert [r.tokens for r in results] == arch["base"]


def test_poisoned_state_row_is_confined_to_its_request(arch):
    """A NaN poison of request 1's state row before its third decode: its
    finite flag comes back False, it ends with ``nan_logits`` after two
    tokens, every other request's tokens equal the baseline's, and the
    scrubbed row is finite again."""
    plan = FaultPlan.parse("nan_logits:rid=1,at=2")
    eng = Engine(arch["tcfg"], tconfigs.ServeConfig(**SCFG), arch["tparams"],
                 device="cpu", faults=plan)
    with torch.no_grad():
        results, _ = eng.run_offline(arch["prompts"], list(BUDGETS))
    assert plan.unfired() == []
    assert results[1].error == "nan_logits" and len(results[1].tokens) == 2
    assert results[1].tokens == arch["base"][1][:2]
    assert [r.tokens for i, r in enumerate(results) if i != 1] \
        == [t for i, t in enumerate(arch["base"]) if i != 1]
    assert eng.metrics.value("engine.quarantined") == 1
    assert all(not leaf.isnan().any() for _, leaf in
               tree_leaves(eng.states.state))
    assert _leak_free(eng)


def test_cli_verify(arch, capsys):
    tokens = tserve.main(["--device", "cpu", "--arch", arch["tcfg"].name,
                          "--reduced", "--requests", "4", "--mixed",
                          "--prompt-len", "40", "--gen", "6", "--verify"])
    assert len(tokens) == 4
    out = capsys.readouterr().out
    assert "verify OK: 4 requests" in out and "state slots" in out


# ------------------------------------------------------------ against JAX

def test_engine_matches_jax_engine(arch):
    """The port's engine tokens against the JAX engine's, and the dual gate
    along the port's tokens of the 40-token prompt (past the window) and
    the 7-token one against the JAX static path."""
    jcfg, tcfg = arch["jcfg"], arch["tcfg"]
    tokens, jtokens = arch["base"], arch["jtokens"]
    pick = [1, 2]
    ref = [_jax_static_logits(jcfg, arch["jparams"], arch["prompts"][i],
                              tokens[i], SCFG["max_len"]) for i in pick]
    with torch.no_grad():
        test = [replay_logits(tcfg, tconfigs.ServeConfig(**SCFG),
                              arch["tparams"], arch["prompts"][i], tokens[i])
                for i in pick]
    assert all((t.argmax(-1) == np.asarray(tokens[i])).all()
               for t, i in zip(test, pick))           # replay fidelity
    rep = dual_gate(ref, test, [tokens[i] for i in pick], tol=TOL)
    assert rep["ok"], {k: v for k, v in rep.items() if k != "per_request"}
    for p, t, jt in zip(arch["prompts"], tokens, jtokens):
        if t == jt:
            continue
        # a parting: replayed along the port's tokens up to it, the JAX
        # top two at the parting lie within twice the observed error
        d = next(i for i, (a, b) in enumerate(zip(t, jt)) if a != b)
        jl = _jax_static_logits(jcfg, arch["jparams"], p, t[:d + 1],
                                SCFG["max_len"])
        with torch.no_grad():
            tl = replay_logits(tcfg, tconfigs.ServeConfig(**SCFG),
                               arch["tparams"], p, t[:d + 1])
        r = dual_gate([jl], [tl], [t[:d + 1]], tol=TOL)
        assert r["ok"] and jl[d].argmax() == jt[d], (d, r["max_logit_err"])
