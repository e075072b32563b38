"""Fault injection, recovery and overload control in the port, on the CPU
(reference backend, reduced qwen2-0.5b), against the JAX package's.

The contract is **exact-survivor recovery**: whatever fault is injected
(poisoned pages, raised step errors, page-pool pressure, client
disconnects), the engine quarantines only the offending request — failed
terminally, pages scrubbed and released, trace closed — while every other
request's tokens stay identical to a fault-free run.  On top of that:

* cancel mid-prefill releases the unpublished page tail;
* admission control sheds at the door with a backoff hint and evicts
  expired requests (queued and live); its estimates equal the JAX
  controller's on the same observations;
* the health state machine, a draining engine shedding new work, and the
  watchdog failing pending streams when the pipeline stalls;
* an HTTP client disconnect mid-stream leaves the other streams exact;
* ``launch.serve --overlap --inject ... --verify`` passes;
* across frameworks: the JAX engine and the port under the same
  ``FaultPlan`` on the same weights give the same failure reason for each
  request and the same survivor tokens;
* a poison on an int8 pool (carried by its bf16 scale pages) flips only
  its target row's finite flag.

Every await is bounded by ``asyncio.wait_for`` (10 s); the watchdog test
uses sub-second settings.
"""
import asyncio
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.serving import AdmissionController as JAdmission  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import FaultPlan as JFaultPlan  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve_http import HttpFrontend, _sse_client  # noqa: E402,E501
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (AdmissionController, Engine,  # noqa: E402
                                 FaultPlan, HealthState, ServingLoop,
                                 generate_static, stream_request,
                                 validate_trace)

from test_torch_engine import seeded_params  # noqa: E402

WAIT_S = 10.0


from _torch_common import one_thread  # noqa: E402, F401


@pytest.fixture(scope="module")
def setup():
    jcfg = reduced(get_arch("qwen2-0.5b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("qwen2-0.5b"))
    jparams = seeded_params(jcfg, 0)
    tparams = params_from_numpy(tcfg, jax.device_get(jparams))
    return jcfg, tcfg, jparams, tparams


def _prompts(cfg, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab, size=n).tolist() for n in lens]


def _scfg(**kw):
    return tconfigs.ServeConfig(**{"page_size": 8, "max_slots": 4,
                                   "max_len": 48, **kw})


def _check_survivors(results, ref, targeted):
    """targeted: rid -> expected error substring."""
    for r in results:
        if r.rid in targeted:
            assert r.failed and targeted[r.rid] in r.error, (r.rid, r.error)
            # partial output is a prefix of the clean run
            assert r.tokens == ref[r.rid][:len(r.tokens)], r.rid
        else:
            assert not r.failed, (r.rid, r.error)
            assert r.tokens == ref[r.rid], r.rid


# ------------------------------------------------- quarantine per fault kind

FAULT_CASES = [
    # spec, engine config, prompt lengths, budgets, targeted rid -> error
    ("nan_logits:rid=2,at=2", {}, [6, 14, 9, 20], [8, 6, 8, 5],
     {2: "nan_logits"}),
    ("step_error:rid=0,at=3", {}, [6, 14, 9, 20], [8, 6, 8, 5],
     {0: "step_error"}),
    ("client_disconnect:rid=1,at=2", {}, [6, 14, 9], [8, 8, 8],
     {1: "cancelled"}),
    ("pool_pressure:at=3,pages=4,steps=4",
     dict(max_slots=3, max_len=32, num_pages=9), [7, 15, 9, 12],
     [9, 8, 10, 7], {}),
    ("nan_logits:rid=1,at=3", dict(kv_dtype="int8"), [6, 14, 9, 20],
     [8, 6, 8, 5], {1: "nan_logits"}),
]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("spec,kw,lens,budgets,targeted", FAULT_CASES,
                         ids=[c[0].split(":")[0] + ("-int8" if c[1].get(
                             "kv_dtype") else "") for c in FAULT_CASES])
def test_fault_quarantines_only_its_target(setup, spec, kw, lens, budgets,
                                           targeted, overlap):
    _, tcfg, _, tparams = setup
    scfg = _scfg(**kw)
    prompts = _prompts(tcfg, lens, seed=1)
    plan = FaultPlan.parse(spec)
    with torch.no_grad():
        eng = Engine(tcfg, scfg, tparams, device="cpu", faults=plan)
        results, _ = eng.run_offline(prompts, budgets, overlap=overlap)
        clean = Engine(tcfg, scfg, tparams, device="cpu")
        ref = [r.tokens for r in clean.run_offline(prompts, budgets)[0]]
        if scfg.kv_dtype == "bf16":
            assert ref == generate_static(tcfg, tparams, prompts, budgets,
                                          scfg)[0]
    assert plan.unfired() == []
    _check_survivors(results, ref, targeted)
    kind = spec.split(":")[0]
    assert eng.metrics.get("engine.faults_injected").labels(
        kind=kind).value == 1
    n_quarantined = sum(k in ("nan_logits", "step_error")
                        for k in targeted.values())
    assert eng.metrics.value("engine.quarantined") == n_quarantined
    if kind == "nan_logits":
        # the poisoned request produced exactly ``at`` tokens, and its
        # pages were scrubbed before returning to the free list
        rid = next(iter(targeted))
        assert len(results[rid].tokens) == int(spec.split("at=")[1])
        assert eng.metrics.value("pool.pages_scrubbed") >= 1
    if kind == "pool_pressure":
        assert sum(r.n_preemptions for r in results) > 0
    assert eng.pool.num_allocated == 0 and eng.pool.conservation_ok()
    assert validate_trace(eng.tracer.to_dict()) == []


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_poisoned_page_flips_only_its_own_row(setup, kv_dtype):
    """A NaN poison of one slot's newest page (its K/V, or for int8 pages
    its bf16 scales: int8 cannot hold NaN) reaches that row's logits and no
    other row's; the row is quarantined and its pages zeroed."""
    _, tcfg, _, tparams = setup
    prompts = _prompts(tcfg, [8, 20, 13, 30], seed=3)
    with torch.no_grad():
        eng = Engine(tcfg, _scfg(kv_dtype=kv_dtype), tparams, device="cpu")
        for p in prompts:
            eng.add_request(p, 8)
        while eng.sched.queue or len(eng.sched.decode_ready()) < 4:
            assert eng.step()
        page = eng.sched.slots[2].pages[-1]
        eng.poison_slot(2)
        leaves = [leaf for leaf in _leaves(eng.pool.kv)
                  if leaf.is_floating_point()]
        assert all(leaf[:, page].isnan().all() for leaf in leaves)
        pending = eng._dispatch_next()
        assert pending.kind == "decode"
        ok = pending.out_dev[1].tolist()
        eng._finish_step(pending)
    assert ok == [True, True, False, True]
    assert eng.sched.slots[2] is None
    assert not any(leaf[:, page].isnan().any()
                   for leaf in _leaves(eng.pool.kv))     # scrubbed


def _leaves(kv):
    from repro_torch.models.params import tree_leaves
    return [leaf for _, leaf in tree_leaves(kv)]


def test_fault_plan_parse_rejects_bad_specs():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultPlan.parse("frobnicate:rid=1")
    with pytest.raises(ValueError, match="unknown fault field"):
        FaultPlan.parse("nan_logits:rid=1,bogus=2")
    with pytest.raises(ValueError, match="at >= 1"):
        FaultPlan.parse("nan_logits:rid=1,at=0")
    with pytest.raises(ValueError, match="empty fault plan"):
        FaultPlan.parse(" ; ")
    plan = FaultPlan.parse("detok_stall:at=2,stall_s=0.5;"
                           "pool_pressure:at=1,pages=3,steps=2")
    assert plan.unfired() == ["detok_stall:at=2,stall_s=0.5",
                              "pool_pressure:at=1,pages=3,steps=2"]


def test_cancel_mid_prefill_releases_unpublished_tail(setup):
    _, tcfg, _, tparams = setup
    eng = Engine(tcfg, _scfg(max_slots=2, max_len=64,
                             prefill_chunk_tokens=8), tparams, device="cpu")
    with torch.no_grad():
        rid = eng.add_request(_prompts(tcfg, [30], seed=5)[0], 8)
        assert eng.step()                           # first chunk only
        assert eng.pool.num_allocated > 0           # mid-prefill, holding
        eng.cancel(rid)
        for _ in range(8):
            if not eng.step():
                break
    (res,) = eng.collect()
    assert res.failed and "cancelled" in res.error
    assert eng.pool.num_allocated == 0 and eng.pool.conservation_ok()
    assert (eng.metrics.value("pool.pages_allocated")
            == eng.metrics.value("pool.pages_released"))
    assert validate_trace(eng.tracer.to_dict()) == []


# -------------------------------------------------- deadlines and admission

def _adm_engine(tparams, tcfg):
    return Engine(tcfg, _scfg(max_slots=2, admission_control=True), tparams,
                  device="cpu")


def test_admission_sheds_hopeless_deadline_with_backoff_hint(setup):
    _, tcfg, _, tparams = setup
    eng = _adm_engine(tparams, tcfg)
    p = _prompts(tcfg, [6], seed=6)[0]
    rid = eng.add_request(p, 4, deadline_s=1e-6)    # < step-time prior
    (res,) = eng.collect()
    assert res.rid == rid and res.failed
    assert "shed" in res.error and "overloaded" in res.error
    assert res.retry_after_s > 0 and res.tokens == []
    assert eng.metrics.get("admission.shed").labels(
        reason="overloaded").value == 1
    # requests without a deadline are never shed by the estimator
    with torch.no_grad():
        eng.add_request(p, 4)
        results, _ = eng.run_offline([], [])
    assert eng.metrics.value("engine.deadline_evictions") == 0


def test_deadline_eviction_queued_and_live(setup):
    _, tcfg, _, tparams = setup
    eng = _adm_engine(tparams, tcfg)
    prompts = _prompts(tcfg, [6, 9, 7], seed=7)
    with torch.no_grad():
        for p in prompts:                           # the third queues
            eng.add_request(p, 12, deadline_s=120.0)
        eng.step()
        # expire one queued and one bound request deterministically
        past = time.perf_counter() - 1.0
        assert eng.sched.queue
        eng.sched.queue[-1].deadline = past
        next(s for s in eng.sched.slots if s is not None).req.deadline = past
        while eng.step():
            pass
    results = eng.collect()
    expired = [r for r in results
               if r.failed and "deadline_exceeded" in r.error]
    assert len(expired) == 2                        # one queued + one live
    assert eng.metrics.value("engine.deadline_evictions") == 2
    assert eng.pool.num_allocated == 0 and eng.pool.conservation_ok()
    assert validate_trace(eng.tracer.to_dict()) == []


def test_admission_controller_matches_jax():
    """The same observations into the port's and the JAX controller give
    the same estimates, verdicts and (seeded) backoff hints."""
    rng = np.random.RandomState(0)
    ours, theirs = (cls(max_slots=4, step_s_prior=0.05, seed=3)
                    for cls in (AdmissionController, JAdmission))
    assert ours.estimate_queue_wait(0) == 0.0 and ours.check(0) is None
    assert ours.check(0, deadline_s=1e-6) == "overloaded"
    for _ in range(12):
        step, ttft, service = rng.uniform(0.01, 0.2), *rng.uniform(0.1, 2, 2)
        for adm in (ours, theirs):
            adm.observe_step(step)
            adm.observe_result(ttft_s=ttft, service_s=service)
        for depth in (0, 1, 4, 5, 9):
            assert ours.estimate_queue_wait(depth) \
                == theirs.estimate_queue_wait(depth)
            for dl in (None, 0.5, 3.0):
                assert ours.check(depth, deadline_s=dl, ttft_deadline_s=dl) \
                    == theirs.check(depth, deadline_s=dl, ttft_deadline_s=dl)
            assert ours.retry_after_s(depth) == theirs.retry_after_s(depth)
    fresh = AdmissionController(max_slots=4)
    for _ in range(8):
        fresh.observe_result(ttft_s=0.1, service_s=1.0)
    assert fresh.estimate_queue_wait(4) == pytest.approx(1.0)
    assert fresh.estimate_queue_wait(5) == pytest.approx(2.0)
    assert fresh.check(5, deadline_s=10.0) is None
    assert fresh.check(5, deadline_s=2.5) == "overloaded"
    assert 0.05 <= fresh.retry_after_s(5) <= 45.0


# ----------------------------------------------------- health state machine

def test_health_state_machine_transitions():
    h = HealthState()
    assert h.state == "starting" and h.accepting
    assert h.mark_healthy() and not h.mark_healthy()
    assert h.begin_drain()
    assert not h.mark_healthy()                     # no way back
    assert h.draining and not h.accepting
    assert h.mark_drained()
    assert h.history == ["starting", "healthy", "draining", "drained"]
    assert not h.mark_degraded("too late")          # terminal
    d = h.to_dict()
    assert d["state"] == "drained" and d["ok"] is False


def test_draining_engine_sheds_new_requests(setup):
    _, tcfg, _, tparams = setup
    eng = _adm_engine(tparams, tcfg)
    eng.health.mark_healthy()
    eng.health.begin_drain()
    eng.add_request(_prompts(tcfg, [5], seed=8)[0], 4)
    (res,) = eng.collect()
    assert res.failed and "draining" in res.error and res.retry_after_s > 0
    assert eng.metrics.get("admission.shed").labels(
        reason="draining").value == 1


# ------------------------------------------------ watchdog via detok stall

def test_watchdog_fails_pending_streams_on_stalled_pipeline(setup):
    """A detok_stall fault wedges the bounded event queue; the watchdog
    fails the pending stream with a terminal error instead of letting the
    client hang, and marks the server degraded."""
    _, tcfg, _, tparams = setup
    plan = FaultPlan.parse("detok_stall:at=2,stall_s=1.0")
    eng = Engine(tcfg, _scfg(max_slots=2), tparams, device="cpu",
                 faults=plan)

    async def main():
        serving = ServingLoop(eng, overlap=True, collect_queue_size=1,
                              watchdog_s=0.3)
        await serving.start()
        try:
            return await asyncio.wait_for(stream_request(
                serving, _prompts(tcfg, [6], seed=9)[0], 16,
                timeout_s=WAIT_S), WAIT_S)
        finally:
            await asyncio.wait_for(serving.stop(), WAIT_S)

    events = asyncio.run(main())
    assert plan.unfired() == []
    final = events[-1]
    assert final["type"] == "error" and "watchdog" in final["error"]
    assert eng.metrics.value("server.watchdog_trips") == 1
    assert eng.health.state == "degraded"


# --------------------------------------------- HTTP disconnect mid-stream

def test_http_client_disconnect_survivors_byte_exact(setup):
    _, tcfg, _, tparams = setup
    scfg = _scfg(max_slots=3)
    eng = Engine(tcfg, scfg, tparams, device="cpu")
    prompts = _prompts(tcfg, [6, 13, 9], seed=10)
    budgets = [6, 24, 8]                            # rid 1 drops early

    async def main():
        serving = ServingLoop(eng, overlap=True)
        frontend = HttpFrontend(serving)
        await serving.start()
        server = await asyncio.start_server(frontend.handle, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        try:
            outs = await asyncio.wait_for(asyncio.gather(
                _sse_client("127.0.0.1", port, prompts[0], budgets[0]),
                _sse_client("127.0.0.1", port, prompts[1], budgets[1],
                            disconnect_after=2),
                _sse_client("127.0.0.1", port, prompts[2], budgets[2]),
            ), WAIT_S)
            # wait for the engine to notice the dead socket and drain
            deadline = time.monotonic() + WAIT_S
            while (eng.sched.has_work() or not serving._submit.empty()) \
                    and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
        finally:
            server.close()
            await asyncio.wait_for(server.wait_closed(), WAIT_S)
            await asyncio.wait_for(serving.stop(), WAIT_S)
        return outs

    outs = asyncio.run(main())
    with torch.no_grad():
        ref = generate_static(tcfg, tparams, prompts, budgets, scfg)[0]
    for i in (0, 2):
        assert outs[i]["final"]["type"] == "done"
        assert outs[i]["streamed"] == ref[i], f"survivor {i} diverged"
    assert outs[1]["streamed"] == ref[1][:len(outs[1]["streamed"])]
    assert eng.metrics.value("engine.cancelled") == 1
    assert eng.pool.num_allocated == 0 and eng.pool.conservation_ok()
    assert validate_trace(eng.tracer.to_dict()) == []


@pytest.mark.parametrize("extra,spec,verdict", [
    ([], "nan_logits:rid=1,at=2;step_error:rid=5,at=2;"
         "client_disconnect:rid=4,at=1",
     "3 survivors identical to the fault-free static baseline"),
    # int8 pages: survivors held to a fault-free engine run, and under pool
    # pressure (preemption replays) to the reference replay's dual gate
    (["--kv-dtype", "int8"], "pool_pressure:at=2,pages=8,steps=3;"
     "nan_logits:rid=1,at=2", "5 survivors held to a fault-free engine run"),
])
def test_cli_overlap_inject_verify(capsys, extra, spec, verdict):
    tserve.main(["--device", "cpu", "--reduced", "--requests", "6",
                 "--mixed", "--gen", "8", "--overlap", "--inject", spec,
                 "--verify", *extra])
    out = capsys.readouterr().out
    n = spec.count(":")
    assert f"{n}/{n} planned faults fired" in out
    assert f"chaos verify OK: {verdict}" in out


# --------------------------------------------------------- across frameworks

def test_fault_outcomes_match_jax_engine(setup):
    """The JAX engine and the port under the same fault plan, on the same
    weights and prompts: the same terminal reason for every request and
    the same tokens, survivors and partial targets alike."""
    jcfg, tcfg, jparams, tparams = setup
    kw = dict(page_size=8, max_slots=4, max_len=48)
    spec = ("nan_logits:rid=2,at=2;step_error:rid=0,at=3;"
            "client_disconnect:rid=4,at=2")
    prompts = _prompts(tcfg, [6, 14, 9, 20, 11], seed=2)
    budgets = [8, 6, 8, 5, 7]
    jres = JEngine(jcfg, JServeConfig(**kw), jparams,
                   faults=JFaultPlan.parse(spec)).run_offline(
        prompts, budgets, overlap=True)[0]
    with torch.no_grad():
        tres = Engine(tcfg, tconfigs.ServeConfig(**kw), tparams,
                      device="cpu", faults=FaultPlan.parse(spec)).run_offline(
            prompts, budgets, overlap=True)[0]
    assert [r.error for r in tres] == [r.error for r in jres] \
        == ["step_error", "", "nan_logits", "", "cancelled"]
    assert [r.tokens for r in tres] == [r.tokens for r in jres]
