"""The port's overlapped pipeline and streaming front end on the CPU
(reference backend, reduced qwen2-0.5b), against the JAX package's.

* ``run_offline(overlap=True)`` (``Engine.pump()``) is token-exact against
  ``step()`` and ``generate_static``, with staged plans used and every plan
  accounted for (used + dropped == staged), also under preemption churn;
* ``ServingLoop`` streams every token exactly once, in order, token-exact
  against the static baseline; rejection and cancellation arrive as
  terminal error events; traces with rejected requests validate clean;
* ``launch.trace_report`` over the port's traces: phase sums cover the
  wall clock, the host pipeline's spans are summed, ``--validate`` passes;
* ``launch.serve_http --device cpu --reduced --smoke 3`` exits 0, and asks
  for a card unless given ``--device cpu``;
* across frameworks: the JAX ``Engine.pump()`` and ``ServingLoop`` and the
  port's, on the same numpy-drawn weights and prompts, give the same
  tokens, exactly (at these shapes the dual gate's exact case: the logits
  of the same engine config are held to the JAX replay's by
  ``tests/test_torch_engine.py``).

Every await on a stream, queue or server is bounded by ``asyncio.wait_for``
(10 s), so a hang fails one test instead of the suite.
"""
import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_arch, reduced  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import ServingLoop as JServingLoop  # noqa: E402
from repro.serving import stream_request as j_stream_request  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve_http, trace_report  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (Engine, ServingLoop,  # noqa: E402
                                 generate_static, stream_request,
                                 validate_trace)
from repro_torch.serving.telemetry import ENGINE_PID, HOST_TID  # noqa: E402

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


def _static(tcfg, tparams, prompts, budgets, scfg):
    with torch.no_grad():
        return generate_static(tcfg, tparams, prompts, budgets, scfg)[0]


def _stream_all(serving, prompts, budgets):
    async def main():
        await serving.start()
        try:
            return await asyncio.wait_for(asyncio.gather(*[
                stream_request(serving, p, g, timeout_s=WAIT_S)
                for p, g in zip(prompts, budgets)]), WAIT_S)
        finally:
            await asyncio.wait_for(serving.stop(), WAIT_S)
    return asyncio.run(main())


# ------------------------------------------------------- overlapped pipeline

def test_overlap_run_offline_token_exact_and_staging_used(setup):
    _, tcfg, _, tparams = setup
    scfg = _scfg()
    prompts = _prompts(tcfg, [3, 30, 11, 7, 22, 15], seed=6)
    budgets = [6, 4, 8, 5, 7, 3]
    with torch.no_grad():
        sync = Engine(tcfg, scfg, tparams, device="cpu").run_offline(
            prompts, budgets)[0]
        eng = Engine(tcfg, scfg, tparams, device="cpu")
        results, _ = eng.run_offline(prompts, budgets, overlap=True)
    ref = _static(tcfg, tparams, prompts, budgets, scfg)
    assert [r.tokens for r in results] == ref == [r.tokens for r in sync]
    staged, used, dropped = (eng.metrics.value(f"engine.overlap_{k}")
                             for k in ("staged", "used", "dropped"))
    assert staged > 0 and used > 0            # the pipeline really staged
    assert used + dropped == staged           # every plan accounted for
    trace = eng.tracer.to_dict()
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("pid") == ENGINE_PID and e.get("tid") == HOST_TID
             and e.get("ph") == "X"}
    assert {"dispatch", "stage", "collect"} <= names
    assert validate_trace(trace) == []


def test_long_decode_stages_most_steps(setup):
    """With nothing queued and nothing prefilling, every decode step but
    the page-boundary and retiring ones runs on a staged plan."""
    _, tcfg, _, tparams = setup
    scfg = _scfg(max_len=64)
    prompts = _prompts(tcfg, [5, 9, 12], seed=7)
    with torch.no_grad():
        eng = Engine(tcfg, scfg, tparams, device="cpu")
        results, m = eng.run_offline(prompts, 40, overlap=True)
    assert [r.tokens for r in results] \
        == _static(tcfg, tparams, prompts, 40, scfg)
    used = eng.metrics.value("engine.overlap_used")
    assert used >= m["decode_steps"] // 2, (used, m["decode_steps"])
    assert eng.metrics.value("engine.overlap_dropped") == 0


def test_preemption_under_pressure_overlap_still_exact(setup):
    """Staged plans are invalidated by preemption and admission churn, not
    replayed stale: the pressure workload stays exact under pump()."""
    _, tcfg, _, tparams = setup
    scfg = _scfg(max_slots=3, max_len=32, num_pages=7)
    prompts = _prompts(tcfg, [7, 15, 9, 12], seed=9)
    budgets = [9, 8, 10, 7]
    with torch.no_grad():
        eng = Engine(tcfg, scfg, tparams, device="cpu")
        results, _ = eng.run_offline(prompts, budgets, overlap=True)
    assert [r.tokens for r in results] \
        == _static(tcfg, tparams, prompts, budgets, scfg)
    assert sum(r.n_preemptions for r in results) > 0
    for r in results:              # a replay keeps the first token's time
        assert r.ttft == pytest.approx(r.ttft_s, rel=1e-6, abs=1e-9)


# --------------------------------------------------------- streaming server

def test_serving_loop_streams_token_exact(setup):
    _, tcfg, _, tparams = setup
    scfg = _scfg()
    prompts = _prompts(tcfg, [4, 18, 9, 13, 6], seed=12)
    budgets = [5, 7, 4, 6, 8]
    eng = Engine(tcfg, scfg, tparams, device="cpu")
    streams = _stream_all(ServingLoop(eng, overlap=True,
                                      collect_queue_size=4),
                          prompts, budgets)
    ref = _static(tcfg, tparams, prompts, budgets, scfg)
    for events, want in zip(streams, ref):
        toks = [e for e in events if e["type"] == "token"]
        done = events[-1]
        assert done["type"] == "done"
        # every token exactly once, in order, each matching the baseline
        assert [e["index"] for e in toks] == list(range(len(want)))
        assert [e["token"] for e in toks] == want
        assert done["tokens"] == want
        assert done["text"] == "".join(f"<{t}>" for t in want)
        assert done["ttft_s"] <= done["finish_s"]
    assert eng.health.state == "healthy"
    assert eng.metrics.value("engine.overlap_staged") > 0


def test_serving_loop_rejection_and_cancel_events(setup):
    _, tcfg, _, tparams = setup
    eng = Engine(tcfg, _scfg(max_slots=2, max_len=16), tparams, device="cpu")

    async def main():
        serving = ServingLoop(eng, overlap=True)
        await serving.start()
        try:
            # zero-budget prompt -> terminal error event, no tokens
            rejected = await stream_request(
                serving, list(range(1, 17)), 4, timeout_s=WAIT_S)
            # live cancel: wait for the first token, then disconnect
            rid, q = serving.submit(_prompts(tcfg, [5], seed=14)[0],
                                    max_new_tokens=12)
            first = await asyncio.wait_for(q.get(), WAIT_S)
            serving.cancel(rid)
            while True:
                last = await asyncio.wait_for(q.get(), WAIT_S)
                if last["type"] in ("done", "error"):
                    break
            serving.forget(rid)
        finally:
            await asyncio.wait_for(serving.stop(), WAIT_S)
        return rejected, first, last

    rejected, first, last = asyncio.run(main())
    assert len(rejected) == 1 and rejected[0]["type"] == "error"
    assert "no_budget" in rejected[0]["error"]
    assert first["type"] == "token" and first["index"] == 0
    assert last["type"] == "error" and "cancelled" in last["error"]
    assert eng.pool.num_allocated == 0          # slot and pages released


def test_trace_with_rejection_validates_clean(setup):
    _, tcfg, _, tparams = setup
    eng = Engine(tcfg, _scfg(max_slots=2, max_len=16), tparams, device="cpu")
    with torch.no_grad():
        eng.add_request(list(range(1, 17)), 4)          # rejected
        eng.run_offline(_prompts(tcfg, [5, 9], seed=16), 4)
    trace = eng.tracer.to_dict()
    assert validate_trace(trace) == []
    assert sum(e.get("ph") == "i" and e.get("name") == "rejected"
               for e in trace["traceEvents"]) == 1


# ------------------------------------------------------------ trace report

@pytest.mark.parametrize("overlap", [False, True])
def test_trace_report_phase_sums_cover_wall_clock(setup, overlap, tmp_path,
                                                  capsys):
    """Per-phase durations plus the host gap reconstruct the wall clock;
    the overlapped run also reports its dispatch / stage / collect sums;
    ``trace_report --validate`` accepts the saved trace."""
    _, tcfg, _, tparams = setup
    scfg = _scfg(max_slots=3, prefill_chunk_tokens=16, max_len=64)
    prompts = _prompts(tcfg, [40, 7, 23, 11], seed=5)
    with torch.no_grad():
        eng = Engine(tcfg, scfg, tparams, device="cpu")
        results, metrics = eng.run_offline(prompts, 6, overlap=overlap)
    trace = eng.tracer.to_dict()
    bd = trace_report.phase_breakdown(trace)
    covered = sum(bd["per_phase_s"].values()) + bd["other_s"] + bd["host_s"]
    assert covered == pytest.approx(bd["wall_s"], rel=1e-6)
    assert metrics["wall_s"] * 0.5 <= bd["wall_s"] <= metrics["wall_s"] * 1.1
    assert bd["counts"]["decode"] == metrics["decode_steps"]
    assert bd["n_steps"] == metrics["prefill_steps"] + metrics["decode_steps"]
    hp = trace_report.host_pipeline(trace)
    if overlap:
        assert hp["counts"]["dispatch"] == hp["counts"]["collect"] \
            == bd["n_steps"]
        assert 0 < hp["counts"]["stage"] <= metrics["decode_steps"]
    else:
        assert hp == {}
    rows = trace_report.request_rows(trace)
    assert [r["rid"] for r in rows] == [r.rid for r in results]
    for row, r in zip(rows, results):
        assert row["ttft_s"] == pytest.approx(r.ttft_s)
        assert row["n_tokens"] == len(r.tokens)
    path = tmp_path / "trace.json"
    eng.tracer.save(str(path))
    assert trace_report.main([str(path), "--validate"]) == 0
    out = capsys.readouterr().out
    assert "time in phase" in out and "trace valid" in out
    assert ("host pipeline" in out) == overlap


# ---------------------------------------------------------- HTTP front end

def test_serve_http_smoke_on_cpu(tmp_path, capsys):
    metrics = tmp_path / "metrics.json"
    assert serve_http.main(["--device", "cpu", "--reduced", "--smoke", "3",
                            "--timeout-s", str(WAIT_S),
                            "--metrics-json", str(metrics)]) == 0
    out = capsys.readouterr().out
    assert "smoke verify OK: 3 streams" in out
    assert "starting -> healthy -> draining -> drained" in out
    snap = json.loads(metrics.read_text())
    assert snap["counters"]["engine.overlap_staged"] > 0


def test_serve_http_asks_for_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="cuda"):
        serve_http.main(["--reduced", "--smoke", "1"])


# --------------------------------------------------------- across frameworks

def test_pump_and_serving_loop_match_jax(setup):
    """The JAX package's ``Engine.pump()`` and ``ServingLoop`` and the
    port's, on the same weights and prompts: the same tokens, exactly."""
    jcfg, tcfg, jparams, tparams = setup
    kw = dict(page_size=8, max_slots=4, max_len=48)
    prompts = _prompts(tcfg, [4, 18, 9, 13, 6], seed=21)
    budgets = [5, 7, 4, 6, 8]
    jeng = JEngine(jcfg, JServeConfig(**kw), jparams)
    jpump = [r.tokens for r in jeng.run_offline(prompts, budgets,
                                                overlap=True)[0]]

    async def jmain():
        serving = JServingLoop(JEngine(jcfg, JServeConfig(**kw), jparams))
        await serving.start()
        try:
            return await asyncio.wait_for(asyncio.gather(*[
                j_stream_request(serving, p, g, timeout_s=WAIT_S)
                for p, g in zip(prompts, budgets)]), WAIT_S)
        finally:
            await asyncio.wait_for(serving.stop(), WAIT_S)
    jstream = [ev[-1]["tokens"] for ev in asyncio.run(jmain())]
    with torch.no_grad():
        tpump = [r.tokens for r in Engine(
            tcfg, tconfigs.ServeConfig(**kw), tparams,
            device="cpu").run_offline(prompts, budgets, overlap=True)[0]]
    tstream = [ev[-1]["tokens"] for ev in _stream_all(
        ServingLoop(Engine(tcfg, tconfigs.ServeConfig(**kw), tparams,
                           device="cpu")), prompts, budgets)]
    assert tpump == tstream == jpump == jstream
    assert [len(t) for t in tpump] == budgets
