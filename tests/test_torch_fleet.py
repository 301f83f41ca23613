"""The port's fleet on the CPU: ``EngineManager`` (M501 admission, the
load race, health-gated hot swap with canary rollback), ``FrontDoor``
(per-model circuit breakers, deadline-bounded retry, shedding, the
half-open probe ticket), ``FleetHTTPServer`` and the fault-site registry,
the cases of the JAX package's ``tests/test_fleet.py``, plus the decode
slots of ``tests/test_decode.py::test_fleet_hosts_decode_engines`` and an
HTTP round trip that carries a W3C ``traceparent``.

Models are saved by the JAX package and loaded by the port's sessions
(``param_path``); the served answers are held against the JAX
``Inferencer`` from the same files, and bit-equal to the port's own
one-request ``Inferencer``.  Every test that reads the process-wide
``"fleet"`` / ``"serving"`` counters resets them first, so no result
depends on the tests that ran before it on the worker.
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.serving import decode_models as jzoo
from paddle_tpu_torch import faults, telemetry
from paddle_tpu_torch.serving import (CircuitBreaker, CircuitOpen, EngineManager,
                                      FleetHTTPServer, FrontDoor, ModelRejected,
                                      RequestTimeout, ServingError, ServingNonFinite,
                                      ServingOverloaded, SwapFailed)
from paddle_tpu_torch.serving import decode_models as zoo
from paddle_tpu_torch.serving.engine import SERVING_SCOPE
from paddle_tpu_torch.serving.fleet import FLEET_SCOPE, SITE_ADMIT, SITE_BACKEND, SITE_SWAP
from paddle_tpu_torch.telemetry import REGISTRY

from _torch_validate import _no_port_validate_findings  # noqa: F401

FEAT, CLASSES = 6, 4
CPU = pt.CPUPlace()
EOS, GEN = 0, 5
# float32 fc -> relu -> fc -> softmax, XLA against torch on the CPU
JAX_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _reset():
    faults.reset()
    telemetry.reset_scope(FLEET_SCOPE, SERVING_SCOPE)
    yield
    faults.reset()


def _infer_func(pkg=pt):
    def infer_func():
        x = pkg.layers.data(name="x", shape=[FEAT], dtype="float32")
        h = pkg.layers.fc(input=x, size=8, act="relu")
        return pkg.layers.fc(input=h, size=CLASSES, act="softmax")
    return infer_func


_SAVED = {}


def _save_params(tmp_path, name="params", seed=7) -> str:
    """The JAX package's startup from ``seed``, saved in its format (once
    a seed in this module; the sessions only read the files)."""
    if seed in _SAVED:
        return _SAVED[seed]
    d = str(tmp_path / name)
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            _infer_func(fluid)()
    startup.random_seed = seed
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, d, main)
    _SAVED[seed] = d
    return d


@pytest.fixture(scope="module")
def saved_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("params")


@pytest.fixture
def model_dir(saved_dir):
    return _save_params(saved_dir)


def _sequential(params, inputs):
    with pt.unique_name.guard():
        inf = pt.Inferencer(infer_func=_infer_func(), param_path=params, place=CPU)
        return inf.infer(inputs)


def _jax_sequential(params, inputs):
    with fluid.unique_name.guard():
        inf = fluid.Inferencer(infer_func=_infer_func(fluid), param_path=params)
        return inf.infer(inputs)


def _mgr(**kw):
    return EngineManager(place=CPU, **kw)


# ------------------------------------------------------- breaker machine


def test_breaker_state_machine():
    events = []
    br = CircuitBreaker("m", threshold=2, backoff_s=0.05, backoff_max_s=0.5,
                        on_event=lambda e, **f: events.append((e, f)))
    br.admit()
    br.record_failure(RuntimeError("one"))
    assert br.snapshot()["state"] == "closed"
    br.record_failure(RuntimeError("two"))
    snap = br.snapshot()
    assert snap["state"] == "open" and snap["trips"] == 1
    with pytest.raises(CircuitOpen) as ei:
        br.admit()
    assert ei.value.model == "m" and ei.value.retry_after_s > 0.0
    time.sleep(0.06)
    br.admit()                                   # the backoff is over: the probe
    assert br.snapshot()["state"] == "half_open"
    with pytest.raises(CircuitOpen):             # one probe ticket
        br.admit()
    br.record_failure(RuntimeError("probe"))     # re-open, backoff doubled
    snap = br.snapshot()
    assert snap["state"] == "open" and snap["backoff_s"] == pytest.approx(0.1)
    assert snap["trips"] == 2
    time.sleep(0.12)
    br.admit()
    br.record_success()
    snap = br.snapshot()
    assert snap["state"] == "closed" and snap["backoff_s"] == pytest.approx(0.05)
    assert snap["failures"] == 0
    assert [e for e, _ in events] == ["breaker-trip", "breaker-half-open", "breaker-trip",
                                      "breaker-half-open", "breaker-close"]
    assert br.open_seconds() > 0.1


def test_breaker_backoff_caps_and_success_resets_failures():
    br = CircuitBreaker("m", threshold=1, backoff_s=0.01, backoff_max_s=0.02)
    br.record_failure()
    for _ in range(4):
        time.sleep(0.025)
        br.admit()
        br.record_failure()
    assert br.snapshot()["backoff_s"] == pytest.approx(0.02)
    br2 = CircuitBreaker("m2", threshold=2)
    br2.record_failure()
    br2.record_success()
    br2.record_failure()
    assert br2.snapshot() == {"state": "closed", "failures": 1, "backoff_s": 0.25, "trips": 0}


# --------------------------------------------------- manager lifecycle


def test_manager_load_infer_unload(model_dir):
    x = np.random.default_rng(0).standard_normal((3, FEAT), dtype=np.float32)
    want = _sequential(model_dir, {"x": x})
    np.testing.assert_allclose(want[0], _jax_sequential(model_dir, {"x": x})[0],
                               rtol=0, atol=JAX_ATOL)
    with _mgr() as mgr:
        mgr.load("m", infer_func=_infer_func(), param_path=model_dir, max_batch_size=4,
                 max_wait_ms=0.0)
        assert mgr.session("m").inferencer.exe.device.type == "cpu"
        np.testing.assert_array_equal(mgr.infer("m", {"x": x})[0], want[0])
        assert mgr.models()["m"]["version"] == 1
        with pytest.raises(ValueError):
            mgr.load("m", infer_func=_infer_func(), param_path=model_dir)
        mgr.unload("m")
        with pytest.raises(KeyError):
            mgr.infer("m", {"x": x})
    rec = REGISTRY.snapshot(scope=FLEET_SCOPE)
    assert rec["loads"] == 1 and rec["requests_routed"] == 1


def test_manager_admission_rejects_on_budget(tmp_path):
    """The M501 pre-flight on a manifest checkpoint: over budget ->
    ModelRejected before any build, and nothing registered."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.checkpoint import manifest as manifest_mod
    main, startup = pt.Program(), pt.Program()
    scope = pt.Scope()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        _infer_func()()
    startup.random_seed = 7
    pt.Executor(CPU).run(startup, scope=scope)
    cm = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    cm.save(main, scope, step=1)
    ckpt = manifest_mod.checkpoint_dir(str(tmp_path / "ckpt"), 1)

    mgr = _mgr(memory_budget=16)
    built = []
    real = mgr._build_session
    mgr._build_session = lambda *a, **k: built.append(1) or real(*a, **k)
    with pytest.raises(ModelRejected) as ei:
        mgr.load("m", infer_func=_infer_func(), param_path=ckpt)
    assert ei.value.model == "m" and ei.value.code == "M501"
    assert ei.value.predicted_peak_bytes > 16 and ei.value.budget_bytes == 16
    assert mgr.models() == {} and built == []
    assert REGISTRY.snapshot(scope=FLEET_SCOPE)["rejects"] == 1
    mgr.close()
    with _mgr(memory_budget="1GiB") as mgr2:
        mgr2.load("m", infer_func=_infer_func(), param_path=ckpt, max_batch_size=4,
                  max_wait_ms=0.0)
        assert np.isfinite(mgr2.infer("m", {"x": np.zeros((2, FEAT), np.float32)})[0]).all()


def test_manager_load_race_loser_closes_cleanly(model_dir):
    mgr = _mgr()
    built, real_build = [], mgr._build_session

    def racing_build(name, infer_func, param_path, **kw):
        s = real_build(name, infer_func, param_path, **kw)
        built.append(s)
        if len(built) == 1:
            mgr.load(name, infer_func=infer_func, param_path=param_path, max_batch_size=4,
                     max_wait_ms=0.0)
        return s

    mgr._build_session = racing_build
    with pytest.raises(ValueError):
        mgr.load("m", infer_func=_infer_func(), param_path=model_dir, max_batch_size=4,
                 max_wait_ms=0.0)
    assert mgr.models()["m"]["version"] == 1
    assert mgr.session("m") is built[1]
    assert built[0].engine._stop.is_set()
    assert np.isfinite(mgr.infer("m", {"x": np.zeros((1, FEAT), np.float32)})[0]).all()
    mgr.close()

    mgr2 = _mgr()
    real_build2 = mgr2._build_session

    def closing_build(name, infer_func, param_path, **kw):
        s = real_build2(name, infer_func, param_path, **kw)
        built.append(s)
        mgr2.close()
        return s

    mgr2._build_session = closing_build
    with pytest.raises(ServingError):
        mgr2.load("m", infer_func=_infer_func(), param_path=model_dir, max_batch_size=4,
                  max_wait_ms=0.0)
    assert mgr2.models() == {}
    assert built[-1].engine._stop.is_set()


# ------------------------------------------------------------- hot swap


def test_swap_canary_rollback_and_success(saved_dir):
    p1 = _save_params(saved_dir, "v1", seed=7)
    p2 = _save_params(saved_dir, "v2", seed=11)
    x = np.random.default_rng(1).standard_normal((2, FEAT), dtype=np.float32)
    want_v1, want_v2 = _sequential(p1, {"x": x}), _sequential(p2, {"x": x})
    assert not np.array_equal(want_v1[0], want_v2[0])
    with _mgr() as mgr:
        mgr.load("m", infer_func=_infer_func(), param_path=p1, max_batch_size=4,
                 max_wait_ms=0.0)
        faults.install("fail@serving.swap:n=1")
        with pytest.raises(SwapFailed) as ei:
            mgr.swap("m", infer_func=_infer_func(), param_path=p2, max_batch_size=4,
                     max_wait_ms=0.0)
        assert isinstance(ei.value.cause, faults.FaultInjected)
        faults.reset()
        assert mgr.models()["m"]["version"] == 1
        np.testing.assert_array_equal(mgr.infer("m", {"x": x})[0], want_v1[0])
        # a poisoned canary (a NaN feed through the NaN guard) rolls back too
        with pytest.raises(SwapFailed) as ei:
            mgr.swap("m", infer_func=_infer_func(), param_path=p2,
                     canary={"x": np.full((1, FEAT), np.nan, np.float32)},
                     max_batch_size=4, max_wait_ms=0.0)
        assert isinstance(ei.value.cause, ServingNonFinite)
        assert mgr.models()["m"]["version"] == 1
        np.testing.assert_array_equal(mgr.infer("m", {"x": x})[0], want_v1[0])
        mgr.swap("m", infer_func=_infer_func(), param_path=p2, max_batch_size=4,
                 max_wait_ms=0.0)
        assert mgr.models()["m"]["version"] == 2
        np.testing.assert_array_equal(mgr.infer("m", {"x": x})[0], want_v2[0])
    rec = REGISTRY.snapshot(scope=FLEET_SCOPE)
    assert rec["swap_rollbacks"] == 2 and rec["swaps"] == 1


def test_swap_aborts_cleanly_when_slot_vanishes(saved_dir):
    p1 = _save_params(saved_dir, "v1", seed=7)
    p2 = _save_params(saved_dir, "v2", seed=11)
    with _mgr() as mgr:
        mgr.load("m", infer_func=_infer_func(), param_path=p1, max_batch_size=4,
                 max_wait_ms=0.0)
        candidates, real_build = [], mgr._build_session

        def build_hooked(name, infer_func, param_path, **kw):
            s = real_build(name, infer_func, param_path, **kw)
            candidates.append(s)
            real_infer = s.infer

            def canary_then_vanish(inputs, timeout=None):
                out = real_infer(inputs, timeout=timeout)
                mgr.unload("m")
                return out

            s.infer = canary_then_vanish
            return s

        mgr._build_session = build_hooked
        with pytest.raises(SwapFailed) as ei:
            mgr.swap("m", infer_func=_infer_func(), param_path=p2, max_batch_size=4,
                     max_wait_ms=0.0)
        assert ei.value.model == "m"
        assert mgr.models() == {}
        assert candidates[0].engine._stop.is_set()
    assert REGISTRY.snapshot(scope=FLEET_SCOPE)["swap_rollbacks"] == 1


# ---------------------------------------------------- front-door policy


def _manager_with_fake(infer):
    mgr = _mgr()
    mgr.infer = infer
    return mgr


def test_frontdoor_retries_retryable_then_succeeds():
    calls = []

    def flaky(model, inputs, timeout=None):
        calls.append(timeout)
        if len(calls) == 1:
            raise ServingNonFinite("poisoned batch")
        return [np.ones((1, 1), np.float32)]

    fd = FrontDoor(_manager_with_fake(flaky), max_retries=2, retry_backoff_s=0.001)
    out = fd.infer("m", {"x": np.zeros((1, 1))}, timeout_s=5.0)
    assert len(calls) == 2 and calls[1] < calls[0]
    np.testing.assert_array_equal(out[0], [[1.0]])
    snap = fd.breaker("m").snapshot()
    assert snap["state"] == "closed" and snap["failures"] == 0
    assert REGISTRY.snapshot(scope=FLEET_SCOPE)["requests_retried"] == 1


def test_frontdoor_never_retries_queue_timeouts_or_overload():
    calls = []

    def wedged(model, inputs, timeout=None):
        calls.append(1)
        raise RequestTimeout("queue full too long", where="queue")

    fd = FrontDoor(_manager_with_fake(wedged), max_retries=5)
    with pytest.raises(RequestTimeout):
        fd.infer("m", {"x": 0}, timeout_s=5.0)
    assert len(calls) == 1 and fd.breaker("m").snapshot()["failures"] == 1

    def full(model, inputs, timeout=None):
        raise ServingOverloaded("queue full")

    fd2 = FrontDoor(_manager_with_fake(full), max_retries=5)
    with pytest.raises(ServingOverloaded):
        fd2.infer("m", {"x": 0}, timeout_s=5.0)
    assert fd2.breaker("m").snapshot() == {"state": "closed", "failures": 0,
                                           "backoff_s": 0.25, "trips": 0}
    assert REGISTRY.snapshot(scope=FLEET_SCOPE)["requests_shed"] == 1


def test_frontdoor_trips_then_sheds_without_backend_touch():
    calls = []

    def dying(model, inputs, timeout=None):
        calls.append(1)
        raise RequestTimeout("device wedged", where="device")

    fd = FrontDoor(_manager_with_fake(dying), breaker_threshold=2, breaker_backoff_s=30.0,
                   max_retries=0)
    for _ in range(2):
        with pytest.raises(RequestTimeout):
            fd.infer("m", {"x": 0}, timeout_s=5.0)
    assert fd.breaker("m").snapshot()["state"] == "open"
    n = len(calls)
    with pytest.raises(CircuitOpen):
        fd.infer("m", {"x": 0}, timeout_s=5.0)
    assert len(calls) == n
    rec = REGISTRY.snapshot(scope=FLEET_SCOPE)
    assert rec["breaker_trips"] == 1 and rec["requests_shed"] == 1
    slo = fd.slo()
    assert slo["requests_shed"] == 1 and slo["requests_failed"] == 2
    assert slo["breaker_open_s"]["m"] >= 0.0 and slo["availability"] == 0.0


def test_frontdoor_spent_budget_never_reaches_backend():
    calls = []

    def backend(model, inputs, timeout=None):
        calls.append(1)
        return [np.zeros((1, 1))]

    fd = FrontDoor(_manager_with_fake(backend))
    with pytest.raises(RequestTimeout) as ei:
        fd.infer("m", {"x": 0}, timeout_s=0.0)
    assert ei.value.where == "queue" and calls == []
    for _ in range(fd.breaker_threshold + 1):
        with pytest.raises(RequestTimeout):
            fd.infer("m", {"x": 0}, timeout_s=-1.0)
    assert fd.breaker("m").snapshot() == {"state": "closed", "failures": 0,
                                          "backoff_s": 0.25, "trips": 0}


def test_frontdoor_probe_ticket_survives_verdictless_exits():
    behavior = {"mode": "die"}

    def backend(model, inputs, timeout=None):
        if behavior["mode"] == "die":
            raise RequestTimeout("device wedged", where="device")
        if behavior["mode"] == "full":
            raise ServingOverloaded("queue full")
        if behavior["mode"] == "gone":
            raise KeyError(model)
        return [np.ones((1, 1), np.float32)]

    fd = FrontDoor(_manager_with_fake(backend), breaker_threshold=2, breaker_backoff_s=0.02,
                   max_retries=0)
    for _ in range(2):
        with pytest.raises(RequestTimeout):
            fd.infer("m", {"x": 0}, timeout_s=5.0)
    assert fd.breaker("m").snapshot()["state"] == "open"
    time.sleep(0.03)
    behavior["mode"] = "full"
    with pytest.raises(ServingOverloaded):
        fd.infer("m", {"x": 0}, timeout_s=5.0)
    behavior["mode"] = "gone"
    with pytest.raises(KeyError):
        fd.infer("m", {"x": 0}, timeout_s=5.0)
    with pytest.raises(RequestTimeout):
        fd.infer("m", {"x": 0}, timeout_s=0.0)
    behavior["mode"] = "ok"
    np.testing.assert_array_equal(fd.infer("m", {"x": 0}, timeout_s=5.0)[0], [[1.0]])
    assert fd.breaker("m").snapshot()["state"] == "closed"


# --------------------------------------------------------- HTTP surface


def _http(method, url, body=None, headers=None):
    req = urllib.request.Request(
        url, method=method, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_http_roundtrip(model_dir):
    x = np.random.default_rng(2).standard_normal((2, FEAT), dtype=np.float32)
    want = _sequential(model_dir, {"x": x})
    with _mgr() as mgr:
        mgr.load("m", infer_func=_infer_func(), param_path=model_dir, max_batch_size=4,
                 max_wait_ms=0.0)
        fd = FrontDoor(mgr, breaker_backoff_s=30.0)
        with FleetHTTPServer(fd) as srv:
            base = srv.address
            assert base.startswith("http://127.0.0.1:")
            code, out, _ = _http("POST", base + "/v1/infer",
                                 {"model": "m", "inputs": {"x": x.tolist()}, "timeout_s": 30.0})
            assert code == 200
            np.testing.assert_allclose(np.asarray(out["outputs"][0], np.float32), want[0],
                                       rtol=1e-6)
            code, models, _ = _http("GET", base + "/v1/models")
            assert code == 200 and models["models"]["m"]["version"] == 1
            code, stats, _ = _http("GET", base + "/v1/stats")
            assert code == 200 and "breakers" in stats
            code, hz, _ = _http("GET", base + "/v1/healthz")
            assert code == 200 and hz["ok"] is True
            code, slo, _ = _http("GET", base + "/v1/slo")
            assert code == 200 and slo["availability"] == 1.0
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                text = r.read().decode()
            assert r.status == 200 and "text/plain" in r.headers["Content-Type"]
            assert "fleet" in text and "requests_routed" in text
            code, _, _ = _http("POST", base + "/v1/infer",
                               {"model": "ghost", "inputs": {"x": x.tolist()}})
            assert code == 404
            code, _, _ = _http("POST", base + "/v1/infer", {"inputs": {}})
            assert code == 400
            for bad_timeout in (0, -3, "soon", float("nan")):
                code, _, _ = _http("POST", base + "/v1/infer",
                                   {"model": "m", "inputs": {"x": x.tolist()},
                                    "timeout_s": bad_timeout})
                assert code == 400, bad_timeout
            br = fd.breaker("m")
            for _ in range(fd.breaker_threshold):
                br.record_failure(RuntimeError("wedge"))
            code, hz, _ = _http("GET", base + "/v1/healthz")
            assert code == 503 and hz["breakers_open"] == ["m"]
            code, err, hdrs = _http("POST", base + "/v1/infer",
                                    {"model": "m", "inputs": {"x": x.tolist()}})
            assert code == 503 and err["code"] == "circuit_open"
            assert float(hdrs["Retry-After"]) > 0.0


def test_http_adopts_the_traceparent_and_returns_its_trace(model_dir, tmp_path, monkeypatch):
    """``POST /v1/infer`` and ``POST /v1/generate`` sent with a W3C
    ``traceparent``: the admit span is a child of the caller's, the
    response's header carries the same trace id with the span's own id,
    and the fleet and decode records of the request join that trace."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / "tel"))
    from paddle_tpu_torch.serving import fleet
    fleet.FLEET_RECORDS.reopen()
    trace_id, caller_span = "ab" * 16, "cd" * 8
    header = {"traceparent": f"00-{trace_id}-{caller_span}-01"}
    pre, step, _ = zoo.gru_lm()
    try:
        with _mgr() as mgr:
            mgr.load("m", infer_func=_infer_func(), param_path=model_dir, max_batch_size=4,
                     max_wait_ms=0.0)
            mgr.load_decode("lm", pre, step, eos_id=EOS, max_seq_len=8, max_batch_size=2,
                            seed=11, max_new_tokens_default=GEN)
            with FleetHTTPServer(FrontDoor(mgr)) as srv:
                code, out, hdrs = _http("POST", srv.address + "/v1/infer",
                                        {"model": "m", "inputs": {"x": [[0.5] * FEAT]}},
                                        headers=header)
                assert code == 200
                parts = hdrs["traceparent"].split("-")
                assert parts[1] == trace_id and parts[2] != caller_span
                code, gen, hdrs2 = _http("POST", srv.address + "/v1/generate",
                                         {"model": "lm", "prompt": [5, 9, 2],
                                          "max_new_tokens": 3}, headers=header)
                assert code == 200 and gen["reason"] in ("eos", "max_tokens")
                assert 1 <= gen["n_tokens"] == len(gen["tokens"]) <= 3
                assert hdrs2["traceparent"].split("-")[1] == trace_id
                code, _, hdrs3 = _http("POST", srv.address + "/v1/generate",
                                       {"model": "m", "prompt": [1]})
                assert code == 400                   # an infer slot has no decode engine
    finally:
        fleet.FLEET_RECORDS.reopen()
    recs = []
    for name in os.listdir(tmp_path / "tel"):
        if name.endswith(".jsonl"):
            with open(tmp_path / "tel" / name) as f:
                recs += [json.loads(line) for line in f if line.strip()]
    http = [r for r in recs if r.get("kind") == "http"]
    assert len(http) == 3 and all(r["parent_id"] == caller_span for r in http[:2])
    assert {r["trace_id"] for r in http[:2]} == {trace_id}
    decode = [r for r in recs if r.get("kind") == "request" and r.get("trace_id") == trace_id
              and "n_iterations" in r]
    assert len(decode) == 1


# ------------------------------------------------------- the decode slots


def test_fleet_hosts_decode_engines(tmp_path):
    """load_decode / generate / swap_decode / wrong-kind routing on the
    shared manager and front door; the tokens equal the JAX one-shot
    program's from the same saved parameters."""
    _, _, jref = jzoo.gru_lm()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        (_i, _l), toks_v = jref(8, GEN)
    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    startup.random_seed = 11
    jexe.run(startup, scope=jscope)
    d = str(tmp_path / "lm")
    with fluid.scope_guard(jscope):
        fluid.io.save_persistables(jexe, d, main)
    prompt = np.array([5, 9, 2], np.int64)
    ids = np.full((1, 8), EOS, np.int64)
    ids[0, :3] = prompt
    (want,) = jexe.run(main, feed={"ids": ids, "lens": np.array([[3]], np.int32)},
                       fetch_list=[toks_v], scope=jscope)
    want = list(np.asarray(want)[0])
    want = np.asarray(want[:want.index(EOS) + 1] if EOS in want else want)

    pre, step, _ = zoo.gru_lm()
    kw = dict(eos_id=EOS, max_seq_len=8, max_batch_size=2, max_new_tokens_default=GEN)
    mgr = _mgr()
    try:
        slot = mgr.load_decode("lm", pre, step, param_path=d, **kw)
        assert slot.kind == "decode" and slot.version == 1
        assert mgr.decode_engine("lm").exe.device.type == "cpu"
        models = mgr.models()
        assert models["lm"]["kind"] == "decode"
        assert models["lm"]["buckets"] == list(mgr.decode_engine("lm").seq_buckets)
        with pytest.raises(ValueError):
            mgr.load_decode("lm", pre, step, eos_id=EOS, seed=11)
        with pytest.raises(TypeError):
            mgr.session("lm")
        with pytest.raises(KeyError):
            mgr.decode_engine("missing")
        fd = FrontDoor(mgr, default_timeout_s=60.0)
        r1 = fd.generate("lm", prompt, max_new_tokens=GEN)
        assert np.array_equal(np.asarray(r1.tokens).ravel(), want)
        slot2 = mgr.swap_decode("lm", pre, step, param_path=d, **kw)
        assert slot2.version == 2
        assert mgr.decode_engine("lm").fresh_compiles_since_warmup == 0
        r2 = fd.generate("lm", prompt, max_new_tokens=GEN)
        assert np.array_equal(np.asarray(r2.tokens), np.asarray(r1.tokens))
        # a canary that fails rolls the decode slot back
        faults.install("fail@serving.swap:n=1")
        with pytest.raises(SwapFailed):
            mgr.swap_decode("lm", pre, step, param_path=d, **kw)
        faults.reset()
        assert mgr.models()["lm"]["version"] == 2
        st = mgr.stats()
        assert st["swaps"] == 1 and st["swap_rollbacks"] == 1
        assert st["models"]["lm"]["kind"] == "decode"
    finally:
        mgr.close()


def test_the_fleet_defaults_to_the_card():
    import inspect
    assert EngineManager().place is None
    assert inspect.signature(EngineManager).parameters["place"].default is None


# ----------------------------------------- faults site registry contract


def test_fleet_sites_registered_at_import():
    cat = faults.sites()
    for site in (SITE_ADMIT, SITE_SWAP, SITE_BACKEND, "serving.runner",
                 "dispatch.task_start"):
        assert site in cat and cat[site]


def test_register_site_from_user_code():
    assert faults.register_site("user.custom_site", "my own guard") == "user.custom_site"
    assert faults.sites()["user.custom_site"] == "my own guard"
    faults.register_site("user.custom_site")
    assert faults.sites()["user.custom_site"] == "my own guard"
    for bad in ("", "a@b", "a;b"):
        with pytest.raises(ValueError):
            faults.register_site(bad)


def test_serving_sites_inert_without_plan():
    assert not faults.active()
    for site in (SITE_ADMIT, SITE_SWAP, f"{SITE_BACKEND}.m"):
        assert faults.fire(site) is False
    assert faults.counters() == {}


def test_serving_site_gating_deterministic():
    faults.install(f"fail@{SITE_SWAP}:n=2")
    assert faults.fire(SITE_SWAP) is False
    with pytest.raises(faults.FaultInjected):
        faults.fire(SITE_SWAP)
    assert faults.fire(SITE_SWAP) is False

    def pattern(seed):
        faults.install(f"drop@{SITE_BACKEND}.m:p=0.5", seed=seed)
        return [faults.fire(f"{SITE_BACKEND}.m") for _ in range(32)]

    a, b = pattern(3), pattern(3)
    assert a == b and True in a and False in a
    assert pattern(4) != a


def test_a_wedged_backend_trips_its_breaker_while_its_mate_serves(model_dir):
    """``delay@serving.backend.<name>`` slows one model's batches past the
    deadline: its breaker opens and sheds, the other model keeps serving
    bit-equal answers, and the breaker closes through its half-open probe
    once the wedge is lifted."""
    x = np.random.default_rng(3).standard_normal((1, FEAT), dtype=np.float32)
    want = _sequential(model_dir, {"x": x})
    with _mgr() as mgr:
        for name in ("a", "b"):
            mgr.load(name, infer_func=_infer_func(), param_path=model_dir, max_batch_size=2,
                     max_wait_ms=0.0)
        fd = FrontDoor(mgr, breaker_threshold=2, breaker_backoff_s=0.05, max_retries=0)
        faults.install("delay@serving.backend.a:s=0.3")
        for _ in range(2):
            with pytest.raises(RequestTimeout):
                fd.infer("a", {"x": x}, timeout_s=0.1)
        with pytest.raises(CircuitOpen):
            fd.infer("a", {"x": x}, timeout_s=0.1)
        np.testing.assert_array_equal(fd.infer("b", {"x": x}, timeout_s=5.0)[0], want[0])
        faults.reset()
        time.sleep(0.4)                      # the wedged batches drain, the backoff ends
        np.testing.assert_array_equal(fd.infer("a", {"x": x}, timeout_s=5.0)[0], want[0])
        assert fd.breaker("a").snapshot()["state"] == "closed"
    rec = REGISTRY.snapshot(scope=FLEET_SCOPE)
    assert rec["breaker_trips"] == 1 and rec["breaker_closes"] == 1


def test_concurrent_clients_over_two_models_stay_bit_equal(saved_dir):
    p1 = _save_params(saved_dir, "v1", seed=7)
    p2 = _save_params(saved_dir, "v2", seed=11)
    rs = np.random.default_rng(4)
    xs = [rs.standard_normal((1, FEAT), dtype=np.float32) for _ in range(12)]
    want = {"a": [_sequential(p1, {"x": x})[0] for x in xs],
            "b": [_sequential(p2, {"x": x})[0] for x in xs]}
    errors = []
    with _mgr() as mgr:
        mgr.load("a", infer_func=_infer_func(), param_path=p1, max_batch_size=4)
        mgr.load("b", infer_func=_infer_func(), param_path=p2, max_batch_size=4)
        fd = FrontDoor(mgr)

        def client(c):
            name = "ab"[c % 2]
            try:
                for i, x in enumerate(xs):
                    out = fd.infer(name, {"x": x}, timeout_s=30.0)[0]
                    # a batch of 1 or of 4 rows: the CPU's fc is row-exact here
                    np.testing.assert_allclose(out, want[name][i], rtol=0, atol=1e-7)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    assert not errors, errors
    assert REGISTRY.snapshot(scope=FLEET_SCOPE)["frontdoor_requests"] == 4 * len(xs)


def _load_tool(name):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_port_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decode_and_fleet_records_read_by_the_reference_tools(tmp_path, monkeypatch):
    """``decode_<pid>.jsonl`` and ``fleet_<pid>.jsonl`` in the reference's
    schema: ``tools/stats.py``'s decode and fleet summaries and
    ``tools/health_report.py``'s sections, unedited, read the port's
    records and agree with the engine's and the manager's counters."""
    from paddle_tpu_torch.serving import DECODE_SCOPE, fleet
    tel = tmp_path / "tel"
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tel))
    telemetry.reset_scope(DECODE_SCOPE)
    fleet.FLEET_RECORDS.reopen()
    pre, step, _ = zoo.gru_lm()
    kw = dict(eos_id=EOS, max_seq_len=16, max_batch_size=2, seed=11, max_new_tokens_default=GEN)
    try:
        with _mgr() as mgr:
            mgr.load_decode("lm", pre, step, **kw)
            fd = FrontDoor(mgr, breaker_threshold=2)
            rs = np.random.RandomState(5)
            for n in (3, 6, 2, 5):
                fd.generate("lm", rs.randint(1, zoo.VOCAB, size=n), max_new_tokens=GEN)
            st = mgr.decode_engine("lm").stats()
            mgr.swap_decode("lm", pre, step, **kw)
            for _ in range(2):
                fd.breaker("lm").record_failure(RuntimeError("wedge"))
    finally:
        fleet.FLEET_RECORDS.reopen()
    stats, health = _load_tool("stats"), _load_tool("health_report")
    records, files = stats.load_decode_records(str(tel))
    assert len(files) == 1 and files[0].endswith(f"decode_{os.getpid()}.jsonl")
    s = stats.summarize_decode_records(records)
    assert s["requests"] == st["requests_ok"] + 1          # and the swap's canary
    assert s["iterations"] == st["iterations"] and s["tokens_out"] == st["tokens_out"] + 1
    assert sum(s["retirements"].values()) == s["requests"]
    h = health.decode_engine_health(str(tel))
    assert h["requests"] == s["requests"] and h["iterations"] == s["iterations"]
    frecs, ffiles = stats.load_fleet_records(str(tel))
    f = stats.summarize_fleet_records(frecs)
    assert f["kinds"]["load"] == 1 and f["kinds"]["swap"] == 1 and f["models"] == {"lm": 2}
    assert f["breakers_open"] == ["lm"]
    fh = health.fleet_breaker_health(str(tel))
    assert fh["swaps"] == 1 and fh["breakers_stuck_open"] == ["lm"]
