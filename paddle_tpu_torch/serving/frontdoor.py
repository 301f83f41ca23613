"""The fleet's front door: per-model circuit breakers, deadline-bounded
retry, load-shed admission, and a stdlib HTTP surface, as the JAX
package's ``serving/frontdoor.py`` defines them.

Failure policy (the whole module in four rules):

* **Breaker input** — what counts as a backend failure is anything that
  says "this model's pipeline is unhealthy": every
  :class:`~paddle_tpu_torch.serving.engine.RequestTimeout` flavor (a wedged
  backend manifests as queue/dispatch timeouts long before a device
  error), :class:`~paddle_tpu_torch.serving.engine.ServingNonFinite` (poisoned
  outputs), injected :class:`~paddle_tpu_torch.faults.FaultInjected`, and raw
  runner errors.  :class:`ServingOverloaded` is NOT a failure — a full
  queue is the admission layer doing its job; shedding must never talk
  the breaker into amplifying an overload into an outage.
* **Breaker state machine** — CLOSED → (``threshold`` consecutive
  failures) → OPEN for ``backoff_s`` (every request sheds instantly with
  :class:`CircuitOpen`, no backend touch) → HALF_OPEN (exactly ONE probe
  request rides through; concurrent arrivals still shed) → CLOSED on
  success, or re-OPEN with the backoff doubled (capped at
  ``backoff_max_s``).  A probe that exits WITHOUT a health verdict
  (overload shed, unknown model, client budget already spent) hands its
  ticket back so the next arrival probes — the ticket can never leak
  and wedge the breaker in HALF_OPEN.  Every transition lands in the
  ``"fleet"`` telemetry stream via the manager's recorder.
* **Retry budget** — a request carries ONE deadline end-to-end.
  Retryable errors (``ServingNonFinite``, device-stage
  ``RequestTimeout``) are retried with doubling backoff only while
  deadline budget remains; queue-stage timeouts and overloads are never
  retried (the retry would land in the same full queue), and no retry
  ever starts after the budget is spent.
* **Shed accounting** — breaker and overload rejections count as
  ``requests_shed``, not admitted traffic, so the soak's admitted-p99
  bound stays meaningful while one model is being chaos-wedged.

The HTTP server is deliberately stdlib-``http.server`` line-JSON (the
``dispatch/master.py`` discipline): POST ``/v1/infer`` with
``{"model": ..., "inputs": {name: rows}, "timeout_s": ...}``; GET
``/v1/models`` / ``/v1/stats`` / ``/v1/healthz``.  Error mapping:
overload → 429, open breaker → 503 (+``retry_after_s``), deadline →
504, unknown model → 404, non-finite → 502.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .. import faults
from .. import telemetry
from .engine import (SERVING_SCOPE, RequestTimeout, ServingClosed,
                     ServingError, ServingNonFinite, ServingOverloaded)
from .fleet import FLEET_SCOPE, SITE_ADMIT, EngineManager

__all__ = ["CircuitBreaker", "CircuitOpen", "FrontDoor", "FleetHTTPServer"]


class CircuitOpen(ServingError):
    """The model's circuit breaker is open: the request was shed at the
    front door without touching the backend.  ``retry_after_s`` is the
    remaining backoff — the client's hint, and the HTTP ``Retry-After``
    source."""

    def __init__(self, msg: str, model: str = "",
                 retry_after_s: float = 0.0):
        super().__init__(msg)
        self.model = model
        self.retry_after_s = float(retry_after_s)


class CircuitBreaker:
    """One model's failure-isolation state machine (see module doc for
    the CLOSED/OPEN/HALF_OPEN protocol).  Thread-safe; ``on_event(event,
    **fields)`` fires on every transition — the FrontDoor points it at
    the manager's fleet recorder."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, model: str, threshold: int = 5,
                 backoff_s: float = 0.25, backoff_max_s: float = 8.0,
                 on_event=None):
        self.model = model
        self.threshold = max(1, int(threshold))
        self.base_backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.on_event = on_event
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.failures = 0            # consecutive, CLOSED state only
        self.backoff_s = self.base_backoff_s
        self.opened_at = 0.0
        self._probing = False        # the single HALF_OPEN ticket
        self.trips = 0
        self._open_s_total = 0.0     # closed-out OPEN time (SLO source)

    def _emit(self, event: str, **fields):
        if self.on_event is not None:
            self.on_event(event, model=self.model, state=self.state,
                          **fields)

    # ---------------------------------------------------------- admission
    def admit(self) -> bool:
        """Gate one request.  CLOSED admits; OPEN sheds with
        :class:`CircuitOpen` until the backoff elapses, then flips to
        HALF_OPEN and admits exactly one probe (everyone else keeps
        shedding until the probe reports).  Returns True when THIS
        caller holds the probe ticket: the caller MUST resolve it —
        ``record_success``/``record_failure``, or :meth:`abort_probe`
        when the request never produced a health signal (shed, unknown
        model) — or the breaker wedges in HALF_OPEN forever."""
        with self._lock:
            if self.state == self.CLOSED:
                return False
            remaining = self.opened_at + self.backoff_s - time.monotonic()
            if self.state == self.OPEN and remaining <= 0.0:
                self._open_s_total += time.monotonic() - self.opened_at
                self.state = self.HALF_OPEN
                self._probing = False
                self._emit("breaker-half-open",
                           backoff_s=round(self.backoff_s, 4))
            if self.state == self.HALF_OPEN and not self._probing:
                self._probing = True    # this caller IS the probe
                return True
            raise CircuitOpen(
                f"circuit open for model {self.model!r}; retry after "
                f"{max(0.0, remaining):.3f}s", model=self.model,
                retry_after_s=max(0.0, remaining))

    def abort_probe(self):
        """Hand back an unresolved probe ticket: the probe exited without
        a health verdict (overload shed, unknown model, spent budget), so
        the NEXT arrival becomes the probe instead of the ticket being
        lost with the breaker stuck in HALF_OPEN shedding everything."""
        with self._lock:
            if self.state == self.HALF_OPEN and self._probing:
                self._probing = False

    # ------------------------------------------------------------ outcomes
    def record_success(self):
        with self._lock:
            if self.state == self.HALF_OPEN:
                self.state = self.CLOSED
                self.backoff_s = self.base_backoff_s
                self._emit("breaker-close",
                           backoff_s=round(self.backoff_s, 4))
            self.failures = 0
            self._probing = False

    def record_failure(self, error: Optional[BaseException] = None):
        err = f"{type(error).__name__}: {error}" if error else None
        with self._lock:
            if self.state == self.HALF_OPEN:
                # the probe failed: re-open with the backoff doubled
                self.state = self.OPEN
                self.opened_at = time.monotonic()
                self.backoff_s = min(self.backoff_max_s,
                                     self.backoff_s * 2.0)
                self._probing = False
                self.trips += 1
                self._emit("breaker-trip", probe=True,
                           backoff_s=round(self.backoff_s, 4), error=err)
                return
            self.failures += 1
            if self.state == self.CLOSED \
                    and self.failures >= self.threshold:
                self.state = self.OPEN
                self.opened_at = time.monotonic()
                self._probing = False
                self.trips += 1
                self._emit("breaker-trip", probe=False,
                           consecutive_failures=self.failures,
                           backoff_s=round(self.backoff_s, 4), error=err)

    def open_seconds(self) -> float:
        """Cumulative wall time this breaker has spent OPEN (an ongoing
        OPEN period counts up live) — the SLO page's outage clock."""
        with self._lock:
            t = self._open_s_total
            if self.state == self.OPEN:
                t += max(0.0, time.monotonic() - self.opened_at)
            return t

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "backoff_s": round(self.backoff_s, 4),
                    "trips": self.trips}


class FrontDoor:
    """The request path in front of an :class:`EngineManager`: fault-site
    admission, per-model breaker, deadline-bounded retry.

    ``infer(model, inputs, timeout_s=...)`` is the programmatic surface;
    :class:`FleetHTTPServer` exposes the same path over HTTP.  Breaker
    knobs apply to every model's breaker (created lazily on first
    request)."""

    def __init__(self, manager: EngineManager, *,
                 breaker_threshold: int = 5,
                 breaker_backoff_s: float = 0.25,
                 breaker_backoff_max_s: float = 8.0,
                 max_retries: int = 2, retry_backoff_s: float = 0.01,
                 default_timeout_s: float = 30.0):
        self.manager = manager
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_backoff_s = float(breaker_backoff_s)
        self.breaker_backoff_max_s = float(breaker_backoff_max_s)
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.default_timeout_s = float(default_timeout_s)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ breakers
    def _on_breaker_event(self, event: str, **fields):
        # breaker transitions ride the manager's fleet stream (one writer
        # per process) and bump the fleet-scope counters
        self.manager.record(event, **fields)
        if event == "breaker-trip":
            self.manager._inc("breaker_trips")
        elif event == "breaker-half-open":
            self.manager._inc("breaker_half_opens")
        elif event == "breaker-close":
            self.manager._inc("breaker_closes")

    def breaker(self, model: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(model)
            if br is None:
                br = CircuitBreaker(
                    model, threshold=self.breaker_threshold,
                    backoff_s=self.breaker_backoff_s,
                    backoff_max_s=self.breaker_backoff_max_s,
                    on_event=self._on_breaker_event)
                self._breakers[model] = br
            return br

    def breakers(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {m: b.snapshot()
                    for m, b in sorted(self._breakers.items())}

    # ------------------------------------------------------------- request
    @staticmethod
    def _retryable(e: BaseException) -> bool:
        # device-stage timeout = backend trouble worth another shot once
        # the backend recovers; queue-stage timeout/overload = shedding,
        # a retry would pile onto the same full queue
        if isinstance(e, ServingNonFinite):
            return True
        return isinstance(e, RequestTimeout) and e.where == "device"

    def infer(self, model: str, inputs: Dict[str, Any],
              timeout_s: Optional[float] = None) -> List[np.ndarray]:
        """One admitted request: fire the admission fault site, pass the
        model's breaker, then run with bounded retry under ONE deadline.
        Raises :class:`CircuitOpen` (shed, breaker open),
        :class:`ServingOverloaded` (shed, queue full — passes through
        untouched and untripped), :class:`RequestTimeout`,
        :class:`ServingNonFinite`, or ``KeyError`` (unknown model).

        Tracing: the whole call runs under one front-door span (child of
        the caller's context — the HTTP server span — or a fresh root
        when none), each attempt under its own child span, so the engine
        request spans minted downstream hang off the attempt that
        submitted them and breaker verdicts land inside the trace."""
        return self._request(
            model, "infer",
            lambda budget: self.manager.infer(model, inputs,
                                              timeout=budget),
            timeout_s)

    def generate(self, model: str, prompt,
                 max_new_tokens: Optional[int] = None,
                 timeout_s: Optional[float] = None):
        """One admitted generation through ``model``'s decode engine:
        the same breaker / deadline / shed policy as :meth:`infer`, the
        same trace shape.  Decode-stage and queue-stage timeouts are
        never retried — a generation that ran out of deadline mid-stream
        would restart from token zero into the same full engine; only a
        poisoned output (:class:`ServingNonFinite`) is worth one clean
        re-run.  Returns a
        :class:`~paddle_tpu_torch.serving.decode.DecodeResult`."""
        return self._request(
            model, "generate",
            lambda budget: self.manager.generate(
                model, prompt, max_new_tokens=max_new_tokens,
                timeout=budget),
            timeout_s)

    def _request(self, model: str, op: str, call,
                 timeout_s: Optional[float]):
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        with telemetry.start_span(root=True) as span:
            t0 = time.perf_counter()
            try:
                out = self._attempt_loop(model, call, timeout_s)
            except BaseException as e:
                # final-outcome accounting for the SLO surface: sheds
                # (breaker, overload) are admission doing its job, not
                # availability loss; anything else is a failed request
                # even if retries were attempted along the way
                if not isinstance(e, (CircuitOpen, ServingOverloaded)):
                    self.manager._inc("frontdoor_requests")
                    self.manager._inc("frontdoor_errors")
                if span is not None:
                    self.manager.record(
                        "frontdoor", model=model, op=op,
                        outcome=type(e).__name__,
                        latency_s=round(time.perf_counter() - t0, 6),
                        **span.fields())
                raise
            self.manager._inc("frontdoor_requests")
            if span is not None:
                self.manager.record(
                    "frontdoor", model=model, op=op, outcome="ok",
                    latency_s=round(time.perf_counter() - t0, 6),
                    **span.fields())
            return out

    def _attempt_loop(self, model: str, call, timeout_s: float):
        deadline = time.monotonic() + timeout_s
        traced = telemetry.current_trace() is not None
        faults.fire(SITE_ADMIT)
        br = self.breaker(model)
        try:
            probe = br.admit()
        except CircuitOpen:
            self.manager._inc("requests_shed")
            if traced:
                self.manager.record("breaker-shed", model=model,
                                    state=CircuitBreaker.OPEN)
            raise
        if traced:
            # the breaker's verdict for THIS request (transitions emit
            # their own records; admission normally doesn't) — the
            # "breaker decision" span node in the assembled trace
            self.manager.record("breaker-admit", model=model,
                                probe=probe, state=br.state)
        attempt = 0
        backoff = self.retry_backoff_s
        try:
            while True:
                budget = deadline - time.monotonic()
                if budget <= 0.0:
                    # the CLIENT's budget ran out before the backend was
                    # touched: not a health signal — a flood of
                    # zero-timeout requests must never open the breaker
                    # and shed other clients' traffic
                    raise RequestTimeout(
                        f"deadline budget spent before attempt "
                        f"{attempt + 1} for model {model!r}",
                        where="queue")
                with telemetry.start_span() as att:
                    if att is not None:
                        self.manager.record(
                            "attempt", model=model, attempt=attempt + 1,
                            budget_s=round(budget, 6), **att.fields())
                    try:
                        out = call(budget)
                    except ServingOverloaded:
                        # load shed, not a health signal: no trip, no
                        # retry
                        self.manager._inc("requests_shed")
                        raise
                    except KeyError:
                        raise
                    except BaseException as e:  # noqa: BLE001 — policy
                        br.record_failure(e)
                        probe = False
                        attempt += 1
                        remaining = deadline - time.monotonic()
                        if not self._retryable(e) \
                                or attempt > self.max_retries \
                                or remaining <= backoff:
                            raise
                        self.manager._inc("requests_retried")
                        if att is not None:
                            # the backoff sleep is charged to the trace
                            # explicitly: it is front-door wait, not
                            # backend time
                            self.manager.record(
                                "retry-backoff", model=model,
                                attempt=attempt,
                                backoff_s=round(backoff, 6),
                                error=type(e).__name__)
                        time.sleep(backoff)
                        backoff *= 2.0
                        continue
                    br.record_success()
                    probe = False
                    return out
        finally:
            if probe:
                # every exit path must resolve the HALF_OPEN probe
                # ticket: verdict-less exits (overload shed, unknown
                # model, spent budget) hand it back so the next arrival
                # probes instead of the breaker blackholing the model
                br.abort_probe()

    def stats(self) -> Dict[str, Any]:
        s = self.manager.stats()
        s["breakers"] = self.breakers()
        return s

    def slo(self) -> Dict[str, Any]:
        """The front door's SLO summary (``GET /v1/slo``): availability
        over admitted traffic, admitted p99 latency vs the default
        deadline, cumulative breaker-open seconds per model, and the
        shed rate.  All of it comes from the always-on metrics registry
        and the breakers — no JSONL reads, safe to poll."""
        reg = telemetry.REGISTRY
        admitted = reg.counter("requests", scope=SERVING_SCOPE).value
        expired = reg.counter("requests_expired",
                              scope=SERVING_SCOPE).value
        nonfinite = reg.counter("requests_nonfinite",
                                scope=SERVING_SCOPE).value
        shed = reg.counter("requests_shed", scope=FLEET_SCOPE).value
        retried = reg.counter("requests_retried",
                              scope=FLEET_SCOPE).value
        # availability is a FINAL-outcome ratio: a request that retried
        # and then succeeded is available.  The front-door counters see
        # one increment per completed request; the engine-scope attempt
        # counters (expired/nonfinite) stay visible as raw error volume.
        fd_total = reg.counter("frontdoor_requests",
                               scope=FLEET_SCOPE).value
        fd_errors = reg.counter("frontdoor_errors",
                                scope=FLEET_SCOPE).value
        errors = expired + nonfinite
        total = admitted + shed
        lat = reg.histogram("request_latency_s", scope=SERVING_SCOPE)
        p99 = lat.percentile(0.99) if lat.count else 0.0
        with self._lock:
            brs = sorted(self._breakers.items())
        open_s = {m: round(b.open_seconds(), 3) for m, b in brs}
        return {
            "requests_total": total,
            "requests_admitted": admitted,
            "requests_shed": shed,
            "requests_retried": retried,
            "requests_errored": errors,
            "requests_failed": fd_errors,
            "availability": round((fd_total - fd_errors) / fd_total, 6)
            if fd_total else 1.0,
            "shed_rate": round(shed / total, 6) if total else 0.0,
            "admitted_p99_s": round(p99, 6),
            "deadline_s": self.default_timeout_s,
            "p99_within_deadline": p99 <= self.default_timeout_s,
            "breaker_open_s": open_s,
            "breaker_open_s_total": round(sum(open_s.values()), 3),
        }


# ------------------------------------------------------------------ HTTP

def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(f"not JSON serializable: {type(o)}")


class FleetHTTPServer:
    """The stdlib HTTP surface over a :class:`FrontDoor` (line-JSON over
    ``http.server``, the dispatch-master discipline: zero dependencies,
    one thread per connection).

    * ``POST /v1/infer`` — body ``{"model": str, "inputs": {feed:
      rows}, "timeout_s": float?}``; 200 with ``{"outputs": [...],
      "model": ..., "latency_s": ...}``.  The body's ``timeout_s`` IS
      the end-to-end deadline — it propagates through the breaker, the
      retry budget and the engine.
    * ``POST /v1/generate`` — body ``{"model": str, "prompt": [ids],
      "max_new_tokens": int?, "timeout_s": float?}`` routed to the
      model's continuous-batching decode engine; 200 with ``{"tokens":
      [...], "reason": ..., "ttft_s": ..., "latency_s": ...}``.
    * ``GET /v1/models`` / ``GET /v1/stats`` / ``GET /v1/healthz``.
    * ``GET /metrics`` — the process :data:`~paddle_tpu_torch.telemetry.REGISTRY`
      in Prometheus text exposition format.
    * ``GET /v1/slo`` — :meth:`FrontDoor.slo`: availability, admitted
      p99 vs deadline, breaker-open seconds, shed rate.
    * ``POST /v1/infer`` accepts a W3C ``traceparent`` header (and
      always echoes one back when tracing is active): the server span
      it opens parents the front-door/attempt/request spans below it.
    """

    def __init__(self, frontdoor: FrontDoor, host: str = "127.0.0.1",
                 port: int = 0):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        fd = frontdoor

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):   # quiet: telemetry is the log
                pass

            def _reply(self, code: int, payload: Dict[str, Any],
                       headers: Optional[Dict[str, str]] = None):
                body = (json.dumps(payload, default=_json_default)
                        + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_text(self, code: int, text: str,
                            content_type: str):
                body = text.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/v1/models":
                    self._reply(200, {"models": fd.manager.models(),
                                      "breakers": fd.breakers()})
                elif self.path == "/v1/stats":
                    self._reply(200, fd.stats())
                elif self.path == "/metrics":
                    self._reply_text(
                        200, telemetry.prometheus_text(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif self.path == "/v1/slo":
                    self._reply(200, fd.slo())
                elif self.path == "/v1/healthz":
                    open_models = [m for m, b in fd.breakers().items()
                                   if b["state"] != CircuitBreaker.CLOSED]
                    code = 200 if not open_models else 503
                    self._reply(code, {"ok": not open_models,
                                       "models": sorted(
                                           fd.manager.models()),
                                       "breakers_open": open_models})
                else:
                    self._reply(404, {"error": "not found",
                                      "path": self.path})

            def do_POST(self):
                if self.path not in ("/v1/infer", "/v1/generate"):
                    self._reply(404, {"error": "not found",
                                      "path": self.path})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    model = req["model"]
                    if self.path == "/v1/infer":
                        inputs = {k: np.asarray(v)
                                  for k, v in req["inputs"].items()}
                    else:
                        prompt = np.asarray(req["prompt"], dtype=np.int64)
                        max_new = req.get("max_new_tokens")
                        if max_new is not None:
                            max_new = int(max_new)
                    timeout_s = req.get("timeout_s")
                    if timeout_s is not None:
                        timeout_s = float(timeout_s)
                        if not timeout_s > 0.0:   # rejects 0, <0 and NaN
                            raise ValueError(
                                f"timeout_s must be > 0, got {timeout_s}")
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                # HTTP admit span: adopt the client's traceparent (the
                # remote context becomes the parent) or mint a fresh
                # root when tracing is on; the same context is echoed
                # back in the response header either way so the caller
                # can join its side of the story to ours
                remote = telemetry.TraceContext.from_traceparent(
                    self.headers.get("traceparent"))
                with telemetry.start_span(parent=remote,
                                          root=True) as span:
                    hdrs = {"traceparent": span.to_traceparent()} \
                        if span is not None else {}
                    t0 = time.perf_counter()
                    if span is not None:
                        fd.manager.record(
                            "http", path=self.path, model=model,
                            **span.fields())
                    try:
                        if self.path == "/v1/infer":
                            out = fd.infer(model, inputs,
                                           timeout_s=timeout_s)
                        else:
                            out = fd.generate(model, prompt,
                                              max_new_tokens=max_new,
                                              timeout_s=timeout_s)
                    except CircuitOpen as e:
                        hdrs["Retry-After"] = f"{e.retry_after_s:.3f}"
                        self._reply(503, {
                            "error": str(e), "model": model,
                            "code": "circuit_open",
                            "retry_after_s": e.retry_after_s}, hdrs)
                    except ServingOverloaded as e:
                        self._reply(429, {"error": str(e),
                                          "model": model,
                                          "code": "overloaded"}, hdrs)
                    except RequestTimeout as e:
                        self._reply(504, {"error": str(e),
                                          "model": model,
                                          "code": "timeout",
                                          "where": e.where}, hdrs)
                    except ServingNonFinite as e:
                        self._reply(502, {"error": str(e),
                                          "model": model,
                                          "code": "non_finite"}, hdrs)
                    except KeyError as e:
                        self._reply(404, {"error": f"unknown model: "
                                                   f"{e}",
                                          "model": model}, hdrs)
                    except ServingClosed as e:
                        self._reply(503, {"error": str(e),
                                          "model": model,
                                          "code": "closed"}, hdrs)
                    except (TypeError, ServingError) as e:
                        # wrong engine kind for the path, or request
                        # validation (e.g. prompt + max_new_tokens over
                        # the decode engine's max_seq_len)
                        self._reply(400, {"error": str(e),
                                          "model": model}, hdrs)
                    except Exception as e:  # noqa: BLE001 — edge
                        self._reply(500, {"error":
                                          f"{type(e).__name__}: {e}",
                                          "model": model}, hdrs)
                    else:
                        if self.path == "/v1/infer":
                            self._reply(200, {
                                "model": model, "outputs": out,
                                "latency_s": round(
                                    time.perf_counter() - t0, 6)}, hdrs)
                        else:
                            self._reply(200, {
                                "model": model,
                                "tokens": out.tokens,
                                "reason": out.reason,
                                "n_tokens": out.n_tokens,
                                "ttft_s": round(out.ttft_s, 6),
                                "latency_s": round(
                                    time.perf_counter() - t0, 6)}, hdrs)

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "FleetHTTPServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="paddle_tpu_torch-fleet-http")
        self._thread.start()
        return self

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False
