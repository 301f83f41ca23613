"""EngineManager: the multi-model serving fleet behind the front door, as
the JAX package's ``serving/fleet.py`` defines it.

One process serves MANY models: each loaded model owns its own
:class:`~paddle_tpu_torch.serving.session.ServingSession` (its own Inferencer,
pinned scope, batching engine and bucket set), keyed by name, with a
monotonically increasing version per slot.  The manager adds the three
fleet-grade properties the single-session facade cannot:

* **Admission before compile** — ``load``/``swap`` against a
  checkpoint-manifest directory run the static memory planner's M501
  restore-fit (:func:`paddle_tpu_torch.checkpoint.restore_fit_dir`)
  BEFORE the Inferencer is built: a model whose predicted per-device peak
  exceeds the manager's budget is rejected with a structured
  :class:`ModelRejected` (carrying the predicted/budget bytes) without
  paying a capture or a device byte.
* **Health-gated hot swap** — ``swap`` builds the replacement session
  OFF the serving path first (its warmup builds every bucket's cache
  entry: on the card one CUDA graph each), runs a canary inference
  through the new engine, and only then flips the slot atomically under
  the manager lock.  A failed canary closes the new session and leaves
  the old one serving — rollback is the default, not a recovery
  procedure — with a structured ``swap-rollback`` event.  The displaced
  session drains its in-flight batches before its executables are
  dropped.
* **Per-model chaos isolation** — every session is built with
  ``fault_site="serving.backend.<name>"`` so a chaos plan
  (:mod:`paddle_tpu_torch.faults`) can wedge, poison or kill ONE model's
  backend while its fleet-mates keep serving bit-identical results; the
  front door's circuit breaker turns that isolation into graceful
  degradation.

Every state transition (load / reject / swap / canary-fail rollback /
close — plus the breaker transitions the front door reports through
:meth:`EngineManager.record`) lands in the ``"fleet"`` metric scope and
in ``fleet_<pid>.jsonl`` under ``PADDLE_TPU_TELEMETRY_DIR``, the stream
``tools/stats.py`` and ``tools/health_report.py`` read.

Every session and engine the manager builds runs on its ``place``
(``None``: ``CUDAPlace(0)``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import faults, telemetry
from ..telemetry import REGISTRY
from .engine import ServingClosed, ServingError
from .session import ServingSession

__all__ = ["EngineManager", "ModelRejected", "SwapFailed", "FLEET_SCOPE",
           "FLEET_RECORDS"]

FLEET_SCOPE = "fleet"

#: every fleet state transition flows through one process-wide stream ->
#: fleet_<pid>.jsonl under the telemetry dir (shared by EngineManager and
#: the FrontDoor breaker events — ONE writer per process, so records from
#: both layers interleave in order instead of tearing across two files)
FLEET_RECORDS = telemetry.StepTelemetry(capacity=2048, prefix="fleet")

# the fleet's injection sites, registered at import so chaos specs can be
# written against the catalogue (faults.sites()) before any model loads
SITE_ADMIT = faults.register_site(
    "serving.admit", "front-door admission of each request (fail = an "
                     "admission-layer outage; delay = a slow edge)")
SITE_SWAP = faults.register_site(
    "serving.swap", "each hot-swap canary (fail = a poisoned candidate "
                    "the health gate must roll back)")
SITE_BACKEND = faults.register_site(
    "serving.backend", "each dispatched batch of every fleet model "
                       "(per-model: serving.backend.<name>)")


class ModelRejected(ServingError):
    """Admission control rejected a model load/swap: the static memory
    planner predicts its per-device peak exceeds the fleet budget (code
    ``M501``), surfaced BEFORE any compile.  Carries ``model``,
    ``predicted_peak_bytes`` and ``budget_bytes``."""

    code = "M501"

    def __init__(self, msg: str, model: str = "",
                 predicted_peak_bytes: int = 0, budget_bytes: int = 0):
        super().__init__(msg)
        self.model = model
        self.predicted_peak_bytes = int(predicted_peak_bytes)
        self.budget_bytes = int(budget_bytes)


class SwapFailed(ServingError):
    """A hot swap's canary inference failed: the candidate session was
    closed and the PREVIOUS version is still serving (rollback already
    happened when this raises).  ``cause`` holds the canary's error."""

    def __init__(self, msg: str, model: str = "",
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.model = model
        self.cause = cause


class _Slot:
    __slots__ = ("name", "session", "version", "param_path", "kind")

    def __init__(self, name: str, session, version: int,
                 param_path: Optional[str], kind: str = "infer"):
        self.name = name
        self.session = session      # ServingSession or DecodeEngine
        self.version = version
        self.param_path = param_path
        self.kind = kind


class EngineManager:
    """The multi-model engine registry: load / swap / route / drain.

    ``memory_budget`` is both the per-model admission budget (M501
    restore-fit against manifest checkpoints) and the default executor
    budget handed to each session.  Per-call ``load``/``swap`` kwargs
    pass through to :class:`ServingSession` (max_batch_size, buckets,
    passes, amp, ...).  ``place`` is where every session and decode
    engine runs unless a call passes its own (``None``: ``CUDAPlace(0)``).
    """

    def __init__(self, memory_budget=None, place=None):
        self.memory_budget = memory_budget
        self.place = place
        self._slots: Dict[str, _Slot] = {}
        self._lock = threading.RLock()
        self._closed = False
        # "fleet"-scope metrics, pre-registered so snapshot() always
        # shows the full picture
        for name in ("loads", "rejects", "swaps", "swap_rollbacks",
                     "requests_routed", "breaker_trips",
                     "breaker_half_opens", "breaker_closes",
                     "requests_shed", "requests_retried",
                     "frontdoor_requests", "frontdoor_errors"):
            REGISTRY.counter(name, scope=FLEET_SCOPE)
        self._g_models = REGISTRY.gauge("models_loaded", scope=FLEET_SCOPE)

    # ------------------------------------------------------------ telemetry
    @staticmethod
    def record(kind: str, **fields):
        """Append one structured record to the fleet stream
        (``fleet_<pid>.jsonl``).  Public: the front door reports breaker
        transitions through the SAME stream so swap and trip events
        interleave in causal order."""
        FLEET_RECORDS.record(kind=kind, **fields)

    @staticmethod
    def _inc(name: str, n: int = 1):
        REGISTRY.counter(name, scope=FLEET_SCOPE).inc(n)

    # ------------------------------------------------------------ admission
    def _admit(self, name: str, param_path: Optional[str]):
        """The M501 pre-flight: against a manifest-checkpoint directory
        with a budget set, predict the restore's per-device peak BEFORE
        building the Inferencer.  Non-manifest paths (flat param dirs)
        pass through — their per-bucket peaks are still budget-checked at
        warmup by the session itself."""
        if param_path is None or self.memory_budget is None:
            return None
        from ..checkpoint import restore_fit_dir
        from ..checkpoint.manifest import try_read_manifest
        if try_read_manifest(param_path) is None:
            return None
        from ..analysis.memory import PredictedOOMError
        try:
            return restore_fit_dir(param_path, budget=self.memory_budget)
        except PredictedOOMError as e:
            self._inc("rejects")
            self.record("reject", model=name, code="M501",
                        predicted_peak_bytes=e.plan.peak_bytes,
                        budget_bytes=e.budget, error=str(e))
            raise ModelRejected(
                f"model {name!r} rejected by admission control: {e}",
                model=name, predicted_peak_bytes=e.plan.peak_bytes,
                budget_bytes=e.budget) from e

    def _build_session(self, name: str, infer_func, param_path,
                       **session_kw) -> ServingSession:
        session_kw.setdefault("memory_budget", self.memory_budget)
        session_kw.setdefault("place", self.place)
        return ServingSession(infer_func=infer_func,
                              param_path=param_path,
                              fault_site=f"serving.backend.{name}",
                              **session_kw)

    def _build_decode(self, name: str, prefill_func, step_func,
                      param_path, **decode_kw):
        from .decode import DecodeEngine
        decode_kw.setdefault("memory_budget", self.memory_budget)
        decode_kw.setdefault("name", name)
        decode_kw.setdefault("place", self.place)
        return DecodeEngine(prefill_func, step_func,
                            param_path=param_path,
                            fault_site=f"serving.backend.{name}",
                            **decode_kw)

    # ------------------------------------------------------------ lifecycle
    def load(self, name: str, infer_func=None,
             param_path: Optional[str] = None, **session_kw) -> _Slot:
        """Admit (M501), build, warm and register a model under ``name``.
        Raises :class:`ModelRejected` over budget, ``ValueError`` when
        the name is already taken (use :meth:`swap` to replace)."""
        with self._lock:
            if self._closed:
                raise ServingError("manager is closed")
            if name in self._slots:
                raise ValueError(f"model {name!r} already loaded; use "
                                 f"swap() to replace it")
        fit = self._admit(name, param_path)
        session = self._build_session(name, infer_func, param_path,
                                      **session_kw)
        with self._lock:
            # re-check: the lock was dropped for the (slow) admit/build,
            # so a racing load() may have won the name or close() may
            # have shut the manager — inserting anyway would leak the
            # loser's session (device memory held, never drained)
            closed, taken = self._closed, name in self._slots
            if not closed and not taken:
                slot = _Slot(name, session, version=1,
                             param_path=param_path)
                self._slots[name] = slot
                self._g_models.set(len(self._slots))
        if closed or taken:
            session.close(drain=False)
            if closed:
                raise ServingError("manager is closed")
            raise ValueError(f"model {name!r} already loaded; use "
                             f"swap() to replace it")
        self._inc("loads")
        self.record("load", model=name, version=1, param_path=param_path,
                    buckets=list(session.buckets),
                    predicted_peak_bytes=(fit or {}).get("peak_bytes"),
                    budget_bytes=(fit or {}).get("budget_bytes"))
        return slot

    def swap(self, name: str, infer_func=None,
             param_path: Optional[str] = None,
             canary: Optional[Dict[str, Any]] = None,
             canary_timeout_s: float = 30.0, **session_kw) -> _Slot:
        """Health-gated hot swap: admit + build + warm the replacement
        OFF the serving path, canary it, then atomically flip traffic.

        The canary is one real inference through the NEW engine (a
        caller-supplied feed, or a synthesized 1-row zeros feed from the
        program's own signature).  Any canary failure — including a NaN
        guard trip or an injected ``serving.swap`` fault — closes the
        candidate, leaves the old version serving, records a
        ``swap-rollback`` event and raises :class:`SwapFailed`.  On
        success the flip is one dict store under the lock: requests
        admitted before it drain on the old engine (``close(drain=True)``
        after the flip), requests after it ride the new one."""
        with self._lock:
            old = self._slots.get(name)
            if old is None:
                raise KeyError(f"model {name!r} is not loaded; use load()")
            new_version = old.version + 1
        fit = self._admit(name, param_path)
        session = self._build_session(name, infer_func, param_path,
                                      **session_kw)
        try:
            faults.fire(SITE_SWAP)
            feed = canary if canary is not None else _canary_feed(session)
            session.infer(feed, timeout=canary_timeout_s)
        except BaseException as e:
            session.close(drain=False)
            self._inc("swap_rollbacks")
            self.record("swap-rollback", model=name,
                        version=new_version, param_path=param_path,
                        error=f"{type(e).__name__}: {e}")
            raise SwapFailed(
                f"hot swap of {name!r} -> v{new_version} rolled back: "
                f"canary failed with {type(e).__name__}: {e}",
                model=name, cause=e) from e
        with self._lock:
            old = None if self._closed else self._slots.get(name)
            if old is not None:
                # recompute under the flip lock: a concurrent swap may
                # have bumped the version during our warmup, and two
                # swaps must never mint the same version number
                new_version = old.version + 1
                slot = _Slot(name, session, new_version, param_path)
                self._slots[name] = slot
                self._g_models.set(len(self._slots))
        if old is None:
            # the slot vanished during warmup (unload() raced the
            # canary, or the manager closed): close the fully warmed
            # candidate rather than leak it, and report structured
            session.close(drain=False)
            self._inc("swap_rollbacks")
            self.record("swap-rollback", model=name,
                        param_path=param_path,
                        error="slot vanished during warmup "
                              "(unloaded or manager closed)")
            raise SwapFailed(
                f"hot swap of {name!r} aborted: the slot vanished "
                f"during warmup (unloaded or manager closed)",
                model=name)
        # the displaced engine finishes what it already admitted — the
        # drain happens AFTER the flip, so no request window is ownerless
        old.session.close(drain=True)
        self._inc("swaps")
        self.record("swap", model=name, version=new_version,
                    param_path=param_path, buckets=list(session.buckets),
                    predicted_peak_bytes=(fit or {}).get("peak_bytes"),
                    budget_bytes=(fit or {}).get("budget_bytes"),
                    fresh_compiles=session.inferencer.exe
                    .fresh_compile_count)
        return slot

    def load_decode(self, name: str, prefill_func, step_func,
                    param_path: Optional[str] = None,
                    **decode_kw) -> _Slot:
        """Admit (M501), build, warm and register a continuous-batching
        :class:`~paddle_tpu_torch.serving.decode.DecodeEngine` under ``name``.
        ``decode_kw`` passes through (``eos_id`` is required there);
        route requests with :meth:`generate`."""
        with self._lock:
            if self._closed:
                raise ServingError("manager is closed")
            if name in self._slots:
                raise ValueError(f"model {name!r} already loaded; use "
                                 f"swap_decode() to replace it")
        fit = self._admit(name, param_path)
        engine = self._build_decode(name, prefill_func, step_func,
                                    param_path, **decode_kw)
        with self._lock:
            closed, taken = self._closed, name in self._slots
            if not closed and not taken:
                slot = _Slot(name, engine, version=1,
                             param_path=param_path, kind="decode")
                self._slots[name] = slot
                self._g_models.set(len(self._slots))
        if closed or taken:
            engine.close(drain=False)
            if closed:
                raise ServingError("manager is closed")
            raise ValueError(f"model {name!r} already loaded; use "
                             f"swap_decode() to replace it")
        self._inc("loads")
        self.record("load", model=name, engine="decode", version=1,
                    param_path=param_path,
                    seq_buckets=list(engine.seq_buckets),
                    batch_buckets=list(engine.batch_buckets),
                    executables_warmed=len(engine.warmup_reports),
                    pool_bytes=engine.memory_plan.get("pool_bytes"),
                    predicted_peak_bytes=(fit or {}).get("peak_bytes"),
                    budget_bytes=(fit or {}).get("budget_bytes"))
        return slot

    def swap_decode(self, name: str, prefill_func, step_func,
                    param_path: Optional[str] = None,
                    canary_timeout_s: float = 30.0,
                    **decode_kw) -> _Slot:
        """Health-gated hot swap of a decode slot: the replacement engine
        warms every (phase × batch × seqlen) executable OFF the serving
        path, generates one canary token, then the slot flips atomically.
        Requests admitted on the old engine drain there; a failed canary
        rolls back exactly like :meth:`swap`."""
        with self._lock:
            old = self._slots.get(name)
            if old is None:
                raise KeyError(f"model {name!r} is not loaded; use "
                               f"load_decode()")
            new_version = old.version + 1
        fit = self._admit(name, param_path)
        engine = self._build_decode(name, prefill_func, step_func,
                                    param_path, **decode_kw)
        try:
            faults.fire(SITE_SWAP)
            engine.canary()
        except BaseException as e:
            engine.close(drain=False)
            self._inc("swap_rollbacks")
            self.record("swap-rollback", model=name, engine="decode",
                        version=new_version, param_path=param_path,
                        error=f"{type(e).__name__}: {e}")
            raise SwapFailed(
                f"hot swap of decode model {name!r} -> v{new_version} "
                f"rolled back: canary failed with "
                f"{type(e).__name__}: {e}", model=name, cause=e) from e
        with self._lock:
            old = None if self._closed else self._slots.get(name)
            if old is not None:
                new_version = old.version + 1
                slot = _Slot(name, engine, new_version, param_path,
                             kind="decode")
                self._slots[name] = slot
                self._g_models.set(len(self._slots))
        if old is None:
            engine.close(drain=False)
            self._inc("swap_rollbacks")
            self.record("swap-rollback", model=name, engine="decode",
                        param_path=param_path,
                        error="slot vanished during warmup "
                              "(unloaded or manager closed)")
            raise SwapFailed(
                f"hot swap of decode model {name!r} aborted: the slot "
                f"vanished during warmup (unloaded or manager closed)",
                model=name)
        # the displaced engine finishes every generation it admitted
        old.session.close(drain=True)
        self._inc("swaps")
        self.record("swap", model=name, engine="decode",
                    version=new_version, param_path=param_path,
                    seq_buckets=list(engine.seq_buckets),
                    batch_buckets=list(engine.batch_buckets),
                    executables_warmed=len(engine.warmup_reports),
                    predicted_peak_bytes=(fit or {}).get("peak_bytes"),
                    budget_bytes=(fit or {}).get("budget_bytes"),
                    fresh_compiles=engine.fresh_compiles_since_warmup)
        return slot

    def unload(self, name: str, drain: bool = True):
        """Remove a model and drain its engine."""
        with self._lock:
            slot = self._slots.pop(name, None)
            self._g_models.set(len(self._slots))
        if slot is None:
            raise KeyError(f"model {name!r} is not loaded")
        slot.session.close(drain=drain)
        self.record("unload", model=name, version=slot.version)

    # -------------------------------------------------------------- serving
    def session(self, name: str) -> ServingSession:
        with self._lock:
            slot = self._slots.get(name)
            loaded = sorted(self._slots)
        if slot is None:
            raise KeyError(f"model {name!r} is not loaded "
                           f"(loaded: {loaded})")
        if slot.kind != "infer":
            raise TypeError(f"model {name!r} is a {slot.kind!r} engine; "
                            f"route it through generate()")
        return slot.session

    def infer(self, name: str, inputs: Dict[str, Any],
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """Route one request to ``name``'s current engine.  Thread-safe;
        a concurrent swap is invisible beyond which version serves it."""
        session = self.session(name)
        self._inc("requests_routed")
        try:
            return session.infer(inputs, timeout=timeout)
        except ServingClosed:
            # a hot swap closed the displaced engine between our slot
            # lookup and the submit — route once more to the CURRENT
            # slot; only a genuinely closed model re-raises
            current = self.session(name)
            if current is session:
                raise
            return current.infer(inputs, timeout=timeout)

    def decode_engine(self, name: str):
        """The current :class:`DecodeEngine` behind a decode slot."""
        with self._lock:
            slot = self._slots.get(name)
            loaded = sorted(self._slots)
        if slot is None:
            raise KeyError(f"model {name!r} is not loaded "
                           f"(loaded: {loaded})")
        if slot.kind != "decode":
            raise TypeError(f"model {name!r} is a {slot.kind!r} engine; "
                            f"route it through infer()")
        return slot.session

    def generate(self, name: str, prompt,
                 max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None):
        """Route one generation to ``name``'s decode engine.  Like
        :meth:`infer`, a concurrent hot swap is invisible beyond which
        version serves it: a request that loses the race against the
        displaced engine's close is re-routed once to the new slot."""
        engine = self.decode_engine(name)
        self._inc("requests_routed")
        try:
            return engine.generate(prompt, max_new_tokens=max_new_tokens,
                                   timeout=timeout)
        except ServingClosed:
            current = self.decode_engine(name)
            if current is engine:
                raise
            return current.generate(prompt,
                                    max_new_tokens=max_new_tokens,
                                    timeout=timeout)

    def models(self) -> Dict[str, Dict[str, Any]]:
        """{name: {version, kind, param_path, buckets}} per loaded model
        (``buckets`` are a decode slot's seqlen slot buckets)."""
        with self._lock:
            return {n: {"version": s.version, "kind": s.kind,
                        "param_path": s.param_path,
                        "buckets": list(getattr(
                            s.session, "buckets",
                            getattr(s.session, "seq_buckets", ())))}
                    for n, s in sorted(self._slots.items())}

    def stats(self) -> Dict[str, Any]:
        """The ``"fleet"`` scope snapshot plus per-model session stats."""
        out: Dict[str, Any] = dict(REGISTRY.snapshot(scope=FLEET_SCOPE))
        with self._lock:
            slots = list(self._slots.values())
        out["models"] = {s.name: {"version": s.version, "kind": s.kind,
                                  **s.session.stats()} for s in slots}
        return out

    def close(self, drain: bool = True):
        """Drain and close every engine; further loads/infers fail."""
        with self._lock:
            self._closed = True
            slots, self._slots = list(self._slots.values()), {}
            self._g_models.set(0)
        for s in slots:
            s.session.close(drain=drain)
        self.record("close", models=[s.name for s in slots])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _canary_feed(session: ServingSession,
                 rows: int = 1) -> Dict[str, np.ndarray]:
    """A 1-row zeros feed synthesized from the program's own data-var
    signature (the warmup convention: only the signature matters for
    "does this engine produce a finite answer")."""
    feed: Dict[str, np.ndarray] = {}
    for v in session.inferencer._feed_vars():
        shape = (rows,) + tuple(int(d) for d in tuple(v.shape)[1:])
        if any(d < 0 for d in shape):
            raise ValueError(
                f"feed {v.name!r} has dynamic non-batch dims; pass an "
                f"explicit canary= feed to swap()")
        feed[v.name] = np.zeros(shape, dtype=v.dtype.np_dtype)
    return feed
