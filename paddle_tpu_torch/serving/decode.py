"""Token-level continuous batching for autoregressive decode, as the JAX
package's ``serving/decode.py`` defines it.

The :class:`~paddle_tpu_torch.serving.engine.BatchingEngine` coalesces
fixed-shape one-shot infer; a generative model run through it pays one
full-batch dispatch per token with head-of-line blocking on the longest
prompt.  :class:`DecodeEngine` is the autoregressive counterpart:
iteration-level scheduling (Orca, OSDI'22) over a paged, bucketed
KV-cache pool (vLLM, SOSP'23), built from the rest of the serving stack:
``Executor.precompile`` warmup (on the card one CUDA graph for each
program and feed signature), pow2 bucketing, ``plan_memory`` admission,
hosting behind :class:`~paddle_tpu_torch.serving.fleet.EngineManager`,
and the trace contexts of the ``telemetry`` module.

Model contract: two build functions over the layers API.

* ``prefill_func(max_len)`` builds the prompt-ingest program for one
  pow2 prompt bucket: returns ``((ids, lens), (token0, [state0...]))``
  where ``ids`` is an int64 ``[N, max_len]`` feed, ``lens`` an int32
  ``[N, 1]`` feed of true prompt lengths, ``token0`` the first generated
  token (``[N]`` greedy or ``[N, beam]``), and ``state0`` the initial
  decoder state (K/V caches ``[N, max_len, ...]``, or an RNN hidden
  ``[N, H]``).
* ``step_func()`` builds the single-token decode program ONCE with a
  dynamic cache-length axis: returns
  ``((token, pos, [state...]), (next_token, [state_out...]))``.
  ``pos`` is the int32 ``[N, 1]`` decode-loop position feed (``None``
  for positionless models such as RNN cells); state feeds whose
  non-batch axis is dynamic (``-1``) are the KV-cache slots.  The engine
  stamps them with the ``kv_cache_slots`` var attr, so the R401
  recompile-hazard check knows each distinct length is a pow2 slot
  bucket, not churn.

Both functions must create the SAME parameter set (shared by name; each
program is built under its own ``unique_name.guard()``, as ``Inferencer``
builds its program).

Scheduling: requests are admitted against the slot pool (one fixed-size
cache slot per request, bucketed pow2 by ``prompt_len +
max_new_tokens``, the pool sized up front and checked against
``memory_budget`` through ``plan_memory``).  Prompts prefill in their own
bucketed program, never inside the decode batch, and join the decode
loop at the next iteration boundary.  Every decode iteration re-forms
batches from live requests only (grouped by slot bucket, padded to a pow2
batch bucket), so EOS / max-token / deadline retirement frees a slot and
shrinks the dispatched shape at once; every (phase x batch-bucket x
seqlen-bucket) program is warmed through ``Executor.precompile`` at
construction, so membership churn is ``fresh_compiles == 0`` in steady
state (:meth:`DecodeEngine.fresh_compiles_since_warmup`).

The slot pool keeps its arenas as tensors on the engine's device: a
decode group's state feed is an ``index_select`` into a zero-padded batch,
its fetched state goes back with ``index_copy_``, a freed slot is zeroed
there.  The scheduler reads on the host only what it must: the next
tokens and the NaN guard's per-row verdict, one small copy a group.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..telemetry import REGISTRY
from ..core.dtypes import coerce_feed_dtype, convert_dtype
from .engine import (RequestTimeout, ServingClosed, ServingError,
                     ServingNonFinite, ServingOverloaded, pow2_buckets)

DECODE_SCOPE = "decode"

# VarDesc attr stamped on dynamic-length state feeds of adopted decode
# programs: the length axis only ever sees pow2 slot-bucket sizes, so the
# R401 recompile-hazard check treats it like a seq_len_buckets stamp.
KV_CACHE_ATTR = "kv_cache_slots"
# VarDesc attr stamped on the decode-loop position feed: a per-row int32
# tensor precisely so the loop counter never bakes into the executable.
DECODE_POS_ATTR = "decode_position"

_MIN_SEQ_BUCKET = 8
_OCC_HIST = (1, 2, 4, 8, 16, 32, 64, 128)


def seq_len_buckets(max_len: int, lo: int = _MIN_SEQ_BUCKET
                    ) -> Tuple[int, ...]:
    """Pow2 sequence-length buckets ``lo..pow2ceil(max_len)`` — the slot
    sizes of the paged cache pool and the prompt buckets of prefill."""
    if max_len < 1:
        raise ValueError("max_len must be >= 1")
    out, b = [], int(lo)
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


class DecodeResult:
    """One finished generation: ``tokens`` is ``[n_tokens]`` (greedy) or
    ``[n_tokens, beam]`` int64 — every token the request emitted,
    starting with prefill's; ``reason`` is the retirement cause
    (``eos`` / ``max_tokens``)."""

    __slots__ = ("tokens", "reason", "n_tokens", "ttft_s", "latency_s",
                 "queue_s", "prefill_s", "decode_s", "n_iterations")

    def __init__(self, tokens: np.ndarray, reason: str, ttft_s: float,
                 latency_s: float, queue_s: float, prefill_s: float,
                 decode_s: float, n_iterations: int):
        self.tokens = tokens
        self.reason = reason
        self.n_tokens = int(tokens.shape[0])
        self.ttft_s = ttft_s
        self.latency_s = latency_s
        self.queue_s = queue_s
        self.prefill_s = prefill_s
        self.decode_s = decode_s
        self.n_iterations = n_iterations

    def __repr__(self):
        return (f"DecodeResult(n_tokens={self.n_tokens}, "
                f"reason={self.reason!r}, ttft_s={self.ttft_s:.4f}, "
                f"latency_s={self.latency_s:.4f})")


class _StateSpec:
    """One decoder-state tensor: feed/fetch row layout and which axis (if
    any) is the slot-bucketed sequence axis."""

    __slots__ = ("name", "row_shape", "dtype", "seq_axis")

    def __init__(self, name: str, row_shape: Tuple[int, ...], dtype: str,
                 seq_axis: Optional[int]):
        self.name = name
        self.row_shape = row_shape      # per-row, -1 at seq_axis
        self.dtype = getattr(dtype, "value", dtype)
        self.seq_axis = seq_axis        # index into row_shape, or None

    def slot_shape(self, cap: int) -> Tuple[int, ...]:
        if self.seq_axis is None:
            return self.row_shape
        s = list(self.row_shape)
        s[self.seq_axis] = cap
        return tuple(s)

    def nbytes(self, cap: int) -> int:
        n = int(np.dtype(self.dtype).itemsize)
        for d in self.slot_shape(cap):
            n *= int(d)
        return n


class _SlotPool:
    """The paged KV-cache pool: per seq-bucket, ``n_slots`` fixed-size
    cache slots (one device arena per state tensor, ``[n_slots,
    *slot_shape]``).  A slot is allocated at prefill admission and freed
    at retirement, where it is zeroed, so a stale cache never leaks into
    a later tenant's attention window.  The arenas hold each state in the
    dtype it runs in (int64 narrows to int32, as feeds do); the byte
    counts are the declared dtypes', as the JAX pool's numpy arenas
    count them."""

    def __init__(self, buckets: Dict[int, int], specs: List[_StateSpec],
                 device: Optional[torch.device] = None):
        self.specs = specs
        self.device = torch.device("cpu") if device is None else device
        self.buckets = dict(sorted(buckets.items()))
        self._dtypes = [coerce_feed_dtype(convert_dtype(sp.dtype)).torch_dtype
                        for sp in specs]
        self._arenas: Dict[int, List[torch.Tensor]] = {}
        self._free: Dict[int, List[int]] = {}
        self._materialized = False

    def materialize(self):
        """Allocate the arenas (zeros).  Sizing probes build pools that
        are never used, so the device memory is taken only here."""
        if self._materialized:
            return
        for cap, n in self.buckets.items():
            self._arenas[cap] = [
                torch.zeros((n,) + sp.slot_shape(cap), dtype=dt, device=self.device)
                for sp, dt in zip(self.specs, self._dtypes)]
            self._free[cap] = list(range(n - 1, -1, -1))
        self._materialized = True

    def total_bytes(self) -> int:
        return sum(n * self.bytes_per_slot(cap) for cap, n in self.buckets.items())

    def bytes_per_slot(self, cap: int) -> int:
        return sum(sp.nbytes(cap) for sp in self.specs)

    def counts(self) -> Dict[int, Tuple[int, int]]:
        """{bucket: (in_use, total)}"""
        return {cap: (n - len(self._free[cap]), n)
                for cap, n in self.buckets.items()}

    def in_use(self) -> int:
        return sum(u for u, _ in self.counts().values())

    def alloc(self, need: int) -> Optional[Tuple[int, int]]:
        """Smallest free slot with capacity >= need (falling back to
        larger buckets when the exact one is exhausted), or None."""
        for cap in self.buckets:
            if cap >= need and self._free[cap]:
                return cap, self._free[cap].pop()
        return None

    def free(self, slot: Tuple[int, int]):
        cap, idx = slot
        for a in self._arenas[cap]:
            a[idx].zero_()
        self._free[cap].append(idx)

    def write(self, slot: Tuple[int, int], i_state: int, value: torch.Tensor):
        """Store one state tensor into a slot, zero-padding the seq axis
        up to the slot capacity (prefill fetches come back at the prompt
        bucket length, not the slot length)."""
        cap, idx = slot
        sp = self.specs[i_state]
        row = self._arenas[cap][i_state][idx]
        if sp.seq_axis is None:
            row.copy_(value)
            return
        row.zero_()
        row.narrow(sp.seq_axis, 0, value.shape[sp.seq_axis]).copy_(value)

    def _index(self, idxs: Sequence[int]) -> torch.Tensor:
        return torch.tensor(list(idxs), dtype=torch.int64).to(self.device, non_blocking=True)

    def gather(self, cap: int, idxs: Sequence[int], i_state: int,
               pad_to: int) -> torch.Tensor:
        """[pad_to, *slot_shape] batch feed for one state tensor; padded
        rows are zeros (masked off by the padded rows' pos=0)."""
        arena = self._arenas[cap][i_state]
        out = arena.new_zeros((pad_to,) + tuple(arena.shape[1:]))
        out[:len(idxs)] = torch.index_select(arena, 0, self._index(idxs))
        return out

    def scatter(self, cap: int, idxs: Sequence[int], i_state: int,
                value: torch.Tensor):
        self._arenas[cap][i_state].index_copy_(0, self._index(idxs), value[:len(idxs)])


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "deadline", "future", "enqueued_at",
                 "trace", "slot", "pos", "tokens", "t_prefilled",
                 "t_first", "prefill_s", "n_iters", "decode_s")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 deadline: Optional[float], trace):
        self.prompt = prompt
        self.max_new = max_new
        self.deadline = deadline
        self.future: "Future[DecodeResult]" = Future()
        self.enqueued_at = time.perf_counter()
        self.trace = trace
        self.slot: Optional[Tuple[int, int]] = None
        self.pos = 0                      # next cache row to write
        self.tokens: List[np.ndarray] = []
        self.t_prefilled: Optional[float] = None
        self.t_first: Optional[float] = None
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.n_iters = 0


class DecodeEngine:
    """Continuous-batching decode server for one model.

    See the module docstring for the model contract.  ``submit`` returns
    a future of :class:`DecodeResult`; ``generate`` is the synchronous
    wrapper.  A single scheduler thread owns the iteration loop; callers
    only touch the admission queue.  ``place`` is where the programs run
    and the slot pool lives (``None``: ``CUDAPlace(0)``).
    """

    _SEQ = iter(range(1, 1 << 62))

    def __init__(self, prefill_func: Callable, step_func: Callable, *,
                 eos_id: int,
                 max_seq_len: int = 64,
                 param_path: Optional[str] = None,
                 seed: Optional[int] = None,
                 max_batch_size: int = 8,
                 prefill_batch_size: Optional[int] = None,
                 slots_per_bucket: Optional[int] = None,
                 max_queue: int = 64,
                 default_timeout_s: Optional[float] = 30.0,
                 max_new_tokens_default: int = 16,
                 memory_budget=None,
                 nan_guard: bool = True,
                 warmup: bool = True,
                 fault_site: Optional[str] = None,
                 name: str = "decode",
                 place=None):
        from .. import faults
        from ..core import unique_name
        from ..core.executor import Executor
        from ..core.framework import Program, program_guard
        from ..core.scope import Scope

        self.name = name
        self.eos_id = int(eos_id)
        self.max_seq_len = int(max_seq_len)
        self.max_batch_size = int(max_batch_size)
        self.prefill_batch_size = int(prefill_batch_size
                                      or max(1, max_batch_size // 2))
        self.default_timeout_s = default_timeout_s
        self.max_new_tokens_default = int(max_new_tokens_default)
        self.nan_guard = bool(nan_guard)
        self.seq_buckets = seq_len_buckets(self.max_seq_len)
        self.batch_buckets = pow2_buckets(self.max_batch_size)
        self.prefill_buckets = pow2_buckets(self.prefill_batch_size)
        self._fault_site = fault_site
        if fault_site:
            faults.register_site(fault_site)
        self._fire_fault = faults.fire

        # ---- build programs (fresh name counters per program => shared
        # deterministic parameter names, the Inferencer discipline)
        self.scope = Scope()
        self._step_prog = Program()
        step_startup = Program()
        with unique_name.guard():
            with program_guard(self._step_prog, step_startup):
                (tok_in, pos_in, state_ins), (tok_out, state_outs) = \
                    step_func()
        self._tok_in, self._pos_in = tok_in, pos_in
        self._state_ins = list(state_ins)
        self._step_fetch = [tok_out] + list(state_outs)
        if len(state_outs) != len(self._state_ins):
            raise ValueError(
                f"step_func returned {len(state_outs)} state outputs for "
                f"{len(self._state_ins)} state feeds — they must align "
                f"positionally")
        self._specs = self._adopt_step_vars()

        self._prefill: Dict[int, Tuple[Any, Any, Any, List[Any]]] = {}
        for t in self.seq_buckets:
            prog = Program()
            startup = Program()
            with unique_name.guard():
                with program_guard(prog, startup):
                    (ids_v, lens_v), (tok0_v, st0_vs) = prefill_func(t)
            if len(st0_vs) != len(self._specs):
                raise ValueError(
                    f"prefill_func({t}) returned {len(st0_vs)} states, "
                    f"step program has {len(self._specs)}")
            self._prefill[t] = (prog, (ids_v.name, lens_v.name),
                                tok0_v, list(st0_vs))

        self.exe = Executor(place)
        self.place = self.exe.place
        step_startup.random_seed = seed if seed is not None else 0
        self.exe.run(step_startup, scope=self.scope)
        if param_path:
            from .. import io as io_mod
            from ..core.scope import scope_guard
            with scope_guard(self.scope):
                io_mod.load_persistables(self.exe, param_path,
                                         self._step_prog)

        # ---- slot pool, sized under the memory budget via plan_memory
        self._pool, self.memory_plan = self._build_pool(
            slots_per_bucket, memory_budget)
        self._pool.materialize()

        # ---- scheduler state
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: "deque[_DecodeRequest]" = deque()
        self._max_queue = int(max_queue)
        self._ready: List[_DecodeRequest] = []     # prefilled, to splice
        self._active: List[_DecodeRequest] = []    # scheduler-owned
        self._stop = threading.Event()
        self._drain = True
        self._drained = threading.Event()

        self._records = telemetry.StepTelemetry(capacity=4096,
                                                prefix="decode")
        for cname in ("requests", "requests_ok", "requests_failed",
                      "requests_rejected", "tokens_out", "prefill_tokens",
                      "iterations", "prefill_batches", "padded_rows",
                      "rows_dispatched", "retired_eos",
                      "retired_max_tokens", "retired_deadline",
                      "retired_error", "requests_nonfinite",
                      "slots_allocated", "slots_freed",
                      "fresh_compile_breaches"):
            REGISTRY.counter(cname, scope=DECODE_SCOPE)
        self._h_ttft = REGISTRY.histogram("ttft_s", scope=DECODE_SCOPE)
        self._h_per_token = REGISTRY.histogram("per_token_s",
                                               scope=DECODE_SCOPE)
        self._h_rows = REGISTRY.histogram("decode_batch_rows",
                                          scope=DECODE_SCOPE,
                                          buckets=_OCC_HIST)
        self._h_gen_len = REGISTRY.histogram("generated_tokens",
                                             scope=DECODE_SCOPE,
                                             buckets=_OCC_HIST)
        self._g_active = REGISTRY.gauge("active_requests",
                                        scope=DECODE_SCOPE)
        self._g_depth = REGISTRY.gauge("queue_depth", scope=DECODE_SCOPE)
        self._g_slots = REGISTRY.gauge("slots_in_use", scope=DECODE_SCOPE)
        self._g_occ = REGISTRY.gauge("batch_occupancy", scope=DECODE_SCOPE)

        # ---- AOT warmup: every (phase × batch-bucket × seqlen-bucket)
        self.warmup_reports: List[dict] = []
        if warmup:
            self._warmup()
        self._fresh_after_warmup = self.exe.fresh_compile_count
        self._breaches_reported = 0

        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"paddle_tpu_torch-decode-{name}")
        self._thread.start()

    # ------------------------------------------------------------ adoption
    def _adopt_step_vars(self) -> List[_StateSpec]:
        """Introspect the step program's feeds into state specs and stamp
        the recompile-hazard discharges (see KV_CACHE_ATTR)."""
        specs: List[_StateSpec] = []
        for v in self._state_ins:
            shape = tuple(v.shape)
            row = shape[1:]
            dyn = [ax for ax, d in enumerate(row) if d < 0]
            if len(dyn) > 1:
                raise ValueError(
                    f"state feed {v.name!r} has {len(dyn)} dynamic "
                    f"non-batch dims {tuple(shape)}; at most one (the "
                    f"cache slot axis) is supported")
            seq_axis = dyn[0] if dyn else None
            if seq_axis is not None:
                v.desc.attrs[KV_CACHE_ATTR] = "pow2"
            specs.append(_StateSpec(v.name, row, v.dtype, seq_axis))
        if self._pos_in is not None:
            self._pos_in.desc.attrs[DECODE_POS_ATTR] = True
        return specs

    # ---------------------------------------------------------- pool/plan
    def _build_pool(self, slots_per_bucket, memory_budget):
        from ..analysis import plan_memory
        from ..analysis.memory import PredictedOOMError, parse_memory_budget

        n_default = slots_per_bucket or self.max_batch_size
        buckets = {cap: int(n_default) for cap in self.seq_buckets}
        specs = self._specs

        # dispatch peak at the largest (batch, seqlen) signature — the
        # static planner's number, same as the M501 admission gate
        cap = self.seq_buckets[-1]
        feed_shapes = {n: s for n, (s, _d)
                       in self._step_feed_shapes(self.batch_buckets[-1],
                                                 cap)}
        plan = plan_memory(self._step_prog, fetch_list=self._step_fetch,
                           feed_shapes=feed_shapes)
        peak = int(getattr(plan, "peak_bytes", 0) or 0)

        budget = parse_memory_budget(memory_budget) if memory_budget \
            else None
        pool = _SlotPool(buckets, specs, self.exe.device)
        if budget is not None:
            # shrink uniformly until the pool + dispatch peak fits; the
            # floor is one slot per bucket — below that, admission of
            # that length class is impossible and construction fails
            # loudly instead of wedging every request at the queue
            while pool.total_bytes() + peak > budget:
                n = max(n for n in pool.buckets.values())
                if n <= 1:
                    from ..analysis.diagnostics import Diagnostic
                    raise PredictedOOMError(plan, budget, Diagnostic(
                        code="M501",
                        message=(
                            f"decode cache pool needs "
                            f"{pool.bytes_per_slot(cap)}B/slot at "
                            f"bucket {cap} plus {peak}B dispatch peak, "
                            f"over the {budget}B budget even at one "
                            f"slot per bucket — raise the budget or "
                            f"lower max_seq_len")))
                buckets = {c: max(1, v - 1) if v == n else v
                           for c, v in pool.buckets.items()}
                pool = _SlotPool(buckets, specs, self.exe.device)
        info = {
            "pool_bytes": pool.total_bytes(),
            "dispatch_peak_bytes": peak,
            "budget_bytes": budget,
            "slots": {c: n for c, n in pool.buckets.items()},
            "bytes_per_slot": {c: pool.bytes_per_slot(c)
                               for c in pool.buckets},
        }
        return pool, info

    def _step_feed_shapes(self, b: int, cap: int):
        yield self._tok_in.name, ((b,) + tuple(
            d for d in self._tok_in.shape[1:]),
            getattr(self._tok_in.dtype, "value", self._tok_in.dtype))
        if self._pos_in is not None:
            yield self._pos_in.name, ((b, 1), "int32")
        for sp in self._specs:
            yield sp.name, ((b,) + sp.slot_shape(cap), sp.dtype)

    # ------------------------------------------------------------- warmup
    def _warmup(self):
        """Precompile every (phase × batch-bucket × seqlen-bucket)
        executable so steady-state membership churn never compiles."""
        for t, (prog, (ids_n, lens_n), tok0, st0) in self._prefill.items():
            for b in self.prefill_buckets:
                rep = self.exe.precompile(
                    prog, feed={ids_n: ((b, t), "int64"),
                                lens_n: ((b, 1), "int32")},
                    fetch_list=[tok0] + st0, scope=self.scope)
                rep.update(phase="prefill", batch_bucket=b, seq_bucket=t)
                self.warmup_reports.append(rep)
        for cap in self.seq_buckets:
            for b in self.batch_buckets:
                rep = self.exe.precompile(
                    self._step_prog,
                    feed=dict(self._step_feed_shapes(b, cap)),
                    fetch_list=self._step_fetch, scope=self.scope)
                rep.update(phase="decode", batch_bucket=b, seq_bucket=cap)
                self.warmup_reports.append(rep)

    @property
    def fresh_compiles_since_warmup(self) -> int:
        return self.exe.fresh_compile_count - self._fresh_after_warmup

    # ------------------------------------------------------------ ingress
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None
               ) -> "Future[DecodeResult]":
        if self._stop.is_set():
            raise ServingClosed("decode engine is closed")
        p = np.asarray(prompt, dtype=np.int64).reshape(-1)
        if p.size < 1:
            raise ValueError("empty prompt")
        max_new = int(self.max_new_tokens_default
                      if max_new_tokens is None else max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(p.size) + max_new
        if total > self.max_seq_len:
            raise ServingError(
                f"prompt_len({p.size}) + max_new_tokens({max_new}) = "
                f"{total} exceeds max_seq_len={self.max_seq_len}")
        if timeout is None:
            timeout = self.default_timeout_s
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        ctx = telemetry.current_trace()
        trace = ctx.child() if ctx is not None \
            else (telemetry.TraceContext.new_root()
                  if telemetry.tracing_enabled() else None)
        req = _DecodeRequest(p, max_new, deadline, trace)
        with self._cv:
            if self._stop.is_set():
                raise ServingClosed("decode engine is closed")
            if len(self._queue) >= self._max_queue:
                self._inc("requests_rejected")
                raise ServingOverloaded(
                    f"decode queue full ({self._max_queue} waiting); "
                    f"retry with backoff or raise max_queue")
            self._queue.append(req)
            self._inc("requests")
            self._g_depth.set(len(self._queue))
            self._cv.notify()
        return req.future

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 timeout: Optional[float] = None) -> DecodeResult:
        """Synchronous decode: submit and wait for retirement."""
        if timeout is None:
            timeout = self.default_timeout_s
        fut = self.submit(prompt, max_new_tokens=max_new_tokens,
                          timeout=timeout)
        try:
            # grace over the engine-side deadline so the scheduler's own
            # deadline retirement (typed, accounted) wins the race
            return fut.result(timeout=None if timeout is None
                              else timeout + 5.0)
        except _FutureTimeout:
            raise RequestTimeout(
                f"decode result not ready within {timeout}s",
                where="decode") from None

    def canary(self) -> DecodeResult:
        """Tiny end-to-end generation — the hot-swap admission probe."""
        return self.generate(np.array([self.eos_id], dtype=np.int64),
                             max_new_tokens=1, timeout=30.0)

    # ------------------------------------------------------------ metrics
    @staticmethod
    def _inc(name: str, n: int = 1):
        REGISTRY.counter(name, scope=DECODE_SCOPE).inc(n)

    def stats(self) -> Dict[str, Any]:
        """Flat snapshot of the ``"decode"`` scope plus this engine's
        pool/compile state.  ``prefill_decode_ratio`` is prefill batches
        per decode iteration — the knob-health number for the split."""
        s = REGISTRY.snapshot(scope=DECODE_SCOPE)
        iters = s.get("iterations") or 0
        s["prefill_decode_ratio"] = \
            (s.get("prefill_batches") or 0) / iters if iters else 0.0
        tok = s.get("tokens_out") or 0
        s["mean_batch_rows"] = (s.get("rows_dispatched") or 0) / iters \
            if iters else 0.0
        s["tokens_out_total"] = tok
        s["slots"] = {str(c): {"in_use": u, "total": t}
                      for c, (u, t) in self._pool.counts().items()}
        s["memory_plan"] = self.memory_plan
        s["fresh_compiles_since_warmup"] = self.fresh_compiles_since_warmup
        s["executables_warmed"] = len(self.warmup_reports)
        return s

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # ---------------------------------------------------------- scheduler
    def _loop(self):
        try:
            while True:
                with self._cv:
                    while not (self._queue or self._ready or self._active
                               or self._stop.is_set()):
                        self._cv.wait(timeout=0.25)
                    if self._stop.is_set() and not (
                            self._drain and (self._queue or self._ready
                                             or self._active)):
                        break
                    # iteration boundary: splice freshly prefilled
                    # requests into the decode batch
                    self._active.extend(self._ready)
                    self._ready.clear()
                self._expire_queued()
                if self._active:
                    self._decode_iteration()
                self._prefill_once()
                self._g_active.set(len(self._active))
                self._g_slots.set(self._pool.in_use())
        finally:
            self._drained.set()
            self._fail_parked()

    def _expire_queued(self):
        now = time.monotonic()
        with self._cv:
            keep: "deque[_DecodeRequest]" = deque()
            for r in self._queue:
                if r.deadline is not None and now > r.deadline:
                    self._inc("retired_deadline")
                    self._inc("requests_failed")
                    r.future.set_exception(RequestTimeout(
                        f"deadline expired after "
                        f"{time.perf_counter() - r.enqueued_at:.3f}s "
                        f"waiting for a cache slot "
                        f"(queue_depth={len(self._queue)})",
                        where="queue"))
                else:
                    keep.append(r)
            self._queue = keep
            self._g_depth.set(len(self._queue))

    # ------------------------------------------------------------ prefill
    def _prefill_once(self):
        """Dispatch at most one prefill batch: FIFO head's prompt bucket,
        batch-mates from the same bucket, each needing a free slot."""
        batch: List[_DecodeRequest] = []
        t_bucket = None
        with self._cv:
            while self._queue and len(batch) < self.prefill_batch_size:
                r = self._queue[0]
                tb = self._bucket_for_len(len(r.prompt))
                if t_bucket is None:
                    t_bucket = tb
                elif tb != t_bucket:
                    break
                slot = self._pool.alloc(len(r.prompt) + r.max_new)
                if slot is None:
                    # pool exhausted for this class: requests wait
                    # admitted-but-queued (budget-aware admission)
                    break
                self._queue.popleft()
                r.slot = slot
                self._inc("slots_allocated")
                batch.append(r)
            self._g_depth.set(len(self._queue))
        if not batch:
            return
        t0 = time.perf_counter()
        prog, (ids_n, lens_n), tok0_v, st0_vs = self._prefill[t_bucket]
        b = self._batch_bucket(len(batch), self.prefill_buckets)
        ids = np.full((b, t_bucket), self.eos_id, dtype=np.int64)
        lens = np.ones((b, 1), dtype=np.int32)
        for i, r in enumerate(batch):
            ids[i, :len(r.prompt)] = r.prompt
            lens[i, 0] = len(r.prompt)
        if self._fault_site:
            self._fire_fault(self._fault_site)
        first = next((r.trace for r in batch if r.trace is not None), None)
        btrace = first.child() if first is not None else None
        with telemetry.use_trace(btrace):
            out = self.exe.run(prog, feed={ids_n: ids, lens_n: lens},
                               fetch_list=[tok0_v] + st0_vs,
                               scope=self.scope, return_numpy=False)
        states0 = out[1:]
        tok0, bad = self._to_host(out[0], states0, len(batch))
        took = time.perf_counter() - t0
        now = time.perf_counter()
        for i, r in enumerate(batch):
            r.prefill_s = took
            r.t_prefilled = now
            if i in bad:
                self._inc("requests_nonfinite")
                self._retire(r, "nonfinite", exc=ServingNonFinite(
                    "prefill produced non-finite decoder state for this "
                    "request; response withheld by the NaN guard",
                    batch_seq=-1))
                continue
            for si, arr in enumerate(states0):
                self._pool.write(r.slot, si, arr[i])
            r.pos = len(r.prompt)
            t = np.asarray(tok0[i]).astype(np.int64)
            r.tokens.append(t)
            r.t_first = now
            self._h_ttft.observe(now - r.enqueued_at)
            self._inc("tokens_out")
            if bool(np.all(t == self.eos_id)):
                self._retire(r, "eos")
            elif r.max_new <= 1:
                self._retire(r, "max_tokens")
            else:
                with self._cv:
                    self._ready.append(r)
        self._inc("prefill_batches")
        self._inc("prefill_tokens", int(sum(len(r.prompt) for r in batch)))
        extra = btrace.fields() if btrace is not None else {}
        links = [{"trace_id": r.trace.trace_id, "span_id": r.trace.span_id}
                 for r in batch if r.trace is not None]
        if links:
            extra["links"] = links
        self._records.record(
            kind="prefill", requests=len(batch), seq_bucket=t_bucket,
            bucket=b, padded_rows=b - len(batch),
            prefill_s=round(took, 6), queue_depth=self.queue_depth,
            **extra)

    # ------------------------------------------------------- decode loop
    def _decode_iteration(self):
        """One iteration over every live request, grouped by slot bucket,
        each group padded to a pow2 batch bucket."""
        groups: Dict[int, List[_DecodeRequest]] = {}
        now = time.monotonic()
        for r in list(self._active):
            if r.deadline is not None and now > r.deadline:
                self._retire(r, "deadline", exc=RequestTimeout(
                    f"deadline expired mid-generation after "
                    f"{len(r.tokens)} tokens", where="decode"))
                continue
            groups.setdefault(r.slot[0], []).append(r)
        for cap in sorted(groups):
            members = groups[cap]
            for i in range(0, len(members), self.max_batch_size):
                self._decode_group(cap, members[i:i + self.max_batch_size])

    def _decode_group(self, cap: int, members: List[_DecodeRequest]):
        t0 = time.perf_counter()
        b = self._batch_bucket(len(members), self.batch_buckets)
        seq = next(DecodeEngine._SEQ)
        idxs = [r.slot[1] for r in members]
        tok_row = tuple(int(d) for d in self._tok_in.shape[1:])
        tok = np.full((b,) + tok_row, self.eos_id, dtype=np.int64)
        for i, r in enumerate(members):
            tok[i] = r.tokens[-1].reshape(tok_row)
        feed: Dict[str, Any] = {self._tok_in.name: tok}
        if self._pos_in is not None:
            pos = np.zeros((b, 1), dtype=np.int32)
            for i, r in enumerate(members):
                pos[i, 0] = r.pos
            feed[self._pos_in.name] = pos
        for si, sp in enumerate(self._specs):
            feed[sp.name] = self._pool.gather(cap, idxs, si, b)
        if self._fault_site:
            self._fire_fault(self._fault_site)
        first = next((r.trace for r in members if r.trace is not None),
                     None)
        btrace = first.child() if first is not None else None
        with telemetry.use_trace(btrace):
            out = self.exe.run(self._step_prog, feed=feed,
                               fetch_list=self._step_fetch,
                               scope=self.scope, return_numpy=False)
        states = out[1:]
        nxt, bad = self._to_host(out[0], states, len(members))
        took = time.perf_counter() - t0
        for si in range(len(self._specs)):
            self._pool.scatter(cap, idxs, si, states[si])
        live = 0
        for i, r in enumerate(members):
            r.n_iters += 1
            r.decode_s += took
            if i in bad:
                self._inc("requests_nonfinite")
                self._retire(r, "nonfinite", exc=ServingNonFinite(
                    f"decode step produced non-finite state for this "
                    f"request (iteration batch {seq}); response withheld "
                    f"by the NaN guard", batch_seq=seq))
                continue
            t = np.asarray(nxt[i]).astype(np.int64)
            r.tokens.append(t)
            r.pos += 1
            self._inc("tokens_out")
            self._h_per_token.observe(took)
            if bool(np.all(t == self.eos_id)):
                self._retire(r, "eos")
            elif len(r.tokens) >= r.max_new:
                self._retire(r, "max_tokens")
            else:
                live += 1
        occupancy = len(members) / float(b)
        self._inc("iterations")
        self._inc("rows_dispatched", len(members))
        self._inc("padded_rows", b - len(members))
        self._h_rows.observe(len(members))
        self._g_occ.set(occupancy)
        extra = btrace.fields() if btrace is not None else {}
        links = [{"trace_id": r.trace.trace_id, "span_id": r.trace.span_id}
                 for r in members if r.trace is not None]
        if links:
            extra["links"] = links
        self._records.record(
            kind="iteration", batch_seq=seq, requests=len(members),
            rows=len(members), bucket=b, seq_bucket=cap,
            padded_rows=b - len(members),
            occupancy=round(occupancy, 4), live_after=live,
            queue_depth=self.queue_depth,
            active=len(self._active), decode_s=round(took, 6), **extra)
        breach = self.fresh_compiles_since_warmup
        if breach > self._breaches_reported:
            # warmup covered every reachable signature; a fresh compile
            # here means a hole in the bucket matrix — surface it loudly
            # in metrics (and the smoke asserts the counter stays 0)
            self._inc("fresh_compile_breaches",
                      breach - self._breaches_reported)
            self._breaches_reported = breach

    # --------------------------------------------------------- retirement
    def _retire(self, r: _DecodeRequest, reason: str,
                exc: Optional[Exception] = None):
        if r in self._active:
            self._active.remove(r)
        if r.slot is not None:
            self._pool.free(r.slot)
            r.slot = None
            self._inc("slots_freed")
        latency = time.perf_counter() - r.enqueued_at
        queue_s = (r.t_prefilled - r.enqueued_at - r.prefill_s) \
            if r.t_prefilled else latency
        self._records.record(
            kind="request", reason=reason, tokens=len(r.tokens),
            prompt_len=int(len(r.prompt)), n_iterations=r.n_iters,
            latency_s=round(latency, 6),
            queue_s=round(max(0.0, queue_s), 6),
            prefill_s=round(r.prefill_s, 6),
            decode_s=round(r.decode_s, 6),
            ttft_s=round((r.t_first - r.enqueued_at), 6)
            if r.t_first else None,
            **(r.trace.fields() if r.trace else {}))
        self._h_gen_len.observe(len(r.tokens))
        if exc is not None:
            self._inc("requests_failed")
            self._inc("retired_deadline" if reason == "deadline"
                      else "retired_error")
            if not r.future.done():
                r.future.set_exception(exc)
            return
        self._inc("requests_ok")
        self._inc(f"retired_{reason}")
        if not r.future.done():
            r.future.set_result(DecodeResult(
                tokens=np.stack(r.tokens) if r.tokens
                else np.zeros((0,), np.int64),
                reason=reason,
                ttft_s=(r.t_first - r.enqueued_at) if r.t_first else 0.0,
                latency_s=latency,
                queue_s=max(0.0, queue_s),
                prefill_s=r.prefill_s, decode_s=r.decode_s,
                n_iterations=r.n_iters))

    # ------------------------------------------------------------ helpers
    def _bucket_for_len(self, n: int) -> int:
        for b in self.seq_buckets:
            if n <= b:
                return b
        return self.seq_buckets[-1]

    @staticmethod
    def _batch_bucket(n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def _to_host(self, tok: torch.Tensor, states: Sequence[torch.Tensor],
                 rows: int) -> Tuple[np.ndarray, set]:
        """(the first ``rows`` tokens as int64 host rows, the rows whose
        floating state is not finite): one copy to the host, the NaN
        guard's verdict computed on the device beside the tokens."""
        tok_rows = tok[:rows].reshape(rows, -1).to(torch.int64)
        cols = [tok_rows]
        if self.nan_guard:
            ok = torch.ones(rows, dtype=torch.bool, device=tok.device)
            for a in states:
                if a.is_floating_point():
                    ok &= torch.isfinite(a[:rows].reshape(rows, -1)).all(dim=1)
            cols.append((~ok).to(torch.int64)[:, None])
        host = torch.cat(cols, dim=1).cpu().numpy()
        toks = host[:, :tok_rows.shape[1]].reshape((rows,) + tuple(tok.shape[1:]))
        bad = {int(i) for i in np.nonzero(host[:, -1])[0]} if self.nan_guard else set()
        return toks, bad

    # ---------------------------------------------------------- lifecycle
    def _fail_parked(self):
        with self._cv:
            leftovers = list(self._queue) + self._ready + self._active
            self._queue.clear()
            self._ready.clear()
            self._active.clear()
        for r in leftovers:
            if r.slot is not None:
                self._pool.free(r.slot)
                r.slot = None
            if not r.future.done():
                self._inc("requests_failed")
                r.future.set_exception(ServingClosed(
                    "decode engine closed before the request finished"))

    def close(self, drain: bool = True, timeout: float = 30.0):
        """Shut down the scheduler.  ``drain=True`` finishes every
        admitted request first (in-flight generations complete); either
        way, stragglers are failed with :class:`ServingClosed`."""
        self._drain = bool(drain)
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._drained.wait(timeout=timeout)
        self._thread.join(timeout=max(0.0, timeout))
        self._fail_parked()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
