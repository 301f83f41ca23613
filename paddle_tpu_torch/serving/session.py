"""ServingSession: the model-facing serving facade.

Wraps an :class:`~paddle_tpu_torch.trainer.Inferencer` with the
:class:`~paddle_tpu_torch.serving.engine.BatchingEngine`: at load time it
builds the executor's cache entry of every bucket (on the card, one CUDA
graph each; ``warmup_report`` holds one record per bucket) before the
engine's thread starts, at request time callers from any number of
threads share one dispatcher and one device queue, and at shutdown
in-flight batches drain before the session closes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import faults
from ..telemetry import REGISTRY
from .engine import SERVING_SCOPE, BatchingEngine, pow2_buckets

__all__ = ["ServingSession"]


class ServingSession:
    """Serve a model to concurrent callers through one micro-batched device
    pipeline.  Wrap an ``Inferencer`` (``inferencer=``) or build one
    (``infer_func=``).  ``infer`` is thread-safe and returns only the
    calling request's rows.  A model with dynamic non-batch feed dims
    (a ragged model) cannot be warmed from its declarations: call
    ``inferencer.warmup(buckets, feed_specs)`` first and pass
    ``warmup=False``.
    ``passes=``, ``amp=``, ``kernels=``, ``validate=`` and
    ``memory_budget=`` go to the ``Inferencer`` it builds:
    ``amp=AmpConfig(bf16=False, quant=True), kernels=True`` serves in int8;
    ``validate="warn"``/``"error"`` verifies the inference program once
    for all buckets.  A pre-built inferencer adopts the session's
    ``memory_budget``.  With a budget, the warmup rejects every bucket
    whose planned peak exceeds it, and the engine dispatches only the
    others (a ``ValueError`` when none is left).
    ``fault_site``: a per-model chaos hook (``faults``): every dispatched
    batch fires the generic ``serving.backend`` site and this one, so a
    fault plan can fail, slow or kill one model's backend; None (the
    default) fires nothing.
    ``param_path`` loads saved parameters into the ``Inferencer`` it
    builds.  ``embedding_cache``: LRU row caches (``embedding.RowCache``)
    in front of the model's embedding tables for :meth:`lookup_rows`, a
    sequence of table names (capacity keyed on the memory budget) or
    ``{table: {budget/fraction/capacity_rows}}``; ``stats()["embedding"]``
    holds each table's cache counters."""

    def __init__(self, infer_func=None, place=None, inferencer=None,
                 max_batch_size: int = 32, max_wait_ms: float = 2.0,
                 max_queue: int = 256,
                 default_timeout_s: Optional[float] = 30.0,
                 buckets: Optional[Sequence[int]] = None,
                 warmup: bool = True, nan_guard: bool = True, passes=None,
                 amp=None, kernels=None, validate: Optional[str] = None,
                 memory_budget=None, fault_site: Optional[str] = None,
                 param_path: Optional[str] = None, embedding_cache=None):
        if inferencer is None:
            if infer_func is None:
                raise ValueError("pass infer_func or an existing inferencer")
            from ..trainer import Inferencer
            inferencer = Inferencer(infer_func=infer_func, param_path=param_path, place=place,
                                    passes=passes, amp=amp, kernels=kernels,
                                    validate=validate, memory_budget=memory_budget)
        elif memory_budget is not None:
            inferencer.exe.memory_budget = memory_budget
        self.inferencer = inferencer
        if embedding_cache:
            spec = embedding_cache
            if not isinstance(spec, dict):
                spec = {str(t): {} for t in spec}
            for table, kw in spec.items():
                self.inferencer.attach_row_cache(table, **dict(kw or {}))
        self._fault_site = fault_site
        self.buckets = tuple(sorted(
            int(b) for b in (buckets or pow2_buckets(max_batch_size))))
        self.warmup_report: List[Dict[str, Any]] = []
        if warmup:
            self.warmup_report = self.inferencer.warmup(self.buckets)
            accepted = tuple(r["batch_size"] for r in self.warmup_report
                             if not r.get("rejected"))
            if len(accepted) != len(self.buckets):
                rejected = [r for r in self.warmup_report if r.get("rejected")]
                if not accepted:
                    raise ValueError("every warmup bucket exceeds the memory budget -- "
                                     f"smallest rejection: {rejected[0]['error']}")
                self.buckets = accepted
                max_batch_size = min(int(max_batch_size), accepted[-1])
        self.engine = BatchingEngine(
            runner=self._run_batch, max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            default_timeout_s=default_timeout_s, buckets=self.buckets,
            feed_names=self.inferencer.feed_names or None,
            nan_guard=nan_guard)

    def _run_batch(self, feed: dict):
        # sync=False: the dispatcher gets FetchHandles back as soon as the
        # batch is enqueued and can coalesce the next one meanwhile
        if self._fault_site is not None:
            faults.fire("serving.backend")
            faults.fire(self._fault_site)
        return self.inferencer.infer(feed, sync=False)

    def infer(self, inputs: Dict[str, Any],
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """One request through the shared batching engine: this request's
        rows of each model output.  Safe to call from many threads."""
        return self.engine.infer(inputs, timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        """This session's engine counters (``coalesce_ratio``,
        ``queue_depth``), its executor's cache counters under
        ``"executor"``, and under ``"serving"`` the registry's process-wide
        ``"serving"`` scope (every engine's counters, the ``batch_size``
        and ``request_latency_s`` histograms, the ``queue_depth`` gauge)."""
        s = self.engine.stats()
        exe = self.inferencer.exe
        s["executor"] = {"scope": exe.telemetry_scope, "compile_count": exe.compile_count,
                         "executables": len(exe._cache)}
        s["serving"] = REGISTRY.snapshot(scope=SERVING_SCOPE)
        emb = self.inferencer.row_cache_stats()
        if emb:
            s["embedding"] = emb
        return s

    def lookup_rows(self, table: str, ids):
        """Embedding rows for ``ids``, through the table's row cache where
        ``embedding_cache=`` attached one (a hit gathers nothing)."""
        return self.inferencer.lookup_rows(table, ids)

    def close(self, drain: bool = True):
        """Stop accepting requests; by default drain in-flight batches."""
        self.engine.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
