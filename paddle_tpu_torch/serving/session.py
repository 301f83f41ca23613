"""ServingSession: the model-facing serving facade.

Wraps an :class:`~paddle_tpu_torch.trainer.Inferencer` with the
:class:`~paddle_tpu_torch.serving.engine.BatchingEngine`: at load time it
runs one zero batch per bucket, at request time callers from any number of
threads share one dispatcher and one device queue, and at shutdown
in-flight batches drain before the session closes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .engine import BatchingEngine, pow2_buckets

__all__ = ["ServingSession"]


class ServingSession:
    """Serve a model to concurrent callers through one micro-batched device
    pipeline.  Wrap an ``Inferencer`` (``inferencer=``) or build one
    (``infer_func=``).  ``infer`` is thread-safe and returns only the
    calling request's rows.  A model with dynamic non-batch feed dims
    (a ragged model) cannot be warmed from its declarations: pass
    ``warmup=False`` and call ``inferencer.warmup(buckets, feed_specs)``."""

    def __init__(self, infer_func=None, place=None, inferencer=None,
                 max_batch_size: int = 32, max_wait_ms: float = 2.0,
                 max_queue: int = 256,
                 default_timeout_s: Optional[float] = 30.0,
                 buckets: Optional[Sequence[int]] = None,
                 warmup: bool = True, nan_guard: bool = True):
        if inferencer is None:
            if infer_func is None:
                raise ValueError("pass infer_func or an existing inferencer")
            from ..trainer import Inferencer
            inferencer = Inferencer(infer_func=infer_func, place=place)
        self.inferencer = inferencer
        self.buckets = tuple(sorted(
            int(b) for b in (buckets or pow2_buckets(max_batch_size))))
        self.warmup_report: List[Dict[str, Any]] = []
        if warmup:
            self.warmup_report = self.inferencer.warmup(self.buckets)
        self.engine = BatchingEngine(
            runner=self._run_batch, max_batch_size=max_batch_size,
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            default_timeout_s=default_timeout_s, buckets=self.buckets,
            feed_names=self.inferencer.feed_names or None,
            nan_guard=nan_guard)

    def _run_batch(self, feed: dict):
        # sync=False: the dispatcher gets FetchHandles back as soon as the
        # batch is enqueued and can coalesce the next one meanwhile
        return self.inferencer.infer(feed, sync=False)

    def infer(self, inputs: Dict[str, Any],
              timeout: Optional[float] = None) -> List[np.ndarray]:
        """One request through the shared batching engine: this request's
        rows of each model output.  Safe to call from many threads."""
        return self.engine.infer(inputs, timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()

    def close(self, drain: bool = True):
        """Stop accepting requests; by default drain in-flight batches."""
        self.engine.close(drain=drain)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
