"""RowPrefetcher: each batch's embedding ids deduplicated on the host, on
the feed-staging thread (the JAX package's ``embedding/prefetch.py``).

The unique id set of each table is staged beside the batch (the
``FeedStager``'s ``on_batch`` hook, off the step's critical path), so a
consumer of the staged batch (a serving row cache, a debugging hook) sees
which rows the batch touches; the dedup ratio, how hot the hot rows are,
is exported as ``"embedding"``-scope counters and a JSONL row a batch.
This is the one place the id stream is deduplicated on the host: the
step itself merges its sparse gradients on the device.

Wire-up: ``Trainer(prefetcher=...)`` or ``Executor.stage_feeds(...,
on_batch=prefetcher.on_batch)``; a standalone reader wraps with
:meth:`RowPrefetcher.wrap_reader`.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, Optional

import numpy as np

from ..telemetry import REGISTRY
from . import EMBEDDING_SCOPE, records


class RowPrefetcher:
    """Extract + stage each batch's unique embedding ids.

    ``tables`` maps id feed names to the table (parameter) names they
    index: ``RowPrefetcher({"user_ids": "user_table"})``.  After a batch
    is staged, :attr:`last` holds ``{table: unique ids}`` and — when the
    batch came through a FeedStager — the staged batch's ``prefetched``
    slot carries the same mapping.

    Optionally warms a :class:`~paddle_tpu_torch.embedding.RowCache` per
    table (``cache=`` a dict of table -> (cache, fetch_fn)): rows pulled
    into the cache before the request that needs them.
    """

    def __init__(self, tables: Dict[str, str], cache: Optional[dict] = None):
        if not tables:
            raise ValueError("RowPrefetcher needs at least one "
                             "id-feed -> table mapping")
        self._tables = {str(k): str(v) for k, v in tables.items()}
        self._cache = dict(cache or {})
        self._lock = threading.Lock()
        self.last: Dict[str, np.ndarray] = {}
        # per-instance tallies for stats(); the scope counters below are
        # process-global (shared by every prefetcher in the process)
        self._batches = self._seen = self._unique = self._bytes = 0
        self._c_batches = REGISTRY.counter("prefetch_batches",
                                           scope=EMBEDDING_SCOPE)
        self._c_seen = REGISTRY.counter("prefetch_ids_seen",
                                        scope=EMBEDDING_SCOPE)
        self._c_unique = REGISTRY.counter("prefetch_ids_unique",
                                          scope=EMBEDDING_SCOPE)
        self._c_bytes = REGISTRY.counter("prefetch_staged_id_bytes",
                                         scope=EMBEDDING_SCOPE)
        self._g_ratio = REGISTRY.gauge("prefetch_dedup_ratio",
                                       scope=EMBEDDING_SCOPE)

    # ------------------------------------------------------------ hooks
    def on_batch(self, feed: dict, staged=None):
        """FeedStager ``on_batch`` hook — runs on the stager thread with
        the raw host feed; attaches the dedup'd id sets to ``staged``."""
        prefetched: Dict[str, np.ndarray] = {}
        seen = unique = 0
        for feed_name, table in self._tables.items():
            val = feed.get(feed_name)
            if val is None:
                continue
            flat = np.asarray(val).reshape(-1)
            uniq = np.unique(flat)
            prefetched[table] = uniq
            seen += int(flat.size)
            unique += int(uniq.size)
            self._c_bytes.inc(int(uniq.nbytes))
            ent = self._cache.get(table)
            if ent is not None:
                cache, fetch = ent
                cache.warm(uniq, fetch)
        if not prefetched:
            return
        self._c_batches.inc()
        self._c_seen.inc(seen)
        self._c_unique.inc(unique)
        ratio = round(unique / max(1, seen), 6)
        self._g_ratio.set(ratio)
        with self._lock:
            self._batches += 1
            self._seen += seen
            self._unique += unique
            self._bytes += sum(int(v.nbytes) for v in prefetched.values())
            self.last.update(prefetched)
        if staged is not None and hasattr(staged, "prefetched"):
            staged.prefetched = prefetched
        records().record(kind="prefetch", ids_seen=seen, ids_unique=unique,
                         dedup_ratio=ratio,
                         staged_bytes=sum(int(v.nbytes)
                                          for v in prefetched.values()),
                         tables=sorted(prefetched))

    def wrap_reader(self, reader):
        """Wrap a paddle-style reader factory: each yielded batch passes
        through :meth:`on_batch` keyed by position-independent feed dicts
        built by the caller's feeder — here the reader yields dicts."""
        def _reader() -> Iterable[Any]:
            for batch in reader():
                if isinstance(batch, dict):
                    self.on_batch(batch)
                yield batch
        return _reader

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            seen, unique = self._seen, self._unique
            return {"batches": self._batches, "ids_seen": seen,
                    "ids_unique": unique,
                    "staged_id_bytes": self._bytes,
                    "dedup_ratio": round(unique / max(1, seen), 6)}
