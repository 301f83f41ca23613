"""RowCache: the serving-side LRU embedding-row cache (the JAX
package's ``embedding/cache.py``).

It sits in front of ``lookup_table`` for inference engines: ids hit a
host-side LRU of recently used rows, and only the misses pay the gather
from the live table (on the card, K2 and a copy to the host).

Capacity is keyed on the memory budget: :meth:`RowCache.for_table` reads
the per-device byte bound through the memory planner's budget parser and
admits only ``fraction`` of it as cache rows.  Hit, miss and eviction
counters live in the ``"embedding"`` telemetry scope; every lookup
appends a JSONL row (``embedding.records()``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..telemetry import REGISTRY
from . import EMBEDDING_SCOPE, records


class RowCache:
    """LRU of ``id -> row`` for one embedding table.

    ``lookup(ids, fetch)`` returns the ``[len(ids), dim]`` row block;
    ``fetch(miss_ids)`` supplies rows for the ids not cached (a gather
    against the live parameter, a checkpoint read, an RPC — the cache
    does not care).  Thread-safe: serving sessions share one instance
    across request threads.
    """

    def __init__(self, capacity_rows: int, table: str = "table"):
        self.capacity_rows = int(capacity_rows)
        if self.capacity_rows <= 0:
            raise ValueError(f"RowCache capacity must be positive, got "
                             f"{capacity_rows}")
        self.table = str(table)
        self._rows: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        # per-instance tallies for stats(); the scope counters below are
        # process-global (aggregated across every table's cache)
        self._hits = self._misses = self._evictions = self._inserts = 0
        self._c_hits = REGISTRY.counter("cache_hits", scope=EMBEDDING_SCOPE)
        self._c_misses = REGISTRY.counter("cache_misses",
                                          scope=EMBEDDING_SCOPE)
        self._c_evict = REGISTRY.counter("cache_evictions",
                                         scope=EMBEDDING_SCOPE)
        self._c_inserts = REGISTRY.counter("cache_inserts",
                                           scope=EMBEDDING_SCOPE)
        self._g_rows = REGISTRY.gauge("cache_rows", scope=EMBEDDING_SCOPE)

    # ------------------------------------------------------- constructors
    @classmethod
    def for_table(cls, rows: int, dim: int, *, dtype: str = "float32",
                  budget=None, fraction: float = 0.05,
                  table: str = "table") -> "RowCache":
        """Capacity from the memory planner's budget grammar: admit at
        most ``fraction`` of ``budget`` (bytes / "512MiB" / a device
        profile name) as cached rows, never more than the table has."""
        from ..analysis import memory as _memory

        row_bytes = int(dim) * np.dtype(dtype).itemsize
        cap = int(rows)
        if budget is not None:
            budget_b = _memory.parse_memory_budget(budget)
            cap = min(cap, max(1, int(budget_b * float(fraction))
                               // max(1, row_bytes)))
        return cls(cap, table=table)

    # ------------------------------------------------------------ lookup
    def lookup(self, ids, fetch: Callable[[np.ndarray], Any]) -> np.ndarray:
        """Rows for ``ids`` (any int array-like), LRU-served; misses are
        fetched in ONE ``fetch(miss_ids)`` call and admitted."""
        flat = np.asarray(ids).reshape(-1)
        out: list = [None] * flat.size
        miss_pos: Dict[int, list] = {}
        hits = 0
        with self._lock:
            for i, rid in enumerate(flat):
                rid = int(rid)
                row = self._rows.get(rid)
                if row is not None:
                    self._rows.move_to_end(rid)
                    out[i] = row
                    hits += 1
                else:
                    miss_pos.setdefault(rid, []).append(i)
        misses = len(miss_pos)
        if misses:
            miss_ids = np.fromiter(miss_pos, dtype=np.int64, count=misses)
            fetched = np.asarray(fetch(miss_ids))
            with self._lock:
                for j, rid in enumerate(miss_ids):
                    row = fetched[j]
                    for i in miss_pos[int(rid)]:
                        out[i] = row
                    self._insert_locked(int(rid), row)
        self._c_hits.inc(hits)
        self._c_misses.inc(misses)
        with self._lock:
            self._hits += hits
            self._misses += misses
        self._g_rows.set(len(self._rows))
        records().record(kind="lookup", table=self.table,
                         ids=int(flat.size), hits=hits, misses=misses,
                         cached_rows=len(self._rows))
        return np.stack(out) if out else \
            np.empty((0,), dtype=np.float32)

    def warm(self, ids, fetch: Callable[[np.ndarray], Any]) -> int:
        """Admit rows for ``ids`` without serving them (the prefetch
        path).  Returns how many rows were actually fetched."""
        flat = np.unique(np.asarray(ids).reshape(-1))
        with self._lock:
            need = [int(r) for r in flat if int(r) not in self._rows]
        if not need:
            return 0
        fetched = np.asarray(fetch(np.asarray(need, dtype=np.int64)))
        with self._lock:
            for j, rid in enumerate(need):
                self._insert_locked(rid, fetched[j])
        self._g_rows.set(len(self._rows))
        records().record(kind="warm", table=self.table, rows=len(need))
        return len(need)

    def _insert_locked(self, rid: int, row) -> None:
        if rid in self._rows:
            self._rows.move_to_end(rid)
            self._rows[rid] = row
            return
        self._rows[rid] = row
        self._c_inserts.inc()
        self._inserts += 1
        while len(self._rows) > self.capacity_rows:
            self._rows.popitem(last=False)
            self._c_evict.inc()
            self._evictions += 1

    # ------------------------------------------------------- maintenance
    def invalidate(self, ids=None) -> None:
        """Drop cached rows (all, or just ``ids``) — the hot-swap /
        post-restore hook: a new table version must not serve stale
        rows."""
        with self._lock:
            if ids is None:
                self._rows.clear()
            else:
                for rid in np.asarray(ids).reshape(-1):
                    self._rows.pop(int(rid), None)
        self._g_rows.set(len(self._rows))

    def __len__(self) -> int:
        return len(self._rows)

    def stats(self) -> Dict[str, Any]:
        hits, misses = self._hits, self._misses
        return {"table": self.table, "capacity_rows": self.capacity_rows,
                "cached_rows": len(self._rows), "hits": hits,
                "misses": misses, "evictions": self._evictions,
                "inserts": self._inserts,
                "hit_rate": round(hits / max(1, hits + misses), 6)}
