"""The giant-embedding subsystem (the JAX package's ``embedding/``), on
one card:

* :func:`sharded_table` -- a ``lookup_table`` layer whose parameter is
  stamped with the *embedding* layout role (the ``layout_role`` var attr
  a mesh layout reads; ROADMAP item 12c places tables on a mesh), with
  ``is_sparse=True`` SelectedRows gradients, so a step's update gathers,
  updates and writes back only the batch's unique rows;
* :class:`RowPrefetcher` -- dedups each batch's ids on the host, on the
  ``FeedStager``'s thread, and stages the unique id set beside the batch,
  with dedup-ratio and staged-byte telemetry in the ``"embedding"``
  scope;
* :class:`RowCache` -- a serving-side LRU row cache in front of
  ``lookup_table``, its capacity keyed on the memory planner's budget,
  with hit, miss and eviction counters.

:func:`plan_table` sizes a table statically (bytes with its optimizer
slots) so ``Executor(memory_budget=)`` can pre-flight it and M501-refuse
one that does not fit.
"""
from __future__ import annotations

import threading

from .. import telemetry

#: telemetry scope for every counter, gauge and histogram of the subsystem
EMBEDDING_SCOPE = "embedding"

_records_lock = threading.Lock()
_records = None


def records() -> "telemetry.StepTelemetry":
    """The subsystem's JSONL ring (``embedding_<pid>.jsonl`` under
    ``PADDLE_TPU_TELEMETRY_DIR``): one row a prefetched batch, cache
    lookup or planned table."""
    global _records
    with _records_lock:
        if _records is None:
            _records = telemetry.StepTelemetry(capacity=4096, prefix="embedding")
        return _records


def _reset_records_for_tests():
    global _records
    with _records_lock:
        _records = None


from .cache import RowCache                      # noqa: E402
from .prefetch import RowPrefetcher              # noqa: E402
from .table import plan_table, sharded_table     # noqa: E402

__all__ = ["EMBEDDING_SCOPE", "RowCache", "RowPrefetcher", "plan_table", "records",
           "sharded_table"]
