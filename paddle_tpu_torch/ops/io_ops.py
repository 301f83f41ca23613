"""In-graph I/O op registrations.  The ``read`` op (the py_reader contract,
``layers/io.py``) has no lowering: the executor pops a batch from the
reader's queue and binds its outputs before each run, as it binds feeds
(``Executor._pop_readers``).  Like ``feed`` it has no gradient."""
from __future__ import annotations

from ..core.registry import mark_no_gradient

mark_no_gradient("read")
