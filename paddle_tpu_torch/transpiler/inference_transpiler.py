"""InferenceTranspiler: inference-time program rewrites (legacy API), as
in the JAX package's ``transpiler/inference_transpiler.py``.

Fluid's ``transpile(program, place, scope)`` folds batch_norm into the
preceding conv2d (``_fuse_batch_norm``).  Here it is a thin wrapper over
the ``bn-fold`` pass (passes/bn_fold.py), applied in place with the
verifier's pre/post checks every pipeline run gets.  Prefer::

    from paddle_tpu_torch.passes import PassPipeline
    program, result = PassPipeline(["bn-fold"]).run(
        test_prog, fetch_list=[pred.name], scope=scope)

or ``Executor(passes=True)`` / ``Inferencer(passes=True)``, which also fuse
loss heads, eliminate dead ops and insert donation.
"""
from __future__ import annotations

from typing import Optional

from ..core.framework import Program
from ..core.scope import Scope, global_scope
from ..log import VLOG

__all__ = ["InferenceTranspiler", "memory_optimize", "release_memory"]


class InferenceTranspiler:
    def transpile(self, program: Program, place=None,
                  scope: Optional[Scope] = None) -> None:
        """Fold conv2d -> (bias add) -> batch_norm chains of ``program`` in
        place by running the ``bn-fold`` pass on it; the program must be a
        test-mode program (``clone(for_test=True)``), as in Fluid."""
        scope = scope or global_scope()
        # the legacy contract rejects a train-mode program (the pass itself
        # would merely skip training-mode batch_norm ops)
        for op in program.desc.block(0).ops:
            if op.type == "batch_norm" and not op.attr("is_test", False):
                raise ValueError(
                    "InferenceTranspiler requires a test-mode program "
                    "(clone(for_test=True) first), like Fluid's")
        VLOG(1, "InferenceTranspiler is deprecated: it wraps the 'bn-fold' "
                "pass; prefer Executor(passes=True) or "
                "PassPipeline(['bn-fold']).run(...)")
        from ..passes import PassPipeline
        PassPipeline(["bn-fold"]).run(program, scope=scope, clone=False)


def memory_optimize(input_program: Program, skip_opt_set=None,
                    print_log: bool = False, level: int = 0) -> None:
    """Fluid's in-place var reuse by liveness analysis.  The executor
    already drops each value after its last reader (``core/lower.py``
    ``plan_frees``) and updates state in place, so the program-level
    rewrite does nothing here; the name is kept so Fluid scripts run.  The
    liveness-driven rewrites live in ``passes`` (``dead-op-elim``,
    ``donation-insert``)."""
    VLOG(1, "memory_optimize: no-op (the executor frees each value after its "
            "last reader; see paddle_tpu_torch.passes)")


def release_memory(input_program: Program, skip_opt_set=None) -> None:
    """Fluid's release_memory (inserts delete_var ops): a no-op here, for
    the same reason as :func:`memory_optimize`."""
    VLOG(1, "release_memory: no-op (the executor frees each value after its "
            "last reader)")
