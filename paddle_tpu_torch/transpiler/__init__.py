"""paddle_tpu_torch.transpiler — the legacy program-rewrite entry points.

``InferenceTranspiler`` wraps the ``bn-fold`` pass; ``memory_optimize``
and ``release_memory`` keep Fluid's names and do nothing.  The JAX
package's ``DistributeTranspiler`` is not ported yet (it needs the mesh).
"""
from .inference_transpiler import (InferenceTranspiler, memory_optimize,
                                   release_memory)

__all__ = ["InferenceTranspiler", "memory_optimize", "release_memory"]
