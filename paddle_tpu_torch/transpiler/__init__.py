"""paddle_tpu_torch.transpiler — the legacy program-rewrite entry points.

``DistributeTranspiler`` splits a training program into trainer and
pserver programs (parameter-server training); ``InferenceTranspiler``
wraps the ``bn-fold`` pass; ``memory_optimize`` and ``release_memory``
keep Fluid's names and do nothing.
"""
from .distribute_transpiler import (DistributeTranspiler,
                                    DistributeTranspilerConfig)
from .inference_transpiler import (InferenceTranspiler, memory_optimize,
                                   release_memory)

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "InferenceTranspiler", "memory_optimize", "release_memory"]
