"""paddle_tpu_torch.passes — the ProgramDesc rewrite pipeline.

Ordered, registered, fingerprint-aware passes over the ProgramDesc IR, as
in the JAX package's ``paddle_tpu.passes``.  The registered passes are the
dtype-policy pass ``amp-quant-int8`` (``paddle_tpu_torch/amp``) and the
kernel tier's ``pallas-kernels`` (``paddle_tpu_torch/ops/cuda``).
Entry points: ``Executor(passes=, amp=, kernels=)`` and the
``Inferencer``/``ServingSession`` plumbing, or ``PassPipeline([...],
verify="off").run(program, fetch_list=...)`` directly.
"""
from .base import (PASSES, PassContext, PassPipeline, PassResult,
                   PipelineResult, ProgramPass, default_pipeline,
                   make_pipeline, register_pass)
from .bn_fold import BnFoldPass
# the dtype-policy pass lives in paddle_tpu_torch/amp but registers into
# the same PASSES registry
from ..amp.passes import QuantInt8Pass


def __getattr__(name):
    # the kernel tier (ops/cuda) imports THIS package's base module for
    # the pass machinery: resolve its names lazily so either package can
    # be imported first
    if name == "PallasKernelsPass":
        from ..ops.cuda.kernel_pass import PallasKernelsPass
        return PallasKernelsPass
    if name == "KernelPolicy":
        from ..ops.cuda.policy import KernelPolicy
        return KernelPolicy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PASSES", "BnFoldPass", "KernelPolicy", "PallasKernelsPass", "PassContext",
    "PassPipeline", "PassResult", "PipelineResult", "ProgramPass",
    "QuantInt8Pass", "default_pipeline", "make_pipeline", "register_pass",
]
