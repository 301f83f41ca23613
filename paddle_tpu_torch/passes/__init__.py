"""paddle_tpu_torch.passes — the verifier-checked ProgramDesc rewrite
pipeline, as in the JAX package's ``paddle_tpu.passes``.

Ordered, registered, fingerprint-aware passes over the ProgramDesc IR with
``analysis.verify`` run before and after every pass.  Seed passes
(``default_pipeline()``, ``Executor(passes=True)``):

* ``fuse-fc-softmax-ce`` — mul(+bias)+softmax_with_cross_entropy ->
  ``fused_fc_softmax_ce`` (K7 on the card);
* ``bn-fold`` — inference batch_norm folding into the preceding conv;
* ``dead-op-elim`` — acts on the D204 dead-op findings through
  ``core/prune.live_op_slice``;
* ``donation-insert`` — acts on the memory planner's M503 findings by
  stamping the ``donate`` feed attr.

Also registered: the dtype-policy passes ``amp-bf16`` and
``amp-quant-int8`` (``paddle_tpu_torch/amp``) and the kernel tier's
``pallas-kernels`` (``paddle_tpu_torch/ops/cuda``).  Entry points:
``Executor(passes=, amp=, kernels=)`` and the ``Inferencer`` /
``ServingSession`` plumbing, or ``default_pipeline().run(program,
fetch_list=..., scope=...)`` directly.
"""
from .base import (PASSES, PassContext, PassPipeline, PassResult,
                   PassVerificationError, PipelineResult, ProgramPass,
                   default_pipeline, export_pipeline_result, make_pipeline,
                   register_pass)
from .bn_fold import BnFoldPass
from .dead_ops import DeadOpEliminationPass
from .donation import DonationInsertionPass
from .fuse import FuseFcSoftmaxCePass
# the dtype-policy passes live in paddle_tpu_torch/amp but register into
# the same PASSES registry
from ..amp.passes import AmpBf16Pass, QuantInt8Pass


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
    "PASSES", "AmpBf16Pass", "BnFoldPass", "DeadOpEliminationPass",
    "DonationInsertionPass", "FuseFcSoftmaxCePass", "KernelPolicy",
    "PallasKernelsPass", "PassContext", "PassPipeline", "PassResult",
    "PassVerificationError", "PipelineResult", "ProgramPass",
    "QuantInt8Pass", "default_pipeline", "export_pipeline_result",
    "make_pipeline", "register_pass",
]
