"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

Mirrors the JAX package's structure and names.  Programs are built as
ProgramDescs by ``layers``, differentiated by ``append_backward``, given
update ops by an ``optimizer``, and run eagerly, op by op, by the
``Executor`` on a CUDA device (``CUDAPlace(0)``, the default) or, when
asked, on the CPU.  Attention, embedding lookups and their gradients, the
fused loss head, SGD and Adam go through hand-written CUDA kernels
(``ops/cuda/``, sources in ``csrc/``), built with nvcc at first use.  The
pass pipeline (``passes``) rewrites programs onto the kernel tier, and
``amp.AmpConfig(bf16=False, quant=True)`` serves every ``mul`` through the
int8 GEMM kernel.  ``Trainer`` trains from a reader (``reader``,
``DataFeeder``), staging batches to the card on a background thread, with
serial-dir checkpoints; ``io`` saves and loads in the JAX package's
formats.

This package imports torch, numpy and the standard library only -- never
jax or paddle_tpu.
"""
from . import ops  # noqa: F401  (registers every op lowering)
from . import (amp, checkpoint, io, layers, lod, models, optimizer,  # noqa: F401
               passes, reader, telemetry)
from .backward import append_backward  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
from .core import unique_name  # noqa: F401
from .core.executor import CPUPlace, CUDAPlace, Executor, Place  # noqa: F401
from .core.framework import (Program, Variable, default_main_program,  # noqa: F401
                             default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from .serving import ServingSession  # noqa: F401
from .reader.decorator import batch  # noqa: F401
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,  # noqa: F401
                      EndEpochEvent, EndStepEvent, Inferencer, Trainer)
