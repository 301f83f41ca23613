"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

Mirrors the JAX package's structure and names.  Programs are built as
ProgramDescs by ``layers``, differentiated by ``append_backward``, given
update ops by an ``optimizer``, and run eagerly, op by op, by the
``Executor`` on a CUDA device (``CUDAPlace(0)``, the default) or, when
asked, on the CPU.  Attention, embedding lookups and their gradients, the
fused loss head, SGD and Adam go through hand-written CUDA kernels
(``ops/cuda/``, sources in ``csrc/``), built with nvcc at first use; the
other update rules (``optimizer``), learning-rate schedules
(``layers.noam_decay`` and the decays), gradient clips (``clip``) and
regularizers (``regularizer``) run in the same step.  The
pass pipeline (``passes``) rewrites programs onto the kernel tier (and,
with ``passes=True``, fuses loss heads onto K7, folds batch norms, drops
dead ops and stamps donations), and ``amp.AmpConfig(bf16=False,
quant=True)`` serves every ``mul`` through the int8 GEMM kernel.  The
static analysis (``analysis``: the verifier behind ``Executor(validate=)``
and the memory planner behind ``Executor(memory_budget=)``) checks a
program before it first runs.  ``Trainer`` trains from a reader (``reader``,
``DataFeeder``), staging batches to the card on a background thread, with
serial-dir checkpoints or the async ``checkpoint.CheckpointManager``;
``io`` and ``checkpoint`` save and load in the JAX package's formats.  The data path:
``recordio`` (the chunked record files, scanned by a C++ library built
with ``g++`` at first use), ``dispatch`` (the lease master, its client and
``Trainer(dispatch=)``), the in-graph readers (``layers.py_reader``,
``layers.open_files``, the executor's ``read`` binding), ``reader.DeviceLoader``
and ``metrics``.  Observability: ``telemetry`` (metrics, the trace timeline, step
records), ``health`` (the training flight recorder: sentinels inside the
step, first-bad-op localization, divergence events), ``flags`` (the
gflags registry: ``FLAGS.check_nan_inf``, ``FLAGS.benchmark``), ``faults``
(seeded fault injection), ``profiler`` (host spans, chrome traces, ``device_trace``),
``profiling`` (the sampled per-op profiler behind
``Executor.profile_ops`` and ``Trainer(profile_steps=)``), ``compile_log``
(the capture log), ``resource_sampler`` (memory and stager gauges;
``PADDLE_TPU_SAMPLER=1`` starts it at import) and ``log`` (``VLOG``).

This package imports torch, numpy and the standard library only -- never
jax or paddle_tpu.
"""
from . import ops  # noqa: F401  (registers every op lowering)
from . import (amp, analysis, checkpoint, clip, compile_log, dataset, dispatch,  # noqa: F401
               embedding, faults, flags, health, initializer, io, layers, lod, log,
               metrics, models, nets, optimizer, passes, profiler, profiling, reader,
               recordio, regularizer, resource_sampler, telemetry, transpiler)
from .backward import append_backward, calc_gradient  # noqa: F401
from .clip import (ErrorClipByValue, GradientClipByGlobalNorm,  # noqa: F401
                   GradientClipByNorm, GradientClipByValue)
from .convert import params_from_numpy  # noqa: F401
from .core import unique_name  # noqa: F401
from .core.executor import CPUPlace, CUDAPlace, EOFException, Executor, Place  # noqa: F401
from .core.framework import (Program, Variable, default_main_program,  # noqa: F401
                             default_startup_program, program_guard)
from .core.scope import Scope, global_scope, scope_guard  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from .serving import ServingSession  # noqa: F401
from .transpiler import (InferenceTranspiler, memory_optimize,  # noqa: F401
                         release_memory)
from .reader.decorator import batch  # noqa: F401
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,  # noqa: F401
                      EndEpochEvent, EndStepEvent, Inferencer, Trainer)

# PADDLE_TPU_SAMPLER=1 starts the background resource sampler with no code
# change (off by default: no thread)
resource_sampler._maybe_autostart()
