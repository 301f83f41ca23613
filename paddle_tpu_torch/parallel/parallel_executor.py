"""ParallelExecutor: multi-device data parallelism on DTensor, the JAX
package's ``parallel/parallel_executor.py``.

Reference architecture being replaced
(the reference's parallel_executor.cc:119-208 and
details/multi_devices_graph_pass.cc): clone scopes per GPU, broadcast
params over NCCL, build a per-device SSA op-handle graph with AllReduce
nodes, run it with a threaded dataflow executor.

Here the program's block runs once a step on every rank, on DTensors over
a mesh of the clique's ranks (one device a rank): each rank's feed rows
are its shard of the global batch, the parameters are replicated, and
DTensor reduces each gradient's partial sums before the update (the
reference's fused AllReduce).  On the card over NCCL the step is one CUDA
graph with its collectives inside.  The reference's knobs keep their
names:

* ``BuildStrategy.reduce_strategy = AllReduce`` → replicated params (DP);
  ``Reduce`` → parameters + optimizer state sharded over the data axis
  (the ZeRO-style descendant of the reference's reduce+broadcast placement
  round-robin, multi_devices_graph_pass.cc:412-424).
* feed splitting (reference FeedAndSplitTensorIntoLocalScopes,
  parallel_executor.cc:333-350) is each rank feeding its own rows.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.executor import Executor
from ..core.framework import Program, default_main_program
from ..core.scope import Scope, global_scope
from .mesh import make_mesh


class ReduceStrategy:
    AllReduce = 0
    Reduce = 1


class BuildStrategy:
    """reference details/build_strategy.h"""

    ReduceStrategy = ReduceStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0  # CoeffNumDevice
        self.debug_graphviz_path = ""


class ExecutionStrategy:
    """reference details/execution_strategy.h — thread knobs mean nothing
    to one program run a step (on the card, one CUDA graph); kept for API
    parity.  Setting one to a non-default value warns instead of silently
    doing nothing."""

    _DEFAULTS = {"num_threads": 0, "allow_op_delay": False,
                 "num_iteration_per_drop_scope": 100}

    def __init__(self):
        for k, v in self._DEFAULTS.items():
            object.__setattr__(self, k, v)

    def __setattr__(self, name, value):
        if name in self._DEFAULTS and value != self._DEFAULTS[name]:
            import warnings
            warnings.warn(
                f"ExecutionStrategy.{name} has no effect: the executor "
                f"runs one program a step (no op-handle thread pool to tune)",
                stacklevel=2)
        object.__setattr__(self, name, value)


class ParallelExecutor:
    """reference python/paddle/fluid/parallel_executor.py:67.

    ``use_cuda`` picks the card (``CUDAPlace``, NCCL) or the CPU (gloo)
    when the process group is not joined yet; ``num_trainers > 1`` joins
    it through ``distributed.init_parallel_env``."""

    def __init__(self, use_cuda: bool = True, use_tpu: Optional[bool] = None,
                 loss_name: Optional[str] = None,
                 main_program: Optional[Program] = None,
                 share_vars_from: Optional["ParallelExecutor"] = None,
                 exec_strategy: Optional[ExecutionStrategy] = None,
                 build_strategy: Optional[BuildStrategy] = None,
                 num_trainers: int = 1, trainer_id: int = 0,
                 scope: Optional[Scope] = None, mesh=None, layout=None):
        from .. import distributed as dist
        from ..core.executor import CPUPlace, CUDAPlace
        self._program = main_program or default_main_program()
        # layout: a SpecLayout (parallel/layout.py) — declarative
        # data × fsdp × tp sharding of params + optimizer state; supersedes
        # the Reduce strategy's dim-0 annotation pass below
        self._layout = layout
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._scope = scope or global_scope()
        self.loss_name = loss_name
        place = CUDAPlace(0) if use_cuda else CPUPlace()
        if num_trainers > 1 or not dist._state["initialized"]:
            # multi-trainer mode (reference "nccl2": world-spanning comms
            # built from num_trainers/trainer_id, nccl_helper.h:109-119)
            dist.init_parallel_env(trainer_id=trainer_id, num_trainers=num_trainers,
                                   place=place)
            if dist.num_trainers() != num_trainers or dist.trainer_id() != trainer_id:
                raise ValueError(
                    f"ParallelExecutor(num_trainers={num_trainers}, "
                    f"trainer_id={trainer_id}) disagrees with the initialized "
                    f"distributed runtime ({dist.num_trainers()}, "
                    f"{dist.trainer_id()})")
        self.num_trainers = dist.num_trainers()
        self.trainer_id = dist.trainer_id()
        if mesh is None and layout is not None and layout.mesh_axes:
            self._mesh = make_mesh(layout.mesh_axes)
        else:
            self._mesh = mesh if mesh is not None else make_mesh()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope
        if (self._build_strategy.reduce_strategy == ReduceStrategy.Reduce
                and layout is None):
            self._shard_params_over_data_axis()
        if self._build_strategy.debug_graphviz_path:
            raise NotImplementedError(
                "BuildStrategy.debug_graphviz_path needs debugger.py, not ported to "
                "paddle_tpu_torch yet (ROADMAP §A item 14)")
        self._executor = Executor(mesh=self._mesh, layout=layout)
        self.device_count = int(np.prod(self._mesh.devices.shape))
        # place params (and any optimizer slots already created) at init:
        # rank 0's values onto the placements before step 0, the reference's
        # BCastParamsToDevices; vars the startup has not initialized yet are
        # placed by the first step that reads them
        from .layout import shard_program_state
        shard_program_state(self._program, self._scope, self._mesh, layout)

    def _shard_params_over_data_axis(self):
        """ZeRO-ish: annotate parameters (and their optimizer accumulators,
        which share the leading dim) to shard dim 0 over 'data' when it
        divides evenly.  DTensor then all-gathers params for compute and
        reduce-scatters grads — the analogue of the reference's kReduce
        strategy."""
        n = int(np.prod(self._mesh.devices.shape))
        for var in self._program.list_vars():
            if not var.persistable or not var.shape:
                continue
            if var.shape[0] % n == 0 and int(np.prod(var.shape)) >= n * 1024:
                var.set_sharding(["data"] + [None] * (len(var.shape) - 1))

    def run(self, fetch_list: Sequence, feed: Optional[dict] = None,
            feed_dict: Optional[dict] = None, return_numpy: bool = True):
        feed = feed if feed is not None else feed_dict
        return self._executor.run(self._program, feed=feed,
                                  fetch_list=list(fetch_list),
                                  scope=self._scope,
                                  return_numpy=return_numpy)

    @property
    def mesh(self):
        return self._mesh
