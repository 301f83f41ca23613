"""Inferencer: build an inference program once, initialize its parameters,
run predictions.

The program is built under ``unique_name.guard()`` (fresh counters) so
parameter names are deterministic: the same ``infer_func`` built by the
JAX package's Inferencer names its parameters the same way, which is what
lets ``convert.params_from_numpy`` carry weights across.  One pinned
``Scope`` holds the parameters across every ``infer`` call.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .core import unique_name
from .core.desc import VarType
from .core.executor import Executor, Place
from .core.framework import Program, Variable, program_guard
from .core.scope import Scope


class Inferencer:
    def __init__(self, infer_func: Callable, place: Optional[Place] = None):
        self.scope = Scope()
        self.startup_program = Program()
        self.inference_program = Program()
        with unique_name.guard():
            with program_guard(self.inference_program, self.startup_program):
                self.predict_vars = infer_func()
                if not isinstance(self.predict_vars, (list, tuple)):
                    self.predict_vars = [self.predict_vars]
        self.exe = Executor(place)
        self.exe.run(self.startup_program, scope=self.scope)
        self.feed_names = [v.name for v in self._feed_vars()]

    def _feed_vars(self) -> List[Variable]:
        """The program's input vars: consumed but never produced by any op,
        dense, and not parameters/persistables."""
        block = self.inference_program.global_block
        produced = {n for op in block.desc.ops for n in op.output_names() if n}
        consumed = {n for op in block.desc.ops for n in op.input_names() if n}
        out = []
        for name, var in block.vars.items():
            vd = var.desc
            if (vd.persistable or vd.is_parameter
                    or vd.type != VarType.DENSE_TENSOR):
                continue
            if name in produced or name not in consumed:
                continue
            out.append(var)
        return out

    def warmup(self, batch_sizes: Sequence[int] = (1,),
               feed_specs: Optional[dict] = None) -> List[dict]:
        """Run one zero batch at each batch size, so the first live request
        at that size pays no one-time cost (kernel library build and load,
        cuBLAS handles and workspaces, allocator growth).

        ``feed_specs`` maps feed name -> ``(row_shape, dtype)`` (shape
        WITHOUT the batch dim), overriding what the program's data vars
        declare -- required for ragged models, whose non-batch dims are
        dynamic (include their ``@SEQ_LEN`` channels too).  Returns one
        record per batch size."""
        specs: dict = {}
        for v in self._feed_vars():
            specs[v.name] = (tuple(v.shape)[1:], v.dtype.np_dtype)
        if feed_specs:
            specs.update({k: (tuple(s), np.dtype(d))
                          for k, (s, d) in feed_specs.items()})
        for name, (shape, _) in specs.items():
            if any(int(d) < 0 for d in shape):
                raise ValueError(
                    f"feed {name!r} has dynamic non-batch dims {shape}; "
                    f"pass feed_specs={{name: (row_shape, dtype)}} with "
                    f"concrete dims (ragged models also need their "
                    f"@SEQ_LEN channels)")
        report = []
        for bs in batch_sizes:
            feed = {n: np.zeros((int(bs),) + tuple(int(d) for d in s), dtype=d)
                    for n, (s, d) in specs.items()}
            t0 = time.perf_counter()
            for h in self.infer(feed, sync=False):
                h.numpy()
            report.append({"batch_size": int(bs),
                           "seconds": time.perf_counter() - t0})
        return report

    def infer(self, inputs: dict, return_numpy: bool = True, sync: bool = True):
        """Run one prediction.  ``sync=False`` returns non-blocking
        :class:`~paddle_tpu_torch.core.staging.FetchHandle`\\ s (the serving
        engine's dispatch path)."""
        return self.exe.run(self.inference_program, feed=inputs,
                            fetch_list=list(self.predict_vars),
                            scope=self.scope, return_numpy=return_numpy,
                            sync=sync)
