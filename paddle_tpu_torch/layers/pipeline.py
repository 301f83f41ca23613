"""PipelinedStages: the Program-IR surface for pipeline parallelism.

Usage (Fluid-style, mirroring the While/StaticRNN sub-block pattern)::

    pipe = layers.PipelinedStages(input=h, n_stages=4, n_micro=8)
    with pipe.block() as s:                 # s: the stage input Variable
        y = layers.fc(input=s, size=d, act="relu")
        pipe.complete(y)                    # stage output (same shape as s)
    h = pipe.output

Every stage runs the SAME body on its own parameters: parameters created
inside ``block()`` are transparently stored stacked with a leading
``n_stages`` dim (each stage sees its slice), the SPMD form of pipeline
parallelism.  Under an executor mesh with a ``pipe`` axis the op lowers
to the GPipe microbatch schedule (parallel/pipeline.py: ppermute between
the stages' ranks); without one it runs the stages sequentially — the
same function either way.
"""
from __future__ import annotations

import contextlib

from ..core import unique_name
from ..layer_helper import LayerHelper

__all__ = ["PipelinedStages"]

_BUILDING = False    # nesting guard: stacked-param capture patches
                     # LayerHelper.create_parameter class-wide


class PipelinedStages:
    def __init__(self, input, n_stages: int, n_micro: int,
                 pipe_axis: str = "pipe", name=None):
        self.helper = LayerHelper("pipeline", name=name)
        self._input = input
        self.n_stages = int(n_stages)
        self.n_micro = int(n_micro)
        self.pipe_axis = pipe_axis
        self._stage_out_name = None
        self._param_map = {}        # stored (stacked) name -> view name
        self.output = None

    @contextlib.contextmanager
    def block(self):
        global _BUILDING
        if _BUILDING:
            raise RuntimeError(
                "PipelinedStages.block() does not nest (stack deeper "
                "layers inside ONE stage body instead)")
        program = self.helper.main_program
        parent_block = program.current_block()
        sub = program.create_block()
        stage_in = sub.create_var(
            name=unique_name.generate("pipeline_stage_in"),
            shape=tuple(self._input.shape), dtype=self._input.dtype)

        # parameters created while the stage body builds get stacked
        # storage [n_stages, ...] plus a stage-view var the body's ops
        # reference; the lowering binds the view to the per-stage slice
        pipe = self
        orig_create = LayerHelper.create_parameter

        def stacked_create(helper_self, attr, shape, dtype, is_bias=False,
                           default_initializer=None):
            # the stacked [n_stages, ...] startup var must NOT change the
            # init statistics: fix shape-dependent fans to the PER-STAGE
            # shape (rank-3 fans computed on the stacked shape would be
            # ~n_stages*D too large).  Applies to the
            # default AND to ParamAttr/explicitly-supplied Xavier/MSRA
            # initializers whose fans were left automatic.
            import copy as _copy

            from ..initializer import (MSRAInitializer, XavierInitializer,
                                       _fan_in_out)
            from ..param_attr import ParamAttr

            import types
            fi, fo = _fan_in_out(
                types.SimpleNamespace(shape=tuple(shape)))

            def fix_fans(init):
                if isinstance(init, XavierInitializer):
                    init = _copy.copy(init)
                    init.fan_in = (init.fan_in if init.fan_in is not None
                                   else fi)
                    init.fan_out = (init.fan_out
                                    if init.fan_out is not None else fo)
                elif isinstance(init, MSRAInitializer):
                    init = _copy.copy(init)
                    init.fan_in = (init.fan_in if init.fan_in is not None
                                   else fi)
                return init

            if default_initializer is None and not is_bias:
                default_initializer = XavierInitializer(fan_in=fi,
                                                        fan_out=fo)
            else:
                default_initializer = fix_fans(default_initializer)
            attr = ParamAttr._to_attr(attr)
            if getattr(attr, "initializer", None) is not None:
                attr = _copy.copy(attr)
                attr.initializer = fix_fans(attr.initializer)
            param = orig_create(helper_self, attr,
                                [pipe.n_stages] + list(shape), dtype,
                                is_bias=is_bias,
                                default_initializer=default_initializer)
            view = sub.create_var(
                name=unique_name.generate(param.name + "@STAGE"),
                shape=tuple(shape), dtype=param.dtype)
            pipe._param_map[param.name] = view.name
            return view

        _BUILDING = True
        LayerHelper.create_parameter = stacked_create
        try:
            yield stage_in
        finally:
            LayerHelper.create_parameter = orig_create
            _BUILDING = False
            # always leave the program building into the PARENT block —
            # an exception in the stage body must not strand subsequent
            # layers inside the half-built sub-block
            program.rollback()
        if self._stage_out_name is None:
            raise ValueError("pipe.complete(out) was never called inside "
                             "the pipeline block")
        # closed-world stage body: every input must be the stage input, a
        # param view, or produced inside the block — closures over outer
        # vars would KeyError deep in lowering otherwise
        from ..core.registry import op_draws
        defined = {stage_in.name} | set(self._param_map.values()) \
            | set(sub.desc.vars)

        def check_random(od):
            # an op that draws from the generator (in a nested sub-block
            # too): every stage and microbatch would share one draw
            if op_draws(od, program.desc):
                raise ValueError(
                    f"pipeline stage bodies must be deterministic and "
                    f"side-effect free (op {od.type!r}): all stages/"
                    f"microbatches would share one RNG key — apply "
                    f"dropout/random ops outside the pipeline or with "
                    f"is_test=True")

        for od in sub.desc.ops:
            check_random(od)
            for n in od.input_names():
                if n and n not in defined:
                    raise ValueError(
                        f"pipeline stage body reads {n!r} from outside "
                        f"the block — stage bodies are closed over their "
                        f"stage input and parameters only (make it a "
                        f"parameter or compute it inside the block)")
            defined.update(n for n in od.output_names() if n)
        out = parent_block.create_var(
            name=unique_name.generate("pipeline_out"),
            shape=tuple(self._input.shape), dtype=self._input.dtype)
        op = parent_block.append_op(
            "pipeline",
            inputs={"X": self._input,
                    "Params": sorted(self._param_map)},
            outputs={"Out": out},
            attrs={"n_stages": self.n_stages, "n_micro": self.n_micro,
                   "pipe_axis": self.pipe_axis,
                   "stage_in": stage_in.name,
                   "stage_out": self._stage_out_name,
                   "stage_params": dict(self._param_map)})
        op.desc.set_block_attr("sub_block", sub.idx)
        self.output = out

    def complete(self, out_var):
        """Declare the stage body's output (must match the stage input's
        shape/dtype — pipeline stages compose)."""
        self._stage_out_name = out_var.name
