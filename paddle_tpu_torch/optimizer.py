"""Optimizer classes: ``minimize`` = ``append_backward`` + per-parameter
update ops.  Accumulators (moments, beta powers) and the learning rate are
persistable vars initialized by the startup program; the update rules are
the ops of ``ops/optimizer_ops.py``.  Builds the same ops, vars and attrs
as the JAX package's ``optimizer.py``.

Gradient clipping and regularization are ported for the case without
either (what the transformer's training path uses); any other case raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .backward import append_backward
from .core import unique_name
from .core.framework import (Block, Parameter, Program, Variable,
                             default_main_program, default_startup_program)


def append_gradient_clip_ops(params_grads):
    """Gradient clipping: only the no-clip case is ported."""
    clipped = [p.name for p, _ in params_grads
               if getattr(p, "gradient_clip", None) is not None]
    if clipped:
        raise NotImplementedError(f"gradient clipping is not ported yet (params {clipped})")
    return params_grads


def append_regularization_ops(params_grads, regularization=None):
    """Weight decay: only the no-regularizer case is ported."""
    regular = [p.name for p, g in params_grads
               if g is not None and (p.regularizer or regularization) is not None]
    if regular:
        raise NotImplementedError(f"regularization is not ported yet (params {regular})")
    return params_grads


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self._learning_rate_var: Optional[Variable] = None
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}

    def _global_learning_rate(self) -> Variable:
        """The learning-rate var: the given Variable, or a persistable
        float32 scalar set by a ``fill_constant`` in the startup program."""
        if self._learning_rate_var is not None:
            return self._learning_rate_var
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_var = self._learning_rate
            return self._learning_rate_var
        name = unique_name.generate("learning_rate")
        lr = default_main_program().global_block.create_var(
            name=name, shape=(), dtype="float32", persistable=True)
        startup = default_startup_program().global_block
        svar = startup.create_var(name=name, shape=(), dtype="float32", persistable=True)
        startup.append_op("fill_constant", outputs={"Out": svar},
                          attrs={"shape": [], "dtype": svar.dtype,
                                 "value": float(self._learning_rate)})
        self._learning_rate_var = lr
        return lr

    def _add_accumulator(self, name: str, param: Parameter, shape=None,
                         fill_value: float = 0.0, dtype=None) -> Variable:
        if param.name in self._accumulators.get(name, {}):
            return self._accumulators[name][param.name]
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = tuple(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        acc = default_main_program().global_block.create_var(
            name=var_name, shape=shape, dtype=dtype, persistable=True)
        startup = default_startup_program().global_block
        svar = startup.create_var(name=var_name, shape=shape, dtype=dtype, persistable=True)
        # which param the slot belongs to (the JAX package's layouts shard
        # a slot as its param)
        acc.desc.attrs["slot_of"] = param.name
        svar.desc.attrs["slot_of"] = param.name
        startup.append_op("fill_constant", outputs={"Out": svar},
                          attrs={"shape": list(shape), "dtype": dtype,
                                 "value": float(fill_value)})
        self._accumulators.setdefault(name, {})[param.name] = acc
        return acc

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def minimize(self, loss: Variable, startup_program: Optional[Program] = None,
                 parameter_list=None, no_grad_set=None
                 ) -> Tuple[List, List[Tuple[Parameter, Variable]]]:
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        return self._create_optimization_pass(params_grads), params_grads

    def _create_optimization_pass(self, params_grads):
        block = default_main_program().global_block
        self._global_learning_rate()
        self._create_accumulators(block, [p for p, _ in params_grads])
        return [self._append_optimize_op(block, (p, g)) for p, g in params_grads
                if g is not None and p.trainable]

    def _create_accumulators(self, block: Block, params: List[Parameter]):
        pass

    def _append_optimize_op(self, block: Block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd", inputs={"Param": p, "Grad": g,
                           "LearningRate": self._global_learning_rate()},
            outputs={"ParamOut": p}, attrs={"op_role": "optimize"})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow", p, shape=(), fill_value=1.0)
            self._add_accumulator("beta2_pow", p, shape=(), fill_value=1.0)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        slots = {slot: self._get_accumulator(acc, p) for slot, acc in (
            ("Moment1", "moment1"), ("Moment2", "moment2"),
            ("Beta1Pow", "beta1_pow"), ("Beta2Pow", "beta2_pow"))}
        return block.append_op(
            "adam",
            inputs={"Param": p, "Grad": g, **slots,
                    "LearningRate": self._global_learning_rate()},
            outputs={"ParamOut": p, **{s + "Out": v for s, v in slots.items()}},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "op_role": "optimize"})


SGD = SGDOptimizer
Adam = AdamOptimizer
