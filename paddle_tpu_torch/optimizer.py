"""Optimizer classes: ``minimize`` = ``append_backward``, the gradient
clips (clip.py), the regularizers (regularizer.py), then one update op per
parameter.  Accumulators (moments, beta powers) and a constant learning
rate are persistable vars initialized by the startup program; a schedule's
learning rate (layers/learning_rate_scheduler.py) is a [1] var the step
computes.  The update rules are the ops of ``ops/optimizer_ops.py``.
Builds the same ops, vars and attrs as the JAX package's ``optimizer.py``:
``SGD``, ``Momentum``, ``LarsMomentum``, ``Adam``, ``Adamax``,
``Adagrad``, ``DecayedAdagrad``, ``Adadelta``, ``RMSProp``, ``Ftrl`` and
``ModelAverage``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from .backward import append_backward
from .clip import append_gradient_clip_ops
from .core import unique_name
from .core.framework import (Block, Parameter, Program, Variable,
                             default_main_program, default_startup_program)
from .core.scope import global_scope
from .regularizer import append_regularization_ops


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
        # clip, then regularize (the JAX package's order)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        return self._create_optimization_pass(params_grads), params_grads

    def apply_gradients(self, params_grads):
        return self._create_optimization_pass(params_grads)

    def _create_optimization_pass(self, params_grads):
        block = default_main_program().global_block
        self._global_learning_rate()
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = [self._append_optimize_op(block, (p, g)) for p, g in params_grads
               if g is not None and p.trainable]
        self._finish_update(block, params_grads)
        return ops

    def _create_accumulators(self, block: Block, params: List[Parameter]):
        pass

    def _finish_update(self, block: Block, params_grads):
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


def _update(optimizer, block, op_type, param_and_grad, slots, attrs, lr=True,
            extra_inputs=()):
    """Append ``op_type`` updating Param and the accumulators ``slots``
    ((input slot, output slot, accumulator name)) in place; it also reads
    the accumulators ``extra_inputs`` ((input slot, accumulator name))."""
    p, g = param_and_grad
    inputs = {"Param": p, "Grad": g}
    outputs = {"ParamOut": p}
    for slot, out_slot, acc in slots:
        inputs[slot] = outputs[out_slot] = optimizer._get_accumulator(acc, p)
    for slot, acc in extra_inputs:
        inputs[slot] = optimizer._get_accumulator(acc, p)
    if lr:
        inputs["LearningRate"] = optimizer._global_learning_rate()
    return block.append_op(op_type, inputs=inputs, outputs=outputs,
                           attrs={**attrs, "op_role": "optimize"})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "momentum", param_and_grad,
                       [("Velocity", "VelocityOut", "velocity")],
                       {"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=1e-3, lars_weight_decay=5e-4, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "lars_momentum", param_and_grad,
                       [("Velocity", "VelocityOut", "velocity")],
                       {"mu": self._momentum, "lars_coeff": self._lars_coeff,
                        "lars_weight_decay": self._lars_weight_decay})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            # beta1^t at the update, starting at beta1 (1.0 would divide the
            # first step's bias correction by zero)
            self._add_accumulator("beta1_pow", p, shape=(), fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "adamax", param_and_grad,
                       [("Moment", "MomentOut", "moment"), ("InfNorm", "InfNormOut", "inf_norm")],
                       {"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon},
                       extra_inputs=[("Beta1Pow", "beta1_pow")])

    def _finish_update(self, block, params_grads):
        """Advance each beta1 power after all the updates."""
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow", p)
            block.append_op("scale", inputs={"X": b1p}, outputs={"Out": b1p},
                            attrs={"scale": self._beta1, "op_role": "optimize"})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "adagrad", param_and_grad,
                       [("Moment", "MomentOut", "moment")], {"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "decayed_adagrad", param_and_grad,
                       [("Moment", "MomentOut", "moment")],
                       {"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    """Adadelta reads no learning rate (the startup program still sets
    one, as the JAX package's does)."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "adadelta", param_and_grad,
                       [("AvgSquaredGrad", "AvgSquaredGradOut", "avg_squared_grad"),
                        ("AvgSquaredUpdate", "AvgSquaredUpdateOut", "avg_squared_update")],
                       {"epsilon": self._epsilon, "rho": self._rho}, lr=False)


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "rmsprop", param_and_grad,
                       [("MeanSquare", "MeanSquareOut", "mean_square"),
                        ("Moment", "MomentOut", "momentum")],
                       {"decay": self._rho, "epsilon": self._epsilon,
                        "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, params):
        for p in params:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        return _update(self, block, "ftrl", param_and_grad,
                       [("SquaredAccumulator", "SquaredAccumOut", "squared"),
                        ("LinearAccumulator", "LinearAccumOut", "linear")],
                       {"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging.  Appends one
    ``average_accumulates`` op a trainable parameter to the current main
    program (call it after ``minimize``); at evaluation::

        with model_average.apply(exe):
            ... run inference on the averaged parameters ...

    puts each parameter's windowed average into the global scope's tensor
    and the live values back on exit.  Both are copies into the scope's own
    tensors (``copy_``), so a step's captured CUDA graph stays valid: no
    tensor is rebound.
    """

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = float(average_window_rate)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        block = default_main_program().global_block
        self.params = [p for p in block.all_parameters() if p.trainable]
        self._suffixes = ("sum_1", "sum_2", "sum_3")
        for param in self.params:
            s1, s2, s3 = (self._add_accumulator(k, param) for k in self._suffixes)
            na, oa, nu = (self._add_accumulator(k, param, shape=(1,), dtype="int32") for k in (
                "num_accumulates", "old_num_accumulates", "num_updates"))
            block.append_op(
                "average_accumulates",
                inputs={"param": param, "in_sum_1": s1, "in_sum_2": s2, "in_sum_3": s3,
                        "in_num_accumulates": na, "in_old_num_accumulates": oa,
                        "in_num_updates": nu},
                outputs={"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
                         "out_num_accumulates": na, "out_old_num_accumulates": oa,
                         "out_num_updates": nu},
                attrs={"average_window": self.average_window,
                       "min_average_window": self.min_average_window,
                       "max_average_window": self.max_average_window,
                       "op_role": "optimize"})

    def _avg(self, scope, param):
        """(sum_1 + sum_2 + sum_3) / max(num_accumulates +
        old_num_accumulates, 1), summed and divided in float64 and rounded
        once to float32, as the JAX package computes it on the host."""
        accs = self._accumulators
        total = sum(scope.find_var(accs[k][param.name].name).double() for k in self._suffixes)
        n = sum(int(scope.find_var(accs[k][param.name].name).reshape(()))
                for k in ("num_accumulates", "old_num_accumulates"))
        return (total / max(n, 1)).to(torch.float32)

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True):
        """Each parameter's average copied into its tensor for the block;
        the live values copied back after it unless ``need_restore`` is
        False."""
        scope = global_scope()
        backup = {}
        for p in self.params:
            t = scope.find_var(p.name)
            backup[p.name] = t.clone()
            t.copy_(self._avg(scope, p))
        try:
            yield
        finally:
            if need_restore:
                for p in self.params:
                    scope.find_var(p.name).copy_(backup[p.name])

    def restore(self, executor=None):
        """No-op outside ``apply()`` (the JAX package's)."""


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
