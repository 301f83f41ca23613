"""Learning-rate schedules as ops in the program, built as the JAX package's
``layers/learning_rate_scheduler.py`` builds them: a persistable step
counter that each run of the program increments, cast to float32, and the
decay's math ops.  The schedule is computed on the device inside the step
(inside its CUDA graph on the card), and the optimizer's update reads the
result as its ``LearningRate``.  Every op a schedule builds is stamped
``op_role="lr_sched"``, so ``Program.clone(for_test=True)`` drops them and
an evaluation run never advances the counter.  ``piecewise_decay`` is a
``Switch`` over conditional sub-blocks, which the step's graph records
whole (``ops/control_flow_ops.py``).
"""
from __future__ import annotations

import functools
import math

from ..core import unique_name
from ..core.framework import op_role_guard
from ..layer_helper import LayerHelper
from . import control_flow, nn, tensor

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay"]


def _lr_sched(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with op_role_guard("lr_sched"):
            return fn(*args, **kwargs)
    return wrapped


def _decay_step_counter(begin: int = 0):
    """The global step counter: a persistable int64 [1] var (int32 in the
    scope, as in the JAX package's), incremented by each run of the
    program before the decay reads it, cast to float32 for the math."""
    counter = tensor.create_global_var(
        shape=[1], value=float(begin - 1), dtype="int64", persistable=True,
        name=unique_name.generate("@LR_DECAY_COUNTER@"))
    tensor.increment(counter, value=1, in_place=True)
    return tensor.cast(counter, "float32")


@_lr_sched
def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5), step from 1:
    the Transformer's schedule."""
    step = _decay_step_counter(begin=1)
    a = _pow(step, -0.5)
    b = nn.scale(step, scale=float(warmup_steps) ** -1.5)
    return nn.scale(nn.elementwise_min(a, b), scale=float(d_model) ** -0.5)


@_lr_sched
def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * decay_rate ^ (step / decay_steps), as exp((step / decay_steps) *
    ln decay_rate)."""
    step = _decay_step_counter()
    div = nn.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = _unary("floor", div)
    return nn.scale(_unary("exp", nn.scale(div, scale=math.log(float(decay_rate)))),
                    scale=float(learning_rate))


@_lr_sched
def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    step = _decay_step_counter()
    div = nn.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = _unary("floor", div)
    return nn.scale(_unary("exp", nn.scale(div, scale=-float(decay_rate))),
                    scale=float(learning_rate))


@_lr_sched
def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    step = _decay_step_counter()
    div = nn.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = _unary("floor", div)
    denom = nn.scale(div, scale=float(decay_rate), bias=1.0)
    helper = LayerHelper("elementwise_div")
    num = tensor.fill_constant(shape=[1], dtype="float32", value=float(learning_rate))
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op("elementwise_div", inputs={"X": num, "Y": denom}, outputs={"Out": out})
    return out


@_lr_sched
def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0,
                     cycle=False):
    """(lr - end) * (1 - min(step, decay_steps) / decay_steps)^power + end."""
    step = _decay_step_counter()
    capped = nn.elementwise_min(
        step, tensor.fill_constant(shape=[1], dtype="float32", value=float(decay_steps)))
    frac = nn.scale(capped, scale=-1.0 / float(decay_steps), bias=1.0)
    return nn.scale(_pow(frac, power), scale=float(learning_rate) - float(end_learning_rate),
                    bias=float(end_learning_rate))


@_lr_sched
def piecewise_decay(boundaries, values):
    """``values[i]`` while the step is below ``boundaries[i]``, the last
    value after them: a ``Switch`` of conditional blocks over the step
    counter, each assigning its value to a persistable rate."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _decay_step_counter()
    lr = tensor.create_global_var(shape=[1], value=float(values[0]), dtype="float32",
                                  persistable=True, name=unique_name.generate("piecewise_lr"))
    with control_flow.Switch() as switch:
        for i, b in enumerate(boundaries):
            bvar = tensor.fill_constant(shape=[1], dtype="float32", value=float(b))
            with switch.case(control_flow.less_than(step, bvar)):
                vvar = tensor.fill_constant(shape=[1], dtype="float32", value=float(values[i]))
                tensor.assign(vvar, output=lr)
        with switch.default():
            vvar = tensor.fill_constant(shape=[1], dtype="float32", value=float(values[-1]))
            tensor.assign(vvar, output=lr)
    return lr


def _pow(x, p):
    helper = LayerHelper("pow")
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op("pow", inputs={"X": x}, outputs={"Out": out}, attrs={"factor": float(p)})
    return out


def _unary(op_type, x):
    helper = LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out})
    return out
