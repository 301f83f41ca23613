"""Control-flow layers: While, ConditionalBlock, Switch, StaticRNN, IfElse,
DynamicRNN, the comparison and logical layers, and the tensor arrays.

The API and the ProgramDescs are the JAX package's
(``paddle_tpu/layers/control_flow.py``, itself Fluid's): a construct's
body is a sub-block (``Program.create_block`` / ``rollback``) and the op
that owns it declares the names the body reads from the enclosing block
(``X``) and writes there (``Out``).  ``ops/control_flow_ops.py`` lowers
them.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

from ..core import unique_name
from ..core.desc import VarType, block_outer_reads, block_written_names
from ..core.dtypes import convert_dtype
from ..core.framework import Parameter, Variable
from ..layer_helper import LayerHelper

__all__ = ["While", "StaticRNN", "DynamicRNN", "IfElse", "Switch", "ConditionalBlock",
           "less_than", "less_equal", "greater_than", "greater_equal", "equal", "not_equal",
           "logical_and", "logical_or", "logical_not", "array_write", "array_read",
           "array_length", "create_array", "increment"]


# ------------------------------------------------------ comparison / logical

def _compare_layer(op_type):
    def layer(x, y, cond=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if cond is None:
            cond = helper.create_tmp_variable(dtype="bool")
        helper.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": cond})
        cond.desc.dtype = convert_dtype("bool")
        return cond
    layer.__name__ = op_type
    return layer


less_than = _compare_layer("less_than")
less_equal = _compare_layer("less_equal")
greater_than = _compare_layer("greater_than")
greater_equal = _compare_layer("greater_equal")
equal = _compare_layer("equal")
not_equal = _compare_layer("not_equal")
logical_and = _compare_layer("logical_and")
logical_or = _compare_layer("logical_or")


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    if out is None:
        out = helper.create_tmp_variable(dtype="bool")
    helper.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


def increment(x, value=1.0, in_place=True):
    from .tensor import increment as _inc
    return _inc(x, value=value, in_place=in_place)


# -------------------------------------------------------------- tensor arrays

def create_array(dtype="float32"):
    helper = LayerHelper("create_array")
    return helper.main_program.current_block().create_var(
        name=unique_name.generate("array"), dtype=dtype, type=VarType.TENSOR_ARRAY)


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(dtype=x.dtype)
    helper.append_op("array_write", inputs={"X": x, "I": i}, outputs={"Out": array})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op("array_read", inputs={"X": array, "I": i}, outputs={"Out": out})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_tmp_variable(dtype="int32")
    helper.append_op("array_length", inputs={"X": array}, outputs={"Out": out})
    return out


# ---------------------------------------------------------------------- While

def _sub_block_interface(parent_block, sub):
    """(reads, writes) of a closed sub-block with respect to the enclosing
    block, declared on the op so that the backward slice and the grad
    makers see the body's data flow.  A read-modify-written carry is in
    both lists: without its read the backward slice would not reach the
    producer of its value before the loop."""
    writes = [n for n in block_written_names(sub.desc)
              if n not in sub.desc.vars and parent_block.desc.find_var(n) is not None]
    reads = [n for n in block_outer_reads(sub.desc)
             if parent_block.desc.find_var(n) is not None]
    return reads, writes


class While:
    """A loop over a sub-block while ``cond`` holds; the body must compute
    the condition again::

        cond = layers.less_than(i, limit)
        w = layers.While(cond, max_iters=16)
        with w.block():
            ...
            layers.increment(i)
            layers.less_than(i, limit, cond=cond)

    With ``max_iters`` (an upper bound on the trips) the loop runs that
    many masked trips on the device: a CUDA graph records it, and it is
    differentiable (trips past the bound are cut, forward and backward
    alike).  Without, the condition is read on the host before each trip,
    the program runs op by op, and ``append_backward`` raises if a
    gradient is asked through the loop."""

    def __init__(self, cond: Variable, is_test: bool = False, name=None,
                 max_iters: Optional[int] = None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_iters = max_iters

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub = program.create_block()
        yield
        program.rollback()
        attrs = {"op_uid": unique_name.generate("while_uid")}
        if self.max_iters is not None:
            attrs["max_iters"] = int(self.max_iters)
        reads, writes = _sub_block_interface(parent_block, sub)
        op = parent_block.append_op("while", inputs={"Condition": self.cond_var, "X": reads},
                                    outputs={"Out": writes}, attrs=attrs)
        op.desc.set_block_attr("sub_block", sub.idx)


# ------------------------------------------------- ConditionalBlock / Switch

class ConditionalBlock:
    """A sub-block that runs where the scalar condition holds.  What it
    writes must be defined before it (``fill_constant`` / ``assign``): the
    values where the condition is false.  Differentiable on both
    branches."""

    def __init__(self, inputs: List[Variable], is_scalar_condition=True, name=None):
        self.inputs = inputs
        self.helper = LayerHelper("conditional_block", name=name)

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        sub = program.create_block()
        yield
        program.rollback()
        reads, writes = _sub_block_interface(parent_block, sub)
        op = parent_block.append_op(
            "conditional_block", inputs={"Cond": self.inputs, "X": reads},
            outputs={"Out": writes},
            attrs={"is_scalar_condition": True, "op_uid": unique_name.generate("cond_uid")})
        op.desc.set_block_attr("sub_block", sub.idx)


class Switch:
    """The first case whose condition holds runs::

        with layers.Switch() as switch:
            with switch.case(cond1): ...
            with switch.case(cond2): ...
            with switch.default(): ...
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.pre_not_conditions: List[Variable] = []
        self.inside = False

    def _none_before(self):
        acc = self.pre_not_conditions[0]
        for c in self.pre_not_conditions[1:]:
            acc = logical_and(acc, c)
        return acc

    @contextlib.contextmanager
    def case(self, condition: Variable):
        if not self.inside:
            raise RuntimeError("Switch.case must be used inside 'with Switch()'")
        # active iff condition and no earlier condition
        active = logical_and(condition, self._none_before()) if self.pre_not_conditions \
            else condition
        self.pre_not_conditions.append(logical_not(condition))
        with ConditionalBlock([active]).block():
            yield

    @contextlib.contextmanager
    def default(self):
        if not self.pre_not_conditions:
            raise RuntimeError("Switch.default requires at least one case")
        with ConditionalBlock([self._none_before()]).block():
            yield

    def __enter__(self):
        self.inside = True
        return self

    def __exit__(self, *exc):
        self.inside = False
        return False


# ------------------------------------------------------------------ StaticRNN

class StaticRNN:
    """A recurrence over time-major sequences [T, ...], differentiable
    (the generic grad re-runs the T steps; the parameters the cell reads
    take their gradients)::

        rnn = layers.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x_tm)        # x_tm: [T, B, D]
            prev = rnn.memory(init=h0)         # h0:   [B, H]
            h = layers.fc(input=layers.concat([word, prev], 1), size=H, act="tanh")
            rnn.update_memory(prev, h)
            rnn.step_output(h)
        outs = rnn()                            # [T, B, H]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("recurrent", name=name)
        self._seq_inputs: List[Variable] = []
        self._step_input_vars: List[str] = []
        self._init_states: List[Variable] = []
        self._ex_state_vars: List[str] = []
        self._state_vars: List[Optional[str]] = []
        self._step_output_vars: List[str] = []
        self._outputs: List[Variable] = []
        # closure vars declared as op inputs so the grad differentiates
        # them (DynamicRNN.static_input)
        self._extra_param_inputs: List[str] = []
        self._sub = None
        self._parent_block = None
        self._complete = False

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        self._sub = program.create_block()
        yield
        program.rollback()
        self._append_op()
        self._complete = True

    def step_input(self, x: Variable) -> Variable:
        if len(x.shape) < 1:
            raise ValueError("step_input needs a [T, ...] sequence var")
        self._seq_inputs.append(x)
        v = self._sub.create_var(name=unique_name.generate("rnn_step_in"),
                                 shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._step_input_vars.append(v.name)
        return v

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None, init_value=0.0,
               dtype="float32") -> Variable:
        if init is None:
            if shape is None:
                raise ValueError("memory needs init var or shape")
            from . import tensor as tensor_layers
            init = tensor_layers.fill_constant(shape=shape, dtype=dtype, value=init_value)
        self._init_states.append(init)
        v = self._sub.create_var(name=unique_name.generate("rnn_mem"),
                                 shape=tuple(init.shape), dtype=init.dtype)
        self._ex_state_vars.append(v.name)
        self._state_vars.append(None)
        return v

    def update_memory(self, mem: Variable, new: Variable):
        self._state_vars[self._ex_state_vars.index(mem.name)] = new.name

    def step_output(self, o: Variable):
        self._step_output_vars.append(o.name)
        self._outputs.append(self._parent_block.create_var(
            name=unique_name.generate("rnn_out"),
            shape=(self._seq_inputs[0].shape[0],) + tuple(o.shape), dtype=o.dtype))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _collect_params(self) -> List[str]:
        """The parameters the cell's ops read, declared as op inputs so
        the grad maker asks for their gradients."""
        params: List[str] = list(self._extra_param_inputs)
        local = set(self._sub.vars.keys())
        for o in self._sub.ops:
            for n in o.desc.input_names():
                if not n or n in params or n in local:
                    continue
                if isinstance(self._parent_block._find_var(n), Parameter):
                    params.append(n)
        return params

    def _append_op(self):
        if any(s is None for s in self._state_vars):
            raise ValueError("every memory needs update_memory")
        op = self._parent_block.append_op(
            "recurrent",
            inputs={"Inputs": self._seq_inputs, "InitStates": self._init_states,
                    "Parameters": self._collect_params()},
            outputs={"Outputs": self._outputs, "LastStates": []},
            attrs={"step_input_vars": list(self._step_input_vars),
                   "ex_state_vars": list(self._ex_state_vars),
                   "state_vars": list(self._state_vars),
                   "step_output_vars": list(self._step_output_vars)})
        op.desc.set_block_attr("sub_block", self._sub.idx)

    def __call__(self):
        if not self._complete:
            raise RuntimeError("StaticRNN used before its step block closed")
        return self._outputs[0] if len(self._outputs) == 1 else self._outputs


@contextlib.contextmanager
def _in_block(program, idx):
    """Append to block ``idx`` for a while (DynamicRNN's input preparation
    goes to the parent block while its body is open)."""
    saved = program.current_block_idx
    program.current_block_idx = idx
    try:
        yield
    finally:
        program.current_block_idx = saved


# --------------------------------------------------------------------- IfElse

class IfElse:
    """Rows where ``cond`` holds take the true block's outputs, the others
    the false block's.  Both branches compute on the whole batch and the
    outputs merge with ``where``, as in the JAX package (Fluid gathers the
    rows of each branch): a branch that reduces across rows sees the whole
    batch.

    ::

        ie = layers.IfElse(cond)           # cond: [N, 1] bool
        with ie.true_block():
            ie.output(layers.fc(input=ie.input(x), size=H))
        with ie.false_block():
            ie.output(layers.scale(ie.input(x), scale=-1.0))
        merged, = ie()
    """

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self._cond = cond
        self._true_outs: List[Variable] = []
        self._false_outs: List[Variable] = []
        self._branch: Optional[bool] = None
        self._done_true = self._done_false = False

    @contextlib.contextmanager
    def true_block(self):
        self._branch = True
        yield
        self._branch = None
        self._done_true = True

    @contextlib.contextmanager
    def false_block(self):
        self._branch = False
        yield
        self._branch = None
        self._done_false = True

    def input(self, x: Variable) -> Variable:
        if self._branch is None:
            raise RuntimeError("IfElse.input() outside a branch block")
        return x

    def output(self, *outs: Variable):
        if self._branch is None:
            raise RuntimeError("IfElse.output() outside a branch block")
        (self._true_outs if self._branch else self._false_outs).extend(outs)

    def __call__(self):
        if not (self._done_true and self._done_false):
            raise RuntimeError("IfElse needs both true_block and false_block before calling it")
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError(f"IfElse branches produced {len(self._true_outs)} vs "
                             f"{len(self._false_outs)} outputs -- they must match")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = self.helper.create_variable_for_type_inference(t.dtype)
            self.helper.append_op("where", inputs={"Condition": self._cond, "X": t, "Y": f},
                                  outputs={"Out": out})
            merged.append(out)
        return merged


# ----------------------------------------------------------------- DynamicRNN

class DynamicRNN:
    """A recurrence over ragged [N, T, ...] sequences (lengths in
    ``@SEQ_LEN``).  Fluid sorts the rows by length and shrinks the batch
    each step; here, as in the JAX package, the batch keeps its shape and a
    step mask freezes each row's memory past its length and zeroes its
    outputs there.

    ::

        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(sentence)     # [N, D] a step
            prev = drnn.memory(shape=[H], value=0.0)
            hidden = layers.fc(input=layers.concat([word, prev], 1), size=H, act="tanh")
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()                             # [N, T, H] (+@SEQ_LEN)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._srnn = StaticRNN(name=name)
        self._program = self.helper.main_program
        self._parent_idx: Optional[int] = None
        self._first_seq: Optional[Variable] = None   # [N, T, ...] parent var
        self._lens: Optional[Variable] = None        # [N] int32
        self._mask_nt: Optional[Variable] = None     # [N, T] float
        self._mask_step: Optional[Variable] = None   # [N, 1] a step
        self._in_block = False
        self._finals: List[Variable] = []

    @contextlib.contextmanager
    def block(self):
        self._parent_idx = self._program.current_block_idx
        with self._srnn.step():
            self._in_block = True
            yield
            self._in_block = False
        self._finalize_outputs()

    def step_input(self, x: Variable) -> Variable:
        """``x``: ragged [N, T, ...]; returns its [N, ...] step.  Every step
        input shares the first one's lengths (Fluid requires one LoD)."""
        if not self._in_block:
            raise RuntimeError("step_input outside drnn.block()")
        if self._first_seq is not None and len(x.shape) > 1 and x.shape[1] > 0 and \
                self._first_seq.shape[1] > 0 and x.shape[1] != self._first_seq.shape[1]:
            raise ValueError(
                f"step_input {x.name!r} has padded length {x.shape[1]} but the first "
                f"step_input has {self._first_seq.shape[1]} -- all DynamicRNN step inputs "
                f"must share one ragged layout")
        from . import nn as nn_layers
        from . import sequence as seq_layers
        with _in_block(self._program, self._parent_idx):
            if self._first_seq is None:
                self._first_seq = x
                self._lens = seq_layers.sequence_length(x)
                mask = seq_layers.sequence_mask(
                    self._lens, maxlen=x.shape[1] if x.shape[1] > 0 else None,
                    maxlen_like=x, dtype="float32")
                self._mask_nt = mask                       # [N, T]
                mask_t = nn_layers.transpose(mask, perm=[1, 0])
                mask_t = nn_layers.unsqueeze(mask_t, axes=[2])  # [T, N, 1]
            perm = [1, 0] + list(range(2, len(x.shape)))
            xt = nn_layers.transpose(x, perm=perm)         # [T, N, ...]
        step = self._srnn.step_input(xt)
        if self._mask_step is None:
            self._mask_step = self._srnn.step_input(mask_t)
        return step

    def static_input(self, x: Variable) -> Variable:
        """A per-row constant [N, ...]: the var itself (the rows keep their
        order), declared as an input of the recurrence so its producers
        take a gradient."""
        if x.name not in self._srnn._extra_param_inputs:
            self._srnn._extra_param_inputs.append(x.name)
        return x

    def memory(self, init: Optional[Variable] = None, shape=None, value=0.0,
               need_reorder: bool = False, dtype="float32") -> Variable:
        if self._first_seq is None:
            raise RuntimeError("call step_input before memory")
        if init is None:
            if shape is None:
                raise ValueError("memory needs init= or shape=")
            from . import tensor as tensor_layers
            with _in_block(self._program, self._parent_idx):
                init = tensor_layers.fill_constant_batch_size_like(
                    input=self._first_seq, shape=[-1] + list(shape), dtype=dtype, value=value)
        return self._srnn.memory(init=init)

    def update_memory(self, ex_mem: Variable, new_mem: Variable):
        """Past a row's length its memory keeps its value (a select)."""
        masked = self.helper.create_variable_for_type_inference(new_mem.dtype)
        self.helper.append_op("where", inputs={"Condition": self._mask_step, "X": new_mem,
                                               "Y": ex_mem},
                              outputs={"Out": masked})
        self._srnn.update_memory(ex_mem, masked)

    def output(self, *outputs: Variable):
        for o in outputs:
            self._srnn.step_output(o)

    def _finalize_outputs(self):
        from . import nn as nn_layers
        for po in self._srnn._outputs:                 # [T, N, ...]
            perm = [1, 0] + list(range(2, len(po.shape)))
            out = nn_layers.transpose(po, perm=perm)   # [N, T, ...]
            mask = self._mask_nt
            for _ in range(len(out.shape) - 2):
                mask = nn_layers.unsqueeze(mask, axes=[len(mask.shape)])
            if mask.dtype != out.dtype:    # integer outputs stay integer
                mask = nn_layers.cast(mask, out.dtype.value)
            zeroed = out * mask            # the 0/1 mask zeroes the padding
            final = self.helper.create_variable_for_type_inference(out.dtype)
            self.helper.append_op("lod_reset", inputs={"X": zeroed, "Y": self._lens},
                                  outputs={"Out": final})
            self._finals.append(final)

    def __call__(self):
        if self._in_block or not self._finals:
            raise RuntimeError("DynamicRNN used before its block closed or with no output()")
        return self._finals[0] if len(self._finals) == 1 else self._finals
