"""Weight-decay regularizers, appended as ops to each parameter's
gradient by ``optimizer.minimize`` (after the gradient clips), as the JAX
package's ``regularizer.py`` appends them: L2 adds ``coeff * param``, L1
adds ``coeff * sign(param)``.  A parameter's own ``regularizer`` (from its
``ParamAttr``) takes precedence over the optimizer's ``regularization``.
A SelectedRows (sparse embedding) gradient decays lazily, once a touched
row (``sparse_weight_decay``), and stays sparse."""
from __future__ import annotations

from .core import unique_name
from .core.desc import VarType


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


def _decayed(param, grad, decay, block):
    out = block.create_var(name=unique_name.generate(param.name + "_reg_grad"),
                           shape=param.shape, dtype=param.dtype)
    block.append_op("sum", inputs={"X": [grad, decay]}, outputs={"Out": out},
                    attrs={"op_role": "backward"})
    return out


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(name=unique_name.generate(param.name + "_l2_decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": param}, outputs={"Out": decay},
                        attrs={"scale": self._coeff, "op_role": "backward"})
        return _decayed(param, grad, decay, block)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sign = block.create_var(name=unique_name.generate(param.name + "_sign"),
                                shape=param.shape, dtype=param.dtype)
        block.append_op("sign", inputs={"X": param}, outputs={"Out": sign},
                        attrs={"op_role": "backward"})
        decay = block.create_var(name=unique_name.generate(param.name + "_l1_decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op("scale", inputs={"X": sign}, outputs={"Out": decay},
                        attrs={"scale": self._coeff, "op_role": "backward"})
        return _decayed(param, grad, decay, block)


def append_regularization_ops(params_grads, regularization=None):
    """[(param, grad)] -> [(param, regularized grad)]."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer or regularization
        if grad is None or reg is None:
            out.append((param, grad))
            continue
        block = param.block.program.global_block
        if getattr(grad, "type", None) == VarType.SELECTED_ROWS:
            out.append((param, _sparse_decay(param, grad, reg, block)))
            continue
        out.append((param, reg.append_regularization_op(param, grad, block)))
    return out


def _sparse_decay(param, grad, reg, block):
    """``grad`` ++ the decay of its touched rows, a SelectedRows."""
    if isinstance(reg, L1DecayRegularizer):
        mode = "l1"
    elif isinstance(reg, L2DecayRegularizer):
        mode = "l2"
    else:
        raise NotImplementedError(
            f"custom regularizer {type(reg).__name__} has no sparse (SelectedRows) decay "
            f"rule -- use L1Decay/L2Decay for is_sparse embeddings or set is_sparse=False")
    out = block.create_var(name=unique_name.generate(grad.name + "_reg"), shape=grad.shape,
                           dtype=grad.dtype, type=VarType.SELECTED_ROWS)
    block.append_op("sparse_weight_decay", inputs={"Param": param, "Grad": grad},
                    outputs={"Out": out},
                    attrs={"coeff": reg._coeff, "mode": mode, "op_role": "backward"})
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
