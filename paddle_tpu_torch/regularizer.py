"""Weight-decay regularizers, appended as ops to each parameter's
gradient by ``optimizer.minimize`` (after the gradient clips), as the JAX
package's ``regularizer.py`` appends them: L2 adds ``coeff * param``, L1
adds ``coeff * sign(param)``.  A parameter's own ``regularizer`` (from its
``ParamAttr``) takes precedence over the optimizer's ``regularization``.
Gradients are dense: SelectedRows (sparse) gradients are not ported yet."""
from __future__ import annotations

from .core import unique_name


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
        out.append((param, reg.append_regularization_op(
            param, grad, param.block.program.global_block)))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
