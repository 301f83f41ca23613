"""Gradient clipping, appended as ops by ``optimizer.minimize`` before the
regularizers, as the JAX package's ``clip.py`` appends them:
``GradientClipByValue`` (``clip``), ``GradientClipByNorm``
(``clip_by_norm``, per gradient) and ``GradientClipByGlobalNorm`` (every
gradient scaled by clip_norm / max(global norm, clip_norm), the global
norm read from all gradients before any update).  ``set_gradient_clip``
attaches a clip to parameters.  A SelectedRows (sparse embedding)
gradient adds its merged rows' squared norm to the global norm and is
rescaled row by row (``sparse_scale_rows``); the per-gradient value and
norm clips leave it as it is, as in the JAX package."""
from __future__ import annotations

from .core import unique_name
from .core.desc import VarType


class BaseGradientClipAttr:
    def _append_clip_op(self, block, grad):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def _append_clip_op(self, block, grad):
        out = block.create_var(name=unique_name.generate(grad.name + "_clip"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("clip", inputs={"X": grad}, outputs={"Out": out},
                        attrs={"min": self.min, "max": self.max, "op_role": "backward"})
        return out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _append_clip_op(self, block, grad):
        out = block.create_var(name=unique_name.generate(grad.name + "_clip"),
                               shape=grad.shape, dtype=grad.dtype)
        block.append_op("clip_by_norm", inputs={"X": grad}, outputs={"Out": out},
                        attrs={"max_norm": self.clip_norm, "op_role": "backward"})
        return out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Scales all gradients by clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm


def set_gradient_clip(clip, param_list=None, program=None):
    from .core.framework import default_main_program
    program = program or default_main_program()
    for p in param_list or program.global_block.all_parameters():
        if not isinstance(p, str):
            p.gradient_clip = clip


def _var(block, stem, shape=(), dtype="float32"):
    return block.create_var(name=unique_name.generate(stem), shape=shape, dtype=dtype)


def append_gradient_clip_ops(params_grads):
    """[(param, grad)] -> [(param, clipped grad)].  A global-norm clip on
    any parameter clips every gradient by the one global norm."""
    from .core.framework import default_main_program
    block = default_main_program().global_block
    sparse = [(p, g) for p, g in params_grads if getattr(g, "type", None) == VarType.SELECTED_ROWS]
    params_grads = [(p, g) for p, g in params_grads
                    if getattr(g, "type", None) != VarType.SELECTED_ROWS]
    gn = next((c for c in (getattr(p, "gradient_clip", None) for p, _ in params_grads + sparse)
               if isinstance(c, GradientClipByGlobalNorm)), None)
    if gn is not None:
        sq_sums = []
        for _, g in params_grads + sparse:
            if g is None:
                continue
            sq = _var(block, "gclip_sq")
            block.append_op("squared_l2_norm", inputs={"X": g}, outputs={"Out": sq},
                            attrs={"op_role": "backward"})
            sq_sums.append(sq)
        total = _var(block, "gclip_total")
        block.append_op("sum", inputs={"X": sq_sums}, outputs={"Out": total},
                        attrs={"op_role": "backward"})
        norm = _var(block, "gclip_norm")
        block.append_op("sqrt", inputs={"X": total}, outputs={"Out": norm},
                        attrs={"op_role": "backward"})
        denom = _var(block, "gclip_denom")
        block.append_op("maximum", inputs={"X": norm, "Y": _const(block, gn.clip_norm)},
                        outputs={"Out": denom}, attrs={"op_role": "backward"})
        ratio = _var(block, "gclip_ratio")
        block.append_op("elementwise_div", inputs={"X": _const(block, gn.clip_norm), "Y": denom},
                        outputs={"Out": ratio}, attrs={"axis": -1, "op_role": "backward"})
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            scaled = _var(block, g.name + "_gclip", g.shape, g.dtype)
            block.append_op("elementwise_mul", inputs={"X": g, "Y": ratio},
                            outputs={"Out": scaled}, attrs={"axis": -1, "op_role": "backward"})
            out.append((p, scaled))
        for p, g in sparse:
            scaled = block.create_var(name=unique_name.generate(g.name + "_gclip"),
                                      shape=g.shape, dtype=g.dtype, type=VarType.SELECTED_ROWS)
            block.append_op("sparse_scale_rows", inputs={"X": g, "Y": ratio},
                            outputs={"Out": scaled}, attrs={"op_role": "backward"})
            out.append((p, scaled))
        return out
    out = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip", None)
        if g is None or not isinstance(clip, BaseGradientClipAttr):
            out.append((p, g))
            continue
        out.append((p, clip._append_clip_op(block, g)))
    return out + sparse


def _const(block, value):
    v = _var(block, "gclip_const")
    block.append_op("fill_constant", outputs={"Out": v},
                    attrs={"shape": [], "dtype": v.dtype, "value": float(value),
                           "op_role": "backward"})
    return v
