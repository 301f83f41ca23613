"""The int8 fake-quant serving pass, ``amp-quant-int8``.

The port of the JAX package's ``QuantInt8Pass``
(``paddle_tpu/amp/passes.py``): policy-selected float32 matmuls of an
inference program get ``fake_quantize_abs_max`` on both operands, run on
the simulated-int8 values, and a ``fake_dequantize_max_abs`` with the
combined scale ``s_x * s_w`` (an inserted ``elementwise_mul``) and
``max_range = bin_cnt**2`` restores the float32 scale.  The pass name, the
inserted op types and the var names (``@QUANT``, ``@QSCALE``, ``@QRAW``)
are those of the JAX package: both packages write equal ProgramDescs.

With the kernel tier on, the ``pallas-kernels`` pass collapses each such
group into one ``pallas_int8_matmul`` op, the int8 GEMM kernel (K4).

The ``amp-bf16`` training pass is not ported yet (it comes with the bf16
training slice).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..core.desc import CALLSITE_ATTR, PASS_PROVENANCE_ATTR, OpDesc, VarDesc
from ..core.dtypes import DataType
from ..passes.base import PassContext, PassResult, ProgramPass, register_pass
from .policy import AmpPolicy

__all__ = ["QuantInt8Pass"]


@register_pass
class QuantInt8Pass(ProgramPass):
    """Simulated-int8 serving rewrite: wrap policy-selected float32
    matmuls in ``fake_quantize_abs_max`` (both operands) and one
    ``fake_dequantize_max_abs`` with the combined scale.  Inference
    programs only; the quantized values stay in float storage."""

    name = "amp-quant-int8"

    def __init__(self, policy: Optional[AmpPolicy] = None, bits: int = 8,
                 quant_ops: Tuple[str, ...] = ("mul", "matmul")):
        self.policy = policy or AmpPolicy()
        self.bits = int(bits)
        self.quant_ops = tuple(sorted(quant_ops))

    def config(self) -> dict:
        return {"policy": self.policy.fingerprint(), "bits": self.bits,
                "ops": list(self.quant_ops)}

    def apply(self, ctx: PassContext, result: PassResult) -> None:
        if ctx.desc.num_blocks() > 1:
            result.skipped = "multi-block program (control flow)"
            return
        block = ctx.desc.block(0)
        if any(op.attrs.get("op_role") in ("backward", "optimize")
               for op in block.ops):
            result.skipped = ("training program (int8 fake-quant is the "
                              "serving rewrite)")
            return

        bin_cnt = (1 << (self.bits - 1)) - 1
        quantized: Dict[str, Tuple[str, str]] = {}  # src -> (qvar, scale)

        def quantize(v: str, index: int, callsite) -> int:
            """Insert one fake_quantize_abs_max for ``v`` (reused across
            consumers: a weight shared by two matmuls quantizes once)."""
            if v in quantized:
                return 0
            src = block.find_var(v)
            qv, sv = f"{v}@QUANT", f"{v}@QSCALE"
            block.add_var(VarDesc(name=qv, shape=tuple(src.shape),
                                  dtype=src.dtype, stop_gradient=True))
            block.add_var(VarDesc(name=sv, shape=(1,), dtype=src.dtype,
                                  stop_gradient=True))
            result.vars_added += 2
            self.insert_op(block, index, OpDesc(
                type="fake_quantize_abs_max", inputs={"X": [v]},
                outputs={"Out": [qv], "OutScale": [sv]},
                attrs={"bit_length": self.bits, "op_role": "forward"}),
                result, callsite=callsite)
            quantized[v] = (qv, sv)
            return 1

        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type not in self.quant_ops \
                    or self.policy.class_for(op.type) != "bf16":
                i += 1
                continue
            xs, ys = op.inputs.get("X"), op.inputs.get("Y")
            if not xs or not ys:
                i += 1
                continue
            x, y = xs[0], ys[0]
            xd, yd = block.find_var(x), block.find_var(y)
            out = op.output("Out")[0]
            out_vd = block.find_var(out)
            if any(vd is None or vd.dtype != DataType.FP32
                   for vd in (xd, yd, out_vd)):
                i += 1  # non-float32 matmuls stay as they are
                continue
            cs = op.attrs.get(CALLSITE_ATTR)
            ins = quantize(x, i, cs)
            ins += quantize(y, i + ins, cs)
            xq, xs_v = quantized[x]
            yq, ys_v = quantized[y]
            # combined scale s_x*s_w, computed once per matmul
            comb = f"{out}@QSCALE"
            block.add_var(VarDesc(name=comb, shape=(1,),
                                  dtype=DataType.FP32, stop_gradient=True))
            self.insert_op(block, i + ins, OpDesc(
                type="elementwise_mul", inputs={"X": [xs_v], "Y": [ys_v]},
                outputs={"Out": [comb]},
                attrs={"axis": -1, "op_role": "forward"}),
                result, callsite=cs)
            ins += 1
            # the matmul now consumes the simulated-int8 operands and
            # writes a raw (scaled) accumulator the dequant restores
            raw = f"{out}@QRAW"
            block.add_var(VarDesc(name=raw, shape=tuple(out_vd.shape),
                                  dtype=DataType.FP32, stop_gradient=True))
            result.vars_added += 2
            op.inputs["X"][0] = xq
            op.inputs["Y"][0] = yq
            op.outputs["Out"] = [raw]
            # provenance on the rewritten matmul itself: the kernel pass
            # collapses only the groups this pass built
            op.attrs[PASS_PROVENANCE_ATTR] = self.name
            self.insert_op(block, i + ins + 1, OpDesc(
                type="fake_dequantize_max_abs",
                inputs={"X": [raw], "Scale": [comb]},
                outputs={"Out": [out]},
                attrs={"max_range": float(bin_cnt * bin_cnt),
                       "op_role": "forward"}),
                result, callsite=cs)
            result.changed = True
            i += ins + 2
        if result.changed:
            block.program._bump()
            if ctx.program is not None:
                prev = ctx.program._amp_policy_fp
                tag = f"int{self.bits}:{self.policy.fingerprint()}"
                ctx.program._amp_policy_fp = \
                    f"{prev}+{tag}" if prev else tag
            result.notes.append(f"int{self.bits} fake-quant, "
                                f"bin_cnt {bin_cnt}")
