"""Fusion to the fused loss head: mul(+bias) + softmax_with_cross_entropy
-> ``fused_fc_softmax_ce`` (ops/fused_ce.py), the JAX package's
``fuse-fc-softmax-ce`` pass.

The fused op computes the loss from an online log-sum-exp and never holds
the [rows, vocab] logits and softmax; on the card it runs K7
(``csrc/linear_ce.cu``).  The pass is pattern rewriting on the desc: find
the ``fc``-shaped projection feeding a hard-label
``softmax_with_cross_entropy`` whose intermediates feed nothing else, and
replace the 2-3 ops with one fused op that keeps the loss var's name.

Training programs are skipped whole: rewriting a program whose backward
was already appended would orphan the existing grad chain (build with
``layers.fused_fc_softmax_ce`` instead).  The fused path computes
``logsumexp - label_logit`` where the unfused op materializes the softmax:
the same math in another order of rounding, so the loss agrees within a
tolerance, not bit for bit.
"""
from __future__ import annotations

from typing import Dict, List

from ..core.desc import DataType, OpDesc, VarDesc
from .base import PassContext, PassResult, ProgramPass, register_pass

LSE_SUFFIX = "@LSE"


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@register_pass
class FuseFcSoftmaxCePass(ProgramPass):
    name = "fuse-fc-softmax-ce"

    def apply(self, ctx: PassContext, result: PassResult) -> None:
        block = ctx.desc.block(0)
        if any(op.attrs.get("op_role") in ("backward", "optimize")
               for b in ctx.desc.blocks for op in b.ops):
            result.skipped = ("training program (backward already "
                              "appended); fuse before append_backward or "
                              "use layers.fused_fc_softmax_ce")
            return

        produced_by: Dict[str, OpDesc] = {}
        for op in block.ops:
            for n in op.output_names():
                if n:
                    produced_by[n] = op
        consumers: Dict[str, List[OpDesc]] = {}
        for op in block.ops:
            for n in op.input_names():
                consumers.setdefault(n, []).append(op)
        protected = set(ctx.fetch_names) | set(ctx.feed_names or ())

        drop: List[OpDesc] = []
        for ce in list(block.ops):
            if ce.type != "softmax_with_cross_entropy" or ce in drop:
                continue
            if ce.attr("soft_label", False):
                continue        # the fused op is hard-label only
            softmax_outs = ce.output("Softmax")
            if any(n in protected or consumers.get(n)
                   for n in softmax_outs):
                continue        # somebody wants the probabilities
            logits = ce.input("Logits")[0]
            if logits in protected:
                continue
            prev = produced_by.get(logits)
            bias_add = None
            mul = None
            if prev is not None and prev.type == "elementwise_add":
                maybe_mul = produced_by.get(prev.input("X")[0])
                if maybe_mul is not None and maybe_mul.type == "mul":
                    bias_add, mul = prev, maybe_mul
            elif prev is not None and prev.type == "mul":
                mul = prev
            if mul is None:
                continue
            tmp = mul.output("Out")[0]
            # every intermediate feeds ONLY the chain and is not fetched
            if consumers.get(logits, []) != [ce] or logits in protected:
                continue
            if bias_add is not None and (
                    consumers.get(tmp, []) != [bias_add]
                    or tmp in protected):
                continue
            w_name = mul.input("Y")[0]
            w_vd = block.find_var(w_name)
            if w_vd is None or len(w_vd.shape) != 2:
                continue
            if bias_add is not None:
                b_vd = block.find_var(bias_add.input("Y")[0])
                if b_vd is None or len(b_vd.shape) != 1 \
                        or bias_add.attr("axis", -1) != \
                        mul.attr("x_num_col_dims", 1):
                    continue

            nfd = int(mul.attr("x_num_col_dims", 1))
            x_name = mul.input("X")[0]
            x_vd = block.find_var(x_name)
            loss_name = ce.output("Loss")[0]
            lead = tuple(int(d) for d in (x_vd.shape[:nfd] if x_vd is not
                                          None else ()))
            fused = OpDesc(
                type="fused_fc_softmax_ce",
                inputs={"X": [x_name], "W": [w_name],
                        "Label": list(ce.input("Label"))},
                outputs={"Loss": [loss_name],
                         "LogSumExp": [loss_name + LSE_SUFFIX]},
                attrs={"num_flatten_dims": nfd, "vocab_chunks": 0,
                       "use_pallas": -1})
            if bias_add is not None:
                fused.inputs["Bias"] = list(bias_add.input("Y"))
            # declared shapes as the fused op's infer-shape rule and its
            # lowering write them, concrete so the planner can size them
            flat = (-1 if any(d < 0 for d in lead) else _prod(lead))
            block.add_var(VarDesc(
                name=loss_name + LSE_SUFFIX, shape=(flat,),
                dtype=DataType.FP32))
            result.vars_added += 1
            loss_vd = block.find_var(loss_name)
            if loss_vd is not None:
                loss_vd.shape = lead + (1,)
                loss_vd.dtype = DataType.FP32
            self.insert_op(block, block.ops.index(ce), fused, result,
                           callsite=ce.callsite)
            drop.extend([o for o in (mul, bias_add, ce) if o is not None])
            result.ops_replaced += 1

        if not drop:
            return
        indices = [i for i, op in enumerate(block.ops) if op in drop]
        self.remove_ops(block, indices, result)
        self.gc_dead_var_decls(block, protected, result)
        result.notes.append(
            f"{result.ops_replaced} softmax+cross_entropy head(s) fused "
            f"to fused_fc_softmax_ce (logits never materialize)")
