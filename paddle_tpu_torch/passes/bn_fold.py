"""Inference batch_norm folding as a pipeline pass (``"bn-fold"``).

A test-mode ``batch_norm`` after a ``conv2d`` (directly, or through the
conv's channel-bias ``elementwise_add``) is an affine map a channel, so it
folds into the conv's parameters:

    y = scale * (x - mean) / std + bias,   std = sqrt(var + eps)
    W' = W * (scale / std)[oc]             b' = (b - mean) * scale / std + bias

The rewrite does not touch the input program or its scope values: the
folded values go to new scope vars (``<name>@BNFOLD``), which only the
rewritten program reads.  The fold is computed in float64 and stored in
float32, where the unfolded program normalizes in float32 at run time:
the same map, rounded otherwise (the JAX package's tolerance, rtol 2e-4).
Training-mode ``batch_norm`` updates its statistics every step and is left
alone (fold a ``clone(for_test=True)``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..core.desc import OpDesc, VarDesc
from .base import PassContext, PassResult, ProgramPass, register_pass

FOLD_SUFFIX = "@BNFOLD"


@register_pass
class BnFoldPass(ProgramPass):
    name = "bn-fold"
    requires_scope = True

    def apply(self, ctx: PassContext, result: PassResult) -> None:
        block = ctx.desc.block(0)
        scope = ctx.scope
        produced_by = {}
        consumers: dict = {}
        for op in block.ops:
            for n in op.output_names():
                if n:
                    produced_by[n] = op
            for n in op.input_names():
                consumers.setdefault(n, []).append(op)

        drop = []
        skipped_train = 0
        for bn in list(block.ops):
            if bn.type != "batch_norm":
                continue
            if not bn.attr("is_test", False):
                skipped_train += 1
                continue
            x = bn.input("X")[0]
            prev = produced_by.get(x)
            bias_add: Optional[OpDesc] = None
            conv: Optional[OpDesc] = None
            if prev is not None and prev.type == "elementwise_add" and \
                    prev.attr("axis", -1) == 1:
                maybe_conv = produced_by.get(prev.input("X")[0])
                if maybe_conv is not None and maybe_conv.type == "conv2d":
                    bias_add, conv = prev, maybe_conv
            elif prev is not None and prev.type == "conv2d":
                conv = prev
            if conv is None:
                continue
            # each intermediate must feed the chain only: the fold rescales
            # what a second consumer would still read
            mid_ok = all(len(consumers.get(out, [])) <= 1 for out in conv.output("Output"))
            if bias_add is not None:
                mid_ok = mid_ok and all(consumers.get(out, []) == [bn]
                                        for out in bias_add.output("Out"))
            if not mid_ok:
                result.notes.append(f"bn over {x!r} not folded: conv output has a side "
                                    f"consumer")
                continue

            w_name = conv.input("Filter")[0]
            missing = [n for n in [w_name] + [bn.input(s)[0] for s in
                                              ("Scale", "Bias", "Mean", "Variance")]
                       if scope.find_var(n) is None]
            if missing:
                result.notes.append(f"bn over {x!r} not folded: scope is missing {missing}")
                continue

            def f64(name):
                return scope.find_var(name).to(torch.float64)

            w = f64(w_name)
            scale, bias = f64(bn.input("Scale")[0]), f64(bn.input("Bias")[0])
            mean, var = f64(bn.input("Mean")[0]), f64(bn.input("Variance")[0])
            factor = scale / torch.sqrt(var + float(bn.attr("epsilon", 1e-5)))
            w_fold = self._folded_var(block, scope, w_name,
                                      w * factor[:, None, None, None], result)
            conv.rename_input(w_name, w_fold)
            if bias_add is not None:
                b_name = bias_add.input("Y")[0]
                b_fold = self._folded_var(block, scope, b_name,
                                          (f64(b_name) - mean) * factor + bias, result)
                bias_add.rename_input(b_name, b_fold)
                # the bias add now writes what the batch_norm wrote
                bias_add.outputs["Out"] = list(bn.output("Y"))
            else:
                b_fold = self._folded_var(block, scope, bn.input("Bias")[0],
                                          (0.0 - mean) * factor + bias, result)
                add = OpDesc(type="elementwise_add",
                             inputs={"X": list(conv.output("Output")), "Y": [b_fold]},
                             outputs={"Out": list(bn.output("Y"))},
                             attrs={"axis": 1})
                self.insert_op(block, block.ops.index(bn), add, result, callsite=bn.callsite)
            drop.append(bn)
            result.ops_replaced += 1

        if skipped_train:
            result.notes.append(f"{skipped_train} training-mode batch_norm op(s) left "
                                f"alone (clone(for_test=True) to fold)")
        if not drop:
            return
        self.remove_ops(block, [i for i, op in enumerate(block.ops) if op in drop], result)
        self.gc_dead_var_decls(block, set(ctx.fetch_names) | set(ctx.feed_names or ()),
                               result)

    def _folded_var(self, block, scope, src_name: str, value, result) -> str:
        """Declare ``<src>@BNFOLD`` (once) and set ``value`` in float32 in
        the scope under that name; returns the name."""
        name = src_name + FOLD_SUFFIX
        if not block.has_var_local(name):
            src = block.find_var(src_name)
            block.add_var(VarDesc(name=name, shape=tuple(value.shape), dtype=src.dtype,
                                  persistable=True, stop_gradient=True, is_parameter=True))
            result.vars_added += 1
        scope.update_var(name, value.to(torch.float32))
        return name
