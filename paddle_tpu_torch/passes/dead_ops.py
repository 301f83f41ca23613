"""Dead-op elimination: act on the D204/D205 liveness findings (the JAX
package's ``dead-op-elim`` pass).

Uses the same ``core/prune.live_op_slice`` backward slice as the D2xx
checker and inference pruning, so an op this pass removes is exactly an
op the verifier calls dead and ``io.save_inference_model`` would prune.
Roots are the fetch targets plus every persisted-state write (the
verifier's rule), plus the inputs of effect ops (save/print/control
flow/...), which are kept, along with their sub-blocks' outer reads.

On the memory planner's ledger this is the M502 fix: a dead op whose
output dominates the live-set peak stops existing.
"""
from __future__ import annotations

from typing import List, Set

from ..core import prune as _prune
from ..core.desc import block_outer_reads
from .base import PassContext, PassResult, ProgramPass, register_pass


@register_pass
class DeadOpEliminationPass(ProgramPass):
    name = "dead-op-elim"

    def apply(self, ctx: PassContext, result: PassResult) -> None:
        from ..analysis.verifier import _EFFECT_OPS
        block = ctx.desc.block(0)
        roots: Set[str] = set(ctx.fetch_names)
        for op in block.ops:
            for n in op.output_names():
                if not n:
                    continue
                vd = block.find_var(n)
                if vd is not None and vd.persistable:
                    roots.add(n)
        # effect ops are force-kept below, so their reads (including each
        # sub-block's outer-scope closure) are roots too — the slice must
        # not drop their producers
        for op in block.ops:
            if op.type not in _EFFECT_OPS:
                continue
            roots.update(n for n in op.input_names() if n)
            for aname in op.attrs:
                bidx = op.block_attr(aname)
                if bidx is not None:
                    sub = ctx.desc.blocks[bidx]
                    roots.update(n for n in block_outer_reads(sub)
                                 if n not in sub.vars)
        if not roots:
            result.skipped = "no fetch targets or persisted state to root " \
                             "the slice"
            return
        keep_idx, _ = _prune.live_op_slice(block, roots)
        kept = set(keep_idx)
        drop: List[int] = [i for i, op in enumerate(block.ops)
                           if i not in kept and op.type not in _EFFECT_OPS]
        if not drop:
            return
        self.remove_ops(block, drop, result)
        keep_names = set(roots) | set(ctx.feed_names or ())
        self.gc_dead_var_decls(block, keep_names, result)
        result.notes.append(f"{len(drop)} dead op(s) removed "
                            f"(D204 slice, roots={len(roots)})")
