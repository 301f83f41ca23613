"""Program pruning: backward-slice to fetch targets for inference
(Fluid's paddle/fluid/framework/prune.cc:1-210), copied from the JAX
package.  ``io.save_inference_model`` saves the slice to its targets; the
JAX package's verifier shares :func:`live_op_slice`, so the two agree on
which ops are live."""
from __future__ import annotations

from typing import Iterable, List, Set, Tuple


def live_op_slice(block, targets: Iterable[str]) -> Tuple[List[int], Set[str]]:
    """Backward slice of ``block`` to ``targets``.

    Returns ``(keep_indices, live_vars)``: the (ascending) indices of ops
    needed to compute any target, and every var name those ops read or
    write (targets included, whether or not produced).  An op is live iff
    it writes a var some later live op (or a target) reads — the same
    rule Fluid's prune.cc applies to its op graph."""
    needed: Set[str] = set(n for n in targets if n)
    live: Set[str] = set(needed)
    keep_idx: List[int] = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if set(op.output_names()) & needed:
            keep_idx.append(i)
            reads = [n for n in op.input_names() if n]
            needed.update(reads)
            live.update(reads)
            live.update(n for n in op.output_names() if n)
    keep_idx.reverse()
    return keep_idx, live


def prune_program(program, targets: List[str]):
    """Return a cloned program whose block 0 keeps only ops needed to compute
    ``targets`` (names)."""
    pruned = program.clone()
    block = pruned.desc.block(0)
    keep_idx, _ = live_op_slice(block, targets)
    block.ops = [block.ops[i] for i in keep_idx]
    pruned.desc._bump()
    pruned.sync_with_desc()
    return pruned
