"""Block lowering: run a BlockDesc's ops, one by one, on torch tensors.

The JAX package traces a whole block into one XLA computation; here each
op's lowering runs eagerly as it is reached, as Fluid's executor
interpreted a block.  Op lowerings are registered in ``registry.OPS``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .desc import BlockDesc, OpDesc
from .registry import OPS

# Env key suffix carrying per-row sequence lengths of a padded ragged
# batch: var `x` with lod_level>0 is a padded [N, T, ...] tensor and
# `x@SEQ_LEN` its int32 [N] lengths (fed by the caller, propagated below).
SEQ_LEN_SUFFIX = "@SEQ_LEN"

# Op types that manage @SEQ_LEN themselves; the generic propagation below
# must not second-guess them.  Populated by op modules at registration.
SEQ_LEN_AWARE: set = set()


def _propagate_seq_len(ctx: "LowerCtx", op: OpDesc):
    """Carry lengths through shape-preserving ops (fc over flattened [N,T],
    elementwise, activations, embedding...): if an input has lengths and
    an output keeps the same leading [N, T] dims, the output is the same
    ragged batch."""
    in_lens = lead = None
    for n in op.input_names():
        if not n:
            continue
        lens = ctx.read_opt(n + SEQ_LEN_SUFFIX)
        if lens is not None:
            v = ctx.read_opt(n)
            if v is not None and getattr(v, "ndim", 0) >= 2:
                in_lens, lead = lens, tuple(v.shape[:2])
                break
    if in_lens is None:
        return
    for n in op.output_names():
        if not n or ctx.read_opt(n + SEQ_LEN_SUFFIX) is not None:
            continue
        v = ctx.read_opt(n)
        if (v is not None and getattr(v, "ndim", 0) >= 2
                and tuple(v.shape[:2]) == lead):
            ctx.write(n + SEQ_LEN_SUFFIX, in_lens)


class LowerCtx:
    """Environment of one block run: ``env`` maps var name -> tensor.
    ``generator`` is the ``torch.Generator`` random ops draw from;
    ``device`` is where ops create new tensors.  (The JAX package's parent
    contexts for control-flow sub-blocks come with control flow.)"""

    def __init__(self, block: BlockDesc, env: Dict[str, Any],
                 generator: torch.Generator, device: torch.device):
        self.block = block
        self.env = env
        self.generator = generator
        self.device = device

    def read(self, name: str):
        if name not in self.env:
            raise KeyError(
                f"var {name!r} is not defined at this point of block {self.block.idx}"
            )
        return self.env[name]

    def read_opt(self, name: str):
        return self.env.get(name)

    def write(self, name: str, value):
        if name:
            self.env[name] = value

    def read_slot(self, op: OpDesc, slot: str):
        names = op.input(slot)
        return self.read(names[0]) if names else None

    def write_slot(self, op: OpDesc, slot: str, value):
        names = op.output(slot)
        if names:
            self.write(names[0], value)


def lower_op(ctx: LowerCtx, op: OpDesc, index: Optional[int] = None):
    info = OPS.get(op.type) if OPS.has(op.type) else None
    if info is None or info.lower is None:
        where = f" (op {index})" if index is not None else ""
        raise NotImplementedError(
            f"no lowering registered for op {op.type!r}{where}")
    info.lower(ctx, op)
    if op.type not in SEQ_LEN_AWARE:
        _propagate_seq_len(ctx, op)


def lower_block(ctx: LowerCtx, block: BlockDesc):
    for idx, op in enumerate(block.ops):
        lower_op(ctx, op, index=idx)
