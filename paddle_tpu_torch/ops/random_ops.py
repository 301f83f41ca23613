"""Random initializer ops.  Numbers come from the executor's explicit
``torch.Generator`` (or a fresh one for an op with a nonzero ``seed``
attr); they differ from the JAX package's threefry bits, so parity runs
carry parameters across (convert.py) instead of re-drawing them."""
from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from ..core.registry import register_infer_shape, register_lowering
from .common import set_out_shape


@register_lowering("uniform_random", no_gradient=True, draws=True)
def _uniform_random(ctx, op):
    shape = tuple(op.attr("shape", ()))
    dtype = convert_dtype(op.attr("dtype", "float32"))
    seed = op.attr("seed", 0)
    gen = ctx.generator
    if seed:
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(int(seed))
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.uniform_(op.attr("min", -1.0), op.attr("max", 1.0), generator=gen)
    ctx.write_slot(op, "Out", out.to(dtype.torch_dtype))


@register_infer_shape("uniform_random")
def _uniform_random_shape(block, op):
    set_out_shape(block, op, "Out", op.attr("shape", ()),
                  convert_dtype(op.attr("dtype", "float32")))
