"""Random initializer ops.  Numbers come from the executor's explicit
``torch.Generator`` (or a fresh one for an op with a nonzero ``seed``
attr); they differ from the JAX package's threefry bits, so parity runs
carry parameters across (convert.py) instead of re-drawing them, and the
draws are held by tests of their distribution."""
from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from ..core.registry import register_infer_shape, register_lowering
from .common import set_out_shape

# the JAX package's truncated draw keeps a standard normal inside (-2, 2)
TRUNCATION = 2.0


def _draw(ctx, op, fill):
    """A float32 tensor of the op's ``shape`` filled by ``fill(out, gen)``
    from the op's generator, written to Out in the op's ``dtype``."""
    seed = op.attr("seed", 0)
    gen = ctx.generator
    if seed:
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(int(seed))
    out = torch.empty(tuple(op.attr("shape", ())), dtype=torch.float32, device=ctx.device)
    fill(out, gen)
    ctx.write_slot(op, "Out", out.to(convert_dtype(op.attr("dtype", "float32")).torch_dtype))


@register_lowering("uniform_random", no_gradient=True, draws=True)
def _uniform_random(ctx, op):
    _draw(ctx, op, lambda out, gen: out.uniform_(op.attr("min", -1.0), op.attr("max", 1.0),
                                                 generator=gen))


@register_lowering("gaussian_random", no_gradient=True, draws=True)
def _gaussian_random(ctx, op):
    """``mean + std * N(0, 1)``."""
    def fill(out, gen):
        out.normal_(generator=gen).mul_(op.attr("std", 1.0)).add_(op.attr("mean", 0.0))
    _draw(ctx, op, fill)


@register_lowering("truncated_gaussian_random", no_gradient=True, draws=True)
def _truncated_gaussian_random(ctx, op):
    """``mean + std * t``, t a standard normal truncated to (-2, 2)."""
    def fill(out, gen):
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -TRUNCATION, TRUNCATION, generator=gen)
        out.mul_(op.attr("std", 1.0)).add_(op.attr("mean", 0.0))
    _draw(ctx, op, fill)


def _random_shape(block, op):
    set_out_shape(block, op, "Out", op.attr("shape", ()),
                  convert_dtype(op.attr("dtype", "float32")))


for _t in ("uniform_random", "gaussian_random", "truncated_gaussian_random"):
    register_infer_shape(_t)(_random_shape)
