"""``data``: declare an input variable of the default main program."""
from __future__ import annotations

from ..core.framework import default_main_program

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True):
    """Declare an input variable.  With ``append_batch_size`` the batch dim
    is prepended as -1, plus one dynamic padded axis per LoD level (the
    padded-ragged convention: a ragged var's per-row lengths are fed as
    ``<name>@SEQ_LEN``)."""
    if append_batch_size:
        shape = [-1] + [-1] * lod_level + list(shape)
    block = default_main_program().global_block
    if block.has_var(name):
        return block.var(name)
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient)
