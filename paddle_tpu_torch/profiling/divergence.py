"""Where two runs of one program part ways: the first op, in program
order, whose output is not bit-equal between them.

Used as evidence when a bit-equality gate fails on the card: a CUDA
graph's replay against the eager run of the same batch
(``tests/test_torch_gpu.py``), a step on a one-device mesh against the
plain step (``chip_smoke.py`` phase 31), as
``tools/decode_invariance.py`` does for a batch against its row.

    names = op_output_names(program)
    got = dict(zip(names, run_a(fetch_list=names)))
    want = dict(zip(names, run_b(fetch_list=names)))
    print(divergence_report(program, got, want))
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["op_output_names", "first_differing_op", "divergence_report"]


def op_output_names(program) -> List[str]:
    """The output names of block 0's ops, in program order, each once."""
    ops = program.desc.block(0).ops
    return list(dict.fromkeys(n for o in ops for n in o.output_names() if n))


def _as_array(v):
    if hasattr(v, "detach"):
        v = v.detach().to("cpu", copy=True)
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        v = v.float().numpy() if str(v.dtype) == "torch.bfloat16" else v.numpy()
    return np.asarray(v)


def _max_abs(a, b) -> float:
    if a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())


def first_differing_op(program, got: Dict[str, object],
                       want: Dict[str, object]) -> Optional[Tuple[int, str, str, float]]:
    """(op index, op type, output name, max abs difference) of the first op
    of block 0, in program order, with an output in both ``got`` and
    ``want`` that is not bit-equal (NaNs equal where both have them); None
    when every compared output agrees."""
    for i, o in enumerate(program.desc.block(0).ops):
        for n in o.output_names():
            if not n or n not in got or n not in want:
                continue
            a, b = _as_array(got[n]), _as_array(want[n])
            if a.shape != b.shape or not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
                return i, o.type, n, _max_abs(a, b)
    return None


def divergence_report(program, got: Dict[str, object], want: Dict[str, object]) -> str:
    """One line: the largest difference over every compared output, and
    the first op whose output differs (or that every one agrees)."""
    common = [n for n in got if n in want]
    worst = max((_max_abs(_as_array(got[n]), _as_array(want[n])) for n in common), default=0.0)
    first = first_differing_op(program, got, want)
    if first is None:
        return f"every one of {len(common)} op outputs bit-equal (max abs diff {worst:.3e})"
    i, typ, name, diff = first
    return (f"max abs diff {worst:.3e} over {len(common)} op outputs; the first op whose output "
            f"differs is op {i} ({typ}) -> {name!r}, max abs diff {diff:.3e}")
