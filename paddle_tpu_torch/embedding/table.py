"""sharded_table: the giant-embedding layer and its static memory plan
(the JAX package's ``embedding/table.py``).

The layer is one ``lookup_table`` op; what it adds is its stamps: the
``layout_role`` var attr names the table's layout role (dim 0 over the
mesh, once tables are placed on meshes: ROADMAP item 12c), and ``is_sparse=True``
gives it a SelectedRows gradient, so the optimizer updates only the
batch's unique rows.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from . import records

#: the layout role sharded_table stamps
TABLE_ROLE = "embedding"


def sharded_table(input, name: str, rows: int, dim: int, *, dtype: str = "float32",
                  padding_idx: Optional[int] = None, param_attr=None, is_sparse: bool = True):
    """Embedding lookup through the ``[rows, dim]`` parameter ``name``
    (created, or reused by name), stamped with the embedding layout role;
    appends a ``lookup_table`` op.  With the default ``is_sparse=True``
    the gradient is a SelectedRows (the batch's unique rows, merged at
    the source) and sgd / adagrad / adam update only those rows.  Returns
    the ``[batch..., dim]`` lookup output."""
    rows, dim = int(rows), int(dim)
    if rows <= 0 or dim <= 0:
        raise ValueError(f"sharded_table {name!r} needs positive rows/dim, got ({rows}, {dim})")
    attr = ParamAttr._to_attr(param_attr)
    if attr.name is None:
        attr.name = name
    helper = LayerHelper("sharded_table", param_attr=attr, name=name)
    w = helper.create_parameter(attr, shape=[rows, dim], dtype=dtype)
    w.desc.attrs["layout_role"] = TABLE_ROLE
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="lookup_table", inputs={"W": w, "Ids": input}, outputs={"Out": out},
                     attrs={"is_sparse": bool(is_sparse),
                            "padding_idx": -1 if padding_idx is None else int(padding_idx)})
    return out


def plan_table(name: str, rows: int, dim: int, *, dtype: str = "float32", mesh=None,
               layout=None, slots: int = 0, budget=None) -> Dict[str, Any]:
    """Static size of a table with ``slots`` same-shape optimizer
    accumulators (2 for adam's moments, 1 for adagrad, 0 for sgd), before
    any program is built.  With a ``budget`` (bytes, "16GiB" or a device
    profile name) the result carries ``fits`` and ``budget_bytes``:
    ``Executor(memory_budget=)`` enforces the same bound as an M501
    pre-flight.  ``mesh=`` and ``layout=`` (a table split over devices)
    wait for ROADMAP item 12c."""
    if mesh is not None or layout is not None:
        raise NotImplementedError(
            "plan_table(mesh=, layout=) is not ported to paddle_tpu_torch yet (ROADMAP §A "
            "item 12c): a table is planned for one device")
    from ..analysis import memory as _memory

    rows, dim, slots = int(rows), int(dim), int(slots)
    var_table = {name: {"shape": [rows, dim], "dtype": dtype, "role": TABLE_ROLE}}
    for i in range(slots):
        var_table[f"{name}_moment{i + 1}_0"] = {"shape": [rows, dim], "dtype": dtype,
                                               "slot_of": name}
    plan = _memory.plan_state_memory(var_table)
    out: Dict[str, Any] = {
        "table": name, "rows": rows, "dim": dim, "dtype": dtype, "slots": slots,
        "total_bytes": sum(t.total_bytes for t in plan.tensors.values()),
        "per_device_bytes": plan.peak_bytes, "num_devices": plan.num_devices,
    }
    if budget is not None:
        budget_b = _memory.parse_memory_budget(budget)
        out["budget_bytes"] = budget_b
        out["fits"] = plan.peak_bytes <= budget_b
    records().record(kind="plan", **{k: v for k, v in out.items() if k != "table"}, table=name)
    return out
