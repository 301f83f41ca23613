"""The IR: ProgramDesc / BlockDesc / OpDesc / VarDesc.

A copy of the JAX package's desc module, kept here because the port never
imports that package.  The descs are plain, JSON-serializable Python data
with the same schema, so ``ProgramDesc.serialize()`` of a program built by
either package parses in the other and ``fingerprint()`` agrees when both
build the same model.  Here a block is interpreted eagerly, op by op, by
the executor (core/executor.py) instead of being traced into one
computation.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .dtypes import DataType, convert_dtype

# Non-semantic metadata attrs, scrubbed from ``ProgramDesc.fingerprint()``
# so the same program built from two source locations hashes the same.
# ``callsite`` is the user-code ``file:line`` that appended the op;
# ``inserted_by`` is stamped by program-rewriting passes.
CALLSITE_ATTR = "callsite"
PASS_PROVENANCE_ATTR = "inserted_by"
NONSEMANTIC_OP_ATTRS = frozenset({CALLSITE_ATTR, PASS_PROVENANCE_ATTR})
NONSEMANTIC_VAR_ATTRS = frozenset({"seq_len_buckets", "mem_bytes_hint",
                                   "kv_cache_slots", "decode_position"})

# Gradient var naming: ``x@GRAD`` is the gradient of ``x``; a second
# producer of the same gradient writes ``x@GRAD@RENAME@<n>`` and a ``sum``
# op folds it back into ``x@GRAD`` (backward.py).
GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


def strip_grad_suffix(name: str) -> str:
    pos = name.find(GRAD_SUFFIX)
    return name[:pos] if pos >= 0 else name


class VarType:
    """Variable kinds.  DENSE_TENSOR is a padded dense tensor (raggedness
    rides in a ``@SEQ_LEN`` side channel), SELECTED_ROWS a (rows, values)
    pair for sparse embedding grads."""

    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    TENSOR_ARRAY = "tensor_array"
    READER = "reader"
    RAW = "raw"
    STEP_SCOPES = "step_scopes"


@dataclass
class VarDesc:
    name: str
    shape: Tuple[int, ...] = ()
    dtype: DataType = DataType.FP32
    persistable: bool = False
    stop_gradient: bool = False
    lod_level: int = 0
    type: str = VarType.DENSE_TENSOR
    is_parameter: bool = False
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype.value,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "type": self.type,
            "is_parameter": self.is_parameter,
            "attrs": dict(self.attrs),
        }

    @staticmethod
    def from_dict(d: dict) -> "VarDesc":
        return VarDesc(
            name=d["name"],
            shape=tuple(d["shape"]),
            dtype=convert_dtype(d["dtype"]),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            lod_level=d.get("lod_level", 0),
            type=d.get("type", VarType.DENSE_TENSOR),
            is_parameter=d.get("is_parameter", False),
            attrs=d.get("attrs", {}),
        )


@dataclass
class OpDesc:
    type: str
    # slot name -> list of var names
    inputs: Dict[str, List[str]] = field(default_factory=dict)
    outputs: Dict[str, List[str]] = field(default_factory=dict)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable_attrs(self.attrs),
        }

    @staticmethod
    def from_dict(d: dict) -> "OpDesc":
        return OpDesc(
            type=d["type"],
            inputs={k: list(v) for k, v in d.get("inputs", {}).items()},
            outputs={k: list(v) for k, v in d.get("outputs", {}).items()},
            attrs=_unjsonable_attrs(d.get("attrs", {})),
        )


def _jsonable_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, DataType):
            out[k] = {"__dtype__": v.value}
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def _unjsonable_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__dtype__" in v:
            out[k] = convert_dtype(v["__dtype__"])
        else:
            out[k] = v
    return out


class BlockDesc:
    """An ordered op list over named vars; var lookup falls through to
    ancestor blocks (``parent_idx``)."""

    def __init__(self, program: "ProgramDesc", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, VarDesc] = {}
        self.ops: List[OpDesc] = []
        self.forward_block_idx = -1

    def find_var(self, name: str) -> Optional[VarDesc]:
        b: Optional[BlockDesc] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        return None

    def has_var_local(self, name: str) -> bool:
        return name in self.vars

    def add_var(self, desc: VarDesc) -> VarDesc:
        self.vars[desc.name] = desc
        self.program._bump()
        return desc

    @property
    def parent(self) -> Optional["BlockDesc"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def append_op(self, op: OpDesc) -> OpDesc:
        self.ops.append(op)
        self.program._bump()
        return op

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "forward_block_idx": self.forward_block_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [o.to_dict() for o in self.ops],
        }


class ProgramDesc:
    """The whole-program IR: a list of blocks, block 0 global."""

    def __init__(self):
        self.blocks: List[BlockDesc] = [BlockDesc(self, 0, -1)]
        self._version = 0
        self._fp: Optional[str] = None
        self._fp_version = -1

    def _bump(self):
        self._version += 1

    def block(self, idx: int) -> BlockDesc:
        return self.blocks[idx]

    @property
    def global_block(self) -> BlockDesc:
        return self.blocks[0]

    def to_dict(self) -> dict:
        return {"blocks": [b.to_dict() for b in self.blocks]}

    def serialize(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def parse(data: str) -> "ProgramDesc":
        return ProgramDesc.from_dict(json.loads(data))

    @staticmethod
    def from_dict(d: dict) -> "ProgramDesc":
        p = ProgramDesc()
        p.blocks = []
        for bd in d["blocks"]:
            b = BlockDesc(p, bd["idx"], bd["parent_idx"])
            b.forward_block_idx = bd.get("forward_block_idx", -1)
            for vd in bd["vars"]:
                v = VarDesc.from_dict(vd)
                b.vars[v.name] = v
            for od in bd["ops"]:
                b.ops.append(OpDesc.from_dict(od))
            p.blocks.append(b)
        return p

    def fingerprint(self) -> str:
        """Stable content hash of the program with the non-semantic attrs
        scrubbed; memoized per mutation epoch.  Equal to the JAX package's
        fingerprint of the same program."""
        if self._fp is None or self._fp_version != self._version:
            d = self.to_dict()
            for bd in d["blocks"]:
                for od in bd["ops"]:
                    for a in NONSEMANTIC_OP_ATTRS:
                        od["attrs"].pop(a, None)
                for vd in bd["vars"]:
                    for a in NONSEMANTIC_VAR_ATTRS:
                        vd["attrs"].pop(a, None)
            payload = json.dumps(d, sort_keys=True)
            self._fp = hashlib.sha1(payload.encode()).hexdigest()
            self._fp_version = self._version
        return self._fp

    def __str__(self) -> str:
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for v in b.vars.values():
                flag = "P" if v.persistable else " "
                lines.append(
                    f"  var[{flag}] {v.name}: {v.type} {tuple(v.shape)} {v.dtype.value}"
                )
            for o in b.ops:
                ins = ", ".join(f"{k}={v}" for k, v in o.inputs.items())
                outs = ", ".join(f"{k}={v}" for k, v in o.outputs.items())
                lines.append(f"  op {o.type}({ins}) -> ({outs}) attrs={o.attrs}")
        return "\n".join(lines)
