"""Program construction: Program / Block / Operator / Variable.

Appending an Operator writes an OpDesc into the block and immediately
runs the op type's registered infer-shape, so downstream layers see
concrete shapes (the same construction-time behaviour as the JAX
package's framework module).
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Dict, List, Optional, Sequence

from . import unique_name
from .desc import CALLSITE_ATTR, BlockDesc, OpDesc, ProgramDesc, VarDesc, VarType
from .dtypes import DataType, convert_dtype
from .registry import OPS


class Variable:
    """Symbolic tensor in a block."""

    def __init__(self, block: "Block", desc: VarDesc):
        self.block = block
        self.desc = desc

    @property
    def name(self) -> str:
        return self.desc.name

    @property
    def shape(self):
        return tuple(self.desc.shape)

    @shape.setter
    def shape(self, s):
        self.desc.shape = tuple(s)

    @property
    def dtype(self) -> DataType:
        return self.desc.dtype

    @property
    def persistable(self) -> bool:
        return self.desc.persistable

    @persistable.setter
    def persistable(self, v: bool):
        self.desc.persistable = v

    @property
    def stop_gradient(self) -> bool:
        return self.desc.stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, v: bool):
        self.desc.stop_gradient = v

    @property
    def lod_level(self) -> int:
        return self.desc.lod_level

    @property
    def type(self) -> str:
        return self.desc.type

    def set_sharding(self, spec: Sequence[Optional[str]]):
        """Annotate with a spec over mesh axis names (one entry a dim: an
        axis, a tuple of axes, or None), read under a mesh
        (``parallel/layout.py``)."""
        self.desc.attrs["sharding"] = list(spec)
        return self

    @property
    def sharding(self):
        return self.desc.attrs.get("sharding")

    def __str__(self):
        return (f"Variable({self.name}: shape={self.shape}, "
                f"dtype={self.dtype.value}, persistable={self.persistable})")

    __repr__ = __str__


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block: "Block", desc: VarDesc, trainable: bool = True,
                 regularizer=None, optimize_attr: Optional[dict] = None):
        desc.persistable = True
        desc.is_parameter = True
        super().__init__(block, desc)
        self.trainable = trainable
        self.regularizer = regularizer
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}


class Operator:
    """Wrapper over an appended OpDesc."""

    def __init__(self, block: "Block", desc: OpDesc):
        self.block = block
        self.desc = desc

    @property
    def type(self) -> str:
        return self.desc.type

    def __str__(self):
        return f"Operator({self.desc.type})"


# Every append_op stamps the user frame that built the op -- the first
# frame outside this package and the standard library -- as its
# ``callsite`` attr, so errors can name "the mul at model.py:42".  The
# attr is non-semantic (scrubbed from ProgramDesc.fingerprint()).
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_STDLIB_DIR = os.path.dirname(os.__file__) + os.sep


def _user_callsite() -> Optional[str]:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not (fn.startswith(_PKG_DIR) or fn.startswith(_STDLIB_DIR)):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return None


def _to_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    if isinstance(v, Variable):
        return [v.name]
    return [str(v)]


class _OpRoleState(threading.local):
    role: Optional[str] = None


# The active op-role stamp: ops appended inside ``op_role_guard(role)`` get
# ``attrs["op_role"] = role`` unless the caller set one.  The learning-rate
# schedules stamp ``lr_sched``, so ``clone(for_test=True)`` drops their
# step-counter increment with the backward and optimize ops.
_ACTIVE_OP_ROLE = _OpRoleState()


@contextlib.contextmanager
def op_role_guard(role: str):
    prev = _ACTIVE_OP_ROLE.role
    _ACTIVE_OP_ROLE.role = role
    try:
        yield
    finally:
        _ACTIVE_OP_ROLE.role = prev


class Block:
    def __init__(self, program: "Program", idx: int):
        self.program = program
        self.idx = idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def desc(self) -> BlockDesc:
        return self.program.desc.block(self.idx)

    @property
    def parent_idx(self) -> int:
        return self.desc.parent_idx

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, name: Optional[str] = None, shape=(), dtype="float32",
                   persistable: bool = False, stop_gradient: bool = False,
                   lod_level: int = 0, type: str = VarType.DENSE_TENSOR) -> Variable:
        if name is None:
            name = unique_name.generate("_generated_var")
        desc = VarDesc(
            name=name, shape=tuple(shape), dtype=convert_dtype(dtype),
            persistable=persistable, stop_gradient=stop_gradient,
            lod_level=lod_level, type=type,
        )
        self.desc.add_var(desc)
        var = Variable(self, desc)
        self.vars[name] = var
        return var

    def create_parameter(self, name: Optional[str] = None, shape=(),
                         dtype="float32", trainable: bool = True,
                         regularizer=None, optimize_attr=None) -> Parameter:
        if name is None:
            name = unique_name.generate("_param")
        desc = VarDesc(name=name, shape=tuple(shape), dtype=convert_dtype(dtype))
        self.desc.add_var(desc)
        p = Parameter(self, desc, trainable=trainable, regularizer=regularizer,
                      optimize_attr=optimize_attr)
        self.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var(name)
        if v is None:
            raise KeyError(f"var {name!r} not in block {self.idx}")
        return v

    def _find_var(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        return None

    def has_var(self, name: str) -> bool:
        return self._find_var(name) is not None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def _sync_with_desc(self):
        """Wrap vars and ops that desc-level rewrites (backward) added."""
        for name, vd in self.desc.vars.items():
            if name not in self.vars:
                self.vars[name] = Variable(self, vd)
        if len(self.ops) != len(self.desc.ops):
            self.ops = [Operator(self, od) for od in self.desc.ops]

    def append_op(self, type: str, inputs: Optional[dict] = None,
                  outputs: Optional[dict] = None,
                  attrs: Optional[dict] = None) -> Operator:
        attrs = dict(attrs or {})
        if _ACTIVE_OP_ROLE.role is not None:
            attrs.setdefault("op_role", _ACTIVE_OP_ROLE.role)
        cs = _user_callsite()
        if cs is not None:
            attrs.setdefault(CALLSITE_ATTR, cs)
        desc = OpDesc(
            type=type,
            inputs={k: _to_name_list(v) for k, v in (inputs or {}).items()},
            outputs={k: _to_name_list(v) for k, v in (outputs or {}).items()},
            attrs=attrs,
        )
        self.desc.append_op(desc)
        op = Operator(self, desc)
        self.ops.append(op)
        if OPS.has(desc.type):
            info = OPS.get(desc.type)
            if info.infer_shape is not None:
                info.infer_shape(self.desc, desc)
        return op


class Program:
    def __init__(self):
        self.desc = ProgramDesc()
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        # seed of the executor's torch.Generator for this program's random
        # ops; None means 0
        self.random_seed: Optional[int] = None
        # bf16 mixed precision, set by amp.enable_amp(program): the
        # executor rewrites the program through the amp-bf16 pass
        self.amp = False
        # stamped by the rewriting passes on the programs they change: the
        # AmpPolicy fingerprint (amp-bf16, amp-quant-int8) and the KernelPolicy
        # fingerprint (pallas-kernels)
        self._amp_policy_fp: Optional[str] = None
        self._kernel_policy_fp: Optional[str] = None

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        """A new block under ``parent_idx`` (the current block by default),
        made current: the layers a control-flow construct's body calls
        append their ops there."""
        parent = self.block(parent_idx if parent_idx is not None else self.current_block_idx)
        self.desc.append_block(parent.desc)
        b = Block(self, len(self.blocks))
        self.blocks.append(b)
        self.current_block_idx = b.idx
        return b

    def rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.block(self.current_block_idx).parent_idx

    def num_blocks(self) -> int:
        return len(self.blocks)

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def sync_with_desc(self):
        """Wrap the vars and ops that desc-level rewrites added."""
        for b in self.blocks:
            b._sync_with_desc()

    def clone(self, for_test: bool = False) -> "Program":
        """A deep copy of the program (a fresh desc uid); parameters stay
        Parameter objects.  ``for_test`` (Fluid's framework.py:1567, as the
        JAX package ports it) drops the ops whose ``op_role`` is
        ``backward``, ``optimize`` or ``lr_sched`` (an evaluation run must
        not step the optimizer), sets ``is_test`` on every op that has the
        attr (and on dropout and batch_norm), and bumps the desc's
        version.  The result writes no state, so on the card it replays one
        CUDA graph per feed signature."""
        p = Program()
        p.desc = self.desc.clone()
        if for_test:
            for bd in p.desc.blocks:
                bd.ops = [od for od in bd.ops
                          if od.attrs.get("op_role") not in ("backward", "optimize", "lr_sched")]
        p.blocks = [Block(p, i) for i in range(p.desc.num_blocks())]
        for b in p.blocks:
            for name, vd in b.desc.vars.items():
                src = self.blocks[b.idx].vars.get(name)
                if isinstance(src, Parameter):
                    b.vars[name] = Parameter(b, vd, trainable=src.trainable,
                                             regularizer=src.regularizer,
                                             optimize_attr=src.optimize_attr)
                else:
                    b.vars[name] = Variable(b, vd)
            b.ops = [Operator(b, od) for od in b.desc.ops]
        p.random_seed = self.random_seed
        p.amp = self.amp
        p._amp_policy_fp = self._amp_policy_fp
        p._kernel_policy_fp = self._kernel_policy_fp
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.desc.attrs or op.type in ("dropout", "batch_norm"):
                        op.desc.attrs["is_test"] = True
            p.desc._bump()
        return p

    def _prune(self, targets: List[str]) -> "Program":
        """A clone whose block 0 keeps only the ops needed for ``targets``
        (Fluid's framework/prune.cc)."""
        from .prune import prune_program
        return prune_program(self, targets)

    def __str__(self):
        return str(self.desc)


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
