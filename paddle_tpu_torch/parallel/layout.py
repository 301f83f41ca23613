"""Declarative sharding layouts over the canonical ``data × fsdp × tp`` mesh.

The counterpart of the reference's ParallelExecutor/SSA-graph engine
(SURVEY layer 5b: per-device scopes, NCCL broadcast, AllReduce op
handles): instead of building a per-device op graph, a :class:`SpecLayout`
maps parameter *roles* (embedding, QKV, FFN, bias/norm, generic-by-rank) to
specs over three canonical axes, and DTensor inserts the collectives the
reference inserted by hand — in the style of GSPMD (Xu et al., 2021) with
ZeRO-style optimizer-state sharding (Rajbhandari et al., 2020).

Canonical axis vocabulary (extends parallel/mesh.py's):

* ``data`` — pure data parallelism: batch sharded, params replicated.
* ``fsdp`` — fully-sharded data parallelism: batch sharded AND parameter
  dim 0 sharded (ZeRO-3 style; params all-gathered for compute, grads
  reduce-scattered).
* ``tp``   — tensor parallelism: parameter hidden/head dims sharded.

A layout is *rule-based*: parameters (and their optimizer-state slots,
matched through the ``slot_of`` var attr the optimizer records) are
assigned specs by name-pattern rules, falling back to a generic-by-rank
rule, with per-dim divisibility degradation — so existing programs adopt
a layout through ``Executor(layout=...)`` / ``Trainer(layout=...)``
without any model changes.  An explicit ``Variable.set_sharding``
annotation always wins over the layout.

The port keeps the JAX package's specs as they are (``spec_for`` gives the
same spec for every var) and runs them on DTensor: :func:`as_placements`
turns a spec into a ``DeviceMesh``'s placements (``Shard(dim)`` on the
mesh dims a spec entry names, ``Replicate()`` on the others), and
:func:`shard_program_state` places each persistable var with one
``distribute_tensor`` (rank 0's value broadcast: the reference's
BCastParamsToDevices).  :func:`on_local` runs a hand-written kernel on
each rank's shards.
"""
from __future__ import annotations

import hashlib
import json
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"

# Spec entry vocabulary: an axis name, a tuple of axis names (one dim split
# over several mesh axes), or None (replicated dim).  A whole spec of None
# means fully replicated.
SpecEntry = Any


def _entries(spec) -> List[Any]:
    """A spec's entries with list entries as tuples (JSON round-trips
    tuples as lists)."""
    return [tuple(e) if isinstance(e, (list, tuple)) else e for e in (spec or ())]


def as_placements(spec, mesh) -> Tuple:
    """The DTensor placements of ``spec`` over ``mesh`` (a
    ``parallel.mesh.Mesh``): one a mesh dim, ``Shard(d)`` where the spec's
    entry for tensor dim ``d`` names that mesh axis (alone or in a tuple),
    else ``Replicate()``.  ``None`` (fully replicated) gives every dim
    ``Replicate()``; an axis the mesh lacks is skipped, as a sharding over
    it is a no-op.  A tuple entry (one dim split over several axes) shards
    that dim over each of its axes in mesh order, which is the JAX
    package's order for axes listed in mesh order (``_fit_axes`` lists
    them so)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, e in enumerate(_entries(spec)):
        if e is None:
            continue
        for a in (e if isinstance(e, tuple) else (e,)):
            if a in mesh.shape:
                out[mesh.dim(a)] = Shard(d)
    return tuple(out)


class Sharding:
    """A spec over a mesh: the port's ``NamedSharding``.  ``placements``
    are its DTensor placements (:func:`as_placements`)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = None if spec is None else _entries(spec)
        self.placements = as_placements(self.spec, mesh)

    def __repr__(self):
        return f"Sharding({self.spec}, {self.mesh!r})"


def spec_tuple(spec) -> Tuple:
    """Canonical tuple form of a spec (a PartitionSpec, a var-attr list, or
    None) for equality checks: list entries become tuples (JSON round-trip)
    and trailing replicated dims are dropped — ``P()`` and ``P(None, None)``
    both mean fully replicated but compare unequal as PartitionSpecs."""
    if spec is None:
        entries: Tuple = ()
    else:
        entries = tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                        for e in tuple(spec))
    while entries and entries[-1] is None:
        entries = entries[:-1]
    return entries


def _axes_in(mesh, *axes: str) -> List[str]:
    """The subset of ``axes`` present in ``mesh`` (order preserved,
    deduped).  Size-1 axes are kept — sharding over them is a no-op but
    keeps specs stable across mesh reshapes."""
    seen: List[str] = []
    shape = dict(mesh.shape)
    for a in axes:
        if a in shape and a not in seen:
            seen.append(a)
    return seen


def _fit_axes(dim: int, axes: Sequence[str], mesh) -> Optional[SpecEntry]:
    """The largest prefix of ``axes`` whose mesh-size product divides
    ``dim`` — the per-dim divisibility degradation: a dim that cannot be
    split over (fsdp, tp) tries fsdp alone, then replicates.  Never
    silently truncates (contrast make_mesh's old ``n // known``)."""
    shape = dict(mesh.shape)
    cand = [a for a in axes if a in shape]
    while cand:
        prod = int(np.prod([shape[a] for a in cand]))
        if dim > 0 and prod > 0 and dim % prod == 0:
            return tuple(cand) if len(cand) > 1 else cand[0]
        cand.pop()
    return None


class SpecLayout:
    """Canonical PartitionSpecs for parameters and activations over
    ``data × fsdp × tp``.

    ``mesh_axes`` optionally carries the axis sizes this layout was
    designed for (``{"data": -1, "fsdp": 2, "tp": 2}``) so
    ``Trainer(layout=...)`` can build the mesh itself via
    :func:`~paddle_tpu_torch.parallel.mesh.make_mesh`.

    ``rules`` prepends custom ``(name_regex, role)`` pairs to the default
    role table; roles are the method names below (``embedding``, ``qkv``,
    ``attn_out``, ``ffn_up``, ``ffn_down``) plus ``replicate``.

    ``min_shard_elems``: parameters smaller than this replicate regardless
    of rules (tiny vars are cheaper broadcast than gathered).
    """

    #: default name-pattern -> role table, matched with ``re.search`` on
    #: the var name (most specific first; the generic-by-rank rule is the
    #: fallback, so these only exist to pick *better* specs for known
    #: roles, never to decide IF a var is sharded)
    DEFAULT_RULES: Tuple[Tuple[str, str], ...] = (
        (r"(emb|embedding|lookup|shared_w)", "embedding"),
        (r"(qkv|query|key|value|q_proj|k_proj|v_proj)", "qkv"),
        (r"(attn_out|out_proj|o_proj)", "attn_out"),
        (r"(ffn_up|up_proj|gate_proj)", "ffn_up"),
        (r"(ffn_down|down_proj)", "ffn_down"),
        (r"(norm|scale|bias|(^|[._/])b_)", "replicate"),
    )

    #: roles a ``layout_role`` var attr / ``spec_for(role=)`` may pin;
    #: anything else falls back to generic-by-rank
    _ROLE_METHODS = frozenset(
        {"embedding", "qkv", "attn_out", "ffn_up", "ffn_down",
         "replicate", "generic"})

    def __init__(self, data_axis: str = DATA_AXIS,
                 fsdp_axis: str = FSDP_AXIS, tp_axis: str = TP_AXIS,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 rules: Optional[Sequence[Tuple[str, str]]] = None,
                 min_shard_elems: int = 0):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.rules = tuple(rules or ()) + self.DEFAULT_RULES
        self.min_shard_elems = int(min_shard_elems)
        self._rule_memo: Dict[str, str] = {}

    # ------------------------------------------------------------ role specs
    # Role templates in SNIPPETS.md [3] style: per-dim axis preferences,
    # degraded per-dim by divisibility at resolution time.
    def embedding(self) -> List[SpecEntry]:
        """Vocab dim sharded over fsdp×tp, embed dim replicated."""
        return [(self.fsdp_axis, self.tp_axis), None]

    def qkv(self) -> List[SpecEntry]:
        """Attention projections: rows over fsdp, cols (heads) over tp."""
        return [self.fsdp_axis, self.tp_axis]

    def attn_out(self) -> List[SpecEntry]:
        """Output projection: input dim is the tp-sharded one."""
        return [self.tp_axis, self.fsdp_axis]

    def ffn_up(self) -> List[SpecEntry]:
        return [self.fsdp_axis, self.tp_axis]

    def ffn_down(self) -> List[SpecEntry]:
        return [self.tp_axis, self.fsdp_axis]

    def replicate(self) -> None:
        return None

    def generic(self, rank: int) -> Optional[List[SpecEntry]]:
        """Fallback by rank: matrices (and conv kernels etc.) shard dim 0
        over fsdp and the last dim over tp; vectors/scalars replicate."""
        if rank < 2:
            return None
        return ([self.fsdp_axis] + [None] * (rank - 2) + [self.tp_axis])

    # ------------------------------------------------------------ resolution
    def role_for(self, name: str) -> Optional[str]:
        """First rule whose pattern matches ``name`` (memoized)."""
        role = self._rule_memo.get(name)
        if role is None:
            role = "generic"
            for pat, r in self.rules:
                if re.search(pat, name):
                    role = r
                    break
            self._rule_memo[name] = role
        return role

    def spec_for(self, name: str, shape: Sequence[int], mesh,
                 slot_of: Optional[str] = None,
                 param_lookup=None,
                 role: Optional[str] = None) -> Optional[List[SpecEntry]]:
        """The PartitionSpec-style spec (list per dim, or None = fully
        replicated) for one parameter/state var under ``mesh``.

        ``slot_of`` names the parameter an optimizer slot belongs to (the
        ``slot_of`` var attr): the slot inherits its param's spec when the
        shapes match (ZeRO-style — moments live exactly where their param
        shard lives) and replicates otherwise (scalar beta-pows).
        ``param_lookup`` resolves that param's var desc (shape source).
        ``role`` pins the role directly, overriding the name-pattern
        rules — the ``layout_role`` var attr stamped by
        ``embedding.sharded_table`` travels here so a table shards by
        contract, not by how the user happened to name it."""
        shape = tuple(int(d) for d in (shape or ()))
        if slot_of:
            pvd = param_lookup(slot_of) if param_lookup is not None else None
            if pvd is not None and tuple(int(d) for d in pvd.shape) == shape:
                return self.spec_for(
                    slot_of, shape, mesh,
                    role=getattr(pvd, "attrs", {}).get("layout_role"))
            return None
        rank = len(shape)
        if rank == 0 or any(d <= 0 for d in shape):
            return None
        if self.min_shard_elems and int(np.prod(shape)) < self.min_shard_elems:
            return None
        role = role or self.role_for(name)
        if role not in self._ROLE_METHODS:
            role = "generic"
        if role == "generic":
            template = self.generic(rank)
        else:
            template = getattr(self, role)()
        if template is None:
            return None
        if len(template) != rank:
            # role template rank mismatch (e.g. a conv kernel matching an
            # "ffn" pattern): fall back to generic-by-rank
            template = self.generic(rank)
            if template is None:
                return None
        spec: List[SpecEntry] = []
        used: set = set()
        for dim, entry in zip(shape, template):
            if entry is None:
                spec.append(None)
                continue
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            axes = [a for a in axes if a not in used]
            fitted = _fit_axes(dim, axes, mesh)
            spec.append(fitted)
            if fitted is not None:
                used.update(fitted if isinstance(fitted, tuple)
                            else (fitted,))
        if all(e is None for e in spec):
            return None
        return spec

    # ----------------------------------------------------------- batch specs
    def batch_axes(self, mesh) -> Tuple[str, ...]:
        """The mesh axes the batch dim is split over: every present axis
        among (data, fsdp) — fsdp shards the batch too (it IS data
        parallelism, plus param sharding)."""
        return tuple(_axes_in(mesh, self.data_axis, self.fsdp_axis))

    def batch_spec(self, mesh, rank: int = 1) -> Optional[List[SpecEntry]]:
        """Feed/activation spec: dim 0 over the batch axes, rest
        replicated.  ``None`` when the mesh has neither batch axis (pure
        tp/pipeline meshes replicate feeds)."""
        axes = self.batch_axes(mesh)
        if not axes or rank < 1:
            return None
        return [axes[0] if len(axes) == 1 else tuple(axes)]

    # ----------------------------------------------------------- fingerprint
    def fingerprint(self) -> str:
        """Stable content hash of the layout — keyed into the executable
        fingerprint (persistent compile cache) and the compile flight
        recorder, so recompile attribution can name ``layout-change``
        distinctly from ``mesh-change``."""
        payload = json.dumps({
            "axes": [self.data_axis, self.fsdp_axis, self.tp_axis],
            "mesh_axes": self.mesh_axes,
            "rules": [list(r) for r in self.rules],
            "min_shard_elems": self.min_shard_elems,
        }, sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()

    def describe(self) -> Dict[str, Any]:
        return {"fingerprint": self.fingerprint()[:12],
                "axes": [self.data_axis, self.fsdp_axis, self.tp_axis],
                "mesh_axes": self.mesh_axes}

    def __repr__(self):
        return (f"SpecLayout({self.data_axis}×{self.fsdp_axis}×"
                f"{self.tp_axis}, fp={self.fingerprint()[:8]})")


def shard_program_state(program, scope, mesh, layout: Optional[SpecLayout],
                        block_idx: int = 0,
                        only: Optional[set] = None) -> Dict[str, Any]:
    """Place every initialized persistable var of ``program`` (parameters,
    optimizer-state slots, grad-accumulation buffers) onto its layout
    placement NOW — one ``distribute_tensor`` per var, before step 0,
    instead of a re-placement inside the first step.  The value is rank
    0's, scattered or broadcast over the mesh: the reference's
    BCastParamsToDevices (parallel_executor.cc:210-308), generalized from
    broadcast to arbitrary specs.

    Explicit ``Variable.set_sharding`` annotations win over the layout;
    with ``layout=None`` only they shard, and every other var is
    replicated.  Vars missing from the scope (startup not run yet) are
    skipped.  ``only`` restricts placement to the named vars.  Returns
    ``{var_name: spec}`` for every var placed (None = replicated)."""
    block = program.desc.block(block_idx)
    report: Dict[str, Any] = {}
    for name, vd in block.vars.items():
        if not vd.persistable or (only is not None and name not in only):
            continue
        v = scope.find_var(name)
        if v is None or not hasattr(v, "dtype") or not hasattr(v, "shape"):
            continue
        spec = state_spec(block, name, mesh, layout)
        scope.set_var(name, place_tensor(v, mesh, spec, name))
        report[name] = spec
    return report


def state_spec(block, name: str, mesh, layout: Optional[SpecLayout]):
    """The spec a persistable var lives on under ``mesh``: its explicit
    ``sharding`` attr, else the layout's rule, else None (replicated) —
    the JAX executor's ``_resolve_sharding`` for state."""
    vd = block.find_var(name)
    spec = vd.attrs.get("sharding") if vd is not None else None
    if spec is not None:
        return _entries(spec)
    if layout is not None and vd is not None and vd.persistable:
        return layout.spec_for(name, vd.shape, mesh,
                               slot_of=vd.attrs.get("slot_of"),
                               param_lookup=block.find_var,
                               role=vd.attrs.get("layout_role"))
    return None


def check_divisible(name: str, shape, spec, mesh) -> None:
    """Raise ``ValueError`` when a dim of ``shape`` does not divide by the
    mesh sizes its spec entry names, as ``jax.device_put`` refuses such a
    sharding (uneven shards are not a feature of either package; a rule's
    spec never asks for one, ``_fit_axes`` degrades it first)."""
    sizes = dict(mesh.shape)
    for d, e in enumerate(_entries(spec)):
        if e is None or d >= len(shape):
            continue
        n = int(np.prod([sizes.get(a, 1) for a in (e if isinstance(e, tuple) else (e,))]))
        if int(shape[d]) % n:
            raise ValueError(
                f"{name}: the sharding {list(_entries(spec))} over {dict(sizes)} implies that "
                f"the global size of its dimension {d} should be divisible by {n}, but it is "
                f"equal to {int(shape[d])} (full shape: {tuple(int(s) for s in shape)})")


def shard_range(placements, mesh, size: int, dim: int = 0) -> Tuple[int, int]:
    """``(offset, local_size)``: where this rank's shard of a value placed
    on ``placements`` over ``mesh`` lies along tensor dim ``dim`` (of
    global ``size``).  The mesh dims that place ``Shard(dim)`` split it in
    mesh order, each into equal parts (DTensor's order, and the JAX
    package's for a tuple entry); a dim they leave alone is ``(0, size)``."""
    from torch.distributed.tensor import Shard
    dm = getattr(mesh, "device_mesh", mesh)     # a Mesh, or a DTensor's DeviceMesh
    offset, size = 0, int(size)
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n = int(dm.size(i))
            if size % n:
                raise ValueError(f"a dim of {size} does not split into {n} equal shards")
            size //= n
            offset += int(dm.get_local_rank(i)) * size
    return offset, size


def row_shard(value, mesh) -> Optional[Tuple[int, int]]:
    """``(row_offset, local_rows)`` of the rows this rank holds of a table
    placed ``Shard(0)`` over ``mesh`` (a ``sharded_table`` under
    ``SpecLayout``'s embedding role, ``("fsdp", "tp")``, or an explicit
    ``Variable.set_sharding(["data", None])``); None for a value whose rows
    are not split (a plain tensor, or rows replicated on every mesh dim)."""
    from torch.distributed.tensor import Shard
    from ..core.lower import is_dtensor
    if mesh is None or not is_dtensor(value) or not any(
            isinstance(p, Shard) and p.dim == 0 for p in value.placements):
        return None
    return shard_range(value.placements, mesh, value.shape[0], 0)


def local_index(placements, mesh, shape) -> Tuple[slice, ...]:
    """This rank's shard of a value of global ``shape`` on ``placements``
    over ``mesh``, as one slice a dim (:func:`shard_range`)."""
    out = []
    for d, size in enumerate(shape):
        off, n = shard_range(placements, mesh, size, d)
        out.append(slice(off, off + n))
    return tuple(out)


def first_replica(placements, mesh) -> bool:
    """Whether this rank is the lowest rank that holds its shard of a value
    on ``placements``: its index is 0 on every mesh dim that does not
    split the value (a replicated value is written once, by rank 0)."""
    from torch.distributed.tensor import Shard
    dm = getattr(mesh, "device_mesh", mesh)
    return all(isinstance(p, Shard) or dm.size(i) == 1 or dm.get_local_rank(i) == 0
               for i, p in enumerate(placements))


def row_groups(value, mesh) -> List[Any]:
    """The process groups of the mesh dims that split ``value``'s rows
    (each of more than one rank): a partial sum over a table's row shards
    is all-reduced over each in turn (:func:`all_reduce_over`)."""
    from torch.distributed.tensor import Shard
    return [mesh.device_mesh.get_group(i) for i, p in enumerate(value.placements)
            if isinstance(p, Shard) and p.dim == 0 and int(mesh.devices.shape[i]) > 1]


def mesh_groups(mesh) -> List[Any]:
    """The process group of each mesh dim of more than one rank: a sum over
    every rank of the mesh is an all-reduce over each in turn."""
    dm = mesh.device_mesh
    return [dm.get_group(i) for i in range(dm.ndim) if dm.size(i) > 1]


def all_reduce_over(t, groups):
    """``t`` summed in place over each process group of ``groups`` in turn;
    returns ``t``."""
    import torch.distributed as dist
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def place_tensor(value, mesh, spec, name: str = "value"):
    """``value`` as a DTensor on ``spec``'s placements over ``mesh``: a
    DTensor already there is returned as it is, one elsewhere is
    redistributed, and a plain tensor takes the mesh's first rank's value
    (broadcast over the mesh, through host memory on a host-staged mesh)
    and keeps this rank's shard of it.  A dim the spec's axes do not
    divide raises (:func:`check_divisible`)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    check_divisible(name, value.shape, spec, mesh)
    placements = as_placements(spec, mesh)
    if isinstance(value, DTensor):
        if tuple(value.placements) == placements:
            return value
        return value.redistribute(mesh.device_mesh, placements)
    value = value.to(mesh.device, copy=True)
    if mesh.size > 1:
        if mesh.size != dist.get_world_size():
            return distribute_tensor(value, mesh.device_mesh, placements)
        src = int(mesh.devices.flat[0])
        if mesh.host_staged:
            host = value.cpu()
            dist.broadcast(host, src=src)
            value.copy_(host)
        else:
            dist.broadcast(value, src=src)
    return distribute_tensor(value, mesh.device_mesh, placements, src_data_rank=None)


# ---------------------------------------------------------- kernels on shards
def batch_like(t, mesh, dims=(0,)) -> Tuple:
    """The placements a kernel takes ``t`` on: its ``Shard(d)`` for ``d``
    in ``dims`` kept, every other mesh dim ``Replicate()`` (all of them for
    a plain tensor, which an op made whole on every rank)."""
    from torch.distributed.tensor import Replicate, Shard
    from ..core.lower import is_dtensor
    if not is_dtensor(t):
        return replicate(mesh)
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in t.placements)


def replicate(mesh) -> Tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * len(mesh.axis_names)


def partial_where_sharded(placements) -> Tuple:
    """The placements of a gradient that each shard of ``placements`` adds
    to: ``Partial()`` where they shard, ``Replicate()`` elsewhere (the
    gradient of a replicated weight read by a batch-sharded kernel)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(p, Shard) else Replicate() for p in placements)


def on_local(mesh, fn, args, in_placements, out_placements, in_grad_placements=None):
    """``fn(*args)`` on the local shards of the DTensors in ``args``
    (``torch.distributed.tensor.experimental.local_map``): each DTensor is
    redistributed to its entry of ``in_placements`` (None for an argument
    that is no tensor), ``fn`` runs on the local tensors, and its outputs
    come back as DTensors on ``out_placements`` (one placements tuple for
    a single output, else a sequence of them, None for an output that is
    None).  ``in_grad_placements``: the placements autograd gives each
    input's gradient (default its ``in_placements``).  With no mesh, or
    no DTensor among ``args``, ``fn(*args)`` runs as it is: no kernel is
    given a DTensor either way."""
    from ..core.lower import is_dtensor
    if mesh is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor.placement_types import Placement
    if isinstance(out_placements, tuple) and all(isinstance(p, Placement) for p in out_placements):
        out_placements = (out_placements,)      # one output
    else:
        out_placements = tuple(out_placements)
    # a plain tensor among them is an op's whole value, the same on every
    # rank: replicated, then taken on its stated placements like the rest
    from torch.distributed.tensor import DTensor
    rep = replicate(mesh)
    args = tuple(DTensor.from_local(a, mesh.device_mesh, rep, run_check=False)
                 if isinstance(a, torch.Tensor) and not is_dtensor(a) and p is not None else a
                 for a, p in zip(args, in_placements))
    if in_grad_placements is not None:
        # an input without a gradient of its own placements (local_map wants one)
        in_grad_placements = tuple(g if g is not None else p
                                   for g, p in zip(in_grad_placements, in_placements))
    return local_map(fn, out_placements=out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=in_grad_placements,
                     device_mesh=mesh.device_mesh, redistribute_inputs=True)(*args)
