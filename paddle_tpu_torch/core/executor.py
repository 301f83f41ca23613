"""The executor: run a program's global block on one device, through a
cache of executables.

``Executor.run`` coerces the feeds, finds the cache entry of (program uid,
version, feed signature, fetch names, state signature, amp, passes, kernel
policy, matmul and cuDNN flags) -- the JAX package's executable cache -- and runs
it.  An entry holds the block's analysis (which names it reads from the
scope and which state it writes), done once.

State is updated in place, the port's counterpart of the reference's
donated state: after the block's ops, each written state value that is
not the scope's own tensor is copied into that tensor (one
``torch._foreach_copy_``), and the optimizer kernels update parameters and
moments in place to begin with.  So a scope tensor keeps its address from
step to step; only state the block initializes (the startup program) is
bound anew.

On a CUDA place an entry of a program whose written state all exists
already (``state_out`` within ``state_in``: an inference program, a
training step) holds one CUDA graph of the whole lowering of block 0 (its
control-flow ops' sub-blocks included) and its write-back: a hit copies
the feeds into the graph's static buffers and replays it, and no op is
lowered from Python.  A program that
draws random numbers registers the executor's generator with its graph,
so each replay draws anew and advances it as an eager run would.  Any
other entry (the startup program, which initializes state; a generic
grad of a random op, which forks the generator; a ``while`` without
``max_iters``, which reads its condition on the host each trip; every
entry on the CPU) lowers the block op by op: the environment is built from
the scope's state, the feeds and their ``@SEQ_LEN`` lengths, and every
op's lowering runs in order.  Which kind an entry is is decided from the
program before any capture; a capture that fails raises.
``Executor.cache_info()`` lists each entry's kind and the reasons an entry
has no graph.

Static analysis, as in the JAX package (``paddle_tpu_torch.analysis``).
``validate`` (``"error"``, ``"warn"`` or ``"off"``; default
``$PADDLE_TPU_VALIDATE``, else ``"off"``) runs the verifier on the program
that runs, once per (program uid, version, fetch names): the buckets of a
serving warmup share one pass.  ``"error"`` raises
:class:`~paddle_tpu_torch.analysis.ProgramVerificationError` on an
error-severity finding, and both modes warn on the other findings.
``memory_budget`` (bytes, a size string such as ``"16GiB"``, or a device
profile such as ``"h100-80gb-hbm3"``) plans the program's per-device peak
(``analysis.plan_memory``) before the first eager run or capture of each
feed signature, and raises
:class:`~paddle_tpu_torch.analysis.PredictedOOMError` when the plan
exceeds it: nothing has been allocated for the program then.  The plan
goes to the ``predicted_peak_bytes`` gauge and ``memplan_<pid>.jsonl``.

Donation: ``run(donate_feeds=True)`` on a batch staged with
``stage_feeds(reuse=False)`` (``donatable``), or a program the
``donation-insert`` pass stamped, hands the batch to the step: the staged
batch is emptied and the executor keeps each feed tensor only until its
last reader in an eager run (a CUDA graph copies the feeds into its own
static buffers, so there only the staged copy goes).  The flag is part of
the cache key.

A graph reads the addresses it captured, so the state signature of a
graph-eligible program includes each state tensor's ``data_ptr()``: a
scope variable rebound to a new tensor misses (the new graph replaces the
old one), and an in-place update (``copy_``, or a training step) hits and
is read.  Fetches on the card are copied into pinned host memory on the
step's stream right after the step (``staging.prefetch_to_host``);
``return_numpy=False`` returns device clones of a graph's outputs, never
its own buffers, and of fetched state, which the next step overwrites.

Feeds may come staged (``stage_feeds`` / ``run_pipelined``: a
``FeedStager`` thread coerces batch N+1 into pinned buffers and copies it
to the card on a stream of its own while step N runs).  ``run`` makes its
stream wait on the batch's event before anything reads it (a replay's copy
into its static buffers, or an eager lowering) and marks the staged
tensors as used by that stream; they are not coerced or moved again.

Places: ``CUDAPlace(i)`` is a real CUDA device and the default; the CPU is
used only when the caller passes ``CPUPlace()``.  An executor asked for a
GPU that is not there raises instead of running on the CPU.

The health sentinel (``Executor(sentinels=...)``, ``health.py``): each
entry watches the fetches and the gradient and state groups its program
has, and after the block's ops computes five tensors (a finite-bit mask,
loss, grad norm, param norm, update norm; the update reads copies of the
watched state taken at the block's head, since the updates write in
place).  They are outputs of the block, so on the card the step's CUDA
graph writes them on every replay; ``run`` peels them off the caller's
fetches, enqueues their copies to pinned host memory behind the step and
hands the handles to the attached ``HealthMonitor`` without waiting.  The
sentinel classes are part of the cache key and the fingerprint (as a
``@HEALTH[...]@`` pseudo-fetch): toggling them builds a new entry.  With
no sentinel the block has no extra outputs and the key is unchanged.

``flags.FLAGS.check_nan_inf`` makes ``run`` scan the fetches and the
written state after the step and, on a non-finite value, replay the block
op by op from clones of the state taken before it, raising a
``RuntimeError`` that names the first op with a non-finite output;
``FLAGS.benchmark`` synchronizes after each run and logs its wall time
and the live device bytes (``torch.cuda.memory_allocated``).

``passes=``, ``amp=`` and ``kernels=`` compose the program-rewrite
pipeline (``amp.compose_passes``) as in the JAX package.  ``kernels=None``
is resolved per device, as the JAX package resolves it per backend: the
kernel tier is on for a CUDA place, where the kernels run, and off on the
CPU.  The pipeline runs once per (program uid, version, feed names, fetch
names); the executor runs the rewritten program.  A program flagged by
``amp.enable_amp`` then goes through the ``amp-bf16`` pass (the legacy
bridge, memoized per program uid, version and fetch names), as in the JAX
package; one the pass cannot rewrite raises.

Parameter servers (``DistributeTranspiler``): a CUDA graph cannot call
the host, so a trainer program's server ops run on the host around the
rest of the step (``plan_host_stages``): the ``recv`` head copies each
parameter into the scope's tensor in place, on the current stream, and a
``distributed_lookup_table`` over fed ids binds its rows as a feed; then
the body runs (one graph replay on the card); then the values the tail
reads come to pinned host memory in one copy each, and the ``send`` tail
pushes them, one ``send_grads`` round trip a pserver.  A server op that
fits neither end stays in the body, and ``graph_blockers`` names it.
``run_pserver`` serves a pserver program on this executor's place.

A mesh (``Executor(mesh=, batch_axis=, layout=)``, ``parallel/``; the
JAX package's GSPMD executor on DTensor): each state var is placed once,
before the first step that reads it, on its spec's placements (its
``sharding`` attr, else the layout's rule, else replicated; rank 0's
value broadcast, ``parallel.layout.place_tensor``); each feed is this
rank's rows of the global batch, wrapped as a DTensor sharded over the
batch axes (the layout's, else ``batch_axis`` and ``fsdp``); the block
runs on DTensors, with each hand-written kernel on local shards and each
gradient redistributed to its parameter's placements before the update
group (``core/lower.py``); written state goes back shard to shard, and
each fetch is gathered whole, inside the step.  The mesh and the layout's
fingerprint key the cache.  An NCCL mesh's collectives are device work: the
step is one CUDA graph with them inside (the capture's eager run builds
the communicators first).  A gloo mesh's collectives run on the host, so
``graph_blockers`` keeps its entries op by op.  Under a mesh the health
sentinel waits for ROADMAP §A item 12c and raises.

Telemetry, as in the JAX package: each executor counts its cache in a
telemetry scope of its own (``executor:<n>``: ``compile_count``,
``fresh_compiles``, ``persistent_hits`` (always 0: a CUDA graph is not
saved across processes), ``cache_hits``, ``cache_misses``, ``runs`` and
``captures``), and every new cache entry writes one record to the capture
log (``compile_log.COMPILE_LOG``, ``compiles_<pid>.jsonl``): why it was
built, what it cost (``kind``: ``capture`` or ``eager``) and how long.
While the timeline is enabled a run records ``executor::feed``,
``executor::run(block0/<n> ops)`` and ``executor::fetch`` spans, the
head of a staged batch's flow, and the step's span on the device lane;
with it off a run adds a few counter increments.  ``profile_ops`` is the
sampled per-op profiler (``paddle_tpu_torch.profiling``) over the program
``run`` would execute.
"""
from __future__ import annotations

import copy
import itertools
import json
import os
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compile_log import COMPILE_LOG, diff_signatures
from ..flags import FLAGS
from ..health import _nonfinite, sentinel_classes, sentinel_extras, shadow_state
from ..log import VLOG
from ..telemetry import REGISTRY, TIMELINE
from .desc import GRAD_SUFFIX, BlockDesc, OpDesc, VarType, block_written_names
from .dtypes import coerce_feed_dtype, convert_dtype
from .framework import Program, Variable, default_main_program
from .lower import (_SKIP_OPS, LowerCtx, TensorArrayVal, is_dtensor, lower_block, lower_op,
                    plan_frees)
from .registry import op_draws, op_forks, sub_blocks
from .scope import Scope, global_scope
from .staging import (COUNTERS, FeedStager, FetchHandle, executable_fingerprint,
                      prefetch_to_host)

# scope var holding the executor's torch.Generator for random ops
RNG_STATE_VAR = "@RNG_STATE@"

# a program that has built this many distinct cache entries (feed shapes,
# usually) draws one warning, as in the JAX package
RECOMPILE_WARN_THRESHOLD = 8

# program uid -> the signature of the last cache entry built for it, by any
# executor: the capture log's attribution diffs against it
_LAST_PROGRAM_SIG: Dict[int, dict] = {}
_LAST_PROGRAM_SIG_LOCK = threading.Lock()

# (program uid, version) already written under PADDLE_TPU_PROGRAM_DUMP_DIR
_DUMPED_PROGRAMS: set = set()


class EOFException(Exception):
    """An in-graph reader (``layers.py_reader`` / ``open_files``) is
    exhausted (Fluid's ``core.EOFException``): catch it, call the reader's
    ``reset()`` and start the next pass."""


class Place:
    """Device tag."""

    def __init__(self, kind: str, device_id: int = 0):
        self.kind = kind
        self.device_id = device_id

    def __repr__(self):
        return f"{self.kind.upper()}Place({self.device_id})"


def CPUPlace() -> Place:
    return Place("cpu", 0)


def CUDAPlace(device_id: int = 0) -> Place:
    return Place("cuda", device_id)


def place_device(place: Place) -> torch.device:
    """The torch device of ``place``; raises for a missing GPU."""
    if place.kind == "cpu":
        return torch.device("cpu")
    if place.kind != "cuda":
        raise ValueError(f"unknown place {place!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{place!r} requested but no CUDA device is available; pass "
            f"place=CPUPlace() to run on the CPU")
    if place.device_id >= torch.cuda.device_count():
        raise RuntimeError(f"{place!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
    return torch.device("cuda", place.device_id)


def analyze_state(block: BlockDesc, feed_names) -> tuple:
    """(state_in, state_out): names the block reads before any op writes
    them and that are not feeds, and written names that are persistable or
    read-modify-written.  Control-flow sub-blocks are scanned too: a name
    a body reads from the enclosing scope is read by the block, and a name
    a ``while`` or ``conditional_block`` body writes there is a carry,
    both read (its value before the loop or branch) and written."""
    feeds = set(feed_names)
    state_in: List[str] = []
    written: List[str] = []

    def scan(op: OpDesc, defined: set):
        for name in op.input_names():
            if name and name not in defined and name not in feeds and name not in state_in:
                state_in.append(name)
        for sub in sub_blocks(op, block.program):
            # vars declared in the sub-block are local to it (step inputs
            # and memories the lowering binds)
            sub_defined = defined | set(sub.vars)
            for sop in sub.ops:
                scan(sop, sub_defined)
                sub_defined.update(n for n in sop.output_names() if n)
            if op.type not in ("while", "conditional_block"):
                continue
            for n in block_written_names(sub):
                if n in sub.vars or n in feeds:
                    continue
                if n not in defined and n not in state_in:
                    state_in.append(n)
                if n not in written:
                    written.append(n)
        for name in op.output_names():
            if name:
                defined.add(name)
                if name not in written:
                    written.append(name)

    defined: set = set()
    for op in block.ops:
        # a read op's reader is a queue on the host and its outputs are
        # bound as feeds (Executor._pop_readers)
        if op.type not in _SKIP_OPS:
            scan(op, defined)
    state_out = []
    for n in written:
        vd = block.find_var(n)
        if (vd is not None and vd.persistable) or n in state_in:
            state_out.append(n)
    return state_in, state_out


def graph_blockers(program: Program, state_in: Sequence[str],
                   state_out: Sequence[str], mesh=None) -> List[str]:
    """Why block 0 of ``program`` gets no CUDA graph (empty: it may).  The
    reference's rule: the block may be one executable when every state
    name it writes is one it reads (its graph then updates the scope's
    tensors in place); a block that initializes state does not.  Nor does
    a block with a generic grad of a random op, or the grad of a control
    flow op whose body draws, which draws from a fork of the generator (a
    graph would replay the fork's numbers), or one that runs a ``while``
    without ``max_iters``, which reads its condition on the host each
    trip.  A bounded ``while``, a ``conditional_block`` and a
    ``recurrent`` op run a fixed number of trips on the device and are
    recorded whole.  Under a ``mesh`` whose collectives run on the host
    (gloo) no block gets a graph; an NCCL mesh's collectives are device
    work, recorded with the rest."""
    reasons = []
    if mesh is not None and not mesh.graph_safe:
        reasons.append(f"runs its collectives over {mesh.backend} ({mesh!r}), on the host, "
                       f"which a CUDA graph cannot hold")
    have = set(state_in)
    created = [n for n in state_out if n not in have]
    if created:
        names = ", ".join(created[:3]) + (", ..." if len(created) > 3 else "")
        reasons.append(f"initializes state ({len(created)} vars: {names})")
    desc = program.desc
    ops = [op for b in desc.blocks for op in b.ops]
    forks = sorted({op.type for op in ops if op_forks(op, desc)})
    if forks:
        reasons.append(f"forks the generator in a generic grad ({', '.join(forks)})")
    unbounded = sum(op.type == "while" and op.attr("max_iters") is None for op in ops)
    if unbounded:
        reasons.append(f"runs {unbounded} unbounded while loop(s) (no max_iters), which read "
                       f"their condition on the host each trip")
    from ..ops.dist_ops import SERVER_OPS
    server = sorted({op.type for op in ops if op.type in SERVER_OPS})
    if server:
        reasons.append(f"calls a parameter server between its other ops ({', '.join(server)}), "
                       f"which runs on the host")
    return reasons


class HostStages:
    """How a program that talks to parameter servers runs (``plan_host_stages``):
    ``head`` (server ops run on the host before the rest, in order),
    ``body`` (a program of the other ops: one CUDA graph a step on the
    card, where nothing else blocks it) and ``tail`` (server ops run on the
    host after it, in order); ``tail_reads``: the names the tail reads,
    which the body keeps as outputs unless they are feeds."""

    def __init__(self, head: List[OpDesc], body: Program, tail: List[OpDesc]):
        self.head, self.body, self.tail = head, body, tail
        self.tail_reads = list(dict.fromkeys(n for op in tail for n in op.input_names() if n))


def plan_host_stages(program: Program) -> Optional[HostStages]:
    """Split block 0's parameter-server ops off a step (None: it has none).
    A server op goes to the head when every server op before it does, every
    name it reads is one no other op of the step writes (a feed, or state
    the step does not write) and no op before it reads or writes what it
    writes: ``recv`` and ``fetch_barrier``, and a ``distributed_lookup_table``
    over fed ids, whose rows become a feed of the body.  Of the rest, one
    goes to the tail when every server op after it does and no op after it
    reads or writes its outputs or writes its inputs: ``send``,
    ``send_barrier``, ``distributed_table_push``.  A server op that fits
    neither stays in the body, whose ``graph_blockers`` then name it (it
    runs op by op).  ``listen_and_serv`` is never split off."""
    from ..ops.dist_ops import SERVER_OPS
    ops = program.desc.block(0).ops
    server = [i for i, op in enumerate(ops) if op.type in SERVER_OPS
              and op.type != "listen_and_serv"]
    if not server:
        return None
    writers: Dict[str, List[int]] = {}
    for i, op in enumerate(ops):
        for n in op.output_names():
            if n:
                writers.setdefault(n, []).append(i)
    head: List[int] = []
    for i in server:
        op = ops[i]
        outs = {n for n in op.output_names() if n}
        if any(j not in head for j in server if j < i):
            break
        if any(w != i and w not in head for n in op.input_names() if n for w in writers.get(n, ())):
            break
        if any(outs & (set(ops[j].input_names()) | set(ops[j].output_names()))
               for j in range(i) if j not in head):
            break
        head.append(i)
    rest = [i for i in server if i not in head]
    tail: List[int] = []
    for i in reversed(rest):
        op = ops[i]
        if any(j not in tail for j in rest if j > i):
            break
        outs = {n for n in op.output_names() if n}
        ins = {n for n in op.input_names() if n}
        later = [ops[j] for j in range(i + 1, len(ops)) if j not in tail]
        if any(outs & (set(o.input_names()) | set(o.output_names())) or ins & set(o.output_names())
               for o in later):
            break
        tail.insert(0, i)
    if not head and not tail:
        return None
    body = program.clone()
    moved = set(head) | set(tail)
    body.desc.block(0).ops = [op for i, op in enumerate(body.desc.block(0).ops) if i not in moved]
    body.desc._bump()
    body.blocks[0].ops = [o for i, o in enumerate(body.blocks[0].ops) if i not in moved]
    return HostStages([ops[i] for i in head], body, [ops[i] for i in tail])


def _matmul_flags() -> Tuple[Tuple[str, bool], ...]:
    """The flags a capture bakes into its cuBLAS and cuDNN calls (cuDNN's
    choice of convolution algorithms among them)."""
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return (("tf32_matmul", m.allow_tf32),
            ("tf32_cudnn", cudnn.allow_tf32),
            ("bf16_reduced", m.allow_bf16_reduced_precision_reduction),
            ("fp16_reduced", m.allow_fp16_reduced_precision_reduction),
            ("cudnn_deterministic", cudnn.deterministic),
            ("cudnn_benchmark", cudnn.benchmark))


def _write_back(state_out: Sequence[str], homes: Dict[str, Any],
                env: Dict[str, Any]) -> Dict[str, Any]:
    """Copy each written state value in ``env`` into its home tensor
    (``homes``: name -> the tensor the value goes into), where it is not
    that tensor already, in one ``torch._foreach_copy_``.  Returns the
    values that have no home of their shape, dtype and device (state the
    block initializes), for the caller to bind."""
    dst, src, rest = [], [], {}
    for n in state_out:
        v, h = env.get(n), homes.get(n)
        if v is None or v is h:
            continue
        if is_dtensor(h):
            # under a mesh: the value on the home's placements, shard to shard
            v, h = _local_like(v, h), h.to_local()
            if v is h:
                continue
        if isinstance(h, torch.Tensor) and isinstance(v, torch.Tensor) and \
                (h.shape, h.dtype, h.device) == (v.shape, v.dtype, v.device):
            dst.append(h)
            src.append(v)
        else:
            rest[n] = v
    if dst:
        # a value that is another name's home is read before it is overwritten
        home_ids = {id(h) for h in dst}
        torch._foreach_copy_(dst, [v.clone() if id(v) in home_ids else v for v in src])
    return rest


def _local_like(v, home) -> torch.Tensor:
    """This rank's shard of ``v`` on ``home``'s placements (``home`` a
    DTensor): a DTensor redistributed there, a plain (global) tensor split
    there."""
    from torch.distributed.tensor import distribute_tensor
    if is_dtensor(v):
        if tuple(v.placements) != tuple(home.placements):
            v = v.redistribute(home.device_mesh, home.placements)
        return v.to_local()
    if not isinstance(v, torch.Tensor):
        return v
    return distribute_tensor(v, home.device_mesh, home.placements, src_data_rank=None).to_local()


def _fetches(entry: "_CacheEntry", ctx: LowerCtx) -> List[torch.Tensor]:
    """An eager run's fetched tensors: clones where a fetch names state,
    whose tensor the next step updates in place; then the sentinel's
    tensors, when the entry watches any."""
    return [ctx.read(n).clone() if n in entry.state_names else ctx.read(n)
            for n in entry.fetch_names] + ctx.sentinel


def _scope_tensors(scope: Scope):
    """The tensors ``scope`` and its ancestors hold."""
    s, seen = scope, set()
    while s is not None:
        for name, v in s._vars.items():
            if name not in seen and isinstance(v, torch.Tensor):
                seen.add(name)
                yield v
        s = s.parent


def _private(entry: "_CacheEntry", env: Dict[str, Any]) -> Dict[str, Any]:
    """``env`` (state_in name -> value) with clones of the state the block
    writes: a run over it changes nothing the scope holds."""
    written = set(entry.state_out)
    return {n: v.clone() if n in written and isinstance(v, torch.Tensor) else v
            for n, v in env.items()}


def _feed_shapes(feed) -> Dict[str, tuple]:
    """The shapes of a feed dict's values that have one."""
    return {k: tuple(int(d) for d in v.shape) for k, v in feed.items() if hasattr(v, "shape")}


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    return copy


def _dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX package's spelling)."""
    return str(dtype).replace("torch.", "")


def _tensor_sig(name: str, v, with_address: bool) -> tuple:
    if not isinstance(v, torch.Tensor):
        return (name, type(v).__name__)
    if is_dtensor(v):
        # the global shape and the placements; the shard's address
        local = v.to_local()
        sig = (name, tuple(v.shape), v.dtype, tuple(str(p) for p in v.placements))
        return sig + (local.stride(), local.data_ptr()) if with_address else sig
    if with_address:
        return (name, tuple(v.shape), v.dtype, v.stride(), v.data_ptr())
    return (name, tuple(v.shape), v.dtype)


class _CacheEntry:
    """One entry of the executable cache (the JAX package's
    ``_CompiledBlock``): the rewritten program, the feeds' shapes and
    coerced dtypes, the analysed ``state_in`` / ``state_out`` and fetch
    names, and on the card, for a graph-eligible program, the CUDA graph
    of the whole lowering with its static feed buffers, its output tensors
    and the kernel launches a replay makes (``launches``: (wrapper,
    counter) -> count).  ``eligible``: the program allows a graph;
    ``reasons``: why the entry has none."""

    def __init__(self, program: Program, feeds: Dict[str, torch.Tensor],
                 state_in: List[str], state_out: List[str],
                 fetch_names: List[str], reasons: List[str], eligible: bool):
        self.program = program
        self.block = program.desc.block(0)
        # name -> (shape, coerced dtype)
        self.feeds = {k: (tuple(t.shape), t.dtype) for k, t in feeds.items()}
        self.state_in = state_in
        self.state_out = state_out
        self.state_names = frozenset(state_in).union(state_out)
        self.fetch_names = fetch_names
        # for each op, the values that leave the environment after it
        self.frees: Optional[List[List[str]]] = None
        self.reasons: Tuple[str, ...] = tuple(reasons)
        self.eligible = eligible      # the program allows a graph
        self.fingerprint: Optional[str] = None
        self.compile_s = 0.0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_feeds: Dict[str, torch.Tensor] = {}
        self.outputs: List[torch.Tensor] = []
        self.launches: Dict[tuple, int] = {}
        self.state: List[Any] = []     # the captured state tensors, kept alive
        self.donate = False            # the feeds are the step's (dropped after use)
        # the generator a graph's replays draw from (kept alive: its id is keyed)
        self.generator: Optional[torch.Generator] = None
        # the health sentinel (``Executor(sentinels=...)``): the watched
        # names, whose finite bits pack into the mask (fetches, then the
        # group pseudo-names), and the gradient and state groups behind the
        # norms; ``sentinel_extra`` tensors (5, or 0) follow the fetches
        self.sentinel_watch: Tuple[str, ...] = ()
        self.grad_watch: Tuple[str, ...] = ()
        self.param_watch: Tuple[str, ...] = ()
        self.sentinel_extra = 0

    @property
    def kind(self) -> str:
        return "graph" if self.graph is not None else "eager"

    def watch(self, sentinels: Sequence[str]) -> None:
        """Fix the sentinel's watched names (the JAX package's rule): the
        fetches (at most ``MAX_WATCH``); the gradients of parameters and
        persistable vars the block writes, as one group; the persistable
        state it writes, as another."""
        if not sentinels:
            return
        from ..health import GRADS_GROUP, MAX_WATCH, PARAMS_GROUP
        block = self.block
        grads: List[str] = []
        for op in block.ops:
            for n in op.output_names():
                if not n or not n.endswith(GRAD_SUFFIX) or n in grads:
                    continue
                vd = block.find_var(n[:-len(GRAD_SUFFIX)])
                if vd is not None and (vd.is_parameter or vd.persistable):
                    grads.append(n)
        params = []
        for n in self.state_out:
            vd = block.find_var(n)
            if vd is not None and vd.persistable and n not in params:
                params.append(n)
        watch: List[str] = []
        if "fetches" in sentinels:
            watch += [n for n in self.fetch_names if n not in watch]
        watch = watch[:MAX_WATCH]
        if "grads" in sentinels and grads:
            self.grad_watch = tuple(grads)
            watch.append(GRADS_GROUP)
        if "params" in sentinels and params:
            self.param_watch = tuple(params)
            watch.append(PARAMS_GROUP)
        self.sentinel_watch = tuple(watch)
        self.sentinel_extra = 5 if watch else 0

    def info(self) -> Dict[str, Any]:
        return {"fingerprint": (self.fingerprint or "")[:12], "kind": self.kind,
                "graph_eligible": self.eligible, "reasons": list(self.reasons),
                "compile_s": round(self.compile_s, 4),
                "feeds": {k: [list(s), str(d)] for k, (s, d) in self.feeds.items()},
                "launches": {f"{w.__name__}.{a}": n for (w, a), n in self.launches.items()}}


class Executor:
    """Executor on one device (one rank's, under a ``mesh``), with the
    executable cache described above.  ``place=None`` means
    ``CUDAPlace(0)``, or the mesh's device.

    ``passes``: ``None``/``False``, a list of pass names or a
    ``PassPipeline``; ``amp``: ``None``/``AmpPolicy``/``AmpConfig``;
    ``kernels``: ``None`` (on for a CUDA place, off on the CPU),
    ``True``/``False`` or a ``KernelPolicy``; ``validate`` and
    ``memory_budget``: the static analysis described above; ``sentinels``:
    the health sentinel described above."""

    _SEQ = itertools.count(1)      # executor numbering, for telemetry scopes

    def __init__(self, place: Optional[Place] = None, passes=None, amp=None,
                 kernels=None, validate: Optional[str] = None, memory_budget=None,
                 sentinels=None, mesh=None, batch_axis: str = "data", layout=None):
        # mesh: a parallel.mesh.Mesh -- each run's state lives on its
        # placements (the layout's specs and Variable.set_sharding), the
        # feeds are this rank's rows of the global batch over the batch
        # axes, the step runs on DTensors and fetches come back whole
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.layout = layout
        self._layout_fp = layout.fingerprint() if layout is not None else None
        if mesh is not None:
            dev = mesh.device
            if place is None:
                place = CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)
            if place_device(place) != dev:
                raise ValueError(f"place {place!r} is not the device of {mesh!r} ({dev})")
            if sentinels:
                raise NotImplementedError(
                    "the health sentinel under a mesh (its global-norm mode and the "
                    "cross-rank skew) is not ported to paddle_tpu_torch yet "
                    "(ROADMAP §A item 12c)")
        elif layout is not None:
            raise ValueError("Executor(layout=...) needs mesh=")
        self.place = place if place is not None else CUDAPlace(0)
        self.device = place_device(self.place)
        # sentinels: the health sentinel (``health.sentinel_extras``) over
        # the chosen value groups, computed inside each step (inside its
        # CUDA graph on the card) as five extra outputs that ``run`` hands
        # to the attached ``HealthMonitor`` without waiting.  True watches
        # every group, or pass a subset of ("fetches", "grads", "params").
        self.sentinels: Tuple[str, ...] = sentinel_classes(sentinels)
        # set by HealthMonitor.attach(): called with each step's sentinel
        # values, and whether it wants the step's feed kept for localization
        self._health_hook = None
        self._health_keep_feed = False
        if validate is None:
            validate = os.environ.get("PADDLE_TPU_VALIDATE", "off")
        if validate not in ("off", "warn", "error"):
            raise ValueError(f"validate must be 'error', 'warn' or 'off', got {validate!r}")
        self.validate = validate
        # (uid, version, fetch names) -> VerifyResult: the buckets of one
        # program share one verification
        self._verified: Dict[tuple, Any] = {}
        # bytes, a size string or a device profile; plans are memoized per
        # feed signature (each serving bucket is a plan of its own)
        self.memory_budget = memory_budget
        self._budget_memo: Dict[tuple, Any] = {}
        # (uid, version) -> the program carries a donate feed stamp
        self._donate_stamp_memo: Dict[tuple, bool] = {}
        from ..ops.cuda.policy import as_kernel_policy
        if kernels is None:
            kernels = self.device.type == "cuda"
        self.kernel_policy = as_kernel_policy(kernels)
        if passes or amp or self.kernel_policy is not None:
            from ..amp import compose_passes
            self.passes = compose_passes(passes, amp, kernels=self.kernel_policy)
        else:
            self.passes = None
        self._passes_fp = self.passes.fingerprint() if self.passes is not None else None
        # (uid, version, amp flag, feed names, fetch names) -> the program to run
        self._pass_memo: Dict[tuple, Program] = {}
        # (uid, version, fetch names) -> the amp-bf16 rewrite of a program
        # flagged by enable_amp
        self._amp_bridge_memo: Dict[tuple, Program] = {}
        # (uid, version, feed names) -> (state_in, state_out, graph blockers)
        self._analysis_memo: Dict[tuple, tuple] = {}
        # (uid, version) -> the block's read ops (in-graph readers)
        self._read_ops_memo: Dict[tuple, List[OpDesc]] = {}
        # (uid, version) -> the program's HostStages, or None (no server op)
        self._host_stages_memo: Dict[tuple, Optional[HostStages]] = {}
        self._host_pool = None         # threads of the host stages, one an endpoint
        # the last split run's host stages: seconds and payload bytes
        self.last_host_stages: Optional[Dict[str, float]] = None
        self.pserver = None            # the ParameterServer ``run_pserver`` serves
        self._cache: Dict[tuple, _CacheEntry] = {}
        # the key without state addresses, and the scope -> the key of the
        # one graph-eligible entry kept for it (see ``_get_entry``)
        self._by_shape: Dict[tuple, tuple] = {}
        # guards the cache, and a graph's feed copy, replay and output copies
        self._lock = threading.RLock()
        self._side_stream = None       # the captures' eager runs
        # the cache's counters, in this executor's own telemetry scope (two
        # executors' numbers never mix); process-wide totals stay in the
        # "pipeline" scope (COUNTERS)
        self.telemetry_scope = f"executor:{next(Executor._SEQ)}"
        sc = self.telemetry_scope
        self._m_compiles = REGISTRY.counter("compile_count", scope=sc)
        self._m_fresh = REGISTRY.counter("fresh_compiles", scope=sc)
        self._m_persistent = REGISTRY.counter("persistent_hits", scope=sc)
        self._m_hits = REGISTRY.counter("cache_hits", scope=sc)
        self._m_misses = REGISTRY.counter("cache_misses", scope=sc)
        self._m_runs = REGISTRY.counter("runs", scope=sc)
        self._m_captures = REGISTRY.counter("captures", scope=sc)
        self._per_program_compiles: Dict[int, int] = {}
        self._per_program_replaced: Dict[int, int] = {}

    # counters, under the JAX package's names (the rest: ``cache_info``)
    @property
    def compile_count(self) -> int:
        """Cache entries built (graphs captured and eager entries)."""
        return self._m_compiles.value

    @property
    def fresh_compile_count(self) -> int:
        return self._m_fresh.value

    @property
    def persistent_hit_count(self) -> int:
        """Always 0: a CUDA graph is not saved across processes."""
        return self._m_persistent.value

    @property
    def run_count(self) -> int:
        return self._m_runs.value

    def _apply_passes(self, program: Program, feed_names: List[str],
                      fetch_names: List[str], scope: Optional[Scope] = None,
                      feed_shapes=None) -> Program:
        """The rewritten program, from the pipeline run once per (program
        uid, version, amp flag, feed names, fetch names, and the scope when
        a pass reads parameter values: ``bn-fold``).  The rewrite lands
        on a clone with the program's uid and a version of its own, so
        running the rewritten program again hits the memo too.  A program
        flagged by ``enable_amp`` goes through the bridge after the pipeline
        (the flag is in the key: setting it does not move the version).
        As in the JAX package, the pipeline infers the feeds from the
        program and plans with the first call's ``feed_shapes``
        (``donation-insert``): a dict, or a function giving one, called
        only on a memo miss (the run path's hits pay nothing for it)."""
        def shapes():
            return (feed_shapes() if callable(feed_shapes) else feed_shapes) or None
        if self.passes is None:
            return self._legacy_amp_rewrite(program, fetch_names, shapes)
        scope = scope or global_scope()
        names = (tuple(sorted(feed_names)), tuple(fetch_names))
        if any(p.requires_scope for p in self.passes.passes):
            names += (id(scope),)
        key = (program.desc.uid, program.desc.version, program.amp) + names
        hit = self._pass_memo.get(key)
        if hit is not None:
            return hit
        new_prog, _ = self.passes.run(program, fetch_list=fetch_names,
                                      feed_shapes=shapes(), scope=scope)
        new_prog = self._legacy_amp_rewrite(new_prog, fetch_names, shapes)
        self._pass_memo[key] = new_prog
        self._pass_memo[(new_prog.desc.uid, new_prog.desc.version, new_prog.amp) + names] = \
            new_prog
        return new_prog

    def _legacy_amp_rewrite(self, program: Program, fetch_names: List[str],
                            feed_shapes=lambda: None) -> Program:
        """The ``program.amp = True`` bridge: the flag goes through the
        ``amp-bf16`` pass with the default policy, so the legacy API is
        fingerprint-identical to the pass path.  A program an amp pass has
        already rewritten is left alone.  A program the pass skips
        (several blocks) keeps the flag and runs with the lowering-time
        casts (``core/lower.py``), as in the JAX package.  ``feed_shapes``
        gives the feed shapes on a memo miss."""
        if not program.amp or program._amp_policy_fp:
            return program
        key = (program.desc.uid, program.desc.version, tuple(fetch_names))
        hit = self._amp_bridge_memo.get(key)
        if hit is not None:
            return hit
        from ..passes import PassPipeline
        new_prog, result = PassPipeline(["amp-bf16"]).run(program, fetch_list=fetch_names,
                                                          feed_shapes=feed_shapes())
        self._amp_bridge_memo[key] = new_prog
        if new_prog is not program:
            self._amp_bridge_memo[(new_prog.desc.uid, new_prog.desc.version)
                                  + key[2:]] = new_prog
        return new_prog

    def _amp_desc(self, program: Program):
        """The amp descriptor keyed into the cache and the fingerprint: the
        policy fingerprint when a dtype pass rewrote the program, else the
        legacy flag."""
        return program._amp_policy_fp or bool(program.amp)

    def _wants_donate(self, program: Program) -> bool:
        """Whether ``program`` carries a ``donate`` feed stamp (the
        ``donation-insert`` pass's output), once per (uid, version)."""
        key = (program.desc.uid, program.desc.version)
        want = self._donate_stamp_memo.get(key)
        if want is None:
            from ..analysis.memory import DONATE_ATTR
            want = any(vd.attrs.get(DONATE_ATTR) for vd in program.desc.block(0).vars.values()
                       if not vd.persistable)
            self._donate_stamp_memo[key] = want
        return want

    def _check(self, program: Program, feeds: Dict[str, torch.Tensor],
               fetch_names: List[str], donate: bool) -> None:
        """The static analysis before a run: the verifier, then the memory
        pre-flight (each a no-op when off, and memoized)."""
        if self.validate != "off":
            self._maybe_validate(program, fetch_names, donate, list(feeds))
        if self.memory_budget is not None:
            self._preflight_memory(program, feeds, fetch_names, donate)

    def _maybe_validate(self, program: Program, fetch_names: List[str],
                        donate_feeds: bool = False, feed_names: Sequence[str] = ()) -> None:
        """Verify ``program`` once per (uid, version, fetch names, feed
        names): ``error`` raises on error-severity findings, both modes warn
        on the rest.  The feeds are those inferred from the program (an
        unproduced non-persistable read may be fed or found in the scope),
        as the JAX executor infers them, and the fetched names that are fed
        and that no op produces: a fed var no op reads may still be fetched
        (D203 would call it unreachable)."""
        key = (program.desc.uid, program.desc.version, tuple(fetch_names),
               tuple(sorted(feed_names)))
        if key in self._verified:
            return
        from ..analysis import ProgramVerificationError, record_findings, verify
        from ..analysis.verifier import _BlockFacts
        facts = _BlockFacts(program.desc.block(0))
        fed = set(feed_names)
        feeds = facts.feed_like() | {n for n in fetch_names if n in fed and n not in facts.producer}
        res = verify(program, fetch_list=fetch_names, feed_names=feeds,
                     donate_feeds=donate_feeds, mesh=self.mesh, layout=self.layout)
        self._verified[key] = res
        record_findings(res)
        if res.errors and self.validate == "error":
            raise ProgramVerificationError(res)
        findings = res.findings
        if findings:
            lines = [d.format() for d in findings[:8]]
            if len(findings) > 8:
                lines.append(f"... and {len(findings) - 8} more")
            warnings.warn(f"program verifier found {len(findings)} issue(s):\n  "
                          + "\n  ".join(lines), stacklevel=4)

    def _preflight_memory(self, program: Program, feeds: Dict[str, torch.Tensor],
                          fetch_names: List[str], donate_feeds: bool = False) -> None:
        """Plan the per-device peak of ``program`` at this feed signature
        (``analysis.plan_memory``) and raise ``PredictedOOMError`` when it
        exceeds ``memory_budget``, before anything is allocated for the
        program.  Memoized per feed signature (a verdict, error included);
        each plan sets the ``predicted_peak_bytes`` gauge and goes to
        ``memplan_<pid>.jsonl``."""
        shapes = _feed_shapes(feeds)
        key = (program.desc.uid, program.desc.version, tuple(sorted(shapes.items())),
               tuple(fetch_names), donate_feeds)
        hit = self._budget_memo.get(key)
        if hit is not None:
            if isinstance(hit, Exception):
                raise hit
            return
        from ..analysis import memory as _memory
        budget = _memory.parse_memory_budget(self.memory_budget)
        plan = _memory.plan_memory(program, fetch_list=fetch_names,
                                   feed_shapes=self.global_feed_shapes(program.desc.block(0),
                                                                       shapes),
                                   donate_feeds=donate_feeds, mesh=self.mesh, layout=self.layout)
        REGISTRY.gauge("predicted_peak_bytes", scope=self.telemetry_scope).set(plan.peak_bytes)
        _memory.export_plan(plan, scope=self.telemetry_scope, budget=budget)
        if plan.peak_bytes > budget:
            err = _memory.PredictedOOMError(plan, budget)
            self._budget_memo[key] = err
            raise err
        self._budget_memo[key] = True

    @staticmethod
    def _feed_host(block: BlockDesc, name: str, value) -> Tuple[torch.Tensor, torch.dtype]:
        """A feed as a tensor (a view of a numpy array) and the dtype it
        runs in: its declared dtype (the value's own for undeclared
        ``@SEQ_LEN`` feeds), with 64-bit types narrowed."""
        t = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(value))
        vd = block.find_var(name)
        want = vd.dtype if vd is not None and vd.type == VarType.DENSE_TENSOR \
            else convert_dtype(t.dtype)
        return t, coerce_feed_dtype(want).torch_dtype

    def _feed_tensor(self, block: BlockDesc, name: str, value) -> torch.Tensor:
        """A feed as a tensor in the dtype it runs in.  A numpy array is
        coerced on the host; a tensor keeps its device (a staged tensor is
        in that dtype already, and is returned as it is).  Under a mesh a
        DTensor feed (``DeviceLoader(sharding=)``) is taken as this rank's
        shard on the feed's placements."""
        if self.mesh is not None and is_dtensor(value):
            from ..parallel.layout import as_placements
            want = as_placements(self._feed_spec(block, name, value.ndim), self.mesh)
            if tuple(value.placements) != want:
                value = value.redistribute(self.mesh.device_mesh, want)
            value = value.to_local()
        t, dtype = self._feed_host(block, name, value)
        return t.to(dtype=dtype)

    def _wait_staged(self, feed) -> None:
        """A batch staged on the card (a :class:`StagedBatch` with an
        event): the current stream waits for its copies before anything
        reads it, and each of its tensors is marked as used by that
        stream, so its memory is not handed out again before the step that
        reads it has run."""
        event = getattr(feed, "event", None)
        if event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in feed.values():
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(cur)

    def _pop_readers(self, program: Program, scope: Scope, feed) -> dict:
        """Bind each in-graph ``read`` op's outputs from its reader's queue
        (the py_reader contract): one batch a read op a run, added to the
        feeds, so a step with a ``read`` op enters the card through the
        same input copy as a fed one.  Every reader is checked before
        anything is popped; at end of stream the batches already popped
        from sibling readers go back to their queues (their streams stay
        aligned for the next pass) and :class:`EOFException` is raised, or
        the reader pipeline's error as the cause of a ``RuntimeError``.  A
        batch holds one array an output, then the ``@SEQ_LEN`` lengths of
        its ``lod_level > 0`` outputs in order."""
        desc = program.desc
        key = (desc.uid, desc.version)
        read_ops = self._read_ops_memo.get(key)
        if read_ops is None:
            read_ops = [o for o in desc.block(0).ops if o.type == "read"]
            self._read_ops_memo[key] = read_ops
        if not read_ops:
            return feed
        from .lower import SEQ_LEN_SUFFIX
        feed = dict(feed)
        for rop in read_ops:
            qname = rop.input("Reader")[0]
            q = scope.find_var(qname)
            if q is None:
                raise RuntimeError(
                    f"reader {qname!r} has no queue in the scope -- was the "
                    f"py_reader created under a different scope?")
            if not getattr(q, "started", True):
                raise RuntimeError(
                    f"reader {qname!r} was never started -- call "
                    f"reader.start() before exe.run()")
        popped = []
        for rop in read_ops:
            rname = rop.input("Reader")[0]
            q = scope.find_var(rname)
            batch = q.pop()
            if batch is None:
                for other_q, other_batch in popped:
                    other_q.unpop(other_batch)
                err = getattr(q, "error", None)
                if err is not None:
                    raise RuntimeError(f"reader {rname!r}'s data pipeline failed") from err
                raise EOFException(f"reader {rname!r} exhausted (reset() it to start a "
                                   f"new pass)")
            popped.append((q, batch))
        for rop, (q, batch) in zip(read_ops, popped):
            outs = rop.output("Out")
            lods = list(rop.attr("lod_levels", [0] * len(outs)))
            data, extra = batch[:len(outs)], list(batch[len(outs):])
            if len(data) < len(outs):
                raise ValueError(
                    f"reader {rop.input('Reader')[0]!r} batch has {len(data)} arrays "
                    f"but the read op declares {len(outs)} outputs")
            for name, arr in zip(outs, data):
                feed[name] = arr
            for name, lod in zip(outs, lods):
                if lod and extra:
                    feed[name + SEQ_LEN_SUFFIX] = extra.pop(0)
        return feed

    def _prepare(self, program, feed, fetch_list, scope, readers: bool = True):
        program = program or default_main_program()
        feed = feed or {}
        self._wait_staged(feed)
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        program = self._apply_passes(program, list(feed), fetch_names, scope,
                                     lambda: _feed_shapes(feed))
        if readers:
            feed = self._pop_readers(program, scope, feed)
        block = program.desc.block(0)
        if TIMELINE.enabled:
            t0 = TIMELINE.now_us()
            feeds = {k: self._feed_tensor(block, k, v) for k, v in feed.items()}
            TIMELINE.record_complete("executor::feed", t0, TIMELINE.now_us() - t0)
        else:
            feeds = {k: self._feed_tensor(block, k, v) for k, v in feed.items()}
        return program, scope, feeds, fetch_names

    def run(self, program: Optional[Program] = None, feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, sync: bool = True, donate_feeds: bool = False):
        """Run block 0 once through its cache entry.  ``sync=False``
        returns :class:`FetchHandle`\\ s whose copies to pinned host memory
        are enqueued behind the step, so the caller can enqueue the next
        step meanwhile; otherwise numpy arrays (``return_numpy``; a bf16
        value comes back as float32, numpy having no bfloat16) or device
        tensors (clones of a graph's outputs).  ``donate_feeds`` (or a
        program's ``donate`` stamp) donates a ``donatable`` staged batch
        (see the module docstring)."""
        stages = self._host_stages(program or default_main_program())
        if stages is not None:
            return self._run_host_stages(stages, feed, fetch_list, scope, return_numpy, sync,
                                         donate_feeds)
        # a staged batch's flow id links its stage span to this step's span
        timeline = TIMELINE.enabled
        flow_id = getattr(feed, "flow_id", None) if timeline else None
        program, scope, feeds, fetch_names = self._prepare(program, feed, fetch_list, scope)
        donate = bool(getattr(feed, "donatable", False)) and \
            (donate_feeds or self._wants_donate(program))
        self._check(program, feeds, fetch_names, donate)
        check_nan, bench = FLAGS.check_nan_inf, FLAGS.benchmark
        # FLAGS_check_nan_inf: the state and feeds before the run, for the
        # op-by-op replay that names the first bad op (the run updates the
        # state in place)
        snapshot = self._nan_snapshot(program, feeds, scope) if check_nan else None
        # a monitor that localizes trips keeps each step's feed, on this
        # executor's device: a graph's feed buffers are overwritten by the
        # next replay, a donated batch is emptied
        kept_feed = {k: t.to(self.device, copy=True) for k, t in feeds.items()} \
            if self.sentinels and self._health_hook is not None and self._health_keep_feed \
            else None
        if donate:
            # the batch is the step's now: only ``feeds`` holds its tensors
            feed.clear()
        self._m_runs.inc()
        step_no = self._m_runs.value
        t_bench = time.perf_counter() if bench else 0.0
        label = dispatch_us = None
        if timeline:
            label, dispatch_us = f"step[{step_no}]", TIMELINE.now_us()
            if flow_id is not None:
                TIMELINE.record_flow("f", "staged_batch", flow_id, TIMELINE.now_us())
        outs = sentinel = None
        with self._lock:
            entry, state, warm = self._get_entry(program, feeds, fetch_names, scope, donate)
            if entry.graph is not None and warm is None:
                # the outputs' copies are enqueued before another replay can start
                fetches = self._replay(entry, feeds)
                if check_nan:
                    self._check_nan_inf(entry, fetches, scope, snapshot)
                outs, sentinel = self._stage_step(entry, fetches, sync, return_numpy, True,
                                                  label, dispatch_us)
        if outs is None:
            # an eager entry, or the eager run that preceded a fresh capture
            fetches = warm if warm is not None else self._lower(entry, feeds, state, scope)
            if check_nan:
                self._check_nan_inf(entry, fetches, scope, snapshot)
            outs, sentinel = self._stage_step(entry, fetches, sync, return_numpy, False,
                                              label, dispatch_us)
        if bench:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                live = torch.cuda.memory_allocated(self.device)
            else:
                live = sum(v.nbytes for v in _scope_tensors(scope))
            VLOG(0, "benchmark: run %.3f ms, live device buffers %.1f MiB",
                 (time.perf_counter() - t_bench) * 1e3, live / 2**20)
        if sentinel is not None and self._health_hook is not None:
            # the sentinel's values go to the monitor as handles whose
            # copies are enqueued behind the step: no sync here
            try:
                self._health_hook(step=step_no, program=program, compiled=entry,
                                  values=sentinel, feed=kept_feed, scope=scope)
            except Exception as e:  # noqa: BLE001 -- health never kills a run
                VLOG(1, "health hook failed: %s: %s", type(e).__name__, e)
        if timeline:
            TIMELINE.record_complete(f"executor::run(block0/{len(entry.block.ops)} ops)",
                                     dispatch_us, TIMELINE.now_us() - dispatch_us)
        if not (sync and return_numpy):
            return outs
        if not timeline:
            return [h.numpy() for h in outs]
        t0 = TIMELINE.now_us()
        out = [h.numpy() for h in outs]
        TIMELINE.record_complete("executor::fetch", t0, TIMELINE.now_us() - t0)
        return out

    # ------------------------------------------------- parameter servers
    def _host_stages(self, program: Program) -> Optional[HostStages]:
        """``plan_host_stages`` of ``program``, once per (uid, version); the
        body it splits off plans to None."""
        key = (program.desc.uid, program.desc.version)
        if key not in self._host_stages_memo:
            stages = plan_host_stages(program)
            self._host_stages_memo[key] = stages
            if stages is not None:
                self._host_stages_memo[(stages.body.desc.uid, stages.body.desc.version)] = None
        return self._host_stages_memo[key]

    def _by_endpoint(self, ops: List[OpDesc], call) -> list:
        """``call(ops_of_one_endpoint)`` for each endpoint of ``ops`` (its
        ``endpoint`` attr), on a thread each when there are several; the
        results in the ops' order."""
        groups: Dict[str, List[int]] = {}
        for i, op in enumerate(ops):
            groups.setdefault(str(op.attr("endpoint")), []).append(i)
        parts = [[ops[i] for i in idx] for idx in groups.values()]
        if len(parts) > 1:
            if self._host_pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._host_pool = ThreadPoolExecutor(8, thread_name_prefix="pserver-io")
            results = list(self._host_pool.map(call, parts))
        else:
            results = [call(p) for p in parts]
        out: list = [None] * len(ops)
        for idx, res in zip(groups.values(), results):
            for i, r in zip(idx, res or [None] * len(idx)):
                out[i] = r
        return out

    def _run_host_stages(self, stages: HostStages, feed, fetch_list, scope, return_numpy: bool,
                         sync: bool, donate_feeds: bool):
        """One step of a program that talks to parameter servers: the head
        on the host (each ``recv`` copies its parameter into the scope's
        tensor in place, on the current stream, before anything of the
        step reads it; other head outputs become feeds of the body), the
        body (one graph replay on the card), one copy of the values the
        tail reads to pinned host memory, then the tail on the host (the
        ``send`` ops one ``send_grads`` round trip an endpoint).  The head
        and the tail run once a call, whatever the body's cache entry does
        (its first run, a capture).  ``last_host_stages`` gets the seconds
        of each part and the payload bytes each way."""
        from ..ops import dist_ops
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        body_feed = copy.copy(feed) if feed is not None else {}
        t0 = time.perf_counter()
        recvs = [op for op in stages.head if op.type == "recv"]
        params = self._by_endpoint(recvs, lambda ops: [dist_ops.host_recv(op) for op in ops])
        got = 0
        for op, arr in zip(recvs, params):
            name = op.output("Out")[0]
            home = scope.find_var(name)
            got += arr.nbytes
            if isinstance(home, torch.Tensor) and tuple(home.shape) == tuple(arr.shape):
                home.copy_(torch.from_numpy(arr), non_blocking=True)
            else:
                body_feed[name] = arr
        for op in stages.head:
            if op.type == "distributed_lookup_table":
                ids_name = op.input("Ids")[0]
                ids = body_feed[ids_name] if ids_name in body_feed else scope.find_var(ids_name)
                rows = dist_ops.host_lookup(op, ids)
                got += rows.nbytes
                body_feed[op.output("Out")[0]] = rows
            elif op.type != "recv":
                dist_ops.run_on_host(op, {
                    n: dist_ops.host_array(body_feed[n] if n in body_feed else scope.find_var(n))
                    for n in op.input_names() if n})
        t1 = time.perf_counter()
        kept = [n for n in stages.tail_reads if n not in body_feed and n not in fetch_names]
        names = fetch_names + kept
        outs = self.run(stages.body, feed=body_feed, fetch_list=names, scope=scope,
                        return_numpy=False, sync=False, donate_feeds=donate_feeds)
        values = {}
        for n in stages.tail_reads:
            if n in body_feed:
                values[n] = dist_ops.host_array(body_feed[n])
            else:
                values[n] = outs[names.index(n)].numpy()
        t2 = time.perf_counter()
        sent, i, tail = 0, 0, stages.tail
        while i < len(tail):
            if tail[i].type == "send":
                j = i
                while j < len(tail) and tail[j].type == "send":
                    j += 1
                grads = {id(op): dist_ops.send_slice(op, values[op.input("X")[0]])
                         for op in tail[i:j]}
                sent += sum(g.nbytes for g in grads.values())
                self._by_endpoint(tail[i:j], lambda ops: dist_ops.host_send_grouped(
                    ops, [grads[id(op)] for op in ops]))
                i = j
                continue
            sent += dist_ops.run_on_host(tail[i], values)
            i += 1
        t3 = time.perf_counter()
        self.last_host_stages = {"head_s": t1 - t0, "step_s": t2 - t1, "tail_s": t3 - t2,
                                 "bytes_received": got, "bytes_sent": sent}
        outs = outs[:len(fetch_names)]
        if not sync:
            return outs
        if return_numpy:
            return [h.numpy() for h in outs]
        return [torch.from_numpy(h.numpy()).to(self.device) for h in outs]

    def run_pserver(self, pserver_program, scope: Optional[Scope] = None,
                    ready_file: Optional[str] = None, on_round=None):
        """Run a parameter-server program: start serving and BLOCK -- the
        analogue of ``exe.run(pserver_program)`` where the listen_and_serv
        op loops forever (reference listen_and_serv_op.cc:251-300).  The
        ``ParameterServer`` (``self.pserver``) runs its updates on this
        executor's place, from ``scope`` (the pserver startup program run
        into it first); its param blocks and table shards are carved out of
        the scope first.  ``ready_file``: written with "host:port" once
        serving (the test harness's _wait_ps_ready contract,
        test_dist_base.py:201).  ``on_round(n)`` is called as round ``n``
        ends.  A ``KeyboardInterrupt`` stops serving and returns."""
        from ..distributed.pserver import (ParameterServer, serve_pserver,
                                           slice_param_blocks, slice_table_shards)
        meta = getattr(pserver_program, "_pserver_meta", None)
        if meta is None:
            raise ValueError("not a pserver program (use "
                             "DistributeTranspiler.get_pserver_program)")
        scope = scope or global_scope()
        if meta.get("slices"):
            slice_param_blocks(scope, meta["slices"])
        ps = ParameterServer(meta["params"], meta["optimize_programs"], scope,
                             meta["trainers"], meta["sync_mode"],
                             lr_program=meta.get("lr_program"),
                             tables=slice_table_shards(scope, meta.get("tables", {})),
                             place=self.place)
        ps.on_round = on_round
        self.pserver = ps
        host, port = meta["endpoint"].rsplit(":", 1)
        srv, addr = serve_pserver(ps, host, int(port))
        if ready_file:
            with open(ready_file + ".tmp", "w") as f:
                f.write(f"{addr[0]}:{addr[1]}")
            os.replace(ready_file + ".tmp", ready_file)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.shutdown()
            srv.server_close()

    def _run_eager(self, program: Optional[Program] = None, feed: Optional[dict] = None,
                   fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
                   return_numpy: bool = True, sync: bool = True):
        """``run`` with the block lowered op by op, outside the cache: the
        eager path a graph is measured and checked against."""
        program, scope, feeds, fetch_names = self._prepare(program, feed, fetch_list, scope)
        self._check(program, feeds, fetch_names, False)
        state_in, state_out, blockers, _, state = self._analyse(program, feeds, scope)
        entry = _CacheEntry(program, feeds, state_in, state_out, fetch_names, blockers,
                            eligible=not blockers)
        outs = self._stage(self._lower(entry, feeds, state, scope), sync, return_numpy,
                           clone=False)
        return [h.numpy() for h in outs] if sync and return_numpy else outs

    def _stage_step(self, entry: _CacheEntry, outs: List[torch.Tensor], sync: bool,
                    return_numpy: bool, clone: bool, label: Optional[str],
                    dispatch_us: Optional[float]):
        """(the caller's fetches staged as ``_stage`` stages them, the
        sentinel's handles or None): an entry's sentinel tensors follow
        its fetches and are peeled off first; their copies to pinned host
        memory are enqueued now, behind the step, whatever the caller
        asked for."""
        sentinel = None
        if entry.sentinel_extra:
            n = len(outs) - entry.sentinel_extra
            outs, extra = outs[:n], outs[n:]
            sentinel = [FetchHandle(t) for t in extra]
            prefetch_to_host(sentinel)
        return self._stage(outs, sync, return_numpy, clone, label=label,
                           dispatch_us=dispatch_us), sentinel

    def _nan_snapshot(self, program: Program, feeds: Dict[str, torch.Tensor], scope: Scope):
        """FLAGS_check_nan_inf's snapshot before a run: the feeds, clones
        of the state the block reads (its updates write it in place) and a
        copy of the scope's generator."""
        state_in, _, _, _, state = self._analyse(program, feeds, scope)
        env = {n: v.clone() if isinstance(v, torch.Tensor) else v
               for n, v in zip(state_in, state)}
        env.update({k: t.to(self.device) for k, t in feeds.items()})
        gen = scope.find_var(RNG_STATE_VAR)
        return env, (self._new_generator(program) if gen is None else _copy_generator(gen))

    def _check_nan_inf(self, entry: _CacheEntry, outs: List[torch.Tensor], scope: Scope,
                       snapshot) -> None:
        """FLAGS_check_nan_inf: scan the fetches and the written state; on a
        hit, replay the block op by op from the snapshot taken before the
        run and raise naming the first op with a non-finite output (Fluid
        scans after every op, operator.cc:643-655; a whole-block graph
        makes the scan post-hoc and the naming a replay)."""
        n = len(outs) - entry.sentinel_extra
        hits = [name for name, v in zip(entry.fetch_names, outs[:n]) if _nonfinite(v)]
        hits += [name for name in entry.state_out if _nonfinite(scope.find_var(name))]
        if not hits:
            return
        env, gen = snapshot
        ctx = LowerCtx(entry.block, dict(env), gen, self.device, amp=bool(entry.program.amp))
        with torch.no_grad():
            for i, op in enumerate(entry.block.ops):
                if op.type in _SKIP_OPS:
                    continue
                lower_op(ctx, op, index=i)
                for name in op.output_names():
                    if name and _nonfinite(ctx.env.get(name)):
                        raise RuntimeError(f"Operator {op.type} output {name!r} contains "
                                           f"NaN/Inf (FLAGS_check_nan_inf)")
        raise RuntimeError(f"NaN/Inf detected in {hits} but the op-by-op replay was clean -- "
                           f"likely a nondeterministic source (a random op); inspect with "
                           f"FLAGS_v=2")

    def _stage(self, fetches, sync: bool, return_numpy: bool, clone: bool,
               label: Optional[str] = None, dispatch_us: Optional[float] = None):
        """Device tensors (``sync`` without ``return_numpy``; clones of a
        graph's buffers), else handles whose copies to pinned host memory
        are enqueued now.  The first handle carries the step's ``label``
        and ``dispatch_us`` (the device-lane span: one a step)."""
        if sync and not return_numpy:
            return [t.clone() for t in fetches] if clone else list(fetches)
        handles = [FetchHandle(t, label, dispatch_us) if i == 0 else FetchHandle(t)
                   for i, t in enumerate(fetches)]
        prefetch_to_host(handles)
        return handles

    # ------------------------------------------------------- async pipeline
    def stage_feeds(self, program: Optional[Program] = None, feeds=(), depth: int = 2,
                    reuse: bool = True, on_batch=None) -> FeedStager:
        """Wrap an iterable of host feed dicts in a :class:`FeedStager` that
        converts batch N+1 on a background thread while batch N runs: on the
        card each value is coerced into a pinned buffer and copied to the
        device on the stager's stream, and ``run`` waits on the batch's
        event and reads the staged tensors as they are.  ``reuse=False``
        turns off the staged-tensor reuse cache and marks batches
        donatable.  ``on_batch(host_feed, staged)`` runs on the stager's
        thread after each batch is staged (``RowPrefetcher.on_batch``).
        Under a mesh each rank's stager stages that rank's rows to its own
        device; the step takes them as its shard of the global batch."""
        program = program or default_main_program()
        block = program.desc.block(0)

        def convert(name, value):
            return self._feed_host(block, name, value)
        return FeedStager(convert, feeds, depth=depth, reuse=reuse, device=self.device,
                          on_batch=on_batch)

    def run_pipelined(self, program: Optional[Program] = None, feeds=(),
                      fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
                      depth: int = 2, donate_feeds: bool = False):
        """Pipelined multi-step execution: a generator over each step's list
        of :class:`FetchHandle`.  Batch N+1 is staged (:meth:`stage_feeds`)
        while step N runs, and fetches do not block (``sync=False``), so the
        device queue stays full until a handle is read.  ``donate_feeds``
        turns off the stager's reuse cache and donates each batch to its
        step (see the module docstring)."""
        program = program or default_main_program()
        stager = self.stage_feeds(program, feeds, depth=depth, reuse=not donate_feeds)
        try:
            for feed in stager:
                yield self.run(program, feed=feed, fetch_list=fetch_list, scope=scope,
                               return_numpy=False, sync=False, donate_feeds=donate_feeds)
        finally:
            stager.close()

    def precompile(self, program: Optional[Program] = None, feed: Optional[dict] = None,
                   fetch_list: Optional[Sequence] = None,
                   scope: Optional[Scope] = None, donate_feeds: bool = False) -> Dict[str, Any]:
        """Build the cache entry of one (program, feed signature) without
        running a step: the serving warmup path.  On the card a
        graph-eligible program is run once eagerly (on clones of the state
        it writes) and captured.  ``feed`` values may be arrays or
        ``(shape, dtype)`` specs (zeros).  On the card an eager entry built
        now is run once, writing no state.  The scope and its generator are
        read, never written (a graph of a random program makes the scope's
        generator if it has none, as its first run would).  Returns the JAX
        package's record (the verifier and the memory pre-flight run first,
        as in ``run``):
        ``fingerprint``, ``kind`` (``graph`` / ``eager``), ``compile_s``
        (the entry's build: on the card the eager run and the capture),
        ``aot`` (a graph was captured) and ``reasons`` (why the entry has
        no graph)."""
        arrays = {}
        for k, v in (feed or {}).items():
            if isinstance(v, tuple) and len(v) == 2 and not hasattr(v, "shape"):
                shape, dtype = v
                v = np.zeros(tuple(int(d) for d in shape), dtype=np.dtype(dtype))
            arrays[k] = v
        if self._host_stages(program or default_main_program()) is not None:
            raise NotImplementedError(
                "precompile of a program that calls parameter servers: its host stages "
                "talk to the servers, so its first run builds its entry")
        program, scope, feeds, fetch_names = self._prepare(program, arrays, fetch_list, scope,
                                                           readers=False)
        self._check(program, feeds, fetch_names, donate_feeds)
        with self._lock:
            compiles = self.compile_count
            entry, state, _ = self._get_entry(program, feeds, fetch_names, scope, donate_feeds)
            built = self.compile_count != compiles
        if built and entry.graph is None and self.device.type == "cuda":
            # an eager entry's first run on the card builds the kernel
            # library and creates cuBLAS's handles: paid here, not by the
            # first live request
            t0 = time.perf_counter()
            self._lower(entry, feeds, state, scope, commit=False)
            torch.cuda.synchronize(self.device)
            entry.compile_s += time.perf_counter() - t0
        return {"fingerprint": entry.fingerprint, "kind": entry.kind,
                "compile_s": round(entry.compile_s, 6), "aot": entry.graph is not None,
                "reasons": list(entry.reasons)}

    def profile_ops(self, program: Optional[Program] = None, feed: Optional[dict] = None,
                    fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
                    samples: int = 3, compiled_step_s: Optional[float] = None):
        """Per-op wall-time attribution of one step (the sampled slice
        profiler of ``paddle_tpu_torch.profiling``): ``feed`` replayed op by
        op through the live slice of the program ``run`` would execute
        with this fetch list (the pass pipeline, the amp bridge and the
        kernel tier applied), each op timed to its outputs being ready.
        The replay runs on clones of the state it writes and draws from a
        generator of its own: the scope, its tensors' addresses, the
        generators and this executor's cache are left as they were.
        ``fetch_list=None`` profiles every op (a training step's backward
        and updates included).  ``compiled_step_s`` (the measured step
        wall, when the caller has one) rides into the record.

        Returns a :class:`~paddle_tpu_torch.profiling.ProgramProfile`; its
        records (``profile_<pid>.jsonl``, ``costmodel_<pid>.json``) go to
        ``PADDLE_TPU_TELEMETRY_DIR`` when it is set."""
        from ..profiling import profile_program
        program = program or default_main_program()
        feed = feed or {}
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        scope = scope or global_scope()
        program = self._apply_passes(program, list(feed), fetch_names, scope,
                                     lambda: _feed_shapes(feed))
        return profile_program(program, feed, scope=scope,
                               fetch_list=fetch_names, samples=samples, executor=self,
                               compiled_step_s=compiled_step_s)

    def cache_info(self) -> Dict[str, Any]:
        """Cache and pipeline statistics, under the JAX package's keys
        (``scope`` names this executor's telemetry scope), and one record
        per entry (``kind``, ``graph_eligible``, ``reasons``,
        ``compile_s``, the feeds' shapes and dtypes and the kernel launches
        a replay makes)."""
        with self._lock:
            return {"executables": len(self._cache), "scope": self.telemetry_scope,
                    "compile_count": self.compile_count,
                    "fresh_compiles": self.fresh_compile_count,
                    "persistent_hits": self.persistent_hit_count,
                    "captures": self._m_captures.value,
                    "hits": self._m_hits.value, "misses": self._m_misses.value,
                    "runs": self._m_runs.value, "pipeline": COUNTERS.snapshot(),
                    "entries": [e.info() for e in self._cache.values()]}

    # ------------------------------------------------------------ the cache
    def _analyse(self, program: Program, feeds: Dict[str, torch.Tensor], scope: Scope):
        """(state_in, state_out, graph blockers, draws, state values): the
        block's analysis, once per (program uid, version, feed names), and
        the values of ``state_in`` in ``scope``."""
        desc = program.desc
        akey = (desc.uid, desc.version, tuple(sorted(feeds)))
        analysis = self._analysis_memo.get(akey)
        if analysis is None:
            state_in, state_out = analyze_state(desc.block(0), feeds)
            analysis = (state_in, state_out,
                        graph_blockers(program, state_in, state_out, mesh=self.mesh),
                        any(op_draws(op, desc) for op in desc.block(0).ops))
            self._analysis_memo[akey] = analysis
        state = []
        for n in analysis[0]:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"variable {n!r} used by the program is not initialized "
                    f"in the scope -- run the startup program first")
            if self.mesh is not None and isinstance(v, torch.Tensor) and not is_dtensor(v):
                # placed once, before the first step that reads it
                from ..parallel.layout import place_tensor, state_spec
                v = place_tensor(v, self.mesh, state_spec(desc.block(0), n, self.mesh,
                                                          self.layout))
                scope.update_var(n, v)
            state.append(v)
        return analysis + (state,)

    def _get_entry(self, program: Program, feeds: Dict[str, torch.Tensor],
                   fetch_names: List[str], scope: Scope, donate: bool = False):
        """(entry, state values, warm): the cache entry of this run, found
        or built, under ``self._lock``.  ``warm`` is the fetches of the eager
        run that preceded a capture made now where the block writes no
        state and draws nothing, else None (such a graph's first step is its
        first replay).

        A graph-eligible entry that misses only because a state tensor of
        the same scope was rebound (its address moved: ``set_var`` of a new
        tensor) replaces the entry it differs from instead of being added
        beside it, so each (program version, feed signature, fetches,
        scope) keeps at most one graph, and the old graph, its memory pool
        and the state it captured go."""
        state_in, state_out, blockers, draws, state = self._analyse(program, feeds, scope)
        desc = program.desc
        on_card = self.device.type == "cuda"
        gen = None
        if draws and not blockers and on_card:
            # the graph registers this generator: keyed by identity
            gen = self._scope_generator(program, scope)
        feed_sig = tuple(sorted((k, tuple(t.shape), t.dtype) for k, t in feeds.items()))
        shape_sig = tuple(_tensor_sig(n, v, False) for n, v in zip(state_in, state))
        state_sig = shape_sig if blockers else \
            tuple(_tensor_sig(n, v, True) for n, v in zip(state_in, state)) + (id(gen),)
        rest = (self._amp_desc(program), self._passes_fp, program._kernel_policy_fp,
                _matmul_flags(), donate, id(self.mesh), self._layout_fp)
        # the sentinel adds outputs to the block, so it keys the entry and
        # the fingerprint as a pseudo-fetch (toggling it reads as a
        # fetch-list change in the capture log)
        sig_fetches = tuple(fetch_names) + (
            ("@HEALTH[" + ",".join(self.sentinels) + "]@",) if self.sentinels else ())
        key = (desc.uid, desc.version, feed_sig, sig_fetches, state_sig) + rest
        entry = self._cache.get(key)
        if entry is not None:
            self._m_hits.inc()
            COUNTERS.inc("cache_hits")
            return entry, state, None
        self._m_misses.inc()
        COUNTERS.inc("cache_misses")
        self._maybe_dump_program(program, fetch_names, feeds)
        replaced = None
        if not blockers:
            shape_key = (desc.uid, desc.version, feed_sig, sig_fetches, shape_sig,
                         id(scope)) + rest
            replaced = self._by_shape.get(shape_key)
            # dropped before the capture, so the old graph's memory is free for it
            self._cache.pop(replaced, None)
            self._by_shape[shape_key] = key

        VLOG(1, "building the cache entry of block 0: %d ops, %d feeds, %d state vars, "
                "%d fetches (cache size %d)", len(desc.block(0).ops), len(feeds),
             len(state_in), len(fetch_names), len(self._cache))
        t_span = TIMELINE.now_us() if TIMELINE.enabled else None
        t0 = time.perf_counter()
        reasons = blockers if blockers or on_card else ["the CPU runs the block op by op"]
        entry = _CacheEntry(program, feeds, state_in, state_out, fetch_names, reasons,
                            eligible=not blockers)
        entry.donate = donate
        entry.watch(self.sentinels)
        program_fp = desc.fingerprint()
        entry.fingerprint = executable_fingerprint(
            program_fp, feed_sig, shape_sig, list(sig_fetches), *rest[:3],
            (torch.cuda.get_device_name(self.device) if on_card else "cpu")
            + ("" if self.mesh is None else f"|mesh={self._mesh_desc()}|layout={self._layout_fp}"),
            dict(_matmul_flags()))
        warm = None
        if on_card and not blockers:
            warm = self._capture(entry, feeds, state, gen)
            self._m_captures.inc()
        entry.compile_s = time.perf_counter() - t0
        self._cache[key] = entry
        self._m_compiles.inc()
        self._m_fresh.inc()
        COUNTERS.inc("compiles")
        self._record_capture(entry, program, program_fp, feed_sig, shape_sig, t_span,
                             list(sig_fetches))
        # each warning at most once per program
        if replaced is not None:
            n = self._per_program_replaced.get(desc.uid, 0) + 1
            self._per_program_replaced[desc.uid] = n
            if n == RECOMPILE_WARN_THRESHOLD and on_card:
                warnings.warn(
                    f"this program's graph has been captured again {n} times "
                    f"because a scope variable it reads was rebound to a new "
                    f"tensor (set_var); each capture replaces the last.  "
                    f"Update state in place (copy_) to keep the graph.", stacklevel=4)
            return entry, state, warm
        n = self._per_program_compiles.get(desc.uid, 0) + 1
        self._per_program_compiles[desc.uid] = n
        if n == RECOMPILE_WARN_THRESHOLD:
            warnings.warn(
                f"this program has built {n} distinct cache entries "
                f"(Executor.compile_count={self.compile_count}), usually one per "
                f"feed shape; on the card each is a CUDA graph with memory of "
                f"its own.  Bucket the batch and sequence shapes.", stacklevel=4)
        return entry, state, warm

    def _record_capture(self, entry: _CacheEntry, program: Program, program_fp: str,
                        feed_sig, shape_sig, t_span: Optional[float], sig_fetches: List[str]):
        """One record of a new cache entry in the capture log: the diff of
        its signature against the last entry built for the same program
        (by any executor), what it cost (``kind``: ``capture`` for a CUDA
        graph, ``eager`` for an entry the graph rule left op by op, with
        the rule's reasons as ``eager:<reason>``) and its seconds; plus a
        timeline span while the timeline is enabled."""
        feeds = [[n, [int(d) for d in s], _dtype_name(d)] for n, s, d in feed_sig]
        state = [[sig[0], [int(d) for d in sig[1]], _dtype_name(sig[2])] if len(sig) == 3
                 else [sig[0], None, None] for sig in shape_sig]
        donated = sorted(set(entry.state_in) & set(entry.state_out))
        if entry.donate:
            donated.append("@FEEDS@")
        amp = self._amp_desc(program)
        passes = (self._passes_fp or "")[:12] or None
        kernels = (program._kernel_policy_fp or "")[:12] or None
        cur = {"program_fp": program_fp, "scope": self.telemetry_scope, "feed_sig": feeds,
               "state_sig": state, "fetch_names": sig_fetches,
               "donated": donated, "mesh": self._mesh_desc(), "amp": amp,
               "layout": (self._layout_fp or "")[:12] or None,
               "passes": passes, "kernels": kernels}
        uid = program.desc.uid
        with _LAST_PROGRAM_SIG_LOCK:
            prev = _LAST_PROGRAM_SIG.get(uid)
            _LAST_PROGRAM_SIG[uid] = cur
        kind = "capture" if entry.graph is not None else "eager"
        reasons = diff_signatures(prev, cur) + [f"eager:{r}" for r in entry.reasons]
        COMPILE_LOG.record(
            scope=self.telemetry_scope, program_uid=uid,
            program_version=program.desc.version, program_fp=program_fp[:12],
            fingerprint=entry.fingerprint, kind=kind, reasons=reasons,
            compile_s=round(entry.compile_s, 6), ops=len(entry.block.ops),
            feeds={n: [s, d] for n, s, d in feeds}, fetches=list(entry.fetch_names),
            state_vars=len(state), donated=len(donated), mesh=self._mesh_desc(), amp=amp,
            layout=(self._layout_fp or "")[:12] or None, passes=passes, kernels=kernels, aot=entry.graph is not None,
            cost=None, memory=None)
        if t_span is not None:
            TIMELINE.record_complete(
                "executor::compile", t_span, max(0.0, TIMELINE.now_us() - t_span),
                cat="compile", args={"kind": kind, "reasons": reasons[:6],
                                     "fingerprint": (entry.fingerprint or "")[:12]})

    def _maybe_dump_program(self, program: Program, fetch_names: List[str],
                            feeds: Dict[str, torch.Tensor]):
        """With ``PADDLE_TPU_PROGRAM_DUMP_DIR`` set, write each program the
        executor runs once per version as ``program_<pid>_<uid>_v<version>
        .json`` (the JAX package's dump: the ProgramDesc, the fetch and
        feed names and this first signature's feed shapes), the input of
        ``tools/pass_report.py`` and ``tools/program_lint.py``."""
        out_dir = os.environ.get("PADDLE_TPU_PROGRAM_DUMP_DIR")
        if not out_dir:
            return
        key = (program.desc.uid, program.desc.version)
        if key in _DUMPED_PROGRAMS:
            return
        _DUMPED_PROGRAMS.add(key)
        try:
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, f"program_{os.getpid()}_{key[0]}_v{key[1]}.json")
            with open(path, "w") as f:
                json.dump({"program": program.desc.to_dict(),
                           "fetch_names": list(fetch_names),
                           "feed_names": sorted(feeds),
                           "feed_shapes": {k: [int(d) for d in v.shape]
                                           for k, v in feeds.items()},
                           "mesh": self._mesh_desc(), "fingerprint": program.desc.fingerprint(),
                           "uid": key[0], "version": key[1]}, f)
        except (OSError, TypeError, ValueError) as e:
            VLOG(1, "program dump failed: %s: %s", type(e).__name__, e)

    # ------------------------------------------------------------ the mesh
    def _batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes the batch dim splits over: the layout's (data, fsdp)
        axes when a layout is set, else ``batch_axis`` plus ``fsdp`` when
        present (fsdp is data parallelism with the parameters sharded)."""
        if self.layout is not None:
            return self.layout.batch_axes(self.mesh)
        return tuple(a for a in dict.fromkeys((self.batch_axis, "fsdp")) if a in self.mesh.shape)

    def _feed_spec(self, block: BlockDesc, name: str, ndim: int):
        """The spec a feed lands on under the mesh: the var's ``sharding``
        attr, else dim 0 over the batch axes (a 0-d feed replicated)."""
        vd = block.find_var(name)
        spec = vd.attrs.get("sharding") if vd is not None else None
        if spec is not None:
            return spec
        axes = self._batch_axes()
        if not axes or ndim == 0:
            return None
        return [axes[0] if len(axes) == 1 else tuple(axes)]

    def global_feed_shapes(self, block: BlockDesc, shapes: Dict[str, tuple]) -> Dict[str, tuple]:
        """The global batch's feed shapes from this rank's (``shapes``):
        each dim a feed's spec shards, times its axes' sizes."""
        if self.mesh is None:
            return shapes
        out = {}
        for k, shape in shapes.items():
            shape = list(shape)
            for d, e in enumerate(self._feed_spec(block, k, len(shape)) or ()):
                for a in (e if isinstance(e, (list, tuple)) else (e,)):
                    if a is not None and d < len(shape):
                        shape[d] *= int(self.mesh.shape.get(a, 1))
            out[k] = tuple(shape)
        return out

    def _global_feeds(self, block: BlockDesc, feeds: Dict[str, torch.Tensor]):
        """Each feed (this rank's rows of the global batch: the JAX
        package's multi-process feed, the global batch being the ranks'
        rows concatenated in mesh order) as a DTensor on its spec's
        placements; without a mesh the feeds as they are."""
        if self.mesh is None:
            return feeds
        from torch.distributed.tensor import DTensor
        from ..parallel.layout import as_placements
        dm = self.mesh.device_mesh
        return {k: DTensor.from_local(t, dm, as_placements(self._feed_spec(block, k, t.ndim),
                                                            self.mesh), run_check=False)
                for k, t in feeds.items()}

    def _mesh_desc(self) -> Optional[dict]:
        if self.mesh is None:
            return None
        return {"axes": {str(k): int(v) for k, v in self.mesh.shape.items()},
                "devices": int(self.mesh.size), "backend": self.mesh.backend}

    def _new_generator(self, program: Program) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(program.random_seed or 0)
        return gen

    def _scope_generator(self, program: Program, scope: Scope) -> torch.Generator:
        """The scope's generator, made (seeded from the program) and set if
        it has none."""
        gen = scope.find_var(RNG_STATE_VAR)
        if gen is None:
            gen = self._new_generator(program)
            scope.set_var(RNG_STATE_VAR, gen)
        return gen

    def _lower_block(self, entry: _CacheEntry, env: Dict[str, Any], homes: Dict[str, Any],
                     gen) -> Tuple[LowerCtx, Dict[str, Any]]:
        """Lower block 0 op by op over ``env`` (state and feeds) and write
        the state it updates into ``homes`` in place (``_write_back``).
        Returns the context and the written values that have no home."""
        if entry.frees is None:
            # the sentinel reads its watched names after the last op
            entry.frees = plan_frees(entry.block, set(entry.fetch_names) | set(entry.state_out)
                                     | set(entry.grad_watch) | set(entry.param_watch))
        mesh = self.mesh
        ctx = LowerCtx(entry.block, env, gen, self.device, frees=entry.frees,
                       amp=bool(entry.program.amp), mesh=mesh)
        ctx.sentinel = []
        with torch.no_grad():
            old = shadow_state(env, entry.param_watch) if entry.sentinel_extra else None
            if mesh is None:
                lower_block(ctx, entry.block)
            else:
                from torch.distributed.tensor.experimental import implicit_replication
                # a tensor an op makes (a constant, a draw) meets the
                # DTensors as the same value on every rank
                with implicit_replication():
                    lower_block(ctx, entry.block)
            for n in entry.fetch_names:
                # a fetched tensor array is its elements stacked
                if isinstance(ctx.env.get(n), TensorArrayVal):
                    ctx.env[n] = torch.stack(list(ctx.env[n]))
            rest = _write_back(entry.state_out, homes, ctx.env)
            if mesh is not None:
                # a fetch is the global value (inside the graph on the card)
                for n in entry.fetch_names:
                    if is_dtensor(ctx.env.get(n)):
                        ctx.env[n] = ctx.env[n].full_tensor()
            if entry.sentinel_extra:
                ctx.sentinel = sentinel_extras(
                    ctx.env, old, [ctx.read(n) for n in entry.fetch_names],
                    entry.sentinel_watch, entry.grad_watch, entry.param_watch, self.device)
        return ctx, rest

    def _lower(self, entry: _CacheEntry, feeds: Dict[str, torch.Tensor], state: list,
               scope: Scope, commit: bool = True) -> List[torch.Tensor]:
        """Lower the block op by op, updating the scope's state in place;
        state the block initializes (or writes in another shape or dtype)
        is bound in the scope, into a tensor it already holds where it
        can.  Returns the fetched tensors, clones where a fetch names state
        (the next step overwrites the state's tensor).  ``commit=False``
        writes nothing: the block runs on clones of the state it writes,
        random ops draw from a copy of the scope's generator (or one of
        their own), and initialized state is dropped."""
        env: Dict[str, Any] = dict(zip(entry.state_in, state))
        if commit:
            homes = {n: env[n] if n in env else scope.find_var(n) for n in entry.state_out}
        else:
            env = homes = _private(entry, env)
        cuda = self.device.type == "cuda"
        for k, t in feeds.items():
            env[k] = t.to(self.device, non_blocking=cuda)
        if self.mesh is not None:
            env.update(self._global_feeds(entry.block, {k: env[k] for k in feeds}))
        if entry.donate and commit:
            # the environment holds the only reference: each feed goes
            # after its last reader (``plan_frees``)
            feeds.clear()
        if commit:
            gen = self._scope_generator(entry.program, scope)
        else:
            gen = scope.find_var(RNG_STATE_VAR)
            gen = self._new_generator(entry.program) if gen is None else _copy_generator(gen)
        ctx, rest = self._lower_block(entry, env, homes, gen)
        if commit:
            for n, v in rest.items():
                scope.update_var(n, v)
        return _fetches(entry, ctx)

    def _capture(self, entry: _CacheEntry, feeds: Dict[str, torch.Tensor],
                 state: list, gen) -> Optional[List[torch.Tensor]]:
        """Capture block 0's whole lowering, with its in-place write-back,
        as one CUDA graph into ``entry``, reading static feed buffers that
        hold this run's feeds.  The block first runs once eagerly on a side
        stream (that builds the kernel library, sets the kernels'
        attributes and creates cuBLAS's handles and workspaces) on clones
        of the state it writes and a copy of ``gen``, so neither that run
        nor the capture, which launches nothing, changes the scope or the
        generator.  Returns that run's fetches where the block writes no
        state and draws nothing, else None: the step asked for is then the
        first replay.
        ``gen`` (the scope's generator, where the block draws) is
        registered with the graph, so each replay draws anew and advances
        it as an eager run does.  The kernel launch counters the capture
        moved are set back and recorded in ``entry.launches`` for each
        replay to add.  A capture that fails raises."""
        from ..ops.cuda.build import launch_counters
        dev = self.device
        homes = dict(zip(entry.state_in, state))
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            static = {k: torch.empty(t.shape, dtype=t.dtype, device=dev)
                      for k, t in feeds.items()}
            for k, t in feeds.items():
                static[k].copy_(t, non_blocking=True)
            if self._side_stream is None:
                # one side stream an executor: cuBLAS keeps a workspace for
                # each stream it has run on
                self._side_stream = torch.cuda.Stream(dev)
            side = self._side_stream
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                private = _private(entry, homes)
                ctx, _ = self._lower_block(entry, {**private, **self._global_feeds(entry.block,
                                                                                 static)},
                                           private, None if gen is None else _copy_generator(gen))
                # a block that writes state or draws (the generator is state
                # too) takes its step in the first replay
                warm = None if entry.state_out or gen is not None else _fetches(entry, ctx)
                del ctx, private
            cur.wait_stream(side)
            for t in warm or ():
                t.record_stream(cur)

            counters = launch_counters()
            before = [getattr(w, a) for w, a in counters]
            gens = [torch.cuda.default_generators[dev.index]] + ([gen] if gen is not None else [])
            saved = [g.clone_state() for g in gens]
            graph = torch.cuda.CUDAGraph()
            if gen is not None:
                graph.register_generator_state(gen)
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    ctx, rest = self._lower_block(
                        entry, {**homes, **self._global_feeds(entry.block, static)}, homes, gen)
                    if rest:
                        raise RuntimeError(f"the block writes state in another shape or dtype "
                                           f"than the scope's: {sorted(rest)}")
            except Exception as e:
                # a capture that fails to end leaves torch's capture stream
                # current and the generators in capture mode
                torch.cuda.set_stream(cur)
                for g, st in zip(gens, saved):
                    g.graphsafe_set_state(st)
                raise RuntimeError(
                    f"capturing block 0 of program {entry.program.desc.uid} as a CUDA "
                    f"graph failed: {e}") from e
            finally:
                moved = [getattr(w, a) - b for (w, a), b in zip(counters, before)]
                for (w, a), n in zip(counters, moved):
                    setattr(w, a, getattr(w, a) - n)
        entry.graph, entry.static_feeds, entry.state = graph, static, list(state)
        entry.generator = gen
        entry.outputs = [ctx.read(n) for n in entry.fetch_names] + ctx.sentinel
        entry.launches = {c: n for c, n in zip(counters, moved) if n}
        return warm

    def _replay(self, entry: _CacheEntry, feeds: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """Copy the feeds into the entry's static buffers and replay its
        graph on the current stream; returns the graph's own output
        tensors, which the next replay overwrites."""
        with torch.cuda.device(self.device):
            for k, t in feeds.items():
                entry.static_feeds[k].copy_(t, non_blocking=True)
            entry.graph.replay()
        for (w, a), n in entry.launches.items():
            setattr(w, a, getattr(w, a) + n)
        return entry.outputs
