"""Training health flight recorder: sentinels inside the step, first-bad-op
localization, and structured per-step health records (the JAX package's
``health`` module, ported).

1. **Sentinels inside the step** (:func:`sentinel_extras`, computed by
   ``Executor(sentinels=...)``): a packed finite-check bitmask over the
   watched values (fetches, then the gradient and parameter groups) plus
   loss, gradient norm, parameter norm and update norm, appended to the
   block's outputs.  On the card they are part of the step's CUDA graph,
   so every replay writes them; the executor copies the five values to
   pinned host memory behind the step (``FetchHandle``\\ s) and hands them
   to the attached :class:`HealthMonitor`, which resolves them once their
   copies have landed (``handle.ready()``): pipelined training pays no
   extra sync.  The groups' sums of squares are multi-tensor passes
   (``torch._foreach_norm``: one pass a tensor), and the update norm reads
   a copy of each watched state tensor taken at the head of the block
   (:func:`shadow_state`: one ``torch._foreach_copy_`` a dtype), since the
   port's updates write the scope's tensors in place.
2. **First-bad-op localization on a trip**
   (:func:`localize_first_bad_op`): the tripping step's feed replayed
   through prefix slices of the program (``core/prune.live_op_slice``),
   op by op (``core/lower.LowerCtx`` / ``lower_op``) on clones of the
   state the slice writes, binary-searching to the first op with a
   non-finite output, named by its ``callsite`` attr.
3. **Per-step health records and divergence events**
   (:class:`DivergenceDetector`): loss-spike z-score and grad-norm
   explosion against a sliding window, written with every step record to
   ``health_<pid>.jsonl`` (``StepTelemetry(prefix="health")``) with the JAX
   package's keys, which ``tools/health_report.py`` reads.

``Trainer(health=True)`` wires all of it; ``Executor(sentinels=...)`` and
an attached :class:`HealthMonitor` are the low-level path.  A monitor
with ``localize=True`` keeps a device clone of each parked step's feed
(at most ``max_pending``), since the graph's feed buffers are overwritten
by the next replay and a donated batch is emptied.

Under a mesh (``Executor(mesh=, sentinels=)``) the norms are the global
ones and the bitmask is OR-ed across the ranks (one all-reduce inside the
step), and a trip's localization on a mesh that spans processes is
skipped, as the JAX package skips it; every record carries ``rank``, so
``tools/health_report.py`` merges the ranks' streams.
"""
from __future__ import annotations

import collections
import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .log import VLOG
from .telemetry import REGISTRY, StepTelemetry

__all__ = [
    "HEALTH_SCOPE", "HEALTH_RECORDS", "HealthConfig", "HealthMonitor",
    "DivergenceDetector", "sentinel_extras", "shadow_state", "localize_first_bad_op",
    "SENTINEL_CLASSES", "decode_sentinel_mask",
]

HEALTH_SCOPE = "health"

# watched-value groups a sentinel can cover (Executor(sentinels=...))
SENTINEL_CLASSES = ("fetches", "grads", "params")

# bound on watched fetch names per cache entry: the mask stays a few words
MAX_WATCH = 512

# every health record (step and event) goes through one process-wide
# stream, so several monitors never write interleaved half-streams
HEALTH_RECORDS = StepTelemetry(capacity=4096, prefix="health")


class HealthConfig:
    """Knobs for :class:`HealthMonitor` / ``Trainer(health=...)``.

    * ``sentinels`` -- watched-value groups computed in the step (a subset
      of :data:`SENTINEL_CLASSES`; the default watches all).
    * ``window`` / ``min_steps`` -- the divergence detector's sliding
      window and the records it needs before it judges.
    * ``loss_spike_z`` -- z-score of the loss against the window at which
      a ``loss-spike`` event fires.
    * ``grad_explosion_factor`` -- multiple of the window's median grad
      norm at which a ``grad-explosion`` event fires.
    * ``localize`` -- on a sentinel trip, replay prefix slices to name the
      first bad op (the executor then keeps a clone of each parked step's
      feed).
    * ``max_pending`` -- unresolved sentinel values parked before the
      oldest is resolved by force (bounds the feeds and pinned values the
      monitor holds).
    """

    def __init__(self, sentinels: Sequence[str] = SENTINEL_CLASSES,
                 window: int = 32, min_steps: int = 8,
                 loss_spike_z: float = 6.0,
                 grad_explosion_factor: float = 10.0,
                 localize: bool = True, max_pending: int = 8):
        self.sentinels = sentinel_classes(sentinels)
        self.window = max(2, int(window))
        self.min_steps = max(2, int(min_steps))
        self.loss_spike_z = float(loss_spike_z)
        self.grad_explosion_factor = float(grad_explosion_factor)
        self.localize = bool(localize)
        self.max_pending = max(1, int(max_pending))


# --------------------------------------------------------------- sentinels

def sentinel_classes(sentinels) -> Tuple[str, ...]:
    """``sentinels`` as a tuple of :data:`SENTINEL_CLASSES` (True for all,
    None or empty for none); an unknown class raises ``ValueError``."""
    if sentinels is True:
        sentinels = SENTINEL_CLASSES
    sentinels = tuple(sentinels or ())
    bad = [s for s in sentinels if s not in SENTINEL_CLASSES]
    if bad:
        raise ValueError(f"unknown sentinel class(es) {bad}; pick from {SENTINEL_CLASSES}")
    return sentinels


# pseudo-names of the group bits in a sentinel's watch tuple: the gradient
# and parameter groups are checked through their norm reductions (one pass
# a tensor, shared with the health scalars), so a group trips as a whole;
# the localization replay names the var and the op
GRADS_GROUP = "@GRADS@"
PARAMS_GROUP = "@PARAMS@"


def _is_float(v) -> bool:
    import torch
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _nonfinite(v) -> bool:
    """A floating tensor holding a NaN or an Inf (a sync on the card)."""
    import torch
    return _is_float(v) and not bool(torch.isfinite(v).all())


def shadow_state(env: Dict[str, Any], names: Sequence[str]) -> Dict[str, Any]:
    """Copies of the floating tensors ``env`` holds under ``names``: one
    buffer a dtype and one ``torch._foreach_copy_`` into its views.  Taken
    at the head of the block, before any op writes them in place; inside a
    CUDA graph's capture the buffers live in the graph's pool and each
    replay refills them."""
    import torch
    by_dtype: Dict[Any, List[str]] = {}
    for n in names:
        v = env.get(n)
        if _is_float(v):
            by_dtype.setdefault(v.dtype, []).append(n)
    out: Dict[str, Any] = {}
    for dtype, group in by_dtype.items():
        # a DTensor's copy is of this rank's shard
        from .core.lower import local_of
        srcs = [local_of(env[n]) for n in group]
        flat = torch.empty(sum(t.numel() for t in srcs), dtype=dtype, device=srcs[0].device)
        views, off = [], 0
        for t in srcs:
            views.append(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        torch._foreach_copy_(views, srcs)
        out.update(zip(group, views))
    return out


def _rank_share(v):
    """What this rank adds to a sum over a mesh of the value ``v``: a
    DTensor's local shard where this rank is the lowest that holds it
    (a partial sum reduced first), else None; any other value whole."""
    from .core.lower import is_dtensor
    if not is_dtensor(v):
        return v
    from torch.distributed.tensor import Partial, Replicate
    from .parallel.layout import first_replica
    if any(isinstance(p, Partial) for p in v.placements):
        v = v.redistribute(v.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                           for p in v.placements])
    return v.to_local() if first_replica(v.placements, v.device_mesh) else None


def sentinel_extras(env: Dict[str, Any], old_state: Dict[str, Any],
                    fetch_vals: Sequence[Any], watch: Sequence[str],
                    grad_names: Sequence[str], param_names: Sequence[str],
                    device=None, mesh=None) -> List[Any]:
    """The sentinel's five tensors, computed after the block's ops (inside
    the step's CUDA graph on the card).  ``old_state`` holds each watched
    state tensor's value before the step (:func:`shadow_state`); it is
    consumed (overwritten with the update).

    Every watched fetch gets an exact ``isfinite`` bit; the gradient and
    parameter groups are checked through the same sum of squares that
    gives their norms (a NaN or Inf anywhere makes the group sum
    non-finite), taken as multi-tensor norms.

    Returns ``[mask_words, loss, grad_norm, param_norm, update_norm]``:
    ``mask_words`` int64 [ceil(n/32)] holding the uint32 words (torch has
    no uint32 arithmetic), bit ``i`` for ``watch[i]`` (fetch names, then
    the :data:`GRADS_GROUP` / :data:`PARAMS_GROUP` pseudo-entries); the
    rest float32 scalars, a norm NaN when its group is empty (an empty
    group reads as healthy).

    Under a ``mesh`` the values are DTensors: each rank sums the squares
    of the shards it is the lowest holder of, and one all-reduce over the
    mesh (inside the step's graph on NCCL) totals the three groups' sums
    and every watched value's non-finite flag, so the norms are the global
    ones and the bitmask is OR-ed across the ranks."""
    import torch
    from .core.lower import local_of

    def _sq_sum(tensors):
        """Sum of squares over ``tensors`` in float32."""
        norms = torch._foreach_norm([t if t.dtype == torch.float32 else t.float()
                                     for t in tensors], 2)
        return torch.stack(norms).square().sum()

    def _shares(names):
        # each float value's share of a sum over the mesh, by name
        return {n: _rank_share(env[n]) for n in names if _is_float(env.get(n))}

    def _total(shares):
        # None for a group empty on every rank (the same names on each),
        # zero where this rank is the lowest holder of none of it
        if not shares:
            return None
        mine = [t for t in shares.values() if t is not None]
        return _sq_sum(mine) if mine else torch.zeros((), dtype=torch.float32, device=device)

    grad_sq = _total(_shares(grad_names))
    param_shares = _shares(param_names)
    param_sq = _total(param_shares)
    params = {n: t for n, t in param_shares.items() if n in old_state}
    update_sq = None
    if params:
        # the update's shares: the held params' old values less their new
        deltas = {n: old_state[n] for n, t in params.items() if t is not None}
        if deltas:
            torch._foreach_sub_(list(deltas.values()), [local_of(env[n]) for n in deltas])
        update_sq = _total({n: deltas.get(n) for n in params})

    def _nan():
        return torch.full((), float("nan"), dtype=torch.float32, device=device)

    def _norm(tot):
        return torch.sqrt(tot) if tot is not None else _nan()

    def _ok(tot):
        return torch.ones((), dtype=torch.bool, device=device) if tot is None \
            else torch.isfinite(tot)

    flags = []
    for n in watch:
        if n == GRADS_GROUP:
            flags.append(_ok(grad_sq))
        elif n == PARAMS_GROUP:
            flags.append(torch.logical_and(_ok(param_sq), _ok(update_sq)))
        else:
            v = local_of(env.get(n))
            flags.append(torch.isfinite(v).all() if _is_float(v) else _ok(None))
    if mesh is not None:
        grad_sq, param_sq, update_sq, flags = _mesh_totals(mesh, grad_sq, param_sq,
                                                           update_sq, flags, device)
    nwords = max(1, (len(flags) + 31) // 32)
    bad = torch.zeros(nwords * 32, dtype=torch.int64, device=device)
    if flags:
        bad[:len(flags)] = torch.logical_not(torch.stack(flags)).to(torch.int64)
    weights = torch.bitwise_left_shift(torch.ones(32, dtype=torch.int64, device=device),
                                       torch.arange(32, dtype=torch.int64, device=device))
    mask = (bad.view(nwords, 32) * weights).sum(dim=1)

    loss = _nan()
    if fetch_vals and _is_float(fetch_vals[0]):
        loss = fetch_vals[0].float().mean()
    return [mask, loss, _norm(grad_sq), _norm(param_sq), _norm(update_sq)]


def _mesh_totals(mesh, grad_sq, param_sq, update_sq, flags, device):
    """The three squared sums totalled and the flags AND-ed over every rank
    of ``mesh``: one float32 vector all-reduced (summed) over each mesh
    dim's group in turn (a NaN or Inf in any rank's sum stays one; a flag
    is carried as its failure count)."""
    import torch
    from .parallel.layout import all_reduce_over, mesh_groups
    sums = [grad_sq, param_sq, update_sq]
    vec = torch.stack([t if t is not None else torch.zeros((), dtype=torch.float32,
                                                           device=device) for t in sums]
                      + [torch.logical_not(f).to(torch.float32) for f in flags])
    all_reduce_over(vec, mesh_groups(mesh))
    sums = [vec[j] if t is not None else None for j, t in enumerate(sums)]
    return sums[0], sums[1], sums[2], [vec[3 + j] == 0 for j in range(len(flags))]


def decode_sentinel_mask(mask_words, watch: Sequence[str]) -> List[str]:
    """Names of the watched values whose finite-check bit tripped."""
    import numpy as np
    words = np.asarray(mask_words).reshape(-1).astype(np.uint32)
    bad = []
    for i, name in enumerate(watch):
        if int(words[i // 32]) >> (i % 32) & 1:
            bad.append(name)
    return bad


# ------------------------------------------------------------ localization

def localize_first_bad_op(program, feed: Dict[str, Any], scope=None,
                          rng_seed: Optional[int] = None,
                          device=None) -> Optional[dict]:
    """Replay ``feed`` through prefix slices of ``program`` and name the
    FIRST op whose outputs hold non-finite values.

    Each probe takes the backward slice (``core/prune.live_op_slice``) to
    the outputs of the ops in a prefix and lowers it op by op; a binary
    search over the prefix length finds the shortest prefix whose
    frontier is non-finite.  State comes from ``scope`` (the values at
    resolution time), and the state a probe writes is cloned first, so a
    probe changes nothing the scope holds; randomness comes from a fresh
    generator seeded with ``rng_seed`` (default the program's seed), so a
    trip that depends on dropout's draws may not reproduce.  ``feed``
    values (arrays or tensors) are coerced as ``Executor.run`` coerces
    them, onto ``device`` (default: where the feed's tensors, else the
    scope's, are; else ``CUDAPlace(0)``, which raises without a card).  A
    value leaves the probe's environment after the slice's last reader of
    it; each op's outputs are checked as they are written (the last write
    of a name decides), which names the same var set as a check at the
    end.

    Returns ``None`` when the replay is clean, else a dict with
    ``op_index`` / ``op_type`` / ``callsite`` / ``bad_outputs`` /
    ``probes`` / ``ops_replayed``."""
    import torch

    from .core.executor import CUDAPlace, Executor, place_device
    from .core.lower import _SKIP_OPS, SEQ_LEN_SUFFIX, LowerCtx, lower_op
    from .core.prune import live_op_slice
    from .core.scope import global_scope

    scope = scope or global_scope()
    block = program.desc.block(0)
    sem = [i for i, op in enumerate(block.ops) if op.type not in _SKIP_OPS]
    if not sem:
        return None

    base_env: Dict[str, Any] = {}
    for op in block.ops:
        for n in op.input_names():
            if not n or n in feed or n in base_env:
                continue
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor):
                base_env[n] = v
    if device is None:
        device = next((v.device for v in list(feed.values()) + list(base_env.values())
                       if isinstance(v, torch.Tensor)), None) or place_device(CUDAPlace(0))
    device = torch.device(device)
    for k, v in feed.items():
        t, dtype = Executor._feed_host(block, k, v)
        base_env[k] = t.to(device=device, dtype=dtype)
    if rng_seed is None:
        rng_seed = program.random_seed or 0
    probes = 0

    def probe(k: int) -> List[str]:
        """Non-finite var names among the outputs of sem ops[0..k]."""
        nonlocal probes
        probes += 1
        targets = [n for i in sem[:k + 1] for n in block.ops[i].output_names() if n]
        keep_idx, _ = live_op_slice(block, targets)
        run = [i for i in keep_idx if block.ops[i].type not in _SKIP_OPS]
        written = {n for i in run for n in block.ops[i].output_names() if n}
        env = {n: (v.clone() if n in written else v) for n, v in base_env.items()}
        last: Dict[str, int] = {}
        for pos, i in enumerate(run):
            for n in block.ops[i].input_names() + block.ops[i].output_names():
                if n:
                    last[n] = pos
        target_set = set(targets)
        bad: Dict[str, bool] = {}
        gen = torch.Generator(device=device)
        gen.manual_seed(rng_seed)
        ctx = LowerCtx(block, env, gen, device, amp=bool(program.amp))
        with torch.no_grad():
            for pos, i in enumerate(run):
                op = block.ops[i]
                lower_op(ctx, op, index=i)
                for n in op.output_names():
                    if n in target_set and n in env:
                        bad[n] = _nonfinite(env[n])
                for n in op.input_names() + op.output_names():
                    if n and last.get(n) == pos and not n.endswith(SEQ_LEN_SUFFIX):
                        env.pop(n, None)
        return [n for n in targets if bad.get(n)]

    if not probe(len(sem) - 1):
        return None            # the full replay is clean: a nondeterministic source
    lo, hi = 0, len(sem) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if probe(mid):
            hi = mid
        else:
            lo = mid + 1
    op = block.ops[sem[lo]]
    bad_here = probe(lo)
    own = [n for n in op.output_names() if n and n in bad_here]
    return {
        "op_index": sem[lo], "op_type": op.type,
        "callsite": op.callsite,
        "bad_outputs": own or bad_here[:4],
        "probes": probes, "ops_replayed": len(sem),
    }


# ------------------------------------------------------------- divergence

class DivergenceDetector:
    """Sliding-window divergence detector over the per-step health
    scalars (pure stdlib).

    ``observe(loss, grad_norm)`` returns zero or more event dicts:
    ``loss-spike`` when the loss's z-score against the window exceeds the
    threshold, ``grad-explosion`` when the grad norm exceeds ``factor`` x
    the window median.  Non-finite inputs never enter the window (a NaN
    would poison every later mean): the sentinel mask, not the detector,
    reports non-finite values."""

    def __init__(self, window: int = 32, min_steps: int = 8,
                 loss_spike_z: float = 6.0,
                 grad_explosion_factor: float = 10.0):
        self.min_steps = max(2, int(min_steps))
        self.loss_spike_z = float(loss_spike_z)
        self.grad_explosion_factor = float(grad_explosion_factor)
        self._losses: "collections.deque[float]" = collections.deque(maxlen=max(2, int(window)))
        self._gnorms: "collections.deque[float]" = collections.deque(maxlen=max(2, int(window)))

    def observe(self, loss: Optional[float] = None,
                grad_norm: Optional[float] = None) -> List[dict]:
        events: List[dict] = []
        if loss is not None and math.isfinite(loss):
            if len(self._losses) >= self.min_steps:
                mean = sum(self._losses) / len(self._losses)
                var = sum((x - mean) ** 2 for x in self._losses) / len(self._losses)
                std = math.sqrt(var)
                if std > 0.0:
                    z = (loss - mean) / std
                    if z >= self.loss_spike_z:
                        events.append({
                            "event": "loss-spike",
                            "loss": round(loss, 6), "z": round(z, 2),
                            "window_mean": round(mean, 6),
                            "window_std": round(std, 6)})
            self._losses.append(loss)
        if grad_norm is not None and math.isfinite(grad_norm):
            if len(self._gnorms) >= self.min_steps:
                med = sorted(self._gnorms)[len(self._gnorms) // 2]
                if med > 0.0 and grad_norm >= self.grad_explosion_factor * med:
                    events.append({
                        "event": "grad-explosion",
                        "grad_norm": round(grad_norm, 6),
                        "window_median": round(med, 6),
                        "factor": round(grad_norm / med, 2)})
            self._gnorms.append(grad_norm)
        return events


# ---------------------------------------------------- fetch-timeout hook

_TIMEOUT_HOOK_LOCK = threading.Lock()
_timeout_hook_installed = False


def _record_fetch_timeout(label: Optional[str] = None,
                          timeout: Optional[float] = None, trace=None):
    REGISTRY.counter("fetch_timeouts", scope=HEALTH_SCOPE).inc()
    HEALTH_RECORDS.record(kind="event", event="fetch-timeout",
                          label=label, timeout_s=timeout,
                          # the wedged handle's own trace (captured where it
                          # was made), not the waiter's
                          **(trace.fields() if trace is not None else {}))


def _install_fetch_timeout_hook():
    """Route every :class:`~paddle_tpu_torch.core.staging.FetchTimeoutError`
    (training handles and serving requests alike) into the health stream
    as a ``fetch-timeout`` event.  Installed once, the first time a
    monitor attaches."""
    global _timeout_hook_installed
    with _TIMEOUT_HOOK_LOCK:
        if _timeout_hook_installed:
            return
        from .core import staging
        staging.add_fetch_timeout_hook(_record_fetch_timeout)
        _timeout_hook_installed = True


# ---------------------------------------------------------------- monitor

class _Pending:
    __slots__ = ("step", "program", "compiled", "values", "feed", "scope", "multiproc")

    def __init__(self, step, program, compiled, values, feed, scope, multiproc=False):
        self.step = step
        self.program = program
        self.compiled = compiled
        self.values = values
        self.feed = feed
        self.scope = scope
        # the step ran on a mesh that spans processes: its shards cannot be
        # replayed here
        self.multiproc = multiproc


class HealthMonitor:
    """Resolves the sentinel values off the critical path and turns them
    into health records and events.

    ``attach(executor)`` hooks the monitor into an
    ``Executor(sentinels=...)``: each ``run()`` hands over the step's five
    sentinel values as ``FetchHandle``\\ s whose copies to pinned memory are
    enqueued behind the step, without waiting; ``poll()`` (the Trainer
    calls it once a step) resolves the ones whose copies have landed, and
    ``flush()`` resolves the rest.  A resolution writes one ``kind="step"``
    record (loss, grad norm, param norm, update ratio, ok), feeds the
    :class:`DivergenceDetector`, and on a tripped bit runs
    :func:`localize_first_bad_op` and writes a ``kind="event",
    event="non-finite"`` record naming the first bad op and its callsite."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self.records = HEALTH_RECORDS
        self.detector = DivergenceDetector(
            window=self.config.window, min_steps=self.config.min_steps,
            loss_spike_z=self.config.loss_spike_z,
            grad_explosion_factor=self.config.grad_explosion_factor)
        self._pending: "collections.deque[_Pending]" = collections.deque()
        self._lock = threading.Lock()
        # observers of health events (divergence, non-finite): the
        # Trainer's rollback-on-divergence registers one; a hook's failure
        # is logged and swallowed
        self._event_hooks: List = []
        self._m_steps = REGISTRY.counter("steps_recorded", scope=HEALTH_SCOPE)
        self._m_trips = REGISTRY.counter("sentinel_trips", scope=HEALTH_SCOPE)
        self._m_events = REGISTRY.counter("divergence_events", scope=HEALTH_SCOPE)
        self._m_localized = REGISTRY.counter("localizations", scope=HEALTH_SCOPE)

    # -- wiring ------------------------------------------------------------
    def attach(self, executor) -> "HealthMonitor":
        """Receive sentinel values from ``executor`` (built with
        ``sentinels=...``), have it keep each step's feed when
        ``localize`` is on, and install the process-wide fetch-timeout
        hook."""
        executor._health_hook = self.on_step
        executor._health_keep_feed = self.config.localize
        _install_fetch_timeout_hook()
        return self

    def add_event_hook(self, hook) -> "HealthMonitor":
        """Call ``hook(record)`` with every health EVENT this monitor emits
        (``loss-spike`` / ``grad-explosion`` / ``non-finite``).  Idempotent
        per hook object; failures are swallowed."""
        if hook not in self._event_hooks:
            self._event_hooks.append(hook)
        return self

    def _emit_event(self, record: dict):
        for hook in list(self._event_hooks):
            try:
                hook(record)
            except Exception as e:  # noqa: BLE001 -- observability only
                VLOG(1, "health event hook failed: %s: %s", type(e).__name__, e)

    # -- executor side -----------------------------------------------------
    def on_step(self, *, step, program, compiled, values, feed=None, scope=None,
                multiproc=False):
        """Park one step's sentinel values (non-blocking).  Past
        ``max_pending`` parked the oldest is resolved by force: the card
        is that far ahead anyway."""
        entry = _Pending(step, program, compiled, values, feed, scope, multiproc)
        force = None
        with self._lock:
            self._pending.append(entry)
            if len(self._pending) > self.config.max_pending:
                force = self._pending.popleft()
        if force is not None:
            self._resolve(force)

    # -- resolution --------------------------------------------------------
    @staticmethod
    def _ready(entry: _Pending) -> bool:
        return entry.values[0].ready()

    def poll(self, block: bool = False) -> int:
        """Resolve parked sentinel values that are ready (``block=True``
        resolves all of them).  Returns the number resolved."""
        done = 0
        while True:
            with self._lock:
                if not self._pending:
                    return done
                if not block and not self._ready(self._pending[0]):
                    return done
                entry = self._pending.popleft()
            self._resolve(entry)
            done += 1

    def flush(self) -> int:
        """Resolve every parked sentinel (end of training)."""
        return self.poll(block=True)

    def _scalar(self, v) -> Optional[float]:
        return None if math.isnan(v) else v

    def _resolve(self, entry: _Pending):
        try:
            import numpy as np
            mask = np.asarray(entry.values[0])
            raw = [float(np.asarray(v)) for v in entry.values[1:5]]
        except Exception as e:  # noqa: BLE001 -- health never kills a run
            VLOG(1, "health: sentinel resolve failed: %s", e)
            return
        loss, grad_norm, param_norm, update_norm = raw
        bad = [{GRADS_GROUP: "grads", PARAMS_GROUP: "params"}.get(n, n)
               for n in decode_sentinel_mask(mask, entry.compiled.sentinel_watch)]
        update_ratio = None
        if math.isfinite(update_norm) and param_norm and math.isfinite(param_norm):
            update_ratio = update_norm / param_norm
        self._m_steps.inc()
        self.records.record(
            kind="step", step=entry.step, ok=not bad,
            loss=self._scalar(loss),
            grad_norm=self._scalar(grad_norm),
            param_norm=self._scalar(param_norm),
            update_ratio=round(update_ratio, 8) if update_ratio is not None else None)
        for ev in self.detector.observe(loss=loss, grad_norm=grad_norm):
            self._m_events.inc()
            rec = self.records.record(kind="event", step=entry.step, **ev)
            self._emit_event(rec)
        if bad:
            self._on_trip(entry, bad)

    def _on_trip(self, entry: _Pending, bad: List[str]):
        self._m_trips.inc()
        localization = None
        if not self.config.localize:
            pass
        elif entry.multiproc:
            localization = {
                "skipped": "multi-process mesh (replay needs host copies of non-addressable "
                           "shards); reproduce on a single process to localize"}
        elif entry.feed is None:
            localization = {"skipped": "no feed snapshot retained"}
        else:
            try:
                localization = localize_first_bad_op(entry.program, dict(entry.feed),
                                                     scope=entry.scope)
                if localization is not None:
                    self._m_localized.inc()
            except Exception as e:  # noqa: BLE001
                localization = {"error": f"{type(e).__name__}: {e}"}
        rec = self.records.record(kind="event", event="non-finite",
                                  step=entry.step, bad_vars=bad[:16],
                                  n_bad=len(bad), localization=localization)
        self._emit_event(rec)
        VLOG(0, "health: non-finite values at step %s in %s%s", entry.step, bad[:4],
             f" -- first bad op: {localization.get('op_type')} at "
             f"{localization.get('callsite')}"
             if localization and localization.get("op_type") else "")
