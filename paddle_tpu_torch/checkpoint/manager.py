"""Async checkpointing with restore in place (the JAX package's
``checkpoint/manager.py``, ported; its on-disk format, so a checkpoint
either package writes restores in the other).

* **Async saves** (:class:`CheckpointManager.save`): the step pays only
  the snapshot (:func:`snapshot_program_state`): every persistable
  tensor's copy to pinned host memory, enqueued as one wave on the
  current stream with one event after it.  The port's updates write the
  scope's tensors in place, and the next step's replay is enqueued on the
  same stream after those copies, so the snapshot is the state of the
  step before it, never a torn one.  The writer thread waits on the event
  and takes host arrays only: npz writing, fsync and the atomic commit
  happen there.
* **Atomic commit**: the payload goes into ``ckpt_<step>.tmp.<token>/``
  (a name of its own for each save), the manifest last inside it, then
  one ``os.replace`` publishes the directory; a reader never sees a torn
  checkpoint and a killed writer leaves only a ``.tmp`` torso.
  Keep-last-K retention prunes committed checkpoints oldest first.  A
  save that failed on the writer raises at the next ``save`` / ``wait``.
* **Restore in place** (:meth:`CheckpointManager.restore`): each value is
  copied into the tensor the scope already holds (``io``'s rule), so a
  restore, a resume or a rollback keeps every state tensor's address and
  the step's captured CUDA graph replays on; the shapes must match the
  program's (a drift is refused).  The scope's ``torch.Generator`` is
  saved and restored under its own ``impl`` (``torch-<device type>``),
  in place, so a graph that registered it draws from the restored state;
  a JAX threefry key is skipped with a VLOG, as the JAX package skips
  this one.  ``memory_budget`` gates a restore through the static memory
  planner (``analysis.memory``).
* **Telemetry**: a ``"checkpoint"`` scope (saves, restores, rollbacks,
  bytes; ``save_s`` / ``snapshot_s`` / ``restore_s`` histograms),
  ``checkpoint_<pid>.jsonl`` records and ``ckpt::*`` timeline spans.

* **Multi-rank saves** (state on DTensors across processes): every rank
  writes its own ``shard_r<k>.npz`` (its local shards with their global
  index; a replicated chunk only by the lowest rank that holds it), to a
  temporary name and then renamed; the ranks' chunk maps are gathered
  through the clique on the training thread (``all_gather_object``, in
  the synchronous half: the writer thread runs no collective), with
  each rank's pending writer error, so that every rank raises together.
  All ranks write into the save's own tmp directory, which rank 0 names;
  rank 0's writer waits for every rank's file, then writes
  ``program.json`` and the manifest last, naming every rank's file, and
  renames the directory into place: the commit point.
* **Resharded restore** (``restore(mesh=, layout=)``): the chunks are
  reassembled into whole host arrays and each rank keeps its shard of the
  TARGET placement (which need not be the source's), copied into the
  DTensor the scope holds where the placement is unchanged.

``Trainer(checkpoint=CheckpointConfig(...))`` wires periodic saves,
resume from the latest checkpoint, and the health layer's actions
(divergence -> rollback to the last good checkpoint, fetch timeout -> save
and stop).
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..log import VLOG
from ..telemetry import REGISTRY, TIMELINE, StepTelemetry, process_rank
from . import manifest as manifest_mod
from .manifest import (CheckpointError, checkpoint_dir, latest_step,
                       list_steps, read_manifest, shard_filename,
                       validate_shards, write_manifest)

__all__ = ["CHECKPOINT_SCOPE", "CKPT_RECORDS", "CheckpointConfig",
           "CheckpointManager", "restore_fit_dir", "snapshot_program_state"]

CHECKPOINT_SCOPE = "checkpoint"

#: every checkpoint record (saves, restores, rollbacks) goes through one
#: process-wide stream -> checkpoint_<pid>.jsonl under the telemetry dir
CKPT_RECORDS = StepTelemetry(capacity=1024, prefix="checkpoint")

# the scope var of the executor's generator (core/executor.py RNG_STATE_VAR)
_RNG_KEY = "@RNG_STATE@"
_RNG_IMPL_PREFIX = "torch-"


def _clique() -> Tuple[int, int]:
    """(this process's rank, the clique's size) of the process group, or
    (0, 1) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _index_meta(sl: Tuple[slice, ...], shape) -> Optional[List[List[int]]]:
    """A shard's slices as the manifest's index (``[[start, stop]]`` a
    dim), or None for the whole array (the JAX package's form)."""
    out = [[int(s.start), int(s.stop)] for s in sl]
    if all(a == 0 and b == int(d) for (a, b), d in zip(out, shape)):
        return None
    return out


def _chunk_map(chunks) -> Tuple[Dict[str, List[dict]], List[str]]:
    """({var: [{"key", "index"}]}, the npz keys in chunk order) of a
    snapshot's chunks: a whole var's key is its name, a shard's
    ``<name>::<k>`` (the k-th chunk of that var in this file)."""
    chunk_map: Dict[str, List[dict]] = {}
    keys: List[str] = []
    for name, index, _ in chunks:
        k = len(chunk_map.get(name, ()))
        key = name if index is None and k == 0 else f"{name}::{k}"
        chunk_map.setdefault(name, []).append({"key": key, "index": index})
        keys.append(key)
    return chunk_map, keys


class CheckpointConfig:
    """Knobs for ``Trainer(checkpoint=...)`` / :class:`CheckpointManager`.

    * ``dir`` -- checkpoint root (``ckpt_<step>`` dirs below it).
    * ``step_interval`` / ``epoch_interval`` -- the save cadence (steps
      within an epoch / epochs; 0 turns that cadence off).
    * ``keep`` -- keep-last-K retention over committed checkpoints.
    * ``async_save`` -- serialize and commit on the writer thread (the step
      pays only the snapshot); False writes inline.
    * ``resume`` -- ``"auto"`` restores the latest committed checkpoint
      when the Trainer is built (epoch and step resume included); ``"off"``
      never loads.
    * ``rollback_on_divergence`` -- on a health event (loss-spike,
      grad-explosion, non-finite sentinel trip), restore the last good
      checkpoint's state and keep training.
    * ``save_on_fetch_timeout`` -- on a fetch-timeout event, save
      synchronously and stop the run.
    * ``memory_budget`` -- the restore's pre-flight budget (bytes, "16GiB"
      or a device profile), checked by the static memory planner.
    * ``include_rng`` -- save and restore the scope's generator.
    """

    def __init__(self, dir: Optional[str] = None, step_interval: int = 0,
                 epoch_interval: int = 1, keep: int = 3,
                 async_save: bool = True, resume: str = "auto",
                 rollback_on_divergence: bool = False,
                 save_on_fetch_timeout: bool = False,
                 memory_budget=None, include_rng: bool = True):
        self.dir = dir or os.path.join(os.getcwd(), "checkpoint")
        self.step_interval = max(0, int(step_interval))
        self.epoch_interval = max(0, int(epoch_interval))
        self.keep = max(1, int(keep))
        self.async_save = bool(async_save)
        if resume not in ("auto", "off"):
            raise ValueError(f"resume must be 'auto' or 'off', got {resume!r}")
        self.resume = resume
        self.rollback_on_divergence = bool(rollback_on_divergence)
        self.save_on_fetch_timeout = bool(save_on_fetch_timeout)
        self.memory_budget = memory_budget
        self.include_rng = bool(include_rng)


# ------------------------------------------------------------- snapshot

class _Snapshot(dict):
    """A snapshot: ``vars``, ``chunks`` and ``rng`` as the JAX package's,
    plus the event its device-to-host copies complete at (None when every
    array is already a host copy) and the pinned buffers its arrays view.
    :meth:`host` waits on the event."""

    event = None
    buffers: Tuple[Any, ...] = ()

    def host(self) -> "_Snapshot":
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self


class _PinnedPool:
    """Pinned host buffers reused across saves, keyed by dtype and size: a
    snapshot takes its buffers here and the writer gives them back once it
    has serialized them, so a save pins new host memory (a slow
    ``cudaHostAlloc`` on the step's thread) only while every buffer it
    could reuse is still in flight."""

    def __init__(self):
        self._free: Dict[Tuple[Any, int], List[Any]] = {}
        self._lock = threading.Lock()

    def take(self, dtype, numel: int):
        import torch
        with self._lock:
            free = self._free.get((dtype, numel))
            if free:
                return free.pop()
        return torch.empty(numel, dtype=dtype, pin_memory=True)

    def give(self, buffers):
        with self._lock:
            for b in buffers:
                self._free.setdefault((b.dtype, b.numel()), []).append(b)


def _host_copies(tensors: Sequence[Any], pool: Optional[_PinnedPool] = None):
    """(host arrays, event, pinned buffers): each tensor's value as a host
    numpy array.  CUDA tensors are copied into one pinned buffer a dtype
    (taken from ``pool`` when given, else new), one ``non_blocking`` copy
    each on the current stream, with one event recorded after the wave;
    the arrays may be read once the event has completed.  CPU tensors are
    copied now."""
    import torch
    out: List[Any] = [None] * len(tensors)
    by_dtype: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        if t.is_cuda:
            by_dtype.setdefault(t.dtype, []).append(i)
        else:
            out[i] = _as_numpy(t.detach().to("cpu", copy=True))
    if not by_dtype:
        return out, None, ()
    device, buffers = None, []
    for dtype, idx in by_dtype.items():
        numel = sum(tensors[i].numel() for i in idx)
        flat = pool.take(dtype, numel) if pool is not None else \
            torch.empty(numel, dtype=dtype, pin_memory=True)
        buffers.append(flat)
        off = 0
        for i in idx:
            t = tensors[i]
            view = flat[off:off + t.numel()].view(t.shape)
            view.copy_(t.detach(), non_blocking=True)
            out[i] = _as_numpy(view)
            off += t.numel()
            device = t.device
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return out, event, tuple(buffers)


def _as_numpy(t):
    """A host tensor as numpy (bf16 as its uint16 view: numpy has no
    bfloat16; the io.py convention)."""
    import numpy as np
    import torch
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def snapshot_program_state(programs: Sequence, scope, include_rng: bool = True,
                           pool: Optional[_PinnedPool] = None) -> Dict[str, Any]:
    """Capture every persistable var of ``programs`` (parameters,
    optimizer slots, accumulation buffers) from ``scope`` as host arrays:
    the synchronous half of a save.

    The copies are enqueued on the current stream before the caller
    enqueues its next step, which then writes the tensors only after they
    are read.  Returns ``{"vars": {name: meta}, "chunks": [(name, index,
    array)], "rng": {"data", "impl"} or None}`` (the JAX package's shape),
    whose ``host()`` waits until the arrays hold their values.  A plain
    tensor is one whole-array chunk (index None); a DTensor is this rank's
    local shard with its global index (``[[start, stop]]`` a dim), kept
    only where this rank is the lowest that holds it, so a replicated or
    partly replicated chunk is written once across the ranks.  Under a
    clique of more than one rank a plain tensor is rank 0's alone.  With a
    ``pool`` the pinned buffers come from it, and go back to it once the
    arrays are no longer read."""
    import numpy as np
    import torch

    from ..core.lower import is_dtensor
    from ..parallel.layout import first_replica, local_index

    rank, world = _clique()
    seen: Dict[str, Tuple[Any, Any]] = {}
    for prog in programs:
        block = prog.desc.block(0)
        for name, vd in block.vars.items():
            if not vd.persistable or name in seen:
                continue
            v = scope.find_var(name)
            if not isinstance(v, torch.Tensor):
                continue
            seen[name] = (vd, v)
    picked: List[Tuple[str, Any, Any]] = []      # (name, index, tensor) to write
    for name, (vd, v) in seen.items():
        if is_dtensor(v):
            if first_replica(v.placements, v.device_mesh):
                sl = local_index(v.placements, v.device_mesh, v.shape)
                picked.append((name, _index_meta(sl, v.shape), v.to_local()))
        elif rank == 0 or world == 1:
            picked.append((name, None, v))
    hosts, event, buffers = _host_copies([t for _, _, t in picked], pool)
    var_meta: Dict[str, dict] = {}
    chunks: List[Tuple[str, Any, Any]] = [(name, index, host) for (name, index, _), host
                                          in zip(picked, hosts)]
    for name, (vd, v) in seen.items():
        var_meta[name] = {
            "shape": [int(d) for d in v.shape],
            "dtype": str(v.dtype).replace("torch.", ""),
            "slot_of": vd.attrs.get("slot_of"),
            "is_parameter": bool(vd.is_parameter),
            "spec": vd.attrs.get("sharding"),
            "role": vd.attrs.get("layout_role"),
        }
    rng = None
    if include_rng:
        gen = scope.find_var(_RNG_KEY)
        if isinstance(gen, torch.Generator):
            rng = {"data": np.array(gen.get_state().numpy(), copy=True),
                   "impl": _RNG_IMPL_PREFIX + gen.device.type}
    snap = _Snapshot(vars=var_meta, chunks=chunks, rng=rng)
    snap.event, snap.buffers = event, buffers
    return snap


def gather_program_state(programs: Sequence, scope) -> Optional[Dict[str, Any]]:
    """Every persistable var of ``programs`` as a whole host tensor on rank
    0 of the clique, None on the other ranks.  Each rank's host copies of
    its own chunks (:func:`snapshot_program_state`: its local shards, a
    replicated chunk only from its lowest holder) go to rank 0 one var at
    a time (``gather_object``, on the calling thread), so no value is
    gathered whole on a device and rank 0 receives one var at a time."""
    import numpy as np
    import torch.distributed as dist

    from ..io import _from_numpy
    snap = snapshot_program_state(programs, scope, include_rng=False)
    snap.host()
    rank, world = _clique()
    mine: Dict[str, List[Tuple[Any, Any]]] = {}
    for name, index, arr in snap["chunks"]:
        mine.setdefault(name, []).append((index, arr))
    out: Optional[Dict[str, Any]] = {} if rank == 0 else None
    for name, meta in snap["vars"].items():     # the same order on every rank
        got: Optional[List[Any]] = [mine.get(name, [])]
        if world > 1:
            got = [None] * world if rank == 0 else None
            dist.gather_object(mine.get(name, []), got, dst=0)
        if out is None:
            continue
        shape = tuple(meta["shape"])
        whole = None
        for index, arr in (c for chunks in got for c in chunks):
            if index is None:
                whole = arr
                continue
            if whole is None:
                whole = np.empty(shape, arr.dtype)
            whole[manifest_mod.chunk_slices(index, shape)] = arr
        out[name] = _from_numpy(whole, meta["dtype"])
    return out


class _SaveJob:
    __slots__ = ("snapshot", "step", "meta", "t_snap", "sync_event", "rank", "world", "token")

    def __init__(self, snapshot, step, meta, t_snap, rank: int = 0, world: int = 1,
                 token: str = ""):
        self.snapshot = snapshot
        self.step = step
        self.meta = meta
        self.t_snap = t_snap
        self.sync_event: Optional[threading.Event] = None
        # a multi-rank save (world > 1): this rank's shard file, rank 0's
        # manifest naming every rank's
        self.rank = rank
        self.world = world
        # names the save's tmp directory (the same on every rank of a clique)
        self.token = token


class CheckpointManager:
    """Background-thread async checkpointing over one root dir.

    ``save`` snapshots the state (one wave of copies, enqueued) and hands
    serialization and the atomic commit to the writer thread; ``restore``
    copies any committed checkpoint into the scope's tensors.  One manager
    per training process; the writer thread starts at the first async save
    and is drained by :meth:`wait` / :meth:`close`."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = True,
                 memory_budget=None, include_rng: bool = True):
        self.root = os.path.abspath(root)
        self.keep = max(1, int(keep))
        self.async_save = bool(async_save)
        self.memory_budget = memory_budget
        self.include_rng = bool(include_rng)
        self.rank = process_rank()
        self._q: "queue.Queue[Optional[_SaveJob]]" = queue.Queue(maxsize=2)
        # the snapshots' pinned buffers: at most one a save in flight (the
        # queue's two and the one being written)
        self._pool = _PinnedPool()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self.last_saved_step: Optional[int] = None
        # a save of this manager ran in a clique of several ranks
        self._multirank = False
        sc = CHECKPOINT_SCOPE
        self._m_saves = REGISTRY.counter("saves", scope=sc)
        self._m_async = REGISTRY.counter("saves_async", scope=sc)
        self._m_skipped = REGISTRY.counter("saves_skipped", scope=sc)
        self._m_errors = REGISTRY.counter("save_errors", scope=sc)
        self._m_restores = REGISTRY.counter("restores", scope=sc)
        self._m_rollbacks = REGISTRY.counter("rollbacks", scope=sc)
        self._m_bytes_w = REGISTRY.counter("bytes_written", scope=sc)
        self._m_bytes_r = REGISTRY.counter("bytes_read", scope=sc)
        self._m_pruned = REGISTRY.counter("pruned", scope=sc)
        self._h_save = REGISTRY.histogram("save_s", scope=sc)
        self._h_snap = REGISTRY.histogram("snapshot_s", scope=sc)
        self._h_restore = REGISTRY.histogram("restore_s", scope=sc)
        self._g_last = REGISTRY.gauge("last_save_step", scope=sc)

    # ------------------------------------------------------------- save
    def save(self, programs, scope, step: int, *, epoch_id: int = 0,
             step_id: int = 0, sync: Optional[bool] = None,
             feed_shapes: Optional[Dict[str, Sequence[int]]] = None,
             mesh=None, layout=None, extra: Optional[dict] = None,
             reason: str = "periodic") -> bool:
        """Checkpoint the persistable state of ``programs`` at ``step``.

        Synchronous part: the snapshot (:func:`snapshot_program_state`).
        Asynchronous part (unless ``sync`` or the manager is synchronous):
        waiting for the snapshot's copies, npz serialization, the program
        and manifest writes, the atomic commit, retention.  A save asked
        for while the writer's queue is full is SKIPPED (``saves_skipped``):
        checkpointing never stalls training.  Returns False on a skip.

        Under a clique of more than one rank (state on DTensors across
        processes) every rank calls ``save`` at the same step: the ranks
        agree here, on this thread, whether to skip (any rank's full queue
        skips every rank's save) and exchange their chunk maps; each
        writes its own shard file into the save's tmp directory and rank 0
        the manifest naming them all.  A writer error on any rank raises
        on every rank here.  ``mesh`` and ``layout`` are recorded in the
        manifest (``mesh`` and ``layout_fp``), as the JAX package records
        them."""
        if not hasattr(programs, "__iter__"):
            programs = [programs]
        programs = [p for p in programs if p is not None]
        sync = (not self.async_save) if sync is None else bool(sync)
        rank, world = _clique()
        busy = not sync and self._q.full()
        token = uuid.uuid4().hex
        if world > 1:
            # any rank's full queue skips every rank's save; rank 0 names
            # the directory every rank writes into
            said = self._exchange((busy, token))
            busy = any(b for b, _ in said)
            token = said[0][1]
        else:
            self._raise_pending()
        if busy:
            return self._skip(step)
        ts = TIMELINE.now_us() if TIMELINE.enabled else None
        t0 = time.perf_counter()
        snap = snapshot_program_state(programs, scope, include_rng=self.include_rng,
                                      pool=self._pool)
        t_snap = time.perf_counter() - t0
        self._h_snap.observe(t_snap)
        if ts is not None:
            TIMELINE.record_complete(f"ckpt::snapshot[{step}]", ts, TIMELINE.now_us() - ts,
                                     cat="ckpt", args={"vars": len(snap["vars"])})
        meta = {
            "step": int(step), "reason": reason,
            "trainer": {"epoch_id": int(epoch_id), "step_id": int(step_id)},
            "feed_shapes": {k: [int(d) for d in v] for k, v in (feed_shapes or {}).items()},
            "mesh": ({"axes": {str(k): int(v) for k, v in dict(mesh.shape).items()}}
                     if mesh is not None else None),
            "layout_fp": layout.fingerprint() if layout is not None else None,
            "program_fp": programs[0].desc.fingerprint() if programs else None,
            "programs": [p.desc.to_dict() for p in programs],
            "extra": dict(extra or {}),
        }
        if world > 1:
            meta["shards"] = self._agree(_chunk_map(snap["chunks"])[0])
            self._multirank = True
        job = _SaveJob(snap, int(step), meta, t_snap, rank, world, token)
        if sync:
            self._write(job)
            return True
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="paddle_tpu_torch-ckpt")
            self._thread.start()
        try:
            self._q.put_nowait(job)
        except queue.Full:
            self._release(snap)
            return self._skip(step)
        return True

    @staticmethod
    def _agree(obj) -> List[Any]:
        """Every rank's ``obj``, in rank order (``all_gather_object``: on
        the training thread, never on the writer's)."""
        import torch.distributed as dist
        out: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def _exchange(self, obj=None) -> List[Any]:
        """Every rank's ``obj`` in rank order, exchanged together with each
        rank's pending writer error (taken): when any rank's writer failed,
        every rank raises here, so none is left waiting in a collective."""
        err, self._error = self._error, None
        said = self._agree((None if err is None else f"{type(err).__name__}: {err}", obj))
        failed = [(r, e) for r, (e, _) in enumerate(said) if e is not None]
        if failed:
            raise CheckpointError(f"a previous async save failed on rank {failed[0][0]}: "
                                  f"{failed[0][1]}") from err
        return [o for _, o in said]

    def _skip(self, step: int) -> bool:
        self._m_skipped.inc()
        VLOG(1, "checkpoint: writer busy, skipping save at step %d", step)
        return False

    def _release(self, snap: _Snapshot):
        """Hand a snapshot's pinned buffers back once nothing reads its
        arrays (its copies have landed: ``host()`` waited, or the event
        is waited on here)."""
        snap.host()
        self._pool.give(snap.buffers)
        snap.buffers = ()
        snap.clear()

    def _worker(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            if job.meta.get("__barrier__"):
                if job.sync_event is not None:
                    job.sync_event.set()
                continue
            try:
                self._write(job)
            except BaseException as e:  # noqa: BLE001 -- raised at the next save/wait
                self._m_errors.inc()
                self._error = e
                VLOG(0, "checkpoint: async save at step %s failed: %s: %s",
                     job.step, type(e).__name__, e)
            finally:
                if job.sync_event is not None:
                    job.sync_event.set()

    def _write(self, job: _SaveJob):
        """Serialize one snapshot and commit it atomically (on the writer
        thread for async saves, inline for sync ones), then hand its pinned
        buffers back to the pool."""
        job.snapshot.host()
        try:
            self._serialize(job)
        finally:
            self._release(job.snapshot)

    def _serialize(self, job: _SaveJob):
        import numpy as np

        t0 = time.perf_counter()
        ts = TIMELINE.now_us() if TIMELINE.enabled else None
        final = checkpoint_dir(self.root, job.step)
        multirank = job.world > 1
        # everything in the save's own tmp directory (each rank's file
        # there too, tmp then rename); rank 0's manifest, written last, and
        # one rename of the directory publish it
        workdir = final + f".tmp.{job.token}"
        os.makedirs(workdir, exist_ok=True)

        chunk_map, keys = _chunk_map(job.snapshot["chunks"])
        payload: Dict[str, Any] = {}
        nbytes = 0
        for key, (_, _, arr) in zip(keys, job.snapshot["chunks"]):
            payload[key] = arr
            nbytes += int(arr.nbytes)
        rng = job.snapshot.get("rng")
        if rng is not None and job.rank == 0:
            payload["@RNG_STATE@::key"] = rng["data"]
        shard = shard_filename(job.rank if multirank else self.rank)
        tmp = os.path.join(workdir, shard + f".tmp.{os.getpid()}")
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(workdir, shard))
        if multirank and job.rank != 0:
            self._saved(job, t0, ts, nbytes, final)
            return
        shards = {str(self.rank): {"file": shard, "chunks": chunk_map}}
        if multirank:
            shards = {str(r): {"file": shard_filename(r), "chunks": m}
                      for r, m in enumerate(job.meta.pop("shards"))}
            _wait_for_files(workdir, [v["file"] for v in shards.values()])

        progs = job.meta.pop("programs", None)
        if progs:
            import json as _json
            ptmp = os.path.join(workdir, manifest_mod.PROGRAM_NAME + ".tmp")
            with open(ptmp, "w") as f:
                _json.dump({"program": progs[0], "programs": progs,
                            "feed_shapes": job.meta.get("feed_shapes"),
                            "mesh": job.meta.get("mesh")}, f)
            os.replace(ptmp, os.path.join(workdir, manifest_mod.PROGRAM_NAME))
        manifest = {
            "format": manifest_mod.FORMAT,
            "step": job.step,
            "vars": job.snapshot["vars"],
            "shards": shards,
            "rng": ({"key": "@RNG_STATE@::key", "impl": rng["impl"]}
                    if rng is not None else None),
            **{k: v for k, v in job.meta.items() if k != "step"},
        }
        write_manifest(workdir, manifest)   # the commit point
        if os.path.isdir(final):            # a same-step re-save
            shutil.rmtree(final, ignore_errors=True)
        os.replace(workdir, final)
        self._prune()
        self._saved(job, t0, ts, nbytes, final)

    def _saved(self, job: _SaveJob, t0: float, ts, nbytes: int, final: str):
        """A save's counters, span, record and log line."""
        save_s = time.perf_counter() - t0
        with self._lock:
            self.last_saved_step = job.step
        is_async = threading.current_thread() is self._thread
        self._m_saves.inc()
        if is_async:
            self._m_async.inc()
        self._m_bytes_w.inc(nbytes)
        self._h_save.observe(save_s)
        self._g_last.set(job.step)
        if ts is not None:
            TIMELINE.record_complete(f"ckpt::write[{job.step}]", ts, TIMELINE.now_us() - ts,
                                     cat="ckpt", args={"bytes": nbytes})
        CKPT_RECORDS.record(
            kind="save", step=job.step, reason=job.meta.get("reason"),
            vars=len(job.snapshot["vars"]), bytes=nbytes,
            snapshot_s=round(job.t_snap, 6), save_s=round(save_s, 6),
            async_=is_async, dir=final)
        VLOG(1, "checkpoint: step %d committed to %s (%d vars, %d bytes, %.1f ms)",
             job.step, final, len(job.snapshot["vars"]), nbytes, save_s * 1e3)

    def _prune(self):
        """Keep-last-K retention (rank 0's, after its commit)."""
        steps = list_steps(self.root)
        while len(steps) > self.keep:
            victim = checkpoint_dir(self.root, steps.pop(0))
            shutil.rmtree(victim, ignore_errors=True)
            self._m_pruned.inc()

    def _raise_pending(self):
        err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(
                f"a previous async save failed: {type(err).__name__}: {err}") from err

    # ------------------------------------------------------------- drain
    def wait(self, timeout: Optional[float] = None):
        """Block until every queued async save has committed.  Raises a
        writer error.  After a multi-rank save every rank calls ``wait``:
        it ends in an exchange of the clique's writer errors (raised on
        every rank), so no rank returns before rank 0 has committed the
        manifest."""
        if self._thread is not None and self._thread.is_alive():
            # a barrier: the worker acks it once every job queued before
            # it has been written and committed
            job = _SaveJob(None, -1, {"__barrier__": True}, 0.0)
            job.sync_event = threading.Event()
            self._q.put(job, timeout=timeout)
            job.sync_event.wait(timeout)
        if self._multirank:
            self._exchange()
        else:
            self._raise_pending()

    def close(self):
        if self._thread is not None and self._thread.is_alive():
            self.wait()
            self._q.put(None)
            self._thread.join(timeout=5.0)
        self._thread = None
        self._pool = _PinnedPool()

    # ----------------------------------------------------------- restore
    def steps(self) -> List[int]:
        return list_steps(self.root)

    def latest(self) -> Optional[int]:
        return latest_step(self.root)

    def restore(self, programs, scope, *, step: Optional[int] = None,
                mesh=None, layout=None, executor=None,
                memory_budget=None, strict: bool = True,
                reason: str = "resume") -> Dict[str, Any]:
        """Restore a committed checkpoint (the latest by default) into
        ``scope``, each value copied into the tensor the scope holds (a
        name the scope lacks is bound on ``executor``'s device).  With a
        ``memory_budget`` (argument or manager default) the static planner
        checks the program first, under the target ``mesh`` and
        ``layout``, and raises ``PredictedOOMError`` before anything moves.
        A var whose shape differs from the program's is refused
        (``strict``) or skipped.

        ``mesh`` (and ``layout``) place the state on the TARGET topology,
        whatever the source's was: every shard file's chunks are
        reassembled into whole host arrays, and each rank keeps its shard
        of each var's target spec (its ``sharding`` attr, else the
        layout's rule, else replicated), copied in place into a DTensor
        the scope holds on those placements, else bound as a new one; no
        collective runs.  Returns the manifest."""
        from ..io import _from_numpy, _place

        t0 = time.perf_counter()
        if not hasattr(programs, "__iter__"):
            programs = [programs]
        programs = [p for p in programs if p is not None]
        if step is None:
            step = self.latest()
            if step is None:
                raise CheckpointError(f"no committed checkpoint under {self.root!r}")
        d = checkpoint_dir(self.root, step)
        manifest = read_manifest(d)
        validate_shards(d, manifest, check_payload=False)

        budget = memory_budget if memory_budget is not None else self.memory_budget
        if budget is not None:
            self.restore_fit(programs[0] if programs else None, manifest, mesh=mesh,
                             layout=layout, budget=budget)

        want: List[str] = []
        drift: List[str] = []
        for prog in programs:
            block = prog.desc.block(0)
            for name, vd in block.vars.items():
                if not vd.persistable or name in want:
                    continue
                meta = (manifest.get("vars") or {}).get(name)
                if meta is None:
                    continue
                if tuple(int(x) for x in meta["shape"]) != tuple(int(x) for x in vd.shape):
                    drift.append(f"{name}: ckpt {meta['shape']} vs program {list(vd.shape)}")
                    continue
                want.append(name)
        if drift and strict:
            raise CheckpointError(
                f"checkpoint step {step} does not fit this program -- "
                f"shape drift in {len(drift)} var(s): " + "; ".join(drift[:6]))
        arrays = manifest_mod.read_chunks(d, manifest, want)
        nbytes = 0
        for name, arr in arrays.items():
            nbytes += int(arr.nbytes)
            value = _from_numpy(arr, manifest["vars"][name].get("dtype"))
            if mesh is None:
                _place(scope, executor, name, value)
            else:
                _place_shard(scope, programs, name, value, mesh, layout)
        rng_meta = manifest.get("rng")
        if rng_meta and self.include_rng:
            _restore_rng(d, manifest, rng_meta, scope)
        restore_s = time.perf_counter() - t0
        self._m_restores.inc()
        if reason == "rollback":
            self._m_rollbacks.inc()
        self._m_bytes_r.inc(nbytes)
        self._h_restore.observe(restore_s)
        CKPT_RECORDS.record(
            kind=reason if reason in ("rollback",) else "restore",
            step=step, vars=len(want), bytes=nbytes, restore_s=round(restore_s, 6),
            source_mesh=(manifest.get("mesh") or {}).get("axes"),
            target_mesh=({str(k): int(v) for k, v in dict(mesh.shape).items()}
                         if mesh is not None else None), dir=d)
        VLOG(0, "checkpoint: restored step %d from %s (%d vars, %d bytes, %.1f ms)%s",
             step, d, len(want), nbytes, restore_s * 1e3,
             f" -- {len(drift)} var(s) skipped on shape drift" if drift else "")
        return manifest

    # ------------------------------------------------------ restore fit
    @staticmethod
    def restore_fit(program, manifest: Dict[str, Any], *, mesh=None,
                    layout=None, budget=None,
                    feed_shapes: Optional[dict] = None) -> Dict[str, Any]:
        """The restore-fit pre-flight, answered statically before anything
        is placed: with a ``program``, the full ``analysis.plan_memory``
        sweep (persistent state and activations at the manifest's recorded
        feed shapes); without one, the manifest-only persistent-bytes
        estimate.  ``mesh`` is a ``{axis: size}`` dict (planning only).
        Raises ``PredictedOOMError`` (M501) when the predicted per-device
        peak exceeds ``budget``."""
        from ..analysis import memory as _memory

        budget_b = _memory.parse_memory_budget(budget)
        mesh_shape = None
        if mesh is not None:
            mesh_shape = {str(k): int(v)
                          for k, v in dict(getattr(mesh, "shape", mesh)).items()}
        if program is not None:
            plan = _memory.plan_memory(
                program, feed_shapes=feed_shapes or manifest.get("feed_shapes"),
                mesh=mesh_shape, layout=layout)
        else:
            plan = _memory.plan_state_memory(manifest.get("vars") or {}, mesh=mesh_shape,
                                             layout=layout)
        if plan.peak_bytes > budget_b:
            raise _memory.PredictedOOMError(plan, budget_b)
        return {"peak_bytes": plan.peak_bytes, "budget_bytes": budget_b,
                "num_devices": plan.num_devices}


def _place_shard(scope, programs, name: str, value, mesh, layout):
    """This rank's shard of the whole host ``value`` of ``name`` on its
    target spec over ``mesh``: copied into the scope's DTensor where it
    already lies on those placements (the tensor keeps its address, so a
    captured step replays on), else bound as a new DTensor."""
    import torch
    from torch.distributed.tensor import DTensor

    from ..core.lower import is_dtensor
    from ..parallel.layout import as_placements, check_divisible, local_index, state_spec
    block = next(p.desc.block(0) for p in programs if p.desc.block(0).find_var(name) is not None)
    cur = scope.find_var(name)
    if isinstance(cur, torch.Tensor) and cur.numel() == value.numel():
        value = value.reshape(cur.shape)    # a [1] scalar the startup made stays [1] (io._place)
    spec = state_spec(block, name, mesh, layout)
    check_divisible(name, value.shape, spec, mesh)
    placements = as_placements(spec, mesh)
    local = value[local_index(placements, mesh, value.shape)]
    if is_dtensor(cur) and tuple(cur.placements) == placements \
            and tuple(cur.to_local().shape) == tuple(local.shape):
        cur.to_local().copy_(local)
        return
    local = local.to(mesh.device, dtype=cur.dtype if isinstance(cur, torch.Tensor)
                     else local.dtype).contiguous()
    scope.set_var(name, DTensor.from_local(local, mesh.device_mesh, placements,
                                           run_check=False, shape=value.shape,
                                           stride=value.contiguous().stride()))


#: how long rank 0's writer waits for the other ranks' shard files
WAIT_FOR_SHARDS_S = 600.0


def _wait_for_files(dirname: str, names: Sequence[str], timeout: float = None):
    """Block until every file of ``names`` exists in ``dirname`` (each is
    renamed into place whole, so existing means written).  Raises
    ``CheckpointError`` naming the missing ones after ``timeout``."""
    timeout = WAIT_FOR_SHARDS_S if timeout is None else timeout
    deadline = time.time() + timeout
    while True:
        missing = [n for n in names if not os.path.isfile(os.path.join(dirname, n))]
        if not missing:
            return
        if time.time() > deadline:
            raise CheckpointError(f"shard files {missing} did not appear in {dirname!r} "
                                  f"within {timeout} s: a writing rank failed or stopped")
        time.sleep(0.01)


def _restore_rng(d: str, manifest: Dict[str, Any], rng_meta: Dict[str, Any], scope):
    """The scope's generator set, in place (``set_state`` on the same
    object), to the saved state: a CUDA graph that registered the
    generator draws from the restored state on its next replay.  A state
    saved by another implementation (a JAX key, or a generator of another
    device type) is skipped with a VLOG, as the JAX package skips this
    one."""
    import numpy as np
    import torch
    impl = rng_meta.get("impl") or ""
    gen = scope.find_var(_RNG_KEY)
    if not isinstance(gen, torch.Generator):
        VLOG(1, "checkpoint: rng restore skipped: the scope holds no generator")
        return
    if impl != _RNG_IMPL_PREFIX + gen.device.type:
        VLOG(1, "checkpoint: rng restore skipped: saved by %r, the scope's generator is %s%s",
             impl or None, _RNG_IMPL_PREFIX, gen.device.type)
        return
    shard = (manifest.get("shards") or {}).get("0", {}).get("file") or shard_filename(0)
    with np.load(os.path.join(d, shard), allow_pickle=False) as data:
        state = np.array(data[rng_meta["key"]], copy=True)
    gen.set_state(torch.from_numpy(state))


# -------------------------------------------------- directory restore-fit

def restore_fit_dir(dirname: str, *, mesh=None, layout=None, budget=None,
                    feed_shapes: Optional[dict] = None) -> Dict[str, Any]:
    """:meth:`CheckpointManager.restore_fit` against a checkpoint
    DIRECTORY: the manifest, and the embedded ``program.json`` when the
    checkpoint carries one (the full ``plan_memory`` sweep with the
    recorded feed shapes), else the manifest-only estimate.  Raises
    ``PredictedOOMError`` (M501) over ``budget``."""
    import json as _json

    manifest = manifest_mod.read_manifest(dirname)
    program = None
    prog_path = os.path.join(dirname, manifest_mod.PROGRAM_NAME)
    if os.path.isfile(prog_path):
        from ..core.desc import ProgramDesc
        from ..ops import shape_infer as _shape_infer  # noqa: F401
        with open(prog_path) as f:
            dump = _json.load(f)
        program = ProgramDesc.from_dict(dump["program"])
        if feed_shapes is None:
            feed_shapes = dump.get("feed_shapes")
    out = CheckpointManager.restore_fit(program, manifest, mesh=mesh, layout=layout,
                                        budget=budget, feed_shapes=feed_shapes)
    out["source"] = "plan_memory" if program is not None else "manifest-persistent-only"
    return out
