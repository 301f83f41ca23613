"""Trainer and Inferencer: the high-level entry points.

``Trainer`` (Fluid's trainer.py:169, ported from the JAX package's
``trainer.py``): ``train_func`` builds the forward graph and returns the
loss (or ``[loss, *metrics]``), ``optimizer_func`` returns an optimizer,
and ``train`` runs epochs over a reader, calling ``event_handler`` with
``BeginEpochEvent`` / ``BeginStepEvent`` / ``EndStepEvent`` /
``EndEpochEvent`` in that order.  With ``pipeline=True`` (the default)
each epoch's batches are converted by ``DataFeeder`` and staged to the
card on a background thread (``Executor.stage_feeds``) while the step
before runs, and ``EndStepEvent.metrics`` are non-blocking
``FetchHandle`` objects; ``pipeline=False`` runs synchronous steps with
numpy metrics.  On the card each step replays the step program's CUDA graph
(one per feed signature).  ``CheckpointConfig`` keeps Fluid's numbered
serial directories (``checkpoint_<n>``) with rotation and epoch and step
resume; a resumed run repeats the uninterrupted run's steps.  A step
record goes to ``telemetry.STEPS`` (JSONL under
``PADDLE_TPU_TELEMETRY_DIR``) with the JAX Trainer's keys.
``profile_steps=N`` replays every Nth step's feed through
``Executor.profile_ops`` (the sampled per-op profiler: records in
``profile_<pid>.jsonl`` and ``costmodel_<pid>.json``) after the step; the
replay writes no state, and a failure is logged at ``VLOG(1)``.

``accum_steps=N`` splits the step program (``backward.
split_for_gradient_accumulation``) into an accumulate program, run on
every batch, and an apply program (the updates on the mean of the N
accumulated gradients), run after every Nth batch; on the card each is one
CUDA graph.

``health=True`` (or a ``health.HealthConfig``) builds the step's
executor with the health sentinel (``Executor(sentinels=...)``: computed
inside the step's CUDA graph on the card) and attaches a
``health.HealthMonitor`` after the startup run: a health record a step in
``health_<pid>.jsonl``, divergence events, and on a non-finite trip the
first bad op named by a replay.  The monitor is polled after each step
(non-blocking) and flushed when ``train`` returns.

``checkpoint=CheckpointConfig(...)`` (``checkpoint.CheckpointConfig``,
the async manager; exclusive with the legacy ``checkpoint_config=``)
restores the latest committed checkpoint when the Trainer is built
(``resume="auto"``: epoch and step resume, the values copied into the
startup's tensors), saves every ``step_interval`` steps and every
``epoch_interval`` epochs (the step pays the snapshot's copies; the
writer thread the rest), and acts on the health layer's events:
``rollback_on_divergence`` restores the last good checkpoint in place
after a loss spike, a grad explosion or a non-finite trip (the step's
graph replays on, no new capture), ``save_on_fetch_timeout`` saves
synchronously and stops after a fetch timeout.  ``train`` waits for the
queued saves before it returns.

``prefetcher=`` (an ``embedding.RowPrefetcher``) dedups each batch's
embedding ids on the host as the batch is staged.

``parallel=True`` trains on a ``data`` mesh of every rank of the clique
(``distributed.init_parallel_env``; one device a rank), ``mesh=`` on a
given ``parallel.mesh.Mesh``, and ``layout=`` (a ``parallel.SpecLayout``)
on its specs, over a mesh built from ``layout.mesh_axes`` when none is
given: the executor runs each step on DTensors (``core/executor.py``),
each rank feeding its own rows of the global batch.  Under a mesh,
``checkpoint=`` saves from every rank (a shard file each, rank 0's
manifest naming them all), resumes (``resume="auto"``) and rolls back onto
the trainer's mesh and layout; ``checkpoint_config=``'s serial dirs save
and load the whole values (``io``: every rank reads, rank 0 writes);
``health=`` takes the sentinel's global norms and OR-ed bitmask over the
ranks, and a trip's localization is skipped on a mesh that spans
processes (reproduce it in one process).

``dispatch=DispatchConfig(...)`` (``dispatch/``, the elastic data
dispatch) makes ``train(reader=None)`` read its epoch from a
``DispatchMaster``'s leases through a ``DispatchReader``; the batches take
the same ``DataFeeder`` / ``FeedStager`` path as a local reader's.  On
construction the Trainer reaps the leases its previous incarnation (the
same worker id, or ``reap_worker_id``) still holds, so they re-serve at
once; a resumed run leaves mid-epoch progress to the master; each step
record carries the trace context of the task that fed it.

Before the first step the Trainer plans the step program's memory from
the first batch's shapes (``analysis.plan_memory``), logs the predicted
peak and exports the plan to ``memplan_<pid>.jsonl`` with
``source="trainer"``; the plan is advisory and never fails a run.

``Inferencer``: build an inference program once, initialize its
parameters (or load them from ``param_path``), run predictions.  The
program is built under ``unique_name.guard()`` (fresh counters) so
parameter names are deterministic: the same ``infer_func`` built by the
JAX package's Inferencer names its parameters the same way, which is what
lets ``convert.params_from_numpy`` or a saved directory carry weights
across.  One pinned ``Scope`` holds the parameters across every ``infer``
call.  ``passes=``, ``amp=`` and ``kernels=`` go to the ``Executor``: e.g.
``amp=AmpConfig(bf16=False, quant=True)`` with the kernel tier on (the
default on a CUDA place) serves every ``mul`` through the int8 GEMM.
``validate=`` and ``memory_budget=`` go to the ``Executor`` as well: the
verifier runs once for all warmup buckets, and :meth:`Inferencer.warmup`
rejects a batch size whose planned peak exceeds the budget (its record
carries ``rejected=True`` and the M501 diagnostic).
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import io as io_mod
from . import telemetry
from .core import unique_name
from .core.desc import VarType
from .core.dtypes import to_numpy
from .core.executor import Executor, Place
from .core.framework import Program, Variable, program_guard
from .core.scope import Scope, scope_guard
from .core.staging import COUNTERS
from .data_feeder import DataFeeder
from .log import VLOG

__all__ = ["BeginEpochEvent", "EndEpochEvent", "BeginStepEvent", "EndStepEvent",
           "CheckpointConfig", "Trainer", "Inferencer"]

_LOG = logging.getLogger(__name__)


class BeginEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id: int, step_id: int):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id: int, step_id: int, metrics: List):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """Fluid's trainer.py:100: periodic serial-dir checkpoints with
    rotation and epoch and step resume."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3, epoch_interval: int = 1,
                 step_interval: int = 10):
        self.checkpoint_dir = checkpoint_dir or os.path.join(os.getcwd(), "checkpoint")
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(1, int(epoch_interval))
        self.step_interval = max(1, int(step_interval))
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial: Optional[int] = None


_TRAINER_STATE = "trainer_state.json"


def _serial_dir(root: str, serial: int) -> str:
    return os.path.join(root, f"checkpoint_{serial}")


def _list_serials(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("checkpoint_"):
            try:
                out.append(int(d.split("_")[-1]))
            except ValueError:
                pass
    return sorted(out)


class Trainer:
    """Fluid's trainer.py:169 (see the module docstring)."""

    def __init__(self, train_func: Callable, optimizer_func: Callable,
                 place: Optional[Place] = None,
                 param_path: Optional[str] = None, parallel: bool = False,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 seq_len_buckets=None, pipeline: bool = True,
                 mesh=None, layout=None, accum_steps: int = 1,
                 health=None, checkpoint=None, dispatch=None, amp=None,
                 kernels=None, profile_steps: Optional[int] = None,
                 prefetcher=None):
        if mesh is None and layout is not None:
            from .parallel import make_mesh
            mesh = make_mesh(layout.mesh_axes) if layout.mesh_axes else make_mesh()
        if mesh is None and parallel:
            from .parallel import make_mesh
            mesh = make_mesh()
        # mesh/layout: sharded training (parallel/layout.py SpecLayout over
        # data x fsdp x tp); parameters, optimizer slots and accumulation
        # buffers are placed on the layout's specs before step 0
        self.layout = layout
        self._mesh = mesh
        # prefetcher: an embedding.RowPrefetcher; its on_batch hook dedups
        # each batch's ids on the stager's thread (pipeline=True) or before
        # the step (pipeline=False)
        self.prefetcher = prefetcher
        if checkpoint and checkpoint_config:
            raise ValueError(
                "pass either checkpoint= (paddle_tpu_torch.checkpoint, the async format) "
                "or the legacy checkpoint_config=, not both")
        # health: the flight recorder (health.py): True or a HealthConfig
        if health:
            from .health import HealthConfig, HealthMonitor
            self.health = HealthMonitor(HealthConfig() if health is True else health)
        else:
            self.health = None
        # seq_len_buckets: DataFeeder's ragged-length buckets (None: the
        # pow2 default for ragged feeds, False: exact per-batch padding)
        self.seq_len_buckets = seq_len_buckets
        # pipeline: stage batch N+1 on a background thread while step N
        # runs, and fetch metrics through non-blocking handles
        self.pipeline = pipeline
        # accum_steps=N: gradients of N micro-batches are summed into
        # persistable buffers and the optimizer applies their mean every
        # Nth micro-step
        self.accum_steps = max(1, int(accum_steps))
        # profile_steps=N: every Nth step's feed replayed through
        # exe.profile_ops after the step (the other steps pay nothing)
        self.profile_steps = int(profile_steps) if profile_steps else None
        self.checkpoint_cfg = checkpoint_config
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()
        # the resume point, written by whichever checkpoint layer loaded
        # (legacy serial dirs or the manifest format) and read by train()
        self._ckpt_state = {"epoch_id": 0, "step_id": 0}
        self._stop = False
        self.ckpt_config = None
        self.ckpt_manager = None
        self._global_step = 0
        # set by the health layer's hooks, acted on after the step
        self._ckpt_rollback = threading.Event()
        self._ckpt_save_exit = threading.Event()
        # dispatch: a DispatchConfig makes train(reader=None) read its epoch
        # from the master's leases; the leases a previous incarnation of this
        # worker still holds are reaped first, so they re-serve at once
        self.dispatch_cfg = dispatch
        self.dispatch_client = None
        self.dispatch_reader = None
        if dispatch is not None:
            self.dispatch_client = dispatch.make_client()
            if dispatch.reap_on_start:
                try:
                    reaped = self.dispatch_client.reap_worker(dispatch.reap_worker_id)
                    if reaped:
                        VLOG(0, "dispatch: reaped %d in-flight task(s) of a previous "
                                "incarnation: %s", len(reaped), reaped)
                except Exception as e:  # noqa: BLE001 -- the master may not be up yet
                    VLOG(1, "dispatch reap_on_start skipped: %s", e)
            self.dispatch_reader = dispatch.make_reader(self.dispatch_client)
        with program_guard(self.train_program, self.startup_program):
            outs = train_func()
            self.train_outputs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
            loss = self.train_outputs[0]
            optimizer = optimizer_func()
            optimizer.minimize(loss)
        self.loss = loss
        if self.accum_steps > 1:
            from .backward import split_for_gradient_accumulation
            self._step_program, self.apply_program = split_for_gradient_accumulation(
                self.train_program, self.startup_program, self.accum_steps)
        else:
            self._step_program, self.apply_program = self.train_program, None
        # amp: mixed precision (amp.AmpConfig / AmpPolicy / True) composed
        # into the executor's pass pipeline; kernels: the kernel tier (None:
        # on for a CUDA place, off on the CPU)
        self.amp = amp
        self.kernels = kernels
        sentinels = self.health.config.sentinels if self.health else None
        self.exe = Executor(place, amp=amp, kernels=kernels, sentinels=sentinels, mesh=mesh,
                            layout=layout)
        self.exe.run(self.startup_program, scope=self.scope)
        if self.health:
            # attached after the startup run: an init program gives no
            # step-health signal worth a record
            self.health.attach(self.exe)
        if param_path:
            with scope_guard(self.scope):
                io_mod.load_persistables(self.exe, param_path, self.train_program)
        if self.checkpoint_cfg:
            serials = _list_serials(self.checkpoint_cfg.checkpoint_dir)
            if serials:
                self._load_checkpoint(serials[-1])
        if checkpoint:
            self._attach_checkpoint(checkpoint)
        if mesh is not None:
            # rank 0's values onto the placements before step 0 (one
            # placement at init, not inside the first step); also covers
            # values just loaded from param_path
            from .parallel.layout import shard_program_state
            for prog in filter(None, (self._step_program, self.apply_program)):
                shard_program_state(prog, self.scope, mesh, layout)
        self._memory_planned = False
        self.memory_plan = None

    def _attach_checkpoint(self, checkpoint):
        """The async manager: resume from its latest checkpoint (in place),
        and the health layer's triggers."""
        from .checkpoint import CheckpointConfig as _AsyncCkptConfig, CheckpointManager
        cfg = _AsyncCkptConfig() if checkpoint is True else checkpoint
        self.ckpt_config = cfg
        self.ckpt_manager = CheckpointManager(
            cfg.dir, keep=cfg.keep, async_save=cfg.async_save,
            memory_budget=cfg.memory_budget, include_rng=cfg.include_rng)
        if cfg.resume == "auto" and self.ckpt_manager.latest() is not None:
            manifest = self.ckpt_manager.restore([self._step_program, self.apply_program],
                                                 self.scope, executor=self.exe,
                                                 mesh=self._mesh, layout=self.layout)
            st = manifest.get("trainer") or {}
            self._ckpt_state = {"epoch_id": int(st.get("epoch_id", 0)),
                                "step_id": int(st.get("step_id", 0))}
            self._global_step = int(manifest.get("step", 0))
        if cfg.rollback_on_divergence and self.health:
            ev = self._ckpt_rollback

            def _on_health_event(rec, _ev=ev):
                if rec.get("event") in ("loss-spike", "grad-explosion", "non-finite"):
                    _ev.set()
            self.health.add_event_hook(_on_health_event)
        if cfg.save_on_fetch_timeout:
            from .core import staging as _staging
            ev = self._ckpt_save_exit
            _staging.add_fetch_timeout_hook(lambda _ev=ev, **kw: _ev.set())

    # ------------------------------------------------------------- training
    def train(self, num_epochs: int, event_handler: Callable,
              reader: Optional[Callable] = None, feed_order: Sequence[str] = ()):
        dispatched = False
        if reader is None:
            if self.dispatch_reader is None:
                raise ValueError("train(reader=None) needs Trainer(dispatch="
                                 "DispatchConfig(...)) -- no data source")
            reader = self.dispatch_reader
            dispatched = True
        feed_vars = [self.train_program.global_block.var(n) for n in feed_order]
        buckets = self.seq_len_buckets
        if buckets is None and any(v.lod_level > 0 for v in feed_vars):
            # ragged feeds default to power-of-two buckets: an epoch of
            # varying lengths then builds one cache entry (on the card, one
            # CUDA graph) a bucket; pad columns carry zero ids and the true
            # lengths ride @SEQ_LEN, so SEQ_LEN-aware consumers are
            # unaffected.  seq_len_buckets=False pads each batch exactly.
            buckets = "pow2"
            _LOG.info("Trainer: ragged feeds default to seq_len_buckets='pow2' (pass "
                      "seq_len_buckets=False for exact per-batch padding)")
        elif buckets is False:
            buckets = None
        feeder = DataFeeder(feed_list=feed_vars, program=self.train_program,
                            seq_len_buckets=buckets)
        # mid-epoch resume: skip the already-trained steps of the first
        # resumed epoch
        start_epoch = self._ckpt_state["epoch_id"]
        resume_step = self._ckpt_state["step_id"]
        if dispatched:
            # the master owns mid-epoch progress (finished tasks never
            # re-serve): skipping local step indices would drop the requeued
            # tasks a restart exists to recover
            resume_step = 0
        self._stop = False
        try:
            with scope_guard(self.scope):
                for epoch_id in range(start_epoch, num_epochs):
                    event_handler(BeginEpochEvent(epoch_id))
                    skip_until = resume_step if epoch_id == start_epoch else 0
                    self._run_epoch(epoch_id, event_handler, reader, feeder, skip_until)
                    if self._stop:
                        return
                    event_handler(EndEpochEvent(epoch_id))
                    if self.checkpoint_cfg and \
                            epoch_id % self.checkpoint_cfg.epoch_interval == 0:
                        self._save_checkpoint(epoch_id + 1, 0)
                    if (self.ckpt_manager is not None and self.ckpt_config.epoch_interval
                            and (epoch_id + 1) % self.ckpt_config.epoch_interval == 0):
                        self._ckpt_save(epoch_id + 1, 0, None, reason="epoch")
        finally:
            if self.health:
                # the last steps' records land even when training stops early
                self.health.flush()
            if self.ckpt_manager is not None:
                # every save asked for is committed (the manager stays open:
                # train() may be called again)
                self.ckpt_manager.wait()

    def _run_epoch(self, epoch_id: int, event_handler: Callable, reader,
                   feeder: DataFeeder, skip_until: int):
        if self.pipeline:
            # DataFeeder's conversion and the copy to the card of batch N+1
            # run on the stager thread while step N runs; the executor
            # returns non-blocking FetchHandles, so reading a metric in the
            # event handler is the step's one sync point
            batches = (feeder.feed(b) for i, b in enumerate(reader()) if i >= skip_until)
            on_batch = self.prefetcher.on_batch if self.prefetcher is not None else None
            stager = self.exe.stage_feeds(self._step_program, batches, on_batch=on_batch)
            steps = enumerate(stager, start=skip_until)
        else:
            stager = None

            def _synchronous_steps():
                for i, b in enumerate(reader()):
                    if i < skip_until:
                        continue
                    feed = feeder.feed(b)
                    if self.prefetcher is not None:
                        self.prefetcher.on_batch(feed)
                    yield i, feed
            steps = _synchronous_steps()
        steps = iter(steps)
        micro = 0   # micro-steps since the last application of the optimizer
        try:
            while True:
                # the pull is timed on its own: on the pipelined path it is
                # the host waiting for the stager (feed starvation)
                t_wait0 = time.perf_counter()
                try:
                    step_id, feed = next(steps)
                except StopIteration:
                    return
                t_run0 = time.perf_counter()
                if self._stop:
                    return
                if not self._memory_planned:
                    self._log_memory_plan(feed)
                stalls0 = COUNTERS.get("sync_stalls")
                begin = BeginStepEvent(epoch_id, step_id)
                event_handler(begin)
                fetch = self.train_outputs if begin.fetch_metrics else []
                metrics = self.exe.run(self._step_program, feed=feed, fetch_list=fetch,
                                       scope=self.scope, sync=not self.pipeline)
                if self.apply_program is not None:
                    micro += 1
                    if micro >= self.accum_steps:
                        micro = 0
                        self.exe.run(self.apply_program, feed={}, fetch_list=[],
                                     scope=self.scope, sync=not self.pipeline)
                t_handler0 = time.perf_counter()
                event_handler(EndStepEvent(epoch_id, step_id, metrics))
                t_end = time.perf_counter()
                # assembly_s: the JAX Trainer's global-batch assembly time
                # under a multi-process mesh; one card assembles nothing
                self._record_step(epoch_id, step_id, feed, wait_s=t_run0 - t_wait0,
                                  run_s=t_handler0 - t_run0, handler_s=t_end - t_handler0,
                                  step_time_s=t_end - t_wait0,
                                  sync_stalls=COUNTERS.get("sync_stalls") - stalls0,
                                  assembly_s=0.0)
                if self.profile_steps and (step_id + 1) % self.profile_steps == 0:
                    # fetch_list=None: every op output is a target, so the
                    # backward and the updates stay in the live slice
                    try:
                        self.exe.profile_ops(self._step_program, feed=feed, scope=self.scope,
                                             compiled_step_s=t_handler0 - t_run0)
                    except Exception as e:  # noqa: BLE001 -- profiling never fails a run
                        VLOG(1, "profile_ops failed: %s: %s", type(e).__name__, e)
                if self.health:
                    # resolve the sentinels whose copies have landed, without
                    # waiting: the pipeline stays full
                    self.health.poll()
                if self.checkpoint_cfg and step_id \
                        and step_id % self.checkpoint_cfg.step_interval == 0:
                    # saved step_id + 1: training through step_id is
                    # complete, a resume starts at the next step
                    self._save_checkpoint(epoch_id, step_id + 1)
                if self.ckpt_manager is not None:
                    self._global_step += 1
                    if self._ckpt_step_actions(epoch_id, step_id, feed):
                        return
        finally:
            if stager is not None:
                stager.close()

    def _log_memory_plan(self, feed: dict):
        """The step-0 static memory plan: the step program's per-device
        peak from the first batch's shapes, logged and exported
        (``memplan_<pid>.jsonl``, ``source="trainer"``) as the plan side of
        a plan-vs-actual comparison.  Kept as ``self.memory_plan``; a
        failure is logged, never raised."""
        self._memory_planned = True
        try:
            from .analysis import memory as _memory
            plan = _memory.plan_memory(
                self._step_program, fetch_list=[v.name for v in self.train_outputs],
                feed_shapes=self.exe.global_feed_shapes(
                    self._step_program.desc.block(0),
                    {k: tuple(int(d) for d in v.shape) for k, v in feed.items()
                     if hasattr(v, "shape")}), mesh=self._mesh, layout=self.layout)
            self.memory_plan = plan
            _memory.export_plan(plan, source="trainer")
            b = plan.breakdown
            VLOG(0, "memory plan: peak %s/device at op#%s %s (%s) -- persistent %s, "
                    "activations %s, feeds %s over %d device(s)",
                 _memory.fmt_bytes(plan.peak_bytes), plan.peak_op_index, plan.peak_op_type,
                 plan.peak_callsite or "?", _memory.fmt_bytes(b.get("persistent", 0)),
                 _memory.fmt_bytes(b.get("activations", 0)),
                 _memory.fmt_bytes(b.get("feeds", 0)), plan.num_devices)
        except Exception as e:  # noqa: BLE001 -- advisory only
            VLOG(1, "memory plan failed: %s: %s", type(e).__name__, e)

    def _record_step(self, epoch_id: int, step_id: int, feed: dict, **timings):
        """One step's telemetry record (ring buffer, and JSONL when
        PADDLE_TPU_TELEMETRY_DIR is set): step time, examples/s, stall
        attribution, cache state; ``tools/stats.py`` summarizes them."""
        examples = 0
        for v in feed.values():
            shape = getattr(v, "shape", None)
            if shape:
                examples = int(shape[0])
                break
        st = timings.get("step_time_s") or 0.0
        trace = {}
        if self.dispatch_reader is not None:
            # the reader's generator runs on the stager's thread, so its
            # task's consume span reaches this record only through the
            # reader: the step joins the task's trace (the master's task
            # span, the worker's consume span, this step)
            ctx = self.dispatch_reader.current_trace
            if ctx is not None:
                trace = ctx.fields()
        telemetry.STEPS.record(epoch=epoch_id, step=step_id, examples=examples,
                               examples_per_sec=(examples / st) if st > 0 else 0.0,
                               compiles=self.exe.compile_count, pipeline=self.pipeline,
                               **timings, **trace)

    def stop(self):
        self._stop = True

    # ---------------------------------------------------------- persistence
    def save_params(self, param_path: str):
        with scope_guard(self.scope):
            io_mod.save_persistables(self.exe, param_path, self.train_program)

    def save_inference_model(self, param_path: str, feeded_var_names: Sequence[str],
                             target_vars: Sequence[Variable]):
        with scope_guard(self.scope):
            io_mod.save_inference_model(param_path, list(feeded_var_names),
                                        list(target_vars), self.exe, self.train_program)

    def _save_checkpoint(self, epoch_id: int, step_id: int):
        cfg = self.checkpoint_cfg
        scope = self.scope
        if self._mesh is not None:
            # the whole values on rank 0's host (every rank takes part), written by rank 0
            from .checkpoint.manager import gather_program_state
            whole = gather_program_state([self.train_program], self.scope)
            if whole is None:
                return
            scope = Scope()
            for name, val in whole.items():
                scope.set_var(name, val)
        serials = _list_serials(cfg.checkpoint_dir)
        serial = (serials[-1] + 1) if serials else 0
        d = _serial_dir(cfg.checkpoint_dir, serial)
        with scope_guard(scope):
            io_mod.save_persistables(self.exe, d, self.train_program)
        with open(os.path.join(d, _TRAINER_STATE), "w") as f:
            json.dump({"epoch_id": epoch_id, "step_id": step_id}, f)
        # rotation (Fluid's max_num_checkpoints)
        serials = _list_serials(cfg.checkpoint_dir)
        while len(serials) > cfg.max_num_checkpoints:
            shutil.rmtree(_serial_dir(cfg.checkpoint_dir, serials.pop(0)), ignore_errors=True)

    def _load_checkpoint(self, serial: int):
        cfg = self.checkpoint_cfg
        d = _serial_dir(cfg.checkpoint_dir, serial)
        with scope_guard(self.scope):
            io_mod.load_persistables(self.exe, d, self.train_program)
        state_path = os.path.join(d, _TRAINER_STATE)
        if os.path.exists(state_path):
            with open(state_path) as f:
                st = json.load(f)
            cfg.epoch_id = int(st.get("epoch_id", 0))
            cfg.step_id = int(st.get("step_id", 0))
            cfg.load_serial = serial
            self._ckpt_state = {"epoch_id": cfg.epoch_id, "step_id": cfg.step_id}


    # -------------------------------------------- async checkpoint wiring
    def _ckpt_save(self, epoch_id: int, step_id: int, feed, sync: Optional[bool] = None,
                   reason: str = "periodic"):
        """One manager save of the step (and apply) programs' persistable
        state, stamped with this trainer's resume point."""
        feed_shapes = {k: tuple(int(d) for d in v.shape)
                       for k, v in (feed or {}).items() if hasattr(v, "shape")}
        self.ckpt_manager.save([self._step_program, self.apply_program], self.scope,
                               self._global_step, epoch_id=epoch_id, step_id=step_id,
                               sync=sync, feed_shapes=feed_shapes, mesh=self._mesh,
                               layout=self.layout, reason=reason)

    def _ckpt_step_actions(self, epoch_id: int, step_id: int, feed) -> bool:
        """After a step: a health-triggered rollback or save-and-exit
        first, then the periodic save.  True when the epoch loop should
        stop (save-and-exit)."""
        cfg = self.ckpt_config
        due = bool(cfg.step_interval and step_id and step_id % cfg.step_interval == 0)
        if due and self.health is not None and cfg.rollback_on_divergence \
                and not self._ckpt_rollback.is_set():
            # certify the save: every parked sentinel resolved first, so a
            # step that diverged on the card is never committed as the last
            # good checkpoint (this sync happens only at save boundaries,
            # and only with rollback armed)
            self.health.flush()
        if self._ckpt_rollback.is_set():
            # a divergence event: restore the last good checkpoint in place
            # and train on (the step counters are not rewound)
            self._ckpt_rollback.clear()
            if self.ckpt_manager.latest() is None:
                # a save from before the divergence may still be queued
                self.ckpt_manager.wait(timeout=60.0)
            if self.ckpt_manager.latest() is not None:
                self.ckpt_manager.restore([self._step_program, self.apply_program],
                                          self.scope, executor=self.exe, mesh=self._mesh,
                                          layout=self.layout, reason="rollback")
            return False
        if self._ckpt_save_exit.is_set():
            # a fetch timeout: save everything synchronously and stop
            self._ckpt_save_exit.clear()
            self._ckpt_save(epoch_id, step_id + 1, feed, sync=True, reason="fetch-timeout")
            self.stop()
            return True
        if due:
            # saved step_id + 1: a resume starts at the next step
            self._ckpt_save(epoch_id, step_id + 1, feed, reason="periodic")
        return False


class Inferencer:
    """Fluid's inferencer.py (see the module docstring).  ``param_path``
    loads a directory ``io.save_persistables`` (or ``Trainer.save_params``)
    wrote, of either package, into the startup's tensors (``copy_``)."""

    def __init__(self, infer_func: Callable, param_path: Optional[str] = None,
                 place: Optional[Place] = None, passes=None, amp=None, kernels=None,
                 validate: Optional[str] = None, memory_budget=None):
        self.scope = Scope()
        self.startup_program = Program()
        self.inference_program = Program()
        with unique_name.guard():
            with program_guard(self.inference_program, self.startup_program):
                self.predict_vars = infer_func()
                if not isinstance(self.predict_vars, (list, tuple)):
                    self.predict_vars = [self.predict_vars]
        self.exe = Executor(place, passes=passes, amp=amp, kernels=kernels,
                            validate=validate, memory_budget=memory_budget)
        self.exe.run(self.startup_program, scope=self.scope)
        if param_path:
            with scope_guard(self.scope):
                io_mod.load_persistables(self.exe, param_path, self.inference_program)
        self.feed_names = [v.name for v in self._feed_vars()]
        # table name -> embedding.RowCache serving lookup_rows()
        self._row_caches: dict = {}

    def _feed_vars(self) -> List[Variable]:
        """The program's input vars: consumed but never produced by any op,
        dense, and not parameters/persistables."""
        block = self.inference_program.global_block
        produced = {n for op in block.desc.ops for n in op.output_names() if n}
        consumed = {n for op in block.desc.ops for n in op.input_names() if n}
        out = []
        for name, var in block.vars.items():
            vd = var.desc
            if (vd.persistable or vd.is_parameter
                    or vd.type != VarType.DENSE_TENSOR):
                continue
            if name in produced or name not in consumed:
                continue
            out.append(var)
        return out

    def warmup(self, batch_sizes: Sequence[int] = (1,),
               feed_specs: Optional[dict] = None) -> List[dict]:
        """Build the executor's cache entry at each batch size
        (``Executor.precompile`` on zero feeds from the specs): on the card
        the inference program is run once and captured as a CUDA graph (a
        program that gets no graph is run once, writing no state), so a
        live request at that size pays no one-time cost (kernel library
        build and load, cuBLAS handles and workspaces, the capture).

        ``feed_specs`` maps feed name -> ``(row_shape, dtype)`` (shape
        WITHOUT the batch dim), overriding what the program's data vars
        declare -- required for ragged models, whose non-batch dims are
        dynamic (include their ``@SEQ_LEN`` channels too).  Returns one
        record per batch size: ``precompile``'s (``fingerprint``, ``kind``,
        ``compile_s``, ``aot``, ``reasons``) with ``batch_size`` and
        ``seconds`` (the whole call's).

        With the executor's ``memory_budget`` set, a batch size whose
        planned per-device peak exceeds the budget is rejected before
        anything is built for it: its record holds ``rejected=True``,
        ``code="M501"``, the error, ``predicted_peak_bytes`` and
        ``budget_bytes``."""
        from .analysis import PredictedOOMError
        specs: dict = {}
        for v in self._feed_vars():
            specs[v.name] = (tuple(v.shape)[1:], v.dtype.np_dtype)
        if feed_specs:
            specs.update({k: (tuple(s), np.dtype(d))
                          for k, (s, d) in feed_specs.items()})
        for name, (shape, _) in specs.items():
            if any(int(d) < 0 for d in shape):
                raise ValueError(
                    f"feed {name!r} has dynamic non-batch dims {shape}; "
                    f"pass feed_specs={{name: (row_shape, dtype)}} with "
                    f"concrete dims (ragged models also need their "
                    f"@SEQ_LEN channels)")
        report = []
        for bs in batch_sizes:
            feed = {n: ((int(bs),) + tuple(int(d) for d in s), d)
                    for n, (s, d) in specs.items()}
            t0 = time.perf_counter()
            try:
                info = self.exe.precompile(self.inference_program, feed=feed,
                                           fetch_list=list(self.predict_vars),
                                           scope=self.scope)
            except PredictedOOMError as e:
                info = {"rejected": True, "code": "M501", "error": str(e),
                        "predicted_peak_bytes": e.plan.peak_bytes, "budget_bytes": e.budget}
            info.update(batch_size=int(bs), seconds=time.perf_counter() - t0)
            report.append(info)
        return report

    def infer(self, inputs: dict, return_numpy: bool = True, sync: bool = True):
        """Run one prediction.  ``sync=False`` returns non-blocking
        :class:`~paddle_tpu_torch.core.staging.FetchHandle`\\ s (the serving
        engine's dispatch path)."""
        return self.exe.run(self.inference_program, feed=inputs,
                            fetch_list=list(self.predict_vars),
                            scope=self.scope, return_numpy=return_numpy,
                            sync=sync)

    # ------------------------------------------- serving embedding cache
    def attach_row_cache(self, table: str, *, budget=None, fraction: float = 0.05,
                         capacity_rows=None):
        """Put an LRU row cache (``embedding.RowCache``) in front of
        ``table`` for :meth:`lookup_rows`, its capacity keyed on the memory
        planner's budget grammar (``budget`` falls back to the executor's
        ``memory_budget``).  Returns the cache."""
        from .embedding import RowCache
        var = self.scope.find_var(table)
        if var is None:
            raise KeyError(f"no loaded parameter {table!r} to cache")
        if capacity_rows is not None:
            cache = RowCache(int(capacity_rows), table=table)
        else:
            dim = int(np.prod(var.shape[1:])) or 1
            cache = RowCache.for_table(
                int(var.shape[0]), dim, dtype=str(var.dtype).replace("torch.", ""),
                budget=budget if budget is not None else self.exe.memory_budget,
                fraction=fraction, table=table)
        self._row_caches[table] = cache
        return cache

    def lookup_rows(self, table: str, ids) -> np.ndarray:
        """Rows of parameter ``table`` at ``ids``, through the attached
        :class:`~paddle_tpu_torch.embedding.RowCache` where there is one;
        the misses (or every id, without a cache) are gathered from the
        live table where it lies (K2 on the card) and copied to the host."""
        from .ops.cuda.embedding import gather_rows
        var = self.scope.find_var(table)
        if var is None:
            raise KeyError(f"no loaded parameter {table!r}")
        ids = np.asarray(ids).reshape(-1).astype(np.int64)

        def fetch(miss_ids):
            at = torch.as_tensor(np.asarray(miss_ids, np.int32), device=var.device)
            return to_numpy(gather_rows(var.reshape(var.shape[0], -1).contiguous(), at)
                            ).reshape((len(at),) + tuple(var.shape[1:]))

        cache = self._row_caches.get(table)
        return fetch(ids) if cache is None else cache.lookup(ids, fetch)

    def row_cache_stats(self) -> dict:
        return {t: c.stats() for t, c in self._row_caches.items()}
