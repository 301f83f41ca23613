"""The port's ``Trainer`` on the CPU against the JAX package's.

A 2+2-layer ``train_network(fuse_final_ce=True)`` (vocab 1000, d_model 64,
4 heads, d_inner 256, max_len 32, batch 4: bench.py's CPU shape) is built
by both packages' ``Trainer`` under ``unique_name.guard()``; the JAX
startup's state is copied into the port trainer's own tensors (``copy_``,
no rebind), and both train 2 epochs of 3 batches from one seeded reader
(source lengths in [17, 32], so the pow2 default pads them to 32).  The
event sequences must be equal, the losses within ``LOSS_RTOL`` and the
parameters within the Adam bound below (``SGD`` likewise, so K5's CPU body
runs).  Then the port alone: ``pipeline=True`` against ``False``
bit-equal, a partial last batch, serial-dir checkpoint rotation, a
resume whose losses are bit-equal to the run without the stop,
``stop()``, the options that work under a mesh (a world of one), and the
step records' keys (which ``tools/stats.py`` reads).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import telemetry as jax_telemetry
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch import telemetry as pt_telemetry
from paddle_tpu_torch.models import transformer as pt_transformer

import _torch_mesh_ranks as R
from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER, BATCH = 1000, 64, 4, 256, 32, 2, 4
EPOCHS, BATCHES = 2, 3
ADAM_LR, SGD_LR = 1e-3, 0.1
FEED_ORDER = ["src", "trg", "lbl"]
# tests/test_torch_training.py's gates.  Losses: XLA and torch sum in other
# orders.  Parameters: each Adam update differs from the jitted JAX one in
# the last bits (tests/test_torch_faults.py: within 2e-7 relative, from
# XLA's fused multiply-add), and the gradients that follow carry it on; the
# training tests' per-element gate holds both optimizers (read here after 6
# steps: Adam at most 1.5e-5 abs, SGD 1.2e-7, against 5e-5 + 1e-4 |p|; the
# losses 1.5e-7 relative).
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4


def _train_func(pkg, mod):
    def train_func():
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                                    d_model=D_MODEL, n_head=N_HEAD, d_inner=D_INNER,
                                    fuse_final_ce=True)
        return loss
    return train_func


def _optimizer(pkg, sgd):
    return (lambda: pkg.optimizer.SGD(learning_rate=SGD_LR)) if sgd else \
        (lambda: pkg.optimizer.Adam(learning_rate=ADAM_LR))


def _samples(n=BATCHES * BATCH, seed=0):
    """A seeded sample reader: (src [n_i, 1], trg [T, 1], lbl [T, 1]) int64,
    n_i in [17, T]."""
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            yield (rs.randint(1, VOCAB, (rs.randint(17, T + 1), 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64))
    return reader


def _jax_trainer(sgd=False, **kw):
    with fluid.unique_name.guard():
        return fluid.Trainer(_train_func(fluid, jax_transformer), _optimizer(fluid, sgd), **kw)


def _pt_trainer(sgd=False, **kw):
    with pt.unique_name.guard():
        return pt.Trainer(_train_func(pt, pt_transformer), _optimizer(pt, sgd),
                          place=pt.CPUPlace(), **kw)


def _persistables(trainer):
    return [v.name for v in trainer.train_program.list_vars() if v.persistable]


def _carry(arrays, trainer):
    """Copy ``name -> array`` into the trainer's own scope tensors (no
    rebind: their addresses stay)."""
    for n, a in arrays.items():
        t = trainer.scope.find_var(n)
        ptr = t.data_ptr()
        t.copy_(torch.from_numpy(np.array(a)).reshape(t.shape))
        assert t.data_ptr() == ptr


def _state(trainer):
    return {n: trainer.scope.find_var(n).clone() for n in _persistables(trainer)}


class _Recorder:
    """An event handler: the (event, epoch, step) sequence and the losses."""

    def __init__(self, stop_at=None, trainer=None):
        self.events, self.losses = [], []
        self.stop_at, self.trainer = stop_at, trainer

    def __call__(self, ev):
        self.events.append((type(ev).__name__, ev.epoch, getattr(ev, "step", None)))
        if type(ev).__name__ == "EndStepEvent":
            self.losses.append(float(np.asarray(ev.metrics[0])))
            if self.stop_at == (ev.epoch, ev.step):
                self.trainer.stop()


def _train(trainer, epochs=EPOCHS, reader=None, batch=pt.batch, **kw):
    rec = _Recorder(**kw)
    if kw.get("stop_at") is not None:
        rec.trainer = trainer
    trainer.train(epochs, rec, reader=batch(reader or _samples(), BATCH), feed_order=FEED_ORDER)
    return rec


@pytest.fixture(scope="module", params=["adam", "sgd"])
def runs(request):
    """Both packages' Trainers over the same batches from the JAX startup's
    state: events, losses, final parameters; and the port's pipelined run
    against a synchronous one from the same state."""
    sgd = request.param == "sgd"
    jtr = _jax_trainer(sgd)
    start = {n: np.asarray(jtr.scope.find_var(n)) for n in _persistables(jtr)}
    ttr = _pt_trainer(sgd)
    addrs = {n: ttr.scope.find_var(n).data_ptr() for n in start}
    _carry(start, ttr)
    jrec = _train(jtr, batch=fluid.batch)
    trec = _train(ttr)
    sync = _pt_trainer(sgd, pipeline=False)
    _carry(start, sync)
    srec = _train(sync)
    params = [p.name for p in ttr.train_program.global_block.all_parameters()]
    return dict(sgd=sgd, jax=(jtr, jrec), pt=(ttr, trec), sync=(sync, srec), params=params,
                start=start, addrs=addrs)


def test_event_sequences_equal_the_jax_trainers(runs):
    (_, jrec), (_, trec) = runs["jax"], runs["pt"]
    want = []
    for e in range(EPOCHS):
        want += [("BeginEpochEvent", e, None)]
        for s in range(BATCHES):
            want += [("BeginStepEvent", e, s), ("EndStepEvent", e, s)]
        want += [("EndEpochEvent", e, None)]
    assert jrec.events == want and trec.events == want


def test_losses_within_the_jax_trainers(runs):
    (_, jrec), (_, trec) = runs["jax"], runs["pt"]
    assert len(trec.losses) == EPOCHS * BATCHES and np.isfinite(trec.losses).all()
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=LOSS_RTOL, atol=0)


def test_parameters_within_the_jax_trainers(runs):
    (jtr, _), (ttr, _) = runs["jax"], runs["pt"]
    for n in runs["params"]:
        ref = np.asarray(jtr.scope.find_var(n))
        got = ttr.scope.find_var(n).numpy()
        tol = PARAM_ATOL + PARAM_RTOL * np.abs(ref)
        assert (np.abs(got - ref) <= tol).all(), (n, float(np.abs(got - ref).max()))
    unchanged = [n for n in runs["params"] if np.array_equal(runs["start"][n],
                                                              ttr.scope.find_var(n).numpy())]
    assert not unchanged


def test_pipelined_and_synchronous_runs_bit_equal(runs):
    (ttr, trec), (sync, srec) = runs["pt"], runs["sync"]
    assert srec.losses == trec.losses and srec.events == trec.events
    for n in _persistables(ttr):
        assert torch.equal(ttr.scope.find_var(n), sync.scope.find_var(n)), n


def test_pipelined_metrics_are_fetch_handles_and_state_stays_in_place(runs):
    ttr, _ = runs["pt"]
    assert all(ttr.scope.find_var(n).data_ptr() == p for n, p in runs["addrs"].items())
    got = []
    ttr.train(1, lambda ev: got.append(ev.metrics) if isinstance(ev, pt.EndStepEvent) else None,
              reader=pt.batch(_samples(BATCH), BATCH), feed_order=FEED_ORDER)
    (metrics,) = got
    assert type(metrics[0]).__name__ == "FetchHandle" and np.isfinite(float(metrics[0]))


def test_a_partial_last_batch_runs_as_in_the_jax_trainer():
    n = BATCHES * BATCH + 2          # the last batch has 2 rows
    jtr = _jax_trainer()
    start = {k: np.asarray(jtr.scope.find_var(k)) for k in _persistables(jtr)}
    ttr = _pt_trainer()
    _carry(start, ttr)
    jrec = _train(jtr, epochs=1, reader=_samples(n), batch=fluid.batch)
    trec = _train(ttr, epochs=1, reader=_samples(n))
    assert len(trec.losses) == BATCHES + 1 and trec.events == jrec.events
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=LOSS_RTOL, atol=0)
    feeds = [e["feeds"]["lbl"][0][0] for e in ttr.exe.cache_info()["entries"]
             if "lbl" in e["feeds"]]
    assert feeds == [BATCH, 2]       # one entry for each batch size


def test_checkpoint_serial_dirs_rotate(tmp_path):
    cfg = pt.CheckpointConfig(str(tmp_path), max_num_checkpoints=2, step_interval=1)
    ttr = _pt_trainer(checkpoint_config=cfg)
    _train(ttr)
    # saves: after steps 1 and 2 of each epoch and after each epoch: 6
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_4", "checkpoint_5"]
    states = [json.load(open(tmp_path / d / "trainer_state.json"))
              for d in ("checkpoint_4", "checkpoint_5")]
    assert states == [{"epoch_id": 1, "step_id": 3}, {"epoch_id": 2, "step_id": 0}]
    assert {"__params__.npz", "manifest.json"} <= set(os.listdir(tmp_path / "checkpoint_5"))


@pytest.mark.parametrize("pipeline", [True, False])
def test_a_resume_repeats_the_uninterrupted_runs_losses_bit_for_bit(tmp_path, pipeline):
    base = _pt_trainer(pipeline=pipeline)
    start = {n: v.numpy().copy() for n, v in _state(base).items()}
    full = _train(base)
    cfg = pt.CheckpointConfig(str(tmp_path), step_interval=1)
    first = _pt_trainer(pipeline=pipeline, checkpoint_config=cfg)
    _carry(start, first)
    cut = _train(first, stop_at=(0, 1))
    # stop() after step 1: step 2 and the epoch's end never come
    assert cut.events[-1] == ("EndStepEvent", 0, 1) and cut.losses == full.losses[:2]
    resumed_trainer = _pt_trainer(pipeline=pipeline,
                                  checkpoint_config=pt.CheckpointConfig(str(tmp_path),
                                                                        step_interval=1))
    assert resumed_trainer._ckpt_state == {"epoch_id": 0, "step_id": 2}
    resumed = _train(resumed_trainer)
    assert resumed.events[:3] == [("BeginEpochEvent", 0, None), ("BeginStepEvent", 0, 2),
                                  ("EndStepEvent", 0, 2)]
    assert resumed.losses == full.losses[2:]
    for n, v in _state(base).items():
        assert torch.equal(v, resumed_trainer.scope.find_var(n)), n


def test_stop_ends_training_after_the_current_step():
    ttr = _pt_trainer()
    rec = _train(ttr, stop_at=(0, 0))
    assert rec.events == [("BeginEpochEvent", 0, None), ("BeginStepEvent", 0, 0),
                          ("EndStepEvent", 0, 0)]


def test_begin_step_event_can_skip_the_metrics():
    ttr = _pt_trainer(pipeline=False)
    got = []

    def handler(ev):
        if isinstance(ev, pt.BeginStepEvent):
            ev.fetch_metrics = ev.step != 1
        elif isinstance(ev, pt.EndStepEvent):
            got.append(len(ev.metrics))
    ttr.train(1, handler, reader=pt.batch(_samples(), BATCH), feed_order=FEED_ORDER)
    assert got == [1, 0, 1]


@pytest.mark.parametrize("option,value,item", [
    ("checkpoint", True, "12c"), ("checkpoint_config", "cfg", "12c"), ("health", True, "12c")])
def test_options_not_ported_raise_naming_their_roadmap_item(option, value, item, tmp_path):
    """The options that waited for ROADMAP item 12c under a mesh now work
    (here on a world of one; two ranks in tests/test_torch_mesh_checkpoint.py):
    each trains a batch on the ``{"data": 1}`` mesh and does its part --
    a manifest checkpoint recording the mesh that a new Trainer resumes
    bit-equal, a serial dir of the whole values, a clean health record."""
    from paddle_tpu_torch import health
    from paddle_tpu_torch.checkpoint import CheckpointConfig as AsyncConfig
    from paddle_tpu_torch.checkpoint import checkpoint_dir, read_manifest
    if option == "checkpoint":
        value = AsyncConfig(dir=str(tmp_path), epoch_interval=1, async_save=False)
    elif value == "cfg":
        value = pt.CheckpointConfig(checkpoint_dir=str(tmp_path))
    with R.world_of_one() as mesh:
        ttr = _pt_trainer(mesh=mesh, pipeline=False, **{option: value})
        assert ttr.exe.mesh is mesh
        rec = _train(ttr, epochs=1, reader=_samples(BATCH))
        assert len(rec.losses) == 1 and np.isfinite(rec.losses[0])
        state = {n: v.full_tensor() for n, v in _state(ttr).items()}
        if option == "checkpoint":
            man = read_manifest(checkpoint_dir(str(tmp_path), ttr.ckpt_manager.latest()))
            assert man["mesh"] == {"axes": {"data": 1}} and list(man["shards"]) == ["0"]
            resumed = _pt_trainer(mesh=mesh, pipeline=False, **{option: value})
            for n, v in state.items():
                got = resumed.scope.find_var(n)
                assert got.placements == ttr.scope.find_var(n).placements
                assert torch.equal(got.full_tensor().reshape(v.shape), v), n
        elif option == "checkpoint_config":
            d = tmp_path / "checkpoint_0"
            with np.load(d / "__params__.npz") as z:
                for n, v in state.items():
                    np.testing.assert_array_equal(z[n].reshape(v.shape), v.numpy(), err_msg=n)
        else:
            steps = [r for r in health.HEALTH_RECORDS.records() if r.get("kind") == "step"]
            assert steps[-1]["ok"] is True and np.isfinite(steps[-1]["grad_norm"])


def test_train_without_a_reader_raises():
    ttr = _pt_trainer()
    with pytest.raises(ValueError, match="dispatch"):
        ttr.train(1, lambda ev: None, feed_order=FEED_ORDER)


def test_step_records_carry_the_jax_trainers_keys(tmp_path, monkeypatch):
    keys = []
    for name, tel, make, batch in (("jax", jax_telemetry, _jax_trainer, fluid.batch),
                                   ("pt", pt_telemetry, _pt_trainer, pt.batch)):
        d = tmp_path / name
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(d))
        monkeypatch.setattr(tel, "STEPS", tel.StepTelemetry())
        trainer = make()
        _train(trainer, epochs=1, reader=_samples(2 * BATCH), batch=batch)
        (path,) = list(d.glob("steps_*.jsonl"))
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        assert [(r["epoch"], r["step"], r["examples"]) for r in recs] == [(0, 0, BATCH),
                                                                          (0, 1, BATCH)]
        assert all(r["pipeline"] is True and r["step_time_s"] > 0 for r in recs)
        keys.append(sorted(recs[0]))
    assert keys[0] == keys[1]
    # tools/stats.py reads the port's records unedited
    out = subprocess.run([sys.executable, str(REPO / "tools" / "stats.py"), str(tmp_path / "pt"),
                          "--json"], capture_output=True, text=True, timeout=60, check=True)
    summary = json.loads(out.stdout)
    assert summary["steps"] == 2 and summary["examples"] == 2 * BATCH
