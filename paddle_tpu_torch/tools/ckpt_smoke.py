#!/usr/bin/env python
"""Kill-mid-epoch resume proof of the port's async checkpointing, as three
subprocess runs of one small MLP under ``Trainer(checkpoint=
CheckpointConfig(...))`` (the JAX package's ``tools/ckpt_smoke.py``,
ported):

* ``full``   -- uninterrupted: 1 epoch, its per-step losses recorded;
* ``kill``   -- the same run, SIGKILLed mid-epoch after an async
  checkpoint committed and before the epoch ends;
* ``resume`` -- a fresh process resumes from the latest committed
  checkpoint and finishes the epoch.

Checks: the resumed losses are bit-identical to the uninterrupted run's
at every resumed step (parameters, Adam's slots and the generator round
trip exactly, copied into the startup's tensors), the resume started at
the step after the last committed save, the survivor checkpoint
validates (``tools/ckpt_tool.py --validate``, free of jax and torch), and
``checkpoint_<pid>.jsonl`` records were written.  The JAX tool's "zero
fresh compiles" has no counterpart: the port keeps no persistent cache
of its executables.

Usage:  python paddle_tpu_torch/tools/ckpt_smoke.py [--cpu] [workdir]
        python paddle_tpu_torch/tools/ckpt_smoke.py worker <full|kill|resume> <cpu|cuda> <workdir>
Runs on the card unless ``--cpu``.  Exit 0 on pass; the last line is a
JSON summary.
"""
import glob
import json
import os
import signal
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 12
BATCH = 16
SAVE_EVERY = 4          # checkpoints after steps 4 and 8
KILL_AT = 7             # die between checkpoints, mid-epoch


def worker(mode: str, place: str, workdir: str) -> int:
    sys.path.insert(0, REPO)
    import numpy as np

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.checkpoint import CheckpointConfig

    ckpt_dir = os.path.join(workdir, "ckpt_full" if mode == "full" else "ckpt")

    def train_func():
        x = layers.data(name="x", shape=[64], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="int64")
        h = layers.fc(input=x, size=32, act="relu")
        pred = layers.fc(input=h, size=10, act="softmax")
        return layers.mean(layers.cross_entropy(input=pred, label=y))

    def opt_func():
        return pt.optimizer.Adam(learning_rate=1e-2)

    def reader():
        rng = np.random.RandomState(11)
        for _ in range(STEPS):
            xs = rng.rand(BATCH, 64).astype(np.float32)
            ys = rng.randint(0, 10, (BATCH, 1)).astype(np.int64)
            yield [(xv, yv) for xv, yv in zip(xs, ys)]

    losses = {}
    cell = {}

    def handler(ev):
        if isinstance(ev, pt.EndStepEvent):
            losses[ev.step] = float(np.asarray(ev.metrics[0]))
            if mode == "kill" and ev.step == KILL_AT:
                # the step-4 async save committed first (at these step
                # times the kill would outrun the writer), then the hard
                # death: no atexit, no stream drained; steps 5..KILL_AT
                # are lost and retrained on resume
                cell["t"].ckpt_manager.wait(timeout=60)
                _dump(workdir, mode, losses, None)
                os.kill(os.getpid(), signal.SIGKILL)

    with pt.unique_name.guard():
        t = cell["t"] = pt.Trainer(
            train_func=train_func, optimizer_func=opt_func,
            place=pt.CPUPlace() if place == "cpu" else pt.CUDAPlace(0),
            checkpoint=CheckpointConfig(dir=ckpt_dir, step_interval=SAVE_EVERY,
                                        epoch_interval=0, async_save=True))
    t.train(num_epochs=1, event_handler=handler, reader=reader, feed_order=["x", "y"])
    info = t.exe.cache_info()
    _dump(workdir, mode, losses, {"compiles": info["compile_count"],
                                  "resumed_from_step": t._ckpt_state["step_id"]})
    return 0


def _dump(workdir, mode, losses, compiles):
    path = os.path.join(workdir, f"result_{mode}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"losses": {str(k): v for k, v in losses.items()}, "compiles": compiles}, f)
    os.replace(tmp, path)


def _spawn(mode: str, place: str, workdir: str, expect_kill: bool = False):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.setdefault("PADDLE_TPU_TELEMETRY_DIR", os.path.join(workdir, "telemetry"))
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "worker", mode, place,
                        workdir], env=env, capture_output=True, text=True, timeout=300)
    if expect_kill:
        assert p.returncode == -signal.SIGKILL, (
            f"{mode} run should have died by SIGKILL, got {p.returncode}:\n{p.stderr[-2000:]}")
    else:
        assert p.returncode == 0, f"{mode} run failed rc={p.returncode}:\n{p.stderr[-3000:]}"
    with open(os.path.join(workdir, f"result_{mode}.json")) as f:
        return json.load(f)


def main(argv) -> int:
    import tempfile

    place = "cpu" if "--cpu" in argv else "cuda"
    rest = [a for a in argv if a != "--cpu"]
    workdir = rest[0] if rest else tempfile.mkdtemp(prefix="paddle_tpu_torch_ckpt_smoke_")
    os.makedirs(workdir, exist_ok=True)
    tel = os.environ.get("PADDLE_TPU_TELEMETRY_DIR") or os.path.join(workdir, "telemetry")
    os.environ["PADDLE_TPU_TELEMETRY_DIR"] = tel
    os.makedirs(tel, exist_ok=True)

    full = _spawn("full", place, workdir)
    assert len(full["losses"]) == STEPS, full
    killed = _spawn("kill", place, workdir, expect_kill=True)
    assert len(killed["losses"]) == KILL_AT + 1, killed
    resumed = _spawn("resume", place, workdir)
    resume_step = resumed["compiles"]["resumed_from_step"]
    assert resume_step == SAVE_EVERY + 1, resumed       # saved after step 4 -> resume at 5
    mismatch = [(k, full["losses"][k], v) for k, v in resumed["losses"].items()
                if full["losses"][k] != v]
    assert not mismatch, f"the loss series diverged after the resume: {mismatch}"
    assert len(resumed["losses"]) == STEPS - resume_step, resumed
    val = subprocess.run([sys.executable, os.path.join(REPO, "tools", "ckpt_tool.py"),
                          os.path.join(workdir, "ckpt"), "--validate", "--json"],
                         capture_output=True, text=True, timeout=60)
    assert val.returncode == 0, val.stdout + val.stderr
    vres = json.loads(val.stdout)
    assert vres["valid"] and vres["vars"] >= 8, vres
    assert glob.glob(os.path.join(tel, "checkpoint_*.jsonl")), f"no checkpoint_*.jsonl under {tel}"
    print(json.dumps({"ckpt_smoke": "PASS", "place": place, "steps": STEPS,
                      "killed_at": KILL_AT, "resumed_from": resume_step,
                      "resumed_steps": len(resumed["losses"]),
                      "compiles_on_resume": resumed["compiles"]["compiles"],
                      "checkpoint_validated": vres["valid"], "workdir": workdir}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        sys.exit(worker(sys.argv[2], sys.argv[3], sys.argv[4]))
    sys.exit(main(sys.argv[1:]))
