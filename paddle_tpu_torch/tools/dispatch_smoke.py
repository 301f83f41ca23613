#!/usr/bin/env python
"""Elastic data-dispatch chaos smoke of the port (``paddle_tpu_torch/dispatch``).

One ``DispatchMaster`` (a subprocess) serves an epoch of tasks to TWO
worker subprocesses while this parent injects the failures the subsystem
exists to survive:

* **worker death**: worker ``rank1`` runs under
  ``PADDLE_TPU_FAULTS=kill@dispatch.task_start:n=2``: it finishes its first
  task, leases a second, and SIGKILLs itself holding the lease.  The
  master's timeout sweep reaps the expired lease and re-serves the task to
  the surviving worker;
* **master death**: once a few tasks finished, the parent SIGKILLs the
  master and restarts it on a fresh port; the restarted master recovers
  every pending, leased and finished task from its committed snapshot, and
  the workers find it again through the address file.

It asserts, from the master's final committed snapshot and the workers'
delivery logs: every task FINISHED and none DEAD; ``counters.finished ==
len(tasks)``; the records delivered under each task's final lease are the
whole dataset, each once; ``lease_expiry >= 1``; the restarted master
logged a recover; ``dispatch_*.jsonl`` was written.

Modes::

    python paddle_tpu_torch/tools/dispatch_smoke.py --quick [workdir]
        # workers that import neither jax nor torch (the dispatch and
        # recordio modules load by path) consume RecordIO chunk tasks;
        # seconds, no card; the CPU test runs it
    python paddle_tpu_torch/tools/dispatch_smoke.py [--cpu] [workdir]
        # workers train through Trainer(dispatch=DispatchConfig(...)) on
        # the card (--cpu: on the CPU); the survivor must have replayed one
        # cache entry for the whole epoch (on the card: one CUDA graph)

Internal: ``master|qworker|worker <args>`` subprocess entries.
"""
from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_RECORDS = 96
PER_TASK = 8               # records a task -> 12 tasks
BATCH = 8                  # full mode: one batch a task
FEAT = 64
LEASE_S = 2.5
SWEEP_S = 0.4
KILL_AT_TASK = 2           # worker rank1 dies starting its 2nd task
MASTER_KILL_AFTER = 3      # the parent kills the master after 3 finishes


def _load_framework_free(name: str):
    """Import ``paddle_tpu_torch.<name>`` WITHOUT the package's
    ``__init__`` (which imports torch): a stand-in parent package whose
    ``__path__`` is the port's directory, so the relative imports
    (``..telemetry``, ``..faults``) resolve by path."""
    import importlib
    import types

    if "_pttfree" not in sys.modules:
        pkg = types.ModuleType("_pttfree")
        pkg.__path__ = [os.path.join(REPO, "paddle_tpu_torch")]
        sys.modules["_pttfree"] = pkg
    mod = importlib.import_module(f"_pttfree.{name}")
    leaked = [m for m in ("jax", "torch", "paddle_tpu") if m in sys.modules]
    assert not leaked, f"{leaked} imported by the framework-free {name}"
    return mod


# ---------------------------------------------------------------- master

def master_main(mode: str, workdir: str) -> int:
    dispatch = _load_framework_free("dispatch")
    if mode == "quick":
        payloads = dispatch.make_recordio_tasks([os.path.join(workdir, "data.rio")],
                                                chunks_per_task=1)
    else:
        payloads = dispatch.make_range_tasks(N_RECORDS, PER_TASK)
    m = dispatch.DispatchMaster(
        payloads, snapshot_dir=os.path.join(workdir, "snap"),
        addr_file=os.path.join(workdir, "addr"), lease_timeout_s=LEASE_S,
        sweep_interval_s=SWEEP_S, max_failures=4, backoff_base_s=0.2, backoff_cap_s=2.0)
    # serve until the epoch retires every task, then linger briefly so the
    # last worker's in-flight calls drain before the final snapshot
    while not m.queue.done:
        time.sleep(0.1)
    time.sleep(0.5)
    m.close()
    return 0


# ---------------------------------------------------------- quick worker

def qworker_main(worker_id: str, workdir: str) -> int:
    dispatch = _load_framework_free("dispatch")
    _signal_ready_and_wait_go(workdir, worker_id)
    client = dispatch.DispatchClient(addr_file=os.path.join(workdir, "addr"),
                                     worker=worker_id, retry_window_s=30.0)
    decode = lambda rec: int.from_bytes(rec, "little")  # noqa: E731
    reader = dispatch.DispatchReader(dispatch.recordio_task_reader(decode), client)
    with open(os.path.join(workdir, f"delivered_{worker_id}.jsonl"), "a", buffering=1) as log:
        for idx in reader():
            t = reader.current_task
            log.write(json.dumps({"task": t["task_id"], "lease": t["lease_id"],
                                  "index": idx}) + "\n")
    return 0


# ----------------------------------------------------------- full worker

def worker_main(worker_id: str, workdir: str, on_cpu: bool) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.dispatch import DispatchConfig

    def sample(i: int):
        rng = np.random.RandomState(1000 + i)
        return rng.rand(FEAT).astype(np.float32), np.array([i % 10], dtype=np.int64)

    log = open(os.path.join(workdir, f"delivered_{worker_id}.jsonl"), "a", buffering=1)
    cell = {}

    def batch_task_reader(payload):
        # one batch a task: the trainer sees one feed shape, so the epoch
        # is one cache entry (on the card one CUDA graph)
        start, count = int(payload["start"]), int(payload["count"])
        t = cell["reader"].current_task
        for b0 in range(start, start + count, BATCH):
            idxs = list(range(b0, min(b0 + BATCH, start + count)))
            log.write(json.dumps({"task": t["task_id"], "lease": t["lease_id"],
                                  "indices": idxs}) + "\n")
            yield [sample(i) for i in idxs]

    def train_func():
        x = pt.layers.data(name="x", shape=[FEAT], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="int64")
        h = pt.layers.fc(input=x, size=32, act="relu")
        pred = pt.layers.fc(input=h, size=10, act="softmax")
        return pt.layers.mean(pt.layers.cross_entropy(input=pred, label=y))

    losses = []

    def handler(ev):
        if isinstance(ev, pt.EndStepEvent):
            losses.append(float(np.asarray(ev.metrics[0])))

    with pt.unique_name.guard():
        t = pt.Trainer(train_func=train_func,
                       optimizer_func=lambda: pt.optimizer.Adam(learning_rate=1e-2),
                       place=pt.CPUPlace() if on_cpu else pt.CUDAPlace(0),
                       dispatch=DispatchConfig(addr_file=os.path.join(workdir, "addr"),
                                               task_reader=batch_task_reader,
                                               worker=worker_id, retry_window_s=30.0))
    cell["reader"] = t.dispatch_reader
    _signal_ready_and_wait_go(workdir, worker_id)
    t.train(num_epochs=1, event_handler=handler, reader=None, feed_order=["x", "y"])
    log.close()
    info = t.exe.cache_info()
    step_entries = [e for e in info["entries"] if "x" in e["feeds"]]
    result = {"steps": len(losses), "losses_finite": bool(np.isfinite(losses).all()),
              "entries": [e["kind"] for e in step_entries], "captures": info["captures"],
              "tasks_finished": t.dispatch_reader.tasks_finished,
              "device": "cpu" if on_cpu else torch.cuda.get_device_name(0)}
    path = os.path.join(workdir, f"result_{worker_id}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(result, f)
    os.replace(path + ".tmp", path)
    return 0


# -------------------------------------------------------------- barriers

def _signal_ready_and_wait_go(workdir: str, worker_id: str):
    open(os.path.join(workdir, f"ready_{worker_id}"), "w").close()
    go = os.path.join(workdir, "go")
    deadline = time.monotonic() + 180.0
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError("the parent never raised the go barrier")
        time.sleep(0.02)


# ---------------------------------------------------------------- parent

def _spawn(args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *args], env=env)


def _wait(proc, name, timeout=300, expect_kill=False):
    rc = proc.wait(timeout=timeout)
    if expect_kill:
        assert rc == -signal.SIGKILL, f"{name} should have died by SIGKILL, got rc={rc}"
    else:
        assert rc == 0, f"{name} failed rc={rc}"


def _assert_exactly_once(workdir, snap):
    """Every record delivered exactly once to a FINISHED task: the master's
    final snapshot joined with the workers' delivery logs."""
    tasks = {t["task_id"]: t for t in snap["tasks"]}
    assert all(t["state"] == "finished" for t in tasks.values()), \
        {tid: t["state"] for tid, t in tasks.items()}
    assert snap["counters"]["dead"] == 0, snap["counters"]
    assert snap["counters"]["finished"] == len(tasks), snap["counters"]
    delivered = {}
    for f in glob.glob(os.path.join(workdir, "delivered_*.jsonl")):
        worker = os.path.basename(f)[len("delivered_"):-len(".jsonl")]
        with open(f) as fh:
            for line in fh:
                if not line.strip():
                    continue
                r = json.loads(line)
                key = (worker, int(r["task"]), int(r["lease"]))
                idxs = r["indices"] if "indices" in r else [r["index"]]
                delivered.setdefault(key, []).extend(int(i) for i in idxs)
    seen = []
    for tid, t in tasks.items():
        key = (t["worker"], tid, t["lease_id"])
        assert key in delivered, f"task {tid}: no delivery log under its final lease {key}"
        seen.extend(delivered[key])
    assert sorted(seen) == list(range(N_RECORDS)), (
        f"exactly-once violated: {len(seen)} records delivered, {len(set(seen))} unique "
        f"(want {N_RECORDS})")


def main(argv) -> int:
    quick = "--quick" in argv
    on_cpu = "--cpu" in argv
    argv = [a for a in argv if a not in ("--quick", "--cpu")]
    if argv:
        workdir = os.path.abspath(argv[0])
    else:
        import tempfile
        workdir = tempfile.mkdtemp(prefix="paddle_tpu_torch_dispatch_smoke_")
    os.makedirs(workdir, exist_ok=True)
    tel = os.environ.get("PADDLE_TPU_TELEMETRY_DIR") or os.path.join(workdir, "telemetry")
    os.environ["PADDLE_TPU_TELEMETRY_DIR"] = tel
    os.makedirs(tel, exist_ok=True)
    mode = "quick" if quick else "full"
    dispatch = _load_framework_free("dispatch")
    scanned = None
    if quick:
        # N_RECORDS records of little-endian indices, in chunks of PER_TASK
        # records (each 4 + 8 bytes), so each chunk is one task; read back
        # once with the default scanner (native where g++ built it)
        recordio = _load_framework_free("recordio")
        rio = os.path.join(workdir, "data.rio")
        with recordio.Writer(rio, max_chunk_bytes=PER_TASK * 12) as w:
            for i in range(N_RECORDS):
                w.write(i.to_bytes(8, "little"))
        assert [int.from_bytes(r, "little") for r in recordio.scan(rio)] == \
            list(range(N_RECORDS))
        scanned = recordio.scans()

    master = _spawn(["master", mode, workdir])
    # both workers pace their reads through the faults layer (a delay a
    # yielded record or batch), so the kill and the master restart land
    # mid-epoch
    stall = "delay@dispatch.read:s=0.02" if quick else "delay@dispatch.read:s=0.25"
    entry = "qworker" if quick else "worker"
    extra = ["--cpu"] if on_cpu and not quick else []
    wa = _spawn([entry, "rank0", workdir, *extra], env_extra={"PADDLE_TPU_FAULTS": stall})
    wb = _spawn([entry, "rank1", workdir, *extra], env_extra={
        "PADDLE_TPU_FAULTS": f"{stall};kill@dispatch.task_start:n={KILL_AT_TASK}"})
    procs = [master, wa, wb]
    try:
        deadline = time.monotonic() + 240
        while not all(os.path.exists(os.path.join(workdir, f"ready_{w}"))
                      for w in ("rank0", "rank1")):
            assert time.monotonic() < deadline, "workers never initialized"
            assert wa.poll() is None and wb.poll() is None, "a worker died before the go barrier"
            time.sleep(0.1)
        open(os.path.join(workdir, "go"), "w").close()

        client = dispatch.DispatchClient(addr_file=os.path.join(workdir, "addr"),
                                         worker="parent", retry_window_s=30.0)
        deadline = time.monotonic() + 240
        while client.stats()["counters"]["finished"] < MASTER_KILL_AFTER:
            assert time.monotonic() < deadline, "no progress before the master kill"
            time.sleep(0.05)
        client.close()
        master.kill()            # SIGKILL: no final snapshot
        master.wait(timeout=30)
        master2 = _spawn(["master", mode, workdir])
        procs.append(master2)

        _wait(wb, "worker rank1", expect_kill=True)
        _wait(wa, "worker rank0")
        _wait(master2, "restarted master", timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    snap = dispatch.load_snapshot(os.path.join(workdir, "snap"))
    assert snap is not None, "no committed final snapshot"
    _assert_exactly_once(workdir, snap)
    assert snap["counters"]["lease_expiry"] >= 1 or snap["counters"]["worker_reaps"] >= 1, \
        snap["counters"]
    recs = []
    for f in glob.glob(os.path.join(tel, "dispatch_*.jsonl")):
        with open(f) as fh:
            recs.extend(json.loads(x) for x in fh if x.strip())
    assert recs, f"no dispatch_*.jsonl under {tel}"
    assert any(r.get("event") == "recover" for r in recs), "the restarted master logged no recover"

    out = {"dispatch_smoke": "PASS", "mode": mode, "tasks": len(snap["tasks"]),
           "counters": snap["counters"], "workdir": workdir}
    if quick:
        out["scanned"] = scanned
    else:
        with open(os.path.join(workdir, "result_rank0.json")) as f:
            survivor = json.load(f)
        want = ["eager"] if on_cpu else ["graph"]
        assert survivor["entries"] == want and survivor["losses_finite"], survivor
        assert survivor["steps"] >= survivor["tasks_finished"] >= 1, survivor
        out["survivor"] = survivor
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "master":
        sys.exit(master_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) > 1 and sys.argv[1] == "qworker":
        sys.exit(qworker_main(sys.argv[2], sys.argv[3]))
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        sys.exit(worker_main(sys.argv[2], sys.argv[3], "--cpu" in sys.argv[4:]))
    sys.exit(main(sys.argv[1:]))
