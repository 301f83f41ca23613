#!/usr/bin/env python
"""One process of a parameter-server cluster of the port: a pserver or a
trainer, built from the same model and ``DistributeTranspiler`` call in
every process (the counterpart of the JAX package's
``tests/dist_ps_runner.py``; the reference's localhost-subprocess pattern,
test_dist_base.py:166-216).

    python paddle_tpu_torch/tools/pserver_runner.py pserver <endpoint> <trainers> <ready_file>
    python paddle_tpu_torch/tools/pserver_runner.py trainer <endpoints> <trainers> <trainer_id>

    options: --model {mlp,transformer,table}   (default mlp)
             --endpoints a,b   every pserver's endpoint (a pserver's own by default)
             --cpu             run on the CPU (default: CUDAPlace(0))
             --out FILE        the JSON record written on exit
             --steps N         (trainers) the steps to take

A pserver serves (``Executor.run_pserver``) until it gets SIGINT or
SIGTERM, then writes its record: its rounds' apply seconds, the payload
bytes each way, its kernels' launch counts (in all and after each round)
and, on the card, each round's device busy milliseconds
(``_DeviceRounds``).  A trainer takes ``--steps`` steps on its share of
each seeded global batch (``ROWS[model]`` rows, seed ``SEED + step``;
rows ``trainer_id * ROWS / trainers`` on) and writes its losses, each
step's host stages (``Executor.last_host_stages``), a digest of the
parameters it received each step and its launch counts.  The models are
the MLP of ``tests/test_dist_pserver.py``, transformer-base's training
step (``bench.py``'s, float32, ``fuse_final_ce=True``, Adam 1e-3, 6+6
layers) and the distributed lookup table of
``tests/test_dist_lookup_table.py`` at Criteo's largest field (a
[10,131,227, 16] table, 2,048 Zipf ids a batch, SGD 0.1).
"""
import argparse
import hashlib
import json
import os
import signal
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

# transformer-base (bench.py's training step)
VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER = 32000, 512, 8, 2048, 256, 6
# the distributed lookup table at Criteo's largest field
TABLE_ROWS, TABLE_DIM, TABLE_IDS, TABLE_LR = 10131227, 16, 2048, 0.1
# each model's global batch rows, and the seed of step 0's batch
ROWS = {"mlp": 16, "transformer": 64, "table": TABLE_IDS}
SEED = 7


def build(pt, model: str, is_distributed: bool = True):
    """(main, startup, loss) of ``model``, built under ``unique_name.guard``."""
    from paddle_tpu_torch import layers
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        if model == "mlp":
            x = layers.data(name="x", shape=[5], dtype="float32")
            y = layers.data(name="y", shape=[1], dtype="float32")
            h = layers.fc(input=x, size=8, act="relu", param_attr=pt.ParamAttr(name="w1"),
                          bias_attr=pt.ParamAttr(name="b1"))
            pred = layers.fc(input=h, size=1, param_attr=pt.ParamAttr(name="w2"),
                             bias_attr=pt.ParamAttr(name="b2"))
            loss = layers.mean(layers.square_error_cost(input=pred, label=y))
            pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
        elif model == "transformer":
            from paddle_tpu_torch.models import transformer
            src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
            trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
            lbl = layers.data(name="lbl", shape=[T, 1], dtype="int64")
            loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                                n_layer=N_LAYER, d_model=D_MODEL,
                                                n_head=N_HEAD, d_inner=D_INNER,
                                                fuse_final_ce=True)
            pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        elif model == "table":
            ids = layers.data(name="ids", shape=[1], dtype="int64")
            label = layers.data(name="label", shape=[1], dtype="float32")
            emb = layers.embedding(ids, size=[TABLE_ROWS, TABLE_DIM],
                                   is_distributed=is_distributed)
            emb = layers.reshape(emb, shape=[-1, TABLE_DIM])
            pred = layers.fc(input=emb, size=1)
            loss = layers.mean(layers.square_error_cost(input=pred, label=label))
            pt.optimizer.SGD(learning_rate=TABLE_LR).minimize(loss)
        else:
            raise ValueError(f"unknown model {model!r}")
    return main, startup, loss


def global_feed(model: str, rows: int, seed: int) -> dict:
    """The seeded global batch of one step (``rows`` rows)."""
    rs = np.random.RandomState(seed)
    if model == "mlp":
        x = rs.rand(rows, 5).astype(np.float32)
        return {"x": x, "y": (2.0 * x.sum(1, keepdims=True) - 1.0).astype(np.float32)}
    if model == "transformer":
        feed = {}
        for name in ("src", "trg"):
            lens = rs.randint(128, T + 1, rows).astype(np.int32)
            ids = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
            ids[np.arange(T)[None, :] >= lens[:, None]] = 0
            feed[name], feed[name + "@SEQ_LEN"] = ids, lens
        feed["lbl"] = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
        return feed
    ids = ((rs.zipf(1.1, rows) - 1) % TABLE_ROWS).astype(np.int64).reshape(rows, 1)
    return {"ids": ids, "label": rs.rand(rows, 1).astype(np.float32)}


def share(feed: dict, trainer_id: int, trainers: int) -> dict:
    """Trainer ``trainer_id``'s rows of a global batch."""
    rows = next(iter(feed.values())).shape[0]
    per = rows // trainers
    return {k: v[trainer_id * per:(trainer_id + 1) * per] for k, v in feed.items()}


def transpile(pt, main, startup, endpoints, trainers, trainer_id):
    from paddle_tpu_torch.transpiler import DistributeTranspiler
    t = DistributeTranspiler()
    t.transpile(trainer_id=trainer_id, program=main, pservers=",".join(endpoints),
                trainers=trainers, startup_program=startup)
    return t


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by ``<wrapper>[.bf16]``."""
    from paddle_tpu_torch.ops.cuda.build import launch_counters
    return {w.__name__ + ("" if a == "launches" else ".bf16"): getattr(w, a)
            for w, a in launch_counters()}


def params_digest(scope, names) -> str:
    """sha1 of the named parameters' bytes, in name order."""
    h = hashlib.sha1()
    for n in sorted(n for n in names if scope.find_var(n) is not None):
        h.update(scope.find_var(n).to("cpu").contiguous().numpy().tobytes())
    return h.hexdigest()


def _write(path, record):
    if path:
        with open(path + ".tmp", "w") as f:
            json.dump(record, f)
        os.replace(path + ".tmp", path)


class _DeviceRounds:
    """The device time of a pserver on the card, round by round:
    ``torch.profiler``'s records of the card's kernels and copies, cut by a
    spin kernel launched at the start and as each round ends.  The interval
    of round n runs from the end of round n - 1 to its own end: the
    trainers' fetches of the parameters, their gradients' copies to the
    card and the round's updates.  ``finish`` gives each round's busy
    milliseconds (the union of its records, the marks left out) and the
    interval after the last round's."""

    MARK = "spin_kernel"

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        # the card's activity tracing starts a little after the profiler
        torch.cuda.synchronize()
        time.sleep(0.2)
        self.mark()

    def mark(self):
        self.torch.cuda._sleep(1000)

    def finish(self, rounds: int) -> dict:
        from torch.autograd import DeviceType
        self.mark()
        self.torch.cuda.synchronize()
        time.sleep(0.05)
        self.prof.stop()
        events = sorted((e.start_ns(), e.end_ns(), self.MARK in e.name())
                        for e in self.prof.profiler.kineto_results.events()
                        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
        marks = [start for start, _, is_mark in events if is_mark]
        if len(marks) != rounds + 2:
            # the trace lost a mark: the rounds cannot be told apart
            return {"round_device_ms": None, "marks": len(marks)}
        busy = [0] * (rounds + 1)
        end = 0
        for start, stop, is_mark in events:
            if is_mark or not marks[0] <= start < marks[-1]:
                continue
            i = sum(1 for m in marks[1:-1] if m <= start)
            busy[i] += max(0, stop - max(start, end))
            end = max(end, stop)
        return {"round_device_ms": [b / 1e6 for b in busy[:rounds]],
                "after_rounds_device_ms": busy[rounds] / 1e6}


def run_pserver(args) -> int:
    import torch

    import paddle_tpu_torch as pt
    place = pt.CPUPlace() if args.cpu else pt.CUDAPlace(0)
    endpoints = args.endpoints.split(",") if args.endpoints else [args.endpoint]
    main, startup, _ = build(pt, args.model)
    t = transpile(pt, main, startup, endpoints, args.trainers, 0)
    prog = t.get_pserver_program(args.endpoint)
    exe = pt.Executor(place)
    scope = pt.Scope()
    exe.run(t.get_startup_program(args.endpoint, prog), scope=scope)
    after_round = []
    record = {"role": "pserver", "endpoint": args.endpoint, "model": args.model,
              "params": prog._pserver_meta["params"], "launches_after_round": after_round}

    trace = None if args.cpu else _DeviceRounds(torch)

    def on_round(n):
        after_round.append(launch_counts())
        if trace is not None:
            trace.mark()

    def stop(signum, frame):
        # the first SIGINT or SIGTERM stops serving; later ones are ignored
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise KeyboardInterrupt
    signal.signal(signal.SIGINT, stop)
    signal.signal(signal.SIGTERM, stop)
    record["launches_before"] = launch_counts()
    exe.run_pserver(prog, scope=scope, ready_file=args.ready_file, on_round=on_round)
    record.update(exe.pserver.stats(), launches=launch_counts())
    if trace is not None:
        record.update(trace.finish(record["rounds"]))
    _write(args.out, record)
    return 0


def run_trainer(args) -> int:
    import torch

    import paddle_tpu_torch as pt
    place = pt.CPUPlace() if args.cpu else pt.CUDAPlace(0)
    if not args.cpu:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    endpoints = args.endpoint.split(",")
    main, startup, loss = build(pt, args.model)
    t = transpile(pt, main, startup, endpoints, args.trainers, args.trainer_id)
    prog = t.get_trainer_program()
    recv_names = [op.output("Out")[0] for op in prog.desc.block(0).ops if op.type == "recv"]
    exe = pt.Executor(place)
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    record = {"role": "trainer", "trainer_id": args.trainer_id, "model": args.model,
              "losses": [], "stages": [], "digests": [], "step_s": []}
    before = launch_counts()
    for step in range(args.steps):
        feed = share(global_feed(args.model, ROWS[args.model], SEED + step), args.trainer_id,
                     args.trainers)
        t0 = time.perf_counter()
        (lv,) = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        record["step_s"].append(time.perf_counter() - t0)
        record["losses"].append(float(lv))
        record["stages"].append(dict(exe.last_host_stages))
        record["digests"].append(params_digest(scope, recv_names))
    after = launch_counts()
    record["launches"] = {k: after[k] - before[k] for k in after}
    _write(args.out, record)
    print("TRAINER_LOSSES " + json.dumps(record["losses"]), flush=True)
    return 0


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("role", choices=["pserver", "trainer"])
    p.add_argument("endpoint", help="pserver: its endpoint; trainer: every endpoint, a,b")
    p.add_argument("trainers", type=int)
    p.add_argument("last", help="pserver: the ready file; trainer: its trainer id")
    p.add_argument("--model", choices=["mlp", "transformer", "table"], default="mlp")
    p.add_argument("--endpoints", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--steps", type=int, default=6)
    args = p.parse_args(argv)
    if args.role == "pserver":
        args.ready_file = args.last
        return run_pserver(args)
    args.trainer_id = int(args.last)
    return run_trainer(args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
