#!/usr/bin/env python3
"""What the observability code costs the hot paths, on one card, against
another checkout, in turns:

    python3 paddle_tpu_torch/tools/telemetry_ab.py ab <other checkout>

runs the other checkout and this one in three pairs, alternating which
side runs first, with telemetry off (no ``PADDLE_TPU_TELEMETRY_DIR``, the
timeline disabled), then this one with telemetry on (the directory set,
the timeline enabled), each in a process of its own (each builds its own
kernels), and prints one JSON line a run;

    python3 paddle_tpu_torch/tools/telemetry_ab.py measure <checkout> [--telemetry]

is one such run.  Measured, with ``chip_smoke.py``'s own helpers and shapes
(transformer-base, random weights from seed 0): serving, every bucket of
``ServingSession(max_batch_size=8)`` captured first, the host
microseconds of ``Inferencer.infer(feed, sync=False)`` on the 8-row batch
(the executor's ``run`` call on a cache hit: feed coercion, lookup, graph
replay, the fetch copy's enqueue; 100 calls, each begun with the card
idle: median and quartiles), the 8-row batch's wall to the logits on the
host (20), and requests/s over 64 requests of 1-2 rows from 4 threads
(three rounds); training at 64 x 256 (Adam, one graph replay a step), the
host microseconds of ``Executor.run(..., sync=False)`` (20 steps) and the
step's wall to the loss on the host (10).  Needs one CUDA GPU and nvcc.
"""
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _quartiles(xs):
    xs = sorted(xs)
    return [xs[len(xs) // 4], xs[(3 * len(xs)) // 4]]


def measure(root, telemetry):
    sys.path.insert(0, HERE)
    import chip_smoke as cs           # this checkout's helpers and shapes
    sys.path.insert(0, os.path.abspath(root))
    import gc
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import build
    assert os.path.abspath(pt.__file__).startswith(os.path.abspath(root) + os.sep), pt.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"root": root, "telemetry": telemetry, "card": smi.stdout.strip(),
           "build_s": build.build()["seconds"]}
    if telemetry:
        os.environ["PADDLE_TPU_TELEMETRY_DIR"] = tempfile.mkdtemp(prefix="telemetry_ab_")
        pt.telemetry.TIMELINE.enabled = True

    inf = pt.Inferencer(cs._infer_func, place=pt.CUDAPlace(0))
    inf.warmup(cs.BUCKETS, feed_specs=cs.SERVE_SPECS)
    feed8 = cs._batch_feed(cs._requests(16, seed=1), 8)
    run_us = [v * 1e3 for v in cs._host_ms(torch, lambda: inf.infer(feed8, sync=False), 100)]
    wall_ms = cs._host_ms(torch, lambda: inf.infer(feed8), 20)
    rps = []
    for _ in range(3):
        sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0,
                                 warmup=False)
        rps.append(cs._rps(sess)[0])
        sess.close()
    out["serving"] = {"host_us_run": _median(run_us), "host_us_run_quartiles": _quartiles(run_us),
                      "host_us_run_all": run_us,
                      "batch_wall_ms": _median(wall_ms), "batch_wall_ms_all": wall_ms,
                      "requests_per_s": _median(rps), "requests_per_s_all": rps}
    del inf, sess
    gc.collect()
    torch.cuda.empty_cache()

    main, startup, loss = cs._train_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0), kernels=True)
    exe.run(startup, scope=scope)
    feed = cs._train_feed(cs.TRAIN_B, seed=0)
    exe.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
    for _ in range(2):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    step_us = [v * 1e3 for v in cs._host_ms(
        torch, lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                               return_numpy=False, sync=False), 20)]
    step_ms = cs._host_ms(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                                 scope=scope), 10)
    out["training"] = {"host_us_run": _median(step_us), "host_us_run_quartiles": _quartiles(step_us),
                       "host_us_run_all": step_us,
                       "step_wall_ms": _median(step_ms), "step_wall_ms_all": step_ms,
                       "tokens_per_s": cs.TRAIN_B * cs.T / _median(step_ms) * 1e3,
                       "captures": exe.cache_info()["captures"]}
    if telemetry:
        out["timeline_events"] = len(pt.telemetry.TIMELINE.events())
    print(json.dumps(out), flush=True)


def ab(other):
    me = os.path.abspath(HERE)
    runs = [(other, False), (me, False), (me, False), (other, False), (other, False),
            (me, False), (me, True)]
    for root, telemetry in runs:
        cmd = [sys.executable, os.path.abspath(__file__), "measure", root]
        if telemetry:
            cmd.append("--telemetry")
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        line = (p.stdout.strip().splitlines() or [""])[-1]
        if p.returncode != 0 or not line.startswith("{"):
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"the run of {root} failed with exit {p.returncode}")
        print(line, flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "ab":
        ab(os.path.abspath(sys.argv[2]))
    elif len(sys.argv) >= 3 and sys.argv[1] == "measure":
        measure(sys.argv[2], "--telemetry" in sys.argv[3:])
    else:
        raise SystemExit(__doc__)
