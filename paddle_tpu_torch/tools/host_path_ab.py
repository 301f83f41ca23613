#!/usr/bin/env python3
"""Two checkouts of the port on one card, in turns: what a change to the
kernels or to their launch path does to the paths that ``chip_smoke.py``
drives.  Times bound by the host differ from machine to machine and from
minute to minute, so two versions are compared only inside one run:

    python3 paddle_tpu_torch/tools/host_path_ab.py ab <other checkout>

runs the other checkout, this one, this one and the other again, each in a
process of its own (each builds its own kernels), and prints one JSON line a
run;

    python3 paddle_tpu_torch/tools/host_path_ab.py measure <checkout>

is one such run.  Measured, with ``chip_smoke.py``'s own helpers and shapes:
K2 (``gather_rows``) beside ``F.embedding`` at the four cases, CUDA-event
time and host microseconds a call; K4's GEMM at (512, 512) beside
``torch._int_mm``; K8 (``linear_ce_bwd``) at the loss head's shapes; the
outputs of K1, K7 (float32 and bf16) and K8 at the training shapes on
seeded inputs, as a SHA-256 digest of their bytes (equal digests: bit-equal
outputs), with the CUDA-event time of each; one
8-row int8 batch of transformer-base (wall, copies, device busy, from the
profiler, three times); three Adam training steps at 64 x 256 (tokens/s,
and the host time of the update tail: from the start of the first Adam
update's lowering to the end of the last, 186 lowerings op by op or one
group call a step; the allocator's retries a step) and one profiled
step.  In a checkout whose training step replays a CUDA graph the updates
are lowered only while the first step is captured: the update tail reads
0 on the timed steps, and the first step's launches include the
capture's eager run.  Needs one CUDA GPU and nvcc.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(root):
    sys.path.insert(0, HERE)
    import chip_smoke as cs           # this checkout's helpers and shapes
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.amp import AmpConfig
    from paddle_tpu_torch.ops.cuda import build, fused_optimizer
    from paddle_tpu_torch.ops.cuda.embedding import gather_rows
    from paddle_tpu_torch.ops.cuda.int8_matmul import abs_max_pair, int8_mm, quantize_int8
    from paddle_tpu_torch.ops.cuda.linear_ce import linear_ce_bwd, linear_ce_fwd
    assert os.path.abspath(pt.__file__).startswith(os.path.abspath(root) + os.sep), pt.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"root": root, "card": smi.stdout.strip(), "build_s": build.build()["seconds"]}
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    out["outputs"] = _kernel_outputs(cs, np, torch, dev)

    for shape, vocab, n in (("serve", cs.VOCAB, cs.B * cs.T), ("serve", cs.T, cs.B * cs.T),
                            ("train", cs.VOCAB, cs.TRAIN_B * cs.T), ("train", cs.T, cs.TRAIN_B * cs.T)):
        w = torch.randn(vocab, cs.D_MODEL, generator=g).to(dev)
        ids = torch.randint(0, vocab, (n,), generator=g, dtype=torch.int32).to(dev)
        long_ids = ids.long()
        fns = [lambda: gather_rows(w, ids), lambda: F.embedding(long_ids, w)]
        ms, lib_ms = cs._best(lambda fn: cs._ms(fn, 1000), fns)
        us, lib_us = cs._best(lambda fn: cs._host_us(torch, fn), fns)
        out[f"K2 {shape} {vocab}"] = {"ms": ms, "F.embedding_ms": lib_ms, "host_us": us,
                                      "F.embedding_host_us": lib_us}

    x = torch.randn(cs.B * cs.T, cs.D_MODEL, generator=g).to(dev)
    y = torch.randn(cs.D_MODEL, cs.D_MODEL, generator=g).to(dev)
    scales = abs_max_pair(x, y)
    xq, yqt = quantize_int8(x, scales, 0, 127.0), quantize_int8(y, scales, 1, 127.0, True)
    fns = [lambda: int8_mm(xq, yqt, scales, 127.0), lambda: torch._int_mm(xq, yqt.t())]
    ms, lib_ms = cs._best(lambda fn: cs._ms(fn, 1000), fns)
    us, lib_us = cs._best(lambda fn: cs._host_us(torch, fn), fns)
    out["K4 (512, 512)"] = {"ms": ms, "_int_mm_ms": lib_ms, "host_us": us, "_int_mm_host_us": lib_us}

    rows = cs.TRAIN_B * cs.T
    xs = torch.randn(rows, cs.D_MODEL, generator=g).to(dev)
    ws = (0.02 * torch.randn(cs.D_MODEL, cs.VOCAB, generator=g)).to(dev)
    bs = torch.zeros(cs.VOCAB, device=dev)
    labels = torch.randint(0, cs.VOCAB, (rows,), generator=g, dtype=torch.int32).to(dev)
    gl = torch.full((rows,), 1.0 / rows, device=dev)
    lse, _ = linear_ce_fwd(xs, ws, bs, labels)
    out["K8"] = {"ms": min(cs._ms(lambda: linear_ce_bwd(xs, ws, bs, labels, lse, gl), 5)
                           for _ in range(2))}
    del xs, ws, bs, labels, gl, lse

    inf = pt.Inferencer(cs._infer_func, place=pt.CUDAPlace(0), amp=AmpConfig(bf16=False, quant=True),
                        kernels=True)
    feed8 = cs._batch_feed(cs._requests(16, seed=0))
    for _ in range(2):
        inf.infer(feed8)
    batches = []
    for _ in range(3):
        prof = cs._profile(torch, lambda: inf.infer(feed8), "int8_batch", out["card"], {})
        copy_ms = prof["by_family_ms"].get("memcpy", 0.0)
        batches.append({"wall_ms": prof["wall_ms"], "copy_ms": copy_ms,
                        "wall_less_copy_ms": prof["wall_ms"] - copy_ms,
                        "device_compute_ms": prof["device_busy_ms"] - copy_ms})
    out["int8 batch (profiled)"] = batches
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inf.infer(feed8)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["int8 batch wall_ms (not profiled)"] = walls
    del inf

    main, startup, loss = cs._train_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0), kernels=True)
    exe.run(startup, scope=scope)
    feed = cs._train_feed(cs.TRAIN_B, seed=0)
    span, reset = _time_updates()

    def step():
        """One training step: its host ms, its update tail's host ms and
        the caching allocator's retries in it (each frees the cached blocks
        and waits for the device)."""
        torch.cuda.synchronize()
        reset()
        r0 = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        return ((time.perf_counter() - t0) * 1e3, span[0] * 1e3,
                torch.cuda.memory_stats().get("num_alloc_retries", 0) - r0)
    launches = fused_optimizer.fused_adam.launches
    steps, updates, retries = zip(*[step() for _ in range(4)])
    launches = (fused_optimizer.fused_adam.launches - launches) / 4
    prof = cs._profile(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
                       "training_step", out["card"], {})
    out["training"] = {"step_ms": steps[1:], "profiled_wall_ms": prof["wall_ms"],
                       "tokens_per_s": [cs.TRAIN_B * cs.T / ms * 1e3 for ms in steps[1:]],
                       "update_tail_host_ms": updates[1:], "alloc_retries": retries[1:],
                       "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
                       "K6_launches_a_step": launches,
                       "K6_device_ms": prof["by_family_ms"].get("fused_adam (K6)"),
                       "device_busy_ms": prof["device_busy_ms"],
                       "K8_ms": prof["by_family_ms"].get("linear_ce_bwd (K8)")}
    print("AB " + json.dumps(out))


def _time_updates():
    """Wrap the block lowering's per-op and per-group calls (``lower_op``,
    and ``_lower_group`` where the checkout has one) so that the returned
    one-element list holds, for the last block run, the host seconds from
    the start of its first Adam update to the end of its last: the update
    tail's host time, 186 lowerings or one group call a step, with the
    block loop's own work between them counted on both sides."""
    from paddle_tpu_torch.core import lower
    updates = ("adam", "pallas_adam")
    span = [0.0]
    first = [None]

    def mark(t0):
        if first[0] is None:
            first[0] = t0
        span[0] = time.perf_counter() - first[0]

    op_fn = lower.lower_op

    def lower_op(ctx, op, index=None):
        t0 = time.perf_counter()
        try:
            return op_fn(ctx, op, index=index)
        finally:
            if op.type in updates:
                mark(t0)
    lower.lower_op = lower_op
    group_fn = getattr(lower, "_lower_group", None)
    if group_fn is not None:
        def lower_group(ctx, ops, start, info):
            t0 = time.perf_counter()
            try:
                return group_fn(ctx, ops, start, info)
            finally:
                if ops[start].type in updates:
                    mark(t0)
        lower._lower_group = lower_group

    def reset():
        span[0], first[0] = 0.0, None
    return span, reset


def _kernel_outputs(cs, np, torch, dev):
    """K1 (float32 and bf16, causal and not), K7 (float32 and bf16) and K8
    at the training path's shapes on inputs from one seed: a digest of each
    call's output bytes and its CUDA-event time."""
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd
    from paddle_tpu_torch.ops.cuda.linear_ce import linear_ce_bwd, linear_ce_fwd

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    g = torch.Generator().manual_seed(8)
    res = {}
    train = cs._train_feed(cs.TRAIN_B, seed=0)
    for dtype in (torch.float32, torch.bfloat16):
        for causal, row_lens in ((False, train["src@SEQ_LEN"]), (True, train["trg@SEQ_LEN"])):
            q, k, v = (torch.randn(cs.TRAIN_B * cs.H, cs.T, cs.D_HEAD, generator=g).to(dtype)
                       .to(dev) for _ in range(3))
            lens = torch.from_numpy(np.repeat(row_lens, cs.H)).to(dev)
            fn = lambda: flash_attn_fwd(q, k, v, lens, causal, cs.D_HEAD ** -0.5)  # noqa: E731
            res[f"K1 {str(dtype)[6:]} causal={causal}"] = {"digest": digest(*fn()),
                                                           "ms": cs._ms(fn, 20)}
    rows = cs.TRAIN_B * cs.T
    x = torch.randn(rows, cs.D_MODEL, generator=g).to(dev)
    w = ((torch.rand(cs.D_MODEL, cs.VOCAB, generator=g) * 2 - 1) * 0.0136).to(dev)
    b = (0.01 * torch.randn(cs.VOCAB, generator=g)).to(dev)
    labels = torch.randint(0, cs.VOCAB, (rows,), generator=g, dtype=torch.int32).to(dev)
    for name, xx, ww in (("K7 float32", x, w), ("K7 bf16", x.bfloat16(), w.bfloat16())):
        fn = lambda: linear_ce_fwd(xx, ww, b, labels)  # noqa: E731
        res[name] = {"digest": digest(*fn()), "ms": cs._ms(fn, 5)}
    lse, _ = linear_ce_fwd(x, w, b, labels)
    gl = torch.full((rows,), 1.0 / rows, device=dev)
    fn = lambda: linear_ce_bwd(x, w, b, labels, lse, gl)  # noqa: E731
    res["K8"] = {"digest": digest(*fn()), "ms": cs._ms(fn, 3)}
    return res


def main():
    if len(sys.argv) != 3 or sys.argv[1] not in ("ab", "measure"):
        raise SystemExit(__doc__)
    if sys.argv[1] == "measure":
        return measure(sys.argv[2])
    for root in (sys.argv[2], HERE, HERE, sys.argv[2]):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "measure", root],
                             capture_output=True, text=True, timeout=900)
        lines = [line for line in run.stdout.splitlines() if line.startswith("AB ")]
        if run.returncode != 0 or not lines:
            raise SystemExit(f"measuring {root} failed:\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
        print(lines[-1], flush=True)


if __name__ == "__main__":
    main()
