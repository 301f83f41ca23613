#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA GPU and nvcc (CUDA_HOME or PATH)

Phases, each fatal on failure (non-zero exit, no result line):

1. the card's name and power limit;
2. build the hand-written kernels from ``paddle_tpu_torch/csrc``;
3. flash-attention forward (K1) against its plain PyTorch version at the
   serving path's shapes, causal and not, with ragged and zero key lengths;
4. embedding gather (K2) against its plain version, out-of-range ids
   included, bit-equal;
5. transformer-base (vocab 32000, d_model 512, 8 heads, 6+6 layers,
   d_inner 2048, max_len 256, random weights from seed 0) served by
   ``ServingSession(max_batch_size=8)`` to 4 client threads: answers
   finite, of the right shape, bit-identical to sequential
   ``Inferencer.infer`` runs of the same batches, K1/K2 launched 18/4
   times per dispatched batch, and one request within a stated tolerance
   of the port on the CPU with the same weights;
6. a ``{"kernels": [...]}`` line with each kernel's launches on the served
   path, error against its plain version, times, and bound.

The last line is ``{"ok": true, "device": {...}}``.  Times are CUDA-event
times on this card; bounds use the H100 SXM's published peaks.
"""
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
FP32_FLOPS = 67e12          # H100 SXM float32 rate outside the tensor cores

B, H, T, D_HEAD = 8, 8, 256, 64          # served batch: 8 rows x 8 heads
VOCAB, D_MODEL, N_LAYER, D_INNER = 32000, 512, 6, 2048
K1_PER_BATCH, K2_PER_BATCH = 3 * N_LAYER, 4
FLASH_TOL = 1e-5        # float32, kernel vs plain on the card
CPU_TOL = 1e-3          # max abs logit difference, card vs CPU, float32


def _ms(fn, iters):
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash(torch, card):
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(B * H, T, D_HEAD, generator=g).to(dev) for _ in range(3))
    row_lens = np.array([T, 0, 17, 200, 1, 129, 64, T - 1], np.int32)
    lens = torch.from_numpy(np.repeat(row_lens, H)).to(dev)
    scale = D_HEAD ** -0.5
    key_pos = torch.arange(T, device=dev)
    results = {}
    for causal in (False, True):
        out, lse = flash_attn_fwd(q, k, v, lens, causal, scale)
        ref_out, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, scale)
        torch.cuda.synchronize()
        err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
        if not err <= FLASH_TOL:
            raise AssertionError(f"flash_attn_fwd causal={causal}: max abs err {err} > {FLASH_TOL}")
        empty = out.reshape(B, H, T, D_HEAD)[1]
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise AssertionError("flash_attn_fwd: a row with no valid key is not exactly 0")
        mask = key_pos[None, None, :] < lens.reshape(B, H)[:, :, None, None]
        if causal:
            mask = mask & (key_pos[:, None] >= key_pos[None, :])
        q4, k4, v4 = (x.reshape(B, H, T, D_HEAD) for x in (q, k, v))
        ms = _ms(lambda: flash_attn_fwd(q, k, v, lens, causal, scale), 50)
        plain_ms = _ms(lambda: flash_attn_fwd_plain(q, k, v, lens, causal, scale), 5)
        lib_ms = _ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=scale), 50)
        # data-dependent work: only (query, key) pairs the masks keep
        qp = np.arange(T)[:, None]
        pairs = sum(int(((np.arange(T)[None, :] < L) & ((qp >= np.arange(T)[None, :]) | (not causal))).sum())
                    for L in np.repeat(row_lens, H))
        nbytes = 4 * (4 * q.numel() + lse.numel() + lens.numel())
        bound_ms, bound_by = _bound(nbytes, 4 * D_HEAD * pairs)
        results[causal] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by)
        print(f"K1 flash_attn_fwd B*H={B * H} T={T} d={D_HEAD} causal={causal}: "
              f"max_abs_err {err:.3e} (tol {FLASH_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; {pairs} pairs) [{card}]")
    return results


def phase_gather(torch, card):
    from paddle_tpu_torch.ops.cuda.embedding import gather_rows, gather_rows_plain
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    results = {}
    for vocab in (VOCAB, T):
        w = torch.randn(vocab, D_MODEL, generator=g).to(dev)
        ids = torch.randint(-5, vocab + 5, (B * T,), generator=g, dtype=torch.int32)
        ids[:4] = torch.tensor([-1, vocab, vocab + 4, 0], dtype=torch.int32)
        ids = ids.to(dev)
        out = gather_rows(w, ids)
        ref = gather_rows_plain(w, ids)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"gather_rows [{vocab},{D_MODEL}] differs from its plain version")
        in_range = ids.clamp(0, vocab - 1).long()
        ms = _ms(lambda: gather_rows(w, ids), 100)
        plain_ms = _ms(lambda: gather_rows_plain(w, ids), 100)
        lib_ms = _ms(lambda: torch.nn.functional.embedding(in_range, w), 100)
        valid = ids[(ids >= 0) & (ids < vocab)]
        rows_read = int(torch.unique(valid).numel())
        nbytes = 4 * (rows_read * D_MODEL + ids.numel() + out.numel())
        bound_ms, bound_by = _bound(nbytes, 0)
        results[vocab] = dict(max_abs_err=(out - ref).abs().max().item(), ms=ms, plain_ms=plain_ms,
                              library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        print(f"K2 gather_rows W=[{vocab},{D_MODEL}] N={ids.numel()}: bit-equal; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, F.embedding {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}) [{card}]")
    return results


def _infer_func():
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    return transformer.transformer(src, trg, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                                   d_model=D_MODEL, n_head=H, d_inner=D_INNER, is_test=True)


def _requests(n, seed):
    rs = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        rows = 1 + i % 2
        feed = {}
        for name in ("src", "trg"):
            lens = rs.randint(1, T + 1, rows).astype(np.int32)
            lens[0] = T if i % 5 == 0 else lens[0]
            ids = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
            ids[np.arange(T)[None, :] >= lens[:, None]] = 0
            feed[name], feed[name + "@SEQ_LEN"] = ids, lens
        reqs.append(feed)
    return reqs


def _family(name):
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_attn_fwd (K1)"
    if "gather_rows_kernel" in name:
        return "gather_rows (K2)"
    if "memcpy" in low:
        return "memcpy"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "sm90")):
        return "gemm (cuBLAS)"
    return "other (elementwise, layer_norm, copies)"


def phase_profile(torch, inf, reqs, card):
    """Where one full (8-row) served batch's time goes: torch.profiler's
    device activities by kernel family, their union as the device's busy
    time, and its share of the host wall clock around ``infer`` (logits
    to host included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    feed = {n: np.concatenate([r[n] for r in reqs])[:8] for n in reqs[0]}
    inf.infer(feed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inf.infer(feed)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    if not dev:
        print(f"serving profile: torch.profiler recorded no device activity (not measured) [{card}]")
        return
    fam, names = {}, {}
    for name, _, dur in dev:
        fam[_family(name)] = fam.get(_family(name), 0.0) + dur / 1e6
        ms, n = names.get(name, (0.0, 0))
        names[name] = (ms + dur / 1e6, n + 1)
    busy_ns, end = 0, 0
    for _, start, dur in sorted(dev, key=lambda x: x[1]):
        busy_ns += max(0, start + dur - max(start, end))
        end = max(end, start + dur)
    busy_ms = busy_ns / 1e6
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:6]
    print(json.dumps({"serving_profile": {
        "card": card, "rows": 8, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "by_family_ms": fam, "top": [[n[:80], ms, c] for n, (ms, c) in top]}}))


def phase_serving(torch, card):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda.embedding import gather_rows
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd

    t0 = time.perf_counter()
    inf = pt.Inferencer(_infer_func, place=pt.CUDAPlace(0))
    torch.cuda.synchronize()
    print(f"transformer-base startup on the card: {time.perf_counter() - t0:.2f} s")
    specs = {"src": ((T, 1), "int64"), "trg": ((T, 1), "int64"),
             "src@SEQ_LEN": ((), "int32"), "trg@SEQ_LEN": ((), "int32")}
    sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0, warmup=False)
    warm = inf.warmup(sess.buckets, feed_specs=specs)
    print("warmup:", [(r["batch_size"], round(r["seconds"], 4)) for r in warm])

    n_threads, per_thread = 4, 4
    reqs = _requests(n_threads * per_thread, seed=0)
    answers = [None] * len(reqs)
    slices = [None] * len(reqs)
    errors = []
    barrier = threading.Barrier(n_threads + 1)

    def client(t):
        try:
            barrier.wait(timeout=60)
            for j in range(per_thread):
                i = t * per_thread + j
                sl = sess.engine.submit(reqs[i], timeout=120).result(timeout=120)
                slices[i] = sl
                answers[i] = sl.materialize(timeout=120)[0]
        except Exception as e:  # noqa: BLE001 -- re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    flash_attn_fwd.launches = 0
    gather_rows.launches = 0
    barrier.wait(timeout=60)
    t_serve = time.perf_counter()
    for th in threads:
        th.join(timeout=300)
    serve_s = time.perf_counter() - t_serve
    k1, k2 = flash_attn_fwd.launches, gather_rows.launches
    stats = sess.stats()
    sess.close()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serving clients failed: {errors}")
    batches = stats["batches"]
    print(f"served {len(reqs)} requests in {batches} batches: {stats}")
    if stats["requests_dispatched"] != len(reqs):
        raise AssertionError("not every request was dispatched")
    if k1 != K1_PER_BATCH * batches or k2 != K2_PER_BATCH * batches:
        raise AssertionError(f"launches K1={k1} K2={k2} over {batches} batches; want "
                             f"{K1_PER_BATCH} and {K2_PER_BATCH} per batch")
    print(f"launches on the served path: K1 {k1} ({k1 // batches}/batch), K2 {k2} ({k2 // batches}/batch)")

    # each dispatched batch again, sequentially, from the same rows
    by_batch = {}
    for i, sl in enumerate(slices):
        by_batch.setdefault(sl.batch_seq, []).append(i)
    batch_s = []
    for seq, idx in sorted(by_batch.items()):
        idx.sort(key=lambda i: slices[i].start)
        bucket = slices[idx[0]].bucket
        feed = {}
        for name in reqs[0]:
            parts = [reqs[i][name] for i in idx]
            pad = bucket - sum(p.shape[0] for p in parts)
            parts.append(np.zeros((pad,) + parts[0].shape[1:], parts[0].dtype))
            feed[name] = np.concatenate(parts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (ref,) = inf.infer(feed)
        batch_s.append(time.perf_counter() - t0)
        for i in idx:
            a, sl = answers[i], slices[i]
            if a.shape != (sl.stop - sl.start, T, VOCAB) or not np.isfinite(a).all():
                raise AssertionError(f"request {i}: shape {a.shape} or non-finite values")
            if not np.array_equal(a, ref[sl.start:sl.stop]):
                raise AssertionError(f"request {i} differs from the sequential run of its batch")
    print(f"every answer bit-identical to the sequential Inferencer.infer of its batch "
          f"({len(by_batch)} batches)")
    print(f"serving: {len(reqs) / serve_s:.2f} requests/s ({len(reqs)} requests of 1-2 rows, "
          f"4 threads, {serve_s:.3f} s); sequential batch latency mean {1e3 * np.mean(batch_s):.2f} ms "
          f"(infer + logits to host, buckets {sorted({slices[i].bucket for i in range(len(reqs))})}) [{card}]")

    # not a gate: does a row's answer depend on its batch (cuBLAS picks
    # GEMM algorithms by shape)?
    (alone,) = inf.infer(reqs[0])
    print(f"request 0 run alone ({reqs[0]['src'].shape[0]} row) vs served in its batch "
          f"(bucket {slices[0].bucket}): max abs diff {float(np.abs(alone - answers[0]).max()):.3e}")

    phase_profile(torch, inf, reqs, card)

    # one request against the port on the CPU, same weights, float32 everywhere
    cpu_inf = pt.Inferencer(_infer_func, place=pt.CPUPlace())
    params = {n: inf.scope.find_var(n).cpu().numpy()
              for n, v in inf.inference_program.global_block.vars.items() if v.persistable}
    pt.params_from_numpy(params, cpu_inf.scope, "cpu")
    (cpu_out,) = cpu_inf.infer(reqs[0])
    diff = float(np.abs(cpu_out - answers[0]).max())
    if not diff <= CPU_TOL:
        raise AssertionError(f"card vs CPU: max abs logit diff {diff} > {CPU_TOL}")
    print(f"card vs CPU (request 0, {reqs[0]['src'].shape[0]} row): max abs logit diff {diff:.3e} "
          f"(tol {CPU_TOL}, TF32 off)")
    return k1, k2


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
        from paddle_tpu_torch.ops.cuda import build
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the paddle_tpu_torch package is missing: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card)
    print(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    info = build.build()
    print(f"kernel build: {info['seconds']:.2f} s ({'built' if info['built'] else 'cached'}) -> {info['path']}")
    print("\n".join(line for line in info["log"].splitlines()
                    if "registers" in line or "Compiling entry" in line))

    flash = phase_flash(torch, card)
    gather = phase_gather(torch, card)
    k1, k2 = phase_serving(torch, card)

    f, gw = flash[False], gather[VOCAB]
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "paddle_tpu/ops/pallas/flash_attention.py:38", "launches": k1,
         "max_abs_err": max(flash[c]["max_abs_err"] for c in flash), "ms": f["ms"],
         "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
         "library_ms": f["library_ms"]},
        {"name": "gather_rows", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/embedding_gather.cu",
         "replaces": "paddle_tpu/ops/pallas/embedding.py:48", "launches": k2,
         "max_abs_err": max(gather[v]["max_abs_err"] for v in gather), "ms": gw["ms"],
         "plain_ms": gw["plain_ms"], "bound_ms": gw["bound_ms"], "bound_by": gw["bound_by"],
         "library_ms": gw["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:  # noqa: BLE001 -- any phase failure is a non-zero exit
        traceback.print_exc()
        sys.exit(1)
