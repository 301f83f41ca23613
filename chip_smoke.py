#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA GPU and nvcc (CUDA_HOME or PATH)

Phases, each fatal on failure (non-zero exit, no result line):

1. the card's name and power limit;
2. build the hand-written kernels from ``paddle_tpu_torch/csrc``;
3. flash-attention forward (K1) against its plain PyTorch version at the
   serving path's shapes (ragged and zero key lengths) and the training
   path's (64 x 8 heads, the training batch's lengths), causal and not;
4. embedding gather (K2) against its plain version at both paths' shapes,
   out-of-range ids included, bit-equal;
5. transformer-base (vocab 32000, d_model 512, 8 heads, 6+6 layers,
   d_inner 2048, max_len 256, random weights from seed 0) served by
   ``ServingSession(max_batch_size=8)`` to 4 client threads: answers
   finite, of the right shape, bit-identical to sequential
   ``Inferencer.infer`` runs of the same batches, K1/K2 launched 18/4
   times per dispatched batch, and one request within a stated tolerance
   of the port on the CPU with the same weights;
6. linear-CE forward and backward (K7, K8), fused Adam (K6) and embedding
   scatter-add (K3) against their plain versions at the training path's
   shapes, with times beside a PyTorch yardstick;
7. transformer-base training (``train_network(fuse_final_ce=True)`` +
   ``Adam(1e-3)``, random weights from seed 0, batch 64 x 256 with ragged
   lengths): one warm-up and three timed steps on one batch, every loss
   finite and falling, every parameter changed by step 1, and each
   kernel's launches per step as the design gives them;
8. one training step profiled with ``torch.profiler``;
9. one step at batch 2 x 256 from the same weights, held against the port
   on the CPU in float64: the card (TF32 off) and the CPU in float32 within
   the stated gates on the loss and three gradients, and the card with TF32
   on (the control) outside them;
10. a ``{"kernels": [...]}`` line with each kernel's launches on the
    training path, error against its plain version, times, and bound.

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
TRAIN_B = 64            # training batch rows (x T = 256 tokens each)
N_PARAMS = 186          # transformer-base's parameters (and adam ops)
# launches per training step: attention and embedding forwards run again
# in their grad ops (the generic grad re-runs the forward lowering)
PER_STEP = {"flash_attn_fwd": 2 * 3 * N_LAYER, "gather_rows": 2 * 4, "scatter_add_rows": 4,
            "fused_adam": N_PARAMS, "linear_ce_fwd": 1, "linear_ce_bwd": 1}
CE_RTOL = 1e-4          # K7/K8 vs plain, relative to the largest value, TF32 off
ADAM_TOL = 1e-6         # K6 vs plain, abs (same rounding, element for element)
ADAM_RTOL = 1e-6        # K6 vs plain, each output relative to its own largest value
SCATTER_RTOL = 1e-5     # K3 vs plain (index_add_), relative; both add by atomics
# one full-width step at 2 x 256 against the port on the CPU in float64.
# Readings on an H100 (PERF.md): the card 7.9e-8 on the loss and <= 1.3e-6 on
# the gradients; the CPU in float32 1.1e-4 norm- and 1.0e-3 max-relative,
# from two ReLU inputs on the other side of 0 than in float64; the TF32
# control 2.6e-7 on the loss and up to 1.5e-2 norm- and 2.3e-2
# max-relative.  The gradient gates sit between the float32 readings and
# the control's.
STEP_LOSS_RTOL = 1e-6        # |x - f64| / |f64| on the loss
STEP_GRAD_NORM_RTOL = 1e-3   # ||x - f64|| / ||f64||
STEP_GRAD_MAX_RTOL = 5e-3    # max |x - f64| / max |f64|


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


def _attn_pairs(row_lens, causal):
    """(query, key) pairs the masks keep, over every row and head."""
    pairs = 0
    for L in np.repeat(row_lens, H).astype(np.int64):
        pairs += L * (L + 1) // 2 + (T - L) * L if causal else T * L
    return int(pairs)


def phase_flash(torch, card):
    """K1 at the serving shape (8 rows, zero and short key lengths) and at
    the training shape (64 rows, the training batch's ragged lengths)."""
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    serve_lens = np.array([T, 0, 17, 200, 1, 129, 64, T - 1], np.int32)
    train = _train_feed(TRAIN_B, seed=0)
    cases = [("serve", serve_lens, False), ("serve", serve_lens, True),
             ("train", train["src@SEQ_LEN"], False), ("train", train["trg@SEQ_LEN"], True)]
    scale = D_HEAD ** -0.5
    key_pos = torch.arange(T, device=dev)
    results = {}
    for shape, row_lens, causal in cases:
        rows = len(row_lens)
        q, k, v = (torch.randn(rows * H, T, D_HEAD, generator=g).to(dev) for _ in range(3))
        lens = torch.from_numpy(np.repeat(row_lens, H)).to(dev)
        out, lse = flash_attn_fwd(q, k, v, lens, causal, scale)
        ref_out, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, scale)
        torch.cuda.synchronize()
        err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
        if not err <= FLASH_TOL:
            raise AssertionError(f"flash_attn_fwd {shape} causal={causal}: max abs err {err} > {FLASH_TOL}")
        empty = out.reshape(rows, H, T, D_HEAD)[torch.from_numpy(row_lens == 0).to(dev)]
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise AssertionError("flash_attn_fwd: a row with no valid key is not exactly 0")
        mask = key_pos[None, None, :] < lens.reshape(rows, H)[:, :, None, None]
        if causal:
            mask = mask & (key_pos[:, None] >= key_pos[None, :])
        q4, k4, v4 = (x.reshape(rows, H, T, D_HEAD) for x in (q, k, v))
        ms = _ms(lambda: flash_attn_fwd(q, k, v, lens, causal, scale), 20)
        plain_ms = _ms(lambda: flash_attn_fwd_plain(q, k, v, lens, causal, scale), 3)
        lib_ms = _ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=scale), 20)
        pairs = _attn_pairs(row_lens, causal)     # data-dependent work
        nbytes = 4 * (4 * q.numel() + lse.numel() + lens.numel())
        bound_ms, bound_by = _bound(nbytes, 4 * D_HEAD * pairs)
        results[(shape, causal)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                        bound_ms=bound_ms, bound_by=bound_by)
        print(f"K1 flash_attn_fwd {shape} B*H={rows * H} T={T} d={D_HEAD} causal={causal}: "
              f"max_abs_err {err:.3e} (tol {FLASH_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}; {pairs} pairs) [{card}]")
    return results


def phase_gather(torch, card):
    """K2 at the serving shape (2048 ids) and at the training shape (the
    training batch's 16384 ids), into the word and the position table."""
    from paddle_tpu_torch.ops.cuda.embedding import gather_rows, gather_rows_plain
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    train_ids = {VOCAB: _train_feed(TRAIN_B, seed=0)["src"].reshape(-1),
                 T: np.tile(np.arange(T), TRAIN_B)}
    results = {}
    for shape, vocab in (("serve", VOCAB), ("serve", T), ("train", VOCAB), ("train", T)):
        w = torch.randn(vocab, D_MODEL, generator=g).to(dev)
        if shape == "serve":
            ids = torch.randint(-5, vocab + 5, (B * T,), generator=g, dtype=torch.int32)
            ids[:4] = torch.tensor([-1, vocab, vocab + 4, 0], dtype=torch.int32)
        else:
            ids = torch.from_numpy(train_ids[vocab].astype(np.int32))
        ids = ids.to(dev)
        out = gather_rows(w, ids)
        ref = gather_rows_plain(w, ids)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"gather_rows {shape} [{vocab},{D_MODEL}] differs from its plain version")
        in_range = ids.clamp(0, vocab - 1).long()
        ms = _ms(lambda: gather_rows(w, ids), 100)
        plain_ms = _ms(lambda: gather_rows_plain(w, ids), 100)
        lib_ms = _ms(lambda: torch.nn.functional.embedding(in_range, w), 100)
        valid = ids[(ids >= 0) & (ids < vocab)]
        rows_read = int(torch.unique(valid).numel())
        nbytes = 4 * (rows_read * D_MODEL + ids.numel() + out.numel())
        bound_ms, bound_by = _bound(nbytes, 0)
        results[(shape, vocab)] = dict(max_abs_err=(out - ref).abs().max().item(), ms=ms,
                                       plain_ms=plain_ms, library_ms=lib_ms,
                                       bound_ms=bound_ms, bound_by=bound_by)
        print(f"K2 gather_rows {shape} W=[{vocab},{D_MODEL}] N={ids.numel()}: bit-equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.embedding {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}) [{card}]")
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
    if "scatter_add_rows_kernel" in name:
        return "scatter_add_rows (K3)"
    if "fused_adam_kernel" in name:
        return "fused_adam (K6)"
    if "ce_fwd" in name:
        return "linear_ce_fwd (K7)"
    if any(k in name for k in ("ce_dl_kernel", "ce_dx_kernel", "ce_dw_kernel")):
        return "linear_ce_bwd (K8)"
    if "memcpy" in low:
        return "memcpy"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "sm90")):
        return "gemm (cuBLAS)"
    return "other (elementwise, layer_norm, copies)"


def _profile(torch, run, label, card, extra):
    """torch.profiler's device activities during ``run()`` by kernel
    family, their union as the device's busy time, and its share of the
    host wall clock around ``run``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.name(), e.start_ns(), e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    if not dev:
        print(f"{label}: torch.profiler recorded no device activity (not measured) [{card}]")
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
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:8]
    print(json.dumps({label: {
        "card": card, **extra, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "by_family_ms": fam, "top": [[n[:80], ms, c] for n, (ms, c) in top]}}))


def phase_profile(torch, inf, reqs, card):
    """Where one full (8-row) served batch's time goes (logits to host
    included)."""
    feed = {n: np.concatenate([r[n] for r in reqs])[:8] for n in reqs[0]}
    inf.infer(feed)
    _profile(torch, lambda: inf.infer(feed), "serving_profile", card, {"rows": 8})


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


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def phase_linear_ce(torch, card):
    """K7 and K8 at the loss head's shapes: 16384 rows, D 512, V 32000."""
    from paddle_tpu_torch.ops.cuda.linear_ce import (linear_ce_bwd, linear_ce_bwd_plain,
                                                     linear_ce_fwd, linear_ce_fwd_plain)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    rows = TRAIN_B * T
    lim = (6.0 / (D_MODEL + VOCAB)) ** 0.5           # the Xavier bound of W
    x = torch.randn(rows, D_MODEL, generator=g).to(dev)
    w = ((torch.rand(D_MODEL, VOCAB, generator=g) * 2 - 1) * lim).to(dev)
    b = (0.01 * torch.randn(VOCAB, generator=g)).to(dev)
    labels = torch.randint(0, VOCAB, (rows,), generator=g, dtype=torch.int32)
    labels[:2] = torch.tensor([0, VOCAB - 1], dtype=torch.int32)
    labels = labels.to(dev)
    gl = torch.full((rows,), 1.0 / rows, device=dev)    # d mean(loss) / d loss
    lse, lab = linear_ce_fwd(x, w, b, labels)
    dx, dw, db = linear_ce_bwd(x, w, b, labels, lse, gl)
    r_lse, r_lab = linear_ce_fwd_plain(x, w, b, labels)
    r_dx, r_dw, r_db = linear_ce_bwd_plain(x, w, b, labels, r_lse, gl)
    torch.cuda.synchronize()
    fwd_rel = max(_rel(lse, r_lse), _rel(lab, r_lab))
    bwd_rel = max(_rel(dx, r_dx), _rel(dw, r_dw), _rel(db, r_db))
    if not (fwd_rel <= CE_RTOL and bwd_rel <= CE_RTOL):
        raise AssertionError(f"linear_ce: relative error fwd {fwd_rel}, bwd {bwd_rel} > {CE_RTOL}")
    fwd_abs = max((lse - r_lse).abs().max().item(), (lab - r_lab).abs().max().item())
    bwd_abs = max((dx - r_dx).abs().max().item(), (dw - r_dw).abs().max().item(),
                  (db - r_db).abs().max().item())
    idx = torch.arange(rows, device=dev)
    lbl_long = labels.long()

    def lib_fwd():
        logits = x @ w + b
        return torch.logsumexp(logits, dim=-1), logits[idx, lbl_long]

    def lib_bwd():
        p = torch.softmax(x @ w + b, dim=-1)
        p[idx, lbl_long] -= 1.0
        p *= gl[:, None]
        return p @ w.T, x.T @ p, p.sum(dim=0)

    flops = 2.0 * rows * D_MODEL * VOCAB
    io = 4 * (x.numel() + w.numel() + b.numel() + labels.numel())
    res = {}
    for name, fn, plain, lib, nflops, nbytes, err, rel in (
            ("linear_ce_fwd", lambda: linear_ce_fwd(x, w, b, labels),
             lambda: linear_ce_fwd_plain(x, w, b, labels), lib_fwd, flops,
             io + 4 * 2 * rows, fwd_abs, fwd_rel),
            ("linear_ce_bwd", lambda: linear_ce_bwd(x, w, b, labels, lse, gl),
             lambda: linear_ce_bwd_plain(x, w, b, labels, lse, gl), lib_bwd, 3 * flops,
             io + 4 * (2 * rows + dx.numel() + dw.numel() + db.numel()), bwd_abs, bwd_rel)):
        ms = _ms(fn, 5)
        plain_ms = _ms(plain, 3)
        lib_ms = _ms(lib, 3)
        bound_ms, bound_by = _bound(nbytes, nflops)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"{name} x=[{rows},{D_MODEL}] W=[{D_MODEL},{VOCAB}]: max_abs_err {err:.3e}, "
              f"rel {rel:.3e} (tol {CE_RTOL} rel); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"composed torch {lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
              f"{nflops / ms / 1e9:.1f} TFLOP/s) [{card}]")
    return res


def phase_adam(torch, card):
    """K6 on the [32000, 512] word table and a [512] vector."""
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam, fused_adam_plain
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    res = {}
    for shape in ((VOCAB, D_MODEL), (D_MODEL,)):
        p, grad, m1 = (torch.randn(*shape, generator=g).to(dev) for _ in range(3))
        grad *= 1e-4
        m1 *= 1e-4
        m2 = (1e-8 * torch.rand(*shape, generator=g)).to(dev)
        b1p, b2p = torch.tensor(0.9 ** 3, device=dev), torch.tensor(0.999 ** 3, device=dev)
        lr = torch.tensor(1e-3, device=dev)
        args = (p, grad, m1, m2, b1p, b2p, lr, 0.9, 0.999, 1e-8)
        got, want = fused_adam(*args), fused_adam_plain(*args)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        # each output against its own scale: Moment2Out is ~1e-8 here
        rels = [_rel(a, b) for a, b in zip(got, want)]
        if not (err <= ADAM_TOL and max(rels) <= ADAM_RTOL):
            raise AssertionError(f"fused_adam {shape}: max abs err {err} (tol {ADAM_TOL}), "
                                 f"relative to each output's largest value {rels} (tol {ADAM_RTOL})")
        tp = torch.nn.Parameter(p.clone())
        tp.grad = grad.clone()
        opt = torch.optim.Adam([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8, fused=True)
        opt.state[tp] = {"step": torch.tensor(3.0, device=dev), "exp_avg": m1.clone(),
                         "exp_avg_sq": m2.clone()}
        ms = _ms(lambda: fused_adam(*args), 50)
        plain_ms = _ms(lambda: fused_adam_plain(*args), 20)
        lib_ms = _ms(opt.step, 50)
        bound_ms, bound_by = _bound(7 * 4 * p.numel(), 10 * p.numel())
        res[shape] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"K6 fused_adam {list(shape)}: max_abs_err {err:.3e} (tol {ADAM_TOL}), relative per "
              f"output (p, m1, m2, b1p, b2p) {[f'{r:.1e}' for r in rels]} (tol {ADAM_RTOL}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.optim.Adam(fused=True) {lib_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return res


def phase_scatter(torch, card):
    """K3: 16384 ids with duplicates and out-of-range ids, into the word
    table [32000, 512] and the position table [256, 512]."""
    from paddle_tpu_torch.ops.cuda.embedding import scatter_add_rows, scatter_add_rows_plain
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    n = TRAIN_B * T
    res = {}
    for vocab in (VOCAB, T):
        w = torch.zeros(vocab, D_MODEL, device=dev)
        ids = torch.randint(0, vocab, (n,), generator=g, dtype=torch.int32)
        ids[:4] = torch.tensor([-1, vocab, vocab + 3, 0], dtype=torch.int32)
        ids = ids.to(dev)
        rows = torch.randn(n, D_MODEL, generator=g).to(dev)
        got, want = scatter_add_rows(w, ids, rows), scatter_add_rows_plain(w, ids, rows)
        torch.cuda.synchronize()
        rel = _rel(got, want)
        if not rel <= SCATTER_RTOL:
            raise AssertionError(f"scatter_add_rows [{vocab},{D_MODEL}]: rel err {rel} > {SCATTER_RTOL}")
        valid = (ids >= 0) & (ids < vocab)
        v_ids, v_rows = ids[valid].long(), rows[valid]
        ms = _ms(lambda: scatter_add_rows(w, ids, rows), 50)
        plain_ms = _ms(lambda: scatter_add_rows_plain(w, ids, rows), 20)
        lib_ms = _ms(lambda: torch.zeros_like(w).index_add_(0, v_ids, v_rows), 50)
        bound_ms, bound_by = _bound(4 * (ids.numel() + int(valid.sum()) * D_MODEL + w.numel()),
                                    int(valid.sum()) * D_MODEL)
        err = (got - want).abs().max().item()
        res[vocab] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"K3 scatter_add_rows W=[{vocab},{D_MODEL}] N={n}: max_abs_err {err:.3e}, rel "
              f"{rel:.3e} (tol {SCATTER_RTOL} rel); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_add_ {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return res


def _train_programs(pt):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                            n_layer=N_LAYER, d_model=D_MODEL, n_head=H,
                                            d_inner=D_INNER, fuse_final_ce=True)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _train_feed(rows, seed):
    rs = np.random.RandomState(seed)
    feed = {}
    for name in ("src", "trg"):
        lens = rs.randint(128, T + 1, rows).astype(np.int32)
        ids = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
        ids[np.arange(T)[None, :] >= lens[:, None]] = 0
        feed[name], feed[name + "@SEQ_LEN"] = ids, lens
    feed["lbl"] = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
    return feed


def _counters():
    from paddle_tpu_torch.ops.cuda import embedding, flash_attention, fused_optimizer, linear_ce
    return {"flash_attn_fwd": flash_attention.flash_attn_fwd,
            "gather_rows": embedding.gather_rows,
            "scatter_add_rows": embedding.scatter_add_rows,
            "fused_adam": fused_optimizer.fused_adam,
            "linear_ce_fwd": linear_ce.linear_ce_fwd,
            "linear_ce_bwd": linear_ce.linear_ce_bwd}


def phase_training(torch, card):
    """Full-width transformer-base training on the card: 1 warm-up and 3
    timed steps on one fixed batch."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    main, startup, loss = _train_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block.all_parameters()
    n_floats = sum(int(np.prod(p.shape)) for p in params)
    ops = [o.type for o in main.desc.block(0).ops]
    print(f"transformer-base training program: {len(ops)} ops ({ops.count('adam')} adam, "
          f"{ops.count('sum')} sum), {len(params)} parameters, {n_floats} floats; built and "
          f"initialized on the card in {time.perf_counter() - t0:.2f} s")
    if len(params) != N_PARAMS:
        raise AssertionError(f"{len(params)} parameters, want {N_PARAMS}")
    feed = _train_feed(TRAIN_B, seed=0)
    before = {p.name: scope.find_var(p.name).clone() for p in params}
    counters = _counters()
    for f in counters.values():
        f.launches = 0
    losses, step_s = [], []
    for step in range(4):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(l))
        if step == 0:
            unchanged = [p.name for p in params
                         if torch.equal(before[p.name], scope.find_var(p.name))]
            if unchanged:
                raise AssertionError(f"parameters unchanged by step 1: {unchanged}")
            del before
    launches = {k: f.launches for k, f in counters.items()}
    print(f"training losses {losses}; step times (s) {[round(s, 4) for s in step_s]}")
    if not (np.isfinite(losses).all() and all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"losses not finite and falling: {losses}")
    want = {k: 4 * v for k, v in PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"launches over 4 steps {launches}, want {want}")
    print(f"launches on the training path over 4 steps: {launches} (per step {PER_STEP})")
    step_ms = 1e3 * float(np.mean(step_s[1:]))
    real = int(feed["trg@SEQ_LEN"].sum())
    print(f"training step: {step_ms:.2f} ms mean of 3 timed steps (host clock to the loss "
          f"on the host); {TRAIN_B * T / step_ms * 1e3:.0f} tokens/s at batch {TRAIN_B} x {T} "
          f"(padded), {real / step_ms * 1e3:.0f} target tokens/s within the lengths; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    _profile(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
             "training_profile", card, {"batch": [TRAIN_B, T]})
    return launches


def _step_errs(names, got, ref):
    """Loss relative difference and, per gradient, norm-relative and
    max-relative (to the largest reference element) differences."""
    out = {"loss_rel": abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))}
    for n, a, b in zip(names, got[1:], ref[1:]):
        d = np.abs(a - b)
        out[n] = {"finite": bool(np.isfinite(a).all()),
                  "norm_rel": float(np.linalg.norm(d) / np.linalg.norm(b)),
                  "max_rel": float(d.max() / np.abs(b).max())}
    return out


def _within_gates(e):
    return e["loss_rel"] <= STEP_LOSS_RTOL and all(
        g["finite"] and g["norm_rel"] <= STEP_GRAD_NORM_RTOL and g["max_rel"] <= STEP_GRAD_MAX_RTOL
        for n, g in e.items() if n != "loss_rel")


def phase_train_vs_cpu(torch, card):
    """One step at batch 2 x 256, full width, from the same weights.  The
    witness is the port on the CPU in float64; the card (TF32 off) must be
    within the gates of it, as the port on the CPU in float32 is; the card
    with TF32 on is the control the gates must reject."""
    import paddle_tpu_torch as pt
    main, startup, loss = _train_programs(pt)
    init_scope = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(startup, scope=init_scope)
    persist = [v.name for v in main.list_vars() if v.persistable]
    init = {n: init_scope.find_var(n).cpu().numpy() for n in persist}
    del init_scope
    ops = main.desc.block(0).ops
    head_w = next(o for o in ops if o.type == "fused_fc_softmax_ce").input("W")[0]
    ln_scale = next(o for o in ops if o.type == "layer_norm").input("Scale")[0]
    names = ["src_emb", head_w, ln_scale]
    relu_in = [o.input("X")[0] for o in ops if o.type == "relu"]
    fetch = [loss.name] + [n + "@GRAD" for n in names] + relu_in
    feed = _train_feed(2, seed=1)

    def step(on_card, arrays):
        scope = pt.Scope()
        pt.params_from_numpy(arrays, scope, "cuda" if on_card else "cpu")
        exe = pt.Executor(pt.CUDAPlace(0) if on_card else pt.CPUPlace())
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        out = [np.asarray(o, np.float64) for o in out]
        return out[:len(names) + 1], out[len(names) + 1:], time.perf_counter() - t0

    got, got_r, _ = step(True, init)
    cpu32, cpu32_r, s32 = step(False, init)
    cpu64, cpu64_r, s64 = step(False, {n: a.astype(np.float64) if a.dtype == np.float32 else a
                                       for n, a in init.items()})
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, tf32_r, _ = step(True, init)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    # a ReLU input on the other side of 0 than in float64 passes or stops
    # its whole gradient: one such element moves the deep gradients far
    # more than rounding does
    flips = {k: int(sum(((a > 0) != (b > 0)).sum() for a, b in zip(r, cpu64_r)))
             for k, r in (("card_fp32", got_r), ("cpu_fp32", cpu32_r), ("card_tf32_control", tf32_r))}
    errs = {"card_fp32": _step_errs(names, got, cpu64), "cpu_fp32": _step_errs(names, cpu32, cpu64),
            "card_tf32_control": _step_errs(names, tf32, cpu64),
            "card_vs_cpu_fp32": _step_errs(names, got, cpu32)}
    print(f"one step at 2 x {T}, each against the port on the CPU in float64 (CPU steps "
          f"{s32:.1f} s float32, {s64:.1f} s float64; loss {float(got[0]):.6f} card, "
          f"{float(cpu64[0]):.6f} float64): {json.dumps(errs)}")
    print(f"ReLU inputs on the other side of 0 than in float64, of "
          f"{sum(r.size for r in cpu64_r)}: {flips}")
    print(f"gates: loss {STEP_LOSS_RTOL} rel; gradients {STEP_GRAD_NORM_RTOL} norm-relative, "
          f"{STEP_GRAD_MAX_RTOL} max-relative")
    if not _within_gates(errs["card_fp32"]):
        raise AssertionError(f"card (TF32 off) vs float64: outside the gates: {errs['card_fp32']}")
    if not _within_gates(errs["cpu_fp32"]):
        raise AssertionError(f"CPU float32 vs float64: outside the gates: {errs['cpu_fp32']}")
    if _within_gates(errs["card_tf32_control"]):
        raise AssertionError("the gates let the TF32 control through: they cannot tell "
                             f"float32 from TF32 products: {errs['card_tf32_control']}")


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
    phase_serving(torch, card)
    ce = phase_linear_ce(torch, card)
    adam = phase_adam(torch, card)
    scatter = phase_scatter(torch, card)
    launches = phase_training(torch, card)
    phase_train_vs_cpu(torch, card)

    def entry(name, source, replaces, per_case, main_case):
        m = per_case[main_case]
        return {"name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": f"paddle_tpu/ops/pallas/{replaces}", "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in per_case.values()),
                **{k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}

    kernels = [
        entry("flash_attn_fwd", "flash_attention_fwd.cu", "flash_attention.py:38", flash,
              ("train", False)),
        entry("gather_rows", "embedding_gather.cu", "embedding.py:48", gather, ("train", VOCAB)),
        entry("scatter_add_rows", "embedding_scatter_add.cu", "embedding.py:85", scatter, VOCAB),
        entry("fused_adam", "fused_adam.cu", "fused_optimizer.py:106", adam, (VOCAB, D_MODEL)),
        entry("linear_ce_fwd", "linear_ce.cu", "linear_ce.py:42",
              {0: ce["linear_ce_fwd"]}, 0),
        entry("linear_ce_bwd", "linear_ce.cu", "linear_ce.py:78",
              {0: ce["linear_ce_bwd"]}, 0),
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
