#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one
                                   # CUDA GPU and nvcc (CUDA_HOME or PATH)

Phases, each fatal on failure (non-zero exit, no result line):

1. the card's name and power limit;
2. build the hand-written kernels from ``paddle_tpu_torch/csrc``;
3. flash-attention forward (K1) against its plain PyTorch version at the
   serving path's shapes (ragged and zero key lengths) and the training
   path's (64 x 8 heads, the training batch's lengths), causal and not,
   timed beside ``scaled_dot_product_attention``;
4. embedding gather (K2) against its plain version at both paths' shapes,
   out-of-range ids included, bit-equal; CUDA-event times, the device
   time (profiler) and the host microseconds a call of K2 and of
   ``F.embedding``;
5. transformer-base (vocab 32000, d_model 512, 8 heads, 6+6 layers,
   d_inner 2048, max_len 256, random weights from seed 0): every bucket
   (1, 2, 4, 8) captured as one CUDA graph by ``Inferencer.warmup`` before
   the session's engine thread starts (the executor's cache entries and
   their reasons printed), then served by ``ServingSession(max_batch_size=
   8)`` to 4 client threads through graph replays, with no capture while
   serving: answers finite, of the right shape, bit-identical to
   sequential ``Inferencer.infer`` runs (replays) of the same batches,
   K1/K2 launched 18/4 times per dispatched batch (the counts each replay
   adds, as captured), the 8-row batch's replay bit-equal to its eager
   (op-by-op) run, a profile of the replay with K1/K2's device launches
   gated at 18/4, and one request within a stated tolerance of
   the port on the CPU with the same weights; then phase 16 for float32;
6. linear-CE forward and backward (K7, K8), fused Adam (K6) and embedding
   scatter-add (K3) against their plain versions at the training path's
   shapes, with times beside a PyTorch yardstick; K7 and K8 (3xTF32 on the
   tensor cores, one mainloop) also against their plain versions in
   float64, beside the cuBLAS float32 composition and a single-pass-TF32
   control, and twice for bit-equality; K8's mainloop alone at one chunk's
   three products; K3 bit-equal to its plain version run on the CPU, and
   twice bit-equal, on the word table (uniform ids, a quarter of them 0,
   and the training feed's own source ids) and the position table (random
   ids, and the step's position ids); K6 (multi-tensor) over the training
   step's 186 parameter shapes in one launch, each entry in the expression
   of its op type (``adam`` or ``pallas_adam``, as the kernel pass types
   it), in place (p, m1 and m2 updated where they lie, the beta powers
   into fresh scalars), bit-equal to its plain version, with a control
   (one entry's expression flag flipped changes its Moment2Out), beside
   ``torch.optim.Adam(fused=True)`` over the same shapes in one call (its
   device operations by name and count) and the step's bound; K6's times
   are those of the in-place call on clones of the inputs;
7. transformer-base training (``train_network(fuse_final_ce=True)`` +
   ``Adam(1e-3)``, random weights from seed 0, batch 64 x 256 with ragged
   lengths), each step one CUDA graph replay: the graph captured by
   ``Executor.precompile`` (kind ``graph``, the scope left bit-equal),
   then one warm-up and three timed steps on one batch, every loss
   finite and falling, every parameter changed by step 1, no capture over
   the steps, the allocated memory equal after steps 2 and 4, every state
   tensor at its address, and each kernel's launches per step as the
   design gives them (K6 once a step over all 186 parameters); then a
   step taken again from the same state (copied in place) and feed must
   give bit-equal parameters (the first that differs is named);
8. one training step (a replay) profiled with ``torch.profiler``, its
   device launches gated by kernel family (K1 36, K2 4, K3 8 kernels, K7
   2, K8 32, K6 1); then phase 17;
9. one step at batch 2 x 256 from the same weights, held against the port
   on the CPU in float64: the card (TF32 off) and the CPU in float32 within
   the stated gates on the loss and three gradients, and the card with TF32
   on (the control) outside them;
10. the int8 path (K4) at the served batch's four (K, N) products, M = 256
    and 2048: the quantize kernels (abs-max pair, x, the weight
    transposed), the GEMM's int32 and float32 (dequant) epilogues and the
    whole ``int8_matmul``, each bit-equal to its plain version; the GEMM
    timed beside its bound and ``torch._int_mm`` (column-major B), the
    quantizers and the whole product timed, and the quantizers' time a
    batch; host microseconds a call at (512, 512); fused SGD (K5) on the
    word table and a vector, bit-equal, beside ``torch.optim.SGD(fused=
    True)``, and K5 over the training step's 186 parameter shapes in one
    launch, in place, bit-equal, beside that call over the same shapes
    (K5's times those of the in-place call on clones of p);
11. int8 serving: ``Inferencer(amp=AmpConfig(bf16=False, quant=True),
    kernels=True)`` with the float32 weights, every bucket captured at
    warmup, served by ``ServingSession(max_batch_size=8)`` to 4 client
    threads through graph replays: answers finite, of the right shape,
    bit-identical to sequential runs of the same batches, launches per
    batch K4 97 (and its quantize kernels: abs-max 97, quantize 194), K1
    18, K2 4; one 8-row batch's replay bit-equal to its eager run and to
    the simulated fake-quant program (``kernels=False``) on the card, and
    within a gate of float32 serving that the same model at
    ``quant_bits=4`` (the control) fails; requests/s and batch latency
    beside float32's; a profile of one replay, its device launches gated
    at K4 97, quantizers 291, K1 18 and K2 4, with at most 6 device
    operations a product; then phase 16 for int8;
12. transformer-base training with ``SGD`` through ``Executor(kernels=
    True)``, one graph replay a step as in phase 7: three steps at 64 x
    256, loss finite, every parameter changed, K5 launched once a step and
    K7/K8/K3 as in phase 7; a profile of one step gated as phase 8's (K5
    in place of K6); then phase 17;
13. the bf16 instances of K1, K3 and K7 at the bf16 step's shapes, each
    against its plain version on the card (K3: bit-equal to it run on the
    CPU, and twice bit-equal) and against float64 over the same
    bf16-rounded inputs, inside a gate that a control fails (K3 on phase
    6's ids): K1 (bf16
    tensor cores, P split into two bf16 terms) with P rounded once to bf16
    before p.v, K3 with a bf16 running sum, K7 with the logits rounded to
    bf16 before the lse; times beside a PyTorch yardstick, and K7's
    mainloop on its own (``gemm_bf16``, writing the float32 product) at the
    same shape;
14. bf16 AMP training: ``amp.enable_amp`` on the Adam program, run by
    ``Executor(CUDAPlace(0))`` (kernel tier, then the amp-bf16 bridge), at
    full width and 64 x 256: one step's gradients against the float32
    step from the same state within a norm-relative gate (these runs op by
    op), which the program with the reference pass's stale casts (the
    control) fails on the layer_norm parameters behind a gradient merge;
    the same step through ``Executor(amp=AmpConfig())``; then the bf16
    step's graph captured by ``precompile`` and four steps, one replay
    each, losses finite and falling, no capture, memory flat from step 2,
    the launches a step (K1 36 in bf16, K2 4, K3 4 in bf16, K6 1, K7 1 in
    bf16, K8 1 in float32); tokens/s and a profile gated as phase 8's;
    then phase 17;
15. a ``{"kernels": [...]}`` line with each kernel's launches on its path
    (and, as ``launches_trainer``, in phase 18's pipelined Trainer run and
    its bf16 Trainer, counted alone),
    error against its plain version, times, and bound; K4's entry lists
    its quantize kernels under ``quantizers``, K7's and K8's both of their
    bounds (float32 on the CUDA cores, and three TF32 products), K3's times
    those of the padded word table; the bf16 instances of K1, K3 and K7 as
    entries of their own;
16. (inside phases 5 and 11, before each drops its inferencer and graphs)
    the executable cache per serving path and bucket: the capture's
    seconds, host us a replay (the ``run(sync=False)`` call on a hit; of
    it ``CUDAGraph.replay`` alone, and the feed coercion and cache lookup
    alone), the logits' copy into pinned memory (events) beside a pageable
    copy and a host copy of the pinned array, pinned allocations, each
    replay bit-equal to the eager run of its batch, the batch's wall
    through the graph, eagerly with pinned fetches, and eagerly with a
    pageable copy (the path before the cache), in alternating turns, and
    profiles of the batch through the graph and eagerly (device idle
    share); requests/s over 64 requests at 4 threads through the graphs
    and eagerly, with the pinned allocations of the graphs' run; and a
    client that keeps all 64 answers: the pinned bytes its arrays hold
    (at most ``PINNED_HANDOUT_LIMIT``, given back when they are dropped)
    and the host allocator's;
17. (inside phases 7, 12 and 14, before each drops its executor) the
    training step through its graph against the same step op by op
    (``Executor._run_eager``) from the same state and feed, the loss and
    every state tensor bit-equal; the capture's seconds,
    ``CUDAGraph.replay``'s host microseconds, the wall a step and tokens/s
    through the graph and eagerly in alternating turns, the peak device
    memory of a step each way, and a profile of each (device idle share;
    both gated as phase 8) (``{"training_graph_float32_Adam": ...}``,
    ``..._float32_SGD``, ``..._bf16_Adam``);
18. the ``Trainer`` at phase 7's full width (Adam, float32) from a seeded
    reader through ``reader.batch`` and the pow2 ``DataFeeder`` (source
    lengths in [129, 256], target and label at 256): ``Trainer(pipeline=
    True)`` over one epoch of 6 batches (batches staged by the
    ``FeedStager`` on its own stream) and ``Trainer(pipeline=False)`` from
    the same state over the same batches, losses and every parameter
    bit-equal, no capture after step 0, each later step's launches from
    the counters K1 36, K2 4, K3 4, K6 1, K7 1, K8 1 (step 0: twice, the
    eager run before the capture and the first replay); ``save_params``
    after step 3 and a new ``Trainer(param_path=)`` holding every
    persistable bit-equal; ``CheckpointConfig(step_interval=2)``: a run
    stopped after step 3, resumed by a new Trainer, repeating steps 3-5's
    losses and the final parameters bit for bit; ``clone(for_test=True)``
    on a held-out batch, its second run a replay bit-equal to the eager
    run, no state changed; a 3-step ``Trainer(amp=AmpConfig())`` on one
    batch, losses falling, phase 14's launches a step.  It prints
    tokens/s through the Trainer both ways (a warm epoch, to the last
    loss on the host) beside an ``exe.run`` loop on the same executor and
    phase 7's, the Trainer's host ms a step outside ``run`` (``wait_s``,
    ``handler_s``, from ``telemetry.STEPS``), profiles of a warm 6-step
    epoch each way (device idle share; launches by family gated at 6
    steps' K1 36, K2 4, K3 8, K7 2, K8 32, K6 1 a step), the staged copy per
    batch, and what a second feed signature (a half batch) costs.

Phase 9 also takes the 2 x 256 step in bf16 (``enable_amp``) with cuBLAS's
reduced-precision bf16 reductions allowed (PyTorch's default) and not, and
prints each one's gradient error against float64.

The last line is ``{"ok": true, "device": {...}}``.  Times are CUDA-event
times on this card; bounds use the H100 SXM's published peaks.
"""
import gc
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
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor-core rate
INT8_OPS = 1979e12          # H100 SXM dense int8 tensor-core rate
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core rate

B, H, T, D_HEAD = 8, 8, 256, 64          # served batch: 8 rows x 8 heads
VOCAB, D_MODEL, N_LAYER, D_INNER = 32000, 512, 6, 2048
K1_PER_BATCH, K2_PER_BATCH = 3 * N_LAYER, 4
FLASH_TOL = 1e-5        # float32, kernel vs plain on the card
CPU_TOL = 1e-3          # max abs logit difference, card vs CPU, float32
TRAIN_B = 64            # training batch rows (x T = 256 tokens each)
N_PARAMS = 186          # transformer-base's parameters (and adam ops)
# launches per training step: attention forwards run again in their grad
# ops (the generic grad re-runs the forward lowering); the kernel tier's
# pallas_scatter_add reads the embedding's output gradient and runs no
# gather again; one K6 (K5) launch updates all 186 parameters
PER_STEP = {"flash_attn_fwd": 2 * 3 * N_LAYER, "gather_rows": 4, "scatter_add_rows": 4,
            "fused_adam": 1, "fused_sgd": 0, "linear_ce_fwd": 1, "linear_ce_bwd": 1,
            "int8_matmul": 0, "abs_max_pair": 0, "quantize_int8": 0}
PER_STEP_SGD = dict(PER_STEP, fused_adam=0, fused_sgd=1)
# the served batch's int8 products: (K, N) -> count (M = rows x 256);
# per encoder layer q, k, v, o and the two FFN products, per decoder layer
# eight attention projections and the FFN's two, and the vocabulary head
INT8_SHAPES = {(D_MODEL, D_MODEL): 12 * N_LAYER, (D_MODEL, D_INNER): 2 * N_LAYER,
               (D_INNER, D_MODEL): 2 * N_LAYER, (D_MODEL, VOCAB): 1}
K4_PER_BATCH = sum(INT8_SHAPES.values())          # 97
# per int8 product: one abs-max launch for both operands, two quantize
# launches (x, and the weight transposed), the GEMM, and the memset of the
# abs-max pair; the profile holds the product to at most this many device
# operations
INT8_OPS_PER_PRODUCT = 6
# one 8-row int8 batch against float32 serving, norm-relative logit error
# ||int8 - fp32|| / ||fp32||; the control at quant_bits=4 must exceed it
INT8_VS_FP32_NORM_RTOL = 0.05
# the serving buckets of ServingSession(max_batch_size=8), each one CUDA
# graph; a replay against the eager (op-by-op) run of the same batch, max
# abs logit difference: bit-equal at every bucket of both paths on an H100
# (PERF.md), cuBLAS picking the same GEMMs inside the capture
BUCKETS = (1, 2, 4, 8)
REPLAY_ATOL = 0.0
CE_RTOL = 1e-4          # K7/K8 vs plain, relative to the largest value, TF32 off
# K8 (3xTF32 on the tensor cores) against the plain version in float64, norm-
# relative per gradient: at most this many times the error of the cuBLAS
# float32 composition, and (dx, dW) at least this many times below
# single-pass TF32's
K8_VS_FP32_FACTOR = 4.0
K8_VS_TF32_FACTOR = 100.0
# K7 (the same mainloop) against its plain version in float64, norm-relative:
# lse and the label logit at most this many times the cuBLAS float32
# composition's error; the label logit (and lse where the control tells
# float32 from TF32 there) at least K8_VS_TF32_FACTOR below single-pass TF32's
K7_VS_FP32_FACTOR = 2.0
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
# bf16 instances against float64 over the same bf16-rounded inputs.  K1 and
# K3 round only their output: each element within half a bf16 ulp of the
# float64 value plus the float32 sums' error (K1: FLASH_TOL; K3: the
# recursive-summation bound n * 2**-24 * sum |rows| of its segment).  K7's
# products of bf16 values are exact in float32: its norm-relative error at
# most K7_VS_FP32_FACTOR x the cuBLAS float32 composition's over the widened
# operands, and the control's (logits rounded to bf16) at least
# K8_VS_TF32_FACTOR x above K7's on the label logit (on lse where the control
# separates from float32 there).
BF16_HALF_ULP = 0.5
# the bf16 step launches what the float32 step does (PER_STEP); of those,
# these are the bf16 instances
BF16_PER_STEP = {"flash_attn_fwd": 2 * 3 * N_LAYER, "scatter_add_rows": 4, "linear_ce_fwd": 1}
# the bf16 step's gradients against the float32 step's from the same state,
# norm-relative: bf16 rounds activations and gradients to 8 bits of
# mantissa.  Over all 186 gradients as one vector (the step's update
# direction) at most BF16_STEP_GLOBAL_NREL; each layer_norm parameter behind
# a stale cast at most BF16_STEP_GRAD_NREL.  The control drops gradient
# contributions at the stale casts and must exceed both.  (Single gradients
# that cancel, such as the attention projections' at random weights, are
# far noisier in bf16: phase 9 gates each against an independent bf16 run.)
BF16_STEP_GLOBAL_NREL = 0.1
BF16_STEP_GRAD_NREL = 0.2
# every gradient of the bf16 step at 2 x 256 on the card, norm-relative to
# the float64 step, at most BF16_WITNESS_FACTOR x the same program's error
# on the CPU (plain versions, the CPU's products) + BF16_WITNESS_FLOOR: the
# single gradients phase 14 prints (the attention projections' are far from
# float32 in bf16) are held here against an independent bf16 computation
BF16_WITNESS_FACTOR = 2.0
BF16_WITNESS_FLOOR = 1e-3


# phase 7's exe.run loop, read beside phase 18's Trainer
PHASE7 = {}

# the primer's kernels (``torch.cuda._sleep``), left out of every profile
PRIMER = "spin_kernel"


def _profiler_started(torch):
    """Called first inside a ``torch.profiler.profile`` block: the card's
    activity tracing starts a few milliseconds after the block is entered
    (kernels launched at once were seen missing from the trace), so wait
    for it before the measured work; then a primer of a few short spin
    kernels, which the profiles leave out: a window was seen to lose its
    first records (a replayed step's first 4 feed copies and gather)."""
    torch.cuda.synchronize()
    time.sleep(0.2)
    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()


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


def _host_us(torch, fn, iters=1000):
    """Host microseconds a call: the host clock over ``iters`` back-to-back
    calls up to the last call's return; the device, which may still be
    working then, is waited for after the clock is read."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _best(measure, fns, rounds=3):
    """The least ``measure(fn)`` of each ``fn`` over ``rounds`` rounds taken
    in turns: times bound by the host vary with the load of the machine's
    other tenants, and a kernel and its yardstick should meet the same."""
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], measure(fn))
    return best


def _bound(nbytes, flops, peak=FP32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _attn_bound(nbytes, pairs, qk_peak, pv_peak):
    """K1's bound: its bytes, or q.k^T (2 D operations a kept pair) at
    ``qk_peak`` plus p.v (2 D a pair) at ``pv_peak``, the larger; beside it
    (``bound_fp32_ms``) all of it on the float32 CUDA cores.  Float32 K1's
    function on the tensor cores is three TF32 products each (peak / 3);
    bf16 K1 runs q.k^T as one bf16 product (products of bf16 values summed
    in float32) and p.v as two (P split into two bf16 terms; peak / 2)."""
    flops = 2 * D_HEAD * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / qk_peak + flops / pv_peak
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_fp32_ms=_bound(nbytes, 2 * flops)[0])


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
        bound = _attn_bound(nbytes, pairs, TF32_FLOPS / 3, TF32_FLOPS / 3)
        results[(shape, causal)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                        **bound)
        print(f"K1 flash_attn_fwd {shape} B*H={rows * H} T={T} d={D_HEAD} causal={causal}: "
              f"max_abs_err {err:.3e} (tol {FLASH_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}, "
              f"3xTF32 tensor cores; {bound['bound_fp32_ms']:.5f} ms on the float32 CUDA cores; "
              f"{pairs} pairs) [{card}]")
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
        fns = [lambda: gather_rows(w, ids), lambda: torch.nn.functional.embedding(in_range, w)]
        ms, lib_ms = _best(lambda fn: _ms(fn, 1000), fns)
        plain_ms = _ms(lambda: gather_rows_plain(w, ids), 100)
        # device time alone, and host time alone: back to back, the events'
        # time above is the larger of the two
        dev_ms = _device_ms(torch, lambda: gather_rows(w, ids), 50)
        lib_dev_ms = _device_ms(torch, lambda: torch.nn.functional.embedding(in_range, w), 50)
        host_us, lib_host_us = _best(lambda fn: _host_us(torch, fn), fns)
        valid = ids[(ids >= 0) & (ids < vocab)]
        rows_read = int(torch.unique(valid).numel())
        nbytes = 4 * (rows_read * D_MODEL + ids.numel() + out.numel())
        bound_ms, bound_by = _bound(nbytes, 0)
        results[(shape, vocab)] = dict(max_abs_err=(out - ref).abs().max().item(), ms=ms,
                                       plain_ms=plain_ms, library_ms=lib_ms,
                                       bound_ms=bound_ms, bound_by=bound_by,
                                       device_ms=dev_ms, library_device_ms=lib_dev_ms,
                                       host_us=host_us, library_host_us=lib_host_us)
        print(f"K2 gather_rows {shape} W=[{vocab},{D_MODEL}] N={ids.numel()}: bit-equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, F.embedding {lib_ms:.4f} ms (kernel and "
              f"F.embedding: the best of 3 rounds in turns), bound "
              f"{bound_ms:.5f} ms ({bound_by}); device time (profiler) kernel {dev_ms} ms, "
              f"F.embedding {lib_dev_ms} ms; host time a call (1000 calls, host clock to the last "
              f"return, best of 3) kernel {host_us:.2f} us, F.embedding {lib_host_us:.2f} us "
              f"[{card}]")
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
    if "flash_fwd_kernel" in name or "flash_fwd_bf16_kernel" in name:
        return "flash_attn_fwd (K1)"
    if "gather_rows_kernel" in name:
        return "gather_rows (K2)"
    if "::sort_kernel(" in name or "segment_sums_kernel" in name:
        return "scatter_add_rows (K3)"
    if "int8_gemm_kernel" in name:
        return "int8_matmul (K4)"
    if any(k in name for k in ("absmax2_kernel", "quantize_rows_kernel", "quantize_t_kernel")):
        return "int8 quantizers (K4)"
    if "fused_sgd_kernel" in name:
        return "fused_sgd (K5)"
    if "fused_adam_kernel" in name:
        return "fused_adam (K6)"
    if "ce_fwd" in name or "gemm_3xtf32_kernel<2>" in name or "gemm_bf16_kernel" in name:
        return "linear_ce_fwd (K7)"
    if any(k in name for k in ("gemm_3xtf32_kernel", "ce_db_kernel")):
        return "linear_ce_bwd (K8)"
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    if any(s in low for s in ("gemm", "cutlass", "xmma", "sm90")):
        return "gemm (cuBLAS)"
    return OTHER


OTHER = "other (elementwise, layer_norm, copies)"


def _profile(torch, run, label, card, extra):
    """torch.profiler's device activities during ``run()`` by kernel
    family, their union as the device's busy time, and its share of the
    host wall clock around ``run``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _profiler_started(torch)
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
           and PRIMER not in e.name()]
    if not dev:
        print(f"{label}: torch.profiler recorded no device activity (not measured) [{card}]")
        return None

    fam, fam_n, names, bf16_n = {}, {}, {}, {}
    for name, _, dur in dev:
        f = _family(name)
        fam[f] = fam.get(f, 0.0) + dur / 1e6
        fam_n[f] = fam_n.get(f, 0) + 1
        if "bf16" in name or "bfloat16" in name:
            bf16_n[f] = bf16_n.get(f, 0) + 1
        ms, n = names.get(name, (0.0, 0))
        names[name] = (ms + dur / 1e6, n + 1)
    busy_ns, end = 0, 0
    for _, start, dur in sorted(dev, key=lambda x: x[1]):
        busy_ns += max(0, start + dur - max(start, end))
        end = max(end, start + dur)
    busy_ms = busy_ns / 1e6
    top = sorted(names.items(), key=lambda kv: -kv[1][0])[:12]
    rec = {"card": card, **extra, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms, "by_family_ms": fam,
           "by_family_launches": fam_n, "bf16_named_launches": bf16_n,
           "top": [[n[:80], ms, c] for n, (ms, c) in top]}
    print(json.dumps({label: rec}))
    return rec


def _device_by_kernel(torch, fn, iters, counts=None, annotations=None):
    """Mean device time of each kernel ``fn`` launches, per call, by name
    (the first 48 characters), from ``torch.profiler`` ({} if two windows
    record no device activity).  ``counts``, a dict, receives each name's
    device operations a call.  A range the profiler draws on the device's
    timeline around a ``record_function`` (``torch.optim``'s
    ``Optimizer.step#...``) is no device work: it goes to ``annotations``
    (ms a call), not into the sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    by = {}
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _profiler_started(torch)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                    and PRIMER not in e.name():
                name = e.name().replace("void ", "").replace("(anonymous namespace)::", "")[:48]
                ms = e.duration_ns() / 1e6 / iters
                if e.is_user_annotation():
                    if annotations is not None:
                        annotations[name] = annotations.get(name, 0.0) + ms
                    continue
                by[name] = by.get(name, 0.0) + ms
                if counts is not None:
                    counts[name] = counts.get(name, 0) + 1 / iters
        if by:
            break
    return by


def _device_ms(torch, fn, iters):
    """Mean device time of ``fn`` per call: the sum of the device
    activities ``torch.profiler`` records over ``iters`` calls (None if two
    windows record none)."""
    return sum(_device_by_kernel(torch, fn, iters).values()) or None


SERVE_SPECS = {"src": ((T, 1), "int64"), "trg": ((T, 1), "int64"),
               "src@SEQ_LEN": ((), "int32"), "trg@SEQ_LEN": ((), "int32")}


def _batch_feed(reqs, n_rows=8):
    return {n: np.concatenate([r[n] for r in reqs])[:n_rows] for n in reqs[0]}


def _serve(torch, sess, reqs, per_batch, label, card):
    """``reqs`` from 4 client threads through ``sess``, with every kernel
    counter in ``per_batch`` set to 0 just before and read just after;
    then each dispatched batch again, sequentially, from the same rows:
    every answer finite, of the right shape and bit-identical to its
    batch's sequential run.  Returns requests/s and the mean sequential
    batch latency."""
    counters = _counters()
    n_threads = 4
    per_thread = len(reqs) // n_threads
    answers, slices, errors = [None] * len(reqs), [None] * len(reqs), []
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
    for k in per_batch:
        counters[k].launches = 0
    barrier.wait(timeout=60)
    t_serve = time.perf_counter()
    for th in threads:
        th.join(timeout=300)
    serve_s = time.perf_counter() - t_serve
    launches = {k: counters[k].launches for k in per_batch}
    stats = sess.stats()
    sess.close()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"{label}: serving clients failed: {errors}")
    batches = stats["batches"]
    print(f"{label}: served {len(reqs)} requests in {batches} batches: {stats}")
    if stats["requests_dispatched"] != len(reqs):
        raise AssertionError(f"{label}: not every request was dispatched")
    if launches != {k: v * batches for k, v in per_batch.items()}:
        raise AssertionError(f"{label}: launches {launches} over {batches} batches; want "
                             f"{per_batch} per batch")
    print(f"{label}: launches {launches} over {batches} batches ({per_batch} per batch)")

    inf = sess.inferencer
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
                raise AssertionError(f"{label}: request {i}: shape {a.shape} or non-finite values")
            if not np.array_equal(a, ref[sl.start:sl.stop]):
                raise AssertionError(f"{label}: request {i} differs from the sequential run of "
                                     f"its batch")
    rps, lat_ms = len(reqs) / serve_s, 1e3 * float(np.mean(batch_s))
    print(f"{label}: every answer bit-identical to the sequential Inferencer.infer of its batch "
          f"({len(by_batch)} batches)")
    print(f"{label}: {rps:.2f} requests/s ({len(reqs)} requests of 1-2 rows, 4 threads, "
          f"{serve_s:.3f} s); sequential batch latency mean {lat_ms:.2f} ms (infer + logits to "
          f"host, buckets {sorted({slices[i].bucket for i in range(len(reqs))})}) [{card}]")
    return {"requests_per_s": rps, "batch_latency_ms": lat_ms, "answers": answers,
            "launches": launches}


def _warm(torch, inf, label):
    """Capture every bucket of ``inf`` (``Inferencer.warmup`` ->
    ``Executor.precompile``) before a session's engine thread starts: each
    must be a CUDA graph.  Prints each bucket's record and the cache's
    entries (the startup program's is eager, with its reasons)."""
    warm = inf.warmup(BUCKETS, feed_specs=SERVE_SPECS)
    torch.cuda.synchronize()
    for r in warm:
        print(f"{label} warmup: bucket {r['batch_size']}: kind {r['kind']}, aot {r['aot']}, "
              f"capture {r['compile_s']:.3f} s (whole call {r['seconds']:.3f} s), "
              f"fingerprint {r['fingerprint'][:12]}")
    if [(r["batch_size"], r["kind"]) for r in warm] != [(b, "graph") for b in BUCKETS]:
        raise AssertionError(f"{label}: a bucket was not captured: {warm}")
    for e in inf.exe.cache_info()["entries"]:
        print(f"{label} cache entry: kind {e['kind']}, src feed {e['feeds'].get('src')}, "
              f"reasons {e['reasons']}, replay launches {e['launches']}")
    return warm


def _serve_graphs(torch, sess, reqs, per_batch, label, card):
    """``_serve`` through graphs captured at warmup: no capture while
    serving, and a replay of the 8-row batch against its eager run."""
    exe = sess.inferencer.exe
    captures = exe.cache_info()["captures"]
    res = _serve(torch, sess, reqs, per_batch, label, card)
    info = exe.cache_info()
    if info["captures"] != captures:
        raise AssertionError(f"{label}: {info['captures'] - captures} captures while serving")
    print(f"{label}: served through the graphs captured at warmup: hits {info['hits']}, "
          f"misses {info['misses']}, captures {info['captures']}, pipeline {info['pipeline']}")
    return res


def _gate_profile_launches(prof, want, label):
    """The per-batch launch gates read from the device: ``prof``'s
    operations by kernel family (a replay calls no wrapper, so this is
    what the card ran) must equal ``want``."""
    if prof is None:
        raise AssertionError(f"{label}: the profiler recorded no device activity; the "
                             f"per-batch launch gates read it")
    got = {f: prof["by_family_launches"].get(f, 0) for f in want}
    if got != want:
        raise AssertionError(f"{label}: device launches {got}, want {want} per batch")
    print(f"{label}: device launches a batch from the profile {got} (gate {want})")


def _replay_vs_eager(inf, feed, label):
    (got,) = inf.infer(feed)
    (want,) = inf.exe._run_eager(inf.inference_program, feed, inf.predict_vars, inf.scope)
    diff = float(np.abs(got - want).max())
    print(f"{label}: graph replay vs the eager run of the same {feed['src'].shape[0]}-row batch: "
          f"max abs diff {diff:.3e} ({'bit-equal' if diff == 0 else 'not bit-equal'}; "
          f"gate {REPLAY_ATOL})")
    if not diff <= REPLAY_ATOL:
        raise AssertionError(f"{label}: replay vs eager {diff} > {REPLAY_ATOL}")
    return got


def phase_serving(torch, card):
    import paddle_tpu_torch as pt

    t0 = time.perf_counter()
    inf = pt.Inferencer(_infer_func, place=pt.CUDAPlace(0))
    torch.cuda.synchronize()
    print(f"transformer-base startup on the card: {time.perf_counter() - t0:.2f} s")
    warm = _warm(torch, inf, "float32 serving")
    sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0, warmup=False)
    reqs = _requests(16, seed=0)
    res = _serve_graphs(torch, sess, reqs, {"flash_attn_fwd": K1_PER_BATCH,
                                            "gather_rows": K2_PER_BATCH},
                        "float32 serving", card)

    # not a gate: does a row's answer depend on its batch (cuBLAS picks
    # GEMM algorithms by shape)?
    (alone,) = inf.infer(reqs[0])
    print(f"request 0 run alone ({reqs[0]['src'].shape[0]} row) vs served in its batch: max abs "
          f"diff {float(np.abs(alone - res['answers'][0]).max()):.3e}")

    feed8 = _batch_feed(reqs)
    res["fp32_feed8"] = _replay_vs_eager(inf, feed8, "float32 serving")
    prof = _profile(torch, lambda: inf.infer(feed8), "serving_profile", card,
                    {"rows": 8, "path": "graph"})
    _gate_profile_launches(prof, {"flash_attn_fwd (K1)": K1_PER_BATCH,
                                  "gather_rows (K2)": K2_PER_BATCH}, "float32 serving profile")

    # one request against the port on the CPU, same weights, float32 everywhere
    res["params"] = _params(inf)
    cpu_inf = pt.Inferencer(_infer_func, place=pt.CPUPlace())
    pt.params_from_numpy(res["params"], cpu_inf.scope, "cpu")
    (cpu_out,) = cpu_inf.infer(reqs[0])
    diff = float(np.abs(cpu_out - res["answers"][0]).max())
    if not diff <= CPU_TOL:
        raise AssertionError(f"card vs CPU: max abs logit diff {diff} > {CPU_TOL}")
    print(f"card vs CPU (request 0, {reqs[0]['src'].shape[0]} row): max abs logit diff {diff:.3e} "
          f"(tol {CPU_TOL}, TF32 off)")
    del res["answers"]
    res["graphs"] = _graphs_vs_eager(torch, inf, warm, "float32", card)
    return res


def _host_ms(torch, fn, rounds=5):
    """Host milliseconds of each of ``rounds`` calls of ``fn``, each begun
    with the card idle and ended by ``fn``'s own wait for its result."""
    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _host_alloc_stats(torch):
    """torch's caching host allocator: pinned blocks allocated with
    ``cudaHostAlloc`` (``allocations``) and the time they took (us), and
    the requests it served (``active_requests``, new blocks or reused)."""
    s = torch.cuda.memory.host_memory_stats()
    return {"new_blocks": s["allocations.allocated"], "requests": s["active_requests.allocated"],
            "alloc_us": s["host_alloc_time.total"]}


def _pinned_bytes(torch):
    """The pinned bytes torch's host allocator owns (blocks in use and
    cached) and those that arrays handed out by fetch handles hold."""
    from paddle_tpu_torch.core.staging import PINNED_HANDOUT
    s = torch.cuda.memory.host_memory_stats()
    return {"allocator_bytes": s["allocated_bytes.current"],
            "allocator_peak_bytes": s["allocated_bytes.peak"], **PINNED_HANDOUT.snapshot()}


def _moved(after, before):
    return {k: after[k] - before[k] for k in after}


def _rps(sess, n_requests=64, n_threads=4, kept=None):
    """Requests/s of ``n_requests`` 1-2-row requests from ``n_threads``
    client threads through ``sess`` (answers dropped as they come, or
    appended to ``kept``)."""
    reqs = _requests(n_requests, seed=2)
    errors = []
    barrier = threading.Barrier(n_threads + 1)

    def client(t):
        try:
            barrier.wait(timeout=60)
            for i in range(t, n_requests, n_threads):
                (a,) = sess.infer(reqs[i], timeout=120)
                if not np.isfinite(a).all():
                    raise AssertionError(f"request {i}: non-finite logits")
                if kept is not None:
                    kept.append(a)
        except Exception as e:  # noqa: BLE001 -- re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    barrier.wait(timeout=60)
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"serving clients failed: {errors}")
    return n_requests / wall, sess.stats()


def _graphs_vs_eager(torch, inf, warm, label, card):
    """Phase 16, for one serving path (run inside phases 5 and 11, before
    each drops its inferencer): per bucket the capture's seconds, host us
    a replay (the whole ``run(sync=False)`` call on a hit; of it
    ``CUDAGraph.replay`` alone, and the feed coercion and cache lookup
    alone), the logits' copy into pinned memory (device ms, events) beside
    a pageable copy and a host copy of the pinned array, pinned allocations
    and their time over the timed batches, the replay against the eager
    run of the same batch, the batch's wall through the graph, the eager
    path with pinned fetches and the eager path with a pageable copy of
    the logits (the path before the cache), in alternating turns, and a
    profile of the batch through the graph and eagerly (device idle
    share); then requests/s over 64 requests at 4 threads through the
    graphs and through the eager path."""
    import paddle_tpu_torch as pt
    exe, fetch = inf.exe, list(inf.predict_vars)
    reqs = _requests(16, seed=1)
    out = {"card": card, "buckets": {}}
    entries = {e.feeds["src"][0][0]: e for e in exe._cache.values() if e.graph is not None}
    for rec in warm:
        b = rec["batch_size"]
        feed = _batch_feed(reqs, b)
        entry = entries[b]

        def graph():
            return inf.infer(feed)

        def eager():
            return exe._run_eager(inf.inference_program, feed, fetch, inf.scope)

        def pageable():
            return [t.cpu().numpy() for t in exe._run_eager(
                inf.inference_program, feed, fetch, inf.scope, return_numpy=False)]

        _replay_vs_eager(inf, feed, f"{label} bucket {b}")
        host_run_us = [v * 1e3 for v in _host_ms(torch, lambda: inf.infer(feed, sync=False), 20)]
        host_replay_us = [v * 1e3 for v in _host_ms(torch, entry.graph.replay, 20)]

        def lookup():
            program, scope, feeds, names = exe._prepare(inf.inference_program, feed, fetch,
                                                         inf.scope)
            with exe._lock:
                exe._get_entry(program, feeds, names, scope)

        host_lookup_us = [v * 1e3 for v in _host_ms(torch, lookup, 20)]
        dev_out = entry.outputs[0]
        pinned = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
        copy_ms = _ms(lambda: pinned.copy_(dev_out, non_blocking=True), 5)
        pageable_copy_ms = min(_host_ms(torch, lambda: dev_out.cpu(), 3))
        # what a ring of pinned buffers would add: one host copy of the logits
        host_copy_ms = min(_host_ms(torch, lambda: pinned.numpy().copy(), 3))
        del pinned
        stats0 = _host_alloc_stats(torch)
        walls = {"graph": [], "eager": [], "eager_pageable": []}
        for _ in range(3):
            for name, fn in (("graph", graph), ("eager", eager), ("eager_pageable", pageable)):
                walls[name] += _host_ms(torch, fn, 1)
        stats1 = _host_alloc_stats(torch)
        row = {"capture_s": rec["compile_s"],
               "host_us_run": float(np.median(host_run_us)),
               "host_us_replay": float(np.median(host_replay_us)),
               "host_us_lookup": float(np.median(host_lookup_us)),
               "logits_mb": dev_out.numel() * dev_out.element_size() / 1e6,
               "pinned_copy_ms": copy_ms, "pageable_copy_ms": pageable_copy_ms,
               "host_copy_ms": host_copy_ms,
               "pinned_allocs": _moved(stats1, stats0),
               "wall_ms": {k: {"min": min(v), "median": float(np.median(v))}
                           for k, v in walls.items()}}
        for path, fn in (("graph", graph), ("eager", eager)):
            prof = _profile(torch, fn, f"{label}_bucket{b}_{path}_profile", card, {"rows": b})
            if prof is not None:
                row[f"{path}_profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                              "device_idle_share")}
        out["buckets"][b] = row
        w = row["wall_ms"]
        print(f"{label} bucket {b}: capture {row['capture_s']:.3f} s; host us a replay "
              f"{row['host_us_run']:.1f} (run call) / {row['host_us_replay']:.1f} (replay alone) / "
              f"{row['host_us_lookup']:.1f} (feeds coerced and the cache entry found); "
              f"logits {row['logits_mb']:.1f} MB: pinned copy {copy_ms:.3f} ms, pageable "
              f"{pageable_copy_ms:.3f} ms, a host copy of the pinned array {host_copy_ms:.3f} "
              f"ms; batch wall graph {w['graph']['median']:.2f} ms, eager "
              f"{w['eager']['median']:.2f}, eager with a pageable copy "
              f"{w['eager_pageable']['median']:.2f} (medians of 3 in turns); pinned allocations "
              f"over the 9 batches {row['pinned_allocs']}; profiled device idle share graph "
              f"{row.get('graph_profile', {}).get('device_idle_share')}, eager "
              f"{row.get('eager_profile', {}).get('device_idle_share')} [{card}]")

    sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0, warmup=False)
    stats0 = _host_alloc_stats(torch)
    out["requests_per_s_graph"], stats = _rps(sess)
    out["serving_pinned_allocs"] = _moved(_host_alloc_stats(torch), stats0)
    sess.close()
    print(f"{label}: {out['requests_per_s_graph']:.2f} requests/s through the graphs (64 requests "
          f"of 1-2 rows, 4 threads): {stats}; pinned allocations {out['serving_pinned_allocs']} "
          f"[{card}]")
    # a client that keeps all 64 answers: the arrays handed out over pinned
    # blocks stop at PINNED_HANDOUT_LIMIT, later reads are copied out
    kept, pinned0 = [], _pinned_bytes(torch)
    sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0, warmup=False)
    out["requests_per_s_keeping"], stats = _rps(sess, kept=kept)
    sess.close()
    gc.collect()
    pinned1 = _pinned_bytes(torch)
    del kept
    gc.collect()
    pinned2 = _pinned_bytes(torch)
    out["keeping"] = {"before": pinned0, "answers_kept": pinned1, "answers_dropped": pinned2}
    print(f"{label}: a client keeping all 64 answers: {out['requests_per_s_keeping']:.2f} "
          f"requests/s, {stats['batches']} batches; pinned bytes before {pinned0}, with the "
          f"answers kept {pinned1}, after dropping them {pinned2} [{card}]")
    if pinned1["bytes"] > pinned1["limit"] or pinned2["bytes"] != pinned0["bytes"]:
        raise AssertionError(f"{label}: pinned bytes held past the limit or not given back: "
                             f"{out['keeping']}")
    sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0, warmup=False)
    sess.engine._runner = lambda feed: exe._run_eager(inf.inference_program, feed, fetch,
                                                      inf.scope, sync=False)
    out["requests_per_s_eager"], stats = _rps(sess)
    sess.close()
    print(f"{label}: {out['requests_per_s_eager']:.2f} requests/s eagerly (the same requests): "
          f"{stats} [{card}]")
    print(json.dumps({f"serving_graphs_{label}": out}))
    return out


def _params(inf):
    return {n: inf.scope.find_var(n).cpu().numpy()
            for n, v in inf.inference_program.global_block.vars.items() if v.persistable}


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def phase_int8_serving(torch, card, f32_res):
    """transformer-base served in int8 through the kernel tier, from the
    float32 path's weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.amp import AmpConfig

    amp = AmpConfig(bf16=False, quant=True)
    params = f32_res["params"]
    t0 = time.perf_counter()
    inf = pt.Inferencer(_infer_func, place=pt.CUDAPlace(0), amp=amp, kernels=True)
    pt.params_from_numpy(params, inf.scope, "cuda")
    warm = _warm(torch, inf, "int8 serving")
    print(f"int8 serving: startup and warmup {time.perf_counter() - t0:.2f} s")
    sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0, warmup=False)
    reqs = _requests(16, seed=0)
    res = _serve_graphs(torch, sess, reqs, {
        "int8_matmul": K4_PER_BATCH, "abs_max_pair": K4_PER_BATCH,
        "quantize_int8": 2 * K4_PER_BATCH, "flash_attn_fwd": K1_PER_BATCH,
        "gather_rows": K2_PER_BATCH}, "int8 serving", card)
    del res["answers"]
    ops = [o.type for o in inf.exe._apply_passes(
        inf.inference_program, list(reqs[0]), [v.name for v in inf.predict_vars]).desc.block(0).ops]
    print(f"int8 serving program: {len(ops)} ops, {ops.count('pallas_int8_matmul')} "
          f"pallas_int8_matmul, {ops.count('mul')} mul, {ops.count('pallas_gather')} pallas_gather")
    print(f"int8 vs float32 serving: {res['requests_per_s']:.2f} vs {f32_res['requests_per_s']:.2f} "
          f"requests/s; sequential batch latency {res['batch_latency_ms']:.2f} vs "
          f"{f32_res['batch_latency_ms']:.2f} ms [{card}]")

    feed8 = _batch_feed(reqs)
    got = _replay_vs_eager(inf, feed8, "int8 serving")
    sim = pt.Inferencer(_infer_func, place=pt.CUDAPlace(0), amp=amp, kernels=False)
    pt.params_from_numpy(params, sim.scope, "cuda")
    (want,) = sim.infer(feed8)
    if not np.array_equal(got, want):
        _first_differing_product(inf, sim, feed8)
        raise AssertionError(f"int8 kernel tier vs simulated fake-quant on the card: max abs diff "
                             f"{float(np.abs(got - want).max())}")
    print("int8 kernel tier (K4) vs the simulated fake-quant program (kernels=False) on the card, "
          "one 8-row batch: bit-equal")
    del sim

    fp32 = f32_res["fp32_feed8"]
    ctl = pt.Inferencer(_infer_func, place=pt.CUDAPlace(0), kernels=True,
                        amp=AmpConfig(bf16=False, quant=True, quant_bits=4))
    pt.params_from_numpy(params, ctl.scope, "cuda")
    (int4,) = ctl.infer(feed8)
    del ctl
    errs = {"int8": _norm_rel(got, fp32), "int4_control": _norm_rel(int4, fp32)}
    max_errs = {"int8": float(np.abs(got - fp32).max()), "int4_control": float(np.abs(int4 - fp32).max())}
    print(f"one 8-row batch against float32 serving, ||x - fp32|| / ||fp32||: {errs}; max abs "
          f"{max_errs} (largest |fp32 logit| {float(np.abs(fp32).max()):.4f}); gate "
          f"{INT8_VS_FP32_NORM_RTOL}")
    if not errs["int8"] <= INT8_VS_FP32_NORM_RTOL:
        raise AssertionError(f"int8 logits too far from float32: {errs}")
    if errs["int4_control"] <= INT8_VS_FP32_NORM_RTOL:
        raise AssertionError(f"the gate lets the quant_bits=4 control through: {errs}")
    # the replay of the 8-row batch's graph: the product's memset is a node
    # of it.  The arrays above give their pinned blocks back first, so the
    # profiled fetch allocates none (each 8-row fetch held is a 512 MB block)
    del got, want, int4
    stats0 = _host_alloc_stats(torch)
    prof = _profile(torch, lambda: inf.infer(feed8), "int8_serving_profile", card, {"rows": 8})
    print(f"int8 serving profile: pinned allocations {_moved(_host_alloc_stats(torch), stats0)}")
    # 97 abs-max pairs and 194 quantize launches: K4's quantizers
    _gate_profile_launches(prof, {"int8_matmul (K4)": K4_PER_BATCH,
                                  "int8 quantizers (K4)": 3 * K4_PER_BATCH,
                                  "flash_attn_fwd (K1)": K1_PER_BATCH,
                                  "gather_rows (K2)": K2_PER_BATCH}, "int8 serving profile")
    copy_ms = prof["by_family_ms"].get("memcpy", 0.0)
    print(f"int8 serving profile: one 8-row batch's wall {prof['wall_ms']:.2f} ms, less its "
          f"copies ({copy_ms:.2f} ms) {prof['wall_ms'] - copy_ms:.2f} ms, against "
          f"{prof['device_busy_ms'] - copy_ms:.2f} ms of device compute [{card}]")
    n_ops = prof["by_family_launches"]
    per_product = sum(n_ops.get(f, 0) for f in ("int8_matmul (K4)", "int8 quantizers (K4)",
                                               "memset")) / K4_PER_BATCH
    print(f"int8 serving profile: {per_product:g} device operations a product "
          f"(limit {INT8_OPS_PER_PRODUCT}): {n_ops.get('int8_matmul (K4)', 0)} GEMM, "
          f"{n_ops.get('int8 quantizers (K4)', 0)} quantizer, {n_ops.get('memset', 0)} "
          f"memset in {K4_PER_BATCH} products")
    if per_product > INT8_OPS_PER_PRODUCT:
        raise AssertionError(f"int8 serving profile: {n_ops}; want at most "
                             f"{INT8_OPS_PER_PRODUCT} device operations a product")
    res["graphs"] = _graphs_vs_eager(torch, inf, warm, "int8", card)
    return res


def _first_differing_product(inf, sim, feed):
    """Print the first int8 product whose output differs between the two
    programs (both write the original ``mul`` outputs' names)."""
    prog = inf.exe._apply_passes(inf.inference_program, list(feed),
                                 [v.name for v in inf.predict_vars])
    outs = [o.output("Out")[0] for o in prog.desc.block(0).ops if o.type == "pallas_int8_matmul"]
    a = inf.exe.run(inf.inference_program, feed=feed, fetch_list=outs, scope=inf.scope)
    b = sim.exe.run(sim.inference_program, feed=feed, fetch_list=outs, scope=sim.scope)
    for name, x, y in zip(outs, a, b):
        if not np.array_equal(x, y):
            print(f"first differing int8 product: {name}: max abs diff "
                  f"{float(np.abs(x - y).max())} of {float(np.abs(y).max())}")
            return


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def phase_linear_ce(torch, card):
    """K7 and K8 at the loss head's shapes: 16384 rows, D 512, V 32000."""
    from paddle_tpu_torch.ops.cuda.linear_ce import (gemm_3xtf32, linear_ce_bwd,
                                                     linear_ce_bwd_plain, linear_ce_fwd,
                                                     linear_ce_fwd_plain)
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

    # K7 and two yardsticks against the plain forward in float64 on the
    # card: the cuBLAS float32 composition (logsumexp of x @ W + b, the
    # label's logit), and the same with single-pass TF32 products
    r64_fwd = linear_ce_fwd_plain(x.double(), w.double(), b.double(), labels)
    f32_fwd = lib_fwd()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_fwd = lib_fwd()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    vs64_fwd = {}
    for who, outs in (("K7", (lse, lab)), ("cublas_fp32", f32_fwd),
                      ("cublas_tf32_control", tf32_fwd)):
        vs64_fwd[who] = {n: {"norm_rel": ((got.double() - ref).norm() / ref.norm()).item(),
                             "max_rel": ((got.double() - ref).abs().max() / ref.abs().max()).item()}
                         for n, got, ref in zip(("lse", "label_logit"), outs, r64_fwd)}
    del r64_fwd, f32_fwd, tf32_fwd
    print(f"linear_ce_fwd against its plain version in float64 on the card: "
          f"{json.dumps(vs64_fwd)}; gate: K7's norm-relative error at most "
          f"{K7_VS_FP32_FACTOR:g}x cuBLAS float32's (lse, label logit) and at least "
          f"{K8_VS_TF32_FACTOR:g}x below the TF32 control's (the label logit; lse where the "
          f"control's error is {K8_VS_TF32_FACTOR:g}x float32's) [{card}]")
    for n in ("lse", "label_logit"):
        k7, fp32, ctl = (vs64_fwd[who][n]["norm_rel"] for who in ("K7", "cublas_fp32",
                                                                   "cublas_tf32_control"))
        # lse sums exp over 32000 logits, in which the control's product
        # errors may average out: it is held against the control only
        # where the control separates from float32 there
        separates = n == "label_logit" or ctl >= K8_VS_TF32_FACTOR * fp32
        if not (k7 <= K7_VS_FP32_FACTOR * fp32 and (not separates or k7 * K8_VS_TF32_FACTOR <= ctl)):
            raise AssertionError(f"linear_ce_fwd {n} vs float64: K7 {k7}, cuBLAS float32 {fp32}, "
                                 f"TF32 control {ctl}: outside the gate")
    again_fwd = linear_ce_fwd(x, w, b, labels)
    if not (torch.equal(lse, again_fwd[0]) and torch.equal(lab, again_fwd[1])):
        raise AssertionError("linear_ce_fwd: two calls on the same inputs differ")
    print("linear_ce_fwd: two calls on the same inputs bit-equal")

    # K8 and two yardsticks against the plain backward in float64 on the
    # card: the cuBLAS float32 composition, and the same with single-pass
    # TF32 products (the control: what 3xTF32 has to stay far below)
    r64 = linear_ce_bwd_plain(x.double(), w.double(), b.double(), labels, lse.double(),
                              gl.double())
    f32 = lib_bwd()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = lib_bwd()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    vs64 = {}
    for who, grads in (("K8", (dx, dw, db)), ("cublas_fp32", f32), ("cublas_tf32_control", tf32)):
        vs64[who] = {n: {"norm_rel": ((got.double() - ref).norm() / ref.norm()).item(),
                         "max_rel": ((got.double() - ref).abs().max() / ref.abs().max()).item()}
                     for n, got, ref in zip(("dx", "dw", "db"), grads, r64)}
    del r64, f32, tf32
    print(f"linear_ce_bwd against its plain version in float64 on the card: {json.dumps(vs64)}; "
          f"gate: K8's norm-relative error at most {K8_VS_FP32_FACTOR:g}x cuBLAS float32's "
          f"(dx, dw, db) and at least {K8_VS_TF32_FACTOR:g}x below the TF32 control's (dx, dw) "
          f"[{card}]")
    for n in ("dx", "dw", "db"):
        k8, fp32, ctl = (vs64[who][n]["norm_rel"] for who in ("K8", "cublas_fp32",
                                                               "cublas_tf32_control"))
        # db is a sum of dl over 16384 rows, in which the control's product
        # errors average out (it reads within 4x of float32's): it cannot
        # tell the two apart, so the control gates the products' outputs
        vs_ctl = n == "db" or k8 * K8_VS_TF32_FACTOR <= ctl
        if not (k8 <= K8_VS_FP32_FACTOR * fp32 and vs_ctl):
            raise AssertionError(f"linear_ce_bwd {n} vs float64: K8 {k8}, cuBLAS float32 {fp32}, "
                                 f"TF32 control {ctl}: outside the gate")
    again = linear_ce_bwd(x, w, b, labels, lse, gl)
    if not all(torch.equal(a, c) for a, c in zip((dx, dw, db), again)):
        raise AssertionError("linear_ce_bwd: two calls on the same inputs differ")
    print("linear_ce_bwd: two calls on the same inputs bit-equal")

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
        # K7 and K8 run each float32 product as three TF32 products on the
        # tensor cores: that is their bound, and the float32 CUDA cores'
        # stands beside it
        res[name]["bound_fp32_ms"] = bound_ms
        bound_ms, bound_by = _bound(nbytes, 3 * nflops, TF32_FLOPS)
        res[name].update(bound_ms=bound_ms, bound_by=bound_by, bound_3xtf32_ms=bound_ms)
        both = (f", as float32 on the CUDA cores {res[name]['bound_fp32_ms']:.3f} ms; "
                f"{3 * nflops / ms / 1e9:.1f} TFLOP/s TF32")
        by_kernel = _device_by_kernel(torch, fn, 3)
        print(f"{name} device time by kernel (profiler): "
              f"{json.dumps({k: round(v, 5) for k, v in by_kernel.items()})} [{card}]")
        print(f"{name} x=[{rows},{D_MODEL}] W=[{D_MODEL},{VOCAB}]: max_abs_err {err:.3e}, "
              f"rel {rel:.3e} (tol {CE_RTOL} rel); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"composed torch {lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
              f"{nflops / ms / 1e9:.1f} TFLOP/s float32{both}) [{card}]")

    # K8's mainloop on its own at one chunk's three products (m, n, k, blocks
    # that are neighbours share At), beside one cuBLAS float32 matmul
    chunk = 4096
    for what, m, n, k, n_fast in (("dlT = W^T x^T", chunk, rows, D_MODEL, False),
                                  ("dx = dl W^T", rows, D_MODEL, chunk, True),
                                  ("dW = x^T dl", D_MODEL, chunk, rows, False)):
        at = torch.randn(k, m, generator=g).to(dev)
        bk = torch.randn(n, k, generator=g).to(dev)
        got, want = gemm_3xtf32(at, bk, n_fast), at.t() @ bk.t()
        off = ((got - want).norm() / want.norm()).item()
        if not off <= 1e-5:
            raise AssertionError(f"gemm_3xtf32 {what}: {off} norm-relative from cuBLAS float32")
        ms, lib_ms = _ms(lambda: gemm_3xtf32(at, bk, n_fast), 20), _ms(lambda: at.t() @ bk.t(), 20)
        print(f"K8 mainloop gemm_3xtf32 {what} m={m} n={n} k={k}: {ms:.4f} ms "
              f"({6.0 * m * n * k / ms / 1e9:.1f} TFLOP/s TF32 as three products, "
              f"{2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s float32), cuBLAS float32 matmul "
              f"{lib_ms:.4f} ms; {off:.2e} norm-relative apart [{card}]")
    return res


def _step_updates(pt, sgd=False):
    """The training step's 186 parameters as the kernel pass types their
    updates (phase 7's program, ``Executor(kernels=True)``): (shape, op
    type) in program order."""
    main, _, loss = _train_programs(pt, sgd=sgd)
    prog = pt.Executor(pt.CUDAPlace(0), kernels=True)._apply_passes(
        main, list(_train_feed(2, seed=0)), [loss.name])
    shapes = {p.name: tuple(p.shape) for p in main.global_block.all_parameters()}
    kinds = ("sgd", "pallas_sgd") if sgd else ("adam", "pallas_adam")
    ups = [(shapes[o.input("Param")[0]], o.type) for o in prog.desc.block(0).ops
           if o.type in kinds]
    if len(ups) != N_PARAMS or len(shapes) != N_PARAMS:
        raise AssertionError(f"{len(ups)} updates of {len(shapes)} parameters, want {N_PARAMS}")
    return ups


def _step_adam_entries(torch, ups, seed):
    """K6 entries at the step's shapes and op types, made on the card."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    entries = []
    for k, (shape, op_type) in enumerate(ups):
        p = torch.randn(shape, device=dev, generator=g)
        grad, m1 = (1e-4 * torch.randn(shape, device=dev, generator=g) for _ in range(2))
        m2 = 1e-8 * torch.rand(shape, device=dev, generator=g)
        b1p, b2p = (torch.tensor(b ** (3 + k % 5), device=dev) for b in (0.9, 0.999))
        entries.append((p, grad, m1, m2, b1p, b2p, torch.tensor([1e-3], device=dev),
                        op_type == "pallas_adam"))
    return entries


def _adam_clones(e):
    """A K6 entry with clones of p, m1 and m2 (the call updates them in
    place; the gradient, powers and lr are read only)."""
    return (e[0].clone(), e[1], e[2].clone(), e[3].clone()) + tuple(e[4:])


def _library_step(torch, card, name, make_opt, bytes_per_float):
    """The per-step yardstick of K5/K6: one ``make_opt(params).step()`` over
    tensors of the training step's 186 parameter shapes (transformer-base as
    phase 7 builds it), its event time, its device time (profiler) and its
    device operations by name and count, beside the step's bytes bound
    (``bytes_per_float`` a parameter float)."""
    import paddle_tpu_torch as pt
    main, _, _ = _train_programs(pt)
    shapes = [tuple(p.shape) for p in main.global_block.all_parameters()]
    if len(shapes) != N_PARAMS:
        raise AssertionError(f"{len(shapes)} parameters, want {N_PARAMS}")
    dev = torch.device("cuda")
    params = [torch.nn.Parameter(torch.empty(s, device=dev).normal_()) for s in shapes]
    for q in params:
        q.grad = 1e-4 * torch.randn_like(q)
    opt = make_opt(params)
    opt.step()                                   # creates the optimizer's state
    ms = _ms(opt.step, 20)
    counts, annotations = {}, {}
    by = _device_by_kernel(torch, opt.step, 5, counts, annotations)
    dev_ms = sum(by.values()) or None
    floats = sum(q.numel() for q in params)
    bound_ms, bound_by = _bound(bytes_per_float * floats, 0)
    ops = {n: [round(by[n], 5), round(counts[n], 2)] for n in sorted(by, key=lambda n: -by[n])}
    print(f"{name} over the training step's {len(shapes)} parameters ({floats} floats), one call a "
          f"step: {ms:.4f} ms (events), device {dev_ms} ms (profiler); its device operations a "
          f"call [ms, count]: {json.dumps(ops)}; left out, the profiler's range on the device "
          f"around the call (no device work): {json.dumps(annotations)}; the step's bound "
          f"{bound_ms:.4f} ms ({bound_by}) [{card}]")
    del opt, params
    torch.cuda.empty_cache()
    return dict(library_ms=ms, library_device_ms=dev_ms, library_device_ops=ops,
                bound_ms=bound_ms)


def _max_abs_diff(torch, pairs):
    """The largest absolute difference over ``pairs`` of tensors of one
    shape: 0.0 where every pair is bit-equal."""
    return torch.stack([(a - b).abs().max() for a, b in pairs]).max().item()


def _timed_step(torch, fn, launch, plain, counter):
    """One multi-tensor call ``fn`` over the step's entries: its launches
    (``counter``), its event time, the event time of its kernel alone
    (``launch``: the launch of a table built once, whose host cost is below
    its device time), its device time and operations (profiler; the mean of
    a recorded launch times the launches, as the profiler may miss some),
    and the time of its plain version ``plain``."""
    before = counter.launches
    fn()
    launches = counter.launches - before
    ms, kernel_ms = _best(lambda f: _ms(f, 20), [fn, launch])
    counts = {}
    by = _device_by_kernel(torch, fn, 5, counts)
    return dict(ms=ms, kernel_ms=kernel_ms,
                device_ms=launches * sum(by[n] / counts[n] for n in by) if by else None,
                device_ops={n: [round(v, 5), round(counts[n], 2)] for n, v in by.items()},
                host_us=_host_us(torch, fn, iters=50), plain_ms=_ms(plain, 2),
                launches_per_call=launches)


def phase_adam(torch, card):
    """K6 on the [32000, 512] word table and a [512] vector (a table of
    one), and over the training step's 186 parameters in one launch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda.fused_optimizer import (_adam_launch, fused_adam,
                                                           fused_adam_multi, fused_adam_multi_plain,
                                                           fused_adam_plain)
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
        err = _max_abs_diff(torch, zip(got, want))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"fused_adam {shape}: differs from its plain version (max {err})")
        tp = torch.nn.Parameter(p.clone())
        tp.grad = grad.clone()
        opt = torch.optim.Adam([tp], lr=1e-3, betas=(0.9, 0.999), eps=1e-8, fused=True)
        opt.state[tp] = {"step": torch.tensor(3.0, device=dev), "exp_avg": m1.clone(),
                         "exp_avg_sq": m2.clone()}
        # timed as the step calls it: in place (on clones of p, m1, m2)
        mine = [_adam_clones(args[:7] + (True,))]
        ms = _ms(lambda: fused_adam_multi(mine, 0.9, 0.999, 1e-8), 50)
        plain_ms = _ms(lambda: fused_adam_plain(*args), 20)
        lib_ms = _ms(opt.step, 50)
        bound_ms, bound_by = _bound(7 * 4 * p.numel(), 10 * p.numel())
        res[shape] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"K6 fused_adam {list(shape)} (a table of one): bit-equal (max_abs_err {err}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, torch.optim.Adam(fused=True) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}) [{card}]")
        del p, grad, m1, m2, tp, opt, got, want, mine

    # the step: 186 entries in one launch, each in its op type's expression,
    # in place (on clones of p, m1, m2; the plain version on other clones)
    ups = _step_updates(pt)
    entries = _step_adam_entries(torch, ups, seed=5)
    mine = [_adam_clones(e) for e in entries]
    before = fused_adam.launches
    got = fused_adam_multi(mine, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    if fused_adam.launches != before + 1:
        raise AssertionError(f"fused_adam_multi over {len(entries)}: "
                             f"{fused_adam.launches - before} launches, want 1")
    if not all(o[0] is e[0] and o[1] is e[2] and o[2] is e[3] for o, e in zip(got, mine)):
        raise AssertionError("fused_adam_multi: p, m1, m2 not updated in place")
    theirs = [_adam_clones(e) for e in entries]

    def plain():
        return fused_adam_multi_plain(theirs, 0.9, 0.999, 1e-8)
    want = plain()
    err = _max_abs_diff(torch, [(x, y) for a, b in zip(got, want) for x, y in zip(a, b)])
    differ = [k for k, (a, b) in enumerate(zip(got, want))
              if not all(torch.equal(x, y) for x, y in zip(a, b))]
    if differ:
        raise AssertionError(f"fused_adam_multi: entries {differ[:8]} ({len(differ)} of "
                             f"{len(entries)}) differ from their plain versions")
    # the control: one adam entry (the largest) in the other expression
    k = max((i for i, e in enumerate(entries) if not e[7]), key=lambda i: entries[i][0].numel())
    flipped = _adam_clones(entries[k])[:7] + (True,)
    m2_other = fused_adam_multi([flipped], 0.9, 0.999, 1e-8)[0][2]
    n_other = int((m2_other != got[k][2]).sum())
    if n_other == 0:
        raise AssertionError(f"the expression flag's control: entry {k} {list(ups[k][0])} gives "
                             f"the same Moment2Out in both expressions")
    del got, want, m2_other, flipped
    floats = sum(e[0].numel() for e in entries)
    counts = [e[0].numel() for e in entries]
    _, launch = _adam_launch(mine, counts, 0.9, 0.999, 1e-8)
    step = _timed_step(torch, lambda: fused_adam_multi(mine, 0.9, 0.999, 1e-8), launch, plain,
                       fused_adam)
    # p, grad, m1, m2 read and p, m1, m2 written; three scalars read and two
    # written an entry
    bound_ms, bound_by = _bound(7 * 4 * floats + 5 * 4 * len(entries), 10 * floats)
    n_fused = sum(e[7] for e in entries)
    print(f"K6 fused_adam_multi over the training step's {len(entries)} parameters ({floats} "
          f"floats; {n_fused} pallas_adam, {len(entries) - n_fused} adam), one launch: bit-equal "
          f"to the plain versions; control: entry {k} {list(ups[k][0])} in the other expression "
          f"changes {n_other} Moment2Out elements; max_abs_err {err}; the call {step['ms']:.4f} ms (events; host "
          f"{step['host_us']:.0f} us a call), the kernel alone {step['kernel_ms']:.4f} ms "
          f"(events), device {step['device_ms']} ms (profiler: {json.dumps(step['device_ops'])}), plain "
          f"{step['plain_ms']:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}); in place [{card}]")
    del entries, mine, theirs
    torch.cuda.empty_cache()
    lib = _library_step(torch, card, "torch.optim.Adam(fused=True)",
                        lambda ps: torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                                    fused=True), 7 * 4)
    res["step"] = dict(step, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib["library_ms"], library_device_ms=lib["library_device_ms"])
    print(f"K6 a step: the kernel {step['kernel_ms']:.4f} ms, the call {step['ms']:.4f} ms, "
          f"against Adam(fused=True) {lib['library_ms']:.4f} ms and the bound {bound_ms:.4f} ms "
          f"(events; device {step['device_ms']} against {lib['library_device_ms']}) [{card}]")
    return res


def _scatter_ids(torch, case, g, n):
    """K3's ids at the training step's shapes, and the table's rows: 16384
    uniform ids with out-of-range ones into the word table (VOCAB) or the
    position table (T); "padded", the word table with a quarter of the ids
    0, as the training feed's padded positions give (one segment of ~4100
    ids); "feed", the step's own source ids (``_train_feed``, flattened);
    "positions", the step's position ids (arange(T) tiled TRAIN_B times, as
    ``_position_ids_like`` feeds the position table)."""
    if case == "feed":
        return VOCAB, torch.from_numpy(_train_feed(TRAIN_B, seed=0)["src"].reshape(-1)
                                       .astype(np.int32))
    if case == "positions":
        return T, torch.from_numpy(np.tile(np.arange(T, dtype=np.int32), TRAIN_B))
    vocab = VOCAB if case == "padded" else case
    ids = torch.randint(0, vocab, (n,), generator=g, dtype=torch.int32)
    if case == "padded":
        ids[torch.rand(n, generator=g) < 0.25] = 0
    ids[:4] = torch.tensor([-1, vocab, vocab + 3, 0], dtype=torch.int32)
    return vocab, ids


SCATTER_CASES = (VOCAB, T, "padded", "feed", "positions")


def _scatter_label(vocab, case, n):
    return f"W=[{vocab},{D_MODEL}] N={n}" + ("" if case in (VOCAB, T) else f" {case}")


def phase_scatter(torch, card):
    """K3 at the training step's shapes (``_scatter_ids``): bit-equal to its
    plain version run on the CPU, and to itself."""
    from paddle_tpu_torch.ops.cuda.embedding import scatter_add_rows, scatter_add_rows_plain
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    n = TRAIN_B * T
    res = {}
    for case in SCATTER_CASES:
        vocab, ids = _scatter_ids(torch, case, g, n)
        w = torch.zeros(vocab, D_MODEL, device=dev)
        rows = torch.randn(n, D_MODEL, generator=g)
        # the plain version on the CPU adds in the kernel's order (ascending
        # n); on the card index_add_ adds by atomics
        want = scatter_add_rows_plain(w.cpu(), ids, rows)
        ids, rows = ids.to(dev), rows.to(dev)
        got, again = scatter_add_rows(w, ids, rows), scatter_add_rows(w, ids, rows)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"scatter_add_rows [{vocab},{D_MODEL}]: differs from its plain "
                                 f"version on the CPU by {(got.cpu() - want).abs().max().item()}")
        if not torch.equal(got, again):
            raise AssertionError(f"scatter_add_rows [{vocab},{D_MODEL}]: two calls differ")
        valid = (ids >= 0) & (ids < vocab)
        v_ids, v_rows = ids[valid].long(), rows[valid]
        ms = _ms(lambda: scatter_add_rows(w, ids, rows), 50)
        plain_ms = _ms(lambda: scatter_add_rows_plain(w, ids, rows), 20)
        lib_ms = _ms(lambda: torch.zeros_like(w).index_add_(0, v_ids, v_rows), 50)
        bound_ms, bound_by = _bound(4 * (ids.numel() + int(valid.sum()) * D_MODEL + w.numel()),
                                    int(valid.sum()) * D_MODEL)
        by_kernel = _device_by_kernel(torch, lambda: scatter_add_rows(w, ids, rows), 20)
        host_us = _host_us(torch, lambda: scatter_add_rows(w, ids, rows), 200)
        res[case] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         device_ms=sum(by_kernel.values()) or None, host_us=host_us)
        print(f"K3 scatter_add_rows {_scatter_label(vocab, case, n)}: bit-equal to its plain "
              f"version on the CPU, two calls bit-equal; kernel {ms:.4f} ms, plain on the card "
              f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}); device time by kernel (profiler) "
              f"{json.dumps({k: round(v, 5) for k, v in by_kernel.items()})}; host us a call "
              f"{host_us:.1f} [{card}]")
    return res


def phase_int8(torch, card):
    """K4 at the served batch's four (K, N) products, M = 256 and 2048: the
    quantize kernels (abs-max pair, x, the weight transposed), the GEMM in
    its int32 and its float32 (dequant) epilogue, and the whole quantize ->
    GEMM -> dequantize, each bit-equal to its plain version.  Times at M =
    2048: the GEMM beside the bound and ``torch._int_mm`` (cuBLASLt int8,
    on the same int8 operands), the quantizers, the whole ``int8_matmul``;
    and the quantizers' time for one 8-row batch's 97 products."""
    from paddle_tpu_torch.ops.cuda.int8_matmul import (abs_max_pair, abs_max_pair_plain,
                                                       int8_matmul, int8_matmul_plain, int8_mm,
                                                       int8_mm_plain, quantize_int8,
                                                       quantize_int8_plain)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(6)
    res, quant, quant_ms, wrapper_ms = {}, {}, 0.0, 0.0
    for (k, n), count in INT8_SHAPES.items():
        for m in (256, B * T):
            x = torch.randn(m, k, generator=g).to(dev)
            y = ((torch.rand(k, n, generator=g) * 2 - 1) * (6.0 / (k + n)) ** 0.5).to(dev)
            scales, ref_scales = abs_max_pair(x, y), abs_max_pair_plain(x, y)
            xq, yqt = quantize_int8(x, scales, 0, 127.0), quantize_int8(y, scales, 1, 127.0, True)
            ref_xq = quantize_int8_plain(x, scales, 0, 127.0)
            ref_yqt = quantize_int8_plain(y, scales, 1, 127.0, True)
            acc, ref_acc = int8_mm(xq, yqt), int8_mm_plain(xq, yqt)
            deq, ref_deq = int8_mm(xq, yqt, scales, 127.0), int8_mm_plain(xq, yqt, scales, 127.0)
            out, ref_out = int8_matmul(x, y), int8_matmul_plain(x, y)
            torch.cuda.synchronize()
            checks = {"abs-max pair": torch.equal(scales, ref_scales),
                      "quantize x": torch.equal(xq, ref_xq), "quantize y^T": torch.equal(yqt, ref_yqt),
                      "int32 epilogue": torch.equal(acc, ref_acc),
                      "float32 epilogue": torch.equal(deq, ref_deq),
                      "int8_matmul": torch.equal(out, ref_out)}
            if not all(checks.values()):
                raise AssertionError(f"int8 M={m} K={k} N={n}: differs from the plain version: "
                                     f"{checks} (int32 max diff {(acc - ref_acc).abs().max().item()})")
            if m != B * T:
                continue
            ms = _ms(lambda: int8_mm(xq, yqt, scales, 127.0), 20)
            int32_ms = _ms(lambda: int8_mm(xq, yqt), 20)
            plain_ms = _ms(lambda: int8_mm_plain(xq, yqt, scales, 127.0), 5)
            # cuBLASLt on the same int8 operands, B column-major (the layout
            # it runs fastest); int32 out, no dequant
            lib_ms = _ms(lambda: torch._int_mm(xq, yqt.t()), 20)

            def quantizers():
                s = abs_max_pair(x, y)
                return quantize_int8(x, s, 0, 127.0), quantize_int8(y, s, 1, 127.0, True)

            def quantizers_plain():
                s = abs_max_pair_plain(x, y)
                return quantize_int8_plain(x, s, 0, 127.0), quantize_int8_plain(y, s, 1, 127.0, True)
            q_ms = _ms(quantizers, 20)
            q_plain_ms = _ms(quantizers_plain, 5)
            q_dev_ms = _device_ms(torch, quantizers, 10)
            w_ms = _ms(lambda: int8_matmul(x, y), 20)
            w_dev_ms = _device_ms(torch, lambda: int8_matmul(x, y), 10)
            if (k, n) == (D_MODEL, D_MODEL):
                fns = [lambda: int8_mm(xq, yqt, scales, 127.0), lambda: torch._int_mm(xq, yqt.t())]
                host_us, lib_host_us = _best(lambda fn: _host_us(torch, fn), fns)
                gemm_dev_ms = _device_ms(torch, fns[0], 50)
                print(f"K4 GEMM M={m} K={k} N={n}: host time a call (1000 calls, host clock to "
                      f"the last return, best of 3 rounds in turns) kernel {host_us:.2f} us, "
                      f"torch._int_mm {lib_host_us:.2f} us; device time (profiler) kernel "
                      f"{gemm_dev_ms} ms [{card}]")
            quant_ms += count * q_ms
            wrapper_ms += count * w_ms
            kp = xq.shape[1]
            bound_ms, bound_by = _bound(m * kp + n * kp + 4 * m * n, 2.0 * m * kp * n, INT8_OPS)
            res[(k, n)] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                               bound_ms=bound_ms, bound_by=bound_by)
            # quantizers: each input read once, each int8 output written once
            q_bound_ms, q_bound_by = _bound(4 * (m * k + k * n) + m * kp + n * kp + 8,
                                            2 * (m * k + k * n))
            quant[(k, n)] = dict(max_abs_err=0.0, ms=q_ms, plain_ms=q_plain_ms, library_ms=None,
                                 bound_ms=q_bound_ms, bound_by=q_bound_by, device_ms=q_dev_ms)
            if n == VOCAB:
                # what the card's write path gives this output: fill_ of the same bytes
                fill_ms = _ms(lambda: deq.fill_(1.0), 20)
                print(f"K4 yardstick: fill_ of the head's [{m}, {n}] float32 output {fill_ms:.4f} ms "
                      f"({4 * m * n / fill_ms / 1e9:.2f} TB/s) [{card}]")
            print(f"K4 int8_matmul M={m} K={k} N={n} (x{count} a batch): bit-equal (quantizers, "
                  f"int32 and float32 epilogues, the whole product; and at M=256); GEMM "
                  f"{ms:.4f} ms ({2.0 * m * k * n / ms / 1e9:.1f} TOP/s; int32 epilogue "
                  f"{int32_ms:.4f} ms), plain {plain_ms:.4f} ms, torch._int_mm {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({bound_by}); quantizers {q_ms:.4f} ms (device "
                  f"{q_dev_ms} ms, plain {q_plain_ms:.4f} ms, bound {q_bound_ms:.5f} ms); the "
                  f"whole int8_matmul {w_ms:.4f} ms (device {w_dev_ms} ms) [{card}]")
    print(f"K4 a served 8-row batch ({K4_PER_BATCH} products, CUDA events): int8_matmul "
          f"{wrapper_ms:.3f} ms, of which quantizers {quant_ms:.3f} ms [{card}]")
    _scale_routes(torch)
    return res, quant


def _scale_routes(torch):
    """The int8 scale expressions on the card and on the CPU: the port's
    (``quantize_ratio``, ``combined_scale``) must agree bit for bit; the
    naive forms (a Python float over a tensor, a division by a Python
    float) are reported, as torch routes them per device."""
    from paddle_tpu_torch.ops.cuda.int8_matmul import combined_scale, quantize_ratio
    g = torch.Generator().manual_seed(8)
    s = torch.rand(100000, generator=g) * 10 + 1e-3
    sx, sy = (torch.exp(3 * torch.randn(100000, generator=g)) for _ in range(2))
    on = {dev: (quantize_ratio(s.to(dev), 127.0).cpu(), combined_scale(sx.to(dev), sy.to(dev), 127.0).cpu(),
                (127.0 / s.to(dev)).cpu(), ((sx.to(dev) * sy.to(dev)) / 16129.0).cpu())
          for dev in ("cpu", "cuda")}
    same = [torch.equal(a, b) for a, b in zip(on["cpu"], on["cuda"])]
    print(f"int8 scale expressions, card vs CPU over 1e5 values: ratio {same[0]}, combined scale "
          f"{same[1]} (the port's); naive forms: 127 / s {same[2]}, (sx * sy) / 16129 {same[3]}; "
          f"on the card (sx * sy) / 16129 equals the reciprocal product: "
          f"{torch.equal(on['cuda'][3], on['cuda'][1])}")
    if not (same[0] and same[1]):
        raise AssertionError("the port's int8 scale expressions differ between the card and the CPU")


def phase_sgd(torch, card):
    """K5 on the [32000, 512] word table and a [512] vector (a table of
    one), and over the training step's 186 parameters in one launch,
    bit-equal to its plain version, beside ``torch.optim.SGD(fused=True)``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda.fused_optimizer import (_sgd_launch, fused_sgd,
                                                           fused_sgd_multi, fused_sgd_multi_plain,
                                                           fused_sgd_plain)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    res = {}
    for shape in ((VOCAB, D_MODEL), (D_MODEL,)):
        p = torch.randn(*shape, generator=g).to(dev)
        grad = (1e-2 * torch.randn(*shape, generator=g)).to(dev)
        lr = torch.tensor([0.1], device=dev)
        got, want = fused_sgd(p, grad, lr), fused_sgd_plain(p, grad, lr)
        err = _max_abs_diff(torch, [(got, want)])
        if not torch.equal(got, want):
            raise AssertionError(f"fused_sgd {shape}: differs from its plain version (max {err})")
        tp = torch.nn.Parameter(p.clone())
        tp.grad = grad.clone()
        try:
            opt, lib = torch.optim.SGD([tp], lr=0.1, fused=True), "torch.optim.SGD(fused=True)"
            opt.step()
            lib_fn = opt.step
        except (RuntimeError, TypeError, ValueError):
            lib, lib_fn = "p.add_(g, alpha=-lr)", lambda: tp.data.add_(grad, alpha=-0.1)
        # timed as the step calls it: in place (on a clone of p)
        mine = [(p.clone(), grad, lr)]
        ms = _ms(lambda: fused_sgd_multi(mine), 50)
        plain_ms = _ms(lambda: fused_sgd_plain(p, grad, lr), 20)
        lib_ms = _ms(lib_fn, 50)
        bound_ms, bound_by = _bound(3 * 4 * p.numel() + 4, 2 * p.numel())
        res[shape] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"K5 fused_sgd {list(shape)} (a table of one): bit-equal (max_abs_err {err}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {lib} {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) "
              f"[{card}]")

    ups = _step_updates(pt, sgd=True)
    gd = torch.Generator(device=dev).manual_seed(8)
    entries = [(torch.randn(s, device=dev, generator=gd),
                1e-2 * torch.randn(s, device=dev, generator=gd),
                torch.tensor([0.1], device=dev)) for s, _ in ups]
    # in place, on clones of p (the plain version on other clones)
    mine = [(e[0].clone(),) + e[1:] for e in entries]
    theirs = [(e[0].clone(),) + e[1:] for e in entries]
    before = fused_sgd.launches
    got = fused_sgd_multi(mine)
    torch.cuda.synchronize()
    if fused_sgd.launches != before + 1:
        raise AssertionError(f"fused_sgd_multi over {len(entries)}: "
                             f"{fused_sgd.launches - before} launches, want 1")
    if not all(o is e[0] for o, e in zip(got, mine)):
        raise AssertionError("fused_sgd_multi: p not updated in place")

    def plain():
        return fused_sgd_multi_plain(theirs)
    want = plain()
    err = _max_abs_diff(torch, zip(got, want))
    differ = [k for k, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"fused_sgd_multi: entries {differ[:8]} ({len(differ)} of "
                             f"{len(entries)}) differ from their plain versions")
    del got, want
    floats = sum(e[0].numel() for e in entries)
    launch = _sgd_launch(mine, [e[0].numel() for e in entries])
    step = _timed_step(torch, lambda: fused_sgd_multi(mine), launch, plain, fused_sgd)
    # p, grad read and p written; lr read an entry
    bound_ms, bound_by = _bound(3 * 4 * floats + 4 * len(entries), 2 * floats)
    print(f"K5 fused_sgd_multi over the training step's {len(entries)} parameters ({floats} "
          f"floats), one launch: bit-equal to the plain version (max_abs_err {err}); the call {step['ms']:.4f} ms "
          f"(events; host {step['host_us']:.0f} us a call), the kernel alone "
          f"{step['kernel_ms']:.4f} ms (events), device {step['device_ms']} ms (profiler: "
          f"{json.dumps(step['device_ops'])}), plain {step['plain_ms']:.2f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); in place [{card}]")
    del entries, mine, theirs
    torch.cuda.empty_cache()
    lib = _library_step(torch, card, "torch.optim.SGD(fused=True)",
                        lambda ps: torch.optim.SGD(ps, lr=0.1, fused=True), 3 * 4)
    res["step"] = dict(step, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=lib["library_ms"], library_device_ms=lib["library_device_ms"])
    print(f"K5 a step: the kernel {step['kernel_ms']:.4f} ms, the call {step['ms']:.4f} ms, "
          f"against SGD(fused=True) {lib['library_ms']:.4f} ms and the bound {bound_ms:.4f} ms "
          f"(events; device {step['device_ms']} against {lib['library_device_ms']}) [{card}]")
    return res


def _train_programs(pt, sgd=False):
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
        opt = pt.optimizer.SGD(learning_rate=0.1) if sgd else pt.optimizer.Adam(learning_rate=1e-3)
        opt.minimize(loss)
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
    from paddle_tpu_torch.ops.cuda import (embedding, flash_attention, fused_optimizer,
                                           int8_matmul, linear_ce)
    return {"flash_attn_fwd": flash_attention.flash_attn_fwd,
            "gather_rows": embedding.gather_rows,
            "scatter_add_rows": embedding.scatter_add_rows,
            "int8_matmul": int8_matmul.int8_matmul,
            "abs_max_pair": int8_matmul.abs_max_pair,
            "quantize_int8": int8_matmul.quantize_int8,
            "fused_sgd": fused_optimizer.fused_sgd,
            "fused_adam": fused_optimizer.fused_adam,
            "linear_ce_fwd": linear_ce.linear_ce_fwd,
            "linear_ce_bwd": linear_ce.linear_ce_bwd}


def _train_entry(exe, fetch_names):
    """The executor's graph entry of the full-width step fetching
    ``fetch_names``."""
    (entry,) = [e for e in exe._cache.values() if e.graph is not None
                and e.fetch_names == list(fetch_names) and e.feeds["lbl"][0][0] == TRAIN_B]
    return entry


def _gate_step_profile(prof, want, label):
    """The launches a training step makes, read from its profile by kernel
    family (a replay calls no wrapper, so this is what the card ran)."""
    if prof is None:
        raise AssertionError(f"{label}: the profiler recorded no device activity; the "
                             f"per-step launch gates read it")
    got = {f: prof["by_family_launches"].get(f, 0) for f in want}
    if got != want:
        raise AssertionError(f"{label}: device launches a step {got}, want {want}")
    print(f"{label}: device launches a step from the profile {got} (gate {want})")


def _step_families(sgd=False):
    """Kernel launches a full-width step makes on the device, by profile
    family: K3 and K7 are 2 kernels a call, K8 32."""
    return {"flash_attn_fwd (K1)": PER_STEP["flash_attn_fwd"],
            "gather_rows (K2)": PER_STEP["gather_rows"],
            "scatter_add_rows (K3)": 2 * PER_STEP["scatter_add_rows"],
            "linear_ce_fwd (K7)": 2, "linear_ce_bwd (K8)": 32,
            "fused_sgd (K5)" if sgd else "fused_adam (K6)": 1}


def phase_training(torch, card, sgd=False):
    """Full-width transformer-base training on the card through the kernel
    tier (``Executor(kernels=True)``, the default on the card), on one fixed
    batch, each step one CUDA graph replay: the graph captured by
    ``precompile`` (writing nothing), then with Adam one warm-up and three
    timed steps (losses falling) and with SGD one warm-up and two timed
    steps; the allocated memory flat from step 2; the launches a step from
    the wrappers' counters and from a profile; then phase 17."""
    import paddle_tpu_torch as pt
    label = "SGD training" if sgd else "training"
    steps, per_step = (3, PER_STEP_SGD) if sgd else (4, PER_STEP)
    t0 = time.perf_counter()
    main, startup, loss = _train_programs(pt, sgd=sgd)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0), kernels=True)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    params = main.global_block.all_parameters()
    n_floats = sum(int(np.prod(p.shape)) for p in params)
    feed = _train_feed(TRAIN_B, seed=0)
    ops = [o.type for o in main.desc.block(0).ops]
    run_ops = [o.type for o in exe._apply_passes(main, list(feed), [loss.name]).desc.block(0).ops]
    kinds = ("sgd", "pallas_sgd", "adam", "pallas_adam", "pallas_gather", "pallas_scatter_add")
    print(f"transformer-base {label} program: {len(ops)} ops ({ops.count('sum')} sum), "
          f"{len(params)} parameters, {n_floats} floats; after the kernel pass "
          f"{ {k: run_ops.count(k) for k in kinds} }; built and initialized on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    if len(params) != N_PARAMS:
        raise AssertionError(f"{len(params)} parameters, want {N_PARAMS}")
    persist = [v.name for v in main.list_vars()
               if v.persistable and scope.find_var(v.name) is not None]
    before = {n: scope.find_var(n).clone() for n in persist}
    addrs = {n: scope.find_var(n).data_ptr() for n in persist}
    rec = exe.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
    torch.cuda.synchronize()
    wrote = [n for n in persist if not torch.equal(before[n], scope.find_var(n))]
    print(f"{label}: precompile -> kind {rec['kind']}, capture {rec['compile_s']:.3f} s (an eager "
          f"run on clones of the written state, then the capture), reasons {rec['reasons']}; "
          f"state written by it: {len(wrote)} of {len(persist)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB [{card}]")
    if rec["kind"] != "graph" or wrote:
        raise AssertionError(f"{label}: precompile gave kind {rec['kind']} and wrote {wrote[:8]}")
    state0 = before
    del before
    counters = _counters()
    captures = exe.cache_info()["captures"]
    for f in counters.values():
        f.launches = 0
    losses, step_s, mem = [], [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(l))
        mem.append(torch.cuda.memory_allocated())
        if step == 0:
            after1 = {p.name: scope.find_var(p.name).clone() for p in params}
            unchanged = [p.name for p in params if torch.equal(state0[p.name], after1[p.name])]
            if unchanged:
                raise AssertionError(f"{label}: parameters unchanged by step 1: {unchanged}")
            if sgd:
                state0 = None
    launches = {k: f.launches for k, f in counters.items()}
    info = exe.cache_info()
    entry = {k: v for k, v in _train_entry(exe, [loss.name]).info().items() if k != "feeds"}
    print(f"{label} losses {losses}; step times (s) {[round(s, 4) for s in step_s]}; allocated "
          f"bytes after each step {mem}; captures over the steps "
          f"{info['captures'] - captures}; the step's entry {json.dumps(entry)}")
    if not np.isfinite(losses).all() or not (sgd or all(a > b for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f"{label}: losses not finite{'' if sgd else ' and falling'}: {losses}")
    if info["captures"] != captures or mem[1] != mem[-1]:
        raise AssertionError(f"{label}: {info['captures'] - captures} captures over the steps, "
                             f"allocated bytes {mem}")
    moved = [n for n in persist if scope.find_var(n).data_ptr() != addrs[n]]
    if moved:
        raise AssertionError(f"{label}: state tensors moved: {moved[:8]}")
    want = {k: steps * v for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{label}: launches over {steps} steps {launches}, want {want}")
    print(f"launches on the {label} path over {steps} steps: {launches} (per step {per_step}); "
          f"every one of the {len(persist)} state tensors at its address")
    if state0 is not None:
        # step 1 again, from the same state (copied in place: the same graph
        # replays) and feed: bit-equal parameters need every kernel and op on
        # the path to add in a fixed order
        for n, t in state0.items():
            scope.find_var(n).copy_(t)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        differ = [p.name for p in params if not torch.equal(after1[p.name], scope.find_var(p.name))]
        first = ""
        if differ:
            a, c = after1[differ[0]], scope.find_var(differ[0])
            first = (f"; the first that differs: {differ[0]} (max abs diff "
                     f"{(a - c).abs().max().item():.3e}, {int((a != c).sum())} of {a.numel()} "
                     f"elements)")
        print(f"{label}: step 1 taken again from the same state and feed: parameters "
              f"{'bit-equal' if not differ else 'not bit-equal'} ({len(params) - len(differ)} of "
              f"{len(params)} bit-equal){first}; differing: {differ[:12]}")
        if differ:
            raise AssertionError(f"{label}: the repeated step is not bit-equal")
        del state0
    del after1
    step_ms = 1e3 * float(np.mean(step_s[1:]))
    if not sgd:
        PHASE7["tokens_per_s"] = TRAIN_B * T / step_ms * 1e3
    real = int(feed["trg@SEQ_LEN"].sum())
    print(f"{label} step: {step_ms:.2f} ms mean of {steps - 1} timed step(s) (host clock to the "
          f"loss on the host, one graph replay a step); {TRAIN_B * T / step_ms * 1e3:.0f} tokens/s "
          f"at batch {TRAIN_B} x {T} (padded), {real / step_ms * 1e3:.0f} target tokens/s within "
          f"the lengths; peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
          f"[{card}]")
    prof = _profile(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
                    "sgd_training_profile" if sgd else "training_profile", card,
                    {"batch": [TRAIN_B, T]})
    _gate_step_profile(prof, _step_families(sgd), label)
    _step_graph_vs_eager(torch, exe, main, feed, loss, scope,
                         "float32 SGD" if sgd else "float32 Adam", card, _step_families(sgd))
    return launches, steps


def _step_graph_vs_eager(torch, exe, main, feed, loss, scope, label, card, families):
    """Phase 17, for one training path (run inside phases 7, 12 and 14,
    before each drops its executor): the step through its graph
    (``Executor.run``, a replay) against the same step op by op
    (``Executor._run_eager``) from the same state and feed, loss and every
    state tensor bit-equal; then the capture's seconds, ``CUDAGraph.replay``'s
    host microseconds, the wall a step and tokens/s through the graph and
    eagerly in alternating turns, the peak device memory of a step each
    way, and a profile of each (device idle share; the eager step's
    launches gated as the replay's)."""
    entry = _train_entry(exe, [loss.name])
    persist = [v.name for v in main.list_vars() if v.persistable]
    state0 = {n: scope.find_var(n).clone() for n in persist}
    (g_loss,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    (e_loss,) = exe._run_eager(main, feed, [loss], scope)
    differ = [n for n in persist if not torch.equal(after[n], scope.find_var(n))]
    del state0, after
    bit_equal = not differ and np.array_equal(g_loss, e_loss)
    print(f"{label}: the step replayed vs op by op from the same state and feed: loss "
          f"{float(g_loss):.7f} / {float(e_loss):.7f}; {len(persist) - len(differ)} of "
          f"{len(persist)} state tensors bit-equal ({'bit-equal' if bit_equal else 'NOT'}); "
          f"differing {differ[:8]}")
    if not bit_equal:
        raise AssertionError(f"{label}: a replayed step differs from the eager step: {differ[:8]}")

    def graph():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    def eager():
        return exe._run_eager(main, feed, [loss], scope)
    replay_us = [v * 1e3 for v in _host_ms(torch, entry.graph.replay, 5)]
    torch.cuda.synchronize()
    walls = {"graph": [], "eager": []}
    for _ in range(3):
        for name, fn in (("graph", graph), ("eager", eager)):
            walls[name] += _host_ms(torch, fn, 1)
    peak = {}
    for name, fn in (("graph", graph), ("eager", eager)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak[name] = {"max_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
    out = {"card": card, "capture_s": entry.compile_s,
           "host_us_replay": float(np.median(replay_us)), "host_us_replay_all": replay_us,
           "wall_ms": {k: {"min": min(v), "median": float(np.median(v)), "all": v}
                       for k, v in walls.items()},
           "tokens_per_s": {k: TRAIN_B * T / float(np.median(v)) * 1e3 for k, v in walls.items()},
           "peak_memory": peak, "launches_captured": entry.info()["launches"]}
    for name, fn in (("graph", graph), ("eager", eager)):
        tag = label.replace(" ", "_")
        prof = _profile(torch, fn, f"{tag}_step_{name}_profile", card, {"batch": [TRAIN_B, T]})
        _gate_step_profile(prof, families, f"{label} ({name})")
        out[f"{name}_profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                      "device_idle_share")}
    w = out["wall_ms"]
    print(f"{label} step through its graph vs op by op: capture {out['capture_s']:.3f} s; "
          f"CUDAGraph.replay {out['host_us_replay']:.0f} host us; wall a step graph "
          f"{w['graph']['median']:.2f} ms ({out['tokens_per_s']['graph']:.0f} tokens/s), eager "
          f"{w['eager']['median']:.2f} ms ({out['tokens_per_s']['eager']:.0f} tokens/s) (medians "
          f"of 3 in turns); device idle share graph "
          f"{out['graph_profile']['device_idle_share']:.3f}, eager "
          f"{out['eager_profile']['device_idle_share']:.3f}; peak memory {json.dumps(peak)} [{card}]")
    print(json.dumps({f"training_graph_{label.replace(' ', '_')}": out}))
    return out


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
    with TF32 on is the control the gates must reject.  The bf16 step's
    error against the same witness is printed with cuBLAS's reduced-
    precision bf16 reductions allowed and not, and each of its gradients is
    held against the same program's bf16 step on the CPU (plain versions),
    with the stale-cast program as the control."""
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
    grads = [p.name + "@GRAD" for p in main.global_block.all_parameters()]
    fetch = [loss.name] + [n + "@GRAD" for n in names] + relu_in + grads
    feed = _train_feed(2, seed=1)
    k_r, k_g = len(names) + 1, len(names) + 1 + len(relu_in)

    def step(on_card, arrays, prog=main, kernels=None):
        """(loss and the gated gradients, ReLU inputs, every gradient, s)"""
        scope = pt.Scope()
        pt.params_from_numpy(arrays, scope, "cuda" if on_card else "cpu")
        exe = pt.Executor(pt.CUDAPlace(0) if on_card else pt.CPUPlace(), kernels=kernels)
        t0 = time.perf_counter()
        out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        out = [np.asarray(o, np.float64) for o in out]
        return out[:k_r], out[k_r:k_g], out[k_g:], time.perf_counter() - t0

    got, got_r, got_g, _ = step(True, init)
    cpu32, cpu32_r, _, s32 = step(False, init)
    cpu64, cpu64_r, cpu64_g, s64 = step(False, {n: a.astype(np.float64) if a.dtype == np.float32
                                                else a for n, a in init.items()})
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, tf32_r, _, _ = step(True, init)
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
    # the same step in bf16 (enable_amp) on the card, with cuBLAS allowed to
    # reduce bf16 GEMM partial sums in reduced precision (PyTorch's default)
    # and not: each one's error against the float64 witness
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    bf16_errs, bf16_grads = {}, {}
    try:
        for allow in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allow
            with pt.amp.amp_guard(main):
                b16, _, bf16_grads[allow], _ = step(True, init)
            bf16_errs[f"allow_bf16_reduced_precision_reduction={allow}"] = \
                _step_errs(names, b16, cpu64)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    print(f"the same step in bf16 (enable_amp) on the card against float64: "
          f"{json.dumps(bf16_errs)} (PyTorch's default: {flag}) [{card}]")
    if not all(np.isfinite([g["norm_rel"] for n, g in e.items() if n != "loss_rel"]).all()
               for e in bf16_errs.values()):
        raise AssertionError(f"bf16 step on the card: a gradient is not finite: {bf16_errs}")

    # Every gradient of the bf16 step against float64, beside an independent
    # bf16 computation of the same rewritten program: the port on the CPU
    # with the kernel tier's op types, where every kernel runs its plain
    # version and every product is the CPU's.  The stale-cast program on the
    # card is the control.
    with pt.amp.amp_guard(main):
        _, _, cpu_b16_g, s_b16 = step(False, init, kernels=True)
        rewritten = pt.Executor(pt.CUDAPlace(0))._apply_passes(main, list(feed), fetch)
    stale, _ = _stale_variant(rewritten)
    _, _, stale_g, _ = step(True, init, prog=stale)

    def nrel(a, r):
        return float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-300))
    e = {who: {n: nrel(a, r) for n, a, r in zip(grads, g, cpu64_g)}
         for who, g in (("card_bf16", bf16_grads[flag]), ("cpu_bf16_plain", cpu_b16_g),
                        ("card_fp32", got_g), ("stale_control", stale_g))}
    vs_fp32 = {n: nrel(a, r) for n, a, r in zip(grads, bf16_grads[flag], got_g)}

    def over(who):     # gradients outside the gate, with their excess
        return {n: e[who][n] / (BF16_WITNESS_FACTOR * e["cpu_bf16_plain"][n]
                                + BF16_WITNESS_FLOOR)
                for n in grads if e[who][n] > BF16_WITNESS_FACTOR * e["cpu_bf16_plain"][n]
                + BF16_WITNESS_FLOOR}
    worst = sorted(grads, key=lambda n: -e["card_bf16"][n])[:8]
    ratio = {n: e["card_bf16"][n] / max(e["cpu_bf16_plain"][n], 1e-300) for n in grads}
    print(f"every gradient ({len(grads)}) of the bf16 step at 2 x {T} against float64, norm-"
          f"relative (CPU bf16 step {s_b16:.1f} s): the worst on the card "
          f"{json.dumps({n: {k: round(e[k][n], 5) for k in e} | {'vs_card_fp32': round(vs_fp32[n], 5)} for n in worst})}; "
          f"card over CPU plain: max {max(ratio.values()):.3f}, median "
          f"{float(np.median(list(ratio.values()))):.3f}; card float32 at most "
          f"{max(e['card_fp32'].values()):.2e}; gate: each card gradient at most "
          f"{BF16_WITNESS_FACTOR:g} x the CPU's + {BF16_WITNESS_FLOOR:g}; outside it: card "
          f"{len(over('card_bf16'))}, stale control {len(over('stale_control'))} [{card}]")
    if over("card_bf16"):
        raise AssertionError(f"bf16 step on the card: gradients outside the witness gate: "
                             f"{over('card_bf16')}")
    if not over("stale_control"):
        raise AssertionError("the stale-cast control passes the witness gate")


def _bf16_ulp(torch, t):
    """The bf16 spacing at each element's magnitude."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def _bf16_running_sum(torch, vocab, ids, rows):
    """The control for K3's bf16 instance, on the CPU: each table row adds
    its rows in ascending n, rounded to bf16 after every add.  (index_add_
    into a bf16 table sums in float32 on the CPU.)"""
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    pos = torch.arange(len(sid))
    start = torch.ones(len(sid), dtype=torch.bool)
    start[1:] = sid[1:] != sid[:-1]
    nth = pos - torch.cummax(torch.where(start, pos, 0), 0).values   # place within the segment
    acc = torch.zeros(vocab, rows.shape[1], dtype=torch.bfloat16)
    for j in range(int(nth.max()) + 1 if len(sid) else 0):
        sel = order[nth == j]
        t = ids[sel]
        acc[t] = (acc[t].float() + rows[sel].float()).to(torch.bfloat16)
    return acc


def _norm_rel64(got, ref):
    return ((got.double() - ref).norm() / ref.norm()).item()


def phase_bf16_kernels(torch, card):
    """The bf16 instances of K1, K3 and K7 at the bf16 step's shapes, each
    against its plain version and against float64 over the same
    bf16-rounded inputs, with a control that the float64 gate must reject."""
    from paddle_tpu_torch.ops.cuda.embedding import scatter_add_rows, scatter_add_rows_plain
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
    from paddle_tpu_torch.ops.cuda.linear_ce import gemm_bf16, linear_ce_fwd, linear_ce_fwd_plain
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(11)
    res = {}

    # K1 at the training batch's shapes: 64 x 8 heads, T 256, head_dim 64
    train = _train_feed(TRAIN_B, seed=0)
    scale = D_HEAD ** -0.5
    key_pos = torch.arange(T, device=dev)
    for row_lens, causal in ((train["src@SEQ_LEN"], False), (train["trg@SEQ_LEN"], True)):
        rows = len(row_lens)
        q, k, v = (torch.randn(rows * H, T, D_HEAD, generator=g).to(bf).to(dev) for _ in range(3))
        lens = torch.from_numpy(np.repeat(row_lens, H)).to(dev)
        out, lse = flash_attn_fwd(q, k, v, lens, causal, scale)
        ref, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, scale)
        o64, l64 = flash_attn_fwd_plain(q.double(), k.double(), v.double(), lens, causal, scale)
        # the control: the same float32 attention with P rounded to bf16
        # before p.v (what bf16 tensor-core products would do)
        mask = key_pos[None, None, :] < lens[:, None, None]
        if causal:
            mask = mask & (key_pos[:, None] >= key_pos[None, :])
        sc = torch.einsum("bqd,bkd->bqk", q.float() * scale, k.float()).masked_fill(~mask, -np.inf)
        p = torch.exp(sc - sc.amax(-1, keepdim=True)).to(bf).float()
        ctl = (torch.einsum("bqk,bkd->bqd", p, v.float()) / p.sum(-1, keepdim=True)).to(bf)
        del sc, p
        torch.cuda.synchronize()
        if out.dtype != bf or lse.dtype != torch.float32:
            raise AssertionError(f"flash_attn_fwd bf16 causal={causal}: out {out.dtype}, lse "
                                 f"{lse.dtype}")
        mag = torch.maximum(out.float().abs(), ref.float().abs())
        vs_plain = (((out.float() - ref.float()).abs() - FLASH_TOL).clamp_min(0)
                    / _bf16_ulp(torch, mag)).max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (vs_plain <= 1 and lse_err <= FLASH_TOL):
            raise AssertionError(f"flash_attn_fwd bf16 causal={causal} vs plain: {vs_plain} bf16 "
                                 f"ulps over {FLASH_TOL}, lse {lse_err}")
        off = {who: ((x.double() - o64).abs() - BF16_HALF_ULP * _bf16_ulp(
                   torch, torch.maximum(x.double().abs(), o64.abs())) - FLASH_TOL).max().item()
               for who, x in (("K1", out), ("control", ctl))}
        nrel = {who: _norm_rel64(x, o64) for who, x in (("K1", out), ("control", ctl))}
        lse64 = (lse.double() - l64).abs().max().item()
        print(f"flash_attn_fwd bf16 causal={causal} against float64 over the same bf16 inputs: "
              f"norm-relative {json.dumps(nrel)}; largest excess over half a bf16 ulp + "
              f"{FLASH_TOL} {json.dumps(off)} (K1 must be <= 0, the control > 0); lse {lse64:.2e}")
        if not (off["K1"] <= 0 and off["control"] > 0 and lse64 <= FLASH_TOL):
            raise AssertionError(f"flash_attn_fwd bf16 vs float64: outside the gate: {off}, lse {lse64}")
        q4, k4, v4 = (x.reshape(rows, H, T, D_HEAD) for x in (q, k, v))
        mask4 = mask.reshape(rows, H, T, T) if causal else mask.reshape(rows, H, 1, T)
        def k1():
            return flash_attn_fwd(q, k, v, lens, causal, scale)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, scale=scale)
        ms = _ms(k1, 20)
        plain_ms = _ms(lambda: flash_attn_fwd_plain(q, k, v, lens, causal, scale), 3)
        lib_ms = _ms(sdpa, 20)
        # back-to-back event times can be bound by the host's cost a call:
        # the device's own time by kernel, and the host microseconds a call
        # (100 calls: the launch queue does not fill), beside them; float32
        # K1 on the same inputs widened shares the Python path and encodes
        # no TMA descriptor, so the difference bounds what caching K1 bf16's
        # three descriptors could save
        q32, k32, v32 = q.float(), k.float(), v.float()
        dev_k1, dev_lib = (_device_by_kernel(torch, fn, 20) for fn in (k1, sdpa))
        host_us, lib_host_us, f32_host_us = _best(
            lambda fn: _host_us(torch, fn, 100),
            [k1, sdpa, lambda: flash_attn_fwd(q32, k32, v32, lens, causal, scale)])
        del q32, k32, v32
        pairs = _attn_pairs(row_lens, causal)
        bound = _attn_bound(2 * 4 * q.numel() + 4 * (lse.numel() + lens.numel()), pairs,
                            BF16_FLOPS, BF16_FLOPS / 2)
        res[("flash", causal)] = dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
                                      ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound,
                                      device_ms=sum(dev_k1.values()) or None,
                                      library_device_ms=sum(dev_lib.values()) or None,
                                      host_us=host_us, library_host_us=lib_host_us)
        print(f"K1 flash_attn_fwd bf16 B*H={rows * H} T={T} d={D_HEAD} causal={causal}: within "
              f"{vs_plain:.2f} bf16 ulps (+{FLASH_TOL}) of plain; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa bf16 {lib_ms:.4f} ms (kernel / sdpa {ms / lib_ms:.2f}), "
              f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']}; q.k^T and p.v as one and "
              f"two bf16 products on the tensor cores), {bound['bound_fp32_ms']:.5f} ms on the "
              f"float32 CUDA cores; device time by kernel (profiler) K1 "
              f"{json.dumps({k: round(t, 5) for k, t in dev_k1.items()})}, sdpa "
              f"{json.dumps({k: round(t, 5) for k, t in dev_lib.items()})}; host us a call "
              f"K1 {host_us:.1f}, sdpa {lib_host_us:.1f}, float32 K1 {f32_host_us:.1f} [{card}]")
        del q, k, v, ref, o64, ctl

    # K3 into bf16 word and position tables, 16384 ids (_scatter_ids)
    n = TRAIN_B * T
    for case in SCATTER_CASES:
        vocab, ids = _scatter_ids(torch, case, g, n)
        w = torch.zeros(vocab, D_MODEL, device=dev, dtype=bf)
        rows = torch.randn(n, D_MODEL, generator=g).to(bf)
        want = scatter_add_rows_plain(w.cpu(), ids, rows)
        d_ids, d_rows = ids.to(dev), rows.to(dev)
        got, again = scatter_add_rows(w, d_ids, d_rows), scatter_add_rows(w, d_ids, d_rows)
        torch.cuda.synchronize()
        if got.dtype != bf or not torch.equal(got.cpu(), want) or not torch.equal(got, again):
            raise AssertionError(f"scatter_add_rows bf16 [{vocab},{D_MODEL}]: not bit-equal to its "
                                 f"plain version on the CPU, or two calls differ")
        valid = (ids >= 0) & (ids < vocab)
        vi, vr = ids[valid].long(), rows[valid]
        r64 = torch.zeros(vocab, D_MODEL, dtype=torch.float64).index_add_(0, vi, vr.double())
        a64 = torch.zeros(vocab, D_MODEL, dtype=torch.float64).index_add_(0, vi, vr.double().abs())
        cnt = torch.bincount(vi, minlength=vocab).double()[:, None]
        ctl = _bf16_running_sum(torch, vocab, vi, vr)
        off = {who: ((x.double() - r64).abs() - BF16_HALF_ULP * _bf16_ulp(
                   torch, torch.maximum(x.double().abs(), r64.abs()))
                   - cnt * 2.0 ** -24 * a64).max().item()
               for who, x in (("K3", got.cpu()), ("control", ctl))}
        nrel = {who: _norm_rel64(x, r64) for who, x in (("K3", got.cpu()), ("control", ctl))}
        print(f"scatter_add_rows bf16 {_scatter_label(vocab, case, n)} against float64 sums: norm-relative {json.dumps(nrel)}; largest excess over half a "
              f"bf16 ulp + the float32 summation bound {json.dumps(off)} (K3 must be <= 0, the "
              f"control > 0)")
        if not (off["K3"] <= 0 and off["control"] > 0):
            raise AssertionError(f"scatter_add_rows bf16 vs float64: outside the gate: {off}")
        d_vi, d_vr = vi.to(dev), vr.to(dev)
        ms = _ms(lambda: scatter_add_rows(w, d_ids, d_rows), 50)
        plain_ms = _ms(lambda: scatter_add_rows_plain(w, d_ids, d_rows), 20)
        lib_ms = _ms(lambda: torch.zeros(vocab, D_MODEL, device=dev).index_add_(
            0, d_vi, d_vr.float()).to(bf), 50)
        nvalid = int(valid.sum())
        bound_ms, bound_by = _bound(4 * n + 2 * (nvalid + vocab) * D_MODEL, nvalid * D_MODEL)
        by_kernel = _device_by_kernel(torch, lambda: scatter_add_rows(w, d_ids, d_rows), 20)
        host_us = _host_us(torch, lambda: scatter_add_rows(w, d_ids, d_rows), 200)
        res[("scatter", case)] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=bound_ms, bound_by=bound_by,
                                      device_ms=sum(by_kernel.values()) or None, host_us=host_us)
        print(f"K3 scatter_add_rows bf16 {_scatter_label(vocab, case, n)}: bit-equal to its plain "
              f"version on the CPU, two calls bit-equal; kernel {ms:.4f} ms, plain on the card "
              f"{plain_ms:.4f} ms, float32 index_add_ then .to(bfloat16) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}); device time by kernel (profiler) "
              f"{json.dumps({k: round(v, 5) for k, v in by_kernel.items()})}; host us a call "
              f"{host_us:.1f} [{card}]")
        del w, got, again, want, r64, a64, ctl

    # K7 at the loss head: x [16384, 512] and W [512, 32000] bf16, bias float32
    rows = TRAIN_B * T
    lim = (6.0 / (D_MODEL + VOCAB)) ** 0.5
    x = torch.randn(rows, D_MODEL, generator=g).to(bf).to(dev)
    w = ((torch.rand(D_MODEL, VOCAB, generator=g) * 2 - 1) * lim).to(bf).to(dev)
    b = (0.01 * torch.randn(VOCAB, generator=g)).to(dev)
    labels = torch.randint(0, VOCAB, (rows,), generator=g, dtype=torch.int32).to(dev)
    idx, lbl = torch.arange(rows, device=dev), labels.long()

    def from_logits(logits):
        return torch.logsumexp(logits, dim=-1), logits[idx, lbl]

    def lib_fwd():    # cuBLAS bf16 GEMM (bf16 out), then the float32 bias and lse
        return from_logits(torch.matmul(x, w).float() + b)

    lse, lab = linear_ce_fwd(x, w, b, labels)
    again = linear_ce_fwd(x, w, b, labels)
    ref = linear_ce_fwd_plain(x, w, b, labels)
    r64 = linear_ce_fwd_plain(x.double(), w.double(), b.double(), labels)
    f32 = from_logits(x.float() @ w.float() + b)
    ctl = lib_fwd()
    torch.cuda.synchronize()
    if not (torch.equal(lse, again[0]) and torch.equal(lab, again[1])):
        raise AssertionError("linear_ce_fwd bf16: two calls on the same inputs differ")
    rel = max(_rel(lse, ref[0]), _rel(lab, ref[1]))
    if not rel <= CE_RTOL:
        raise AssertionError(f"linear_ce_fwd bf16 vs plain: relative error {rel} > {CE_RTOL}")
    vs64 = {who: {n_: _norm_rel64(o, r) for n_, o, r in zip(("lse", "label_logit"), outs, r64)}
            for who, outs in (("K7", (lse, lab)), ("cublas_fp32_of_widened", f32),
                              ("bf16_logits_control", ctl))}
    print(f"linear_ce_fwd bf16 against float64 over the same bf16 inputs: {json.dumps(vs64)}; "
          f"gate: K7 at most {K7_VS_FP32_FACTOR:g}x the float32 composition's error, the control "
          f"(logits rounded to bf16) at least {K8_VS_TF32_FACTOR:g}x above K7's on the label "
          f"logit (on lse where it separates from float32 there) [{card}]")
    for n_ in ("lse", "label_logit"):
        k7, fp32, c = (vs64[who][n_] for who in ("K7", "cublas_fp32_of_widened",
                                                 "bf16_logits_control"))
        separates = n_ == "label_logit" or c >= K8_VS_TF32_FACTOR * fp32
        if not (k7 <= K7_VS_FP32_FACTOR * fp32 and (not separates or k7 * K8_VS_TF32_FACTOR <= c)):
            raise AssertionError(f"linear_ce_fwd bf16 {n_} vs float64: K7 {k7}, float32 {fp32}, "
                                 f"control {c}: outside the gate")
    err = max((lse - ref[0]).abs().max().item(), (lab - ref[1]).abs().max().item())
    del r64, f32, ctl, again
    ms = _ms(lambda: linear_ce_fwd(x, w, b, labels), 10)
    plain_ms = _ms(lambda: linear_ce_fwd_plain(x, w, b, labels), 3)
    lib_ms = _ms(lib_fwd, 10)
    # the mainloop alone, writing its float32 product (2.1 GB: a floor of its
    # own, 0.63 ms at the memory's rate), so an upper bound on the mainloop
    gemm_ms = _ms(lambda: gemm_bf16(w, x), 5)
    flops = 2.0 * rows * D_MODEL * VOCAB
    bound_ms, bound_by = _bound(2 * (x.numel() + w.numel()) + 4 * (b.numel() + 3 * rows), flops,
                                BF16_FLOPS)
    by_kernel = _device_by_kernel(torch, lambda: linear_ce_fwd(x, w, b, labels), 3)
    res["linear_ce_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bound_ms=bound_ms, bound_by=bound_by)
    print(f"linear_ce_fwd bf16 device time by kernel (profiler): "
          f"{json.dumps({k: round(v, 5) for k, v in by_kernel.items()})} [{card}]")
    print(f"K7 linear_ce_fwd bf16 x=[{rows},{D_MODEL}] W=[{D_MODEL},{VOCAB}]: max_abs_err {err:.3e}"
          f", rel {rel:.3e} (tol {CE_RTOL} rel), two calls bit-equal; kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s bf16), its mainloop alone writing the float32 "
          f"product (gemm_bf16) {gemm_ms:.3f} ms, plain {plain_ms:.3f} ms, cuBLAS bf16 matmul + "
          f"bias + logsumexp {lib_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) [{card}]")
    return res


def stale_reads(ops):
    """Indices of ops that read a cast's output after the cast's source was
    written again (and before the cast's output was)."""
    out = set()
    for i, c in enumerate(ops):
        if c.type != "cast":
            continue
        x, y = c.input("X")[0], c.output("Out")[0]
        moved = False
        for k in range(i + 1, len(ops)):
            if moved and y in ops[k].input_names():
                out.add(k)
            if y in ops[k].output_names():
                break
            if x in ops[k].output_names():
                moved = True
    return sorted(out)


def _stale_variant(program):
    """An amp-bf16 rewrite without the casts that re-cast a merged gradient
    (a cast of X to X@FP32 or X@BF16 whose output an earlier cast wrote):
    the reference pass's rewrite, whose later float32 readers of a merged
    gradient read the cast of its first contribution (the control)."""
    stale = program.clone()
    block = stale.desc.block(0)
    seen, drop = set(), []
    for i, op in enumerate(block.ops):
        if op.type != "cast":
            continue
        src, dst = op.input("X")[0], op.output("Out")[0]
        if dst in (src + "@FP32", src + "@BF16"):
            if dst in seen:
                drop.append(i)
            seen.add(dst)
    for i in reversed(drop):
        del block.ops[i]
    stale.desc._bump()
    stale.sync_with_desc()
    return stale, len(drop)


def phase_bf16_step(torch, card):
    """bf16 AMP training at full width through ``enable_amp`` (the kernel
    tier, then the amp-bf16 bridge) and ``Executor(amp=AmpConfig())``."""
    import paddle_tpu_torch as pt
    main, startup, loss = _train_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block.all_parameters()]
    persist = [v.name for v in main.list_vars()
               if v.persistable and scope.find_var(v.name) is not None]
    state0 = {n: scope.find_var(n).clone() for n in persist}
    feed = _train_feed(TRAIN_B, seed=0)
    fetch = [loss.name] + [p + "@GRAD" for p in params]

    def from_state0(prog, executor=exe, fetch_list=fetch):
        # op by op: each of these programs would hold a full-width graph's
        # memory pool (phase 17 holds the graph to this path)
        for n, t in state0.items():
            scope.find_var(n).copy_(t)
        return executor._run_eager(prog, feed, fetch_list, scope)

    f32 = from_state0(main)
    with pt.amp.amp_guard(main):
        bf16 = from_state0(main)
        rewritten = exe._apply_passes(main, list(feed), fetch)
    left = stale_reads(rewritten.desc.block(0).ops)
    if left:
        raise AssertionError(f"the port's amp-bf16 rewrite leaves {len(left)} stale reads")
    stale, n_dropped = _stale_variant(rewritten)
    ctl = from_state0(stale)
    cfg = from_state0(main, pt.Executor(pt.CUDAPlace(0), amp=pt.amp.AmpConfig()))
    ops = stale.desc.block(0).ops
    behind = sorted({n for k in stale_reads(ops) if ops[k].type == "layer_norm_grad"
                     for slot in ("Scale@GRAD_SLOT", "Bias@GRAD_SLOT")
                     for n in ops[k].outputs.get(slot, []) if n})
    types = [o.type for o in rewritten.desc.block(0).ops]
    print(f"bf16 step program (enable_amp, kernel tier then the bridge): {len(types)} ops, "
          f"{types.count('cast')} casts; the control drops {n_dropped} re-casts of merged gradients "
          f"({len(stale_reads(ops))} stale reads, {len(behind)} layer_norm gradients behind them)")

    def nrel(a, r):
        return float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))
    runs = (("bf16", bf16), ("amp_config", cfg), ("stale_control", ctl))
    errs = {who: {n: nrel(a, r) for n, a, r in zip(fetch[1:], got[1:], f32[1:])}
            for who, got in runs}
    ref_sq = sum(float(np.square(r, dtype=np.float64).sum()) for r in f32[1:])
    glob = {who: (sum(float(np.square(a - r, dtype=np.float64).sum())
                      for a, r in zip(got[1:], f32[1:])) / ref_sq) ** 0.5 for who, got in runs}
    worst = {who: sorted(e.items(), key=lambda kv: -kv[1])[:8] for who, e in errs.items()}
    ln = {who: [round(errs[who][n], 4) for n in behind] for who in errs}
    finite = all(np.isfinite(a).all() for a in bf16 + cfg)
    print(f"one step from the same state, gradients against the float32 step's: all 186 as one "
          f"vector, norm-relative {json.dumps(glob)} (gate {BF16_STEP_GLOBAL_NREL}); the layer_norm "
          f"gradients behind a stale read, each {json.dumps(ln)} (gate {BF16_STEP_GRAD_NREL}); "
          f"the worst single gradients (not gated) {json.dumps(worst)}; losses float32 "
          f"{float(f32[0]):.6f}, bf16 {float(bf16[0]):.6f}, AmpConfig {float(cfg[0]):.6f}, "
          f"control {float(ctl[0]):.6f} [{card}]")

    def within(who):
        return glob[who] <= BF16_STEP_GLOBAL_NREL and all(
            errs[who][n] <= BF16_STEP_GRAD_NREL for n in behind)
    if not (finite and behind and within("bf16") and within("amp_config")):
        raise AssertionError(f"bf16 step gradients outside the gate of the float32 step: "
                             f"{glob}, {ln}")
    if glob["stale_control"] <= BF16_STEP_GLOBAL_NREL or any(
            errs["stale_control"][n] <= BF16_STEP_GRAD_NREL for n in behind):
        raise AssertionError(f"the stale-cast control passes a gate: {glob['stale_control']}, "
                             f"{ln['stale_control']}")
    del f32, bf16, ctl, cfg

    counters = _counters()
    bf16_counters = {k: counters[k] for k in BF16_PER_STEP}
    steps, losses, step_s, mem = 4, [], [], []
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    addrs = {n: scope.find_var(n).data_ptr() for n in state0}
    del state0
    with pt.amp.amp_guard(main):
        rec = exe.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
        torch.cuda.synchronize()
        print(f"bf16 training: precompile -> kind {rec['kind']}, capture {rec['compile_s']:.3f} s, "
              f"reasons {rec['reasons']}; reserved "
              f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB [{card}]")
        if rec["kind"] != "graph":
            raise AssertionError(f"bf16 training: precompile gave kind {rec['kind']}")
        captures = exe.cache_info()["captures"]
        for f in counters.values():
            f.launches = 0
        for f in bf16_counters.values():
            f.bf16_launches = 0
        for _ in range(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            step_s.append(time.perf_counter() - t1)
            losses.append(float(l))
            mem.append(torch.cuda.memory_allocated())
        launches = {k: f.launches for k, f in counters.items()}
        bf16_launches = {k: f.bf16_launches for k, f in bf16_counters.items()}
        moved = [n for n, a in addrs.items() if scope.find_var(n).data_ptr() != a]
        print(f"bf16 training losses {losses}; step times (s) {[round(x, 4) for x in step_s]}; "
              f"allocated bytes after each step {mem}; captures over the steps "
              f"{exe.cache_info()['captures'] - captures}; state tensors moved {len(moved)}")
        if not (np.isfinite(losses).all() and all(a > c for a, c in zip(losses, losses[1:]))):
            raise AssertionError(f"bf16 training: losses not finite and falling: {losses}")
        if exe.cache_info()["captures"] != captures or mem[1] != mem[-1] or moved:
            raise AssertionError(f"bf16 training: captures over the steps, memory {mem} or "
                                 f"moved state {moved[:8]}")
        want = {k: steps * v for k, v in PER_STEP.items()}
        want_bf16 = {k: steps * v for k, v in BF16_PER_STEP.items()}
        if launches != want or bf16_launches != want_bf16:
            raise AssertionError(f"bf16 training: launches over {steps} steps {launches}, bf16 "
                                 f"instances {bf16_launches}; want {want}, {want_bf16}")
        print(f"launches on the bf16 training path over {steps} steps: {launches}; of them the bf16 "
              f"instances {bf16_launches} (per step {BF16_PER_STEP}; K8 stays float32)")
        step_ms = 1e3 * float(np.mean(step_s[1:]))
        print(f"bf16 training step: {step_ms:.2f} ms mean of {steps - 1} timed steps (host clock "
              f"to the loss on the host, one graph replay a step); "
              f"{TRAIN_B * T / step_ms * 1e3:.0f} tokens/s at batch {TRAIN_B} x {T} (padded); "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
        prof = _profile(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
                        "bf16_training_profile", card, {"batch": [TRAIN_B, T]})
        _gate_step_profile(prof, _step_families(), "bf16 training")
        print(f"bf16 training: device launches a step of kernels whose names carry bf16, by "
              f"family: {json.dumps(prof['bf16_named_launches'])}")
        _step_graph_vs_eager(torch, exe, main, feed, loss, scope, "bf16 Adam", card,
                             _step_families())
    return launches, bf16_launches


# ------------------------------------------------------------ phase 18: the Trainer

TRAINER_STEPS = 6          # phase 18's epoch: whole batches of TRAIN_B rows
TRAINER_STOP_AFTER = 3     # the checkpointed run stops after this step


def _trainer_train_func(pt):
    """Phase 7's model as a Trainer's ``train_func``."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer

    def train_func():
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                            n_layer=N_LAYER, d_model=D_MODEL, n_head=H,
                                            d_inner=D_INNER, fuse_final_ce=True)
        return loss
    return train_func


def _trainer_samples(n, seed):
    """A seeded sample reader: source lengths in [129, 256] (pow2 buckets
    pad every batch to 256, K1's key mask reads the true lengths), target
    and label at 256."""
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            yield (rs.randint(1, VOCAB, (rs.randint(T // 2 + 1, T + 1), 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64))
    return reader


def _make_trainer(pt, **kw):
    with pt.unique_name.guard():
        return pt.Trainer(_trainer_train_func(pt), lambda: pt.optimizer.Adam(learning_rate=1e-3),
                          place=pt.CUDAPlace(0), **kw)


class _TrainerRun:
    """An event handler: the events, each step's metrics (handles on the
    pipelined path, read after the run), the launch counters and captures
    after each step, and optional actions after given steps."""

    def __init__(self, trainer, counters, actions=None):
        self.trainer, self.counters, self.actions = trainer, counters, actions or {}
        self.events, self.metrics, self.after_step = [], [], []

    def __call__(self, ev):
        self.events.append((type(ev).__name__, ev.epoch, getattr(ev, "step", None)))
        if type(ev).__name__ == "EndStepEvent":
            self.metrics.append(ev.metrics[0])
            self.after_step.append(({k: f.launches for k, f in self.counters.items()},
                                    {k: getattr(f, "bf16_launches", 0)
                                     for k, f in self.counters.items()},
                                    self.trainer.exe.cache_info()["captures"]))
            action = self.actions.get(ev.step)
            if action is not None:
                action(self.trainer)

    def losses(self):
        return [float(np.asarray(m)) for m in self.metrics]

    def per_step(self, first=1):
        """Launches each step from ``first`` on made, from the counters."""
        out = []
        for (a, _, _), (b, _, _) in zip(self.after_step[first - 1:], self.after_step[first:]):
            out.append({k: b[k] - a[k] for k in b})
        return out


def _train_once(trainer, reader, counters, actions=None):
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "bf16_launches"):
            f.bf16_launches = 0
    run = _TrainerRun(trainer, counters, actions)
    trainer.train(1, run, reader=reader, feed_order=["src", "trg", "lbl"])
    losses = run.losses()
    return run, losses


def _persist_numpy(trainer):
    """The trainer's persistables as host copies."""
    return {v.name: trainer.scope.find_var(v.name).to("cpu", copy=True).numpy()
            for v in trainer.train_program.list_vars() if v.persistable}


def _carry_numpy(trainer, state):
    import torch
    for n, a in state.items():
        t = trainer.scope.find_var(n)
        t.copy_(torch.from_numpy(a).reshape(t.shape))


def _free_trainer(torch, label):
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label} released: {torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB reserved on the card")


def _gate_trainer_steps(run, label, per_step, bf16_per_step=None, steps=TRAINER_STEPS):
    """One replay a step: no capture after step 0, and the launches each
    later step made from the wrappers' counters equal to the step's design
    (step 0 adds the eager run before its capture); returns the first
    later step's launches."""
    captures = [c for _, _, c in run.after_step]
    per = run.per_step()
    bf16_per = [{k: b[1][k] - a[1][k] for k in b[1]}
                for a, b in zip(run.after_step, run.after_step[1:])]
    print(f"{label}: {len(run.after_step)} steps; captures after each step {captures}; launches "
          f"a step after step 0 {json.dumps(per[0]) if per else None}")
    if len(run.after_step) != steps or len(set(captures)) != 1:
        raise AssertionError(f"{label}: {len(run.after_step)} steps, captures after each "
                             f"{captures}: want {steps} steps, no capture after step 0")
    want = {k: v for k, v in per_step.items()}
    bad = [p for p in per if {k: p.get(k, 0) for k in want} != want]
    if bad:
        raise AssertionError(f"{label}: launches a step {bad[0]}, want {want}")
    if bf16_per_step is not None:
        bad = [p for p in bf16_per if {k: p.get(k, 0) for k in bf16_per_step} != bf16_per_step]
        if bad:
            raise AssertionError(f"{label}: bf16 instances a step {bad[0]}, want {bf16_per_step}")
    first = run.after_step[0][0]
    if {k: first[k] for k in want} != {k: 2 * v for k, v in want.items()}:
        raise AssertionError(f"{label}: step 0 launched {first}, want twice the step's "
                             f"(the eager run before the capture, then the first replay)")
    return per[0]


def _trainer_records(pt, first, n):
    """The step records of the last ``n`` steps (``telemetry.STEPS``) from
    index ``first``: medians of wait_s, run_s, handler_s, step_time_s (ms)."""
    recs = pt.telemetry.STEPS.records()[first:first + n]
    return {k: 1e3 * float(np.median([r[k] for r in recs]))
            for k in ("wait_s", "run_s", "handler_s", "step_time_s")}


def _timed_epoch(torch, pt, trainer, reader, label, card):
    """One warm epoch through ``Trainer.train`` (its graph captured): the
    wall from the call to the last loss on the host, and the records'
    host times a step."""
    first = len(pt.telemetry.STEPS.records())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = _TrainerRun(trainer, {})
    trainer.train(1, run, reader=reader, feed_order=["src", "trg", "lbl"])
    losses = run.losses()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(losses)
    rec = _trainer_records(pt, first, n)
    out = {"steps": n, "wall_s": wall, "tokens_per_s": n * TRAIN_B * T / wall,
           "host_ms_a_step": rec, "losses_finite": bool(np.isfinite(losses).all())}
    print(f"{label}: {n} warm steps through Trainer.train in {wall:.3f} s, "
          f"{out['tokens_per_s']:.0f} tokens/s (to the last loss on the host); host ms a step "
          f"(medians): wait {rec['wait_s']:.3f}, run {rec['run_s']:.3f}, handler "
          f"{rec['handler_s']:.3f}, step {rec['step_time_s']:.3f} [{card}]")
    if not out["losses_finite"]:
        raise AssertionError(f"{label}: losses not finite: {losses}")
    return out


def _exe_run_loop(torch, pt, trainer, reader, card):
    """Phase 7's loop on the same trainer's executor: the DataFeeder's
    feeds run by ``exe.run`` one by one, the loss read each step."""
    program = trainer.train_program
    feeder = pt.DataFeeder(feed_list=[program.global_block.var(n) for n in ("src", "trg", "lbl")],
                           program=program, seq_len_buckets="pow2")
    feeds = [feeder.feed(b) for b in reader()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feeds:
        (l,) = trainer.exe.run(program, feed=f, fetch_list=[trainer.loss], scope=trainer.scope)
        float(l)
    wall = time.perf_counter() - t0
    tps = len(feeds) * TRAIN_B * T / wall
    print(f"phase 7's exe.run loop on the same executor: {len(feeds)} steps in {wall:.3f} s, "
          f"{tps:.0f} tokens/s (the loss read each step) [{card}]")
    return {"steps": len(feeds), "wall_s": wall, "tokens_per_s": tps}


def _staged_h2d(torch, pt, trainer, reader, card):
    """The copy to the card one staged batch makes: its bytes (a
    StagedBatch's ``nbytes``), and the copies' device time (events on a
    stream of their own) and host time (coercion into pinned buffers and
    the enqueue), as the stager thread makes them."""
    from paddle_tpu_torch.core.staging import host_to_device_copy
    program = trainer.train_program
    feeder = pt.DataFeeder(feed_list=[program.global_block.var(n) for n in ("src", "trg", "lbl")],
                           program=program, seq_len_buckets="pow2")
    feed = feeder.feed(next(iter(reader())))
    (staged,) = list(trainer.exe.stage_feeds(program, iter([feed])))
    block = program.desc.block(0)
    stream = torch.cuda.Stream()
    pinned = {}
    dev_ms, host_ms = [], []
    with torch.cuda.stream(stream):
        for _ in range(6):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record(stream)
            for k, v in feed.items():
                host, dtype = trainer.exe._feed_host(block, k, v)
                _, pinned[k] = host_to_device_copy(host, trainer.exe.device, dtype, pinned.get(k))
            b.record(stream)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            b.synchronize()
            dev_ms.append(a.elapsed_time(b))
    out = {"bytes": staged.nbytes, "feeds": {k: [list(v.shape), str(v.dtype)]
                                             for k, v in staged.items()},
           "device_ms": float(np.median(dev_ms[1:])), "host_ms": float(np.median(host_ms[1:]))}
    print(f"staged H2D per batch: {out['bytes']} bytes {json.dumps(out['feeds'])}; the copies "
          f"{out['device_ms']:.4f} ms on the card, {out['host_ms']:.4f} ms of host (coercion into "
          f"pinned buffers and the enqueue), medians of 5 [{card}]")
    return out


def _second_signature(torch, pt, trainer, card):
    """What a partial last batch costs: an epoch of one whole batch and one
    of half the rows, whose new feed signature is a second capture and a
    second graph memory pool."""
    reserved0 = torch.cuda.memory_reserved()
    n_entries = len(trainer.exe._cache)
    run = _TrainerRun(trainer, {})
    t0 = time.perf_counter()
    trainer.train(1, run, reader=pt.batch(_trainer_samples(TRAIN_B + TRAIN_B // 2, seed=4),
                                          TRAIN_B), feed_order=["src", "trg", "lbl"])
    losses = run.losses()
    wall = time.perf_counter() - t0
    new = list(trainer.exe._cache.values())[n_entries:]
    out = {"rows": TRAIN_B // 2, "captures": len(new),
           "capture_s": [e.compile_s for e in new], "kinds": [e.kind for e in new],
           "reserved_gib_before": reserved0 / 2 ** 30,
           "reserved_gib_after": torch.cuda.memory_reserved() / 2 ** 30, "epoch_s": wall}
    print(f"a partial last batch ({TRAIN_B // 2} rows): {len(new)} new entr(ies), kind "
          f"{out['kinds']}, capture {[round(c, 3) for c in out['capture_s']]} s; reserved "
          f"{out['reserved_gib_before']:.2f} -> {out['reserved_gib_after']:.2f} GiB; the epoch of "
          f"2 batches {wall:.3f} s; losses {losses} [{card}]")
    if out["kinds"] != ["graph"] or not np.isfinite(losses).all():
        raise AssertionError(f"a partial last batch: entries {out['kinds']}, losses {losses}")
    return out


def _trainer_profile(torch, pt, trainer, reader, label, card):
    """A profile of one warm epoch of TRAINER_STEPS batches through
    ``Trainer.train`` (the epoch's start, the stager's first batch
    included; the last loss read inside the window): device idle share,
    and the launches by kernel family held to the steps' design."""
    def run():
        r = _TrainerRun(trainer, {})
        trainer.train(1, r, reader=reader, feed_order=["src", "trg", "lbl"])
        r.losses()
        torch.cuda.synchronize()
    prof = _profile(torch, run, f"trainer_{label}_profile", card,
                    {"batch": [TRAIN_B, T], "steps": TRAINER_STEPS})
    if prof is None:
        raise AssertionError(f"trainer {label}: the profiler recorded no device activity")
    want = {k: TRAINER_STEPS * v for k, v in _step_families().items()}
    _gate_step_profile(prof, want, f"trainer {label} ({TRAINER_STEPS} steps)")
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}


def phase_trainer(torch, card):
    """Phase 18: the ``Trainer`` on the card at transformer-base's full
    width (phase 7's model and Adam), from a seeded reader through
    ``reader.batch`` and the pow2 ``DataFeeder``.  (a) ``Trainer(pipeline=
    True)``, one epoch of 6 batches, against ``Trainer(pipeline=False)``
    from the same state over the same batches: losses and every state
    tensor bit-equal, one replay a step, launches a step K1 36, K2 4, K3 4
    calls, K6 1, K7 1, K8 1 (the profile: K3 8, K7 2, K8 32 kernels);
    (b) ``save_params`` after step 3, and a new ``Trainer(param_path=)``
    holding every persistable bit-equal; (c) ``CheckpointConfig(
    step_interval=2)``: a run stopped after step 3, resumed by a new
    Trainer, repeats steps 3-5's losses and ends with the uninterrupted
    run's parameters, bit for bit; (d) ``clone(for_test=True)`` on a
    held-out batch twice: the second run a replay bit-equal to the eager
    run, no state changed; then a 3-step ``Trainer(amp=AmpConfig())``:
    one replay a step, losses finite and falling, phase 14's launches.
    Prints tokens/s through the Trainer both ways beside ``exe.run``'s
    loop, the Trainer's host time a step outside ``run``, the device idle
    share of a profiled pipelined and synchronous epoch, and the staged
    copy per batch."""
    import shutil
    import paddle_tpu_torch as pt
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_trainer")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    counters = _counters()
    reader = pt.batch(_trainer_samples(TRAINER_STEPS * TRAIN_B, seed=1), TRAIN_B)
    res = {"card": card}

    # (a) pipelined, with save_params after step 3 (b)
    t0 = time.perf_counter()
    piped = _make_trainer(pt)
    start = _persist_numpy(piped)
    params = [p.name for p in piped.train_program.global_block.all_parameters()]
    print(f"trainer (pipeline=True) built and initialized in {time.perf_counter() - t0:.2f} s: "
          f"{len(params)} parameters, {len(start)} persistables")
    if len(params) != N_PARAMS:
        raise AssertionError(f"{len(params)} parameters, want {N_PARAMS}")
    saved = {}

    def save_after_step(trainer):
        trainer.save_params(os.path.join(workdir, "params"))
        saved.update(_persist_numpy(trainer))
    run_p, loss_p = _train_once(piped, reader, counters, {TRAINER_STOP_AFTER: save_after_step})
    per_p = _gate_trainer_steps(run_p, "trainer pipelined", PER_STEP)
    if type(run_p.metrics[0]).__name__ != "FetchHandle":
        raise AssertionError(f"pipelined metrics are {type(run_p.metrics[0]).__name__}")
    launches_trainer = {k: f.launches for k, f in counters.items()}
    events_p = run_p.events
    final_p = {n: piped.scope.find_var(n).to("cpu", copy=True).numpy() for n in params}
    res["pipelined"] = {"losses": loss_p, "launches_a_step": per_p,
                        "entry": {k: v for k, v in piped.exe.cache_info()["entries"][-1].items()
                                  if k != "feeds"}}
    res["pipelined"]["timed"] = _timed_epoch(torch, pt, piped, reader, "trainer pipelined", card)
    res["pipelined"]["profile"] = _trainer_profile(
        torch, pt, piped, pt.batch(_trainer_samples(TRAINER_STEPS * TRAIN_B, seed=2), TRAIN_B),
        "pipelined",
        card)
    res["staged_h2d"] = _staged_h2d(torch, pt, piped, reader, card)
    res["second_signature"] = _second_signature(torch, pt, piped, card)
    del piped, run_p
    _free_trainer(torch, "pipelined trainer")

    # (a) synchronous, from the same state
    sync = _make_trainer(pt, pipeline=False)
    _carry_numpy(sync, start)
    run_s, loss_s = _train_once(sync, reader, counters)
    per_s = _gate_trainer_steps(run_s, "trainer synchronous", PER_STEP)
    differ = [n for n in params if not np.array_equal(final_p[n],
                                                      sync.scope.find_var(n).cpu().numpy())]
    print(f"trainer pipelined vs synchronous over {TRAINER_STEPS} steps: losses {loss_p} / "
          f"{loss_s} ({'bit-equal' if loss_p == loss_s else 'NOT bit-equal'}); "
          f"{len(params) - len(differ)} of {len(params)} parameters bit-equal; events equal "
          f"{run_s.events == events_p}")
    if loss_p != loss_s or differ or run_s.events != events_p:
        raise AssertionError(f"pipelined and synchronous trainers differ: {differ[:8]}")
    res["synchronous"] = {"losses": loss_s, "launches_a_step": per_s}
    res["synchronous"]["timed"] = _timed_epoch(torch, pt, sync, reader, "trainer synchronous",
                                               card)
    res["synchronous"]["profile"] = _trainer_profile(
        torch, pt, sync, pt.batch(_trainer_samples(TRAINER_STEPS * TRAIN_B, seed=2), TRAIN_B),
        "synchronous", card)
    res["exe_run_loop"] = _exe_run_loop(torch, pt, sync, reader, card)
    res["phase7_exe_run_tokens_per_s"] = PHASE7.get("tokens_per_s")
    del sync, run_s
    _free_trainer(torch, "synchronous trainer")

    # (b) a new trainer from the parameters saved after step 3
    t0 = time.perf_counter()
    loaded = _make_trainer(pt, param_path=os.path.join(workdir, "params"))
    load_s = time.perf_counter() - t0
    differ = [n for n, a in saved.items()
              if not np.array_equal(a, loaded.scope.find_var(n).cpu().numpy())]
    print(f"trainer(param_path=) from save_params after step {TRAINER_STOP_AFTER}: built and "
          f"loaded in {load_s:.2f} s; {len(saved) - len(differ)} of {len(saved)} persistables "
          f"bit-equal")
    if differ or not saved:
        raise AssertionError(f"param_path reload differs: {differ[:8]}")
    del loaded, saved
    _free_trainer(torch, "param_path trainer")

    # (c) checkpoint, stop after step 3, resume
    ckpt = os.path.join(workdir, "ckpt")
    first = _make_trainer(pt, checkpoint_config=pt.CheckpointConfig(ckpt, step_interval=2))
    _carry_numpy(first, start)
    run_c, loss_c = _train_once(first, reader, counters, {TRAINER_STOP_AFTER: pt.Trainer.stop})
    if loss_c != loss_p[:TRAINER_STOP_AFTER + 1] or run_c.events[-1] != \
            ("EndStepEvent", 0, TRAINER_STOP_AFTER):
        raise AssertionError(f"the checkpointed run: losses {loss_c}, last event "
                             f"{run_c.events[-1]}")
    del first, run_c
    _free_trainer(torch, "checkpointed trainer")
    t0 = time.perf_counter()
    resumed = _make_trainer(pt, checkpoint_config=pt.CheckpointConfig(ckpt, step_interval=2))
    resume_s = time.perf_counter() - t0
    state = dict(resumed._ckpt_state)
    run_r, loss_r = _train_once(resumed, reader, counters)
    differ = [n for n in params if not np.array_equal(final_p[n],
                                                      resumed.scope.find_var(n).cpu().numpy())]
    want_r = loss_p[TRAINER_STOP_AFTER:]
    print(f"trainer resumed from {state} (built and loaded in {resume_s:.2f} s): steps "
          f"{[e[2] for e in run_r.events if e[0] == 'EndStepEvent']}, losses {loss_r} against the "
          f"uninterrupted {want_r} ({'bit-equal' if loss_r == want_r else 'NOT bit-equal'}); "
          f"final parameters {len(params) - len(differ)} of {len(params)} bit-equal")
    if state != {"epoch_id": 0, "step_id": TRAINER_STOP_AFTER} or loss_r != want_r or differ:
        raise AssertionError(f"the resume differs: {state}, {loss_r}, {differ[:8]}")
    res["resume"] = {"from": state, "losses": loss_r}

    # (d) the evaluation clone on a held-out batch
    test_prog = resumed.train_program.clone(for_test=True)
    feeder = pt.DataFeeder(feed_list=[test_prog.global_block.var(n) for n in ("src", "trg", "lbl")],
                           program=test_prog, seq_len_buckets="pow2")
    held_out = feeder.feed(next(iter(pt.batch(_trainer_samples(TRAIN_B, seed=9), TRAIN_B)())))
    persist = [v.name for v in resumed.train_program.list_vars() if v.persistable]
    before = {n: resumed.scope.find_var(n).clone() for n in persist}
    exe, scope = resumed.exe, resumed.scope
    (e1,) = exe.run(test_prog, feed=held_out, fetch_list=[resumed.loss], scope=scope)
    captures = exe.cache_info()["captures"]
    (e2,) = exe.run(test_prog, feed=held_out, fetch_list=[resumed.loss], scope=scope)
    (e3,) = exe._run_eager(test_prog, held_out, [resumed.loss], scope)
    kinds = [e.kind for e in exe._cache.values() if e.program.desc.uid == test_prog.desc.uid]
    changed = [n for n in persist if not torch.equal(before[n], scope.find_var(n))]
    print(f"clone(for_test=True): {len(test_prog.desc.block(0).ops)} ops of "
          f"{len(resumed.train_program.desc.block(0).ops)}; held-out loss {float(e1):.7f} / replay "
          f"{float(e2):.7f} / eager {float(e3):.7f}; captures by the replay "
          f"{exe.cache_info()['captures'] - captures}; entry kinds {kinds}; state changed "
          f"{len(changed)}")
    if exe.cache_info()["captures"] != captures or kinds != ["graph"] \
            or not np.array_equal(e2, e3) or changed or not np.isfinite(e2):
        raise AssertionError(f"the for_test clone: replay {e2} vs eager {e3}, changed {changed[:8]}")
    res["eval_clone"] = {"loss": float(e2), "ops": len(test_prog.desc.block(0).ops)}
    del resumed, run_r, before, exe, scope
    _free_trainer(torch, "resumed trainer")

    # the bf16 trainer: one batch three times
    once = _trainer_samples(TRAIN_B, seed=3)
    bf16_reader = pt.batch(pt.reader.chain(once, once, once), TRAIN_B)
    bf16 = _make_trainer(pt, amp=pt.amp.AmpConfig())
    run_b, loss_b = _train_once(bf16, bf16_reader, counters)
    per_b = _gate_trainer_steps(run_b, "trainer bf16", PER_STEP, BF16_PER_STEP, steps=3)
    print(f"trainer bf16 (amp=AmpConfig()) losses {loss_b}")
    if not (np.isfinite(loss_b).all() and all(a > b for a, b in zip(loss_b, loss_b[1:]))):
        raise AssertionError(f"trainer bf16: losses not finite and falling: {loss_b}")
    res["bf16"] = {"losses": loss_b, "launches_a_step": per_b}
    bf16_launches = {k: counters[k].bf16_launches for k in BF16_PER_STEP}
    del bf16, run_b
    _free_trainer(torch, "bf16 trainer")
    shutil.rmtree(workdir, ignore_errors=True)

    p, s = res["pipelined"], res["synchronous"]
    print(f"trainer tokens/s: pipelined {p['timed']['tokens_per_s']:.0f}, synchronous "
          f"{s['timed']['tokens_per_s']:.0f}, exe.run loop {res['exe_run_loop']['tokens_per_s']:.0f} "
          f"(phase 7's loop {res['phase7_exe_run_tokens_per_s']}); device idle share of a profiled "
          f"epoch pipelined {p['profile']['device_idle_share']:.4f}, synchronous "
          f"{s['profile']['device_idle_share']:.4f} [{card}]")
    print(json.dumps({"trainer": res}))
    return launches_trainer, bf16_launches


def _release_serving(torch, label):
    """A serving phase's inferencers (and their graphs' memory pools) are
    gone once it returns: collect them before the training phases."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{label} released: {torch.cuda.memory_allocated() / 2**20:.0f} MiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB reserved on the card")


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
                    if "registers" in line or "Compiling entry" in line or "C75" in line))

    flash = phase_flash(torch, card)
    gather = phase_gather(torch, card)
    f32_res = phase_serving(torch, card)
    _release_serving(torch, "float32 serving")
    ce = phase_linear_ce(torch, card)
    adam = phase_adam(torch, card)
    scatter = phase_scatter(torch, card)
    launches, adam_steps = phase_training(torch, card)
    phase_train_vs_cpu(torch, card)
    int8, int8_quant = phase_int8(torch, card)
    sgd = phase_sgd(torch, card)
    int8_res = phase_int8_serving(torch, card, f32_res)
    _release_serving(torch, "int8 serving")
    sgd_launches, sgd_steps = phase_training(torch, card, sgd=True)
    bf16 = phase_bf16_kernels(torch, card)
    _, bf16_launches = phase_bf16_step(torch, card)
    _free_trainer(torch, "bf16 step")
    trainer_launches, trainer_bf16_launches = phase_trainer(torch, card)
    for name in ("int8_matmul", "abs_max_pair", "quantize_int8"):
        launches[name] = int8_res["launches"][name]
    launches["fused_sgd"] = sgd_launches["fused_sgd"]

    def entry(name, source, replaces, per_case, main_case):
        m = per_case[main_case]
        return {"name": name, "route": "cuda", "source": f"paddle_tpu_torch/csrc/{source}",
                "replaces": f"paddle_tpu/ops/pallas/{replaces}", "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in per_case.values()),
                **{k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                **{k: v for k, v in m.items() if k.startswith("bound_") and k.endswith("_ms")}}

    # K4's entry is the GEMM; the quantize kernels it now runs with (abs-max
    # pair, quantize) are listed under it with their launches and times
    k4 = entry("int8_matmul", "int8_matmul.cu", "int8_matmul.py:51", int8, (D_MODEL, VOCAB))
    q_main = int8_quant[(D_MODEL, VOCAB)]
    k4["quantizers"] = {
        "names": ["abs_max_pair", "quantize_int8"],
        "launches": {n: launches[n] for n in ("abs_max_pair", "quantize_int8")},
        "max_abs_err": max(c["max_abs_err"] for c in int8_quant.values()),
        **{k: q_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    kernels = [
        # launches_trainer: phase 18's pipelined Trainer run, counted alone
        entry("flash_attn_fwd", "flash_attention_fwd.cu", "flash_attention.py:38", flash,
              ("train", False)),
        entry("gather_rows", "embedding_gather.cu", "embedding.py:48", gather, ("train", VOCAB)),
        entry("scatter_add_rows", "embedding_scatter_add.cu", "embedding.py:85", scatter, "padded"),
        k4,
        # K5's and K6's main case is the step: one launch over 186 parameters
        entry("fused_sgd", "fused_sgd.cu", "fused_optimizer.py:86", sgd, "step"),
        entry("fused_adam", "fused_adam.cu", "fused_optimizer.py:106", adam, "step"),
        entry("linear_ce_fwd", "linear_ce.cu", "linear_ce.py:42", {0: ce["linear_ce_fwd"]}, 0),
        entry("linear_ce_bwd", "linear_ce_bwd.cu", "linear_ce.py:78", {0: ce["linear_ce_bwd"]}, 0),
    ]
    # K5's and K6's "ms" is the whole in-place call's (the table built on the
    # host, K6's power outputs made, the launch), "kernel_ms" the launch's alone;
    # launches a step from phases 12 and 7
    for e, case, steps in ((kernels[4], sgd["step"], sgd_steps),
                           (kernels[5], adam["step"], adam_steps)):
        e.update({k: case[k] for k in ("kernel_ms", "device_ms", "host_us", "launches_per_call",
                                       "library_device_ms")},
                 launches_per_step=e["launches"] // steps)
    # the bf16 instances (the amp-bf16 step's path), launches from phase 14
    for e in kernels:
        e["launches_trainer"] = trainer_launches[e["name"]]
    for name, source, replaces, cases, main_case in (
            ("flash_attn_fwd", "flash_attention_fwd_bf16.cu", "flash_attention.py:38",
             {k: v for k, v in bf16.items() if k[0] == "flash"}, ("flash", False)),
            ("scatter_add_rows", "embedding_scatter_add.cu", "embedding.py:85",
             {k: v for k, v in bf16.items() if k[0] == "scatter"}, ("scatter", "padded")),
            ("linear_ce_fwd", "linear_ce.cu", "linear_ce.py:42",
             {0: bf16["linear_ce_fwd"]}, 0)):
        e = dict(entry(name, source, replaces, cases, main_case), name=f"{name}_bf16",
                 launches=bf16_launches[name], launches_trainer=trainer_bf16_launches[name])
        kernels.append(e)
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
