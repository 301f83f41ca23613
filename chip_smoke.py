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
9. one step at batch 2 x 256 (2+2 layers) from the same weights, held against the port
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
    its bf16 Trainer, counted alone, as ``launches_profile`` under
    phase 19's op profiles, as ``launches_health`` phase 23's launches
    a step, as ``launches_book`` phase 24's, as ``launches_lstm``,
    ``launches_imdb_trainer`` and ``launches_seq_models`` phase 25's (a),
    (b) and (c), and as ``launches_control_flow`` phase 26's),
    error against its plain version (``max_abs_err_lstm``: phase 25 (a)'s
    check at the LSTM step's shapes; ``max_abs_err_control_flow``: phase
    26's; both in ``max_abs_err`` too), times, and
    bound; K4's entry lists
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
18. the ``Trainer`` at phase 7's widths and 2+2 layers (Adam, float32)
    from a seeded reader through ``reader.batch`` and the pow2
    ``DataFeeder`` (source lengths in [129, 256], target and label at
    256): ``Trainer(pipeline=
    True)`` over one epoch of 5 batches (batches staged by the
    ``FeedStager`` on its own stream) and ``Trainer(pipeline=False)`` from
    the same state over the same batches, losses and every parameter
    bit-equal, no capture after step 0, each later step's launches from
    the counters K1 12, K2 4, K3 4, K6 1, K7 1, K8 1 (step 0: twice, the
    eager run before the capture and the first replay); ``save_params``
    after step 3 and a new ``Trainer(param_path=)`` holding every
    persistable bit-equal; ``CheckpointConfig(step_interval=2)``: a run
    stopped after step 3, resumed by a new Trainer, repeating steps 3-4's
    losses and the final parameters bit for bit; ``clone(for_test=True)``
    on a held-out batch, its second run a replay bit-equal to the eager
    run, no state changed; a 3-step ``Trainer(amp=AmpConfig())`` on one
    batch, losses falling, phase 14's launches a step.  It prints
    tokens/s through the Trainer both ways (a warm epoch, to the last
    loss on the host) beside an ``exe.run`` loop on the same executor and
    phase 7's, the Trainer's host ms a step outside ``run`` (``wait_s``,
    ``handler_s``, from ``telemetry.STEPS``), profiles of a warm 6-step
    epoch each way (device idle share; launches by family gated at 6
    steps' K1 12, K2 4, K3 8, K7 2, K8 32, K6 1 a step), the staged copy per
    batch, and what a second feed signature (a half batch) costs;
19. the observability core, every record under one temporary
    ``PADDLE_TPU_TELEMETRY_DIR`` (set only around phase 19's pieces, so the
    other phases run with telemetry off): (a) inside phases 7 and 14, right
    after a replay of the step's graph, ``Executor.profile_ops`` (3 samples
    and a warm-up pass, every op) on the float32 and the bf16 step: rows,
    coverage (at least 0.9), top 10 ops and the sum by op type printed
    beside the graph's step wall; every state tensor bit-equal and at its
    address after it, no capture, the launches during it those of 4
    op-by-op passes (K1 36, K2 4, K3 4, K6 186 (one an update op), K7 1, K8
    1 a pass; in bf16 also its bf16 instances), and the next replay's loss
    and state bit-equal to a control step from the same state; (b) inside
    phases 5 and 11 the same profile of the 8-row float32 and int8 serving
    batch (K4 97 a pass); (c) inside phase 18 ``Trainer(profile_steps=2)``
    over 4 pipelined steps: 2 profile summaries, losses bit-equal to phase
    18's and, with every persistable, to the same Trainer with profiles
    off; (d) inside phase 5, 64 requests through a ``ServingSession`` under
    one root trace, ``tools/trace_tool.py --strict`` exiting 0 and its
    critical-path split, requests/s traced and with telemetry off beside
    phase 16's; (f) inside phases 7 and 14 ``profiler.device_trace``
    around one eager step: K1's, K7's and K8's kernels and ``op<idx>:``
    ranges in the exported trace, and the step's device time by op type
    (each kernel booked to the op range its launch ran in), of it the
    "other" kernels' (outside cuBLAS and the hand-written kernels); then (g) ``resource_sampler.sample_once()``'s device
    bytes in use equal to ``torch.cuda.memory_allocated()``, and (e) the
    record families present (``memplan_`` too: the Trainer's step-0 plan)
    and ``tools/stats.py``, ``profile_report.py``, ``compile_report.py``,
    ``pass_report.py``, ``memory_report.py`` and ``trace_tool.py
    --strict`` each exiting 0 over the directory.  The kernels line
    carries each kernel's launches under the profiles as
    ``launches_profile``;
20. the reference training path (``phase_reference_path``): (a)
    transformer-base at 64 x 256 with the unfused head (fc to the
    vocabulary, ``softmax_with_cross_entropy``), token weights zeroing each
    target row's padded tail, ``noam_decay(512, 4000)``, ``Adam(beta1=0.9,
    beta2=0.98, epsilon=1e-9)``, ``GradientClipByGlobalNorm(1.0)`` and
    ``L2Decay(1e-4)`` on the fc weights: one op-by-op step, then steps
    through one CUDA graph; losses finite and falling, the fetched
    learning rate each step equal to noam_decay's float32 value (K6 reads a
    fresh rate on each replay), the step counter at n after n steps, a
    replay bit-equal to an op-by-op step from the same state, launches a
    replay K1 36, K2 4, K3 4, K6 1 (no K7/K8), a profile gated alike, peak
    memory and tokens/s; (b) its bf16 twin (``AmpConfig()``) from (a)'s
    last state: losses finite and falling, the softmax-CE vars float32;
    (c) ``Trainer(accum_steps=4, pipeline=True)`` over 16 x 256
    micro-batches at 2+2 layers, two applies, bit-equal to an ``exe.run`` loop of its
    accumulate and apply programs from the same state, each program's
    cache entry kind printed; (d) 2 steps of one program at 2+2 layers of
    (a)'s widths in which each update rule (Momentum and Nesterov,
    LarsMomentum, Adamax, Adagrad, DecayedAdagrad, Adadelta, RMSProp, Ftrl,
    SGD with ``exponential_decay`` through K5) updates every tenth
    parameter, each step against one step from the card's state before it
    on the CPU in float32 and in float64 (the loss against the float32
    one; each state tensor's change, slots included, no further from the
    float64 one than ``FAMILY_WITNESS_FACTOR`` x the float32 CPU's
    distance + ``FAMILY_WITNESS_FLOOR``), with each rule's group calls and
    the multi-tensor kernels of a replay; (e) a
    2-D ``layers.matmul`` [2048, 512] x [512, 2048] served with
    ``AmpConfig(bf16=False, quant=True)``: K4 once a pass through the
    ``base_op="matmul"`` branch, bit-equal to the fake-quant program and
    within 0.05 norm-relative of float32.  The kernels line carries each
    kernel's phase-20 launches as ``launches_reference_path``;
21. the CNN path (``phase_cnn``): (a) bench.py's headline, ResNet-50
    training (``resnet.train_network`` at batch 128, 3 x 224 x 224, 1,000
    classes, ``Momentum(0.01, 0.9)``, ``enable_amp``) from seeded random
    images placed on the card, each step one CUDA graph replay: the
    program's 535 ops (975 and 440 casts after amp-bf16), the capture's
    seconds, images/s over 6 replays with their spread, the FLOPs a step
    (3 x 2 x the conv2d and mul multiply-adds) as a share of the dense
    bf16 peak, peak memory, losses finite and falling, all 106 running
    statistics moved, no hand-written kernel launched, a profile (device
    idle share) and the device ms by op type (a device trace of an eager
    step); (b) the same in float32 with TF32 off; (c) inside each, a
    replay against an op-by-op step from the same state, the loss and the
    106 statistics and 161 velocities bit-equal, and where cuDNN's
    default algorithms are not deterministic, again with
    ``cudnn.deterministic`` (images/s that way too); (d) ResNet-18 at 32 x
    32, batch 8, two steps on the card against the CPU from the same state,
    and a max pool over a window of ties; (e) the MNIST CNN with Adam, each
    step a replay with K6 inside (``launches_cnn`` on the kernels line;
    ResNet's path launches none, ``launches_resnet`` 0); (f) (b)'s trained
    model's ``clone(for_test=True)`` served at 8 rows with and without
    ``passes=["bn-fold"]``, the logits within the fold tolerance, a batch's
    latency both ways;
22. static analysis (``phase_analysis``): (a) phase 20's trained model's
    ``clone(for_test=True)`` at 64 x 256 run with ``Executor(passes=True,
    validate="error")`` and without passes from the same state and feed,
    each as graph replays: the default pipeline fuses the one loss head,
    K7 launches once a pass and no bf16 instance launches
    (``launches_passes`` on the kernels line, counted apart), the
    fused loss within ``EVAL_LOSS_RTOL`` of the unfused one, both peaks and
    eval times printed; (b) every main path's program as it runs (float32
    and int8 serving, the fused float32 step and its bf16 twin, the
    reference step, bf16 and float32 ResNet-50, after the port's rewrites)
    verified by ``analysis.verify`` inside its phase, zero errors, its
    counts by code and the verifier's host seconds printed; (c) each of
    those programs' ``plan_memory`` peak beside the peak an eager run of
    it measured in its phase (the scope's state its ops touch and the feeds
    already on the card, plus ``torch.cuda.max_memory_allocated`` over the
    run after ``reset_peak_memory_stats`` less what was allocated before),
    the ratio within ``analysis/measured.py``'s ``PLAN_BAND``; (d)
    ``memory_budget`` at 0.9 x the reference step's plan raising
    ``PredictedOOMError`` with ``torch.cuda.memory_allocated`` unchanged and
    no cache entry, a ``ServingSession`` budget between two buckets' plans
    rejecting the larger buckets with the survivors' answers bit-equal to an
    unbudgeted session's, and the Trainer's step-0 ``memplan_`` record;
23. the training flight recorder and the async checkpoint
    (``phase_health``): (a) ``Trainer(health=True, checkpoint=
    CheckpointConfig(step_interval=2, epoch_interval=0, keep=2,
    rollback_on_divergence=True))`` on phase 7's step at full width (6+6
    layers, 64 x 256, Adam, float32), 6 pipelined steps, each one graph
    replay with the sentinel inside: every health record ok with finite
    norms, launches a step K1 36, K2 4, K3 4, K6 1, K7 1, K8 1 and no
    bf16 instance (``launches_health`` on the kernels line), one replay's
    sentinel scalars within ``SENTINEL_RTOL`` of float64 sums over the
    same step's state and its eager step's gradients, tokens/s with and
    without the sentinel in turns on one executor, the device ms a replay
    with and without it from ``torch.profiler`` (the difference by part:
    the shadow copy, the norms, the update pass), and the peak device
    memory of each entry's first run (the scalars' check and the cost
    run after (c): their replays train on one batch); (b) each save's
    stall on the step (the whole ``save`` call on the step's thread), its
    snapshot, writer
    seconds and bytes, every committed checkpoint validated, (c)'s save
    taking a pinned buffer (a)'s writer had released, and a new Trainer in
    a new scope resuming from the latest one, its next loss bit-equal to
    the uninterrupted run's; (c) one element of the first weight the step
    reads set to inf in place before a step at a save boundary: that
    step's sentinel trips, the localization names the weight's first
    reader, the rollback restores the last good checkpoint into the same
    tensors (read back bit-equal before the next step), the later steps
    finite, one rollback, no new cache entry; (d) ``FLAGS.check_nan_inf``
    naming ``elementwise_div`` on the card, at the first run and at a
    replay; (e) ``fail@serving.backend.m:n=2`` failing exactly the second
    of four batches served by ``ServingSession(fault_site=
    "serving.backend.m")``.
24. the book models and what the training path left (``phase_book``):
    (a) bench.py's AlexNet row (``bench_image_model``: 128 x 3 x 224 x
    224, 1,000 classes, ``Momentum(0.01, 0.9)``, ``enable_amp``, uniform
    images in [0, 1) placed on the card), each step one CUDA graph replay:
    the program's ops and casts, the capture's seconds, images/s over 6
    replays with their spread, the K40m ratio as bench.py prints it,
    peak memory, losses finite and falling, no hand-written kernel
    launched, a profile (device idle share) and the device ms by op type
    (``lrn``, ``conv2d(_grad)``, ``mul(_grad)``, the casts); (b) GoogLeNet
    the same; (c) SE-ResNeXt-50 (stages [3, 4, 6, 3], filters [128, 256,
    512, 1024], cardinality 32, SE ratio 16) the same with the grouped
    3x3s' device ms named, then its eval clone exported with
    ``save_inference_model`` and one batch of 8 served through
    ``Inferencer(param_path=)``, against the eval clone on the trainer's
    executor; (d) one float32 step of each model at a small image size on
    the card and on the CPU from the same parameters, against the port on
    the CPU in float64; (e) fit_a_line with SGD on the synthetic
    ``uci_housing`` reader, the loss from ~25 to under 0.1 in 30 steps, K5
    once a replay; (f) ``ModelAverage`` over an Adam step (K6 once a
    replay, ``average_accumulates`` in the graph), the averages against a
    float64 host witness of the window's mean, ``apply()`` and its restore
    copying in place (no new capture, the next replay bit-equal to one
    without them), and a QAT step with ``fake_quantize_range_abs_max`` in
    its graph against the CPU (``Iter`` and the window on the device); (g)
    each new op on the card against the CPU: bit-equal where the maths is
    exact, else within ``BOOK_OP_RTOL`` (``launches_book`` on the kernels
    line: K5 and K6 on (e) and (f)).
25. sequences and recurrent nets (``phase_sequences``): (a) bench.py's
    LSTM row (``bench_lstm``: ``stacked_lstm.train_network`` at batch 64,
    seq 80, dict 30,000, emb 128, hidden 256, ``stacked_num=2``,
    ``Adam(0.002)``, ``enable_amp``; lengths in [40, 80] on the card),
    each step one CUDA graph replay: the program's ops and casts; one
    step op by op from the same state in bf16 and in its float32 twin
    (TF32 off), the loss and the gradients against the twin's within
    stated bf16 gates; K2, the bf16 K3 and K6 at the step's shapes (its
    table and ids, its 11 updates from that step's state and gradients)
    bit-equal to their plain versions; the capture's seconds, ms/batch
    over 6 replays with their spread beside the reference's K40m 83 ms as
    bench.py states it, peak memory, losses finite and falling, launches a
    replay K2 1, K3 1 (its bf16 instance: the grad of the table's bf16
    copy; the float32 K3 0) and K6 1 (over the 11 parameters), a 2-replay
    profile (the device idle share, device operations a step; K2, K3 and
    K6 in both replays), a replay bit-equal to an op-by-op step from the
    same state (loss and all 56 state tensors), the device ms by op type
    of an eager step (its trace showing K2, K3 and K6), and the float32
    twin's replays from the same state and feed: its ms/batch and its
    first loss within the bf16 gate of the bf16 step's; (b) the same net
    in bf16 through ``Trainer(amp=AmpConfig())`` on the synthetic imdb
    reader (its 5,148-word dict; reviews sorted by length, 3 batches of
    64 for each pow2 bucket 16, 32, 64): the first step's loss against
    one op-by-op step of the Trainer's program on the same padded batch
    from the same state, one capture a bucket, then a warm epoch of
    replays (K2, the bf16 K3, K6 once a step), real and padded tokens/s; (c)
    machine translation's ``train_network`` (``dynamic_gru`` encoder and
    decoder, ``sequence_pool`` last and sum, ``sequence_length``) and the
    sentiment convolution net (``nets.sequence_conv_pool`` x 2,
    ``Adagrad``), one float32 step on the card and on the CPU from the same
    state, each against the port on the CPU in float64, then 3 replays
    with the losses falling (``launches_seq_models``: K2, K3 on both, K6
    on machine translation; no bf16 instance).
26. control flow (``phase_control_flow``): (a) the book's RNN
    encoder-decoder (``models/rnn_encoder_decoder.py``: an embedding, fc
    and ``dynamic_lstm`` encoder pooled at its last step, a
    ``DynamicRNN`` decoder, a masked cross-entropy) at vocabulary 30,000,
    word and hidden 32, batch 64 x 32 (lengths in [8, 32]), with Adam at
    ``piecewise_decay`` (a ``Switch`` of ``conditional_block``s): no graph
    blocker for its five blocks; K2 on both tables, K3 of each table's
    step gradient (against the CPU) and K6 over the 10 updates at the
    step's shapes, bit-equal to their plain versions; the capture's
    seconds and 6 replays on one batch, one graph: ms a replay with its
    spread, target tokens/s, losses finite and falling, the rate read back
    after each replay equal to the host's formula across both boundaries,
    launches a replay K2 4, K3 2, K6 1 and no bf16 instance; a 2-replay
    profile, which must record (device busy ms a replay, and from it the
    timed replays' idle share; K2 4, K3 4 kernels, K6 1 a replay); a
    replay bit-equal to an op-by-op
    step (loss and every state tensor); the device ms by op type of an
    eager step; (b) a ``While`` of 8 trips of tanh(fc) over [4096, 256]:
    bounded (``max_iters``) with SGD, one replay a step (K5 once, no bf16
    instance, bit-equal to its plain version at the step's 2 updates), and
    its forward bounded
    (replayed, and op by op) against unbounded (op by op, the condition
    read on the host each trip, the reason named), outputs bit-equal
    (``launches_control_flow`` and ``max_abs_err_control_flow`` on the
    kernels line).
27. sparse gradients and the embedding subsystem (``phase_sparse``): (a)
    DeepFM (``models/deepfm.py``) at the Criteo width (26 fields with the
    Criteo Kaggle cardinalities, 33,762,577 rows a table set, embed 16,
    MLP 400-400-400 with dropout, batch 2,048, Zipf(1.3) ids from the
    seed), the tables' gradients SelectedRows and Adam lazy on them: no
    graph blocker; K2 at the 10,131,227-row field's [V, 16] and [V, 1]
    tables and a small field's, bit-equal to its plain version and
    ``F.embedding`` and timed beside them, K6 over the 8 dense updates
    bit-equal; the capture and 8 replays over 4 batches, one graph: ms a
    replay with its spread, examples/s, peak, losses finite, launches a
    replay K2 52 and K6 1 and nothing else (``launches_sparse``); every
    row no batch touched unmoved in the 52 tables and their moments; a
    2-replay profile (K2 52, K6 1, K3 0, K5 0 a replay; the idle share of
    the timed replays); a replay bit-equal to an op-by-op step from the
    same state and generator state; (b) the dense twin (``is_sparse=
    False``): K3 at the 10,131,227-row field's [V, 16] and [V, 1] tables
    (the first op-by-op step's output gradients at its ids) bit-equal to
    its plain version run on the CPU and timed beside ``index_add_``, K6
    over all 60 updates (574 M floats) bit-equal to its plain version;
    6 replays: K2 52, K3 52, K6 1 a replay; (c) bench.py's
    embedding row (``sharded_table`` + ``mean`` + ``SGD(0.125)``, batch
    1,024, dim 128, Zipf ids) at 4,096, 32,768 and 262,144 rows, both
    arms one graph each, ms a step, the dense arm launching K2, K3 and
    K5, the sparse arm K2 alone, the arms' tables equal after the same
    steps (within ``EMB_ARM_ATOL``); (d) DeepFM through
    ``Trainer(prefetcher=RowPrefetcher(...))``, 3 pipelined steps, the
    dedup ratio equal to numpy's; (e) the trained tables served by
    ``ServingSession(embedding_cache=...)``: ``lookup_rows`` equal to the
    trained rows with hits, a served batch bit-equal to the inferencer's
    replay and to an op-by-op run.
28. the data path (``phase_data``): phase 27 (a)'s DeepFM at the Criteo
    width trained from RecordIO shards the port's native writer makes
    from ``models/deepfm.py``'s seeded feed (4 shards of 4 chunks, a chunk
    one batch of 2,048 records of 268 bytes: 26 int64 ids, 13 float32
    features, an int64 label; a held-out chunk), with ``layers.auc`` in
    the step; a 4-thread ``parallel_scan`` reads every record once; the
    host ms a batch of the native and the Python scanner,
    of the dispatch task reader's decode, ``DataFeeder`` and
    ``open_files``' reader; (a) a ``DispatchMaster`` in the process, a
    client ``rank0`` that leases a task and dies, then
    ``Trainer(dispatch=DispatchConfig(worker="rank0", reap_on_start=
    True))``, which reaps the lease on construction, and an epoch of 16
    steps: every task finished once, the master done, one graph, step 0
    the eager run and a replay and K2 52, K6 1 each later step (K3, K5 and
    the bf16 instances 0; ``launches_dispatch``), ms a step with the
    spread; the state bit-equal to the feed-dict control (the trainer's
    step program run by ``exe.run`` on the same batches in the order the
    reader consumed the tasks, from the same state and generator state:
    dropout draws alike); (b) the same network over ``open_files`` (one
    thread, the files' order) + ``read_file``, two passes through
    ``EOFException`` / ``reset()``, each step one replay of one graph
    (``launches_py_reader``), every record read by the native scanner,
    the state bit-equal to the control over the same 32 batches; (c) the
    trained model's ``clone(for_test=True)`` on the held-out batch: one
    graph, K2 52 a replay, its AUC within ``AUC_TOL`` of ``metrics.Auc``
    over the thresholds' buckets and of a float64 trapezoid; a 2-replay
    profile (device busy ms a step) and from it the idle share of (a)'s
    and (b)'s timed steps.
29. decode serving and the fleet (``phase_decode``): K1 at
    ``attention_lm``'s prefill shapes (causal, head_dim 16, B*H 4, T 8 /
    16 / 32) and K2 at the decode models' [43, 12] table, each against
    its plain version and timed beside SDPA / ``F.embedding``; (a)
    machine translation's ``infer_network`` at the book width
    (dictionaries of 30,000, word 32, hidden 32, beam 4, 12 steps; seeded
    parameters) on 64 sources of the synthetic wmt16, padded to their
    pow2 bucket: one graph replay a batch (the graph blockers printed),
    K2 13 a replay and nothing else, the replay's SentenceIds and
    SentenceScores bit-equal to an op-by-op run, K2 bit-equal to its
    plain version at both tables with the step's ids, the CPU port from
    the same parameters (ids equal, or differing only at a near tie whose
    candidates' totals in the CPU's arithmetic differ by under
    ``DEC_TIE_RTOL`` of their magnitude, printed; scores
    within ``DEC_SCORE_RTOL``), ms a batch over 6 replays with the
    spread, sentences/s, a profile's idle share, the peak; (b)
    ``DecodeEngine`` with bench.py's decode row (``gru_lm``, 48 requests
    from ``default_rng(11)``, batch 8, ``max_seq_len`` 32, seed 5): the
    static and the continuous arm bit-identical and equal to the one-shot
    ``reference_func`` program on the card, no fresh compile, K2's
    launches equal to the ``lookup_table`` ops of the programs the engine
    dispatched; tokens/s, TTFT and per-token p50 / p99, occupancy, the
    speedup; then ``attention_lm`` (12 staggered ragged clients, K1 once
    a prefill batch, tokens equal to a solo engine's) and
    ``beam_gru_lm`` (8 requests equal to its one-shot program); (c)
    ``EngineManager`` with transformer-base float32 serving (from saved
    parameters; K1 18, K2 4 a batch) and ``gru_lm`` (``load_decode``):
    the parameters refused over a 64 MiB budget (M501) before any build;
    ``swap`` to equal parameters passing its canary, to a NaN set rolled
    back with the old answers bit-equal; a 6 s ``FrontDoor`` soak of 16
    clients over both models, ``delay@serving.backend.tb`` over its
    middle third tripping the breaker (shedding, then closing through the
    half-open probe), ``swap_decode`` at two thirds, the admitted p99
    under twice the 0.25 s deadline; ``FleetHTTPServer`` on 127.0.0.1
    answering ``POST /v1/infer`` and ``/v1/generate`` sent with a
    ``traceparent`` whose trace id comes back.  ``launches_decode`` on
    the kernels line counts (a), (b) and (c) apart, K3-K8 0 in each;
    (b)'s ``attention_lm`` steps launch ``rowvec_mm`` (C7), counted apart.
30. parameter-server training (``phase_pserver``): first C7's kernel,
    ``rowvec_mm`` (``csrc/batched_rowvec_mm.cu``), at ``attention_lm``'s
    decode shapes against its plain version (``ROWVEC_RTOL`` of the
    largest value), every row bit-equal alone and inside batches of 1, 2,
    3 and 8, timed beside ``torch.matmul``.  Then trainers and pservers
    as processes on the one card (``tools/pserver_runner.py``; all six
    pservers started together, every child stopped in a ``finally``).
    Before the arms, the kernels at the shapes they run: K6 once a
    parameter over the 186 updates of the first step (as the pservers
    launch it), and K1, K2, K3, K7 and K8 at (b)'s 32-row trainer shapes,
    each against its plain version (``max_abs_err_pserver``, also in
    ``max_abs_err``); (a)'s 64-row trainer shapes are phases 1-7's.
    (a) transformer-base (``bench.py``'s step in float32: 6+6 layers, 64
    x 256, ``fuse_final_ce``, Adam 1e-3) transpiled over two pservers,
    this process the trainer: the pservers' initial parameters and, after
    each of 2 warm and 6 timed steps, every parameter bit-equal to the
    local training of the same program from the same stamped startup and
    feeds (run first, in this phase) -- as the next step's recv fetched
    them, and after the last step through ``get_param`` -- each loss
    bit-equal; one graph, the trainer's launches a step (K1 36, K2 4, K3
    4, K7 1, K8 1) and the pservers' K6 186 a round over the two; ms a
    step with its spread and its parts (the recv stage, the replay with
    the pinned D2H, the send stage), each timed step in a profiler window
    of its own (the trainer's device busy ms), the pservers' host round
    and device ms a round (their own traces, cut at each round's end),
    bytes each way, tokens/s beside the local step's, and the card's idle
    share over the timed steps (1 - the trainer's and the pservers' device
    busy time over the steps' wall time); (b) two ``pserver_runner`` trainers in sync
    mode, 32 + 32 rows, 2 steps: the parameters they received bit-equal to
    each other each round, the mean loss within ``PS_B_LOSS_RTOL`` of the
    local 64-row step's, each parameter on the pservers within
    ``PS_B_PARAM_NREL`` norm-relative; (c) ``tests/test_dist_lookup_table.
    py``'s model with a [10,131,227, 16] table (Criteo's largest field)
    sharded over two pservers, 2,048 Zipf ids a batch, 3 steps: the
    prefetched rows bit-equal to a local ``lookup_table``, the touched rows
    and the dense parameters within ``PS_C_RTOL`` / ``PS_C_ATOL`` of the
    local step with ``is_distributed=False`` after each step (K5 on the
    pservers, held against its plain version once a dense ``sgd`` op);
    the prefetch and push ms a step and the bytes moved.
    ``launches_pserver`` on the kernels line counts each arm, the trainers'
    and the pservers' apart; the kernels line ends with C7's entry.
31. the collective half on the card (``phase_collective``; ROADMAP §A
    item 12b): (d) ``switch_moe`` at transformer-base's FFN width (x
    [16,384, 512], 8 experts, d_hidden 2048, capacity factor 1.25: a
    [16,384, 8, 2,560] dispatch tensor) in an SGD step on the card
    against the plain CPU step from the same parameters (``P31_MOE_*``);
    (b) two processes of this script (``--collective-worker``) sharing the
    card, ``backend="gloo"`` on CUDA tensors with ``make_mesh(...,
    host_staged=True)`` (gloo's functional all-gather and its sends run on
    host copies; the worker prints that it stages): transformer-base at
    ``P31_B_LAYERS``, 64 global rows (32 a rank) x 256, 2 Adam steps
    under ``{"data": 2}`` and ``{"fsdp": 2}`` from rank 0's parameters,
    the global mean loss within ``P31_B_LOSS_RTOL`` and every parameter
    within ``P31_B_PARAM_NREL`` norm-relative of rank 0's one-process
    64-row steps, fsdp's state bytes a rank below data's, and each rank's
    kernels (K1, K2, K3, K7, K8, K6 over its shards) against their plain
    versions at its local shapes (``max_abs_err_collective``); (c) the
    same pair: a two-stage ``PipelinedStages`` of transformer-base
    encoder layers (``n_micro`` 4) on ``{"pipe": 2}`` and causal
    ``flash_attention(use_ring=True)`` (8 heads x d 64, T 256) on
    ``{"seq": 2}``, output and every parameter gradient against one
    process (``P31_C_*``); (a) a world of one over NCCL on the card:
    transformer-base's Adam step at 64 x 256 (6+6 layers) through
    ``Trainer(layout=SpecLayout(mesh_axes={"data": -1, "fsdp": 1, "tp":
    1}))`` against the plain ``Trainer`` over the same batches from the
    same state, then ``ParallelExecutor`` against a plain ``Executor`` in
    lockstep: one CUDA graph replay a step (its collectives inside), every
    state tensor bit-equal after each step (on a failure the first op
    whose output differs between the mesh's eager step and a plain one is
    named), the launches a step equal (K1 36, K2 4, K3 4, K6 1, K7 1, K8
    1; ``launches_collective``), tokens/s of a warm epoch each way.
    (b) and (c)'s four workers run while this process takes (d); (a) runs
    alone after them.  Phase 31 prints its seconds by piece.
32. sharded state on the card (``phase_sharded``; ROADMAP §A item 12c):
    (a) bench.py's embedding row at its largest TPU size (a ``[262,144,
    128]`` float32 ``sharded_table``, 1,024 Zipf(1.3) ids from seed 17,
    ``SGD(0.125)`` on its mean) on two worker processes sharing the card
    over gloo under ``SpecLayout()`` on ``{"fsdp": 2}`` (131,072 rows a
    rank), both gradient arms: after each of ``P32_STEPS`` steps the
    rank's shard bit-equal to one process's rows, K2 and K3 (dense arm)
    handed the rank's shard alone, each rank's peak below one process's;
    K2 and K3 at that shard against their plain versions, timed beside
    ``F.embedding`` and ``index_add_``; (b) DeepFM with
    ``shard_tables=True`` at the Criteo width through
    ``Trainer(layout=SpecLayout(), health=True)`` on the world of one over
    NCCL, every state tensor and the sentinel's values bit-equal to the
    plain ``Trainer(health=True)``, one capture; (c) transformer-base
    (``P32_C_LAYERS``) trained on a worker pair under ``{"fsdp": 2}``
    through ``Trainer(checkpoint=, health=True)``, the step-2 save's two
    shard files and one manifest (``validate_shards``), restored onto no
    mesh in this process and onto ``{"data": 2}`` on the pair (bit-equal;
    the next step within phase 31 (b)'s gates of one process's; an
    impossible budget refused with M501 first); (d) the pair's sentinel
    against one process's (``P32_SENTINEL_RTOL``), a NaN put into rank 1's
    batch through ``faults`` tripping both ranks (localization skipped),
    and the reference's ``tools/health_report.py`` over their telemetry.
    ``launches_sharded`` counts the main path's launches (the workers'
    mesh runs and (b)'s Trainer).

Phase 9 also takes the 2 x 256 step in bf16 (``enable_amp``) with cuBLAS's
reduced-precision bf16 reductions allowed (PyTorch's default) and not, and
prints each one's gradient error against float64.

The last line is ``{"ok": true, "device": {...}}``.  Times are CUDA-event
times on this card; bounds use the H100 SXM's published peaks.
"""
import contextlib
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# one full-width step at 2 x 256 against the port on the CPU in float64, at
# TRAIN_VS_CPU_LAYERS (6+6 before the reference path's phase came; the CPU's
# three steps then took 16 of the phase's 38 s).  Readings on an H100 at
# 6+6 (PERF.md): the card 7.9e-8 on the loss and <= 1.3e-6 on the
# gradients; the CPU in float32 1.1e-4 norm- and 1.0e-3 max-relative, from
# two ReLU inputs on the other side of 0 than in float64; the TF32 control
# 2.6e-7 on the loss and up to 1.5e-2 norm- and 2.3e-2 max-relative.  The
# gradient gates sit between the float32 readings and the control's.
TRAIN_VS_CPU_LAYERS = 2
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
# the ``record_function`` range around the measured work of a window that
# runs a warm-up first (``_profile(warm=)``, ``_device_trace_step(warm=)``)
MEASURED = "chip_smoke_measured"


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


def _profiler_ending(torch):
    """Called last inside a ``torch.profiler.profile`` block, after the
    measured work has finished on the card: a tail of the primer's spin
    kernels and a short wait before the block closes.  A window was seen
    to lose a replayed step's last records (K1's last launch, half of K3's
    kernels and the update's) although the card had finished them; the
    records it loses now are the tail's, which the profiles leave out."""
    for _ in range(8):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.05)


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
    # cuDNN's convolutions (and its layout transposes around them)
    if any(s in low for s in ("cudnn", "fprop", "dgrad", "wgrad", "convolve", "implicit_gemm")):
        return "conv (cuDNN)"
    if "memcpy" in low:
        return "memcpy"
    if "memset" in low:
        return "memset"
    # cuBLAS's Hopper kernels for bf16 GEMMs are named nvjet_*
    if any(s in low for s in ("gemm", "cutlass", "xmma", "sm90", "nvjet")):
        return "gemm (cuBLAS)"
    return OTHER


OTHER = "other (elementwise, layer_norm, copies)"


def _profile(torch, run, label, card, extra, warm=None):
    """torch.profiler's device activities during ``run()`` by kernel
    family, their union as the device's busy time, and its share of the
    host wall clock around ``run`` and the wait for the card to finish it
    (a window closed before the card had finished was seen to lose a
    step's last kernels: the weight gradients' scatter and the update).
    With ``warm``, that call runs first in the window, behind the primer
    (a whole-script run was seen to lose a replayed step's first records
    there: its feed copies and K2), and only the device records inside
    ``run``'s range are counted; ``warm_records`` counts the warm-up's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _profiler_started(torch)
        if warm is not None:
            warm()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(MEASURED) if warm is not None else contextlib.nullcontext():
            run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _profiler_ending(torch)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
              and PRIMER not in e.name()]
    warm_n = None
    if warm is not None:
        spans = [(e.start_ns(), e.end_ns()) for e in events
                 if e.is_user_annotation() and e.name() == MEASURED]
        if len(spans) != 1:
            raise AssertionError(f"{label}: {len(spans)} device ranges of the measured run")
        ((lo, hi),) = spans
        events = [e for e in events if not e.is_user_annotation()]
        warm_n = sum(1 for e in events if e.start_ns() < lo)
        events = [e for e in events if lo <= e.start_ns() <= hi]
    dev = [(e.name(), e.start_ns(), e.duration_ns()) for e in events]
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
    if warm_n is not None:
        rec["warm_records"] = warm_n
    print(json.dumps({label: rec}))
    return rec


def _device_by_kernel(torch, fn, iters, counts=None, annotations=None, width=48):
    """Mean device time of each kernel ``fn`` launches, per call, by name
    (the first ``width`` characters), from ``torch.profiler`` ({} if two windows
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
            _profiler_ending(torch)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                    and PRIMER not in e.name():
                name = e.name().replace("void ", "").replace("(anonymous namespace)::", "")[:width]
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
    engine_stats = {k: v for k, v in stats.items() if k not in ("serving", "executor")}
    print(f"{label}: served {len(reqs)} requests in {batches} batches: {engine_stats}; "
          f"executor {stats['executor']}")
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


def _replay_vs_eager(inf, feed, label, key=None):
    """The batch's replay against its eager run; with ``key``, the eager run
    is phase 22's measured run of the serving program."""
    import torch
    (got,) = inf.infer(feed)

    def eager():
        return inf.exe._run_eager(inf.inference_program, feed, inf.predict_vars, inf.scope)
    (want,) = eager() if key is None else _analysis_path(
        torch, key, inf.exe, inf.inference_program, feed, [v.name for v in inf.predict_vars],
        inf.scope, eager)
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
    res["fp32_feed8"] = _replay_vs_eager(inf, feed8, "float32 serving", key="serving_float32")
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
    inf.infer(feed8)      # a replay: the profile follows one
    res["op_profile"] = _op_profile(
        torch, inf.exe, inf.inference_program, feed8, list(inf.predict_vars), inf.scope,
        "float32 serving", card, SERVE_PER_PASS,
        graph_wall_ms=res["graphs"]["buckets"][8]["wall_ms"]["graph"]["median"])[1]
    res["traced"] = _traced_serving(torch, inf, res["graphs"]["requests_per_s_graph"], card)
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


def _rps(sess, n_requests=64, n_threads=4, kept=None, trace=None):
    """Requests/s of ``n_requests`` 1-2-row requests from ``n_threads``
    client threads through ``sess`` (answers dropped as they come, or
    appended to ``kept``), each client inside ``trace`` when one is given."""
    from paddle_tpu_torch.telemetry import use_trace
    reqs = _requests(n_requests, seed=2)
    errors = []
    barrier = threading.Barrier(n_threads + 1)

    def client(t):
        try:
            barrier.wait(timeout=60)
            with use_trace(trace):
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
    got = _replay_vs_eager(inf, feed8, "int8 serving", key="serving_int8")
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
    inf.infer(feed8)      # a replay: the profile follows one
    res["op_profile"] = _op_profile(
        torch, inf.exe, inf.inference_program, feed8, list(inf.predict_vars), inf.scope,
        "int8 serving", card, INT8_PER_PASS,
        graph_wall_ms=res["graphs"]["buckets"][8]["wall_ms"]["graph"]["median"])[1]
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


def _train_programs(pt, sgd=False, n_layer=N_LAYER):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                            n_layer=n_layer, d_model=D_MODEL, n_head=H,
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


def _step_families(sgd=False, n_layer=N_LAYER):
    """Kernel launches a full-width step of ``n_layer`` + ``n_layer`` layers
    makes on the device, by profile family: K3 and K7 are 2 kernels a call,
    K8 32."""
    return {"flash_attn_fwd (K1)": 2 * 3 * n_layer,
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
    out = _step_graph_vs_eager(torch, exe, main, feed, loss, scope,
                               "float32 SGD" if sgd else "float32 Adam", card,
                               _step_families(sgd), key=None if sgd else "fused_step_float32")
    if not sgd:
        _profile_training_step(torch, exe, main, feed, loss, scope, "float32 Adam step", card,
                               out["wall_ms"]["graph"]["median"])
        _device_trace_step(torch, exe, main, feed, loss, scope, "float32 Adam step", card)
    return launches, steps


def _step_graph_vs_eager(torch, exe, main, feed, loss, scope, label, card, families,
                         key=None):
    """Phase 17, for one training path (run inside phases 7, 12 and 14,
    before each drops its executor): the step through its graph
    (``Executor.run``, a replay) against the same step op by op
    (``Executor._run_eager``) from the same state and feed, loss and every
    state tensor bit-equal; then the capture's seconds, ``CUDAGraph.replay``'s
    host microseconds, the wall a step and tokens/s through the graph and
    eagerly in alternating turns, the peak device memory of a step each
    way, and a profile of each (device idle share; the eager step's
    launches gated as the replay's).  With ``key``, the eager step's peak
    is phase 22's measured run of the step program."""
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
    if key is not None:
        rec = _analysis_prepare(key, exe, main, feed, [loss.name], scope)
    for name, fn in (("graph", graph), ("eager", eager)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if key is not None and name == "eager":
            _analysis_measure(rec, scope, feed, fn)
        else:
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
    """One step at batch 2 x 256, full width at TRAIN_VS_CPU_LAYERS, from
    the same weights.  The
    witness is the port on the CPU in float64; the card (TF32 off) must be
    within the gates of it, as the port on the CPU in float32 is; the card
    with TF32 on is the control the gates must reject.  The bf16 step's
    error against the same witness is printed with cuBLAS's reduced-
    precision bf16 reductions allowed and not, and each of its gradients is
    held against the same program's bf16 step on the CPU (plain versions),
    with the stale-cast program as the control."""
    import paddle_tpu_torch as pt
    main, startup, loss = _train_programs(pt, n_layer=TRAIN_VS_CPU_LAYERS)
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
        out = _step_graph_vs_eager(torch, exe, main, feed, loss, scope, "bf16 Adam", card,
                                   _step_families(), key="fused_step_bf16")
        _profile_training_step(torch, exe, main, feed, loss, scope, "bf16 Adam step", card,
                               out["wall_ms"]["graph"]["median"], bf16=True)
        _device_trace_step(torch, exe, main, feed, loss, scope, "bf16 Adam step", card)
    return launches, bf16_launches


# ------------------------------------------------------------ phase 18: the Trainer

TRAINER_STEPS = 5          # phase 18's epoch: whole batches of TRAIN_B rows
TRAINER_STOP_AFTER = 3     # the checkpointed run stops after this step
# phase 18's depth: transformer-base's widths at 2+2 layers (6+6 before the
# CNN phase came; the phase then took 49-57 s of the script's 236-262)
TRAINER_LAYERS = 2
TRAINER_PARAMS = 66
TRAINER_PER_STEP = dict(PER_STEP, flash_attn_fwd=2 * 3 * TRAINER_LAYERS)
TRAINER_BF16_PER_STEP = dict(BF16_PER_STEP, flash_attn_fwd=2 * 3 * TRAINER_LAYERS)


def _trainer_train_func(pt):
    """Phase 7's model at TRAINER_LAYERS as a Trainer's ``train_func``."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer

    def train_func():
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                            n_layer=TRAINER_LAYERS, d_model=D_MODEL, n_head=H,
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
    """Phase 7's loop on the same trainer's executor (phase 18's depth):
    the DataFeeder's feeds run by ``exe.run`` one by one, the loss read
    each step."""
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
    print(f"an exe.run loop on the same executor: {len(feeds)} steps in {wall:.3f} s, "
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
    want = {k: TRAINER_STEPS * v for k, v in _step_families(n_layer=TRAINER_LAYERS).items()}
    _gate_step_profile(prof, want, f"trainer {label} ({TRAINER_STEPS} steps)")
    return {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share")}


def phase_trainer(torch, card):
    """Phase 18: the ``Trainer`` on the card at transformer-base's widths
    and TRAINER_LAYERS (phase 7's model and Adam), from a seeded reader through
    ``reader.batch`` and the pow2 ``DataFeeder``.  (a) ``Trainer(pipeline=
    True)``, one epoch of TRAINER_STEPS batches, against ``Trainer(pipeline=False)``
    from the same state over the same batches: losses and every state
    tensor bit-equal, one replay a step, launches a step K1 12, K2 4, K3 4
    calls, K6 1, K7 1, K8 1 (the profile: K3 8, K7 2, K8 32 kernels);
    (b) ``save_params`` after step 3, and a new ``Trainer(param_path=)``
    holding every persistable bit-equal; (c) ``CheckpointConfig(
    step_interval=2)``: a run stopped after step 3, resumed by a new
    Trainer, repeats the later steps' losses and ends with the uninterrupted
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
    t_phase = t0 = time.perf_counter()
    piped = _make_trainer(pt)
    start = _persist_numpy(piped)
    params = [p.name for p in piped.train_program.global_block.all_parameters()]
    print(f"trainer (pipeline=True) built and initialized in {time.perf_counter() - t0:.2f} s: "
          f"{len(params)} parameters, {len(start)} persistables")
    if len(params) != TRAINER_PARAMS:
        raise AssertionError(f"{len(params)} parameters, want {TRAINER_PARAMS}")
    saved = {}

    def save_after_step(trainer):
        trainer.save_params(os.path.join(workdir, "params"))
        saved.update(_persist_numpy(trainer))
    run_p, loss_p = _train_once(piped, reader, counters, {TRAINER_STOP_AFTER: save_after_step})
    per_p = _gate_trainer_steps(run_p, "trainer pipelined", TRAINER_PER_STEP)
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

    t_phase = _piece_seconds("phase 18 (a) pipelined", t_phase)
    # (a) synchronous, from the same state
    sync = _make_trainer(pt, pipeline=False)
    _carry_numpy(sync, start)
    run_s, loss_s = _train_once(sync, reader, counters)
    per_s = _gate_trainer_steps(run_s, "trainer synchronous", TRAINER_PER_STEP)
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

    t_phase = _piece_seconds("phase 18 (a) synchronous", t_phase)
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

    t_phase = _piece_seconds("phase 18 (b)", t_phase)
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

    t_phase = _piece_seconds("phase 18 (c)", t_phase)
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

    t_phase = _piece_seconds("phase 18 (d)", t_phase)
    res["profiled"] = _profiled_trainer(torch, pt, start, loss_p, card)
    t_phase = _piece_seconds("phase 18 profiled trainer", t_phase)
    _free_trainer(torch, "profiled trainer")

    # the bf16 trainer: one batch three times
    once = _trainer_samples(TRAIN_B, seed=3)
    bf16_reader = pt.batch(pt.reader.chain(once, once, once), TRAIN_B)
    bf16 = _make_trainer(pt, amp=pt.amp.AmpConfig())
    run_b, loss_b = _train_once(bf16, bf16_reader, counters)
    per_b = _gate_trainer_steps(run_b, "trainer bf16", TRAINER_PER_STEP, TRAINER_BF16_PER_STEP,
                                steps=3)
    print(f"trainer bf16 (amp=AmpConfig()) losses {loss_b}")
    if not (np.isfinite(loss_b).all() and all(a > b for a, b in zip(loss_b, loss_b[1:]))):
        raise AssertionError(f"trainer bf16: losses not finite and falling: {loss_b}")
    res["bf16"] = {"losses": loss_b, "launches_a_step": per_b}
    bf16_launches = {k: counters[k].bf16_launches for k in BF16_PER_STEP}
    del bf16, run_b
    _free_trainer(torch, "bf16 trainer")
    shutil.rmtree(workdir, ignore_errors=True)
    _piece_seconds("phase 18 bf16 trainer", t_phase)

    p, s = res["pipelined"], res["synchronous"]
    print(f"trainer tokens/s: pipelined {p['timed']['tokens_per_s']:.0f}, synchronous "
          f"{s['timed']['tokens_per_s']:.0f}, exe.run loop {res['exe_run_loop']['tokens_per_s']:.0f} "
          f"(phase 7's loop at {N_LAYER}+{N_LAYER} layers {res['phase7_exe_run_tokens_per_s']}); "
          f"device idle share of a profiled "
          f"epoch pipelined {p['profile']['device_idle_share']:.4f}, synchronous "
          f"{s['profile']['device_idle_share']:.4f} [{card}]")
    print(json.dumps({"trainer": res}))
    return launches_trainer, bf16_launches


# ------------------------------------------------- phase 19: the observability core

# phase 19's records all go to one temporary directory (made in main); the
# launches each kernel made under the op profiles, summed over them
PHASE19 = {"dir": None, "launches_profile": {}, "launches_profile_bf16": {}}
# every record family phase 19 must leave in its directory
PHASE19_FAMILIES = ("steps_", "compiles_", "profile_", "costmodel_", "gauges_", "passes_",
                    "serving_", "memplan_")
PROFILE_SAMPLES = 3
PROFILE_COVERAGE = 0.9     # attributed / replay wall, the JAX package's own bar
# the launches one op-by-op replay pass of the training step makes: the
# step's (PER_STEP), with each of the 186 update ops lowered alone (one K6
# launch an op, where the step's graph makes one over all of them)
PER_PROFILE_PASS = dict(PER_STEP, fused_adam=N_PARAMS)
SERVE_PER_PASS = {"flash_attn_fwd": K1_PER_BATCH, "gather_rows": K2_PER_BATCH}
INT8_PER_PASS = dict(SERVE_PER_PASS, int8_matmul=K4_PER_BATCH, abs_max_pair=K4_PER_BATCH,
                     quantize_int8=2 * K4_PER_BATCH)


@contextlib.contextmanager
def _telemetry_on():
    """``PADDLE_TPU_TELEMETRY_DIR`` (and ``PADDLE_TPU_PROGRAM_DUMP_DIR``,
    which ``tools/pass_report.py`` reads) set to phase 19's directory for
    the block; on exit both are unset and every record stream's file is
    closed, so the other phases run with telemetry off."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.profiling import PROFILE_RECORDS
    names = ("PADDLE_TPU_TELEMETRY_DIR", "PADDLE_TPU_PROGRAM_DUMP_DIR")
    for k in names:
        os.environ[k] = PHASE19["dir"]
    try:
        yield PHASE19["dir"]
    finally:
        for k in names:
            os.environ.pop(k, None)
        for stream in (pt.telemetry.STEPS, PROFILE_RECORDS, pt.compile_log.COMPILE_LOG):
            stream.reopen()


def _zero_counters(counters):
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "bf16_launches"):
            f.bf16_launches = 0


def _op_profile(torch, exe, program, feed, fetch, scope, label, card, per_pass,
                bf16_per_pass=None, graph_wall_ms=None):
    """Phase 19 (a)/(b): ``exe.profile_ops`` (``PROFILE_SAMPLES`` samples,
    telemetry on) over ``program``'s step or batch right after a replay of
    its graph: the rows, coverage, top 10 ops and the sum by op type
    printed; the state and the captures unchanged; the kernels' launches
    during the profile equal to ``per_pass`` for each replay pass (the
    warm-up included).  Returns the profile and its launches."""
    persist = [v.name for v in program.list_vars()
               if v.persistable and scope.find_var(v.name) is not None]
    before = {n: scope.find_var(n).clone() for n in persist}
    addrs = {n: scope.find_var(n).data_ptr() for n in persist}
    captures = exe.cache_info()["captures"]
    counters = _counters()
    _zero_counters(counters)
    with _telemetry_on():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = exe.profile_ops(program, feed=feed, fetch_list=fetch, scope=scope,
                               samples=PROFILE_SAMPLES)
        call_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items() if f.launches}
    bf16 = {k: f.bf16_launches for k, f in counters.items()
            if getattr(f, "bf16_launches", 0)}
    written = [n for n in persist if scope.find_var(n).data_ptr() != addrs[n]
               or not torch.equal(scope.find_var(n), before[n])]
    del before
    passes = prof.samples + 1
    by_type = sorted(prof.by_type.items(), key=lambda kv: -kv[1]["wall_s"])
    rec = {"card": card, "ops_replayed": prof.ops_replayed, "samples": prof.samples,
           "replay_wall_ms": prof.measured_wall_s * 1e3,
           "attributed_ms": prof.attributed_s * 1e3, "coverage": prof.coverage,
           "profile_call_s": call_s, "graph_wall_ms": graph_wall_ms,
           "launches_profile": launches, "bf16_launches_profile": bf16,
           "top10": [[o.op_index, o.op_type, o.wall_s * 1e3, o.share, o.roofline, o.callsite]
                     for o in prof.top(10)],
           "by_type": {t: {"count": v["count"], "ms": v["wall_s"] * 1e3,
                           "share": v["wall_s"] / prof.attributed_s} for t, v in by_type}}
    print(prof.format(10))
    print(json.dumps({f"op_profile_{label.replace(' ', '_')}": rec}))
    want = {k: passes * v for k, v in per_pass.items() if v}
    want_bf16 = {k: passes * v for k, v in (bf16_per_pass or {}).items()}
    print(f"{label} op profile: {prof.ops_replayed} ops, replay wall "
          f"{rec['replay_wall_ms']:.2f} ms (graph {graph_wall_ms}), coverage "
          f"{prof.coverage:.4f}; launches over {passes} passes {launches} (want {want}), bf16 "
          f"{bf16}; state written {len(written)}; captures "
          f"{exe.cache_info()['captures'] - captures} [{card}]")
    if written or exe.cache_info()["captures"] != captures:
        raise AssertionError(f"{label}: the profile wrote state {written[:8]} or captured")
    if launches != want or bf16 != want_bf16:
        raise AssertionError(f"{label}: launches during the profile {launches}, bf16 {bf16}; "
                             f"want {want}, {want_bf16}")
    for k, n in launches.items():
        PHASE19["launches_profile"][k] = PHASE19["launches_profile"].get(k, 0) + n
    for k, n in bf16.items():
        PHASE19["launches_profile_bf16"][k] = PHASE19["launches_profile_bf16"].get(k, 0) + n
    return prof, rec


def _profile_training_step(torch, exe, main, feed, loss, scope, label, card, graph_wall_ms,
                           bf16=False):
    """Phase 19 (a), inside phases 7 and 14: after a replay of the step's
    graph, a control step from the state S the profile starts from, S
    copied back in place, the profile (every op: fetch_list=None), and
    the next replay: its loss and every state tensor bit-equal to the
    control's; coverage at least PROFILE_COVERAGE."""
    persist = [v.name for v in main.list_vars() if v.persistable]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    state0 = {n: scope.find_var(n).clone() for n in persist}
    (ctl,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    ctl_state = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    del state0
    prof, rec = _op_profile(torch, exe, main, feed, None, scope, label, card, PER_PROFILE_PASS,
                            BF16_PER_STEP if bf16 else None, graph_wall_ms)
    (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    differ = [n for n in persist if not torch.equal(scope.find_var(n), ctl_state[n])]
    print(f"{label}: the replayed step after the profile vs the control step from the same "
          f"state: loss {float(got):.7f} / {float(ctl):.7f}; {len(persist) - len(differ)} of "
          f"{len(persist)} state tensors bit-equal")
    if not np.array_equal(got, ctl) or differ:
        raise AssertionError(f"{label}: the step after the profile differs from the control: "
                             f"{differ[:8]}")
    if not prof.coverage >= PROFILE_COVERAGE:
        raise AssertionError(f"{label}: profile coverage {prof.coverage} < {PROFILE_COVERAGE}")
    return rec


def _device_ms_by_op(events, by_index=False):
    """Device milliseconds of a trace's kernels by the op whose
    ``op<idx>:<type>`` range was open when the kernel was launched (the
    runtime call carrying the kernel's correlation id), by op type (by
    ``"<idx>:<type>"`` with ``by_index``) and by (op type, kernel
    family).  Ops run one after another, so the ranges do not overlap; a launch may come from another thread than the range's
    (the autograd engine runs a generic grad's backward on a device
    thread of its own while the op waits), so any thread's launch counts."""
    import bisect
    import re
    ranges, launches = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), str(e.get("name", ""))
        m = re.match(r"op(\d+):(\w+)", name)
        if m and cat != "gpu_user_annotation":
            ranges.append((e["ts"], e["ts"] + e["dur"], m.group(2),
                           f"{m.group(1)}:{m.group(2)}"))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_type, by_family = {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        ts = launches.get(e.get("args", {}).get("correlation"))
        op = key = "(outside an op)"
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ranges[i][1] >= ts:
                op = ranges[i][2]
                key = ranges[i][3] if by_index else op
        ms = e["dur"] / 1e3
        by_type[key] = by_type.get(key, 0.0) + ms
        fam = f"{op} | {_family(str(e.get('name', '')))}"
        by_family[fam] = by_family.get(fam, 0.0) + ms
    return by_type, by_family


def _device_trace_step(torch, exe, main, feed, loss, scope, label, card,
                       need=("flash_attn_fwd (K1)", "linear_ce_fwd (K7)", "linear_ce_bwd (K8)"),
                       by_index=None, warm=False):
    """Phase 19 (f), inside phases 7 and 14: ``profiler.device_trace``
    (default directory: ``$PADDLE_TPU_TELEMETRY_DIR/xplane``) around one
    eager step (``_run_eager``, which commits the step): the exported trace
    names K1's, K7's and K8's kernels and the lowering's ``op<idx>:``
    ranges.  Prints the step's device time by op type, and of it the
    kernels outside cuBLAS and the hand-written ones ("other") by op type:
    the same kernels a replay of the step's graph launches.  A dict given
    as ``by_index`` is filled with the device ms by ``"<idx>:<type>"``.
    With ``warm``, a first eager step runs in the window, behind the
    primer, and only the kernels inside the second step's range count
    (see ``_profile``)."""
    import re
    import paddle_tpu_torch as pt
    with _telemetry_on():
        with pt.profiler.device_trace() as dt:
            # the primer's spin kernels first (a window was seen to lose its
            # first records: the LSTM step's gather, its first kernel) and
            # its tail last; the counts and times leave them out
            _profiler_started(torch)
            if warm:
                exe._run_eager(main, feed, [loss], scope)
                torch.cuda.synchronize()
            with torch.profiler.record_function(MEASURED) if warm else contextlib.nullcontext():
                exe._run_eager(main, feed, [loss], scope)
                torch.cuda.synchronize()
            _profiler_ending(torch)
    with open(dt.path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if not (e.get("cat") == "kernel" and PRIMER in str(e.get("name", "")))]
    warm_n = None
    if warm:
        # the host's range of the measured step, and each kernel's launch
        # (the runtime call of its correlation id) on the host's clock: the
        # device-side range holds only the kernels no op range encloses
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name") == MEASURED]
        if len(spans) != 1:
            raise AssertionError(f"{label}: {len(spans)} host ranges of the measured step")
        ((lo, hi),) = spans
        launched = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {})}

        def at(e):
            return launched.get(e.get("args", {}).get("correlation"), -1.0)
        warm_n = sum(1 for e in events if e.get("cat") == "kernel" and at(e) < lo)
        events = [e for e in events if e.get("cat") != "kernel" or lo <= at(e) <= hi]
    kernels, ranges = {}, set()
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") == "kernel":
            fam = _family(name)
            kernels[fam] = kernels.get(fam, 0) + 1
        elif re.match(r"op\d+:", name):
            ranges.add(name)
    by_type, by_family = _device_ms_by_op(events)
    if by_index is not None:
        by_index.update(_device_ms_by_op(events, by_index=True)[0])
    other = {k.split(" | ")[0]: v for k, v in by_family.items() if k.endswith(f" | {OTHER}")}
    rec = {"card": card, "trace_mib": os.path.getsize(dt.path) / 2 ** 20, "op_ranges": len(ranges),
           "kernels_by_family": kernels,
           "device_ms_by_op_type": dict(sorted(by_type.items(), key=lambda kv: -kv[1])),
           "other_kernels_ms_by_op_type": dict(sorted(other.items(), key=lambda kv: -kv[1])),
           "device_ms": sum(by_type.values()), "other_kernels_ms": sum(other.values())}
    if warm:
        rec["warm_kernels"] = warm_n
    print(f"{label}: device_trace of an eager step -> "
          f"{os.path.relpath(dt.path, PHASE19['dir'])} ({rec['trace_mib']:.1f} MiB): kernels by "
          f"family {kernels}; {len(ranges)} op ranges, e.g. {sorted(ranges)[:3]}; device "
          f"{rec['device_ms']:.2f} ms, of it other kernels {rec['other_kernels_ms']:.2f} ms"
          + (f" (behind a warm-up step of {warm_n} kernels)" if warm else "") + f" [{card}]")
    print(json.dumps({f"device_by_op_{label.replace(' ', '_')}": rec}))
    if any(not kernels.get(k) for k in need) or not ranges:
        raise AssertionError(f"{label}: the device trace lacks {need} kernels or op ranges")
    os.remove(dt.path)     # tens of MiB; its numbers are printed
    return rec


def _traced_serving(torch, inf, phase16_rps, card):
    """Phase 19 (d), inside phase 5: 64 requests from 4 threads through a
    ``ServingSession`` under one root trace (telemetry on; the root's own
    record closes every chain), ``tools/trace_tool.py --strict`` over the
    directory and its critical-path split; then the same 64 requests with
    telemetry off.  Both requests/s beside phase 16's."""
    import paddle_tpu_torch as pt
    tel = pt.telemetry
    root = tel.TraceContext.new_root()
    with _telemetry_on():
        sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0,
                                 warmup=False)
        t0 = time.perf_counter()
        rps_on, stats = _rps(sess, trace=root)
        client = tel.StepTelemetry(prefix="client")
        client.record(kind="client", requests=64, latency_s=time.perf_counter() - t0,
                      **root.fields())
        client.reopen()
        sess.close()
    sess = pt.ServingSession(inferencer=inf, max_batch_size=8, max_wait_ms=20.0, warmup=False)
    rps_off, _ = _rps(sess)
    sess.close()
    p = _tool("trace_tool", "--strict", "--json")
    if p.returncode != 0:
        raise AssertionError(f"trace_tool --strict exited {p.returncode}: {p.stderr[-2000:]}")
    (trace,) = [t for t in json.loads(p.stdout)["traces"] if t["trace_id"] == root.trace_id]
    out = {"card": card, "requests_per_s_traced": rps_on, "requests_per_s_off": rps_off,
           "requests_per_s_phase16": phase16_rps, "spans": trace["spans"],
           "critical_path_s": trace["attribution"], "end_to_end_s": trace["end_to_end_s"],
           "batches": stats["batches"]}
    print(f"traced serving: 64 requests under one root trace, {trace['spans']} spans, "
          f"trace_tool --strict exit 0; critical path (s, summed over the requests) "
          f"{json.dumps(trace['attribution'])}; requests/s traced {rps_on:.2f}, telemetry off "
          f"{rps_off:.2f}, phase 16 {phase16_rps:.2f} [{card}]")
    print(json.dumps({"traced_serving": out}))
    return out


def _profiled_trainer(torch, pt, start, loss_p, card):
    """Phase 19 (c), inside phase 18: ``Trainer(profile_steps=2)``
    (pipelined) over 4 batches from phase 18's start state (telemetry on):
    two profile summaries; losses bit-equal to phase 18's pipelined
    Trainer's first 4, and losses and every persistable bit-equal to the
    same Trainer run again from the start state with profiles off."""
    from paddle_tpu_torch.profiling import PROFILE_RECORDS
    reader = pt.batch(_trainer_samples(4 * TRAIN_B, seed=1), TRAIN_B)
    with _telemetry_on():
        tr = _make_trainer(pt, profile_steps=2)
        _carry_numpy(tr, start)
        n0 = len(PROFILE_RECORDS.records())
        run_a, loss_a = _train_once(tr, reader, {})
        recs = PROFILE_RECORDS.records()[n0:]
        final_a = _persist_numpy(tr)
        _carry_numpy(tr, start)
        tr.profile_steps = None
        run_b, loss_b = _train_once(tr, reader, {})
        final_b = _persist_numpy(tr)
    summaries = [r for r in recs if r["kind"] == "summary"]
    differ = [n for n in final_a if not np.array_equal(final_a[n], final_b[n])]
    print(f"Trainer(profile_steps=2), 4 pipelined steps: losses {loss_a}; profiles off "
          f"{loss_b}; phase 18's first 4 {loss_p[:4]}; {len(final_a) - len(differ)} of "
          f"{len(final_a)} persistables bit-equal; {len(summaries)} profile summaries, "
          f"coverage {[round(r['coverage'], 4) for r in summaries]}, the step's run_s "
          f"{[round(r['compiled_step_s'] * 1e3, 3) for r in summaries]} ms [{card}]")
    if loss_a != loss_b or loss_a != loss_p[:4] or differ or len(summaries) != 2:
        raise AssertionError(f"Trainer(profile_steps=2): losses {loss_a} / {loss_b} / "
                             f"{loss_p[:4]}, differing {differ[:8]}, {len(summaries)} summaries")
    del tr, run_a, run_b
    return {"losses": loss_a, "summaries": len(summaries),
            "coverage": [r["coverage"] for r in summaries]}


def _tool(name, *args):
    """``tools/<name>.py`` (the JAX package's jax-free readers) over phase
    19's directory, as a subprocess."""
    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.run([sys.executable, os.path.join(repo, "tools", f"{name}.py"),
                           PHASE19["dir"], *args], capture_output=True, text=True, timeout=300)


def phase_observability(torch, card):
    """Phase 19's end (its profiles, device trace, traced serving and
    profiled Trainer ran inside phases 5, 7, 11, 14 and 18): (g)
    ``resource_sampler.sample_once()``, its device bytes in use equal to
    ``torch.cuda.memory_allocated()`` read in the same call, and one gauge
    row written; (e) the record families present and ``tools/stats.py``,
    ``profile_report.py``, ``compile_report.py``, ``pass_report.py`` and
    ``trace_tool.py --strict`` each exiting 0 over the directory."""
    from paddle_tpu_torch import resource_sampler
    values = resource_sampler.sample_once()
    allocated = torch.cuda.memory_allocated()
    print(f"resource sampler: device0 bytes in use {values.get('device0_bytes_in_use')}, "
          f"torch.cuda.memory_allocated() {allocated}, peak "
          f"{values.get('device0_peak_bytes_in_use')}, limit {values.get('device0_bytes_limit')}, "
          f"process RSS {values.get('process_rss_bytes')}")
    if values.get("device0_bytes_in_use") != allocated:
        raise AssertionError(f"sample_once: {values.get('device0_bytes_in_use')} bytes in use, "
                             f"memory_allocated {allocated}")
    with _telemetry_on():
        sampler = resource_sampler.ResourceSampler()
        sampler.write_sample(values)
        sampler.close()
    names = sorted(os.listdir(PHASE19["dir"]))
    missing = [f for f in PHASE19_FAMILIES if not any(n.startswith(f) for n in names)]
    print(f"phase 19 records: {names}")
    if missing:
        raise AssertionError(f"phase 19's directory lacks {missing}")
    out = {}
    for name, args in (("stats", []), ("profile_report", []), ("compile_report", []),
                       ("pass_report", []), ("memory_report", []), ("trace_tool", ["--strict"])):
        t0 = time.perf_counter()
        p = _tool(name, *args)
        out[name] = {"rc": p.returncode, "s": time.perf_counter() - t0}
        tail = "\n".join(p.stdout.strip().splitlines()[-6:])
        print(f"tools/{name}.py {' '.join(args)}: exit {p.returncode} in "
              f"{out[name]['s']:.2f} s\n{tail}")
        if p.returncode != 0:
            raise AssertionError(f"tools/{name}.py exited {p.returncode}: {p.stderr[-2000:]}")
    return out


# ----------------------------------------------- phase 22 (b)-(c): in-phase hooks

# name -> the verifier's counts and seconds, the plan and the measured peak
# of each main path's program, filled inside the phases that run them
# (paddle_tpu_torch/analysis/measured.py, whose PLAN_BAND they are held in)
PHASE22 = {"paths": {}}


def _analysis_prepare(key, exe, program, feed, fetch_names, scope):
    """Phase 22 (b)-(c)'s record of the program ``exe`` runs for
    ``program`` (``measured.prepare``), kept under ``key``."""
    from paddle_tpu_torch.analysis import measured
    rec = PHASE22["paths"][key] = measured.prepare(
        f"phase 22 (b) {key}", exe, program, feed, fetch_names, scope)
    return rec


def _analysis_measure(rec, scope, feed, run):
    from paddle_tpu_torch.analysis import measured
    return measured.measure(rec, scope, feed, run)


def _analysis_path(torch, key, exe, program, feed, fetch_names, scope, run):
    rec = _analysis_prepare(key, exe, program, feed, fetch_names, scope)
    return _analysis_measure(rec, scope, feed, run)


# ------------------------------------------------- phase 20: the reference path

P20_STEPS = 4                 # (a): one eager step, then graph steps
P20_BF16_STEPS = 2            # (b): the capture's step, then a replay
NOAM_D, NOAM_WARMUP = D_MODEL, 4000
L2_COEFF, CLIP_NORM = 1e-4, 1.0
# the unfused head's step: no K7/K8; K3 and K8 are 2 and 32 kernels a call
P20_PER_STEP = dict(PER_STEP, linear_ce_fwd=0, linear_ce_bwd=0)
P20_FAMILIES = {"flash_attn_fwd (K1)": PER_STEP["flash_attn_fwd"],
                "gather_rows (K2)": PER_STEP["gather_rows"],
                "scatter_add_rows (K3)": 2 * PER_STEP["scatter_add_rows"],
                "fused_adam (K6)": 1, "linear_ce_fwd (K7)": 0, "linear_ce_bwd (K8)": 0}
ACCUM_STEPS, ACCUM_ROWS, ACCUM_APPLIES = 4, 16, 2   # (c)
ACCUM_LAYERS = 2        # (c)'s depth (6+6 before the CNN phase came)
# (d)'s depth: the CPU's float32 and float64 steps take most of its time
FAMILY_LAYERS, FAMILY_T, FAMILY_ROWS, FAMILY_STEPS = 2, 64, 2, 2
# (d): one program, each rule updating every tenth parameter; each of its
# steps on the card held against one step from the card's own state before
# it, on the CPU in float32 and in float64 (the witness).  The loss within
# FAMILY_LOSS_RTOL of the float32 CPU's.  Each floating state tensor,
# parameters and slots alike, by the step's change: the card's distance
# from the witness, norm-relative to the witness's change, at most
# FAMILY_WITNESS_FACTOR x the float32 CPU's own distance +
# FAMILY_WITNESS_FLOOR.  Rounding (the stored float32 parameter, a sign-like
# step such as Adamax's m / (u + 1e-8) where a gradient is near 0) puts
# both float32 runs about equally far from float64; a wrong rule puts the
# card far outside.  Held from the start rather than step by step, the card
# drifted: after 2 Adamax steps a few ReLU inputs crossed 0 on the card and
# not on the CPU, and the third step's gradients read 4.5e-3 from float64
# on the card against 3.4e-6 on the CPU (an H100).  Step by step on an H100
# every tensor read at most 0.25 of its gate: the card as far from float64
# as the CPU, or nearer (LarsMomentum's norms).  The gate's resolution is
# printed: a step FAMILY_CONTROL_SCALE x the witness's fails it for how
# many of each rule's tensors (at least one).  In this program the first
# rule's updates are one group call; each other rule's update passes that
# group and is lowered alone (``core/lower.py`` ``_lower_group``), so K5
# launches once an SGD op: the GPU tests hold each rule's group alone.
FAMILY_WITNESS_FACTOR = 4.0
FAMILY_WITNESS_FLOOR = 1e-5
FAMILY_CONTROL_SCALE = 1.1
FAMILY_LOSS_RTOL = 1e-5
INT8_MM = (2048, 512, 2048)   # (e): M, K, N


def _ref_feed(rows, t, seed):
    """Phase 7's feed at ``rows`` x ``t`` with the token weights: each
    target row's padded tail (past its ragged length) weighted 0."""
    rs = np.random.RandomState(seed)
    feed = {}
    for name in ("src", "trg"):
        lens = rs.randint(t // 2, t + 1, rows).astype(np.int32)
        ids = rs.randint(1, VOCAB, (rows, t, 1)).astype(np.int64)
        ids[np.arange(t)[None, :] >= lens[:, None]] = 0
        feed[name], feed[name + "@SEQ_LEN"] = ids, lens
    feed["lbl"] = rs.randint(1, VOCAB, (rows, t, 1)).astype(np.int64)
    feed["wgt"] = (np.arange(t)[None, :] < feed["trg@SEQ_LEN"][:, None]).astype(
        np.float32)[..., None]
    return feed


def _ref_net(pt, t=None, n_layer=None):
    """transformer-base's reference training network: the unfused head
    (fc to the vocabulary, softmax_with_cross_entropy) weighted by ``wgt``,
    global-norm clipping and L2 decay on the fc weights; returns the loss."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    t, n_layer = t or T, n_layer or N_LAYER
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = layers.data(name="lbl", shape=[t, 1], dtype="int64")
    wgt = layers.data(name="wgt", shape=[t, 1], dtype="float32")
    loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, weights=wgt, max_len=t,
                                        n_layer=n_layer, d_model=D_MODEL, n_head=H,
                                        d_inner=D_INNER, fuse_final_ce=False)
    for p in pt.default_main_program().global_block.all_parameters():
        if p.name.startswith("fc_") and p.name.endswith(".w_0"):
            p.regularizer = pt.regularizer.L2Decay(L2_COEFF)
    pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(CLIP_NORM))
    return loss


def _noam_adam(pt):
    """Paddle's Transformer schedule and Adam settings."""
    lr = pt.layers.noam_decay(NOAM_D, NOAM_WARMUP)
    return pt.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98, epsilon=1e-9), lr


def _ref_programs(pt, make_opt=_noam_adam, t=None, n_layer=None):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = _ref_net(pt, t, n_layer)
        opt, lr = make_opt(pt)
        opt.minimize(loss)
    return main, startup, loss, lr


def _noam_f32(torch, step):
    """noam_decay's value at ``step`` by the program's float32 operations on
    the card (pow, the two scales, the minimum)."""
    s = torch.tensor([float(step)], dtype=torch.float32, device="cuda")
    a = torch.pow(s, -0.5)
    b = s * (float(NOAM_WARMUP) ** -1.5) + 0.0
    return float((torch.minimum(a, b) * (float(NOAM_D) ** -0.5) + 0.0).item())


def _piece_seconds(label, t0):
    """Print the seconds since ``t0`` of a phase's piece; returns now."""
    now = time.perf_counter()
    print(f"{label}: {now - t0:.1f} s")
    return now


def _op_counts(program):
    types = [o.type for o in program.desc.block(0).ops]
    return len(types), {k: types.count(k) for k in sorted(set(types))}


def _launch_snapshot(counters):
    return {k: f.launches for k, f in counters.items()}


def _bf16_snapshot(counters):
    """The bf16 instances' counts (0 for a wrapper with none); each is also
    in its wrapper's ``launches``."""
    return {k: getattr(f, "bf16_launches", 0) for k, f in counters.items()}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def phase_reference_path(torch, card):
    """Phase 20 (see the module docstring): the reference training path at
    transformer-base's full width -- (a) the unfused head with token
    weights, noam_decay, Adam, global-norm clipping and L2 decay, (b) its
    bf16 twin, (c) Trainer(accum_steps=4) at 2+2 layers, (d) the optimizer family at 2+2
    layers against the CPU, (e) the int8 matmul.  Returns the launches by
    kernel of each piece."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {"card": card}
    out = {}

    # (a) the full-width reference step
    t_phase = t0 = time.perf_counter()
    main, startup, loss, lr = _ref_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    feed = _ref_feed(TRAIN_B, T, seed=0)
    n_ops, by_type = _op_counts(main)
    n_params = len(main.global_block.all_parameters())
    run_ops = [o.type for o in exe._apply_passes(main, list(feed), [loss.name, lr.name])
               .desc.block(0).ops]
    persist = [v.name for v in main.list_vars()
               if v.persistable and scope.find_var(v.name) is not None]
    (counter,) = [n for n in persist if "COUNTER" in n]
    keys = ("softmax_with_cross_entropy", "softmax_with_cross_entropy_grad", "mul", "mul_grad",
            "adam", "squared_l2_norm", "elementwise_mul", "reduce_sum", "scale", "sum",
            "increment", "fused_fc_softmax_ce")
    res["program"] = {"ops": n_ops, "by_type": {k: by_type.get(k, 0) for k in keys},
                      "parameters": n_params, "after_passes": {
                          k: run_ops.count(k) for k in ("pallas_adam", "adam", "pallas_gather",
                                                        "pallas_scatter_add")}}
    print(f"phase 20 (a) reference program: {n_ops} ops {json.dumps(res['program'])}; built and "
          f"initialized on the card in {time.perf_counter() - t0:.2f} s")
    if n_params != N_PARAMS or by_type.get("softmax_with_cross_entropy") != 1 \
            or by_type.get("fused_fc_softmax_ce"):
        raise AssertionError(f"phase 20 (a): {n_params} parameters, ops {by_type}")
    rec22 = _analysis_prepare("reference_step", exe, main, feed, [loss.name, lr.name], scope)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    snaps, losses, lrs, counts, step_s = [], [], [], [], []
    for step in range(1, P20_STEPS + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if step == 1:
            lv, rv = _analysis_measure(rec22, scope, feed,
                                       lambda: exe._run_eager(main, feed, [loss, lr], scope))
        else:
            lv, rv = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(np.asarray(lv)))
        lrs.append(float(np.ravel(rv)[0]))
        counts.append(int(scope.find_var(counter)[0]))
        snaps.append(_launch_snapshot(counters))
    main_path = _launch_snapshot(counters)
    peak = torch.cuda.max_memory_allocated()
    want_lr = [_noam_f32(torch, s) for s in range(1, P20_STEPS + 1)]
    per_step = [_delta(b, a) for a, b in zip(snaps[2:], snaps[3:])]
    entries = [e for e in exe.cache_info()["entries"] if "lbl" in e["feeds"]]
    print(f"phase 20 (a) losses {losses}; learning rates {lrs} (noam_decay in float32 "
          f"{want_lr}); counter after each step {counts}; step seconds "
          f"{[round(s, 4) for s in step_s]} (step 1 op by op, step 2 the capture, then "
          f"replays); launches over the {P20_STEPS} steps {main_path}; a replay's "
          f"{per_step[0] if per_step else None}; the step's entry kind "
          f"{[e['kind'] for e in entries]}; peak device memory {peak / 2 ** 30:.2f} GiB [{card}]")
    if not np.isfinite(losses).all() or not all(a > b for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"phase 20 (a): losses not finite and falling: {losses}")
    if lrs != want_lr or counts != list(range(1, P20_STEPS + 1)):
        raise AssertionError(f"phase 20 (a): learning rates {lrs} (want {want_lr}) or "
                             f"counter {counts}")
    if [e["kind"] for e in entries] != ["graph"] or exe.cache_info()["captures"] != 1:
        raise AssertionError(f"phase 20 (a): the step is not one graph: {entries}")
    want = {k: v for k, v in P20_PER_STEP.items()}
    if any(d != want for d in per_step):
        raise AssertionError(f"phase 20 (a): launches a replay {per_step}, want {want}")
    for k in ("flash_attn_fwd", "gather_rows", "scatter_add_rows", "fused_adam"):
        if not main_path[k]:
            raise AssertionError(f"phase 20 (a): {k} was not launched on the main path")
    out["a"] = main_path
    replay_ms = 1e3 * float(np.median(step_s[2:]))
    res["a"] = {"losses": losses, "lrs": lrs, "step_s": step_s, "replay_ms_median": replay_ms,
                "tokens_per_s": TRAIN_B * T / replay_ms * 1e3,
                "target_tokens_per_s": float(feed["wgt"].sum()) / replay_ms * 1e3,
                "peak_allocated_gib": peak / 2 ** 30, "launches_a_step": per_step[0],
                "launches_main_path": main_path}

    # the replayed step against an op-by-op step from the same state
    state0 = {n: scope.find_var(n).clone() for n in persist}
    g_out = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
    after = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    e_out = exe._run_eager(main, feed, [loss, lr], scope)
    differ = [n for n in persist if not torch.equal(after[n], scope.find_var(n))]
    equal = not differ and all(np.array_equal(a, b) for a, b in zip(g_out, e_out))
    print(f"phase 20 (a): step {P20_STEPS + 1} replayed vs op by op from the same state: loss "
          f"{float(g_out[0]):.7f} / {float(e_out[0]):.7f}, lr {float(np.ravel(g_out[1])[0])!r} / "
          f"{float(np.ravel(e_out[1])[0])!r}; {len(persist) - len(differ)} of {len(persist)} "
          f"state tensors bit-equal ({'bit-equal' if equal else 'NOT bit-equal'})")
    if not equal:
        raise AssertionError(f"phase 20 (a): the replay differs from the eager step: {differ[:8]}")
    del state0, after
    prof = _profile(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope),
                    "reference_path_profile", card, {"batch": [TRAIN_B, T]})
    _gate_step_profile(prof, P20_FAMILIES, "phase 20 (a)")
    res["a"]["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                                "by_family_ms", "by_family_launches")}
    start = {n: scope.find_var(n).to("cpu", copy=True) for n in persist}
    # phase 22 (a) evaluates this trained model, (d) budgets its step
    PHASE22["ref"] = {"main": main, "startup": startup, "loss": loss.name, "state": start,
                      "feed": feed}
    del exe, scope
    _free_trainer(torch, "phase 20 (a)")
    t_phase = _piece_seconds("phase 20 (a)", t_phase)

    # (b) the bf16 twin, from (a)'s last state (the counter included: the
    # schedule goes on where (a) stopped)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0), amp=pt.amp.AmpConfig())
    exe.run(startup, scope=scope)
    for n, t in start.items():
        scope.find_var(n).copy_(t)
    prog = exe._apply_passes(main, list(feed), [loss.name, lr.name])
    blk = prog.desc.block(0)
    ce_dtypes = sorted({blk.find_var(n).dtype.value for o in blk.ops
                        if o.type.startswith("softmax_with_cross_entropy")
                        for slot in ("Logits", "Softmax", "Loss", "__out__Softmax", "__out__Loss")
                        for n in o.inputs.get(slot, []) + o.outputs.get(slot, []) if n})
    bf16_before = {k: getattr(f, "bf16_launches", 0) for k, f in counters.items()}
    b_losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]))
                for _ in range(P20_BF16_STEPS)]
    bf16_launches = {k: getattr(f, "bf16_launches", 0) - bf16_before[k]
                     for k, f in counters.items()}
    print(f"phase 20 (b) bf16 twin (AmpConfig()): losses {b_losses}; softmax-CE vars in "
          f"{ce_dtypes}; {sum(o.type == 'cast' for o in blk.ops)} casts; bf16 launches over {P20_BF16_STEPS} "
          f"steps {bf16_launches}; captures {exe.cache_info()['captures']} [{card}]")
    if not np.isfinite(b_losses).all() or not b_losses[0] > b_losses[-1] \
            or ce_dtypes != ["float32"]:
        raise AssertionError(f"phase 20 (b): losses {b_losses}, softmax-CE dtypes {ce_dtypes}")
    res["b"] = {"losses": b_losses, "softmax_ce_dtypes": ce_dtypes, "bf16_launches": bf16_launches}
    out["b_bf16"] = bf16_launches
    del exe, scope, prog, main, startup
    _free_trainer(torch, "phase 20 (b)")
    t_phase = _piece_seconds("phase 20 (b)", t_phase)

    res["c"] = _ref_accumulation(torch, pt, counters, card)
    t_phase = _piece_seconds("phase 20 (c)", t_phase)
    res["d"], out["d"] = _ref_families(torch, pt, counters, card)
    t_phase = _piece_seconds("phase 20 (d)", t_phase)
    res["e"], out["e"] = _ref_int8_matmul(torch, pt, counters, card)
    print(json.dumps({"reference_path": res}))
    return out


def _ref_samples(n, seed):
    """Phase 18's samples with the token weights of a ragged target."""
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            length = rs.randint(T // 2, T + 1)
            yield (rs.randint(1, VOCAB, (rs.randint(T // 2 + 1, T + 1), 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
                   (np.arange(T) < length).astype(np.float32)[:, None])
    return reader


def _ref_accumulation(torch, pt, counters, card):
    """(c) Trainer(accum_steps=4, pipeline=True) over 16 x 256 micro-batches
    of (a)'s program at ACCUM_LAYERS, two applies, against an exe.run loop
    of the same accumulate and apply programs on the same executor from
    the same state: parameters bit-equal; each program's cache entry
    kind."""
    def optimizer_func():
        return _noam_adam(pt)[0]
    with pt.unique_name.guard():
        trainer = pt.Trainer(lambda: _ref_net(pt, n_layer=ACCUM_LAYERS), optimizer_func,
                             place=pt.CUDAPlace(0), accum_steps=ACCUM_STEPS, pipeline=True)
    feed_order = ["src", "trg", "lbl", "wgt"]
    names = [v.name for v in trainer.train_program.list_vars() if v.persistable] + \
        [v.name for v in trainer.apply_program.list_vars() if v.name.endswith("@ACC")]
    start = {n: trainer.scope.find_var(n).clone() for n in names}
    reader = pt.batch(_ref_samples(ACCUM_STEPS * ACCUM_APPLIES * ACCUM_ROWS, seed=3), ACCUM_ROWS)
    losses = []

    def handler(ev):
        if type(ev).__name__ == "EndStepEvent":
            losses.append(ev.metrics[0])
    t0 = time.perf_counter()
    trainer.train(1, handler, reader=reader, feed_order=feed_order)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [float(np.asarray(m)) for m in losses]
    params = [p.name for p in trainer.train_program.global_block.all_parameters()]
    trained = {n: trainer.scope.find_var(n).clone() for n in names}
    kinds = {}
    for e in trainer.exe.cache_info()["entries"]:
        if "lbl" in e["feeds"]:
            kinds["accumulate"] = [e["kind"], e["reasons"]]
        elif not e["feeds"] and not any("initializes" in r for r in e["reasons"]):
            kinds["apply"] = [e["kind"], e["reasons"]]
    for n, t in start.items():
        trainer.scope.find_var(n).copy_(t)
    feeder = pt.DataFeeder(feed_list=[trainer.train_program.global_block.var(n)
                                      for n in feed_order],
                           program=trainer.train_program, seq_len_buckets="pow2")
    for i, batch in enumerate(reader()):
        # the Trainer's fetch list: the same cache entry, its graph replayed
        trainer.exe.run(trainer._step_program, feed=feeder.feed(batch),
                        fetch_list=trainer.train_outputs, scope=trainer.scope)
        if i % ACCUM_STEPS == ACCUM_STEPS - 1:
            trainer.exe.run(trainer.apply_program, feed={}, fetch_list=[], scope=trainer.scope)
    differ = [n for n in names if not torch.equal(trained[n], trainer.scope.find_var(n))]
    moved = [n for n in params if torch.equal(trained[n], start[n])]
    print(f"phase 20 (c) Trainer(accum_steps={ACCUM_STEPS}, pipeline=True), "
          f"{ACCUM_STEPS * ACCUM_APPLIES} micro-batches of {ACCUM_ROWS} x {T}: losses {losses}; "
          f"{train_s:.2f} s; against an exe.run loop of the accumulate and apply programs from "
          f"the same state: {len(names) - len(differ)} of {len(names)} persistables bit-equal; "
          f"entries {json.dumps(kinds)}; captures {trainer.exe.cache_info()['captures']} [{card}]")
    if differ or moved or not np.isfinite(losses).all():
        raise AssertionError(f"phase 20 (c): differ {differ[:8]}, unmoved {moved[:8]}")
    out = {"losses": losses, "seconds": train_s, "entries": kinds,
           "bit_equal_persistables": len(names)}
    del trainer, start, trained
    _free_trainer(torch, "phase 20 (c)")
    return out


def _family_optimizers(pt):
    o, L = pt.optimizer, pt.layers
    return {
        "Momentum": lambda: o.Momentum(learning_rate=0.01, momentum=0.9),
        "Momentum_nesterov": lambda: o.Momentum(learning_rate=0.01, momentum=0.9,
                                                use_nesterov=True),
        "LarsMomentum": lambda: o.LarsMomentum(learning_rate=1.0, momentum=0.9),
        "Adamax": lambda: o.Adamax(learning_rate=0.002),
        "Adagrad": lambda: o.Adagrad(learning_rate=0.01),
        "DecayedAdagrad": lambda: o.DecayedAdagrad(learning_rate=0.01),
        "Adadelta": lambda: o.Adadelta(learning_rate=1.0),
        "RMSProp": lambda: o.RMSProp(learning_rate=0.001, momentum=0.5),
        "Ftrl": lambda: o.Ftrl(learning_rate=0.01, l2=0.001),
        "SGD_exponential_decay": lambda: o.SGD(learning_rate=L.exponential_decay(0.1, 2, 0.5)),
    }


def _kernel_names(torch, run):
    """Device kernels by name during ``run()`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _profiler_started(torch)
        run()
        torch.cuda.synchronize()
        _profiler_ending(torch)
    names = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 and PRIMER not in e.name():
            names[e.name()] = names.get(e.name(), 0) + 1
    return names


def _family_program(pt):
    """(d)'s program: (a)'s network at FAMILY_LAYERS x FAMILY_T with its
    clip and L2, each rule of _family_optimizers applying the gradients of
    its share of the parameters (every tenth, in order).  Returns (main,
    startup, loss, each rule's parameter names)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = _ref_net(pt, FAMILY_T, FAMILY_LAYERS)
        params_grads = pt.append_backward(loss)
        params_grads = pt.clip.append_gradient_clip_ops(params_grads)
        params_grads = pt.regularizer.append_regularization_ops(params_grads)
        rules = _family_optimizers(pt)
        shares = {}
        for k, (name, make) in enumerate(rules.items()):
            share = params_grads[k::len(rules)]
            make().apply_gradients(share)
            shares[name] = [p.name for p, _ in share]
    return main, startup, loss, shares


def _family_distances(torch, before, card, cpu32, cpu64):
    """Per floating state tensor: the card's and the float32 CPU's distance
    from the float64 witness, norm-relative to the witness's change from
    ``before``; computed in float64 on the card."""
    out = {}
    for n, w in cpu64.items():
        if not w.is_floating_point():
            continue
        w = w.to("cuda")
        s = torch.from_numpy(before[n]).to("cuda", torch.float64)
        move = float(torch.linalg.vector_norm(w - s))
        out[n] = tuple(float(torch.linalg.vector_norm(t.to("cuda", torch.float64) - w))
                       / max(move, 1e-300) for t in (card[n], cpu32[n]))
    return out


def _family_gate(dist_cpu):
    return FAMILY_WITNESS_FACTOR * dist_cpu + FAMILY_WITNESS_FLOOR


def _ref_families(torch, pt, counters, card):
    """(d) FAMILY_STEPS steps of one program in which each update rule (8 new
    ones, Momentum also Nesterov, and SGD with exponential_decay through
    K5) updates its share of a 2+2 network at (a)'s widths on the card (one
    graph a step); each step against one step from the same state on the
    CPU in float32 and in float64; each rule's lowering calls, and the
    multi-tensor kernels of one replay."""
    from paddle_tpu_torch.core.registry import OPS
    t0 = time.perf_counter()
    feed = _ref_feed(FAMILY_ROWS, FAMILY_T, seed=4)
    main, startup, loss, shares = _family_program(pt)
    rule_of = {p: name for name, ps in shares.items() for p in ps}
    blk = main.desc.block(0)
    persist = [v.name for v in main.list_vars() if v.persistable]
    # a slot belongs to its parameter's rule
    for n in persist:
        owner = blk.find_var(n).attrs.get("slot_of")
        if owner in rule_of:
            rule_of[n] = rule_of[owner]
    updates = sorted({o.type for o in blk.ops if o.attrs.get("op_role") == "optimize"
                      and o.type != "scale"})
    gscope, gexe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    gexe.run(startup, scope=gscope)
    persist = [n for n in persist if gscope.find_var(n) is not None]
    infos = {t: OPS.get(t) for u in updates for t in (u, "pallas_" + u) if OPS.has(t)}
    originals = {t: (i.group_lower, i.lower) for t, i in infos.items()}
    calls = {name: [] for name in shares}

    def counting(group_lower, lower):
        """The lowerings, each call booked to its rule with its op count (an
        update that passes another rule's group is lowered at once, alone:
        ``core/lower.py`` ``_lower_group``)."""
        def group(ctx, ops):
            calls[rule_of[ops[0].input("Param")[0]]].append(len(ops))
            group_lower(ctx, ops)

        def one(ctx, op):
            calls[rule_of[op.input("Param")[0]]].append(1)
            lower(ctx, op)
        return group, one
    cpu = {dt: (pt.Scope(), pt.Executor(pt.CPUPlace())) for dt in (np.float32, np.float64)}
    k5 = counters["fused_sgd"].launches
    losses, steps, secs = [], [], {"card": 0.0, "cpu_float32": 0.0, "cpu_float64": 0.0}
    for _ in range(FAMILY_STEPS):
        before = {n: gscope.find_var(n).to("cpu", copy=True).numpy() for n in persist}
        t1 = time.perf_counter()
        for t, i in infos.items():
            i.group_lower, i.lower = counting(*originals[t])
        try:
            step_losses = [float(gexe.run(main, feed=feed, fetch_list=[loss], scope=gscope)[0])]
        finally:
            for t, i in infos.items():
                i.group_lower, i.lower = originals[t]
        torch.cuda.synchronize()
        secs["card"] += time.perf_counter() - t1
        got = {n: gscope.find_var(n) for n in persist}
        if not all(torch.isfinite(t).all() for t in got.values() if t.is_floating_point()):
            raise AssertionError("phase 20 (d): a state tensor is not finite on the card")
        ref = {}
        for dt, (scope, exe) in cpu.items():
            t1 = time.perf_counter()
            pt.params_from_numpy({n: a.astype(dt) if a.dtype == np.float32 else a
                                  for n, a in before.items()}, scope, "cpu")
            step_losses.append(float(exe.run(main, feed=feed, fetch_list=[loss],
                                             scope=scope)[0]))
            ref[dt] = {n: scope.find_var(n) for n in persist}
            secs["cpu_" + np.dtype(dt).name] += time.perf_counter() - t1
        losses.append(step_losses)
        steps.append(_family_distances(torch, before, got, ref[np.float32], ref[np.float64]))
        del before, ref
    k5 = counters["fused_sgd"].launches - k5
    kinds = [e["kind"] for e in gexe.cache_info()["entries"] if "lbl" in e["feeds"]]
    names = _kernel_names(torch, lambda: gexe.run(main, feed=feed, fetch_list=[loss],
                                                  scope=gscope))
    foreach = sum(c for k, c in names.items() if "multi_tensor_apply" in k)
    outside = [{n: round(c / _family_gate(f), 2) for n, (c, f) in d.items() if c > _family_gate(f)}
               for d in steps]
    out = {}
    for name in shares:
        mine = [n for n in steps[0] if rule_of.get(n) == name]
        worst = max(((d[n][0] / _family_gate(d[n][1]), k + 1, n) for k, d in enumerate(steps)
                     for n in mine))
        resolved = sum(FAMILY_CONTROL_SCALE - 1 > _family_gate(d[n][1])
                       for d in steps[-1:] for n in mine)
        out[name] = {"parameters": len(shares[name]), "tensors": len(mine),
                     "lowering_calls": len(calls[name]), "ops_per_call": sorted(set(calls[name])),
                     "card_vs_float64_max": max(d[n][0] for d in steps for n in mine),
                     "cpu_vs_float64_max": max(d[n][1] for d in steps for n in mine),
                     "worst_over_gate": worst, "control_outside_last_step": resolved}
        print(f"phase 20 (d) {name}: {len(shares[name])} parameters, {len(mine)} state tensors; "
              f"each step's change against the float64 witness, the largest: card "
              f"{out[name]['card_vs_float64_max']:.3e}, CPU float32 "
              f"{out[name]['cpu_vs_float64_max']:.3e}; nearest the gate: {worst[2]} at step "
              f"{worst[1]}, {worst[0]:.3f} of it; a step {FAMILY_CONTROL_SCALE:g} x the "
              f"witness's fails the gate for {resolved} of {len(mine)}; lowering calls on the "
              f"card {len(calls[name])} of {sorted(set(calls[name]))} ops [{card}]")
    rec = {"rules": out, "losses_card_cpu32_cpu64": losses, "outside": outside,
           "entry_kinds": kinds, "multi_tensor_kernels_a_replay": foreach,
           "fused_sgd_launches": k5, "updates": updates, "seconds": time.perf_counter() - t0,
           **{k + "_s": v for k, v in secs.items()}}
    print(f"phase 20 (d): losses (card, CPU float32, float64) {losses}; outside the gate "
          f"({FAMILY_WITNESS_FACTOR:g} x CPU + {FAMILY_WITNESS_FLOOR:g}) {outside}; "
          f"{foreach} multi-tensor kernels in one replay; K5 launches {k5}; entries {kinds}; "
          f"{rec['seconds']:.1f} s (card {secs['card']:.1f}, CPU float32 "
          f"{secs['cpu_float32']:.1f}, float64 {secs['cpu_float64']:.1f}) [{card}]")
    if any(outside) or kinds != ["graph"] or not all(
            abs(c - f) <= FAMILY_LOSS_RTOL * abs(f) for c, f, _ in losses):
        raise AssertionError(f"phase 20 (d): outside the witness gate {outside}, entries "
                             f"{kinds}, losses {losses}")
    if not all(r["control_outside_last_step"] and r["lowering_calls"] for r in out.values()):
        raise AssertionError(f"phase 20 (d): a rule not lowered, or whose gate a "
                             f"{FAMILY_CONTROL_SCALE:g} x step passes: {out}")
    # the capture's eager run and the capture each lower the step once; K5
    # launches once a lowering call of the SGD rule, as many on each replay
    want_k5 = (FAMILY_STEPS + 1) * len(calls["SGD_exponential_decay"]) // 2
    if k5 != want_k5:
        raise AssertionError(f"phase 20 (d): K5 launched {k5} times over {FAMILY_STEPS} steps, "
                             f"want {want_k5}")
    del gexe, gscope, cpu
    gc.collect()
    torch.cuda.empty_cache()
    return rec, {"fused_sgd": k5}


def _ref_int8_matmul(torch, pt, counters, card):
    """(e) a 2-D ``layers.matmul`` served by Inferencer(amp=AmpConfig(
    bf16=False, quant=True), kernels=True): K4 once a pass through the
    ``base_op="matmul"`` branch, bit-equal to the fake-quant program
    (kernels=False) and within INT8_VS_FP32_NORM_RTOL of float32."""
    m, k, n = INT8_MM

    def infer_func():
        x = pt.layers.data(name="x", shape=[k])
        w = pt.layer_helper.LayerHelper("proj").create_parameter(
            pt.ParamAttr(name="proj.w"), shape=[k, n], dtype="float32")
        return pt.layers.matmul(x, w)
    amp = pt.amp.AmpConfig(bf16=False, quant=True)
    kern = pt.Inferencer(infer_func, place=pt.CUDAPlace(0), amp=amp, kernels=True)
    sim = pt.Inferencer(infer_func, place=pt.CUDAPlace(0), amp=amp, kernels=False)
    f32 = pt.Inferencer(infer_func, place=pt.CUDAPlace(0))
    w = kern.scope.find_var("proj.w")
    for inf in (sim, f32):
        inf.scope.find_var("proj.w").copy_(w)
    ops = [(o.type, o.attrs.get("base_op")) for o in kern.exe._apply_passes(
        kern.inference_program, ["x"], [v.name for v in kern.predict_vars]).desc.block(0).ops]
    kern.warmup([m])
    feed = {"x": np.random.RandomState(6).randn(m, k).astype(np.float32)}
    names = ("int8_matmul", "abs_max_pair", "quantize_int8")
    for nm in names:
        counters[nm].launches = 0
    passes = 3
    got = [kern.infer(feed)[0] for _ in range(passes)]
    launches = {nm: counters[nm].launches for nm in names}
    ref = sim.infer(feed)[0]
    want = f32.infer(feed)[0]
    rel = float(np.linalg.norm(got[0] - want) / np.linalg.norm(want))
    equal = all(np.array_equal(g, ref) for g in got)
    print(f"phase 20 (e) int8 matmul [{m}, {k}] x [{k}, {n}]: program {ops}; launches over "
          f"{passes} passes {launches}; bit-equal to the fake-quant program {equal}; "
          f"norm-relative to float32 {rel:.4e} (gate {INT8_VS_FP32_NORM_RTOL}) [{card}]")
    if ops != [("pallas_int8_matmul", "matmul")] or launches["int8_matmul"] != passes \
            or not equal or rel > INT8_VS_FP32_NORM_RTOL:
        raise AssertionError(f"phase 20 (e): ops {ops}, launches {launches}, equal {equal}, "
                             f"rel {rel}")
    del kern, sim, f32
    _free_trainer(torch, "phase 20 (e)")
    return {"launches": launches, "bit_equal_to_fake_quant": equal, "nrel_vs_float32": rel}, \
        launches


# phase 21: the CNN path (ResNet-50 training in bf16 and float32, ResNet-18
# on the card against the CPU, the MNIST CNN with Adam, bn-fold served)
RESNET_B, RESNET_HW, RESNET_CLASSES, RESNET_DEPTH = 128, 224, 1000, 50   # bench.py:124
RESNET_OPS, RESNET_AMP_OPS, RESNET_AMP_CASTS = 535, 975, 440
RESNET_BN_STATS, RESNET_VELOCITIES = 106, 161
CNN_REPLAYS = 6            # timed replays of the step on one batch
CNN_PROFILE_STEPS = 2
# (d): ResNet-18 at bench.py's shapes off the TPU (bench.py:127), two steps on
# the card, each against a step on the CPU from the card's state before it,
# float32 (TF32 off): each state tensor's change in the step, norm-relative
# to the CPU's, and the loss, relative.  The port on the CPU against the JAX
# package at the same shapes read <= 5.8e-5 on the changes over two steps
# from one start (tests/test_torch_cnn_models.py); two steps from one start
# on the card read 1.7e-3 against the CPU (a batch_norm bias's velocity: the
# first step takes the loss from 4.46 to 0.44, and the second step's
# gradients carry the first step's rounding), hence a step from the card's
# own state
CARD_VS_CPU_CHANGE_NREL = 1e-3
CARD_VS_CPU_LOSS_RTOL = 1e-4
CARD_VS_CPU_B, CARD_VS_CPU_HW, CARD_VS_CPU_CLASSES, CARD_VS_CPU_DEPTH = 8, 32, 10, 18
MNIST_B, MNIST_STEPS = 64, 4
# (f): the folded program's logits against the unfolded one's: the JAX
# package's fold tolerance, rtol 2e-4, with an absolute term of 2e-4 of the
# largest logit for the logits near 0
BN_FOLD_RTOL = 2e-4
BN_FOLD_ROWS = 8


def _resnet_programs(pt, depth=RESNET_DEPTH, hw=RESNET_HW, classes=RESNET_CLASSES, amp=False):
    """bench.py's ``_resnet_train_setup``: ``resnet.train_network`` and
    ``Momentum(0.01, 0.9)``, flagged by ``enable_amp`` for bf16."""
    from paddle_tpu_torch.models import resnet
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        image = pt.layers.data(name="image", shape=[3, hw, hw], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc = resnet.train_network(image, label, class_dim=classes, depth=depth)
        pt.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    if amp:
        pt.amp.enable_amp(main)
    return main, startup, loss, acc


def _image_feed(torch, rows, hw, classes, seed, device):
    rs = np.random.RandomState(seed)
    image = rs.randn(rows, 3, hw, hw).astype(np.float32)
    label = rs.randint(0, classes, (rows, 1)).astype(np.int32)
    if device == "cpu":
        return {"image": image, "label": label}
    # placed on the card before the step, as bench.py:153-161 places them
    return {"image": torch.from_numpy(image).to(device), "label": torch.from_numpy(label).to(device)}


def _model_flops(program, rows):
    """2 * multiply-adds of a forward pass over ``rows`` rows, from the
    ProgramDesc's ``conv2d`` and ``mul`` shapes."""
    blk = program.desc.block(0)

    def shape(name):
        return [rows if d < 0 else d for d in blk.find_var(name).shape]

    macs = 0
    for op in blk.ops:
        if op.type == "conv2d":
            n, _, ho, wo = shape(op.output("Output")[0])
            co, ci, kh, kw = shape(op.input("Filter")[0])
            macs += n * co * ho * wo * ci * kh * kw
        elif op.type == "mul":
            x, (k, n) = shape(op.input("X")[0]), shape(op.input("Y")[0])
            macs += int(np.prod(x[:op.attr("x_num_col_dims", 1)])) * k * n
    return 2 * macs


def _state_names(main, scope):
    persist = [v.name for v in main.list_vars() if v.persistable and scope.find_var(v.name) is not None]
    stats = [n for n in persist if n.startswith("batch_norm_") and n.endswith((".w_2", ".w_3"))]
    velocities = [n for n in persist if "_velocity_" in n]
    return persist, stats, velocities


def _state_vs_eager(torch, exe, main, feed, fetch, scope, persist, kinds, label, card, key=None,
                    phase="phase 21 (c)"):
    """Phase 21 (c) (and 25 (a)): a replayed step against an op-by-op step
    from the same state, printed by kind of state tensor; the loss must be
    bit-equal.  Returns the state tensors that differ and the largest
    difference.  With ``key``, the op-by-op step is phase 22's measured run
    of the step."""
    state0 = {n: scope.find_var(n).clone() for n in persist}
    g_out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    after = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    if key is None:
        e_out = exe._run_eager(main, feed, fetch, scope)
    else:
        e_out = _analysis_path(torch, key, exe, main, feed, [v.name for v in fetch], scope,
                               lambda: exe._run_eager(main, feed, fetch, scope))
    differ = {n: float((after[n].double() - scope.find_var(n).double()).abs().max())
              for n in persist if not torch.equal(after[n], scope.find_var(n))}
    fetch_equal = all(np.array_equal(a, b) for a, b in zip(g_out, e_out))
    g_loss, e_loss = float(np.asarray(g_out[0])), float(np.asarray(e_out[0]))
    print(f"{phase} {label}: a replay against an op-by-op step from the same state: loss "
          f"{g_loss!r} / {e_loss!r}; " + "; ".join(
              f"{k} bit-equal {sum(n not in differ for n in ns)} of {len(ns)}"
              for k, ns in kinds.items())
          + f"; all state {len(persist) - len(differ)} of {len(persist)}"
          + (f"; largest differences {sorted(differ.items(), key=lambda kv: -kv[1])[:4]}"
             if differ else "") + f" [{card}]")
    if g_loss != e_loss:
        raise AssertionError(f"{phase} {label}: the replay's loss {g_loss!r} differs from "
                             f"the op-by-op step's {e_loss!r}")
    return {"differ": len(differ), "state": len(persist), "fetch_equal": fetch_equal,
            "max_abs": max(differ.values()) if differ else 0.0}


def _resnet_cell(torch, pt, card, counters, amp):
    """Phase 21 (a) (bf16) or (b) (float32): bench.py's ResNet-50 step at
    batch 128, one CUDA graph replay a step; returns its readings and the
    trained executor, program and scope."""
    label = "bf16" if amp else "float32"
    t0 = time.perf_counter()
    main, startup, loss, acc = _resnet_programs(pt, amp=amp)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _image_feed(torch, RESNET_B, RESNET_HW, RESNET_CLASSES, seed=0, device="cuda")
    fetch = [loss, acc]
    n_ops, by_type = _op_counts(main)
    run_ops = [o.type for o in exe._apply_passes(main, list(feed), [loss.name, acc.name], scope)
               .desc.block(0).ops]
    persist, stats, velocities = _state_names(main, scope)
    flops = 3 * _model_flops(main, RESNET_B)
    print(f"phase 21 ({'a' if amp else 'b'}) ResNet-{RESNET_DEPTH} {label}: {n_ops} ops "
          f"({len(run_ops)} run, {run_ops.count('cast')} casts), {len(stats)} running statistics, "
          f"{len(velocities)} velocities, {flops / 1e12:.3f} TFLOP a step (3 x 2 x MACs of the conv2d "
          f"and mul ops); built and initialized in {time.perf_counter() - t0:.2f} s")
    want_ops = (RESNET_AMP_OPS, RESNET_AMP_CASTS) if amp else (RESNET_OPS, 0)
    if n_ops != RESNET_OPS or (len(run_ops), run_ops.count("cast")) != want_ops \
            or (len(stats), len(velocities)) != (RESNET_BN_STATS, RESNET_VELOCITIES):
        raise AssertionError(f"phase 21 {label}: {n_ops} ops, {len(run_ops)} run with "
                             f"{run_ops.count('cast')} casts, {len(stats)} statistics, "
                             f"{len(velocities)} velocities; want {RESNET_OPS}, {want_ops}, "
                             f"{RESNET_BN_STATS}, {RESNET_VELOCITIES}")
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    # the peak over the capture (its eager run and the graph's pool) and the replays
    torch.cuda.reset_peak_memory_stats()
    info = exe.precompile(main, feed=feed, fetch_list=fetch, scope=scope)
    stats0 = {n: scope.find_var(n).clone() for n in stats}
    losses, step_s = [], []
    for _ in range(CNN_REPLAYS):
        t1 = time.perf_counter()
        lv, _ = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(np.asarray(lv)))
    peak = torch.cuda.max_memory_allocated()
    launches = _launch_snapshot(counters)
    moved = sum(not torch.equal(stats0[n], scope.find_var(n)) for n in stats)
    entries = [e for e in exe.cache_info()["entries"] if "image" in e["feeds"]]
    ips = [RESNET_B / s for s in step_s]
    step_ms = 1e3 * float(np.median(step_s))
    res = {"card": card, "ops": n_ops, "run_ops": len(run_ops), "casts": run_ops.count("cast"),
           "capture_s": info["compile_s"], "losses": losses, "step_ms": [1e3 * s for s in step_s],
           "images_per_s_median": float(np.median(ips)), "images_per_s_min": min(ips),
           "images_per_s_max": max(ips), "peak_allocated_gib": peak / 2 ** 30,
           "tflop_a_step": flops / 1e12,
           "bf16_peak_share": flops / (step_ms / 1e3) / BF16_FLOPS,
           "launches": launches, "statistics_moved": moved}
    print(f"phase 21 {label}: capture {info['compile_s']:.2f} s (kind {info['kind']}); "
          f"{CNN_REPLAYS} replays on one batch: losses {losses}; step ms "
          f"{[round(1e3 * s, 2) for s in step_s]}; images/s median {res['images_per_s_median']:.1f} "
          f"(min {res['images_per_s_min']:.1f}, max {res['images_per_s_max']:.1f}); "
          f"{res['bf16_peak_share']:.4f} of the dense bf16 peak ({BF16_FLOPS / 1e12:.0f} TFLOP/s); "
          f"peak {peak / 2 ** 30:.2f} GiB; {moved} of {len(stats)} running statistics moved; "
          f"hand-written kernel launches {launches} [{card}]")
    if info["kind"] != "graph" or [e["kind"] for e in entries] != ["graph"] \
            or exe.cache_info()["captures"] != 1:
        raise AssertionError(f"phase 21 {label}: the step is not one graph: {info}, {entries}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 21 {label}: losses not finite and falling: {losses}")
    if moved != len(stats) or any(launches.values()):
        raise AssertionError(f"phase 21 {label}: {moved} of {len(stats)} statistics moved, "
                             f"launches {launches} (the CNN path runs no hand-written kernel)")

    # (c) a replay against an op-by-op step from the same state; where
    # cuDNN's default algorithms are not deterministic, again with
    # cudnn.deterministic (a flag of the cache key: a new capture), with the
    # step's images/s that way
    res["replay_vs_eager"] = _state_vs_eager(torch, exe, main, feed, fetch, scope, persist,
                                             {"running statistics": stats,
                                              "velocities": velocities}, label, card,
                                             key=f"resnet50_{label}")
    if res["replay_vs_eager"]["differ"]:
        torch.backends.cudnn.deterministic = True
        try:
            det_s = []
            for _ in range(CNN_REPLAYS):
                t1 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                det_s.append(time.perf_counter() - t1)
            det_ips = [RESNET_B / s for s in det_s[1:]]     # the first is the capture
            res["deterministic"] = {
                "images_per_s_median": float(np.median(det_ips)),
                "images_per_s_min": min(det_ips), "images_per_s_max": max(det_ips),
                "replay_vs_eager": _state_vs_eager(
                    torch, exe, main, feed, fetch, scope, persist,
                    {"running statistics": stats, "velocities": velocities},
                    f"{label} with cudnn.deterministic", card)}
            print(f"phase 21 {label} with cudnn.deterministic: images/s median "
                  f"{res['deterministic']['images_per_s_median']:.1f} (min "
                  f"{min(det_ips):.1f}, max {max(det_ips):.1f}) against "
                  f"{res['images_per_s_median']:.1f} without [{card}]")
        finally:
            torch.backends.cudnn.deterministic = False
        if res["deterministic"]["replay_vs_eager"]["differ"]:
            raise AssertionError(f"phase 21 (c) {label}: the replay differs from the op-by-op "
                                 f"step even with cudnn.deterministic")

    prof = _profile(torch, lambda: [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                                    for _ in range(CNN_PROFILE_STEPS)],
                    f"resnet50_{label}_profile", card,
                    {"batch": [RESNET_B, 3, RESNET_HW, RESNET_HW], "steps": CNN_PROFILE_STEPS})
    if prof is not None:
        res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                               "by_family_ms", "by_family_launches")}
    res["device_by_op"] = _device_trace_step(torch, exe, main, feed, loss, scope,
                                             f"phase 21 {label}", card, need=("conv (cuDNN)",))
    print(json.dumps({f"resnet50_training_{label}": res}))
    return res, exe, main, scope, feed, loss


def _card_vs_cpu(torch, pt, card):
    """Phase 21 (d): ResNet-18 at 32 x 32, batch 8, 10 classes, float32: two
    steps on the card, each against a step on the CPU from the card's state
    before it (the first from the CPU startup's state), and a max-pool
    window of ties."""
    main, startup, loss, acc = _resnet_programs(
        pt, depth=CARD_VS_CPU_DEPTH, hw=CARD_VS_CPU_HW, classes=CARD_VS_CPU_CLASSES)
    feed = _image_feed(torch, CARD_VS_CPU_B, CARD_VS_CPU_HW, CARD_VS_CPU_CLASSES, seed=1,
                       device="cpu")
    cpu_scope, cpu_exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    cpu_exe.run(startup, scope=cpu_scope)
    persist, _, _ = _state_names(main, cpu_scope)
    card_scope, card_exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    card_exe.run(startup, scope=card_scope)
    for n in persist:
        card_scope.find_var(n).copy_(cpu_scope.find_var(n))
    losses, worst, worst_name, loss_rel = {"cpu": [], "card": []}, 0.0, None, 0.0
    # C8's evidence (ROADMAP §C): the worst state tensor's changes, kept,
    # and on a failed gate the card's kernels by name in a replay of the
    # graph both steps ran (cuDNN's convolution algorithms among them)
    worst_changes = None
    for step in range(2):
        before = {n: card_scope.find_var(n).cpu().numpy().copy() for n in persist}
        for n, a in before.items():
            cpu_scope.find_var(n).copy_(torch.from_numpy(a))
        for name, exe, scope in (("cpu", cpu_exe, cpu_scope), ("card", card_exe, card_scope)):
            losses[name].append(float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                                         scope=scope)[0])))
        loss_rel = max(loss_rel, abs(losses["card"][-1] - losses["cpu"][-1]) / abs(losses["cpu"][-1]))
        for n in persist:
            d_cpu = cpu_scope.find_var(n).numpy() - before[n]
            d_card = card_scope.find_var(n).cpu().numpy() - before[n]
            den = np.linalg.norm(d_cpu)
            if den == 0:
                continue
            r = float(np.linalg.norm(d_card - d_cpu) / den)
            if r > worst:
                worst, worst_name, worst_changes = r, f"{n} (step {step + 1})", (d_card, d_cpu)

    # ties: a 3 x 3, stride 2, pad 1 max pool over equal values, and its gradient
    tie_grads = {}
    for name, place in (("cpu", pt.CPUPlace()), ("card", pt.CUDAPlace(0))):
        tmain, tstart = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(tmain, tstart):
            x = pt.layers.data(name="x", shape=[2, 3, 7, 7], dtype="float32",
                               append_batch_size=False, stop_gradient=False)
            y = pt.layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max")
            (gx,) = pt.calc_gradient(pt.layers.reduce_sum(y), [x])
        tie_grads[name] = pt.Executor(place).run(
            tmain, feed={"x": np.ones((2, 3, 7, 7), np.float32)}, fetch_list=[gx],
            scope=pt.Scope())[0]
    ties_equal = bool(np.array_equal(tie_grads["cpu"], tie_grads["card"]))
    res = {"card": card, "losses": losses, "loss_rel": loss_rel, "worst_change_nrel": worst,
           "worst_state": worst_name, "ties_equal": ties_equal,
           "tie_grad_sum": float(tie_grads["card"].sum())}
    print(f"phase 21 (d) ResNet-{CARD_VS_CPU_DEPTH} {CARD_VS_CPU_B} x 3 x {CARD_VS_CPU_HW} x "
          f"{CARD_VS_CPU_HW}, 2 steps on the card, each against the CPU from the card's state "
          f"before it: losses {losses}, loss {loss_rel:.2e} "
          f"(gate {CARD_VS_CPU_LOSS_RTOL}); each state tensor's change, largest norm-relative "
          f"{worst:.2e} ({worst_name}; gate {CARD_VS_CPU_CHANGE_NREL}); max pool over ties: the "
          f"gradients {'bit-equal' if ties_equal else 'DIFFER'} [{card}]")
    if loss_rel > CARD_VS_CPU_LOSS_RTOL or worst > CARD_VS_CPU_CHANGE_NREL or not ties_equal:
        # the second step again from its state: a replay of the same graph
        for n, a in before.items():
            card_scope.find_var(n).copy_(torch.from_numpy(a))
        kernels = {}
        with _card_kernels(torch, kernels):
            card_exe.run(main, feed=feed, fetch_list=[loss], scope=card_scope)
        evidence = c8_evidence(worst_name, worst, *(worst_changes or (None, None)), kernels,
                               _cudnn_flags(torch))
        print(evidence)
        raise AssertionError(f"phase 21 (d): {res}\n{evidence}")
    return res


@contextlib.contextmanager
def _card_kernels(torch, into):
    """Count the card's kernels by name into ``into`` (name -> launches)
    while the block runs."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0)) > 0 \
                and getattr(e, "cpu_time_total", 0) == 0:
            into[e.key] = into.get(e.key, 0) + e.count


def _cudnn_flags(torch):
    c = torch.backends.cudnn
    return {"deterministic": c.deterministic, "benchmark": c.benchmark, "allow_tf32":
            c.allow_tf32, "version": c.version()}


CONV_KERNEL_MARKS = ("conv", "cudnn", "wgrad", "dgrad", "fprop", "winograd", "fft", "implicit")


def c8_evidence(worst_name, worst, d_card, d_cpu, kernels, cudnn_flags):
    """Phase 21 (d)'s evidence when its gate fails (ROADMAP §C, C8): the
    state tensor with the largest change against the CPU's, that change's
    values on both sides, whether ``cudnn.deterministic`` was set, and the
    card's convolution kernels (cuDNN's algorithms) by name and count in a
    replay of the graph both steps ran, from the second step's state."""
    lines = [f"phase 21 (d) evidence: the largest change {worst:.3e} norm-relative is "
             f"{worst_name}; cudnn {cudnn_flags}"]
    if d_card is not None:
        diff = np.abs(d_card - d_cpu)
        i = int(np.argmax(diff))
        lines.append(f"  its change on the card: norm {np.linalg.norm(d_card):.6e}, on the CPU "
                     f"{np.linalg.norm(d_cpu):.6e}; the worst element "
                     f"{tuple(int(j) for j in np.unravel_index(i, diff.shape))}"
                     f": card {d_card.flat[i]:.9e}, CPU {d_cpu.flat[i]:.9e}; first values card "
                     f"{np.round(d_card.ravel()[:4], 9).tolist()}, CPU "
                     f"{np.round(d_cpu.ravel()[:4], 9).tolist()}")
    conv = sorted((k, n) for k, n in kernels.items()
                  if any(m in k.lower() for m in CONV_KERNEL_MARKS))
    lines.append(f"  the card's convolution kernels in the graph of the steps ({len(conv)} "
                 f"names of {len(kernels)} kernels):")
    lines += [f"    {n} x {k}" for k, n in conv]
    return "\n".join(lines)


def _mnist_adam(torch, pt, card, counters):
    """Phase 21 (e): the MNIST CNN (models/mnist.py) with Adam, each step one
    graph replay, K6 once a step inside it."""
    from paddle_tpu_torch.models import mnist
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        image = pt.layers.data(name="pixel", shape=[1, 28, 28], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc = mnist.train_network(image, label)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    images, labels = pt.dataset.mnist._synthetic(MNIST_B, seed=0)
    feed = {"pixel": torch.from_numpy(images.reshape(MNIST_B, 1, 28, 28)).cuda(),
            "label": torch.from_numpy(labels.reshape(MNIST_B, 1).astype(np.int32)).cuda()}
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]))
              for _ in range(MNIST_STEPS)]
    launches = _launch_snapshot(counters)
    entries = [e for e in exe.cache_info()["entries"] if "pixel" in e["feeds"]]
    replay = entries[0]["launches"] if entries else {}
    print(f"phase 21 (e) MNIST CNN + Adam, {MNIST_B} rows, {MNIST_STEPS} steps: losses {losses}; "
          f"launches {launches} (the capture's eager run and {MNIST_STEPS} replays); a replay's "
          f"{replay}; entry kinds {[e['kind'] for e in entries]} [{card}]")
    want = dict.fromkeys(launches, 0, ) | {"fused_adam": MNIST_STEPS + 1}
    if launches != want or [e["kind"] for e in entries] != ["graph"] \
            or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 21 (e): launches {launches} (want {want}), entries "
                             f"{entries}, losses {losses}")
    return {"card": card, "losses": losses, "launches": launches}, launches


def _bn_fold_served(torch, pt, card, main, scope, loss):
    """Phase 21 (f): ``clone(for_test=True)`` of (b)'s trained float32
    ResNet-50, pruned to its logits, served at 8 rows with and without
    ``passes=["bn-fold"]``."""
    blk = main.desc.block(0)
    (logits,) = [o.input("Logits")[0] for o in blk.ops if o.type == "softmax_with_cross_entropy"]
    test = main.clone(for_test=True)._prune([logits])
    rs = np.random.RandomState(2)
    feed = {"image": torch.from_numpy(rs.randn(BN_FOLD_ROWS, 3, RESNET_HW, RESNET_HW)
                                      .astype(np.float32)).cuda()}
    out, walls = {}, {}
    for name, passes in (("unfolded", None), ("bn-fold", ["bn-fold"])):
        exe = pt.Executor(pt.CUDAPlace(0), passes=passes)
        ts = []
        for _ in range(6):
            t0 = time.perf_counter()
            (out[name],) = exe.run(test, feed=feed, fetch_list=[logits], scope=scope)
            ts.append(time.perf_counter() - t0)
        walls[name] = [1e3 * t for t in ts[1:]]
        if name == "bn-fold":
            folded = exe._apply_passes(test, list(feed), [logits], scope)
    n_bn = sum(o.type == "batch_norm" for o in folded.desc.block(0).ops)
    want, got = out["unfolded"], out["bn-fold"]
    atol = BN_FOLD_RTOL * float(np.abs(want).max())
    err = float(np.max(np.abs(got - want) / (atol + BN_FOLD_RTOL * np.abs(want))))
    res = {"card": card, "batch_norm_left": n_bn, "ops": [len(test.desc.block(0).ops),
                                                          len(folded.desc.block(0).ops)],
           "max_abs": float(np.abs(got - want).max()), "gate_ratio": err,
           "batch_ms_unfolded": walls["unfolded"], "batch_ms_folded": walls["bn-fold"]}
    print(f"phase 21 (f) bn-fold served, ResNet-{RESNET_DEPTH} clone(for_test=True), "
          f"{BN_FOLD_ROWS} rows: ops {res['ops'][0]} -> {res['ops'][1]} ({n_bn} batch_norm left); "
          f"logits max abs difference {res['max_abs']:.3e}, {err:.3f} of the gate (rtol "
          f"{BN_FOLD_RTOL}, atol {BN_FOLD_RTOL} x max |logit|); a batch (the first is the "
          f"capture, then replays) unfolded {[round(w, 3) for w in walls['unfolded']]} ms, folded "
          f"{[round(w, 3) for w in walls['bn-fold']]} ms [{card}]")
    if n_bn or err > 1.0:
        raise AssertionError(f"phase 21 (f): {res}")
    return res


def phase_cnn(torch, card):
    """Phase 21 (see the module docstring): the CNN path.  Returns (the
    readings, the MNIST path's launches by kernel)."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {}
    res["a"], exe, main, scope, _, _ = _resnet_cell(torch, pt, card, counters, amp=True)
    del exe, main, scope
    _free_trainer(torch, "phase 21 (a)")
    res["b"], exe, main, scope, _, loss = _resnet_cell(torch, pt, card, counters, amp=False)
    del exe
    _free_trainer(torch, "phase 21 (b)")
    res["f"] = _bn_fold_served(torch, pt, card, main, scope, loss)
    del main, scope
    _free_trainer(torch, "phase 21 (f)")
    res["d"] = _card_vs_cpu(torch, pt, card)
    res["e"], mnist_launches = _mnist_adam(torch, pt, card, counters)
    print(json.dumps({"cnn_path": res}))
    return res, mnist_launches


# ------------------------------------------------------ phase 22: static analysis

EVAL_LOSS_RTOL = 1e-5      # the fused head's loss against softmax + CE
EVAL_REPLAYS = 5           # timed replays of each eval, in turns
BUDGET_FRACTION = 0.9      # (d): the reference step's budget, of its plan
BUDGET_NET = (4096, 4096, 1000)   # (d): the serving net's input, hidden and output widths
BUDGET_BUCKETS = (1, 2, 4, 8)


def _reference_eval(torch, pt, card):
    """Phase 22 (a): phase 20 (a)'s trained model's eval clone at 64 x 256,
    unfused (``Executor()``) and through the seed pipeline
    (``Executor(passes=True, validate="error")``): an eager run of each is
    phase 22's measured run of its program (the peaks), then each is
    captured and replayed in turns (the eval times); the counters set to 0
    just before the fused executor's graph runs and read just after.
    Returns (the readings, the float32 instances' launches, the bf16
    instances', the scope): the float32 eval must run no bf16 instance."""
    ref = PHASE22["ref"]
    main, loss, feed = ref["main"], ref["loss"], ref["feed"]
    test = main.clone(for_test=True)
    scope = pt.Scope()
    pt.Executor(pt.CUDAPlace(0)).run(ref["startup"], scope=scope)
    names = [n for n, v in test.desc.block(0).vars.items()
             if v.persistable and n in ref["state"] and scope.find_var(n) is not None]
    for n in names:
        scope.find_var(n).copy_(ref["state"][n])
    plain = pt.Executor(pt.CUDAPlace(0))
    fused = pt.Executor(pt.CUDAPlace(0), passes=True, validate="error")
    shapes = {k: tuple(np.shape(v)) for k, v in feed.items()}
    ran = fused._apply_passes(test, list(feed), [loss], scope, shapes)
    heads = [o.type for o in ran.desc.block(0).ops].count("fused_fc_softmax_ce")
    left = [o.type for o in ran.desc.block(0).ops].count("softmax_with_cross_entropy")
    print(f"phase 22 (a) the reference eval clone: {len(test.desc.block(0).ops)} ops; "
          f"through the seed pipeline {len(ran.desc.block(0).ops)} ops, {heads} head(s) fused, "
          f"{left} softmax_with_cross_entropy left; {len(names)} parameters from phase 20")
    if heads != 1 or left:
        raise AssertionError(f"phase 22 (a): {heads} fused heads, {left} unfused left")
    (u_eager,) = _analysis_path(torch, "reference_eval_unfused", plain, test, feed, [loss], scope,
                                lambda: plain._run_eager(test, feed, [loss], scope))
    (f_eager,) = _analysis_path(torch, "reference_eval_fused", fused, test, feed, [loss], scope,
                                lambda: fused._run_eager(test, feed, [loss], scope))
    counters = _counters()
    (u_loss,) = plain.run(test, feed=feed, fetch_list=[loss], scope=scope)   # the capture
    # the counts are the fused executor's runs alone: each is counted from
    # its own snapshot (the unfused replays in turns launch K1 and K2 too)
    _zero_counters(counters)
    (f_loss,) = fused.run(test, feed=feed, fetch_list=[loss], scope=scope)   # the capture
    launches, bf16 = _launch_snapshot(counters), _bf16_snapshot(counters)
    walls = {"unfused": [], "fused": []}
    runs = 1
    for _ in range(EVAL_REPLAYS):
        for name, exe in (("unfused", plain), ("fused", fused)):
            before, bf16_before = _launch_snapshot(counters), _bf16_snapshot(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (lv,) = exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
            walls[name].append(1e3 * (time.perf_counter() - t0))
            if name == "fused":
                runs += 1
                after, bf16_after = _launch_snapshot(counters), _bf16_snapshot(counters)
                launches = {k: launches[k] + after[k] - before[k] for k in launches}
                bf16 = {k: bf16[k] + bf16_after[k] - bf16_before[k] for k in bf16}
                if not np.array_equal(lv, f_loss):
                    raise AssertionError("phase 22 (a): a fused replay's loss moved")
    kinds = {n: [e["kind"] for e in exe.cache_info()["entries"] if "lbl" in e["feeds"]]
             for n, exe in (("unfused", plain), ("fused", fused))}
    rel = abs(float(f_loss) - float(u_loss)) / abs(float(u_loss))
    paths = PHASE22["paths"]
    u, f = paths["reference_eval_unfused"], paths["reference_eval_fused"]
    drop = u["measured_bytes"] - f["measured_bytes"]
    logits = TRAIN_B * T * VOCAB * 4
    res = {"card": card, "loss_unfused": float(u_loss), "loss_fused": float(f_loss),
           "loss_rel_diff": rel, "eager_loss_rel_diff":
               abs(float(f_eager) - float(u_eager)) / abs(float(u_eager)),
           "eval_ms": {k: {"median": float(np.median(v)), "all": v} for k, v in walls.items()},
           "peak_bytes": {"unfused": u["measured_bytes"], "fused": f["measured_bytes"]},
           "plan_bytes": {"unfused": u["plan_bytes"], "fused": f["plan_bytes"]},
           "drop_bytes": drop, "logits_and_softmax_bytes": 2 * logits,
           "launches_passes": {k: v for k, v in launches.items() if v},
           "bf16_launches_passes": bf16, "runs": runs, "kinds": kinds}
    print(f"phase 22 (a) eval, 64 x 256, graph replays: loss unfused {float(u_loss)!r}, fused "
          f"{float(f_loss)!r} (relative difference {rel:.3e}, gate {EVAL_LOSS_RTOL}); eval ms "
          f"unfused {res['eval_ms']['unfused']['median']:.2f}, fused "
          f"{res['eval_ms']['fused']['median']:.2f} (medians of {EVAL_REPLAYS} in turns); peak "
          f"unfused {u['measured_bytes'] / 2 ** 30:.3f} GiB, fused "
          f"{f['measured_bytes'] / 2 ** 30:.3f} GiB, lower by {drop / 1e9:.3f} GB (the logits "
          f"and softmax: {2 * logits / 1e9:.3f} GB); launches over the fused executor's {runs} "
          f"runs {res['launches_passes']}, of them the bf16 instances' {bf16}; entry kinds "
          f"{kinds} [{card}]")
    if rel > EVAL_LOSS_RTOL or not np.isfinite([float(u_loss), float(f_loss)]).all():
        raise AssertionError(f"phase 22 (a): fused loss {float(f_loss)} vs {float(u_loss)}")
    want = {"linear_ce_fwd": runs, "flash_attn_fwd": K1_PER_BATCH * runs,
            "gather_rows": K2_PER_BATCH * runs}
    float32 = _delta(launches, bf16)
    if {k: float32[k] for k in want} != want or any(bf16.values()) or \
            kinds != {"unfused": ["graph"], "fused": ["graph"]}:
        raise AssertionError(f"phase 22 (a): launches over {runs} fused runs "
                             f"{res['launches_passes']} (bf16 instances {bf16}), want {want} "
                             f"float32 and no bf16; entry kinds {kinds}")
    if not f["measured_bytes"] < u["measured_bytes"]:
        raise AssertionError(f"phase 22 (a): the fused eval's peak is not the lower one")
    return res, float32, bf16, scope


def _budget_net(pt):
    x = pt.layers.data(name="x", shape=[BUDGET_NET[0]], dtype="float32")
    h = pt.layers.fc(input=x, size=BUDGET_NET[1], act="relu")
    return pt.layers.fc(input=h, size=BUDGET_NET[2], act="softmax")


def _budget_checks(torch, pt, card, scope):
    """Phase 22 (d): the reference step under 0.9 x its plan raises before
    anything is allocated; a ServingSession budget between the plans of
    buckets 2 and 4 drops 4 and 8, and the survivors answer bit-equal to an
    unbudgeted session's; the Trainer's step-0 record in phase 19's
    directory."""
    from paddle_tpu_torch.analysis import PredictedOOMError, plan_memory
    ref = PHASE22["ref"]
    step_plan = PHASE22["paths"]["reference_step"]["plan_bytes"]
    budget = int(BUDGET_FRACTION * step_plan)
    exe = pt.Executor(pt.CUDAPlace(0), memory_budget=budget)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        exe.run(ref["main"], feed=ref["feed"], fetch_list=[ref["loss"]], scope=scope)
        raise AssertionError("phase 22 (d): the reference step ran under 0.9 x its plan")
    except PredictedOOMError as e:
        err = e
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    info = exe.cache_info()
    print(f"phase 22 (d) memory_budget {budget} B (0.9 x the reference step's plan {step_plan} "
          f"B): PredictedOOMError ({err.diagnostic.code} at op#{err.diagnostic.op_index} "
          f"{err.diagnostic.op_type}); memory_allocated {before} -> {after}; cache entries "
          f"{info['executables']}, captures {info['captures']}")
    if after != before or info["executables"] or info["captures"] or             err.plan.peak_bytes != step_plan:
        raise AssertionError(f"phase 22 (d): allocated {before} -> {after}, cache {info}, plan "
                             f"{err.plan.peak_bytes} vs {step_plan}")

    plain = pt.ServingSession(lambda: _budget_net(pt), place=pt.CUDAPlace(0),
                              max_batch_size=8, max_wait_ms=1.0)
    inf = plain.inferencer
    fetch = [v.name for v in inf.predict_vars]
    plans = {}
    for b in BUDGET_BUCKETS:
        shapes = {"x": (b, BUDGET_NET[0])}
        ran = inf.exe._apply_passes(inf.inference_program, ["x"], fetch, inf.scope, shapes)
        plans[b] = plan_memory(ran, fetch_list=fetch, feed_shapes=shapes).peak_bytes
    budget = (plans[2] + plans[4]) // 2
    sess = pt.ServingSession(inferencer=pt.Inferencer(lambda: _budget_net(pt),
                                                      place=pt.CUDAPlace(0)),
                             max_batch_size=8, max_wait_ms=1.0, memory_budget=budget)
    try:
        for n in inf.scope._vars:
            v, w = inf.scope.find_var(n), sess.inferencer.scope.find_var(n)
            if isinstance(v, torch.Tensor) and isinstance(w, torch.Tensor):
                w.copy_(v)
        rejected = [r["batch_size"] for r in sess.warmup_report if r.get("rejected")]
        rs = np.random.RandomState(11)
        equal = []
        for i in range(8):
            x = {"x": rs.rand(1 + i % 2, BUDGET_NET[0]).astype(np.float32)}
            (a,), (b,) = plain.infer(x), sess.infer(x)
            equal.append(bool(np.array_equal(a, b)))
        print(f"phase 22 (d) ServingSession(memory_budget={budget}): bucket plans {plans}; "
              f"rejected {rejected} ({[r['code'] for r in sess.warmup_report if r.get('rejected')]}); "
              f"buckets served {sess.buckets}; 8 one- and two-row requests bit-equal to the "
              f"unbudgeted session's: {sum(equal)} of 8 [{card}]")
        if rejected != [4, 8] or sess.buckets != (1, 2) or not all(equal):
            raise AssertionError(f"phase 22 (d): rejected {rejected}, buckets {sess.buckets}, "
                                 f"bit-equal {equal}")
    finally:
        plain.close()
        sess.close()

    recs = [json.loads(line) for f in sorted(os.listdir(PHASE19["dir"]))
            if f.startswith("memplan_") for line in open(os.path.join(PHASE19["dir"], f))]
    trainer = [r for r in recs if r.get("source") == "trainer"]
    print(f"phase 22 (d) memplan_ records in phase 19's directory: {len(recs)}; the Trainer's "
          f"step-0 plans (source='trainer'): "
          f"{[(r['peak_bytes'], r['peak_op']['type']) for r in trainer]}")
    if not trainer or not all(r["peak_bytes"] > 0 for r in trainer):
        raise AssertionError(f"phase 22 (d): no step-0 memplan_ record from the Trainer")
    return {"rejected_buckets": rejected, "bucket_plans": plans,
            "trainer_plans": [r["peak_bytes"] for r in trainer]}


def phase_analysis(torch, card):
    """Phase 22 (see the module docstring).  Returns the launches of (a)'s
    fused eval runs (``launches_passes``): the float32 instances', the bf16
    instances'."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.analysis import measured, memory
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"phase 22: torch.cuda.get_device_properties(0).total_memory {total} B "
          f"(DEVICE_PROFILES['h100-80gb-hbm3'] reads {memory.H100_TOTAL_MEMORY} B) [{card}]")
    res, launches, bf16, scope = _reference_eval(torch, pt, card)
    res["budget"] = _budget_checks(torch, pt, card, scope)
    del scope
    PHASE22.pop("ref")
    _free_trainer(torch, "phase 22")
    rows, out_of_band = {}, []
    for key, r in PHASE22["paths"].items():
        rows[key] = {k: r[k] for k in ("ops", "counts", "codes", "verify_s", "plan_bytes",
                                       "measured_bytes", "resident_bytes", "transient_bytes",
                                       "ratio", "plan_peak_op", "unsized")}
        print(f"phase 22 (b)-(c) {key}: {r['ops']} ops, verify {r['counts']} by code "
              f"{r['codes']} in {r['verify_s']:.3f} host s; plan {r['plan_bytes'] / 2 ** 30:.3f} GiB "
              f"(peak at op#{r['plan_peak_op'][0]} {r['plan_peak_op'][1]}), measured "
              f"{r['measured_bytes'] / 2 ** 30:.3f} GiB (state {r['resident_bytes'] / 2 ** 30:.3f} + "
              f"run {r['transient_bytes'] / 2 ** 30:.3f}); predicted/measured {r['ratio']:.3f} "
              f"[{card}]")
        if not measured.PLAN_BAND[0] <= r["ratio"] <= measured.PLAN_BAND[1]:
            out_of_band.append(key)
    want = {"serving_float32", "serving_int8", "fused_step_float32", "fused_step_bf16",
            "reference_step", "resnet50_bf16", "resnet50_float32", "reference_eval_unfused",
            "reference_eval_fused"}
    res["paths"] = rows
    print(json.dumps({"analysis": res}))
    if set(rows) != want or any(r["unsized"] for r in rows.values()):
        raise AssertionError(f"phase 22: paths {sorted(rows)}, want {sorted(want)}")
    if out_of_band:
        raise AssertionError(f"phase 22 (c): predicted/measured outside the band "
                             f"{measured.PLAN_BAND}: {out_of_band} (a ratio < 0.5 or > 2 is a "
                             f"planner fault, ROADMAP §C)")
    return launches, bf16


# ------------------------------------------------ phase 23: health and checkpoint

HEALTH_STEPS = 6              # (a)'s epoch, at full width (6+6 layers)
HEALTH_SAVE_EVERY = 2         # CheckpointConfig(step_interval=)
HEALTH_TRIP_STEP = 2          # (c): the weight poisoned before this step (a save boundary)
SENTINEL_RTOL = 1e-4          # the sentinel's scalars against float64 norms of the same step
HEALTH_COST_STEPS = 8         # replays a turn, with and without the sentinel
HEALTH_PROFILE_STEPS = 3      # replays a profile window, with and without the sentinel
# the sentinel's device work by kernel name (torch's multi-tensor functors):
# the shadow copy at the block's head, the group norms, the update pass
SENTINEL_PARTS = (("shadow_copy", ("CopyFunctor", "UnaryOpFunctor")),
                  ("norms", ("LpNormFunctor", "lpnorm_cleanup")),
                  ("update", ("BinaryOpListAlphaFunctor",)))


def _health_trainer(pt, **kw):
    """Phase 7's model (6+6 layers) and Adam as a Trainer on the card."""
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
    with pt.unique_name.guard():
        return pt.Trainer(train_func, lambda: pt.optimizer.Adam(learning_rate=1e-3),
                          place=pt.CUDAPlace(0), **kw)


def _health_feed(pt, trainer, reader, index):
    """The ``index``-th batch of ``reader`` as the Trainer's DataFeeder
    makes it (pow2 buckets)."""
    batch = next(b for i, b in enumerate(reader()) if i == index)
    feed_vars = [trainer.train_program.global_block.var(n) for n in ("src", "trg", "lbl")]
    return pt.DataFeeder(feed_list=feed_vars, program=trainer.train_program,
                         seq_len_buckets="pow2").feed(batch), batch


def _health_entry(exe):
    (entry,) = [e for e in exe._cache.values() if e.graph is not None and e.sentinel_extra
                and "lbl" in e.feeds and e.feeds["lbl"][0][0] == TRAIN_B]
    return entry


def _sentinel_vs_eager(torch, pt, trainer, feed, card):
    """One replay of the step with its sentinel, then the same step op by
    op from the same state (fetching the gradients): the sentinel's loss,
    grad norm, param norm and update norm against float64 sums over the
    replay's state and the eager step's gradients."""
    exe, scope, prog = trainer.exe, trainer.scope, trainer._step_program
    fetch = [v.name for v in trainer.train_outputs]
    entry = _health_entry(exe)
    names, grads = list(entry.param_watch), list(entry.grad_watch)
    before = {n: scope.find_var(n).clone() for n in names}
    tapped, hook = [], exe._health_hook
    exe._health_hook = lambda **kw: (tapped.append(kw["values"]), hook(**kw))
    try:
        (loss,) = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    finally:
        exe._health_hook = hook
    got = [float(np.asarray(v)) for v in tapped[0][1:5]]
    after = {n: scope.find_var(n).clone() for n in names}
    for n, t in before.items():
        scope.find_var(n).copy_(t)
    outs = exe._run_eager(prog, feed=feed, fetch_list=fetch + grads, scope=scope,
                          return_numpy=False)
    for n, t in after.items():
        scope.find_var(n).copy_(t)

    def norm(ts):
        return float(torch.sqrt(sum(t.double().square().sum() for t in ts)))
    want = [float(loss), norm(outs[1:]), norm(after.values()),
            norm(after[n].double() - before[n].double() for n in names)]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    print(f"phase 23 (a) sentinel vs float64 of the same step ({len(grads)} gradients, "
          f"{len(names)} state tensors): loss/grad/param/update {got} vs {want}, relative "
          f"{[f'{r:.2e}' for r in rel]} (gate {SENTINEL_RTOL}); eager loss "
          f"{float(outs[0].float().mean())} [{card}]")
    if not all(r <= SENTINEL_RTOL for r in rel) or float(outs[0].float().mean()) != float(loss):
        raise AssertionError(f"phase 23 (a): sentinel {got} vs {want}")
    return {"sentinel": got, "float64": want, "rel": rel, "grads": len(grads),
            "state_tensors": len(names)}


def _health_cost(torch, pt, trainer, feed, card):
    """The sentinel's cost on the same executor and scope: the step's
    graph with the sentinel (the Trainer's entry) and without (``exe.
    sentinels = ()``: a new entry, captured here), ``HEALTH_COST_STEPS``
    replays a turn in turns (with, without, without, with), tokens/s
    each, every replay fed one batch staged as the Trainer stages its
    feeds (on the card, no pageable copy to wait for); the peak device
    memory above what was allocated before each entry's first run (its
    eager run and capture); and profile windows of each."""
    exe, scope, prog = trainer.exe, trainer.scope, trainer._step_program
    fetch = [v.name for v in trainer.train_outputs]
    sentinels = exe.sentinels
    stager = exe.stage_feeds(prog, [feed])
    staged = next(iter(stager))

    def replay():
        out = exe.run(prog, feed=staged, fetch_list=fetch, scope=scope, sync=False)
        trainer.health.poll()
        return out

    def turn(on):
        exe.sentinels = sentinels if on else ()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HEALTH_COST_STEPS):
            out = replay()
        out[0].numpy()
        torch.cuda.synchronize()
        return TRAIN_B * T * HEALTH_COST_STEPS / (time.perf_counter() - t0)
    try:
        exe.sentinels = ()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        exe.run(prog, feed=staged, fetch_list=fetch, scope=scope)
        peak_off = torch.cuda.max_memory_allocated() - base
        exe.sentinels = sentinels
        exe.run(prog, feed=staged, fetch_list=fetch, scope=scope)     # the entry, warm
        rates = {"with": [], "without": []}
        for on in (True, False, False, True):
            rates["with" if on else "without"].append(turn(on))
        device, windows = {}, {}
        for on in (True, False):
            exe.sentinels = sentinels if on else ()
            key = "with" if on else "without"
            device[key] = _device_by_kernel(torch, replay, HEALTH_PROFILE_STEPS, width=160)
            rec = _profile(torch, lambda: [replay() for _ in range(HEALTH_PROFILE_STEPS)],
                           f"phase23_replays_{key}_the_sentinel", card,
                           {"replays": HEALTH_PROFILE_STEPS})
            if rec is not None:
                windows[key] = {k: rec[k] for k in ("wall_ms", "device_busy_ms",
                                                    "device_idle_share")}
        exe.sentinels = sentinels
        trainer.health.flush()
    finally:
        stager.close()
    out = {"tokens_per_s": rates, "peak_without_bytes": peak_off}
    gap_ms = [1e3 * TRAIN_B * T * (1 / w - 1 / o) for w, o in zip(rates["with"], rates["without"])]
    print(f"phase 23 (a) tokens/s with the sentinel {[round(r) for r in rates['with']]}, "
          f"without {[round(r) for r in rates['without']]} ({HEALTH_COST_STEPS} replays a turn, "
          f"in turns): {[f'{g:.2f}' for g in gap_ms]} ms a step of wall clock; peak above the "
          f"allocated state at the entry's first run without the sentinel "
          f"{peak_off / 2 ** 30:.3f} GiB [{card}]")
    if not device["with"] or not device["without"]:
        print(f"phase 23 (a) the sentinel's device ms a step: not measured (torch.profiler "
              f"recorded no device activity) [{card}]")
        return out
    diff = {n: device["with"].get(n, 0.0) - device["without"].get(n, 0.0)
            for n in set(device["with"]) | set(device["without"])}
    parts = {part: sum(ms for n, ms in diff.items() if any(k in n for k in keys))
             for part, keys in SENTINEL_PARTS}
    parts["other"] = sum(diff.values()) - sum(parts.values())
    total = {k: sum(v.values()) for k, v in device.items()}
    out["device_ms"] = {"with": total["with"], "without": total["without"],
                        "sentinel": total["with"] - total["without"], "parts": parts,
                        "windows": windows}
    top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:8]
    print(f"phase 23 (a) the sentinel's device ms a step ({HEALTH_PROFILE_STEPS} replays a "
          f"window, torch.profiler): with {total['with']:.3f}, without {total['without']:.3f}, "
          f"the difference {total['with'] - total['without']:.3f}: "
          f"{ {k: round(v, 4) for k, v in parts.items()} }; largest differences by kernel "
          f"{[(n[:110], round(ms, 4)) for n, ms in top]}; a window of "
          f"{HEALTH_PROFILE_STEPS} replays (wall, device busy, idle share) {windows} [{card}]")
    return out


def _poison_first_reader(trainer, reader_batch):
    """The weight the step reads first (the source word embedding, read by
    op 0 ``pallas_gather``) and the row of the tripping batch's first
    source token: (name, row, the program op that reads it first)."""
    entry = _health_entry(trainer.exe)
    params = {p.name for p in trainer.train_program.global_block.all_parameters()}
    for i, op in enumerate(entry.block.ops):
        read = [n for n in op.input_names() if n in params]
        if read:
            row = int(np.asarray(reader_batch[0][0]).reshape(-1)[0])
            return read[0], row, (i, op.type)
    raise AssertionError("phase 23 (c): no op reads a parameter")


def _time_saves(manager):
    """(calls, buffers): each ``manager.save`` call's (step, seconds on the
    caller's thread, result), and every pinned buffer its pool hands out."""
    calls, taken = [], []
    save, take = manager.save, manager._pool.take

    def timed(programs, scope, step, **kw):
        t0 = time.perf_counter()
        ok = save(programs, scope, step, **kw)
        calls.append((step, time.perf_counter() - t0, ok))
        return ok

    def counted(dtype, numel):
        taken.append(take(dtype, numel))
        return taken[-1]
    manager.save, manager._pool.take = timed, counted
    return calls, taken


def phase_health(torch, card):
    """Phase 23 (see the module docstring).  Returns the launches a step of
    (a)'s Trainer (``launches_health``): the float32 instances', and the
    bf16 instances' apart (gated at 0)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import faults, health
    from paddle_tpu_torch.checkpoint import (CKPT_RECORDS, CheckpointConfig, checkpoint_dir,
                                             list_steps, manifest, read_manifest,
                                             validate_shards)
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.telemetry import REGISTRY
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "chip_smoke_health")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ckpt = os.path.join(workdir, "ckpt")
    counters = _counters()
    reader = pt.batch(_trainer_samples(HEALTH_STEPS * TRAIN_B, seed=3), TRAIN_B)
    res = {"card": card}
    try:
        # (a) the Trainer with the flight recorder and the async checkpoint
        t0 = time.perf_counter()
        tr = _health_trainer(pt, health=health.HealthConfig(), checkpoint=CheckpointConfig(
            dir=ckpt, step_interval=HEALTH_SAVE_EVERY, epoch_interval=0, keep=2,
            rollback_on_divergence=True))
        print(f"phase 23 (a) trainer built in {time.perf_counter() - t0:.2f} s: sentinels "
              f"{tr.exe.sentinels} [{card}]")
        h0, c0 = len(health.HEALTH_RECORDS.records()), len(CKPT_RECORDS.records())
        save_calls, taken = _time_saves(tr.ckpt_manager)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run, losses = _train_once(tr, reader, counters)
        epoch_s = time.perf_counter() - t0
        peak_on = torch.cuda.max_memory_allocated() - base
        _gate_trainer_steps(run, "phase 23 (a)", PER_STEP,
                            bf16_per_step={k: 0 for k in PER_STEP}, steps=HEALTH_STEPS)
        # the first later step's launches, the float32 and the bf16
        # instances apart (the bf16 ones gated at 0 above)
        (l0, b0, _), (l1, b1, _) = run.after_step[:2]
        bf16_step = {k: b1[k] - b0[k] for k in b1}
        per = {k: l1[k] - l0[k] - bf16_step[k] for k in l1}
        recs = [r for r in health.HEALTH_RECORDS.records()[h0:] if r.get("kind") == "step"]
        events = [r for r in health.HEALTH_RECORDS.records()[h0:] if r.get("kind") == "event"]
        entry = _health_entry(tr.exe)
        print(f"phase 23 (a) {HEALTH_STEPS} pipelined steps in {epoch_s:.2f} s (the capture "
              f"included): losses {losses}; health records "
              f"{[(r['step'], r['ok'], r['grad_norm'], r['param_norm'], r['update_ratio']) for r in recs]}; "
              f"watch {len(entry.sentinel_watch)} bits ({entry.sentinel_watch[:1]} + groups), "
              f"{len(entry.grad_watch)} gradients, {len(entry.param_watch)} state tensors; peak "
              f"above the allocated state at the entry's first run with the sentinel "
              f"{peak_on / 2 ** 30:.3f} GiB [{card}]")
        if len(recs) != HEALTH_STEPS or events or not all(
                r["ok"] and all(np.isfinite(r[k]) for k in ("loss", "grad_norm", "param_norm",
                                                             "update_ratio")) for r in recs):
            raise AssertionError(f"phase 23 (a): health records {recs}, events {events}")
        res["a"] = {"losses": losses, "launches_a_step": per, "epoch_s": epoch_s,
                    "peak_with_bytes": peak_on}

        # (b) the saves: stall on the step, writer seconds, bytes; validate
        saves = [r for r in CKPT_RECORDS.records()[c0:] if r.get("kind") == "save"]
        steps = list_steps(ckpt)
        for s in steps:
            validate_shards(checkpoint_dir(ckpt, s), check_payload=True)
        print(f"phase 23 (b) saves {[(r['step'], r['snapshot_s'], r['save_s'], r['bytes']) for r in saves]} "
              f"(step, snapshot s, writer s, bytes); each save call on the step's thread "
              f"{[(st, round(sec, 6)) for st, sec, _ in save_calls]} s (the stall on the step: "
              f"the snapshot and the manifest's program descs), {len(taken)} pinned buffers "
              f"taken, {len({t.data_ptr() for t in taken})} distinct; committed {steps}, each "
              f"validate_shards clean [{card}]")
        if [r["step"] for r in saves] != [3, 5] or steps != [3, 5]:
            raise AssertionError(f"phase 23 (b): saves {saves}, committed {steps}")
        res["b"] = {"saves": [dict({k: r[k] for k in ("step", "snapshot_s", "save_s", "bytes")},
                                   call_s=sec) for r, (_, sec, _) in zip(saves, save_calls)]}
        first_buffers = {t.data_ptr() for t in taken}
        del save_calls[:], taken[:]
        # a fresh Trainer in a new scope resumes from the step-5 save (after
        # step 4): its step 5 against the uninterrupted run's
        t0 = time.perf_counter()
        resumed = _health_trainer(pt, health=True, checkpoint=CheckpointConfig(
            dir=ckpt, step_interval=0, epoch_interval=0))
        build_s = time.perf_counter() - t0
        if resumed.scope is tr.scope or resumed._ckpt_state != {"epoch_id": 0, "step_id": 5}:
            raise AssertionError(f"phase 23 (b): resume state {resumed._ckpt_state}")
        run_r, loss_r = _train_once(resumed, reader, {})
        print(f"phase 23 (b) a new Trainer resumed at {resumed._ckpt_state} (built and restored "
              f"in {build_s:.2f} s): step 5 loss {loss_r} vs the uninterrupted {losses[5:]} "
              f"({'bit-equal' if loss_r == losses[5:] else 'NOT bit-equal'}) [{card}]")
        if loss_r != losses[5:]:
            raise AssertionError(f"phase 23 (b): resumed {loss_r}, uninterrupted {losses[5:]}")
        res["b"]["resume"] = {"build_s": build_s, "loss": loss_r}
        del resumed, run_r
        _free_trainer(torch, "phase 23 resumed trainer")

        # (c) a trip: a weight poisoned in place before a step at a save boundary
        feed_trip, batch_trip = _health_feed(pt, tr, reader, HEALTH_TRIP_STEP)
        name, row, (op_index, op_type) = _poison_first_reader(tr, batch_trip)
        persist = [v.name for v in tr.train_program.list_vars() if v.persistable]
        addrs = {n: tr.scope.find_var(n).data_ptr() for n in persist}
        compiles = tr.exe.compile_count
        rollbacks = REGISTRY.counter("rollbacks", scope="checkpoint").value
        h0 = len(health.HEALTH_RECORDS.records())
        t_c = time.perf_counter()
        checked = {}

        def poison(trainer):
            trainer.scope.find_var(name)[row, 0] = float("inf")

        def check_restored():
            # before the step after the trip: the rollback has restored the
            # latest committed checkpoint into the scope's tensors
            last = list_steps(ckpt)[-1]
            d = checkpoint_dir(ckpt, last)
            want = [n for n in persist if n == name or n.startswith("fc_0.w_0")]
            arrays = manifest.read_chunks(d, read_manifest(d), want)
            checked["step"] = last
            checked["equal"] = {n: bool(np.array_equal(
                tr.scope.find_var(n).to("cpu", copy=True).numpy(), a))
                for n, a in arrays.items()}
        run_c = _TrainerRun(tr, counters, {HEALTH_TRIP_STEP - 1: poison})

        def handler(ev):
            if type(ev).__name__ == "BeginStepEvent" and ev.step == HEALTH_TRIP_STEP + 1:
                check_restored()
            run_c(ev)
        tr.train(1, handler, reader=reader, feed_order=["src", "trg", "lbl"])
        losses_c = run_c.losses()
        epoch_c_s = time.perf_counter() - t_c
        tr.ckpt_manager.wait()
        saves_c = [r for r in CKPT_RECORDS.records()[c0:] if r.get("kind") == "save"][2:]
        print(f"phase 23 (c) saves after the trip {[(r['step'], r['snapshot_s'], r['save_s']) for r in saves_c]} "
              f"(step, snapshot s, writer s); each save call on the step's thread "
              f"{[(st, round(sec, 6)) for st, sec, _ in save_calls]} s with a pinned buffer "
              f"the writer had released ({len(taken)} taken, all (a)'s: "
              f"{bool(taken) and {t.data_ptr() for t in taken} <= first_buffers}) [{card}]")
        if not saves_c or len(save_calls) != len(saves_c) or not taken or \
                not {t.data_ptr() for t in taken} <= first_buffers:
            raise AssertionError(f"phase 23 (c): saves {saves_c}, calls {save_calls}, "
                                 f"buffers {[t.data_ptr() for t in taken]} vs {first_buffers}")
        res["b"]["saves_reused"] = [dict({k: r[k] for k in ("step", "snapshot_s", "save_s")},
                                         call_s=sec)
                                    for r, (_, sec, _) in zip(saves_c, save_calls)]
        recs = health.HEALTH_RECORDS.records()[h0:]
        trips = [r for r in recs if r.get("event") == "non-finite"]
        steps_ok = [(r["step"], r["ok"]) for r in recs if r.get("kind") == "step"]
        loc = trips[0]["localization"] if trips else None
        n_roll = REGISTRY.counter("rollbacks", scope="checkpoint").value - rollbacks
        moved = [n for n in persist if tr.scope.find_var(n).data_ptr() != addrs[n]]
        print(f"phase 23 (c) {name}[{row}, 0] = inf before step {HEALTH_TRIP_STEP}, the epoch "
              f"in {epoch_c_s:.2f} s (the localization and the rollback included): losses "
              f"{losses_c}; health {steps_ok}; trips {len(trips)}, localization {loc} (the first "
              f"reader of {name}: op {op_index} {op_type}); rollbacks {n_roll}, restored from "
              f"ckpt {checked.get('step')} bit-equal {checked.get('equal')}; compile_count "
              f"{compiles} -> {tr.exe.compile_count}; state tensors moved {len(moved)} [{card}]")
        after = losses_c[HEALTH_TRIP_STEP + 1:]
        if (len(trips) != 1 or not loc or loc.get("op_index") != op_index
                or loc.get("op_type") != op_type or n_roll != 1
                or tr.exe.compile_count != compiles or moved
                or not checked.get("equal") or not all(checked["equal"].values())
                or not after or not all(np.isfinite(after))
                or [ok for _, ok in steps_ok] != [i != HEALTH_TRIP_STEP
                                                  for i in range(HEALTH_STEPS)]):
            raise AssertionError(f"phase 23 (c): trips {trips}, rollbacks {n_roll}, losses "
                                 f"{losses_c}, restored {checked}, moved {moved[:4]}")
        res["c"] = {"weight": name, "row": row, "losses": losses_c, "localization": loc,
                    "epoch_s": epoch_c_s,
                    "first_reader": [op_index, op_type], "rollbacks": n_roll,
                    "restored_from": checked["step"]}

        # (a) the sentinel against float64 of the same step, and its cost:
        # after (c), since the cost's replays train on one batch and would
        # skew the divergence detector's window ahead of (c)'s trip
        t0 = time.perf_counter()
        feed, _ = _health_feed(pt, tr, reader, 0)
        res["a"]["sentinel_vs_eager"] = _sentinel_vs_eager(torch, pt, tr, feed, card)
        res["a"]["cost"] = _health_cost(torch, pt, tr, feed, card)
        print(f"phase 23 (a) the sentinel's check and cost in {time.perf_counter() - t0:.2f} s")
        del tr, run, run_c
        _free_trainer(torch, "phase 23 trainer")

        # (d) FLAGS_check_nan_inf on the card
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            x = pt.layers.data(name="x", shape=[4], dtype="float32")
            z = pt.layers.fill_constant(shape=[4], dtype="float32", value=0.0)
            out = pt.layers.mean(pt.layers.elementwise_div(x, z))
        exe = pt.Executor(pt.CUDAPlace(0))
        FLAGS.check_nan_inf = True
        named = []
        try:
            for _ in range(2):           # the entry's first run, then a replay
                try:
                    exe.run(main, feed={"x": np.zeros((2, 4), np.float32)}, fetch_list=[out])
                except RuntimeError as e:
                    named.append(str(e))
        finally:
            FLAGS.check_nan_inf = False
        kinds = [e["kind"] for e in exe.cache_info()["entries"]]
        print(f"phase 23 (d) FLAGS_check_nan_inf on the card ({kinds}): {named} [{card}]")
        if len(named) != 2 or not all("elementwise_div" in s for s in named):
            raise AssertionError(f"phase 23 (d): {named}")
        res["d"] = {"errors": named, "entries": kinds}

        # (e) a fault plan fails exactly the second served batch
        def infer_func():
            xs = pt.layers.data(name="x", shape=[D_MODEL], dtype="float32")
            return pt.layers.fc(input=xs, size=8)
        sess = pt.ServingSession(infer_func=infer_func, max_batch_size=1, max_wait_ms=0.0,
                                 fault_site="serving.backend.m")
        outcome = []
        try:
            faults.install("fail@serving.backend.m:n=2", seed=0)
            for i in range(4):
                try:
                    (o,) = sess.infer({"x": np.full((1, D_MODEL), i, np.float32)})
                    outcome.append(list(o.shape))
                except faults.FaultInjected as e:
                    outcome.append(f"FaultInjected({e.site})")
            log, counts = faults.fired_log(), faults.counters()
        finally:
            faults.reset()
            sess.close()
        print(f"phase 23 (e) fail@serving.backend.m:n=2 over 4 batches: {outcome}; fired {log}; "
              f"counters {counts} [{card}]")
        if outcome != [[1, 8], "FaultInjected(serving.backend.m)", [1, 8], [1, 8]] or \
                log != [("serving.backend.m", "fail", 2)]:
            raise AssertionError(f"phase 23 (e): {outcome}, {log}")
        res["e"] = {"outcome": outcome}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"health": res}, default=str))
    return per, bf16_step


# ------------------------------------------------------ phase 24: the book models
BOOK_MODELS = ("alexnet", "googlenet", "se_resnext")
# bench.py's image rows (bench_image_model on the accelerator, bench.py:1542):
# batch 128 at 224 x 224, 1,000 classes, Momentum(0.01, 0.9), enable_amp
BOOK_B, BOOK_HW, BOOK_CLASSES = 128, 224, 1000
BOOK_REPLAYS = 6
BOOK_PROFILE_STEPS = 2
K40M_MS = {"alexnet": 334.0, "googlenet": 1149.0}     # bench.py:2067, the K40m rows
# ops, and ops and casts after amp-bf16 (tests/test_torch_book_models.py)
BOOK_OPS = {"alexnet": (85, 120, 35), "googlenet": (546, 862, 316),
            "se_resnext": (874, 1473, 599)}
SE_GROUPED = 16                 # SE-ResNeXt-50's grouped 3x3s (cardinality 32)
SERVE_ROWS = 8                  # (c): one batch through Inferencer
# (d): one float32 step of each model at a small image size (the smallest
# its pools take; rows, classes) on the card and on the CPU from the same
# parameters (AlexNet, GoogLeNet with is_test=True, SE-ResNeXt with
# dropout_prob=0.0: dropout draws never agree), all the gradients as one
# vector.  AlexNet and GoogLeNet: the card within BOOK_CARD_VS_CPU_NREL of
# the CPU (an H100's readings against float64 before this gate, AlexNet at
# 4 rows: the card 5.0e-6 and 1.0e-6, the CPU 4.1e-7 and 6.0e-7).  At 32 x
# 32 SE-ResNeXt's last stage is 1 x 1 and its batch_norm over 2 values
# degenerate (float32 and float64 10 % apart on the loss); at 64 x 64 its
# fifty training batch_norms put both
# float32 runs ~1e-2 from float64 (tests/test_torch_book_models.py), so it
# is held against the port on the CPU in float64 from the same state (the
# witness): the card's distance from it at most BOOK_WITNESS_FACTOR x the
# float32 CPU's + BOOK_WITNESS_FLOOR.  The loss within BOOK_LOSS_RTOL of the
# float32 CPU's.
BOOK_SMALL = {"alexnet": (64, 5, 2), "googlenet": (64, 5, 2), "se_resnext": (64, 10, 2)}
BOOK_CARD_VS_CPU_NREL = 1e-4
BOOK_WITNESS_FACTOR = 4.0
BOOK_WITNESS_FLOOR = 1e-5
BOOK_LOSS_RTOL = 1e-4
FIT_STEPS, FIT_B = 30, 32       # (e) fit_a_line: SGD(0.05) on uci_housing's reader
# (f): ModelAverage(0.5, min 2, max 4) over an Adam MLP, the averages against
# a float64 host witness of the window's mean (the parameters after each
# step, the windows emulated): float32 sums of a few float32 values
MA_STEPS, MA_WINDOW = 8, (0.5, 2, 4)
MA_RTOL = 1e-6
QAT_STEPS, QAT_WINDOW = 5, 3
# (g) the float ops on the card against the CPU, relative to the largest
# value (TF32 off; other summation orders)
BOOK_OP_RTOL = 1e-5


def _book_programs(pt, name, hw=BOOK_HW, classes=BOOK_CLASSES, amp=True, small=False):
    """bench.py's ``bench_image_model`` program for ``name`` (SE-ResNeXt-50
    with the same recipe); ``small``: the parity step of
    tests/test_torch_book_models.py (no dropout draws)."""
    from paddle_tpu_torch import models
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        image = pt.layers.data(name="image", shape=[3, hw, hw], dtype="float32")
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        if small and name == "se_resnext":
            pred = models.se_resnext.se_resnext(image, class_dim=classes, dropout_prob=0.0)
            loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
            acc = pt.layers.accuracy(input=pred, label=label)
        else:
            loss, acc = getattr(models, name).train_network(image, label, class_dim=classes,
                                                            **({"is_test": True} if small else {}))
        pt.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    if amp:
        pt.amp.enable_amp(main)
    return main, startup, loss, acc


def _book_feed(torch, rows, hw, classes, seed, device="cuda"):
    """bench.py's feed: uniform images in [0, 1) and int32 labels."""
    rng = np.random.default_rng(seed)
    image = rng.random((rows, 3, hw, hw), dtype=np.float32)
    label = rng.integers(0, classes, (rows, 1)).astype(np.int32)
    if device == "cpu":
        return {"image": image, "label": label}
    return {"image": torch.from_numpy(image).to(device), "label": torch.from_numpy(label).to(device)}


def _timed_replays(exe, main, feed, fetch, scope, n):
    """``n`` runs of ``main`` (replays of its graph once captured): the
    first fetch of each as a float, and each run's wall seconds."""
    losses, step_s = [], []
    for _ in range(n):
        t1 = time.perf_counter()
        lv = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)[0]
        step_s.append(time.perf_counter() - t1)
        losses.append(float(np.asarray(lv)))
    return losses, step_s


def _book_cell(torch, pt, card, counters, name):
    """Phase 24 (a)-(c): bench.py's row for ``name`` at batch 128, one CUDA
    graph replay a step.  Returns its readings and the trained executor,
    programs and scope."""
    t0 = time.perf_counter()
    main, startup, loss, acc = _book_programs(pt, name)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _book_feed(torch, BOOK_B, BOOK_HW, BOOK_CLASSES, seed=0)
    fetch = [loss, acc]
    run_prog = exe._apply_passes(main, list(feed), [loss.name, acc.name], scope)
    run_ops = run_prog.desc.block(0).ops
    types = [o.type for o in run_ops]
    n_ops = len(main.desc.block(0).ops)
    flops = 3 * _model_flops(main, BOOK_B)
    print(f"phase 24 {name}: {n_ops} ops ({len(types)} run, {types.count('cast')} casts), "
          f"{flops / 1e12:.3f} TFLOP a step (3 x 2 x MACs of the conv2d and mul ops); built and "
          f"initialized in {time.perf_counter() - t0:.2f} s")
    if (n_ops, len(types), types.count("cast")) != BOOK_OPS[name]:
        raise AssertionError(f"phase 24 {name}: {n_ops} ops, {len(types)} run, "
                             f"{types.count('cast')} casts; want {BOOK_OPS[name]}")
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    info = exe.precompile(main, feed=feed, fetch_list=fetch, scope=scope)
    losses, step_s = _timed_replays(exe, main, feed, fetch, scope, BOOK_REPLAYS)
    peak = torch.cuda.max_memory_allocated()
    launches = _launch_snapshot(counters)
    entries = [e for e in exe.cache_info()["entries"] if "image" in e["feeds"]]
    ips = [BOOK_B / s for s in step_s]
    step_ms = 1e3 * float(np.median(step_s))
    res = {"card": card, "ops": n_ops, "run_ops": len(types), "casts": types.count("cast"),
           "capture_s": info["compile_s"], "losses": losses, "step_ms": [1e3 * s for s in step_s],
           "step_ms_median": step_ms, "images_per_s_median": float(np.median(ips)),
           "images_per_s_min": min(ips), "images_per_s_max": max(ips),
           "peak_allocated_gib": peak / 2 ** 30, "tflop_a_step": flops / 1e12,
           "bf16_peak_share": flops / (step_ms / 1e3) / BF16_FLOPS, "launches": launches}
    if name in K40M_MS:
        res["k40m_ms"] = K40M_MS[name]
        res["k40m_ratio"] = K40M_MS[name] / step_ms
    print(f"phase 24 {name} bf16: capture {info['compile_s']:.2f} s (kind {info['kind']}); "
          f"{BOOK_REPLAYS} replays on one batch: losses {losses}; step ms "
          f"{[round(1e3 * s, 2) for s in step_s]}; images/s median "
          f"{res['images_per_s_median']:.1f} (min {res['images_per_s_min']:.1f}, max "
          f"{res['images_per_s_max']:.1f}); {res['bf16_peak_share']:.4f} of the dense bf16 peak; "
          f"peak {peak / 2 ** 30:.2f} GiB; hand-written kernel launches {launches}"
          + (f"; {step_ms:.1f} ms/batch bs={BOOK_B} (reference K40m: {K40M_MS[name]:.0f} "
             f"ms/batch -> {res['k40m_ratio']:.1f}x)" if name in K40M_MS else "") + f" [{card}]")
    if info["kind"] != "graph" or [e["kind"] for e in entries] != ["graph"] \
            or exe.cache_info()["captures"] != 1:
        raise AssertionError(f"phase 24 {name}: the step is not one graph: {info}, {entries}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 24 {name}: losses not finite and falling: {losses}")
    if any(launches.values()):
        raise AssertionError(f"phase 24 {name}: launches {launches} (the image models run no "
                             f"hand-written kernel)")
    prof = _profile(torch, lambda: [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                                    for _ in range(BOOK_PROFILE_STEPS)],
                    f"book_{name}_profile", card,
                    {"batch": [BOOK_B, 3, BOOK_HW, BOOK_HW], "steps": BOOK_PROFILE_STEPS})
    if prof is not None:
        res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                               "by_family_ms", "by_family_launches")}
    by_index = {}
    res["device_by_op"] = _device_trace_step(torch, exe, main, feed, loss, scope,
                                             f"phase 24 {name}", card, need=("conv (cuDNN)",),
                                             by_index=by_index)
    for k in ("lrn", "lrn_grad", "conv2d", "conv2d_grad", "mul", "mul_grad", "cast"):
        res[f"device_ms_{k}"] = res["device_by_op"]["device_ms_by_op_type"].get(k, 0.0)
    if name == "se_resnext":
        grouped = {str(i) for i, o in enumerate(run_ops)
                   if o.type in ("conv2d", "conv2d_grad") and o.attr("groups", 1) == 32}
        ms = sum(v for k, v in by_index.items() if k.split(":")[0] in grouped)
        res["grouped_conv"] = {"ops": len(grouped), "device_ms": ms,
                               "share": ms / res["device_by_op"]["device_ms"]}
        print(f"phase 24 se_resnext: the grouped 3x3s ({len(grouped)} ops, forward and grad) "
              f"{ms:.2f} device ms of the eager step's {res['device_by_op']['device_ms']:.2f} "
              f"({res['grouped_conv']['share']:.3f}) [{card}]")
        if len(grouped) != 2 * SE_GROUPED or not ms > 0:
            raise AssertionError(f"phase 24 (c): grouped convolutions {res['grouped_conv']}")
    print(json.dumps({f"book_{name}_bf16": res}))
    return res, exe, main, scope, loss


def _book_serve(torch, pt, card, exe, main, scope, loss):
    """Phase 24 (c): the trained SE-ResNeXt-50's eval clone (float32, its
    softmax output) exported with ``save_inference_model`` and one batch of
    8 served through ``Inferencer(param_path=)``, against the eval clone
    run by the trainer's executor on the same parameters."""
    from paddle_tpu_torch.models import se_resnext
    (pred,) = [o.input("X")[0] for o in main.desc.block(0).ops if o.type == "cross_entropy"]
    test = pt.amp.disable_amp(main.clone(for_test=True)._prune([pred]))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_se_resnext_")
    try:
        with pt.scope_guard(scope):
            pt.io.save_inference_model(workdir, ["image"], [test.global_block.var(pred)], exe,
                                       test, export_compiled=False)

        def infer_func():
            image = pt.layers.data(name="image", shape=[3, BOOK_HW, BOOK_HW], dtype="float32")
            return se_resnext.se_resnext(image, class_dim=BOOK_CLASSES, is_test=True)
        t0 = time.perf_counter()
        inf = pt.Inferencer(infer_func, param_path=workdir, place=pt.CUDAPlace(0))
        load_s = time.perf_counter() - t0
        feed = _book_feed(torch, SERVE_ROWS, BOOK_HW, BOOK_CLASSES, seed=3)
        (want,) = exe.run(test, feed={"image": feed["image"]}, fetch_list=[pred], scope=scope)
        walls = []
        for _ in range(3):
            t1 = time.perf_counter()
            (got,) = inf.infer({"image": feed["image"]})
            walls.append(1e3 * (time.perf_counter() - t1))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    res = {"card": card, "rows": SERVE_ROWS, "load_s": load_s, "batch_ms": walls,
           "max_abs": err, "bit_equal": bool(np.array_equal(got, want)),
           "rows_sum_to_one": float(np.abs(got.sum(-1) - 1).max())}
    print(f"phase 24 (c) SE-ResNeXt-50 exported and served through Inferencer(param_path=), "
          f"{SERVE_ROWS} rows: against the trainer's eval clone on the same parameters max abs "
          f"{err:.3e} ({'bit-equal' if res['bit_equal'] else 'not bit-equal'}); batch ms "
          f"{[round(w, 2) for w in walls]} (the first the capture); loaded in {load_s:.2f} s "
          f"[{card}]")
    if got.shape != (SERVE_ROWS, BOOK_CLASSES) or err > BOOK_OP_RTOL \
            or res["rows_sum_to_one"] > 1e-4:
        raise AssertionError(f"phase 24 (c): {res}")
    return res


def _grad_vector(outs):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in outs])


def _card_cpu_witness(torch, pt, main, startup, feed, fetch, witness=None):
    """One float32 step of ``main`` on the card and on the CPU from the CPU
    startup's state.  With ``witness`` (a tuple of feed names), also the
    witness: the same step on the CPU in float64 from the same state, the
    feeds ``witness`` names read from its scope as float64 (a feed is
    narrowed to float32).  Returns the card's, the CPU's and the witness's
    fetches (None without one), and the card's executor and scope."""
    cpu_scope, cpu = pt.Scope(), pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    persist = [v.name for v in main.list_vars()
               if v.persistable and cpu_scope.find_var(v.name) is not None]
    state = {n: cpu_scope.find_var(n).numpy().copy() for n in persist}
    card_scope, card_exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    card_exe.run(startup, scope=card_scope)
    for n, a in state.items():
        card_scope.find_var(n).copy_(torch.from_numpy(a))
    got = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    ref = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    wit = None
    if witness is not None:
        w_scope = pt.Scope()
        pt.params_from_numpy({n: a.astype(np.float64) if a.dtype == np.float32 else a
                              for n, a in state.items()}, w_scope, "cpu")
        for n in witness:
            w_scope.set_var(n, torch.from_numpy(feed[n].astype(np.float64)))
        wit = pt.Executor(pt.CPUPlace()).run(
            main, feed={k: v for k, v in feed.items() if k not in witness}, fetch_list=fetch,
            scope=w_scope)
    return got, ref, wit, card_exe, card_scope


def _witness_gate(got, ref, wit):
    """The card's and the float32 CPU's gradients (fetches 1 on), as one
    vector, norm-relative to the witness's; the card's at most
    BOOK_WITNESS_FACTOR x the CPU's + BOOK_WITNESS_FLOOR.  Returns the
    readings and whether they pass."""
    w = _grad_vector(wit[1:])
    gv = {k: float(np.linalg.norm(_grad_vector(g[1:]) - w) / np.linalg.norm(w))
          for k, g in (("card", got), ("cpu_float32", ref))}
    dtype = str(np.asarray(wit[1]).dtype)
    ok = dtype == "float64" and \
        gv["card"] <= BOOK_WITNESS_FACTOR * gv["cpu_float32"] + BOOK_WITNESS_FLOOR
    return {"witness_dtype": dtype, "grads_vs_float64": gv}, ok


def _witness_text(gv):
    return (f"against float64: card {gv['card']:.3e}, CPU float32 {gv['cpu_float32']:.3e} "
            f"(gate {BOOK_WITNESS_FACTOR} x CPU + {BOOK_WITNESS_FLOOR})")


def _book_card_vs_cpu(torch, pt, card):
    """Phase 24 (d): one float32 step of each model at a small image size on
    the card and on the CPU from the same parameters; SE-ResNeXt's also
    against the float64 witness on the CPU."""
    res = {}
    for name in BOOK_MODELS:
        t0 = time.perf_counter()
        hw, classes, rows = BOOK_SMALL[name]
        main, startup, loss, _ = _book_programs(pt, name, hw, classes, amp=False, small=True)
        params = [p.name for p in main.global_block.all_parameters()
                  if main.desc.block(0).find_var(p.name + "@GRAD") is not None]
        fetch = [loss.name] + [p + "@GRAD" for p in params]
        feed = _book_feed(torch, rows, hw, classes, seed=5, device="cpu")
        got, ref, wit, card_exe, card_scope = _card_cpu_witness(
            torch, pt, main, startup, feed, fetch,
            witness=("image",) if name == "se_resnext" else None)
        g_card, g_cpu = _grad_vector(got[1:]), _grad_vector(ref[1:])
        loss_rel = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
        r = {"image": [rows, 3, hw, hw], "losses": [float(got[0]), float(ref[0])],
             "loss_rel": loss_rel,
             "grads_card_vs_cpu": float(np.linalg.norm(g_card - g_cpu) / np.linalg.norm(g_cpu))}
        ok = loss_rel <= BOOK_LOSS_RTOL
        if wit is not None:
            r["losses"].append(float(wit[0]))
            w_rec, w_ok = _witness_gate(got, ref, wit)
            r.update(w_rec)
            ok = ok and w_ok
            gate = _witness_text(r["grads_vs_float64"])
        else:
            ok = ok and r["grads_card_vs_cpu"] <= BOOK_CARD_VS_CPU_NREL
            gate = f"gate {BOOK_CARD_VS_CPU_NREL}"
        r["seconds"] = time.perf_counter() - t0
        res[name] = r
        print(f"phase 24 (d) {name} {rows} x 3 x {hw} x {hw}, one float32 step: losses card / CPU"
              f"{' / float64' if wit is not None else ''} {r['losses']} ({loss_rel:.2e}, gate "
              f"{BOOK_LOSS_RTOL}); {len(params)} gradients as one vector, card against CPU "
              f"{r['grads_card_vs_cpu']:.3e}, {gate}; {r['seconds']:.1f} s [{card}]")
        if not ok:
            raise AssertionError(f"phase 24 (d) {name}: {r}")
        del card_exe, card_scope
        gc.collect()
    return res


def _fit_a_line_programs(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        y_predict = pt.layers.fc(input=x, size=1)
        avg_cost = pt.layers.mean(pt.layers.square_error_cost(input=y_predict, label=y))
        pt.optimizer.SGD(learning_rate=0.05).minimize(avg_cost)
    return main, startup, avg_cost


def _fit_a_line(torch, pt, card, counters):
    """Phase 24 (e): fit_a_line with SGD on the synthetic uci_housing
    reader's batches, each step one replay with K5 inside."""
    main, startup, loss = _fit_a_line_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    reader = pt.reader.batch(pt.dataset.uci_housing.train(), FIT_B, drop_last=True)
    feeds = []
    while len(feeds) < FIT_STEPS:
        for rows in reader():
            feeds.append({"x": np.stack([r[0] for r in rows]), "y": np.stack([r[1] for r in rows])})
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]))
              for f in feeds[:FIT_STEPS]]
    launches = _launch_snapshot(counters)
    entries = [e for e in exe.cache_info()["entries"] if "x" in e["feeds"]]
    replay = entries[0]["launches"] if entries else {}
    res = {"card": card, "losses": losses, "launches": launches, "replay_launches": replay}
    print(f"phase 24 (e) fit_a_line, SGD(0.05), {FIT_STEPS} steps of {FIT_B} uci_housing rows: "
          f"losses {[round(v, 4) for v in losses]}; launches {launches} (the capture's eager run "
          f"and {FIT_STEPS} replays); a replay's {replay}; entry kinds "
          f"{[e['kind'] for e in entries]} [{card}]")
    want = dict.fromkeys(launches, 0) | {"fused_sgd": FIT_STEPS + 1}
    if launches != want or [e["kind"] for e in entries] != ["graph"] \
            or not np.isfinite(losses).all() or not (15.0 < losses[0] and losses[-1] < 0.1):
        raise AssertionError(f"phase 24 (e): {res}")
    return res, launches


def _ma_witness(snapshots, rate, min_w, max_w):
    """The window's mean on the host in float64 from the parameter after
    each step: ``average_accumulates``' rule (no spill within the steps)."""
    s12 = s3 = 0.0
    n_acc = n_old = n_upd = 0
    for p in snapshots:
        n_upd += 1
        n_acc += 1
        s12 = s12 + p
        if n_acc >= min_w and n_acc >= min(float(max_w), np.float32(n_upd) * np.float32(rate)):
            s3, s12, n_old, n_acc = s12, 0.0, n_acc, 0
    return (s12 + s3) / max(n_acc + n_old, 1)


def _model_average(torch, pt, card, counters):
    """Phase 24 (f): ModelAverage over an Adam step replayed as one graph
    (K6 once a step, ``average_accumulates`` inside the graph), ``apply()``
    and its restore without a new capture, and a QAT step with the range
    quantizer in its graph."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        h = pt.layers.fc(input=x, size=64, act="relu")
        loss = pt.layers.mean(pt.layers.square_error_cost(input=pt.layers.fc(input=h, size=1),
                                                          label=y))
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
        ma = pt.optimizer.ModelAverage(MA_WINDOW[0], min_average_window=MA_WINDOW[1],
                                       max_average_window=MA_WINDOW[2])
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    xs, ys = pt.dataset.uci_housing._synthetic(FIT_B, seed=0)
    feed = {"x": torch.from_numpy(xs).cuda(), "y": torch.from_numpy(ys).cuda()}
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    snaps = {p.name: [] for p in ma.params}
    for _ in range(MA_STEPS):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        for p in ma.params:
            snaps[p.name].append(scope.find_var(p.name).double().cpu().numpy())
    launches = _launch_snapshot(counters)
    persist = [v.name for v in main.list_vars() if v.persistable]
    n_upd = {int(scope.find_var(v.name).cpu()[0]) for v in ma._accumulators["num_updates"].values()}
    captures = exe.cache_info()["captures"]
    ptrs = {n: scope.find_var(n).data_ptr() for n in persist}
    state0 = {n: scope.find_var(n).clone() for n in persist}
    with pt.scope_guard(scope):
        with ma.apply(exe):
            applied = {p.name: scope.find_var(p.name).double().cpu().numpy() for p in ma.params}
    restored = all(torch.equal(scope.find_var(n), state0[n]) for n in persist)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after_apply = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    continues = all(torch.equal(scope.find_var(n), after_apply[n]) for n in persist)
    errs = {}
    for p in ma.params:
        w = _ma_witness(snaps[p.name], *MA_WINDOW)
        errs[p.name] = float(np.abs(applied[p.name] - w).max() / np.abs(w).max())
    res = {"card": card, "launches": launches, "num_updates": sorted(n_upd),
           "average_vs_float64": errs, "restored_bit_equal": restored,
           "next_replay_bit_equal": continues,
           "captures": [captures, exe.cache_info()["captures"]],
           "addresses_kept": ptrs == {n: scope.find_var(n).data_ptr() for n in persist}}
    print(f"phase 24 (f) ModelAverage{MA_WINDOW} over Adam, {MA_STEPS} replays: launches "
          f"{launches}; num_updates {sorted(n_upd)}; averages against the float64 witness, "
          f"largest relative {max(errs.values()):.2e} (gate {MA_RTOL}); apply()/restore: "
          f"restored bit-equal {restored}, the next replay bit-equal to one without apply "
          f"{continues}, captures {res['captures']}, every tensor at its address "
          f"{res['addresses_kept']} [{card}]")
    want = dict.fromkeys(launches, 0) | {"fused_adam": MA_STEPS + 1}
    if launches != want or n_upd != {MA_STEPS} or max(errs.values()) > MA_RTOL or not restored \
            or not continues or res["captures"] != [1, 1] or not res["addresses_kept"]:
        raise AssertionError(f"phase 24 (f): {res}")
    res["qat"], qat_launches = _qat_step(torch, pt, card, counters)
    return res, {k: launches[k] + qat_launches[k] for k in launches}


def _qat_step(torch, pt, card, counters):
    """Phase 24 (f): a QAT step (``fake_quantize_range_abs_max`` on an fc
    output, dequantized, SGD) replayed on the card against the CPU from the
    same parameters: ``Iter`` and the window advance inside the graph."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[13], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="float32")
        h = pt.layers.fc(input=x, size=8)
        q, s = pt.layers.fake_quantize_range_abs_max(h, bit_length=8, window_size=QAT_WINDOW)
        deq = pt.layers.fake_dequantize_max_abs(q, s, max_range=127.0)
        loss = pt.layers.mean(pt.layers.square_error_cost(
            input=pt.layers.fc(input=deq, size=1), label=y))
        pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    (op,) = [o for o in main.desc.block(0).ops if o.type == "fake_quantize_range_abs_max"]
    buf, it = op.input("InScales")[0], op.input("Iter")[0]
    cpu_scope, cpu = pt.Scope(), pt.Executor(pt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    card_scope, card_exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    card_exe.run(startup, scope=card_scope)
    for v in main.list_vars():
        if v.persistable and cpu_scope.find_var(v.name) is not None:
            card_scope.find_var(v.name).copy_(cpu_scope.find_var(v.name))
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    windows, worst = [], 0.0
    for step in range(QAT_STEPS):
        xs, ys = pt.dataset.uci_housing._synthetic(FIT_B, seed=10 + step)
        feed = {"x": xs * (1 + step % 3), "y": ys}
        card_exe.run(main, feed=feed, fetch_list=[loss], scope=card_scope)
        cpu.run(main, feed=feed, fetch_list=[loss], scope=cpu_scope)
        a, b = card_scope.find_var(buf).cpu().numpy(), cpu_scope.find_var(buf).numpy()
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
        windows.append(a.tolist())
    launches = _launch_snapshot(counters)
    iters = (int(card_scope.find_var(it).cpu()), int(cpu_scope.find_var(it)))
    res = {"card": card, "windows": windows, "iter": iters, "window_vs_cpu": worst,
           "launches": launches, "captures": card_exe.cache_info()["captures"]}
    print(f"phase 24 (f) QAT, the range quantizer (window {QAT_WINDOW}) in the SGD step's graph, "
          f"{QAT_STEPS} replays: Iter card / CPU {iters}; the window after each step {windows}; "
          f"against the CPU {worst:.2e} (gate {BOOK_OP_RTOL}); launches {launches}; captures "
          f"{res['captures']} [{card}]")
    want = dict.fromkeys(launches, 0) | {"fused_sgd": QAT_STEPS + 1}
    if iters != (QAT_STEPS, QAT_STEPS) or worst > BOOK_OP_RTOL or launches != want \
            or res["captures"] != 1 or not all(np.count_nonzero(w) == min(i + 1, QAT_WINDOW)
                                               for i, w in enumerate(windows)):
        raise AssertionError(f"phase 24 (f) QAT: {res}")
    return res, launches


def _book_ops_programs(pt):
    """Phase 24 (g): every op of the slice in two programs over seeded
    feeds: (the ops' program, the update rules' program, the feeds, the
    names to fetch whose values are exact, the names held within
    BOOK_OP_RTOL)."""
    L = pt.layers
    rs = np.random.RandomState(24)
    feeds = {"x": rs.randn(4, 16, 9, 9).astype(np.float32) * 2,
             "w": rs.randn(16, 8, 3, 3).astype(np.float32) * 0.2,
             "u": rs.randn(6, 8).astype(np.float32) * 3,
             "v": (rs.rand(6, 8).astype(np.float32) + 0.5) * np.where(rs.rand(6, 8) < 0.5, -1, 1)
             .astype(np.float32),
             "a": rs.randint(-20, 20, (6, 8)).astype(np.int32),
             "b": (rs.randint(1, 6, (6, 8)) * np.where(rs.rand(6, 8) < 0.5, -1, 1)).astype(np.int32),
             "idx": np.array([5, 0, -1, 3, 2], np.int32),
             "ids": np.array([[0], [7], [3], [-1], [9], [2]], np.int64)}
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        xs = {n: L.data(name=n, shape=list(a.shape), dtype=str(a.dtype), append_batch_size=False,
                        stop_gradient=a.dtype != np.float32) for n, a in feeds.items()}
        helper = pt.layer_helper.LayerHelper("book_ops")

        def op(op_type, ins, attrs=None, outs=("Out",), dtype="float32"):
            o = {s: helper.create_variable_for_type_inference(dtype) for s in outs}
            helper.append_op(op_type, inputs=ins, outputs=o, attrs=attrs or {})
            return o[outs[0]]
        x, u, v, a, b = (xs[n] for n in "xuvab")
        exact = [L.flatten(x, axis=2), L.stack([u, v], axis=1),
                 L.squeeze(L.unsqueeze(u, axes=[0, 2]), axes=[0]), L.gather(u, xs["idx"]),
                 op("slice", {"Input": x}, {"axes": [1, 3], "starts": [2, -4], "ends": [100, -1]}),
                 L.expand(u, [2, 3]), L.pad(u, [1, 0, 2, 1], pad_value=0.5),
                 L.one_hot(xs["ids"], depth=8), L.argmax(u, axis=1), L.argmin(u, axis=0),
                 L.assign_value([1.5, -2.0, 3.0, 4.0], [2, 2]),
                 op("elementwise_mod", {"X": a, "Y": b}, {"axis": -1}, dtype="int32"),
                 op("elementwise_floordiv", {"X": a, "Y": b}, {"axis": -1}, dtype="int32"),
                 op("elementwise_mod", {"X": u, "Y": v}, {"axis": -1}),
                 op("elementwise_floordiv", {"X": u, "Y": v}, {"axis": -1}),
                 op("isfinite", {"X": u}, dtype="bool")]
        close = [L.lrn(x, n=5, alpha=0.05, beta=0.75),
                 op("conv2d_transpose", {"Input": x, "Filter": xs["w"]},
                    {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]},
                    outs=("Output",)),
                 L.cos_sim(u, v), op("squared_l2_distance", {"X": u, "Y": v},
                                     outs=("Out", "sub_result"))]
        parts = [L.reduce_sum(t) for t in close + exact[1:4] + exact[5:7]]
        target = parts[0]
        for t in parts[1:]:
            target = L.elementwise_add(target, t)
        close += pt.calc_gradient(target, [x, u, v, xs["w"]])
    # the proximal rules, their outputs named apart from their inputs
    rmain, rstart = pt.Program(), pt.Program()
    rfeeds = {"param": rs.randn(16, 8).astype(np.float32), "grad": rs.randn(16, 8).astype(np.float32),
              "lr": np.array([0.4], np.float32),
              "moment": np.abs(rs.randn(16, 8)).astype(np.float32)}
    with pt.unique_name.guard(), pt.program_guard(rmain, rstart):
        r = {n: L.data(name=n, shape=list(a.shape), dtype="float32", append_batch_size=False)
             for n, a in rfeeds.items()}
        helper = pt.layer_helper.LayerHelper("book_rules")
        rules = []
        for op_type, state, attrs in (("proximal_gd", (), {"l1": 0.3, "l2": 0.1}),
                                      ("proximal_adagrad", ("Moment",), {"l1": 0.1, "l2": 0.2})):
            ins = {"Param": r["param"], "Grad": r["grad"], "LearningRate": r["lr"]}
            outs = {"ParamOut": helper.create_variable_for_type_inference("float32")}
            for s_ in state:
                ins[s_] = r["moment"]
                outs[s_ + "Out"] = helper.create_variable_for_type_inference("float32")
            helper.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
            rules += list(outs.values())
    return main, rmain, feeds, rfeeds, [t.name for t in exact], [t.name for t in close], \
        [t.name for t in rules]


def _book_ops(torch, pt, card):
    """Phase 24 (g): each op of the slice once on the card against its
    result on the CPU."""
    main, rmain, feeds, rfeeds, exact, close, rules = _book_ops_programs(pt)
    out = {}
    for place, key in ((pt.CUDAPlace(0), "card"), (pt.CPUPlace(), "cpu")):
        exe = pt.Executor(place)
        out[key] = [np.asarray(t) for t in exe.run(main, feed=feeds, fetch_list=exact + close,
                                                    scope=pt.Scope())]
        out[key] += [np.asarray(t) for t in exe.run(rmain, feed=rfeeds, fetch_list=rules,
                                                     scope=pt.Scope())]
    names = exact + close + rules
    n_exact = len(exact)
    differ, worst = [], 0.0
    for i, (n, g, c) in enumerate(zip(names, out["card"], out["cpu"])):
        if g.shape != c.shape or g.dtype != c.dtype:
            differ.append(f"{n}: {g.shape} {g.dtype} / {c.shape} {c.dtype}")
        elif n_exact <= i < n_exact + len(close):
            scale = max(float(np.abs(c).max()), 1e-30)
            e = float(np.abs(g.astype(np.float64) - c).max() / scale)
            worst = max(worst, e)
            if e > BOOK_OP_RTOL:
                differ.append(f"{n}: {e:.2e}")
        elif not np.array_equal(g, c, equal_nan=g.dtype.kind == "f"):
            differ.append(f"{n}: not bit-equal")
    res = {"card": card, "exact": len(exact) + len(rules), "close": len(close),
           "close_worst_rel": worst, "differ": differ}
    print(f"phase 24 (g) each op of the slice on the card against the CPU: {res['exact']} "
          f"outputs bit-equal (shape ops, gather, one_hot, arg_max/arg_min, assign_value, "
          f"integer and float mod and floor division, isfinite, proximal_gd, "
          f"proximal_adagrad), {len(close)} within {BOOK_OP_RTOL} of the largest value (lrn, "
          f"conv2d_transpose, cos_sim, squared_l2_distance and the gradients of x, u, v, w): "
          f"largest {worst:.2e}; differing {differ} [{card}]")
    if differ:
        raise AssertionError(f"phase 24 (g): {differ}")
    return res


def phase_book(torch, card):
    """Phase 24 (see the module docstring): the book models and what the
    training path left.  Returns phase 24's launches by kernel (K5 and K6
    on (e) and (f); the image models launch none)."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {}
    t_piece = time.perf_counter()
    for part, name in zip("abc", BOOK_MODELS):
        res[name], exe, main, scope, loss = _book_cell(torch, pt, card, counters, name)
        if name == "se_resnext":
            res["serve"] = _book_serve(torch, pt, card, exe, main, scope, loss)
        del exe, main, scope
        _free_trainer(torch, f"phase 24 {name}")
        t_piece = _piece_seconds(f"phase 24 ({part})", t_piece)
    res["card_vs_cpu"] = _book_card_vs_cpu(torch, pt, card)
    t_piece = _piece_seconds("phase 24 (d)", t_piece)
    res["fit_a_line"], fit_launches = _fit_a_line(torch, pt, card, counters)
    res["model_average"], ma_launches = _model_average(torch, pt, card, counters)
    res["ops"] = _book_ops(torch, pt, card)
    _piece_seconds("phase 24 (e)-(g)", t_piece)
    launches = {k: fit_launches[k] + ma_launches[k] for k in fit_launches}
    print(json.dumps({"book_models": res}))
    return launches


# bench.py's LSTM row (bench_lstm on the accelerator, bench.py:1510-1539):
# stacked_lstm.train_network at batch 64, seq 80, dict 30,000, emb 128,
# hidden 256, stacked_num=2, Adam(0.002), enable_amp; lengths in [40, 80]
LSTM_B, LSTM_T, LSTM_DICT, LSTM_EMB, LSTM_HID, LSTM_STACK = 64, 80, 30000, 128, 256, 2
LSTM_LR = 0.002
LSTM_REPLAYS = 6
LSTM_PROFILE_STEPS = 2
K40M_LSTM_MS = 83.0          # bench.py:1511, BASELINE.md's LSTM row
# the step's op types (tests/test_torch_lstm_models.py): 47 ops, 78 after
# amp-bf16 (31 casts); on the card the kernel tier retypes the table's
# gather and scatter (K2, K3) and 5 of the 11 updates (all 11 in one K6)
LSTM_OPS = (47, 78, 31)
LSTM_PER_STEP = {"gather_rows": 1, "scatter_add_rows": 1, "fused_adam": 1}
# of those, the bf16 instances: the table's gradient is scattered into its
# bf16 copy, so the float32 K3 runs 0 times a step
LSTM_BF16_PER_STEP = {"scatter_add_rows": 1}
# (a)'s kernels at the step's shapes, before its replays: K2 on the [30000,
# 128] float32 table at the feed's 5,120 ids, bit-equal to its plain version
# and to F.embedding; the bf16 K3 into the table's bf16 copy at those ids
# (its rows seeded bf16 values), bit-equal to its plain version run on the
# CPU (float32 index_add_ in ascending n, then bf16 once; on the card
# index_add_ adds by atomics); K6 over the step's 11 updates in their op
# types, from the first step's state and gradients, bit-equal to the plain
# versions.
# (a)'s bf16 step against its float32 twin, one step op by op from the
# same state and feed: the loss within LSTM_BF16_LOSS_RTOL
# (tests/test_torch_lstm_models.py's BF16_LOSS_RTOL); the 11 gradients as
# one vector at most BF16_STEP_GLOBAL_NREL norm-relative (phase 14's gate);
# each gradient's norm within LSTM_BF16_GRAD_NORM_RTOL of the float32 one's
LSTM_BF16_LOSS_RTOL = 1e-3
LSTM_BF16_GRAD_NORM_RTOL = 0.1
# (b): the Trainer's first step against one op-by-op step of its program
# on the same padded batch from the Trainer's initial state
LSTM_TRAINER_LOSS_RTOL = 1e-6
# (b): the Trainer on the synthetic imdb reader (its 5,148-word dict), the
# samples sorted by length and cut into batches of 64, LSTM_TRAINER_STEPS
# batches for each pow2 bucket of their longest review (8-63 words)
LSTM_TRAINER_BUCKETS = (16, 32, 64)
LSTM_TRAINER_STEPS = 3
# (c): machine translation's train_network (the JAX package's widths, word
# and hidden 32, dicts of 10,000, batch 64, source and target up to 32) and
# the sentiment convolution net (the reference book model's emb 128, hid
# 512 and Adagrad(0.002), notest_understand_sentiment.py; a batch of 64 of
# the sentiment reader's 8-40 words):
# one float32 step on the card and on the CPU from the same state, each
# against the port on the CPU in float64 (the witness; TF32 off), under
# phase 24 (d)'s gates (BOOK_WITNESS_FACTOR, BOOK_WITNESS_FLOOR,
# BOOK_LOSS_RTOL); then SEQ_STEPS steps on the card, the losses finite and
# falling
SEQ_MT = dict(src_dict_size=10000, trg_dict_size=10000, word_dim=32, hidden_dim=32)
SEQ_MT_T = 32
SEQ_SENT = dict(emb=128, hid=512, t=40, dict_dim=600, lr=0.002)
SEQ_STEPS = 3


def _lstm_programs(pt, amp=True, dict_dim=LSTM_DICT):
    """bench.py's ``bench_lstm`` program (``amp``: through ``enable_amp``)."""
    from paddle_tpu_torch.models import stacked_lstm
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        data = pt.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc = stacked_lstm.train_network(data, label, dict_dim=dict_dim, emb_dim=LSTM_EMB,
                                               hid_dim=LSTM_HID, stacked_num=LSTM_STACK)
        pt.optimizer.Adam(learning_rate=LSTM_LR).minimize(loss)
    if amp:
        pt.amp.enable_amp(main)
    return main, startup, loss, acc


def _lstm_feed(torch, seed):
    """bench.py's feed: int32 ids, lengths in [T/2, T], labels, on the card."""
    rng = np.random.default_rng(seed)
    feed = {"words": rng.integers(0, LSTM_DICT, (LSTM_B, LSTM_T, 1)).astype(np.int32),
            "words@SEQ_LEN": rng.integers(LSTM_T // 2, LSTM_T + 1, (LSTM_B,)).astype(np.int32),
            "label": rng.integers(0, 2, (LSTM_B, 1)).astype(np.int32)}
    return {k: torch.from_numpy(v).to("cuda") for k, v in feed.items()}


def _lstm_kernels(torch, run_prog, state0, feed, grads, card):
    """(a)'s kernels on the card at the step's shapes (see LSTM_BF16_PER_STEP's
    note), each against its plain version; ``grads`` the first bf16 step's
    gradients by parameter.  Returns each kernel's largest absolute error."""
    from paddle_tpu_torch.ops.cuda.embedding import (gather_rows, gather_rows_plain,
                                                     scatter_add_rows, scatter_add_rows_plain)
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam_multi, fused_adam_multi_plain
    bf = torch.bfloat16
    ops = run_prog.desc.block(0).ops
    (gather,) = [o for o in ops if o.type == "pallas_gather"]
    table = state0[gather.input("W")[0]]
    ids = feed["words"].reshape(-1).contiguous()
    out, ref = gather_rows(table, ids), gather_rows_plain(table, ids)
    lib = torch.nn.functional.embedding(ids.long(), table)
    errs = {"gather_rows": (out - ref).abs().max().item()}
    ok = {"gather_rows": torch.equal(out, ref) and torch.equal(out, lib)}
    g = torch.Generator().manual_seed(25)
    rows = (1e-3 * torch.randn(ids.numel(), table.shape[1], generator=g)).to(bf)
    w = table.to(bf)
    got = scatter_add_rows(w, ids, rows.to("cuda"))
    want = scatter_add_rows_plain(w.cpu(), ids.cpu(), rows)
    errs["scatter_add_rows_bf16"] = (got.cpu().float() - want.float()).abs().max().item()
    ok["scatter_add_rows_bf16"] = got.dtype == bf and torch.equal(got.cpu(), want)
    ups = [o for o in ops if o.type in ("adam", "pallas_adam")]
    hyper = {(o.attr("beta1"), o.attr("beta2"), o.attr("epsilon")) for o in ups}
    if len(hyper) != 1:
        raise AssertionError(f"phase 25 (a): the updates' betas and epsilon differ: {hyper}")
    ((b1, b2, eps),) = hyper
    entries = [(state0[o.input("Param")[0]].clone(),
                torch.as_tensor(np.asarray(grads[o.input("Param")[0]])).to("cuda", torch.float32),
                state0[o.input("Moment1")[0]].clone(), state0[o.input("Moment2")[0]].clone(),
                state0[o.input("Beta1Pow")[0]], state0[o.input("Beta2Pow")[0]],
                state0[o.input("LearningRate")[0]], o.type == "pallas_adam") for o in ups]
    mine = fused_adam_multi([_adam_clones(e) for e in entries], b1, b2, eps)
    theirs = fused_adam_multi_plain([_adam_clones(e) for e in entries], b1, b2, eps)
    pairs = [(x, y) for a, b in zip(mine, theirs) for x, y in zip(a, b)]
    errs["fused_adam"] = _max_abs_diff(torch, pairs)
    ok["fused_adam"] = all(torch.equal(x, y) for x, y in pairs)
    torch.cuda.synchronize()
    print(f"phase 25 (a) kernels at the step's shapes against their plain versions: K2 "
          f"[{table.shape[0]},{table.shape[1]}] float32 at {ids.numel()} ids (and "
          f"F.embedding), bf16 K3 into its bf16 copy (plain on the CPU), K6 over "
          f"{len(entries)} updates ({sum(e[7] for e in entries)} pallas_adam): bit-equal "
          f"{ok}; max abs err {errs} [{card}]")
    if not all(ok.values()):
        raise AssertionError(f"phase 25 (a): a kernel differs from its plain version: {ok}, "
                             f"{errs}")
    return errs


def _lstm_bf16_vs_float32(torch, exe, runs, feed, scope, state0, params, card):
    """(a)'s bf16 step against its float32 twin: one step of each of
    ``runs`` ("bf16" and "float32": program and loss) op by op from
    ``state0`` (copied back after each), under LSTM_BF16_LOSS_RTOL,
    BF16_STEP_GLOBAL_NREL and LSTM_BF16_GRAD_NORM_RTOL.  Returns the
    readings and the bf16 step's gradients by parameter."""
    outs = {}
    for who, (prog, loss) in runs.items():
        outs[who] = exe._run_eager(prog, feed, [loss.name] + [p + "@GRAD" for p in params],
                                   scope)
        for n, t in state0.items():
            scope.find_var(n).copy_(t)
    b, f = ([np.asarray(a, np.float64) for a in outs[w]] for w in ("bf16", "float32"))
    loss_rel = abs(float(b[0]) - float(f[0])) / abs(float(f[0]))
    glob = float(np.linalg.norm(_grad_vector(b[1:]) - _grad_vector(f[1:]))
                 / np.linalg.norm(_grad_vector(f[1:])))
    norms = {p: float(np.linalg.norm(x) / np.linalg.norm(y) - 1.0)
             for p, x, y in zip(params, b[1:], f[1:])}
    res = {"losses_bf16_float32": [float(b[0]), float(f[0])], "loss_rel": loss_rel,
           "grads_nrel": glob, "grad_norm_rel_diff": norms}
    print(f"phase 25 (a) one step op by op from the same state, bf16 against float32: losses "
          f"{res['losses_bf16_float32']} ({loss_rel:.3e} relative, gate {LSTM_BF16_LOSS_RTOL}); "
          f"{len(params)} gradients as one vector {glob:.4e} norm-relative (gate "
          f"{BF16_STEP_GLOBAL_NREL}); each gradient's norm over the float32 one's, less 1 "
          f"(gate {LSTM_BF16_GRAD_NORM_RTOL}) {json.dumps({k: round(v, 5) for k, v in norms.items()})} "
          f"[{card}]")
    if not (np.isfinite(_grad_vector(b)).all() and loss_rel <= LSTM_BF16_LOSS_RTOL
            and glob <= BF16_STEP_GLOBAL_NREL
            and all(abs(v) <= LSTM_BF16_GRAD_NORM_RTOL for v in norms.values())):
        raise AssertionError(f"phase 25 (a): the bf16 step is outside the gates of its float32 "
                             f"twin: {res}")
    return res, dict(zip(params, outs["bf16"][1:]))


def _lstm_cell(torch, pt, card, counters):
    """Phase 25 (a): bench.py's LSTM step at 64 x 80, bf16, one CUDA graph
    replay a step; its kernels at the step's shapes against their plain
    versions; the step against its float32 twin from the same state and
    feed, op by op, and the twin's replays."""
    t0 = time.perf_counter()
    main, startup, loss, acc = _lstm_programs(pt)
    main32, startup32, loss32, acc32 = _lstm_programs(pt, amp=False)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    persist = [v.name for v in main.list_vars() if v.persistable and scope.find_var(v.name)
               is not None]
    params = [p.name for p in main.global_block.all_parameters()]
    state0 = {n: scope.find_var(n).clone() for n in persist}
    feed = _lstm_feed(torch, seed=0)
    fetch = [loss, acc]
    run_prog = exe._apply_passes(main, list(feed), [loss.name, acc.name], scope)
    types = [o.type for o in run_prog.desc.block(0).ops]
    n_ops = len(main.desc.block(0).ops)
    got_ops = (n_ops, len(types), types.count("cast"))
    kinds = {k: types.count(k) for k in ("dynamic_lstm", "dynamic_lstm_grad", "pallas_gather",
                                         "pallas_scatter_add", "pallas_adam", "adam")}
    print(f"phase 25 (a) stacked LSTM {LSTM_B} x {LSTM_T}, dict {LSTM_DICT}, emb {LSTM_EMB}, "
          f"hidden {LSTM_HID} x {LSTM_STACK}: {n_ops} ops ({len(types)} run, {types.count('cast')} "
          f"casts; {kinds}); {len(params)} parameters; built and initialized in "
          f"{time.perf_counter() - t0:.2f} s")
    if got_ops != LSTM_OPS or kinds != {"dynamic_lstm": 2, "dynamic_lstm_grad": 2,
                                        "pallas_gather": 1, "pallas_scatter_add": 1,
                                        "pallas_adam": 5, "adam": 6}:
        raise AssertionError(f"phase 25 (a): ops {got_ops}, {kinds}; want {LSTM_OPS}")
    vs32, grads = _lstm_bf16_vs_float32(
        torch, exe, {"bf16": (main, loss), "float32": (main32, loss32)}, feed, scope, state0,
        params, card)
    kernel_errs = _lstm_kernels(torch, run_prog, state0, feed, grads, card)
    del grads
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    info = exe.precompile(main, feed=feed, fetch_list=fetch, scope=scope)
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "bf16_launches"):
            f.bf16_launches = 0
    losses, step_s = _timed_replays(exe, main, feed, fetch, scope, LSTM_REPLAYS)
    launches, bf16 = _launch_snapshot(counters), _bf16_snapshot(counters)
    # the step's own peak: over what earlier phases still hold
    peak = torch.cuda.max_memory_allocated() - base
    entries = [e for e in exe.cache_info()["entries"] if "words" in e["feeds"]]
    step_ms = 1e3 * float(np.median(step_s))
    res = {"card": card, "ops": n_ops, "run_ops": len(types), "casts": types.count("cast"),
           "capture_s": info["compile_s"], "losses": losses, "step_ms": [1e3 * s for s in step_s],
           "step_ms_median": step_ms, "step_ms_min": 1e3 * min(step_s),
           "step_ms_max": 1e3 * max(step_s), "k40m_ms": K40M_LSTM_MS,
           "k40m_ratio": K40M_LSTM_MS / step_ms,
           "padded_tokens_per_s": LSTM_B * LSTM_T / (step_ms / 1e3),
           "peak_over_base_gib": peak / 2 ** 30, "launches": launches, "bf16_launches": bf16,
           "kernel_max_abs_err": kernel_errs, "bf16_vs_float32": vs32}
    print(f"phase 25 (a) bf16: capture {info['compile_s']:.2f} s (kind {info['kind']}); "
          f"{LSTM_REPLAYS} replays on one batch: losses {losses}; step ms "
          f"{[round(1e3 * s, 3) for s in step_s]}; median {step_ms:.3f} ms/batch bs={LSTM_B} "
          f"(reference K40m: {K40M_LSTM_MS:.0f} ms/batch -> {res['k40m_ratio']:.2f}x); "
          f"{res['padded_tokens_per_s']:.0f} padded tokens/s; peak {peak / 2 ** 30:.3f} GiB over "
          f"what was allocated before; "
          f"hand-written kernel launches {launches} (bf16 instances {bf16}) [{card}]")
    if info["kind"] != "graph" or [e["kind"] for e in entries] != ["graph"] \
            or exe.cache_info()["captures"] != 1:
        raise AssertionError(f"phase 25 (a): the step is not one graph: {info}, {entries}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 25 (a): losses not finite and falling: {losses}")
    want = {k: LSTM_REPLAYS * v for k, v in LSTM_PER_STEP.items()}
    want_bf16 = {k: LSTM_REPLAYS * LSTM_BF16_PER_STEP.get(k, 0) for k in bf16}
    if {k: launches[k] for k in want} != want or bf16 != want_bf16 or \
            any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"phase 25 (a): launches {launches}, bf16 instances {bf16}; want "
                             f"{want}, bf16 {LSTM_BF16_PER_STEP} a replay")
    prof = _profile(torch, lambda: [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                                    for _ in range(LSTM_PROFILE_STEPS)],
                    "lstm_bf16_profile", card,
                    {"batch": [LSTM_B, LSTM_T], "steps": LSTM_PROFILE_STEPS},
                    warm=lambda: exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
    if prof is None:
        raise AssertionError("phase 25 (a): the profiler recorded no device activity; the "
                             "per-step kernel gates read it")
    res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                           "by_family_ms", "by_family_launches",
                                           "warm_records")}
    fams = prof["by_family_launches"]
    # K3 is two kernels a call (the sort and the segment sums)
    want = {"gather_rows (K2)": 1, "scatter_add_rows (K3)": 2, "fused_adam (K6)": 1}
    got = {k: fams.get(k, 0) for k in want}
    if got != {k: LSTM_PROFILE_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"phase 25 (a): the profile's kernels {got}, want {want} a "
                             f"replay")
    n_dev = sum(fams.values())
    res["profile"]["device_operations_a_step"] = n_dev / LSTM_PROFILE_STEPS
    print(f"phase 25 (a) profile of {LSTM_PROFILE_STEPS} replays behind a warm-up replay: "
          f"idle share {prof['device_idle_share']:.4f}, {n_dev / LSTM_PROFILE_STEPS:.0f} "
          f"device operations a step (the warm-up replay's records "
          f"{prof['warm_records']}) [{card}]")
    moments = [n for n in persist if "_moment" in n]
    res["replay_vs_eager"] = _state_vs_eager(
        torch, exe, main, feed, fetch, scope, persist,
        {"parameters": params, "moments": moments}, "bf16 stacked LSTM", card,
        phase="phase 25 (a)")
    if res["replay_vs_eager"]["differ"] or not res["replay_vs_eager"]["fetch_equal"]:
        raise AssertionError(f"phase 25 (a): the replay differs from the op-by-op step: "
                             f"{res['replay_vs_eager']}")
    res["device_by_op"] = _device_trace_step(
        torch, exe, main, feed, loss, scope, "phase 25 lstm bf16", card,
        need=("gather_rows (K2)", "scatter_add_rows (K3)", "fused_adam (K6)"), warm=True)
    by_type = res["device_by_op"]["device_ms_by_op_type"]
    res["recurrence_device_ms"] = by_type.get("dynamic_lstm", 0.0) + \
        by_type.get("dynamic_lstm_grad", 0.0)
    del exe
    _free_trainer(torch, "phase 25 (a) bf16")

    # the float32 twin's replays from the same state and feed (TF32 off)
    scope32, exe32 = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe32.run(startup32, scope=scope32)
    for n, t in state0.items():
        scope32.find_var(n).copy_(t)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    info32 = exe32.precompile(main32, feed=feed, fetch_list=[loss32, acc32], scope=scope32)
    losses32, step32 = _timed_replays(exe32, main32, feed, [loss32, acc32], scope32,
                                      LSTM_REPLAYS)
    ms32 = 1e3 * float(np.median(step32))
    res["float32"] = {"capture_s": info32["compile_s"], "losses": losses32,
                      "step_ms": [1e3 * s for s in step32], "step_ms_median": ms32,
                      "peak_over_base_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                      "first_loss_bf16_vs_float32": abs(losses[0] - losses32[0]) / abs(losses32[0])}
    print(f"phase 25 (a) float32 twin (TF32 off), from the same state and feed: capture "
          f"{info32['compile_s']:.2f} s; losses {losses32}; step ms "
          f"{[round(1e3 * s, 3) for s in step32]}, median {ms32:.3f} ({ms32 / step_ms:.2f}x the "
          f"bf16 step's); the first replay's loss bf16 {losses[0]!r} vs float32 "
          f"{losses32[0]!r}: {res['float32']['first_loss_bf16_vs_float32']:.3e} relative (gate "
          f"{LSTM_BF16_LOSS_RTOL}) [{card}]")
    if info32["kind"] != "graph" or not np.isfinite(losses32).all() \
            or res["float32"]["first_loss_bf16_vs_float32"] > LSTM_BF16_LOSS_RTOL:
        raise AssertionError(f"phase 25 (a) float32: {info32}, losses {losses32}")
    del exe32, scope32, state0
    _free_trainer(torch, "phase 25 (a) float32")
    return res


def _imdb_bucket_reader(pt):
    """(b)'s reader: the imdb samples sorted by length, cut into batches of
    LSTM_B, LSTM_TRAINER_STEPS batches for each bucket in order."""
    samples = sorted(pt.dataset.imdb.train()(), key=lambda s: len(s[0]))
    batches = [samples[i:i + LSTM_B] for i in range(0, len(samples) - LSTM_B + 1, LSTM_B)]
    chosen = []
    for b in LSTM_TRAINER_BUCKETS:
        inb = [x for x in batches if 1 << (max(len(s[0]) for s in x) - 1).bit_length() == b]
        chosen += inb[:LSTM_TRAINER_STEPS]
    flat = [s for x in chosen for s in x]
    return (lambda: iter(flat)), [sum(len(s[0]) for s in x) for x in chosen]


def _trainer_first_step(torch, pt, trainer, batch, card):
    """(b)'s control: one op-by-op step of the Trainer's program on
    ``batch`` as the Trainer pads it (pow2 buckets), from the Trainer's
    initial state copied into a scope of its own.  Returns its loss."""
    program = trainer.train_program
    scope = pt.Scope()
    for v in program.list_vars():
        t = trainer.scope.find_var(v.name) if v.persistable else None
        if t is not None:
            scope.set_var(v.name, t.clone())
    feeder = pt.DataFeeder(feed_list=[program.global_block.var(n) for n in ("words", "label")],
                           program=program, seq_len_buckets="pow2")
    exe = pt.Executor(pt.CUDAPlace(0), amp=pt.amp.AmpConfig())
    (loss,) = exe._run_eager(program, feeder.feed(batch), [trainer.loss.name], scope)
    del exe, scope
    return float(np.asarray(loss))


def _lstm_trainer(torch, pt, card, counters):
    """Phase 25 (b): an epoch of the same net (bf16, the imdb dict) through
    ``Trainer`` on the synthetic imdb reader, one capture a bucket, then a
    warm epoch of replays; the first step's loss against one op-by-op step
    from the same state on the same batch."""
    dict_dim = len(pt.dataset.imdb.word_dict())

    def train_func():
        from paddle_tpu_torch.models import stacked_lstm
        data = pt.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        return stacked_lstm.train_network(data, label, dict_dim=dict_dim, emb_dim=LSTM_EMB,
                                          hid_dim=LSTM_HID, stacked_num=LSTM_STACK)[0]
    with pt.unique_name.guard():
        trainer = pt.Trainer(train_func, lambda: pt.optimizer.Adam(learning_rate=LSTM_LR),
                             place=pt.CUDAPlace(0), amp=pt.amp.AmpConfig())
    reader, real_tokens = _imdb_bucket_reader(pt)
    batched = pt.batch(reader, LSTM_B)
    n_steps = len(LSTM_TRAINER_BUCKETS) * LSTM_TRAINER_STEPS
    ctl_loss = _trainer_first_step(torch, pt, trainer, next(iter(batched())), card)
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "bf16_launches"):
            f.bf16_launches = 0
    run = _TrainerRun(trainer, counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(1, run, reader=batched, feed_order=["words", "label"])
    losses = run.losses()
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    captures = [c for _, _, c in run.after_step]
    # the warm epoch: every bucket's graph replays
    run2 = _TrainerRun(trainer, counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(1, run2, reader=batched, feed_order=["words", "label"])
    losses2 = run2.losses()
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches, bf16 = _launch_snapshot(counters), _bf16_snapshot(counters)
    first_rel = abs(losses[0] - ctl_loss) / abs(ctl_loss)
    padded = sum(LSTM_B * b * LSTM_TRAINER_STEPS for b in LSTM_TRAINER_BUCKETS)
    res = {"card": card, "steps": n_steps, "buckets": list(LSTM_TRAINER_BUCKETS),
           "captures_after_each_step": captures, "epoch_s_with_captures": wall1,
           "warm_epoch_s": wall2, "real_tokens": sum(real_tokens), "padded_tokens": padded,
           "real_tokens_per_s": sum(real_tokens) / wall2, "padded_tokens_per_s": padded / wall2,
           "losses": losses, "warm_losses": losses2, "first_loss_op_by_op": ctl_loss,
           "first_loss_rel": first_rel, "launches": launches, "bf16_launches": bf16}
    print(f"phase 25 (b) Trainer(amp=AmpConfig()) on the synthetic imdb reader (dict "
          f"{dict_dim}), {n_steps} steps in buckets {list(LSTM_TRAINER_BUCKETS)}: captures after "
          f"each step {captures}; the epoch with its captures {wall1:.2f} s; the warm epoch "
          f"{wall2:.3f} s, {res['real_tokens_per_s']:.0f} real tokens/s "
          f"({res['padded_tokens_per_s']:.0f} padded); losses of the first epoch {losses}, of "
          f"the warm epoch {losses2} (the reader's classes part by word ids); the first step's "
          f"loss {losses[0]!r} against one op-by-op step from the same state on the same batch "
          f"{ctl_loss!r} ({first_rel:.3e} relative, gate {LSTM_TRAINER_LOSS_RTOL}); launches "
          f"{launches} (bf16 instances {bf16}) [{card}]")
    if captures[-1] != len(LSTM_TRAINER_BUCKETS) or len(losses) != n_steps \
            or trainer.exe.cache_info()["captures"] != len(LSTM_TRAINER_BUCKETS):
        raise AssertionError(f"phase 25 (b): captures {captures}, "
                             f"{trainer.exe.cache_info()['captures']}, want one a bucket")
    bad = [p for p in run2.per_step() if {k: p.get(k, 0) for k in LSTM_PER_STEP} != LSTM_PER_STEP]
    bf16_per = [{k: b[1][k] - a[1][k] for k in b[1]}
                for a, b in zip(run2.after_step, run2.after_step[1:])]
    bad_bf16 = [p for p in bf16_per
                if p != {k: LSTM_BF16_PER_STEP.get(k, 0) for k in p}]
    if bad or bad_bf16 or not np.isfinite(losses + losses2).all():
        raise AssertionError(f"phase 25 (b): warm launches a step {bad[:1]}, bf16 instances "
                             f"{bad_bf16[:1]}; want {LSTM_PER_STEP}, bf16 {LSTM_BF16_PER_STEP}; "
                             f"losses {losses2}")
    if not first_rel <= LSTM_TRAINER_LOSS_RTOL:
        raise AssertionError(f"phase 25 (b): the first step's loss {losses[0]!r}, op by op "
                             f"{ctl_loss!r}")
    del trainer
    _free_trainer(torch, "phase 25 (b)")
    return res, launches, bf16


def _mt_programs(pt):
    from paddle_tpu_torch.models import machine_translation
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = pt.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pt.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pt.layers.data(name="lbl", shape=[1], dtype="int64", lod_level=1)
        loss = machine_translation.train_network(src, trg, lbl, **SEQ_MT)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _mt_feed(seed):
    rng = np.random.default_rng(seed)
    n, t = LSTM_B, SEQ_MT_T
    trg_lens = rng.integers(1, t + 1, (n,)).astype(np.int32)
    return {"src": rng.integers(2, SEQ_MT["src_dict_size"], (n, t, 1)).astype(np.int32),
            "src@SEQ_LEN": rng.integers(1, t + 1, (n,)).astype(np.int32),
            "trg": rng.integers(2, SEQ_MT["trg_dict_size"], (n, t, 1)).astype(np.int32),
            "trg@SEQ_LEN": trg_lens,
            "lbl": rng.integers(2, SEQ_MT["trg_dict_size"], (n, t, 1)).astype(np.int32),
            "lbl@SEQ_LEN": trg_lens}


def _sentiment_programs(pt):
    """tests/test_understand_sentiment.py's convolution_net at the
    reference book model's widths."""
    main, startup = pt.Program(), pt.Program()
    emb_dim, hid = SEQ_SENT["emb"], SEQ_SENT["hid"]
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        data = pt.layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = pt.layers.data(name="label", shape=[1], dtype="int64")
        emb = pt.layers.embedding(input=data, size=[SEQ_SENT["dict_dim"], emb_dim])
        emb = pt.layers.reshape(emb, shape=[0, 0, emb_dim])
        conv_3 = pt.nets.sequence_conv_pool(input=emb, num_filters=hid, filter_size=3,
                                            act="tanh", pool_type="sqrt")
        conv_4 = pt.nets.sequence_conv_pool(input=emb, num_filters=hid, filter_size=4,
                                            act="tanh", pool_type="sqrt")
        pred = pt.layers.fc(input=[conv_3, conv_4], size=2, act="softmax")
        loss = pt.layers.mean(pt.layers.cross_entropy(input=pred, label=label))
        pt.optimizer.Adagrad(learning_rate=SEQ_SENT["lr"]).minimize(loss)
    return main, startup, loss


def _sentiment_feed(pt):
    rows = list(pt.dataset.sentiment.train(LSTM_B)())
    t = SEQ_SENT["t"]
    words = np.zeros((LSTM_B, t, 1), np.int32)
    lens = np.array([len(w) for w, _ in rows], np.int32)
    for i, (w, _) in enumerate(rows):
        words[i, :len(w), 0] = w
    return {"words": words, "words@SEQ_LEN": lens,
            "label": np.array([[l] for _, l in rows], np.int32)}


def _witness_model(torch, pt, card, name, main, startup, loss, feed):
    """Phase 25 (c): one float32 step on the card (a graph replay) and on
    the CPU from the same state, the gradients against the port on the CPU
    in float64 (``_card_cpu_witness``, phase 24 (d)'s gates); then
    SEQ_STEPS - 1 more replays on the card."""
    t0 = time.perf_counter()
    params = [p.name for p in main.global_block.all_parameters()
              if main.desc.block(0).find_var(p.name + "@GRAD") is not None]
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    got, ref, wit, card_exe, card_scope = _card_cpu_witness(torch, pt, main, startup, feed,
                                                             fetch, witness=())
    losses = [float(np.asarray(got[0]))]
    for _ in range(SEQ_STEPS - 1):
        losses.append(float(np.asarray(card_exe.run(main, feed=feed, fetch_list=fetch,
                                                    scope=card_scope)[0])))
    w_rec, w_ok = _witness_gate(got, ref, wit)
    r = {"losses_card_cpu_float64": [losses[0], float(ref[0]), float(wit[0])],
         "loss_rel": abs(losses[0] - float(ref[0])) / abs(float(ref[0])), **w_rec,
         "card_losses": losses, "entries": [e["kind"] for e in card_exe.cache_info()["entries"]
                                            if "words" in e["feeds"] or "src" in e["feeds"]]}
    r["seconds"] = time.perf_counter() - t0
    print(f"phase 25 (c) {name}: one float32 step, losses card / CPU / float64 "
          f"{r['losses_card_cpu_float64']} ({r['loss_rel']:.2e}, gate {BOOK_LOSS_RTOL}); "
          f"{len(params)} gradients as one vector {_witness_text(r['grads_vs_float64'])}; "
          f"{SEQ_STEPS} steps on the card (entries {r['entries']}): losses {losses}; "
          f"{r['seconds']:.1f} s [{card}]")
    if not w_ok or r["loss_rel"] > BOOK_LOSS_RTOL or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0] or r["entries"] != ["graph"]:
        raise AssertionError(f"phase 25 (c) {name}: {r}")
    del card_exe, card_scope
    gc.collect()
    return r


def phase_sequences(torch, card):
    """Phase 25 (see the module docstring): sequences and recurrent nets.
    Returns (a)'s, (b)'s and (c)'s launches by kernel, each counted from 0,
    the float32 instances and the bf16 ones apart, and (a)'s kernels'
    largest errors at the step's shapes."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {}
    t_piece = time.perf_counter()
    res["lstm"] = _lstm_cell(torch, pt, card, counters)
    launches_a = res["lstm"]["launches"]
    t_piece = _piece_seconds("phase 25 (a)", t_piece)
    res["trainer"], launches_b, bf16_b = _lstm_trainer(torch, pt, card, counters)
    t_piece = _piece_seconds("phase 25 (b)", t_piece)
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "bf16_launches"):
            f.bf16_launches = 0
    main, startup, loss = _mt_programs(pt)
    res["machine_translation"] = _witness_model(torch, pt, card, "machine translation", main,
                                                startup, loss, _mt_feed(seed=7))
    main, startup, loss = _sentiment_programs(pt)
    res["sentiment"] = _witness_model(torch, pt, card, "sentiment conv net", main, startup,
                                      loss, _sentiment_feed(pt))
    launches_c, bf16_c = _launch_snapshot(counters), _bf16_snapshot(counters)
    _piece_seconds("phase 25 (c)", t_piece)
    print(f"phase 25 (c) launches over both models' steps {launches_c} (bf16 instances "
          f"{bf16_c}) [{card}]")
    if not (launches_c["gather_rows"] and launches_c["scatter_add_rows"]
            and launches_c["fused_adam"]) or any(bf16_c.values()):
        raise AssertionError(f"phase 25 (c): launches {launches_c}, bf16 instances {bf16_c} "
                             f"(float32 steps)")
    print(json.dumps({"sequences": res}))

    def float32(launches, bf16):
        return {k: v - bf16.get(k, 0) for k, v in launches.items()}
    return {"a": float32(launches_a, res["lstm"]["bf16_launches"]),
            "a_bf16": res["lstm"]["bf16_launches"], "b": float32(launches_b, bf16_b),
            "b_bf16": bf16_b, "c": float32(launches_c, bf16_c), "c_bf16": bf16_c,
            "max_abs_err": res["lstm"]["kernel_max_abs_err"]}


# Phase 26: control flow.  (a) the book's RNN encoder-decoder
# (tests/test_dynamic_rnn.py::test_rnn_encoder_decoder_book's graph: an
# embedding, fc and dynamic_lstm encoder pooled at its last step; a
# DynamicRNN decoder over the target with the encoder's state as memory and
# static input, fc(tanh) and fc to the vocabulary; softmax, cross-entropy
# masked by sequence_mask) at the JAX package's book NMT widths, word and
# hidden 32 (paddle_tpu/models/machine_translation.py:23, :45), a
# vocabulary of 30,000 on both sides (the book's dict_size, phase 25's
# LSTM_DICT), batch 64, padded length 32, lengths from the seed in
# [8, 32]; Adam whose rate is piecewise_decay (a Switch of
# conditional_blocks over the step counter), boundaries inside the replays
CF_V, CF_E, CF_H, CF_B, CF_T = 30000, 32, 32, 64, 32
CF_LOW = 8
CF_BOUNDARIES, CF_RATES = [2, 4], [2e-3, 1e-3, 5e-4]
CF_REPLAYS = 6
CF_PROFILE_STEPS = 2
# launches a replay: K2 on both tables in the forward and again in each
# lookup_table_grad's re-run; K3 in each table's gradient; K6 once over the
# 10 parameters (the kernel pass skips a program of several blocks, so the
# ops keep their types and launch through their lowerings)
CF_PER_STEP = {"gather_rows": 4, "scatter_add_rows": 2, "fused_adam": 1}
# (b): a loop of CF_TRIPS trips of h = tanh(fc(h)) over [CF_ROWS, CF_WIDTH],
# its weight shared by every trip: the bounded form (max_iters) trained by
# SGD, one replay a step (K5 once); the forward alone bounded (replayed)
# and unbounded (op by op, the condition read on the host each trip),
# bit-equal to each other
CF_ROWS, CF_WIDTH, CF_TRIPS = 4096, 256, 8
CF_WHILE_STEPS = 6


def _encdec_programs(pt):
    """(a)'s program, the port's builder at CF_B x CF_T and the book's
    widths: [loss, rate] and its main and startup programs."""
    from paddle_tpu_torch.models import rnn_encoder_decoder
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, lr = rnn_encoder_decoder.train_network(CF_B, CF_T, CF_BOUNDARIES, CF_RATES,
                                                     dict_size=CF_V, word_dim=CF_E,
                                                     hidden_dim=CF_H)
    return main, startup, loss, lr


def _encdec_feed(torch, seed):
    """The builder's synthetic feed on the card, lengths in [CF_LOW, CF_T],
    ids and lengths int32."""
    from paddle_tpu_torch.models.rnn_encoder_decoder import synthetic_feed
    feed = synthetic_feed(seed, CF_B, CF_T, dict_size=CF_V, low=CF_LOW)
    return {k: torch.from_numpy(v.astype(np.int32)).to("cuda") for k, v in feed.items()}


def _piecewise_rate(step):
    """The host's piecewise formula: CF_RATES[i] below CF_BOUNDARIES[i]."""
    for b, v in zip(CF_BOUNDARIES, CF_RATES):
        if step < b:
            return float(np.float32(v))
    return float(np.float32(CF_RATES[-1]))


def _encdec_kernels(torch, main, state0, feed, grads, card):
    """(a)'s kernels at the step's shapes against their plain versions:
    K2 on each [30000, 32] table at its 2,048 ids (and F.embedding); K3
    of each table's step gradient rows (the embedding output's gradient
    of the first step) at those ids, against the plain version on the CPU;
    K6 over the step's 10 updates from its first state and gradients."""
    from paddle_tpu_torch.ops.cuda.embedding import (gather_rows, gather_rows_plain,
                                                     scatter_add_rows, scatter_add_rows_plain)
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam_multi, fused_adam_multi_plain
    ops = main.desc.block(0).ops
    lookups = [o for o in ops if o.type == "lookup_table"]
    errs, ok = {"gather_rows": 0.0, "scatter_add_rows": 0.0}, {}
    for o in lookups:
        table, name = state0[o.input("W")[0]], o.input("Ids")[0]
        ids = feed[name].reshape(-1).contiguous()
        out, ref = gather_rows(table, ids), gather_rows_plain(table, ids)
        lib = torch.nn.functional.embedding(ids.long(), table)
        errs["gather_rows"] = max(errs["gather_rows"], (out - ref).abs().max().item())
        ok[f"gather_rows {name}"] = torch.equal(out, ref) and torch.equal(out, lib)
        rows = torch.as_tensor(np.asarray(grads[o.output("Out")[0]])).reshape(
            ids.numel(), table.shape[1]).to("cuda", torch.float32)
        got = scatter_add_rows(table, ids, rows)
        want = scatter_add_rows_plain(table.cpu(), ids.cpu(), rows.cpu())
        errs["scatter_add_rows"] = max(errs["scatter_add_rows"],
                                       (got.cpu() - want).abs().max().item())
        ok[f"scatter_add_rows {name}"] = torch.equal(got.cpu(), want)
    ups = [o for o in ops if o.type == "adam"]
    ((b1, b2, eps),) = {(o.attr("beta1"), o.attr("beta2"), o.attr("epsilon")) for o in ups}
    entries = [(state0[o.input("Param")[0]].clone(),
                torch.as_tensor(np.asarray(grads[o.input("Param")[0]])).to("cuda", torch.float32),
                state0[o.input("Moment1")[0]].clone(), state0[o.input("Moment2")[0]].clone(),
                state0[o.input("Beta1Pow")[0]], state0[o.input("Beta2Pow")[0]],
                state0[o.input("LearningRate")[0]], False) for o in ups]
    mine = fused_adam_multi([_adam_clones(e) for e in entries], b1, b2, eps)
    theirs = fused_adam_multi_plain([_adam_clones(e) for e in entries], b1, b2, eps)
    pairs = [(x, y) for a, b in zip(mine, theirs) for x, y in zip(a, b)]
    errs["fused_adam"] = _max_abs_diff(torch, pairs)
    ok["fused_adam"] = all(torch.equal(x, y) for x, y in pairs)
    torch.cuda.synchronize()
    print(f"phase 26 (a) kernels at the step's shapes against their plain versions: K2 on "
          f"{len(lookups)} [{CF_V},{CF_E}] tables at {CF_B * CF_T} ids each (and F.embedding), "
          f"K3 of each table's step gradient (plain on the CPU), K6 over {len(entries)} "
          f"updates (the rate the Switch wrote): bit-equal {ok}; max abs err {errs} [{card}]")
    if not all(ok.values()) or len(lookups) != 2 or len(entries) != 10:
        raise AssertionError(f"phase 26 (a): a kernel differs from its plain version: {ok}, "
                             f"{errs}")
    return errs


def _encdec_cell(torch, pt, card, counters):
    """Phase 26 (a): the encoder-decoder trained one CUDA graph replay a
    step; returns its readings."""
    from paddle_tpu_torch.core.executor import analyze_state, graph_blockers
    t0 = time.perf_counter()
    main, startup, loss, lr = _encdec_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feed = _encdec_feed(torch, seed=26)
    st_in, st_out = analyze_state(main.desc.block(0), list(feed))
    blockers = graph_blockers(main, st_in, st_out)
    types = [o.type for o in main.desc.block(0).ops]
    kinds = {k: types.count(k) for k in ("recurrent", "recurrent_grad", "conditional_block",
                                         "dynamic_lstm", "lookup_table", "lookup_table_grad",
                                         "adam")}
    persist = [v.name for v in main.list_vars() if v.persistable and scope.find_var(v.name)
               is not None]
    params = [p.name for p in main.global_block.all_parameters()]
    tokens = int(feed["trg@SEQ_LEN"].sum().item())
    print(f"phase 26 (a) encoder-decoder: vocabulary {CF_V}, word {CF_E}, hidden {CF_H}, batch "
          f"{CF_B} x {CF_T} ({tokens} target tokens), piecewise_decay({CF_BOUNDARIES}, "
          f"{CF_RATES}): {main.desc.num_blocks()} blocks, {len(types)} ops in block 0 {kinds}; "
          f"{len(params)} parameters; graph blockers {blockers}; built and initialized in "
          f"{time.perf_counter() - t0:.2f} s")
    if blockers or main.desc.num_blocks() != 5 or kinds["conditional_block"] != 3:
        raise AssertionError(f"phase 26 (a): blocks {main.desc.num_blocks()}, {kinds}, "
                             f"blockers {blockers}")
    state0 = {n: scope.find_var(n).clone() for n in persist}
    emb_outs = [o.output("Out")[0] for o in main.desc.block(0).ops if o.type == "lookup_table"]
    grad_names = [p + "@GRAD" for p in params] + [n + "@GRAD" for n in emb_outs]
    first = exe._run_eager(main, feed, [loss.name] + grad_names, scope)
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    grads = dict(zip(params + emb_outs, first[1:]))
    kernel_errs = _encdec_kernels(torch, main, state0, feed, grads, card)
    del grads, first
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    info = exe.precompile(main, feed=feed, fetch_list=[loss, lr], scope=scope)
    for f in counters.values():
        f.launches = 0
    bf16_before = _bf16_snapshot(counters)
    losses, rates, step_s = [], [], []
    for _ in range(CF_REPLAYS):
        t1 = time.perf_counter()
        lv, rv = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
        step_s.append(time.perf_counter() - t1)
        losses.append(float(np.asarray(lv)))
        rates.append(float(np.asarray(rv).reshape(-1)[0]))
    launches = _launch_snapshot(counters)
    bf16 = {k: v - bf16_before[k] for k, v in _bf16_snapshot(counters).items()}
    peak = torch.cuda.max_memory_allocated() - base
    entries = [e for e in exe.cache_info()["entries"] if "src" in e["feeds"]]
    step_ms = 1e3 * float(np.median(step_s))
    want_rates = [_piecewise_rate(k) for k in range(CF_REPLAYS)]
    res = {"card": card, "blocks": main.desc.num_blocks(), "ops": len(types), "op_kinds": kinds,
           "capture_s": info["compile_s"], "losses": losses, "rates": rates,
           "step_ms": [1e3 * s for s in step_s], "step_ms_median": step_ms,
           "step_ms_min": 1e3 * min(step_s), "step_ms_max": 1e3 * max(step_s),
           "target_tokens": tokens, "target_tokens_per_s": tokens / (step_ms / 1e3),
           "peak_over_base_gib": peak / 2 ** 30, "launches": launches, "bf16_launches": bf16,
           "kernel_max_abs_err": kernel_errs}
    print(f"phase 26 (a) capture {info['compile_s']:.2f} s (kind {info['kind']}); "
          f"{CF_REPLAYS} replays on one batch: losses {losses}; rates read back {rates} (the "
          f"host's piecewise formula {want_rates}); step ms "
          f"{[round(1e3 * s, 3) for s in step_s]}; median {step_ms:.3f} ms (min "
          f"{res['step_ms_min']:.3f}, max {res['step_ms_max']:.3f}); "
          f"{res['target_tokens_per_s']:.0f} target tokens/s; peak {peak / 2 ** 30:.3f} GiB "
          f"over what was allocated before; hand-written kernel launches {launches} (bf16 "
          f"instances {bf16}) [{card}]")
    if info["kind"] != "graph" or [e["kind"] for e in entries] != ["graph"] \
            or exe.cache_info()["captures"] != 1:
        raise AssertionError(f"phase 26 (a): the step is not one graph: {info}, {entries}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 26 (a): losses not finite and falling: {losses}")
    if rates != want_rates:
        raise AssertionError(f"phase 26 (a): rates {rates}, the formula gives {want_rates}")
    want = {k: CF_REPLAYS * v for k, v in CF_PER_STEP.items()}
    if {k: launches[k] for k in want} != want or any(bf16.values()) or \
            any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"phase 26 (a): launches {launches}, bf16 instances {bf16}; want "
                             f"{CF_PER_STEP} a replay, no bf16 instance")
    prof = _profile(torch, lambda: [exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
                                    for _ in range(CF_PROFILE_STEPS)],
                    "encdec_profile", card,
                    {"batch": [CF_B, CF_T], "steps": CF_PROFILE_STEPS},
                    warm=lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope))
    if prof is None:
        raise AssertionError("phase 26 (a): the profiler recorded no device activity; the "
                             "per-step kernel gates and the idle share read it")
    res["profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                           "by_family_ms", "by_family_launches",
                                           "warm_records")}
    fams = prof["by_family_launches"]
    # K3 is two kernels a call (the sort and the segment sums)
    want = {"gather_rows (K2)": 4, "scatter_add_rows (K3)": 4, "fused_adam (K6)": 1}
    got = {k: fams.get(k, 0) for k in want}
    if got != {k: CF_PROFILE_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"phase 26 (a): the profile's kernels {got}, want {want} a "
                             f"replay")
    n_dev = sum(fams.values())
    busy = prof["device_busy_ms"] / CF_PROFILE_STEPS
    # the profiler stretches the host's side of a replay (its wall a step
    # is printed beside the unprofiled one), so the idle share of the
    # timed replays is read from their median and the profile's busy time
    res["profile"].update(device_operations_a_step=n_dev / CF_PROFILE_STEPS,
                          device_busy_ms_a_step=busy,
                          idle_share_of_timed_replays=1.0 - busy / step_ms)
    print(f"phase 26 (a) profile of {CF_PROFILE_STEPS} replays behind a warm-up replay: "
          f"wall {prof['wall_ms'] / CF_PROFILE_STEPS:.3f} ms a replay (unprofiled median "
          f"{step_ms:.3f}), device busy {busy:.3f} ms a replay; idle share "
          f"{res['profile']['idle_share_of_timed_replays']:.4f} of the timed replays "
          f"({prof['device_idle_share']:.4f} of the profiled window); "
          f"{n_dev / CF_PROFILE_STEPS:.0f} device operations a step [{card}]")
    moments = [n for n in persist if "_moment" in n]
    res["replay_vs_eager"] = _state_vs_eager(
        torch, exe, main, feed, [loss, lr], scope, persist,
        {"parameters": params, "moments": moments}, "encoder-decoder", card,
        phase="phase 26 (a)")
    if res["replay_vs_eager"]["differ"] or not res["replay_vs_eager"]["fetch_equal"]:
        raise AssertionError(f"phase 26 (a): the replay differs from the op-by-op step: "
                             f"{res['replay_vs_eager']}")
    res["device_by_op"] = _device_trace_step(
        torch, exe, main, feed, loss, scope, "phase 26 encoder-decoder", card,
        need=("gather_rows (K2)", "scatter_add_rows (K3)", "fused_adam (K6)"), warm=True)
    del exe, scope, state0
    _free_trainer(torch, "phase 26 (a)")
    return res


def _while_programs(pt, max_iters, train):
    """(b)'s loop: CF_TRIPS trips of h = tanh(fc(h)) from the feed, its fc
    shared by every trip; with ``train``, SGD on mean((h - t)^2)."""
    L = pt.layers
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = L.data(name="x", shape=[CF_ROWS, CF_WIDTH], append_batch_size=False)
        t = L.data(name="t", shape=[CF_ROWS, CF_WIDTH], append_batch_size=False)
        i = L.fill_constant(shape=[1], dtype="int32", value=0)
        limit = L.fill_constant(shape=[1], dtype="int32", value=CF_TRIPS)
        h = L.assign(x)
        h.stop_gradient = False
        cond = L.less_than(i, limit)
        with L.While(cond, max_iters=max_iters).block():
            L.assign(L.fc(input=h, size=CF_WIDTH, act="tanh",
                          param_attr=pt.ParamAttr(name="loop_w"),
                          bias_attr=pt.ParamAttr(name="loop_b")), output=h)
            L.increment(i, value=1, in_place=True)
            L.less_than(i, limit, cond=cond)
        diff = L.elementwise_sub(h, t)
        loss = L.mean(L.elementwise_mul(diff, diff))
        if train:
            pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _while_cell(torch, pt, card, counters):
    """Phase 26 (b): the bounded While trained one replay a step (K5);
    the forward bounded and replayed against unbounded and op by op."""
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_sgd_multi, fused_sgd_multi_plain
    g = torch.Generator().manual_seed(261)
    feed = {"x": torch.randn(CF_ROWS, CF_WIDTH, generator=g).to("cuda"),
            "t": (0.5 * torch.randn(CF_ROWS, CF_WIDTH, generator=g)).to("cuda")}
    res = {}
    main, startup, loss = _while_programs(pt, CF_TRIPS, train=True)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    params = ["loop_w", "loop_b"]
    state0 = {n: scope.find_var(n).clone() for n in params}
    first = exe._run_eager(main, feed, [loss.name] + [p + "@GRAD" for p in params], scope)
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    ((lr_name,),) = {tuple(o.input("LearningRate")) for o in main.desc.block(0).ops
                     if o.type == "sgd"}
    lr_t = scope.find_var(lr_name)
    entries = [(state0[p].clone(), torch.as_tensor(np.asarray(gv)).to("cuda"), lr_t)
               for p, gv in zip(params, first[1:])]
    mine = fused_sgd_multi([(p.clone(), gr, r) for p, gr, r in entries])
    theirs = fused_sgd_multi_plain([(p.clone(), gr, r) for p, gr, r in entries])
    k5_err = _max_abs_diff(torch, list(zip(mine, theirs)))
    k5_ok = all(torch.equal(a, b) for a, b in zip(mine, theirs))
    info = exe.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
    for f in counters.values():
        f.launches = 0
    bf16_before = _bf16_snapshot(counters)
    losses, step_s = _timed_replays(exe, main, feed, [loss], scope, CF_WHILE_STEPS)
    launches = _launch_snapshot(counters)
    bf16 = {k: v - bf16_before[k] for k, v in _bf16_snapshot(counters).items()}
    train_ms = 1e3 * float(np.median(step_s))
    print(f"phase 26 (b) bounded While ({CF_TRIPS} trips of tanh(fc) over [{CF_ROWS}, "
          f"{CF_WIDTH}], max_iters {CF_TRIPS}) + SGD: K5 at the step's 2 updates against its "
          f"plain version bit-equal {k5_ok} (max abs err {k5_err}); capture "
          f"{info['compile_s']:.2f} s (kind {info['kind']}); {CF_WHILE_STEPS} replays: losses "
          f"{losses}; step ms {[round(1e3 * s, 3) for s in step_s]}, median {train_ms:.3f}; "
          f"launches {launches} (bf16 instances {bf16}) [{card}]")
    if info["kind"] != "graph" or not k5_ok or not np.isfinite(losses).all() \
            or not losses[-1] < losses[0] or launches["fused_sgd"] != CF_WHILE_STEPS \
            or any(v for k, v in launches.items() if k != "fused_sgd") or any(bf16.values()):
        raise AssertionError(f"phase 26 (b): {info}, K5 {k5_ok}, losses {losses}, launches "
                             f"{launches}, bf16 instances {bf16}")
    res["bounded_sgd"] = {"capture_s": info["compile_s"], "losses": losses,
                          "step_ms": [1e3 * s for s in step_s], "step_ms_median": train_ms,
                          "launches": launches, "bf16_launches": bf16, "k5_max_abs_err": k5_err}
    res["k5_max_abs_err"] = k5_err
    del exe, scope

    outs, times = {}, {}
    for form, max_iters in (("bounded", CF_TRIPS), ("unbounded", None)):
        fmain, fstartup, floss = _while_programs(pt, max_iters, train=False)
        fscope, fexe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        fexe.run(fstartup, scope=fscope)
        for n, t in state0.items():
            fscope.find_var(n).copy_(t)
        if max_iters is not None:
            fexe.precompile(fmain, feed=feed, fetch_list=[floss], scope=fscope)
        else:
            fexe.run(fmain, feed=feed, fetch_list=[floss], scope=fscope)
        vals, run_s = _timed_replays(fexe, fmain, feed, [floss], fscope, CF_WHILE_STEPS)
        (entry,) = [e for e in fexe.cache_info()["entries"] if "x" in e["feeds"]]
        outs[form], times[form] = vals, [1e3 * s for s in run_s]
        res[form] = {"kind": entry["kind"], "reasons": entry["reasons"], "ms": times[form],
                     "ms_median": float(np.median(times[form]))}
        if form == "bounded":
            eager_s = []
            for _ in range(CF_WHILE_STEPS):
                t1 = time.perf_counter()
                fexe._run_eager(fmain, feed, [floss], fscope)
                eager_s.append(time.perf_counter() - t1)
            res["bounded_op_by_op_ms_median"] = 1e3 * float(np.median(eager_s))
        want_kind = "graph" if max_iters is not None else "eager"
        if entry["kind"] != want_kind or (max_iters is None) != bool(entry["reasons"]):
            raise AssertionError(f"phase 26 (b) {form}: {entry}")
        del fexe, fscope
    print(f"phase 26 (b) the loop's forward, {CF_TRIPS} trips: bounded, one graph replay "
          f"{res['bounded']['ms_median']:.3f} ms a run (op by op "
          f"{res['bounded_op_by_op_ms_median']:.3f} ms); unbounded, op by op, the condition "
          f"read on the host each trip, {res['unbounded']['ms_median']:.3f} ms a run "
          f"({res['unbounded']['ms_median'] / res['bounded']['ms_median']:.2f}x the replay; "
          f"reason: {res['unbounded']['reasons']}); outputs bit-equal "
          f"{outs['bounded'] == outs['unbounded']} [{card}]")
    if outs["bounded"] != outs["unbounded"]:
        raise AssertionError(f"phase 26 (b): bounded {outs['bounded']} != unbounded "
                             f"{outs['unbounded']}")
    _free_trainer(torch, "phase 26 (b)")
    return res


def phase_control_flow(torch, card):
    """Phase 26 (see the module docstring): control flow.  Returns (a)'s
    and (b)'s launches by kernel, each counted from 0, the float32
    instances and the bf16 ones (gated at 0) apart, and the kernels'
    largest errors at (a)'s and (b)'s shapes."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {}
    t_piece = time.perf_counter()
    res["encoder_decoder"] = _encdec_cell(torch, pt, card, counters)
    t_piece = _piece_seconds("phase 26 (a)", t_piece)
    res["while"] = _while_cell(torch, pt, card, counters)
    _piece_seconds("phase 26 (b)", t_piece)
    print(json.dumps({"control_flow": res}))
    cells = (res["encoder_decoder"], res["while"]["bounded_sgd"])
    bf16 = {k: sum(c["bf16_launches"][k] for c in cells) for k in cells[0]["bf16_launches"]}
    launches = {k: sum(c["launches"][k] for c in cells) - bf16[k]
                for k in cells[0]["launches"]}
    errs = {**res["encoder_decoder"]["kernel_max_abs_err"],
            "fused_sgd": res["while"]["k5_max_abs_err"]}
    return {"launches": launches, "bf16_launches": bf16, "max_abs_err": errs}


# ---------------------------------------------------------------- phase 27
# (a): DeepFM (models/deepfm.py, BASELINE.json's CTR config) at the width
# users train it at: 26 categorical fields with the Criteo Kaggle
# cardinalities (33,762,577 rows a table set), embed_dim 16, a 400-400-400
# ReLU MLP with dropout 0.5, 13 dense features, batch 2,048; the tables'
# gradients SelectedRows (is_sparse=True), Adam (lazy on the tables)
FM_B, FM_DIM, FM_HIDDEN = 2048, 16, (400, 400, 400)
FM_LR = 1e-3
FM_REPLAYS = 8
FM_FEEDS = 4                # the replays cycle over this many batches
FM_PROFILE_STEPS = 2
# launches a replay: K2 once a lookup (52: the [V, 1] and [V, 16] table of
# each field; a sparse gradient re-runs no gather), K6 once over the MLP's
# 8 dense parameters; no K3 (a sparse gradient is no scatter-add) and no K5
FM_PER_STEP = {"gather_rows": 52, "fused_adam": 1}
# (b): the dense twin (is_sparse=False): K2 52, K3 52 (the kernel tier's
# pallas_scatter_add reads the output gradient; no gather again), K6 once
# over all 60 parameters
FM_DENSE_PER_STEP = {"gather_rows": 52, "scatter_add_rows": 52, "fused_adam": 1}
FM_DENSE_REPLAYS = 6
# (c): bench.py's embedding row (bench.py:1456-1507) at its TPU sizes
EMB_ROWS, EMB_DIM, EMB_B = (4096, 32768, 262144), 128, 1024
EMB_LR, EMB_STEPS, EMB_FEEDS = 0.125, 20, 4
# both arms' tables after the same steps: every update is exact (a mean over
# 1024 x 128 and a rate of 2**-3 make multiples of 2**-20), so they agree
# within this (0 expected)
EMB_ARM_ATOL = 1e-6
# (d): the Trainer's steps; (e): the served batch and the cached table
FM_TRAINER_STEPS = 3
FM_SERVE_ROWS = 8
FM_CACHE_TABLE = "fm_emb_2"     # the 10,131,227-row field


def _deepfm_programs(pt, is_sparse=True, is_test=False):
    """(main, startup, loss) of DeepFM at the Criteo width."""
    from paddle_tpu_torch.models import deepfm
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids, dense, label = deepfm.data_layers(len(deepfm.CRITEO_VOCAB))
        logits = deepfm.deepfm(ids, dense, deepfm.CRITEO_VOCAB, embed_dim=FM_DIM,
                               hidden=FM_HIDDEN, is_test=is_test, is_sparse=is_sparse)
        loss = pt.layers.mean(pt.layers.sigmoid_cross_entropy_with_logits(x=logits, label=label))
        pt.optimizer.Adam(learning_rate=FM_LR).minimize(loss)
    return main, startup, loss


def _deepfm_feeds(torch, n, seed):
    """``n`` seeded Criteo-width batches on the card (ids int32)."""
    from paddle_tpu_torch.models.deepfm import synthetic_feed
    feeds = []
    for k in range(n):
        f = synthetic_feed(seed + k, FM_B)
        feeds.append({name: torch.from_numpy(v.astype(np.int32) if v.dtype == np.int64 else v)
                      .to("cuda") for name, v in f.items()})
    return feeds


def _k2_at(torch, w, ids, label, card, phase="phase 27 (a)"):
    """K2 on ``w`` at ``ids`` against its plain version (bit-equal) and
    ``F.embedding``: event ms (best of 3 rounds in turns), plain ms, bound."""
    from paddle_tpu_torch.ops.cuda.embedding import gather_rows, gather_rows_plain
    out, ref = gather_rows(w, ids), gather_rows_plain(w, ids)
    lib = torch.nn.functional.embedding(ids.long(), w)
    torch.cuda.synchronize()
    equal = torch.equal(out, ref) and torch.equal(out, lib)
    fns = [lambda: gather_rows(w, ids), lambda: torch.nn.functional.embedding(ids.long(), w)]
    ms, lib_ms = _best(lambda fn: _ms(fn, 200), fns)
    plain_ms = _ms(lambda: gather_rows_plain(w, ids), 50)
    rows_read = int(torch.unique(ids).numel())
    bound_ms, bound_by = _bound(4 * (rows_read * w.shape[1] + ids.numel() + out.numel()), 0)
    rec = dict(max_abs_err=(out - ref).abs().max().item(), bit_equal=equal, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
               rows_read=rows_read, table=list(w.shape), ids=ids.numel())
    print(f"{phase} K2 {label} W=[{w.shape[0]},{w.shape[1]}] N={ids.numel()} "
          f"({rows_read} rows read): bit-equal to plain and F.embedding {equal}; kernel {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, F.embedding {lib_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    return rec


def _k6_at(torch, ups, state0, grads):
    """K6 over the update ops ``ups`` from ``state0`` and ``grads`` (by
    parameter) against its plain version: max abs err, bit-equal, entries
    and floats."""
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam_multi, fused_adam_multi_plain
    ((b1, b2, eps),) = {(o.attr("beta1"), o.attr("beta2"), o.attr("epsilon")) for o in ups}
    entries = [(state0[o.input("Param")[0]], grads[o.input("Param")[0]],
                state0[o.input("Moment1")[0]], state0[o.input("Moment2")[0]],
                state0[o.input("Beta1Pow")[0]], state0[o.input("Beta2Pow")[0]],
                state0[o.input("LearningRate")[0]], o.type == "pallas_adam") for o in ups]
    mine = fused_adam_multi([_adam_clones(e) for e in entries], b1, b2, eps)
    theirs = fused_adam_multi_plain([_adam_clones(e) for e in entries], b1, b2, eps)
    pairs = [(x, y) for a, b in zip(mine, theirs) for x, y in zip(a, b)]
    return {"max_abs_err": _max_abs_diff(torch, pairs),
            "bit_equal": all(torch.equal(x, y) for x, y in pairs), "entries": len(entries),
            "floats": sum(e[0].numel() for e in entries)}


def _fm_kernels(torch, main, state0, feed, grads, card):
    """(a)'s kernels at the step's shapes: K2 on the D-16 and D-1 tables of
    the largest field (10,131,227 rows, the scalar branch at D 1) and of a
    small one at the step's ids; K6 over the 8 dense updates of the first
    step from its state and gradients."""
    k2 = {}
    for field in (2, 0):
        ids = feed[f"C{field}"].reshape(-1).contiguous()
        for name in (f"fm_emb_{field}", f"fm_w1_{field}"):
            k2[name] = _k2_at(torch, state0[name], ids, f"field {field}", card)
    k6 = _k6_at(torch, [o for o in main.desc.block(0).ops if o.type in ("adam", "pallas_adam")
                        and not o.input("Param")[0].startswith("fm_")], state0, grads)
    print(f"phase 27 (a) K6 over the step's {k6['entries']} dense updates (the MLP) against its "
          f"plain version: bit-equal {k6['bit_equal']}, max abs err {k6['max_abs_err']} [{card}]")
    if not all(r["bit_equal"] for r in k2.values()) or not k6["bit_equal"] or k6["entries"] != 8:
        raise AssertionError(f"phase 27 (a): a kernel differs from its plain version: K2 "
                             f"{ {k: r['bit_equal'] for k, r in k2.items()} }, K6 {k6}")
    return k2, k6


def _replay_vs_eager_rng(torch, exe, main, feed, fetch, scope, persist, label, card):
    """A replay against an op-by-op step from the same state and the same
    generator state (the step draws dropout masks): loss and every state
    tensor bit-equal."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    gen = scope.find_var(RNG_STATE_VAR)
    state0 = {n: scope.find_var(n).clone() for n in persist}
    rng = gen.get_state()
    g_out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    after = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    gen.set_state(rng)
    e_out = exe._run_eager(main, feed, fetch, scope)
    differ = [n for n in persist if not torch.equal(after[n], scope.find_var(n))]
    equal = not differ and all(np.array_equal(a, b) for a, b in zip(g_out, e_out))
    print(f"phase 27 {label}: a replay against an op-by-op step from the same state and "
          f"generator state: loss {float(np.asarray(g_out[0]))!r} / "
          f"{float(np.asarray(e_out[0]))!r}; {len(persist) - len(differ)} of {len(persist)} "
          f"state tensors bit-equal; differing {differ[:6]} [{card}]")
    if not equal:
        raise AssertionError(f"phase 27 {label}: the replay differs from the op-by-op step: "
                             f"{differ[:6]}")
    return {"state": len(persist), "differ": len(differ)}


def _untouched_unchanged(torch, scope, before, feeds):
    """Of each table and its two moments, the rows no batch in ``feeds``
    touched, against ``before`` (their values before the steps): the count
    of tensors checked, rows checked, and the names that moved."""
    moved, rows = [], 0
    for field in range(26):
        hit = torch.zeros(0, dtype=torch.int64, device="cuda")
        for f in feeds:
            hit = torch.cat([hit, f[f"C{field}"].reshape(-1).long()])
        for table in (f"fm_emb_{field}", f"fm_w1_{field}"):
            for name in (table, f"{table}_moment1_0", f"{table}_moment2_0"):
                keep = torch.ones(before[name].shape[0], dtype=torch.bool, device="cuda")
                keep[hit] = False
                rows += int(keep.sum())
                if not torch.equal(scope.find_var(name)[keep], before[name][keep]):
                    moved.append(name)
    return {"tensors": 26 * 6, "untouched_rows": rows, "moved": moved}


def _deepfm_cell(torch, pt, card, counters):
    """Phase 27 (a): DeepFM trained one CUDA graph replay a step with
    SelectedRows gradients; returns its readings."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR, analyze_state, graph_blockers
    from paddle_tpu_torch.models.deepfm import CRITEO_VOCAB
    t0 = time.perf_counter()
    main, startup, loss = _deepfm_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feeds = _deepfm_feeds(torch, FM_FEEDS, seed=27)
    st_in, st_out = analyze_state(main.desc.block(0), list(feeds[0]))
    blockers = graph_blockers(main, st_in, st_out)
    n_ops, kinds = _op_counts(main)
    sparse = [v.name for v in main.list_vars() if v.type == "selected_rows"]
    persist = [v.name for v in main.list_vars() if v.persistable and scope.find_var(v.name)
               is not None]
    params = [p.name for p in main.global_block.all_parameters()]
    table_bytes = sum(scope.find_var(p).numel() * 4 for p in params if p.startswith("fm_"))
    print(f"phase 27 (a) DeepFM: 26 Criteo fields ({sum(CRITEO_VOCAB):,} rows a table set, "
          f"{table_bytes / 1e9:.3f} GB of tables), embed {FM_DIM}, MLP {FM_HIDDEN}, batch {FM_B}: "
          f"{n_ops} ops {kinds}; {len(sparse)} SelectedRows gradients; {len(params)} parameters; "
          f"graph blockers {blockers}; built and initialized in {time.perf_counter() - t0:.2f} s "
          f"[{card}]")
    if blockers or len(sparse) != 52 or kinds.get("adam", 0) != 60:
        raise AssertionError(f"phase 27 (a): blockers {blockers}, {len(sparse)} sparse "
                             f"gradients, {kinds}")
    # the first step's dense gradients from an op-by-op step, after which
    # the state and the generator are put back
    state0 = {n: scope.find_var(n).clone() for n in persist}
    gen = scope.find_var(RNG_STATE_VAR)
    rng = gen.get_state() if gen is not None else None
    dense_params = [p for p in params if not p.startswith("fm_")]
    first = exe._run_eager(main, feeds[0], [loss.name] + [p + "@GRAD" for p in dense_params],
                           scope, return_numpy=False)
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    if rng is not None:
        scope.find_var(RNG_STATE_VAR).set_state(rng)
    grads = dict(zip(dense_params, first[1:]))
    kernels = _fm_kernels(torch, main, state0, feeds[0], grads, card)
    del first, grads
    # the tables and their moments before the replays, for the untouched rows
    before = {n: t for n, t in state0.items() if n.startswith("fm_")}
    del state0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    info = exe.precompile(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    for f in counters.values():
        f.launches = 0
    bf16_before = _bf16_snapshot(counters)
    losses, step_s = [], []
    for k in range(FM_REPLAYS):
        t1 = time.perf_counter()
        (lv,) = exe.run(main, feed=feeds[k % FM_FEEDS], fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv)))
        step_s.append(time.perf_counter() - t1)
    launches = _launch_snapshot(counters)
    bf16 = {k: v - bf16_before[k] for k, v in _bf16_snapshot(counters).items()}
    peak = torch.cuda.max_memory_allocated()
    untouched = _untouched_unchanged(torch, scope, before, feeds[:min(FM_REPLAYS, FM_FEEDS)])
    del before
    step_ms = 1e3 * float(np.median(step_s))
    entries = [e for e in exe.cache_info()["entries"] if "C0" in e["feeds"]]
    res = {"card": card, "ops": n_ops, "op_kinds": kinds, "sparse_grads": len(sparse),
           "table_bytes": table_bytes, "capture_s": info["compile_s"], "losses": losses,
           "step_ms": [1e3 * s for s in step_s], "step_ms_median": step_ms,
           "step_ms_min": 1e3 * min(step_s), "step_ms_max": 1e3 * max(step_s),
           "examples_per_s": FM_B / (step_ms / 1e3), "peak_gib": peak / 2 ** 30,
           "peak_over_base_gib": (peak - base) / 2 ** 30, "launches": launches,
           "bf16_launches": bf16, "untouched": untouched,
           "k2": kernels[0], "k6": kernels[1]}
    print(f"phase 27 (a) capture {info['compile_s']:.2f} s (kind {info['kind']}); {FM_REPLAYS} "
          f"replays over {FM_FEEDS} batches: losses {losses}; step ms "
          f"{[round(1e3 * s, 3) for s in step_s]}; median {step_ms:.3f} ms (min "
          f"{res['step_ms_min']:.3f}, max {res['step_ms_max']:.3f}); "
          f"{res['examples_per_s']:.0f} examples/s; peak {peak / 2 ** 30:.3f} GiB allocated "
          f"({(peak - base) / 2 ** 30:.3f} over the state); hand-written kernel launches "
          f"{launches} (bf16 instances {bf16}); untouched rows of the 52 tables and their "
          f"moments: {untouched['untouched_rows']:,} rows, moved {untouched['moved']} [{card}]")
    if info["kind"] != "graph" or [e["kind"] for e in entries] != ["graph"] \
            or exe.cache_info()["captures"] != 1:
        raise AssertionError(f"phase 27 (a): the step is not one graph: {info}, {entries}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"phase 27 (a): losses not finite: {losses}")
    if untouched["moved"]:
        raise AssertionError(f"phase 27 (a): untouched rows moved in {untouched['moved']}")
    want = {k: FM_REPLAYS * v for k, v in FM_PER_STEP.items()}
    if {k: launches[k] for k in want} != want or any(bf16.values()) or \
            any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"phase 27 (a): launches {launches}, bf16 {bf16}; want "
                             f"{FM_PER_STEP} a replay and nothing else")
    res["profile"] = _replay_profile(torch, exe, main, feeds[0], loss, scope, "deepfm", card,
                                     {"gather_rows (K2)": 52, "fused_adam (K6)": 1,
                                      "scatter_add_rows (K3)": 0, "fused_sgd (K5)": 0},
                                     step_ms)
    res["replay_vs_eager"] = _replay_vs_eager_rng(torch, exe, main, feeds[1], [loss], scope,
                                                  persist, "(a) DeepFM", card)
    del exe, scope
    _free_trainer(torch, "phase 27 (a)")
    return res


def _replay_profile(torch, exe, main, feed, loss, scope, label, card, want, step_ms,
                    fetch=None, phase=27):
    """A profile of FM_PROFILE_STEPS replays behind a warm-up replay, which
    must record: device busy ms a replay, the timed replays' idle share
    (their median wall against the profile's busy time: the profiler
    stretches the host's side), the kernels by family gated at ``want`` a
    replay.  ``fetch`` (default ``[loss]``) keys the cache entry replayed."""
    fetch = fetch or [loss]
    prof = _profile(torch, lambda: [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
                                    for _ in range(FM_PROFILE_STEPS)],
                    f"{label}_profile", card, {"batch": FM_B, "steps": FM_PROFILE_STEPS},
                    warm=lambda: exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
    if prof is None:
        raise AssertionError(f"phase {phase} {label}: the profiler recorded no device activity; "
                             f"the kernel gates and the idle share read it")
    fams = prof["by_family_launches"]
    got = {k: fams.get(k, 0) for k in want}
    if got != {k: FM_PROFILE_STEPS * v for k, v in want.items()}:
        raise AssertionError(f"phase {phase} {label}: the profile's kernels {got}, want {want} a "
                             f"replay")
    busy = prof["device_busy_ms"] / FM_PROFILE_STEPS
    out = {k: prof[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                "by_family_ms", "by_family_launches", "warm_records")}
    out.update(device_operations_a_step=sum(fams.values()) / FM_PROFILE_STEPS,
               device_busy_ms_a_step=busy, idle_share_of_timed_replays=1.0 - busy / step_ms)
    print(f"phase {phase} {label} profile of {FM_PROFILE_STEPS} replays: device busy "
          f"{busy:.3f} ms a replay (timed median {step_ms:.3f} ms): idle share "
          f"{out['idle_share_of_timed_replays']:.4f} of the timed replays "
          f"({prof['device_idle_share']:.4f} of the profiled window); "
          f"{out['device_operations_a_step']:.0f} device operations a step; ms by family "
          f"{ {k: round(v / FM_PROFILE_STEPS, 4) for k, v in prof['by_family_ms'].items()} } "
          f"[{card}]")
    return out


def _k3_at(torch, w, ids, rows, label, card):
    """K3 of ``rows`` at ``ids`` into ``w``'s shape against its plain
    version run on the CPU (bit-equal; on the card ``index_add_`` adds by
    atomics): event ms (best of 3 rounds in turns with ``index_add_``),
    plain ms on the card, bound."""
    from paddle_tpu_torch.ops.cuda.embedding import scatter_add_rows, scatter_add_rows_plain
    got = scatter_add_rows(w, ids, rows)
    want = scatter_add_rows_plain(w.cpu(), ids.cpu(), rows.cpu())
    got = got.cpu()
    equal = torch.equal(got, want)
    err = (got - want).abs().max().item()
    del got, want
    l_ids = ids.long()
    fns = [lambda: scatter_add_rows(w, ids, rows),
           lambda: torch.zeros_like(w).index_add_(0, l_ids, rows)]
    ms, lib_ms = _best(lambda fn: _ms(fn, 20), fns)
    plain_ms = _ms(lambda: scatter_add_rows_plain(w, ids, rows), 20)
    n, d = rows.shape
    bound_ms, bound_by = _bound(4 * (ids.numel() + n * d + w.numel()), n * d)
    rec = dict(max_abs_err=err, bit_equal=equal, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, table=list(w.shape), ids=ids.numel())
    print(f"phase 27 (b) K3 {label} W=[{w.shape[0]},{w.shape[1]}] N={n}: bit-equal to its plain "
          f"version on the CPU {equal} (max abs err {err}); kernel {ms:.4f} ms, plain on the card "
          f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}) "
          f"[{card}]")
    return rec


def _dense_twin_kernels(torch, main, state0, feed, grads, card):
    """(b)'s kernels at the step's shapes: K3 of the first step's output
    gradients of the 10,131,227-row field's two lookups at its ids; K6
    over the step's 60 updates (every table dense) from its state and
    gradients."""
    ops = main.desc.block(0).ops
    ids = feed["C2"].reshape(-1).contiguous()
    k3 = {}
    for name in ("fm_emb_2", "fm_w1_2"):
        (out,) = [o.output("Out")[0] for o in ops
                  if o.type in ("lookup_table", "pallas_gather") and o.input("W")[0] == name]
        w = state0[name]
        k3[name] = _k3_at(torch, w, ids,
                          grads[out].reshape(ids.numel(), w.shape[1]).contiguous(),
                          "field 2", card)
    k6 = _k6_at(torch, [o for o in ops if o.type in ("adam", "pallas_adam")], state0, grads)
    print(f"phase 27 (b) K6 over the step's {k6['entries']} updates ({k6['floats']:,} floats, "
          f"every table dense) against its plain version: bit-equal {k6['bit_equal']}, max abs "
          f"err {k6['max_abs_err']} [{card}]")
    if not all(r["bit_equal"] for r in k3.values()) or not k6["bit_equal"] or k6["entries"] != 60:
        raise AssertionError(f"phase 27 (b): a kernel differs from its plain version: K3 "
                             f"{ {k: r['bit_equal'] for k, r in k3.items()} }, K6 {k6}")
    return k3, k6


def _deepfm_dense_twin(torch, pt, card, counters):
    """Phase 27 (b): the same model with dense table gradients, replayed:
    K3 into the 10M-row tables and K6 over all 60 parameters, each first
    held against its plain version at the step's shapes."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    main, startup, loss = _deepfm_programs(pt, is_sparse=False)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    feeds = _deepfm_feeds(torch, FM_FEEDS, seed=27)
    # the first step's gradients from an op-by-op step, after which the
    # state and the generator are put back
    persist = [v.name for v in main.list_vars() if v.persistable and scope.find_var(v.name)
               is not None]
    params = [p.name for p in main.global_block.all_parameters()]
    outs = [o.output("Out")[0] for o in main.desc.block(0).ops
            if o.type in ("lookup_table", "pallas_gather")
            and o.input("W")[0] in ("fm_emb_2", "fm_w1_2")]
    state0 = {n: scope.find_var(n).clone() for n in persist}
    gen = scope.find_var(RNG_STATE_VAR)
    rng = gen.get_state() if gen is not None else None
    first = exe._run_eager(main, feeds[0], [loss.name] + [n + "@GRAD" for n in params + outs],
                           scope, return_numpy=False)
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    if rng is not None:
        gen.set_state(rng)
    kernels = _dense_twin_kernels(torch, main, state0, feeds[0],
                                  dict(zip(params + outs, first[1:])), card)
    del first, state0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    info = exe.precompile(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    for f in counters.values():
        f.launches = 0
    losses, step_s = [], []
    for k in range(FM_DENSE_REPLAYS):
        t1 = time.perf_counter()
        (lv,) = exe.run(main, feed=feeds[k % FM_FEEDS], fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv)))
        step_s.append(time.perf_counter() - t1)
    launches = _launch_snapshot(counters)
    peak = torch.cuda.max_memory_allocated()
    step_ms = 1e3 * float(np.median(step_s))
    res = {"card": card, "capture_s": info["compile_s"], "losses": losses,
           "step_ms": [1e3 * s for s in step_s], "step_ms_median": step_ms,
           "step_ms_min": 1e3 * min(step_s), "step_ms_max": 1e3 * max(step_s),
           "examples_per_s": FM_B / (step_ms / 1e3), "peak_gib": peak / 2 ** 30,
           "launches": launches, "k3": kernels[0], "k6": kernels[1]}
    print(f"phase 27 (b) the dense twin (is_sparse=False): capture {info['compile_s']:.2f} s "
          f"(kind {info['kind']}); {FM_DENSE_REPLAYS} replays: losses {losses}; step ms "
          f"{[round(1e3 * s, 3) for s in step_s]}; median {step_ms:.3f} ms; "
          f"{res['examples_per_s']:.0f} examples/s; peak {peak / 2 ** 30:.3f} GiB; launches "
          f"{launches} [{card}]")
    want = {k: FM_DENSE_REPLAYS * v for k, v in FM_DENSE_PER_STEP.items()}
    if info["kind"] != "graph" or not np.isfinite(losses).all() or \
            {k: launches[k] for k in want} != want or \
            any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"phase 27 (b): {info['kind']}, losses {losses}, launches "
                             f"{launches}; want {FM_DENSE_PER_STEP} a replay")
    del exe, scope
    _free_trainer(torch, "phase 27 (b)")
    return res


def _embedding_arm(torch, pt, rows, is_sparse, feeds, start, counters):
    """bench.py's embedding step (sharded_table + mean + SGD(0.125)) at
    ``rows``, EMB_STEPS replays over ``feeds``: (step ms a replay, the
    table after them, launches)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        emb = pt.embedding.sharded_table(ids, "bench_table", rows=rows, dim=EMB_DIM,
                                         is_sparse=is_sparse)
        loss = pt.layers.mean(emb)
        pt.optimizer.SGD(learning_rate=EMB_LR).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    scope.find_var("bench_table").copy_(start)
    exe.precompile(main, feed=feeds[0], fetch_list=[loss], scope=scope)
    for f in counters.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(EMB_STEPS):
        exe.run(main, feed=feeds[k % len(feeds)], fetch_list=[loss], scope=scope)
    ms = (time.perf_counter() - t0) / EMB_STEPS * 1e3
    launches = _launch_snapshot(counters)
    table = scope.find_var("bench_table").clone()
    if [e["kind"] for e in exe.cache_info()["entries"] if "ids" in e["feeds"]] != ["graph"]:
        raise AssertionError(f"phase 27 (c): rows {rows} sparse {is_sparse}: not one graph")
    return ms, table, launches


def _embedding_row(torch, pt, card, counters):
    """Phase 27 (c): bench.py's embedding row at its TPU sizes, both arms."""
    rng = np.random.default_rng(17)
    out = []
    for rows in EMB_ROWS:
        feeds = [{"ids": torch.from_numpy(np.minimum(rng.zipf(1.3, (EMB_B, 1)) - 1, rows - 1)
                                          .astype(np.int32)).to("cuda")}
                 for _ in range(EMB_FEEDS)]
        start = torch.randn(rows, EMB_DIM, generator=torch.Generator().manual_seed(rows)).cuda()
        dense_ms, dense_t, dense_l = _embedding_arm(torch, pt, rows, False, feeds, start, counters)
        sparse_ms, sparse_t, sparse_l = _embedding_arm(torch, pt, rows, True, feeds, start,
                                                       counters)
        diff = (dense_t - sparse_t).abs().max().item()
        rec = {"rows": rows, "dim": EMB_DIM, "batch": EMB_B, "dense_step_ms": dense_ms,
               "sparse_step_ms": sparse_ms, "speedup": dense_ms / sparse_ms,
               "sparse_rows_per_s": EMB_B / (sparse_ms / 1e3), "arms_max_abs_diff": diff,
               "arms_bit_equal": torch.equal(dense_t, sparse_t),
               "dense_launches": {k: v for k, v in dense_l.items() if v},
               "sparse_launches": {k: v for k, v in sparse_l.items() if v}}
        out.append(rec)
        print(f"phase 27 (c) bench.py's embedding row, rows {rows} x {EMB_DIM}, batch {EMB_B}, "
              f"{EMB_STEPS} replays: dense {dense_ms:.3f} ms a step, sparse {sparse_ms:.3f} ms "
              f"({rec['speedup']:.2f}x); the arms' tables max abs diff {diff} (bit-equal "
              f"{rec['arms_bit_equal']}); launches dense {rec['dense_launches']}, sparse "
              f"{rec['sparse_launches']} [{card}]")
        want_dense = {"gather_rows": EMB_STEPS, "scatter_add_rows": EMB_STEPS,
                      "fused_sgd": EMB_STEPS}
        if diff > EMB_ARM_ATOL or rec["dense_launches"] != want_dense or \
                rec["sparse_launches"] != {"gather_rows": EMB_STEPS}:
            raise AssertionError(f"phase 27 (c): rows {rows}: {rec}; the dense arm must launch "
                                 f"{want_dense}, the sparse arm K2 alone")
        del dense_t, sparse_t, start
    _free_trainer(torch, "phase 27 (c)")
    return out


def _deepfm_trainer(torch, pt, card):
    """Phase 27 (d): DeepFM through Trainer(prefetcher=RowPrefetcher(...)),
    pipelined, FM_TRAINER_STEPS steps; returns the trainer and readings."""
    from paddle_tpu_torch.embedding import RowPrefetcher
    from paddle_tpu_torch.models import deepfm
    n = len(deepfm.CRITEO_VOCAB)
    feeds = [deepfm.synthetic_feed(270 + k, FM_B) for k in range(FM_TRAINER_STEPS)]

    def train_func():
        ids, dense, label = deepfm.data_layers(n)
        loss, _ = deepfm.train_network(ids, dense, label, deepfm.CRITEO_VOCAB, embed_dim=FM_DIM)
        return loss

    def reader():
        for f in feeds:
            yield list(zip(*[f[f"C{i}"] for i in range(n)], f["dense"], f["label"]))

    pf = RowPrefetcher({f"C{i}": f"fm_emb_{i}" for i in range(n)})
    with pt.unique_name.guard():
        trainer = pt.Trainer(train_func=train_func,
                             optimizer_func=lambda: pt.optimizer.Adam(learning_rate=FM_LR),
                             place=pt.CUDAPlace(0), prefetcher=pf)
    losses = []

    def handler(ev):
        if isinstance(ev, pt.EndStepEvent):
            losses.append(float(np.asarray(ev.metrics[0])))
    t0 = time.perf_counter()
    trainer.train(num_epochs=1, event_handler=handler, reader=reader,
                  feed_order=[f"C{i}" for i in range(n)] + ["dense", "label"])
    wall = time.perf_counter() - t0
    stats = pf.stats()
    want_ratio = np.mean([sum(np.unique(f[f"C{i}"]).size for i in range(n)) / (n * FM_B)
                          for f in feeds])
    entries = [e for e in trainer.exe.cache_info()["entries"] if "C0" in e["feeds"]]
    res = {"steps": len(losses), "losses": losses, "wall_s": wall, "prefetch": stats,
           "host_dedup_ratio": float(want_ratio), "entries": [e["kind"] for e in entries]}
    print(f"phase 27 (d) Trainer(prefetcher=RowPrefetcher(26 fields)) pipelined, "
          f"{FM_TRAINER_STEPS} steps of {FM_B}: losses {losses}; {wall:.2f} s; prefetcher "
          f"{stats} (dedup ratio {stats['dedup_ratio']}, numpy's over the batches "
          f"{want_ratio:.6f}); cache entries {res['entries']} [{card}]")
    if len(losses) != FM_TRAINER_STEPS or not np.isfinite(losses).all() or \
            stats["batches"] != FM_TRAINER_STEPS or \
            abs(stats["dedup_ratio"] - want_ratio) > 1e-5 or res["entries"] != ["graph"]:
        raise AssertionError(f"phase 27 (d): {res}")
    return trainer, res


def _deepfm_serving(torch, pt, card, trainer):
    """Phase 27 (e): the trained DeepFM served by ServingSession with a row
    cache on the largest table: lookup_rows equal to the trained rows (hits
    on the second call), a served batch equal to the inferencer's own run
    and to an op-by-op run."""
    from paddle_tpu_torch.models import deepfm
    n = len(deepfm.CRITEO_VOCAB)

    def infer_func():
        ids, dense, _ = deepfm.data_layers(n)
        return deepfm.deepfm(ids, dense, deepfm.CRITEO_VOCAB, embed_dim=FM_DIM, is_test=True)

    inf = pt.Inferencer(infer_func=infer_func, place=pt.CUDAPlace(0))
    for v in inf.inference_program.list_vars():
        if v.persistable and inf.scope.find_var(v.name) is not None:
            inf.scope.find_var(v.name).copy_(trainer.scope.find_var(v.name))
    sess = pt.ServingSession(inferencer=inf, max_batch_size=FM_SERVE_ROWS,
                             embedding_cache={FM_CACHE_TABLE: {"capacity_rows": 4096}})
    try:
        table = trainer.scope.find_var(FM_CACHE_TABLE)
        ids = np.array([0, 1, 2, 3, 10_131_226, 5_000_000, 1, 0], np.int64)
        r1 = sess.lookup_rows(FM_CACHE_TABLE, ids)
        r2 = sess.lookup_rows(FM_CACHE_TABLE, ids[::-1])
        want = table[torch.from_numpy(ids).cuda()].cpu().numpy()
        cache = sess.stats()["embedding"][FM_CACHE_TABLE]
        f = deepfm.synthetic_feed(2700, FM_SERVE_ROWS)
        feed = {k: v for k, v in f.items() if k != "label"}
        served = sess.infer(feed)[0]
        direct = inf.infer(feed)[0]
        eager = inf.exe._run_eager(inf.inference_program, feed, list(inf.predict_vars),
                                   inf.scope)[0]
    finally:
        sess.close()
    res = {"lookup_equal": bool(np.array_equal(r1, want) and np.array_equal(r2, want[::-1])),
           "cache": cache, "served_equal_direct": bool(np.array_equal(served, direct)),
           "served_equal_eager": bool(np.array_equal(served, eager)),
           "served": np.asarray(served).reshape(-1).tolist(),
           "buckets": [r["kind"] for r in sess.warmup_report]}
    print(f"phase 27 (e) ServingSession(embedding_cache={{{FM_CACHE_TABLE!r}: 4096 rows}}) over "
          f"the trained DeepFM: lookup_rows equal to the trained table {res['lookup_equal']}; "
          f"cache {cache}; a served {FM_SERVE_ROWS}-row batch {res['served']} equal to the "
          f"inferencer's replay {res['served_equal_direct']} and to an op-by-op run "
          f"{res['served_equal_eager']}; buckets {res['buckets']} [{card}]")
    if not (res["lookup_equal"] and res["served_equal_direct"] and res["served_equal_eager"]) \
            or cache["hits"] < len(ids) or not np.isfinite(res["served"]).all():
        raise AssertionError(f"phase 27 (e): {res}")
    return res


def phase_sparse(torch, card):
    """Phase 27 (see the module docstring): sparse gradients and the
    embedding subsystem.  Returns (a)'s launches by kernel over its timed
    replays (the bf16 instances apart), the kernels' largest errors at
    (a)'s and (b)'s shapes, and K2's and K3's records at them."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {}
    t_piece = time.perf_counter()
    res["deepfm"] = _deepfm_cell(torch, pt, card, counters)
    t_piece = _piece_seconds("phase 27 (a)", t_piece)
    res["dense_twin"] = _deepfm_dense_twin(torch, pt, card, counters)
    t_piece = _piece_seconds("phase 27 (b)", t_piece)
    res["embedding_row"] = _embedding_row(torch, pt, card, counters)
    t_piece = _piece_seconds("phase 27 (c)", t_piece)
    trainer, res["trainer"] = _deepfm_trainer(torch, pt, card)
    t_piece = _piece_seconds("phase 27 (d)", t_piece)
    res["serving"] = _deepfm_serving(torch, pt, card, trainer)
    del trainer
    _piece_seconds("phase 27 (e)", t_piece)
    _free_trainer(torch, "phase 27")
    print(json.dumps({"sparse": res}))
    a, b = res["deepfm"], res["dense_twin"]
    errs = {"gather_rows": max(r["max_abs_err"] for r in a["k2"].values()),
            "scatter_add_rows": max(r["max_abs_err"] for r in b["k3"].values()),
            "fused_adam": max(a["k6"]["max_abs_err"], b["k6"]["max_abs_err"])}
    return {"launches": {k: v - a["bf16_launches"][k] for k, v in a["launches"].items()},
            "bf16_launches": a["bf16_launches"], "max_abs_err": errs,
            "k2_shapes": a["k2"], "k3_shapes": b["k3"], "step_ms_median": a["step_ms_median"]}


# ---------------------------------------------------------------- phase 28

# the data path: phase 27 (a)'s DeepFM at the Criteo width trained from
# RecordIO shards written here by the port's native writer from
# models/deepfm.py's seeded feed.  DATA_SHARDS shards of DATA_CHUNKS chunks,
# a chunk one batch of FM_B samples (a dispatch task), and one held-out
# shard of one chunk for (c); a record is the C-order bytes of a sample's
# arrays in declaration order, as open_files decodes them: 26 int64 ids,
# 13 float32 dense features, one int64 label (268 bytes)
DATA_SHARDS, DATA_CHUNKS, DATA_SEED = 4, 4, 2800
DATA_STEPS = DATA_SHARDS * DATA_CHUNKS
DATA_RECORD = np.dtype([("ids", "<i8", (26,)), ("dense", "<f4", (13,)), ("label", "<i8", (1,))])
DATA_ORDER = [f"C{i}" for i in range(26)] + ["dense", "label"]
# launches a step of (a) and (b) (phase 27 (a)'s), of an eval replay in (c)
DATA_PER_STEP = {"gather_rows": 52, "fused_adam": 1, "scatter_add_rows": 0, "fused_sgd": 0}
DATA_BF16_PER_STEP = {"flash_attn_fwd": 0, "scatter_add_rows": 0, "linear_ce_fwd": 0}
DATA_EVAL_PER_RUN = {"gather_rows": 52, "fused_adam": 0, "scatter_add_rows": 0, "fused_sgd": 0}
DATA_EVAL_RUNS = 5
DATA_LEASE_S = 60.0
# (c): the auc op (float32 rates and trapezoid) against the float64
# trapezoid at the same 200 thresholds and against metrics.Auc over the
# thresholds' 199 buckets (the same ROC points)
AUC_TOL = 1e-5


def _data_records(feed):
    """The FM_B records of one synthetic_feed batch, as bytes."""
    rec = np.empty(FM_B, dtype=DATA_RECORD)
    rec["ids"] = np.concatenate([feed[f"C{i}"] for i in range(26)], axis=1)
    rec["dense"] = feed["dense"]
    rec["label"] = feed["label"].astype(np.int64)
    raw, n = rec.tobytes(), DATA_RECORD.itemsize
    return [raw[k * n:(k + 1) * n] for k in range(FM_B)]


def _data_sample(rec):
    """One record as (a)'s sample tuple in DATA_ORDER: 26 [1] int64 ids,
    the dense features, the label as float32 (deepfm.data_layers')."""
    ids = np.frombuffer(rec, np.int64, 26, 0).reshape(26, 1)
    return (*ids, np.frombuffer(rec, np.float32, 13, 208),
            np.frombuffer(rec, np.int64, 1, 260).astype(np.float32))


def _data_shards(root):
    """Write the shards and the held-out shard with the native writer;
    returns (shard paths, held-out path, the training batches' feeds in
    task order, the held-out feed, seconds)."""
    from paddle_tpu_torch import recordio
    from paddle_tpu_torch.models.deepfm import synthetic_feed
    t0 = time.perf_counter()
    paths, feeds = [], []
    for s in range(DATA_SHARDS + 1):
        path = os.path.join(root, f"criteo-{s}.rio")
        chunk_bytes = FM_B * (DATA_RECORD.itemsize + 4)
        with recordio.Writer(path, max_chunk_bytes=chunk_bytes, use_native=True) as w:
            for _ in range(DATA_CHUNKS if s < DATA_SHARDS else 1):
                feeds.append(synthetic_feed(DATA_SEED + len(feeds), FM_B))
                for r in _data_records(feeds[-1]):
                    w.write(r)
        paths.append(path)
    return paths[:-1], paths[-1], feeds[:-1], feeds[-1], time.perf_counter() - t0


def _data_net(pt, ids, dense, label):
    """DeepFM over the field ids and dense features; returns the loss, the
    batch AUC (layers.auc over [1 - p, p]) and p."""
    from paddle_tpu_torch.models import deepfm
    logits = deepfm.deepfm(ids, dense, deepfm.CRITEO_VOCAB, embed_dim=FM_DIM, hidden=FM_HIDDEN)
    loss = pt.layers.mean(pt.layers.sigmoid_cross_entropy_with_logits(x=logits, label=label))
    prob = pt.layers.sigmoid(logits)
    predict = pt.layers.concat([pt.layers.scale(prob, scale=-1.0, bias=1.0), prob], axis=1)
    return loss, pt.layers.auc(input=predict, label=label), prob


def _persist_tensors(torch, program, scope):
    """The names of ``program``'s persistables that are tensors in
    ``scope`` (a py_reader's persistable reader holds its queue)."""
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and isinstance(scope.find_var(v.name), torch.Tensor))


def _restore(scope, state0, gen, rng0):
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    gen.set_state(rng0)


def _differing(torch, scope, ref):
    return [n for n, t in ref.items() if not torch.equal(scope.find_var(n), t)]


def _ms_stats(seconds):
    ms = [1e3 * s for s in seconds]
    return {"ms": ms, "median": float(np.median(ms)), "min": min(ms), "max": max(ms),
            "examples_per_s": FM_B / (float(np.median(ms)) / 1e3)}


def _data_host(pt, shards, payload):
    """Host ms a batch of FM_B records: the native and the Python scanner
    over one shard (DATA_CHUNKS batches), (a)'s task reader (Python chunk
    read and decode) and its DataFeeder, (b)'s open_files reader (native
    scan, decode, stack); best of 3 rounds."""
    from paddle_tpu_torch import recordio
    from paddle_tpu_torch.data_feeder import DataFeeder
    from paddle_tpu_torch.dispatch import read_chunk

    def best(fn, per):
        out = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0) / per)
        return min(out)
    main = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, pt.Program()):
        from paddle_tpu_torch.models import deepfm
        ids, dense, label = deepfm.data_layers(26)
    feeder = DataFeeder(feed_list=ids + [dense, label], program=main)
    batch = [_data_sample(r) for ch in payload["chunks"]
             for r in read_chunk(payload["path"], ch["offset"])]
    out = {"scan_native_ms": best(lambda: list(recordio.scan(shards[0], use_native=True)),
                                  DATA_CHUNKS),
           "scan_python_ms": best(lambda: list(recordio.scan(shards[0], use_native=False)),
                                  DATA_CHUNKS),
           "dispatch_task_read_decode_ms": best(
               lambda: [_data_sample(r) for ch in payload["chunks"]
                        for r in read_chunk(payload["path"], ch["offset"])], 1),
           "data_feeder_ms": best(lambda: feeder.feed(batch), 1)}
    with pt.scope_guard(pt.Scope()), pt.unique_name.guard(), \
            pt.program_guard(pt.Program(), pt.Program()):
        reader = pt.layers.open_files([shards[0]], shapes=[[1]] * 26 + [[13], [1]],
                                      dtypes=["int64"] * 26 + ["float32", "int64"],
                                      thread_num=1, batch_size=FM_B)
    out["open_files_scan_decode_stack_ms"] = best(lambda: list(reader._paddle_reader()),
                                                  DATA_CHUNKS)
    return out


def _data_dispatch(torch, pt, card, counters, shards):
    """Phase 28 (a): a dead rank's lease reaped by Trainer(dispatch=...) on
    construction, an epoch of DATA_STEPS steps from the master's RecordIO
    tasks; returns (the trainer, its state before training, the generator
    and its state then, the readings)."""
    from paddle_tpu_torch import dispatch
    from paddle_tpu_torch.models import deepfm
    cell = {}

    def train_func():
        ids, dense, label = deepfm.data_layers(26)
        loss, auc, prob = _data_net(pt, ids, dense, label)
        cell["prob"] = prob
        return [loss, auc]

    def task_reader(payload):
        for ch in payload["chunks"]:
            yield [_data_sample(r) for r in dispatch.read_chunk(payload["path"], ch["offset"])]

    tasks = dispatch.make_recordio_tasks(shards)
    if len(tasks) != DATA_STEPS or any(c["nrecords"] != FM_B for t in tasks for c in t["chunks"]):
        raise AssertionError(f"phase 28: {len(tasks)} tasks {tasks[:2]}")
    with dispatch.DispatchMaster(tasks, lease_timeout_s=DATA_LEASE_S, sweep_interval_s=1.0) as m:
        dead = dispatch.DispatchClient(m.addr, worker="rank0", timeout_s=30.0)
        held = dead.get_task()
        dead.close()                         # rank0 dies holding task 0's lease
        t0 = time.perf_counter()
        with pt.unique_name.guard():
            trainer = pt.Trainer(
                train_func, lambda: pt.optimizer.Adam(learning_rate=FM_LR),
                place=pt.CUDAPlace(0),
                dispatch=dispatch.DispatchConfig(addr=m.addr, task_reader=task_reader,
                                                 worker="rank0", reap_on_start=True,
                                                 timeout_s=30.0))
        init_s = time.perf_counter() - t0
        reaped = m.stats()["counters"]["worker_reaps"]
        scope = trainer.scope
        persist = _persist_tensors(torch, trainer.train_program, scope)
        state0 = {n: scope.find_var(n).clone() for n in persist}
        gen = trainer.exe._scope_generator(trainer.train_program, scope)
        rng0 = gen.get_state()
        for f in counters.values():
            f.launches = 0
            if hasattr(f, "bf16_launches"):
                f.bf16_launches = 0
        bf16_before = _bf16_snapshot(counters)
        run = _TrainerRun(trainer, counters)
        t0 = time.perf_counter()
        trainer.train(1, run, reader=None, feed_order=DATA_ORDER)
        losses = run.losses()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_snapshot(counters)
        bf16 = _delta(_bf16_snapshot(counters), bf16_before)
        st = m.stats()
    reader = trainer.dispatch_reader
    recs = pt.telemetry.STEPS.records()[-DATA_STEPS:]
    step_s = [r["step_time_s"] for r in recs[1:]]        # step 0 holds the capture
    res = {"init_s": init_s, "held_task": held["task_id"], "reaped_on_start": reaped,
           "losses": losses, "wall_s": wall, "steps": len(losses), "consumed": reader.consumed,
           "tasks_finished": reader.tasks_finished, "master": st["counters"],
           "done": st["done"], "launches": launches, "bf16_launches": bf16,
           "step": _ms_stats(step_s),
           "wait_ms_median": 1e3 * float(np.median([r["wait_s"] for r in recs[1:]])),
           "run_ms_median": 1e3 * float(np.median([r["run_s"] for r in recs[1:]])),
           "entries": [e["kind"] for e in trainer.exe.cache_info()["entries"]
                       if "C0" in e["feeds"]], "captures": trainer.exe.cache_info()["captures"]}
    print(f"phase 28 (a) Trainer(dispatch=DispatchConfig(worker='rank0', reap_on_start=True)): "
          f"built and initialized in {init_s:.2f} s; rank0's dead lease on task "
          f"{held['task_id']} reaped on construction ({reaped}); {len(losses)} steps over "
          f"{len(tasks)} RecordIO chunk tasks in {wall:.2f} s: losses {losses}; consumed "
          f"{reader.consumed}; master {st['counters']} done {st['done']}; step ms after the "
          f"capture {[round(x, 3) for x in res['step']['ms']]} (median "
          f"{res['step']['median']:.3f}, min {res['step']['min']:.3f}, max "
          f"{res['step']['max']:.3f}; {res['step']['examples_per_s']:.0f} examples/s; the "
          f"loop's wait for the stager {res['wait_ms_median']:.3f} ms, run "
          f"{res['run_ms_median']:.3f} ms a step); launches {launches} [{card}]")
    per_step = _gate_trainer_steps(run, "phase 28 (a)", DATA_PER_STEP, DATA_BF16_PER_STEP,
                                   steps=DATA_STEPS)
    c = st["counters"]
    if not st["done"] or (c["finished"], c["served"], c["worker_reaps"], c["lease_expiry"],
                          c["stale_finish"], c["dead"]) != (DATA_STEPS, DATA_STEPS + 1, 1, 0, 0,
                                                            0) \
            or reaped != 1 or reader.tasks_finished != DATA_STEPS \
            or sorted(reader.consumed) != list(range(DATA_STEPS)):
        raise AssertionError(f"phase 28 (a): the master {st}, reaped on start {reaped}, the "
                             f"reader finished {reader.tasks_finished} of {reader.consumed}")
    if res["entries"] != ["graph"] or not np.isfinite(losses).all() or any(bf16.values()) \
            or [r["step"] for r in recs] != list(range(DATA_STEPS)):
        raise AssertionError(f"phase 28 (a): entries {res['entries']}, losses {losses}, bf16 "
                             f"{bf16}, step records {[r['step'] for r in recs]}")
    res["launches_a_step"] = per_step
    return trainer, cell, state0, gen, rng0, res


def _data_control(trainer, feeds, order, state0, gen, rng0, label):
    """The feed-dict control: the trainer's step program run by its
    executor (the same graph) on ``feeds`` in ``order`` from the start
    state and generator state; returns the host ms a step (each ends with
    the loss on the host)."""
    _restore(trainer.scope, state0, gen, rng0)
    step_s = []
    for k in order:
        t0 = time.perf_counter()
        trainer.exe.run(trainer._step_program, feed=feeds[k], fetch_list=trainer.train_outputs,
                        scope=trainer.scope)
        step_s.append(time.perf_counter() - t0)
    if trainer.exe.cache_info()["captures"] != 1:
        raise AssertionError(f"phase 28 {label}: the control captured a graph of its own")
    return step_s


def _data_open_files(torch, pt, card, counters, trainer, shards, state0, gen, rng0):
    """Phase 28 (b): the same network over open_files + read_file (the
    trainer's scope and state, thread_num=1), two passes through
    EOFException / reset(); returns the readings and the final state."""
    from paddle_tpu_torch import recordio
    scope = trainer.scope
    main, startup = pt.Program(), pt.Program()
    with pt.scope_guard(scope), pt.unique_name.guard(), pt.program_guard(main, startup):
        reader = pt.layers.open_files(shards, shapes=[[1]] * 26 + [[13], [1]],
                                      dtypes=["int64"] * 26 + ["float32", "int64"],
                                      thread_num=1, batch_size=FM_B)
        outs = pt.layers.read_file(reader)
        loss, auc, _ = _data_net(pt, outs[:26], outs[26], pt.layers.cast(outs[27], "float32"))
        pt.optimizer.Adam(learning_rate=FM_LR).minimize(loss)
    mine = _persist_tensors(torch, main, scope)
    if mine != sorted(state0):
        raise AssertionError(f"phase 28 (b): state names differ from (a)'s: "
                             f"{sorted(set(mine) ^ set(state0))[:6]}")
    exe = pt.Executor(pt.CUDAPlace(0))
    _restore(scope, state0, gen, rng0)
    recordio.reset_scans()
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "bf16_launches"):
            f.bf16_launches = 0
    bf16_before = _bf16_snapshot(counters)
    losses, step_s, passes = [], [], []
    t0 = time.perf_counter()
    for _ in range(2):
        reader.start()
        n = 0
        while True:
            t1 = time.perf_counter()
            try:
                (lv, _) = exe.run(main, fetch_list=[loss, auc], scope=scope)
            except pt.EOFException:
                reader.reset()
                break
            step_s.append(time.perf_counter() - t1)
            losses.append(float(np.asarray(lv)))
            n += 1
        passes.append(n)
    wall = time.perf_counter() - t0
    launches = _launch_snapshot(counters)
    bf16 = {k: v - bf16_before[k] for k, v in _bf16_snapshot(counters).items()}
    scans = recordio.scans()
    entries = [e["kind"] for e in exe.cache_info()["entries"] if e["feeds"]]
    later = step_s[1:]                  # the first run holds the capture
    res = {"passes": passes, "losses": losses, "wall_s": wall, "scans": scans,
           "launches": launches, "bf16_launches": bf16, "entries": entries,
           "captures": exe.cache_info()["captures"], "step": _ms_stats(later),
           "capture_step_ms": 1e3 * step_s[0]}
    print(f"phase 28 (b) open_files(4 shards, thread_num=1) + read_file, two passes: "
          f"{passes} steps, {wall:.2f} s; losses {losses[:3]} ... {losses[-3:]}; step ms after "
          f"the capture: median {res['step']['median']:.3f} (min {res['step']['min']:.3f}, max "
          f"{res['step']['max']:.3f}; {res['step']['examples_per_s']:.0f} examples/s); the "
          f"capture's step {res['capture_step_ms']:.1f} ms; records scanned {scans}; cache "
          f"entries {entries}, captures {res['captures']}; launches {launches} (bf16 {bf16}) "
          f"[{card}]")
    want = {k: (2 * DATA_STEPS + 1) * v for k, v in DATA_PER_STEP.items()}
    if passes != [DATA_STEPS, DATA_STEPS] or entries != ["graph"] or res["captures"] != 1 \
            or {k: launches[k] for k in want} != want or any(bf16.values()) \
            or any(v for k, v in launches.items() if k not in want) \
            or scans["native"] != 2 * DATA_STEPS * FM_B or scans["python"] \
            or not np.isfinite(losses).all():
        raise AssertionError(f"phase 28 (b): {res}; want launches {want} (the capture's eager "
                             f"run and {2 * DATA_STEPS} replays), native scans only")
    return res, exe


def _data_eval(card, counters, trainer, cell, held_feed):
    """Phase 28 (c): the trained model's clone(for_test=True) with its
    layers.auc on the held-out batch: one graph, K2 52 a replay, the AUC
    against metrics.Auc and a float64 trapezoid."""
    from paddle_tpu_torch import metrics
    test_prog = trainer.train_program.clone(for_test=True)
    auc_name, prob_name = trainer.train_outputs[1].name, cell["prob"].name
    fetch = [auc_name, prob_name]
    exe, scope = trainer.exe, trainer.scope
    captures = exe.cache_info()["captures"]
    exe.run(test_prog, feed=held_feed, fetch_list=fetch, scope=scope)    # the capture
    for f in counters.values():
        f.launches = 0
    step_s, outs = [], []
    for _ in range(DATA_EVAL_RUNS):
        t0 = time.perf_counter()
        outs.append(exe.run(test_prog, feed=held_feed, fetch_list=fetch, scope=scope))
        step_s.append(time.perf_counter() - t0)
    launches = _launch_snapshot(counters)
    auc = float(np.asarray(outs[-1][0]))
    prob = np.asarray(outs[-1][1]).reshape(-1)
    label = held_feed["label"].reshape(-1)
    m = metrics.Auc(num_thresholds=199)
    m.update(np.stack([1 - prob, prob], 1), label)
    thr = np.linspace(0.0, 1.0, 200).astype(np.float32).astype(np.float64)
    pos = prob[None, :].astype(np.float64) > thr[:, None]
    tpr = (pos * label).sum(1) / max(label.sum(), 1.0)
    fpr = (pos * (1 - label)).sum(1) / max((1 - label).sum(), 1.0)
    f64 = float(-np.trapezoid(tpr, fpr))
    p, n = prob[label == 1], prob[label == 0]
    exact = float(((p[:, None] > n[None, :]).sum() + 0.5 * (p[:, None] == n[None, :]).sum())
                  / (len(p) * len(n)))
    captured = exe.cache_info()["captures"] - captures
    res = {"captured": captured, "auc": auc, "metrics_auc": float(m.eval()),
           "float64_trapezoid": f64, "exact_rank_auc": exact, "ms": _ms_stats(step_s),
           "launches": launches,
           "same": all(float(np.asarray(o[0])) == auc for o in outs)}
    print(f"phase 28 (c) eval clone(for_test=True) on the held-out batch ({FM_B}): AUC {auc!r}; "
          f"metrics.Auc(199 buckets) {res['metrics_auc']!r}, float64 trapezoid {f64!r}, "
          f"exact rank AUC {exact!r}; ms a run {[round(x, 3) for x in res['ms']['ms']]}; "
          f"launches over {DATA_EVAL_RUNS} replays {launches} [{card}]")
    want = {k: DATA_EVAL_RUNS * v for k, v in DATA_EVAL_PER_RUN.items()}
    if abs(auc - f64) > AUC_TOL or abs(auc - m.eval()) > AUC_TOL or not res["same"] \
            or captured != 1 \
            or {k: launches[k] for k in want} != want \
            or any(v for k, v in launches.items() if k not in want):
        raise AssertionError(f"phase 28 (c): {res}; want launches {want}, AUC within {AUC_TOL}")
    return res


def phase_data(torch, card, feed_dict_ms=None):
    """Phase 28 (see the module docstring): the data path.  Returns the
    launches of (a)'s epoch and of (b)'s two passes by kernel (the bf16
    instances apart)."""
    import paddle_tpu_torch as pt
    counters = _counters()
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    res = {}
    try:
        t_piece = time.perf_counter()
        shards, held, feeds, held_feed, write_s = _data_shards(root)
        from paddle_tpu_torch.dispatch import make_recordio_tasks
        res["host"] = _data_host(pt, shards, make_recordio_tasks(shards[:1])[0])
        res["write_s"] = write_s
        # parallel_scan over 4 threads keeps no order: every record once
        from paddle_tpu_torch import recordio
        written = sorted(r for f in feeds for r in _data_records(f))
        res["parallel_scan_4_threads_exact"] = \
            sorted(recordio.parallel_scan(shards, num_threads=4)) == written
        if not res["parallel_scan_4_threads_exact"]:
            raise AssertionError("phase 28: parallel_scan over 4 threads lost or repeated "
                                 "records")
        print(f"phase 28 shards: {DATA_SHARDS} x {DATA_CHUNKS} chunks of {FM_B} records of "
              f"{DATA_RECORD.itemsize} bytes and a held-out chunk written in {write_s:.2f} s "
              f"(parallel_scan over 4 threads: every record once) "
              f"({sum(os.path.getsize(p) for p in shards) / 1e6:.2f} MB); host ms a batch of "
              f"{FM_B}: {json.dumps({k: round(v, 3) for k, v in res['host'].items()})} [{card}]")
        t_piece = _piece_seconds("phase 28 shards", t_piece)
        trainer, cell, state0, gen, rng0, res["dispatch"] = _data_dispatch(
            torch, pt, card, counters, shards)
        t_piece = _piece_seconds("phase 28 (a)", t_piece)
        scope = trainer.scope
        trained = {n: scope.find_var(n).clone() for n in state0}
        ctl_s = _data_control(trainer, feeds, res["dispatch"]["consumed"], state0, gen, rng0,
                              "(a)")
        differ = _differing(torch, scope, trained)
        del trained
        res["dispatch"]["control"] = {"state": len(state0), "differ": differ,
                                      "step": _ms_stats(ctl_s)}
        print(f"phase 28 (a) the feed-dict control (the same batches in the consumed order from "
              f"the same state and generator state): {len(state0) - len(differ)} of "
              f"{len(state0)} state tensors bit-equal, differing {differ[:6]}; control ms a "
              f"step median {res['dispatch']['control']['step']['median']:.3f} (phase 27 (a)'s "
              f"feed-dict replay {feed_dict_ms}) [{card}]")
        if differ:
            raise AssertionError(f"phase 28 (a): the state differs from the feed-dict "
                                 f"control's: {differ[:6]}")
        _data_control(trainer, feeds, list(range(DATA_STEPS)) * 2, state0, gen, rng0, "(b)")
        control_b = {n: scope.find_var(n).clone() for n in state0}
        t_piece = _piece_seconds("phase 28 controls", t_piece)
        res["open_files"], exe_b = _data_open_files(torch, pt, card, counters, trainer, shards,
                                                    state0, gen, rng0)
        differ = _differing(torch, scope, control_b)
        del control_b, state0
        res["open_files"]["control_differ"] = differ
        print(f"phase 28 (b) against the feed-dict control over the same 2 x {DATA_STEPS} "
              f"batches in the files' order: {len(differ)} state tensors differ {differ[:6]} "
              f"[{card}]")
        if differ:
            raise AssertionError(f"phase 28 (b): the state differs from the feed-dict "
                                 f"control's: {differ[:6]}")
        t_piece = _piece_seconds("phase 28 (b)", t_piece)
        res["eval"] = _data_eval(card, counters, trainer, cell, held_feed)
        t_piece = _piece_seconds("phase 28 (c)", t_piece)
        prof = _replay_profile(torch, trainer.exe, trainer._step_program, feeds[0], None,
                               scope, "data", card,
                               {"gather_rows (K2)": 52, "fused_adam (K6)": 1,
                                "scatter_add_rows (K3)": 0, "fused_sgd (K5)": 0},
                               res["dispatch"]["step"]["median"], fetch=trainer.train_outputs,
                               phase=28)
        busy = prof["device_busy_ms_a_step"]
        res["profile"] = prof
        for key in ("dispatch", "open_files"):
            res[key]["idle_share_of_timed_steps"] = 1.0 - busy / res[key]["step"]["median"]
        print(f"phase 28 idle share of the timed steps (1 - the profile's busy {busy:.3f} ms a "
              f"replay over the median step): (a) "
              f"{res['dispatch']['idle_share_of_timed_steps']:.4f}, (b) "
              f"{res['open_files']['idle_share_of_timed_steps']:.4f} [{card}]")
        _piece_seconds("phase 28 profile", t_piece)
        a, b = res["dispatch"], res["open_files"]
        out = {"launches_dispatch": _delta(a["launches"], a["bf16_launches"]),
               "bf16_launches_dispatch": a["bf16_launches"],
               "launches_py_reader": _delta(b["launches"], b["bf16_launches"]),
               "bf16_launches_py_reader": b["bf16_launches"]}
        # the scope holds the 6.9 GB of tables and moments
        del trainer, exe_b, cell, gen, scope
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _free_trainer(torch, "phase 28")
    print(json.dumps({"data": res}, default=str))
    return out


DEC_NMT = dict(src_dict_size=30000, trg_dict_size=30000, word_dim=32, hidden_dim=32,
               beam_size=4, max_len=12)    # the book NMT's width (phase 26's encoder-decoder)
DEC_SOURCES = 64
DEC_REPLAYS = 6
DEC_SCORE_RTOL = 1e-4      # (a): sentence scores, card against the CPU, relative
# (a): an id may differ from the CPU port's only at a near tie: the two
# candidates' totals, both scored in the CPU's arithmetic (float64 sums of
# its step's own float32 inputs), within this fraction of their magnitude.
# Relative, as the scores' gate is: a total after 8 steps is ~-80, where a
# float32 ulp is 7.6e-6, so the two devices' summation orders alone move a
# total by a few 1e-6
DEC_TIE_RTOL = 1e-5
DEC_CLIENTS, DEC_PER_CLIENT, DEC_BATCH, DEC_MAX_SEQ, DEC_SEED = 16, 3, 8, 32, 5
DEC_NEW = (4, 20)          # max_new_tokens, bench.py's decode row
DEC_REF_GEN = 20           # the one-shot programs' tokens (cut to each request's)
DEC_ATTN_CLIENTS = 12
DEC_BEAM_REQUESTS, DEC_BEAM_GEN = 8, 6
DEC_K1_T = (8, 16, 32)     # attention_lm's prefill buckets at max_seq_len 32
FLEET_SOAK_S, FLEET_CLIENTS, FLEET_DEADLINE_S = 6.0, 16, 0.25
FLEET_BUDGET = "64MiB"     # (c) 1: under transformer-base's 0.4 GB of parameters
OTHER_KERNELS = ("scatter_add_rows", "int8_matmul", "abs_max_pair", "quantize_int8", "fused_sgd",
                 "fused_adam", "linear_ce_fwd", "linear_ce_bwd")


def _gate_others_zero(launches, label):
    bad = {k: launches[k] for k in OTHER_KERNELS if launches[k]}
    if bad:
        raise AssertionError(f"phase 29 {label}: kernels off the decode path launched: {bad}")


def _lookup_count(program):
    return sum(o.type == "lookup_table" for o in program.desc.block(0).ops)


def _beam_first_divergence(card_steps, cpu_steps, cpu_inputs, n, end_id):
    """Where source ``n``'s selection first differs between the card's run
    and the CPU's: (step, lane, the card's and the CPU's candidate as
    (parent, id), their totals in the CPU's arithmetic, the gap).  Each
    total is that step's ``beam_search`` total of the candidate (a live
    lane's score plus the token's log-prob, a finished lane's frozen score
    for end_id) summed in float64 from the CPU run's inputs to the step."""
    for t, ((ci, cp, _), (pi, pp, _)) in enumerate(zip(card_steps, cpu_steps)):
        lanes = np.nonzero((ci[n] != pi[n]) | (cp[n] != pp[n]))[0]
        if not len(lanes):
            continue
        b = int(lanes[0])
        pre_ids, pre_sc, logp = cpu_inputs[t]

        def total(parent, tok):
            if pre_ids[n, parent] == end_id:
                return float(pre_sc[n, parent]) if tok == end_id else -1e9
            return float(np.float64(pre_sc[n, parent]) + np.float64(logp[n, parent, tok]))

        card_c, cpu_c = (int(cp[n, b]), int(ci[n, b])), (int(pp[n, b]), int(pi[n, b]))
        tc, tp = total(*card_c), total(*cpu_c)
        return {"step": t, "lane": b, "card": card_c, "cpu": cpu_c, "card_total": tc,
                "cpu_total": tp, "gap": abs(tc - tp),
                "gap_rel": abs(tc - tp) / max(abs(tp), 1e-30)}
    return None


def _decode_beam(torch, pt, card, counters):
    """(a): machine translation's ``infer_network`` at the book width."""
    from paddle_tpu_torch.core.executor import analyze_state, graph_blockers
    from paddle_tpu_torch.dataset import wmt16
    from paddle_tpu_torch.models import machine_translation as mt
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = pt.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        ids_v, scores_v = mt.infer_network(src, **DEC_NMT)
    ops = main.desc.block(0).ops
    lookups = [o.input("Ids")[0] for o in ops if o.type == "lookup_table"]
    steps = [(o.output("selected_ids")[0], o.output("parent_idx")[0],
              o.output("selected_scores")[0]) for o in ops if o.type == "beam_search"]
    step_inputs = [(o.input("pre_ids")[0], o.input("pre_scores")[0], o.input("scores")[0])
                   for o in ops if o.type == "beam_search"]
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    startup.random_seed = 29
    exe.run(startup, scope=scope)
    samples = [s for _, s in zip(range(DEC_SOURCES),
                                 wmt16.test(DEC_NMT["src_dict_size"], DEC_NMT["trg_dict_size"])())]
    longest = max(len(s[0]) for s in samples)
    t_pad = 1 << (longest - 1).bit_length()          # the pow2 bucket
    src_np = np.full((DEC_SOURCES, t_pad, 1), mt.END_ID, np.int64)
    lens = np.zeros((DEC_SOURCES,), np.int32)
    for i, s in enumerate(samples):
        src_np[i, :len(s[0]), 0] = s[0]
        lens[i] = len(s[0])
    feed = {"src": src_np, "src@SEQ_LEN": lens}
    fetch = [ids_v, scores_v]
    state_in, state_out = analyze_state(main.desc.block(0), list(feed))
    blockers = graph_blockers(main, state_in, state_out)
    rep = exe.precompile(main, feed=feed, fetch_list=fetch, scope=scope)
    print(f"phase 29 (a) infer_network {json.dumps(DEC_NMT)}: {len(ops)} ops, "
          f"{len(lookups)} lookup_table, {len(steps)} beam_search; {DEC_SOURCES} sources of "
          f"the synthetic wmt16 padded to {t_pad}; cache entry {rep['kind']} in "
          f"{rep['compile_s']:.3f} s, graph blockers {blockers}, reasons {rep['reasons']} "
          f"[{card}]")
    if len(lookups) != 1 + DEC_NMT["max_len"]:
        raise AssertionError(f"phase 29 (a): {len(lookups)} lookup_table ops, want "
                             f"{1 + DEC_NMT['max_len']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = _launch_snapshot(counters)
    walls, outs = [], None
    for _ in range(DEC_REPLAYS):
        t0 = time.perf_counter()
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope, return_numpy=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = _delta(_launch_snapshot(counters), before)
    peak = torch.cuda.max_memory_allocated()
    if launches["gather_rows"] != len(lookups) * DEC_REPLAYS or launches["flash_attn_fwd"]:
        raise AssertionError(f"phase 29 (a): launches {launches} over {DEC_REPLAYS} replays, "
                             f"want K2 {len(lookups)} a replay and no K1")
    _gate_others_zero(launches, "(a)")
    eager = exe._run_eager(main, feed=feed,
                           fetch_list=fetch + lookups + [n for s in steps for n in s],
                           scope=scope, return_numpy=False)
    if not (torch.equal(outs[0], eager[0]) and torch.equal(outs[1], eager[1])):
        raise AssertionError("phase 29 (a): the replay's SentenceIds / SentenceScores differ "
                             "from the op-by-op run on the card")
    if tuple(outs[0].shape) != (DEC_SOURCES, DEC_NMT["beam_size"], DEC_NMT["max_len"]) or \
            not bool(torch.isfinite(outs[1]).all()):
        raise AssertionError(f"phase 29 (a): SentenceIds {tuple(outs[0].shape)}, scores finite "
                             f"{bool(torch.isfinite(outs[1]).all())}")
    # K2 at the step's shapes: the source table at the source ids, the
    # target table at a mid-decode step's beam ids
    k2 = {}
    mid = len(lookups) // 2
    for label, table, ids in (("src", "src_emb", eager[2]), ("trg", "trg_emb", eager[2 + mid])):
        rec = _k2_at(torch, scope.find_var(table), ids.reshape(-1).to(torch.int32),
                     f"{label} ids", card, phase="phase 29 (a)")
        if not rec["bit_equal"]:
            raise AssertionError(f"phase 29 (a): K2 at [{table}] is not bit-equal to its plain "
                                 f"version")
        k2[f"nmt_{label}"] = rec
    # the CPU port from the same parameters
    persist = [n for n, v in main.desc.block(0).vars.items() if v.persistable]
    cpu_scope, cexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pt.params_from_numpy({n: scope.find_var(n).cpu().numpy() for n in persist}, cpu_scope, "cpu")
    cpu = cexe.run(main, feed=feed, fetch_list=fetch + [n for s in steps for n in s]
                   + [n for s in step_inputs for n in s], scope=cpu_scope)
    card_ids, card_sc = eager[0].cpu().numpy(), eager[1].cpu().numpy()
    base, k = 2 + len(lookups), len(steps)
    card_steps = [tuple(eager[base + 3 * i + j].cpu().numpy() for j in range(3))
                  for i in range(k)]
    cpu_steps = [tuple(cpu[2 + 3 * i + j] for j in range(3)) for i in range(k)]
    cpu_inputs = [tuple(cpu[2 + 3 * k + 3 * i + j] for j in range(3)) for i in range(k)]
    differ = [n for n in range(DEC_SOURCES) if not np.array_equal(card_ids[n], cpu[0][n])]
    ties = []
    for n in differ:
        div = _beam_first_divergence(card_steps, cpu_steps, cpu_inputs, n, mt.END_ID)
        ties.append({"source": n, **(div or {})})
        print(f"phase 29 (a) source {n}: ids differ card vs CPU; {json.dumps(div)} (gate: "
              f"gap_rel < {DEC_TIE_RTOL}) [{card}]")
    same = [n for n in range(DEC_SOURCES) if n not in differ]
    rel = float(np.max(np.abs(card_sc[same] - cpu[1][same]) / np.maximum(np.abs(cpu[1][same]),
                                                                          1e-30)))
    if any("gap_rel" not in t or not t["gap_rel"] < DEC_TIE_RTOL for t in ties):
        raise AssertionError(f"phase 29 (a): ids differ from the CPU port's beyond a near tie: "
                             f"{ties}")
    if not rel <= DEC_SCORE_RTOL:
        raise AssertionError(f"phase 29 (a): scores {rel:.3e} relative from the CPU port's "
                             f"(gate {DEC_SCORE_RTOL})")
    st = _ms_stats(walls)
    st["sentences_per_s"] = DEC_SOURCES / (st["median"] / 1e3)
    prof = _replay_profile(torch, exe, main, feed, None, scope, "beam", card,
                           {"gather_rows (K2)": len(lookups), "flash_attn_fwd (K1)": 0,
                            "scatter_add_rows (K3)": 0},
                           st["median"], fetch=fetch, phase=29)
    res = {"ops": len(ops), "kind": rep["kind"], "blockers": blockers, "reasons": rep["reasons"],
           "capture_s": rep["compile_s"], "replay": st, "peak_bytes": peak,
           "launches": launches, "cpu_ids_differ": ties, "score_rel_err": rel,
           "profile": prof, "k2": k2}
    print(f"phase 29 (a) beam inference ({DEC_SOURCES} sources, beam {DEC_NMT['beam_size']}, "
          f"{DEC_NMT['max_len']} steps, one replay a batch): ms a batch median "
          f"{st['median']:.3f} (min {st['min']:.3f}, max {st['max']:.3f}), "
          f"{st['sentences_per_s']:.1f} sentences/s, idle share "
          f"{prof['idle_share_of_timed_replays']:.4f} of the timed replays, peak "
          f"{peak / 2**20:.1f} MiB; replay bit-equal to op by op; card vs CPU: "
          f"{len(differ)} of {DEC_SOURCES} sources' ids differ (near ties), scores "
          f"{rel:.3e} relative [{card}]")
    del exe, scope
    return res, launches


def _engine_k2_want(eng):
    """K2 launches the engine's dispatched programs hold: each prefill
    batch's program at its seq bucket, and the step program once an
    iteration (one lookup_table each an embedding)."""
    per = {t: _lookup_count(p[0]) for t, p in eng._prefill.items()}
    step = _lookup_count(eng._step_prog)
    recs = eng._records.records()
    return sum(per[r["seq_bucket"]] for r in recs if r["kind"] == "prefill") + \
        step * sum(r["kind"] == "iteration" for r in recs)


def _decode_arm(pt, pre, step, reqs, static):
    """bench.py's decode row, one arm (bench.py:1334-1430)."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.serving import DECODE_SCOPE, DecodeEngine
    telemetry.reset_scope(DECODE_SCOPE)
    eng = DecodeEngine(pre, step, eos_id=0, max_seq_len=DEC_MAX_SEQ, max_batch_size=DEC_BATCH,
                       max_queue=len(reqs) + 1, seed=DEC_SEED, default_timeout_s=300.0,
                       name="bench")
    counters = _counters()
    before = _launch_snapshot(counters)
    try:
        t0 = time.perf_counter()
        results, subs = [None] * len(reqs), [0.0] * len(reqs)

        def post(j):
            subs[j] = time.perf_counter() - t0
            return eng.submit(reqs[j]["prompt"], reqs[j]["max_new"])

        if static:
            for lo in range(0, len(reqs), DEC_BATCH):
                futs = [(j, post(j)) for j in range(lo, min(lo + DEC_BATCH, len(reqs)))]
                for j, f in futs:
                    results[j] = f.result(timeout=300.0)
        else:
            futs = [(j, post(j)) for j in range(len(reqs))]
            for j, f in futs:
                results[j] = f.result(timeout=300.0)
        wall = time.perf_counter() - t0
        st = eng.stats()
    finally:
        eng.close(drain=False)
    launches = _delta(_launch_snapshot(counters), before)
    want_k2 = _engine_k2_want(eng)
    toks = sum(len(r.tokens) for r in results)
    ttft = [sub + r.ttft_s for r, sub in zip(results, subs)]
    per_tok = [r.decode_s / max(1, len(r.tokens)) for r in results]
    row = {"tokens_per_sec": toks / wall, "tokens": toks, "wall_s": wall,
           "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
           "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3,
           "per_token_p50_ms": float(np.percentile(per_tok, 50)) * 1e3,
           "per_token_p99_ms": float(np.percentile(per_tok, 99)) * 1e3,
           "occupancy": st["mean_batch_rows"] / DEC_BATCH,
           "fresh_compiles": st["fresh_compiles_since_warmup"],
           "prefill_batches": st["prefill_batches"], "iterations": st["iterations"],
           "executables_warmed": st["executables_warmed"], "k2_want": want_k2}
    return row, results, launches, eng


def _oneshot_tokens(pt, ref, scope, prompts, gen, eos=0):
    """The decode model's one-shot program (every token of the loop in one
    program) on the card at batch 1, from ``scope``'s parameters; each
    request's tokens cut at its own count (``gen`` may be a list) and at
    the first whole-row EOS, as the engine retires it.  The kernel tier's
    pass is off (``kernels=False``): ``gru_lm``'s one-shot program computes
    a last step nothing reads, and the pass's verification refuses a
    retyped op that is dead (D204), as the JAX package's does; its
    ``lookup_table`` ops launch K2 on the card all the same."""
    exe = pt.Executor(pt.CUDAPlace(0), kernels=False)
    progs = {}
    out = []
    for i, p in enumerate(prompts):
        t = 8 if len(p) <= 8 else 16
        if t not in progs:
            main, startup = pt.Program(), pt.Program()
            with pt.unique_name.guard(), pt.program_guard(main, startup):
                (_i, _l), toks_v = ref(t, max(gen) if isinstance(gen, list) else gen)
            progs[t] = (main, toks_v)
        main, toks_v = progs[t]
        ids = np.full((1, t), eos, np.int64)
        ids[0, :len(p)] = p
        (toks,) = exe.run(main, feed={"ids": ids, "lens": np.array([[len(p)]], np.int32)},
                          fetch_list=[toks_v], scope=scope)
        toks = np.asarray(toks)[0][:gen[i] if isinstance(gen, list) else gen]
        for k in range(len(toks)):
            if np.all(toks[k] == eos):
                toks = toks[:k + 1]
                break
        out.append(toks.astype(np.int64))
    return out


def _staggered(eng, prompts, gens, stagger=0.02):
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            time.sleep(stagger * (i % 4))
            results[i] = eng.generate(prompts[i], max_new_tokens=gens[i], timeout=120.0)
        except Exception as e:  # noqa: BLE001
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180.0)
    if errors:
        raise AssertionError(f"phase 29 (b): clients failed: {errors[:4]}")
    return results


def _k1_decode_shapes(torch, card):
    """K1 at attention_lm's prefill shapes: causal, head_dim 16, B*H 4 (the
    prefill batch bucket of 4 rows, one head), T 8 / 16 / 32."""
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
    from paddle_tpu_torch.serving import decode_models as zoo
    g = torch.Generator().manual_seed(29)
    d, bh, out = zoo.HID, 4, {}
    for t in DEC_K1_T:
        q, k, v = (torch.randn(bh, t, d, generator=g).cuda() for _ in range(3))
        lens = torch.full((bh,), t, dtype=torch.int32, device="cuda")
        scale = d ** -0.5
        o, lse = flash_attn_fwd(q, k, v, lens, True, scale)
        ro, rlse = flash_attn_fwd_plain(q, k, v, lens, True, scale)
        torch.cuda.synchronize()
        err = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
        if not err <= FLASH_TOL:
            raise AssertionError(f"phase 29 K1 T={t} d={d}: max abs err {err} > {FLASH_TOL}")
        fns = [lambda: flash_attn_fwd(q, k, v, lens, True, scale),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q[None], k[None], v[None], is_causal=True, scale=scale)]
        ms, lib_ms = _best(lambda fn: _ms(fn, 200), fns)
        plain_ms = _ms(lambda: flash_attn_fwd_plain(q, k, v, lens, True, scale), 50)
        pairs = bh * t * (t + 1) // 2
        nbytes = 4 * (4 * q.numel() + lse.numel() + lens.numel())
        bound_ms, bound_by = _bound(nbytes, 2 * 2 * d * pairs, TF32_FLOPS / 3)
        out[f"decode_prefill_T{t}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           library_ms=lib_ms, bound_ms=bound_ms,
                                           bound_by=bound_by, bh=bh, t=t, d=d, causal=True)
        print(f"phase 29 K1 flash_attn_fwd decode prefill B*H={bh} T={t} d={d} causal: "
              f"max_abs_err {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}) [{card}]")
    return out


def _decode_engines(torch, pt, card, counters):
    """(b): DecodeEngine with bench.py's decode row (static and continuous
    arms), then attention_lm with staggered ragged clients, then
    beam_gru_lm.  Returns (record, launches of every engine's serving)."""
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.serving import decode_models as zoo
    res, total = {}, dict.fromkeys(counters, 0)

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    pre, step, ref = zoo.gru_lm()
    rs = np.random.default_rng(11)
    reqs = [{"prompt": rs.integers(1, zoo.VOCAB, size=int(rs.integers(1, 11)), dtype=np.int64),
             "max_new": int(rs.integers(DEC_NEW[0], DEC_NEW[1] + 1))}
            for _ in range(DEC_CLIENTS * DEC_PER_CLIENT)]
    arms, toks, engines = {}, {}, {}
    for name, static in (("static", True), ("continuous", False)):
        row, results, launches, eng = _decode_arm(pt, pre, step, reqs, static)
        add(launches)
        row["launches"] = launches
        arms[name], toks[name], engines[name] = row, [np.asarray(r.tokens) for r in results], eng
        if launches["gather_rows"] != row["k2_want"] or launches["flash_attn_fwd"]:
            raise AssertionError(f"phase 29 (b) gru_lm {name}: K2 launched "
                                 f"{launches['gather_rows']} times, the dispatched programs "
                                 f"hold {row['k2_want']} lookup_table ops; K1 "
                                 f"{launches['flash_attn_fwd']}")
        _gate_others_zero(launches, f"(b) gru_lm {name}")
        if row["fresh_compiles"]:
            raise AssertionError(f"phase 29 (b) gru_lm {name}: {row['fresh_compiles']} fresh "
                                 f"compiles after warmup")
    differ = [j for j, (a, b) in enumerate(zip(toks["static"], toks["continuous"]))
              if not np.array_equal(a, b)]
    if differ:
        raise AssertionError(f"phase 29 (b): static and continuous tokens differ at requests "
                             f"{differ[:8]}")
    want = _oneshot_tokens(pt, ref, engines["continuous"].scope, [r["prompt"] for r in reqs],
                           [r["max_new"] for r in reqs])
    bad = [j for j, (g, w) in enumerate(zip(toks["continuous"], want)) if not np.array_equal(
        g.ravel(), w.ravel())]
    if bad:
        j = bad[0]
        raise AssertionError(f"phase 29 (b): {len(bad)} requests differ from the one-shot "
                             f"program, first {j}: {toks['continuous'][j].tolist()} vs "
                             f"{want[j].tolist()}")
    speedup = arms["continuous"]["tokens_per_sec"] / arms["static"]["tokens_per_sec"]
    res["gru_lm"] = {"requests": len(reqs), "static": arms["static"],
                     "continuous": arms["continuous"], "speedup": speedup}
    for name in ("static", "continuous"):
        a = arms[name]
        print(f"phase 29 (b) gru_lm {name}: {a['tokens_per_sec']:.1f} tokens/s ({a['tokens']} "
              f"tokens in {a['wall_s']:.3f} s), TTFT p50 {a['ttft_p50_ms']:.2f} / p99 "
              f"{a['ttft_p99_ms']:.2f} ms, per-token p50 {a['per_token_p50_ms']:.3f} / p99 "
              f"{a['per_token_p99_ms']:.3f} ms, occupancy {a['occupancy']:.3f}, "
              f"{a['prefill_batches']} prefill batches, {a['iterations']} iterations, "
              f"{a['executables_warmed']} warmed, fresh compiles {a['fresh_compiles']}, K2 "
              f"{a['launches']['gather_rows']} = the programs' lookups [{card}]")
    print(f"phase 29 (b) gru_lm: {len(reqs)} requests bit-identical across the arms and to the "
          f"one-shot program on the card; continuous / static {speedup:.3f}x [{card}]")
    del engines

    # attention_lm: K1 once a prefill batch, solo == concurrent
    pre, step, _ = zoo.attention_lm()
    rs = np.random.default_rng(12)
    prompts = [rs.integers(1, zoo.VOCAB, size=int(rs.integers(1, 11)), dtype=np.int64)
               for _ in range(DEC_ATTN_CLIENTS)]
    gens = [int(rs.integers(4, 17)) for _ in prompts]
    solo = DecodeEngine(pre, step, eos_id=0, max_seq_len=DEC_MAX_SEQ, max_batch_size=1,
                        seed=DEC_SEED, name="attn-solo")
    try:
        want = [np.asarray(solo.generate(p, g, timeout=120.0).tokens)
                for p, g in zip(prompts, gens)]
    finally:
        solo.close(drain=False)
    eng = DecodeEngine(pre, step, eos_id=0, max_seq_len=DEC_MAX_SEQ, max_batch_size=DEC_BATCH,
                       seed=DEC_SEED, name="attn")
    try:
        before = _launch_snapshot(counters)
        results = _staggered(eng, prompts, gens)
        launches = _delta(_launch_snapshot(counters), before)
        prefills = sum(r["kind"] == "prefill" for r in eng._records.records())
        k2_want = _engine_k2_want(eng)
        fresh = eng.fresh_compiles_since_warmup
        warmed = len(eng.warmup_reports)
        kinds = sorted({r["kind"] for r in eng.warmup_reports})
    finally:
        eng.close(drain=False)
    add(launches)
    bad = [i for i, (r, w) in enumerate(zip(results, want))
           if not np.array_equal(np.asarray(r.tokens), w)]
    if bad:
        raise AssertionError(f"phase 29 (b) attention_lm: requests {bad} differ from the solo "
                             f"engine's")
    if launches["flash_attn_fwd"] != prefills or launches["gather_rows"] != k2_want:
        raise AssertionError(f"phase 29 (b) attention_lm: K1 {launches['flash_attn_fwd']} for "
                             f"{prefills} prefill batches, K2 {launches['gather_rows']} for "
                             f"{k2_want} lookups")
    _gate_others_zero(launches, "(b) attention_lm")
    if fresh:
        raise AssertionError(f"phase 29 (b) attention_lm: {fresh} fresh compiles after warmup")
    res["attention_lm"] = {"requests": len(prompts), "prefill_batches": prefills,
                           "launches": launches, "executables_warmed": warmed,
                           "warm_kinds": kinds}
    print(f"phase 29 (b) attention_lm: {len(prompts)} staggered ragged clients equal to a solo "
          f"engine's tokens; K1 {launches['flash_attn_fwd']} = {prefills} prefill batches, K2 "
          f"{launches['gather_rows']}; {warmed} warmed ({kinds}), fresh compiles 0 [{card}]")

    # beam_gru_lm against its one-shot program
    pre, step, ref = zoo.beam_gru_lm()
    rs = np.random.default_rng(13)
    prompts = [rs.integers(1, zoo.VOCAB, size=int(rs.integers(1, 9)), dtype=np.int64)
               for _ in range(DEC_BEAM_REQUESTS)]
    eng = DecodeEngine(pre, step, eos_id=0, max_seq_len=16, max_batch_size=DEC_BATCH,
                       seed=DEC_SEED, name="beam")
    try:
        before = _launch_snapshot(counters)
        results = _staggered(eng, prompts, [DEC_BEAM_GEN] * len(prompts))
        launches = _delta(_launch_snapshot(counters), before)
        k2_want = _engine_k2_want(eng)
        fresh = eng.fresh_compiles_since_warmup
        want = _oneshot_tokens(pt, ref, eng.scope, prompts, DEC_BEAM_GEN)
    finally:
        eng.close(drain=False)
    add(launches)
    bad = [i for i, (r, w) in enumerate(zip(results, want))
           if not np.array_equal(np.asarray(r.tokens), w[:len(r.tokens)])]
    if bad or launches["gather_rows"] != k2_want or fresh:
        raise AssertionError(f"phase 29 (b) beam_gru_lm: requests {bad} differ from the one-shot "
                             f"program; K2 {launches['gather_rows']} for {k2_want} lookups; "
                             f"fresh compiles {fresh}")
    _gate_others_zero(launches, "(b) beam_gru_lm")
    res["beam_gru_lm"] = {"requests": len(prompts), "launches": launches}
    print(f"phase 29 (b) beam_gru_lm: {len(prompts)} requests equal to the one-shot program, "
          f"lane for lane; K2 {launches['gather_rows']} [{card}]")
    return res, total


def _soak_client(fd, c, stop, reqs, prompts, note, errors):
    from paddle_tpu_torch.serving import CircuitOpen, RequestTimeout, ServingOverloaded
    model = "tb" if c % 2 else "lm"
    i = c
    while time.perf_counter() < stop:
        t0 = time.perf_counter()
        try:
            if model == "tb":
                fd.infer("tb", reqs[i % len(reqs)], timeout_s=FLEET_DEADLINE_S)
            else:
                p, g = prompts[i % len(prompts)]
                fd.generate("lm", p, max_new_tokens=g, timeout_s=FLEET_DEADLINE_S)
            note(model, "ok", time.perf_counter() - t0)
        except CircuitOpen:
            note(model, "shed_breaker")
            time.sleep(0.002)
        except ServingOverloaded:
            note(model, "shed_overload")
            time.sleep(0.002)
        except RequestTimeout:
            note(model, "timeout")
        except Exception as e:  # noqa: BLE001 -- counted; the gate reads them
            note(model, "error")
            errors.append(f"{model}: {type(e).__name__}: {e}")
        i += 1


def _http_json(url, body, headers):
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _decode_fleet(torch, pt, card, counters):
    """(c): transformer-base serving and gru_lm decode behind one
    EngineManager and FrontDoor."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.serving import (EngineManager, FleetHTTPServer, FrontDoor,
                                          ModelRejected, ServingNonFinite, SwapFailed)
    from paddle_tpu_torch.serving import decode_models as zoo
    root = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    res = {}
    try:
        t_piece = time.perf_counter()
        main, startup = pt.Program(), pt.Program()
        with pt.unique_name.guard(), pt.program_guard(main, startup):
            _infer_func()
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        startup.random_seed = 0
        exe.run(startup, scope=scope)
        d1, d_nan = os.path.join(root, "tb"), os.path.join(root, "tb_nan")
        with pt.scope_guard(scope):
            pt.io.save_persistables(exe, d1, main)
            for n, v in main.desc.block(0).vars.items():
                t = scope.find_var(n)
                if v.persistable and isinstance(t, torch.Tensor) and t.is_floating_point():
                    t.fill_(float("nan"))
            pt.io.save_persistables(exe, d_nan, main)
        del scope, exe
        t_piece = _piece_seconds("phase 29 (c) parameters saved", t_piece)

        # 1. M501 before any build
        small = EngineManager(memory_budget=FLEET_BUDGET)
        built, real = [], small._build_session
        small._build_session = lambda *a, **k: built.append(1) or real(*a, **k)
        try:
            small.load("tb", infer_func=_infer_func, param_path=d1, warmup=False)
        except ModelRejected as e:
            res["rejected"] = {"code": e.code, "predicted_peak_bytes": e.predicted_peak_bytes,
                               "budget_bytes": e.budget_bytes}
        finally:
            small.close()
        if "rejected" not in res or built or res["rejected"]["code"] != "M501":
            raise AssertionError(f"phase 29 (c) 1: the checkpoint over {FLEET_BUDGET} was not "
                                 f"refused before any build ({res.get('rejected')}, built "
                                 f"{len(built)})")
        print(f"phase 29 (c) 1: transformer-base's checkpoint refused over {FLEET_BUDGET}: "
              f"{json.dumps(res['rejected'])}, no session built [{card}]")

        mgr = EngineManager()
        pre, step, _ = zoo.gru_lm()
        dec_kw = dict(eos_id=0, max_seq_len=DEC_MAX_SEQ, max_batch_size=DEC_BATCH,
                      default_timeout_s=60.0)
        try:
            mgr.load("tb", infer_func=_infer_func, param_path=d1, max_batch_size=8,
                     warmup=False)
            mgr.session("tb").inferencer.warmup(BUCKETS, SERVE_SPECS)
            mgr.load_decode("lm", pre, step, seed=DEC_SEED, **dec_kw)
            t_piece = _piece_seconds("phase 29 (c) two models loaded", t_piece)
            reqs = _requests(16, seed=29)
            batch = _batch_feed(reqs, 8)
            canary = {k: v[:1] for k, v in reqs[0].items()}
            before = _launch_snapshot(counters)
            answer = mgr.infer("tb", batch)
            per_batch = _delta(_launch_snapshot(counters), before)
            if per_batch["flash_attn_fwd"] != K1_PER_BATCH or \
                    per_batch["gather_rows"] != K2_PER_BATCH:
                raise AssertionError(f"phase 29 (c): a served batch launched {per_batch}")
            if answer[0].shape != (8, T, VOCAB) or not np.isfinite(answer[0]).all():
                raise AssertionError(f"phase 29 (c): answer {answer[0].shape}")

            # 2. hot swap: equal parameters pass, NaN parameters roll back
            mgr.swap("tb", infer_func=_infer_func, param_path=d1, canary=canary,
                     max_batch_size=8, warmup=False)
            mgr.session("tb").inferencer.warmup(BUCKETS, SERVE_SPECS)
            same = np.array_equal(mgr.infer("tb", batch)[0], answer[0])
            try:
                mgr.swap("tb", infer_func=_infer_func, param_path=d_nan, canary=canary,
                         max_batch_size=8, warmup=False)
                rolled = None
            except SwapFailed as e:
                rolled = type(e.cause).__name__
            kept = np.array_equal(mgr.infer("tb", batch)[0], answer[0])
            version = mgr.models()["tb"]["version"]
            if not (same and kept and rolled == ServingNonFinite.__name__ and version == 2):
                raise AssertionError(f"phase 29 (c) 2: equal-parameter swap answers bit-equal "
                                     f"{same}; NaN swap rolled back by {rolled}; answers kept "
                                     f"{kept}; version {version}")
            res["swap"] = {"equal_swap_bit_equal": same, "nan_swap_cause": rolled,
                           "answers_kept": kept, "version": version}
            print(f"phase 29 (c) 2: swap to equal parameters passed its canary, answers "
                  f"bit-equal; the NaN set raised SwapFailed ({rolled}), v{version}'s answers "
                  f"bit-equal [{card}]")
            t_piece = _piece_seconds("phase 29 (c) swaps", t_piece)

            # 3. the soak: a wedge over the middle third, swap_decode at 2/3
            fd = FrontDoor(mgr, breaker_threshold=5, breaker_backoff_s=0.2,
                           breaker_backoff_max_s=0.4, default_timeout_s=FLEET_DEADLINE_S)
            rs = np.random.default_rng(29)
            prompts = [(rs.integers(1, zoo.VOCAB, size=int(rs.integers(1, 9)), dtype=np.int64),
                        int(rs.integers(2, 9))) for _ in range(32)]
            lock, series, errors = threading.Lock(), {"tb": {}, "lm": {}}, []
            t_start = time.perf_counter()

            def note(model, kind, latency=None):
                with lock:
                    b = series[model].setdefault(int(time.perf_counter() - t_start), {
                        "ok": 0, "shed_breaker": 0, "shed_overload": 0, "timeout": 0,
                        "error": 0, "lat": []})
                    b[kind] += 1
                    if latency is not None:
                        b["lat"].append(latency)

            stats0 = dict(mgr.stats())
            before = _launch_snapshot(counters)
            stop = t_start + FLEET_SOAK_S
            threads = [threading.Thread(target=_soak_client,
                                        args=(fd, c, stop, reqs, prompts, note, errors))
                       for c in range(FLEET_CLIENTS)]
            for t in threads:
                t.start()
            time.sleep(FLEET_SOAK_S / 3.0)
            faults.install(f"delay@serving.backend.tb:s={FLEET_DEADLINE_S * 2.0}", seed=7)
            time.sleep(FLEET_SOAK_S / 3.0)
            faults.install(None)
            t_swap = time.perf_counter()
            mgr.swap_decode("lm", pre, step, seed=23, **dec_kw)
            swap_s = time.perf_counter() - t_swap
            for t in threads:
                t.join(timeout=FLEET_SOAK_S + 60)
            # the breaker closes through its half-open probe
            t0 = time.perf_counter()
            while fd.breaker("tb").snapshot()["state"] != "closed" and \
                    time.perf_counter() - t0 < 10.0:
                try:
                    fd.infer("tb", canary, timeout_s=5.0)
                except Exception:  # noqa: BLE001 -- shed until the backoff ends
                    time.sleep(0.05)
            launches = _delta(_launch_snapshot(counters), before)
            st = mgr.stats()
            fd_stats = fd.breakers()
            lat = sorted(v for m in series.values() for b in m.values() for v in b["lat"])
            p99 = float(np.percentile(lat, 99)) if lat else float("inf")
            totals = {m: {k: sum(b[k] for b in bs.values())
                          for k in ("ok", "shed_breaker", "shed_overload", "timeout", "error")}
                      for m, bs in series.items()}
            soak = {"seconds": FLEET_SOAK_S, "clients": FLEET_CLIENTS,
                    "deadline_s": FLEET_DEADLINE_S, "totals": totals,
                    "admitted_p50_ms": float(np.percentile(lat, 50)) * 1e3 if lat else None,
                    "admitted_p99_ms": p99 * 1e3, "swap_decode_s": swap_s,
                    "breaker_trips": st["breaker_trips"] - stats0["breaker_trips"],
                    "breaker_closes": st["breaker_closes"] - stats0["breaker_closes"],
                    "swaps": st["swaps"] - stats0["swaps"], "breakers": fd_stats,
                    "lm_version": mgr.models()["lm"]["version"],
                    "lm_fresh_compiles": mgr.decode_engine("lm").fresh_compiles_since_warmup,
                    "launches": launches,
                    "series": {m: [{"t": t, **{k: v for k, v in b.items() if k != "lat"},
                                    "p99_ms": float(np.percentile(b["lat"], 99)) * 1e3
                                    if b["lat"] else None}
                                   for t, b in sorted(bs.items())]
                               for m, bs in series.items()}}
            res["soak"] = soak
            print(json.dumps({"fleet_soak": soak}, default=str))
            print(f"phase 29 (c) 3: {FLEET_SOAK_S:.0f} s soak of {FLEET_CLIENTS} clients over "
                  f"tb / lm: {json.dumps(totals)}; admitted p50 {soak['admitted_p50_ms']:.2f} "
                  f"ms, p99 {soak['admitted_p99_ms']:.2f} ms (bound "
                  f"{2 * FLEET_DEADLINE_S * 1e3:.0f}); breaker trips {soak['breaker_trips']}, "
                  f"closes {soak['breaker_closes']}; swap_decode {swap_s:.2f} s -> "
                  f"v{soak['lm_version']}, fresh compiles {soak['lm_fresh_compiles']}; "
                  f"launches K1 {launches['flash_attn_fwd']}, K2 {launches['gather_rows']} "
                  f"[{card}]")
            if errors:
                raise AssertionError(f"phase 29 (c) 3: soak errors: {errors[:4]}")
            if not (soak["breaker_trips"] >= 1 and totals["tb"]["shed_breaker"] >= 1
                    and soak["breaker_closes"] >= 1 and fd_stats["tb"]["state"] == "closed"):
                raise AssertionError(f"phase 29 (c) 3: the wedge did not trip, shed and close "
                                     f"the breaker: {fd_stats}, {totals}")
            if not (soak["swaps"] == 1 and soak["lm_version"] == 2
                    and soak["lm_fresh_compiles"] == 0):
                raise AssertionError(f"phase 29 (c) 3: swap_decode: {soak['swaps']} swaps, "
                                     f"v{soak['lm_version']}")
            if not (totals["tb"]["ok"] and totals["lm"]["ok"]
                    and p99 < 2.0 * FLEET_DEADLINE_S):
                raise AssertionError(f"phase 29 (c) 3: admitted p99 {p99 * 1e3:.1f} ms, bound "
                                     f"{2 * FLEET_DEADLINE_S * 1e3:.0f} ms; {totals}")
            _gate_others_zero(launches, "(c)")
            t_piece = _piece_seconds("phase 29 (c) soak", t_piece)

            # 4. HTTP with a traceparent
            trace_id = os.urandom(16).hex()
            hdr = {"traceparent": f"00-{trace_id}-{os.urandom(8).hex()}-01"}
            short = {k: (v[:1, :8] if v.ndim == 3 else np.minimum(v[:1], 8))
                     for k, v in reqs[1].items()}
            with FleetHTTPServer(fd, host="127.0.0.1") as srv:
                code_i, out_i, h_i = _http_json(
                    srv.address + "/v1/infer",
                    {"model": "tb", "inputs": {k: v.tolist() for k, v in short.items()},
                     "timeout_s": 30.0}, hdr)
                code_g, out_g, h_g = _http_json(
                    srv.address + "/v1/generate",
                    {"model": "lm", "prompt": prompts[0][0].tolist(), "max_new_tokens": 4,
                     "timeout_s": 30.0}, hdr)
            logits = np.asarray(out_i["outputs"][0], np.float32)
            http = {"infer": [code_i, list(logits.shape), h_i.get("traceparent")],
                    "generate": [code_g, out_g.get("tokens"), h_g.get("traceparent")]}
            res["http"] = http
            print(f"phase 29 (c) 4: {srv.address} POST /v1/infer {code_i} logits "
                  f"{list(logits.shape)}, POST /v1/generate {code_g} tokens "
                  f"{out_g.get('tokens')}; sent trace {trace_id}, returned "
                  f"{h_i.get('traceparent')} / {h_g.get('traceparent')} [{card}]")
            if not (code_i == 200 and code_g == 200 and logits.shape == (1, 8, VOCAB)
                    and np.isfinite(logits).all()
                    and all((h or "").split("-")[1:2] == [trace_id] for h in (
                        h_i.get("traceparent"), h_g.get("traceparent")))):
                raise AssertionError(f"phase 29 (c) 4: {http}")
        finally:
            faults.reset()
            mgr.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return res, launches


def phase_decode(torch, card):
    """Phase 29 (see the module docstring): decode serving and the fleet.
    Returns the launches of (a), (b) and (c) by kernel, the bf16 instances
    apart, and K1's and K2's records at the slice's shapes."""
    import paddle_tpu_torch as pt
    counters = _counters()
    bf16 = _bf16_snapshot(counters)
    res = {}
    from paddle_tpu_torch.ops.cuda.rowvec_mm import rowvec_mm
    rowvec = {}
    t_piece = time.perf_counter()
    res["k1"] = _k1_decode_shapes(torch, card)
    k2 = {}
    from paddle_tpu_torch.serving import decode_models as zoo
    g = torch.Generator().manual_seed(30)
    w = torch.randn(zoo.VOCAB, zoo.EMB, generator=g).cuda()
    for label, n in (("decode step, batch 8", DEC_BATCH), ("prefill, 4 x 32", 4 * 32)):
        ids = torch.randint(0, zoo.VOCAB, (n,), generator=g, dtype=torch.int32).cuda()
        rec = _k2_at(torch, w, ids, label, card, phase="phase 29 (b)")
        if not rec["bit_equal"]:
            raise AssertionError(f"phase 29: K2 at [{zoo.VOCAB}, {zoo.EMB}] is not bit-equal")
        k2[f"decode_{label.split(',')[0].replace(' ', '_')}"] = rec
    t_piece = _piece_seconds("phase 29 K1 / K2 at the slice's shapes", t_piece)
    r0 = rowvec_mm.launches
    res["beam"], la = _decode_beam(torch, pt, card, counters)
    rowvec["a"] = rowvec_mm.launches - r0
    k2.update(res["beam"].pop("k2"))
    res["k2"] = k2
    t_piece = _piece_seconds("phase 29 (a)", t_piece)
    r0 = rowvec_mm.launches
    res["engines"], lb = _decode_engines(torch, pt, card, counters)
    rowvec["b"] = rowvec_mm.launches - r0
    t_piece = _piece_seconds("phase 29 (b)", t_piece)
    r0 = rowvec_mm.launches
    res["fleet"], lc = _decode_fleet(torch, pt, card, counters)
    rowvec["c"] = rowvec_mm.launches - r0
    if not rowvec["b"]:
        raise AssertionError("phase 29 (b): attention_lm's decode steps launched no rowvec_mm "
                             "(C7's batch-invariant row-vector product)")
    _piece_seconds("phase 29 (c)", t_piece)
    if _bf16_snapshot(counters) != bf16:
        raise AssertionError("phase 29: a bf16 instance launched")
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"decode": res}, default=str))
    res["rowvec_launches"] = rowvec
    return {"launches_decode": {"a": la, "b": lb, "c": lc}, "k1": res["k1"], "k2": k2,
            "rowvec": rowvec}


# C7's kernel against its plain version (torch.bmm, cuBLAS), float32: each
# element within this fraction of the plain result's largest value (the two
# sum over K in other orders: 1-2 ulp of the larger elements)
ROWVEC_RTOL = 1e-6
ROWVEC_BATCHES = (1, 2, 3, 8)
ROWVEC_HID = 16            # attention_lm's head width (serving/decode_models.py HID)

# the depth, the global batch's rows and the feeds' seed are the runner's
# (tools/pserver_runner.py N_LAYER, ROWS, SEED): 6+6 layers, 64 rows
PS_WARM, PS_TIMED = 2, 6   # (a): steps before the timed ones, timed steps
PS_B_STEPS = 2             # (b): sync steps of the two trainers
PS_C_STEPS = 3             # (c): steps of the distributed table
# (b): two trainers' 32 + 32 rows averaged on the pservers against one local
# step over the 64 rows.  The loss is the mean over all 64 x 256 positions,
# so the two halves' mean gradient is the whole batch's up to rounding; Adam's
# first steps move each element by about lr * sign(g), so an element whose
# gradient is near 0 may move the other way: the gates are the mean loss,
# relative, and each parameter's norm-relative distance
PS_B_LOSS_RTOL = 1e-4
PS_B_PARAM_NREL = 1e-3
# (c): tests/test_dist_lookup_table.py:121's tolerance (the push subtracts
# lr * rows in two roundings, K5 in one fused multiply-add)
PS_C_RTOL, PS_C_ATOL = 1e-4, 1e-6
# (a): kernel launches a trainer step (the forward and backward; the update
# runs on the pservers: K6 once an adam op a round over the two)
PS_TRAINER_PER_STEP = {"flash_attn_fwd": 2 * 3 * N_LAYER, "gather_rows": 4, "scatter_add_rows": 4,
                       "fused_adam": 0, "fused_sgd": 0, "linear_ce_fwd": 1, "linear_ce_bwd": 1}
PS_READY_S = 300.0         # a pserver's start (torch import, program, startup) at most


def _rowvec_case(torch, b, k, n, transposed, g):
    """(x [b, k], y [b, k, n]) on the card as a decode step gives them: the
    probabilities times the value cache, or (``transposed``) the query times
    the key cache read as [b, d, cap]."""
    x = torch.randn(b, k, generator=g).cuda()
    if not transposed:
        x = torch.softmax(x, -1)          # attention probabilities
    if transposed:
        return x, torch.randn(b, n, k, generator=g).cuda().transpose(1, 2)
    return x, torch.randn(b, k, n, generator=g).cuda()


def _rowvec_check(torch, card):
    """C7's kernel (``rowvec_mm``) at attention_lm's decode shapes (cap
    DEC_MAX_SEQ, head width 16, batch DEC_BATCH): against its plain version
    within ROWVEC_RTOL of its largest value, each row bit-equal across batch counts 1, 2, 3, 8,
    and timed beside the plain version and ``torch.matmul``."""
    from paddle_tpu_torch.ops.cuda.rowvec_mm import rowvec_mm, rowvec_mm_plain
    g = torch.Generator().manual_seed(31)
    cases, worst = {}, 0.0
    before = rowvec_mm.launches
    for label, k, n, tr in (("probs_x_v", DEC_MAX_SEQ, ROWVEC_HID, False),
                            ("q_x_kT", ROWVEC_HID, DEC_MAX_SEQ, True)):
        x, y = _rowvec_case(torch, max(ROWVEC_BATCHES), k, n, tr, g)
        full, plain = rowvec_mm(x, y), rowvec_mm_plain(x, y)
        err = float((full - plain).abs().max())
        scale = float(plain.abs().max())
        for b in ROWVEC_BATCHES:
            for r in range(b):
                if not torch.equal(rowvec_mm(x[r:r + 1], y[r:r + 1])[0], full[r]):
                    raise AssertionError(f"C7 rowvec_mm {label}: row {r} alone differs from "
                                         f"the row inside batch {max(ROWVEC_BATCHES)}")
            sub = rowvec_mm(x[:b], y[:b])
            if not torch.equal(sub, full[:b]):
                raise AssertionError(f"C7 rowvec_mm {label}: batch {b} differs from the first "
                                     f"{b} rows of batch {max(ROWVEC_BATCHES)}")
        if err > ROWVEC_RTOL * scale:
            raise AssertionError(f"C7 rowvec_mm {label}: max abs err {err:.3e} against the "
                                 f"plain version > {ROWVEC_RTOL} x its largest value {scale:.3e}")
        bsz = DEC_BATCH
        xb, yb = x[:bsz], y[:bsz]
        x3 = xb.unsqueeze(1)
        nbytes = 4 * (bsz * k + bsz * k * n + bsz * n)
        bound_ms, bound_by = _bound(nbytes, 2 * bsz * k * n)
        cases[label] = {"shape": [bsz, k, n], "max_abs_err": err, "largest": scale,
                        "ms": _ms(lambda: rowvec_mm(xb, yb), 200),
                        "plain_ms": _ms(lambda: rowvec_mm_plain(xb, yb), 200),
                        "library_ms": _ms(lambda: torch.matmul(x3, yb), 200),
                        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes}
        worst = max(worst, err)
        print(f"phase 30 C7 rowvec_mm {label} [{bsz}, 1, {k}] x [{bsz}, {k}, {n}]: max abs err "
              f"{err:.3e} (<= {ROWVEC_RTOL} x {scale:.3e}), every row bit-equal across batches "
              f"{ROWVEC_BATCHES}; kernel {cases[label]['ms']:.4f} ms, plain (bmm) "
              f"{cases[label]['plain_ms']:.4f}, torch.matmul {cases[label]['library_ms']:.4f}, "
              f"bound {bound_ms:.6f} ({bound_by}) [{card}]")
    rowvec_mm.launches = before      # the comparisons' launches are not the path's
    return {"cases": cases, "max_abs_err": worst}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _runner():
    """The ``pserver_runner`` module (tools/ is a directory of scripts)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "paddle_tpu_torch", "tools",
                        "pserver_runner.py")
    spec = importlib.util.spec_from_file_location("pserver_runner", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


class _Cluster:
    """The runner processes of phase 30: each started with its log and its
    JSON record under ``root``; ``stop`` ends them (SIGTERM, then a kill)
    and reads the records."""

    def __init__(self, root, path):
        self.root, self.path, self.procs = root, path, {}

    def start(self, name, *args):
        out = os.path.join(self.root, name + ".json")
        log = open(os.path.join(self.root, name + ".log"), "w")
        p = subprocess.Popen([sys.executable, self.path, *[str(a) for a in args], "--out", out],
                             stdout=log, stderr=subprocess.STDOUT, cwd=os.path.dirname(
                                 os.path.abspath(__file__)))
        self.procs[name] = (p, log, out)
        return p

    def pservers(self, name, model, trainers):
        eps = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
        for i, ep in enumerate(eps):
            self.start(f"{name}_ps{i}", "pserver", ep, trainers,
                       os.path.join(self.root, f"{name}_ps{i}.ready"), "--model", model,
                       "--endpoints", ",".join(eps))
        return eps

    def log_tail(self, name, n=3000):
        try:
            with open(os.path.join(self.root, name + ".log")) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def wait_ready(self, names):
        deadline = time.time() + PS_READY_S
        for name in names:
            ready = os.path.join(self.root, name + ".ready")
            while not os.path.exists(ready):
                p = self.procs[name][0]
                if p.poll() is not None or time.time() > deadline:
                    raise AssertionError(f"phase 30: {name} never became ready:\n"
                                         f"{self.log_tail(name)}")
                time.sleep(0.1)

    def wait(self, name, timeout):
        p = self.procs[name][0]
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 30: {name} did not end in {timeout} s:\n"
                                 f"{self.log_tail(name)}")
        if rc != 0:
            raise AssertionError(f"phase 30: {name} exited {rc}:\n{self.log_tail(name)}")
        with open(self.procs[name][2]) as f:
            return json.load(f)

    def stop(self, names):
        import signal
        for name in names:
            p = self.procs[name][0]
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        records = {}
        for name in names:
            records[name] = self.wait(name, 60)
        return records

    def kill_all(self):
        for p, log, _ in self.procs.values():
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
            log.close()


def _placement(program):
    """The endpoint of each parameter the trainer program's recvs pull
    (its endpoint attrs name the live servers: the runners were started
    on them)."""
    return {op.attr("param_name"): op.attr("endpoint") for op in program.desc.block(0).ops
            if op.type == "recv"}


def _pserver_params(torch, placement, min_round):
    """Every parameter as the pservers hold it after ``min_round`` rounds,
    on the card."""
    from paddle_tpu_torch.distributed.pserver import PServerClient
    return {n: torch.from_numpy(PServerClient.for_endpoint(ep).get_param(n, min_round)).cuda()
            for n, ep in placement.items()}


def _first_differing(torch, got, want, order):
    for n in order:
        if not torch.equal(got[n], want[n]):
            return n, float((got[n].double() - want[n].double()).abs().max())
    return None


def _local_control(torch, pt, runner, steps):
    """The local training of transformer-base on the card from the stamped
    startup (the pservers' own): each step's loss, the parameters after
    each step (device clones), and each step's wall seconds."""
    from paddle_tpu_torch.transpiler.distribute_transpiler import _stamp_init_seeds
    main, startup, loss = runner.build(pt, "transformer")
    _stamp_init_seeds(startup)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    names = sorted(p.name for p in main.global_block.vars.values()
                   if getattr(p, "trainable", False))
    init = {n: scope.find_var(n).clone() for n in names}
    losses, after, walls = [], [], []
    for step in range(steps):
        feed = runner.global_feed("transformer", runner.ROWS["transformer"], runner.SEED + step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        walls.append(time.perf_counter() - t0)
        losses.append(float(lv))
        after.append({n: scope.find_var(n).clone() for n in names})
    del exe, scope
    return {"names": names, "init": init, "losses": losses, "after": after, "walls": walls}


def _ps_kernels(torch, pt, runner, card):
    """Phase 30's kernels at the shapes its arms run them, each against its
    plain version ((a)'s trainer runs phase 7's shapes, 64 rows, which
    phases 1-7 hold).  K6 once a parameter, as (a)'s and (b)'s pservers
    launch it (one ``adam`` op a launch), over transformer-base's 186
    updates from the stamped startup's state and the first step's
    gradients; K1, K2, K3, K7 and K8 at (b)'s trainer shapes (trainer 0's
    32 rows of the first global batch: B*H 256, 8,192 ids and loss rows).
    Returns each kernel's largest absolute error."""
    from paddle_tpu_torch.ops.cuda.embedding import (gather_rows, gather_rows_plain,
                                                     scatter_add_rows, scatter_add_rows_plain)
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam_multi, fused_adam_multi_plain
    from paddle_tpu_torch.ops.cuda.linear_ce import (linear_ce_bwd, linear_ce_bwd_plain,
                                                     linear_ce_fwd, linear_ce_fwd_plain)
    from paddle_tpu_torch.transpiler.distribute_transpiler import _stamp_init_seeds
    main, startup, _ = runner.build(pt, "transformer")
    _stamp_init_seeds(startup)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    ops = main.desc.block(0).ops
    ups = [o for o in ops if o.type == "adam"]
    slots = ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
    state0 = {o.input(sl)[0]: scope.find_var(o.input(sl)[0]).clone() for o in ups for sl in slots}
    feed = runner.global_feed("transformer", runner.ROWS["transformer"], runner.SEED)
    outs = exe.run(main, feed=feed, fetch_list=[o.input("Grad")[0] for o in ups], scope=scope)
    grads = {o.input("Param")[0]: torch.from_numpy(np.asarray(g)).to("cuda", torch.float32)
             for o, g in zip(ups, outs)}
    del exe, scope, outs
    errs, ok = {}, {}
    ((b1, b2, eps),) = {(o.attr("beta1"), o.attr("beta2"), o.attr("epsilon")) for o in ups}
    k6_err, k6_ok = 0.0, True
    for o in ups:
        e = (state0[o.input("Param")[0]], grads[o.input("Param")[0]],
             *(state0[o.input(sl)[0]] for sl in slots[1:]), False)
        (mine,) = fused_adam_multi([_adam_clones(e)], b1, b2, eps)
        (theirs,) = fused_adam_multi_plain([_adam_clones(e)], b1, b2, eps)
        pairs = list(zip(mine, theirs))
        k6_err = max(k6_err, _max_abs_diff(torch, pairs))
        k6_ok = k6_ok and all(torch.equal(x, y) for x, y in pairs)
    errs["fused_adam"], ok[f"fused_adam x {len(ups)}"] = k6_err, k6_ok and len(ups) == N_PARAMS
    half = runner.share(feed, 0, 2)
    rows = half["lbl"].shape[0]
    g = torch.Generator().manual_seed(30)
    scale = D_HEAD ** -0.5
    errs["flash_attn_fwd"] = 0.0
    for lens_name, causal in (("src@SEQ_LEN", False), ("trg@SEQ_LEN", True)):
        q, k, v = (torch.randn(rows * H, T, D_HEAD, generator=g).cuda() for _ in range(3))
        lens = torch.from_numpy(np.repeat(half[lens_name], H)).cuda()
        out, lse = flash_attn_fwd(q, k, v, lens, causal, scale)
        ref, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, scale)
        err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        errs["flash_attn_fwd"] = max(errs["flash_attn_fwd"], err)
        ok[f"flash_attn_fwd causal={causal}"] = err <= FLASH_TOL
    errs["gather_rows"] = errs["scatter_add_rows"] = 0.0
    positions = torch.arange(T, dtype=torch.int32).repeat(rows).cuda()
    lookups = [o for o in ops if o.type == "lookup_table"]
    for o in lookups:
        w, name = state0[o.input("W")[0]], o.input("Ids")[0]
        ids = (torch.from_numpy(half[name].astype(np.int32)).reshape(-1).cuda()
               if name in half else positions)
        out, ref = gather_rows(w, ids), gather_rows_plain(w, ids)
        errs["gather_rows"] = max(errs["gather_rows"], (out - ref).abs().max().item())
        ok[f"gather_rows {o.input('W')[0]}"] = torch.equal(out, ref)
        d_rows = 1e-3 * torch.randn(ids.numel(), w.shape[1], generator=g)
        got = scatter_add_rows(w, ids, d_rows.cuda()).cpu()
        want = scatter_add_rows_plain(w.cpu(), ids.cpu(), d_rows)
        errs["scatter_add_rows"] = max(errs["scatter_add_rows"], (got - want).abs().max().item())
        ok[f"scatter_add_rows {o.input('W')[0]}"] = torch.equal(got, want)
    (ce,) = [o for o in ops if o.type == "fused_fc_softmax_ce"]
    w, b = state0[ce.input("W")[0]], (state0[ce.input("Bias")[0]] if ce.input("Bias") else None)
    x = torch.randn(rows * T, D_MODEL, generator=g).cuda()
    labels = torch.from_numpy(half["lbl"].astype(np.int32)).reshape(-1).cuda()
    gl = torch.full((rows * T,), 1.0 / (rows * T), device="cuda")
    lse, lab = linear_ce_fwd(x, w, b, labels)
    r_lse, r_lab = linear_ce_fwd_plain(x, w, b, labels)
    dx, dw, db = linear_ce_bwd(x, w, b, labels, lse, gl)
    r_dx, r_dw, r_db = linear_ce_bwd_plain(x, w, b, labels, r_lse, gl)
    fwd = [(lse, r_lse), (lab, r_lab)]
    bwd = [(a, r) for a, r in ((dx, r_dx), (dw, r_dw), (db, r_db)) if a is not None]
    errs["linear_ce_fwd"] = max((a - r).abs().max().item() for a, r in fwd)
    errs["linear_ce_bwd"] = max((a - r).abs().max().item() for a, r in bwd)
    ok["linear_ce_fwd"] = max(_rel(a, r) for a, r in fwd) <= CE_RTOL
    ok["linear_ce_bwd"] = max(_rel(a, r) for a, r in bwd) <= CE_RTOL
    torch.cuda.synchronize()
    print(f"phase 30 kernels at the arms' shapes against their plain versions: K6 once a "
          f"parameter over the {len(ups)} updates of the first step (bit-equal), K1 at B*H "
          f"{rows * H} T {T} d {D_HEAD} (tol {FLASH_TOL}), K2 and K3 (bit-equal, K3's plain "
          f"version on the CPU) on the {len(lookups)} tables at {rows} x {T} ids, K7 and K8 at "
          f"[{rows * T}, {D_MODEL}] x [{D_MODEL}, {w.shape[1]}] (tol {CE_RTOL} relative): ok "
          f"{ok}; max abs err {errs} [{card}]")
    if not all(ok.values()) or len(lookups) != 4:
        raise AssertionError(f"phase 30: a kernel differs from its plain version at the arms' "
                             f"shapes: {ok}, {errs}")
    return errs


def _ps_a(torch, pt, runner, card, cluster, eps, control):
    """(a): one trainer (this process) through two pservers, parameters
    bit-equal to the local control after every step: those the trainer's
    recv fetched from the pservers at the next step (the round before's),
    and after the last step those fetched with ``get_param``.  Each timed
    step runs in a ``torch.profiler`` window of its own (the trainer's
    device busy time); the pservers' device time a round is theirs
    (``pserver_runner``'s ``_DeviceRounds``)."""
    counters = _counters()
    rows = runner.ROWS["transformer"]
    main, startup, loss = runner.build(pt, "transformer")
    t = runner.transpile(pt, main, startup, eps, 1, 0)
    prog = t.get_trainer_program()
    placement = _placement(prog)
    names = control["names"]
    if sorted(placement) != names:
        raise AssertionError(f"phase 30 (a): recv pulls {len(placement)} parameters, the model "
                             f"has {len(names)}")
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    steps = PS_WARM + PS_TIMED
    walls, stages, losses, busy = [], [], [], []
    launches = None
    for step in range(steps):
        feed = runner.global_feed("transformer", rows, runner.SEED + step)
        if step == PS_WARM:
            before = _launch_snapshot(counters)
        out = {}

        def run():
            t0 = time.perf_counter()
            (out["loss"],) = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
            out["wall"] = time.perf_counter() - t0

        torch.cuda.synchronize()
        if step < PS_WARM:
            run()
        else:
            rec = _profile(torch, run, f"phase 30 (a) timed step {step - PS_WARM}", card,
                           {"step": step})
            busy.append(None if rec is None else rec["device_busy_ms"])
        walls.append(out["wall"])
        stages.append(dict(exe.last_host_stages))
        lv = out["loss"]
        losses.append(float(lv))
        if step == steps - 1:
            launches = _delta(_launch_snapshot(counters), before)
        # the parameters the step's recv fetched: the pservers' after the
        # step before
        want = control["after"][step - 1] if step else control["init"]
        bad = _first_differing(torch, {n: scope.find_var(n) for n in names}, want, names)
        if bad:
            raise AssertionError(f"phase 30 (a) step {step}: the {bad[0]} that recv fetched "
                                 f"differs from the local parameter after step {step - 1} by "
                                 f"{bad[1]:.3e} (the first of the update order that does)")
        if lv != control["losses"][step]:
            raise AssertionError(f"phase 30 (a) step {step}: loss {lv!r} against the local "
                                 f"step's {control['losses'][step]!r}")
    got = _pserver_params(torch, placement, steps)
    bad = _first_differing(torch, got, control["after"][steps - 1], names)
    if bad:
        raise AssertionError(f"phase 30 (a) step {steps - 1}: the pservers' {bad[0]} differs "
                             f"from the local step's by {bad[1]:.3e} (the first of the update "
                             f"order that does)")
    del got
    per_step = {k: launches[k] / PS_TIMED for k in launches}
    want = PS_TRAINER_PER_STEP
    if {k: per_step[k] for k in want} != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"phase 30 (a): the trainer launched {per_step} a step, want {want}")
    graphs = [e for e in exe._cache.values() if e.graph is not None]
    if len(graphs) != 1:
        raise AssertionError(f"phase 30 (a): {len(graphs)} graphs, want the step's body as one")
    records = cluster.stop([f"a_ps{i}" for i in range(2)])
    timed = walls[PS_WARM:]
    tstages = stages[PS_WARM:]
    rounds, ps_dev = [], []
    k6 = []
    for rec in records.values():
        rounds.append(rec["round_s"][PS_WARM:PS_WARM + PS_TIMED])
        dev = rec.get("round_device_ms")
        ps_dev.append(None if dev is None else dev[PS_WARM:PS_WARM + PS_TIMED])
        after = rec["launches_after_round"]
        k6.append([after[r]["fused_adam"] - after[r - 1]["fused_adam"]
                   for r in range(PS_WARM, PS_WARM + PS_TIMED)])
    k6_round = [a + b for a, b in zip(*k6)]
    if set(k6_round) != {N_PARAMS}:
        raise AssertionError(f"phase 30 (a): the pservers launched K6 {k6_round} times a timed "
                             f"round over the two, want {N_PARAMS} (one an adam op)")
    ps_launches = {}
    for rec in records.values():
        for k, v in rec["launches"].items():
            ps_launches[k] = ps_launches.get(k, 0) + v - rec["launches_before"][k]
    med = float(np.median(timed))
    tokens = rows * T
    local_med = float(np.median(control["walls"][PS_WARM:]))
    round_ms = [max(a, b) * 1e3 for a, b in zip(*rounds)]
    # the card's idle share over the timed steps: the trainer's device busy
    # time (its windows) and the pservers' (their rounds, which end inside
    # the trainer's steps) over the steps' wall time.  Without MPS the
    # processes' work takes turns on the card, so the sum is their union
    if None in busy or None in ps_dev:
        idle = None
    else:
        idle = 1.0 - (sum(busy) + sum(sum(d) for d in ps_dev)) / (sum(timed) * 1e3)
    ps_dev_round = None if None in ps_dev else [a + b for a, b in zip(*ps_dev)]
    res = {
        "steps": steps, "timed": PS_TIMED, "step_ms": [w * 1e3 for w in timed],
        "step_ms_median": med * 1e3, "step_ms_spread": (max(timed) - min(timed)) * 1e3,
        "recv_stage_ms": [s["head_s"] * 1e3 for s in tstages],
        "replay_and_d2h_ms": [s["step_s"] * 1e3 for s in tstages],
        "send_stage_ms": [s["tail_s"] * 1e3 for s in tstages],
        "trainer_device_busy_ms": busy,
        "pserver_round_ms": [[r * 1e3 for r in rr] for rr in rounds],
        "pserver_device_ms": ps_dev, "pservers_device_ms_a_round": ps_dev_round,
        "bytes_received_a_step": tstages[-1]["bytes_received"],
        "bytes_sent_a_step": tstages[-1]["bytes_sent"],
        "tokens_per_s": tokens / med, "local_tokens_per_s": tokens / local_med,
        "local_step_ms_median": local_med * 1e3,
        "device_idle_share_timed": idle,
        "trainer_launches_per_step": per_step, "pserver_k6_per_round": k6_round,
        "pserver_params": [len(r["params"]) for r in records.values()],
        "losses": losses}
    shown = "not measured" if idle is None else f"{idle:.4f}"
    print(f"phase 30 (a) transformer-base, {runner.N_LAYER}+{runner.N_LAYER} layers, {rows} x "
          f"{T}, one trainer, two pservers ({res['pserver_params']} parameters): every parameter "
          f"bit-equal to the local step after each of {steps} steps; step "
          f"{res['step_ms_median']:.1f} ms median (spread {res['step_ms_spread']:.1f}) = recv "
          f"stage {np.median(res['recv_stage_ms']):.1f} + replay and D2H "
          f"{np.median(res['replay_and_d2h_ms']):.1f} + send stage "
          f"{np.median(res['send_stage_ms']):.1f}; the trainer's device busy ms a timed step "
          f"{busy}; the pservers' round {np.median(round_ms):.1f} ms (host, the slower), their "
          f"device ms a round {ps_dev_round} (the two summed); bytes a step "
          f"{res['bytes_received_a_step']} in, {res['bytes_sent_a_step']} out; "
          f"{res['tokens_per_s']:.0f} tokens/s against {res['local_tokens_per_s']:.0f} local; "
          f"the card's idle share over the timed steps {shown} [{card}]")
    del exe, scope
    return res, launches, ps_launches


def _ps_b(torch, pt, runner, card, cluster, eps, control):
    """(b): two trainer processes in sync mode, 32 + 32 rows, against the
    local step over 64."""
    for i in range(2):
        cluster.start(f"b_tr{i}", "trainer", ",".join(eps), 2, i, "--model", "transformer",
                      "--steps", PS_B_STEPS)
    trs = [cluster.wait(f"b_tr{i}", 600) for i in range(2)]
    for step in range(PS_B_STEPS):
        if trs[0]["digests"][step] != trs[1]["digests"][step]:
            raise AssertionError(f"phase 30 (b) step {step}: the two trainers received different "
                                 f"parameters")
    mean_loss = [float(np.mean([trs[0]["losses"][s], trs[1]["losses"][s]]))
                 for s in range(PS_B_STEPS)]
    loss_rel = [abs(m - c) / abs(c) for m, c in zip(mean_loss, control["losses"])]
    if max(loss_rel) > PS_B_LOSS_RTOL:
        raise AssertionError(f"phase 30 (b): mean loss {mean_loss} against the local 64-row "
                             f"step's {control['losses'][:PS_B_STEPS]}: relative {loss_rel} > "
                             f"{PS_B_LOSS_RTOL}")
    main, startup, _ = runner.build(pt, "transformer")
    prog = runner.transpile(pt, main, startup, eps, 2, 0).get_trainer_program()
    got = _pserver_params(torch, _placement(prog), PS_B_STEPS)
    want = control["after"][PS_B_STEPS - 1]
    nrel = {n: float((got[n].double() - want[n].double()).norm()
                     / max(float(want[n].double().norm()), 1e-30)) for n in control["names"]}
    worst = max(nrel, key=nrel.get)
    if nrel[worst] > PS_B_PARAM_NREL:
        raise AssertionError(f"phase 30 (b): {worst} on the pservers is {nrel[worst]:.3e} "
                             f"norm-relative from the local step's > {PS_B_PARAM_NREL}")
    records = cluster.stop([f"b_ps{i}" for i in range(2)])
    ps_launches = {}
    for rec in records.values():
        for k, v in rec["launches"].items():
            ps_launches[k] = ps_launches.get(k, 0) + v - rec["launches_before"][k]
    tr_launches = {k: trs[0]["launches"][k] + trs[1]["launches"][k] for k in trs[0]["launches"]}
    res = {"mean_loss": mean_loss, "local_loss": control["losses"][:PS_B_STEPS],
           "loss_rel": loss_rel, "param_nrel_max": nrel[worst], "param_nrel_worst": worst,
           "trainer_step_ms": [[s * 1e3 for s in tr["step_s"]] for tr in trs],
           "trainer_stages": [tr["stages"] for tr in trs],
           "pserver_round_ms": [[r * 1e3 for r in rec["round_s"]] for rec in records.values()],
           "pserver_device_ms": [rec.get("round_device_ms") for rec in records.values()]}
    print(f"phase 30 (b) two trainers x 32 rows, sync mode, {PS_B_STEPS} steps: received "
          f"parameters bit-equal between the trainers each round; mean loss {mean_loss} against "
          f"the local 64-row step's {control['losses'][:PS_B_STEPS]} (relative {max(loss_rel):.2e}"
          f" <= {PS_B_LOSS_RTOL}); worst parameter {worst} {nrel[worst]:.2e} norm-relative "
          f"(<= {PS_B_PARAM_NREL}) [{card}]")
    return res, tr_launches, ps_launches


def _k5_each(torch, ups, state0, grads, card):
    """K5 once an ``sgd`` op, as (c)'s pservers launch it on the dense
    parameters, from the startup's state and the first step's gradients,
    against its plain version (bit-equal): the largest absolute error."""
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_sgd_multi, fused_sgd_multi_plain
    err, equal = 0.0, True
    for o in ups:
        p, lr = state0[o.input("Param")[0]], state0[o.input("LearningRate")[0]]
        g = grads[o.input("Param")[0]]
        (mine,) = fused_sgd_multi([(p.clone(), g, lr)])
        (theirs,) = fused_sgd_multi_plain([(p.clone(), g, lr)])
        err = max(err, (mine - theirs).abs().max().item())
        equal = equal and torch.equal(mine, theirs)
    shapes = [list(state0[o.input("Param")[0]].shape) for o in ups]
    print(f"phase 30 (c) K5 once a dense sgd op ({shapes}) against its plain version: "
          f"bit-equal {equal}, max abs err {err} [{card}]")
    if not equal or not ups:
        raise AssertionError(f"phase 30 (c): K5 differs from its plain version ({err}) or there "
                             f"is no dense sgd op ({len(ups)})")
    return err


def _ps_c(torch, pt, runner, card, cluster, eps):
    """(c): the [10,131,227, 16] distributed table through two pservers
    against the local step with ``is_distributed=False``."""
    from paddle_tpu_torch.distributed.pserver import PServerClient
    from paddle_tpu_torch.transpiler.distribute_transpiler import _stamp_init_seeds
    counters = _counters()
    main, startup, loss = runner.build(pt, "table", is_distributed=False)
    _stamp_init_seeds(startup)
    table = next(op.input("W")[0] for op in main.desc.block(0).ops if op.type == "lookup_table")
    emb_out = next(op.output("Out")[0] for op in main.desc.block(0).ops
                   if op.type == "lookup_table")
    dense = sorted(p.name for p in main.global_block.vars.values()
                   if getattr(p, "trainable", False) and p.name != table)
    ups = [o for o in main.desc.block(0).ops if o.type == "sgd" and o.input("Param")[0] in dense]
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    state0 = {o.input(sl)[0]: scope.find_var(o.input(sl)[0]).clone() for o in ups
              for sl in ("Param", "LearningRate")}
    feeds = [runner.global_feed("table", runner.ROWS["table"], runner.SEED + s)
             for s in range(PS_C_STEPS)]
    touched = []
    ctrl = []
    for s, feed in enumerate(feeds):
        out = exe.run(main, feed=feed, fetch_list=[loss, emb_out] + [o.input("Grad")[0]
                                                                     for o in ups], scope=scope)
        if s == 0:
            grads = {o.input("Param")[0]: torch.from_numpy(np.asarray(gr)).cuda()
                     for o, gr in zip(ups, out[2:])}
        touched = np.unique(np.concatenate([touched, feed["ids"].reshape(-1)])).astype(np.int64)
        ctrl.append({"loss": float(out[0]), "emb": out[1],
                     "rows": scope.find_var(table)[torch.from_numpy(touched).cuda()].cpu().numpy(),
                     "touched": touched,
                     "dense": {n: scope.find_var(n).cpu().numpy() for n in dense}})
    del exe, scope
    k5 = _k5_each(torch, ups, state0, grads, card)
    gc.collect()
    torch.cuda.empty_cache()
    main, startup, loss = runner.build(pt, "table")
    t = runner.transpile(pt, main, startup, eps, 1, 0)
    prog = t.get_trainer_program()
    dl_out = next(op.output("Out")[0] for op in prog.desc.block(0).ops
                  if op.type == "distributed_lookup_table")
    placement = _placement(prog)
    exe, scope = pt.Executor(pt.CUDAPlace(0)), pt.Scope()
    exe.run(startup, scope=scope)
    if scope.find_var(table) is not None:
        raise AssertionError("phase 30 (c): the trainer's startup made the distributed table")
    before = _launch_snapshot(counters)
    stages, walls = [], []
    for s, feed in enumerate(feeds):
        t0 = time.perf_counter()
        out = exe.run(prog, feed=feed, fetch_list=[loss, dl_out], scope=scope)
        walls.append(time.perf_counter() - t0)
        stages.append(dict(exe.last_host_stages))
        if s == 0 and not np.array_equal(out[1], ctrl[0]["emb"]):
            raise AssertionError("phase 30 (c): the prefetched rows differ from the local "
                                 "lookup_table's")
        ids = ctrl[s]["touched"]
        rows = np.zeros((ids.shape[0], runner.TABLE_DIM), np.float32)
        for k, ep in enumerate(eps):
            m = (ids % len(eps)) == k
            rows[m] = PServerClient.for_endpoint(ep).prefetch_rows(table, ids[m])
        np.testing.assert_allclose(rows, ctrl[s]["rows"], rtol=PS_C_RTOL, atol=PS_C_ATOL,
                                   err_msg=f"phase 30 (c) step {s}: touched table rows")
        for n, ep in placement.items():
            np.testing.assert_allclose(PServerClient.for_endpoint(ep).get_param(n, s + 1),
                                       ctrl[s]["dense"][n], rtol=PS_C_RTOL, atol=PS_C_ATOL,
                                       err_msg=f"phase 30 (c) step {s}: {n}")
    launches = _delta(_launch_snapshot(counters), before)
    records = cluster.stop([f"c_ps{i}" for i in range(2)])
    ps_launches = {}
    for rec in records.values():
        for k, v in rec["launches"].items():
            ps_launches[k] = ps_launches.get(k, 0) + v - rec["launches_before"][k]
    if ps_launches["fused_sgd"] < PS_C_STEPS:
        raise AssertionError(f"phase 30 (c): the pservers launched K5 {ps_launches['fused_sgd']}"
                             f" times over {PS_C_STEPS} rounds")
    res = {"steps": PS_C_STEPS, "ids_a_step": runner.TABLE_IDS,
           "unique_ids": [int(np.unique(f["ids"]).size) for f in feeds],
           "step_ms": [w * 1e3 for w in walls],
           "prefetch_ms": [s["head_s"] * 1e3 for s in stages],
           "push_and_send_ms": [s["tail_s"] * 1e3 for s in stages],
           "bytes_received": [s["bytes_received"] for s in stages],
           "bytes_sent": [s["bytes_sent"] for s in stages],
           "pserver_round_ms": [[r * 1e3 for r in rec["round_s"]] for rec in records.values()],
           "pserver_device_ms": [rec.get("round_device_ms") for rec in records.values()],
           "local_losses": [c["loss"] for c in ctrl], "k5": k5}
    print(f"phase 30 (c) distributed table [{runner.TABLE_ROWS}, {runner.TABLE_DIM}] over two "
          f"pservers, {runner.TABLE_IDS} Zipf ids a batch ({res['unique_ids']} unique), "
          f"{PS_C_STEPS} steps: prefetched rows bit-equal to the local lookup_table; touched rows"
          f" and dense parameters within rtol {PS_C_RTOL} / atol {PS_C_ATOL} of the local step "
          f"each step; prefetch {res['prefetch_ms']} ms, push + sends "
          f"{res['push_and_send_ms']} ms a step, bytes in {res['bytes_received']}, out "
          f"{res['bytes_sent']} [{card}]")
    del exe, scope
    return res, launches, ps_launches


def phase_pserver(torch, card):
    """Phase 30 (see the module docstring): C7's kernel, then
    parameter-server training on the card -- (a) transformer-base through
    two pservers bit-equal to local training, (b) two trainers in sync
    mode, (c) the distributed lookup table at the Criteo width.  Returns
    the launches by arm, C7's record and the largest absolute error of
    each kernel held against its plain version at the arms' shapes."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.pserver import PServerClient
    t_piece = time.perf_counter()
    rowvec = _rowvec_check(torch, card)
    t_piece = _piece_seconds("phase 30 C7", t_piece)
    runner, path = _runner()
    root = tempfile.mkdtemp(prefix="chip_smoke_pserver_")
    cluster = _Cluster(root, path)
    res = {"c7": rowvec}
    try:
        eps = {"a": cluster.pservers("a", "transformer", 1),
               "b": cluster.pservers("b", "transformer", 2),
               "c": cluster.pservers("c", "table", 1)}
        control = _local_control(torch, pt, runner, PS_WARM + PS_TIMED)
        t_piece = _piece_seconds("phase 30 local control", t_piece)
        errs = _ps_kernels(torch, pt, runner, card)
        gc.collect()
        torch.cuda.empty_cache()
        t_piece = _piece_seconds("phase 30 kernels at the arms' shapes", t_piece)
        cluster.wait_ready([f"{a}_ps{i}" for a in "abc" for i in range(2)])
        t_piece = _piece_seconds("phase 30 pservers ready", t_piece)
        res["a"], la, la_ps = _ps_a(torch, pt, runner, card, cluster, eps["a"], control)
        t_piece = _piece_seconds("phase 30 (a)", t_piece)
        res["b"], lb, lb_ps = _ps_b(torch, pt, runner, card, cluster, eps["b"], control)
        t_piece = _piece_seconds("phase 30 (b)", t_piece)
        del control
        gc.collect()
        torch.cuda.empty_cache()
        res["c"], lc, lc_ps = _ps_c(torch, pt, runner, card, cluster, eps["c"])
        errs["fused_sgd"] = res["c"]["k5"]
        _piece_seconds("phase 30 (c)", t_piece)
    finally:
        PServerClient.reset_all()
        cluster.kill_all()
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"pserver": res}, default=str))
    return {"launches_pserver": {"a": la, "a_pservers": la_ps, "b": lb, "b_pservers": lb_ps,
                                 "c": lc, "c_pservers": lc_ps},
            "rowvec": rowvec, "max_abs_err": errs}


# ------------------------------------------------------------------ phase 31
# the collective half on the card (ROADMAP §A item 12b): (a) a world of one
# over NCCL, (b) two ranks sharing the card over gloo, (c) the pipeline and
# ring attention over gloo, (d) switch_moe at transformer-base's FFN width
P31_STEPS = 6              # (a): the steps of each path's epoch (and of its timed epoch)
P31_LAYERS = TRAINER_LAYERS  # (a): 2+2 layers at transformer-base's widths (phase 18's cut)
P31_PER_STEP = {"flash_attn_fwd": 2 * 3 * P31_LAYERS, "gather_rows": 4, "scatter_add_rows": 4,
                "fused_adam": 1, "linear_ce_fwd": 1, "linear_ce_bwd": 1}
P31_AXES = {"data": -1, "fsdp": 1, "tp": 1}
P31_B_STEPS = 2            # (b): steps of each layout
P31_B_LAYERS = TRAINER_LAYERS  # (b): 2+2 layers (the eager gloo steps run op by op)
P31_B_LOSS_RTOL = 1e-5     # (b): the global mean loss against the one-process 64-row step
P31_B_PARAM_NREL = 1e-3    # (b): the worst parameter, norm-relative (phase 30 (b)'s gate)
P31_PIPE_ROWS = 32         # (c): the pipeline's batch (8 rows a microbatch)
P31_PIPE_MICRO = 4
P31_RING_ROWS = 2          # (c): ring attention's batch at T 256, 8 heads x d 64
# (c): pipelined / ring outputs and every parameter gradient against one
# process on the card, norm-relative.  The gradient gate is phase 9's and
# phase 30 (b)'s: the one-process step on the card itself is 2.3e-4 to
# 5.0e-4 off the CPU's on these gradients (NVIDIA H100 80GB HBM3, 700 W;
# the pipeline 1.9e-4 to 4.2e-4 off the CPU), float32 at T 256
P31_C_NREL = 1e-5
P31_C_GRAD_NREL = 1e-3
P31_MOE_TOKENS = 16384     # (d): x [16,384, 512], 8 experts, d_hidden 2048, capacity 1.25
P31_MOE_EXPERTS = 8
P31_MOE_LR = 0.1
# (d): the card's step against the plain CPU step from the same parameters,
# norm-relative, TF32 off: the output, the aux loss, every gradient, and
# every updated parameter's change (SGD)
P31_MOE_NREL = 1e-4
P31_MOE_GRAD_NREL = 1e-3
P31_WORKER_S = 600         # (b), (c): a worker pair's limit


def _p31_train_func(pt, n_layer):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer

    def train_func():
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                            n_layer=n_layer, d_model=D_MODEL, n_head=H,
                                            d_inner=D_INNER, fuse_final_ce=True)
        return loss
    return train_func


def _p31_trainer(pt, **kw):
    with pt.unique_name.guard():
        return pt.Trainer(_p31_train_func(pt, P31_LAYERS),
                          lambda: pt.optimizer.Adam(learning_rate=1e-3),
                          place=pt.CUDAPlace(0), **kw)


def _full(t):
    """A scope value's whole tensor (a DTensor gathered: collective)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _p31_persist(program):
    return [v.name for v in program.list_vars() if v.persistable]


def _p31_state(scope, names):
    """Copies of the scope's state tensors (this rank's shards), on the
    card."""
    from paddle_tpu_torch.core.lower import local_of
    return {n: local_of(scope.find_var(n)).clone() for n in names}


def _p31_state_diff(torch, scope, names, want):
    """The state tensors of ``scope`` not bit-equal to the copies ``want``:
    {name: max abs difference}."""
    from paddle_tpu_torch.core.lower import local_of
    bad = {}
    for n in names:
        got = local_of(scope.find_var(n))
        if not torch.equal(got, want[n]):
            bad[n] = float((got.double() - want[n].double()).abs().max())
    return bad


def _p31_first_op(torch, pt, mesh_exe, program, feed, scope, state):
    """On a failed bit-equality gate of (a): the first op whose output
    differs between the mesh executor's eager step and a plain one, from
    ``state`` and ``feed`` (both steps run op by op; the scope is restored)."""
    from paddle_tpu_torch.core.lower import local_of
    from paddle_tpu_torch.profiling.divergence import divergence_report, op_output_names
    names = [n for n in op_output_names(program) if n in set(
        v.name for v in program.list_vars())]
    runs = []
    for exe in (mesh_exe, pt.Executor(pt.CUDAPlace(0))):
        for n, v in state.items():
            local_of(scope.find_var(n)).copy_(v)
        runs.append(dict(zip(names, exe._run_eager(program, feed=feed, fetch_list=names,
                                                   scope=scope))))
    return divergence_report(program, runs[0], runs[1])


def _p31_a(torch, pt, card, counters):
    """(a): a world of one over NCCL on the card.  transformer-base's Adam
    step at 64 x 256 through ``Trainer(layout=SpecLayout(mesh_axes=
    P31_AXES))`` against the plain ``Trainer`` over the same batches from
    the same state: one CUDA graph replay a step, every state tensor
    bit-equal after each step, the launches a step equal; then the same
    through ``ParallelExecutor`` against a plain ``Executor``.  tokens/s of
    a warm epoch each way."""
    from paddle_tpu_torch.core.lower import local_of
    from paddle_tpu_torch.parallel import ParallelExecutor, SpecLayout
    res = {}
    reader = pt.batch(_trainer_samples(P31_STEPS * TRAIN_B, seed=31), TRAIN_B)

    # the plain Trainer: its state after each step, on the host
    t0 = time.perf_counter()
    plain = _p31_trainer(pt)
    names = _p31_persist(plain.train_program)
    start = _p31_state(plain.scope, names)
    snaps = []
    run_p, loss_p = _train_once(plain, reader, counters, {
        i: (lambda tr: snaps.append(_p31_state(tr.scope, names))) for i in range(P31_STEPS)})
    per_p = _gate_trainer_steps(run_p, "phase 31 (a) plain Trainer", P31_PER_STEP,
                                steps=P31_STEPS)
    timed_p = _timed_epoch(torch, pt, plain, reader, "phase 31 (a) plain Trainer", card)
    del plain, run_p
    _free_trainer(torch, "phase 31 (a) plain Trainer")

    # the same through the layout's Trainer on the one-device NCCL mesh
    layout = SpecLayout(mesh_axes=P31_AXES)
    mt = _p31_trainer(pt, layout=layout)
    mesh = mt.exe.mesh
    if mesh.backend != "nccl" or mesh.size != 1:
        raise AssertionError(f"phase 31 (a): the trainer's mesh is {mesh!r}, want one NCCL rank")
    for n in names:
        local_of(mt.scope.find_var(n)).copy_(start[n])
    bad_steps = []

    def compare(tr):
        i = len(bad_steps)
        bad_steps.append(_p31_state_diff(torch, tr.scope, names, snaps[i]))
    run_m, loss_m = _train_once(mt, reader, counters, {i: compare for i in range(P31_STEPS)})
    per_m = _gate_trainer_steps(run_m, "phase 31 (a) Trainer(layout=)", P31_PER_STEP,
                                steps=P31_STEPS)
    (entry,) = [e for e in mt.exe.cache_info()["entries"] if e["kind"] == "graph"]
    print(f"phase 31 (a) Trainer(layout=SpecLayout(mesh_axes={P31_AXES})) on {mesh!r}: losses "
          f"{loss_m} (plain {loss_p}); state tensors not bit-equal to the plain Trainer's after "
          f"each step {[len(b) for b in bad_steps]} of {len(names)}; launches a step {per_m} "
          f"(plain {per_p}); the step's entry {entry['kind']}, captured in "
          f"{entry['compile_s']} s [{card}]")
    if any(bad_steps) or loss_m != loss_p:
        first = next(i for i, b in enumerate(bad_steps) if b) if any(bad_steps) else 0
        worst = sorted(bad_steps[first].items(), key=lambda kv: -kv[1])[:5]
        raise AssertionError(f"phase 31 (a): the mesh Trainer's state differs from the plain "
                             f"Trainer's after step {first}: {worst}")
    if per_m != per_p:
        raise AssertionError(f"phase 31 (a): launches a step {per_m}, plain {per_p}")
    timed_m = _timed_epoch(torch, pt, mt, reader, "phase 31 (a) Trainer(layout=)", card)
    res["trainer"] = {"losses": loss_m, "launches_a_step": per_m, "tokens_per_s": timed_m[
        "tokens_per_s"], "plain_tokens_per_s": timed_p["tokens_per_s"],
        "capture_s": entry["compile_s"], "state_tensors": len(names)}
    # the mesh paths' launches: this epoch and the timed one, then the
    # ParallelExecutor's steps (not the plain Executor's beside them)
    launches = {k: f.launches for k, f in counters.items()}
    del mt, run_m, snaps
    _free_trainer(torch, "phase 31 (a) Trainer(layout=)")

    # ParallelExecutor against a plain Executor, in lockstep
    main, startup, loss = _train_programs(pt, n_layer=P31_LAYERS)
    feeds = [_train_feed(TRAIN_B, seed=3100 + i) for i in range(P31_STEPS)]
    pscope, pexe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    pexe.run(startup, scope=pscope)
    names = _p31_persist(main)
    start = _p31_state(pscope, names)
    mscope = pt.Scope()
    pexe.run(startup, scope=mscope)
    for n in names:
        local_of(mscope.find_var(n)).copy_(start[n])
    pe = ParallelExecutor(loss_name=loss.name, main_program=main, scope=mscope)
    for f in counters.values():
        f.launches = 0
    walls = {"plain": [], "parallel": []}
    bad = []
    for i, feed in enumerate(feeds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (lp,) = pexe.run(main, feed=feed, fetch_list=[loss], scope=pscope)
        walls["plain"].append(time.perf_counter() - t0)
        before = {k: f.launches for k, f in counters.items()}
        t0 = time.perf_counter()
        (lm,) = pe.run(fetch_list=[loss.name], feed=feed)
        walls["parallel"].append(time.perf_counter() - t0)
        after = {k: f.launches for k, f in counters.items()}
        for k in launches:
            launches[k] += after[k] - before[k]
        diff = _p31_state_diff(torch, mscope, names, _p31_state(pscope, names))
        if diff or float(lp) != float(lm):
            report = _p31_first_op(torch, pt, pe._executor, main, feed, mscope,
                                   _p31_state(pscope, names)) if i == 0 else ""
            raise AssertionError(f"phase 31 (a): ParallelExecutor step {i} differs from the "
                                 f"plain step: loss {float(lm)} vs {float(lp)}, "
                                 f"{len(diff)} state tensors, worst "
                                 f"{sorted(diff.items(), key=lambda kv: -kv[1])[:5]}; {report}")
        bad.append({k: after[k] - before[k] for k in P31_PER_STEP})
    pe_info = pe._executor.cache_info()
    captures = pe_info["captures"]
    per_pe = bad[1:]
    if captures != 1 or any(p != P31_PER_STEP for p in per_pe):
        raise AssertionError(f"phase 31 (a): ParallelExecutor captures {captures}, launches a "
                             f"step after the first {per_pe}, want 1 and {P31_PER_STEP}")
    med = {k: float(np.median(v[1:])) for k, v in walls.items()}
    res["parallel_executor"] = {
        "steps": len(feeds), "captures": captures, "launches_a_step": per_pe[0],
        "tokens_per_s": TRAIN_B * T / med["parallel"],
        "plain_tokens_per_s": TRAIN_B * T / med["plain"],
        "reasons": pe_info["entries"][-1]["reasons"]}
    print(f"phase 31 (a) ParallelExecutor on {pe.mesh!r}: {len(feeds)} steps bit-equal to the "
          f"plain Executor's (every state tensor and the loss), one capture, launches a step "
          f"{per_pe[0]}; {res['parallel_executor']['tokens_per_s']:.0f} tokens/s against "
          f"{res['parallel_executor']['plain_tokens_per_s']:.0f} (host clock to the loss, "
          f"medians of the warm steps, the two in turns) [{card}]")
    del pe, pexe, pscope, mscope
    _free_trainer(torch, "phase 31 (a) ParallelExecutor")
    return res, launches


def _p31_start(arm, env=None):
    """Phase 31 (b) or (c), phase 32 (a) or (c): start two processes of
    ``python3 chip_smoke.py --collective-worker`` that share the card over
    gloo (``env``: variables added to their environment); returns their
    handle for :func:`_p31_finish`."""
    root = tempfile.mkdtemp(prefix="chip_smoke_collective_")
    port = _free_port()
    procs = []
    for rank in range(2):
        out = os.path.join(root, f"{arm}_{rank}.json")
        log = open(os.path.join(root, f"{arm}_{rank}.log"), "w")
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--collective-worker",
                              arm, str(rank), str(port), out], stdout=log,
                             stderr=subprocess.STDOUT, env={**os.environ, **(env or {})},
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        procs.append((p, log, out))
    return arm, root, procs, time.time() + P31_WORKER_S


def _p31_finish(handle):
    """Wait for a worker pair (killed at its limit), print their lines, and
    return each rank's record; each rank's failure fails the phase."""
    arm, root, procs, deadline = handle
    try:
        for p, _, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        recs, failed = [], []
        for rank, (p, log, out) in enumerate(procs):
            log.close()
            with open(log.name) as f:
                text = f.read()
            print(f"worker {arm} rank {rank} log:\n" + "\n".join(
                line for line in text.splitlines()
                if line.startswith(("phase 31", "phase 32", "collectives"))))
            if p.returncode != 0 or not os.path.exists(out):
                failed.append(f"rank {rank} exited {p.returncode}:\n{text[-3000:]}")
                continue
            with open(out) as f:
                recs.append(json.load(f))
        if failed:
            raise AssertionError(f"worker pair {arm}: " + "\n".join(failed))
        return recs
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
        shutil.rmtree(root, ignore_errors=True)


def _p31_rows_kernels(torch, ops, scope, feed, rows, g, errs, ok):
    """K1, K2, K3, K7 and K8 at a rank's ``rows`` of the batch ``feed``
    against their plain versions, into ``errs`` and ``ok``."""
    from paddle_tpu_torch.ops.cuda.embedding import (gather_rows, gather_rows_plain,
                                                     scatter_add_rows, scatter_add_rows_plain)
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
    from paddle_tpu_torch.ops.cuda.linear_ce import (linear_ce_bwd, linear_ce_bwd_plain,
                                                     linear_ce_fwd, linear_ce_fwd_plain)
    scale = D_HEAD ** -0.5
    errs["flash_attn_fwd"] = 0.0
    for lens_name, causal in (("src@SEQ_LEN", False), ("trg@SEQ_LEN", True)):
        q, k, v = (torch.randn(rows * H, T, D_HEAD, generator=g).cuda() for _ in range(3))
        lens = torch.from_numpy(np.repeat(feed[lens_name], H)).cuda()
        out, lse = flash_attn_fwd(q, k, v, lens, causal, scale)
        ref, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, scale)
        err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
        errs["flash_attn_fwd"] = max(errs["flash_attn_fwd"], err)
        ok[f"flash_attn_fwd causal={causal}"] = err <= FLASH_TOL
    errs["gather_rows"] = errs["scatter_add_rows"] = 0.0
    positions = torch.arange(T, dtype=torch.int32).repeat(rows).cuda()
    for o in [o for o in ops if o.type == "lookup_table"]:
        w, name = _full(scope.find_var(o.input("W")[0])), o.input("Ids")[0]
        ids = (torch.from_numpy(feed[name].astype(np.int32)).reshape(-1).cuda()
               if name in feed else positions)
        out, ref = gather_rows(w, ids), gather_rows_plain(w, ids)
        errs["gather_rows"] = max(errs["gather_rows"], (out - ref).abs().max().item())
        ok[f"gather_rows {o.input('W')[0]}"] = torch.equal(out, ref)
        d_rows = 1e-3 * torch.randn(ids.numel(), w.shape[1], generator=g)
        got = scatter_add_rows(w, ids, d_rows.cuda()).cpu()
        want = scatter_add_rows_plain(w.cpu(), ids.cpu(), d_rows)
        errs["scatter_add_rows"] = max(errs["scatter_add_rows"], (got - want).abs().max().item())
        ok[f"scatter_add_rows {o.input('W')[0]}"] = torch.equal(got, want)
    (ce,) = [o for o in ops if o.type == "fused_fc_softmax_ce"]
    w = _full(scope.find_var(ce.input("W")[0]))
    b = _full(scope.find_var(ce.input("Bias")[0])) if ce.input("Bias") else None
    x = torch.randn(rows * T, D_MODEL, generator=g).cuda()
    labels = torch.from_numpy(feed["lbl"].astype(np.int32)).reshape(-1).cuda()
    gl = torch.full((rows * T,), 1.0 / (rows * T), device="cuda")
    lse, lab = linear_ce_fwd(x, w, b, labels)
    r_lse, r_lab = linear_ce_fwd_plain(x, w, b, labels)
    dx, dw, db = linear_ce_bwd(x, w, b, labels, lse, gl)
    r_dx, r_dw, r_db = linear_ce_bwd_plain(x, w, b, labels, r_lse, gl)
    fwd = [(lse, r_lse), (lab, r_lab)]
    bwd = [(a, r) for a, r in ((dx, r_dx), (dw, r_dw), (db, r_db)) if a is not None]
    errs["linear_ce_fwd"] = max((a - r).abs().max().item() for a, r in fwd)
    errs["linear_ce_bwd"] = max((a - r).abs().max().item() for a, r in bwd)
    ok["linear_ce_fwd"] = max(_rel(a, r) for a, r in fwd) <= CE_RTOL
    ok["linear_ce_bwd"] = max(_rel(a, r) for a, r in bwd) <= CE_RTOL


def _p31_kernels_at(torch, pt, main, scope, feed, rows, card, label, only_k6=False):
    """Each rank's kernels at its local shapes against their plain
    versions: K1 at B*H ``rows * H``, K2 and K3 on the four tables at the
    rank's ids, K7 and K8 at ``rows * T`` rows, K6 over the rank's shards
    of every parameter (half of each under fsdp); ``only_k6``: K6 alone.
    Returns the largest absolute errors."""
    from paddle_tpu_torch.core.lower import local_of
    from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam_multi, fused_adam_multi_plain
    g = torch.Generator().manual_seed(31)
    ops = main.desc.block(0).ops
    errs, ok = {}, {}
    if not only_k6:
        _p31_rows_kernels(torch, ops, scope, feed, rows, g, errs, ok)
    ups = [o for o in ops if o.type == "adam"]
    slots = ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
    ((b1, b2, eps),) = {(o.attr("beta1"), o.attr("beta2"), o.attr("epsilon")) for o in ups}
    entries = []
    for o in ups:
        p, m1, m2, p1, p2, lr = (local_of(scope.find_var(o.input(sl)[0])) for sl in slots)
        grad = 1e-3 * torch.randn(p.shape, generator=g).cuda()
        entries.append((p, grad, m1, m2, p1, p2, lr, False))
    mine = fused_adam_multi([_adam_clones(e) for e in entries], b1, b2, eps)
    theirs = fused_adam_multi_plain([_adam_clones(e) for e in entries], b1, b2, eps)
    pairs = [(x, y) for m, t in zip(mine, theirs) for x, y in zip(m, t)]
    errs["fused_adam"] = _max_abs_diff(torch, pairs)
    ok[f"fused_adam over {len(entries)} shards"] = all(torch.equal(x, y) for x, y in pairs)
    torch.cuda.synchronize()
    print(f"{label}: the kernels at this rank's shapes against their plain versions (K1 at B*H "
          f"{rows * H}, K2/K3 at {rows} x {T} ids, K7/K8 at {rows * T} rows, K6 over "
          f"{sum(e[0].numel() for e in entries)} parameter elements in {len(entries)} shards): "
          f"ok {all(ok.values())}; max abs err {errs} [{card}]")
    if not all(ok.values()):
        raise AssertionError(f"{label}: a kernel differs from its plain version: {ok}, {errs}")
    return errs


def _p31_b_rank(torch, pt, rank, card):
    """(b) on one rank: the transformer at P31_B_LAYERS, 64 global rows (32
    this rank's) x 256, P31_B_STEPS Adam steps on ``{"data": 2}`` and on
    ``{"fsdp": 2}`` (gloo on CUDA tensors, host-staged), each from rank 0's
    parameters; rank 0 first takes the same steps alone on the 64 rows.
    The mean loss and every parameter against that run; the state bytes
    this rank holds; its kernels at its local shapes (K6 at each layout's
    shards)."""
    from paddle_tpu_torch.core.lower import local_of
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh, shard_program_state
    counters = _counters()
    out = {}
    feeds = [_train_feed(TRAIN_B, seed=3200 + i) for i in range(P31_B_STEPS)]
    lo, hi = rank * TRAIN_B // 2, (rank + 1) * TRAIN_B // 2
    t_piece = time.perf_counter()
    start = ref = ref_loss = None
    if rank == 0:
        # the one-process 64-row steps, op by op, from the startup's state
        main, startup, loss = _train_programs(pt, n_layer=P31_B_LAYERS)
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        start = {n: scope.find_var(n).clone() for n in _p31_persist(main)}
        ref_loss = [float(exe._run_eager(main, feed=f, fetch_list=[loss], scope=scope)[0])
                    for f in feeds]
        ref = {p.name: scope.find_var(p.name).clone()
               for p in main.global_block.all_parameters()}
        del scope, exe
        t_piece = _piece_seconds("phase 31 (b) rank 0's one-process steps", t_piece)
    for axes in ({"data": 2}, {"fsdp": 2}):
        key = next(iter(axes))
        main, startup, loss = _train_programs(pt, n_layer=P31_B_LAYERS)
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        names = _p31_persist(main)
        params = [p.name for p in main.global_block.all_parameters()]
        if start is not None:
            for n in names:
                scope.find_var(n).copy_(start[n])
        mesh = make_mesh(axes, host_staged=True)
        layout = SpecLayout(mesh_axes=axes)
        mexe = pt.Executor(mesh=mesh, layout=layout)
        shard_program_state(main, scope, mesh, layout)
        state_bytes = sum(local_of(scope.find_var(n)).numel() * local_of(scope.find_var(n))
                          .element_size() for n in names)
        t_piece = _piece_seconds(f"phase 31 (b) {axes} rank {rank} programs, startup and "
                                 f"placement", t_piece)
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        losses = [float(mexe.run(main, feed={k: v[lo:hi] for k, v in f.items()},
                                 fetch_list=[loss], scope=scope)[0]) for f in feeds]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        final = {n: scope.find_var(n).full_tensor() for n in params}
        rec = {"losses": losses, "state_bytes_a_rank": state_bytes, "wall_s": wall,
               "launches": launches, "reasons": mexe.cache_info()["entries"][-1]["reasons"]}
        if rank == 0:
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_loss))
            worst = max((_norm_rel(final[n].cpu().numpy(), ref[n].cpu().numpy()), n)
                        for n in params)
            rec.update(ref_losses=ref_loss, loss_rel=loss_rel, worst_param_nrel=worst[0],
                       worst_param=worst[1])
            print(f"phase 31 (b) {axes}: mean loss {losses} against the one-process 64-row "
                  f"step's {ref_loss} (worst relative {loss_rel:.3e}, gate {P31_B_LOSS_RTOL}); "
                  f"worst parameter {worst[1]} {worst[0]:.3e} norm-relative (gate "
                  f"{P31_B_PARAM_NREL}); state {state_bytes} bytes a rank; {P31_B_STEPS} steps "
                  f"in {wall:.2f} s [{card}]")
            if loss_rel > P31_B_LOSS_RTOL or worst[0] > P31_B_PARAM_NREL:
                raise AssertionError(f"phase 31 (b) {axes}: outside the gates: loss {loss_rel}, "
                                     f"{worst}")
        rec["max_abs_err"] = _p31_kernels_at(torch, pt, main, scope,
                                             {k: v[lo:hi] for k, v in feeds[0].items()},
                                             TRAIN_B // 2, card, f"phase 31 (b) {axes} rank {rank}",
                                             only_k6=key == "fsdp")
        t_piece = _piece_seconds(f"phase 31 (b) {axes} rank {rank} steps and checks", t_piece)
        out[key] = rec
        del mexe, exe, scope, final
        gc.collect()
        torch.cuda.empty_cache()
    if out["fsdp"]["state_bytes_a_rank"] >= out["data"]["state_bytes_a_rank"]:
        raise AssertionError(f"phase 31 (b): fsdp holds {out['fsdp']['state_bytes_a_rank']} "
                             f"state bytes a rank, data {out['data']['state_bytes_a_rank']}")
    return out


def _p31_projection_loss(layers, y):
    """The mean of ``y`` times a fed random tensor ``r`` of its shape: a
    layer_norm's output read through its mean (or its mean square) has an
    input gradient of rounding noise alone, which no gate can hold."""
    r = layers.data(name="r", shape=[T, D_MODEL], dtype="float32")
    return layers.mean(layers.elementwise_mul(y, r))


def _p31_pipe_program(pt):
    """Two transformer-base encoder layers as a two-stage pipeline, and
    their sum as the loss."""
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[T, D_MODEL], dtype="float32")
        pipe = layers.PipelinedStages(input=x, n_stages=2, n_micro=P31_PIPE_MICRO)
        with pipe.block() as s:
            pipe.complete(transformer.encoder_layer(s, D_MODEL, H, D_INNER))
        loss = _p31_projection_loss(layers, pipe.output)
    return main, startup, pipe.output, loss


def _p31_ring_program(pt):
    from paddle_tpu_torch import layers
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[T, D_MODEL], dtype="float32")
        out = layers.multi_head_attention(x, x, x, D_MODEL, H, causal=True,
                                          use_ring_attention=True)
        loss = _p31_projection_loss(layers, out)
    return main, startup, out, loss


def _p31_grads(pt, main, startup, loss):
    """Append the gradients of ``loss`` to ``main``; the parameters and
    their gradients' names."""
    from paddle_tpu_torch.core.desc import grad_var_name
    params = [p.name for p in main.global_block.all_parameters()]
    with pt.program_guard(main, startup):
        pt.append_backward(loss)
    return params, [grad_var_name(p) for p in params]


def _p31_c_rank(torch, pt, rank, card):
    """(c) on one rank: the two-stage pipeline on ``{"pipe": 2}`` and ring
    attention on ``{"seq": 2}`` (gloo on CUDA tensors, ppermute through
    the host), each output and every parameter gradient against the same
    program in one process on the card (rank 0)."""
    from paddle_tpu_torch.parallel import make_mesh
    out = {}
    for name, build, axes, rows in (("pipeline", _p31_pipe_program, {"pipe": 2}, P31_PIPE_ROWS),
                                    ("ring", _p31_ring_program, {"seq": 2}, P31_RING_ROWS)):
        main, startup, y, loss = build(pt)
        params, grads = _p31_grads(pt, main, startup, loss)
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        rs = np.random.RandomState(33)
        feed = {k: rs.randn(rows, T, D_MODEL).astype(np.float32) for k in ("x", "r")}
        fetch = [y.name] + grads
        ref = exe.run(main, feed=feed, fetch_list=fetch, scope=scope) if rank == 0 else None
        mesh = make_mesh(axes, host_staged=True)
        mexe = pt.Executor(mesh=mesh)
        t0 = time.perf_counter()
        got = mexe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        wall = time.perf_counter() - t0
        rec = {"wall_s": wall}
        if rank == 0:
            errs = [_norm_rel(np.asarray(a, np.float64), np.asarray(b, np.float64))
                    for a, b in zip(got, ref)]
            rec.update(out_nrel=errs[0], grad_nrel=max(errs[1:]), grads=len(errs) - 1)
            print(f"phase 31 (c) {name} on {axes} ({rows} x {T} x {D_MODEL}): output "
                  f"{errs[0]:.3e} and the worst of {len(errs) - 1} parameter gradients "
                  f"{max(errs[1:]):.3e} norm-relative against one process (gates {P31_C_NREL}, "
                  f"{P31_C_GRAD_NREL}); {wall:.2f} s [{card}]")
            if errs[0] > P31_C_NREL or max(errs[1:]) > P31_C_GRAD_NREL:
                raise AssertionError(f"phase 31 (c) {name}: outside the gates: {errs}")
        out[name] = rec
        del mexe, exe, scope
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _collective_worker(argv):
    """``chip_smoke.py --collective-worker ARM RANK PORT OUT``: one rank of
    phase 31 (b) or (c) or phase 32 (a) or (c), gloo on the card's CUDA
    tensors."""
    import torch
    arm, rank, port, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as pt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    pt.distributed.init_parallel_env(trainer_id=rank, num_trainers=2,
                                     coordinator_address=f"127.0.0.1:{port}",
                                     place=pt.CUDAPlace(0), backend="gloo")
    res = {"b": _p31_b_rank, "c": _p31_c_rank, "p32a": _p32_a_rank,
           "p32c": _p32_c_rank}[arm](torch, pt, rank, card)
    pt.distributed.barrier()
    with open(out, "w") as f:
        json.dump(res, f)


def _p31_moe_program(pt):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.core.desc import grad_var_name
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[D_MODEL], dtype="float32")
        y, aux = layers.switch_moe(x, num_experts=P31_MOE_EXPERTS, d_hidden=D_INNER,
                                   capacity_factor=1.25)
        loss = layers.elementwise_add(layers.mean(layers.square(y)),
                                      layers.scale(aux, scale=0.01))
        pt.optimizer.SGD(learning_rate=P31_MOE_LR).minimize(loss)
    params = [p.name for p in main.global_block.all_parameters()]
    return main, startup, y, aux, loss, params, [grad_var_name(p) for p in params]


def _p31_d(torch, pt, card):
    """(d): ``switch_moe`` at transformer-base's FFN width in an SGD step
    on the card (x [16,384, 512], 8 experts, d_hidden 2048, capacity
    factor 1.25: a [16,384, 8, 2,560] dispatch tensor), against the plain
    CPU step of the same program from the same parameters."""
    from paddle_tpu_torch.core.lower import local_of
    main, startup, y, aux, loss, params, grads = _p31_moe_program(pt)
    feed = {"x": np.random.RandomState(34).randn(P31_MOE_TOKENS, D_MODEL).astype(np.float32)}
    fetch = [y.name, aux.name, loss.name] + grads
    runs = {}
    for where, place in (("card", pt.CUDAPlace(0)), ("cpu", pt.CPUPlace())):
        scope, exe = pt.Scope(), pt.Executor(place)
        exe.run(startup, scope=scope)
        if where == "card":
            torch.cuda.reset_peak_memory_stats()
            start = {n: scope.find_var(n).cpu() for n in params}
        else:
            for n in params:
                scope.find_var(n).copy_(start[n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        torch.cuda.synchronize()
        runs[where] = {"outs": outs, "s": time.perf_counter() - t0,
                       "params": {n: local_of(scope.find_var(n)).cpu() for n in params}}
        if where == "card":
            runs[where]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del exe, scope
    gc.collect()
    torch.cuda.empty_cache()
    nrel = [_norm_rel(np.asarray(a, np.float64), np.asarray(b, np.float64))
            for a, b in zip(runs["card"]["outs"], runs["cpu"]["outs"])]
    moved = max(_norm_rel((runs["card"]["params"][n] - start[n]).double().numpy(),
                          (runs["cpu"]["params"][n] - start[n]).double().numpy())
                for n in params)
    rec = {"out_nrel": nrel[0], "aux_nrel": nrel[1], "loss_nrel": nrel[2],
           "grad_nrel": max(nrel[3:]), "update_nrel": moved, "card_s": runs["card"]["s"],
           "cpu_s": runs["cpu"]["s"], "card_peak_gib": runs["card"]["peak_gib"], "dispatch_gb": P31_MOE_TOKENS * P31_MOE_EXPERTS
           * int(1.25 * P31_MOE_TOKENS / P31_MOE_EXPERTS) * 4 / 1e9}
    print(f"phase 31 (d) switch_moe (x [{P31_MOE_TOKENS}, {D_MODEL}], {P31_MOE_EXPERTS} experts, "
          f"d_hidden {D_INNER}, capacity factor 1.25; dispatch {rec['dispatch_gb']:.2f} GB) SGD "
          f"step, card against the plain CPU step, norm-relative: out {nrel[0]:.3e}, aux "
          f"{nrel[1]:.3e}, loss {nrel[2]:.3e} (gate {P31_MOE_NREL}), worst of {len(grads)} "
          f"gradients {rec['grad_nrel']:.3e}, worst parameter change {moved:.3e} (gate "
          f"{P31_MOE_GRAD_NREL}); the step {runs['card']['s']:.3f} s on the card (its first: the "
          f"eager run, the capture and a replay; peak {rec['card_peak_gib']:.2f} GiB), "
          f"{runs['cpu']['s']:.3f} s on the CPU [{card}]")
    if max(nrel[:3]) > P31_MOE_NREL or max(rec["grad_nrel"], moved) > P31_MOE_GRAD_NREL:
        raise AssertionError(f"phase 31 (d): outside the gates: {rec}")
    return rec


def phase_collective(torch, card):
    """Phase 31 (see the module docstring): the collective half on the card
    -- (a) a world of one over NCCL through ``Trainer(layout=)`` and
    ``ParallelExecutor``, bit-equal to the plain paths; (b) two ranks
    sharing the card over gloo under ``{"data": 2}`` and ``{"fsdp": 2}``
    against one process's 64-row step; (c) the pipeline and ring attention
    over gloo; (d) ``switch_moe`` at transformer-base's FFN width.
    Returns the launches of (a) and (d) and the kernels' largest errors at
    (b)'s local shapes."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {}
    t_piece = time.perf_counter()
    # (b) and (c)'s worker pairs run while this process takes (d): five
    # processes share the card, so (d)'s seconds are not its alone
    workers = [_p31_start("b"), _p31_start("c")]
    try:
        for f in counters.values():
            f.launches = 0
        res["d"] = _p31_d(torch, pt, card)
        # (d)'s SGD step: K5 updates the five expert parameters in one launch
        d_launches = {k: f.launches for k, f in counters.items()}
        if d_launches["fused_sgd"] < 1:
            raise AssertionError(f"phase 31 (d): K5 never launched: {d_launches}")
        t_piece = _piece_seconds("phase 31 (d), beside the workers", t_piece)
    finally:
        recs = []
        for h in workers:
            try:
                recs.append(_p31_finish(h)[0])
            except AssertionError as e:
                recs.append(e)
    for arm, rec in zip("bc", recs):
        if isinstance(rec, AssertionError):
            raise rec
        res[arm] = rec
    t_piece = _piece_seconds("phase 31 (b) and (c) to their end", t_piece)
    # (a) last: its NCCL group of one is the process's (no worker needs it)
    pt.distributed.init_parallel_env(place=pt.CUDAPlace(0))
    res["a"], launches = _p31_a(torch, pt, card, counters)
    launches = {k: n + d_launches.get(k, 0) for k, n in launches.items()}
    _piece_seconds("phase 31 (a)", t_piece)
    print(json.dumps({"collective": res}, default=str))
    errs = {}
    for k in ("data", "fsdp"):
        for name, e in res["b"][k]["max_abs_err"].items():
            errs[name] = max(errs.get(name, 0.0), e)
    return {"launches": launches, "max_abs_err": errs}


# ------------------------------------------------------------------ phase 32
# sharded state on the card (ROADMAP §A item 12c): (a) bench.py's embedding
# row at its largest TPU size (bench.py:1466-1490) with the table
# row-sharded over two gloo ranks sharing the card, both gradient arms;
# (b) DeepFM with shard_tables=True at the Criteo width through
# Trainer(layout=, health=True) on a world of one over NCCL; (c) a
# transformer-base checkpoint across topologies; (d) health across (c)'s
# ranks.  (a)'s and (c)'s two ranks share one card over gloo: their times
# are no multi-card figure
P32_ROWS, P32_DIM, P32_B = 262144, 128, 1024
P32_LR, P32_STEPS, P32_SEED = 0.125, 3, 17
P32_TABLE = "p32_table"
P32_FM_STEPS = 2
P32_FM_PER_STEP = {"gather_rows": 52, "fused_adam": 1}
P32_C_LAYERS = N_LAYER     # (c), (d): transformer-base at its full 6+6 depth
P32_C_ROWS = 8             # (c): global rows a batch (4 a rank) x T 256
P32_C_STEPS = 2            # (c): the steps before the save (at step 2)
P32_C_GATES = (P31_B_LOSS_RTOL, P31_B_PARAM_NREL)   # (c) (ii): phase 31 (b)'s
# (d): the sentinel's global gradient norm against one process's from the
# same state and global batch, relative: a development run on an NVIDIA
# H100 80GB HBM3 at 700 W read 3.1e-6 (the ranks' sums of squares add in
# another order, and each rank's step runs op by op over gloo while the
# one-process step replays a graph)
P32_SENTINEL_RTOL = 1e-5
P32_NAN_SITE = "chip_smoke.nan_weights"   # a hit puts a NaN into a batch's weights
# the kernels phase 32's main path runs (K4 is not on it)
P32_KERNELS = ("flash_attn_fwd", "gather_rows", "scatter_add_rows", "fused_sgd", "fused_adam",
               "linear_ce_fwd", "linear_ce_bwd")


def _p32_table_program(pt, is_sparse):
    """bench.py's embedding row: ``sharded_table`` -> mean, SGD 0.125."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        emb = pt.embedding.sharded_table(ids, P32_TABLE, rows=P32_ROWS, dim=P32_DIM,
                                         is_sparse=is_sparse)
        loss = pt.layers.mean(emb)
        pt.optimizer.SGD(learning_rate=P32_LR).minimize(loss)
    return main, startup, loss


def _p32_table_feeds():
    rng = np.random.default_rng(P32_SEED)
    return [np.minimum(rng.zipf(1.3, (P32_B, 1)) - 1, P32_ROWS - 1).astype(np.int64)
            for _ in range(P32_STEPS)]


class _KernelTables:
    """The tables K2's and K3's wrappers are handed (their argument check
    runs first on every call)."""

    def __enter__(self):
        from paddle_tpu_torch.ops.cuda import embedding as E
        self.module, self.orig, self.seen = E, E._check, set()

        def spy(name, w, flat_ids, rows=None):
            self.seen.add((name, tuple(w.shape)))
            return self.orig(name, w, flat_ids, rows)
        E._check = spy
        return self

    def __exit__(self, *exc):
        self.module._check = self.orig


def _p32_a_rank(torch, pt, rank, card):
    """(a) on one rank: each arm's P32_STEPS steps in one process on the
    card (this rank takes them itself: its rows of the table after each
    step, its peak), then on ``{"fsdp": 2}`` under ``SpecLayout()`` from the
    same table (each step's shard bit-equal to those rows, the peak, the
    kernels' launches and the tables they were handed)."""
    from paddle_tpu_torch.core.lower import local_of
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh, shard_program_state
    counters = _counters()
    feeds = _p32_table_feeds()
    start = torch.randn(P32_ROWS, P32_DIM, generator=torch.Generator().manual_seed(P32_ROWS))
    lo, hi = rank * P32_ROWS // 2, (rank + 1) * P32_ROWS // 2
    out = {"launches": {k: 0 for k in counters}}
    for arm, sparse in (("dense", False), ("sparse", True)):
        # one process: the whole table on the card
        main, startup, loss = _p32_table_program(pt, sparse)
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
        exe.run(startup, scope=scope)
        scope.find_var(P32_TABLE).copy_(start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want, single_ms = [], []
        for f in feeds:
            t0 = time.perf_counter()
            exe.run(main, feed={"ids": f}, fetch_list=[loss], scope=scope)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t0) * 1e3)
            want.append(scope.find_var(P32_TABLE)[lo:hi].to("cpu", copy=True))
        single_peak = torch.cuda.max_memory_allocated()
        del scope, exe
        gc.collect()
        torch.cuda.empty_cache()
        # two ranks: this rank's rows
        main, startup, loss = _p32_table_program(pt, sparse)
        scope = pt.Scope()
        pt.Executor(pt.CUDAPlace(0)).run(startup, scope=scope)
        scope.find_var(P32_TABLE).copy_(start)
        mesh, layout = make_mesh({"fsdp": 2}, host_staged=True), SpecLayout()
        shard_program_state(main, scope, mesh, layout)
        mexe = pt.Executor(mesh=mesh, layout=layout)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        mesh_ms, equal = [], []
        with _KernelTables() as kt:
            for f in feeds:
                t0 = time.perf_counter()
                mexe.run(main, feed={"ids": f[rank * P32_B // 2:(rank + 1) * P32_B // 2]},
                         fetch_list=[loss], scope=scope)
                torch.cuda.synchronize()
                mesh_ms.append((time.perf_counter() - t0) * 1e3)
                equal.append(torch.equal(scope.find_var(P32_TABLE).to_local().cpu(),
                                         want[len(equal)]))
        mesh_peak = torch.cuda.max_memory_allocated()
        launches = {k: f.launches for k, f in counters.items()}
        for k, n in launches.items():
            out["launches"][k] += n
        v = scope.find_var(P32_TABLE)
        held = sum(local_of(scope.find_var(n)).numel() * local_of(scope.find_var(n)).element_size()
                   for n in _p31_persist(main))
        rec = {"steps_bit_equal": equal, "single_ms": single_ms, "mesh_ms": mesh_ms,
               "single_peak_bytes": single_peak, "mesh_peak_bytes": mesh_peak,
               "state_bytes_a_rank": held, "placements": [repr(p) for p in v.placements],
               "local": list(v.to_local().shape),
               "launches": {k: n for k, n in launches.items() if n},
               "kernel_tables": sorted([n, list(s)] for n, s in kt.seen)}
        out[arm] = rec
        print(f"phase 32 (a) rank {rank} {arm}: the [{P32_ROWS}, {P32_DIM}] table on "
              f"{rec['placements']} (this rank's {rec['local']}); each step's shard bit-equal to "
              f"one process's rows {equal}; step ms a rank {[round(x, 3) for x in mesh_ms]} "
              f"against one process's {[round(x, 3) for x in single_ms]} (two ranks share the "
              f"card over gloo: no multi-card figure); peak {mesh_peak} bytes against "
              f"{single_peak}; state {held} bytes a rank; launches {rec['launches']}; the "
              f"kernels' tables {rec['kernel_tables']} [{card}]")
        want_launches = {"gather_rows": P32_STEPS}
        if not sparse:
            want_launches.update(scatter_add_rows=P32_STEPS, fused_sgd=P32_STEPS)
        shard = [P32_ROWS // 2, P32_DIM]
        if not all(equal) or mesh_peak >= single_peak or rec["launches"] != want_launches \
                or {n for n, _ in rec["kernel_tables"]} != set(want_launches) - {"fused_sgd"} \
                or any(s != shard for _, s in rec["kernel_tables"]) \
                or rec["placements"] != ["Shard(dim=0)"]:
            raise AssertionError(f"phase 32 (a) rank {rank} {arm}: {rec}; want launches "
                                 f"{want_launches}, K2/K3 handed {shard}")
        del scope, mexe, v
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _p32_shard_kernels(torch, card):
    """K2 and K3 at (a)'s shapes, a rank's [131072, 128] shard at the first
    step's 1,024 ids shifted by each rank's row offset, against their plain
    versions (K2 bit-equal on the card, K3 bit-equal to its plain version
    on the CPU), with times beside ``F.embedding`` and ``index_add_`` on the
    shard (each over the ids in the shard: the library calls have no zero
    row for another rank's id) and the bounds."""
    from paddle_tpu_torch.ops.cuda.embedding import (gather_rows, gather_rows_plain,
                                                     scatter_add_rows, scatter_add_rows_plain)
    ids = torch.from_numpy(_p32_table_feeds()[0].reshape(-1).astype(np.int32)).cuda()
    local = P32_ROWS // 2
    w = torch.randn(local, P32_DIM, generator=torch.Generator().manual_seed(32)).cuda()
    g = torch.randn(P32_B, P32_DIM, generator=torch.Generator().manual_seed(33)).cuda()
    out = {}
    for rank in range(2):
        at = (ids - rank * local).contiguous()
        inside = (at >= 0) & (at < local)
        lib_ids = at.clamp(0, local - 1).long()
        lib_rows = torch.where(inside[:, None], g, 0.0)
        k2, ref2 = gather_rows(w, at), gather_rows_plain(w, at)
        k3 = scatter_add_rows(w, at, g).cpu()
        ref3 = scatter_add_rows_plain(w.cpu(), at.cpu(), g.cpu())
        torch.cuda.synchronize()
        ms2, lib2 = _best(lambda fn: _ms(fn, 200),
                          [lambda: gather_rows(w, at),
                           lambda: torch.nn.functional.embedding(lib_ids, w)])
        plain2 = _ms(lambda: gather_rows_plain(w, at), 50)
        ms3, lib3 = _best(lambda fn: _ms(fn, 20),
                          [lambda: scatter_add_rows(w, at, g),
                           lambda: torch.zeros_like(w).index_add_(0, lib_ids, lib_rows)])
        plain3 = _ms(lambda: scatter_add_rows_plain(w, at, g), 20)
        rows_read = int(torch.unique(at[inside]).numel())
        b2, by2 = _bound(4 * (rows_read * P32_DIM + P32_B + P32_B * P32_DIM), 0)
        b3, by3 = _bound(4 * (P32_B + P32_B * P32_DIM + local * P32_DIM), P32_B * P32_DIM)
        out[rank] = {
            "gather_rows": dict(max_abs_err=(k2 - ref2).abs().max().item(),
                                bit_equal=torch.equal(k2, ref2), ms=ms2, plain_ms=plain2,
                                library_ms=lib2, bound_ms=b2, bound_by=by2, rows_read=rows_read,
                                table=[local, P32_DIM], ids=P32_B,
                                ids_in_shard=int(inside.sum())),
            "scatter_add_rows": dict(max_abs_err=(k3 - ref3).abs().max().item(),
                                     bit_equal=torch.equal(k3, ref3), ms=ms3, plain_ms=plain3,
                                     library_ms=lib3, bound_ms=b3, bound_by=by3,
                                     table=[local, P32_DIM], ids=P32_B,
                                     ids_in_shard=int(inside.sum()))}
        for name, r in out[rank].items():
            print(f"phase 32 (a) {name} on rank {rank}'s shard [{local},{P32_DIM}] at the step's "
                  f"{P32_B} ids shifted by {rank * local} ({r['ids_in_shard']} in the shard): "
                  f"bit-equal to its plain version {r['bit_equal']}; kernel {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, "
                  f"{'F.embedding' if name == 'gather_rows' else 'index_add_'} "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}) "
                  f"[{card}]")
        if not all(r["bit_equal"] for r in out[rank].values()):
            raise AssertionError(f"phase 32 (a): a kernel differs from its plain version at "
                                 f"rank {rank}'s shard: {out[rank]}")
    return out


def _p32_fm_trainer(pt, shard):
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.parallel import SpecLayout
    n = len(deepfm.CRITEO_VOCAB)

    def train_func():
        ids, dense, label = deepfm.data_layers(n)
        loss, _ = deepfm.train_network(ids, dense, label, deepfm.CRITEO_VOCAB, embed_dim=FM_DIM,
                                       shard_tables=shard)
        return loss
    kw = {"layout": SpecLayout()} if shard else {}
    with pt.unique_name.guard():
        return pt.Trainer(train_func=train_func,
                          optimizer_func=lambda: pt.optimizer.Adam(learning_rate=FM_LR),
                          place=pt.CUDAPlace(0), health=True, **kw)


def _p32_b(torch, pt, card, counters):
    """(b): DeepFM with ``shard_tables=True`` at the Criteo width through
    ``Trainer(layout=SpecLayout(), health=True)`` on the world of one over
    NCCL, on phase 27 (d)'s feeds, against the plain ``Trainer(health=
    True)`` from the same parameters: every state tensor bit-equal after
    the epoch, one capture (the sentinel inside the step's graph), the
    sentinel's values a step equal."""
    from paddle_tpu_torch.core.lower import local_of
    from paddle_tpu_torch import health
    from paddle_tpu_torch.models import deepfm
    n = len(deepfm.CRITEO_VOCAB)
    feeds = [deepfm.synthetic_feed(270 + k, FM_B) for k in range(P32_FM_STEPS)]
    order = [f"C{i}" for i in range(n)] + ["dense", "label"]

    def reader():
        for f in feeds:
            yield list(zip(*[f[f"C{i}"] for i in range(n)], f["dense"], f["label"]))

    def steps_of(tr):
        first = len(health.HEALTH_RECORDS.records())
        losses = []
        tr.train(1, lambda ev: losses.append(float(np.asarray(ev.metrics[0])))
                 if isinstance(ev, pt.EndStepEvent) else None, reader=reader, feed_order=order)
        recs = [r for r in health.HEALTH_RECORDS.records()[first:] if r.get("kind") == "step"]
        return losses, [{k: r.get(k) for k in ("ok", "loss", "grad_norm", "param_norm",
                                                "update_ratio")} for r in recs]
    t0 = time.perf_counter()
    plain = _p32_fm_trainer(pt, False)
    mt = _p32_fm_trainer(pt, True)
    names = _p31_persist(plain.train_program)
    for nm in names:
        local_of(mt.scope.find_var(nm)).copy_(plain.scope.find_var(nm))
    loss_p, sent_p = steps_of(plain)
    for f in counters.values():
        f.launches = 0
    loss_m, sent_m = steps_of(mt)
    launches = {k: f.launches for k, f in counters.items()}
    info = mt.exe.cache_info()
    bad = [nm for nm in names if not torch.equal(local_of(mt.scope.find_var(nm)),
                                                 plain.scope.find_var(nm))]
    mesh = mt.exe.mesh
    placements = {nm: [repr(p) for p in mt.scope.find_var(nm).placements]
                  for nm in ("fm_emb_2", "fm_w1_2")}
    rec = {"losses": loss_m, "plain_losses": loss_p, "sentinel": sent_m, "plain_sentinel": sent_p,
           "state_tensors": len(names), "not_bit_equal": bad[:8], "captures": info["captures"],
           "mesh": repr(mesh), "placements": placements,
           "launches": {k: v for k, v in launches.items() if v}, "seconds": time.perf_counter() - t0}
    print(f"phase 32 (b) DeepFM(shard_tables=True) at the Criteo width through "
          f"Trainer(layout=SpecLayout(), health=True) on {mesh!r}, {P32_FM_STEPS} steps of "
          f"{FM_B}: losses {loss_m} (plain {loss_p}); state tensors not bit-equal to the plain "
          f"Trainer's {len(bad)} of {len(names)}; captures {info['captures']}; the sentinel a "
          f"step {sent_m} (plain {sent_p}); {placements}; launches {rec['launches']} "
          f"[{card}]")
    want = {k: v * P32_FM_STEPS for k, v in P32_FM_PER_STEP.items()}
    if bad or loss_m != loss_p or sent_m != sent_p or info["captures"] != 1 \
            or mesh.size != 1 or mesh.backend != "nccl" \
            or placements["fm_emb_2"] != ["Shard(dim=0)"] \
            or any(launches[k] < v for k, v in want.items()) \
            or not all(s["ok"] for s in sent_m):
        raise AssertionError(f"phase 32 (b): {rec}; want launches at least {want}")
    del plain, mt
    _free_trainer(torch, "phase 32 (b)")
    return rec, launches


def _p32_c_train_func(pt):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer

    def train_func():
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[T, 1], dtype="int64")
        w = layers.data(name="weights", shape=[T, 1], dtype="float32")
        loss, _ = transformer.train_network(src, trg, lbl, VOCAB, VOCAB, weights=w, max_len=T,
                                            n_layer=P32_C_LAYERS, d_model=D_MODEL, n_head=H,
                                            d_inner=D_INNER, fuse_final_ce=True)
        return loss
    return train_func


def _p32_c_programs(pt):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss = _p32_c_train_func(pt)()
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _p32_c_samples(batch, rank=None):
    """Batch ``batch``'s P32_C_ROWS samples (rank ``rank``'s rows of them,
    or all): source lengths in [129, 256], target and label at 256,
    weights 1; a hit of ``P32_NAN_SITE`` puts a NaN into the first
    sample's weights."""
    from paddle_tpu_torch import faults
    rs = np.random.RandomState(3200 + batch)
    out = [(rs.randint(1, VOCAB, (rs.randint(T // 2 + 1, T + 1), 1)).astype(np.int64),
            rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
            rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
            np.ones((T, 1), np.float32)) for _ in range(P32_C_ROWS)]
    if rank is not None:
        per = P32_C_ROWS // 2
        out = out[rank * per:(rank + 1) * per]
        if faults.fire(P32_NAN_SITE):
            out[0][3][0, 0] = np.nan
    return out


def _p32_digests(scope, names):
    """sha1 of each state tensor's whole value (a DTensor gathered: every
    rank calls it), as host bytes."""
    import hashlib
    return {n: hashlib.sha1(_full(scope.find_var(n)).detach().cpu().contiguous().numpy()
                            .tobytes()).hexdigest() for n in names}


def _p32_c_rank(torch, pt, rank, card):
    """(c) and (d) on one rank (gloo on the card's CUDA tensors): the
    transformer trained on ``{"fsdp": 2}`` through ``Trainer(checkpoint=,
    health=True)``, saving at step 2; the sentinel's step-1 gradient norm
    against one process's; a NaN put into rank 1's next batch through
    ``faults``; then the step-2 checkpoint restored onto ``{"data": 2}``
    (an impossible budget refused first), bit-equal, and its next step
    against one process's step from the restored state."""
    from paddle_tpu_torch import faults, health
    from paddle_tpu_torch.analysis import PredictedOOMError
    from paddle_tpu_torch.checkpoint import CheckpointConfig, CheckpointManager
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    counters = _counters()
    root = os.environ["CHIP_SMOKE_P32_DIR"]
    ckpt = os.path.join(root, "ckpt")
    order = ["src", "trg", "lbl", "weights"]
    out = {"launches": {k: 0 for k in counters}}
    t_piece = time.perf_counter()

    def trainer(axes, **kw):
        with pt.unique_name.guard():
            return pt.Trainer(_p32_c_train_func(pt), lambda: pt.optimizer.Adam(learning_rate=1e-3),
                              place=pt.CUDAPlace(0), mesh=make_mesh(axes, host_staged=True),
                              layout=SpecLayout(mesh_axes=axes), **kw)

    def epoch(tr, batches):
        losses = []
        for f in counters.values():
            f.launches = 0
        tr.train(1, lambda ev: losses.append(float(np.asarray(ev.metrics[0])))
                 if isinstance(ev, pt.EndStepEvent) else None,
                 reader=lambda: (_p32_c_samples(b, rank) for b in batches), feed_order=order)
        for k, f in counters.items():
            out["launches"][k] += f.launches
        return losses

    def plain_step(state, batch, sentinels=False):
        """One process's step on the card from ``state`` (whole values) on
        the global batch: (loss, the sentinel's values, parameters)."""
        main, startup, loss = _p32_c_programs(pt)
        scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0), sentinels=sentinels)
        exe.run(startup, scope=scope)
        for n, v in state.items():
            scope.find_var(n).copy_(v.reshape(scope.find_var(n).shape))
        taps = []
        exe._health_hook = lambda **kw: taps.append([float(np.asarray(v).reshape(-1)[0])
                                                     for v in kw["values"]])
        feeder = pt.DataFeeder(feed_list=[main.global_block.var(n) for n in order],
                               program=main, seq_len_buckets="pow2")
        # the sentinel's values come from a step through run (a capture, its
        # eager run first); a step without them runs op by op, no capture
        step = exe.run if sentinels else exe._run_eager
        (lv,) = step(main, feed=feeder.feed(_p32_c_samples(batch)), fetch_list=[loss],
                     scope=scope)
        params = {p.name: scope.find_var(p.name).clone()
                  for p in main.global_block.all_parameters()}
        return float(lv), (taps[0] if taps else None), params

    # (c): train and save at step 2; (d): the trainer's sentinel
    t1 = trainer({"fsdp": 2}, health=True,
                 checkpoint=CheckpointConfig(dir=ckpt, step_interval=1, epoch_interval=0))
    names = _p31_persist(t1.train_program)
    start = {n: _full(t1.scope.find_var(n)).clone() for n in names}
    first = len(health.HEALTH_RECORDS.records())
    out["losses"] = epoch(t1, range(P32_C_STEPS))
    steps = [r for r in health.HEALTH_RECORDS.records()[first:] if r.get("kind") == "step"]
    out["steps_saved"] = t1.ckpt_manager.steps()
    out["state2"] = _p32_digests(t1.scope, names)
    t_piece = _piece_seconds(f"phase 32 (c) rank {rank}: the Trainer on {{'fsdp': 2}}, "
                             f"{P32_C_STEPS} steps and the save", t_piece)
    loss1, sent1, _ = plain_step(start, 0, sentinels=True)
    del start
    out["sentinel"] = {"grad_norm": steps[0]["grad_norm"], "plain_grad_norm": sent1[2],
                       "loss": steps[0]["loss"], "plain_loss": loss1}
    out["sentinel"]["rel"] = abs(sent1[2] - steps[0]["grad_norm"]) / abs(sent1[2])
    # (d): a NaN in rank 1's next batch, through faults
    faults.install(f"drop@{P32_NAN_SITE}:n=1" if rank == 1 else None, seed=0)
    first = len(health.HEALTH_RECORDS.records())
    try:
        out["nan_losses"] = epoch(t1, [P32_C_STEPS])
    finally:
        faults.reset()
    out["trips"] = [{k: r.get(k) for k in ("step", "bad_vars", "localization", "rank")}
                    for r in health.HEALTH_RECORDS.records()[first:]
                    if r.get("event") == "non-finite"]
    del t1
    _free_trainer(torch, f"phase 32 (c) rank {rank}'s first Trainer")
    t_piece = _piece_seconds(f"phase 32 (c)-(d) rank {rank}: the sentinel's reference step and "
                             f"the NaN step", t_piece)
    # (c) (ii): onto {"data": 2}; an impossible budget first
    try:
        trainer({"data": 2}, checkpoint=CheckpointConfig(dir=ckpt, step_interval=0,
                                                         epoch_interval=0, memory_budget=1024))
        out["m501"] = None
    except PredictedOOMError as e:
        out["m501"] = e.diagnostic.code
    t2 = trainer({"data": 2}, checkpoint=CheckpointConfig(dir=ckpt, step_interval=0,
                                                          epoch_interval=0))
    out["restored"] = _p32_digests(t2.scope, names)
    out["restored_placements"] = {n: [repr(p) for p in t2.scope.find_var(n).placements]
                                  for n in ("src_emb", "fc_0.w_0")}
    restored = {n: _full(t2.scope.find_var(n)).clone() for n in names}
    # the resumed epoch skips the steps the checkpoint took (its step_id)
    out["next_loss"] = epoch(t2, list(range(P32_C_STEPS)) + [P32_C_STEPS + 1])
    params = {p.name: _full(t2.scope.find_var(p.name)).cpu().numpy()
              for p in t2.train_program.global_block.all_parameters()}
    del t2
    _free_trainer(torch, f"phase 32 (c) rank {rank}'s restored Trainer")
    loss_p, _, params_p = plain_step(restored, P32_C_STEPS + 1)
    out["next_loss_plain"] = loss_p
    out["next_loss_rel"] = abs(out["next_loss"][0] - loss_p) / abs(loss_p)
    worst = max((_norm_rel(params[n], params_p[n].cpu().numpy()), n) for n in params)
    out["next_param_nrel"], out["next_param_worst"] = worst
    _piece_seconds(f"phase 32 (c) rank {rank}: the restore onto {{'data': 2}} and its step",
                   t_piece)
    print(f"phase 32 (c) rank {rank}: losses {out['losses']}; saved steps "
          f"{out['steps_saved']}; restored onto {{'data': 2}} {out['restored_placements']}, "
          f"state digests equal to the saved state's "
          f"{out['restored'] == out['state2']}; an impossible budget {out['m501']}; the next "
          f"step's loss {out['next_loss']} against one process's {loss_p} (relative "
          f"{out['next_loss_rel']:.3e}, gate {P32_C_GATES[0]}), worst parameter {worst[1]} "
          f"{worst[0]:.3e} norm-relative (gate {P32_C_GATES[1]}) [{card}]")
    print(f"phase 32 (d) rank {rank}: the sentinel's step-1 gradient norm "
          f"{out['sentinel']['grad_norm']} against one process's "
          f"{out['sentinel']['plain_grad_norm']} (relative {out['sentinel']['rel']:.3e}, gate "
          f"{P32_SENTINEL_RTOL}); the NaN step's losses {out['nan_losses']}, trips {out['trips']} "
          f"[{card}]")
    if out["restored"] != out["state2"] or out["m501"] != "M501" \
            or out["next_loss_rel"] > P32_C_GATES[0] or worst[0] > P32_C_GATES[1] \
            or out["sentinel"]["rel"] > P32_SENTINEL_RTOL or len(out["trips"]) != 1 \
            or "skipped" not in (out["trips"][0]["localization"] or {}) \
            or out["trips"][0]["rank"] != rank:
        raise AssertionError(f"phase 32 (c)-(d) rank {rank}: outside the gates: "
                             f"{ {k: v for k, v in out.items() if k not in ('state2', 'restored')} }")
    return out


def _p32_c_parent(torch, pt, card, root, recs):
    """(c) (i) and (d)'s report in this process: the step-2 checkpoint's
    manifest names both ranks' files and passes ``validate_shards``; it
    restores onto no mesh on the card, every persistable bit-equal to the
    ranks' state; ``tools/health_report.py`` (the reference's, unedited)
    over the ranks' telemetry."""
    from paddle_tpu_torch.checkpoint import (CheckpointManager, checkpoint_dir, read_manifest,
                                             validate_shards)
    ckpt = os.path.join(root, "ckpt")
    d = checkpoint_dir(ckpt, P32_C_STEPS)
    man = read_manifest(d)
    summary = validate_shards(d, man)
    main, startup, _ = _p32_c_programs(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    exe.run(startup, scope=scope)
    CheckpointManager(ckpt).restore(main, scope, step=P32_C_STEPS)
    names = _p31_persist(main)
    digests = _p32_digests(scope, names)
    bad = [n for n in names if digests[n] != recs[0]["state2"][n]]
    del scope, exe
    _free_trainer(torch, "phase 32 (c) (i)")
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "health_report.py")
    tel = os.path.join(root, "telemetry")
    run = subprocess.run([sys.executable, tool, tel, "--json"], capture_output=True, text=True,
                         timeout=120)
    strict = subprocess.run([sys.executable, tool, tel, "--strict"], capture_output=True,
                            text=True, timeout=120)
    report = json.loads(run.stdout) if run.returncode == 0 else {}
    health_ranks = report.get("health") or {}
    rec = {"shards": {k: v["file"] for k, v in man["shards"].items()}, "validate": summary,
           "mesh": man["mesh"], "restored_on_no_mesh_not_equal": bad, "state_tensors": len(names),
           "report_ranks": sorted(health_ranks),
           "lockstep": (report.get("fingerprint_lockstep") or {}).get("lockstep"),
           "trips": {r: h["events"].get("non-finite") for r, h in health_ranks.items()},
           "report_rc": run.returncode, "strict_rc": strict.returncode}
    print(f"phase 32 (c) (i): the step-{P32_C_STEPS} checkpoint's manifest names {rec['shards']} "
          f"(mesh {rec['mesh']}), validate_shards {summary}; restored onto no mesh on the card, "
          f"{len(names) - len(bad)} of {len(names)} persistables bit-equal to the ranks' state "
          f"[{card}]")
    print(f"phase 32 (d) tools/health_report.py --json: ranks {rec['report_ranks']}, fingerprint "
          f"lockstep {rec['lockstep']}, non-finite trips by rank {rec['trips']} (exit "
          f"{run.returncode}); --strict exit {strict.returncode}")
    if rec["shards"] != {"0": "shard_r0.npz", "1": "shard_r1.npz"} or bad \
            or rec["report_ranks"] != ["0", "1"] or rec["lockstep"] is not True \
            or rec["trips"] != {"0": 1, "1": 1} or run.returncode != 0 or strict.returncode != 1:
        raise AssertionError(f"phase 32 (c) (i) / (d): {rec}; {run.stderr[-2000:]}")
    return rec


def phase_sharded(torch, card):
    """Phase 32 (see the comment above P32_ROWS): sharded state on the card.
    (a)'s and (c)/(d)'s worker pairs run while this process takes (b), then
    this process checks K2 and K3 at (a)'s shard shapes, restores (c)'s
    checkpoint onto no mesh and reads (d)'s report.  Returns the launches
    of the main path (the workers' mesh runs and (b)'s Trainer, counted
    from 0; the one-process references and the kernel checks left out),
    the kernels' largest errors and K2's and K3's records at the shard."""
    import paddle_tpu_torch as pt
    counters = _counters()
    res = {}
    t_piece = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    tel = os.path.join(root, "telemetry")
    os.makedirs(tel)
    env = {"CHIP_SMOKE_P32_DIR": root, "PADDLE_TPU_TELEMETRY_DIR": tel}
    try:
        workers = [_p31_start("p32a", env), _p31_start("p32c", env)]
        try:
            res["b"], b_launches = _p32_b(torch, pt, card, counters)
            t_piece = _piece_seconds("phase 32 (b), beside the workers", t_piece)
        finally:
            recs = []
            for h in workers:
                try:
                    recs.append(_p31_finish(h))
                except AssertionError as e:
                    recs.append(e)
        for rec in recs:
            if isinstance(rec, AssertionError):
                raise rec
        res["a"], res["c"] = recs
        t_piece = _piece_seconds("phase 32 (a) and (c)-(d) to their end", t_piece)
        res["kernels"] = _p32_shard_kernels(torch, card)
        res["c_parent"] = _p32_c_parent(torch, pt, card, root, res["c"])
        _piece_seconds("phase 32 the kernels at the shard, (c) (i) and (d)'s report", t_piece)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {k: b_launches.get(k, 0) + sum(r["launches"][k] for r in res["a"] + res["c"])
                for k in counters}
    print(f"phase 32 launches of the main path (the workers' mesh runs and (b)'s Trainer): "
          f"{launches} [{card}]")
    missing = [k for k in P32_KERNELS if not launches.get(k)]
    if missing or launches["int8_matmul"]:
        raise AssertionError(f"phase 32: kernels of the path never launched: {missing}; "
                             f"{launches}")
    print(json.dumps({"sharded": {
        "a": [{k: v for k, v in r.items() if k != "launches"} for r in res["a"]],
        "b": res["b"], "c": [{k: v for k, v in r.items() if k not in ("state2", "restored",
                                                                      "launches")}
                             for r in res["c"]],
        "c_parent": res["c_parent"], "kernels": res["kernels"]}}, default=str))
    errs = {name: max(res["kernels"][r][name]["max_abs_err"] for r in (0, 1))
            for name in ("gather_rows", "scatter_add_rows")}
    return {"launches": launches, "max_abs_err": errs,
            "shapes": {name: {f"rank{r}": res["kernels"][r][name] for r in (0, 1)}
                       for name in ("gather_rows", "scatter_add_rows")}}


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
    PHASE19["dir"] = tempfile.mkdtemp(prefix="chip_smoke_telemetry_")
    try:
        _main(torch, build)
    finally:
        shutil.rmtree(PHASE19["dir"], ignore_errors=True)


def _main(torch, build):
    t_main = time.perf_counter()
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

    seconds = {}

    def timed(label, phase, *args, **kw):
        t0 = time.perf_counter()
        result = phase(torch, card, *args, **kw)
        seconds[label] = round(time.perf_counter() - t0, 1)
        print(f"phase function {label}: {seconds[label]} s")
        return result
    flash = timed("flash", phase_flash)
    gather = timed("gather", phase_gather)
    f32_res = timed("serving", phase_serving)
    _release_serving(torch, "float32 serving")
    ce = timed("linear_ce", phase_linear_ce)
    adam = timed("adam", phase_adam)
    scatter = timed("scatter", phase_scatter)
    launches, adam_steps = timed("training", phase_training)
    timed("train_vs_cpu", phase_train_vs_cpu)
    int8, int8_quant = timed("int8", phase_int8)
    sgd = timed("sgd", phase_sgd)
    int8_res = timed("int8_serving", phase_int8_serving, f32_res)
    _release_serving(torch, "int8 serving")
    sgd_launches, sgd_steps = timed("training_sgd", phase_training, sgd=True)
    bf16 = timed("bf16_kernels", phase_bf16_kernels)
    _, bf16_launches = timed("bf16_step", phase_bf16_step)
    _free_trainer(torch, "bf16 step")
    trainer_launches, trainer_bf16_launches = timed("trainer", phase_trainer)
    for name in ("int8_matmul", "abs_max_pair", "quantize_int8"):
        launches[name] = int8_res["launches"][name]
    launches["fused_sgd"] = sgd_launches["fused_sgd"]
    timed("observability_end", phase_observability)
    ref_launches = timed("reference_path", phase_reference_path)
    _, cnn_launches = timed("cnn", phase_cnn)
    passes_launches, passes_bf16 = timed("analysis", phase_analysis)
    health_launches, health_bf16 = timed("health", phase_health)
    book_launches = timed("book", phase_book)
    seq_launches = timed("sequences", phase_sequences)
    cf = timed("control_flow", phase_control_flow)
    sparse = timed("sparse", phase_sparse)
    data = timed("data", phase_data, sparse["step_ms_median"])
    dec = timed("decode", phase_decode)
    ps = timed("pserver", phase_pserver)
    coll = timed("collective", phase_collective)
    shard = timed("sharded", phase_sharded)
    print(f"seconds by phase function: {json.dumps(seconds)}; "
          f"{sum(seconds.values()):.1f} in all; {time.perf_counter() - t_main:.1f} since the "
          f"card's name was read (the kernel build included) [{card}]")

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
    # launches_profile: phase 19's op profiles (the float32 and bf16 steps,
    # the float32 and int8 serving batches), summed
    # launches_reference_path: phase 20's runs, each counted from 0 -- (a) the
    # full-width reference step (K1, K2, K3, K6), (d) SGD with a schedule
    # (K5), (e) the int8 matmul (K4); the bf16 entries (b)'s bf16 twin
    phase20 = {**ref_launches["a"], "fused_sgd": ref_launches["d"].get("fused_sgd", 0),
               "int8_matmul": ref_launches["e"]["int8_matmul"]}
    # launches_passes: phase 22 (a), the reference eval through passes=True
    # (K7 once a pass), counted from 0, the float32 and the bf16 instances
    # apart (the bf16 entries' count, gated at 0 there);
    # launches_cnn: phase 21 (e), the MNIST CNN with Adam, counted from 0;
    # launches_resnet: phase 21 (a)-(b), bf16 and float32 ResNet-50 training,
    # which runs no hand-written kernel (gated at 0 there);
    # launches_health: phase 23 (a), a step of Trainer(health=, checkpoint=)
    # after its capture, the float32 and the bf16 instances apart (the bf16
    # entries' count, gated at 0 there);
    # launches_book: phase 24, counted from 0 -- K5 in (e) fit_a_line and
    # (f)'s QAT step, K6 in (f)'s ModelAverage over Adam; the image models
    # (a)-(c) launch none (gated at 0 there)
    # launches_lstm: phase 25 (a), bench.py's bf16 stacked-LSTM step, counted
    # from 0 over its timed replays (K2, the bf16 K3, K6 one a replay);
    # launches_imdb_trainer: (b), the Trainer's two epochs over the imdb
    # buckets; launches_seq_models: (c), machine translation's and the
    # sentiment net's float32 steps; each the float32 and the bf16 instances
    # apart (the float32 K3 gated at 0 in (a) and (b), the bf16 instances at
    # 0 in (c)).  max_abs_err_lstm: (a)'s check of K2, the bf16 K3 and K6 at
    # the step's shapes, also in max_abs_err
    # launches_control_flow: phase 26, counted from 0 -- (a) the
    # encoder-decoder's timed replays (K2 4, K3 2, K6 1 a replay), (b) the
    # bounded While's SGD replays (K5 1 a replay); the float32 and the bf16
    # instances apart (the bf16 entries' count, gated at 0 in both).
    # max_abs_err_control_flow: (a)'s check of K2, K3 and K6 and (b)'s of
    # K5 at their steps' shapes, also in max_abs_err
    # launches_sparse: phase 27 (a), DeepFM's timed replays, counted from 0
    # (K2 52, K6 1 a replay), the float32 and the bf16 instances apart (the
    # bf16 entries' count, gated at 0 there).  max_abs_err_sparse: (a)'s
    # check of K2 and K6 and (b)'s of K3 and K6 at their steps' shapes, also
    # in max_abs_err
    # launches_dispatch: phase 28 (a), the Trainer(dispatch=) epoch of 16
    # steps, counted from 0 (the capture's eager run and 16 replays: K2 52,
    # K6 1 each); launches_py_reader: (b), open_files + read_file over two
    # passes (the capture's eager run and 32 replays); the float32 and the
    # bf16 instances apart (the bf16 entries' count, gated at 0 in both)
    # launches_decode: phase 29, each part counted from 0 -- "a" the beam
    # inference's timed replays (K2 13 a replay), "b" the decode engines'
    # serving (K2 a lookup_table op of each dispatched program, K1 once an
    # attention_lm prefill batch), "c" the fleet's soak; K3-K8 and the bf16
    # instances gated at 0 in each
    # launches_pserver: phase 30, by arm -- "a" the trainer's timed steps,
    # "a_pservers" the two pservers' whole serving (K6 once an adam op a
    # round), "b" the two trainers, "b_pservers", "c" the trainer of the
    # distributed table, "c_pservers" (K5 once a dense sgd op a round).
    # launches_collective: phase 31 (a), the Trainer(layout=) epoch and the
    # ParallelExecutor steps on the one-device NCCL mesh, and (d)'s SGD step
    # (K5), counted from 0.
    # max_abs_err_collective: (b)'s check of K1, K2, K3, K7, K8 and K6 at
    # each rank's local shapes, also in max_abs_err
    # launches_sharded: phase 32's main path, counted from 0 -- (a)'s mesh
    # steps on both ranks (K2, K3 and K5 on the dense arm's shard), (b)'s
    # Trainer (K2 52, K6 1 a step), (c)-(d)'s Trainers on both ranks (K1,
    # K2, K3, K6, K7, K8); the one-process references and the kernel checks
    # left out.  max_abs_err_sharded: K2's and K3's checks at (a)'s shard
    # max_abs_err_pserver: phase 30's check of K6 once a parameter, K1, K2,
    # K3, K7 and K8 at (b)'s trainer shapes and K5 at (c)'s dense shapes,
    # also in max_abs_err
    for e in kernels:
        e["launches_trainer"] = trainer_launches[e["name"]]
        e["launches_profile"] = PHASE19["launches_profile"].get(e["name"], 0)
        e["launches_reference_path"] = phase20.get(e["name"], 0)
        e["launches_cnn"] = cnn_launches[e["name"]]
        e["launches_resnet"] = 0
        e["launches_passes"] = passes_launches[e["name"]]
        e["launches_health"] = health_launches.get(e["name"], 0)
        e["launches_book"] = book_launches[e["name"]]
        e["launches_lstm"] = seq_launches["a"][e["name"]]
        e["launches_imdb_trainer"] = seq_launches["b"][e["name"]]
        e["launches_seq_models"] = seq_launches["c"][e["name"]]
        if e["name"] in seq_launches["max_abs_err"]:
            e["max_abs_err_lstm"] = seq_launches["max_abs_err"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_lstm"])
        e["launches_control_flow"] = cf["launches"][e["name"]]
        if e["name"] in cf["max_abs_err"]:
            e["max_abs_err_control_flow"] = cf["max_abs_err"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_control_flow"])
        e["launches_sparse"] = sparse["launches"][e["name"]]
        e["launches_dispatch"] = data["launches_dispatch"][e["name"]]
        e["launches_py_reader"] = data["launches_py_reader"][e["name"]]
        if e["name"] in sparse["max_abs_err"]:
            e["max_abs_err_sparse"] = sparse["max_abs_err"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_sparse"])
        e["launches_decode"] = {k: dec["launches_decode"][k][e["name"]] for k in "abc"}
        e["launches_pserver"] = {k: v.get(e["name"], 0)
                                 for k, v in ps["launches_pserver"].items()}
        if e["name"] in ps["max_abs_err"]:
            e["max_abs_err_pserver"] = ps["max_abs_err"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_pserver"])
        e["launches_collective"] = coll["launches"].get(e["name"], 0)
        if e["name"] in coll["max_abs_err"]:
            e["max_abs_err_collective"] = coll["max_abs_err"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_collective"])
        e["launches_sharded"] = shard["launches"].get(e["name"], 0)
        if e["name"] in shard["max_abs_err"]:
            e["max_abs_err_sharded"] = shard["max_abs_err"][e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"], e["max_abs_err_sharded"])
    # K2 at phase 27's shapes (the 10,131,227-row field's [V, 16] and [V, 1]
    # tables, the scalar branch at D 1; a 1,460-row field's), each with its
    # times, plain version, F.embedding and bound
    kernels[1]["shapes_sparse"] = sparse["k2_shapes"]
    # K3 at (b)'s shapes: the same tables' dense gradients of the dense twin
    kernels[2]["shapes_sparse"] = sparse["k3_shapes"]
    # K1 at attention_lm's prefill shapes, K2 at the decode models' table and
    # the book NMT's two tables (phase 29)
    kernels[0]["shapes_decode"] = dec["k1"]
    kernels[1]["shapes_decode"] = dec["k2"]
    # K2 and K3 at phase 32 (a)'s shard: [131,072, 128] at the step's 1,024
    # ids shifted by each rank's row offset
    kernels[1]["shapes_sharded"] = shard["shapes"]["gather_rows"]
    kernels[2]["shapes_sharded"] = shard["shapes"]["scatter_add_rows"]
    k4["quantizers"]["launches_profile"] = {
        n: PHASE19["launches_profile"].get(n, 0) for n in ("abs_max_pair", "quantize_int8")}
    k4["quantizers"]["launches_reference_path"] = {
        n: ref_launches["e"][n] for n in ("abs_max_pair", "quantize_int8")}
    for name, source, replaces, cases, main_case in (
            ("flash_attn_fwd", "flash_attention_fwd_bf16.cu", "flash_attention.py:38",
             {k: v for k, v in bf16.items() if k[0] == "flash"}, ("flash", False)),
            ("scatter_add_rows", "embedding_scatter_add.cu", "embedding.py:85",
             {k: v for k, v in bf16.items() if k[0] == "scatter"}, ("scatter", "padded")),
            ("linear_ce_fwd", "linear_ce.cu", "linear_ce.py:42",
             {0: bf16["linear_ce_fwd"]}, 0)):
        e = dict(entry(name, source, replaces, cases, main_case), name=f"{name}_bf16",
                 launches=bf16_launches[name], launches_trainer=trainer_bf16_launches[name],
                 launches_profile=PHASE19["launches_profile_bf16"].get(name, 0),
                 launches_reference_path=ref_launches["b_bf16"].get(name, 0),
                 launches_cnn=0, launches_resnet=0, launches_passes=passes_bf16[name],
                 launches_health=health_bf16.get(name, 0), launches_book=0,
                 launches_lstm=seq_launches["a_bf16"].get(name, 0),
                 launches_imdb_trainer=seq_launches["b_bf16"].get(name, 0),
                 launches_seq_models=seq_launches["c_bf16"].get(name, 0),
                 launches_control_flow=cf["bf16_launches"].get(name, 0),
                 launches_sparse=sparse["bf16_launches"].get(name, 0),
                 launches_dispatch=data["bf16_launches_dispatch"].get(name, 0),
                 launches_py_reader=data["bf16_launches_py_reader"].get(name, 0),
                 launches_decode={k: 0 for k in "abc"},
                 launches_pserver={k: v.get(name + ".bf16", 0)
                                   for k, v in ps["launches_pserver"].items()},
                 launches_collective=0, launches_sharded=0)
        lstm_err = seq_launches["max_abs_err"].get(f"{name}_bf16")
        if lstm_err is not None:
            e["max_abs_err_lstm"] = lstm_err
            e["max_abs_err"] = max(e["max_abs_err"], lstm_err)
        kernels.append(e)
    # C7's batch-invariant row-vector product: the route of a decode step's
    # batched row-vector matmuls (attention_lm's attention over its cache),
    # where the JAX package's matmul lowering hands the product to XLA.
    # launches: phase 29 (b)'s decode engines; launches_decode by part;
    # times and errors from phase 30's check at the decode shapes
    rv = ps["rowvec"]["cases"]["probs_x_v"]
    kernels.append({"name": "rowvec_mm", "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/batched_rowvec_mm.cu",
                    "replaces": "paddle_tpu/ops/math_ops.py:57 (matmul, left to XLA: no Pallas "
                                "kernel)",
                    "launches": dec["rowvec"]["b"], "max_abs_err": ps["rowvec"]["max_abs_err"],
                    **{k: rv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms")},
                    "shapes": ps["rowvec"]["cases"], "launches_decode": dec["rowvec"],
                    "launches_pserver": {k: v.get("rowvec_mm", 0)
                                         for k, v in ps["launches_pserver"].items()},
                    "launches_collective": 0, "launches_sharded": 0})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--collective-worker"]:
        # one rank of phase 31 (b) or (c), started by phase_collective
        _collective_worker(sys.argv[2:])
        sys.exit(0)
    try:
        main()
    except Exception:  # noqa: BLE001 -- any phase failure is a non-zero exit
        traceback.print_exc()
        sys.exit(1)
