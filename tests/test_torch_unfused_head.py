"""The transformer's reference training path, ported, against the JAX
package on the CPU.

* A 2+2-layer ``train_network(fuse_final_ce=False, weights=w)`` (vocab
  1000, d_model 64, 4 heads, d_inner 256, max_len 32, batch 4, ragged
  target lengths; ``w`` zeroes each row's padded tail), with
  ``noam_decay(64, 4)`` (rates 0.016-0.047 over the 3 steps, so Adam
  moves each parameter visibly), ``Adam(beta1=0.9, beta2=0.98,
  epsilon=1e-9)``, ``GradientClipByGlobalNorm(1.0)`` and ``L2Decay(1e-4)``
  on the fc weights, built by both packages under ``unique_name.guard()``:
  equal main and startup ProgramDescs; from the JAX startup's parameters,
  every step-1 gradient within ``GRAD_ATOL`` / ``GRAD_RTOL``, the 3-step
  losses within ``LOSS_RTOL``, the learning rates within ``LR_RTOL``, and
  each persistable's change over the 3 steps within ``DELTA_NREL`` of the
  JAX package's (the JAX state one step short fails that gate).
* ``Trainer(accum_steps=2)`` over that network against the JAX
  ``Trainer``: equal accumulate / apply / startup ProgramDescs, equal
  events, losses and each persistable's change within the same gates,
  ``pipeline=True`` bit-equal to ``False``, and the accumulators zero
  after each apply.
* The int8 ``matmul`` (``pallas_int8_matmul`` with ``base_op="matmul"``):
  served by both packages' ``Inferencer(amp=AmpConfig(bf16=False,
  quant=True), kernels=True)`` (the JAX one running its Pallas kernel in
  interpret mode), 2-D with and without transposes and ``alpha``, and
  batched; bit-equal, and bit-equal to the port's fake-quant program.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch.core.desc import grad_var_name
from paddle_tpu_torch.models import transformer as pt_transformer

from _torch_validate import _no_port_validate_findings  # noqa: F401

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER, BATCH = 1000, 64, 4, 256, 32, 2, 4
STEPS = 3
NOAM_WARMUP = 4
# float32, XLA and torch sum in other orders (tests/test_torch_training.py)
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
LOSS_RTOL = 1e-4
# a learning rate is a power and a few scalings: a last-bit difference
LR_RTOL = 2e-7
# Each floating persistable's change from the start, p_n - p_0, against
# the JAX package's, norm-relative a tensor (slots and beta powers too).
# Readings on the CPU: at most 9.2e-5 (fc_11.w_0 after 3 steps, src_emb
# after the Trainer's 4 applies; XLA and torch sum the gradients in other
# orders, and Adam's early steps are sign-like where a gradient is near 0).
# Unchanged state reads 1; Adam without its bias correction, or the L2
# coefficient doubled, fails both gates.
DELTA_NREL = 5e-4
FEED_ORDER = ["src", "trg", "lbl", "wgt"]


def _head(pkg, mod):
    """The network, schedule, clip, regularizer and Adam; returns (loss, lr)."""
    src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
    wgt = pkg.layers.data(name="wgt", shape=[T, 1], dtype="float32")
    loss, logits = mod.train_network(src, trg, lbl, VOCAB, VOCAB, weights=wgt, max_len=T,
                                     n_layer=N_LAYER, d_model=D_MODEL, n_head=N_HEAD,
                                     d_inner=D_INNER, fuse_final_ce=False)
    assert tuple(logits.shape) == (-1, -1, VOCAB)
    main = pkg.default_main_program()
    for p in main.global_block.all_parameters():
        if p.name.startswith("fc_") and p.name.endswith(".w_0"):
            p.regularizer = pkg.regularizer.L2Decay(1e-4)
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0))
    lr = pkg.layers.noam_decay(D_MODEL, NOAM_WARMUP)
    return loss, lr


def _optimizer(pkg, lr):
    return pkg.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98, epsilon=1e-9)


def _build(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss, lr = _head(pkg, mod)
        _optimizer(pkg, lr).minimize(loss)
    return main, startup, loss, lr


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _descs_equal(a, b):
    da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
    assert [o["type"] for o in da["blocks"][0]["ops"]] == \
        [o["type"] for o in db["blocks"][0]["ops"]]
    assert da == db


def _weights(lens):
    return (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)[..., None]


def _feed():
    rs = np.random.RandomState(0)
    trg_lens = np.array([9, 32, 1, 20], np.int32)
    return {"src": rs.randint(1, VOCAB, (BATCH, T, 1)), "trg": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "lbl": rs.randint(1, VOCAB, (BATCH, T, 1)), "wgt": _weights(trg_lens),
            "src@SEQ_LEN": np.array([32, 17, 5, 29], np.int32), "trg@SEQ_LEN": trg_lens}


@pytest.fixture(scope="module")
def runs():
    jm, js, jl, jlr = _build(fluid, jax_transformer)
    tm, ts, tl, tlr = _build(pt, pt_transformer)
    params = [p.name for p in tm.global_block.all_parameters()]
    fetch = [tl.name, tlr.name] + [grad_var_name(p) for p in params]
    jscope, jexe = fluid.Scope(), fluid.Executor()
    jexe.run(js, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    persist = [v.name for v in jm.list_vars() if v.persistable]
    start = {n: np.array(jscope.find_var(n)) for n in persist}
    pt.params_from_numpy(start, tscope, "cpu")
    feed = _feed()
    jout = [np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)]
    tout = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    steps = [(jout[:2], tout[:2])]
    for _ in range(STEPS - 1):
        short = {n: np.array(jscope.find_var(n)) for n in persist}
        a = jexe.run(jm, feed=feed, fetch_list=[jl.name, jlr.name], scope=jscope)
        b = texe.run(tm, feed=feed, fetch_list=[tl.name, tlr.name], scope=tscope)
        steps.append(([np.asarray(x) for x in a], b))
    final = {n: (np.asarray(jscope.find_var(n)), tscope.find_var(n).numpy()) for n in persist}
    return dict(progs=((jm, js), (tm, ts)), params=params, steps=steps, final=final,
                start=start, short=short, grads=dict(zip(params, zip(jout[2:], tout[2:]))))


def _moved_alike(start, ref, got):
    """Whether ``got`` moved from ``start`` as ``ref`` did: integers equal,
    floats within DELTA_NREL of ref's change (no change where ref has none)."""
    if ref.dtype.kind != "f":
        return np.array_equal(got, ref)
    want = ref.astype(np.float64) - start
    have = got.astype(np.float64) - start
    return np.linalg.norm(have - want) <= DELTA_NREL * np.linalg.norm(want)


def _assert_moved_alike(start, final, params):
    for name, (ref, got) in final.items():
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert _moved_alike(start[name], ref, got), name
    assert all(np.any(final[p][0] != start[p]) for p in params)


def test_program_descs_equal_op_for_op(runs):
    (jm, js), (tm, ts) = runs["progs"]
    _descs_equal(jm, tm)
    _descs_equal(js, ts)
    types = [o.type for o in tm.desc.block(0).ops]
    n = len(runs["params"])
    assert types.count("softmax_with_cross_entropy") == types.count(
        "softmax_with_cross_entropy_grad") == 1
    assert "fused_fc_softmax_ce" not in types
    # one clip scaling a gradient, and the loss's weights
    assert types.count("adam") == types.count("squared_l2_norm") == types.count(
        "elementwise_mul") - 1 == n
    assert types.count("reduce_sum") == 2 and types.count("elementwise_div") == 2
    assert [o.attrs["op_role"] for o in tm.desc.block(0).ops if o.type == "increment"] == \
        ["lr_sched"]
    l2 = [p for p in runs["params"] if p.startswith("fc_") and p.endswith(".w_0")]
    # L2Decay's scale per fc weight; the two embeddings' and noam_decay's two
    assert types.count("scale") - 2 - 2 == len(l2) > 0


def test_every_parameter_gets_the_jax_gradient(runs):
    assert len(runs["grads"]) == len(runs["params"]) == 66
    for name, (ref, got) in runs["grads"].items():
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        assert np.abs(ref).max() > 0, name
        np.testing.assert_allclose(got, ref, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_three_steps_losses_and_learning_rates_match_and_losses_fall(runs):
    losses = [(float(a[0]), float(b[0])) for a, b in runs["steps"]]
    lrs = [(float(np.ravel(a[1])[0]), float(np.ravel(b[1])[0])) for a, b in runs["steps"]]
    ref, got = zip(*losses)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert got[0] > got[1] > got[2]
    ref_lr, got_lr = zip(*lrs)
    np.testing.assert_allclose(got_lr, ref_lr, rtol=LR_RTOL, atol=0)
    want = [D_MODEL ** -0.5 * min(s ** -0.5, s * NOAM_WARMUP ** -1.5) for s in (1, 2, 3)]
    np.testing.assert_allclose(got_lr, want, rtol=1e-6)


def test_final_parameters_and_state_within_the_adam_bound(runs):
    _assert_moved_alike(runs["start"], runs["final"], runs["params"])
    # the control: the JAX state one Adam step short fails the gate
    short = [n for n in runs["params"]
             if not _moved_alike(runs["start"][n], runs["final"][n][0], runs["short"][n])]
    assert short == runs["params"]
    (ref, got), = [v for n, v in runs["final"].items() if "COUNTER" in n]
    assert got.dtype == np.int32 and int(got[0]) == int(ref[0]) == STEPS


# ------------------------------------------------------- accumulation

def _samples(n, seed=0):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(n):
            length = rs.randint(1, T + 1)
            yield (rs.randint(1, VOCAB, (rs.randint(17, T + 1), 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
                   rs.randint(1, VOCAB, (T, 1)).astype(np.int64),
                   _weights([length])[0])
    return reader


def _trainer(pkg, mod, **kw):
    def train_func():
        loss, lr = _head(pkg, mod)
        _LR[pkg.__name__] = lr
        return loss
    with pkg.unique_name.guard():
        return pkg.Trainer(train_func, lambda: _optimizer(pkg, _LR[pkg.__name__]), **kw)


_LR = {}


def _train(trainer, pkg, epochs=2, batches=4):
    losses = []
    events = []

    def handler(ev):
        events.append((type(ev).__name__, ev.epoch, getattr(ev, "step", None)))
        if type(ev).__name__ == "EndStepEvent":
            losses.append(float(np.asarray(ev.metrics[0])))
    trainer.train(epochs, handler, reader=pkg.batch(_samples(batches * BATCH), BATCH),
                  feed_order=FEED_ORDER)
    return events, losses


@pytest.fixture(scope="module")
def accum_runs():
    jtr = _trainer(fluid, jax_transformer, accum_steps=2)
    persist = [v.name for v in jtr.train_program.list_vars() if v.persistable]
    start = {n: np.asarray(jtr.scope.find_var(n)) for n in persist}
    out = {"jax": (jtr, _train(jtr, fluid)), "start": start}
    for pipeline in (True, False):
        ttr = _trainer(pt, pt_transformer, accum_steps=2, place=pt.CPUPlace(),
                       pipeline=pipeline)
        for n, a in start.items():
            t = ttr.scope.find_var(n)
            t.copy_(torch.from_numpy(np.array(a)).reshape(t.shape))
        out[pipeline] = (ttr, _train(ttr, pt))
    out["persist"] = persist
    return out


def test_accumulation_programs_equal_the_jax_package(accum_runs):
    jtr, _ = accum_runs["jax"]
    ttr, _ = accum_runs[True]
    for a, b in ((jtr._step_program, ttr._step_program), (jtr.apply_program, ttr.apply_program),
                 (jtr.startup_program, ttr.startup_program)):
        _descs_equal(a, b)
    accum_types = [o.type for o in ttr._step_program.desc.block(0).ops]
    apply_types = [o.type for o in ttr.apply_program.desc.block(0).ops]
    assert "adam" not in accum_types and "increment" not in accum_types
    assert "squared_l2_norm" in accum_types      # the clip acts on each micro-batch
    n = len(ttr.train_program.global_block.all_parameters())
    assert apply_types.count("adam") == apply_types.count("fill_constant") == n
    assert apply_types.count("increment") == 1


def test_accumulation_trainer_matches_the_jax_trainer(accum_runs):
    jtr, (jev, jloss) = accum_runs["jax"]
    ttr, (tev, tloss) = accum_runs[True]
    assert tev == jev and len(tloss) == 8
    np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL, atol=0)
    final = {n: (np.asarray(jtr.scope.find_var(n)), ttr.scope.find_var(n).numpy())
             for n in accum_runs["persist"]}
    params = [p.name for p in ttr.train_program.global_block.all_parameters()]
    _assert_moved_alike(accum_runs["start"], final, params)
    counter = [n for n in accum_runs["persist"] if "COUNTER" in n]
    assert [int(ttr.scope.find_var(n)[0]) for n in counter] == [4]   # 8 micro-steps, 4 applies


def test_accumulation_pipelined_bit_equal_to_synchronous_and_buffers_zeroed(accum_runs):
    a, (_, la) = accum_runs[True]
    b, (_, lb) = accum_runs[False]
    assert la == lb
    for n in accum_runs["persist"]:
        assert torch.equal(a.scope.find_var(n), b.scope.find_var(n)), n
    accs = [v.name for v in a.apply_program.list_vars() if v.name.endswith("@ACC")]
    assert accs and all(not a.scope.find_var(n).any() for n in accs)


# ------------------------------------------------------------ int8 matmul

M, K, N = 64, 256, 128


def _matmul_model(pkg, case):
    def infer_func():
        if case == "batched":
            x = pkg.layers.data(name="x", shape=[3, M, K], append_batch_size=False)
        else:
            x = pkg.layers.data(name="x", shape=[K, M] if case == "transposed" else [M, K],
                                append_batch_size=False)
        shape = [N, K] if case == "transposed" else [K, N]
        w = pkg.layer_helper.LayerHelper("proj").create_parameter(
            pkg.ParamAttr(name="proj.w"), shape=shape, dtype="float32")
        if case == "transposed":
            return pkg.layers.matmul(x, w, transpose_x=True, transpose_y=True, alpha=0.25)
        return pkg.layers.matmul(x, w)
    return infer_func


@pytest.mark.parametrize("case", ["plain", "transposed", "batched"])
def test_int8_matmul_matches_the_jax_kernel_in_interpret_mode(case, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    amp = {pkg: pkg.amp.AmpConfig(bf16=False, quant=True) for pkg in (fluid, pt)}
    jinf = fluid.Inferencer(infer_func=_matmul_model(fluid, case), amp=amp[fluid], kernels=True)
    tinf = pt.Inferencer(_matmul_model(pt, case), place=pt.CPUPlace(), amp=amp[pt], kernels=True)
    sim = pt.Inferencer(_matmul_model(pt, case), place=pt.CPUPlace(), amp=amp[pt], kernels=False)
    f32 = pt.Inferencer(_matmul_model(pt, case), place=pt.CPUPlace())
    w = np.asarray(jinf.scope.find_var("proj.w"))
    for inf in (tinf, sim, f32):
        pt.params_from_numpy({"proj.w": w}, inf.scope, "cpu")
    x = np.random.RandomState(5).randn(*jinf.inference_program.global_block.var("x").shape)
    feed = {"x": x.astype(np.float32)}
    ref = np.asarray(jinf.infer(feed)[0])
    (got,) = tinf.infer(feed)
    ops = tinf.exe._apply_passes(tinf.inference_program, ["x"],
                                 [v.name for v in tinf.predict_vars]).desc.block(0).ops
    assert [(o.type, o.attrs.get("base_op")) for o in ops] == [("pallas_int8_matmul", "matmul")]
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, sim.infer(feed)[0])
    want = f32.infer(feed)[0]
    assert np.linalg.norm(got - want) <= 0.05 * np.linalg.norm(want)
