"""The PyTorch/CUDA port's pass pipeline and kernel tier against the JAX
package.

A 2+2-layer transformer (vocab 1000, d_model 64, 4 heads, d_inner 256,
max_len 32) is built by both packages under ``unique_name.guard()``; its
serving program is rewritten by ``amp-quant-int8`` and ``pallas-kernels``
and its SGD training program by ``pallas-kernels``: the rewritten
ProgramDescs must be equal op for op.  With the JAX weights carried across,
the port's int8 logits, per op and for the whole model, and its SGD losses
are held to the JAX package's.  The JAX side runs the int8 GEMM through
its exact integer fallback and the fused SGD in Pallas interpret mode, as
its own tests run them on the CPU.
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.amp import compose_passes as jax_compose_passes
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.ops.pallas.fused_optimizer import fused_sgd as jax_fused_sgd
from paddle_tpu.ops.pallas.int8_matmul import int8_matmul as jax_int8_matmul
from paddle_tpu.ops.pallas.int8_matmul import quantize_abs_max as jax_quantize_abs_max
from paddle_tpu.ops.pallas.policy import KernelPolicy as JaxKernelPolicy
from paddle_tpu_torch.amp import compose_passes
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_sgd_plain
from paddle_tpu_torch.ops.cuda.int8_matmul import (abs_max_pair_plain, bin_count, combined_scale,
                                                   int8_matmul, int8_matmul_plain, int8_mm_plain,
                                                   quantize_abs_max, quantize_int8_plain,
                                                   quantize_ratio, scale_by_reciprocal)
from paddle_tpu_torch.passes import KernelPolicy, PassPipeline

from _torch_validate import _no_port_validate_findings  # noqa: F401

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER = 1000, 64, 4, 256, 32, 2
N_MUL = 33                      # mul ops of the 2+2-layer serving program
KNOBS = ("flash_block_q", "flash_block_k", "flash_min_block_q", "flash_lane",
         "embedding_vmem_bytes", "optimizer_min_numel")
# Whole-model int8 logits, port vs JAX (logits within +-1.5).  A quantizer
# input that differs in its last bit (layer_norm and attention sum in another
# order in XLA and torch, ~6e-7 apart in float32) can round one element the
# other way, or move an abs-max scale; the later layers carry that as
# quantization noise.  Measured over the 16 batches of 1-8 rows below, the
# norm-relative error |got - ref| / |ref| is at most 2e-3 in 11 of them (0 in
# 6) and up to 0.0163 in the others, as far as float32 (unquantized) logits
# are from the int8 ones: 0.0136-0.0184, in every batch.  So no one batch
# tells a port that does not quantize from one that does; the share of
# "quiet" batches does: the port must have at least QUIET_SHARE of them, and
# the float32 control, which has none, must fail that gate.  Every batch is
# also held within WHOLE_MODEL_ATOL (measured at most 0.0308).  Per op, with
# equal inputs, the two packages are bit-equal (test below).
QUIET_REL_ERR = 2e-3
QUIET_SHARE = 0.25
WHOLE_MODEL_ATOL = 0.05
LOSS_RTOL = 1e-4                # float32 losses, XLA vs torch summation orders


def _jax_default_policy():
    """The port's KernelPolicy with the JAX package's default knob values."""
    ref = JaxKernelPolicy()
    return KernelPolicy(**{k: getattr(ref, k) for k in KNOBS})


def _amp(pkg):
    return pkg.amp.AmpConfig(bf16=False, quant=True)


def _serving_model(pkg, mod):
    def infer_func():
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        return mod.transformer(src, trg, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                               d_model=D_MODEL, n_head=N_HEAD, d_inner=D_INNER,
                               is_test=True)
    return infer_func


def _build_serving(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        out = _serving_model(pkg, mod)()
    return main, out


def _feed(rs, rows):
    feed = {}
    for name in ("src", "trg"):
        lens = rs.randint(1, T + 1, rows)
        ids = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
        ids[np.arange(T)[None, :] >= lens[:, None]] = 0
        feed[name], feed[name + "@SEQ_LEN"] = ids, lens.astype(np.int32)
    return feed


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _assert_descs_equal(a, b):
    da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
    assert [o["type"] for o in da["blocks"][0]["ops"]] == \
        [o["type"] for o in db["blocks"][0]["ops"]]
    assert da == db
    assert a.desc.fingerprint() == b.desc.fingerprint()


def _types(program):
    return Counter(o.type for o in program.desc.block(0).ops)


# ------------------------------------------------------------ fingerprints


@pytest.mark.parametrize("case", [
    "amp_policy_default", "amp_policy_rules", "amp_config_default",
    "amp_config_int8", "amp_config_int4_lists", "kernel_policy_jax_knobs",
    "kernel_policy_rules_disable"])
def test_policy_fingerprints_equal_the_jax_package(case):
    args = {
        "amp_policy_default": ("AmpPolicy", {}),
        "amp_policy_rules": ("AmpPolicy", {"rules": [("conv2d", "fp32"), ("^mul$", "bf16")]}),
        "amp_config_default": ("AmpConfig", {}),
        "amp_config_int8": ("AmpConfig", {"bf16": False, "quant": True}),
        "amp_config_int4_lists": ("AmpConfig", {"bf16": False, "quant": True, "quant_bits": 4,
                                                "custom_black_list": ["relu"]}),
        "kernel_policy_jax_knobs": ("KernelPolicy", {}),
        "kernel_policy_rules_disable": ("KernelPolicy", {"rules": [("^fc$", "int8_matmul")],
                                                         "disable": ["embedding"],
                                                         "optimizer_min_numel": 1}),
    }
    cls, kw = args[case]
    if cls == "KernelPolicy":
        ref = JaxKernelPolicy(**kw)
        ours = KernelPolicy(**dict({k: getattr(JaxKernelPolicy(), k) for k in KNOBS}, **kw))
    else:
        ref = getattr(fluid.amp, cls)(**kw)
        ours = getattr(pt.amp, cls)(**kw)
    assert ours.fingerprint() == ref.fingerprint()


def test_hopper_default_knobs_differ_from_the_tpu_and_say_why():
    ours, ref = KernelPolicy(), JaxKernelPolicy()
    assert ours.fingerprint() != ref.fingerprint()
    # K1 takes head_dim 16/32/64/128; the TPU's 128-lane rule declines 64
    assert ours.flash_profitable(-1, -1, 64) == (True, None)
    assert ref.flash_profitable(256, 256, 64) == (False, "head-dim-unaligned")
    assert ours.flash_profitable(256, 256, 48) == (False, "head-dim-unsupported")
    # K2/K3 stream rows from device memory: transformer-base's word table fits
    assert ours.embedding_profitable(32000, 512) == (True, None)
    assert ref.embedding_profitable(32000, 512)[0] is False
    assert ours.optimizer_min_numel == ref.optimizer_min_numel == 4096


# ------------------------------------------------- rewritten ProgramDescs


@pytest.fixture(scope="module")
def serving_programs():
    return _build_serving(fluid, jax_transformer), _build_serving(pt, pt_transformer)


def test_quant_pass_program_descs_equal(serving_programs):
    (jm, jo), (tm, to) = serving_programs
    jp = jax_compose_passes(None, _amp(fluid))
    tp = compose_passes(None, _amp(pt))
    assert tp.fingerprint() == jp.fingerprint()
    a, _ = jp.run(jm, fetch_list=[jo.name])
    b, res = tp.run(tm, fetch_list=[to.name])
    _assert_descs_equal(a, b)
    types = _types(b)
    assert types["mul"] == types["fake_dequantize_max_abs"] == types["elementwise_mul"] == N_MUL
    assert types["fake_quantize_abs_max"] > N_MUL     # both operands, shared ones once
    assert b.desc.uid == tm.desc.uid and b.desc.version != tm.desc.version
    assert _types(tm)["fake_quantize_abs_max"] == 0   # the input program is untouched
    assert b._amp_policy_fp.startswith("int8:")
    assert res.changed and res.passes[0].name == "amp-quant-int8"


def test_kernel_pass_program_descs_equal_under_the_jax_knobs(serving_programs):
    (jm, jo), (tm, to) = serving_programs
    jp = jax_compose_passes(None, _amp(fluid), kernels=JaxKernelPolicy())
    tp = compose_passes(None, _amp(pt), kernels=_jax_default_policy())
    assert tp.fingerprint() == jp.fingerprint()
    a, _ = jp.run(jm, fetch_list=[jo.name])
    b, _ = tp.run(tm, fetch_list=[to.name])
    _assert_descs_equal(a, b)
    types = _types(b)
    assert types["pallas_int8_matmul"] == N_MUL and types["mul"] == 0
    assert not any(t.startswith("fake_") or t == "elementwise_mul" for t in types)
    assert types["pallas_gather"] == 4
    block = b.desc.block(0)
    assert not any(n.endswith(("@QUANT", "@QSCALE", "@QRAW")) for n in block.vars)
    # the sequence length is dynamic and the TPU knobs need it: no stamp
    assert all("pallas_kernel" not in o.attrs for o in block.ops if o.type == "flash_attention")
    assert b._kernel_policy_fp == _jax_default_policy().fingerprint()


def test_hopper_defaults_stamp_the_flash_ops_true(serving_programs):
    _, (tm, to) = serving_programs
    b, res = compose_passes(None, _amp(pt), kernels=KernelPolicy()).run(tm, fetch_list=[to.name])
    flash = [o for o in b.desc.block(0).ops if o.type == "flash_attention"]
    assert len(flash) == 3 * N_LAYER
    assert all(o.attrs["pallas_kernel"] is True and o.attrs["inserted_by"] == "pallas-kernels"
               for o in flash)
    assert _types(b)["pallas_int8_matmul"] == N_MUL
    assert "flash 6, int8 33" in res.passes[-1].notes[-1]


# ----------------------------------------------------------------- kernels


@pytest.mark.parametrize("m,k,n,interpret", [(64, 256, 384, True), (7, 100, 33, False)])
def test_int8_matmul_plain_bit_equal_to_jax(m, k, n, interpret):
    """Aligned: against the Pallas kernel in interpret mode; unaligned
    (M=7, K=100, N=33): against the JAX package's exact integer fallback."""
    rs = np.random.RandomState(m + k + n)
    x = rs.randn(m, k).astype(np.float32)
    y = (rs.rand(k, n).astype(np.float32) - 0.5) * 0.1
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(y), bits=8,
                                     interpret=interpret))
    got = int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(int8_matmul(torch.from_numpy(x), torch.from_numpy(y)).numpy(), ref)


@pytest.mark.parametrize("seed", [0, 5])
def test_quantizer_bit_equal_to_the_jitted_jax_quantizer(seed):
    """transformer-base's [2048, 512] activations, against ``quantize_abs_max``
    as the JAX ``Executor`` runs it (``jax.jit``).  From these seeds a ratio
    ``bin_cnt / s`` rounded twice (``s.reciprocal() * bin_cnt``) moves one
    element by a quantum."""
    x = np.random.RandomState(seed).randn(2048, 512).astype(np.float32)
    ref_q, ref_s = jax.jit(lambda a: jax_quantize_abs_max(a, 127.0))(jnp.asarray(x))
    q, s = quantize_abs_max(torch.from_numpy(x), 127.0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert s.item() == float(ref_s)
    xt = torch.from_numpy(x)
    q8 = quantize_int8_plain(xt, abs_max_pair_plain(xt, xt), 0, 127.0)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(ref_q).astype(np.int8))
    # the twice-rounded ratio differs here: the test can tell
    s_t = torch.tensor(float(ref_s))
    twice = torch.clamp(torch.from_numpy(x), -s_t, s_t).mul_(127.0 / s_t).round_()
    assert not np.array_equal(twice.numpy(), np.asarray(ref_q))


@pytest.mark.parametrize("bits", [8, 4])
def test_ratio_and_combined_scale_bit_equal_to_the_jitted_jax_expressions(bits):
    """10**5 seeded scales: ``bin_cnt / s`` is one float32 division, and XLA
    folds the divisions by the constants ``bin_cnt**2`` and ``max_range``
    into products with their float32 reciprocals."""
    bin_cnt = bin_count(bits)
    rs = np.random.RandomState(bits)
    s = (rs.rand(100000) * 10 + 1e-3).astype(np.float32)
    sx, sy = (np.exp(rs.randn(100000) * 3).astype(np.float32) for _ in range(2))
    ts, tsx, tsy = (torch.from_numpy(a) for a in (s, sx, sy))
    ref_ratio = np.asarray(jax.jit(lambda a: bin_cnt / a)(jnp.asarray(s)))
    np.testing.assert_array_equal(quantize_ratio(ts, bin_cnt).numpy(), ref_ratio)
    ref_scale = np.asarray(jax.jit(lambda a, b: (a * b) / (bin_cnt * bin_cnt))(
        jnp.asarray(sx), jnp.asarray(sy)))
    np.testing.assert_array_equal(combined_scale(tsx, tsy, bin_cnt).numpy(), ref_scale)
    max_range = bin_cnt * bin_cnt            # what the quant pass writes
    ref_dq = np.asarray(jax.jit(lambda x, sc: x * (sc / max_range))(jnp.asarray(sx), jnp.asarray(sy)))
    np.testing.assert_array_equal((tsx * scale_by_reciprocal(tsy, max_range)).numpy(), ref_dq)
    # the twice-rounded ratio and the true quotient differ on these inputs: the test can tell
    assert not np.array_equal((bin_cnt / ts).numpy(), ref_ratio)
    assert not np.array_equal(((tsx * tsy) / (bin_cnt * bin_cnt)).numpy(), ref_scale)


@pytest.mark.parametrize("m,k,n,bits", [(64, 256, 384, 8), (7, 100, 33, 8), (5, 19, 40, 4)])
def test_the_kernel_routes_plain_versions_compose_to_the_jax_int8_matmul(m, k, n, bits):
    """The card's route -- one abs-max pass, two quantize passes (the
    weight transposed, rows zero-padded to 16 bytes), the GEMM with the
    dequant in its epilogue -- in its plain versions, bit-equal to the JAX
    package's ``int8_matmul`` under ``jit``."""
    rs = np.random.RandomState(m * k + n)
    x = rs.randn(m, k).astype(np.float32)
    y = (rs.rand(k, n).astype(np.float32) - 0.5) * 0.1
    bin_cnt = bin_count(bits)
    ref = np.asarray(jax.jit(lambda a, b: jax_int8_matmul(a, b, bits=bits))(
        jnp.asarray(x), jnp.asarray(y)))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    scales = abs_max_pair_plain(xt, yt)
    xq = quantize_int8_plain(xt, scales, 0, bin_cnt)
    yqt = quantize_int8_plain(yt, scales, 1, bin_cnt, transpose=True)
    assert xq.shape == (m, -(-k // 16) * 16) and yqt.shape == (n, xq.shape[1])
    assert not xq[:, k:].any() and not yqt[:, k:].any()
    np.testing.assert_array_equal(int8_mm_plain(xq, yqt, scales, bin_cnt).numpy(), ref)
    np.testing.assert_array_equal(int8_matmul(xt, yt, bits=bits).numpy(), ref)


def test_int8_matmul_wrapper_rejects_bad_arguments():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="x \\[M, K\\] and y \\[K, N\\]"):
        int8_matmul(x, torch.zeros(7, 3))
    from paddle_tpu_torch.ops.cuda.int8_matmul import int8_mm
    with pytest.raises(TypeError, match="int8 operands"):
        int8_mm(x, x)


@pytest.mark.parametrize("shape", [(1001,), (64, 130), (4096,)])
def test_fused_sgd_plain_bit_equal_to_jax_interpret(shape):
    """XLA compiles the kernel's ``p - lr * g`` into a fused multiply-add
    (one rounding), which the plain version reproduces exactly."""
    rs = np.random.RandomState(len(shape))
    p = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    lr = np.array([0.37], np.float32)     # lr * g of p's size: many roundings differ
    ref = np.asarray(jax_fused_sgd(jnp.asarray(p), jnp.asarray(g), jnp.asarray(lr), interpret=True))
    got = fused_sgd_plain(torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(lr))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the twice-rounded p - lr * g differs on these inputs: the test can tell
    assert not np.array_equal(ref, p - lr * g)


# --------------------------------------------------------- served logits


@pytest.fixture(scope="module")
def int8_inferencers():
    """{kernels: (JAX Inferencer, port Inferencer on the CPU with its
    weights, port float32 Inferencer with them)}, the first two with
    AmpConfig(bf16=False, quant=True)."""
    out = {}
    for kernels in (False, True):
        jax_inf = fluid.Inferencer(infer_func=_serving_model(fluid, jax_transformer),
                                   amp=_amp(fluid), kernels=kernels)
        pt_inf = pt.Inferencer(_serving_model(pt, pt_transformer), place=pt.CPUPlace(),
                               amp=_amp(pt), kernels=kernels)
        f32_inf = pt.Inferencer(_serving_model(pt, pt_transformer), place=pt.CPUPlace())
        params = {v.name: np.asarray(jax_inf.scope.find_var(v.name))
                  for v in jax_inf.inference_program.list_vars() if v.persistable}
        pt.params_from_numpy(params, pt_inf.scope, "cpu")
        pt.params_from_numpy(params, f32_inf.scope, "cpu")
        out[kernels] = (jax_inf, pt_inf, f32_inf)
    return out


def _quiet_share(pairs):
    """Share of (got, ref) batches within QUIET_REL_ERR, norm-relative."""
    return float(np.mean([np.linalg.norm(a - b) <= QUIET_REL_ERR * np.linalg.norm(b)
                          for a, b in pairs]))


@pytest.mark.parametrize("kernels", [False, True])
def test_each_int8_op_is_bit_equal_given_equal_inputs(kernels):
    """One fc through the quant pass: every intermediate (quantized
    operands, scales, combined scale, raw product, dequantized output) of
    the port equals the JAX package's bit for bit."""
    rs = np.random.RandomState(7)
    feed = {"x": rs.randn(6, 5, 48).astype(np.float32)}
    outs = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[5, 48])
            out = pkg.layers.fc(input=x, size=40, num_flatten_dims=2)
        if pkg is fluid:
            scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace(), amp=_amp(fluid),
                                                       kernels=kernels)
            exe.run(startup, scope=scope)
            params = {v.name: np.asarray(scope.find_var(v.name))
                      for v in main.list_vars() if v.persistable}
        else:
            scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), amp=_amp(pt), kernels=kernels)
            pt.params_from_numpy(params, scope, "cpu")
        rewritten = exe._apply_passes(main, ["x"], [out.name]) if pkg is pt else None
        w = params and [n for n in params if n.endswith(".w_0")][0]
        mul_out = [o for o in main.desc.block(0).ops if o.type == "mul"][0].output("Out")[0]
        fetch = [out.name, mul_out]
        if not kernels:
            fetch += ["x@QUANT", "x@QSCALE", w + "@QUANT", w + "@QSCALE",
                      mul_out + "@QSCALE", mul_out + "@QRAW"]
        outs.append([np.asarray(a) for a in exe.run(main, feed=feed, fetch_list=fetch,
                                                    scope=scope)])
    assert ("pallas_int8_matmul" in _types(rewritten)) == kernels
    for name, a, b in zip(fetch, *outs):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kernels", [False, True])
def test_served_int8_logits_match_jax(int8_inferencers, kernels):
    jax_inf, pt_inf, f32_inf = int8_inferencers[kernels]
    rs = np.random.RandomState(11)
    port, control = [], []
    for rows in (1, 3, 5, 8) * 4:
        feed = _feed(rs, rows)
        ref = np.asarray(jax_inf.infer(feed)[0])
        (got,) = pt_inf.infer(feed)
        assert got.shape == ref.shape == (rows, T, VOCAB) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=WHOLE_MODEL_ATOL, rtol=0)
        port.append((got, ref))
        control.append((f32_inf.infer(feed)[0], ref))
    assert _quiet_share(port) >= QUIET_SHARE
    assert _quiet_share(control) < QUIET_SHARE      # the gate rejects unquantized logits


def test_kernel_tier_int8_equals_the_simulated_path_bit_for_bit(int8_inferencers):
    """Same weights, same batch: the integer GEMM is exact and the float32
    fake-quant GEMM is exact while its partial sums stay below 2**24."""
    _, sim, _ = int8_inferencers[False]
    _, kern, _ = int8_inferencers[True]
    pt.params_from_numpy({v.name: sim.scope.find_var(v.name).numpy()
                          for v in sim.inference_program.list_vars() if v.persistable},
                         kern.scope, "cpu")
    feed = _feed(np.random.RandomState(12), 4)
    np.testing.assert_array_equal(kern.infer(feed)[0], sim.infer(feed)[0])
    types = _types(kern.exe._apply_passes(kern.inference_program, list(feed),
                                          [v.name for v in kern.predict_vars]))
    assert types["pallas_int8_matmul"] == N_MUL and types["pallas_gather"] == 4


def test_pallas_gather_with_padding_idx_and_its_gradient_match_jax():
    rs = np.random.RandomState(3)
    feed = {"ids": rs.randint(0, 64, (6, 7, 1)).astype(np.int64)}
    feed["ids"][0, :3] = 4
    res = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            ids = pkg.layers.data(name="ids", shape=[7, 1], dtype="int64")
            emb = pkg.layers.embedding(input=ids, size=[64, 72], padding_idx=4)
            loss = pkg.layers.mean(emb)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        w = main.global_block.all_parameters()[0].name
        if pkg is fluid:
            scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace(), kernels=True)
            exe.run(startup, scope=scope)
            init = {v.name: np.asarray(scope.find_var(v.name))
                    for v in main.list_vars() if v.persistable}
        else:
            scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), kernels=True)
            pt.params_from_numpy(init, scope, "cpu")
        res.append([np.asarray(a) for a in exe.run(main, feed=feed, fetch_list=[emb, w + "@GRAD"],
                                                   scope=scope)] + [np.asarray(scope.find_var(w))])
    rewritten = exe._apply_passes(main, ["ids"], [emb.name, w + "@GRAD"])
    assert {"pallas_gather", "pallas_scatter_add", "pallas_sgd"} <= set(_types(rewritten))
    for a, b in zip(*res):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7)
    assert (res[1][0][0, :3] == 0).all() and (res[1][1][4] == 0).all()


def test_flash_stamp_false_runs_the_plain_composed_attention(monkeypatch):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        q = pt.layers.data(name="q", shape=[5, 32])
        out = pt.layers.flash_attention(q, q, q, num_heads=2)
    op = [o for o in main.desc.block(0).ops if o.type == "flash_attention"][0]
    feed = {"q": np.random.RandomState(0).randn(3, 5, 32).astype(np.float32)}
    exe = pt.Executor(pt.CPUPlace())
    (ref,) = exe.run(main, feed=feed, fetch_list=[out])

    def refuse(*args):
        raise AssertionError("the kernel path ran under pallas_kernel=False")
    monkeypatch.setattr(fa.FlashAttention, "apply", refuse)
    op.attrs["pallas_kernel"] = False
    main.desc._bump()
    (got,) = exe.run(main, feed=feed, fetch_list=[out])
    np.testing.assert_array_equal(got, ref)


def test_pallas_int8_matmul_on_the_matmul_base_op_raises():
    """Named for what it checked before the matmul op was ported: the
    ``base_op="matmul"`` branch raised.  It is ported now
    (tests/test_torch_unfused_head.py holds it against the JAX lowering), so
    this checks the branch on the CPU: the transposed operands' int8 product
    times ``alpha``, bit-equal to ``int8_matmul_plain``."""
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.lower import LowerCtx
    from paddle_tpu_torch.core.registry import OPS
    rs = np.random.RandomState(3)
    x, y = (torch.from_numpy(rs.randn(*s).astype(np.float32)) for s in ((48, 32), (40, 48)))
    op = OpDesc(type="pallas_int8_matmul", inputs={"X": ["x"], "Y": ["y"]},
                outputs={"Out": ["o"]},
                attrs={"base_op": "matmul", "transpose_X": True, "transpose_Y": True,
                       "alpha": 0.5})
    ctx = LowerCtx(None, {"x": x, "y": y}, None, torch.device("cpu"))
    OPS.get("pallas_int8_matmul").lower(ctx, op)
    want = int8_matmul_plain(x.t().contiguous(), y.t().contiguous()) * 0.5
    assert torch.equal(ctx.read("o"), want) and want.shape == (32, 40)


# ----------------------------------------------------------- SGD training


def _build_train(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                    n_layer=N_LAYER, d_model=D_MODEL, n_head=N_HEAD,
                                    d_inner=D_INNER, fuse_final_ce=True)
        pkg.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return main, startup, loss


def test_sgd_training_through_the_kernel_tier_matches_jax():
    (jm, js, jl), (tm, ts, tl) = _build_train(fluid, jax_transformer), \
        _build_train(pt, pt_transformer)
    a, _ = jax_compose_passes(None, None, kernels=JaxKernelPolicy()).run(jm, fetch_list=[jl.name])
    b, _ = compose_passes(None, None, kernels=_jax_default_policy()).run(tm, fetch_list=[tl.name])
    _assert_descs_equal(a, b)
    params = tm.global_block.all_parameters()
    big = sum(int(np.prod(p.shape)) >= 4096 for p in params)
    types = _types(b)
    assert types["pallas_sgd"] == big and types["sgd"] == len(params) - big
    assert types["pallas_scatter_add"] == types["pallas_gather"] == 4

    jscope, jexe = fluid.Scope(), fluid.Executor(fluid.CPUPlace(), kernels=True)
    jexe.run(js, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace(), kernels=_jax_default_policy())
    persist = [v.name for v in jm.list_vars() if v.persistable]
    pt.params_from_numpy({n: np.asarray(jscope.find_var(n)) for n in persist}, tscope, "cpu")
    rs = np.random.RandomState(0)
    feed = {"src": rs.randint(1, VOCAB, (4, T, 1)), "trg": rs.randint(1, VOCAB, (4, T, 1)),
            "lbl": rs.randint(1, VOCAB, (4, T, 1)),
            "src@SEQ_LEN": np.array([32, 17, 5, 29], np.int32),
            "trg@SEQ_LEN": np.array([9, 32, 1, 20], np.int32)}
    losses = []
    for _ in range(3):
        (x,) = jexe.run(jm, feed=feed, fetch_list=[jl.name], scope=jscope)
        (y,) = texe.run(tm, feed=feed, fetch_list=[tl.name], scope=tscope)
        losses.append((float(np.asarray(x)), float(y)))
    ref, got = zip(*losses)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert got[0] > got[1] > got[2]


# ---------------------------------------------------------- the executor


def test_the_pipeline_runs_once_per_program_version(monkeypatch):
    calls = []
    real = PassPipeline.run

    def counting(self, program, **kw):
        calls.append(program.desc.uid)
        return real(self, program, **kw)
    monkeypatch.setattr(PassPipeline, "run", counting)
    main, out = _build_serving(pt, pt_transformer)
    startup = pt.Program()
    inf_scope = pt.Scope()
    with pt.unique_name.guard(), pt.program_guard(pt.Program(), startup):
        _serving_model(pt, pt_transformer)()
    exe = pt.Executor(pt.CPUPlace(), amp=_amp(pt), kernels=True)
    exe.run(startup, scope=inf_scope)
    n_startup = len(calls)
    rs = np.random.RandomState(0)
    for rows in (1, 2, 2, 4):
        exe.run(main, feed=_feed(rs, rows), fetch_list=[out], scope=inf_scope)
    assert len(calls) == n_startup + 1
    main.desc._bump()                     # a new version is rewritten again
    exe.run(main, feed=_feed(rs, 1), fetch_list=[out], scope=inf_scope)
    assert len(calls) == n_startup + 2
    exe.run(main, feed=_feed(rs, 1), fetch_list=[], scope=inf_scope)   # other fetches
    assert len(calls) == n_startup + 3


def test_kernels_none_is_off_on_the_cpu():
    exe = pt.Executor(pt.CPUPlace())
    assert exe.kernel_policy is None and exe.passes is None
    on = pt.Executor(pt.CPUPlace(), kernels=True)
    assert isinstance(on.kernel_policy, KernelPolicy)
    assert [p.name for p in on.passes.passes] == ["pallas-kernels"]
    assert pt.Executor(pt.CPUPlace(), amp=_amp(pt)).kernel_policy is None


@pytest.mark.parametrize("verify", ["error", "warn"])
def test_pass_pipeline_verification_is_not_ported_and_says_so(verify, serving_programs):
    """Named for what it checked before the analysis slice: ``verify="error"``
    and ``"warn"`` raised ``NotImplementedError``, and so did
    ``make_pipeline(True)``.  The verifier and the seed passes are ported
    now (tests/test_torch_analysis.py, tests/test_torch_passes.py), so it
    checks that both modes build and verify the quant rewrite before and
    after the pass (no finding added), with the JAX pipeline's counts, and
    that ``make_pipeline(True)`` is the seed pipeline."""
    (jm, jo), (tm, to) = serving_programs
    p = PassPipeline(["amp-quant-int8"], verify=verify)
    assert p.verify == verify
    _, res = p.run(tm, fetch_list=[to.name])
    _, jres = fluid.passes.PassPipeline(["amp-quant-int8"], verify=verify).run(
        jm, fetch_list=[jo.name])
    assert res.changed and res.verify_counts_pre and res.verify_counts_post
    assert (res.verify_counts_pre, res.verify_counts_post) == \
        (jres.verify_counts_pre, jres.verify_counts_post)
    assert res.verify_counts_post["error"] == res.verify_counts_post["warning"] == 0
    seed = pt.passes.make_pipeline(True)
    assert [q.name for q in seed.passes] == ["fuse-fc-softmax-ce", "bn-fold", "dead-op-elim",
                                             "donation-insert"]
    assert seed.verify == "error" and seed.fingerprint() == \
        fluid.passes.make_pipeline(True).fingerprint()


def test_bf16_amp_is_not_ported_and_says_so():
    """Named for what it checked before the bf16 slice: ``AmpConfig()``
    raised.  bf16 AMP is ported now (tests/test_torch_amp_bf16.py), so it
    checks that ``AmpConfig()`` and ``amp=True`` compose the amp-bf16 pass
    instead of raising."""
    assert [p.name for p in compose_passes(None, pt.amp.AmpConfig()).passes] == ["amp-bf16"]
    assert [p.name for p in pt.Executor(pt.CPUPlace(), amp=True).passes.passes] == ["amp-bf16"]
