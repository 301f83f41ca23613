"""Repairs of the port against the JAX package, each held on the CPU:

* ``fc`` over several inputs appends ``sum`` over the ``mul`` results, as
  the JAX package's ``fc`` does: equal ProgramDescs, equal fetches;
* ``pallas_adam`` on the CPU computes the JAX package's ``fused_adam``
  expression (``(1 - b2) * (g * g)``), ``adam`` the composed one
  (``((1 - b2) * g) * g``);
* the generic grad's forward re-run draws from a fork of the generator's
  state and leaves the live generator as it was;
* K3's plain version sums each row's incoming rows in ascending n from
  +0.0, the order the CUDA kernel keeps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.core.desc import OpDesc as JaxOpDesc
from paddle_tpu.core.lower import LowerCtx as JaxLowerCtx
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.ops.pallas.fused_optimizer import fused_adam as jax_fused_adam
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.lower import LowerCtx, lower_op
from paddle_tpu_torch.core.registry import OPS, register_lowering
from paddle_tpu_torch.ops.cuda.embedding import scatter_add_rows, scatter_add_rows_plain
from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam_plain

from _torch_validate import _no_port_validate_findings  # noqa: F401

FC_ATOL = 1e-5     # float32, XLA vs torch summation orders over 12 + 7 terms


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


# ------------------------------------------------------ fc over several inputs


@pytest.mark.parametrize("act", [None, "relu"])
def test_fc_over_two_inputs_matches_the_jax_package(act):
    rs = np.random.RandomState(11)
    feed = {"a": rs.randn(4, 12).astype(np.float32), "b": rs.randn(4, 7).astype(np.float32)}
    progs, outs = [], []
    jax_scope = fluid.Scope()
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            a = pkg.layers.data(name="a", shape=[12])
            b = pkg.layers.data(name="b", shape=[7])
            out = pkg.layers.fc(input=[a, b], size=5, act=act)
        progs.append((main, startup))
        if pkg is fluid:
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup, scope=jax_scope)
            params = {v.name: np.asarray(jax_scope.find_var(v.name))
                      for v in main.list_vars() if v.persistable}
            outs.append(exe.run(main, feed=feed, fetch_list=[out], scope=jax_scope)[0])
        else:
            scope = pt.Scope()
            pt.params_from_numpy(params, scope, "cpu")
            outs.append(pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[out],
                                                       scope=scope)[0])
    (jm, js), (tm, ts) = progs
    for a, b in ((jm, tm), (js, ts)):
        assert _scrub(a.desc.to_dict()) == _scrub(b.desc.to_dict())
    types = [o.type for o in tm.desc.block(0).ops]
    assert types[:4] == ["mul", "mul", "sum", "elementwise_add"]
    assert len(params) == 3                      # two weights and one bias
    ref, got = np.asarray(outs[0]), np.asarray(outs[1])
    assert got.shape == ref.shape == (4, 5)
    np.testing.assert_allclose(got, ref, atol=FC_ATOL, rtol=0)


# ----------------------------------------------------- adam and pallas_adam

_ADAM_IN = ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
_ADAM_OUT = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut")
_ADAM_ATTRS = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
# the port's CPU bodies against the jitted JAX package, each output's
# largest difference over its largest value: XLA contracts b1 * m + (1 -
# b1) * g into a fused multiply-add and torch does not, so single elements
# differ in their last bits (a float32 ulp is 6e-8 relative; read on the
# CPU: at most 8.0e-8, in 2 % of the parameter's elements and a quarter of
# each moment's)
ADAM_VS_JAX_RTOL = 2e-7


def _adam_inputs():
    rs = np.random.RandomState(12)
    n = 100000
    p, g, m1 = rs.randn(n).astype(np.float32), (1e-2 * rs.randn(n)).astype(np.float32), \
        (1e-3 * rs.randn(n)).astype(np.float32)
    m2 = (1e-5 * rs.rand(n)).astype(np.float32)
    return [p, g, m1, m2, np.array([0.9 ** 3], np.float32), np.array([0.999 ** 3], np.float32),
            np.array([1e-3], np.float32)]


def _port_update(op_type, arrays):
    op = OpDesc(type=op_type, inputs={s: [s] for s in _ADAM_IN},
                outputs={s: [s] for s in _ADAM_OUT}, attrs=dict(_ADAM_ATTRS))
    ctx = LowerCtx(None, {s: torch.from_numpy(a.copy()) for s, a in zip(_ADAM_IN, arrays)},
                   torch.Generator(), torch.device("cpu"))
    lower_op(ctx, op)
    return [ctx.read(s) for s in _ADAM_OUT]


def _jax_adam(arrays):
    """The JAX package's ``adam`` lowering, jitted as its Executor runs it."""
    op = JaxOpDesc(type="adam", inputs={s: [s] for s in _ADAM_IN},
                   outputs={s: [s] for s in _ADAM_OUT}, attrs=dict(_ADAM_ATTRS))

    def run(*vals):
        ctx = JaxLowerCtx(None, dict(zip(_ADAM_IN, vals)), None)
        JAX_OPS.get("adam").lower(ctx, op)
        return [ctx.env[s] for s in _ADAM_OUT]
    return [np.asarray(o) for o in jax.jit(run)(*(jnp.asarray(a) for a in arrays))]


def _jax_fused_adam(arrays):
    """The JAX package's ``fused_adam`` off the Pallas path, jitted."""
    def run(*vals):
        return jax_fused_adam(*vals, 0.9, 0.999, 1e-8, interpret=False)
    return [np.asarray(o) for o in jax.jit(run)(*(jnp.asarray(a) for a in arrays))]


def _max_rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_pallas_adam_on_the_cpu_is_fused_adam_plain_bit_for_bit():
    arrays = _adam_inputs()
    got = _port_update("pallas_adam", arrays)
    want = fused_adam_plain(*(torch.from_numpy(a.copy()) for a in arrays), 0.9, 0.999, 1e-8)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_adam_on_the_cpu_keeps_the_composed_expression():
    arrays = _adam_inputs()
    got = _port_update("adam", arrays)
    p, g, m1, m2, b1p, b2p, lr = (torch.from_numpy(a.copy()) for a in arrays)
    m2n = 0.999 * m2 + (1 - 0.999) * g * g
    assert torch.equal(got[2], m2n)
    # the two op types differ in Moment2's last bits, as in the JAX package
    fused = _port_update("pallas_adam", arrays)
    assert not torch.equal(got[2], fused[2])


@pytest.mark.parametrize("op_type", ["adam", "pallas_adam"])
def test_adam_bodies_within_the_bound_of_their_jax_counterparts(op_type):
    """``adam`` against the JAX ``adam`` lowering, ``pallas_adam`` against
    the JAX ``fused_adam`` off the Pallas path, both jitted: within
    ADAM_VS_JAX_RTOL of each output's largest value, not bit-equal (XLA's
    fused multiply-adds); the beta powers are one product each and equal."""
    arrays = _adam_inputs()
    got = [t.numpy() for t in _port_update(op_type, arrays)]
    ref = _jax_adam(arrays) if op_type == "adam" else _jax_fused_adam(arrays)
    for name, a, b in zip(_ADAM_OUT, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _max_rel(a, b) <= ADAM_VS_JAX_RTOL, name
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[4], ref[4])


# ----------------------------------------- the generic grad's random re-run


def test_generic_grad_rerun_leaves_the_live_generator_alone():
    """A test-only op ``x * noise`` with noise drawn from ``ctx.generator``:
    its generic grad re-runs the forward under autograd.  The re-run draws
    the same noise the forward drew from the same state, and the live
    generator's state is the same after the grad op as before it."""
    op_type = "_test_random_scale"
    assert not OPS.has(op_type)

    @register_lowering(op_type)
    def _lower(ctx, op):
        x = ctx.read_slot(op, "X")
        noise = torch.rand(x.shape, generator=ctx.generator, dtype=x.dtype)
        ctx.write_slot(op, "Out", x * noise)

    try:
        gen = torch.Generator().manual_seed(5)
        x = torch.randn(3, 4, generator=torch.Generator().manual_seed(6))
        state = gen.get_state()
        ctx = LowerCtx(None, {"x": x}, gen, torch.device("cpu"))
        lower_op(ctx, OpDesc(type=op_type, inputs={"X": ["x"]}, outputs={"Out": ["out"]}))
        noise = ctx.read("out") / x
        gen.set_state(state)                    # the grad re-runs from the forward's state
        ctx.write("out@GRAD", torch.ones(3, 4))
        grad_op = OpDesc(type=op_type + "_grad",
                         inputs={"X": ["x"], "__out__Out": ["out"], "__outgrad__Out": ["out@GRAD"]},
                         outputs={"X@GRAD_SLOT": ["x@GRAD"]})
        lower_op(ctx, grad_op)
        assert torch.equal(gen.get_state(), state)
        torch.testing.assert_close(ctx.read("x@GRAD"), noise, rtol=1e-6, atol=0)
    finally:
        del OPS._map[op_type]


# ------------------------------------------------------ K3's order of addition


@pytest.mark.parametrize("v,d,n", [(256, 64, 4096), (1000, 16, 300), (7, 3, 50), (5, 4, 0)])
def test_scatter_add_plain_is_an_ascending_loop_bit_for_bit(v, d, n):
    """Rows of mixed magnitude (so the order of addition shows in the last
    bits), duplicates, and ids out of range on both sides."""
    g = torch.Generator().manual_seed(v + n)
    ids = torch.randint(-3, v + 3, (n,), generator=g, dtype=torch.int32)
    if n:
        ids[: min(n, 4)] = torch.tensor([-1, v, 0, 0], dtype=torch.int32)[: min(n, 4)]
    rows = torch.randn(n, d, generator=g) * torch.exp(4 * torch.randn(n, 1, generator=g))
    want = torch.zeros(v, d)
    for i in range(n):
        j = int(ids[i])
        if 0 <= j < v:
            want[j] += rows[i]
    got = scatter_add_rows_plain(torch.empty(v, d), ids, rows)
    assert torch.equal(got, want)
    assert torch.equal(scatter_add_rows(torch.empty(v, d), ids, rows), want)


# ------------------------------------------------- C8 and C9's evidence (§C)
def _small_net():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[6], dtype="float32")
        h = pt.layers.fc(input=x, size=8, act="relu")
        y = pt.layers.fc(input=h, size=3)
    return main, startup, y


def test_divergence_report_names_the_first_differing_op():
    """C9's printer (tests/test_torch_gpu.py, on a failed replay-vs-eager
    gate): two runs' op outputs, one of them bent at the first fc's
    activation and everything after it; the report names that op and the
    largest difference, and two equal runs read bit-equal."""
    from paddle_tpu_torch.profiling.divergence import (divergence_report, first_differing_op,
                                                       op_output_names)
    main, startup, _ = _small_net()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    names = op_output_names(main)
    feed = {"x": np.random.RandomState(0).randn(4, 6).astype(np.float32)}
    run = lambda: dict(zip(names, exe._run_eager(main, feed=feed, fetch_list=names,  # noqa: E731
                                                 scope=scope)))
    want, got = run(), run()
    assert "every one of" in divergence_report(main, got, want)
    ops = main.desc.block(0).ops
    (relu_i,) = [i for i, o in enumerate(ops) if o.type == "relu"]
    bent = ops[relu_i].output_names()[0]
    got[bent] = got[bent] + 0.25
    for o in ops[relu_i + 1:]:
        for n in o.output_names():
            got[n] = got[n] + 1.0
    i, typ, name, diff = first_differing_op(main, got, want)
    assert (i, typ, name) == (relu_i, "relu", bent) and diff == pytest.approx(0.25)
    report = divergence_report(main, got, want)
    assert f"op {relu_i} (relu)" in report and "max abs diff 1.000e+00" in report


def test_c8_evidence_names_the_worst_state_tensor_and_the_conv_kernels():
    """C8's printer (chip_smoke.py phase 21 (d), on a failed card-vs-CPU
    gate): a forced mismatch of one state tensor's change."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_c8", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    d_cpu = np.linspace(-1, 1, 12).reshape(3, 4) * 1e-3
    d_card = d_cpu.copy()
    d_card[2, 1] += 5e-5
    kernels = {"sm90_xmma_wgrad_implicit_gemm_indexed": 40, "cudnn::winograd_fprop": 18,
               "elementwise_kernel": 300}
    text = cs.c8_evidence("batch_norm_18.w_1_velocity_0 (step 2)", 6.37e-3, d_card, d_cpu,
                          kernels, {"deterministic": False, "benchmark": False})
    assert "batch_norm_18.w_1_velocity_0 (step 2)" in text and "6.370e-03" in text
    assert "'deterministic': False" in text and "(2, 1)" in text
    assert "sm90_xmma_wgrad_implicit_gemm_indexed" in text and "winograd_fprop" in text
    assert "elementwise_kernel" not in text and "2 names of 3 kernels" in text
