"""The training step as one CUDA graph, held on the CPU: which programs may
be a graph, state updated in place, and the step against the JAX package.

A training step's block writes only state it reads (parameters, Adam's
moments and beta powers), so it may be one graph; the startup program
initializes state and runs op by op, and so does a block with a generic
grad of a random op (its re-run forks the generator).  The executor
updates state in place, as the reference's donated state is updated: the
optimizer kernels' plain versions write their inputs, the executor copies
every other written state value into the scope's tensor, and no scope
tensor moves.  The CPU runs the same write-back as a capture, so these
tests hold the semantics the graph needs.

A 2+2-layer ``train_network(fuse_final_ce=True)`` (vocab 1000, d_model 64,
4 heads, d_inner 256, max_len 32, batch 4) with ``Adam(1e-3)`` or
``SGD(0.1)`` is built by both packages; from the JAX startup's parameters
(``params_from_numpy``) three steps of the port's ``Executor(CPUPlace())``
give the JAX ``Executor``'s losses and parameters within the gates of
``tests/test_torch_training.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch.core.desc import OpDesc, grad_var_name
from paddle_tpu_torch.core.executor import _write_back, analyze_state, graph_blockers
from paddle_tpu_torch.core.lower import LowerCtx
from paddle_tpu_torch.core.registry import OPS, register_lowering
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.ops import shape_infer
from paddle_tpu_torch.ops.cuda import fused_optimizer as fo

from _torch_validate import _no_port_validate_findings  # noqa: F401

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER, BATCH = 1000, 64, 4, 256, 32, 2, 4
STEPS = 3
ADAM_LR, SGD_LR = 1e-3, 0.1
# tests/test_torch_training.py's gates: losses (XLA vs torch summation
# orders), Adam's parameters (where a gradient is ~0 an Adam step moves a
# parameter by ~lr * sign(g), so two correct implementations may differ by
# up to 2 * lr a step there), and the gradients' agreement, which bounds
# SGD's parameters: p - lr * sum(g) differs by at most lr * STEPS times the
# gradient gate, plus a float32 rounding of p a step.
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 5e-5, 1e-4
ZERO_GRAD = 1e-7
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
CPU = torch.device("cpu")


def _build(pkg, mod, sgd):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                    n_layer=N_LAYER, d_model=D_MODEL, n_head=N_HEAD,
                                    d_inner=D_INNER, fuse_final_ce=True)
        opt = pkg.optimizer.SGD(learning_rate=SGD_LR) if sgd else \
            pkg.optimizer.Adam(learning_rate=ADAM_LR)
        opt.minimize(loss)
    return main, startup, loss


def _feed():
    rs = np.random.RandomState(0)
    return {"src": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "trg": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "lbl": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "src@SEQ_LEN": np.array([32, 17, 5, 29], np.int32),
            "trg@SEQ_LEN": np.array([9, 32, 1, 20], np.int32)}


def _tensors(scope):
    return {n: v for n, v in scope._vars.items() if isinstance(v, torch.Tensor)}


@pytest.fixture(scope="module", params=["adam", "sgd"])
def steps(request):
    """Both packages' three steps from the JAX startup's parameters: the
    losses, the step-1 gradients, the final parameters, and the port's
    scope tensors' addresses before and after."""
    sgd = request.param == "sgd"
    jm, js, jl = _build(fluid, jax_transformer, sgd)
    tm, ts, tl = _build(pt, pt_transformer, sgd)
    params = [p.name for p in tm.global_block.all_parameters()]
    fetch = [tl.name] + [grad_var_name(p) for p in params]
    jscope, jexe = fluid.Scope(), fluid.Executor()
    jexe.run(js, scope=jscope)
    tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
    texe.run(ts, scope=tscope)
    persist = [v.name for v in jm.list_vars() if v.persistable]
    pt.params_from_numpy({n: np.asarray(jscope.find_var(n)) for n in persist}, tscope, "cpu")
    addrs = {n: v.data_ptr() for n, v in _tensors(tscope).items()}
    feed = _feed()
    jout = [np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)]
    tout = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    losses = [(float(jout[0]), float(tout[0]))]
    for _ in range(STEPS - 1):
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jl.name], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tl.name], scope=tscope)
        losses.append((float(np.asarray(a)), float(b)))
    final = {n: (np.asarray(jscope.find_var(n)), tscope.find_var(n).numpy()) for n in params}
    return dict(sgd=sgd, program=tm, scope=tscope, exe=texe, params=params, persist=persist,
                grads=dict(zip(params, zip(jout[1:], tout[1:]))), losses=losses, final=final,
                addrs=addrs, addrs_after={n: v.data_ptr() for n, v in _tensors(tscope).items()})


# ------------------------------------------------------------ eligibility


def test_a_training_step_may_be_a_graph_and_its_startup_may_not(steps):
    """The step writes parameters, moments and powers, all of which it
    reads: no blocker.  The startup program creates every persistable var:
    it initializes state, and runs op by op once."""
    main = steps["program"]
    _, startup, _ = _build(pt, pt_transformer, steps["sgd"])
    state_in, state_out = analyze_state(main.desc.block(0), _feed())
    assert set(state_out) <= set(state_in) and state_out
    assert graph_blockers(main, state_in, state_out) == []
    s_in, s_out = analyze_state(startup.desc.block(0), {})
    assert s_in == [] and len(s_out) == len(steps["persist"])
    (reason,) = graph_blockers(startup, s_in, s_out)
    assert reason.startswith(f"initializes state ({len(s_out)} vars: ")
    # the startup, the step fetching the gradients, the step fetching the loss
    info = steps["exe"].cache_info()["entries"]
    assert [e["graph_eligible"] for e in info] == [False, True, True]
    assert info[0]["reasons"] == [reason]
    assert all(e["reasons"] == ["the CPU runs the block op by op"] for e in info[1:])


@pytest.fixture
def random_scale_op():
    """A test-only op ``x * noise``, noise drawn from the executor's
    generator, with no grad lowering of its own: its grad is the generic
    one, which re-runs the forward on a fork of the generator."""
    op_type = "_test_step_graph_random_scale"
    assert not OPS.has(op_type)

    @register_lowering(op_type, draws=True)
    def _lower(ctx, op):
        x = ctx.read_slot(op, "X")
        ctx.write_slot(op, "Out", x * torch.rand(x.shape, generator=ctx.generator))

    shape_infer._same(op_type)     # Out is X's shape: the memory plan sizes it
    yield op_type
    del OPS._map[op_type]


def test_a_generic_grad_of_a_random_op_stays_eager(random_scale_op):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        h = pt.layers.fc(input=x, size=8)
        out = main.global_block.create_var(name="noisy", shape=(-1, 8), dtype="float32")
        main.global_block.append_op(random_scale_op, inputs={"X": [h]},
                                    outputs={"Out": [out]})
        loss = pt.layers.mean(out)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    types = [o.type for o in main.desc.block(0).ops]
    assert random_scale_op + "_grad" in types
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((2, 8), np.float32)}, fetch_list=[loss], scope=scope)
    entry = exe.cache_info()["entries"][-1]
    assert entry["graph_eligible"] is False
    assert entry["reasons"] == [
        f"forks the generator in a generic grad ({random_scale_op}_grad)"]


def test_dropout_training_step_may_be_a_graph():
    """dropout_grad reads the forward's mask (no fork): a dropout training
    step draws from the registered generator in a graph."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        h = pt.layers.dropout(pt.layers.fc(input=x, size=8), dropout_prob=0.5)
        loss = pt.layers.mean(pt.layers.fc(input=h, size=1))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    state_in, state_out = analyze_state(main.desc.block(0), {"x": None})
    assert graph_blockers(main, state_in, state_out) == []


# ------------------------------------------------------------ state in place


def test_every_state_tensor_keeps_its_address_over_three_steps(steps):
    """Parameters, moments, beta powers and the learning rate: the same
    tensors after three steps, with new values."""
    assert steps["addrs_after"] == steps["addrs"]
    n_state = len(steps["persist"])
    assert len(steps["addrs"]) == n_state
    n_params = len(steps["params"])
    assert n_state == n_params + (1 if steps["sgd"] else 4 * n_params + 1)
    for n in steps["params"]:
        ref, got = steps["final"][n]
        assert got.shape == ref.shape and np.isfinite(got).all()


def test_losses_against_the_jax_executor(steps):
    ref, got = zip(*steps["losses"])
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert got[0] > got[1] > got[2]


def test_parameters_against_the_jax_executor(steps):
    for name, (ref, got) in steps["final"].items():
        g1 = steps["grads"][name][0]
        if steps["sgd"]:
            tol = STEPS * SGD_LR * (GRAD_ATOL + GRAD_RTOL * np.abs(g1).max()) \
                + STEPS * np.spacing(np.abs(ref).astype(np.float32))
        else:
            tol = np.where(np.abs(g1) < ZERO_GRAD, 2 * ADAM_LR * STEPS,
                           PARAM_ATOL + PARAM_RTOL * np.abs(ref))
        assert (np.abs(got - ref) <= tol).all(), name


def test_beta_powers_follow_the_steps(steps):
    """Adam's beta powers, copied home after each step; SGD's learning rate
    (its only state besides the parameters), read and left as it was."""
    scope = steps["scope"]
    if steps["sgd"]:
        (lr,) = [n for n in steps["persist"] if n not in steps["params"]]
        assert scope.find_var(lr).numpy() == np.float32(SGD_LR)
        return
    pows = [n for n in steps["persist"] if "beta1_pow" in n]
    assert len(pows) == len(steps["params"])
    # three steps from the startup's 1.0, each a float32 product by 0.9
    want = np.float32(1.0)
    for _ in range(STEPS):
        want = np.float32(want * np.float32(0.9))
    for n in pows:
        assert scope.find_var(n).numpy() == want, n


@pytest.mark.parametrize("return_numpy", [True, False])
def test_a_fetched_state_name_does_not_change_with_the_next_step(return_numpy):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        loss = pt.layers.mean(pt.layers.fc(input=x, size=4))
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    w = main.global_block.all_parameters()[0].name
    m1 = [v.name for v in main.list_vars() if v.persistable and "moment1" in v.name][0]
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(1).randn(5, 8).astype(np.float32)}
    got = exe.run(main, feed=feed, fetch_list=[loss, w, m1], scope=scope,
                  return_numpy=return_numpy)
    kept = [np.array(a, copy=True) for a in got[1:]]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    for name, a, k in zip((w, m1), got[1:], kept):
        np.testing.assert_array_equal(np.asarray(a), k)
        # the control: the step did change the scope's tensor
        assert not np.array_equal(scope.find_var(name).numpy(), k), name


def test_running_the_startup_again_reinitializes_in_place():
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        pt.optimizer.SGD(learning_rate=0.1).minimize(
            pt.layers.mean(pt.layers.fc(input=x, size=4)))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    first = {n: v.clone() for n, v in _tensors(scope).items()}
    addrs = {n: v.data_ptr() for n, v in _tensors(scope).items()}
    exe.run(startup, scope=scope)
    assert {n: v.data_ptr() for n, v in _tensors(scope).items()} == addrs
    w = main.global_block.all_parameters()[0].name
    assert not torch.equal(scope.find_var(w), first[w])    # drawn again


# ------------------------------------------------------------ the write-back


def test_write_back_copies_into_homes_and_returns_the_rest():
    a, b = torch.zeros(3), torch.ones(2)
    homes = {"a": a, "b": b, "c": torch.zeros(4)}
    new_a, new_c = torch.full((3,), 5.0), torch.zeros(4, dtype=torch.float64)
    env = {"a": new_a, "b": b, "c": new_c, "d": torch.ones(1)}
    rest = _write_back(["a", "b", "c", "d", "e"], homes, env)
    assert homes["a"] is a and torch.equal(a, new_a)
    assert torch.equal(b, torch.ones(2))
    # another dtype, and state with no home: for the caller to bind
    assert rest.keys() == {"c", "d"} and rest["c"] is new_c


def test_write_back_reads_a_value_that_is_another_names_home():
    """``a`` takes ``b``'s old value while ``b`` is written: the copy reads
    ``b`` before it is overwritten."""
    a, b = torch.zeros(2), torch.full((2,), 7.0)
    _write_back(["a", "b"], {"a": a, "b": b}, {"a": b, "b": torch.full((2,), 9.0)})
    assert a.tolist() == [7.0, 7.0] and b.tolist() == [9.0, 9.0]


# ------------------------------------------------- K5/K6's plain versions


def _entries(rs, shapes):
    out = []
    for k, shape in enumerate(shapes):
        p, g, m1 = (torch.from_numpy(s * rs.randn(*shape).astype(np.float32))
                    for s in (1.0, 1e-2, 1e-3))
        m2 = torch.from_numpy(1e-5 * rs.rand(*shape).astype(np.float32))
        b1p, b2p = torch.tensor([0.9 ** (k + 1)]), torch.tensor([0.999 ** (k + 1)])
        out.append((p, g, m1, m2, b1p, b2p, torch.tensor([1e-3]), k % 2 == 0))
    return out


SHAPES = [(64, 33), (7,), (3 * fo.CHUNK + 5,), (1,), (0,)]


def test_plain_adam_in_place_bit_equal_to_out_of_place():
    entries = _entries(np.random.RandomState(2), SHAPES)
    want = [(fo.fused_adam_plain if e[7] else fo.adam_plain)(*e[:7], 0.9, 0.999, 1e-8)
            for e in entries]
    mine = [tuple(t.clone() for t in e[:7]) + e[7:] for e in entries]
    got = fo.fused_adam_multi(mine, 0.9, 0.999, 1e-8)
    for e, g, w in zip(mine, got, want):
        assert g[0] is e[0] and g[1] is e[2] and g[2] is e[3]
        # the powers go to fresh tensors; the inputs keep theirs
        assert g[3] is not e[4] and g[4] is not e[5]
        for a, b in zip(g, w):
            assert a.shape == b.shape and torch.equal(a, b)


def test_plain_sgd_in_place_bit_equal_to_out_of_place():
    entries = [e[:2] + (torch.tensor([0.37]),) for e in _entries(np.random.RandomState(3),
                                                                 SHAPES)]
    want = [fo.fused_sgd_plain(*e) for e in entries]
    mine = [(e[0].clone(),) + e[1:] for e in entries]
    for e, g, w in zip(mine, fo.fused_sgd_multi(mine), want):
        assert g is e[0] and torch.equal(g, w)


@pytest.mark.parametrize("op_type", ["sgd", "adam"])
def test_an_update_named_apart_from_its_input_leaves_the_input(op_type):
    (p, g, m1, m2, b1p, b2p, lr, _), = _entries(np.random.RandomState(4), [(9, 5)])
    vals = {"p": p, "p@GRAD": g, "m1": m1, "m2": m2, "b1": b1p, "b2": b2p, "lr": lr}
    if op_type == "sgd":
        op = OpDesc(type="sgd", inputs={"Param": ["p"], "Grad": ["p@GRAD"],
                                        "LearningRate": ["lr"]},
                    outputs={"ParamOut": ["p_new"]})
        want = {"p_new": fo.fused_sgd_plain(p, g, lr)}
    else:
        op = OpDesc(type="adam", inputs={"Param": ["p"], "Grad": ["p@GRAD"], "Moment1": ["m1"],
                                         "Moment2": ["m2"], "Beta1Pow": ["b1"],
                                         "Beta2Pow": ["b2"], "LearningRate": ["lr"]},
                    outputs={"ParamOut": ["p_new"], "Moment1Out": ["m1"],
                             "Moment2Out": ["m2_new"], "Beta1PowOut": ["b1"],
                             "Beta2PowOut": ["b2"]},
                    attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
        outs = fo.adam_plain(p, g, m1, m2, b1p, b2p, lr, 0.9, 0.999, 1e-8)
        want = dict(zip(("p_new", "m1", "m2_new", "b1", "b2"), outs))
    env = {k: v.clone() for k, v in vals.items()}
    before = dict(env)
    ctx = LowerCtx(None, env, torch.Generator(), CPU)
    OPS.get(op_type).lower(ctx, op)
    for name, w in want.items():
        assert torch.equal(ctx.read(name), w), name
    # the inputs named apart keep their values; m1 (named alike) is updated in place
    assert torch.equal(before["p"], p)
    if op_type == "adam":
        assert torch.equal(before["m2"], m2)
        assert ctx.read("m1") is before["m1"]
