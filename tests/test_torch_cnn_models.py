"""The CNN slice's models, nets and datasets against the JAX package, on
the CPU.

* bench.py's ResNet-50 step (``resnet.train_network`` at 224 x 224, 1,000
  classes, ``Momentum(0.01, 0.9)``): equal ProgramDescs, 535 ops, and under
  ``amp-bf16`` 975 ops with 440 casts, op for op (built, not run);
* ResNet-18 at 32 x 32, batch 8, 10 classes (bench.py's shapes off the
  TPU), from the JAX startup's parameters: the loss and accuracy, every
  parameter's gradient, the saved batch statistics, and after two Momentum
  steps each persistable's change (parameters, velocities, running
  statistics), each within the gate written beside it; three faults
  planted in ``batch_norm`` (an unbiased running variance, torch's momentum
  convention, the variance saved where 1/sqrt(var + eps) belongs) each
  fail a gate; ``bn-fold`` on its ``clone(for_test=True)``;
* ``resnet_cifar10`` at depth 8, the MNIST CNN with Adam, VGG16's
  ProgramDesc and its ``for_test`` forward;
* ``nets`` and the synthetic datasets.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.dataset.cifar
import paddle_tpu.dataset.mnist
import paddle_tpu.models.mnist
import paddle_tpu.models.resnet
import paddle_tpu.models.vgg
import paddle_tpu.nets
import paddle_tpu.passes  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import OPS
from test_torch_cnn_ops import (build_both, descs_equal, fetch_names, persistables,
                                start_both)

from _torch_validate import _no_port_validate_findings  # noqa: F401

# ResNet-18 at 32 x 32, batch 8, port against the JAX package.  Readings on
# the CPU (x86-64): the loss 7.9e-7 and 5.0e-6 relative (steps 1, 2);
# gradients <= 1.3e-5 norm-relative; each persistable's change over two
# steps <= 5.8e-5 (the running statistics' <= 1.6e-5); the saved batch
# statistics <= 4.4e-6.  The planted faults read 0.34 (an unbiased running
# variance) and 6.2 (torch's momentum convention) on the statistics' gate,
# and 5.4 (the variance saved as itself) on the saved statistics'.
LOSS_RTOL = 1e-5
GRAD_NREL = 1e-4
CHANGE_NREL = 5e-4
SAVED_NREL = 1e-5
BN_FOLD_RTOL = 2e-4          # the JAX package's fold tolerance


def nrel(a, b):
    """||a - b|| / ||b||."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _resnet_step(pkg, depth=18, hw=32, classes=10, cifar=False):
    image = pkg.layers.data(name="image", shape=[3, hw, hw], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    if cifar:
        logits = pkg.models.resnet.resnet_cifar10(image, class_dim=classes, depth=depth)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        acc = pkg.layers.accuracy(pkg.layers.softmax(logits), label)
    else:
        loss, acc = pkg.models.resnet.train_network(image, label, class_dim=classes,
                                                    depth=depth)
    pkg.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss, acc


def _image_feed(rows, hw, classes, seed):
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(rows, 3, hw, hw).astype(np.float32),
            "label": rs.randint(0, classes, (rows, 1)).astype(np.int64)}


def test_resnet50_bench_program_matches_the_jax_package():
    """bench.py:120-142's step, built by both packages: 535 ops."""
    (jm, _, _), (tm, _, _) = build_both(lambda pkg: _resnet_step(pkg, 50, 224, 1000))
    types = [o.type for o in tm.desc.block(0).ops]
    assert len(types) == 535
    want = {"conv2d": 53, "batch_norm": 53, "conv2d_grad": 53, "batch_norm_grad": 53,
            "relu": 49, "relu_grad": 49, "elementwise_add": 17, "elementwise_add_grad": 17,
            "sum": 16, "momentum": 161, "pool2d": 2, "pool2d_grad": 2, "mul": 1,
            "softmax_with_cross_entropy": 1, "mean": 1, "softmax": 1, "top_k": 1,
            "accuracy": 1}
    assert {k: types.count(k) for k in want} == want
    persist = persistables(tm)
    assert len(persist) == 429        # 161 parameters, 161 velocities, 106 statistics, the rate
    assert len(tm.global_block.all_parameters()) == 267   # the statistics are parameters too


def test_resnet50_amp_program_matches_op_for_op():
    """``amp-bf16`` over the same step: 975 ops, 440 casts, equal to the
    JAX pass's rewrite op for op.  (The port's repair of the reference
    pass's stale casts after a ``sum`` merge changes nothing here: no cast
    of a merged gradient is read after its merge.)"""
    (jm, _, (jl, _)), (tm, _, (tl, _)) = build_both(lambda pkg: _resnet_step(pkg, 50, 224, 1000))
    jp, _ = fluid.passes.PassPipeline(["amp-bf16"], verify="error").run(jm, fetch_list=[jl.name])
    tp, _ = pt.passes.PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=[tl.name])
    types = [o.type for o in tp.desc.block(0).ops]
    assert (len(types), types.count("cast")) == (975, 440)
    descs_equal(jp, tp)


STEPS = 2


def _bn_ops(main):
    return [o for o in main.desc.block(0).ops if o.type == "batch_norm"]


def _run_port(port_side, state, feed, fetch):
    """Two steps of the port from ``state``: (the fetches of each step, the
    persistables after them)."""
    tm, ts, _ = port_side
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(ts, scope=scope)
    pt.params_from_numpy(state, scope, "cpu")
    outs = [[np.asarray(a) for a in exe.run(tm, feed=feed, fetch_list=fetch, scope=scope)]
            for _ in range(STEPS)]
    return outs, {n: scope.find_var(n).numpy().copy() for n in state}, scope


@pytest.fixture(scope="module")
def resnet18():
    """Both packages' ResNet-18 step at 32 x 32, batch 8: two steps from
    the JAX startup's state, fetching the loss, the accuracy, every
    parameter's gradient and every batch_norm's saved statistics."""
    from conftest_helpers import fresh_framework_state
    fresh_framework_state()
    jax_side, port_side = build_both(_resnet_step)
    jexe, jscope, _, _, state = start_both(jax_side, port_side)
    jm = jax_side[0]
    loss, acc = fetch_names(jax_side[2])
    params = [p.name for p in jm.global_block.all_parameters()
              if jm.desc.block(0).find_var(p.name + "@GRAD") is not None]
    saved = [o.output(s)[0] for o in _bn_ops(jm) for s in ("SavedMean", "SavedVariance")]
    fetch = [loss, acc] + [p + "@GRAD" for p in params] + saved
    feed = _image_feed(8, 32, 10, seed=0)
    jouts = [[np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)]
             for _ in range(STEPS)]
    jstate = {n: np.asarray(jscope.find_var(n)).copy() for n in state}
    touts, tstate, tscope = _run_port(port_side, state, feed, fetch)
    return {"jax_side": jax_side, "port_side": port_side, "state": state, "feed": feed,
            "fetch": fetch, "n_grads": len(params), "jouts": jouts,
            "jstate": jstate, "touts": touts, "tstate": tstate, "tscope": tscope}


def _worst_change(got_state, r, names=None):
    """The largest norm-relative distance of a persistable's change over the
    steps from the JAX package's, and its name."""
    worst, name = 0.0, None
    for n in names or r["state"]:
        want = r["jstate"][n] - r["state"][n]
        if not np.any(want):
            continue
        e = nrel(got_state[n] - r["state"][n], want)
        if e > worst:
            worst, name = e, n
    return worst, name


def _stat_names(r):
    return [n for o in _bn_ops(r["jax_side"][0]) for n in (o.input("Mean")[0],
                                                           o.input("Variance")[0])]


def _worst_saved(touts, r):
    lo = 2 + r["n_grads"]
    return max(nrel(a, b) for a, b in zip(touts[0][lo:], r["jouts"][0][lo:]))


def test_resnet18_loss_accuracy_and_gradients_match(resnet18):
    r = resnet18
    for step in range(STEPS):
        (jl, ja), (tl, ta) = r["jouts"][step][:2], r["touts"][step][:2]
        assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl)), (step, tl, jl)
        assert float(ta) == float(ja)
    grads = zip(r["touts"][0][2:2 + r["n_grads"]], r["jouts"][0][2:2 + r["n_grads"]])
    worst = max(nrel(a, b) for a, b in grads)
    assert worst <= GRAD_NREL, worst
    assert _worst_saved(r["touts"], r) <= SAVED_NREL


def test_resnet18_two_momentum_steps_match(resnet18):
    """Each persistable's change over the two steps: the 62 parameters,
    their velocities and the 40 running statistics."""
    r = resnet18
    worst, name = _worst_change(r["tstate"], r)
    assert worst <= CHANGE_NREL, (worst, name)
    stats = _stat_names(r)
    assert len(stats) == 40 and all(np.any(r["tstate"][n] != r["state"][n]) for n in stats)


def _planted(fault):
    """The port's batch_norm with one fault of a torch translation planted
    after the real lowering."""
    real = OPS.get("batch_norm").lower

    def lower(ctx, op):
        x = ctx.read_slot(op, "X")
        old_mean, old_var = ctx.read_slot(op, "Mean"), ctx.read_slot(op, "Variance")
        real(ctx, op)
        m, eps = op.attr("momentum"), op.attr("epsilon")
        saved_inv = ctx.read(op.output("SavedVariance")[0])
        var = 1.0 / saved_inv ** 2 - eps
        mean = ctx.read(op.output("SavedMean")[0])
        if fault == "unbiased_running_variance":
            n = x.numel() // x.shape[1]
            ctx.write_slot(op, "VarianceOut", m * old_var + (1 - m) * var * n / (n - 1))
        elif fault == "torch_momentum":
            ctx.write_slot(op, "MeanOut", (1 - m) * old_mean + m * mean)
            ctx.write_slot(op, "VarianceOut", (1 - m) * old_var + m * var)
        elif fault == "saved_variance_as_variance":
            ctx.write_slot(op, "SavedVariance", var)
    return lower


@pytest.mark.parametrize("fault", ["unbiased_running_variance", "torch_momentum",
                                   "saved_variance_as_variance"])
def test_each_planted_batch_norm_fault_fails_a_gate(resnet18, monkeypatch, fault):
    r = resnet18
    monkeypatch.setattr(OPS.get("batch_norm"), "lower", _planted(fault))
    touts, tstate, _ = _run_port(r["port_side"], r["state"], r["feed"], r["fetch"])
    if fault == "saved_variance_as_variance":
        assert _worst_saved(touts, r) > SAVED_NREL
    else:
        worst, name = _worst_change(tstate, r, _stat_names(r))
        assert worst > CHANGE_NREL, (worst, name)


def test_bn_fold_on_the_resnet18_eval_clone(resnet18):
    """``bn-fold`` over ``clone(for_test=True)`` of the trained ResNet-18:
    every batch_norm folded (into a bias add), the logits within the fold
    tolerance, the input program and the scope's values untouched."""
    r = resnet18
    tm, scope = r["port_side"][0], r["tscope"]
    (logits,) = [o.input("Logits")[0] for o in tm.desc.block(0).ops
                 if o.type == "softmax_with_cross_entropy"]
    test = tm.clone(for_test=True)._prune([logits])
    before = {n: scope.find_var(n).clone() for n in r["state"]}
    n_ops = len(test.desc.block(0).ops)
    folded, res = pt.passes.PassPipeline(["bn-fold"], verify="off").run(
        test, fetch_list=[logits], scope=scope)
    assert res.passes[0].ops_replaced == 20 and len(test.desc.block(0).ops) == n_ops
    assert "batch_norm" not in [o.type for o in folded.desc.block(0).ops]
    exe = pt.Executor(pt.CPUPlace())
    x = {"image": r["feed"]["image"][:4]}
    want = exe.run(test, feed=x, fetch_list=[logits], scope=scope)[0]
    got = exe.run(folded, feed=x, fetch_list=[logits], scope=scope)[0]
    np.testing.assert_allclose(got, want, rtol=BN_FOLD_RTOL,
                               atol=BN_FOLD_RTOL * float(np.abs(want).max()))
    for n, v in before.items():
        assert torch.equal(scope.find_var(n), v), n


def _carried_run(build, feed, steps, fetch_extra=None):
    """Both packages' ``build(pkg)`` (returning the vars to fetch) run
    ``steps`` times from the JAX startup's state; returns (JAX fetches,
    port fetches, JAX state, port state) of the last step."""
    jax_side, port_side = build_both(build)
    jexe, jscope, texe, tscope, state = start_both(jax_side, port_side)
    fetch = fetch_names(jax_side[2]) + (fetch_extra(jax_side[0]) if fetch_extra else [])
    for _ in range(steps):
        jout = [np.asarray(a) for a in jexe.run(jax_side[0], feed=feed, fetch_list=fetch,
                                                scope=jscope)]
        tout = [np.asarray(a) for a in texe.run(port_side[0], feed=feed, fetch_list=fetch,
                                                scope=tscope)]
    return (jout, tout, {n: np.asarray(jscope.find_var(n)) for n in state},
            {n: tscope.find_var(n).numpy() for n in state}, state)


def test_resnet_cifar10_depth8_step_matches():
    """``resnet_cifar10`` at depth 8 (one basic block a stage), batch 4:
    the loss, every gradient, and the persistables after a step."""
    def grads(main):
        return [p.name + "@GRAD" for p in main.global_block.all_parameters()
                if main.desc.block(0).find_var(p.name + "@GRAD") is not None]
    jout, tout, jst, tst, st = _carried_run(lambda pkg: list(_resnet_step(pkg, 8, cifar=True)),
                                            _image_feed(4, 32, 10, seed=3), 1, grads)
    assert abs(float(tout[0]) - float(jout[0])) <= LOSS_RTOL * abs(float(jout[0]))
    assert max(nrel(a, b) for a, b in zip(tout[2:], jout[2:])) <= GRAD_NREL
    assert max(nrel(tst[n] - st[n], jst[n] - st[n]) for n in st if np.any(jst[n] != st[n])) \
        <= CHANGE_NREL


# MNIST + Adam, 3 steps: XLA fuses Adam's moment updates into FMAs and torch
# rounds twice (tests/test_torch_optimizers.py), so the parameters carry a
# few float32 ulps a step; the loss likewise
MNIST_STEP_ATOL = 2e-5


def test_mnist_cnn_with_adam_matches_over_three_steps():
    def build(pkg):
        image = pkg.layers.data(name="pixel", shape=[1, 28, 28], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc = pkg.models.mnist.train_network(image, label)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return [loss, acc]
    images, labels = pt.dataset.mnist._synthetic(16, seed=0)
    feed = {"pixel": images.reshape(16, 1, 28, 28), "label": labels.reshape(16, 1)}
    jout, tout, jst, tst, _ = _carried_run(build, feed, 3)
    assert abs(float(tout[0]) - float(jout[0])) <= MNIST_STEP_ATOL
    for n in jst:
        np.testing.assert_allclose(tst[n], jst[n], atol=MNIST_STEP_ATOL, rtol=0, err_msg=n)


def test_mnist_mlp_program_matches():
    build_both(lambda pkg: pkg.models.mnist.train_network(
        pkg.layers.data(name="pixel", shape=[784]),
        pkg.layers.data(name="label", shape=[1], dtype="int64"), model="mlp"))


def test_vgg16_program_and_eval_forward_match():
    """VGG16's training step (its dropouts fixed at 0.5) as a ProgramDesc,
    and the ``for_test`` clone's forward at 32 x 32 from the same
    parameters (dropout off, batch_norm on the running statistics)."""
    def build(pkg):
        image = pkg.layers.data(name="image", shape=[3, 32, 32], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        loss, acc = pkg.models.vgg.train_network(image, label, class_dim=10)
        pkg.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
        return loss
    jax_side, port_side = build_both(build)
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    tests = []
    for main in (jax_side[0], port_side[0]):
        (logits,) = [o.input("Logits")[0] for o in main.desc.block(0).ops
                     if o.type == "softmax_with_cross_entropy"]
        tests.append((main.clone(for_test=True)._prune([logits]), logits))
    descs_equal(tests[0][0], tests[1][0])
    x = {"image": _image_feed(2, 32, 10, seed=4)["image"]}
    want = np.asarray(jexe.run(tests[0][0], feed=x, fetch_list=[tests[0][1]], scope=jscope)[0])
    got = texe.run(tests[1][0], feed=x, fetch_list=[tests[1][1]], scope=tscope)[0]
    assert nrel(got, want) <= 1e-5


NETS = {
    "simple_img_conv_pool": (lambda pkg, x: pkg.nets.simple_img_conv_pool(
        x, num_filters=4, filter_size=3, pool_size=2, pool_stride=2, act="relu",
        conv_padding=1), (2, 3, 8, 8)),
    "img_conv_group": (lambda pkg, x: pkg.nets.img_conv_group(
        x, conv_num_filter=[4, 5], pool_size=2, pool_stride=2, conv_act="relu",
        conv_with_batchnorm=[True, False]), (2, 3, 8, 8)),
    "glu": (lambda pkg, x: pkg.nets.glu(x, dim=-1), (3, 8)),
    "scaled_dot_product_attention": (lambda pkg, x: pkg.nets.scaled_dot_product_attention(
        x, x, x), (2, 5, 8)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_nets_match_the_jax_package(name):
    """Each composite net's ProgramDesc, output and input gradient."""
    net, shape = NETS[name]

    def build(pkg):
        x = pkg.layers.data(name="x", shape=list(shape), append_batch_size=False,
                            stop_gradient=False)
        out = net(pkg, x)
        (gx,) = pkg.calc_gradient(pkg.layers.reduce_sum(pkg.layers.square(out)), [x])
        return [out, gx]
    feed = {"x": np.random.RandomState(5).randn(*shape).astype(np.float32)}
    jout, tout, _, _, _ = _carried_run(build, feed, 1)
    for a, b in zip(tout, jout):
        assert nrel(a, b) <= 1e-5


def test_sequence_conv_pool_names_the_roadmap_item():
    """``nets.sequence_conv_pool`` is ported now (ROADMAP.md queue A item 9's
    sequence half): ``sequence_conv`` with its bias and activation, then
    ``sequence_pool``, the program the JAX package builds."""
    def build(pkg):
        x = pkg.layers.data(name="x", shape=[1], dtype="int64", lod_level=1)
        emb = pkg.layers.embedding(input=x, size=[50, 8])
        return pkg.nets.sequence_conv_pool(emb, 4, 3, act="tanh", pool_type="sqrt")
    (jm, _, _), (tm, _, _) = build_both(build)
    assert [o.type for o in tm.desc.block(0).ops] == [
        "lookup_table", "sequence_conv", "elementwise_add", "tanh", "sequence_pool"]


@pytest.mark.parametrize("name,make,n", [
    ("mnist_train", lambda m: m.mnist.train(), 8192),
    ("mnist_test", lambda m: m.mnist.test(), 1024),
    ("cifar10_train", lambda m: m.cifar.train10(), 4096),
    ("cifar10_test", lambda m: m.cifar.test10(), 512),
    ("cifar100_train", lambda m: m.cifar.train100(), 4096),
    ("cifar100_test", lambda m: m.cifar.test100(), 512),
])
def test_synthetic_datasets_give_the_jax_packages_arrays(name, make, n):
    """Each port reader yields, from the same seed, the JAX package's
    synthetic arrays (compared with its generator: its reader would try
    the network first)."""
    samples = list(make(pt.dataset)())
    module, split = name.split("_")
    if module == "mnist":
        images, labels = fluid.dataset.mnist._synthetic(n, {"train": 0, "test": 1}[split])
    else:
        classes = 10 if module == "cifar10" else 100
        seed = {("cifar10", "train"): 0, ("cifar10", "test"): 1, ("cifar100", "train"): 2,
                ("cifar100", "test"): 3}[module, split]
        images, labels = fluid.dataset.cifar._synthetic(n, classes, seed)
    assert len(samples) == n
    np.testing.assert_array_equal(np.stack([s[0] for s in samples]), images)
    assert [s[1] for s in samples] == [int(v) for v in labels]
