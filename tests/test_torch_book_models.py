"""The book's image models against the JAX package, on the CPU.

* bench.py's AlexNet and GoogLeNet rows and SE-ResNeXt-50 (224 x 224,
  1,000 classes, ``Momentum(0.01, 0.9)``): equal ProgramDescs, and equal
  ``amp-bf16`` rewrites op for op (built, not run);
* each model at a small image size from the JAX startup's parameters, one
  Momentum step: the loss and accuracy, every parameter's gradient and
  every persistable's change over the step, each within the gate written
  beside it.  Dropout draws at random in both packages and never agrees bit
  for bit, so AlexNet and GoogLeNet are built with ``is_test=True`` (their
  dropout scales, and no op of theirs reads ``is_test`` else) and
  SE-ResNeXt with ``dropout_prob=0.0`` (its batch_norm still trains);
* SE-ResNeXt's structure (16 grouped 3x3s, 16 gates), its gate
  (``elementwise_mul(axis=0)`` of [N, C] over [N, C, H, W]) and its
  inference export served again;
* the JAX package's training smoke on the port: losses finite and falling
  over a few Momentum steps on one batch.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu.models.alexnet
import paddle_tpu.models.googlenet
import paddle_tpu.models.se_resnext
import paddle_tpu.passes  # noqa: F401
import paddle_tpu_torch as pt
from test_torch_cnn_ops import _f, assert_close, build_both, descs_equal, run_both, start_both
from test_torch_amp_bf16 import _assert_differs_only_at_stale_reads, _ops
from test_torch_cnn_models import nrel

from _torch_validate import _no_port_validate_findings  # noqa: F401

# One Momentum step at the small sizes, port against the JAX package
# (readings on the CPU, x86-64, printed by the assertions when they fail):
# the loss within LOSS_RTOL, each gradient within GRAD_NREL norm-relative,
# each persistable's change within CHANGE_NREL norm-relative (the ResNet-18
# gates of tests/test_torch_cnn_models.py)
LOSS_RTOL = 1e-5
GRAD_NREL = 1e-4
CHANGE_NREL = 5e-4
# SE-ResNeXt-50 at 64 x 64, two rows: fifty layers of batch_norm in training
# mode amplify rounding.  Both packages' float32 gradients read ~1e-2
# (8.4e-3 JAX, 9.8e-3 port, all gradients as one vector) from a float64 run
# of the same step (the port's, the witness) and up to 1.7e-2 from each
# other, a gradient at a time; the loss agrees to 5e-6.  So each gradient
# and change within SE_NREL of the JAX package's, and the port's distance
# from the witness at most WITNESS_FACTOR x the JAX package's + WITNESS_FLOOR
SE_NREL = 5e-2
WITNESS_FACTOR = 2.0
WITNESS_FLOOR = 1e-4
# the bench programs: (ops, ops after amp-bf16, its casts); the port's
# rewrite re-casts the merged gradients that the JAX pass reads stale
# (ROADMAP.md section C): RECASTS more casts than the JAX rewrite
BENCH_OPS = {"alexnet": (85, 120, 35), "googlenet": (546, 862, 316),
             "se_resnext": (874, 1473, 599)}
RECASTS = {"alexnet": 0, "googlenet": 18, "se_resnext": 16}


def _bench_step(pkg, name, hw=224, classes=1000):
    image = pkg.layers.data(name="image", shape=[3, hw, hw], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    loss, acc = getattr(pkg.models, name).train_network(image, label, class_dim=classes)
    pkg.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss, acc


@pytest.mark.parametrize("name", sorted(BENCH_OPS))
def test_bench_programs_match_the_jax_package_with_and_without_amp(name):
    """bench.py:1542-1575's AlexNet and GoogLeNet rows and SE-ResNeXt-50,
    built by both packages: equal ProgramDescs; the ``amp-bf16`` rewrite
    of AlexNet equal op for op, GoogLeNet's and SE-ResNeXt's equal but for
    the port's re-casts of merged gradients right before the JAX rewrite's
    stale reads (an inception block's input and a bottleneck's feed four
    and two readers whose gradients merge)."""
    (jm, _, (jl, _)), (tm, _, (tl, _)) = build_both(lambda pkg: _bench_step(pkg, name))
    # (SE-ResNeXt's rewrite leaves 64 dead-op infos, D204, which the JAX
    # pipeline's "error" mode refuses; both pipelines run unverified here)
    jp, _ = fluid.passes.PassPipeline(["amp-bf16"], verify="off").run(jm, fetch_list=[jl.name])
    tp, _ = pt.passes.PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=[tl.name])
    types = [o.type for o in tp.desc.block(0).ops]
    assert (len(tm.desc.block(0).ops), len(types), types.count("cast")) == BENCH_OPS[name]
    recasts = len(types) - len(jp.desc.block(0).ops)
    assert recasts == RECASTS[name]
    if recasts:
        _assert_differs_only_at_stale_reads(_ops(jp), _ops(tp))
    else:
        descs_equal(jp, tp)


def test_se_resnext50_structure():
    """16 bottlenecks (3 + 4 + 6 + 3): a cardinality-32 grouped 3x3 and an
    SE gate (a sigmoid, an axis-0 ``elementwise_mul``) in each."""
    (_, _, _), (tm, _, _) = build_both(lambda pkg: [pkg.models.se_resnext.se_resnext(
        pkg.layers.data(name="img", shape=[3, 64, 64], dtype="float32"), class_dim=10,
        is_test=True)])
    ops = tm.desc.block(0).ops
    assert sum(o.type == "conv2d" and o.attr("groups", 1) == 32 for o in ops) == 16
    gates = [o for o in ops if o.type == "elementwise_mul"]
    assert len(gates) == 16 and all(o.attr("axis") == 0 for o in gates)
    assert sum(o.type == "sigmoid" for o in ops) == 16


def test_the_se_gate_broadcasts_n_c_over_n_c_h_w():
    """``elementwise_mul(x, gate, axis=0)``: the port's ``bcast_y`` lays the
    [N, C] gate over [N, C, H, W] from axis 0; output and both gradients
    (the gate's summed over H and W) against the JAX lowering."""
    feed = {"x": _f(40, 3, 8, 5, 4), "gate": _f(41, 3, 8)}
    ref, got = run_both(lambda pkg, xs: [pkg.layers.elementwise_mul(xs[0], xs[1], axis=0)],
                        feed)
    assert got[2].shape == (3, 8)
    assert_close(got, ref, 1e-5)
    np.testing.assert_array_equal(got[0], feed["x"] * feed["gate"][:, :, None, None])


def _small_step(pkg, name, hw, classes):
    image = pkg.layers.data(name="image", shape=[3, hw, hw], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    if name == "se_resnext":
        pred = pkg.models.se_resnext.se_resnext(image, class_dim=classes, dropout_prob=0.0)
        loss = pkg.layers.mean(pkg.layers.cross_entropy(input=pred, label=label))
        acc = pkg.layers.accuracy(input=pred, label=label)
    else:
        loss, acc = getattr(pkg.models, name).train_network(image, label, class_dim=classes,
                                                            is_test=True)
    pkg.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    return loss, acc


# (image size, classes, rows): the smallest sizes each model's pools allow
SMALL = {"alexnet": (64, 5, 4), "googlenet": (64, 5, 2), "se_resnext": (64, 10, 2)}


@pytest.fixture(scope="module", params=sorted(SMALL))
def one_step(request):
    """Both packages' step of one model at its small size, from the JAX
    startup's parameters: the loss, accuracy and every gradient, and the
    persistables after the step."""
    from conftest_helpers import fresh_framework_state
    fresh_framework_state()
    name = request.param
    hw, classes, rows = SMALL[name]
    jax_side, port_side = build_both(lambda pkg: _small_step(pkg, name, hw, classes))
    jexe, jscope, texe, tscope, state = start_both(jax_side, port_side)
    jm = jax_side[0]
    loss, acc = (v.name for v in jax_side[2])
    params = [p.name for p in jm.global_block.all_parameters()
              if jm.desc.block(0).find_var(p.name + "@GRAD") is not None]
    fetch = [loss, acc] + [p + "@GRAD" for p in params]
    rs = np.random.RandomState(42)
    feed = {"image": rs.randn(rows, 3, hw, hw).astype(np.float32),
            "label": rs.randint(0, classes, (rows, 1)).astype(np.int64)}
    jout = [np.asarray(a) for a in jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)]
    tout = [np.asarray(a) for a in texe.run(port_side[0], feed=feed, fetch_list=fetch,
                                            scope=tscope)]
    witness = None
    if name == "se_resnext":
        # the same step in float64 on the port: float64 state, and the image
        # read from the scope (a feed would be narrowed to float32)
        wscope = pt.Scope()
        pt.params_from_numpy({n: a.astype(np.float64) if a.dtype == np.float32 else a
                              for n, a in state.items()}, wscope, "cpu")
        wscope.set_var("image", torch.from_numpy(feed["image"].astype(np.float64)))
        witness = [np.asarray(a) for a in pt.Executor(pt.CPUPlace()).run(
            port_side[0], feed={"label": feed["label"]}, fetch_list=fetch, scope=wscope)]
        assert witness[2].dtype == np.float64
    return {"name": name, "state": state, "params": params, "jout": jout, "tout": tout,
            "witness": witness,
            "jstate": {n: np.asarray(jscope.find_var(n)).copy() for n in state},
            "tstate": {n: tscope.find_var(n).numpy().copy() for n in state}}


def _flat(arrays):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays])


def test_one_step_loss_accuracy_and_gradients_match(one_step):
    r = one_step
    (jl, ja), (tl, ta) = r["jout"][:2], r["tout"][:2]
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl)), (tl, jl)
    assert float(ta) == float(ja)
    errs = {p: nrel(a, b) for p, a, b in zip(r["params"], r["tout"][2:], r["jout"][2:])}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= (SE_NREL if r["witness"] else GRAD_NREL), (worst, errs[worst])
    if r["witness"]:
        w = _flat(r["witness"][2:])
        port, ref = nrel(_flat(r["tout"][2:]), w), nrel(_flat(r["jout"][2:]), w)
        assert port <= WITNESS_FACTOR * ref + WITNESS_FLOOR, (port, ref)


def test_one_step_changes_every_persistable_as_the_jax_package(one_step):
    """Parameters, velocities and (SE-ResNeXt) the running statistics."""
    r = one_step
    worst, name, moved = 0.0, None, 0
    for n, before in r["state"].items():
        want = r["jstate"][n] - before
        if not np.any(want):
            continue
        moved += 1
        e = nrel(r["tstate"][n] - before, want)
        if e > worst:
            worst, name = e, n
    assert moved >= len(r["params"]), (moved, len(r["params"]))
    assert worst <= (SE_NREL if r["witness"] else CHANGE_NREL), (worst, name)


def test_se_resnext_export_and_serve(tmp_path):
    """The eval program exported with ``save_inference_model`` and loaded
    again serves what the live program computes, and that equals the JAX
    package's forward from the same parameters."""
    def build(pkg):
        img = pkg.layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        return [pkg.models.se_resnext.se_resnext(img, class_dim=10, is_test=True)]
    jax_side, port_side = build_both(build)
    jexe, jscope, texe, tscope, _ = start_both(jax_side, port_side)
    pred = port_side[2][0]
    xv = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    (want,) = jexe.run(jax_side[0], feed={"img": xv}, fetch_list=[pred.name], scope=jscope)
    (live,) = texe.run(port_side[0], feed={"img": xv}, fetch_list=[pred], scope=tscope)
    assert_close([np.asarray(live)], [np.asarray(want)], 1e-5)
    d = str(tmp_path / "se")
    with pt.scope_guard(tscope):
        pt.io.save_inference_model(d, ["img"], [pred], texe, port_side[0],
                                   export_compiled=False)
    exe2 = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        prog, feeds, fetch = pt.io.load_inference_model(d, exe2)
        (got,) = exe2.run(prog, feed={"img": xv}, fetch_list=fetch)
    assert feeds == ["img"]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(live))


@pytest.mark.parametrize("name", ["alexnet", "googlenet"])
def test_image_models_train_on_the_port(name):
    """The JAX package's training smoke (tests/test_image_models.py) on the
    port: Momentum on one fixed batch, losses finite and falling."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, _ = _bench_step(pt, name, hw=64, classes=5)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(0)
    feed = {"image": rng.random((8, 3, 64, 64), dtype=np.float32),
            "label": rng.integers(0, 5, (8, 1)).astype(np.int64)}
    losses = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]))
              for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
