"""The port's flag registry (``paddle_tpu_torch/flags.py``) against the JAX
package's, and the two flags ``Executor.run`` reads: ``check_nan_inf``
(a run whose outputs or written state hold NaN/Inf replays the block op by
op from a snapshot taken before it and raises naming the first bad op) and
``benchmark`` (a synchronized run logs its wall time and the live bytes).
Also the operator sugar on ``Variable`` (``layers/math_op_patch.py``),
which programs such as ``loss + 1e-9 * layers.mean(x)`` need."""
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import flags as jax_flags
from paddle_tpu_torch import flags
from paddle_tpu_torch.flags import FLAGS, init_gflags

from _torch_fresh import _fresh_port_programs  # noqa: F401
from _torch_validate import _no_port_validate_findings  # noqa: F401


@pytest.fixture(autouse=True)
def _reset_flags():
    saved = {n: FLAGS._values[n] for n in FLAGS.names()}
    warned = set(FLAGS._warned)
    yield
    FLAGS._values.update(saved)
    FLAGS._warned.clear()
    FLAGS._warned.update(warned)


def test_flag_sets_equal_in_names_kinds_and_defaults():
    jf = jax_flags.FLAGS
    assert FLAGS.names() == jf.names()
    for name in FLAGS.names():
        mine, ref = flags.get_flag_info(name), jax_flags.get_flag_info(name)
        assert (mine["kind"], mine["default"]) == (ref["kind"], ref["default"]), name
        # no flag obviated in the JAX package is live here
        assert bool(mine["obviated"]) == bool(ref["obviated"]), name
    assert flags._ENV_FLAGS == jax_flags._ENV_FLAGS


def test_obviated_reasons_speak_of_the_card_not_of_xla():
    for name in FLAGS.names():
        reason = flags.get_flag_info(name)["obviated"] or ""
        assert "XLA" not in reason and "jax" not in reason, (name, reason)
    assert "torch.backends.cudnn.deterministic" in \
        flags.get_flag_info("cudnn_deterministic")["obviated"]


def test_defaults_and_set():
    assert FLAGS.check_nan_inf is False
    assert FLAGS.rpc_deadline == 30.0
    FLAGS.check_nan_inf = True
    assert FLAGS.check_nan_inf is True


def test_init_gflags_parsing_as_the_jax_package():
    args = ["--check_nan_inf=true", "--rpc_deadline", "7.5", "--paddle_num_threads=4",
            "--benchmark", "--rpc_retry_times", "5"]
    saved = {n: jax_flags.FLAGS._values[n] for n in jax_flags.FLAGS.names()}
    try:
        init_gflags(args)
        jax_flags.init_gflags(args)
        assert {n: FLAGS._values[n] for n in FLAGS.names()} == \
            {n: jax_flags.FLAGS._values[n] for n in FLAGS.names()}
    finally:
        jax_flags.FLAGS._values.update(saved)
    assert FLAGS.check_nan_inf is True and FLAGS.benchmark is True
    assert FLAGS.rpc_deadline == 7.5 and FLAGS.paddle_num_threads == 4


def test_bool_coercion_strings():
    for s, want in [("1", True), ("ON", True), ("no", False), ("0", False)]:
        FLAGS.set("benchmark", s)
        assert FLAGS.benchmark is want
    with pytest.raises(ValueError):
        FLAGS.set("benchmark", "maybe")


def test_unknown_flag_raises():
    with pytest.raises(AttributeError):
        FLAGS.set("no_such_flag", 1)
    with pytest.raises(ValueError):
        init_gflags(["not-a-flag"])
    with pytest.raises(ValueError, match="missing a value"):
        init_gflags(["--rpc_deadline"])


def test_obviated_flag_warns_on_nondefault_read():
    FLAGS._warned.discard("fraction_of_gpu_memory_to_use")
    FLAGS.set("fraction_of_gpu_memory_to_use", 0.5)
    with pytest.warns(UserWarning, match="no effect"):
        _ = FLAGS.fraction_of_gpu_memory_to_use


def test_flags_v_drives_the_ports_log():
    from paddle_tpu_torch import log
    before = log.get_verbosity()
    try:
        FLAGS.v = 3
        assert log.get_verbosity() == 3
    finally:
        log.set_verbosity(before)


def test_environment_flags_read_at_import():
    code = ("import paddle_tpu_torch.flags as f; from paddle_tpu_torch import log; "
            "print(f.FLAGS.check_nan_inf, f.FLAGS.paddle_num_threads, log.get_verbosity())")
    env = {**os.environ, "FLAGS_check_nan_inf": "1", "FLAGS_paddle_num_threads": "3",
           "FLAGS_v": "2"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                             __file__))))
    assert out.stdout.split() == ["True", "3", "2"], out.stderr


def test_xmap_readers_sizes_its_pool_from_paddle_num_threads(monkeypatch):
    import threading
    from paddle_tpu_torch.reader import decorator
    FLAGS.paddle_num_threads = 3
    started = []
    real = threading.Thread.start

    def start(self):
        started.append(self.name)
        real(self)
    monkeypatch.setattr(threading.Thread, "start", start)
    out = sorted(decorator.xmap_readers(lambda x: x * 2, lambda: iter(range(10)))())
    assert out == [2 * i for i in range(10)]
    # the feeder thread, then one worker a pool slot
    assert len(started) == 1 + 3


# --------------------------------------------------------- check_nan_inf

def _div_by_zero(pkg):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    z = pkg.layers.fill_constant(shape=[4], dtype="float32", value=0.0)
    return pkg.layers.mean(pkg.layers.elementwise_div(x, z))


def test_check_nan_inf_names_elementwise_div_as_the_jax_package():
    out = _div_by_zero(pt)
    FLAGS.check_nan_inf = True
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(RuntimeError, match="elementwise_div") as mine:
        exe.run(pt.default_main_program(), feed={"x": np.zeros((2, 4), np.float32)},
                fetch_list=[out])
    jout = _div_by_zero(fluid)
    jax_flags.FLAGS.check_nan_inf = True
    try:
        with pytest.raises(RuntimeError) as ref:
            fluid.Executor().run(fluid.default_main_program(),
                                 feed={"x": np.zeros((2, 4), np.float32)}, fetch_list=[jout])
    finally:
        jax_flags.FLAGS.check_nan_inf = False
    assert str(mine.value) == str(ref.value)


def test_check_nan_inf_replays_from_the_state_before_the_run():
    """An SGD step whose feed poisons the update: the state after the run
    is non-finite, and the replay starts from the snapshot (the op it names
    reads the feed, not the poisoned parameter)."""
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    y = pt.layers.data(name="y", shape=[1], dtype="float32")
    pred = pt.layers.fc(input=x, size=1)
    loss = pt.layers.mean(pt.layers.square_error_cost(input=pred, label=y))
    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_startup_program(), scope=scope)
    xs = np.ones((2, 4), np.float32)
    xs[0, 0] = np.inf
    FLAGS.check_nan_inf = True
    with pytest.raises(RuntimeError, match=r"Operator mul output"):
        exe.run(pt.default_main_program(), feed={"x": xs, "y": np.ones((2, 1), np.float32)},
                fetch_list=[loss], scope=scope)


def test_check_nan_inf_clean_run_passes():
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    out = pt.layers.mean(pt.layers.relu(x))
    FLAGS.check_nan_inf = True
    exe = pt.Executor(pt.CPUPlace())
    (v,) = exe.run(pt.default_main_program(), feed={"x": np.ones((2, 4), np.float32)},
                   fetch_list=[out])
    assert np.isfinite(v).all()


def test_benchmark_flag_logs(capfd):
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    out = pt.layers.mean(x)
    FLAGS.benchmark = True
    exe = pt.Executor(pt.CPUPlace())
    exe.run(pt.default_main_program(), feed={"x": np.ones((2, 4), np.float32)},
            fetch_list=[out])
    err = capfd.readouterr().err
    assert "benchmark: run" in err and "live device buffers" in err
    FLAGS.benchmark = False
    exe.run(pt.default_main_program(), feed={"x": np.ones((2, 4), np.float32)},
            fetch_list=[out])
    assert "benchmark: run" not in capfd.readouterr().err


# ------------------------------------------------- Variable operator sugar

def _sugar(pkg):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    y = pkg.layers.data(name="y", shape=[4], dtype="float32")
    a = 1e-3 * pkg.layers.log(x) + 2.0
    b = (x - 1.0) * y / 4.0 - y
    c = 3.0 - (-x) ** y + 1.0 / y
    d = pkg.layers.cast(x < y, "float32") + (x >= y).astype("float32")
    return [a, b, c, d]


def test_variable_operators_build_the_jax_packages_program():
    """``Variable`` arithmetic appends the ops the JAX package appends
    (a ``TypeError`` on the parent tree: the port had no sugar)."""
    outs = _sugar(pt)
    jouts = _sugar(fluid)
    mine = pt.default_main_program().desc.to_dict()
    ref = fluid.default_main_program().desc.to_dict()
    strip = lambda d: [(o["type"], o["inputs"], o["outputs"], {k: v for k, v in o["attrs"].items()
                                                            if k != "op_callstack"})
                       for o in d["blocks"][0]["ops"]]
    assert [o[0] for o in strip(mine)] == [o[0] for o in strip(ref)]
    rs = np.random.RandomState(0)
    feed = {"x": rs.rand(3, 4).astype(np.float32) + 0.5, "y": rs.rand(3, 4).astype(np.float32) + 0.5}
    got = pt.Executor(pt.CPUPlace()).run(pt.default_main_program(), feed=feed, fetch_list=outs)
    want = fluid.Executor().run(fluid.default_main_program(), feed=feed, fetch_list=jouts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)
