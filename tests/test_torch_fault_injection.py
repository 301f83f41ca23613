"""The port's fault injection (``paddle_tpu_torch/faults.py``) against the
JAX package's: for a set of specs and seeds both fire identically over 200
hits (the fired log and the counters), the grammar and the catalogue are
the same, and ``ServingSession(fault_site=)`` fails exactly the planned
batch on the CPU."""
import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu import faults as jax_faults
from paddle_tpu_torch import faults

from _torch_fresh import _fresh_port_programs  # noqa: F401
from _torch_validate import _no_port_validate_findings  # noqa: F401

SITES = ("dispatch.renew", "dispatch.read", "serving.runner", "serving.backend.m")
SPECS = [
    "drop@dispatch.renew:p=0.5",
    "drop@dispatch.renew:p=0.3;drop@dispatch.renew:p=0.6;drop@dispatch.read:n=7",
    "drop@serving.runner:p=0.25;delay@serving.runner:s=0,p=0.1",
    "drop@serving.backend.m:n=2;drop@dispatch.read:p=0.9",
    "stall@dispatch.read:s=0,p=0.5",
]


@pytest.fixture(autouse=True)
def _no_plans():
    yield
    faults.reset()
    jax_faults.reset()


def _drive(mod, spec, seed, hits=200):
    mod.install(spec, seed=seed)
    dropped = []
    for i in range(hits):
        site = SITES[i % len(SITES)]
        dropped.append((site, mod.fire(site)))
    return dropped, mod.fired_log(), mod.counters()


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("spec", SPECS)
def test_both_packages_fire_identically(spec, seed):
    mine = _drive(faults, spec, seed)
    ref = _drive(jax_faults, spec, seed)
    assert mine == ref
    assert mine[1], "the plan fired nothing: the comparison would be empty"


def test_fail_raises_at_the_planned_hit_in_both():
    for mod in (faults, jax_faults):
        mod.install("fail@serving.backend:n=3", seed=0)
        mod.fire("serving.backend")
        mod.fire("serving.backend")
        with pytest.raises(mod.FaultInjected) as e:
            mod.fire("serving.backend")
        assert e.value.site == "serving.backend"
        assert mod.counters() == {"serving.backend": {"hits": 3, "fires": 1}}


def test_spec_grammar_errors_and_catalogue_match():
    for bad in ("explode@x", "kill", "drop@x:q=1", "drop@:n=1"):
        with pytest.raises(ValueError):
            faults.install(bad)
        with pytest.raises(ValueError):
            jax_faults.install(bad)
    for name in jax_faults.sites():
        if name.startswith(("dispatch.", "serving.runner")):
            assert faults.sites()[name] == jax_faults.sites()[name]
    with pytest.raises(ValueError):
        faults.register_site("a;b")
    assert not faults.active() and faults.fire("dispatch.renew") is False


def test_the_inert_path_reads_the_environment_once(tmp_path):
    import os
    import subprocess
    import sys
    code = ("from paddle_tpu_torch import faults; "
            "print([faults.fire('serving.runner') for _ in range(4)], faults.fired_log())")
    env = {**os.environ, "PADDLE_TPU_FAULTS": "drop@serving.runner:n=3",
           "PADDLE_TPU_FAULTS_SEED": "7"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == \
        "[False, False, True, False] [('serving.runner', 'drop', 3)]", out.stderr


def _infer_func():
    x = pt.layers.data(name="x", shape=[4], dtype="float32")
    return pt.layers.fc(input=x, size=3)


def test_serving_session_fault_site_fails_exactly_the_planned_batch():
    """``fail@serving.backend.m:n=2``: the second dispatched batch raises
    (its request gets the error), the first and third are served."""
    sess = pt.ServingSession(infer_func=_infer_func, place=pt.CPUPlace(), max_batch_size=4,
                             max_wait_ms=0.0, fault_site="serving.backend.m")
    try:
        faults.install("fail@serving.backend.m:n=2", seed=0)
        rs = np.random.RandomState(0)
        xs = [rs.rand(1, 4).astype(np.float32) for _ in range(3)]
        (first,) = sess.infer({"x": xs[0]})
        with pytest.raises(faults.FaultInjected, match="serving.backend.m"):
            sess.infer({"x": xs[1]})
        (third,) = sess.infer({"x": xs[2]})
        assert first.shape == third.shape == (1, 3)
        assert faults.fired_log() == [("serving.backend.m", "fail", 2)]
        assert faults.counters() == {"serving.backend.m": {"hits": 3, "fires": 1}}
        # the generic site is hit by every batch too
        faults.install("drop@serving.backend:p=1.0", seed=0)
        sess.infer({"x": xs[0]})
        assert faults.counters()["serving.backend"]["hits"] == 1
    finally:
        faults.reset()
        sess.close()


def test_serving_session_without_a_fault_site_fires_nothing():
    sess = pt.ServingSession(infer_func=_infer_func, place=pt.CPUPlace(), max_batch_size=2,
                             max_wait_ms=0.0)
    try:
        faults.install("fail@serving.backend:n=1", seed=0)
        (out,) = sess.infer({"x": np.ones((1, 4), np.float32)})
        assert out.shape == (1, 3) and faults.fired_log() == []
    finally:
        faults.reset()
        sess.close()
