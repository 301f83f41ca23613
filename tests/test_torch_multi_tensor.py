"""The multi-tensor optimizer updates (K5, K6) and the lowering-time
schedule that feeds them, on the CPU.

* The launch planner and the kernels' walk over it: a PyTorch-free
  emulation of ``csrc/fused_adam.cu``'s and ``csrc/fused_sgd.cu``'s chunk
  loop (their constants read from the sources) writes every element of
  every tensor exactly once, and each tensor's beta powers once.
* The plain group versions against each op's own lowering, and against
  the JAX package's kernels and lowerings.
* ``lower_block``'s schedule against a test-local op-by-op loop of
  ``lower_op``: two steps of a 2+2-layer transformer (Adam in float32,
  Adam under ``enable_amp``, SGD), every scope variable bit-equal, and
  synthetic blocks whose ops stop a group, with the group calls the rule
  gives.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu_torch as pt
from paddle_tpu.core.desc import OpDesc as JaxOpDesc
from paddle_tpu.core.lower import LowerCtx as JaxLowerCtx
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.ops.pallas.fused_optimizer import fused_adam as jax_fused_adam
from paddle_tpu.ops.pallas.fused_optimizer import fused_sgd as jax_fused_sgd
from paddle_tpu_torch.core import executor as executor_module
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.lower import LowerCtx, lower_block, lower_op
from paddle_tpu_torch.core.registry import OPS
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops import optimizer_ops
from paddle_tpu_torch.ops.cuda import fused_optimizer as fo

from _torch_validate import _no_port_validate_findings  # noqa: F401

CSRC = Path(fo.__file__).resolve().parents[2] / "csrc"
ADAM_SRC = (CSRC / "fused_adam.cu").read_text()
SGD_SRC = (CSRC / "fused_sgd.cu").read_text()
# the port's CPU bodies against the JAX package's, each output's largest
# difference over its largest value: the jitted reference contracts b1 * m +
# (1 - b1) * g into a fused multiply-add (tests/test_torch_faults.py)
ADAM_VS_JAX_RTOL = 2e-7

_ADAM_IN = ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
_ADAM_OUT = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut")
_SUFFIX = ("", "@GRAD", "_moment1", "_moment2", "_beta1_pow", "_beta2_pow")


def _const(src, name):
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


# ------------------------------------------------ the planner and the walk


def test_capacities_are_the_kernels():
    assert fo.ADAM_CAPACITY == _const(ADAM_SRC, "kMaxTensors")
    assert fo.SGD_CAPACITY == _const(SGD_SRC, "kMaxTensors")
    # the planner's chunk is the one the kernels walk
    assert fo.CHUNK == _const(ADAM_SRC, "kChunk") == _const(SGD_SRC, "kChunk")
    assert fo.CHUNK % 4 == 0 and _const(ADAM_SRC, "kBlocksPerSm") >= 1
    assert re.search(r"kFused = 1, kVec4 = 2;", ADAM_SRC) and (fo.FUSED, fo.VEC4) == (1, 2)
    assert re.search(r"kVec4 = 2;", SGD_SRC)


def test_plan_launches_splits_in_order_and_counts_chunks():
    assert fo.plan_launches([0, 1, 8, 9, 17], capacity=2, chunk=8) == \
        [(0, [0, 1, 2]), (2, [0, 1, 3]), (4, [0, 3])]
    assert fo.plan_launches([], capacity=4) == []
    with pytest.raises(ValueError, match="multiple of 4"):
        fo.plan_launches([5], capacity=4, chunk=6)


def _walk(counts, flags, capacity, chunk, src, blocks):
    """The kernels' loops over ``plan_launches`` (``src``'s kThreads and
    kUnroll): how often each element of each tensor is written, and how
    often each tensor's chunk 0 is taken by thread 0 (which writes the beta
    powers).  ``blocks`` is the grid before it is cut to the launch's
    chunks, as the host function cuts it."""
    threads, unroll = _const(src, "kThreads"), _const(src, "kUnroll")
    cover = [np.zeros(n, np.int64) for n in counts]
    vec = [np.zeros(n, bool) for n in counts]
    first_chunks = np.zeros(len(counts), np.int64)
    for first, starts in fo.plan_launches(counts, capacity, chunk):
        n_tensors, n_chunks = len(starts) - 1, starts[-1]
        grid = max(1, min(blocks, n_chunks))
        for block in range(grid):
            for c in range(block, n_chunks, grid):
                lo, hi = 0, n_tensors - 1
                while lo < hi:
                    mid = (lo + hi + 1) // 2
                    if starts[mid] <= c:
                        lo = mid
                    else:
                        hi = mid - 1
                t = first + lo
                local = c - starts[lo]
                first_chunks[t] += local == 0
                begin = local * chunk
                length = min(counts[t], begin + chunk) - begin
                n4 = length // 4 if flags[t] & fo.VEC4 else 0
                for tid in range(min(threads, max(length, 0))):
                    i = np.arange(tid, n4, unroll * threads)
                    for u in range(unroll):
                        q = i + u * threads
                        q = q[q < n4]
                        idx = (begin + 4 * q[:, None] + np.arange(4)).ravel()
                        np.add.at(cover[t], idx, 1)
                        vec[t][idx] = True
                    np.add.at(cover[t], begin + np.arange(4 * n4 + tid, length, threads), 1)
    return cover, vec, first_chunks


def _adam_entries(counts, offset=()):
    """CPU entries of ``counts`` elements, the ones in ``offset`` views one
    float into a buffer (so not 16-byte aligned)."""
    entries = []
    for k, n in enumerate(counts):
        big = [torch.zeros(n + 1)[1:] if k in offset else torch.zeros(n) for _ in range(4)]
        entries.append((*big, torch.ones(()), torch.ones(()), torch.ones(1), k % 2 == 0))
    return entries


CASES = [[1, 3, 4, 5, 2048, 4095, 4097], [4097, 5, 4095, 1, 2048, 4, 3]]
CPU = torch.device("cpu")


@pytest.mark.parametrize("chunk", [16, 1024, fo.CHUNK])
@pytest.mark.parametrize("counts", CASES)
def test_walk_writes_every_element_once(counts, chunk):
    n = len(counts)
    entries = _adam_entries(counts, offset=(3,))
    pows, pow_addrs = fo._scalars(CPU, [e[4] for e in entries] + [e[5] for e in entries])
    assert pow_addrs == [t.data_ptr() for t in pows]
    rows, flags = fo.adam_table(entries, pow_addrs[:n], pow_addrs[n:], -1)   # -1: the CPU
    assert len(rows) == 12 * n
    for k, e in enumerate(entries):
        assert rows[12 * k:12 * k + 7] == [t.data_ptr() for t in e[:7]]
        # in place: p', m1', m2' are p, m1, m2; the powers go to fresh scalars
        outs = [e[0], e[2], e[3], pows[k], pows[n + k]]
        assert rows[12 * k + 7:12 * k + 12] == [t.data_ptr() for t in outs]
        assert all(t.shape == () for t in outs[3:])
    assert len({t.data_ptr() for t in pows}) == 2 * n
    # the offset view goes element by element; every other entry is aligned
    assert [f & fo.VEC4 for f in flags] == [0 if k == 3 else fo.VEC4 for k in range(n)]
    assert [f & fo.FUSED for f in flags] == [fo.FUSED * (k % 2 == 0) for k in range(n)]
    cover, vec, first_chunks = _walk(counts, flags, fo.ADAM_CAPACITY, chunk, ADAM_SRC, blocks=3)
    for k, (c, v) in enumerate(zip(cover, vec)):
        assert (c == 1).all(), (k, counts[k])
        # float4s up to the last multiple of 4 (a chunk is one), then the tail
        n4 = 0 if k == 3 else counts[k] // 4 * 4
        assert v[:n4].all() and not v[n4:].any(), k
    assert (first_chunks == 1).all()


def test_walk_over_more_tensors_than_one_launch_holds():
    rs = np.random.RandomState(0)
    counts = [int(n) for n in rs.randint(0, 40, fo.SGD_CAPACITY + 37)]
    counts[5] = 0
    p = [torch.zeros(n) for n in counts]
    entries = [(t, t, torch.ones(1)) for t in p]
    rows, flags = fo.sgd_table(entries, -1)
    # in place: each p' is p
    assert len(rows) == 4 * len(counts) and rows[3::4] == rows[0::4]
    launches = fo.plan_launches(counts, fo.SGD_CAPACITY, 8)
    assert [first for first, _ in launches] == [0, fo.SGD_CAPACITY]
    cover, _, first_chunks = _walk(counts, flags, fo.SGD_CAPACITY, 8, SGD_SRC, blocks=7)
    assert all((c == 1).all() for c in cover) and (first_chunks == 1).all()


# ----------------------------------------------------- plain group versions


def _env(names, rs, n=4096, shapes=None):
    env = {"lr": torch.tensor([3e-2]), "lr2": torch.tensor([0.37])}
    for k, name in enumerate(names):
        shape = (shapes or {}).get(name, (n,))
        env[name] = torch.from_numpy(rs.randn(*shape).astype(np.float32))
        env[name + "@GRAD"] = torch.from_numpy((0.1 * rs.randn(*shape)).astype(np.float32))
        env[name + "_moment1"] = torch.from_numpy((1e-2 * rs.randn(*shape)).astype(np.float32))
        env[name + "_moment2"] = torch.from_numpy((1e-3 * rs.rand(*shape)).astype(np.float32))
        env[name + "_beta1_pow"] = torch.tensor(0.9 ** (k + 1), dtype=torch.float32)
        env[name + "_beta2_pow"] = torch.tensor(0.999 ** (k + 1), dtype=torch.float32)
    return env


def _adam_op(name, op_type="adam", grad=None, lr="lr", **attrs):
    ins = {s: [name + x] for s, x in zip(_ADAM_IN, _SUFFIX)}
    ins["Grad"], ins["LearningRate"] = [grad or name + "@GRAD"], [lr]
    outs = {s: [name + x] for s, x in zip(_ADAM_OUT, ("",) + _SUFFIX[2:])}
    return OpDesc(type=op_type, inputs=ins, outputs=outs,
                  attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, **attrs})


def _sgd_op(name, op_type="sgd", lr="lr2"):
    return OpDesc(type=op_type, inputs={"Param": [name], "Grad": [name + "@GRAD"],
                                        "LearningRate": [lr]}, outputs={"ParamOut": [name]})


def _scale_op(x, out, scale=0.5):
    return OpDesc(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                  attrs={"scale": scale, "bias": 0.0, "bias_after_scale": True})


def _ctx(env):
    """A context over clones of ``env``'s tensors: the updates write their
    inputs in place."""
    return LowerCtx(None, {k: v.clone() for k, v in env.items()}, torch.Generator(),
                    torch.device("cpu"))


def _assert_envs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_adam_group_is_each_ops_own_lowering_bit_for_bit():
    rs = np.random.RandomState(1)
    names = ["w0", "w1", "w2", "w3", "w4"]
    shapes = {"w1": (5,), "w2": (3, 7), "w4": (64, 65)}
    env = _env(names, rs, shapes=shapes)
    ops = [_adam_op(n, "pallas_adam" if k % 2 else "adam") for k, n in enumerate(names)]
    group, single = _ctx(env), _ctx(env)
    OPS.get("adam").group_lower(group, ops)
    for op in ops:
        lower_op(single, op)
    _assert_envs_equal(group.env, single.env)
    # each entry computes its op type's expression: adam's composed
    # ((1 - b2) * g) * g, pallas_adam's fused_adam_plain
    args = [[env[n + x] for x in _SUFFIX] + [env["lr"]] for n in names]
    # the plain group version updates p, m1 and m2 in place: on clones
    plain = fo.fused_adam_multi_plain([(*(t.clone() for t in a), k % 2 == 1)
                                       for k, a in enumerate(args)], 0.9, 0.999, 1e-8)
    differ = 0
    for k, n in enumerate(names):
        want = (fo.fused_adam_plain if k % 2 else fo.adam_plain)(*args[k], 0.9, 0.999, 1e-8)
        other = (fo.adam_plain if k % 2 else fo.fused_adam_plain)(*args[k], 0.9, 0.999, 1e-8)
        assert all(torch.equal(a, b) for a, b in zip(plain[k], want))
        for slot, w in zip(_ADAM_OUT, want):
            assert torch.equal(group.env[ops[k].output(slot)[0]], w), (n, slot)
        m2 = env[n + "@GRAD"]
        if k % 2 == 0:
            assert torch.equal(want[2], 0.999 * env[n + "_moment2"] + (1 - 0.999) * m2 * m2)
        differ += not torch.equal(want[2], other[2])
    assert differ >= 3          # the inputs tell the two expressions apart


def test_sgd_group_is_each_ops_own_lowering_bit_for_bit():
    rs = np.random.RandomState(2)
    names = ["v0", "v1", "v2", "v3"]
    env = _env(names, rs, shapes={"v1": (5,), "v3": (33, 7)})
    ops = [_sgd_op(n, "pallas_sgd" if k % 2 else "sgd") for k, n in enumerate(names)]
    group, single = _ctx(env), _ctx(env)
    OPS.get("sgd").group_lower(group, ops)
    for op in ops:
        lower_op(single, op)
    _assert_envs_equal(group.env, single.env)
    plain = fo.fused_sgd_multi_plain([(env[n].clone(), env[n + "@GRAD"], env["lr2"])
                                      for n in names])
    for n, want in zip(names, plain):
        assert torch.equal(group.env[n], want)
        assert torch.equal(want, fo.fused_sgd_plain(env[n], env[n + "@GRAD"], env["lr2"]))


def test_multi_entries_against_the_jax_package():
    """fused_adam_multi's entries against the JAX package (pallas_adam:
    ``fused_adam``'s Pallas kernel in interpret mode; adam: the jitted
    ``adam`` lowering) within ADAM_VS_JAX_RTOL; fused_sgd_multi bit-equal
    to ``fused_sgd``'s Pallas kernel in interpret mode."""
    import jax
    rs = np.random.RandomState(3)
    names = ["a0", "a1", "a2"]
    env = _env(names, rs, shapes={"a0": (64, 130), "a1": (1001,), "a2": (7,)})
    entries, arrays = [], []
    for k, n in enumerate(names):
        args = [env[n + x].clone() for x in _SUFFIX] + [env["lr"]]
        entries.append((*args, k != 1))
        arrays.append([a.numpy().copy() for a in args])
    got = fo.fused_adam_multi(entries, 0.9, 0.999, 1e-8)
    for k, (outs, arr) in enumerate(zip(got, arrays)):
        if k != 1:
            ref = jax_fused_adam(*(jnp.asarray(a) for a in arr), 0.9, 0.999, 1e-8,
                                 interpret=True)
        else:
            op = JaxOpDesc(type="adam", inputs={s: [s] for s in _ADAM_IN},
                           outputs={s: [s] for s in _ADAM_OUT},
                           attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})

            def run(*vals):
                ctx = JaxLowerCtx(None, dict(zip(_ADAM_IN, vals)), None)
                JAX_OPS.get("adam").lower(ctx, op)
                return [ctx.env[s] for s in _ADAM_OUT]
            ref = jax.jit(run)(*(jnp.asarray(a) for a in arr))
        for a, b in zip(outs, ref):
            b = np.asarray(b)
            assert a.shape == b.shape
            err = np.abs(a.numpy().astype(np.float64) - b).max() / max(np.abs(b).max(), 1e-30)
            assert err <= ADAM_VS_JAX_RTOL
    sgd = [(env[n].clone(), env[n + "@GRAD"], env["lr2"]) for n in names]
    refs = [jax_fused_sgd(jnp.asarray(p.numpy()), jnp.asarray(g.numpy()),
                          jnp.asarray(lr.numpy()), interpret=True) for p, g, lr in sgd]
    for (p, _, _), out, ref in zip(sgd, fo.fused_sgd_multi(sgd), refs):
        assert out is p
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_empty_group_and_mixed_devices():
    assert fo.fused_adam_multi([], 0.9, 0.999, 1e-8) == [] and fo.fused_sgd_multi([]) == []
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="shapes differ"):
        fo.fused_adam_multi([(x, torch.zeros(4), x, x, x[:1], x[:1], x[:1], True)],
                            0.9, 0.999, 1e-8)
    with pytest.raises(ValueError, match="lr must have one element"):
        fo.fused_sgd_multi([(x, x, x)])


# -------------------------------------------------------------- the schedule


@pytest.fixture
def update_calls(monkeypatch):
    """Every multi-tensor call the update lowerings make: (family, the
    entries' parameter shapes' sizes) in order."""
    calls = []

    def wrap(fn, family):
        def counted(entries, *args, **kwargs):
            calls.append((family, len(entries)))
            return fn(entries, *args, **kwargs)
        return counted
    monkeypatch.setattr(optimizer_ops, "fused_adam_multi", wrap(fo.fused_adam_multi, "adam"))
    monkeypatch.setattr(optimizer_ops, "fused_sgd_multi", wrap(fo.fused_sgd_multi, "sgd"))
    return calls


def _op_by_op(ctx, block):
    for i, op in enumerate(block.ops):
        lower_op(ctx, op, index=i)


def _run_block(ops, env, scheduled):
    ctx = _ctx(env)
    block = types.SimpleNamespace(ops=ops, idx=0)
    (lower_block if scheduled else _op_by_op)(ctx, block)
    return ctx.env


SYNTHETIC = {
    # an op that reads a collected update's output ends the group
    "reads_output": ([_adam_op("a"), _scale_op("a", "y"), _adam_op("b")],
                     [("adam", 1), ("adam", 1)]),
    # ... as does one that writes a collected update's input or output
    "writes_input": ([_adam_op("a"), _scale_op("z", "a@GRAD"), _adam_op("b")],
                     [("adam", 1), ("adam", 1)]),
    "writes_output": ([_adam_op("a"), _scale_op("z", "a_moment2"), _adam_op("b")],
                      [("adam", 1), ("adam", 1)]),
    # an update that reads a collected update's output ends it too
    "update_reads_update": ([_adam_op("a"), _adam_op("b", grad="a"), _adam_op("c")],
                            [("adam", 1), ("adam", 2)]),
    # an op that writes a later update's input runs ahead of the group
    "writes_later_input": ([_adam_op("a"), _scale_op("z", "b@GRAD"), _adam_op("b")],
                           [("adam", 2)]),
    # a gradient cast's shape: reads and writes names no update touched yet
    "cast_like": ([_adam_op("a", "pallas_adam"), _scale_op("z", "w"), _adam_op("b"),
                   _scale_op("w", "b2@GRAD"), _adam_op("b2", "pallas_adam")], [("adam", 3)]),
    # another family, or other attributes, run ahead as a group of one
    "other_family": ([_adam_op("a"), _sgd_op("c"), _adam_op("b")],
                     [("sgd", 1), ("adam", 2)]),
    "other_attrs": ([_adam_op("a"), _adam_op("b", beta1=0.8), _adam_op("c")],
                    [("adam", 1), ("adam", 2)]),
    "shared_lr_written": ([_sgd_op("c"), _sgd_op("d"), _scale_op("lr", "lr2"), _sgd_op("e")],
                          [("sgd", 2), ("sgd", 1)]),
}


@pytest.mark.parametrize("case", sorted(SYNTHETIC))
def test_schedule_of_synthetic_blocks(case, update_calls):
    ops, want_calls = SYNTHETIC[case]
    env = _env(["a", "b", "b2", "c", "d", "e"], np.random.RandomState(4), n=37)
    env["z"] = torch.full((37,), 0.25)
    env["w"] = torch.full((37,), 2.0)
    got = _run_block(ops, env, scheduled=True)
    assert update_calls == want_calls
    update_calls.clear()
    want = _run_block(ops, env, scheduled=False)
    assert len(update_calls) == sum(n for _, n in want_calls)
    _assert_envs_equal(got, want)


T = 32


def _program(sgd):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = pt.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pt.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pt.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, 1000, 1000, max_len=T, n_layer=2,
                                            d_model=64, n_head=4, d_inner=256,
                                            fuse_final_ce=True)
        (pt.optimizer.SGD(0.1) if sgd else pt.optimizer.Adam(1e-3)).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("kind", ["adam", "adam_bf16", "sgd"])
def test_schedule_bit_equal_to_op_by_op_over_two_steps(kind, monkeypatch, update_calls):
    """Two steps of a 2+2-layer transformer with the kernel tier's op types
    (``adam`` and ``pallas_adam``, or ``sgd`` and ``pallas_sgd``): the
    schedule makes one update call a step, the op-by-op loop 66, and every
    scope variable comes out bit-equal."""
    main, startup, loss = _program(kind == "sgd")
    if kind == "adam_bf16":
        pt.amp.enable_amp(main)
    rs = np.random.RandomState(0)
    feed = {"src": rs.randint(1, 1000, (4, T, 1)), "trg": rs.randint(1, 1000, (4, T, 1)),
            "lbl": rs.randint(1, 1000, (4, T, 1)),
            "src@SEQ_LEN": np.array([32, 17, 5, 29], np.int32),
            "trg@SEQ_LEN": np.array([9, 32, 1, 20], np.int32)}
    exe = pt.Executor(pt.CPUPlace(), kernels=True)
    scope0 = pt.Scope()
    exe.run(startup, scope=scope0)
    family = "sgd" if kind == "sgd" else "adam"
    ops = exe._apply_passes(main, list(feed), [loss.name]).desc.block(0).ops
    updates = [k for k, o in enumerate(ops) if o.type in (family, "pallas_" + family)]
    n_params = len(main.global_block.all_parameters())
    assert len(updates) == n_params == 66
    assert {o.type for o in ops} >= {family, "pallas_" + family}
    between = [ops[k].type for k in range(updates[0], updates[-1]) if k not in updates]
    # the bf16 step's gradient casts sit between the updates (and are hoisted)
    assert (set(between) == {"cast"}) if kind == "adam_bf16" else not between

    losses, scopes = [], []
    for scheduled in (True, False):
        if not scheduled:
            monkeypatch.setattr(executor_module, "lower_block", _op_by_op)
        scope = pt.Scope()
        for n, v in scope0._vars.items():
            if not isinstance(v, torch.Tensor):         # the random generator
                v, state = torch.Generator(), v.get_state()
                v.set_state(state)
            scope.set_var(n, v.clone() if isinstance(v, torch.Tensor) else v)
        update_calls.clear()
        losses.append([float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
                       for _ in range(2)])
        assert update_calls == ([(family, n_params)] * 2 if scheduled
                                else [(family, 1)] * (2 * n_params))
        scopes.append(scope._vars)
    assert losses[0] == losses[1] and losses[0][1] < losses[0][0]
    sched, loop = scopes
    assert sched.keys() == loop.keys()
    for n, v in sched.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == loop[n].dtype and torch.equal(v, loop[n]), n
        else:                                   # the random generator
            assert torch.equal(v.get_state(), loop[n].get_state()), n
