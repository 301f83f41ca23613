"""The port's ``io`` and ``clone(for_test=True)`` on the CPU against the
JAX package, and ``Inferencer(param_path=)``.

A 2+2-layer transformer (vocab 1000, d_model 64, 4 heads, d_inner 256,
max_len 32), built by both packages under ``unique_name.guard()`` with the
JAX parameters carried across.  A directory saved by either package's
``save_persistables`` / ``save_inference_model`` loads in the other with
bit-equal values, and both packages' inferencers give equal logits (within
``LOGIT_ATOL``, tests/test_torch_serving.py's gate) from either
directory.  A load copies into the scope's tensors: each keeps its
``data_ptr()``.  bf16 values are stored as the JAX package stores them
(their uint16 view, ``"bfloat16"`` in ``__meta__``).  The for-test clone
of the Adam training program has the JAX clone's ops, and running it
changes no parameter.  Then bf16 serving (``Inferencer(amp=AmpConfig())``)
against the JAX package's bf16 Inferencer.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu import io as jax_io
from paddle_tpu.amp import AmpConfig as JaxAmpConfig
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu_torch import io as pt_io
from paddle_tpu_torch.amp import AmpConfig
from paddle_tpu_torch.models import transformer as pt_transformer

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER = 1000, 64, 4, 256, 32, 2
LOGIT_ATOL = 1e-4     # tests/test_torch_serving.py: float32 through 4 layers
# bf16 serving, port against the JAX package, ||a - b|| / ||b|| over the
# logits of a batch.  Each side rounds activations to bf16 on its own: on
# this model each lies 0.006-0.0074 from float32 and the two 0.0074-0.0084
# apart (ROADMAP §C's probe; read here 0.0076-0.0077).  The gate, 1.5x the
# probe's largest, cannot tell bf16 from float32 serving (the port's float32
# logits lie 0.006 from the JAX bf16 ones), so the port's bf16 logits must
# also lie at least BF16_VS_FP32_MIN from its own float32 logits (the
# probe: 0.0071-0.0074): the bf16 path ran.
BF16_NREL = 0.0125
BF16_VS_FP32_MIN = 0.003


def _infer_func(pkg, mod):
    def infer_func():
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        return mod.transformer(src, trg, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                               d_model=D_MODEL, n_head=N_HEAD, d_inner=D_INNER, is_test=True)
    return infer_func


def _feed(seed, rows=3):
    rs = np.random.RandomState(seed)
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


def _persist(program):
    return [v.name for v in program.list_vars() if v.persistable]


@pytest.fixture(scope="module")
def inferencers():
    """(JAX Inferencer, port Inferencer on the CPU with the JAX weights)."""
    jax_inf = fluid.Inferencer(infer_func=_infer_func(fluid, jax_transformer))
    pt_inf = pt.Inferencer(_infer_func(pt, pt_transformer), place=pt.CPUPlace())
    for n in _persist(jax_inf.inference_program):
        pt_inf.scope.find_var(n).copy_(torch.from_numpy(np.array(jax_inf.scope.find_var(n))))
    return jax_inf, pt_inf


def _jax_values(scope, names):
    return {n: np.asarray(scope.find_var(n)) for n in names}


def _pt_values(scope, names):
    return {n: scope.find_var(n).numpy() for n in names}


# ------------------------------------------------------ persistables


def test_port_save_loads_in_the_jax_package_bit_equal(inferencers, tmp_path):
    jax_inf, pt_inf = inferencers
    names = _persist(pt_inf.inference_program)
    with pt.scope_guard(pt_inf.scope):
        pt_io.save_persistables(pt_inf.exe, str(tmp_path), pt_inf.inference_program)
    assert {"__params__.npz", "manifest.json"} <= set(os.listdir(tmp_path))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        jax_io.load_persistables(jax_inf.exe, str(tmp_path), jax_inf.inference_program)
    got, want = _jax_values(scope, names), _pt_values(pt_inf.scope, names)
    for n in names:
        assert got[n].dtype == want[n].dtype and np.array_equal(got[n], want[n]), n
    # the flat payload alone (no manifest) loads as well
    os.remove(tmp_path / "manifest.json")
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        jax_io.load_persistables(jax_inf.exe, str(tmp_path), jax_inf.inference_program)
    assert all(np.array_equal(np.asarray(scope.find_var(n)), want[n]) for n in names)


@pytest.mark.parametrize("manifest", [True, False])
def test_jax_save_loads_in_the_port_bit_equal_in_place(inferencers, tmp_path, manifest):
    jax_inf, _ = inferencers
    names = _persist(jax_inf.inference_program)
    with fluid.scope_guard(jax_inf.scope):
        jax_io.save_persistables(jax_inf.exe, str(tmp_path), jax_inf.inference_program)
    if not manifest:
        os.remove(tmp_path / "manifest.json")
    fresh = pt.Inferencer(_infer_func(pt, pt_transformer), place=pt.CPUPlace())
    addrs = {n: fresh.scope.find_var(n).data_ptr() for n in names}
    with pt.scope_guard(fresh.scope):
        pt_io.load_persistables(fresh.exe, str(tmp_path), fresh.inference_program)
    want = _jax_values(jax_inf.scope, names)
    for n in names:
        t = fresh.scope.find_var(n)
        assert t.data_ptr() == addrs[n], n
        assert np.array_equal(t.numpy(), want[n]), n


def test_the_manifests_match_the_jax_packages(inferencers, tmp_path):
    jax_inf, pt_inf = inferencers
    with fluid.scope_guard(jax_inf.scope):
        jax_io.save_persistables(jax_inf.exe, str(tmp_path / "jax"), jax_inf.inference_program)
    with pt.scope_guard(pt_inf.scope):
        pt_io.save_persistables(pt_inf.exe, str(tmp_path / "pt"), pt_inf.inference_program)
    mj, mp = (json.load(open(tmp_path / d / "manifest.json")) for d in ("jax", "pt"))
    for m in (mj, mp):
        m.pop("created", None)
        m.pop("time", None)
    assert mp["vars"] == mj["vars"] and mp["shards"] == mj["shards"]
    assert mp["format"] == mj["format"] and mp["program_fp"] == mj["program_fp"]


@pytest.mark.parametrize("direction", ["pt_to_jax", "jax_to_pt"])
def test_bf16_values_are_stored_as_the_jax_package_stores_them(tmp_path, direction):
    rs = np.random.RandomState(4)
    vals = rs.randn(3, 5).astype(np.float32)
    progs = {}
    for pkg in (fluid, pt):
        main = pkg.Program()
        main.global_block.create_var(name="w16", shape=[3, 5], dtype="bfloat16",
                                     persistable=True)
        progs[pkg] = main
    jscope, tscope = fluid.Scope(), pt.Scope()
    import jax.numpy as jnp
    jscope.set_var("w16", jnp.asarray(vals, dtype=jnp.bfloat16))
    tscope.set_var("w16", torch.from_numpy(vals).to(torch.bfloat16))
    exe = pt.Executor(pt.CPUPlace())
    src = tmp_path / "src"
    if direction == "pt_to_jax":
        with pt.scope_guard(tscope):
            pt_io.save_persistables(exe, str(src), progs[pt])
        out = fluid.Scope()
        with fluid.scope_guard(out):
            jax_io.load_persistables(None, str(src), progs[fluid])
        got = np.asarray(out.find_var("w16")).astype(np.float32)
    else:
        with fluid.scope_guard(jscope):
            jax_io.save_persistables(None, str(src), progs[fluid])
        out = pt.Scope()
        out.set_var("w16", torch.zeros(3, 5, dtype=torch.bfloat16))
        ptr = out.find_var("w16").data_ptr()
        with pt.scope_guard(out):
            pt_io.load_persistables(exe, str(src), progs[pt])
        assert out.find_var("w16").data_ptr() == ptr
        got = out.find_var("w16").float().numpy()
    want = torch.from_numpy(vals).to(torch.bfloat16).float().numpy()
    assert np.array_equal(got, want)
    with np.load(src / "__params__.npz") as data:
        assert json.loads(str(data["__meta__"]))["w16"] == "bfloat16"
        assert data["w16"].dtype == np.uint16


def test_load_vars_binds_a_name_the_scope_lacks_on_the_executors_device(inferencers, tmp_path):
    _, pt_inf = inferencers
    names = _persist(pt_inf.inference_program)
    with pt.scope_guard(pt_inf.scope):
        pt_io.save_params(pt_inf.exe, str(tmp_path), pt_inf.inference_program)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt_io.load_params(pt_inf.exe, str(tmp_path), pt_inf.inference_program)
    params = [p.name for p in pt_inf.inference_program.global_block.all_parameters()]
    assert sorted(scope._vars) == sorted(params) and set(params) <= set(names)
    for n in params:
        got = scope.find_var(n)
        assert got.device == torch.device("cpu") and torch.equal(got, pt_inf.scope.find_var(n))
    with pytest.raises(ValueError, match="no executor"):
        with pt.scope_guard(pt.Scope()):
            pt_io.load_params(None, str(tmp_path), pt_inf.inference_program)


# ------------------------------------------------------ inference models


@pytest.mark.parametrize("saver", ["pt", "jax"])
def test_inference_models_load_and_serve_in_both_packages(inferencers, tmp_path, saver):
    jax_inf, pt_inf = inferencers
    logits = jax_inf.predict_vars[0].name
    d = str(tmp_path)
    if saver == "pt":
        with pt.scope_guard(pt_inf.scope), pytest.warns(UserWarning, match="StableHLO"):
            pt_io.save_inference_model(d, ["src", "trg"], pt_inf.predict_vars, pt_inf.exe,
                                       pt_inf.inference_program)
    else:
        with fluid.scope_guard(jax_inf.scope):
            jax_io.save_inference_model(d, ["src", "trg"], jax_inf.predict_vars, jax_inf.exe,
                                        jax_inf.inference_program, export_compiled=False)
    model = json.load(open(tmp_path / "__model__.json"))
    assert model["feed_names"] == ["src", "trg"] and model["fetch_names"] == [logits]
    feed = _feed(1)
    jscope, tscope = fluid.Scope(), pt.Scope()
    texe = pt.Executor(pt.CPUPlace())
    with fluid.scope_guard(jscope):
        jprog, jfeeds, jfetch = jax_io.load_inference_model(d, jax_inf.exe)
        (a,) = jax_inf.exe.run(jprog, feed=feed, fetch_list=jfetch, scope=jscope)
    with pt.scope_guard(tscope):
        tprog, tfeeds, tfetch = pt_io.load_inference_model(d, texe)
    (b,) = texe.run(tprog, feed=feed, fetch_list=tfetch, scope=tscope)
    assert jfeeds == tfeeds == ["src", "trg"] and [v.name for v in tfetch] == [logits]
    assert _scrub(tprog.desc.to_dict()) == _scrub(jprog.desc.to_dict())
    (ref,) = jax_inf.infer(feed)
    np.testing.assert_allclose(b, np.asarray(a), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(b, np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_save_train_model_writes_the_whole_program(tmp_path):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4])
        y = pt.layers.fc(input=x, size=2)
        loss = pt.layers.mean(y)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    with pt.scope_guard(scope):
        pt_io.save_train_model(str(tmp_path), ["x"], [loss], exe, main)
    meta = json.load(open(tmp_path / "__model__.json"))
    assert meta["fetch_names"] == [loss.name]
    assert [o["type"] for o in meta["program"]["blocks"][0]["ops"]] == \
        [o.type for o in main.desc.block(0).ops]
    assert "sgd" in [o.type for o in main.desc.block(0).ops]


@pytest.mark.parametrize("saver", ["pt", "jax"])
def test_inferencer_param_path_gives_the_jax_inferencers_logits(inferencers, tmp_path, saver):
    jax_inf, pt_inf = inferencers
    if saver == "pt":
        with pt.scope_guard(pt_inf.scope):
            pt_io.save_persistables(pt_inf.exe, str(tmp_path), pt_inf.inference_program)
    else:
        with fluid.scope_guard(jax_inf.scope):
            jax_io.save_persistables(jax_inf.exe, str(tmp_path), jax_inf.inference_program)
    j = fluid.Inferencer(infer_func=_infer_func(fluid, jax_transformer), param_path=str(tmp_path))
    t = pt.Inferencer(_infer_func(pt, pt_transformer), param_path=str(tmp_path),
                      place=pt.CPUPlace())
    for n in _persist(t.inference_program):
        assert np.array_equal(t.scope.find_var(n).numpy(), np.asarray(j.scope.find_var(n))), n
    for seed in (2, 3):
        feed = _feed(seed)
        (a,) = j.infer(feed)
        (b,) = t.infer(feed)
        np.testing.assert_allclose(b, np.asarray(a), atol=LOGIT_ATOL, rtol=0)


def test_trainer_param_path_loads_into_the_trainers_own_scope(tmp_path):
    """The port's Trainer loads ``param_path`` into its scope.  (The JAX
    package's Trainer loads it into the global scope instead, where its
    steps never read it: ROADMAP §C.)"""
    def train_func():
        x = pt.layers.data(name="x", shape=[4])
        return pt.layers.mean(pt.layers.fc(input=x, size=3))

    def make(**kw):
        with pt.unique_name.guard():
            return pt.Trainer(train_func, lambda: pt.optimizer.Adam(learning_rate=0.01),
                              place=pt.CPUPlace(), **kw)
    a = make()
    rs = np.random.RandomState(0)
    reader = pt.batch(lambda: iter([(rs.randn(4).astype(np.float32),) for _ in range(6)]), 3)
    a.train(1, lambda ev: None, reader=reader, feed_order=["x"])
    a.save_params(str(tmp_path))
    b = make(param_path=str(tmp_path))
    names = [v.name for v in a.train_program.list_vars() if v.persistable]
    assert len(names) == 3 + 2 * 4        # w, b, the learning rate, 4 Adam slots each
    for n in names:
        assert torch.equal(a.scope.find_var(n), b.scope.find_var(n)), n
    assert pt.global_scope().find_var(names[0]) is None


# ------------------------------------------------------ clone(for_test)


def _training_program(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                                    d_model=D_MODEL, n_head=N_HEAD, d_inner=D_INNER,
                                    fuse_final_ce=True, dropout_rate=0.1)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def test_clone_for_test_gives_the_jax_clones_ops():
    (jm, _, _), (tm, _, _) = (_training_program(fluid, jax_transformer),
                              _training_program(pt, pt_transformer))
    jc, tc = jm.clone(for_test=True), tm.clone(for_test=True)
    assert _scrub(tc.desc.to_dict()) == _scrub(jc.desc.to_dict())
    types = [o.type for o in tc.desc.block(0).ops]
    assert not any(t.endswith("_grad") or t in ("adam", "sum", "fill_constant") for t in types)
    assert len(types) < len(tm.desc.block(0).ops) // 2
    drops = [o for o in tc.desc.block(0).ops if o.type == "dropout"]
    assert drops and all(o.attrs["is_test"] for o in drops)
    assert not any(o.attrs["is_test"] for o in tm.desc.block(0).ops if o.type == "dropout")
    assert tc.desc.version > 0 and tc.desc.uid != tm.desc.uid
    assert [v.name for v in tc.global_block.all_parameters()] == \
        [v.name for v in tm.global_block.all_parameters()]


def test_running_the_for_test_clone_changes_no_state():
    main, startup, loss = _training_program(pt, pt_transformer)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    test_prog = main.clone(for_test=True)
    before = {n: scope.find_var(n).clone() for n in _persist(main)}
    rs = np.random.RandomState(0)
    feed = {k: v for k, v in _feed(5, rows=2).items()}
    feed["lbl"] = rs.randint(1, VOCAB, (2, T, 1)).astype(np.int64)
    (a,) = exe.run(test_prog, feed=feed, fetch_list=[loss.name], scope=scope)
    (b,) = exe.run(test_prog, feed=feed, fetch_list=[loss.name], scope=scope)
    assert np.isfinite(a) and np.array_equal(a, b)          # dropout off: deterministic
    for n, v in before.items():
        assert torch.equal(v, scope.find_var(n)), n
    (entry,) = [e for e in exe.cache_info()["entries"] if "lbl" in e["feeds"]]
    assert entry["graph_eligible"]


# ------------------------------------------------------ bf16 serving


def test_bf16_inferencer_within_the_bound_of_the_jax_packages(inferencers):
    jax_f32, pt_f32 = inferencers
    j = fluid.Inferencer(infer_func=_infer_func(fluid, jax_transformer), amp=JaxAmpConfig())
    t = pt.Inferencer(_infer_func(pt, pt_transformer), place=pt.CPUPlace(), amp=AmpConfig())
    names = _persist(jax_f32.inference_program)
    import jax.numpy as jnp
    for n in names:
        j.scope.set_var(n, jnp.asarray(np.asarray(jax_f32.scope.find_var(n))))
        t.scope.find_var(n).copy_(torch.from_numpy(np.array(jax_f32.scope.find_var(n))))
    for seed in (6, 7, 8):
        feed = _feed(seed, rows=4)
        (a,) = j.infer(feed)
        (b,) = t.infer(feed)
        (f,) = pt_f32.infer(feed)
        a, b, f = (np.asarray(v, np.float64) for v in (a, b, f))
        err = np.linalg.norm(b - a) / np.linalg.norm(a)
        vs_fp32 = np.linalg.norm(b - f) / np.linalg.norm(f)
        assert err <= BF16_NREL, (seed, err)
        assert vs_fp32 >= BF16_VS_FP32_MIN, (seed, vs_fp32)
