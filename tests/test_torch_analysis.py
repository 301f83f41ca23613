"""The static verifier ported (``paddle_tpu_torch.analysis``), against the
JAX package's on the CPU.

The corpus (:func:`planted_programs`, :func:`main_path_programs`; the
memory and passes tests import it):

* the planted-fault programs of ``tests/test_analysis.py``, built by the
  JAX package and parsed into the port from their serialized desc: every
  code of the catalog a program can trip (S101-S103, D201-D206, A301,
  A302, R401-R404, with ``mesh=`` as an ``{axis: size}`` dict and a
  ``layout=``), control flow included;
* the port's main paths at 1+1 layers (vocab 1000, d_model 64, 4 heads,
  d_inner 256, max_len 32), built by both packages: float32 serving and
  its int8 kernel-tier rewrite, the fused float32 step and its bf16 and
  kernel-tier rewrites, the reference step (unfused head with token
  weights, noam_decay, Adam, clip, L2) and its eval clone; ResNet-18 at
  32 x 32 (and its amp-bf16 rewrite), the MNIST CNN with Adam and VGG16 at
  32 x 32.  A rewrite is the port's, loaded into the JAX package through
  its serialized desc, so the JAX verifier reads the program the port
  runs.

On every program both packages' ``verify`` give the same sorted
``(code, severity, var, op_type, block_idx, op_index)``; every
infer-shape rule gives equal shapes and dtypes on every op of a type the
port lowers; ``infer_shape_coverage()`` is equal over the 178 lowered op
types; ``Executor(validate=)`` raises, warns and memoizes as the JAX
package's; ``tools/program_lint.py`` reads the port's program dumps.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.analysis  # noqa: F401  (registers fluid.analysis)
import paddle_tpu_torch as pt
from paddle_tpu import layers as jl
import paddle_tpu.passes  # noqa: F401  (registers fluid.passes)
from paddle_tpu.amp import compose_passes as jax_compose_passes
from paddle_tpu.analysis import verifier as jax_verifier
from paddle_tpu.core.desc import DataType as JaxDataType
from paddle_tpu.core.desc import OpDesc as JaxOpDesc
from paddle_tpu.core.desc import ProgramDesc as JaxProgramDesc
from paddle_tpu.core.desc import VarDesc as JaxVarDesc
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.ops.pallas.policy import KernelPolicy as JaxKernelPolicy
from paddle_tpu.parallel import SpecLayout
from paddle_tpu_torch import analysis
from paddle_tpu_torch.core.desc import ProgramDesc
from paddle_tpu_torch.core.registry import OPS, _generic_grad_infer_shape
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.telemetry import REGISTRY

from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER, ROWS = 1000, 64, 4, 256, 32, 1, 4
# op types the port lowers (143, the 22 sequence and recurrent types, the
# 13 control-flow types, the 12 sparse and embedding types, auc and the 7
# parameter-server types, pipeline and moe_ffn)
N_LOWERED = 202


# ------------------------------------------------------------ the corpus

def to_port(jax_program):
    """A JAX-built program's desc, parsed by the port."""
    return ProgramDesc.parse(getattr(jax_program, "desc", jax_program).serialize())


def to_jax(port_program):
    """A port-built program's desc, parsed by the JAX package."""
    return JaxProgramDesc.parse(getattr(port_program, "desc", port_program).serialize())


def _mlp(with_opt=True):
    """tests/test_analysis.py's clean train program: x -> fc -> fc -> CE [-> sgd]."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = jl.data(name="x", shape=[8], dtype="float32")
        lbl = jl.data(name="lbl", shape=[1], dtype="int64")
        h = jl.fc(input=x, size=16, act="relu")
        logits = jl.fc(input=h, size=4)
        loss = jl.mean(jl.softmax_with_cross_entropy(logits=logits, label=lbl))
        if with_opt:
            fluid.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _pow_tampered(attr):
    main, _, loss = _mlp(with_opt=False)
    with fluid.program_guard(main):
        h = jl.pow(main.current_block().var("x"), factor=2.0)
    vd = main.desc.block(0).find_var(h.name)
    if attr == "shape":
        vd.shape = (8, 999)
    else:
        vd.dtype = JaxDataType.INT64
    main.desc._bump()
    return main, [loss.name, h.name], {}


def _swapped_muls():
    main, _, loss = _mlp(with_opt=False)
    ops = main.desc.block(0).ops
    idx = [i for i, op in enumerate(ops) if op.type == "mul"]
    ops[idx[0]], ops[idx[1]] = ops[idx[1]], ops[idx[0]]
    main.desc._bump()
    return main, [loss.name], {}


def _undefined_read():
    main, _, loss = _mlp(with_opt=False)
    for op in main.desc.block(0).ops:
        if op.type == "mean":
            op.rename_input(op.input_names()[0], "never_declared")
    main.desc._bump()
    return main, [loss.name], {}


def _unreachable_fetch(name):
    main, _, loss = _mlp(with_opt=False)
    main.current_block().create_var(name="orphan", shape=(4,), dtype="float32")
    return main, [loss.name, name], {}


def _dead_code():
    main, _, loss = _mlp(with_opt=False)
    with fluid.program_guard(main):
        jl.fc(input=main.current_block().var("x"), size=3)
        main.current_block().create_var(name="unused", shape=(2,), dtype="float32")
    return main, [loss.name], {}


def _param_clobber():
    main, _, loss = _mlp(with_opt=False)
    param = main.all_parameters()[0]
    with fluid.program_guard(main):
        main.current_block().append_op("scale", inputs={"X": [param.name]},
                                       outputs={"Out": [param.name]}, attrs={"scale": 0.5})
    return main, [loss.name], {}


def _feed_clobber():
    main, _, loss = _mlp(with_opt=False)
    main.current_block().append_op("scale", inputs={"X": ["x"]}, outputs={"Out": ["x"]},
                                   attrs={"scale": 2.0})
    return main, [loss.name], {"feed_names": ["x", "lbl"], "donate_feeds": True}


def _read_after_update():
    main, _, loss = _mlp()
    blk = main.current_block()
    param = main.all_parameters()[0]
    blk.append_op("scale", inputs={"X": [param.name]}, outputs={"Out": ["post_read"]},
                  attrs={"scale": 1.0})
    blk.create_var(name="post_read", shape=param.shape, dtype="float32")
    return main, [loss.name], {}


def _infer_shape_raises():
    """A ``one_hot`` whose ``depth`` is missing: the rule raises (S103)."""
    main, _, loss = _mlp(with_opt=False)
    blk = main.desc.block(0)
    blk.add_var(JaxVarDesc(name="oh", shape=(-1, 4), dtype=JaxDataType.FP32))
    blk.ops.append(JaxOpDesc(type="one_hot", inputs={"X": ["lbl"]}, outputs={"Out": ["oh"]},
                             attrs={"depth": None}))
    main.desc._bump()
    return main, [loss.name, "oh"], {}


def _seq_program(buckets=None):
    """tests/test_analysis.py's ragged program, with ``reduce_sum`` over the
    time axis (an op the port lowers) in place of ``sequence_pool``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        seq = jl.data(name="seq", shape=[1], dtype="int64", lod_level=1)
        emb = jl.embedding(input=seq, size=[50, 8])
        pooled = jl.reduce_sum(emb, dim=1)
        loss = jl.mean(jl.fc(input=pooled, size=4))
        if buckets is not None:
            fluid.DataFeeder(feed_list=[seq], seq_len_buckets=buckets)
    return main, [loss.name], {"feed_names": ["seq"]}


def _sharded(spec, mesh):
    main, _, loss = _mlp(with_opt=False)
    main.all_parameters()[0].set_sharding(spec)
    return main, [loss.name], {"mesh": mesh}


def _layout(seeded):
    main, _, loss = _mlp()
    if seeded:
        main.all_parameters()[0].set_sharding(("nope",))
    return main, [loss.name], {"layout": SpecLayout(), "mesh": {"data": 2, "fsdp": 2, "tp": 2}}


def _while_program(late_read=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        i = jl.fill_constant(shape=[1], dtype="int32", value=0)
        limit = jl.fill_constant(shape=[1], dtype="int32", value=4)
        acc = jl.fill_constant(shape=[1], dtype="int32", value=0)
        cond = jl.less_than(i, limit)
        w = jl.While(cond)
        with w.block():
            t = jl.elementwise_add(acc, i)
            jl.assign(t, output=acc)
            jl.increment(i, value=1, in_place=True)
            jl.less_than(i, limit, cond=cond)
    if late_read:
        blk0 = main.desc.block(0)
        blk0.add_var(JaxVarDesc(name="late", shape=(1,), dtype=JaxDataType.FP32))
        blk0.ops.append(JaxOpDesc(type="fill_constant", outputs={"Out": ["late"]},
                                  attrs={"shape": [1], "value": 0.0, "dtype": "float32"}))
        (widx,) = [k for k, op in enumerate(blk0.ops) if op.type == "while"]
        sub = main.desc.blocks[blk0.ops[widx].block_attr("sub_block")]
        sub.ops.append(JaxOpDesc(type="scale", inputs={"X": ["late"]},
                                 outputs={"Out": ["body_read"]}, attrs={"scale": 1.0}))
        sub.add_var(JaxVarDesc(name="body_read", shape=(1,), dtype=JaxDataType.FP32))
        main.desc._bump()
    return main, [acc.name], {}


def _cond_ghost():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = jl.fill_constant(shape=[1], dtype="float32", value=3.0)
        flag = jl.fill_constant(shape=[1], dtype="bool", value=True)
        out = jl.fill_constant(shape=[1], dtype="float32", value=0.0)
        cb = jl.ConditionalBlock([flag])
        with cb.block():
            jl.assign(x, out)
    (cidx,) = [k for k, op in enumerate(main.desc.block(0).ops)
               if op.type == "conditional_block"]
    sub = main.desc.blocks[main.desc.block(0).ops[cidx].block_attr("sub_block")]
    sub.ops.append(JaxOpDesc(type="scale", inputs={"X": ["ghost"]}, outputs={"Out": ["ghost2"]}))
    main.desc._bump()
    return main, [out.name], {}


PLANTED = {
    "clean_train": lambda: (lambda m: (m[0], [m[2].name], {}))(_mlp()),
    "clean_test": lambda: (lambda m: (m[0].clone(for_test=True), [m[2].name], {}))(_mlp()),
    "S101": lambda: _pow_tampered("shape"),
    "S102": lambda: _pow_tampered("dtype"),
    "S103": _infer_shape_raises,
    "D201": _swapped_muls,
    "D202": _undefined_read,
    "D203": lambda: _unreachable_fetch("orphan"),
    "D203_undeclared": lambda: _unreachable_fetch("no_such_var"),
    "D204_D205": _dead_code,
    "D206": _param_clobber,
    "A301": _feed_clobber,
    "A302": _read_after_update,
    "R401": _seq_program,
    "R401_bucketed": lambda: _seq_program("pow2"),
    "R402": lambda: _sharded(("model", None), {"data": 2, "tp": 2}),
    "R403": lambda: _sharded(("data", None, "tp"), {"data": 2, "tp": 2}),
    "R404": lambda: _sharded((None, "tp"), {"tp": 3}),
    "layout_clean": lambda: _layout(False),
    "layout_R402": lambda: _layout(True),
    "while_clean": _while_program,
    "while_D201": lambda: _while_program(late_read=True),
    "cond_D202": _cond_ghost,
}
# the code each planted program is built to trip (None: a clean program)
PLANTED_CODE = {"clean_train": None, "clean_test": None, "layout_clean": None,
                "while_clean": None, "R401_bucketed": None, "D203_undeclared": "D203",
                "D204_D205": "D205", "layout_R402": "R402", "while_D201": "D201",
                "cond_D202": "D202"}


@functools.lru_cache(maxsize=None)
def planted_programs():
    """name -> (the JAX package's parse of the program's serialized desc,
    the port's parse of it, fetch names, kwargs).  Both sides read the same
    serialized form: parsing orders an op's slots by name, and D204 names
    an op's first output."""
    out = {}
    for name, build in PLANTED.items():
        with fluid.unique_name.guard():
            jprog, fetch, kw = build()
        out[name] = (to_jax(jprog), to_port(jprog), fetch, kw)
    return out


def _serving(pkg, mod):
    src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    return [mod.transformer(src, trg, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER, d_model=D_MODEL,
                            n_head=N_HEAD, d_inner=D_INNER, is_test=True)]


def _fused_step(pkg, mod):
    src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
    loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T, n_layer=N_LAYER,
                                d_model=D_MODEL, n_head=N_HEAD, d_inner=D_INNER,
                                fuse_final_ce=True)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return [loss]


def reference_net(pkg, mod):
    """The reference path's forward: the unfused head with token weights,
    L2 on the fc weights, global-norm clipping; returns the loss."""
    src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
    wgt = pkg.layers.data(name="wgt", shape=[T, 1], dtype="float32")
    loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, weights=wgt, max_len=T,
                                n_layer=N_LAYER, d_model=D_MODEL, n_head=N_HEAD,
                                d_inner=D_INNER, fuse_final_ce=False)
    for p in pkg.default_main_program().global_block.all_parameters():
        if p.name.startswith("fc_") and p.name.endswith(".w_0"):
            p.regularizer = pkg.regularizer.L2Decay(1e-4)
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0))
    return loss


def _reference_step(pkg, mod):
    loss = reference_net(pkg, mod)
    lr = pkg.layers.noam_decay(D_MODEL, 4)
    pkg.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98, epsilon=1e-9).minimize(loss)
    return [loss, lr]


def _resnet18(pkg, mod=None):
    image = pkg.layers.data(name="image", shape=[3, 32, 32], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    loss, acc = pkg.models.resnet.train_network(image, label, class_dim=10, depth=18)
    pkg.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    return [loss, acc]


def _mnist(pkg, mod=None):
    image = pkg.layers.data(name="pixel", shape=[1, 28, 28], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    loss, acc = pkg.models.mnist.train_network(image, label)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return [loss, acc]


def _vgg(pkg, mod=None):
    image = pkg.layers.data(name="image", shape=[3, 32, 32], dtype="float32")
    label = pkg.layers.data(name="label", shape=[1], dtype="int64")
    loss, _ = pkg.models.vgg.train_network(image, label, class_dim=10)
    pkg.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    return [loss]


def _build(pkg, mod, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        outs = build(pkg, mod)
    return main, startup, [v.name for v in outs]


def transformer_feed(rows=ROWS, weights=False, seed=0):
    rs = np.random.RandomState(seed)
    feed = {}
    for name in ("src", "trg"):
        lens = rs.randint(T // 2, T + 1, rows).astype(np.int32)
        ids = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
        ids[np.arange(T)[None, :] >= lens[:, None]] = 0
        feed[name], feed[name + "@SEQ_LEN"] = ids, lens
    feed["lbl"] = rs.randint(1, VOCAB, (rows, T, 1)).astype(np.int64)
    if weights:
        feed["wgt"] = (np.arange(T)[None, :] < feed["trg@SEQ_LEN"][:, None]).astype(
            np.float32)[..., None]
    return feed


def _rewrite(program, fetch, **knobs):
    """The program the port's CPU executor runs with these knobs."""
    exe = pt.Executor(pt.CPUPlace(), validate="off", **knobs)
    return exe._apply_passes(program, [], fetch)


@functools.lru_cache(maxsize=None)
def main_path_programs():
    """name -> (JAX program, port program, fetch names, feed shapes).  A
    rewrite's JAX program is the port's rewrite parsed by the JAX package."""
    tf = (jax_transformer, pt_transformer)
    fs_serve = {k: v.shape for k, v in transformer_feed().items() if k != "lbl"}
    fs_train = {k: v.shape for k, v in transformer_feed().items()}
    fs_ref = {k: v.shape for k, v in transformer_feed(weights=True).items()}
    fs_img = {"image": (ROWS, 3, 32, 32), "label": (ROWS, 1)}
    fs_mnist = {"pixel": (ROWS, 1, 28, 28), "label": (ROWS, 1)}
    out = {}
    for name, build, mods, fs in (("serving", _serving, tf, fs_serve),
                                  ("fused_step", _fused_step, tf, fs_train),
                                  ("reference_step", _reference_step, tf, fs_ref),
                                  ("resnet18", _resnet18, (None, None), fs_img),
                                  ("mnist", _mnist, (None, None), fs_mnist),
                                  ("vgg16", _vgg, (None, None), fs_img)):
        jm, _, jfetch = _build(fluid, mods[0], build)
        tm, _, tfetch = _build(pt, mods[1], build)
        assert jfetch == tfetch
        out[name] = (jm, tm, tfetch, fs)
    tm, fetch = out["reference_step"][1], out["reference_step"][2][:1]
    jm = out["reference_step"][0]
    out["reference_eval"] = (jm.clone(for_test=True), tm.clone(for_test=True), fetch, fs_ref)
    rewrites = (
        ("serving_int8", "serving", dict(amp=pt.amp.AmpConfig(bf16=False, quant=True),
                                         kernels=True)),
        ("fused_step_bf16", "fused_step", dict(amp=pt.amp.AmpConfig())),
        ("fused_step_kernels", "fused_step", dict(kernels=True)),
        ("reference_step_bf16", "reference_step", dict(amp=pt.amp.AmpConfig(), kernels=True)),
        ("resnet18_bf16", "resnet18", dict(amp=pt.amp.AmpConfig())),
        # chip_smoke.py phase 14 fetches every gradient of the bf16 step
        ("fused_step_bf16_grads", "fused_step", dict(amp=pt.amp.AmpConfig(), kernels=True)),
    )
    for name, base, knobs in rewrites:
        _, tm, fetch, fs = out[base]
        if name.endswith("_grads"):
            fetch = fetch + [p.name + "@GRAD" for p in tm.global_block.all_parameters()]
        rewritten = _rewrite(tm, fetch, **knobs)
        assert rewritten is not tm
        out[name] = (to_jax(rewritten), rewritten, fetch, fs)
    return out


def corpus():
    """Every program of the corpus: name -> (JAX program or desc, port
    program or desc, fetch names, verify kwargs, feed shapes or None)."""
    out = {f"planted:{k}": (j, t, f, kw, None) for k, (j, t, f, kw) in planted_programs().items()}
    out.update({f"main:{k}": (j, t, f, {}, fs)
                for k, (j, t, f, fs) in main_path_programs().items()})
    return out


def findings(res):
    return sorted((d.code, d.severity, d.var or "", d.op_type or "", d.block_idx,
                   -1 if d.op_index is None else d.op_index) for d in res.diagnostics)


def lowered_types():
    return sorted(t for t, i in OPS._map.items() if i.lower is not None)


# --------------------------------------------------------------- parity

@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_faults_give_equal_findings(name):
    jprog, tdesc, fetch, kw = planted_programs()[name]
    jres = jax_verifier.verify(jprog, fetch_list=fetch, **kw)
    tres = analysis.verify(tdesc, fetch_list=fetch, **kw)
    assert findings(tres) == findings(jres)
    code = PLANTED_CODE.get(name, name)
    if code is None:
        assert tres.findings == [], [str(d) for d in tres.findings]
    else:
        assert code in {d.code for d in tres.diagnostics}, tres.format()
    assert tres.num_ops == jres.num_ops and tres.num_blocks == jres.num_blocks
    assert tres.program_fp == jres.program_fp and set(tres.checks) == set(analysis.ALL_CHECKS)
    # and the port's desc, serialized back, verifies the same in the JAX package
    assert findings(jax_verifier.verify(to_jax(tdesc), fetch_list=fetch, **kw)) == findings(jres)


def test_planted_findings_name_the_op_and_its_callsite():
    jprog, tdesc, fetch, kw = planted_programs()["S101"]
    (d,) = analysis.verify(tdesc, fetch_list=fetch, **kw).by_code("S101")
    assert d.op_type == "pow" and d.callsite and os.path.basename(__file__) in d.callsite
    assert d.to_dict().keys() == jax_verifier.verify(jprog, fetch_list=fetch).by_code(
        "S101")[0].to_dict().keys()


@pytest.mark.parametrize("name", ["serving", "fused_step", "reference_step", "reference_eval",
                                  "resnet18", "mnist", "vgg16", "serving_int8",
                                  "fused_step_bf16", "fused_step_kernels",
                                  "reference_step_bf16", "resnet18_bf16",
                                  "fused_step_bf16_grads"])
def test_main_paths_give_equal_findings_and_no_error(name):
    """A program built by both packages verifies the same in memory; and
    each package's parse of the port's serialized desc verifies the same
    (parsing orders an op's output slots by name, and D204 names the first
    output, so a parsed program is compared with a parsed program)."""
    jprog, tprog, fetch, _ = main_path_programs()[name]
    tres = analysis.verify(tprog, fetch_list=fetch)
    assert tres.counts()["error"] == tres.counts()["warning"] == 0, tres.format()
    if not isinstance(jprog, JaxProgramDesc):
        assert findings(tres) == findings(jax_verifier.verify(jprog, fetch_list=fetch))
    assert findings(analysis.verify(to_port(tprog), fetch_list=fetch)) == \
        findings(jax_verifier.verify(to_jax(tprog), fetch_list=fetch))
    assert findings(analysis.verify(to_port(jprog), fetch_list=fetch)) == \
        findings(jax_verifier.verify(to_jax(jprog), fetch_list=fetch))


def test_infer_shape_coverage_equal_on_the_lowered_op_types():
    lowered = lowered_types()
    assert len(lowered) == N_LOWERED
    mine = [t for t in OPS.infer_shape_coverage() if t in lowered]
    theirs = [t for t in JAX_OPS.infer_shape_coverage() if t in lowered]
    assert mine == theirs and len(mine) == 166
    for t in lowered:
        assert (OPS.infer_shape_fn(t) is None) == (JAX_OPS.infer_shape_fn(t) is None), t
    # a <type>_grad without a rule of its own gets the structural grad rule
    assert "dropout_grad" not in mine
    assert OPS.infer_shape_fn("dropout_grad") is _generic_grad_infer_shape


def _propagate(desc, ops, feed_shapes, lowered):
    """Apply each op's rule in program order on a clone with the feeds'
    concrete shapes; returns, per op of a lowered type, its outputs'
    (shape, dtype) or the exception's type."""
    scratch = desc.clone()
    block = scratch.block(0)
    for n, sh in (feed_shapes or {}).items():
        vd = block.find_var(n)
        if vd is not None:
            vd.shape = tuple(int(d) for d in sh)
    rows = []
    for i, op in enumerate(block.ops):
        fn = ops.infer_shape_fn(op.type)
        if fn is None:
            continue
        try:
            fn(block, op)
        except Exception as e:  # noqa: BLE001 -- compared across packages
            got = type(e).__name__
        else:
            got = sorted((n, tuple(block.find_var(n).shape), block.find_var(n).dtype.value)
                         for n in op.output_names() if n and block.find_var(n) is not None)
        if op.type in lowered:
            rows.append((i, op.type, got))
    return rows


@pytest.mark.parametrize("name", sorted(n for n in ("serving", "fused_step", "reference_step",
                                                    "reference_eval", "resnet18", "mnist",
                                                    "vgg16", "serving_int8", "fused_step_bf16",
                                                    "fused_step_kernels",
                                                    "reference_step_bf16", "resnet18_bf16",
                                                    "fused_step_bf16_grads")))
def test_every_rule_gives_equal_shapes_and_dtypes(name):
    jprog, tprog, _, fs = main_path_programs()[name]
    lowered = set(lowered_types())
    mine = _propagate(tprog.desc, OPS, fs, lowered)
    theirs = _propagate(jprog if isinstance(jprog, JaxProgramDesc) else jprog.desc, JAX_OPS,
                        fs, lowered)
    assert len(mine) > 10 and mine == theirs


def test_every_rule_on_the_planted_programs():
    lowered = set(lowered_types())
    for name, (jprog, tdesc, _, _) in planted_programs().items():
        assert _propagate(tdesc, OPS, None, lowered) == \
            _propagate(jprog, JAX_OPS, None, lowered), name


# ------------------------------------------------- Executor(validate=)

def _port_mlp(with_opt=False):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8], dtype="float32")
        lbl = pt.layers.data(name="lbl", shape=[1], dtype="int64")
        h = pt.layers.fc(input=x, size=16, act="relu")
        logits = pt.layers.fc(input=h, size=4)
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(logits=logits, label=lbl))
        if with_opt:
            pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _mlp_feed(rows=4):
    rs = np.random.RandomState(0)
    return {"x": rs.rand(rows, 8).astype(np.float32),
            "lbl": rs.randint(0, 4, (rows, 1)).astype(np.int64)}


def _swap_muls(main):
    ops = main.desc.block(0).ops
    idx = [i for i, op in enumerate(ops) if op.type == "mul"]
    ops[idx[0]], ops[idx[1]] = ops[idx[1]], ops[idx[0]]
    main.desc._bump()


@pytest.mark.allow_validate_findings
def test_executor_validate_error_raises_on_a_planted_d201():
    main, startup, loss = _port_mlp()
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace(), validate="off").run(startup, scope=scope)
    _swap_muls(main)
    exe = pt.Executor(pt.CPUPlace(), validate="error")
    with pytest.raises(analysis.ProgramVerificationError, match="D201") as ei:
        exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    assert ei.value.result.errors and exe.cache_info()["executables"] == 0
    d = ei.value.result.errors[0]
    assert d.callsite and os.path.basename(__file__) in d.callsite


@pytest.mark.allow_validate_findings
def test_executor_validate_warn_warns_and_runs():
    main, startup, loss = _port_mlp()
    blk = main.desc.block(0)
    param = main.global_block.all_parameters()[0].name
    from paddle_tpu_torch.core.desc import OpDesc
    blk.ops.append(OpDesc(type="scale", inputs={"X": [param]}, outputs={"Out": [param]},
                          attrs={"scale": 1.0}))
    main.desc._bump()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), validate="warn")
    exe.run(startup, scope=scope)
    before = REGISTRY.counter("validate_findings", scope="analysis").value
    with pytest.warns(UserWarning, match="D206"):
        (out,) = exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    assert REGISTRY.counter("validate_findings", scope="analysis").value == before + 1
    assert analysis.LAST_FINDINGS[-1].code == "D206"


def test_executor_validate_modes_and_default(monkeypatch):
    with pytest.raises(ValueError, match="validate"):
        pt.Executor(pt.CPUPlace(), validate="loud")
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "error")
    assert pt.Executor(pt.CPUPlace()).validate == "error"
    monkeypatch.delenv("PADDLE_TPU_VALIDATE")
    assert pt.Executor(pt.CPUPlace()).validate == "off"


def test_buckets_share_one_verification_pass():
    main, startup, loss = _port_mlp()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), validate="error")
    exe.run(startup, scope=scope)
    verified = REGISTRY.counter("programs_verified", scope="analysis")
    before = verified.value
    for rows in (1, 2, 4, 8):
        exe.precompile(main, feed={"x": ((rows, 8), "float32"), "lbl": ((rows, 1), "int64")},
                       fetch_list=[loss], scope=scope)
    assert verified.value == before + 1 and exe.compile_count == 5
    main.desc._bump()                   # a new version is verified again
    exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    assert verified.value == before + 2


def test_verify_telemetry_and_export(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path))
    main, _, loss = _port_mlp(with_opt=True)
    res = analysis.verify(main, fetch_list=[loss])
    (rec,) = [json.loads(line) for f in tmp_path.glob("analysis_*.jsonl") for line in open(f)]
    jrec = dict(jax_verifier.verify(to_jax(main), fetch_list=[loss.name]).to_dict(), ts=0)
    assert rec.keys() == jrec.keys() and rec["counts"] == res.counts()
    assert REGISTRY.histogram("verify_s", scope="analysis").count >= 1


def test_the_bf16_bridge_verifies_and_runs():
    """``enable_amp`` goes through the amp-bf16 pass with ``verify="error"``:
    the port's repaired pass adds no finding on the transformer step, where
    the JAX package's pass raises ``PassVerificationError`` (the stale-cast
    fault, tests/test_torch_amp_bf16.py)."""
    jm, tm, fetch, _ = main_path_programs()["fused_step"]
    with pytest.raises(fluid.passes.PassVerificationError, match="amp-bf16"):
        fluid.passes.PassPipeline(["amp-bf16"], verify="error").run(jm, fetch_list=fetch)
    prog = tm.clone()
    pt.amp.enable_amp(prog)
    exe = pt.Executor(pt.CPUPlace(), validate="error")
    rewritten = exe._apply_passes(prog, list(transformer_feed()), fetch)
    assert rewritten is not prog and sum(o.type == "cast" for o in rewritten.desc.block(0).ops)
    res = analysis.verify(rewritten, fetch_list=fetch)
    assert res.counts()["error"] == res.counts()["warning"] == 0


def test_the_gclip_repair_declares_the_dtype_the_value_runs_in():
    """The port's repair of the amp-bf16 pass (ROADMAP §C): on the
    reference step, the global-norm clip scales bf16 gradients into
    ``x@GRAD_gclip_0``.  The JAX pass declares those float32 (the forward
    var's dtype), and its ``verify="error"`` pipeline raises S102 on them;
    the port declares them bf16, the dtype they run in on the CPU, and
    its pipeline adds no finding."""
    jm, tm, fetch, _ = main_path_programs()["reference_step"]
    with pytest.raises(fluid.passes.PassVerificationError) as ei:
        fluid.passes.PassPipeline(["amp-bf16"], verify="error").run(jm, fetch_list=fetch)
    s102 = {d.var for d in ei.value.introduced if d.code == "S102"}
    assert s102 and all("@GRAD_gclip_" in v for v in s102)
    rewritten, res = pt.passes.PassPipeline(["amp-bf16"], verify="error").run(
        tm, fetch_list=fetch)
    block = rewritten.desc.block(0)
    assert {block.find_var(v).dtype.value for v in s102} == {"bfloat16"}
    assert res.verify_counts_post["warning"] == res.verify_counts_post["error"] == 0
    # the value really runs in bf16: fetched as a tensor from a CPU step
    main, startup, _ = _build(pt, pt_transformer, _reference_step)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace(), validate="error")
    exe.run(startup, scope=scope)
    name = sorted(s102)[0]
    out = pt.Executor(pt.CPUPlace(), amp=pt.amp.AmpConfig()).run(
        main, feed=transformer_feed(weights=True), fetch_list=[name], scope=scope,
        return_numpy=False)
    assert str(out[0].dtype) == "torch.bfloat16"


def test_the_kernel_pass_declares_a_fetched_bf16_table_gradient_as_it_runs():
    """The port's repair of the ``pallas-kernels`` pass (ROADMAP §C): after
    amp-bf16, a fetched gradient of an embedding table keeps its name
    (``trg_emb@GRAD``) and runs in bf16, declared float32 by the
    ``lookup_table_grad`` op; retyped to ``pallas_scatter_add``, whose rule
    gives it the bf16 table copy's dtype, it is re-declared bf16.  The JAX
    kernel pass keeps the float32 declaration, and its verifier reads S102."""
    _, tm, fetch, _ = main_path_programs()["fused_step"]
    grads = [p.name + "@GRAD" for p in tm.global_block.all_parameters()]
    exe = pt.Executor(pt.CPUPlace(), amp=pt.amp.AmpConfig(), kernels=True, validate="error")
    ran = exe._apply_passes(tm, list(transformer_feed()), fetch + grads)
    block = ran.desc.block(0)
    scatter = [o for o in block.ops if o.type == "pallas_scatter_add"]
    assert len(scatter) == 4
    for op in scatter:
        (g,) = op.output("W@GRAD_SLOT")
        assert g in grads
        assert block.find_var(g).dtype == block.find_var(op.input("W")[0]).dtype
        assert block.find_var(g).dtype.value == "bfloat16"
    # the JAX passes, in the same order (their pipeline's own verification
    # off: it raises on the stale casts first)
    jm = main_path_programs()["fused_step"][0]
    ref = jax_compose_passes(None, fluid.amp.AmpConfig(), kernels=JaxKernelPolicy())
    jran, _ = fluid.passes.PassPipeline(ref.passes, verify="off").run(
        jm, fetch_list=fetch + grads)
    s102 = {d.var for d in jax_verifier.verify(jran, fetch_list=fetch + grads).by_code("S102")}
    assert {op.output("W@GRAD_SLOT")[0] for op in scatter} <= s102


# ----------------------------------------------------------------- tools

def test_program_lint_reads_the_ports_program_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PROGRAM_DUMP_DIR", str(tmp_path))
    main, startup, loss = _port_mlp(with_opt=True)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), validate="off")
    exe.run(startup, scope=scope)
    exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    assert list(tmp_path.glob("program_*.json"))
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "program_lint.py"),
                        str(tmp_path), "--json", "--strict"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    out = json.loads(p.stdout)
    assert out["jax_free"] and out["errors"] == out["warnings"] == 0 and out["files"]
    # the control: a planted D201 in a dump fails the lint
    bad = tmp_path / "bad"
    bad.mkdir()
    _swap_muls(main)
    (bad / "program_1_1_v0.json").write_text(json.dumps(
        {"program": main.desc.to_dict(), "fetch_names": [loss.name]}))
    p = subprocess.run([sys.executable, os.path.join(REPO, "tools", "program_lint.py"),
                        str(bad)], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 1 and "D201" in p.stdout


def test_executor_validate_accepts_a_fetched_feed_no_op_reads():
    """A fed var that no op reads may be fetched: the executor's verifier
    counts the fetched feeds among the feeds.  ``analysis.verify`` alone
    infers the feeds from the reads, as the JAX package's does, and calls
    such a fetch unreachable (D203)."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[3])
        ids = pt.layers.data(name="ids", shape=[8], dtype="int64")
        y = pt.layers.scale(x, scale=2.0)
    assert [d.code for d in analysis.verify(main, fetch_list=[y, ids]).errors] == ["D203"]
    exe = pt.Executor(pt.CPUPlace(), validate="error")
    before = REGISTRY.counter("validate_findings", scope="analysis").value
    feed = {"x": np.ones((2, 3), np.float32), "ids": np.arange(16).reshape(2, 8)}
    _, got = exe.run(main, feed=feed, fetch_list=[y, ids])
    assert np.array_equal(got, feed["ids"])
    assert REGISTRY.counter("validate_findings", scope="analysis").value == before
