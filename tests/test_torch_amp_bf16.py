"""bf16 AMP training in the PyTorch/CUDA port against the JAX package.

The ``amp-bf16`` pass, the ``enable_amp`` bridge, the ``cast`` op and the
bf16 op lowerings, on the CPU at a small size: a 2+2-layer
``train_network(fuse_final_ce=True)`` + ``Adam`` (vocab 1024, d_model 128,
4 heads, d_inner 512, seq 32, batch 4) and two merge-free models.

The JAX pass caches one cast per (name, dtype) and keeps serving it after
a ``sum`` merge's cast-back has written the name again: a later float32
reader of a merged gradient reads the first contribution alone (a "stale
read"; 19 of them in this transformer).  The port repairs that and is
otherwise the JAX pass.  So:

* on a model without gradient merges the two rewrites are equal op for op;
* on the transformer they differ only at the stale reads, which the tests
  derive from the JAX rewrite: the port inserts a fresh cast before each
  and nothing else, leaves none stale, and adds no verifier finding (the
  JAX rewrite adds dead-op findings: the cast-backs nobody reads);
* the port's rewritten desc, loaded into the JAX package, runs in the JAX
  ``Executor``; the port's loss and gradients match it within bf16
  tolerances, and the gradients of JAX's own (stale) rewrite fail the same
  gate on the layer_norm parameters behind a merge: the control;
* those whole-step gates do not tell bf16 from float32 (the port's float32
  step passes them: see GRAD_NREL), so the bf16 rounding itself is held
  per activation: every activation the desc declares bf16 lies on the bf16
  grid, and the first encoder layer's agree with JAX's to 1 bf16 ulp; the
  float32 step fails both.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.amp import compose_passes as jax_compose_passes
from paddle_tpu.analysis import verifier as jax_verifier
from paddle_tpu.core.desc import ProgramDesc as JaxProgramDesc
from paddle_tpu.core.framework import Block as JaxBlock
from paddle_tpu.models import transformer as jax_transformer
from paddle_tpu.ops.pallas.policy import KernelPolicy as JaxKernelPolicy
from paddle_tpu.passes import PassPipeline as JaxPassPipeline
from paddle_tpu_torch.amp import compose_passes
from paddle_tpu_torch.core.desc import BlockDesc, grad_var_name
from paddle_tpu_torch.models import transformer as pt_transformer
from paddle_tpu_torch.passes import KernelPolicy, PassPipeline

from _torch_validate import _no_port_validate_findings  # noqa: F401

VOCAB, D_MODEL, N_HEAD, D_INNER, T, N_LAYER, BATCH = 1024, 128, 4, 512, 32, 2, 4
LR, STEPS = 1e-3, 3
N_STALE = 19                      # stale reads in JAX's rewrite of this model
# Whole step, port vs the JAX Executor running the same (repaired) desc.
# Both round to bf16 at the ops the desc names, but XLA may keep a fused
# elementwise chain in float32 where torch rounds every op, and the two sum
# in other orders; measured on this model the largest per-parameter
# norm-relative gradient difference is 0.075, as large as the bf16 step's
# own distance from the float32 step (0.066): bf16 noise of a small random
# network.  The stale rewrite is 0.9-1.0 off on the parameters behind a
# merge.  The gate sits between.  It does not separate bf16 from float32:
# the port's float32 step passes it too, because XLA on the CPU keeps fused
# elementwise chains in float32 -- the float32 cast that feeds the first
# layer_norm reads the unrounded residual sum, while the sum JAX fetches is
# bf16 and equal to the port's.  The per-activation test holds the rounding.
GRAD_NREL = 0.2
LOSS_RTOL = 2e-4                  # measured 6.6e-5
# Adam moves a parameter by at most ~lr a step whatever its gradient, so
# two bf16 runs whose gradients differ by bf16 noise end within 2 * lr a
# step of each other.
PARAM_ATOL = 2 * LR * STEPS
KERNELS = ("flash_block_q", "flash_block_k", "flash_min_block_q", "flash_lane",
           "embedding_vmem_bytes", "optimizer_min_numel")


def _jax_default_policy():
    ref = JaxKernelPolicy()
    return KernelPolicy(**{k: getattr(ref, k) for k in KERNELS})


def _scrub(desc_dict):
    for b in desc_dict["blocks"]:
        for o in b["ops"]:
            o["attrs"].pop("callsite", None)
    return desc_dict


def _ops(program):
    return _scrub(program.desc.to_dict())["blocks"][0]["ops"]


def _names(slots):
    return [n for ns in slots.values() for n in ns if n]


def stale_reads(ops):
    """Indices of ops that read a cast's output after the cast's source was
    written again (and before the cast's output was)."""
    out = set()
    for i, c in enumerate(ops):
        if c["type"] != "cast":
            continue
        x, y = c["inputs"]["X"][0], c["outputs"]["Out"][0]
        moved = False
        for k in range(i + 1, len(ops)):
            if moved and y in _names(ops[k]["inputs"]):
                out.add(k)
            if y in _names(ops[k]["outputs"]):
                break
            if x in _names(ops[k]["outputs"]):
                moved = True
    return sorted(out)


def _to_jax(program):
    """The port's desc as a JAX ``Program`` (the io.py idiom)."""
    desc = JaxProgramDesc.from_dict(program.desc.to_dict())
    p = fluid.Program()
    p.desc = desc
    p.blocks = [JaxBlock(p, i) for i in range(desc.num_blocks())]
    p.sync_with_desc()
    return p


def _build_transformer(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = pkg.layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = pkg.layers.data(name="lbl", shape=[T, 1], dtype="int64")
        loss, _ = mod.train_network(src, trg, lbl, VOCAB, VOCAB, max_len=T,
                                    n_layer=N_LAYER, d_model=D_MODEL, n_head=N_HEAD,
                                    d_inner=D_INNER, fuse_final_ce=True)
        pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    return main, startup, loss


def _feed():
    rs = np.random.RandomState(0)
    return {"src": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "trg": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "lbl": rs.randint(1, VOCAB, (BATCH, T, 1)),
            "src@SEQ_LEN": np.array([32, 17, 5, 29], np.int32),
            "trg@SEQ_LEN": np.array([9, 32, 1, 20], np.int32)}


def _nrel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


# ------------------------------------------------------- merge-free models

N, TT, D, V = 4, 8, 128, 1024


def _mlp(pkg):
    """fc -> relu -> layer_norm -> scale -> fused_fc_softmax_ce -> mean (the
    model of tests/test_fused_ce.py with the fp32 and passthrough ops the
    transformer step runs); every activation has one consumer."""
    x = pkg.layers.data(name="x", shape=[N, TT, D], append_batch_size=False,
                        stop_gradient=False)
    lbl = pkg.layers.data(name="lbl", shape=[N, TT, 1], dtype="int64", append_batch_size=False)
    h = pkg.layers.fc(input=x, size=D, num_flatten_dims=2, act="relu")
    n = pkg.layers.layer_norm(h, begin_norm_axis=2)
    s = pkg.layers.scale(n, scale=0.5, bias=0.1)
    loss = pkg.layers.fused_fc_softmax_ce(s, lbl, V, num_flatten_dims=2)
    return pkg.layers.mean(loss), [h, n, s]


def _two_input_fc(pkg):
    """``fc`` over two inputs: two ``mul`` ops and a ``sum`` (blacklist)."""
    a = pkg.layers.data(name="a", shape=[N, D], append_batch_size=False, stop_gradient=False)
    b = pkg.layers.data(name="b", shape=[N, D], append_batch_size=False, stop_gradient=False)
    h = pkg.layers.fc(input=[a, b], size=D, act="relu")
    return pkg.layers.mean(h), [h]


def _attention(pkg):
    """Projections, ``flash_attention`` (4 heads of 32) and the output
    projection on three separate inputs: ``flash_attention_grad`` in bf16."""
    q, k, v = (pkg.layers.data(name=n, shape=[N, TT, D], append_batch_size=False,
                               stop_gradient=False) for n in ("q", "k", "v"))
    out = pkg.layers.multi_head_attention(q, k, v, d_model=D, n_head=4)
    return pkg.layers.mean(out), [out]


def _merge_free_feed(model):
    rs = np.random.RandomState(1)
    if model is _mlp:
        return {"x": rs.randn(N, TT, D).astype(np.float32),
                "lbl": rs.randint(0, V, (N, TT, 1)).astype(np.int64)}
    if model is _attention:
        return {n: rs.randn(N, TT, D).astype(np.float32) for n in ("q", "k", "v")}
    return {"a": rs.randn(N, D).astype(np.float32), "b": rs.randn(N, D).astype(np.float32)}


def _build_small(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        loss, acts = model(pkg)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss, acts


@pytest.mark.parametrize("model", [_mlp, _two_input_fc, _attention])
def test_rewrite_equals_jax_op_for_op_without_gradient_merges(model):
    jm, _, jl, _ = _build_small(fluid, model)
    tm, _, tl, _ = _build_small(pt, model)
    a, _ = JaxPassPipeline(["amp-bf16"], verify="off").run(jm, fetch_list=[jl.name])
    b, res = PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=[tl.name])
    assert stale_reads(_ops(a)) == []
    assert _ops(a) == _ops(b)
    assert _scrub(a.desc.to_dict()) == _scrub(b.desc.to_dict())
    assert a.desc.fingerprint() == b.desc.fingerprint()
    assert b.amp is False and b._amp_policy_fp == pt.amp.AmpPolicy().fingerprint()
    assert b._amp_policy_fp == a._amp_policy_fp
    assert PassPipeline(["amp-bf16"], verify="off").fingerprint() == \
        JaxPassPipeline(["amp-bf16"], verify="off").fingerprint()
    assert res.passes[0].changed and sum(o["type"] == "cast" for o in _ops(b)) > 0


@pytest.mark.parametrize("model", [_mlp, _two_input_fc, _attention])
def test_bf16_op_lowerings_match_jax(model):
    """mul, mul_grad, elementwise_add, relu, layer_norm (float32 behind
    casts), scale, fused_fc_softmax_ce, mean, sum and flash_attention with
    their grads, on
    bf16 operands: the JAX Executor and the port run the same rewritten
    desc from the same parameters.  bf16 activations agree to 1 bf16 ulp
    in all but a few elements (the last float32 bit of a sum, taken in
    another order, can round the other way), and float32 outputs and
    gradients within a bf16 relative error."""
    jm, js, jl, jacts = _build_small(fluid, model)
    tm, ts, tl, tacts = _build_small(pt, model)
    params = [p.name for p in tm.global_block.all_parameters()]
    feeds = list(_merge_free_feed(model))
    fetch = ([tl.name] + [v.name for v in tacts] + [grad_var_name(p) for p in params]
             + [grad_var_name(f) for f in feeds if f != "lbl"])
    b, _ = PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=fetch)
    jscope, jexe = fluid.Scope(), fluid.Executor()
    jexe.run(js, scope=jscope)
    persist = {v.name: np.asarray(jscope.find_var(v.name)) for v in jm.list_vars()
               if v.persistable}
    ref = [np.asarray(r, dtype=np.float32) for r in
           jexe.run(_to_jax(b), feed=_merge_free_feed(model), fetch_list=fetch, scope=jscope)]
    scope = pt.Scope()
    pt.params_from_numpy(persist, scope, "cpu")
    got = pt.Executor(pt.CPUPlace()).run(b, feed=_merge_free_feed(model), fetch_list=fetch,
                                         scope=scope)
    block = b.desc.block(0)
    for name, g, r in zip(fetch, got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape, name
        if block.find_var(name).dtype.value == "bfloat16" and name in [v.name for v in tacts]:
            mag = np.maximum(np.abs(g), np.abs(r))
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
            off = np.abs(g - r) / ulp
            assert (off <= 1).mean() > 0.99 and off.max() <= 4, name
        else:
            assert _nrel(g, r) < 1e-2, (name, _nrel(g, r))


# ----------------------------------------------------- the transformer step


@pytest.fixture(scope="module")
def rewrites():
    jm, js, jl = _build_transformer(fluid, jax_transformer)
    tm, ts, tl = _build_transformer(pt, pt_transformer)
    a, _ = JaxPassPipeline(["amp-bf16"], verify="off").run(jm, fetch_list=[jl.name])
    b, _ = PassPipeline(["amp-bf16"], verify="off").run(tm, fetch_list=[tl.name])
    return dict(jax=(jm, js, jl, a), port=(tm, ts, tl, b))


def _assert_differs_only_at_stale_reads(jax_ops, port_ops):
    """The port's ops are JAX's with one ``cast`` inserted among the casts
    right before some of JAX's stale reads (re-casting the merged value
    under the same name), and no stale read is left."""
    stale = stale_reads(jax_ops)
    assert stale, "JAX's rewrite has no stale read to repair"
    i = j = 0
    fixed = []
    while i < len(jax_ops):
        if j < len(port_ops) and port_ops[j] == jax_ops[i]:
            i += 1
            j += 1
            continue
        extra = port_ops[j]
        reader = i
        while jax_ops[reader]["type"] == "cast":
            reader += 1
        assert extra["type"] == "cast" and reader in stale, (i, jax_ops[reader]["type"], extra)
        assert extra["outputs"]["Out"][0] in _names(jax_ops[reader]["inputs"])
        fixed.append(reader)
        j += 1
    assert j == len(port_ops)
    assert stale_reads(port_ops) == []
    return stale, fixed


def test_transformer_rewrite_differs_from_jax_only_at_the_stale_reads(rewrites):
    a, b = rewrites["jax"][3], rewrites["port"][3]
    stale, fixed = _assert_differs_only_at_stale_reads(_ops(a), _ops(b))
    assert len(stale) == N_STALE
    assert fixed and len(fixed) <= len(stale)
    types = [_ops(a)[k]["type"] for k in stale]
    assert (types.count("sum"), types.count("layer_norm_grad")) == (10, 9)
    da, db = _scrub(a.desc.to_dict()), _scrub(b.desc.to_dict())
    assert da["blocks"][0]["vars"] == db["blocks"][0]["vars"]   # no new var: same cast names


def test_the_repaired_rewrite_adds_no_verifier_finding(rewrites):
    """JAX's verifier on the original program, on JAX's rewrite and on the
    port's (loaded into the JAX package): the port adds no finding; JAX's
    rewrite adds dead ops (merges and cast-backs whose results nobody
    reads, since the readers take the stale cast), which is why its own
    ``verify="error"`` pipeline raises on a transformer."""
    jm, _, jl, a = rewrites["jax"]
    b = rewrites["port"][3]

    def codes(p):
        return sorted((d.code, d.var, d.op_type) for d in
                      jax_verifier.verify(p, fetch_list=[jl.name]).diagnostics)
    base = codes(jm)
    assert codes(_to_jax(b)) == base
    added = [c for c in codes(a) if c not in base]
    assert added and {c[0] for c in added} == {"D204"}
    assert {c[2] for c in added} == {"cast", "sum"}


@pytest.mark.parametrize("order", ["amp_then_kernels", "kernels_then_bridge"])
def test_both_pass_orders_with_the_kernel_tier(rewrites, order):
    """``Executor(amp=AmpConfig(), kernels=...)`` runs amp-bf16 then
    pallas-kernels; ``enable_amp`` with the kernel tier on runs
    pallas-kernels, then the bridge (the JAX package's TPU order).  Each
    equals the JAX package's rewrite in that order but at the stale reads."""
    jm, _, jl, _ = rewrites["jax"]
    tm, _, tl, _ = rewrites["port"]
    if order == "amp_then_kernels":
        # the JAX package's own pipeline verifies with "error" and raises on
        # the stale rewrite's dead ops: the same passes, verification off
        ref = jax_compose_passes(None, fluid.amp.AmpConfig(), kernels=JaxKernelPolicy())
        a, _ = JaxPassPipeline(ref.passes, verify="off").run(jm, fetch_list=[jl.name])
        exe = pt.Executor(pt.CPUPlace(), amp=pt.amp.AmpConfig(), kernels=_jax_default_policy())
        b = exe._apply_passes(tm, list(_feed()), [tl.name])
    else:
        k, _ = jax_compose_passes(None, None, kernels=JaxKernelPolicy()).run(
            jm, fetch_list=[jl.name])
        a, _ = JaxPassPipeline(["amp-bf16"], verify="off").run(k, fetch_list=[jl.name])
        exe = pt.Executor(pt.CPUPlace(), kernels=_jax_default_policy())
        with pt.amp.amp_guard(tm):
            b = exe._apply_passes(tm, list(_feed()), [tl.name])
        assert tm.amp is False
    _assert_differs_only_at_stale_reads(_ops(a), _ops(b))
    types = [o["type"] for o in _ops(b)]
    assert types.count("pallas_scatter_add") == types.count("pallas_gather") == 4
    assert types.count("fused_fc_softmax_ce") == 1
    block = b.desc.block(0)
    fwd = next(o for o in block.ops if o.type == "fused_fc_softmax_ce")
    assert all(block.find_var(fwd.input(s)[0]).dtype.value == "bfloat16" for s in ("X", "W"))
    grad = next(o for o in block.ops if o.type == "fused_fc_softmax_ce_grad")
    assert all(block.find_var(grad.input(s)[0]).dtype.value == "float32"
               for s in ("X", "W", "Bias", "LogSumExp", "LossGrad"))
    scatter = [o for o in block.ops if o.type == "pallas_scatter_add"]
    assert any(block.find_var(o.input("W")[0]).dtype.value == "bfloat16" for o in scatter)
    assert b.amp is False and b._amp_policy_fp and b._kernel_policy_fp


@pytest.fixture(scope="module")
def steps(rewrites):
    """The port's bf16 step (``enable_amp``, ``Executor(CPUPlace())``), the
    JAX Executor on the port's rewritten desc, and on JAX's own rewrite,
    from the same parameters: losses and every parameter gradient; then 3
    steps each (port and JAX on the port's desc), losses and final
    parameters."""
    jm, js, jl, _ = rewrites["jax"]
    tm, ts, tl, _ = rewrites["port"]
    params = [p.name for p in tm.global_block.all_parameters()]
    fetch = [tl.name] + [grad_var_name(p) for p in params]
    jscope, jexe = fluid.Scope(), fluid.Executor()
    jexe.run(js, scope=jscope)
    persist = {v.name: np.asarray(jscope.find_var(v.name)) for v in jm.list_vars()
               if v.persistable}

    def jax_scope():
        s = fluid.Scope()
        for n, a in persist.items():
            s.set_var(n, jnp.asarray(a))
        return s

    pt.amp.enable_amp(tm)
    try:
        tscope, texe = pt.Scope(), pt.Executor(pt.CPUPlace())
        pt.params_from_numpy(persist, tscope, "cpu")
        got = texe.run(tm, feed=_feed(), fetch_list=fetch, scope=tscope)
        rewritten = texe._apply_passes(tm, list(_feed()), fetch)
        acts = _bf16_activations(rewritten, tm)
        stale, _ = JaxPassPipeline(["amp-bf16"], verify="off").run(jm, fetch_list=fetch)
        outs = {}
        for key, prog, names in (("ref", _to_jax(rewritten), fetch + acts),
                                 ("stale", stale, fetch)):
            outs[key] = [np.asarray(a, dtype=np.float32) for a in
                         jexe.run(prog, feed=_feed(), fetch_list=names, scope=jax_scope())]
        losses = [(float(outs["ref"][0]), float(got[0]))]
        loss_prog = _to_jax(texe._apply_passes(tm, list(_feed()), [tl.name]))
        js2 = jax_scope()
        jexe.run(_to_jax(rewritten), feed=_feed(), fetch_list=fetch, scope=js2)
        for _ in range(STEPS - 1):
            (x,) = jexe.run(loss_prog, feed=_feed(), fetch_list=[tl.name], scope=js2)
            (y,) = texe.run(tm, feed=_feed(), fetch_list=[tl.name], scope=tscope)
            losses.append((float(np.asarray(x)), float(y)))
    finally:
        pt.amp.disable_amp(tm)
    final = {n: (np.asarray(js2.find_var(n)), tscope.find_var(n).numpy()) for n in params}
    # the rewritten desc run as it is, and the float32 step (the control),
    # each from the same parameters, fetching the bf16 activations too
    runs = {}
    for key, prog in (("port", rewritten), ("fp32", tm)):
        scope = pt.Scope()
        pt.params_from_numpy(persist, scope, "cpu")
        runs[key] = pt.Executor(pt.CPUPlace()).run(prog, feed=_feed(), fetch_list=fetch + acts,
                                                   scope=scope)
    k = len(fetch)
    return dict(fetch=fetch, got=got, ref=outs["ref"][:k], stale=outs["stale"], losses=losses,
                final=final, stale_prog=stale, params=params, acts=acts,
                early=_before_first_layer_norm(rewritten, acts), ref_acts=outs["ref"][k:],
                port_run=runs["port"][:k], port_acts=runs["port"][k:], fp32=runs["fp32"][:k],
                fp32_acts=runs["fp32"][k:])


def _bf16_activations(rewritten, fp32_program):
    """The activations (forward and backward) that the rewritten desc
    declares bf16 and the float32 program also holds, in op order."""
    block, names = rewritten.global_block, []
    twins = {v.name for v in fp32_program.list_vars()}
    for op in rewritten.desc.block(0).ops:
        for n in op.output_names():
            if n and n in twins and n not in names and not block.var(n).persistable \
                    and block.var(n).dtype.value == "bfloat16":
                names.append(n)
    return names


def _before_first_layer_norm(rewritten, acts):
    """Those of ``acts`` written before the first layer_norm op: the first
    encoder layer's projections, attention and residual add."""
    ops = rewritten.desc.block(0).ops
    first = next(i for i, o in enumerate(ops) if o.type == "layer_norm")
    early = {n for o in ops[:first] for n in o.output_names()}
    return [n for n in acts if n in early]


def _bf16_ulps(got, ref):
    """|got - ref| in bf16 ulps at ref's magnitude."""
    mag = np.abs(ref.astype(np.float64))
    return np.abs(got.astype(np.float64) - ref) / 2.0 ** (
        np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)


def _on_bf16_grid(a):
    return np.array_equal(torch.from_numpy(a).to(torch.bfloat16).float().numpy(), a)


def test_bf16_activations_round_where_the_desc_says(steps):
    """The per-activation check that the whole-step gates cannot make (see
    GRAD_NREL): every activation the desc declares bf16 comes out of the
    port on the bf16 grid, as out of the JAX Executor, and the first
    encoder layer's (before the first layer_norm, where XLA's float32
    chains start) agree with JAX's to 1 bf16 ulp in all but a few elements
    (measured: bit-equal but one element at 1 ulp).  The float32 step is the
    control: off the grid in every one of them, and more than a tenth of
    the first layer's elements more than 1 ulp from JAX's -- while it
    passes the whole-step loss and gradient gates, which this checks too."""
    acts, early = steps["acts"], steps["early"]
    assert len(acts) >= 100 and len(early) >= 5
    for got, want in zip(steps["port_run"], steps["got"]):
        np.testing.assert_array_equal(got, want)   # the rewritten desc run as it is
    idx = {n: i for i, n in enumerate(acts)}
    for name in acts:
        port, ref, fp32 = (steps[k][idx[name]] for k in ("port_acts", "ref_acts", "fp32_acts"))
        assert _on_bf16_grid(port) and _on_bf16_grid(ref), name
        assert not _on_bf16_grid(fp32), name
    for name in early:
        port, ref, fp32 = (steps[k][idx[name]] for k in ("port_acts", "ref_acts", "fp32_acts"))
        off, ctl = _bf16_ulps(port, ref), _bf16_ulps(fp32, ref)
        assert (off <= 1).mean() > 0.99 and off.max() <= 4, (name, (off <= 1).mean())
        assert (ctl <= 1).mean() < 0.9, (name, (ctl <= 1).mean())
    fp32, ref = steps["fp32"], steps["ref"]
    np.testing.assert_allclose(fp32[0], ref[0], rtol=LOSS_RTOL, atol=0)
    assert max(_nrel(g, r) for g, r in zip(fp32[1:], ref[1:])) <= GRAD_NREL


def test_bf16_step_loss_and_every_gradient_match_the_jax_executor(steps):
    fetch, got, ref = steps["fetch"], steps["got"], steps["ref"]
    assert len(fetch) == 67
    np.testing.assert_allclose(got[0], ref[0], rtol=LOSS_RTOL, atol=0)
    for name, g, r in zip(fetch[1:], got[1:], ref[1:]):
        assert g.dtype == np.float32 and g.shape == r.shape and np.isfinite(g).all(), name
        assert np.abs(r).max() > 0, name
        assert _nrel(g, r) <= GRAD_NREL, (name, _nrel(g, r))


def test_three_bf16_steps_match_and_fall(steps):
    ref, got = zip(*steps["losses"])
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=0)
    assert got[0] > got[1] > got[2]
    for name, (r, g) in steps["final"].items():
        assert g.dtype == np.float32 and np.abs(g - r).max() <= PARAM_ATOL, name


def test_control_the_stale_rewrite_fails_the_gradient_gate(steps):
    """JAX's own rewrite drops contributions at its stale reads: the
    layer_norm parameters whose grad op reads a stale merged cotangent fail
    the gate that the port passes."""
    ops = _ops(steps["stale_prog"])
    behind = sorted({n for k in stale_reads(ops) if ops[k]["type"] == "layer_norm_grad"
                     for slot in ("Scale@GRAD_SLOT", "Bias@GRAD_SLOT")
                     for n in ops[k]["outputs"].get(slot, []) if n})
    assert len(behind) >= 8
    idx = {n: i for i, n in enumerate(steps["fetch"])}
    for name in behind:
        err = _nrel(steps["stale"][idx[name]], steps["ref"][idx[name]])
        assert err > GRAD_NREL, (name, err)


# ------------------------------------------------------------- edge cases


def test_amp_config_bf16_composes_the_jax_pipeline():
    p = compose_passes(None, pt.amp.AmpConfig(), kernels=_jax_default_policy())
    ref = jax_compose_passes(None, fluid.amp.AmpConfig(), kernels=JaxKernelPolicy())
    assert [x.name for x in p.passes] == [x.name for x in ref.passes] == \
        ["amp-bf16", "pallas-kernels"]
    assert p.fingerprint() == ref.fingerprint()
    both = compose_passes(None, pt.amp.AmpConfig(quant=True), kernels=None)
    assert [x.name for x in both.passes] == ["amp-quant-int8", "amp-bf16"]
    assert [x.name for x in pt.Executor(pt.CPUPlace(), amp=True).passes.passes] == ["amp-bf16"]


def test_enable_disable_and_guard_set_and_restore_the_flag():
    main = pt.Program()
    assert main.amp is False and pt.amp.enable_amp(main) is main and main.amp is True
    assert main.clone().amp is True
    pt.amp.disable_amp(main)
    assert main.amp is False
    with pt.amp.amp_guard(main) as p:
        assert p is main and main.amp is True
        with pt.amp.amp_guard(main, enable=False):
            assert main.amp is False
        assert main.amp is True
    assert main.amp is False
    assert pt.amp.white_list() == fluid.amp.white_list()
    assert pt.amp.black_list() == fluid.amp.black_list()


def test_setting_the_flag_after_a_float32_run_takes_effect():
    """The executor's pass memo keys on the flag: ``enable_amp`` does not
    move the program's version, and a run after it must be the bf16 one."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[8])
        out = pt.layers.fc(input=x, size=4)
    feed = {"x": np.random.RandomState(3).randn(2, 8).astype(np.float32)}
    for kernels in (False, True):
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace(), kernels=kernels)
        exe.run(startup, scope=scope)
        (a,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        with pt.amp.amp_guard(main):
            assert "cast" in [o.type for o in exe._apply_passes(main, list(feed), [out.name])
                              .desc.block(0).ops]
            (b,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        (c,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        assert np.array_equal(a, c) and not np.array_equal(a, b)
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=2e-2)


def test_a_flagged_multi_block_program_raises_instead_of_running_in_float32():
    """A flagged program of several blocks, which the amp-bf16 pass skips,
    raised here while the port had no lowering-time cast path.  Now it
    runs with the lowering-time casts, as the JAX package runs it, and
    still not in float32: the fc's mul reads bf16 operands, its bias add
    promotes to float32, and mean reads float32."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[4])
        out = pt.layers.mean(pt.layers.fc(input=x, size=2))
    main.desc.blocks.append(BlockDesc(main.desc, 1, 0))
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(5).randn(2, 4).astype(np.float32)}
    pt.amp.enable_amp(main)
    (b,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert exe._apply_passes(main, ["x"], [out.name]) is main and main.amp
    pt.amp.disable_amp(main)
    (v,) = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    assert v.dtype == np.float32 and b.dtype == np.float32
    w, bias = (scope.find_var(p.name) for p in main.global_block.all_parameters())
    xb = torch.from_numpy(feed["x"]).bfloat16()
    want = ((xb @ w.bfloat16()).float() + bias).mean()
    assert float(b) == float(want) and float(b) != float(v)


def test_a_bf16_fetch_comes_back_as_float32_exactly():
    """numpy has no bfloat16: a fetched bf16 value is widened to float32,
    which every bf16 value is exactly; a float32 feed into a bf16 var is
    rounded to bf16 (to nearest even, as the JAX package rounds)."""
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data(name="x", shape=[3], dtype="bfloat16")
        y = pt.layers.scale(x, scale=3.0)
    vals = np.array([[1.0, 1.0 + 2 ** -8, -3.1]], np.float32)
    exe = pt.Executor(pt.CPUPlace())
    (a, b), (h,) = (exe.run(main, feed={"x": vals}, fetch_list=[x, y]),
                    exe.run(main, feed={"x": vals}, fetch_list=[y], sync=False))
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))
    assert a.dtype == b.dtype == h.numpy().dtype == np.float32
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(
        b, np.asarray((jnp.asarray(want).astype(jnp.bfloat16) * 3).astype(jnp.float32)))
    np.testing.assert_array_equal(h.numpy(), b)
    t = torch.from_numpy(b).to(torch.bfloat16)
    assert torch.equal(t.float(), torch.from_numpy(b))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_cast_op_matches_jax(out_dtype):
    vals = np.random.RandomState(2).randn(4, 5).astype(np.float32) * 100
    res = []
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.layers.data(name="x", shape=[5])
            out = main.global_block.create_var(name="y", shape=(-1, 5), dtype=out_dtype)
            main.global_block.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                                        attrs={"in_dtype": "float32", "out_dtype": out_dtype})
        exe = pkg.Executor(pkg.CPUPlace())
        assert out.dtype.value == out_dtype
        res.append(np.asarray(exe.run(main, feed={"x": vals}, fetch_list=[out])[0],
                              dtype=np.float32))
    np.testing.assert_array_equal(res[1], res[0])
