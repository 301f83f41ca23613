"""The port's continuous-batching ``DecodeEngine`` on the CPU against the
JAX package.

No JAX ``DecodeEngine`` is built with ``warmup=True`` (each would compile
20+ XLA executables): the JAX side is the decode models' one-shot
``reference_func`` programs (the whole decode loop unrolled in one
program), or, for ``attention_lm``, which has none, its prefill and step
programs run request by request at one bucket, all from the JAX
package's parameters, which the port's engines load with ``param_path``.

* the three families' engine tokens, from ragged clients joining
  mid-generation, equal the JAX programs' token for token, and
  ``n_iterations == n_tokens - 1`` for every request (a request whose
  prefill token is EOS retires at prefill with no iteration; the JAX
  ``tests/test_decode.py::test_gru_concurrent_parity_vs_oneshot`` asserts
  ``>= 1`` there, which the engine, port and reference alike, does not
  promise);
* typed errors, an expired deadline, a closed engine;
* ``PredictedOOMError`` before any warmup, and a tight budget's shrunk
  pool whose ``memory_plan`` equals the JAX engine's (built with
  ``warmup=False``), the pool's bytes equal to the JAX pool's;
* the ``kv_cache_slots`` stamp: R401 fires without it and not with it,
  and the fingerprint does not move;
* zero fresh compiles through churn, and a freed slot zeroed on its
  device arena.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.serving import decode_models as jzoo
from paddle_tpu_torch import analysis, layers
from paddle_tpu_torch.analysis.memory import PredictedOOMError
from paddle_tpu_torch.core import unique_name
from paddle_tpu_torch.core.desc import NONSEMANTIC_VAR_ATTRS
from paddle_tpu_torch.serving import (DecodeEngine, RequestTimeout, ServingClosed,
                                      ServingError, seq_len_buckets)
from paddle_tpu_torch.serving import decode_models as zoo
from paddle_tpu_torch.serving.decode import KV_CACHE_ATTR, _SlotPool

from _torch_validate import _no_port_validate_findings  # noqa: F401

EOS = 0
GEN = 5
CPU = pt.CPUPlace()


def _jax_params(tmp_path, build, seed, name):
    """Run the JAX startup of ``build()``'s program from ``seed`` and save
    its persistables; returns (dir, JAX executor, main, fetch, scope)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            out = build()
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    startup.random_seed = seed
    exe.run(startup, scope=scope)
    d = str(tmp_path / name)
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, d, main)
    return d, exe, main, out, scope


def _oneshot(exe, main, toks_v, scope, prompt, max_len):
    ids = np.full((1, max_len), EOS, np.int64)
    ids[0, :len(prompt)] = prompt
    lens = np.array([[len(prompt)]], np.int32)
    (t,) = exe.run(main, feed={"ids": ids, "lens": lens}, fetch_list=[toks_v], scope=scope)
    return np.asarray(t)[0]


def _cut_at_eos(toks):
    """Tokens through the first whole-row EOS (a beam row ends when every
    lane is EOS, as the engine retires it)."""
    toks = np.asarray(toks)
    for i in range(len(toks)):
        if np.all(toks[i] == EOS):
            return toks[:i + 1]
    return toks


def _concurrent(eng, prompts, gen, stagger=0.02):
    """Ragged clients joining mid-generation: staggered starts force joins
    and retirements while other requests decode."""
    results, errors = {}, []

    def client(i):
        try:
            time.sleep(stagger * (i % 4))
            results[i] = eng.generate(prompts[i], max_new_tokens=gen, timeout=60.0)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    return results


def _assert_iterations(results):
    for r in results.values():
        assert r.n_iterations == r.n_tokens - 1, (r.n_iterations, r.n_tokens)
        assert r.reason in ("eos", "max_tokens") and r.ttft_s >= 0.0


@pytest.fixture(scope="module")
def gru(tmp_path_factory):
    """(port engine, JAX one-shot runner) for the greedy GRU LM."""
    _, _, jref = jzoo.gru_lm()
    d, exe, main, ((_i, _l), toks_v), scope = _jax_params(
        tmp_path_factory.mktemp("gru"), lambda: jref(8, GEN), 11, "gru")
    pre, step, _ = zoo.gru_lm()
    eng = DecodeEngine(pre, step, eos_id=EOS, max_seq_len=16, max_batch_size=4,
                       param_path=d, max_new_tokens_default=GEN, name="gru", place=CPU)

    def oneshot(prompt):
        return _cut_at_eos(_oneshot(exe, main, toks_v, scope, prompt, 8))

    yield eng, oneshot
    eng.close(drain=False)


def test_gru_concurrent_tokens_equal_the_jax_oneshot(gru):
    eng, oneshot = gru
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, zoo.VOCAB, size=n) for n in (3, 5, 7, 4, 6, 2, 8, 3)]
    results = _concurrent(eng, prompts, GEN)
    for i, p in enumerate(prompts):
        want = oneshot(p)
        got = np.asarray(results[i].tokens).ravel()
        assert np.array_equal(got, want[:len(got)]), (i, got.tolist(), want.tolist())
        assert len(got) == len(want)
    _assert_iterations(results)
    assert eng.fresh_compiles_since_warmup == 0


def test_gru_solo_equals_concurrent(gru):
    eng, _ = gru
    rs = np.random.RandomState(17)
    prompts = [rs.randint(1, zoo.VOCAB, size=n) for n in (4, 6, 3, 7)]
    solo = [np.asarray(eng.generate(p, max_new_tokens=GEN, timeout=60.0).tokens)
            for p in prompts]
    results = _concurrent(eng, prompts, GEN)
    for i in range(len(prompts)):
        assert np.array_equal(np.asarray(results[i].tokens), solo[i])


def test_gru_eos_at_prefill_retires_with_no_iteration(gru):
    """A prompt whose first generated token is EOS retires at prefill:
    one token, no decode iteration (the reference's engine too,
    ``paddle_tpu/serving/decode.py:704-705``)."""
    eng, oneshot = gru
    rs = np.random.RandomState(0)
    for _ in range(400):
        p = rs.randint(1, zoo.VOCAB, size=int(rs.randint(1, 9)))
        if oneshot(p)[0] == EOS:
            break
    else:
        pytest.fail("no prompt of 400 makes EOS the first token")
    r = eng.generate(p, max_new_tokens=GEN, timeout=60.0)
    assert r.reason == "eos" and r.n_tokens == 1 and r.n_iterations == 0


def test_typed_errors_and_limits(gru):
    eng, _ = gru
    with pytest.raises(ValueError):
        eng.generate([], max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.generate([1, 2], max_new_tokens=0)
    # prompt + max_new over the horizon is a typed reject, not a truncation
    with pytest.raises(ServingError):
        eng.generate(list(range(1, 15)), max_new_tokens=10)
    # an already-expired deadline retires typed, never a silent hang (in
    # the queue, or at the next iteration when the scheduler prefilled it
    # first: the reference's race too)
    with pytest.raises(RequestTimeout) as ei:
        eng.generate([1, 2, 3], max_new_tokens=2, timeout=-1.0)
    assert ei.value.where in ("queue", "decode")


def test_closed_engine_rejects():
    pre, step, _ = zoo.gru_lm()
    eng = DecodeEngine(pre, step, eos_id=EOS, max_seq_len=8, max_batch_size=1, seed=11,
                       warmup=False, name="closing", place=CPU)
    eng.close(drain=True)
    with pytest.raises(ServingClosed):
        eng.submit([1, 2], max_new_tokens=2)


def test_attention_tokens_equal_the_jax_programs_run_solo(tmp_path):
    """The paged-cache family: the JAX prefill program at the prompt's
    bucket, then its step program over a cache zero-padded to the slot's
    capacity, one token at a time, at one bucket (8: every prompt plus its
    tokens fits); the engine serves the same prompts concurrently through
    pooled slots (its prefill runs the causal flash attention's plain
    version on the CPU)."""
    jpre, jstep, _ = jzoo.attention_lm()
    d, jexe, jstep_prog, ((tok_v, pos_v, st_vs), (nxt_v, st_out)), jscope = _jax_params(
        tmp_path, jstep, 5, "attn")
    t = cap = 8
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        (ids_v, lens_v), (tok0_v, st0_vs) = jpre(t)

    def jax_solo(prompt, gen):
        n = len(prompt)
        assert n + gen <= cap
        ids = np.full((1, t), EOS, np.int64)
        ids[0, :n] = prompt
        tok0, k, v = jexe.run(main, feed={"ids": ids, "lens": np.array([[n]], np.int32)},
                              fetch_list=[tok0_v] + st0_vs, scope=jscope)
        caches = []
        for c in (k, v):
            z = np.zeros((1, cap, zoo.HID), np.float32)
            z[:, :t] = c
            caches.append(z)
        toks, tok, pos = [int(tok0[0])], int(tok0[0]), n
        while tok != EOS and len(toks) < gen:
            nxt, kc, vc = jexe.run(jstep_prog, feed={
                tok_v.name: np.array([[tok]], np.int64), pos_v.name: np.array([[pos]], np.int32),
                st_vs[0].name: caches[0], st_vs[1].name: caches[1]},
                fetch_list=[nxt_v] + st_out, scope=jscope)
            tok, pos, caches = int(nxt[0]), pos + 1, [kc, vc]
            toks.append(tok)
        return np.asarray(toks)

    pre, step, _ = zoo.attention_lm()
    eng = DecodeEngine(pre, step, eos_id=EOS, max_seq_len=16, max_batch_size=2,
                       param_path=d, max_new_tokens_default=GEN, name="attn", place=CPU)
    try:
        assert tuple(eng.seq_buckets) == tuple(seq_len_buckets(16))
        rs = np.random.RandomState(9)
        prompts = [rs.randint(1, zoo.VOCAB, size=n) for n in (3, 1, 2, 3, 2)]
        results = _concurrent(eng, prompts, GEN)
        for i, p in enumerate(prompts):
            want = jax_solo(p, GEN)
            got = np.asarray(results[i].tokens)
            assert np.array_equal(got, want), (i, got.tolist(), want.tolist())
        _assert_iterations(results)
        st = eng.stats()
        assert st["fresh_compiles_since_warmup"] == 0 and st["executables_warmed"] > 0
        assert all(u == 0 for u, _t in eng._pool.counts().values())
        # the step program's dynamic cache axis is stamped: R401 stays quiet
        feed_names = [eng._tok_in.name, eng._pos_in.name] + [s.name for s in eng._specs]
        res = analysis.verify(eng._step_prog, fetch_list=eng._step_fetch, feed_names=feed_names)
        assert res.by_code("R401") == []
    finally:
        eng.close(drain=False)


def test_beam_tokens_equal_the_jax_oneshot(tmp_path):
    """Dense-lane beam search through the engine equals the JAX one-shot
    beam program, lane for lane."""
    gen = 4
    _, _, jref = jzoo.beam_gru_lm()
    d, jexe, main, ((_i, _l), toks_v), scope = _jax_params(
        tmp_path, lambda: jref(8, gen), 13, "beam")
    pre, step, _ = zoo.beam_gru_lm()
    eng = DecodeEngine(pre, step, eos_id=EOS, max_seq_len=8, max_batch_size=2,
                       param_path=d, max_new_tokens_default=gen, name="beam", place=CPU)
    try:
        rs = np.random.RandomState(4)
        prompts = [rs.randint(1, zoo.VOCAB, size=n) for n in (3, 2, 4)]
        results = _concurrent(eng, prompts, gen)
        for i, p in enumerate(prompts):
            want = _oneshot(jexe, main, toks_v, scope, p, 8)    # [gen, BEAM]
            got = np.asarray(results[i].tokens)                 # [n, BEAM]
            assert got.shape[1] == zoo.BEAM and got.dtype == np.int64
            assert np.array_equal(got, want[:len(got)])
        _assert_iterations(results)
        assert eng.fresh_compiles_since_warmup == 0
    finally:
        eng.close(drain=False)


# ------------------------------------------------------------ the pool


def test_memory_budget_predicts_oom_before_warmup():
    pre, step, _ = zoo.gru_lm()
    with pytest.raises(PredictedOOMError) as ei:
        DecodeEngine(pre, step, eos_id=EOS, max_seq_len=16, max_batch_size=2, seed=11,
                     memory_budget=64, warmup=False, name="oom", place=CPU)
    assert ei.value.diagnostic.code == "M501"


@pytest.mark.parametrize("family", ["gru_lm", "attention_lm", "beam_gru_lm"])
def test_shrunk_pool_plan_equals_the_jax_engines(family):
    """A tight-but-feasible budget shrinks the slots, not fails; the plan
    (pool bytes, dispatch peak, slots, bytes a slot) equals the JAX
    engine's for the same model and budget."""
    jpre, jstep, _ = getattr(jzoo, family)()
    pre, step, _ = getattr(zoo, family)()
    kw = dict(eos_id=EOS, max_seq_len=16, max_batch_size=4, seed=11, warmup=False)
    roomy = DecodeEngine(pre, step, name="roomy", place=CPU, **kw)
    full = roomy.memory_plan
    assert roomy._pool.total_bytes() == full["pool_bytes"] == sum(
        n * full["bytes_per_slot"][c] for c, n in full["slots"].items())
    roomy.close(drain=False)
    budget = full["pool_bytes"] + full["dispatch_peak_bytes"] - 1
    jtight = JaxDecodeEngine(jpre, jstep, memory_budget=budget, name="tight", **kw)
    tight = DecodeEngine(pre, step, memory_budget=budget, name="tight", place=CPU, **kw)
    try:
        plan = tight.memory_plan
        assert plan == jtight.memory_plan
        assert tight._pool.total_bytes() == jtight._pool.total_bytes()
        assert plan["pool_bytes"] + plan["dispatch_peak_bytes"] <= budget
        assert sum(plan["slots"].values()) < sum(full["slots"].values())
        assert all(n >= 1 for n in plan["slots"].values())
    finally:
        tight.close(drain=False)
        jtight.close(drain=False)


def test_a_freed_slot_is_zeroed_on_its_arena():
    from paddle_tpu_torch.serving.decode import _StateSpec
    specs = [_StateSpec("k", (-1, 3), "float32", 0), _StateSpec("h", (4,), "float32", None)]
    pool = _SlotPool({8: 2, 16: 1}, specs)
    pool.materialize()
    assert pool.total_bytes() == 2 * (8 * 3 * 4 + 16) + (16 * 3 * 4 + 16)
    slot = pool.alloc(5)
    assert slot == (8, 0)
    pool.write(slot, 0, torch.ones(4, 3))           # a prompt bucket of 4 rows
    pool.write(slot, 1, torch.full((4,), 2.0))
    k = pool.gather(8, [slot[1]], 0, pad_to=2)
    assert k.shape == (2, 8, 3) and k[0, :4].eq(1).all() and k[0, 4:].eq(0).all()
    assert k[1].eq(0).all()                          # the padded row
    pool.scatter(8, [slot[1]], 1, torch.full((2, 4), 3.0))
    assert pool.gather(8, [slot[1]], 1, pad_to=1).eq(3).all()
    pool.free(slot)
    assert pool.gather(8, [0], 0, pad_to=1).eq(0).all()
    assert pool.gather(8, [0], 1, pad_to=1).eq(0).all()
    assert pool.alloc(9) == (16, 0) and pool.alloc(9) is None and pool.alloc(3) == (8, 0)


def test_churn_pays_no_fresh_compile_and_frees_every_slot():
    pre, step, _ = zoo.gru_lm()
    eng = DecodeEngine(pre, step, eos_id=EOS, max_seq_len=16, max_batch_size=4, seed=11,
                       name="churn", place=CPU)
    try:
        rs = np.random.RandomState(21)
        prompts = [rs.randint(1, zoo.VOCAB, size=int(rs.randint(1, 11))) for _ in range(14)]
        gens = [int(rs.randint(1, 6)) for _ in prompts]
        results, errors = {}, []

        def client(i):
            try:
                results[i] = eng.generate(prompts[i], max_new_tokens=gens[i], timeout=60.0)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not errors
        assert eng.fresh_compiles_since_warmup == 0
        assert eng._pool.in_use() == 0
        st = eng.stats()
        assert st["requests_ok"] >= len(prompts) and st["fresh_compile_breaches"] == 0
        assert len(eng.warmup_reports) == 2 * 2 + 2 * 3   # prefill 1,2 / decode 1,2,4 x 8,16
    finally:
        eng.close(drain=False)


# --------------------------------------------------------------- R401


def test_kv_cache_stamp_semantics_and_fingerprint():
    """An unstamped dynamic cache feed fires R401; the ``kv_cache_slots``
    stamp discharges it without moving the fingerprint (non-semantic)."""
    assert KV_CACHE_ATTR in NONSEMANTIC_VAR_ATTRS
    assert "decode_position" in NONSEMANTIC_VAR_ATTRS
    main, startup = pt.Program(), pt.Program()
    with unique_name.guard(), pt.program_guard(main, startup):
        cache = layers.data(name="cache", shape=[-1, 8], dtype="float32")
        loss = layers.mean(layers.reduce_sum(cache, dim=-1))
    res = analysis.verify(main, fetch_list=[loss], feed_names=["cache"])
    assert "R401" in {d.code for d in res.infos}
    vd = main.desc.block(0).find_var("cache")
    fp = main.desc.fingerprint()
    vd.attrs[KV_CACHE_ATTR] = "pow2"
    main.desc._bump()
    assert main.desc.fingerprint() == fp
    res = analysis.verify(main, fetch_list=[loss], feed_names=["cache"])
    assert res.by_code("R401") == []


def test_engine_defaults_to_the_card():
    import inspect
    assert inspect.signature(DecodeEngine).parameters["place"].default is None
    if not torch.cuda.is_available():
        pre, step, _ = zoo.gru_lm()
        with pytest.raises(RuntimeError):
            DecodeEngine(pre, step, eos_id=EOS, max_seq_len=8, max_batch_size=1,
                         warmup=False, name="card")
