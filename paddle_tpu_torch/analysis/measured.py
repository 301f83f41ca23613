"""The memory plan beside the peak the card measures.

``prepare`` verifies the program an executor runs for ``program`` (its
passes, kernel tier and amp bridge applied) and plans its memory at the
feed's shapes; ``measure`` completes that record with the peak an eager
run of the program reaches on a CUDA device:

    rec = measured.prepare("eval", exe, program, feed, [loss], scope)
    out = measured.measure(rec, scope, feed,
                           lambda: exe._run_eager(program, feed, [loss], scope))
    assert PLAN_BAND[0] <= rec["ratio"] <= PLAN_BAND[1]

The plan models XLA's buffer liveness, which ``core/lower.py``
``plan_frees`` follows.  An eager run on the card also holds what the plan
cannot see: a generic grad's forward re-run under autograd, a lowering's
temporaries, cuBLAS and cuDNN workspaces, the allocator's rounding.
``PLAN_BAND`` is the predicted / measured ratio a main path may read;
PERF.md states the runs on the card behind it.  A ratio under 0.5 or over
2 is a planner fault, not a reason to widen the band.
"""
import time

PLAN_BAND = (0.6, 1.05)


def prepare(key, exe, program, feed, fetch_names, scope):
    """``analysis.verify`` (no error allowed; its counts by code and host
    seconds, which is what ``validate="error"`` adds to the program's first
    capture) and ``analysis.plan_memory`` of the program ``exe`` runs for
    ``program`` at ``feed``'s shapes.  Returns the record ``measure``
    completes; ``key`` names the program in an error."""
    import numpy as np
    from . import plan_memory, verify
    shapes = {k: tuple(int(d) for d in np.shape(v)) for k, v in feed.items()}
    ran = exe._apply_passes(program, list(feed), list(fetch_names), scope, shapes)
    t0 = time.perf_counter()
    res = verify(ran, fetch_list=list(fetch_names))
    verify_s = time.perf_counter() - t0
    if res.errors:
        raise AssertionError(f"{key}: the verifier found errors:\n{res.format()}")
    codes = {}
    for d in res.diagnostics:
        codes[d.code] = codes.get(d.code, 0) + 1
    plan = plan_memory(ran, fetch_list=list(fetch_names), feed_shapes=shapes)
    blk = ran.desc.block(0)
    return {"ops": res.num_ops, "counts": res.counts(), "codes": codes, "verify_s": verify_s,
            "plan_bytes": plan.peak_bytes, "plan_persistent_bytes": plan.persistent_bytes,
            "plan_peak_op": [plan.peak_op_index, plan.peak_op_type],
            "unsized": len(plan.unsized),
            "state_names": sorted({n for op in blk.ops
                                   for n in op.input_names() + op.output_names()
                                   if n and (v := blk.find_var(n)) is not None
                                   and v.persistable})}


def measure(rec, scope, feed, run):
    """Run ``run`` (an eager run of ``rec``'s program) and record its
    measured peak: the bytes of the scope's state the program's ops read or
    write and of the feeds already on the card, plus
    ``torch.cuda.max_memory_allocated`` over the run less the bytes
    allocated before it.  Returns what ``run`` returns."""
    import torch
    names = rec.pop("state_names")
    tensors = [scope.find_var(n) for n in names]
    resident = sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor) and t.is_cuda)
    resident += sum(v.numel() * v.element_size() for v in feed.values()
                    if isinstance(v, torch.Tensor) and v.is_cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before
    rec.update(resident_bytes=resident, transient_bytes=transient,
               measured_bytes=resident + transient)
    rec["ratio"] = rec["plan_bytes"] / rec["measured_bytes"]
    return out
