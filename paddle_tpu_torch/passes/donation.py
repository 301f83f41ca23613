"""Donation insertion: act on the memory planner's M503 findings (the JAX
package's ``donation-insert`` pass).

M503 ("feed buffer is dead after op#k but held through the peak") is an
info diagnostic of ``analysis/memory.py``.  This pass re-runs
``plan_memory`` over the program being rewritten and stamps the
``donate`` var attr (``analysis.memory.DONATE_ATTR``) on every feed the
M503 findings name.  Downstream:

* ``plan_memory`` ends a stamped feed's live range at its last use, so the
  re-planned peak drops and the M503 findings go;
* the Executor runs a stamped program as ``run(donate_feeds=True)``.  On
  the card that means: a staged batch is handed to the step without the
  stager's reuse cache keeping it (``stage_feeds(reuse=False)``), so an
  eager run drops each feed tensor after its last reader
  (``core/lower.py`` ``plan_frees``) and its memory goes back to the
  allocator during the step.  A CUDA graph copies the feeds into static
  buffers of its own, which live as long as the graph: there donation
  frees only the staged copy, after the replay's copy into the graph.

The stamp is a SEMANTIC attr, so a stamped program fingerprints
differently and is a cache entry of its own; its fetches are bit-equal to
the unstamped program's.
"""
from __future__ import annotations

from .base import PassContext, PassResult, ProgramPass, register_pass


@register_pass
class DonationInsertionPass(ProgramPass):
    name = "donation-insert"

    def apply(self, ctx: PassContext, result: PassResult) -> None:
        from ..analysis import memory as _memory
        block = ctx.desc.block(0)
        plan = _memory.plan_memory(
            ctx.desc, fetch_list=ctx.fetch_names,
            feed_names=ctx.feed_names, feed_shapes=ctx.feed_shapes,
            mesh=ctx.mesh, layout=ctx.layout)
        stamped = []
        for d in _memory.memory_diagnostics(plan):
            if d.code != "M503" or not d.var:
                continue
            vd = block.find_var(d.var)
            if vd is None or vd.attrs.get(_memory.DONATE_ATTR):
                continue
            vd.attrs[_memory.DONATE_ATTR] = True
            stamped.append(d.var)
        if not stamped:
            return
        ctx.desc._bump()
        result.changed = True
        result.donate_vars = stamped
        result.notes.append(
            f"stamped donate on {len(stamped)} feed(s) from M503 "
            f"findings: {', '.join(stamped)} (predicted peak "
            f"{_memory.fmt_bytes(plan.peak_bytes)} before donation)")
