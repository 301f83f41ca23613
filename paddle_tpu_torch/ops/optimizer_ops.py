"""Optimizer update rules as ops.  Each reads Param, Grad and its
accumulators and writes the ``*Out`` vars, which share their inputs'
names: the update is made in place, into the scope's own tensors, as the
JAX package's executor updates donated state.  An output named apart from
its input (no op that ``optimizer.py`` emits has one) gets a clone of the
input, updated in place, so the input keeps its value.

Each family has a group lowering: ``core/lower.py`` hands it every update
of a step at once (``register_group_lowering``).  ``sgd`` / ``pallas_sgd``
and ``adam`` / ``pallas_adam`` call the multi-tensor kernel K5 or K6
(ops/cuda/fused_optimizer.py) once on CUDA tensors, or the plain versions
entry by entry on the CPU.  ``sgd`` and the kernel tier's ``pallas_sgd``
(the ``pallas-kernels`` pass's retype, whose op types are part of the
ProgramDesc) compute the same, ``p - lr * g`` rounded once, as XLA fuses
the JAX package's ``sgd``.  ``adam`` computes the JAX package's composed
``adam`` lowering, ``pallas_adam`` its ``fused_adam``: each entry of a K6
launch says which.

The other rules -- ``momentum`` (Nesterov too), ``lars_momentum``,
``adamax``, ``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``,
``ftrl``, ``proximal_gd`` and ``proximal_adagrad`` -- have no Pallas kernel in the JAX package (XLA computes
them), so here they are PyTorch's multi-tensor ``torch._foreach_*`` ops:
one pass over every tensor of the group a step per operation, each
operation in the order the JAX lowering writes it.  A group shares its
attributes and its learning-rate var (part of the group key).

An op lowered on its own is a group of one.  An update whose gradient is
a SelectedRows (a sparse embedding's) leaves its group: ``sgd`` /
``pallas_sgd``, ``adam`` / ``pallas_adam`` and ``adagrad`` update its
touched rows in place (ops/sparse_ops.py), so a step's K5 or K6 launch
covers its dense parameters only; every other rule raises
``unsupported_sparse``, as in the JAX package.

``average_accumulates`` is ``ModelAverage``'s windowed parameter sum
(optimizer.py): its counters stay int32 tensors and its branches are
device-side selects, so a step's CUDA graph advances them on each replay.
"""
from __future__ import annotations

import torch

from ..core.lower import is_dtensor, local_of
from ..core.registry import register_group_lowering, register_infer_shape, register_lowering
from ..core.selected_rows import SelectedRows, shard_rows
from .common import in_dtype, in_shape, set_out_shape
from .cuda.fused_optimizer import fused_adam_multi, fused_sgd_multi
from .sparse_ops import sparse_adagrad, sparse_adam, sparse_sgd, unsupported_sparse

_ADAM_IN = ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
_ADAM_OUT = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut")


def _sgd_key(op):
    return "sgd"


def _grad_as(g, p):
    """``g`` contiguous in ``p``'s dtype: under the lowering-time bf16
    casts a gradient may come out bf16, and the update promotes it to its
    float32 parameter, as the JAX package's arithmetic does (exactly)."""
    return g.to(p.dtype).contiguous()


def _own(op, slot, out_slot, t):
    """``t`` (the value of ``op``'s input ``slot``) to be updated in place
    into ``out_slot``: ``t`` itself where the output shares the input's
    name, else a clone of it."""
    return t if op.output(out_slot) == op.input(slot) else t.clone()


def _like(value, home):
    """``value`` (a local tensor the kernel wrote) as the value of its slot:
    ``home`` itself where the kernel updated ``home``'s shard in place, a
    DTensor on ``home``'s placements where ``home`` is one, else
    ``value``."""
    if not is_dtensor(home):
        return value
    if value is home.to_local():
        return home
    return type(home).from_local(value, home.device_mesh, home.placements, run_check=False)


def _dense(ctx, ops, sparse_rule):
    """The ops of ``ops`` whose gradient is dense; each other one (a
    SelectedRows gradient) goes to ``sparse_rule(ctx, op, grad)`` now,
    with the rows of the grad that land in this rank's rows of the param
    (:func:`_rank_rows`)."""
    dense = []
    for op in ops:
        g = ctx.read_slot(op, "Grad")
        if isinstance(g, SelectedRows):
            sparse_rule(ctx, op, _rank_rows(ctx, g, ctx.read_slot(op, "Param")))
        else:
            dense.append(op)
    return dense


def _rank_rows(ctx, g, p):
    """The part of the whole batch's sparse gradient ``g`` that updates
    this rank's rows of ``p``: under a mesh that splits p's rows, the
    rows in its shard shifted to local ids (:func:`shard_rows`); else
    ``g`` whole (a replica applies the whole batch's update)."""
    if ctx.mesh is None:
        return g
    from ..parallel.layout import row_shard
    shard = row_shard(p, ctx.mesh)
    return g if shard is None else shard_rows(g, *shard)


def _sgd_sparse(ctx, op, g):
    p = _own(op, "Param", "ParamOut", ctx.read_slot(op, "Param"))
    out = sparse_sgd(local_of(p), g, local_of(ctx.read_slot(op, "LearningRate")))
    ctx.write_slot(op, "ParamOut", _like(out, p))


@register_group_lowering("sgd", "pallas_sgd", key=_sgd_key)
def _sgd_group(ctx, ops):
    entries = []
    ops = _dense(ctx, ops, _sgd_sparse)
    if not ops:
        return
    homes = []
    for op in ops:
        p, g, lr = (ctx.read_slot(op, s) for s in ("Param", "Grad", "LearningRate"))
        p = _own(op, "Param", "ParamOut", p)
        homes.append(p)
        entries.append((local_of(p), local_of(_grad_as(g, p)), local_of(lr)))
    for op, out, p in zip(ops, fused_sgd_multi(entries), homes):
        ctx.write_slot(op, "ParamOut", _like(out, p))


def _adam_attrs(op):
    return op.attr("beta1", 0.9), op.attr("beta2", 0.999), op.attr("epsilon", 1e-8)


def _adam_key(op):
    return ("adam",) + _adam_attrs(op)


def _adam_sparse(ctx, op, g):
    p, _, m1, m2, b1p, b2p, lr = (ctx.read_slot(op, s) for s in _ADAM_IN)
    p, m1, m2 = (_own(op, s, o, t) for s, o, t in
                 zip(("Param", "Moment1", "Moment2"), _ADAM_OUT, (p, m1, m2)))
    outs = sparse_adam(local_of(p), g.astype(p.dtype),
                       *(local_of(t) for t in (m1, m2, b1p, b2p, lr)), *_adam_attrs(op))
    for slot, val, home in zip(_ADAM_OUT, outs, (p, m1, m2, b1p, b2p)):
        ctx.write_slot(op, slot, _like(val, home))


@register_group_lowering("adam", "pallas_adam", key=_adam_key)
def _adam_group(ctx, ops):
    entries = []
    ops = _dense(ctx, ops, _adam_sparse)
    if not ops:
        return
    homes = []
    for op in ops:
        p, g, m1, m2, b1p, b2p, lr = (ctx.read_slot(op, s) for s in _ADAM_IN)
        p, m1, m2 = (_own(op, s, o, t) for s, o, t in
                     zip(("Param", "Moment1", "Moment2"), _ADAM_OUT, (p, m1, m2)))
        homes.append((p, m1, m2, b1p, b2p))
        entries.append(tuple(local_of(t) for t in (p, _grad_as(g, p), m1, m2, b1p, b2p, lr))
                       + (op.type == "pallas_adam",))
    for op, outs, home in zip(ops, fused_adam_multi(entries, *_adam_attrs(ops[0])), homes):
        for slot, val, h in zip(_ADAM_OUT, outs, home):
            ctx.write_slot(op, slot, _like(val, h))


@register_lowering("pallas_sgd", no_gradient=True)
@register_lowering("sgd", no_gradient=True)
def _sgd(ctx, op):
    _sgd_group(ctx, [op])


@register_lowering("pallas_adam", no_gradient=True)
@register_lowering("adam", no_gradient=True)
def _adam(ctx, op):
    _adam_group(ctx, [op])


# ------------------------------------------------- the foreach families

def _family(op_type, state, attrs, reads=()):
    """Register ``op_type``'s lowering and group lowering around
    ``rule(lr, ps, gs, slots, extra, at)``, which updates the list ``ps``
    and the lists ``slots[i]`` (the tensors of the state slot ``state[i]``,
    a name whose output is ``<name>Out``, or an (input, output) pair) in
    place.  ``lr`` is the group's one learning rate as a 0-d tensor (None
    for a rule without one), ``extra`` the lists of the read-only slots
    ``reads``, ``at`` the attrs.  The group key is the op type, the values
    of ``attrs`` and the LearningRate var."""
    def key(op):
        return (op_type,) + tuple(op.attr(a) for a in attrs) + tuple(op.input("LearningRate"))

    state = [(s, s + "Out") if isinstance(s, str) else s for s in state]

    def sparse(ctx, op, g):
        if op_type != "adagrad":
            unsupported_sparse(op_type)
        p, mom = (_own(op, s, s + "Out", ctx.read_slot(op, s)) for s in ("Param", "Moment"))
        new_p, new_mom = sparse_adagrad(local_of(p), g.astype(p.dtype), local_of(mom),
                                        local_of(ctx.read_slot(op, "LearningRate")),
                                        op.attr("epsilon", 1e-6))
        ctx.write_slot(op, "ParamOut", _like(new_p, p))
        ctx.write_slot(op, "MomentOut", _like(new_mom, mom))

    def deco(rule):
        @register_group_lowering(op_type, key=key)
        def group(ctx, ops):
            ops = _dense(ctx, ops, sparse)
            if not ops:
                return
            lr = ctx.read_slot(ops[0], "LearningRate")
            ps = [_own(op, "Param", "ParamOut", ctx.read_slot(op, "Param")) for op in ops]
            gs = [_grad_as(ctx.read_slot(op, "Grad"), p) for op, p in zip(ops, ps)]
            slots = [[_own(op, s, o, ctx.read_slot(op, s)) for op in ops] for s, o in state]
            extra = [[ctx.read_slot(op, s) for op in ops] for s in reads]
            rule(None if lr is None else lr.reshape(()), ps, gs, slots, extra,
                 {a: ops[0].attr(a) for a in attrs})
            for i, op in enumerate(ops):
                ctx.write_slot(op, "ParamOut", ps[i])
                for (_, o), ts in zip(state, slots):
                    ctx.write_slot(op, o, ts[i])

        @register_lowering(op_type, no_gradient=True)
        def single(ctx, op):
            group(ctx, [op])
        return rule
    return deco


def _decay_avg(decay, avg, xs):
    """avg' = decay * avg + (1 - decay) * x * x in place, each product
    rounded as the JAX lowerings' ``decay * a + (1 - decay) * x * x``."""
    sq = torch._foreach_mul(xs, 1 - decay)
    torch._foreach_mul_(sq, xs)
    torch._foreach_mul_(avg, decay)
    torch._foreach_add_(avg, sq)


def _each(xs, scalars):
    """x * s for per-tensor 0-d tensors ``scalars``."""
    return [x * s for x, s in zip(xs, scalars)]


@_family("momentum", ("Velocity",), ("mu", "use_nesterov"))
def _momentum(lr, ps, gs, slots, extra, at):
    """v' = mu * v + g; p' = p - lr * v', or with Nesterov
    p' = p - (g + mu * v') * lr."""
    (vs,) = slots
    mu = at["mu"]
    torch._foreach_mul_(vs, mu)
    torch._foreach_add_(vs, gs)
    if at["use_nesterov"]:
        step = torch._foreach_mul(vs, mu)
        torch._foreach_add_(step, gs)
        torch._foreach_mul_(step, lr)
    else:
        step = torch._foreach_mul(vs, lr)
    torch._foreach_sub_(ps, step)


@_family("lars_momentum", ("Velocity",), ("mu", "lars_coeff", "lars_weight_decay"))
def _lars_momentum(lr, ps, gs, slots, extra, at):
    """Per tensor local_lr = lr * coeff * |p| / (|g| + decay * |p| + 1e-12);
    v' = mu * v + local_lr * (g + decay * p); p' = p - v'."""
    (vs,) = slots
    mu, decay = at["mu"], at["lars_weight_decay"]
    pn = torch._foreach_norm(ps)
    den = torch._foreach_mul(pn, decay)
    torch._foreach_add_(den, torch._foreach_norm(gs))
    torch._foreach_add_(den, 1e-12)
    local = torch._foreach_mul(pn, lr * at["lars_coeff"])
    torch._foreach_div_(local, den)
    step = torch._foreach_mul(ps, decay)
    torch._foreach_add_(step, gs)
    torch._foreach_mul_(vs, mu)
    torch._foreach_add_(vs, _each(step, local))
    torch._foreach_sub_(ps, vs)


@_family("adamax", ("Moment", "InfNorm"), ("beta1", "beta2", "epsilon"), reads=("Beta1Pow",))
def _adamax(lr, ps, gs, slots, extra, at):
    """m' = b1 * m + (1 - b1) * g; u' = max(b2 * u, |g|);
    p' = p - (lr / (1 - b1^t)) * m' / (u' + eps), b1^t each parameter's own
    beta1 power (the optimizer's ``scale`` op advances it after the
    updates)."""
    ms, us = slots
    (b1ps,) = extra
    b1, b2 = at["beta1"], at["beta2"]
    g1 = torch._foreach_mul(gs, 1 - b1)
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, g1)
    torch._foreach_mul_(us, b2)
    torch._foreach_maximum_(us, torch._foreach_abs(gs))
    step = _each(ms, [lr / (1 - b.reshape(())) for b in b1ps])
    torch._foreach_div_(step, torch._foreach_add(us, at["epsilon"]))
    torch._foreach_sub_(ps, step)


def _sqrt_step(lr, ps, gs, ms, eps):
    """p' = p - lr * g / (sqrt(m) + eps)."""
    den = torch._foreach_sqrt(ms)
    torch._foreach_add_(den, eps)
    step = torch._foreach_mul(gs, lr)
    torch._foreach_div_(step, den)
    torch._foreach_sub_(ps, step)


@_family("adagrad", ("Moment",), ("epsilon",))
def _adagrad(lr, ps, gs, slots, extra, at):
    """m' = m + g * g; p' = p - lr * g / (sqrt(m') + eps)."""
    (ms,) = slots
    torch._foreach_add_(ms, torch._foreach_mul(gs, gs))
    _sqrt_step(lr, ps, gs, ms, at["epsilon"])


@_family("decayed_adagrad", ("Moment",), ("decay", "epsilon"))
def _decayed_adagrad(lr, ps, gs, slots, extra, at):
    """m' = decay * m + (1 - decay) * g * g; p' = p - lr * g / (sqrt(m') + eps)."""
    (ms,) = slots
    _decay_avg(at["decay"], ms, gs)
    _sqrt_step(lr, ps, gs, ms, at["epsilon"])


@_family("adadelta", ("AvgSquaredGrad", "AvgSquaredUpdate"), ("rho", "epsilon"))
def _adadelta(lr, ps, gs, slots, extra, at):
    """a_g' = rho * a_g + (1 - rho) * g * g;
    u = -sqrt((a_u + eps) / (a_g' + eps)) * g;
    a_u' = rho * a_u + (1 - rho) * u * u; p' = p + u."""
    asg, asu = slots
    rho, eps = at["rho"], at["epsilon"]
    _decay_avg(rho, asg, gs)
    upd = torch._foreach_add(asu, eps)
    torch._foreach_div_(upd, torch._foreach_add(asg, eps))
    torch._foreach_sqrt_(upd)
    torch._foreach_neg_(upd)
    torch._foreach_mul_(upd, gs)
    _decay_avg(rho, asu, upd)
    torch._foreach_add_(ps, upd)


@_family("rmsprop", ("MeanSquare", "Moment"), ("decay", "epsilon", "momentum"))
def _rmsprop(lr, ps, gs, slots, extra, at):
    """ms' = decay * ms + (1 - decay) * g * g;
    mom' = momentum * mom + lr * g / sqrt(ms' + eps); p' = p - mom'."""
    mss, moms = slots
    _decay_avg(at["decay"], mss, gs)
    den = torch._foreach_add(mss, at["epsilon"])
    torch._foreach_sqrt_(den)
    step = torch._foreach_mul(gs, lr)
    torch._foreach_div_(step, den)
    torch._foreach_mul_(moms, at["momentum"])
    torch._foreach_add_(moms, step)
    torch._foreach_sub_(ps, moms)


@_family("ftrl", (("SquaredAccumulator", "SquaredAccumOut"),
                  ("LinearAccumulator", "LinearAccumOut")), ("l1", "l2", "lr_power"))
def _ftrl(lr, ps, gs, slots, extra, at):
    """n' = n + g * g; sigma = (n'^-k - n^-k) / lr (k = lr_power, a square
    root at -0.5); z' = z + g - sigma * p;
    p' = (l1 * sign(z') - z') / (n'^-k / lr + 2 * l2) where |z'| > l1, else 0."""
    sq, lin = slots
    l1, l2, power = at["l1"], at["l2"], at["lr_power"]
    new_sq = torch._foreach_add(sq, torch._foreach_mul(gs, gs))
    if power == -0.5:
        root_new, root_old = torch._foreach_sqrt(new_sq), torch._foreach_sqrt(sq)
    else:
        root_new, root_old = torch._foreach_pow(new_sq, -power), torch._foreach_pow(sq, -power)
    sigma = torch._foreach_sub(root_new, root_old)
    torch._foreach_div_(sigma, lr)
    torch._foreach_mul_(sigma, ps)
    torch._foreach_add_(lin, gs)
    torch._foreach_sub_(lin, sigma)
    den = torch._foreach_div(root_new, lr)
    torch._foreach_add_(den, 2 * l2)
    pre = torch._foreach_mul(torch._foreach_sign(lin), l1)
    torch._foreach_sub_(pre, lin)
    torch._foreach_div_(pre, den)
    torch._foreach_copy_(ps, [torch.where(z.abs() > l1, q, 0.0) for z, q in zip(lin, pre)])
    torch._foreach_copy_(sq, new_sq)


def _proximal(lrs, ps, gs, l1, l2):
    """p' = sign(q) * max(|q| - lr * l1, 0) / (1 + lr * l2), q = p - lr * g,
    per tensor, ``lrs[i]`` a 0-d rate or an elementwise one."""
    for p, g, lr in zip(ps, gs, lrs):
        prox = p - lr * g
        p.copy_(torch.sign(prox) * torch.clamp_min(prox.abs() - lr * l1, 0.0)
                / (1.0 + lr * l2))


@_family("proximal_gd", (), ("l1", "l2"))
def _proximal_gd(lr, ps, gs, slots, extra, at):
    """Proximal gradient descent with L1 and L2 terms (the JAX lowering;
    no optimizer class emits it)."""
    _proximal([lr] * len(ps), ps, gs, at["l1"], at["l2"])


@_family("proximal_adagrad", ("Moment",), ("l1", "l2"))
def _proximal_adagrad(lr, ps, gs, slots, extra, at):
    """m' = m + g * g; the proximal step with the rate lr / sqrt(m')."""
    (ms,) = slots
    torch._foreach_add_(ms, torch._foreach_mul(gs, gs))
    _proximal([lr / torch.sqrt(m) for m in ms], ps, gs, at["l1"], at["l2"])


SPILL_EVERY = 16384     # average_accumulates moves sum_1 into sum_2 this often


@register_lowering("average_accumulates", no_gradient=True)
def _average_accumulates(ctx, op):
    """Three parameter sums: sum_1 adds the parameter each step and spills
    into sum_2 every SPILL_EVERY updates; once num_accumulates reaches
    ``min_average_window`` and min(``max_average_window``, num_updates *
    ``average_window``), sum_1 + sum_2 move to sum_3 and the window
    restarts (old_num_accumulates keeps its length).  The average is
    (sum_1 + sum_2 + sum_3) / (num_accumulates + old_num_accumulates)."""
    p, s1, s2, s3 = (ctx.read_slot(op, s) for s in ("param", "in_sum_1", "in_sum_2", "in_sum_3"))
    num_acc, old_acc, num_upd = (ctx.read_slot(op, s).reshape(()) for s in (
        "in_num_accumulates", "in_old_num_accumulates", "in_num_updates"))
    rate = float(op.attr("average_window", 0.0))
    max_w = int(op.attr("max_average_window", 10000))
    min_w = int(op.attr("min_average_window", 10000))
    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p.to(s1.dtype)
    spill = (num_upd % SPILL_EVERY) == 0
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, 0.0, s1)
    window = torch.clamp_max(num_upd.to(torch.float32) * rate, float(max_w))
    shift = (num_acc >= min_w) & (num_acc.to(torch.float32) >= window)
    s3 = torch.where(shift, s1 + s2, s3)
    s1 = torch.where(shift, 0.0, s1)
    s2 = torch.where(shift, 0.0, s2)
    old_acc = torch.where(shift, num_acc, old_acc)
    num_acc = torch.where(shift, 0, num_acc)
    for slot, v in (("out_sum_1", s1), ("out_sum_2", s2), ("out_sum_3", s3)):
        ctx.write_slot(op, slot, v)
    for slot, v in (("out_num_accumulates", num_acc), ("out_old_num_accumulates", old_acc),
                    ("out_num_updates", num_upd)):
        ctx.write_slot(op, slot, v.reshape(1).to(torch.int32))


def _optimizer_shape(op_type):
    """Each ``<Slot>Out`` has its ``<Slot>``'s shape and dtype."""
    @register_infer_shape(op_type)
    def rule(block, op):
        for out_slot in list(op.outputs):
            in_slot = out_slot[:-3]
            if out_slot.endswith("Out") and op.input(in_slot):
                set_out_shape(block, op, out_slot, in_shape(block, op, in_slot),
                              in_dtype(block, op, in_slot))


for _t in ("sgd", "momentum", "lars_momentum", "adam", "adamax", "adagrad", "adadelta",
           "decayed_adagrad", "ftrl", "rmsprop", "proximal_gd", "proximal_adagrad"):
    _optimizer_shape(_t)
