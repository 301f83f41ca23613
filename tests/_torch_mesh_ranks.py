"""The multi-rank cases of ``tests/test_torch_parallel.py`` and
``tests/test_torch_pipeline_moe.py``: each test file spawns its gloo
ranks on the CPU once (:func:`spawn`), every rank runs the file's cases
in order (collectives need every rank in each), and the tests read the
records the ranks wrote.  The JAX package's references are computed by
the test file beforehand and read from ``workdir``; this module imports
neither jax nor the JAX package, so a rank starts in seconds.
"""
import json
import os
import socket
import time
import traceback

import numpy as np

SPAWN_S = 240.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(suite: str, world: int, workdir: str):
    """Run ``suite``'s cases in ``world`` spawned ranks; each rank's
    records: {case: {"ok": bool, "value" or "error"}, "findings": n}."""
    import torch.multiprocessing as mp
    port = free_port()
    ctx = mp.start_processes(run_rank, args=(world, port, workdir, suite), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.time() + SPAWN_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise TimeoutError(f"the {suite} ranks did not end in {SPAWN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{suite}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def run_rank(rank, world, port, workdir, suite):
    import torch
    torch.set_num_threads(2)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.telemetry import REGISTRY
    pt.distributed.init_parallel_env(trainer_id=rank, num_trainers=world,
                                     coordinator_address=f"localhost:{port}",
                                     place=pt.CPUPlace())
    findings = REGISTRY.counter("validate_findings", scope="analysis")
    records = {}
    for name, fn in SUITES[suite]:
        try:
            records[name] = {"ok": True, "value": fn(pt, rank, world, workdir)}
        except Exception:  # noqa: BLE001 -- reported to the test, which fails
            records[name] = {"ok": False, "error": traceback.format_exc()}
    records["findings"] = findings.value
    pt.distributed.barrier()
    with open(os.path.join(workdir, f"{suite}_rank{rank}.json"), "w") as f:
        json.dump(records, f)


def _np(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)


def _load(workdir, name):
    with np.load(os.path.join(workdir, name)) as z:
        return {k: z[k] for k in z.files}


def _carry(pt, scope, params):
    """Copy numpy values into the scope's tensors (before placement)."""
    import torch
    for n, a in params.items():
        t = scope.find_var(n)
        if t is not None:
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(t.shape))


def _rows(feed, rank, world):
    """This rank's rows of a global batch (the feed of a data-parallel
    rank: the global batch is the ranks' rows concatenated)."""
    out = {}
    for k, v in feed.items():
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


# ------------------------------------------------------------------ programs
# each takes the package (paddle_tpu or paddle_tpu_torch) and builds the
# same program under unique_name.guard(): (main, startup, loss)

def build_mlp(pkg, width=32, reduce_net=False):
    """tests/test_parallel_executor.py's nets: the softmax MLP (SGD 0.1), or
    the regression net of its Reduce test (width 256, SGD 0.01)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        if reduce_net:
            x = L.data(name="x", shape=[64], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="float32")
            h = L.fc(input=x, size=width, act="relu")
            loss = L.mean(L.square_error_cost(input=L.fc(input=h, size=1), label=y))
            pkg.optimizer.SGD(learning_rate=0.01).minimize(loss)
        else:
            x = L.data(name="x", shape=[16], dtype="float32")
            y = L.data(name="y", shape=[1], dtype="int64")
            h = L.fc(input=x, size=width, act="relu")
            pred = L.fc(input=h, size=4, act="softmax")
            loss = L.mean(L.cross_entropy(input=pred, label=y))
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def mlp_data(step, batch=32):
    rng = np.random.RandomState(step)
    xs = rng.randn(batch, 16).astype(np.float32)
    return {"x": xs, "y": (xs.sum(1, keepdims=True) > 0).astype(np.int64)}


def reduce_data(steps=5):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(steps):
        xs = rng.randn(32, 64).astype(np.float32)
        out.append({"x": xs, "y": xs[:, :1] * 2.0})
    return out


TF = dict(vocab=64, t=8, d_model=32, n_head=4, d_inner=64, n_layer=1, batch=4)


def build_transformer(pkg):
    """A 1+1-layer train_network(fuse_final_ce=True) with Adam 1e-3."""
    from importlib import import_module
    transformer = import_module(pkg.__name__ + ".models.transformer")
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = L.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = L.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = L.data(name="lbl", shape=[TF["t"], 1], dtype="int64")
        loss, _ = transformer.train_network(
            src, trg, lbl, TF["vocab"], TF["vocab"], max_len=TF["t"], n_layer=TF["n_layer"],
            d_model=TF["d_model"], n_head=TF["n_head"], d_inner=TF["d_inner"],
            fuse_final_ce=True)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def transformer_feeds(steps=2):
    rs = np.random.RandomState(7)
    b, t, v = TF["batch"], TF["t"], TF["vocab"]
    return [{"src": rs.randint(1, v, (b, t, 1)), "trg": rs.randint(1, v, (b, t, 1)),
             "lbl": rs.randint(1, v, (b, t, 1)),
             "src@SEQ_LEN": np.array([8, 5, 3, 8], np.int32),
             "trg@SEQ_LEN": np.array([2, 8, 6, 7], np.int32)} for _ in range(steps)]


LAYOUTS = ({"data": 2}, {"fsdp": 2}, {"tp": 2})


def layout_key(axes):
    return ",".join(f"{k}{v}" for k, v in axes.items())


# ------------------------------------------------------- the parallel suite
def case_env(pt, rank, world, workdir):
    from paddle_tpu_torch import distributed as dist
    env = pt.distributed.init_parallel_env(trainer_id=rank, num_trainers=world)
    out = {"nranks": env.nranks, "rank": env.rank, "global_devices": env.global_devices,
           "is_initialized": dist.is_initialized()}
    try:
        dist.init_parallel_env(trainer_id=rank, num_trainers=world + 1)
        out["conflict"] = None
    except RuntimeError as e:
        out["conflict"] = str(e)
    mesh = dist.data_mesh()
    out["data_mesh_cached"] = dist.data_mesh() is mesh
    out["data_mesh_shape"] = dict(mesh.shape)
    out["coordinate"] = mesh.coordinate("data")
    sh = dist.feed_sharding()
    out["feed_sharding"] = [sh.spec, [repr(p) for p in sh.placements]]
    sh2 = dist.feed_sharding(spec=[None, "data"])
    out["feed_sharding_spec"] = [sh2.spec, [repr(p) for p in sh2.placements]]
    dist.barrier()
    return out


def case_dp(pt, rank, world, workdir):
    from paddle_tpu_torch.parallel import ParallelExecutor
    main, startup, loss = build_mlp(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    _carry(pt, scope, _load(workdir, "dp_init.npz"))
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, main_program=main, scope=scope)
    losses = [float(pe.run(fetch_list=[loss.name], feed=_rows(mlp_data(s), rank, world))[0])
              for s in range(5)]
    info = pe._executor.cache_info()["entries"][-1]
    return {"losses": losses, "device_count": pe.device_count, "reasons": info["reasons"]}


def case_reduce(pt, rank, world, workdir):
    from paddle_tpu_torch.parallel import BuildStrategy, ParallelExecutor
    main, startup, loss = build_mlp(pt, width=256, reduce_net=True)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    _carry(pt, scope, _load(workdir, "reduce_init.npz"))
    bs = BuildStrategy()
    bs.reduce_strategy = BuildStrategy.ReduceStrategy.Reduce
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, build_strategy=bs,
                          main_program=main, scope=scope)
    losses = [float(pe.run(fetch_list=[loss], feed=_rows(f, rank, world))[0])
              for f in reduce_data()]
    sharded = {v.name: [repr(p) for p in scope.find_var(v.name).placements]
               for v in main.list_vars() if v.persistable and v.sharding is not None}
    local = {n: list(scope.find_var(n).to_local().shape) for n in sharded}
    return {"losses": losses, "sharded": sharded, "local_shapes": local}


def case_layout(pt, rank, world, workdir):
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh, shard_program_state
    init = _load(workdir, "tf_init.npz")
    feeds = transformer_feeds()
    out = {}
    for axes in LAYOUTS:
        main, startup, loss = build_transformer(pt)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        _carry(pt, scope, init)
        mesh, layout = make_mesh(axes), SpecLayout(mesh_axes=axes)
        specs = shard_program_state(main, scope, mesh, layout)
        mexe = pt.Executor(mesh=mesh, layout=layout)
        # a batch-sharded layout feeds each rank its rows; tp feeds it all
        split = "data" in axes or "fsdp" in axes
        losses = [float(mexe.run(main, feed=_rows(f, rank, world) if split else f,
                                 fetch_list=[loss], scope=scope)[0]) for f in feeds]
        persist = [v.name for v in main.list_vars() if v.persistable]
        final = {k: _np(scope.find_var(k)) for k in persist}
        if rank == 0:
            np.savez(os.path.join(workdir, f"tf_{layout_key(axes)}.npz"), **final)
        out[layout_key(axes)] = {
            "losses": losses, "sharded": sum(1 for s in specs.values() if s),
            "state_bytes": sum(scope.find_var(k).to_local().numel() * 4 for k in persist),
            "entry": mexe.cache_info()["entries"][-1]["reasons"]}
    return out


def _tf_trainer(pt, **kw):
    from paddle_tpu_torch.models import transformer

    def train_func():
        L = pt.layers
        src = L.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = L.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = L.data(name="lbl", shape=[TF["t"], 1], dtype="int64")
        loss, _ = transformer.train_network(
            src, trg, lbl, TF["vocab"], TF["vocab"], max_len=TF["t"], n_layer=TF["n_layer"],
            d_model=TF["d_model"], n_head=TF["n_head"], d_inner=TF["d_inner"],
            fuse_final_ce=True)
        return loss
    with pt.unique_name.guard():
        return pt.Trainer(train_func, lambda: pt.optimizer.Adam(learning_rate=1e-3),
                          place=pt.CPUPlace(), **kw)


def _tf_samples(rank=0, world=1, n=8):
    """Samples of 8 batches of 4; a rank reads its rows of each batch."""
    rs = np.random.RandomState(11)
    t, v = TF["t"], TF["vocab"]
    samples = [(rs.randint(1, v, (rs.randint(3, t + 1), 1)), rs.randint(1, v, (t, 1)),
                rs.randint(1, v, (t, 1))) for _ in range(n)]
    per = TF["batch"] // world

    def reader():
        for b in range(0, n, TF["batch"]):
            yield samples[b + rank * per:b + (rank + 1) * per]
    return reader


def case_trainer(pt, rank, world, workdir):
    """Trainer(parallel=True) and Trainer(layout=fsdp) against a one-process
    Trainer of the same program and seed (rank 0), the same global batches."""
    from paddle_tpu_torch.parallel import SpecLayout
    out = {}

    def losses_of(tr, reader):
        got = []
        tr.train(1, lambda ev: got.append(float(np.asarray(ev.metrics[0])))
                 if type(ev).__name__ == "EndStepEvent" else None,
                 reader=reader, feed_order=["src", "trg", "lbl"])
        return got
    out["single"] = losses_of(_tf_trainer(pt, pipeline=False), _tf_samples())
    for label, kw in (("parallel", {"parallel": True}),
                      ("fsdp", {"layout": SpecLayout(mesh_axes={"fsdp": world})})):
        tr = _tf_trainer(pt, **kw)
        out[label] = losses_of(tr, _tf_samples(rank, world))
        out[label + "_captures"] = tr.exe.cache_info()["captures"]
        out[label + "_mesh"] = dict(tr.exe.mesh.shape)
    for option, value in (("checkpoint", True), ("health", True)):
        try:
            _tf_trainer(pt, parallel=True, **{option: value})
            out[option] = None
        except NotImplementedError as e:
            out[option] = str(e)
    return out


def case_device_loader(pt, rank, world, workdir):
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.reader.device_loader import DeviceLoader
    main, startup, loss = build_mlp(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    mesh = dist.data_mesh()
    mexe = pt.Executor(mesh=mesh)
    batches = [_rows(mlp_data(s), rank, world) for s in range(3)]
    loader = DeviceLoader(lambda: iter(batches), sharding=dist.feed_sharding())
    got, kinds = [], []
    state0 = {v.name: scope.find_var(v.name).clone() for v in main.list_vars() if v.persistable}
    for b in loader():
        kinds.append([type(b["x"]).__name__, [repr(p) for p in b["x"].placements],
                      list(b["x"].shape), list(b["x"].to_local().shape)])
        got.append(float(mexe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]))
    scope2 = pt.Scope()
    exe.run(startup, scope=scope2)
    for n, v in state0.items():
        scope2.find_var(n).copy_(v)
    want = [float(mexe.run(main, feed=b, fetch_list=[loss], scope=scope2)[0]) for b in batches]
    return {"losses": got, "numpy_losses": want, "kinds": kinds}


def case_analysis(pt, rank, world, workdir):
    """verify / plan_memory given the real Mesh and SpecLayout objects."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import SpecLayout
    main, startup, loss = build_analysis_net(pt)
    mesh = dist.data_mesh()
    res = analysis.verify(main, fetch_list=[loss], mesh=mesh, layout=SpecLayout())
    plan = analysis.plan_memory(main, fetch_list=[loss], feed_shapes={"x": (8, 6)}, mesh=mesh,
                                layout=SpecLayout())
    return {"codes": sorted(d.code for d in res.diagnostics),
            "plan": {"num_devices": plan.num_devices, "mesh": plan.mesh,
                     "layout": plan.layout_fp},
            "m5": sorted(d.code for d in analysis.memory.memory_diagnostics(plan))}


def build_analysis_net(pkg):
    """A net whose annotations the mesh lint flags: an axis the mesh lacks
    (R402), a dim the axis does not divide (R404)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = L.data(name="x", shape=[6], dtype="float32")
        h = L.fc(input=x, size=6, act="relu")
        h.set_sharding(["data", "tp"])
        g = L.fc(input=h, size=3)
        g.set_sharding(["data"])
        loss = L.mean(g)
        for p in main.global_block.all_parameters():
            if tuple(p.shape) == (6, 3):
                p.set_sharding([None, "data"])
    return main, startup, loss


def case_errors(pt, rank, world, workdir):
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    out = {}
    for label, call in (
            ("layout_without_mesh", lambda: pt.Executor(pt.CPUPlace(), layout=SpecLayout())),
            ("sentinels_under_mesh", lambda: pt.Executor(mesh=dist.data_mesh(),
                                                         sentinels=True)),
            ("checkpoint_save", lambda: CheckpointManager(
                os.path.join(workdir, f"ckpt{rank}"), async_save=False).save(
                    pt.Program(), pt.Scope(), step=1, mesh=dist.data_mesh())),
            ("host_staged_nccl", None),
            ("bad_axes", lambda: make_mesh({"data": 3})),
            ("two_inferred", lambda: make_mesh({"data": -1, "fsdp": -1}))):
        if call is None:
            continue
        try:
            call()
            out[label] = None
        except (NotImplementedError, ValueError) as e:
            out[label] = f"{type(e).__name__}: {e}"
    return out


SUITES = {
    "parallel": [("env", case_env), ("dp", case_dp), ("reduce", case_reduce),
                 ("layout", case_layout), ("trainer", case_trainer),
                 ("device_loader", case_device_loader), ("analysis", case_analysis),
                 ("errors", case_errors)],
}


# -------------------------------------------------- the pipeline / MoE suite
D = 16


def build_pipelined(pkg, n_stages=2, n_micro=4, sgd=True):
    """tests/test_pipeline_ir.py's net: a PipelinedStages of fc+relu
    stages, then an fc head and a square-error loss (SGD 0.05)."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = L.data(name="x", shape=[D], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        pipe = L.PipelinedStages(input=x, n_stages=n_stages, n_micro=n_micro)
        with pipe.block() as s:
            pipe.complete(L.fc(input=s, size=D, act="relu"))
        pred = L.fc(input=pipe.output, size=1)
        loss = L.mean(L.square_error_cost(input=pred, label=y))
        if sgd:
            pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss, pipe


def pipeline_feeds():
    rng = np.random.default_rng(2)
    feeds = [{"x": rng.standard_normal((16, D)).astype(np.float32)} for _ in range(4)]
    for f in feeds:
        f["y"] = f["x"].sum(1, keepdims=True).astype(np.float32)
    return feeds


RING = dict(t=32, dm=16, heads=2, rows=4)


def build_ring(pkg, causal=True):
    """tests/test_pipeline_ir.py's ring net: multi_head_attention with
    use_ring_attention=True, its gradients appended."""
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = L.data(name="x", shape=[RING["t"], RING["dm"]], dtype="float32")
        attn = L.multi_head_attention(x, x, x, d_model=RING["dm"], n_head=RING["heads"],
                                      causal=causal, use_ring_attention=True, name="ring_mha")
        out = L.reduce_mean(attn)
        params = [p.name for p in main.global_block.all_parameters()]
        pkg.append_backward(out)
    return main, startup, attn, params


def ring_feed():
    rng = np.random.default_rng(3)
    return {"x": rng.standard_normal((RING["rows"], RING["t"], RING["dm"])).astype(np.float32)}


MOE = dict(d=16, e=4, h=32, t=16, cf=2.0)


def build_moe(pkg, expert_axis="expert"):
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = L.data(name="x", shape=[MOE["d"]], dtype="float32")
        out, aux = L.switch_moe(x, num_experts=MOE["e"], d_hidden=MOE["h"],
                                capacity_factor=MOE["cf"], expert_axis=expert_axis)
    return main, startup, out, aux


def moe_feed():
    return {"x": np.random.RandomState(3).randn(MOE["t"], MOE["d"]).astype(np.float32)}


def case_collectives(pt, rank, world, workdir):
    """ppermute and psum on local tensors: values and gradients."""
    import torch
    from paddle_tpu_torch.parallel import _collectives as C
    from paddle_tpu_torch.parallel import make_mesh
    out = {}
    for staged in (False, True):
        mesh = make_mesh({"x": world}, host_staged=staged)
        v = torch.arange(4, dtype=torch.float32) + 10 * rank
        v.requires_grad_(True)
        ring = C.ppermute(v, mesh, "x", [(j, (j + 1) % world) for j in range(world)])
        shift = C.ppermute(v, mesh, "x", [(j, j + 1) for j in range(world - 1)])
        w = torch.full((4,), float(rank + 1))
        (gv,) = torch.autograd.grad((ring * w).sum() + (shift * 2 * w).sum(), [v])
        s = C.psum(v * (rank + 1), mesh, "x")
        (gs,) = torch.autograd.grad(s.sum(), [v])
        out[f"staged={staged}"] = {"ring": ring.tolist(), "shift": shift.tolist(),
                                   "grad": gv.tolist(), "psum": s.tolist(),
                                   "psum_grad": gs.tolist(), "index": C.axis_index(mesh, "x")}
    return out


def case_pipeline(pt, rank, world, workdir):
    from paddle_tpu_torch.parallel import make_mesh
    main, startup, loss, pipe = build_pipelined(pt, n_stages=world)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    _carry(pt, scope, _load(workdir, "pipe_init.npz"))
    mexe = pt.Executor(mesh=make_mesh({"pipe": world}))
    runs = [mexe.run(main, feed=f, fetch_list=[loss, pipe.output], scope=scope)
            for f in pipeline_feeds()]
    losses, y0 = [float(r[0]) for r in runs], runs[0][1]
    (op,) = [o for o in main.desc.block(0).ops if o.type == "pipeline"]
    stacked = sorted(op.attr("stage_params"))
    return {"losses": losses, "out0": np.asarray(y0).tolist(),
            "placements": {n: [repr(p) for p in scope.find_var(n).placements] for n in stacked}}


def case_ring(pt, rank, world, workdir):
    from paddle_tpu_torch.core.desc import grad_var_name
    from paddle_tpu_torch.parallel import make_mesh
    out = {}
    for causal in (True, False):
        main, startup, attn, params = build_ring(pt, causal)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=scope)
        _carry(pt, scope, _load(workdir, f"ring_init_{causal}.npz"))
        mexe = pt.Executor(mesh=make_mesh({"seq": world}))
        got = mexe.run(main, feed=ring_feed(), fetch_list=[attn] + [grad_var_name(p)
                                                                    for p in params],
                       scope=scope)
        if rank == 0:
            np.savez(os.path.join(workdir, f"ring_got_{causal}.npz"),
                     **{n: a for n, a in zip(["out"] + params, got)})
        out[str(causal)] = len(got)
    main, startup, attn, params = build_ring(pt)
    for label, feed in (("ragged", dict(ring_feed(), **{"x@SEQ_LEN": np.full(
            RING["rows"], RING["t"], np.int32)})),):
        try:
            scope = pt.Scope()
            pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
            pt.Executor(mesh=make_mesh({"seq": world})).run(main, feed=feed, fetch_list=[attn],
                                                            scope=scope)
            out[label] = None
        except ValueError as e:
            out[label] = str(e)
    return out


def case_moe(pt, rank, world, workdir):
    from paddle_tpu_torch.parallel import make_mesh
    main, startup, out, aux = build_moe(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    _carry(pt, scope, _load(workdir, "moe_init.npz"))
    mexe = pt.Executor(mesh=make_mesh({"expert": world}))
    got_out, got_aux = mexe.run(main, feed=moe_feed(), fetch_list=[out, aux], scope=scope)
    w1 = [v.name for v in main.list_vars() if v.persistable and len(v.shape) == 3][0]
    return {"out": np.asarray(got_out).tolist(), "aux": float(got_aux),
            "w1_placements": [repr(p) for p in scope.find_var(w1).placements],
            "w1_local": list(scope.find_var(w1).to_local().shape)}


SUITES["pipeline_moe"] = [("collectives", case_collectives), ("pipeline", case_pipeline),
                          ("ring", case_ring), ("moe", case_moe)]
