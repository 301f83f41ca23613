"""The multi-rank cases of ``tests/test_torch_parallel.py``,
``tests/test_torch_pipeline_moe.py``, ``tests/test_torch_sharded_tables.py``
and ``tests/test_torch_mesh_checkpoint.py``: each test file spawns its gloo
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


def spawn(suite: str, world: int, workdir: str, env=None):
    """Run ``suite``'s cases in ``world`` spawned ranks (``env``: variables
    each rank sets before it imports the port); each rank's records:
    {case: {"ok": bool, "value" or "error"}, "findings": n}."""
    import torch.multiprocessing as mp
    port = free_port()
    ctx = mp.start_processes(run_rank, args=(world, port, workdir, suite, env), nprocs=world,
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


class world_of_one:
    """A clique of one gloo rank on the CPU inside the calling process, and
    its ``{"data": 1}`` mesh, torn down on exit (the process group
    destroyed, the port's clique state and mesh cache reset), so the
    process's later tests see no group."""

    def __enter__(self):
        import paddle_tpu_torch as pt
        from paddle_tpu_torch.parallel import make_mesh
        pt.distributed.init_parallel_env(trainer_id=0, num_trainers=1,
                                         coordinator_address=f"localhost:{free_port()}",
                                         place=pt.CPUPlace())
        return make_mesh({"data": 1})

    def __exit__(self, *exc):
        import torch.distributed as tdist
        from paddle_tpu_torch import distributed as dist
        if tdist.is_initialized():
            tdist.destroy_process_group()
        dist._state.update(initialized=False, num_trainers=1, trainer_id=0, device=None,
                           backend=None)
        dist._data_meshes.clear()


def run_rank(rank, world, port, workdir, suite, env=None):
    os.environ.update(env or {})
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
    # the options that waited for item 12c under a mesh: each trains the
    # epoch beside Trainer(parallel=True) and does its part
    from paddle_tpu_torch import health
    from paddle_tpu_torch.checkpoint import CheckpointConfig
    root = os.path.join(workdir, "trainer_ckpt")
    for option, value in (("checkpoint", CheckpointConfig(dir=root, step_interval=1,
                                                          epoch_interval=0)),
                          ("health", True)):
        tr = _tf_trainer(pt, parallel=True, **{option: value})
        rec = {"losses": losses_of(tr, _tf_samples(rank, world))}
        if option == "checkpoint":
            rec["steps"] = tr.ckpt_manager.steps()
        else:
            rec["ok"] = [r["ok"] for r in health.HEALTH_RECORDS.records()
                         if r.get("kind") == "step"][-2:]
        out[option] = rec
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
    # what waited for item 12c under a mesh now works: the sentinel's
    # executor builds, a save from both ranks commits one manifest
    out["sentinels_under_mesh"] = list(pt.Executor(mesh=dist.data_mesh(), sentinels=True)
                                       .sentinels)
    out["checkpoint_save"] = CheckpointManager(os.path.join(workdir, "ckpt_errors"),
                                               async_save=False).save(
        pt.Program(), pt.Scope(), step=1, mesh=dist.data_mesh())
    for label, call in (
            ("layout_without_mesh", lambda: pt.Executor(pt.CPUPlace(), layout=SpecLayout())),
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


# ------------------------------------------------- the sharded-tables suite
TBL = dict(rows=64, dim=8, batch=8, steps=3)


def build_table(pkg, is_sparse=True, opt="sgd", name="user_table"):
    """tests/test_embedding.py's net: ``sharded_table`` -> mean, SGD 0.5
    (``opt="sgd_clip"``: under a global-norm clip of 0.05, which the
    batch's gradient norm of ~0.12 exceeds; ``opt="sgd_l2"``: with an L2
    decay of 0.25), or Adam 0.1."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.layers.data(name="ids", shape=[1], dtype="int64")
        emb = pkg.embedding.sharded_table(ids, name, rows=TBL["rows"], dim=TBL["dim"],
                                          is_sparse=is_sparse)
        loss = pkg.layers.mean(emb)
        if opt == "sgd_clip":
            pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(clip_norm=0.05))
        decay = pkg.regularizer.L2Decay(0.25) if opt == "sgd_l2" else None
        (pkg.optimizer.Adam(learning_rate=0.1) if opt == "adam" else
         pkg.optimizer.SGD(0.5, regularization=decay)).minimize(loss)
    return main, startup, loss


def table_feeds():
    """tests/test_embedding.py's ``_train`` batches: 8 ids a step."""
    rng = np.random.RandomState(3)
    return [{"ids": rng.randint(0, TBL["rows"], (TBL["batch"], 1)).astype(np.int64)}
            for _ in range(TBL["steps"])]


class KernelShapes:
    """Records the table each call of K2's and K3's wrappers is handed
    (their argument check runs first on every call, on the CPU too)."""

    def __enter__(self):
        from paddle_tpu_torch.ops.cuda import embedding as E
        self.module, self.orig, self.seen = E, E._check, set()

        def spy(name, w, flat_ids, rows=None):
            self.seen.add((name, tuple(w.shape)))
            return self.orig(name, w, flat_ids, rows)
        E._check = spy
        return self

    def __exit__(self, *exc):
        self.module._check = self.orig


def train_table(pt, start, is_sparse, opt="sgd", axes=None, rank=0, world=1, kernels=None):
    """The table net from ``start`` over ``table_feeds`` (each rank its rows
    of a batch); returns (the whole table, the rank's shard shape, its
    placements, the kernels' tables)."""
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    main, startup, loss = build_table(pt, is_sparse, opt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    _carry(pt, scope, {"user_table": start})
    exe = (pt.Executor(pt.CPUPlace(), kernels=kernels) if axes is None else
           pt.Executor(mesh=make_mesh(axes), layout=SpecLayout(), kernels=kernels))
    with KernelShapes() as ks:
        for f in table_feeds():
            exe.run(main, feed=_rows(f, rank, world) if axes else f, fetch_list=[loss],
                    scope=scope)
    v = scope.find_var("user_table")
    placements = [repr(p) for p in v.placements] if hasattr(v, "placements") else None
    local = list(v.to_local().shape) if hasattr(v, "to_local") else list(v.shape)
    return _np(v), local, placements, sorted([n, list(s)] for n, s in ks.seen)


TABLE_ARMS = (("dense", False, "sgd", None), ("sparse", True, "sgd", None),
              ("dense_kernel_tier", False, "sgd", True), ("sparse_kernel_tier", True, "sgd", True),
              ("sparse_adam", True, "adam", None), ("dense_adam", False, "adam", None),
              ("sparse_clip", True, "sgd_clip", None), ("sparse_l2", True, "sgd_l2", None))


def case_tables(pt, rank, world, workdir):
    """Each arm on ``{"fsdp": 2}`` under ``SpecLayout()`` against the same
    net in one process from the same table; rank 0 writes both tables."""
    start = _load(workdir, "tbl_start.npz")["user_table"]
    out = {}
    for arm, sparse, opt, kernels in TABLE_ARMS:
        got, local, placements, seen = train_table(pt, start, sparse, opt, {"fsdp": world},
                                                   rank, world, kernels)
        single, _, _, seen1 = train_table(pt, start, sparse, opt, kernels=kernels)
        if rank == 0:
            np.savez(os.path.join(workdir, f"tbl_{arm}.npz"), mesh=got, single=single)
        out[arm] = {"equal_single": bool(np.array_equal(got, single)), "local": local,
                    "placements": placements, "kernel_tables": seen,
                    "kernel_tables_single": seen1}
    return out


def case_plan(pt, rank, world, workdir):
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    mesh = make_mesh({"fsdp": world})
    return {str(kw): pt.embedding.plan_table("t", 1024, 16, mesh=mesh, layout=SpecLayout(), **kw)
            for kw in PLAN_CASES}


PLAN_CASES = ({"slots": 1, "budget": 1024 * 16 * 4}, {"slots": 2}, {"slots": 0, "budget": "1MiB"})
FM = dict(vocab=(8, 16, 4), odd_vocab=(5, 16, 4), dim=4, dense=3, batch=8, steps=2)


def build_deepfm(pkg, shard_tables, vocab=FM["vocab"]):
    """DeepFM at a small width (no dropout: ``is_test``), SGD 0.5."""
    from importlib import import_module
    deepfm = import_module(pkg.__name__ + ".models.deepfm")
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = [L.data(name=f"C{i}", shape=[1], dtype="int64") for i in range(len(vocab))]
        dense = L.data(name="dense", shape=[FM["dense"]], dtype="float32")
        label = L.data(name="label", shape=[1], dtype="float32")
        logits = deepfm.deepfm(ids, dense, list(vocab), embed_dim=FM["dim"], hidden=(8,),
                               is_test=True, shard_tables=shard_tables)
        loss = pkg.layers.mean(pkg.layers.sigmoid_cross_entropy_with_logits(x=logits,
                                                                            label=label))
        pkg.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


def deepfm_feeds(vocab=FM["vocab"]):
    from paddle_tpu_torch.models.deepfm import synthetic_feed
    return [synthetic_feed(40 + s, FM["batch"], vocab_sizes=vocab, num_dense=FM["dense"])
            for s in range(FM["steps"])]


def case_deepfm(pt, rank, world, workdir):
    """``deepfm(shard_tables=True)`` on ``{"data": 2}`` against the same
    model unsharded on the mesh (bit-equal) and in one process; a
    vocabulary the axis does not divide raises at placement."""
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    init = _load(workdir, "fm_init.npz")
    out = {}
    runs = {}
    for label, shard, axes in (("sharded", True, {"data": world}),
                               ("unsharded", False, {"data": world}), ("single", False, None)):
        main, startup, loss = build_deepfm(pt, shard)
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        _carry(pt, scope, init)
        exe = pt.Executor(pt.CPUPlace()) if axes is None else \
            pt.Executor(mesh=make_mesh(axes), layout=SpecLayout())
        losses = [float(exe.run(main, feed=_rows(f, rank, world) if axes else f,
                                fetch_list=[loss], scope=scope)[0]) for f in deepfm_feeds()]
        runs[label] = {n: _np(scope.find_var(n)) for n in init}
        out[label] = {"losses": losses}
        if shard:
            out[label]["placements"] = {n: [repr(p) for p in scope.find_var(n).placements]
                                        for n in ("fm_emb_0", "fm_w1_0")}
    out["sharded_equal_unsharded"] = all(np.array_equal(runs["sharded"][n], runs["unsharded"][n])
                                         for n in init)
    worst = max(float(np.abs(runs["sharded"][n] - runs["single"][n]).max()) for n in init)
    out["sharded_vs_single_max_abs"] = worst
    main, startup, loss = build_deepfm(pt, True, FM["odd_vocab"])
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    from paddle_tpu_torch.telemetry import REGISTRY
    findings = REGISTRY.counter("validate_findings", scope="analysis")
    before = findings.value
    try:
        pt.Executor(mesh=make_mesh({"data": world}), layout=SpecLayout()).run(
            main, feed=_rows(deepfm_feeds(FM["odd_vocab"])[0], rank, world), fetch_list=[loss],
            scope=scope)
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    # the verifier's R404 on the planted odd vocabulary, as in the JAX package
    out["odd_findings"] = findings.value - before
    return out


SUITES["sharded_tables"] = [("tables", case_tables), ("plan", case_plan), ("deepfm", case_deepfm)]


# ------------------------------------------------ the mesh-checkpoint suite
NAN_SITE = "test.nan_feed"     # fired once a batch by mlp_reader: a hit puts a NaN in x


def persist_names(program):
    return [v.name for v in program.list_vars() if v.persistable]


def case_ckpt_save(pt, rank, world, workdir):
    """The 1+1 transformer on ``{"fsdp": 2}`` from the JAX init, 2 Adam
    steps, a synchronous save at step 2 (rank 0 writes the state it saved),
    one more step and an async save at step 3."""
    from paddle_tpu_torch.checkpoint import (CheckpointManager, checkpoint_dir, read_manifest,
                                             validate_shards)
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh, shard_program_state
    root = os.path.join(workdir, "ckpt_tf")
    main, startup, loss = build_transformer(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    _carry(pt, scope, _load(workdir, "tf_init.npz"))
    axes = {"fsdp": world}
    mesh, layout = make_mesh(axes), SpecLayout(mesh_axes=axes)
    shard_program_state(main, scope, mesh, layout)
    mexe = pt.Executor(mesh=mesh, layout=layout)
    feeds = transformer_feeds(3)
    for f in feeds[:2]:
        mexe.run(main, feed=_rows(f, rank, world), fetch_list=[loss], scope=scope)
    m = CheckpointManager(root, async_save=False)
    assert m.save(main, scope, step=2, mesh=mesh, layout=layout)
    state = {n: _np(scope.find_var(n)) for n in persist_names(main)}
    if rank == 0:
        np.savez(os.path.join(workdir, "ck_state2.npz"), **state)
    loss3 = float(mexe.run(main, feed=_rows(feeds[2], rank, world), fetch_list=[loss],
                           scope=scope)[0])
    ma = CheckpointManager(root, async_save=True)
    saved_async = ma.save(main, scope, step=3, mesh=mesh, layout=layout)
    ma.wait()
    ma.close()
    pt.distributed.barrier()
    out = {"loss3": loss3, "async": saved_async, "steps": m.steps()}
    for step in (2, 3):
        d = checkpoint_dir(root, step)
        man = read_manifest(d)
        out[step] = {
            "files": sorted(f for f in os.listdir(d)),
            "shards": {k: v["file"] for k, v in man["shards"].items()},
            "validate": validate_shards(d, man), "mesh": man["mesh"],
            "layout_fp": man["layout_fp"] == layout.fingerprint(),
            "chunks": {n: sum(len(info["chunks"].get(n, [])) for info in man["shards"].values())
                       for n in man["vars"]},
            "sharded": sorted(n for n in persist_names(main)
                              if "Shard" in repr(scope.find_var(n).placements))}
    return out


def case_ckpt_restore(pt, rank, world, workdir):
    """Step 2's checkpoint restored onto ``{"data": 2}`` and onto its own
    ``{"fsdp": 2}`` (each bit-equal to the state saved; the next step's
    loss against the source's), again in place, an impossible budget
    refused first; and the JAX package's checkpoint of its table (saved on
    its 2 x 2 virtual-device mesh) restored onto ``{"fsdp": 2}``."""
    from paddle_tpu_torch.analysis import PredictedOOMError
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    m = CheckpointManager(os.path.join(workdir, "ckpt_tf"), async_save=False)
    want = _load(workdir, "ck_state2.npz")
    feeds = transformer_feeds(3)
    out = {}
    for axes in ({"data": world}, {"fsdp": world}):
        main, startup, loss = build_transformer(pt)
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        mesh, layout = make_mesh(axes), SpecLayout(mesh_axes=axes)
        rec = {}
        try:
            m.restore(main, scope, step=2, mesh=mesh, layout=layout, memory_budget=256)
            rec["m501"] = None
        except PredictedOOMError as e:
            rec["m501"] = e.diagnostic.code
            rec["untouched"] = not any(hasattr(scope.find_var(n), "placements")
                                       for n in persist_names(main))
        man = m.restore(main, scope, step=2, mesh=mesh, layout=layout)
        got = {n: _np(scope.find_var(n)) for n in persist_names(main)}
        rec["diffs"] = {n: float(np.abs(got[n].reshape(want[n].shape) - want[n]).max())
                        for n in want if not np.array_equal(got[n].reshape(want[n].shape),
                                                            want[n])}
        rec["placements"] = {n: [repr(p) for p in scope.find_var(n).placements]
                             for n in ("src_emb", "fc_0.w_0")}
        rec["source_mesh"] = man["mesh"]
        ptrs = {n: scope.find_var(n).to_local().data_ptr() for n in persist_names(main)}
        m.restore(main, scope, step=2, mesh=mesh, layout=layout)
        rec["in_place"] = all(scope.find_var(n).to_local().data_ptr() == p
                              for n, p in ptrs.items())
        mexe = pt.Executor(mesh=mesh, layout=layout)
        rec["loss3"] = float(mexe.run(main, feed=_rows(feeds[2], rank, world), fetch_list=[loss],
                                      scope=scope)[0])
        from paddle_tpu_torch.checkpoint import CKPT_RECORDS
        last = [r for r in CKPT_RECORDS.records() if r.get("kind") == "restore"][-1]
        rec["record"] = {k: last.get(k) for k in ("source_mesh", "target_mesh")}
        out[layout_key(axes)] = rec
    main, startup, loss = build_table(pt, True)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    mesh = make_mesh({"fsdp": world})
    CheckpointManager(os.path.join(workdir, "ckpt_jax"), async_save=False).restore(
        main, scope, mesh=mesh, layout=SpecLayout())
    v = scope.find_var("user_table")
    out["jax_table"] = {"equal": bool(np.array_equal(_np(v), _load(workdir, "jax_table.npz")
                                                     ["user_table"])),
                        "placements": [repr(p) for p in v.placements],
                        "local": list(v.to_local().shape)}
    return out


def _mlp_train_func(pt):
    def train_func():
        L = pt.layers
        x = L.data(name="x", shape=[16], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        h = L.fc(input=x, size=32, act="relu")
        pred = L.fc(input=h, size=4, act="softmax")
        return L.mean(L.cross_entropy(input=pred, label=y))
    return train_func


def mlp_reader(rank, world, batches, seed=0):
    """This rank's rows of ``batches`` global batches of 8; each batch
    fires ``NAN_SITE`` (``faults``), and a hit puts a NaN in its first x."""
    from paddle_tpu_torch import faults

    def reader():
        for s in range(batches):
            d = mlp_data(seed + s, batch=8)
            lo, hi = rank * 8 // world, (rank + 1) * 8 // world
            xs = d["x"][lo:hi].copy()
            if faults.fire(NAN_SITE):
                xs[0, 0] = np.nan
            yield [(x, y) for x, y in zip(xs, d["y"][lo:hi])]
    return reader


def _mlp_trainer(pt, world, root, **kw):
    from paddle_tpu_torch.checkpoint import CheckpointConfig
    from paddle_tpu_torch.parallel import SpecLayout
    with pt.unique_name.guard():
        return pt.Trainer(_mlp_train_func(pt), lambda: pt.optimizer.SGD(learning_rate=0.1),
                          place=pt.CPUPlace(), layout=SpecLayout(mesh_axes={"fsdp": world}),
                          checkpoint=CheckpointConfig(dir=root, step_interval=1, epoch_interval=0,
                                                      rollback_on_divergence=True),
                          **kw)


def _train_events(tr, reader):
    got = []
    tr.train(1, lambda ev: got.append(float(np.asarray(ev.metrics[0])))
             if type(ev).__name__ == "EndStepEvent" else None,
             reader=reader, feed_order=["x", "y"])
    return got


def case_trainer_ckpt(pt, rank, world, workdir):
    """Trainer(layout=, health=True, checkpoint=) on ``{"fsdp": 2}``: an
    epoch saves at its second step; a new Trainer resumes it; a NaN put
    into rank 1's next batch through ``faults`` trips the sentinel on both
    ranks, and the rollback restores the saved shards."""
    from paddle_tpu_torch import faults, health
    root = os.path.join(workdir, "ckpt_mlp")
    tr = _mlp_trainer(pt, world, root, health=True)
    names = persist_names(tr.train_program)
    losses = _train_events(tr, mlp_reader(rank, world, 2))
    saved = {n: _np(tr.scope.find_var(n)) for n in names}
    out = {"losses": losses, "steps": tr.ckpt_manager.steps(),
           "placements": {p.name: [list(p.shape), [repr(q) for q in
                                                   tr.scope.find_var(p.name).placements]]
                          for p in tr.train_program.global_block.all_parameters()}}
    resumed = _mlp_trainer(pt, world, root, health=True)
    out["resume_equal"] = all(np.array_equal(_np(resumed.scope.find_var(n)).reshape(saved[n].shape),
                                             saved[n]) for n in names)
    out["resume_step"] = resumed._global_step
    trips0 = len([r for r in health.HEALTH_RECORDS.records() if r.get("event") == "non-finite"])
    faults.install(f"drop@{NAN_SITE}:n=1" if rank == 1 else None, seed=0)
    try:
        out["nan_losses"] = _train_events(tr, mlp_reader(rank, world, 1, seed=50))
    finally:
        faults.reset()
    trips = [r for r in health.HEALTH_RECORDS.records() if r.get("event") == "non-finite"]
    out["trips"] = [{k: r.get(k) for k in ("bad_vars", "localization", "rank")}
                    for r in trips[trips0:]]
    out["rolled_back"] = all(np.array_equal(_np(tr.scope.find_var(n)).reshape(saved[n].shape),
                                            saved[n]) for n in names)
    out["finite"] = all(np.isfinite(_np(tr.scope.find_var(n))).all() for n in names)
    return out


def case_sentinel(pt, rank, world, workdir):
    """``Executor(mesh=, sentinels=True)``'s values against one process's
    from the same state and global batch (the MLP, SGD 0.1)."""
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    main, startup, loss = build_mlp(pt)
    init = _load(workdir, "mlp_init.npz")
    feed = mlp_data(7, batch=8)
    got = {}
    for label, axes in (("single", None), ("mesh", {"fsdp": world})):
        scope = pt.Scope()
        pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
        _carry(pt, scope, init)
        exe = pt.Executor(pt.CPUPlace(), sentinels=True) if axes is None else \
            pt.Executor(mesh=make_mesh(axes), layout=SpecLayout(mesh_axes=axes), sentinels=True)
        taps = []
        exe._health_hook = lambda **kw: taps.append(
            ([np.asarray(v).tolist() for v in kw["values"]], kw.get("multiproc")))
        exe.run(main, feed=feed if axes is None else _rows(feed, rank, world),
                fetch_list=[loss], scope=scope)
        (values, multiproc), = taps
        got[label] = {"mask": values[0], "loss": values[1], "grad_norm": values[2],
                      "param_norm": values[3], "update_norm": values[4], "multiproc": multiproc}
    return got


def case_nan_global(pt, rank, world, workdir):
    """FLAGS_check_nan_inf on the mesh: a clean step passes; a NaN in rank
    1's rows fails on both ranks, naming the vars."""
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh
    main, startup, loss = build_mlp(pt)
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    _carry(pt, scope, _load(workdir, "mlp_init.npz"))
    axes = {"fsdp": world}
    exe = pt.Executor(mesh=make_mesh(axes), layout=SpecLayout(mesh_axes=axes))
    out = {}
    FLAGS.check_nan_inf = True
    try:
        feed = _rows(mlp_data(8, batch=8), rank, world)
        out["clean"] = float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
        if rank == 1:
            feed["x"] = feed["x"].copy()
            feed["x"][0, 0] = np.nan
        try:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            out["error"] = None
        except FloatingPointError as e:
            out["error"] = str(e)
    finally:
        FLAGS.check_nan_inf = False
    return out


def case_resave(pt, rank, world, workdir):
    """The table net on ``{"fsdp": 2}``: two async saves at one step, the
    table changed between them, then ``wait`` and a restore onto the mesh;
    then a writer error put on rank 1 alone, which the next ``save`` and
    the next ``wait`` raise on both ranks."""
    from paddle_tpu_torch.checkpoint import (CheckpointError, CheckpointManager,
                                             checkpoint_dir, read_manifest, validate_shards)
    from paddle_tpu_torch.parallel import SpecLayout, make_mesh, shard_program_state
    root = os.path.join(workdir, "ckpt_resave")
    main, startup, _ = build_table(pt, True)
    mesh, layout = make_mesh({"fsdp": world}), SpecLayout()
    scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    shard_program_state(main, scope, mesh, layout)
    table = scope.find_var("user_table")
    m = CheckpointManager(root, async_save=True)
    out = {"saved": [m.save(main, scope, step=5, mesh=mesh, layout=layout)]}
    table.to_local().add_(1.0)
    out["saved"].append(m.save(main, scope, step=5, mesh=mesh, layout=layout))
    m.wait()
    d = checkpoint_dir(root, 5)
    out["entries"] = sorted(os.listdir(root)) == [os.path.basename(d)]
    out["validate"] = validate_shards(d, read_manifest(d))
    again = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=again)
    m.restore(main, again, step=5, mesh=mesh, layout=layout)
    out["second"] = bool(np.array_equal(_np(again.find_var("user_table")), _np(table)))
    for call in ("save", "wait"):
        if rank == 1:
            m._error = RuntimeError("injected writer failure")
        try:
            m.save(main, scope, step=6, mesh=mesh, layout=layout) if call == "save" else m.wait()
            out[call + "_raised"] = None
        except CheckpointError as e:
            out[call + "_raised"] = str(e)
    m.close()
    out["steps"] = m.steps()
    return out


def case_legacy_dir(pt, rank, world, workdir):
    """``Trainer(checkpoint_config=)`` with the row-sharded table on
    ``{"fsdp": 2}``: after the epoch's save, a save with every way to make
    a DTensor whole on the device refused, whose serial dir rank 0 writes
    with the whole table."""
    from torch.distributed.tensor import DTensor
    from paddle_tpu_torch.parallel import SpecLayout
    root = os.path.join(workdir, "legacy_tbl")

    def train_func():
        ids = pt.layers.data(name="ids", shape=[1], dtype="int64")
        return pt.layers.mean(pt.embedding.sharded_table(ids, "user_table", rows=TBL["rows"],
                                                         dim=TBL["dim"], is_sparse=True))
    with pt.unique_name.guard():
        tr = pt.Trainer(train_func, lambda: pt.optimizer.SGD(0.5), place=pt.CPUPlace(),
                        layout=SpecLayout(mesh_axes={"fsdp": world}),
                        checkpoint_config=pt.CheckpointConfig(checkpoint_dir=root))
    ids = _rows(table_feeds()[0], rank, world)["ids"]
    tr.train(1, lambda ev: None, reader=lambda: iter([[(i,) for i in ids]]),
             feed_order=["ids"])
    table = tr.scope.find_var("user_table")
    orig = DTensor.full_tensor, DTensor.redistribute

    def refuse(*a, **k):
        raise AssertionError("a DTensor was made whole on the device")
    DTensor.full_tensor = DTensor.redistribute = refuse
    try:
        tr._save_checkpoint(0, 1)
    finally:
        DTensor.full_tensor, DTensor.redistribute = orig
    out = {"local": list(table.to_local().shape)}
    whole = _np(table)
    if rank == 0:
        dirs = sorted(os.listdir(root))
        with np.load(os.path.join(root, dirs[-1], "__params__.npz")) as z:
            out["dirs"] = dirs
            out["equal"] = bool(np.array_equal(z["user_table"], whole))
    return out


SUITES["mesh_checkpoint"] = [("ckpt_save", case_ckpt_save), ("ckpt_restore", case_ckpt_restore),
                             ("trainer_ckpt", case_trainer_ckpt), ("sentinel", case_sentinel),
                             ("nan_global", case_nan_global), ("resave", case_resave),
                             ("legacy_dir", case_legacy_dir)]
