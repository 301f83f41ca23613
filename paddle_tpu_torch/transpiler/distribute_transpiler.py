"""DistributeTranspiler: split one training program into trainer and
pserver programs (a copy of the JAX package's, so both packages build the
same ProgramDescs).

Reference: Paddle's python/paddle/fluid/transpiler/
distribute_transpiler.py:132-180 (config :116) — params/grads are sliced
into blocks (slice_variable :70-114), placed round-robin over pserver
endpoints (ps_dispatcher.py), the trainer program gets send/send_barrier/
recv/fetch_barrier ops, and each pserver program is a listen_and_serv op
whose sub-blocks hold the optimize ops for its params
(get_pserver_program :477, get_trainer_program :384, startup :701).

Simplifications, as in the JAX package:
* parameters are placed WHOLE, round-robin by size (the reference
  additionally splits large params into ~8MB blocks purely for pserver
  load balance; whole-param placement preserves semantics), unless
  ``slice_var_up`` asks for dim0-aligned blocks;
* the trainer program puts recv+fetch_barrier FIRST (every step computes
  on the freshly-applied round — BSP sync exactly like RunSyncLoop) and
  send+send_barrier last, so the executor runs them as host stages before
  and after the step's CUDA graph (``core/executor.py``);
* the pserver "program" carries the per-param optimize mini-programs
  directly (built from the captured optimize op descs), executed through
  the port's Executor on the server's place by ParameterServer — the same
  optimizer lowerings as local training, so parity is exact.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.desc import OpDesc
from ..core.framework import Block, Program, default_main_program

OPTIMIZE_ROLE = "optimize"


class DistributeTranspilerConfig:
    """reference transpiler config :116.  ``slice_var_up=True`` splits each
    large parameter into dim0-aligned blocks of >= ``min_block_size``
    elements (reference slice_variable :70-114) and balances the BLOCKS
    across pservers; False places parameters whole."""

    def __init__(self):
        self.slice_var_up = False
        self.min_block_size = 8192
        self.sync_mode = True


class DistributeTranspiler:
    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()

    # ------------------------------------------------------------ transpile
    def transpile(self, trainer_id: int, program: Optional[Program] = None,
                  pservers: str = "", trainers: int = 1,
                  sync_mode: Optional[bool] = None,
                  startup_program: Optional[Program] = None):
        self.trainer_id = trainer_id
        self.origin_program = program or default_main_program()
        self.endpoints = [e.strip() for e in pservers.split(",") if e.strip()]
        if not self.endpoints:
            raise ValueError("pservers must list at least one endpoint")
        self.trainers = trainers
        self.sync_mode = (self.config.sync_mode if sync_mode is None
                          else sync_mode)
        self.startup_program = startup_program
        if startup_program is not None:
            _stamp_init_seeds(startup_program)

        block = self.origin_program.desc.block(0)
        # distributed lookup tables: lookup_table ops flagged
        # is_distributed (reference _has_distributed_lookup_table,
        # distribute_transpiler.py:808) get row-sharded across ALL
        # pservers instead of whole-param placement
        self.table_meta: Dict[str, dict] = {}
        for op in block.ops:
            if op.type == "lookup_table" and op.attr("is_distributed",
                                                     False):
                w = op.input("W")[0]
                vd = block.find_var(w)
                self.table_meta[w] = {"vocab": int(vd.shape[0]),
                                      "dim": int(vd.shape[1]),
                                      "dtype": np.dtype(
                                          vd.dtype.np_dtype).name}

        # collect (param, grad, [optimize op descs]) from the optimize pass
        self._opt_ops: Dict[str, List[OpDesc]] = {}
        self._param_grad: Dict[str, str] = {}
        self._lr_ops: List[OpDesc] = []
        lr_targets = set()
        for op in block.ops:
            if op.attr("op_role") != OPTIMIZE_ROLE:
                continue
            pnames = op.input("Param")
            if pnames:
                p = pnames[0]
                if p in self.table_meta:
                    # tables update by SGD-on-rows on their shard owners
                    # (the reference's constraint too: the distributed
                    # table path only supports sgd)
                    if op.type != "sgd":
                        raise ValueError(
                            f"distributed lookup table {p!r} must be "
                            f"optimized by SGD, got {op.type!r}")
                    lr_name = op.input("LearningRate")[0]
                    self.table_meta[p]["lr"] = self._find_init_value(
                        lr_name)
                    continue
                self._opt_ops.setdefault(p, []).append(op)
                g = op.input("Grad")
                if g:
                    self._param_grad[p] = g[0]
                lr_targets.update(op.input("LearningRate"))
            else:
                self._lr_ops.append(op)
        # lr-SCHEDULE ops are built by the scheduler layers in the main
        # block without the optimize role: collect the transitive producer
        # closure of the optimizers' LearningRate inputs — these move to
        # the pserver and run once per round (reference transpiler moves
        # the lr-decay sub-program the same way)
        produced = set(lr_targets)
        sched: List[OpDesc] = []
        for op in reversed(block.ops):
            if op.attr("op_role") == OPTIMIZE_ROLE:
                continue
            if any(o in produced for o in op.output_names()):
                sched.append(op)
                produced.update(op.input_names())
        self._lr_ops = list(reversed(sched)) + self._lr_ops

        # tables with no sgd op (frozen param / forward-only program) are
        # read-only: prefetch works, pushes are numeric no-ops (lr 0)
        for tm in self.table_meta.values():
            tm.setdefault("lr", 0.0)

        # trainers never materialize a distributed table (that's the whole
        # point — reference removes the table from the trainer side too):
        # keep a pristine startup clone for the pservers, then strip the
        # table init ops from the TRAINER's startup program in place
        if self.table_meta and self.startup_program is not None:
            self._pserver_startup_src = _clone(self.startup_program)
            sb = self.startup_program.desc.block(0)
            sb.ops = [op for op in sb.ops
                      if not any(o in self.table_meta
                                 for o in op.output_names())]
            self.startup_program.desc._bump()
            self.startup_program.sync_with_desc()
        else:
            self._pserver_startup_src = self.startup_program

        # --- param slicing (reference slice_variable :70-114): with
        # slice_var_up, each param with >= min_block_size elements splits
        # into up to len(endpoints) dim0-aligned blocks named
        # `<param>.block<i>` — the placement units below are then blocks,
        # so one giant fc/embedding param spreads across pservers
        self.slices: Dict[str, List[dict]] = {}
        if self.config.slice_var_up and len(self.endpoints) > 1:
            import math
            for p in self._opt_ops:
                vd = block.find_var(p)
                if vd is None or not vd.shape:
                    continue
                shape = tuple(int(d) for d in vd.shape)
                numel = int(np.prod(shape))
                dim1 = int(np.prod(shape[1:])) if len(shape) > 1 else 1
                split = min(len(self.endpoints),
                            max(1, numel // int(self.config.min_block_size)))
                if split <= 1:
                    continue
                bsize = math.ceil(numel / split)
                rows_per = max(1, math.ceil(bsize / dim1))
                nblocks = math.ceil(shape[0] / rows_per)
                if nblocks <= 1:
                    continue
                self.slices[p] = [
                    {"block": f"{p}.block{i}", "row0": i * rows_per,
                     "rows": min(rows_per, shape[0] - i * rows_per)}
                    for i in range(nblocks)]
        elif self.config.slice_var_up:
            import warnings
            warnings.warn("slice_var_up=True has no effect with a single "
                          "pserver endpoint; parameters are placed whole",
                          stacklevel=2)

        # placement units (whole params or blocks), balanced by numel
        # (largest first — the load-balance goal of reference
        # slice_variable + RoundRobin dispatch)
        sizes = []
        for p in self._opt_ops:
            vd = block.find_var(p)
            dim1 = (int(np.prod(vd.shape[1:]))
                    if vd is not None and len(vd.shape) > 1 else 1)
            if p in self.slices:
                for s in self.slices[p]:
                    sizes.append((s["rows"] * dim1, s["block"]))
            else:
                sizes.append((int(np.prod(vd.shape)) if vd is not None and
                              vd.shape else 0, p))
        sizes.sort(reverse=True)
        self.param_endpoint: Dict[str, str] = {}
        load = {e: 0 for e in self.endpoints}
        for size, p in sizes:
            ep = min(self.endpoints, key=lambda e: load[e])
            self.param_endpoint[p] = ep
            load[ep] += size
        # unit -> (source param, row0, rows); whole params map to themselves
        self.unit_src: Dict[str, tuple] = {}
        for p in self._opt_ops:
            if p in self.slices:
                for s in self.slices[p]:
                    self.unit_src[s["block"]] = (p, s["row0"], s["rows"])
            else:
                self.unit_src[p] = (p, 0, -1)

    def _find_init_value(self, name: str) -> float:
        """Initial value of a fill_constant-initialized var (used for the
        table SGD learning rate — constant-lr only, like the reference's
        table path)."""
        progs = [p for p in (self.startup_program, self.origin_program)
                 if p is not None]
        for prog in progs:
            for op in prog.desc.block(0).ops:
                if op.type == "fill_constant" and name in \
                        op.output_names():
                    return float(op.attr("value"))
        raise ValueError(
            f"cannot determine constant learning rate for distributed "
            f"table (var {name!r} has no fill_constant initializer); "
            f"lr schedules are not supported for distributed tables")

    # ------------------------------------------------------------- trainer
    def get_trainer_program(self) -> Program:
        """Strip optimize-role ops; prepend recv/fetch_barrier; append
        send/send_barrier (reference get_trainer_program :384)."""
        prog = _clone(self.origin_program)
        block = prog.desc.block(0)
        lr_sigs = {(op.type, tuple(sorted(op.output_names())))
                   for op in self._lr_ops}
        block.ops = [op for op in block.ops
                     if op.attr("op_role") != OPTIMIZE_ROLE
                     and (op.type, tuple(sorted(op.output_names())))
                     not in lr_sigs]
        # rewrite distributed-table ops: forward lookup -> remote prefetch,
        # backward -> sparse row push (reference replaces the table's
        # lookup with split_ids + prefetch, distribute_transpiler.py:808+)
        if self.table_meta:
            new_ops, dangling = [], set()
            for op in block.ops:
                w = (op.input("W") or [""])[0]
                if op.type == "lookup_table" and w in self.table_meta:
                    tm = self.table_meta[w]
                    new_ops.append(OpDesc(
                        type="distributed_lookup_table",
                        inputs={"Ids": list(op.input("Ids"))},
                        outputs={"Out": list(op.output("Out"))},
                        attrs={"table_name": w,
                               "endpoints": list(self.endpoints),
                               "dim": tm["dim"], "dtype": tm["dtype"],
                               "padding_idx": op.attr("padding_idx", -1),
                               "op_role": "dist"}))
                elif op.type == "lookup_table_grad" and \
                        w in self.table_meta:
                    tm = self.table_meta[w]
                    # the W@GRAD this op would have produced no longer
                    # exists — remember it so grad-accumulation sum ops
                    # over it (shared tables looked up twice,
                    # backward.py dedup) are dropped below
                    dangling.update(
                        n for n in op.outputs.get("W@GRAD_SLOT", []) if n)
                    new_ops.append(OpDesc(
                        type="distributed_table_push",
                        inputs={"Ids": list(op.input("Ids")),
                                "OutGrad": list(
                                    op.input("__outgrad__Out"))},
                        outputs={},
                        attrs={"table_name": w,
                               "endpoints": list(self.endpoints),
                               "dim": tm["dim"],
                               "padding_idx": op.attr("padding_idx", -1),
                               "trainer_id": self.trainer_id,
                               "op_role": "dist"}))
                else:
                    new_ops.append(op)
            if dangling:
                # transitively drop ops all of whose inputs dangle (the
                # sum op merging two replaced table grads, then anything
                # reading its output — normally nothing, since the only
                # consumer was the stripped sgd op)
                pruned = []
                for op in new_ops:
                    ins = [n for n in op.input_names() if n]
                    if ins and all(n in dangling for n in ins):
                        dangling.update(n for n in op.output_names() if n)
                        continue
                    pruned.append(op)
                new_ops = pruned
            block.ops = new_ops
        # sends (after backward — ops are appended at the end); a sliced
        # param sends one row-range of its grad per block
        for unit, ep in self.param_endpoint.items():
            src, row0, rows = self.unit_src[unit]
            g = self._param_grad.get(src)
            if not g:
                continue
            attrs = {"endpoint": ep, "param_name": unit,
                     "trainer_id": self.trainer_id, "op_role": "dist"}
            if rows >= 0:
                attrs["row_begin"] = int(row0)
                attrs["row_end"] = int(row0 + rows)
            block.append_op(OpDesc(
                type="send", inputs={"X": [g]}, outputs={}, attrs=attrs))
        block.append_op(OpDesc(
            type="send_barrier", inputs={}, outputs={},
            attrs={"endpoints": list(self.endpoints), "op_role": "dist"}))
        # recvs run FIRST each step: forward computes on the fresh round.
        # Sliced params recv per block, then concat-on-recv rebuilds the
        # whole param right after the barrier (reference recv-splice).
        from ..core.desc import VarDesc
        pos = 0
        for unit, ep in sorted(self.param_endpoint.items()):
            src, row0, rows = self.unit_src[unit]
            if rows >= 0 and not block.find_var(unit):
                svd = block.find_var(src)
                block.add_var(VarDesc(
                    name=unit,
                    shape=(rows,) + tuple(svd.shape[1:]),
                    dtype=svd.dtype))
            block.insert_op(pos, OpDesc(
                type="recv", inputs={}, outputs={"Out": [unit]},
                attrs={"endpoint": ep, "param_name": unit,
                       "op_role": "dist"}))
            pos += 1
        block.insert_op(pos, OpDesc(
            type="fetch_barrier", inputs={}, outputs={},
            attrs={"endpoints": list(self.endpoints), "op_role": "dist"}))
        pos += 1
        for p in sorted(self.slices):
            block.insert_op(pos, OpDesc(
                type="concat",
                inputs={"X": [s["block"] for s in self.slices[p]]},
                outputs={"Out": [p]},
                attrs={"axis": 0, "op_role": "dist"}))
            pos += 1
        prog.sync_with_desc()
        return prog

    # ------------------------------------------------------------- pserver
    def get_pserver_program(self, endpoint: str) -> Program:
        """A program whose single op is listen_and_serv; its attrs carry
        everything Executor.run_pserver needs (reference
        get_pserver_program :477 builds optimize sub-blocks the same
        way)."""
        params = sorted(p for p, ep in self.param_endpoint.items()
                        if ep == endpoint)
        prog = Program()
        block = prog.desc.block(0)
        src = self.origin_program.desc.block(0)
        opt_meta = {}
        slice_meta = {}
        for unit in params:
            # per-unit optimize mini-program: declares param (persistable)
            # + grad (feed) + aux vars, runs the captured optimize ops.
            # For a BLOCK unit, every var the ops touch is renamed
            # `<name>.block<i>` and param-shaped vars get block-row shapes
            # (written scalars like beta pows are per-block copies, so two
            # blocks of one param never double-step shared state).
            p, row0, rows = self.unit_src[unit]
            mini = Program()
            mb = mini.desc.block(0)
            g = self._param_grad[p]
            pvd = src.find_var(p)
            full_rows = int(pvd.shape[0]) if pvd.shape else 0
            blk_idx = unit[len(p):] if rows >= 0 else ""   # ".block<i>"
            needed = set()
            for op in self._opt_ops.get(p, []):
                needed.update(op.input_names())
                needed.update(op.output_names())
            written = set()
            for op in self._opt_ops.get(p, []):
                written.update(op.output_names())
            lr_names = set()
            for op in self._opt_ops.get(p, []):
                lr_names.update(op.input("LearningRate"))

            def unit_name(n):
                if rows < 0 or n in lr_names:
                    return n            # whole param, or shared read-only lr
                if n == p or n == g or n in written:
                    return n + blk_idx
                vd = src.find_var(n)
                if vd is not None and vd.shape and \
                        int(vd.shape[0]) == full_rows:
                    return n + blk_idx  # param-shaped read (rare)
                return n

            var_map = {}
            for n in sorted(needed):
                vd = src.find_var(n)
                if vd is None:
                    continue
                nn = unit_name(n)
                nv = mb.add_var(type(vd).from_dict(
                    dict(vd.to_dict(), name=nn)))
                if nn != n and vd.shape and int(vd.shape[0]) == full_rows:
                    nv.shape = (rows,) + tuple(vd.shape[1:])
                nv.persistable = (n != g)       # grad is fed per round
                var_map[n] = nn
            for op in self._opt_ops.get(p, []):
                od = OpDesc.from_dict(op.to_dict())
                for names in list(od.inputs.values()) + \
                        list(od.outputs.values()):
                    for k, n in enumerate(names):
                        names[k] = var_map.get(n, unit_name(n) if n else n)
                mb.append_op(od)
            mini.sync_with_desc()
            opt_meta[unit] = (mini, var_map.get(g, g))
            if rows >= 0:
                slice_meta[unit] = {
                    "src": p, "row0": int(row0), "rows": int(rows),
                    "full_rows": full_rows,
                    "vars": {n: nn for n, nn in var_map.items()
                             if nn != n and n != g}}
        # lr-schedule ops (optimize-role ops with no Param) run ONCE per
        # round before the param updates (reference puts them in the
        # pserver's global block, get_pserver_program :477+)
        lr_prog = None
        if self._lr_ops:
            lr_prog = Program()
            lb = lr_prog.desc.block(0)
            lr_needed = set()
            for op in self._lr_ops:
                lr_needed.update(op.input_names())
                lr_needed.update(op.output_names())
            for n in sorted(lr_needed):
                vd = src.find_var(n)
                if vd is not None:
                    nv = lb.add_var(type(vd).from_dict(vd.to_dict()))
                    nv.persistable = True
            for op in self._lr_ops:
                lb.append_op(OpDesc.from_dict(op.to_dict()))
            lr_prog.sync_with_desc()
        ls = OpDesc(type="listen_and_serv", inputs={}, outputs={},
                    attrs={"endpoint": endpoint,
                           "params": params,
                           "trainers": self.trainers,
                           "sync_mode": self.sync_mode,
                           "op_role": "dist"})
        block.append_op(ls)
        prog.sync_with_desc()
        prog._pserver_meta = {                  # consumed by run_pserver
            "endpoint": endpoint, "params": params,
            "optimize_programs": opt_meta, "trainers": self.trainers,
            "sync_mode": self.sync_mode, "lr_program": lr_prog,
            # block units: startup initializes FULL params/accumulators;
            # run_pserver carves this server's row ranges out
            # (slice_param_blocks)
            "slices": slice_meta,
            # every pserver holds one row-shard of every distributed table
            "tables": {
                w: {"vocab": tm["vocab"], "dim": tm["dim"],
                    "lr": tm["lr"],
                    "shard_id": self.endpoints.index(endpoint),
                    "num_shards": len(self.endpoints)}
                for w, tm in self.table_meta.items()},
        }
        return prog

    def get_startup_program(self, endpoint: str,
                            pserver_program: Program) -> Program:
        """Init ops for this pserver's params + their optimizer
        accumulators (reference :701) — copied from the trainer startup
        program so pserver round-0 values equal the trainer's."""
        if self.startup_program is None:
            raise ValueError("pass startup_program to transpile() first")
        # block units initialize through their SOURCE param's init ops —
        # run_pserver slices the rows out afterwards
        params = {self.unit_src[u][0]
                  for u in pserver_program._pserver_meta["params"]}
        # distributed tables init their full tensor here too; the server
        # slices its row shard out at construction (Executor.run_pserver)
        params |= set(pserver_program._pserver_meta.get("tables", {}))
        # accumulators (adam moments etc.) and lr-schedule state are
        # startup-initialized too
        aux = set()
        for p in params:
            for op in self._opt_ops.get(p, []):
                for n in op.input_names():
                    aux.add(n)
        for op in self._lr_ops:
            aux.update(op.input_names())
            aux.update(op.output_names())
        keep = params | aux
        prog = _clone(self._pserver_startup_src)
        block = prog.desc.block(0)
        block.ops = [op for op in block.ops
                     if any(o in keep for o in op.output_names())]
        prog.sync_with_desc()
        return prog


def _clone(program: Program) -> Program:
    from ..core.desc import ProgramDesc
    desc = ProgramDesc.from_dict(program.desc.to_dict())
    p = Program()
    p.desc = desc
    p.blocks = [Block(p, i) for i in range(desc.num_blocks())]
    p.sync_with_desc()
    p.random_seed = program.random_seed
    p.amp = getattr(program, "amp", False)
    return p


_SEEDED_INIT_OPS = ("uniform_random", "gaussian_random",
                    "truncated_gaussian_random")


def _stamp_init_seeds(startup_program: Program):
    """Give every random init op a deterministic per-variable seed, so a
    pserver's FILTERED startup clone produces bit-identical values to the
    trainer's full startup (sequential key-splitting would diverge when
    ops are dropped).  The reference reaches the same property through
    per-op seed attrs on its initializer ops."""
    import zlib
    block = startup_program.desc.block(0)
    for op in block.ops:
        if op.type in _SEEDED_INIT_OPS and not op.attr("seed", 0):
            name = (op.output_names() or ["?"])[0]
            op.attrs["seed"] = (zlib.crc32(name.encode()) & 0x7FFFFFFF) or 1
