"""Checkpoint / model IO (Fluid's python/paddle/fluid/io.py), ported from
the JAX package with its file formats: tensors go into one numpy ``.npz``
(``__params__.npz``, bf16 stored as its raw uint16 view with a
``__meta__`` dtype map), a ``manifest.json`` in the checkpoint schema rides
beside it (``checkpoint/manifest.py``), and the program goes into
``__model__.json`` (``core/desc.py``'s JSON).  A directory either package
saves loads in the other.

Values are read from and written to the global scope (``scope_guard``
swaps it).  A load copies into the tensor the scope already holds under
the name (``copy_``) wherever its shape and dtype fit, so each state
tensor keeps its address: the CUDA graphs the executor captured read state
by address, and a rebind would force a new capture of each of them (and
the memory of two pools).  A name the scope does not hold yet is bound to
a new tensor on the executor's device.

Not ported: the StableHLO artifact of ``save_inference_model``
(``export_compiled``; ``CompiledPredictor``), which is jax's
serialization.  ``save_inference_model`` writes the program and the
parameters and warns, as the JAX package does when its export fails: a
CUDA graph cannot be saved across processes, so it has no counterpart.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from .core.desc import ProgramDesc
from .core.dtypes import convert_dtype
from .core.framework import Block, Parameter, Program, Variable, default_main_program
from .core.scope import global_scope

MODEL_FILENAME = "__model__.json"
PARAMS_FILENAME = "__params__.npz"


def _is_persistable(var: Variable) -> bool:
    return var.persistable


def _to_numpy(value):
    """A scope tensor as the C-ordered host array the JAX package writes
    (``np.ascontiguousarray``: a 0-d value is stored with shape (1,)), and
    its dtype name; bf16 as its uint16 view."""
    t = value.detach()
    if t.dtype == torch.bfloat16:
        return np.ascontiguousarray(t.view(torch.int16).cpu().numpy().view(np.uint16)), \
            "bfloat16"
    arr = np.ascontiguousarray(t.cpu().numpy())
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _place(scope, executor, name: str, value: torch.Tensor):
    """Put a loaded value under ``name``: copied into the scope's tensor
    when one of the same element count and dtype is there (it keeps its
    address), else bound as a new tensor on that tensor's device or the
    executor's."""
    have = scope.find_var(name)
    if isinstance(have, torch.Tensor) and have.dtype == value.dtype \
            and have.numel() == value.numel():
        have.copy_(value.reshape(have.shape))
        return
    if isinstance(have, torch.Tensor):
        device = have.device
    elif executor is not None:
        device = executor.device
    else:
        raise ValueError(f"loading {name!r}: the scope holds no tensor to copy into and "
                         f"no executor was given to place a new one")
    scope.update_var(name, value.to(device))


def save_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None):
    """Fluid's io.py:128 save_vars: the vars' scope values into one npz."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate or _is_persistable)(v)]
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    payload, meta = {}, {}
    for v in vars:
        val = scope.find_var(v.name)
        if not isinstance(val, torch.Tensor):
            continue
        arr, dt = _to_numpy(val)
        payload[v.name] = arr
        meta[v.name] = dt
    path = os.path.join(dirname, filename or PARAMS_FILENAME)
    np.savez(path, __meta__=json.dumps(meta), **payload)
    return path


def load_vars(executor, dirname: str, main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None, predicate=None,
              filename: Optional[str] = None):
    """Fluid's io.py:220 load_vars: each var the npz holds, into the scope."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if (predicate or _is_persistable)(v)]
    scope = global_scope()
    path = os.path.join(dirname, filename or PARAMS_FILENAME)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        for v in vars:
            if v.name not in data:
                continue
            _place(scope, executor, v.name, _from_numpy(data[v.name], meta.get(v.name)))


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: isinstance(v, Parameter),
                     filename=filename)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=lambda v: isinstance(v, Parameter),
                     filename=filename)


def _write_flat_manifest(dirname: str, main_program: Program, payload_file: str):
    """Next to the flat ``__params__.npz`` payload, a ``manifest.json`` in
    the checkpoint schema (per-var shape and dtype, one whole-array chunk
    per var, the program's fingerprint), so every ``save_persistables``
    directory is also a manifest checkpoint."""
    from .checkpoint import manifest as _manifest

    block = main_program.desc.block(0)
    var_meta, chunks = {}, {}
    scope = global_scope()
    for name, vd in block.vars.items():
        if not vd.persistable:
            continue
        v = scope.find_var(name)
        if not isinstance(v, torch.Tensor):
            continue
        shape = tuple(v.shape)
        # the payload stores what _to_numpy wrote: a 0-d value as shape (1,)
        var_meta[name] = {
            "shape": [int(d) for d in shape] if shape else [1],
            "dtype": convert_dtype(v.dtype).value,
            "slot_of": vd.attrs.get("slot_of"),
            "is_parameter": bool(vd.is_parameter),
            "spec": vd.attrs.get("sharding"),
        }
        chunks[name] = [{"key": name, "index": None}]
    if not var_meta:
        return
    _manifest.write_manifest(dirname, {
        "format": _manifest.FLAT_FORMAT,
        "step": 0,
        "program_fp": main_program.desc.fingerprint(),
        "vars": var_meta,
        "shards": {"0": {"file": payload_file, "chunks": chunks}},
    })


def save_persistables(executor, dirname, main_program=None, filename=None):
    """The flat-npz persistable save, and the manifest beside it."""
    main_program = main_program or default_main_program()
    path = save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)
    _write_flat_manifest(dirname, main_program, os.path.basename(path))
    return path


def load_persistables(executor, dirname, main_program=None, filename=None):
    """Load persistables through the manifest where the directory has one
    (shapes validated, a multi-file payload reassembled), else through the
    flat npz.  Each value is copied into the scope's tensor (see the
    module docstring)."""
    from .checkpoint import manifest as _manifest

    m = _manifest.try_read_manifest(dirname)
    if m is not None:
        files = {info.get("file") for info in (m.get("shards") or {}).values()}
        if filename is not None and files != {filename}:
            m = None          # the caller names another payload file
    if m is None:
        return load_vars(executor, dirname, main_program,
                         predicate=_is_persistable, filename=filename)
    main_program = main_program or default_main_program()
    scope = global_scope()
    want = [v.name for v in main_program.list_vars()
            if _is_persistable(v) and v.name in (m.get("vars") or {})]
    arrays = _manifest.read_chunks(dirname, m, want)
    for name, arr in arrays.items():
        _place(scope, executor, name, _from_numpy(arr, m["vars"][name].get("dtype")))
    # persistables the manifest does not cover (a directory written by
    # several saves of different programs) come from the flat npz
    missing = [v for v in main_program.list_vars()
               if _is_persistable(v) and v.name not in arrays]
    if missing:
        load_vars(executor, dirname, main_program, vars=missing, filename=filename)


def save_train_model(dirname: str, feeded_var_names: List[str],
                     fetch_vars: List[Variable], executor,
                     main_program: Optional[Program] = None):
    """Save the whole training program (forward, backward and optimizer
    ops, unpruned) and its persistables: the input of the JAX package's
    native training demo."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": main_program.desc.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name for v in fetch_vars],
    }
    with open(os.path.join(dirname, MODEL_FILENAME), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, main_program)
    return dirname


def save_inference_model(dirname: str, feeded_var_names: List[str],
                         target_vars: List[Variable], executor,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         export_compiled: bool = True):
    """Fluid's io.py:561: prune the program to the fetch targets, save the
    program and its persistables.  ``export_compiled`` asks for the JAX
    package's StableHLO artifact, which is not ported: the rest is saved
    and a warning says so, as the JAX package does when its export fails."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    target_names = [v.name for v in target_vars]
    pruned = main_program._prune(target_names)
    meta = {
        "program": pruned.desc.to_dict(),
        "feed_names": list(feeded_var_names),
        "fetch_names": target_names,
    }
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, filename=params_filename)
    if export_compiled:
        warnings.warn("the StableHLO artifact (export_compiled) is not ported; the JSON "
                      "program + params were saved and load_inference_model reads them",
                      stacklevel=2)
    return dirname


def load_inference_model(dirname: str, executor,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None):
    """Fluid's io.py:677: returns (program, feed_names, fetch_vars)."""
    with open(os.path.join(dirname, model_filename or MODEL_FILENAME)) as f:
        meta = json.load(f)
    program = Program()
    program.desc = ProgramDesc.from_dict(meta["program"])
    program.blocks = [Block(program, i) for i in range(program.desc.num_blocks())]
    program.sync_with_desc()
    load_persistables(executor, dirname, program, filename=params_filename)
    fetch_vars = [program.global_block.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars
