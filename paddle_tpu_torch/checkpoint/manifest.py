"""Checkpoint manifest: the jax-free source of truth for one checkpoint.

A checkpoint directory is payload (one ``shard_r<rank>.npz`` per writing
rank) plus ONE ``manifest.json`` describing everything a reader needs
without deserializing any tensor: program fingerprint, SpecLayout
fingerprint, mesh shape, per-var shape/dtype/spec/slot_of, the chunk map
(which npz key holds which global index range of which var, per rank),
and the trainer resume state.  The manifest is written LAST (tmp-write →
rename), so a directory containing a parseable manifest is a committed
checkpoint by construction — the same commit discipline as the compile
cache index (cache_hygiene.py).

Deliberately stdlib-only at import (numpy only inside payload helpers).
A copy of the JAX package's manifest module, with the same format tags,
so a directory either package writes is read by the other.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_NAME = "manifest.json"
PROGRAM_NAME = "program.json"
FORMAT = "paddle_tpu-ckpt-v1"
#: manifest format tag for a legacy flat ``__params__.npz`` dir wrapped by
#: the io.py shim (one rank, one whole-array chunk per var)
FLAT_FORMAT = "paddle_tpu-flat-v1"

CKPT_PREFIX = "ckpt_"

__all__ = [
    "MANIFEST_NAME", "PROGRAM_NAME", "FORMAT", "FLAT_FORMAT", "CKPT_PREFIX",
    "CheckpointError", "shard_filename", "checkpoint_dir", "list_steps",
    "latest_step", "write_manifest", "read_manifest", "try_read_manifest",
    "validate_shards", "chunk_slices", "read_chunks", "device_bytes",
    "persistent_device_bytes",
]


class CheckpointError(RuntimeError):
    """A checkpoint directory is missing, uncommitted, or inconsistent
    with its manifest (incomplete shard coverage, shape drift, …)."""


def shard_filename(rank: int) -> str:
    return f"shard_r{int(rank)}.npz"


def checkpoint_dir(root: str, step: int) -> str:
    return os.path.join(root, f"{CKPT_PREFIX}{int(step)}")


def list_steps(root: str) -> List[int]:
    """Committed checkpoint steps under ``root`` (ascending).  A dir
    without a parseable manifest is an uncommitted torso (a writer died
    mid-save) and is not listed."""
    out = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        if not name.startswith(CKPT_PREFIX):
            continue
        try:
            step = int(name[len(CKPT_PREFIX):])
        except ValueError:
            continue
        if os.path.isfile(os.path.join(root, name, MANIFEST_NAME)):
            out.append(step)
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = list_steps(root)
    return steps[-1] if steps else None


# ------------------------------------------------------------- read/write

def write_manifest(dirname: str, manifest: Dict[str, Any]) -> str:
    """Atomically write ``manifest.json`` (tmp-write → rename) — the
    commit point of a checkpoint: readers treat a dir without it as
    nonexistent."""
    manifest = dict(manifest)
    manifest.setdefault("format", FORMAT)
    manifest.setdefault("created", time.time())
    path = os.path.join(dirname, MANIFEST_NAME)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_manifest(dirname: str) -> Dict[str, Any]:
    path = os.path.join(dirname, MANIFEST_NAME)
    try:
        with open(path) as f:
            m = json.load(f)
    except OSError as e:
        raise CheckpointError(
            f"no committed checkpoint at {dirname!r} (missing "
            f"{MANIFEST_NAME}: {e})") from None
    except ValueError as e:
        raise CheckpointError(
            f"corrupt manifest at {path!r}: {e}") from None
    if not isinstance(m, dict) or "vars" not in m:
        raise CheckpointError(f"manifest at {path!r} has no 'vars' table")
    return m


def try_read_manifest(dirname: str) -> Optional[Dict[str, Any]]:
    """The manifest, or None when the dir carries none / an unparseable
    one — the io.py shim's probe (legacy flat dirs have no manifest)."""
    try:
        return read_manifest(dirname)
    except CheckpointError:
        return None


# ------------------------------------------------------------- validation

def chunk_slices(index, shape) -> Tuple[slice, ...]:
    """A chunk's manifest index ([[start, stop] | null per dim], or null
    for the whole array) as a tuple of slices into the global array."""
    if index is None:
        return tuple(slice(0, int(d)) for d in shape)
    out = []
    for ent, d in zip(index, shape):
        if ent is None:
            out.append(slice(0, int(d)))
        else:
            out.append(slice(int(ent[0]), int(ent[1])))
    return tuple(out)


def _volume(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def validate_shards(dirname: str, manifest: Optional[Dict[str, Any]] = None,
                    check_payload: bool = True) -> Dict[str, Any]:
    """Check shard completeness across ranks: every shard file the
    manifest names exists, every var is FULLY covered by its chunks
    (chunk volumes sum to the var volume, chunks stay in bounds and are
    pairwise disjoint), and — with ``check_payload`` — every chunk key
    exists in its npz with the declared shape.  Raises
    :class:`CheckpointError` on the first inconsistency; returns a
    summary dict (vars, chunks, ranks, payload bytes)."""
    manifest = manifest or read_manifest(dirname)
    shards = manifest.get("shards") or {}
    var_meta = manifest.get("vars") or {}
    # var -> [(rank, key, slices)]
    cover: Dict[str, List[Tuple[str, str, Tuple[slice, ...]]]] = {}
    payload_bytes = 0
    keys_by_rank: Dict[str, Dict[str, tuple]] = {}
    for rank, info in shards.items():
        fname = info.get("file") or shard_filename(int(rank))
        path = os.path.join(dirname, fname)
        if not os.path.isfile(path):
            raise CheckpointError(
                f"shard file {fname!r} (rank {rank}) named by the manifest "
                f"is missing from {dirname!r}")
        payload_bytes += os.path.getsize(path)
        if check_payload:
            import numpy as np
            with np.load(path, allow_pickle=False) as data:
                keys_by_rank[rank] = {k: tuple(data[k].shape)
                                      for k in data.files}
        for name, chunks in (info.get("chunks") or {}).items():
            meta = var_meta.get(name)
            if meta is None:
                raise CheckpointError(
                    f"rank {rank} carries chunks of {name!r} but the "
                    f"manifest vars table does not list it")
            shape = meta["shape"]
            for ch in chunks:
                sl = chunk_slices(ch.get("index"), shape)
                for s, d in zip(sl, shape):
                    if s.start < 0 or s.stop > int(d) or s.start >= s.stop:
                        raise CheckpointError(
                            f"{name!r} chunk {ch.get('key')} index "
                            f"{ch.get('index')} out of bounds for shape "
                            f"{shape}")
                cover.setdefault(name, []).append(
                    (rank, ch.get("key") or name, sl))
                if check_payload:
                    have = keys_by_rank[rank].get(ch.get("key") or name)
                    want = tuple(int(s.stop - s.start) for s in sl)
                    if have is None:
                        raise CheckpointError(
                            f"{name!r} chunk key {ch.get('key')!r} missing "
                            f"from {fname!r}")
                    if have != want:
                        raise CheckpointError(
                            f"{name!r} chunk {ch.get('key')!r} in {fname!r} "
                            f"has shape {have}, manifest says {want}")
    n_chunks = 0
    for name, meta in var_meta.items():
        chunks = cover.get(name)
        if not chunks:
            raise CheckpointError(
                f"var {name!r} has no chunks in any rank's shard "
                f"(incomplete checkpoint — a writing rank is missing?)")
        n_chunks += len(chunks)
        total = sum(_volume(s.stop - s.start for s in sl)
                    for _, _, sl in chunks)
        want = _volume(meta["shape"])
        if total != want:
            raise CheckpointError(
                f"var {name!r} chunks cover {total} elements of {want} "
                f"(shape {meta['shape']}) — missing or overlapping ranks")
        # pairwise disjointness (chunk counts are small: one per shard)
        for i in range(len(chunks)):
            for j in range(i + 1, len(chunks)):
                a, b = chunks[i][2], chunks[j][2]
                if all(sa.start < sb.stop and sb.start < sa.stop
                       for sa, sb in zip(a, b)) and a:
                    raise CheckpointError(
                        f"var {name!r} chunks {chunks[i][1]!r} and "
                        f"{chunks[j][1]!r} overlap")
    return {"vars": len(var_meta), "chunks": n_chunks,
            "ranks": len(shards), "payload_bytes": payload_bytes}


# --------------------------------------------------------------- payload

def read_chunks(dirname: str, manifest: Dict[str, Any],
                names: Optional[List[str]] = None) -> Dict[str, Any]:
    """Reassemble the requested vars (default: all) from every rank's
    shard file into full host numpy arrays, stored-dtype (bfloat16 rides
    as its uint16 view; the caller views it back — io.py convention)."""
    import numpy as np

    var_meta = manifest.get("vars") or {}
    want = set(names) if names is not None else set(var_meta)
    out: Dict[str, Any] = {}
    filled: Dict[str, int] = {}
    for rank, info in (manifest.get("shards") or {}).items():
        fname = info.get("file") or shard_filename(int(rank))
        chunks = info.get("chunks") or {}
        if not (want & set(chunks)):
            continue
        path = os.path.join(dirname, fname)
        with np.load(path, allow_pickle=False) as data:
            for name in want & set(chunks):
                meta = var_meta[name]
                shape = tuple(int(d) for d in meta["shape"])
                for ch in chunks[name]:
                    arr = data[ch.get("key") or name]
                    sl = chunk_slices(ch.get("index"), shape)
                    if sl == tuple(slice(0, d) for d in shape) \
                            and len(chunks[name]) == 1:
                        out[name] = arr
                    else:
                        buf = out.get(name)
                        if buf is None:
                            buf = out[name] = np.empty(shape, arr.dtype)
                        buf[sl] = arr
                    filled[name] = filled.get(name, 0) + arr.size
    missing = [n for n in sorted(want)
               if filled.get(n, 0) != _volume(var_meta[n]["shape"])]
    if missing:
        raise CheckpointError(
            f"incomplete payload for {missing[:8]} — run validate_shards "
            f"for the per-chunk detail")
    return out


# ------------------------------------------------------------- fit math

class _MeshShim:
    """Duck-typed mesh for SpecLayout.spec_for: only ``.shape`` (an
    ``{axis: size}`` dict) is consulted."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)


_DTYPE_BYTES = {"bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
                "int32": 4, "uint32": 4, "int64": 8, "float16": 2,
                "bfloat16": 2, "float32": 4, "float64": 8}


def device_bytes(shape, dtype: str, spec, mesh_shape: Optional[Dict[str,
                 int]], x64: bool = False) -> int:
    """Per-device bytes of one tensor under a PartitionSpec-style spec
    and an ``{axis: size}`` mesh — ceil-division per sharded dim (the
    memory planner's pad-accounting rule)."""
    itemsize = _DTYPE_BYTES.get(str(dtype), 4)
    if not x64 and itemsize == 8:
        itemsize = 4
    dims = [int(d) for d in shape]
    if spec and mesh_shape:
        for i, entry in enumerate(spec[:len(dims)]):
            if entry is None:
                continue
            axes = entry if isinstance(entry, (list, tuple)) else (entry,)
            div = 1
            for a in axes:
                div *= int(mesh_shape.get(str(a), 1))
            dims[i] = -(-dims[i] // max(1, div))
    return _volume(dims) * itemsize


def persistent_device_bytes(manifest: Dict[str, Any],
                            mesh_shape: Optional[Dict[str, int]] = None,
                            layout=None) -> Dict[str, Any]:
    """Per-device byte cost of restoring this checkpoint's state onto a
    TARGET topology — the manifest-only restore-fit estimate (no program
    needed): each var's global shape divided by the spec the target
    layout would assign it.  ``layout`` is a SpecLayout (or None: the
    specs recorded in the manifest, which describe the SOURCE topology,
    are NOT reused — absent a layout the state restores replicated)."""
    shim = _MeshShim(mesh_shape) if mesh_shape else None
    var_meta = manifest.get("vars") or {}

    def find_vd(name):
        m = var_meta.get(name)
        if m is None:
            return None
        return _MetaVarDesc(m)

    total = 0
    per_var: Dict[str, int] = {}
    for name, meta in var_meta.items():
        spec = None
        if layout is not None and shim is not None:
            try:
                spec = layout.spec_for(name, meta["shape"], shim,
                                       slot_of=meta.get("slot_of"),
                                       param_lookup=find_vd,
                                       role=meta.get("role"))
            except Exception:  # noqa: BLE001 — replicate on failure
                spec = None
        b = device_bytes(meta["shape"], meta.get("dtype", "float32"), spec,
                         mesh_shape)
        per_var[name] = b
        total += b
    return {"persistent_bytes": total, "per_var": per_var,
            "num_devices": _volume((mesh_shape or {}).values() or (1,))}


class _MetaVarDesc:
    """Manifest var row quacking like a VarDesc for spec_for's
    ``param_lookup`` (``.shape`` plus the ``layout_role`` attr a
    sharded-embedding slot inherits through ``slot_of``)."""

    def __init__(self, meta: Dict[str, Any]):
        self.shape = tuple(int(d) for d in meta["shape"])
        self.attrs = {"layout_role": meta.get("role")} \
            if meta.get("role") else {}
