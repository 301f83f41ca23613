#!/usr/bin/env python3
"""Where K3's time goes on the card.  The embedding scatter-add
(csrc/embedding_scatter_add.cu: ``sort_kernel``, then
``segment_sums_kernel``) is built from this checkout's source as it is and
with parts of it changed by text substitution, and each build is timed
(CUDA events over back-to-back calls, and the device time of each kernel
from ``torch.profiler``) at the training step's shapes, float32 and bf16:

    python3 paddle_tpu_torch/tools/k3_split.py

Cases: the word table [32000, 512] with 16384 uniform ids ("uniform"), the
same with a quarter of the ids 0 ("padded", one segment of ~4100 ids), the
training feed's own source ids ("feed", as chip_smoke.py's ``_train_feed``
makes them), and the position table [256, 512] with arange(256) tiled 64
times ("positions").

Variants:
  as_built     the kernel as the port runs it;
  timeline     as built, with the global timer read at each phase's end by
               block 0 (the sort's histogram and scatter phases of each
               pass, the offsets, the segment kernel's start, long block
               0's end) and by the last row block at its end; one call
               after a synchronize;
  fixed_slice  every long work item 32 columns wide (no narrower slices
               when the long segments are few);
  tile2048     sort tiles of 2048 ids (8 rounds a warp), not 512;
  rows_only    the long blocks do nothing (wrong by design);
  long_only    the row blocks do nothing (wrong by design).
Every variant's output is compared with as_built's ("same": bit-equal).
Prints a line a (dtype, case, variant), then one JSON line.  Needs one CUDA
GPU and nvcc.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC = os.path.join(HERE, "paddle_tpu_torch", "csrc", "embedding_scatter_add.cu")


def _stamp(i, cond):
    return ("if (" + cond + ") { unsigned long long g_; asm volatile(\"mov.u64 %0, "
            "%%globaltimer;\" : \"=l\"(g_)); k3_t[" + str(i) + "] = g_; }\n")


_B0 = "blockIdx.x == 0 && threadIdx.x == 0"
# timeline slots: 0 sort start, 1 + 2p / 2 + 2p pass p's histogram / scatter
# phase, 7 offsets, 8 segment kernel start, 9 long block 0's end, 11 the
# last row block's end
TIMELINE = [
    ("namespace {\n\nnamespace cg = cooperative_groups;",
     "__device__ unsigned long long k3_t[16];\nnamespace {\n\nnamespace cg = cooperative_groups;"),
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  " + _stamp(0, _B0)),
    ("    grid.sync();\n    for (int tile",
     "    grid.sync();\n    " + _stamp("1 + 2 * p", _B0) + "    for (int tile"),
    ("    grid.sync();\n    src_keys = dk;",
     "    grid.sync();\n    " + _stamp("2 + 2 * p", _B0) + "    src_keys = dk;"),
    ("    row_offsets(src_keys, m, p0 + threadIdx.x, static_cast<int>(v), start, longs, nlong);\n}",
     "    row_offsets(src_keys, m, p0 + threadIdx.x, static_cast<int>(v), start, longs, nlong);\n  "
     + _stamp(7, _B0) + "}"),
    ("  if (blockIdx.x < long_blocks) {\n", "  " + _stamp(8, _B0) + "  if (blockIdx.x < long_blocks) {\n"),
    ("      long_block<T, kVec, 8>(S, idx, start, longs, n_long, rows, out, d, long_blocks);\n",
     "      long_block<T, kVec, 8>(S, idx, start, longs, n_long, rows, out, d, long_blocks);\n    "
     + _stamp(9, _B0)),
    ("    if (hi - lo <= kLong) add_short<T, kVec>(idx, lo, hi, rows, out + (r0 + i) * d, d);\n  }\n}\n",
     "    if (hi - lo <= kLong) add_short<T, kVec>(idx, lo, hi, rows, out + (r0 + i) * d, d);\n  }\n  "
     + _stamp(11, "blockIdx.x == gridDim.x - 1 && threadIdx.x == 0") + "}\n"),
    ("extern \"C\" int ptt_scatter_add_rows_f32(",
     "extern \"C\" int ptt_k3_times(unsigned long long* out) {\n"
     "  return static_cast<int>(cudaMemcpyFromSymbol(out, k3_t, sizeof(k3_t)));\n}\n"
     "extern \"C\" int ptt_scatter_add_rows_f32("),
]
VARIANTS = {
    "as_built": [],
    "timeline": TIMELINE,
    "fixed_slice": [("  int cols = 32;\n  while (", "  int cols = 32;\n  while (false && ")],
    "tile2048": [("constexpr int kRounds = 2; ", "constexpr int kRounds = 8; ")],
    "rows_only": [("  if (b >= items) return;\n", "  return;\n")],
    "long_only": [("  if (r0 >= v) return;\n", "  return;\n")],
}
PHASES = {1: "pass 0 histogram", 2: "pass 0 scatter", 3: "pass 1 histogram",
          4: "pass 1 scatter", 7: "offsets", 8: "segment kernel start",
          9: "long block 0 end", 11: "last row block end"}


def build_variants(build):
    """One shared library per variant under build/k3_split/, the nvcc
    processes started together; returns {name: path}."""
    src = open(SRC).read()
    nvcc = build._nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"k3_split: variant {name}: the source no longer holds "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        out = os.path.join(HERE, "build", "k3_split", name)
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "k3.cu"), "w") as f:
            f.write(text)
        lib = os.path.join(out, "libk3.so")
        cmd = [nvcc, *flags, "-shared", "-o", lib, os.path.join(out, "k3.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"k3_split: building {name} failed:\n{log}")
        libs[name] = lib
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k3_split: no CUDA device")
    sys.path.insert(0, HERE)
    import numpy as np
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.ops.cuda.embedding import _scratch_ints
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = {}
    for name, path in build_variants(build).items():
        lib = ctypes.CDLL(path)
        for sym in ("ptt_scatter_add_rows_f32", "ptt_scatter_add_rows_bf16"):
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    n = cs.TRAIN_B * cs.T
    cases = {}
    for case in ("uniform", "padded", "feed", "positions"):
        vocab = cs.T if case == "positions" else cs.VOCAB
        if case == "positions":
            ids = torch.arange(cs.T, dtype=torch.int32).repeat(cs.TRAIN_B)
        elif case == "feed":
            ids = torch.from_numpy(cs._train_feed(cs.TRAIN_B, 0)["src"].reshape(-1).astype(np.int32))
        else:
            ids = torch.randint(0, vocab, (n,), generator=g, dtype=torch.int32)
            if case == "padded":
                ids[torch.rand(n, generator=g) < 0.25] = 0
        cases[case] = (vocab, ids.to(dev), torch.randn(n, cs.D_MODEL, generator=g).to(dev))
    res = {}
    for dt, sym in ((torch.bfloat16, "ptt_scatter_add_rows_bf16"),
                    (torch.float32, "ptt_scatter_add_rows_f32")):
        for case, (vocab, ids, rows32) in cases.items():
            rows = rows32.to(dt)
            ref = None
            for name, lib in libs.items():
                out = torch.empty(vocab, cs.D_MODEL, dtype=dt, device=dev)
                scratch = torch.empty(_scratch_ints(n, vocab), dtype=torch.int32, device=dev)
                fn = getattr(lib, sym)

                def call():
                    rc = fn(ids.data_ptr(), rows.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                            n, vocab, cs.D_MODEL, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"k3_split {name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                if ref is None:
                    ref = out.clone()
                rec = {"same": bool(torch.equal(out, ref)), "ms": cs._ms(call, 50),
                       "device_ms": cs._device_by_kernel(torch, call, 20)}
                if name == "timeline":
                    ts = (ctypes.c_ulonglong * 16)()
                    call()
                    torch.cuda.synchronize()
                    lib.ptt_k3_times(ts)
                    rec["timeline_us"] = {label: (ts[i] - ts[0]) / 1e3 for i, label in PHASES.items()
                                          if ts[i] >= ts[0]}
                res[f"{dt}".replace("torch.", "") + f" {case} {name}"] = rec
                print(f"{dt} {case} {name}: {json.dumps(rec)} [{card}]", flush=True)
    print(json.dumps({"k3_split": res, "card": card}))


if __name__ == "__main__":
    main()
