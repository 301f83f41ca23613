#!/usr/bin/env python3
"""Where K7 bf16's time goes on the card.  The fused linear-CE forward's
bf16 kernel (``ptt_linear_ce_fwd_bf16``: ``gemm_bf16_kernel<kLse>`` of
csrc/gemm_3xtf32.cuh, then the merge of csrc/linear_ce.cu) is built from
this checkout's sources as it is and with one of the header's variant
macros set (``-D``), and each is timed (CUDA events) at the training path's
shape, x [16384, 512] and W [512, 32000] bf16:

    python3 paddle_tpu_torch/tools/k7_split.py

Variants (the kernel's own arithmetic everywhere else):
  as_built     the kernel as the port runs it;
  no_epilogue  the mainloop alone: each tile's sum is folded into one
               value that is kept, and nothing is reduced or written;
  fast_exp     the epilogue with ``__expf`` (the special-function unit's
               approximation) in place of ``expf``;
  no_shuffle   the epilogue without its cross-lane shuffles.
The variants' results are wrong by design; only their times mean anything.
The variants are timed in turns over several rounds (the spread is each
one's range).  Prints one JSON line.  Needs one CUDA GPU and nvcc.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VARIANTS = {
    "as_built": [],
    "no_epilogue": ["-DPTT_K7_NO_EPILOGUE"],
    "fast_exp": ["-DPTT_K7_FAST_EXP"],
    "no_shuffle": ["-DPTT_K7_NO_SHUFFLE"],
}
ROUNDS = 5


def build_variants(build):
    """One shared library per variant under build/k7_split/, the nvcc
    processes started together; returns {name: path}."""
    csrc = os.path.join(HERE, "paddle_tpu_torch", "csrc")
    nvcc = build._nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, defines in VARIANTS.items():
        out = os.path.join(HERE, "build", "k7_split", name)
        os.makedirs(out, exist_ok=True)
        lib = os.path.join(out, "libk7.so")
        cmd = [nvcc, *flags, *defines, "-shared", "-o", lib,
               os.path.join(csrc, "linear_ce.cu"), os.path.join(csrc, "runtime.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"k7_split: building {name} failed:\n{log}")
        libs[name] = lib
    return libs


def main():
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import build
    if not torch.cuda.is_available():
        raise SystemExit("k7_split: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    libs = build_variants(build)
    dev, g = torch.device("cuda"), torch.Generator().manual_seed(11)
    rows, d, v = cs.TRAIN_B * cs.T, cs.D_MODEL, cs.VOCAB
    lim = (6.0 / (d + v)) ** 0.5
    x = torch.randn(rows, d, generator=g).to(torch.bfloat16).to(dev)
    w = ((torch.rand(d, v, generator=g) * 2 - 1) * lim).to(torch.bfloat16).to(dev)
    b = (0.01 * torch.randn(v, generator=g)).to(dev)
    labels = torch.randint(0, v, (rows,), generator=g, dtype=torch.int32).to(dev)
    lse, lab = torch.empty(rows, device=dev), torch.empty(rows, device=dev)
    part = torch.empty((2, 2 * -(-v // 128), rows), device=dev)
    args = [t.data_ptr() for t in (x, w, b, labels, lse, lab, part[0], part[1])]
    calls = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(path), "ptt_linear_ce_fwd_bf16")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn, name=name):
            rc = fn(*args, rows, d, v, v, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k7_split: {name}: CUDA error {rc}")
        calls[name] = call
    runs = {name: [] for name in calls}
    for _ in range(ROUNDS):
        for name, call in calls.items():
            runs[name].append(cs._ms(call, 10))
    print(json.dumps({"card": smi.stdout.strip(), "shape": {"x": [rows, d], "W": [d, v]},
                      "ms": {n: min(r) for n, r in runs.items()}, "runs_ms": runs}))


if __name__ == "__main__":
    main()
