#!/usr/bin/env python3
"""K6 and K5 (the multi-tensor optimizer kernels) over the training step's
186 parameter shapes, built from this checkout's sources as they stand and
with parts changed by text substitution (as ``k3_split.py`` does), beside
``torch.optim.Adam(fused=True)`` / ``SGD(fused=True)`` over the same shapes,
all in one process on one card:

    python3 paddle_tpu_torch/tools/k56_sweep.py

The variants:

  as_built    the kernels as the port runs them;
  chunk4096 .. chunk65536  chunks of that many floats (kChunk; the table's
              chunk prefix planned for it);
  blocks2/8   a persistent grid of 2 or 8 blocks an SM (kBlocksPerSm);
  unroll1/2/4  1, 2 or 4 float4s of each stream in flight a thread (K6
              runs 4, K5 2);
  threads128/512  blocks of 128 or 512 threads (not 256);
  cached      plain loads and stores in place of the evict-first ones;
  one_table   every group through the table of kMaxTensors entries (no
              small table for groups of at most kSmallTensors).

Each variant launches the step's table built once, in place; its
CUDA-event time is the best of 5 rounds taken in turns
(``chip_smoke._best``), and its outputs from the same inputs (copied back
before each check; Adam's beta powers, which go to fresh tensors, set to
NaN) are bit-equal to the as-built kernel's.  A table of one ([512] and the
[32000, 512] word table) is timed the same way through as_built and
one_table, event milliseconds and host microseconds a launch.

The wrappers' whole calls (``fused_adam_multi``, ``fused_sgd_multi``: the
table built in Python, Adam's power outputs made, the launch, all in
place): event time, device time (profiler) and host microseconds a call
over 5 rounds; the same for the library calls.  Prints one JSON line.
Needs one CUDA GPU and nvcc.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
from array import array

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
ROUNDS = 5


def _set(name, value):
    """A substitution setting ``constexpr int name`` to ``value`` (the
    default that followed it becomes a comment)."""
    return (f"constexpr int {name} = ", f"constexpr int {name} = {value}; // ")


VARIANTS = {
    "as_built": [],
    **{f"chunk{c}": [_set("kChunk", c)] for c in (4096, 16384, 32768, 65536)},
    **{f"blocks{b}": [_set("kBlocksPerSm", b)] for b in (2, 8)},
    **{f"unroll{u}": [_set("kUnroll", u)] for u in (1, 2, 4)},
    "threads128": [_set("kThreads", 128)],
    "threads512": [_set("kThreads", 512)],
    "cached": [("{ __stcs(p, v); }", "{ *p = v; }"), ("__ldcs(", "__ldg(")],
    "one_table": [("if (n_tensors <= kSmallTensors)", "if (false)")],
}


def build_variants(build):
    """One shared library of both kernels a variant under
    build/k56_sweep/, the nvcc processes started together; {name: (CDLL,
    its kChunk)}."""
    nvcc = build._nvcc()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, subs in VARIANTS.items():
        out = os.path.join(ROOT, "build", "k56_sweep", name)
        os.makedirs(out, exist_ok=True)
        files, chunks = [], set()
        for src in ("fused_adam.cu", "fused_sgd.cu"):
            text = open(os.path.join(CSRC, src)).read()
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"k56_sweep: variant {name}: {src} no longer holds {old!r}")
                text = text.replace(old, new)
            chunks.add(int(re.search(r"constexpr int kChunk = (\d+);", text).group(1)))
            files.append(os.path.join(out, src))
            with open(files[-1], "w") as f:
                f.write(text)
        lib = os.path.join(out, "libk56.so")
        procs[name] = (lib, chunks.pop(), subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", lib, *files], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, chunk, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"k56_sweep: building {name} failed:\n{log}")
        libs[name] = (ctypes.CDLL(lib), chunk)
    return libs


def main():
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"card": smi.stdout.strip(), "rounds": ROUNDS}
    libs = build_variants(fo.build)
    adam = cs._step_adam_entries(torch, cs._step_updates(pt), seed=5)
    dev = adam[0][0].device                   # cuda:0: its index is the table's
    g = torch.Generator(device=dev).manual_seed(8)
    sgd = [(torch.randn(e[0].shape, device=dev, generator=g),
            1e-2 * torch.randn(e[0].shape, device=dev, generator=g),
            torch.tensor([0.1], device=dev)) for e in adam]
    scalars = {"K6": (0.9, 0.999, 1.0 - 0.9, 1.0 - 0.999, 1e-8), "K5": ()}
    symbols = {"K6": "ptt_fused_adam_multi_f32", "K5": "ptt_fused_sgd_multi_f32"}

    def prepared(name, entries):
        """The tensors a prepared launch over ``entries`` writes (flat: the
        updated inputs, then K6's fresh beta powers), how many of them are
        inputs, and the launch."""
        counts = [e[0].numel() for e in entries]
        if name == "K6":
            pows, launch = fo._adam_launch(entries, counts, *scalars["K6"][:2],
                                           scalars["K6"][4])
            ins = [t for e in entries for t in (e[0], e[2], e[3])]
            return ins + pows, len(ins), launch
        return [e[0] for e in entries], len(entries), fo._sgd_launch(entries, counts)

    # the kernels alone: launches of a table built once (a launch's host
    # cost, ~0.1 ms, is below its device time, so events time the device)
    for name, entries in (("K6", adam), ("K5", sgd)):
        outputs, n_in, launch = prepared(name, entries)
        inputs = [t.clone() for t in outputs[:n_in]]

        def restore():
            for t, v in zip(outputs, inputs):
                t.copy_(v)
            for t in outputs[n_in:]:                # a launch that writes nothing shows
                t.fill_(float("nan"))
        restore()
        launch()
        ref = [t.clone() for t in outputs]
        variants = _variant_calls(torch, fo, libs, symbols[name], launch, scalars[name])
        for v, fn in variants.items():
            restore()
            fn()
            if not all(torch.equal(x, y) for x, y in zip(outputs, ref)):
                raise AssertionError(f"{name} variant {v} differs from the kernel as built")
        best = cs._best(lambda fn: cs._ms(fn, 20), list(variants.values()), rounds=ROUNDS)
        out[name + " variant_ms"] = dict(zip(variants, best))
        del ref, outputs, inputs
        # a table of one: the small table (as built) against the large one
        for k in (min(range(len(entries)), key=lambda i: entries[i][0].numel()),
                  max(range(len(entries)), key=lambda i: entries[i][0].numel())):
            kept, _, launch = prepared(name, [entries[k]])   # its outputs live as long
            fns = _variant_calls(torch, fo, {v: libs[v] for v in ("as_built", "one_table")},
                                 symbols[name], launch, scalars[name])
            label = f"{name} table of one {list(entries[k][0].shape)}"
            out[label + " ms"] = dict(zip(fns, cs._best(lambda fn: cs._ms(fn, 200),
                                                        list(fns.values()), rounds=ROUNDS)))
            out[label + " host_us"] = dict(zip(fns, cs._best(
                lambda fn: cs._host_us(torch, fn, iters=2000), list(fns.values()),
                rounds=ROUNDS)))
    # the wrappers' whole calls, in place
    calls = {"K6": lambda: fo.fused_adam_multi(adam, 0.9, 0.999, 1e-8),
             "K5": lambda: fo.fused_sgd_multi(sgd)}
    for name, call in calls.items():
        res = {"ms": [], "host_us": []}
        for _ in range(ROUNDS):
            res["ms"].append(cs._ms(call, 20))
            res["host_us"].append(cs._host_us(torch, call, iters=200))
        out[name + " call"] = res
        out[name + " call_device_ms"] = sum(cs._device_by_kernel(torch, call, 5).values())
    floats = sum(e[0].numel() for e in adam)
    params = [torch.nn.Parameter(e[0].clone()) for e in adam]
    for q, e in zip(params, adam):
        q.grad = e[1].clone()
    del adam, sgd
    for name, opt in (("Adam(fused=True)", torch.optim.Adam(params, lr=1e-3, fused=True)),
                      ("SGD(fused=True)", torch.optim.SGD(params, lr=0.1, fused=True))):
        opt.step()
        out[name + " ms"] = min(cs._ms(opt.step, 20) for _ in range(3))
        out[name + " device_ms"] = sum(cs._device_by_kernel(torch, opt.step, 5).values())
        out[name + " host_us"] = cs._host_us(torch, opt.step, iters=200)
    out["bound_ms"] = {"K6": cs._bound(28 * floats, 0)[0], "K5": cs._bound(12 * floats, 0)[0]}
    print(json.dumps(out))


def _variant_calls(torch, fo, libs, symbol, launch, scalars):
    """For each variant library, a function launching its ``symbol`` with
    the table ``launch`` (a wrapper's prepared launch) holds, its chunk
    prefix planned for the variant's chunk."""
    rows, counts, flags = launch.args[5:8]
    calls = {}
    for name, (lib, chunk) in libs.items():
        (_, starts), = fo.plan_launches(counts, len(counts), chunk)
        bufs = (array("q", rows), array("q", counts), array("i", flags), array("i", starts))
        args = [b.buffer_info()[0] for b in bufs] + [len(counts), *scalars]
        fn = getattr(lib, symbol)
        fn.argtypes = launch.args[0].argtypes
        fn.restype = ctypes.c_int

        def call(fn=fn, name=name, args=args, bufs=bufs):   # the arrays live as long
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k56_sweep {name}: CUDA error {rc}")
        calls[name] = call
    return calls


if __name__ == "__main__":
    main()
