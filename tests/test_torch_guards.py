"""Guards of the PyTorch/CUDA port: it never imports jax or the JAX
package, it never runs on the CPU unless asked, a kernel wrapper given a
CUDA tensor never falls back to its plain version, and ``chip_smoke.py``
fails (prints no result) where there is no GPU or no package."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as pt

from _torch_validate import _no_port_validate_findings  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_no_jax_and_no_paddle_tpu():
    code = ("import sys, paddle_tpu_torch; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in (REPO / "paddle_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_paddle_tpu(path):
    tree = ast.parse((REPO / path).read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_the_import_scan_covers_the_data_path_and_io_modules():
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "paddle_tpu_torch").rglob("*.py")}
    for path in ("reader/__init__.py", "reader/decorator.py", "checkpoint/__init__.py",
                 "checkpoint/manifest.py", "io.py", "telemetry.py", "data_feeder.py", "lod.py",
                 "trainer.py", "core/prune.py"):
        assert f"paddle_tpu_torch/{path}" in scanned, path


def test_the_import_scan_covers_the_observability_modules():
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "paddle_tpu_torch").rglob("*.py")}
    for path in ("log.py", "compile_log.py", "profiler.py", "profiling/__init__.py",
                 "profiling/op_profiler.py", "resource_sampler.py"):
        assert f"paddle_tpu_torch/{path}" in scanned, path


def test_the_import_scan_covers_the_optimizer_slice_modules():
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "paddle_tpu_torch").rglob("*.py")}
    for path in ("clip.py", "regularizer.py", "optimizer.py", "backward.py",
                 "layers/learning_rate_scheduler.py", "ops/optimizer_ops.py", "ops/math_ops.py",
                 "ops/nn_ops.py", "ops/tensor_ops.py", "ops/kernel_ops.py"):
        assert f"paddle_tpu_torch/{path}" in scanned, path


def test_the_import_scan_covers_the_analysis_slice_modules():
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "paddle_tpu_torch").rglob("*.py")}
    for path in ("analysis/__init__.py", "analysis/diagnostics.py", "analysis/verifier.py",
                 "analysis/memory.py", "ops/shape_infer.py", "passes/fuse.py",
                 "passes/dead_ops.py", "passes/donation.py", "transpiler/__init__.py",
                 "transpiler/inference_transpiler.py"):
        assert f"paddle_tpu_torch/{path}" in scanned, path


def test_the_import_scan_covers_the_cnn_slice_modules():
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "paddle_tpu_torch").rglob("*.py")}
    for path in ("nets.py", "initializer.py", "models/resnet.py", "models/mnist.py",
                 "models/vgg.py", "passes/bn_fold.py", "ops/metric_ops.py",
                 "ops/activation_ops.py", "ops/random_ops.py", "dataset/__init__.py",
                 "dataset/common.py", "dataset/mnist.py", "dataset/cifar.py"):
        assert f"paddle_tpu_torch/{path}" in scanned, path


def test_trainer_and_inferencer_without_gpu_raise_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def train_func():
        return pt.layers.mean(pt.layers.data(name="x", shape=[2]))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Trainer(train_func, lambda: pt.optimizer.SGD(learning_rate=0.1))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Inferencer(lambda: pt.layers.scale(pt.layers.data(name="x", shape=[2]), 2.0))


def test_executor_without_gpu_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor(pt.CUDAPlace(0))
    assert pt.Executor(pt.CPUPlace()).device == torch.device("cpu")


CUDA_MODULES = sorted(p.stem for p in (REPO / "paddle_tpu_torch/ops/cuda").glob("*.py")
                      if p.stem != "__init__")


def test_importing_the_kernel_modules_starts_no_build_and_needs_no_nvcc():
    """Every ops/cuda module imports with no compiler on the PATH and no
    CUDA_HOME, starts no process, and leaves every entry point unresolved."""
    code = (
        "import subprocess, sys\n"
        "def refuse(*a, **k): raise AssertionError('a process was started at import')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import importlib\n"
        "from paddle_tpu_torch.ops.cuda import build\n"
        f"mods = [importlib.import_module('paddle_tpu_torch.ops.cuda.' + m) for m in {CUDA_MODULES!r}]\n"
        "entries = [e for m in mods for e in vars(m).values() if isinstance(e, build.Entry)]\n"
        "assert len(entries) >= 10, len(entries)\n"
        "assert all(e.fn == e._first_call for e in entries)\n"
        "assert build._lib is None\n"
        "print('ok', len(entries))\n")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.startswith("ok")


class _CountingLibrary:
    """Stands in for the loaded kernel library: counts symbol look-ups."""

    def __init__(self):
        self.lookups, self.calls = [], []

    def __getattr__(self, name):
        self.lookups.append(name)
        calls = self.calls

        class Fn:
            argtypes = restype = None

            def __call__(self, *args):
                calls.append(args)
                return 0
        return Fn()


def test_entry_resolves_its_symbol_once(monkeypatch):
    import ctypes

    from paddle_tpu_torch.ops.cuda import build
    lib = _CountingLibrary()
    loads = []
    monkeypatch.setattr(build, "_load", lambda: loads.append(1) or lib)
    entry = build.Entry("ptt_some_kernel", [ctypes.c_void_p, ctypes.c_int])
    assert entry.fn == entry._first_call and not loads     # nothing at construction
    for i in range(5):
        assert entry.fn(i, 7) == 0
    assert lib.lookups == ["ptt_some_kernel"] and loads == [1]
    assert lib.calls == [(i, 7) for i in range(5)]
    assert entry.fn.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert entry.fn.restype is ctypes.c_int
    assert entry.fn != entry._first_call                   # the hot path is the C function


def test_launch_passes_the_raw_stream_and_raises_on_an_error_code(monkeypatch):
    from paddle_tpu_torch.ops.cuda import build
    seen = []
    monkeypatch.setattr(build, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(build, "_get_device", lambda: 0)
    entry = build.Entry("ptt_x", [])
    entry.fn = lambda *args: seen.append(args) or 0
    build.launch(entry, "x", torch.device("cuda", 0), 1, 2)
    assert seen == [(1, 2, 1000)]
    entry.fn = lambda *args: 700
    with pytest.raises(RuntimeError, match="x: CUDA error 700"):
        build.launch(entry, "x", torch.device("cuda", 0), 1)


def _bad_gather_arguments():
    i32 = lambda *shape: torch.zeros(*shape, dtype=torch.int32)
    w = torch.zeros(4, 8)
    return [
        ("w_3d", (w[None], i32(3)), ValueError, r"w \[V, D\]"),
        ("w_1d", (w[0], i32(3)), ValueError, r"w \[V, D\]"),
        ("ids_2d", (w, i32(3, 1)), ValueError, r"ids \[N\]"),
        ("ids_int64", (w, torch.zeros(3, dtype=torch.int64)), TypeError, "int32"),
        ("ids_float", (w, torch.zeros(3)), TypeError, "int32"),
        ("ids_elsewhere", (w, i32(3).to("meta")), ValueError, "one CUDA device"),
        ("w_elsewhere", (w.to("meta"), i32(3)), ValueError, "one CUDA device"),
        ("both_not_cuda", (w.to("meta"), i32(3).to("meta")), ValueError, "one CUDA device"),
    ]


@pytest.mark.parametrize("case", _bad_gather_arguments(), ids=lambda c: c[0])
def test_gather_rows_argument_errors(case):
    from paddle_tpu_torch.ops.cuda.embedding import gather_rows
    _, args, exc, match = case
    with pytest.raises(exc, match=match):
        gather_rows(*args)


@pytest.mark.parametrize("case", ["rows_shape", "rows_elsewhere"])
def test_scatter_add_rows_argument_errors(case):
    from paddle_tpu_torch.ops.cuda.embedding import scatter_add_rows
    w, ids = torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32)
    rows = torch.zeros(3, 4) if case == "rows_shape" else torch.zeros(3, 8).to("meta")
    with pytest.raises(ValueError, match="rows \\[N, D\\]" if case == "rows_shape"
                       else "one CUDA device"):
        scatter_add_rows(w, ids, rows)


def _cuda_calls():
    """(module, plain-version name, call on CUDA tensors) per wrapper."""
    from paddle_tpu_torch.ops.cuda import (embedding, flash_attention,
                                           fused_optimizer, int8_matmul, linear_ce)
    dev = torch.device("cuda")
    q = torch.randn(2, 16, 64, device=dev)
    x, w = torch.randn(8, 16, device=dev), torch.randn(16, 32, device=dev)
    labels = torch.zeros(8, dtype=torch.int32, device=dev)
    per_row = torch.rand(8, device=dev)
    ids = torch.tensor([0, 3, 3, 9], dtype=torch.int32, device=dev)
    table, rows = torch.zeros(10, 16, device=dev), torch.randn(4, 16, device=dev)
    one = torch.ones((), device=dev)
    return [
        (linear_ce, "linear_ce_fwd_plain", lambda: linear_ce.linear_ce_fwd(x, w, None, labels)),
        (linear_ce, "linear_ce_bwd_plain",
         lambda: linear_ce.linear_ce_bwd(x, w, None, labels, per_row, per_row)),
        (fused_optimizer, "fused_adam_plain",
         lambda: fused_optimizer.fused_adam(x, x, x, x.abs(), one, one, one, 0.9, 0.999, 1e-8)),
        (fused_optimizer, "adam_plain",
         lambda: fused_optimizer.fused_adam_multi([(x, x, x, x.abs(), one, one, one, False)],
                                                  0.9, 0.999, 1e-8)),
        (fused_optimizer, "fused_adam_multi_plain",
         lambda: fused_optimizer.fused_adam_multi([(x, x, x, x.abs(), one, one, one, True)],
                                                  0.9, 0.999, 1e-8)),
        (fused_optimizer, "fused_sgd_multi_plain",
         lambda: fused_optimizer.fused_sgd_multi([(x, x, one)])),
        (embedding, "scatter_add_rows_plain",
         lambda: embedding.scatter_add_rows(table, ids, rows)),
        (embedding, "gather_rows_plain", lambda: embedding.gather_rows(table, ids)),
        (flash_attention, "flash_attn_fwd_plain", lambda: flash_attention.flash_attn_fwd(q, q, q)),
        (fused_optimizer, "fused_sgd_plain", lambda: fused_optimizer.fused_sgd(x, x, one)),
        (int8_matmul, "int8_matmul_plain", lambda: int8_matmul.int8_matmul(x, w)),
        (int8_matmul, "abs_max_pair_plain", lambda: int8_matmul.int8_matmul(x, w)),
        (int8_matmul, "quantize_int8_plain", lambda: int8_matmul.int8_matmul(x, w)),
        (int8_matmul, "int8_mm_plain",
         lambda: int8_matmul.int8_mm(ids.to(torch.int8)[:, None].expand(4, 16).contiguous(),
                                     ids.to(torch.int8)[:, None].expand(4, 16).contiguous())),
    ]


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels are CUDA-only)")
    for module, plain, call in _cuda_calls():
        def refuse(*args, **kwargs):
            raise AssertionError("a CUDA tensor reached the plain version")
        monkeypatch.setattr(module, plain, refuse)
        call()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("head_dim,reason", [(16, "policy disables"), (24, "head_dim 24")])
def test_flash_stamp_false_on_the_card_raises_instead_of_the_plain_attention(
        monkeypatch, head_dim, reason):
    """A flash op the kernel pass declined (a policy that disables K1, or a
    head_dim K1 does not take) raises on CUDA tensors and names why."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels are CUDA-only)")
    from paddle_tpu_torch.ops.cuda import flash_attention
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        q = pt.layers.data(name="q", shape=[5, 2 * head_dim])
        out = pt.layers.flash_attention(q, q, q, num_heads=2)
    policy = pt.passes.KernelPolicy(disable=["flash_attention"] if head_dim == 16 else ())
    exe = pt.Executor(pt.CUDAPlace(0), kernels=policy)
    flash_ops = [o for o in exe._apply_passes(main, ["q"], [out.name]).desc.block(0).ops
                 if o.type == "flash_attention"]
    assert [o.attrs["pallas_kernel"] for o in flash_ops] == [False]

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain attention")
    monkeypatch.setattr(flash_attention, "flash_attn_fwd_plain", refuse)
    monkeypatch.setattr("paddle_tpu_torch.ops.attention_ops.flash_attn_fwd_plain", refuse)
    feed = {"q": torch.randn(3, 5, 2 * head_dim).numpy()}
    with pytest.raises(NotImplementedError, match=reason):
        exe.run(main, feed=feed, fetch_list=[out])


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok": true' not in run.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    run = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and '"ok": true' not in run.stdout
