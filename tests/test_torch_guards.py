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


def test_executor_without_gpu_raises_instead_of_using_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Executor(pt.CUDAPlace(0))
    assert pt.Executor(pt.CPUPlace()).device == torch.device("cpu")


def _cuda_calls():
    """(module, plain-version name, call on CUDA tensors) per wrapper."""
    from paddle_tpu_torch.ops.cuda import (embedding, flash_attention,
                                           fused_optimizer, linear_ce)
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
        (embedding, "scatter_add_rows_plain",
         lambda: embedding.scatter_add_rows(table, ids, rows)),
        (embedding, "gather_rows_plain", lambda: embedding.gather_rows(table, ids)),
        (flash_attention, "flash_attn_fwd_plain", lambda: flash_attention.flash_attn_fwd(q, q, q)),
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
