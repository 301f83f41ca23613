"""Guards of the PyTorch/CUDA port: it never imports jax or the JAX
package, it never runs on the CPU unless asked, and ``chip_smoke.py``
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
