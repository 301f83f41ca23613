"""The PyTorch/CUDA port's CUDA kernels on the card, against their plain
PyTorch versions, and the serving slice on the card against the port on
the CPU.  Every test is marked ``gpu`` and skips where there is no CUDA
device.

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without jax, bypassing tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.cuda.embedding import gather_rows, gather_rows_plain
from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain

pytestmark = pytest.mark.gpu

FLASH_ATOL = 1e-5     # float32, kernel vs plain on the card
LOGIT_ATOL = 1e-4     # float32 through 4 layers, card vs CPU, TF32 off


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels are CUDA-only)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, d, causal):
    """Ragged T (100, not a multiple of the tiles), key lengths 0..T."""
    rs = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rs.randn(16, 100, d).astype(np.float32)).to(cuda)
               for _ in range(3))
    lens = torch.from_numpy(rs.randint(0, 101, 16).astype(np.int32)).to(cuda)
    lens[0] = 0
    before = flash_attn_fwd.launches
    out, lse = flash_attn_fwd(q, k, v, kv_lens=lens, causal=causal)
    ref, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attn_fwd.launches == before + 1
    assert (out - ref).abs().max().item() <= FLASH_ATOL
    assert (lse - ref_lse).abs().max().item() <= FLASH_ATOL
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_flash_kernel_cross_attention_without_lengths(cuda):
    rs = np.random.RandomState(7)
    q = torch.from_numpy(rs.randn(2, 4, 33, 64).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rs.randn(2, 4, 70, 64).astype(np.float32)).to(cuda)
            for _ in range(2))
    out, lse = flash_attn_fwd(q, k, v)
    ref, _ = flash_attn_fwd_plain(q.reshape(8, 33, 64), k.reshape(8, 70, 64),
                                  v.reshape(8, 70, 64), None, False, 0.125)
    assert out.shape == (2, 4, 33, 64) and lse.shape == (2, 4, 33)
    assert (out.reshape(8, 33, 64) - ref).abs().max().item() <= FLASH_ATOL


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attn_fwd(q, q, q)
    q = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn_fwd(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1))
    with pytest.raises(TypeError, match="int32"):
        flash_attn_fwd(q, q, q, kv_lens=torch.zeros(2, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("d", [512, 30])          # float4 and scalar paths
def test_gather_kernel_matches_plain_bit_equal(cuda, d):
    g = torch.Generator().manual_seed(d)
    w = torch.randn(1000, d, generator=g).to(cuda)
    ids = torch.randint(-3, 1003, (777,), generator=g, dtype=torch.int32).to(cuda)
    before = gather_rows.launches
    out = gather_rows(w, ids)
    assert gather_rows.launches == before + 1
    assert torch.equal(out, gather_rows_plain(w, ids))


def test_gather_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError, match="device"):
        gather_rows(torch.zeros(4, 8, device=cuda), torch.zeros(3, dtype=torch.int32))


def _infer_func():
    src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
    trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
    return transformer.transformer(src, trg, 1000, 1000, max_len=32, n_layer=2,
                                   d_model=64, n_head=4, d_inner=256, is_test=True)


def test_small_transformer_on_card_matches_cpu_and_uses_the_kernels(cuda):
    gpu = pt.Inferencer(_infer_func)                  # CUDAPlace(0) by default
    cpu = pt.Inferencer(_infer_func, place=pt.CPUPlace())
    params = {n: gpu.scope.find_var(n).cpu().numpy()
              for n, v in gpu.inference_program.global_block.vars.items() if v.persistable}
    pt.params_from_numpy(params, cpu.scope, "cpu")
    rs = np.random.RandomState(0)
    feed = {"src": rs.randint(1, 1000, (3, 32, 1)), "trg": rs.randint(1, 1000, (3, 32, 1)),
            "src@SEQ_LEN": np.array([32, 0, 9], np.int32),
            "trg@SEQ_LEN": np.array([5, 32, 1], np.int32)}
    k1, k2 = flash_attn_fwd.launches, gather_rows.launches
    (got,) = gpu.infer(feed)
    assert flash_attn_fwd.launches - k1 == 6 and gather_rows.launches - k2 == 4
    (want,) = cpu.infer(feed)
    assert got.shape == (3, 32, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
