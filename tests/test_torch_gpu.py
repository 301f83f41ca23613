"""The PyTorch/CUDA port's CUDA kernels on the card, against their plain
PyTorch versions, and the serving and training slices on the card against
the port on the CPU.  Every test is marked ``gpu`` and skips where there
is no CUDA device.

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
from paddle_tpu_torch.ops.cuda.embedding import (gather_rows, gather_rows_plain,
                                                 scatter_add_rows, scatter_add_rows_plain)
from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam, fused_adam_plain
from paddle_tpu_torch.ops.cuda.linear_ce import (linear_ce_bwd, linear_ce_bwd_plain,
                                                 linear_ce_fwd, linear_ce_fwd_plain)

pytestmark = pytest.mark.gpu

FLASH_ATOL = 1e-5     # float32, kernel vs plain on the card
LOGIT_ATOL = 1e-4     # float32 through 4 layers, card vs CPU, TF32 off
CE_RTOL = 1e-4        # linear-CE kernels vs plain, relative to the largest value
ADAM_ATOL = 1e-6      # fused Adam vs plain (the kernel rounds as the plain does)
SCATTER_RTOL = 1e-5   # scatter-add vs index_add_: both sum duplicates by atomics


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


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("bsz,d,v,bias", [(256, 128, 1024, True), (300, 64, 1000, False),
                                          (129, 36, 4100, True)])
def test_linear_ce_kernels_match_plain(cuda, bsz, d, v, bias):
    """Ragged row, column and k tiles; labels at 0, V-1 and out of range."""
    g = torch.Generator().manual_seed(bsz)
    x = torch.randn(bsz, d, generator=g).to(cuda)
    w = (0.1 * torch.randn(d, v, generator=g)).to(cuda)
    b = torch.randn(v, generator=g).to(cuda) if bias else None
    labels = torch.randint(0, v, (bsz,), generator=g, dtype=torch.int32)
    labels[:4] = torch.tensor([0, v - 1, v, -1], dtype=torch.int32)
    labels = labels.to(cuda)
    gl = torch.rand(bsz, generator=g).to(cuda)
    before = linear_ce_fwd.launches, linear_ce_bwd.launches
    lse, lab = linear_ce_fwd(x, w, b, labels)
    dx, dw, db = linear_ce_bwd(x, w, b, labels, lse, gl)
    assert (linear_ce_fwd.launches, linear_ce_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_lse, ref_lab = linear_ce_fwd_plain(x, w, b, labels)
    rdx, rdw, rdb = linear_ce_bwd_plain(x, w, b, labels, ref_lse, gl)
    torch.cuda.synchronize()
    assert _rel_err(lse, ref_lse) <= CE_RTOL and _rel_err(lab, ref_lab) <= CE_RTOL
    assert lab[2].item() == 0.0 and lab[3].item() == 0.0
    assert _rel_err(dx, rdx) <= CE_RTOL and _rel_err(dw, rdw) <= CE_RTOL
    assert (db is None) == (not bias)
    if bias:
        assert _rel_err(db, rdb) <= CE_RTOL


@pytest.mark.parametrize("shape", [(64, 130), (1001,), (32000, 512)])
def test_fused_adam_kernel_matches_plain(cuda, shape):
    g = torch.Generator().manual_seed(len(shape))
    p, grad, m1 = (torch.randn(*shape, generator=g).to(cuda) for _ in range(3))
    m2 = torch.rand(*shape, generator=g).to(cuda)
    b1p, b2p = torch.tensor(0.9 ** 3, device=cuda), torch.tensor(0.999 ** 3, device=cuda)
    lr = torch.tensor(1e-3, device=cuda)
    before = fused_adam.launches
    got = fused_adam(p, grad, m1, m2, b1p, b2p, lr, 0.9, 0.999, 1e-8)
    want = fused_adam_plain(p, grad, m1, m2, b1p, b2p, lr, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and (a - b).abs().max().item() <= ADAM_ATOL


@pytest.mark.parametrize("v,d", [(1024, 128), (256, 512), (77, 30)])
def test_scatter_add_kernel_matches_plain(cuda, v, d):
    g = torch.Generator().manual_seed(v)
    w = torch.zeros(v, d, device=cuda)
    ids = torch.randint(0, v, (4096,), generator=g, dtype=torch.int32)
    ids[:3] = torch.tensor([v, -1, 0], dtype=torch.int32)
    ids = ids.to(cuda)
    rows = torch.randn(4096, d, generator=g).to(cuda)
    before = scatter_add_rows.launches
    got = scatter_add_rows(w, ids, rows)
    want = scatter_add_rows_plain(w, ids, rows)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert _rel_err(got, want) <= SCATTER_RTOL


def _train_programs():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[32, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, 1000, 1000, max_len=32,
                                            n_layer=2, d_model=64, n_head=4,
                                            d_inner=256, fuse_final_ce=True)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def test_small_training_step_on_card_matches_cpu_and_uses_the_kernels(cuda):
    main, startup, loss = _train_programs()
    gpu_scope, cpu_scope = pt.Scope(), pt.Scope()
    gpu, cpu = pt.Executor(), pt.Executor(pt.CPUPlace())
    gpu.run(startup, scope=gpu_scope)
    params = [p.name for p in main.global_block.all_parameters()]
    persist = [v.name for v in main.list_vars() if v.persistable]
    pt.params_from_numpy({n: gpu_scope.find_var(n).cpu().numpy() for n in persist},
                         cpu_scope, "cpu")
    rs = np.random.RandomState(0)
    feed = {"src": rs.randint(1, 1000, (3, 32, 1)), "trg": rs.randint(1, 1000, (3, 32, 1)),
            "lbl": rs.randint(1, 1000, (3, 32, 1)),
            "src@SEQ_LEN": np.array([32, 0, 9], np.int32),
            "trg@SEQ_LEN": np.array([5, 32, 1], np.int32)}
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    counts = [f.launches for f in (flash_attn_fwd, gather_rows, scatter_add_rows,
                                   fused_adam, linear_ce_fwd, linear_ce_bwd)]
    got = gpu.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    after = [f.launches for f in (flash_attn_fwd, gather_rows, scatter_add_rows,
                                  fused_adam, linear_ce_fwd, linear_ce_bwd)]
    # K1: 6 attention ops, forward and grad retrace; K2 likewise over 4
    # embeddings; K3 once per embedding grad; K6 once per parameter
    assert [a - c for a, c in zip(after, counts)] == [12, 8, 4, len(params), 1, 1]
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for n, a, b in zip(fetch[1:], got[1:], want[1:]):
        assert np.isfinite(a).all(), n
        np.testing.assert_allclose(a, b, atol=1e-5 + 1e-4 * np.abs(b).max(), rtol=1e-4,
                                   err_msg=n)
