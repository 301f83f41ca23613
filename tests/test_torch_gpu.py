"""The PyTorch/CUDA port's CUDA kernels on the card, against their plain
PyTorch versions, and the serving and training slices on the card against
the port on the CPU.  Every test is marked ``gpu`` and skips where there
is no CUDA device.

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without jax, bypassing tests/conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import layers
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.ops.cuda.embedding import (gather_rows, gather_rows_plain,
                                                 scatter_add_rows, scatter_add_rows_plain)
from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain
from paddle_tpu_torch.ops.cuda import fused_optimizer
from paddle_tpu_torch.ops.cuda.fused_optimizer import (fused_adam, fused_adam_multi,
                                                       fused_adam_multi_plain, fused_adam_plain,
                                                       fused_sgd, fused_sgd_multi,
                                                       fused_sgd_multi_plain, fused_sgd_plain)
from paddle_tpu_torch.ops.cuda.int8_matmul import (abs_max_pair, abs_max_pair_plain, int8_matmul,
                                                   int8_matmul_plain, int8_mm, int8_mm_plain,
                                                   quantize_int8, quantize_int8_plain)
from paddle_tpu_torch.ops.cuda.linear_ce import (gemm_3xtf32, gemm_bf16, linear_ce_bwd,
                                                 linear_ce_bwd_plain, linear_ce_fwd,
                                                 linear_ce_fwd_plain)

from _torch_validate import _no_port_validate_findings  # noqa: F401

pytestmark = pytest.mark.gpu

FLASH_ATOL = 1e-5     # float32, kernel vs plain on the card
LOGIT_ATOL = 1e-4     # float32 through 4 layers, card vs CPU, TF32 off
# linear-CE kernels vs plain, relative to the largest value: both run on the
# card in float32 (TF32 off), in other orders of summation; K7 and K8 read
# within 1e-6 at these shapes (3xTF32 holds float32's accuracy)
CE_RTOL = 2e-6
ADAM_ATOL = 1e-6      # fused Adam vs plain (the kernel rounds as the plain does)
# int8 logits, card vs CPU: a quantizer input ~1e-6 apart can round one
# element the other way or move an abs-max scale, and the later layers carry
# that as quantization noise, so one batch may be as far from the CPU as the
# float32 logits are.  The gates are those of the port vs the JAX package on
# the CPU (tests/test_torch_kernel_tier.py, where they were measured): every
# batch within INT8_LOGIT_ATOL, and at least QUIET_SHARE of 16 batches within
# QUIET_REL_ERR norm-relative, which the float32 control must fail.
INT8_LOGIT_ATOL = 0.05
QUIET_REL_ERR = 2e-3
QUIET_SHARE = 0.25
# bf16 instances.  K1: the Pallas kernel's float32 function, the output
# rounded once to bf16; the kernel (bf16 tensor cores, P split into two bf16
# terms, 2**-17 of P) and the plain version (float32) differ before the
# rounding by summation order and the split (FLASH_ATOL), and rounding can
# then land on neighbouring bf16 values: each element within 1 bf16 ulp plus
# FLASH_ATOL.  Against float64 over the same bf16 inputs each element lies
# within half a bf16 ulp plus FLASH_ATOL, a gate that P rounded once to bf16
# (one term of the split, the control) fails.  K7: products of bf16 values
# are exact in float32 and both sides sum in float32.
FLASH_BF16_ULPS = 1
CE_BF16_RTOL = 2e-6
# a bf16 training step, card vs CPU (both bf16, other summation orders and
# cuBLAS's bf16 GEMMs): bf16 noise of a small random network, as between
# the port and the JAX package on the CPU (tests/test_torch_amp_bf16.py)
BF16_STEP_GRAD_NREL = 0.2
BF16_STEP_LOSS_RTOL = 2e-3


def _bf16_ulps(got, ref, atol=0.0):
    """max over elements of (|got - ref| - atol) in units of the bf16
    spacing at the larger magnitude."""
    got, ref = got.float(), ref.float()
    mag = torch.maximum(got.abs(), ref.abs()).clamp_min(2.0 ** -126)
    off = ((got - ref).abs() - atol).clamp_min(0)
    return (off / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


def _half_ulp_excess(got, ref64, atol):
    """max over elements of |got - ref64| less half a bf16 ulp at the larger
    magnitude and ``atol``: <= 0 inside the float64 gate."""
    x = got.double()
    mag = torch.maximum(x.abs(), ref64.abs()).clamp_min(2.0 ** -126)
    return ((x - ref64).abs() - 0.5 * torch.exp2(torch.floor(torch.log2(mag)) - 7)
            - atol).max().item()


def _flash_p_rounded_once(q, k, v, lens, causal, scale):
    """The control of K1 bf16's float64 gate: float32 attention whose p . v
    takes P rounded once to bf16 (one term of the kernel's split), over the
    float32 sum of P."""
    tq, tk = q.shape[1], k.shape[1]
    kp = torch.arange(tk, device=q.device)
    mask = kp[None, None, :] < lens[:, None, None]
    if causal:
        mask = mask & (kp[None, :] <= torch.arange(tq, device=q.device)[:, None])
    s = (torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale).masked_fill(~mask, -np.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True)).nan_to_num(0.0)   # a row with no key: 0
    out = torch.einsum("bqk,bkd->bqd", p.to(torch.bfloat16).float(), v.float())
    return (out / p.sum(-1, keepdim=True).clamp_min(1e-20)).to(torch.bfloat16)


def _check_flash_bf16(q, k, v, lens, causal):
    """K1 bf16 against its plain version (1 bf16 ulp + FLASH_ATOL) and
    against float64 over the same bf16 inputs (half a bf16 ulp +
    FLASH_ATOL, lse FLASH_ATOL), with P rounded once outside that gate."""
    scale = q.shape[-1] ** -0.5
    before = (flash_attn_fwd.launches, flash_attn_fwd.bf16_launches)
    out, lse = flash_attn_fwd(q, k, v, kv_lens=lens, causal=causal)
    ref, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, scale)
    o64, l64 = flash_attn_fwd_plain(q.double(), k.double(), v.double(), lens, causal, scale)
    ctl = _flash_p_rounded_once(q, k, v, lens, causal, scale)
    torch.cuda.synchronize()
    assert (flash_attn_fwd.launches, flash_attn_fwd.bf16_launches) == \
        (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _bf16_ulps(out, ref, FLASH_ATOL) <= FLASH_BF16_ULPS
    assert (lse - ref_lse).abs().max().item() <= FLASH_ATOL
    assert _half_ulp_excess(out, o64, FLASH_ATOL) <= 0
    keyed = lens > 0      # a row with no valid key has lse -1e30 in either precision
    assert (lse[keyed].double() - l64[keyed]).abs().max().item() <= FLASH_ATOL
    assert _half_ulp_excess(ctl, o64, FLASH_ATOL) > 0
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    return out, lse


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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_many_tiles_with_short_and_ragged_lengths(cuda, d, causal):
    """T = 300: five 64-key tiles, the last ragged; key lengths 0, 1, at
    and around the tile edges, and T."""
    rs = np.random.RandomState(100 + d)
    q, k, v = (torch.from_numpy(rs.randn(10, 300, d).astype(np.float32)).to(cuda)
               for _ in range(3))
    lens = torch.tensor([0, 1, 2, 63, 64, 65, 128, 257, 299, 300], dtype=torch.int32).to(cuda)
    out, lse = flash_attn_fwd(q, k, v, kv_lens=lens, causal=causal)
    ref, ref_lse = flash_attn_fwd_plain(q, k, v, lens, causal, d ** -0.5)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= FLASH_ATOL
    assert (lse - ref_lse).abs().max().item() <= FLASH_ATOL
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(lse[0], ref_lse[0])


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_kernel_matches_plain(cuda, d, causal):
    """The bf16 kernel: ragged T (100), key lengths 0..T, several tiles."""
    rs = np.random.RandomState(100 + d)
    q, k, v = (torch.from_numpy(rs.randn(16, 100, d).astype(np.float32)).to(cuda)
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.from_numpy(rs.randint(0, 101, 16).astype(np.int32)).to(cuda)
    lens[0] = 0
    _check_flash_bf16(q, k, v, lens, causal)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_kernel_many_tiles_with_short_and_ragged_lengths(cuda, d, causal):
    """T = 300: five 64-row query blocks and five 64-key tiles, the last of
    each ragged; key lengths 0, 1, at and around the tile edges, and T."""
    rs = np.random.RandomState(200 + d)
    q, k, v = (torch.from_numpy(rs.randn(10, 300, d).astype(np.float32)).to(cuda)
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor([0, 1, 2, 63, 64, 65, 128, 257, 299, 300], dtype=torch.int32).to(cuda)
    _, lse = _check_flash_bf16(q, k, v, lens, causal)
    assert torch.equal(lse[0], flash_attn_fwd_plain(q[:1], k[:1], v[:1], lens[:1], causal,
                                                    d ** -0.5)[1][0])


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
    q16 = torch.zeros(2, 8, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16"):
        flash_attn_fwd(q16, q16, q16)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attn_fwd(q16.bfloat16(), q16.float(), q16.float())
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


K8_F64_NORM_RTOL = 2e-6   # 3xTF32 backward vs the plain version in float64, norm-relative
# K7 (3xTF32) against the plain forward in float64, norm-relative: at most
# this many times the cuBLAS float32 composition's error, and the label
# logit at least this many times below single-pass TF32's
K7_VS_FP32_FACTOR = 2.0
K7_VS_TF32_FACTOR = 100.0


def _lse_lab_float32(x, w, b):
    """logsumexp(x @ w + b) and the logits, cuBLAS float32 (or TF32 when
    the caller allows it)."""
    logits = x @ w + (0 if b is None else b)
    return torch.logsumexp(logits, dim=-1), logits


@pytest.mark.parametrize("bsz,d,v,bias", [(300, 64, 1000, True), (300, 64, 1000, False),
                                          (129, 36, 4100, True), (1001, 512, 4100, False),
                                          (5, 4, 8, True)])
def test_linear_ce_fwd_ragged_against_float64_and_twice_bit_equal(cuda, bsz, d, v, bias):
    """K7 at ragged B and V (not multiples of 128), labels -1 and V: within
    the gate of the cuBLAS float32 composition against float64, far below
    single-pass TF32 on the label logit, one launch a call, two calls
    bit-equal."""
    g = torch.Generator().manual_seed(bsz * v + bias)
    x = torch.randn(bsz, d, generator=g).to(cuda)
    w = (0.1 * torch.randn(d, v, generator=g)).to(cuda)
    b = torch.randn(v, generator=g).to(cuda) if bias else None
    labels = torch.randint(0, v, (bsz,), generator=g, dtype=torch.int32)
    labels[:4] = torch.tensor([0, v - 1, v, -1], dtype=torch.int32)[:min(4, bsz)]
    labels = labels.to(cuda)
    before = linear_ce_fwd.launches
    lse, lab = linear_ce_fwd(x, w, b, labels)
    lse2, lab2 = linear_ce_fwd(x, w, b, labels)
    assert linear_ce_fwd.launches == before + 2
    r_lse, r_lab = linear_ce_fwd_plain(x.double(), w.double(), None if b is None else b.double(),
                                       labels)
    rows = torch.arange(bsz, device=cuda)
    hit = (labels >= 0) & (labels < v)
    pick = labels.clamp(0, v - 1).long()
    f_lse, f_logits = _lse_lab_float32(x, w, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        t_lse, t_logits = _lse_lab_float32(x, w, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert torch.equal(lse, lse2) and torch.equal(lab, lab2)
    assert lab[2].item() == 0.0 and lab[3].item() == 0.0

    def err(got, ref):
        return ((got.double() - ref).norm() / ref.norm()).item()

    f_lab = torch.where(hit, f_logits[rows, pick], 0.0)
    t_lab = torch.where(hit, t_logits[rows, pick], 0.0)
    ulp = 2.0 ** -24            # a float32 rounding, the floor of either error
    assert err(lse, r_lse) <= K7_VS_FP32_FACTOR * max(err(f_lse, r_lse), ulp)
    assert err(lab, r_lab) <= K7_VS_FP32_FACTOR * max(err(f_lab, r_lab), ulp)
    assert err(lab, r_lab) * K7_VS_TF32_FACTOR <= err(t_lab, r_lab)


@pytest.mark.parametrize("bsz,d,v,bias", [(300, 36, 1000, True), (300, 36, 4100, False),
                                          (129, 36, 4100, True), (1001, 64, 4100, True),
                                          (5, 4, 8, True)])
def test_linear_ce_bwd_ragged_against_float64_and_twice_bit_equal(cuda, bsz, d, v, bias):
    """K8 at ragged shapes (B not a multiple of 128 nor of 4, D 36, V across
    a chunk edge at 4100), with and without bias, a label out of range on
    either side: against the plain version in float64, and two calls on the
    same inputs bit-equal (no float atomics)."""
    g = torch.Generator().manual_seed(bsz + v)
    x = torch.randn(bsz, d, generator=g).to(cuda)
    w = (0.1 * torch.randn(d, v, generator=g)).to(cuda)
    b = torch.randn(v, generator=g).to(cuda) if bias else None
    labels = torch.randint(0, v, (bsz,), generator=g, dtype=torch.int32)
    labels[:4] = torch.tensor([0, v - 1, v, -1], dtype=torch.int32)
    labels = labels.to(cuda)
    gl = torch.rand(bsz, generator=g).to(cuda)
    lse, _ = linear_ce_fwd(x, w, b, labels)
    got = linear_ce_bwd(x, w, b, labels, lse, gl)
    again = linear_ce_bwd(x, w, b, labels, lse, gl)
    ref = linear_ce_bwd_plain(x.double(), w.double(), None if b is None else b.double(), labels,
                              lse.double(), gl.double())
    torch.cuda.synchronize()
    assert (got[2] is None) == (not bias) and (ref[2] is None) == (not bias)
    for a, a2, r in zip(got, again, ref):
        if a is None:
            continue
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert torch.equal(a, a2)
        assert ((a.double() - r).norm() / r.norm()).item() <= K8_F64_NORM_RTOL
    # the rows whose label lies outside [0, V) have no one-hot: their dx is
    # the softmax's alone
    p = torch.softmax(x.double() @ w.double() + (0 if b is None else b.double()), dim=-1)
    want = (p[2:4] * gl[2:4, None].double()) @ w.double().T
    assert ((got[0][2:4].double() - want).norm() / want.norm()).item() <= K8_F64_NORM_RTOL


@pytest.mark.parametrize("bsz,d,v,bias", [(256, 128, 1024, True), (300, 64, 1000, False),
                                          (300, 72, 4100, True), (7, 520, 132, True)])
def test_linear_ce_fwd_bf16_kernel_matches_plain(cuda, bsz, d, v, bias):
    """The bf16 instance (wgmma bf16, W read as stored; V = 4100 and 132
    go through a row-padded copy): ragged rows and vocabulary, against the
    plain version, twice bit-equal, and against float64 over the same bf16
    values."""
    g = torch.Generator().manual_seed(bsz + d + v)
    x = torch.randn(bsz, d, generator=g).to(torch.bfloat16).to(cuda)
    w = (0.1 * torch.randn(d, v, generator=g)).to(torch.bfloat16).to(cuda)
    b = torch.randn(v, generator=g).to(cuda) if bias else None
    labels = torch.randint(0, v, (bsz,), generator=g, dtype=torch.int32)
    labels[:2] = torch.tensor([v - 1, v + 5])
    labels = labels.to(cuda)
    before = (linear_ce_fwd.launches, linear_ce_fwd.bf16_launches)
    lse, lab = linear_ce_fwd(x, w, b, labels)
    again = linear_ce_fwd(x, w, b, labels)
    assert (linear_ce_fwd.launches, linear_ce_fwd.bf16_launches) == \
        (before[0] + 2, before[1] + 2)
    ref = linear_ce_fwd_plain(x, w, b, labels)
    r64 = linear_ce_fwd_plain(x.double(), w.double(), b.double() if bias else None, labels)
    torch.cuda.synchronize()
    assert lse.dtype == lab.dtype == torch.float32
    assert torch.equal(lse, again[0]) and torch.equal(lab, again[1])
    assert lab[1].item() == 0.0
    for got, want, w64 in zip((lse, lab), ref, r64):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= CE_BF16_RTOL * scale
        assert (got.double() - w64).abs().max().item() <= CE_BF16_RTOL * scale


@pytest.mark.parametrize("d", [512, 520])
def test_linear_ce_fwd_bf16_several_tiles_a_block_twice_bit_equal(cuda, d):
    """K7 bf16 where each block walks several output tiles (33 x 16 of them
    over the card's blocks), across rows of W's tiles: at D = 512 an even
    and at D = 520 an odd number of 64-k steps; the two k-step sums taken
    in turn and the ring of stages carry over tile boundaries.  Two calls
    are bit-equal and within the plain version's tolerance."""
    g = torch.Generator().manual_seed(5)
    bsz, v = 2048, 4100
    x = torch.randn(bsz, d, generator=g).to(torch.bfloat16).to(cuda)
    w = (0.05 * torch.randn(d, v, generator=g)).to(torch.bfloat16).to(cuda)
    b = torch.randn(v, generator=g).to(cuda)
    labels = torch.randint(0, v, (bsz,), generator=g, dtype=torch.int32).to(cuda)
    lse, lab = linear_ce_fwd(x, w, b, labels)
    again = linear_ce_fwd(x, w, b, labels)
    ref = linear_ce_fwd_plain(x, w, b, labels)
    torch.cuda.synchronize()
    assert torch.equal(lse, again[0]) and torch.equal(lab, again[1])
    for got, want in zip((lse, lab), ref):
        assert (got - want).abs().max().item() <= CE_BF16_RTOL * want.abs().max().item()


@pytest.mark.parametrize("m,n,k", [(128, 128, 64), (36, 200, 104), (1000, 132, 8),
                                   (300, 4100, 520)])
def test_gemm_bf16_mainloop_against_float64(cuda, m, n, k):
    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
    bk = torch.randn(n, k, generator=g).to(torch.bfloat16).to(cuda)
    got, want = gemm_bf16(a.t().contiguous(), bk), a.double() @ bk.double().t()
    assert got.dtype == torch.float32
    assert ((got.double() - want).norm() / want.norm()).item() <= 1e-6


@pytest.mark.parametrize("bias", [True, False])
def test_linear_ce_bwd_no_rows_gives_zero_gradients(cuda, bias):
    d, v = 36, 1000
    x = torch.zeros(0, d, device=cuda)
    w = torch.randn(d, v, device=cuda)
    b = torch.randn(v, device=cuda) if bias else None
    empty = torch.zeros(0, device=cuda)
    dx, dw, db = linear_ce_bwd(x, w, b, empty.to(torch.int32), empty, empty)
    torch.cuda.synchronize()
    assert dx.shape == (0, d) and torch.equal(dw, torch.zeros_like(w))
    assert (db is None) if not bias else torch.equal(db, torch.zeros_like(b))


@pytest.mark.parametrize("m,n,k", [(128, 128, 32), (36, 200, 100), (1000, 132, 36),
                                   (4100, 260, 1028), (512, 256, 16384)])
@pytest.mark.parametrize("n_fast", [False, True])
def test_gemm_3xtf32_mainloop_against_float64(cuda, m, n, k, n_fast):
    """The backward's tensor-core mainloop on its own, ragged in M, N and K
    and with a long K: float32 accuracy (single-pass TF32 would be ~1e-3)."""
    g = torch.Generator().manual_seed(m + n + k)
    at = torch.randn(k, m, generator=g).to(cuda)
    bk = torch.randn(n, k, generator=g).to(cuda)
    out = gemm_3xtf32(at, bk, n_fast)
    ref = at.double().t() @ bk.double().t()
    torch.cuda.synchronize()
    assert ((out.double() - ref).norm() / ref.norm()).item() <= K8_F64_NORM_RTOL
    assert torch.equal(out, gemm_3xtf32(at, bk, n_fast))


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


def _adam_group(cuda, shapes, seed):
    """Mixed ``adam`` / ``pallas_adam`` entries on the card: every third
    one a view one float into its buffer (element by element)."""
    g = torch.Generator().manual_seed(seed)
    entries = []
    for k, shape in enumerate(shapes):
        def make(scale, rand=torch.randn):
            t = (scale * rand(*shape, generator=g)).to(cuda)
            if k % 3 == 2:          # one float into a buffer: not 16-byte aligned
                t = torch.cat([torch.zeros(1, device=cuda), t.flatten()])[1:].view(shape)
            return t
        p, grad, m1, m2 = make(1.0), make(1e-2), make(1e-3), make(1e-5, torch.rand)
        b1p, b2p = (torch.tensor(b ** (k + 1), device=cuda) for b in (0.9, 0.999))
        lr = torch.tensor(1e-3 * (1 + k % 4), device=cuda)
        entries.append((p, grad, m1, m2, b1p, b2p, lr, k % 2 == 0))
    return entries


def _copy_as(t):
    """A copy of ``t`` as far from 16-byte alignment as ``t`` is (a view
    one float into a buffer stays one)."""
    off = (t.data_ptr() % 16) // t.element_size()
    return torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:].view(
        t.shape).copy_(t)


ADAM_GROUP_SHAPES = [(32000, 512), (512,), (2048, 512), (7,), (512, 2048), (1001,), (3, 5),
                     (64, 130), (0,), (4097,)]


@pytest.mark.parametrize("extra", [0, fused_optimizer.ADAM_CAPACITY])
def test_fused_adam_multi_bit_equal_to_plain_over_mixed_groups(cuda, extra):
    """One launch over a mixed group (two launches when ``extra`` small
    tensors push it over one launch's table), in place: every output of
    every entry bit-equal to its op type's plain version (run in place on
    other clones of the inputs); flipping one entry's expression flag
    changes its Moment2Out."""
    shapes = ADAM_GROUP_SHAPES + [(1 + k % 9,) for k in range(extra)]
    entries = _adam_group(cuda, shapes, seed=len(shapes))

    def clones(flip=False):
        return [tuple(_copy_as(t) for t in e[:7]) + ((not e[7]) if flip and k == 0 else e[7],)
                for k, e in enumerate(entries)]
    mine = clones()
    before = fused_adam.launches
    got = fused_adam_multi(mine, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert fused_adam.launches == before + (1 if extra == 0 else 2)
    assert all(o[0] is e[0] and o[1] is e[2] and o[2] is e[3] for o, e in zip(got, mine))
    for k, (outs, want) in enumerate(zip(got, fused_adam_multi_plain(clones(), 0.9, 0.999,
                                                                     1e-8))):
        for a, b in zip(outs, want):
            assert a.shape == b.shape and torch.equal(a, b), (k, shapes[k])
    again = fused_adam_multi(clones(flip=True), 0.9, 0.999, 1e-8)
    assert not torch.equal(again[0][2], got[0][2])
    assert all(torch.equal(a, b) for o, w in zip(again[1:], got[1:]) for a, b in zip(o, w))


@pytest.mark.parametrize("extra", [0, fused_optimizer.SGD_CAPACITY])
def test_fused_sgd_multi_bit_equal_to_plain_over_mixed_groups(cuda, extra):
    shapes = ADAM_GROUP_SHAPES + [(1 + k % 9,) for k in range(extra)]
    entries = [e[:2] + (torch.tensor([0.37 + 0.01 * (k % 3)], device=cuda),)
               for k, e in enumerate(_adam_group(cuda, shapes, seed=3))]
    plain = fused_sgd_multi_plain([(e[0].clone(),) + e[1:] for e in entries])
    before = fused_sgd.launches
    got = fused_sgd_multi(entries)
    torch.cuda.synchronize()
    assert fused_sgd.launches == before + (1 if extra == 0 else 2)
    for k, (out, want) in enumerate(zip(got, plain)):
        assert out is entries[k][0] and torch.equal(out, want), (k, shapes[k])


@pytest.mark.parametrize("op_type", ["adam", "pallas_adam"])
def test_adam_op_on_the_card_bit_equal_to_the_cpu(cuda, op_type):
    """Each Adam op type on the card computes its own expression, as on
    the CPU: ``adam`` the composed ``((1 - b2) * g) * g``, ``pallas_adam``
    ``fused_adam``'s ``(1 - b2) * (g * g)``."""
    from paddle_tpu_torch.core.desc import OpDesc
    from paddle_tpu_torch.core.lower import LowerCtx, lower_op
    ins = ("Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
    outs = ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut")
    op = OpDesc(type=op_type, inputs={s: [s] for s in ins}, outputs={s: [s] for s in outs},
                attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
    entry = _adam_group(cuda, [(4096, 33)], seed=9)[0]
    res = []
    for dev in (cuda, torch.device("cpu")):
        ctx = LowerCtx(None, {s: t.to(dev, copy=True) for s, t in zip(ins, entry[:7])},
                       torch.Generator(), dev)
        lower_op(ctx, op)
        res.append([ctx.read(s).cpu() for s in outs])
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("v,d", [(1024, 128), (256, 512), (77, 30)])
def test_scatter_add_kernel_matches_plain(cuda, v, d):
    """Bit-equal to the plain version run on the CPU: both add each row's
    incoming rows in ascending n from +0.0."""
    g = torch.Generator().manual_seed(v)
    w = torch.zeros(v, d, device=cuda)
    ids = torch.randint(0, v, (4096,), generator=g, dtype=torch.int32)
    ids[:3] = torch.tensor([v, -1, 0], dtype=torch.int32)
    rows = torch.randn(4096, d, generator=g)
    before = scatter_add_rows.launches
    got = scatter_add_rows(w, ids.to(cuda), rows.to(cuda))
    want = scatter_add_rows_plain(w.cpu(), ids, rows)
    torch.cuda.synchronize()
    assert scatter_add_rows.launches == before + 1
    assert torch.equal(got.cpu(), want)


# segment lengths about the kernel's boundaries: 32 ids go to a row block and
# 33 to the long blocks; a stage of a long block's ring holds 56, 112 or 224
# rows (by the slice's width), the ring 4 stages
SEGMENT_LENGTHS = [32, 33, 55, 56, 57, 111, 112, 113, 223, 224, 225, 447, 448, 449, 895, 896, 897]


def _scatter_ids(v, n, ids_kind, g):
    """int32 ids of one kind: "all equal" (one segment of every id),
    "padding" (a quarter of the ids 0, as a padded batch gives), "positions"
    (0..v-1 tiled, as the position table's ids), "two long" (every id 5 or
    6: two long segments side by side), "lengths" (segments of
    SEGMENT_LENGTHS ids, shuffled; n is ignored), "out of range", or
    "random" (a few out of range)."""
    if ids_kind == "all equal":
        return torch.full((n,), 7, dtype=torch.int32)
    if ids_kind == "padding":
        ids = torch.randint(1, v, (n,), generator=g, dtype=torch.int32)
        ids[torch.rand(n, generator=g) < 0.25] = 0
        return ids
    if ids_kind == "positions":
        return torch.arange(v, dtype=torch.int32).repeat(n // v)
    if ids_kind == "two long":
        return torch.randint(5, 7, (n,), generator=g, dtype=torch.int32)
    if ids_kind == "lengths":
        ids = torch.cat([torch.full((k,), 3 * i + 1, dtype=torch.int32)
                         for i, k in enumerate(SEGMENT_LENGTHS)])
        return ids[torch.randperm(len(ids), generator=g)]
    if ids_kind == "out of range":
        return torch.randint(-v, 2 * v, (n,), generator=g, dtype=torch.int32)
    return torch.randint(-2, v + 2, (n,), generator=g, dtype=torch.int32)


SCATTER_MAIN_PATH_CASES = [
    (32000, 512, 16384, "padding"),   # the step's padded word table
    (256, 512, 16384, "positions"),   # the step's position ids: arange(256) tiled 64 times
    (300, 512, 16384, "all equal"),   # one segment of every id, 16 column slices
    (300, 130, 16384, "all equal"),   # the same at a ragged D (element accesses)
    (64, 512, 9000, "two long"),      # two long segments side by side
    (64, 512, 0, "lengths"),          # segment lengths about the boundaries
    (64, 130, 0, "lengths")]


@pytest.mark.parametrize("v,d,n,ids_kind", [
    (1000, 36, 5000, "random"),       # ragged V and D (scalar path)
    (4100, 64, 9000, "random"),
    (70000, 8, 9000, "random"),       # three radix passes
    (300, 64, 5000, "all equal"),     # one segment of every id
    (4100, 64, 9000, "padding"),      # a quarter of the ids 0: one long segment
    (256, 36, 16384, "random"),       # 64 ids a row: every segment long
    (33, 130, 0, "random"),           # no ids: every row written as zeros
    (256, 512, 16384, "out of range")] + SCATTER_MAIN_PATH_CASES)
def test_scatter_add_kernel_bit_equal_to_cpu_and_to_itself(cuda, v, d, n, ids_kind):
    """Rows of mixed magnitude, so that another order of addition would
    show in the last bits; ids out of range on both sides add nothing."""
    g = torch.Generator().manual_seed(v + d + n)
    ids = _scatter_ids(v, n, ids_kind, g)
    n = len(ids)
    rows = torch.randn(n, d, generator=g) * torch.exp(3 * torch.randn(n, 1, generator=g))
    w = torch.empty(v, d, device=cuda)
    got = scatter_add_rows(w, ids.to(cuda), rows.to(cuda))
    again = scatter_add_rows(w, ids.to(cuda), rows.to(cuda))
    want = scatter_add_rows_plain(w.cpu(), ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("v,d,n,ids_kind", [
    (1000, 36, 5000, "random"),       # ragged V and D (scalar path)
    (4100, 64, 9000, "padding"),      # a quarter of the ids 0: one long segment
    (256, 36, 16384, "random"),       # 64 ids a row: every segment long
    (32000, 512, 16384, "random"),    # the word table
    (256, 512, 16384, "out of range")] + SCATTER_MAIN_PATH_CASES)
def test_scatter_add_bf16_kernel_bit_equal_to_cpu_and_to_itself(cuda, v, d, n, ids_kind):
    """The bf16 instance: bf16 rows summed in float32 in ascending n and
    rounded once, bit-equal to the plain version on the CPU."""
    g = torch.Generator().manual_seed(v + d + n + 1)
    ids = _scatter_ids(v, n, ids_kind, g)
    n = len(ids)
    rows = (torch.randn(n, d, generator=g)
            * torch.exp(3 * torch.randn(n, 1, generator=g))).to(torch.bfloat16)
    w = torch.empty(v, d, device=cuda, dtype=torch.bfloat16)
    before = scatter_add_rows.bf16_launches
    got = scatter_add_rows(w, ids.to(cuda), rows.to(cuda))
    again = scatter_add_rows(w, ids.to(cuda), rows.to(cuda))
    want = scatter_add_rows_plain(w.cpu(), ids, rows)
    torch.cuda.synchronize()
    assert scatter_add_rows.bf16_launches == before + 2 and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)


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


def _train_step_on_card_vs_cpu(kernels):
    """One 2+2-layer Adam step on the card and on the CPU from the same
    weights; returns the launches of K1, K2, K3, K6, K7, K8 on the card and
    the parameter count."""
    main, startup, loss = _train_programs()
    gpu_scope, cpu_scope = pt.Scope(), pt.Scope()
    gpu, cpu = pt.Executor(kernels=kernels), pt.Executor(pt.CPUPlace())
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
    # the step's graph is captured first (its eager run on clones of the
    # state launches every kernel once): the launches counted are one replay's
    gpu.precompile(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    counts = [f.launches for f in (flash_attn_fwd, gather_rows, scatter_add_rows,
                                   fused_adam, linear_ce_fwd, linear_ce_bwd)]
    got = gpu.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    after = [f.launches for f in (flash_attn_fwd, gather_rows, scatter_add_rows,
                                  fused_adam, linear_ce_fwd, linear_ce_bwd)]
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for n, a, b in zip(fetch[1:], got[1:], want[1:]):
        assert np.isfinite(a).all(), n
        np.testing.assert_allclose(a, b, atol=1e-5 + 1e-4 * np.abs(b).max(), rtol=1e-4,
                                   err_msg=n)
    return [a - c for a, c in zip(after, counts)], len(params)


def test_small_training_step_on_card_matches_cpu_and_uses_the_kernels(cuda):
    launches, n_params = _train_step_on_card_vs_cpu(kernels=None)   # on for the card
    # K1: 6 attention ops, forward and grad retrace; K2 once per embedding
    # (the kernel tier's pallas_scatter_add reads the output gradient and
    # runs no gather again); K3 once per embedding grad; K6 once a step over
    # every parameter
    assert launches == [12, 4, 4, 1, 1, 1]


def test_small_bf16_training_step_on_card_matches_cpu(cuda):
    """``enable_amp``: one 2+2-layer bf16 Adam step on the card (kernel tier
    on, then the amp-bf16 bridge) and on the CPU from the same weights."""
    main, startup, loss = _train_programs()
    params = [p.name for p in main.global_block.all_parameters()]
    gpu_scope, cpu_scope = pt.Scope(), pt.Scope()
    gpu, cpu = pt.Executor(), pt.Executor(pt.CPUPlace())
    gpu.run(startup, scope=gpu_scope)
    persist = [v.name for v in main.list_vars() if v.persistable]
    pt.params_from_numpy({n: gpu_scope.find_var(n).cpu().numpy() for n in persist},
                         cpu_scope, "cpu")
    rs = np.random.RandomState(0)
    feed = {"src": rs.randint(1, 1000, (3, 32, 1)), "trg": rs.randint(1, 1000, (3, 32, 1)),
            "lbl": rs.randint(1, 1000, (3, 32, 1)),
            "src@SEQ_LEN": np.array([32, 0, 9], np.int32),
            "trg@SEQ_LEN": np.array([5, 32, 1], np.int32)}
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    pt.amp.enable_amp(main)
    gpu.precompile(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    before = (flash_attn_fwd.bf16_launches, scatter_add_rows.bf16_launches,
              linear_ce_fwd.bf16_launches, linear_ce_bwd.launches)
    got = gpu.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    after = (flash_attn_fwd.bf16_launches, scatter_add_rows.bf16_launches,
             linear_ce_fwd.bf16_launches, linear_ce_bwd.launches)
    want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    assert [a - c for a, c in zip(after, before)] == [12, 4, 1, 1]
    np.testing.assert_allclose(got[0], want[0], rtol=BF16_STEP_LOSS_RTOL)
    for n, a, b in zip(fetch[1:], got[1:], want[1:]):
        assert a.dtype == np.float32 and np.isfinite(a).all(), n
        assert np.linalg.norm(a - b) <= BF16_STEP_GRAD_NREL * np.linalg.norm(b), n


def test_full_width_bf16_step_launches_the_bf16_instances(cuda):
    """transformer-base (vocab 32000, d_model 512, 8 heads, 6+6 layers,
    d_inner 2048) under ``enable_amp``, one step at 2 x 256: K1 36 times in
    bf16, K2 4 (float32 tables), K3 4 in bf16 (the pass casts each table for
    its gradient), K6 once over the 186 parameters (the gradient casts
    between the updates run ahead of it), K7 once in bf16, K8 once in
    float32."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[256, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, 32000, 32000, max_len=256,
                                            n_layer=6, d_model=512, n_head=8, d_inner=2048,
                                            fuse_final_ce=True)
        pt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    pt.amp.enable_amp(main)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    feed = {"src": rs.randint(1, 32000, (2, 256, 1)), "trg": rs.randint(1, 32000, (2, 256, 1)),
            "lbl": rs.randint(1, 32000, (2, 256, 1)),
            "src@SEQ_LEN": np.array([256, 130], np.int32),
            "trg@SEQ_LEN": np.array([200, 256], np.int32)}
    counters = (flash_attn_fwd, gather_rows, scatter_add_rows, fused_adam, linear_ce_fwd,
                linear_ce_bwd)
    exe.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
    before = [f.launches for f in counters] + [f.bf16_launches for f in
                                               (flash_attn_fwd, scatter_add_rows, linear_ce_fwd)]
    (l,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = [f.launches for f in counters] + [f.bf16_launches for f in
                                              (flash_attn_fwd, scatter_add_rows, linear_ce_fwd)]
    assert np.isfinite(l).all()
    assert [a - c for a, c in zip(after, before)] == [36, 4, 4, 1, 1, 1, 36, 4, 1]


def test_small_training_step_without_the_kernel_tier_on_card(cuda):
    """``kernels=False``: lookup_table_grad differentiates the gather
    (GatherRows.backward), so K2 runs again under autograd before K3."""
    launches, n_params = _train_step_on_card_vs_cpu(kernels=False)
    assert launches == [12, 8, 4, 1, 1, 1]


@pytest.mark.parametrize("m", [256, 2048])
@pytest.mark.parametrize("k,n", [(512, 512), (512, 2048), (2048, 512), (512, 32000)])
def test_int8_kernel_matches_plain_bit_equal(cuda, m, k, n):
    """The serving path's GEMM shapes: raw int32 products, and the whole
    quantize -> GEMM -> dequantize against the plain version."""
    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g).to(cuda)
    y = (0.05 * torch.randn(k, n, generator=g)).to(cuda)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(cuda)
    yqt = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(cuda)
    scales = torch.tensor([3.7, 0.21], device=cuda)
    before = int8_matmul.launches
    got = int8_mm(xq, yqt)
    out = int8_matmul(x, y)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 2
    assert got.dtype == torch.int32 and torch.equal(got, int8_mm_plain(xq, yqt))
    assert torch.equal(out, int8_matmul_plain(x, y))
    # the float32 epilogue: float(acc) * ((s_x * s_y) * float32(1 / 127**2))
    deq = int8_mm(xq, yqt, scales, 127.0)
    assert deq.dtype == torch.float32 and torch.equal(deq, int8_mm_plain(xq, yqt, scales, 127.0))


@pytest.mark.parametrize("m,k,n", [(7, 100, 33), (300, 96, 1000), (129, 4096, 130), (1, 16, 1)])
def test_int8_kernel_masks_ragged_edges(cuda, m, k, n):
    g = torch.Generator().manual_seed(m)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(cuda)
    yqt = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(cuda)
    assert torch.equal(int8_mm(xq, yqt), int8_mm_plain(xq, yqt))
    scales = torch.tensor([0.5, 1e-9], device=cuda)        # the second under the 1e-8 floor
    assert torch.equal(int8_mm(xq, yqt, scales, 7.0), int8_mm_plain(xq, yqt, scales, 7.0))
    x, y = torch.randn(m, k, generator=g).to(cuda), torch.randn(k, n, generator=g).to(cuda)
    assert torch.equal(int8_matmul(x, y, bits=4), int8_matmul_plain(x, y, bits=4))


@pytest.mark.parametrize("r,c", [(7, 100), (300, 96), (129, 4100), (2048, 512), (512, 2048),
                                 (1, 1)])
@pytest.mark.parametrize("transpose", [False, True])
def test_quantize_kernels_match_plain_bit_equal(cuda, r, c, transpose):
    """abs-max of both operands in one launch, then the quantize pass:
    int8 rows zero-padded to 16 bytes (the weight transposed)."""
    g = torch.Generator().manual_seed(r * c)
    x = (3 * torch.randn(r, c, generator=g)).to(cuda)
    y = (0.02 * torch.randn(c, r + 3, generator=g)).to(cuda)
    before = abs_max_pair.launches, quantize_int8.launches
    scales = abs_max_pair(x, y)
    q = quantize_int8(x, scales, 0, 127.0, transpose=transpose)
    torch.cuda.synchronize()
    assert (abs_max_pair.launches, quantize_int8.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(scales, abs_max_pair_plain(x, y))
    want = quantize_int8_plain(x, scales, 0, 127.0, transpose)
    assert q.dtype == torch.int8 and q.shape == want.shape and q.shape[1] % 16 == 0
    assert torch.equal(q, want)
    # a scale under the 1e-8 floor, and 4 bits
    tiny = torch.tensor([1e-9, 0.0], device=cuda)
    assert torch.equal(quantize_int8(1e-9 * x, tiny, 1, 7.0, transpose),
                       quantize_int8_plain(1e-9 * x, tiny, 1, 7.0, transpose))


def test_int8_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(4, 8, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="device"):
        int8_mm(q, q.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        int8_mm(torch.zeros(8, 4, dtype=torch.int8, device=cuda).t(), q)
    with pytest.raises(ValueError, match="bit_length"):
        int8_matmul(torch.zeros(4, 8, device=cuda), torch.zeros(8, 2, device=cuda), bits=12)


@pytest.mark.parametrize("shape", [(32000, 512), (1001,), (64, 130)])
def test_fused_sgd_kernel_matches_plain_bit_equal(cuda, shape):
    """float4 and scalar paths; lr * g of p's size, where one rounding and
    two differ most often."""
    g = torch.Generator().manual_seed(len(shape))
    p, grad = (torch.randn(*shape, generator=g).to(cuda) for _ in range(2))
    lr = torch.tensor([0.37], device=cuda)
    before = fused_sgd.launches
    got = fused_sgd(p, grad, lr)
    torch.cuda.synchronize()
    assert fused_sgd.launches == before + 1
    assert torch.equal(got, fused_sgd_plain(p, grad, lr))
    assert got.data_ptr() != p.data_ptr()


def test_small_int8_transformer_on_card_matches_cpu_and_uses_the_kernels(cuda):
    amp = pt.amp.AmpConfig(bf16=False, quant=True)
    gpu = pt.Inferencer(_infer_func, amp=amp)            # kernels on by default on the card
    sim = pt.Inferencer(_infer_func, amp=amp, kernels=False)
    cpu = pt.Inferencer(_infer_func, place=pt.CPUPlace(), amp=amp)
    params = {n: gpu.scope.find_var(n).cpu().numpy()
              for n, v in gpu.inference_program.global_block.vars.items() if v.persistable}
    pt.params_from_numpy(params, cpu.scope, "cpu")
    pt.params_from_numpy(params, sim.scope, "cuda")
    f32 = pt.Inferencer(_infer_func, place=pt.CPUPlace())    # the unquantized control
    pt.params_from_numpy(params, f32.scope, "cpu")
    rs = np.random.RandomState(0)
    card, control = [], []
    for i, rows in enumerate((1, 3, 5, 8) * 4):
        feed = {}
        for name in ("src", "trg"):
            lens = rs.randint(0 if i == 1 else 1, 33, rows).astype(np.int32)
            feed[name], feed[name + "@SEQ_LEN"] = rs.randint(1, 1000, (rows, 32, 1)), lens
        counts = [f.launches for f in (int8_matmul, flash_attn_fwd, gather_rows)]
        (got,) = gpu.infer(feed)
        after = [f.launches for f in (int8_matmul, flash_attn_fwd, gather_rows)]
        assert [a - c for a, c in zip(after, counts)] == [33, 6, 4]
        (want,) = cpu.infer(feed)
        assert got.shape == (rows, 32, 1000) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=INT8_LOGIT_ATOL, rtol=0)
        # the simulated fake-quant path on the card: exact float32 sums, bit-equal
        np.testing.assert_array_equal(got, sim.infer(feed)[0])
        card.append(np.linalg.norm(got - want) / np.linalg.norm(want))
        control.append(np.linalg.norm(f32.infer(feed)[0] - want) / np.linalg.norm(want))
    print("int8 card vs CPU, norm-relative per batch:", [f"{e:.3g}" for e in card])
    print("float32 control vs CPU int8:", [f"{e:.3g}" for e in control])
    assert np.mean(np.asarray(card) <= QUIET_REL_ERR) >= QUIET_SHARE
    assert np.mean(np.asarray(control) <= QUIET_REL_ERR) < QUIET_SHARE


def test_small_sgd_training_step_on_card_launches_fused_sgd(cuda):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[64])
        loss = pt.layers.mean(pt.layers.fc(input=pt.layers.fc(input=x, size=96), size=8))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope, cpu_scope = pt.Scope(), pt.Scope()
    gpu, cpu = pt.Executor(), pt.Executor(pt.CPUPlace())
    gpu.run(startup, scope=scope)
    persist = [v.name for v in main.list_vars() if v.persistable]
    pt.params_from_numpy({n: scope.find_var(n).cpu().numpy() for n in persist}, cpu_scope, "cpu")
    feed = {"x": np.random.RandomState(0).randn(16, 64).astype(np.float32)}
    gpu.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
    before = fused_sgd.launches
    gpu.run(main, feed=feed, fetch_list=[loss], scope=scope)
    # one pallas_sgd (the 64 x 96 weight) and three sgd ops: one K5 launch
    # updates all four
    assert fused_sgd.launches - before == 1
    cpu.run(main, feed=feed, fetch_list=[loss], scope=cpu_scope)
    for n in persist:
        np.testing.assert_allclose(scope.find_var(n).cpu().numpy(), cpu_scope.find_var(n).numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=n)


# ------------------------------------------------ the executable cache's graphs

SMALL_SPECS = {"src": ((32, 1), "int64"), "trg": ((32, 1), "int64"),
               "src@SEQ_LEN": ((), "int32"), "trg@SEQ_LEN": ((), "int32")}
INT8_AMP = pt.amp.AmpConfig(bf16=False, quant=True)


def _small_feed(rs, rows):
    feed = {}
    for name in ("src", "trg"):
        feed[name] = rs.randint(1, 1000, (rows, 32, 1))
        feed[name + "@SEQ_LEN"] = rs.randint(1, 33, rows).astype(np.int32)
    return feed


def _warm(amp=None, buckets=(1, 2)):
    """A 2+2-layer Inferencer on the card with a graph captured at each
    bucket."""
    inf = pt.Inferencer(_infer_func, amp=amp)
    report = inf.warmup(buckets, feed_specs=SMALL_SPECS)
    assert [(r["batch_size"], r["kind"], r["aot"]) for r in report] == \
        [(b, "graph", True) for b in buckets]
    return inf


def _captures(exe):
    return exe.cache_info()["captures"]


def _eager(inf, feed, **kw):
    return inf.exe._run_eager(inf.inference_program, feed=feed, fetch_list=inf.predict_vars,
                              scope=inf.scope, **kw)


@pytest.mark.parametrize("amp", [None, INT8_AMP], ids=["float32", "int8"])
def test_graph_replay_matches_the_eager_run_of_the_same_batch(cuda, amp):
    inf = _warm(amp)
    rs = np.random.RandomState(1)
    feed, other = _small_feed(rs, 2), _small_feed(rs, 2)
    (got,) = inf.infer(feed)
    (want,) = _eager(inf, feed)
    print(f"replay vs eager, max abs diff {float(np.abs(got - want).max()):.3e} "
          f"(bit-equal: {np.array_equal(got, want)})")
    np.testing.assert_array_equal(got, want)
    # the control: the replay of another batch (the static feed buffers hold
    # each run's feeds) is far outside the gate
    (got_other,) = inf.infer(other)
    assert np.abs(got_other - want).max() > 1e-2
    info = inf.exe.cache_info()
    assert info["captures"] == 2 and info["hits"] == 2
    assert all(e["kind"] == "graph" for e in info["entries"] if e["graph_eligible"])


def test_sync_false_handles_keep_their_values_across_replays(cuda):
    """Two batches at one bucket with sync=False, then the first read: it
    holds its own values, though the second replay has overwritten the
    graph's output buffer (the control)."""
    inf = _warm()
    rs = np.random.RandomState(2)
    a, b = _small_feed(rs, 2), _small_feed(rs, 2)
    (ha,) = inf.infer(a, sync=False)
    (hb,) = inf.infer(b, sync=False)
    got_a, got_b = ha.numpy(), hb.numpy()
    np.testing.assert_array_equal(got_a, _eager(inf, a)[0])
    np.testing.assert_array_equal(got_b, _eager(inf, b)[0])
    (entry,) = [e for e in inf.exe._cache.values() if e.feeds.get("src", [None])[0] == (2, 32, 1)]
    buffer = entry.outputs[0].cpu().numpy()
    assert np.array_equal(buffer, got_b) and not np.array_equal(buffer, got_a)
    # return_numpy=False: clones, never the graph's own buffer
    (t,) = inf.infer(a, return_numpy=False)
    assert t.is_cuda and t.data_ptr() != entry.outputs[0].data_ptr()
    np.testing.assert_array_equal(t.cpu().numpy(), got_a)


def test_rebound_parameter_is_captured_again_and_in_place_update_is_read(cuda):
    inf = _warm(buckets=(2,))
    feed = _small_feed(np.random.RandomState(3), 2)
    (before,) = inf.infer(feed)
    name = next(n for n, v in inf.inference_program.global_block.vars.items()
                if v.persistable and "fc" in n and n.endswith(".w_0"))
    w = inf.scope.find_var(name)
    captures = _captures(inf.exe)
    executables = inf.exe.cache_info()["executables"]
    w.mul_(1.5)                                   # in place: the same address, a hit
    (in_place,) = inf.infer(feed)
    assert _captures(inf.exe) == captures
    assert not np.array_equal(in_place, before)
    np.testing.assert_array_equal(in_place, _eager(inf, feed)[0])
    inf.scope.set_var(name, w / 1.5)              # a new tensor: a miss and a capture
    (rebound,) = inf.infer(feed)
    assert _captures(inf.exe) == captures + 1
    # the new graph replaced the one captured over the old tensor
    assert inf.exe.cache_info()["executables"] == executables
    np.testing.assert_allclose(rebound, before, atol=LOGIT_ATOL, rtol=0)
    (again,) = inf.infer(feed)                    # the new graph replays
    np.testing.assert_array_equal(again, _eager(inf, feed)[0])


def test_replay_launches_equal_the_eager_run(cuda):
    """int8: a replay adds to every kernel counter what an eager run of the
    batch adds; the capture itself (which launches nothing) adds nothing,
    so warming a bucket adds one eager run's launches (the control: two
    would mean the capture was counted)."""
    counters = (int8_matmul, abs_max_pair, quantize_int8, flash_attn_fwd, gather_rows)
    read = lambda: [f.launches for f in counters]      # noqa: E731
    inf = pt.Inferencer(_infer_func, amp=INT8_AMP)
    feed = _small_feed(np.random.RandomState(4), 2)
    c0 = read()
    _eager(inf, feed)
    c1 = read()
    eager = [b - a for a, b in zip(c0, c1)]
    assert eager == [33, 33, 66, 6, 4]
    inf.warmup((2,), feed_specs=SMALL_SPECS)
    c2 = read()
    assert [b - a for a, b in zip(c1, c2)] == eager
    inf.infer(feed)
    c3 = read()
    assert [b - a for a, b in zip(c2, c3)] == eager
    (entry,) = inf.exe.cache_info()["entries"][1:]
    assert entry["launches"]["int8_matmul.launches"] == 33


def test_fetches_come_from_pinned_memory(cuda):
    inf = _warm(buckets=(1,))
    feed = _small_feed(np.random.RandomState(5), 1)
    (h,) = inf.infer(feed, sync=False)
    assert not h.value.is_cuda and h.value.is_pinned()
    a = h.numpy()
    assert a.ctypes.data == h.value.data_ptr()          # the array is the pinned buffer
    # the control: a fetch on the CPU place is not pinned
    cpu = pt.Inferencer(_infer_func, place=pt.CPUPlace())
    (hc,) = cpu.infer(feed, sync=False)
    assert not hc.value.is_pinned()


def test_kept_fetches_pin_no_more_than_the_limit(cuda, monkeypatch):
    """A caller that keeps every answer: arrays over pinned buffers are
    handed out until the limit (two 2-row blocks here), later reads are
    copied out to pageable memory, and the pinned bytes held go back as
    the arrays go.  The control: the first reads are pinned."""
    import gc
    from paddle_tpu_torch.core import staging
    inf = _warm(buckets=(2,))
    feed = _small_feed(np.random.RandomState(8), 2)
    (probe,) = inf.infer(feed, sync=False)
    block = staging._block_bytes(probe.value)
    del probe
    gc.collect()
    base = staging.PINNED_HANDOUT.snapshot()
    monkeypatch.setattr(staging, "PINNED_HANDOUT_LIMIT", base["bytes"] + 2 * block)
    handles = [inf.infer(feed, sync=False)[0] for _ in range(5)]
    kept = [h.numpy() for h in handles]
    pinned = [h.value.is_pinned() for h in handles]
    assert pinned == [True, True, False, False, False]
    assert all(a.ctypes.data == h.value.data_ptr() for a, h in zip(kept, handles))
    now = staging.PINNED_HANDOUT.snapshot()
    assert now["bytes"] - base["bytes"] == 2 * block and now["copies"] - base["copies"] == 3
    for a in kept[1:]:
        np.testing.assert_array_equal(a, kept[0])
    del kept, handles
    assert staging.PINNED_HANDOUT.snapshot()["bytes"] == base["bytes"]


def test_evaluating_between_training_steps_keeps_memory_flat(cuda):
    """An Adam step (K6 updates every parameter in place) and then a
    forward-only clone on the same scope, six times: the step and the
    evaluation are each captured once and then replayed, so the cache's
    size and the card's allocated memory stay flat, and the evaluation
    reads the step's parameters."""
    import gc
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[64])
        loss = pt.layers.mean(pt.layers.fc(input=pt.layers.fc(input=x, size=96), size=8))
        test = main.clone()
        pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(9).randn(16, 64).astype(np.float32)}
    sizes, mem, caps = [], [], []
    for _ in range(6):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        (ev,) = exe.run(test, feed=feed, fetch_list=[loss.name], scope=scope)
        gc.collect()
        torch.cuda.synchronize()
        sizes.append(exe.cache_info()["executables"])
        mem.append(torch.cuda.memory_allocated())
        caps.append(_captures(exe))
    print(f"executables {sizes}, captures {caps}, allocated bytes {mem}")
    assert sizes == [3] * 6
    assert caps == [2] * 6
    assert exe.cache_info()["entries"][1]["kind"] == "graph"
    assert mem[5] == mem[1]
    (want,) = exe._run_eager(test, feed, [loss.name], scope)
    np.testing.assert_array_equal(ev, want)


def test_precompile_runs_an_eager_entry_once_writing_no_state(cuda):
    """A dropout program (its graph registers the scope's generator) is
    run once on the card by ``precompile``, on a copy of the generator, and
    captured -- the kernel library and cuBLAS are set up then, not by the
    first live request -- and the scope, its generator included, is left
    as it was.  The control: a second precompile hits and runs nothing."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids = layers.data(name="ids", shape=[1], dtype="int64")
        emb = layers.embedding(ids, size=[1000, 64])
        out = layers.dropout(emb, dropout_prob=0.5, is_test=False)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    names = sorted(scope._vars)
    before = {n: v.clone() for n, v in scope._vars.items() if isinstance(v, torch.Tensor)}
    rng = scope.find_var(RNG_STATE_VAR).get_state()
    spec = {"ids": ((4, 1), "int64")}
    launches = gather_rows.launches
    rec = exe.precompile(main, feed=spec, fetch_list=[out], scope=scope)
    assert (rec["kind"], rec["aot"], rec["reasons"]) == ("graph", True, [])
    assert gather_rows.launches == launches + 1
    assert sorted(scope._vars) == names
    assert torch.equal(scope.find_var(RNG_STATE_VAR).get_state(), rng)
    for n, v in before.items():
        assert torch.equal(scope.find_var(n), v), n
    exe.precompile(main, feed=spec, fetch_list=[out], scope=scope)
    assert gather_rows.launches == launches + 1


def test_failed_capture_raises_and_caches_nothing(cuda):
    """A lowering that reads a device value on the host (``.item()``) runs
    eagerly but cannot be captured: the run raises, no entry is cached and
    nothing runs eagerly instead.  The control: without the host read the
    same program is captured."""
    from paddle_tpu_torch.core.registry import OPS, register_lowering
    op_type = "_test_host_read"

    @register_lowering(op_type)
    def _lower(ctx, op):
        x = ctx.read_slot(op, "X")
        ctx.write_slot(op, "Out", x + (x.sum().item() if op.attr("host_read") else 0.0))

    try:
        for host_read in (False, True):
            main, startup = pt.Program(), pt.Program()
            with pt.program_guard(main, startup):
                x = layers.data(name="x", shape=[4])
                out = main.global_block.create_var(name="out", shape=(-1, 4))
                main.global_block.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                                            attrs={"host_read": host_read})
            exe = pt.Executor()
            feed = {"x": np.ones((2, 4), np.float32)}
            if not host_read:
                np.testing.assert_array_equal(exe.run(main, feed=feed, fetch_list=[out])[0],
                                              feed["x"])
                assert exe.cache_info()["entries"][0]["kind"] == "graph"
                continue
            stream = torch.cuda.current_stream()
            with pytest.raises(RuntimeError, match="capturing block 0"):
                exe.run(main, feed=feed, fetch_list=[out])
            assert exe.cache_info()["executables"] == 0
            # the process goes on: its stream and the default generator are as before
            assert torch.cuda.current_stream() == stream
            assert torch.randn(4, device=cuda).isfinite().all()
        torch.cuda.synchronize()
    finally:
        del OPS._map[op_type]


# ------------------------------------------------ the training step's graph


def _small_train_feed():
    rs = np.random.RandomState(0)
    return {"src": rs.randint(1, 1000, (3, 32, 1)), "trg": rs.randint(1, 1000, (3, 32, 1)),
            "lbl": rs.randint(1, 1000, (3, 32, 1)),
            "src@SEQ_LEN": np.array([32, 0, 9], np.int32),
            "trg@SEQ_LEN": np.array([5, 32, 1], np.int32)}


def _sgd_train_programs():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[32, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, 1000, 1000, max_len=32,
                                            n_layer=2, d_model=64, n_head=4,
                                            d_inner=256, fuse_final_ce=True)
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _state(main, scope):
    return {v.name: scope.find_var(v.name) for v in main.list_vars() if v.persistable}


@pytest.mark.parametrize("kind", ["float32", "bf16", "sgd"])
def test_replayed_step_bit_equal_to_an_eager_step(cuda, kind):
    """A 2+2-layer step through its graph (a replay: the capture and the
    first replay come before) and eagerly (``_run_eager``, op by op) from
    the same state and feed: the loss and every parameter, moment and beta
    power bit-equal, and every state tensor at the address it had before
    the first step; one capture."""
    main, startup, loss = _sgd_train_programs() if kind == "sgd" else _train_programs()
    if kind == "bf16":
        pt.amp.enable_amp(main)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = _small_train_feed()
    addrs = {n: t.data_ptr() for n, t in _state(main, scope).items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    state0 = {n: t.clone() for n, t in _state(main, scope).items()}
    (replayed,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = {n: t.clone() for n, t in _state(main, scope).items()}
    for n, t in _state(main, scope).items():
        t.copy_(state0[n])
    (eager,) = exe._run_eager(main, feed, [loss], scope)
    assert np.isfinite(replayed) and np.array_equal(replayed, eager)
    differ = [n for n, t in _state(main, scope).items() if not torch.equal(t, after[n])]
    assert not differ, differ[:8]
    assert not any(torch.equal(after[n], state0[n]) for n in after if "moment1" in n)
    assert {n: t.data_ptr() for n, t in _state(main, scope).items()} == addrs
    info = exe.cache_info()
    assert info["captures"] == 1 and info["entries"][1]["kind"] == "graph"


@pytest.mark.parametrize("shape", [(3 * fused_optimizer.CHUNK + 5,), (32000, 512)])
def test_fused_adam_in_place_over_several_chunks_bit_equal_to_plain(cuda, shape):
    """Every chunk of a tensor reads its beta powers: updated in place they
    would race with the chunk-0 thread's write.  In place over 4 and 2,000
    chunks, p, m1 and m2 bit-equal to the plain version, the input powers
    unchanged and the new ones in fresh tensors."""
    (entry,) = _adam_group(cuda, [shape], seed=11)
    want = fused_adam_plain(*entry[:7], 0.9, 0.999, 1e-8)
    pows = [entry[4].clone(), entry[5].clone()]
    mine = tuple(t.clone() for t in entry[:7]) + entry[7:]
    (got,) = fused_adam_multi([mine], 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert got[0] is mine[0] and got[1] is mine[2] and got[2] is mine[3]
    assert torch.equal(mine[4], pows[0]) and torch.equal(mine[5], pows[1])
    assert got[3].data_ptr() not in (mine[4].data_ptr(), mine[5].data_ptr())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_add_captured_and_replayed_bit_equal(cuda, dtype):
    """K3's cooperative sort and its segment sums captured in a CUDA graph:
    the replay bit-equal to an eager call, and again after new ids are
    copied into the captured buffer (the control: the first output
    differs from the second)."""
    g = torch.Generator().manual_seed(12)
    w = torch.empty(32000, 512, dtype=dtype, device=cuda)
    ids = torch.randint(0, 32000, (16384,), generator=g, dtype=torch.int32).to(cuda)
    ids[::4] = 0
    rows = torch.randn(16384, 512, generator=g).to(dtype).to(cuda)
    eager = scatter_add_rows(w, ids, rows)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = scatter_add_rows(w, ids, rows)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    ids.copy_(torch.randint(0, 32000, (16384,), generator=g, dtype=torch.int32).to(cuda))
    graph.replay()
    again = scatter_add_rows(w, ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and not torch.equal(out, eager)


def test_dropout_replays_draw_new_masks_equal_to_eager_runs(cuda):
    """The executor's generator is registered with the dropout program's
    graph: three replays draw three masks, equal to three eager runs from
    the same generator state, which ends where theirs does."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[256])
        y = layers.dropout(x, dropout_prob=0.5, is_test=False)
    scope, exe = pt.Scope(), pt.Executor()
    feed = {"x": np.ones((8, 256), np.float32)}
    exe.run(main, feed=feed, fetch_list=[y], scope=scope)        # the capture
    gen = scope.find_var(RNG_STATE_VAR)
    state = gen.get_state()
    replays = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0] for _ in range(3)]
    end = gen.get_state()
    gen.set_state(state)
    eager = [exe._run_eager(main, feed, [y], scope)[0] for _ in range(3)]
    assert exe.cache_info()["entries"][0]["kind"] == "graph"
    assert exe.cache_info()["captures"] == 1
    for a, b in zip(replays, eager):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(replays[0], replays[1])
    assert 0.3 < float((replays[0] == 0).mean()) < 0.7
    assert torch.equal(gen.get_state(), end)


def test_precompile_of_a_training_step_writes_nothing(cuda):
    """``precompile`` of an Adam step captures its graph from an eager run
    on clones of the state and a copy of the generator: the scope and the
    generator bit-equal after it; the first run then replays (no capture)
    and equals an eager step from the same state."""
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    main, startup, loss = _train_programs()
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = _small_train_feed()
    before = {n: t.clone() for n, t in _state(main, scope).items()}
    rng = scope.find_var(RNG_STATE_VAR).get_state()
    rec = exe.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
    assert (rec["kind"], rec["aot"], rec["reasons"]) == ("graph", True, [])
    assert all(torch.equal(t, before[n]) for n, t in _state(main, scope).items())
    assert torch.equal(scope.find_var(RNG_STATE_VAR).get_state(), rng)
    captures = exe.cache_info()["captures"]
    (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.cache_info()["captures"] == captures
    after = {n: t.clone() for n, t in _state(main, scope).items()}
    for n, t in _state(main, scope).items():
        t.copy_(before[n])
    (want,) = exe._run_eager(main, feed, [loss], scope)
    assert np.array_equal(got, want)
    assert all(torch.equal(t, after[n]) for n, t in _state(main, scope).items())


# ------------------------------------------------ the Trainer and its data path


def test_feed_stager_on_the_card_bit_equal_to_the_host_arrays(cuda):
    """Twelve batches (three times the pinned ring) staged on the card: each
    value coerced on the stager thread (int64 to int32), copied on the
    stager's stream, and after the consumer's wait bit-equal to the host
    array; the event travels with the batch."""
    main, _, _ = _train_programs()
    exe = pt.Executor()
    rs = np.random.RandomState(3)
    feeds = [{"src": rs.randint(0, 1000, (4, 32, 1)), "lbl": rs.randint(0, 1000, (4, 32, 1)),
              "src@SEQ_LEN": rs.randint(1, 33, 4).astype(np.int32)} for _ in range(12)]
    got = []
    for b in exe.stage_feeds(main, iter(feeds), depth=2):
        assert b.event is not None and b.nbytes == 2 * 4 * 32 * 4 + 4 * 4
        torch.cuda.current_stream().wait_event(b.event)
        got.append({k: v.cpu() for k, v in b.items()})
    assert len(got) == 12
    for b, f in zip(got, feeds):
        for k, v in f.items():
            assert b[k].dtype == torch.int32, k
            assert np.array_equal(b[k].numpy(), v.astype(np.int32)), k


def _small_trainer(**kw):
    def train_func():
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[32, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, 1000, 1000, max_len=32,
                                            n_layer=2, d_model=64, n_head=4,
                                            d_inner=256, fuse_final_ce=True)
        return loss
    with pt.unique_name.guard():
        return pt.Trainer(train_func, lambda: pt.optimizer.Adam(learning_rate=1e-3), **kw)


def _small_samples(n, pause=0.0):
    """Samples whose source lengths alternate by batch of 4 between
    [9, 16] and [17, 32], so pow2 buckets give the batches two feed
    signatures in turn; ``pause`` seconds before each sample keep the
    stager thread converting and copying while the step before runs (and
    while the first steps capture their graphs)."""
    def reader():
        rs = np.random.RandomState(0)
        for i in range(n):
            time.sleep(pause)
            lo, hi = (9, 17) if (i // 4) % 2 == 0 else (17, 33)
            yield (rs.randint(1, 1000, (rs.randint(lo, hi), 1)),
                   rs.randint(1, 1000, (32, 1)), rs.randint(1, 1000, (32, 1)))
    return reader


def test_pipelined_trainer_bit_equal_to_a_synchronous_one_one_capture_a_signature(cuda):
    """A 2+2-layer Trainer on the card, pipelined (its reader slow enough
    that the stager thread allocates pinned memory and copies on its own
    stream while the graphs are captured) and synchronous from the same
    state, 2 epochs of 3 batches of 4 and a last batch of 2 whose source
    lengths pad to 16 and 32 in turn: losses and every state tensor
    bit-equal; three captures each (one a feed signature), every other
    step a replay."""
    runs = []
    start = None
    for pipeline in (True, False):
        trainer = _small_trainer(pipeline=pipeline)
        persist = [v.name for v in trainer.train_program.list_vars() if v.persistable]
        if start is None:
            start = {n: trainer.scope.find_var(n).clone() for n in persist}
        for n in persist:
            trainer.scope.find_var(n).copy_(start[n])
        losses = []

        def handler(ev, losses=losses):
            if isinstance(ev, pt.EndStepEvent):
                losses.append(ev.metrics[0])
        reader = _small_samples(14, pause=0.02 if pipeline else 0.0)
        trainer.train(2, handler, reader=pt.batch(reader, 4), feed_order=["src", "trg", "lbl"])
        runs.append((trainer, [float(np.asarray(m)) for m in losses], persist))
    (a, la, persist), (b, lb, _) = runs
    assert len(la) == 8 and np.isfinite(la).all() and la == lb
    for n in persist:
        assert torch.equal(a.scope.find_var(n), b.scope.find_var(n)), n
    for t in (a, b):
        info = t.exe.cache_info()
        assert info["captures"] == 3
        assert sorted((e["feeds"]["src"][0][1], e["feeds"]["lbl"][0][0])
                      for e in info["entries"] if e["kind"] == "graph" and "lbl" in e["feeds"]) == \
            [(16, 4), (32, 2), (32, 4)]


def test_load_persistables_into_a_captured_scope_is_read_by_the_next_replay(cuda, tmp_path):
    """Parameters loaded into an Inferencer whose graph is captured are
    copied into its tensors: the next replay reads them (the CPU run of the
    saved parameters within LOGIT_ATOL), with no new capture."""
    inf = _warm(buckets=(2,))
    names = [v.name for v in inf.inference_program.list_vars() if v.persistable]
    addrs = {n: inf.scope.find_var(n).data_ptr() for n in names}
    src = pt.Inferencer(_infer_func, place=pt.CPUPlace())
    for n in names:
        src.scope.find_var(n).mul_(1.5)
    with pt.scope_guard(src.scope):
        pt.io.save_persistables(src.exe, str(tmp_path), src.inference_program)
    feed = _small_feed(np.random.RandomState(1), 2)
    (before,) = inf.infer(feed)
    captures = _captures(inf.exe)
    with pt.scope_guard(inf.scope):
        pt.io.load_persistables(inf.exe, str(tmp_path), inf.inference_program)
    (got,) = inf.infer(feed)
    (want,) = src.infer(feed)
    assert _captures(inf.exe) == captures
    assert {n: inf.scope.find_var(n).data_ptr() for n in names} == addrs
    assert not np.allclose(got, before, atol=LOGIT_ATOL)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_for_test_clone_replays_a_graph_bit_equal_to_its_eager_run(cuda):
    """The evaluation clone of an Adam training program writes no state: on
    the card it is one graph, the second run a replay bit-equal to the
    eager run, and no state tensor changes."""
    main, startup, loss = _train_programs()
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    test_prog = main.clone(for_test=True)
    before = {n: t.clone() for n, t in _state(main, scope).items()}
    feed = _small_train_feed()
    (first,) = exe.run(test_prog, feed=feed, fetch_list=[loss], scope=scope)
    captures = _captures(exe)
    (replayed,) = exe.run(test_prog, feed=feed, fetch_list=[loss], scope=scope)
    (eager,) = exe._run_eager(test_prog, feed, [loss], scope)
    assert _captures(exe) == captures
    (entry,) = [e for e in exe.cache_info()["entries"] if "lbl" in e["feeds"]]
    assert entry["kind"] == "graph"
    assert np.isfinite(replayed) and np.array_equal(replayed, eager)
    assert np.array_equal(first, replayed)
    assert all(torch.equal(t, before[n]) for n, t in _state(main, scope).items())


# ------------------------------------------------ the observability core


def test_profile_ops_of_a_replayed_step_writes_nothing(cuda):
    """``Executor.profile_ops`` of a 2+2 Adam step right after a replay of
    its graph: every state tensor bit-equal and at its address, no
    capture, each update op lowered alone (one K6 launch an ``adam`` row,
    where the step's graph makes one launch), and the next replay
    bit-equal to a control step from the same state."""
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd as k1
    main, startup, loss = _train_programs()
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = _small_train_feed()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    state0 = {n: t.clone() for n, t in _state(main, scope).items()}
    addrs = {n: t.data_ptr() for n, t in _state(main, scope).items()}
    (ctl,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    ctl_state = {n: t.clone() for n, t in _state(main, scope).items()}
    for n, t in _state(main, scope).items():
        t.copy_(state0[n])
    captures = exe.cache_info()["captures"]
    adam0, k10 = fused_adam.launches, k1.launches
    prof = exe.profile_ops(main, feed=feed, scope=scope, samples=2)
    n_adam = sum(o.op_type in ("adam", "pallas_adam") for o in prof.ops)
    assert n_adam == len(main.global_block.all_parameters())
    assert fused_adam.launches - adam0 == 3 * n_adam        # a warm-up pass and 2 samples
    assert k1.launches - k10 == 3 * 2 * 3 * 2               # 6 attentions, forward and grad
    assert exe.cache_info()["captures"] == captures
    for n, t in _state(main, scope).items():
        assert t.data_ptr() == addrs[n] and torch.equal(t, state0[n]), n
    assert 0.5 < prof.coverage <= 1.0 + 1e-9
    (got,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.array_equal(got, ctl)
    for n, t in _state(main, scope).items():
        assert torch.equal(t, ctl_state[n]), n


def test_device_trace_names_the_kernels_and_the_op_ranges(cuda, tmp_path):
    """``profiler.device_trace`` around an eager 2+2 step: the exported
    trace holds K1's kernel and ``op<idx>:<type>@file:line`` ranges; a
    replayed step's trace holds the kernels but no op range."""
    import json
    import re
    main, startup, loss = _train_programs()
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = _small_train_feed()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    names = {}
    for how in ("eager", "replay"):
        with pt.profiler.device_trace(str(tmp_path / how)) as dt:
            if how == "eager":
                exe._run_eager(main, feed, [loss], scope)
            else:
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        with open(dt.path) as f:
            names[how] = [str(e.get("name", "")) for e in json.load(f)["traceEvents"]]
    for how in ("eager", "replay"):
        assert any("flash_fwd_kernel" in n for n in names[how]), how
    ranges = [n for n in names["eager"] if re.match(r"op\d+:\w+", n)]
    assert any(":flash_attention_grad" in r for r in ranges)
    assert any(":flash_attention@" in r for r in ranges)     # with its callsite
    assert not [n for n in names["replay"] if re.match(r"op\d+:\w+", n)]


def test_sample_once_reads_the_caching_allocator(cuda):
    from paddle_tpu_torch import resource_sampler
    keep = torch.empty(1 << 20, device=cuda)
    values = resource_sampler.sample_once()
    assert values["device0_bytes_in_use"] == torch.cuda.memory_allocated()
    assert values["device0_peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    assert values["device0_bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    del keep


def test_trainer_profile_steps_on_the_card_bit_equal_to_no_profiles(cuda):
    """A pipelined 2+2 Trainer with ``profile_steps=2`` and one without,
    from the same state over the same 4 batches: losses and every state
    tensor bit-equal, two profiles."""
    from paddle_tpu_torch.profiling import PROFILE_RECORDS
    runs, start = [], None
    for profile_steps in (2, None):
        trainer = _small_trainer(profile_steps=profile_steps)
        persist = [v.name for v in trainer.train_program.list_vars() if v.persistable]
        if start is None:
            start = {n: trainer.scope.find_var(n).clone() for n in persist}
        for n in persist:
            trainer.scope.find_var(n).copy_(start[n])
        n0, losses = len(PROFILE_RECORDS.records()), []

        def handler(ev, losses=losses):
            if isinstance(ev, pt.EndStepEvent):
                losses.append(ev.metrics[0])
        trainer.train(1, handler, reader=pt.batch(_small_samples(16), 4),
                      feed_order=["src", "trg", "lbl"])
        summaries = [r for r in PROFILE_RECORDS.records()[n0:] if r["kind"] == "summary"]
        runs.append((trainer, [float(np.asarray(m)) for m in losses], len(summaries)))
    (a, la, na), (b, lb, nb) = runs
    assert (na, nb) == (2, 0) and len(la) == 4 and la == lb
    for n in start:
        assert torch.equal(a.scope.find_var(n), b.scope.find_var(n)), n


# ------------------------------------------- the optimizer family, schedules


GPU_FAMILIES = {
    "Momentum": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9),
    "Momentum_nesterov": lambda o: o.Momentum(learning_rate=0.05, momentum=0.9,
                                              use_nesterov=True),
    "LarsMomentum": lambda o: o.LarsMomentum(learning_rate=50.0, momentum=0.9),
    "Adamax": lambda o: o.Adamax(learning_rate=0.05),
    "Adagrad": lambda o: o.Adagrad(learning_rate=0.2),
    "DecayedAdagrad": lambda o: o.DecayedAdagrad(learning_rate=0.02),
    "Adadelta": lambda o: o.Adadelta(learning_rate=1.0),
    "RMSProp": lambda o: o.RMSProp(learning_rate=0.05, momentum=0.5),
    "Ftrl": lambda o: o.Ftrl(learning_rate=0.3, l1=0.01, l2=0.1),
    "SGD_exponential_decay": lambda o: o.SGD(
        learning_rate=layers.exponential_decay(0.1, 2, 0.5)),
}
# 3 steps of a small network on the card (graph replays) against the CPU,
# norm-relative per state tensor: cuBLAS and the CPU sum the products in
# other orders, and an adaptive rule's first step, lr * g / (|g| + eps), turns
# a 1e-11 difference in a gradient near 0 into 1e-5 in the parameter (Adagrad
# at lr 0.2 read 2 such elements of 8192 on an H100, 1e-6 norm-relative)
FAMILY_NREL = 1e-5


def _family_net(make_opt):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[64])
        y = layers.data(name="y", shape=[1], dtype="int64")
        h = layers.fc(input=x, size=128, act="relu")
        logits = layers.fc(input=h, size=10)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
        make_opt(pt.optimizer).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("name", sorted(GPU_FAMILIES))
def test_each_update_family_on_the_card_matches_the_cpu(cuda, name):
    """Each family's group lowering (torch._foreach_* on the card; K5 for
    SGD) inside the step's CUDA graph: 3 steps against the same program on
    the CPU from the same state; one capture, every state tensor at its
    address."""
    main, startup, loss = _family_net(GPU_FAMILIES[name])
    gpu_scope, cpu_scope = pt.Scope(), pt.Scope()
    gpu, cpu = pt.Executor(), pt.Executor(pt.CPUPlace())
    gpu.run(startup, scope=gpu_scope)
    persist = [v.name for v in main.list_vars() if v.persistable]
    pt.params_from_numpy({n: gpu_scope.find_var(n).cpu().numpy() for n in persist},
                         cpu_scope, "cpu")
    addrs = {n: gpu_scope.find_var(n).data_ptr() for n in persist}
    rs = np.random.RandomState(0)
    feed = {"x": rs.randn(32, 64).astype(np.float32), "y": rs.randint(0, 10, (32, 1))}
    sgd0 = fused_sgd.launches
    for _ in range(3):
        (a,) = gpu.run(main, feed=feed, fetch_list=[loss], scope=gpu_scope)
        (b,) = cpu.run(main, feed=feed, fetch_list=[loss], scope=cpu_scope)
        np.testing.assert_allclose(a, b, rtol=1e-5)
    for n in persist:
        a, b = gpu_scope.find_var(n).cpu().double(), cpu_scope.find_var(n).double()
        assert torch.linalg.norm(a - b) <= FAMILY_NREL * torch.linalg.norm(b), n
    info = gpu.cache_info()
    assert info["captures"] == 1 and [e["kind"] for e in info["entries"]][-1] == "graph"
    assert {n: gpu_scope.find_var(n).data_ptr() for n in persist} == addrs
    if name.startswith("SGD"):
        # the capture's eager run (on clones of the state) launches once more
        assert fused_sgd.launches - sgd0 == 3 + 1


def _unfused_programs(clip=True):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[32, 1], dtype="int64")
        wgt = layers.data(name="wgt", shape=[32, 1], dtype="float32")
        loss, _ = transformer.train_network(src, trg, lbl, 1000, 1000, weights=wgt,
                                            max_len=32, n_layer=2, d_model=64, n_head=4,
                                            d_inner=256, fuse_final_ce=False)
        if clip:
            pt.clip.set_gradient_clip(pt.clip.GradientClipByGlobalNorm(1.0))
        lr = layers.noam_decay(64, 4000)
        pt.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.98,
                          epsilon=1e-9).minimize(loss)
    return main, startup, loss, lr


def _unfused_feed():
    feed = _small_train_feed()
    feed["wgt"] = (np.arange(32)[None, :] < feed["trg@SEQ_LEN"][:, None]).astype(
        np.float32)[..., None]
    return feed


def _noam(step):
    s = torch.tensor([float(step)], dtype=torch.float32)
    return (torch.minimum(torch.pow(s, -0.5), s * 4000.0 ** -1.5) * 64.0 ** -0.5).item()


def test_scheduled_learning_rate_is_fresh_on_every_replay(cuda):
    """The unfused 2+2 step with noam_decay, global-norm clipping and Adam:
    one capture, each replay's fetched lr the schedule's value at that step
    (the counter advances in the graph and K6 reads the new lr through its
    table's pointer), one K6 launch a step, the counter at n after n steps,
    and a replay bit-equal to an eager step from the same state."""
    main, startup, loss, lr = _unfused_programs()
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = _unfused_feed()
    k6 = fused_adam.launches
    lrs, losses = [], []
    for _ in range(4):
        a, b = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
        losses.append(float(a))
        lrs.append(float(np.ravel(b)[0]))
    assert lrs == [_noam(s) for s in (1, 2, 3, 4)]
    assert np.isfinite(losses).all() and losses[0] > losses[-1]
    # one launch a replay, and one in the capture's eager run
    assert exe.cache_info()["captures"] == 1 and fused_adam.launches - k6 == 4 + 1
    (counter,) = [n for n in _state(main, scope) if "COUNTER" in n]
    assert scope.find_var(counter).dtype == torch.int32 and int(scope.find_var(counter)[0]) == 4
    state0 = {n: t.clone() for n, t in _state(main, scope).items()}
    replayed = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
    after = {n: t.clone() for n, t in _state(main, scope).items()}
    for n, t in _state(main, scope).items():
        t.copy_(state0[n])
    eager = exe._run_eager(main, feed, [loss, lr], scope)
    assert all(np.array_equal(x, y) for x, y in zip(replayed, eager))
    assert not [n for n, t in _state(main, scope).items() if not torch.equal(t, after[n])]


def test_accumulation_programs_each_replay_one_graph(cuda):
    """Trainer(accum_steps=2) on the card over the unfused step: the
    accumulate and apply programs each one CUDA graph, and the parameters
    bit-equal to an exe.run loop of the same two programs on a second
    Trainer's executor from the same state."""
    def train_func():
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[32, 1], dtype="int64")
        loss, _ = transformer.train_network(src, trg, lbl, 1000, 1000, max_len=32, n_layer=2,
                                            d_model=64, n_head=4, d_inner=256)
        return loss

    def make():
        with pt.unique_name.guard():
            return pt.Trainer(train_func, lambda: pt.optimizer.Adam(
                learning_rate=layers.noam_decay(64, 4000)), accum_steps=2,
                seq_len_buckets=False)
    a, b = make(), make()
    persist = [v.name for v in a.train_program.list_vars() if v.persistable]
    for n in persist:
        b.scope.find_var(n).copy_(a.scope.find_var(n))
    reader = pt.batch(_small_samples(16), 4)
    a.train(1, lambda ev: None, reader=reader, feed_order=["src", "trg", "lbl"])
    kinds = {}
    for e in a.exe.cache_info()["entries"]:
        kinds.setdefault(e["kind"], 0)
        kinds[e["kind"]] += 1
    feeder = pt.DataFeeder(feed_list=[b.train_program.global_block.var(n)
                                      for n in ("src", "trg", "lbl")], program=b.train_program)
    for i, batch in enumerate(reader()):
        b.exe.run(b._step_program, feed=feeder.feed(batch), fetch_list=[], scope=b.scope)
        if i % 2 == 1:
            b.exe.run(b.apply_program, feed={}, fetch_list=[], scope=b.scope)
    for n in persist:
        assert torch.equal(a.scope.find_var(n), b.scope.find_var(n)), n
    graphs = [e for e in a.exe.cache_info()["entries"] if e["kind"] == "graph"]
    assert len(graphs) >= 2 and not [e for e in a.exe.cache_info()["entries"]
                                     if e["kind"] == "eager" and e["graph_eligible"]]


def test_int8_matmul_program_launches_k4_once_a_pass(cuda):
    """``layers.matmul`` served through AmpConfig(bf16=False, quant=True)
    with the kernel tier: ``pallas_int8_matmul`` with base_op="matmul",
    one K4 launch a pass, bit-equal to the fake-quant program on the card
    (kernels=False) and within 0.05 norm-relative of float32."""
    def infer_func():
        x = layers.data(name="x", shape=[512])
        w = pt.layer_helper.LayerHelper("proj").create_parameter(
            pt.ParamAttr(name="proj.w"), shape=[512, 256], dtype="float32")
        return layers.matmul(x, w)
    amp = pt.amp.AmpConfig(bf16=False, quant=True)
    kern = pt.Inferencer(infer_func, amp=amp, kernels=True)
    sim = pt.Inferencer(infer_func, amp=amp, kernels=False)
    f32 = pt.Inferencer(infer_func)
    w = kern.scope.find_var("proj.w")
    for inf in (sim, f32):
        inf.scope.find_var("proj.w").copy_(w)
    feed = {"x": np.random.RandomState(0).randn(256, 512).astype(np.float32)}
    k4 = int8_matmul.launches
    (got,) = kern.infer(feed)
    (again,) = kern.infer(feed)
    assert int8_matmul.launches - k4 == 2
    assert np.array_equal(got, again) and np.array_equal(got, sim.infer(feed)[0])
    want = f32.infer(feed)[0]
    assert np.linalg.norm(got - want) <= 0.05 * np.linalg.norm(want)


# ResNet-18 at 32 x 32, batch 8, 10 classes (bench.py's shapes off the TPU):
# two Momentum steps on the card (TF32 off), each against a step of the port
# on the CPU from the card's state before it; each state tensor's change in
# the step norm-relative to the CPU's, and the loss relative (chip_smoke.py
# phase 21 (d), where the readings stand).
RESNET18_CHANGE_NREL = 1e-3
RESNET18_LOSS_RTOL = 1e-4


def test_resnet18_on_the_card_matches_the_cpu(cuda):
    """chip_smoke.py phase 21 (d): the CNN path's ops (conv2d through
    cuDNN, pool2d, batch_norm and its grad, momentum) on the card against
    the CPU, and a max pool over a window of ties routing its gradient as
    the CPU does."""
    from paddle_tpu_torch.models import resnet
    torch.backends.cudnn.allow_tf32 = False
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        image = layers.data(name="image", shape=[3, 32, 32], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        loss, _ = resnet.train_network(image, label, class_dim=10, depth=18)
        pt.optimizer.MomentumOptimizer(learning_rate=0.01, momentum=0.9).minimize(loss)
    rs = np.random.RandomState(1)
    feed = {"image": rs.randn(8, 3, 32, 32).astype(np.float32),
            "label": rs.randint(0, 10, (8, 1)).astype(np.int64)}
    scopes = {"cpu": pt.Scope(), "cuda": pt.Scope()}
    exes = {"cpu": pt.Executor(pt.CPUPlace()), "cuda": pt.Executor(pt.CUDAPlace(0))}
    for k in scopes:
        exes[k].run(startup, scope=scopes[k])
    persist = [v.name for v in main.list_vars() if v.persistable]
    for n in persist:
        scopes["cuda"].find_var(n).copy_(scopes["cpu"].find_var(n))
    for _ in range(2):
        before = {n: scopes["cuda"].find_var(n).cpu().numpy().copy() for n in persist}
        for n, a in before.items():
            scopes["cpu"].find_var(n).copy_(torch.from_numpy(a))
        losses = {k: float(exes[k].run(main, feed=feed, fetch_list=[loss], scope=scopes[k])[0])
                  for k in scopes}
        assert abs(losses["cuda"] - losses["cpu"]) <= RESNET18_LOSS_RTOL * abs(losses["cpu"])
        for n in persist:
            d_cpu = scopes["cpu"].find_var(n).numpy() - before[n]
            d_card = scopes["cuda"].find_var(n).cpu().numpy() - before[n]
            if np.any(d_cpu):
                assert np.linalg.norm(d_card - d_cpu) <= \
                    RESNET18_CHANGE_NREL * np.linalg.norm(d_cpu), n

    grads = {}
    for k, place in (("cpu", pt.CPUPlace()), ("cuda", pt.CUDAPlace(0))):
        tmain = pt.Program()
        with pt.unique_name.guard(), pt.program_guard(tmain, pt.Program()):
            x = layers.data(name="x", shape=[2, 3, 7, 7], append_batch_size=False,
                            stop_gradient=False)
            y = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
            (gx,) = pt.calc_gradient(layers.reduce_sum(y), [x])
        grads[k] = pt.Executor(place).run(tmain, feed={"x": np.ones((2, 3, 7, 7), np.float32)},
                                          fetch_list=[gx], scope=pt.Scope())[0]
    np.testing.assert_array_equal(grads["cuda"], grads["cpu"])


EVAL_LOSS_RTOL = 1e-5   # the fused head's eval loss against softmax + CE's


def _reference_eval(rows=16, t=256, vocab=32000):
    """The eval clone of a 2+2-layer reference step (unfused head with token
    weights) at the full vocabulary, and its feed."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        src = layers.data(name="src", shape=[1], dtype="int64", lod_level=1)
        trg = layers.data(name="trg", shape=[1], dtype="int64", lod_level=1)
        lbl = layers.data(name="lbl", shape=[t, 1], dtype="int64")
        wgt = layers.data(name="wgt", shape=[t, 1], dtype="float32")
        loss, _ = transformer.train_network(src, trg, lbl, vocab, vocab, weights=wgt,
                                            max_len=t, n_layer=2, d_model=512, n_head=8,
                                            d_inner=2048, fuse_final_ce=False)
    rs = np.random.RandomState(2)
    feed = {}
    for name in ("src", "trg"):
        lens = rs.randint(t // 2, t + 1, rows).astype(np.int32)
        ids = rs.randint(1, vocab, (rows, t, 1)).astype(np.int64)
        ids[np.arange(t)[None, :] >= lens[:, None]] = 0
        feed[name], feed[name + "@SEQ_LEN"] = ids, lens
    feed["lbl"] = rs.randint(1, vocab, (rows, t, 1)).astype(np.int64)
    feed["wgt"] = (np.arange(t)[None, :] < feed["trg@SEQ_LEN"][:, None]).astype(
        np.float32)[..., None]
    return main.clone(for_test=True), startup, loss.name, feed


def test_passes_fuse_the_reference_eval_and_the_plan_holds_the_band(cuda):
    """``Executor(passes=True, validate="error")`` on a 2+2 reference eval
    at vocab 32000, 16 x 256: one head fused, K7 once a run (the capture,
    then replays), the loss within ``EVAL_LOSS_RTOL`` of the unfused
    eval's; each eval's ``plan_memory`` peak against the peak an eager run
    of it measures (``analysis.measured``: the state it reads +
    ``max_memory_allocated`` over the run less what was allocated before)
    within ``measured.PLAN_BAND``, the fused one the lower."""
    from paddle_tpu_torch.analysis import measured
    from paddle_tpu_torch.ops.cuda.linear_ce import linear_ce_fwd as k7
    test, startup, loss, feed = _reference_eval()
    scope = pt.Scope()
    pt.Executor().run(startup, scope=scope)
    plain = pt.Executor()
    fused = pt.Executor(passes=True, validate="error")
    ran = fused._apply_passes(test, list(feed), [loss], scope,
                              {k: np.shape(v) for k, v in feed.items()})
    assert [o.type for o in ran.desc.block(0).ops].count("fused_fc_softmax_ce") == 1
    paths = {}
    for key, exe in (("unfused", plain), ("fused", fused)):
        paths[key] = measured.prepare(key, exe, test, feed, [loss], scope)
        measured.measure(paths[key], scope, feed,
                         lambda: exe._run_eager(test, feed, [loss], scope))
    for r in paths.values():
        assert measured.PLAN_BAND[0] <= r["ratio"] <= measured.PLAN_BAND[1], paths
    assert paths["fused"]["measured_bytes"] < paths["unfused"]["measured_bytes"]
    k7_0 = k7.launches
    (want,) = plain.run(test, feed=feed, fetch_list=[loss], scope=scope)
    losses = [fused.run(test, feed=feed, fetch_list=[loss], scope=scope)[0] for _ in range(3)]
    assert k7.launches - k7_0 == 3
    assert [e["kind"] for e in fused.cache_info()["entries"] if "lbl" in e["feeds"]] == ["graph"]
    for got in losses:
        assert abs(float(got) - float(want)) <= EVAL_LOSS_RTOL * abs(float(want))


# ------------------------------------- the health sentinel and the checkpoint


def test_sentinel_inside_the_step_graph_against_float64_norms(cuda):
    """``Executor(sentinels=True)`` on the card: the step's graph holds the
    sentinel, each replay writes it (no capture after the first run), its
    four scalars within 1e-4 of float64 sums over the same replay's state
    before and after and the eager step's gradients, and a replay from a
    poisoned weight trips the gradient and state bits."""
    from paddle_tpu_torch import health
    main, startup, loss = _train_programs()
    scope, exe = pt.Scope(), pt.Executor(sentinels=True)
    exe.run(startup, scope=scope)
    feed = _small_train_feed()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)      # the capture
    (entry,) = [e for e in exe._cache.values() if e.graph is not None]
    assert entry.sentinel_extra == 5 and entry.param_watch and entry.grad_watch
    names, grads = list(entry.param_watch), list(entry.grad_watch)
    before = {n: scope.find_var(n).clone() for n in names}
    tapped = []
    exe._health_hook = lambda **kw: tapped.append([np.asarray(v) for v in kw["values"]])
    (got_loss,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert exe.cache_info()["captures"] == 1
    after = {n: scope.find_var(n).clone() for n in names}
    for n, t in before.items():
        scope.find_var(n).copy_(t)
    outs = exe._run_eager(main, feed=feed, fetch_list=[loss.name] + grads, scope=scope,
                          return_numpy=False)

    def norm(ts):
        return float(torch.sqrt(sum(t.double().square().sum() for t in ts)))
    want = [float(got_loss), norm(outs[1:]), norm(after.values()),
            norm(after[n].double() - before[n].double() for n in names)]
    mask, *scalars = tapped[0]
    assert int(mask[0]) == 0
    for g, w in zip(scalars, want):
        assert abs(float(g) - w) <= 1e-4 * abs(w), (scalars, want)
    for n, t in after.items():
        scope.find_var(n).copy_(t)
    # a poisoned weight: the replay trips, and the monitor localizes it on
    # the card from the feed the executor kept (numpy feeds: a host copy
    # would put the replay on the CPU)
    monitor = health.HealthMonitor()
    monitor.attach(exe)
    exe._health_hook = lambda **kw: (tapped.append([np.asarray(v) for v in kw["values"]]),
                                     monitor.on_step(**kw))
    n0 = len(health.HEALTH_RECORDS.records())
    scope.find_var("src_emb")[int(feed["src"][0, 0, 0]), 0] = float("inf")
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    monitor.flush()
    bad = health.decode_sentinel_mask(tapped[-1][0], entry.sentinel_watch)
    assert {health.GRADS_GROUP, health.PARAMS_GROUP} <= set(bad), bad
    assert exe.cache_info()["captures"] == 1
    (trip,) = [r for r in health.HEALTH_RECORDS.records()[n0:] if r.get("event") == "non-finite"]
    assert trip["localization"]["op_index"] == 0, trip["localization"]


def test_a_restore_sets_a_graph_registered_generator_in_place(cuda, tmp_path):
    """The dropout program's graph registers the scope's generator; a
    checkpoint restore sets that generator's state in place (the object the
    graph registered), so the next replay draws the mask an eager run from
    the saved state draws."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.core.executor import RNG_STATE_VAR
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[256])
        y = layers.dropout(x, dropout_prob=0.5, is_test=False)
    scope, exe = pt.Scope(), pt.Executor()
    feed = {"x": np.ones((8, 256), np.float32)}
    exe.run(main, feed=feed, fetch_list=[y], scope=scope)        # the capture
    gen = scope.find_var(RNG_STATE_VAR)
    saved = gen.get_state()
    m = CheckpointManager(str(tmp_path), async_save=False)
    m.save(main, scope, step=1)
    drawn = [exe.run(main, feed=feed, fetch_list=[y], scope=scope)[0] for _ in range(2)]
    m.restore(main, scope)
    assert scope.find_var(RNG_STATE_VAR) is gen and torch.equal(gen.get_state(), saved)
    (replayed,) = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    gen.set_state(saved)
    (eager,) = exe._run_eager(main, feed, [y], scope)
    np.testing.assert_array_equal(replayed, eager)
    np.testing.assert_array_equal(replayed, drawn[0])
    assert exe.cache_info()["captures"] == 1


def test_saves_reuse_a_pinned_buffer_once_the_writer_has_released_it(cuda, tmp_path):
    """The manager's snapshots of CUDA state land in pinned buffers from its
    pool: a save after the writer has committed the last one reuses that
    buffer (the same host address), and the checkpoint holds the second
    save's values."""
    from paddle_tpu_torch.checkpoint import (CheckpointManager, checkpoint_dir, manifest,
                                             read_manifest)
    main, startup, loss = _train_programs()
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    m = CheckpointManager(str(tmp_path), async_save=True, keep=3)
    taken, take = [], m._pool.take
    m._pool.take = lambda dtype, numel: taken.append(take(dtype, numel)) or taken[-1]
    m.save(main, scope, step=1)
    m.wait()
    exe.run(main, feed=_small_train_feed(), fetch_list=[loss], scope=scope)
    m.save(main, scope, step=2)
    m.wait()
    assert len(taken) == 2 and taken[0].is_pinned()
    assert taken[1].data_ptr() == taken[0].data_ptr()
    d = checkpoint_dir(str(tmp_path), 2)
    arrays = manifest.read_chunks(d, read_manifest(d), ["src_emb"])
    np.testing.assert_array_equal(arrays["src_emb"], scope.find_var("src_emb").cpu().numpy())
    m.close()


def test_check_nan_inf_names_the_op_on_the_card(cuda):
    """``FLAGS.check_nan_inf`` on a graph entry: the first run (the eager
    run before the capture) and a replay each raise naming the op; the
    replay from the snapshot runs on the card."""
    from paddle_tpu_torch.flags import FLAGS
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        z = layers.fill_constant(shape=[4], dtype="float32", value=0.0)
        out = layers.mean(layers.elementwise_div(x, z))
    exe = pt.Executor()
    FLAGS.check_nan_inf = True
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="Operator elementwise_div output"):
                exe.run(main, feed={"x": np.zeros((2, 4), np.float32)}, fetch_list=[out])
    finally:
        FLAGS.check_nan_inf = False
    assert [e["kind"] for e in exe.cache_info()["entries"]] == ["graph"]


# ------------------------------------------------------ the book models' slice

def _book_ops_program():
    """The slice's ops over seeded feeds: (program, feeds, exact fetches,
    float fetches incl. the gradients)."""
    rs = np.random.RandomState(19)
    feeds = {"x": rs.randn(2, 8, 7, 7).astype(np.float32),
             "w": rs.randn(8, 4, 3, 3).astype(np.float32) * 0.2,
             "u": rs.randn(5, 6).astype(np.float32) * 3,
             "v": (rs.rand(5, 6).astype(np.float32) + 0.5) * np.where(rs.rand(5, 6) < 0.5, -1, 1)
             .astype(np.float32),
             "idx": np.array([4, 0, -1, 2], np.int32), "ids": np.array([[1], [6], [-1]], np.int64)}
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        xs = {n: layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                             append_batch_size=False, stop_gradient=a.dtype != np.float32)
              for n, a in feeds.items()}
        helper = pt.layer_helper.LayerHelper("book_ops")

        def op(op_type, ins, attrs=None, dtype="float32", out="Out"):
            o = helper.create_variable_for_type_inference(dtype)
            helper.append_op(op_type, inputs=ins, outputs={out: o}, attrs=attrs or {})
            return o
        x, u, v = xs["x"], xs["u"], xs["v"]
        exact = [layers.flatten(x, axis=2), layers.stack([u, v], axis=-1),
                 layers.squeeze(layers.unsqueeze(u, axes=[1]), axes=[1]),
                 layers.gather(u, xs["idx"]), layers.expand(u, [2, 1]),
                 layers.pad(u, [0, 1, 2, 0], pad_value=-1.0), layers.one_hot(xs["ids"], depth=6),
                 layers.argmax(u, axis=1), layers.argmin(u, axis=0),
                 op("slice", {"Input": x}, {"axes": [1, 2], "starts": [1, -5], "ends": [50, -2]}),
                 op("elementwise_mod", {"X": u, "Y": v}, {"axis": -1}),
                 op("elementwise_floordiv", {"X": u, "Y": v}, {"axis": -1}),
                 op("isfinite", {"X": u}, dtype="bool")]
        floats = [layers.lrn(x, n=5, alpha=0.1, beta=0.75),
                  op("conv2d_transpose", {"Input": x, "Filter": xs["w"]},
                     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]},
                     out="Output"),
                  layers.cos_sim(u, v)]
        total = layers.reduce_sum(floats[0])
        for t in floats[1:] + exact[1:6]:
            total = layers.elementwise_add(total, layers.reduce_sum(t))
        floats += pt.calc_gradient(total, [x, u, v, xs["w"]])
    return main, feeds, exact, floats


def test_the_book_slices_ops_on_the_card_match_the_cpu(cuda):
    """Shape ops, gather, one_hot, the arg reductions, mod and floor
    division, isfinite bit-equal to the CPU; lrn, conv2d_transpose, cos_sim
    and the gradients within BOOK_RTOL of the largest value."""
    main, feeds, exact, floats = _book_ops_program()
    fetch = exact + floats
    got = pt.Executor().run(main, feed=feeds, fetch_list=fetch, scope=pt.Scope())
    ref = pt.Executor(pt.CPUPlace()).run(main, feed=feeds, fetch_list=fetch, scope=pt.Scope())
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, fetch[i].name
        if i < len(exact):
            np.testing.assert_array_equal(a, b, err_msg=fetch[i].name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=BOOK_RTOL * np.abs(b).max(),
                                       err_msg=fetch[i].name)


BOOK_RTOL = 1e-5   # float32 card vs CPU, TF32 off


def test_model_average_apply_in_a_captured_step_keeps_its_graph(cuda):
    """ModelAverage over an Adam step replayed as one graph: K6 once a
    replay with ``average_accumulates`` inside the graph (num_updates
    counts the replays), ``apply()`` within 1e-6 of the float64 window
    mean of the parameters after each step, every tensor at its address,
    no new capture, and the next replay bit-equal to one without apply."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[13])
        y = layers.data(name="y", shape=[1])
        h = layers.fc(input=x, size=16, act="relu")
        loss = layers.mean(layers.square_error_cost(input=layers.fc(input=h, size=1), label=y))
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
        ma = pt.optimizer.ModelAverage(1.0, min_average_window=0, max_average_window=10000)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    xs, ys = pt.dataset.uci_housing._synthetic(32, seed=0)
    feed = {"x": xs, "y": ys}
    k6 = fused_adam.launches
    snaps = {p.name: [] for p in ma.params}
    for _ in range(5):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        for p in ma.params:
            snaps[p.name].append(scope.find_var(p.name).double().cpu())
    assert fused_adam.launches - k6 == 5 + 1 and exe.cache_info()["captures"] == 1
    assert {int(scope.find_var(v.name).cpu()[0])
            for v in ma._accumulators["num_updates"].values()} == {5}
    persist = [v.name for v in main.list_vars() if v.persistable]
    ptrs = {n: scope.find_var(n).data_ptr() for n in persist}
    state0 = {n: scope.find_var(n).clone() for n in persist}
    with pt.scope_guard(scope):
        with ma.apply(exe):
            for p in ma.params:
                want = torch.stack(snaps[p.name]).mean(0)
                got = scope.find_var(p.name).double().cpu()
                assert (got - want).abs().max() <= 1e-6 * want.abs().max(), p.name
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert all(torch.equal(scope.find_var(n), after[n]) for n in persist)
    assert exe.cache_info()["captures"] == 1
    assert {n: scope.find_var(n).data_ptr() for n in persist} == ptrs


def test_the_range_quantizer_advances_inside_the_graph(cuda):
    """A QAT step (range quantizer, window 3, on an fc output; SGD)
    replayed on the card against the CPU from the same parameters: Iter
    and the window advance inside the graph (4 replays), the window within
    BOOK_RTOL of the CPU's, one capture."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[13])
        y = layers.data(name="y", shape=[1])
        q, s = layers.fake_quantize_range_abs_max(layers.fc(input=x, size=8), window_size=3)
        pred = layers.fc(input=layers.fake_dequantize_max_abs(q, s, max_range=127.0), size=1)
        loss = layers.mean(layers.square_error_cost(input=pred, label=y))
        pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    (op,) = [o for o in main.desc.block(0).ops if o.type == "fake_quantize_range_abs_max"]
    buf, it = op.input("InScales")[0], op.input("Iter")[0]
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu.run(startup, scope=cpu_scope)
    gpu.run(startup, scope=gpu_scope)
    for v in main.list_vars():
        if v.persistable:
            gpu_scope.find_var(v.name).copy_(cpu_scope.find_var(v.name))
    for step in range(4):
        xs, ys = pt.dataset.uci_housing._synthetic(16, seed=step)
        feed = {"x": xs * (1 + step), "y": ys}
        gpu.run(main, feed=feed, fetch_list=[loss], scope=gpu_scope)
        cpu.run(main, feed=feed, fetch_list=[loss], scope=cpu_scope)
        a, b = gpu_scope.find_var(buf).cpu(), cpu_scope.find_var(buf)
        assert (a - b).abs().max() <= BOOK_RTOL * b.abs().max(), step
        assert int(gpu_scope.find_var(it).cpu()) == step + 1
    assert gpu.cache_info()["captures"] == 1


# ------------------------------------------- sequences and recurrent nets

SEQ_RTOL = 1e-5    # float32 card vs CPU, TF32 off, relative to the largest value


def _seq_card_vs_cpu(build, feed, exact=0):
    """``build(xs)`` (inside a fresh program; ``xs`` one data var per feed
    entry that is not a lengths channel) returns the vars to fetch, of
    which the first ``exact`` are integer or copies.  Both executors start
    from the CPU startup's state; returns nothing, asserts the card
    against the CPU."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        xs = [layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                          append_batch_size=False,
                          lod_level=int(n + "@SEQ_LEN" in feed),
                          stop_gradient=a.dtype.kind != "f")
              for n, a in feed.items() if "@" not in n]
        fetch = build(xs)
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    cpu, gpu = pt.Executor(pt.CPUPlace()), pt.Executor()
    cpu.run(startup, scope=cpu_scope)
    gpu.run(startup, scope=gpu_scope)
    for v in main.list_vars():
        if v.persistable and cpu_scope.find_var(v.name) is not None:
            gpu_scope.find_var(v.name).copy_(cpu_scope.find_var(v.name))
    got = gpu.run(main, feed=feed, fetch_list=fetch, scope=gpu_scope)
    ref = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype, fetch[i].name
        if i < exact or a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=fetch[i].name)
        else:
            assert np.isfinite(a).all(), fetch[i].name
            np.testing.assert_allclose(a, b, rtol=0, atol=SEQ_RTOL * max(np.abs(b).max(), 1.0),
                                       err_msg=fetch[i].name)


def _seq_feed(t=6, d=5, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(4, t, d).astype(np.float32),
            "x@SEQ_LEN": np.array([t, 0, 3, 5], np.int32)}


def test_the_sequence_ops_on_the_card_match_the_cpu(cuda):
    """The six pool types, softmax, conv, reshape, pad, slice, erase and
    the lengths on the card against the CPU, with a zero-length row;
    gradients of the float outputs included."""
    feed = dict(_seq_feed(), y=np.random.RandomState(1).randn(4, 6).astype(np.float32),
                ids=np.random.RandomState(2).randint(0, 5, (4, 6, 1)).astype(np.int64),
                pad=np.array([0.5], np.float32))
    feed["y@SEQ_LEN"] = feed["ids@SEQ_LEN"] = feed["x@SEQ_LEN"]

    def build(xs):
        x, y, ids, pad = xs
        helper = pt.layer_helper.LayerHelper("sequence_erase")
        erased = helper.create_variable_for_type_inference("int64")
        helper.append_op("sequence_erase", inputs={"X": ids}, outputs={"Out": erased},
                         attrs={"tokens": [1, 3]})
        padded, length = layers.sequence_pad(x, pad, maxlen=8)
        exact = [erased, layers.sequence_length(erased), length, layers.sequence_length(x),
                 layers.sequence_pool(x, "first"), layers.sequence_pool(x, "last"),
                 layers.sequence_mask(layers.sequence_length(x), maxlen=7, dtype="float32"),
                 padded, layers.sequence_reshape(x, 10)]
        floats = [layers.sequence_pool(x, p) for p in ("sum", "average", "sqrt", "max")]
        floats += [layers.sequence_softmax(y),
                   layers.sequence_conv(x, num_filters=3, filter_size=3, act="tanh"),
                   layers.row_conv(x, future_context_size=2)]
        total = layers.reduce_sum(layers.square(floats[0]))
        for t in floats[1:] + exact[4:6]:
            total = layers.elementwise_add(total, layers.reduce_sum(layers.square(t)))
        floats += pt.calc_gradient(total, [x, y])
        return exact + floats
    _seq_card_vs_cpu(build, feed, exact=9)


@pytest.mark.parametrize("op", ["lstm", "lstm_reverse", "gru", "gru_reverse", "lstmp", "units"])
def test_the_recurrent_ops_on_the_card_match_the_cpu(cuda, op):
    """Each recurrence (lengths below T, one row empty, initial states) and
    every gradient on the card against the CPU from the same parameters."""
    h = 8
    width = 3 * h if op.startswith("gru") or op == "units" else 4 * h
    feed = _seq_feed(t=7, d=width, seed=3)
    feed["h0"] = np.random.RandomState(4).randn(4, h).astype(np.float32)
    if not op.startswith("gru"):
        feed["c0"] = np.random.RandomState(5).randn(4, h).astype(np.float32)

    def bias():
        return pt.ParamAttr(initializer=pt.initializer.Normal(0.0, 0.5))

    def build(xs):
        if op in ("lstm", "lstm_reverse"):
            x, h0, c0 = xs
            out = list(layers.dynamic_lstm(x, size=4 * h, h_0=h0, c_0=c0, bias_attr=bias(),
                                           is_reverse=op.endswith("reverse")))
        elif op.startswith("gru"):
            x, h0 = xs
            out = [layers.dynamic_gru(x, size=h, h_0=h0, bias_attr=bias(),
                                      is_reverse=op.endswith("reverse"))]
        elif op == "lstmp":
            x, h0, c0 = xs
            out = list(layers.dynamic_lstmp(x, size=4 * h, proj_size=3, h_0=h0, c_0=c0,
                                            bias_attr=bias()))
        else:
            x, h0, c0 = xs
            step = layers.reduce_sum(x, dim=1)
            out = list(layers.gru_unit(step, h0, size=3 * h, bias_attr=bias()))
            out += list(layers.lstm_unit(out[0], h0, c0, bias_attr=bias()))
        total = layers.reduce_sum(layers.square(out[0]))
        for t in out[1:]:
            total = layers.elementwise_add(total, layers.reduce_sum(layers.square(t)))
        params = pt.default_main_program().global_block.all_parameters()
        return out + pt.calc_gradient(total, list(xs) + params)
    _seq_card_vs_cpu(build, feed)


@pytest.mark.parametrize("amp", [False, True])
def test_a_stacked_lstm_step_replays_bit_equal_to_an_eager_step(cuda, amp):
    """models/stacked_lstm at a small size with Adam (bf16 through
    ``enable_amp`` too): each step one graph replay launching K2, K3 and K6
    once, the lengths on the device (no capture per batch of other
    lengths), and a replay bit-equal to an op-by-op step from the same
    state."""
    from paddle_tpu_torch.models import stacked_lstm
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        data = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        loss, _ = stacked_lstm.train_network(data, label, dict_dim=1000, emb_dim=32,
                                             hid_dim=32, stacked_num=2)
        pt.optimizer.Adam(learning_rate=0.002).minimize(loss)
    if amp:
        pt.amp.enable_amp(main)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)

    def feed(seed):
        r = np.random.RandomState(seed)
        return {"words": r.randint(0, 1000, (8, 12, 1)).astype(np.int64),
                "words@SEQ_LEN": r.randint(0, 13, (8,)).astype(np.int32),
                "label": r.randint(0, 2, (8, 1)).astype(np.int64)}
    before = (gather_rows.launches, scatter_add_rows.launches, fused_adam.launches)
    losses = [float(exe.run(main, feed=feed(s), fetch_list=[loss], scope=scope)[0])
              for s in range(4)]
    after = (gather_rows.launches, scatter_add_rows.launches, fused_adam.launches)
    # 4 steps, the first's capture adding its eager warm-up run
    assert tuple(b - a for a, b in zip(before, after)) == (5, 5, 5)
    assert exe.cache_info()["captures"] == 1 and np.isfinite(losses).all()
    persist = [v.name for v in main.list_vars() if v.persistable]
    state0 = {n: scope.find_var(n).clone() for n in persist}
    f = feed(9)
    g = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    replayed = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    e = exe._run_eager(main, f, [loss], scope)
    assert np.array_equal(g[0], e[0])
    assert all(torch.equal(replayed[n], scope.find_var(n)) for n in persist)


def _replay_vs_eager(exe, main, feed, fetch, scope):
    """One replay and one op-by-op step of ``main`` from the same state:
    (fetches equal, every persistable equal)."""
    persist = [v.name for v in main.list_vars() if v.persistable]
    state0 = {n: scope.find_var(n).clone() for n in persist}
    g = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    replayed = {n: scope.find_var(n).clone() for n in persist}
    for n, t in state0.items():
        scope.find_var(n).copy_(t)
    e = exe._run_eager(main, feed, fetch, scope)
    return (all(np.array_equal(a, b) for a, b in zip(g, e)),
            all(torch.equal(replayed[n], scope.find_var(n)) for n in persist))


def test_lod_reset_with_target_lod_replays_bit_equal_to_an_eager_step(cuda):
    """``lod_reset(target_lod=)`` makes its lengths on the device once and
    clones them each run, so a training step holding it is one graph (a
    copy from pageable host memory each run made the capture fail)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32", lod_level=1)
        y = layers.lod_reset(layers.fc(input=x, size=4, num_flatten_dims=2),
                             target_lod=[0, 6, 9, 11, 15])
        loss = layers.mean(layers.sequence_pool(y, "sum"))
        pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(4, 6, 4).astype(np.float32)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
              for _ in range(3)]
    (entry,) = [e for e in exe.cache_info()["entries"] if "x" in e["feeds"]]
    assert entry["kind"] == "graph" and exe.cache_info()["captures"] == 1
    assert np.isfinite(losses).all() and losses[2] < losses[0]
    assert _replay_vs_eager(exe, main, feed, [loss], scope) == (True, True)


def _while_training(max_iters):
    """y = x + 3 w x through three trips of a While, SGD on (y - t)^2."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = layers.data(name="x", shape=[64, 1], append_batch_size=False)
        t = layers.data(name="t", shape=[64, 1], append_batch_size=False)
        w = layers.create_parameter(shape=[1], dtype="float32")
        i = layers.fill_constant(shape=[1], dtype="int32", value=0)
        limit = layers.fill_constant(shape=[1], dtype="int32", value=3)
        y = layers.elementwise_add(x, layers.fill_constant(shape=[64, 1], dtype="float32",
                                                           value=0.0))
        y.stop_gradient = False
        cond = layers.less_than(i, limit)
        with layers.While(cond, max_iters=max_iters).block():
            layers.assign(layers.elementwise_add(y, layers.elementwise_mul(x, w, axis=0)),
                          output=y)
            layers.increment(i, value=1, in_place=True)
            layers.less_than(i, limit, cond=cond)
        diff = layers.elementwise_sub(y, t)
        loss = layers.mean(layers.elementwise_mul(diff, diff))
        if max_iters is not None:
            pt.optimizer.SGD(learning_rate=0.03).minimize(loss)
    xv = np.random.RandomState(0).rand(64, 1).astype(np.float32) + 0.5
    return main, startup, loss, {"x": xv, "t": (1 + 3 * 0.7) * xv}


def test_a_bounded_while_step_replays_bit_equal_to_an_eager_step(cuda):
    """``max_iters`` keeps the trips on the device: the SGD step is one
    graph replay launching K5 once, and a replay is bit-equal to an
    op-by-op step from the same state."""
    main, startup, loss, feed = _while_training(max_iters=4)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    before = fused_sgd.launches
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
              for _ in range(4)]
    (entry,) = [e for e in exe.cache_info()["entries"] if "x" in e["feeds"]]
    assert entry["kind"] == "graph" and entry["reasons"] == []
    # 4 steps, the capture adding its eager warm-up run
    assert fused_sgd.launches - before == 5
    assert np.isfinite(losses).all() and losses[3] < losses[0]
    assert _replay_vs_eager(exe, main, feed, [loss], scope) == (True, True)


def test_an_unbounded_while_runs_op_by_op_and_says_why(cuda):
    main, startup, loss, feed = _while_training(max_iters=None)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    a = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    (entry,) = [e for e in exe.cache_info()["entries"] if "x" in e["feeds"]]
    assert entry["kind"] == "eager" and exe.cache_info()["captures"] == 0
    assert entry["reasons"] == ["runs 1 unbounded while loop(s) (no max_iters), which read "
                                "their condition on the host each trip"]
    bounded_main, bounded_startup, bounded_loss, _ = _while_training(max_iters=4)
    b_scope, b_exe = pt.Scope(), pt.Executor()
    b_exe.run(bounded_startup, scope=b_scope)
    b_scope.find_var(bounded_main.global_block.all_parameters()[0].name).copy_(
        scope.find_var(main.global_block.all_parameters()[0].name))
    b = b_exe._run_eager(bounded_main, feed, [bounded_loss], b_scope)
    assert np.array_equal(a[0], b[0])


def test_the_encoder_decoder_trains_one_replay_a_step(cuda):
    """The book's encoder-decoder at a small width with ``piecewise_decay``:
    one graph for its five blocks, K2 4 times, K3 twice and K6 once a
    replay, the rate crossing its boundaries, a replay bit-equal to an
    op-by-op step."""
    from paddle_tpu_torch.models.rnn_encoder_decoder import synthetic_feed, train_network
    rates = [5e-3, 2e-3, 1e-3]
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        loss, lr = train_network(4, 6, [1, 2], rates, dict_size=24, word_dim=12, hidden_dim=16)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    feed = synthetic_feed(3, 4, 6, dict_size=24)
    exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope)
    before = (gather_rows.launches, scatter_add_rows.launches, fused_adam.launches)
    runs = [exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope) for _ in range(3)]
    after = (gather_rows.launches, scatter_add_rows.launches, fused_adam.launches)
    assert tuple(b - a for a, b in zip(before, after)) == (12, 6, 3)
    (entry,) = [e for e in exe.cache_info()["entries"] if "src" in e["feeds"]]
    assert entry["kind"] == "graph" and exe.cache_info()["captures"] == 1
    assert [float(r[1][0]) for r in runs] == [float(np.float32(v)) for v in rates[1:]] + \
        [float(np.float32(rates[-1]))]
    assert _replay_vs_eager(exe, main, feed, [loss, lr], scope) == (True, True)


def _small_deepfm(is_test, vocab=(50, 30, 20), dim=4, batch=16):
    from paddle_tpu_torch.models import deepfm
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids, dense, label = deepfm.data_layers(len(vocab))
        loss, _ = deepfm.train_network(ids, dense, label, list(vocab), embed_dim=dim,
                                       is_test=is_test)
        pt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    feed = deepfm.synthetic_feed(4, batch, vocab)
    feed["C0"][:3, 0] = vocab[0] - 1          # the last row, three times
    return main, startup, loss, feed


def test_sparse_adam_step_replays_bit_equal_to_an_eager_step(cuda):
    """A small DeepFM with SelectedRows gradients and lazy Adam: one graph,
    K2 once a lookup and K6 once (the dense MLP) a replay, no K3 and no
    K5; a replay bit-equal to an op-by-op step; untouched rows unmoved."""
    main, startup, loss, feed = _small_deepfm(is_test=True)
    scope, exe = pt.Scope(), pt.Executor()
    exe.run(startup, scope=scope)
    exe.precompile(main, feed=feed, fetch_list=[loss], scope=scope)
    counts = (gather_rows.launches, scatter_add_rows.launches, fused_adam.launches,
              fused_sgd.launches)
    start = {n: scope.find_var(n).clone() for n in ("fm_emb_0", "fm_w1_2")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    after = (gather_rows.launches, scatter_add_rows.launches, fused_adam.launches,
             fused_sgd.launches)
    assert tuple(b - a for a, b in zip(counts, after)) == (6, 0, 1, 0)
    (entry,) = [e for e in exe.cache_info()["entries"] if "C0" in e["feeds"]]
    assert entry["kind"] == "graph" and exe.cache_info()["captures"] == 1
    for name, field in (("fm_emb_0", "C0"), ("fm_w1_2", "C2")):
        hit = sorted(set(feed[field][:, 0].tolist()))
        rest = [r for r in range(start[name].shape[0]) if r not in hit]
        now = scope.find_var(name)
        assert torch.equal(now[rest], start[name][rest])
        assert not torch.equal(now[hit], start[name][hit])
    assert _replay_vs_eager(exe, main, feed, [loss], scope) == (True, True)


def test_merged_recorded_in_a_cuda_graph(cuda):
    """``SelectedRows.merged()`` captured in a CUDA graph: replays over new
    ids (copied into the static buffer) equal the eager merge bit for bit,
    and the unique ids equal ``torch.unique``'s, padded with the height."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    height, k = 1000, 512
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, 40, (k,), device="cuda", generator=g, dtype=torch.int32)
    rows = torch.randn(k, 16, device="cuda", generator=g)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        SelectedRows(ids, rows, height).merged()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = SelectedRows(ids, rows, height).merged()
    for seed in range(3):
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        ids.copy_(torch.randint(0, 40 + 300 * seed, (k,), device="cuda", generator=gen,
                                dtype=torch.int32))
        ids[-1] = height - 1
        rows.copy_(torch.randn(k, 16, device="cuda", generator=gen))
        graph.replay()
        want = SelectedRows(ids, rows, height).merged()
        assert torch.equal(out.ids, want.ids) and torch.equal(out.rows, want.rows)
        uniq = torch.unique(ids)
        assert torch.equal(out.ids[:uniq.numel()], uniq)
        assert bool((out.ids[uniq.numel():] == height).all())
        dense = torch.zeros(height, 16, device="cuda", dtype=torch.float64).index_put_(
            (ids.long(),), rows.double(), accumulate=True)
        torch.testing.assert_close(out.to_dense(), dense.float(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("rule", ["adam", "adagrad", "sgd"])
def test_sparse_update_padded_slots_at_the_last_row(cuda, rule):
    """A batch with duplicates and the table's last row (the padded slots
    point at slot 0's row): the sparse update on the card twice bit-equal,
    within 1e-6 of the CPU's, the untouched rows bit-equal."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.ops.sparse_ops import sparse_adagrad, sparse_adam, sparse_sgd
    height, d = 300, 8
    gen = torch.Generator().manual_seed(11)
    ids = torch.tensor([299, 5, 299, 17, 5, 5, 299, 0], dtype=torch.int32)
    rows = torch.randn(len(ids), d, generator=gen)
    tables = [torch.randn(height, d, generator=gen) for _ in range(3)]
    tables[2] = tables[2].abs()
    lr = torch.tensor([0.05])
    powers = (torch.tensor([0.9]), torch.tensor([0.999]))

    def step(dev):
        p, m1, m2 = (t.to(dev).clone() for t in tables)
        g = SelectedRows(ids.to(dev), rows.to(dev), height)
        g = g if rule == "sgd" else g.merged()
        if rule == "adam":
            sparse_adam(p, g, m1, m2, *(x.to(dev) for x in powers), lr.to(dev), 0.9, 0.999, 1e-8)
        elif rule == "adagrad":
            sparse_adagrad(p, g, m2, lr.to(dev), 1e-6)
        else:
            sparse_sgd(p, g, lr.to(dev))
        return [t.cpu() for t in (p, m1, m2)]

    a, b, cpu = step("cuda"), step("cuda"), step("cpu")
    touched = [0, 5, 17, 299]
    rest = [r for r in range(height) if r not in touched]
    for x, y, z, t0 in zip(a, b, cpu, tables):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, atol=1e-6, rtol=0)
        assert torch.equal(x[rest], t0[rest])
    assert not torch.equal(a[0][299], tables[0][299])


def _fed_and_read_programs():
    """The same regression net and Adam step twice: over data layers, and
    over a py_reader whose read op the executor binds."""
    out = []
    for read in (False, True):
        main, startup, scope = pt.Program(), pt.Program(), pt.Scope()
        with pt.scope_guard(scope), pt.unique_name.guard(), pt.program_guard(main, startup):
            if read:
                reader = layers.py_reader(capacity=4, shapes=[[-1, 32], [-1, 1]],
                                          dtypes=["float32", "float32"])
                x, y = layers.read_file(reader)
            else:
                reader = None
                x = layers.data(name="x", shape=[32], dtype="float32")
                y = layers.data(name="y", shape=[1], dtype="float32")
            h = layers.fc(input=x, size=64, act="relu")
            loss = layers.mean(layers.square_error_cost(input=layers.fc(input=h, size=1),
                                                        label=y))
            pt.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        out.append((main, startup, scope, loss, reader))
    return out


def test_a_read_op_step_replays_bit_equal_to_its_fed_twin(cuda):
    """Four steps through a py_reader (the executor pops each batch and
    copies it in as a feed) against the same steps fed: each program one
    CUDA graph, K6 once a replay, losses and every state tensor bit-equal."""
    (fmain, fstart, fscope, floss, _), (rmain, rstart, rscope, rloss, reader) = \
        _fed_and_read_programs()
    fexe, rexe = pt.Executor(), pt.Executor()
    fexe.run(fstart, scope=fscope)
    rexe.run(rstart, scope=rscope)
    persist = [v.name for v in fmain.list_vars() if v.persistable]
    for n in persist:
        rscope.find_var(n).copy_(fscope.find_var(n))
    rs = np.random.RandomState(5)
    batches = [(rs.randn(64, 32).astype(np.float32), rs.randn(64, 1).astype(np.float32))
               for _ in range(4)]
    reader.decorate_paddle_reader(lambda: iter(batches))
    reader.start()
    names = rmain.desc.block(0).ops[0].output("Out")
    k6 = fused_adam.launches
    fed = [float(fexe.run(fmain, feed={"x": x, "y": y}, fetch_list=[floss], scope=fscope)[0])
           for x, y in batches]
    k6_fed = fused_adam.launches - k6
    read = [float(rexe.run(rmain, fetch_list=[rloss], scope=rscope)[0]) for _ in batches]
    with pytest.raises(pt.EOFException):
        rexe.run(rmain, fetch_list=[rloss], scope=rscope)
    assert read == fed
    for n in persist:
        assert torch.equal(rscope.find_var(n), fscope.find_var(n)), n
    for exe, feeds in ((fexe, ["x", "y"]), (rexe, names)):
        (entry,) = [e for e in exe.cache_info()["entries"] if e["feeds"]]
        assert entry["kind"] == "graph" and sorted(entry["feeds"]) == sorted(feeds)
        assert exe.cache_info()["captures"] == 1
    assert fused_adam.launches - k6 == 2 * k6_fed and k6_fed == 5   # the capture's eager run


def test_device_loader_yields_cuda_tensors_equal_to_the_host_batch(cuda):
    """Batches copied on the loader's side stream: CUDA tensors equal to the
    host arrays, read on the consumer's stream after their event."""
    from paddle_tpu_torch.reader import DeviceLoader
    rs = np.random.RandomState(7)
    host = [(rs.randn(2048, 13).astype(np.float32), rs.randint(0, 1000, (2048, 26)))
            for _ in range(6)]
    got = []
    for x, ids in DeviceLoader(lambda: iter(host), capacity=3)():
        assert x.is_cuda and ids.is_cuda and ids.dtype == torch.int64
        got.append((x * 2, ids + 1))          # work on the consumer's stream
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for (x2, ids1), (x, ids) in zip(got, host):
        np.testing.assert_array_equal(x2.cpu().numpy(), x * 2)
        np.testing.assert_array_equal(ids1.cpu().numpy(), ids + 1)


# ------------------------------------------------------- decode serving


def _decode_step_feed(eng, b, cap, rs):
    from paddle_tpu_torch.serving import decode_models as zoo
    tok_row = tuple(int(d) for d in eng._tok_in.shape[1:])
    feed = {eng._tok_in.name: rs.randint(1, zoo.VOCAB, (b,) + tok_row).astype(np.int64)}
    if eng._pos_in is not None:
        feed[eng._pos_in.name] = rs.randint(0, cap, (b, 1)).astype(np.int32)
    for sp in eng._specs:
        feed[sp.name] = rs.randn(*((b,) + sp.slot_shape(cap))).astype(np.float32)
    return feed


@pytest.mark.parametrize("family", ["gru_lm", "attention_lm", "beam_gru_lm"])
def test_decode_step_replay_bit_equal_to_an_eager_step_at_every_bucket(cuda, family):
    """The engine warms one CUDA graph a (batch, seq) bucket of its step
    program; each replay is bit-equal to the same step run op by op."""
    from paddle_tpu_torch.serving import DecodeEngine
    from paddle_tpu_torch.serving import decode_models as zoo
    pre, step, _ = getattr(zoo, family)()
    eng = DecodeEngine(pre, step, eos_id=0, max_seq_len=16, max_batch_size=4, seed=3,
                       name=f"replay-{family}")
    try:
        rs = np.random.RandomState(1)
        kinds = {r["kind"] for r in eng.warmup_reports}
        assert kinds == {"graph"}, eng.warmup_reports
        for cap in eng.seq_buckets:
            for b in eng.batch_buckets:
                feed = _decode_step_feed(eng, b, cap, rs)
                got = eng.exe.run(eng._step_prog, feed=feed, fetch_list=eng._step_fetch,
                                  scope=eng.scope, return_numpy=False)
                want = eng.exe._run_eager(eng._step_prog, feed=feed,
                                          fetch_list=eng._step_fetch, scope=eng.scope,
                                          return_numpy=False)
                for g, w in zip(got, want):
                    assert g.is_cuda and torch.equal(g, w), (family, b, cap)
        assert eng.fresh_compiles_since_warmup == 0
    finally:
        eng.close(drain=False)


@pytest.mark.parametrize("family", ["gru_lm", "attention_lm"])
def test_decode_step_row_bit_equal_at_batch_1_and_inside_batch_8(cuda, family):
    """Batch invariance, on which the static-vs-continuous gate rests: a
    row's logits, next token and state at batch bucket 1 are bit-equal to
    the same row inside bucket 8 (other rows random)."""
    from paddle_tpu_torch.serving import decode_models as zoo
    _, step, _ = getattr(zoo, family)()
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        (tok, pos, states), (nxt, outs) = step()
    logits = next(o.input("X")[0] for o in main.desc.block(0).ops if o.type == "arg_max")
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    startup.random_seed = 4
    exe.run(startup, scope=scope)
    fetch = [logits, nxt] + list(outs)
    rs = np.random.RandomState(2)
    cap, row = 16, 3

    def feed(b):
        f = {tok.name: rs.randint(1, zoo.VOCAB, (b, 1)).astype(np.int64)}
        if pos is not None:
            f[pos.name] = rs.randint(0, cap, (b, 1)).astype(np.int32)
        for s in states:
            f[s.name] = rs.randn(*((b,) + tuple(cap if d < 0 else d for d in s.shape[1:]))
                                 ).astype(np.float32)
        return f

    wide = feed(8)
    one = {k: v[row:row + 1] for k, v in wide.items()}
    for _ in range(2):                   # a capture's first run, then a replay
        got8 = exe.run(main, feed=wide, fetch_list=fetch, scope=scope)
        got1 = exe.run(main, feed=one, fetch_list=fetch, scope=scope)
    for g8, g1, name in zip(got8, got1, ["logits", "next"] + [o.name for o in outs]):
        np.testing.assert_array_equal(g8[row:row + 1], g1, err_msg=name)
