"""The 3xTF32 split of the fused linear-CE kernels (K7, K8) on the CPU.

``split_tf32`` mirrors, bit for bit, how csrc/gemm_3xtf32.cuh splits a
float32 operand for the tensor cores: ``hi`` with the low 13 mantissa bits
cleared, ``lo`` the exact rest rounded to TF32.  The kernel itself runs
only on the card (tests/test_torch_gpu.py); here the split's arithmetic is
held against float64.  Inputs come from a numpy seed.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda.linear_ce import (gemm_3xtf32, gemm_3xtf32_plain,
                                                 split_tf32)

from _torch_validate import _no_port_validate_findings  # noqa: F401

LOW13 = (1 << 13) - 1


def _operands(seed=11, m=64, k=96, n=80):
    rs = np.random.RandomState(seed)
    return (torch.from_numpy(rs.randn(m, k).astype(np.float32)),
            torch.from_numpy(rs.randn(k, n).astype(np.float32)))


def _norm_rel(got, ref):
    return ((got - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e18])
def test_split_rebuilds_the_input_to_2_pow_minus_21(scale):
    a, _ = _operands()
    a = a * scale
    hi, lo = split_tf32(a)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == a.shape
    err = ((hi.double() + lo.double()) - a.double()).abs() / a.double().abs()
    assert err.max().item() <= 2.0 ** -21


def test_split_parts_are_tf32_values():
    """13 zero low mantissa bits in both parts; hi is the input truncated,
    so it never exceeds the input in magnitude and the rest has its sign."""
    a, _ = _operands(seed=12)
    hi, lo = split_tf32(a)
    assert not (hi.view(torch.int32) & LOW13).any()
    assert not (lo.view(torch.int32) & LOW13).any()
    assert torch.equal(hi.view(torch.int32), a.view(torch.int32) & ~LOW13)
    assert (hi.abs() <= a.abs()).all()
    assert ((lo == 0) | (torch.sign(lo) == torch.sign(a))).all()


def test_split_lo_rounds_to_nearest_ties_away():
    """The rest is rounded to 11 significant bits, not truncated.  1 + 2**-11
    + 2**-22: the rest 2**-11 + 2**-22 is a tie and goes away from zero, to
    2**-11 + 2**-21.  1 + 2**-10 - 2**-23: the rest is thirteen one-bits and
    rounds up to 2**-10."""
    v = torch.tensor([1 + 2.0 ** -11 + 2.0 ** -22, 1 + 2.0 ** -10 - 2.0 ** -23,
                      -(1 + 2.0 ** -10 - 2.0 ** -23), 0.0, 1.0], dtype=torch.float32)
    hi, lo = split_tf32(v)
    assert hi.tolist() == [1.0, 1.0, -1.0, 0.0, 1.0]
    assert lo.tolist() == [2.0 ** -11 + 2.0 ** -21, 2.0 ** -10, -(2.0 ** -10), 0.0, 0.0]


def test_three_term_product_recovers_float32_accuracy_one_term_does_not():
    """a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in float64, is within
    1e-6 norm-relative of the float64 product at [64, 96] x [96, 80]; the
    single TF32 product a_hi b_hi (the control) is a thousand times off."""
    a, b = _operands()
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    ref = a.double() @ b.double()
    three = al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()
    one = ah.double() @ bh.double()
    assert _norm_rel(three, ref) < 1e-6
    assert _norm_rel(one, ref) > 1e-4
    assert _norm_rel(three, ref) * 100 < _norm_rel(one, ref)


def test_split_rejects_other_types():
    with pytest.raises(TypeError, match="float32"):
        split_tf32(torch.zeros(4, dtype=torch.float64))


def test_gemm_3xtf32_on_the_cpu_is_the_plain_product_and_checks_shapes():
    a, b = _operands(seed=13)
    at, bk = a.t().contiguous(), b.t().contiguous()        # [K, M], [N, K]
    got = gemm_3xtf32(at, bk)
    assert torch.equal(got, gemm_3xtf32_plain(at, bk))
    np.testing.assert_allclose(got.numpy(), (a @ b).numpy(), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match=r"at \[K, M\]"):
        gemm_3xtf32(at, bk.t().contiguous())
    with pytest.raises(ValueError, match="one CUDA device"):
        gemm_3xtf32(at.to("meta"), bk)
