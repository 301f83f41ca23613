"""The bf16 split of K1's bf16 kernel (csrc/flash_attention_fwd_bf16.cu) on
the CPU.

``split_bf16`` mirrors, bit for bit, how the kernel splits P into two bf16
terms for its tensor-core ``p.v`` products.  The kernel itself runs only on
the card (tests/test_torch_gpu.py).  Here the split's arithmetic is held
against float64, and a torch emulation of the kernel's arithmetic (bf16
products summed in float32 per 64-key tile, P split into bf16 terms, per
tile partials added to a float32 accumulator) is held to the float64 gate
that chip_smoke.py holds the kernel to, with P rounded once (one term) as
the control, and against the JAX package's Pallas kernel in interpret mode
on the same bf16 inputs.  Inputs come from a numpy seed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.flash_attention import _flash_fwd_pallas
from paddle_tpu_torch.ops.cuda.flash_attention import NEG_INF, flash_attn_fwd_plain, split_bf16

from _torch_validate import _no_port_validate_findings  # noqa: F401

FLASH_TOL = 1e-5      # float32 sums, as chip_smoke.py's gate
SPLIT_REL = 2.0 ** -17
SPLIT_ABS = 2.0 ** -134   # half the spacing of bf16's subnormals
TILE = 64                 # the kernel's key tile
LOG2E = np.float32(1.4426950408889634)
CASE_LENS = [0, 37, 64, 100]   # no key, inside a tile, a tile's edge, T


def _bf16(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(torch.bfloat16)


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def _emulate(q, k, v, lens, causal, sm_scale, terms=2):
    """The kernel's arithmetic on bf16 q, k, v [BH, T, d]: per 64-key tile,
    S = q.k^T (exact products summed in float32) times the scale in
    float32, the masks, the online softmax in float32 (exp2 of the
    log2(e)-scaled scores less the running max's), P split into ``terms``
    bf16 terms (2 as the kernel; 1 is P rounded once, the control) whose
    products with V are summed in float32 from zero into the tile's partial,
    the small term first; the accumulator rescaled by alpha and the partial
    added.  out = acc / l rounded once to bf16, lse = m + log(l)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    qpos = torch.arange(tq)[:, None]
    neg = torch.tensor(NEG_INF, dtype=torch.float32)
    m = torch.full((bh, tq), NEG_INF, dtype=torch.float32)
    ml = torch.zeros((bh, tq))
    lsum = torch.zeros((bh, tq))
    acc = torch.zeros((bh, tq, d))
    for k0 in range(0, tk, TILE):
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + TILE]) * np.float32(sm_scale)
        kp = torch.arange(k0, min(k0 + TILE, tk))
        valid = kp[None, None, :] < lens[:, None, None]
        if causal:
            valid = valid & (kp[None, None, :] <= qpos[None])
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        ml_new = m_new * LOG2E
        alpha = torch.exp2(torch.where(m > NEG_INF / 2, ml - ml_new, 0.0))
        p = torch.where((m_new > NEG_INF / 2)[..., None],
                        torch.exp2(s * LOG2E - ml_new[..., None]), 0.0)
        lsum = lsum * alpha + p.sum(-1)
        parts = split_bf16(p) if terms == 2 else (p.to(torch.bfloat16),)
        partial = torch.zeros_like(acc)
        for t in reversed(parts):
            partial = partial + torch.einsum("bqk,bkd->bqd", t.float(), vf[:, k0:k0 + TILE])
        acc = acc * alpha[..., None] + partial
        m, ml = m_new, ml_new
    l_safe = lsum.clamp_min(1e-20)
    out = torch.where((m > NEG_INF / 2)[..., None], acc / l_safe[..., None], 0.0)
    return out.to(torch.bfloat16), m + torch.log(l_safe)


def _case(d, causal, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (_bf16(rs, len(CASE_LENS), 100, d) for _ in range(3))
    lens = torch.tensor(CASE_LENS, dtype=torch.int32)
    o64, l64 = flash_attn_fwd_plain(q.double(), k.double(), v.double(), lens, causal,
                                    d ** -0.5)
    return q, k, v, lens, o64, l64


def _excess(out, o64):
    """max |out - float64| less half a bf16 ulp (at the larger magnitude) and
    FLASH_TOL: <= 0 inside the gate."""
    x = out.double()
    return ((x - o64).abs() - 0.5 * _bf16_ulp(torch.maximum(x.abs(), o64.abs()))
            - FLASH_TOL).max().item()


# ------------------------------------------------------------ the split


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e-37, 1e-39])
def test_split_rebuilds_its_input_to_2_pow_minus_17(scale):
    """hi + lo is within 2**-17 |x| of x, or 2**-134 where lo is a bf16
    subnormal (the last two scales: subnormal rests, subnormal inputs)."""
    rs = np.random.RandomState(21)
    x = torch.from_numpy((rs.randn(4096) * scale).astype(np.float32))
    x[:8] = 0.0
    hi, lo = split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == x.shape
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= (SPLIT_REL * x.double().abs()).clamp_min(SPLIT_ABS)).all()
    assert not hi[:8].float().any() and not lo[:8].float().any()


def test_split_parts_are_the_roundings_of_the_input_and_of_its_rest():
    """hi is x rounded to bf16; the rest x - hi is exact in float32, below
    half of hi's ulp, and lo is it rounded to bf16."""
    rs = np.random.RandomState(22)
    x = torch.from_numpy(rs.rand(4096).astype(np.float32))
    hi, lo = split_bf16(x)
    assert torch.equal(hi, x.to(torch.bfloat16))
    rest = x - hi.float()
    assert torch.equal((rest.double() + hi.double()), x.double())     # exact
    assert (rest.abs() <= 0.5 * _bf16_ulp(hi.float())).all()
    assert torch.equal(lo, rest.to(torch.bfloat16))


def test_split_rounds_to_nearest_even():
    """1 + 2**-8 lies halfway between 1 and 1 + 2**-7 and goes to 1 (even);
    1 + 3 * 2**-8 lies halfway between 1 + 2**-7 and 1 + 2**-6 and goes to
    1 + 2**-6; the rests are exact in bf16."""
    x = torch.tensor([1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(1 + 3 * 2.0 ** -8), 0.0, 1.0],
                     dtype=torch.float32)
    hi, lo = split_bf16(x)
    assert hi.float().tolist() == [1.0, 1 + 2.0 ** -6, -(1 + 2.0 ** -6), 0.0, 1.0]
    assert lo.float().tolist() == [2.0 ** -8, -(2.0 ** -8), 2.0 ** -8, 0.0, 0.0]


def test_split_rejects_other_types():
    with pytest.raises(TypeError, match="float32"):
        split_bf16(torch.zeros(4, dtype=torch.float64))


def test_two_terms_of_p_recover_float32_accuracy_one_does_not():
    """P in [0, 1] (softmax weights) times bf16 V: the two bf16 terms'
    products, each exact, summed in float64, are within 2**-17
    norm-relative of the float64 product; P rounded once (the control) is
    at least a hundred times further off."""
    rs = np.random.RandomState(23)
    p = torch.from_numpy(rs.rand(64, 96).astype(np.float32))
    v = _bf16(rs, 96, 80)
    ref = p.double() @ v.double()
    hi, lo = split_bf16(p)
    two = hi.double() @ v.double() + lo.double() @ v.double()
    one = hi.double() @ v.double()
    rel = [((x - ref).norm() / ref.norm()).item() for x in (two, one)]
    assert rel[0] <= SPLIT_REL
    assert rel[0] * 100 < rel[1]


# ------------------------------------------------------- the kernel's arithmetic


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_kernel_is_inside_the_float64_gate(d, causal):
    """B*H 4, T 100 (ragged: a full tile and 36 keys), key lengths 0..T:
    every output within half a bf16 ulp + FLASH_TOL of float64 over the
    same bf16 inputs, lse within FLASH_TOL, exact zeros for a row with no
    key.  d 32 and 128 have a scale that is not a power of two."""
    q, k, v, lens, o64, l64 = _case(d, causal, seed=30 + d)
    out, lse = _emulate(q, k, v, lens, causal, d ** -0.5)
    assert _excess(out, o64) <= 0
    keyed = lens > 0
    assert (lse[keyed].double() - l64[keyed]).abs().max().item() <= FLASH_TOL
    assert not out[0].float().any()


def test_one_term_control_falls_outside_the_float64_gate():
    """P rounded once to bf16 before p.v is outside the gate that the two
    terms keep (on every case here, by ~1.5e-3; the test needs one)."""
    outside = []
    for d in (16, 32, 64, 128):
        for causal in (False, True):
            q, k, v, lens, o64, _ = _case(d, causal, seed=30 + d)
            ctl, _ = _emulate(q, k, v, lens, causal, d ** -0.5, terms=1)
            outside.append(_excess(ctl, o64) > 0)
    assert any(outside), outside


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_emulated_kernel_matches_pallas_interpret(d):
    """The same bf16 inputs through the Pallas kernel in interpret mode
    (float32 math, the output rounded once): every output within 1 bf16
    ulp + FLASH_TOL (the two sides' float32 values differ by summation
    order and the split, by up to FLASH_TOL, and may then round to
    neighbouring bf16 values), as tests/test_torch_gpu.py holds the kernel
    to its plain version; lse within FLASH_TOL.  Non-causal: interpret mode
    cannot lower the causal skip."""
    rs = np.random.RandomState(40 + d)
    bh, t = 4, 96
    q, k, v = (_bf16(rs, bh, t, d) for _ in range(3))
    lens = np.array([96, 0, 5, 40], np.int32)
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    ref_out, ref_lse = _flash_fwd_pallas(jq, jk, jv, jnp.asarray(lens), False, d ** -0.5, 32, 32,
                                         interpret=True)
    out, lse = _emulate(q, k, v, torch.from_numpy(lens), False, d ** -0.5)
    got, ref = out.float().numpy(), np.asarray(ref_out.astype(jnp.float32))
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert (np.abs(got - ref) <= ulp + FLASH_TOL).all()
    keyed = lens > 0
    np.testing.assert_allclose(lse.numpy()[keyed], np.asarray(ref_lse)[keyed], atol=FLASH_TOL,
                               rtol=0)
    assert not got[1].any()
