"""The training slice's kernels in the PyTorch/CUDA port against the JAX
package's Pallas kernels, and the flash-attention gradient against
``jax.vjp``.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode, as the JAX package's
own tests do (tests/test_fused_ce.py, tests/test_kernel_policy.py).  The
causal flash case goes to the JAX package's composed path: interpret mode
cannot lower the Pallas kernel's causal block skip on this JAX version.
Inputs come from a numpy seed and go to both as numpy arrays.  The CUDA
kernels are held against these plain versions in test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas.embedding import scatter_add_rows as pallas_scatter_add_rows
from paddle_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from paddle_tpu.ops.pallas.fused_optimizer import fused_adam as pallas_fused_adam
from paddle_tpu.ops.pallas.linear_ce import linear_ce_bwd as pallas_linear_ce_bwd
from paddle_tpu.ops.pallas.linear_ce import linear_ce_fwd as pallas_linear_ce_fwd
from paddle_tpu_torch.ops.cuda.embedding import GatherRows, scatter_add_rows
from paddle_tpu_torch.ops.cuda.flash_attention import FlashAttention
from paddle_tpu_torch.ops.cuda.fused_optimizer import fused_adam
from paddle_tpu_torch.ops.cuda.linear_ce import linear_ce_bwd, linear_ce_fwd

CE_FWD_ATOL = 1e-5       # lse and label logit, float32
CE_BWD_ATOL = 1e-4       # dx, dW, db: sums over 256 rows or 1024 columns
ADAM_P_ATOL = 2e-6       # the JAX package's own kernel-vs-composed bound
ADAM_M_ATOL = 1e-6
SCATTER_ATOL = 1e-6
FLASH_GRAD_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------- K7, K8: linear CE


@pytest.mark.parametrize("bias", [True, False])
def test_linear_ce_plain_matches_pallas_interpret(bias):
    rs = np.random.RandomState(7)
    bsz, d, v = 256, 128, 1024
    x = rs.randn(bsz, d).astype(np.float32)
    w = (0.1 * rs.randn(d, v)).astype(np.float32)
    b = rs.randn(v).astype(np.float32) if bias else None
    labels = rs.randint(0, v, bsz).astype(np.int32)
    labels[:3] = [0, v - 1, v]            # the edges, and one out of range
    g = rs.rand(bsz).astype(np.float32)
    jb = jnp.asarray(b) if bias else None
    ref_lse, ref_lab = pallas_linear_ce_fwd(jnp.asarray(x), jnp.asarray(w), jb,
                                            jnp.asarray(labels), interpret=True)
    ref_dx, ref_dw, ref_db = pallas_linear_ce_bwd(
        jnp.asarray(x), jnp.asarray(w), jb, jnp.asarray(labels), ref_lse,
        jnp.asarray(g), interpret=True)
    tb = _t(b) if bias else None
    lse, lab = linear_ce_fwd(_t(x), _t(w), tb, _t(labels))
    dx, dw, db = linear_ce_bwd(_t(x), _t(w), tb, _t(labels), lse, _t(g))
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=CE_FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lab.numpy(), np.asarray(ref_lab), atol=CE_FWD_ATOL, rtol=0)
    assert lab[2].item() == 0.0
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=CE_BWD_ATOL, rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(ref_dw), atol=CE_BWD_ATOL, rtol=0)
    if bias:
        np.testing.assert_allclose(db.numpy(), np.asarray(ref_db), atol=CE_BWD_ATOL, rtol=0)
    else:
        assert db is None


def test_linear_ce_plain_chunks_agree_with_one_dense_softmax():
    """V over several plain-version chunks (ragged last chunk) against a
    dense softmax in float64."""
    rs = np.random.RandomState(8)
    bsz, d, v = 16, 8, 9000
    x, w, b = (rs.randn(bsz, d), 0.3 * rs.randn(d, v), rs.randn(v))
    labels = rs.randint(0, v, bsz).astype(np.int32)
    g = rs.rand(bsz)
    logits = x @ w + b
    lse_ref = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) + logits.max(1)
    p = np.exp(logits - lse_ref[:, None])
    p[np.arange(bsz), labels] -= 1.0
    dl = p * g[:, None]
    f32 = [_t(a.astype(np.float32)) for a in (x, w, b)]
    lse, lab = linear_ce_fwd(*f32, _t(labels))
    dx, dw, db = linear_ce_bwd(*f32, _t(labels), lse, _t(g.astype(np.float32)))
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(lab.numpy(), logits[np.arange(bsz), labels], atol=1e-4, rtol=0)
    np.testing.assert_allclose(dx.numpy(), dl @ w.T, atol=1e-4, rtol=0)
    np.testing.assert_allclose(dw.numpy(), x.T @ dl, atol=1e-4, rtol=0)
    np.testing.assert_allclose(db.numpy(), dl.sum(0), atol=1e-4, rtol=0)


def test_linear_ce_wrappers_reject_bad_arguments():
    x, w = torch.zeros(4, 8), torch.zeros(8, 12)
    with pytest.raises(TypeError, match="int32"):
        linear_ce_fwd(x, w, None, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"x \[B, D\]"):
        linear_ce_fwd(x, torch.zeros(7, 12), None, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="bias"):
        linear_ce_fwd(x, w, torch.zeros(5), torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------- K6: Adam


def test_fused_adam_plain_matches_pallas_interpret():
    rs = np.random.RandomState(2)
    shp = (64, 130)
    p = rs.randn(*shp).astype(np.float32)
    g = rs.randn(*shp).astype(np.float32)
    m1 = (rs.randn(*shp) * 0.1).astype(np.float32)
    m2 = (np.abs(rs.randn(*shp)) * 0.01).astype(np.float32)
    b1p, b2p, lr = (np.array(v, np.float32) for v in (0.9, 0.999, 0.01))
    ref = pallas_fused_adam(*(jnp.asarray(a) for a in (p, g, m1, m2, b1p, b2p, lr)),
                            0.9, 0.999, 1e-8, interpret=True)
    got = fused_adam(*(_t(a) for a in (p, g, m1, m2, b1p, b2p, lr)), 0.9, 0.999, 1e-8)
    assert len(got) == 5
    for a, b, tol in zip(got, ref, (ADAM_P_ATOL, ADAM_M_ATOL, ADAM_M_ATOL, 0, 0)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=1e-7)


def test_fused_adam_leaves_its_inputs_alone():
    p, g, m1, m2 = (torch.full((5,), v) for v in (1.0, 0.5, 0.0, 0.0))
    one = torch.ones(())
    fused_adam(p, g, m1, m2, one, one, torch.tensor(0.1), 0.9, 0.999, 1e-8)
    assert torch.equal(p, torch.ones(5)) and torch.equal(m1, torch.zeros(5))


# --------------------------------------------------------- K3: scatter-add


def test_scatter_add_plain_matches_pallas_interpret():
    rs = np.random.RandomState(3)
    v, d, n = 1024, 128, 64
    w = np.zeros((v, d), np.float32)
    ids = rs.randint(0, v, n).astype(np.int32)
    ids[:6] = [5, 5, 5, v, -1, v - 1]          # duplicates, out of range
    rows = rs.randn(n, d).astype(np.float32)
    ref = pallas_scatter_add_rows(jnp.asarray(w), jnp.asarray(ids), jnp.asarray(rows),
                                  interpret=True)
    got = scatter_add_rows(_t(w), _t(ids), _t(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SCATTER_ATOL, rtol=0)
    np.testing.assert_allclose(got[5].numpy(), rows[:3].sum(0), atol=SCATTER_ATOL, rtol=0)
    # -1 does not wrap onto the last row
    np.testing.assert_allclose(got[v - 1].numpy(), rows[ids == v - 1].sum(0),
                               atol=SCATTER_ATOL, rtol=0)


def test_gather_rows_gradient_is_the_scatter_add():
    rs = np.random.RandomState(4)
    w = _t(rs.randn(10, 4).astype(np.float32)).requires_grad_(True)
    ids = _t(np.array([1, 1, 9, 10, -1, 3], np.int32))
    g = _t(rs.randn(6, 4).astype(np.float32))
    out = GatherRows.apply(w, ids)
    assert not out[3].any() and not out[4].any()
    (dw,) = torch.autograd.grad(out, w, g)
    torch.testing.assert_close(dw, scatter_add_rows(w.detach(), ids, g), rtol=0, atol=0)


# ---------------------------------------------------- K1: flash backward


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_matches_jax_vjp(d, causal):
    rs = np.random.RandomState(10 * d + causal)
    b, h, t = 2, 2, 64
    q, k, v, g = (rs.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    lens = np.array([0, 37], np.int32)                  # one row with no valid key

    def jax_fn(q, k, v):
        return pallas_flash(q, k, v, kv_lens=jnp.asarray(lens), causal=causal,
                            block_q=32, block_k=32, use_pallas=not causal,
                            interpret=not causal)

    out_ref, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    leaves = [_t(a.reshape(b * h, t, d)).requires_grad_(True) for a in (q, k, v)]
    out = FlashAttention.apply(*leaves, _t(np.repeat(lens, h)), causal, d ** -0.5)
    grads = torch.autograd.grad(out, leaves, _t(g.reshape(b * h, t, d)))
    np.testing.assert_allclose(out.detach().numpy().reshape(b, h, t, d), np.asarray(out_ref),
                               atol=FLASH_GRAD_ATOL, rtol=0)
    for got, ref in zip(grads, refs):
        got = got.numpy().reshape(b, h, t, d)
        np.testing.assert_allclose(got, np.asarray(ref), atol=FLASH_GRAD_ATOL, rtol=0)
        assert not got[0].any()      # the keyless row leaks nothing into dq, dk, dv
