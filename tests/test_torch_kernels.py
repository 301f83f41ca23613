"""The PyTorch/CUDA port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode.  The causal flash case
goes to the JAX package's composed reference (``_flash_fwd_xla``) instead:
interpret mode cannot lower the Pallas kernel's causal block skip (it reads
``program_id`` outside ``pl.when``) on this JAX version.  Inputs come from a
numpy seed and go to both as numpy arrays.  The CUDA kernels themselves
are tested against these plain versions in test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.embedding import gather_rows as pallas_gather_rows
from paddle_tpu.ops.pallas.flash_attention import _flash_fwd_pallas, _flash_fwd_xla
from paddle_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from paddle_tpu_torch.ops.cuda.embedding import gather_rows
from paddle_tpu_torch.ops.cuda.flash_attention import flash_attn_fwd, flash_attn_fwd_plain

FLASH_ATOL = 1e-5   # float32; composed vs interpret differ by ~1.2e-6 here


def _qkv(rs, *shape):
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


# ------------------------------------------------------------ K1: flash


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_flash(d, causal):
    rs = np.random.RandomState(d + causal)
    b, h, t = 2, 2, 64
    q, k, v = _qkv(rs, b, h, t, d)
    lens = np.array([0, 37], np.int32)      # one row with no valid key
    ref = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  kv_lens=jnp.asarray(lens), causal=causal,
                                  block_q=32, block_k=32, use_pallas=not causal,
                                  interpret=not causal))
    out, lse = flash_attn_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), kv_lens=torch.from_numpy(lens),
                              causal=causal)
    assert out.shape == (b, h, t, d) and lse.shape == (b, h, t)
    np.testing.assert_allclose(out.numpy(), ref, atol=FLASH_ATOL, rtol=0)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # exact zeros


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_lse_matches_jax_flash(causal):
    """The saved log-sum-exp, [B*H, T] float32, per-(batch*head) lengths."""
    rs = np.random.RandomState(3)
    bh, t, d = 4, 64, 16
    q, k, v = _qkv(rs, bh, t, d)
    lens = np.array([64, 0, 5, 40], np.int32)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
            causal, 0.25)
    _, ref_lse = (_flash_fwd_xla(*args, 32) if causal
                  else _flash_fwd_pallas(*args, 32, 32, interpret=True))
    out, lse = flash_attn_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), kv_lens=torch.from_numpy(lens),
                              causal=causal, sm_scale=0.25)
    assert lse.shape == (bh, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=FLASH_ATOL, rtol=0)


def test_flash_plain_ragged_tiles_and_no_lengths():
    """T not a multiple of the key tile, cross-attention Tq != Tk, no
    kv_lens: the plain loop against one dense softmax."""
    rs = np.random.RandomState(4)
    q = rs.randn(3, 20, 32).astype(np.float32)
    k, v = (rs.randn(3, 45, 32).astype(np.float32) for _ in range(2))
    out, _ = flash_attn_fwd_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), None, False, 0.2, block_k=16)
    s = np.einsum("bqd,bkd->bqk", q * 0.2, k)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out.numpy(), ref, atol=FLASH_ATOL, rtol=0)


def test_flash_wrapper_rejects_bad_arguments():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="kv_lens"):
        flash_attn_fwd(q, q, q, kv_lens=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="bad shapes"):
        flash_attn_fwd(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))


# ------------------------------------------------------------ K2: gather


def test_gather_plain_matches_pallas_interpret_bit_equal():
    rs = np.random.RandomState(5)
    w = rs.randn(64, 128).astype(np.float32)
    ids = rs.randint(0, 64, 16).astype(np.int32)
    ids[:4] = [-1, 64, 67, 63]                  # out of range -> zero rows
    ref = np.asarray(pallas_gather_rows(jnp.asarray(w), jnp.asarray(ids),
                                        interpret=True))
    got = gather_rows(torch.from_numpy(w), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[:3].any()


def test_gather_wrapper_rejects_bad_arguments():
    w = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="int32"):
        gather_rows(w, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="w \\[V, D\\]"):
        gather_rows(w[None], torch.zeros(3, dtype=torch.int32))
