"""Ring attention: context parallelism with K/V blocks rotating around
the ``seq`` axis of the mesh (Liu et al. 2023 style), the JAX package's
``parallel/ring_attention.py`` on DTensor and ``_collectives.ppermute``.

The sequence is sharded over the ``seq`` mesh axis; each rank keeps its
local Q block and receives each K/V block once around the ring, combining
the partial results with the online-softmax algebra of the flash kernel,
so a rank holds O(T/n · d) of keys and values.  ``ring_attention`` takes
the global [B, H, T, D] DTensors, runs ``_ring_attn_local`` on the local
blocks (``layout.on_local``, ``local_map``: the counterpart of the JAX
package's ``shard_map``) and returns the output on the same placements.
"""
from __future__ import annotations

import math

import torch

from ._collectives import axis_index, axis_size, ppermute

NEG_INF = -1e30


def _ring_attn_local(q, k, v, mesh, axis_name: str, causal: bool, sm_scale: float):
    """Per-rank body: q, k, v are LOCAL blocks [B, H, Tl, D]; k and v go
    around the ring n times."""
    n = axis_size(mesh, axis_name)
    my = axis_index(mesh, axis_name)
    b, h, tl, d = q.shape
    qf = q.float() * sm_scale
    q_pos = my * tl + torch.arange(tl, device=q.device)
    acc = torch.zeros((b, h, tl, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=q.device)
    perm = [(j, (j + 1) % n) for j in range(n)]
    k_cur, v_cur = k, v
    for i in range(n):
        # the K/V block held now came from rank (my - i) mod n
        src = (my - i) % n
        k_pos = src * tl + torch.arange(tl, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur.float())
        if causal:
            s = torch.where(q_pos[None, None, :, None] >= k_pos[None, None, None, :], s,
                            torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_cur.float())
        m = m_new
        if i + 1 < n:
            # one hop around the ring (the JAX scan's last rotation returns
            # every block home unused)
            k_cur = ppermute(k_cur, mesh, axis_name, perm)
            v_cur = ppermute(v_cur, mesh, axis_name, perm)
    l = torch.clamp(l, min=1e-20)
    return (acc / l[..., None]).to(q.dtype)


def ring_attention(q, k, v, mesh, seq_axis: str = "seq", batch_axis: str = "data",
                   causal: bool = False, sm_scale: float = None):
    """q, k, v: [B, H, T, D] DTensors over ``mesh`` (T divisible by the
    ``seq`` axis size, B by the ``batch_axis`` size when the mesh has it);
    returns [B, H, T, D] sharded as ``(batch_axis, None, seq_axis, None)``."""
    from .layout import as_placements, on_local
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    spec = [batch_axis if batch_axis in mesh.shape else None, None, seq_axis, None]
    pl = as_placements(spec, mesh)

    def body(ql, kl, vl):
        return _ring_attn_local(ql, kl, vl, mesh, seq_axis, causal, sm_scale)

    return on_local(mesh, body, (q, k, v), (pl, pl, pl), pl)
