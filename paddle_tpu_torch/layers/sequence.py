"""Attention layers: ``flash_attention`` and ``multi_head_attention``."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["flash_attention", "multi_head_attention"]


def flash_attention(q, k, v, num_heads=1, causal=False, use_ring=False,
                    ring_seq_axis="seq", ring_batch_axis="data", name=None):
    """Fused blockwise attention.  q/k/v: [N, T, H*D].  Ragged keys are
    masked by k's @SEQ_LEN lengths.  The ring attrs are recorded for
    ProgramDesc parity with the JAX package; the port runs on one device,
    where the JAX package also takes the local kernel."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_tmp_variable("float32")
    helper.append_op("flash_attention", inputs={"Q": q, "K": k, "V": v},
                     outputs={"Out": out},
                     attrs={"num_heads": num_heads, "causal": causal,
                            "use_ring": use_ring,
                            "ring_seq_axis": ring_seq_axis,
                            "ring_batch_axis": ring_batch_axis})
    return out


def multi_head_attention(queries, keys, values, d_model, n_head=1,
                         causal=False, dropout_rate=0.0, is_test=False,
                         use_ring_attention=False, name=None):
    """q/k/v projections + flash attention + output projection, each
    projection with its own bias-free weight."""
    from . import nn

    def proj_attr(suffix):
        if name is None:
            return None
        return ParamAttr(name=f"{name}_{suffix}.w")

    q = nn.fc(input=queries, size=d_model, num_flatten_dims=2,
              bias_attr=False, param_attr=proj_attr("q"))
    k = nn.fc(input=keys, size=d_model, num_flatten_dims=2, bias_attr=False,
              param_attr=proj_attr("k"))
    v = nn.fc(input=values, size=d_model, num_flatten_dims=2,
              bias_attr=False, param_attr=proj_attr("v"))
    ctx_out = flash_attention(q, k, v, num_heads=n_head, causal=causal,
                              use_ring=use_ring_attention)
    if dropout_rate:
        ctx_out = nn.dropout(ctx_out, dropout_prob=dropout_rate,
                             is_test=is_test)
    return nn.fc(input=ctx_out, size=d_model, num_flatten_dims=2,
                 bias_attr=False, param_attr=proj_attr("out"))
