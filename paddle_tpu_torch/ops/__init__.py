"""Op lowerings; importing this package registers every op type."""
from . import (activation_ops, attention_ops, beam_search_ops, fused_ce,  # noqa: F401
               kernel_ops, control_flow_ops, embedding_ops, io_ops, math_ops, metric_ops, misc_ops, nn_ops,
               optimizer_ops, quantize_ops, random_ops, rnn_ops, sequence_ops, sparse_ops,
               tensor_ops)
from . import shape_infer  # noqa: F401  (last: the default rules fill gaps only)
