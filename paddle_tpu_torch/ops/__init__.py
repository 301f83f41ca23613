"""Op lowerings; importing this package registers every op type."""
from . import (activation_ops, attention_ops, fused_ce, math_ops,  # noqa: F401
               nn_ops, optimizer_ops, random_ops, tensor_ops)
