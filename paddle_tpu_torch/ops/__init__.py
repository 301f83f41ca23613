"""Op lowerings; importing this package registers every op type."""
from . import (activation_ops, attention_ops, math_ops, nn_ops,  # noqa: F401
               random_ops, tensor_ops)
