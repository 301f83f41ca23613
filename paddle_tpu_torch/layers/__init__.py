from . import learning_rate_scheduler, nn, sequence, tensor
from .math_op_patch import monkey_patch_variable
from .learning_rate_scheduler import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

monkey_patch_variable()
