from . import control_flow, extras, io, learning_rate_scheduler, nn, sequence, tensor
from .math_op_patch import monkey_patch_variable
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .pipeline import PipelinedStages  # noqa: F401

monkey_patch_variable()
