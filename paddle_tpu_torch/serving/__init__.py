from .engine import (BatchingEngine, BatchSlice, RequestTimeout,  # noqa: F401
                     ServingClosed, ServingError, ServingNonFinite,
                     ServingOverloaded, pow2_buckets)
from .session import ServingSession  # noqa: F401
