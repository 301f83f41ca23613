"""Serving: dynamic micro-batching (:class:`BatchingEngine`,
:class:`ServingSession`), token-level continuous batching for
autoregressive decode (:class:`DecodeEngine`), and the fleet that hosts
many models behind admission, hot swap, circuit breakers and HTTP
(:class:`EngineManager`, :class:`FrontDoor`, :class:`FleetHTTPServer`).
The names are the JAX package's ``serving`` exports."""
from .decode import DECODE_SCOPE, DecodeEngine, DecodeResult, seq_len_buckets  # noqa: F401
from .engine import (BatchingEngine, BatchSlice, RequestTimeout,  # noqa: F401
                     ServingClosed, ServingError, ServingNonFinite,
                     ServingOverloaded, pow2_buckets)
from .fleet import FLEET_SCOPE, EngineManager, ModelRejected, SwapFailed  # noqa: F401
from .frontdoor import CircuitBreaker, CircuitOpen, FleetHTTPServer, FrontDoor  # noqa: F401
from .session import ServingSession  # noqa: F401

__all__ = [
    "BatchingEngine", "ServingSession", "ServingError",
    "ServingOverloaded", "RequestTimeout", "ServingNonFinite",
    "ServingClosed", "pow2_buckets",
    "EngineManager", "ModelRejected", "SwapFailed", "FLEET_SCOPE",
    "FrontDoor", "CircuitBreaker", "CircuitOpen", "FleetHTTPServer",
    "DecodeEngine", "DecodeResult", "DECODE_SCOPE", "seq_len_buckets",
]
