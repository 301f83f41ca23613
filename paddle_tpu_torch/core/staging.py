"""Non-blocking fetches.

``Executor.run(..., sync=False)`` returns :class:`FetchHandle`\\ s: each holds
the fetched tensor and a CUDA event recorded on the stream right after the
step was enqueued, and copies to host numpy on first read (a bf16 value as
float32: numpy has no bfloat16).  Until then the step may still be running
on the card, so the caller (the serving dispatcher) can enqueue the next
batch meanwhile.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .dtypes import to_numpy


class FetchTimeoutError(TimeoutError):
    """A bounded :meth:`FetchHandle.result` wait expired before the device
    produced the value."""


class FetchHandle:
    """A fetched tensor that materializes to numpy on first access."""

    __slots__ = ("_val", "_event", "_np")

    def __init__(self, val: torch.Tensor, event: Optional[torch.cuda.Event] = None):
        self._val = val
        self._event = event
        self._np = None

    def ready(self) -> bool:
        return self._np is not None or self._event is None or self._event.query()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The host value, waiting at most ``timeout`` seconds for the
        device (``None`` blocks).  Raises :class:`FetchTimeoutError` instead
        of hanging on a wedged device queue."""
        if timeout is not None and not self.ready():
            deadline = time.monotonic() + timeout
            pause = 5e-5
            while not self.ready():
                if time.monotonic() >= deadline:
                    raise FetchTimeoutError(
                        f"fetch not ready after {timeout:.3f}s (device queue "
                        f"wedged or overloaded)")
                time.sleep(pause)
                pause = min(pause * 2, 2e-3)
        return self.numpy()

    def numpy(self) -> np.ndarray:
        if self._np is None:
            if self._event is not None:
                self._event.synchronize()
            self._np = to_numpy(self._val)
        return self._np

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return np.asarray(a, dtype=dtype) if dtype is not None else a

    @property
    def shape(self):
        return tuple(self._val.shape)

    @property
    def dtype(self):
        return self._val.dtype

    def __repr__(self):
        state = "ready" if self.ready() else "pending"
        return f"FetchHandle(shape={self.shape}, dtype={self.dtype}, {state})"
