"""Carry parameters across from the JAX package (or any numpy source).

Both packages name parameters the same way when they build the same model
under ``unique_name.guard()`` (as their Inferencers do), so a dict of the
JAX scope's values, each through ``np.asarray``, loads straight into the
port's scope.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.scope import Scope


def params_from_numpy(arrays: Dict[str, np.ndarray], scope: Scope,
                      device) -> None:
    """Set each ``name -> array`` in ``scope`` as a tensor on ``device``
    (a ``torch.device`` or a string such as ``"cuda:0"``)."""
    device = torch.device(device)
    for name, a in arrays.items():
        scope.set_var(name, torch.from_numpy(np.array(a, copy=True)).to(device))
