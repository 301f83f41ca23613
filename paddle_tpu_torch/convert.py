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
    (a ``torch.device`` or a string such as ``"cuda:0"``); a bfloat16
    array (``ml_dtypes``) becomes a bfloat16 tensor."""
    device = torch.device(device)
    for name, a in arrays.items():
        a = np.array(a, copy=True)
        if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, the JAX scope's
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        scope.set_var(name, t.to(device))
