"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(the caller runs ``jax.device_get``; this module imports no jax) and
returns the port's tree of tensors with the same names and shapes.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.params import tree_map


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                   # owned, writable, C-contiguous copy
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; the bits move as
        # int16 and are reinterpreted, which is exact
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested dict of numpy arrays -> the same tree of tensors on ``device``;
    floating leaves are cast to ``dtype`` when it is given."""
    def one(a):
        t = _tensor(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return tree_map(one, tree)
