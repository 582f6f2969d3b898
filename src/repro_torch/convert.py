"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(the caller runs ``jax.device_get``; this module imports no jax) and
returns the port's tree of tensors with the same names and shapes.  A cast
to the model's dtype leaves float32 the leaves the reference keeps in
float32 (the Mamba2 ``dt_bias``, ``A_log`` and ``D``), as the port's own
``init_params`` does.  With a ``layout`` each leaf is the rank's shard of
the global array (``core.params.shard`` under the leaf's spec).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.params import shard, tree_map
from .models.transformer import abstract_params


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                   # owned, writable, C-contiguous copy
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; the bits move as
        # int16 and are reinterpreted, which is exact
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device, dtype: Optional[torch.dtype] = None,
                    cfg=None, layout=None):
    """Nested dict of numpy arrays -> the same tree of tensors on ``device``.
    With ``dtype``, floating leaves are cast to it, except those whose
    Param in ``abstract_params(cfg)`` pins its own dtype; with ``layout``,
    each leaf is cut to the rank's shard.  Either needs ``cfg`` (the port's
    ModelConfig)."""
    if dtype is None and layout is None:
        return tree_map(lambda a: _tensor(a).to(device), tree)
    if cfg is None:
        raise ValueError("params_from_jax: a cast to a dtype or a layout "
                         "needs the model's cfg (the leaves' dtypes and "
                         "specs)")
    out = {}

    def walk(src, spec, dst):
        for k, v in src.items():
            if isinstance(v, dict):
                dst[k] = {}
                walk(v, spec[k], dst[k])
                continue
            t = _tensor(v)
            if layout is not None:
                t = shard(t, spec[k].spec, layout)
            if dtype is not None and t.is_floating_point():
                t = t.to(spec[k].dtype or dtype)
            dst[k] = t.to(device)
    walk(tree, abstract_params(cfg, layout), out)
    return out
