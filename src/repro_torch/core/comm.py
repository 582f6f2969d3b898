"""The 3-D islands' collectives over a named mesh axis (the port's stand-in
for ``lax.all_gather`` / ``lax.psum`` / ``lax.psum_scatter`` /
``lax.axis_index`` inside the reference's ``shard_map`` islands).

``axis`` is one name of ``topology.AXES`` or a tuple of them.  At axis size
1 each collective is the identity (the tiled all-gather and reduce-scatter
of one shard are that shard).  Above size 1 each one raises until the
multi-rank slice builds the ``torch.distributed`` groups: a wrong answer is
never returned silently.
"""
from __future__ import annotations

import torch

from .plan import MULTI_RANK_TODO
from .topology import Layout


def _check(layout: Layout, axis, op: str):
    n = layout.size(axis)
    if n != 1:
        raise NotImplementedError(f"{op} over {axis!r} of size {n}: "
                                  f"{MULTI_RANK_TODO}")


def all_gather(layout: Layout, x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """Tiled all-gather of ``x`` along tensor dim ``dim`` over ``axis``."""
    _check(layout, axis, "all_gather")
    return x


def psum(layout: Layout, x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of ``x`` over ``axis``."""
    _check(layout, axis, "psum")
    return x


def psum_scatter(layout: Layout, x: torch.Tensor, axis,
                 dim: int) -> torch.Tensor:
    """Tiled reduce-scatter of ``x`` along tensor dim ``dim`` over ``axis``."""
    _check(layout, axis, "psum_scatter")
    return x


def axis_index(layout: Layout, axis) -> int:
    """This rank's coordinate on ``axis``."""
    _check(layout, axis, "axis_index")
    return 0
