"""Checkpoints in the reference's on-disk format (port of
``repro/checkpoint/store.py``), so that a checkpoint moves between the JAX
package and the port in either direction.

A step is a directory ``step_{step:08d}/`` holding one global ``.npy`` per
leaf and an ``index.json``: ``step``, ``leaves`` (each leaf's ``file``,
``shape`` and ``dtype``), ``meta`` (the mesh sizes and the ZeRO stage in
force, ``Layout.effective_zero_stage()``) and ``extra``.  bf16 is
stored as its uint16 bits and restored by view, which is exact.

A leaf's key is the one ``jax.tree_util.tree_flatten_with_path`` gives it
with ``[^\\w.]`` removed and the parts joined by ``/``: a dict key gives its
plain name, a NamedTuple's field its name after a dot.  So the port's
``OptState`` (``step``, ``m``, ``v``) gives ``opt/.step``,
``opt/.m/<param path>`` and ``opt/.v/<param path>``, as the reference's
does; the files are ``params__stack__mlstm__w_q.npy``,
``opt__.m__stack__mlstm__w_q.npy`` and so on.  Leaves are written in
JAX's order (dict keys sorted, fields in order), so the same tree saved
by either package gives the same files and the same ``index.json``.
The optimizer step, a host ``int`` in the port, is written as an int32
0-d array and read back as an ``int``.

What goes to disk is always each leaf's global value (the reference's
resharding contract, ``store.py:1-17``).  Above one device ``save`` takes
the trees of Params that place the values (``abstract``: the model's;
``opt_abstract``: ``optim.opt_state_abstract``'s, the moments on their
ZeRO specs) and gathers each leaf from the ranks' shards onto rank 0
(``core.params.gather``; every rank calls it), which writes the files.
Adafactor's state (``OptState(step, None, v)``, a factored leaf's ``v`` a
dict of ``row`` and ``col``) gives the reference's keys,
``opt/.v/<path>/row``.

``restore`` fills a template: a tree of tensors, of ``Param``s (then the
leaves land on ``device`` in the dtype each Param pins, else ``dtype``,
and with a ``layout`` each is the rank's block under the Param's spec, so
that a dp 2 / ZeRO 1 checkpoint restores onto dp 4 or one device) or of
ints.  At pp > 1 the ``stack`` leaves are the global ``(pp, slots, ...)``
stage slabs, as in the reference; a checkpoint saved at another pp (its
``meta``, none for a one-device save) restores when ``cfg`` is given:
each ``stack`` leaf, of the parameters and of the optimizer's moments,
is re-cut by ``models.registry.repartition_stack`` before it is cut to
the rank's block (the reference leaves that re-cut to its caller,
``registry.py:840-848``).  A restored leaf takes its template's dtype and device, so the
f32 Mamba2 leaves stay f32 in a bf16 model.  A missing leaf and a
global-shape mismatch fail loudly, with the reference's messages.  Every
family's tree goes through the same walk: whisper's ``encoder`` subtree
and its decoder blocks' ``ln_x`` and ``xattn`` are leaves like any other.
"""
from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.params import Param, gather, shard
from ..core.topology import Layout


def _part(key) -> str:
    return re.sub(r"[^\w.]", "", str(key))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaf_paths(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in JAX's flattening order; None is an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (_part(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _leaf_paths(getattr(tree, name),
                                   path + (f".{name}",))
    else:
        yield "/".join(path), tree


def _rebuild(tree, fn: Callable[[str, Any], Any],
             path: Tuple[str, ...] = ()):
    """The template's structure with ``fn(key, leaf)`` at every leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (_part(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, name), fn,
                                     path + (f".{name}",))
                            for name in tree._fields))
    return fn("/".join(path), tree)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name): bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, params, opt_state=None, extra=None,
         layout: Optional[Layout] = None, abstract=None,
         opt_abstract=None) -> str:
    """Write ``params`` (and ``opt_state``) as step ``step``; returns the
    step's directory (reference ``store.py:41-68``).  Above one device
    every rank calls it with its shards and the trees of Params that place
    them (``abstract``, ``opt_abstract``); rank 0 writes."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    multi = layout is not None and layout.n_devices > 1
    if multi and (abstract is None
                  or (opt_state is not None and opt_abstract is None)):
        raise ValueError("save above one device needs the trees of Params "
                         "(abstract, opt_abstract) that place the shards")
    writer = not multi or layout.rank == 0
    if writer:
        os.makedirs(d, exist_ok=True)
    index: Dict[str, Any] = {"step": step, "leaves": {}}
    if layout is not None:
        index["meta"] = {"mesh": {k: int(v) for k, v in layout.sizes.items()},
                         "zero_stage": layout.effective_zero_stage()}
    trees = {"params": (params, abstract)}
    if opt_state is not None:
        trees["opt"] = (opt_state, opt_abstract)
    for prefix, (tree, specs) in trees.items():
        placed = _leaf_paths(specs) if multi else None
        for key, leaf in _leaf_paths(tree):
            if placed is not None:
                spec = next(placed)[1]
                if isinstance(spec, Param):
                    leaf = gather(leaf, spec.spec, layout)
            if not writer:
                continue
            arr, dtype = _to_numpy(leaf)
            fname = f"{prefix}__{key}.npy".replace("/", "__")
            np.save(os.path.join(d, fname), arr)
            index["leaves"][f"{prefix}/{key}"] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
    if extra:
        index["extra"] = extra
    if writer:
        with open(os.path.join(d, "index.json"), "w") as f:
            json.dump(index, f, indent=1)
    if multi:
        import torch.distributed as dist
        dist.barrier()      # the files are whole before any rank goes on
    return d


def latest_step(ckpt_dir: str) -> int:
    """The highest saved step under ``ckpt_dir``, -1 when there is none."""
    if not os.path.isdir(ckpt_dir):
        return -1
    steps = [int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_")]
    return max(steps) if steps else -1


def _recut(cfg, key: str, arr: np.ndarray, src: int, dst: int):
    """``arr`` re-cut from pp ``src`` to ``dst`` when ``key`` is a leaf of
    the ``stack`` subtree (of the parameters, ``stack/<kind>/...``, or of
    the optimizer's state, ``.m/stack/<kind>/...``); else ``arr``."""
    parts = key.split("/")
    if src == dst or "stack" not in parts[:2]:
        return arr
    from ..models.registry import repartition_stack
    kind = parts[parts.index("stack") + 1]
    return repartition_stack(cfg, {kind: arr}, src, dst)[kind]


def restore(ckpt_dir: str, step: int, params_template, opt_template=None,
            *, device=None, dtype: torch.dtype = torch.bfloat16,
            layout: Optional[Layout] = None, cfg=None):
    """(params, opt_state or None, extra) of step ``step``, in the
    templates' structure (reference ``store.py:79-124``): with ``layout``
    each leaf of a template of Params is the rank's block under its spec
    in that layout, whatever layout saved it; with ``cfg`` too, whatever
    pp saved it (the module docstring)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    src_pp = index.get("meta", {}).get("mesh", {}).get("pp", 1)
    dst_pp = src_pp if layout is None or cfg is None else layout.size("pp")

    def load_tree(prefix, template):
        def one(key, leaf):
            entry = index["leaves"].get(f"{prefix}/{key}")
            if entry is None:
                raise KeyError(f"checkpoint missing {prefix}/{key}")
            # a memory map: a rank reads the pages of its own block
            arr = np.load(os.path.join(d, entry["file"]), mmap_mode="r")
            arr = _recut(cfg, key, arr, src_pp, dst_pp)
            want = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {prefix}/{key}: stored global shape "
                    f"{tuple(arr.shape)} != template {want}. Checkpoints are "
                    "layout-independent (dp/zero resharding changes placement"
                    " only), so a shape mismatch means the model config or "
                    "cube changed, not the parallel plan.")
            if isinstance(leaf, int):
                return int(arr)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")     # a read-only map
                t = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16) if entry["dtype"] == "bfloat16" \
                    else torch.from_numpy(arr)
            block = shard(t, leaf.spec, layout) if (
                isinstance(leaf, Param) and layout is not None) else t
            block = block.clone() if block is t else block   # off the map
            if isinstance(leaf, Param):
                return block.to(device=device, dtype=leaf.dtype or dtype)
            return block.to(device=leaf.device, dtype=leaf.dtype)
        return _rebuild(template, one)

    params = load_tree("params", params_template)
    opt = load_tree("opt", opt_template) if opt_template is not None \
        else None
    return params, opt, index.get("extra", {})
