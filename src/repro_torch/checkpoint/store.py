"""Checkpoints in the reference's on-disk format (port of
``repro/checkpoint/store.py``), so that a checkpoint moves between the JAX
package and the port in either direction.

A step is a directory ``step_{step:08d}/`` holding one global ``.npy`` per
leaf and an ``index.json``: ``step``, ``leaves`` (each leaf's ``file``,
``shape`` and ``dtype``), ``meta`` (the mesh sizes and the ZeRO stage;
the port runs at one device with ZeRO stage 0) and ``extra``.  bf16 is
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

``restore`` fills a template: a tree of tensors, of ``Param``s (then the
leaves land on ``device`` in the dtype each Param pins, else ``dtype``)
or of ints.  A restored leaf takes its template's dtype and device, so the
f32 Mamba2 leaves stay f32 in a bf16 model.  A missing leaf and a
global-shape mismatch fail loudly, with the reference's messages.  Every
family's tree goes through the same walk: whisper's ``encoder`` subtree
and its decoder blocks' ``ln_x`` and ``xattn`` are leaves like any other.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.params import Param
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
         layout: Optional[Layout] = None) -> str:
    """Write ``params`` (and ``opt_state``) as step ``step``; returns the
    step's directory (reference ``store.py:41-68``)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    index: Dict[str, Any] = {"step": step, "leaves": {}}
    if layout is not None:
        index["meta"] = {"mesh": {k: int(v) for k, v in layout.sizes.items()},
                         "zero_stage": 0}
    trees = {"params": params}
    if opt_state is not None:
        trees["opt"] = opt_state
    for prefix, tree in trees.items():
        for key, leaf in _leaf_paths(tree):
            arr, dtype = _to_numpy(leaf)
            fname = f"{prefix}__{key}.npy".replace("/", "__")
            np.save(os.path.join(d, fname), arr)
            index["leaves"][f"{prefix}/{key}"] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
    if extra:
        index["extra"] = extra
    with open(os.path.join(d, "index.json"), "w") as f:
        json.dump(index, f, indent=1)
    return d


def latest_step(ckpt_dir: str) -> int:
    """The highest saved step under ``ckpt_dir``, -1 when there is none."""
    if not os.path.isdir(ckpt_dir):
        return -1
    steps = [int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
             if n.startswith("step_")]
    return max(steps) if steps else -1


def restore(ckpt_dir: str, step: int, params_template, opt_template=None,
            *, device=None, dtype: torch.dtype = torch.bfloat16):
    """(params, opt_state or None, extra) of step ``step``, in the
    templates' structure (reference ``store.py:79-124``, whose layout
    argument places each leaf on its shards; one device needs none)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)

    def load_tree(prefix, template):
        def one(key, leaf):
            entry = index["leaves"].get(f"{prefix}/{key}")
            if entry is None:
                raise KeyError(f"checkpoint missing {prefix}/{key}")
            arr = np.load(os.path.join(d, entry["file"]))
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
            if entry["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if isinstance(leaf, Param):
                return t.to(device=device, dtype=leaf.dtype or dtype)
            return t.to(device=leaf.device, dtype=leaf.dtype)
        return _rebuild(template, one)

    params = load_tree("params", params_template)
    opt = load_tree("opt", opt_template) if opt_template is not None \
        else None
    return params, opt, index.get("extra", {})
