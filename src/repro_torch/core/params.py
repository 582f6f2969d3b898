"""The parameter tree of the port: shapes, init rules, and a native init.

``abstract_params(cfg)`` returns the same nested names and shapes as the
reference's ``transformer.abstract_params`` at one device and pp = 1 for
the dense family:

    embed                                                   (vocab, d)
    stack.dense.{ln1.g, attn.{wq, wk, wv, wo}, ln2.g,
                 mlp.{w_up, w_gate, w_down}}                (L, ...) stacked
    ln_f.g                                                  (d,)
    head                                                    (d, vocab)

(plus ``ln*.b`` for LayerNorm configs, ``attn.{q,k}_norm`` with qk-norm, and
no ``w_gate`` for a plain GELU MLP).  Weights keep JAX's (in, out) layout,
so a tree converted by ``convert.params_from_jax`` needs no transposes.

``init_params`` follows the reference's init rules
(``repro/core/params.py:44-66``) in distribution only: its random numbers
come from a ``torch.Generator``, not from ``jax.random``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from ..config import Family, ModelConfig


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    init: str = "fan_in"        # fan_in | zeros | ones | embed
    fan_axis: int = -2          # contraction axis for fan_in scaling
    scale: float = 1.0


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _norm(cfg: ModelConfig, d: int):
    p = {"g": Param((d,), init="ones")}
    if cfg.norm == "layernorm":
        p["b"] = Param((d,), init="zeros")
    return p


def abstract_params(cfg: ModelConfig):
    """Param tree of a dense-family model (see the module docstring)."""
    if cfg.family != Family.DENSE:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family.value!r} is not ported yet; "
            "the port serves the dense family")
    d, nh, nkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    attn = {"wq": Param((d, nh * dh)), "wk": Param((d, nkv * dh)),
            "wv": Param((d, nkv * dh)), "wo": Param((nh * dh, d))}
    if cfg.qk_norm:
        attn["q_norm"] = Param((dh,), init="ones")
        attn["k_norm"] = Param((dh,), init="ones")
    mlp = {"w_up": Param((d, cfg.d_ff)), "w_down": Param((cfg.d_ff, d))}
    if cfg.act in ("silu", "gelu"):
        mlp["w_gate"] = Param((d, cfg.d_ff))
    block = {"ln1": _norm(cfg, d), "attn": attn, "ln2": _norm(cfg, d),
             "mlp": mlp}
    stacked = tree_map(lambda p: dataclasses.replace(
        p, shape=(cfg.n_layers, *p.shape)), block)
    return {"embed": Param((cfg.vocab, d), init="embed"),
            "stack": {"dense": stacked},
            "ln_f": _norm(cfg, d),
            "head": Param((d, cfg.vocab))}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, dtype: torch.dtype = torch.bfloat16):
    """Random weights for ``abstract_params(cfg)`` drawn from ``generator``
    (which must live on ``device``): N(0, scale) for embeddings,
    N(0, scale / sqrt(fan_in)) for weights, ones and zeros for norms."""
    def one(p: Param) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        std = p.scale
        if p.init == "fan_in":
            std = p.scale / math.sqrt(max(p.shape[p.fan_axis], 1))
        x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)
    return tree_map(one, abstract_params(cfg))
