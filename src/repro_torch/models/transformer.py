"""Model assembly for serving (port of the serving entries of
``repro/models/transformer.py`` and the dense part of
``repro/models/registry.py``).

``prefill`` runs whole right-padded prompts and hands their rope'd (k, v)
to the paged pool; ``forward(mode="decode", page=...)`` advances every slot
by one token against that pool.  The reference scans stacked layer
parameters (``registry.run_stack``); PyTorch runs eagerly, so here the
layer plan is a Python loop over the same stacked tensors.
"""
from __future__ import annotations

import math

import torch

from ..config import Family, ModelConfig
from ..core.linear3d import embed_lookup, plinear
from ..core.params import tree_map
from ..core.topology import Dirs, Layout
from . import blocks as B


def entry_dirs() -> Dirs:
    return Dirs("y", "z")


def serve_cache_mode(cfg: ModelConfig) -> str:
    """'paged' when the reference serves this config through the
    block-table KV pool (dense / MLA attention stacks), else 'state'
    (recurrent state or modality frontends) — ``registry.serve_cache_mode``."""
    return "paged" if cfg.family in (Family.DENSE, Family.MOE) else "state"


def embed(layout: Layout, cfg: ModelConfig, dirs: Dirs, params, tokens,
          decode: bool = False):
    x = embed_lookup(layout, dirs, tokens, params["embed"], decode=decode)
    if cfg.emb_scale_sqrt_d:
        x = x * math.sqrt(cfg.d_model)
    return x


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def run_stack(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, params,
              positions, *, mode: str, cache=None, page=None,
              collect_kv: bool = False):
    """The dense layer plan, one layer after another (the reference's
    ``run_stack`` scan, ``registry.py:660-716``).  Returns (x, new_cache):
    decode -> {"dense": {"k", "v", "pos"}} stacked per layer; prefill with
    ``collect_kv`` -> {"dense": (k, v)} stacked (n_layers, B, S, nkv, d)."""
    if cfg.family != Family.DENSE:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family.value!r} is not ported yet")
    decode = mode == "decode"
    stacked = params["stack"]["dense"]
    outs = []
    for i in range(cfg.n_layers):
        c = _layer(cache["dense"], i) if decode else None
        x, nc = B.dense_block_apply(layout, cfg, dirs, x, _layer(stacked, i),
                                    positions, decode=decode, cache=c,
                                    return_kv=collect_kv, page=page)
        if nc is not None:
            outs.append(nc)
    if not outs:
        return x, {}
    if decode:
        return x, {"dense": {k: torch.stack([o[k] for o in outs])
                             for k in outs[0]}}
    return x, {"dense": (torch.stack([o[0] for o in outs]),
                         torch.stack([o[1] for o in outs]))}


def forward(cfg: ModelConfig, layout: Layout, params, batch, *, mode: str,
            cache=None, page=None):
    """mode='decode' -> (logits (B, V), new entries) against the paged pool
    (reference ``transformer.py:177-230`` with ``page=...``): ``batch`` is
    {"token": (B, 1), "pos": (B,) int32}, ``cache`` the pool tree (leaves
    (n_layers, phys, ...)), read-only here; the returned entries are
    written back by ``kvcache.scatter_step``."""
    if mode != "decode":
        raise NotImplementedError(
            f"forward(mode={mode!r}): prompts go through prefill(); the "
            "train forward arrives with the training slice")
    if page is None:
        raise ValueError("decode runs against the paged pool only: pass "
                         "page=PageInfo(...)")
    dirs = entry_dirs()
    x = embed(layout, cfg, dirs, params, batch["token"], decode=True)
    positions = batch["pos"][:, None]                      # (B, 1)
    x, new_cache = run_stack(layout, cfg, dirs, x, params, positions,
                             mode="decode", cache=cache, page=page)
    x = B.apply_norm(cfg, x, params["ln_f"])
    logits, _ = plinear(layout, dirs, x, params["head"], kind="first",
                        decode=True)
    return logits[:, 0], new_cache


def prefill(cfg: ModelConfig, layout: Layout, params, batch):
    """Batched whole-prompt prefill (reference ``transformer.py:323-356``).

    ``batch``: {"tokens": (B, S) right-padded prompts, "length": (B,) true
    prompt lengths (0 marks an inactive row)}.  Returns ``(logits, kv)``:
    per-row logits at the last *valid* position (B, V), and the collected
    rope'd (k, v) per layer for ``pack_prefill_cache``."""
    dirs = entry_dirs()
    tokens = batch["tokens"]
    x = embed(layout, cfg, dirs, params, tokens)
    b, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(b, S)
    x, kv = run_stack(layout, cfg, dirs, x, params, positions,
                      mode="prefill", collect_kv=True)
    x = B.apply_norm(cfg, x, params["ln_f"])
    idx = (batch["length"].long() - 1).clamp(0, S - 1)
    last = x[torch.arange(b, device=x.device), idx][:, None]    # (B, 1, H)
    logits, _ = plinear(layout, dirs, last, params["head"], kind="first",
                        decode=True)
    return logits[:, 0], kv


def pack_prefill_cache(cfg: ModelConfig, collected, pos2d):
    """Shape the kv collected by ``prefill`` into pool updates
    (reference ``registry.py:570-593``): {kind: {"k", "v", "pos"}} with
    leaves (n_layers, B, S, ...); ``pos2d`` (B, S) holds the logical
    positions, -1 on padding lanes."""
    out = {}
    for kname, (k, v) in collected.items():
        pos = pos2d[None].to(torch.int32).expand(k.shape[0], *pos2d.shape)
        out[kname] = {"k": k, "v": v, "pos": pos}
    return out
