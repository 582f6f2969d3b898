"""Model assembly (port of ``repro/models/transformer.py`` and the dense
part of ``repro/models/registry.py``).

``forward(mode="train")`` returns the loss of a batch of token sequences,
differentiable in every parameter: embedding, the layer plan (each layer
recomputed in the backward when ``cfg.remat``), ``ln_f`` and the chunked
vocab-parallel head and cross-entropy.  ``prefill`` runs whole
right-padded prompts and hands their rope'd (k, v) to the paged pool;
``forward(mode="decode", page=...)`` advances every slot by one token
against that pool.  The reference scans stacked layer parameters
(``registry.run_stack``); PyTorch runs eagerly, so here the layer plan is a
Python loop over one ``torch.unbind`` of each stacked leaf, whose backward
is a single stack (indexing a layer out of a stack would build a full-size
zero gradient per layer).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..config import Family, ModelConfig
from ..core.linear3d import embed_lookup, plinear
from ..core.params import tree_map
from ..core.topology import Dirs, Layout
from . import blocks as B
from .registry import text_labels


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


def _layers(tree, n: int):
    """The n per-layer trees of a stacked tree, one unbind per leaf."""
    parts = tree_map(torch.unbind, tree)
    return [tree_map(lambda t, i=i: t[i], parts) for i in range(n)]


def run_stack(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, params,
              positions, *, mode: str, cache=None, page=None,
              collect_kv: bool = False, remat: bool = False):
    """The dense layer plan, one layer after another (the reference's
    ``run_stack`` scan, ``registry.py:643-716``); with ``remat`` each layer
    is recomputed in the backward (``jax.checkpoint`` of the scan body
    there).  Returns (x, new_cache): decode -> {"dense": {"k", "v", "pos"}}
    stacked per layer; prefill with ``collect_kv`` -> {"dense": (k, v)}
    stacked (n_layers, B, S, nkv, d)."""
    if cfg.family != Family.DENSE:
        raise NotImplementedError(
            f"{cfg.arch}: family {cfg.family.value!r} is not ported yet")
    decode = mode == "decode"
    layers = _layers(params["stack"]["dense"], cfg.n_layers)

    def block(xx, p):
        return B.dense_block_apply(layout, cfg, dirs, xx, p, positions)[0]

    outs = []
    for i, p in enumerate(layers):
        if remat:
            x = checkpoint(block, x, p, use_reentrant=False)
            continue
        c = _layer(cache["dense"], i) if decode else None
        x, nc = B.dense_block_apply(layout, cfg, dirs, x, p, positions,
                                    decode=decode, cache=c,
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


def head_loss_chunks(cfg: ModelConfig, layout: Layout, S: int) -> int:
    """Sequence-chunking factor of the LM head and loss (reference
    ``transformer.py:245-254``): bounds the live (tokens, V) logits to
    about a 32k vocabulary's worth.  The port has no sequence axes."""
    k = min(8, max(1, cfg.vocab // 32000, S // 1024))
    div = layout.size("y") * layout.size("z")
    while k > 1 and (S % k or (S // k) % div):
        k -= 1
    return k


def chunked_head_loss(cfg: ModelConfig, layout: Layout, dirs: Dirs, x,
                      labels, mask, w_head):
    """LM head + vocab-parallel cross entropy, chunked over the sequence
    and recomputed per chunk in the backward (reference
    ``transformer.py:257-291``): tokens go to chunk ``position % K``; the
    running max is detached, as ``stop_gradient`` is there."""
    B_, S = labels.shape
    K = head_loss_chunks(cfg, layout, S)

    def chunk(x_c, lab_c, mask_c, w):
        logits, _ = plinear(layout, dirs, x_c, w, kind="first")
        lf = logits.float()
        m = lf.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
        picked = torch.gather(lf, -1, lab_c[..., None])[..., 0]
        nll = (lse - picked) * mask_c
        return nll.sum(), mask_c.sum()

    c = S // K
    xs = x.reshape(B_, c, K, x.shape[-1])
    labs = labels.reshape(B_, c, K)
    masks = mask.reshape(B_, c, K)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(K):
        t, n = checkpoint(chunk, xs[:, :, i], labs[:, :, i], masks[:, :, i],
                          w_head, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / cnt.clamp_min(1.0)


def forward(cfg: ModelConfig, layout: Layout, params, batch, *, mode: str,
            cache=None, page=None):
    """mode='train' -> (loss, {"xent", "aux"}) for ``batch`` {"tokens":
    (B, S), "labels": (B, S)}, labels < 0 masked out (reference
    ``transformer.py:177-242``).

    mode='decode' -> (logits (B, V), new entries) against the paged pool
    (reference ``transformer.py:177-230`` with ``page=...``): ``batch`` is
    {"token": (B, 1), "pos": (B,) int32}, ``cache`` the pool tree (leaves
    (n_layers, phys, ...)), read-only here; the returned entries are
    written back by ``kvcache.scatter_step``."""
    if mode == "train":
        return _forward_train(cfg, layout, params, batch)
    if mode != "decode":
        raise NotImplementedError(
            f"forward(mode={mode!r}): prompts go through prefill()")
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


def _forward_train(cfg: ModelConfig, layout: Layout, params, batch):
    if cfg.mtp:
        raise NotImplementedError(
            f"{cfg.arch}: the multi-token-prediction head is not ported yet "
            "(ROADMAP.md, Queue 1 item 10)")
    dirs = entry_dirs()
    tokens = batch["tokens"]
    x = embed(layout, cfg, dirs, params, tokens)
    b, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(b, S)
    x, _ = run_stack(layout, cfg, dirs, x, params, positions, mode="train",
                     remat=cfg.remat)
    x = B.apply_norm(cfg, x, params["ln_f"])
    labels, mask = text_labels(batch)
    xent = chunked_head_loss(cfg, layout, dirs, x, labels.clamp_min(0).long(),
                             mask, params["head"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return xent + aux, {"xent": xent, "aux": aux}


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
