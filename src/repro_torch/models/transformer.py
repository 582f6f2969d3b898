"""Model assembly (port of ``repro/models/transformer.py`` and the stack
drivers of ``repro/models/registry.py``).

``abstract_params(cfg, layout)`` is the parameter tree, with the same
nested names, global shapes, dtypes and (for the dense and MoE
families' leaves) specs as the reference's ``transformer.abstract_params``; at pp > 1 each
``stack`` leaf is the ``(pp, slots, ...)`` stage slab, 'pp' on dim 0
(``registry.pipeline_stack_params``), and ``forward(mode="train")`` runs
``forward_pipelined``.  The dense family's:

    embed                                                   (vocab, d)
    stack.dense.{ln1.g, attn.{wq, wk, wv, wo}, ln2.g,
                 mlp.{w_up, w_gate, w_down}}                (L, ...) stacked
    ln_f.g                                                  (d,)
    head                                                    (d, vocab)

(plus ``ln*.b`` for LayerNorm configs, ``attn.{q,k}_norm`` with qk-norm, and
no ``w_gate`` for a plain GELU MLP).  With MLA (deepseek-v3) each block has
``mla.{w_dq, q_ln, w_uq, w_dkv, kv_ln, w_ukv, w_o}`` in place of ``attn``,
and the mtp head adds ``mtp.{ln_h, ln_e, proj, block}``, one MLA block with
the dense MLP.  The MoE family has
``stack.moe.{ln1.g, ln2.g, moe.{w_router, w1, w2, w3, shared.{w_up,
w_down, w_gate}}, attn.{...}}`` (L - first_k_dense, ...), the router in
f32, and its ``first_k_dense`` leading layers as ``stack.dense`` with the
MLP ``moe.dense_ff`` wide.  The hybrid family (zamba2) has
``shared.attn``, one unstacked dense block, and ``stack.mamba.{ln, w_x,
w_z, w_bc, w_dt, dt_bias, A_log, D, conv_x, conv_x_b, conv_bc, conv_bc_b,
gate_ln, w_out}`` (L, ...) instead of ``stack.dense``; the SSM family
(xlstm) has ``stack.mlstm.{ln, w_q, w_k, w_v, w_z, w_if, out_ln, w_out}``
and ``stack.slstm.{ln, w_gates, R, w_out}``.  The VLM family (internvl2)
has the dense family's tree.  The audio family (whisper) has
``encoder.{blocks.{ln1, attn, ln2, mlp} (n_enc, ...), ln_post}`` and
``stack.xdec.{ln1, attn, ln_x, xattn.{wq, wk, wv, wo}, ln2, mlp}`` (L, ...)
(``models/encdec.py``).  Weights keep JAX's (in, out) layout, so a tree
converted by ``convert.params_from_jax`` needs no transposes.

``forward(mode="train")`` returns the loss of a batch of token sequences,
differentiable in every parameter: the frontend (the embedding; the VLM
family's patch embeddings prepended; the audio family's encoder over its
frames, whose states the decoder blocks attend), the layer plan (dense
blocks, MoE blocks, zamba2's Mamba2 blocks and its shared attention
block, xlstm's mLSTM and sLSTM blocks, or whisper's decoder blocks; each
block recomputed in the backward when ``cfg.remat``), ``ln_f`` and the
chunked vocab-parallel head and cross-entropy, plus the MoE blocks'
router losses (``aux``) and, with the mtp head, 0.1 of its loss
(``mtp``).  Serving:
``prefill`` runs
whole right-padded prompts and hands their rope'd (k, v) to the paged
pool; ``forward(mode="decode")`` advances every slot by one token, against
that pool (``page=...``) or against a contiguous per-slot cache tree
(``abstract_cache``: zamba2's and xlstm's recurrent state, zamba2's
shared-block caches, the VLM family's and whisper's caches, the
speculative draft's cache, the gather-view decode); ``extend`` continues
past a cache view with several fresh tokens a row (the prefix-hit tail
prefill and the speculative verify).  The reference scans stacked layer
parameters (``registry.run_stack``); PyTorch runs eagerly, so here the
layer plan is a Python loop over one ``torch.unbind`` of each stacked
leaf, whose backward is a single stack (indexing a layer out of a stack
would build a full-size zero gradient per layer).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..config import Family, ModelConfig
from ..core.linear3d import (act_axes, cross_entropy_sums, embed_lookup,
                             embed_param, out_axes, plinear, weight_param)
from ..core.params import Param, stack_tree, tree_map, unstack
from ..core.topology import Dirs, Layout, entry_dirs
from ..core import comm, ops3d, pipeline
from ..core.plan import pipeline_mode_error
from . import blocks as B
from . import encdec, mamba2, mla, moe, xlstm
from .registry import (KV_KINDS, SHARED_KINDS, embed, get_stack,
                       layer_plan, make_stage_fn, pipeline_info,
                       pipeline_stack_params, pipeline_unsupported_reason,
                       segments, serve_cache_mode, stack_cache)


def _attn_block_params(cfg: ModelConfig, d_ff: int = 0, layout=None):
    """A dense block, its attention MLA where the config has it
    (reference ``registry.py:231-237``)."""
    if cfg.mla is not None:
        return mla.mla_block_params(cfg, d_ff, layout)
    return B.dense_block_params(cfg, d_ff, layout)


def _dense_params(cfg: ModelConfig, layout=None):
    """The MoE family's leading dense layers take ``dense_ff`` (reference
    ``registry.py:281-283``)."""
    return _attn_block_params(
        cfg, cfg.moe.dense_ff if cfg.family == Family.MOE else 0, layout)


# block kinds with per-layer (stacked) parameters; "attn" reads the one
# shared block (reference registry.py:323-329, BlockKind(params=None))
STACKED_KINDS = {"dense": _dense_params, "moe": moe.moe_block_params,
                 "mamba": mamba2.mamba_block_params,
                 "mlstm": xlstm.mlstm_params, "slstm": xlstm.slstm_params,
                 "xdec": encdec.decoder_block_params}
# the recurrent kinds' one-token decode, (x, p, cache) -> (x, new leaves)
RECURRENT_DECODE = {
    "mamba": mamba2.mamba_decode,
    "mlstm": lambda layout, cfg, dirs, x, p, c: xlstm.mlstm_apply(
        layout, cfg, dirs, x, p, decode=True, cache=c),
    "slstm": lambda layout, cfg, dirs, x, p, c: xlstm.slstm_apply(
        layout, cfg, dirs, x, p, decode=True, cache=c)}


def abstract_params(cfg: ModelConfig, layout: Layout = None):
    """Param tree of a model of any family (see the module docstring;
    reference ``transformer.py:47-73``), every leaf on the reference's
    spec for ``layout`` (its strategy; the kv projections',
    ``blocks.attn_params``; the experts', ``moe.moe_params``), None for
    one device."""
    plan = layer_plan(cfg)
    d = cfg.d_model
    dirs = entry_dirs()
    st = "3d" if layout is None else layout.strategy
    pp = 1 if layout is None else layout.size("pp")
    tree = {"embed": embed_param(dirs, cfg.vocab, d, strategy=st)}
    tree.update(get_stack(cfg.family).frontend_params(cfg, layout))
    if "attn" in plan:
        tree["shared"] = {"attn": B.dense_block_params(cfg, layout=layout)}
    layers = {kind: fn(cfg, layout)
              for kind, fn in STACKED_KINDS.items() if kind in plan}
    if pp > 1:
        reason = pipeline_unsupported_reason(cfg, pp)
        if reason:
            raise ValueError(reason)
        tree["stack"] = pipeline_stack_params(cfg, pp, layers)
    else:
        tree["stack"] = {kind: stack_tree(t, plan.count(kind))
                         for kind, t in layers.items()}
    tree["ln_f"] = B.norm_params(cfg, d, st)
    tree["head"] = weight_param(dirs, d, cfg.vocab, strategy=st)
    if cfg.mtp:
        # reference transformer.py:71-79: the proj is a noswap linear
        tree["mtp"] = {
            "ln_h": B.norm_params(cfg, d, st),
            "ln_e": B.norm_params(cfg, d, st),
            "proj": Param((2 * d, d), spec=(dirs.out_ax, None), synced=True),
            "block": _attn_block_params(
                cfg, cfg.moe.dense_ff if cfg.moe else cfg.d_ff, layout)}
    return tree


def frontend(layout: Layout, cfg: ModelConfig, dirs: Dirs, params, batch,
             *, mode: str):
    """(x, ctx): the embedded input and the blocks' context, by the
    family's ``Stack.frontend`` (reference ``registry.py:146-208``).
    Outside decode the VLM family prepends ``batch["patch_embeds"]`` (B,
    n_vision, d) to the text, and the audio family runs the encoder over
    ``batch["frames"]`` (under remat in training), handing its states to
    the decoder blocks as ``ctx["enc"]``.  A decode embeds the one token
    and nothing else, as the reference's does: served internvl2 never sees
    patches and served whisper attends the cache's ``xk``/``xv`` (ROADMAP
    Queue 3, fault 5)."""
    return get_stack(cfg.family).frontend(layout, cfg, dirs, params, batch,
                                          mode=mode)


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _kv_block(kind, layout, cfg, dirs, x, p, positions, **kw):
    """(x, new_cache, aux) of a block that attends through a kv cache: the
    MoE block's router losses, or None for a dense block."""
    if kind == "moe":
        return moe.moe_block_apply(layout, cfg, dirs, x, p, positions, **kw)
    return (*_attn_block_apply(layout, cfg, dirs, x, p, positions, **kw),
            None)


def _attn_block_apply(layout, cfg, dirs, x, p, positions, **kw):
    """(x, new_cache) of a dense block, MLA or not (reference
    ``registry.py:240-258``)."""
    fn = mla.mla_block_apply if "mla" in p else B.dense_block_apply
    return fn(layout, cfg, dirs, x, p, positions, **kw)


def _train_block(layout: Layout, cfg: ModelConfig, dirs: Dirs, positions,
                 kind: str, x, p, enc=None):
    """(x, aux) of one block of ``kind`` outside serving: ``aux`` the MoE
    block's router losses, else None; ``enc`` the encoder's states that
    whisper's ``xdec`` blocks attend."""
    if kind == "xdec":
        return encdec.decoder_block_apply(layout, cfg, dirs, x, p,
                                          positions, enc)[0], None
    if kind == "mamba":
        return mamba2.mamba_apply(layout, cfg, dirs, x, p), None
    if kind == "mlstm":
        return xlstm.mlstm_apply(layout, cfg, dirs, x, p)[0], None
    if kind == "slstm":
        return xlstm.slstm_apply(layout, cfg, dirs, x, p)[0], None
    x, _, a = _kv_block(kind, layout, cfg, dirs, x, p, positions)
    return x, a


def run_stack(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, params,
              positions, *, mode: str, cache=None, page=None,
              collect_kv: bool = False, remat: bool = False, ctx=None):
    """The layer plan, one segment of one block kind after another (the
    reference's ``run_stack``, ``registry.py:643-716``): a per-kind offset
    into each stacked slab, the shared kind ("attn", zamba2's one attention
    block) applied unrolled with ``params["shared"]["attn"]``.  With
    ``remat`` each block is recomputed in the backward (``jax.checkpoint``
    of the scan body and of the shared block there).  ``ctx`` is the
    frontend's context: ``ctx["enc"]``, the encoder's states that
    whisper's ``xdec`` blocks attend outside decode; in decode they
    attend their cache's ``xk``/``xv``.

    Returns (x, new_cache, aux), ``aux`` the f32 sum of the MoE blocks'
    router losses (None when the plan has none).  ``new_cache``: paged decode
    (``page``) -> {kind: {"k", "v", "pos"}} (MLA: {"c_kv", "k_rope",
    "pos"}) for each kv kind ("dense", "moe"), each layer's new entries
    stacked; contiguous decode -> the
    ``cache`` tree itself, written in place (attention entries, Mamba
    state and conv tails; the shared kind's slab holds one cache per use);
    prefill or extend with ``collect_kv`` -> {kind: (k, v)} stacked
    (n_layers of the kind, B, S, nkv, d), MLA's {kind: (c_kv, k_rope)}.  Prefill and extend take the
    dense and MoE families only: a recurrent state has no chunked form, so
    the hybrid and SSM families prefill one token a step through decode."""
    plan = layer_plan(cfg)
    if mode in ("prefill", "extend") and serve_cache_mode(cfg) != "paged":
        raise NotImplementedError(
            f"{cfg.arch}: the {cfg.family.value!r} family serves with "
            f"recurrent state, which has no {mode} form: it prefills one "
            "token a step through forward(mode='decode')")
    decode = mode == "decode"
    contiguous = decode and page is None
    stacks = {k: unstack(t, plan.count(k))
              for k, t in params["stack"].items()}

    enc = (ctx or {}).get("enc")

    def block(kind, xx, p, enc=None):
        return _train_block(layout, cfg, dirs, positions, kind, xx, p, enc)

    outs, offs, auxes = {}, {}, []
    for kind, n in segments(plan):
        off = offs.get(kind, 0)
        offs[kind] = off + n
        for i in range(off, off + n):
            p = params["shared"][kind] if kind in SHARED_KINDS \
                else stacks[kind][i]
            a = None
            if remat:
                x, a = checkpoint(block, kind, x, p, enc,
                                  use_reentrant=False)
            elif contiguous:
                c = _layer(cache[kind], i)
                if kind == "xdec":
                    # the self attention writes c["kv"] in place; the
                    # encoder k/v are static (reference registry.py:351-356)
                    x, _ = encdec.decoder_block_apply(
                        layout, cfg, dirs, x, p, positions,
                        (c["xk"], c["xv"]), decode=True, cache=c["kv"])
                elif kind in RECURRENT_DECODE:
                    x, nc = RECURRENT_DECODE[kind](layout, cfg, dirs, x, p, c)
                    for name, t in nc.items():
                        c[name].copy_(t)
                else:
                    x, _, a = _kv_block(kind, layout, cfg, dirs, x, p,
                                        positions, decode=True, cache=c)
            elif kind not in KV_KINDS:
                x, a = block(kind, x, p, enc)
            else:
                c = (_layer(cache[kind], i)
                     if decode or mode == "extend" else None)
                x, nc, a = _kv_block(kind, layout, cfg, dirs, x, p,
                                     positions, decode=decode, cache=c,
                                     return_kv=collect_kv, page=page)
                if nc is not None:
                    outs.setdefault(kind, []).append(nc)
            if a is not None:
                auxes.append(a)
    aux = torch.stack(auxes).sum() if auxes else None
    if contiguous:
        return x, cache, aux
    if decode:
        return x, {kind: {k: torch.stack([o[k] for o in os]) for k in os[0]}
                   for kind, os in outs.items()}, aux
    return x, {kind: (torch.stack([o[0] for o in os]),
                      torch.stack([o[1] for o in os]))
               for kind, os in outs.items()}, aux


def head_loss_chunks(cfg: ModelConfig, layout: Layout, S: int) -> int:
    """Sequence-chunking factor of the LM head and loss (reference
    ``transformer.py:245-254``): bounds the live (tokens, V) logits to
    about a 32k vocabulary's worth.  ``S`` is the global sequence."""
    k = min(8, max(1, cfg.vocab // 32000, S // 1024))
    div = layout.size("y") * layout.size("z") * \
        layout.size(tuple(layout.seq_axes))
    while k > 1 and (S % k or (S // k) % div):
        k -= 1
    return k


def loss_axes(layout: Layout, dirs: Dirs):
    """The axes over which the head's logits split the tokens: the batch
    axes, ``seq_axes`` and the sequence axis of ``out_axes`` (3d out_ax,
    2d 'y', 1d none; the reference's ``linear3d.logits_spec``)."""
    return layout.live((*layout.batch_axes, *layout.seq_axes,
                        out_axes(layout, dirs)[0]))


def chunked_head_loss(cfg: ModelConfig, layout: Layout, dirs: Dirs, x,
                      labels, mask, w_head):
    """LM head + vocab-parallel cross entropy, chunked over the sequence
    and recomputed per chunk in the backward (reference
    ``transformer.py:257-291``): tokens go to chunk ``position % K``; the
    running max is detached, as ``stop_gradient`` is there.

    ``x`` is the rank's shard in the entry layout (``act_axes``: 3d the
    sequence over ``seq_axes`` and in_ax, the hidden over out_ax);
    ``labels`` and ``mask`` are the rank's shard in the logits' layout
    (``out_axes``: 3d the sequence over ``seq_axes`` and out_ax, the vocab
    over in_ax; 2d 'y' and 'z'; 1d the vocab over 'z'), which the head's
    linear produces.  Since K divides each rank's sequence block, chunk i
    of a block is the block's part of global chunk i.  The loss is the
    token mean, its two sums over ``loss_axes``."""
    seq_ax, vocab_ax = out_axes(layout, dirs)
    B_, S_loc = labels.shape
    S = S_loc * layout.size((*layout.seq_axes, seq_ax))
    K = head_loss_chunks(cfg, layout, S)

    def chunk(x_c, lab_c, mask_c, w):
        logits, _ = plinear(layout, dirs, x_c, w, kind="first")
        return cross_entropy_sums(layout, vocab_ax, logits, lab_c, mask_c)

    xs = x.reshape(B_, x.shape[1] // K, K, x.shape[-1])
    labs = labels.reshape(B_, S_loc // K, K)
    masks = mask.reshape(B_, S_loc // K, K)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(K):
        t, n = checkpoint(chunk, xs[:, :, i], labs[:, :, i], masks[:, :, i],
                          w_head, use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    tot, cnt = comm.psum_id(layout, torch.stack([tot, cnt]),
                            loss_axes(layout, dirs)).unbind()
    return tot / cnt.clamp_min(1.0)


def forward(cfg: ModelConfig, layout: Layout, params, batch, *, mode: str,
            cache=None, page=None):
    """mode='train' -> (loss, {"xent", "aux"} and "mtp" with the mtp head)
    for ``batch`` {"tokens":
    (B, S), "labels": (B, S)}, labels < 0 masked out (reference
    ``transformer.py:177-242``).

    The VLM family's batch carries "patch_embeds" (B, n_vision, d) too,
    its labels the text's; the audio family's "frames" (B, n_frames, d).

    mode='decode' -> (logits (B, V), cache) for ``batch`` {"token": (B,
    1), "pos": (B,) int32} (reference ``transformer.py:177-230``).  With
    ``page=...`` ``cache`` is the paged pool tree (leaves (n_layers, phys,
    ...)), read-only here, and the second result holds the step's new
    entries for ``kvcache.scatter_step``; without, ``cache`` is a
    contiguous tree of ``abstract_cache``'s shape, written in place and
    returned."""
    if mode == "train":
        if layout.size("pp") > 1:
            return forward_pipelined(cfg, layout, params, batch)
        return _forward_train(cfg, layout, params, batch)
    err = pipeline_mode_error(layout.size("pp"), mode)
    if err:
        raise ValueError(err)
    if mode != "decode":
        raise NotImplementedError(
            f"forward(mode={mode!r}): prompts go through prefill()")
    dirs = entry_dirs()
    x, _ = frontend(layout, cfg, dirs, params, batch, mode="decode")
    positions = batch["pos"][:, None]                      # (B, 1)
    x, new_cache, _ = run_stack(layout, cfg, dirs, x, params, positions,
                                mode="decode", cache=cache, page=page)
    x = B.apply_norm(cfg, x, params["ln_f"])
    logits, _ = plinear(layout, dirs, x, params["head"], kind="first",
                        decode=True)
    return logits[:, 0], new_cache


def _forward_train(cfg: ModelConfig, layout: Layout, params, batch):
    """The train loss of the rank's shard of a batch: ``tokens`` split in
    the entry layout (batch, sequence over ``seq_axes`` and in_ax),
    ``labels`` in the logits' (``chunked_head_loss``); the whole batch at
    one device (``data.pipeline.shard_batch``)."""
    dirs = entry_dirs()
    x, ctx = frontend(layout, cfg, dirs, params, batch, mode="train")
    b = x.shape[0]
    S = x.shape[1] * layout.size((*layout.seq_axes,
                                  act_axes(layout, dirs)[0]))
    # the global positions; each attention keeps its rows' columns
    positions = torch.arange(S, device=x.device).expand(b, S)
    x, _, aux = run_stack(layout, cfg, dirs, x, params, positions,
                          mode="train", remat=cfg.remat, ctx=ctx)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = B.apply_norm(cfg, x, params["ln_f"], layout, dirs)
    labels, mask = get_stack(cfg.family).labels(cfg, batch)
    xent = chunked_head_loss(cfg, layout, dirs, x, labels.clamp_min(0).long(),
                             mask, params["head"])
    metrics = {"xent": xent, "aux": aux}
    loss = xent + aux
    if cfg.mtp:
        metrics["mtp"] = _mtp_loss(cfg, layout, dirs, params, x, batch,
                                   positions)
        loss = loss + 0.1 * metrics["mtp"]
    return loss, metrics


def forward_pipelined(cfg: ModelConfig, layout: Layout, params, batch,
                      leaves=None):
    """The train loss at pp > 1 (reference ``transformer.py:109-170``),
    this rank running its stage of the synchronous schedule
    (``core/pipeline.py``) over ``layout.microbatches`` equal microbatches
    of its shard of the batch: stage 0 embeds the batch, each stage runs
    its slots (``registry.make_stage_fn``) and sends the activation on,
    the last stage applies ``ln_f``, the head and the chunked loss to each
    microbatch.  Each microbatch's mean is weighted by its valid-token
    count ``w_i`` (summed over the label axes), so that the total, the
    loss of every pp rank, is the pp = 1 path's global token mean.

    With ``leaves`` (the tensors of ``params`` in ``tree_leaves`` order,
    requiring grad) the schedule runs the backward too, each microbatch's
    seeded with w_i / W (W = sum w_i, known from the labels before any
    forward), and returns (loss, metrics, the f32 gradient of each leaf:
    this stage's part; the train step sums the leaves replicated over pp).
    Without, (loss, metrics), no gradient crossing a stage."""
    pp = layout.size("pp")
    dirs = entry_dirs()
    stage, m = layout.index("pp"), max(layout.microbatches, 1)
    last = stage == pp - 1
    labels, mask = get_stack(cfg.family).labels(cfg, batch)
    b, s_loc = batch["tokens"].shape
    if b % m:
        raise ValueError(f"batch dim {b} not divisible by microbatches {m}")
    bm = b // m
    dev = labels.device
    # the microbatches' global token counts, from the labels alone
    w = comm.psum(layout, mask.reshape(m, -1).sum(1),
                  loss_axes(layout, dirs))
    wsum = w.sum().clamp_min(1.0)
    seq_ax, hid_ax = act_axes(layout, dirs)
    S = s_loc * layout.size((*layout.seq_axes, seq_ax))
    positions = torch.arange(S, device=dev).expand(bm, S)
    like = ((bm, s_loc, cfg.d_model // layout.size(hid_ax)),
            params["embed"].dtype, dev)

    def apply(kind, x, p):
        return _train_block(layout, cfg, dirs, positions, kind, x, p)[0]

    stage_fn = make_stage_fn(pipeline_info(get_stack(cfg.family), cfg, pp),
                             stage, apply, remat=cfg.remat)
    feed = x_all = None
    if stage == 0:
        x_all, _ = frontend(layout, cfg, dirs, params, batch, mode="train")
        feed = [c.detach().requires_grad_(leaves is not None)
                for c in x_all.split(bm)]

    def collect(i, y):
        h = B.apply_norm(cfg, y, params["ln_f"], layout, dirs)
        sl = slice(i * bm, (i + 1) * bm)
        return chunked_head_loss(cfg, layout, dirs, h,
                                 labels[sl].clamp_min(0).long(), mask[sl],
                                 params["head"])

    outs, grads, dfeed = pipeline.pipeline_schedule(
        layout, m=m, feed=feed, stage_fn=lambda x: stage_fn(x, params[
            "stack"]), collect_fn=collect, like=like, leaves=leaves,
        seeds=list(w / wsum))
    xent = (sum(wi * o for wi, o in zip(w, outs)) / wsum if last
            else torch.zeros((), dtype=torch.float32, device=dev))
    # the loss is known on the last stage only: to every pp rank
    xent = comm.psum(layout, xent.detach().float(), "pp")
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = {"xent": xent, "aux": aux}
    if leaves is None:
        return xent + aux, metrics
    if stage == 0:          # the embedding's backward, the whole batch once
        g_emb = torch.autograd.grad(x_all, leaves,
                                    grad_outputs=torch.cat(dfeed),
                                    allow_unused=True)
        grads = [g if e is None else g + e.float()
                 for g, e in zip(grads, g_emb)]
    return xent + aux, metrics, grads


def _mtp_loss(cfg: ModelConfig, layout: Layout, dirs: Dirs, params, h,
              batch, positions):
    """DeepSeek's multi-token prediction (reference
    ``transformer.py:294-317``): predict token t + 2 from (h_t, the
    embedding of token t + 1) through one more block and the shared
    head."""
    p = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    e = embed_lookup(layout, dirs, nxt, params["embed"])
    cat = torch.cat([B.apply_norm(cfg, h, p["ln_h"]),
                     B.apply_norm(cfg, e, p["ln_e"])], dim=-1)
    z = ops3d.matmul3d_noswap(layout, dirs.in_ax, dirs.out_ax, cat,
                              p["proj"])
    z, _ = _attn_block_apply(layout, cfg, dirs, z, p["block"], positions)
    z = B.apply_norm(cfg, z, params["ln_f"])
    lab2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, -1:], -1)],
                     dim=1)
    return chunked_head_loss(cfg, layout, dirs, z, lab2.clamp_min(0).long(),
                             (lab2 >= 0).float(), params["head"])


def prefill(cfg: ModelConfig, layout: Layout, params, batch):
    """Batched whole-prompt prefill (reference ``transformer.py:323-356``).

    ``batch``: {"tokens": (B, S) right-padded prompts, "length": (B,) true
    prompt lengths (0 marks an inactive row)}.  Returns ``(logits, kv)``:
    per-row logits at the last *valid* position (B, V), and the collected
    rope'd (k, v) per layer for ``pack_prefill_cache``."""
    err = pipeline_mode_error(layout.size("pp"), "prefill")
    if err:
        raise ValueError(err)
    dirs = entry_dirs()
    tokens = batch["tokens"]
    x = embed(layout, cfg, dirs, params, tokens)
    b, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(b, S)
    x, kv, _ = run_stack(layout, cfg, dirs, x, params, positions,
                         mode="prefill", collect_kv=True)
    x = B.apply_norm(cfg, x, params["ln_f"])
    idx = (batch["length"].long() - 1).clamp(0, S - 1)
    last = x[torch.arange(b, device=x.device), idx][:, None]    # (B, 1, H)
    logits, _ = plinear(layout, dirs, last, params["head"], kind="first",
                        decode=True)
    return logits[:, 0], kv


def extend(cfg: ModelConfig, layout: Layout, params, batch, view):
    """Multi-token continuation past a cache view (reference
    ``transformer.py:359-400``): the prefix-hit tail prefill and the
    speculative verify.  ``batch``: {"tokens": (B, S) right-padded fresh
    tokens, "offset": (B,) int32 position of each row's first fresh token,
    "length": (B,) int32 valid fresh tokens (0 = inactive row)}; ``view``:
    a gathered cache tree {kind: {"k", "v", "pos"}} with leaves
    (n_layers, B, L, ...).  Returns (logits (B, S, V) at every fresh
    position, the collected (k, v) for ``pack_prefill_cache``, positions
    (B, S) int32 with -1 on padding)."""
    if serve_cache_mode(cfg) != "paged":
        raise ValueError(
            f"extend: family {cfg.family} serves with recurrent state, not a "
            "kv view; only 'paged' families support multi-token continuation")
    if cfg.mla is not None:
        raise NotImplementedError(
            "extend: MLA latent caches have no gathered-view continuation "
            "path yet; serve MLA models without --prefix-cache/--draft")
    err = pipeline_mode_error(layout.size("pp"), "extend")
    if err:
        raise ValueError(err)
    dirs = entry_dirs()
    tokens = batch["tokens"]
    x = embed(layout, cfg, dirs, params, tokens)
    S = tokens.shape[1]
    i = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = torch.where(i[None, :] < batch["length"][:, None],
                            batch["offset"][:, None] + i[None, :], -1)
    x, kv, _ = run_stack(layout, cfg, dirs, x, params, positions,
                         mode="extend", cache=view, collect_kv=True)
    x = B.apply_norm(cfg, x, params["ln_f"])
    logits, _ = plinear(layout, dirs, x, params["head"], kind="first")
    return logits, kv, positions


def abstract_cache(cfg: ModelConfig, layout: Layout, batch: int,
                   length: int):
    """The contiguous decode-cache tree of ``batch`` slots of ``length``
    (reference ``transformer.py:406-409``): ``registry.stack_cache``."""
    return stack_cache(cfg, batch, length)


def pack_prefill_cache(cfg: ModelConfig, collected, pos2d):
    """Shape the kv collected by ``prefill`` into pool updates
    (reference ``registry.py:570-593``): {kind: {"k", "v", "pos"}} (MLA's
    latents: {"c_kv", "k_rope", "pos"}) with leaves (n_layers, B, S, ...);
    ``pos2d`` (B, S) holds the logical positions, -1 on padding lanes."""
    keys = ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")
    out = {}
    for kname, (a, b) in collected.items():
        pos = pos2d[None].to(torch.int32).expand(a.shape[0], *pos2d.shape)
        out[kname] = {keys[0]: a, keys[1]: b, "pos": pos}
    return out
