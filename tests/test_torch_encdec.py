"""The port's encoder-decoder family (whisper-medium) against the JAX
package, on the CPU.

Reduced whisper (a 2-layer encoder over 32 frames and 2 decoder blocks,
d_model 256, 4/4 heads of 64, LayerNorm, ``gelu_mlp``) in f32, weights
drawn by the port's init and handed to JAX as arrays:

  * the copies: the layer plan, the FLOPs formula, the label length, the
    parameter and decode-cache trees, ``cross_kv_cache_init``;
  * ``sin_positions``, ``encoder_apply`` (plain and under remat),
    ``encoder_kv`` and ``decoder_block_apply`` (train, and decode against
    a filled kv cache and cross k/v) within 1e-4;
  * the whole train loss and every gradient leaf within 1e-4, with and
    without remat;
  * decode steps whose ``xk``/``xv`` hold ``encoder_kv``'s output: the
    JAX decode's logits and the train forward's at each position, within
    1e-4;
  * three AdamW steps at two microbatches within 1e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs.registry import get as jget
from repro.core.params import init_params as jinit_params
from repro.core.topology import Dirs as JDirs
from repro.core.topology import single_device_layout
from repro.models import encdec as jencdec
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.serve import kvcache as jkvcache
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.linear3d import plinear
from repro_torch.core.params import init_params, tree_leaves, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import Dirs
from repro_torch.models import blocks, encdec, registry, transformer
from repro_torch.serve import kvcache
from test_torch_moe_train import _at, _draw, _paths
from test_torch_train import _batch, three_adamw_steps

ARCH = "whisper-medium"
DIRS, JDIRS = Dirs("y", "z"), JDirs("y", "z")
_MODEL = {}


def _model():
    """(jax cfg, port cfg, jax layout, jax f32 params, port params),
    reduced."""
    if not _MODEL:
        jcfg, tcfg = jconfig.reduced(jget(ARCH)), config.reduced(get(ARCH))
        jp = _draw(transformer.abstract_params(tcfg), 0)
        _MODEL["m"] = (jcfg, tcfg, single_device_layout("3d"), jp,
                       params_from_jax(jax.device_get(jp), "cpu"))
    return _MODEL["m"]


def _lay():
    return ParallelPlan().validate().build()


def _frames(cfg):
    def stubs(b, seed):
        rng = np.random.default_rng(seed)
        return {"frames": rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)}
    return stubs


def _np(a):
    return np.asarray(jax.device_get(a), np.float32)


def _scaled_err(got, want):
    """max |got - want| / (1 + max |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - w))) / (
        1 + float(np.max(np.abs(w))))


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def _jlayer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def test_encdec_copies_match_reference():
    cfg, jcfg = get(ARCH), jget(ARCH)
    stack = jregistry.get_stack(jcfg.family)
    assert registry.layer_plan(cfg) == jregistry._plan_audio(jcfg) == \
        ("xdec",) * 24
    assert transformer.serve_cache_mode(cfg) == \
        jregistry.serve_cache_mode(jcfg) == "state"
    for s in (1, 448, 2048):
        assert registry.get_stack(cfg.family).label_len(cfg, s) == \
            stack.label_len(jcfg, s) == s
        assert registry.train_flops_per_token(cfg, s) == \
            jregistry.train_flops_per_token(jcfg, s)
    rcfg, rjcfg = config.reduced(cfg), jconfig.reduced(jcfg)
    jlay = single_device_layout("3d")
    for got_tree, want_tree in (
            (transformer.abstract_params(rcfg),
             jtransformer.abstract_params(rjcfg, jlay)),
            (transformer.abstract_cache(rcfg, None, 3, 40),
             jtransformer.abstract_cache(rjcfg, jlay, 3, 40)),
            (encdec.cross_kv_cache_init(rcfg, 3),
             jencdec.cross_kv_cache_init(jlay, rjcfg, JDIRS, 3))):
        want = dict(_paths(want_tree))
        got = dict(_paths(got_tree))
        assert sorted(got) == sorted(want)
        for path, p in got.items():
            assert tuple(p.shape) == tuple(want[path].shape), path
            assert p.init == want[path].init, path
    assert sorted(transformer.abstract_params(rcfg)["stack"]["xdec"]) == \
        ["attn", "ln1", "ln2", "ln_x", "mlp", "xattn"]


@pytest.mark.parametrize("S,d", [(32, 256), (1504, 1024)])
def test_sin_positions_match_reference(S, d):
    got = encdec.sin_positions(S, d, torch.float32)
    want = _np(jencdec.sin_positions(S, d, jnp.float32))
    assert got.shape == want.shape == (S, d)
    assert float(np.max(np.abs(got.numpy() - want))) <= 1e-4


@pytest.mark.parametrize("remat", [False, True])
def test_encoder_apply_and_encoder_kv_match_reference(remat):
    jcfg, tcfg, jlay, jp, tp = _model()
    frames = _frames(tcfg)(2, 3)["frames"]
    jenc = jax.jit(lambda f, p: jencdec.encoder_apply(
        jlay, jcfg, JDIRS, f, p, remat=remat))(jnp.asarray(frames),
                                               jp["encoder"])
    lay = _lay()
    enc = encdec.encoder_apply(lay, tcfg, DIRS, torch.from_numpy(frames),
                               tp["encoder"], remat=remat)
    assert enc.shape == (2, 32, 256)
    assert _scaled_err(enc, _np(jenc)) <= 1e-4
    xp = _layer(tp["stack"]["xdec"], 1)["xattn"]
    jxp = _jlayer(jp["stack"]["xdec"], 1)["xattn"]
    k, v = encdec.encoder_kv(lay, tcfg, DIRS, enc, xp)
    jk, jv = jax.jit(lambda e, p: jencdec.encoder_kv(
        jlay, jcfg, JDIRS, e, p))(jenc, jxp)
    assert k.shape == (2, 32, tcfg.n_kv, tcfg.head_dim)
    assert _scaled_err(k, _np(jk)) <= 1e-4
    assert _scaled_err(v, _np(jv)) <= 1e-4


def test_decoder_block_train_and_decode_match_reference():
    jcfg, tcfg, jlay, jp, tp = _model()
    rng = np.random.default_rng(7)
    b, S, F = 2, 12, tcfg.encoder.n_frames
    nkv, dh, d = tcfg.n_kv, tcfg.head_dim, tcfg.d_model
    bp = _layer(tp["stack"]["xdec"], 0)
    jbp = _jlayer(jp["stack"]["xdec"], 0)
    lay = _lay()
    # train: the encoder's states through the cross attention
    x = rng.standard_normal((b, S, d)).astype(np.float32)
    enc = rng.standard_normal((b, F, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (b, S))
    jy, _ = jax.jit(lambda x, e, p: jencdec.decoder_block_apply(
        jlay, jcfg, JDIRS, x, p, jnp.asarray(pos), e))(
            jnp.asarray(x), jnp.asarray(enc), jbp)
    y, _ = encdec.decoder_block_apply(
        lay, tcfg, DIRS, torch.from_numpy(x), bp,
        torch.from_numpy(pos.copy()), torch.from_numpy(enc))
    assert _scaled_err(y, _np(jy)) <= 1e-4
    # decode: one token against a kv cache of 16 slots, 5 and 9 filled,
    # and a static cross k/v
    L = 16
    ck = rng.standard_normal((b, L, nkv, dh)).astype(np.float32)
    cv = rng.standard_normal((b, L, nkv, dh)).astype(np.float32)
    cpos = np.where(np.arange(L)[None] < np.array([[5], [9]]),
                    np.arange(L)[None], -1).astype(np.int32)
    xk = rng.standard_normal((b, F, nkv, dh)).astype(np.float32)
    xv = rng.standard_normal((b, F, nkv, dh)).astype(np.float32)
    x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
    p1 = np.array([[5], [9]], np.int32)
    jy, jc = jax.jit(lambda x, p, c, kv: jencdec.decoder_block_apply(
        jlay, jcfg, JDIRS, x, p, jnp.asarray(p1), kv, decode=True,
        cache=c))(jnp.asarray(x1), jbp,
                  {"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                   "pos": jnp.asarray(cpos)},
                  (jnp.asarray(xk), jnp.asarray(xv)))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
             "pos": torch.from_numpy(cpos.copy())}
    y, c = encdec.decoder_block_apply(
        lay, tcfg, DIRS, torch.from_numpy(x1), bp, torch.from_numpy(p1),
        (torch.from_numpy(xk), torch.from_numpy(xv)), decode=True,
        cache=cache)
    assert _scaled_err(y, _np(jy)) <= 1e-4
    for name in ("k", "v"):
        assert _scaled_err(c[name], _np(jc[name])) <= 1e-4
    assert np.array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("remat", [False, True])
def test_train_loss_and_grads_match_reference(remat):
    jcfg, tcfg, jlay, jp, tp = _model()
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    batch = _batch(tcfg.vocab, 2, 16, 2)
    batch.update(_frames(tcfg)(2, 2))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.forward(jcfg, jlay, p, b, mode="train"),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, met = transformer.forward(
        tcfg, _lay(), live, {k: torch.from_numpy(v) if v.dtype.kind == "f"
                             else torch.from_numpy(v).long()
                             for k, v in batch.items()}, mode="train")
    grads = torch.autograd.grad(loss, tree_leaves(live))
    assert abs(loss.item() - float(jloss)) <= 1e-4
    assert abs(met["xent"].item() - float(jmet["xent"])) <= 1e-4
    jg = jax.device_get(jgrads)
    n = 0
    for (path, _), g in zip(_paths(live), grads):
        want = np.asarray(_at(jg, path), np.float32)
        assert g.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.max(np.abs(g.numpy() - want))) <= 1e-4 * scale, path
        n += 1
    # embed, the encoder (10 block leaves, ln_post), the decoder block (16
    # leaves), ln_f, head
    assert n == len(jax.tree.leaves(jg)) == 1 + 12 + 16 + 2 + 1


def _port_logits(tcfg, tp, batch):
    """The train forward's logits at every position (B, S, V)."""
    lay = _lay()
    x, ctx = transformer.frontend(lay, tcfg, DIRS, tp, batch, mode="train")
    b, S = x.shape[:2]
    positions = torch.arange(S).expand(b, S)
    x, _, _ = transformer.run_stack(lay, tcfg, DIRS, x, tp, positions,
                                    mode="train", ctx=ctx)
    x = blocks.apply_norm(tcfg, x, tp["ln_f"])
    return plinear(lay, DIRS, x, tp["head"])[0], ctx["enc"]


def test_decode_over_filled_cross_kv_matches_train_logits():
    """``xk``/``xv`` filled by ``encoder_kv`` from the encoder's states:
    each decode step's logits equal the train forward's at its position
    and the JAX decode's, within 1e-4."""
    jcfg, tcfg, jlay, jp, tp = _model()
    b, T = 2, 6
    batch = _batch(tcfg.vocab, b, T, 4)
    batch.update(_frames(tcfg)(b, 4))
    tb = {"tokens": torch.from_numpy(batch["tokens"]).long(),
          "frames": torch.from_numpy(batch["frames"])}
    with torch.no_grad():
        full, enc = _port_logits(tcfg, tp, tb)
        lay = _lay()
        cache = init_params(kvcache.cache_with_dtype(
            transformer.abstract_cache(tcfg, None, b, 16), torch.float32),
            None, "cpu")
        layers = [_layer(tp["stack"]["xdec"], i)
                  for i in range(tcfg.n_layers)]
        for i, bp in enumerate(layers):
            k, v = encdec.encoder_kv(lay, tcfg, DIRS, enc, bp["xattn"])
            cache["xdec"]["xk"][i].copy_(k)
            cache["xdec"]["xv"][i].copy_(v)
        jcache = jinit_params(jkvcache.cache_with_dtype(
            jtransformer.abstract_cache(jcfg, jlay, b, 16), jnp.float32),
            jax.random.key(0))
        jcache["xdec"]["xk"] = jnp.asarray(cache["xdec"]["xk"].numpy())
        jcache["xdec"]["xv"] = jnp.asarray(cache["xdec"]["xv"].numpy())
        jstep = jax.jit(lambda p, bt, c: jtransformer.forward(
            jcfg, jlay, p, bt, mode="decode", cache=c))
        for t in range(T):
            tok = batch["tokens"][:, t:t + 1]
            pos = np.full((b,), t, np.int32)
            logits, cache = transformer.forward(
                tcfg, lay, tp, {"token": torch.from_numpy(tok).long(),
                                "pos": torch.from_numpy(pos)},
                mode="decode", cache=cache)
            jl, jcache = jstep(jp, {"token": jnp.asarray(tok),
                                    "pos": jnp.asarray(pos)}, jcache)
            assert _scaled_err(logits, _np(full[:, t])) <= 1e-4, t
            assert _scaled_err(logits, _np(jl)) <= 1e-4, t


def test_three_adamw_steps_match_reference():
    model = _model()
    three_adamw_steps(model, 2, seq=16, metrics=("loss", "xent", "gnorm"),
                      stubs=_frames(model[1]))
