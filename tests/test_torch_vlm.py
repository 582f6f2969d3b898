"""The port's VLM family (internvl2-2b) against the JAX package, on the CPU.

Reduced internvl2 (2 dense layers, d_model 256, 8 vision tokens) in f32,
weights drawn by the port's init and handed to JAX as arrays:

  * the copies: ``frontend.py``'s two stubs and the token stream's
    modality stubs bit for bit (both families), the layer plan, the label
    length, the FLOPs formula, the labels and mask, the microbatch weight;
  * the train loss, xent and every gradient leaf within 1e-4 at two
    microbatches, each weighted as the reference weights it (every text
    position counts, masked labels too);
  * three AdamW steps at two microbatches within 1e-2;
  * the state-path engine: the JAX engine's greedy tokens, every step's
    logits within 1e-4;
  * the reference's patch-less serving pinned (ROADMAP.md, Queue 3 fault
    5): its decode ignores ``patch_embeds``, and the state path prefills
    through decode, in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs.registry import get as jget
from repro.core.params import init_params as jinit_params
from repro.core.topology import single_device_layout
from repro.data import pipeline as jpipeline
from repro.models import frontend as jfrontend
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.serve import Engine as JEngine, Request as JRequest
from repro.serve import kvcache as jkvcache
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_leaves, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.data.pipeline import DataConfig, TokenStream, to_device
from repro_torch.models import frontend, registry, transformer
from repro_torch.serve import Engine, Request
from test_torch_moe_serve import _record_port, _run
from test_torch_moe_train import _at, _draw, _paths
from test_torch_train import _batch, three_adamw_steps

ARCH = "internvl2-2b"
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


def _patches(cfg):
    def stubs(b, seed):
        rng = np.random.default_rng(seed)
        return {"patch_embeds": rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    return stubs


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype.kind == "f"
            else torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-medium"])
def test_frontend_and_data_stubs_equal_reference_bit_for_bit(arch,
                                                             monkeypatch):
    cfg, jcfg = config.reduced(get(arch)), jconfig.reduced(jget(arch))
    if cfg.encoder is not None:
        for seed in (None, 5):
            rng = None if seed is None else np.random.default_rng(seed)
            jrng = None if seed is None else np.random.default_rng(seed)
            assert np.array_equal(frontend.audio_frames(cfg, 3, rng),
                                  jfrontend.audio_frames(jcfg, 3, jrng))
    else:
        got = frontend.vision_patches(cfg, 3, np.random.default_rng(2))
        want = jfrontend.vision_patches(jcfg, 3, np.random.default_rng(2))
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert np.array_equal(frontend.vision_patches(cfg, 2),
                              jfrontend.vision_patches(jcfg, 2))
    # the token stream: the reference's host batches, before shard_batch
    monkeypatch.setattr(jpipeline, "shard_batch", lambda b, c, lay: b)
    shape = config.ShapeConfig("t", 48, 3, "train")
    jshape = jconfig.ShapeConfig("t", 48, 3, "train")
    port = TokenStream(cfg, shape, DataConfig(seed=3))
    ref = jpipeline.TokenStream(jcfg, None, jshape,
                                jpipeline.DataConfig(seed=3))
    for _ in range(2):
        got, want = port.next_host(), next(ref)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    stub = "frames" if cfg.encoder is not None else "patch_embeds"
    assert got["tokens"].shape[1] == \
        registry.get_stack(cfg.family).label_len(cfg, 48)
    dev = to_device(got, "cpu")
    assert dev[stub].dtype == torch.bfloat16 and dev["tokens"].dtype == \
        torch.int64
    assert torch.equal(dev[stub], torch.from_numpy(got[stub]).bfloat16())


def test_vlm_copies_match_reference():
    cfg, jcfg = get(ARCH), jget(ARCH)
    stack = jregistry.get_stack(jcfg.family)
    pstack = registry.get_stack(cfg.family)
    assert registry.layer_plan(cfg) == stack.layer_plan(jcfg) == \
        ("dense",) * 24
    assert transformer.serve_cache_mode(cfg) == \
        jregistry.serve_cache_mode(jcfg) == "state"
    for s in (1, 2048, 4096):
        assert pstack.label_len(cfg, s) == stack.label_len(jcfg, s)
        assert registry.train_flops_per_token(cfg, s) == \
            jregistry.train_flops_per_token(jcfg, s)
    rcfg, rjcfg = config.reduced(cfg), jconfig.reduced(jcfg)
    batch = _batch(rcfg.vocab, 2, 12, 0)
    got = pstack.labels(rcfg, _torch_batch(batch))
    want = stack.labels(rjcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy().astype(np.float32),
                              np.asarray(w, np.float32))
    assert float(pstack.mb_weight(rcfg, _torch_batch(batch))) == \
        float(stack.mb_weight(rjcfg, batch)) == 24.0
    want = dict(_paths(jtransformer.abstract_params(
        rjcfg, single_device_layout("3d"))))
    got = dict(_paths(transformer.abstract_params(rcfg)))
    assert sorted(got) == sorted(want)
    for path, p in got.items():
        assert tuple(p.shape) == tuple(want[path].shape), path


def _grads(fn, live, mbs, weight):
    """(loss, xent, grads) accumulated over microbatches ``mbs``, each
    weighted by ``weight(mb)`` over their sum, as the train steps weight
    them."""
    tot = xent = 0.0
    gsum = None
    wsum = 0.0
    for mb in mbs:
        w = float(weight(mb))
        loss, met, g = fn(live, mb)
        tot, xent, wsum = tot + w * loss, xent + w * met, wsum + w
        g = [w * np.asarray(x, np.float32) for x in g]
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
    return tot / wsum, xent / wsum, [g / wsum for g in gsum]


def test_train_loss_and_grads_at_two_microbatches_match_reference():
    jcfg, tcfg, jlay, jp, tp = _model()
    batch = _batch(tcfg.vocab, 4, 24, 1)
    batch.update(_patches(tcfg)(4, 1))
    mbs = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
           for i in range(2)]
    stack = jregistry.get_stack(jcfg.family)
    jfn = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.forward(jcfg, jlay, p, b, mode="train"),
        has_aux=True))

    def jax_mb(p, mb):
        (loss, met), g = jfn(p, {k: jnp.asarray(v) for k, v in mb.items()})
        return float(loss), float(met["xent"]), jax.tree.leaves(
            jax.device_get(g))
    jloss, jxent, jg = _grads(jax_mb, jp, mbs,
                              lambda mb: stack.mb_weight(jcfg, mb))
    lay = ParallelPlan().validate().build()

    def port_mb(p, mb):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, met = transformer.forward(tcfg, lay, live, _torch_batch(mb),
                                        mode="train")
        g = torch.autograd.grad(loss, tree_leaves(live))
        return loss.item(), met["xent"].item(), [x.numpy() for x in g]
    loss, xent, grads = _grads(
        port_mb, tp, mbs, lambda mb: registry.get_stack(
            tcfg.family).mb_weight(tcfg, _torch_batch(mb)))
    assert abs(loss - jloss) <= 1e-4 and abs(xent - jxent) <= 1e-4
    jtree = jax.tree.unflatten(jax.tree.structure(jp), jg)
    n = 0
    for (path, _), g in zip(_paths(tp), grads):
        want = np.asarray(_at(jtree, path), np.float32)
        assert g.shape == want.shape, path
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.max(np.abs(g - want))) <= 1e-4 * scale, path
        n += 1
    assert n == len(jg)


def test_three_adamw_steps_match_reference():
    model = _model()
    three_adamw_steps(model, 2, seq=16, metrics=("loss", "xent", "gnorm"),
                      stubs=_patches(model[1]))


PROMPTS = [[2 + (7 * i + 3 * j) % 500 for j in range(5 + 3 * i)]
           for i in range(3)]


def _record_jax(eng):
    """Log every logits array the JAX engine samples from (state path)."""
    log, base = [], eng.sampler

    def recording(logits, key):
        jax.debug.callback(lambda x: log.append(np.array(x)), logits)
        return base(logits, key)
    eng.sampler = recording
    eng._build_contiguous()
    return log


def test_engine_state_path_matches_reference():
    jcfg, tcfg, jlay, jp, tp = _model()
    kw = dict(batch_size=2, max_len=32)
    jeng = JEngine(jcfg, jlay, jp, **kw)
    jlog = _record_jax(jeng)
    jout, _ = _run(jeng, JRequest, PROMPTS, 6)
    eng = Engine(tcfg, ParallelPlan().validate(mode="serve").build(), tp,
                 **kw)
    assert not eng.paged and sorted(eng.cache) == ["dense"]
    tlog = _record_port(eng)
    out, st = _run(eng, Request, PROMPTS, 6)
    assert out == jout
    assert st["nonfinite_rows"] == 0 and len(tlog) == len(jlog)
    assert max(float(np.max(np.abs(t - j))) for t, j in zip(tlog, jlog)) \
        <= 1e-4


def test_reference_serves_without_patches():
    """Fault 5 of the reference, copied: ``_vlm_frontend`` prepends the
    patches only outside decode, and the state path prefills through
    decode, so a served request's logits never depend on its image."""
    jcfg, tcfg, jlay, jp, tp = _model()
    b = 2
    tok = np.array([[5], [9]], np.int32)
    pos = np.array([0, 3], np.int32)
    logits = {}
    for seed in (0, 1):
        patches = _patches(tcfg)(b, seed)["patch_embeds"]
        jcache = jinit_params(jkvcache.cache_with_dtype(
            jtransformer.abstract_cache(jcfg, jlay, b, 16), jnp.float32),
            jax.random.key(0))
        jl, _ = jtransformer.forward(
            jcfg, jlay, jp, {"token": jnp.asarray(tok),
                             "pos": jnp.asarray(pos),
                             "patch_embeds": jnp.asarray(patches)},
            mode="decode", cache=jcache)
        cache = init_params(transformer.abstract_cache(
            tcfg, None, b, 16), None, "cpu", torch.float32)
        tl, _ = transformer.forward(
            tcfg, ParallelPlan().validate(mode="serve").build(), tp,
            {"token": torch.from_numpy(tok).long(),
             "pos": torch.from_numpy(pos),
             "patch_embeds": torch.from_numpy(patches)},
            mode="decode", cache=cache)
        logits[seed] = (np.asarray(jl), tl.numpy())
        assert float(np.max(np.abs(logits[seed][0] - logits[seed][1]))) \
            <= 1e-4
    assert np.array_equal(logits[0][0], logits[1][0])
    assert np.array_equal(logits[0][1], logits[1][1])
    assert JEngine(jcfg, jlay, jp, batch_size=2, max_len=16).chunked is False
