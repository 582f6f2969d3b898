"""The port's whisper-medium serving and checkpoints against the JAX
package, on the CPU.

Reduced whisper in f32 (2 decoder blocks, 32 frames), weights drawn by the
port's init and handed to JAX as arrays:

  * the state-path engine (sequential prefill through the decode path, the
    self attention's contiguous kv and the static cross k/v): the JAX
    engine's greedy tokens, every step's logits within 1e-4;
  * the reference's empty cross k/v pinned (ROADMAP.md, Queue 3 fault 5):
    no engine code writes the encoder's k/v into ``xk``/``xv``, which stay
    zero through a run, and the slot wipe zeroes them, in both packages;
  * the prefix-cache and draft refusals, worded as the reference's;
  * a checkpoint of reduced whisper (the ``encoder`` subtree, each decoder
    block's ``ln_x`` and ``xattn``) written by each package and restored
    by the other, bit for bit, and the JAX tree carried across by
    ``convert.params_from_jax``;
  * both launchers on the CPU for both modality families, the serve
    launcher restoring the train launcher's checkpoint.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.checkpoint import store as jstore
from repro.configs.registry import get as jget
from repro.core.topology import single_device_layout
from repro.models import transformer as jtransformer
from repro.optim.optimizers import opt_state_abstract
from repro.serve import Engine as JEngine, Request as JRequest
from repro_torch import config
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core.params import init_params, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.optim import OptState, adamw_init
from repro_torch.serve import Engine, Request, speculate
from test_torch_encdec import _model
from test_torch_moe_serve import _record_port, _run
from test_torch_moe_train import _same_bits
from test_torch_vlm import _record_jax

ARCH = "whisper-medium"
PROMPTS = [[2 + (7 * i + 3 * j) % 500 for j in range(5 + 3 * i)]
           for i in range(3)]


def _tlay():
    return ParallelPlan().validate(mode="serve").build()


def test_engine_state_path_matches_reference():
    jcfg, tcfg, jlay, jp, tp = _model()
    kw = dict(batch_size=2, max_len=32)
    jeng = JEngine(jcfg, jlay, jp, **kw)
    jlog = _record_jax(jeng)
    jout, _ = _run(jeng, JRequest, PROMPTS, 6)
    eng = Engine(tcfg, _tlay(), tp, **kw)
    assert not eng.paged and sorted(eng.cache["xdec"]) == ["kv", "xk", "xv"]
    tlog = _record_port(eng)
    out, st = _run(eng, Request, PROMPTS, 6)
    assert out == jout
    assert st["nonfinite_rows"] == 0 and len(tlog) == len(jlog)
    assert max(float(np.max(np.abs(t - j))) for t, j in zip(tlog, jlog)) \
        <= 1e-4
    # fault 5: nothing wrote the encoder's k/v, in either engine
    for leaf in ("xk", "xv"):
        assert not np.any(np.asarray(jeng.cache["xdec"][leaf]))
        assert not eng.cache["xdec"][leaf].any()


def test_reference_slot_wipe_zeroes_cross_kv():
    """Fault 5 of the reference, copied: its ``reset_rows`` wipes the
    placed slots' ``xk``/``xv`` with every other float leaf, so even a
    cross k/v written by hand does not survive an admission."""
    jcfg, tcfg, jlay, jp, tp = _model()
    eng = Engine(tcfg, _tlay(), tp, batch_size=2, max_len=16)
    jeng = JEngine(jcfg, jlay, jp, batch_size=2, max_len=16)
    for leaf in ("xk", "xv"):
        eng.cache["xdec"][leaf].fill_(1.0)
    jcache = jax.tree.map(
        lambda a: jnp.ones_like(a) if a.shape[-1] == tcfg.head_dim
        and a.ndim == 5 and a.shape[2] == tcfg.encoder.n_frames else a,
        jeng.cache)
    mask = np.array([True, False])
    eng._reset_rows(torch.from_numpy(mask))
    jcache = jeng._reset(jcache, jnp.asarray(mask))
    for leaf in ("xk", "xv"):
        got = eng.cache["xdec"][leaf].numpy()
        want = np.asarray(jcache["xdec"][leaf])
        assert np.array_equal(got, want)
        assert not got[:, 0].any() and (got[:, 1] == 1).all()
    assert np.array_equal(eng.cache["xdec"]["kv"]["pos"].numpy(),
                          np.asarray(jcache["xdec"]["kv"]["pos"]))


def test_engine_refusals_match_reference():
    jcfg, tcfg, jlay, jp, tp = _model()
    with pytest.raises(ValueError) as want:
        JEngine(jcfg, jlay, jp, prefix_cache=True)
    with pytest.raises(ValueError) as got:
        Engine(tcfg, _tlay(), tp, prefix_cache=True)
    assert str(got.value) == str(want.value)
    assert speculate.draft_unsupported_reason(tcfg, tcfg) is not None
    with pytest.raises(ValueError, match="recurrent state"):
        Engine(tcfg, _tlay(), tp, draft=speculate.DraftSpec(tcfg, _tlay(),
                                                            tp))


def test_whisper_checkpoint_round_trips_between_packages(tmp_path):
    """A port save of reduced whisper's bf16 parameters and an AdamW state,
    restored by the JAX store bit for bit; the JAX tree saved by the JAX
    store, restored by the port bit for bit."""
    jcfg, tcfg = jconfig.reduced(jget(ARCH)), config.reduced(get(ARCH))
    jlay = single_device_layout("3d")
    gen = torch.Generator().manual_seed(3)
    params = init_params(transformer.abstract_params(tcfg), gen, "cpu",
                         torch.bfloat16)
    assert "ln_post" in params["encoder"]
    assert "xattn" in params["stack"]["xdec"]
    opt = OptState(4, tree_map(lambda t: torch.randn(t.shape, generator=gen),
                               params),
                   tree_map(lambda t: torch.rand(t.shape, generator=gen),
                            params))
    store.save(str(tmp_path / "port"), 4, params, opt,
               layout=ParallelPlan().validate().build())
    jtmpl = jtransformer.abstract_params(jcfg, jlay)
    jparams, jopt, _ = jstore.restore(
        str(tmp_path / "port"), 4, jtmpl, jlay,
        opt_state_abstract(jtmpl, jlay, jconfig.OptimConfig()))
    assert int(jopt.step) == 4
    _same_bits(params, jparams)
    _same_bits(opt.m, jopt.m)
    _same_bits(opt.v, jopt.v)

    jstore.save(str(tmp_path / "jax"), 6, jparams, jopt, layout=jlay)
    tmpl = init_params(transformer.abstract_params(tcfg),
                       torch.Generator().manual_seed(4), "cpu",
                       torch.bfloat16)
    back, tstate, _ = store.restore(
        str(tmp_path / "jax"), 6, tmpl,
        adamw_init(tmpl, ParallelPlan().validate().build(),
                   transformer.abstract_params(tcfg)))
    assert tstate.step == 4
    _same_bits(back, jparams)
    _same_bits(tstate.v, jopt.v)
    # the same tree carried across by convert, with a cast to bf16
    _same_bits(params_from_jax(jax.device_get(jparams), "cpu",
                               torch.bfloat16, cfg=tcfg), jparams)


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-medium"])
def test_launchers_run_the_modality_families_on_cpu(arch, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = train_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "24",
                             "--log-every", "1", "--microbatch", "2",
                             "--ckpt-dir", ck, "--ckpt-every", "2"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    stats = serve_launch.main(["--arch", arch, "--reduced", "--device",
                               "cpu", "--requests", "3", "--max-new", "4",
                               "--ckpt-dir", ck])
    assert stats["tokens"] == 12
    text = capsys.readouterr().out
    assert "saved " in text and "restored checkpoint step 2" in text
    assert "cache=state" in text
