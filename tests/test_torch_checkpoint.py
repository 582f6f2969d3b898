"""The port's checkpoint store against the JAX package's, on the CPU.

Both packages write the same on-disk format (``step_{step:08d}/``, one
global ``.npy`` per leaf, bf16 as its uint16 bits, ``index.json``), so a
checkpoint moves between them in either direction: a JAX save of reduced
tinyllama-1.1b and xlstm-350m parameters and AdamW state after two steps
is restored by the port bit for bit and two more steps of each package
agree within 1e-4; a port save (bf16 parameters) is restored by the JAX
store bit for bit; the same tree saved by both gives the same files, the
same ``index.json`` and the same bytes.  Then the reference's refusals
(a missing leaf, a global-shape mismatch) with its messages,
``latest_step``, and the launchers' ``--ckpt-dir``: the train launcher's
resume and its ``nothing to do`` line, the serve launcher's restore.
Last, Adafactor's state (a factored leaf's ``v`` a dict of ``row`` and
``col``) round trips with the reference's keys and files.  Checkpoints
across layouts (dp 2 / ZeRO 1 to dp 4) are in ``test_torch_zero.py``,
whose 8-rank world they share.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.checkpoint import store as jstore
from repro.configs.registry import get as jget
from repro.core.params import init_params as jinit_params
from repro.core.topology import single_device_layout
from repro.models import transformer as jtransformer
from repro.optim.optimizers import OptState as JOptState
from repro.optim.optimizers import opt_state_abstract
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import config
from repro_torch.checkpoint import store
from repro_torch.configs.registry import get
from repro_torch.core.params import init_params, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import transformer
from repro_torch.optim import OptState, adamw_init
from repro_torch.optim.optimizers import \
    opt_state_abstract as port_opt_abstract
from repro_torch.train.step import make_train_step

OPT = dict(lr=3e-3, warmup=2, total_steps=6)


def _bits(a) -> np.ndarray:
    """An array's bytes as unsigned ints of its width (bf16 -> uint16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(jax.device_get(a))
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _same_bits(port_tree, jax_tree):
    jt = jax.device_get(jax_tree)
    n = 0
    for path, t in _flat(port_tree):
        want = jt
        for k in path:
            want = want[k]
        assert tuple(t.shape) == tuple(want.shape), path
        assert np.array_equal(_bits(t), _bits(want)), path
        n += 1
    assert n == len(jax.tree.leaves(jt))


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _models(arch):
    jcfg = jconfig.reduced(jget(arch))
    tcfg = config.reduced(get(arch))
    jlay = single_device_layout("3d")
    return jcfg, tcfg, jlay


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-350m"])
def test_port_restores_jax_checkpoint_and_trains_on(tmp_path, arch):
    """Two JAX AdamW steps saved by the JAX store, restored by the port
    into f32 templates: every parameter, moment and the step bit for bit;
    then two more steps of each package from there agree within 1e-4."""
    jcfg, tcfg, jlay = _models(arch)
    jp = jinit_params(jtransformer.abstract_params(jcfg, jlay),
                      jax.random.key(0), dtype=jnp.float32)
    jstate = jinit_params(opt_state_abstract(
        jtransformer.abstract_params(jcfg, jlay), jlay,
        jconfig.OptimConfig(**OPT)), jax.random.key(1))
    jstep = jax.jit(jmake_train_step(jcfg, jlay, jconfig.OptimConfig(**OPT)))
    for s in range(2):
        jp, jstate, _ = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in
                                           _batch(tcfg.vocab, s).items()})
    jstore.save(str(tmp_path), 2, jp, jstate, layout=jlay)

    assert store.latest_step(str(tmp_path)) == 2
    lay = ParallelPlan().validate().build()
    tmpl = init_params(transformer.abstract_params(tcfg),
                       torch.Generator().manual_seed(5), "cpu",
                       torch.float32)
    tp, tstate, extra = store.restore(
        str(tmp_path), 2, tmpl,
        adamw_init(tmpl, lay, transformer.abstract_params(tcfg)))
    assert extra == {} and isinstance(tstate, OptState)
    assert tstate.step == 2 and isinstance(tstate.step, int)
    _same_bits(tp, jp)
    _same_bits(tstate.m, jstate.m)
    _same_bits(tstate.v, jstate.v)

    step = make_train_step(tcfg, lay, config.OptimConfig(**OPT))
    for s in range(2, 4):
        batch = _batch(tcfg.vocab, s)
        jp, jstate, jmet = jstep(jp, jstate, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        tp, tstate, met = step(tp, tstate, {k: torch.from_numpy(v).long()
                                            for k, v in batch.items()})
        assert abs(met["loss"].item() - float(jmet["loss"])) <= 1e-4
    assert tstate.step == 4
    jg = jax.device_get(jp)
    for path, t in _flat(tp):
        want = jg
        for k in path:
            want = want[k]
        assert np.max(np.abs(t.numpy() - np.asarray(want))) <= 1e-4, path


def _port_tree(tcfg, seed=3):
    """Port bf16 parameters and an AdamW state with drawn moments."""
    gen = torch.Generator().manual_seed(seed)
    params = init_params(transformer.abstract_params(tcfg), gen, "cpu",
                         torch.bfloat16)
    m = tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
    v = tree_map(lambda t: torch.rand(t.shape, generator=gen), params)
    return params, OptState(7, m, v)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "xlstm-350m"])
def test_jax_restores_port_checkpoint(tmp_path, arch):
    jcfg, tcfg, jlay = _models(arch)
    params, opt = _port_tree(tcfg)
    lay = ParallelPlan().validate().build()
    d = store.save(str(tmp_path), 7, params, opt, extra={"note": "port"},
                   layout=lay)
    assert d == os.path.join(str(tmp_path), "step_00000007")
    jtmpl = jtransformer.abstract_params(jcfg, jlay)
    jp, jopt, extra = jstore.restore(
        str(tmp_path), 7, jtmpl, jlay,
        opt_state_abstract(jtmpl, jlay, jconfig.OptimConfig(**OPT)))
    assert extra == {"note": "port"}
    assert int(jopt.step) == 7 and jopt.step.dtype == jnp.int32
    _same_bits(params, jp)
    _same_bits(opt.m, jopt.m)
    _same_bits(opt.v, jopt.v)
    assert jax.tree.leaves(jp)[0].dtype == jnp.bfloat16


def test_both_packages_write_the_same_files(tmp_path):
    """One tree (xlstm bf16 parameters, f32 moments, step 7) saved by
    each package: the same file names, the same index.json, the same
    bytes in every file."""
    jcfg, tcfg, jlay = _models("xlstm-350m")
    params, opt = _port_tree(tcfg)
    lay = ParallelPlan().validate().build()
    store.save(str(tmp_path / "port"), 7, params, opt, layout=lay)

    def to_jax(t):
        return jnp.asarray(_bits(t)).view(jnp.bfloat16) \
            if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())
    jparams = jax.tree.map(to_jax, params)
    jopt = JOptState(jnp.int32(7), jax.tree.map(to_jax, opt.m),
                     jax.tree.map(to_jax, opt.v))
    jstore.save(str(tmp_path / "jax"), 7, jparams, jopt, layout=jlay)
    a, b = (tmp_path / w / "step_00000007" for w in ("port", "jax"))
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert "params__stack__mlstm__w_q.npy" in names
    assert "opt__.m__stack__mlstm__w_q.npy" in names
    assert "opt__.step.npy" in names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    index = json.loads((a / "index.json").read_text())
    assert index["leaves"]["opt/.step"] == {"file": "opt__.step.npy",
                                            "shape": [], "dtype": "int32"}
    assert index["leaves"]["params/stack/slstm/R"]["dtype"] == "bfloat16"
    assert index["meta"] == {"mesh": {a_: 1 for a_ in lay.sizes},
                             "zero_stage": 0}


def test_restore_refusals_match_reference(tmp_path):
    """A leaf the checkpoint lacks and a global-shape mismatch: KeyError
    and ValueError with the reference's messages."""
    jcfg, tcfg, jlay = _models("xlstm-350m")
    params, opt = _port_tree(tcfg)
    store.save(str(tmp_path), 1, params, opt)
    extra = dict(params, more=torch.zeros(3))
    with pytest.raises(KeyError) as got:
        store.restore(str(tmp_path), 1, extra)
    jtmpl = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32), params)
    with pytest.raises(KeyError) as want:
        jstore.restore(str(tmp_path), 1, dict(jtmpl, more=jnp.zeros(3)),
                       jlay)
    assert str(got.value) == str(want.value) == \
        "'checkpoint missing params/more'"
    bad = dict(params, head=torch.zeros(3, 4))
    with pytest.raises(ValueError) as got:
        store.restore(str(tmp_path), 1, bad)
    with pytest.raises(ValueError) as want:
        jstore.restore(str(tmp_path), 1, dict(jtmpl, head=jnp.zeros((3, 4))),
                       jlay)
    assert str(got.value) == str(want.value)
    assert "stored global shape (256, 512) != template (3, 4)" in \
        str(got.value)


def test_latest_step(tmp_path):
    assert store.latest_step(str(tmp_path / "none")) == -1
    assert store.latest_step(str(tmp_path)) == -1
    for s in (2, 10, 4):
        os.makedirs(tmp_path / f"step_{s:08d}")
    assert store.latest_step(str(tmp_path)) == 10 == \
        jstore.latest_step(str(tmp_path))


def test_restore_lands_in_the_templates_dtypes(tmp_path):
    """A bf16 model restores its bf16 leaves bit for bit and keeps the
    f32 leaves its Params pin (zamba2's dt_bias, A_log, D) in f32."""
    tcfg = config.reduced(get("zamba2-1.2b"))
    params, _ = _port_tree(tcfg)
    store.save(str(tmp_path), 3, params)
    got, opt, _ = store.restore(str(tmp_path), 3,
                                transformer.abstract_params(tcfg),
                                device="cpu")
    assert opt is None
    m = got["stack"]["mamba"]
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    assert m["w_x"].dtype == torch.bfloat16
    for (path, a), (_, b) in zip(_flat(got), _flat(params)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_launchers_resume_and_restore(tmp_path, capsys):
    """The train launcher saves every --ckpt-every steps, resumes from the
    latest step, says when there is nothing to do; the serve launcher
    restores the latest step's parameters and serves."""
    ck = str(tmp_path / "ck")
    argv = ["--arch", "xlstm-350m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--log-every", "1",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    out = train_launch.main(argv + ["--steps", "2"])
    text = capsys.readouterr().out
    assert out["start"] == 0 and len(out["losses"]) == 2
    assert f"saved {os.path.join(ck, 'step_00000002')}" in text
    out = train_launch.main(argv + ["--steps", "3"])
    text = capsys.readouterr().out
    assert f"restoring step 2 from {ck}" in text
    assert out["start"] == 2 and len(out["losses"]) == 1
    assert "step     3 loss=" in text and "step     2 loss=" not in text
    out = train_launch.main(argv + ["--steps", "2"])
    text = capsys.readouterr().out
    assert "nothing to do: restored step 2 >= --steps 2" in text
    assert out["losses"] == []
    stats = serve_launch.main(["--arch", "xlstm-350m", "--reduced",
                               "--device", "cpu", "--requests", "2",
                               "--max-new", "3", "--ckpt-dir", ck])
    text = capsys.readouterr().out
    assert "restored checkpoint step 2" in text and stats["tokens"] == 6


def test_adafactor_checkpoint_round_trips_with_reference_keys(tmp_path):
    """A port save of tinyllama's bf16 parameters and an Adafactor state
    of drawn stats: the reference's keys (``opt/.v/<path>/row``), no
    ``opt/.m``; the JAX store restores it bit for bit with its own
    template, writes the same files and bytes, and the port restores
    those bit for bit."""
    tcfg = config.reduced(get("tinyllama-1.1b"))
    jcfg = jconfig.reduced(jget("tinyllama-1.1b"))
    lay, jlay = ParallelPlan().validate().build(), single_device_layout()
    ada = dict(name="adafactor")
    gen = torch.Generator().manual_seed(3)
    ab = transformer.abstract_params(tcfg, lay)
    params = init_params(ab, gen, "cpu", torch.bfloat16)
    stats = port_opt_abstract(ab, lay, config.OptimConfig(**ada)).v
    opt = OptState(5, None, tree_map(
        lambda p: torch.rand(p.shape, generator=gen), stats))
    assert sorted(opt.v["stack"]["dense"]["mlp"]["w_up"]) == ["col", "row"]
    assert isinstance(opt.v["ln_f"]["g"], torch.Tensor)    # 1-D: whole
    store.save(str(tmp_path / "port"), 5, params, opt, layout=lay)
    d = tmp_path / "port" / "step_00000005"
    names = sorted(os.listdir(d))
    assert "opt__.v__stack__dense__mlp__w_up__row.npy" in names
    assert "opt__.v__ln_f__g.npy" in names
    assert not any(n.startswith("opt__.m") for n in names)

    jtmpl = jtransformer.abstract_params(jcfg, jlay)
    jp, jopt, _ = jstore.restore(
        str(tmp_path / "port"), 5, jtmpl, jlay,
        opt_state_abstract(jtmpl, jlay, jconfig.OptimConfig(**ada)))
    assert int(jopt.step) == 5 and jopt.m is None
    _same_bits(params, jp)
    _same_bits(opt.v, jopt.v)

    jstore.save(str(tmp_path / "jax"), 5, jp, jopt, layout=jlay)
    e = tmp_path / "jax" / "step_00000005"
    assert sorted(os.listdir(e)) == names
    for n in names:
        assert (d / n).read_bytes() == (e / n).read_bytes(), n
    tp, topt, _ = store.restore(
        str(tmp_path / "jax"), 5, ab,
        port_opt_abstract(ab, lay, config.OptimConfig(**ada)),
        device="cpu", layout=lay)
    assert topt.step == 5 and topt.m is None
    _same_bits(tp, jp)
    _same_bits(topt.v, jopt.v)
