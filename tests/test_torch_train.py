"""The port's training slice against the JAX package, on the CPU.

K3 (RMSNorm) and K2 (flash attention) run their plain versions here: each
is held against the reference's Pallas kernel in interpret mode and
against the jnp function the JAX model runs, forward and backward.  Then
the 3-D linear's and the embedding's autograd against the reference's
``custom_vjp``; the train loss and its whole gradient tree on reduced
tinyllama-1.1b (2 layers, d_model 256) within 1e-4 in f32, and the same
for reduced zamba2-1.2b (2 Mamba2 layers and the shared attention block,
remat on, sequences long enough that the SSD state crosses chunks), the
paper's model at head dim 48 and gemma-2b at head dim 256 (three AdamW
steps of each variant are in ``test_torch_train_adamw*.py``, which build
them with ``build_model`` and run ``three_adamw_steps``, as the MoE and
deepseek-v3 files do); and the copies (token stream,
configs, FLOPs formula, schedule, plan), the launcher and its refusals.
Inputs come from numpy with a seed; weights cross by
``convert.params_from_jax``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.configs.registry import ARCH_IDS, get as jget
from repro.core import linear3d as jlinear3d
from repro.core import ops3d as jops3d
from repro.core.params import init_params as jinit_params
from repro.core.plan import ParallelPlan as JPlan
from repro.core.topology import single_device_layout
from repro.data import pipeline as jpipeline
from repro.kernels import ops
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.optim.optimizers import make_schedule as jmake_schedule
from repro.optim.optimizers import opt_state_abstract
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import config
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core import ops3d
from repro_torch.core.params import tree_leaves, tree_map
from repro_torch.core.plan import ParallelPlan
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.kernels import flash_attention as k2
from repro_torch.kernels import rmsnorm as k3
from repro_torch.launch import train as train_launch
from repro_torch.models import registry, transformer
from repro_torch.obs.telemetry import first_nonfinite_path
from repro_torch.optim import adamw_init, make_schedule
from repro_torch.train.step import make_train_step

F32 = jnp.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's torch ops on one intra-op thread while this module runs,
    the worker's count restored after: the suite runs six workers on the
    machine's cores, and these small shapes slow down several-fold when
    every worker spreads each op over all of them.  The files that import
    it run the same way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# variant -> (arch, config change); the reduced zamba2 has the plan
# [mamba, mamba, attn], SSD chunk 64 and attention window 64.  The paper's
# model and gemma-2b keep their published head dims, 48 and 256 (which
# config.reduced would set to 64): 4/4 heads of 48 with LayerNorm, and 4/1
# heads of 256 (MQA) with the zero-centred RMSNorm
VARIANTS = {"mha": ("tinyllama-1.1b", {}),
            "gqa_remat": ("tinyllama-1.1b", {"n_kv": 2, "remat": True}),
            "zamba2": ("zamba2-1.2b", {"remat": True}),
            "paper_d48": ("paper-transformer", {"d_head": 48}),
            "gemma_d256": ("gemma-2b", {"d_head": 256})}
# arch -> sequence length of (the loss test, the AdamW test): zamba2's
# cross the SSD chunk ends at Q = 40 (4 chunks) and Q = 48 (2 chunks)
SEQ = {"tinyllama-1.1b": (32, 16), "zamba2-1.2b": (160, 96),
       "paper-transformer": (32, 16), "gemma-2b": (32, 16)}


def _np(a):
    return np.asarray(jax.device_get(a), np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ---------------------------------------------------------------------------
# K3 RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 8, 256), (16, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zc", [False, True])
def test_k3_plain_matches_pallas(shape, dtype, zc):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ops.pallas_rmsnorm(jnp.asarray(x, jd), jnp.asarray(g, jd),
                              zero_centered=zc, interpret=True)
    got = k3.rmsnorm(_t(x, td), _t(g, td), zero_centered=zc)
    assert got.dtype == td and tuple(got.shape) == shape
    tol = 1e-5 if dtype == "float32" else 2e-2      # tests/test_kernels.py
    assert _maxerr(got.float().numpy(), _np(want)) < tol


@pytest.mark.parametrize("zc", [False, True])
def test_k3_plain_backward_matches_jax_grad(zc):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    g = (rng.standard_normal(64) * 0.1 + 1).astype(np.float32)
    w = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jdx, jdg = jax.grad(
        lambda a, b: jnp.sum(jlinear3d.rmsnorm(a, b, zero_centered=zc) * w),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    tx, tg = _t(x).requires_grad_(), _t(g).requires_grad_()
    before = (k3.launches, k3.launches_bwd)
    (k3.rmsnorm(tx, tg, zero_centered=zc) * _t(w)).sum().backward()
    assert (k3.launches, k3.launches_bwd) == before   # CPU: no kernel
    assert _maxerr(tx.grad, _np(jdx)) <= 1e-5
    assert _maxerr(tg.grad, _np(jdg)) <= 1e-5


# ---------------------------------------------------------------------------
# K2 flash attention
# ---------------------------------------------------------------------------
def _attn_inputs(b, sq, sk, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _positions(b, sq, sk, off):
    q_pos = np.broadcast_to(off + np.arange(sq), (b, sq)).astype(np.int32)
    return q_pos, np.arange(sk, dtype=np.int32)


@pytest.mark.parametrize("shape", [(2, 64, 64, 4, 2, 32),
                                   (1, 64, 128, 4, 1, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["causal", "full", "window"])
def test_k2_plain_matches_pallas(shape, dtype, mode):
    b, sq, sk, hq, hkv, d = shape
    causal = mode != "full"
    window = 32 if mode == "window" else 0
    off = sk - sq if causal else 0                  # q_offset
    q, k, v = _attn_inputs(*shape)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ops.pallas_flash(*(jnp.asarray(a, jd) for a in (q, k, v)),
                            causal=causal, window=window, q_offset=off,
                            interpret=True)
    q_pos, k_pos = _positions(b, sq, sk, off)
    got, lse = k2.flash_attention(
        *(_t(a, td) for a in (q, k, v)), torch.from_numpy(q_pos),
        torch.from_numpy(k_pos), causal=causal, window=window)
    assert got.dtype == td and tuple(lse.shape) == (b, hq, sq)
    tol = 3e-5 if dtype == "float32" else 3e-2      # tests/test_kernels.py
    assert _maxerr(got.float().numpy(), _np(want)) < tol


@pytest.mark.parametrize("mode", ["causal", "full", "window"])
def test_k2_plain_matches_jnp_and_its_grad(mode):
    """Forward (out, (m, l, o)) and the plain backward against
    flash_attention_jnp and jax.grad of it, GQA, f32."""
    b, sq, sk, hq, hkv, d = 2, 48, 48, 4, 2, 16
    causal = mode != "full"
    window = 16 if mode == "window" else 0
    q, k, v = _attn_inputs(b, sq, sk, hq, hkv, d, seed=3)
    w = np.random.default_rng(4).standard_normal((b, sq, hq, d)) \
        .astype(np.float32)
    q_pos, k_pos = _positions(b, sq, sk, 0)
    kw = dict(causal=causal, window=window, chunk=16)

    def jloss(q_, k_, v_):
        out, _ = jblocks.flash_attention_jnp(q_, k_, v_, jnp.asarray(q_pos),
                                             jnp.asarray(k_pos), **kw)
        return jnp.sum(out * w)

    jout, jres = jblocks.flash_attention_jnp(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(q_pos),
        jnp.asarray(k_pos), **kw)
    tq, tk, tv = (_t(a) for a in (q, k, v))
    tqp, tkp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    out, res = k2.flash_attention_plain(tq, tk, tv, tqp, tkp, **kw)
    assert _maxerr(out, _np(jout)) <= 1e-5
    for got, want in zip(res, jres):
        assert got.shape == want.shape
        assert _maxerr(got, _np(want)) <= 1e-4 * (1 + np.abs(_np(want)).max())
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for t in (tq, tk, tv):
        t.requires_grad_()
    before = (k2.launches, k2.launches_bwd)
    got, _ = k2.flash_attention(tq, tk, tv, tqp, tkp, causal=causal,
                                window=window)
    (got * _t(w)).sum().backward()
    assert (k2.launches, k2.launches_bwd) == before   # CPU: no kernel
    for t, want in zip((tq, tk, tv), jgrads):
        assert _maxerr(t.grad, _np(want)) <= 1e-4


def test_kernels_refuse_other_devices():
    """The new wrappers, too, run their plain versions only for CPU
    tensors, or for meta tensors (the dry run's shapes); a mix of devices
    raises."""
    x, g = torch.zeros(2, 8), torch.ones(8)
    y = k3.rmsnorm(x.to("meta"), g.to("meta"))
    assert y.device.type == "meta" and y.shape == x.shape
    with pytest.raises(ValueError):
        k3.rmsnorm(x, g.to("meta"))
    q = torch.zeros(1, 4, 2, 16)
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        k2.flash_attention(q, q, q.to("meta"), pos[None], pos)


# ---------------------------------------------------------------------------
# Algorithm 2 and the embedding backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shard_f", [True, False])
def test_matmul3d_grad_matches_custom_vjp(shard_f):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    dc = rng.standard_normal((2, 8, 48)).astype(np.float32)
    jlay = single_device_layout("3d")
    y, vjp = jax.vjp(lambda a, b: jops3d.matmul3d(jlay, "y", "z", a, b,
                                                  shard_f=shard_f),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dc))
    lay = ParallelPlan().validate().build()
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = ops3d.matmul3d(lay, "y", "z", tx, tw, shard_f)
    ty.backward(_t(dc))
    assert _maxerr(ty.detach(), _np(y)) <= 1e-4
    assert _maxerr(tx.grad, _np(jdx)) <= 1e-4
    assert _maxerr(tw.grad, _np(jdw)) <= 1e-4


def test_embedding3d_grad_matches_custom_vjp():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    ids = rng.integers(0, 40, (2, 12)).astype(np.int32)
    ids[0, :3] = 7                                   # repeated ids add up
    dc = rng.standard_normal((2, 12, 16)).astype(np.float32)
    jlay = single_device_layout("3d")
    _, vjp = jax.vjp(lambda t: jops3d.embedding3d(jlay, "y", "z",
                                                  jnp.asarray(ids), t),
                     jnp.asarray(table))
    (jdt,) = vjp(jnp.asarray(dc))
    lay = ParallelPlan().validate().build()
    tt = _t(table).requires_grad_()
    ops3d.embedding3d(lay, "y", "z", torch.from_numpy(ids).long(),
                      tt).backward(_t(dc))
    assert _maxerr(tt.grad, _np(jdt)) <= 1e-4


# ---------------------------------------------------------------------------
# The slice: train loss, gradients, trajectory
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    """(jax cfg, port cfg, jax layout, jax f32 params, port params)."""
    return build_model(request.param)


def build_model(variant):
    """``model`` of one variant: the AdamW trajectory files build theirs
    with it."""
    arch, change = VARIANTS[variant]
    jcfg = dataclasses.replace(jconfig.reduced(jget(arch)), **change)
    tcfg = dataclasses.replace(config.reduced(get(arch)), **change)
    jlay = single_device_layout("3d")
    jp = jinit_params(jtransformer.abstract_params(jcfg, jlay),
                      jax.random.key(0), dtype=F32)
    return jcfg, tcfg, jlay, jp, params_from_jax(jax.device_get(jp), "cpu")


def _batch(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -5:] = -1                              # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_train_loss_and_grads_match_reference(model):
    jcfg, tcfg, jlay, jp, tp = model
    batch = _batch(tcfg.vocab, s=SEQ[tcfg.arch][0])
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtransformer.forward(jcfg, jlay, p, b, mode="train"),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    lay = ParallelPlan().validate().build()
    live = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, met = transformer.forward(
        tcfg, lay, live, {k: torch.from_numpy(v).long()
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
        assert _maxerr(g, want) <= 1e-4 * scale, (path, _maxerr(g, want),
                                                  scale)
        n += 1
    assert n == len(jax.tree.leaves(jg))


def three_adamw_steps(model, mb, seq=None, metrics=("loss", "gnorm"),
                      stubs=None, optimizer="adamw"):
    """Three AdamW steps of ``model`` (``build_model``'s tuple) at ``mb``
    microbatches against the JAX package's: each step's ``metrics`` and lr,
    then every parameter, within 1e-2.  The AdamW trajectory test of each
    family calls it; ``seq`` defaults to the arch's AdamW length in
    ``SEQ``; ``stubs(b, seed)`` adds a modality family's float arrays to
    each batch; ``optimizer="adafactor"`` takes Adafactor's steps
    instead, its state from ``opt_state_abstract``."""
    jcfg, tcfg, jlay, jp, tp = model
    opt = dict(name=optimizer, lr=3e-3, warmup=2, total_steps=3)
    jlay_mb = JPlan(microbatches=mb).build()
    jstate = jinit_params(opt_state_abstract(
        jtransformer.abstract_params(jcfg, jlay_mb), jlay_mb,
        jconfig.OptimConfig(**opt)), jax.random.key(1))
    jstep = jax.jit(jmake_train_step(jcfg, jlay_mb,
                                     jconfig.OptimConfig(**opt)))
    lay = ParallelPlan(microbatches=mb).validate(global_batch=4).build()
    step = make_train_step(tcfg, lay, config.OptimConfig(**opt))
    tparams = tree_map(lambda t: t.clone(), tp)
    tstate = adamw_init(tparams, lay, transformer.abstract_params(tcfg, lay),
                        config.OptimConfig(**opt))
    jparams = jp
    for s in range(3):
        batch = _batch(tcfg.vocab, b=4, s=seq or SEQ[tcfg.arch][1],
                       seed=10 + s)
        if stubs is not None:
            batch.update(stubs(4, 10 + s))
        jparams, jstate, jmet = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tparams, tstate, met = step(
            tparams, tstate, {k: torch.from_numpy(v) if v.dtype.kind == "f"
                              else torch.from_numpy(v).long()
                              for k, v in batch.items()})
        for key in metrics:
            assert abs(met[key].item() - float(jmet[key])) <= 1e-2, key
        assert abs(met["lr"] - float(jmet["lr"])) <= 1e-9
    assert tstate.step == 3
    jg = jax.device_get(jparams)
    for path, t in _paths(tparams):
        assert _maxerr(t, np.asarray(_at(jg, path), np.float32)) <= 1e-2, path


def test_train_launcher_on_cpu(capsys):
    _launch_on_cpu(capsys, "tinyllama-1.1b")


def test_train_launcher_trains_hybrid_on_cpu(capsys):
    """zamba2 is no longer refused: reduced, 128 steps of sequence, so the
    SSD state crosses two chunks of 64."""
    _launch_on_cpu(capsys, "zamba2-1.2b", seq=128)


def _launch_on_cpu(capsys, arch, seq=64):
    out = train_launch.main(["--arch", arch, "--reduced",
                             "--device", "cpu", "--steps", "3", "--batch",
                             "4", "--seq", str(seq), "--log-every", "1",
                             "--telemetry", ""])
    text = capsys.readouterr().out
    assert f"arch={arch}" in text and "plan={" in text
    assert "params: " in text and "done: first loss" in text
    assert text.count(" loss=") == 3 and "gnorm=" in text
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))


# the launcher's flags, each refused (NotImplementedError pointing at
# ROADMAP.md, or the reference's ValueError) or run; the cases that now
# run keep their places, so that each keeps its name
LAUNCHER_CASES = [
    (["--dp", "2", "--zero", "1", "--host-devices", "2"], "runs"),
    (["--model", "2", "--pp", "2", "--microbatch", "2", "--host-devices",
      "4"], "runs"),
    (["--arch", "zamba2-1.2b", "--pp", "2", "--microbatch", "2"],
     NotImplementedError),
    (["--pp", "2", "--layers", "1"], "too shallow"),
    (["--strategy", "1d", "--arch", "mixtral-8x7b", "--model", "4",
      "--host-devices", "4"], "runs"),
    (["--overlap"], "runs"), (["--zero", "1"], ValueError),
    (["--optimizer", "adafactor"], "runs"),
    (["--dp", "2", "--model", "4", "--cube", "2,2,1", "--host-devices", "8"],
     "resumes"),
    (["--arch", "mixtral-8x7b", "--model", "8", "--host-devices", "8"],
     "runs"),
    (["--arch", "zamba2-1.2b", "--dp", "2"], NotImplementedError),
    (["--arch", "deepseek-v3-671b", "--model", "8"], NotImplementedError),
    (["--arch", "deepseek-v3-671b", "--optimizer", "adafactor"], "runs"),
    (["--arch", "mixtral-8x7b", "--pp", "2"], NotImplementedError),
    (["--arch", "moonshot-v1-16b-a3b", "--optimizer", "adafactor"], "runs"),
    (["--arch", "internvl2-2b", "--pp", "2"], NotImplementedError),
    (["--arch", "whisper-medium", "--zero", "1"], ValueError),
    (["--overlap", "--strategy", "1d", "--model", "4"], "overlap 3d only")]


@pytest.mark.parametrize("flags,outcome", [
    pytest.param(f, o, id=f"flags{i}") for i, (f, o) in
    enumerate(LAUNCHER_CASES)])
def test_train_launcher_refusals(flags, outcome, tmp_path, capsys):
    """What the port does not carry raises NotImplementedError pointing at
    ROADMAP.md (pp above one device for a family but the dense one among
    it, deepseek-v3's MLA above one device); ``--zero 1`` at one device
    the reference's ValueError, a stage with no layer the reference's,
    ``--overlap`` beside a strategy other than 3d the reference's.  ZeRO
    above one device, pp 2 over a cube of 2, ``--overlap`` (the chunked
    islands), Adafactor (every family) and mixtral across ranks (1d(4)
    and the cube (2, 2, 2): expert parallelism) run a step; at dp 2 x
    (2, 2, 1)
    ``--ckpt-dir`` saves across the ranks and a second run resumes from
    it."""
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
            "--steps", "1", "--batch", "8", "--seq", "32"] + flags
    if outcome is NotImplementedError:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            train_launch.main(argv)
    elif outcome is ValueError:
        with pytest.raises(ValueError, match="requires a data-parallel "
                           "degree > 1"):
            train_launch.main(argv)
    elif outcome == "too shallow":
        with pytest.raises(ValueError, match="every pipeline stage needs "
                           "at least one block"):
            train_launch.main(argv)
    elif outcome == "overlap 3d only":
        with pytest.raises(ValueError, match="only wired into the 3-D "
                           "islands, got strategy='1d'"):
            train_launch.main(argv)
    elif outcome == "runs":
        out = train_launch.main(argv)
        text = capsys.readouterr().out
        assert "done: first loss" in text and np.isfinite(out["losses"][0])
        if "--zero" in flags:
            assert "'zero_stage': 1" in text
        if "--pp" in flags:
            assert "'pp': 2" in text and "ranks=4" in text
        if "--overlap" in flags:
            assert "'overlap': True, 'overlap_chunks': 4" in text
    else:
        ck = str(tmp_path / "ck")
        ckpt = ["--ckpt-dir", ck, "--ckpt-every", "1"]
        out = train_launch.main(argv + ckpt)
        assert f"saved {os.path.join(ck, 'step_00000001')}" in \
            capsys.readouterr().out
        index = json.loads((tmp_path / "ck" / "step_00000001" /
                            "index.json").read_text())
        assert index["meta"]["zero_stage"] == 1
        assert index["meta"]["mesh"]["dp"] == 2
        out = train_launch.main(argv[:argv.index("--steps") + 1] + ["2"]
                                + argv[argv.index("--steps") + 2:] + ckpt)
        text = capsys.readouterr().out
        assert f"restoring step 1 from {ck}" in text
        assert out["start"] == 1 and len(out["losses"]) == 1
        assert np.isfinite(out["losses"][0])


def test_train_launcher_refuses_nccl_sharing_a_card(monkeypatch):
    """NCCL refuses two ranks on one device; the launcher raises before
    any rank starts, and never switches the backend."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1",
            "--model", "2", "--host-devices", "2", "--backend", "nccl"]
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        train_launch.main(argv)
    with pytest.raises(ValueError, match="nccl takes CUDA ranks"):
        train_launch.main(argv + ["--device", "cpu"])


def test_train_launcher_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_launch.main(["--arch", "tinyllama-1.1b", "--reduced",
                           "--steps", "1"])


# ---------------------------------------------------------------------------
# The copies
# ---------------------------------------------------------------------------
def test_token_stream_matches_reference(tmp_path):
    cfg = get("tinyllama-1.1b")
    jcfg = jget("tinyllama-1.1b")
    shape = config.ShapeConfig("t", 32, 4, "train")
    jshape = jconfig.ShapeConfig("t", 32, 4, "train")
    path = str(tmp_path / "toks.npy")
    jpipeline.write_packed_tokens(
        path, np.random.default_rng(0).integers(0, 70000, 300))
    for kind in ("synthetic", "file"):
        got = TokenStream(cfg, shape, DataConfig(kind=kind, path=path,
                                                 seed=3))
        want = jpipeline.TokenStream(jcfg, single_device_layout("3d"), jshape,
                                     jpipeline.DataConfig(kind=kind,
                                                          path=path, seed=3))
        for _ in range(3):
            g, w = next(got), next(want)
            for key in ("tokens", "labels"):
                assert g[key].dtype == torch.int64
                np.testing.assert_array_equal(g[key].numpy(),
                                              np.asarray(w[key]))


def test_config_copies_match_reference():
    for cls in ("OptimConfig", "ShapeConfig"):
        got = [(f.name, f.default) for f in
               dataclasses.fields(getattr(config, cls))]
        want = [(f.name, f.default) for f in
                dataclasses.fields(getattr(jconfig, cls))]
        assert got == want, cls
    for arch in ARCH_IDS:
        for red in (False, True):
            c, jc = get(arch), jget(arch)
            if red:
                c, jc = config.reduced(c), jconfig.reduced(jc)
            assert c.n_params() == jc.n_params(), arch
            assert c.n_active_params() == jc.n_active_params(), arch
            for s in (1, 1024, 4096):
                assert registry.train_flops_per_token(c, s) == \
                    jregistry.train_flops_per_token(jc, s), arch


def test_mesh_copies_match_reference():
    """``launch/mesh.py`` against the reference's: the per-shape axis
    policy equal; rank r's coordinates its place in the reference's
    row-major device grid (``topology.make_mesh``), and its layout's
    sizes the framework mesh's."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        for multi_pod in (False, True):
            assert mesh.shape_layout_args(name, multi_pod) == \
                jmesh.shape_layout_args(name, multi_pod)
    for kw in ({}, {"multi_pod": True, "n_pp": 2}, {"cube": (4, 2, 2)}):
        lay = mesh.make_framework_layout(**kw)
        grid = np.arange(lay.n_devices).reshape(tuple(lay.sizes.values()))
        for r in (0, 1, 37, lay.n_devices - 1):
            got = mesh.make_framework_layout(rank=r, **kw).coords
            assert tuple(got.values()) == tuple(np.argwhere(grid == r)[0])
    assert mesh.make_framework_layout().cube == (2, 2, 4)
    assert mesh.make_framework_layout(multi_pod=True, n_pp=2).sizes == {
        "pod": 2, "dp": 8, "pp": 2, "x": 2, "y": 2, "z": 4}


@pytest.mark.parametrize("sched", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(sched):
    kw = dict(lr=1e-3, warmup=5, total_steps=20, schedule=sched)
    got = make_schedule(config.OptimConfig(**kw))
    want = jmake_schedule(jconfig.OptimConfig(**kw))
    for step in (0, 1, 4, 5, 6, 12, 20, 25):
        assert abs(got(step) - float(want(jnp.int32(step)))) <= 1e-9


def test_train_plan_validation_matches_reference():
    assert ParallelPlan().validate(n_layers=2, global_batch=4,
                                   mode="train") is not None
    for kw, vkw in (({"n_stages": 4}, {"n_layers": 2}),
                    ({"microbatches": 3}, {"global_batch": 4}),
                    ({"n_stages": 2}, {"n_layers": 2, "mode": "serve"})):
        with pytest.raises(ValueError) as want:
            JPlan(**kw).validate(**vkw)
        with pytest.raises(ValueError) as got:
            ParallelPlan(**kw).validate(**vkw)
        assert str(got.value) == str(want.value)
    lay = ParallelPlan(n_stages=2, microbatches=2).validate(
        n_layers=2).build(1)
    jlay = JPlan(n_stages=2, microbatches=2).validate(n_layers=2)
    assert lay.sizes["pp"] == jlay.n_stages == 2 and lay.microbatches == 2
    assert lay.index("pp") == 1 and lay.stage_bounds(2) == ((0, 1), (1, 2))


def test_nonfinite_sentinel_names_the_leaf():
    tree = {"embed": torch.zeros(3), "stack": {"dense": {
        "wq": torch.zeros(2), "wk": torch.tensor([0.0, float("nan")])}}}
    assert first_nonfinite_path(tree) == "['stack']['dense']['wk']"
    tree["stack"]["dense"]["wk"] = torch.ones(2)
    assert first_nonfinite_path(tree) is None
