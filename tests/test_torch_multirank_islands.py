"""The port's 3-D islands on 8 ranks against the JAX package's on 8 host
devices, on the cube (2, 2, 2) in f32.

The ranks are 8 gloo processes (``launch/ranks.spawn_local``, one CPU
thread each); the JAX side runs in its own subprocess with 8 host
devices, as ``tests/test_multidev.py`` does, at the same time.  Inputs
come from numpy with a seed and reach both through ``.npz`` files in
``tmp_path``; each rank writes its shards, and the test holds each one
against the JAX array's block at the rank's mesh coordinates
(``core.params.shard``), within 1e-4 of the array's largest value, and
the matmuls' also against the dense oracle (``tests/test_multidev.py``'s
battery, ``:28-61``).  Checked: ``matmul3d`` (forward, dx, dw),
``matmul3d_noswap``, ``matmul3d_repc``, ``embedding3d`` (forward and the
table's gradient), the attention island (kv heads split and replicated
over the head axis), RMSNorm (K3's two phases) and LayerNorm over the
split hidden dim with their gains' gradients after the train step's leaf
sync, the chunked vocab-parallel head loss (K = 2) with its gradients,
and ``comm``'s tiled gather and reduce-scatter over the axis tuples
``("y", "x")`` and ``("z", "y")``.

Each rank also runs the battery with one fault planted at a time, and
each fault must fail it: a tuple-axis group in global-rank order, a loss
``psum`` whose backward all-reduces, and the attention's q positions
without their offset.  ``run_jax``, ``run_ranks`` and ``held`` serve the
other multi-rank files too.

Last, the train launcher itself: ``--host-devices 8`` at ``--model 8``
and at ``--dp 2 --model 4`` trains reduced tinyllama-1.1b in bf16 on 8
gloo ranks, each step's loss within 3e-2 (the limit of
``tests/test_multidev.py:92``) of the one-device run's.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core.params import shard
from repro_torch.core.topology import make_layout
from repro_torch.launch import train as train_launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
# layout name -> make_layout's arguments (tests/test_multidev.py:66-67)
LAYOUTS = {"cube": dict(n_pod=1, n_dp=1, n_model=8),
           "dp2": dict(n_pod=1, n_dp=2, n_model=4, cube=(2, 2, 1))}
FAULTS = ("tuple_order", "loss_psum_allreduce", "q_pos_offset")


# XLA's CPU backend without LLVM's costly passes: the programs are small
# and run once, so most of their time is compilation
XLA_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                    "--xla_llvm_disable_expensive_passes=true")


def run_jax(script: str, tmp_path, name: str = "jax"):
    """Start ``script`` in a subprocess with 8 JAX host devices (MR_DIR
    names ``tmp_path``); its output goes to ``tmp_path/<name>.log``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               + XLA_FAST_COMPILE,
               PYTHONPATH=os.path.join(ROOT, "src"), MR_DIR=str(tmp_path))
    path = tmp_path / f"{name}.log"
    log = open(path, "w")
    return subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=log, stderr=subprocess.STDOUT), log, path


def wait_jax(run, timeout: float = 300) -> str:
    """Wait for ``run_jax``'s subprocess; its output, which must end
    well."""
    proc, log, path = run
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = path.read_text()
    assert proc.returncode == 0, text[-4000:]
    assert "JAX-OK" in text, text[-4000:]
    return text


def run_ranks(script: str, tmp_path, timeout: float = 300):
    """Run ``script`` as 8 gloo ranks; MR_DIR names ``tmp_path``."""
    from repro_torch.launch.ranks import spawn_local
    env = dict(os.environ, MR_DIR=str(tmp_path))
    return spawn_local([sys.executable, "-c", script], WORLD,
                       timeout=timeout, env=env, cpu_threads=1,
                       workdir=str(tmp_path))


def layout_of(name: str, rank: int, layouts=LAYOUTS):
    """Rank ``rank``'s layout of ``layouts[name]`` (make_layout's
    arguments; the strategy 3d unless they name one)."""
    return make_layout(rank=rank, **dict({"strategy": "3d"}, **layouts[name]))


def held(got, want, spec, lay, tol=1e-4, what=""):
    """``got`` (a rank's shard) against the block of the global ``want``
    at the rank's coordinates, within ``tol`` of ``want``'s largest
    value."""
    import torch
    block = shard(torch.from_numpy(np.asarray(want, np.float32)), spec,
                  lay).numpy()
    got = np.asarray(got, np.float32)
    assert got.shape == block.shape, (what, got.shape, block.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - block).max()) if got.size else 0.0
    return err <= tol * scale, (what, err, scale)


BATCH = ("pod", "dp", "x")
B, S, H, F, R, V = 4, 8, 16, 24, 12, 32
VH = 64000                          # the head's vocab: K = 2 loss chunks
NH, DH = 4, 8
# input -> spec on the (2, 2, 2) cube
IN_SPECS = {
    "x": (BATCH, "y", "z"), "w": ("z", ("y", "x")), "dc": (BATCH, "z", "y"),
    "wn": ("z", None), "dcn": (BATCH, "y", None),
    "xr": (BATCH, "y", None), "wr": (None, ("y", "x")),
    "ids": (BATCH, "y"), "table": ("y", "z"), "dce": (BATCH, "y", "z"),
    "g": ("z",), "b": ("z",), "dcx": (BATCH, "y", "z"),
    "wh": ("z", ("y", "x")), "lab": (BATCH, "z"), "mask": (BATCH, "z"),
    "q": (BATCH, "z", "y", None), "k2": (BATCH, "z", "y", None),
    "v2": (BATCH, "z", "y", None), "k1": (BATCH, "z", None, None),
    "v1": (BATCH, "z", None, None), "dq": (BATCH, "z", "y", None),
    "t": (("pod", "dp", "pp", "x", "y", "z"), None)}
# output -> spec; each rank saves its shard under these names
OUT_SPECS = {
    "mm_y": (BATCH, "z", "y"), "mm_dx": (BATCH, "y", "z"),
    "mm_dw": ("z", ("y", "x")),
    "ns_y": (BATCH, "y", None), "ns_dx": (BATCH, "y", "z"),
    "ns_dw": ("z", None),
    "rc_y": (BATCH, "z", "y"), "rc_dx": (BATCH, "y", None),
    "rc_dw": (None, ("y", "x")),
    "em_y": (BATCH, "y", "z"), "em_dt": ("y", "z"),
    "rms0_y": (BATCH, "y", "z"), "rms0_dx": (BATCH, "y", "z"),
    "rms0_dg": ("z",), "rms1_y": (BATCH, "y", "z"),
    "rms1_dx": (BATCH, "y", "z"), "rms1_dg": ("z",),
    "ln_y": (BATCH, "y", "z"), "ln_dx": (BATCH, "y", "z"),
    "ln_dg": ("z",), "ln_db": ("z",),
    "loss": (), "loss_dx": (BATCH, "y", "z"), "loss_dw": ("z", ("y", "x")),
    "at2_o": (BATCH, "z", "y", None), "at2_dq": (BATCH, "z", "y", None),
    "at2_dk": (BATCH, "z", "y", None), "at2_dv": (BATCH, "z", "y", None),
    "at1_o": (BATCH, "z", "y", None), "at1_dq": (BATCH, "z", "y", None),
    "at1_dk": (BATCH, "z", None, None), "at1_dv": (BATCH, "z", None, None),
    "ag_yx": ("z", None), "rs_yx": ("z", ("y", "x")),
    "ag_zy": ("x", None), "rs_zy": ("x", ("z", "y"))}


def _inputs(path):
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lab = rng.integers(0, VH, (B, S)).astype(np.int64)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    np.savez(path, x=f(B, S, H), w=f(H, F), dc=f(B, S, F), wn=f(H, R),
             dcn=f(B, S, R), xr=f(B, S, R), wr=f(R, F),
             ids=rng.integers(0, V, (B, S)).astype(np.int64),
             table=f(V, H), dce=f(B, S, H), g=1 + 0.1 * f(H),
             b=0.1 * f(H), dcx=f(B, S, H), wh=0.3 * f(H, VH), lab=lab,
             mask=mask, q=f(B, S, NH, DH), k2=f(B, S, 2, DH),
             v2=f(B, S, 2, DH), k1=f(B, S, 1, DH), v1=f(B, S, 1, DH),
             dq=f(B, S, NH, DH), t=f(WORLD * 4, 8))


JAX_SCRIPT = r"""
import dataclasses, os
import numpy as np
import jax, jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.config import reduced
from repro.configs.registry import get
from repro.core import linear3d, ops3d
from repro.core.compat import shard_map
from repro.core.topology import make_layout
from repro.models import blocks, transformer

d = os.environ["MR_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
lay = make_layout(1, 1, 8, "3d")
assert lay.cube == (2, 2, 2) and len(jax.devices()) == 8
BATCH = ("pod", "dp", "x")
SPECS = %(specs)r


def put(name, value=None):
    a = jnp.asarray(inp[name] if value is None else value)
    spec = P(*[tuple(e) if isinstance(e, list) else e
               for e in SPECS[name]])
    return jax.device_put(a, lay.sharding(spec))


out = {}
x, w, dc = put("x"), put("w"), put("dc")
f = lambda a, b: jnp.sum(ops3d.matmul3d(lay, "y", "z", a, b) * dc)
out["mm_y"] = jax.jit(lambda a, b: ops3d.matmul3d(lay, "y", "z", a, b))(x, w)
out["mm_dx"], out["mm_dw"] = jax.jit(jax.grad(f, (0, 1)))(x, w)
wn, dcn = put("wn"), put("dcn")
f = lambda a, b: jnp.sum(ops3d.matmul3d_noswap(lay, "y", "z", a, b) * dcn)
out["ns_y"] = jax.jit(lambda a, b: ops3d.matmul3d_noswap(
    lay, "y", "z", a, b))(x, wn)
out["ns_dx"], out["ns_dw"] = jax.jit(jax.grad(f, (0, 1)))(x, wn)
xr, wr = put("xr"), put("wr")
f = lambda a, b: jnp.sum(ops3d.matmul3d_repc(lay, "y", "z", a, b) * dc)
out["rc_y"] = jax.jit(lambda a, b: ops3d.matmul3d_repc(
    lay, "y", "z", a, b))(xr, wr)
out["rc_dx"], out["rc_dw"] = jax.jit(jax.grad(f, (0, 1)))(xr, wr)
ids, table, dce = put("ids"), put("table"), put("dce")
out["em_y"] = jax.jit(lambda i, t: ops3d.embedding3d(
    lay, "y", "z", i, t))(ids, table)
out["em_dt"] = jax.jit(jax.grad(lambda t: jnp.sum(ops3d.embedding3d(
    lay, "y", "z", ids, t) * dce)))(table)
g, b, dcx = put("g"), put("b"), put("dcx")
for zc in (0, 1):
    fn = lambda a, gg: linear3d.rmsnorm(a, gg, zero_centered=bool(zc))
    out[f"rms{zc}_y"] = jax.jit(fn)(x, g)
    out[f"rms{zc}_dx"], out[f"rms{zc}_dg"] = jax.jit(jax.grad(
        lambda a, gg: jnp.sum(fn(a, gg) * dcx), (0, 1)))(x, g)
out["ln_y"] = jax.jit(linear3d.layernorm)(x, g, b)
out["ln_dx"], out["ln_dg"], out["ln_db"] = jax.jit(jax.grad(
    lambda a, gg, bb: jnp.sum(linear3d.layernorm(a, gg, bb) * dcx),
    (0, 1, 2)))(x, g, b)
cfg = dataclasses.replace(reduced(get("tinyllama-1.1b")), vocab=%(vh)d,
                          d_model=%(h)d)
assert transformer.head_loss_chunks(cfg, lay, %(s)d) == 2
wh, lab, mask = put("wh"), put("lab"), put("mask")
lossf = lambda a, ww: transformer.chunked_head_loss(
    cfg, lay, transformer.entry_dirs(), a, lab, mask, ww)
out["loss"] = jax.jit(lossf)(x, wh)
out["loss_dx"], out["loss_dw"] = jax.jit(jax.grad(lossf, (0, 1)))(x, wh)
q, dq = put("q"), put("dq")
for nkv in (2, 1):
    acfg = dataclasses.replace(reduced(get("tinyllama-1.1b")), n_heads=4,
                               n_kv=nkv, d_head=%(dh)d)
    k, v = put(f"k{nkv}"), put(f"v{nkv}")
    fn = lambda a, kk, vv: blocks.attention(
        lay, acfg, transformer.entry_dirs(), a, kk, vv, causal=True)
    out[f"at{nkv}_o"] = jax.jit(fn)(q, k, v)
    (out[f"at{nkv}_dq"], out[f"at{nkv}_dk"],
     out[f"at{nkv}_dv"]) = jax.jit(jax.grad(
        lambda a, kk, vv: jnp.sum(fn(a, kk, vv) * dq), (0, 1, 2)))(q, k, v)
t = put("t")
allax = ("pod", "dp", "pp", "x", "y", "z")
for name, ax, rest in (("yx", ("y", "x"), "z"), ("zy", ("z", "y"), "x")):
    sm = lambda body, o: jax.jit(shard_map(
        body, mesh=lay.mesh, in_specs=(P(allax, None),), out_specs=o,
        check_vma=False))
    # each device's (4, 8) block: the gather of its first two columns
    # over ax, and the reduce-scatter of the whole block over ax
    out["ag_" + name] = sm(lambda a: lax.all_gather(
        a[:, :2], ax, axis=1, tiled=True), P(rest, None))(t)
    out["rs_" + name] = sm(lambda a: lax.psum_scatter(
        a, ax, scatter_dimension=1, tiled=True), P(rest, ax))(t)
np.savez(os.path.join(d, "jax.npz"),
         **{k: np.asarray(jax.device_get(v), np.float32)
            for k, v in out.items()})
print("JAX-OK")
"""

RANK_SCRIPT = r"""
import dataclasses, os
import numpy as np
import torch
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.core import comm, linear3d, ops3d
from repro_torch.core.params import Param, shard
from repro_torch.core.topology import make_layout
from repro_torch.launch import ranks
from repro_torch.models import blocks, transformer
from repro_torch.train.step import leaf_sync_axes

torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
lay = comm.init(make_layout(1, 1, 8, "3d", rank=me.rank), "gloo")
d = os.environ["MR_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
SPECS = %(specs)r


def loc(name, grad=False):
    t = shard(torch.from_numpy(inp[name]), SPECS[name], lay)
    return t.clone().requires_grad_(grad) if grad else t


def battery():
    out = {}
    x, w = loc("x", True), loc("w", True)
    y = ops3d.matmul3d(lay, "y", "z", x, w)
    (y * loc("dc")).sum().backward()
    out.update(mm_y=y, mm_dx=x.grad, mm_dw=w.grad)
    x, wn = loc("x", True), loc("wn", True)
    y = ops3d.matmul3d_noswap(lay, "y", "z", x, wn)
    (y * loc("dcn")).sum().backward()
    out.update(ns_y=y, ns_dx=x.grad, ns_dw=wn.grad)
    xr, wr = loc("xr", True), loc("wr", True)
    y = ops3d.matmul3d_repc(lay, "y", "z", xr, wr)
    (y * loc("dc")).sum().backward()
    out.update(rc_y=y, rc_dx=xr.grad, rc_dw=wr.grad)
    table = loc("table", True)
    y = ops3d.embedding3d(lay, "y", "z", loc("ids"), table)
    (y * loc("dce")).sum().backward()
    out.update(em_y=y, em_dt=table.grad)
    gsync = leaf_sync_axes(Param((%(h)d,), spec=("z",)), lay)
    for zc in (0, 1):
        x, g = loc("x", True), loc("g", True)
        y = linear3d.rmsnorm(x, g, zero_centered=bool(zc), layout=lay,
                             axis="z")
        (y * loc("dcx")).sum().backward()
        out.update({f"rms{zc}_y": y, f"rms{zc}_dx": x.grad,
                    f"rms{zc}_dg": comm.psum(lay, g.grad, gsync)})
    x, g, b = loc("x", True), loc("g", True), loc("b", True)
    y = linear3d.layernorm(x, g, b, layout=lay, axis="z")
    (y * loc("dcx")).sum().backward()
    out.update(ln_y=y, ln_dx=x.grad, ln_dg=comm.psum(lay, g.grad, gsync),
               ln_db=comm.psum(lay, b.grad, gsync))
    cfg = dataclasses.replace(reduced(get("tinyllama-1.1b")), vocab=%(vh)d,
                              d_model=%(h)d)
    x, wh = loc("x", True), loc("wh", True)
    loss = transformer.chunked_head_loss(
        cfg, lay, transformer.entry_dirs(), x, loc("lab"), loc("mask"), wh)
    loss.backward()
    out.update(loss=loss, loss_dx=x.grad, loss_dw=wh.grad)
    for nkv in (2, 1):
        acfg = dataclasses.replace(reduced(get("tinyllama-1.1b")),
                                   n_heads=4, n_kv=nkv, d_head=%(dh)d)
        q, k, v = loc("q", True), loc(f"k{nkv}", True), loc(f"v{nkv}", True)
        o = blocks.attention(lay, acfg, transformer.entry_dirs(), q, k, v,
                             causal=True)
        (o * loc("dq")).sum().backward()
        out.update({f"at{nkv}_o": o, f"at{nkv}_dq": q.grad,
                    f"at{nkv}_dk": k.grad, f"at{nkv}_dv": v.grad})
    t = loc("t")
    for name, ax in (("yx", ("y", "x")), ("zy", ("z", "y"))):
        out["ag_" + name] = comm.all_gather(lay, t[:, :2], ax, dim=1)
        out["rs_" + name] = comm.psum_scatter(lay, t, ax, dim=1)
    return {k: v.detach().numpy() for k, v in out.items()}


PLANT = {
    "tuple_order": (comm.Groups, "order",
                    lambda self, axes: (self.group[frozenset(axes)], None)),
    "loss_psum_allreduce": (comm, "psum_id", comm.psum_ad),
    "q_pos_offset": (blocks, "seq_offset", lambda layout, dirs, s: 0),
}
for fault in ("none",) + tuple(PLANT):
    if fault != "none":
        obj, attr, fake = PLANT[fault]
        real = getattr(obj, attr)
        setattr(obj, attr, fake)
    res = battery()
    if fault != "none":
        setattr(obj, attr, real)
    np.savez(os.path.join(d, f"rank{me.rank}_{fault}.npz"), **res)
print("RANK-OK")
"""


def _fill(script):
    return script % {"specs": {**IN_SPECS}, "vh": VH, "h": H, "s": S,
                     "dh": DH}


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    """{variant: [rank's outputs]} for the clean run and each fault, and
    the JAX outputs."""
    tmp = tmp_path_factory.mktemp("islands")
    _inputs(tmp / "inputs.npz")
    jax_run = run_jax(_fill(JAX_SCRIPT), tmp)
    try:
        run_ranks(_fill(RANK_SCRIPT), tmp)
    finally:
        wait_jax(jax_run)
    want = dict(np.load(tmp / "jax.npz"))
    got = {v: [dict(np.load(tmp / f"rank{r}_{v}.npz"))
               for r in range(WORLD)] for v in ("none",) + FAULTS}
    inputs = dict(np.load(tmp / "inputs.npz"))
    return want, got, inputs


def _failures(want, ranks_out, names):
    bad = []
    for r, res in enumerate(ranks_out):
        lay = layout_of("cube", r)
        for name in names:
            ok, info = held(res[name], want[name], OUT_SPECS[name], lay,
                            what=f"rank {r} {name}")
            if not ok:
                bad.append(info)
    return bad


def test_islands_match_jax_shards(battery):
    want, got, _ = battery
    assert set(OUT_SPECS) == set(want)
    assert not _failures(want, got["none"], sorted(OUT_SPECS))


def test_matmuls_match_dense_oracle(battery):
    """The ranks' shards against the dense oracle of
    ``tests/test_multidev.py``'s battery."""
    _, got, i = battery
    x, w, dc = i["x"], i["w"], i["dc"]
    oracle = {"mm_y": x @ w, "mm_dx": dc @ w.T,
              "mm_dw": x.reshape(-1, H).T @ dc.reshape(-1, F),
              "ns_y": x @ i["wn"], "rc_y": i["xr"] @ i["wr"]}
    bad = _failures(oracle, got["none"], sorted(oracle))
    assert not bad, bad


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(battery, fault):
    want, got, _ = battery
    assert _failures(want, got[fault], sorted(OUT_SPECS)), fault


# ---------------------------------------------------------------------------
# The train launcher on 8 CPU ranks
# ---------------------------------------------------------------------------
def _losses(capsys, extra):
    out = train_launch.main(["--arch", "tinyllama-1.1b", "--reduced",
                             "--device", "cpu", "--steps", "3", "--batch",
                             "4", "--seq", "64", "--log-every", "1",
                             *extra])
    text = capsys.readouterr().out
    assert text.count(" loss=") == 3 and "done: first loss" in text
    return np.array(out["losses"])


@pytest.fixture(scope="module")
def one_device_losses():
    return np.array(train_launch.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
        "--steps", "3", "--batch", "4", "--seq", "64", "--log-every",
        "1"])["losses"])


@pytest.mark.parametrize("flags", [["--model", "8"],
                                   ["--dp", "2", "--model", "4"]])
def test_launcher_trains_on_8_cpu_ranks(capsys, one_device_losses, flags):
    got = _losses(capsys, [*flags, "--host-devices", "8"])
    assert len(got) == 3 and np.all(np.isfinite(got))
    assert np.abs(got - one_device_losses).max() <= 3e-2, (
        got, one_device_losses)
