"""The paper's 1-D (Megatron) and 2-D (SUMMA) baselines in the port against
the JAX package's, on 8 ranks at the two layouts of
``tests/test_multidev.py:68-69``: ``1d(4)`` = dp 2 x cube (1, 1, 4) and
``2d(q2)`` = dp 2 x cube (1, 2, 2), in f32.

One JAX subprocess on 8 host devices and one world of 8 gloo ranks run at
once (``test_torch_multirank_islands.py``'s machinery); each rank's shards
are held against the JAX arrays' blocks at its coordinates, within 1e-4 of
the array's largest value.  Checked:

  * ``linear1d_col`` and ``linear1d_row`` (forward, dx, dw) against JAX
    and against the dense oracle;
  * ``matmul2d``: the forward against JAX and the oracle, the backward
    equal to JAX's, and both packages' dx and dw away from the oracle by
    more than 1.0 (ROADMAP.md Queue 3, fault 6: the reference's 2-D
    backward is wrong off the grid's diagonal, and the port copies it);
  * each lone island's bytes on ``comm``'s counter against the count
    worked out by hand from its collectives (``HAND_BYTES``);
  * a 1-D norm gain's gradient after the train step's leaf sync, and the
    parent's rule, which also summed it over 'z' (4x too large): planted,
    it must fail;
  * the comm check: the port's analytic formulas equal the reference's
    and ``benchmarks/analytic.py``'s, and the measured ordering 3d < 2d <
    1d holds for a reduced paper-transformer in the wide window
    (``d_ff = d_model``, t = 2h tokens) at p = 8, 4, 8: the 1d and 3d
    plans in the ranks' world, the 2d plan in a world of 4 beside it
    (``commcheck.check``).

Last, the train launcher at ``--strategy 1d`` and ``2d`` on 8 CPU ranks,
and one-device serving at every strategy.
"""
import threading

import numpy as np
import pytest

from repro_torch.core.linear3d import norm_param
from repro_torch.core.params import Param, spec_axes
from repro_torch.core.topology import AXES, entry_dirs, make_layout
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.obs import commcheck
from repro_torch.train.step import leaf_sync_axes
from test_torch_multirank_islands import (WORLD, held, run_jax, run_ranks,
                                          wait_jax)

BASELINES = {"1d": dict(n_pod=1, n_dp=2, n_model=4, strategy="1d"),
             "2d": dict(n_pod=1, n_dp=2, n_model=4, strategy="2d")}
BATCH = ("pod", "dp", "x")
B, S, H, F = 4, 8, 16, 24
# island -> (layout, {input: spec}, {output: spec}); inputs x, w, dc
ISLANDS = {
    "c1": ("1d", {"x": (BATCH, None, None), "w": (None, "z"),
                  "dc": (BATCH, None, "z")},
           {"y": (BATCH, None, "z"), "dx": (BATCH, None, None),
            "dw": (None, "z")}),
    "r1": ("1d", {"xr": (BATCH, None, "z"), "wr": ("z", None),
                  "dcr": (BATCH, None, None)},
           {"y": (BATCH, None, None), "dx": (BATCH, None, "z"),
            "dw": ("z", None)}),
    "m2": ("2d", {"x": (BATCH, "y", "z"), "w2": ("y", "z"),
                  "dc": (BATCH, "y", "z")},
           {"y": (BATCH, "y", "z"), "dx": (BATCH, "y", "z"),
            "dw": ("y", "z")}),
}
NORM_SPECS = {"x": (BATCH, None, None), "g": (None,),
              "dcn": (BATCH, None, None)}
F32 = 4


def _hand_bytes():
    """Each island's ring-model bytes per device for one forward and
    backward, by kind, from its collectives at the local shapes (f32;
    dp 2, so the data-axis sum of dw is an all-reduce over 2 ranks):

    c1 (column, z = 4): forward none; backward dx (2, 8, 16) all-reduced
       over z: 2 * 1024 * 3/4 = 1536; dw (16, 6) over dp: 2 * 384 / 2.
    r1 (row, z = 4): forward y (2, 8, 16) all-reduced over z: 1536;
       backward dw (6, 16) over dp: 384.
    m2 (2-D, y = z = 2): all-gathers, each out * 1/2: forward x over z
       to (2, 4, 16) 512 B and w over y to (16, 12) 768 B; backward dc
       over z to (2, 4, 24) 768 B, w over z to (8, 24) 768 B, x over y
       to (2, 8, 8) 512 B, dc over y to (2, 8, 12) 768 B; dw (8, 12) over
       dp: 384."""
    ar = lambda n_bytes, n: 2 * n_bytes * (n - 1) / n      # noqa: E731
    ag = lambda out_bytes, n: out_bytes * (n - 1) / n      # noqa: E731
    return {
        "c1": {"all-reduce": ar(2 * 8 * 16 * F32, 4) + ar(16 * 6 * F32, 2)},
        "r1": {"all-reduce": ar(2 * 8 * 16 * F32, 4) + ar(6 * 16 * F32, 2)},
        "m2": {"all-gather": sum(ag(o * F32, 2) for o in (
            2 * 4 * 16, 16 * 12, 2 * 4 * 24, 8 * 24, 2 * 8 * 8, 2 * 8 * 12)),
            "all-reduce": ar(8 * 12 * F32, 2)}}


HAND_BYTES = _hand_bytes()
# the comm check's reduced paper-transformer: 8 heads, so that 1d splits
# them over 8 ranks; 2 x 256 tokens = 2h, the wide window; f32, whose
# matmuls the CPU runs faster (the bytes double, the ordering stays)
CC = dict(arch="paper-transformer", n_layers=2, d_ff=0, vocab=512,
          reduced=True, changes={"n_heads": 8, "n_kv": 8, "d_head": 32,
                                 "dtype": "float32"})
CC_BATCH, CC_SEQ = 2, 256


def parent_sync_axes(p, layout):
    """The leaf sync before the 1-D baseline: every live axis but pp that
    the spec does not split."""
    if p.synced:
        return ()
    split = set(spec_axes(p.spec))
    return layout.live(tuple(a for a in AXES if a != "pp" and a not in split))


def _inputs(path):
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    np.savez(path, x=f(B, S, H), w=f(H, F), dc=f(B, S, F), xr=f(B, S, F),
             wr=f(F, H), dcr=f(B, S, H), w2=f(H, F), g=1 + 0.1 * f(H),
             dcn=f(B, S, H))


JAX_SCRIPT = r"""
import os
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import linear3d, ops1d, ops2d
from repro.core.topology import make_layout

d = os.environ["MR_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
ISLANDS, NORM_SPECS = %(islands)r, %(norm)r
lays = {"1d": make_layout(1, 2, 4, "1d"), "2d": make_layout(1, 2, 4, "2d")}
assert lays["1d"].cube == (1, 1, 4) and lays["2d"].cube == (1, 2, 2)


def put(lay, name, spec):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    return jax.device_put(jnp.asarray(inp[name]), lay.sharding(spec))


FN = {"c1": ops1d.linear1d_col, "r1": ops1d.linear1d_row,
      "m2": ops2d.matmul2d}
out = {}
for name, (lname, ins, _) in ISLANDS.items():
    lay = lays[lname]
    x, w, dc = [put(lay, k, s) for k, s in ins.items()]
    fn = lambda a, b: FN[name](lay, a, b)
    out[name + "_y"] = jax.jit(fn)(x, w)
    out[name + "_dx"], out[name + "_dw"] = jax.jit(jax.grad(
        lambda a, b: jnp.sum(fn(a, b) * dc), (0, 1)))(x, w)
lay = lays["1d"]
x, g, dcn = [put(lay, k, s) for k, s in NORM_SPECS.items()]
out["norm_dg"] = jax.jit(jax.grad(
    lambda gg: jnp.sum(linear3d.rmsnorm(x, gg) * dcn)))(g)
np.savez(os.path.join(d, "jax.npz"),
         **{k: np.asarray(jax.device_get(v), np.float32)
            for k, v in out.items()})
print("JAX-OK")
"""

RANK_SCRIPT = r"""
import json, os
import numpy as np
import torch
from repro_torch.core import comm, linear3d, ops1d, ops2d
from repro_torch.core.params import shard, spec_axes
from repro_torch.core.topology import AXES, entry_dirs, make_layout
from repro_torch.launch import ranks
from repro_torch.obs import commcheck
from repro_torch.train.step import leaf_sync_axes

torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
d = os.environ["MR_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
ISLANDS, NORM_SPECS, CC = %(islands)r, %(norm)r, %(cc)r
lays = {s: comm.init(make_layout(1, 2, 4, s, rank=me.rank), "gloo")
        for s in ("1d", "2d")}
FN = {"c1": ops1d.linear1d_col, "r1": ops1d.linear1d_row,
      "m2": ops2d.matmul2d}


def loc(lay, name, spec, grad=False):
    t = shard(torch.from_numpy(inp[name]), spec, lay)
    return t.clone().requires_grad_(grad) if grad else t


out, moved = {}, {}
for name, (lname, ins, _) in ISLANDS.items():
    lay = lays[lname]
    (xn, xs), (wn, ws), (dn, ds) = ins.items()
    x, w = loc(lay, xn, xs, True), loc(lay, wn, ws, True)
    comm.reset_bytes()
    y = FN[name](lay, x, w)
    (y * loc(lay, dn, ds)).sum().backward()
    moved[name] = comm.bytes_moved()
    out.update({name + "_y": y, name + "_dx": x.grad, name + "_dw": w.grad})
lay = lays["1d"]
x, g, dcn = [loc(lay, k, s, k == "g") for k, s in NORM_SPECS.items()]
(linear3d.rmsnorm(x, g) * dcn).sum().backward()
p = linear3d.norm_param(entry_dirs(), x.shape[-1], strategy="1d")
old = lay.live(tuple(a for a in AXES if a != "pp"      # the parent's rule
                    and a not in spec_axes(p.spec)))
out["norm_dg"] = comm.psum(lay, g.grad, leaf_sync_axes(p, lay))
out["norm_dg_parent"] = comm.psum(lay, g.grad, old)
cfg = commcheck.plan_config(**CC["cfg"])
for strat in ("1d", "3d"):
    lay = comm.init(make_layout(1, 1, 8, strat, rank=me.rank), "gloo")
    moved["cc_" + strat] = commcheck.measure(cfg, lay, CC["batch"],
                                             CC["seq"], "cpu")
np.savez(os.path.join(d, f"rank{me.rank}.npz"),
         **{k: v.detach().numpy() for k, v in out.items()})
with open(os.path.join(d, f"rank{me.rank}.json"), "w") as f:
    json.dump(moved, f)
print("RANK-OK")
"""


def _fill(script):
    return script % {"islands": ISLANDS, "norm": NORM_SPECS,
                     "cc": {"cfg": CC, "batch": CC_BATCH, "seq": CC_SEQ}}


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    """(JAX outputs, [rank outputs], [rank byte counts], inputs, the comm
    check's 2d report)."""
    import json
    tmp = tmp_path_factory.mktemp("baselines")
    _inputs(tmp / "inputs.npz")
    cc2d = {}

    def two_d():
        try:
            cc2d["report"] = commcheck.check(
                CC["arch"], CC_BATCH, CC_SEQ, CC["n_layers"], CC["d_ff"],
                CC["vocab"], {"2d": 4}, device="cpu", host_devices=4,
                reduced=True, changes=CC["changes"])
        except Exception as e:          # reported by the assert below
            cc2d["error"] = repr(e)

    side = threading.Thread(target=two_d)
    jax_run = run_jax(_fill(JAX_SCRIPT), tmp)
    side.start()
    try:
        run_ranks(_fill(RANK_SCRIPT), tmp)
    finally:
        side.join(timeout=300)
        wait_jax(jax_run)
    assert "report" in cc2d, cc2d.get("error", "the 2d plan's world hung")
    want = dict(np.load(tmp / "jax.npz"))
    got = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    moved = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return want, got, moved, dict(np.load(tmp / "inputs.npz")), \
        cc2d["report"]


def _layout(lname, r):
    return make_layout(rank=r, **BASELINES[lname])


def _failures(want, ranks_out, names, tol=1e-4):
    bad = []
    for name in names:
        isl, out = name.split("_")
        lname, _, outs = ISLANDS[isl]
        for r, res in enumerate(ranks_out):
            ok, info = held(res[name], want[name], outs[out],
                            _layout(lname, r), tol=tol,
                            what=f"rank {r} {name}")
            if not ok:
                bad.append(info)
    return bad


def _oracle(i):
    x, w, dc = i["x"], i["w"], i["dc"]
    xr, wr, dcr = i["xr"], i["wr"], i["dcr"]
    w2 = i["w2"]
    return {"c1_y": x @ w, "c1_dx": dc @ w.T,
            "c1_dw": x.reshape(-1, H).T @ dc.reshape(-1, F),
            "r1_y": xr @ wr, "r1_dx": dcr @ wr.T,
            "r1_dw": xr.reshape(-1, F).T @ dcr.reshape(-1, H),
            "m2_y": x @ w2, "m2_dx": dc @ w2.T,
            "m2_dw": x.reshape(-1, H).T @ dc.reshape(-1, F)}


ISLAND_OUTS = [f"{i}_{o}" for i in ISLANDS for o in ("y", "dx", "dw")]


@pytest.mark.parametrize("name", ISLAND_OUTS)
def test_island_shards_match_jax(battery, name):
    want, got, *_ = battery
    assert not _failures(want, got, [name])


@pytest.mark.parametrize("name", [n for n in ISLAND_OUTS
                                  if n.startswith(("c1", "r1"))] + ["m2_y"])
def test_island_matches_dense_oracle(battery, name):
    """1-D forward and backward, and 2-D's forward, against the oracle."""
    _, got, _, inputs, _ = battery
    assert not _failures(_oracle(inputs), got, [name], tol=1e-5)


@pytest.mark.parametrize("name", ["m2_dx", "m2_dw"])
def test_2d_backward_is_the_reference_fault(battery, name):
    """ROADMAP.md Queue 3, fault 6, pinned: both packages' 2-D dx and dw
    are off the dense oracle by more than 1.0, equal to each other within
    1e-4, while the forward is exact.  A repair of both packages flips
    this test."""
    want, got, _, inputs, _ = battery
    oracle = _oracle(inputs)[name]
    spec = ISLANDS["m2"][2][name[3:]]
    assert float(np.abs(want[name] - oracle).max()) > 1.0
    port = max(held(res[name], oracle, spec, _layout("2d", r))[1][1]
               for r, res in enumerate(got))
    assert port > 1.0, port
    assert not _failures(want, got, [name])
    assert not _failures(_oracle(inputs), got, ["m2_y"], tol=1e-5)


@pytest.mark.parametrize("name", sorted(HAND_BYTES))
def test_island_bytes_match_hand_count(battery, name):
    _, _, moved, _, _ = battery
    want = HAND_BYTES[name]
    for r, m in enumerate(moved):
        got = {k: v for k, v in m[name]["by_kind"].items() if v}
        assert got == pytest.approx(want), (r, name, got, want)


def test_1d_norm_gain_sync_and_the_parent_rule(battery):
    """The 1-D norm gain's gradient after the leaf sync equals JAX's; the
    parent's rule, which summed it over 'z' too, gives 4x JAX's and fails."""
    want, got, *_ = battery
    for r, res in enumerate(got):
        lay = _layout("1d", r)
        ok, info = held(res["norm_dg"], want["norm_dg"], (None,), lay)
        assert ok, info
        ok, info = held(res["norm_dg_parent"], want["norm_dg"], (None,), lay)
        assert not ok, info
        np.testing.assert_allclose(res["norm_dg_parent"],
                                   4 * want["norm_dg"], rtol=1e-4)


@pytest.mark.parametrize("strategy,want", [
    ("3d", ("dp", "y")), ("2d", ("dp", "y")), ("1d", ("dp",))])
def test_leaf_sync_axes_per_strategy(strategy, want):
    """A norm gain's sync axes at dp 2 x the model cube of 4: the parent's
    rule gave ("dp", "z") at 1d, a sum over four whole copies."""
    lay = make_layout(1, 2, 4, strategy, cube=None if strategy != "3d"
                      else (1, 2, 2))
    p = norm_param(entry_dirs(), 16, strategy=strategy)
    assert leaf_sync_axes(p, lay) == want
    if strategy == "1d":
        assert parent_sync_axes(p, lay) == ("dp", "z")
    assert leaf_sync_axes(Param((16,), spec=(None,)), lay) == \
        parent_sync_axes(Param((16,), spec=(None,)), lay)


@pytest.mark.parametrize("strategy", ["3d", "2d", "1d"])
def test_leaf_specs_match_reference(strategy):
    """``weight_param``, ``bias_param``, ``norm_param`` and
    ``embed_param`` place their leaves as the reference's do at each
    strategy (``repro/core/linear3d.py:44-87``, ``:138-146``,
    ``:170-178``), for both directions, both kinds and ``shard_f``."""
    from repro.core import linear3d as ref
    from repro.core.topology import Dirs as JDirs
    from repro.core.topology import make_layout as jmake_layout
    from repro_torch.core import linear3d as port
    from repro_torch.core.topology import Dirs

    def tup(spec):
        return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                     for e in spec)
    jlay = jmake_layout(1, 1, 1, strategy)
    for ins, outs in (("y", "z"), ("z", "y")):
        d, jd = Dirs(ins, outs), JDirs(ins, outs)
        for kind in ("first", "second"):
            for sf in (True, False):
                assert port.weight_param(
                    d, 8, 16, kind=kind, shard_f=sf, strategy=strategy
                ).spec == tup(ref.weight_param(jlay, jd, 8, 16, kind=kind,
                                               shard_f=sf).spec)
                assert port.bias_param(
                    d, 16, kind=kind, shard_f=sf, strategy=strategy
                ).spec == tup(ref.bias_param(jlay, jd, 16, kind=kind,
                                             shard_f=sf).spec)
        assert port.norm_param(d, 8, strategy=strategy).spec == \
            tup(ref.norm_param(jlay, jd, 8).spec)
        assert port.embed_param(d, 32, 8, strategy=strategy).spec == \
            tup(ref.embed_param(jlay, jd, 32, 8).spec)


# ---------------------------------------------------------------------------
# The comm check
# ---------------------------------------------------------------------------
def test_analytic_formulas_match_reference_and_benchmarks():
    from benchmarks import analytic as bench
    from repro.config import reduced as jreduced
    from repro.configs.registry import get as jget
    from repro.obs import commcheck as ref
    from repro_torch.config import reduced
    from repro_torch.configs.registry import get
    for M, N, K in [(6144, 3072, 3072), (6144, 3072, 9216),
                    (6144, 12288, 3072), (1024, 512, 2048), (512, 256, 8)]:
        for p in (4, 8, 16, 64):
            for name in ("comm_1d", "comm_2d", "comm_3d"):
                got = getattr(commcheck, name)(M, N, K, p)
                assert got == getattr(ref, name)(M, N, K, p)
                assert got == pytest.approx(getattr(bench, name)(M, N, K, p))
    for arch in ("paper-transformer", "tinyllama-1.1b", "gemma-2b"):
        for red in (False, True):
            cfg, jcfg = get(arch), jget(arch)
            if red:
                cfg, jcfg = reduced(cfg), jreduced(jcfg)
            for strat, p in commcheck.PLANS.items():
                assert commcheck.config_matmuls(cfg, 12, 512) == \
                    ref.config_matmuls(jcfg, 12, 512)
                assert commcheck.analytic_bytes(cfg, strat, p, 12, 512) == \
                    ref.analytic_bytes(jcfg, strat, p, 12, 512)


def test_measured_ordering_3d_2d_1d(battery):
    _, _, moved, _, rep2d = battery
    got = {s: max(m["cc_" + s]["bytes_per_device"] for m in moved)
           for s in ("1d", "3d")}
    got["2d"] = rep2d["plans"]["2d"]["measured_bytes_per_device"]
    assert got["3d"] < got["2d"] < got["1d"], got
    cfg = commcheck.plan_config(**CC)
    ana = {s: commcheck.analytic_bytes(cfg, s, p, CC_BATCH, CC_SEQ)
           for s, p in commcheck.PLANS.items()}
    assert ana["3d"] < ana["2d"] < ana["1d"], ana
    losses = [m["cc_" + s]["loss"] for m in moved for s in ("1d", "3d")]
    assert np.all(np.isfinite(losses + [rep2d["plans"]["2d"]["loss"]]))
    assert rep2d["plans"]["2d"]["cube"] == [1, 2, 2]
    assert "2d (1x2x2)" in commcheck.format_report(rep2d)


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------
def _train(capsys, extra):
    out = train_launch.main(["--arch", "tinyllama-1.1b", "--reduced",
                             "--device", "cpu", "--steps", "2", "--batch",
                             "4", "--seq", "32", "--log-every", "1",
                             *extra])
    text = capsys.readouterr().out
    assert text.count(" loss=") == 2 and "done: first loss" in text
    return np.array(out["losses"])


@pytest.fixture(scope="module")
def one_device_losses():
    return np.array(train_launch.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "4", "--seq", "32", "--log-every",
        "1"])["losses"])


@pytest.mark.parametrize("strategy", ["1d", "2d"])
def test_launcher_trains_baseline_on_8_cpu_ranks(capsys, one_device_losses,
                                                 strategy):
    """Two steps with finite losses; the first equals the one-device run's
    within bf16 noise (``tests/test_multidev.py:92``), and at 1-D the
    second too (at 2-D the gradients carry fault 6)."""
    one = one_device_losses
    got = _train(capsys, ["--strategy", strategy, "--dp", "2", "--model",
                          "4", "--host-devices", "8"])
    assert len(got) == 2 and np.all(np.isfinite(got))
    upto = 2 if strategy == "1d" else 1
    assert np.abs(got[:upto] - one[:upto]).max() <= 3e-2, (got, one)


def test_one_device_serving_same_tokens_every_strategy(capsys):
    outs = {s: serve_launch.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
        "--requests", "2", "--batch-size", "2", "--max-new", "4",
        "--max-len", "64", "--strategy", s])["outputs"]
        for s in ("3d", "1d", "2d")}
    capsys.readouterr()
    assert outs["1d"] == outs["3d"] and outs["2d"] == outs["3d"]
    assert all(len(o) == 4 for o in outs["3d"])


def test_commcheck_defaults_to_the_card(monkeypatch):
    """The card is the comm check's default, as it is every entry point's:
    with no CUDA device ``main`` exits with a message naming the CPU's
    flags and never falls back to the CPU; ``check`` defaults to it too."""
    import inspect

    import torch
    assert inspect.signature(commcheck.check).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=r"--device cuda: no CUDA device is "
                       r"available \(pass --device cpu --host-devices 8"):
        commcheck.main([])
