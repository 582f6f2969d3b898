"""The dry run's trace (``repro_torch.launch.dryrun.trace_step``: rank r's
train step on meta tensors in a fake world) against real steps, and the
JAX package's FLOP and collective counts.

One world of 8 gloo ranks trains one step of reduced tinyllama-1.1b (2
layers, d_model 256, remat on) in bf16, B 8 x S 64, AdamW, at (2, 2, 2),
dp 2 x (2, 2, 1) with ZeRO 1, 1d(4), 2d(q2), pp 2 x (1, 2, 2) with 4
microbatches and (2, 2, 2) with ``--overlap``, and reduced mixtral-8x7b at
(2, 2, 2); each rank counts its collectives (``comm.bytes_moved``) and
``FlopCounterMode`` its FLOPs.  The trace at the same plans must equal
them, bytes and counts by kind and FLOPs, for rank 0 and at pp 2 for the
first rank of each stage.

Beside the ranks one JAX subprocess compiles the reference's train step
for reduced mixtral at (2, 2, 2) (``tools/dryrun_reference_bytes.py
--side reference``), which pins ROADMAP Queue 3 fault 8: ``HloCost``
skips the collectives whose result is a tuple.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.config import OptimConfig, reduced
from repro_torch.configs.registry import get
from repro_torch.core.topology import make_layout
from repro_torch.launch import dryrun
from test_torch_multirank_islands import ROOT, WORLD, run_ranks

B, S = 8, 64
TINY, MIX = "tinyllama-1.1b", "mixtral-8x7b"
# name -> (arch, make_layout's arguments)
PLANS = {
    "cube": (TINY, dict(n_model=8, cube=(2, 2, 2))),
    "dp2_zero1": (TINY, dict(n_dp=2, n_model=4, cube=(2, 2, 1),
                             zero_stage=1)),
    "1d": (TINY, dict(n_dp=2, n_model=4, strategy="1d")),
    "2d": (TINY, dict(n_dp=2, n_model=4, strategy="2d")),
    "pp2": (TINY, dict(n_model=4, cube=(1, 2, 2), n_pp=2, microbatches=4)),
    "overlap": (TINY, dict(n_model=8, cube=(2, 2, 2), overlap=True,
                           overlap_chunks=4)),
    "moe_cube": (MIX, dict(n_model=8, cube=(2, 2, 2))),
}
TOOL = os.path.join(ROOT, "tools", "dryrun_reference_bytes.py")
FAULT8 = ["--arch", MIX, "--reduced", "--layers", "2", "--batch", "4",
          "--seq", "256", "--plan", "cube"]


def cfg_of(arch):
    return dataclasses.replace(reduced(get(arch)), remat=True)


RANK_SCRIPT = r"""
import dataclasses, json, os
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.config import OptimConfig, ShapeConfig, reduced
from repro_torch.configs.registry import get
from repro_torch.core import comm
from repro_torch.core.params import init_params
from repro_torch.core.topology import make_layout
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import ranks
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
from repro_torch.train.step import make_train_step

PLANS, B, S = %r, %d, %d
torch.set_num_threads(1)
me = ranks.rank_env()
ranks.init_world(me, "gloo", torch.device("cpu"))
out = {}
for name, (arch, kw) in PLANS.items():
    cfg = dataclasses.replace(reduced(get(arch)), remat=True)
    kw = dict(kw, cube=tuple(kw["cube"])) if "cube" in kw else kw
    lay = comm.init(make_layout(rank=me.rank, **kw), "gloo")
    opt = OptimConfig()
    abstract = transformer.abstract_params(cfg, lay)
    params = init_params(abstract, torch.Generator().manual_seed(0), "cpu",
                         torch.bfloat16, layout=lay)
    state = adamw_init(params, lay, abstract, opt)
    step = make_train_step(cfg, lay, opt)
    batch = next(TokenStream(cfg, ShapeConfig("t", S, B, "train"), None,
                             "cpu", layout=lay))
    comm.reset_bytes()
    with FlopCounterMode(display=False) as fc:
        step(params, state, batch)
    out[name] = {"flops": fc.get_total_flops(),
                 "collectives": comm.bytes_moved()}
with open(os.path.join(os.environ["MR_DIR"], f"rank{me.rank}.json"),
          "w") as f:
    json.dump(out, f)
print("RANK-OK")
"""


def start_reference(argv, tmp, name):
    """``tools/dryrun_reference_bytes.py --side reference`` started in a
    subprocess; ``finish_reference`` reads its JSON."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    log = open(tmp / f"{name}.out", "w")
    return subprocess.Popen([sys.executable, TOOL, "--side", "reference",
                             *argv], env=env, stdout=log,
                            stderr=subprocess.STDOUT), log


def finish_reference(run, tmp, name):
    proc, log = run
    try:
        proc.wait(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp / f"{name}.out").read_text()
    assert proc.returncode == 0, text[-4000:]
    return json.loads(text.splitlines()[-1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_trace")
    ref = start_reference(FAULT8, tmp, "fault8")
    try:
        plans = {k: (a, dict(kw, cube=list(kw["cube"])) if "cube" in kw
                     else kw) for k, (a, kw) in PLANS.items()}
        run_ranks(RANK_SCRIPT % (plans, B, S), tmp, timeout=240)
    finally:
        got = {"fault8": finish_reference(ref, tmp, "fault8")}
    got["ranks"] = [json.loads((tmp / f"rank{r}.json").read_text())
                    for r in range(WORLD)]
    return got


@pytest.mark.parametrize("name", list(PLANS))
def test_trace_matches_real_step(world, name):
    """Rank 0's trace (at pp 2 each stage's first rank's) equals the real
    step's collective counter, bytes and counts by kind, and its
    FlopCounterMode FLOPs."""
    arch, kw = PLANS[name]
    lay = make_layout(**kw)
    per = lay.n_devices // (lay.n_data * lay.size("pp"))
    for r in range(0, per * lay.size("pp"), per):
        got = dryrun.trace_step(cfg_of(arch), make_layout(rank=r, **kw), B,
                                S, OptimConfig())
        want = world["ranks"][r][name]
        assert got["collectives"]["by_kind"] == \
            want["collectives"]["by_kind"], (name, r)
        assert got["collectives"]["counts"] == \
            want["collectives"]["counts"], (name, r)
        assert got["collectives"]["bytes_per_device"] > 0
        assert got["flops"] == want["flops"] > 0, (name, r)


def test_reference_hlo_cost_skips_tuple_collectives(world):
    """ROADMAP Queue 3 fault 8, a fault of the reference: ``HloCost``
    (and ``launch/dryrun.collective_stats``) skip every collective whose
    result is a tuple, so reduced mixtral's step at (2, 2, 2) counts no
    all-to-all and a fraction of its all-reduce bytes.  A repair of the
    reference flips this test."""
    ref = world["fault8"]
    counted, full = ref["hlo_cost"]["by_kind"], ref["tuple_aware"]
    assert counted["all-to-all"] == 0
    assert full["by_kind"]["all-to-all"] > 0
    assert full["skipped_by_kind"]["all-to-all"] == \
        full["by_kind"]["all-to-all"]
    assert counted["all-reduce"] < 0.1 * full["by_kind"]["all-reduce"]
    for k in counted:
        assert counted[k] == pytest.approx(
            full["by_kind"][k] - full["skipped_by_kind"][k], rel=1e-9), k


def test_main_prints_an_ok_line(capsys, monkeypatch):
    """A trace at the production layout (256 ranks) prints OK with its
    FLOPs and bytes, the bytes by kind and the memory model; reduced
    tinyllama in place of the published one."""
    monkeypatch.setattr(dryrun, "get", lambda arch: reduced(get(arch)))
    rc = dryrun.main(["--arch", TINY, "--shape", "train_4k"])
    out = capsys.readouterr().out
    assert rc == 0, out
    line = next(x for x in out.splitlines() if x.startswith(TINY))
    assert " OK flops=" in line and "comm=" in line, out
    assert "comm/device by kind all-gather=" in out
    assert "mem/device grads" in out


def test_fake_world_is_its_own():
    """The trace refuses to run inside a world this process has joined,
    and names the fake backend's module where it is missing."""
    with dryrun.fake_world(2, 0):
        with pytest.raises(RuntimeError, match="already in a world"):
            with dryrun.fake_world(2, 1):
                pass
    import builtins
    real = builtins.__import__

    def no_fake(name, *a, **k):
        if name.endswith("fake_pg"):
            raise ImportError(name)
        return real(name, *a, **k)
    builtins.__import__ = no_fake
    try:
        with pytest.raises(RuntimeError, match=dryrun.FAKE_PG):
            with dryrun.fake_world(2, 0):
                pass
    finally:
        builtins.__import__ = real
