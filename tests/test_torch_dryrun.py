"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, with no world.

One JAX subprocess (``repro.launch.dryrun`` gives JAX its 512 host
devices) computes the reference's ``memory_model`` at train_4k for all 10
architectures on one pod and two, at 3d, 2d and 1d, ZeRO 0, 1 and 2, and
at pp 2 with 8 microbatches (3d); the per-rank bytes of every parameter
leaf of zamba2-1.2b, xlstm-350m and deepseek-v3-671b at those layouts;
``sharded_bytes`` of the optimizer state's tree for AdamW at ZeRO 0, 1, 2
and for Adafactor; and its SKIP reasons.  The port's must equal them, key
for key (relative 1e-9).  Beside it a second compiles the reference's
train step of full-width tinyllama cut to 2 layers at (2, 2, 2), whose
``HloCost.flops()`` the trace's FLOPs must be within 10% of.  The rest needs no reference: the tree walk over
an ``OptState``, the pipeline and ZeRO lowerings of
``tests/test_pipeline.py:140`` and ``tests/test_zero.py:191``, ``main``'s
lines and exit codes, and K1-K5's entry points on meta tensors.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.config import SHAPES, OptimConfig
from repro_torch.configs.registry import ARCH_IDS, get
from repro_torch.core.params import Param, sharded_bytes, tree_leaves
from repro_torch.launch import dryrun
from repro_torch.models import transformer
from repro_torch.optim.optimizers import OptState, opt_state_abstract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PODS, STRATEGIES, ZEROS = (False, True), ("3d", "2d", "1d"), (0, 1, 2)
LEAF_ARCHS = ("zamba2-1.2b", "xlstm-350m", "deepseek-v3-671b")
OPTS = (("adamw", 0), ("adamw", 1), ("adamw", 2), ("adafactor", 1))
# the reference's compiled step that the trace's FLOPs are held to
FLOPS_RUN = ["--arch", "tinyllama-1.1b", "--layers", "2", "--batch", "4",
             "--seq", "2048", "--plan", "cube"]
# (arch, shape, n_pp) of the reference's SKIPs held to the port's
SKIPS = (("gemma-2b", "long_500k", 1), ("tinyllama-1.1b", "decode_32k", 2),
         ("deepseek-v3-671b", "train_4k", 2))

REF_SCRIPT = r"""
import json, sys
from repro.launch import dryrun as D
import jax
from repro.config import SHAPES, OptimConfig
from repro.configs.registry import ARCH_IDS, get
from repro.core.params import is_param, sharded_bytes
from repro.models import transformer
from repro.optim import opt_state_abstract
PODS, STRATEGIES, ZEROS, LEAF_ARCHS, OPTS, SKIPS = %s
out = {"mm": {}, "leaves": {}, "opt": {}, "skip": {}}
for arch in ARCH_IDS:
    cfg = get(arch)
    opt = OptimConfig(name="adafactor" if arch == "deepseek-v3-671b"
                      else "adamw")
    plans = [(mp, st, 1, 1, z) for mp in PODS for st in STRATEGIES
             for z in ZEROS] + [(mp, "3d", 2, 8, 1) for mp in PODS]
    for mp, st, pp, m, z in plans:
        key = f"{arch}|{mp}|{st}|{pp}|{m}|{z}"
        try:
            lay = D.build_layout(arch, "train_4k", mp, st, pp, m, z)
            out["mm"][key] = D.memory_model(cfg, lay, SHAPES["train_4k"], opt)
        except ValueError as e:
            out["mm"][key] = {"error": str(e)}
            continue
        if arch in LEAF_ARCHS and z == 1 and pp == 1:
            ab = transformer.abstract_params(cfg, lay)
            flat = jax.tree_util.tree_flatten_with_path(ab, is_leaf=is_param)
            out["leaves"][key] = {
                "/".join(str(k.key) for k in path):
                sharded_bytes({"a": leaf}, lay) for path, leaf in flat[0]}
cfg = get("tinyllama-1.1b")
for name, z in OPTS:
    lay = D.build_layout("tinyllama-1.1b", "train_4k", False, "3d",
                         zero_stage=z)
    out["opt"][f"{name}|{z}"] = sharded_bytes(opt_state_abstract(
        transformer.abstract_params(cfg, lay), lay, OptimConfig(name=name)),
        lay)
for arch, shape, pp in SKIPS:
    res = D.lower_one(arch, shape, multi_pod=False, compile_=False, n_pp=pp,
                      microbatches=8)
    out["skip"][f"{arch}|{shape}|{pp}"] = [res["status"], res["reason"]]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's figures: REF_SCRIPT's, and beside it the compiled
    step of full-width tinyllama cut to 2 layers at (2, 2, 2), 4 x 2048
    (``tools/dryrun_reference_bytes.py --side reference``)."""
    script = REF_SCRIPT % repr((PODS, STRATEGIES, ZEROS, LEAF_ARCHS, OPTS,
                                SKIPS))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    tool = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "dryrun_reference_bytes.py"),
         "--side", "reference", *FLOPS_RUN], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              capture_output=True, text=True, timeout=300)
        tool_out = tool.communicate(timeout=300)[0]
    finally:
        if tool.poll() is None:
            tool.kill()
            tool.wait()
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert tool.returncode == 0, tool_out[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    out = json.loads(line[0][len("RESULT "):])
    out["tiny_222"] = json.loads(tool_out.splitlines()[-1])
    return out


def plan_of(key):
    arch, mp, st, pp, m, z = key.split("|")
    return arch, mp == "True", st, int(pp), int(m), int(z)


def leaf_bytes(tree, layout, path=()):
    """{path: the rank's bytes} of every leaf of a tree of Params."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaf_bytes(v, layout, path + (k,)))
        return out
    return {"/".join(path): sharded_bytes({"a": tree}, layout)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_memory_model_matches_reference(ref, arch):
    """Every key of ``memory_model`` at every plan of the grid, within a
    relative 1e-9 of the reference's; at pp 2 deepseek-v3 raises the
    reference's ValueError (its mtp head)."""
    keys = [k for k in ref["mm"] if k.startswith(arch + "|")]
    assert len(keys) == len(PODS) * (len(STRATEGIES) * len(ZEROS) + 1)
    cfg = get(arch)
    for key in keys:
        want = ref["mm"][key]
        _, mp, st, pp, m, z = plan_of(key)
        if "error" in want:
            with pytest.raises(ValueError) as e:
                dryrun.memory_model(cfg, dryrun.build_layout(
                    arch, "train_4k", mp, st, pp, m, z), SHAPES["train_4k"],
                    dryrun.opt_config(arch))
            assert str(e.value) == want["error"]
            continue
        lay = dryrun.build_layout(arch, "train_4k", mp, st, pp, m, z)
        got = dryrun.memory_model(cfg, lay, SHAPES["train_4k"],
                                  dryrun.opt_config(arch))
        assert set(got) == set(want), key
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-9, abs=0), (key, k)


@pytest.mark.parametrize("arch", LEAF_ARCHS)
def test_param_leaves_match_reference(ref, arch):
    """The rank's bytes of every parameter leaf of the three families that
    carry the reference's specs since this slice (the Mamba2 blocks, the
    mLSTM and sLSTM blocks, MLA and deepseek's MoE layers) equal the
    reference's at every production layout of the grid."""
    keys = [k for k in ref["leaves"] if k.startswith(arch + "|")]
    assert len(keys) == len(PODS) * len(STRATEGIES)
    for key in keys:
        _, mp, st, pp, m, z = plan_of(key)
        lay = dryrun.build_layout(arch, "train_4k", mp, st, pp, m, z)
        got = leaf_bytes(transformer.abstract_params(get(arch), lay), lay)
        assert got == ref["leaves"][key], key


@pytest.mark.parametrize("name,zero", OPTS)
def test_opt_state_bytes_match_reference(ref, name, zero):
    """``sharded_bytes`` over the whole ``OptState`` (the tree walk
    descends into the NamedTuple; the step counts as the reference's
    int32) equals the reference's at the production layout."""
    lay = dryrun.build_layout("tinyllama-1.1b", "train_4k", False, "3d",
                              zero_stage=zero)
    abstract = transformer.abstract_params(get("tinyllama-1.1b"), lay)
    state = opt_state_abstract(abstract, lay, OptimConfig(name=name))
    got = sharded_bytes(state, lay)
    assert got == ref["opt"][f"{name}|{zero}"]
    assert got == 4 + sum(sharded_bytes(t, lay)
                          for t in (state.m or {}, state.v))


def test_tree_leaves_descends_into_tuples():
    """``tree_leaves`` walks dicts, lists, tuples and NamedTuples as JAX's
    flatten does, None an empty subtree; a Param and a host int are
    leaves."""
    p = Param((2, 3))
    state = OptState(7, None, {"a": p, "b": [p, (p, None)]})
    assert tree_leaves(state) == [7, p, p, p]
    assert tree_leaves({"x": {"y": p}, "z": p}) == [p, p]
    assert tree_leaves(None) == []
    assert tree_leaves(p) == [p]


@pytest.mark.parametrize("arch,shape,pp", SKIPS)
def test_skip_reasons_match_reference(ref, arch, shape, pp):
    res = dryrun.lower_one(arch, shape, multi_pod=False, compile_=False,
                           n_pp=pp, microbatches=8)
    assert [res["status"], res["reason"]] == \
        ref["skip"][f"{arch}|{shape}|{pp}"]


def test_tinyllama_flops_near_reference(ref):
    """Full-width tinyllama cut to 2 layers at (2, 2, 2), 4 x 2048: the
    trace's FLOPs within 10% of the reference's ``HloCost.flops()``."""
    import dataclasses

    from repro_torch.core.topology import make_layout
    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=2)
    got = dryrun.trace_step(cfg, make_layout(n_model=8, cube=(2, 2, 2)), 4,
                            2048, OptimConfig())
    want = ref["tiny_222"]["flops"]
    assert abs(got["flops"] / want - 1) <= 0.10, (got["flops"], want)


def test_dryrun_reports_bubble():
    """tests/test_pipeline.py:140's counterpart: tinyllama at pp 2, 8
    microbatches, lowered."""
    res = dryrun.lower_one("tinyllama-1.1b", "train_4k", multi_pod=False,
                           strategy="3d", compile_=False, n_pp=2,
                           microbatches=8)
    assert res["status"] == "LOWERED", res
    assert res["pipeline"]["bubble_fraction"] == pytest.approx(1 / 8)
    assert res["pipeline"]["n_stages"] == 2
    assert res["mesh"]["pp"] == 2


def test_dryrun_memory_model_reports_zero_savings():
    """tests/test_zero.py:191's counterpart: all four components reported,
    ZeRO 1 shrinks the optimizer line ~16x over dp 16, the parameters
    unchanged."""
    cfg = get("tinyllama-1.1b")
    mm0, mm1 = (dryrun.memory_model(
        cfg, dryrun.build_layout("tinyllama-1.1b", "train_4k", False, "3d",
                                 zero_stage=z), SHAPES["train_4k"],
        OptimConfig()) for z in (0, 1))
    for mm in (mm0, mm1):
        for key in ("param_gib", "grad_gib", "opt_gib", "act_est_gib"):
            assert mm[key] > 0, (key, mm)
    assert mm0["zero_stage"] == 0 and mm1["zero_stage"] == 1
    assert mm0["opt_savings_x"] == 1.0
    assert mm1["opt_gib"] < mm0["opt_gib"] / 8
    assert mm1["param_gib"] == mm0["param_gib"]


def test_main_prints_lines_and_exits_zero(capsys):
    """``--lower-only``: LOWERED lines with the memory model's, SKIP with
    the reason; exit 0."""
    rc = dryrun.main(["--arch", "xlstm-350m", "--shape", "all",
                      "--lower-only", "--single-pod", "--multi-pod"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "production mesh multi_pod=False: {'data': 16, 'model': 16}" in out
    assert "{'pod': 2, 'data': 16, 'model': 16}" in out
    lines = out.splitlines()
    assert sum(" LOWERED" in x for x in lines) == 8, out
    assert sum("mem/device opt" in x for x in lines) == 2, out
    assert not any(" FAIL" in x or " SKIP" in x for x in lines), out


def test_main_traces_skips_and_fails(capsys, monkeypatch):
    """The trace's SKIP names ``multi_rank_refusal``'s reason; a plan that
    raises prints FAIL and ``main`` exits 1."""
    rc = dryrun.main(["--arch", "zamba2-1.2b", "--shape", "train_4k"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "SKIP (zamba2-1.2b on 256 devices: above one rank" in out
    assert "mem/device params" in out

    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "lower_one", boom)
    rc = dryrun.main(["--arch", "gemma-2b", "--shape", "train_4k"])
    out = capsys.readouterr().out
    assert rc == 1
    assert " FAIL" in out


# ---------------------------------------------------------------------------
# K1-K5 on meta tensors: the plain versions' shapes and dtypes
# ---------------------------------------------------------------------------
def _shapes(t):
    """(shape, dtype, device type) of every tensor of a result."""
    if isinstance(t, torch.Tensor):
        return [(tuple(t.shape), t.dtype, t.device.type)]
    return [x for part in t for x in _shapes(part)]


def _case(kernel):
    from test_torch_cuda import _paged_case
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.kernels import ssd_scan as k5
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)
    if kernel == "K1":
        return (lambda x, w, b: k1.matmul(x, w, b, act="gelu"),
                (r(2, 8, 32, dtype=torch.bfloat16),
                 r(32, 24, dtype=torch.bfloat16),
                 r(24, dtype=torch.bfloat16)))
    if kernel == "K2":
        kpos = torch.arange(16)

        def k2_both(q, k, v, qp, kp):
            out, lse = k2.flash_attention_fwd(q, k, v, qp, kp, window=8)
            return out, lse, *k2.flash_attention_bwd(
                q, k, v, out, out, lse, qp, kp, window=8)
        return k2_both, (r(2, 16, 4, 32, dtype=torch.bfloat16),
                         r(2, 16, 2, 32, dtype=torch.bfloat16),
                         r(2, 16, 2, 32, dtype=torch.bfloat16),
                         kpos.expand(2, 16).contiguous(), kpos)
    if kernel == "K3":
        def k3_both(x, gamma, dy):
            y, rstd = k3.rmsnorm_fwd(x, gamma)
            return y, rstd, *k3.rmsnorm_bwd(dy, x, gamma, rstd)
        return k3_both, (r(4, 6, 64, dtype=torch.bfloat16),
                         r(64, dtype=torch.bfloat16),
                         r(4, 6, 64, dtype=torch.bfloat16))
    if kernel == "K4":
        case = _paged_case(B=2, nq=4, nkv=2, dk=16, dv=16, block=4, nb=3,
                           n_blocks=8)
        return (lambda *a: k4.paged_flash_decode(*a, block=4,
                                                 return_residuals=True),
                tuple(torch.from_numpy(c) for c in case))

    def k5_both(xbar, la, B, C, dy):
        y, states = k5.ssd_scan_fwd(xbar, la, B, C, chunk=8)
        return y, states, *k5.ssd_scan_bwd(dy, xbar, la, B, C, states,
                                           chunk=8)
    return k5_both, (r(2, 16, 4, 8), -r(2, 16, 4).abs(), r(2, 16, 1, 8),
                     r(2, 16, 1, 8), r(2, 16, 4, 8))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
def test_kernels_on_meta_give_plain_shapes(kernel):
    """Meta tensors through each kernel's entry points (forward and
    backward) take the plain version, which gives the CPU run's shapes and
    dtypes on meta; a mix of meta and CPU tensors raises."""
    fn, args = _case(kernel)
    want = _shapes(fn(*args))
    got = _shapes(fn(*(a.to("meta") for a in args)))
    assert got == [(s, d, "meta") for s, d, _ in want]
    with pytest.raises(ValueError, match="several devices"):
        fn(args[0].to("meta"), *args[1:])
