"""The MoE family's layout above one device, held to the JAX package's
without starting a world: ``moe.ep_axes`` and the parameter tree's specs
(the router, w1/w2/w3 on the expert-parallel axes with the storage-only
'dp' split of the FFN dim, the shared experts, the attention and the
norms), and the optimizer moments' ZeRO specs, over the cube, dp 2, the
1-D and 2-D baselines and pp 2 layouts, each at 3, 4, 8 and 64 experts;
and what ``plan.multi_rank_refusal`` still refuses (MoE in pipeline
stages, deepseek-v3's MLA above one device, MoE serving), each naming
ROADMAP.md's Queue 1 item 3.
"""
import dataclasses

import pytest
from jax.sharding import AbstractMesh

from repro.config import reduced as jreduced
from repro.configs.registry import get as jget
from repro.core import topology as jtopology
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.optim.optimizers import zero_partition_spec as jzero_spec
from repro_torch.config import OptimConfig, reduced
from repro_torch.configs.registry import get
from repro_torch.core.params import tree_zip
from repro_torch.core.plan import ParallelPlan, multi_rank_refusal
from repro_torch.core.topology import Dirs, make_layout
from repro_torch.models import moe, transformer
from repro_torch.optim.optimizers import zero_partition_spec
from repro_torch.train.step import make_train_step

# name -> (pod, dp, pp, x, y, z), strategy
LAYOUTS = {"cube": ((1, 1, 1, 2, 2, 2), "3d"),
           "dp2": ((1, 2, 1, 2, 2, 1), "3d"),
           "1d": ((1, 2, 1, 1, 1, 4), "1d"),
           "2d": ((1, 2, 1, 1, 2, 2), "2d"),
           "pp2": ((1, 1, 2, 1, 2, 2), "3d"),
           "dp4": ((1, 4, 1, 1, 2, 1), "3d")}
EXPERTS = (3, 4, 8, 64)
ARCHS = ("mixtral-8x7b", "moonshot-v1-16b-a3b")
ITEM3 = "ROADMAP.md, Queue 1 item 3"


def _layouts(name):
    shape, strategy = LAYOUTS[name]
    pod, dp, pp, *cube = shape
    lay = make_layout(n_pod=pod, n_dp=dp, n_model=cube[0] * cube[1]
                      * cube[2], strategy=strategy, cube=tuple(cube),
                      n_pp=pp)
    jlay = jtopology.Layout(mesh=AbstractMesh(shape, jtopology.AXES),
                            strategy=strategy)
    return lay, jlay


def _cfgs(arch, e):
    cfg = reduced(get(arch))
    jcfg = jreduced(jget(arch))
    return (dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=e)),
            dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, n_experts=e)))


def _norm(spec, ndim):
    spec = [tuple(e) if isinstance(e, (tuple, list)) else e
            for e in (spec or ())]
    return tuple(spec + [None] * (ndim - len(spec)))


@pytest.mark.parametrize("e", EXPERTS)
@pytest.mark.parametrize("lname", sorted(LAYOUTS))
def test_ep_axes_match_reference(lname, e):
    lay, jlay = _layouts(lname)
    got = moe.ep_axes(lay, Dirs("y", "z"), e)
    assert got == tuple(jmoe.ep_axes(jlay, jtopology.Dirs("y", "z"), e))
    if lname == "cube" and e in (4, 8, 64):
        assert got == ("x", "y")


@pytest.mark.parametrize("e", EXPERTS)
@pytest.mark.parametrize("lname", sorted(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero_specs_match_reference(arch, lname, e):
    """Every leaf of the tree: its global shape, its spec and, at the
    layout's default ZeRO stage, its moments' spec."""
    cfg, jcfg = _cfgs(arch, e)
    lay, jlay = _layouts(lname)
    tree = transformer.abstract_params(cfg, lay)
    jtree = jtransformer.abstract_params(jcfg, jlay)
    n = 0
    for p, jp in tree_zip(tree, jtree):
        assert p.shape == tuple(jp.shape), (p, jp)
        assert _norm(p.spec, len(p.shape)) == _norm(jp.spec, len(p.shape)), \
            (p, jp)
        assert _norm(zero_partition_spec(p, lay), len(p.shape)) == _norm(
            jzero_spec(jp, jlay), len(p.shape)), (p, jp)
        n += 1
    assert n > 10
    w1 = tree["stack"]["moe"]["moe"]["w1"].spec
    if lname == "dp2" and e == 3:       # no ep: the FFN dim over dp
        assert w1 == (None, None, "z", "dp")


def test_refusals_name_roadmap_item_3():
    mix = reduced(get("mixtral-8x7b"))
    ds = reduced(get("deepseek-v3-671b"))
    assert multi_rank_refusal(8, cfg=mix) is None
    err = multi_rank_refusal(4, cfg=mix, n_stages=2)
    assert "pp=2" in err and "MoE in pipeline stages" in err and ITEM3 in err
    err = multi_rank_refusal(8, cfg=ds)
    assert "deepseek-v3-671b on 8 devices" in err and ITEM3 in err
    err = multi_rank_refusal(8, cfg=mix, mode="serve")
    assert "multi-rank serving" in err and ITEM3 in err
    with pytest.raises(NotImplementedError, match="multi-rank serving"):
        ParallelPlan(n_model=8).validate(model=mix, mode="serve")
    lay = make_layout(n_model=4, cube=(1, 2, 2), n_pp=2)
    with pytest.raises(NotImplementedError, match="MoE in pipeline stages"):
        make_train_step(mix, lay, OptimConfig())
    with pytest.raises(NotImplementedError, match="multi-rank serving"):
        moe.moe_apply(make_layout(n_model=8), mix, Dirs("y", "z"), None,
                      {}, decode=True)
