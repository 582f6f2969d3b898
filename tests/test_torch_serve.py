"""The port's serving slice against the JAX package, on the CPU.

Reduced tinyllama-1.1b in f32 (2 layers, d_model 256) and a GQA variant
with n_kv = 2, with the port's weights carried over from the reference by
``convert.params_from_jax``: prefill logits and collected kv, one fused
decode step's logits and entries (all <= 1e-4), and the engines' greedy
tokens (identical).  Also the copies' units (configs, topology, plan,
allocator, scheduler, sampling), the slice's refusals, and a subprocess
that runs the CPU engine and checks that neither jax nor ``repro`` was
imported.
"""
import dataclasses
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs.registry import ARCH_IDS, get as jget
from repro.core.params import init_params as jinit_params
from repro.core.topology import single_device_layout
from repro.models import blocks as jblocks
from repro.models import registry as jregistry
from repro.models import transformer as jtransformer
from repro.serve import kvcache as jkvcache
from repro_torch.config import reduced
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_jax
from repro_torch.core import comm
from repro_torch.core.params import abstract_params, init_params, tree_leaves
from repro_torch.core.plan import ParallelPlan
from repro_torch.core.topology import AXES, Layout, factor_model_axis
from repro_torch.models import blocks
from repro_torch.models import transformer
from repro_torch.serve import Engine, Request, kvcache, sampling
from repro_torch.serve.kvcache import RESERVED, BlockAllocator, PagedKVCache
from repro_torch.serve.scheduler import Scheduler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"mha": {}, "gqa": {"n_kv": 2}}


@pytest.fixture(scope="module")
def tlayout():
    return ParallelPlan().validate(mode="serve").build()


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    """(jax cfg, port cfg, jax layout, jax params, port params)."""
    change = VARIANTS[request.param]
    jcfg = dataclasses.replace(jreduced(jget("tinyllama-1.1b")), **change)
    tcfg = dataclasses.replace(reduced(get("tinyllama-1.1b")), **change)
    jlay = single_device_layout("3d")
    jp = jinit_params(jtransformer.abstract_params(jcfg, jlay),
                      jax.random.key(0), dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp), "cpu")
    return jcfg, tcfg, jlay, jp, tp


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).tolist() for n in lens]


def _maxerr(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


# ---------------------------------------------------------------------------
# The slice against the reference
# ---------------------------------------------------------------------------
def test_param_tree_matches_reference():
    """Same nested names and shapes as transformer.abstract_params, at the
    full published width of tinyllama-1.1b."""
    jtree = jtransformer.abstract_params(jget("tinyllama-1.1b"),
                                         single_device_layout())
    ttree = abstract_params(get("tinyllama-1.1b"))
    jflat = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda p: hasattr(p, "spec"))[0]
    tflat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            tflat[path] = t.shape
    walk(ttree, ())
    want = {tuple(k.key for k in path): tuple(p.shape) for path, p in jflat}
    assert tflat == want


def _prefill_both(jcfg, tcfg, jlay, tlay, jp, tp, lens, S):
    prompts = _prompts(jcfg.vocab, lens)
    tokens = np.zeros((len(lens), S), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    length = np.asarray(lens, np.int32)
    jl, jkv = jax.jit(lambda p, b: jtransformer.prefill(jcfg, jlay, p, b))(
        jp, {"tokens": jnp.asarray(tokens), "length": jnp.asarray(length)})
    tl, tkv = transformer.prefill(
        tcfg, tlay, tp, {"tokens": torch.from_numpy(tokens).long(),
                         "length": torch.from_numpy(length)})
    return tokens, length, (jl, jkv), (tl, tkv)


def test_prefill_matches_reference(model, tlayout):
    jcfg, tcfg, jlay, jp, tp = model
    _, _, (jl, jkv), (tl, tkv) = _prefill_both(jcfg, tcfg, jlay, tlayout, jp,
                                               tp, [16, 9, 12], 16)
    assert _maxerr(tl, jl) <= 1e-4
    for got, want in zip(tkv["dense"], jkv["dense"]):
        assert tuple(got.shape) == want.shape
        assert _maxerr(got, want) <= 1e-4


def test_fused_decode_step_matches_reference(model, tlayout):
    """Prefill into the paged pool, then one fused decode step straight
    against it: logits and the step's new (k, v, pos) entries."""
    jcfg, tcfg, jlay, jp, tp = model
    lens, S, L, blk = [16, 9, 12], 16, 48, 8
    tokens, length, (jl, jkv), (tl, tkv) = _prefill_both(
        jcfg, tcfg, jlay, tlayout, jp, tp, lens, S)
    B = len(lens)
    jc = jkvcache.PagedKVCache(jcfg, jlay, B, L, block=blk,
                               dtype=jnp.float32)
    tc = PagedKVCache(tcfg, B, L, block=blk, dtype=torch.float32)
    for i, n in enumerate(lens):
        assert jc.admit(i, n + 4) and tc.admit(i, n + 4)
    assert (jc.tables == tc.tables).all()
    phys_map = jc.prefill_phys_map(dict(enumerate(lens)), S)
    assert (phys_map == tc.prefill_phys_map(dict(enumerate(lens)), S)).all()
    p = np.arange(S)[None, :]
    pos2d = np.where(p < length[:, None], p, -1).astype(np.int32)
    jpool = jkvcache.scatter_prefill(
        jc.init_pool(),
        jregistry.pack_prefill_cache(jcfg, jkv, jnp.asarray(pos2d)),
        phys_map)
    tpool = kvcache.scatter_prefill(
        tc.init_pool("cpu"),
        transformer.pack_prefill_cache(tcfg, tkv, torch.from_numpy(pos2d)),
        torch.from_numpy(phys_map))
    keep = np.ones(tc.n_blocks * blk, bool)
    keep[blk:2 * blk] = False          # the trash block holds any lane's write
    for leaf in ("k", "v", "pos"):
        assert _maxerr(tpool["dense"][leaf][:, keep],
                       np.asarray(jpool["dense"][leaf])[:, keep]) <= 1e-4

    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    active = np.ones((B,), bool)

    def jstep(params, batch, pool, tables, act):
        page = jblocks.PageInfo(tables=tables, active=act, block=blk)
        return jtransformer.forward(jcfg, jlay, params, batch, mode="decode",
                                    cache=pool, page=page)

    jlog, jupd = jax.jit(jstep)(
        jp, {"token": jnp.asarray(tok), "pos": jnp.asarray(length)}, jpool,
        jnp.asarray(jc.tables), jnp.asarray(active))
    page = blocks.PageInfo(tables=tc.tables_device("cpu"),
                           active=torch.from_numpy(active), block=blk)
    tlog, tupd = transformer.forward(
        tcfg, tlayout, tp, {"token": torch.from_numpy(tok).long(),
                            "pos": torch.from_numpy(length)},
        mode="decode", cache=tpool, page=page)
    assert _maxerr(tlog, jlog) <= 1e-4
    for leaf in ("k", "v", "pos"):
        assert _maxerr(tupd["dense"][leaf], jupd["dense"][leaf]) <= 1e-4


def test_engine_greedy_matches_reference(model, tlayout):
    """Four ragged prompts through two slots (continuous batching with
    slot refill): the port's greedy tokens equal the reference engine's."""
    from repro.serve import Engine as JEngine, Request as JRequest
    jcfg, tcfg, jlay, jp, tp = model
    prompts = _prompts(jcfg.vocab, [5, 17, 9, 12], seed=1)
    jreqs = [JRequest(uid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    treqs = [Request(uid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    JEngine(jcfg, jlay, jp, batch_size=2, max_len=64).run(jreqs)
    stats = Engine(tcfg, tlayout, tp, batch_size=2, max_len=64).run(treqs)
    assert all(r.done and len(r.out) == 6 for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert stats["nonfinite_rows"] == 0 and stats["tokens"] == 24


def test_engine_chunked_matches_sequential(tlayout):
    """Chunked prefill hands the pool the same kv that token-by-token
    prefill writes: identical greedy trajectories (f32)."""
    cfg = reduced(get("tinyllama-1.1b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         torch.float32)
    outs = []
    for chunked in (True, False):
        reqs = [Request(uid=i, prompt=list(range(4, 4 + 17 + i)), max_new=4)
                for i in range(2)]
        Engine(cfg, tlayout, params, batch_size=2, max_len=64,
               chunked_prefill=chunked).run(reqs)
        assert all(r.done and len(r.out) == 4 for r in reqs)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# Copies of jax-free reference modules
# ---------------------------------------------------------------------------
def _as_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["family"] = cfg.family.value
    return d


def test_configs_match_reference():
    for arch in ARCH_IDS + ["paper-transformer"]:
        assert _as_dict(get(arch)) == _as_dict(jget(arch)), arch
        assert _as_dict(reduced(get(arch))) == _as_dict(jreduced(jget(arch)))


def test_topology_and_plan_match_reference():
    from repro.core import plan as jplan
    from repro.core import topology as jtopo
    for n in range(1, 65):
        for strategy in ("1d", "2d", "3d"):
            try:
                want = jtopo.factor_model_axis(n, strategy)
            except ValueError:
                with pytest.raises(ValueError):
                    factor_model_axis(n, strategy)
                continue
            assert factor_model_axis(n, strategy) == want
    for kw in ({"n_stages": 2}, {"n_model": 8, "cube": (2, 2, 3)},
               {"n_stages": 0}):
        with pytest.raises(ValueError) as want:
            jplan.ParallelPlan(**kw).validate(mode="serve")
        with pytest.raises(ValueError) as got:
            ParallelPlan(**kw).validate(mode="serve")
        assert str(got.value) == str(want.value)
    assert ParallelPlan(n_model=8).describe() == {
        k: v for k, v in jplan.ParallelPlan(n_model=8).describe().items()
        if k not in ("zero_stage", "overlap", "overlap_chunks")}


def test_block_allocator_invariants():
    a = BlockAllocator(10)
    assert a.n_free == 10 - RESERVED
    b1 = a.alloc(3)
    b2 = a.alloc(4)
    assert b1 is not None and b2 is not None
    assert not (set(b1) & set(b2)), "a block was handed out twice"
    assert all(b >= RESERVED for b in b1 + b2), "reserved block leaked"
    assert a.alloc(2) is None          # only 1 free: refused atomically
    assert a.n_free == 1
    a.free(b1)
    assert a.n_free == 4
    with pytest.raises(ValueError):
        a.free(b1)                     # double free
    a.check()
    b3 = a.alloc(4)
    assert b3 is not None
    a.check()


def test_block_allocator_refcount_lru():
    a = BlockAllocator(8)                       # 6 usable
    evicted = []
    a.on_evict = evicted.append
    (b1,), (b2,) = a.alloc(1), a.alloc(1)
    a.acquire(b1)                               # second owner
    assert a.refcount(b1) == 2
    a.release(b1)
    assert a.refcount(b1) == 1                  # still live: not allocatable
    got = a.alloc(4)
    assert got is not None and b1 not in got and b2 not in got
    assert a.alloc(1) is None                   # all 6 live
    a.release(b1, cache=True)                   # park on the LRU
    assert a.refcount(b1) == 0 and a.n_free == 1
    a.acquire(b1)                               # a cached block revives
    assert a.refcount(b1) == 1 and a.n_free == 0
    a.release(b1, cache=True)
    a.release(b2, cache=True)                   # LRU order: b1 older than b2
    (victim,) = a.alloc(1)
    assert victim == b1 and evicted == [b1]     # oldest evicted, hook fired
    assert a.evictions == 1
    with pytest.raises(ValueError):
        a.acquire(victim + 100)                 # foreign block
    a.check()


def test_block_allocator_random_walk():
    """Seeded random acquire/release/alloc walk against a pure-python
    refcount model: never double-hands a block, never leaks."""
    rng = np.random.default_rng(7)
    a = BlockAllocator(12)
    ref, cached = {}, []                        # model: block -> refcount
    for _ in range(400):
        op = rng.integers(0, 4)
        if op == 0:                             # alloc
            n = int(rng.integers(1, 4))
            got = a.alloc(n)
            if got is None:
                # allocatable = everything not live (cached blocks evictable)
                assert 12 - RESERVED - len(ref) < n
            else:
                for b in got:
                    assert b not in ref, "live block handed out twice"
                    if b in cached:
                        cached.remove(b)
                    ref[b] = 1
        elif op == 1 and ref:                   # release a live ref
            b = int(rng.choice(sorted(ref)))
            cache = bool(rng.integers(0, 2))
            a.release(b, cache=cache)
            ref[b] -= 1
            if ref[b] == 0:
                del ref[b]
                if cache:
                    cached.append(b)
        elif op == 2 and (ref or cached):       # acquire live or cached
            b = int(rng.choice(sorted(ref) + cached))
            a.acquire(b)
            if b in cached:
                cached.remove(b)
                ref[b] = 1
            else:
                ref[b] += 1
        else:                                   # cross-check
            a.check()
            assert ref == a._ref
            assert a.n_free == 12 - RESERVED - len(ref)
    for b in sorted(ref):                       # drain: no block leaks
        for _ in range(ref[b]):
            a.release(b)
    a.check()
    assert a.n_free == 12 - RESERVED


def test_paged_cache_admit_release():
    cfg = reduced(get("tinyllama-1.1b"))
    kv = PagedKVCache(cfg, batch_size=2, max_len=64, block=16)
    assert kv.view_len == 64 and kv.blocks_per_slot == 4
    assert kv.allocator.n_free == 2 * 4
    assert kv.admit(0, 20)             # 2 blocks
    assert kv.admit(1, 64)             # full residency
    assert kv.allocator.n_free == 8 - 2 - 4
    # tables point only at owned blocks; unallocated entries at null block 0
    assert set(kv.tables[0][kv.tables[0] > 0]) == set(kv._owned[0])
    assert (kv.tables[0] == 0).sum() == 2
    # physical index math: pos p -> owned block, in-block offset p % block
    p = kv.phys(0, 17)
    assert p // kv.block == kv._owned[0][1] and p % kv.block == 1
    kv.release(0)
    kv.allocator.check()
    assert (kv.tables[0] == 0).all()
    assert kv.allocator.n_free == 8 - 4
    with pytest.raises(ValueError):
        kv.admit(1, 8)                 # occupied slot cannot double-admit


def _req(uid, n, priority=0, max_new=4):
    return Request(uid=uid, prompt=list(range(2, 2 + n)), max_new=max_new,
                   priority=priority)


def test_scheduler_admission_rejection():
    s = Scheduler(batch_size=2, max_len=16)
    bad = _req(0, 16)                  # prompt == max_len: can never fit
    assert not s.submit(bad)
    assert bad.done and "max_len" in bad.error and bad.out == []
    empty = _req(1, 0)
    assert not s.submit(empty) and empty.done
    ok = _req(2, 15)
    assert s.submit(ok) and not ok.done
    assert s.queue_depth() == 1


def test_scheduler_slot_refill_and_priority():
    s = Scheduler(batch_size=2, max_len=64)
    r_fifo = [_req(i, 4) for i in range(3)]
    r_prio = _req(9, 4, priority=1)
    for r in r_fifo:
        s.submit(r)
    s.submit(r_prio)
    placed = s.fill([0, 1], can_place=lambda r, slot: True)
    # priority queue drains first, then FIFO order
    assert [r.uid for _, r in placed] == [9, 0]
    assert s.pending_prefill == [0, 1]
    # capacity gate: nothing placeable -> nothing placed, queue intact
    placed = s.fill([0], can_place=lambda r, slot: False)
    assert placed == [] and s.queue_depth() == 2


def test_scheduler_prefill_grouping():
    s = Scheduler(batch_size=2, max_len=512, chunk_tokens=64)
    s.pending_prefill = [0, 1, 2]
    lens = {0: 100, 1: 10, 2: 300}
    group, s_pad = s.prefill_group(lens)
    # head always runs even beyond the 64/2=32-token budget; slot 2 waits
    assert group == [0, 1] and s_pad == 128
    assert s.pending_prefill == [2]
    group, s_pad = s.prefill_group(lens)
    assert group == [2] and s_pad == 512


def test_sampling_filters_match_reference():
    from repro.serve import sampling as jsampling
    logits = np.random.default_rng(3).standard_normal((4, 50)).astype(
        np.float32)
    t = torch.from_numpy(logits)
    for k in (1, 5):
        assert np.array_equal(sampling.top_k_mask(t, k).numpy(),
                              np.asarray(jsampling.top_k_mask(
                                  jnp.asarray(logits), k)))
    for p in (0.3, 0.9):
        assert np.array_equal(sampling.top_p_mask(t, p).numpy(),
                              np.asarray(jsampling.top_p_mask(
                                  jnp.asarray(logits), p)))
    greedy = sampling.make_sampler(0.0)(t, None)
    assert greedy.tolist() == logits.argmax(-1).tolist()
    gen = torch.Generator().manual_seed(0)
    drawn = sampling.make_sampler(0.7, top_k=3)(t, gen)
    top3 = np.argsort(logits, -1)[:, -3:]
    assert all(int(d) in row for d, row in zip(drawn, top3))


# ---------------------------------------------------------------------------
# What this slice refuses, and the rule that the port imports no jax
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["prefix", "draft", "gather", "state", "moe"])
def test_engine_refuses_later_slices(tlayout, case):
    cfg = reduced(get("tinyllama-1.1b"))
    kw = {"prefix": {"prefix_cache": True}, "draft": {"draft": object()},
          "gather": {"fused_decode": False}}.get(case, {})
    if case in ("state", "moe"):
        cfg = reduced(get("xlstm-350m" if case == "state" else "mixtral-8x7b"))
    with pytest.raises(ValueError, match="later serving slice"):
        Engine(cfg, tlayout, {}, **kw)


def test_multi_rank_refused():
    with pytest.raises(NotImplementedError, match="Multi-rank islands"):
        ParallelPlan(n_model=8).validate(mode="serve").build()
    lay = Layout(sizes={a: (2 if a == "z" else 1) for a in AXES})
    x = torch.zeros(2, 4, 8)
    assert comm.all_gather(lay, x, "y", dim=1) is x
    for fn, args in ((comm.all_gather, ("z", 1)), (comm.psum, ("z",)),
                     (comm.psum_scatter, ("z", 1))):
        with pytest.raises(NotImplementedError):
            fn(lay, x, *args)


def test_native_init_distribution():
    """init_params follows the reference's rules in distribution: fan_in
    weights have std 1/sqrt(fan_in), embeddings std 1, norms ones."""
    cfg = reduced(get("tinyllama-1.1b"))
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p))
    wq = p["stack"]["dense"]["attn"]["wq"].float()
    assert abs(wq.std().item() * math.sqrt(cfg.d_model) - 1) < 0.05
    assert abs(p["embed"].float().std().item() - 1) < 0.05
    assert (p["ln_f"]["g"] == 1).all()


def test_port_imports_no_jax_and_no_reference():
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "import repro_torch",
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):",
        "    importlib.import_module(m.name)",
        "from repro_torch.launch.serve import main",
        "stats = main(['--arch', 'tinyllama-1.1b', '--reduced', '--device',",
        "              'cpu', '--requests', '3', '--max-new', '4'])",
        "assert stats['tokens'] == 12, stats['tokens']",
        "from repro_torch.launch.train import main as train",
        "out = train(['--arch', 'tinyllama-1.1b', '--reduced', '--device',",
        "             'cpu', '--steps', '2', '--batch', '2', '--seq', '32'])",
        "assert len(out['losses']) == 1, out",
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')",
        "       or m == 'repro' or m.startswith('repro.')]",
        "assert not bad, bad",
        "print('NO-JAX-OK')",
    ])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO-JAX-OK" in r.stdout
