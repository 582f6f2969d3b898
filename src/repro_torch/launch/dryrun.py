"""The dry run (port of ``repro/launch/dryrun.py``): every architecture
and input shape at the production layout, 256 devices on a pod and 512
on two, with no device.

``python -m repro_torch.launch.dryrun --arch all --shape all`` takes the
reference's flags and prints its lines.  For each (arch, shape, pods) it
builds rank 0's layout over the production mesh (``build_layout``: the
arch's cube, the shape's batch and sequence axes, the batch axes that
exceed the global batch dropped) and then:

  * SKIP, with the reference's reasons: long_500k on an arch without
    sub-quadratic attention, pp > 1 with a serving shape
    (``plan.pipeline_mode_error``), a config that does not pipeline
    (``registry.pipeline_unsupported_reason``);
  * LOWERED (``--lower-only``): the layout, the parameter tree on the
    layout's specs, the
    ``pipeline`` block at pp > 1, and for a train shape ``memory_model``,
    the reference's per-device params, grads, optimizer state and
    activation estimate, key for key;
  * OK (the default, a train shape whose plan the port runs above one
    device): the trace.  In a fake world of ``layout.n_devices`` ranks in
    this one process (``torch.distributed``'s fake backend, whose
    collectives move nothing), rank 0 runs its real ``make_train_step``
    once on meta tensors: the parameters, the optimizer state (AdamW;
    Adafactor for deepseek-v3, as the reference's) and its shard of the
    batch.  ``cost.flops`` is ``FlopCounterMode``'s count of that step
    (``FlopCount``, its formulas without its overheads),
    ``collectives`` the ring-model bytes and counts by kind that its
    collectives add to ``comm.bytes_moved``.  At pp > 1 the first rank
    of every stage is traced, the largest figures reported and each
    stage's beside them (``stages``).  A plan that
    ``plan.multi_rank_refusal`` refuses (serving shapes, MLA, the hybrid,
    SSM, VLM and audio families, MoE in pp stages) is a SKIP naming that
    reason, its memory model still printed; so is one whose step a layer
    refuses (``NotImplementedError``: at the 1-D production layout
    gemma-2b's 8 heads over 16 ranks, qwen3-4b's qk-norm with its kv
    heads replicated).

The kernels' wrappers take their plain versions on meta tensors, which
compute shapes and dtypes only (``kernels/_build.on_cuda``); the dry run
touches no device, as the reference's runs on placeholder host devices.
The reference's compiled figures, XLA's ``memory`` block (the peak) and
``cost.bytes_accessed``, have no counterpart here.  Where this
installation of PyTorch lacks the fake backend
(``torch.testing._internal.distributed.fake_pg``) the trace raises,
naming it.  The module imports no jax and nothing of the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback

import torch

from ..config import SHAPES, ModelConfig, OptimConfig, ShapeConfig
from ..configs.registry import ARCH_IDS, LONG_OK, cube_for, get
from ..core.params import Param, local_shape, sharded_bytes, tree_map
from ..core.pipeline import pipeline_report
from ..core.plan import multi_rank_refusal, pipeline_mode_error
from ..core.topology import Layout
from ..models import registry as model_registry
from ..models import transformer
from ..optim.optimizers import opt_state_abstract, zero_partition_spec
from .mesh import (make_framework_layout, production_mesh_shape,
                   shape_layout_args)

FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def build_layout(arch: str, shape_name: str, multi_pod: bool, strategy: str,
                 n_pp: int = 1, microbatches: int = 1, zero_stage: int = 1,
                 rank: int = 0) -> Layout:
    """Rank ``rank``'s production layout of ``arch`` at ``shape_name``
    (reference ``dryrun.py:91-107``): the batch axes whose running product
    exceeds the global batch are dropped."""
    args = shape_layout_args(shape_name, multi_pod)
    lay = make_framework_layout(multi_pod=multi_pod, strategy=strategy,
                                cube=cube_for(arch, 16, strategy),
                                n_pp=n_pp, microbatches=microbatches,
                                zero_stage=zero_stage, rank=rank, **args)
    bax, prod = [], 1
    for a in args["batch_axes"]:
        if prod * lay.size(a) <= SHAPES[shape_name].global_batch:
            bax.append(a)
            prod *= lay.size(a)
    return dataclasses.replace(lay, batch_axes=tuple(bax))


def opt_config(arch: str) -> OptimConfig:
    """The optimizer the reference's dry run lowers: Adafactor for
    deepseek-v3-671b, else AdamW (``dryrun.py:219``)."""
    return OptimConfig(name="adafactor" if arch == "deepseek-v3-671b"
                       else "adamw")


def memory_model(cfg: ModelConfig, layout: Layout, shape: ShapeConfig,
                 opt_cfg: OptimConfig) -> dict:
    """Per-device memory under the layout's specs (reference
    ``dryrun.py:110-174``, key for key): the parameters, the gradients
    (f32 when microbatching, on the ZeRO specs at stage 2), the optimizer
    state, its replicated baseline and the saving, and the per-family
    activation estimate over the stage's resident blocks plus the
    pipeline carry (``models/registry.Stack.act_bytes``, ``carry_bytes``),
    a rough lower bound."""
    abstract = transformer.abstract_params(cfg, layout)
    zs = layout.effective_zero_stage()
    m = max(layout.microbatches, 1)
    param_b = sharded_bytes(abstract, layout)

    def grad_param(p: Param) -> Param:
        spec = zero_partition_spec(p, layout) if zs >= 2 else p.spec
        return dataclasses.replace(p, spec=spec, dtype=torch.float32
                                   if m > 1 else p.dtype)
    grad_b = sharded_bytes(tree_map(grad_param, abstract), layout)
    opt_b = sharded_bytes(opt_state_abstract(abstract, layout, opt_cfg),
                          layout)
    lay0 = dataclasses.replace(layout, zero_stage=0)
    opt_b0 = sharded_bytes(opt_state_abstract(abstract, lay0, opt_cfg), lay0)

    stack = model_registry.get_stack(cfg.family)
    bsh = math.prod(layout.size(a) for a in layout.batch_axes) or 1
    ssh = math.prod(layout.size(a) for a in layout.seq_axes) \
        * layout.size("y")
    b_dev = max(shape.global_batch / m / bsh, 1)
    s_dev = shape.seq_len / ssh
    n_blocks = len(stack.layer_plan(cfg))
    resident = -(-n_blocks // layout.size("pp"))     # stage slots (ceil)
    act_b = (resident * stack.act_bytes(cfg, layout, b_dev, s_dev)
             + stack.carry_bytes(cfg, layout, b_dev))
    return {
        "zero_stage": zs,
        "param_gib": param_b / 2**30,
        "grad_gib": grad_b / 2**30,
        "opt_gib": opt_b / 2**30,
        "opt_replicated_gib": opt_b0 / 2**30,
        "opt_savings_x": round(opt_b0 / max(opt_b, 1), 2),
        "act_est_gib": act_b / 2**30,
    }


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------
class FlopCount:
    """The FLOPs of the ops run inside it, by ``torch.utils.flop_counter``'s
    formulas (``flop_registry``): ``FlopCounterMode``'s count of a train
    step, which this matches op for op, without its per-module tracking
    and its Python decompositions of the ops it has no formula for, which
    made a production-size trace on meta tensors 1.5x slower."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        count = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                f = flop_registry.get(func._overloadpacket)
                if f is not None:
                    count.total += f(*args, **kwargs, out_val=out)
                return out
        self.total, self._mode = 0, Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


@contextlib.contextmanager
def fake_world(world: int, rank: int):
    """A ``torch.distributed`` world of ``world`` ranks in which this
    process is ``rank``, over the fake backend; torn down on exit.  Raises
    where the backend is missing, or where this process is already in a
    world."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"the dry run's trace needs {FAKE_PG} (the fake "
                           "process group), which this installation of "
                           f"PyTorch lacks: {e}") from e
    if dist.is_initialized():
        raise RuntimeError("the dry run's trace runs in a fake world of its "
                           "own: this process is already in a world")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def meta_tree(abstract, layout: Layout, dtype):
    """A meta tensor of the rank's block of every leaf of a tree of
    Params, in the leaf's pinned dtype or ``dtype``."""
    return tree_map(lambda p: torch.empty(
        local_shape(p.shape, p.spec, layout), dtype=p.dtype or dtype,
        device="meta"), abstract)


def meta_batch(cfg: ModelConfig, layout: Layout, rows: int, seq: int):
    """The rank's shard of a train batch of ``rows`` x ``seq`` as meta
    tensors, the shapes ``data.pipeline.shard_batch`` cuts (the tokens'
    sequence over the entry layout's axis, the labels' over the logits'),
    nothing drawn: the text families' batches, tokens and labels, the
    only ones with a multi-rank layout."""
    from ..core.linear3d import act_axes, out_axes
    from ..core.topology import entry_dirs
    s = model_registry.get_stack(cfg.family).label_len(cfg, seq)
    dirs = entry_dirs()
    seq_ax = {"tokens": act_axes(layout, dirs)[0],
              "labels": out_axes(layout, dirs)[0]}
    return {k: torch.empty(local_shape(
        (rows, s), (layout.batch_axes, (*layout.seq_axes, ax)), layout),
        dtype=torch.long, device="meta") for k, ax in seq_ax.items()}


def trace_step(cfg: ModelConfig, layout: Layout, rows: int, seq: int,
               opt_cfg: OptimConfig) -> dict:
    """Rank ``layout.rank``'s one train step of a ``rows`` x ``seq`` batch
    on meta tensors, in a fake world of ``layout.n_devices`` ranks (no
    world at one device): {"flops": ``FlopCount``'s count,
    "collectives": ``comm.bytes_moved()`` of the step}.  Raises where the
    port does not run the plan (``make_train_step``)."""
    from ..core import comm
    from ..optim import adamw_init
    from ..train.step import make_train_step
    world = (fake_world(layout.n_devices, layout.rank)
             if layout.n_devices > 1 else contextlib.nullcontext())
    with world:
        layout = comm.init(layout, "fake")
        step = make_train_step(cfg, layout, opt_cfg)
        abstract = transformer.abstract_params(cfg, layout)
        params = meta_tree(abstract, layout, getattr(torch, cfg.dtype))
        opt = adamw_init(params, layout, abstract, opt_cfg)
        batch = meta_batch(cfg, layout, rows, seq)
        comm.reset_bytes()
        with FlopCount() as fc:
            step(params, opt, batch)
        return {"flops": float(fc.total),
                "collectives": comm.bytes_moved()}


def trace_stages(cfg: ModelConfig, layout: Layout, rows: int, seq: int,
                 opt_cfg: OptimConfig) -> dict:
    """``trace_step`` of the first rank of every pp stage of ``layout``
    (rank 0 alone at pp 1): the largest FLOPs and the largest collective
    bytes over the stages, and at pp > 1 each stage's (``stages``)."""
    pp = layout.size("pp")
    per = layout.n_devices // (layout.n_data * pp)      # a stage's ranks
    stages = []
    for s in range(pp):
        r = s * per
        got = trace_step(cfg, dataclasses.replace(layout, rank=r), rows,
                         seq, opt_cfg)
        stages.append({"stage": s, "rank": r, **got})
    top = max(stages, key=lambda x: x["collectives"]["bytes_per_device"])
    out = {"flops": max(x["flops"] for x in stages),
           "collectives": top["collectives"]}
    if pp > 1:
        out["stages"] = stages
    return out


def lower_one(arch: str, shape_name: str, *, multi_pod: bool,
              strategy: str = "3d", compile_: bool = True,
              force_window: int = 0, n_pp: int = 1, microbatches: int = 1,
              zero_stage: int = 1, overlap: bool = False,
              overlap_chunks: int = 4) -> dict:
    """One (arch, shape, pods) of the dry run (reference
    ``dryrun.py:177-271``): SKIP, LOWERED (``compile_=False``) or, by the
    trace, OK or a SKIP naming ``multi_rank_refusal``'s reason."""
    cfg = get(arch)
    if force_window and not cfg.window:
        # a sliding-window variant of a full-attention arch, reported as
        # "<arch>+swa", never as the assigned config itself
        cfg = dataclasses.replace(cfg, window=force_window)
        arch_tag = arch + "+swa"
    else:
        arch_tag = arch
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and arch not in LONG_OK and not cfg.window:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "SKIP", "reason": "full quadratic attention; "
                "sub-quadratic required (DESIGN.md §4)"}
    if n_pp > 1 and shape.kind != "train":
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "SKIP",
                "reason": pipeline_mode_error(n_pp, shape.kind)}
    if n_pp > 1:
        reason = model_registry.pipeline_unsupported_reason(cfg, n_pp)
        if reason:
            return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                    "status": "SKIP", "reason": reason}
    layout = build_layout(arch, shape_name, multi_pod, strategy, n_pp,
                          microbatches, zero_stage)
    if overlap:
        layout = dataclasses.replace(layout, overlap=True,
                                     overlap_chunks=overlap_chunks)
    t0 = time.time()
    transformer.abstract_params(cfg, layout)
    opt_cfg = opt_config(arch)
    res = {"arch": arch_tag, "shape": shape_name, "multi_pod": multi_pod,
           "strategy": strategy, "status": "LOWERED",
           "mesh": dict(layout.sizes),
           "t_lower_s": round(time.time() - t0, 1)}
    if n_pp > 1:
        res["pipeline"] = pipeline_report(n_pp, microbatches)
    if shape.kind == "train":
        res["memory_model"] = memory_model(cfg, layout, shape, opt_cfg)
    if not compile_:
        return res
    refusal = multi_rank_refusal(
        layout.n_devices, cfg=cfg,
        mode="train" if shape.kind == "train" else "serve", n_stages=n_pp)
    if refusal:
        return dict(res, status="SKIP", reason=refusal)
    t0 = time.time()
    try:
        got = trace_stages(cfg, layout, shape.global_batch, shape.seq_len,
                           opt_cfg)
    except NotImplementedError as e:    # a layer the port refuses here
        return dict(res, status="SKIP", reason=str(e))
    res["t_trace_s"] = round(time.time() - t0, 1)
    res["cost"] = {"flops": got["flops"]}
    res["collectives"] = got["collectives"]
    if "stages" in got:
        res["stages"] = got["stages"]
    res["status"] = "OK"
    return res


def format_result(tag: str, res: dict) -> list:
    """The lines the reference prints for one result
    (``dryrun.py:313-374``): the status line, then the memory model's."""
    line = f"{tag:60s} {res['status']}"
    if res["status"] == "OK":
        line += (f" flops={res['cost']['flops']:.3e}"
                 f" comm={res['collectives']['bytes_per_device']/2**30:.3f}"
                 f"GiB (lower {res['t_lower_s']}s trace "
                 f"{res['t_trace_s']}s)")
    if "pipeline" in res:
        pl = res["pipeline"]
        line += (f" bubble={pl['bubble_fraction']:.3f}"
                 f" eff={pl['efficiency']:.3f}")
    if res["status"] == "SKIP":
        line += f" ({res['reason']})"
    lines = [line]
    if res["status"] == "OK":
        by = res["collectives"]["by_kind"]
        lines.append("    comm/device by kind "
                     + " ".join(f"{k}={v / 2**30:.4f}GiB"
                                for k, v in by.items() if v))
        for st in res.get("stages", ()):
            lines.append(f"    stage {st['stage']} (rank {st['rank']}) "
                         f"flops={st['flops']:.3e} comm="
                         f"{st['collectives']['bytes_per_device']/2**30:.3f}"
                         "GiB")
    if "memory_model" in res:
        mm = res["memory_model"]
        for part, key in (("params", "param_gib"), ("grads", "grad_gib"),
                          ("opt", "opt_gib"), ("act(est)", "act_est_gib")):
            note = ""
            if part == "opt":
                note = (f"  [replicated {mm['opt_replicated_gib']:.3f} GiB "
                        f"-> {mm['opt_savings_x']}x saved, "
                        f"zero={mm['zero_stage']}]")
            lines.append(f"    mem/device {part:8s} {mm[key]:9.3f} GiB{note}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + ["all"])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--strategy", default="3d", choices=["3d", "2d", "1d"])
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (carved out of the data axis)")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="pipeline microbatches m (bubble = (pp-1)/m); "
                         "default: 8 when --pp > 1, else 1")
    ap.add_argument("--zero", type=int, default=-1, choices=[-1, 0, 1, 2],
                    help="ZeRO stage of the optimizer state (0 replicated, "
                         "1 sharded m/v, 2 + sharded grad accumulation); "
                         "default: auto (1)")
    ap.add_argument("--overlap", action="store_true",
                    help="async-TP: chunked 3-D island collectives "
                         "(strategy=3d only)")
    ap.add_argument("--overlap-chunks", type=int, default=4,
                    help="chunks per overlapped island matmul")
    ap.add_argument("--lower-only", action="store_true",
                    help="the layout and the memory model, no trace")
    ap.add_argument("--force-window", type=int, default=0,
                    help="run a sliding-window variant of full-attention "
                         "archs")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)

    if not args.microbatch:
        args.microbatch = 8 if args.pp > 1 else 1
    archs = ARCH_IDS if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    pods = []
    if args.single_pod or not args.multi_pod:
        pods.append(False)
    if args.multi_pod:
        pods.append(True)
    for mp in pods:
        print(f"production mesh multi_pod={mp}: "
              f"{production_mesh_shape(multi_pod=mp)}", flush=True)

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = (f"{arch} x {shape} x {'2pod' if mp else '1pod'} "
                       f"[{args.strategy}]")
                if args.pp > 1:
                    tag += f" pp={args.pp} m={args.microbatch}"
                if args.zero >= 0:
                    tag += f" zero={args.zero}"
                try:
                    res = lower_one(arch, shape, multi_pod=mp,
                                    strategy=args.strategy,
                                    compile_=not args.lower_only,
                                    force_window=args.force_window,
                                    n_pp=args.pp,
                                    microbatches=args.microbatch,
                                    zero_stage=1 if args.zero < 0
                                    else args.zero,
                                    overlap=args.overlap,
                                    overlap_chunks=args.overlap_chunks)
                except Exception as e:
                    traceback.print_exc()
                    res = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "strategy": args.strategy, "status": "FAIL",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                for line in format_result(tag, res):
                    print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(res) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
