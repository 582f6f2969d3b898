"""Training launcher of the port:
``python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100``.

The flags of ``repro.launch.train`` plus ``--device {cuda,cpu}`` (default
cuda; with no card it exits with a message and never falls back to the
CPU), ``--cube X,Y,Z`` (the plan's cube; default the near-cube factors of
``--model``) and ``--backend {gloo,nccl}``.  It trains every family on one
device, the cube (1, 1, 1) at pp = 1 and dp = 1, with AdamW: dense, MoE
(mixtral, Moonlight, deepseek-v3 with MLA and the mtp head), hybrid
(zamba2), SSM (xlstm), VLM (internvl2: its ``--seq`` counts the
``n_vision_tokens`` patches ahead of the text, as the reference's does)
and audio (whisper: ``--seq`` text tokens beside the encoder's frames).
The dense family also trains above one device, on the 3-D cube or the
paper's 1-D (Megatron) and 2-D (SUMMA) baselines (``--strategy``) with data
parallelism (``--dp``, ``--model``, ``--cube``) and pipeline stages
(``--pp N --microbatch M``: each rank holds its stage's layers, the
activations crossing a stage by send/recv; ``plan=`` prints the bubble
(pp - 1) / m), and so does the MoE family without MLA (mixtral,
Moonlight) at pp 1, its experts split over the expert-parallel axes and
the tokens exchanged by all-to-all (``models/moe.py``), one rank a
device:

  * ``--host-devices N`` spawns N local ranks (the JAX launcher's flag,
    which gives JAX N host devices): CPU ranks with ``--device cpu``, or
    ranks that share the cards, ``LOCAL_RANK % device_count()``;
  * under ``torchrun`` each process is the rank its environment names
    (``launch/ranks.py``) and runs on card ``LOCAL_RANK %
    device_count()``.

The backend defaults to gloo for CPU ranks and NCCL for CUDA ranks, and is
never switched: NCCL with more ranks than cards raises, and ranks that
share a card take ``--backend gloo``, whose collectives go through the
host.  Only rank 0 prints; MFU divides by the peak of the world's cards.
``--optimizer adafactor`` trains every family (reference
``optim/optimizers.py``: anything else is AdamW), and ``--zero 0|1|2``
places the optimizer state over the data axes; the default resolves as
the reference's plan does, to 1 when ``--dp`` > 1, else 0, and ``--zero
1`` at one device raises its ValueError.  ``--overlap --overlap-chunks K``
chunks each 3-D island's collectives so that they run beside its
products (``core/ops3d.py``; the 3d strategy only, the reference's
ValueError otherwise).  The flags of what the port does not carry (the
other families above one device, MoE in pp stages) raise with a pointer
to ROADMAP.md.  A rank whose world is already joined when ``main`` runs
(a job that calls it twice) keeps that world; ``main`` leaves only the
world it joined.
Weights are drawn from seed 0 at the config's published shapes (``--layers``
and ``--d-model`` cut them; for the MoE family ``--dense-layers`` sets how
many leading layers are dense and ``--experts`` cuts the routed experts, so
that deepseek-v3 fits one card as [dense, moe] with 16 experts).  It prints the reference launcher's lines
(``arch=... plan=...``, ``params: ...M``, ``step N loss=... xent=...
lr=... gnorm=... s/step``, ``done: first loss ...``) and returns
{"losses", "telemetry", "start"}.

``--ckpt-dir`` follows the reference (``repro/launch/train.py:128-180``):
the latest step found there is restored (``restoring step N from DIR``),
parameters and optimizer state, and the loop runs from it to
``--steps``; every ``--ckpt-every`` steps the state is saved (``saved
DIR``) in the format both packages read (``checkpoint/store.py``): each
leaf's global value, whatever the layout, so that a run resumes on
another dp size, ZeRO stage or pp (the stage slabs re-cut by
``models.registry.repartition_stack``); a restored step at or past ``--steps``
prints ``nothing to do: restored step N >= --steps M``.  As in the
reference, a resumed run restarts the token stream from its first batch
rather than skipping the batches already trained on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

TODO = "not ported yet: see ROADMAP.md, Queue 1"


def _refuse(args, cfg):
    """NotImplementedError for what the port does not carry yet above one
    device: the families but the dense and the MoE ones, MoE in pipeline
    stages."""
    from repro_torch.core.plan import multi_rank_refusal
    err = multi_rank_refusal(args.dp * args.model * args.pp, cfg=cfg,
                             n_stages=args.pp)
    if err:
        raise NotImplementedError(f"{err}: {TODO}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--cube", default="",
                    help="the model cube as X,Y,Z (default: the near-cube "
                         "factors of --model)")
    ap.add_argument("--backend", default="", choices=["", "gloo", "nccl"],
                    help="torch.distributed backend above one device "
                         "(default: gloo for --device cpu, nccl for cuda)")
    ap.add_argument("--strategy", default="3d", choices=["3d", "2d", "1d"])
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages (a depth that does not "
                         "divide gives the first stages one layer more)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches per step (the "
                         "pipeline's m when --pp > 1)")
    ap.add_argument("--zero", type=int, default=-1,
                    help="ZeRO stage of the optimizer state over dp: 0 = "
                         "replicated, 1 = AdamW's moments sharded 1/dp, 2 = "
                         "also the f32 gradient accumulation; default: "
                         "auto (1 when --dp > 1, else 0)")
    ap.add_argument("--overlap", action="store_true",
                    help="async-TP: chunk each 3-D island's collectives so "
                         "that they run beside its products (3d only)")
    ap.add_argument("--overlap-chunks", type=int, default=4,
                    help="chunks of an island's contraction dim under "
                         "--overlap (the largest divisor up to this)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced variant")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--dense-layers", type=int, default=-1,
                    help="MoE family: leading dense layers (first_k_dense)")
    ap.add_argument("--experts", type=int, default=0,
                    help="MoE family: routed experts (top-k stays)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="spawn this many local ranks (one per device of "
                         "the plan)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace of the run here (plus a "
                         "<path>.jsonl event log)")
    ap.add_argument("--telemetry", default="",
                    help="per-step telemetry (step time, tokens/s, MFU, "
                         "memory high-water mark, non-finite sentinel); "
                         "writes the summary JSON here")
    ap.add_argument("--peak-flops", type=float, default=0,
                    help="device peak FLOP/s for MFU (default: the dense "
                         "bf16 peak of the card's data sheet; none on an "
                         "unknown card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.launch import ranks
    cfg = _config(args)
    _refuse(args, cfg)
    plan = _plan(args, cfg)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run the plain versions on the CPU)")
    world = args.dp * args.model * args.pp
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    me = ranks.rank_env() if world > 1 else None
    if world > 1:
        ranks.check_backend(backend, args.device, world)
    if world > 1 and me is None:
        if args.host_devices != world:
            raise ValueError(
                f"a plan of {world} devices runs {world} ranks: pass "
                f"--host-devices {world}, or start them with torchrun")
        return _spawn(argv if argv is not None else sys.argv[1:], world,
                      args.device)
    if me is not None and me.world != world:
        raise ValueError(f"{me.world} ranks for a plan of {world} devices")
    if world == 1 and args.host_devices > 1:
        raise ValueError(f"--host-devices {args.host_devices} for a plan of "
                         "one device: add --dp/--model")
    return _train(args, cfg, plan, me, backend)


def _plan(args, cfg):
    """The validated ParallelPlan of the flags (before any rank starts)."""
    from repro_torch.core.plan import ParallelPlan
    cube = tuple(int(c) for c in args.cube.split(",")) if args.cube \
        else None
    plan = ParallelPlan(n_dp=args.dp, n_model=args.model,
                        strategy=args.strategy, n_stages=args.pp,
                        microbatches=args.microbatch, cube=cube,
                        zero_stage=None if args.zero < 0 else args.zero,
                        overlap=args.overlap,
                        overlap_chunks=args.overlap_chunks)
    return plan.validate(n_layers=cfg.n_layers, global_batch=args.batch,
                         model=cfg, mode="train")


def _config(args):
    from repro_torch.config import reduced
    from repro_torch.configs.registry import get
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    changes = {}
    if args.layers:
        changes["n_layers"] = args.layers
    if args.d_model:
        changes["d_model"] = args.d_model
    if cfg.moe is not None and (args.experts or args.dense_layers >= 0):
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=args.experts or cfg.moe.n_experts,
            first_k_dense=(args.dense_layers if args.dense_layers >= 0
                           else cfg.moe.first_k_dense))
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    return cfg


def _spawn(argv, world: int, device: str) -> dict:
    """Run this launcher as ``world`` local ranks (``--host-devices``),
    print rank 0's output and return its result."""
    import tempfile

    from repro_torch.launch import ranks
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "result.json")
        env = dict(os.environ, REPRO_TORCH_RESULT=result)
        cores = os.cpu_count() or 1
        outs = ranks.spawn_local(
            [sys.executable, "-m", "repro_torch.launch.train", *argv], world,
            timeout=ranks.TIMEOUT_S, env=env,
            cpu_threads=max(1, cores // world) if device == "cpu" else 0)
        print(outs[0], end="", flush=True)
        with open(result) as f:
            return json.load(f)


def _train(args, cfg, plan, me, backend: str) -> dict:
    """The run of one rank (``me``; None at one device)."""
    import torch

    from repro_torch.checkpoint import store
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.core import comm
    from repro_torch.core.params import init_params, tree_leaves
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.launch import ranks
    from repro_torch.models import transformer
    from repro_torch.obs import make_tracer
    from repro_torch.obs.telemetry import TrainTelemetry, peak_flops_for
    from repro_torch.optim import adamw_init
    from repro_torch.optim.optimizers import opt_state_abstract
    from repro_torch.train.step import make_train_step

    import torch.distributed as dist
    device = torch.device(args.device)
    joined = False
    if me is not None:
        device = ranks.device_for(me, args.device)
        if not dist.is_initialized():
            ranks.init_world(me, backend, device)
            joined = True
        elif (dist.get_backend(), dist.get_rank(), dist.get_world_size()) \
                != (backend, me.rank, me.world):
            raise ValueError(
                f"the world this process joined runs {dist.get_backend()} "
                f"with rank {dist.get_rank()} of {dist.get_world_size()}, "
                f"not --backend {backend} with rank {me.rank} of "
                f"{me.world}")
    rank = 0 if me is None else me.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    if device.type == "cuda":
        # f32 stays IEEE; bf16 products accumulate in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

    layout = comm.init(plan.build(rank), backend)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = OptimConfig(name=args.optimizer, lr=args.lr,
                          warmup=args.warmup, total_steps=args.steps)
    tracer = make_tracer(bool(args.trace))

    say(f"arch={cfg.arch} layers={cfg.n_layers} d={cfg.d_model} "
        f"mesh={layout.sizes} plan={plan.describe()} device={device}"
        + (f" ranks={layout.n_devices} backend={backend}"
           if layout.n_devices > 1 else ""))
    gen = torch.Generator(device=device).manual_seed(0)
    abstract = transformer.abstract_params(cfg, layout)
    params = init_params(abstract, gen, device, getattr(torch, cfg.dtype),
                         layout=layout)
    n_params = sum(math.prod(p.shape) for p in tree_leaves(abstract))
    say(f"params: {n_params / 1e6:.1f}M")
    opt_abstract = opt_state_abstract(abstract, layout, opt_cfg)
    opt_state = adamw_init(params, layout, abstract, opt_cfg)
    step_fn = make_train_step(cfg, layout, opt_cfg)
    start = 0
    if args.ckpt_dir:
        last = store.latest_step(args.ckpt_dir)
        if last >= 0:
            say(f"restoring step {last} from {args.ckpt_dir}")
            params, opt_state, _ = store.restore(
                args.ckpt_dir, last, abstract, opt_abstract, device=device,
                dtype=getattr(torch, cfg.dtype), layout=layout, cfg=cfg)
            start = last
    data = TokenStream(cfg, shape, DataConfig(kind=args.data,
                                              path=args.data_path), device,
                       layout=layout)
    tel = None
    if args.telemetry:
        peak = args.peak_flops or peak_flops_for(device)
        cards = 1
        if device.type == "cuda":
            cards = min(layout.n_devices, torch.cuda.device_count())
        tel = TrainTelemetry(cfg, global_batch=args.batch, seq_len=args.seq,
                             device=device,
                             peak_flops=peak and peak * cards, tracer=tracer)
        tel.start()
    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        with tracer.span("data_next", track="train"):
            batch = next(data)
        with tracer.span("train_step", track="train", step=step) as sp:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if tel is not None:
                sp.sync(metrics["loss"])
        if tel is not None:
            tel.record(step, metrics)
            if tel.nonfinite is not None and "blame" not in tel.nonfinite:
                tel.nonfinite["blame"] = tel.blame(params)
                say(f"non-finite loss at step {step + 1}: "
                    f"{tel.nonfinite['blame']}", file=sys.stderr)
        if (step + 1) % args.log_every == 0 or step == start:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = (time.time() - t0) / (step - start + 1)
            parts = "".join(f"{k}={float(metrics[k]):8.4f} "
                            for k in ("xent", "aux", "mtp") if k in metrics)
            say(f"step {step + 1:5d} loss={loss:8.4f} {parts}"
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['gnorm']):7.3f} "
                f"{dt:6.2f}s/step", flush=True)
        if args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            d = store.save(args.ckpt_dir, step + 1, params, opt_state,
                           layout=layout, abstract=abstract,
                           opt_abstract=opt_abstract)
            say(f"saved {d}")
    if losses:
        say(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    else:
        say(f"nothing to do: restored step {start} >= --steps "
            f"{args.steps}")
    summary = None
    if tel is not None:
        summary = tel.summary()
        if rank == 0:
            tel.write(args.telemetry)
        say(tel.format_summary(), flush=True)
        say(f"telemetry: wrote {args.telemetry}")
    if args.trace and rank == 0:
        tracer.write_chrome(args.trace)
        tracer.write_jsonl(args.trace + ".jsonl")
        say(f"trace: wrote {args.trace} (+ {args.trace}.jsonl)")
    out = {"losses": losses, "telemetry": summary, "start": start}
    if me is not None:
        if rank == 0 and os.environ.get("REPRO_TORCH_RESULT"):
            with open(os.environ["REPRO_TORCH_RESULT"], "w") as f:
                json.dump(out, f)
        if joined:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
