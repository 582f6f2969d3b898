"""Training launcher of the port:
``python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 100``.

The flags of ``repro.launch.train`` plus ``--device {cuda,cpu}`` (default
cuda; with no card it exits with a message and never falls back to the
CPU).  It trains the dense family on one device, the cube (1, 1, 1) at
pp = 1 and dp = 1, with AdamW; the flags of what this slice does not carry
(more than one device, the 1-D/2-D baselines, overlap, ZeRO, Adafactor,
checkpoints, other families) raise with a pointer to ROADMAP.md.  Weights
are drawn from seed 0 at the config's published shapes.  It prints the
reference launcher's lines (``arch=... plan=...``, ``params: ...M``,
``step N loss=... xent=... lr=... gnorm=... s/step``, ``done: first loss
...``) and returns {"losses", "telemetry"}.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

TODO = "not ported yet: see ROADMAP.md, Queue 1"


def _refuse(args, cfg):
    """NotImplementedError for every flag this slice does not carry."""
    from repro_torch.config import Family
    bad = []
    if args.dp > 1 or args.model > 1 or args.pp > 1 or args.host_devices:
        bad.append("more than one device (--dp/--model/--pp/--host-devices;"
                   " 'Multi-rank islands', items 1-2 and 9)")
    if args.strategy != "3d":
        bad.append(f"--strategy {args.strategy} (the 1-D/2-D baselines, "
                   "item 3)")
    if args.overlap:
        bad.append("--overlap (async-TP overlap, item 8)")
    if args.zero >= 1:
        bad.append(f"--zero {args.zero} (ZeRO over dp, item 6)")
    if args.optimizer != "adamw":
        bad.append(f"--optimizer {args.optimizer} (Adafactor, item 6)")
    if args.ckpt_dir:
        bad.append("--ckpt-dir (checkpoints, item 9)")
    if cfg.family != Family.DENSE:
        bad.append(f"family {cfg.family.value!r} (item 10)")
    if bad:
        raise NotImplementedError(f"{'; '.join(bad)}: {TODO}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--strategy", default="3d", choices=["3d", "2d", "1d"])
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel stages (n_layers must divide)")
    ap.add_argument("--microbatch", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--zero", type=int, default=-1,
                    help="ZeRO stage over dp (only 0 / auto at one device)")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--overlap-chunks", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test reduced variant")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default="")
    ap.add_argument("--host-devices", type=int, default=0)
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

    from repro_torch.config import OptimConfig, ShapeConfig, reduced
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.obs import make_tracer
    from repro_torch.obs.telemetry import TrainTelemetry, peak_flops_for
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step

    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    changes = {}
    if args.layers:
        changes["n_layers"] = args.layers
    if args.d_model:
        changes["d_model"] = args.d_model
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    _refuse(args, cfg)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run the plain versions on the CPU)")
    device = torch.device(args.device)
    if device.type == "cuda":
        # f32 stays IEEE; bf16 products accumulate in f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False

    plan = ParallelPlan(n_dp=args.dp, n_model=args.model,
                        strategy=args.strategy, n_stages=args.pp,
                        microbatches=args.microbatch)
    plan.validate(n_layers=cfg.n_layers, global_batch=args.batch, model=cfg,
                  mode="train")
    layout = plan.build()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = OptimConfig(name=args.optimizer, lr=args.lr,
                          warmup=args.warmup, total_steps=args.steps)
    tracer = make_tracer(bool(args.trace))

    print(f"arch={cfg.arch} layers={cfg.n_layers} d={cfg.d_model} "
          f"mesh={layout.sizes} plan={plan.describe()} device={device}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device, getattr(torch, cfg.dtype))
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"params: {n_params / 1e6:.1f}M")
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, layout, opt_cfg)
    data = TokenStream(cfg, shape, DataConfig(kind=args.data,
                                              path=args.data_path), device)
    tel = None
    if args.telemetry:
        tel = TrainTelemetry(cfg, global_batch=args.batch, seq_len=args.seq,
                             device=device,
                             peak_flops=args.peak_flops
                             or peak_flops_for(device), tracer=tracer)
        tel.start()
    t0 = time.time()
    losses = []
    for step in range(args.steps):
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
                print(f"non-finite loss at step {step + 1}: "
                      f"{tel.nonfinite['blame']}", file=sys.stderr)
        if (step + 1) % args.log_every == 0 or step == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = (time.time() - t0) / (step + 1)
            print(f"step {step + 1:5d} loss={loss:8.4f} "
                  f"xent={float(metrics['xent']):8.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['gnorm']):7.3f} "
                  f"{dt:6.2f}s/step", flush=True)
    if losses:
        print(f"done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    summary = None
    if tel is not None:
        tel.write(args.telemetry)
        summary = tel.summary()
        print(tel.format_summary(), flush=True)
        print(f"telemetry: wrote {args.telemetry}")
    if args.trace:
        tracer.write_chrome(args.trace)
        tracer.write_jsonl(args.trace + ".jsonl")
        print(f"trace: wrote {args.trace} (+ {args.trace}.jsonl)")
    return {"losses": losses, "telemetry": summary}


if __name__ == "__main__":
    main()
