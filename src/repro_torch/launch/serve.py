"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch tinyllama-1.1b --requests 8``
builds the continuous-batching engine on one device (the paged KV cache
with chunked prefill for the dense and MoE families, the per-slot caches
with sequential prefill for zamba2, xlstm, internvl2 and whisper), submits
synthetic requests and reports the serving metrics (TTFT / TPOT p50/p95,
tok/s, prefix hits, accepted drafts).  Same flags as ``repro.launch.serve``
for the paths the port has (``--prefix-cache``, ``--draft ARCH
--spec-tokens N``, ``--no-fused-decode``), plus ``--device {cuda,cpu}``
(default cuda: raises when no GPU is present unless ``--device cpu``) and
``--layers N``, which cuts the depth.  Weights are drawn from ``--seed``
at the config's published shapes, a draft's too (so a draft of the
target's own arch is the target itself, as in the reference);
``--ckpt-dir`` then restores the target's parameters from the latest step
saved there by either package's train launcher (reference
``repro/launch/serve.py:108-114``).  Exits nonzero when no tokens were
produced; returns the engine's stats with each request's tokens under
``outputs``.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (mixtral-8x7b "
                         "holds 16 of its 32 on an 80 GB card; deepseek-v3 "
                         "at 4 is its 3 dense layers and one MoE layer)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--strategy", default="3d", choices=["3d", "2d", "1d"])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the k most likely tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=0.0,
                    help="nucleus sampling mass (0 = off)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the sampler")
    ap.add_argument("--priority", type=int, default=0,
                    help="submit every Nth request on the priority queue "
                         "(0 = all FIFO)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV cache block size (tokens per block)")
    ap.add_argument("--prefill-chunk", type=int, default=4096,
                    help="max padded tokens per chunked-prefill step")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="sequential prefill (one prompt token per engine "
                         "step)")
    ap.add_argument("--inference-opt", action="store_true",
                    help="x-replicated decode weights (zero per-token gathers)")
    ap.add_argument("--no-fused-decode", action="store_true",
                    help="paged decode over gathered per-slot views instead "
                         "of the fused block-table path")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=False,
                    help="shared-prefix KV reuse: prompts whose prefix is "
                         "resident enter by block reference (copy-on-write "
                         "on partial-block divergence)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--draft", default="",
                    help="draft model arch for speculative decoding (greedy "
                         "output stays identical to the non-speculative "
                         "engine)")
    ap.add_argument("--spec-tokens", type=int, default=4,
                    help="draft tokens proposed per speculative step (γ)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many common tokens to every "
                         "synthetic request")
    ap.add_argument("--ckpt-dir", default="",
                    help="restore the parameters of the latest checkpoint "
                         "step here")
    ap.add_argument("--trace", default="",
                    help="write a Chrome-trace of the run here (plus a "
                         "<path>.jsonl event log)")
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from repro_torch.checkpoint import store
    from repro_torch.config import reduced
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer
    from repro_torch.obs import make_tracer
    from repro_torch.serve import Engine, Request
    from repro_torch.serve.metrics import format_summary
    from repro_torch.serve.speculate import DraftSpec

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available (pass "
                 "--device cpu to run the plain versions on the CPU)")
    device = torch.device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dcfg = None
    if args.draft:
        dcfg = get(args.draft)
        if args.reduced:
            dcfg = reduced(dcfg)
    plan = ParallelPlan(n_dp=args.dp, n_model=args.model,
                        strategy=args.strategy)
    # an illegal pairing fails here, before any weights are built
    plan.validate(n_layers=cfg.n_layers, model=cfg, mode="serve",
                  draft=dcfg)
    layout = plan.build()
    if args.inference_opt:
        layout = dataclasses.replace(layout, inference_opt=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"serving {cfg.arch}{' (reduced)' if args.reduced else ''} on "
          f"{layout.n_devices} device ({name}), cube={layout.cube}, "
          f"cache={transformer.serve_cache_mode(cfg)}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(transformer.abstract_params(cfg),
                         gen, device, getattr(torch, cfg.dtype))
    if args.ckpt_dir:
        last = store.latest_step(args.ckpt_dir)
        if last >= 0:
            params, _, _ = store.restore(
                args.ckpt_dir, last, transformer.abstract_params(cfg),
                device=device, dtype=getattr(torch, cfg.dtype))
            print(f"restored checkpoint step {last}")
    draft = None
    if dcfg is not None:
        dgen = torch.Generator(device=device).manual_seed(args.seed)
        dparams = init_params(transformer.abstract_params(dcfg), dgen,
                              device, getattr(torch, dcfg.dtype))
        draft = DraftSpec(dcfg, layout, dparams, gamma=args.spec_tokens)
        print(f"draft: {dcfg.arch}, gamma={args.spec_tokens}")
    tracer = make_tracer(bool(args.trace))
    eng = Engine(cfg, layout, params, batch_size=args.batch_size,
                 max_len=args.max_len, temperature=args.temperature,
                 top_k=args.top_k, top_p=args.top_p, seed=args.seed,
                 block_size=args.block_size,
                 prefill_chunk=args.prefill_chunk,
                 chunked_prefill=not args.no_chunked_prefill,
                 fused_decode=not args.no_fused_decode,
                 prefix_cache=args.prefix_cache, draft=draft, tracer=tracer)
    common = [3 + j % 13 for j in range(args.shared_prefix)]
    reqs = [Request(uid=i,
                    prompt=common + [2 + (i + j) % 17
                                     for j in range(3 + i % 5)],
                    max_new=args.max_new,
                    priority=(1 if args.priority and i % args.priority == 0
                              else 0))
            for i in range(args.requests)]
    stats = eng.run(reqs)
    for r in reqs[:4]:
        tag = f" [rejected: {r.error}]" if r.error else ""
        print(f"  req {r.uid}: {len(r.prompt)} prompt -> {r.out}{tag}")
    print(format_summary(stats))
    if stats["nonfinite_rows"]:
        print(f"  WARNING: {stats['nonfinite_rows']} emitted tokens came "
              "from non-finite logits")
    if args.trace:
        tracer.write_chrome(args.trace)
        tracer.write_jsonl(args.trace + ".jsonl")
        print(f"trace: wrote {args.trace} (+ {args.trace}.jsonl)")
    if stats["tokens"] <= 0:
        sys.exit("no tokens generated")
    return dict(stats, outputs=[r.out for r in reqs])


if __name__ == "__main__":
    main()
