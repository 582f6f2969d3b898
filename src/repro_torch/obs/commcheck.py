"""Measured against analytic per-device collective bytes for each parallel
plan (port of ``repro/obs/commcheck.py``).

The paper's claim is a communication-cost claim: per-device volume for 1-D
(Megatron) tensor parallelism stays O(1) in p, 2-D (Optimus) falls as
O(1/sqrt(p)) and the 3-D cube as O(1/p^(2/3)).

  * **measured**: one forward and backward of the training loss on each
    plan, in a world of p ranks, with the train step's sums of the leaves'
    gradients; ``core/comm.py``'s counter holds the ring-model bytes of
    every collective a rank issued (the reference reads them from the
    compiled HLO, ``launch/hlo_cost.py``).  The plan's figure is the
    largest rank's, with that rank's bytes by kind and counts.
  * **analytic**: the alpha-beta per-matmul formulas of
    ``benchmarks/analytic.py`` (a test holds the two equal), on the
    config's own matmul shapes.

``check()`` reports the plans and the ordering ``3d < 2d < 1d`` of the
measured bytes; ``main`` exits non-zero when it is violated.

    PYTHONPATH=src python -m repro_torch.obs.commcheck
    PYTHONPATH=src python -m repro_torch.obs.commcheck --device cpu \
        --host-devices 8

The card is the default, as for every entry point of the port: with no
CUDA device ``main`` exits with a message and never falls back to the
CPU.  ``--device cpu --host-devices N`` runs each plan's p ranks as local
CPU processes over gloo (``launch/ranks.spawn_local``; every plan needs
p <= N).  With ``--device cuda`` each plan runs under
``torch.distributed.run --standalone --nproc-per-node p``, its ranks on
the cards (``LOCAL_RANK % device_count()``; gloo where ranks share a
card, which stages the collectives through the host and leaves the
count unchanged).
``--rank-of STRATEGY`` is the entry of one such rank; started under
``torch.distributed.run`` by hand it measures that plan over the whole
world and rank 0 prints the plan's line.

**Shape regime** (the reference's module docstring): the ordering is
asymptotic in p and holds per layer only where token traffic dominates
weight traffic.  For one layer with d_ff = a·h at the degrees above the
model predicts ``3d < 2d < 1d`` for t in ((6+3a)h/(9.5-1.5a), (2+a)h)
tokens: for a = 4 a sliver, for a = 1 a wide band (1.125h..3h).  The
defaults therefore run paper-transformer with ``d_ff = d_model``, a 4096
vocabulary and t = 2h tokens (12 x 512 at h = 3072).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

BYTES_BF16 = 2
PLANS = {"1d": 8, "2d": 4, "3d": 8}      # 2d needs a square degree


# ---------------------------------------------------------------------------
# Analytic side: per-device bytes of one C = AB, forward and backward, for
# M tokens, N input features, K output features and p model-parallel
# devices (``benchmarks/analytic.py:comm_1d/2d/3d``)
# ---------------------------------------------------------------------------
def comm_1d(M, N, K, p, bytes_per=BYTES_BF16):
    if K > N:                       # up-projection (col-parallel): no comm
        return 0.0
    ar = 2 * bytes_per * M * K * (p - 1) / p
    return 2 * ar                   # fwd + bwd all-reduce


def comm_2d(M, N, K, p, bytes_per=BYTES_BF16):
    q = int(round(math.sqrt(p)))
    ag_x = bytes_per * (M * N / p) * (q - 1)
    ag_w = bytes_per * (N * K / p) * (q - 1)
    fwd = ag_x + ag_w
    return fwd + 2 * fwd            # dX and dW each re-gather


def comm_3d(M, N, K, p, bytes_per=BYTES_BF16):
    c = round(p ** (1 / 3))
    ag_a = bytes_per * (M * N / (c * c)) * (c - 1) / c
    ag_b = bytes_per * (N * K / (c * c)) * (c - 1) / c
    rs_c = bytes_per * (M * K / (c * c)) * (c - 1) / c
    return 3 * (ag_a + ag_b + rs_c)


COMM = {"1d": comm_1d, "2d": comm_2d, "3d": comm_3d}


def config_matmuls(cfg, batch: int, seq: int) -> List[Tuple[int, int, int]]:
    """(M, N, K) of one layer at the config's shapes: the fused qkv, the
    attention's out projection and the MLP pair (a gated MLP has two up
    projections)."""
    t = batch * seq
    h = cfg.d_model
    dh = cfg.head_dim
    qkv = (cfg.n_heads + 2 * cfg.n_kv) * dh
    up = (2 if cfg.act in ("silu", "gelu") else 1) * cfg.d_ff
    return [(t, h, qkv), (t, cfg.n_heads * dh, h), (t, h, up),
            (t, cfg.d_ff, h)]


def analytic_bytes(cfg, strategy: str, p: int, batch: int, seq: int) -> float:
    """Per-device collective bytes of one forward and backward over the
    layer stack (the embedding, the head and the norms left out; the
    measured side has them, which the report's ratio shows)."""
    mm = config_matmuls(cfg, batch, seq)
    return sum(COMM[strategy](M, N, K, p) for M, N, K in mm) * cfg.n_layers


# ---------------------------------------------------------------------------
# Measured side
# ---------------------------------------------------------------------------
def plan_config(arch: str, n_layers: int = 4, d_ff: int = 0,
                vocab: int = 4096, reduced: bool = False, changes=None):
    """The measured config: ``arch`` (its smoke-test variant with
    ``reduced``) with ``changes`` applied, cut to ``n_layers``, its MLP
    ``d_ff`` wide (0: d_model, the wide window) and ``vocab`` (0: the
    arch's own)."""
    from ..config import reduced as reduce
    from ..configs.registry import get
    cfg = get(arch)
    if reduced:
        cfg = reduce(cfg)
    cfg = dataclasses.replace(cfg, **(changes or {}))
    return dataclasses.replace(cfg, n_layers=n_layers,
                               d_ff=d_ff or cfg.d_model,
                               vocab=vocab or cfg.vocab)


def measure(cfg, layout, batch: int, seq: int, device) -> dict:
    """One forward and backward of the training loss on this rank of
    ``layout`` (its groups attached, ``comm.init``), with the train step's
    sums of the leaves' gradients: ``comm.bytes_moved()`` over that work,
    and the loss.  The weights and tokens are drawn from seed 0."""
    import numpy as np
    import torch

    from ..core import comm
    from ..core.params import init_params
    from ..data.pipeline import shard_batch, to_device
    from ..models import transformer
    from ..train.step import loss_and_grads

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(transformer.abstract_params(cfg, layout), gen,
                         device, getattr(torch, cfg.dtype), layout=layout)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (batch, seq + 1))
    data = to_device(shard_batch({"tokens": toks[:, :-1],
                                  "labels": toks[:, 1:]}, layout), device)
    comm.reset_bytes()
    loss, _, _ = loss_and_grads(cfg, layout, params, data)
    return dict(comm.bytes_moved(), loss=float(loss))


def measure_rank(cfg, strategy: str, batch: int, seq: int, me,
                 device: str) -> dict:
    """``measure`` on rank ``me`` of a world of p ranks, joined here, on
    the plan (1, 1, p, strategy): the largest rank's reading, with its
    rank."""
    import torch
    import torch.distributed as dist

    from ..core import comm
    from ..core.topology import make_layout
    from ..launch import ranks

    dev = ranks.device_for(me, device)
    backend = "nccl" if (dev.type == "cuda" and
                         me.world <= torch.cuda.device_count()) else "gloo"
    ranks.init_world(me, backend, dev)
    layout = comm.init(make_layout(1, 1, me.world, strategy, rank=me.rank),
                       backend)
    got = measure(cfg, layout, batch, seq, dev)
    every = [None] * me.world
    dist.all_gather_object(every, got)
    dist.destroy_process_group()
    top = max(range(me.world), key=lambda r: every[r]["bytes_per_device"])
    return dict(every[top], rank=top, cube=list(layout.cube),
                n_model=me.world)


def _run_plan(cfg_args: list, strategy: str, p: int, batch: int, seq: int,
              device: str, host_devices: int) -> dict:
    """Start the plan's p ranks (``--rank-of``, the config from
    ``cfg_args``) and return rank 0's result."""
    from ..launch import ranks
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "plan.json")
        args = ["--rank-of", strategy, "--batch", str(batch), "--seq",
                str(seq), "--device", device, "--result", out, *cfg_args]
        if device == "cpu":
            if p > host_devices:
                raise ValueError(f"plan {strategy} of {p} ranks: pass "
                                 f"--host-devices {p} or more")
            ranks.spawn_local(
                [sys.executable, "-m", "repro_torch.obs.commcheck", *args],
                p, timeout=ranks.TIMEOUT_S, workdir=tmp,
                cpu_threads=max(1, (os.cpu_count() or 1) // p))
        else:
            src = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                x for x in (src, os.environ.get("PYTHONPATH", "")) if x))
            subprocess.run(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(p), "-m",
                 "repro_torch.obs.commcheck", *args],
                env=env, check=True, timeout=ranks.TIMEOUT_S)
        with open(out) as f:
            return json.load(f)


def plan_report(cfg, strategy: str, meas: dict, batch: int,
                seq: int) -> dict:
    """A plan's entry of the report from its measurement (``measure_rank``:
    the largest rank's reading, its rank, cube and p)."""
    p = meas["n_model"]
    ana = analytic_bytes(cfg, strategy, p, batch, seq)
    return {"n_model": p, "cube": meas["cube"],
            "measured_bytes_per_device": meas["bytes_per_device"],
            "measured_by_kind": meas["by_kind"],
            "measured_counts": meas["counts"],
            "measured_rank": meas["rank"], "loss": meas["loss"],
            "analytic_bytes_per_device": ana,
            "ratio_measured_over_analytic": (
                meas["bytes_per_device"] / ana if ana else float("inf"))}


def report(cfg, batch: int, seq: int, device: str, plans: dict) -> dict:
    """The report (JSON-ready) of the plans' entries (``plan_report``),
    with the orderings ``3d < 2d < 1d`` of the measured and the analytic
    bytes when all three are there."""
    rep = {"arch": cfg.arch, "batch": batch, "seq": seq,
           "n_layers": cfg.n_layers, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "tokens": batch * seq, "device": device, "plans": plans}
    if {"1d", "2d", "3d"} <= set(plans):
        for side in ("measured", "analytic"):
            b = {s: plans[s][f"{side}_bytes_per_device"] for s in plans}
            rep[f"ordering_{side}_3d_2d_1d"] = b["3d"] < b["2d"] < b["1d"]
    return rep


def check(arch: str = "paper-transformer", batch: int = 12, seq: int = 512,
          n_layers: int = 4, d_ff: int = 0, vocab: int = 4096,
          plans: Optional[Dict[str, int]] = None, *, device: str = "cuda",
          host_devices: int = 0, reduced: bool = False,
          changes: Optional[dict] = None) -> dict:
    """The measured and analytic report across the plans (the reference's
    ``check``); its ``ordering_measured_3d_2d_1d`` is the criterion.  The
    config is ``plan_config``'s."""
    cfg = plan_config(arch, n_layers, d_ff, vocab, reduced, changes)
    cfg_args = ["--arch", arch, "--layers", str(n_layers), "--d-ff",
                str(d_ff), "--vocab", str(vocab),
                "--changes", json.dumps(changes or {})]
    if reduced:
        cfg_args.append("--reduced")
    return report(cfg, batch, seq, device, {
        strat: plan_report(cfg, strat, _run_plan(
            cfg_args, strat, p, batch, seq, device, host_devices),
            batch, seq)
        for strat, p in (PLANS if plans is None else plans).items()})


def format_report(rep: dict) -> str:
    lines = [f"commcheck: {rep['arch']} batch={rep['batch']} "
             f"seq={rep['seq']} layers={rep['n_layers']} d_ff={rep['d_ff']} "
             f"vocab={rep['vocab']} device={rep['device']} (per-device "
             "collective bytes, fwd+bwd)",
             f"{'plan':<14}{'p':>3}  {'measured':>12}  {'analytic':>12}"
             f"  {'ratio':>6}  counts"]
    for strat in ("1d", "2d", "3d"):
        r = rep["plans"].get(strat)
        if r is None:
            continue
        counts = " ".join(f"{k.split('-')[-1]}={v}"
                          for k, v in r["measured_counts"].items() if v)
        cube = "x".join(str(c) for c in r["cube"])
        lines.append(f"{strat + ' (' + cube + ')':<14}{r['n_model']:>3}  "
                     f"{r['measured_bytes_per_device']:>12.3e}  "
                     f"{r['analytic_bytes_per_device']:>12.3e}  "
                     f"{r['ratio_measured_over_analytic']:>6.2f}  {counts}")
    if "ordering_measured_3d_2d_1d" in rep:
        ok = rep["ordering_measured_3d_2d_1d"]
        lines.append("measured per-device volume ordering 3d < 2d < 1d: "
                     + ("OK" if ok else "VIOLATED"))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-transformer")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=0,
                    help="override d_ff (0 = d_model, the wide-window "
                         "regime; see the module docstring)")
    ap.add_argument("--vocab", type=int, default=4096,
                    help="override vocab (0 = the arch's own)")
    ap.add_argument("--out", default="",
                    help="also write the report as JSON here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--host-devices", type=int, default=0,
                    help="run each plan's ranks as this many local CPU "
                         "processes at most (the default plans need 8)")
    ap.add_argument("--reduced", action="store_true",
                    help="start from the arch's smoke-test variant")
    ap.add_argument("--rank-of", default="", choices=["", *PLANS],
                    help="be one rank of this strategy's plan, the world "
                         "from the environment")
    ap.add_argument("--changes", default="{}",
                    help="JSON of further config fields to override, e.g. "
                         "'{\"n_heads\": 8}' so that a reduced model's "
                         "heads split over 8 ranks")
    ap.add_argument("--result", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device is available (pass "
                 "--device cpu --host-devices 8 to run the plans' ranks on "
                 "the CPU)")
    if args.rank_of:
        from ..launch import ranks
        me = ranks.rank_env()
        if me is None:
            sys.exit("--rank-of: no RANK/WORLD_SIZE in the environment "
                     "(start it under torch.distributed.run)")
        cfg = plan_config(args.arch, args.layers, args.d_ff, args.vocab,
                          args.reduced, json.loads(args.changes))
        res = measure_rank(cfg, args.rank_of, args.batch, args.seq, me,
                           args.device)
        if me.rank == 0:
            print(json.dumps(res))
            if args.result:
                with open(args.result, "w") as f:
                    json.dump(res, f)
        return res
    if args.device == "cpu" and not args.host_devices:
        sys.exit("--device cpu: pass --host-devices N (the default plans "
                 "need 8)")
    rep = check(args.arch, args.batch, args.seq, args.layers,
                d_ff=args.d_ff, vocab=args.vocab, device=args.device,
                host_devices=args.host_devices, reduced=args.reduced,
                changes=json.loads(args.changes))
    print(format_report(rep))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True)
        print(f"# wrote {args.out}", file=sys.stderr)
    if not rep.get("ordering_measured_3d_2d_1d", False):
        sys.exit("measured comm ordering violated (expected 3d < 2d < 1d)")
    return rep


if __name__ == "__main__":
    main()
