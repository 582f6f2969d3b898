"""One train step's FLOPs and collective bytes by kind at a small plan:
the JAX package's compiled HLO against the port's dry-run trace.

    python tools/dryrun_reference_bytes.py --arch tinyllama-1.1b \\
        --layers 2 --batch 4 --seq 2048 --plan cube [--reduced] [--json]

runs two subprocesses, no device: the reference's side (``--side
reference``: the JAX package on 8 host devices compiles its
``make_train_step`` at the plan and reads the HLO) and the port's
(``--side port``: ``repro_torch.launch.dryrun.trace_step`` of rank 0 in a
fake world of the plan's size), then prints per kind the port's bytes a
device, the reference's as ``launch/hlo_cost.HloCost`` counts them, and
the reference's counted with the collectives whose result is a tuple
(XLA's combined all-reduces, every all-to-all), which ``HloCost`` and
``launch/dryrun.collective_stats`` skip; the dtypes of the reference
program's collectives before XLA's CPU compiler rewrites them; then the
reference's largest
collectives by kind, dtype and ``op_name`` (the HLO's metadata), bytes x
trip count, and the port's by kind, dtype and the function that called
``core/comm.py``.  The ring model is the same on both sides (``core/comm.py``).
``--json`` prints the two sides' results as one JSON object instead.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# make_layout's arguments of each plan (both packages take them)
PLANS = {"cube": dict(n_model=8, cube=(2, 2, 2)),
         "dp2": dict(n_dp=2, n_model=4, cube=(2, 2, 1)),
         "1d": dict(n_dp=2, n_model=4, strategy="1d"),
         "2d": dict(n_dp=2, n_model=4, strategy="2d"),
         "pp2": dict(n_model=4, cube=(1, 2, 2), n_pp=2, microbatches=4),
         "overlap": dict(n_model=8, cube=(2, 2, 2), overlap=True,
                         overlap_chunks=4)}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_ELEM_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_TUPLE_RE = re.compile(r"=\s*\((.*?)\)\s+(?:%s)(?:-start)?\(" % "|".join(
    KINDS))
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_DT_RE = re.compile(r"=\s*\(?([a-z0-9]+)\[")


def _config(args, package):
    import dataclasses
    mod = __import__(f"{package}.configs.registry", fromlist=["get"])
    cfg = mod.get(args.arch)
    if args.reduced:
        red = __import__(f"{package}.config", fromlist=["reduced"]).reduced
        cfg = red(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def _ring(kind, out_bytes, n):
    """The ring model's bytes a device (``core/comm.py``, the reference's
    ``hlo_cost.py:230-239``)."""
    if kind == "all-reduce":
        return 2 * out_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)
    if kind == "collective-permute":
        return out_bytes
    return out_bytes * (n - 1) / n


def tuple_aware(hc):
    """Per kind, ``HloCost``'s rows plus the tuple-shaped collectives it
    skips (each element of the tuple one result), bytes x trip count:
    {"by_kind", "counts", "skipped_by_kind", "by_op"}."""
    from repro.launch import hlo_cost as H
    by = dict.fromkeys(KINDS, 0.0)
    counts = dict.fromkeys(KINDS, 0)
    skipped = dict.fromkeys(KINDS, 0.0)
    by_op = {}
    for comp, instrs in hc.comps.items():
        m = hc.mult.get(comp, 1.0)
        if m == 0:
            continue
        for _, dt, dims, line in instrs:
            kind = next((c for c in KINDS if f" {c}(" in line
                         or f" {c}-start(" in line), None)
            if kind is None:
                continue
            if dt is not None:
                outs, dts = [H._shape_bytes(dt, dims)], {dt}
            else:
                mt = _TUPLE_RE.search(line)
                if mt is None:
                    continue
                elems = _ELEM_RE.findall(mt.group(1))
                outs = [H._shape_bytes(a, b) for a, b in elems]
                dts = {a for a, _ in elems}
            n = 2
            g2, g1 = H._GROUPS2_RE.search(line), H._GROUPS_RE.search(line)
            if g2:
                n = max(2, int(g2.group(2)))
            elif g1:
                first = g1.group(1).strip("{}")
                n = max(2, len([t for t in first.split(",") if t.strip()]))
            moved = m * sum(_ring(kind, b, n) for b in outs)
            by[kind] += moved
            counts[kind] += int(m)
            if dt is None:
                skipped[kind] += moved
            mo = _OPNAME_RE.search(line)
            key = (f"{kind} {'/'.join(sorted(dts))} "
                   f"{mo.group(1) if mo else '?'}")
            by_op[key] = by_op.get(key, 0.0) + moved
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:24]
    return {"by_kind": by, "counts": counts, "skipped_by_kind": skipped,
            "by_op": top}


def reference_side(args) -> dict:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    from repro.config import OptimConfig, ShapeConfig
    from repro.core.params import abstract_arrays
    from repro.core.topology import make_layout
    from repro.launch.hlo_cost import HloCost
    from repro.models import transformer
    from repro.optim import opt_state_abstract
    from repro.train.step import make_train_step
    cfg = _config(args, "repro")
    lay = make_layout(**PLANS[args.plan])
    opt_cfg = OptimConfig(name=args.optimizer)
    abstract = transformer.abstract_params(cfg, lay)
    params = abstract_arrays(abstract, lay)
    opt = abstract_arrays(opt_state_abstract(abstract, lay, opt_cfg), lay)
    specs = transformer.input_specs(
        cfg, lay, ShapeConfig("plan", args.seq, args.batch, "train"))
    step = make_train_step(cfg, lay, opt_cfg)
    lowered = jax.jit(step, donate_argnums=(0, 1)).lower(params, opt, *specs)
    # the program's own collectives and their dtypes, before XLA's CPU
    # compiler rewrites them
    program = {}
    for line in lowered.as_text(dialect="hlo").splitlines():
        kind = next((c for c in KINDS if f" {c}(" in line), None)
        m = _DT_RE.search(line) if kind else None
        if m:
            key = f"{kind} {m.group(1)}"
            program[key] = program.get(key, 0) + 1
    hc = HloCost(lowered.compile().as_text())
    return {"flops": hc.flops(), "hlo_cost": hc.collective_bytes(),
            "tuple_aware": tuple_aware(hc), "program": program}


def port_side(args) -> dict:
    """The trace, its bytes also by call site: the caller of
    ``core/comm.py`` that issued each collective, and its dtype."""
    from repro_torch.config import OptimConfig
    from repro_torch.core import comm
    from repro_torch.core.topology import make_layout
    from repro_torch.launch.dryrun import trace_step
    cfg = _config(args, "repro_torch")
    by_site, real = {}, comm._count

    def count(kind, nbytes):
        real(kind, nbytes)
        f = sys._getframe(1)
        t = f.f_locals.get("out", f.f_locals.get("buf"))
        while f is not None and f.f_code.co_filename == comm.__file__:
            f = f.f_back
        site = (f"{os.path.basename(f.f_code.co_filename)}:"
                f"{f.f_code.co_name}" if f is not None else "?")
        key = f"{kind} {str(t.dtype).replace('torch.', '')} {site}"
        by_site[key] = by_site.get(key, 0.0) + nbytes
    comm._count = count
    res = trace_step(cfg, make_layout(**PLANS[args.plan]), args.batch,
                     args.seq, OptimConfig(name=args.optimizer))
    res["by_site"] = sorted(by_site.items(), key=lambda kv: -kv[1])[:24]
    return res


def _run(side, argv) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--side", side, *argv], env=env,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode:
        raise RuntimeError(f"{side} side failed:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--plan", default="cube", choices=list(PLANS))
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--side", default="", choices=["", "reference", "port"])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.side:
        res = (reference_side if args.side == "reference"
               else port_side)(args)
        print(json.dumps(res))
        return 0
    argv = [a for a in (argv if argv is not None else sys.argv[1:])
            if a != "--json"]
    res = {"reference": _run("reference", argv), "port": _run("port", argv)}
    if args.json:
        print(json.dumps(res))
        return 0
    ref, port = res["reference"], res["port"]
    mb = 1e6
    print(f"{args.arch} {'reduced ' if args.reduced else ''}{args.layers} "
          f"layers, {args.batch} x {args.seq}, plan {args.plan} "
          f"{PLANS[args.plan]}: MB a device a step (ring model)")
    print(f"{'kind':20s} {'port':>10s} {'HloCost':>10s} {'with tuples':>12s}"
          f" {'(skipped)':>10s}  counts port / reference")
    for k in KINDS:
        t = ref["tuple_aware"]
        print(f"{k:20s} {port['collectives']['by_kind'][k] / mb:10.1f} "
              f"{ref['hlo_cost']['by_kind'][k] / mb:10.1f} "
              f"{t['by_kind'][k] / mb:12.1f} {t['skipped_by_kind'][k] / mb:10.1f}"
              f"  {port['collectives']['counts'][k]} / {t['counts'][k]}")
    print(f"FLOPs: port {port['flops']:.4g}, reference HloCost "
          f"{ref['flops']:.4g} (port / reference "
          f"{port['flops'] / ref['flops']:.3f})")
    print("the reference program's collectives before compiling (kind "
          "dtype: count): " + ", ".join(
              f"{k} {v}" for k, v in sorted(ref["program"].items())))
    print("the reference's largest collectives (kind dtype op_name: MB):")
    for key, v in ref["tuple_aware"]["by_op"]:
        print(f"  {key}: {v / mb:.1f}")
    print("the port's largest (kind dtype caller: MB):")
    for key, v in port["by_site"]:
        print(f"  {key}: {v / mb:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
