#!/usr/bin/env python3
"""Paired serving runs of two checkouts on one card: ``python3
tools/serve_ab.py --base DIR`` serves, in the order base, this tree, this
tree, base, tinyllama-1.1b and mixtral-8x7b cut to 16 layers with
``chip_smoke.py`` phases 7's and 7m's traffic and zamba2-1.2b and
xlstm-350m with phases 7z's and 7x's, each through
``repro_torch.launch.serve`` in a fresh process after that tree's kernels
are built, and prints one JSON line a run (TTFT p50, TPOT p50, tok/s);
``--out FILE`` also writes them.  Run from the root of this tree, with
the base unpacked somewhere (``git archive``)."""
import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--requests", "8", "--batch-size", "8", "--max-new", "32",
          "--max-len", "512"]
RUNS = {"tinyllama-1.1b": ["--shared-prefix", "256"],
        "zamba2-1.2b": ["--shared-prefix", "40"],
        "xlstm-350m": ["--shared-prefix", "40"],
        "mixtral-8x7b": ["--shared-prefix", "256", "--layers", "16"]}


def serve(tree, arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", arch, "--device", "cuda"] + COMMON
                       + RUNS[arch], cwd=tree, env=env, capture_output=True,
                       text=True, timeout=600)
    if r.returncode:
        raise RuntimeError(f"{tree} {arch}: {r.stdout[-2000:]}"
                           f"{r.stderr[-3000:]}")
    p50 = dict(re.findall(r"(TTFT|TPOT) p50\s+([\d.]+) ms", r.stdout))
    return {"ttft_p50_ms": float(p50["TTFT"]),
            "tpot_p50_ms": float(p50["TPOT"]),
            "tok_per_s": float(re.search(r"= ([\d.]+) tok/s",
                                         r.stdout).group(1))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    base = os.path.abspath(args.base)
    for tree in (base, ROOT):                # build each tree's kernels
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels "
                        "import _build; _build.build()"], cwd=tree,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(tree, "src")),
                       check=True, capture_output=True, timeout=600)
    runs = []
    for label, tree in (("base", base), ("this", ROOT), ("this", ROOT),
                        ("base", base)):
        for arch in RUNS:
            rec = dict(tree=label, arch=arch, **serve(tree, arch))
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)


if __name__ == "__main__":
    main()
