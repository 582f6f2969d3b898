#!/usr/bin/env python3
"""K4's split route at fixed split counts beside its plan's.

For each K4 shape that ``chip_smoke.py`` phase 3 times (the serve shape,
64 slots of 1024-2048 tokens, and 16 of them at d 128 in blocks of 32),
prints the device time (``chip_smoke.graph_ms``) of
``paged_flash_decode_step`` with the grid of ``split_plan`` (one wave of
the CTAs an SM holds), with the grid a fixed 3 CTAs an SM would give (the
d 64, block 16 figure), and with ``split_plan`` replaced by each fixed
split count, each with the waves it launches.  It shows whether one wave
is the right grid at each ring size.  Needs an NVIDIA GPU and nvcc; from
the root of a checkout (about 30 s):

    python3 tools/k4_split_sweep.py
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_decode as k4  # noqa: E402

# (label, contexts, table columns, head dim, block), as phase 3 times them
SHAPES = [("serve", c.K4_SERVE, 32, c.DH, 16),
          ("long", c.K4_LONG, 128, c.DH, 16),
          ("long, d 128, block 32", c.K4_WIDE, 64, 128, 32)]
FIXED = (1, 2, 4, 8, 16, 32)
REPS = 100


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_split_sweep: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip())
    dev = torch.device("cuda:0")
    sms = _build.sm_count(dev.index)
    plan = k4.split_plan
    for label, lens, nb, d, block in SHAPES:
        args, new = c.k4_case(dev, lens, nb, torch.bfloat16,
                              seed=len(label), d=d, block=block)

        def step():
            return k4.paged_flash_decode_step(args[0], *new, *args[1:],
                                              block=block)
        n, cols, stages, per_sm = k4.split_grid(args[0], args[1], args[4],
                                                block)
        wave = per_sm * sms
        ctas = len(lens) * c.NKV
        readings = [f"plan {n} splits of {cols}: "
                    f"{c.graph_ms(step, REPS):.4f} ms, "
                    f"{n * ctas / wave:.2f} waves"]
        three, _ = plan(len(lens), c.NKV, nb, 3 * sms)
        counts = {three: "at 3 CTAs an SM "}
        for fixed in FIXED:
            counts.setdefault(k4.split_cols(nb, fixed, k4.WARPS)[0], "")
        for got, note in counts.items():
            k4.split_plan = lambda B, nkv, nb, wave, got=got: \
                k4.split_cols(nb, got, k4.WARPS)
            try:
                ms = c.graph_ms(step, REPS)
            finally:
                k4.split_plan = plan
            readings.append(f"{note}{got} splits: {ms:.4f} ms, "
                            f"{got * ctas / wave:.2f} waves")
        print(f"K4 {label} (B {len(lens)}, d {d}, block {block}, {nb} "
              f"columns; {per_sm} CTAs an SM, {stages} stages), split step "
              f"device time (graph_ms): " + "; ".join(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
