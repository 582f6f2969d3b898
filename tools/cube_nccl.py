#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 30 over NCCL, one rank a card: tinyllama-1.1b
at full width and depth in bf16, 4 x 2048, remat, AdamW, ``RANK_STEPS``
(2) steps, through ``repro_torch.launch.train`` under torchrun on 4 ranks
at the cube (1, 2, 2) (the layout of ``tests/test_multidev.py:132``),
against one rank on one card (phase 8 at those steps): each loss within
3e-2, each rank's K1/K2/K3 launches exact; each rank's step time,
tokens/s, peak memory and collective bytes a step by kind; then again in
the same world with the islands chunked (``--overlap --overlap-chunks
4``, K1 once a chunk).  Unlike phase 30's 8 ranks sharing one card over
gloo, the collectives run card to card, so only here can the overlap
show in the step time.  With ``--profile`` both runs go again in that
world under torch.profiler, and the last step of each is split on the
card by kernel group, the NCCL kernels by collective, with the
collectives' time outside every compute kernel (``chip_smoke.step_split``).
Needs 4 NVIDIA GPUs and nvcc; from the root of a checkout:

    python3 tools/cube_nccl.py [--profile]
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as c  # noqa: E402

LAYOUTS = {"cube122": (1, 4, (1, 2, 2))}
RANKS = 4


def main() -> int:
    import torch
    if torch.cuda.device_count() < RANKS:
        print(f"cube_nccl: needs {RANKS} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0]})"
    print(f"cube_nccl on {torch.cuda.device_count()} x {card}")
    c.phase_build()
    _, _, _, tel = c.phase_train(card, steps=c.RANK_STEPS)
    runs = c.rank_runs(LAYOUTS, overlap=tuple(LAYOUTS))
    if "--profile" in sys.argv[1:]:
        runs += [r._replace(name=f"{r.name}_profiled", profile=True)
                 for r in runs]
    out = c.phase_ranks_train(card, tel["series"]["loss"], runs,
                              nranks=RANKS, backend="nccl")
    print(json.dumps({"one_rank": c.train_numbers(tel), "nccl": out}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
