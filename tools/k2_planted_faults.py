#!/usr/bin/env python3
"""Planted faults in K2's tc kernels, held to ``chip_smoke.py``'s phase-5
limits: each fault must fail them, and the unchanged kernels must pass.

Copies ``src/repro_torch`` into a temporary directory once per case,
plants one fault in the copy's ``csrc/flash_attention_hopper.cu``, builds
the copies in parallel, then runs ``chip_smoke.k2_case`` (the tc route
against the plain version at the tinyllama training shape, 4 x 2048, 32/4
heads, d 64, causal, bf16) against each copy in a process of its own.  It
prints each case's errors and whether the limits caught it, and exits
nonzero if a fault passed or the unchanged copy failed.  The checkout is
never modified.  Needs an NVIDIA GPU and nvcc; from the root of a
checkout:

    python3 tools/k2_planted_faults.py
"""
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("repro_torch/kernels/csrc/flash_attention_hopper.cu")


def skip(cond):
    """Consumer code that drops the stage it just waited for when ``cond``
    holds, releasing it to the producer as a finished stage would be."""
    return (f"      if ({cond}) {{\n"
            "        if (lane == 0) mbar_arrive(empty(s));\n"
            "        continue;\n"
            "      }\n")


WAIT = "      mbar_wait(full(s), (i / STAGES) & 1);\n"

# name -> (text in the source, text that replaces it); each text occurs
# once.  The k16 slices: slice 1 of the product reads slice 0's operand.
FAULTS = {
    "none (the kernels as they are)": None,
    "forward: key tile 1 of each q tile dropped": (
        WAIT + "      zero<BK / 2>(sc);\n",
        WAIT + skip("i == 1 && n > 2") + "      zero<BK / 2>(sc);\n"),
    "forward: k16 slice 1 of P V wrong": (
        "wgmma_rs<D, 1>(o, pa[kk], mnmajor(v_s, BK, kk));",
        "wgmma_rs<D, 1>(o, pa[kk == 1 ? 0 : kk], mnmajor(v_s, BK, kk));"),
    "dq: k16 slice 1 of dS K wrong": (
        "wgmma_rs<D, 1>(dq, da[kk], mnmajor(k_s, BK, kk));",
        "wgmma_rs<D, 1>(dq, da[kk == 1 ? 0 : kk], mnmajor(k_s, BK, kk));"),
    "dk/dv: q head 1 of each GQA group dropped": (
        WAIT + "      float st[BQ / 2], dpt[BQ / 2];\n",
        WAIT + skip("i / n == 1") + "      float st[BQ / 2], dpt[BQ / 2];\n"),
    "dk: k16 slice 1 of dS^T Q wrong": (
        "wgmma_rs<D, 1>(dk, da[kk], mnmajor(q_s, BQ, kk));",
        "wgmma_rs<D, 1>(dk, da[kk == 1 ? 0 : kk], mnmajor(q_s, BQ, kk));"),
    "dv: k16 slice 1 of P^T dO wrong": (
        "wgmma_rs<D, 1>(dv, pa[kk], mnmajor(do_s, BQ, kk));",
        "wgmma_rs<D, 1>(dv, pa[kk == 1 ? 0 : kk], mnmajor(do_s, BQ, kk));"),
    # the same faults confined to the last q tile (128 of 2048 rows) or to
    # the middle key tile (64 of 2048 keys)
    "forward: k16 slice 1 of P V wrong on the last q tile": (
        "wgmma_rs<D, 1>(o, pa[kk], mnmajor(v_s, BK, kk));",
        "wgmma_rs<D, 1>(o, pa[kk == 1 && q0 + BQ >= a.Sq ? 0 : kk], "
        "mnmajor(v_s, BK, kk));"),
    "dq: k16 slice 1 of dS K wrong on the last q tile": (
        "wgmma_rs<D, 1>(dq, da[kk], mnmajor(k_s, BK, kk));",
        "wgmma_rs<D, 1>(dq, da[kk == 1 && q0 + BQ >= a.Sq ? 0 : kk], "
        "mnmajor(k_s, BK, kk));"),
    "dk/dv: q head 1 dropped on the middle key tile": (
        WAIT + "      float st[BQ / 2], dpt[BQ / 2];\n",
        WAIT + skip("i / n == 1 && blockIdx.y == gridDim.y / 2")
        + "      float st[BQ / 2], dpt[BQ / 2];\n"),
}

BUILD = ("from repro_torch.kernels import _build; "
         "_build.build(['flash_attention_hopper'])")
CHECK = """
import sys, torch
import chip_smoke as c
from repro_torch.kernels import flash_attention as k2
label, b, s, nq, nkv, window = c.K2_SHAPES[0]
gen = torch.Generator(device="cuda").manual_seed(4)
try:
    c.k2_case(k2, "cuda", gen, b, s, nq, nkv, window, torch.bfloat16,
              ["tc"], label)
except c.SmokeFailure as e:
    print("caught:", e)
    sys.exit(3)
"""


def plant(dst: Path, fault) -> None:
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault is None:
        return
    path = dst / "src" / SOURCE
    text = path.read_text()
    old, new = fault
    if text.count(old) != 1:
        raise SystemExit(f"k2_planted_faults: {old!r} occurs "
                         f"{text.count(old)} times in {SOURCE}, not once")
    path.write_text(text.replace(old, new))


def env_for(copy: Path) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(copy / "src"), str(ROOT)]))


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="k2_faults_") as tmp:
        copies = {}
        for i, (name, fault) in enumerate(FAULTS.items()):
            copies[name] = Path(tmp) / f"case{i}"
            plant(copies[name], fault)
        builds = [subprocess.Popen([sys.executable, "-c", BUILD],
                                   env=env_for(c)) for c in copies.values()]
        if any([p.wait() for p in builds]):
            print("k2_planted_faults: a build failed")
            return 1
        wrong = []
        for name, copy in copies.items():
            proc = subprocess.run([sys.executable, "-c", CHECK],
                                  env=env_for(copy), capture_output=True,
                                  text=True, cwd=ROOT)
            print(f"== {name}\n{proc.stdout.strip()}\n{proc.stderr[-2000:]}"
                  .rstrip())
            caught = proc.returncode == 3
            if proc.returncode not in (0, 3) or caught == (
                    FAULTS[name] is None):
                wrong.append(name)
            print(f"== {name}: {'caught' if caught else 'passed'} "
                  f"(exit {proc.returncode})")
        print(f"k2_planted_faults: {len(FAULTS) - 1} faults, "
              f"{'all as expected' if not wrong else f'wrong: {wrong}'}")
        return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
