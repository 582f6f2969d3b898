#!/usr/bin/env python3
"""Planted faults in K4's split route, held to ``chip_smoke.py``'s phase-3
limits: each fault must fail them, and the unchanged kernels must pass.

Copies ``src/repro_torch`` into a temporary directory once per case,
plants one fault in the copy's ``csrc/paged_decode_hopper.cu``, builds the
copies in parallel, then runs ``chip_smoke.k4_checks`` in bf16 (every case
of ``K4_CASES`` through both routes, against the plain version, to
``K4_NORM_TOL``) against each copy in a process of its own.  It prints
each case's errors and whether the limits caught it, and exits nonzero if
a fault passed or the unchanged copy failed.  The checkout is never
modified.  Needs an NVIDIA GPU and nvcc; from the root of a checkout:

    python3 tools/k4_planted_faults.py
"""
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("repro_torch/kernels/csrc/paged_decode_hopper.cu")
MASK = "  return p >= 0 && p <= cur && (window == 0 || cur - p < window);"

# name -> (text in the source, text that replaces it), or None for the
# unchanged kernels; each text occurs once in the source
FAULTS = {
    "none (the kernels as they are)": None,
    "combine: one split's partial dropped": (
        "    const float sc = exp2f(mp[s] - mx);",
        "    const float sc = s == c.splits / 2 ? 0.0f : exp2f(mp[s] - mx);"),
    "combine: one split's acc not rescaled by e^(m_s - M)": (
        "o[i] = fmaf(ap[s * D + lane + 32 * i], sc, o[i]);",
        "o[i] = fmaf(ap[s * D + lane + 32 * i],\n"
        "                                       s == c.splits / 2 ? 1.0f : sc,"
        " o[i]);"),
    "mask: pos <= cur turned into pos < cur": (
        MASK, MASK.replace("p <= cur", "p < cur")),
    "mask: the window test off by one": (
        MASK, MASK.replace("cur - p < window", "cur - p <= window")),
    "mask: a recycled block's stale positions (past cur) accepted": (
        MASK, MASK.replace("p <= cur && ", "")),
    "combine: the current token's fold skipped": (
        "    const float wc = exp2f(s0 - mx);",
        "    const float wc = 0.0f;"),
    "split: the GQA row mapping shifted by one kv head": (
        "  const int64_t row0 = (int64_t)b * a.nq + (int64_t)h * G;",
        "  const int64_t row0 = (int64_t)b * a.nq + "
        "(int64_t)((h + 1) % a.nkv) * G;"),
}

BUILD = ("from repro_torch.kernels import _build; "
         "_build.build(['paged_decode_hopper', 'paged_decode'])")
CHECK = """
import sys, torch
import chip_smoke as c
try:
    c.k4_checks(torch.device("cuda:0"), dtypes=("bfloat16",))
except c.SmokeFailure as e:
    print("caught:", e)
    sys.exit(3)
"""


def plant(dst: Path, fault) -> None:
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if fault is None:
        return
    old, new = fault
    path = dst / "src" / SOURCE
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"k4_planted_faults: {old!r} occurs "
                         f"{text.count(old)} times in {SOURCE.name}, not once")
    path.write_text(text.replace(old, new))


def env_for(copy: Path) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(copy / "src"), str(ROOT)]))


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="k4_faults_") as tmp:
        copies = {}
        for i, (name, fault) in enumerate(FAULTS.items()):
            copies[name] = Path(tmp) / f"case{i}"
            plant(copies[name], fault)
        builds = [subprocess.Popen([sys.executable, "-c", BUILD],
                                   env=env_for(c)) for c in copies.values()]
        if any([p.wait() for p in builds]):
            print("k4_planted_faults: a build failed")
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
        print(f"k4_planted_faults: {len(FAULTS) - 1} faults, "
              f"{'all as expected' if not wrong else f'wrong: {wrong}'}")
        return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
