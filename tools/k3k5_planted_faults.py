#!/usr/bin/env python3
"""Planted faults in K3's and K5's kernels, held to ``chip_smoke.py``'s
phase-4 and phase-11 limits: each fault must fail them, and the unchanged
kernels must pass.

Copies ``src/repro_torch`` into a temporary directory once per case,
plants one fault in the copy's ``csrc/rmsnorm.cu`` or ``csrc/ssd_scan.cu``,
builds the copies in parallel, then runs the checks of the faulty kernel
against each copy in a process of its own: ``chip_smoke.k3_case`` at the
training shape (8192 x 2048, f32 and bf16) for K3, ``chip_smoke.k5_case``
at zamba2's training shape (4 x 2048, 64 heads, f32 and bf16 B/C) for K5.
It prints each case's errors and whether the limits caught it, and exits
nonzero if a fault passed or the unchanged copy failed.  The checkout is
never modified.  Needs an NVIDIA GPU and nvcc; from the root of a
checkout:

    python3 tools/k3k5_planted_faults.py
"""
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("repro_torch/kernels/csrc")

# name -> (kernel, source, text in the source, text that replaces it);
# each text occurs once in its source
FAULTS = {
    "none (the kernels as they are)": ("K3 K5", None, None, None),
    "K3 forward: y of one row not written": (
        "K3", "rmsnorm.cu",
        "    *reinterpret_cast<P*>(yr + C::col(k, t)) = out;",
        "    if (row != M / 2) *reinterpret_cast<P*>(yr + C::col(k, t)) = out;"),
    "K3 backward: one row's share of dg dropped": (
        "K3", "rmsnorm.cu",
        "          dg[k][e] += dye * (xe * r);",
        "          if (row != M / 2) dg[k][e] += dye * (xe * r);"),
    "K3 backward: one block's dg partial dropped": (
        "K3", "rmsnorm.cu",
        "  for (int p = 0; p < nparts; ++p) s += dg_part[(int64_t)p * H + c];",
        "  for (int p = 0; p < nparts; ++p)\n"
        "    if (p != nparts / 2) s += dg_part[(int64_t)p * H + c];"),
    "K5 forward: one sub-chunk's own state skipped in state passing": (
        "K5", "ssd_scan.cu",
        "      h = a[s] * h + v[u];",
        "      h = a[s] * h + (s == nsub / 2 ? 0.0f : v[u]);"),
    "K5 forward: the sub-block below the diagonal (rows 32-63, columns "
    "0-31) of one sub-chunk skipped": (
        "K5", "ssd_scan.cu",
        "  decay_mask(sS, cum, q.len);\n  __syncthreads();\n  float yacc",
        "  decay_mask(sS, cum, q.len);\n"
        "  for (int e = threadIdx.x; e < L * L; e += THREADS)\n"
        "    if (q.s == 5 && e >> 6 >= 32 && (e & (L - 1)) < 32)\n"
        "      sS[(e >> 6) * LD + (e & (L - 1))] = 0.0f;\n"
        "  __syncthreads();\n  float yacc"),
    "K5 forward: one sub-chunk's carried-state term dropped": (
        "K5", "ssd_scan.cu",
        "    for (int j = 0; j < 4; ++j) yacc[i][j] *= ecum[8 * tm + i];",
        "    for (int j = 0; j < 4; ++j)\n"
        "      yacc[i][j] *= q.s == 5 ? 0.0f : ecum[8 * tm + i];"),
    "K5 backward: one sub-chunk's dH skipped in the reverse pass": (
        "K5", "ssd_scan.cu",
        "      gd = a[s] * gd + v[u];",
        "      gd = a[s] * gd + (s == nsub / 2 ? 0.0f : v[u]);"),
    "K5 backward: D^T C of one sub-chunk skipped": (
        "K5", "ssd_scan.cu",
        "  mm<COLS, COLS>(db, sX, sC, q.len, tm, tn);",
        "  mm<COLS, COLS>(db, sX, sC, q.s == 5 ? 0 : q.len, tm, tn);"),
}

BUILD = ("from repro_torch.kernels import _build; "
         "_build.build(['rmsnorm', 'ssd_scan'])")
CHECK = """
import sys, torch
import chip_smoke as c
from repro_torch.kernels import rmsnorm as k3, ssd_scan as k5
kernels = sys.argv[1].split()
try:
    if "K3" in kernels:
        gen = torch.Generator(device="cuda").manual_seed(3)
        for dtype in (torch.float32, torch.bfloat16):
            c.k3_case(k3, "cuda", gen, c.TRAIN_B * c.TRAIN_S, c.D, dtype,
                      False)
    if "K5" in kernels:
        gen = torch.Generator(device="cuda").manual_seed(5)
        for label, b, T, dtype, scale in c.K5_CASES[:2]:
            c.k5_case(k5, "cuda", gen, label, b, T, getattr(torch, dtype),
                      scale)
except c.SmokeFailure as e:
    print("caught:", e)
    sys.exit(3)
"""


def plant(dst: Path, fault) -> None:
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _, source, old, new = fault
    if source is None:
        return
    path = dst / "src" / CSRC / source
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"k3k5_planted_faults: {old!r} occurs "
                         f"{text.count(old)} times in {source}, not once")
    path.write_text(text.replace(old, new))


def env_for(copy: Path) -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(copy / "src"), str(ROOT)]))


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="k3k5_faults_") as tmp:
        copies = {}
        for i, (name, fault) in enumerate(FAULTS.items()):
            copies[name] = Path(tmp) / f"case{i}"
            plant(copies[name], fault)
        builds = [subprocess.Popen([sys.executable, "-c", BUILD],
                                   env=env_for(c)) for c in copies.values()]
        if any([p.wait() for p in builds]):
            print("k3k5_planted_faults: a build failed")
            return 1
        wrong = []
        for name, copy in copies.items():
            proc = subprocess.run([sys.executable, "-c", CHECK,
                                   FAULTS[name][0]], env=env_for(copy),
                                  capture_output=True, text=True, cwd=ROOT)
            print(f"== {name}\n{proc.stdout.strip()}\n{proc.stderr[-2000:]}"
                  .rstrip())
            caught = proc.returncode == 3
            if proc.returncode not in (0, 3) or caught == (
                    FAULTS[name][1] is None):
                wrong.append(name)
            print(f"== {name}: {'caught' if caught else 'passed'} "
                  f"(exit {proc.returncode})")
        print(f"k3k5_planted_faults: {len(FAULTS) - 1} faults, "
              f"{'all as expected' if not wrong else f'wrong: {wrong}'}")
        return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
