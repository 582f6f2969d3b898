#!/usr/bin/env python3
"""Planted faults in K2's tc kernels, held to ``chip_smoke.py``'s phase-5
limits: each fault must fail them, and the unchanged kernels must pass.
With ``--mla``, faults in the simt kernels' loops over v's head dim,
held to phase 5d's limits at MLA's pair (q and k at 192, v at 128).

Copies ``src/repro_torch`` into a temporary directory once per case,
plants one fault in the copy's ``csrc/flash_attention_hopper.cu``, builds
the copies in parallel, then runs ``chip_smoke.k2_case`` (the tc route
against the plain version at the tinyllama training shape, 4 x 2048, 32/4
heads, d 64, causal, bf16, and at whisper's cross attention, 4 x 448
over 1504 frames, 16/16 heads, non-causal) against each copy in a
process of its own.  It
prints each case's errors and whether the limits caught it, and exits
nonzero if a fault passed or the unchanged copy failed.  The checkout is
never modified.  Needs an NVIDIA GPU and nvcc; from the root of a
checkout:

    python3 tools/k2_planted_faults.py
    python3 tools/k2_planted_faults.py --mla   # simt at dk 192 / dv 128
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
    # the forward's mask of a ragged last key tile (1504 = 23.5 x 64):
    # without the causal mask, the columns past Sk read as valid keys
    "forward: key columns past Sk valid under causal = 0": (
        "\n        const int kp = col < a.Sk ? __ldg(a.k_pos + col) : -1;",
        "\n        const int kp = col < a.Sk ? __ldg(a.k_pos + col) "
        ": (a.causal ? -1 : col);"),
}

# --mla: faults in csrc/flash_attention.cu's products and sums over DV
SIMT_SOURCE = Path("repro_torch/kernels/csrc/flash_attention.cu")
MLA_FAULTS = {
    "none (the kernels as they are)": None,
    "forward: P V reads v one column over": (
        "mm<BK, R, NJ, KP, 1, 1, VDP>(acc, Ps, Vs, ty, tx);",
        "mm<BK, R, NJ, KP, 1, 1, VDP>(acc, Ps, Vs + 1, ty, tx);"),
    "dq: delta sums the first DV - 32 columns only": (
        "for (int c = lane; c < DV; c += 32)",
        "for (int c = lane; c < DV - 32; c += 32)"),
    "dk/dv: dP = dO V^T over the first DV - 16 columns": (
        "mm<DV, R, R, VDP, 1, VDP, 1>(dp, dOs, Vs, ty, tx);    // dP",
        "mm<DV - 16, R, R, VDP, 1, VDP, 1>(dp, dOs, Vs, ty, tx);    // dP"),
    "dv: the last 16 columns of P^T dO written as 0": (
        "dvo[row * DV + tx + 16 * j] = from_f<T>(dv[i][j]);",
        "dvo[row * DV + tx + 16 * j] = from_f<T>(j == NV - 1 ? 0.0f "
        ": dv[i][j]);"),
}
MLA = "--mla" in sys.argv[1:]
if MLA:
    SOURCE, FAULTS = SIMT_SOURCE, MLA_FAULTS

BUILD = ("from repro_torch.kernels import _build; "
         f"_build.build(['{SOURCE.stem}'])")
CHECK = """
import sys, torch
import chip_smoke as c
from repro_torch.kernels import flash_attention as k2
label, b, s, nq, nkv, window = c.K2_SHAPES[0]
gen = torch.Generator(device="cuda").manual_seed(4)
try:
    if MLA:
        for dtype, tol in ((torch.float32, c.K2_F32_NORM_TOL),
                           (torch.bfloat16, None)):
            c.k2_case(k2, "cuda", gen, 1, 512, 16, 16, 0, dtype, ["simt"],
                      "mla", d=c.DS_DK, dv=c.DS_DV, tag="5d", f32_tol=tol)
    else:
        c.k2_case(k2, "cuda", gen, b, s, nq, nkv, window, torch.bfloat16,
                  ["tc"], label)
        c.k2_case(k2, "cuda", gen, 4, c.W_TEXT, c.W_NH, c.W_NH, 0,
                  torch.bfloat16, ["tc"], "whisper cross", tag="5w",
                  sk=c.W_FRAMES, causal=False)
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
            proc = subprocess.run([sys.executable, "-c",
                                   f"MLA = {MLA}\n" + CHECK],
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
