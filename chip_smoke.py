#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, in order (any failure raises and exits nonzero):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, all at once) and print each kernel's
     registers, spills and shared memory from ``-Xptxas -v``;
  2. K1 matmul against its plain version at every GEMM shape of
     tinyllama-1.1b's decode and prefill: f32 through the simt route,
     bf16 through both the tc (wgmma + TMA) and the decode (split-K)
     route, every activation, with and without bias; then the times of
     the route the path takes, the other bf16 route, the simt kernel,
     the plain version and ``torch.matmul`` beside the bound;
 2t. the decode threshold: both bf16 routes timed at M in {8, 16, 32,
     64, 128} over a decode step's GEMMs, and the crossover printed
     beside ``kernels/matmul.py:DECODE_MAX_M``;
  3. K4 paged decode against its plain version at the tinyllama shape
     (B = 8, 32 q heads, 4 kv heads, d = 64, block 16): ragged contexts of
     64-1024 tokens, a windowed case, null and recycled blocks, residuals;
  4. K3 RMSNorm forward and backward against their plain versions at the
     training shape (8192 rows x 2048), bf16 and f32, with and without a
     zero-centred gain, and at 3072 and 4096 (zamba2's gate_ln) in bf16:
     within 1e-4 (f32) or 3e-2 (bf16) of 1 + max and within
     ``K3_NORM_TOL`` of the plain version's norm, dg repeating bit for
     bit; then device times at each width beside ``F.rms_norm``'s forward
     and its backward (the backward's kernels summed by torch.profiler);
  5. K2 flash attention forward and backward against their plain versions
     at the main paths' attention shapes, all causal at d = 64: the
     tinyllama training layer (4 x 2048, 32/4 heads), zamba2's shared
     attention (4 x 2048, 32/32 heads, window 4096) and the serving
     prefill (8 x 512, 32/4): bf16 through the tc route (wgmma + TMA) at
     all three and through the simt route at the training shape, out, lse,
     dq, dk and dv within 3e-2 of 1 + max (lse 1e-5) and out, dq, dk and
     dv within ``K2_NORM_TOL`` of the plain version's norm, two backward
     runs giving the same bits, and the cost of the tc kernels' bf16 dS
     measured by the plain backward with dS rounded; f32 through the simt
     route at 1e-4.  Then the times of both routes, the plain version and
     ``F.scaled_dot_product_attention`` at each shape, beside the bound.
     Last, the head dims only the simt route takes (``K2_WIDE_SHAPES``):
     the paper's model, 4 x 512, 64/64 heads of 48, and gemma-2b, 4 x
     2048, 8/1 heads of 256, f32 and bf16 (bf16 also to ``K2_NORM_TOL``),
     timed beside SDPA and the bound;
  6. full-width two-layer tinyllama in f32 (K1's simt route) and in bf16
     (its tc and decode routes): CPU (plain versions) against the card
     (kernels), serving prefill and the first fused decode step's logits,
     then one f32 training step's loss and gradients (batch 2 x 512),
     also of the paper's model (d 48) and gemma-2b (d 256) cut to two
     layers, with K2's launches on the card counted;
  7. the serving run: ``repro_torch.launch.serve`` serves 8 requests of
     tinyllama-1.1b at full depth and width in bf16 (weights from a seed),
     with the kernels' launch counters reset just before and read after;
     no bf16 K1 GEMM and no bf16 K2 attention, forward or backward, may
     take the simt route, and the routes add up to the totals (also in
     phases 8 and 13);
  8. the training run: ``repro_torch.launch.train`` trains tinyllama-1.1b at
     full depth and width in bf16 (batch 4 x 2048, remat, AdamW, synthetic
     tokens from seed 0) for a few steps, counters reset before and read
     after; every loss must be finite and the launches as expected;
  9. where the time of one such training step goes: torch.profiler's
     device time by kernel group, and the device's idle share;
 10. K1 at training shapes: the tc route against the plain version at
     every GEMM shape of a tinyllama and a zamba2 training step, then the
     route, the simt kernel, the plain version and ``torch.matmul``
     summed over the GEMMs of one step of each;
 11. K5 SSD scan forward and backward against their plain versions at
     zamba2's training shape (4 x 2048, 64 heads of 64, 2 groups, d_state
     64, chunk 256), bf16 and f32 B/C, a ragged T (a chunk of 250 steps),
     a strongly negative log-decay, each within its scaled limit and
     ``K5_NORM_TOL``, and two backward runs that must give the same bits;
 12. full-width zamba2 cut to [mamba, mamba, attn] in f32: one training
     step's loss and gradients, CPU (plain versions) against the card;
 13. the zamba2 training run: ``repro_torch.launch.train`` trains
     zamba2-1.2b at full depth and width in bf16 (batch 4 x 2048, remat,
     AdamW, synthetic tokens from seed 0), counters reset before and read
     after; every loss finite and the launches exact;
 14. where the time of one zamba2 training step goes (as phase 9);
 15. K1 against ``torch.matmul`` summed over each path's GEMMs.

The lines before the last carry one JSON object of per-kernel numbers and
the card's name and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits nonzero and
prints no result.
"""
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

# tinyllama-1.1b (configs/tinyllama_1_1b.py)
D, NQ, NKV, DH, FF, VOCAB, LAYERS = 2048, 32, 4, 64, 5632, 32000, 22
# (name, K, N, launches per layer) of the decode step's GEMMs; the LM head
# runs once per step
LAYER_GEMMS = [("wq,wo", D, NQ * DH, 2), ("wk,wv", D, NKV * DH, 2),
               ("w_up,w_gate", D, FF, 2), ("w_down", FF, D, 1)]
HEAD_GEMM = ("head", D, VOCAB, 1)
DECODE_M, PREFILL_M = 8, 8 * 512     # batch 8; prefill pads 259-263 -> 512
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5    # the training run (phase 8)
# launches per training step: K1 runs the 7 linears of each layer twice
# (forward and its recompute under remat) and the head's 2 loss chunks
# twice; K2 runs each layer's attention forward twice and backward once;
# K3 the 2 norms of each layer twice and ln_f once, backward once each
TRAIN_LAUNCHES = {"K1": 2 * 7 * LAYERS + 2 * 2, "K2": 2 * LAYERS,
                  "K2 bwd": LAYERS, "K3": 2 * 2 * LAYERS + 1,
                  "K3 bwd": 2 * LAYERS + 1, "K5": 0, "K5 bwd": 0}
# training GEMMs of tinyllama: (name, K, N, launches per step), forward and
# its recompute; the head runs in 2 chunks of 4 x 1024 rows
TRAIN_GEMMS = [("wq,wo", D, NQ * DH, 2 * 2 * LAYERS),
               ("wk,wv", D, NKV * DH, 2 * 2 * LAYERS),
               ("w_up,w_gate", D, FF, 2 * 2 * LAYERS),
               ("w_down", FF, D, 2 * LAYERS)]

# zamba2-1.2b (configs/zamba2_1_2b.py): 38 Mamba2 layers (d_inner 4096,
# 64 SSM heads of 64, 2 groups, d_state 64, chunk 256) and one shared
# attention block (32/32 heads, gated-GELU MLP of 8192) after every 6
Z_LAYERS, Z_SHARED, Z_FF = 38, 6, 8192
Z_HEADS, Z_WINDOW = 32, 4096      # the shared block's attention: 32/32 heads
Z_DIN, Z_NH, Z_G, Z_N, Z_CHUNK = 4096, 64, 2, 64, 256
Z_STEPS = 4
# launches per zamba2 training step: K1 runs the 5 linears of each Mamba
# layer, the 7 of each shared-block use and the 2 head chunks twice
# (forward and remat recompute); K3 the 2 norms of each Mamba layer and of
# each shared-block use twice and ln_f once, backward once each; K2 the 6
# shared attentions and K5 the 38 scans twice forward, once backward
Z_LAUNCHES = {"K1": 2 * (5 * Z_LAYERS + 7 * Z_SHARED + 2),
              "K2": 2 * Z_SHARED, "K2 bwd": Z_SHARED,
              "K3": 2 * (2 * Z_LAYERS + 2 * Z_SHARED) + 1,
              "K3 bwd": 2 * Z_LAYERS + 2 * Z_SHARED + 1,
              "K5": 2 * Z_LAYERS, "K5 bwd": Z_LAYERS}
Z_GEMMS = [("w_x,w_z", D, Z_DIN, 2 * 2 * Z_LAYERS),
           ("w_bc", D, 2 * Z_G * Z_N, 2 * Z_LAYERS),
           ("w_dt", D, Z_NH, 2 * Z_LAYERS),
           ("w_out", Z_DIN, D, 2 * Z_LAYERS),
           ("wq,wk,wv,wo", D, D, 2 * 4 * Z_SHARED),
           ("w_up,w_gate", D, Z_FF, 2 * 2 * Z_SHARED),
           ("w_down", Z_FF, D, 2 * Z_SHARED)]


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events, after
    one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def capture_stream():
    """The one side stream every graph is captured on: cuBLAS keeps a
    workspace for each stream it has run on, so a stream per capture
    would hold 32 MiB each for the rest of the run."""
    import torch
    return torch.cuda.Stream()


def graph_ms(fn, reps):
    """Mean device time of ``fn`` with the host taken out: ``reps`` calls
    captured in one CUDA graph, replayed between CUDA events (after one
    warm-up call and one warm-up replay)."""
    import torch
    side = capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(got, want):
    """max |got - want| / (1 + |want|), elementwise, in f32."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (1 + w.abs())).max().item()


def scaled_err(got, want):
    """max |got - want| / (1 + max |want|), in f32: for gradients, whose
    entries span many magnitudes."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / (1 + w.abs().max())).item()


def leaf_err(got, want):
    """max |got - want| / max |want|, in f32: one gradient leaf against
    its own scale."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[1] built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, text in sorted(logs.items()):
        kernel = "?"
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = demangle(entry.group(1))
            elif "Used" in line or "spill" in line:
                print(f"    {name}: {kernel}: {line.strip()}")


def demangle(symbol: str) -> str:
    """A kernel's name and template arguments from its mangled symbol, by
    c++filt where the toolkit's host compiler brought it, else the
    symbol."""
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    if not out or out == symbol:
        return symbol
    out = out.replace("(anonymous namespace)::", "").split("(")[0]
    return out.removeprefix("void ").strip()


def k1_inputs(gen, dev, m, k, n, dtype=None):
    import torch
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    b = torch.randn(n, generator=gen, device=dev)
    if dtype is not None:
        x, w, b = (t.to(dtype) for t in (x, w, b))
    return x, w, b


def k1_check(k1, x, w, b, force=None):
    """Worst (relative, absolute) error of K1 against its plain version over
    every activation, with and without bias."""
    worst, worst_abs = 0.0, 0.0
    for act in k1.ACTS:
        for bias in (None, b):
            got = k1.matmul(x, w, bias, act=act, force=force)
            want = k1.matmul_plain(x, w, bias, act=act)
            worst = max(worst, rel_err(got, want))
            worst_abs = max(worst_abs, abs_err(got, want))
    return worst, worst_abs


def k1_time(k1, dev, gen, m, k, n, reps, routes, with_plain=True,
            device=False):
    """Times of the bf16 product at the path's case (no bias, no
    activation): each named route forced, the plain version and
    ``torch.matmul``, as calls from the host (CUDA events around a loop of
    calls); with ``device``, also each route's and ``torch.matmul``'s
    device time (``graph_ms``: the same calls replayed from a CUDA graph),
    under keys ending in ``device_ms``.  The weights rotate over enough
    copies to exceed the 50 MB L2 cache, as a step finds them."""
    import torch
    copies = max(1, min(64, math.ceil(120e6 / (k * n * 2))))
    ws = [(torch.randn(k, n, generator=gen, device=dev)
           / math.sqrt(k)).to(torch.bfloat16) for _ in range(copies)]
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    it = iter(range(1 << 30))

    def pick():
        return ws[next(it) % copies]
    t = {}
    for name, r in routes.items():
        t[name] = time_ms(lambda: k1.matmul(x, pick(), force=r),
                          reps if r != "simt" else max(1, reps // 20))
    if with_plain:
        t["plain_ms"] = time_ms(lambda: k1.matmul_plain(x, pick()),
                                max(1, reps // 4))
    t["library_ms"] = time_ms(lambda: torch.matmul(x, pick()), reps)
    if device:
        for name, r in routes.items():
            if r != "simt":
                t[name[:-2] + "device_ms"] = graph_ms(
                    lambda: k1.matmul(x, pick(), force=r), reps)
        t["library_device_ms"] = graph_ms(lambda: torch.matmul(x, pick()),
                                          reps)
    t["bound_ms"], t["bound_by"] = bound_ms(
        2 * (m * k + k * n + m * n), 2 * m * n * k, H100_BF16_FLOPS)
    return t


def phase_k1(dev):
    """K1 at every GEMM shape of tinyllama-1.1b's decode step (M = 8) and
    prefill (M = 4096): f32 through the simt route, bf16 through both the
    tc and the decode route, each against the plain version; then the
    times of the route the path takes, of the other bf16 route, of the
    simt kernel (the first K1 design), the plain version and
    ``torch.matmul``."""
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [(DECODE_M, k, n, name) for name, k, n, _ in
              LAYER_GEMMS + [HEAD_GEMM]]
    shapes += [(PREFILL_M, k, n, name) for name, k, n, _ in LAYER_GEMMS]
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    times, path_err = {}, {"tc": 0.0, "decode": 0.0}
    for m, k, n, name in shapes:
        path = k1.route(m, n, k, torch.bfloat16, True)
        check(path != "simt", f"K1 {name} ({m},{k},{n}) would take simt")
        cases = [(torch.float32, "simt"), (torch.bfloat16, "tc"),
                 (torch.bfloat16, "decode")]
        for dtype, force in cases:
            x, w, b = k1_inputs(gen, dev, m, k, n, dtype)
            worst, worst_abs = k1_check(k1, x, w, b, force)
            print(f"[2] K1 {name:12s} ({m},{k})@({k},{n}) {str(dtype)[6:]:8s}"
                  f" {force:6s} max rel err {worst:.2e} (tol "
                  f"{tol[dtype]:.0e}), max abs err {worst_abs:.2e}")
            check(worst <= tol[dtype], f"K1 {name} {dtype} {force}: {worst}")
            if dtype == torch.bfloat16 and force == path:
                path_err[path] = max(path_err[path], worst_abs)
        other = "tc" if path == "decode" else "decode"
        t = k1_time(k1, dev, gen, m, k, n, 60 if m == DECODE_M else 5,
                    {"ms": path, f"{other}_ms": other, "simt_ms": "simt"},
                    device=True)
        times[(m, name)] = t
        dm = t["device_ms"]
        print(f"    time bf16 ({m},{k})@({k},{n}), called from the host: "
              f"{path} {t['ms']:.4f} ms, {other} {t[other + '_ms']:.4f}, "
              f"simt {t['simt_ms']:.4f}, plain {t['plain_ms']:.4f}, "
              f"torch.matmul {t['library_ms']:.4f}; device (CUDA graph): "
              f"{path} {dm:.4f} ms ({2 * m * n * k / dm / 1e9:.1f} TFLOP/s, "
              f"{2 * k * n / dm / 1e6:.0f} GB/s of weight), {other} "
              f"{t[other + '_device_ms']:.4f}, torch.matmul "
              f"{t['library_device_ms']:.4f}; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    keys = ("ms", "device_ms", "simt_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms")
    step = dict.fromkeys(keys, 0.0)
    prefill = dict(step)
    for name, k, n, per_layer in LAYER_GEMMS:
        for key in keys:
            step[key] += LAYERS * per_layer * times[(DECODE_M, name)][key]
            prefill[key] += LAYERS * per_layer * times[(PREFILL_M, name)][key]
    for key in keys:
        step[key] += times[(DECODE_M, "head")][key]
        prefill[key] += times[(DECODE_M, "head")][key]
    for label, agg, m in (("decode step", step, DECODE_M),
                          ("prefill of 8x512", prefill, PREFILL_M)):
        flops = 2 * DECODE_M * D * VOCAB + sum(
            2 * m * k * n * LAYERS * per_layer
            for _, k, n, per_layer in LAYER_GEMMS)
        print(f"[2] K1 per {label} (155 launches, bf16): called from the "
              f"host {agg['ms']:.3f} ms, {agg['ms'] / agg['library_ms']:.2f}x "
              f"torch.matmul {agg['library_ms']:.3f} ms (target 1.5x, limit "
              f"3x); device {agg['device_ms']:.3f} ms ("
              f"{flops / agg['device_ms'] / 1e9:.2f} TFLOP/s), "
              f"{agg['device_ms'] / agg['library_device_ms']:.2f}x "
              f"torch.matmul {agg['library_device_ms']:.3f} ms; simt "
              f"{agg['simt_ms']:.3f} ms, plain {agg['plain_ms']:.3f} ms, "
              f"bound {agg['bound_ms']:.3f} ms")
    by = {times[(DECODE_M, name)]["bound_by"]
          for name, *_ in LAYER_GEMMS + [HEAD_GEMM]}
    step["bound_by"] = by.pop() if len(by) == 1 else "bytes and operations"
    by = {times[(PREFILL_M, name)]["bound_by"] for name, *_ in LAYER_GEMMS}
    prefill["bound_by"] = by.pop() if len(by) == 1 else \
        "bytes and operations"
    step["max_abs_err"] = path_err["decode"]
    prefill["max_abs_err"] = path_err["tc"]
    return {"decode": step, "tc": prefill}


def phase_k1_threshold(dev):
    """The decode threshold: both bf16 routes timed at M in {8, 16, 32, 64,
    128}, summed over the GEMMs of one tinyllama decode step (155
    launches), as device time (``graph_ms``) and as calls from the host.
    The crossover is the largest M up to which the decode route's device
    time is not above the tc route's; ``kernels/matmul.py:DECODE_MAX_M``
    holds the measured value.  Device time decides: the host's cost of a
    call is the same for every M and belongs to the caller's loop."""
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(12)
    gemms = [(k, n, LAYERS * per) for _, k, n, per in LAYER_GEMMS] + \
        [(D, VOCAB, 1)]
    crossover = 4
    for m in (8, 16, 32, 64, 128):
        tot = dict.fromkeys(("tc_ms", "decode_ms", "tc_device_ms",
                             "decode_device_ms"), 0.0)
        for k, n, count in gemms:
            t = k1_time(k1, dev, gen, m, k, n, 20,
                        {"tc_ms": "tc", "decode_ms": "decode"},
                        with_plain=False, device=True)
            for key in tot:
                tot[key] += count * t[key]
        if tot["decode_device_ms"] <= tot["tc_device_ms"] and \
                crossover == m // 2:
            crossover = m      # decode not slower at every M up to here
        print(f"[2t] K1 routes at M = {m:3d}, summed over a decode step's "
              f"GEMMs: device decode {tot['decode_device_ms']:.3f} ms, tc "
              f"{tot['tc_device_ms']:.3f} ms; called from the host decode "
              f"{tot['decode_ms']:.3f} ms, tc {tot['tc_ms']:.3f} ms")
    crossover = crossover if crossover > 4 else None
    print(f"[2t] K1 threshold: the decode route's device time is not above "
          f"the tc route's up to M = {crossover or 'none'}; "
          f"kernels/matmul.py:DECODE_MAX_M = {k1.DECODE_MAX_M}")
    return crossover


def k4_case(dev, lens, nb, dtype, seed):
    """Tinyllama-shaped pool: each slot's blocks at shuffled physical ids,
    unused columns on the null block 0, and slot 0's first unused column on
    a recycled block 1 whose stale positions lie past every cur."""
    import torch
    block = 16
    g = torch.Generator().manual_seed(seed)
    n_used = sum(-(-n // block) for n in lens)
    n_blocks = 2 + n_used
    perm = (torch.randperm(n_used, generator=g) + 2).tolist()
    pos_pool = torch.full((n_blocks * block,), -1, dtype=torch.int32)
    tables = torch.zeros((len(lens), nb), dtype=torch.int32)
    cur = torch.tensor([n - 1 for n in lens], dtype=torch.int32)
    for b, n in enumerate(lens):
        for j in range(-(-n // block)):
            blk = perm.pop()
            tables[b, j] = blk
            e = torch.arange(block, dtype=torch.int32)
            pos_pool[blk * block:(blk + 1) * block] = torch.where(
                j * block + e < n, j * block + e, -1)
    pos_pool[block:2 * block] = max(lens) + 100
    tables[0, -(-lens[0] // block)] = 1
    phys = n_blocks * block
    q = torch.randn(len(lens), NQ, DH, generator=g)
    k_pool = torch.randn(phys, NKV, DH, generator=g)
    v_pool = torch.randn(phys, NKV, DH, generator=g)
    return [t.to(dev, dtype) for t in (q, k_pool, v_pool)] + \
        [t.to(dev) for t in (pos_pool, tables, cur)]


def k4_bound(lens, nb, window, elt):
    B = len(lens)
    valid = [min(n, window) if window else n for n in lens]
    nbytes = (B * NQ * DH * elt * 2                      # q in, out
              + sum(valid) * NKV * 2 * DH * elt          # valid K and V
              + B * nb * 16 * 4 + B * nb * 4 + B * 4)    # positions, tables, cur
    flops = sum(2 * NQ * v * 2 * DH for v in valid)
    return bound_ms(nbytes, flops, H100_BF16_FLOPS)


def phase_k4(dev):
    import torch
    from repro_torch.kernels import paged_decode as k4
    ragged = [64, 200, 333, 512, 640, 777, 900, 1024]
    serve = [n + 16 for n in (259, 260, 261, 262, 263, 259, 260, 261)]
    cases = [("ragged 64-1024", ragged, 64, 0, False),
             ("window 256", ragged, 64, 256, False),
             ("residuals", ragged, 64, 0, True),
             ("serve shape", serve, 32, 0, True)]
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    worst_path_err, timing = 0.0, None
    for label, lens, nb, window, residuals in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = k4_case(dev, lens, nb, dtype, seed=len(label))
            kw = dict(block=16, window=window, return_residuals=residuals)
            got = k4.paged_flash_decode(*args, **kw)
            want = k4.paged_flash_decode_plain(*args, **kw)
            if not residuals:
                got, want = (got,), (want,)
            # the unnormalized residuals are held relative to their largest
            # magnitude, the normalized output elementwise
            errs = [(g - w).abs().max().item() / (1 + w.abs().max().item())
                    if residuals else rel_err(g, w)
                    for g, w in zip(got, want)]
            abs_err = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got, want))
            print(f"[3] K4 {label:15s} {str(dtype)[6:]:8s} max rel err "
                  f"{max(errs):.2e} (tol {tol[dtype]:.0e}), max abs err "
                  f"{abs_err:.2e}")
            check(max(errs) <= tol[dtype], f"K4 {label} {dtype}: {errs}")
            if dtype == torch.bfloat16 and label == "serve shape":
                worst_path_err = abs_err
                t = {"ms": time_ms(lambda: k4.paged_flash_decode(*args, **kw),
                                   200),
                     "plain_ms": time_ms(
                         lambda: k4.paged_flash_decode_plain(*args, **kw),
                         50),
                     "library_ms": None}
                t["bound_ms"], t["bound_by"] = k4_bound(lens, nb, window, 2)
                timing = t
            if dtype == torch.bfloat16 and label == "ragged 64-1024":
                ms = time_ms(lambda: k4.paged_flash_decode(*args, **kw), 200)
                bnd = k4_bound(lens, nb, window, 2)[0]
                print(f"    time bf16 ragged 64-1024: kernel {ms:.4f} ms, "
                      f"bound {bnd:.4f} ms (bytes)")
    print(f"[3] K4 serve shape (B=8, contexts 275-279, 32 columns, bf16): "
          f"kernel {timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms, "
          f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    timing["max_abs_err"] = worst_path_err
    return timing


# K3: the limits on ||got - want|| / ||want|| against the plain version,
# per dtype, 3-5x the readings of the redesign (on an H100: f32 y 4-6e-8,
# dx 6-8e-8, dg 2-4e-7; bf16 y 0.4-1.6e-5, dx 0.5-2.4e-5).  bf16 dg is one
# rounding of an f32 sum over the rows: it reads 0 where no rounding
# flips, and one flipped entry of H = 4096 reads up to ~6e-5, so its
# limit is 3e-4.  One row's share of dg dropped reads ~1e-2 at 8192 rows
# (tools/k3k5_planted_faults.py)
K3_NORM_TOL = {"float32": {"y": 3e-7, "dx": 3e-7, "dg": 1.5e-6},
               "bfloat16": {"y": 6e-5, "dx": 1e-4, "dg": 3e-4}}
# K3's widths on the main paths: every norm of tinyllama and zamba2 (2048),
# zamba2's gate_ln over d_inner (4096), and the 3072 instance
K3_WIDTHS = (2048, 3072, 4096)


def kernels_by_name(fn, reps):
    """{kernel name: device ms per call of ``fn``}, largest first, summed
    by torch.profiler over ``reps`` calls (after one warm-up call); the
    names without their arguments and anonymous namespace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: v / reps for k, v in sorted(out.items(),
                                           key=lambda kv: -kv[1])}


def kernel_ms(fn, reps):
    """Device time of ``fn``, its kernels' durations summed (see
    ``kernels_by_name``), or None when the profiler sees no kernel: for
    calls that cannot be captured in a CUDA graph, such as an autograd
    backward."""
    return sum(kernels_by_name(fn, reps).values()) or None


def k3_case(k3, dev, gen, m, h, dtype, zc, tag="[4]"):
    """K3's forward and backward against the plain version at (m, h):
    y, rstd, dx and dg within the scaled limit (1e-4 f32, 3e-2 bf16, of
    1 + max) and within ``K3_NORM_TOL`` of the plain version's norm, and
    two backward runs giving the same dg bits.  Returns the inputs, rstd
    and the worst absolute error."""
    import torch
    x = torch.randn(m, h, generator=gen, device=dev).to(dtype)
    g = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(dtype)
    dy = torch.randn(m, h, generator=gen, device=dev).to(dtype)
    y, rstd = k3.rmsnorm_fwd(x, g, zero_centered=zc)
    dx, dg = k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)
    again = k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)[1]
    y2, rstd2 = k3.rmsnorm_plain(x, g, zero_centered=zc)
    dx2, dg2 = k3.rmsnorm_bwd_plain(dy, x, g, rstd2, zero_centered=zc)
    pairs = (("y", y, y2), ("rstd", rstd, rstd2), ("dx", dx, dx2),
             ("dg", dg, dg2))
    errs = {n: scaled_err(a, b) for n, a, b in pairs}
    norms = {n: norm_err(a, b) for n, a, b in pairs if n != "rstd"}
    name = str(dtype)[6:]
    tol, ntol = {"float32": 1e-4, "bfloat16": 3e-2}[name], K3_NORM_TOL[name]
    same = torch.equal(dg, again)
    print(f"{tag} K3 ({m},{h}) {name:8s} zc={zc!s:5s} errors "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {tol:.0e}, relative to 1 + max); ||error|| / ||plain|| "
          + ", ".join(f"{k} {v:.2e}" for k, v in norms.items())
          + " (tol " + ", ".join(f"{k} {v:.0e}" for k, v in ntol.items())
          + f"); dg repeats bit for bit: {same}")
    check(all(norms[k] <= ntol[k] for k in ntol),
          f"K3 ({m},{h}) {dtype} zc={zc}: ||error|| / ||plain|| {norms}")
    check(max(errs.values()) <= tol, f"K3 ({m},{h}) {dtype} zc={zc}: {errs}")
    check(same, f"K3 ({m},{h}) {dtype} zc={zc}: dg does not repeat")
    worst = max(abs_err(a, b) for n, a, b in pairs if n != "rstd")
    return (x, g, dy), rstd, worst, norms


def phase_k3(dev):
    """K3 at the training shape: every norm of a step sees 8192 rows, of
    2048 (tinyllama, zamba2) or 4096 (zamba2's gate_ln); the 3072 instance
    too.  Checked in f32 and bf16, with and without zero-centring at 2048;
    then the device times of the kernels, the plain versions and
    ``F.rms_norm``'s forward and backward at each width in bf16.  Returns
    the 2048 case's numbers (bf16, no zero-centring), the kernel's time
    as forward + backward of one norm (device time), the other widths
    under ``shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as k3
    m = TRAIN_B * TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(D, dtype, zc) for dtype in (torch.float32, torch.bfloat16)
             for zc in (False, True)]
    cases += [(h, torch.bfloat16, False) for h in K3_WIDTHS if h != D]
    out = {}
    for h, dtype, zc in cases:
        (x, g, dy), rstd, worst, norms = k3_case(k3, dev, gen, m, h, dtype,
                                                 zc)
        if dtype != torch.bfloat16 or zc:
            continue
        xr = x.detach().requires_grad_()
        gr = g.detach().requires_grad_()
        lib_out = F.rms_norm(xr, (h,), gr, 1e-6)

        def lib_bwd():
            torch.autograd.grad(lib_out, (xr, gr), dy, retain_graph=True)
        t = {"fwd_ms": graph_ms(lambda: k3.rmsnorm_fwd(x, g), 50),
             "bwd_ms": graph_ms(lambda: k3.rmsnorm_bwd(dy, x, g, rstd), 50),
             "fwd_host_ms": time_ms(lambda: k3.rmsnorm_fwd(x, g), 50),
             "bwd_host_ms": time_ms(lambda: k3.rmsnorm_bwd(dy, x, g, rstd),
                                    50),
             "bwd_kernels_ms": kernel_ms(
                 lambda: k3.rmsnorm_bwd(dy, x, g, rstd), 20),
             "plain_fwd_ms": time_ms(lambda: k3.rmsnorm_plain(x, g), 10),
             "plain_bwd_ms": time_ms(
                 lambda: k3.rmsnorm_bwd_plain(dy, x, g, rstd), 10),
             "library_fwd_ms": graph_ms(
                 lambda: F.rms_norm(x, (h,), g, 1e-6), 50),
             "library_bwd_ms": kernel_ms(lib_bwd, 20),
             "norm_err": norms, "max_abs_err": worst}
        t["ms"] = t["fwd_ms"] + t["bwd_ms"]
        t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
        t["library_ms"] = (t["library_fwd_ms"] + t["library_bwd_ms"]
                           if t["library_bwd_ms"] is not None else None)
        fb, fo = bound_ms(2 * m * h * 2 + h * 2 + m * 4, 4 * m * h,
                          H100_F32_FLOPS)
        bb, bo = bound_ms(3 * m * h * 2 + 2 * h * 2 + m * 4, 10 * m * h,
                          H100_F32_FLOPS)
        t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
                 bound_by=fo if fo == bo else "bytes and operations")
        lb = t["library_bwd_ms"]
        print(f"[4] K3 bf16 ({m},{h}), device time: forward {t['fwd_ms']:.4f}"
              f" ms ({fb / t['fwd_ms'] * 100:.0f}% of its bound {fb:.4f} {fo};"
              f" F.rms_norm {t['library_fwd_ms']:.4f}, "
              f"{t['fwd_ms'] / t['library_fwd_ms']:.2f}x); backward "
              f"{t['bwd_ms']:.4f} ms ({bb / t['bwd_ms'] * 100:.0f}% of its "
              f"bound {bb:.4f} {bo}; its kernels summed by the profiler "
              f"{t['bwd_kernels_ms'] or float('nan'):.4f}; F.rms_norm's "
              f"backward, its kernels summed by the profiler, "
              + (f"{lb:.4f}, {t['bwd_kernels_ms'] / lb:.2f}x"
                 if lb and t["bwd_kernels_ms"] else "not measured")
              + f"); called from the host {t['fwd_host_ms']:.4f} + "
              f"{t['bwd_host_ms']:.4f} ms; plain {t['plain_fwd_ms']:.4f} + "
              f"{t['plain_bwd_ms']:.4f} ms")
        out[h] = t
        del xr, gr, lib_out
    return dict(out[D], shapes={f"{m}x{h}": t for h, t in out.items()})


# the attention shapes of the main paths (phase 5): (label, batch, seq, q
# heads, kv heads, window), all causal at d = 64
K2_SHAPES = [("train", TRAIN_B, TRAIN_S, NQ, NKV, 0),
             ("zamba2", TRAIN_B, TRAIN_S, Z_HEADS, Z_HEADS, Z_WINDOW),
             ("prefill", 8, 512, NQ, NKV, 0)]
# the head dims the tc route does not take, at their configs' training
# shapes (phase 5): (label, batch, seq, q heads, kv heads, d), causal: the
# paper's model (configs/paper_transformer.py, seq 512) and gemma-2b
# (configs/gemma_2b.py, MQA)
K2_WIDE_SHAPES = [("paper d48", 4, 512, 64, 64, 48),
                  ("gemma d256", 4, 2048, 8, 1, 256)]


def k2_work(q_pos, k_pos, b, nq, nkv, d, elt, window=0):
    """(fwd bytes, fwd flops, bwd bytes, bwd flops) of one attention call,
    causal, the flops counted over the allowed (query, key) pairs of these
    positions: 2 products of 2*d flops a pair forward, 5 backward."""
    qp, kp = q_pos[:, :, None], k_pos[None, None, :]
    allowed = (kp >= 0) & (qp >= kp)
    if window:
        allowed &= qp - kp < window
    pairs = int(allowed.sum().item()) * nq
    sq, sk = q_pos.shape[1], k_pos.shape[0]
    q_bytes = b * sq * nq * d * elt
    kv_bytes = 2 * b * sk * nkv * d * elt
    lse = b * nq * sq * 4
    pos = (b * sq + sk) * 4
    fwd = (2 * q_bytes + kv_bytes + lse + pos, 4 * d * pairs)
    bwd = (4 * q_bytes + 2 * kv_bytes + lse + pos, 10 * d * pairs)
    return (*fwd, *bwd)


# K2 in bf16: the limits on ||got - want|| / ||want|| (the whole tensor's
# L2 norm) against the plain version.  The tc route reads out 1.1-1.4e-3,
# dq and dk 2.5-2.7e-3 (as much as rounding dS to bf16 alone gives) and
# dv 1.7-3.4e-4 at the main paths' shapes; a dropped key tile or GQA head,
# or a wrong k16 slice of a product, even on one q tile or one key tile of
# the 32, reads 1.6e-2 or more (tools/k2_planted_faults.py)
K2_NORM_TOL = {"out": 5e-3, "dq": 1e-2, "dk": 1e-2, "dv": 1.5e-3}


def norm_err(got, want):
    """||got - want|| / ||want|| over the whole tensor, in f64."""
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm().clamp_min(1e-300)).item()


def k2_bwd_ds_rounded(q, k, v, out, dout, lse, q_pos, k_pos, window):
    """``(dq, dk)`` of the plain backward (causal, the default scale) with
    dS rounded to q's dtype before its two products, as the tc kernels
    round it: held against the plain version, it measures what that
    rounding alone costs."""
    import torch
    f32 = torch.float32
    b, sq, nq, d = q.shape
    nkv = k.shape[2]
    g, scale = nq // nkv, d ** -0.5
    qf = (q.to(f32) * scale).reshape(b, sq, nkv, g, d)
    dof = dout.to(f32).reshape(b, sq, nkv, g, d)
    qp = q_pos[:, None, None, :, None]
    allowed = (k_pos >= 0) & (qp >= k_pos)
    if window:
        allowed &= qp - k_pos < window
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(f32))
    p = torch.where(allowed, torch.exp(s - lse.reshape(b, nkv, g, sq, 1)),
                    0.0)
    delta = (dof * out.to(f32).reshape(b, sq, nkv, g, d)).sum(-1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.to(f32))
    ds = (p * (dp - delta.permute(0, 2, 3, 1)[..., None])).to(q.dtype)
    del s, p, dp
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(f32), k.to(f32)) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(f32), qf)
    return dq.reshape(b, sq, nq, d).to(q.dtype), dk.to(k.dtype)


def k2_case(k2, dev, gen, b, s, nq, nkv, window, dtype, routes, label,
            d=DH):
    """K2's routes against the plain version at one shape: out, lse, dq,
    dk and dv, and two backward runs of each route that must give the same
    bits.  In bf16 each of out, dq, dk and dv is also held to
    ``K2_NORM_TOL``, and the plain backward with dS rounded to bf16 shows
    what the tc kernels' rounding of dS costs by itself.  Returns the
    inputs, the path route's (out, lse), its worst absolute error (lse
    apart) and each route's norm errors (with ``"dS in bf16"``: the
    rounded plain backward's)."""
    import torch
    q_pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s) \
        .contiguous()
    k_pos = torch.arange(s, dtype=torch.int32, device=dev)
    q = torch.randn(b, s, nq, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, nkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, nkv, d, generator=gen, device=dev).to(dtype)
    dout = torch.randn(b, s, nq, d, generator=gen, device=dev).to(dtype)
    kw = dict(window=window)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    lse_tol = 1e-4 if dtype == torch.float32 else 1e-5
    bf16 = dtype == torch.bfloat16
    out2, lse2 = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos, **kw)
    path = k2.route_for(q, k, v, out2)
    worst, kept, norms = 0.0, None, {}
    tag = (f"[5] K2 {label} ({b},{s},{nq}/{nkv},{d}) causal"
           f"{f' window {window}' if window else ''} {str(dtype)[6:]:8s}")
    for r in routes:
        out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos, force=r,
                                          **kw)
        grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                       force=r, **kw)
        again = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos,
                                       force=r, **kw)
        grads2 = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                              k_pos, **kw)
        pairs = [("out", out, out2), ("lse", lse, lse2)] + list(
            zip(("dq", "dk", "dv"), grads, grads2))
        errs = {n: scaled_err(x, y) for n, x, y in pairs}
        norms[r] = {n: norm_err(x, y) for n, x, y in pairs if n != "lse"}
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        print(f"{tag} {r:4s} errors "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
              + f" (tol {tol:.0e}, lse {lse_tol:.0e}, relative to 1 + max); "
              "||error|| / ||plain|| "
              + ", ".join(f"{n} {e:.2e}" for n, e in norms[r].items())
              + (" (tol " + ", ".join(f"{n} {e:.1e}" for n, e in
                                      K2_NORM_TOL.items()) + ")"
                 if bf16 else "")
              + f"; backward repeats bit for bit: {same}")
        check(errs["lse"] <= lse_tol and max(errs.values()) <= tol,
              f"K2 {label} {dtype} {r}: {errs}")
        check(not bf16 or all(norms[r][n] <= K2_NORM_TOL[n]
                              for n in K2_NORM_TOL),
              f"K2 {label} {dtype} {r}: ||error|| / ||plain|| {norms[r]}")
        check(same, f"K2 {label} {dtype} {r}: the backward does not repeat")
        if r == path:
            worst = max(abs_err(x, y) for n, x, y in pairs if n != "lse")
            kept = (out, lse, grads, grads2)
        del again
    if bf16:
        out, lse, grads, grads2 = kept
        rounded = k2_bwd_ds_rounded(q, k, v, out, dout, lse, q_pos, k_pos,
                                    window)
        norms["dS in bf16"] = {n: norm_err(x, y) for n, x, y in
                               zip(("dq", "dk"), rounded, grads2)}
        near = {n: norm_err(x, y) for n, x, y in
                zip(("dq", "dk"), grads, rounded)}
        print(f"{tag} dS in bf16: the plain backward with dS rounded to bf16"
              " against the plain version, ||error|| / ||plain|| "
              + ", ".join(f"{n} {e:.2e}" for n, e in
                          norms["dS in bf16"].items())
              + f"; the {path} route against the rounded one "
              + ", ".join(f"{n} {e:.2e}" for n, e in near.items()))
        del rounded, grads2
    return (q, k, v, dout, q_pos, k_pos), kept[:2], worst, norms


def phase_k2(dev):
    """K2 at the main paths' attention shapes (K2_SHAPES): tinyllama's
    training layer, which is also the serving prefill's kernel at another
    batch, zamba2's shared attention and the serving prefill.  In bf16 the
    tc route (and at the training shape the simt route too) against the
    plain version; in f32 the simt route at the training shape.  Then the
    times of each route, the plain version and SDPA at each shape.  Returns
    the training shape's numbers (bf16, causal) at the top, the kernel's
    time as one tc forward + one tc backward, and every shape's under
    ``shapes``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    gen = torch.Generator(device=dev).manual_seed(4)
    label, b, s, nq, nkv, _ = K2_SHAPES[0]
    k2_case(k2, dev, gen, b, s, nq, nkv, 0, torch.float32, ["simt"], label)
    t_all, worst_path_err = {}, 0.0
    for label, b, s, nq, nkv, window in K2_SHAPES:
        routes = ["tc", "simt"] if label == "train" else ["tc"]
        (q, k, v, dout, q_pos, k_pos), (out, lse), worst, norms = k2_case(
            k2, dev, gen, b, s, nq, nkv, window, torch.bfloat16, routes,
            label)
        check(k2.route_for(q, k, v, out, dout) == "tc",
              f"K2 {label}: the bf16 path does not take the tc route")
        worst_path_err = max(worst_path_err, worst)
        kw = dict(window=window)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dt = dout.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dt)

        def fwd(r):
            return lambda: k2.flash_attention_fwd(q, k, v, q_pos, k_pos,
                                                  force=r, **kw)

        def bwd(r):
            return lambda: k2.flash_attention_bwd(q, k, v, out, dout, lse,
                                                  q_pos, k_pos, force=r, **kw)
        t = {"fwd_ms": time_ms(fwd("tc"), 20),
             "bwd_ms": time_ms(bwd("tc"), 10),
             "simt_fwd_ms": time_ms(fwd("simt"), 3),
             "simt_bwd_ms": time_ms(bwd("simt"), 2),
             "plain_fwd_ms": time_ms(lambda: k2.flash_attention_fwd_plain(
                 q, k, v, q_pos, k_pos, **kw), 2),
             "plain_bwd_ms": time_ms(lambda: k2.flash_attention_bwd_plain(
                 q, k, v, out, dout, lse, q_pos, k_pos, **kw), 2),
             "library_fwd_ms": time_ms(sdpa, 20),
             "library_ms": time_ms(sdpa_fwd_bwd, 20),
             # device time (CUDA graph): at the prefill's shape a call's
             # host cost is of the order of its kernels' time
             "fwd_device_ms": graph_ms(fwd("tc"), 20),
             "bwd_device_ms": graph_ms(bwd("tc"), 10),
             "library_fwd_device_ms": graph_ms(
                 lambda: F.scaled_dot_product_attention(
                     qt.detach(), kt.detach(), vt.detach(), is_causal=True,
                     enable_gqa=True), 20)}
        t["ms"] = t["fwd_ms"] + t["bwd_ms"]
        t["norm_err"] = norms
        t["simt_ms"] = t["simt_fwd_ms"] + t["simt_bwd_ms"]
        t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
        fby, ffl, bby, bfl = k2_work(q_pos, k_pos, b, nq, nkv, DH, 2, window)
        fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
        bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
        t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
                 bound_by=fo if fo == bo else "bytes and operations")
        print(f"[5] K2 bf16 {label} ({b},{s},{nq}/{nkv},{DH}) causal: tc "
              f"forward {t['fwd_ms']:.4f} ms ({ffl / t['fwd_ms'] / 1e9:.1f} "
              f"TFLOP/s), backward {t['bwd_ms']:.4f} ms "
              f"({bfl / t['bwd_ms'] / 1e9:.1f} TFLOP/s); simt "
              f"{t['simt_fwd_ms']:.3f} + {t['simt_bwd_ms']:.3f}; plain "
              f"{t['plain_fwd_ms']:.3f} + {t['plain_bwd_ms']:.3f}; sdpa fwd "
              f"{t['library_fwd_ms']:.4f}, fwd+bwd {t['library_ms']:.4f}; "
              f"bound {fb:.4f} + {bb:.4f} ({fo}); tc / sdpa: forward "
              f"{t['fwd_ms'] / t['library_fwd_ms']:.2f}x (target 1.5x), "
              f"forward + backward {t['ms'] / t['library_ms']:.2f}x "
              f"(target 2x); device time (CUDA graph): tc "
              f"{t['fwd_device_ms']:.4f} + {t['bwd_device_ms']:.4f} ms, sdpa "
              f"forward {t['library_fwd_device_ms']:.4f} "
              f"({t['fwd_device_ms'] / t['library_fwd_device_ms']:.2f}x)")
        t_all[label] = t
        del q, k, v, dout, out, lse, qt, kt, vt
    for label, b, s_, nq, nkv, d in K2_WIDE_SHAPES:
        t_all[label] = k2_wide(k2, dev, gen, b, s_, nq, nkv, d, label)
    return dict(t_all["train"], shapes=t_all, max_abs_err=worst_path_err)


def k2_wide(k2, dev, gen, b, s, nq, nkv, d, label):
    """K2 at a head dim only the simt route takes: f32 and bf16 against
    the plain version (bf16 also to ``K2_NORM_TOL``), then the simt
    route's, the plain version's and SDPA's times in bf16 beside the
    bound."""
    import torch
    import torch.nn.functional as F
    k2_case(k2, dev, gen, b, s, nq, nkv, 0, torch.float32, ["simt"], label,
            d=d)
    (q, k, v, dout, q_pos, k_pos), (out, lse), worst, norms = k2_case(
        k2, dev, gen, b, s, nq, nkv, 0, torch.bfloat16, ["simt"], label, d=d)
    check(k2.route_for(q, k, v, out, dout) == "simt",
          f"K2 {label}: the bf16 path does not take the simt route")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    t = {"fwd_ms": time_ms(lambda: k2.flash_attention_fwd(
             q, k, v, q_pos, k_pos), 3),
         "bwd_ms": time_ms(lambda: k2.flash_attention_bwd(
             q, k, v, out, dout, lse, q_pos, k_pos), 2),
         "plain_fwd_ms": time_ms(lambda: k2.flash_attention_fwd_plain(
             q, k, v, q_pos, k_pos), 2),
         "plain_bwd_ms": time_ms(lambda: k2.flash_attention_bwd_plain(
             q, k, v, out, dout, lse, q_pos, k_pos), 2),
         "library_fwd_ms": time_ms(sdpa, 20),
         "library_ms": time_ms(
             lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dt), 20),
         "norm_err": norms, "max_abs_err": worst}
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
    fby, ffl, bby, bfl = k2_work(q_pos, k_pos, b, nq, nkv, d, 2)
    fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
    bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
    t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
             bound_by=fo if fo == bo else "bytes and operations")
    print(f"[5] K2 bf16 {label} ({b},{s},{nq}/{nkv},{d}) causal, simt route:"
          f" forward {t['fwd_ms']:.3f} ms ({ffl / t['fwd_ms'] / 1e9:.1f} "
          f"TFLOP/s), backward {t['bwd_ms']:.3f} ms "
          f"({bfl / t['bwd_ms'] / 1e9:.1f} TFLOP/s); plain "
          f"{t['plain_fwd_ms']:.3f} + {t['plain_bwd_ms']:.3f}; sdpa fwd "
          f"{t['library_fwd_ms']:.4f}, fwd+bwd {t['library_ms']:.4f} "
          f"({t['ms'] / t['library_ms']:.1f}x); bound {fb:.4f} + {bb:.4f} "
          f"({fo})")
    return t


def phase_two_layer(dev, dtype_name="float32"):
    """Full-width tinyllama cut to two layers, the same seeded weights on
    the CPU (plain versions) and on the card (kernels): serving prefill's
    and the first fused decode step's logits.  In f32 every K1 call takes
    the simt route; in bf16 the tc and decode routes, and the limit is set
    by bf16 rounding."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import matmul as k1
    from repro_torch.models import blocks, transformer
    from repro_torch.serve import kvcache
    dtype = getattr(torch, dtype_name)
    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=2,
                              dtype=dtype_name)
    layout = ParallelPlan().validate(mode="serve").build()
    params = {"cpu": init_params(transformer.abstract_params(cfg),
                                 torch.Generator().manual_seed(0),
                                 "cpu", dtype)}
    params["cuda"] = tree_map(lambda t: t.to(dev), params["cpu"])
    lens, S, L, blk = [48, 33], 64, 128, 16
    rng = np.random.default_rng(0)
    tokens = np.zeros((len(lens), S), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(2, cfg.vocab, n)
    length = np.asarray(lens, np.int32)
    p = np.arange(S)[None, :]
    pos2d = np.where(p < length[:, None], p, -1).astype(np.int32)
    out, nxt = {}, None
    for where in ("cpu", "cuda"):
        d = "cpu" if where == "cpu" else dev
        routes_before = dict(k1.launches_by_route)
        kv = kvcache.PagedKVCache(cfg, len(lens), L, block=blk,
                                  dtype=dtype)
        for i, n in enumerate(lens):
            check(kv.admit(i, n + 8), "two-layer: admission failed")
        pool = kv.init_pool(d)
        pl, col = transformer.prefill(
            cfg, layout, params[where],
            {"tokens": torch.from_numpy(tokens).to(d),
             "length": torch.from_numpy(length).to(d)})
        kvcache.scatter_prefill(
            pool, transformer.pack_prefill_cache(
                cfg, col, torch.from_numpy(pos2d).to(d)),
            torch.from_numpy(kv.prefill_phys_map(dict(enumerate(lens)), S))
            .to(d))
        if nxt is None:                   # both sides decode the CPU's tokens
            nxt = pl.argmax(-1).cpu()[:, None]
        page = blocks.PageInfo(tables=kv.tables_device(d),
                               active=torch.ones(len(lens), dtype=torch.bool,
                                                 device=d), block=blk)
        dl, _ = transformer.forward(
            cfg, layout, params[where],
            {"token": nxt.to(d), "pos": torch.from_numpy(length).to(d)},
            mode="decode", cache=pool, page=page)
        out[where] = (pl.float().cpu(), dl.float().cpu())
        routes = {r: k1.launches_by_route[r] - routes_before[r]
                  for r in k1.ROUTES}
    if dtype == torch.float32:
        # f32 on both; only the order of the sums differs
        tol, limit = 1e-3, "1e-03"
    else:
        # bf16 on both: each side rounds every activation to 8 bits of
        # mantissa, and a sum taken in another order may round a value to
        # its other neighbour; over two layers a handful of such flips
        # move a logit by a few bf16 ulps, so the limit is 16 ulps
        # (16 * 2**-8) of the largest logit
        tol, limit = None, "16 bf16 ulps of max |logit|"
    print(f"[6] two-layer full width {dtype_name}: K1 launches on the card "
          f"by route {routes}")
    want_routes = ({"simt"} if dtype == torch.float32 else {"tc", "decode"})
    check({r for r, c in routes.items() if c} <= want_routes
          and routes["simt" if dtype == torch.float32 else "decode"] > 0,
          f"two-layer {dtype_name}: K1 routes {routes}")
    for i, name in enumerate(("prefill last-position", "first decode step")):
        err = (out["cpu"][i] - out["cuda"][i]).abs().max().item()
        scale = out["cpu"][i].abs().max().item()
        lim = tol if tol is not None else 16 * 2 ** -8 * scale
        print(f"[6] two-layer full width {dtype_name} {name} logits: max abs "
              f"err {err:.2e} (tol {lim:.2e}: {limit}; |logits| up to "
              f"{scale:.2f})")
        check(err <= lim and math.isfinite(err), f"two-layer {name}: {err}")


def phase_two_layer_train(dev, arch="tinyllama-1.1b", seed=1, rows=2,
                          seq=512):
    """One training step's loss and gradients of a full-width model cut
    to two layers, f32, batch 2 x 512 (or ``rows`` x ``seq``): CPU (plain
    versions) against the card (kernels), the same seeded weights and
    tokens.  K2 must have run on the card, forward and backward:
    tinyllama-1.1b, and the paper's model (d 48) and gemma-2b (d 256),
    whose head dims only K2's simt route takes."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get(arch), n_layers=2, dtype="float32")
    layout = ParallelPlan().validate(mode="train").build()
    # drawn on the card (a CPU generator takes seconds for gemma's
    # 256000-word embedding), then copied: both sides start from these
    cpu = tree_map(lambda t: t.cpu(), init_params(
        transformer.abstract_params(cfg),
        torch.Generator(device=dev).manual_seed(seed), dev, torch.float32))
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (rows, seq + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][-1, -7:] = -1
    res = {}
    for d in ("cpu", dev):
        before = (dict(k2.launches_by_route), dict(k2.launches_bwd_by_route))
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        loss, _ = transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        routes = {r: (k2.launches_by_route[r] - before[0][r],
                      k2.launches_bwd_by_route[r] - before[1][r])
                  for r in k2.ROUTES}
        res[str(d)] = (loss.item(), [g.cpu() for g in grads], routes)
        del live, loss, grads
    (l_cpu, g_cpu, r_cpu), (l_dev, g_dev, r_dev) = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    worst = max(scaled_err(a, b) for a, b in zip(g_dev, g_cpu))
    shown = {n: scaled_err(a, b) for n, a, b in zip(names, g_dev, g_cpu)
             if n in ("embed", "head", "ln_f.g", "stack.dense.ln1.g",
                      "stack.dense.attn.wq", "stack.dense.mlp.w_down")}
    tol = 1e-3      # f32 on both; the order of the sums differs
    print(f"[6] two-layer full width {arch} (d {cfg.d_head}, "
          f"{cfg.n_heads}/{cfg.n_kv} heads) f32 train step "
          f"({rows}x{seq}): loss cpu "
          f"{l_cpu:.6f} card {l_dev:.6f}; gradient errors relative to "
          f"1 + max: " + ", ".join(f"{k} {v:.1e}" for k, v in shown.items())
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"K2 launches (forward, backward) by route on the card {r_dev}")
    check(all(c == (0, 0) for c in r_cpu.values()),
          f"two-layer train {arch}: K2 counted CPU calls {r_cpu}")
    check(r_dev["simt"][0] > 0 and r_dev["simt"][1] > 0,
          f"two-layer train {arch}: K2 did not run on the card {r_dev}")
    check(abs(l_cpu - l_dev) <= 1e-4 and math.isfinite(l_dev),
          f"two-layer train {arch} loss: {l_cpu} vs {l_dev}")
    check(worst <= tol, f"two-layer train {arch} gradients: {worst}")


def phase_k1_train(dev):
    """K1 at the training shapes: every GEMM of one training step of
    tinyllama and of zamba2 (M = 4 x 2048 rows; the head's 2 chunks 4 x
    1024) through the route the step takes (tc), held against the plain
    version in bf16 with every activation, with and without bias; then
    timed as that route, the simt kernel (the first K1 design), the plain
    version and ``torch.matmul``, each times its launches a step (forward
    and remat recompute)."""
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(10)
    m = TRAIN_B * TRAIN_S
    head = [("head", D, VOCAB, 2 * 2)]
    seen, out, worst_err = {}, {}, 0.0
    keys = ("ms", "simt_ms", "plain_ms", "library_ms", "bound_ms")
    for arch, gemms in (("tinyllama", TRAIN_GEMMS), ("zamba2", Z_GEMMS)):
        tot = dict.fromkeys(keys, 0.0)
        launches = flops = 0
        for name, k, n, per_step in gemms + head:
            rows = m // 2 if name == "head" else m
            key = (rows, k, n)
            if key not in seen:
                path = k1.route(rows, n, k, torch.bfloat16, True)
                check(path == "tc", f"K1 train {name}: route {path}")
                x, w, b = k1_inputs(gen, dev, rows, k, n, torch.bfloat16)
                worst, worst_abs = k1_check(k1, x, w, b)
                worst_err = max(worst_err, worst_abs)
                check(worst <= 1e-2, f"K1 train {name} tc: {worst}")
                del x, w, b
                t = k1_time(k1, dev, gen, rows, k, n, 10,
                            {"ms": path, "simt_ms": "simt"})
                seen[key] = t
                print(f"[10] K1 train GEMM ({rows},{k})@({k},{n}) bf16 tc "
                      f"(tile 128x{k1.tile_n(rows, n)}): max rel err "
                      f"{worst:.2e} (tol 1e-02); {t['ms']:.3f} ms "
                      f"({2 * rows * k * n / t['ms'] / 1e9:.1f} TFLOP/s), "
                      f"simt {t['simt_ms']:.3f}, plain {t['plain_ms']:.3f}, "
                      f"torch.matmul {t['library_ms']:.3f}, bound "
                      f"{t['bound_ms']:.4f} ({t['bound_by']})")
            for key2 in tot:
                tot[key2] += per_step * seen[key][key2]
            launches += per_step
            flops += per_step * 2 * rows * k * n
        print(f"[10] K1 per {arch} training step ({launches} GEMMs, bf16): "
              f"kernel {tot['ms']:.1f} ms ({flops / tot['ms'] / 1e9:.1f} "
              f"TFLOP/s), {tot['ms'] / tot['library_ms']:.2f}x torch.matmul "
              f"{tot['library_ms']:.1f} ms (target 1.5x, limit 3x); simt "
              f"{tot['simt_ms']:.1f} ms, plain {tot['plain_ms']:.1f} ms, "
              f"bound {tot['bound_ms']:.1f} ms")
        out[arch] = tot
    return out, worst_err


def k5_work(b, T, Q, bc_elt):
    """(fwd bytes, fwd flops, bwd bytes, bwd flops) of one SSD scan at
    zamba2's heads: each input read once and each output written once;
    the flops over the allowed (i >= j) pairs of each chunk (forward C.B
    and S.xbar; backward dy.xbar, S^T dy, dS B and dS^T C, not the kernel's
    recompute of C.B) plus the carried-state products of every row (2
    forward, 4 backward)."""
    nc = T // Q
    pairs = b * Z_NH * nc * Q * (Q + 1) // 2
    rows = b * T * Z_NH
    io = b * T * Z_NH * DH * 4                 # xbar, y, dy, dxbar: f32
    small = b * T * Z_NH * 4 + 2 * b * T * Z_G * Z_N * bc_elt
    fwd = (2 * io + small, pairs * (2 * Z_N + 2 * DH) + rows * 4 * Z_N * DH)
    bwd = (3 * io + 2 * small,
           pairs * (4 * Z_N + 4 * DH) + rows * 8 * Z_N * DH)
    return (*fwd, *bwd)


# K5: the limits on ||got - want|| / ||want|| against the plain version
# (set in k5_case's comment from the readings); "la << 0" is the case of
# log-decays near -200 a step, where the decays differ by up to ~1%
K5_NORM_TOL = {
    "float32": dict.fromkeys(("y", "states", "dxbar", "dla", "dB", "dC"),
                             5e-6),
    "bfloat16": dict(dict.fromkeys(("y", "states", "dxbar", "dla"), 5e-6),
                     dB=2.5e-4, dC=2.5e-4),
    "la << 0": dict(y=1e-4, states=3e-4, dxbar=1e-4, dla=3e-3, dB=1e-4,
                    dC=1e-4)}


def k5_case(k5, dev, gen, label, b, T, dtype, la_scale, tag="[11]"):
    """K5's forward and backward against the plain version at zamba2's
    heads (b, T): y, states, dxbar, dla, dB and dC within the scaled limit
    and within ``K5_NORM_TOL`` of the plain version's norm, every output
    finite, and two backward runs giving the same bits.  Returns the
    inputs, the states and the worst absolute error."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    xbar = 0.5 * rnd(b, T, Z_NH, DH)
    la = -la_scale * rnd(b, T, Z_NH).abs()
    B = (0.3 * rnd(b, T, Z_G, Z_N)).to(dtype)
    C = (0.3 * rnd(b, T, Z_G, Z_N)).to(dtype)
    dy = rnd(b, T, Z_NH, DH)
    y, st = k5.ssd_scan_fwd(xbar, la, B, C, Z_CHUNK)
    grads = k5.ssd_scan_bwd(dy, xbar, la, B, C, st, Z_CHUNK)
    y2, st2 = k5.ssd_scan_plain(xbar, la, B, C, Z_CHUNK)
    grads2 = k5.ssd_scan_bwd_plain(dy, xbar, la, B, C, st2, Z_CHUNK)
    pairs = [("y", y, y2), ("states", st, st2)] + list(
        zip(("dxbar", "dla", "dB", "dC"), grads, grads2))
    errs = {n: scaled_err(a, c) for n, a, c in pairs}
    norms = {n: norm_err(a, c) for n, a, c in pairs}
    finite = all(bool(torch.isfinite(t).all()) for t in (y, *grads))
    again = k5.ssd_scan_bwd(dy, xbar, la, B, C, st, Z_CHUNK)
    same = all(torch.equal(a, g) for a, g in zip(again, grads))
    # f32 everywhere but dB and dC in bf16, which round once.  With la
    # near -160 a step, cum reaches -4e4 in a chunk, where one f32 ulp is
    # 4e-3: a decay exp(cum_i - cum_j) between neighbours is the difference
    # of two such sums, and the kernel's and torch.cumsum's orders may
    # differ by an ulp or two, so those decays may differ by ~1%: 1e-2
    # there (the case is for the masked exponent, NaN-free).  The norm
    # limits are 3-6x the readings of the redesign (on an H100): f32
    # 0.8-1.4e-6, bf16 B/C dB and dC 5.5-5.9e-5; la << 0, over three
    # seeds, y and dxbar 1.1-2.9e-5, states 0-7.8e-5, dla 4.7-7.2e-4, dB
    # and dC 0.5-3.3e-5
    tol = 1e-4 if dtype == torch.float32 and la_scale < 1 else 1e-2
    ntol = K5_NORM_TOL["la << 0" if la_scale >= 1 else str(dtype)[6:]]
    print(f"{tag} K5 {label:13s} ({b},{T},{Z_NH},{DH}) B/C "
          f"{str(dtype)[6:]:8s} errors " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {tol:.0e}, relative to 1 + max); ||error|| / ||plain|| "
          + ", ".join(f"{k} {v:.2e}" for k, v in norms.items())
          + " (tol " + ", ".join(f"{k} {v:.1e}" for k, v in ntol.items())
          + f"); finite {finite}; backward repeats bit for bit {same}")
    check(all(norms[k] <= ntol[k] for k in ntol),
          f"K5 {label} {dtype}: ||error|| / ||plain|| {norms}")
    check(finite, f"K5 {label} {dtype}: a non-finite output")
    check(same, f"K5 {label} {dtype}: backward not deterministic")
    check(max(errs.values()) <= tol, f"K5 {label} {dtype}: {errs}")
    worst = max(abs_err(a, c) for n, a, c in pairs)
    return (xbar, la, B, C, dy), st, worst, norms


# (label, b, T, B/C dtype, log-decay scale): T 2000 gives Q = 250, a chunk
# of 3 whole and one 58-row sub-chunk; la near -200 a step would overflow
# any exponent formed above the diagonal
K5_CASES = [("train shape", TRAIN_B, TRAIN_S, "float32", 0.1),
            ("train shape", TRAIN_B, TRAIN_S, "bfloat16", 0.1),
            ("ragged T=2000", 1, 2000, "float32", 0.1),
            ("la << 0", 1, TRAIN_S, "float32", 200.0)]


def phase_k5(dev):
    """K5 at zamba2's training shape of one layer.  The model's B and C are
    f32 (the SiLU of the conv runs in f32), so the path case is f32; bf16
    B/C is checked too.  Returns the path case's numbers, the kernel's
    time as one forward + one backward."""
    import torch
    from repro_torch.kernels import ssd_scan as k5
    gen = torch.Generator(device=dev).manual_seed(5)
    worst_path_err, path = 0.0, None
    for label, b, T, dtype, scale in K5_CASES:
        inputs, st, worst, norms = k5_case(k5, dev, gen, label, b, T,
                                           getattr(torch, dtype), scale)
        if label == "train shape" and dtype == "float32":
            worst_path_err, path, path_norms = worst, (*inputs, st), norms
        del inputs, st
    xbar, la, B, C, dy, st = path
    t = {"fwd_ms": time_ms(lambda: k5.ssd_scan_fwd(xbar, la, B, C, Z_CHUNK),
                           10),
         "bwd_ms": time_ms(lambda: k5.ssd_scan_bwd(dy, xbar, la, B, C, st,
                                                   Z_CHUNK), 5),
         "plain_fwd_ms": time_ms(lambda: k5.ssd_scan_plain(xbar, la, B, C,
                                                           Z_CHUNK), 3),
         "plain_bwd_ms": time_ms(lambda: k5.ssd_scan_bwd_plain(
             dy, xbar, la, B, C, st, Z_CHUNK), 3),
         "library_ms": None}
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
    t["kernels_ms"] = kernels_by_name(
        lambda: (k5.ssd_scan_fwd(xbar, la, B, C, Z_CHUNK),
                 k5.ssd_scan_bwd(dy, xbar, la, B, C, st, Z_CHUNK)), 3)
    print("[11] K5 kernels, device time of one forward and one backward "
          "(torch.profiler): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in t["kernels_ms"].items()))
    fby, ffl, bby, bfl = k5_work(TRAIN_B, TRAIN_S, Z_CHUNK, 4)
    # the operations at the dense bf16 peak, as K2's: the least time the
    # card could take; the f32 rate outside the tensor cores is printed
    fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
    bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
    t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
             bound_by=fo if fo == bo else "bytes and operations",
             max_abs_err=worst_path_err, norm_err=path_norms)
    fw, bw = t["fwd_ms"], t["bwd_ms"]
    print(f"[11] K5 f32 B/C ({TRAIN_B},{TRAIN_S}, {Z_NH} heads of {DH}, "
          f"{Z_G} groups, N {Z_N}, Q {Z_CHUNK}): forward {fw:.3f} ms "
          f"({ffl / fw / 1e9:.2f} TFLOP/s, {fby / fw / 1e6:.1f} GB/s; plain "
          f"{t['plain_fwd_ms']:.3f}; bound {fb:.4f} {fo}: {fby / 1e9:.3f} GB "
          f"and {ffl / 1e9:.2f} GFLOP, {ffl / H100_F32_FLOPS * 1e3:.4f} ms "
          f"at the f32 rate); backward {bw:.3f} ms ({bfl / bw / 1e9:.2f} "
          f"TFLOP/s; plain {t['plain_bwd_ms']:.3f}; bound {bb:.4f} {bo}: "
          f"{bby / 1e9:.3f} GB and {bfl / 1e9:.2f} GFLOP, "
          f"{bfl / H100_F32_FLOPS * 1e3:.4f} ms at the f32 rate); no PyTorch "
          "call computes this scan")
    return t


def phase_two_layer_zamba2(dev):
    """One training step's loss and gradients of full-width zamba2 cut to
    the plan [mamba, mamba, attn] (n_layers 2, attn_every 2), f32, batch 1
    x 512: CPU (plain versions) against the card (kernels), the same
    seeded weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import ssd_scan as k5
    from repro_torch.models import transformer
    base = get("zamba2-1.2b")
    cfg = dataclasses.replace(base, n_layers=2, dtype="float32",
                              ssm=dataclasses.replace(base.ssm, attn_every=2))
    layout = ParallelPlan().validate(mode="train").build()
    cpu = init_params(transformer.abstract_params(cfg),
                      torch.Generator().manual_seed(2), "cpu",
                      torch.float32)
    rng = np.random.default_rng(2)
    m = cpu["stack"]["mamba"]        # the init leaves these 0 and 1
    for k in ("dt_bias", "A_log", "D"):
        m[k] += torch.from_numpy(0.3 * rng.standard_normal(m[k].shape)
                                 .astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 513)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][0, -9:] = -1
    res = {}
    for d in ("cpu", dev):
        before = k5.launches_bwd
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        loss, _ = transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        res[str(d)] = (loss.item(), [g.cpu() for g in grads],
                       k5.launches_bwd - before)
    (l_cpu, g_cpu, n_cpu), (l_dev, g_dev, n_dev) = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    # each leaf against its own largest entry, so that a fault in a leaf
    # of small gradients (w_bc through dB and dC) shows as plainly as one
    # in a large leaf
    errs = {n: (leaf_err(a, b), b.abs().max().item())
            for n, a, b in zip(names, g_dev, g_cpu)}
    worst = max(e for e, _ in errs.values())
    tol = 1e-4      # f32 on both; the order of the sums differs
    print(f"[12] zamba2 [mamba, mamba, attn] full width f32 train step "
          f"(1x512): loss cpu {l_cpu:.6f} card {l_dev:.6f}; gradient "
          f"max |card - cpu| / max |cpu| per leaf, worst first (max |cpu| "
          f"in brackets): " + ", ".join(
              f"{k} {e:.1e} [{g:.1e}]" for k, (e, g) in sorted(
                  errs.items(), key=lambda kv: -kv[1][0])[:8])
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e}); "
          f"K5 backward launches cpu {n_cpu}, card {n_dev}")
    check(n_cpu == 0 and n_dev == 2, f"two-layer zamba2: K5 backward "
          f"launches cpu {n_cpu}, card {n_dev}")
    check(abs(l_cpu - l_dev) <= 1e-4 and math.isfinite(l_dev),
          f"two-layer zamba2 train loss: {l_cpu} vs {l_dev}")
    check(worst <= tol, f"two-layer zamba2 train gradients: {worst}")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix


def reset_launches():
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.kernels import ssd_scan as k5
    k1.launches = k2.launches = k2.launches_bwd = k3.launches = 0
    k3.launches_bwd = k4.launches = k5.launches = k5.launches_bwd = 0
    k1.launches_by_route = dict.fromkeys(k1.ROUTES, 0)
    k2.launches_by_route = dict.fromkeys(k2.ROUTES, 0)
    k2.launches_bwd_by_route = dict.fromkeys(k2.ROUTES, 0)


def check_k2_routes(launches, tag, label):
    """The K2 launches of a main-path run by route, forward and backward:
    every bf16 attention takes tc, none simt, and the routes add up to the
    totals."""
    from repro_torch.kernels import flash_attention as k2
    routes = {"K2": dict(k2.launches_by_route),
              "K2 bwd": dict(k2.launches_bwd_by_route)}
    print(f"[{tag}] K2 launches by route in the {label}: {routes}")
    for key, by in routes.items():
        check(by["simt"] == 0, f"{label}: {by['simt']} bf16 {key} launches "
              "took the simt route")
        check(sum(by.values()) == launches[key],
              f"{label}: {key} routes {by} != total {launches[key]}")
    return routes


def check_k1_routes(launches, tag, label):
    """The K1 launches of a main-path run by route: every bf16 GEMM takes
    tc or decode, none simt, and the routes add up to the total."""
    from repro_torch.kernels import matmul as k1
    routes = dict(k1.launches_by_route)
    print(f"[{tag}] K1 launches by route in the {label}: {routes}")
    check(routes["simt"] == 0, f"{label}: {routes['simt']} bf16 K1 GEMMs "
          "took the simt route")
    check(sum(routes.values()) == launches["K1"],
          f"{label}: K1 routes {routes} != total {launches['K1']}")
    return routes


def read_launches():
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.kernels import rmsnorm as k3
    from repro_torch.kernels import ssd_scan as k5
    return {"K1": k1.launches, "K2": k2.launches, "K2 bwd": k2.launches_bwd,
            "K3": k3.launches, "K3 bwd": k3.launches_bwd, "K4": k4.launches,
            "K5": k5.launches, "K5 bwd": k5.launches_bwd}


def phase_serve(card):
    import torch
    from repro_torch.launch import serve
    reset_launches()
    stats = serve.main(["--arch", "tinyllama-1.1b", "--device", "cuda",
                        "--requests", "8", "--batch-size", "8",
                        "--shared-prefix", "256", "--max-new", "32",
                        "--max-len", "512", "--block-size", "16"])
    torch.cuda.synchronize()
    launches = read_launches()
    steps = stats["prefill_steps"] + stats["decode_steps"]
    want = {"K1": 155 * steps, "K2": LAYERS * stats["prefill_steps"],
            "K2 bwd": 0, "K3": (2 * LAYERS + 1) * steps, "K3 bwd": 0,
            "K4": LAYERS * stats["decode_steps"], "K5": 0, "K5 bwd": 0}
    print(f"[7] launches in the serving run: {launches} over "
          f"{stats['prefill_steps']} prefill + {stats['decode_steps']} decode "
          f"steps (expected {want})")
    check(stats["tokens"] == 8 * 32 and stats["completed"] == 8,
          f"serving run: {stats['tokens']} tokens, {stats['completed']} done")
    check(stats["nonfinite_rows"] == 0,
          f"serving run: {stats['nonfinite_rows']} non-finite logit rows")
    check(all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")),
          f"serving run skipped a kernel: {launches}")
    check(launches == want, f"serving run launches {launches} != {want}")
    routes = check_k1_routes(launches, "7", "serving run")
    check(routes["tc"] > 0 and routes["decode"] > 0,
          f"serving run: K1 routes {routes}")
    k2_routes = check_k2_routes(launches, "7", "serving run")
    print(f"[7] serving tinyllama-1.1b bf16, 8 requests x 32 new tokens on "
          f"{card}: TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{stats['tpot_p50_s'] * 1e3:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} tok/s")
    return launches, routes, k2_routes


def phase_train(card, arch="tinyllama-1.1b", steps=TRAIN_STEPS,
                per_step=TRAIN_LAUNCHES, tag="8"):
    """``repro_torch.launch.train`` at full depth and width in bf16, batch
    4 x 2048, remat, AdamW, synthetic tokens from seed 0; the launch
    counters reset just before and read just after."""
    import torch
    from repro_torch.launch import train
    tel_path = ROOT / "build" / f"chip_smoke_train_{arch}_telemetry.json"
    tel_path.parent.mkdir(parents=True, exist_ok=True)
    reset_launches()
    out = train.main(["--arch", arch, "--device", "cuda",
                      "--steps", str(steps), "--batch", str(TRAIN_B),
                      "--seq", str(TRAIN_S), "--lr", "3e-4", "--warmup", "20",
                      "--log-every", "1", "--telemetry", str(tel_path)])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: steps * n for k, n in per_step.items()}
    want["K4"] = 0
    tel = out["telemetry"]
    print(f"[{tag}] launches in the {arch} training run: {launches} over "
          f"{steps} steps (expected {want})")
    losses = tel["series"]["loss"]
    check(len(losses) == steps and all(map(math.isfinite, losses)),
          f"{arch} training run: losses {losses}")
    check(tel["nonfinite"] is None, f"{arch} training run: {tel['nonfinite']}")
    check(launches == want, f"{arch} training run launches {launches} != "
          f"{want}")
    routes = check_k1_routes(launches, tag, f"{arch} training run")
    check(routes["tc"] == launches["K1"],
          f"{arch} training run: K1 routes {routes}")
    k2_routes = check_k2_routes(launches, tag, f"{arch} training run")
    mfu = (f"MFU {tel['mfu'] * 100:.3f}% of {tel['peak_flops']:.3g} FLOP/s"
           if tel["mfu"] is not None else "MFU not reported")
    print(f"[{tag}] training {arch} bf16, batch {TRAIN_B} x {TRAIN_S}, "
          f"remat, AdamW on {card}: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step times " + " ".join(f"{x:.3f}" for x in
                                        tel["series"]["t_step"])
          + f" s (first = warm-up); steady {tel['t_step_s']:.3f} s/step, "
          f"{tel['tokens_per_s']:.0f} tok/s, {mfu}; peak memory "
          f"{tel['mem_peak_bytes'] / 2 ** 30:.2f} GiB")
    return launches, routes, k2_routes


def kernel_group(name: str) -> str:
    """The part of a training step a device kernel belongs to."""
    low = name.lower()
    # K5's backward runs the forward's first two passes again (with true);
    # its ssd_cb is the forward's kernel and is counted with it
    if re.search(r"ssd_(state|pass)<[^>]*true>", name) or \
            "ssd_bwd" in name or "group_sum" in name:
        return "K5 backward"
    if "ssd_" in name:
        return "K5 forward (and its recompute)"
    # every K1 kernel's name starts with k1_ (matmul_kernel is the simt
    # route's kernel); matched before the library's gemm names
    if re.search(r"(^|[^A-Za-z0-9_])k1_", name) or "matmul_kernel" in name:
        return "K1 matmul (forward linears and their recompute)"
    # the tc route's kernels (k2_tc_*) and the simt route's (fa_*)
    if "k2_tc_fwd" in name or "fa_fwd" in name:
        return "K2 forward (and its recompute)"
    if "k2_tc_bwd" in name or "fa_bwd" in name:
        return "K2 backward"
    if "rms_" in name:
        return "K3 forward and backward"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "torch.matmul (dx, dw)"
    return "other (elementwise, reductions, AdamW, copies)"


def phase_breakdown(dev, card, arch="tinyllama-1.1b", tag="9"):
    """Where the time of one training step goes: torch.profiler over the
    second step of the phase 8 (or 13) configuration, device time summed
    by kernel group against the step's wall time (host clock,
    synchronised).  A profiler that sees no device kernel leaves the
    breakdown unmeasured; it does not fail the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = get(arch)
    layout = ParallelPlan().validate(mode="train").build()
    params = init_params(transformer.abstract_params(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         dev, torch.bfloat16)
    state = adamw_init(params)
    step = make_train_step(cfg, layout, OptimConfig(
        lr=3e-4, warmup=20, total_steps=TRAIN_STEPS))
    data = TokenStream(cfg, ShapeConfig("smoke", TRAIN_S, TRAIN_B, "train"),
                       DataConfig(seed=0), dev)
    sync = (torch.cuda.synchronize if torch.device(dev).type == "cuda"
            else lambda: None)
    params, state, _ = step(params, state, next(data))     # warm-up
    batch = next(data)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(met["loss"].item()), "breakdown step: loss")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] torch.profiler saw no device kernels on {card}: the"
              f" {arch} step's breakdown is not measured")
        return None
    groups, spans, names = {}, [], {}
    for e in kernels:
        g = kernel_group(e.name)
        n, ms = groups.get(g, (0, 0.0))
        groups[g] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
        spans.append((e.time_range.start, e.time_range.end))
        if g.startswith("other"):
            names[e.name] = names.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy, end = 0.0, -math.inf                  # union of kernel intervals
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3
    print(f"[{tag}] one {arch} training step (batch {TRAIN_B} x {TRAIN_S}) "
          f"under torch.profiler on {card}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for g, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"    {g}: {ms:.1f} ms in {n} kernels "
              f"({ms / wall_ms * 100:.1f}% of the step)")
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:4]:
        print(f"    largest in other: {name[:90]}: {ms:.1f} ms")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "groups": groups}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(f"chip_smoke on {card}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()

    def timed(fn, *args, **kw):
        """fn's result, with the seconds it took printed after it."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        print(f"    ({fn.__name__} took {time.perf_counter() - t:.1f} s)")
        return out
    timed(phase_build)
    k1_numbers = timed(phase_k1, dev)
    k1_numbers["decode"]["decode_max_m_measured"] = timed(
        phase_k1_threshold, dev)
    k4_numbers = timed(phase_k4, dev)
    k3_numbers = timed(phase_k3, dev)
    k2_numbers = timed(phase_k2, dev)
    timed(phase_two_layer, dev)
    timed(phase_two_layer, dev, "bfloat16")
    timed(phase_two_layer_train, dev)
    # one sequence of 256: the CPU side of gemma's 256000-word head is
    # the slow part of these two
    timed(phase_two_layer_train, dev, "paper-transformer", seed=6, rows=1,
          seq=256)
    timed(phase_two_layer_train, dev, "gemma-2b", seed=7, rows=1, seq=256)
    serve_launches, serve_routes, serve_k2 = timed(phase_serve, card)
    train_launches, train_routes, train_k2 = timed(phase_train, card)
    timed(phase_breakdown, dev, card)
    k1_train, k1_train_err = timed(phase_k1_train, dev)
    k5_numbers = timed(phase_k5, dev)
    timed(phase_two_layer_zamba2, dev)
    zamba_launches, zamba_routes, zamba_k2 = timed(
        phase_train, card, "zamba2-1.2b", Z_STEPS, Z_LAUNCHES, tag="13")
    timed(phase_breakdown, dev, card, "zamba2-1.2b", tag="14")

    def launched(*names):
        by = {path: sum(counts[n] for n in names) for path, counts in
              (("serve", serve_launches), ("train", train_launches),
               ("train_zamba2", zamba_launches))}
        return dict(launches=sum(by.values()), launches_by_path=by)
    k1_tc, k1_dec = k1_numbers["tc"], k1_numbers["decode"]
    for arch, agg in k1_train.items():
        k1_tc.update({f"train_{arch}_{k}": v for k, v in agg.items()})
    k1_tc["max_abs_err"] = max(k1_tc["max_abs_err"], k1_train_err)
    by_route = {r: serve_routes[r] + train_routes[r] + zamba_routes[r]
                for r in serve_routes}
    k2_by_route = {key: {r: sum(p[key][r] for p in (serve_k2, train_k2,
                                                    zamba_k2))
                         for r in serve_k2[key]} for key in serve_k2}

    def k1_launched(route):
        by = {path: routes[route] for path, routes in
              (("serve", serve_routes), ("train", train_routes),
               ("train_zamba2", zamba_routes))}
        return dict(launches=sum(by.values()), launches_by_path=by,
                    launches_by_route=by_route)
    ratios = {"decode step": k1_dec["ms"] / k1_dec["library_ms"],
              "prefill": k1_tc["ms"] / k1_tc["library_ms"]}
    ratios.update({f"{a} train step": v["ms"] / v["library_ms"]
                   for a, v in k1_train.items()})
    print("[15] K1 / torch.matmul summed over each path's GEMMs, called "
          "from the host (target 1.5x, limit 3x): " + ", ".join(
              f"{k} {v:.2f}x" for k, v in ratios.items())
          + "; device time (CUDA graph): decode step "
          f"{k1_dec['device_ms'] / k1_dec['library_device_ms']:.2f}x, "
          f"prefill {k1_tc['device_ms'] / k1_tc['library_device_ms']:.2f}x")
    kernels = [
        dict(name="K1 matmul, tc route (prefill, training)", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul_hopper.cu",
             replaces="src/repro/kernels/matmul.py:30",
             **k1_launched("tc"), **k1_tc),
        dict(name="K1 matmul, decode route", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul_hopper.cu",
             replaces="src/repro/kernels/matmul.py:30",
             **k1_launched("decode"), **k1_dec),
        dict(name="K2 flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_hopper.cu "
                    "(tc), src/repro_torch/kernels/csrc/flash_attention.cu "
                    "(simt)",
             replaces="src/repro/kernels/flash_attention.py:24",
             **launched("K2", "K2 bwd"), launches_by_route=k2_by_route,
             **k2_numbers),
        dict(name="K3 rmsnorm", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:19",
             **launched("K3", "K3 bwd"), **k3_numbers),
        dict(name="K4 paged_flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode.cu",
             replaces="src/repro/kernels/paged_decode.py:72",
             **launched("K4"), **k4_numbers),
        dict(name="K5 ssd_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:23",
             **launched("K5", "K5 bwd"), **k5_numbers),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_by_path", "launches_by_route",
             "decode_max_m_measured", "device_ms", "library_device_ms",
             "simt_ms", "fwd_ms", "bwd_ms", "simt_fwd_ms", "simt_bwd_ms",
             "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms", "fwd_bound_ms",
             "bwd_bound_ms", "fwd_device_ms", "bwd_device_ms",
             "library_fwd_device_ms", "fwd_host_ms", "bwd_host_ms",
             "bwd_kernels_ms", "library_bwd_ms", "norm_err", "kernels_ms",
             "shapes") + tuple(
                 f"train_{arch}_{k}" for arch in ("tinyllama", "zamba2")
                 for k in ("ms", "simt_ms", "plain_ms", "library_ms",
                           "bound_ms"))
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [
        {k: kn[k] for k in keys + extra if k in kn} for kn in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
