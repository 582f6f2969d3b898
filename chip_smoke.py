#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, in order (any failure raises and exits nonzero):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  2. K1 matmul against its plain version at every GEMM shape of
     tinyllama-1.1b's decode and prefill, bf16 and f32, every activation,
     with and without bias; time the path's case (bf16, no bias, no act);
  3. K4 paged decode against its plain version at the tinyllama shape
     (B = 8, 32 q heads, 4 kv heads, d = 64, block 16): ragged contexts of
     64-1024 tokens, a windowed case, null and recycled blocks, residuals;
  4. full-width two-layer tinyllama in f32: CPU (plain versions) against
     the card (kernels), prefill and the first fused decode step's logits;
  5. the serving run: ``repro_torch.launch.serve`` serves 8 requests of
     tinyllama-1.1b at full depth and width in bf16 (weights from a seed),
     with both kernels' launch counters reset just before and read after.

The lines before the last carry one JSON object of per-kernel numbers and
the card's name and power limit from nvidia-smi; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, it exits nonzero and
prints no result.
"""
import dataclasses
import json
import math
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


def bound_ms(nbytes, flops, peak):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rel_err(got, want):
    """max |got - want| / (1 + |want|), elementwise, in f32."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / (1 + w.abs())).max().item()


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[1] built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")


def phase_k1(dev):
    import torch
    from repro_torch.kernels import matmul as k1
    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = [(DECODE_M, k, n, name) for name, k, n, _ in
              LAYER_GEMMS + [HEAD_GEMM]]
    shapes += [(PREFILL_M, k, n, name) for name, k, n, _ in LAYER_GEMMS]
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    times, worst_path_err = {}, 0.0
    for m, k, n, name in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            w = (torch.randn(k, n, generator=gen, device=dev)
                 / math.sqrt(k)).to(dtype)
            b = torch.randn(n, generator=gen, device=dev).to(dtype)
            worst, worst_abs = 0.0, 0.0
            for act in k1.ACTS:
                for bias in (None, b):
                    got = k1.matmul(x, w, bias, act=act)
                    want = k1.matmul_plain(x, w, bias, act=act)
                    worst = max(worst, rel_err(got, want))
                    worst_abs = max(worst_abs,
                                    (got.float() - want.float()).abs()
                                    .max().item())
            print(f"[2] K1 {name:12s} ({m},{k})@({k},{n}) {str(dtype)[6:]:8s}"
                  f" max rel err {worst:.2e} (tol {tol[dtype]:.0e}), "
                  f"max abs err {worst_abs:.2e}")
            check(worst <= tol[dtype], f"K1 {name} {dtype}: {worst}")
            if dtype == torch.bfloat16 and m == DECODE_M:
                worst_path_err = max(worst_path_err, worst_abs)
        # timing at the path's case: bf16, no bias, no activation; weights
        # rotate over enough copies to exceed the 50 MB L2 cache
        copies = max(1, min(64, math.ceil(120e6 / (k * n * 2))))
        ws = [(torch.randn(k, n, generator=gen, device=dev)
               / math.sqrt(k)).to(torch.bfloat16) for _ in range(copies)]
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        it = iter(range(1 << 30))
        reps = 60 if m == DECODE_M else 5

        def pick():
            return ws[next(it) % copies]
        t = {"ms": time_ms(lambda: k1.matmul(x, pick()), reps),
             "plain_ms": time_ms(lambda: k1.matmul_plain(x, pick()), reps),
             "library_ms": time_ms(lambda: torch.matmul(x, pick()), reps)}
        t["bound_ms"], t["bound_by"] = bound_ms(
            2 * (m * k + k * n + m * n), 2 * m * n * k, H100_BF16_FLOPS)
        times[(m, name)] = t
        print(f"    time bf16 ({m},{k})@({k},{n}): kernel {t['ms']:.4f} ms, "
              f"plain {t['plain_ms']:.4f} ms, torch.matmul "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
    step = {key: 0.0 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    prefill = dict(step)
    for name, k, n, per_layer in LAYER_GEMMS:
        for key in step:
            step[key] += LAYERS * per_layer * times[(DECODE_M, name)][key]
            prefill[key] += LAYERS * per_layer * times[(PREFILL_M, name)][key]
    for key in step:
        step[key] += times[(DECODE_M, "head")][key]
        prefill[key] += times[(DECODE_M, "head")][key]
    for label, agg, m in (("decode step", step, DECODE_M),
                          ("prefill of 8x512", prefill, PREFILL_M)):
        flops = 2 * DECODE_M * D * VOCAB + sum(
            2 * m * k * n * LAYERS * per_layer
            for _, k, n, per_layer in LAYER_GEMMS)
        print(f"[2] K1 per {label} (155 launches, bf16): kernel "
              f"{agg['ms']:.3f} ms ({flops / agg['ms'] / 1e9:.2f} TFLOP/s), "
              f"plain {agg['plain_ms']:.3f} ms, torch.matmul "
              f"{agg['library_ms']:.3f} ms, bound {agg['bound_ms']:.3f} ms")
    by = {times[(DECODE_M, name)]["bound_by"]
          for name, *_ in LAYER_GEMMS + [HEAD_GEMM]}
    step["bound_by"] = by.pop() if len(by) == 1 else "bytes and operations"
    step["max_abs_err"] = worst_path_err
    return step


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


def phase_two_layer(dev):
    """Full-width tinyllama cut to two layers, f32, the same seeded
    weights on the CPU (plain versions) and on the card (kernels)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import blocks, transformer
    from repro_torch.serve import kvcache
    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=2,
                              dtype="float32")
    layout = ParallelPlan().validate(mode="serve").build()
    params = {"cpu": init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", torch.float32)}
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
        kv = kvcache.PagedKVCache(cfg, len(lens), L, block=blk,
                                  dtype=torch.float32)
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
        out[where] = (pl.cpu(), dl.cpu())
    tol = 1e-3      # f32 on both; only the order of the sums differs
    for i, name in enumerate(("prefill last-position", "first decode step")):
        err = (out["cpu"][i] - out["cuda"][i]).abs().max().item()
        scale = out["cpu"][i].abs().max().item()
        print(f"[4] two-layer full width f32 {name} logits: max abs err "
              f"{err:.2e} (tol {tol:.0e}; |logits| up to {scale:.2f})")
        check(err <= tol and math.isfinite(err), f"two-layer {name}: {err}")


def phase_serve(card):
    import torch
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.launch import serve
    k1.launches = 0
    k4.launches = 0
    stats = serve.main(["--arch", "tinyllama-1.1b", "--device", "cuda",
                        "--requests", "8", "--batch-size", "8",
                        "--shared-prefix", "256", "--max-new", "32",
                        "--max-len", "512", "--block-size", "16"])
    torch.cuda.synchronize()
    launches = {"K1": k1.launches, "K4": k4.launches}
    steps = stats["prefill_steps"] + stats["decode_steps"]
    print(f"[5] launches in the serving run: {launches} over "
          f"{stats['prefill_steps']} prefill + {stats['decode_steps']} decode "
          f"steps (expected K1 {155 * steps}, K4 {LAYERS * stats['decode_steps']})")
    check(stats["tokens"] == 8 * 32 and stats["completed"] == 8,
          f"serving run: {stats['tokens']} tokens, {stats['completed']} done")
    check(stats["nonfinite_rows"] == 0,
          f"serving run: {stats['nonfinite_rows']} non-finite logit rows")
    check(launches["K1"] > 0 and launches["K4"] > 0,
          f"serving run skipped a kernel: {launches}")
    print(f"[5] serving tinyllama-1.1b bf16, 8 requests x 32 new tokens on "
          f"{card}: TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{stats['tpot_p50_s'] * 1e3:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} tok/s")
    return launches


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
    phase_build()
    k1_numbers = phase_k1(dev)
    k4_numbers = phase_k4(dev)
    phase_two_layer(dev)
    launches = phase_serve(card)
    kernels = [
        dict(name="K1 matmul", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul.cu",
             replaces="src/repro/kernels/matmul.py:30",
             launches=launches["K1"], **k1_numbers),
        dict(name="K4 paged_flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode.cu",
             replaces="src/repro/kernels/paged_decode.py:72",
             launches=launches["K4"], **k4_numbers),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [{k: kn[k] for k in keys}
                                  for kn in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
