#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU: ``python3 chip_smoke.py`` from the root of a checkout.

Phases, in order (any failure raises and exits nonzero):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     (one process per source, all at once);
  2. K1 matmul against its plain version at every GEMM shape of
     tinyllama-1.1b's decode and prefill, bf16 and f32, every activation,
     with and without bias; time the path's case (bf16, no bias, no act);
  3. K4 paged decode against its plain version at the tinyllama shape
     (B = 8, 32 q heads, 4 kv heads, d = 64, block 16): ragged contexts of
     64-1024 tokens, a windowed case, null and recycled blocks, residuals;
  4. K3 RMSNorm forward and backward against their plain versions at the
     training shape (8192 rows x 2048), bf16 and f32, with and without a
     zero-centred gain; times beside ``F.rms_norm``;
  5. K2 flash attention forward and backward against their plain versions
     at the training shape (4 x 2048, 32/4 heads, d = 64, causal), bf16 and
     f32; times beside ``F.scaled_dot_product_attention``;
  6. full-width two-layer tinyllama in f32: CPU (plain versions) against
     the card (kernels), serving prefill and the first fused decode step's
     logits, then one training step's loss and gradients (batch 2 x 512);
  7. the serving run: ``repro_torch.launch.serve`` serves 8 requests of
     tinyllama-1.1b at full depth and width in bf16 (weights from a seed),
     with the kernels' launch counters reset just before and read after;
  8. the training run: ``repro_torch.launch.train`` trains tinyllama-1.1b at
     full depth and width in bf16 (batch 4 x 2048, remat, AdamW, synthetic
     tokens from seed 0) for a few steps, counters reset before and read
     after; every loss must be finite and the launches as expected;
  9. where the time of one such training step goes: torch.profiler's
     device time by kernel group, and the device's idle share.

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
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 5    # the training run (phase 8)
# launches per training step: K1 runs the 7 linears of each layer twice
# (forward and its recompute under remat) and the head's 2 loss chunks
# twice; K2 runs each layer's attention forward twice and backward once;
# K3 the 2 norms of each layer twice and ln_f once, backward once each
TRAIN_LAUNCHES = {"K1": 2 * 7 * LAYERS + 2 * 2, "K2": 2 * LAYERS,
                  "K2 bwd": LAYERS, "K3": 2 * 2 * LAYERS + 1,
                  "K3 bwd": 2 * LAYERS + 1}


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


def scaled_err(got, want):
    """max |got - want| / (1 + max |want|), in f32: for gradients, whose
    entries span many magnitudes."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / (1 + w.abs().max())).item()


def abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


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


def phase_k3(dev):
    """K3 at the training shape: every norm of a step sees 8192 rows of
    2048.  Returns the path case's numbers (bf16, no zero-centring), the
    kernel's time as forward + backward of one norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as k3
    m, h = TRAIN_B * TRAIN_S, D
    gen = torch.Generator(device=dev).manual_seed(3)
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    worst_path_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(m, h, generator=gen, device=dev).to(dtype)
        g = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(m, h, generator=gen, device=dev).to(dtype)
        for zc in (False, True):
            y, rstd = k3.rmsnorm_fwd(x, g, zero_centered=zc)
            dx, dg = k3.rmsnorm_bwd(dy, x, g, rstd, zero_centered=zc)
            y2, rstd2 = k3.rmsnorm_plain(x, g, zero_centered=zc)
            dx2, dg2 = k3.rmsnorm_bwd_plain(dy, x, g, rstd2, zero_centered=zc)
            errs = {"y": scaled_err(y, y2), "rstd": scaled_err(rstd, rstd2),
                    "dx": scaled_err(dx, dx2), "dg": scaled_err(dg, dg2)}
            worst = max(errs.values())
            print(f"[4] K3 ({m},{h}) {str(dtype)[6:]:8s} zc={zc!s:5s} errors "
                  + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                  + f" (tol {tol[dtype]:.0e}, relative to 1 + max)")
            check(worst <= tol[dtype], f"K3 {dtype} zc={zc}: {errs}")
            if dtype == torch.bfloat16 and not zc:
                worst_path_err = max(abs_err(a, b) for a, b in
                                     ((y, y2), (dx, dx2), (dg, dg2)))
    xr = x.detach().requires_grad_()
    gr = g.detach().requires_grad_()

    def lib_fwd_bwd():
        out = F.rms_norm(xr, (h,), gr, 1e-6)
        torch.autograd.grad(out, (xr, gr), dy)
    t = {"fwd_ms": time_ms(lambda: k3.rmsnorm_fwd(x, g), 50),
         "bwd_ms": time_ms(lambda: k3.rmsnorm_bwd(dy, x, g, rstd), 50),
         "plain_fwd_ms": time_ms(lambda: k3.rmsnorm_plain(x, g), 20),
         "plain_bwd_ms": time_ms(lambda: k3.rmsnorm_bwd_plain(dy, x, g, rstd),
                                 20),
         "library_fwd_ms": time_ms(lambda: F.rms_norm(x, (h,), g, 1e-6), 50),
         "library_ms": time_ms(lib_fwd_bwd, 50)}
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
    fb, fo = bound_ms(2 * m * h * 2 + h * 2 + m * 4, 4 * m * h,
                      H100_F32_FLOPS)
    bb, bo = bound_ms(3 * m * h * 2 + 2 * h * 2 + m * 4, 10 * m * h,
                      H100_F32_FLOPS)
    t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
             bound_by=fo if fo == bo else "bytes and operations",
             max_abs_err=worst_path_err)
    print(f"[4] K3 bf16 ({m},{h}): forward {t['fwd_ms']:.4f} ms (plain "
          f"{t['plain_fwd_ms']:.4f}, F.rms_norm {t['library_fwd_ms']:.4f}, "
          f"bound {fb:.4f} {fo}); backward {t['bwd_ms']:.4f} ms (plain "
          f"{t['plain_bwd_ms']:.4f}, bound {bb:.4f} {bo}); F.rms_norm fwd+bwd"
          f" {t['library_ms']:.4f} ms")
    return t


def k2_work(q_pos, k_pos, b, nq, d, elt):
    """(fwd bytes, fwd flops, bwd bytes, bwd flops) of one attention call,
    causal, the flops counted over the allowed (query, key) pairs of these
    positions: 2 products of 2*d flops a pair forward, 5 backward."""
    qp, kp = q_pos[:, :, None], k_pos[None, None, :]
    allowed = (kp >= 0) & (qp >= kp)
    pairs = int(allowed.sum().item()) * nq
    sq, sk = q_pos.shape[1], k_pos.shape[0]
    nkv = NKV
    q_bytes = b * sq * nq * d * elt
    kv_bytes = 2 * b * sk * nkv * d * elt
    lse = b * nq * sq * 4
    pos = (b * sq + sk) * 4
    fwd = (2 * q_bytes + kv_bytes + lse + pos, 4 * d * pairs)
    bwd = (4 * q_bytes + 2 * kv_bytes + lse + pos, 10 * d * pairs)
    return (*fwd, *bwd)


def phase_k2(dev):
    """K2 at the training shape of one layer (also the serving prefill's
    kernel).  Returns the path case's numbers (bf16, causal), the kernel's
    time as one forward + one backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    b, s = TRAIN_B, TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(4)
    q_pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s) \
        .contiguous()
    k_pos = torch.arange(s, dtype=torch.int32, device=dev)
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
    worst_path_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(b, s, NQ, DH, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, s, NKV, DH, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, s, NKV, DH, generator=gen, device=dev).to(dtype)
        dout = torch.randn(b, s, NQ, DH, generator=gen, device=dev).to(dtype)
        out, lse = k2.flash_attention_fwd(q, k, v, q_pos, k_pos)
        grads = k2.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, k_pos)
        out2, lse2 = k2.flash_attention_fwd_plain(q, k, v, q_pos, k_pos)
        grads2 = k2.flash_attention_bwd_plain(q, k, v, out, dout, lse, q_pos,
                                              k_pos)
        pairs = [("out", out, out2), ("lse", lse, lse2)] + list(
            zip(("dq", "dk", "dv"), grads, grads2))
        errs = {n: scaled_err(a, c) for n, a, c in pairs}
        print(f"[5] K2 ({b},{s},{NQ}/{NKV},{DH}) causal {str(dtype)[6:]:8s} "
              "errors " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {tol[dtype]:.0e}, relative to 1 + max)")
        check(max(errs.values()) <= tol[dtype], f"K2 {dtype}: {errs}")
        if dtype == torch.bfloat16:
            worst_path_err = max(abs_err(a, c) for n, a, c in pairs
                                 if n != "lse")
        del grads2, out2
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dt)
    t = {"fwd_ms": time_ms(lambda: k2.flash_attention_fwd(q, k, v, q_pos,
                                                          k_pos), 5),
         "bwd_ms": time_ms(lambda: k2.flash_attention_bwd(
             q, k, v, out, dout, lse, q_pos, k_pos), 3),
         "plain_fwd_ms": time_ms(lambda: k2.flash_attention_fwd_plain(
             q, k, v, q_pos, k_pos), 2),
         "plain_bwd_ms": time_ms(lambda: k2.flash_attention_bwd_plain(
             q, k, v, out, dout, lse, q_pos, k_pos), 2),
         "library_fwd_ms": time_ms(sdpa, 20),
         "library_ms": time_ms(sdpa_fwd_bwd, 20)}
    t["ms"] = t["fwd_ms"] + t["bwd_ms"]
    t["plain_ms"] = t["plain_fwd_ms"] + t["plain_bwd_ms"]
    fby, ffl, bby, bfl = k2_work(q_pos, k_pos, b, NQ, DH, 2)
    fb, fo = bound_ms(fby, ffl, H100_BF16_FLOPS)
    bb, bo = bound_ms(bby, bfl, H100_BF16_FLOPS)
    t.update(fwd_bound_ms=fb, bwd_bound_ms=bb, bound_ms=fb + bb,
             bound_by=fo if fo == bo else "bytes and operations",
             max_abs_err=worst_path_err)
    print(f"[5] K2 bf16 ({b},{s},{NQ}/{NKV},{DH}) causal: forward "
          f"{t['fwd_ms']:.3f} ms ({ffl / t['fwd_ms'] / 1e9:.2f} TFLOP/s; "
          f"plain {t['plain_fwd_ms']:.3f}, sdpa {t['library_fwd_ms']:.3f}, "
          f"bound {fb:.4f} {fo}); backward {t['bwd_ms']:.3f} ms "
          f"({bfl / t['bwd_ms'] / 1e9:.2f} TFLOP/s; plain "
          f"{t['plain_bwd_ms']:.3f}, bound {bb:.4f} {bo}); sdpa fwd+bwd "
          f"{t['library_ms']:.3f} ms")
    return t


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
        print(f"[6] two-layer full width f32 {name} logits: max abs err "
              f"{err:.2e} (tol {tol:.0e}; |logits| up to {scale:.2f})")
        check(err <= tol and math.isfinite(err), f"two-layer {name}: {err}")


def phase_two_layer_train(dev):
    """One training step's loss and gradients of full-width tinyllama cut
    to two layers, f32, batch 2 x 512: CPU (plain versions) against the
    card (kernels), the same seeded weights and tokens."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params, tree_leaves, tree_map
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get("tinyllama-1.1b"), n_layers=2,
                              dtype="float32")
    layout = ParallelPlan().validate(mode="train").build()
    cpu = init_params(cfg, torch.Generator().manual_seed(1), "cpu",
                      torch.float32)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 513)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].clone()}
    batch["labels"][1, -7:] = -1
    res = {}
    for d in ("cpu", dev):
        live = tree_map(lambda t: t.detach().to(d).requires_grad_(), cpu)
        loss, _ = transformer.forward(
            cfg, layout, live, {k: v.to(d) for k, v in batch.items()},
            mode="train")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        res[str(d)] = (loss.item(), [g.cpu() for g in grads])
    (l_cpu, g_cpu), (l_dev, g_dev) = res["cpu"], res[str(dev)]
    names = [".".join(p) for p in _paths(cpu)]
    worst = max(scaled_err(a, b) for a, b in zip(g_dev, g_cpu))
    shown = {n: scaled_err(a, b) for n, a, b in zip(names, g_dev, g_cpu)
             if n in ("embed", "head", "ln_f.g", "stack.dense.ln1.g",
                      "stack.dense.attn.wq", "stack.dense.mlp.w_down")}
    tol = 1e-3      # f32 on both; the order of the sums differs
    print(f"[6] two-layer full width f32 train step (2x512): loss cpu "
          f"{l_cpu:.6f} card {l_dev:.6f}; gradient errors relative to "
          f"1 + max: " + ", ".join(f"{k} {v:.1e}" for k, v in shown.items())
          + f"; worst of {len(names)} leaves {worst:.1e} (tol {tol:.0e})")
    check(abs(l_cpu - l_dev) <= 1e-4 and math.isfinite(l_dev),
          f"two-layer train loss: {l_cpu} vs {l_dev}")
    check(worst <= tol, f"two-layer train gradients: {worst}")


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
    k1.launches = k2.launches = k2.launches_bwd = k3.launches = 0
    k3.launches_bwd = k4.launches = 0


def read_launches():
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import matmul as k1
    from repro_torch.kernels import paged_decode as k4
    from repro_torch.kernels import rmsnorm as k3
    return {"K1": k1.launches, "K2": k2.launches, "K2 bwd": k2.launches_bwd,
            "K3": k3.launches, "K3 bwd": k3.launches_bwd, "K4": k4.launches}


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
            "K4": LAYERS * stats["decode_steps"]}
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
    print(f"[7] serving tinyllama-1.1b bf16, 8 requests x 32 new tokens on "
          f"{card}: TTFT p50 {stats['ttft_p50_s'] * 1e3:.1f} ms, p95 "
          f"{stats['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{stats['tpot_p50_s'] * 1e3:.2f} ms, p95 "
          f"{stats['tpot_p95_s'] * 1e3:.2f} ms; {stats['tok_per_s']:.1f} tok/s")
    return launches


def phase_train(card):
    import torch
    from repro_torch.launch import train
    tel_path = ROOT / "build" / "chip_smoke_train_telemetry.json"
    tel_path.parent.mkdir(parents=True, exist_ok=True)
    reset_launches()
    out = train.main(["--arch", "tinyllama-1.1b", "--device", "cuda",
                      "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
                      "--seq", str(TRAIN_S), "--lr", "3e-4", "--warmup", "20",
                      "--log-every", "1", "--telemetry", str(tel_path)])
    torch.cuda.synchronize()
    launches = read_launches()
    want = {k: TRAIN_STEPS * n for k, n in TRAIN_LAUNCHES.items()}
    want["K4"] = 0
    tel = out["telemetry"]
    print(f"[8] launches in the training run: {launches} over {TRAIN_STEPS} "
          f"steps (expected {want})")
    losses = tel["series"]["loss"]
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"training run: losses {losses}")
    check(tel["nonfinite"] is None, f"training run: {tel['nonfinite']}")
    check(launches == want, f"training run launches {launches} != {want}")
    mfu = (f"MFU {tel['mfu'] * 100:.3f}% of {tel['peak_flops']:.3g} FLOP/s"
           if tel["mfu"] is not None else "MFU not reported")
    print(f"[8] training tinyllama-1.1b bf16, batch {TRAIN_B} x {TRAIN_S}, "
          f"remat, AdamW on {card}: losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + f"; step times " + " ".join(f"{x:.3f}" for x in
                                        tel["series"]["t_step"])
          + f" s (first = warm-up); steady {tel['t_step_s']:.3f} s/step, "
          f"{tel['tokens_per_s']:.0f} tok/s, {mfu}; peak memory "
          f"{tel['mem_peak_bytes'] / 2 ** 30:.2f} GiB")
    return launches, tel


def kernel_group(name: str) -> str:
    """The part of a training step a device kernel belongs to."""
    low = name.lower()
    if "matmul_kernel" in name:
        return "K1 matmul (forward linears and their recompute)"
    if "fa_fwd" in name:
        return "K2 forward (and its recompute)"
    if "fa_bwd" in name:
        return "K2 backward"
    if "rms_" in name:
        return "K3 forward and backward"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "torch.matmul (dx, dw)"
    return "other (elementwise, reductions, AdamW, copies)"


def phase_breakdown(dev, card):
    """Where the time of one training step goes: torch.profiler over the
    second step of the phase 8 configuration, device time summed by
    kernel group against the step's wall time (host clock, synchronised).
    A profiler that sees no device kernel leaves the breakdown
    unmeasured; it does not fail the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.config import OptimConfig, ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.core.params import init_params
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    cfg = get("tinyllama-1.1b")
    layout = ParallelPlan().validate(mode="train").build()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
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
        print(f"[9] torch.profiler saw no device kernels on {card}: the "
              "step's breakdown is not measured")
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
    print(f"[9] one training step (batch {TRAIN_B} x {TRAIN_S}) under "
          f"torch.profiler on {card}: wall {wall_ms:.1f} ms, device busy "
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
    phase_build()
    k1_numbers = phase_k1(dev)
    k4_numbers = phase_k4(dev)
    k3_numbers = phase_k3(dev)
    k2_numbers = phase_k2(dev)
    phase_two_layer(dev)
    phase_two_layer_train(dev)
    serve_launches = phase_serve(card)
    train_launches, _ = phase_train(card)
    phase_breakdown(dev, card)

    def launched(*names):
        by = {"serve": sum(serve_launches[n] for n in names),
              "train": sum(train_launches[n] for n in names)}
        return dict(launches=by["serve"] + by["train"], launches_by_path=by)
    kernels = [
        dict(name="K1 matmul", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul.cu",
             replaces="src/repro/kernels/matmul.py:30",
             **launched("K1"), **k1_numbers),
        dict(name="K2 flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:24",
             **launched("K2", "K2 bwd"), **k2_numbers),
        dict(name="K3 rmsnorm", route="cuda",
             source="src/repro_torch/kernels/csrc/rmsnorm.cu",
             replaces="src/repro/kernels/rmsnorm.py:19",
             **launched("K3", "K3 bwd"), **k3_numbers),
        dict(name="K4 paged_flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode.cu",
             replaces="src/repro/kernels/paged_decode.py:72",
             **launched("K4"), **k4_numbers),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_by_path", "fwd_ms", "bwd_ms", "plain_fwd_ms",
             "plain_bwd_ms", "library_fwd_ms", "fwd_bound_ms",
             "bwd_bound_ms")
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
