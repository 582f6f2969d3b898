"""Per-step train telemetry (port of a subset of
``repro/obs/telemetry.py:120-230``): step time with the warm-up steps
split off, tokens/s, model FLOPs utilisation (MFU), the device memory
high-water mark and a non-finite sentinel.

``record`` is a sync point: it waits for the step's device work (the loss
is copied to the host) so that the step time covers the device, not the
launches.  The MFU numerator is ``registry.train_flops_per_token``; the
denominator is ``peak_flops``, which the caller passes (``--peak-flops``)
or ``peak_flops_for`` reads from the card's name: the dense bf16
tensor-core peak of the card's data sheet.  An unknown card with no peak
given gets no MFU rather than a wrong one.  A CPU run reports no device
memory.
"""
from __future__ import annotations

import json
import math
import time
from typing import List, Optional

import torch

from ..models.registry import train_flops_per_token

# Dense bf16 tensor-core peaks from NVIDIA's data sheets (no sparsity), by
# a substring of torch.cuda.get_device_name; the first match wins.
DENSE_BF16_PEAK = (("H100 PCIe", 756e12), ("H100 NVL", 835e12),
                   ("H100", 989e12), ("H200", 989e12), ("H800", 989e12))


def peak_flops_for(device) -> Optional[float]:
    """The dense bf16 peak of the card ``device`` names, or None."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in DENSE_BF16_PEAK:
        if key in name:
            return peak
    return None


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def first_nonfinite_path(tree) -> Optional[str]:
    """Path of the first leaf holding a NaN or inf, e.g.
    ``"['stack']['dense']['attn']['wq']"``; None when every leaf is finite.
    Fetches each leaf's verdict, so call it once something went wrong."""
    for path, leaf in _paths(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            return path
    return None


class TrainTelemetry:
    warmup_steps = 1       # the first step is reported apart

    def __init__(self, cfg, *, global_batch: int, seq_len: int, device,
                 peak_flops: Optional[float] = None, tracer=None):
        from .trace import NULL
        self.global_batch, self.seq_len = global_batch, seq_len
        self.device = torch.device(device)
        self.flops_per_step = (train_flops_per_token(cfg, seq_len)
                               * global_batch * seq_len)
        self.peak = peak_flops
        self._last: Optional[float] = None
        self.tracer = tracer if tracer is not None else NULL
        self.records: List[dict] = []
        self.nonfinite: Optional[dict] = None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def start(self):
        """Stamp the clock before the first step (after set-up)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._last = time.perf_counter()

    def record(self, step: int, metrics: dict) -> dict:
        """Close out one step: wait for its device work, stamp the step
        time, fetch the scalar metrics, run the finite check."""
        rec = {"step": int(step), "warmup": len(self.records) <
               self.warmup_steps}
        for k, v in metrics.items():       # .item() waits for the device
            if isinstance(v, torch.Tensor) and v.dim() == 0:
                rec[k] = v.item()
            elif isinstance(v, (int, float)):
                rec[k] = float(v)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        rec["t_step"] = (now - self._last) if self._last is not None else 0.0
        self._last = now
        if rec["t_step"] > 0:
            rec["tokens_per_s"] = self.global_batch * self.seq_len \
                / rec["t_step"]
            if self.peak:
                rec["mfu"] = self.flops_per_step / rec["t_step"] / self.peak
        loss = rec.get("loss")
        if self.nonfinite is None and loss is not None \
                and not math.isfinite(loss):
            self.nonfinite = {"step": int(step), "loss": loss}
        self.records.append(rec)
        if self.tracer.enabled:
            for k in ("loss", "gnorm", "t_step"):
                if k in rec:
                    self.tracer.counter(k, rec[k], track="telemetry")
        return rec

    def blame(self, params) -> str:
        """The first non-finite parameter leaf, or 'all finite'."""
        path = first_nonfinite_path(params)
        return f"params: {path}" if path else "params: all finite"

    def summary(self) -> dict:
        warm = [r["t_step"] for r in self.records if r["warmup"]]
        steady = [r["t_step"] for r in self.records if not r["warmup"]]
        mean = lambda xs: sum(xs) / len(xs) if xs else 0.0  # noqa: E731
        t = mean(steady)
        mem = (torch.cuda.max_memory_allocated(self.device)
               if self.device.type == "cuda" else None)
        return {
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "steps": len(self.records),
            "warmup_steps": self.warmup_steps,
            "t_step_warmup_s": mean(warm),
            "t_step_s": t,
            "tokens_per_s": self.global_batch * self.seq_len / t if t else 0.0,
            "flops_per_step": self.flops_per_step,
            "peak_flops": self.peak,
            "mfu": (self.flops_per_step / t / self.peak
                    if t and self.peak else None),
            "mem_peak_bytes": mem,
            "nonfinite": self.nonfinite,
            "series": {k: [r.get(k) for r in self.records]
                       for k in ("loss", "gnorm", "t_step")},
        }

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2, sort_keys=True)

    def format_summary(self) -> str:
        s = self.summary()
        mfu = (f"MFU {s['mfu'] * 100:.2f}% of {s['peak_flops']:.3g} FLOP/s"
               if s["mfu"] is not None else "MFU not reported (no peak)")
        mem = (f"{s['mem_peak_bytes'] / 2 ** 30:.2f} GiB"
               if s["mem_peak_bytes"] is not None else "not measured")
        lines = [
            f"telemetry: {s['steps']} steps on {s['device']} (warmup "
            f"{s['warmup_steps']}: {s['t_step_warmup_s']:.3f}s, steady "
            f"{s['t_step_s']:.3f}s/step)",
            f"  {s['tokens_per_s']:.0f} tok/s   {mfu}",
            f"  device memory high-water mark {mem}",
        ]
        if s["nonfinite"] is not None:
            lines.append(f"  NON-FINITE loss at step {s['nonfinite']['step']}")
        return "\n".join(lines)
