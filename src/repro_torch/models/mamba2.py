"""Mamba2 (SSD) block, the training path (port of the train/prefill branch
of ``repro/models/mamba2.py``).

The four input projections and the output projection are the paper's 3-D
linears (K1); the norms ``ln`` and ``gate_ln`` go through K3; the SSD scan
is K5 (``kernels/ssd_scan.py``), forward and backward.  The elementwise
work around the scan stays in PyTorch with autograd, with the reference's
arithmetic and casts: softplus(dt + dt_bias), a = -exp(A_log), the
per-step log-decay dt * a, xbar = x * dt, the D skip.  At one device the
reference's scan island (``shard_map`` gathering the sequence and slicing
the heads) is the identity, so the block runs over all heads here.

``ssd_step``, ``MambaCache`` and the decode branch belong to the serving
slice of the state families and are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.linear3d import plinear, rmsnorm
from ..core.params import Param
from ..core.plan import MULTI_RANK_TODO
from ..core.topology import Dirs, Layout
from ..kernels.ssd_scan import ssd_scan

F32 = torch.float32
MAMBA_HEAD_DIM = 64


def mamba_dims(cfg: ModelConfig):
    """(d_inner, SSM heads, groups, d_state) of a Mamba2 block (reference
    ``mamba2.py:127-131``; heads are 64 wide)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // MAMBA_HEAD_DIM, s.n_groups, s.d_state


def mamba_block_params(cfg: ModelConfig):
    """One Mamba2 block (reference ``mamba2.py:134-153``): ``ln`` and
    ``gate_ln`` are leaves, not ``{"g": ...}`` dicts, and ``dt_bias``,
    ``A_log`` and ``D`` are float32 whatever the model's dtype."""
    d = cfg.d_model
    d_in, nh, G, N = mamba_dims(cfg)
    K = cfg.ssm.d_conv
    return {
        "ln": Param((d,), init="ones"),
        "w_x": Param((d, d_in)), "w_z": Param((d, d_in)),
        "w_bc": Param((d, 2 * G * N)), "w_dt": Param((d, nh)),
        "dt_bias": Param((nh,), init="zeros", dtype=F32),
        "A_log": Param((nh,), init="zeros", dtype=F32),
        "D": Param((nh,), init="ones", dtype=F32),
        "conv_x": Param((K, d_in)), "conv_x_b": Param((d_in,), init="zeros"),
        "conv_bc": Param((K, 2 * G * N)),
        "conv_bc_b": Param((2 * G * N,), init="zeros"),
        "gate_ln": Param((d_in,), init="ones"),
        "w_out": Param((d_in, d)),
    }


def ssd_chunked(x, dt, A_log, B, C, D, chunk: int):
    """The SSD over a whole sequence through K5 (reference
    ``mamba2.py:33-89``).  x: (b, T, nh, dh); dt: (b, T, nh) before the
    softplus; A_log, D: (nh,); B, C: (b, T, G, N).  Returns y (b, T, nh,
    dh) in f32; the final state, which training discards, is not returned.
    """
    dtf = F.softplus(dt.to(F32))                          # (b, T, nh)
    la = dtf * -torch.exp(A_log.to(F32))
    xbar = x.to(F32) * dtf[..., None]
    y = ssd_scan(xbar.contiguous(), la.contiguous(), B.contiguous(),
                 C.contiguous(), chunk)
    return y + x.to(F32) * D.to(F32)[None, None, :, None]


def causal_conv(x, w, b):
    """Depthwise causal conv with its SiLU, in f32 (reference
    ``mamba2.py:110-115``).  x: (b, T, C); w: (K, C); b: (C,)."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x.to(F32), (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + T] * w[i].to(F32) for i in range(K))
    return F.silu(y + b.to(F32))


def _gspmd_causal_conv(x, w, b):
    """The B/C conv (reference ``mamba2.py:259-265``): f32, no activation,
    rounded back to x's dtype."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x.to(F32), (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + T] * w[i].to(F32) for i in range(K))
    return (y + b.to(F32)).to(x.dtype)


def mamba_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p):
    """Pre-norm Mamba2 block with its residual over a whole sequence (the
    train/prefill branch of reference ``mamba2.py:171-256``).  x: (b, T, d)
    in the entry layout; returns the block's output in the same layout."""
    if layout.n_devices != 1:
        raise NotImplementedError(MULTI_RANK_TODO)
    d_in, nh, G, N = mamba_dims(cfg)
    h = rmsnorm(x, p["ln"])
    xc, d2 = plinear(layout, dirs, h, p["w_x"], kind="first")
    zg, _ = plinear(layout, dirs, h, p["w_z"], kind="first")
    bc, _ = plinear(layout, dirs, h, p["w_bc"], kind="first", shard_f=False)
    dt, _ = plinear(layout, dirs, h, p["w_dt"], kind="first", shard_f=False)

    bc = _gspmd_causal_conv(bc, p["conv_bc"], p["conv_bc_b"])
    dt = dt.to(F32) + p["dt_bias"].to(F32)
    xf = causal_conv(xc, p["conv_x"], p["conv_x_b"])      # (b, T, d_in) f32
    bcf = F.silu(bc.to(F32))            # rounded to bc's dtype before SiLU
    b, T = xf.shape[0], xf.shape[1]
    Bt = bcf[..., :G * N].reshape(b, T, G, N)
    Ct = bcf[..., G * N:].reshape(b, T, G, N)
    y = ssd_chunked(xf.reshape(b, T, nh, MAMBA_HEAD_DIM), dt, p["A_log"], Bt,
                    Ct, p["D"], cfg.ssm.chunk)
    y = y.reshape(b, T, d_in).to(xc.dtype)

    y = rmsnorm(y * F.silu(zg.to(F32)).to(y.dtype), p["gate_ln"])
    out, _ = plinear(layout, d2, y, p["w_out"], kind="second")
    return x + out
