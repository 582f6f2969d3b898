"""Mamba2 (SSD) block (port of ``repro/models/mamba2.py``): the
train/prefill branch and the one-token decode branch.

The four input projections and the output projection are the paper's 3-D
linears (K1); the norms ``ln`` and ``gate_ln`` go through K3; the SSD scan
is K5 (``kernels/ssd_scan.py``), forward and backward.  The elementwise
work around the scan stays in PyTorch with autograd, with the reference's
arithmetic and casts: softplus(dt + dt_bias), a = -exp(A_log), the
per-step log-decay dt * a, xbar = x * dt, the D skip.  At one device the
reference's scan island (``shard_map`` gathering the sequence and slicing
the heads) is the identity, so the block runs over all heads here.

Serving decodes one token a step (``mamba_decode``, the reference's
``decode=True`` branch) against a per-slot cache (``mamba_cache_init``):
the f32 SSM state and the two conv tails.  ``ssd_step`` is the one-step recurrence,
elementwise work and two small products per slot in f32, plain PyTorch on
the card too (it reaches no kernel in the reference either); the norms
(K3) and the five linears (K1, whose decode route takes M = batch) are
the training path's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.linear3d import norm_param, plinear, rmsnorm, weight_param
from ..core.params import Param
from ..core.plan import MULTI_RANK_TODO
from ..core.topology import Dirs, Layout, entry_dirs
from ..kernels.ssd_scan import ssd_scan

F32 = torch.float32
MAMBA_HEAD_DIM = 64


def mamba_dims(cfg: ModelConfig):
    """(d_inner, SSM heads, groups, d_state) of a Mamba2 block (reference
    ``mamba2.py:127-131``; heads are 64 wide)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // MAMBA_HEAD_DIM, s.n_groups, s.d_state


def feat_ax(strategy: str, dirs: Dirs) -> str:
    """The axis that splits a projection's output features (reference
    ``mamba2.py:_feat_ax``): in_ax at 3d, else 'z'."""
    return dirs.in_ax if strategy == "3d" else "z"


def mamba_block_params(cfg: ModelConfig, layout: Layout = None):
    """One Mamba2 block (reference ``mamba2.py:134-153``) with the specs
    of ``layout``'s strategy (None: one device): ``ln`` and ``gate_ln``
    are leaves, not ``{"g": ...}`` dicts, and ``dt_bias``, ``A_log`` and
    ``D`` are float32 whatever the model's dtype.  The projections are
    the paper's linears; the conv channels and ``gate_ln`` split like the
    projections' features (``feat_ax``)."""
    d = cfg.d_model
    d_in, nh, G, N = mamba_dims(cfg)
    K = cfg.ssm.d_conv
    dirs = entry_dirs()
    st = "3d" if layout is None else layout.strategy
    fa = feat_ax(st, dirs)
    return {
        "ln": norm_param(dirs, d, strategy=st),
        "w_x": weight_param(dirs, d, d_in, strategy=st),
        "w_z": weight_param(dirs, d, d_in, strategy=st),
        "w_bc": weight_param(dirs, d, 2 * G * N, shard_f=False, strategy=st),
        "w_dt": weight_param(dirs, d, nh, shard_f=False, strategy=st),
        "dt_bias": Param((nh,), init="zeros", dtype=F32, spec=(None,)),
        "A_log": Param((nh,), init="zeros", dtype=F32, spec=(None,)),
        "D": Param((nh,), init="ones", dtype=F32, spec=(None,)),
        "conv_x": Param((K, d_in), spec=(None, fa)),
        "conv_x_b": Param((d_in,), init="zeros", spec=(fa,)),
        "conv_bc": Param((K, 2 * G * N), spec=(None, None)),
        "conv_bc_b": Param((2 * G * N,), init="zeros", spec=(None,)),
        "gate_ln": Param((d_in,), init="ones", spec=(fa,)),
        "w_out": weight_param(dirs.swap(), d_in, d, kind="second",
                              strategy=st),
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


def ssd_step(state, x_t, dt_t, A_log, B_t, C_t, D):
    """One decode step of the SSD in f32 (reference ``mamba2.py:92-107``):
    decay = exp(softplus(dt) * -exp(A_log)), the rank-1 state update
    state * decay + (x * dt) B^T, the C readout and the D skip.
    state: (b, nh, dh, N); x_t: (b, nh, dh); dt_t: (b, nh); B_t, C_t: (b,
    G, N).  Returns (y (b, nh, dh), new state), both f32."""
    nh = state.shape[1]
    rep = nh // B_t.shape[1]
    a = -torch.exp(A_log.to(F32))
    dtf = F.softplus(dt_t.to(F32))                        # (b, nh)
    decay = torch.exp(dtf * a)
    Bh = B_t.to(F32).repeat_interleave(rep, dim=1)        # (b, nh, N)
    Ch = C_t.to(F32).repeat_interleave(rep, dim=1)
    xbar = x_t.to(F32) * dtf[..., None]                   # (b, nh, dh)
    new = (state.to(F32) * decay[..., None, None]
           + xbar[..., :, None] * Bh[:, :, None, :])
    y = torch.einsum("bhdn,bhn->bhd", new, Ch) \
        + x_t.to(F32) * D.to(F32)[None, :, None]
    return y, new


def mamba_cache_init(cfg: ModelConfig, batch: int):
    """Abstract decode cache of one Mamba2 layer, zeroed, f32 (reference
    ``MambaCache`` and ``mamba_cache_init``, ``mamba2.py:121``, ``:268``):
    "state" (B, nh, 64, N), "conv" (B, K - 1, d_inner), the x channel's
    conv tail, and "conv_bc" (B, K - 1, 2 G N)."""
    d_in, nh, G, N = mamba_dims(cfg)
    K = cfg.ssm.d_conv
    return {"state": Param((batch, nh, MAMBA_HEAD_DIM, N), init="zeros",
                           dtype=F32),
            "conv": Param((batch, K - 1, d_in), init="zeros", dtype=F32),
            "conv_bc": Param((batch, K - 1, 2 * G * N), init="zeros",
                             dtype=F32)}


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


def mamba_decode(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p, cache):
    """One decode token through a pre-norm Mamba2 block with its residual
    (the ``decode=True`` branch of reference ``mamba2.py:189-204``).
    x: (B, 1, d); cache: one layer's ``mamba_cache_init`` leaves.  The conv runs
    over [tail, new] with its SiLU, dt gets dt_bias, ``ssd_step`` advances
    the state, and the tails shift by one.  Returns (x + out, the new
    cache leaves)."""
    if layout.n_devices != 1:
        raise NotImplementedError(MULTI_RANK_TODO)
    d_in, nh, G, N = mamba_dims(cfg)
    b = x.shape[0]
    h = rmsnorm(x, p["ln"])
    xc, d2 = plinear(layout, dirs, h, p["w_x"], kind="first", decode=True)
    zg, _ = plinear(layout, dirs, h, p["w_z"], kind="first", decode=True)
    bc, _ = plinear(layout, dirs, h, p["w_bc"], kind="first", shard_f=False,
                    decode=True)
    dt, _ = plinear(layout, dirs, h, p["w_dt"], kind="first", shard_f=False,
                    decode=True)
    conv_in = torch.cat([cache["conv"], xc.to(F32)], dim=1)  # (B, K, d_in)
    x_t = F.silu((conv_in * p["conv_x"].to(F32)[None]).sum(dim=1)
                 + p["conv_x_b"].to(F32))
    conv_bc_in = torch.cat([cache["conv_bc"], bc.to(F32)], dim=1)
    bc_t = F.silu((conv_bc_in * p["conv_bc"].to(F32)[None]).sum(dim=1)
                  + p["conv_bc_b"].to(F32))
    B_t = bc_t[:, :G * N].reshape(b, G, N)
    C_t = bc_t[:, G * N:].reshape(b, G, N)
    dt_t = dt[:, 0].to(F32) + p["dt_bias"].to(F32)
    y, state = ssd_step(cache["state"], x_t.reshape(b, nh, MAMBA_HEAD_DIM),
                        dt_t, p["A_log"], B_t, C_t, p["D"])
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(zg.to(F32)).to(y.dtype), p["gate_ln"])
    out, _ = plinear(layout, d2, y, p["w_out"], kind="second", decode=True)
    return x + out, {"state": state, "conv": conv_in[:, 1:],
                     "conv_bc": conv_bc_in[:, 1:]}
