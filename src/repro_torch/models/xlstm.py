"""xLSTM blocks (port of ``repro/models/xlstm.py``): the mLSTM
(matrix-memory) and the sLSTM (scalar-memory) block, their recurrences and
their one-token decode branches.

Every projection is the paper's 3-D linear (K1) and every norm goes
through K3.  The recurrences are ``jnp`` in the reference, reaching no
Pallas kernel, and stay plain PyTorch here, in f32 with the reference's
arithmetic: ``torch.matmul``/``torch.einsum`` for the products the
reference computes outside any kernel (the mLSTM's chunk products, the
sLSTM's recurrent ``R`` product) and elementwise work around them.  At one
device the reference's scan island (``shard_map`` gathering the sequence,
slicing the heads) is the identity, so a block runs over all heads.

``mlstm_scan`` is the chunk-parallel form: a Python loop over chunks of Q
steps (Q = 256, shrunk until it divides T).  The reference checkpoints
each chunk (``xlstm.py:121``) and each sLSTM step (``:171``); the port
does not: the block-level remat of ``transformer.run_stack`` recomputes
the whole block in the backward, so a chunk's or a step's intermediates
live only while their own block's backward runs.

Serving decodes one token a step against a per-slot cache
(``mlstm_cache_init``, ``slstm_cache_init``): the mLSTM's f32 (C, n, m)
and the sLSTM's f32 (c, n, h, m), n initialised to ones as in the
reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.linear3d import norm_param, plinear, rmsnorm, weight_param
from ..core.params import Param
from ..core.plan import MULTI_RANK_TODO
from ..core.topology import Dirs, Layout, entry_dirs
from .mamba2 import feat_ax

F32 = torch.float32


# ---------------------------------------------------------------------------
# Recurrences (f32)
# ---------------------------------------------------------------------------
def _mlstm_state0(b, nh, dh, device):
    return (torch.zeros(b, nh, dh, dh, dtype=F32, device=device),
            torch.zeros(b, nh, dh, dtype=F32, device=device),
            torch.full((b, nh), -1e30, dtype=F32, device=device))


def mlstm_step(state, qt, kt, vt, it, ft):
    """One step of the stabilised mLSTM (reference ``xlstm.py:126-141``).
    qt/kt/vt: (b, nh, dh); it/ft: (b, nh), ft the log-forget.  Returns (h
    (b, nh, dh), (C, n, m))."""
    C, n, m = state
    scale = 1.0 / math.sqrt(qt.shape[-1])
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    kt = kt * scale
    C = f_[..., None, None] * C + i_[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", vt, kt)
    n = f_[..., None] * n + i_[..., None] * kt
    num = torch.einsum("bhde,bhe->bhd", C, qt)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, qt).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (C, n, m_new)


def mlstm_scan_seq(q, k, v, ig, fg, state=None):
    """Sequential mLSTM (reference ``xlstm.py:27-58``).  q/k/v: (b, T, nh,
    dh); ig/fg: (b, T, nh).  Returns (h (b, T, nh, dh) f32, (C, n, m))."""
    b, T, nh, dh = q.shape
    if state is None:
        state = _mlstm_state0(b, nh, dh, q.device)
    hs = []
    for t in range(T):
        h, state = mlstm_step(state, q[:, t].to(F32), k[:, t].to(F32),
                              v[:, t].to(F32), ig[:, t].to(F32),
                              fg[:, t].to(F32))
        hs.append(h)
    return torch.stack(hs, dim=1), state


def chunk_len(T: int, chunk: int) -> int:
    """The chunk of ``mlstm_scan``: ``chunk``, shrunk until it divides T."""
    Q = min(chunk, T)
    while T % Q:
        Q -= 1
    return Q


def mlstm_scan(q, k, v, ig, fg, state=None, chunk: int = 256):
    """Chunk-parallel stabilised mLSTM, equal to ``mlstm_scan_seq``
    (reference ``xlstm.py:61-123``).  Within a chunk the stabiliser is m_t
    = b_t + max(cummax_{j<=t}(i_j - b_j), m_carry), b the cumulative
    log-forget; the carried (C, n) is normalised by exp(m_carry); the
    causal mask is applied to the exponent before the exp.  As in the
    reference, the carried C is laid out (k, v), the transpose of
    ``mlstm_step``'s (v, k): no path hands one form's state to the other."""
    b, T, nh, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    Q = chunk_len(T, chunk)
    C, n, m_c = state if state is not None else \
        _mlstm_state0(b, nh, dh, q.device)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=q.device).tril()
    hs = []
    for s in range(0, T, Q):
        qq, vv = q[:, s:s + Q].to(F32), v[:, s:s + Q].to(F32)
        kk = k[:, s:s + Q].to(F32) * scale
        ii, ff = ig[:, s:s + Q].to(F32), fg[:, s:s + Q].to(F32)
        bcum = torch.cumsum(ff, dim=1)                   # (b, Q, nh)
        g = torch.cummax(ii - bcum, dim=1).values
        m_t = bcum + torch.maximum(g, m_c[:, None])
        lw = (bcum[:, :, None] - bcum[:, None] + ii[:, None]) \
            - m_t[:, :, None]                            # (b, t, j, nh)
        lw = torch.where(causal[None, :, :, None], lw, -1e30)
        w = torch.exp(lw).permute(0, 3, 1, 2)            # (b, nh, t, j)
        qk = torch.einsum("bthd,bjhd->bhtj", qq, kk)
        sw = qk * w
        num = torch.einsum("bhtj,bjhn->bthn", sw, vv)
        den = sw.sum(dim=-1).transpose(1, 2)             # (b, t, nh)
        dec = torch.exp(bcum + m_c[:, None] - m_t)       # (b, Q, nh)
        num = num + dec[..., None] * torch.einsum("bthd,bhdn->bthn", qq, C)
        den = den + dec * torch.einsum("bthd,bhd->bth", qq, n)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_t))[..., None])
        m_T = m_t[:, -1]
        ws = torch.exp((bcum[:, -1:] - bcum) + ii - m_T[:, None])
        carry = torch.exp(bcum[:, -1] + m_c - m_T)       # (b, nh)
        C = carry[..., None, None] * C + torch.einsum(
            "bjhd,bjhn->bhdn", ws[..., None] * kk, vv)
        n = carry[..., None] * n + torch.einsum("bjh,bjhd->bhd", ws, kk)
        m_c = m_T
    return torch.cat(hs, dim=1), (C, n, m_c)


def _slstm_cell(pre, c, n, m):
    """The sLSTM's gates and state update (reference ``xlstm.py:162-167``)
    from the pre-activations ``pre`` = (z, i, f, o), each (b, nh, dh)."""
    zt, it, ft, ot = pre
    m_new = torch.maximum(ft + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c = f_ * c + i_ * torch.tanh(zt)
    n = f_ * n + i_
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
    return h, c, n, m_new


def _recurrent(Rm, h):
    """rec[g, b, h, d] = sum_e R[g, h, d, e] h[b, h, e] as one batched
    product: Rm is R laid out (nh, 4 dh, dh)."""
    nh, dh = h.shape[1], h.shape[2]
    out = torch.bmm(Rm, h.permute(1, 2, 0))              # (nh, 4 dh, b)
    return out.view(nh, 4, dh, -1).permute(1, 3, 0, 2)   # (4, b, nh, dh)


def _r_matrix(R):
    nh, dh = R.shape[1], R.shape[2]
    return R.to(F32).permute(1, 0, 2, 3).reshape(nh, 4 * dh, dh)


def slstm_scan(zg, ig, fg, og, R, state=None):
    """sLSTM over a sequence (reference ``xlstm.py:144-172``): the gates'
    pre-activations from the input path, (b, T, nh, dh) each, plus the
    block-diagonal recurrent product with R (4, nh, dh, dh) of the
    previous h.  Returns (h (b, T, nh, dh) f32, (c, n, h, m))."""
    b, T, nh, dh = zg.shape
    if state is None:
        z = torch.zeros(b, nh, dh, dtype=F32, device=zg.device)
        state = (z, torch.ones_like(z), z, z)
    c, n, h, m = state
    Rm = _r_matrix(R)
    xs = torch.stack([a.to(F32) for a in (zg, ig, fg, og)], dim=0)
    xs = xs.unbind(2)                                    # T x (4, b, nh, dh)
    hs = []
    for t in range(T):
        pre = (xs[t] + _recurrent(Rm, h)).unbind(0)
        h, c, n, m = _slstm_cell(pre, c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)


def slstm_step(state, zt, it, ft, ot, R):
    """One sLSTM step (reference ``xlstm.py:175-187``); returns (h, (c, n,
    h, m))."""
    c, n, h, m = state
    rec = _recurrent(_r_matrix(R), h)
    pre = tuple(a.to(F32) + r for a, r in zip((zt, it, ft, ot),
                                              rec.unbind(0)))
    h, c, n, m = _slstm_cell(pre, c, n, m)
    return h, (c, n, h, m)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def mlstm_dims(cfg: ModelConfig):
    """(d_in, heads, head dim) of the mLSTM: projection factor 2 (reference
    ``xlstm.py:197-200``)."""
    d_in = 2 * cfg.d_model
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def mlstm_params(cfg: ModelConfig, layout: Layout = None):
    """One mLSTM block (reference ``xlstm.py:203-215``) with the specs of
    ``layout``'s strategy (None: one device): ``ln`` and ``out_ln`` are
    leaves; ``w_if`` gives the input and forget gates' (2 nh)
    pre-activations; ``out_ln`` splits like the projections' features."""
    d = cfg.d_model
    d_in, nh, _ = mlstm_dims(cfg)
    dirs = entry_dirs()
    st = "3d" if layout is None else layout.strategy

    def first(f, shard_f=True):
        return weight_param(dirs, d, f, shard_f=shard_f, strategy=st)
    return {"ln": norm_param(dirs, d, strategy=st),
            "w_q": first(d_in), "w_k": first(d_in),
            "w_v": first(d_in), "w_z": first(d_in),
            "w_if": first(2 * nh, shard_f=False),
            "out_ln": Param((d_in,), init="ones",
                            spec=(feat_ax(st, dirs),)),
            "w_out": weight_param(dirs.swap(), d_in, d, kind="second",
                                  strategy=st)}


def mlstm_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p, *,
                decode: bool = False, cache=None):
    """Pre-norm mLSTM block with its residual (reference ``xlstm.py:218-283``).
    x: (b, T, d), or (B, 1, d) with ``decode`` and one layer's ``cache``
    leaves.  Returns (x + out, the new cache leaves or None)."""
    if layout.n_devices != 1:
        raise NotImplementedError(MULTI_RANK_TODO)
    d_in, nh, dh = mlstm_dims(cfg)
    h = rmsnorm(x, p["ln"])
    q, d2 = plinear(layout, dirs, h, p["w_q"], kind="first", decode=decode)
    k, _ = plinear(layout, dirs, h, p["w_k"], kind="first", decode=decode)
    v, _ = plinear(layout, dirs, h, p["w_v"], kind="first", decode=decode)
    zg, _ = plinear(layout, dirs, h, p["w_z"], kind="first", decode=decode)
    gif, _ = plinear(layout, dirs, h, p["w_if"], kind="first", shard_f=False,
                     decode=decode)
    b, T = x.shape[0], x.shape[1]
    if decode:
        y, st = mlstm_step((cache["C"], cache["n"], cache["m"]),
                           q.reshape(b, nh, dh).to(F32),
                           k.reshape(b, nh, dh).to(F32),
                           v.reshape(b, nh, dh).to(F32),
                           gif[:, 0, :nh].to(F32),
                           F.logsigmoid(gif[:, 0, nh:].to(F32)))
        new_cache = dict(zip(("C", "n", "m"), st))
    else:
        y, _ = mlstm_scan(q.reshape(b, T, nh, dh), k.reshape(b, T, nh, dh),
                          v.reshape(b, T, nh, dh), gif[..., :nh],
                          F.logsigmoid(gif[..., nh:].to(F32)))
        new_cache = None
    y = y.reshape(b, T, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(zg.to(F32)).to(y.dtype), p["out_ln"])
    out, _ = plinear(layout, d2, y, p["w_out"], kind="second", decode=decode)
    return x + out, new_cache


def slstm_params(cfg: ModelConfig, layout: Layout = None):
    """One sLSTM block (reference ``xlstm.py:286-297``) with the specs of
    ``layout``'s strategy (None: one device): ``w_gates`` gives the [z,
    i, f, o] pre-activations, R the recurrent block-diagonal weights,
    fan-in over its last axis at scale 0.3, replicated."""
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    dirs = entry_dirs()
    st = "3d" if layout is None else layout.strategy
    return {"ln": norm_param(dirs, d, strategy=st),
            "w_gates": weight_param(dirs, d, 4 * d, shard_f=False,
                                    strategy=st),
            "R": Param((4, nh, dh, dh), fan_axis=-1, scale=0.3,
                       spec=(None, None, None, None)),
            "w_out": weight_param(dirs.swap(), d, d, kind="second",
                                  strategy=st)}


def slstm_apply(layout: Layout, cfg: ModelConfig, dirs: Dirs, x, p, *,
                decode: bool = False, cache=None):
    """Pre-norm sLSTM block with its residual (reference ``xlstm.py:300-349``);
    arguments and result as ``mlstm_apply``."""
    if layout.n_devices != 1:
        raise NotImplementedError(MULTI_RANK_TODO)
    d, nh = cfg.d_model, cfg.n_heads
    dh = d // nh
    h = rmsnorm(x, p["ln"])
    g, d2 = plinear(layout, dirs, h, p["w_gates"], kind="first",
                    shard_f=False, decode=decode)
    b, T = x.shape[0], x.shape[1]
    gt = g.reshape(b, T, 4, nh, dh)
    if decode:
        y, st = slstm_step(tuple(cache[k_] for k_ in ("c", "n", "h", "m")),
                           *gt[:, 0].unbind(1), p["R"])
        new_cache = dict(zip(("c", "n", "h", "m"), st))
    else:
        y, _ = slstm_scan(*gt.unbind(2), p["R"])
        new_cache = None
    y = y.reshape(b, T, d).to(x.dtype)
    out, _ = plinear(layout, d2, y, p["w_out"], kind="second", decode=decode)
    return x + out, new_cache


def mlstm_cache_init(cfg: ModelConfig, batch: int):
    """Abstract decode cache of one mLSTM layer, zeroed, f32 (reference
    ``xlstm.py:352-363``): C (B, nh, dh, dh), n (B, nh, dh), m (B, nh)."""
    _, nh, dh = mlstm_dims(cfg)
    return {"C": Param((batch, nh, dh, dh), init="zeros", dtype=F32),
            "n": Param((batch, nh, dh), init="zeros", dtype=F32),
            "m": Param((batch, nh), init="zeros", dtype=F32)}


def slstm_cache_init(cfg: ModelConfig, batch: int):
    """Abstract decode cache of one sLSTM layer, f32 (reference
    ``xlstm.py:366-372``): c, n, h, m (B, nh, dh), n initialised to ones."""
    nh = cfg.n_heads
    shape = (batch, nh, cfg.d_model // nh)
    return {"c": Param(shape, init="zeros", dtype=F32),
            "n": Param(shape, init="ones", dtype=F32),
            "h": Param(shape, init="zeros", dtype=F32),
            "m": Param(shape, init="zeros", dtype=F32)}
