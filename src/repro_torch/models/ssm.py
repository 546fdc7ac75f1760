"""Mamba2 (state-space duality) mixer: the chunked SSD scan for prefill and
a one-step recurrence for decode.

Port of ``repro.models.ssm``.  Shapes as there: x ``[B, S, D]``; heads
``H = d_inner / headdim``; one group (G = 1) shares B/C.  The prefill scan
goes through ``kernels.ops.ssd`` on the route of ``kernels``: the
hand-written CUDA kernel on ``cuda`` (every call, with or without an initial
state), the plain ``ssd_chunked`` on ``torch``.  Under a gradient (training)
the ``cuda`` route runs ``SsdScanFn``: that kernel forward and the three
backward kernels of ``kernels/csrc/ssd_scan_bwd.cu``, where the reference
takes XLA's autodiff of ``ssd_chunked``; the ``torch`` route is
differentiated by autograd.  Decode is plain PyTorch on every route, as the
reference leaves it to XLA.  The reference's ``shard_activation``
constraint (GSPMD) has no counterpart on one card.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, resolve
from repro_torch.kernels.ssd_scan import ssd_chunked

from .config import ModelConfig
from .layers import _mm, rmsnorm, silu
from .module import spec

__all__ = ["mamba2_specs", "mamba2_forward", "mamba2_decode_step",
           "ssd_chunked", "ssd"]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ModelConfig, layers: int | None = None) -> Dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H = 1, cfg.d_state, cfg.ssm_heads
    convc = di + 2 * G * N
    dt = cfg.param_dtype
    L = (layers,) if layers else ()
    La = ("layers",) if layers else ()
    return {
        "in_proj": spec(L + (d, 2 * di + 2 * G * N + H),
                        La + ("embed", "inner"), dtype=dt),
        "conv_w": spec(L + (cfg.d_conv, convc), La + ("conv", "inner"),
                       dtype=dt, scale=0.5),
        "conv_b": spec(L + (convc,), La + ("inner",), dtype=dt, init="zeros"),
        "A_log": spec(L + (H,), La + (None,), init="zeros"),  # A = -exp(A_log)
        "D": spec(L + (H,), La + (None,), init="ones"),
        "dt_bias": spec(L + (H,), La + (None,), init="zeros"),
        "norm_w": spec(L + (di,), La + ("inner",), dtype=dt, init="ones"),
        "out_proj": spec(L + (di, d), La + ("inner", "embed"), dtype=dt),
    }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b):
    """Depthwise causal conv1d via K shifted adds. x: [B,S,C]; w: [K,C]."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + pad[:, i:i + S, :].float() * w[i].float()
    return (y + b.float()).to(x.dtype)


def ssd(x, dA, Bm, Cm, chunk: int, init_state=None, kernels=None):
    """The scan of one mixer in the model's layout, through ``ops.ssd``.

    x: [B, S, H, P]; dA: [B, S, H]; Bm, Cm: [B, S, 1, N]; init_state:
    [B, H, P, N] or None.  Returns (y [B, S, H, P], state [B, H, P, N]).
    x and dA go in as their [B, H, S, ·] transpose views and y comes back
    as one, so the kernel reads and writes the model's layout in place; the
    state is the kernel's ``[B*H, N, P]``, transposed here."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h0 = (None if init_state is None else
          init_state.float().transpose(-1, -2).reshape(B * H, N, P)
          .contiguous())
    y, h = ops.ssd(x.transpose(1, 2), dA.float().transpose(1, 2),
                   Bm.reshape(B, S, N), Cm.reshape(B, S, N),
                   n_heads_per_group=H, chunk=chunk, h0=h0,
                   use_kernel=resolve(kernels, x.device).use_kernel)
    return y.transpose(1, 2), h.reshape(B, H, N, P).transpose(-1, -2)


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------

def mamba2_forward(p: Dict, x, cfg: ModelConfig, init_state=None,
                   kernels=None):
    """Full-sequence Mamba2 mixer.

    x: [B, S, D] -> (y, final_ssm_state [B,H,P,N], conv_tail) where
    conv_tail holds the last (K-1) *pre-conv* xBC inputs -- the conv cache
    handed to decode."""
    B, S, D = x.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.ssm_heads, cfg.headdim
    cd = cfg.compute_dtype

    zxbcdt = _mm(x, p["in_proj"], cd)
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    conv_tail = xBC[:, -(cfg.d_conv - 1):, :]
    xBC = silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                           # [H]
    dA = dt * A                                                  # [B,S,H]

    xh = xs.reshape(B, S, H, P)
    xd = (xh.float() * dt[..., None]).to(cd)

    y, h_final = ssd(xd, dA, Bm.to(cd).reshape(B, S, 1, N),
                     Cm.to(cd).reshape(B, S, 1, N), cfg.ssd_chunk,
                     init_state, kernels)
    y = y.float() + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di)

    y = (y * F.silu(z.float())).to(cd)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    out = _mm(y, p["out_proj"], cd)
    return out, h_final, conv_tail.to(cd)


def mamba2_decode_step(p: Dict, x, cfg: ModelConfig, ssm_state, conv_state):
    """One-token recurrent step.

    x: [B, 1, D]; ssm_state: [B, H, P, N]; conv_state: [B, K-1, convc].
    Returns (y [B,1,D], ssm_state', conv_state')."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.ssm_heads, cfg.headdim
    cd = cfg.compute_dtype

    zxbcdt = _mm(x, p["in_proj"], cd)[:, 0]
    z, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)

    # conv over (state ++ new input)
    full = torch.cat([conv_state, xBC[:, None, :]], dim=1)       # [B,K,convc]
    conv_out = ((full.float() * p["conv_w"].float()[None]).sum(dim=1)
                + p["conv_b"].float())
    xBC = F.silu(conv_out).to(cd)
    conv_state_new = full[:, 1:]

    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    Bm, Cm = Bm.float(), Cm.float()                              # [B,N]

    dt = F.softplus(dt.float() + p["dt_bias"].float())           # [B,H]
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)                                       # [B,H]

    xh = xs.reshape(B, H, P).float()
    upd = (dt[..., None] * xh)[..., None] * Bm[:, None, None, :]  # [B,H,P,N]
    st = ssm_state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", st, Cm)
    y = y + p["D"].float()[None, :, None] * xh
    y = y.reshape(B, 1, di)

    y = (y * F.silu(z.float())[:, None, :]).to(cd)
    y = rmsnorm(y, p["norm_w"], cfg.norm_eps)
    out = _mm(y, p["out_proj"], cd)
    return out, st.to(ssm_state.dtype), conv_state_new
