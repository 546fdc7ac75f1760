"""ssd_scan: the Mamba2 SSD chunked scan.

Port of ``repro.kernels.ssd_scan.ssd_scan_pallas``, in its folded layout:
x ``[BH, S, P]``, dA ``[BH, S]``, B/C ``[BH // H, S, N]`` shared by the H
heads of a group; it returns (y ``[BH, S, P]``, h ``[BH, N, P]``).  It also
takes x and dA as the ``[G, H, S, P]`` / ``[G, H, S]`` transpose views of
the model's ``[G, S, H, P]`` / ``[G, S, H]`` and then returns y as such a
view, so the model's layout is read and written in place: the kernel
indexes by the strides it is given.  The CUDA kernels
(``csrc/ssd_scan.cu``), chosen by a fixed table (:func:`ssd_kernel`):
bf16 at P = 64 with N = 64 or 128 in chunks of 128 rows on the Hopper
kernel (a block a chunk, the chunks of a batch*head a thread block
cluster passing the state on through distributed shared memory, wgmma
products on TMA tiles); the other bf16 shapes on the mma.sync kernel and
float32 on the FMA kernel, both a block per batch*head walking the chunks
in order with the state on chip.  Beyond the Pallas kernel it takes an
initial state ``h0`` (or None) and any S: the tail chunk is masked
in-kernel as the reference's zero padding would leave it.

Its plain version, :func:`ssd_plain`, folds the layout onto
:func:`ssd_chunked`, the port of the reference model's
``models/ssm.py:ssd_chunked`` (model layout ``[B, S, H, P]``, intra-chunk
products plus a linear scan over chunks); it serves CPU tensors and the
``torch`` route.

The gradient: the reference has no Pallas backward; it trains through
XLA's autodiff of ``ssd_chunked``.  Here three CUDA kernels
(``csrc/ssd_scan_bwd.cu``) compute it from the forward's inputs and dy:
``ssd_scan_bwd_states`` (each chunk's end state from a zero start and
the chunk's C-weighted dy), ``ssd_scan_bwd_scan`` (the states entering
the chunks and the state gradients leaving them, two scans over the
chunks) and ``ssd_scan_bwd_grads`` (dx, dA, and dB, dC summed over a
group's heads).  The states and grads kernels take the forward's table
(:func:`ssd_bwd_kernel`): Hopper forms (wgmma on TMA tiles; the grads
kernel a cluster of a group's heads a (group, chunk), dB and dC summed on
chip) at P = 64 with N = 64 or 128 in chunks of 128 rows, mma.sync forms
for the other bf16 shapes, FMA forms in float32.  Where the Hopper forms
run and a batch*head has at most ``SSD_BWD_FUSED_CHUNKS`` chunks
(:func:`ssd_bwd_fused`: every training shape of the repo), the states and
the scan are one launch, ``ssd_scan_bwd_states_scan`` (a cluster of a
batch*head's chunks, the scans through distributed shared memory: st and
U never reach device memory).  :class:`SsdScanFn` binds them to autograd;
the plain versions (:func:`ssd_bwd_states_plain`,
:func:`ssd_bwd_scan_plain`, :func:`ssd_bwd_grads_plain`, chained by
:func:`ssd_bwd_plain`; :func:`ssd_bwd_states_scan_plain` the first two)
write the same formulas out in plain PyTorch (not by autograd) and serve
CPU tensors and the card's checks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import SMEM_LIMIT, check_input, launch, library, stream_of

__all__ = ["SsdScanFn", "ssd_bwd", "ssd_bwd_cuda", "ssd_bwd_fused",
           "ssd_bwd_grads_cuda", "ssd_bwd_grads_plain", "ssd_bwd_kernel",
           "ssd_bwd_plain", "ssd_bwd_scan_cuda", "ssd_bwd_scan_plain",
           "ssd_bwd_smem_bytes", "ssd_bwd_states_cuda",
           "ssd_bwd_states_plain", "ssd_bwd_states_scan_clusters",
           "ssd_bwd_states_scan_cuda", "ssd_bwd_states_scan_plain",
           "ssd_chunked", "ssd_cuda", "ssd_kernel", "ssd_plain", "ssd_scan",
           "ssd_smem_bytes"]

NEG_INF = -1.0e30
SSD_STRIP = 64          # the float32 kernel's strip of [M | C] rows
_DTYPES = (torch.float32, torch.bfloat16)
# the bf16 (P, N) of the Hopper kernel (ssd_scan_wgmma_kernel), zamba2-2.7b's
# and mamba2-130m's, and its chunk; the C entry's kernel codes
SSD_WGMMA_SHAPES = ((64, 64), (64, 128))
SSD_WGMMA_CHUNK = 128
_KIND = {"fma": 0, "mma": 1, "wgmma": 2}


def _segsum(a):
    """a: [..., Q] log-decays -> [..., Q, Q] cumulative segment sums,
    -1e30 above the diagonal."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]   # sum_{k=j+1..i} a_k
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, NEG_INF)


def ssd_chunked(x, dA, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan (model layout).

    x: [B, S, H, P] (already multiplied by dt); dA: [B, S, H] (log decay,
    negative); Bm, Cm: [B, S, G, N]; init_state: [B, H, P, N] or None.
    Returns (y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32).
    """
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    HG = H // G
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        # zero-pad to a chunk multiple: padded x=0 contributes nothing to the
        # states and padded dA=0 (decay 1) leaves the recurrence unchanged
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    xg = x.reshape(B, nc, Q, G, HG, P).float()
    ac = dA.float().reshape(B, nc, Q, H).permute(0, 3, 1, 2)     # [B,H,nc,Q]
    bc = Bm.reshape(B, nc, Q, G, N).float()
    cc = Cm.reshape(B, nc, Q, G, N).float()
    a_cum = torch.cumsum(ac, dim=-1)                             # [B,H,nc,Q]

    # (1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(ac)).reshape(B, G, HG, nc, Q, Q)
    scores = torch.einsum("bcqgn,bcsgn->bgcqs", cc, bc)         # [B,G,nc,Q,Q]
    y_diag = torch.einsum("bgcqs,bghcqs,bcsghp->bcqghp", scores, Lmat, xg)

    # (2) per-chunk end states
    ds = torch.exp(a_cum[..., -1:] - a_cum).reshape(B, G, HG, nc, Q)
    states = torch.einsum("bcqgn,bghcq,bcqghp->bcghpn", bc, ds, xg)

    # (3) inter-chunk recurrence (linear scan over chunks)
    chunk_decay = torch.exp(a_cum[..., -1]).reshape(B, G, HG, nc)
    h = (torch.zeros((B, G, HG, P, N), dtype=torch.float32, device=x.device)
         if init_state is None
         else init_state.float().reshape(B, G, HG, P, N))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[..., c, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                          # [B,nc,G,HG,P,N]

    # (4) off-diagonal contribution
    sd_out = torch.exp(a_cum).reshape(B, G, HG, nc, Q)
    y_off = torch.einsum("bcqgn,bcghpn,bghcq->bcqghp", cc, h_prev, sd_out)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y[:, :S0].to(x.dtype), h.reshape(B, H, P, N)


def _unfold(x, dA, H):
    """Views of x [BH, S, P] or [G, H, S, P] and dA [BH, S] or [G, H, S]
    as [G, H, S, P] and [G, H, S] (no copy)."""
    if x.dim() == 3:
        x = x.unflatten(0, (x.shape[0] // H, H))
    if dA.dim() == 2:
        dA = dA.unflatten(0, (dA.shape[0] // H, H))
    return x, dA


def ssd_plain(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
              h0=None):
    """Plain PyTorch version of :func:`ssd_cuda` (same arguments, either
    layout): unfolded onto :func:`ssd_chunked`.  y comes back in x's
    shape."""
    H = n_heads_per_group
    x4, a4 = _unfold(x, dA, H)
    Bg, _, S, P = x4.shape
    N = Bm.shape[-1]
    init = None if h0 is None else h0.reshape(Bg, H, N, P).transpose(-1, -2)
    y, h = ssd_chunked(x4.transpose(1, 2), a4.transpose(1, 2),
                       Bm[:, :, None], Cm[:, :, None], chunk, init)
    return (y.transpose(1, 2).reshape(x.shape),
            h.transpose(-1, -2).reshape(Bg * H, N, P))


# ---------------------------------------------------------------------------
# the gradient, in plain PyTorch: the backward kernels' formulas
# ---------------------------------------------------------------------------

def _chunk_rows(t, Q: int, nc: int):
    """[R, S, ...] -> float32 [R, nc, Q, ...], zero rows past S."""
    pad = nc * Q - t.shape[1]
    t = t.float()
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], nc, Q, *t.shape[2:])


def _bwd_operands(x, dA, Bm, Cm, dy, H: int, chunk: int):
    """The plain backward's operands, float32 rows of each batch*head in
    chunks, zero past S: x, dy [BH, nc, Q, P], the chunk cumsum a
    [BH, nc, Q], B and C [BH, nc, Q, N] (a group's rows for each of its
    H heads); and (G, S, Q, nc)."""
    x4, a4 = _unfold(x, dA, H)
    G, _, S, P = x4.shape
    Q = max(1, min(chunk, S))
    nc = -(-S // Q)
    rows = lambda t: _chunk_rows(t, Q, nc)
    xc = rows(x4.reshape(G * H, S, P))
    dyc = rows(_unfold(dy, a4, H)[0].reshape(G * H, S, P))
    a = torch.cumsum(rows(a4.reshape(G * H, S)), dim=-1)
    Bc = rows(Bm).repeat_interleave(H, dim=0)
    Cc = rows(Cm).repeat_interleave(H, dim=0)
    return xc, dyc, a, Bc, Cc, (G, S, Q, nc)


def ssd_bwd_states_plain(x, dA, Bm, Cm, dy, n_heads_per_group: int,
                         chunk: int = 128):
    """The states kernel in plain PyTorch (arguments as
    :func:`ssd_plain`'s, dy in y's shape): (st, U [BH, nc, N, P],
    aL [BH, nc]), float32.  Per chunk, a = cumsum(dA), a_L its last value
    (the last real row's: padded rows add dA = 0), w_j = exp(a_L - a_j):
    st = sum_j w_j B_j^T x_j, the chunk's end state from a zero start;
    U = sum_i exp(a_i) C_i^T dy_i."""
    xc, dyc, a, Bc, Cc, _ = _bwd_operands(x, dA, Bm, Cm, dy,
                                          n_heads_per_group, chunk)
    w = torch.exp(a[..., -1:] - a)
    st = torch.einsum("rcqn,rcq,rcqp->rcnp", Bc, w, xc)
    U = torch.einsum("rcqn,rcq,rcqp->rcnp", Cc, torch.exp(a), dyc)
    return st, U, a[..., -1].contiguous()


def ssd_bwd_scan_plain(st, U, aL, h0=None, dh=None):
    """The scan kernel in plain PyTorch: (hprev, G [BH, nc, N, P],
    dh0 [BH, N, P], sc [BH, nc]), float32.  h_c = exp(aL_c) h_{c-1} + st_c
    from h0 (zeros when None) gives hprev_c = h_{c-1}, the state entering
    chunk c; G_{c-1} = U_c + exp(aL_c) G_c from dh (the final state's
    gradient; zeros when None) gives G_c, the gradient of the state leaving
    it, and dh0 = G_{-1}; sc_c = exp(aL_c) <h_{c-1}, G_c>, the chunk
    decay's share of the gradient of its last row's a."""
    nc = aL.shape[1]
    d = torch.exp(aL)[..., None, None]
    zero = torch.zeros(st.shape[:1] + st.shape[2:], dtype=torch.float32,
                       device=st.device)
    h = zero if h0 is None else h0.float()
    hprev = []
    for c in range(nc):
        hprev.append(h)
        h = d[:, c] * h + st[:, c]
    g = zero if dh is None else dh.float()
    grads = [None] * nc
    for c in reversed(range(nc)):
        grads[c] = g
        g = U[:, c] + d[:, c] * g
    hprev, grads = torch.stack(hprev, dim=1), torch.stack(grads, dim=1)
    sc = torch.exp(aL) * (hprev * grads).sum((-1, -2))
    return hprev, grads, g, sc


def ssd_bwd_states_scan_plain(x, dA, Bm, Cm, dy, n_heads_per_group: int,
                              chunk: int = 128, h0=None, dh=None):
    """The fused states and scan kernel in plain PyTorch: the two plain
    stages chained, (hprev, G [BH, nc, N, P], dh0 [BH, N, P], sc
    [BH, nc]), float32."""
    return ssd_bwd_scan_plain(*ssd_bwd_states_plain(
        x, dA, Bm, Cm, dy, n_heads_per_group, chunk), h0, dh)


def ssd_bwd_grads_plain(x, dA, Bm, Cm, dy, hprev, G, sc,
                        n_heads_per_group: int, chunk: int = 128):
    """The grads kernel in plain PyTorch, all in float32: (dx in x's
    shape and dtype, ddA in dA's shape (float32), dB, dC [Bg, S, N] in B's
    dtype).  Per chunk, with L_ij = exp(a_i - a_j) (j <= i, masked before
    the exponential), S_ij = C_i . B_j, W_ij = (dy_i . x_j) L_ij, R_ij =
    W_ij S_ij and w_j = exp(a_L - a_j):
    dx_j = sum_i S_ij L_ij dy_i + w_j B_j G;
    dC_i = sum_j W_ij B_j + exp(a_i) dy_i hprev^T;
    dB_j = sum_i W_ij C_i + w_j x_j G^T, both summed over a group's heads;
    da_i = sum_j R_ij - sum_k R_ki + C_i . (exp(a_i) dy_i hprev^T)
    - B_i . (w_i x_i G^T), plus at the chunk's last row
    sum_j B_j . (w_j x_j G^T) + sc; dA = the reverse cumsum of da within
    the chunk."""
    H = n_heads_per_group
    xc, dyc, a, Bc, Cc, (Gg, S, Q, nc) = _bwd_operands(x, dA, Bm, Cm, dy,
                                                       H, chunk)
    N = Bc.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    L = torch.exp(torch.where(mask, a[..., :, None] - a[..., None, :],
                              NEG_INF))
    ea, w = torch.exp(a), torch.exp(a[..., -1:] - a)
    Sm = torch.einsum("rcin,rcjn->rcij", Cc, Bc)
    W = torch.einsum("rcip,rcjp->rcij", dyc, xc) * L
    R = W * Sm
    dCst = ea[..., None] * torch.einsum("rcip,rcnp->rcin", dyc, hprev)
    dBst = w[..., None] * torch.einsum("rcjp,rcnp->rcjn", xc, G)
    dx = (torch.einsum("rcij,rcip->rcjp", Sm * L, dyc)
          + w[..., None] * torch.einsum("rcjn,rcnp->rcjp", Bc, G))
    dC = torch.einsum("rcij,rcjn->rcin", W, Bc) + dCst
    dB = torch.einsum("rcij,rcin->rcjn", W, Cc) + dBst
    sterm = (Bc * dBst).sum(-1)
    da = R.sum(-1) - R.sum(-2) + (Cc * dCst).sum(-1) - sterm
    da[..., -1] += sterm.sum(-1) + sc
    ddA = torch.flip(torch.cumsum(torch.flip(da, (-1,)), dim=-1), (-1,))
    unrows = lambda t: t.reshape(t.shape[0], nc * Q, *t.shape[3:])[:, :S]
    heads = lambda t: unrows(t).reshape(Gg, H, S, N).sum(1).to(Bm.dtype)
    return (unrows(dx).reshape(x.shape).to(x.dtype),
            unrows(ddA).reshape(dA.shape), heads(dB), heads(dC))


def ssd_bwd_plain(x, dA, Bm, Cm, dy, n_heads_per_group: int,
                  chunk: int = 128, h0=None, dh=None):
    """The gradient of :func:`ssd_plain` at dy (y's shape and dtype) and dh
    (the final state's gradient [BH, N, P], or None), the three plain
    stages chained: (dx, ddA, dB, dC, dh0) in the shapes of x, dA, Bm, Cm
    and [BH, N, P] (dh0 float32)."""
    st, U, aL = ssd_bwd_states_plain(x, dA, Bm, Cm, dy, n_heads_per_group,
                                     chunk)
    hprev, G, dh0, sc = ssd_bwd_scan_plain(st, U, aL, h0, dh)
    return (*ssd_bwd_grads_plain(x, dA, Bm, Cm, dy, hprev, G, sc,
                                 n_heads_per_group, chunk), dh0)


def ssd_kernel(P: int, N: int, Q: int, S: int,
               dtype: torch.dtype) -> str:
    """The kernel :func:`ssd_cuda` launches for chunks of Q rows over S
    positions: "wgmma" (bf16 on Hopper) at the (P, N) of
    ``SSD_WGMMA_SHAPES`` in chunks of 128 rows or in one chunk of S < 128
    rows (the same as 128 rows with zeros after S), "mma" for the other
    bf16 shapes, "fma" for float32."""
    if dtype != torch.bfloat16:
        return "fma"
    if (P, N) in SSD_WGMMA_SHAPES and (
            Q == SSD_WGMMA_CHUNK or Q == S < SSD_WGMMA_CHUNK):
        return "wgmma"
    return "mma"


def ssd_smem_bytes(P: int, N: int, Q: int,
                   dtype: torch.dtype = torch.float32,
                   kernel: str | None = None) -> int:
    """Shared memory of one block of ``kernel`` (default: "mma" for bf16,
    "fma" for float32), in bytes: ``ssd_fma_smem_bytes`` /
    ``ssd_mma_smem_bytes`` / ``sw_smem_bytes`` in ``csrc/ssd_scan.cu``
    (the last at P = 64 and chunks of 128 rows)."""
    kernel = kernel or ("mma" if dtype == torch.bfloat16 else "fma")
    if kernel == "wgmma":
        # x, B, C (128 rows of bf16); at N = 64 the three float32 states a
        # block receives in the scan over its cluster, the hand-over tile
        # and the states' a; at N = 128 the float32 state arriving from
        # the previous block; cs, the warp sums, four mbarriers
        if N == 64:
            return 16384 * 7 + 16 * 3 + 128 * 4 + 16 + 32
        return 16384 * 7 + 128 * 4 + 16 + 32
    if kernel == "mma":
        Qp = -(-Q // 16) * 16
        return 4 * Qp * (P + N) + 2 * Qp * N + 16 * Qp + 4 * N * P
    Qs = min(Q, SSD_STRIP)          # rows of [M | C] staged at a time
    return 4 * (Qs * (Q + N + 1) + Q * (N + 1) + (Q + N) * P + Q)


def ssd_cuda(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
             h0=None, kernel: str | None = None):
    """CUDA kernel.  x: [BH, S, P] or the [G, H, S, P] view of the model's
    [G, S, H, P] (any strides, last dimension dense); Bm/Cm: [G, S, N]
    (G = BH // H, last dimension dense), one dtype with x: bfloat16 (the
    tensor-core kernels: P in {16, 32, 64}, N in {16, 32, 64, 128}) or
    float32 (the FMA kernel); dA: [BH, S] or [G, H, S] float32, any
    strides; h0: [BH, N, P] float32 contiguous or None (zero state).
    Chunks of min(chunk, S) rows.  ``kernel``: the one :func:`ssd_kernel`
    names (None), or "mma" / "wgmma" to time one against the other (raises
    where that kernel does not take the shape).  Returns (y in x's shape,
    dtype and layout order, h [BH, N, P] float32)."""
    H = n_heads_per_group
    S, P = x.shape[-2:]
    N = Bm.shape[-1]
    BH = x.shape[0] * (x.shape[1] if x.dim() == 4 else 1)
    if H < 1 or BH % H or (x.dim() == 4 and x.shape[1] != H):
        raise ValueError(f"ssd_scan: {BH} rows do not fold into groups of "
                         f"{H} heads")
    G = BH // H
    x4, a4 = _unfold(x, dA, H)
    check_input("ssd_scan.x", x4, (G, H, S, P), _DTYPES, "rows")
    check_input("ssd_scan.dA", a4, (G, H, S), torch.float32, "any")
    check_input("ssd_scan.Bm", Bm, (G, S, N), x.dtype, "rows")
    check_input("ssd_scan.Cm", Cm, (G, S, N), x.dtype, "rows")
    if h0 is not None:
        check_input("ssd_scan.h0", h0, (BH, N, P), torch.float32)
    if Bm.stride() != Cm.stride():
        raise ValueError("ssd_scan: B and C must share strides")
    Q = max(1, min(chunk, S))
    routed = ssd_kernel(P, N, Q, S, x.dtype)
    if kernel is not None and kernel != routed and not (
            kernel == "mma" and routed == "wgmma"):
        raise ValueError(f"ssd_scan: the {kernel} kernel does not take "
                         f"P={P}, N={N}, chunk {Q}, {x.dtype}")
    kernel = kernel or routed
    if x.dtype == torch.bfloat16:
        if P not in (16, 32, 64) or N not in (16, 32, 64, 128):
            raise ValueError(f"ssd_scan: the bf16 kernel takes P in (16, 32,"
                             f" 64) and N in (16, 32, 64, 128), got P={P}, "
                             f"N={N}")
        if any(t.data_ptr() % 16 for t in (x4, Bm, Cm)) or any(
                r % 8 for r in x4.stride()[:3] + Bm.stride()[:2]):
            raise ValueError("ssd_scan: bf16 rows of x, B and C must start "
                             "16-byte aligned")
    smem = ssd_smem_bytes(P, N, Q, x.dtype, kernel)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"ssd_scan: chunk {Q} with N={N}, P={P} needs {smem} bytes of "
            f"shared memory, above the {SMEM_LIMIT} a block may use")
    # y in the order of x's layout: the model's [G, S, H, P] for a view of
    # it, else [BH, S, P]
    if x.dim() == 4:
        y = torch.empty((G, S, H, P), dtype=x.dtype,
                        device=x.device).transpose(1, 2)
    else:
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
    y4 = y if y.dim() == 4 else y.unflatten(0, (G, H))
    h = torch.empty((BH, N, P), dtype=torch.float32, device=x.device)
    if BH and S:
        launch("ssd_scan", "ssd_scan_launch", x.data_ptr(), dA.data_ptr(),
               Bm.data_ptr(), Cm.data_ptr(),
               None if h0 is None else h0.data_ptr(), y.data_ptr(),
               h.data_ptr(), BH, S, P, N, H, Q, _KIND[kernel],
               *x4.stride()[:3], *a4.stride(), *y4.stride()[:3],
               *Bm.stride()[:2], stream_of(x))
    elif h0 is not None:
        h.copy_(h0)
    else:
        h.zero_()
    return y, h


def ssd_scan(x, dA, Bm, Cm, n_heads_per_group: int, chunk: int = 128,
             h0=None):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (the kernel has no CPU form)."""
    if x.is_cuda:
        return ssd_cuda(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)
    return ssd_plain(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)


# ---------------------------------------------------------------------------
# the gradient on the card: csrc/ssd_scan_bwd.cu
# ---------------------------------------------------------------------------

# the backward kernels' shapes: P, N (both forms) and the rows of a chunk,
# at most (a 16-row tile a warp of eight)
SSD_BWD_P = (16, 32, 64)
SSD_BWD_N = (16, 32, 64, 128)
SSD_BWD_MAX_CHUNK = 128
# blocks of the Hopper grads kernel's cluster of a (group, chunk), at most
# (SBW_CLUSTER), each a slice of the group's heads; the launch picks the
# size by the clusters that fit on the card at once (sbw_cluster_size)
SSD_BWD_CLUSTER = 8
# chunks of a batch*head the fused states and scan kernel takes, at most:
# a cluster of one block a chunk (SBW_CLUSTER)
SSD_BWD_FUSED_CHUNKS = 8


def ssd_bwd_kernel(P: int, N: int, Q: int, S: int,
                   dtype: torch.dtype) -> str:
    """The form :func:`ssd_bwd_states_cuda` and :func:`ssd_bwd_grads_cuda`
    launch for chunks of Q rows over S positions: the forward's table
    (:func:`ssd_kernel`), "wgmma" (bf16 on Hopper) at the (P, N) of
    ``SSD_WGMMA_SHAPES`` in chunks of 128 rows or one chunk of S < 128
    rows, "mma" for the other bf16 shapes, "fma" for float32.  The scan
    kernel has one form."""
    return ssd_kernel(P, N, Q, S, dtype)


def ssd_bwd_fused(P: int, N: int, Q: int, S: int, dtype: torch.dtype) -> bool:
    """Whether :func:`ssd_bwd_cuda` runs the states and the scan as one
    launch (:func:`ssd_bwd_states_scan_cuda`): where the table names the
    Hopper forms and the chunks of a batch*head, ceil(S / Q), number at
    most ``SSD_BWD_FUSED_CHUNKS``.  Elsewhere it launches the states kernel
    and then the scan kernel."""
    return (ssd_bwd_kernel(P, N, Q, S, dtype) == "wgmma"
            and -(-S // Q) <= SSD_BWD_FUSED_CHUNKS)


def ssd_bwd_smem_bytes(P: int, N: int, Q: int, dtype: torch.dtype,
                       kernel: str, which: str) -> int:
    """Shared memory of one block of the ``which`` ("states", "grads" or,
    for "wgmma", "states_scan") kernel in form ``kernel``, in bytes:
    ``sb_states_smem`` / ``sb_grads_smem`` (Qp = Q rounded up to 16) and,
    for "wgmma" (P = 64, chunks of 128 rows), ``sbw_states_smem`` /
    ``sbw_grads_smem`` / ``sbw_fused_smem`` in ``csrc/ssd_scan_bwd.cu``."""
    if kernel == "wgmma":
        box, nt = 16384, N // 64        # a 128-row box of 64 bf16
        if which == "states":           # x, dy, B, C; a, ea, wq; 1 barrier
            return box * (2 + 2 * nt) + 4 * (3 * 128 + 4) + 8
        if which == "states_scan":      # and sc's barrier and sums, a_L
            return (ssd_bwd_smem_bytes(P, N, Q, dtype, kernel, "states")
                    + 8 + 4 * (9 * SSD_BWD_FUSED_CHUNKS + 4))
        # B, C; x, dy twice; hprev, G; dx's tiles; a, ea, wq and the row
        # terms twice; four barriers
        return box * (4 * nt + 5) + 4 * (9 * 128 + 4) + 8 * 4
    bf = dtype == torch.bfloat16
    Qp = -(-Q // 16) * 16
    tiles = (2 * (2 * Qp * N + 2 * Qp * P) if bf
             else 4 * (2 * Qp * (N + 1) + 2 * Qp * (P + 1)))
    states = tiles + 4 * 3 * Qp
    if which == "states":
        return states
    return states + 4 * 3 * Qp + (4 * 2 * N * P if bf else 4 * 8 * 272)


def _bwd_route(name, P, N, Q, S, dtype, kernel):
    """The form to launch: the table's (``kernel`` None), or "mma" asked
    for where the table names "wgmma" (to time one against the other);
    raises for a form off the table."""
    routed = ssd_bwd_kernel(P, N, Q, S, dtype)
    if kernel is not None and kernel != routed and not (
            kernel == "mma" and routed == "wgmma"):
        raise ValueError(f"{name}: the {kernel} form does not take P={P}, "
                         f"N={N}, chunk {Q}, {dtype}")
    return kernel or routed


def _bwd_check(name, x, dA, Bm, Cm, dy, H, chunk):
    """The backward kernels' input checks (the forward's, and dy in x's
    shape and dtype); returns (G, BH, S, P, N, Q, x4, a4, dy4)."""
    S, P = x.shape[-2:]
    N = Bm.shape[-1]
    BH = x.shape[0] * (x.shape[1] if x.dim() == 4 else 1)
    if H < 1 or BH % H or (x.dim() == 4 and x.shape[1] != H):
        raise ValueError(f"{name}: {BH} rows do not fold into groups of "
                         f"{H} heads")
    G = BH // H
    x4, a4 = _unfold(x, dA, H)
    dy4 = _unfold(dy, a4, H)[0]
    check_input(f"{name}.x", x4, (G, H, S, P), _DTYPES, "rows")
    check_input(f"{name}.dy", dy4, (G, H, S, P), x.dtype, "rows")
    check_input(f"{name}.dA", a4, (G, H, S), torch.float32, "any")
    check_input(f"{name}.Bm", Bm, (G, S, N), x.dtype, "rows")
    check_input(f"{name}.Cm", Cm, (G, S, N), x.dtype, "rows")
    if Bm.stride() != Cm.stride():
        raise ValueError(f"{name}: B and C must share strides")
    if P not in SSD_BWD_P or N not in SSD_BWD_N:
        raise ValueError(f"{name}: the kernels take P in {SSD_BWD_P} and N "
                         f"in {SSD_BWD_N}, got P={P}, N={N}")
    Q = max(1, min(chunk, S))
    if Q > SSD_BWD_MAX_CHUNK:
        raise ValueError(f"{name}: chunks of {Q} rows; the kernels take "
                         f"at most {SSD_BWD_MAX_CHUNK}")
    if x.dtype == torch.bfloat16 and (
            any(t.data_ptr() % 16 for t in (x4, dy4, Bm, Cm))
            or any(r % 8 for r in x4.stride()[:3] + dy4.stride()[:3]
                   + Bm.stride()[:2])):
        raise ValueError(f"{name}: bf16 rows of x, dy, B and C must start "
                         f"16-byte aligned")
    return G, BH, S, P, N, Q, x4, a4, dy4


def ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, n_heads_per_group: int,
                        chunk: int = 128, kernel: str | None = None):
    """The first backward kernel (``ssd_scan_bwd_states``), arguments as
    :func:`ssd_cuda`'s plus dy in x's shape and dtype (any strides, last
    dimension dense): (st, U [BH, nc, N, P], aL [BH, nc]), float32, as
    :func:`ssd_bwd_states_plain`.  ``kernel``: the form
    :func:`ssd_bwd_kernel` names (None), or "mma" where it names "wgmma"."""
    H = n_heads_per_group
    G, BH, S, P, N, Q, x4, a4, dy4 = _bwd_check(
        "ssd_scan_bwd_states", x, dA, Bm, Cm, dy, H, chunk)
    kernel = _bwd_route("ssd_scan_bwd_states", P, N, Q, S, x.dtype, kernel)
    nc = -(-S // Q) if S else 0
    st = torch.empty((BH, nc, N, P), dtype=torch.float32, device=x.device)
    U = torch.empty_like(st)
    aL = torch.empty((BH, nc), dtype=torch.float32, device=x.device)
    if BH and S:
        launch("ssd_scan_bwd_states", "ssd_scan_bwd_states_launch",
               x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
               dy.data_ptr(), st.data_ptr(), U.data_ptr(), aL.data_ptr(), BH,
               S, P, N, H, Q, _KIND[kernel],
               *x4.stride()[:3], *a4.stride(), *dy4.stride()[:3],
               *Bm.stride()[:2], stream_of(x))
    return st, U, aL


def ssd_bwd_scan_cuda(st, U, aL, h0=None, dh=None):
    """The second backward kernel (``ssd_scan_bwd_scan``): st, U
    [BH, nc, N, P] and aL [BH, nc] from the first, h0 and dh [BH, N, P]
    float32 contiguous or None.  Rewrites st with hprev and U with G in
    place and returns (hprev, G, dh0, sc), as :func:`ssd_bwd_scan_plain`."""
    BH, nc = aL.shape
    N, P = st.shape[-2:]
    for name, t in (("st", st), ("U", U)):
        check_input(f"ssd_scan_bwd_scan.{name}", t, (BH, nc, N, P),
                    torch.float32)
    check_input("ssd_scan_bwd_scan.aL", aL, (BH, nc), torch.float32)
    for name, t in (("h0", h0), ("dh", dh)):
        if t is not None:
            check_input(f"ssd_scan_bwd_scan.{name}", t, (BH, N, P),
                        torch.float32)
    if N * P not in {n * p for n in SSD_BWD_N for p in SSD_BWD_P}:
        raise ValueError(f"ssd_scan_bwd_scan: a state of {N} x {P} floats; "
                         f"the kernel takes N P of N in {SSD_BWD_N}, P in "
                         f"{SSD_BWD_P}")
    dh0 = torch.empty((BH, N, P), dtype=torch.float32, device=st.device)
    sc = torch.empty((BH, nc), dtype=torch.float32, device=st.device)
    if BH and nc:
        launch("ssd_scan_bwd_scan", "ssd_scan_bwd_scan_launch",
               st.data_ptr(), U.data_ptr(), aL.data_ptr(),
               None if h0 is None else h0.data_ptr(),
               None if dh is None else dh.data_ptr(), dh0.data_ptr(),
               sc.data_ptr(), BH, nc, N * P, stream_of(st))
    elif dh is not None:
        dh0.copy_(dh)
    else:
        dh0.zero_()
    return st, U, dh0, sc


def ssd_bwd_states_scan_cuda(x, dA, Bm, Cm, dy, n_heads_per_group: int,
                             chunk: int = 128, h0=None, dh=None):
    """The states and scan kernels as one launch
    (``ssd_scan_bwd_states_scan``), where :func:`ssd_bwd_fused` says so:
    the forward's inputs and dy as :func:`ssd_bwd_states_cuda` takes them,
    h0 and dh as :func:`ssd_bwd_scan_cuda`'s.  Returns (hprev, G
    [BH, nc, N, P], dh0 [BH, N, P], sc [BH, nc]), float32, as
    :func:`ssd_bwd_states_scan_plain`; hprev, G and dh0 equal the two
    launches' to the bit, sc up to the order of its sum."""
    H = n_heads_per_group
    S, P = x.shape[-2:]
    N, Q = Bm.shape[-1], max(1, min(chunk, S))
    if not ssd_bwd_fused(P, N, Q, S, x.dtype):
        raise ValueError(
            f"ssd_scan_bwd_states_scan: the fused kernel takes bf16 at (P, "
            f"N) in {SSD_WGMMA_SHAPES}, chunks of {SSD_WGMMA_CHUNK} rows (or "
            f"one of S < {SSD_WGMMA_CHUNK}) and at most "
            f"{SSD_BWD_FUSED_CHUNKS} of them; got P={P}, N={N}, chunk {Q}, "
            f"S={S}, {x.dtype}")
    G, BH, S, P, N, Q, x4, a4, dy4 = _bwd_check(
        "ssd_scan_bwd_states_scan", x, dA, Bm, Cm, dy, H, chunk)
    for name, t in (("h0", h0), ("dh", dh)):
        if t is not None:
            check_input(f"ssd_scan_bwd_states_scan.{name}", t, (BH, N, P),
                        torch.float32)
    nc = -(-S // Q)
    hprev = torch.empty((BH, nc, N, P), dtype=torch.float32,
                        device=x.device)
    Gs = torch.empty_like(hprev)
    dh0 = torch.empty((BH, N, P), dtype=torch.float32, device=x.device)
    sc = torch.empty((BH, nc), dtype=torch.float32, device=x.device)
    if BH:
        launch("ssd_scan_bwd_states_scan", "ssd_scan_bwd_states_scan_launch",
               x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
               dy.data_ptr(), *(None if t is None else t.data_ptr()
                                for t in (h0, dh)),
               hprev.data_ptr(), Gs.data_ptr(), dh0.data_ptr(),
               sc.data_ptr(), BH, S, P, N, H, Q, *x4.stride()[:3],
               *a4.stride(), *dy4.stride()[:3], *Bm.stride()[:2],
               stream_of(x))
    return hprev, Gs, dh0, sc


def ssd_bwd_states_scan_clusters(N: int, nc: int) -> int:
    """Clusters of ``nc`` blocks of the fused kernel at state size ``N``
    that fit on the current card at once (``cudaOccupancyMaxActiveClusters``
    through ``ssd_scan_bwd_states_scan_clusters``); the card only."""
    import ctypes
    fn = library().ssd_scan_bwd_states_scan_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    n = ctypes.c_int(0)
    err = fn(N, nc, ctypes.byref(n))
    if err:
        raise RuntimeError(f"ssd_scan_bwd_states_scan_clusters: cudaError "
                           f"{err}")
    return n.value


def _like_layout(t4, G, H, S, last, dtype):
    """A new tensor in the order of ``t4``'s layout: for a [G, H, S, .]
    transpose view of [G, S, H, .] the same view of a new [G, S, H, .],
    else a contiguous [G, H, S, .] (``last`` the trailing sizes)."""
    if t4.dim() >= 3 and t4.stride(1) < t4.stride(2):
        return torch.empty((G, S, H, *last), dtype=dtype,
                           device=t4.device).transpose(1, 2)
    return torch.empty((G, H, S, *last), dtype=dtype, device=t4.device)


def ssd_bwd_grads_cuda(x, dA, Bm, Cm, dy, hprev, G, sc,
                       n_heads_per_group: int, chunk: int = 128,
                       kernel: str | None = None):
    """The third backward kernel (``ssd_scan_bwd_grads``): the forward's
    inputs, dy, and hprev, G [BH, nc, N, P], sc [BH, nc] from the scan.
    Returns (dx, ddA, dB, dC) as :func:`ssd_bwd_grads_plain` (dx and ddA in
    the layout order of x and dA).  dB and dC are summed over a group's
    heads in a fixed order, so two calls give the same bits: on the Hopper
    form on chip (each block of a (group, chunk)'s cluster over its slice
    of the heads in head order, then the blocks in rank order), on the
    others by the last block of each (group, chunk) to finish, through a
    float32 scratch of every head's rows.  ``kernel`` as
    :func:`ssd_bwd_states_cuda`'s."""
    H = n_heads_per_group
    Gg, BH, S, P, N, Q, x4, a4, dy4 = _bwd_check(
        "ssd_scan_bwd_grads", x, dA, Bm, Cm, dy, H, chunk)
    kernel = _bwd_route("ssd_scan_bwd_grads", P, N, Q, S, x.dtype, kernel)
    nc = -(-S // Q) if S else 0
    for name, t in (("hprev", hprev), ("G", G)):
        check_input(f"ssd_scan_bwd_grads.{name}", t, (BH, nc, N, P),
                    torch.float32)
    check_input("ssd_scan_bwd_grads.sc", sc, (BH, nc), torch.float32)
    dx4 = _like_layout(x4, Gg, H, S, (P,), x.dtype)
    da4 = _like_layout(a4, Gg, H, S, (), torch.float32)
    dB = torch.empty((Gg, S, N), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    if BH and S:
        part = count = None     # the Hopper form sums the heads on chip
        if kernel != "wgmma":
            part = torch.empty((2, BH, S, N), dtype=torch.float32,
                               device=x.device)
            count = torch.zeros((Gg * nc,), dtype=torch.int32,
                                device=x.device)
        launch("ssd_scan_bwd_grads", "ssd_scan_bwd_grads_launch",
               x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
               dy.data_ptr(), hprev.data_ptr(), G.data_ptr(), sc.data_ptr(),
               dx4.data_ptr(), da4.data_ptr(), dB.data_ptr(), dC.data_ptr(),
               *(None if t is None else t.data_ptr() for t in (part, count)),
               BH, S, P, N, H, Q, _KIND[kernel], *x4.stride()[:3],
               *a4.stride(), *dy4.stride()[:3], *dx4.stride()[:3],
               *da4.stride(), *Bm.stride()[:2], stream_of(x))
    else:
        for t in (dx4, da4, dB, dC):
            t.zero_()
    return (dx4.reshape(x.shape), da4.reshape(dA.shape), dB, dC)


def ssd_bwd_cuda(x, dA, Bm, Cm, dy, n_heads_per_group: int,
                 chunk: int = 128, h0=None, dh=None):
    """The backward kernels: the gradient of :func:`ssd_cuda` at dy (x's
    shape and dtype) and dh ([BH, N, P] float32 or None).  Where
    :func:`ssd_bwd_fused` says so the states and the scan are one launch
    (:func:`ssd_bwd_states_scan_cuda`), elsewhere two; then the grads
    kernel.  Returns (dx, ddA, dB, dC, dh0) as :func:`ssd_bwd_plain`."""
    S, P = x.shape[-2:]
    if ssd_bwd_fused(P, Bm.shape[-1], max(1, min(chunk, S)), S, x.dtype):
        hprev, G, dh0, sc = ssd_bwd_states_scan_cuda(
            x, dA, Bm, Cm, dy, n_heads_per_group, chunk, h0, dh)
    else:
        st, U, aL = ssd_bwd_states_cuda(x, dA, Bm, Cm, dy,
                                        n_heads_per_group, chunk)
        hprev, G, dh0, sc = ssd_bwd_scan_cuda(st, U, aL, h0, dh)
    return (*ssd_bwd_grads_cuda(x, dA, Bm, Cm, dy, hprev, G, sc,
                                n_heads_per_group, chunk), dh0)


def ssd_bwd(x, dA, Bm, Cm, dy, n_heads_per_group: int, chunk: int = 128,
            h0=None, dh=None):
    """(dx, ddA, dB, dC, dh0): the backward kernels for CUDA tensors, the
    plain version for CPU tensors."""
    fn = ssd_bwd_cuda if x.is_cuda else ssd_bwd_plain
    return fn(x, dA, Bm, Cm, dy, n_heads_per_group, chunk, h0, dh)


def _kernel_rows(dy, x):
    """dy as the kernels read it: its last dimension dense and, in bf16,
    every row 16-byte aligned (autograd may hand any strides over); else a
    contiguous copy."""
    bad = dy.shape[-1] > 1 and dy.stride(-1) != 1
    if x.dtype == torch.bfloat16:
        bad = bad or dy.data_ptr() % 16 or any(
            s % 8 for s in dy.stride()[:-1])
    return dy.contiguous() if bad else dy


class SsdScanFn(torch.autograd.Function):
    """The SSD scan with its gradient through the wrappers above: the
    forward kernel, and the three backward kernels on CUDA tensors (the
    plain versions on CPU tensors).  It saves its inputs x, dA, B, C and
    h0 as given (strided views, no copies): nothing of size Q x Q and no
    per-chunk state, which the backward recomputes."""

    @staticmethod
    def forward(ctx, x, dA, Bm, Cm, n_heads_per_group, chunk, h0):
        y, h = ssd_scan(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)
        ctx.save_for_backward(x, dA, Bm, Cm, h0)
        ctx.heads, ctx.chunk = n_heads_per_group, chunk
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dA, Bm, Cm, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        grads = ssd_bwd(x, dA, Bm, Cm, _kernel_rows(dy, x), ctx.heads,
                        ctx.chunk, h0, None if dh is None else dh.contiguous())
        need = ctx.needs_input_grad
        dx, ddA, dB, dC, dh0 = (g if n else None
                                for g, n in zip(grads, need[:4] + need[6:]))
        return dx, ddA, dB, dC, None, None, dh0
