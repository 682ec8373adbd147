"""CMB angular power spectra from line-of-sight integration (kernel K2a).

Port of cosmomc_tpu/models/cls.py, table engine (camb/cmbmain.f90
SourceToTransfers + ClTransferToCl): for each sampled multipole l,

  Delta_Tl(k) = int dtau [ S0 j_l(x) + S1 j_l'(x) + S2 j_l''(x) ]
  Delta_El(k) = int dtau  S2 sqrt((l+2)!/(l-2)!) j_l(x)/x^2
  Delta_Pl(k) = int dtau  SL j_l(x) (chi*-chi)/(chi* chi)
  x = k (tau0 - tau);  j_l'' = -2 j_l'/x + (l(l+1)/x^2 - 1) j_l
  C_l^XY = 4 pi int dlnk P_R(k) Delta_Xl Delta_Yl

Sources are cubic-Lagrange interpolated in ln k from the coarse evolution
grid onto the fine quadrature grid (host-precomputed stencils). Two engines
give the same Delta_l(k):

  - table (K2a): j_l and j_l' from float32 tables by linear interpolation,
    read in the compute dtype. `compute_cl_transfers` runs `_los_plain`
    (batched torch, k-chunked so the fine (k, tau) plane is never built
    whole) or the CUDA kernel csrc/cls.cu.
  - recurrence (K2b): j_l generated by the upward recurrence over every
    l = 2..lmax with the Airy cut and the small-x series, no table.
    `compute_cl_transfers_recurrence` runs `_los_rec_plain` or
    csrc/los_recurrence.cu.

The pipeline's "auto" means "table" on every device (the JAX package picks
the recurrence off the CPU; on Hopper the table gathers are L2 hits and the
table engine is the faster one, ROADMAP section 3).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models.bessel import build_bessel_table, default_l_samples
from cosmomc_tpu_torch.models.perturbations import PerturbationOutput
from cosmomc_tpu_torch.models.primordial import PrimordialParams, scalar_power
from cosmomc_tpu_torch.utils.interp import spline_eval, spline_fit
from cosmomc_tpu_torch.utils.remat import remat

L_BATCH = 4        # sampled l's of the table plan padded to a multiple of this
REC_THREADS = 256          # threads of a recurrence kernel block (8 warps)
REC_MAX_NODES = 16 * REC_THREADS   # strided tau nodes the recurrence kernel takes


class CMBSpectra(NamedTuple):
    """l(l+1)C_l/2pi for TT/TE/EE and [l(l+1)]^2 C_l^pp/2pi, each (C, L)."""
    ls: torch.Tensor
    tt: torch.Tensor
    te: torch.Tensor
    ee: torch.Tensor
    pp: torch.Tensor


class ClTransferCache(NamedTuple):
    """Delta_l(k) on the fine k grid (the semi-slow cache)."""
    ls: torch.Tensor       # (nl,) sampled multipoles
    kf: torch.Tensor       # (nkf,) fine quadrature k grid
    wk: torch.Tensor       # (nkf,) dlnk trapezoid weights
    dT: torch.Tensor       # (C, nl, nkf)
    dE: torch.Tensor
    dP: torch.Tensor


def fine_k_grid(tau0: float, kmax: float, points_per_osc: float = 4.0,
                kmin: float = 3e-5) -> np.ndarray:
    """Quadrature k grid resolving Bessel oscillations (static, host)."""
    dk = 2.0 * np.pi / (points_per_osc * tau0)
    n = int(np.ceil((kmax - kmin) / dk))
    return kmin + dk * np.arange(n + 1)


def _cubic_k_weights(coarse_k: np.ndarray, kf_pad: np.ndarray):
    """4-point Lagrange interpolation (in ln k) from the coarse source grid
    onto the fine grid: (idx (nkf, 4), w (nkf, 4)); degenerate boundary
    stencils fall back to linear on the bracketing pair."""
    lg = np.log(np.asarray(coarse_k))
    n = len(lg)
    x = np.log(kf_pad)
    t = np.interp(x, lg, np.arange(n))
    i1 = np.clip(t.astype(np.int64), 0, n - 2)
    i0 = np.clip(i1 - 1, 0, n - 1)
    i2 = np.clip(i1 + 1, 0, n - 1)
    i3 = np.clip(i1 + 2, 0, n - 1)
    idx = np.stack([i0, i1, i2, i3], axis=1)
    w = np.empty((len(x), 4))
    for r in range(len(x)):
        xs = lg[idx[r]]
        if len(np.unique(idx[r])) < 4:
            w[r] = 0.0
            a, b = idx[r, 1], idx[r, 2]
            if a == b:
                w[r, 1] = 1.0
            else:
                f = (x[r] - lg[a]) / (lg[b] - lg[a])
                w[r, 1] = 1.0 - f
                w[r, 2] = f
        else:
            for j in range(4):
                num = 1.0
                for m in range(4):
                    if m != j:
                        num *= (x[r] - xs[m]) / (xs[j] - xs[m])
                w[r, j] = num
    return idx, w


class _LosPlan(NamedTuple):
    """Static (host-built) layout of one LOS problem."""
    ls: np.ndarray         # (nl,)
    ls_pad: np.ndarray     # (nl_pad,)
    kf: np.ndarray         # (nkf,)
    kf_pad: np.ndarray     # (nkf_pad,)
    wk: np.ndarray         # (nkf,)
    idx: np.ndarray        # (nkf_pad, 4)
    w: np.ndarray          # (nkf_pad, 4)
    jl: np.ndarray         # (nl_pad, nx) float32
    jlp: np.ndarray
    dx: float


@lru_cache(maxsize=4)
def _plan(lmax: int, tau0_hint: float, kmax_hint: float, points_per_osc: float,
          k_chunk: int, coarse_k: tuple) -> _LosPlan:
    ls = default_l_samples(lmax)
    kf = fine_k_grid(tau0_hint, kmax_hint, points_per_osc)
    kf_pad = np.concatenate([kf, np.full((-len(kf)) % k_chunk, kf[-1])])
    ls_pad = np.concatenate([ls, np.full((-len(ls)) % L_BATCH, ls[-1])]).astype(int)
    tab = build_bessel_table(tuple(int(l) for l in ls_pad),
                             kmax_hint * tau0_hint * 1.02 + 10)
    dlnk = np.diff(np.log(kf))
    wk = np.concatenate([dlnk[:1] / 2, (dlnk[1:] + dlnk[:-1]) / 2, dlnk[-1:] / 2])
    idx, w = _cubic_k_weights(np.asarray(coarse_k), kf_pad)
    return _LosPlan(ls, ls_pad, kf, kf_pad, wk, idx, w, tab.jl, tab.jlp, tab.dx)


def packed_bessel(jl: np.ndarray, jlp: np.ndarray) -> np.ndarray:
    """(nl, nx, 2) float32 with (j_l, j_l') interleaved: the kernel reads a
    table neighbour's pair with one 8-byte load."""
    return np.ascontiguousarray(np.stack([jl, jlp], -1), dtype=np.float32)


LOS_KT = 32    # fine k per kernel block (csrc/cls.cu KT)


def row_span(idx: np.ndarray, nkf: int) -> int:
    """The most coarse source rows that the stencils of one kernel block
    (LOS_KT consecutive fine k) touch; it sizes csrc/cls.cu's shared
    memory. idx is monotone in k, so a block's rows are one range."""
    starts = np.arange(0, nkf, LOS_KT)
    ends = np.minimum(starts + LOS_KT - 1, nkf - 1)
    return int((idx[ends, 3] - idx[starts, 0]).max()) + 1


def transposed_stencil(idx: np.ndarray, nk: int):
    """The reverse kernel's scatter from the fine k to the coarse source
    rows (csrc/cls.cu los_bwd): k block b (LOS_KT consecutive fine k)
    writes its share of each coarse row it touches, rows idx[b's first k,
    0] .. idx[b's last k, 3], to partial rows blk_off[b] ..; row r is the
    sum over blocks row_kb[r, 0] .. row_kb[r, 1] (0, -1 where no stencil
    reaches it), added in block order. Returns (blk_off (nkb + 1,) int32,
    row_kb (nk, 2) int32); blk_off[-1] is the partial rows in all."""
    nkf = idx.shape[0]
    starts = np.arange(0, nkf, LOS_KT)
    ends = np.minimum(starts + LOS_KT - 1, nkf - 1)
    lo, hi = idx[starts, 0], idx[ends, 3]
    blk_off = np.concatenate([[0], np.cumsum(hi - lo + 1)]).astype(np.int32)
    row_kb = np.tile(np.array([0, -1], np.int32), (nk, 1))
    for r in range(nk):
        b = np.nonzero((lo <= r) & (r <= hi))[0]
        if len(b):
            row_kb[r] = b[0], b[-1]
    return blk_off, row_kb


@lru_cache(maxsize=8)
def _device_plan(key: tuple, device: str, dtype: torch.dtype) -> dict:
    """A plan's arrays on a device (the Bessel tables stay float32). The
    tables are stored once, packed as `packed_bessel` (what the kernel
    reads); `jl` and `jlp` are strided views of it, what the plain version
    indexes. `rspan` is the kernel's row_span; `blk_off` and `row_kb` the
    reverse kernel's `transposed_stencil`."""
    plan = _plan(*key)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    packed = torch.as_tensor(packed_bessel(plan.jl, plan.jlp), device=device)
    blk_off, row_kb = transposed_stencil(plan.idx, len(key[5]))
    return dict(ls=f(plan.ls_pad), kf=f(plan.kf_pad), idx=i32(plan.idx),
                w=f(plan.w), jl=packed[..., 0], jlp=packed[..., 1],
                packed=packed, rspan=row_span(plan.idx, len(plan.kf_pad)),
                k_chunk=key[4], blk_off=i32(blk_off), row_kb=i32(row_kb),
                rtot=int(blk_off[-1]))


def compute_cls(po: PerturbationOutput, pp: PrimordialParams,
                chi_star: torch.Tensor, lmax: int = 2500,
                tau0_hint: float = 14200.0, kmax_hint: float = 0.6,
                points_per_osc: float = 4.0, coarse_k: np.ndarray = None,
                tau_stride: int = 1) -> CMBSpectra:
    """TT/TE/EE/phiphi in one call: the transfer stage (K2a) then the power
    stage. `coarse_k` is the host grid the sources were evolved on."""
    cache = compute_cl_transfers(po, chi_star, coarse_k, lmax=lmax,
                                 tau0_hint=tau0_hint, kmax_hint=kmax_hint,
                                 points_per_osc=points_per_osc,
                                 tau_stride=tau_stride)
    return cls_from_cl_transfers(cache, pp, lmax=lmax)


def _strided_sources(po: PerturbationOutput, tau_stride: int):
    """Subsample the evolution tau grid for the LOS integral."""
    sl = slice(None, None, max(tau_stride, 1))
    return (po.tau[:, sl], po.s0[:, :, sl], po.s1[:, :, sl], po.s2[:, :, sl],
            po.slens[:, :, sl])


def _los_plain(src, idx, w, kf, chi_arg, wt, wl, jl_tab, jlp_tab, ls, inv_dx,
               k_chunk: int):
    """Batched torch LOS: src (C, 4, nk, nt) -> (3, C, nl_pad, nkf_pad).
    Under autograd (grad enabled and an input wanting one) each k chunk is
    rematerialized (utils/remat.py: its per-l intermediates are recomputed
    in the backward pass rather than kept, which bounds the graph's memory
    to one chunk's; the numbers do not change)."""
    C, nt = chi_arg.shape
    nl, nx = jl_tab.shape
    dtype = src.dtype
    jl_t = jl_tab.to(dtype)
    jlp_t = jlp_tab.to(dtype)

    def chunk(k0, src, chi_arg, wt, wl):     # -> (3, C, nl, kc)
        sl = slice(k0, k0 + k_chunk)
        ki, kw = idx[sl].long(), w[sl]

        def k_interp(S):                     # (C, nk, nt) -> (C, kc, nt)
            return (kw[:, 0:1] * S[:, ki[:, 0]] + kw[:, 1:2] * S[:, ki[:, 1]]
                    + kw[:, 2:3] * S[:, ki[:, 2]] + kw[:, 3:4] * S[:, ki[:, 3]])
        S0w = k_interp(src[:, 0]) * wt[:, None]
        S1w = k_interp(src[:, 1]) * wt[:, None]
        S2w = k_interp(src[:, 2]) * wt[:, None]
        SLw = k_interp(src[:, 3]) * wl[:, None]
        x = kf[sl][None, :, None] * chi_arg[:, None, :]
        t = x * inv_dx
        i = t.to(torch.int64).clamp(0, nx - 2)
        f = t - i.to(dtype)
        inv_xs = 1.0 / torch.clamp(x, min=1e-8)
        inv_xs2 = inv_xs * inv_xs
        out_t, out_e, out_p = [], [], []
        for il in range(nl):
            l = ls[il]
            jl = jl_t[il][i] * (1 - f) + jl_t[il][i + 1] * f
            jp = jlp_t[il][i] * (1 - f) + jlp_t[il][i + 1] * f
            jpp = -2.0 * jp * inv_xs + (l * (l + 1) * inv_xs2 - 1.0) * jl
            out_t.append(torch.sum(S0w * jl + S1w * jp + S2w * jpp, -1))
            efac = torch.sqrt(torch.clamp((l + 2) * (l + 1) * l * (l - 1),
                                          min=0.0))
            out_e.append(efac * torch.sum(S2w * jl * inv_xs2, -1))
            out_p.append(torch.sum(SLw * jl, -1))
        return torch.stack([torch.stack(o, 1) for o in (out_t, out_e, out_p)])

    starts = range(0, kf.shape[0], k_chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (src, chi_arg, wt, wl)):
        return torch.cat([remat(lambda *a: (chunk(*a),), k0, src, chi_arg,
                                wt, wl)[0] for k0 in starts], -1)
    out = torch.empty(3, C, nl, kf.shape[0], dtype=dtype, device=src.device)
    for k0 in starts:
        out[..., k0:k0 + k_chunk] = chunk(k0, src, chi_arg, wt, wl)
    return out


def _los_plan_plain(src, dp: dict, chi_arg, wt, wl, inv_dx):
    """_los_plain on a device plan (`_device_plan`): the CPU's path, and
    the kernel's twin with the same signature."""
    return _los_plain(src, dp["idx"], dp["w"], dp["kf"], chi_arg, wt, wl,
                      dp["jl"], dp["jlp"], dp["ls"], inv_dx, dp["k_chunk"])


def _los_cuda(src, dp: dict, chi_arg, wt, wl, inv_dx):
    """csrc/cls.cu: a block owns (chain, 32 fine k) and up to 64 sampled
    l (a warp per 8 l's, a lane per k), one block per SM so the table rows
    it reads stay in L1. Per tile of tau nodes the coarse source rows the
    tile's stencils touch arrive by cp.async (double buffered), the four
    sources are interpolated once per (k, tau) into shared memory with the
    per-(k, tau) Bessel arguments, and every thread then gathers (j_l,
    j_l') pairs from the packed table (dp["packed"]) for its 8 l's. Each
    output has one owner, summed over tau in order; no atomics.

    Replaces cosmomc_tpu/models/cls.py:compute_cl_transfers (the flat
    lax.map at cls.py:285); the bound and the design are in the source."""
    C, _, nk, nt = src.shape
    idx, w, kf, ls, packed = dp["idx"], dp["w"], dp["kf"], dp["ls"], dp["packed"]
    nl, nx, _ = packed.shape
    nkf = kf.shape[0]
    dtype = src.dtype
    kernels.check(src, "sources", (C, 4, nk, nt))
    kernels.check(idx, "k_idx", (nkf, 4), torch.int32)
    kernels.check(w, "k_w", (nkf, 4), dtype)
    kernels.check(kf, "kf", (nkf,), dtype)
    for name, t in (("chi", chi_arg), ("wt", wt), ("wl", wl)):
        kernels.check(t, name, (C, nt), dtype)
    kernels.check(packed, "packed Bessel table", (nl, nx, 2), torch.float32)
    kernels.check(ls, "ls", (nl,), dtype)
    out = torch.empty(3, C, nl, nkf, dtype=dtype, device=src.device)
    kernels.launch("los", dtype, src, idx, w, kf, chi_arg, wt, wl, packed, ls,
                   out, C, nk, nt, nl, nx, nkf, float(inv_dx), dp["rspan"])
    return out


def _los_bwd_cuda(src, dp: dict, chi_arg, wt, wl, inv_dx, g):
    """csrc/cls.cu's reverse kernel: the cotangents of src (C, 4, nk, nt),
    chi_arg, wt and wl (C, nt) from that of the output g (3, C, nl, nkf),
    as autograd of `_los_plan_plain` gives them: the derivative of j_l and
    j_l' in x is the slope of the table's linear interpolant (the index is
    truncated, as in JAX), the source cotangent goes back to the coarse k
    grid through the transposed cubic stencil. A block owns (chain, 32
    fine k, a tile of tau nodes), its lanes walk the sampled l; the sums
    over k and the scatter to the coarse rows go through partial buffers
    added in a fixed order (no atomics)."""
    C, _, nk, nt = src.shape
    idx, w, kf, ls, packed = dp["idx"], dp["w"], dp["kf"], dp["ls"], dp["packed"]
    nl, nx, _ = packed.shape
    nkf = kf.shape[0]
    dtype = src.dtype
    g = g.contiguous()
    kernels.check(src, "sources", (C, 4, nk, nt))
    for name, t in (("chi", chi_arg), ("wt", wt), ("wl", wl)):
        kernels.check(t, name, (C, nt), dtype)
    kernels.check(g, "g", (3, C, nl, nkf), dtype)
    blk_off, row_kb = dp["blk_off"], dp["row_kb"]
    nkb = -(-nkf // LOS_KT)
    kernels.check(blk_off, "blk_off", (nkb + 1,), torch.int32)
    kernels.check(row_kb, "row_kb", (nk, 2), torch.int32)
    rtot = dp["rtot"]
    part_src = torch.empty(C, 4, rtot, nt, dtype=dtype, device=src.device)
    part_w = torch.empty(C, nkb, 3, nt, dtype=dtype, device=src.device)
    g_src = torch.empty_like(src)
    g_chi, g_wt, g_wl = (torch.empty_like(chi_arg) for _ in range(3))
    kernels.launch("los_bwd", dtype, src, idx, w, kf, chi_arg, wt, wl, packed,
                   ls, g, blk_off, row_kb, part_src, part_w, g_src, g_chi, g_wt,
                   g_wl, C, nk, nt, nl, nx, nkf, float(inv_dx), dp["rspan"],
                   rtot)
    return g_src, g_chi, g_wt, g_wl


class _Los(torch.autograd.Function):
    """K2a on the card with its reverse kernel (`_los_bwd_cuda`)."""

    @staticmethod
    def forward(ctx, src, chi_arg, wt, wl, dp, inv_dx):
        ctx.save_for_backward(src, chi_arg, wt, wl)
        ctx.dp, ctx.inv_dx = dp, inv_dx
        return _los_cuda(src, dp, chi_arg, wt, wl, inv_dx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        src, chi_arg, wt, wl = ctx.saved_tensors
        return (*_los_bwd_cuda(src, ctx.dp, chi_arg, wt, wl, ctx.inv_dx, g),
                None, None)


def _los_inputs(po: PerturbationOutput, chi_star: torch.Tensor,
                tau_stride: int):
    """The strided sources (C, 4, nk, nt) and, per chain, tau0 - tau, the
    trapezoid weights and the weights times the lensing kernel (C, nt)."""
    taus, s0, s1, s2, sL = _strided_sources(po, tau_stride)
    tau0 = po.tau0[:, None]
    dt = taus[:, 1:] - taus[:, :-1]
    wt = torch.cat([dt[:, :1] / 2, (dt[:, 1:] + dt[:, :-1]) / 2, dt[:, -1:] / 2],
                   -1)
    chi = torch.clamp(tau0 - taus, min=1e-6)
    cs = chi_star[:, None]
    lens_w = torch.where(chi < cs, (cs - chi) / (cs * chi), 0.0)
    return (torch.stack([s0, s1, s2, sL], 1).contiguous(),
            (tau0 - taus).contiguous(), wt.contiguous(),
            (wt * lens_w).contiguous())


def compute_cl_transfers(po: PerturbationOutput, chi_star: torch.Tensor,
                         coarse_k: np.ndarray, lmax: int = 2500,
                         tau0_hint: float = 14200.0, kmax_hint: float = 0.6,
                         points_per_osc: float = 4.0, k_chunk: int = 256,
                         tau_stride: int = 1) -> ClTransferCache:
    """SLOW stage: source x Bessel time integration -> Delta_l(k) for
    every chain. `coarse_k` is the host grid the sources live on."""
    if coarse_k is None or len(coarse_k) != po.k.shape[0]:
        raise ValueError("coarse_k must be the grid the sources were evolved "
                         "on (the port interpolates with host-built stencils)")
    coarse_k = np.asarray(coarse_k, np.float64)
    dtype, dev = po.s0.dtype, po.s0.device
    key = (lmax, tau0_hint, kmax_hint, points_per_osc, k_chunk,
           tuple(coarse_k.tolist()))
    plan = _plan(*key)
    dp = _device_plan(key, str(dev), dtype)
    src, chi_arg, wt, wl = _los_inputs(po, chi_star, tau_stride)
    inv_dx = float(torch.tensor(1.0 / plan.dx, dtype=dtype))
    if dev.type == "cpu":
        out = _los_plan_plain(src, dp, chi_arg, wt, wl, inv_dx)
    elif torch.is_grad_enabled() and any(
            t.requires_grad for t in (src, chi_arg, wt, wl)):
        out = _Los.apply(src, chi_arg, wt, wl, dp, inv_dx)
    else:
        out = _los_cuda(src, dp, chi_arg, wt, wl, inv_dx)
    nl, nkf = len(plan.ls), len(plan.kf)
    out = out[:, :, :nl, :nkf]
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return ClTransferCache(f(plan.ls), f(plan.kf), f(plan.wk), out[0], out[1],
                           out[2])


@lru_cache(maxsize=4)
def _rec_plan(lmax: int, tau0_hint: float, kmax_hint: float,
              points_per_osc: float, coarse_k: tuple):
    """Static layout of the recurrence engine: sampled l, fine k grid and
    weights, cubic stencils, and the Airy cut nu - 2.5 nu^(1/3) (nu = l +
    1/2) per l, built once on the host so kernel and plain version compare
    against the same numbers."""
    ls = default_l_samples(lmax)
    kf = fine_k_grid(tau0_hint, kmax_hint, points_per_osc)
    dlnk = np.diff(np.log(kf))
    wk = np.concatenate([dlnk[:1] / 2, (dlnk[1:] + dlnk[:-1]) / 2, dlnk[-1:] / 2])
    idx, w = _cubic_k_weights(np.asarray(coarse_k), kf)
    return ls, kf, wk, idx, w, airy_cut(lmax)


def airy_cut(lmax: int) -> np.ndarray:
    """cut[l] = max(nu - 2.5 nu^(1/3), 0), nu = l + 1/2, l = 0..lmax: where
    x <= cut[l] the recurrence engine sets j_l(x) to 0."""
    nu = np.arange(lmax + 1) + 0.5
    return np.maximum(nu - 2.5 * np.cbrt(nu), 0.0)


def _los_rec_plain(src, idx, w, kf, chi_arg, wt, wl, ls, cut, k_chunk: int):
    """Batched torch recurrence LOS: src (C, 4, nk, nt) -> (3, C, nl, nkf).
    The arithmetic of cosmomc_tpu/models/cls.py:compute_cl_transfers_
    recurrence; the sums are taken at the sampled l only."""
    C, nt = chi_arg.shape
    nl, nkf = ls.shape[0], kf.shape[0]
    ls_h = [int(v) for v in ls.tolist()]
    cut_h = cut.tolist()
    out = torch.empty(3, C, nl, nkf, dtype=src.dtype, device=src.device)
    with torch.no_grad():
        for k0 in range(0, nkf, k_chunk):
            sl = slice(k0, k0 + k_chunk)
            ki, kw = idx[sl].long(), w[sl]

            def k_interp(S):                 # (C, nk, nt) -> (C, kc, nt)
                return (kw[:, 0:1] * S[:, ki[:, 0]] + kw[:, 1:2] * S[:, ki[:, 1]]
                        + kw[:, 2:3] * S[:, ki[:, 2]]
                        + kw[:, 3:4] * S[:, ki[:, 3]])
            S0w = k_interp(src[:, 0]) * wt[:, None]
            S1w = k_interp(src[:, 1]) * wt[:, None]
            S2w = k_interp(src[:, 2]) * wt[:, None]
            SLw = k_interp(src[:, 3]) * wl[:, None]
            x = kf[sl][None, :, None] * chi_arg[:, None, :]
            inv_x = 1.0 / torch.clamp(x, min=1e-6)
            inv_x2 = inv_x * inv_x
            xx = x * x
            y2 = 0.5 * x * x                 # series variable x^2/2
            small = x < 1e-3
            sx, cx = torch.sin(x), torch.cos(x)
            jm1 = torch.where(small, 1.0 - x * x / 6.0, sx * inv_x)
            jl = torch.where(small, x / 3.0, sx * inv_x2 - cx * inv_x)
            # p_l = x^l/(2l+1)!!, carried multiplicatively, clamped at 1
            pser = torch.clamp(x / 3.0, max=1.0)
            s = 0
            for l in range(2, ls_h[-1] + 1):
                lf = float(l)
                jnew = ((2.0 * lf - 1.0) * inv_x) * jl - jm1
                pser = torch.clamp(pser * (x / (2.0 * lf + 1.0)), max=1.0)
                poly = (1.0 - y2 / (2.0 * lf + 3.0)
                        + y2 * y2 / (2.0 * (2.0 * lf + 3.0) * (2.0 * lf + 5.0)))
                # small-x series where x^2 < l+1; zero below the Airy cut
                jnew = torch.where(xx < lf + 1.0, pser * poly, jnew)
                jnew = torch.where(x > cut_h[l], jnew, 0.0)
                jm1, jl = jl, jnew
                if l != ls_h[s]:
                    continue
                jp = jm1 - (lf + 1.0) * inv_x * jl
                jpp = -2.0 * jp * inv_x + (lf * (lf + 1.0) * inv_x2 - 1.0) * jl
                out[0, :, s, sl] = torch.sum(S0w * jl + S1w * jp + S2w * jpp, -1)
                efac = np.sqrt(max((lf + 2.0) * (lf + 1.0) * lf * (lf - 1.0), 0.0))
                out[1, :, s, sl] = efac * torch.sum(S2w * jl * inv_x2, -1)
                out[2, :, s, sl] = torch.sum(SLw * jl, -1)
                s += 1
    return out


def rec_nodes_per_thread(nt: int) -> int:
    """NPT, the tau nodes a thread of csrc/los_recurrence.cu holds: warp
    w of a block owns nodes [32 NPT w, 32 NPT (w + 1)), thread `lane` of it
    nodes 32 NPT w + lane + 32 j for j < NPT."""
    for npt in (2, 4, 8, 16):
        if nt <= npt * REC_THREADS:
            return npt
    raise ValueError(f"{nt} tau nodes: the recurrence kernel takes at most "
                     f"{REC_MAX_NODES} (raise tau_stride)")


def rec_lattice(chi_arg: torch.Tensor, kf: torch.Tensor, cut: torch.Tensor,
                ls: torch.Tensor = None) -> dict:
    """The (chain, fine k, tau node, l) points of a recurrence LOS problem,
    l = 2..lmax, counted from its inputs: `lattice` all of them, `live`
    those with x = kf (tau0 - tau) > cut[l] (below the cut j_l is exactly
    0), `walked` those csrc/los_recurrence.cu steps through (a warp walks
    its real nodes up to the largest first dead l among them); given the
    sampled l's `ls`, `sampled` the (node, sampled l) pairs where j_l or
    j_{l-1} can be nonzero (l <= the node's first dead l)."""
    C, nt = chi_arg.shape
    lmax = cut.shape[0] - 1
    span = 32 * rec_nodes_per_thread(nt)
    nw = -(-nt // span)
    c2 = cut[2:].contiguous()
    real = torch.zeros(nw * span, dtype=torch.int64, device=kf.device)
    real[:nt] = 1
    real = real.view(nw, span).sum(-1)                      # real nodes a warp
    live = walked = sampled = 0
    for c in range(C):
        x = (kf[:, None] * chi_arg[c][None, :]).contiguous()
        n_live = torch.searchsorted(c2, x)                  # l >= 2 with cut[l] < x
        live += int(n_live.sum())
        if ls is not None:
            sampled += int(torch.searchsorted(ls.to(n_live.dtype).contiguous(),
                                              n_live + 2, right=True).sum())
        lcut = torch.nn.functional.pad(n_live + 2, (0, nw * span - nt), value=2)
        lend = lcut.view(-1, nw, span).amax(-1).clamp(max=lmax)
        walked += int(((lend - 1) * real).sum())
    out = dict(lattice=C * kf.shape[0] * nt * (lmax - 1), live=live, walked=walked)
    if ls is not None:
        out["sampled"] = sampled
    return out


def rec_series_limit(cut: np.ndarray) -> int:
    """L0 of the recurrence kernel: the smallest l >= 2 from which, for
    every l' in [l, lmax], x*x < l'+1 implies x <= cut[l'] for every x of
    `cut`'s dtype (the product rounded in that dtype). From L0 on the
    series value is one the Airy cut always zeroes, so the kernel drops the
    series there; below it runs the full step. lmax + 1 if no l qualifies."""
    dt = cut.dtype.type
    lmax = len(cut) - 1
    if lmax < 2:
        return 2
    thr = np.arange(3, lmax + 2).astype(cut.dtype)       # l + 1, l = 2..lmax
    r = np.sqrt(thr)
    cand = [r]
    for _ in range(2):
        cand = [np.nextafter(cand[0], dt(0))] + cand + [np.nextafter(cand[-1], dt(np.inf))]
    cand = np.stack(cand)                                 # (5, lmax - 1)
    # the largest x with fl(x*x) < l+1 lies within two ulps of sqrt(l+1)
    xs = np.where(cand * cand < thr, cand, dt(-np.inf)).max(0)
    bad = np.nonzero(xs > cut[2:])[0]
    return int(bad[-1]) + 3 if len(bad) else 2


@lru_cache(maxsize=8)
def rec_l0(lmax: int, dtype: torch.dtype) -> int:
    """L0 (`rec_series_limit`) of `airy_cut(lmax)` rounded to `dtype`,
    after checking that the rounded cut does not decrease in l (the kernel
    finds each node's first dead l by bisection of it)."""
    cut = airy_cut(lmax).astype(np.float32 if dtype == torch.float32 else np.float64)
    if (np.diff(cut[2:]) < 0).any():
        raise ValueError(f"the Airy cut to l = {lmax} decreases in {dtype}")
    return rec_series_limit(cut)


def _los_rec_cuda(src, idx, w, kf, chi_arg, wt, wl, ls, cut, k_chunk: int):
    """csrc/los_recurrence.cu: one block per (chain, fine k); each of its 8
    warps owns a contiguous range of tau nodes and walks l = 2..lmax
    upward with (j_{l-1}, j_l) in registers, stopping where every node of
    the range is past its Airy cut; the series term only below L0; at the
    sampled l each warp reduces over its tau nodes by shuffles into its own
    shared-memory slot, summed in warp order after the walk.

    `cut` is `airy_cut(lmax)` in the sources' dtype, as `_rec_plan` builds
    it, and ls[-1] is lmax: L0 and the check that the cut does not decrease
    come from `rec_l0(lmax, dtype)`, made once on the host, not from the
    tensor (no copy to the host a call).

    Replaces cosmomc_tpu/models/cls.py:compute_cl_transfers_recurrence (the
    lax.scan at cls.py:473). Bound: operations on the live lattice, the
    (k, tau, l) points above the cut (3 flops each). No atomics."""
    del k_chunk
    C, _, nk, nt = src.shape
    nl, nkf = ls.shape[0], kf.shape[0]
    lmax = cut.shape[0] - 1
    dtype = src.dtype
    kernels.check(src, "sources", (C, 4, nk, nt))
    kernels.check(idx, "k_idx", (nkf, 4), torch.int32)
    kernels.check(w, "k_w", (nkf, 4), dtype)
    kernels.check(kf, "kf", (nkf,), dtype)
    for name, t in (("chi", chi_arg), ("wt", wt), ("wl", wl)):
        kernels.check(t, name, (C, nt), dtype)
    kernels.check(ls, "ls", (nl,), torch.int32)
    kernels.check(cut, "cut", (lmax + 1,), dtype)
    rec_nodes_per_thread(nt)   # raises past REC_MAX_NODES
    out = torch.empty(3, C, nl, nkf, dtype=dtype, device=src.device)
    kernels.launch("los_rec", dtype, src, idx, w, kf, chi_arg, wt, wl, ls, cut,
                   out, C, nk, nt, nl, nkf, lmax, rec_l0(lmax, dtype))
    return out


def compute_cl_transfers_recurrence(po: PerturbationOutput,
                                    chi_star: torch.Tensor,
                                    coarse_k: np.ndarray,
                                    lmax: int = 2500,
                                    tau0_hint: float = 14200.0,
                                    kmax_hint: float = 0.6,
                                    points_per_osc: float = 4.0,
                                    k_chunk: int = 512,
                                    tau_stride: int = 1) -> ClTransferCache:
    """SLOW stage, table-free: the same Delta_l(k) as compute_cl_transfers
    from j_l generated by the upward recurrence

        j_{l+1}(x) = ((2l+1)/x) j_l(x) - j_{l-1}(x),

    stable for x > l, zeroed below the Airy turning region (x < nu -
    2.5 nu^(1/3)), and replaced by the 3-term ascending series where
    x^2 < l+1. `coarse_k` is the host grid the sources live on."""
    if coarse_k is None or len(coarse_k) != po.k.shape[0]:
        # the JAX function hands over to its table engine here; the port's
        # table engine needs the same grid and raises, so raise directly
        raise ValueError("coarse_k must be the grid the sources were evolved "
                         "on (the port interpolates with host-built stencils)")
    coarse_k = np.asarray(coarse_k, np.float64)
    dtype, dev = po.s0.dtype, po.s0.device
    ls, kf, wk, idx, w, cut = _rec_plan(lmax, tau0_hint, kmax_hint,
                                        points_per_osc, tuple(coarse_k.tolist()))
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    src, chi_arg, wt, wl = _los_inputs(po, chi_star, tau_stride)
    los = _los_rec_plain if dev.type == "cpu" else _los_rec_cuda
    out = los(src, torch.as_tensor(idx, dtype=torch.int32, device=dev), f(w),
              f(kf), chi_arg, wt, wl,
              torch.as_tensor(ls, dtype=torch.int32, device=dev), f(cut), k_chunk)
    return ClTransferCache(f(ls), f(kf), f(wk), out[0], out[1], out[2])


def cls_from_cl_transfers(cache: ClTransferCache, pp: PrimordialParams,
                          lmax: int = 2500) -> CMBSpectra:
    """SEMI-SLOW stage (CAMB_TransfersToPowers): apply the primordial power
    to cached Delta_l(k) and spline-fill to every integer l."""
    dtype = cache.dT.dtype
    wP = (cache.wk * scalar_power(pp, cache.kf)).to(dtype)[:, None, :]
    tts = 4.0 * torch.pi * torch.sum(wP * cache.dT * cache.dT, -1)
    tes = 4.0 * torch.pi * torch.sum(wP * cache.dT * cache.dE, -1)
    ees = 4.0 * torch.pi * torch.sum(wP * cache.dE * cache.dE, -1)
    pps = 4.0 * torch.pi * torch.sum(wP * cache.dP * cache.dP, -1)
    ls_f = cache.ls
    fac = ls_f * (ls_f + 1) / (2 * torch.pi)
    fac_pp = (ls_f * (ls_f + 1)) ** 2 / (2 * torch.pi)
    all_l = torch.arange(2, lmax + 1, dtype=dtype, device=ls_f.device)

    def fill(vals):
        return spline_eval(spline_fit(ls_f, vals), all_l)
    return CMBSpectra(all_l.to(torch.int32), fill(fac * tts), fill(fac * tes),
                      fill(fac * ees), fill(fac_pp * pps))
