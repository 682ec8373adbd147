"""CMB angular power spectra from line-of-sight integration (kernel K2a).

Port of cosmomc_tpu/models/cls.py, table engine (camb/cmbmain.f90
SourceToTransfers + ClTransferToCl): for each sampled multipole l,

  Delta_Tl(k) = int dtau [ S0 j_l(x) + S1 j_l'(x) + S2 j_l''(x) ]
  Delta_El(k) = int dtau  S2 sqrt((l+2)!/(l-2)!) j_l(x)/x^2
  Delta_Pl(k) = int dtau  SL j_l(x) (chi*-chi)/(chi* chi)
  x = k (tau0 - tau);  j_l'' = -2 j_l'/x + (l(l+1)/x^2 - 1) j_l
  C_l^XY = 4 pi int dlnk P_R(k) Delta_Xl Delta_Yl

Sources are cubic-Lagrange interpolated in ln k from the coarse evolution
grid onto the fine quadrature grid (host-precomputed stencils), j_l and
j_l' come from float32 tables by linear interpolation, read in the compute
dtype. `compute_cl_transfers` runs either `_los_plain` (batched torch,
k-chunked so the fine (k, tau) plane is never built whole) or the CUDA
kernel csrc/cls.cu. The port has only the table engine: "auto" means
"table" on every device; the recurrence engine is not ported yet.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models.bessel import build_bessel_table, default_l_samples
from cosmomc_tpu_torch.models.perturbations import PerturbationOutput
from cosmomc_tpu_torch.models.primordial import PrimordialParams, scalar_power
from cosmomc_tpu_torch.utils.interp import spline_eval, spline_fit

L_BATCH = 4        # sampled l's per kernel thread (and per plain-path step)


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


@lru_cache(maxsize=8)
def _device_plan(key: tuple, device: str, dtype: torch.dtype) -> dict:
    """A plan's arrays on a device (the Bessel tables stay float32)."""
    plan = _plan(*key)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dict(ls=f(plan.ls_pad), kf=f(plan.kf_pad),
                idx=torch.as_tensor(plan.idx, dtype=torch.int32, device=device),
                w=f(plan.w),
                jl=torch.as_tensor(plan.jl, dtype=torch.float32, device=device),
                jlp=torch.as_tensor(plan.jlp, dtype=torch.float32, device=device))


def _strided_sources(po: PerturbationOutput, tau_stride: int):
    """Subsample the evolution tau grid for the LOS integral."""
    sl = slice(None, None, max(tau_stride, 1))
    return (po.tau[:, sl], po.s0[:, :, sl], po.s1[:, :, sl], po.s2[:, :, sl],
            po.slens[:, :, sl])


def _los_plain(src, idx, w, kf, chi_arg, wt, wl, jl_tab, jlp_tab, ls, inv_dx,
               k_chunk: int):
    """Batched torch LOS: src (C, 4, nk, nt) -> (3, C, nl_pad, nkf_pad)."""
    C, nt = chi_arg.shape
    nl, nx = jl_tab.shape
    dtype = src.dtype
    jl_t = jl_tab.to(dtype)
    jlp_t = jlp_tab.to(dtype)
    out = torch.empty(3, C, nl, kf.shape[0], dtype=dtype, device=src.device)
    for k0 in range(0, kf.shape[0], k_chunk):
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
        for il in range(nl):
            l = ls[il]
            jl = jl_t[il][i] * (1 - f) + jl_t[il][i + 1] * f
            jp = jlp_t[il][i] * (1 - f) + jlp_t[il][i + 1] * f
            jpp = -2.0 * jp * inv_xs + (l * (l + 1) * inv_xs2 - 1.0) * jl
            out[0, :, il, sl] = torch.sum(S0w * jl + S1w * jp + S2w * jpp, -1)
            efac = torch.sqrt(torch.clamp((l + 2) * (l + 1) * l * (l - 1),
                                          min=0.0))
            out[1, :, il, sl] = efac * torch.sum(S2w * jl * inv_xs2, -1)
            out[2, :, il, sl] = torch.sum(SLw * jl, -1)
    return out


def _los_cuda(src, idx, w, kf, chi_arg, wt, wl, jl_tab, jlp_tab, ls, inv_dx,
              k_chunk: int):
    """csrc/cls.cu: one thread per (chain, fine k, batch of 4 sampled l)
    reduces over the strided tau nodes, with the cubic ln-k source
    interpolation fused into the loop.

    Replaces cosmomc_tpu/models/cls.py:compute_cl_transfers (the flat
    lax.map at cls.py:285). Bound: ~1e9 (l, k, tau) points per chain, each
    two table gathers from the 32 MB float32 Bessel tables (L2-resident)
    and ~25 flops; a thread's 4 l's share one source interpolation, so
    source traffic is a quarter of the per-l form. No atomics."""
    del k_chunk
    C, _, nk, nt = src.shape
    nl, nx = jl_tab.shape
    nkf = kf.shape[0]
    dtype = src.dtype
    kernels.check(src, "sources", (C, 4, nk, nt))
    kernels.check(idx, "k_idx", (nkf, 4), torch.int32)
    kernels.check(w, "k_w", (nkf, 4), dtype)
    kernels.check(kf, "kf", (nkf,), dtype)
    for name, t in (("chi", chi_arg), ("wt", wt), ("wl", wl)):
        kernels.check(t, name, (C, nt), dtype)
    kernels.check(jl_tab, "jl", (nl, nx), torch.float32)
    kernels.check(jlp_tab, "jlp", (nl, nx), torch.float32)
    kernels.check(ls, "ls", (nl,), dtype)
    if nl % L_BATCH:
        raise ValueError(f"sampled l count {nl} not a multiple of {L_BATCH}")
    out = torch.empty(3, C, nl, nkf, dtype=dtype, device=src.device)
    kernels.launch("los", dtype, src, idx, w, kf, chi_arg, wt, wl, jl_tab,
                   jlp_tab, ls, out, C, nk, nt, nl, nx, nkf, float(inv_dx))
    return out


def compute_cl_transfers(po: PerturbationOutput, chi_star: torch.Tensor,
                         coarse_k: np.ndarray, lmax: int = 2500,
                         tau0_hint: float = 14200.0, kmax_hint: float = 0.6,
                         points_per_osc: float = 4.0, k_chunk: int = 256,
                         tau_stride: int = 1) -> ClTransferCache:
    """SLOW stage: source x Bessel time integration -> Delta_l(k) for
    every chain. `coarse_k` is the host grid the sources live on."""
    coarse_k = np.asarray(coarse_k, np.float64)
    if len(coarse_k) != po.k.shape[0]:
        raise ValueError("coarse_k must be the grid the sources were evolved on")
    dtype, dev = po.s0.dtype, po.s0.device
    key = (lmax, tau0_hint, kmax_hint, points_per_osc, k_chunk,
           tuple(coarse_k.tolist()))
    plan = _plan(*key)
    dp = _device_plan(key, str(dev), dtype)
    taus, s0, s1, s2, sL = _strided_sources(po, tau_stride)
    tau0 = po.tau0[:, None]
    dt = taus[:, 1:] - taus[:, :-1]
    wt = torch.cat([dt[:, :1] / 2, (dt[:, 1:] + dt[:, :-1]) / 2, dt[:, -1:] / 2],
                   -1)
    chi = torch.clamp(tau0 - taus, min=1e-6)
    cs = chi_star[:, None]
    lens_w = torch.where(chi < cs, (cs - chi) / (cs * chi), 0.0)
    src = torch.stack([s0, s1, s2, sL], 1).contiguous()
    inv_dx = float(torch.tensor(1.0 / plan.dx, dtype=dtype))
    los = _los_plain if dev.type == "cpu" else _los_cuda
    out = los(src, dp["idx"], dp["w"], dp["kf"], (tau0 - taus).contiguous(),
              wt.contiguous(), (wt * lens_w).contiguous(), dp["jl"], dp["jlp"],
              dp["ls"], inv_dx, k_chunk)
    nl, nkf = len(plan.ls), len(plan.kf)
    out = out[:, :, :nl, :nkf]
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return ClTransferCache(f(plan.ls), f(plan.kf), f(plan.wk), out[0], out[1],
                           out[2])


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
