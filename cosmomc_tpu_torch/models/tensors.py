"""Tensor modes: evolution (kernel K5) and line-of-sight transfers (K6).

Port of cosmomc_tpu/models/tensors.py (camb/equations.f90 tensor
evolution, cmbmain.f90 tensor transfers, power_tilt.f90 TensorPower).
Per comoving wavenumber k, one polarization (Seljak & Zaldarriaga 1996/97):

  metric      h'' + 2(a'/a) h' + k^2 h = (16/3)(grho_g pi_g + grho_nu pi_nu)
  photons     Dt' + i k mu Dt = -h' - kappa'(Dt - Psi)
              Dp' + i k mu Dp =       -kappa'(Dp + Psi)
  neutrinos   Dn' + i k mu Dn = -h'
  Psi = Dt0/10 + Dt2/7 + 3 Dt4/70 - 3 Dp0/5 + 6 Dp2/7 - 3 Dp4/70

with tight coupling slaving Psi to -h'/(3 kappa') while
opac (1 + R) > TC_LAM_MAX, the hierarchies frozen past k tau = 240, and
lanes held on h = 1 until k tau >= 0.05. Line of sight (ZS97 tensor
radial functions):

  DT_l(k) = sqrt((l+2)!/(l-2)!) int dtau [-h' e^-kappa + g Psi] j_l(x)/x^2
  DE_l(k) = int dtau g Psi [ -j_l + j_l'' + 2 j_l/x^2 + 4 j_l'/x ]
  DB_l(k) = int dtau g Psi [ 2 j_l' + 4 j_l/x ]
  C_l^X   = (1/16) 4 pi int dlnk P_T(k) |DX_l|^2

Everything carries a leading chains axis. `evolve_tensors` runs either
`_evolve_t_plain` (batched torch) or csrc/tensors.cu (K5);
`compute_tensor_transfers` runs `_tlos_plain` or csrc/tensor_los.cu (K6).
CPU tensors take the plain versions; CUDA tensors launch the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.bessel import build_bessel_table, default_l_samples
from cosmomc_tpu_torch.models.cls import L_BATCH, fine_k_grid
from cosmomc_tpu_torch.models.perturbations import (TC_LAM_MAX, ThermoFuncs,
                                                    grho_terms)
from cosmomc_tpu_torch.models.primordial import PrimordialParams, tensor_power
from cosmomc_tpu_torch.utils.interp import interp, spline_eval, spline_fit

# hierarchy truncations (photon temperature / polarization / neutrinos)
LMAXT = 16
LMAXTP = 8
LMAXTN = 16

# state layout
_I_HT = 0                        # tensor amplitude h
_I_HTP = 1                       # h'
_I_DT0 = 2                       # photon intensity Dt_0..Dt_LMAXT
_I_DP0 = _I_DT0 + (LMAXT + 1)    # photon polarization Dp_0..Dp_LMAXTP
_I_DN0 = _I_DP0 + (LMAXTP + 1)   # neutrino Dn_0..Dn_LMAXTN
NVAR_T = _I_DN0 + (LMAXTN + 1)

RSA_KTAU_T = 240.0               # hierarchies frozen past k tau = 240
RELEASE_KTAU_T = 0.05            # lanes held on h = 1 below k tau = 0.05

# fields of the tensor stage table (chains, steps, rows, NQT)
QT_TAU, QT_OPAC, QT_GG, QT_GN, QT_ADOTOA, QT_TC, QT_VIS, QT_EXPMK = range(8)
NQT = 8
# output planes of the evolution
T_PLANES = ("sT", "sP", "ht")


class TensorOutput(NamedTuple):
    tau: torch.Tensor      # (C, N)
    k: torch.Tensor        # (nk,)
    sT: torch.Tensor       # (C, nk, N)  -h' e^-kappa + g Psi
    sP: torch.Tensor       # (C, nk, N)  g Psi
    tau0: torch.Tensor     # (C,)
    ht: torch.Tensor = None   # (C, nk, N) metric amplitude


class TensorSpectra(NamedTuple):
    """l(l+1)C_l/2pi, dimensionless (x (T0*1e6)^2 for muK^2), each (C, L)."""
    ls: torch.Tensor
    tt: torch.Tensor
    te: torch.Tensor
    ee: torch.Tensor
    bb: torch.Tensor


class TensorTransferCache(NamedTuple):
    """Tensor Delta^X_l(k): the primordial-independent slow cache."""
    ls: torch.Tensor       # (nl,)
    kf: torch.Tensor       # (nkf,)
    wk: torch.Tensor       # (nkf,) dlnk trapezoid weights
    dT: torch.Tensor       # (C, nl, nkf)
    dE: torch.Tensor
    dB: torch.Tensor


def tensor_k_grid(kmax: float = 0.065, nk: int = 96,
                  kmin: float = 3e-5) -> np.ndarray:
    """Coarse k grid for tensor sources (BB support is l <~ 700)."""
    return np.exp(np.linspace(np.log(kmin), np.log(kmax), nk))


def _stage_inputs(bg: BackgroundParams, tf: ThermoFuncs,
                  ts: torch.Tensor) -> torch.Tensor:
    """Every k-independent RHS input at times ts (C, M): (C, M, NQT). The
    tight-coupling flag is decided here, once, for kernel and plain alike."""
    a = interp(ts, tf.tau, tf.a)
    opac = interp(ts, tf.tau, tf.opac)
    grho_g, grho_n, grho_num, _gp, grho_c, grho_b, grho_de, grho_k = \
        grho_terms(bg, a)
    grho = grho_g + grho_n + grho_num + grho_c + grho_b + grho_de
    adotoa = torch.sqrt((grho + grho_k) / 3.0)
    R_bg = (4.0 / 3.0) * grho_g / grho_b
    tc_on = opac * (1.0 + R_bg) > TC_LAM_MAX
    return torch.stack([ts, opac, grho_g, grho_n, adotoa, tc_on.to(ts.dtype),
                        interp(ts, tf.tau, tf.vis), interp(ts, tf.tau, tf.expmk)],
                       -1)


def _stage_table(bg: BackgroundParams, tf: ThermoFuncs,
                 substeps: int) -> torch.Tensor:
    """(C, N-1, 3 substeps + 1, NQT): per step, the three RK4 stage times
    of each substep (jnp arithmetic of the JAX step: tau_a + f (tau_b -
    tau_a)), then tau_b itself, where the sources are read."""
    ta, tb = tf.tau[:, :-1], tf.tau[:, 1:]
    d = tb - ta
    rows = []
    for s in range(substeps):
        a_s = ta + (s / substeps) * d
        b_s = ta + ((s + 1) / substeps) * d
        rows += [a_s, a_s + 0.5 * (b_s - a_s), b_s]
    rows.append(tb)
    ts = torch.stack(rows, -1)                         # (C, N-1, R)
    C, S, R = ts.shape
    return _stage_inputs(bg, tf, ts.reshape(C, S * R)).reshape(
        C, S, R, NQT).contiguous()


def _tensor_rhs(y: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                feedback: bool):
    """dy/dtau for y (C, nk, NVAR_T) at one stage, q (C, NQT); returns
    (dy, psi) with psi (C, nk) zero past the freeze."""
    Q = lambda f: q[:, f:f + 1]
    tau, opac, grho_g, grho_n, adotoa = (Q(QT_TAU), Q(QT_OPAC), Q(QT_GG),
                                         Q(QT_GN), Q(QT_ADOTOA))
    tc_on = Q(QT_TC) > 0.5                              # (C, 1)
    ht, htp = y[..., _I_HT], y[..., _I_HTP]
    dt = y[..., _I_DT0:_I_DP0]
    dp = y[..., _I_DP0:_I_DN0]
    dn = y[..., _I_DN0:NVAR_T]
    tau_safe = torch.clamp(tau, min=1e-10)
    psi_tca = -htp / (3.0 * torch.clamp(opac, min=1e-30))
    psi_full = (dt[..., 0] / 10.0 + dt[..., 2] / 7.0 + 3.0 * dt[..., 4] / 70.0
                - 3.0 * dp[..., 0] / 5.0 + 6.0 * dp[..., 2] / 7.0
                - 3.0 * dp[..., 4] / 70.0)
    psi = torch.where(tc_on, psi_tca, psi_full)
    rsa = k * tau >= RSA_KTAU_T                          # (C, nk)
    zero = torch.zeros_like(psi)
    if feedback:
        pi_n = dn[..., 0] / 10.0 + dn[..., 2] / 7.0 + 3.0 * dn[..., 4] / 70.0
        pi_g = dt[..., 0] / 10.0 + dt[..., 2] / 7.0 + 3.0 * dt[..., 4] / 70.0
        pi_g = torch.where(tc_on, zero, pi_g)
        stress = torch.where(rsa, zero,
                             (16.0 / 3.0) * (grho_g * pi_g + grho_n * pi_n))
    else:
        stress = zero
    htpp = -2.0 * adotoa * htp - k * k * ht + stress

    kk = k[:, None]

    def ladder(D, lmax):
        ls = torch.arange(0, lmax + 1, dtype=y.dtype, device=y.device)
        prev = torch.cat([torch.zeros_like(D[..., :1]), D[..., :-1]], -1)
        nxt = torch.cat([D[..., 1:], torch.zeros_like(D[..., :1])], -1)
        return (kk / (2 * ls + 1)) * (ls * prev - (ls + 1) * nxt)

    op = opac[..., None]
    dtdot = ladder(dt, LMAXT) - op * dt
    dt0 = dtdot[..., 0] + (-htp + opac * psi)
    dtl = k * dt[..., -2] - (LMAXT + 1) / tau_safe * dt[..., -1] \
        - opac * dt[..., -1]
    dtdot = torch.cat([dt0[..., None], dtdot[..., 1:-1], dtl[..., None]], -1)
    dpdot = ladder(dp, LMAXTP) - op * dp
    dp0 = dpdot[..., 0] + (-opac * psi)
    dpl = k * dp[..., -2] - (LMAXTP + 1) / tau_safe * dp[..., -1] \
        - opac * dp[..., -1]
    dpdot = torch.cat([dp0[..., None], dpdot[..., 1:-1], dpl[..., None]], -1)
    frozen = (tc_on | rsa)[..., None]
    dtdot = torch.where(frozen, 0.0, dtdot)
    dpdot = torch.where(frozen, 0.0, dpdot)
    dndot = ladder(dn, LMAXTN)
    dn0 = dndot[..., 0] + (-htp)
    dnl = k * dn[..., -2] - (LMAXTN + 1) / tau_safe * dn[..., -1]
    dndot = torch.cat([dn0[..., None], dndot[..., 1:-1], dnl[..., None]], -1)
    dndot = torch.where(rsa[..., None], 0.0, dndot)
    dy = torch.cat([htp[..., None], htpp[..., None], dtdot, dpdot, dndot], -1)
    return dy, torch.where(rsa, zero, psi)


def make_tensor_rhs(bg: BackgroundParams, tf: ThermoFuncs,
                    anisotropic_feedback: bool = True):
    """rhs(tau (C,), y (C, nk, NVAR_T), k (nk,)) -> (dy, psi)."""
    def rhs(tau, y, k):
        q = _stage_inputs(bg, tf, tau[:, None])[:, 0]
        return _tensor_rhs(y, q, k, anisotropic_feedback)
    return rhs


def _initial_state(C: int, nk: int, dtype, device) -> torch.Tensor:
    y0 = torch.zeros(C, nk, NVAR_T, dtype=dtype, device=device)
    y0[..., _I_HT] = 1.0
    return y0


def _evolve_t_plain(qtab: torch.Tensor, k: torch.Tensor, substeps: int,
                    feedback: bool) -> torch.Tensor:
    """RK4 over the grid as batched torch; returns (3, C, N-1, nk)."""
    C, S = qtab.shape[0], qtab.shape[1]
    y0 = _initial_state(C, k.shape[0], qtab.dtype, qtab.device)
    y = y0
    out = torch.empty(len(T_PLANES), C, S, k.shape[0], dtype=qtab.dtype,
                      device=qtab.device)
    with torch.no_grad():
        for i in range(S):
            for s in range(substeps):
                qa, qm, qb = (qtab[:, i, 3 * s], qtab[:, i, 3 * s + 1],
                              qtab[:, i, 3 * s + 2])
                dt = (qb[:, QT_TAU] - qa[:, QT_TAU])[:, None, None]
                k1, _ = _tensor_rhs(y, qa, k, feedback)
                k2, _ = _tensor_rhs(y + 0.5 * dt * k1, qm, k, feedback)
                k3, _ = _tensor_rhs(y + 0.5 * dt * k2, qm, k, feedback)
                k4, _ = _tensor_rhs(y + dt * k3, qb, k, feedback)
                y = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            qf = qtab[:, i, 3 * substeps]
            released = k * qf[:, QT_TAU:QT_TAU + 1] >= RELEASE_KTAU_T
            y = torch.where(released[..., None], y, y0)
            _, psi = _tensor_rhs(y, qf, k, feedback)
            vis, expmk = qf[:, QT_VIS:QT_VIS + 1], qf[:, QT_EXPMK:QT_EXPMK + 1]
            out[0, :, i] = -y[..., _I_HTP] * expmk + vis * psi
            out[1, :, i] = vis * psi
            out[2, :, i] = y[..., _I_HT]
    return out


def _evolve_t_cuda(qtab: torch.Tensor, k: torch.Tensor, substeps: int,
                   feedback: bool) -> torch.Tensor:
    """csrc/tensors.cu: one warp per (chain, k) lane, blocks of 8 lanes of
    one chain; h, h' on every thread, Dt_l and Dn_l on thread l, Dp_l on
    thread 17 + l, neighbours by warp shuffles; stage rows staged in shared
    memory a tile of steps ahead; the source evaluation at tau_b reused as
    the next step's first where the rows repeat.

    Replaces cosmomc_tpu/models/tensors.py:evolve_tensors (the lax.scan at
    tensors.py:254 over make_tensor_rhs and rk4_step). Bound: 4 RHS
    evaluations a step (~300 flops each) over ~8191 dependent steps: the
    dependency chain of a lane. Outputs go to (plane, chain, step, k)."""
    C, S, R = qtab.shape[0], qtab.shape[1], qtab.shape[2]
    nk = k.shape[0]
    if R != 3 * substeps + 1:
        raise ValueError(f"stage table has {R} rows, not 3*{substeps}+1")
    kernels.check(qtab, "qtab", (C, S, R, NQT))
    kernels.check(k, "k", (nk,), qtab.dtype)
    out = torch.empty(len(T_PLANES), C, S, nk, dtype=qtab.dtype,
                      device=qtab.device)
    kernels.launch("tensors", qtab.dtype, qtab, k, out, C, S, nk, substeps,
                   bool(feedback))
    return out


def evolve_tensors(bg: BackgroundParams, tf: ThermoFuncs, tau0: torch.Tensor,
                   k, anisotropic_feedback: bool = True,
                   substeps: int = 1) -> TensorOutput:
    """Evolve every tensor k lane of every chain on the shared tau grid and
    emit the LOS sources. ICs: h = 1, h' = 0, the hierarchies zero; a lane
    is held there until k tau >= 0.05. `substeps` sub-cycles each grid step
    (RK4 stability needs k dt / substeps <~ 2.8; 1 suffices for the
    production tensor grid, kmax 0.065)."""
    dtype, dev = tf.tau.dtype, tf.tau.device
    k = torch.as_tensor(np.asarray(k) if not torch.is_tensor(k) else k,
                        dtype=dtype, device=dev).contiguous()
    qtab = _stage_table(bg, tf, substeps)
    evolve = _evolve_t_plain if dev.type == "cpu" else _evolve_t_cuda
    raw = evolve(qtab, k, substeps, anisotropic_feedback)   # (3, C, N-1, nk)
    C, nk = tf.tau.shape[0], k.shape[0]
    first = torch.zeros(3, C, 1, nk, dtype=dtype, device=dev)
    first[2] = 1.0
    planes = torch.cat([first, raw], 2).transpose(2, 3)      # (3, C, nk, N)
    return TensorOutput(tau=tf.tau, k=k, sT=planes[0], sP=planes[1], tau0=tau0,
                        ht=planes[2])


def _k_stencil(lnk: torch.Tensor, lnkf: torch.Tensor):
    """jnp.interp's bracket and weight from the coarse ln k onto the fine:
    f = S[lo] + w (S[hi] - S[lo]), held at the end values outside."""
    n = lnk.shape[0]
    i = torch.searchsorted(lnk, lnkf.contiguous(), right=True).clamp(1, n - 1)
    w = (lnkf - lnk[i - 1]) / (lnk[i] - lnk[i - 1])
    lo, hi = i - 1, i.clone()
    below, above = lnkf < lnk[0], lnkf > lnk[-1]
    lo = torch.where(below, 0, torch.where(above, n - 1, lo))
    hi = torch.where(below, 0, torch.where(above, n - 1, hi))
    w = torch.where(below | above, 0.0, w)
    return lo.to(torch.int32), hi.to(torch.int32), w


def _tlos_plain(src, lo, hi, w, kf, chi, wt, jl_tab, jlp_tab, ls, inv_dx,
                k_chunk: int = 64):
    """Batched torch tensor LOS: src (C, 2, nk, N) -> (3, C, nl, nkf)."""
    C, N = chi.shape
    nl, nx = jl_tab.shape
    dtype = src.dtype
    jl_t, jlp_t = jl_tab.to(dtype), jlp_tab.to(dtype)
    out = torch.empty(3, C, nl, kf.shape[0], dtype=dtype, device=src.device)
    for k0 in range(0, kf.shape[0], k_chunk):
        sl = slice(k0, k0 + k_chunk)
        l_, h_, w_ = lo[sl].long(), hi[sl].long(), w[sl][:, None]

        def k_interp(S):                     # (C, nk, N) -> (C, kc, N)
            return S[:, l_] + w_ * (S[:, h_] - S[:, l_])
        STw = k_interp(src[:, 0]) * wt[:, None]
        SPw = k_interp(src[:, 1]) * wt[:, None]
        x = kf[sl][None, :, None] * chi[:, None, :]
        t = x * inv_dx
        i = t.to(torch.int64).clamp(0, nx - 2)
        f = t - i.to(dtype)
        xs = torch.clamp(x, min=1e-8)
        xs2 = xs * xs
        for il in range(nl):
            l = ls[il]
            jl = jl_t[il][i] * (1 - f) + jl_t[il][i + 1] * f
            jp = jlp_t[il][i] * (1 - f) + jlp_t[il][i + 1] * f
            jpp = -2.0 * jp / xs + (l * (l + 1) / xs2 - 1.0) * jl
            efac = torch.sqrt(torch.clamp((l + 2) * (l + 1) * l * (l - 1),
                                          min=0.0))
            out[0, :, il, sl] = efac * torch.sum(STw * jl / xs2, -1)
            wE = -jl + jpp + 2.0 * jl / xs2 + 4.0 * jp / xs
            wB = 2.0 * jp + 4.0 * jl / xs
            out[1, :, il, sl] = torch.sum(SPw * wE, -1)
            out[2, :, il, sl] = torch.sum(SPw * wB, -1)
    return out


def _tlos_cuda(src, lo, hi, w, kf, chi, wt, jl_tab, jlp_tab, ls, inv_dx,
               k_chunk: int = 64):
    """csrc/tensor_los.cu: one thread per (chain, fine k, 4 sampled l)
    reduces over every tau node, with the linear ln-k source interpolation,
    the j_l/j_l' table gathers, j_l'' and the three radial windows fused.

    Replaces cosmomc_tpu/models/tensors.py:compute_tensor_transfers (the
    lax.map over l at tensors.py:352). Bound: 65 l x 610 k x 8192 tau per
    chain (3.2e8 points), each two float32 table gathers (the 2.5 MB
    tables stay in L2) and ~40 flops. No atomics."""
    del k_chunk
    C, _, nk, N = src.shape
    nl, nx = jl_tab.shape
    nkf = kf.shape[0]
    dtype = src.dtype
    kernels.check(src, "sources", (C, 2, nk, N))
    kernels.check(lo, "k_lo", (nkf,), torch.int32)
    kernels.check(hi, "k_hi", (nkf,), torch.int32)
    for name, t in (("k_w", w), ("kf", kf)):
        kernels.check(t, name, (nkf,), dtype)
    for name, t in (("chi", chi), ("wt", wt)):
        kernels.check(t, name, (C, N), dtype)
    kernels.check(jl_tab, "jl", (nl, nx), torch.float32)
    kernels.check(jlp_tab, "jlp", (nl, nx), torch.float32)
    kernels.check(ls, "ls", (nl,), dtype)
    if nl % L_BATCH:
        raise ValueError(f"sampled l count {nl} not a multiple of {L_BATCH}")
    out = torch.empty(3, C, nl, nkf, dtype=dtype, device=src.device)
    kernels.launch("tensor_los", dtype, src, lo, hi, w, kf, chi, wt, jl_tab,
                   jlp_tab, ls, out, C, nk, N, nl, nx, nkf, float(inv_dx))
    return out


def compute_tensor_transfers(to: TensorOutput, lmax: int = 700,
                             tau0_hint: float = 14700.0,
                             kmax_hint: float = 0.065,
                             points_per_osc: float = 4.0) -> TensorTransferCache:
    """SLOW stage: tensor sources x Bessel (ZS97 window functions)."""
    dtype, dev = to.sT.dtype, to.sT.device
    ls = default_l_samples(lmax)
    ls_pad = np.concatenate([ls, np.full((-len(ls)) % L_BATCH, ls[-1])])
    tab = build_bessel_table(tuple(int(l) for l in ls_pad),
                             kmax_hint * tau0_hint * 1.02 + 10)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    kf = f(fine_k_grid(tau0_hint, kmax_hint, points_per_osc))
    lnkf = torch.log(kf)
    lo, hi, w = _k_stencil(torch.log(to.k), lnkf)
    taus = to.tau
    dt = taus[:, 1:] - taus[:, :-1]
    wt = torch.cat([dt[:, :1] / 2, (dt[:, 1:] + dt[:, :-1]) / 2, dt[:, -1:] / 2],
                   -1)
    dlnk = lnkf[1:] - lnkf[:-1]
    wk = torch.cat([dlnk[:1] / 2, (dlnk[1:] + dlnk[:-1]) / 2, dlnk[-1:] / 2])
    jl = torch.as_tensor(tab.jl, dtype=torch.float32, device=dev)
    jlp = torch.as_tensor(tab.jlp, dtype=torch.float32, device=dev)
    src = torch.stack([to.sT, to.sP], 1).contiguous()
    los = _tlos_plain if dev.type == "cpu" else _tlos_cuda
    out = los(src, lo, hi, w.contiguous(), kf, (to.tau0[:, None] - taus)
              .contiguous(), wt.contiguous(), jl, jlp, f(ls_pad),
              float(torch.tensor(1.0 / tab.dx, dtype=dtype)))
    nl = len(ls)
    return TensorTransferCache(f(ls), kf, wk, out[0, :, :nl], out[1, :, :nl],
                               out[2, :, :nl])


def tensor_cls_from_transfers(cache: TensorTransferCache, pp: PrimordialParams,
                              lmax: int = 700) -> TensorSpectra:
    """SEMI-SLOW stage: apply the tensor primordial power to the cache.

    NORM = 1/16 for TT/TE/EE/BB alike, derived in the JAX package from
    cmbmain.f90 CalcTensCls (C_l = (pi/4) ctnorm int dlnk P_T Delta^2, with
    ctnorm inside dT as efac)."""
    dtype = cache.dT.dtype
    wP = (cache.wk * tensor_power(pp, cache.kf)).to(dtype)[:, None, :]
    tts = 4.0 * torch.pi * torch.sum(wP * cache.dT * cache.dT, -1)
    tes = 4.0 * torch.pi * torch.sum(wP * cache.dT * cache.dE, -1)
    ees = 4.0 * torch.pi * torch.sum(wP * cache.dE * cache.dE, -1)
    bbs = 4.0 * torch.pi * torch.sum(wP * cache.dB * cache.dB, -1)
    ls_f = cache.ls
    fac = ls_f * (ls_f + 1) / (2 * torch.pi)
    all_l = torch.arange(2, lmax + 1, dtype=dtype, device=ls_f.device)

    def fill(vals):
        return spline_eval(spline_fit(ls_f, vals), all_l)
    NORM = 1.0 / 16.0
    return TensorSpectra(all_l.to(torch.int32), NORM * fill(fac * tts),
                         NORM * fill(fac * tes), NORM * fill(fac * ees),
                         NORM * fill(fac * bbs))

