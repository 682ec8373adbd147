"""Matter power P(k, z), sigma8(z), f sigma8(z), sigma_R, and the HALOFIT
(Takahashi 2012) nonlinear correction.

Port of cosmomc_tpu/models/matterpower.py (camb/modules.f90 Transfer
module, camb/halofit_ppf.f90, source/CosmoTheory.f90 TCosmoTheoryPK),
batched over chains: background fields are (C,), transfers and tables
(C, nz, nk), sigma8(z) and f sigma8(z) (C, nz); the k and z grids are
shared by every chain.

  - `compute_matter_transfers` (slow stage): Boltzmann evolution (kernel
    K1) on the wide matter k grid to 8/Mpc, from a recombination history
    and reionization redshift computed once by the caller;
  - `matter_power_from_transfers` (semi-slow stage): primordial power on
    the cached transfers -> linear and halofit ln P, the Weyl power,
    sigma8(z) and f sigma8(z) = sigma^2_vd / sigma_dd;
  - `power_at`: bilinear in (ln k, z), log-linear past the table to
    EXTRAP_KMAX; `sigma_r`: the tophat sigma(R);
  - `lensing_nl_ratio`: sqrt(P_NL/P_lin)(k, z) on the CMB source k grid.

No kernel of its own beyond K1: the sigma^2(R) = 1 scale of halofit is
found by a fixed 48-step bisection in ln R on (C, nz) tensors, as the H0
and z_re bisections are, and the rest is trapezoid sums over ~220 k.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.perturbations import (build_thermo_funcs,
                                                    evolve_perturbations,
                                                    grho_terms)
from cosmomc_tpu_torch.models.primordial import PrimordialParams, scalar_power
from cosmomc_tpu_torch.models.recfast import ThermoHistory
from cosmomc_tpu_torch.utils.interp import trapezoid

#: log-linear extrapolation above the computed kmax reaches this k (1/Mpc)
#: (CosmoTheory.f90:20 extrap_kmax)
EXTRAP_KMAX = 700.0

#: redshift nodes for the CMB-lensing nonlinear scaling (dense at low z
#: where the halofit boost grows; ratio -> 1 above z ~ 10)
LENS_NL_Z = (0.0, 0.25, 0.5, 0.8, 1.2, 1.7, 2.3, 3.0, 4.0, 5.5, 7.5, 10.0)

N_BISECT = 48


def _power_from_transfer(pp: PrimordialParams, k: torch.Tensor,
                         transfer: torch.Tensor) -> torch.Tensor:
    """P(k) = (2 pi^2 / k^3) P_R(k) T(k)^2; k (nk,), transfer (C, ..., nk)."""
    pr = scalar_power(pp, k)                       # (C, nk)
    pr = pr.reshape(pr.shape[:1] + (1,) * (transfer.dim() - 2) + pr.shape[1:])
    return (2.0 * torch.pi ** 2) / k ** 3 * pr * transfer ** 2


def matter_k_grid(kmax: float = 8.0, kmin: float = 1e-4,
                  nk_log_lo: int = 40, nk_lin: int = 120,
                  nk_log_hi: int = 56, k_lin_lo: float = 0.012,
                  k_lin_hi: float = 0.35) -> np.ndarray:
    """k grid (1/Mpc) for the matter transfers (host numpy): log through
    horizon scales, linear through the BAO wiggles (~8 points a period),
    log to kmax."""
    lo = np.exp(np.linspace(np.log(kmin), np.log(k_lin_lo), nk_log_lo,
                            endpoint=False))
    mid = np.linspace(k_lin_lo, k_lin_hi, nk_lin, endpoint=False)
    hi = np.exp(np.linspace(np.log(k_lin_hi), np.log(kmax), nk_log_hi))
    return np.concatenate([lo, mid, hi])


class MatterTransfers(NamedTuple):
    """Primordial-power-independent matter transfers: the slow-stage cache
    of `matter_power_from_transfers`. z ascending, k in 1/Mpc."""
    k: torch.Tensor          # (nk,) shared
    z: torch.Tensor          # (nz,) shared
    delta_m_z: torch.Tensor  # (C, nz, nk) matter transfer per unit curvature
    weyl_z: torch.Tensor     # (C, nz, nk)
    v_z: torch.Tensor        # (C, nz, nk) velocity transfer d delta / d ln a
    h: torch.Tensor          # (C,)


class MatterPower(NamedTuple):
    """P(k, z) tables: z ascending, k ascending (1/Mpc), P in Mpc^3."""
    k: torch.Tensor          # (nk,) shared
    z: torch.Tensor          # (nz,) shared
    lnP: torch.Tensor        # (C, nz, nk) linear ln P_m
    lnP_nl: torch.Tensor     # (C, nz, nk) halofit ln P_m
    lnP_weyl: torch.Tensor   # (C, nz, nk) ln P of k^2 (phi + psi)/2
    sigma8_z: torch.Tensor   # (C, nz)
    fsigma8_z: torch.Tensor  # (C, nz) sigma^2_vd / sigma_dd at R = 8/h Mpc
    h: torch.Tensor          # (C,)


def _sigma_tophat(k: torch.Tensor, delta2: torch.Tensor,
                  R: torch.Tensor) -> torch.Tensor:
    """sigma^2(R) = int dln k Delta^2(k) W^2(kR) with the tophat window;
    delta2 (..., nk), R broadcastable to delta2's leading axes."""
    x = k * torch.as_tensor(R, dtype=delta2.dtype, device=delta2.device)[..., None]
    # the stable small-x form of 3 j1(x)/x
    w = torch.where(x < 1e-3, 1.0 - x ** 2 / 10.0,
                    3.0 * (torch.sin(x) - x * torch.cos(x))
                    / torch.clamp(x, min=1e-30) ** 3)
    return trapezoid(delta2 * w ** 2, torch.log(k))


def compute_matter_transfers(bg: BackgroundParams, th: ThermoHistory,
                             zre: torch.Tensor, yhe: torch.Tensor,
                             z_outputs: Sequence[float] = (0.0,),
                             k: Optional[np.ndarray] = None,
                             n_step: int = 6144, massive_nu: bool = False,
                             de_perts: bool = False,
                             remat_chunks: int = 0) -> MatterTransfers:
    """Slow stage: Boltzmann evolution (K1) on the wide matter k grid, from
    the recombination history `th` and reionization redshift `zre` the
    caller computed once per slow step. `remat_chunks` checkpoints the
    evolution's gradient (evolve_perturbations)."""
    zs = tuple(float(z) for z in z_outputs)
    if list(zs) != sorted(zs):
        raise ValueError("z_outputs must be ascending")
    if k is None:
        k = matter_k_grid()
    tf, tau0 = build_thermo_funcs(bg, yhe, th, zre, n_step=n_step,
                                  kmax=float(np.max(k)))
    kt = torch.as_tensor(np.asarray(k), dtype=tf.tau.dtype, device=tf.tau.device)
    po = evolve_perturbations(bg, tf, tau0, kt, zs, massive_nu=massive_nu,
                              de_perts=de_perts, remat_chunks=remat_chunks)
    v_z = po.ddelta_m_z / po.aH_z[:, :, None]
    return MatterTransfers(po.k, torch.tensor(zs, dtype=po.k.dtype,
                                              device=po.k.device),
                           po.delta_m_z, po.weyl_z, v_z, bg.H0 / 100.0)


def compute_matter_power(bg: BackgroundParams, pp: PrimordialParams,
                         th: ThermoHistory, zre: torch.Tensor,
                         yhe: torch.Tensor,
                         z_outputs: Sequence[float] = (0.0,),
                         k: Optional[np.ndarray] = None, n_step: int = 6144,
                         nonlinear: bool = True, massive_nu: bool = False,
                         de_perts: bool = False) -> MatterPower:
    """Transfers on the wide k grid -> linear P(k, z) -> sigma8 and
    f sigma8 -> halofit; z_outputs ascending."""
    mt = compute_matter_transfers(bg, th, zre, yhe, z_outputs, k, n_step,
                                  massive_nu=massive_nu, de_perts=de_perts)
    return matter_power_from_transfers(bg, pp, mt, nonlinear=nonlinear)


def matter_power_from_transfers(bg: BackgroundParams, pp: PrimordialParams,
                                mt: MatterTransfers,
                                nonlinear: bool = True) -> MatterPower:
    """Semi-slow stage: primordial power on the cached transfers -> P(k, z),
    sigma8(z), f sigma8(z) (CAMB Transfer_GetSigmaVdelta8, the velocity
    d delta / d ln a cached by the slow stage), halofit."""
    k = mt.k
    h = bg.H0 / 100.0
    P = _power_from_transfer(pp, k, mt.delta_m_z)              # (C, nz, nk)
    lnP = torch.log(torch.clamp(P, min=1e-300))
    # Weyl: P of k^2 (phi + psi)/2 (the reference's MPK_WEYL convention,
    # Calculator_CAMB.f90:465-545)
    lnPw = torch.log(torch.clamp(_power_from_transfer(pp, k, k ** 2 * mt.weyl_z),
                                 min=1e-300))
    R8 = (8.0 / h)[:, None]
    d2 = k ** 3 / (2.0 * torch.pi ** 2) * P
    sigma8 = torch.sqrt(_sigma_tophat(k, d2, R8))
    Pvd = (2.0 * torch.pi ** 2) / k ** 3 * scalar_power(pp, k)[:, None] \
        * mt.delta_m_z * mt.v_z
    sig2_vd = _sigma_tophat(k, k ** 3 / (2.0 * torch.pi ** 2) * Pvd, R8)
    z = mt.z.to(lnP.dtype)
    lnP_nl = halofit_takahashi(bg, k, lnP, z) if nonlinear else lnP
    return MatterPower(k, z, lnP, lnP_nl, lnPw, sigma8, sig2_vd / sigma8, h)


# ---------------------------------------------------------------------------
# HALOFIT (Takahashi et al. 2012, arXiv:1208.2701): the reference's default
# nonlinear model (halofit_ppf.f90:56)
# ---------------------------------------------------------------------------

def _gauss_sigma2(lnk: torch.Tensor, d2: torch.Tensor, lnR: torch.Tensor):
    """sigma^2(R) with the Gaussian window exp(-k^2 R^2) and its first two
    ln R derivatives by the same quadrature; d2 (..., nk), lnR (...)."""
    k = torch.exp(lnk)
    x2 = (k * torch.exp(lnR)[..., None]) ** 2
    w = torch.exp(-x2)
    s2 = trapezoid(d2 * w, lnk)
    ds2 = trapezoid(d2 * (-2.0 * x2) * w, lnk)
    dds2 = trapezoid(d2 * (4.0 * x2 ** 2 - 4.0 * x2) * w, lnk)
    return s2, ds2, dds2


def halofit_takahashi(bg: BackgroundParams, k: torch.Tensor,
                      lnP_lin: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Nonlinear ln P(k, z) from linear (Takahashi 2012, with the w0
    dependence): k (nk,), lnP_lin (C, nz, nk), z (nz,) -> (C, nz, nk)."""
    dtype = lnP_lin.dtype
    lnk = torch.log(k)
    d2 = k ** 3 / (2.0 * torch.pi ** 2) * torch.exp(lnP_lin)
    C, nz = lnP_lin.shape[0], lnP_lin.shape[1]
    a = (1.0 / (1.0 + z)).expand(C, nz)
    grho_g, grho_n, grho_num, _gp, grho_c, grho_b, grho_de, grho_k = \
        grho_terms(bg, a)
    # massive neutrinos count as matter in Omega_m(z) (CAMB halofit)
    grho_m = grho_c + grho_b + grho_num
    grho_tot = grho_g + grho_n + grho_m + grho_de + grho_k
    omm = grho_m / grho_tot
    omv = grho_de / grho_tot
    wde = bg.w[:, None] + bg.wa[:, None] * (1.0 - a)

    # k_sigma: sigma^2(1/k_sigma) = 1, sigma^2 decreasing in R
    lo = torch.full((C, nz), float(np.log(1e-4)), dtype=dtype, device=k.device)
    hi = torch.full((C, nz), float(np.log(1e3)), dtype=dtype, device=k.device)
    for _ in range(N_BISECT):
        mid = 0.5 * (lo + hi)
        grow = _gauss_sigma2(lnk, d2, mid)[0] > 1.0
        lo, hi = torch.where(grow, mid, lo), torch.where(grow, hi, mid)
    lnR = 0.5 * (lo + hi)
    s2, ds2, dds2 = _gauss_sigma2(lnk, d2, lnR)
    dln = ds2 / s2
    # clamps to the fit's domain (inactive in the physical regime, where
    # n_eff ~ -2.5..-1 and C ~ 0.2-1; they keep 10**(...) finite when the
    # sigma^2 = 1 scale is not bracketed)
    neff = torch.clamp(-3.0 - dln, -3.8, 1.5)
    Cc = torch.clamp(-(dds2 / s2 - dln ** 2), -3.0, 3.0)
    ksig = torch.exp(-lnR)

    # Takahashi 2012 eqs (A6-A13)
    n2, n3, n4 = neff ** 2, neff ** 3, neff ** 4
    an = 10.0 ** (1.5222 + 2.8553 * neff + 2.3706 * n2 + 0.9903 * n3
                  + 0.2250 * n4 - 0.6038 * Cc + 0.1749 * omv * (1.0 + wde))
    bn = 10.0 ** (-0.5642 + 0.5864 * neff + 0.5716 * n2 - 1.5474 * Cc
                  + 0.2279 * omv * (1.0 + wde))
    cn = 10.0 ** (0.3698 + 2.0404 * neff + 0.8161 * n2 + 0.5869 * Cc)
    gam = 0.1971 - 0.0843 * neff + 0.8460 * Cc
    alpha = torch.abs(6.0835 + 1.3373 * neff - 0.1959 * n2 - 5.5274 * Cc)
    beta = (2.0379 - 0.7354 * neff + 0.3157 * n2 + 1.2490 * n3
            + 0.3980 * n4 - 0.1682 * Cc)
    mu = 0.0
    nu = 10.0 ** (5.2105 + 3.6902 * neff)
    # flat vs open corrections (Takahashi A14; CAMB frac = omv/(1-omm))
    f1a, f2a, f3a = omm ** -0.0732, omm ** -0.1423, omm ** 0.0725
    f1b, f2b, f3b = omm ** -0.0307, omm ** -0.0585, omm ** 0.0743
    frac = omv / torch.clamp(1.0 - omm, min=1e-10)
    f1 = frac * f1b + (1.0 - frac) * f1a
    f2 = frac * f2b + (1.0 - frac) * f2a
    f3 = frac * f3b + (1.0 - frac) * f3a

    e = lambda v: v[..., None]
    y = k / e(ksig)
    fy = y / 4.0 + y ** 2 / 8.0
    d2q = d2 * ((1.0 + d2) ** e(beta) / (1.0 + e(alpha) * d2)) * torch.exp(-fy)
    d2hp = e(an) * y ** (3.0 * e(f1)) / (1.0 + e(bn) * y ** e(f2)
                                         + (e(cn) * e(f3) * y) ** (3.0 - e(gam)))
    d2h = d2hp / (1.0 + mu / y + e(nu) / y ** 2)
    # additive floor, not max(): keeps d log / d d2nl bounded where d2nl
    # underflows
    return torch.log((d2q + d2h + 1e-30) * (2.0 * torch.pi ** 2) / k ** 3)


def lensing_nl_ratio(bg: BackgroundParams, pp_fid: PrimordialParams,
                     k_coarse: torch.Tensor, dm_z: torch.Tensor,
                     z_nodes) -> torch.Tensor:
    """sqrt(P_NL/P_lin)(k, z) on the source k grid at `z_nodes`: (C, nz, nk).

    `dm_z` (C, nz, nk) are the matter transfers per unit curvature from the
    CMB evolution; `pp_fid` is a fixed fiducial primordial spectrum, so the
    slow transfer cache stays independent of the semi-slow parameters.
    The sigma^2 integrals need P(k) beyond the source kmax: the spectrum
    gets a 24-node power-law tail to 8 k_max, its slope from the last 16
    coarse k."""
    dtype = dm_z.dtype
    z = torch.as_tensor(np.asarray(z_nodes, np.float64), dtype=dtype,
                        device=dm_z.device)
    P = _power_from_transfer(pp_fid, k_coarse, dm_z)
    lnP = torch.log(P + 1e-120)    # additive floor, as in halofit
    lnk = torch.log(k_coarse)
    n_tail = 16
    slope = (lnP[..., -1] - lnP[..., -n_tail]) / (lnk[-1] - lnk[-n_tail])
    k_ext = torch.as_tensor(np.exp(np.linspace(np.log(1.03), np.log(8.0), 24)),
                            dtype=dtype, device=dm_z.device) * k_coarse[-1]
    lnP_ext = lnP[..., -1:] + slope[..., None] * (torch.log(k_ext) - lnk[-1])
    k_all = torch.cat([k_coarse, k_ext])
    lnP_all = torch.cat([lnP, lnP_ext], -1)
    lnP_nl = halofit_takahashi(bg, k_all, lnP_all, z)
    nk = k_coarse.shape[0]
    return torch.exp(0.5 * (lnP_nl[..., :nk] - lnP_all[..., :nk]))


# ---------------------------------------------------------------------------
# Evaluation (the reference's TCosmoTheoryPK.PowerAt, CosmoTheory.f90:56-77,
# with log-linear high-k extrapolation :103-132)
# ---------------------------------------------------------------------------

def _per_chain_queries(x, ref: torch.Tensor) -> torch.Tensor:
    """A query (float, (n,) or (C, n)) as a (1 or C, n) tensor."""
    x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return x.reshape((1,) * (2 - x.dim()) + x.shape) if x.dim() < 2 else x


def power_at(mp: MatterPower, kq, zq, nonlinear: bool = False,
             weyl: bool = False) -> torch.Tensor:
    """P(kq, zq) in Mpc^3 by bilinear interpolation in (ln k, z), log-linear
    in ln k past the table (to EXTRAP_KMAX). kq (1/Mpc) and zq are floats,
    (n,) tensors asked of every chain, or (C, n) tensors; the result is
    (C, n)."""
    tab = mp.lnP_weyl if weyl else (mp.lnP_nl if nonlinear else mp.lnP)
    C, nz, nk = tab.shape
    lnk = torch.log(mp.k)
    kq = _per_chain_queries(kq, tab)
    zq = _per_chain_queries(zq, tab)
    shape = torch.broadcast_shapes(kq.shape, zq.shape, (C, 1))
    lnkq = torch.log(kq).expand(shape)
    zq = zq.expand(shape)
    # clamp into the table and keep the overshoot for the extrapolation
    over = torch.clamp(lnkq - lnk[-1], min=0.0)
    lnkq = torch.clamp(lnkq, lnk[0], lnk[-1])
    if nz == 1:
        iz = torch.zeros(shape, dtype=torch.int64, device=tab.device)
        tz = torch.zeros_like(zq)
    else:
        iz = (torch.searchsorted(mp.z, zq.contiguous(), right=True) - 1
              ).clamp(0, nz - 2)
        z0 = mp.z[iz]
        dz = torch.clamp(mp.z[iz + 1] - z0, min=1e-10)
        tz = torch.clamp((zq - z0) / dz, 0.0, 1.0)
    # jnp.interp in ln k on the two z rows of each query
    ik = torch.searchsorted(lnk, lnkq.contiguous(), right=True).clamp(1, nk - 1)
    row = (torch.arange(C, device=tab.device)[:, None] * nz + iz) * nk
    flat = tab.reshape(-1)
    frac = (lnkq - lnk[ik - 1]) / (lnk[ik] - lnk[ik - 1])

    def at(r):
        lo = flat[r + ik - 1]
        return lo + frac * (flat[r + ik] - lo)
    slope = ((tab[..., -1] - tab[..., -2]) / (lnk[-1] - lnk[-2])).reshape(-1)
    srow = torch.arange(C, device=tab.device)[:, None] * nz + iz
    if nz == 1:
        v, sl = at(row), slope[srow]
    else:
        v = at(row) * (1.0 - tz) + at(row + nk) * tz
        sl = slope[srow] * (1.0 - tz) + slope[srow + 1] * tz
    return torch.exp(v + sl * over)


def sigma_r(mp: MatterPower, R, z_index: int = 0) -> torch.Tensor:
    """sigma(R) (tophat, R in Mpc: a float or (C,)) at table redshift
    `z_index`: (C,)."""
    d2 = mp.k ** 3 / (2.0 * torch.pi ** 2) * torch.exp(mp.lnP[:, z_index])
    return torch.sqrt(_sigma_tophat(mp.k, d2, R))
