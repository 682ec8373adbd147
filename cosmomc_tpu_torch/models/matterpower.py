"""HALOFIT (Takahashi 2012) and the nonlinear lensing-source ratio.

Port of the halofit subset of cosmomc_tpu/models/matterpower.py
(camb/halofit_ppf.f90 halofit_takahashi; cmbmain.f90 MakeNonlinearSources
with NonLinear_Lens): the multiplier sqrt(P_NL/P_lin)(k, z) that the CMB
pipeline applies to the lensing-potential source before the line-of-sight
integral. Batched over chains: background fields are (C,), transfers
(C, nz, nk). The sigma^2(R) = 1 scale is found by a fixed 48-step
bisection in ln R on (C, nz) tensors, as the H0 and z_re bisections are.
No kernel: the work is ~48 trapezoid sums over ~270 k per (chain, z).

Linear P(k,z), sigma8 and the matter-power tables (the rest of the JAX
module) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.perturbations import grho_terms
from cosmomc_tpu_torch.models.primordial import PrimordialParams, scalar_power
from cosmomc_tpu_torch.utils.interp import trapezoid

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
