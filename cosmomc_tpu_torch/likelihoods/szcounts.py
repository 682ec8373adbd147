"""Planck 2015 SZ cluster-counts likelihood, dN/dz and dN/dz/dq (port of
cosmomc_tpu/likelihoods/szcounts.py; reference source/szcounts.f90, Planck
2015 XXIV).

  - catalogue and selection-function loading, binned catalogue counts with
    missing-redshift rescaling            (szcounts.f90:1501-1821 SZ_init)
  - Tinker (default) / Watson mass functions with the reference's
    hard-coded spline tables in log10(Delta)   (szcounts.f90:366-560)
  - Y500/theta500 scaling relations with the hydrostatic bias
                                           (szcounts.f90:221-243)
  - erf completeness with log-normal scatter in the y-m relation, summed
    over sky patches                       (szcounts.f90:872-1315)
  - the Poisson (Cash) statistic over (z, q) bins  (szcounts.f90:1825-1975)

The per-patch erf tables depend only on the y grid, the noise maps and the
fixed S/N bins, so they are built once in float64 numpy at load into
E[lny, theta, qbin]; the parameter-dependent completeness is one matmul
G[(m, z), lny] @ E[lny, (theta, qbin)] followed by a linear interpolation
in theta, and the z-bin integral a second static-weight product.

Per chain in float64, G is 120 m x 282 z x 430 lny (116 MB) and the product
108 MB, so the chains are evaluated in blocks of `chain_block` (each
chain's arithmetic unchanged) to bound the peak whatever the chain count.
The ln sigma(R) spline is fitted on fixed knots, so its second
derivatives are one product with an operator built at load.

The JAX package's deliberate deviations from the Fortran (exact c, the full
background E(z), the growth from the sigma8(z) table, the scatter
convolution always on, the reference's prior switches as Gaussian priors)
hold here too. Fixed nuisance parameters (beta_SZ by default) take their
centres: the likelihood reads the varying columns it is given.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
from scipy.special import erf as nperf

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood
from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models.theory import in_dtype
from cosmomc_tpu_torch.params.space import Param, Speed
from cosmomc_tpu_torch.utils.interp import (Spline, linspace, spline_eval,
                                            spline_eval_deriv, spline_fit,
                                            trapezoid)

# -- fixed survey configuration (szcounts.f90:1522-1551) ---------------------
Q_THRESHOLD = 6.0          # catalogue S/N cut (szcounts.f90:218)
Z0, ZMAX, DZ = 0.0, 1.0, 0.1
LOGY_MIN, LOGY_MAX, DLOGY = 0.7, 1.5, 0.25
LNM_MIN, LNM_MAX, DLNM = 31.0, 37.0, 0.05
LNY_MIN, LNY_MAX, DLNY = -11.5, 10.0, 0.05
DELTA_SO = 500.0           # mass definition Delta_c (szcounts.f90:1523)
FULL_SKY_SR = 3.046174198e-4 * 41253.0   # szcounts.f90:1527,1547
RHOCRIT0 = 2.7751973751261264e11         # h^2 Msun / Mpc^3 (szcounts.f90:47)

# Tinker 2008 table + the reference's hard-coded natural-spline second
# derivatives in log10(Delta) (szcounts.f90:385-468)
_TINKER_LOGD = np.log10(np.array(
    [200., 300., 400., 600., 800., 1200., 1600., 2400., 3200.]))
_TINKER_Y = np.array([
    [0.186, 0.200, 0.212, 0.218, 0.248, 0.255, 0.260, 0.260, 0.260],   # A
    [1.47, 1.52, 1.56, 1.61, 1.87, 2.13, 2.30, 2.53, 2.66],            # a
    [2.57, 2.25, 2.05, 1.87, 1.59, 1.51, 1.46, 1.44, 1.41],            # b
    [1.19, 1.27, 1.34, 1.45, 1.58, 1.80, 1.97, 2.24, 2.44]])           # c
_TINKER_Y2 = np.array([
    [0.00, 0.50, -1.56, 3.05, -2.95, 1.07, -0.71, 0.21, 0.00],
    [0.00, 1.19, -6.34, 21.36, -10.95, 2.59, -0.85, -2.07, 0.00],
    [0.00, -1.08, 12.61, -20.96, 24.08, -6.64, 3.84, -2.09, 0.00],
    [0.00, 0.94, -0.43, 4.61, 0.01, 1.21, 1.43, 0.33, 0.00]])

# scaling-relation constants (szcounts.f90:216-218, 1855-1859)
THETA_STAR = 6.997
YSTAR_NORM = 0.00472724

# reference prior switches -> (param, mean, std) (szcounts.f90:1950-1972)
PRIOR_SWITCHES = {
    "prior_ystar_SZ":   ("ystar_SZ",   -0.186,    0.021),
    "prior_alpha_SZ":   ("alpha_SZ",    1.789,    0.084),
    "prior_scatter_SZ": ("scatter_SZ",  0.075,    0.01),
    "prior_beta_SZ":    ("beta_SZ",     2.0 / 3.0, 0.5),
    "prior_wtg":        ("bias_SZ",     0.688,    0.072),
    "prior_cccp":       ("bias_SZ",     0.780,    0.092),
}

# nuisance defaults: center min max start_width propose_width
_NUISANCE_DEFAULTS = {
    "alpha_SZ":   (1.789, 1.0, 2.6, 0.05, 0.05),
    "ystar_SZ":   (-0.186, -0.5, 0.1, 0.01, 0.01),
    "bias_SZ":    (0.80, 0.1, 1.5, 0.05, 0.05),
    "scatter_SZ": (0.075, 0.02, 0.3, 0.005, 0.005),
    "beta_SZ":    (0.6666666, 0.0, 3.0, 0.0, 0.0),   # fixed by default
}
_NUISANCE_LABELS = {
    "alpha_SZ": r"\alpha_{SZ}", "ystar_SZ": "y_{*}", "bias_SZ": "B_{SZ}",
    "scatter_SZ": r"\sigma_{SZ}", "beta_SZ": r"\beta_{SZ}",
}

#: the ln R grid (h^-1 Mpc) of the sigma(R) spline
_N_LNR = 64
#: the peak bytes one block of chains may take in theory_counts: about six
#: (m, z, lny) float64 planes a chain are live at once
BLOCK_BYTES = 4e9


def _fine_z_steps() -> np.ndarray:
    """The adaptive z grid of deltaN_yz: 1e-3 spacing below z=0.2, 1e-2 to
    z=1, then the bin width above (szcounts.f90:601-615 next_z +
    :658-695); the float accumulation gives the 282 nodes."""
    min_z = (Z0 + 0.5 * DZ) - 0.5 * DZ      # = Z(1)-binz/2 ~ 0
    max_z = (ZMAX + 0.5 * DZ) + 0.5 * DZ    # = Z(Nz)+binz/2
    zi = max(min_z, 0.0) + 1e-8
    steps = []
    while True:
        steps.append(zi)
        if zi > max_z:
            break
        dzi = 1e-3 if zi < 0.2 else (1e-2 if zi <= 1.0 else DZ)
        zi = zi + dzi
    out = np.array(steps)
    if out[0] <= 0:
        out[0] = 1e-5
    return out


def _splint_fixed_y2(xa: torch.Tensor, ya: torch.Tensor, y2a: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Numerical Recipes SPLINT with supplied second derivatives
    (szcounts.f90:563-584), elementwise in x."""
    i = (torch.searchsorted(xa, x.contiguous(), right=True) - 1
         ).clamp(0, xa.shape[0] - 2)
    h = xa[i + 1] - xa[i]
    a = (xa[i + 1] - x) / h
    b = (x - xa[i]) / h
    return (a * ya[i] + b * ya[i + 1]
            + ((a ** 3 - a) * y2a[i] + (b ** 3 - b) * y2a[i + 1])
            * h ** 2 / 6.0)


class SZCountsLikelihood(Likelihood):
    """Planck SZ cluster number counts (use_SZ, szcounts.f90)."""

    kind = "SZ"
    speed = Speed.SLOW
    needs_matter_power = True
    required_zmax = 1.2

    def __init__(self, data_dir: str, name: str = "SZ", switch: int = 2,
                 mass_function: str = "tinker",
                 priors: Optional[dict] = None, catalogue: str = "SZ_cat.txt",
                 chain_block: Optional[int] = None, device="cuda",
                 dtype=torch.float64):
        """switch: 1 = dN/dz, 2 = dN/dz/dq (reference '1D'/'2D' ini keys,
        default 2, szcounts.f90:1423-1442). `priors` maps the reference's
        switch names (PRIOR_SWITCHES) to bool. `chain_block` is the chains
        evaluated at once (default: as many as BLOCK_BYTES allows)."""
        self.device = kernels.entry_device(device, "SZCountsLikelihood")
        super().__init__(name)
        self.dtype = dtype
        self.switch = int(switch)
        if mass_function not in ("tinker", "watson"):
            raise ValueError(f"unknown mass function {mass_function}")
        self.mass_function = mass_function

        cat = np.loadtxt(os.path.join(data_dir, catalogue))   # z, zerr, q
        cat = cat[cat[:, 2] >= Q_THRESHOLD]
        self.thetas = np.loadtxt(os.path.join(data_dir, "SZ_thetas.txt"))
        self.skyfracs = np.loadtxt(os.path.join(data_dir, "SZ_skyfracs.txt"))
        ylims_flat = np.loadtxt(os.path.join(data_dir, "SZ_ylims.txt"))
        npatch, ntheta = len(self.skyfracs), len(self.thetas)
        if ylims_flat.size != npatch * ntheta:
            raise ValueError("SZ_ylims.txt row count != npatches*nthetas")
        # file order: patch-fastest, theta outer (szcounts.f90:1634-1646)
        self.ylims = ylims_flat.reshape(ntheta, npatch).T   # (patch, theta)
        self.fsky = float(self.skyfracs.sum())

        # bin centers (szcounts.f90:1548-1568)
        self.nz = int((ZMAX - Z0) / DZ) + 1
        self.ny = int((LOGY_MAX - LOGY_MIN) / DLOGY) + 1      # + open bin
        self.z_centers = Z0 + (np.arange(self.nz) + 0.5) * DZ
        self.logy_centers = LOGY_MIN + (np.arange(self.ny + 1) + 0.5) * DLOGY

        self._bin_catalogue(cat)

        # static grids
        self.steps_z = _fine_z_steps()
        nm = int(round((LNM_MAX - LNM_MIN) / DLNM))
        self.steps_m = LNM_MIN + (np.arange(nm) + 0.5) * DLNM
        self.lny = np.arange(int((LNY_MAX - LNY_MIN) / DLNY)) * DLNY + LNY_MIN

        self._build_erf_tables()
        self._build_zbin_weights()

        # nuisance registration (data/SZ.paramnames order is the
        # DataParams order, szcounts.f90:1855-1861)
        for pname, spec in _NUISANCE_DEFAULTS.items():
            self.nuisance.append(Param(pname, *spec,
                                       label=_NUISANCE_LABELS[pname],
                                       speed=Speed.FAST))
        for sw, on in (priors or {}).items():
            if not on:
                continue
            pname, mean, std = PRIOR_SWITCHES[sw]
            for p in self.nuisance:
                if p.name == pname:
                    p.prior_mean, p.prior_std = mean, std

        plane = len(self.steps_m) * len(self.steps_z) * len(self.lny) \
            * torch.finfo(dtype).bits // 8
        self.chain_block = chain_block or max(1, int(BLOCK_BYTES // (6 * plane)))
        self._to_device()

    # ------------------------------------------------------------------
    # static setup (host-side, float64 numpy)
    # ------------------------------------------------------------------

    def _bin_catalogue(self, cat: np.ndarray) -> None:
        """Catalogue counts per (z, q) bin with missing-redshift rescaling
        (szcounts.f90:1683-1816); z < 0 flags a missing redshift."""
        nz, ny = self.nz, self.ny
        zlo = Z0 + np.arange(nz) * DZ
        qlo = 10.0 ** (self.logy_centers - 0.5 * DLOGY)
        qhi = 10.0 ** (self.logy_centers + 0.5 * DLOGY)
        dncat = np.zeros((nz, ny + 1))
        for i in range(nz):
            inz = (cat[:, 0] >= zlo[i]) & (cat[:, 0] < zlo[i] + DZ)
            for j in range(ny):
                dncat[i, j] = np.sum(inz & (cat[:, 2] >= qlo[j])
                                     & (cat[:, 2] < qhi[j]))
            dncat[i, ny] = np.sum(inz & (cat[:, 2] >= qhi[ny - 1]))
        # missing redshifts: per missing cluster, scale its q-column so the
        # column total grows by one (szcounts.f90:1769-1797)
        missing = cat[cat[:, 0] < 0]
        for row in missing:
            for j in range(ny):
                if qlo[j] <= row[2] < qhi[j]:
                    tot = dncat[:, j].sum()
                    if tot > 0:
                        dncat[:, j] *= (tot + 1.0) / tot
            if row[2] >= qhi[ny - 1]:
                tot = dncat[:, ny].sum()
                if tot > 0:
                    dncat[:, ny] *= (tot + 1.0) / tot
        self.ncat = len(cat)
        self.nmiss = len(missing)
        self.dncat_zq = dncat
        # 1D counts: rescale for missing redshifts (szcounts.f90:1889-1893)
        dnz = np.zeros(nz)
        for i in range(nz):
            dnz[i] = np.sum((cat[:, 0] >= zlo[i]) & (cat[:, 0] < zlo[i] + DZ))
        nred = self.ncat - self.nmiss
        self.dncat_z = dnz * (self.ncat / max(nred, 1))

        # Poisson log-factorials of the (fractional) catalogue counts:
        # Stirling above 10, exact factorial below (szcounts.f90:1896-1944)
        def _lnfact(n):
            if n == 0:
                return 0.0
            if n > 10:
                return 0.918939 + (n + 0.5) * math.log(n) - n
            return math.lgamma(math.floor(n) + 1.0)
        self.lnfact_zq = np.vectorize(_lnfact)(dncat)
        self.lnfact_z = np.array([0.918939 + (n + 0.5) * math.log(n) - n
                                  if n != 0 else 0.0 for n in self.dncat_z])

    def _build_erf_tables(self) -> None:
        """E[lny, theta, qbin] = sum_patches skyfrac * selection(q-bin) at
        noise ylims[patch, theta] (szcounts.f90:965-1000 erfs of grid_C_2d;
        :1162-1180 the 1D variant)."""
        y0 = np.exp(self.lny)                                  # (nlny,)
        sn = self.ylims                                        # (np, nt)
        qlo = 10.0 ** (self.logy_centers - 0.5 * DLOGY)
        qhi = 10.0 ** (self.logy_centers + 0.5 * DLOGY)

        def compl(q):
            # (nlny, np, nt): erf completeness at threshold q
            arg = (y0[:, None, None] - q * sn[None]) / (np.sqrt(2.) * sn[None])
            return 0.5 * (nperf(arg) + 1.0)

        det = compl(Q_THRESHOLD)
        nq = self.ny + 1
        E = np.empty((len(y0), len(self.thetas), nq))
        for k in range(nq):
            if k == 0:
                c2 = det * (1.0 - compl(qhi[k]))
            elif k == nq - 1:
                c2 = det * compl(qlo[k])
            else:
                c2 = det * compl(qlo[k]) * (1.0 - compl(qhi[k]))
            E[:, :, k] = np.einsum("ypt,p->yt", c2, self.skyfracs)
        self.E_zq = E                                          # (nlny, nt, nq)
        self.E_z = np.einsum("ypt,p->yt", det, self.skyfracs)  # (nlny, nt)
        # trapezoid coefficients on the lny grid in y (szcounts.f90:1213-1227)
        dy = np.diff(y0)
        c = np.zeros_like(y0)
        c[:-1] += 0.5 * dy
        c[1:] += 0.5 * dy
        self.lny_coeff = c

    def _build_zbin_weights(self) -> None:
        """Static trapezoid weights mapping fine-z values to z-bin integrals
        (integrate_m_zq, szcounts.f90:827-869: nearest fine index to each
        bin edge, trapezoid between)."""
        edges_lo = self.z_centers - 0.5 * DZ
        edges_hi = self.z_centers + 0.5 * DZ
        W = np.zeros((self.nz, len(self.steps_z)))
        for b in range(self.nz):
            j1 = int(np.abs(self.steps_z - edges_lo[b]).argmin())
            j2 = int(np.abs(self.steps_z - edges_hi[b]).argmin())
            for j in range(j1, j2):
                h = 0.5 * (self.steps_z[j + 1] - self.steps_z[j])
                W[b, j] += h
                W[b, j + 1] += h
        self.zbin_w = W

    def _to_device(self) -> None:
        """Every static table on the device, once."""
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)
        self._zf, self._m, self._lny = (t(self.steps_z), t(self.steps_m),
                                        t(self.lny))
        self._lny_coeff, self._thetas = t(self.lny_coeff), t(self.thetas)
        self._E = (t(self.E_zq).reshape(len(self.lny), -1) if self.switch == 2
                   else t(self.E_z))
        self._zbin_w, self._z0 = t(self.zbin_w), t(0.0)
        self._ncat = t(self.dncat_zq if self.switch == 2 else self.dncat_z)
        self._lnf = t(self.lnfact_zq if self.switch == 2 else self.lnfact_z)
        self._tinker = (t(_TINKER_LOGD), t(_TINKER_Y), t(_TINKER_Y2))
        # the ln R knots and the natural-spline operator y -> y2 on them
        self._lnR = linspace(math.log(0.5), math.log(80.0), _N_LNR,
                             dtype=self.dtype, device=self.device)
        eye = torch.eye(_N_LNR, dtype=self.dtype, device=self.device)
        self._y2_op = spline_fit(self._lnR, eye).y2        # (n, n): row i = y2(e_i)

    # ------------------------------------------------------------------
    # evaluation, batched over chains
    # ------------------------------------------------------------------

    def _sigma_spline(self, mp, h: torch.Tensor) -> Spline:
        """ln sigma(R) spline at z=0 on the static ln R grid (h^-1 Mpc), one
        a chain, from the linear P(k) table (the reference consumes CAMB's
        Theory%sigma_R spline, szcounts.f90:479,1863)."""
        R_mpc = torch.exp(self._lnR)[None, :, None] / h[:, None, None]
        k = mp.k                                              # 1/Mpc
        d2 = k ** 3 / (2.0 * torch.pi ** 2) * torch.exp(mp.lnP[:, 0])
        x = k * R_mpc                                         # (C, nR, nk)
        w = torch.where(x < 1e-3, 1.0 - x ** 2 / 10.0,
                        3.0 * (torch.sin(x) - x * torch.cos(x)) / x ** 3)
        sig2 = trapezoid(d2[:, None, :] * w ** 2, torch.log(k))
        y = 0.5 * torch.log(sig2)
        return Spline(self._lnR, y, y @ self._y2_op)

    def _mass_function(self, lnsig_sp: Spline, g, omm_z, rhom0, z, R_h):
        """dn/dlnM [h^3 Mpc^-3] on the (m, z) grid, (C, nm, nz)
        (szcounts.f90:366-560). g, omm_z, z: (C, nz); rhom0 (C,); R_h (C,
        nm) the Lagrangian radius in h^-1 Mpc (the same at every z)."""
        lnR = torch.log(R_h)
        sR = torch.exp(spline_eval(lnsig_sp, lnR))[:, :, None]
        dlnsig_dlnR = spline_eval_deriv(lnsig_sp, lnR)[:, :, None]
        sg = sR * g[:, None, :]
        dsoz = DELTA_SO / omm_z
        if self.mass_function == "tinker":
            ld = torch.log10(dsoz)
            xa, ya, y2a = self._tinker
            A0, a0, b0, c0 = (_splint_fixed_y2(xa, ya[i], y2a[i], ld)
                              for i in range(4))
            alpha = 10.0 ** (-((0.75 / torch.log10(dsoz / 75.0)) ** 1.2))
            zp = 1.0 + z
            A = A0 * zp ** (-0.14)
            a = a0 * zp ** (-0.06)
            b = b0 * zp ** (-alpha)
            f = A[:, None] * ((sg / b[:, None]) ** (-a[:, None]) + 1.0) \
                * torch.exp(-c0[:, None] / sg ** 2)
        else:  # watson FOF + SO Delta correction (szcounts.f90:507-552)
            A, a, b, c = 0.282, 2.163, 1.406, 1.210
            f = A * ((sg / b) ** (-a) + 1.0) * torch.exp(-c / sg ** 2)
            ddz = -0.456 * omm_z - 0.139
            CD = torch.exp(0.023 * (dsoz / 178.0 - 1.0)) * 0.947
            gamma = CD[:, None] * (dsoz[:, None] / 178.0) ** ddz[:, None] \
                * torch.exp(0.072 * (1.0 - dsoz[:, None] / 178.0) / sg ** 2.13)
            f = f * gamma
        # dn/dlnM = -(rhom0/3) f dln(sigma)/dlnR / M
        return -(rhom0[:, None, None] / 3.0) * f * dlnsig_dlnR \
            / torch.exp(self._m)[None, :, None]

    def theory_counts(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        """Predicted counts DN (C, z-bin, q-bin) (switch 2) or (C, z-bin)
        (switch 1) for the five nuisance values (alpha, log10 y*, bias,
        sigma_M, beta) of each chain, (C, 5) (deltaN_yz,
        szcounts.f90:618-777)."""
        dt = self.dtype
        theory = in_dtype(theory, dt)
        alpha, log10ystar, bias, sigmaM, beta = nuisance.to(dt).unbind(-1)
        bg = theory.bg
        C = bg.H0.shape[0]
        H0 = bg.H0
        h = H0 / 100.0
        omm = (bg.ombh2 + bg.omch2 + bg.omnuh2) / h ** 2

        zf = self._zf.expand(C, -1)                           # (C, nzf)
        Ez = bgm.hubble_mpc(bg, 1.0 / (1.0 + zf)) \
            / bgm.hubble_mpc(bg, torch.ones_like(zf[:, :1]))
        da_h = bgm.angular_diameter_distance(theory.bf, zf) * h[:, None]
        r_h = da_h * (1.0 + zf)
        # growth normalized to z=0 from the sigma8(z) table
        g = theory.sigma8_at(self._zf) / theory.sigma8_at(self._z0)[:, None]
        omm_z = omm[:, None] * (1.0 + zf) ** 3 / Ez ** 2
        rhom0 = omm * RHOCRIT0

        # scaling relations on the (m, z) grid (szcounts.f90:221-243)
        m = torch.exp(self._m)[None, :, None]                 # (1, nm, 1)
        col = lambda v: v[:, None, None]
        mscale = m * col(bias) / 3.0e14 * (100.0 / col(H0))
        dterm = 100.0 * da_h[:, None, :] / (500.0 * col(H0))
        thetastar2 = THETA_STAR * (H0 / 70.0) ** (-2.0 / 3.0)
        theta500 = col(thetastar2) * mscale ** (1.0 / 3.0) \
            * Ez[:, None, :] ** (-2.0 / 3.0) / dterm
        ystar2 = (10.0 ** log10ystar) / (2.0 ** alpha) * YSTAR_NORM \
            * (H0 / 70.0) ** (alpha - 2.0)
        y500 = col(ystar2) * mscale ** col(alpha) \
            * Ez[:, None, :] ** col(beta) / dterm ** 2
        mu = torch.log(y500)                                  # (C, nm, nzf)

        # theory abundance grid (get_grid, szcounts.f90:1317-1334):
        # dV/dz/dOmega = (c/H0) r^2 / E in h^-3 Mpc^3
        c_100 = const.c / 1e5
        vol = c_100 * r_h ** 2 / Ez
        R_h = (0.75 * torch.exp(self._m)[None, :] / torch.pi
               / rhom0[:, None]) ** (1.0 / 3.0)
        dndlnm = self._mass_function(self._sigma_spline(theory.mp, h), g,
                                     omm_z, rhom0, zf, R_h)
        grid = dndlnm * (FULL_SKY_SR * vol)[:, None, :]       # (C, nm, nzf)

        A = torch.cat([self._completeness_sum(mu[s], sigmaM[s], theta500[s],
                                              grid[s])
                       for s in (slice(i, i + self.chain_block)
                                 for i in range(0, C, self.chain_block))])
        DN = torch.einsum("bz,czq->cbq", self._zbin_w, A)     # (C, nzbin, nq)
        return DN if self.switch == 2 else DN[..., 0]

    def _completeness_sum(self, mu, sigmaM, theta500, grid):
        """sum_m grid * completeness(m, z, q) dlnM for a block of chains,
        (c, nzf, nq): the erf tables through G @ E, then the linear
        interpolation in theta with end extrapolation."""
        c, nm, nzf = mu.shape
        lny = self._lny
        s = sigmaM[:, None, None, None]
        fac = 1.0 / torch.sqrt(2.0 * torch.pi * s ** 2)
        arg = (lny - mu[..., None]) / (math.sqrt(2.0) * s)
        G = self._lny_coeff * fac * torch.exp(-arg ** 2 - lny)  # /y0 term
        F = G.reshape(c, nm * nzf, -1) @ self._E
        nt = self._thetas.shape[0]
        F = F.reshape(c, nm * nzf, nt, -1)
        th_tab = self._thetas
        thq = theta500.reshape(c, -1)
        it = (torch.searchsorted(th_tab, thq.contiguous(), right=True) - 1
              ).clamp(0, nt - 2)
        t1, t2 = th_tab[it], th_tab[it + 1]
        wgt = ((thq - t1) / (t2 - t1))[..., None]
        nq = F.shape[-1]
        at = lambda j: F.gather(2, j[..., None, None].expand(-1, -1, 1, nq)
                                )[:, :, 0]
        compl = torch.clamp(at(it) * (1.0 - wgt) + at(it + 1) * wgt, 0.0,
                            self.fsky).reshape(c, nm, nzf, nq)
        return torch.einsum("cmz,cmzq->czq", grid, compl) * DLNM

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        """-ln L per chain (Cash statistic, szcounts.f90:1896-1946);
        `nuisance` holds the varying nuisance columns."""
        DN = self.theory_counts(theory,
                                self.nuisance_values(nuisance.to(self.dtype)))
        term = torch.where(DN > 0.0, self._ncat * torch.log(
            torch.clamp(DN, min=1e-300)) - DN - self._lnf, 0.0)
        return -term.flatten(1).sum(-1)
