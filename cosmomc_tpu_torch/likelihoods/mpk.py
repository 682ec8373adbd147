"""Windowed matter-power-spectrum likelihoods: generic MPK and WiggleZ
(port of cosmomc_tpu/likelihoods/mpk.py; reference source/mpk.f90
MPK_Lnlike :247-410 and source/wigglez.f90 WiggleZ_LnLike :473-649).

  - data bandpowers P_i (h^-3 Mpc^3) with a window matrix W (points x
    kbands) convolving the theory P(k/h) at the dataset redshift;
  - D_V dilation: a_scl = DV_fid / (H0 D_V(z)); the theory is evaluated at
    k a_scl and divided by a_scl^3 (mpk.f90:300-312);
  - analytic marginalization over a flat prior on the bias b^2:
    chi^2 = P.C^-1.P - (W Pth.C^-1.P)^2 / (W Pth.C^-1.W Pth) [+ ln normV
    for MPK; WiggleZ drops the log term, wigglez.f90:619];
  - the Q model P -> P (1 + Q k^2)/(1 + Ag k), marginalized on a 13-point
    grid with a Gaussian weight (Q_mid, Q_sigma) or analytically with a
    flat prior on (b^2, b^2 Q) (Q_flat, mpk.f90:318-350);
  - WiggleZ: the active sky regions of one redshift bin share one theory
    vector and one b^2 (wigglez.f90:592-620), with the optional GiggleZ
    correction of the theory (polynomial fiducial over the tabulated one).

Files are parsed on the host at construction; the data go to the device
once. Batched over chains, an evaluation is a few (C, points) x (points,
kbands) products: no kernel.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.models.matterpower import power_at
from cosmomc_tpu_torch.params.space import Speed
from cosmomc_tpu_torch.utils.interp import interp

_NQ = 6
_DQ = 0.4


def _read_numbers(path: str) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                vals.extend(float(x) for x in line.split())
    return np.asarray(vals)


def _read_rows(path: str) -> List[List[float]]:
    rows = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#"):
                rows.append([float(x) for x in s.split()])
    return rows


def _q_marginal(chisq_of, Q_mid: float, Q_sigma: float, dtype, device):
    """-ln of the Gaussian-weighted mean of exp(-chi^2/2) over the 13-point
    Q grid, per chain (mpk.f90:352-376)."""
    iQ = torch.arange(-_NQ, _NQ + 1, dtype=dtype, device=device)
    chis = torch.stack([chisq_of(Q_mid + q * Q_sigma * _DQ)
                        for q in iQ.tolist()], -1)                 # (C, 13)
    w = torch.exp(-(iQ * _DQ) ** 2 / 2.0)
    mc = chis.min(-1).values
    like = (torch.exp(-(chis - mc[:, None]) / 2.0) * w).sum(-1) / w.sum()
    return -torch.log(torch.clamp(like, min=1e-300)) + mc / 2.0


class _PKBase(Likelihood):
    """D_V scaling and the theory P(k) at the dataset's k bands."""
    kind = "MPK"
    speed = Speed.FAST
    needs_matter_power = True
    #: the dataset redshift, set by the subclass
    required_zmax = 0.0

    def _resolve(self, ddir: str, f: str) -> str:
        f = f.replace("%DATASETDIR%", "")
        for cand in (os.path.join(ddir, os.path.basename(f)),
                     os.path.join(os.path.dirname(ddir), f), f):
            if os.path.isfile(cand):
                return cand
        raise FileNotFoundError(f"{self.name}: {f}")

    def _scaling(self, theory) -> torch.Tensor:
        """a_scl = DV_fid / (H0 D_V(z)) per chain (mpk.f90
        compute_scaling_factor), or ones."""
        H0 = theory.bg.H0
        if not self.use_scaling:
            return torch.ones_like(H0)
        return self.DV_fid / (H0 * bgm.bao_d_v(theory.bf, self.redshift))

    def _theory_pk_h(self, theory, a_scl: torch.Tensor):
        """Theory P at the dataset redshift in h units, D_V-scaled, and the
        scaled k/h: each (C, nkbands)."""
        mp = theory.mp
        if mp is None:
            raise ValueError(f"{self.name}: posterior has no matter power; "
                             "enable matter_power")
        h = mp.h[:, None]
        a = a_scl[:, None]
        kh = a * self._kh.to(a.dtype)
        P = power_at(mp, kh * h, self.redshift, nonlinear=self.nonlinear)
        return P * h ** 3 / a ** 3, kh

    def _q_model(self, P_lin, kh, Q):
        return (P_lin * (1.0 + Q * kh ** 2) / (1.0 + self.Ag * kh)
                if self.Q_marge else P_lin)


class MPKLikelihood(_PKBase):
    """A generic windowed P(k) dataset (mpk.f90 MPKLikelihood), e.g. the
    SDSS LRG DR4 set."""

    def __init__(self, dataset_path: str, name: Optional[str] = None,
                 nonlinear: bool = False, device="cuda",
                 dtype=torch.float64):
        device = kernels.entry_device(device, "MPKLikelihood")
        ini = read_dataset_ini(dataset_path)
        super().__init__(name or ini.string("name", "MPK"))
        self.nonlinear = nonlinear
        ddir = os.path.dirname(os.path.abspath(dataset_path))

        n_pts = ini.int("num_mpk_points_full", required=True)
        n_kb = ini.int("num_mpk_kbands_full", required=True)
        pmin = ini.int("min_mpk_points_use", 1) - 1
        pmax = ini.int("max_mpk_points_use", n_pts)
        kmin = ini.int("min_mpk_kbands_use", 1) - 1
        kmax = ini.int("max_mpk_kbands_use", n_kb)

        kb = _read_numbers(self._resolve(ddir, ini.string("kbands_file",
                                                          required=True)))
        self.kh = kb[:n_kb][kmin:kmax]
        rows = _read_rows(self._resolve(ddir, ini.string("measurements_file",
                                                         required=True)))
        m = np.asarray(rows[:n_pts])[pmin:pmax]
        self.P_data = m[:, 3]
        W = np.loadtxt(self._resolve(ddir, ini.string("windows_file",
                                                      required=True)))
        self.W = W.reshape(n_pts, n_kb)[pmin:pmax, kmin:kmax]
        cov_f = ini.string("cov_file")
        if cov_f:
            cov = np.loadtxt(self._resolve(ddir, cov_f)).reshape(n_pts, n_pts)
            self.invcov = np.linalg.inv(cov[pmin:pmax, pmin:pmax])
        else:
            self.invcov = np.diag(1.0 / m[:, 4] ** 2)

        self.use_scaling = ini.bool("use_scaling", False)
        self.DV_fid = ini.float("DV_fid", -1.0)
        self.redshift = ini.float("redshift", 0.35)
        self.Q_marge = ini.bool("Q_marge", False)
        self.Q_flat = ini.bool("Q_flat", False)
        self.Q_mid = ini.float("Q_mid", 0.0)
        self.Q_sigma = ini.float("Q_sigma", 0.0)
        self.Ag = ini.float("Ag", 1.4)
        self.required_zmax = float(self.redshift)

        t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self._kh, self._W, self._icov, self._Pd = (t(self.kh), t(self.W),
                                                   t(self.invcov), t(self.P_data))

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        P_lin, kh = self._theory_pk_h(theory, self._scaling(theory))
        dt = P_lin.dtype
        W, icov, Pd = self._W.to(dt), self._icov.to(dt), self._Pd.to(dt)
        covdat = icov @ Pd
        PdCPd = Pd @ covdat

        if self.Q_marge and self.Q_flat:
            # flat prior on (b^2, b^2 Q): the 2x2 analytic marginalization
            Pth = P_lin / (1.0 + self.Ag * kh)
            WPth = Pth @ W.T
            WPk2 = (Pth * kh ** 2) @ W.T
            covth = WPth @ icov.T
            covk2 = WPk2 @ icov.T
            M11 = (covth * WPth).sum(-1)
            M22 = (covk2 * WPk2).sum(-1)
            M12 = (covth * WPk2).sum(-1)
            det = M11 * M22 - M12 ** 2
            v1 = WPth @ covdat
            v2 = WPk2 @ covdat
            quad = (M22 * v1 * v1 - 2 * M12 * v1 * v2 + M11 * v2 * v2) / det
            return 0.5 * (PdCPd - quad + torch.log(det))

        def chisq_of(Q):
            WPth = self._q_model(P_lin, kh, Q) @ W.T
            normV = (WPth @ icov.T * WPth).sum(-1)
            return PdCPd - (WPth @ covdat) ** 2 / normV + torch.log(normV)

        if not self.Q_marge or self.Q_sigma == 0:
            return 0.5 * chisq_of(self.Q_mid)
        return _q_marginal(chisq_of, self.Q_mid, self.Q_sigma, dt, P_lin.device)


# WiggleZ redshift bins (wigglez.f90:34)
WIGGLEZ_Z = {0.22: 1, 0.41: 2, 0.6: 3, 0.78: 4}

# GiggleZ polynomial fits per redshift bin (wigglez.f90 GiggleZtoICsmooth)
_GIGGLEZ_POLY = {
    1: [4.619, -13.7787, 58.941, -175.24, 284.321, -187.284],
    2: [4.63079, -12.6293, 42.9265, -91.8068, 97.808, -37.633],
    3: [4.69659, -12.7287, 42.5681, -89.5578, 96.664, -41.2564],
    4: [4.6849, -13.4747, 53.7172, -145.832, 216.638, -132.782],
}
GIGGLEZ_FILES = {1: "gigglezfiducialmodel_matterpower_a.dat",
                 2: "gigglezfiducialmodel_matterpower_b.dat",
                 3: "gigglezfiducialmodel_matterpower_c.dat",
                 4: "gigglezfiducialmodel_matterpower_d.dat"}
REGION_KEYS = ["Use_9-hr_region", "Use_11-hr_region", "Use_15-hr_region",
               "Use_22-hr_region", "Use_1-hr_region", "Use_3-hr_region",
               "Use_0-hr_region"]


class WiggleZLikelihood(_PKBase):
    """One WiggleZ redshift bin over all active sky regions
    (wigglez.f90 WiggleZLikelihood; data files wigglez_nov11{a..d})."""

    def __init__(self, dataset_path: str, common_path: Optional[str] = None,
                 name: Optional[str] = None, use_gigglez: bool = True,
                 nonlinear: bool = True, device="cuda",
                 dtype=torch.float64):
        device = kernels.entry_device(device, "WiggleZLikelihood")
        ini = read_dataset_ini(dataset_path)
        ddir = os.path.dirname(os.path.abspath(dataset_path))
        common = read_dataset_ini(common_path or os.path.join(
            ddir, "wigglez_nov11_common.dataset"))
        super().__init__(name or ini.string("name", "WiggleZ"))
        self.nonlinear = nonlinear
        self.use_gigglez = use_gigglez
        self.redshift = ini.float("redshift", required=True)
        self.zbin = WIGGLEZ_Z[round(self.redshift, 2)]
        self.use_scaling = common.bool("use_scaling", True)
        self.DV_fid = ini.float("DV_fid", -1.0)
        self.Q_marge = common.bool("Q_marge", False)
        self.Q_mid = common.float("Q_mid", 0.0)
        self.Q_sigma = common.float("Q_sigma", 0.0)
        self.Ag = common.float("Ag", 1.4)
        self.required_zmax = float(self.redshift)

        n_pts = common.int("num_mpk_points_full", 50)
        n_kb = common.int("num_mpk_kbands_full", 100)
        pmin = common.int("min_mpk_points_use", 1) - 1
        pmax = common.int("max_mpk_points_use", n_pts)
        kmin = common.int("min_mpk_kbands_use", 1) - 1
        kmax = common.int("max_mpk_kbands_use", n_kb)
        active = [common.bool(k, True) for k in REGION_KEYS]

        kb = _read_numbers(self._resolve(ddir, common.string(
            "kbands_file", "data/wigglez_nov11_kbands.txt")))
        self.kh = kb[:n_kb][kmin:kmax]
        rows = _read_rows(self._resolve(ddir, ini.string("measurements_file",
                                                         required=True)))
        if len(rows) != 7 * n_pts:
            raise ValueError(f"{self.name}: expected {7 * n_pts} rows, got "
                             f"{len(rows)}")
        W_all = np.loadtxt(self._resolve(ddir, ini.string(
            "windows_file", required=True))).reshape(7, n_pts, n_kb)
        C_all = np.loadtxt(self._resolve(ddir, ini.string(
            "cov_file", required=True))).reshape(7, n_pts, n_pts)
        regions = [r for r in range(7) if active[r]]
        self.P_data = np.stack([np.asarray(rows[r * n_pts:(r + 1) * n_pts])
                                [pmin:pmax, 3] for r in regions])
        self.W = np.stack([W_all[r][pmin:pmax, kmin:kmax] for r in regions])
        self.invcov = np.stack([np.linalg.inv(C_all[r][pmin:pmax, pmin:pmax])
                                for r in regions])

        t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self._kh, self._W, self._icov, self._Pd = (t(self.kh), t(self.W),
                                                   t(self.invcov), t(self.P_data))
        if use_gigglez:
            g = np.asarray(_read_rows(self._resolve(ddir,
                                                    GIGGLEZ_FILES[self.zbin])))
            self._gig_logk, self._gig_logP = t(np.log(g[:, 0])), t(np.log(g[:, 1]))
            self._gig_poly = _GIGGLEZ_POLY[self.zbin][::-1]  # highest first

    def _gigglez_correct(self, P: torch.Tensor, kh: torch.Tensor) -> torch.Tensor:
        """P 10^poly(kh) / P_GiggleZ(kh) (wigglez.f90 WiggleZPowerAt)."""
        dt = kh.dtype
        poly = torch.zeros_like(kh)
        for c in self._gig_poly:                       # Horner, as polyval
            poly = poly * kh + c
        tab = torch.exp(interp(torch.log(kh), self._gig_logk.to(dt),
                               self._gig_logP.to(dt)))
        return P * 10.0 ** poly / tab

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        P_lin, kh = self._theory_pk_h(theory, self._scaling(theory))
        if self.use_gigglez:
            P_lin = self._gigglez_correct(P_lin, kh)
        dt = P_lin.dtype
        W, IC, Pd = self._W.to(dt), self._icov.to(dt), self._Pd.to(dt)
        covdat = torch.einsum("rij,rj->ri", IC, Pd)
        PdCPd = (Pd * covdat).sum()

        def chisq_of(Q):
            WPth = torch.einsum("rik,ck->cri", W,
                                self._q_model(P_lin, kh, Q))
            covth = torch.einsum("rij,crj->cri", IC, WPth)
            normV = (WPth * covth).sum((-2, -1))
            # one b^2 across the regions; the ln normV term is dropped
            # (commented out in wigglez.f90:619)
            return PdCPd - (WPth * covdat).sum((-2, -1)) ** 2 / normV

        if not self.Q_marge or self.Q_sigma == 0:
            return 0.5 * chisq_of(self.Q_mid)
        return _q_marginal(chisq_of, self.Q_mid, self.Q_sigma, dt, P_lin.device)
