"""Type Ia supernova likelihoods, JLA and Pantheon with SALT2
standardisation (port of cosmomc_tpu/likelihoods/sn.py; reference
source/supernovae_JLA.f90):

  mu_model,i = 5 log10((1+zhel_i)(1+zcmb_i) D_A(zcmb_i)/Mpc)        (:1198)
  diff_i = m_B,i + alpha x1_i - beta c_i - mu_model,i - M
  chi2 with M marginalised (flat prior): A + ln(E/2pi) - B^2/E      (:1143)
      A = d^T C^-1 d,  B = 1^T C^-1 d,  E = 1^T C^-1 1
  C(alpha, beta) = C_mag + alpha^2 C_stretch + beta^2 C_colour
      + 2 alpha C_mag,stretch - 2 beta C_mag,colour - 2 alpha beta C_s,c
      + diag(pre_vars + alpha^2 s_var + beta^2 c_var + 2a cov_ms
             - 2b cov_mc - 2ab cov_sc)                               (:939)
  pre_vars = mag_var + intrinsicdisp^2
      + (5/ln10)^2 pecz^2 ((1+z)/(z(1+z/2)))^2                       (:912)
  twoscriptmfit: two absolute magnitudes split at scriptmcut on the third
  variable, both marginalised (:1135-1142).

Batched over chains. With fixed alpha/beta (Pantheon) C is constant: its
inverse is formed once on the host, and a call is one (C, n) @ (n, n)
matmul. With varying alpha/beta (JLA) each chain's C is assembled and
factored (`torch.linalg.cholesky`, `torch.cholesky_solve`, batched).
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.params.space import Param, Speed

_ZFACSQ = (5.0 / np.log(10.0)) ** 2
_INV_TWOPI = 1.0 / (2.0 * np.pi)


def _read_cov(path: str, n: int) -> np.ndarray:
    """SN covariance files: the first entry may be the dimension (JLA)."""
    vals = np.loadtxt(path).ravel()
    if vals.size == n * n + 1:
        if int(vals[0]) != n:
            raise ValueError(f"{path}: dimension {int(vals[0])} != {n}")
        vals = vals[1:]
    return vals.reshape(n, n)


class SNLikelihood(Likelihood):
    kind = "SN"
    speed = Speed.FAST

    def __init__(self, dataset_path: str, name: Optional[str] = None,
                 device="cuda", dtype=torch.float64):
        device = kernels.entry_device(device, "SNLikelihood")
        ini = read_dataset_ini(dataset_path)
        super().__init__(name or ini.string("name", "SN"))
        ddir = os.path.dirname(os.path.abspath(dataset_path))
        root = os.path.dirname(ddir)    # dataset paths are relative to it

        def resolve(f):
            for cand in (os.path.join(ddir, os.path.basename(f)),
                         os.path.join(os.path.dirname(root), f),
                         os.path.join(root, f), f):
                if os.path.isfile(cand):
                    return cand
            raise FileNotFoundError(f"{self.name}: {f}")

        cols = []
        with open(resolve(ini.string("data_file", required=True))) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                cols.append([float(x) for x in line.split()[1:]])
        arr = np.array(cols)
        n = arr.shape[0]
        self.nsn = n
        (zcmb, zhel, dz, mb, dmb, x1, dx1, color, dcolor, thirdvar) = arr[:, :10].T
        cov_m_s, cov_m_c, cov_s_c = arr[:, 11], arr[:, 12], arr[:, 13]

        self.pecz = ini.float("pecz", 0.001)
        intrinsicdisp = ini.float("intrinsicdisp", 0.13)
        self.twoscriptmfit = ini.bool("twoscriptmfit", False)
        scriptmcut = ini.float("scriptmcut", 10.0)

        pre_vars = dmb ** 2 + intrinsicdisp ** 2
        pre_vars = pre_vars + np.where(
            zcmb > 0, _ZFACSQ * self.pecz ** 2
            * ((1.0 + zcmb) / np.maximum(zcmb * (1 + 0.5 * zcmb), 1e-10)) ** 2,
            0.0)

        def load_flag(key):
            if not ini.bool(f"has_{key}_covmat", False):
                return None
            try:
                return _read_cov(
                    resolve(ini.string(f"{key}_covmat_file", required=True)), n)
            except FileNotFoundError:
                # a data tree may not ship the systematic covariances
                warnings.warn(f"{self.name}: {key} covmat file missing; "
                              "using statistical errors only")
                return None

        C_mag = load_flag("mag")
        extra = {k: load_flag(k) for k in ("stretch", "colour", "mag_stretch",
                                           "mag_colour", "stretch_colour")}
        self.varying_alpha_beta = (any(c is not None for c in extra.values())
                                   or np.any(x1 != 0) or np.any(color != 0))
        if self.varying_alpha_beta:
            # JLA convention: alpha, beta sampled (nuisance block)
            self.nuisance = [
                Param("alpha_JLA", 0.135, 0.01, 2.0, 0.003, 0.003,
                      label=r"\alpha_{JLA}", speed=Speed.FAST),
                Param("beta_JLA", 3.1, 0.9, 4.6, 0.03, 0.03,
                      label=r"\beta_{JLA}", speed=Speed.FAST),
            ]

        t = lambda x: None if x is None else torch.as_tensor(
            x, dtype=dtype, device=device)
        self._zcmb, self._zhel = t(zcmb), t(zhel)
        self._mb, self._x1, self._color = t(mb), t(x1), t(color)
        self._pre_vars = t(pre_vars)
        self._svar, self._cvar = t(dx1 ** 2), t(dcolor ** 2)
        self._cov_ms, self._cov_mc, self._cov_sc = t(cov_m_s), t(cov_m_c), t(cov_s_c)
        self._A1 = t(np.where(thirdvar <= scriptmcut, 1.0, 0.0))
        self._A2 = 1.0 - self._A1
        self._Cm = t(C_mag if C_mag is not None else np.zeros((n, n)))
        self._extra = {k: t(v) for k, v in extra.items()}
        if not self.varying_alpha_beta:
            # fixed covariance: inverted once on the host in float64, so a
            # call is one (C, n) @ (n, n) matmul
            C = (C_mag if C_mag is not None else np.zeros((n, n))) \
                + np.diag(pre_vars)
            icov = np.linalg.inv(C)
            self._icov = t(icov)
            self._icov_total = float(icov.sum())
        else:
            self._icov = None

    # ------------------------------------------------------------------

    def _mu_model(self, theory) -> torch.Tensor:
        C = theory.bf.chi_grid.shape[0]
        zc = self._zcmb.expand(C, -1)
        da = bgm.angular_diameter_distance(theory.bf, zc)
        return 5.0 * torch.log10((1.0 + self._zhel) * (1.0 + zc) * da)

    def _marg_chi2(self, diff: torch.Tensor, solve) -> torch.Tensor:
        """M-marginalised chi2, given `solve`: (C, n) x -> C^-1 x per chain."""
        dot = lambda a, b: (a * b).sum(-1)
        cinv_d = solve(diff)
        if self.twoscriptmfit:
            A1 = self._A1.to(diff.dtype).expand_as(diff)
            A2 = self._A2.to(diff.dtype).expand_as(diff)
            A = dot(diff, cinv_d)
            B = dot(cinv_d, A1)
            Cc = dot(cinv_d, A2)
            cinv_A1 = solve(A1)
            D = dot(cinv_A1, A2)
            E = dot(cinv_A1, A1)
            F = dot(solve(A2), A2)
            G = F - D * D / E
            return (A + torch.log(E * _INV_TWOPI) + torch.log(G * _INV_TWOPI)
                    - Cc * Cc / G - B * B * F / (E * G) + 2.0 * B * Cc * D / (E * G))
        A = dot(diff, cinv_d)
        B = cinv_d.sum(-1)
        E = solve(torch.ones_like(diff)).sum(-1)
        return A + torch.log(E * _INV_TWOPI) - B * B / E

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        dt = theory.bg.ombh2.dtype
        mu = self._mu_model(theory)
        if not self.varying_alpha_beta:
            diff = (self._mb - mu).to(dt)
            icov = self._icov.to(dt)
            if self.twoscriptmfit:
                return 0.5 * self._marg_chi2(diff, lambda x: x @ icov)
            cinv_d = diff @ icov
            A = (diff * cinv_d).sum(-1)
            B = cinv_d.sum(-1)
            E = self._icov_total
            return 0.5 * (A + float(np.log(E * _INV_TWOPI)) - B * B / E)

        alpha, beta = nuisance[:, 0:1], nuisance[:, 1:2]            # (C, 1)
        diff = (self._mb + alpha * self._x1 - beta * self._color - mu).to(dt)
        diag = (self._pre_vars + alpha ** 2 * self._svar + beta ** 2 * self._cvar
                + 2 * alpha * self._cov_ms - 2 * beta * self._cov_mc
                - 2 * alpha * beta * self._cov_sc)
        a, b = alpha[:, :, None], beta[:, :, None]                   # (C, 1, 1)
        C = self._Cm + torch.diag_embed(diag)
        ex = self._extra
        for key, coef in (("stretch", a ** 2), ("colour", b ** 2),
                          ("mag_stretch", 2 * a), ("mag_colour", -2 * b),
                          ("stretch_colour", -2 * a * b)):
            if ex[key] is not None:
                C = C + coef * ex[key]
        L = torch.linalg.cholesky(C.to(dt))
        return 0.5 * self._marg_chi2(
            diff, lambda x: torch.cholesky_solve(x[..., None], L)[..., 0])
