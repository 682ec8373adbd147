"""Native Planck plik_lite binned TT/TE/EE Gaussian likelihood.

Re-design of the reference's TPlikLiteLikelihood
(source/CMB.f90:28-46,208-329; "unofficial native cosmomc version,
adapted from code by Erminia Calabrese"): pre-marginalized Planck
high-l bandpowers, Gaussian in the binned C_l with a single `A_planck`
calibration.

File formats (identical to the reference's expected plik_lite release
files, which ship with the Planck likelihood distribution):
  data:    rows of (bin index, bandpower, sigma); 613 rows = 215 TT +
           199 TE + 199 EE bins, each spectrum's bins starting at l=30
  blmin/blmax: per-bin first/last l as offsets from plmin=30
  weights: per-l weights w_l over l=30..2508, normalized for raw C_l;
           the reference multiplies by 2pi/(l(l+1)) so they can be dotted
           with the theory's l(l+1)C_l/2pi convention (CMB.f90:230-234)
  cov_file: (613,613) text covariance (cov_file_binary also accepted in
           the reference; text only here)

Port of cosmomc_tpu/likelihoods/pliklite.py. Load time builds one dense
binning matrix per spectrum on the device; the loglike per chain is
   X = data - B @ Dl / A^2;  chi2 = X^T C^{-1} X   (torch.matmul).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.params.space import Param, Speed
from cosmomc_tpu_torch.utils.paramnames import ParamNames

_SPECTRA = ("TT", "TE", "EE")
_PAIRS = ((0, 0), (1, 0), (1, 1))      # theory-field (i,j) per spectrum


class PlikLiteLikelihood(Likelihood):
    kind = "CMB"
    speed = Speed.SLOW

    plmin = 30
    lmax = 2508
    nbincl = (215, 199, 199)

    def __init__(self, dataset_path: str, name: str = "plik_lite",
                 param_specs: Optional[Dict[str, Sequence[float]]] = None,
                 device="cuda", dtype=torch.float64):
        super().__init__(name)
        device = kernels.entry_device(device, "PlikLiteLikelihood")
        self.device, self.dtype = device, dtype
        ini = read_dataset_ini(dataset_path)
        ddir = os.path.dirname(os.path.abspath(dataset_path))

        def rel(key, required=True):
            v = ini.string(key, required=required)
            if v and not os.path.isabs(v):
                v = os.path.join(ddir, v)
            return v

        cal_file = rel("calibration_param")
        specs = dict(param_specs or {})
        specs.setdefault("A_planck", (1.0, 0.9, 1.1, 0.002, 0.002))
        pn = ParamNames.from_file(cal_file)
        for info in pn.sampled():
            c = specs.get(info.name, (1.0, 0.9, 1.1, 0.002, 0.002))
            p = Param(info.name, *c, label=info.label, speed=Speed.FAST)
            if info.name == "A_planck":
                p.prior_mean, p.prior_std = 1.0, 0.0025
            self.nuisance.append(p)

        use_cl = (ini.string("use_cl") or "TT TE EE").split()
        dat = np.loadtxt(rel("data"))
        blmin = np.loadtxt(rel("blmin")).astype(int) + self.plmin
        blmax = np.loadtxt(rel("blmax")).astype(int) + self.plmin
        weights = np.loadtxt(rel("weights"))
        ls = self.plmin + np.arange(len(weights))
        weights = weights * 2 * np.pi / (ls * (ls + 1.0))
        cov = np.loadtxt(rel("cov_file"))

        maxbin = max(self.nbincl)
        rng = ini.string("bins_for_L_range")
        if rng:
            rmin, rmax = (float(x) for x in rng.split())
            centre = (blmin[:maxbin] + blmax[:maxbin]) / 2.0
            usebins = np.where((centre >= rmin) & (centre <= rmax))[0] + 1
        else:
            usebins = None

        self.used = [s in use_cl for s in _SPECTRA]
        used_indices = []
        bin_mats = []       # per used spectrum: (nb_used, nL) weights matrix
        pairs = []
        offset = 0
        nL = self.lmax - self.plmin + 1
        for i, nb in enumerate(self.nbincl):
            if self.used[i]:
                if usebins is not None:
                    bins = usebins[usebins <= nb]
                else:
                    bins = np.arange(1, nb + 1)
                used_indices.extend(bins - 1 + offset)
                B = np.zeros((len(bins), nL))
                for r, b in enumerate(bins):
                    lo, hi = blmin[b - 1], blmax[b - 1]
                    B[r, lo - self.plmin:hi - self.plmin + 1] = \
                        weights[lo - self.plmin:hi - self.plmin + 1]
                bin_mats.append(B)
                pairs.append(_PAIRS[i])
            offset += nb
        used_indices = np.array(used_indices, int)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.X_data = t(dat[used_indices, 1])
        self.invcov = t(np.linalg.inv(cov[np.ix_(used_indices, used_indices)]))
        self._bin_mats = [t(B) for B in bin_mats]
        self._pairs = pairs

    def required_lmax(self) -> int:
        return self.lmax

    def log_like_cls(self, cls_stack: torch.Tensor, nuisance: torch.Tensor
                     ) -> torch.Tensor:
        """chi^2/2 per chain from the (C, 4, 4, lmax+1) theory stack."""
        parts = [cls_stack[:, i, j, self.plmin:self.lmax + 1].to(self.dtype)
                 @ B.T for B, (i, j) in zip(self._bin_mats, self._pairs)]
        cl = torch.cat(parts, -1)
        cal = nuisance[:, 0].to(self.dtype)
        X = self.X_data - cl / (cal ** 2)[:, None]
        return 0.5 * ((X @ self.invcov) * X).sum(-1)

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        return self.log_like_cls(theory.cls, nuisance)
