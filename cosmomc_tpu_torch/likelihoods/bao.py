"""BAO (and f sigma8) likelihoods (port of cosmomc_tpu/likelihoods/bao.py;
reference source/bao.f90).

A Gaussian on measurements at redshifts z_j with types (bao.f90:29-34)

  Az, DV_over_rs, rs_over_DV, DA_over_rs, F_AP, f_sigma8, bao_Hz_rs,
  bao_Hz_rs_103, dilation, DM_over_rs

and theory (BAO_LnLike, bao.f90:264-306): DV/rs, H(z)[km/s/Mpc] rs
(optionally x1e-3), rs/DV, DM/rs = (1+z) DA/rs, DA/rs, F_AP = (1+z) DA H/c,
f sigma8(z) and the Eisenstein A(z); r_s is the drag sound horizon times
the dataset's `rs_rescale`. Batched over chains: every candidate quantity
is computed at every z for all chains, and each row's type picks its own
with one gather built at load time. f_sigma8 rows read the theory's
f sigma8(z) table (a posterior with matter power), a background-only
theory raises for them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.params.space import Speed

TYPES = ["Az", "DV_over_rs", "rs_over_DV", "DA_over_rs", "F_AP", "f_sigma8",
         "bao_Hz_rs", "bao_Hz_rs_103", "dilation", "DM_over_rs"]
#: the types computed from the background, in the order of `_candidates`,
#: then f_sigma8 (from the matter power)
_BG_TYPES = ["DV_over_rs", "bao_Hz_rs", "bao_Hz_rs_103", "rs_over_DV",
             "DA_over_rs", "DM_over_rs", "F_AP", "Az"]
_CANDIDATES = _BG_TYPES + ["f_sigma8"]
C_KMS = const.c / 1e3


class BAOLikelihood(Likelihood):
    kind = "BAO"
    speed = Speed.FAST

    def __init__(self, dataset_path: str, name: Optional[str] = None,
                 device="cuda", dtype=torch.float64):
        device = kernels.entry_device(device, "BAOLikelihood")
        ini = read_dataset_ini(dataset_path)
        super().__init__(name or ini.string("name", os.path.basename(dataset_path)))
        ddir = os.path.dirname(os.path.abspath(dataset_path))

        errs: List[float] = []
        if ini.string("bao_measurement") is not None:
            # the inline single-point form (e.g. sdss_6DF_bao.dataset):
            # zeff = ..., measurement_type = ..., bao_measurement = value err
            vals = [float(x) for x in ini.string("bao_measurement").split()]
            self.z = np.array([ini.float("zeff", required=True)])
            self.obs = np.array([vals[0]])
            if len(vals) > 1:
                errs = [vals[1]]
            types = [ini.string("measurement_type", required=True)]
        else:
            n = ini.int("num_bao", required=True)
            meas_file = os.path.join(
                ddir, os.path.basename(ini.string("bao_measurements_file",
                                                  required=True)))
            has_err = ini.bool("bao_measurements_file_has_error", False)
            rows, types = [], []
            with open(meas_file) as f:
                for line in f:
                    line = line.split("#")[0].strip()
                    if not line:
                        continue
                    parts = line.split()
                    rows.append((float(parts[0]), float(parts[1])))
                    if has_err:
                        errs.append(float(parts[2]))
                    if len(parts) > 2 + (1 if has_err else 0):
                        types.append(parts[-1])
            if len(rows) != n:
                raise ValueError(f"{self.name}: expected {n} rows, got {len(rows)}")
            if not types:
                types = [ini.string("measurement_type", required=True)] * n
            self.z = np.array([r[0] for r in rows])
            self.obs = np.array([r[1] for r in rows])
        self.types = types
        for t in types:
            if t not in TYPES:
                raise ValueError(f"{self.name}: unknown BAO type {t}")

        cov_file = ini.string("bao_cov_file")
        invcov_file = ini.string("bao_invcov_file")
        if cov_file:
            cov = np.loadtxt(os.path.join(ddir, os.path.basename(cov_file)))
            icov = np.linalg.inv(np.atleast_2d(cov))
        elif invcov_file:
            icov = np.atleast_2d(np.loadtxt(
                os.path.join(ddir, os.path.basename(invcov_file))))
        else:
            err = ini.float_list("bao_errors") or errs
            if not len(err):
                raise ValueError(f"{self.name}: no covariance given")
            icov = np.diag(1.0 / np.asarray(err, float) ** 2)
        self.rs_rescale = ini.float("rs_rescale", 1.0)

        t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self._z, self._obs, self._icov = t(self.z), t(self.obs), t(icov)
        # row j takes candidate _pick[j]
        self._pick = torch.as_tensor(
            [_CANDIDATES.index(x) if x in _CANDIDATES else 0 for x in types],
            device=device)

    def _candidates(self, theory, rs: torch.Tensor) -> torch.Tensor:
        """Every background type at every z: (C, len(_BG_TYPES), nz)."""
        bf = theory.bf
        z = self._z.to(rs.dtype).expand(rs.shape[0], -1)       # (C, nz)
        rs = rs[:, None]
        da = bgm.angular_diameter_distance(bf, z)
        hz_mpc = bgm.hubble_mpc(bf.bg, 1.0 / (1.0 + z))         # H/c, 1/Mpc
        hz_kms = hz_mpc * C_KMS
        dv = ((1.0 + z) ** 2 * da ** 2 * z / hz_mpc) ** (1.0 / 3.0)
        bg = theory.bg
        omh2 = (bg.ombh2 + bg.omch2 + bg.omnuh2)[:, None]
        return torch.stack([
            dv / rs, hz_kms * rs, hz_kms * rs * 1e-3, rs / dv, da / rs,
            (1.0 + z) * da / rs, (1.0 + z) * da * hz_mpc,
            # Eisenstein A(z) = 100 DV sqrt(om h^2) / (c z) (bao.f90:249-262)
            100.0 * dv * torch.sqrt(omh2) / (C_KMS * z)], 1)

    def theory_vector(self, theory) -> torch.Tensor:
        """(C, nz) predictions matching self.types (bao.f90:278-300)."""
        if "dilation" in self.types:
            raise ValueError(f"{self.name}: dilation rows have no theory")
        rs = theory.rs_drag * self.rs_rescale
        q = self._candidates(theory, rs)
        if "f_sigma8" in self.types:
            q = torch.cat([q, theory.fsigma8_at(self._z)[:, None]], 1)
        return q.gather(1, self._pick.expand(q.shape[0], 1, -1))[:, 0]

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        d = self.theory_vector(theory) - self._obs.to(theory.bg.ombh2.dtype)
        return 0.5 * ((d @ self._icov.to(d.dtype)) * d).sum(-1)
