"""Element-abundance likelihoods: Yp and D/H against BBN predictions
(port of cosmomc_tpu/likelihoods/abundances.py; reference
source/ElementAbundances.f90 Abundance_LnLike :99-120).

A Gaussian measurement of the helium nucleon fraction Yp^BBN or of D/H
against the BBN table at (ombh2, nnu - 3.046), with an optional theory
bias offset and a theory error added in quadrature: the dataset's
`theory_effective_error` when set, else the table's own sigma. Dataset
keys (`measurement`, `mean`, `error`, `theory_table`, `theory_bias_offset`,
`theory_effective_error`) are the reference `.dataset` format. Batched
over chains: two bilinear lookups and a quadratic per chain, no kernel.
"""

from __future__ import annotations

import os

import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.models import bbn
from cosmomc_tpu_torch.params.space import Speed

STANDARD_NNU = 3.046

# mass-fraction -> nucleon-ratio conversion constants (bbn.f90:28-39)
_M_H = 1.673575e-27
_NOT4 = 3.9715
_M_HE = _M_H * _NOT4


def yp_bbn_from_mass_fraction(yhe):
    """Convert the Yhe mass fraction (CMB codes) to the nucleon ratio
    Yp^BBN (bbn.f90 GetYPBBN)."""
    return 4 * _M_H * yhe / (_M_HE - yhe * (_M_HE - 4 * _M_H))


class AbundanceLikelihood(Likelihood):
    """One abundance measurement (reference AbundanceLikelihood)."""

    kind = "Abund"
    speed = Speed.FAST

    def __init__(self, dataset: str, name: str = "",
                 bbn_consistency: bool = True, device="cuda",
                 dtype=torch.float64):
        self.device = kernels.entry_device(device, "AbundanceLikelihood")
        ini = read_dataset_ini(dataset)
        ddir = os.path.dirname(os.path.abspath(dataset))
        self.measurement = ini.string("measurement", required=True)
        super().__init__(name or f"abund_{self.measurement.replace('/', '')}")
        self.mean = ini.float("mean", required=True)
        self.error = ini.float("error", required=True)
        self.theory_bias_offset = ini.float("theory_bias_offset", 0.0)
        self.theory_effective_error = ini.float("theory_effective_error", 0.0)
        self.non_bbn_yhe = False
        self.dtype = dtype
        self.table = None

        table_name = ini.string("theory_table")
        table_path = (os.path.join(ddir, os.path.basename(table_name))
                      if table_name else None)
        if self.measurement == "Yp":
            if bbn_consistency:
                self._value = bbn.ypbbn_bbn
            else:
                # the measurement against the sampled or fixed Yhe
                # (ElementAbundances.f90:103-104)
                self.non_bbn_yhe = True
        elif self.measurement == "D/H":
            if not bbn_consistency:
                raise ValueError(
                    "D/H abundance measurement requires BBN consistency")
            self._value = bbn.dh_bbn
        else:
            raise ValueError(
                f"Un-recognised measurement name: {self.measurement}")
        if not self.non_bbn_yhe:
            if table_path is None:
                raise ValueError(f"{self.name}: the dataset names no "
                                 "theory_table")
            self.table = bbn.load_bbn_table(table_path).to(self.device, dtype)

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        if self.non_bbn_yhe:
            yhe = getattr(theory, "yhe", None)
            if yhe is None:
                raise ValueError(f"{self.name}: theory carries no yhe for "
                                 "non-BBN Yp comparison")
            t = yp_bbn_from_mass_fraction(yhe.to(self.dtype)) - self.mean
            return 0.5 * t * t / self.error ** 2
        bg = theory.bg
        ombh2 = bg.ombh2.to(self.dtype)
        dn = bg.nnu.to(self.dtype) - STANDARD_NNU
        val = self._value(ombh2, dn, self.table)
        if self.theory_effective_error > 0:
            terr = self.theory_effective_error
        else:
            sig_yp, sig_dh = bbn.bbn_errors(ombh2, dn, self.table)
            terr = sig_dh if self.measurement == "D/H" else sig_yp
        t = val + self.theory_bias_offset - self.mean
        return 0.5 * t * t / (self.error ** 2 + terr ** 2)
