"""H0 / inverse-distance-ladder likelihood (port of
cosmomc_tpu/likelihoods/hst.py; reference source/HST.f90).

A Gaussian either on H0 directly or, the Riess16/18 convention, on
angconversion / D_A(zeff) with zeff = 0.04 (HST.f90:9-21, 48-58)."""

from __future__ import annotations

import torch

from cosmomc_tpu_torch.likelihoods.base import Likelihood
from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.params.space import Speed


class HSTLikelihood(Likelihood):
    kind = "Hubble"
    speed = Speed.FAST

    def __init__(self, H0: float, H0_err: float, zeff: float = 0.04,
                 angconversion: float = 11425.8, name: str = "HST"):
        super().__init__(name)
        self.H0 = H0
        self.H0_err = H0_err
        self.zeff = zeff
        self.angconversion = angconversion

    @classmethod
    def from_ini(cls, ini) -> "HSTLikelihood":
        return cls(H0=ini.float("Hubble_H0", required=True),
                   H0_err=ini.float("Hubble_H0_err", required=True),
                   zeff=ini.float("Hubble_zeff", 0.04),
                   angconversion=ini.float("Hubble_angconversion", 11425.8),
                   name=ini.string("Hubble_name", "HST"))

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        if self.zeff > 0:
            val = self.angconversion / bgm.angular_diameter_distance(
                theory.bf, self.zeff)
        else:
            val = theory.bg.H0
        return (val - self.H0) ** 2 / (2.0 * self.H0_err ** 2)
