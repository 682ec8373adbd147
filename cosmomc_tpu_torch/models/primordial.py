"""Primordial power spectra (camb/power_tilt.f90 ScalarPower/TensorPower).

  P_R(k) = A_s (k/k_pivot)^(n_s - 1 + (1/2) n_run ln(k/kp)
                             + (1/6) n_runrun ln^2(k/kp))
  P_t(k) = r A_s (k/k_pivot_t)^(n_t + (1/2) n_t_run ln(k/kp))
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class PrimordialParams:
    """Each field a (C,) tensor; the pivots are static floats."""
    logA: torch.Tensor       # ln(10^10 As)
    ns: torch.Tensor
    nrun: torch.Tensor
    nrunrun: torch.Tensor
    r: torch.Tensor
    nt: torch.Tensor
    ntrun: torch.Tensor
    pivot_scalar: float = 0.05
    pivot_tensor: float = 0.05

    @classmethod
    def make(cls, logA, ns, nrun=0.0, nrunrun=0.0, r=0.0, nt=0.0, ntrun=0.0,
             pivot_scalar=0.05, pivot_tensor=0.05):
        """`logA`/`ns` are (C,) tensors; the rest may be floats."""
        f = lambda v: torch.as_tensor(v, dtype=logA.dtype,
                                      device=logA.device).expand(logA.shape)
        return cls(logA, ns, f(nrun), f(nrunrun), f(r), f(nt), f(ntrun),
                   pivot_scalar, pivot_tensor)

    @property
    def As(self) -> torch.Tensor:
        return torch.exp(self.logA) * 1e-10


def scalar_power(pp: PrimordialParams, k: torch.Tensor) -> torch.Tensor:
    """P_R(k) per chain: k (nk,) shared -> (C, nk)."""
    lnk = torch.log(k / pp.pivot_scalar)[None, :]
    c = lambda v: v[:, None]
    return c(pp.As) * torch.exp((c(pp.ns) - 1.0 + lnk * (c(pp.nrun) / 2.0
                                                         + c(pp.nrunrun) * lnk
                                                         / 6.0)) * lnk)


def tensor_power(pp: PrimordialParams, k: torch.Tensor) -> torch.Tensor:
    """P_t(k) per chain (power_tilt.f90 TensorPower): k (nk,) -> (C, nk);
    inflation consistency (nt = -r/8) is set by the caller."""
    lnk = torch.log(k / pp.pivot_tensor)[None, :]
    c = lambda v: v[:, None]
    return c(pp.r) * c(pp.As) * torch.exp((c(pp.nt) + c(pp.ntrun) * lnk / 2.0)
                                          * lnk)
