"""Reionization: tanh in (1+z)^1.5 and the zre <-> tau inversion
(camb/reionization.f90; port of cosmomc_tpu/models/reionization.py).

`zre_from_tau` is a fixed 30-step bisection batched over chains, then one
Newton polish step that carries d zre/d(tau, ombh2, ...) as JAX's does."""

from __future__ import annotations

import torch

from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models.background import (BackgroundParams, hubble_mpc,
                                                 newton_polish)
from cosmomc_tpu_torch.utils.interp import trapezoid

DELTA_Z = 0.5
HE3_Z = 3.5
HE3_DELTA = 0.5


def xe_reion(z: torch.Tensor, zre: torch.Tensor, fHe: torch.Tensor,
             include_he3: bool = True) -> torch.Tensor:
    """Reionization n_e/n_H at z (C, M) for per-chain zre, fHe (C, 1)."""
    y = (1.0 + z) ** 1.5
    yre = (1.0 + zre) ** 1.5
    dy = 1.5 * torch.sqrt(1.0 + zre) * DELTA_Z
    xe = (1.0 + fHe) / 2.0 * (1.0 + torch.tanh((yre - y) / dy))
    if include_he3:
        xe = xe + fHe / 2.0 * (1.0 + torch.tanh((HE3_Z - z) / HE3_DELTA))
    return xe


def reion_optical_depth(bg: BackgroundParams, zre: torch.Tensor, yhe,
                        n: int = 256) -> torch.Tensor:
    """tau from reionization alone, per chain (C,)."""
    mu_H = 1.0 / (1.0 - yhe)
    Nnow = const.n_H_today(bg.ombh2, mu_H)
    akthom = (const.sigma_thomson * Nnow * const.Mpc)[:, None]
    fHe = (yhe / (const.mass_ratio_He_H * (1.0 - yhe)))[:, None]
    z = torch.linspace(0.0, 50.0, n, dtype=torch.float64).to(zre)
    z = z.expand(zre.shape[0], n)
    Hm = hubble_mpc(bg, 1.0 / (1.0 + z))
    integrand = akthom * xe_reion(z, zre[:, None], fHe) * (1.0 + z) ** 2 / Hm
    return trapezoid(integrand, z)


def zre_from_tau(bg: BackgroundParams, tau: torch.Tensor, yhe,
                 iters: int = 30) -> torch.Tensor:
    """Invert tau(zre) by bisection (reionization.f90 GetZreFromTau)."""
    lo = torch.full_like(tau, 0.5)
    hi = torch.full_like(tau, 40.0)
    with torch.no_grad():
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            low = reion_optical_depth(bg, mid, yhe) < tau
            lo, hi = torch.where(low, mid, lo), torch.where(low, hi, mid)
    mid = (0.5 * (lo + hi)).detach()
    return newton_polish(lambda z: reion_optical_depth(bg, z, yhe) - tau, mid)
