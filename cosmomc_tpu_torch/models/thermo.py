"""Thermal-history derived quantities from the recombination table.

Port of cosmomc_tpu/models/thermo.py (camb/modules.f90 ThermoDerivedParams):
optical depth kappa(z) and z* (kappa = 1), drag depth and z_drag, the exact
sound horizon r_s(z), baryon sound speed, and the diffusion damping scale.
Batched over chains: every table is (C, N) on the ascending x = log(1+z)
grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models.background import (BackgroundParams, densities,
                                                 dtauda, hubble_mpc)
from cosmomc_tpu_torch.models.recfast import ThermoHistory
from cosmomc_tpu_torch.utils.interp import cumsum, gradient, interp
from cosmomc_tpu_torch.utils.quad import gl_nodes


class ThermoDerived(NamedTuple):
    z_star: torch.Tensor
    r_star: torch.Tensor
    z_drag: torch.Tensor
    r_drag: torch.Tensor
    tau_reion_excluded: torch.Tensor
    kd: torch.Tensor


class ThermoTables(NamedTuple):
    x: torch.Tensor           # log(1+z), ascending
    xe: torch.Tensor
    kappa: torch.Tensor
    kappa_drag: torch.Tensor
    rs: torch.Tensor
    tm: torch.Tensor
    csq_b: torch.Tensor
    damp: torch.Tensor


def _cumtrapz(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    seg = 0.5 * (f[:, 1:] + f[:, :-1]) * (x[:, 1:] - x[:, :-1])
    return torch.cat([torch.zeros_like(seg[:, :1]), cumsum(seg)], -1)


def compute_thermo_tables(bg: BackgroundParams, th: ThermoHistory,
                          yhe: torch.Tensor) -> ThermoTables:
    xa = torch.log1p(th.z).flip(-1)
    zs = th.z.flip(-1)
    xe = th.xe.flip(-1)
    tm = th.tm.flip(-1)
    c = lambda v: v[:, None]
    mu_H = 1.0 / (1.0 - yhe)
    Nnow = const.n_H_today(bg.ombh2, mu_H)
    akthom = c(const.sigma_thomson * Nnow * const.Mpc)

    a = 1.0 / (1.0 + zs)
    Hm = hubble_mpc(bg, a)
    dkappa_dz = akthom * xe * (1.0 + zs) ** 2 / Hm
    dkappa_dx = dkappa_dz * (1.0 + zs)
    kappa = _cumtrapz(dkappa_dx, xa)

    d = densities(bg)
    R = 0.75 * c(bg.ombh2) * a / c(d["ogh2"])
    kappa_drag = _cumtrapz(dkappa_dx / R, xa)

    cs = 1.0 / torch.sqrt(3.0 * (1.0 + R))
    cum = _cumtrapz(cs * (1.0 + zs) / Hm, xa)
    rs_from_top = cum[:, -1:] - cum
    a_top = 1.0 / (1.0 + zs[:, -1])
    xs_, ws_ = gl_nodes(1e-9 ** 0.5, torch.sqrt(a_top), 96)
    aa = xs_ * xs_
    R_above = 0.75 * c(bg.ombh2) * aa / c(d["ogh2"])
    rs_above = torch.sum(ws_ * 2.0 * xs_ * dtauda(bg, aa)
                         / torch.sqrt(3.0 * (1.0 + R_above)), -1)
    rs = rs_from_top + c(rs_above)

    mu_b = 1.0 / (1.0 - (1.0 - 1.0 / const.mass_ratio_He_H) * c(yhe)
                  + xe * (1.0 - c(yhe)))
    lnTm = torch.log(torch.clamp(tm, min=1e-10))
    dlnTm_dx = gradient(lnTm, xa)
    csq_b = (const.k_B * tm / (mu_b * const.m_H * const.c ** 2)
             * (1.0 + dlnTm_dx / 3.0))

    f_da = ((R ** 2 + 16.0 * (1.0 + R) / 15.0) / (1.0 + R) ** 2
            * dtauda(bg, a) * a ** 2 / (torch.clamp(xe, min=1e-8) * akthom))
    cumd = _cumtrapz(f_da * a, xa)
    damp_above = torch.sum(ws_ * 2.0 * xs_ * (16.0 / 15.0)
                           * dtauda(bg, aa) * aa ** 2
                           / (c(xe[:, -1]) * akthom), -1)
    damp = (cumd[:, -1:] - cumd) + c(damp_above)
    return ThermoTables(xa, xe, kappa, kappa_drag, rs, tm, csq_b, damp)


def thermo_derived(bg: BackgroundParams, tab: ThermoTables) -> ThermoDerived:
    """z*, r*, z_drag, r_drag by inverse interpolation, per chain."""
    x = tab.x
    one = torch.ones_like(x[:, :1])
    z_star = torch.expm1(interp(one, tab.kappa, x))
    z_drag = torch.expm1(interp(one, tab.kappa_drag, x))
    xstar = torch.log1p(z_star)
    r_star = interp(xstar, x, tab.rs)
    r_drag = interp(torch.log1p(z_drag), x, tab.rs)
    kd = torch.sqrt(6.0 / interp(xstar, x, tab.damp))
    s = lambda v: v[:, 0]
    return ThermoDerived(s(z_star), s(r_star), s(z_drag), s(r_drag),
                         tab.kappa[:, -1], s(kd))
