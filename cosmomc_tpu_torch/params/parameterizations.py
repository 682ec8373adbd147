"""Parameterizations: sampled vector -> physical BackgroundParams.

Port of three parameterizations of cosmomc_tpu/params/parameterizations.py
(source/CosmologyParameterizations.f90), batched: the full vector is (C, n).

  - theta (TP_ParamArrayToTheoryParams): ombh2, omch2, 100theta_MC, tau,
    omk, mnu, w, wa, nnu, alpha1, with H0 solved from theta by bisection;
  - background (:350-414): omegam, H0, omk, mnu, w, wa, nnu and an
    explicit ombh2 (for the drag sound horizon), omch2 derived;
  - astro (AP_ParamArrayToTheoryParams, :448-500): omegam, omegab, H0,
    omk, mnu, w, wa, nnu and a fixed tau, for LSS-only runs.
"""

from __future__ import annotations

import torch

from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models.background import BackgroundParams, h0_from_theta
from cosmomc_tpu_torch.params.space import Param, ParameterSpace, Speed


def mnu_to_omnuh2(mnu, nnu=3.046):
    """Sum of neutrino masses (eV) -> omnuh2."""
    return mnu / const.neutrino_mass_fac * (3.046 / 3.0) ** 0.75


def _apply_ini(specs, ini, sp: ParameterSpace) -> ParameterSpace:
    """Add `specs` to `sp`, each overridden by its ``param[name]`` ini line
    (one number fixes it; centre, min, max, start and propose widths vary
    it)."""
    for p in specs:
        if ini is not None and f"param[{p.name}]" in ini:
            parts = [float(x) for x in ini.string(f"param[{p.name}]").split()]
            if len(parts) == 1:
                p = Param(p.name, parts[0], parts[0], parts[0], 0, 0,
                          p.label, p.speed)
            else:
                p = Param(p.name, *parts[:5], label=p.label, speed=p.speed)
        sp.add(p)
    return sp


class BackgroundParameterization:
    """Sampled: omegam, H0, omk, mnu, w, wa, nnu [+ ombh2, by default with
    the Cooke+18 BBN prior]. The reference folds all matter but neutrinos
    into the baryons; ombh2 is explicit here because the drag sound horizon
    needs the baryon fraction."""

    names = ["omegam", "H0", "omk", "mnu", "w", "wa", "nnu", "ombh2"]

    def default_space(self, ini=None) -> ParameterSpace:
        return _apply_ini([
            Param("omegam", 0.3, 0.1, 0.7, 0.02, 0.02, r"\Omega_m", Speed.SLOW),
            Param("H0", 70.0, 40.0, 100.0, 2.0, 2.0, "H_0", Speed.SLOW),
            Param("omk", 0.0, 0.0, 0.0, 0, 0, r"\Omega_K", Speed.SLOW),
            Param("mnu", 0.06, 0.06, 0.06, 0, 0, r"\Sigma m_\nu", Speed.SLOW),
            Param("w", -1.0, -1.0, -1.0, 0, 0, "w", Speed.SLOW),
            Param("wa", 0.0, 0.0, 0.0, 0, 0, "w_a", Speed.SLOW),
            Param("nnu", 3.046, 3.046, 3.046, 0, 0, "N_{eff}", Speed.SLOW),
            Param("ombh2", 0.02236, 0.019, 0.026, 0.0005, 0.0005,
                  r"\Omega_b h^2", Speed.SLOW, prior_mean=0.02236,
                  prior_std=0.00036),
        ], ini, ParameterSpace())

    def to_background(self, full_P: torch.Tensor) -> BackgroundParams:
        """full_P (C, n) in `names` order -> BackgroundParams of (C,) fields."""
        omegam, H0, omk, mnu, w, wa, nnu, ombh2 = full_P[:, :8].unbind(-1)
        omnuh2 = mnu_to_omnuh2(mnu, nnu)
        omch2 = omegam * (H0 / 100.0) ** 2 - omnuh2 - ombh2
        return BackgroundParams(ombh2=ombh2, omch2=omch2, H0=H0, omk=omk,
                                omnuh2=omnuh2, nnu=nnu, w=w, wa=wa,
                                tcmb=torch.full_like(ombh2, const.COBE_CMBTemp),
                                num_massive_nu=1)


class AstroParameterization:
    """Sampled: omegam, omegab, H0, omk, mnu, w, wa, nnu: the reference's
    `astro` parameterization for LSS-only runs. As in the JAX package, the
    pipeline adds the primordial block as (logA, ns), and tau is a fixed
    parameter so that the thermal history is defined (the reference zeroes
    it; astro runs use no CMB likelihood)."""

    names = ["omegam", "omegab", "H0", "omk", "mnu", "w", "wa", "nnu", "tau"]

    def default_space(self, ini=None) -> ParameterSpace:
        return _apply_ini([
            Param("omegam", 0.3, 0.1, 0.7, 0.02, 0.02, r"\Omega_m", Speed.SLOW),
            Param("omegab", 0.0462, 0.03, 0.07, 0.002, 0.002,
                  r"\Omega_b", Speed.SLOW),
            Param("H0", 70.0, 40.0, 100.0, 2.0, 2.0, "H_0", Speed.SLOW),
            Param("omk", 0.0, 0.0, 0.0, 0, 0, r"\Omega_K", Speed.SLOW),
            Param("mnu", 0.06, 0.06, 0.06, 0, 0, r"\Sigma m_\nu", Speed.SLOW),
            Param("w", -1.0, -1.0, -1.0, 0, 0, "w", Speed.SLOW),
            Param("wa", 0.0, 0.0, 0.0, 0, 0, "w_a", Speed.SLOW),
            Param("nnu", 3.046, 3.046, 3.046, 0, 0, "N_{eff}", Speed.SLOW),
            Param("tau", 0.055, 0.055, 0.055, 0, 0, r"\tau", Speed.SLOW),
        ], ini, ParameterSpace())

    def to_background(self, full_P: torch.Tensor) -> BackgroundParams:
        """full_P (C, n) in `names` order -> BackgroundParams of (C,) fields."""
        omegam, omegab, H0, omk, mnu, w, wa, nnu = full_P[:, :8].unbind(-1)
        h2 = (H0 / 100.0) ** 2
        omnuh2 = mnu_to_omnuh2(mnu, nnu)
        ombh2 = omegab * h2
        omch2 = omegam * h2 - ombh2 - omnuh2
        return BackgroundParams(ombh2=ombh2, omch2=omch2, H0=H0, omk=omk,
                                omnuh2=omnuh2, nnu=nnu, w=w, wa=wa,
                                tcmb=torch.full_like(ombh2, const.COBE_CMBTemp),
                                num_massive_nu=1)


class ThetaParameterization:
    """Sampled: ombh2, omch2, 100theta_MC, [tau], omk, mnu, w, wa, nnu,
    alpha1; H0 in [h0_min, h0_max] from theta_MC."""

    names = ["ombh2", "omch2", "theta", "tau", "omk", "mnu", "w", "wa",
             "nnu", "alpha1"]

    def __init__(self, h0_min=20.0, h0_max=100.0, bisect_iters=47):
        self.h0_min = h0_min
        self.h0_max = h0_max
        self.bisect_iters = bisect_iters

    def default_space(self, ini=None) -> ParameterSpace:
        return _apply_ini([
            Param("ombh2", 0.0221, 0.005, 0.1, 0.0001, 0.0001,
                  r"\Omega_b h^2", Speed.SLOW),
            Param("omch2", 0.12, 0.001, 0.99, 0.001, 0.0005,
                  r"\Omega_c h^2", Speed.SLOW),
            Param("theta", 1.0411, 0.5, 10.0, 0.0004, 0.0002,
                  r"100\theta_{MC}", Speed.SLOW),
            Param("tau", 0.055, 0.01, 0.8, 0.006, 0.003, r"\tau", Speed.SLOW),
            Param("omk", 0.0, 0.0, 0.0, 0, 0, r"\Omega_K", Speed.SLOW),
            Param("mnu", 0.06, 0.06, 0.06, 0, 0, r"\Sigma m_\nu", Speed.SLOW),
            Param("w", -1.0, -1.0, -1.0, 0, 0, "w", Speed.SLOW),
            Param("wa", 0.0, 0.0, 0.0, 0, 0, "w_a", Speed.SLOW),
            Param("nnu", 3.046, 3.046, 3.046, 0, 0, "N_{eff}", Speed.SLOW),
            Param("alpha1", 0.0, 0.0, 0.0, 0, 0, r"\alpha_{-1}", Speed.SLOW),
        ], ini, ParameterSpace())

    def to_background(self, full_P: torch.Tensor) -> BackgroundParams:
        """full_P (C, n) in `names` order -> BackgroundParams of (C,) fields."""
        ombh2, omch2, theta = full_P[:, 0], full_P[:, 1], full_P[:, 2]
        omk, mnu, w, wa, nnu = (full_P[:, 4], full_P[:, 5], full_P[:, 6],
                                full_P[:, 7], full_P[:, 8])
        omnuh2 = mnu_to_omnuh2(mnu, nnu)
        tcmb = torch.full_like(ombh2, const.COBE_CMBTemp)

        def make_bg(H0):
            return BackgroundParams(ombh2=ombh2, omch2=omch2, H0=H0, omk=omk,
                                    omnuh2=omnuh2, nnu=nnu, w=w, wa=wa,
                                    tcmb=tcmb, num_massive_nu=1)
        H0 = h0_from_theta(theta, make_bg, self.h0_min, self.h0_max,
                           self.bisect_iters)
        return make_bg(H0)
