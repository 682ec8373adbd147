"""Massive-neutrino background energy density and pressure.

rho_nu(am) and p_nu(am) in units of one massless neutrino species
(camb/modules.f90 Nu_rho/Nu_background :1640-1715):

  rho(am) = 1/const * int_0^inf dq q^2 sqrt(q^2 + am^2) / (e^q + 1)
  p(am)   = 1/(3 const) * int dq q^4 / sqrt(q^2 + am^2) / (e^q + 1)
  const   = 7 pi^4 / 120

Small-am and large-am series at the ends; in between a table of log rho
and log p on a uniform log-am grid (host numpy, float64, Gauss-Laguerre),
read with a closed-form index and linear interpolation in log am. The
table is cast to the caller's dtype before the lookup, as the JAX package
does, so both packages read the same rounded nodes.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmomc_tpu_torch.models.constants import nu_const, zeta3, zeta5, zeta7

_AM_MIN = 0.01
_AM_MAX = 600.0
_N_TAB = 2000

_const2 = 5.0 / (7.0 * np.pi ** 2)


def _integrate_tables():
    q, w = np.polynomial.laguerre.laggauss(160)
    am = np.exp(np.linspace(np.log(_AM_MIN), np.log(_AM_MAX), _N_TAB))
    qq = q[None, :]
    root = np.sqrt(qq ** 2 + am[:, None] ** 2)
    denom = 1.0 + np.exp(-qq)
    rho = (w[None, :] * qq ** 2 * root / denom).sum(axis=1) / nu_const
    p = (w[None, :] * qq ** 4 / root / denom).sum(axis=1) / (3.0 * nu_const)
    return am, rho, p


_am_tab, _rho_tab, _p_tab = _integrate_tables()
LOG_RHO = np.log(_rho_tab)
LOG_P = np.log(_p_tab)
LOG_AM0 = float(np.log(_AM_MIN))
DLOG_AM = float((np.log(_AM_MAX) - np.log(_AM_MIN)) / (_N_TAB - 1))
AM_LO = _AM_MIN * 1.1        # below: small-am series
AM_HI = _AM_MAX * 0.9        # above: large-am series

_TABLES = {}


def table(which: str, device, dtype) -> torch.Tensor:
    """The log-rho ("rho") or log-p ("p") table on a device, in a dtype
    (cached: the kernels read the same tensor)."""
    key = (which, str(device), dtype)
    if key not in _TABLES:
        src = LOG_RHO if which == "rho" else LOG_P
        _TABLES[key] = torch.as_tensor(src, dtype=dtype, device=device)
    return _TABLES[key]


def _tab_lookup(am: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    t = (torch.log(am.clamp(AM_LO, AM_HI)) - LOG_AM0) / DLOG_AM
    i = t.to(torch.int64).clamp(0, _N_TAB - 2)
    f = t - i.to(t.dtype)
    return torch.exp(tab[i] * (1.0 - f) + tab[i + 1] * f)


def nu_rho(am: torch.Tensor) -> torch.Tensor:
    """Massive-nu energy density / massless density; am any-shaped tensor.
    The large-am series reads am clamped to its range, so that at am = 0
    (mnu = 0) its 1/am does not turn the gradient into NaN through the
    unselected branch; the JAX package's gradient is NaN there."""
    small = 1.0 + _const2 * am ** 2
    amb = am.clamp(min=AM_HI)
    big = 3.0 / (2.0 * nu_const) * (zeta3 * amb + 15.0 * zeta5 / (2.0 * amb))
    mid = _tab_lookup(am, table("rho", am.device, am.dtype))
    return torch.where(am <= AM_LO, small, torch.where(am >= AM_HI, big, mid))


def nu_pres(am: torch.Tensor) -> torch.Tensor:
    """Massive-nu pressure / massless density (p of one massless = rho/3);
    the large-am series as in `nu_rho`."""
    small = (2.0 - (1.0 + _const2 * am ** 2)) / 3.0
    amb = am.clamp(min=AM_HI)
    big = (900.0 / 120.0 / nu_const) * (zeta5 - 63.0 / 4.0 * zeta7 / amb ** 2) / amb
    mid = _tab_lookup(am, table("p", am.device, am.dtype))
    return torch.where(am <= AM_LO, small, torch.where(am >= AM_HI, big, mid))
