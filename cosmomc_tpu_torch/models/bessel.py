"""Spherical Bessel function tables for line-of-sight integration.

Port of cosmomc_tpu/models/bessel.py (numpy, copied). Replaces
camb/bessels.f90 (InitSpherBessels). j_l(x) and j_l'(x) are
universal functions: computed once on the host in float64 with the stable
downward-recurrence (Miller) algorithm, tabulated on a uniform x-grid, and
evaluated on device by linear interpolation (grid is fine enough that
interpolation error ~1e-7 relative to the oscillation envelope).

j_l'' needed by the temperature quadrupole term comes from the ODE
  j_l'' = -2/x j_l' + (l(l+1)/x^2 - 1) j_l
instead of a third table.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np


def _sph_jn_array(ls: np.ndarray, x: np.ndarray) -> np.ndarray:
    """j_l(x) for all l in ls, vectorized over x. Host float64 via scipy
    (AMOS-backed, stable for all l, x)."""
    from scipy.special import spherical_jn
    out = np.empty((ls.size, x.size))
    for i, l in enumerate(ls):
        out[i] = spherical_jn(int(l), x)
    return out


class BesselTable(NamedTuple):
    ls: np.ndarray        # (nl,) int32 multipoles tabulated
    x0: float             # grid start (0)
    dx: float             # grid spacing
    jl: np.ndarray        # (nl, nx) j_l values (float32 on every path)
    jlp: np.ndarray       # (nl, nx) j_l' values


@lru_cache(maxsize=4)
def build_bessel_table(ls_tuple: Tuple[int, ...], xmax: float,
                       dx: float = 0.2) -> BesselTable:
    """Host-precomputed table; cached per (l-set, xmax)."""
    ls = np.asarray(ls_tuple, np.int64)
    nx = int(np.ceil(xmax / dx)) + 4
    x = np.arange(nx) * dx
    jl = _sph_jn_array(ls, x)
    # derivative: j_l' = j_{l-1} - (l+1)/x j_l ; compute j_{l-1} too
    lsm1 = np.maximum(ls - 1, 0)
    all_l = np.unique(np.concatenate([ls, lsm1]))
    jall = _sph_jn_array(all_l, x)
    index = {int(l): i for i, l in enumerate(all_l)}
    xnz = np.where(x == 0.0, 1.0, x)
    jlp = np.zeros_like(jl)
    for i, l in enumerate(ls):
        li = int(l)
        if li == 0:
            jlp[i] = -jall[index[1]] if 1 in index else np.gradient(jl[i], dx)
        else:
            jlp[i] = jall[index[li - 1]] - (li + 1) / xnz * jl[i]
            jlp[i, x == 0.0] = 0.0
    # float32 tables even on the float64 path: readers cast on use
    return BesselTable(ls.astype(np.int32), 0.0, dx,
                       jl.astype(np.float32), jlp.astype(np.float32))


def default_l_samples(lmax: int) -> np.ndarray:
    """Sparse l sampling for transfer computation, spline-filled later
    (reference: camb/modules.f90 lvalues module strategy — dense at low l,
    stride growing toward high l)."""
    ls = list(range(2, 20))
    l = 20
    step = 3
    while l < lmax:
        ls.append(l)
        if l > 60:
            step = 7
        if l > 120:
            step = 20
        if l > 400:
            step = 35
        if l > 1300:
            step = 50
        l += step
    ls.append(lmax)
    return np.unique(np.asarray(ls, np.int64))
