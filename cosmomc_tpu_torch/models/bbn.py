"""BBN consistency: YHe(ombh2, DeltaN) and D/H from a uniform grid.

Port of cosmomc_tpu/models/bbn.py (source/bbn.f90). `load_bbn_table` reads
a reference-format grid file and resamples it onto a fine uniform grid;
`synthetic_bbn_table` builds a smooth deterministic table without any
file. Lookups are bilinear with a closed-form index.

A `CMBPosterior` and an abundance likelihood always take their table
explicitly: nothing here reads a default path (the JAX package's
`load_bbn_table()` falls back to the reference data directory).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

COL_OMBH2, COL_ETA10, COL_DELTAN = 0, 1, 2
COL_YP, COL_YPBBN, COL_SIGYP, COL_DH, COL_SIGDH = 3, 4, 5, 6, 7

GRID_FIELDS = ("yp", "ypbbn", "dh", "sig_yp", "sig_dh")


@dataclass
class BBNTable:
    """Uniform grids over (ombh2, DeltaN); grids are numpy arrays or tensors."""
    ombh2_0: float
    ombh2_step: float
    dn_0: float
    dn_step: float
    yp: object
    ypbbn: object
    dh: object
    sig_yp: object
    sig_dh: object

    def to(self, device, dtype) -> "BBNTable":
        return dataclasses.replace(self, **{
            k: torch.as_tensor(np.asarray(getattr(self, k)) if not
                               torch.is_tensor(getattr(self, k))
                               else getattr(self, k), dtype=dtype,
                               device=device) for k in GRID_FIELDS})


def load_bbn_table(path: str, n_fine_omb: int = 768,
                   n_fine_dn: int = 320) -> BBNTable:
    """Parse a reference-format grid file and resample (host, numpy)."""
    raw = np.loadtxt(path)
    ombs = np.unique(raw[:, COL_OMBH2])
    dns = np.unique(raw[:, COL_DELTAN])
    n_o, n_d = len(ombs), len(dns)
    if n_o * n_d != raw.shape[0]:
        raise ValueError(f"BBN table {path} is not a full grid")
    order = np.lexsort((raw[:, COL_DELTAN], raw[:, COL_OMBH2]))
    g = raw[order].reshape(n_o, n_d, raw.shape[1])
    from scipy.interpolate import RectBivariateSpline
    fine_o = np.linspace(ombs[0], ombs[-1], n_fine_omb)
    fine_d = np.linspace(dns[0], dns[-1], n_fine_dn)

    def resample(c):
        return RectBivariateSpline(ombs, dns, g[:, :, c], kx=3, ky=3)(fine_o,
                                                                     fine_d)
    return BBNTable(float(fine_o[0]), float(fine_o[1] - fine_o[0]),
                    float(fine_d[0]), float(fine_d[1] - fine_d[0]),
                    resample(COL_YP), resample(COL_YPBBN), resample(COL_DH),
                    resample(COL_SIGYP), resample(COL_SIGDH))


def synthetic_bbn_grids(n_omb: int = 96, n_dn: int = 41):
    """The smooth deterministic stand-in for the PArthENoPE grid, for runs
    and tests without the data file: (ombh2 (n_omb,), DeltaN (n_dn,), a dict
    of (n_omb, n_dn) grids in GRID_FIELDS). Yp = 0.2454 at (ombh2, DeltaN) =
    (0.02237, 0), d Yp/d ln ombh2 = 0.0105, d Yp/d DeltaN = 0.013;
    D/H = 2.584e-5 (ombh2/0.02237)^-1.6 (1 + 0.135 DeltaN)."""
    omb = np.linspace(0.005, 0.05, n_omb)
    dn = np.linspace(-2.0, 2.0, n_dn)
    lo = np.log(omb / 0.02237)[:, None]
    d = dn[None, :]
    yp = 0.2454 + 0.0105 * lo + 0.013 * d - 0.0008 * lo ** 2
    mr = 3.9715
    ypbbn = 4.0 * yp / (mr - yp * (mr - 4.0))
    dh = 2.584e-5 * np.exp(-1.6 * lo) * (1.0 + 0.135 * d)
    ones = np.ones_like(yp)
    return omb, dn, dict(yp=yp, ypbbn=ypbbn, dh=dh, sig_yp=3e-4 * ones,
                         sig_dh=4e-7 * ones)


def synthetic_bbn_table(n_omb: int = 96, n_dn: int = 41) -> BBNTable:
    """`synthetic_bbn_grids` as a table (numpy grids)."""
    omb, dn, g = synthetic_bbn_grids(n_omb, n_dn)
    return BBNTable(float(omb[0]), float(omb[1] - omb[0]), float(dn[0]),
                    float(dn[1] - dn[0]), **g)


def _bilinear(tab: BBNTable, grid: torch.Tensor, ombh2: torch.Tensor,
              delta_n: torch.Tensor) -> torch.Tensor:
    x = (ombh2 - tab.ombh2_0) / tab.ombh2_step
    y = (delta_n - tab.dn_0) / tab.dn_step
    i = x.to(torch.int64).clamp(0, grid.shape[0] - 2)
    j = y.to(torch.int64).clamp(0, grid.shape[1] - 2)
    fx = (x - i.to(x.dtype)).clamp(0.0, 1.0)
    fy = (y - j.to(y.dtype)).clamp(0.0, 1.0)
    return ((1 - fx) * (1 - fy) * grid[i, j] + fx * (1 - fy) * grid[i + 1, j]
            + (1 - fx) * fy * grid[i, j + 1] + fx * fy * grid[i + 1, j + 1])


def yhe_bbn(ombh2, delta_n, table: BBNTable) -> torch.Tensor:
    """CMB mass fraction Y_He(ombh2, DeltaN), per chain."""
    return _bilinear(table, table.yp, ombh2, delta_n)


def ypbbn_bbn(ombh2, delta_n, table: BBNTable) -> torch.Tensor:
    """Nucleon-number fraction Yp^BBN (abundance-likelihood units), per
    chain."""
    return _bilinear(table, table.ypbbn, ombh2, delta_n)


def dh_bbn(ombh2, delta_n, table: BBNTable) -> torch.Tensor:
    """Primordial D/H prediction, per chain."""
    return _bilinear(table, table.dh, ombh2, delta_n)


def bbn_errors(ombh2, delta_n, table: BBNTable):
    """(sigma_Yp^BBN, sigma_D/H) theory errors of the table, per chain."""
    return (_bilinear(table, table.sig_yp, ombh2, delta_n),
            _bilinear(table, table.sig_dh, ombh2, delta_n))
