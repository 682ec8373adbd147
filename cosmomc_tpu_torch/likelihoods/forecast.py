"""Fiducial-forecast dataset builders.

The reference ships `python/makePerfectForecastDataset.py` + the
CMBlikes.py writer to build forecast `.dataset` files from fiducial
spectra. Here the same capability produces plik_lite-format release files
(data/blmin/blmax/weights/cov, reader in likelihoods/pliklite.py and
CMB.f90:208-303) from any theory C_l table — used for the end-to-end CMB
posterior tests and demos because the real Planck plik_lite release files
are not shipped in the reference tree (only the .minimum.theory_cl best-fit
spectra are).

Covariance: Knox full-sky formula scaled by fsky, with isotropic white
noise from (fwhm_arcmin, muK_arcmin) — deliberately simple; the point is a
realistic posterior width, not Planck's exact correlation structure.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

PLMIN, PLMAX = 30, 2508
NBINCL = (215, 199, 199)


def plik_binning(nbins: int = 215) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous bin edges over PLMIN..PLMAX as (blmin0, blmax0) offsets
    from PLMIN (the release file convention)."""
    nL = PLMAX - PLMIN + 1
    edges = np.unique(np.linspace(0, nL, nbins + 1).astype(int))
    return edges[:-1], edges[1:] - 1


def knox_sigma(ls: np.ndarray, cl: np.ndarray, nl: np.ndarray,
               fsky: float) -> np.ndarray:
    """Per-l Gaussian sigma of C_l-hat (Knox 1995), same units as cl."""
    return np.sqrt(2.0 / ((2 * ls + 1) * fsky)) * (cl + nl)


def write_plik_lite_fiducial(out_dir: str, theory_cl_path: str,
                             fsky: float = 0.7,
                             fwhm_arcmin: float = 7.0,
                             noise_muk_arcmin_t: float = 33.0,
                             seed: int | None = None) -> str:
    """Build a plik_lite-format dataset whose bandpowers are the binned
    fiducial spectra (seed=None: zero scatter, 'perfect forecast') from a
    CosmoMC theory_cl file (columns L TT TE EE BB PP, l(l+1)C_l/2pi muK^2).

    Returns the .dataset path."""
    os.makedirs(out_dir, exist_ok=True)
    ref = np.loadtxt(theory_cl_path)
    L = ref[:, 0].astype(int)
    if L[0] > 2:
        raise ValueError("theory_cl must start at l=2")
    need = np.arange(PLMIN, PLMAX + 1)
    tt = np.interp(need, L, ref[:, 1])
    te = np.interp(need, L, ref[:, 2])
    ee = np.interp(need, L, ref[:, 3])

    # white noise N_l in D_l units
    theta = fwhm_arcmin * np.pi / (180.0 * 60.0)
    wt = (noise_muk_arcmin_t * np.pi / (180.0 * 60.0)) ** 2
    beam = np.exp(need * (need + 1) * theta ** 2 / (8.0 * np.log(2.0)))
    dl_fac = need * (need + 1) / (2 * np.pi)
    nl_tt = wt * beam * dl_fac
    nl_ee = 2.0 * wt * beam * dl_fac

    sig_tt = knox_sigma(need, tt, nl_tt, fsky)
    sig_ee = knox_sigma(need, ee, nl_ee, fsky)
    # TE variance: ((TT+N)(EE+N) + TE^2)/((2l+1) fsky)
    sig_te = np.sqrt(((tt + nl_tt) * (ee + nl_ee) + te ** 2)
                     / ((2 * need + 1) * fsky))

    blmin0, blmax0 = plik_binning(max(NBINCL))
    # release weights are for raw C_l; the reader multiplies by
    # 2pi/(l(l+1)), so store l(l+1)/2pi * (uniform-in-bin D_l weights,
    # normalized per bin) for exact uniform binning of D_l
    raw_w = need * (need + 1.0) / (2 * np.pi)
    for lo, hi in zip(blmin0, blmax0):
        raw_w[lo:hi + 1] /= (hi - lo + 1)

    rows, variances = [], []
    rng = np.random.default_rng(seed) if seed is not None else None
    for spec, sig, nb in (((tt, sig_tt, NBINCL[0])),
                          ((te, sig_te, NBINCL[1])),
                          ((ee, sig_ee, NBINCL[2]))):
        for b in range(nb):
            lo, hi = blmin0[b], blmax0[b]
            w = np.ones(hi - lo + 1) / (hi - lo + 1)
            val = float(w @ spec[lo:hi + 1])
            var = float(np.sum((w * sig[lo:hi + 1]) ** 2))
            if rng is not None:
                val += rng.normal(0.0, np.sqrt(var))
            rows.append(val)
            variances.append(var)
    nbins = len(rows)
    np.savetxt(os.path.join(out_dir, "blmin.dat"), blmin0, fmt="%d")
    np.savetxt(os.path.join(out_dir, "blmax.dat"), blmax0, fmt="%d")
    # weights file: uniform D_l binning == w_l proportional to l(l+1)/2pi
    np.savetxt(os.path.join(out_dir, "weights.dat"), raw_w)
    np.savetxt(os.path.join(out_dir, "data.dat"),
               np.column_stack([np.arange(1, nbins + 1), rows,
                                np.sqrt(variances)]))
    np.savetxt(os.path.join(out_dir, "cov.dat"), np.diag(variances))
    with open(os.path.join(out_dir, "cal.paramnames"), "w") as f:
        f.write("A_planck    A_{\\rm planck}\n")
    ds = os.path.join(out_dir, "plik_lite_fiducial.dataset")
    with open(ds, "w") as f:
        f.write("name = plik_lite_fiducial\n"
                "calibration_param = cal.paramnames\n"
                "data = data.dat\nblmin = blmin.dat\nblmax = blmax.dat\n"
                "weights = weights.dat\ncov_file = cov.dat\n"
                "use_cl = TT TE EE\n")
    return ds
