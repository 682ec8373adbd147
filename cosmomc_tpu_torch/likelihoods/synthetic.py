"""Synthetic BAO and SN datasets in the readers' own file formats.

The DR12 consensus BAO set and the Pantheon SN set are not in the
repository, so tests and chip_smoke.py write look-alikes: the same files
and keys the readers (likelihoods/bao.py, sn.py) parse, at the shapes of
the real sets. A writer takes the measured values; called with none it
writes placeholders, so a caller can build the reader on the layout,
compute the theory at a truth point with it, and write the set again with
those values (optionally scattered by a seeded generator):

  - `write_dr12_bao`: DM_over_rs and bao_Hz_rs at z = 0.38, 0.51, 0.61,
    scaled by a fiducial r_d as the DR12 file is (`rs_rescale = 1/r_fid`),
    with a 6x6 covariance of 1.5% (DM) and 2% (H) errors and correlations
    between a redshift's pair and between neighbouring redshifts;
  - `write_6df_bao`: the inline single-point form (rs_over_DV at 0.106);
  - `write_pantheon`: the Pantheon/JLA column layout, optionally with
    SALT2 stretch and colour columns and any of the six covmats.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

#: the truth point of the background configuration's synthetic sets
BACKGROUND_TRUTH = dict(omegam=0.31, H0=68.0, ombh2=0.02236)

DR12_Z = np.array([0.38, 0.38, 0.51, 0.51, 0.61, 0.61])
DR12_TYPES = ["DM_over_rs", "bao_Hz_rs"] * 3
DR12_RS_FID = 147.78                   # Mpc
DR12_REL_ERR = np.array([0.015, 0.02] * 3)
SIXDF_Z, SIXDF_TYPE, SIXDF_REL_ERR = 0.106, "rs_over_DV", 0.045
#: mb - mu_model of the readers' convention (mu without the +25): M + 25
SN_MB_OFFSET = 5.65

PANTHEON_HEADER = ("#name zcmb zhel dz mb dmb x1 dx1 color dcolor 3rdvar "
                   "d3rdvar cov_m_s cov_m_c cov_s_c set ra dec biascor")


def _ini(path: str, keys: Dict[str, object]) -> str:
    with open(path, "w") as f:
        for k, v in keys.items():
            f.write(f"{k} = {v}\n")
    return path


def dr12_covariance(values: np.ndarray) -> np.ndarray:
    """6x6 covariance in DR12 order (DM, H at each z): DR12_REL_ERR of each
    value, correlation 0.4 within a redshift's pair, 0.5 (DM-DM, H-H) and
    0.15 (DM-H) between neighbouring redshifts, 0.2 and 0.05 two apart."""
    corr = np.eye(6)
    for i in range(6):
        for j in range(6):
            dz, same = abs(i // 2 - j // 2), i % 2 == j % 2
            if i == j:
                continue
            corr[i, j] = ({0: 0.4, 1: 0.15, 2: 0.05}[dz] if not same
                          else {1: 0.5, 2: 0.2}[dz])
    sig = DR12_REL_ERR * np.abs(values)
    return corr * np.outer(sig, sig)


def _scatter(values, cov, rng):
    if rng is None:
        return values
    return values + np.linalg.cholesky(cov) @ rng.standard_normal(len(values))


def write_dr12_bao(out_dir: str, values: Optional[np.ndarray] = None,
                   rng: Optional[np.random.Generator] = None) -> str:
    """A DR12-shaped BAO set; `values` in DR12 order (DM_over_rs, bao_Hz_rs
    at each z, in the file's r_fid-scaled units). Returns the .dataset."""
    os.makedirs(out_dir, exist_ok=True)
    name = "sdss_DR12_synthetic"
    values = np.ones(6) if values is None else np.asarray(values, float)
    cov = dr12_covariance(values)
    obs = _scatter(values, cov, rng)
    with open(os.path.join(out_dir, name + "_measurements.txt"), "w") as f:
        f.write("# z value type\n")
        for z, v, t in zip(DR12_Z, obs, DR12_TYPES):
            f.write(f"{z:.2f} {v:.10e} {t}\n")
    np.savetxt(os.path.join(out_dir, name + "_cov.txt"), cov, fmt="%.10e")
    return _ini(os.path.join(out_dir, name + ".dataset"), dict(
        name=name, num_bao=6,
        bao_measurements_file=name + "_measurements.txt",
        bao_measurements_file_has_error="F",
        bao_cov_file=name + "_cov.txt",
        rs_rescale=repr(1.0 / DR12_RS_FID)))


def write_6df_bao(out_dir: str, value: Optional[float] = None,
                  rng: Optional[np.random.Generator] = None) -> str:
    """The inline single-point form: rs/D_V at z = 0.106."""
    os.makedirs(out_dir, exist_ok=True)
    name = "sdss_6DF_synthetic"
    value = 1.0 if value is None else float(value)
    err = SIXDF_REL_ERR * abs(value)
    obs = float(_scatter(np.array([value]), np.array([[err * err]]), rng)[0])
    return _ini(os.path.join(out_dir, name + ".dataset"), dict(
        name=name, measurement_type=SIXDF_TYPE, zeff=SIXDF_Z,
        bao_measurement=f"{obs:.10e} {err:.10e}"))


def pantheon_columns(n: int, seed: int = 0, salt2: bool = False
                     ) -> Dict[str, np.ndarray]:
    """Every column of a Pantheon-format file but mb, from a seeded
    generator: z from 0.01 to 2.3 (most below 0.7), errors 0.08-0.2 mag,
    host masses about 10 in 3rdvar. `salt2` adds stretch and colour
    columns and their covariances (a JLA-style set)."""
    rng = np.random.default_rng(seed)
    zcmb = np.sort(np.where(rng.random(n) < 0.8,
                            np.exp(rng.uniform(np.log(0.01), np.log(0.7), n)),
                            rng.uniform(0.7, 2.3, n)))
    zero = np.zeros(n)
    cols = dict(zcmb=zcmb, zhel=zcmb + rng.uniform(-1e-3, 1e-3, n),
                dz=zero, dmb=rng.uniform(0.08, 0.2, n), x1=zero, dx1=zero,
                color=zero, dcolor=zero, thirdvar=rng.normal(10.0, 0.6, n),
                dthirdvar=np.full(n, 0.1), cov_m_s=zero, cov_m_c=zero,
                cov_s_c=zero)
    if salt2:
        cols.update(x1=rng.normal(0.0, 1.0, n), dx1=rng.uniform(0.1, 0.5, n),
                    color=rng.normal(0.0, 0.08, n),
                    dcolor=rng.uniform(0.02, 0.05, n),
                    cov_m_s=rng.uniform(-2e-3, 2e-3, n),
                    cov_m_c=rng.uniform(-1e-3, 1e-3, n),
                    cov_s_c=rng.uniform(-1e-3, 1e-3, n))
    return cols


def sn_covmat(zcmb: np.ndarray, amp: float = 0.03, seed: int = 1
              ) -> np.ndarray:
    """A positive semi-definite systematic covariance: 4 smooth modes in
    log z of rms up to `amp` mag, summed as outer products."""
    rng = np.random.default_rng(seed)
    x = np.log(zcmb / zcmb.min()) / np.log(zcmb.max() / zcmb.min())
    modes = np.stack([np.cos(np.pi * k * x + rng.uniform(0, np.pi))
                      for k in range(4)])
    modes *= amp * rng.uniform(0.3, 1.0, (4, 1))
    return modes.T @ modes


def write_pantheon(out_dir: str, cols: Dict[str, np.ndarray],
                   mb: Optional[np.ndarray] = None,
                   covmats: Optional[Dict[str, np.ndarray]] = None,
                   twoscriptmfit: bool = False,
                   rng: Optional[np.random.Generator] = None,
                   name: str = "pantheon_synthetic") -> str:
    """A Pantheon-format SN set (pecz and intrinsicdisp 0: the errors
    include them, as in Pantheon's release). `covmats` maps reader keys
    (mag, stretch, colour, mag_stretch, mag_colour, stretch_colour) to
    matrices, written as the dimension followed by the entries. `rng`
    scatters mb by dmb."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(cols["zcmb"])
    mb = np.zeros(n) if mb is None else np.asarray(mb, float)
    if rng is not None:
        mb = mb + cols["dmb"] * rng.standard_normal(n)
    table = np.column_stack([
        cols["zcmb"], cols["zhel"], cols["dz"], mb, cols["dmb"], cols["x1"],
        cols["dx1"], cols["color"], cols["dcolor"], cols["thirdvar"],
        cols["dthirdvar"], cols["cov_m_s"], cols["cov_m_c"], cols["cov_s_c"],
        np.ones(n), np.zeros(n), np.zeros(n), np.zeros(n)])
    with open(os.path.join(out_dir, name + ".txt"), "w") as f:
        f.write(PANTHEON_HEADER + "\n")
        for i, row in enumerate(table):
            f.write(f"SN{i:04d} " + " ".join(f"{v:.10e}" for v in row) + "\n")
    keys = dict(name=name, data_file=name + ".txt", pecz=0.0,
                intrinsicdisp=0.0,
                twoscriptmfit="T" if twoscriptmfit else "F", scriptmcut=10.0)
    for key, mat in (covmats or {}).items():
        fname = f"{name}_{key}_covmat.txt"
        np.savetxt(os.path.join(out_dir, fname),
                   np.concatenate([[n], np.asarray(mat).ravel()]), fmt="%.10e")
        keys[f"has_{key}_covmat"] = "T"
        keys[f"{key}_covmat_file"] = fname
    return _ini(os.path.join(out_dir, name + ".dataset"), keys)
