"""Synthetic BAO, SN and P(k) datasets in the readers' own file formats.

The DR12 consensus BAO set, the Pantheon SN set, the SDSS LRG DR4 and the
WiggleZ power spectra are not in the repository, so tests and
chip_smoke.py write look-alikes: the same files and keys the readers
(likelihoods/bao.py, sn.py, mpk.py) parse, at the shapes of the real sets.
A writer takes the measured values; called with none it writes
placeholders, so a caller can build the reader on the layout, compute the
theory at a truth point with it, and write the set again with those values
(optionally scattered by a seeded generator):

  - `write_dr12_bao`: DM_over_rs and bao_Hz_rs at z = 0.38, 0.51, 0.61,
    scaled by a fiducial r_d as the DR12 file is (`rs_rescale = 1/r_fid`),
    with a 6x6 covariance of 1.5% (DM) and 2% (H) errors and correlations
    between a redshift's pair and between neighbouring redshifts; with
    `fsigma8` the 9 rows of the DR12 "final consensus" layout (f_sigma8
    third at each z, 9% errors) and a 9x9 covariance;
  - `write_6df_bao`: the inline single-point form (rs_over_DV at 0.106);
  - `write_pantheon`: the Pantheon/JLA column layout, optionally with
    SALT2 stretch and colour columns and any of the six covmats;
  - `write_lrg_mpk`: the SDSS LRG DR4 layout (k bands, measurements,
    windows, optional covariance; D_V scaling at z = 0.35 and the Q model
    with a flat prior, as sdss_lrgDR4.dataset sets them);
  - `write_wigglez`: one WiggleZ redshift bin (7 regions of 50 points over
    100 k bands), its common dataset and the GiggleZ fiducial table.
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
#: the final-consensus layout: (DM_over_rs, bao_Hz_rs, f_sigma8) at each z
DR12_FS8_Z = np.repeat([0.38, 0.51, 0.61], 3)
DR12_FS8_TYPES = ["DM_over_rs", "bao_Hz_rs", "f_sigma8"] * 3
DR12_FS8_REL_ERR = np.array([0.015, 0.02, 0.09] * 3)
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
    """Covariance in DR12 order: 6x6 for (DM, H) at each z, 9x9 for (DM, H,
    f sigma8). Errors DR12_REL_ERR / DR12_FS8_REL_ERR of each value;
    correlation 0.4 within a redshift's distances, 0.3 (DM-fsigma8) and 0.4
    (H-fsigma8) within a redshift, 0.5 (same type) and 0.15 (other types)
    between neighbouring redshifts, 0.2 and 0.05 two apart."""
    per_z = 3 if len(values) == 9 else 2
    within = {(0, 1): 0.4, (0, 2): 0.3, (1, 2): 0.4}
    n = len(values)
    corr = np.eye(n)
    for i in range(n):
        for j in range(n):
            dz = abs(i // per_z - j // per_z)
            ti, tj = sorted((i % per_z, j % per_z))
            if i == j:
                continue
            corr[i, j] = (within[(ti, tj)] if dz == 0 else
                          {1: 0.5, 2: 0.2}[dz] if ti == tj else
                          {1: 0.15, 2: 0.05}[dz])
    rel = DR12_FS8_REL_ERR if per_z == 3 else DR12_REL_ERR
    sig = rel * np.abs(values)
    return corr * np.outer(sig, sig)


def _scatter(values, cov, rng):
    if rng is None:
        return values
    return values + np.linalg.cholesky(cov) @ rng.standard_normal(len(values))


def write_dr12_bao(out_dir: str, values: Optional[np.ndarray] = None,
                   rng: Optional[np.random.Generator] = None,
                   fsigma8: bool = False) -> str:
    """A DR12-shaped BAO set; `values` in DR12 order (DM_over_rs, bao_Hz_rs
    at each z, in the file's r_fid-scaled units; with `fsigma8` also
    f_sigma8 third at each z). Returns the .dataset."""
    os.makedirs(out_dir, exist_ok=True)
    zs, types = (DR12_FS8_Z, DR12_FS8_TYPES) if fsigma8 else (DR12_Z, DR12_TYPES)
    name = "sdss_DR12_fsigma8_synthetic" if fsigma8 else "sdss_DR12_synthetic"
    values = np.ones(len(zs)) if values is None else np.asarray(values, float)
    cov = dr12_covariance(values)
    obs = _scatter(values, cov, rng)
    with open(os.path.join(out_dir, name + "_measurements.txt"), "w") as f:
        f.write("# z value type\n")
        for z, v, t in zip(zs, obs, types):
            f.write(f"{z:.2f} {v:.10e} {t}\n")
    np.savetxt(os.path.join(out_dir, name + "_cov.txt"), cov, fmt="%.10e")
    return _ini(os.path.join(out_dir, name + ".dataset"), dict(
        name=name, num_bao=len(zs),
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


# ---------------------------------------------------------------------------
# P(k) sets
# ---------------------------------------------------------------------------

#: SDSS LRG DR4 (Tegmark et al. 2006) as sdss_lrgDR4.dataset lays it out:
#: 20 bandpowers over 65 k bands at z = 0.35, D_V scaling, the Q model
#: (Q = 30.3 +- 4.4, A = 1.4) with a flat prior on (b^2, b^2 Q)
LRG_NPTS, LRG_NKB, LRG_Z = 20, 65, 0.35
LRG_KEYS = dict(use_scaling="T", redshift=LRG_Z, Q_marge="T", Q_flat="T",
                Q_mid=30.3, Q_sigma=4.4, Ag=1.4)
#: the WiggleZ nov11 layout: per bin 7 regions of 50 points over 100 k
#: bands, 18 points used
WZ_NPTS, WZ_NKB, WZ_NUSE = 50, 100, 18


def _windows(kh: np.ndarray, k_eff: np.ndarray, width: float) -> np.ndarray:
    """Rows of Gaussian windows in ln k around each k_eff, each summing to 1."""
    w = np.exp(-0.5 * (np.log(kh[None, :] / k_eff[:, None]) / width) ** 2)
    return w / w.sum(-1, keepdims=True)


def lrg_layout(seed: int = 0) -> Dict[str, np.ndarray]:
    """k bands (h/Mpc), point centres and windows of an LRG DR4-shaped set."""
    rng = np.random.default_rng(seed)
    kh = np.exp(np.linspace(np.log(0.005), np.log(0.5), LRG_NKB))
    k_eff = np.exp(np.linspace(np.log(0.012), np.log(0.2), LRG_NPTS))
    return dict(kh=kh, k_eff=k_eff,
                W=_windows(kh, k_eff, 0.12 * rng.uniform(0.9, 1.1, LRG_NPTS)[:, None]))


def wigglez_layout(seed: int = 0) -> Dict[str, np.ndarray]:
    """k bands (h/Mpc) and the 7 regions' windows of a WiggleZ-shaped bin."""
    rng = np.random.default_rng(seed)
    kh = np.exp(np.linspace(np.log(0.005), np.log(0.6), WZ_NKB))
    k_eff = np.linspace(0.02, 0.3, WZ_NPTS)
    W = np.stack([_windows(kh, k_eff, 0.15 * rng.uniform(0.9, 1.1, (WZ_NPTS, 1)))
                  for _ in range(7)])
    return dict(kh=kh, k_eff=k_eff, W=W)


def _band_covariance(values: np.ndarray, rel_err: float, corr: float) -> np.ndarray:
    """rel_err of each value, correlation `corr` between neighbours."""
    sig = rel_err * np.abs(values)
    n = len(values)
    c = np.eye(n) + corr * (np.eye(n, k=1) + np.eye(n, k=-1))
    return c * np.outer(sig, sig)


def write_lrg_mpk(out_dir: str, layout: Dict[str, np.ndarray],
                  values: Optional[np.ndarray] = None,
                  settings: Optional[Dict[str, object]] = None,
                  with_cov: bool = False, rel_err: float = 0.05,
                  rng: Optional[np.random.Generator] = None,
                  name: str = "sdss_lrgDR4_synthetic") -> str:
    """An LRG DR4-format P(k) set: `values` the LRG_NPTS bandpowers ((Mpc/h)^3),
    `settings` dataset keys over LRG_KEYS (e.g. DV_fid, Q_flat, use_scaling).
    Errors `rel_err` of each value, in the measurements' sigma column or,
    `with_cov`, in a covariance file with neighbour correlation 0.3."""
    os.makedirs(out_dir, exist_ok=True)
    k_eff = layout["k_eff"]
    values = np.ones(len(k_eff)) if values is None else np.asarray(values, float)
    cov = _band_covariance(values, rel_err, 0.3 if with_cov else 0.0)
    obs = _scatter(values, cov, rng)
    sig = np.sqrt(np.diag(cov))
    np.savetxt(os.path.join(out_dir, name + "_kbands.txt"), layout["kh"],
               fmt="%.10e")
    np.savetxt(os.path.join(out_dir, name + "_measurements.txt"),
               np.column_stack([k_eff, 0.9 * k_eff, 1.1 * k_eff, obs, sig]),
               fmt="%.10e", header="k_eff k_lo k_hi P sigma")
    np.savetxt(os.path.join(out_dir, name + "_windows.txt"), layout["W"],
               fmt="%.10e")
    keys = dict(name=name, num_mpk_points_full=len(k_eff),
                num_mpk_kbands_full=len(layout["kh"]), min_mpk_points_use=1,
                max_mpk_points_use=len(k_eff), min_mpk_kbands_use=1,
                max_mpk_kbands_use=len(layout["kh"]),
                kbands_file=name + "_kbands.txt",
                measurements_file=name + "_measurements.txt",
                windows_file=name + "_windows.txt", **LRG_KEYS)
    if with_cov:
        np.savetxt(os.path.join(out_dir, name + "_cov.txt"), cov, fmt="%.10e")
        keys["cov_file"] = name + "_cov.txt"
    keys.update(settings or {})
    return _ini(os.path.join(out_dir, name + ".dataset"), keys)


def gigglez_fiducial(kh: np.ndarray, zbin: int) -> np.ndarray:
    """A smooth stand-in for the GiggleZ fiducial P(k) table of a bin: the
    bin's polynomial fit times (1 + 0.2 k/h)."""
    from cosmomc_tpu_torch.likelihoods.mpk import _GIGGLEZ_POLY
    return 10.0 ** np.polyval(_GIGGLEZ_POLY[zbin][::-1], kh) * (1.0 + 0.2 * kh)


def write_wigglez(out_dir: str, layout: Dict[str, np.ndarray],
                  redshift: float = 0.6, values: Optional[np.ndarray] = None,
                  DV_fid: float = -1.0,
                  common: Optional[Dict[str, object]] = None,
                  rel_err: float = 0.08,
                  rng: Optional[np.random.Generator] = None) -> str:
    """One WiggleZ bin: `values` (7, WZ_NUSE) bandpowers of the used points
    ((Mpc/h)^3; the rest are placeholders), the common dataset with
    `common` keys (Q_marge, Use_*-hr_region, ...) and the bin's GiggleZ
    fiducial table. Errors `rel_err`, neighbour correlation 0.2, per
    region. Returns the bin's .dataset (the reader finds the common one
    beside it)."""
    from cosmomc_tpu_torch.likelihoods.mpk import GIGGLEZ_FILES, WIGGLEZ_Z
    os.makedirs(out_dir, exist_ok=True)
    zbin = WIGGLEZ_Z[round(redshift, 2)]
    tag = "abcd"[zbin - 1]
    name = f"wigglez_nov11{tag}"
    full = np.ones((7, WZ_NPTS))
    if values is not None:
        full[:, :WZ_NUSE] = values
    rows, covs = [], []
    for r in range(7):
        cov = _band_covariance(full[r], rel_err, 0.2)
        covs.append(cov)
        obs = _scatter(full[r], cov, rng)
        rows += [(k, 0.9 * k, 1.1 * k, v, np.sqrt(c))
                 for k, v, c in zip(layout["k_eff"], obs, np.diag(cov))]
    np.savetxt(os.path.join(out_dir, "wigglez_nov11_kbands.txt"), layout["kh"],
               fmt="%.10e")
    np.savetxt(os.path.join(out_dir, name + "_measurements.txt"), rows,
               fmt="%.10e")
    np.savetxt(os.path.join(out_dir, name + "_windows.txt"),
               layout["W"].reshape(7 * WZ_NPTS, WZ_NKB), fmt="%.10e")
    np.savetxt(os.path.join(out_dir, name + "_cov.txt"),
               np.concatenate(covs), fmt="%.10e")
    kg = np.exp(np.linspace(np.log(1e-3), np.log(1.0), 200))
    np.savetxt(os.path.join(out_dir, GIGGLEZ_FILES[zbin]),
               np.column_stack([kg, gigglez_fiducial(kg, zbin)]), fmt="%.10e")
    keys = dict(num_mpk_points_full=WZ_NPTS, num_mpk_kbands_full=WZ_NKB,
                min_mpk_points_use=1, max_mpk_points_use=WZ_NUSE,
                min_mpk_kbands_use=1, max_mpk_kbands_use=WZ_NKB,
                kbands_file="wigglez_nov11_kbands.txt", use_scaling="T",
                Q_marge="F", Q_mid=4.0, Q_sigma=1.5, Ag=1.4)
    keys.update(common or {})
    _ini(os.path.join(out_dir, "wigglez_nov11_common.dataset"), keys)
    return _ini(os.path.join(out_dir, name + ".dataset"), dict(
        name=f"WiggleZ_{tag}", redshift=redshift, DV_fid=DV_fid,
        measurements_file=name + "_measurements.txt",
        windows_file=name + "_windows.txt", cov_file=name + "_cov.txt"))


def mpk_bandpowers(like, theory) -> np.ndarray:
    """The windowed theory of an MPK or WiggleZ reader at b^2 = 1 and Q = 0
    for the first chain of `theory`: the values that make the set's chi^2
    vanish there ((npoints,) or (regions, npoints))."""
    import torch
    P, kh = like._theory_pk_h(theory, like._scaling(theory))
    if getattr(like, "use_gigglez", False):
        P = like._gigglez_correct(P, kh)
    if like.Q_marge:
        P = P / (1.0 + like.Ag * kh)
    W = like._W.to(P.dtype)
    out = torch.einsum("...k,k->...", W, P[0])
    return out.double().cpu().numpy()
