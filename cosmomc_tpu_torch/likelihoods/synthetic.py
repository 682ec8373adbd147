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
    100 k bands), its common dataset and the GiggleZ fiducial table;
  - `write_bbn_table` and `write_abundance`: the reference-format BBN grid
    (the synthetic table's formulas) and Yp / D/H `.dataset`s;
  - `write_des_wl`: DES 1YR's 3x2pt layout (4 source and 5 lens bins, 20
    theta bins, 900 rows, scale cuts keeping about half);
  - `write_sz_selection` and `write_sz_catalogue`: the Planck 2015 SZ
    layout (417 patches x 80 theta noise maps, a catalogue of given counts
    with a few missing redshifts).
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


# ---------------------------------------------------------------------------
# CMB bandpower sets: SPTpol TE/EE and BB, an SPT-SZ-shaped CMBLike2 TT set,
# a BK15-shaped set, and a high-l lensed template
# ---------------------------------------------------------------------------

#: SPTpol 500d TE/EE (Henning et al. 2018): 56 bins a spectrum over
#: 50 < l <= 8000; here 49 bins of 50 to l = 2500, then 7 wider ones
SPTPOL_TEEE_EDGES = np.concatenate([np.arange(50, 2501, 50),
                                    [3000, 3500, 4000, 5000, 6000, 7000, 8001]])
#: SPTpol 500d BB (Sayre et al. 2019): 7 bins over 52 < l < 2301, three
#: cross-spectra (150x150, 95x150, 95x95)
SPTPOL_BB_EDGES = np.array([50, 250, 500, 750, 1000, 1300, 1650, 2301])
#: SPT-SZ 2500d TT (Story et al. 2013): 47 bandpowers of width 50 over
#: 650 < l <= 3000
SPTSZ_EDGES = np.arange(651, 3002, 50)
#: BK15: 9 bins of width 35 from l = 20
BK_EDGES = np.arange(20, 336, 35)
BK_BANDS = (95, 150, 220)
BK_PARAMS = ("BBdust", "BBsync", "BBalphadust", "BBbetadust", "BBTdust",
             "BBalphasync", "BBbetasync", "BBdustsynccorr", "EEtoBB_dust",
             "EEtoBB_sync", "Delta_dust", "Delta_sync", "gamma_corr",
             "gamma_95", "gamma_150", "gamma_220")


def _bin_centres(edges: np.ndarray) -> np.ndarray:
    return 0.5 * (edges[:-1] + edges[1:] - 1)


def _tophat(l: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """A window 1/(hi-lo) over lo <= l < hi."""
    return ((l >= lo) & (l < hi)) / float(hi - lo)


def _bandpower_sigma(values: np.ndarray, ls: np.ndarray, rel: float,
                     floor: float, l_noise: float) -> np.ndarray:
    """rel of each value plus `floor` of the spectrum's largest value,
    the floor growing as (l / l_noise)^2 (noise-dominated bins)."""
    scale = np.abs(values).max() if np.abs(values).max() > 0 else 1.0
    return rel * np.abs(values) + floor * scale * (1.0 + (ls / l_noise) ** 2)


def _write_sptpol(out_dir: str, prefix: str, edges: np.ndarray,
                  values: np.ndarray, corr_cross: float, seed: int,
                  settings: Optional[Dict[str, object]] = None) -> str:
    """Desc, bandpowers, covariance, windows/window_<i> and beam errors of
    an SPTpol set; `values` (n_spectra, nbin)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "windows"), exist_ok=True)
    nspec, nbin = values.shape
    lmin, lmax = int(edges[0]), int(edges[-1] - 1)
    ls = _bin_centres(edges)
    with open(os.path.join(out_dir, f"{prefix}_desc.txt"), "w") as f:
        f.write(f"{nbin} 1\n{lmin} {lmax}\n")
    np.savetxt(os.path.join(out_dir, f"{prefix}_bp.txt"),
               np.column_stack([np.tile(np.arange(1, nbin + 1), nspec),
                                values.reshape(-1)]), fmt=["%d", "%.17g"])
    sig = np.concatenate([_bandpower_sigma(v, ls, 0.03, 0.01, 3000.0)
                          for v in values])
    n = nspec * nbin
    corr = np.eye(n)
    for i in range(n):
        for j in range(n):
            if i != j and i // nbin == j // nbin and abs(i - j) == 1:
                corr[i, j] = 0.1            # neighbouring bins of a spectrum
            elif i != j and i % nbin == j % nbin:
                corr[i, j] = corr_cross     # one bin of two spectra
    np.savetxt(os.path.join(out_dir, f"{prefix}_cov.txt"),
               corr * np.outer(sig, sig), fmt="%.17g")
    l = np.arange(lmin, lmax + 1)
    for i in range(n):
        b = i % nbin
        sel = (l >= edges[b]) & (l < edges[b + 1])
        np.savetxt(os.path.join(out_dir, "windows", f"window_{i + 1}"),
                   np.column_stack([l[sel], _tophat(l[sel], edges[b],
                                                    edges[b + 1])]),
                   fmt=["%d", "%.17g"])
    beam = rng.uniform(-1.0, 1.0, (2, 1)) * 0.01 * (1.0 + np.tile(ls, nspec)
                                                   / 2000.0)[None, :]
    np.savetxt(os.path.join(out_dir, f"{prefix}_beam.txt"),
               np.column_stack([np.tile(np.arange(1, n + 1), 2),
                                beam.reshape(-1)]), fmt=["%d", "%.17g"])
    keys = {f"{prefix}_desc_file": f"{prefix}_desc.txt",
            f"{prefix}_bp_file": f"{prefix}_bp.txt",
            f"{prefix}_cov_file": f"{prefix}_cov.txt",
            f"{prefix}_window_dir": "windows",
            f"{prefix}_beam_file": f"{prefix}_beam.txt"}
    keys.update(settings or {})
    return _ini(os.path.join(out_dir, f"{prefix}.dataset"), keys)


def write_sptpol_teee(out_dir: str, values: Optional[np.ndarray] = None,
                      edges: np.ndarray = SPTPOL_TEEE_EDGES,
                      settings: Optional[Dict[str, object]] = None) -> str:
    """An SPTpol TE/EE set in the 2017 release's layout: `values` (2, nbin)
    the TE and EE bandpowers (D_l, muK^2) over the bins `edges` (by default
    56 bins over 50 <= l <= 8000). Errors 3% of each bandpower plus 1% of
    the spectrum's largest, growing as (l/3000)^2; correlation 0.1 between
    neighbouring bins and 0.2 between TE and EE of a bin; two seeded
    beam-error templates; top-hat windows. `settings` adds dataset keys
    (correct_aberration, the prior switches). Returns the .dataset."""
    nbin = len(edges) - 1
    values = np.ones((2, nbin)) if values is None else np.asarray(values, float)
    return _write_sptpol(out_dir, "sptpol_TEEE", edges, values, 0.2, 0,
                         settings)


def write_sptpol_bb(out_dir: str, values: Optional[np.ndarray] = None) -> str:
    """An SPTpol BB set in the 2019 release's layout: `values` (3, 7) the
    150x150, 95x150 and 95x95 bandpowers over SPTPOL_BB_EDGES (7 bins over
    50 <= l <= 2300); errors and windows as write_sptpol_teee, correlation
    0.5 between the crosses of a bin."""
    nbin = len(SPTPOL_BB_EDGES) - 1
    values = np.ones((3, nbin)) if values is None else np.asarray(values, float)
    return _write_sptpol(out_dir, "sptpol_BB", SPTPOL_BB_EDGES, values, 0.5, 1)


def sptpol_bandpowers(like, theory) -> np.ndarray:
    """The binned model of an SPTpol reader for the first chain of
    `theory` at its nuisance centres, (n_spectra, nbin): the bandpowers
    that make delta vanish there."""
    import torch
    nu = torch.as_tensor([[p.center for p in like.nuisance if p.varying]],
                         dtype=like.dtype, device=like.device)
    out = like.model(theory, nu)[0].double().cpu().numpy()
    return out.reshape(-1, like.nbin)


def _cl_file(path: str, names, index: np.ndarray, values: np.ndarray) -> None:
    np.savetxt(path, np.column_stack([index, values]),
               fmt=["%d"] + ["%.17g"] * values.shape[1],
               header="bin " + " ".join(names))


def write_cmblikes_tt(out_dir: str, values: Optional[np.ndarray] = None,
                      like_approx: str = "gaussian", lrange=(2, 40)) -> str:
    """A CMBLike2 TT set shaped as SPT-SZ 2500d's spt_s13_margfg.dataset:
    binned over SPTSZ_EDGES (47 bandpowers of width 50 over 650 < l <= 3000),
    top-hat windows, a calibration parameter (sptsz_cal, with a
    log-calibration prior) and an aberration coefficient. `like_approx`
    "gaussian" (the release's), "HL" (the fiducial is `values`) or "exact"
    (unbinned over `lrange`, fullsky_exact_fksy 0.57, no covariance).
    `values` the bandpowers (one a bin, or a multipole for "exact", D_l
    muK^2) without noise; the noise is 5% of each value times (l/2000)^2.
    Bandpower errors 2% plus 0.5% of the largest, growing as (l/2000)^2."""
    os.makedirs(os.path.join(out_dir, "windows"), exist_ok=True)
    name, edges = "sptsz_2500d_synthetic", SPTSZ_EDGES
    binned = like_approx != "exact"
    ls = (_bin_centres(edges) if binned else
          np.arange(lrange[0], lrange[1] + 1, dtype=float))
    values = np.ones(len(ls)) if values is None else np.asarray(values, float)
    index = np.arange(1, len(ls) + 1) if binned else ls.astype(int)
    noise = 0.05 * np.abs(values) * (ls / 2000.0) ** 2
    _cl_file(os.path.join(out_dir, name + "_cl_hat.dat"), ["TT"], index,
             values[:, None])
    keys = dict(like_approx=like_approx, fields_use="T",
                binned="T" if binned else "F",
                cl_hat_file=name + "_cl_hat.dat",
                calibration_param=name + "_cal.paramnames",
                log_calibration_prior=0.026, aberration_coeff=-0.0004826)
    with open(os.path.join(out_dir, name + "_cal.paramnames"), "w") as f:
        f.write("sptsz_cal   T_{\\rm cal}^{\\rm SPT-SZ}\n")
    if like_approx != "gaussian":
        _cl_file(os.path.join(out_dir, name + "_cl_noise.dat"), ["TT"], index,
                 noise[:, None])
        keys["cl_noise_file"] = name + "_cl_noise.dat"
    if binned:
        lmin, lmax = int(edges[0]), int(edges[-1] - 1)
        l = np.arange(lmin, lmax + 1)
        for b in range(len(ls)):
            sel = (l >= edges[b]) & (l < edges[b + 1])
            np.savetxt(os.path.join(out_dir, "windows", f"{name}_{b + 1}"),
                       np.column_stack([l[sel], _tophat(l[sel], edges[b],
                                                        edges[b + 1])]),
                       fmt=["%d", "%.17g"])
        sig = _bandpower_sigma(values, ls, 0.02, 0.005, 2000.0)
        corr = np.eye(len(ls)) + 0.15 * (np.eye(len(ls), k=1)
                                         + np.eye(len(ls), k=-1))
        np.savetxt(os.path.join(out_dir, name + "_cov.dat"),
                   corr * np.outer(sig, sig), fmt="%.17g")
        keys.update(cl_lmin=lmin, cl_lmax=lmax, nbins=len(ls),
                    bin_window_files=f"windows/{name}_%u",
                    bin_window_in_order="TT", covmat_cl="TT",
                    covmat_fiducial=name + "_cov.dat")
        if like_approx == "HL":
            _cl_file(os.path.join(out_dir, name + "_cl_fid.dat"), ["TT"],
                     index, values[:, None])
            keys["cl_fiducial_file"] = name + "_cl_fid.dat"
    else:
        keys.update(cl_lmin=int(lrange[0]), cl_lmax=int(lrange[1]),
                    fullsky_exact_fksy=0.57)
    return _ini(os.path.join(out_dir, name + ".dataset"), keys)


def cmblikes_bandpowers(like, cls) -> np.ndarray:
    """The binned, adapted theory of a CMBLikes (or BK-Planck) reader for
    the first chain of the (C, 4, 4, lmax+1) stack `cls` at its nuisance
    centres, (nbins_used, ncl) in the used maps' vech order: the cl_hat
    that makes the set's chi^2 vanish there (noise not included)."""
    import torch
    nu = torch.as_tensor([[p.center for p in like.nuisance if p.varying]],
                         dtype=like.dtype, device=like.device)
    return like.theory_vech(cls[:1], nu)[0].double().cpu().numpy()


def _gaussian_bandpass(path: str, nu0: float, frac: float = 0.25) -> None:
    """A Gaussian bandpass of FWHM frac*nu0 on 61 frequencies."""
    nu = nu0 * np.linspace(1.0 - 1.2 * frac, 1.0 + 1.2 * frac, 61)
    sig = frac * nu0 / 2.3548
    np.savetxt(path, np.column_stack([nu, np.exp(-0.5 * ((nu - nu0) / sig) ** 2)]),
               fmt="%.10e")


def bk_map_names():
    """The six maps of write_bk_like: E and B at each band."""
    return [f"BK15_{b}_{f}" for b in BK_BANDS for f in "EB"]


def write_bk_like(out_dir: str, values: Optional[np.ndarray] = None,
                  maps_use=("BK15_95_B", "BK15_150_B", "BK15_220_B"),
                  settings: Optional[Dict[str, object]] = None) -> str:
    """A BK15-shaped HL set: six maps (E and B at 95, 150 and 220 GHz),
    `maps_use` of them used, 9 bins of width 35 from l = 20 with top-hat
    windows for every pair of the six maps (the reader keeps the required
    ones), a Gaussian bandpass table per band under `bandpass[map]` keys,
    the 16 foreground parameters in a .paramnames file, and a diagonal
    covariance of 10% of each fiducial-plus-noise bandpower (cross
    spectra: of the geometric mean of the autos). `values` (9, ncl) the
    bandpowers in the used maps' vech order, also the fiducial; the noise
    is 1e-3 (95), 5e-4 (150), 3e-3 (220) muK^2 on the autos."""
    os.makedirs(os.path.join(out_dir, "windows"), exist_ok=True)
    name, maps = "BK15_synthetic", bk_map_names()
    used = [m for m in maps if m in maps_use]
    n = len(used)
    pairs = [(i, j) for i in range(n) for j in range(i + 1)]
    names = [f"{used[i]}x{used[j]}" for i, j in pairs]
    nb = len(BK_EDGES) - 1
    values = (np.ones((nb, len(pairs))) if values is None
              else np.asarray(values, float))
    nlev = {95: 1e-3, 150: 5e-4, 220: 3e-3}
    band = lambda m: int(m.split("_")[1])
    noise = np.array([[nlev[band(used[i])] if i == j else 0.0
                       for i, j in pairs]] * nb)
    index = np.arange(1, nb + 1)
    for stem, v in (("cl_hat", values), ("cl_fid", values),
                    ("cl_noise", noise)):
        _cl_file(os.path.join(out_dir, f"{name}_{stem}.dat"), names, index, v)
    tot = np.abs(values) + noise
    auto = np.stack([tot[:, pairs.index((i, i))] for i in range(n)], 1)
    sig = np.stack([0.1 * np.sqrt(auto[:, i] * auto[:, j]) for i, j in pairs],
                   1)
    np.savetxt(os.path.join(out_dir, f"{name}_cov.dat"),
               np.diag(sig.reshape(-1) ** 2), fmt="%.10e")
    all_pairs = [f"{maps[i]}x{maps[j]}" for i in range(len(maps))
                 for j in range(i + 1)]
    lmax = int(BK_EDGES[-1] + 65)
    l = np.arange(2, lmax + 1)
    for b in range(nb):
        w = _tophat(l, BK_EDGES[b], BK_EDGES[b + 1])
        np.savetxt(os.path.join(out_dir, "windows", f"{name}_bpwf_bin{b + 1}.txt"),
                   np.column_stack([l] + [w] * len(all_pairs)),
                   fmt=["%d"] + ["%.10e"] * len(all_pairs))
    for b in BK_BANDS:
        _gaussian_bandpass(os.path.join(out_dir, f"{name}_bandpass_{b}.txt"), b)
    with open(os.path.join(out_dir, f"{name}.paramnames"), "w") as f:
        for p in BK_PARAMS:
            f.write(f"{p}   {p}\n")
    keys = dict(map_names=" ".join(maps),
                map_fields=" ".join(m[-1] for m in maps),
                maps_use=" ".join(used), like_approx="HL", binned="T",
                nbins=nb, cl_lmin=2, cl_lmax=lmax,
                bin_window_files=f"windows/{name}_bpwf_bin%u.txt",
                bin_window_in_order=" ".join(all_pairs),
                cl_hat_file=f"{name}_cl_hat.dat",
                cl_fiducial_file=f"{name}_cl_fid.dat",
                cl_noise_file=f"{name}_cl_noise.dat",
                covmat_fiducial=f"{name}_cov.dat", covmat_cl=" ".join(names),
                nuisance_params=f"{name}.paramnames")
    for m in maps:
        keys[f"bandpass[{m}]"] = f"{name}_bandpass_{band(m)}.txt"
    keys.update(settings or {})
    return _ini(os.path.join(out_dir, f"{name}.dataset"), keys)


def write_highl_template(path: str, cls: np.ndarray, lmax: int) -> str:
    """A look-alike of CosmoMC's HighL_lensedCls.dat, not CAMB's file: the
    lensed spectrum `cls` ((4, 4, l_c+1) stack, l(l+1)C_l/2pi muK^2) held
    to l_c, then extended to `lmax` by an exponential damping tail. The
    slope of ln TT, ln EE and ln BB is fitted over the last 500
    multipoles from l = 2 (capped at 0, so the tail never grows) and the tail starts
    from the value at l_c; TE above l_c is the mean TE/sqrt(TT EE) of that
    range times sqrt(TT EE). Columns l, TT, EE, BB, TE (CAMB lensedCls
    order), from l = 2."""
    cls = np.asarray(cls, float)
    lc = cls.shape[-1] - 1
    l = np.arange(2, lmax + 1)
    fit = np.arange(max(2, lc - 500), lc + 1)
    out = {}
    for key, (i, j) in (("TT", (0, 0)), ("EE", (1, 1)), ("BB", (2, 2))):
        d = cls[i, j]
        slope = min(np.polyfit(fit, np.log(np.abs(d[fit]) + 1e-30), 1)[0], 0.0)
        tail = d[lc] * np.exp(slope * (l - lc))
        out[key] = np.where(l <= lc, d[np.minimum(l, lc)], tail)
    rho = np.mean(cls[1, 0, fit] / np.sqrt(cls[0, 0, fit] * cls[1, 1, fit]))
    out["TE"] = np.where(l <= lc, cls[1, 0, np.minimum(l, lc)],
                         rho * np.sqrt(out["TT"] * out["EE"]))
    np.savetxt(path, np.column_stack([l, out["TT"], out["EE"], out["BB"],
                                      out["TE"]]),
               fmt=["%d"] + ["%.17g"] * 4, header="L TT EE BB TE")
    return path


# ---------------------------------------------------------------------------
# BBN grid and abundance measurements
# ---------------------------------------------------------------------------

#: abundance sets shaped as the reference's (tests/test_abundances.py:26-47)
ABUNDANCE_SETS = {
    "Yp_Aver2015": dict(measurement="Yp", mean=0.2449, error=0.0040,
                        theory_effective_error=0.0003),
    "D_Cooke2017": dict(measurement="D/H", mean=2.527e-5, error=0.030e-5,
                        theory_bias_offset=-0.091e-5,
                        theory_effective_error=0.089e-5),
    "D_Cooke2013": dict(measurement="D/H", mean=2.53e-5, error=0.04e-5),
}
BBN_TABLE_NAME = "BBN_synthetic_grid.dat"


def write_bbn_table(path: str, n_omb: int = 96, n_dn: int = 41) -> str:
    """`bbn.synthetic_bbn_grids` as a reference-format grid file: one row
    per (ombh2, DeltaN) node in bbn.f90's 8 columns (COL_*), eta10 =
    273.9 ombh2."""
    from cosmomc_tpu_torch.models import bbn
    omb, dn, g = bbn.synthetic_bbn_grids(n_omb, n_dn)
    O, D = np.meshgrid(omb, dn, indexing="ij")
    cols = np.zeros(O.shape + (8,))
    cols[..., bbn.COL_OMBH2], cols[..., bbn.COL_ETA10] = O, 273.9 * O
    cols[..., bbn.COL_DELTAN] = D
    for c, f in ((bbn.COL_YP, "yp"), (bbn.COL_YPBBN, "ypbbn"),
                 (bbn.COL_SIGYP, "sig_yp"), (bbn.COL_DH, "dh"),
                 (bbn.COL_SIGDH, "sig_dh")):
        cols[..., c] = g[f]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, cols.reshape(-1, 8), fmt="%.17e",
               header="ombh2 eta10 DeltaN Yp YpBBN sigYp DH sigDH")
    return path


def write_abundance(out_dir: str, name: str, measurement: str, mean: float,
                    error: float, theory_table: str = BBN_TABLE_NAME,
                    theory_bias_offset: Optional[float] = None,
                    theory_effective_error: Optional[float] = None) -> str:
    """A Yp_Aver2015- or D/H-shaped `.dataset`; `theory_table` is a grid
    file name in `out_dir` (write_bbn_table)."""
    os.makedirs(out_dir, exist_ok=True)
    keys = dict(measurement=measurement, mean=repr(float(mean)),
                error=repr(float(error)), theory_table=theory_table)
    if theory_bias_offset is not None:
        keys["theory_bias_offset"] = repr(float(theory_bias_offset))
    if theory_effective_error is not None:
        keys["theory_effective_error"] = repr(float(theory_effective_error))
    return _ini(os.path.join(out_dir, name + ".dataset"), keys)


# ---------------------------------------------------------------------------
# DES 1YR 3x2pt
# ---------------------------------------------------------------------------

#: DES 1YR's layout: source and lens bins, theta bins, n(z) rows, rows in all
DES_NS, DES_NG, DES_NTHETA, DES_NZ = 4, 5, 20, 350
N_DES_ROWS = DES_NTHETA * (2 * DES_NS * (DES_NS + 1) // 2
                           + DES_NG * DES_NS + DES_NG)
DES_NUISANCE = ([f"DES_b{i}" for i in range(1, 6)]
                + [f"DES_m{i}" for i in range(1, 5)]
                + ["DES_AIA", "DES_alphaIA", "DES_z0AI"]
                + [f"DES_DzL{i}" for i in range(1, 6)]
                + [f"DES_DzS{i}" for i in range(1, 5)])
#: the scale cuts (arcmin): xip and xim above a minimum that grows with the
#: source pair, gammat and wtheta above 12 and 8 Mpc/h at each lens bin's
#: redshift, as DES 1YR; they keep about half the rows
_DES_GAMMAT_MIN = (64.0, 40.0, 30.0, 24.0, 21.0)
_DES_WTHETA_MIN = (43.0, 27.0, 20.0, 16.0, 14.0)
DES_ALL_SCALES = "_all_scales.dat"


def des_theta_bins() -> np.ndarray:
    """Centres (arcmin) of 20 log-spaced bins from 2.5' to 250'."""
    edges = 2.5 * 100.0 ** (np.arange(DES_NTHETA + 1) / DES_NTHETA)
    return np.sqrt(edges[1:] * edges[:-1])


def _des_pairs():
    """(type, b1, b2) of each block in file order (1-based bins)."""
    src = [(i, j) for i in range(1, DES_NS + 1) for j in range(i, DES_NS + 1)]
    return ([("xip", i, j) for i, j in src] + [("xim", i, j) for i, j in src]
            + [("gammat", l, s) for l in range(1, DES_NG + 1)
               for s in range(1, DES_NS + 1)]
            + [("wtheta", l, l) for l in range(1, DES_NG + 1)])


def _des_nz() -> np.ndarray:
    """Z_LOW Z_MID Z_HIGH, 4 source and 5 lens columns on a 0.01 grid to
    z = 3.5: smooth source bins, lens bins the DES redMaGiC ranges
    (0.15-0.9) blurred by 0.02, each normalised to unit integral."""
    from scipy.special import erf
    dz = 0.01
    zm = dz * (np.arange(DES_NZ) + 0.5)
    src = [np.exp(-0.5 * ((zm - m) / w) ** 2) * zm ** 1.5
           for m, w in ((0.35, 0.15), (0.5, 0.17), (0.7, 0.2), (0.95, 0.25))]
    lens = [0.5 * (erf((zm - lo) / 0.02) - erf((zm - lo - 0.15) / 0.02))
            for lo in (0.15, 0.3, 0.45, 0.6, 0.75)]
    nz = np.array(src + lens)
    nz /= nz.sum(-1, keepdims=True) * dz
    return np.column_stack([zm - dz / 2, zm, zm + dz / 2, nz.T])


def write_des_wl(out_dir: str, values: Optional[np.ndarray] = None,
                 seed: int = 0, name: str = "DES_1YR_synthetic") -> str:
    """A DES 1YR-format 3x2pt set: n(z) files, theta bins, xip, xim, gammat
    and wtheta measurement files (bin1 bin2 theta-bin value) of N_DES_ROWS
    rows in all, the scale cuts, the nuisance .paramnames and a covariance
    of 10% of each value plus 0.5% of its block's largest (times a seeded
    factor in [0.9, 1.1]), correlated 0.4^|i-j| between the theta bins of
    one block. `values` are the rows in
    file order (xip, xim, gammat, wtheta); placeholders without. A second
    selection file (name + DES_ALL_SCALES) keeps every row, so a reader
    built on it gives the theory at every row (`des_wl_rows`). Returns the
    .dataset."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    path = lambda suffix: os.path.join(out_dir, name + suffix)
    pairs = _des_pairs()
    values = (np.full(N_DES_ROWS, 1e-5) if values is None
              else np.asarray(values, float))
    nz = _des_nz()
    np.savetxt(path("_nz_source.txt"), nz[:, :3 + DES_NS], fmt="%.10e")
    np.savetxt(path("_nz_lens.txt"),
               np.column_stack([nz[:, :3], nz[:, 3 + DES_NS:]]), fmt="%.10e")
    theta = des_theta_bins()
    np.savetxt(path("_theta_bins.txt"), theta, fmt="%.10e")
    rows = {t: [] for t in ("xip", "xim", "gammat", "wtheta")}
    for ib, (t, b1, b2) in enumerate(pairs):
        for tb in range(DES_NTHETA):
            rows[t].append((b1, b2, tb + 1, values[ib * DES_NTHETA + tb]))
    for t, r in rows.items():
        with open(path(f"_{t}.txt"), "w") as f:
            for b1, b2, tb, v in r:
                f.write(f"{b1} {b2} {tb} {v:.17e}\n")
    with open(path("_scales.dat"), "w") as f, open(path(DES_ALL_SCALES),
                                                      "w") as fa:
        for t, b1, b2 in pairs:
            lo = {"xip": 4.0 + 0.5 * (b1 + b2), "xim": 30.0 + 5.0 * (b1 + b2),
                  "gammat": _DES_GAMMAT_MIN[b1 - 1],
                  "wtheta": _DES_WTHETA_MIN[b1 - 1]}[t]
            f.write(f"{t} {b1} {b2} {lo} 250.0\n")
            fa.write(f"{t} {b1} {b2} 0.0 1e9\n")
    blk_max = np.abs(values).reshape(len(pairs), DES_NTHETA).max(-1)
    sig = 0.1 * (np.abs(values) + 0.05 * np.repeat(blk_max, DES_NTHETA)) \
        * rng.uniform(0.9, 1.1, N_DES_ROWS)
    blk = np.arange(DES_NTHETA)
    corr = np.kron(np.eye(len(pairs)),
                   0.4 ** np.abs(blk[:, None] - blk[None, :]))
    np.savetxt(path("_cov.txt"), corr * np.outer(sig, sig), fmt="%.17e")
    with open(path("_nuisance.paramnames"), "w") as f:
        for n in DES_NUISANCE:
            f.write(f"{n} {n.replace('DES_', '')}\n")
    keys = dict(measurements_format="DES", num_z_bins=DES_NS,
                num_gal_bins=DES_NG, kmax=15, lmax=50000,
                nz_file=name + "_nz_source.txt",
                nz_gal_file=name + "_nz_lens.txt",
                theta_bins_file=name + "_theta_bins.txt",
                data_types="xip xim gammat wtheta",
                used_data_types="xip xim gammat wtheta",
                data_selection=name + "_scales.dat",
                cov_file=name + "_cov.txt",
                nuisance_params=name + "_nuisance.paramnames",
                intrinsic_alignment_model="DES1YR")
    keys.update({f"measurements[{t}]": name + f"_{t}.txt" for t in rows})
    return _ini(path(".dataset"), keys)


def des_wl_rows(like_all, theory) -> np.ndarray:
    """The theory at every row of a DES set, in file order, from a reader
    built on the keep-all selection (write_des_wl), at its nuisance
    centres, chain 0."""
    import torch
    if like_all.num_used != N_DES_ROWS:
        raise ValueError("des_wl_rows needs the keep-all selection")
    nu = torch.as_tensor([p.center for p in like_all.nuisance if p.varying],
                         dtype=like_all.dtype, device=like_all.device)
    nu = nu.expand(theory.bg.H0.shape[0], -1)
    return like_all.theory_vector(theory, nu)[0].double().cpu().numpy()


# ---------------------------------------------------------------------------
# Planck 2015 SZ cluster counts
# ---------------------------------------------------------------------------

SZ_NPATCH, SZ_NTHETA = 417, 80
#: sky fraction of the cosmology sample's mask
SZ_FSKY = 0.65
#: rows written with a missing redshift (z = -1), at these S/N
SZ_MISSING_Q = (7.0, 11.0, 60.0)


def write_sz_selection(out_dir: str, noise: float = 2.8e-4,
                       seed: int = 0) -> str:
    """SZ_thetas.txt (80 theta_500 values from 0.5' to 35'),
    SZ_skyfracs.txt (417 patches summing to SZ_FSKY) and SZ_ylims.txt (the
    Y_500 noise of each patch and theta, patch fastest as the reference
    files are): noise * (theta / 5')^0.8 times a seeded lognormal factor of
    20% per patch. Returns out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    thetas = np.exp(np.linspace(np.log(0.5), np.log(35.0), SZ_NTHETA))
    frac = rng.uniform(0.5, 1.5, SZ_NPATCH)
    frac *= SZ_FSKY / frac.sum()
    patch = np.exp(0.2 * rng.standard_normal(SZ_NPATCH))
    ylims = noise * (thetas[:, None] / 5.0) ** 0.8 * patch[None, :]
    np.savetxt(os.path.join(out_dir, "SZ_thetas.txt"), thetas, fmt="%.17e")
    np.savetxt(os.path.join(out_dir, "SZ_skyfracs.txt"), frac, fmt="%.17e")
    np.savetxt(os.path.join(out_dir, "SZ_ylims.txt"), ylims.reshape(-1),
               fmt="%.17e")
    return out_dir


def write_sz_catalogue(out_dir: str, counts: np.ndarray,
                       name: str = "SZ_cat.txt") -> str:
    """SZ_cat.txt (z, z_err, q): counts[i, j] clusters at the centre of z
    bin i and S/N bin j (the open top bin at 1.2 x its lower edge), then
    the SZ_MISSING_Q rows with z = -1."""
    from cosmomc_tpu_torch.likelihoods import szcounts as sz
    os.makedirs(out_dir, exist_ok=True)
    counts = np.asarray(counts, int)
    ny = counts.shape[1] - 1
    lc = sz.LOGY_MIN + (np.arange(ny + 1) + 0.5) * sz.DLOGY
    qlo = np.maximum(10.0 ** (lc - 0.5 * sz.DLOGY), sz.Q_THRESHOLD)
    qmid = np.sqrt(qlo * 10.0 ** (lc + 0.5 * sz.DLOGY))
    qmid[ny] = 1.2 * 10.0 ** (lc[ny - 1] + 0.5 * sz.DLOGY)
    rows = [(sz.Z0 + (i + 0.5) * sz.DZ, 0.01, qmid[j])
            for i in range(counts.shape[0]) for j in range(ny + 1)
            for _ in range(counts[i, j])]
    rows += [(-1.0, 0.0, q) for q in SZ_MISSING_Q]
    path = os.path.join(out_dir, name)
    np.savetxt(path, np.array(rows), fmt="%.10f", header="z z_err q")
    return path
