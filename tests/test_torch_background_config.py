"""Port parity of the background configuration (BAO + SN + H0) and of BAO
on the flagship's theory products.

Synthetic sets in the readers' own formats (likelihoods/synthetic.py) are
written to tmp_path from the JAX package's own theory at
BACKGROUND_TRUTH, scattered by a seeded generator. The same numpy points
go through the JAX modules and the port's, float64 on the CPU. Tolerances:
theory vectors and distances 1e-12 relative, chi^2/2 1e-10 relative (the
distance tables agree to ~1e-15; chi^2/2 differences of large
SN quadratic forms carry a few more digits of rounding).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.bao import BAOLikelihood as JBAO
from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.likelihoods.hst import HSTLikelihood as JHST
from cosmomc_tpu.likelihoods.sn import SNLikelihood as JSN
from cosmomc_tpu.models import background as jbgm
from cosmomc_tpu.models.matterpower import MatterPower as JMatterPower
from cosmomc_tpu.models.theory import CMBTheoryProducts as JCMBTheory
from cosmomc_tpu.models.theory import compute_background_theory as jtheory
from cosmomc_tpu.params.parameterizations import (
    BackgroundParameterization as JBgPar, ThetaParameterization as JThetaPar)
from cosmomc_tpu.pipeline import BackgroundPosterior as JPost
from cosmomc_tpu.utils.ini import IniFile as JIni

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood as TBAO
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.likelihoods.hst import HSTLikelihood as THST
from cosmomc_tpu_torch.likelihoods.sn import SNLikelihood as TSN
from cosmomc_tpu_torch.models import background as tbgm
from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
from cosmomc_tpu_torch.models.theory import compute_background_theory as ttheory
from cosmomc_tpu_torch.params.parameterizations import (
    BackgroundParameterization as TBgPar, ThetaParameterization as TThetaPar)
from cosmomc_tpu_torch.pipeline import BackgroundPosterior as TPost
from cosmomc_tpu_torch.pipeline import CMBPosterior
from cosmomc_tpu_torch.utils.ini import IniFile as TIni

F64 = torch.float64
VEC_RTOL, CHI2_RTOL = 1e-12, 1e-10
N_SN = 80
ZS = np.array([0.01, 0.106, 0.38, 0.61, 1.5, 2.3])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"rel err {err:.3e} > {rtol:.1e}"


@pytest.fixture(scope="module")
def points():
    """The truth and three points around it (omegam, H0, ombh2)."""
    rng = np.random.default_rng(20261017)
    truth = np.array([sd.BACKGROUND_TRUTH[k] for k in ("omegam", "H0", "ombh2")])
    return np.vstack([truth, truth + rng.normal(0, 1, (3, 3))
                      * np.array([0.02, 2.0, 0.0005])])


def full_vectors(points):
    full = np.tile(np.array([p.center for p in TBgPar().default_space().params]),
                   (len(points), 1))
    full[:, [0, 1, 7]] = points
    return full


@pytest.fixture(scope="module")
def theories(points):
    """(JAX BackgroundTheory per point, the port's batched theory)."""
    full = full_vectors(points)
    jpar = JBgPar(jnp.float64)
    j = [jtheory(jpar.to_background(jnp.asarray(f))) for f in full]
    t = ttheory(TBgPar().to_background(torch.as_tensor(full, dtype=F64)))
    return j, t


@pytest.fixture(scope="module")
def sets(tmp_path_factory, theories):
    """Synthetic sets written from the JAX package's theory at the truth."""
    d = str(tmp_path_factory.mktemp("bgsets"))
    jth = theories[0][0]
    rng = np.random.default_rng(7)
    out = {}
    dr12 = sd.write_dr12_bao(d)
    out["dr12"] = sd.write_dr12_bao(
        d, np.asarray(JBAO(dr12).theory_vector(jth)), rng)
    sixdf = sd.write_6df_bao(d)
    out["6df"] = sd.write_6df_bao(
        d, float(JBAO(sixdf).theory_vector(jth)[0]), rng)
    # the other reader forms, on the DR12 values: a measurements file with
    # an error column and one type from the ini (DM_over_rs rows), and the
    # DR12 rows with an inverse-covariance file
    vals = np.loadtxt(out["dr12"].replace(".dataset", "_measurements.txt"),
                      usecols=(0, 1))
    with open(os.path.join(d, "errcol.txt"), "w") as f:
        for z, v in vals[::2]:
            f.write(f"{z} {float(v)!r} {0.015 * float(v)!r}\n")
    with open(os.path.join(d, "errcol.dataset"), "w") as f:
        f.write("name = errcol\nnum_bao = 3\nbao_measurements_file = "
                "errcol.txt\nbao_measurements_file_has_error = T\n"
                f"measurement_type = DM_over_rs\nrs_rescale = {1 / 147.78!r}\n")
    out["errcol"] = os.path.join(d, "errcol.dataset")
    cov = np.loadtxt(out["dr12"].replace(".dataset", "_cov.txt"))
    np.savetxt(os.path.join(d, "invcov.txt"), np.linalg.inv(cov))
    with open(out["dr12"]) as f, open(os.path.join(d, "inv.dataset"), "w") as g:
        g.write(f.read().replace("bao_cov_file", "bao_invcov_file").replace(
            "sdss_DR12_synthetic_cov.txt", "invcov.txt"))
    out["invcov"] = os.path.join(d, "inv.dataset")
    cols = sd.pantheon_columns(N_SN, seed=3)
    mag = {"mag": sd.sn_covmat(cols["zcmb"])}
    for key, kw in (("fixed", {}), ("twoscript", dict(twoscriptmfit=True)),
                    ("fixed_mag", dict(covmats=mag))):
        p = sd.write_pantheon(d, cols, name=f"sn_{key}", **kw)
        mu = np.asarray(JSN(p)._mu_model(jth))
        out[f"sn_{key}"] = sd.write_pantheon(d, cols, mu + sd.SN_MB_OFFSET,
                                             rng=rng, name=f"sn_{key}", **kw)
    # JLA-style: stretch and colour columns and covmats; alpha, beta vary
    cols2 = sd.pantheon_columns(N_SN, seed=4, salt2=True)
    cm = {k: sd.sn_covmat(cols2["zcmb"], amp=a, seed=s) for k, a, s in (
        ("mag", 0.03, 1), ("stretch", 0.01, 2), ("colour", 0.01, 3),
        ("mag_stretch", 0.005, 4))}
    cm["mag_colour"] = 0.3 * cm["mag_stretch"]
    cm["stretch_colour"] = 0.2 * cm["mag_stretch"]
    p = sd.write_pantheon(d, cols2, covmats=cm, twoscriptmfit=True,
                          name="sn_salt2")
    mu = np.asarray(JSN(p)._mu_model(jth))
    mb = mu + sd.SN_MB_OFFSET - 0.14 * cols2["x1"] + 3.1 * cols2["color"]
    out["sn_salt2"] = sd.write_pantheon(d, cols2, mb, covmats=cm,
                                        twoscriptmfit=True, rng=rng,
                                        name="sn_salt2")
    return out


def test_background_parameterization_and_distances(points, theories):
    jth, tth = theories
    full = full_vectors(points)
    jpar = JBgPar(jnp.float64)
    tbg = TBgPar().to_background(torch.as_tensor(full, dtype=F64))
    z2 = torch.as_tensor(np.tile(ZS, (len(points), 1)), dtype=F64)
    for i, f in enumerate(full):
        jbg = jpar.to_background(jnp.asarray(f))
        for k in ("ombh2", "omch2", "H0", "omnuh2", "nnu", "tcmb"):
            assert_close(getattr(tbg, k)[i], getattr(jbg, k), 1e-15)
        jbf = jth[i].bf
        for name in ("angular_diameter_distance", "luminosity_distance",
                     "bao_d_v"):
            port = getattr(tbgm, name)(tth.bf, z2)[i]
            assert_close(port, getattr(jbgm, name)(jbf, jnp.asarray(ZS)),
                         VEC_RTOL)
            # a float and a (C,) redshift give (C,) values
            assert_close(getattr(tbgm, name)(tth.bf, 0.38)[i],
                         getattr(jbgm, name)(jbf, 0.38), VEC_RTOL)
        assert_close(tbgm.r_drag_approx(tbg)[i], jbgm.r_drag_approx(jbg), 1e-14)
        assert_close(tbgm.z_drag_eh(tbg)[i], jbgm.z_drag_eh(jbg), 1e-14)
        assert_close(tth.rs_drag[i], jth[i].rs_drag, 1e-14)


def test_convert_background_theory(theories):
    jth, tth = theories
    for i, j in enumerate(jth):
        c = convert.background_theory(j)
        assert c.bf.chi_grid.shape == (1, tth.bf.chi_grid.shape[1])
        np.testing.assert_array_equal(c.bf.chi_grid[0].numpy(),
                                      np.asarray(j.bf.chi_grid))
        np.testing.assert_array_equal(c.rs_drag.numpy(), [float(j.rs_drag)])


@pytest.mark.parametrize("key", ["dr12", "6df", "errcol", "invcov"])
def test_bao_theory_vector_and_loglike(sets, theories, key):
    jth, tth = theories
    jl, tl = JBAO(sets[key]), TBAO(sets[key], device="cpu")
    assert tl.types == jl.types and tl.rs_rescale == jl.rs_rescale
    if key == "dr12":
        assert tl.types == sd.DR12_TYPES and len(tl.z) == 6
    tv = tl.theory_vector(tth)
    chi2 = tl.log_like(tth, torch.zeros(len(jth), 0, dtype=F64))
    for i, j in enumerate(jth):
        assert_close(tv[i], jl.theory_vector(j), VEC_RTOL)
        assert_close(chi2[i], jl.log_like(j, jnp.zeros(0)), CHI2_RTOL)
    assert float(chi2.max()) > 1e-3      # the points do not all sit at the data


def test_bao_rows_without_theory_raise(theories, tmp_path):
    """f_sigma8 rows need matter power, which a background-only theory does
    not have, and dilation rows have no theory: both packages raise
    ValueError for each."""
    jth, tth = theories
    for mtype in ("f_sigma8", "dilation"):
        p = tmp_path / f"{mtype}.dataset"
        p.write_text(f"measurement_type = {mtype}\nzeff = 0.5\n"
                     "bao_measurement = 0.45 0.05\n")
        with pytest.raises(ValueError):
            TBAO(str(p), device="cpu").theory_vector(tth)
        with pytest.raises(ValueError):
            JBAO(str(p)).theory_vector(jth[0])


@pytest.mark.parametrize("key", ["sn_fixed", "sn_twoscript", "sn_fixed_mag",
                                 "sn_salt2"])
def test_sn_loglike(sets, theories, key):
    jth, tth = theories
    jl, tl = JSN(sets[key]), TSN(sets[key], device="cpu")
    assert tl.varying_alpha_beta == jl.varying_alpha_beta == (key == "sn_salt2")
    assert tl.twoscriptmfit == jl.twoscriptmfit
    assert [p.name for p in tl.nuisance] == [p.name for p in jl.nuisance]
    ab = np.array([[0.14, 3.1], [0.12, 2.9], [0.16, 3.3], [0.135, 3.0]])
    nuis = ab if key == "sn_salt2" else np.zeros((len(jth), 0))
    chi2 = tl.log_like(tth, torch.as_tensor(nuis, dtype=F64))
    for i, j in enumerate(jth):
        assert_close(chi2[i], jl.log_like(j, jnp.asarray(nuis[i])), CHI2_RTOL)


def test_sn_missing_covmat_warns(tmp_path):
    cols = sd.pantheon_columns(10, seed=5)
    p = sd.write_pantheon(str(tmp_path), cols, covmats={"mag": np.eye(10)},
                          name="sn")
    (tmp_path / "sn_mag_covmat.txt").unlink()
    with pytest.warns(UserWarning, match="covmat file missing"):
        tl = TSN(p, device="cpu")
    assert not tl.varying_alpha_beta


def test_hst(theories, tmp_path):
    jth, tth = theories
    ini = tmp_path / "hst.ini"
    ini.write_text("Hubble_H0 = 73.48\nHubble_H0_err = 1.66\n"
                   "Hubble_name = R18\n")
    pairs = [(JHST(H0=68.3, H0_err=1.66, **kw), THST(H0=68.3, H0_err=1.66, **kw))
             for kw in (dict(zeff=0.04), dict(zeff=0.0))]
    pairs.append((JHST.from_ini(JIni(str(ini))), THST.from_ini(TIni(str(ini)))))
    assert pairs[-1][1].name == "R18" and pairs[-1][1].zeff == 0.04
    for jl, tl in pairs:
        v = tl.log_like(tth, None)
        for i, j in enumerate(jth):
            assert_close(v[i], jl.log_like(j, jnp.zeros(0)), CHI2_RTOL)


def test_background_space_from_ini(tmp_path):
    ini = tmp_path / "bg.ini"
    ini.write_text("param[omegam] = 0.3 0.2 0.5 0.01 0.01\nparam[w] = -0.9\n")
    js = JBgPar(jnp.float64).default_space(JIni(str(ini)))
    ts = TBgPar().default_space(TIni(str(ini)))
    for jp, tp in zip(js.params, ts.params):
        assert vars(tp) == vars(jp)
    assert [p.name for p in ts.varying] == ["omegam", "H0", "ombh2"]
    assert ts.get("w").center == -0.9 and ts.get("omegam").max == 0.5


def _posteriors(sets, hst_h0):
    jl, tl = JLikes(), TLikes()
    for key in ("dr12", "6df", "sn_fixed_mag"):
        J, T = (JBAO, TBAO) if "sn" not in key else (JSN, TSN)
        jl.add(J(sets[key]))
        tl.add(T(sets[key], device="cpu"))
    jl.add(JHST(H0=hst_h0, H0_err=1.66))
    tl.add(THST(H0=hst_h0, H0_err=1.66))
    jpost = JPost(JBgPar(jnp.float64), JBgPar(jnp.float64).default_space(), jl)
    tpost = TPost(TBgPar(), TBgPar().default_space(), tl, device="cpu")
    return jpost, tpost


def test_background_posterior(sets, points, theories):
    jth, _ = theories
    h0 = float(11425.8 / jbgm.angular_diameter_distance(jth[0].bf, 0.04))
    jpost, tpost = _posteriors(sets, h0)
    assert [p.name for p in tpost.space.varying] == ["omegam", "H0", "ombh2"]
    assert tpost.derived_names == jpost.derived_names
    assert [n for n, _ in tpost.derived_names] == ["omegal", "rdrag"]
    # the points, and one out of bounds (omegam above 0.7)
    P = np.vstack([points, [0.75, 68.0, 0.0224]])
    t_mll, t_der = tpost.logpost()(torch.as_tensor(P, dtype=F64))
    jfn = jax.jit(jpost.logpost())
    for i, p in enumerate(P):
        j_mll, j_der = jfn(jnp.asarray(p))
        assert_close(t_mll[i], j_mll, CHI2_RTOL)
        assert_close(t_der[i], j_der, VEC_RTOL)
    assert float(t_mll[-1]) == 1e30     # the sentinel, not its float32 rounding
    tper, jper = tpost.per_likelihood(points[1]), jpost.per_likelihood(points[1])
    assert list(tper) == list(jper)
    for k in tper:
        assert_close(tper[k], jper[k], CHI2_RTOL)
    assert tper["HST"] > 0.0


def test_entry_points_default_to_the_card(sets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TBAO(sets["dr12"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSN(sets["sn_fixed"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPost(TBgPar(), TBgPar().default_space(), TLikes())


def test_flagship_posterior_takes_bao(sets):
    """CMBPosterior with BAO in its list: the theory products it assembles
    (bg, bf, rs_drag carried from the JAX package's by convert) give the
    BAO likelihood the JAX value on the JAX CMBTheoryProducts."""
    jpar = JThetaPar(jnp.float64)
    full = np.array([p.center for p in jpar.default_space().params])
    full[:4] = [0.02237737, 0.1201035, 1.0409020, 0.05430138]
    jbg = jpar.to_background(jnp.asarray(full))
    jbf = jbgm.background_functions(jbg)
    rs = 147.05    # a stand-in for the thermal-history r_drag
    jt = JCMBTheory(jbg, jbf, jnp.asarray(rs))
    likes = TLikes()
    likes.add(TBAO(sets["dr12"], device="cpu"))
    post = CMBPosterior(TThetaPar(), TThetaPar().default_space(), likes,
                        bbn_table=synthetic_bbn_table(), device="cpu")
    slow = dict(bg=convert.background_params(jbg),
                bf=convert.background_functions(jbf),
                rs_drag=torch.tensor([rs], dtype=F64))
    theory = post.assemble_theory(slow, dict(cls=None))
    P = torch.as_tensor([[p.center for p in post.space.varying]], dtype=F64)
    total, per = post.likes.total_log_like(theory, P, post.slices)
    jl = JBAO(sets["dr12"])
    assert_close(likes.likes[0].theory_vector(theory)[0],
                 jl.theory_vector(jt), VEC_RTOL)
    assert_close(total[0], jl.log_like(jt, jnp.zeros(0)), CHI2_RTOL)
    assert_close(per[0, 0], total[0], 0.0)
    # without matter power f sigma8 raises as JAX's does; with a P(k, z)
    # table in the semi cache it is the table's value, interpolated in z
    with pytest.raises(ValueError, match="matter power"):
        theory.fsigma8_at(0.5)
    with pytest.raises(ValueError, match="matter power"):
        jt.fsigma8_at(0.5)
    zs = np.array([0.0, 0.38, 0.61, 1.0])
    nk = 4
    jmp = JMatterPower(np.logspace(-3, 0, nk), zs, *[np.zeros((4, nk))] * 3,
                       0.81 / (1 + 0.5 * zs), 0.47 - 0.05 * zs, 0.67)
    jt = jt._replace(z_pk=jnp.asarray(zs), sigma8_z=jnp.asarray(jmp.sigma8_z),
                     fsigma8_z=jnp.asarray(jmp.fsigma8_z))
    theory = post.assemble_theory(slow, dict(cls=None,
                                             mp=convert.matter_power(jmp)))
    for z in (0.0, 0.5, 0.8):
        assert_close(theory.fsigma8_at(z), [float(jt.fsigma8_at(z))], 1e-15)
        assert_close(theory.sigma8_at(z), [float(jt.sigma8_at(z))], 1e-15)
