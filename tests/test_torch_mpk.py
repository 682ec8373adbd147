"""Port parity of the P(k) likelihoods (likelihoods/mpk.py) and of BAO
f_sigma8 rows.

The SDSS LRG DR4 and WiggleZ sets are not in the repository: synthetic
sets in the readers' formats (likelihoods/synthetic.py) are written to
tmp_path with seeded values. The theory is three chains of smooth
synthetic P(k, z) tables (a turnover near k/h = 0.015, amplitude, tilt
and growth varied per chain) with each chain's own background for D_V,
given to JAX as one CMBTheoryProducts per chain and to the port batched.
float64 on the CPU. Tolerances: theory P(k) and BAO theory vectors 1e-12
relative; chi^2/2 1e-10 relative (the analytic marginalizations subtract
quadratic forms of ~1e3-1e4 that agree to ~1e-15 of themselves).

Every reader branch: MPK without the Q model or D_V scaling (errors from
the measurements), with the Q grid, scaling, a covariance file and a
subset of points and k bands, and the DR4 form (Q with a flat prior,
nonlinear); WiggleZ with the GiggleZ correction, and with the Q grid and
two regions off.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.bao import BAOLikelihood as JBAO
from cosmomc_tpu.likelihoods.mpk import MPKLikelihood as JMPK
from cosmomc_tpu.likelihoods.mpk import WiggleZLikelihood as JWZ
from cosmomc_tpu.models import background as jbgm
from cosmomc_tpu.models.background import BackgroundParams as JBG
from cosmomc_tpu.models.matterpower import MatterPower as JMP
from cosmomc_tpu.models.theory import CMBTheoryProducts as JTheory

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood as TBAO
from cosmomc_tpu_torch.likelihoods.mpk import MPKLikelihood as TMPK
from cosmomc_tpu_torch.likelihoods.mpk import WiggleZLikelihood as TWZ
from cosmomc_tpu_torch.models import background as tbgm
from cosmomc_tpu_torch.models.theory import CMBTheoryProducts as TTheory

F64 = torch.float64
VEC_RTOL, CHI2_RTOL = 1e-12, 1e-10
#: (H0, omch2, amplitude, tilt) per chain
CHAINS = np.array([[67.3, 0.120, 1.00, 0.00], [70.1, 0.115, 1.07, 0.03],
                   [64.8, 0.126, 0.94, -0.02]])
ZS = np.array([0.0, 0.3, 0.5, 0.8, 1.2])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"rel err {err:.3e} > {rtol:.1e}"


def _tables(h, amp, tilt):
    """ln P (linear, 'nonlinear' with a small-scale boost, Weyl) on a
    shared (z, k) grid, sigma8 and f sigma8 tables."""
    k = np.logspace(-4, 1.2, 300)
    kh = k / h
    P_h = 2.4e4 * amp * (kh / 0.015) ** (1 + tilt) / (1 + (kh / 0.015) ** 2.8)
    growth = 1.0 / (1.0 + 0.55 * ZS)
    lnP = np.log(P_h / h ** 3)[None] + 2 * np.log(growth)[:, None]
    lnP_nl = lnP + np.log1p((kh / 0.3) ** 1.5)[None]
    s8 = 0.81 * np.sqrt(amp) * growth
    return k, lnP, lnP_nl, lnP - 2.0, s8, s8 * (0.55 - 0.1 * ZS)


@pytest.fixture(scope="module")
def theories():
    """(JAX CMBTheoryProducts per chain, the port's batched theory)."""
    jbg = [JBG.make(ombh2=0.0224, omch2=c[1], H0=c[0]) for c in CHAINS]
    jth, tabs = [], []
    for bg, c in zip(jbg, CHAINS):
        k, lnP, lnP_nl, lnPw, s8, fs8 = _tables(c[0] / 100.0, c[2], c[3])
        tabs.append((lnP, lnP_nl, lnPw, s8, fs8))
        mp = JMP(*(jnp.asarray(x) for x in (k, ZS, lnP, lnP_nl, lnPw, s8, fs8,
                                             c[0] / 100.0)))
        jth.append(JTheory(bg, jbgm.background_functions(bg),
                           jnp.asarray(147.0), z_pk=mp.z, sigma8_z=mp.sigma8_z,
                           fsigma8_z=mp.fsigma8_z, mp=mp))
    stack = [np.stack(x) for x in zip(*tabs)]
    mp = convert.matter_power(JMP(k, ZS, *stack[:3], stack[3], stack[4],
                                  CHAINS[:, 0] / 100.0))
    tbg = convert.background_params(jax.tree_util.tree_map(
        lambda *x: jnp.stack(x), *jbg))
    tth = TTheory(tbg, tbgm.background_functions(tbg),
                  torch.full((3,), 147.0, dtype=F64), z_pk=mp.z,
                  sigma8_z=mp.sigma8_z, fsigma8_z=mp.fsigma8_z, mp=mp)
    return jth, tth


def _dv_fid(jth, z):
    """2% off chain 0's H0 D_V(z): a_scl != 1 for every chain."""
    return 1.02 * float(jth[0].bg.H0 * jbgm.bao_d_v(jth[0].bf, z))


@pytest.fixture(scope="module")
def sets(tmp_path_factory, theories):
    jth, _ = theories
    d = tmp_path_factory.mktemp("pk")
    rng = np.random.default_rng(11)
    lrg = sd.lrg_layout(seed=1)
    P = 2e4 * (lrg["k_eff"] / 0.02) / (1 + (lrg["k_eff"] / 0.02) ** 2.5)
    dv = _dv_fid(jth, sd.LRG_Z)
    out = {
        "mpk_plain": sd.write_lrg_mpk(
            str(d / "plain"), lrg, P, dict(use_scaling="F", Q_marge="F"),
            rng=rng),
        "mpk_qgrid": sd.write_lrg_mpk(
            str(d / "qgrid"), lrg, P, dict(Q_flat="F", DV_fid=dv,
                                           min_mpk_points_use=2,
                                           max_mpk_points_use=18,
                                           min_mpk_kbands_use=3,
                                           max_mpk_kbands_use=60),
            with_cov=True, rng=rng),
        "mpk_dr4": sd.write_lrg_mpk(str(d / "dr4"), lrg, P,
                                    dict(DV_fid=dv), rng=rng),
    }
    wz = sd.wigglez_layout(seed=2)
    Pw = np.tile(1.5e4 * (wz["k_eff"][:sd.WZ_NUSE] / 0.02)
                 / (1 + (wz["k_eff"][:sd.WZ_NUSE] / 0.02) ** 2.2), (7, 1))
    dvw = _dv_fid(jth, 0.6)
    out["wz_gigglez"] = sd.write_wigglez(str(d / "wz1"), wz, 0.6, Pw, dvw,
                                         rng=rng)
    out["wz_qgrid"] = sd.write_wigglez(
        str(d / "wz2"), wz, 0.6, Pw, dvw, rng=rng,
        common={"Q_marge": "T", "Use_1-hr_region": "F",
                "Use_3-hr_region": "F"})
    return out


READERS = {
    "mpk_plain": lambda p, **kw: (JMPK(p), TMPK(p, **kw)),
    "mpk_qgrid": lambda p, **kw: (JMPK(p), TMPK(p, **kw)),
    "mpk_dr4": lambda p, **kw: (JMPK(p, nonlinear=True),
                                TMPK(p, nonlinear=True, **kw)),
    "wz_gigglez": lambda p, **kw: (JWZ(p), TWZ(p, **kw)),
    "wz_qgrid": lambda p, **kw: (JWZ(p, use_gigglez=False, nonlinear=False),
                                 TWZ(p, use_gigglez=False, nonlinear=False,
                                     **kw)),
}


@pytest.mark.parametrize("key", list(READERS))
def test_pk_likelihood(sets, theories, key):
    jth, tth = theories
    jl, tl = READERS[key](sets[key], device="cpu")
    for f in ("kh", "P_data", "W", "invcov"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    assert (tl.Q_marge, tl.use_scaling, tl.required_zmax) == \
        (jl.Q_marge, jl.use_scaling, jl.required_zmax)
    assert tl.needs_matter_power and tl.name == jl.name
    a = tl._scaling(tth)
    P, kh = tl._theory_pk_h(tth, a)
    chi2 = tl.log_like(tth, torch.zeros(3, 0, dtype=F64))
    for i, j in enumerate(jth):
        ja = jl._scaling(j)
        jP, jkh = jl._theory_pk_h(j, jl.kh, ja)
        assert_close(a[i], ja, VEC_RTOL)
        assert_close(P[i], jP, VEC_RTOL)
        assert_close(kh[i], jkh, VEC_RTOL)
        assert_close(chi2[i], jl.log_like(j, jnp.zeros(0)), CHI2_RTOL)
    assert bool(torch.isfinite(chi2).all())
    if key == "wz_qgrid":
        assert tl.P_data.shape == (5, sd.WZ_NUSE)
    if key == "mpk_qgrid":
        assert tl.P_data.shape == (17,) and tl.W.shape == (17, 58)


def test_bandpowers_at_the_data_give_zero_chi2(tmp_path, theories):
    """A WiggleZ bin written from the reader's own windowed theory
    (`mpk_bandpowers`, no scatter): chi^2/2 of that chain is ~0 (WiggleZ
    has no ln normV term); the other chains are not."""
    jth, tth = theories
    wz = sd.wigglez_layout(seed=3)
    dv = _dv_fid(jth, 0.6)
    p0 = sd.write_wigglez(str(tmp_path), wz, 0.6, DV_fid=dv)
    vals = sd.mpk_bandpowers(TWZ(p0, device="cpu"), tth)
    like = TWZ(sd.write_wigglez(str(tmp_path), wz, 0.6, vals, dv),
               device="cpu")
    chi2 = like.log_like(tth, torch.zeros(3, 0, dtype=F64))
    assert abs(float(chi2[0])) < 1e-8 and float(chi2[1:].min()) > 1.0


@pytest.fixture(scope="module")
def fs8_sets(tmp_path_factory, theories):
    jth, _ = theories
    d = str(tmp_path_factory.mktemp("fs8"))
    dr12 = sd.write_dr12_bao(d, fsigma8=True)
    vals = np.asarray(JBAO(dr12).theory_vector(jth[0]))
    inline = f"{d}/fs8_inline.dataset"
    with open(inline, "w") as f:
        f.write("name = fs8\nmeasurement_type = f_sigma8\nzeff = 0.45\n"
                "bao_measurement = 0.45 0.04\n")
    return {"dr12_fs8": sd.write_dr12_bao(d, vals, np.random.default_rng(5),
                                          fsigma8=True),
            "inline": inline}


@pytest.mark.parametrize("key", ["dr12_fs8", "inline"])
def test_bao_fsigma8_rows(fs8_sets, theories, key):
    jth, tth = theories
    jl, tl = JBAO(fs8_sets[key]), TBAO(fs8_sets[key], device="cpu")
    assert tl.types == jl.types and "f_sigma8" in tl.types
    if key == "dr12_fs8":
        assert tl.types == sd.DR12_FS8_TYPES
    tv = tl.theory_vector(tth)
    chi2 = tl.log_like(tth, torch.zeros(3, 0, dtype=F64))
    for i, j in enumerate(jth):
        assert_close(tv[i], jl.theory_vector(j), VEC_RTOL)
        assert_close(chi2[i], jl.log_like(j, jnp.zeros(0)), CHI2_RTOL)
    # the theory's own table, interpolated in z per chain
    assert_close(tth.fsigma8_at(0.45)[1], jth[1].fsigma8_at(0.45), VEC_RTOL)
    assert_close(tth.sigma8_at(torch.tensor([0.1, 0.9], dtype=F64))[2],
                 jth[2].sigma8_at(jnp.asarray([0.1, 0.9])), VEC_RTOL)


def test_pk_likelihoods_default_to_the_card(sets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TMPK(sets["mpk_dr4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TWZ(sets["wz_gigglez"])
