"""Port parity of CMBPosterior's high-l template splice (`lmax_computed`,
`highl_template`) against the JAX package's, float64 on the CPU.

tests/test_torch_extended_config.py's small configuration (kmax = 0.1,
source_nk = (24, 48), 2048 Boltzmann steps, no halofit lensing, lmax 700)
with lmax_computed = 500. The likelihoods raise lmax past 700: a
fabricated SPTpol TE/EE set over 400 <= l <= 899, whose l-derivatives
straddle the splice at 500, and an SPT-SZ-shaped CMBLike2 TT set to
l = 3000, all of it above the splice. The template is
`write_highl_template`'s look-alike built from a smooth analytic lensed
spectrum to l = 500 (the real HighL_lensedCls.dat is not in the
repository). Both packages get the same synthetic BBN table.

Checked: the LOS runs to lmax_computed + lens_margin and lensing to
lmax_computed (not to the raised lmax); the C_l of two chains against
JAX (1e-9 of each spectrum's maximum), above 500 equal to TT(500) /
template TT(500) times the template, phi-phi 0 there; -logL with the two
likelihoods against JAX (1e-9 relative); the staged sampler's init equal
to the monolithic posterior (1e-12); the template's checks (missing,
not in muK^2, too short) raise ValueError.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.likelihoods.cmblikes import CMBLikes as JCMBLikes
from cosmomc_tpu.likelihoods.sptpol import SPTpolTEEELikelihood as JTEEE
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JTheta
from cosmomc_tpu.pipeline import CMBPosterior as JPost

from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.likelihoods.cmblikes import CMBLikes as TCMBLikes
from cosmomc_tpu_torch.likelihoods.sptpol import SPTpolTEEELikelihood as TTEEE
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TTheta
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler as TSampler

F64 = torch.float64
LM = 500
CFG = dict(kmax=0.1, source_nk=(24, 48), n_step_boltzmann=2048,
           nonlinear_lens=False, lmax=700, lmax_computed=LM)
TEEE_EDGES = np.arange(400, 901, 50)
POINT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
             tau=0.05430138, logA=3.0447260, ns=0.9658923)
CLS_TOL, MLL_RTOL = 1e-9, 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth_lensed(lmax):
    """A (4, 4, lmax+1) smooth stand-in for a lensed spectrum (muK^2)."""
    l = np.arange(lmax + 1, dtype=float)
    l[:2] = 2.0
    cls = np.zeros((4, 4, lmax + 1))
    damp = np.exp(-(l / 1400.0) ** 2)
    cls[0, 0] = 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0) ** 2)
    cls[1, 1] = 40.0 * damp * (l / 1000.0) * (1.0 + np.sin(np.pi * l / 300.0) ** 2)
    cls[2, 2] = 0.1 * (l / 1000.0) * damp
    cls[1, 0] = cls[0, 1] = 0.4 * np.sqrt(cls[0, 0] * cls[1, 1]) * np.cos(
        np.pi * l / 150.0)
    return cls


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("highl")
    tmpl = sd.write_highl_template(str(d / "highl.dat"), smooth_lensed(LM), 3000)
    fid = smooth_lensed(3000)
    ls = 0.5 * (TEEE_EDGES[:-1] + TEEE_EDGES[1:] - 1)
    teee = sd.write_sptpol_teee(str(d / "teee"), np.stack(
        [np.interp(ls, np.arange(3001), fid[i, j]) for i, j in ((1, 0), (1, 1))]),
        edges=TEEE_EDGES, settings=dict(correct_aberration="T"))
    lsz = 0.5 * (sd.SPTSZ_EDGES[:-1] + sd.SPTSZ_EDGES[1:] - 1)
    tt = sd.write_cmblikes_tt(str(d / "sptsz"),
                              np.interp(lsz, np.arange(3001), fid[0, 0]))
    tab = synthetic_bbn_table()
    jtab = JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))
    return dict(tmpl=tmpl, teee=teee, tt=tt, tab=tab, jtab=jtab)


def _likes(s):
    jl, tl = JLikes(), TLikes()
    jl.add(JTEEE(s["teee"]))
    jl.add(JCMBLikes(s["tt"]))
    tl.add(TTEEE(s["teee"], device="cpu"))
    tl.add(TCMBLikes(s["tt"], device="cpu"))
    return jl, tl


@pytest.fixture(scope="module")
def posts(setup):
    jl, tl = _likes(setup)
    jpost = JPost(JTheta(jnp.float64), JTheta(jnp.float64).default_space(), jl,
                  bbn_table=setup["jtab"], dtype=jnp.float64,
                  highl_template=setup["tmpl"], **CFG)
    tpost = TPost(TTheta(), TTheta().default_space(), tl, bbn_table=setup["tab"],
                  device="cpu", dtype=F64, highl_template=setup["tmpl"], **CFG)
    rng = np.random.default_rng(20261017)
    P0 = np.array([POINT.get(p.name, p.center) for p in jpost.space.varying])
    w = np.array([p.propose_width for p in jpost.space.varying])
    points = np.vstack([P0, P0 + 0.5 * w * rng.standard_normal(len(w))])
    jslow = jax.jit(jpost.stage_slow)
    ref = []
    for p in points:
        full = jpost.embed_full(jnp.asarray(p))
        slow = jslow(full)
        semi = jpost.stage_semi(full, slow)
        mll, _ = jpost.stage_fast(jnp.asarray(p), slow, semi)
        ref.append((np.asarray(semi["cls"]), float(mll)))
    P = torch.as_tensor(points, dtype=F64)
    full = tpost.embed_full(P)
    slow = tpost.stage_slow(full)
    semi = tpost.stage_semi(full, slow)
    return dict(jpost=jpost, tpost=tpost, P=P, full=full, slow=slow, semi=semi,
                j_cls=np.stack([c for c, _ in ref]),
                j_mll=np.array([m for _, m in ref]))


def test_splice_settings(posts):
    """The likelihoods raise lmax to 3000 in both packages; the splice is
    on; the LOS ran to lmax_computed + lens_margin, not past it."""
    j, t = posts["jpost"], posts["tpost"]
    assert t.lmax == j.lmax == 3000 and t.lmax_computed == j.lmax_computed == LM
    np.testing.assert_array_equal(t._highl.numpy(), j._highl)
    clt = posts["slow"]["clt"]
    assert int(clt.ls.max()) == LM + t.lens_margin


def test_cls_match_jax(posts):
    t, cls, jc = posts["tpost"], posts["semi"]["cls"].numpy(), posts["j_cls"]
    assert cls.shape == jc.shape == (2, 4, 4, 3001)
    for i, j in ((0, 0), (1, 0), (0, 1), (1, 1), (2, 2), (3, 3)):
        err = np.abs(cls[:, i, j] - jc[:, i, j]).max() / np.abs(jc[:, i, j]).max()
        assert err < CLS_TOL, (i, j, err)
    tmpl = t._highl.numpy()
    norm = cls[:, 0, 0, LM] / tmpl[LM, 0]
    for (i, j), col in (((0, 0), 0), ((1, 1), 1), ((2, 2), 2), ((1, 0), 3),
                        ((0, 1), 3)):
        np.testing.assert_allclose(cls[:, i, j, LM + 1:],
                                   norm[:, None] * tmpl[LM + 1:, col],
                                   rtol=1e-15, atol=0.0)
    assert not cls[:, 3, 3, LM + 1:].any()
    assert np.all(cls[:, 0, 0, 2:] > 0) and np.all(cls[:, 3, 3, 2:LM + 1] > 0)


def test_loglike_and_staged(posts):
    """-logL of both chains against JAX's stage_fast; then the posterior
    (bounds and priors on) and the staged sampler's init agree, the init
    taking the monolithic call's slow stage (a function of the parameters
    alone)."""
    t, P = posts["tpost"], posts["P"]
    mll, _ = t.stage_fast(P, posts["slow"], posts["semi"])
    np.testing.assert_allclose(mll.numpy(), posts["j_mll"], rtol=MLL_RTOL,
                               atol=0.0)
    assert np.all(np.isfinite(mll.numpy()))
    stage_slow = t.stage_slow
    t.stage_slow = lambda full: (posts["slow"] if torch.equal(full, posts["full"])
                                 else stage_slow(full))
    try:
        m_mono, d_mono = t.logpost()(P)
        prop = t.make_proposal()
        prop.set_covariance(np.diag([p.propose_width ** 2
                                     for p in t.space.varying]))
        state = TSampler(prop, t).init_state(P)
    finally:
        t.stage_slow = stage_slow
    np.testing.assert_allclose(state.mloglike.numpy(), m_mono.numpy(), rtol=1e-12)
    np.testing.assert_allclose(state.derived.numpy(), d_mono.numpy(), rtol=1e-12)
    assert state.semi["cls"].shape[-1] == 3001


def test_template_checks(setup, tmp_path):
    """No template, a template not in muK^2, one that stops short of lmax:
    ValueError; a cap at or above lmax: no splice, the template unused."""
    tab = setup["tab"]

    def post(**kw):
        return TPost(TTheta(), TTheta().default_space(), TLikes(), bbn_table=tab,
                     device="cpu", **{**CFG, **kw})
    with pytest.raises(ValueError, match="highl_template"):
        post()
    raw = np.loadtxt(setup["tmpl"])
    low = tmp_path / "low.dat"
    np.savetxt(low, np.column_stack([raw[:, 0], raw[:, 1:] * 1e-12]))
    with pytest.raises(ValueError, match="muK"):
        post(highl_template=str(low))
    short = tmp_path / "short.dat"
    np.savetxt(short, raw[raw[:, 0] <= 600])
    with pytest.raises(ValueError, match="reach"):
        post(highl_template=str(short), lmax=800)
    p = post(lmax_computed=700)
    assert p.lmax_computed == 0 and p._highl is None
