"""Port parity of CMBPosterior with the extended parameters free: mnu,
w, wa and alpha1 sampled through the ini overrides (the massive-neutrino
hierarchy, the dark-energy fluid and correlated CDM isocurvature, all
switched on by the pipeline's "auto" rules), with matter power.

float64 on the CPU, both packages given the same synthetic BBN table.
tests/test_torch_lss.py's small configuration: the CMB posterior at
kmax = 0.1, source_nk = (24, 48), 2048 Boltzmann steps, no halofit
lensing, lmax = 700, a synthetic DR12 BAO set with the three f_sigma8
rows, and the matter transfers on a reduced k grid in both packages (36 k
to 2/Mpc, 2048 steps: each package's `compute_matter_transfers` replaced
by itself with that grid for the whole module).

Tolerances: -logL 1e-9 relative; every derived value 1e-9 relative but kd
and thetad (5e-3, as test_torch_slice.py says); the staged path against
the monolithic one 1e-12; the alpha1 map 1e-15.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.bao import BAOLikelihood as JBAO
from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.models import matterpower as jmp
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JTheta
from cosmomc_tpu.pipeline import CMBPosterior as JPost
from cosmomc_tpu.utils.ini import IniFile as JIni

from cosmomc_tpu_torch import pipeline as tpipe
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood as TBAO
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.models import matterpower as tmp
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TTheta
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler as TSampler
from cosmomc_tpu_torch.utils.ini import IniFile as TIni

F64 = torch.float64
K = tmp.matter_k_grid(kmax=2.0, nk_log_lo=8, nk_lin=16, nk_log_hi=12)
N_STEP = 2048
CFG = dict(kmax=0.1, source_nk=(24, 48), n_step_boltzmann=2048,
           nonlinear_lens=False, lmax=700)
#: the extension parameters freed as users free them: mnu as the repo's
#: grid does (cosmomc_tpu/grid/gridconfig.py:16), w as tests/test_grid.py,
#: wa over Planck 2018's w0-wa prior range, alpha1 as the reference
#: (parameterizations.py:177-181)
FREE = {"mnu": "0.06 0 5 0.1 0.03", "w": "-1 -3 1 0.1 0.05",
        "wa": "0 -3 2 0.1 0.05", "alpha1": "0 -0.3 0.3 0.01 0.01"}
#: the best fit, with mnu, w, wa and alpha1 off their LCDM values (w0, wa
#: crossing w = -1)
POINT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
             tau=0.05430138, logA=3.0447260, ns=0.9658923, mnu=0.12,
             w=-0.9, wa=-0.4, alpha1=0.05)
MLL_RTOL = 1e-9
#: test_torch_slice.py's -logL tolerances, for the per-likelihood table
MLL_RTOL_SLICE, MLL_ATOL_SLICE = 1e-8, 1e-6
DERIVED_RTOL = {"kd": 5e-3, "thetad": 5e-3}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reduced_matter_grid():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jmp, "compute_matter_transfers", functools.partial(
            jmp.compute_matter_transfers, k=K, n_step=N_STEP))
        m.setattr(tpipe, "compute_matter_transfers", functools.partial(
            tmp.compute_matter_transfers, k=K, n_step=N_STEP))
        yield


@pytest.fixture(scope="module")
def bbn():
    tab = synthetic_bbn_table()
    return tab, JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                     *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))


def _spaces(keys):
    """The JAX and port theta spaces with `keys` (name -> ini value) as
    param[name] overrides."""
    ini = {f"param[{n}]": v for n, v in keys.items()}
    return (JTheta(jnp.float64).default_space(JIni(keys=dict(ini))),
            TTheta().default_space(TIni(keys=dict(ini))))


def _posts(keys, tab, jtab, jl=None, tl=None, **kw):
    js, ts = _spaces(keys)
    jpost = JPost(JTheta(jnp.float64), js, jl or JLikes(), bbn_table=jtab,
                  dtype=jnp.float64, **kw)
    tpost = TPost(TTheta(), ts, tl or TLikes(), bbn_table=tab, device="cpu",
                  dtype=F64, **kw)
    return jpost, tpost


def test_ini_frees_the_extension_parameters():
    """ThetaParameterization takes param[mnu], param[w], param[wa] and
    param[alpha1] as JAX does: the same names, order, centres, ranges,
    widths, speeds and varying flags."""
    js, ts = _spaces(FREE)
    assert [p.name for p in ts.params] == [p.name for p in js.params]
    for jp, tp in zip(js.params, ts.params):
        assert (tp.center, tp.min, tp.max, tp.start_width, tp.propose_width,
                int(tp.speed), tp.varying) == (
            jp.center, jp.min, jp.max, jp.start_width, jp.propose_width,
            int(jp.speed), jp.varying), tp.name
    assert {p.name for p in ts.varying} >= set(FREE)


@pytest.mark.parametrize("keys,kw", [
    ({}, {}), ({"mnu": FREE["mnu"]}, {}), ({"mnu": "0.3"}, {}),
    ({"mnu": "0.15"}, {}), ({"w": FREE["w"]}, {}), ({"wa": FREE["wa"]}, {}),
    ({"w": "-0.9"}, {}), ({"wa": "0.1"}, {}), ({"alpha1": FREE["alpha1"]}, {}),
    ({"alpha1": "0.02"}, {}), (FREE, {}),
    (FREE, dict(massive_nu_hierarchy=False, de_perturbations=False))])
def test_auto_switches(bbn, keys, kw):
    """The massive-neutrino hierarchy (mnu sampled or fixed above 0.2 eV),
    the DE fluid (w or wa sampled or off -1, 0) and isocurvature (alpha1
    sampled or nonzero) switch on as in JAX; an explicit switch is kept."""
    jpost, tpost = _posts(keys, *bbn, **CFG, **kw)
    assert (tpost.massive_nu_hierarchy, tpost.de_perturbations,
            tpost._iso_enabled) == (jpost.massive_nu_hierarchy,
                                    jpost.de_perturbations, jpost._iso_enabled)
    if "alpha1" in keys:
        assert tpost._i_alpha1 == jpost._i_alpha1
    assert tpost.derived_names == jpost.derived_names


def test_alpha1_amplitude_map(bbn):
    """alpha1 -> sign(a) sqrt(|a| / (1 - |a|)), |a| clipped to 0.99, per
    chain (Calculator_CAMB.f90:109-111, JAX pipeline.py:389-397); 0.0
    without isocurvature."""
    _, tpost = _posts({"alpha1": FREE["alpha1"]}, *bbn, **CFG)
    a = np.array([-0.995, -0.3, -0.01, 0.0, 0.01, 0.05, 0.3, 0.995])
    full = torch.as_tensor(np.tile(tpost._full_template, (len(a), 1)))
    full[:, tpost._i_alpha1] = torch.as_tensor(a)
    absa = np.clip(np.abs(a), 0.0, 0.99)
    np.testing.assert_allclose(tpost.iso_amplitude(full).numpy(),
                               np.sign(a) * np.sqrt(absa / (1.0 - absa)),
                               rtol=1e-15, atol=0.0)
    _, plain = _posts({}, *bbn, **CFG)
    assert plain.iso_amplitude(full) == 0.0


def test_highl_splice_raises(bbn):
    """The high-l template splice needs its template: lmax_computed below
    lmax without one raises ValueError, as in JAX
    (tests/test_pipeline_extras.py); tests/test_torch_highl.py holds the
    splice itself to JAX."""
    tab, _ = bbn
    with pytest.raises(ValueError, match="highl_template"):
        TPost(TTheta(), TTheta().default_space(), TLikes(), bbn_table=tab,
              device="cpu", lmax=2508, lmax_computed=1000)


@pytest.fixture(scope="module")
def extended(bbn, tmp_path_factory):
    """JAX and port posteriors with mnu, w, wa and alpha1 free and the
    f_sigma8 BAO set, the points (POINT and one seeded neighbour) and the
    JAX values there."""
    tab, jtab = bbn
    vals = np.array([1512.4, 81.21, 0.497, 1975.2, 90.90, 0.458, 2306.7,
                     98.96, 0.436])
    ds = sd.write_dr12_bao(str(tmp_path_factory.mktemp("fs8")), vals,
                           np.random.default_rng(3), fsigma8=True)
    jl, tl = JLikes(), TLikes()
    jl.add(JBAO(ds))
    tl.add(TBAO(ds, device="cpu"))
    jpost, tpost = _posts(FREE, tab, jtab, jl, tl, matter_power=True, **CFG)
    rng = np.random.default_rng(20261017)
    P0 = np.array([POINT.get(p.name, p.center) for p in jpost.space.varying])
    w = np.array([p.propose_width for p in jpost.space.varying])
    points = np.vstack([P0, P0 + 0.5 * w * rng.standard_normal(len(w))])
    jfn = jax.jit(jpost.logpost())
    ref = [jfn(jnp.asarray(p)) for p in points]
    return (jpost, tpost, points, np.array([float(m) for m, _ in ref]),
            np.stack([np.asarray(d) for _, d in ref]))


@pytest.fixture(scope="module")
def slow_cache():
    """(full parameters, the port's slow stage there) pairs, filled by the
    first test that needs the slow stage at the fixture's points."""
    return []


def test_extended_posterior_matches(extended, slow_cache):
    """All three sectors on (massive nu and the DE fluid on the source and
    the matter grids, isocurvature on the source grid): derived names,
    -logL and every derived value at both points against JAX; then the
    staged path equals the monolithic one. The sampler's init takes the
    slow stage's result of the monolithic call for the same parameters
    (stage_slow is a function of them alone; recomputing it, ~50 CPU-s,
    adds nothing here that test_torch_lss.py's staged check does not
    cover), so the semi and fast stages and the caches the sampler
    assembles are what is compared."""
    jpost, tpost, points, j_mll, j_der = extended
    assert (tpost.massive_nu_hierarchy, tpost.de_perturbations,
            tpost._iso_enabled, tpost.matter_power) == (True, True, True, True)
    assert tpost.derived_names == jpost.derived_names
    P = torch.as_tensor(points, dtype=F64)
    slow_of, stage_slow = slow_cache, type(tpost).stage_slow.__get__(tpost)

    def stage_slow_once(full):
        for f, slow in slow_of:
            if torch.equal(f, full):
                return slow
        slow_of.append((full.clone(), stage_slow(full)))
        return slow_of[-1][1]
    tpost.stage_slow = stage_slow_once
    t_mll, t_der = tpost.logpost()(P)
    np.testing.assert_allclose(t_mll.numpy(), j_mll, rtol=MLL_RTOL, atol=0.0)
    names = [n for n, _ in tpost.derived_names]
    for i, n in enumerate(names):
        np.testing.assert_allclose(t_der[:, i].numpy(), j_der[:, i], atol=0.0,
                                   rtol=DERIVED_RTOL.get(n, 1e-9), err_msg=n)
    assert bool(torch.isfinite(t_der).all())
    assert 0.5 < t_der[0, names.index("sigma8")].item() < 1.0
    prop = tpost.make_proposal()
    prop.set_covariance(np.diag([p.propose_width ** 2
                                 for p in tpost.space.varying]))
    state = TSampler(prop, tpost).init_state(P)
    assert len(slow_of) == 1 and state.slow["mt"].delta_m_z.shape[0] == 2
    np.testing.assert_allclose(state.mloglike.numpy(), t_mll.numpy(), rtol=1e-12)
    np.testing.assert_allclose(state.derived.numpy(), t_der.numpy(), rtol=1e-12)


def test_per_likelihood_matches(extended, slow_cache):
    """CMBPosterior.compute_theory and per_likelihood (the action=4 table)
    at the first point. The posterior has one likelihood and no prior, so
    JAX's table there is its -logL, which the fixture holds (JAX's
    per_likelihood itself is called on the astro posterior,
    test_torch_lss_astro.py). The port's slow stage (a function of the
    parameters alone) is the one test_extended_posterior_matches computed
    at both points, first chain."""
    jpost, tpost, points, j_mll, _ = extended
    assert all(p.prior_mean is None for p in jpost.space.params)
    full = tpost.embed_full(torch.as_tensor(points, dtype=F64))
    if not slow_cache:
        slow_cache.append((full, type(tpost).stage_slow(tpost, full)))
    (full2, slow2), = slow_cache
    assert torch.equal(full2, full)
    slow0 = select_first(slow2)
    calls = []

    def stage_slow(f):
        assert torch.equal(f, full[:1])
        return slow0
    compute_theory = type(tpost).compute_theory.__get__(tpost)
    tpost.stage_slow = stage_slow
    tpost.compute_theory = lambda f: calls.append(compute_theory(f)) \
        or calls[-1]
    try:
        got = tpost.per_likelihood(points[0])
    finally:
        del tpost.compute_theory, tpost.stage_slow
    assert list(got) == [like.name for like in jpost.likes.likes]
    np.testing.assert_allclose(got[jpost.likes.likes[0].name], j_mll[0],
                               rtol=MLL_RTOL_SLICE, atol=MLL_ATOL_SLICE)
    theory, extras = calls[0]
    assert sorted(extras) == ["r_star", "yhe", "z_star", "zre"]
    assert theory.cls.shape[0] == 1 and theory.mp is not None
    assert all(v.shape == (1,) for v in extras.values())


def select_first(x, field=None):
    """The first chain of a slow cache (shared grids pass through)."""
    from cosmomc_tpu_torch.sampling.staged import SHARED_FIELDS
    if torch.is_tensor(x):
        return x if field in SHARED_FIELDS else x[:1]
    if isinstance(x, dict):
        return {k: select_first(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(select_first(getattr(x, f), f) for f in x._fields))
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: select_first(getattr(x, f.name), f.name)
            for f in dataclasses.fields(x)})
    return x
