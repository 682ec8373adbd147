"""Port parity of the whole slice: CMBPosterior and the staged sampler.

The flagship composition without BAO and halofit (theta LCDM, plik_lite
fiducial, tau prior, synthetic BBN table shared by both packages), at the
small config (kmax=0.1, source_nk=(24, 48); plik_lite sets lmax = 2508),
float64 on the CPU, with n_step=2048 Boltzmann steps: at 1024 the coarse
tau grid under-resolves the visibility peak, TT comes out ~1e4 times too
high with large negative values above l ~ 940, and the fiducial's TE
variance ((TT+N)(EE+N)+TE^2) turns negative. The fiducial is written from
the JAX package's own C_l at the best fit.

  - -logL and every derived value at the best fit and 4 seeded points:
    the port's batched posterior against the JAX CMBPosterior;
  - staged == monolithic in the port.

The sampler steps on these posteriors are in test_torch_slice_sampler.py,
so that `--dist loadfile` runs the two halves on two workers.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.likelihoods.forecast import write_plik_lite_fiducial
from cosmomc_tpu.likelihoods.pliklite import PlikLiteLikelihood as JPlik
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JPar
from cosmomc_tpu.pipeline import CMBPosterior as JPost

from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood as TPlik
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TPar
from cosmomc_tpu_torch.pipeline import CMB_DERIVED_NAMES
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler as TSampler

F64 = torch.float64
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
               tau=0.05430138, logA=3.0447260, ns=0.9658923)
CFG = dict(kmax=0.1, source_nk=(24, 48), n_step_boltzmann=2048,
           nonlinear_lens=False)
#: -logL: the C_l agree to ~4e-10 of their maximum; the plik_lite forms
#: weigh them by the inverse bandpower errors (signal-to-noise up to ~1e3
#: per bin over 613 bins), so -logL carries ~1e-9 relative or 1e-7 absolute
MLL_RTOL, MLL_ATOL = 1e-8, 1e-6
#: derived: kd and thetad read the damping integral, which differences two
#: ~1e13 cumulative sums (cosmomc_tpu/models/thermo.py:129) and so depends
#: at ~1e-3 on the summation order alone; every other value at 1e-9
DERIVED_RTOL = {"kd": 5e-3, "thetad": 5e-3}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spaces(spar, tpar_):
    js, ts = spar.default_space(), tpar_.default_space()
    for sp in (js, ts):
        sp.get("tau").prior_mean = 0.0544
        sp.get("tau").prior_std = 0.0073
    return js, ts


def _bestfit_vector(post):
    names = [p.name for p in post.space.varying]
    P = np.array([p.center for p in post.space.varying])
    for k, v in BESTFIT.items():
        P[names.index(k)] = v
    return P


@pytest.fixture(scope="module")
def posts(tmp_path_factory):
    tab = synthetic_bbn_table()
    jtab = JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))
    # fiducial from the JAX package's own C_l at the best fit
    j0 = JPost(JPar(jnp.float64), JPar(jnp.float64).default_space(), JLikes(),
               lmax=2508, bbn_table=jtab, dtype=jnp.float64, **CFG)
    full = j0.embed_full(jnp.asarray(_bestfit_vector(j0)))
    cls = np.asarray(jax.jit(j0.stage_semi)(full, jax.jit(j0.stage_slow)(full))
                     ["cls"])
    d = tmp_path_factory.mktemp("plik_fid")
    ls = np.arange(2, cls.shape[-1])
    theory_cl = os.path.join(str(d), "bestfit.theory_cl")
    np.savetxt(theory_cl, np.column_stack([ls, cls[0, 0, 2:], cls[1, 0, 2:],
                                           cls[1, 1, 2:], cls[2, 2, 2:],
                                           cls[3, 3, 2:]]))
    ds = write_plik_lite_fiducial(str(d), theory_cl)
    js, ts = _spaces(JPar(jnp.float64), TPar())
    jl, tl = JLikes(), TLikes()
    jl.add(JPlik(ds, name="plik_lite", dtype=jnp.float64))
    tl.add(TPlik(ds, name="plik_lite", device="cpu", dtype=F64))
    jpost = JPost(JPar(jnp.float64), js, jl, bbn_table=jtab, dtype=jnp.float64,
                  **CFG)
    tpost = TPost(TPar(), ts, tl, bbn_table=tab, device="cpu", dtype=F64,
                  **CFG)
    return jpost, tpost


@pytest.fixture(scope="module")
def points(posts):
    """The best fit and 4 seeded points within ~1 proposal width of it."""
    jpost, _ = posts
    rng = np.random.default_rng(20261016)
    w = np.array([p.propose_width for p in jpost.space.varying])
    P0 = _bestfit_vector(jpost)
    return np.vstack([P0, P0 + 0.7 * w * rng.standard_normal((4, len(w)))])


def _slow_once(tpost):
    """Make tpost.stage_slow compute once per input: the staged path in
    test_staged_equals_monolithic then reads the slow caches of the
    monolithic evaluation at the same points (the plain K4, K1 and K2a are
    deterministic on the CPU, and the slow stage's parity is held to JAX
    by the tests above), so the file runs them once."""
    stage_slow, done = tpost.stage_slow, {}

    def once(full):
        key = full.detach().numpy().tobytes()
        if key not in done:
            done[key] = stage_slow(full)
        return done[key]
    tpost.stage_slow = once


@pytest.fixture(scope="module")
def evaluated(posts, points):
    jpost, tpost = posts
    _slow_once(tpost)
    jfn = jax.jit(jpost.logpost())
    ref = [jfn(jnp.asarray(p)) for p in points]
    j_mll = np.array([float(m) for m, _ in ref])
    j_der = np.stack([np.asarray(d) for _, d in ref])
    t_mll, t_der = tpost.logpost()(torch.as_tensor(points, dtype=F64))
    return j_mll, j_der, t_mll.numpy(), t_der.numpy()


def test_space_and_derived_names_match(posts):
    jpost, tpost = posts
    assert [p.name for p in tpost.space.varying] == \
        [p.name for p in jpost.space.varying]
    assert tpost.derived_names == jpost.derived_names
    assert tpost.space.speed_blocks() == jpost.space.speed_blocks()


def test_minus_loglike_matches(evaluated):
    j_mll, _, t_mll, _ = evaluated
    assert np.all(np.isfinite(t_mll)) and np.all(t_mll < 1e29)
    np.testing.assert_allclose(t_mll, j_mll, rtol=MLL_RTOL, atol=MLL_ATOL)
    # the fiducial was written at the best fit: only the tau prior remains
    assert t_mll[0] < 0.01


@pytest.mark.parametrize("name", [n for n, _ in CMB_DERIVED_NAMES]
                         + [f"{q}{z}" for z in ("038", "051", "061")
                            for q in ("Hubble", "DM")])
def test_derived_matches(posts, evaluated, name):
    _, tpost = posts
    _, j_der, _, t_der = evaluated
    i = [n for n, _ in tpost.derived_names].index(name)
    np.testing.assert_allclose(t_der[:, i], j_der[:, i],
                               rtol=DERIVED_RTOL.get(name, 1e-9), atol=0.0)


def test_staged_equals_monolithic(posts, points, evaluated):
    """The sampler's staged path (stage_slow -> stage_semi -> stage_fast,
    then bounds and priors) against the monolithic logpost() of
    `evaluated`, at all 5 points; the slow stage's caches are the ones
    `evaluated` computed (`_slow_once`)."""
    _, tpost = posts
    _, _, t_mll, t_der = evaluated
    prop = tpost.make_proposal()
    prop.set_covariance(np.diag([p.propose_width ** 2
                                 for p in tpost.space.varying]))
    state = TSampler(prop, tpost).init_state(torch.as_tensor(points, dtype=F64))
    np.testing.assert_allclose(state.mloglike.numpy(), t_mll, rtol=1e-12)
    np.testing.assert_allclose(state.derived.numpy(), t_der, rtol=1e-12)
