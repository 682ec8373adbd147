"""Port parity of CMBPosterior with matter_power: the sigma8 derived
values, BAO f_sigma8 rows in the likelihood list, the staged path against
the monolithic one, and the likelihoods' kmax/zmax requirements
(tests/test_torch_lss_astro.py has the LSS-only astro configuration).

float64 on the CPU, both packages given the same synthetic BBN table. The
matter transfers run on a reduced k grid in both packages for the whole
module (36 k to kmax = 2/Mpc, 2048 steps; tests/test_torch_matterpower.py
says why 2048): each package's `compute_matter_transfers` is replaced by
itself with that grid, where its CMBPosterior calls it. The CMB posterior
is test_torch_slice.py's small config (kmax = 0.1, source_nk = (24, 48),
2048 Boltzmann steps, no halofit lensing) at lmax = 700, with a synthetic
DR12 BAO set that carries the three f_sigma8 rows.

Tolerances: -logL 1e-9 relative; every derived value 1e-9 relative but kd
and thetad (5e-3: they difference two ~1e13 cumulative sums, as
test_torch_slice.py says); the staged path against the monolithic one
1e-12.
"""

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

from cosmomc_tpu_torch import pipeline as tpipe
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood as TBAO
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.models import matterpower as tmp
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TTheta
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler as TSampler

F64 = torch.float64
K = tmp.matter_k_grid(kmax=2.0, nk_log_lo=8, nk_lin=16, nk_log_hi=12)
N_STEP = 2048
CFG = dict(kmax=0.1, source_nk=(24, 48), n_step_boltzmann=2048,
           nonlinear_lens=False, lmax=700)
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
               tau=0.05430138, logA=3.0447260, ns=0.9658923)
MLL_RTOL = 1e-9
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


def _vector(post, values):
    return np.array([values.get(p.name, p.center) for p in post.space.varying])


def _assert_derived(names, t_der, j_der):
    for i, (n, _) in enumerate(names):
        np.testing.assert_allclose(t_der[:, i], j_der[:, i], atol=0.0,
                                   rtol=DERIVED_RTOL.get(n, 1e-9), err_msg=n)


# ---------------------------------------------------------------------------
# the flagship with matter power
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cmb(bbn, tmp_path_factory):
    """JAX and port posteriors with the f_sigma8 BAO set, the points (best
    fit and one seeded neighbour) and the JAX values there."""
    tab, jtab = bbn
    # DR12 consensus-like values (DM and H r_d scaled by r_fid, f sigma8)
    vals = np.array([1512.4, 81.21, 0.497, 1975.2, 90.90, 0.458, 2306.7,
                     98.96, 0.436])
    ds = sd.write_dr12_bao(str(tmp_path_factory.mktemp("fs8")), vals,
                           np.random.default_rng(3), fsigma8=True)
    jl, tl = JLikes(), TLikes()
    jl.add(JBAO(ds))
    tl.add(TBAO(ds, device="cpu"))
    jpost = JPost(JTheta(jnp.float64), JTheta(jnp.float64).default_space(), jl,
                  matter_power=True, bbn_table=jtab, dtype=jnp.float64, **CFG)
    tpost = TPost(TTheta(), TTheta().default_space(), tl, matter_power=True,
                  bbn_table=tab, device="cpu", dtype=F64, **CFG)
    rng = np.random.default_rng(20261017)
    P0 = _vector(jpost, BESTFIT)
    w = np.array([p.propose_width for p in jpost.space.varying])
    points = np.vstack([P0, P0 + 0.7 * w * rng.standard_normal(len(w))])
    jfn = jax.jit(jpost.logpost())
    ref = [jfn(jnp.asarray(p)) for p in points]
    return (jpost, tpost, points, np.array([float(m) for m, _ in ref]),
            np.stack([np.asarray(d) for _, d in ref]))


def test_matter_power_posterior_matches(cmb):
    """Derived names (the sigma8 block and the per-z fsigma8z*/sigma8z*
    after the background ones, in JAX's order), -logL and every derived
    value at both points; then the staged path equals the monolithic one."""
    jpost, tpost, points, j_mll, j_der = cmb
    assert tpost.derived_names == jpost.derived_names
    names = [n for n, _ in tpost.derived_names]
    assert names[-11:] == ["sigma8", "S8", "s8omegamp5", "s8omegamp25", "s8h5",
                           "fsigma8z038", "sigma8z038", "fsigma8z051",
                           "sigma8z051", "fsigma8z061", "sigma8z061"]
    assert tpost.z_pk == jpost.z_pk == (0.0, 0.2, 0.38, 0.51, 0.61, 1.0, 2.0)
    P = torch.as_tensor(points, dtype=F64)
    t_mll, t_der = tpost.logpost()(P)
    np.testing.assert_allclose(t_mll.numpy(), j_mll, rtol=MLL_RTOL, atol=0.0)
    _assert_derived(tpost.derived_names, t_der.numpy(), j_der)
    s8 = t_der[0, names.index("sigma8")].item()
    assert 0.6 < s8 < 1.0
    # the staged path: the semi cache carries the P(k, z) tables and the
    # slow cache the matter transfers
    prop = tpost.make_proposal()
    prop.set_covariance(np.diag([p.propose_width ** 2
                                 for p in tpost.space.varying]))
    state = TSampler(prop, tpost).init_state(P)
    np.testing.assert_allclose(state.mloglike.numpy(), t_mll.numpy(), rtol=1e-12)
    np.testing.assert_allclose(state.derived.numpy(), t_der.numpy(), rtol=1e-12)
    assert state.slow["mt"].delta_m_z.shape == (2, 7, len(K))
    assert state.semi["mp"].sigma8_z.shape == (2, 7)


def test_required_kmax_and_zmax(bbn):
    """A likelihood needing kmax 4 and matter power to z = 3 raises kmax,
    turns matter power on (sigma8 stays among the derived names) and
    extends z_pk on a log(1+z) grid, as the JAX package does."""
    tab, jtab = bbn

    class FakeLike:
        name = "fake"
        kind = "WL"
        nuisance = []
        required_kmax = 4.0
        required_zmax = 3.0
        needs_matter_power = True

    jl, tl = JLikes(), TLikes()
    jl.add(FakeLike())
    tl.add(FakeLike())
    jpost = JPost(JTheta(jnp.float64), JTheta(jnp.float64).default_space(), jl,
                  kmax=0.5, bbn_table=jtab, dtype=jnp.float64)
    tpost = TPost(TTheta(), TTheta().default_space(), tl, kmax=0.5,
                  bbn_table=tab, device="cpu")
    assert tpost.kmax == jpost.kmax == 4.0
    assert tpost.matter_power and jpost.matter_power
    assert "sigma8" in [n for n, _ in tpost.derived_names]
    assert tpost.derived_names == jpost.derived_names
    assert len(tpost.z_pk) == 7 + 23 and max(tpost.z_pk) == pytest.approx(3.06)
    np.testing.assert_allclose(tpost.z_pk, jpost.z_pk, rtol=1e-15)
