"""Port parity of the LCDM+r path: CMBPosterior with compute_tensors=True,
los_method="recurrence" and nonlinear_lens=True (halofit lensing), against
the JAX CMBPosterior in the same configuration.

Small config, float64 on the CPU: kmax=0.1, source_nk=(24, 48), 2048
Boltzmann steps (see tests/test_torch_slice.py for why not 1024), lmax 500
(+150 lensing margin; the tensor C_l to 500), synthetic BBN table shared by
both packages. No CMB likelihood: plik_lite fixes lmax at 2508, which the
recurrence engine walks l by l and the CPU pays for in minutes; -logL is
the tau prior, and the C_l stack is compared directly.

  - the lensed C_l stack (scalar + tensor) at the best fit with r = 0.1 and
    at a seeded point with r = 0.04, each package through its own slow
    stage, within CL_RTOL of each spectrum's maximum (1e-9 for BB and PP;
    TT, TE and EE carry a last-ulps sensitivity of the tensor LOS to tau0,
    explained at the test);
  - the witness for that: the port's own slow cache with only the tensor
    transfers redone on JAX's thermal grid and tau0 gives the JAX stack to
    1e-9 for every spectrum;
  - the port's semi stage on the JAX slow cache: 1e-9 for every spectrum;
  - -logL and every derived value at those points (kd and thetad at 5e-3,
    for the reason tests/test_torch_slice.py gives);
  - staged == monolithic in the port.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.models.bbn import yhe_bbn as j_yhe_bbn
from cosmomc_tpu.models.perturbations import build_thermo_funcs as j_thermo_funcs
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JPar
from cosmomc_tpu.pipeline import CMBPosterior as JPost
from cosmomc_tpu.sampling.metropolis import make_bounded_posterior

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.models.perturbations import \
    build_thermo_funcs as t_thermo_funcs
from cosmomc_tpu_torch.models.recfast import compute_thermo
from cosmomc_tpu_torch.models.tensors import (compute_tensor_transfers,
                                              evolve_tensors, tensor_k_grid)
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TPar
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler as TSampler

F64 = torch.float64
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
               tau=0.05430138, logA=3.0447260, ns=0.9658923, r=0.1)
CFG = dict(kmax=0.1, source_nk=(24, 48), n_step_boltzmann=2048, lmax=500,
           compute_tensors=True, los_method="recurrence", nonlinear_lens=True)
DERIVED_RTOL = {"kd": 5e-3, "thetad": 5e-3}
#: measured (CPU, float64): TT 4.3e-5, TE 4.0e-6, EE 1.7e-8, BB 1.9e-12,
#: PP 2.0e-13 of each maximum; see test_cl_stack_matches
CL_RTOL = {"TT": 1e-4, "TE": 1e-5, "EE": 1e-7, "BB": 1e-9, "PP": 1e-9}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU, and the many
    small ops here then spend most of their time waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(par):
    sp = par.default_space()
    sp.get("tau").prior_mean = 0.0544
    sp.get("tau").prior_std = 0.0073
    return sp


@pytest.fixture(scope="module")
def posts():
    tab = synthetic_bbn_table()
    jtab = JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))
    jpost = JPost(JPar(jnp.float64), _space(JPar(jnp.float64)), JLikes(),
                  bbn_table=jtab, dtype=jnp.float64, **CFG)
    tpost = TPost(TPar(), _space(TPar()), TLikes(), bbn_table=tab,
                  device="cpu", dtype=F64, **CFG)
    return jpost, tpost


@pytest.fixture(scope="module")
def points(posts):
    jpost, _ = posts
    names = [p.name for p in jpost.space.varying]
    P0 = np.array([BESTFIT.get(n, p.center)
                   for n, p in zip(names, jpost.space.varying)])
    w = np.array([p.propose_width for p in jpost.space.varying])
    P1 = P0 + 0.5 * w * np.random.default_rng(20261016).standard_normal(len(w))
    P1[names.index("r")] = 0.04
    return np.vstack([P0, P1])


@pytest.fixture(scope="module")
def evaluated(posts, points):
    """JAX: the three stages jitted, under JAX's bounded posterior. Port:
    the monolithic logpost, and the staged path through the sampler's
    init_state (whose semi cache holds the C_l stack)."""
    jpost, tpost = posts
    jslow, jsemi = jax.jit(jpost.stage_slow), jax.jit(jpost.stage_semi)
    jfast = jax.jit(jpost.stage_fast)
    jstages = []

    def raw(P):
        full = jpost.embed_full(P)
        slow = jslow(full)
        semi = jsemi(full, slow)
        jstages.append((full, slow, semi))
        return jfast(P, slow, semi)
    arr = jpost.space.device_arrays(jnp.float64)
    jfn = make_bounded_posterior(raw, arr["lo"], arr["hi"], prior_arrays=arr,
                                 num_derived=jpost.num_derived)
    ref = [jfn(jnp.asarray(p)) for p in points]
    P = torch.as_tensor(points, dtype=F64)
    t_mll, t_der = tpost.logpost()(P)
    prop = tpost.make_proposal()
    prop.set_covariance(np.diag([p.propose_width ** 2
                                 for p in tpost.space.varying]))
    state = TSampler(prop, tpost).init_state(P)
    return dict(j_mll=np.array([float(m) for m, _ in ref]),
                j_der=np.stack([np.asarray(d) for _, d in ref]),
                jstages=jstages, t_mll=t_mll.numpy(), t_der=t_der.numpy(),
                state=state)


SPECTRA = {"TT": (0, 0), "TE": (1, 0), "EE": (1, 1), "BB": (2, 2),
           "PP": (3, 3)}


def test_space_and_names_match(posts):
    jpost, tpost = posts
    assert [p.name for p in tpost.space.varying] == \
        [p.name for p in jpost.space.varying]
    assert "r" in [p.name for p in tpost.space.varying]
    assert tpost.derived_names == jpost.derived_names
    assert tpost.space.speed_blocks() == jpost.space.speed_blocks()


@pytest.mark.parametrize("spec", list(SPECTRA))
def test_cl_stack_matches(evaluated, spec):
    """The whole stack through each package's own slow stage. Tolerance
    CL_RTOL[spec] of each spectrum's maximum: the tensor LOS integrand
    j_l(x)/x^2 at the last tau node (x -> 0) is read from a linear table
    interpolation, ~f j_l(0.2) / max(x, 1e-8)^2, so it jumps with the last
    ulps of tau0 (the port's float64 cumsum and XLA's scan differ by 4 and
    10 ulps at the two points, see test_tau0_is_the_only_gap): tensor
    Delta_T moves by ~0.7% of its maximum, which is ~3e-5 of lensed TT and
    less of TE and EE. BB (tensor B reads no x^-2 term) and the scalar-only
    PP are held to 1e-9."""
    i, j = SPECTRA[spec]
    t_cls = evaluated["state"].semi["cls"].numpy()
    for c, (_, _, semi) in enumerate(evaluated["jstages"]):
        a, b = t_cls[c, i, j], np.asarray(semi["cls"])[i, j]
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= CL_RTOL[spec], (c, err)


@pytest.mark.parametrize("spec", list(SPECTRA))
def test_semi_stage_on_jax_slow_cache(posts, evaluated, spec):
    """stage_semi (scalar + tensor C_l, lensing) on the JAX slow cache,
    carried by convert: 1e-9 of each spectrum's maximum."""
    _, tpost = posts
    i, j = SPECTRA[spec]
    for full, slow, semi in evaluated["jstages"]:
        tslow = convert._slow_cache(slow, None, F64)
        t_cls = tpost.stage_semi(convert.tensor(full)[None], tslow)["cls"]
        a, b = t_cls[0, i, j].numpy(), np.asarray(semi["cls"])[i, j]
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()


def test_inflation_consistency_off(posts, evaluated):
    """inflation_consistency=False (nt = 0, JAX pipeline.py:359) builds in
    the port; stage_semi on the JAX slow cache at the seeded point (r =
    0.04) matches JAX's stage_semi with the same switch, 1e-9 of each
    spectrum's maximum, and the tensor BB differs from nt = -r/8's."""
    jpost, tpost = posts
    j_off = JPost(JPar(jnp.float64), _space(JPar(jnp.float64)), JLikes(),
                  bbn_table=jpost.bbn_table, dtype=jnp.float64,
                  inflation_consistency=False, **CFG)
    t_off = TPost(TPar(), _space(TPar()), TLikes(),
                  bbn_table=synthetic_bbn_table(), device="cpu", dtype=F64,
                  inflation_consistency=False, **CFG)
    full, slow, semi = evaluated["jstages"][1]
    assert float(full[j_off._i_r]) == 0.04
    j_cls = np.asarray(jax.jit(j_off.stage_semi)(full, slow)["cls"])
    tslow = convert._slow_cache(slow, None, F64)
    t_cls = t_off.stage_semi(convert.tensor(full)[None], tslow)["cls"][0]
    for spec, (i, j) in SPECTRA.items():
        a, b = t_cls[i, j].numpy(), j_cls[i, j]
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), spec
    on = np.asarray(semi["cls"])[2, 2, :701]
    assert np.abs(t_cls[2, 2, :701].numpy() - on).max() > 1e-6 * np.abs(on).max()


@pytest.fixture(scope="module")
def witness(posts, evaluated):
    """The port's slow cache with the tensor transfers (K5, K6 plain)
    redone on JAX's thermal grid and tau0; everything else is the port's
    own (scalar transfers, background, lensing inputs)."""
    jpost, tpost = posts

    def j_tf(full):
        bg = jpost.parameterization.to_background(full)
        yhe = j_yhe_bbn(bg.ombh2, bg.nnu - 3.046, jpost.bbn_table)
        return j_thermo_funcs(bg, yhe, full[jpost._i_tau],
                              n_step=jpost.n_step_boltzmann)
    fulls = jnp.stack([full for full, _, _ in evaluated["jstages"]])
    tf, tau0 = jax.jit(jax.vmap(j_tf))(fulls)
    slow = evaluated["state"].slow
    _, t_tau0 = t_thermo_funcs(slow["bg"], slow["yhe"],
                               compute_thermo(slow["bg"], slow["yhe"]),
                               slow["zre"], n_step=tpost.n_step_boltzmann)
    to = evolve_tensors(slow["bg"], convert.thermo_funcs(tf),
                        convert.tensor(tau0), tensor_k_grid())
    tc = compute_tensor_transfers(to, lmax=min(700, tpost.lmax))
    cls = tpost.stage_semi(convert.tensor(fulls), dict(slow, tt_cache=tc))
    return dict(cls=cls["cls"].numpy(), j_tau0=np.asarray(tau0),
                t_tau0=t_tau0.numpy())


def test_tau0_is_the_only_gap(witness):
    """The two packages' tau0 differ in the last few ulps only (measured:
    the port is 4 and 10 ulps below JAX at the two points)."""
    ulps = (witness["t_tau0"] - witness["j_tau0"]) / np.spacing(witness["j_tau0"])
    print("tau0 JAX", witness["j_tau0"], "port", witness["t_tau0"], "ulps", ulps)
    assert np.all(np.abs(ulps) <= 64), ulps


@pytest.mark.parametrize("spec", list(SPECTRA))
def test_cl_stack_on_jax_tau0_matches(evaluated, witness, spec):
    """With only tau0 and the thermal grid taken from JAX, the whole stack
    agrees to 1e-9 of each spectrum's maximum: the CL_RTOL gap of
    test_cl_stack_matches is that input alone, not a scalar-side or K2b
    fault."""
    i, j = SPECTRA[spec]
    for c, (_, _, semi) in enumerate(evaluated["jstages"]):
        b = np.asarray(semi["cls"])[i, j]
        err = np.abs(witness["cls"][c, i, j] - b).max() / np.abs(b).max()
        assert err <= 1e-9, (c, err)


def test_tensor_bb_present(evaluated):
    """BB at the recombination bump (l = 80) grows with r: 0.1 at the best
    fit, 0.04 at the second point, on a lensing BB floor."""
    bb = evaluated["state"].semi["cls"][:, 2, 2].numpy()
    assert np.all(bb[:, 2:] > 0)
    assert 1.3 < bb[0, 80] / bb[1, 80] < 2.5


def test_minus_loglike_matches(evaluated):
    t_mll = evaluated["t_mll"]
    assert np.all(np.isfinite(t_mll)) and np.all(t_mll < 1e29)
    np.testing.assert_allclose(t_mll, evaluated["j_mll"], rtol=1e-9, atol=1e-9)


def test_derived_match(posts, evaluated):
    _, tpost = posts
    for i, (name, _) in enumerate(tpost.derived_names):
        np.testing.assert_allclose(evaluated["t_der"][:, i],
                                   evaluated["j_der"][:, i],
                                   rtol=DERIVED_RTOL.get(name, 1e-9), atol=0.0,
                                   err_msg=name)


def test_staged_equals_monolithic(evaluated):
    state = evaluated["state"]
    np.testing.assert_allclose(state.mloglike.numpy(), evaluated["t_mll"],
                               rtol=1e-12)
    np.testing.assert_allclose(state.derived.numpy(), evaluated["t_der"],
                               rtol=1e-12)
