"""Port parity of the astro LSS-only posterior's gradient (CPU, float64):
torch.autograd.grad of the port's -logL (AstroParameterization,
CMBPosterior(use_cmb=False, matter_power=True): K4, the thermal tables,
the reionization inversion, K1 on the matter grid, P(k, z), sigma8(z) and
f sigma8(z), a DR12-shaped BAO set with f_sigma8 rows, the priors) against
jax.grad of the JAX package's, at the centre and one point off it.

Reduced in both packages for the whole module (monkeypatch, as
tests/test_torch_lss_astro.py reduces the matter grid): the recombination
history on 1500 z nodes, the matter transfers on 8 k to 0.02/Mpc over 256
steps with the radiation-streaming switch at k tau = 40 (the smallest
grid that stays bounded and still switches; sigma8 is then a number of
the reduced grid, the same in both packages). The port's matter path
checkpoints K1 by chunks (DEFAULT_REMAT_CHUNKS), JAX's keeps every step.
Tolerance 1e-9 of the largest component of each chain's gradient; -logL
1e-9 relative.
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
from cosmomc_tpu.models import perturbations as jpert
from cosmomc_tpu.models import recfast as jrec
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.params.parameterizations import AstroParameterization as JAstro
from cosmomc_tpu.pipeline import CMBPosterior as JPost

from cosmomc_tpu_torch import pipeline as tpipe
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood as TBAO
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.models import matterpower as tmp
from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import AstroParameterization as TAstro
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost

F64 = torch.float64
RTOL = 1e-9
N_Z, N_STEP, RSA = 1500, 256, 40.0
K = np.geomspace(5e-4, 0.02, 8)
#: DR12 consensus-like values (DM and H r_d scaled by r_fid, f sigma8)
DR12 = np.array([1512.4, 81.21, 0.497, 1975.2, 90.90, 0.458, 2306.7, 98.96,
                 0.436])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reduced_grids():
    jct = jrec.compute_thermo
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jrec, "compute_thermo",
                  lambda bg, yhe, n_z=N_Z: jct(bg, yhe, n_z))
        m.setattr(jpert, "compute_thermo", jrec.compute_thermo)
        m.setattr(jmp, "evolve_perturbations", functools.partial(
            jpert.evolve_perturbations, rsa_ktau=RSA))
        m.setattr(jmp, "compute_matter_transfers", functools.partial(
            jmp.compute_matter_transfers, k=K, n_step=N_STEP))
        m.setattr(tpipe, "compute_thermo", functools.partial(
            trec.compute_thermo, n_z=N_Z))
        m.setattr(tmp, "evolve_perturbations", functools.partial(
            tpert.evolve_perturbations, rsa_ktau=RSA))
        m.setattr(tpipe, "compute_matter_transfers", functools.partial(
            tmp.compute_matter_transfers, k=K, n_step=N_STEP))
        yield


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tab = synthetic_bbn_table()
    jtab = JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))
    ds = sd.write_dr12_bao(str(tmp_path_factory.mktemp("grad_astro")), DR12,
                           np.random.default_rng(3), fsigma8=True)
    jl, tl = JLikes(), TLikes()
    jl.add(JBAO(ds))
    tl.add(TBAO(ds, device="cpu"))
    kw = dict(use_cmb=False, matter_power=True, z_pk=(0.0, 0.5, 1.0))
    jpost = JPost(JAstro(jnp.float64), JAstro(jnp.float64).default_space(), jl,
                  bbn_table=jtab, dtype=jnp.float64, **kw)
    tpost = TPost(TAstro(), TAstro().default_space(), tl, bbn_table=tab,
                  device="cpu", dtype=F64, **kw)
    centre = np.array([p.center for p in tpost.space.varying])
    w = np.array([p.propose_width for p in tpost.space.varying])
    points = np.vstack([centre, centre + 0.5 * w * np.array([1, -1, 1, 1, -1])])
    jfn = jpost.logpost()
    vg = jax.jit(jax.value_and_grad(lambda p: jfn(p)[0]))
    ref = [vg(jnp.asarray(p)) for p in points]
    P = torch.tensor(points, dtype=F64, requires_grad=True)
    mll, _ = tpost.logpost()(P)
    (g,) = torch.autograd.grad(mll.sum(), P)
    return (np.array([float(v) for v, _ in ref]),
            np.stack([np.asarray(d) for _, d in ref]),
            mll.detach().numpy(), g.numpy(), tpost)


def test_minus_loglike_matches(both):
    j_mll, _, t_mll, _, _ = both
    assert np.all(np.abs(t_mll) < 1e29)
    np.testing.assert_allclose(t_mll, j_mll, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("chain", [0, 1])
def test_gradient_matches_jax(both, chain):
    _, j_g, _, t_g, _ = both
    assert np.all(np.isfinite(t_g[chain]))
    err = np.abs(t_g[chain] - j_g[chain]).max() / np.abs(j_g[chain]).max()
    assert err <= RTOL, (err, t_g[chain], j_g[chain])


def test_every_parameter_moves_the_likelihood(both):
    """The gradient reaches every sampled parameter through the slow stage
    (none of the five is a pure prior term)."""
    _, _, _, t_g, tpost = both
    assert [p.name for p in tpost.space.varying] == \
        ["omegam", "omegab", "H0", "logA", "ns"]
    assert np.all(t_g != 0.0)
