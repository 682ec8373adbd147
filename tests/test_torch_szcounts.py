"""Port parity of the Planck 2015 SZ cluster-counts likelihood
(likelihoods/szcounts.py).

The Planck SZ files are not in the repository: `synthetic.write_sz_selection`
writes the 2015 layout (417 patches x 80 theta noise maps, patch fastest)
and `write_sz_catalogue` a catalogue of given counts per (z, q) bin with
three missing redshifts. The theory is two chains of analytic BBKS-shaped
P(k, z) tables (JAX's tests/test_szcounts.py `_fake_theory`, amplitude and
background varied per chain), given to JAX one chain at a time and to the
port batched, with the port's chain blocks of one chain (smaller than the
two chains) so that the blocking is exercised. float64 on the CPU.
Tolerances: the static tables equal; counts 1e-9 of each chain's maximum;
Cash -logL 1e-10 relative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.szcounts import SZCountsLikelihood as JSZ
from cosmomc_tpu.models import background as jbgm
from cosmomc_tpu.models.matterpower import MatterPower as JMP
from cosmomc_tpu.models.theory import CMBTheoryProducts as JTheory

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods import szcounts as tsz
from cosmomc_tpu_torch.likelihoods.szcounts import SZCountsLikelihood as TSZ
from cosmomc_tpu_torch.models import background as tbgm
from cosmomc_tpu_torch.models.theory import CMBTheoryProducts as TTheory

F64 = torch.float64
DN_RTOL, LL_RTOL = 1e-9, 1e-10
#: (H0, omch2, sigma8) per chain
CHAINS = np.array([[67.5, 0.1197, 0.81], [70.0, 0.1150, 0.84]])
#: the five nuisance values at the centres (beta_SZ fixed at its centre)
NUIS = np.array([1.789, -0.186, 0.80, 0.075, 0.6666666])
#: integer counts per (z bin, S/N bin) the catalogue is written from
COUNTS = np.array([[3, 1, 0, 0, 0], [12, 6, 2, 1, 0], [18, 9, 4, 1, 1],
                   [20, 10, 4, 2, 0], [15, 7, 3, 1, 0], [11, 5, 2, 0, 0],
                   [7, 3, 1, 0, 0], [4, 2, 0, 0, 0], [2, 1, 0, 0, 0],
                   [1, 0, 0, 0, 0], [0, 0, 0, 0, 0]])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_tables(H0, omch2, s8_0):
    """BBKS-shaped P(k) with a made-up smooth growth, normalised to
    sigma8(0) = s8_0 (JAX tests/test_szcounts.py:_fake_theory)."""
    h = H0 / 100.0
    omm = (0.0222 + omch2 + 0.000644) / h ** 2
    k = np.exp(np.linspace(np.log(1e-4), np.log(20.0), 600))
    q = k / (omm * h ** 2 * np.exp(-0.0222 / h ** 2 * (1 + np.sqrt(2 * h)
                                                       / omm)))
    T = (np.log(1 + 2.34 * q) / (2.34 * q)
         * (1 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3
            + (6.71 * q) ** 4) ** -0.25)
    P_shape = (k / 0.05) ** (0.96 - 1.0) * k * T ** 2

    def sig8(row):
        x = k * (8.0 / h)
        w = np.where(x < 1e-3, 1 - x ** 2 / 10,
                     3 * (np.sin(x) - x * np.cos(x)) / np.maximum(x, 1e-9) ** 3)
        d2 = k ** 3 / (2 * np.pi ** 2) * np.exp(row)
        return np.sqrt(np.trapezoid(d2 * w ** 2, np.log(k)))

    lnP0 = np.log(P_shape) + 2 * np.log(s8_0 / sig8(np.log(P_shape)))
    z = np.array([0.0, 0.3, 0.7, 1.2, 2.0])
    D = 1.0 / (1.0 + z) * (1 + 0.2 * z)
    lnP = lnP0[None, :] + 2 * np.log(D)[:, None]
    s8 = np.array([sig8(r) for r in lnP])
    return k, z, lnP, s8


@pytest.fixture(scope="module")
def theories():
    jbg = [jbgm.BackgroundParams.make(ombh2=0.0222, omch2=c[1], H0=c[0],
                                      dtype=jnp.float64) for c in CHAINS]
    jth, tabs = [], []
    for bg, c in zip(jbg, CHAINS):
        k, z, lnP, s8 = _fake_tables(*c)
        tabs.append((lnP, s8))
        mp = JMP(k=jnp.asarray(k), z=jnp.asarray(z), lnP=jnp.asarray(lnP),
                 lnP_nl=jnp.asarray(lnP), lnP_weyl=jnp.asarray(lnP),
                 sigma8_z=jnp.asarray(s8), fsigma8_z=jnp.asarray(s8),
                 h=jnp.asarray(c[0] / 100.0))
        jth.append(JTheory(bg=bg, bf=jbgm.background_functions(bg),
                           rs_drag=jnp.asarray(147.0), cls=None, z_pk=mp.z,
                           sigma8_z=mp.sigma8_z, fsigma8_z=mp.fsigma8_z,
                           mp=mp))
    lnP = np.stack([t[0] for t in tabs])
    s8 = np.stack([t[1] for t in tabs])
    mp = convert.matter_power(JMP(k, z, lnP, lnP, lnP, s8, s8,
                                  CHAINS[:, 0] / 100.0))
    tbg = convert.background_params(jax.tree_util.tree_map(
        lambda *x: jnp.stack(x), *jbg))
    tth = TTheory(tbg, tbgm.background_functions(tbg),
                  torch.full((2,), 147.0, dtype=F64), z_pk=mp.z,
                  sigma8_z=mp.sigma8_z, fsigma8_z=mp.fsigma8_z, mp=mp)
    return jth, tth


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sz"))
    sd.write_sz_selection(d)
    sd.write_sz_catalogue(d, COUNTS)
    return d


@pytest.fixture(scope="module")
def likes(data_dir):
    return (JSZ(data_dir, switch=2, dtype=jnp.float64),
            TSZ(data_dir, switch=2, chain_block=1, device="cpu"))


def _jax_counts(jl, jth, nuis):
    fn = jax.jit(jl.theory_counts)
    return np.stack([np.asarray(fn(th, jnp.asarray(nu)))
                     for th, nu in zip(jth, nuis)])


def _nuis(beta=True):
    """The centres, and chain 1 with every nuisance (but beta_SZ, fixed in
    a posterior, unless `beta`) moved."""
    return np.stack([NUIS, NUIS * np.array([1.05, 0.9, 0.95, 1.3,
                                            1.2 if beta else 1.0])])


def test_static_tables(likes):
    """Catalogue binning with missing redshifts, the log-factorials, the
    erf tables, the lny trapezoid and the z-bin weights."""
    jl, tl = likes
    assert len(tl.steps_z) == 282 and len(tl.steps_m) == 120
    assert tl.ylims.shape == (sd.SZ_NPATCH, sd.SZ_NTHETA)
    assert tl.nmiss == len(sd.SZ_MISSING_Q) == jl.nmiss
    assert tl.ncat == COUNTS.sum() + len(sd.SZ_MISSING_Q) == jl.ncat
    assert tl.dncat_zq.sum() == pytest.approx(tl.ncat, rel=1e-12)
    for name in ("steps_z", "steps_m", "lny", "dncat_zq", "dncat_z",
                 "lnfact_zq", "lnfact_z", "E_zq", "E_z", "lny_coeff",
                 "zbin_w", "ylims", "thetas", "skyfracs"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name),
                                      err_msg=name)
    # the rescaling of the missing rows' S/N columns, by hand
    want = COUNTS.astype(float)
    qlo = 10.0 ** (tl.logy_centers - 0.5 * tsz.DLOGY)
    qhi = 10.0 ** (tl.logy_centers + 0.5 * tsz.DLOGY)
    for q in sd.SZ_MISSING_Q:
        j = (tl.ny if q >= qhi[tl.ny - 1]
             else int(np.nonzero((qlo <= q) & (q < qhi))[0][0]))
        want[:, j] *= (want[:, j].sum() + 1.0) / want[:, j].sum()
    np.testing.assert_allclose(tl.dncat_zq, want, rtol=1e-14)


@pytest.mark.parametrize("mass_function", ["tinker", "watson"])
def test_counts_switch2(likes, theories, mass_function):
    jl, tl = likes
    jth, tth = theories
    nuis = _nuis()
    try:
        jl.mass_function = tl.mass_function = mass_function
        port = tl.theory_counts(tth, torch.as_tensor(nuis)).numpy()
        ref = _jax_counts(jl, jth, nuis)
    finally:
        jl.mass_function = tl.mass_function = "tinker"
    assert port.shape == (2, 11, 5)
    for c in range(2):
        np.testing.assert_allclose(port[c], ref[c], rtol=0,
                                   atol=DN_RTOL * np.abs(ref[c]).max())
    assert 20.0 < port[0].sum() < 20000.0


def test_counts_and_cash_switch1(data_dir, theories):
    jth, tth = theories
    jl = JSZ(data_dir, switch=1, dtype=jnp.float64)
    tl = TSZ(data_dir, switch=1, chain_block=1, device="cpu")
    nuis = _nuis()
    port = tl.theory_counts(tth, torch.as_tensor(nuis)).numpy()
    ref = _jax_counts(jl, jth, nuis)
    assert port.shape == (2, 11)
    for c in range(2):
        np.testing.assert_allclose(port[c], ref[c], rtol=0,
                                   atol=DN_RTOL * np.abs(ref[c]).max())
    nuis = _nuis(beta=False)
    ll = tl.log_like(tth, torch.as_tensor(nuis[:, :4])).numpy()
    want = [float(jax.jit(jl.log_like)(th, jnp.asarray(nu)))
            for th, nu in zip(jth, nuis)]
    np.testing.assert_allclose(ll, want, rtol=LL_RTOL)


def test_cash_loglike_and_blocking(likes, theories, data_dir):
    """Cash -logL per chain against JAX (the varying four nuisances; JAX
    is given beta_SZ's centre), and blocks of 1 or 2 chains agree bit for
    bit."""
    jl, tl = likes
    jth, tth = theories
    nuis = _nuis(beta=False)
    var = torch.as_tensor(nuis[:, :4])
    ll = tl.log_like(tth, var).numpy()
    want = [float(jax.jit(jl.log_like)(th, jnp.asarray(nu)))
            for th, nu in zip(jth, nuis)]
    np.testing.assert_allclose(ll, want, rtol=LL_RTOL)
    # the Cash sum recomputed from the catalogue counts
    DN = tl.theory_counts(tth, torch.as_tensor(nuis)).numpy()
    term = np.where(DN > 0, tl.dncat_zq * np.log(np.maximum(DN, 1e-300))
                    - DN - tl.lnfact_zq, 0.0)
    np.testing.assert_allclose(ll, -term.sum((1, 2)), rtol=1e-12)
    try:
        tl.chain_block = 2
        whole = tl.log_like(tth, var).numpy()
    finally:
        tl.chain_block = 1
    np.testing.assert_array_equal(whole, ll)


def test_prior_switches_and_nuisance(data_dir):
    from cosmomc_tpu.likelihoods import szcounts as jsz
    assert tsz.PRIOR_SWITCHES == jsz.PRIOR_SWITCHES
    assert tsz._NUISANCE_DEFAULTS == jsz._NUISANCE_DEFAULTS
    tl = TSZ(data_dir, priors={"prior_cccp": True, "prior_ystar_SZ": True,
                               "prior_wtg": False}, device="cpu")
    by_name = {p.name: p for p in tl.nuisance}
    assert [p.name for p in tl.nuisance] == list(jsz._NUISANCE_DEFAULTS)
    assert (by_name["bias_SZ"].prior_mean, by_name["bias_SZ"].prior_std) \
        == (0.780, 0.092)
    assert (by_name["ystar_SZ"].prior_mean, by_name["ystar_SZ"].prior_std) \
        == (-0.186, 0.021)
    assert by_name["alpha_SZ"].prior_mean is None
    assert [p.name for p in tl.nuisance if p.varying] == [
        "alpha_SZ", "ystar_SZ", "bias_SZ", "scatter_SZ"]
    with pytest.raises(ValueError, match="mass function"):
        TSZ(data_dir, mass_function="press-schechter", device="cpu")


def test_gradient_in_nuisance(likes, theories):
    _, tl = likes
    _, tth = theories
    var = torch.tensor(_nuis()[:, :4], requires_grad=True)
    (g,) = torch.autograd.grad(tl.log_like(tth, var).sum(), var)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).all())


def test_device_default(data_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSZ(data_dir)
