"""Port parity of importance sampling (action=1) and the minimizer
(action=2): sampling/importance.py and sampling/minimize.py.

The same numpy inputs go through the JAX functions (one-point posteriors,
vmapped and jitted there) and the port's (batched posteriors), float64 on
the CPU:
  - importance: weights, -logL and the ESS fraction 1e-12 relative, for
    arrays and chain files, in both modes; the port's result bit for bit
    the same whatever the row block;
  - minimizer, L-BFGS-B with the refine off, on a toy Gaussian and on the
    background posterior (a synthetic DR12-shaped BAO set + HST): best
    point 1e-6 relative, -logL 1e-9 relative (1e-9 absolute near 0);
    `estimate_covariance` against the inverse of `jax.hessian` 1e-8
    relative; `write_minimum_file` byte-equal; the low-temperature refine
    never raises the -logL;
  - tests/test_importance_minimize.py's statistical cases on the port.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.bao import BAOLikelihood as JBAO
from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.likelihoods.hst import HSTLikelihood as JHST
from cosmomc_tpu.params.parameterizations import BackgroundParameterization as JBgPar
from cosmomc_tpu.params.space import Param as JParam
from cosmomc_tpu.params.space import ParameterSpace as JSpace
from cosmomc_tpu.params.space import Speed as JSpeed
from cosmomc_tpu.pipeline import BackgroundPosterior as JPost
from cosmomc_tpu.sampling import importance as jimp
from cosmomc_tpu.sampling import minimize as jmin

from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood as TBAO
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.likelihoods.hst import HSTLikelihood as THST
from cosmomc_tpu_torch.models.theory import compute_background_theory
from cosmomc_tpu_torch.params.parameterizations import BackgroundParameterization as TBgPar
from cosmomc_tpu_torch.params.space import Param, ParameterSpace, Speed
from cosmomc_tpu_torch.pipeline import BackgroundPosterior as TPost
from cosmomc_tpu_torch.sampling import importance as timp
from cosmomc_tpu_torch.sampling import minimize as tmin

F64 = torch.float64
RTOL = 1e-12
BEST_RTOL, MLL_RTOL, HESS_RTOL = 1e-6, 1e-9, 1e-8
HST = dict(H0=73.48, H0_err=1.66, zeff=0.04)
CPU = dict(device="cpu", dtype=F64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol=RTOL, atol=0.0):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rtol * np.abs(ref).max() + atol, f"abs err {err:.3e}"


def gauss(mean, cov):
    """(JAX one-point, port batched) -logL of N(mean, cov)."""
    icov = np.linalg.inv(cov)
    ji, jm = jnp.asarray(icov), jnp.asarray(mean)
    ti, tm = torch.as_tensor(icov, dtype=F64), torch.as_tensor(mean, dtype=F64)

    def jfn(P):
        d = P - jm
        return 0.5 * d @ ji @ d, jnp.zeros((0,), P.dtype)

    def tfn(P):
        d = P - tm.to(P.dtype)
        return (0.5 * torch.einsum("ci,ij,cj->c", d, ti.to(P.dtype), d),
                P.new_zeros(P.shape[0], 0))
    return jfn, tfn


def write_background_sets(d):
    """A DR12-shaped BAO set written from the port's float64 theory at
    BACKGROUND_TRUTH, scattered by a seeded generator."""
    par = TBgPar()
    full = np.array([p.center for p in par.default_space().params])
    for k, v in sd.BACKGROUND_TRUTH.items():
        full[par.names.index(k)] = v
    th = compute_background_theory(par.to_background(
        torch.as_tensor(full[None], dtype=F64)))
    tv = TBAO(sd.write_dr12_bao(d), device="cpu").theory_vector(th)
    return dict(dr12=sd.write_dr12_bao(d, tv[0].numpy(),
                                       np.random.default_rng(7)))


@pytest.fixture(scope="module")
def bg_posts(tmp_path_factory):
    sets = write_background_sets(str(tmp_path_factory.mktemp("bg")))
    jl, tl = JLikes(), TLikes()
    jl.add(JBAO(sets["dr12"], dtype=jnp.float64))
    jl.add(JHST(**HST))
    tl.add(TBAO(sets["dr12"], **CPU))
    tl.add(THST(**HST))
    jpar, tpar = JBgPar(jnp.float64), TBgPar()
    return (JPost(jpar, jpar.default_space(), jl, dtype=jnp.float64),
            TPost(tpar, tpar.default_space(), tl, **CPU))


# ------------------------------------------------------------- importance

@pytest.fixture(scope="module")
def stored():
    """A stored N(0, 1) chain in 2D with integer weights."""
    rng = np.random.default_rng(0)
    s = rng.normal(0, 1.0, (3000, 2))
    return s, rng.integers(1, 4, 3000).astype(float), 0.5 * (s ** 2).sum(1)


@pytest.mark.parametrize("mode", ["replace", "add"])
def test_importance_arrays_parity(stored, mode):
    s, w, old = stored
    jfn, tfn = gauss(np.array([0.3, -0.2]), np.diag([0.64, 0.81]))
    j = jimp.importance_sample_arrays(s, w, old, jfn, mode=mode)
    t = timp.importance_sample_arrays(s, w, old, tfn, mode=mode, **CPU)
    assert_close(t.weights, j.weights)
    assert_close(t.mloglike, j.mloglike)
    assert_close(t.eff_frac, j.eff_frac)
    np.testing.assert_array_equal(t.samples, j.samples)


def test_importance_block_size_independent(stored):
    """Rows are chains of their own: blocks of 7 rows give the result of
    one block, bit for bit."""
    s, w, old = stored
    _, tfn = gauss(np.array([0.3, -0.2]), np.diag([0.64, 0.81]))
    a = timp.importance_sample_arrays(s, w, old, tfn, batch=8192, **CPU)
    b = timp.importance_sample_arrays(s, w, old, tfn, batch=7, **CPU)
    np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(a.mloglike, b.mloglike)


def test_importance_chain_files_parity(tmp_path, bg_posts):
    """Chain files of the background posterior reweighted under it without
    HST: the written files' numbers and the pooled result 1e-12."""
    jpost, tpost = bg_posts
    rng = np.random.default_rng(2)
    root = str(tmp_path / "run")
    centre = np.array([p.center for p in tpost.space.varying])
    width = np.array([p.propose_width for p in tpost.space.varying])
    for c in (1, 2):
        s = centre + width * rng.normal(0, 1.0, (400, 3))
        mll = tpost.logpost()(torch.as_tensor(s, dtype=F64))[0].numpy()
        np.savetxt(f"{root}_{c}.txt", np.column_stack(
            [rng.integers(1, 3, 400), mll, s, rng.random(400)]), fmt="%.7E")
    tpost.paramnames().write(root + ".paramnames")
    jl, tl = JLikes(), TLikes()
    jl.add(jpost.likes.likes[0])
    tl.add(tpost.likes.likes[0])
    jp = JPost(jpost.parameterization, JBgPar(jnp.float64).default_space(), jl,
               dtype=jnp.float64)
    tp = TPost(tpost.parameterization, TBgPar().default_space(), tl, **CPU)
    j = jimp.importance_sample_chains(root, jp.logpost(), str(tmp_path / "j" / "r"))
    t = timp.importance_sample_chains(root, tp.logpost(), str(tmp_path / "t" / "r"),
                                      batch=64, **CPU)
    for f in ("weights", "mloglike", "eff_frac"):
        assert_close(getattr(t, f), getattr(j, f))
    assert 0 < t.eff_frac < 1
    for c in (1, 2):
        assert_close(np.loadtxt(tmp_path / "t" / f"r_{c}.txt"),
                     np.loadtxt(tmp_path / "j" / f"r_{c}.txt"))
    for ext in (".paramnames",):
        assert (tmp_path / "t" / f"r{ext}").read_text() == \
            (tmp_path / "j" / f"r{ext}").read_text()


def test_importance_reweight_matches_direct():
    rng = np.random.default_rng(0)
    n = 200_000
    samples = rng.normal(0, 1.0, (n, 2))
    old_mll = 0.5 * (samples ** 2).sum(axis=1)
    mean, cov = np.array([0.3, -0.2]), np.diag([0.64, 0.64])
    res = timp.importance_sample_arrays(samples, np.ones(n), old_mll,
                                        gauss(mean, cov)[1], **CPU)
    wmu = (res.weights[:, None] * res.samples).sum(0) / res.weights.sum()
    xc = res.samples - wmu
    wcov = (res.weights[:, None] * xc).T @ xc / res.weights.sum()
    np.testing.assert_allclose(wmu, mean, atol=0.02)
    np.testing.assert_allclose(np.diag(wcov), np.diag(cov), rtol=0.05)
    assert res.eff_frac > 0.3


def test_importance_add_mode():
    """mode='add': new total = old + delta, w *= exp(-delta)."""
    rng = np.random.default_rng(1)
    n = 100_000
    samples = rng.normal(0, 1.0, (n, 1))
    old_mll = 0.5 * (samples ** 2).sum(axis=1)
    res = timp.importance_sample_arrays(
        samples, np.ones(n), old_mll,
        lambda P: (0.5 * (P * P).sum(-1), P.new_zeros(P.shape[0], 0)),
        mode="add", **CPU)
    wvar = np.average(res.samples[:, 0] ** 2, weights=res.weights)
    assert abs(wvar - 0.5) < 0.02
    np.testing.assert_allclose(res.mloglike, 2 * old_mll, rtol=1e-10)


def test_importance_default_device_needs_cuda(stored):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    s, w, old = stored
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timp.importance_sample_arrays(s, w, old, gauss(np.zeros(2), np.eye(2))[1])


# -------------------------------------------------------------- minimizer

def _spaces():
    js, ts = JSpace(), ParameterSpace()
    for sp, P, S in ((js, JParam, JSpeed), (ts, Param, Speed)):
        sp.add(P("x", 0.5, -10, 10, 0.5, 0.5, "x", S.SLOW))
        sp.add(P("y", -0.5, -10, 10, 0.5, 0.5, "y", S.FAST))
    return js, ts


def test_minimizer_gaussian_parity(tmp_path):
    mean = np.array([1.234, -2.345])
    cov = np.array([[0.04, 0.015], [0.015, 0.09]])
    jfn, tfn = gauss(mean, cov)
    js, ts = _spaces()
    j = jmin.find_best_fit(jfn, js, refine_temperature=None)
    t = tmin.find_best_fit(tfn, ts, refine_temperature=None, **CPU)
    assert_close(t.P, j.P, BEST_RTOL)
    assert_close(t.mloglike, j.mloglike, MLL_RTOL, atol=1e-9)
    np.testing.assert_allclose(t.P, mean, atol=1e-4)
    C = tmin.estimate_covariance(tfn, t.P, **CPU)
    assert_close(C, jmin.estimate_covariance(jfn, t.P), HESS_RTOL)
    np.testing.assert_allclose(C, cov, rtol=1e-5, atol=1e-8)
    # the same BestFit through both writers: the same bytes
    for mod, sp, name in ((jmin, js, "j"), (tmin, ts, "t")):
        mod.write_minimum_file(str(tmp_path / f"{name}.minimum"), sp, t)
    assert (tmp_path / "t.minimum").read_bytes() == \
        (tmp_path / "j.minimum").read_bytes()
    # Nelder-Mead (no gradient) reaches the same optimum
    nm = tmin.find_best_fit(tfn, ts, use_grad=False, refine_temperature=None,
                            **CPU)
    np.testing.assert_allclose(nm.P, mean, atol=1e-4)


def test_minimizer_background_parity(bg_posts):
    jpost, tpost = bg_posts
    j = jmin.find_best_fit(jpost.logpost(), jpost.space, refine_temperature=None)
    t = tmin.find_best_fit(tpost.logpost(), tpost.space, refine_temperature=None,
                           **CPU)
    assert_close(t.P, j.P, BEST_RTOL)
    assert_close(t.mloglike, j.mloglike, MLL_RTOL)
    assert 0.2 < t.P[0] < 0.45 and 60 < t.P[1] < 80
    C = tmin.estimate_covariance(tpost.logpost(), t.P, **CPU)
    H = np.asarray(jax.jit(jax.hessian(lambda p: jpost.logpost()(p)[0]))(
        jnp.asarray(t.P)))
    assert_close(np.linalg.inv(C), 0.5 * (H + H.T), HESS_RTOL)
    assert np.all(np.linalg.eigvalsh(C) > 0)
    # the refine from that optimum never raises the -logL
    r = tmin.find_best_fit(tpost.logpost(), tpost.space, start=t.P,
                           refine_temperature=0.02, refine_steps=128,
                           refine_chains=16, **CPU)
    assert r.mloglike <= t.mloglike + 1e-12
    assert r.n_evals >= 128 * 16


def test_minimizer_gaussian_with_refine():
    """tests/test_importance_minimize.py's case: optimum and covariance of a
    correlated Gaussian, with the refine on."""
    mean = np.array([1.234, -2.345])
    cov = np.array([[0.04, 0.015], [0.015, 0.09]])
    tfn = gauss(mean, cov)[1]
    best = tmin.find_best_fit(tfn, _spaces()[1], refine_temperature=0.02,
                              refine_steps=128, refine_chains=16, **CPU)
    np.testing.assert_allclose(best.P, mean, atol=1e-4)
    assert best.mloglike < 1e-6
    np.testing.assert_allclose(tmin.estimate_covariance(tfn, best.P, **CPU),
                               cov, rtol=1e-5, atol=1e-8)
