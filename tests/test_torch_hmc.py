"""Port parity of the HMC sampler (sampling/hmc.py), float64 on the CPU.

  - HMC transitions with the JAX sampler's random draws recomputed from
    its key and injected (`HMCDraws`): points, -logL and accept flags
    equal to 1e-12 relative, on a bounded Gaussian and on the background
    posterior (a synthetic DR12-shaped BAO set + HST);
  - DualAveraging's step-size sequence equal (1e-15) on the same alphas;
  - the batched posterior's per-chain gradient (the gradient of the sum
    over chains) equal to each chain's own (1e-14);
  - tests/test_hmc.py's Gaussian-recovery, step-size and bounds cases
    (:36-87) on the port, and a short run on the background posterior
    with its chains read back by MCSamples (accept > 0.4).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.sampling import hmc as jhmc
from cosmomc_tpu.sampling.metropolis import make_bounded_posterior as jbounded
from cosmomc_tpu.params.space import Param as JParam
from cosmomc_tpu.params.space import ParameterSpace as JSpace
from cosmomc_tpu.params.space import Speed as JSpeed

from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
from cosmomc_tpu_torch.params.space import Param, ParameterSpace, Speed
from cosmomc_tpu_torch.sampling import hmc as thmc
from cosmomc_tpu_torch.sampling.metropolis import make_bounded_posterior

from test_torch_importance_minimize import bg_posts  # noqa: F401

F64 = torch.float64
RTOL = 1e-12
CPU = dict(device="cpu", dtype=F64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if ref.size:
        err = np.abs(port - ref).max()
        assert err <= rtol * max(np.abs(ref).max(), 1e-300), f"abs err {err:.3e}"


def jax_draws(key, num_steps, shape):
    """The JAX segment's random numbers, recomputed from its key exactly as
    hmc.py:84-92 draws them a transition."""
    z, uj, ua = [], [], []
    for _ in range(num_steps):
        key, k_mom, k_acc, k_jit = jax.random.split(key, 4)
        uj.append(jax.random.uniform(k_jit, (), jnp.float64))
        z.append(jax.random.normal(k_mom, shape, jnp.float64))
        ua.append(jax.random.exponential(k_acc, shape[:1], jnp.float64))
    return thmc.HMCDraws(*(torch.as_tensor(np.array(jnp.stack(x)), dtype=F64)
                           for x in (z, uj, ua)))


def both_box():
    """A Gaussian inside a hard box, in both packages: (JAX one-point,
    port batched) bounded posteriors."""
    icov = np.array([[11.0, 2.0], [2.0, 4.0]])
    js, ts = JSpace(), ParameterSpace()
    for sp, P, S in ((js, JParam, JSpeed), (ts, Param, Speed)):
        sp.add(P("x", 0.5, 0.0, 1.0, 0.1, 0.1, speed=S.FAST))
        sp.add(P("y", 0.0, -0.6, 0.6, 0.3, 0.3, speed=S.FAST))
    ja, ta = js.device_arrays(jnp.float64), ts.device_arrays("cpu", F64)
    ji, ti = jnp.asarray(icov), torch.as_tensor(icov, dtype=F64)
    jfn = jbounded(lambda P: (0.5 * P @ ji @ P, jnp.zeros((0,), P.dtype)),
                   ja["lo"], ja["hi"], prior_arrays=ja)
    tfn = make_bounded_posterior(
        lambda P: (0.5 * torch.einsum("ci,ij,cj->c", P, ti, P),
                   P.new_zeros(P.shape[0], 0)), ta["lo"], ta["hi"],
        prior_arrays=ta)
    return jfn, tfn


def run_both(jfn, tfn, P0, nd, steps, leapfrog, eps, inv_mass):
    js = jhmc.HMCSampler(jfn, num_leapfrog=leapfrog, num_derived=nd)
    ts = thmc.HMCSampler(tfn, num_leapfrog=leapfrog, num_derived=nd, **CPU)
    key = jax.random.PRNGKey(11)
    jst = js.init_state(key, jnp.asarray(P0), step_size=eps, inv_mass=inv_mass)
    tst = ts.init_state(P0, step_size=eps, inv_mass=inv_mass)
    assert_close(tst.grad, jst.grad)
    jfin, jout = js.run_segment(jst, steps)
    tfin, tout = ts.run_segment(tst, steps,
                                draws=jax_draws(key, steps, P0.shape))
    np.testing.assert_array_equal(tout.accept.numpy(), np.asarray(jout.accept))
    assert_close(tout.P, jout.P)
    assert_close(tout.mloglike, jout.mloglike)
    assert_close(tout.derived, jout.derived)
    assert_close(tout.alpha, jout.alpha)
    assert_close(tfin.grad, jfin.grad)
    np.testing.assert_array_equal(tfin.num_accept.numpy(),
                                  np.asarray(jfin.num_accept))
    return tout


def test_transitions_match_box():
    """Three transitions of 6 chains, step size large enough that some
    trajectories leave the box or are rejected."""
    jfn, tfn = both_box()
    rng = np.random.default_rng(5)
    P0 = np.column_stack([rng.uniform(0.2, 0.8, 6), rng.normal(0, 0.2, 6)])
    out = run_both(jfn, tfn, P0, 0, 3, 5, 0.35, np.array([0.09, 0.25]))
    acc = out.accept.numpy()
    assert acc.any() and not acc.all()


def test_transitions_match_background(bg_posts):
    """Two transitions of 4 chains on the background posterior (derived
    values carried), proposal-width mass."""
    jpost, tpost = bg_posts
    P0 = tpost.start_positions(np.random.default_rng(3), 4)
    w = np.array([p.propose_width for p in tpost.space.varying])
    run_both(jpost.logpost(), tpost.logpost(), P0, tpost.num_derived, 2, 4,
             0.3, w ** 2)


def test_batched_gradient_is_each_chains_own(bg_posts):
    _, tpost = bg_posts
    sampler = thmc.HMCSampler(tpost.logpost(), **CPU)
    P = torch.as_tensor(tpost.start_positions(np.random.default_rng(4), 5),
                        dtype=F64)
    m, _, g = sampler.value_and_grad(P)
    for i in range(5):
        mi, _, gi = sampler.value_and_grad(P[i:i + 1])
        assert_close(m[i], mi[0], 1e-14)
        assert_close(g[i], gi[0], 1e-14)
    assert float(g.abs().min()) > 0


def test_dual_averaging_sequence():
    jd, td = jhmc.DualAveraging(), thmc.DualAveraging()
    jd.init(0.05)
    td.init(0.05)
    for a in np.random.default_rng(6).uniform(0.2, 1.0, 12):
        assert_close(td.update(float(a)), jd.update(float(a)), 1e-15)
        assert_close(td.log_eps_bar, jd.log_eps_bar, 1e-15)
    assert_close(td.final(), jd.final(), 1e-15)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thmc.HMCSampler(lambda P: None)


# -------------------------------- tests/test_hmc.py's cases, on the port


def _gauss_target(ndim=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(ndim, ndim))
    cov = A @ A.T + ndim * np.eye(ndim)
    cov = cov / np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    scales = np.linspace(0.5, 2.0, ndim)
    cov *= np.outer(scales, scales)
    icov = torch.as_tensor(np.linalg.inv(cov), dtype=F64)
    mean = np.linspace(-1, 1, ndim)
    mt = torch.as_tensor(mean, dtype=F64)

    def raw(P):
        d = P - mt
        return (0.5 * torch.einsum("ci,ij,cj->c", d, icov, d),
                P.new_zeros(P.shape[0], 0))
    return raw, mean, cov, scales


def test_gaussian_moments():
    ndim = 4
    raw, mean, cov, scales = _gauss_target(ndim)
    sampler = thmc.HMCSampler(raw, num_leapfrog=12, **CPU)
    nchains = 64
    start = np.random.default_rng(1).normal(mean, 0.2, (nchains, ndim))
    run = thmc.HMCRun(sampler, nchains, start, seed=2, warmup_segments=6,
                      segment_steps=24, max_steps=1536, r_stop=0.01)
    res = run.run()
    assert res.accept_rate > 0.5
    merr = np.abs(res.means - mean) / scales
    assert merr.max() < 0.06, merr
    cerr = np.abs(res.cov - cov).max() / cov.max()
    assert cerr < 0.15, cerr


def test_step_size_adapted():
    raw, mean, _, _ = _gauss_target(3, seed=3)
    sampler = thmc.HMCSampler(raw, num_leapfrog=8, **CPU)
    run = thmc.HMCRun(sampler, 32,
                      np.random.default_rng(4).normal(mean, 0.2, (32, 3)),
                      seed=5, warmup_segments=6, segment_steps=16,
                      max_steps=64, r_stop=1e-9, step_size0=1e-3)
    # dual averaging must move the (deliberately tiny) initial step size
    assert run.run().step_size > 5e-3


def test_bounds_respected():
    """Hard prior box: HMC must not leave it (LOG_ZERO rejection)."""
    sp = ParameterSpace()
    sp.add(Param("x", 0.5, 0.0, 1.0, 0.1, 0.1, speed=Speed.FAST))
    sp.add(Param("y", 0.0, -2.0, 2.0, 0.3, 0.3, speed=Speed.FAST))
    arr = sp.device_arrays("cpu", F64)
    lp = make_bounded_posterior(
        lambda P: (0.5 * torch.sum(P ** 2, -1) / 0.09,
                   P.new_zeros(P.shape[0], 0)),
        arr["lo"], arr["hi"], prior_arrays=arr)
    sampler = thmc.HMCSampler(lp, num_leapfrog=8, **CPU)
    rng = np.random.default_rng(6)
    start = np.column_stack([rng.uniform(0.3, 0.7, 32), rng.normal(0, 0.2, 32)])
    run = thmc.HMCRun(sampler, 32, start, seed=7, warmup_segments=4,
                      segment_steps=16, max_steps=256, r_stop=1e-9)
    res = run.run()
    flat = np.concatenate(run._stats).reshape(-1, 2)
    assert flat[:, 0].min() >= 0.0 and flat[:, 0].max() <= 1.0
    assert res.accept_rate > 0.3


def test_background_run(bg_posts, tmp_path):
    """A short HMC run through the background posterior: accepts, finite
    means, chain files MCSamples reads back."""
    _, tpost = bg_posts
    sampler = thmc.HMCSampler(tpost.logpost(), num_leapfrog=6,
                              num_derived=tpost.num_derived, **CPU)
    w = np.array([p.propose_width for p in tpost.space.varying])
    root = str(tmp_path / "hmc" / "run")
    run = thmc.HMCRun(sampler, 8, tpost.start_positions(
        np.random.default_rng(0), 8), seed=1, warmup_segments=3,
        segment_steps=8, max_steps=32, r_stop=1e-9, step_size0=0.1,
        inv_mass0=w ** 2, chain_root=root, paramnames=tpost.paramnames(),
        space=tpost.space)
    res = run.run()
    assert res.accept_rate > 0.4, res.accept_rate
    assert np.isfinite(res.means).all()
    s = MCSamples.load(root, ignore_frac=0.0)
    assert s.samples.shape[1] == 3 + tpost.num_derived
    assert float(s.weights.sum()) == 32 * 8
