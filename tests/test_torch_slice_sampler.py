"""Port parity of the staged sampler on the whole slice's posteriors
(tests/test_torch_slice.py's `posts` and `points`, imported): three
sampler steps (slow, semi, fast) from the same state, with the JAX
sampler's random draws recomputed from its key and injected into the
port: identical accept decisions, points and -logL. A file of its own so
that `--dist loadfile` runs it beside the posterior checks.

On that state's slow cache (the JAX caches carried by `convert`), the
gradient through the semi and fast stages with the slow cache held:
finite, and nonzero along logA, ns and A_planck for every chain (the
JAX package's tests/test_cmb_posterior.py:141-168), while the full path's
gradient reaches the slow stage (held to JAX in
test_torch_grad_flagship.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.sampling import proposal as jprop
from cosmomc_tpu.sampling.proposal import ProposalSchedule
from cosmomc_tpu.sampling.staged import StagedMetropolisSampler as JSampler

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.sampling.staged import SegmentDraws
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler as TSampler

from test_torch_slice import F64, MLL_ATOL, MLL_RTOL, points, posts  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(jsampler, state, sched):
    """The JAX segment's random numbers, recomputed from its key exactly as
    staged.py:197-202 and :146, proposal.py:314-324 draw them."""
    prop = jsampler.proposal
    nchains = state.P.shape[0]
    key, k_rot = jax.random.split(state.key)
    deltas = prop.segment_deltas(k_rot, nchains, sched, state.mapping,
                                 state.P.dtype)
    m2 = prop.schedule_radius_dims(sched)
    radius, u = [], []
    for t in range(len(sched.block)):
        key, k_prop, k_acc = jax.random.split(key, 3)
        radius.append(jprop._propose_r_m(k_prop, nchains, m2[t], state.P.dtype))
        u.append(jax.random.exponential(k_acc, (nchains,), state.P.dtype))
    return SegmentDraws(*(torch.as_tensor(np.asarray(x), dtype=F64)
                          for x in (deltas, jnp.stack(radius), jnp.stack(u))))


@pytest.fixture(scope="module")
def samplers(posts, points):
    """Both samplers and the same start state in both: the JAX caches,
    carried by convert."""
    jpost, tpost = posts
    jprop_ = jpost.make_proposal(oversample_fast=4)
    tprop = tpost.make_proposal(oversample_fast=4)
    w = np.array([p.propose_width for p in jpost.space.varying])
    jprop_.set_covariance(np.diag(w ** 2))
    tprop.set_covariance(np.diag(w ** 2))
    js, ts = JSampler(jprop_, jpost), TSampler(tprop, tpost)
    jstate = js.init_state(jax.random.PRNGKey(3), jnp.asarray(points[1:3]))
    return js, ts, jstate, convert.staged_chain_state(jstate)


def test_sampler_steps_match(samplers):
    js, ts, jstate, tstate = samplers
    jprop_ = js.proposal
    np.testing.assert_array_equal(ts.block_class, js.block_class)
    # one step of each class, in block order slow, semi, fast
    sizes = jprop_.block_sizes
    sched = ProposalSchedule(np.array([0, 1, 2], np.int32),
                             np.array([0, 1, 0], np.int32),
                             np.zeros(3, np.int32),
                             tuple(3 // s + 1 for s in sizes))
    assert list(js.block_class[sched.block]) == [0, 1, 2]
    draws = _jax_draws(js, jstate, sched)
    jfinal, jout = js.run_segment(jstate, sched)
    tfinal, tout = ts.run_segment(tstate, sched, draws=draws)
    np.testing.assert_array_equal(tout.accept.numpy(), np.asarray(jout.accept))
    np.testing.assert_allclose(tout.P.numpy(), np.asarray(jout.P), rtol=1e-12)
    np.testing.assert_allclose(tout.mloglike.numpy(), np.asarray(jout.mloglike),
                               rtol=MLL_RTOL, atol=MLL_ATOL)
    np.testing.assert_array_equal(tfinal.num_accept.numpy(),
                                  np.asarray(jfinal.num_accept))


class _Reached(Exception):
    """Raised by the stubbed first step of the slow stage."""


def test_gradient_semi_fast(posts, samplers, monkeypatch):
    _, tpost = posts
    tstate = samplers[3]
    slow = tstate.slow
    P = tstate.P.clone().requires_grad_(True)
    full = tpost.embed_full(P)
    mll, _ = tpost.stage_fast(P, slow, tpost.stage_semi(full, slow))
    (g,) = torch.autograd.grad(mll.sum(), P)
    assert bool(torch.isfinite(g).all())
    names = [p.name for p in tpost.space.varying]
    for nm in ("logA", "ns", "A_planck"):
        assert bool((g[:, names.index(nm)] != 0).all()), nm
    # the full path takes a gradient now (K2a's and K3's reverse passes):
    # the slow stage's guard lets it through to the theory, stubbed here;
    # the full gradient itself is held to jax.jvp, and its logA, ns and
    # A_planck components to this held-cache gradient, in
    # test_torch_grad_flagship.py at a reduced lmax
    assert tpost.gradient_unsupported() is None

    def reached(*a):
        raise _Reached
    monkeypatch.setattr(tpost.parameterization, "to_background", reached)
    with pytest.raises(_Reached):
        torch.autograd.grad(tpost.logpost()(P)[0].sum(), P)
