"""Port parity of the sampling run loop: convergence, chain files,
MetropolisSampler, SamplingRun, checkpoint/resume, the staged sampler's
`state_from_arrays`.

The same numpy inputs go through the JAX modules and the port's, float64
on the CPU. Where randomness is involved the JAX sampler's draws are
recomputed from its key (as tests/test_torch_slice.py does) and injected
into the port, so both take the same steps. Tolerances: the host numpy
code is copied, so its results are equal; points and -logL 1e-12; R-1 per
segment 1e-10 relative; the learned covariance 1e-12; chain files
byte-equal; a resumed run equal bit for bit.
"""

import os
from functools import partial
from typing import NamedTuple

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.io import chains as jchains
from cosmomc_tpu.params.space import Param as JParam
from cosmomc_tpu.params.space import ParameterSpace as JSpace
from cosmomc_tpu.sampling import convergence as jconv
from cosmomc_tpu.sampling import proposal as jprop
from cosmomc_tpu.sampling.metropolis import MetropolisSampler as JSampler
from cosmomc_tpu.sampling.metropolis import \
    make_bounded_posterior as jbounded
from cosmomc_tpu.sampling.runner import RunConfig as JConfig
from cosmomc_tpu.sampling.runner import SamplingRun as JRun

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.io import chains as tchains
from cosmomc_tpu_torch.params.space import Param, ParameterSpace, Speed
from cosmomc_tpu_torch.sampling import convergence as tconv
from cosmomc_tpu_torch.sampling.metropolis import (LOG_ZERO, MetropolisSampler,
                                                   SegmentDraws,
                                                   make_bounded_posterior)
from cosmomc_tpu_torch.sampling.proposal import BlockedProposal
from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

F64 = torch.float64
N = 4
BLOCKS = [[0, 1], [2, 3]]
A = np.random.default_rng(3).standard_normal((N, N))
COV = A @ A.T + N * np.eye(N)
PREC = np.linalg.inv(COV)
LO, HI = -40.0, 40.0


# ---------------------------------------------------------------- helpers

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_target(P):
    """Correlated Gaussian, -logL; NaN (an error point) where P[0] > 12."""
    m = 0.5 * P @ jnp.asarray(PREC) @ P
    return jnp.where(P[0] > 12.0, jnp.nan, m), jnp.stack([P[0] + P[1]])


def torch_target(P):
    m = 0.5 * ((P @ torch.as_tensor(PREC, dtype=P.dtype)) * P).sum(-1)
    return (torch.where(P[:, 0] > 12.0, torch.nan, m),
            (P[:, 0] + P[:, 1])[:, None])


def spaces():
    js, ts = JSpace(), ParameterSpace()
    for i in range(N):
        args = (f"p{i}", 0.0, LO, HI, 1.0, 1.0, f"p_{i}")
        js.add(JParam(*args))
        ts.add(Param(*args))
    return js, ts


def samplers(seed=0, cov=None):
    jp = jprop.BlockedProposal(BLOCKS, slow_block_max=1, oversample_fast=2)
    tp = BlockedProposal(BLOCKS, slow_block_max=1, oversample_fast=2)
    for p in (jp, tp):
        p.set_covariance(np.diag(np.diag(COV)) * 0.3 if cov is None else cov)
    lo, hi = np.full(N, LO), np.full(N, HI)
    js = JSampler(jp, jbounded(jax_target, jnp.asarray(lo), jnp.asarray(hi)),
                  num_derived=1)
    ts = MetropolisSampler(tp, make_bounded_posterior(
        torch_target, torch.as_tensor(lo), torch.as_tensor(hi)),
        num_derived=1, seed=seed, device="cpu", dtype=F64)
    return js, ts


@partial(jax.jit, static_argnums=(2,))
def _step_draws(key, m2, nchains):
    """The per-step radius and acceptance draws of metropolis.py:143-150."""
    def body(key, m2t):
        key, k_prop, k_acc = jax.random.split(key, 3)
        return key, (jprop._propose_r_m(k_prop, nchains, m2t, jnp.float64),
                     jax.random.exponential(k_acc, (nchains,), jnp.float64))
    _, (r, u) = jax.lax.scan(body, key, m2)
    return r, u


def jax_draws(jsampler, state, sched):
    """The JAX segment's random numbers, recomputed from its key as
    metropolis.py:165-172 and proposal.py:314-324 draw them."""
    nchains = state.P.shape[0]
    key, k_rot = jax.random.split(state.key)
    deltas = jsampler.proposal.segment_deltas(k_rot, nchains, sched,
                                              state.mapping, state.P.dtype)
    r, u = _step_draws(key, jnp.asarray(
        jsampler.proposal.schedule_radius_dims(sched)), nchains)
    return SegmentDraws(*(torch.as_tensor(np.array(x), dtype=F64)
                          for x in (deltas, r, u)))


class Recording(JSampler):
    """The JAX sampler, keeping every segment's draws."""
    def run_segment(self, state, schedule):
        self.draws.append(jax_draws(self, state, schedule))
        return super().run_segment(state, schedule)


class Injected(MetropolisSampler):
    """The port's sampler, taking its draws from a list."""
    def draw_segment(self, schedule, nchains, mapping):
        return self.draws.pop(0)


def files_of(root):
    d, base = os.path.split(root)
    return sorted(f for f in os.listdir(d) if f.startswith(base))


# ---------------------------------------------------------------- convergence

def test_convergence_functions():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 300, 3)) @ np.linalg.cholesky(COV[:3, :3]).T
    x[:, :, 1] += 0.05 * np.arange(8)[:, None]
    w = rng.integers(1, 4, (8, 300)).astype(float)
    for weights in (None, w):
        tm, tc = tconv.chain_moments(x, weights)
        jm, jc = jconv.chain_moments(x, weights)
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tconv.gelman_rubin_evalues(tm, tc),
                                      jconv.gelman_rubin_evalues(jm, jc))
        assert tconv.gelman_rubin_r(tm, tc) == jconv.gelman_rubin_r(jm, jc)
    r_dev = tconv.gelman_rubin_r_device(torch.as_tensor(x))
    j_dev = float(jconv.gelman_rubin_r_device(jnp.asarray(x)))
    np.testing.assert_allclose(float(r_dev), j_dev, rtol=1e-10)
    m, c = tconv.chain_moments(x)
    np.testing.assert_allclose(float(r_dev), tconv.gelman_rubin_r(m, c),
                               rtol=1e-10)


# ---------------------------------------------------------------- chain files

def test_chain_writer_bytes_and_load(tmp_path):
    rng = np.random.default_rng(1)
    C, S = 5, 12
    roots = [str(tmp_path / "j" / "c"), str(tmp_path / "t" / "c")]
    writers = [jchains.ChainWriter(roots[0], C), tchains.ChainWriter(roots[1], C)]
    for seg in range(3):
        acc = rng.random((S, C)) < 0.4
        acc[:, 2] = False                   # a chain that never moves
        if seg == 0:
            acc[0, 3] = True
        P = rng.standard_normal((S, C, 3))
        mll = rng.random((S, C)) * 50
        der = rng.standard_normal((S, C, 2))
        for w in writers:
            w.add_segment(acc, P, mll, der)
    for w in writers:
        w.close()
    assert files_of(roots[0]) == files_of(roots[1]) and len(files_of(roots[1])) == C
    for f in files_of(roots[1]):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
    tl, jl = tchains.load_chains(roots[1]), jchains.load_chains(roots[0])
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k])
    assert tl["weights"].sum() == 3 * S * C
    one = tchains.load_chain(roots[1] + "_3.txt")
    assert len(one["weights"]) == 1 and one["weights"][0] == 3 * S


# ---------------------------------------------------------------- sampler

def test_bounded_posterior_sentinels():
    """Out of bounds -> exactly LOG_ZERO, an error point -> 2 LOG_ZERO, in
    the values' dtype, as the JAX package gives them."""
    lo, hi = np.full(N, LO), np.full(N, HI)
    P = np.array([[0.5, 0.0, 1.0, 0.0], [50.0, 0.0, 0.0, 0.0],
                  [13.0, 0.0, 0.0, 0.0]])
    post = make_bounded_posterior(torch_target, torch.as_tensor(lo),
                                  torch.as_tensor(hi))
    m, d = post(torch.as_tensor(P))
    jpost = jbounded(jax_target, jnp.asarray(lo), jnp.asarray(hi))
    jm = np.array([float(jpost(jnp.asarray(p))[0]) for p in P])
    assert m[1].item() == LOG_ZERO and m[2].item() == 2 * LOG_ZERO
    np.testing.assert_array_equal(m[1:].numpy(), jm[1:])
    np.testing.assert_allclose(m[0].item(), jm[0], rtol=1e-14)
    assert d[1:].abs().max() == 0.0


def test_metropolis_steps_match_jax():
    js, ts = samplers(cov=COV)
    P0 = np.random.default_rng(2).normal(0, 3, (6, N))
    P0[0, 0] = 11.5                         # near the error region
    jstate = js.init_state(jax.random.PRNGKey(4), jnp.asarray(P0))
    tstate = convert.chain_state(jstate)
    sched = js.proposal.make_schedule(24, np.random.default_rng(5))
    draws = jax_draws(js, jstate, sched)
    jfinal, jout = js.run_segment(jstate, sched)
    tfinal, tout = ts.run_segment(tstate, sched, draws=draws)
    np.testing.assert_array_equal(tout.accept.numpy(), np.asarray(jout.accept))
    np.testing.assert_array_equal(tout.error.numpy(), np.asarray(jout.error))
    assert 0 < tout.accept.float().mean() < 1
    for f in ("P", "mloglike", "derived"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=1e-12)
    np.testing.assert_array_equal(tfinal.num_accept.numpy(),
                                  np.asarray(jfinal.num_accept))
    # the port's own draws: a segment draws from the sampler's generator
    g0 = ts.generator.get_state()
    a, _ = ts.run_segment(tstate, sched)
    ts.generator.set_state(g0)
    b, _ = ts.run_segment(tstate, sched)
    assert torch.equal(a.P, b.P)


# ---------------------------------------------------------------- the run loop

def run_config(cls, **kw):
    base = dict(nchains=16, segment_steps=32, max_steps=32 * 14, r_stop=0.0,
                burn_accepts_per_block=3, stats_thin=2,
                checkpoint_freq_segments=4, seed=3)
    base.update(kw)
    return cls(**base)


def test_sampling_run_matches_jax(tmp_path):
    js_, ts_ = samplers()
    js = Recording(js_.proposal, js_.logpost_fn, num_derived=1)
    js.draws = []
    ts = Injected(ts_.proposal, ts_.logpost_fn, num_derived=1, device="cpu",
                  dtype=F64)
    jspace, tspace = spaces()
    P0 = np.random.default_rng(8).normal(0, 0.5, (16, N))
    jroot, troot = str(tmp_path / "j" / "run"), str(tmp_path / "t" / "run")
    jrun = JRun(js, run_config(JConfig), P0, chain_root=jroot, feedback=0,
                paramnames=jspace.param_names(), space=jspace,
                dtype=jnp.float64)
    trun = SamplingRun(ts, run_config(RunConfig), P0, chain_root=troot,
                       feedback=0, paramnames=tspace.param_names(),
                       space=tspace)
    r_seg = {}
    for name, run in (("jax", jrun), ("port", trun)):
        r_seg[name] = []
        upd = run._update_convergence_and_proposal
        run._update_convergence_and_proposal = \
            lambda upd=upd, rs=r_seg[name]: rs.append(upd()) or rs[-1]
    jres = jrun.run()
    ts.draws = list(js.draws)
    tres = trun.run()
    assert not ts.draws
    assert tres.burned_in_at == jres.burned_in_at > 0
    assert len(r_seg["port"]) == len(r_seg["jax"]) >= 8
    np.testing.assert_allclose(r_seg["port"], r_seg["jax"], rtol=1e-10)
    assert min(r_seg["port"]) < 2.0     # the proposal was learned
    assert not np.allclose(ts.proposal.covariance, np.diag(np.diag(COV)) * 0.3)
    np.testing.assert_allclose(ts.proposal.covariance, js.proposal.covariance,
                               rtol=1e-12)
    assert (tres.steps, tres.stopped_on) == (jres.steps, jres.stopped_on)
    assert tres.accept_rate == jres.accept_rate
    np.testing.assert_allclose(tres.r_minus_1, jres.r_minus_1, rtol=1e-10)
    np.testing.assert_allclose(tres.means, jres.means, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tres.cov, jres.cov, rtol=1e-12)
    np.testing.assert_array_equal(trun.class_steps, jrun.class_steps)
    names = [f for f in files_of(troot) if not f.endswith(".chk.npz")]
    assert names == [f for f in files_of(jroot) if not f.endswith(".chk.npz")]
    assert {"run.paramnames", "run.ranges", "run.log", "run.converge_stat",
            "run_1.txt", "run_16.txt"} <= set(names)
    for f in names:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f


def _resume_and_continue(make_sampler, cfg, P0, root):
    """Run to the end (checkpointing), resume a second run with a fresh
    sampler on the same root, and check the restored state and one more
    segment bit for bit. Returns both runs."""
    s1 = make_sampler(seed=11)
    run1 = SamplingRun(s1, cfg, P0, chain_root=root, feedback=0)
    run1.run()
    s2 = make_sampler(seed=12)
    run2 = SamplingRun(s2, cfg, P0, chain_root=root, feedback=0)
    assert run2.resume()
    a, b = run1.state, run2.state
    for f in ("P", "mloglike", "derived", "num_accept", "mapping"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (run2.steps_done, run2.burned_in_at) == \
        (run1.steps_done, run1.burned_in_at)
    np.testing.assert_array_equal(s2.proposal.covariance, s1.proposal.covariance)
    assert torch.equal(s2.generator.get_state(), s1.generator.get_state())
    sched = s1.proposal.make_schedule(cfg.segment_steps,
                                      np.random.default_rng(21))
    n1, o1 = s1.run_segment(a, sched)
    n2, o2 = s2.run_segment(b, sched)
    assert torch.equal(o1.accept, o2.accept) and torch.equal(o1.P, o2.P)
    assert torch.equal(n1.mloglike, n2.mloglike)
    return run1, run2


def test_checkpoint_resume_bit_for_bit(tmp_path):
    cfg = run_config(RunConfig, max_steps=32 * 5, checkpoint_freq_segments=2)
    P0 = np.random.default_rng(9).normal(0, 0.5, (16, N))

    def make(seed):
        return samplers(seed=seed)[1]
    run1, _ = _resume_and_continue(make, cfg, P0, str(tmp_path / "c" / "t"))
    assert run1.burned_in_at > 0
    z = np.load(str(tmp_path / "c" / "t.chk.npz"))
    assert z["generator"].dtype == np.uint8 and int(z["steps_done"]) == 160


class Nest(NamedTuple):
    e: torch.Tensor
    sq: torch.Tensor
    x0: torch.Tensor


class ToyStaged:
    """A correlated Gaussian split into the staged posterior's stages:
    stage_slow holds the slow parameters (a dict with a nested NamedTuple),
    stage_semi adds the semi-slow one, stage_fast the fast one."""
    num_derived = 1
    device = torch.device("cpu")
    dtype = F64

    def __init__(self):
        self.space = ParameterSpace()
        for i, sp in enumerate((Speed.SLOW, Speed.SLOW, Speed.SEMISLOW,
                                Speed.FAST)):
            self.space.add(Param(f"p{i}", 0.0, LO, HI, 1.0, 1.0, speed=sp))

    def embed_full(self, P):
        return P.clone()

    def stage_slow(self, full):
        return dict(a=full[:, :2] * 2.0,
                    nest=Nest(torch.exp(0.01 * full[:, :1]), full[:, 1] ** 2,
                              full[:, 0]))

    def stage_semi(self, full, slow):
        return dict(c=slow["a"].sum(-1) + full[:, 2])

    def stage_fast(self, P, slow, semi):
        x = torch.cat([slow["a"] / 2.0,
                       (semi["c"] - slow["a"].sum(-1))[:, None], P[:, 3:]], -1)
        m = 0.5 * ((x @ torch.as_tensor(PREC)) * x).sum(-1)
        return m, (semi["c"] + slow["nest"].sq)[:, None]


def test_staged_state_from_arrays_and_resume(tmp_path):
    post = ToyStaged()
    cfg = run_config(RunConfig, nchains=8, max_steps=32 * 4,
                     checkpoint_freq_segments=2)
    P0 = np.random.default_rng(10).normal(0, 0.5, (8, N))

    def make(seed):
        prop = BlockedProposal(post.space.speed_blocks(), slow_block_max=2)
        prop.set_covariance(np.diag(np.diag(COV)) * 0.3)
        return StagedMetropolisSampler(prop, post, seed=seed)
    run1, run2 = _resume_and_continue(make, cfg, P0, str(tmp_path / "s" / "t"))
    assert run1.class_steps[0] > 0 and run1.class_steps[2] > 0
    a, b = run1.state, run2.state
    assert torch.equal(a.slow["a"], b.slow["a"])
    for f in a.slow["nest"]._fields:
        assert torch.equal(getattr(a.slow["nest"], f), getattr(b.slow["nest"], f))
    assert torch.equal(a.semi["c"], b.semi["c"])
    # the carried state is the posterior at its points
    m, d = post.stage_fast(a.P, a.slow, a.semi)
    assert torch.equal(m, a.mloglike) and torch.equal(d, a.derived)


# ---------------------------------------------------------------- run control

def simple_sampler(raw, n=2, width=1.0, lo=-50.0, hi=50.0):
    space = ParameterSpace()
    for i in range(n):
        space.add(Param(f"p{i}", 0.0, lo, hi, width, width, speed=Speed.SLOW))
    arr = space.device_arrays("cpu", F64)
    prop = BlockedProposal(space.speed_blocks(), slow_block_max=1)
    prop.set_covariance(np.eye(n))
    return MetropolisSampler(prop, make_bounded_posterior(
        raw, arr["lo"], arr["hi"]), device="cpu", dtype=F64)


def gauss(P):
    return 0.5 * (P * P).sum(-1), P[:, :0]


def test_runtime_control_exit(tmp_path):
    root = str(tmp_path / "c" / "t")
    os.makedirs(os.path.dirname(root))
    with open(root + ".read", "w") as f:
        f.write("feedback = 0\nexit = T\n")
    cfg = RunConfig(nchains=8, segment_steps=32, max_steps=100_000,
                    r_stop=1e-12, seed=5)
    res = SamplingRun(simple_sampler(gauss), cfg, np.zeros((8, 2)),
                      chain_root=root, feedback=0).run()
    assert res.stopped_on == "exit_requested"
    assert res.steps == 32


def test_limits_convergence_gate():
    cfg = RunConfig(nchains=64, segment_steps=64, max_steps=6000,
                    r_stop=0.05, burn_accepts_per_block=20, stats_thin=1,
                    seed=5, limits_tol=0.5, limit_frac=0.025)
    start = np.random.default_rng(0).normal(0, 1, (64, 2))
    run = SamplingRun(simple_sampler(gauss, lo=-30, hi=30), cfg, start,
                      feedback=0)
    res = run.run()
    assert res.stopped_on == "converged"
    assert run.limits_spread is not None and run.limits_spread < 0.5


def test_error_point_policy(tmp_path):
    def raw(P):
        m = 0.5 * (P * P).sum(-1)
        return torch.where(P[:, 0] > 0.5, torch.nan, m), P[:, :0]
    sampler = simple_sampler(raw, width=0.5, lo=-5, hi=5)
    start = np.random.default_rng(0).normal(0, 0.3, (32, 2))
    cfg = RunConfig(nchains=32, segment_steps=32, max_steps=128,
                    r_stop=1e-9, burn_accepts_per_block=1, seed=2)
    run = SamplingRun(sampler, cfg, start, chain_root=str(tmp_path / "err"),
                      feedback=0)
    run.run()
    assert run.num_error_points > 0
    assert "ERROR POINTS" in (tmp_path / "err.log").read_text()
    cfg2 = RunConfig(nchains=32, segment_steps=32, max_steps=128,
                     r_stop=1e-9, burn_accepts_per_block=1, seed=2,
                     stop_on_error=True)
    with pytest.raises(RuntimeError, match="stop_on_error"):
        SamplingRun(sampler, cfg2, start, feedback=0).run()


def test_several_devices_not_ported():
    with pytest.raises(NotImplementedError, match="step 19"):
        SamplingRun(simple_sampler(gauss), RunConfig(nchains=8, num_devices=2),
                    np.zeros((8, 2)))


def test_sampler_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prop = BlockedProposal([[0, 1]])
    prop.set_covariance(np.eye(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MetropolisSampler(prop, gauss)
