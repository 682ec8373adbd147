"""Port parity of the tensor modes' gradients (K5's and K6's plain
versions under autograd, the CPU's path), float64 on the CPU.

(a) The vector-Jacobian product of `evolve_tensors` (the stage table, RK4
    over the 45-variable hierarchy with tight coupling, the freeze at
    k tau = 240 and the release at k tau = 0.05, the sources) against
    jax.vjp of the JAX package's `evolve_tensors`, with respect to the
    background parameters (ombh2, omch2, H0), every ThermoFuncs array and
    tau0, on seeded cotangents of sT, sP, ht and tau0; on
    tests/test_torch_tensors.py's JAX thermal tables (kmax 1.0, 2048
    steps) and 12 tensor k, the port's graph checkpointed in 16 chunks.
(b) The vjp of `compute_tensor_transfers` (lmax 300) against jax.vjp of
    JAX's with respect to sT, sP, the tau grid and tau0, on (a)'s JAX
    sources and a seeded cotangent of Delta_T, Delta_E, Delta_B. The last
    node's chi = tau0 - tau is a few ulps (here -3.6e-12: |x| < 1e-8, where
    max(x, 1e-8) passes no gradient and the table interpolant's slope
    does), the same in both packages since both read the same tau and
    tau0.

Each to 1e-9 of the largest magnitude of each gradient array.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import perturbations as jpert
from cosmomc_tpu.models import tensors as jten

from cosmomc_tpu_torch.models import background as tbg
from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import tensors as tten

F64 = torch.float64
RTOL = 1e-9
YHE = 0.2454
K = jten.tensor_k_grid(nk=12)
PARAMS = np.array([0.02237, 0.1200, 67.36])   # ombh2, omch2, H0
LMAX = 300
REMAT = 16
PLANES = ("sT", "sP", "ht")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bg_jax(p):
    return jbg.BackgroundParams.make(ombh2=p[0], omch2=p[1], H0=p[2],
                                     dtype=jnp.float64)


def rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.all(np.isfinite(got))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def thermo():
    """JAX's tables at PARAMS (test_torch_tensors.py's grid) and the
    seeded cotangents of the evolution's outputs."""
    tf, tau0 = jpert.build_thermo_funcs(_bg_jax(PARAMS), YHE, 0.0544, kmax=1.0,
                                        n_step=2048)
    tf = [np.asarray(x) for x in tf]
    N = tf[0].shape[0]
    rng = np.random.default_rng(18)
    cot = {p: rng.standard_normal((len(K), N)) for p in PLANES}
    cot["tau0"] = float(rng.standard_normal())
    return tf, float(tau0), cot


@pytest.fixture(scope="module")
def evolve_jax(thermo):
    tf, tau0, cot = thermo

    def f(p, tfa, t0):
        to = jten.evolve_tensors(_bg_jax(p), jpert.ThermoFuncs(*tfa), t0,
                                 jnp.asarray(K))
        return [to.sT, to.sP, to.ht, to.tau0]
    out, vjp = jax.vjp(f, jnp.asarray(PARAMS), tuple(jnp.asarray(t) for t in tf),
                       jnp.asarray(tau0))
    gp, gtf, gt0 = vjp([jnp.asarray(cot[p]) for p in PLANES]
                       + [jnp.asarray(cot["tau0"])])
    return ([np.asarray(o) for o in out],
            [np.asarray(gp)] + [np.asarray(g) for g in gtf] + [np.asarray(gt0)])


@pytest.fixture(scope="module")
def evolve_port(thermo):
    tf, tau0, cot = thermo
    p = torch.tensor(PARAMS[None], dtype=F64, requires_grad=True)
    bg = tbg.BackgroundParams.make(ombh2=p[:, 0], omch2=p[:, 1], H0=p[:, 2],
                                   nchains=1, dtype=F64)
    tfa = [torch.tensor(t[None], dtype=F64, requires_grad=True) for t in tf]
    t0 = torch.tensor([tau0], dtype=F64, requires_grad=True)
    to = tten.evolve_tensors(bg, tpert.ThermoFuncs(*tfa), t0, K,
                             remat_chunks=REMAT)
    loss = sum((getattr(to, n)[0] * torch.as_tensor(cot[n])).sum() for n in PLANES)
    loss = loss + (to.tau0 * cot["tau0"]).sum()
    xs = [p] + tfa + [t0]
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)]
    return ([getattr(to, n)[0].detach().numpy() for n in PLANES],
            [g[0].numpy() for g in grads])


def test_evolve_outputs_equal(evolve_jax, evolve_port):
    for n, j, t in zip(PLANES, evolve_jax[0], evolve_port[0]):
        assert rel_err(t, j) <= RTOL, n


@pytest.mark.parametrize("what", ["params"] + list(tpert.ThermoFuncs._fields)
                         + ["tau0"])
def test_evolve_vjp_matches_jax(evolve_jax, evolve_port, what):
    i = (["params"] + list(tpert.ThermoFuncs._fields) + ["tau0"]).index(what)
    ref, got = evolve_jax[1][i], evolve_port[1][i]
    if what == "csqb":    # the tensor RHS does not read the baryon sound speed
        assert np.abs(ref).max() == 0.0 and np.abs(got).max() == 0.0
        return
    assert rel_err(got, ref) <= RTOL, what


@pytest.fixture(scope="module")
def transfers(thermo, evolve_jax):
    """(b): the JAX sources of (a) through both packages' LOS, with the
    same seeded cotangent of the three planes."""
    tf, tau0, _ = thermo
    sT, sP = evolve_jax[0][0], evolve_jax[0][1]
    tau = tf[0]

    def f(sT, sP, tau, t0):
        to = jten.TensorOutput(tau=tau, k=jnp.asarray(K), sT=sT, sP=sP, tau0=t0)
        c = jten.compute_tensor_transfers(to, lmax=LMAX)
        return [c.dT, c.dE, c.dB]
    out, vjp = jax.vjp(f, jnp.asarray(sT), jnp.asarray(sP), jnp.asarray(tau),
                       jnp.asarray(tau0))
    rng = np.random.default_rng(19)
    cot = [rng.standard_normal(o.shape) for o in out]
    jg = [np.asarray(g) for g in vjp([jnp.asarray(c) for c in cot])]
    xs = [torch.tensor(a[None], dtype=F64, requires_grad=True)
          for a in (sT, sP, tau)] + [torch.tensor([tau0], dtype=F64,
                                                  requires_grad=True)]
    to = tten.TensorOutput(tau=xs[2], k=torch.as_tensor(K, dtype=F64), sT=xs[0],
                           sP=xs[1], tau0=xs[3])
    c = tten.compute_tensor_transfers(to, lmax=LMAX, coarse_k=K)
    port = [c.dT[0], c.dE[0], c.dB[0]]
    tg = torch.autograd.grad(sum((o * torch.as_tensor(g)).sum()
                                 for o, g in zip(port, cot)), xs)
    return ([np.asarray(o) for o in out], [o.detach().numpy() for o in port],
            jg, [g.reshape(np.shape(j)).numpy() for g, j in zip(tg, jg)])


def test_transfers_equal(transfers):
    jout, tout = transfers[:2]
    for n, j, t in zip(("dT", "dE", "dB"), jout, tout):
        assert rel_err(t, j) <= RTOL, n


@pytest.mark.parametrize("what", ["sT", "sP", "tau", "tau0"])
def test_transfers_vjp_matches_jax(transfers, thermo, what):
    i = ("sT", "sP", "tau", "tau0").index(what)
    ref, got = transfers[2][i], transfers[3][i]
    assert np.asarray(ref).shape == np.asarray(got).shape, what
    assert rel_err(got, ref) <= RTOL, what
    if what == "tau":
        tf, tau0, _ = thermo
        # the last node sits within a few ulps of tau0: |x| < 1e-8 there
        assert abs(tau0 - tf[0][-1]) < 1e-8
