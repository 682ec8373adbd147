"""Port parity of K1's gradient (the plain path, CPU, float64): the
vector-Jacobian product of evolve_perturbations, whole (the stage table,
the ICs and their release, RK4 with the TCA/RSA switches, the sources, the
curvature normalisation, the snapshots at z_outputs), with respect to the
thermal tables on the tau grid and the background parameters, against
jax.vjp of the JAX package's evolve_perturbations.

Two cosmologies on their own JAX tables (build_thermo_funcs, 256 steps,
kmax 0.1), 8 k to 0.02/Mpc (the lanes above ~0.025 diverge on so coarse a
grid), the radiation-streaming switch at k tau = 40 so that it acts on
these lanes (14% of the stage rows), z_outputs (0, 0.6), the same seeded
cotangents on every output in both packages; unchunked and with 4 remat
chunks in both (JAX pads the steps with dt = 0 no-ops, the port checkpoints by
torch.utils.checkpoint; neither changes a number). Tolerance 1e-9 of the
largest component of each gradient array (they agree to ~1e-14).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import perturbations as jpert

from cosmomc_tpu_torch.models import background as tbg
from cosmomc_tpu_torch.models import perturbations as tpert

F64 = torch.float64
RTOL = 1e-9
N_STEP = 256
K = np.geomspace(5e-4, 0.02, 8)
KMAX_GRID = 0.1
RSA = 40.0
Z_OUT = (0.0, 0.6)
COSMO = [dict(ombh2=0.02237, omch2=0.1201, H0=67.3, tau=0.0543, yhe=0.2454),
         dict(ombh2=0.0210, omch2=0.1290, H0=64.1, tau=0.071, yhe=0.2441)]
FIELDS = ("s0", "s1", "s2", "slens", "delta_m", "r_init", "delta_m_z",
          "ddelta_m_z", "weyl_z", "aH_z")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    return np.array([[c["ombh2"], c["omch2"], c["H0"]] for c in COSMO])


@pytest.fixture(scope="module")
def tables():
    """The JAX tau grid and thermal tables of each cosmology (inputs to both
    packages' evolution, differentiated as such), and the cotangents."""
    tfs, tau0 = [], []
    for c in COSMO:
        bg = jbg.BackgroundParams.make(ombh2=c["ombh2"], omch2=c["omch2"],
                                       H0=c["H0"], dtype=jnp.float64)
        tf, t0 = jpert.build_thermo_funcs(bg, c["yhe"], c["tau"],
                                          n_step=N_STEP, kmax=KMAX_GRID)
        tfs.append([np.asarray(x) for x in tf])
        tau0.append(float(t0))
    tf = [np.stack([t[i] for t in tfs]) for i in range(len(tfs[0]))]
    rng = np.random.default_rng(1414)
    nk, nz = len(K), len(Z_OUT)
    shapes = dict(s0=(nk, N_STEP), s1=(nk, N_STEP), s2=(nk, N_STEP),
                  slens=(nk, N_STEP), delta_m=(nk,), r_init=(nk,),
                  delta_m_z=(nz, nk), ddelta_m_z=(nz, nk), weyl_z=(nz, nk),
                  aH_z=(nz,))
    cot = {f: rng.standard_normal((2,) + shapes[f]) for f in FIELDS}
    return tf, np.array(tau0), cot


def _jax_vjp(tf, tau0, cot, chunks):
    def one(p, tfa, t0, ct):
        def f(p, tfa):
            bg = jbg.BackgroundParams.make(ombh2=p[0], omch2=p[1], H0=p[2],
                                           dtype=jnp.float64)
            po = jpert.evolve_perturbations(
                bg, jpert.ThermoFuncs(*tfa), t0, jnp.asarray(K), Z_OUT,
                rsa_ktau=RSA, remat_chunks=chunks)
            return [getattr(po, n) for n in FIELDS]
        out, vjp = jax.vjp(f, p, tfa)
        return out, vjp(ct)
    out, (gp, gtf) = jax.jit(jax.vmap(one))(
        jnp.asarray(_params()), tuple(jnp.asarray(t) for t in tf),
        jnp.asarray(tau0), [jnp.asarray(cot[f]) for f in FIELDS])
    return ([np.asarray(o) for o in out],
            [np.asarray(gp)] + [np.asarray(g) for g in gtf])


def _port_vjp(tf, tau0, cot, chunks):
    p = torch.tensor(_params(), dtype=F64, requires_grad=True)
    bg = tbg.BackgroundParams.make(ombh2=p[:, 0], omch2=p[:, 1], H0=p[:, 2],
                                   nchains=2, dtype=F64)
    tfa = [torch.tensor(t, dtype=F64, requires_grad=True) for t in tf]
    po = tpert.evolve_perturbations(bg, tpert.ThermoFuncs(*tfa),
                                    torch.tensor(tau0, dtype=F64),
                                    torch.as_tensor(K, dtype=F64), Z_OUT,
                                    rsa_ktau=RSA, remat_chunks=chunks)
    loss = sum((getattr(po, f) * torch.as_tensor(cot[f])).sum()
               for f in FIELDS)
    grads = torch.autograd.grad(loss, [p] + tfa)
    return ([getattr(po, f).detach().numpy() for f in FIELDS],
            [g.numpy() for g in grads])


@pytest.fixture(scope="module")
def port(tables):
    return {c: _port_vjp(*tables, c) for c in (0, 4)}


@pytest.fixture(scope="module", params=[0, 4], ids=["unchunked", "chunks4"])
def both(request, tables, port):
    return _jax_vjp(*tables, request.param), port[request.param]


def test_outputs_moderate_and_equal(both):
    (jout, _), (tout, _) = both
    for f, j, t in zip(FIELDS, jout, tout):
        assert np.all(np.isfinite(t)) and np.abs(t).max() < 1e5, f
        np.testing.assert_allclose(t, j, rtol=1e-9, atol=1e-9 * np.abs(j).max(),
                                   err_msg=f)


@pytest.mark.parametrize("what", ["params"] + list(tpert.ThermoFuncs._fields))
def test_evolve_vjp_matches(both, what):
    (_, jg), (_, tg) = both
    i = (["params"] + list(tpert.ThermoFuncs._fields)).index(what)
    for c in range(2):
        ref, got = jg[i][c], tg[i][c]
        assert np.all(np.isfinite(got))
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= RTOL, (what, c, err)


def test_chunks_change_no_number(port):
    """The port's checkpointed gradient equals the unchunked one bit for
    bit (the same operations, recomputed)."""
    for a, b in zip(port[0][1], port[4][1]):
        np.testing.assert_array_equal(a, b)
