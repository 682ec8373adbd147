"""Port parity of K4's gradient (the plain path, CPU, float64):
compute_thermo's vector-Jacobian product and that of the thermal derived
scalars built on it (z*, r*, z_drag, r_drag), against jax.vjp of the JAX
package's compute_thermo + thermo_derived.

Both differentiate the unrolled Crank-Nicolson map, its two Newton
iterations and the derivatives of their Newton derivatives included, and
the clips at their saturated values (jnp.clip's half gradient at a tie,
`recfast._clip`). Three chains at a reduced grid of 1500 z nodes, the same
seeded cotangents in both packages; the JAX reference is one vmapped vjp.
Tolerance 1e-9 of the largest component of each chain's gradient (they
agree to ~3e-15).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import recfast as jrec
from cosmomc_tpu.models import thermo as jthermo

from cosmomc_tpu_torch.models import background as tbg
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models import thermo as tthermo

F64 = torch.float64
RTOL = 1e-9
N_Z = 1500
_RNG = np.random.default_rng(14)
#: (ombh2, omch2, H0, yhe) of each chain
P = np.stack([_RNG.uniform(0.020, 0.025, 3), _RNG.uniform(0.10, 0.14, 3),
              _RNG.uniform(62.0, 74.0, 3), _RNG.uniform(0.240, 0.250, 3)], 1)
G_XE = _RNG.standard_normal((3, N_Z))
G_TM = 1e-3 * _RNG.standard_normal((3, N_Z))
G_DER = _RNG.standard_normal((3, 4))          # z*, r*, z_drag, r_drag


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_fn(p):
    bg = jbg.BackgroundParams.make(ombh2=p[0], omch2=p[1], H0=p[2],
                                   dtype=jnp.float64)
    th = jrec.compute_thermo(bg, p[3], n_z=N_Z)
    d = jthermo.thermo_derived(bg, jthermo.compute_thermo_tables(bg, th, p[3]))
    return th.xe, th.tm, jnp.stack([d.z_star, d.r_star, d.z_drag, d.r_drag])


@pytest.fixture(scope="module")
def jax_ref():
    def vjp(p, gxe, gtm, gder):
        out, f = jax.vjp(_jax_fn, p)
        return out, f((gxe, gtm, gder))[0]
    out, grad = jax.jit(jax.vmap(vjp))(*(jnp.asarray(a) for a in
                                          (P, G_XE, G_TM, G_DER)))
    return [np.asarray(o) for o in out], np.asarray(grad)


@pytest.fixture(scope="module")
def port():
    p = torch.tensor(P, dtype=F64, requires_grad=True)
    bg = tbg.BackgroundParams.make(ombh2=p[:, 0], omch2=p[:, 1], H0=p[:, 2],
                                   nchains=3, dtype=F64)
    th = trec.compute_thermo(bg, p[:, 3], n_z=N_Z)
    d = tthermo.thermo_derived(bg, tthermo.compute_thermo_tables(bg, th,
                                                                 p[:, 3]))
    der = torch.stack([d.z_star, d.r_star, d.z_drag, d.r_drag], -1)
    loss = ((th.xe * torch.as_tensor(G_XE)).sum()
            + (th.tm * torch.as_tensor(G_TM)).sum()
            + (der * torch.as_tensor(G_DER)).sum())
    (grad,) = torch.autograd.grad(loss, p)
    return [th.xe.detach().numpy(), th.tm.detach().numpy(),
            der.detach().numpy()], grad.numpy()


def test_values_match(jax_ref, port):
    for t, j in zip(port[0], jax_ref[0]):
        np.testing.assert_allclose(t, j, rtol=1e-9, atol=0.0)


@pytest.mark.parametrize("chain", range(3))
def test_thermo_vjp_matches(jax_ref, port, chain):
    ref, got = jax_ref[1][chain], port[1][chain]
    assert np.all(np.isfinite(got))
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= RTOL, (err, got, ref)


def test_no_graph_without_gradients():
    """Without an input that wants a gradient the scan records nothing."""
    bg = tbg.BackgroundParams.make(nchains=1, dtype=F64)
    th = trec.compute_thermo(bg, torch.tensor([0.245], dtype=F64), n_z=200)
    assert th.xe.grad_fn is None and th.tm.grad_fn is None


def test_clip_splits_the_gradient_at_a_tie():
    """`_clip` is jnp.clip's min(max(x, lo), hi): torch.clamp's values, and
    half the gradient at x = hi, as jax.grad gives it."""
    x = torch.tensor([-0.5, 0.0, 0.3, 1.0, 1.5], dtype=F64, requires_grad=True)
    y = trec._clip(x, 0.0, 1.0)
    assert torch.equal(y, x.clamp(0.0, 1.0))
    (g,) = torch.autograd.grad(y.sum(), x)
    jg = jax.grad(lambda v: jnp.clip(v, 0.0, 1.0).sum())(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g[3].item() == 0.5
