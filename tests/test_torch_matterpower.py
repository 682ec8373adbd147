"""Port parity of models/matterpower.py (the matter power, sigma8(z) and
f sigma8(z) on the wide k grid).

Two chains from seeded numpy inputs, float64 on the CPU. The JAX side is
vmapped over the chains; the port is batched over them. The matter k grid
is reduced to 36 k reaching kmax = 2/Mpc (`matter_k_grid(kmax=2, 8, 16,
12)`) with 2048 Boltzmann steps: with fewer the RK4 of both packages
diverges on this grid (1024 steps: k ~ 0.1-0.3/Mpc reach ~1e20; 1536
steps: k >= 0.66/Mpc reach ~1e27), at 2048 and 3072 every lane stays
below 7e4 (6.70e4 and 6.69e4 at their largest). The full grid (216 k to 8/Mpc, 6144
steps) is what chip_smoke.py runs on the card.

  - transfers: the port's whole slow path (its own recombination history
    and z_re) against JAX's `compute_matter_transfers`;
  - power: the JAX transfers carried into the port by convert, then
    lnP, lnP_nl, lnP_weyl, sigma8(z), f sigma8(z);
  - `power_at` inside the table, past kmax (log-linear), outside the z
    range, nonlinear and Weyl, and on a single-z table; `sigma_r`.

Every comparison holds 1e-9 of the compared array's maximum, as
test_torch_perturbations.py does.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import matterpower as jmp
from cosmomc_tpu.models.background import BackgroundParams as JBG
from cosmomc_tpu.models.primordial import PrimordialParams as JPP

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import matterpower as tmp
from cosmomc_tpu_torch.models.primordial import PrimordialParams as TPP
from cosmomc_tpu_torch.models.recfast import compute_thermo
from cosmomc_tpu_torch.models.reionization import zre_from_tau

F64 = torch.float64
RTOL = 1e-9
K = tmp.matter_k_grid(kmax=2.0, nk_log_lo=8, nk_lin=16, nk_log_hi=12)
N_STEP = 2048
ZS = (0.0, 0.38, 0.61, 1.0, 2.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"rel err {err:.3e} > {rtol:.1e}"


@pytest.fixture(scope="module")
def inputs():
    """(ombh2, omch2, H0, tau, yhe, logA, ns) per chain: Planck 2018 and a
    seeded neighbour."""
    rng = np.random.default_rng(20261017)
    p0 = np.array([0.0223774, 0.1201035, 67.32178, 0.0543014, 0.2454,
                   3.0447, 0.96589])
    scale = np.array([0.0003, 0.003, 1.5, 0.006, 0.002, 0.03, 0.01])
    return np.vstack([p0, p0 + scale * rng.standard_normal(7)])


def _jbg(p):
    return JBG.make(ombh2=p[0], omch2=p[1], H0=p[2], omnuh2=0.06 / 93.14)


@pytest.fixture(scope="module")
def jax_side(inputs):
    def one(p):
        mt = jmp.compute_matter_transfers(_jbg(p), p[3], p[4], ZS, k=K,
                                          n_step=N_STEP)
        pp = JPP.make(logA=p[5], ns=p[6])
        return mt, jmp.matter_power_from_transfers(_jbg(p), pp, mt)
    return jax.jit(jax.vmap(one))(jnp.asarray(inputs))


@pytest.fixture(scope="module")
def port_bg(inputs):
    return convert.background_params(jax.vmap(_jbg)(jnp.asarray(inputs)))


def _chain(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def test_matter_k_grid_matches():
    np.testing.assert_array_equal(tmp.matter_k_grid(), jmp.matter_k_grid())
    np.testing.assert_array_equal(K, jmp.matter_k_grid(2.0, nk_log_lo=8,
                                                       nk_lin=16, nk_log_hi=12))
    assert len(tmp.matter_k_grid()) == 216
    assert tmp.matter_k_grid()[-1] == pytest.approx(8.0, rel=1e-15)
    assert tmp.EXTRAP_KMAX == jmp.EXTRAP_KMAX


@pytest.fixture(scope="module")
def port_thermo(inputs, port_bg):
    """The port's own recombination history, z_re and YHe per chain."""
    yhe = torch.as_tensor(inputs[:, 4], dtype=F64)
    return (compute_thermo(port_bg, yhe),
            zre_from_tau(port_bg, torch.as_tensor(inputs[:, 3], dtype=F64),
                         yhe), yhe)


@pytest.fixture(scope="module")
def port_transfers(port_bg, port_thermo):
    return tmp.compute_matter_transfers(port_bg, *port_thermo, ZS, k=K,
                                        n_step=N_STEP)


@pytest.mark.parametrize("field", ["delta_m_z", "weyl_z", "v_z"])
def test_compute_matter_transfers(jax_side, port_transfers, field):
    jmt, _ = jax_side
    got = getattr(port_transfers, field)
    assert got.shape == (2, len(ZS), len(K))
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) < 1e6
    assert_close(got, getattr(jmt, field))
    assert_close(port_transfers.k, K, 0.0)
    assert_close(port_transfers.z, ZS, 0.0)
    assert_close(port_transfers.h, np.asarray(jmt.h))


@pytest.fixture(scope="module")
def port_power(inputs, jax_side, port_bg):
    jmt, _ = jax_side
    pp = TPP.make(logA=torch.as_tensor(inputs[:, 5], dtype=F64),
                  ns=torch.as_tensor(inputs[:, 6], dtype=F64))
    return tmp.matter_power_from_transfers(port_bg, pp,
                                           convert.matter_transfers(jmt))


@pytest.mark.parametrize("field", ["lnP", "lnP_nl", "lnP_weyl", "sigma8_z",
                                   "fsigma8_z"])
def test_matter_power_from_transfers(jax_side, port_power, field):
    _, jmpow = jax_side
    assert_close(getattr(port_power, field), getattr(jmpow, field))


def test_sigma8_is_physical(port_power, inputs, port_bg, port_thermo):
    """At Planck 2018 (chain 0) sigma8(0) is near CAMB's 0.8120 on the
    reduced grid too, and f sigma8 is near its 0.47-0.48 at z 0.38-0.61;
    `compute_matter_power` (the port's whole path from its own thermal
    history) gives the same tables as JAX's carried transfers."""
    s8 = port_power.sigma8_z[0, 0].item()
    assert 0.6 < s8 < 1.0, s8
    assert 0.4 < port_power.fsigma8_z[0, 1].item() < 0.55
    pp = TPP.make(logA=torch.as_tensor(inputs[:, 5], dtype=F64),
                  ns=torch.as_tensor(inputs[:, 6], dtype=F64))
    own = tmp.compute_matter_power(port_bg, pp, *port_thermo, ZS, k=K,
                                   n_step=N_STEP)
    for f in ("lnP", "lnP_nl", "sigma8_z", "fsigma8_z"):
        assert_close(getattr(own, f), getattr(port_power, f))


QUERIES = {
    "inside": (np.exp(np.linspace(np.log(2e-4), np.log(1.9), 9)),
               np.array([0.0, 0.1, 0.38, 0.45, 0.61, 0.9, 1.0, 1.7, 2.0])),
    "past_kmax": (np.array([2.5, 8.0, 40.0, 700.0]),
                  np.array([0.0, 0.5, 1.3, 2.0])),
    "outside_z": (np.array([0.05, 0.2, 1.0]), np.array([-0.1, 2.5, 9.0])),
}


@pytest.mark.parametrize("which", list(QUERIES))
@pytest.mark.parametrize("kind", ["linear", "nonlinear", "weyl"])
def test_power_at(jax_side, which, kind):
    _, jmpow = jax_side
    kq, zq = QUERIES[which]
    kw = dict(nonlinear=kind == "nonlinear", weyl=kind == "weyl")
    got = tmp.power_at(convert.matter_power(jmpow), torch.as_tensor(kq),
                       torch.as_tensor(zq), **kw)
    ref = np.stack([np.asarray(jmp.power_at(_chain(jmpow, i), kq, zq, **kw))
                    for i in range(2)])
    assert_close(got, ref)


def test_power_at_single_z_and_per_chain_queries(jax_side):
    """A one-redshift table (z ignored, JAX's single-z branch), and (C, n)
    queries that differ per chain."""
    jmt, _ = jax_side
    one = jmt._replace(z=jmt.z[:, 1:2], delta_m_z=jmt.delta_m_z[:, 1:2],
                       weyl_z=jmt.weyl_z[:, 1:2], v_z=jmt.v_z[:, 1:2])
    jone = jax.vmap(lambda t, b: jmp.matter_power_from_transfers(
        b, JPP.make(logA=3.05, ns=0.965), t))(
        one, jax.vmap(lambda h: JBG.make(H0=100.0 * h))(jmt.h))
    kq = np.array([[1e-3, 0.1, 1.0, 5.0], [2e-3, 0.2, 1.5, 30.0]])
    zq = np.full(4, 0.7)       # JAX's single-z branch takes zq like kq
    got = tmp.power_at(convert.matter_power(jone), torch.as_tensor(kq), 0.7)
    ref = np.stack([np.asarray(jmp.power_at(_chain(jone, i), kq[i], zq))
                    for i in range(2)])
    assert got.shape == (2, 4)
    assert_close(got, ref)


def test_sigma_r(jax_side):
    _, jmpow = jax_side
    mp = convert.matter_power(jmpow)
    for R, zi in ((8.0, 0), (3.0, 2), (25.0, 4)):
        ref = [float(jmp.sigma_r(_chain(jmpow, i), R, z_index=zi))
               for i in range(2)]
        assert_close(tmp.sigma_r(mp, R, z_index=zi), ref)
    # sigma(R = 8/h) is the sigma8 table's first entry
    assert_close(tmp.sigma_r(mp, 8.0 / mp.h), mp.sigma8_z[:, 0], 1e-12)
