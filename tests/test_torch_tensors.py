"""Port parity, tensor modes: evolution (kernel K5, plain path), the tensor
line-of-sight transfers (kernel K6, plain path) and the tensor C_l.

The thermal tables come from the JAX package (build_thermo_funcs with
kmax=1.0, as tests/test_tensors.py builds them, at n_step=2048) and reach
the port through convert, so each step is tested alone: the JAX
TensorOutput feeds the port's LOS, the JAX transfer cache its C_l.
float64 on the CPU, max |port - jax| <= 1e-9 max |jax| per array.
A port-only anchor pins the physics: Weinberg's free-streaming damping of
the radiation-era gravitational-wave amplitude (~0.80, astro-ph/0306304).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.special import spherical_jn

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import perturbations as jpert
from cosmomc_tpu.models import primordial as jprim
from cosmomc_tpu.models import tensors as jten

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import primordial as tprim
from cosmomc_tpu_torch.models import tensors as tten
from cosmomc_tpu_torch.models.perturbations import ThermoFuncs

F64 = torch.float64
RTOL = 1e-9
YHE = 0.2454
#: a small tensor k list: the production grid thinned (its top lanes pass
#: the freeze, k tau >= 240, from tau ~ 3700 Mpc on)
K = jten.tensor_k_grid(nk=12)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU, and the many
    small ops here then spend most of their time waiting on each other."""
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
def thermo():
    bg = jbg.BackgroundParams.make(dtype=jnp.float64)
    tf, tau0 = jpert.build_thermo_funcs(bg, YHE, 0.0544, kmax=1.0, n_step=2048)
    return bg, tf, tau0


@pytest.fixture(scope="module")
def evolved(thermo):
    bg, tf, tau0 = thermo
    ref = jten.evolve_tensors(bg, tf, tau0, jnp.asarray(K))
    port = tten.evolve_tensors(convert.background_params(bg),
                               convert.thermo_funcs(tf),
                               torch.tensor([float(tau0)], dtype=F64), K)
    return ref, port


@pytest.mark.parametrize("field", ["sT", "sP", "ht"])
def test_evolve_tensors(evolved, field):
    ref, port = evolved
    assert_close(getattr(port, field)[0], getattr(ref, field))


def test_tensor_rhs_matches(thermo):
    """make_tensor_rhs at three times: in tight coupling, after it, and
    past the freeze of the top k lanes."""
    bg, tf, _ = thermo
    jrhs = jten.make_tensor_rhs(jbg.BackgroundParams.make(dtype=jnp.float64), tf)
    trhs = tten.make_tensor_rhs(convert.background_params(bg),
                                convert.thermo_funcs(tf))
    rng = np.random.default_rng(7)
    y = rng.standard_normal((len(K), tten.NVAR_T))
    for tau in (50.0, 400.0, 3000.0):
        dy, psi = trhs(torch.tensor([tau], dtype=F64),
                       torch.as_tensor(y[None], dtype=F64),
                       torch.as_tensor(K, dtype=F64))
        for i, k in enumerate(K):
            jdy, jpsi = jrhs(jnp.asarray(tau), jnp.asarray(y[i]), jnp.asarray(k))
            assert_close(dy[0, i], jdy)
            assert_close(psi[0, i], jpsi)


@pytest.fixture(scope="module")
def transfers(evolved):
    ref, _ = evolved
    jcache = jten.compute_tensor_transfers(ref, lmax=700)
    return jcache, tten.compute_tensor_transfers(convert.tensor_output(ref),
                                                 lmax=700)


@pytest.mark.parametrize("field", ["ls", "kf", "wk", "dT", "dE", "dB"])
def test_tensor_transfers(transfers, field):
    jcache, tcache = transfers
    port = getattr(tcache, field)
    assert_close(port[0] if port.dim() == 3 else port, getattr(jcache, field))


def test_tensor_cls_from_transfers(transfers):
    jcache, tcache = transfers
    r, logA = np.array([0.1, 0.03]), np.array([3.044, 3.10])
    nt = -r / 8.0
    one = convert.tensor_transfer_cache(jcache)
    two = one._replace(**{f: torch.cat([getattr(one, f)] * 2)
                          for f in ("dT", "dE", "dB")})
    pp = tprim.PrimordialParams.make(
        logA=torch.tensor(logA, dtype=F64), ns=torch.full((2,), 0.965, dtype=F64),
        r=torch.tensor(r, dtype=F64), nt=torch.tensor(nt, dtype=F64))
    spec = tten.tensor_cls_from_transfers(two, pp, lmax=700)
    for i in range(2):
        jp = jprim.PrimordialParams.make(logA=logA[i], ns=0.965, r=r[i],
                                         nt=nt[i], dtype=jnp.float64)
        jspec = jten.tensor_cls_from_transfers(jcache, jp, lmax=700)
        np.testing.assert_array_equal(spec.ls.numpy(), np.asarray(jspec.ls))
        for f in ("tt", "te", "ee", "bb"):
            assert_close(getattr(spec, f)[i], getattr(jspec, f))


def test_compute_tensor_cls(evolved, transfers, monkeypatch):
    """tensors.compute_tensor_cls is the LOS then the tensor power: with
    the LOS served from the port's transfers above (held to JAX's by
    test_tensor_transfers), against JAX's power stage on its own
    transfers, which is JAX's compute_tensor_cls."""
    ref, _ = evolved
    jcache, tcache = transfers
    calls = []

    def los(to, **kw):
        calls.append((to, kw))
        return tcache
    monkeypatch.setattr(tten, "compute_tensor_transfers", los)
    pp = tprim.PrimordialParams.make(
        logA=torch.tensor([3.044], dtype=F64), ns=torch.tensor([0.965], dtype=F64),
        r=torch.tensor([0.1], dtype=F64), nt=torch.tensor([-0.0125], dtype=F64))
    jp = jprim.PrimordialParams.make(logA=3.044, ns=0.965, r=0.1, nt=-0.0125,
                                     dtype=jnp.float64)
    to = convert.tensor_output(ref)
    spec = tten.compute_tensor_cls(to, pp, lmax=700)
    assert len(calls) == 1 and calls[0][0] is to
    assert calls[0][1] == dict(lmax=700, tau0_hint=14700.0, kmax_hint=0.065,
                               points_per_osc=4.0, coarse_k=None)
    jspec = jten.tensor_cls_from_transfers(jcache, jp, lmax=700)
    for f in ("tt", "te", "ee", "bb"):
        assert_close(getattr(spec, f)[0], getattr(jspec, f))


def test_weinberg_damping_anchor():
    """The port alone: neutrino free streaming damps h by ~0.80 deep in the
    radiation era (tests/test_tensors.py's anchor), k = 1/Mpc, 4 substeps,
    on the first nodes (tau < 16 Mpc) of the production-density grid."""
    bg = jbg.BackgroundParams.make(dtype=jnp.float64)
    tf, tau0 = jpert.build_thermo_funcs(bg, YHE, 0.0544, kmax=1.0)
    n = int(np.searchsorted(np.asarray(tf.tau), 16.0))
    ttf = ThermoFuncs(*[convert.tensor(np.asarray(getattr(tf, f))[None, :n])
                        for f in ThermoFuncs._fields])
    to = tten.evolve_tensors(convert.background_params(bg), ttf,
                             torch.tensor([float(tau0)], dtype=F64), [1.0],
                             substeps=4)
    taus = ttf.tau[0].numpy()
    ht = to.ht[0, 0].numpy()
    sel = (taus > 6) & (taus < 14)
    x = taus[sel]
    good = np.abs(spherical_jn(0, x)) > 0.25 / x
    ratio = np.median(ht[sel][good] / spherical_jn(0, x[good]))
    assert 0.72 < ratio < 0.86, ratio
