"""Port parity, line-of-sight transfers (kernel K2a, table engine, plain
path) and the primordial C_l assembly.

JAX perturbation outputs reach the port through convert, so the LOS
integral is tested alone: plik_lite lmax 2508 + 150 margin, the kmax=0.1
small config, tau stride 4; float64 on the CPU,
max |port - jax| <= 1e-9 max |jax| per array.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import cls as jcls
from cosmomc_tpu.models import cmb as jcmb
from cosmomc_tpu.models import primordial as jprim

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models import primordial as tprim

F64 = torch.float64
RTOL = 1e-9
LMAX_C = 2508 + 150
K = jcmb.source_k_grid(kmax=0.1, nk_log=24, nk_lin=48)


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
def ref():
    bg = jbg.BackgroundParams.make(ombh2=0.02237737, omch2=0.1201035,
                                   H0=67.32, dtype=jnp.float64)
    po, chi_star = jax.jit(lambda b: jcmb.compute_transfers(
        b, 0.0543, 0.2454, jnp.asarray(K), n_step=1024))(bg)
    clt = jcls.compute_cl_transfers(po, chi_star, lmax=LMAX_C, kmax_hint=0.1,
                                    coarse_k=K, tau_stride=4)
    return po, chi_star, clt


@pytest.fixture(scope="module")
def port(ref):
    po, chi_star, _ = ref
    return tcls.compute_cl_transfers(
        convert.perturbation_output(po), torch.tensor([float(chi_star)], dtype=F64),
        coarse_k=K, lmax=LMAX_C, kmax_hint=0.1, tau_stride=4)


@pytest.mark.parametrize("field", ["ls", "kf", "wk"])
def test_grids(ref, port, field):
    assert_close(getattr(port, field), getattr(ref[2], field), 0.0)


@pytest.mark.parametrize("field", ["dT", "dE", "dP"])
def test_transfers(ref, port, field):
    assert_close(getattr(port, field)[0], getattr(ref[2], field))


def test_cls_from_transfers(ref, port):
    logA, ns = np.array([3.0447, 3.10]), np.array([0.9659, 0.95])
    pp = tprim.PrimordialParams.make(logA=torch.tensor(logA, dtype=F64),
                                     ns=torch.tensor(ns, dtype=F64))
    two = tcls.ClTransferCache(port.ls, port.kf, port.wk,
                               *(torch.cat([getattr(port, f)] * 2)
                                 for f in ("dT", "dE", "dP")))
    spec = tcls.cls_from_cl_transfers(two, pp, lmax=LMAX_C)
    for i in range(2):
        jp = jprim.PrimordialParams.make(logA=logA[i], ns=ns[i],
                                         dtype=jnp.float64)
        jspec = jcls.cls_from_cl_transfers(ref[2], jp, lmax=LMAX_C)
        np.testing.assert_array_equal(spec.ls.numpy(), np.asarray(jspec.ls))
        for f in ("tt", "te", "ee", "pp"):
            assert_close(getattr(spec, f)[i], getattr(jspec, f))


def test_compute_cls_and_cls_from_transfers(ref, port, monkeypatch):
    """cls.compute_cls is the LOS then the power stage, and
    cmb.cls_from_transfers the same in muK^2 (one temperature a chain):
    with the LOS served from the port's transfers above (held to JAX's by
    test_transfers), both against JAX's power stage on its own transfers,
    which is JAX's compute_cls and cls_from_transfers."""
    from cosmomc_tpu_torch.models import cmb as tcmb_mod
    po, chi_star, clt = ref
    calls = []

    def los(po_, chi_, coarse_k, **kw):
        calls.append((po_, chi_, coarse_k, kw))
        return port
    monkeypatch.setattr(tcls, "compute_cl_transfers", los)
    pp = tprim.PrimordialParams.make(logA=torch.tensor([3.0447], dtype=F64),
                                     ns=torch.tensor([0.9659], dtype=F64))
    jp = jprim.PrimordialParams.make(logA=3.0447, ns=0.9659, dtype=jnp.float64)
    jspec = jcls.cls_from_cl_transfers(clt, jp, lmax=LMAX_C)
    tpo = convert.perturbation_output(po)
    chi = torch.tensor([float(chi_star)], dtype=F64)
    kw = dict(lmax=LMAX_C, kmax_hint=0.1, coarse_k=K, tau_stride=4)
    spec = tcls.compute_cls(tpo, pp, chi, **kw)
    muk = tcmb_mod.cls_from_transfers(tpo, chi, pp,
                                      tcmb_k=torch.tensor([[2.7255]], dtype=F64),
                                      tau0_hint=14200.0, **kw)
    assert len(calls) == 2 and all(c[0] is tpo and c[1] is chi and c[2] is K
                                   for c in calls)
    assert calls[0][3] == dict(lmax=LMAX_C, tau0_hint=14200.0, kmax_hint=0.1,
                               points_per_osc=4.0, tau_stride=4)
    assert calls[1][3] == calls[0][3]
    np.testing.assert_array_equal(spec.ls.numpy(), np.asarray(jspec.ls))
    for f in ("tt", "te", "ee", "pp"):
        assert_close(getattr(spec, f)[0], getattr(jspec, f))
        scale = 1.0 if f == "pp" else (2.7255 * 1e6) ** 2
        assert_close(getattr(muk, f)[0], np.asarray(getattr(jspec, f)) * scale)


def test_coarse_grid_required(ref):
    with pytest.raises(ValueError):
        tcls.compute_cl_transfers(convert.perturbation_output(ref[0]),
                                  torch.tensor([1.0e4], dtype=F64),
                                  coarse_k=K[:-1], lmax=100)
