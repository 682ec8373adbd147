"""Port parity, line-of-sight transfers by the recurrence engine (kernel
K2b, plain path).

JAX perturbation outputs reach the port through convert, so the LOS
integral is tested alone: the kmax=0.1 small config (source_nk=(24, 48),
1024 Boltzmann steps), lmax 800, tau stride 4; float64 on the CPU,
max |port - jax| <= 1e-9 max |jax| per array. The Airy cut per l comes
from np.cbrt on the host in the port and from jnp.cbrt in the JAX
package; a last-ulp difference there could flip one (x, l) point's branch
only for x within one ulp of the cut, which these inputs do not hit.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import cls as jcls
from cosmomc_tpu.models import cmb as jcmb

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models import primordial as tprim

F64 = torch.float64
RTOL = 1e-9
LMAX = 800
K = jcmb.source_k_grid(kmax=0.1, nk_log=24, nk_lin=48)
ARGS = dict(lmax=LMAX, kmax_hint=0.1, tau_stride=4)


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
def ref():
    bg = jbg.BackgroundParams.make(ombh2=0.02237737, omch2=0.1201035,
                                   H0=67.32, dtype=jnp.float64)
    po, chi_star = jax.jit(lambda b: jcmb.compute_transfers(
        b, 0.0543, 0.2454, jnp.asarray(K), n_step=1024))(bg)
    clt = jax.jit(lambda p, c: jcls.compute_cl_transfers_recurrence(
        p, c, coarse_k=K, **ARGS))(po, chi_star)
    return po, chi_star, clt


@pytest.fixture(scope="module")
def port(ref):
    po, chi_star, _ = ref
    return tcls.compute_cl_transfers_recurrence(
        convert.perturbation_output(po),
        torch.tensor([float(chi_star)], dtype=F64), coarse_k=K, **ARGS)


@pytest.mark.parametrize("field", ["ls", "kf", "wk"])
def test_grids(ref, port, field):
    assert_close(getattr(port, field), getattr(ref[2], field), 0.0)


@pytest.mark.parametrize("field", ["dT", "dE", "dP"])
def test_transfers(ref, port, field):
    assert_close(getattr(port, field)[0], getattr(ref[2], field))


def test_agrees_with_table_engine(ref, port):
    """The two engines compute the same integral. At the C_l level they
    agree to ~0.1% (TT) - 0.5% (EE, phiphi) of each spectrum's maximum on
    these inputs; per l the recurrence's Airy cut and series move EE at
    l = 2 by ~10%, so the check is on the maximum, at 1%."""
    po, chi_star, _ = ref
    table = tcls.compute_cl_transfers(
        convert.perturbation_output(po),
        torch.tensor([float(chi_star)], dtype=F64), coarse_k=K, **ARGS)
    pp = tprim.PrimordialParams.make(logA=torch.tensor([3.044], dtype=F64),
                                     ns=torch.tensor([0.965], dtype=F64))
    a = tcls.cls_from_cl_transfers(port, pp, lmax=LMAX)
    b = tcls.cls_from_cl_transfers(table, pp, lmax=LMAX)
    for f in ("tt", "te", "ee", "pp"):
        assert_close(getattr(a, f), getattr(b, f), 1e-2)


def test_missing_grid_hands_over_to_table_engine(ref):
    """Without the coarse grid the JAX recurrence defers to its table
    engine; the port's table engine needs that grid, so the recurrence
    raises the same ValueError itself."""
    po = convert.perturbation_output(ref[0])
    with pytest.raises(ValueError):
        tcls.compute_cl_transfers_recurrence(po, torch.tensor([1.0e4], dtype=F64),
                                             coarse_k=None, lmax=100)
