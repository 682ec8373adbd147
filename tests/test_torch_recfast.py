"""Port parity, RECFAST thermal history (kernel K4, plain path) and the
thermal tables and derived scalars built on it.

Same cosmologies through cosmomc_tpu.models.recfast/thermo and
cosmomc_tpu_torch, float64 on the CPU: max |port - jax| <= 1e-9 max |jax|.
The port's three chains run as one batched call.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import recfast as jrec
from cosmomc_tpu.models import thermo as jthermo

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import background as tbg
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models import thermo as tthermo

F64 = torch.float64
RTOL = 1e-9
_RNG = np.random.default_rng(7)
OMB = _RNG.uniform(0.020, 0.025, 3)
OMC = _RNG.uniform(0.10, 0.14, 3)
H0 = _RNG.uniform(62.0, 74.0, 3)
YHE = _RNG.uniform(0.240, 0.250, 3)


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


def jax_bg(i):
    return jbg.BackgroundParams.make(ombh2=OMB[i], omch2=OMC[i], H0=H0[i],
                                     dtype=jnp.float64)


@pytest.fixture(scope="module")
def both():
    bg = tbg.BackgroundParams.make(ombh2=OMB, omch2=OMC, H0=H0, nchains=3,
                                   dtype=F64)
    yhe = torch.as_tensor(YHE, dtype=F64)
    th = trec.compute_thermo(bg, yhe)
    jth = [jrec.compute_thermo(jax_bg(i), YHE[i]) for i in range(3)]
    return bg, yhe, th, jth


@pytest.mark.parametrize("field", ["z", "xe", "tm"])
def test_thermo_history(both, field):
    _, _, th, jth = both
    for i in range(3):
        assert_close(getattr(th, field)[i], getattr(jth[i], field))


def test_recombination_sane(both):
    _, _, th, _ = both
    xe = th.xe.numpy()
    assert np.all(np.isfinite(xe)) and np.all(np.isfinite(th.tm.numpy()))
    assert np.all(xe[:, 0] > 1.0) and np.all(xe[:, -1] < 1e-3)


def test_thermo_tables(both):
    bg, yhe, th, jth = both
    tabs = tthermo.compute_thermo_tables(bg, th, yhe)
    for i in range(3):
        jtab = jthermo.compute_thermo_tables(jax_bg(i), jth[i], YHE[i])
        for f in jtab._fields:
            if f == "damp":
                # damp = cumd[-1] - cumd differences two ~1e13 cumulative
                # sums (thermo.py:129), so its values near the grid top
                # carry 1e-16 x 1e13 absolute error from the summation
                # order alone; compared relative to its maximum
                assert_close(getattr(tabs, f)[i], getattr(jtab, f), 1e-13)
            else:
                assert_close(getattr(tabs, f)[i], getattr(jtab, f))


def test_thermo_derived(both):
    bg, yhe, th, jth = both
    der = tthermo.thermo_derived(bg, tthermo.compute_thermo_tables(bg, th, yhe))
    for i in range(3):
        jb = jax_bg(i)
        jd = jthermo.thermo_derived(jb, jthermo.compute_thermo_tables(
            jb, jth[i], YHE[i]))
        for f in jd._fields:
            # kd reads damp at z* (~3e2), where the cancellation above
            # leaves ~1e-3 relative from the summation order alone: the
            # reference itself is no better than that (measured 9e-4)
            assert_close(getattr(der, f)[i], getattr(jd, f),
                         5e-3 if f == "kd" else RTOL)


def test_convert_thermo_history_roundtrip(both):
    _, _, th, jth = both
    one = convert.thermo_history(jth[0])
    assert one.xe.shape == (1, trec.N_Z)
    assert_close(one.xe[0], th.xe[0])


def test_cuda_tensor_never_takes_plain_path():
    """On a CUDA device the wrapper launches the kernel or raises; it never
    falls back to the plain version."""
    zt = torch.zeros(1, trec.N_ZT, 4, dtype=F64)
    with pytest.raises(ValueError):
        trec._scan_cuda(zt, torch.zeros(1, dtype=F64))
