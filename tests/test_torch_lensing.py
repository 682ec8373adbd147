"""Port parity, curved-sky lensing (kernel K3, plain path).

Smooth CMB-like spectra made with numpy from a fixed seed, two chains with
different amplitudes, at the main path's lmax (2508 + 150 computed, 2508
lensed, 2 lmax theta lanes); float64 on the CPU:
max |port - jax| <= 1e-9 max |jax| per spectrum.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosmomc_tpu.models import lensing as jlens

from cosmomc_tpu_torch.models import lensing as tlens

F64 = torch.float64
RTOL = 1e-9
LMAX, LMAX_LENSED = 2658, 2508


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


def spectra(amp, rng):
    """l(l+1)C_l/2pi-like shapes in muK^2: damped acoustic peaks, and a
    lensing-potential shape peaking near l ~ 40."""
    l = np.arange(2, LMAX + 1, dtype=np.float64)
    ph = rng.uniform(0, 0.3)
    damp = np.exp(-(l / 1400.0) ** 2)
    tt = amp * 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0 + ph) ** 2)
    ee = amp * 40.0 * damp * (l / 1000.0) * (1.0 + np.sin(np.pi * l / 300.0 + ph) ** 2)
    te = 0.4 * np.sqrt(tt * ee) * np.cos(np.pi * l / 150.0 + ph)
    pp = amp * 1.8e-7 * (l / 40.0) / (1.0 + (l / 40.0) ** 2) ** 1.2 * l ** 0.0
    return l, tt, te, ee, pp


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(11)
    sets = [spectra(a, rng) for a in (1.0, 1.12)]
    ls = sets[0][0]
    st = [torch.tensor(np.stack([s[i] for s in sets]), dtype=F64)
          for i in range(1, 5)]
    port = tlens.lens_cls(torch.tensor(ls.astype(np.int64)), *st,
                          lmax_lensed=LMAX_LENSED)
    ref = [jlens.lens_cls(jnp.asarray(ls.astype(np.int32)),
                          *(jnp.asarray(x) for x in s[1:]),
                          lmax_lensed=LMAX_LENSED) for s in sets]
    return port, ref


@pytest.mark.parametrize("field", ["tt", "te", "ee", "bb"])
def test_lensed_spectra(both, field):
    port, ref = both
    for i, r in enumerate(ref):
        assert_close(getattr(port, field)[i], getattr(r, field))


def test_lensing_shapes_and_bb_positive(both):
    port, _ = both
    assert port.tt.shape == (2, LMAX_LENSED - 1)
    assert torch.all(port.bb[:, 10:] > 0)
    np.testing.assert_array_equal(port.ls.numpy(), np.arange(2, LMAX_LENSED + 1))
