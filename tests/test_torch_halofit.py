"""Port parity, halofit and the nonlinear lensing-source ratio
(models/matterpower.py, halofit subset).

Inputs are made with numpy from a seed: BBKS-shaped matter transfers per
unit curvature on the main path's source k grid (kmax 0.5), scaled by a
growth factor per redshift node and perturbed by 1% noise, for two
cosmologies. Each goes through the JAX function (one cosmology at a time)
and through the port (both chains in one batch), float64 on the CPU.
Tolerance: max |port - jax| <= 1e-9 max |jax| per array; the 48-step
bisection can settle one ulp apart, which moves k_sigma by ~1e-14.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import cmb as jcmb
from cosmomc_tpu.models import matterpower as jmp
from cosmomc_tpu.models import primordial as jprim

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import matterpower as tmp
from cosmomc_tpu_torch.models import primordial as tprim

F64 = torch.float64
RTOL = 1e-9
COSMO = [dict(ombh2=0.02237737, omch2=0.1201035, H0=67.32),
         dict(ombh2=0.0210, omch2=0.1290, H0=64.1, w=-0.9, wa=0.1)]
K = jcmb.source_k_grid(kmax=0.5)
Z = np.asarray(jmp.LENS_NL_Z)


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


def _transfers(rng, omh2):
    """delta_m / R at each z node: BBKS shape, growth ~ 1/(1+z)."""
    q = K / (omh2 * 1.0)
    T = (np.log(1 + 2.34 * q) / (2.34 * q)
         * (1 + 3.89 * q + (16.1 * q) ** 2 + (5.46 * q) ** 3
            + (6.71 * q) ** 4) ** -0.25)
    tr = 7.0e6 * K ** 2 * T / (1.0 + Z[:, None])
    return tr * (1.0 + 0.01 * rng.standard_normal(tr.shape))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(20261016)
    jbgs = [jbg.BackgroundParams.make(dtype=jnp.float64, **c) for c in COSMO]
    dm = np.stack([_transfers(rng, c["ombh2"] + c["omch2"]) for c in COSMO])
    tbg = convert.background_params(jbg.BackgroundParams.make(
        **{f: np.array([float(getattr(b, f)) for b in jbgs])
           for f in ("ombh2", "omch2", "H0", "w", "wa")}, dtype=jnp.float64))
    return jbgs, tbg, dm


def test_halofit_takahashi(inputs):
    jbgs, tbg, dm = inputs
    lnP = np.log(2 * np.pi ** 2 / K ** 3 * 2.1e-9 * dm ** 2)
    port = tmp.halofit_takahashi(tbg, torch.as_tensor(K, dtype=F64),
                                 torch.as_tensor(lnP, dtype=F64),
                                 torch.as_tensor(Z, dtype=F64))
    for c, b in enumerate(jbgs):
        ref = jmp.halofit_takahashi(b, jnp.asarray(K), jnp.asarray(lnP[c]),
                                    jnp.asarray(Z))
        assert_close(port[c], ref)
    # the boost is ~1 on large scales and grows at high k, low z
    boost = np.exp(port.numpy() - lnP)
    assert np.all(np.abs(boost[:, :, 0] - 1) < 1e-3)
    assert np.all(boost[:, 0, -1] > 2.0)


def test_lensing_nl_ratio(inputs):
    jbgs, tbg, dm = inputs
    logA, ns = 3.044, 0.965
    pp = tprim.PrimordialParams.make(logA=torch.full((2,), logA, dtype=F64),
                                     ns=torch.full((2,), ns, dtype=F64))
    port = tmp.lensing_nl_ratio(tbg, pp, torch.as_tensor(K, dtype=F64),
                                torch.as_tensor(dm, dtype=F64), tmp.LENS_NL_Z)
    assert tuple(port.shape) == (2, len(Z), len(K))
    jpp = jprim.PrimordialParams.make(logA=logA, ns=ns, dtype=jnp.float64)
    for c, b in enumerate(jbgs):
        ref = jmp.lensing_nl_ratio(b, jpp, jnp.asarray(K), jnp.asarray(dm[c]),
                                   jmp.LENS_NL_Z)
        assert_close(port[c], ref)
    assert tmp.LENS_NL_Z == jmp.LENS_NL_Z
