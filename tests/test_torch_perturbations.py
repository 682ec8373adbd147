"""Port parity, Boltzmann evolution (kernel K1, plain path) and the
evolution grid it runs on.

JAX intermediates reach the port through cosmomc_tpu_torch.convert, so a
mismatch points at one step: the thermal tables on the tau grid
(build_thermo_funcs) from the JAX recombination history, then the RK4
evolution from the JAX tables. Small config (kmax=0.1 grid with
source_nk=(24, 48), n_step=1024), float64 on the CPU:
max |port - jax| <= 1e-9 max |jax| per array.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg
from cosmomc_tpu.models import cmb as jcmb
from cosmomc_tpu.models import perturbations as jpert
from cosmomc_tpu.models import recfast as jrec
from cosmomc_tpu.models import reionization as jreion

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import perturbations as tpert

F64 = torch.float64
RTOL = 1e-9
N_STEP = 1024
COSMO = [dict(ombh2=0.02237737, omch2=0.1201035, H0=67.32, tau=0.0543,
              yhe=0.2454),
         dict(ombh2=0.0210, omch2=0.1290, H0=64.1, tau=0.071, yhe=0.2441)]
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
    """JAX thermal history, grid and perturbations per cosmology."""
    out = []
    evolve = jax.jit(lambda bg, tf, tau0: jpert.evolve_perturbations(
        bg, tf, tau0, jnp.asarray(K)))
    for c in COSMO:
        bg = jbg.BackgroundParams.make(ombh2=c["ombh2"], omch2=c["omch2"],
                                       H0=c["H0"], dtype=jnp.float64)
        th = jrec.compute_thermo(bg, c["yhe"])
        zre = jreion.zre_from_tau(bg, c["tau"], c["yhe"])
        tf, tau0 = jpert.build_thermo_funcs(bg, c["yhe"], c["tau"],
                                            n_step=N_STEP)
        out.append(dict(bg=bg, th=th, zre=zre, tf=tf, tau0=tau0,
                        po=evolve(bg, tf, tau0)))
    return out


def _batch(ref, fn):
    return torch.cat([fn(r) for r in ref])


@pytest.fixture(scope="module")
def port(ref):
    bg = convert.background_params(jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[r["bg"] for r in ref]))
    yhe = torch.tensor([c["yhe"] for c in COSMO], dtype=F64)
    th = convert.thermo_history(jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[r["th"] for r in ref]))
    zre = torch.tensor([float(r["zre"]) for r in ref], dtype=F64)
    tf, tau0 = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=N_STEP)
    # the evolution runs on the JAX tables, so K1 is tested alone
    tf_ref = convert.thermo_funcs(jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[r["tf"] for r in ref]))
    tau0_ref = torch.tensor([float(r["tau0"]) for r in ref], dtype=F64)
    po = tpert.evolve_perturbations(bg, tf_ref, tau0_ref,
                                    torch.as_tensor(K, dtype=F64))
    return dict(tf=tf, tau0=tau0, po=po)


@pytest.mark.parametrize("field", tpert.ThermoFuncs._fields)
def test_thermo_funcs(ref, port, field):
    for i, r in enumerate(ref):
        assert_close(getattr(port["tf"], field)[i], getattr(r["tf"], field))
    assert_close(port["tau0"], [float(r["tau0"]) for r in ref])


@pytest.mark.parametrize("field", ["s0", "s1", "s2", "slens", "r_init",
                                   "delta_m", "delta_m_z", "ddelta_m_z",
                                   "weyl_z", "aH_z"])
def test_evolution_outputs(ref, port, field):
    for i, r in enumerate(ref):
        assert_close(getattr(port["po"], field)[i], getattr(r["po"], field))


def test_sources_finite_and_first_node_zero(port):
    po = port["po"]
    for s in (po.s0, po.s1, po.s2, po.slens):
        assert torch.isfinite(s).all()
        assert (s[:, :, 0] == 0).all()


def test_convert_perturbation_output(ref, port):
    po = convert.perturbation_output(ref[0]["po"])
    assert po.s0.shape == (1,) + port["po"].s0.shape[1:]
    assert_close(po.s0[0], port["po"].s0[0])
