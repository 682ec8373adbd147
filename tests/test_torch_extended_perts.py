"""Port parity, the extended sectors of the Boltzmann evolution (kernel K1,
plain path): the massive-neutrino momentum hierarchy, the c_s^2 = 1
dark-energy fluid and the correlated CDM-isocurvature ICs.

The JAX evolution runs per chain on its own thermal tables; the port runs
all chains of a case at once on those tables (cosmomc_tpu_torch.convert),
so the evolution is tested alone. tests/test_extended_perts.py's cheap
grid: 4096 steps, k <= 0.05 (RK4 stays stable there). Cosmologies are drawn
from a seeded numpy generator around the Planck 2018 best fit; each case
has chains of different mnu, w/wa and isocurvature amplitude b, the w0 =
-0.9, wa = -0.4 crossing among them. float64 on the CPU.

Tolerances: every output 1e-9 of its maximum (the same arithmetic in
another order); the quadrature constants 1e-14; the w = -1 identity and
the massless limit as tests/test_extended_perts.py states them (atol 1e-12
on s0, rtol 1e-12 on delta_m; 2e-3 of the maximum).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import perturbations as jpert
from cosmomc_tpu.models.background import BackgroundParams as JBG
from cosmomc_tpu.params.parameterizations import mnu_to_omnuh2

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import perturbations as tpert

F64 = torch.float64
RTOL = 1e-9
N_STEP = 4096
K = np.array([0.003, 0.01, 0.03, 0.05])
Z_OUT = (0.0, 1.0)
YHE, TAU = 0.2454, 0.0543
#: per case: the switches, and each chain's mnu, w, wa and isocurvature b
CASES = {
    "nu": (dict(massive_nu=True, de_perts=False),
           [dict(mnu=1e-5), dict(mnu=0.06), dict(mnu=0.3)]),
    "de": (dict(massive_nu=False, de_perts=True),
           [dict(w=-1.0), dict(w=-0.8), dict(w=-0.9, wa=-0.4)]),
    "all": (dict(massive_nu=True, de_perts=True),
            [dict(mnu=0.1, w=-0.9, wa=-0.4, b=0.2),
             dict(mnu=0.3, w=-1.1, wa=0.2, b=-0.1)]),
}
FIELDS = ["s0", "s1", "s2", "slens", "r_init", "delta_m", "delta_m_z",
          "ddelta_m_z", "weyl_z", "aH_z"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol=RTOL, what=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"{what}: rel err {err:.3e} > {rtol:.1e}"


def _chains(case):
    """The JAX backgrounds of a case's chains and their isocurvature
    amplitudes; ombh2, omch2, H0 drawn from a seeded generator."""
    rng = np.random.default_rng(sorted(CASES).index(case) + 17)
    out = []
    for c in CASES[case][1]:
        ombh2, omch2, H0 = np.array([0.02238, 0.1201, 67.32]) * (
            1.0 + 0.01 * rng.standard_normal(3))
        bg = JBG(ombh2=jnp.float64(ombh2), omch2=jnp.float64(omch2),
                 H0=jnp.float64(H0), omk=jnp.float64(0.0),
                 omnuh2=jnp.float64(mnu_to_omnuh2(c.get("mnu", 0.06))),
                 nnu=jnp.float64(3.046), w=jnp.float64(c.get("w", -1.0)),
                 wa=jnp.float64(c.get("wa", 0.0)), tcmb=jnp.float64(2.7255),
                 num_massive_nu=1)
        out.append((bg, c.get("b", 0.0)))
    return out


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the JAX backgrounds, isocurvature amplitudes, thermal
    tables and evolution of each chain."""
    tables = jax.jit(lambda bg: jpert.build_thermo_funcs(
        bg, jnp.float64(YHE), jnp.float64(TAU), n_step=N_STEP))
    out = {}
    for name, (sw, _) in CASES.items():
        chains = _chains(name)
        iso = any(b != 0.0 for _, b in chains)
        evolve = jax.jit(lambda bg, tf, tau0, b: jpert.evolve_perturbations(
            bg, tf, tau0, jnp.asarray(K), Z_OUT,
            iso_cdm_amp=b if iso else 0.0, **sw))
        tfs = [tables(bg) for bg, _ in chains]
        out[name] = (chains, tfs, [evolve(bg, tf, tau0, jnp.float64(b))
                                   for (bg, b), (tf, tau0) in zip(chains, tfs)])
    return out


def _port_inputs(chains, tfs):
    return (convert.background_params(_stack([bg for bg, _ in chains])),
            convert.thermo_funcs(_stack([tf for tf, _ in tfs])),
            torch.tensor([float(t) for _, t in tfs], dtype=F64))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, jax_runs):
    """The port on all chains of a case at once, on JAX's tables: (name,
    JAX outputs, port output, port inputs)."""
    name = request.param
    chains, tfs, ref = jax_runs[name]
    bg, tf, tau0 = _port_inputs(chains, tfs)
    b = [b for _, b in chains]
    po = tpert.evolve_perturbations(
        bg, tf, tau0, torch.as_tensor(K, dtype=F64), Z_OUT,
        iso_cdm_amp=torch.tensor(b, dtype=F64) if any(b) else 0.0,
        **CASES[name][0])
    return name, ref, po, (bg, tf, tau0)


@pytest.fixture(scope="module")
def jax_base(jax_runs):
    """JAX's base layout on the first chain of "nu" (mnu = 1e-5)."""
    (bg, _), (tf, tau0) = jax_runs["nu"][0][0], jax_runs["nu"][1][0]
    return jpert.evolve_perturbations(bg, tf, tau0, jnp.asarray(K), Z_OUT)


def test_quadrature_constants():
    """The port's own host copy of the Gauss nodes, weights and the
    rescaled d ln f0/d ln q equals the JAX package's (1e-14), and the
    rescale gives <d ln f0/d ln q> = -4."""
    for name in ("_NU_Q", "_NU_W", "_NU_WNORM", "_NU_DLNF"):
        assert_close(getattr(tpert, name), getattr(jpert, name), 1e-14, name)
    assert abs((tpert._NU_WNORM * tpert._NU_DLNF).sum() + 4.0) < 1e-14
    n3 = 7.0 * np.pi ** 4 / 120.0
    assert abs(tpert._NU_W.sum() / n3 - 1.0) < 1e-6
    assert tpert.extra_state(True, True) == jpert.extra_state(True, True) == 30


@pytest.mark.parametrize("field", FIELDS)
def test_extended_outputs_match(case, field):
    """Every output of every chain against JAX (1e-9 of its maximum)."""
    name, ref, po, _ = case
    for i, r in enumerate(ref):
        assert_close(getattr(po, field)[i], getattr(r, field),
                     what=f"{name}[{i}].{field}")
        assert torch.isfinite(getattr(po, field)[i]).all()


def test_limits_and_normalisation(case, jax_base):
    """The massive hierarchy at mnu = 1e-5 is the massless limit: the
    port's s0, slens and delta_m against the base layout's (JAX's) within
    2e-3 of the maximum. The fluid at w = -1 contributes exactly nothing:
    on every stage row of that chain, with the fluid at zero, the RHS and
    the sources equal the base layout's bit for bit (so the evolution
    does: tests/test_extended_perts.py holds it to atol 1e-12 on s0), and
    the fluid's derivatives are 0. With or without an isocurvature
    admixture, r_init is the curvature of the pure-adiabatic start state,
    bit for bit."""
    name, _, po, (bg, tf, tau0) = case
    k = torch.as_tensor(K, dtype=F64)
    rnu = tpert._r_nu(bg)[:, None]
    if name == "nu":
        for f in ("s0", "slens", "delta_m"):
            x, y = getattr(po, f)[0], torch.as_tensor(np.array(getattr(jax_base, f)))
            assert float((x - y).abs().max() / y.abs().max()) < 2e-3, f
    if name == "de":
        assert float(bg.w[0]) == -1.0 and float(bg.wa[0]) == 0.0
        # every (step, stage) row of chain 0 as a batch of its own
        q_de = tpert._stage_tables(bg, tf, de_perts=True)[0].flatten(0, 1)
        q_b = tpert._stage_tables(bg, tf)[0].flatten(0, 1)
        rng = np.random.default_rng(5)
        y = torch.as_tensor(rng.standard_normal((q_b.shape[0], len(K), tpert.NVAR)))
        y_de = torch.cat([y, torch.zeros(y.shape[:-1] + (tpert.NVAR_DE,), dtype=F64)], -1)
        dy, aux = tpert._rhs(y_de, q_de, k, tpert.RSA_KTAU, de_perts=True)
        dyb, auxb = tpert._rhs(y, q_b, k, tpert.RSA_KTAU)
        assert torch.equal(dy[..., :tpert.NVAR], dyb)
        assert torch.equal(dy[..., tpert.NVAR:], torch.zeros_like(dy[..., tpert.NVAR:]))
        for a_, b_ in zip(tpert._sources(y_de, dy, aux, q_de, k),
                          tpert._sources(y, dyb, auxb, q_b, k)):
            assert torch.equal(a_, b_)
    y0 = tpert.adiabatic_ics(k, tf.tau[:, :1], rnu)
    assert torch.equal(po.r_init, tpert.measure_curvature(bg, tf, y0, k))
