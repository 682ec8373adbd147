"""Port parity of the flagship CMB posterior's gradient, float64 on the CPU.

The flagship composition of tests/test_torch_slice.py (theta LCDM,
plik_lite + the tau prior, the synthetic BBN table; kmax 0.1,
source_nk=(24, 48), 2048 Boltzmann steps, no halofit), with the Boltzmann
C_l computed to lmax_computed = 500 and a high-l template above (the
line of sight to 650, lensing 2..650 -> 500): at the full lmax the plain
line of sight and lensing under autograd take ~30 GB of host memory and
~5 minutes. The plik_lite fiducial and the template are written from one
smooth made-up spectrum, so no posterior runs to make them. One point,
the best fit:

  (a) the semi and fast stages with the slow cache held (JAX's own
      tests/test_cmb_posterior.py:141-165): the port's autograd gradient on
      JAX's slow cache (carried by `convert`) against jax.grad on it,
      1e-9 of the largest component;
  (b) the whole -logL, through K4, K1, K2a and K3: the port's autograd
      gradient (K4's recurrence, K1's steps and K2a's k chunks
      rematerialized, `remat_chunks` = 16) along two seeded directions
      against jax.jvp of the JAX posterior along them (forward mode, one
      jitted call), 1e-9 relative; and its logA, ns and A_planck
      components (on which the slow stage does not depend) against the
      semi + fast gradient on the port's own slow cache from the same
      forward pass, 1e-12.

Cost, measured on one CPU thread (a shared x86 host): the port's
forward with its graph ~46 s and backward ~220 s (recfast's 8000 nodes and
K1's 2048 steps, not the reduced lmax, take most of it: the ~10 us a node
of the autograd engine over ~1e7 nodes), 2.5 GB peak; JAX's jitted slow
stage ~25 s and both jvps ~50 s.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.likelihoods.pliklite import PlikLiteLikelihood as JPlik
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JPar
from cosmomc_tpu.pipeline import CMBPosterior as JPost

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood as TPlik
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TPar
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost

F64 = torch.float64
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
               tau=0.05430138, logA=3.0447260, ns=0.9658923)
LMAX_COMPUTED = 500
CFG = dict(kmax=0.1, source_nk=(24, 48), n_step_boltzmann=2048,
           nonlinear_lens=False, lmax_computed=LMAX_COMPUTED)
SEMI_FAST = ("logA", "ns", "A_planck")
#: (a) and (b) against JAX; the full gradient's semi and fast components
#: against the held-cache gradient in the port
JAX_RTOL, SELF_RTOL = 1e-9, 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth_cls(lmax=3000):
    """(4, 4, lmax + 1) l(l+1)C_l/2pi in muK^2: a made-up smooth spectrum."""
    l = np.arange(lmax + 1, dtype=np.float64)
    cls = np.zeros((4, 4, lmax + 1))
    cls[0, 0] = 1000.0 + 5000.0 * np.exp(-((l - 220.0) / 250.0) ** 2)
    cls[1, 1] = 5.0 + 40.0 * np.exp(-((l - 1000.0) / 400.0) ** 2)
    cls[1, 0] = cls[0, 1] = 0.1 * np.sqrt(cls[0, 0] * cls[1, 1]) * np.cos(l / 150.0)
    cls[2, 2] = 0.01 * cls[1, 1]
    cls[3, 3] = 1e-7
    return cls


@pytest.fixture(scope="module")
def posts(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("grad_flagship"))
    cls = smooth_cls()
    ls = np.arange(2, cls.shape[-1])
    theory_cl = os.path.join(d, "smooth.theory_cl")
    np.savetxt(theory_cl, np.column_stack([ls, cls[0, 0, 2:], cls[1, 0, 2:],
                                           cls[1, 1, 2:], cls[2, 2, 2:],
                                           cls[3, 3, 2:]]))
    ds = write_plik_lite_fiducial(os.path.join(d, "plik"), theory_cl)
    tmpl = sd.write_highl_template(os.path.join(d, "highl.dat"), cls, 3000)
    tab = synthetic_bbn_table()
    jtab = JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))
    js, ts = JPar(jnp.float64).default_space(), TPar().default_space()
    for sp in (js, ts):
        sp.get("tau").prior_mean = 0.0544
        sp.get("tau").prior_std = 0.0073
    jl, tl = JLikes(), TLikes()
    jl.add(JPlik(ds, name="plik_lite", dtype=jnp.float64))
    tl.add(TPlik(ds, name="plik_lite", device="cpu", dtype=F64))
    jpost = JPost(JPar(jnp.float64), js, jl, bbn_table=jtab, dtype=jnp.float64,
                  highl_template=tmpl, **CFG)
    tpost = TPost(TPar(), ts, tl, bbn_table=tab, device="cpu", dtype=F64,
                  highl_template=tmpl, remat_chunks=16, **CFG)
    names = [p.name for p in tpost.space.varying]
    P0 = np.array([p.center for p in tpost.space.varying])
    for k, v in BESTFIT.items():
        P0[names.index(k)] = v
    w = np.array([p.propose_width for p in tpost.space.varying])
    V = w * np.random.default_rng(20261018).standard_normal((2, len(w)))
    return dict(jpost=jpost, tpost=tpost, names=names, P0=P0, V=V)


def _semi_fast_grad(tpost, P, slow):
    """The port's gradient through stage_semi and stage_fast with `slow`
    held."""
    P = P.detach().clone().requires_grad_(True)
    full = tpost.embed_full(P)
    mll, _ = tpost.stage_fast(P, slow, tpost.stage_semi(full, slow))
    (g,) = torch.autograd.grad(mll.sum(), P)
    return g[0].numpy()


def _held(slow):
    return {k: (v.detach() if torch.is_tensor(v) else
                type(v)(*(x.detach() if torch.is_tensor(x) else x for x in v))
                if isinstance(v, tuple) else v) for k, v in slow.items()}


@pytest.fixture(scope="module")
def jax_side(posts):
    jpost, P0, V = posts["jpost"], jnp.asarray(posts["P0"]), jnp.asarray(posts["V"])
    slow = jax.jit(jpost.stage_slow)(jpost.embed_full(P0))
    slow = jax.tree_util.tree_map(jax.lax.stop_gradient, slow)

    def semi_fast(p):
        semi = jpost.stage_semi(jpost.embed_full(p), slow)
        return jpost.stage_fast(p, slow, semi)[0]
    g_semi = np.asarray(jax.jit(jax.grad(semi_fast))(P0))
    f = lambda p: jpost.logpost()(p)[0]
    mll, jvps = jax.jit(lambda p, V: jax.vmap(
        lambda v: jax.jvp(f, (p,), (v,)), out_axes=(None, 0))(V))(P0, V)
    return dict(slow=slow, g_semi=g_semi, mll=float(mll), jvp=np.asarray(jvps))


@pytest.fixture(scope="module")
def port_side(posts):
    """The full gradient at the best fit, and the semi + fast gradient on
    the slow cache of the same forward pass, held."""
    tpost = posts["tpost"]
    assert tpost.gradient_unsupported() is None
    P = torch.tensor(posts["P0"][None], dtype=F64, requires_grad=True)
    seen = {}

    def stage_slow(full):
        seen["slow"] = type(tpost).stage_slow(tpost, full)
        return seen["slow"]
    tpost.stage_slow = stage_slow
    try:
        m, _ = tpost.logpost()(P)
    finally:
        del tpost.stage_slow
    (g,) = torch.autograd.grad(m.sum(), P)
    own = _semi_fast_grad(tpost, P, _held(seen["slow"]))
    return dict(mll=float(m.detach()), g=g[0].numpy(), g_semi_own=own)


def test_semi_fast_gradient_matches_jax_grad(posts, jax_side):
    """(a): on JAX's slow cache, carried by convert."""
    tpost, names = posts["tpost"], posts["names"]
    slow = convert._slow_cache(jax.tree_util.tree_map(lambda a: a[None],
                                                      jax_side["slow"]),
                               "cpu", F64)
    g = _semi_fast_grad(tpost, torch.tensor(posts["P0"][None], dtype=F64), slow)
    ref = jax_side["g_semi"]
    assert np.isfinite(g).all()
    for nm in SEMI_FAST:
        assert ref[names.index(nm)] != 0, nm
    err = np.abs(g - ref).max() / np.abs(ref).max()
    assert err <= JAX_RTOL, f"rel err {err:.3e}"


@pytest.mark.parametrize("direction", [0, 1])
def test_full_gradient_matches_jax_jvp(posts, jax_side, port_side, direction):
    """(b): the directional derivative of -logL."""
    got = float(port_side["g"] @ posts["V"][direction])
    ref = float(jax_side["jvp"][direction])
    assert np.isfinite(port_side["g"]).all()
    np.testing.assert_allclose(port_side["mll"], jax_side["mll"], rtol=1e-9)
    assert abs(got - ref) <= JAX_RTOL * abs(ref), (got, ref)


@pytest.mark.parametrize("name", SEMI_FAST)
def test_full_gradient_semi_fast_components(posts, port_side, name):
    """(b) against (a) in the port: along logA, ns and A_planck the slow
    stage is constant, so the full gradient is the held-cache one."""
    i = posts["names"].index(name)
    got, ref = port_side["g"][i], port_side["g_semi_own"][i]
    assert ref != 0 and abs(got - ref) <= SELF_RTOL * abs(ref), (got, ref)
