"""Port parity of LCDM+r's gradient, float64 on the CPU.

tests/test_torch_grad_flagship.py's composition (theta LCDM, plik_lite +
the tau prior, the synthetic BBN table; kmax 0.1, source_nk=(24, 48),
2048 Boltzmann steps, no halofit, the Boltzmann C_l to lmax_computed =
500 and its high-l template above) with compute_tensors=True: r free
(semi-slow, nt = -r/8), the tensor evolution (K5's plain version, 96 k)
and the tensor line of sight to l = 700 (K6's), both under autograd
(their graphs rematerialized in chunks). One point, the best fit with
r = 0.1:

  (a) the port's gradient of -logL along two seeded directions against
      jax.jvp of the JAX posterior (forward mode, one jitted call), within
      JVP_RTOL; and -logL itself. The two packages' tau0 differ in their
      last ulps (tests/test_torch_lcdm_r.py: the port's float64 cumsum
      against XLA's scan), and the tensor line of sight's last node, where
      chi = tau0 - tau is a few ulps, reads them: tensor Delta_T at l = 2-4
      moves by ~0.7%. plik_lite reads TT from l = 30 only, but the tensor
      C_l reach it through the spline over the sampled l's; the test prints
      both tau0, their gap in ulps, and the relative gaps of -logL and of
      the two directional derivatives, and JVP_RTOL is stated from them;
  (b) the r, logA and ns components (on which the slow stage does not
      depend) against the semi + fast gradient on the port's own slow
      cache from the same forward pass, 1e-12.

Cost on one CPU thread: tests/test_torch_grad_flagship.py's (recfast's
8000 nodes and K1's 2048 steps under the autograd engine), plus the
tensor evolution and line of sight, forward and backward: 337 s alone on
a shared x86 host.
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
from cosmomc_tpu.models.bbn import yhe_bbn as j_yhe_bbn
from cosmomc_tpu.models.perturbations import build_thermo_funcs as j_thermo_funcs
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JPar
from cosmomc_tpu.pipeline import CMBPosterior as JPost

from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood as TPlik
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.models.perturbations import \
    build_thermo_funcs as t_thermo_funcs
from cosmomc_tpu_torch.models.recfast import compute_thermo
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TPar
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost

from test_torch_grad_flagship import CFG, _held, _semi_fast_grad, smooth_cls

F64 = torch.float64
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
               tau=0.05430138, logA=3.0447260, ns=0.9658923, r=0.1)
LCDM_R = dict(CFG, compute_tensors=True)
SEMI = ("r", "logA", "ns")
#: (a): the relative gaps to JAX's. Measured on this composition (CPU,
#: float64): the port's tau0 sits 4 ulps below JAX's, -logL differs by
#: 2.5e-13 and the derivatives along the two directions by 6.3e-11 and
#: 5.3e-11 relative: through the tensor spline the gap of tau0 reaches
#: plik_lite's l >= 30 at that level, so the flagship's 1e-9 holds
JVP_RTOL, MLL_RTOL = 1e-9, 1e-10
SELF_RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def posts(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("grad_lcdm_r"))
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
                  highl_template=tmpl, **LCDM_R)
    tpost = TPost(TPar(), ts, tl, bbn_table=tab, device="cpu", dtype=F64,
                  highl_template=tmpl, remat_chunks=16, **LCDM_R)
    names = [p.name for p in tpost.space.varying]
    assert names == [p.name for p in jpost.space.varying] and "r" in names
    P0 = np.array([p.center for p in tpost.space.varying])
    for k, v in BESTFIT.items():
        P0[names.index(k)] = v
    w = np.array([p.propose_width for p in tpost.space.varying])
    V = w * np.random.default_rng(20261019).standard_normal((2, len(w)))
    return dict(jpost=jpost, tpost=tpost, names=names, P0=P0, V=V)


@pytest.fixture(scope="module")
def jax_side(posts):
    jpost, P0, V = posts["jpost"], jnp.asarray(posts["P0"]), jnp.asarray(posts["V"])
    f = lambda p: jpost.logpost()(p)[0]
    mll, jvps = jax.jit(lambda p, V: jax.vmap(
        lambda v: jax.jvp(f, (p,), (v,)), out_axes=(None, 0))(V))(P0, V)

    def tau0(full):
        bg = jpost.parameterization.to_background(full)
        yhe = j_yhe_bbn(bg.ombh2, bg.nnu - 3.046, jpost.bbn_table)
        return j_thermo_funcs(bg, yhe, full[jpost._i_tau],
                              n_step=jpost.n_step_boltzmann, kmax=jpost.kmax)[1]
    return dict(mll=float(mll), jvp=np.asarray(jvps),
                tau0=float(jax.jit(tau0)(jpost.embed_full(P0))))


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
    slow = _held(seen["slow"])
    own = _semi_fast_grad(tpost, P, slow)
    with torch.no_grad():
        _, tau0 = t_thermo_funcs(slow["bg"], slow["yhe"],
                                 compute_thermo(slow["bg"], slow["yhe"]),
                                 slow["zre"], n_step=tpost.n_step_boltzmann,
                                 kmax=tpost.kmax)
    return dict(mll=float(m.detach()), g=g[0].numpy(), g_semi_own=own,
                tau0=float(tau0[0]))


def test_tau0_gap(jax_side, port_side):
    """The packages' tau0 at the point, and their gap in ulps: the input
    to the tensor line of sight's last node that (a)'s tolerance is
    stated from."""
    j, t = jax_side["tau0"], port_side["tau0"]
    ulps = (t - j) / np.spacing(j)
    print(f"tau0 JAX {j!r} port {t!r}: {ulps:+.0f} ulps")
    assert abs(ulps) <= 64


@pytest.mark.parametrize("direction", [0, 1])
def test_full_gradient_matches_jax_jvp(posts, jax_side, port_side, direction):
    """(a): the directional derivative of -logL, and -logL."""
    got = float(port_side["g"] @ posts["V"][direction])
    ref = float(jax_side["jvp"][direction])
    gap_mll = abs(port_side["mll"] - jax_side["mll"]) / abs(jax_side["mll"])
    print(f"-logL port {port_side['mll']!r} JAX {jax_side['mll']!r} (rel "
          f"{gap_mll:.3e}); direction {direction}: port {got!r} JAX {ref!r} "
          f"(rel {abs(got - ref) / abs(ref):.3e})")
    assert np.isfinite(port_side["g"]).all()
    assert gap_mll <= MLL_RTOL
    assert abs(got - ref) <= JVP_RTOL * abs(ref), (got, ref)


@pytest.mark.parametrize("name", SEMI)
def test_full_gradient_semi_components(posts, port_side, name):
    """(b): along r, logA and ns the slow stage is constant, so the full
    gradient is the held-cache one; r's is not 0 (the tensor C_l reach
    plik_lite's TT, TE and EE)."""
    i = posts["names"].index(name)
    got, ref = port_side["g"][i], port_side["g_semi_own"][i]
    assert ref != 0 and abs(got - ref) <= SELF_RTOL * abs(ref), (got, ref)
