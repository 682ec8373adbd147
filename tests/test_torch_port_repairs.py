"""The port's repaired faults against the JAX package: the implicit
derivatives of the two bisections (H0 from theta, z_re from tau), the
slow stage and K3's wrapper refusing a gradient they cannot give (the
kernels have no reverse pass yet; the semi + fast gradient with the slow
cache held, on the CPU, is tested in test_torch_slice_sampler.py, on that
file's slow cache), and the
public functions of ported modules that the port lacked (the spline
derivative and integral, clamped spline ends, the bicubic grid, linear
interpolation, the BBN Yp^BBN and error lookups, compute_cmb_theory).
CMBPosterior's compute_theory, per_likelihood and inflation_consistency
are tested where both packages' posteriors are already built
(test_torch_extended_config.py, test_torch_lss_astro.py,
test_torch_lcdm_r.py), compute_cls, cls_from_transfers and
compute_tensor_cls beside their fixtures (test_torch_cls.py,
test_torch_tensors.py).

float64 on the CPU. Gradients 1e-8 relative to jax.grad (second
derivatives 1e-7); interpolation and BBN lookups 1e-12 of each maximum.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import bbn as jbbn
from cosmomc_tpu.models import reionization as jreion
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JTheta
from cosmomc_tpu.utils import interp as jinterp

from cosmomc_tpu_torch.models import bbn as tbbn
from cosmomc_tpu_torch.models import cmb as tcmb
from cosmomc_tpu_torch.models import reionization as treion
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.models.background import BackgroundParams as TBG
from cosmomc_tpu_torch.params.parameterizations import AstroParameterization as TAstro
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TTheta
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.utils import interp as tinterp

F64 = torch.float64
GRAD_RTOL, HESS_RTOL, RTOL = 1e-8, 1e-7, 1e-12


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


def _centre():
    """The theta parameterization's full default vector."""
    return np.array([p.center for p in TTheta().default_space().params])


# ------------------------------------------------------------- gradients

def test_h0_gradient_through_to_background():
    """dH0/d(ombh2, omch2, theta) through ThetaParameterization
    .to_background against jax.grad at the default centre, and the second
    derivatives (the Newton step's f_H0 keeps its graph)."""
    full = _centre()
    jpar = JTheta(jnp.float64)
    jH0 = lambda f: jpar.to_background(f).H0
    j_val = float(jH0(jnp.asarray(full)))
    j_grad = np.asarray(jax.grad(jH0)(jnp.asarray(full)))
    # rows of the Hessian along ombh2, omch2, theta: one JVP each
    j_hess = np.stack([np.asarray(jax.jvp(jax.grad(jH0), (jnp.asarray(full),),
                                          (jnp.eye(len(full))[i],))[1])
                       for i in range(3)])
    x = torch.tensor(full[None], dtype=F64, requires_grad=True)
    H0 = TTheta().to_background(x).H0
    (g,) = torch.autograd.grad(H0.sum(), x, create_graph=True)
    assert H0.item() == pytest.approx(67.19117329716795, rel=1e-13)
    assert H0.item() == pytest.approx(j_val, rel=1e-13)
    np.testing.assert_allclose(g[0, :3].detach().numpy(), j_grad[:3],
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(j_grad[:3], [821.796, -350.098, 333.821],
                               rtol=1e-5)
    for i in range(3):
        (h,) = torch.autograd.grad(g[0, i], x, retain_graph=True)
        np.testing.assert_allclose(h[0, :3].numpy(), j_hess[i, :3],
                                   rtol=HESS_RTOL,
                                   atol=HESS_RTOL * np.abs(j_hess[:, :3]).max())


class _Reached(Exception):
    """Raised by a stubbed first step of the slow stage: the guard let the
    call through."""


@pytest.mark.parametrize("kind", ["theta", "astro"])
def test_slow_stage_refuses_gradients(kind, monkeypatch):
    """A gradient through the full posterior raises NotImplementedError
    before any work, on the CMB path and on the LSS-only astro path (which
    runs K4 and K1); without a gradient the call goes through."""
    par = TTheta() if kind == "theta" else TAstro()
    post = TPost(par, par.default_space(), TLikes(), lmax=100,
                 bbn_table=tbbn.synthetic_bbn_table(), use_cmb=kind == "theta",
                 matter_power=kind == "astro", device="cpu", dtype=F64)
    P = torch.tensor([[p.center for p in post.space.varying]], dtype=F64,
                     requires_grad=True)

    def reached(*a):
        raise _Reached
    monkeypatch.setattr(post.parameterization, "to_background", reached)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        torch.autograd.grad(post.logpost()(P)[0].sum(), P)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        post.stage_slow(post.embed_full(P))
    with pytest.raises(_Reached):
        post.stage_slow(post.embed_full(P.detach()))
    with torch.no_grad(), pytest.raises(_Reached):
        post.stage_slow(post.embed_full(P))


def test_lensing_kernel_refuses_gradients(monkeypatch):
    """lens_cls on the kernel's route (K3's wrapper, its launch stubbed)
    raises NotImplementedError before any launch when its spectra want a
    gradient, as the semi stage's would; without one the call reaches the
    launch. The plain version on CPU tensors keeps its gradient."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.models import lensing as tlens
    rng = np.random.default_rng(3)
    ls = torch.arange(2, 81, dtype=F64)
    spectra = torch.tensor(1.0 + rng.random((4, 2, 79)), dtype=F64,
                           requires_grad=True)

    def reached(*a):
        raise _Reached
    monkeypatch.setattr(tlens, "_passes_grid_plain", tlens._passes_cuda)
    monkeypatch.setattr(kernels, "check", lambda *a: None)
    monkeypatch.setattr(kernels, "launch", reached)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        tlens.lens_cls(ls, *spectra, lmax_lensed=60)
    with pytest.raises(_Reached):
        tlens.lens_cls(ls, *spectra.detach(), lmax_lensed=60)
    with torch.no_grad(), pytest.raises(_Reached):
        tlens.lens_cls(ls, *spectra, lmax_lensed=60)
    monkeypatch.undo()
    out = tlens.lens_cls(ls, *spectra, lmax_lensed=60)
    (g,) = torch.autograd.grad(out.bb.sum() + out.tt.sum(), spectra)
    assert bool(torch.isfinite(g).all()) and bool((g[3] != 0).any())


def test_bisections_carry_no_graph_without_gradients():
    """Sampling calls (no input wants a gradient) get plain tensors."""
    bg = TTheta().to_background(torch.tensor(_centre()[None], dtype=F64))
    assert not bg.H0.requires_grad
    zre = treion.zre_from_tau(bg, torch.tensor([0.0543], dtype=F64),
                              torch.tensor([0.2454], dtype=F64))
    assert not zre.requires_grad


def test_zre_gradient():
    """d z_re / d tau at tau = 0.0543 and d z_re / d(ombh2, omch2, theta)
    through the default centre's background (H0 from theta included),
    against jax.grad, with the second derivatives of d z_re / d tau."""
    yhe = 0.245
    full = _centre()
    jpar = JTheta(jnp.float64)

    def j_zre(tau, f):
        return jreion.zre_from_tau(jpar.to_background(f), tau, yhe)
    args = (jnp.asarray(0.0543), jnp.asarray(full))
    j_gt, j_gf = jax.grad(j_zre, argnums=(0, 1))(*args)
    j_h = float(jax.grad(jax.grad(j_zre))(*args))
    tau = torch.tensor([0.0543], dtype=F64, requires_grad=True)
    x = torch.tensor(full[None], dtype=F64, requires_grad=True)
    zre = treion.zre_from_tau(TTheta().to_background(x), tau,
                              torch.tensor([yhe], dtype=F64))
    assert zre.item() == pytest.approx(float(j_zre(*args)), rel=1e-13)
    g_tau, g_x = torch.autograd.grad(zre.sum(), (tau, x), create_graph=True)
    assert g_tau.item() == pytest.approx(float(j_gt), rel=GRAD_RTOL)
    assert float(j_gt) == pytest.approx(102.785, rel=1e-5)
    np.testing.assert_allclose(g_x[0, :3].detach().numpy(),
                               np.asarray(j_gf)[:3], rtol=GRAD_RTOL)
    # the second derivative: in tau 0 in both (f_z does not see tau, the
    # midpoint being detached), in theta through f_z's graph
    (h,) = torch.autograd.grad(g_tau.sum(), tau, retain_graph=True,
                               allow_unused=True)
    assert (0.0 if h is None else h.item()) == j_h == 0.0
    j_hx = np.asarray(jax.grad(jax.grad(j_zre), argnums=1)(*args))
    (hx,) = torch.autograd.grad(g_tau.sum(), x)
    np.testing.assert_allclose(hx[0, :3].numpy(), j_hx[:3], rtol=HESS_RTOL)


# ------------------------------------------------------- interpolation

@pytest.fixture(scope="module")
def knots():
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0.0, 10.0, 23))
    y = np.sin(x) + 0.1 * x ** 2 + rng.normal(0, 0.05, (3, 23))
    xq = np.concatenate([np.linspace(-0.5, 10.5, 97), x[:4]])
    return x, y, xq


@pytest.mark.parametrize("bc", [(None, None), (0.3, None), (None, -1.2),
                                (0.3, -1.2)])
def test_spline_ends_deriv_integral(knots, bc):
    """spline_fit with natural or clamped ends, spline_eval,
    spline_eval_deriv and spline_integral; three value rows at once in the
    port, one at a time in JAX."""
    x, y, xq = knots
    sp = tinterp.spline_fit(torch.as_tensor(x), torch.as_tensor(y),
                            bc_start=bc[0], bc_end=bc[1])
    tq = torch.as_tensor(xq)
    for r in range(3):
        jsp = jinterp.spline_fit(jnp.asarray(x), jnp.asarray(y[r]),
                                 bc_start=bc[0], bc_end=bc[1])
        assert_close(sp.y2[r], jsp.y2)
        assert_close(tinterp.spline_eval(sp, tq)[r],
                     jinterp.spline_eval(jsp, jnp.asarray(xq)))
        assert_close(tinterp.spline_eval_deriv(sp, tq)[r],
                     jinterp.spline_eval_deriv(jsp, jnp.asarray(xq)))
        assert_close(tinterp.spline_integral(sp)[r],
                     jinterp.spline_integral(jsp))
    if bc[0] is not None:
        d0 = tinterp.spline_eval_deriv(sp, torch.as_tensor(x[:1]))
        np.testing.assert_allclose(d0[:, 0].numpy(), bc[0], rtol=1e-12)


def test_spline_per_row_queries(knots):
    """Queries of one row per value row (..., m) gather that row's
    coefficients: equal to evaluating each row alone."""
    x, y, xq = knots
    sp = tinterp.spline_fit(torch.as_tensor(x), torch.as_tensor(y))
    rows = torch.as_tensor(np.stack([xq, xq[::-1], 0.5 * xq]))
    for fn in (tinterp.spline_eval, tinterp.spline_eval_deriv):
        out = fn(sp, rows)
        for r in range(3):
            one = tinterp.Spline(sp.x, sp.y[r], sp.y2[r])
            assert torch.equal(out[r], fn(one, rows[r]))


def test_grid2d_and_linear_interp():
    rng = np.random.default_rng(3)
    gx, gy = np.linspace(0.0, 2.0, 17), np.linspace(-1.0, 1.0, 11)
    gz = np.cos(gx)[:, None] * np.exp(gy)[None, :] + rng.normal(0, 1e-3,
                                                                 (17, 11))
    xq = rng.uniform(-0.2, 2.2, (5, 7))
    yq = rng.uniform(-1.2, 1.2, (5, 7))
    g = tinterp.Grid2D(*(torch.as_tensor(a) for a in (gx, gy, gz)))
    jg = jinterp.Grid2D(*(jnp.asarray(a) for a in (gx, gy, gz)))
    assert_close(tinterp.grid2d_eval(g, torch.as_tensor(xq),
                                     torch.as_tensor(yq)),
                 jinterp.grid2d_eval(jg, jnp.asarray(xq), jnp.asarray(yq)))
    xp = np.sort(rng.uniform(0, 1, 30))
    fp = rng.normal(size=30)
    q = np.linspace(-0.1, 1.1, 50)
    assert_close(tinterp.linear_interp(torch.as_tensor(q), torch.as_tensor(xp),
                                       torch.as_tensor(fp)),
                 jinterp.linear_interp(jnp.asarray(q), jnp.asarray(xp),
                                       jnp.asarray(fp)))


# ----------------------------------------------------------------- BBN

def test_bbn_ypbbn_and_errors():
    """ypbbn_bbn and bbn_errors on the synthetic table (also off its
    edges) against JAX, per chain."""
    tab = tbbn.synthetic_bbn_table()
    jtab = jbbn.BBNTable(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                         *(jnp.asarray(getattr(tab, f))
                           for f in tbbn.GRID_FIELDS))
    t = tab.to("cpu", F64)
    omb = np.array([0.004, 0.0224, 0.03, 0.06])
    dn = np.array([0.0, 0.5, -1.3, 2.5])
    o, d = torch.as_tensor(omb), torch.as_tensor(dn)
    yp = tbbn.ypbbn_bbn(o, d, t)
    sy, sd_ = tbbn.bbn_errors(o, d, t)
    for i in range(4):
        assert_close(yp[i], jbbn.ypbbn_bbn(omb[i], dn[i], jtab))
        js = jbbn.bbn_errors(omb[i], dn[i], jtab)
        assert_close(sy[i], js[0])
        assert_close(sd_[i], js[1])


# ------------------------------------------------------ compute_cmb_theory

def test_compute_cmb_theory_composition(monkeypatch):
    """compute_cmb_theory is the composition of the ported stages: the
    recombination history and z_re at the given (bg, tau, yhe), the
    transfers on source_k_grid(kmax), and cls_from_transfers (held against
    JAX in test_torch_cls.py) at bg's temperature, lmax and that grid."""
    seen = {}
    bg = TBG.make(nchains=2)
    tau = torch.tensor([0.05, 0.06], dtype=F64)
    yhe = torch.tensor([0.245, 0.246], dtype=F64)

    def thermo(b, y):
        seen["thermo"] = (b, y)
        return "th"

    def zre(b, t, y):
        seen["zre"] = (b, t, y)
        return "zre"

    class PO:
        tau0 = torch.tensor([14000.0, 14100.0], dtype=F64)

    def transfers(b, th, z, y, k):
        seen["transfers"] = (b, th, z, y, k)
        return PO, "chi", "tf"

    def cls(po, chi, pp, tcmb_k, lmax, coarse_k):
        seen["cls"] = (po, chi, pp, tcmb_k, lmax, coarse_k)
        return "spectra"
    for name, fn in (("compute_thermo", thermo), ("zre_from_tau", zre),
                     ("compute_transfers", transfers),
                     ("cls_from_transfers", cls)):
        monkeypatch.setattr(tcmb, name, fn)
    out = tcmb.compute_cmb_theory(bg, "pp", tau, yhe, lmax=900, kmax=0.2)
    assert out == tcmb.CMBTheory("spectra", PO, "chi", PO.tau0)
    assert seen["thermo"] == (bg, yhe) and seen["zre"] == (bg, tau, yhe)
    b, th, z, y, k = seen["transfers"]
    assert (b, th, z, y) == (bg, "th", "zre", yhe)
    np.testing.assert_array_equal(k, tcmb.source_k_grid(0.2))
    po, chi, pp, tk, lmax, ck = seen["cls"]
    assert (po, chi, pp, lmax) == (PO, "chi", "pp", 900)
    assert torch.equal(tk, bg.tcmb[:, None]) and ck is k
