"""Which configurations take a gradient through the slow stage, on the CPU
(no theory is evaluated: the first step of the slow stage is stubbed).

`CMBPosterior.gradient_unsupported()` is the one predicate: the recurrence
line of sight (K2b) has a kernel without a reverse pass, and there
`stage_slow` and the driver's action 2 and sampling_method = hmc raise
NotImplementedError before any work; the flagship CMB path (K4, K1, K2a,
K3), with matter power or under the SPT configuration's high-l splice,
LCDM+r (the tensor kernels K5, K6), the massive-neutrino hierarchy and the
dark-energy fluid (K1's extended instantiations), and the LSS-only astro
configuration let the gradient through. The wrappers of the reverse
kernels, K1's four instantiations and the tensor kernels among them, take
no plain fallback on CPU tensors.
"""

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch import driver as tdriver
from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch import pipeline as tpipe
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models import lensing as tlens
from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import (AstroParameterization,
                                                        ThetaParameterization)
from cosmomc_tpu_torch.pipeline import CMBPosterior

F64 = torch.float64
#: the configurations: (parameterization, CMBPosterior switches)
CONFIGS = {
    "astro": (AstroParameterization, dict(use_cmb=False, matter_power=True)),
    "theta": (ThetaParameterization, dict(use_cmb=True)),
    "theta_mp": (ThetaParameterization, dict(use_cmb=True, matter_power=True)),
    "spt": (ThetaParameterization, dict(use_cmb=True, lmax=400,
                                        lmax_computed=200)),
    "lcdm_r": (ThetaParameterization, dict(use_cmb=True, compute_tensors=True)),
    "recurrence": (ThetaParameterization, dict(use_cmb=True,
                                               los_method="recurrence")),
    "theta_mnu": (ThetaParameterization, dict(use_cmb=True,
                                              massive_nu_hierarchy=True)),
    "astro_mnu": (AstroParameterization, dict(use_cmb=False, matter_power=True,
                                              massive_nu_hierarchy=True)),
    "astro_de": (AstroParameterization, dict(use_cmb=False, matter_power=True,
                                             de_perturbations=True)),
}
SUPPORTED = {"astro", "theta", "theta_mp", "spt", "lcdm_r", "theta_mnu",
             "astro_mnu", "astro_de"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Reached(Exception):
    """Raised by the stubbed first step of the slow stage."""


@pytest.fixture(scope="module")
def highl_template(tmp_path_factory):
    """A flat high-l template (the SPT configuration's splice)."""
    path = tmp_path_factory.mktemp("guard") / "highl.dat"
    ls = np.arange(2, 501)
    np.savetxt(path, np.column_stack([ls] + [c + 0 * ls for c in
                                             (1000.0, 10.0, 0.1, 1.0)]))
    return str(path)


def _posterior(kind, template=""):
    par, sw = CONFIGS[kind]
    par = par()
    sw = dict(dict(lmax=100), **sw)
    return CMBPosterior(par, par.default_space(), LikelihoodList(),
                        bbn_table=synthetic_bbn_table(), device="cpu",
                        dtype=F64, highl_template=template, **sw)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_stage_slow_guard(kind, monkeypatch, highl_template):
    post = _posterior(kind, highl_template)
    if kind == "spt":
        assert 0 < post.lmax_computed < post.lmax
    assert (post.gradient_unsupported() is None) == (kind in SUPPORTED)
    P = torch.tensor([[p.center for p in post.space.varying]], dtype=F64,
                     requires_grad=True)

    def reached(*a):
        raise _Reached
    monkeypatch.setattr(post.parameterization, "to_background", reached)
    if kind in SUPPORTED:
        with pytest.raises(_Reached):
            torch.autograd.grad(post.logpost()(P)[0].sum(), P)
    else:
        with pytest.raises(NotImplementedError, match="no reverse pass"):
            torch.autograd.grad(post.logpost()(P)[0].sum(), P)
        with pytest.raises(NotImplementedError):
            post.stage_slow(post.embed_full(P))
    with torch.no_grad(), pytest.raises(_Reached):
        post.stage_slow(post.embed_full(P))


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("grad_guard")
    mpk = sd.write_lrg_mpk(str(d), sd.lrg_layout())
    return (f"parameterization = astro\nuse_mpk = T\nmpk_numdatasets = 1\n"
            f"mpk_dataset1 = {mpk}\n"
            f"bbn_table = {sd.write_bbn_table(str(d / sd.BBN_TABLE_NAME))}\n")


@pytest.mark.parametrize("body", ["action = 2", "sampling_method = hmc"])
@pytest.mark.parametrize("extra", ["", "param[mnu] = 0.06 0 5 0.1 0.03",
                                   "param[w] = -1 -3 1 0.1 0.05"])
def test_driver_dispatch(tmp_path, sets, monkeypatch, body, extra):
    """The astro ini reaches the minimizer and HMC (stubbed here), also
    with mnu or w free (the massive-neutrino hierarchy, the DE fluid, whose
    K1 instantiations have reverse kernels), before any theory or
    kernel."""
    from cosmomc_tpu_torch.sampling import hmc, minimize

    def stub(*a, **k):
        raise _Reached
    monkeypatch.setattr(minimize, "find_best_fit", stub)
    monkeypatch.setattr(hmc, "HMCSampler", stub)
    monkeypatch.setattr(tpipe.CMBPosterior, "stage_slow", stub)
    ini = tmp_path / "astro.ini"
    ini.write_text(f"file_root = {tmp_path}/c/astro\n{sets}{body}\n{extra}\n")
    post = tdriver.build_posterior(tdriver.IniFile(str(ini)), device="cpu")
    assert post.remat_chunks == (64 if "hmc" in body else 0)
    assert post.gradient_unsupported() is None
    assert post.massive_nu_hierarchy == ("mnu" in extra)
    assert post.de_perturbations == ("param[w]" in extra)
    kernels.reset_launches()
    with pytest.raises(_Reached):
        tdriver.run_ini(str(ini), device="cpu")
    assert not any(kernels.launches.values())


def test_remat_key_sets_the_checkpoints(tmp_path, sets):
    ini = tmp_path / "astro.ini"
    ini.write_text(f"{sets}sampling_method = hmc\n"
                   "boltzmann_remat_chunks = 16\n")
    post = tdriver.build_posterior(tdriver.IniFile(str(ini)), device="cpu")
    assert post.remat_chunks == 16 and post.gradient_unsupported() is None


def test_reverse_wrappers_take_no_plain_path():
    """On CPU tensors that want a gradient the card's wrappers go to their
    kernels, which refuse CPU tensors: no plain fallback."""
    zt = torch.zeros(1, trec.N_ZT, 8, dtype=F64, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trec._scan_cuda(zt, torch.ones(1, dtype=F64))
    q = torch.zeros(1, 4, 3, tpert.NQ, dtype=F64, requires_grad=True)
    k = torch.ones(2, dtype=F64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpert._evolve_cuda(q, k, torch.ones(1, dtype=F64), tpert.RSA_KTAU)
    # K2a and K3, through their autograd Functions
    key = (60, 14200.0, 0.01, 4.0, 256, tuple(np.geomspace(1e-4, 0.01, 6)))
    dp = tcls._device_plan(key, "cpu", F64)
    src = torch.zeros(1, 4, 6, 8, dtype=F64, requires_grad=True)
    w = torch.ones(1, 8, dtype=F64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcls._Los.apply(src, w, w, w, dp, 5.0)
    cl = torch.ones(1, 4, 79, dtype=F64, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tlens._passes_cuda(cl, 160, True, 59)


def test_tensor_wrappers_refuse_cpu_tensors():
    """K5 and K6 take their reverse kernels when a gradient is wanted
    (`_Tensors`, `_TensorLos`), and on CPU tensors those refuse rather than
    run the plain version; the reverse wrappers refuse them too."""
    from cosmomc_tpu_torch.models import tensors as tten
    q = torch.zeros(1, 4, 4, tten.NQT, dtype=F64, requires_grad=True)
    k = torch.ones(2, dtype=F64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tten._evolve_t_cuda(q, k, 1, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tten._tensors_bwd(q.detach(), k, torch.zeros(1, 2, 2, tten.NVAR_T, dtype=F64),
                          torch.zeros(3, 1, 4, 2, dtype=F64), 1, True, 4)
    kt = tten.tensor_k_grid(kmax=0.01, nk=6)
    grid = tten._tlos_grid(60, 14700.0, 0.01, 4.0, tuple(kt.tolist()), "cpu", F64)
    tabs = tten.tlos_tables(tuple(grid["ls"].long().tolist()), 0.01 * 14700.0 * 1.02 + 10,
                            "cpu")
    src = torch.zeros(1, 2, 6, 8, dtype=F64, requires_grad=True)
    w = torch.ones(1, 8, dtype=F64)
    rest = (grid["lo"], grid["hi"], grid["w"], grid["kf"], tabs["jl"], tabs["jlp"],
            grid["ls"], 5.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tten._TensorLos.apply(src, w, w, rest, grid)
    assert {"tensors_bwd", "tensor_los_bwd"} <= set(kernels.launches)
    assert kernels.VARIANTS["tensors_bwd"] == "tensors"
    assert kernels.VARIANTS["tensor_los_bwd"] == "tensor_los"


@pytest.mark.parametrize("sw", [(True, False), (False, True), (True, True)])
def test_extended_instantiations_refuse_cpu_tensors(sw):
    """K1's extended instantiations take their reverse kernels when a
    gradient is wanted, and on CPU tensors those refuse (ValueError, as
    every kernel wrapper does) rather than run the plain version."""
    massive_nu, de_perts = sw
    q = torch.zeros(1, 4, 3, tpert.q_fields(massive_nu, de_perts), dtype=F64,
                    requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpert._evolve_cuda(q, torch.ones(2, dtype=F64),
                           torch.ones(1, dtype=F64), tpert.RSA_KTAU,
                           massive_nu, de_perts)
    assert tpert.BWD_VARIANTS[sw] in kernels.SOURCES


def test_bwd_lanes_match_the_kernel_layout():
    """csrc/boltzmann_bwd.cu's blocks and threads of the reverse kernel, as
    the wrapper sizes its scratch: up to 256 lanes a block, at least 64
    threads, a whole number of warps."""
    for nk, want in ((8, (1, 64)), (216, (1, 224)), (248, (1, 256)),
                     (256, (1, 256)), (300, (2, 256))):
        assert tpert._bwd_lanes(nk) == want
    assert np.all([tpert._bwd_lanes(n)[1] % 32 == 0 for n in range(1, 600)])


def test_hessian_from_gradient_differences():
    """estimate_covariance with `gradient_differences` (what action 2 takes
    where the reverse kernels have no second derivative): the inverse of
    the central differences of exact gradients, on a correlated Gaussian
    -logL whose Hessian is known, equals its covariance."""
    from cosmomc_tpu_torch.sampling.minimize import estimate_covariance
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 4))
    cov = A @ A.T + 4.0 * np.eye(4)
    icov = torch.as_tensor(np.linalg.inv(cov), dtype=F64)
    mu = torch.as_tensor(rng.standard_normal(4), dtype=F64)

    def logpost(P):
        d = P - mu
        return 0.5 * torch.einsum("ci,ij,cj->c", d, icov, d), P[:, :0]
    got = estimate_covariance(logpost, mu.numpy() + 0.1, device="cpu",
                              gradient_differences=np.full(4, 1e-3))
    np.testing.assert_allclose(got, cov, rtol=1e-9, atol=1e-12)
    exact = estimate_covariance(logpost, mu.numpy(), device="cpu")
    np.testing.assert_allclose(exact, cov, rtol=1e-9, atol=1e-12)
    # at a bound the difference is one-sided, inside it
    x = mu.numpy() + 0.1
    lo = x - np.array([0.0, 1.0, 0.0, 1.0])
    at_bound = estimate_covariance(logpost, x, device="cpu",
                                   gradient_differences=np.full(4, 1e-3),
                                   bounds=(lo, x + np.array([1.0, 0.0, 1.0, 0.0])))
    np.testing.assert_allclose(at_bound, cov, rtol=1e-9, atol=1e-12)


def test_hessian_step_spans_gradient_jumps():
    """Action 2's step (driver.HESSIAN_STEP proposal widths) on a -logL
    whose exact gradient jumps, as a table interpolant's slope does: a
    correlated Gaussian plus a triangle wave of period 1e-4 whose slope
    flips by 2a. At a point just below a downward flip in every
    coordinate, differences over 1e-3 widths read the flip as curvature;
    over HESSIAN_STEP widths each diagonal element moves by at most
    a / h, which bounds the covariance's error by 3% of its maximum. The
    covariance written is symmetric bit for bit."""
    from cosmomc_tpu_torch.sampling.minimize import estimate_covariance
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 4))
    cov = A @ A.T + 4.0 * np.eye(4)
    icov = torch.as_tensor(np.linalg.inv(cov), dtype=F64)
    mu = rng.standard_normal(4)
    width = np.sqrt(np.diag(cov))
    a, period = 3e-4, 1e-4

    def logpost(P):
        d = P - torch.as_tensor(mu, dtype=F64)
        wave = period * torch.abs(torch.frac(P / period) - 0.5).sum(1)
        return 0.5 * torch.einsum("ci,ij,cj->c", d, icov, d) + a * wave, P[:, :0]
    x = (np.floor(mu / period) + 1.0 - 1e-3) * period

    def error(step):
        got = estimate_covariance(logpost, x, device="cpu",
                                  gradient_differences=step * width)
        assert np.array_equal(got, got.T)
        return np.abs(got - cov).max() / np.abs(cov).max()
    assert error(tdriver.HESSIAN_STEP) <= 0.03
    assert error(1e-3) > 0.5


def test_r_minus_1_without_enough_samples_is_nan():
    """HMC on the LSS-only configuration (29 parameters) computes R-1 after
    segments shorter than that: the within-chain covariance is singular
    there, and gelman_rubin_r_device gives NaN, as jnp.linalg.cholesky
    does in the JAX package, instead of raising; with enough samples the
    value is unchanged."""
    from cosmomc_tpu_torch.sampling.convergence import (gelman_rubin_r,
                                                        gelman_rubin_r_device)
    rng = np.random.default_rng(1)
    short = torch.as_tensor(rng.standard_normal((8, 4, 29)), dtype=F64)
    assert torch.isnan(gelman_rubin_r_device(short))
    x = rng.standard_normal((8, 64, 3))
    xc = x - x.mean(1, keepdims=True)
    covs = np.einsum("csi,csj->cij", xc, xc) / x.shape[1]
    np.testing.assert_allclose(
        float(gelman_rubin_r_device(torch.as_tensor(x, dtype=F64))),
        gelman_rubin_r(x.mean(1), covs), rtol=1e-12)
