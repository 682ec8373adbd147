"""Port parity of the DES 1YR 3x2pt likelihood (likelihoods/wl.py).

The DES files are not in the repository: `synthetic.write_des_wl` writes
DES 1YR's layout (4 source and 5 lens bins, 20 theta bins, 900 rows, scale
cuts keeping about half) to tmp, with the rows computed by the port's
reader on the keep-all selection at chain 0's theory and the nuisance
centres. The
theory is two chains of smooth synthetic P(k, z) tables (linear and a
'nonlinear' small-scale boost) to z = 3.6, each with its own background,
given to JAX one chain at a time and to the port batched. float64 on the
CPU. Tolerances: the loaded operands 1e-12 of each array's maximum;
theory vectors 1e-10 of each 2pt type's maximum; -logL 1e-10 relative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.wl import WLLikelihood as JWL
from cosmomc_tpu.models import background as jbgm
from cosmomc_tpu.models.background import BackgroundParams as JBG
from cosmomc_tpu.models.matterpower import MatterPower as JMP
from cosmomc_tpu.models.theory import CMBTheoryProducts as JTheory

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.wl import WLLikelihood as TWL
from cosmomc_tpu_torch.models import background as tbgm
from cosmomc_tpu_torch.models.theory import CMBTheoryProducts as TTheory

F64 = torch.float64
OPS_RTOL, VEC_RTOL, LL_RTOL = 1e-12, 1e-10, 1e-10
#: (H0, omch2, amplitude, tilt) per chain
CHAINS = np.array([[67.3, 0.120, 1.00, 0.00], [70.1, 0.115, 1.07, 0.03]])
ZS = np.concatenate([np.linspace(0.0, 1.0, 11), np.linspace(1.2, 3.6, 9)])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"rel err {err:.3e} > {rtol:.1e}"


def _tables(h, amp, tilt):
    """ln P (linear, 'nonlinear', Weyl) on a shared (z, k) grid, and sigma8
    and f sigma8 tables."""
    k = np.logspace(-4, np.log10(20.0), 400)
    kh = k / h
    P_h = 2.4e4 * amp * (kh / 0.015) ** (1 + tilt) / (1 + (kh / 0.015) ** 2.8)
    growth = 1.0 / (1.0 + 0.55 * ZS)
    lnP = np.log(P_h / h ** 3)[None] + 2 * np.log(growth)[:, None]
    lnP_nl = lnP + np.log1p((kh / 0.3) ** 1.5)[None]
    s8 = 0.81 * np.sqrt(amp) * growth
    return k, lnP, lnP_nl, lnP - 2.0, s8, s8 * (0.55 - 0.1 * ZS)


@pytest.fixture(scope="module")
def theories():
    """(JAX CMBTheoryProducts per chain, the port's batched theory)."""
    jbg = [JBG.make(ombh2=0.0224, omch2=c[1], H0=c[0]) for c in CHAINS]
    jth, tabs = [], []
    for bg, c in zip(jbg, CHAINS):
        k, *tab = _tables(c[0] / 100.0, c[2], c[3])
        tabs.append(tab)
        mp = JMP(*(jnp.asarray(x) for x in (k, ZS, *tab, c[0] / 100.0)))
        jth.append(JTheory(bg, jbgm.background_functions(bg),
                           jnp.asarray(147.0), z_pk=mp.z, sigma8_z=mp.sigma8_z,
                           fsigma8_z=mp.fsigma8_z, mp=mp))
    stack = [np.stack(x) for x in zip(*tabs)]
    mp = convert.matter_power(JMP(k, ZS, *stack, CHAINS[:, 0] / 100.0))
    tbg = convert.background_params(jax.tree_util.tree_map(
        lambda *x: jnp.stack(x), *jbg))
    tth = TTheory(tbg, tbgm.background_functions(tbg),
                  torch.full((2,), 147.0, dtype=F64), z_pk=mp.z,
                  sigma8_z=mp.sigma8_z, fsigma8_z=mp.fsigma8_z, mp=mp)
    return jth, tth


def centers(like):
    return np.array([p.center for p in like.nuisance if p.varying])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, theories):
    """A DES set whose rows are the port's theory at chain 0's centres
    (the keep-all reader; JAX's equals it to VEC_RTOL, below)."""
    _, tth = theories
    d = str(tmp_path_factory.mktemp("des"))
    ds = sd.write_des_wl(d)
    keep = TWL(ds, dataset_overrides={"data_selection": "DES_1YR_synthetic"
                                      + sd.DES_ALL_SCALES}, device="cpu")
    return sd.write_des_wl(d, sd.des_wl_rows(keep, tth))


@pytest.fixture(scope="module")
def likes(dataset):
    return JWL(dataset), TWL(dataset, device="cpu")


@pytest.fixture(scope="module")
def jax_tvec(likes):
    jl = likes[0]
    return jax.jit(lambda th, nu: jl.theory_vector(th, nu))


def jax_vectors(jax_tvec, jth, nus):
    return np.stack([np.asarray(jax_tvec(th, jnp.asarray(nu)))
                     for th, nu in zip(jth, nus)])


def type_mask(like, tp):
    return np.array([like.data_types[ti] == tp
                     for (ti, b1, b2, tb) in like.used_items])


def assert_by_type(like, port, ref):
    for tp in range(4):
        sel = type_mask(like, tp)
        assert_close(port[:, sel], ref[:, sel], VEC_RTOL)


def test_loaded_operands(likes):
    jl, tl = likes
    assert 400 <= tl.num_used <= 500 and tl.num_used == jl.num_used
    assert (tl.num_z_bins, tl.num_gal_bins, tl.num_theta_bins) == (4, 5, 20)
    np.testing.assert_array_equal(tl.used_items, jl.used_items)
    np.testing.assert_array_equal(tl.used_indices, jl.used_indices)
    np.testing.assert_array_equal(tl.ls_cl, jl.ls_cl)
    np.testing.assert_array_equal(tl.z_p, jl.z_p)
    np.testing.assert_array_equal(tl.data_vector, jl.data_vector)
    for name in ("M0", "M2", "M4", "inv_cov"):
        assert_close(getattr(tl, name), getattr(jl, name), OPS_RTOL)
    assert [p.name for p in tl.nuisance] == [p.name for p in jl.nuisance]
    assert [(p.center, p.min, p.max, p.prior_mean, p.prior_std)
            for p in tl.nuisance] == [(p.center, p.min, p.max, p.prior_mean,
                                       p.prior_std) for p in jl.nuisance]
    assert tl.required_zmax == jl.required_zmax
    assert not tl.nuisance[sd.DES_NUISANCE.index("DES_z0AI")].varying


@pytest.mark.parametrize("nonlinear", [True, False])
def test_theory_vector(likes, theories, nonlinear):
    """The cut vector at the centres, linear and nonlinear P(k, z)."""
    jl, tl = likes
    jth, tth = theories
    nus = np.tile(centers(tl), (2, 1))
    try:
        jl.use_non_linear = tl.use_non_linear = nonlinear
        port = tl.theory_vector(tth, torch.as_tensor(nus)).numpy()
        fn = jax.jit(lambda th, nu: jl.theory_vector(th, nu))
        ref = jax_vectors(fn, jth, nus)
    finally:
        jl.use_non_linear = tl.use_non_linear = True
    assert_by_type(tl, port, ref)


def _shifted(like, base, changes):
    names = [p.name for p in like.nuisance if p.varying]
    out = base.copy()
    for name, fn in changes.items():
        for i, n in enumerate(names):
            if n.startswith(name):
                out[i] = fn(out[i])
    return out


@pytest.mark.parametrize("case", ["shear_m", "bias", "photoz", "ia"])
def test_nuisance_responses(likes, theories, jax_tvec, case):
    """Each nuisance response against JAX, and the scalings of JAX's
    tests/test_wl.py: xip ~ (1+m1)(1+m2), wtheta ~ b^2, gammat ~ b, a
    source shift moves gammat, the IA amplitude moves xip."""
    jl, tl = likes
    jth, tth = theories
    c = centers(tl)
    change = {"shear_m": {"DES_m": lambda v: 0.1},
              "bias": {"DES_b": lambda v: 2.0 * v},
              "photoz": {"DES_DzS2": lambda v: 0.05},
              "ia": {"DES_AIA": lambda v: 3.0}}[case]
    nus = np.stack([c, _shifted(tl, c, change)])
    port = tl.theory_vector(tth, torch.as_tensor(nus)).numpy()
    ref = jax_vectors(jax_tvec, jth, nus)
    assert_by_type(tl, port, ref)
    # both rows at chain 0's theory for the ratios
    t0, t1 = tl.theory_vector(_chain0(tth), torch.as_tensor(nus)).numpy()
    m = {tp: type_mask(tl, tp) for tp in range(4)}
    if case == "shear_m":
        np.testing.assert_allclose(t1[m[0]] / t0[m[0]], (1.1 / 1.012) ** 2,
                                   rtol=1e-10)
        np.testing.assert_allclose(t1[m[3]], t0[m[3]], rtol=1e-12)
    elif case == "bias":
        np.testing.assert_allclose(t1[m[3]] / t0[m[3]], 4.0, rtol=1e-10)
        np.testing.assert_allclose(t1[m[2]] / t0[m[2]], 2.0, rtol=1e-10)
        np.testing.assert_allclose(t1[m[0]], t0[m[0]], rtol=1e-12)
    elif case == "photoz":
        assert np.max(np.abs(t1[m[2]] / t0[m[2]] - 1.0)) > 0.01
    else:
        assert np.max(np.abs(t1[m[0]] / t0[m[0]] - 1.0)) > 0.005


def _chain0(tth):
    """The port theory with chain 0 repeated twice."""
    pick = lambda x: x[[0, 0]] if torch.is_tensor(x) and x.dim() > 0 \
        and x.shape[0] == 2 else x
    bg = type(tth.bg)(*(pick(getattr(tth.bg, f)) for f in
                        ("ombh2", "omch2", "H0", "omk", "omnuh2", "nnu", "w",
                         "wa", "tcmb")), tth.bg.num_massive_nu)
    mp = tth.mp._replace(**{f: pick(getattr(tth.mp, f))
                            for f in ("lnP", "lnP_nl", "lnP_weyl", "sigma8_z",
                                      "fsigma8_z", "h")})
    return tth._replace(bg=bg, bf=tbgm.background_functions(bg),
                        rs_drag=pick(tth.rs_drag), sigma8_z=mp.sigma8_z,
                        fsigma8_z=mp.fsigma8_z, mp=mp)


def test_log_like_per_chain(likes, theories):
    """-logL per chain against JAX; 0 at the theory the set was written
    from (chain 0, the centres)."""
    jl, tl = likes
    jth, tth = theories
    c = centers(tl)
    nus = np.stack([c, _shifted(tl, c, {"DES_m": lambda v: 0.02})])
    port = tl.log_like(tth, torch.as_tensor(nus)).numpy()
    ref = np.array([float(jl.log_like(th, jnp.asarray(nu)))
                    for th, nu in zip(jth, nus)])
    np.testing.assert_allclose(port[1], ref[1], rtol=LL_RTOL)
    # chi^2/2 at the written theory: 0 up to the rows' rounding
    assert abs(port[0]) < 1e-12 and abs(ref[0]) < 1e-12 and port[1] > 1.0


def test_gradient_in_nuisance(likes, theories):
    _, tl = likes
    _, tth = theories
    nu = torch.tensor(np.tile(centers(tl), (2, 1)) * 1.01,
                      requires_grad=True)
    (g,) = torch.autograd.grad(tl.log_like(tth, nu).sum(), nu)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


def test_float32_theory_gives_float64_loglike(likes, theories):
    """A float32 theory is cast to the likelihood's float64."""
    _, tl = likes
    _, tth = theories
    from cosmomc_tpu_torch.models.theory import in_dtype
    t32 = in_dtype(tth, torch.float32)
    nu = torch.as_tensor(np.tile(centers(tl), (2, 1)), dtype=torch.float32)
    out = tl.log_like(t32, nu)
    assert out.dtype == F64 and bool(torch.isfinite(out).all())


def test_device_default(dataset):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TWL(dataset)
