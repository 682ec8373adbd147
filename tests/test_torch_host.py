"""Port parity, host helpers and background layer (slice steps 1-6).

The same inputs, made with numpy from a fixed seed, go through the JAX
package and through cosmomc_tpu_torch, in float64 on the CPU. Arrays are
compared by max |port - jax| <= rtol * max |jax| with rtol = 1e-9 unless a
test states otherwise; numpy helpers copied verbatim must agree exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import background as jbg_mod
from cosmomc_tpu.models import bbn as jbbn
from cosmomc_tpu.models import bessel as jbessel
from cosmomc_tpu.models import cls as jcls
from cosmomc_tpu.models import cmb as jcmb
from cosmomc_tpu.models import constants as jconst
from cosmomc_tpu.models import neutrino as jnu
from cosmomc_tpu.models import primordial as jprim
from cosmomc_tpu.models import reionization as jreion
from cosmomc_tpu.params import parameterizations as jpar
from cosmomc_tpu.utils import interp as jinterp
from cosmomc_tpu.utils import quad as jquad

from cosmomc_tpu_torch import convert
from cosmomc_tpu_torch.models import background as tbg_mod
from cosmomc_tpu_torch.models import bbn as tbbn
from cosmomc_tpu_torch.models import bessel as tbessel
from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models import cmb as tcmb
from cosmomc_tpu_torch.models import constants as tconst
from cosmomc_tpu_torch.models import neutrino as tnu
from cosmomc_tpu_torch.models import primordial as tprim
from cosmomc_tpu_torch.models import reionization as treion
from cosmomc_tpu_torch.params import parameterizations as tpar
from cosmomc_tpu_torch.utils import interp as tinterp
from cosmomc_tpu_torch.utils import quad as tquad

F64 = torch.float64
RTOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, rtol=RTOL):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(port - ref).max() / scale
    assert err <= rtol, f"rel err {err:.3e} > {rtol:.1e}"


def t(x):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=F64)


# cosmologies spread over the prior box, one per chain
_RNG = np.random.default_rng(20261016)
COSMO = dict(ombh2=_RNG.uniform(0.020, 0.025, 3), omch2=_RNG.uniform(0.10, 0.14, 3),
             H0=_RNG.uniform(62.0, 74.0, 3), omnuh2=np.full(3, 0.000645),
             nnu=np.full(3, 3.046))


def jax_bg(i):
    return jbg_mod.BackgroundParams.make(
        ombh2=COSMO["ombh2"][i], omch2=COSMO["omch2"][i], H0=COSMO["H0"][i],
        omnuh2=COSMO["omnuh2"][i], nnu=COSMO["nnu"][i], dtype=jnp.float64)


@pytest.fixture(scope="module")
def tbg():
    return tbg_mod.BackgroundParams(
        ombh2=t(COSMO["ombh2"]), omch2=t(COSMO["omch2"]), H0=t(COSMO["H0"]),
        omk=t(np.zeros(3)), omnuh2=t(COSMO["omnuh2"]), nnu=t(COSMO["nnu"]),
        w=t(-np.ones(3)), wa=t(np.zeros(3)), tcmb=t(np.full(3, 2.7255)))


# ---------------------------------------------------------------- step 1

def test_constants_identical():
    names = [n for n in dir(jconst) if not n.startswith("_")
             and isinstance(getattr(jconst, n), float)]
    assert len(names) > 15
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
    assert tconst.omega_gamma_h2() == jconst.omega_gamma_h2()
    assert tconst.n_H_today(0.0224, 1.3) == jconst.n_H_today(0.0224, 1.3)


def test_ini_and_paramnames_copies(tmp_path):
    from cosmomc_tpu.utils.ini import IniFile as JIni
    from cosmomc_tpu.utils.paramnames import ParamNames as JPN
    from cosmomc_tpu_torch.utils.ini import IniFile as TIni
    from cosmomc_tpu_torch.utils.paramnames import ParamNames as TPN
    (tmp_path / "base.ini").write_text("a = 1\nb = x y # c\nparam[t] = 3\n")
    (tmp_path / "top.ini").write_text("DEFAULT(base.ini)\na = 2\nflag = T\n")
    (tmp_path / "p.paramnames").write_text("x  \\alpha\ny*  \\beta  # d\n")
    ji, ti = JIni(str(tmp_path / "top.ini")), TIni(str(tmp_path / "top.ini"))
    assert ji.params == ti.params
    assert ti.bool("flag") and ti.int("a") == 2
    assert ji.tags("param") == ti.tags("param")
    jp, tp = JPN.from_file(str(tmp_path / "p.paramnames")), \
        TPN.from_file(str(tmp_path / "p.paramnames"))
    assert [(p.name, p.label, p.derived) for p in jp] == \
        [(p.name, p.label, p.derived) for p in tp]


def test_gauss_legendre_nodes():
    a = t([0.1, 0.3])
    xs, ws = tquad.gl_nodes(a, 2.0, 64)
    for i in range(2):
        jx, jw = jquad.gl_nodes(jnp.asarray(0.1 if i == 0 else 0.3), 2.0, 64,
                                dtype=jnp.float64)
        assert_close(xs[i], jx, 1e-15)
        assert_close(ws[i], jw, 1e-15)


@pytest.mark.parametrize("kmax,nk", [(0.5, (48, 200)), (0.1, (24, 48))])
def test_source_k_grid_identical(kmax, nk):
    np.testing.assert_array_equal(tcmb.source_k_grid(kmax, *nk),
                                  jcmb.source_k_grid(kmax, *nk))


def test_fine_k_grid_and_cubic_weights_identical():
    kf = tcls.fine_k_grid(14200.0, 0.1)
    np.testing.assert_array_equal(kf, jcls.fine_k_grid(14200.0, 0.1))
    coarse = jcmb.source_k_grid(0.1, 24, 48)
    kf_pad = np.concatenate([kf, np.full((-len(kf)) % 256, kf[-1])])
    ti, tw = tcls._cubic_k_weights(coarse, kf_pad)
    ji, jw = jcls._cubic_k_weights(coarse, kf_pad)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)


def test_bessel_tables_identical_float32():
    ls = tuple(int(l) for l in jbessel.default_l_samples(600)[:12])
    np.testing.assert_array_equal(tbessel.default_l_samples(2658),
                                  jbessel.default_l_samples(2658))
    tt, jt = tbessel.build_bessel_table(ls, 300.0), \
        jbessel.build_bessel_table(ls, 300.0)
    assert tt.jl.dtype == np.float32 and tt.jlp.dtype == np.float32
    np.testing.assert_array_equal(tt.jl, jt.jl)
    np.testing.assert_array_equal(tt.jlp, jt.jlp)
    assert tt.dx == jt.dx


# ---------------------------------------------------------------- step 2

def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0, 10, 40))
    fp = rng.normal(size=40)
    x = np.concatenate([rng.uniform(-2, 12, 200), xp, [xp[0], xp[-1]]])
    assert_close(tinterp.interp(t(x), t(xp), t(fp)),
                 jnp.interp(x, xp, fp), 1e-15)
    # batched knots and values, per chain
    xp2 = np.sort(rng.uniform(0, 10, (3, 40)), -1)
    fp2 = rng.normal(size=(3, 40))
    x2 = rng.uniform(-1, 11, (3, 25))
    ref = np.stack([np.asarray(jnp.interp(x2[i], xp2[i], fp2[i]))
                    for i in range(3)])
    assert_close(tinterp.interp(t(x2), t(xp2), t(fp2)), ref, 1e-15)
    # exact nodes give exact node values, outside the range the end values
    out = tinterp.interp(t(xp), t(xp), t(fp)).numpy()
    assert np.array_equal(out[:-1], fp[:-1])
    assert tinterp.interp(t([-5.0]), t(xp), t(fp)).item() == fp[0]
    assert tinterp.interp(t([50.0]), t(xp), t(fp)).item() == fp[-1]


def test_splines_match():
    rng = np.random.default_rng(2)
    x = np.cumsum(rng.uniform(0.5, 2.0, 30))
    y = rng.normal(size=(4, 30))
    xq = np.linspace(x[0], x[-1], 117)
    sp = tinterp.spline_fit(t(x), t(y))
    for i in range(4):
        jsp = jinterp.spline_fit(jnp.asarray(x), jnp.asarray(y[i]))
        assert_close(sp.y2[i], jsp.y2)
        assert_close(tinterp.spline_eval(sp, t(xq))[i],
                     jinterp.spline_eval(jsp, jnp.asarray(xq)))
        assert_close(tinterp.spline_cumint(tinterp.Spline(t(x), sp.y[i],
                                                          sp.y2[i])),
                     jinterp.spline_cumint(jsp))


def test_thomas_batched():
    rng = np.random.default_rng(3)
    n = 50
    dl, du = rng.uniform(0.1, 1, (2, n)), rng.uniform(0.1, 1, (2, n))
    d = 4.0 + rng.uniform(0, 1, (2, n))
    b = rng.normal(size=(2, n))
    out = tinterp._thomas(t(dl), t(d), t(du), t(b))
    for i in range(2):
        assert_close(out[i], jinterp._thomas(*(jnp.asarray(a[i])
                                               for a in (dl, d, du, b))))


def test_linspace_gradient_trapezoid():
    assert_close(tinterp.linspace(float(np.log(1e-9)), 0.0, 4096,
                                  dtype=F64), jnp.linspace(np.log(1e-9), 0.0,
                                                           4096), 1e-15)
    rng = np.random.default_rng(4)
    x = np.cumsum(rng.uniform(0.1, 1.0, (2, 64)), -1)
    f = np.sin(x)
    g = tinterp.gradient(t(f), t(x))
    for i in range(2):
        assert_close(g[i], jnp.gradient(f[i], x[i]), 1e-13)
        assert_close(tinterp.trapezoid(t(f[i]), t(x[i])),
                     jnp.trapezoid(f[i], x[i]), 1e-14)


# ---------------------------------------------------------------- step 3

def test_neutrino_tables():
    am = np.exp(np.linspace(np.log(1e-3), np.log(2e3), 301))
    assert_close(tnu.nu_rho(t(am)), jnu.nu_rho(jnp.asarray(am)))
    assert_close(tnu.nu_pres(t(am)), jnu.nu_pres(jnp.asarray(am)))


# ---------------------------------------------------------------- step 4

def test_hubble_and_distances(tbg):
    a = np.exp(np.linspace(np.log(1e-8), 0.0, 200))
    H = tbg_mod.hubble_mpc(tbg, t(np.tile(a, (3, 1))))
    bf = tbg_mod.background_functions(tbg)
    zs = t(np.array([0.38, 1.0, 1089.0]))
    chi = tbg_mod.comoving_radial_distance(bf, zs)
    for i in range(3):
        jb = jax_bg(i)
        assert_close(H[i], jbg_mod.hubble_mpc(jb, jnp.asarray(a)))
        jbf = jbg_mod.background_functions(jb)
        assert_close(bf.chi_grid[i], jbf.chi_grid)
        assert_close(chi[i], jbg_mod.comoving_radial_distance(jbf, zs[i].item()))
        assert_close(tbg_mod.age_gyr(tbg)[i], jbg_mod.age_gyr(jb))
        assert_close(tbg_mod.cosmomc_theta(tbg)[i], jbg_mod.cosmomc_theta(jb))
        assert_close(tbg_mod.hofz_kms(tbg, 0.51)[i], jbg_mod.hofz_kms(jb, 0.51))


def test_h0_from_theta():
    thetas = np.array([1.0395, 1.0409020, 1.0425])
    par_t, par_j = tpar.ThetaParameterization(), \
        jpar.ThetaParameterization(jnp.float64)
    full = np.tile([0.02237737, 0.1201035, 0.0, 0.0543, 0.0, 0.06, -1.0, 0.0,
                    3.046, 0.0], (3, 1))
    full[:, 2] = thetas
    bg = par_t.to_background(t(full))
    for i in range(3):
        jb = par_j.to_background(jnp.asarray(full[i]))
        assert_close(bg.H0[i], jb.H0, 1e-12)
        assert_close(bg.omnuh2[i], jb.omnuh2, 1e-15)


# ---------------------------------------------------------------- step 5

def test_primordial_power():
    k = np.exp(np.linspace(np.log(1e-5), np.log(1.0), 80))
    pp = tprim.PrimordialParams.make(logA=t([3.0, 3.1]), ns=t([0.95, 0.97]))
    P = tprim.scalar_power(pp, t(k))
    for i, (la, ns) in enumerate([(3.0, 0.95), (3.1, 0.97)]):
        jp = jprim.PrimordialParams.make(logA=la, ns=ns, dtype=jnp.float64)
        assert_close(P[i], jprim.scalar_power(jp, jnp.asarray(k)))


def test_reionization(tbg):
    yhe = np.array([0.245, 0.247, 0.243])
    taus = np.array([0.05, 0.06, 0.09])
    z = np.linspace(0, 30, 61)
    fHe = yhe / (jconst.mass_ratio_He_H * (1 - yhe))
    xe = treion.xe_reion(t(np.tile(z, (3, 1))), t([7.0, 8.0, 9.0])[:, None],
                         t(fHe)[:, None])
    depth = treion.reion_optical_depth(tbg, t([7.0, 8.0, 9.0]), t(yhe))
    zre = treion.zre_from_tau(tbg, t(taus), t(yhe))
    for i in range(3):
        jb = jax_bg(i)
        assert_close(xe[i], jreion.xe_reion(jnp.asarray(z), 7.0 + i, fHe[i]))
        assert_close(depth[i], jreion.reion_optical_depth(jb, 7.0 + i, yhe[i]))
        assert_close(zre[i], jreion.zre_from_tau(jb, taus[i], yhe[i]))


def test_synthetic_bbn_table():
    tab = tbbn.synthetic_bbn_table()
    jtab = jbbn.BBNTable(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                         *(jnp.asarray(getattr(tab, f))
                           for f in tbbn.GRID_FIELDS))
    dev = tab.to("cpu", F64)
    assert abs(tbbn.yhe_bbn(t([0.02237]), t([0.0]), dev).item() - 0.2454) < 1e-4
    omb = np.linspace(0.006, 0.045, 23)
    dn = np.linspace(-1.5, 1.5, 23)
    assert_close(tbbn.yhe_bbn(t(omb), t(dn), dev),
                 jbbn.yhe_bbn(jnp.asarray(omb), jnp.asarray(dn), jtab))
    assert_close(tbbn.dh_bbn(t(omb), t(dn), dev),
                 jbbn.dh_bbn(jnp.asarray(omb), jnp.asarray(dn), jtab))
    # carried across by convert, the table is the same
    back = convert.bbn_table(jtab)
    np.testing.assert_array_equal(back.yp, tab.yp)


# ---------------------------------------------------------------- step 6

def test_parameter_space_and_device_arrays():
    ts, js = tpar.ThetaParameterization().default_space(), \
        jpar.ThetaParameterization(jnp.float64).default_space()
    ts.get("tau").prior_mean = js.get("tau").prior_mean = 0.0544
    ts.get("tau").prior_std = js.get("tau").prior_std = 0.0073
    assert ts.names == js.names
    assert ts.speed_blocks() == js.speed_blocks()
    ta, ja = ts.device_arrays("cpu", F64), js.device_arrays(jnp.float64)
    assert set(ta) == set(ja)
    for k in ta:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]))


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port imports without jax or cosmomc_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cosmomc_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cosmomc_tpu' or m.startswith('cosmomc_tpu.')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 25, mods\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
