"""Port parity of the BK-Planck likelihood (cosmomc_tpu_torch/likelihoods/
bkplanck.py) against the JAX package's, float64 on the CPU.

A fabricated BK15-shaped set (`write_bk_like`: six maps, E and B at 95,
150 and 220 GHz, Gaussian bandpasses, the 16 foreground parameters in a
.paramnames file; the BK15 release is not in the repository) goes through
both readers: the nuisance list (names, centres, ranges, widths, priors
from BK15_PRIORS, order) and the DataParams slot map must be equal. Then,
per chain against JAX one chain at a time, 1e-10 relative: the dust and
synchrotron scalings (with band-centre errors), the decorrelation (flat,
lin and quad, Delta on both sides of 1), the foreground power and the
full -logL on the B maps alone and on E and B together, with several
chains of different theories and parameters.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.bkplanck import BKPlanckLikelihood as JBK

from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.bkplanck import BKPlanckLikelihood as TBK

F64 = torch.float64
RTOL = 1e-10
NCH = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spectra(n=NCH, lmax=400, seed=0):
    """(n, 4, 4, lmax+1): EE and BB power laws, TT, TE; per chain an
    amplitude."""
    rng = np.random.default_rng(seed)
    l = np.arange(lmax + 1, dtype=float)
    l[:2] = 1.0
    out = np.zeros((n, 4, 4, lmax + 1))
    for c in range(n):
        a = 1.0 + 0.1 * rng.standard_normal()
        out[c, 0, 0] = a * 1000.0 * (l / 100.0) ** -0.5
        out[c, 1, 1] = a * 0.5 * (l / 100.0) ** 1.2
        out[c, 2, 2] = a * 0.01 * (l / 100.0) ** 0.9
        out[c, 1, 0] = out[c, 0, 1] = 0.3 * np.sqrt(out[c, 0, 0] * out[c, 1, 1])
    out[..., :2] = 0.0
    return out


def fg_points(like, n, seed, **set_):
    """n varying-nuisance vectors: the centres, then seeded steps of two
    proposal widths, with `set_` values where named."""
    rng = np.random.default_rng(seed)
    var = [p for p in like.nuisance if p.varying]
    pts = np.array([p.center for p in var]) + 2.0 * np.array(
        [p.propose_width for p in var]) * rng.standard_normal((n, len(var)))
    pts[0] = [p.center for p in var]
    pts = np.clip(pts, [p.min for p in var], [p.max for p in var])
    for name, v in set_.items():
        pts[:, [p.name for p in var].index(name)] = v
    return pts


@pytest.fixture(scope="module", params=["B", "EB"])
def pair(request, tmp_path_factory):
    """JAX and port readers of a BK15-shaped set: the three B maps used, or
    all six; decorrelation of dust lin, sync quad; gamma_* and Delta_*
    varying (their band-centre and decorrelation paths are then live)."""
    d = str(tmp_path_factory.mktemp("bk"))
    maps = [m for m in sd.bk_map_names() if m[-1] in request.param]
    n = len(maps)
    vals = np.abs(np.random.default_rng(2).normal(0.02, 0.004,
                                                  (9, n * (n + 1) // 2)))
    path = sd.write_bk_like(d, vals, maps_use=maps, settings=dict(
        lform_dust_decorr="lin", lform_sync_decorr="quad"))
    specs = {"Delta_dust": (0.97, 0.5, 1.5, 0.01, 0.01),
             "Delta_sync": (1.02, 0.5, 1.5, 0.01, 0.01),
             "gamma_corr": (0.0, -0.1, 0.1, 0.01, 0.01),
             "gamma_95": (0.01, -0.1, 0.1, 0.01, 0.01),
             "gamma_220": (-0.01, -0.1, 0.1, 0.01, 0.01),
             "EEtoBB_dust": (2.0, 1.0, 3.0, 0.1, 0.1)}
    return (JBK(path, param_specs=specs),
            TBK(path, param_specs=specs, device="cpu", dtype=F64))


def test_nuisance_wiring(pair):
    j, t = pair
    tup = lambda p: (p.name, p.center, p.min, p.max, p.start_width,
                     p.propose_width, int(p.speed), p.varying, p.prior_mean,
                     p.prior_std)
    assert [tup(p) for p in t.nuisance] == [tup(p) for p in j.nuisance]
    assert t._fg_names == j._fg_names == list(sd.BK_PARAMS)
    np.testing.assert_array_equal(t._fg_slice_pos, j._fg_slice_pos)
    np.testing.assert_array_equal(t._gamma_slot, j._gamma_slot)
    for f in ("_bp_nu", "_bp_w", "_bp_th_dust", "_bp_th_sync", "_bp_nu_bar"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    priors = {p.name: (p.prior_mean, p.prior_std) for p in t.nuisance}
    assert priors["BBbetadust"] == (1.59, 0.11)
    assert priors["BBbetasync"] == (-3.1, 0.3)


def test_scalings(pair):
    """Dust and synchrotron scalings of each required map per chain, with
    band-centre errors, against JAX's per chain."""
    j, t = pair
    rng = np.random.default_rng(3)
    beta = np.array([1.59, 1.4, 1.8, 1.6])
    Td = np.array([19.6, 18.0, 21.0, 25.0])
    bs = np.array([-3.1, -2.8, -3.4, -3.0])
    bce = 1.0 + 0.02 * rng.standard_normal((NCH, t.nmaps_required))
    T = lambda a: torch.as_tensor(a, dtype=F64)
    gd = t._dust_scaling(T(beta), T(Td), T(bce)).numpy()
    gs = t._sync_scaling(T(bs), T(bce)).numpy()
    for c in range(NCH):
        wd = np.asarray(j._dust_scaling(jnp.float64(beta[c]), jnp.float64(Td[c]),
                                        jnp.asarray(bce[c])))
        ws = np.asarray(j._sync_scaling(jnp.float64(bs[c]), jnp.asarray(bce[c])))
        np.testing.assert_allclose(gd[c], wd, rtol=RTOL, atol=0.0)
        np.testing.assert_allclose(gs[c], ws, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("lform", ["flat", "lin", "quad"])
def test_decorrelation(pair, lform):
    j, t = pair
    ells = np.arange(20.0, 340.0, 7.0)
    Delta = np.array([0.97, 1.0, 1.03, 0.8])
    nu_i = np.array([[95.0, 150.0, 217.0]] * NCH) * (1 + 0.01 * np.arange(NCH))[:, None]
    nu_j = np.array([[150.0, 220.0, 353.0]] * NCH)
    T = lambda a: torch.as_tensor(a, dtype=F64)
    got = t._decorrelation(T(Delta), T(nu_i), T(nu_j), (217.0, 353.0), lform,
                           T(ells)).numpy()
    for c in range(NCH):
        want = np.asarray(j._decorrelation(jnp.float64(Delta[c]),
                                           jnp.asarray(nu_i[c]),
                                           jnp.asarray(nu_j[c]), (217.0, 353.0),
                                           lform, jnp.asarray(ells)))
        np.testing.assert_allclose(got[c], want, rtol=RTOL, atol=0.0)


def test_foreground_power(pair):
    j, t = pair
    nL = t.pcl_lmax - t.pcl_lmin + 1
    zero = np.zeros((NCH, len(t.req_pairs), nL))
    nus = fg_points(t, NCH, 4)
    got = t.add_foregrounds(torch.as_tensor(zero), torch.as_tensor(nus)).numpy()
    assert np.abs(got).max() > 0
    for c in range(NCH):
        want = np.asarray(j.add_foregrounds(jnp.asarray(zero[c]),
                                            jnp.asarray(nus[c])))
        np.testing.assert_allclose(got[c], want, rtol=RTOL, atol=1e-300)


def test_full_loglike(pair):
    j, t = pair
    cls = spectra()
    nus = fg_points(t, NCH, 5)
    got = t.log_like_cls(torch.as_tensor(cls), torch.as_tensor(nus)).numpy()
    want = np.array([float(j.log_like_cls(jnp.asarray(s), jnp.asarray(n)))
                     for s, n in zip(cls, nus)])
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    # dust moves it
    nus2 = nus.copy()
    nus2[:, [p.name for p in t.nuisance if p.varying].index("BBdust")] = 12.0
    moved = t.log_like_cls(torch.as_tensor(cls), torch.as_tensor(nus2)).numpy()
    assert np.all(moved != got)


def test_writer_round_trip(tmp_path):
    """Bandpowers written from a theory with the foregrounds at their
    centres (`cmblikes_bandpowers` on the port's reader) give chi^2 = 0
    there in both packages (HL at C = Chat)."""
    cls = spectra(n=1, seed=9)
    t0 = TBK(sd.write_bk_like(str(tmp_path / "layout")), device="cpu")
    vals = sd.cmblikes_bandpowers(t0, torch.as_tensor(cls))
    path = sd.write_bk_like(str(tmp_path / "set"), vals)
    j, t = JBK(path), TBK(path, device="cpu")
    nu = np.array([[p.center for p in t.nuisance if p.varying]])
    got = float(t.log_like_cls(torch.as_tensor(cls), torch.as_tensor(nu))[0])
    want = float(j.log_like_cls(jnp.asarray(cls[0]), jnp.asarray(nu[0])))
    assert abs(got) < 1e-18 and abs(want) < 1e-18


def test_entry_default_device(tmp_path):
    path = sd.write_bk_like(str(tmp_path))
    if torch.cuda.is_available():
        assert TBK(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TBK(path)
    assert TBK(path, device="cpu").device.type == "cpu"
