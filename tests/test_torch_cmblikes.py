"""Port parity of the CMBLikes engine (cosmomc_tpu_torch/likelihoods/
cmblikes.py) against the JAX package's, float64 on the CPU.

The same fabricated datasets (the real SPT-SZ, Planck lensing and BK15
files are not in the repository) go through both readers: the index
bookkeeping (required pairs and their theory fields, the pair rows, the
vech order, the covariance columns, the pure-CMB mask, the nuisance list)
must be equal, and -logL of several chains with different theories and
nuisance values equal to 1e-10 relative, JAX evaluating one chain at a
time. One chain of each HL and exact set has a theory plus noise that is
not positive definite: +inf there and only there.

Layouts: TT only (SPT-SZ-shaped, Gaussian with calibration, aberration
and the log-calibration prior; and HL and exact on that writer); T and E
with TT TE EE in HL and Gaussian (tests/test_cmblikes.py's fixture
layout); PP alone with T, E and P required and linear corrections (the
Planck lensing layout); a BK map-name layout (six maps, three used, the
windows of unused pairs dropped); unbinned fullsky-exact T and E. The
synthetic writers round-trip: bandpowers written from a theory through
`cmblikes_bandpowers` give chi^2 = 0 there in both packages.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.cmblikes import CMBLikes as JCMBLikes

from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.cmblikes import CMBLikes, read_cl_text

F64 = torch.float64
RTOL = 1e-10
LMAX = 4500


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def base_stack(lmax=LMAX):
    """A smooth (4, 4, lmax+1) theory stack (tests/test_cmblikes.py's
    smooth spectra)."""
    L = np.arange(2, lmax + 1).astype(float)
    cls = np.zeros((4, 4, lmax + 1))
    tt = 1e3 * (L / 200.0) ** -0.6 * (1 + 0.2 * np.sin(L / 90.0))
    ee = 20.0 * (L / 500.0) ** -0.4 * (1 + 0.3 * np.sin(L / 90.0 + 1.0))
    te = np.sign(np.sin(L / 95.0)) * np.sqrt(np.abs(tt * ee)) * 0.4
    bb = 0.05 * (L / 1000.0) ** 0.8
    pp = 1.3e-7 * (L / 30.0) ** -0.9
    for (i, j), v in (((0, 0), tt), ((1, 0), te), ((1, 1), ee), ((2, 2), bb),
                      ((3, 3), pp)):
        cls[i, j, 2:] = v
        cls[j, i, 2:] = v
    return cls


def chain_stacks(cls, n=4, bad=None, seed=0):
    """n chains: amplitudes and tilts from a seeded generator; chain `bad`
    with the T, E, B spectra negated (theory + noise not positive definite
    where the noise is smaller)."""
    rng = np.random.default_rng(seed)
    L = np.arange(cls.shape[-1], dtype=float)
    out = []
    for c in range(n):
        a = 1.0 + 0.05 * rng.standard_normal()
        t = 0.02 * rng.standard_normal()
        s = cls * a * ((L + 1.0) / 1000.0) ** t
        if c == bad:
            s[:3, :3] *= -1.0
        out.append(s)
    return np.stack(out)


def both(path, **kw):
    return (JCMBLikes(path, **kw),
            CMBLikes(path, device="cpu", dtype=F64, **kw))


def assert_same_layout(j, t):
    for f in ("nmaps", "nmaps_required", "ncl", "ncl_used", "req_pairs",
              "req_theory_pairs", "required_order", "calibration_index",
              "nbins_used", "bin_min", "bin_max", "pcl_lmin", "pcl_lmax"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("_req_pair_row", "cl_use_index", "_tri_i", "_tri_j",
              "cmb_pair_mask", "map_used_index", "map_required_index",
              "chat_m"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    for f in ("inv_covariance", "sqrt_fiducial", "noise_m"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    for wt, wj in ((t.bin_windows, j.bin_windows),
                   (t.correction_windows, j.correction_windows)):
        assert (wt is None) == (wj is None)
        if wt is not None:
            np.testing.assert_array_equal(wt.W, wj.W)
            np.testing.assert_array_equal(wt.in_pair, wj.in_pair)
            np.testing.assert_array_equal(wt.out_col, wj.out_col)
    assert [(p.name, p.center, p.min, p.max, p.start_width, p.propose_width,
             p.prior_mean, p.prior_std) for p in t.nuisance] == \
        [(p.name, p.center, p.min, p.max, p.start_width, p.propose_width,
          p.prior_mean, p.prior_std) for p in j.nuisance]


def assert_same_loglike(j, t, stacks, nus, bad=None):
    got = t.log_like_cls(torch.as_tensor(stacks), torch.as_tensor(nus)).numpy()
    want = np.array([float(j.log_like_cls(jnp.asarray(s), jnp.asarray(n)))
                     for s, n in zip(stacks, nus)])
    assert got.shape == (len(stacks),)
    for c in range(len(stacks)):
        if c == bad:
            assert np.isinf(got[c]) and np.isinf(want[c]), c
        else:
            assert np.isfinite(got[c]), c
            np.testing.assert_allclose(got[c], want[c], rtol=RTOL, atol=0.0,
                                       err_msg=f"chain {c}")
    return got


# ---- TT only: the SPT-SZ-shaped set ----

@pytest.mark.parametrize("approx", ["gaussian", "HL", "exact"])
def test_tt_only(tmp_path, approx):
    cls = base_stack()
    edges = sd.SPTSZ_EDGES
    ls = (0.5 * (edges[:-1] + edges[1:] - 1) if approx != "exact"
          else np.arange(2, 41))
    vals = np.interp(ls, np.arange(cls.shape[-1]), cls[0, 0]) * 1.02
    spec = {"sptsz_cal": (1.0, 0.1, 10, 0.002, 0.002)}
    j, t = both(sd.write_cmblikes_tt(str(tmp_path), vals, like_approx=approx),
                param_specs=spec)
    assert_same_layout(j, t)
    assert [p.name for p in t.nuisance] == ["sptsz_cal"]
    assert t.aberration_coeff == j.aberration_coeff != 0.0
    bad = None if approx == "gaussian" else 2
    stacks = chain_stacks(cls, bad=bad)
    nus = np.array([[1.0], [1.01], [0.98], [1.003]])
    assert_same_loglike(j, t, stacks, nus, bad=bad)


# ---- T and E, TT TE EE, HL and Gaussian ----

def _write_te_set(d):
    """tests/test_cmblikes.py's synthetic binned TT/TE/EE layout (seed 42),
    with its HL and Gaussian datasets."""
    rng = np.random.default_rng(42)
    os.makedirs(f"{d}/windows", exist_ok=True)
    lmin, lmax, nbins = 30, 300, 6
    L = np.arange(lmin, lmax + 1)
    edges = np.linspace(lmin, lmax + 1, nbins + 1).astype(int)
    for b in range(nbins):
        w = np.zeros(len(L))
        w[(L >= edges[b]) & (L < edges[b + 1])] = 1.0
        w /= w.sum()
        np.savetxt(f"{d}/windows/win_{b + 1}.txt",
                   np.column_stack([L, w, w, w]), fmt="%10.6e")
    tt = 2000 * (L / 100.) ** -0.5
    ee = 30 * (L / 300.) ** -0.3
    te = 0.3 * np.sqrt(tt * ee) * np.sin(L / 40.)

    def binv(x):
        return np.array([x[(L >= edges[b]) & (L < edges[b + 1])].mean()
                         for b in range(nbins)])
    bins = np.arange(1, nbins + 1)
    hat = np.column_stack([bins, binv(tt) * (1 + 0.05 * rng.standard_normal(nbins)),
                           binv(te) + 0.03 * np.abs(binv(te)).mean()
                           * rng.standard_normal(nbins),
                           binv(ee) * (1 + 0.08 * rng.standard_normal(nbins))])
    hdr = "  L TT TE EE"
    np.savetxt(f"{d}/cl_hat.dat", hat, fmt="%12.6e", header=hdr)
    np.savetxt(f"{d}/cl_fid.dat",
               np.column_stack([bins, binv(tt), binv(te), binv(ee)]),
               fmt="%12.6e", header=hdr)
    np.savetxt(f"{d}/cl_noise.dat",
               np.column_stack([bins, 0.1 * binv(tt), 0 * bins, 0.2 * binv(ee)]),
               fmt="%12.6e", header=hdr)
    n = 3 * nbins
    A = rng.standard_normal((n, 2 * n))
    scale = np.concatenate([[binv(tt)[b] * 0.05, np.abs(binv(te)[b]) * 0.08 + 1.0,
                             binv(ee)[b] * 0.08] for b in range(nbins)])
    np.savetxt(f"{d}/covmat.dat", (A @ A.T) / (2 * n) * np.outer(scale, scale),
               fmt="%15.8e")
    base = ("fields_use = T E\nbinned = T\nnbins = 6\ncl_lmin = 30\n"
            "cl_lmax = 300\nbin_window_files = windows/win_%u.txt\n"
            "bin_window_in_order = TT TE EE\nbin_window_out_order = TT TE EE\n"
            "covmat_cl = TT TE EE\ncovmat_fiducial = covmat.dat\n"
            "cl_hat_file = cl_hat.dat\ncl_fiducial_file = cl_fid.dat\n"
            "cl_noise_file = cl_noise.dat\n")
    for name, approx in (("hl", "HL"), ("gauss", "gaussian")):
        with open(f"{d}/{name}.dataset", "w") as f:
            f.write(f"like_approx = {approx}\n" + base)


@pytest.mark.parametrize("name", ["hl", "gauss"])
def test_te_ee(tmp_path, name):
    _write_te_set(str(tmp_path))
    j, t = both(f"{tmp_path}/{name}.dataset")
    assert_same_layout(j, t)
    assert t.nmaps == 2 and t.ncl == 3
    cls = base_stack(500)
    bad = 1 if name == "hl" else None
    assert_same_loglike(j, t, chain_stacks(cls, n=5, bad=bad), np.zeros((5, 0)),
                        bad=bad)


def test_hl_pinned_value(tmp_path):
    """The port on tests/test_cmblikes.py's own HL fixture and theory file
    (the value test_cmblikes.py pins from the reference's Python mirror)."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "jax_cmblikes_tests", os.path.join(here, "test_cmblikes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._make_hl_fixture(str(tmp_path))
    cls = read_cl_text(f"{tmp_path}/theory_cl.txt", 500)
    like = CMBLikes(f"{tmp_path}/hl.dataset", device="cpu")
    got = 2 * float(like.log_like_cls(torch.as_tensor(cls[None]),
                                      torch.zeros(1, 0, dtype=F64))[0])
    assert got == pytest.approx(112.29098181576978, abs=1e-7)


# ---- PP alone, T E P required, linear corrections ----

def _write_lensing_set(d, seed=3):
    """The Planck lensing layout: PP bandpowers, T, E and P required, the
    linear corrections' TT EE TE PP windows onto PP, Gaussian."""
    rng = np.random.default_rng(seed)
    os.makedirs(f"{d}/windows", exist_ok=True)
    lmin, lmax, nbins = 2, 2500, 9
    L = np.arange(lmin, lmax + 1)
    edges = np.array([8, 40, 84, 129, 174, 219, 264, 309, 354, 401])
    pp_th = base_stack(lmax)[3, 3]
    for b in range(nbins):
        w = ((L >= edges[b]) & (L < edges[b + 1])) / float(edges[b + 1] - edges[b])
        np.savetxt(f"{d}/windows/window{b + 1}.dat", np.column_stack([L, w]),
                   fmt="%.10e")
        corr = np.column_stack([L] + [1e-12 * w * (1 + k) * rng.uniform(0.5, 1.5)
                                      for k in range(3)] + [0.01 * w])
        np.savetxt(f"{d}/windows/corr{b + 1}.dat", corr, fmt="%.10e")
    bins = np.arange(1, nbins + 1)
    binned = np.array([pp_th[(np.arange(lmax + 1) >= edges[b])
                             & (np.arange(lmax + 1) < edges[b + 1])].mean()
                       for b in range(nbins)])
    np.savetxt(f"{d}/cl_hat.dat",
               np.column_stack([bins, binned * (1 + 0.1 * rng.standard_normal(nbins))]),
               fmt="%.10e", header="bin PP")
    np.savetxt(f"{d}/fid_corr.dat", np.column_stack([bins, 0.01 * binned]),
               fmt="%.10e", header="bin PP")
    sig = 0.1 * binned
    np.savetxt(f"{d}/cov.dat", np.diag(sig ** 2), fmt="%.10e")
    with open(f"{d}/lens.dataset", "w") as f:
        f.write("like_approx = gaussian\nfields_use = P\n"
                "fields_required = T E P\nbinned = T\nnbins = 9\n"
                "use_min = 2\nuse_max = 8\n"
                f"cl_lmin = {lmin}\ncl_lmax = {lmax}\n"
                "bin_window_files = windows/window%u.dat\n"
                "bin_window_in_order = PP\n"
                "cl_hat_file = cl_hat.dat\ncovmat_cl = PP\n"
                "covmat_fiducial = cov.dat\n"
                "linear_correction_fiducial_file = fid_corr.dat\n"
                "linear_correction_bin_window_files = windows/corr%u.dat\n"
                "linear_correction_bin_window_in_order = TT EE TE PP\n"
                "linear_correction_bin_window_out_order = PP PP PP PP\n"
                "calibration_param = cal.paramnames\n")
    with open(f"{d}/cal.paramnames", "w") as f:
        f.write("A_lens   A_{\\rm lens}\n")


def test_lensing_layout(tmp_path):
    _write_lensing_set(str(tmp_path))
    j, t = both(f"{tmp_path}/lens.dataset")
    assert_same_layout(j, t)
    assert (t.nmaps, t.nmaps_required, t.ncl) == (1, 3, 1)
    assert not t.cmb_pair_mask.all() and t.cmb_pair_mask.any()
    assert len(t.correction_windows.in_pair) == 4
    nus = np.array([[1.0], [1.05], [0.97], [1.01]])
    assert_same_loglike(j, t, chain_stacks(base_stack(2500)), nus)


# ---- a BK map-name layout through the generic engine ----

def test_bk_map_names(tmp_path):
    vals = np.abs(np.random.default_rng(4).normal(0.02, 0.005, (9, 6)))
    j, t = both(sd.write_bk_like(str(tmp_path), vals))
    assert_same_layout(j, t)
    assert t.has_map_names and (t.nmaps, t.nmaps_required, t.ncl) == (3, 3, 6)
    # windows of the pairs with an E map dropped: 6 of 21 kept
    assert t.bin_windows.W.shape[1] == 6
    bad = 3
    assert_same_loglike(j, t, chain_stacks(base_stack(400), bad=bad),
                        np.zeros((4, 0)), bad=bad)


# ---- unbinned fullsky exact, T and E ----

def test_exact_te(tmp_path):
    d = str(tmp_path)
    L = np.arange(2, 41).astype(float)
    tt = 1000 * (L / 10.) ** -0.3
    ee = 5 * (L / 10.) ** 0.2
    te = 0.3 * np.sqrt(tt * ee)
    rng = np.random.default_rng(7)
    hdr = "  L TT TE EE"
    np.savetxt(f"{d}/cl_hat.dat",
               np.column_stack([L] + [x * (1 + 0.1 * rng.standard_normal(len(L)))
                                      for x in (tt, te, ee)]),
               fmt="%12.6e", header=hdr)
    np.savetxt(f"{d}/cl_noise.dat",
               np.column_stack([L, 0.05 * tt, 0 * L, 0.1 * ee]),
               fmt="%12.6e", header=hdr)
    with open(f"{d}/exact.dataset", "w") as f:
        f.write("like_approx = exact\nfields_use = T E\nbinned = F\n"
                "cl_lmin = 2\ncl_lmax = 40\nfullsky_exact_fksy = 0.57\n"
                "cl_hat_file = cl_hat.dat\ncl_noise_file = cl_noise.dat\n")
    j, t = both(f"{d}/exact.dataset")
    assert_same_layout(j, t)
    bad = 0
    assert_same_loglike(j, t, chain_stacks(base_stack(100), bad=bad),
                        np.zeros((4, 0)), bad=bad)


# ---- the writers round-trip ----

@pytest.mark.parametrize("approx", ["gaussian", "HL", "exact"])
def test_tt_writer_round_trip(tmp_path, approx):
    """Bandpowers written from a theory by cmblikes_bandpowers (the port's
    reader, at the calibration centre) give chi^2/2 = 0 at that theory in
    both packages."""
    cls = chain_stacks(base_stack(), n=1, seed=5)
    t0 = CMBLikes(sd.write_cmblikes_tt(str(tmp_path / "a"), like_approx=approx),
                  device="cpu")
    vals = sd.cmblikes_bandpowers(t0, torch.as_tensor(cls))[:, 0]
    j, t = both(sd.write_cmblikes_tt(str(tmp_path / "b"), vals,
                                     like_approx=approx))
    one = np.ones((1, 1))
    got = float(t.log_like_cls(torch.as_tensor(cls), torch.as_tensor(one))[0])
    want = float(j.log_like_cls(jnp.asarray(cls[0]), jnp.ones(1)))
    assert abs(got) < 1e-20 and abs(want) < 1e-20
    bad = cls.copy()
    bad[0, 0, 0] *= 1.01
    assert float(t.log_like_cls(torch.as_tensor(bad), torch.as_tensor(one))[0]) > 0


def test_entry_default_device(tmp_path):
    path = sd.write_cmblikes_tt(str(tmp_path))
    if torch.cuda.is_available():
        assert CMBLikes(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CMBLikes(path)
    assert CMBLikes(path, device="cpu").device.type == "cpu"
