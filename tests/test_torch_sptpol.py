"""Port parity of the SPTpol TE/EE and BB likelihoods (cosmomc_tpu_torch/
likelihoods/sptpol.py) against the JAX package's, float64 on the CPU.

Fabricated sets (the SPTpol files are not in the repository): tests/
test_sptpol.py's small layout, and the port's writers
(`write_sptpol_teee`, `write_sptpol_bb`) at the releases' shapes. The
nuisance lists (names, centres, ranges, widths, speeds, order) must be
equal, and -logL of several chains with different theories and nuisance
values equal to 1e-10 relative, JAX one chain at a time, with every
prior switched on. One theory straddles a splice boundary inside the
TE/EE range: above l = 700 it is a scaled template, so the
l-derivatives of the super-sample lensing term and the aberration read
both sides of it. The writers round-trip: bandpowers written from a
theory give delta = 0 there, -logL = half ln det Cov in both packages.
In one LikelihoodList the two share beam1 and beam2 by name.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosmomc_tpu.likelihoods import sptpol as jsp

from cosmomc_tpu_torch.likelihoods import sptpol as tsp
from cosmomc_tpu_torch.likelihoods import synthetic as sd

F64 = torch.float64
RTOL = 1e-10
TEEE_PRIORS = {"correct_aberration": "T", "sptpol_kappa_prior": "T",
               "sptpol_tcal_prior": "T", "sptpol_pcal_prior": "T",
               "sptpol_alphaTE_prior": "T", "sptpol_alphaEE_prior": "T"}
BB_PRIORS = {"sptpol_cal_prior": "T", "sptpol_Add_prior": "T"}
#: the dust indices varying, so their priors act
TEEE_SPECS = {"alphaDust_TE": (-2.42, -3.0, -2.0, 0.02, 0.02),
              "alphaDust_EE": (-2.42, -3.0, -2.0, 0.02, 0.02)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Theory:
    def __init__(self, cls):
        self.cls = cls


def stacks(lmax, n=4, seed=0, splice_at=None):
    """(n, 4, 4, lmax+1) smooth power-law spectra (tests/test_sptpol.py's),
    per chain an amplitude and a tilt; with `splice_at`, chain 1 above it
    is a template (a different damping) scaled to TT there, as the
    pipeline's splice makes it."""
    rng = np.random.default_rng(seed)
    l = np.arange(lmax + 1, dtype=float)
    l[:2] = 1.0
    out = np.zeros((n, 4, 4, lmax + 1))
    for c in range(n):
        a = 1.0 + 0.05 * rng.standard_normal()
        t = 0.05 * rng.standard_normal()
        out[c, 1, 0] = out[c, 0, 1] = a * 30.0 * (l / 100.0) ** (-0.4 + t)
        out[c, 1, 1] = a * 20.0 * (l / 100.0) ** (-0.2 + t)
        out[c, 2, 2] = a * 0.05 * (l / 100.0) ** (0.7 + t)
        out[c, 0, 0] = a * 1000.0 * (l / 100.0) ** (-0.6 + t)
    out[..., :2] = 0.0
    if splice_at is not None:
        lm = splice_at
        tmpl = np.exp(-l / 900.0)
        norm = out[1, 0, 0, lm] / tmpl[lm]
        for (i, j) in ((0, 0), (1, 1), (2, 2), (1, 0), (0, 1)):
            out[1, i, j, lm + 1:] = (norm * tmpl[lm + 1:]
                                     * out[1, i, j, lm] / out[1, 0, 0, lm])
    return out


def nuisance_points(like, n, seed):
    """n nuisance vectors around the centres: the first at the centres."""
    rng = np.random.default_rng(seed)
    var = [p for p in like.nuisance if p.varying]
    c = np.array([p.center for p in var])
    w = np.array([p.propose_width for p in var])
    pts = c + 2.0 * w * rng.standard_normal((n, len(var)))
    pts[0] = c
    return np.clip(pts, [p.min for p in var], [p.max for p in var])


def param_tuple(p):
    return (p.name, p.center, p.min, p.max, p.start_width, p.propose_width,
            int(p.speed), p.varying, p.prior_mean, p.prior_std)


def compare(jcls, tcls, path, overrides, specs, cls, seed):
    j = jcls(path, dataset_overrides=overrides, param_specs=specs)
    t = tcls(path, dataset_overrides=overrides, param_specs=specs,
             device="cpu", dtype=F64)
    assert [param_tuple(p) for p in t.nuisance] == \
        [param_tuple(p) for p in j.nuisance]
    assert t.half_logdet == j.half_logdet
    nus = nuisance_points(t, len(cls), seed)
    got = t.log_like(Theory(torch.as_tensor(cls)), torch.as_tensor(nus)).numpy()

    class JT:
        pass
    want = []
    for s, n in zip(cls, nus):
        th = JT()
        th.cls = jnp.asarray(s)
        want.append(float(j.log_like(th, jnp.asarray(n))))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)
    return t, got


@pytest.mark.parametrize("priors", [False, True])
def test_teee_release_shape(tmp_path, priors):
    """56 bins a spectrum over 50..8000; chain 1 straddles a splice at
    l = 700 (inside the range, with the derivative's neighbours on both
    sides)."""
    path = sd.write_sptpol_teee(str(tmp_path), np.abs(
        np.random.default_rng(1).normal(20.0, 5.0, (2, 56))))
    t, got = compare(jsp.SPTpolTEEELikelihood, tsp.SPTpolTEEELikelihood, path,
                     TEEE_PRIORS if priors else None,
                     TEEE_SPECS if priors else None,
                     stacks(8001, splice_at=700), seed=2)
    assert t.required_lmax() == 8001 and t.nbin == 56 and t.lmin == 50


@pytest.mark.parametrize("priors", [False, True])
def test_bb_release_shape(tmp_path, priors):
    path = sd.write_sptpol_bb(str(tmp_path), np.abs(
        np.random.default_rng(3).normal(0.1, 0.02, (3, 7))))
    t, _ = compare(jsp.SPTpolBBLikelihood, tsp.SPTpolBBLikelihood, path,
                   BB_PRIORS if priors else None,
                   {"Abb": (1.0, 0.0, 5.0, 0.1, 0.1)} if priors else None,
                   stacks(2301, seed=4), seed=5)
    assert t.required_lmax() == 2301 and t.nbin == 7


def test_small_layout_of_the_jax_tests(tmp_path):
    """tests/test_sptpol.py's own fabricated layout (4 bins over 50..250,
    random covariance and windows written by its make_dataset) for both
    likelihoods."""
    import importlib.util
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "jax_sptpol_tests", os.path.join(here, "test_sptpol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for prefix, n_spec, jc, tc, ov in (
            ("sptpol_TEEE", 2, jsp.SPTpolTEEELikelihood,
             tsp.SPTpolTEEELikelihood, TEEE_PRIORS),
            ("sptpol_BB", 3, jsp.SPTpolBBLikelihood, tsp.SPTpolBBLikelihood,
             BB_PRIORS)):
        d = tmp_path / prefix
        d.mkdir()
        data = mod.make_dataset(d, prefix, n_spectra=n_spec, nband=3)
        compare(jc, tc, data["path"], ov, None, stacks(252, seed=6), seed=7)


def test_writers_round_trip(tmp_path):
    """Bandpowers from `sptpol_bandpowers` at a theory: delta = 0 there, so
    -logL equals half ln det Cov (the priors vanish at the centres) in both
    packages; the bandpower and window files read back as written."""
    cls = stacks(8001, n=1, seed=8)
    for writer, jc, tc in ((sd.write_sptpol_teee, jsp.SPTpolTEEELikelihood,
                            tsp.SPTpolTEEELikelihood),
                           (sd.write_sptpol_bb, jsp.SPTpolBBLikelihood,
                            tsp.SPTpolBBLikelihood)):
        d = tmp_path / tc.__name__
        t0 = tc(writer(str(d / "layout")), device="cpu")
        vals = sd.sptpol_bandpowers(t0, Theory(torch.as_tensor(cls)))
        path = writer(str(d / "set"), vals)
        j = jc(path)
        t = tc(path, device="cpu")
        np.testing.assert_array_equal(t.spec, vals)
        np.testing.assert_array_equal(t.windows, j.windows)
        np.testing.assert_allclose(t.windows.sum(-1), 1.0, rtol=1e-12)
        nu = np.array([[p.center for p in t.nuisance if p.varying]])
        got = float(t.log_like(Theory(torch.as_tensor(cls)),
                               torch.as_tensor(nu))[0])

        class JT:
            pass
        th = JT()
        th.cls = jnp.asarray(cls[0])
        want = float(j.log_like(th, jnp.asarray(nu[0])))
        assert got == pytest.approx(t.half_logdet, rel=1e-12, abs=1e-9)
        assert want == pytest.approx(t.half_logdet, rel=1e-12, abs=1e-9)


def test_shared_nuisance_names(tmp_path):
    """TE/EE and BB both name beam1 and beam2: in one LikelihoodList they
    share those two columns of the varying vector (CosmoMC wires nuisance
    parameters by name), so BB's columns are an index list, not the slice
    of the parameters it added; each likelihood reads its own values."""
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.params.space import ParameterSpace
    teee = tsp.SPTpolTEEELikelihood(sd.write_sptpol_teee(str(tmp_path / "a")),
                                    device="cpu")
    bb = tsp.SPTpolBBLikelihood(sd.write_sptpol_bb(str(tmp_path / "b")),
                                device="cpu")
    likes = LikelihoodList()
    likes.add(teee)
    likes.add(bb)
    space = ParameterSpace()
    cols = likes.add_nuisance_to_space(space)
    names = [p.name for p in space.varying]
    assert cols[teee.name] == slice(0, 8)
    assert [names[i] for i in cols[bb.name]] == \
        [p.name for p in bb.nuisance if p.varying]
    assert names.count("beam1") == 1 and len(names) == 14
    rng = np.random.default_rng(9)
    P = torch.as_tensor(np.array([p.center for p in space.varying])
                        + 0.01 * rng.standard_normal((3, len(names))))
    th = Theory(torch.as_tensor(stacks(8001, n=3, seed=10)))
    total, per = likes.total_log_like(th, P, cols)
    own = [teee.log_like(th, P[:, :8]),
           bb.log_like(th, P[:, [names.index(p.name) for p in bb.nuisance
                                 if p.varying]])]
    torch.testing.assert_close(per, torch.stack(own, -1), rtol=0, atol=0)
    torch.testing.assert_close(total, own[0] + own[1], rtol=0, atol=0)


@pytest.mark.parametrize("cls_name", ["SPTpolTEEELikelihood",
                                      "SPTpolBBLikelihood"])
def test_entry_default_device(tmp_path, cls_name):
    writer = (sd.write_sptpol_teee if "TEEE" in cls_name else sd.write_sptpol_bb)
    path = writer(str(tmp_path))
    like = getattr(tsp, cls_name)
    if torch.cuda.is_available():
        assert like(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            like(path)
    assert like(path, device="cpu").device.type == "cpu"
