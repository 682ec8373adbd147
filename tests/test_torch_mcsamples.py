"""Port parity of analysis/mcsamples.py (host numpy in both packages).

The same chain files (ChainWriter + sidecars, seeded numpy) go through
the JAX package's MCSamples and the port's: every statistic equal to
1e-12 relative, and the numbers in every file `write_all` writes equal to
1e-12 relative (the texts' words equal). Then tests/test_analysis.py's
statistical cases run on the port.
"""

import os
import re

import numpy as np
import pytest

from cosmomc_tpu.analysis.mcsamples import MCSamples as JMCSamples
from cosmomc_tpu.io.chains import ChainWriter as JChainWriter
from cosmomc_tpu.utils.paramnames import ParamInfo as JInfo
from cosmomc_tpu.utils.paramnames import ParamNames as JNames

from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
from cosmomc_tpu_torch.io.chains import ChainWriter
from cosmomc_tpu_torch.utils.paramnames import ParamInfo, ParamNames

RTOL = 1e-12
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|nan|inf")


def assert_close(port, ref, rtol=RTOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= rtol, f"rel err {err:.3e} > {rtol:.1e}"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """4 chains of a correlated random walk in (a, b, r), r bounded below
    at 0 (a one-tail marginal), written by the JAX ChainWriter with its
    sidecars."""
    rng = np.random.default_rng(31)
    nsteps, nchains = 1500, 4
    d = tmp_path_factory.mktemp("mcs")
    path = str(d / "run")
    w = JChainWriter(path, nchains)
    accept = rng.random((nsteps, nchains)) < 0.3
    P = rng.normal(0, 1, (nsteps, nchains, 3)).cumsum(axis=0) * 0.01 \
        + rng.normal([1.0, 2.0, 0.0], 0.1, (nsteps, nchains, 3))
    P[..., 2] = np.abs(P[..., 2])
    w.add_segment(accept, P, rng.random((nsteps, nchains)))
    w.close()
    JNames([JInfo("a", "a"), JInfo("b", "b"), JInfo("r", "r")]).write(
        path + ".paramnames")
    with open(path + ".ranges", "w") as f:
        f.write("a -1e30 1e30\nb -1e30 1e30\nr 0 20\n")
    return path


@pytest.fixture(scope="module")
def both(root):
    return (JMCSamples.load(root, ignore_frac=0.2),
            MCSamples.load(root, ignore_frac=0.2))


def test_load_equal(both):
    j, t = both
    for f in ("samples", "weights", "loglikes"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert t.chain_offsets == j.chain_offsets and t.ranges == j.ranges
    assert [p.name for p in t.names.names] == [p.name for p in j.names.names]


@pytest.mark.parametrize("stat", ["means", "cov", "vars", "corr"])
def test_moments_equal(both, stat):
    j, t = both
    assert_close(getattr(t, stat)(), getattr(j, stat)())


def test_limits_kde_pca_equal(both):
    j, t = both
    for js, ts in zip(j.marge_stats(), t.marge_stats()):
        assert (ts.name, ts.label) == (js.name, js.label)
        assert_close([ts.mean, ts.sddev], [js.mean, js.sddev])
        assert [x[2] for x in ts.limits] == [x[2] for x in js.limits]
        assert_close([x[:2] for x in ts.limits], [x[:2] for x in js.limits])
    for k in range(3):
        for a, b in zip(t.kde_1d(k), j.kde_1d(k)):
            assert_close(a, b)
    for k in ("evals", "evecs", "indices"):
        assert_close(t.pca()[k], j.pca()[k])


def test_converge_battery_equal(both):
    j, t = both
    assert_close(t.converge_tests()["R-1"], j.converge_tests()["R-1"])
    js, ts = j.split_limit_tests(), t.split_limit_tests()
    assert sorted(ts) == sorted(js)
    for n in js:
        assert_close(ts[n], js[n])
    assert_close(t.correlation_lengths(), j.correlation_lengths())
    jr, tr = j.raftery_lewis(), t.raftery_lewis()
    for k in jr:
        np.testing.assert_allclose(tr[k], jr[k], rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("ext", [".margestats", ".likestats", ".covmat",
                                 ".corr", ".converge"])
def test_write_all_equal(both, tmp_path, ext):
    j, t = both
    j.write_all(str(tmp_path / "j"))
    t.write_all(str(tmp_path / "t"))
    jt = (tmp_path / ("j" + ext)).read_text()
    tt = (tmp_path / ("t" + ext)).read_text()
    assert NUM.sub("#", tt) == NUM.sub("#", jt)
    jn = [float(x) for x in NUM.findall(jt)]
    tn = [float(x) for x in NUM.findall(tt)]
    np.testing.assert_allclose(tn, jn, rtol=RTOL, atol=0.0, equal_nan=True)


# ------------------------- tests/test_analysis.py's cases, on the port


def _gaussian_samples(n=200_000, seed=0):
    rng = np.random.default_rng(seed)
    mean = np.array([1.5, -0.3])
    cov = np.array([[0.04, 0.012], [0.012, 0.09]])
    x = rng.multivariate_normal(mean, cov, size=n)
    names = ParamNames([ParamInfo("a", "a"), ParamInfo("b", "b")])
    return MCSamples(x, np.ones(n), np.zeros(n), names), mean, cov


@pytest.fixture(scope="module")
def gaussian():
    return _gaussian_samples()


def test_moments_recovered(gaussian):
    s, mean, cov = gaussian
    np.testing.assert_allclose(s.means(), mean, atol=3e-3)
    np.testing.assert_allclose(s.cov(), cov, rtol=0.03, atol=1e-4)


def test_two_tail_limits_match_gaussian(gaussian):
    s, mean, cov = gaussian
    stats = s.marge_stats(contours=(0.68, 0.95))
    for j, st in enumerate(stats):
        sd = np.sqrt(cov[j, j])
        lo68, hi68, tag = st.limits[0]
        assert tag == "two"
        # equal-tail 68% limits of a Gaussian are mean +/- 0.9945 sigma
        assert abs(lo68 - (mean[j] - 0.9945 * sd)) < 0.03 * sd
        assert abs(hi68 - (mean[j] + 0.9945 * sd)) < 0.03 * sd
        lo95, hi95, _ = st.limits[1]
        assert abs(hi95 - (mean[j] + 1.9600 * sd)) < 0.05 * sd


def test_one_tail_detection():
    """A half-Gaussian truncated at 0 must report a '<' upper limit."""
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(0, 1.0, 100_000))[:, None]
    names = ParamNames([ParamInfo("r", "r")])
    s = MCSamples(x, np.ones(len(x)), np.zeros(len(x)), names,
                  ranges={"r": (0.0, 20.0)})
    lo, hi, tag = s.marge_stats(contours=(0.95,))[0].limits[0]
    assert tag == "<"
    assert lo == 0.0
    assert abs(hi - 1.96) < 0.05   # 95% of |N(0,1)|


def test_kde_density_integrates_to_one(gaussian):
    s, mean, cov = gaussian
    x, d = s.kde_1d(0)
    dx = x[1] - x[0]
    assert abs(d.sum() * dx - 1.0) < 1e-6
    assert abs(x[np.argmax(d)] - mean[0]) < 0.05


def test_weighted_stats():
    """Doubling weight == duplicating the sample."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (5000, 1))
    names = ParamNames([ParamInfo("a", "a")])
    s1 = MCSamples(np.concatenate([x, x[:1000]]), np.ones(6000),
                   np.zeros(6000), names)
    w = np.ones(5000)
    w[:1000] = 2.0
    s2 = MCSamples(x, w, np.zeros(5000), names)
    assert abs(s1.means()[0] - s2.means()[0]) < 1e-12
    assert abs(s1.cov()[0, 0] - s2.cov()[0, 0]) < 1e-12


def test_file_roundtrip(tmp_path):
    """Write chains via the port's ChainWriter + sidecars, load via
    MCSamples.load, write all GetDist-format outputs."""
    rng = np.random.default_rng(3)
    nsteps, nchains = 2000, 4
    root = str(tmp_path / "run")
    names = ParamNames([ParamInfo("a", "a"), ParamInfo("b", "b")])
    w = ChainWriter(root, nchains)
    accept = rng.random((nsteps, nchains)) < 0.3
    P = rng.normal(0, 1, (nsteps, nchains, 2)).cumsum(axis=0) * 0.01 \
        + rng.normal([1.0, 2.0], 0.1, (nsteps, nchains, 2))
    w.add_segment(accept, P, rng.random((nsteps, nchains)))
    w.close()
    names.write(root + ".paramnames")
    with open(root + ".ranges", "w") as f:
        f.write("a -1e30 1e30\nb -1e30 1e30\n")
    s = MCSamples.load(root, ignore_frac=0.2)
    assert s.samples.shape[1] == 2
    assert len(s.names) == 2
    out = s.write_all(root)
    assert np.isfinite(out["R-1"])
    for ext in (".margestats", ".likestats", ".covmat", ".corr", ".converge"):
        assert os.path.getsize(root + ext) > 0
    np.testing.assert_allclose(np.loadtxt(root + ".covmat"), s.cov(), rtol=1e-6)


def test_converge_r_sane():
    """Identical chains -> tiny R-1; shifted chains -> big R-1."""
    rng = np.random.default_rng(4)
    names = ParamNames([ParamInfo("a", "a")])
    base = rng.normal(0, 1, (40_000, 1))
    s = MCSamples(base, np.ones(len(base)), np.zeros(len(base)), names,
                  chain_offsets=[0, 20_000, 40_000])
    assert s.converge_tests()["R-1"] < 0.01
    x2 = np.concatenate([base[:20_000], base[20_000:] + 3.0])
    s2 = MCSamples(x2, np.ones(len(x2)), np.zeros(len(x2)), names,
                   chain_offsets=[0, 20_000, 40_000])
    assert s2.converge_tests()["R-1"] > 1.0


def test_converge_battery(tmp_path):
    """Split-limit tests, correlation lengths, Raftery-Lewis on a synthetic
    AR(1) chain."""
    rng = np.random.default_rng(3)
    n, rho = 4000, 0.8
    x = np.empty((n, 2))
    x[0] = 0.0
    eps = rng.standard_normal((n, 2))
    for i in range(1, n):
        x[i] = rho * x[i - 1] + np.sqrt(1 - rho ** 2) * eps[i]
    names = ParamNames([ParamInfo("a", "a"), ParamInfo("b", "b")])
    s = MCSamples(x, np.ones(n), np.zeros(n), names, [0, n // 2, n])
    sp = s.split_limit_tests()
    assert set(sp) == {2, 3, 4}
    for v in sp.values():
        assert v.shape == (2,)
        assert np.all(v >= 0) and np.all(v < 1.0)
    cl = s.correlation_lengths()
    # AR(1) integrated autocorr time = (1+rho)/(1-rho) = 9
    assert np.all(cl > 4) and np.all(cl < 20), cl
    rl = s.raftery_lewis()
    assert np.all(rl["thin_k"] >= 1)
    assert np.all(np.isfinite(rl["N_min"]))
    assert np.all(rl["N_min"] > 100)
    s.write_converge(str(tmp_path / "t.converge"))
    txt = (tmp_path / "t.converge").read_text()
    assert "Split tests" in txt and "Correlation lengths" in txt \
        and "Raftery-Lewis" in txt
