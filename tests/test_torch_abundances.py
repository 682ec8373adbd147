"""Port parity of the element-abundance likelihoods
(likelihoods/abundances.py).

The reference's BBN grid and abundance `.dataset`s are not in the
repository: `synthetic.write_bbn_table` writes the synthetic table's
formulas as a reference-format 8-column grid, read by both packages'
`load_bbn_table`, and `write_abundance` the Yp_Aver2015-, D_Cooke2017- and
D_Cooke2013-shaped sets. The port evaluates three chains at once (ombh2
and nnu vary), JAX one chain at a time. float64 on the CPU; every value
to 1e-12 relative.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from cosmomc_tpu.likelihoods import abundances as jab
from cosmomc_tpu.models import bbn as jbbn
from cosmomc_tpu.models.background import BackgroundParams as JBG
from cosmomc_tpu.models.theory import compute_background_theory as jtheory

from cosmomc_tpu_torch.likelihoods import abundances as tab
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.models.background import BackgroundParams as TBG
from cosmomc_tpu_torch.models.theory import compute_background_theory as ttheory

F64 = torch.float64
RTOL = 1e-12
OMBH2 = np.array([0.02236, 0.0221, 0.0228])
NNU = np.array([3.046, 3.5, 2.8])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("abund"))
    table = sd.write_bbn_table(f"{d}/{sd.BBN_TABLE_NAME}")
    out = {n: sd.write_abundance(d, n, **kw)
           for n, kw in sd.ABUNDANCE_SETS.items()}
    out["He_unknown"] = sd.write_abundance(d, "He_unknown", "He3", 1e-5, 1e-6)
    return table, out


def _theories(ombh2=OMBH2, nnu=NNU):
    jth = [jtheory(JBG.make(ombh2=o, nnu=n)) for o, n in zip(ombh2, nnu)]
    tth = ttheory(TBG(*(torch.as_tensor(v, dtype=F64) for v in (
        ombh2, [0.12] * 3, [67.5] * 3, [0.0] * 3, [0.000644] * 3, nnu,
        [-1.0] * 3, [0.0] * 3, [2.7255] * 3))))
    return jth, tth


@pytest.mark.parametrize("name", list(sd.ABUNDANCE_SETS))
def test_log_like_against_jax(sets, name):
    _, paths = sets
    jl = jab.AbundanceLikelihood(paths[name])
    tl = tab.AbundanceLikelihood(paths[name], device="cpu")
    assert (tl.name, tl.measurement, tl.mean, tl.error, tl.theory_bias_offset,
            tl.theory_effective_error) == (jl.name, jl.measurement, jl.mean,
                                           jl.error, jl.theory_bias_offset,
                                           jl.theory_effective_error)
    jth, tth = _theories()
    got = tl.log_like(tth, torch.zeros(3, 0, dtype=F64)).numpy()
    want = [float(jl.log_like(th, jnp.zeros(0))) for th in jth]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[0] < 2.0 and len(set(got.tolist())) == 3


def test_hand_oracle_on_written_table(sets):
    """JAX's tests/test_abundances.py oracle: the Gaussian evaluated by
    hand from the dataset numbers and the table's prediction."""
    table, paths = sets
    jt = jbbn.load_bbn_table(table)
    _, tth = _theories()
    zeros = torch.zeros(3, 0, dtype=F64)
    yp = tab.AbundanceLikelihood(paths["Yp_Aver2015"], device="cpu")
    pred = float(jbbn.ypbbn_bbn(OMBH2[0], 0.0, table=jt))
    want = 0.5 * (pred - 0.2449) ** 2 / (0.0040 ** 2 + 0.0003 ** 2)
    assert float(yp.log_like(tth, zeros)[0]) == pytest.approx(want, rel=RTOL)
    dh = tab.AbundanceLikelihood(paths["D_Cooke2017"], device="cpu")
    pred = float(jbbn.dh_bbn(OMBH2[0], 0.0, table=jt)) - 0.091e-5
    want = 0.5 * (pred - 2.527e-5) ** 2 / (0.030e-5 ** 2 + 0.089e-5 ** 2)
    assert float(dh.log_like(tth, zeros)[0]) == pytest.approx(want, rel=RTOL)
    # no effective error: the table's sigma_D/H
    dh13 = tab.AbundanceLikelihood(paths["D_Cooke2013"], device="cpu")
    pred = float(jbbn.dh_bbn(OMBH2[0], 0.0, table=jt))
    sig = float(jbbn.bbn_errors(OMBH2[0], 0.0, table=jt)[1])
    want = 0.5 * (pred - 2.53e-5) ** 2 / (0.04e-5 ** 2 + sig ** 2)
    assert float(dh13.log_like(tth, zeros)[0]) == pytest.approx(want, rel=RTOL)


def test_written_table_round_trips(sets):
    """The grid file read back by both packages gives the synthetic
    formulas at the nodes."""
    from cosmomc_tpu_torch.models import bbn as tbbn
    table, _ = sets
    tt, jt = tbbn.load_bbn_table(table), jbbn.load_bbn_table(table)
    for f in tbbn.GRID_FIELDS:
        np.testing.assert_allclose(getattr(tt, f), np.asarray(getattr(jt, f)),
                                   rtol=RTOL)
    omb, dn, g = tbbn.synthetic_bbn_grids()
    i, j = 40, 20
    o = torch.as_tensor([omb[i]], dtype=F64)
    d = torch.as_tensor([dn[j]], dtype=F64)
    t64 = tt.to("cpu", F64)
    assert float(tbbn.ypbbn_bbn(o, d, t64)[0]) == pytest.approx(
        g["ypbbn"][i, j], rel=1e-6)
    assert float(tbbn.dh_bbn(o, d, t64)[0]) == pytest.approx(g["dh"][i, j],
                                                             rel=1e-6)


def test_non_bbn_yp_and_errors(sets):
    """Yp without BBN consistency reads the theory's yhe (and raises
    without one); D/H without it, an unknown measurement raise."""
    _, paths = sets
    jl = jab.AbundanceLikelihood(paths["Yp_Aver2015"], bbn_consistency=False)
    tl = tab.AbundanceLikelihood(paths["Yp_Aver2015"], bbn_consistency=False,
                                 device="cpu")
    assert tl.non_bbn_yhe and tl.table is None
    yhe = np.array([0.2454, 0.246, 0.244])
    jth, tth = _theories()
    got = tl.log_like(SimpleNamespace(bg=tth.bg, yhe=torch.as_tensor(yhe)),
                      torch.zeros(3, 0, dtype=F64)).numpy()
    want = [float(jl.log_like(SimpleNamespace(bg=th.bg, yhe=y), jnp.zeros(0)))
            for th, y in zip(jth, yhe)]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with pytest.raises(ValueError, match="no yhe"):
        tl.log_like(tth, torch.zeros(3, 0, dtype=F64))
    with pytest.raises(ValueError, match="no yhe"):
        jl.log_like(jth[0], jnp.zeros(0))
    for lib, kw in ((jab, {}), (tab, dict(device="cpu"))):
        with pytest.raises(ValueError, match="requires BBN consistency"):
            lib.AbundanceLikelihood(paths["D_Cooke2017"],
                                    bbn_consistency=False, **kw)
        with pytest.raises(ValueError, match="Un-recognised"):
            lib.AbundanceLikelihood(paths["He_unknown"], **kw)


def test_mass_to_nucleon_fraction():
    y = np.array([0.2454, 0.24, 0.25])
    np.testing.assert_allclose(
        tab.yp_bbn_from_mass_fraction(torch.as_tensor(y)).numpy(),
        np.asarray(jab.yp_bbn_from_mass_fraction(jnp.asarray(y))), rtol=1e-15)
    assert tab.STANDARD_NNU == jab.STANDARD_NNU


def test_gradient_and_float32_theory(sets):
    """Differentiable through the table lookup; a float32 theory gives a
    float64 -logL."""
    _, paths = sets
    tl = tab.AbundanceLikelihood(paths["D_Cooke2017"], device="cpu")
    omb = torch.tensor(OMBH2, dtype=F64, requires_grad=True)
    bg = TBG.make(nchains=3)
    bg.ombh2 = omb
    (g,) = torch.autograd.grad(tl.log_like(SimpleNamespace(bg=bg),
                                           torch.zeros(3, 0)).sum(), omb)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).all())
    bg32 = TBG.make(ombh2=0.02236, nchains=3, dtype=torch.float32)
    out = tl.log_like(SimpleNamespace(bg=bg32), torch.zeros(3, 0))
    assert out.dtype == F64


def test_device_default(sets):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tab.AbundanceLikelihood(sets[1]["Yp_Aver2015"])
