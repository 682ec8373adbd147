"""The slice as a whole: the -logL gradient of one CMBPosterior with mnu,
w, wa and alpha1 all free (K1's nu_de instantiation with CDM isocurvature,
so every new term of the reverse pass is on the path), float64 on the CPU,
against jax.grad of the JAX posterior.

tests/test_extended_perts.py::test_remat_gradient_full_boltzmann's tiny
configuration: lmax 96, kmax 0.1, source_nk (24, 48), 1024 Boltzmann steps,
remat chunks (32 in both packages), a one-parameter TT likelihood written
alike in both; no halofit lensing. The extension parameters are freed by
ini overrides as tests/test_torch_extended_config.py frees them, at its
point (mnu 0.12 eV, w0 -0.9, wa -0.4, alpha1 0.05); both packages read the
same synthetic BBN table. The port's gradient is autograd of its plain
versions (K4's recurrence, K1's chunks and K2a's k chunks rematerialized,
utils/remat.py). Tolerances: -logL 1e-9 relative, the gradient 1e-8 of its
largest component.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.base import Likelihood as JLike
from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.params.parameterizations import ThetaParameterization as JTheta
from cosmomc_tpu.params.space import Param as JParam
from cosmomc_tpu.params.space import Speed as JSpeed
from cosmomc_tpu.pipeline import CMBPosterior as JPost
from cosmomc_tpu.utils.ini import IniFile as JIni

from cosmomc_tpu_torch.likelihoods.base import Likelihood as TLike
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization as TTheta
from cosmomc_tpu_torch.params.space import Param as TParam
from cosmomc_tpu_torch.params.space import Speed as TSpeed
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.utils.ini import IniFile as TIni

F64 = torch.float64
LMAX = 96
CFG = dict(lmax=LMAX, kmax=0.1, n_step_boltzmann=1024, source_nk=(24, 48),
           remat_chunks=32, nonlinear_lens=False)
FREE = {"mnu": "0.06 0 5 0.1 0.03", "w": "-1 -3 1 0.1 0.05",
        "wa": "0 -3 2 0.1 0.05", "alpha1": "0 -0.3 0.3 0.01 0.01"}
POINT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
             tau=0.05430138, logA=3.0447260, ns=0.9658923, mnu=0.12,
             w=-0.9, wa=-0.4, alpha1=0.05)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JTiny(JLike):
    kind = "CMB"

    def __init__(self):
        super().__init__("tiny")
        self.nuisance = [JParam("cal_t", 1.0, 0.9, 1.1, 0.002, 0.002,
                                speed=JSpeed.FAST)]

    def required_lmax(self):
        return LMAX

    def log_like(self, theory, nuisance):
        tt = theory.cls[0, 0, 2:LMAX + 1] / (nuisance[0] ** 2)
        return 0.5 * jnp.sum((tt / 1000.0 - 1.0) ** 2)


class TTiny(TLike):
    kind = "CMB"

    def __init__(self):
        super().__init__("tiny")
        self.nuisance = [TParam("cal_t", 1.0, 0.9, 1.1, 0.002, 0.002,
                                speed=TSpeed.FAST)]

    def required_lmax(self):
        return LMAX

    def log_like(self, theory, nuisance):
        tt = theory.cls[:, 0, 0, 2:LMAX + 1] / (nuisance[:, :1] ** 2)
        return 0.5 * torch.sum((tt / 1000.0 - 1.0) ** 2, -1)


@pytest.fixture(scope="module")
def gradients():
    """Both posteriors, -logL and its gradient at POINT (cal_t 1.01)."""
    tab = synthetic_bbn_table()
    jtab = JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))
    ini = {f"param[{n}]": v for n, v in FREE.items()}
    jl, tl = JLikes(), TLikes()
    jl.add(JTiny())
    tl.add(TTiny())
    jpost = JPost(JTheta(jnp.float64),
                  JTheta(jnp.float64).default_space(JIni(keys=dict(ini))), jl,
                  bbn_table=jtab, dtype=jnp.float64, **CFG)
    tpost = TPost(TTheta(), TTheta().default_space(TIni(keys=dict(ini))), tl,
                  bbn_table=tab, device="cpu", dtype=F64, **CFG)
    names = [p.name for p in tpost.space.varying]
    assert names == [p.name for p in jpost.space.varying]
    P = np.array([POINT.get(n, 1.01 if n == "cal_t" else np.nan) for n in names])
    assert np.all(np.isfinite(P)), names
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jpost.logpost()(p)[0]))(
        jnp.asarray(P))
    Pt = torch.tensor(P[None], dtype=F64, requires_grad=True)
    tv = tpost.logpost()(Pt)[0]
    tg, = torch.autograd.grad(tv.sum(), Pt)
    return dict(tpost=tpost, names=names, jv=float(jv), jg=np.asarray(jg),
                tv=float(tv[0]), tg=tg[0].numpy())


def test_every_extension_is_on(gradients):
    post = gradients["tpost"]
    assert post.massive_nu_hierarchy and post.de_perturbations
    assert post._iso_enabled and post.gradient_unsupported() is None
    assert {"mnu", "w", "wa", "alpha1"} <= set(gradients["names"])


def test_logl_matches_jax(gradients):
    assert np.isfinite(gradients["tv"])
    assert abs(gradients["tv"] - gradients["jv"]) <= 1e-9 * abs(gradients["jv"])


def test_gradient_matches_jax(gradients):
    jg, tg, names = gradients["jg"], gradients["tg"], gradients["names"]
    assert np.all(np.isfinite(jg)) and np.all(np.isfinite(tg))
    err = np.abs(tg - jg) / np.abs(jg).max()
    assert err.max() <= 1e-8, dict(zip(names, err))
    # the slow stage's new parameters move -logL
    for n in ("mnu", "w", "wa", "alpha1"):
        assert tg[names.index(n)] != 0.0, n
