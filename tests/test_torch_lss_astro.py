"""Port parity of the LSS-only astro configuration (AstroParameterization,
CMBPosterior with use_cmb=False and matter_power), and of the staged
sampler's caches of matter transfers and P(k, z) tables: per-chain
selection with the shared k and z grids, and the caches rebuilt on resume.

float64 on the CPU, both packages given the same synthetic BBN table. The
matter transfers run on a reduced k grid in both packages for the whole
module (36 k to kmax = 2/Mpc, 2048 steps; tests/test_torch_matterpower.py
says why 2048): each package's `compute_matter_transfers` is replaced by
itself with that grid, where its CMBPosterior calls it.

Tolerances: -logL 1e-12 absolute (no likelihood: the bounded posterior's
prior alone); every derived value 1e-9 relative but kd and thetad (5e-3:
they difference two ~1e13 cumulative sums, as test_torch_slice.py says);
the sigma8 tables 1e-9 relative.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.likelihoods.base import LikelihoodList as JLikes
from cosmomc_tpu.models import matterpower as jmp
from cosmomc_tpu.models.bbn import BBNTable as JBBN
from cosmomc_tpu.params.parameterizations import AstroParameterization as JAstro
from cosmomc_tpu.pipeline import CMBPosterior as JPost

from cosmomc_tpu_torch import pipeline as tpipe
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList as TLikes
from cosmomc_tpu_torch.models import matterpower as tmp
from cosmomc_tpu_torch.models.bbn import GRID_FIELDS, synthetic_bbn_table
from cosmomc_tpu_torch.params.parameterizations import AstroParameterization as TAstro
from cosmomc_tpu_torch.pipeline import CMBPosterior as TPost
from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler as TSampler
from cosmomc_tpu_torch.sampling.staged import select_chains

F64 = torch.float64
K = tmp.matter_k_grid(kmax=2.0, nk_log_lo=8, nk_lin=16, nk_log_hi=12)
N_STEP = 2048
DERIVED_RTOL = {"kd": 5e-3, "thetad": 5e-3}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reduced_matter_grid():
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jmp, "compute_matter_transfers", functools.partial(
            jmp.compute_matter_transfers, k=K, n_step=N_STEP))
        m.setattr(tpipe, "compute_matter_transfers", functools.partial(
            tmp.compute_matter_transfers, k=K, n_step=N_STEP))
        yield


@pytest.fixture(scope="module")
def bbn():
    tab = synthetic_bbn_table()
    return tab, JBBN(tab.ombh2_0, tab.ombh2_step, tab.dn_0, tab.dn_step,
                     *(jnp.asarray(getattr(tab, f)) for f in GRID_FIELDS))


def _assert_derived(names, t_der, j_der):
    for i, (n, _) in enumerate(names):
        np.testing.assert_allclose(t_der[:, i], j_der[:, i], atol=0.0,
                                   rtol=DERIVED_RTOL.get(n, 1e-9), err_msg=n)


@pytest.fixture(scope="module")
def astro(bbn):
    tab, jtab = bbn
    jpost = JPost(JAstro(jnp.float64), JAstro(jnp.float64).default_space(),
                  JLikes(), use_cmb=False, matter_power=True,
                  z_pk=(0.0, 0.5, 1.0), bbn_table=jtab, dtype=jnp.float64)
    tpost = TPost(TAstro(), TAstro().default_space(), TLikes(), use_cmb=False,
                  matter_power=True, z_pk=(0.0, 0.5, 1.0), bbn_table=tab,
                  device="cpu", dtype=F64)
    centre = np.array([p.center for p in tpost.space.varying])
    points = np.vstack([centre, centre * np.array([1.05, 0.97, 1.02, 1.0,
                                                   1.01])])
    prop = tpost.make_proposal()
    prop.set_covariance(np.diag([p.propose_width ** 2
                                 for p in tpost.space.varying]))
    sampler = TSampler(prop, tpost)
    return jpost, tpost, points, sampler, sampler.init_state(
        torch.as_tensor(points, dtype=F64))


def test_astro_parameterization_lss_only(astro):
    """The port of test_pipeline_extras.py::test_astro_parameterization_
    lss_only, against JAX's values: no C_l, sigma8(z) on z_pk, -logL and
    every derived value (the sigma8 combinations included)."""
    jpost, tpost, points, _, state = astro
    assert [p.name for p in tpost.space.varying] == \
        [p.name for p in jpost.space.varying] == \
        ["omegam", "omegab", "H0", "logA", "ns"]
    assert tpost.derived_names == jpost.derived_names
    assert state.semi["cls"] is None and state.slow["clt"] is None
    jth, _ = jax.jit(jpost.compute_theory)(
        jpost.embed_full(jnp.asarray(points[0])))
    assert jth.cls is None
    mp = state.semi["mp"]
    np.testing.assert_allclose(mp.sigma8_z[0].numpy(), np.asarray(jth.sigma8_z),
                               rtol=1e-9)
    np.testing.assert_allclose(mp.fsigma8_z[0].numpy(),
                               np.asarray(jth.fsigma8_z), rtol=1e-9)
    s8 = mp.sigma8_z[0, 0].item()
    assert 0.5 < s8 < 1.1
    jfn = jax.jit(jpost.logpost())
    ref = [jfn(jnp.asarray(p)) for p in points]
    np.testing.assert_allclose(state.mloglike.numpy(),
                               [float(m) for m, _ in ref], atol=1e-12)
    _assert_derived(tpost.derived_names, state.derived.numpy(),
                    np.stack([np.asarray(d) for _, d in ref]))
    dn = [n for n, _ in tpost.derived_names]
    for name in ("sigma8", "S8", "s8omegamp5", "age", "zstar", "thetastar"):
        assert name in dn, name
    assert abs(state.derived[0, dn.index("S8")].item()
               - s8 * np.sqrt(points[0, 0] / 0.3)) < 1e-12


def test_select_chains_passes_shared_grids(astro):
    """Per-chain selection over the matter transfers and P(k, z) tables:
    the shared k and z grids (nk, nz differ from the chain count) pass
    through from the new cache, every per-chain field takes its chain."""
    *_, state = astro
    acc = torch.tensor([True, False])
    for old in (state.slow["mt"], state.semi["mp"]):
        new = type(old)(*[v if f in ("k", "z") else v.flip(0)
                          for f, v in zip(old._fields, old)])
        out = select_chains(acc, new, old)
        assert out.k is new.k and out.z is new.z
        for f, v in zip(out._fields, out):
            if f not in ("k", "z"):
                assert torch.equal(v[0], getattr(new, f)[0]), f
                assert torch.equal(v[1], getattr(old, f)[1]), f


def test_state_from_arrays_rebuilds_matter_caches(astro):
    """A resumed state's caches, rebuilt by `state_from_arrays` at the
    checkpointed points, equal the carried ones bit for bit (matter
    transfers and P(k, z) tables included)."""
    _, _, points, sampler, state = astro
    again = sampler.state_from_arrays(points, state.mloglike.numpy(),
                                      state.derived.numpy(),
                                      state.num_accept.numpy())

    def leaves(x, path="."):
        if torch.is_tensor(x):
            yield path, x
        elif isinstance(x, dict):
            for k, v in x.items():
                yield from leaves(v, f"{path}.{k}")
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for k in x._fields:
                yield from leaves(getattr(x, k), f"{path}.{k}")
        elif isinstance(x, tuple):
            for i, v in enumerate(x):
                yield from leaves(v, f"{path}[{i}]")
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                yield from leaves(getattr(x, f.name), f"{path}.{f.name}")
    a = dict(leaves((state.slow, state.semi)))
    b = dict(leaves((again.slow, again.semi)))
    assert a.keys() == b.keys()
    assert any(".mt." in k for k in a) and any(".mp." in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_per_likelihood_lss_bbn(astro, bbn, tmp_path_factory):
    """The LSS-only configuration with a BBN prior (D/H and Yp abundances on
    a written BBN grid): compute_theory and per_likelihood, the action=4
    table, against JAX's per_likelihood at the centre, at
    test_torch_slice.py's -logL tolerances. Both posteriors take the
    fixture's theory configuration; the port's slow stage is served from
    the fixture's sampler state (a function of the parameters alone), and
    JAX's compute_theory is jitted (the HLO of
    test_astro_parameterization_lss_only's)."""
    from cosmomc_tpu.likelihoods.abundances import AbundanceLikelihood as JAb
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.abundances import \
        AbundanceLikelihood as TAb
    from cosmomc_tpu_torch.sampling.staged import SHARED_FIELDS
    _, _, points, _, state = astro
    tab, jtab = bbn
    d = str(tmp_path_factory.mktemp("lss_bbn"))
    sd.write_bbn_table(f"{d}/{sd.BBN_TABLE_NAME}")
    jl, tl = JLikes(), TLikes()
    for n in ("D_Cooke2017", "Yp_Aver2015"):
        ds = sd.write_abundance(d, n, **sd.ABUNDANCE_SETS[n])
        jl.add(JAb(ds))
        tl.add(TAb(ds, device="cpu"))
    kw = dict(use_cmb=False, matter_power=True, z_pk=(0.0, 0.5, 1.0))
    jpost = JPost(JAstro(jnp.float64), JAstro(jnp.float64).default_space(),
                  jl, bbn_table=jtab, dtype=jnp.float64, **kw)
    tpost = TPost(TAstro(), TAstro().default_space(), tl, bbn_table=tab,
                  device="cpu", dtype=F64, **kw)

    def first(x, field=None):
        if torch.is_tensor(x):
            return x if field in SHARED_FIELDS else x[:1]
        if isinstance(x, dict):
            return {k: first(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(first(getattr(x, f), f) for f in x._fields))
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: first(getattr(x, f.name), f.name)
                for f in dataclasses.fields(x)})
        return x
    slow0 = first(state.slow)
    full0 = tpost.embed_full(torch.as_tensor(points[:1], dtype=F64))

    def stage_slow(full):
        assert torch.equal(full, full0)
        return slow0
    tpost.stage_slow = stage_slow
    calls, compute_theory = [], tpost.compute_theory
    tpost.compute_theory = lambda full: calls.append(
        compute_theory(full)) or calls[-1]
    jpost.compute_theory = jax.jit(jpost.compute_theory)
    got = tpost.per_likelihood(points[0])
    want = jpost.per_likelihood(jnp.asarray(points[0]))
    assert list(got) == list(want) == ["abund_DH", "abund_Yp"]
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-8,
                                   atol=1e-6, err_msg=name)
    theory, extras = calls[0]
    assert theory.cls is None and theory.mp.lnP.shape[0] == 1
    assert sorted(extras) == ["r_star", "yhe", "z_star", "zre"]
