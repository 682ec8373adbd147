"""Port parity of the ini driver (driver.py, __main__.py): the
`python -m cosmomc_tpu_torch params.ini` surface against the JAX
package's `run_ini`, float64 on the CPU (`device=cpu`).

A synthetic background ini (a DR12-shaped BAO set + HST, the JAX
package's tests/test_driver.py layout) runs through both drivers:
  - action 4: -logL at the centre 1e-9 relative to the JAX posterior's,
    the per-likelihood chi^2 table line for line, the test_check_compare
    gate (0 within 0.05, 1 off it), `.inputparams` equal but for the port's
    own keys (device, bbn_table);
  - action 0: tests/test_driver.py:60-77's outputs, and with
    sampling_method = hmc;
  - action 2: `.minimum` -logL within 1e-6 of JAX's L-BFGS-B optimum
    (and not above it by more than 1e-8: the port's run refines at low
    temperature) and its parameters within 1e-6 relative,
    `.hessian.covmat` the inverse of `jax.hessian` there within 1e-5
    relative;
  - action 1 from stored chains: the post chains' numbers 1e-10 relative;
  - the param[...] override, the CLI (`main`), the raises.
CMB and astro inis: `build_posterior`'s configuration against JAX's
(space, likelihood names, lmax, lmax_computed, matter_power,
compute_tensors, use_cmb, derived names) without evaluating any theory;
LCDM+r built by `param[r]` (JAX's driver raises NameError there).
"""

import os
import re

import numpy as np
import pytest
import torch

from cosmomc_tpu import driver as jdriver
from cosmomc_tpu.models import bbn as jbbn
from cosmomc_tpu.utils.ini import IniFile as JIni

from cosmomc_tpu_torch import driver as tdriver
from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch import pipeline as tpipe
from cosmomc_tpu_torch.likelihoods import synthetic as sd
from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
from cosmomc_tpu_torch.params.space import Speed
from cosmomc_tpu_torch.utils.ini import IniFile

from test_torch_importance_minimize import write_background_sets

#: the port's own ini keys, absent from JAX's .inputparams
PORT_KEYS = ("device", "bbn_table")
MLL_RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_bbn_cache_untouched():
    """Leave JAX's default BBN table cache as each test found it empty.
    The tests here that build JAX posteriors set COSMOMC_DATA to a
    synthetic grid, and `cosmomc_tpu.models.bbn.load_bbn_table` caches by
    its `path=None` argument, not by the variable: without the clears the
    synthetic table would outlive monkeypatch and serve every later JAX
    test of the same process."""
    jbbn.load_bbn_table.cache_clear()
    yield
    jbbn.load_bbn_table.cache_clear()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic sets: DR12-shaped BAO, a plik_lite fiducial from a smooth
    made-up spectrum, an LRG DR4-format P(k) set, and the reference-format
    BBN grid under the JAX package's default file name."""
    d = str(tmp_path_factory.mktemp("drv"))
    out = write_background_sets(d)
    ls = np.arange(2, 2701)
    tt = 1000.0 + 5000.0 * np.exp(-((ls - 220.0) / 250.0) ** 2)
    ee = 5.0 + 40.0 * np.exp(-((ls - 1000.0) / 400.0) ** 2)
    te = 0.1 * np.sqrt(tt * ee) * np.cos(ls / 150.0)
    np.savetxt(os.path.join(d, "fake.theory_cl"), np.column_stack(
        [ls, tt, te, ee, 0.01 * ee, 1e-7 * np.ones_like(ls)]))
    out["plik"] = write_plik_lite_fiducial(os.path.join(d, "plik"),
                                           os.path.join(d, "fake.theory_cl"))
    lrg = sd.lrg_layout(seed=1)
    out["mpk"] = sd.write_lrg_mpk(os.path.join(d, "lrg"), lrg,
                                  np.full(len(lrg["k_eff"]), 2e4))
    out["bbn_dir"] = d
    sd.write_bbn_table(os.path.join(d, tdriver.DEFAULT_BBN_TABLE))
    return out


def write_ini(path, data, body):
    path.write_text(f"""
file_root = {path.parent}/chains/test
parameterization = background
bao_dataset[DR12] = {data['dr12']}
use_HST = T
Hubble_H0 = 73.48
Hubble_H0_err = 1.66
param[omegam] = 0.3 0.1 0.7 0.02 0.02
param[H0] = 70 40 100 2 2
{body}
""")
    return str(path)


def run_both(tmp_path, data, body, capsys):
    """The same ini through JAX's run_ini and the port's (device=cpu), each
    in a directory of its own: (rc, stdout, file_root) for each."""
    out = []
    for name, run in (("jax", jdriver.run_ini),
                      ("port", lambda p: tdriver.run_ini(p, device="cpu"))):
        (tmp_path / name).mkdir()
        rc = run(write_ini(tmp_path / name / "params.ini", data, body))
        out.append((rc, capsys.readouterr().out,
                    str(tmp_path / name / "chains" / "test")))
    return out


def _inputparams(root):
    """The .inputparams lines but the port's keys, with each run's own
    directory (the file_root) cut out."""
    lines = open(root + ".inputparams").read().replace(
        os.path.dirname(os.path.dirname(root)), "").splitlines()
    return [ln for ln in lines if ln.split(" = ")[0] not in PORT_KEYS]


def _mll(out):
    return float(out.split("Test -log(Like) =")[1].split()[0])


def test_action4(tmp_path, data, capsys):
    (jrc, jout, jroot), (trc, tout, troot) = run_both(
        tmp_path, data, "action = 4\n", capsys)
    assert jrc == trc == 0
    post = jdriver.build_posterior(JIni(str(tmp_path / "jax" / "params.ini")))
    P = np.array([p.center for p in post.space.varying])
    ref = float(post.logpost()(P)[0])
    assert abs(_mll(tout) - ref) <= MLL_RTOL * abs(ref)
    assert abs(_mll(jout) - _mll(tout)) < 1e-6
    table = re.compile(r"^\s+(\S+)\s+chi2 =\s+(\S+)$", re.M)
    assert table.findall(tout) == table.findall(jout)
    assert [n for n, _ in table.findall(tout)] == ["DR12", "HST"]
    assert _inputparams(troot) == _inputparams(jroot)
    # the gate: 0 at the value, 1 off it by more than 0.05
    ini = str(tmp_path / "port" / "params.ini")
    assert tdriver.run_ini(ini, {"test_check_compare": repr(ref + 0.01)},
                           device="cpu") == 0
    assert tdriver.run_ini(ini, {"test_check_compare": "99.0"},
                           device="cpu") == 1
    assert jdriver.run_ini(str(tmp_path / "jax" / "params.ini"),
                           {"test_check_compare": "99.0"}) == 1
    assert "MISMATCH" in capsys.readouterr().out


def test_action0_outputs(tmp_path, data):
    """tests/test_driver.py:60-77 on the port."""
    path = write_ini(tmp_path / "params.ini", data, """action = 0
num_chains = 32
segment_steps = 64
samples = 512
MPI_R_Stop = 0.0
feedback = 0
""")
    assert tdriver.run_ini(path, device="cpu") == 0
    root = f"{tmp_path}/chains/test"
    for ext in ("_1.txt", ".paramnames", ".ranges", ".converge_stat",
                ".inputparams", ".margestats", ".covmat", ".likestats",
                ".log", ".chk.npz"):
        assert os.path.exists(root + ext), ext
    dat = np.loadtxt(root + "_1.txt")
    assert dat.shape[1] >= 2 + 2
    assert "slow/semi/fast" in open(root + ".log").read()


def test_action0_hmc(tmp_path, data, capsys):
    """sampling_method = hmc on the background ini: warmup from the
    proposal widths' mass, chains and GetDist outputs written."""
    path = write_ini(tmp_path / "params.ini", data, """action = 0
sampling_method = hmc
num_chains = 16
hmc_warmup_segments = 3
hmc_leapfrog_steps = 6
segment_steps = 8
samples = 32
MPI_R_Stop = 0
feedback = 0
""")
    assert tdriver.run_ini(path, device="cpu") == 0
    acc = float(capsys.readouterr().out.split("accept =")[1].split(",")[0])
    assert acc > 0.4, acc
    root = f"{tmp_path}/chains/test"
    for ext in ("_16.txt", ".paramnames", ".ranges", ".inputparams",
                ".margestats", ".covmat"):
        assert os.path.exists(root + ext), ext


def test_action2(tmp_path, data):
    """The port's action 2 against JAX's minimizer (L-BFGS-B, refine off)
    and `jax.hessian` on the JAX driver's posterior of the same ini; the
    port's run refines at low temperature, which may only lower -logL."""
    import jax
    import jax.numpy as jnp
    from cosmomc_tpu.sampling.minimize import find_best_fit
    path = write_ini(tmp_path / "params.ini", data, "action = 2\n")
    assert tdriver.run_ini(path, device="cpu") == 0
    root = f"{tmp_path}/chains/test"
    txt = open(root + ".minimum").read()
    tm = float(txt.split("-log(Like) =")[1].split()[0])
    rows = [ln.split() for ln in txt.splitlines()[3:] if ln.strip()]
    assert [r[2] for r in rows] == ["omegam", "H0", "ombh2"]
    jpost = jdriver.build_posterior(JIni(path))
    best = find_best_fit(jpost.logpost(), jpost.space, refine_temperature=None)
    assert tm <= best.mloglike + 1e-8 and abs(tm - best.mloglike) < 1e-6
    np.testing.assert_allclose([float(r[1]) for r in rows], best.P, rtol=1e-6)
    H = np.asarray(jax.jit(jax.hessian(lambda p: jpost.logpost()(p)[0]))(
        jnp.asarray(best.P)))
    np.testing.assert_allclose(np.linalg.inv(np.loadtxt(root + ".hessian.covmat")),
                               0.5 * (H + H.T), rtol=1e-5)
    assert os.path.isfile(root + ".inputparams")


def test_action1_from_stored_chains(tmp_path, data, capsys):
    """Chains written by the port's action 0, reweighted without HST by
    both drivers."""
    store = write_ini(tmp_path / "store.ini", data, """action = 0
num_chains = 8
segment_steps = 64
samples = 512
MPI_R_Stop = 0.0
feedback = 0
write_stats = F
""")
    assert tdriver.run_ini(store, device="cpu") == 0
    redo = f"{tmp_path}/chains/test"
    assert np.loadtxt(redo + "_1.txt").ndim == 2
    body = f"action = 1\nredo_root = {redo}\nuse_HST = F\n"
    (jrc, jout, jroot), (trc, tout, troot) = run_both(tmp_path, data, body,
                                                      capsys)
    assert jrc == trc == 0
    eff = [float(o.split("eff frac =")[1].split()[0]) for o in (jout, tout)]
    assert eff[0] == eff[1] and 0 < eff[1] <= 1
    for c in range(1, 9):
        np.testing.assert_allclose(np.loadtxt(f"{troot}_post_{c}.txt"),
                                   np.loadtxt(f"{jroot}_post_{c}.txt"),
                                   rtol=1e-10)
    assert open(troot + "_post.paramnames").read() == \
        open(redo + ".paramnames").read()


def test_param_override(tmp_path, data):
    """param[...] ini lines override defaults (BaseParameters.f90:107-160)."""
    ini = tmp_path / "p.ini"
    ini.write_text(f"parameterization = background\n"
                   f"bao_dataset[DR12] = {data['dr12']}\n"
                   f"param[omegam] = 0.31 0.2 0.4 0.01 0.01\ndevice = cpu\n")
    om = tdriver.build_posterior(IniFile(str(ini))).space.get("omegam")
    assert om.center == pytest.approx(0.31) and om.min == pytest.approx(0.2)


# ------------------------------------------- CMB and astro configurations

CMB_INIS = {
    "flagship": "pliklite_dataset = {plik}\nbao_dataset[DR12] = {dr12}\n"
                "prior[tau] = 0.0544 0.0073\n",
    "matter_power": "pliklite_dataset = {plik}\nuse_matter_power = T\n"
                    "lmax = 2000\n",
    "splice": "pliklite_dataset = {plik}\nlmax_computed_cl = 1500\n"
              "highL_theory_cl_template = {tmpl}\n",
    "mnu_w": "pliklite_dataset = {plik}\nparam[mnu] = 0.06 0 5 0.1 0.03\n"
             "param[w] = -1 -3 1 0.1 0.05\n",
    "astro": "parameterization = astro\nuse_mpk = T\nmpk_numdatasets = 1\n"
             "mpk_dataset1 = {mpk}\nbao_dataset[DR12] = {dr12}\n",
}


def _config(post):
    return dict(
        space=[(p.name, p.center, p.min, p.max, p.propose_width, int(p.speed),
                p.prior_mean, p.prior_std) for p in post.space.params],
        likes=[l.name for l in post.likes.likes], lmax=post.lmax,
        lmax_computed=post.lmax_computed, matter_power=post.matter_power,
        compute_tensors=post.compute_tensors, use_cmb=post.use_cmb,
        derived=list(post.derived_names), z_pk=tuple(post.z_pk),
        kmax=post.kmax)


@pytest.mark.parametrize("case", sorted(CMB_INIS))
def test_cmb_configurations(tmp_path, data, monkeypatch, case):
    monkeypatch.setenv("COSMOMC_DATA", data["bbn_dir"])
    tmpl = str(tmp_path / "highl.dat")
    ls = np.arange(2, 2601)
    np.savetxt(tmpl, np.column_stack([ls, 1000.0 + 0 * ls, 10.0 + 0 * ls,
                                      0.1 + 0 * ls, 1.0 + 0 * ls]))
    ini = tmp_path / "cmb.ini"
    ini.write_text(CMB_INIS[case].format(tmpl=tmpl, **data))
    jpost = jdriver.build_posterior(JIni(str(ini)))
    tpost = tdriver.build_posterior(IniFile(str(ini)), device="cpu")
    assert isinstance(tpost, tpipe.CMBPosterior)
    assert _config(tpost) == _config(jpost)
    assert tpost.dtype == torch.float64


def test_lcdm_r_builds(tmp_path, data, monkeypatch):
    """compute_tensors = T with param[r]: the port builds LCDM+r with r
    semi-slow at the ini's values; the JAX driver calls `Param` without
    importing it (driver.py:185-188) and raises NameError."""
    monkeypatch.setenv("COSMOMC_DATA", data["bbn_dir"])
    ini = tmp_path / "r.ini"
    ini.write_text(f"pliklite_dataset = {data['plik']}\ncompute_tensors = T\n"
                   "param[r] = 0.1 0 2 0.04 0.04\n")
    with pytest.raises(NameError):
        jdriver.build_posterior(JIni(str(ini)))
    post = tdriver.build_posterior(IniFile(str(ini)), device="cpu")
    r = post.space.get("r")
    assert post.compute_tensors
    assert (r.center, r.min, r.max, r.start_width, r.propose_width) == \
        (0.1, 0.0, 2.0, 0.04, 0.04)
    assert r.speed == Speed.SEMISLOW and r.varying


# ---------------------------------------------------------------- raises


#: LCDM+r, also with mnu free: their slow paths have reverse kernels (the
#: tensor kernels K5, K6; K1's massive-neutrino hierarchy), so action 2 and
#: HMC go on to the theory
LCDM_R_INIS = {
    "lcdm_r": "compute_tensors = T\nparam[r] = 0.1 0 2 0.04 0.04\n",
    "lcdm_r_mnu": ("compute_tensors = T\nparam[r] = 0.1 0 2 0.04 0.04\n"
                   "param[mnu] = 0.06 0 5 0.1 0.03\n"),
}


class _Theory(Exception):
    """Raised by the stubbed slow stage: the driver reached the theory."""


@pytest.mark.parametrize("config", sorted(LCDM_R_INIS))
@pytest.mark.parametrize("body", ["action = 2", "sampling_method = hmc"])
def test_slow_stage_without_gradients_raises(tmp_path, data, monkeypatch,
                                             body, config):
    """Action 2 and HMC on LCDM+r inis (also with mnu free) pass the
    gradient guard and reach the theory (stubbed here), with K5's
    checkpoints taken from boltzmann_remat_chunks; no kernel is launched
    on the CPU. Only the recurrence line of sight still refuses
    (tests/test_torch_grad_guard.py)."""
    monkeypatch.setenv("COSMOMC_DATA", data["bbn_dir"])

    def theory(*a, **k):
        raise _Theory
    monkeypatch.setattr(tpipe.CMBPosterior, "stage_slow", theory)
    ini = tmp_path / "flag.ini"
    ini.write_text(f"file_root = {tmp_path}/c/flag\npliklite_dataset = "
                   f"{data['plik']}\n{LCDM_R_INIS[config]}{body}\n")
    post = tdriver.build_posterior(IniFile(str(ini)), device="cpu")
    assert post.compute_tensors and post.gradient_unsupported() is None
    assert post.remat_chunks == (64 if "hmc" in body else 0)
    kernels.reset_launches()
    with pytest.raises(_Theory):
        tdriver.run_ini(str(ini), device="cpu")
    assert not any(kernels.launches.values())


def test_default_device_and_devices_raise(tmp_path, data):
    path = write_ini(tmp_path / "params.ini", data, "action = 4\n")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdriver.run_ini(path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdriver.main([path])
    with pytest.raises(NotImplementedError):
        tdriver.run_ini(path, {"action": "0", "num_devices": "4"},
                        device="cpu")


def test_cli_main(tmp_path, data, capsys):
    path = write_ini(tmp_path / "params.ini", data, "action = 4\n")
    assert tdriver.main([path, "device=cpu"]) == 0
    assert "Test -log(Like) =" in capsys.readouterr().out
    assert tdriver.main([path, "device = cpu", "test_check_compare=99"]) == 1
    assert "device = cpu" in open(f"{tmp_path}/chains/test.inputparams").read()
    assert tdriver.main([]) == 2
