"""Port parity of the grid layer (grid/: batchjob, gridconfig, jobqueue,
the `python -m cosmomc_tpu_torch.grid` CLI) against the JAX package's,
on tests/test_grid.py's and tests/test_grid_cli.py's small grids with a
synthetic DR12-shaped BAO set in place of the reference data:
  - the same settings give the same job names, layout, importance links
    and `batch.json`; every written ini equal to JAX's byte for byte once
    the batch directory is cut out, and every job script equal but for the
    program string (`python -m cosmomc_tpu_torch`) and the GPU resource
    line;
  - the converge_stat polling, run_batch's submit callable, the queue
    layer with a fake sbatch, and the CLI's make / run / status, as the
    JAX tests check them;
  - a one-job grid with one importance rerun through the in-process
    driver on the CPU; the JAX tests' end-to-end cell is marked slow here
    too (chip_smoke.py phase 13 runs the grid on the card).
"""

import json
import os

import numpy as np
import pytest

from cosmomc_tpu.grid import make_grid as jmake_grid
from cosmomc_tpu.grid.batchjob import DataSet as JDataSet
from cosmomc_tpu.grid.jobqueue import JobQueue as JJobQueue

from cosmomc_tpu_torch.grid import BatchJob, DataSet, make_grid, run_batch
from cosmomc_tpu_torch.grid.__main__ import main
from cosmomc_tpu_torch.grid.jobqueue import JobQueue

from test_torch_importance_minimize import write_background_sets


@pytest.fixture(scope="module")
def dr12(tmp_path_factory):
    return write_background_sets(str(tmp_path_factory.mktemp("grid")))["dr12"]


def small_settings(tmp_path, dr12, ds=DataSet, **defaults):
    bao_ini = tmp_path / "bao.ini"
    bao_ini.write_text(
        f"bao_dataset[DR12] = {dr12}\n"
        "use_HST = T\n"
        "Hubble_H0 = 73.45\nHubble_H0_err = 1.66\nHubble_zeff = 0\n")
    return {
        "params": [[], ["w"]],
        "param_ini_keys": {"w": {"param[w]": "-1 -3 1 0.1 0.05"}},
        "datasets": [ds("bao", [str(bao_ini)]),
                     ds(["bao", "hst"], [str(bao_ini), {"use_HST": "T"}])],
        "importance_runs": [("HST", {"use_HST": "T"})],
        "defaults": {"samples": "4000", "num_chains": "32",
                     "segment_steps": "64", "MPI_R_Stop": "0.5",
                     "feedback": "0", "parameterization": "background",
                     **defaults},
    }


def _text(path, batch_dir):
    return open(path).read().replace(batch_dir, "<batch>")


def test_grid_same_as_jax(tmp_path, dr12):
    jb = jmake_grid(str(tmp_path / "jgrid"),
                    small_settings(tmp_path, dr12, JDataSet))
    tb = make_grid(str(tmp_path / "tgrid"), small_settings(tmp_path, dr12))
    assert tb.item_names() == jb.item_names()
    for ji, ti in zip(jb.items, tb.items):
        assert _text(ti.ini_file, tb.batch_path) == \
            _text(ji.ini_file, jb.batch_path)
        assert os.path.relpath(ti.chain_root, tb.batch_path) == \
            os.path.relpath(ji.chain_root, jb.batch_path)
        assert (ti.importance_of is None) == (ji.importance_of is None)
    assert _text(os.path.join(tb.batch_path, "batch.json"), tb.batch_path) == \
        _text(os.path.join(jb.batch_path, "batch.json"), jb.batch_path)
    for queue in ("slurm", "pbs"):
        jq, tq = JJobQueue(jb, queue=queue), JobQueue(tb, queue=queue)
        assert tq.program == "python -m cosmomc_tpu_torch"
        for ji, ti in zip(jb.items, tb.items):
            js = _text(jq.script_for(ji), jb.batch_path).replace(
                "python -m cosmomc_tpu ", "python -m cosmomc_tpu_torch ")
            ts = _text(tq.script_for(ti), tb.batch_path)
            assert ts == js.replace("--gres=tpu:1", "--gres=gpu:1")
            assert "python -m cosmomc_tpu_torch " in ts


def test_grid_structure(tmp_path, dr12):
    batch = make_grid(str(tmp_path / "grid"), small_settings(tmp_path, dr12))
    names = batch.item_names()
    # 2 param sets x 2 datasets x (1 + 1 importance) = 8 items
    assert len(names) == 8
    assert "base_bao" in names and "base_w_bao_hst" in names
    assert "base_bao_post_HST" in names
    it = batch.job("base_bao")
    assert it.chain_root.endswith("base/bao/base_bao")
    assert os.path.isfile(it.ini_file)
    assert batch.job("base_bao_post_HST").importance_of is it


def test_grid_persistence_roundtrip(tmp_path, dr12):
    batch = make_grid(str(tmp_path / "grid"), small_settings(tmp_path, dr12))
    loaded = BatchJob.load(batch.batch_path)
    assert loaded.item_names() == batch.item_names()
    assert loaded.job("base_bao_post_HST").importance_of.name == "base_bao"


def test_converge_stat_polling(tmp_path, dr12):
    batch = make_grid(str(tmp_path / "grid"), small_settings(tmp_path, dr12))
    it = batch.job("base_bao")
    assert not it.is_converged()
    assert batch.unfinished() == batch.items
    os.makedirs(it.chain_dir, exist_ok=True)
    with open(it.chain_root + ".converge_stat", "w") as f:
        f.write("0.0213\n")
    r, done = it.converge_stat()
    assert r == pytest.approx(0.0213) and not done
    assert it.is_converged(r_tol=0.05)
    assert not it.is_converged(r_tol=0.01)
    with open(it.chain_root + ".converge_stat", "w") as f:
        f.write("0.0213\nDone\n")
    assert it.is_converged()


def test_run_batch_with_custom_submit(tmp_path, dr12):
    batch = make_grid(str(tmp_path / "grid"), small_settings(tmp_path, dr12))
    submitted = []
    run_batch(batch, submit=lambda it: submitted.append(it.name) or 0)
    assert len(submitted) == len(batch.items)
    it = batch.job("base_bao")
    os.makedirs(it.chain_dir, exist_ok=True)
    with open(it.chain_root + ".converge_stat", "w") as f:
        f.write("0.001\nDone\n")
    submitted.clear()
    run_batch(batch, submit=lambda it: submitted.append(it.name) or 0)
    assert "base_bao" not in submitted and len(submitted) == 7


def test_jobqueue_scripts_and_submit(tmp_path, dr12):
    batch = make_grid(str(tmp_path / "grid"), small_settings(tmp_path, dr12))
    fake = tmp_path / "fake_sbatch.sh"
    fake.write_text("#!/bin/sh\necho Submitted batch job 4242\n")
    fake.chmod(0o755)
    q = JobQueue(batch, queue="slurm", submit_cmd=[str(fake)],
                 walltime="01:00:00")
    ids = q.submit_unfinished()
    assert ids and all(i == "4242" for i in ids)
    assert set(q.queued_ids().values()) == {"4242"}
    item = batch.items[0]
    script = open(q.script_for(item)).read()
    assert "#SBATCH --job-name=" in script and "#SBATCH --gres=gpu:1" in script
    assert f"python -m cosmomc_tpu_torch {item.ini_file}" in script
    assert q.status_cmd(item.name)[-1] == "4242"
    s2 = open(JobQueue(batch, queue="pbs",
                       submit_cmd=[str(fake)]).script_for(item)).read()
    assert "#PBS -N" in s2


def test_one_job_and_importance_on_cpu(tmp_path, dr12):
    """One background job and its HST importance rerun through the
    in-process driver on the CPU (a short run: 8 chains, 512 steps, enough
    for RunConfig's 50 accepts per block before rows are written)."""
    settings = small_settings(tmp_path, dr12, samples="512", num_chains="8",
                              device="cpu")
    settings["params"] = [[]]
    settings["datasets"] = [DataSet("bao", [str(tmp_path / "bao.ini"),
                                            {"use_HST": "F"}])]
    batch = make_grid(str(tmp_path / "grid"), settings)
    assert batch.item_names() == ["base_bao", "base_bao_post_HST"]
    assert run_batch(batch) == {"base_bao": 0, "base_bao_post_HST": 0}
    it = batch.job("base_bao")
    assert it.chains_exist()
    r, _ = it.converge_stat()
    assert r is not None and np.isfinite(r)
    post = batch.job("base_bao_post_HST").chain_root + "_post"
    assert os.path.isfile(post + "_1.txt") and os.path.isfile(post + ".paramnames")


@pytest.mark.slow
def test_one_grid_cell_end_to_end(tmp_path, dr12):
    """tests/test_grid.py's end-to-end cell on the port, on the CPU."""
    settings = small_settings(tmp_path, dr12, device="cpu")
    settings["params"] = [[]]
    settings["datasets"] = [settings["datasets"][0]]
    settings["importance_runs"] = []
    batch = make_grid(str(tmp_path / "grid"), settings)
    assert run_batch(batch) == {"base_bao": 0}
    it = batch.job("base_bao")
    assert it.chains_exist()
    r, _done = it.converge_stat()
    assert r is not None and np.isfinite(r)


# ---------------------------------------- tests/test_grid_cli.py's cases


@pytest.fixture
def settings_py(tmp_path, dr12):
    bao_ini = tmp_path / "bao.ini"
    bao_ini.write_text(f"bao_dataset[DR12] = {dr12}\n")
    p = tmp_path / "settings_grid.py"
    p.write_text(
        "params = [[], ['w']]\n"
        "param_ini_keys = {'w': {'param[w]': '-1 -3 1 0.1 0.05'}}\n"
        f"datasets = [DataSet('bao', [{str(bao_ini)!r}])]\n"
        "importance_runs = [('HST', {'use_HST': 'T'})]\n"
        "defaults = {'samples': '4000', 'feedback': '0',\n"
        "            'parameterization': 'background'}\n")
    return str(p)


def test_make_run_status(tmp_path, settings_py, capsys):
    batch_dir = str(tmp_path / "grid")
    assert main(["make", batch_dir, settings_py]) == 0
    out = capsys.readouterr().out
    assert "4 jobs" in out and "base_w_bao" in out
    assert os.path.isfile(os.path.join(batch_dir, "iniFiles", "base_bao.ini"))
    assert main(["run", batch_dir, "--queue", "slurm",
                 "--submit-cmd", "echo"]) == 0
    assert "submitted base_bao" in capsys.readouterr().out
    db = json.load(open(os.path.join(batch_dir, "jobdb.json")))
    assert db["base_bao"]["script"].endswith(".sbatch")
    assert "python -m cosmomc_tpu_torch " in open(db["base_bao"]["script"]).read()
    assert main(["status", batch_dir, "--r-tol", "0.05"]) == 0
    assert "# 0/4 converged" in capsys.readouterr().out
    it = BatchJob.load(batch_dir).job("base_bao")
    os.makedirs(it.chain_dir, exist_ok=True)
    with open(it.chain_root + ".converge_stat", "w") as f:
        f.write("0.0213\n")
    assert main(["status", batch_dir, "--r-tol", "0.05"]) == 0
    s = capsys.readouterr().out
    assert "# 1/4 converged" in s and "R-1=0.0213" in s


def test_make_from_json(tmp_path, dr12):
    bao_ini = tmp_path / "bao.ini"
    bao_ini.write_text(f"bao_dataset[DR12] = {dr12}\n")
    j = tmp_path / "settings.json"
    j.write_text(json.dumps({
        "params": [[]],
        "datasets": [[["bao"], [str(bao_ini)]]],
        "defaults": {"samples": "100", "parameterization": "background"},
    }))
    batch_dir = str(tmp_path / "grid")
    assert main(["make", batch_dir, str(j)]) == 0
    assert os.path.isfile(os.path.join(batch_dir, "iniFiles", "base_bao.ini"))
