"""`python -m cosmomc_tpu_torch.grid` — the grid lifecycle CLI (port of
cosmomc_tpu/grid/__main__.py).

The user surface of the reference's grid scripts (SURVEY §2.8):

  make   <batch_dir> <settings.{py,json}>   python/makeGrid.py
  run    <batch_dir> [--queue ...]          python/runbatch.py
  status <batch_dir> [--r-tol X]           python/checkConverge.py

`make` accepts either a JSON file holding the settings dict, or a python
settings module (reference style, e.g. planck/settings_planck_2018.py):
the module is executed and must expose either a `settings` dict or
top-level names matching the make_grid() vocabulary (params, datasets,
importance_runs, defaults, common, skip, param_ini_keys, base).

`run` with no --queue executes each unfinished ini through the in-process
driver sequentially (runbatch on a workstation; on the card unless the
ini's `device` key asks for the CPU); with --queue slurm|pbs it
renders job scripts and submits them via JobQueue (runbatch on a cluster;
--submit-cmd overrides the submission binary, e.g. for dry runs).

`status` prints one line per grid job: R-1 from the `.converge_stat`
sidecar, whether chains exist, and the converged verdict — the
checkConverge.py loop.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from cosmomc_tpu_torch.grid.batchjob import BatchJob, DataSet, run_batch
from cosmomc_tpu_torch.grid.gridconfig import make_grid
from cosmomc_tpu_torch.grid.jobqueue import JobQueue

_SETTINGS_KEYS = ("base", "params", "datasets", "importance_runs",
                  "defaults", "common", "skip", "param_ini_keys")


def _load_settings(path: str) -> dict:
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
        # JSON datasets: ["names"] or [["names"...], [params...]] rows
        ds = []
        for d in raw.get("datasets", []):
            if isinstance(d, (list, tuple)) and len(d) == 2 \
                    and isinstance(d[0], (list, tuple)):
                ds.append(DataSet(list(d[0]), list(d[1])))
            else:
                ds.append(DataSet(d))
        raw["datasets"] = ds
        return raw
    # python settings module, reference-style
    ns: dict = {"DataSet": DataSet}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), ns)
    if isinstance(ns.get("settings"), dict):
        return ns["settings"]
    return {k: ns[k] for k in _SETTINGS_KEYS if k in ns}


def cmd_make(a) -> int:
    settings = _load_settings(a.settings)
    batch = make_grid(a.batch_dir, settings, write_inis=True)
    print(f"{len(batch.items)} jobs in {batch.batch_path}")
    for it in batch.items:
        print(" ", it.name)
    return 0


def cmd_run(a) -> int:
    batch = BatchJob.load(a.batch_dir)
    if a.queue:
        q = JobQueue(batch, queue=a.queue, walltime=a.walltime,
                     program=a.program,
                     submit_cmd=a.submit_cmd.split() if a.submit_cmd else None)
        qids = q.submit_unfinished(a.r_tol)
        for name, qid in zip([i.name for i in batch.unfinished(a.r_tol)],
                             qids):
            print(f"submitted {name}: {qid}")
        return 0
    results = run_batch(batch, r_tol=a.r_tol,
                        checkpoint_run=a.checkpoint_run)
    bad = {k: v for k, v in results.items() if v != 0}
    for k, v in results.items():
        print(f"{k}: rc={v}")
    return 1 if bad else 0


def cmd_status(a) -> int:
    batch = BatchJob.load(a.batch_dir)
    n_conv = 0
    for it in batch.items:
        r, done = it.converge_stat()
        conv = it.is_converged(a.r_tol)
        n_conv += conv
        rtxt = "-" if r is None else f"{r:.4f}"
        print(f"{it.name:<48s} R-1={rtxt:<10s} "
              f"chains={int(it.chains_exist())} converged={int(conv)}")
    print(f"# {n_conv}/{len(batch.items)} converged")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cosmomc_tpu_torch.grid",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pm = sub.add_parser("make", help="build a grid from a settings file")
    pm.add_argument("batch_dir")
    pm.add_argument("settings")
    pm.set_defaults(fn=cmd_make)

    pr = sub.add_parser("run", help="run/submit unfinished grid jobs")
    pr.add_argument("batch_dir")
    pr.add_argument("--r-tol", type=float, default=None)
    pr.add_argument("--checkpoint-run", action="store_true",
                    help="only rerun jobs whose chains exist but have not "
                         "converged")
    pr.add_argument("--queue", choices=["slurm", "pbs"], default=None)
    pr.add_argument("--walltime", default="08:00:00")
    pr.add_argument("--program", default="python -m cosmomc_tpu_torch")
    pr.add_argument("--submit-cmd", default=None,
                    help="override the submission command (e.g. 'echo' "
                         "for a dry run)")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("status", help="per-job convergence report")
    ps.add_argument("batch_dir")
    ps.add_argument("--r-tol", type=float, default=None)
    ps.set_defaults(fn=cmd_status)

    a = p.parse_args(argv)
    return a.fn(a)


if __name__ == "__main__":
    raise SystemExit(main())
