"""Cluster queue layer: submit/track grid jobs on SLURM/PBS-style queues.

Port of cosmomc_tpu/grid/jobqueue.py. Reference: python/paramgrid/jobqueue.py (:1-40 submit + job tracking, the
job_script* templates). The reference renders a shell template per job
(walltime, nodes, program invocation), submits with qsub/sbatch/msub, and
records queue ids in a `jobdb` so `runbatch.py --checkpoint_run` can
re-submit unconverged jobs.

One grid job = one `python -m cosmomc_tpu_torch <ini>` invocation driving
a whole batch of chains on one GPU: no MPI rank fan-out, so the template
collapses to a single-task script with a GPU resource line. The submit command is pluggable (and fully
fake-able for tests: pass `submit_cmd=["echo"]`).
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from cosmomc_tpu_torch.grid.batchjob import BatchJob, JobItem

SLURM_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={log}
#SBATCH --time={walltime}
#SBATCH --nodes=1
#SBATCH --ntasks=1
{resource_line}
cd {work_dir}
{prolog}
{program} {ini}
"""

PBS_TEMPLATE = """#!/bin/bash
#PBS -N {name}
#PBS -o {log}
#PBS -l walltime={walltime}
#PBS -l nodes=1
cd {work_dir}
{prolog}
{program} {ini}
"""

TEMPLATES = {"slurm": SLURM_TEMPLATE, "pbs": PBS_TEMPLATE}
SUBMIT_CMDS = {"slurm": ["sbatch"], "pbs": ["qsub"]}
STATUS_CMDS = {"slurm": ["squeue", "-h", "-j"], "pbs": ["qstat"]}


@dataclass
class JobQueue:
    """Render job scripts, submit them, and track queue ids in a jobdb.

    jobdb format (one json file per batch, `<batch>/jobdb.json`):
      {job_name: {"queue_id": ..., "script": ..., "submitted": unixtime}}
    """
    batch: BatchJob
    queue: str = "slurm"                      # slurm | pbs
    program: str = "python -m cosmomc_tpu_torch"
    walltime: str = "08:00:00"
    resource_line: str = "#SBATCH --gres=gpu:1"
    prolog: str = ""                          # e.g. module loads / venv
    submit_cmd: Optional[Sequence[str]] = None   # override (tests: ["echo"])

    def __post_init__(self):
        if self.queue not in TEMPLATES:
            raise ValueError(f"unknown queue type {self.queue}")
        self._dbpath = os.path.join(self.batch.batch_path, "jobdb.json")

    # ---------- jobdb ----------

    def _load_db(self) -> Dict:
        if os.path.isfile(self._dbpath):
            with open(self._dbpath) as f:
                return json.load(f)
        return {}

    def _save_db(self, db: Dict) -> None:
        tmp = self._dbpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(db, f, indent=1)
        os.replace(tmp, self._dbpath)

    # ---------- scripts ----------

    def script_for(self, item: JobItem) -> str:
        """Render the job script for one grid item; returns the path."""
        path = item.ini_file[:-4] + (".sbatch" if self.queue == "slurm"
                                     else ".pbs")
        txt = TEMPLATES[self.queue].format(
            name=item.name, log=item.chain_root + ".joblog",
            walltime=self.walltime,
            resource_line=self.resource_line if self.queue == "slurm" else "",
            work_dir=os.path.abspath(self.batch.batch_path),
            prolog=self.prolog, program=self.program,
            ini=os.path.abspath(item.ini_file))
        with open(path, "w") as f:
            f.write(txt)
        os.chmod(path, 0o755)
        return path

    # ---------- submit / track ----------

    def submit(self, item: JobItem) -> str:
        """Submit one job; records and returns the queue id."""
        script = self.script_for(item)
        cmd = list(self.submit_cmd or SUBMIT_CMDS[self.queue]) + [script]
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        qid = self._parse_qid(out.stdout)
        db = self._load_db()
        db[item.name] = {"queue_id": qid, "script": script,
                         "submitted": time.time()}
        self._save_db(db)
        return qid

    @staticmethod
    def _parse_qid(stdout: str) -> str:
        # sbatch: "Submitted batch job 12345"; qsub: "12345.host"
        toks = stdout.split()
        return toks[-1] if toks else ""

    def submit_unfinished(self, r_tol: Optional[float] = None) -> List[str]:
        """Submit every grid item that is not yet converged (the
        runbatch.py --checkpoint_run re-submission loop)."""
        out = []
        for item in self.batch.unfinished(r_tol):
            out.append(self.submit(item))
        return out

    def queued_ids(self) -> Dict[str, str]:
        """{job_name: queue_id} of everything recorded in the jobdb."""
        return {k: v["queue_id"] for k, v in self._load_db().items()}

    def status_cmd(self, name: str) -> List[str]:
        """The queue-status command for a recorded job (caller runs it —
        keeping subprocess policy in the caller's hands)."""
        qid = self._load_db()[name]["queue_id"]
        return STATUS_CMDS[self.queue] + [qid]
