"""Grid orchestration: build and track a grid of (model x dataset) runs.

Port of cosmomc_tpu/grid/batchjob.py. Reference: python/paramgrid/batchjob.py (dataSet :72, jobItem :201,
batchJob :436) + gridconfig.py makeGrid (:72). The reference builds a
directory tree `batchPath/base_<params>_<data>/` of ini files, submits each
to a cluster queue (one MPI job per chain set), polls `.converge_stat` for
doneness, and chains importance-sampled reruns off finished jobs.

Here a "job" is one posterior sampled with all its chains batched on one
card: there is no per-chain process fan-out, so the queue layer collapses
to a local executor (the in-process driver) or a user-supplied submit
callable for a real cluster. The grid bookkeeping — name composition,
directory layout, ini generation, convergence polling, importance
chaining — keeps the reference's layout so downstream tooling (getdist
grids) works unchanged.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union



def non_empty_file(path: str) -> bool:
    return os.path.exists(path) and os.path.getsize(path) > 0


@dataclass
class DataSet:
    """A named combination of likelihood ini fragments (dataSet :72)."""
    names: List[str]
    params: List[Union[str, Dict[str, str]]] = field(default_factory=list)

    def __post_init__(self):
        if isinstance(self.names, str):
            self.names = [self.names]
        if not self.params:
            self.params = [n + ".ini" for n in self.names]

    @property
    def tag(self) -> str:
        return "_".join(self.names)

    def extended(self, name: str,
                 params: Union[str, Dict[str, str]]) -> "DataSet":
        """New DataSet with an extra likelihood fragment appended."""
        return DataSet(self.names + [name], self.params + [params])

    def extend_for_importance(self, name: str,
                              params: Union[str, Dict[str, str]]) -> "DataSet":
        ds = DataSet(list(self.names), list(self.params))
        ds.names = ds.names + [("post_" if "_post_" not in self.tag else "")
                               + name]
        ds.params = ds.params + [params]
        return ds


@dataclass
class JobItem:
    """One grid cell: a parameter-tag set x a DataSet (jobItem :201)."""
    batch_path: str
    param_tag: str          # e.g. "base" or "base_mnu"
    data: DataSet
    base: str = "base"
    param_extensions: List[str] = field(default_factory=list)
    importance_of: Optional["JobItem"] = None
    ini_keys: Dict[str, str] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.param_tag + "_" + self.data.tag

    @property
    def chain_dir(self) -> str:
        return os.path.join(self.batch_path, self.param_tag, self.data.tag)

    @property
    def chain_root(self) -> str:
        return os.path.join(self.chain_dir, self.name)

    @property
    def ini_file(self) -> str:
        return os.path.join(self.batch_path, "iniFiles", self.name + ".ini")

    # ---- status (reference polls <root>.converge_stat; batchjob.py
    #      jobItem.chainFinished/convergeStat) ----

    def converge_stat(self) -> tuple[Optional[float], bool]:
        path = self.chain_root + ".converge_stat"
        if not non_empty_file(path):
            return None, False
        lines = open(path).read().split("\n")
        try:
            r = float(lines[0])
        except (ValueError, IndexError):
            return None, False
        done = any(ln.strip() == "Done" for ln in lines[1:])
        return r, done

    def chains_exist(self) -> bool:
        return non_empty_file(self.chain_root + "_1.txt")

    def is_converged(self, r_tol: Optional[float] = None) -> bool:
        r, done = self.converge_stat()
        if done:
            return True
        return r is not None and r_tol is not None and r <= r_tol

    # ---- ini generation ----

    def write_ini(self, common_defaults: Sequence[str] = (),
                  extra: Optional[Dict[str, str]] = None) -> str:
        os.makedirs(os.path.dirname(self.ini_file), exist_ok=True)
        os.makedirs(self.chain_dir, exist_ok=True)
        lines = [f"# grid job {self.name}"]
        keys: Dict[str, str] = {}
        for frag in self.data.params:
            if isinstance(frag, dict):
                keys.update({k: str(v) for k, v in frag.items()})
            else:
                lines.append(f"DEFAULT({frag})")
        keys.update(self.ini_keys)
        if extra:
            keys.update({k: str(v) for k, v in extra.items()})
        keys["file_root"] = self.chain_root
        if self.importance_of is not None:
            keys["action"] = keys.get("action", "1")
            keys["redo_root"] = self.importance_of.chain_root
        for k, v in keys.items():
            lines.append(f"{k} = {v}")
        for frag in common_defaults:
            lines.append(f"DEFAULT({frag})")
        with open(self.ini_file, "w") as f:
            f.write("\n".join(lines) + "\n")
        return self.ini_file


@dataclass
class BatchJob:
    """The whole grid (batchJob :436): all job items + persistence."""
    batch_path: str
    items: List[JobItem] = field(default_factory=list)

    def add(self, item: JobItem) -> None:
        self.items.append(item)

    def job(self, name: str) -> JobItem:
        for it in self.items:
            if it.name == name:
                return it
        raise KeyError(name)

    def item_names(self) -> List[str]:
        return [it.name for it in self.items]

    def unfinished(self, r_tol: Optional[float] = None) -> List[JobItem]:
        return [it for it in self.items if not it.is_converged(r_tol)]

    # ---- persistence (replaces batch.pyobj pickle with readable json) ----

    def save(self) -> str:
        path = os.path.join(self.batch_path, "batch.json")
        os.makedirs(self.batch_path, exist_ok=True)
        rec = {"batch_path": self.batch_path,
               "items": [{
                   "param_tag": it.param_tag,
                   "names": it.data.names,
                   "params": it.data.params,
                   "ini_keys": it.ini_keys,
                   "importance_of": (it.importance_of.name
                                     if it.importance_of else None),
               } for it in self.items]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return path

    @classmethod
    def load(cls, batch_path: str) -> "BatchJob":
        with open(os.path.join(batch_path, "batch.json")) as f:
            rec = json.load(f)
        batch = cls(rec["batch_path"])
        by_name: Dict[str, JobItem] = {}
        deferred = []
        for r in rec["items"]:
            it = JobItem(batch.batch_path, r["param_tag"],
                         DataSet(r["names"], r["params"]),
                         ini_keys=r.get("ini_keys", {}))
            batch.add(it)
            by_name[it.name] = it
            if r.get("importance_of"):
                deferred.append((it, r["importance_of"]))
        for it, parent in deferred:
            it.importance_of = by_name[parent]
        return batch


def run_batch(batch: BatchJob, r_tol: Optional[float] = None,
              submit: Optional[Callable[[JobItem], int]] = None,
              checkpoint_run: bool = False, device=None) -> Dict[str, int]:
    """Execute (or re-submit) every unfinished job (runbatch.py semantics;
    `checkpoint_run` reruns jobs whose chains exist but haven't converged).
    Default executor runs the ini through the in-process driver, on
    `device` when given (else each ini's `device` key, "cuda" by
    default)."""
    results: Dict[str, int] = {}
    for it in batch.items:
        if it.is_converged(r_tol):
            continue
        if checkpoint_run and not it.chains_exist():
            continue
        if submit is not None:
            results[it.name] = submit(it)
        else:
            from cosmomc_tpu_torch.driver import run_ini
            results[it.name] = run_ini(it.ini_file, device=device)
    return results
