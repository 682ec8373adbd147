"""Grid construction from a settings description (gridconfig.py makeGrid).

Reference: python/paramgrid/gridconfig.py:72 — cross product of parameter
extensions x dataset combinations x importance reruns, described by a
settings .py module (e.g. planck/settings_planck_2018.py). Here the settings
are a plain dict (or any object with the same attributes), keeping the same
vocabulary:

    settings = {
      "params": [[], ["mnu"], ["nnu", "mnu"]],      # extensions over base
      "datasets": [DataSet(...), ...],
      "importance_runs": [("BAO", {"bao_dataset[post]": "..."}), ...],
      "defaults": {"samples": "100000", ...},       # keys in every ini
      "common": ["common.ini"],                     # DEFAULT() fragments
      "skip": ["base_mnu_lens"],                    # excluded job names
      "param_ini_keys": {"mnu": {"param[mnu]": "0.06 0 5 0.1 0.03"}},
    }
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

from cosmomc_tpu_torch.grid.batchjob import BatchJob, DataSet, JobItem


def param_tag(base: str, extensions: Sequence[str]) -> str:
    return "_".join([base] + list(extensions))


def make_grid(batch_path: str, settings: Dict,
              write_inis: bool = True) -> BatchJob:
    """Build the BatchJob for a settings dict (makeGrid, gridconfig.py:72)."""
    base = settings.get("base", "base")
    skip = set(settings.get("skip", ()))
    param_ini_keys: Dict[str, Dict[str, str]] = settings.get(
        "param_ini_keys", {})
    defaults = dict(settings.get("defaults", {}))
    common = list(settings.get("common", ()))

    batch = BatchJob(os.path.abspath(batch_path))
    for exts in settings.get("params", [[]]):
        tag = param_tag(base, exts)
        keys = dict(defaults)
        for e in exts:
            keys.update({k: str(v) for k, v in
                         param_ini_keys.get(e, {}).items()})
        for data in settings.get("datasets", []):
            item = JobItem(batch.batch_path, tag, data,
                           param_extensions=list(exts), ini_keys=dict(keys))
            if item.name in skip:
                continue
            batch.add(item)
            # importance-sampling reruns chained off this job
            for imp_name, imp_params in settings.get("importance_runs", []):
                imp = JobItem(batch.batch_path, tag,
                              data.extend_for_importance(imp_name, imp_params),
                              param_extensions=list(exts),
                              ini_keys=dict(keys), importance_of=item)
                if imp.name not in skip:
                    batch.add(imp)
    if write_inis:
        for it in batch.items:
            it.write_ini(common_defaults=common)
        batch.save()
    return batch
