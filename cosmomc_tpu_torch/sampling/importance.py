"""Importance re-weighting of stored chains (action=1).

Port of cosmomc_tpu/sampling/importance.py (reference:
source/ImportanceSampling.f90): re-evaluate -logL at every stored point
under a new posterior, reweight each point by exp(old - new) and rescale
by the weighted-mean log-ratio before exponentiating (:13-48).

The posterior is batched, (C, n) -> (-logL (C,), derived (C, nd)), so the
stored rows go through it in blocks of `batch` rows under
`torch.no_grad()`. Each row is a chain of its own there, so the result
does not depend on the block size; the block only bounds the memory. A
CMB posterior holds its per-chain transfer tables for every row of a
block, so the driver passes a small block for one (`CMB_BATCH`).

Semantics:
  - `new_logpost`: the new posterior. If it contains the OLD likelihoods
    plus new ones, pass mode="replace" (reference redo_add=F, the
    default); to ADD a correction on top of the stored -logL, build it
    with only the new datasets and pass mode="add" (redo_add=T).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.io.chains import load_chain

#: rows a block for a posterior with a slow stage (the driver's choice)
CMB_BATCH = 64


@dataclass
class ImportanceResult:
    samples: np.ndarray      # (N, n) varying parameters
    weights: np.ndarray      # (N,) new weights
    mloglike: np.ndarray     # (N,) new -logL
    eff_frac: float          # ESS fraction = (sum w)^2 / (N sum w^2)


def importance_sample_arrays(samples: np.ndarray, weights: np.ndarray,
                             old_mll: np.ndarray, new_logpost: Callable,
                             mode: str = "replace", batch: int = 8192,
                             max_exp: float = 30.0, device="cuda",
                             dtype=torch.float64) -> ImportanceResult:
    """Reweight stored samples under a new posterior.

    mode="replace": w *= exp(old - new); the new -logL replaces the old.
    mode="add":     w *= exp(-delta);    new total = old + delta.
    `samples` must contain only the sampled (non-derived) columns.
    """
    device = kernels.entry_device(device, "importance_sample_arrays")
    outs = []
    with torch.no_grad():
        for i in range(0, len(samples), batch):
            blk = torch.as_tensor(np.asarray(samples[i:i + batch]),
                                  dtype=dtype, device=device)
            outs.append(new_logpost(blk)[0].double().cpu().numpy())
    new_val = np.concatenate(outs)
    if mode == "replace":
        log_ratio = old_mll - new_val          # log(new/old posterior)
        new_mll = new_val
    elif mode == "add":
        log_ratio = -new_val
        new_mll = old_mll + new_val
    else:
        raise ValueError(mode)
    # auto offset (weighted mean), clip extreme ratios like logZero guards
    finite = np.isfinite(log_ratio)
    off = np.average(log_ratio[finite], weights=weights[finite]) \
        if finite.any() else 0.0
    lr = np.where(finite, log_ratio - off, -np.inf)
    w = weights * np.exp(np.clip(lr, -max_exp, max_exp))
    w[~np.isfinite(w)] = 0.0
    wsum = w.sum()
    eff = float(wsum ** 2 / (len(w) * (w ** 2).sum())) if wsum > 0 else 0.0
    return ImportanceResult(samples, w, new_mll, eff)


def importance_sample_chains(root: str, new_logpost: Callable,
                             post_root: str, mode: str = "replace",
                             ignore_frac: float = 0.0, batch: int = 8192,
                             device="cuda", dtype=torch.float64
                             ) -> ImportanceResult:
    """Reweight chain files <root>_i.txt -> <post_root>_i.txt (the
    reference's `post_root` convention). Chain columns beyond the sampled
    block (derived values) pass through unchanged; the sampled count comes
    from the .paramnames sidecar when present."""
    device = kernels.entry_device(device, "importance_sample_chains")
    n_sampled = None
    if os.path.isfile(root + ".paramnames"):
        from cosmomc_tpu_torch.utils.paramnames import ParamNames
        n_sampled = len(ParamNames.from_file(root + ".paramnames").sampled())
    i = 1
    results = []
    while os.path.isfile(f"{root}_{i}.txt"):
        ch = load_chain(f"{root}_{i}.txt")
        cut = int(ignore_frac * len(ch["weights"]))
        cols = ch["samples"][cut:]
        ns = n_sampled if n_sampled is not None else cols.shape[1]
        res = importance_sample_arrays(cols[:, :ns], ch["weights"][cut:],
                                       ch["mloglike"][cut:], new_logpost,
                                       mode=mode, batch=batch, device=device,
                                       dtype=dtype)
        keep = res.weights > 0
        out = np.column_stack([res.weights[keep], res.mloglike[keep],
                               cols[keep]])
        os.makedirs(os.path.dirname(post_root) or ".", exist_ok=True)
        np.savetxt(f"{post_root}_{i}.txt", out, fmt="%.7E")
        results.append(res)
        i += 1
    if not results:
        raise FileNotFoundError(f"no chains for root {root}")
    # sidecars travel with the new root
    for ext in (".paramnames", ".ranges"):
        if os.path.isfile(root + ext):
            with open(root + ext) as f_in, open(post_root + ext, "w") as f_out:
                f_out.write(f_in.read())
    allw = np.concatenate([r.weights for r in results])
    alls = np.concatenate([r.samples for r in results])
    allm = np.concatenate([r.mloglike for r in results])
    wsum = allw.sum()
    eff = float(wsum ** 2 / (len(allw) * (allw ** 2).sum())) if wsum > 0 else 0.0
    return ImportanceResult(alls, allw, allm, eff)
