"""Parameter space: bounds, priors, start distribution, fast/slow blocking.

Reference semantics being reproduced (source/BaseParameters.f90):
  - ``param[name] = center`` fixes a parameter;
    ``param[name] = center min max start_width propose_width`` varies it
    (BaseParameters.f90:107-160);
  - ``prior[name] = mean std`` adds a Gaussian prior (…:162-203);
  - ``linear_combination[i] = w1 w2 ...`` + ``linear_combination_prior[i]``
    adds a Gaussian prior on a weighted sum of parameters (…:184-201);
  - start positions are sampled Gaussian around center with start_width,
    truncated to [min, max] (…:85-105);
  - parameters carry a *speed* class driving blocked proposals
    (tp_slow/semislow/semifast/fast, …:11-13, SetFastSlowParams :302-433).

Port of cosmomc_tpu/params/space.py. Host-side object (python/numpy);
`device_arrays(device, dtype)` exports a dict of tensors over the varying
parameters for the samplers and posteriors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cosmomc_tpu_torch.utils.ini import IniFile, IniError
from cosmomc_tpu_torch.utils.paramnames import ParamNames, ParamInfo


class Speed(IntEnum):
    """Proposal speed classes (reference: settings tp_* BaseParameters.f90:11-13)."""
    SLOW = 0        # forces new theory transfers (cosmological params)
    SEMISLOW = 1    # primordial power block: transfers reusable
    SEMIFAST = 2    # shared nuisance (e.g. calibration used by several likes)
    FAST = 3        # per-likelihood nuisance


@dataclass
class Param:
    name: str
    center: float
    min: float
    max: float
    start_width: float
    propose_width: float
    label: str = ""
    speed: Speed = Speed.SLOW
    prior_mean: Optional[float] = None
    prior_std: Optional[float] = None

    @property
    def varying(self) -> bool:
        return self.max > self.min and self.propose_width != 0.0


@dataclass
class LinearPrior:
    weights: Dict[str, float]   # param name -> coefficient
    mean: float
    std: float


class ParameterSpace:
    def __init__(self):
        self.params: List[Param] = []
        self._index: Dict[str, int] = {}
        self.linear_priors: List[LinearPrior] = []

    # ---------- construction ----------

    def add(self, p: Param) -> None:
        if p.name in self._index:
            raise ValueError(f"duplicate param {p.name}")
        self._index[p.name] = len(self.params)
        self.params.append(p)

    def add_from_ini(self, ini: IniFile, names: ParamNames,
                     default_speed: Speed = Speed.SLOW) -> None:
        """Read ``param[name] = ...`` lines for every name in `names`."""
        for info in names.sampled():
            key = f"param[{info.name}]"
            val = ini.string(key)
            if val is None:
                continue
            parts = [float(x) for x in val.split()]
            if len(parts) == 1:
                p = Param(info.name, parts[0], parts[0], parts[0], 0.0, 0.0,
                          label=info.label, speed=default_speed)
            elif len(parts) == 5:
                c, lo, hi, sw, pw = parts
                if not (lo <= c <= hi):
                    raise IniError(f"{key}: center {c} outside [{lo},{hi}]")
                p = Param(info.name, c, lo, hi, sw, pw, label=info.label,
                          speed=default_speed)
            else:
                raise IniError(f"{key}: expected 1 or 5 numbers, got {len(parts)}")
            prior = ini.string(f"prior[{info.name}]")
            if prior is not None:
                m, s = (float(x) for x in prior.split())
                p.prior_mean, p.prior_std = m, s
            self.add(p)
        # linear-combination priors
        i = 1
        while True:
            combo = ini.string(f"linear_combination[{i}]")
            if combo is None:
                break
            pr = ini.string(f"linear_combination_prior[{i}]", required=True)
            pnames = ini.string(f"linear_combination_params[{i}]", required=True).split()
            weights = dict(zip(pnames, (float(x) for x in combo.split())))
            m, s = (float(x) for x in pr.split())
            self.linear_priors.append(LinearPrior(weights, m, s))
            i += 1

    # ---------- queries ----------

    def index(self, name: str) -> int:
        return self._index[name]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def get(self, name: str) -> Param:
        return self.params[self._index[name]]

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.params]

    @property
    def varying(self) -> List[Param]:
        return [p for p in self.params if p.varying]

    @property
    def varying_indices(self) -> np.ndarray:
        return np.array([i for i, p in enumerate(self.params) if p.varying], np.int32)

    @property
    def num_varying(self) -> int:
        return len(self.varying)

    def speed_blocks(self) -> List[List[int]]:
        """Indices *within the varying vector* grouped by speed, slow first.

        Reference: BaseParameters.f90 SetFastSlowParams (:302-433) computes
        per-likelihood fast sub-blocks; we group by the Speed enum which the
        likelihood registry assigns when adding nuisance parameters.
        """
        var = self.varying
        blocks: List[List[int]] = []
        for s in sorted({p.speed for p in var}):
            blocks.append([i for i, p in enumerate(var) if p.speed == s])
        return blocks

    # ---------- device export ----------

    def device_arrays(self, device=None, dtype=torch.float32
                      ) -> Dict[str, torch.Tensor]:
        """Tensors over the *varying* parameter vector."""
        var = self.varying
        t = lambda vals, dt=dtype: torch.as_tensor(np.asarray(vals, np.float64)
                                                   if dt != torch.bool else
                                                   np.asarray(vals, bool),
                                                   dtype=dt, device=device)
        get = lambda attr: t([getattr(p, attr) for p in var])
        lin_w = np.zeros((len(self.linear_priors), len(var)))
        name_to_vi = {p.name: i for i, p in enumerate(var)}
        for k, lp in enumerate(self.linear_priors):
            for nm, w in lp.weights.items():
                if nm in name_to_vi:
                    lin_w[k, name_to_vi[nm]] = w
        return dict(
            center=get("center"), lo=get("min"), hi=get("max"),
            start_width=get("start_width"), propose_width=get("propose_width"),
            has_prior=t([p.prior_std is not None for p in var], torch.bool),
            prior_mean=t([p.prior_mean if p.prior_mean is not None else 0.0
                          for p in var]),
            prior_std=t([p.prior_std if p.prior_std is not None else 1.0
                         for p in var]),
            lin_w=t(lin_w),
            lin_mean=t([lp.mean for lp in self.linear_priors]),
            lin_std=t([lp.std for lp in self.linear_priors]),
        )

    def full_vector(self, varying_values: np.ndarray) -> np.ndarray:
        """Embed a varying-parameter vector into the full (incl. fixed) vector."""
        full = np.array([p.center for p in self.params], float)
        full[self.varying_indices] = np.asarray(varying_values, float)
        return full

    # ---------- propose matrix I/O ----------

    def load_covmat(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        """Read a `.covmat` with `# name1 name2 ...` header; returns
        (cov over varying params, mask of which varying params were matched).
        Unmatched parameters get their propose_width^2 on the diagonal
        (reference: IO.f90:13-60 name-mapped propose matrix read)."""
        with open(path) as f:
            header = f.readline()
        if not header.startswith("#"):
            raise IniError(f"covmat {path} missing '#' name header")
        file_names = header[1:].split()
        mat = np.loadtxt(path)
        if mat.ndim == 1:
            mat = mat.reshape(1, 1)
        var = self.varying
        n = len(var)
        cov = np.zeros((n, n))
        matched = np.zeros(n, bool)
        fmap = {nm: i for i, nm in enumerate(file_names)}
        # reference .covmat/.paramnames aliases (paramnames/params_CMB
        # .paramnames uses omegabh2/...; this package uses the ini-key
        # spellings ombh2/...)
        alias = {"ombh2": "omegabh2", "omch2": "omegach2",
                 "A_planck": "calPlanck", "omk": "omegak"}
        def fidx(p):
            if p.name in fmap:
                return fmap[p.name]
            return fmap.get(alias.get(p.name, ""), None)
        idx = [(i, fidx(p)) for i, p in enumerate(var)
               if fidx(p) is not None]
        for i, fi in idx:
            matched[i] = True
            for j, fj in idx:
                cov[i, j] = mat[fi, fj]
        for i, p in enumerate(var):
            if not matched[i]:
                cov[i, i] = p.propose_width ** 2
        return cov, matched

    def write_covmat(self, path: str, cov: np.ndarray) -> None:
        var = self.varying
        with open(path, "w") as f:
            f.write("# " + " ".join(p.name for p in var) + "\n")
            np.savetxt(f, np.asarray(cov), fmt="%17.9E")

    def param_names(self, derived: Optional[ParamNames] = None) -> ParamNames:
        pn = ParamNames()
        for p in self.varying:
            pn.add(ParamInfo(p.name, p.label, False))
        if derived is not None:
            for q in derived.names:
                pn.add(ParamInfo(q.name, q.label, True))
        return pn

    def write_ranges(self, path: str) -> None:
        with open(path, "w") as f:
            for p in self.varying:
                f.write(f"{p.name:22s} {p.min:17.9E} {p.max:17.9E}\n")
