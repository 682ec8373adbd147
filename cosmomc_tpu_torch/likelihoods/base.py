"""Likelihood framework (port of cosmomc_tpu/likelihoods/base.py;
GeneralTypes.f90 TDataLikelihood / TLikelihoodList).

A likelihood is a host-side object built from its `.dataset` files with
its data on a device, exposing

    log_like(theory, nuisance) -> chi2/2 per chain, (C,)

with `nuisance` its (C, n_nuisance) slice of the sampled vectors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from cosmomc_tpu_torch.params.space import Param, ParameterSpace, Speed
from cosmomc_tpu_torch.utils.ini import IniFile
from cosmomc_tpu_torch.utils.paramnames import ParamNames


class Likelihood:
    """Base likelihood. Subclasses move their data to a device at init."""
    kind: str = "generic"
    name: str = ""
    speed: Speed = Speed.FAST

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self.nuisance: List[Param] = []

    def add_nuisance_from_paramnames(self, path: str,
                                     ini: Optional[IniFile] = None,
                                     defaults: Optional[dict] = None) -> None:
        """Register the sampled entries of a .paramnames file as nuisance
        parameters, in its order: centre and range from `param[name]` ini
        lines (with `prior[name]`), else from `defaults` (a 1-tuple fixes
        the parameter), as the JAX package's base class does."""
        for info in ParamNames.from_file(path).sampled():
            spec = ini.string(f"param[{info.name}]") if ini is not None else None
            if spec is not None:
                spec = [float(x) for x in spec.split()]
            elif defaults and info.name in defaults:
                spec = defaults[info.name]
            else:
                raise ValueError(
                    f"{self.name}: no param[] spec for nuisance {info.name}")
            if len(spec) == 1:
                p = Param(info.name, spec[0], spec[0], spec[0], 0.0, 0.0,
                          label=info.label, speed=Speed.FAST)
            else:
                p = Param(info.name, *spec[:5], label=info.label,
                          speed=Speed.FAST)
            if ini is not None and ini.string(f"param[{info.name}]") is not None:
                pr = ini.string(f"prior[{info.name}]")
                if pr:
                    p.prior_mean, p.prior_std = (float(x) for x in pr.split())
            self.nuisance.append(p)

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def nuisance_values(self, nuisance: torch.Tensor) -> torch.Tensor:
        """The varying columns (C, n_varying) -> every nuisance parameter's
        value (C, n), the fixed ones at their centres. The centres and
        column indices are copied to the device once per set of varying
        flags and centres (an ini override may change them after
        construction)."""
        key = (nuisance.device, nuisance.dtype,
               tuple((p.varying, p.center) for p in self.nuisance))
        cache = self.__dict__.setdefault("_nuisance_fill", {})
        if key not in cache:
            cache[key] = (
                torch.as_tensor([p.center for p in self.nuisance],
                                dtype=nuisance.dtype, device=nuisance.device),
                torch.as_tensor([i for i, p in enumerate(self.nuisance)
                                 if p.varying], dtype=torch.int64,
                                device=nuisance.device))
        cent, var = cache[key]
        return cent.expand(nuisance.shape[0], -1).index_copy(1, var, nuisance)


@dataclass
class LikelihoodList:
    """Ordered collection wiring nuisance blocks into the parameter space."""
    likes: List[Likelihood] = field(default_factory=list)
    #: index lists of add_nuisance_to_space as tensors, per (list, device):
    #: indexing with a host list copies it to the card, which waits for it
    _cols: dict = field(default_factory=dict, repr=False, compare=False)

    def add(self, like: Likelihood) -> None:
        self.likes.append(like)

    def add_nuisance_to_space(self, space: ParameterSpace) -> Dict[str, object]:
        """Append each likelihood's nuisance params to the space; returns
        {likelihood name: its varying nuisance parameters' columns in the
        *varying* vector}, a slice, or an index list where a likelihood
        shares a parameter by name with one before it (SPTpol TE/EE and BB
        both have beam1, beam2). The JAX package gives every likelihood the
        slice of the parameters it added, which reads the wrong columns for
        a shared name; without one the two agree."""
        slices: Dict[str, object] = {}
        for like in self.likes:
            before = space.num_varying
            for p in like.nuisance:
                if p.name not in space:
                    space.add(p)
            cols = {p.name: i for i, p in enumerate(space.varying)}
            own = []
            for p in like.nuisance:
                if p.varying:
                    if p.name not in cols:
                        raise ValueError(
                            f"{like.name}: nuisance {p.name} varies here but "
                            "is fixed by an earlier likelihood")
                    own.append(cols[p.name])
            contiguous = own == list(range(before, space.num_varying))
            slices[like.name] = (slice(before, space.num_varying)
                                 if contiguous else own)
        return slices

    def total_log_like(self, theory, varying: torch.Tensor,
                       slices: Dict[str, object]):
        """(sum of chi^2/2, per-likelihood values), each per chain."""
        total = torch.zeros(varying.shape[0], dtype=varying.dtype,
                            device=varying.device)
        per = []
        for like in self.likes:
            cols = slices[like.name]
            if not isinstance(cols, slice):
                key = (tuple(cols), varying.device)
                if key not in self._cols:
                    self._cols[key] = torch.as_tensor(cols, device=varying.device)
                cols = self._cols[key]
            val = like.log_like(theory, varying[:, cols])
            per.append(val)
            total = total + val
        return total, (torch.stack(per, -1) if per else
                       torch.zeros_like(varying[:, :0]))


def read_dataset_ini(path: str) -> IniFile:
    """Load a `.dataset` file; relative file keys resolve against its dir."""
    import os
    ini = IniFile(path)
    ini.search_dirs.append(os.path.dirname(os.path.abspath(path)))
    return ini
