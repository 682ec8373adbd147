"""Likelihood framework (port of cosmomc_tpu/likelihoods/base.py;
GeneralTypes.f90 TDataLikelihood / TLikelihoodList).

A likelihood is a host-side object built from its `.dataset` files with
its data on a device, exposing

    log_like(theory, nuisance) -> chi2/2 per chain, (C,)

with `nuisance` its (C, n_nuisance) slice of the sampled vectors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch

from cosmomc_tpu_torch.params.space import Param, ParameterSpace, Speed
from cosmomc_tpu_torch.utils.ini import IniFile


class Likelihood:
    """Base likelihood. Subclasses move their data to a device at init."""
    kind: str = "generic"
    name: str = ""
    speed: Speed = Speed.FAST

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self.nuisance: List[Param] = []

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclass
class LikelihoodList:
    """Ordered collection wiring nuisance blocks into the parameter space."""
    likes: List[Likelihood] = field(default_factory=list)

    def add(self, like: Likelihood) -> None:
        self.likes.append(like)

    def add_nuisance_to_space(self, space: ParameterSpace) -> Dict[str, slice]:
        """Append each likelihood's nuisance params to the space; returns
        {likelihood name: slice into the *varying* vector}."""
        slices: Dict[str, slice] = {}
        for like in self.likes:
            before = space.num_varying
            for p in like.nuisance:
                if p.name not in space:
                    space.add(p)
            slices[like.name] = slice(before, space.num_varying)
        return slices

    def total_log_like(self, theory, varying: torch.Tensor,
                       slices: Dict[str, slice]):
        """(sum of chi^2/2, per-likelihood values), each per chain."""
        total = torch.zeros(varying.shape[0], dtype=varying.dtype,
                            device=varying.device)
        per = []
        for like in self.likes:
            val = like.log_like(theory, varying[:, slices[like.name]])
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
