"""Theory products consumed by likelihoods (port of
cosmomc_tpu/models/theory.py): NamedTuples of per-chain tensors in place of
the TCosmoTheoryPredictions pytrees.

`BackgroundTheory` is what a background-only posterior computes (distance
tables and the drag sound horizon); `CMBTheoryProducts` adds the C_l.
Neither carries matter power yet, so `fsigma8_at` raises."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.models.background import (BackgroundFunctions,
                                                 BackgroundParams)


def _no_matter_power(z):
    raise NotImplementedError(
        "f_sigma8 needs the full matter power, which is not ported yet "
        "(ROADMAP queue 1, step 14); drop the f_sigma8 dataset rows")


class BackgroundTheory(NamedTuple):
    bg: BackgroundParams
    bf: BackgroundFunctions
    rs_drag: torch.Tensor                 # (C,)

    def fsigma8_at(self, z):
        _no_matter_power(z)


class CMBTheoryProducts(NamedTuple):
    bg: BackgroundParams
    bf: BackgroundFunctions
    rs_drag: torch.Tensor                 # (C,)
    #: (C, 4, 4, lmax+1) TEBP stack, l(l+1)C_l/2pi muK^2; PP [l(l+1)]^2 C/2pi
    cls: Optional[torch.Tensor] = None

    def fsigma8_at(self, z):
        _no_matter_power(z)


def compute_background_theory(bg: BackgroundParams,
                              fixed_rs: Optional[float] = None
                              ) -> BackgroundTheory:
    """Distance tables and the drag sound horizon; `fixed_rs` is the
    reference's BAO_fixed_rs for runs without a thermal history."""
    bf = bgm.background_functions(bg)
    rs = (torch.full_like(bg.ombh2, fixed_rs) if fixed_rs
          else bgm.r_drag_approx(bg))
    return BackgroundTheory(bg, bf, rs)


def background_derived(th: BackgroundTheory) -> torch.Tensor:
    """(C, 4) derived values in `BACKGROUND_DERIVED_NAMES` order."""
    bg = th.bg
    h2 = (bg.H0 / 100.0) ** 2
    omm = (bg.ombh2 + bg.omch2 + bg.omnuh2) / h2
    oml = 1.0 - bg.omk - omm
    return torch.stack([bg.H0 * torch.ones_like(bg.ombh2), omm, oml,
                        th.rs_drag], -1)


BACKGROUND_DERIVED_NAMES = [
    ("H0", "H_0"), ("omegam", r"\Omega_m"), ("omegal", r"\Omega_\Lambda"),
    ("rdrag", r"r_{\rm drag}"),
]
