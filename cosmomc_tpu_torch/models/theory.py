"""Theory products consumed by likelihoods (port of
cosmomc_tpu/models/theory.py): NamedTuples of per-chain tensors in place of
the TCosmoTheoryPredictions pytrees.

`BackgroundTheory` is what a background-only posterior computes (distance
tables and the drag sound horizon); `CMBTheoryProducts` adds the C_l and,
when the posterior computes matter power, sigma8(z) and f sigma8(z) on the
z_pk table and the P(k, z) tables themselves."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.models.background import (BG_FIELDS,
                                                 BackgroundFunctions,
                                                 BackgroundParams)
from cosmomc_tpu_torch.utils.interp import interp


class BackgroundTheory(NamedTuple):
    bg: BackgroundParams
    bf: BackgroundFunctions
    rs_drag: torch.Tensor                 # (C,)

    def fsigma8_at(self, z):
        raise ValueError(
            "this run's theory stage computes no matter power: f_sigma8 "
            "measurement rows need CMBTheoryProducts (use a posterior with "
            "matter_power enabled, or drop the f_sigma8 dataset rows)")


def _at_z(z_pk: torch.Tensor, table: torch.Tensor, z) -> torch.Tensor:
    """Linear interpolation of a (C, nz) table in z: a float gives (C,), a
    (n,) tensor (C, n)."""
    zq = torch.as_tensor(z, dtype=table.dtype, device=table.device)
    out = interp(zq.reshape(1, -1).expand(table.shape[0], -1), z_pk, table)
    return out[:, 0] if zq.dim() == 0 else out


class CMBTheoryProducts(NamedTuple):
    bg: BackgroundParams
    bf: BackgroundFunctions
    rs_drag: torch.Tensor                 # (C,)
    #: (C, 4, 4, lmax+1) TEBP stack, l(l+1)C_l/2pi muK^2; PP [l(l+1)]^2 C/2pi
    cls: Optional[torch.Tensor] = None
    #: matter-power summaries on z_pk (nz,) ascending, each (C, nz), or None
    z_pk: Optional[torch.Tensor] = None
    sigma8_z: Optional[torch.Tensor] = None
    fsigma8_z: Optional[torch.Tensor] = None
    #: the P(k, z) tables (models/matterpower.MatterPower) for likelihoods
    #: that integrate over the power spectrum (MPK)
    mp: Optional[object] = None

    def fsigma8_at(self, z) -> torch.Tensor:
        """f sigma8(z) from the table (bao.f90:264-306 f_sigma8 rows)."""
        if self.fsigma8_z is None:
            raise ValueError(
                "f_sigma8 requested but matter power was not computed; "
                "enable matter_power on the posterior")
        return _at_z(self.z_pk, self.fsigma8_z, z)

    def sigma8_at(self, z) -> torch.Tensor:
        if self.sigma8_z is None:
            raise ValueError("sigma8 requested but matter power not computed")
        return _at_z(self.z_pk, self.sigma8_z, z)


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


def in_dtype(theory: CMBTheoryProducts, dtype: torch.dtype) -> CMBTheoryProducts:
    """The theory's background, distance tables, sigma8(z) tables and
    P(k, z) tables in `dtype` (the C_l are left as they are): a
    likelihood that keeps float64 reads a float32 theory through this."""
    bg = dataclasses.replace(theory.bg, **{f: getattr(theory.bg, f).to(dtype)
                                           for f in BG_FIELDS})
    bf = theory.bf
    bf = BackgroundFunctions(bg, bf.lz_grid.to(dtype), bf.chi_grid.to(dtype),
                             bf.curvature_k.to(dtype), bf.dchi_grid.to(dtype))
    cast = lambda v: None if v is None else v.to(dtype)
    mp = theory.mp
    if mp is not None:
        mp = mp._replace(**{f: cast(getattr(mp, f)) for f in mp._fields})
    return theory._replace(bg=bg, bf=bf, rs_drag=cast(theory.rs_drag),
                           z_pk=cast(theory.z_pk),
                           sigma8_z=cast(theory.sigma8_z),
                           fsigma8_z=cast(theory.fsigma8_z), mp=mp)
