"""CMB theory assembly: thermal history -> Boltzmann transfers.

Port of cosmomc_tpu/models/cmb.py (camb/camb.f90 CAMB_GetTransfers):
`compute_transfers` builds the evolution grid from a recombination history
and reionization redshift computed once by the caller, evolves every k of
every chain, and returns the distance to the visibility peak.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.perturbations import (build_thermo_funcs,
                                                    evolve_perturbations)
from cosmomc_tpu_torch.models.recfast import ThermoHistory


def source_k_grid(kmax: float = 0.45, nk_log: int = 48, nk_lin: int = 200,
                  kmin: float = 8e-5, k_switch: float = 0.0115) -> np.ndarray:
    """Coarse k grid for source evolution: log-spaced through horizon
    scales, linear through the acoustic oscillations (host numpy)."""
    klog = np.exp(np.linspace(np.log(kmin), np.log(k_switch), nk_log,
                              endpoint=False))
    klin = np.linspace(k_switch, kmax, nk_lin)
    return np.concatenate([klog, klin])


def compute_transfers(bg: BackgroundParams, th: ThermoHistory,
                      zre: torch.Tensor, yhe: torch.Tensor, k,
                      z_outputs: Tuple[float, ...] = (0.0,), n_step: int = 0,
                      massive_nu: bool = False, de_perts: bool = False,
                      iso_cdm_amp=0.0):
    """Slow stage: thermal tables + Boltzmann evolution for every chain;
    massive_nu / de_perts extend the evolved state and iso_cdm_amp (0.0
    or one amplitude a chain) adds the CDM-isocurvature admixture
    (perturbations.evolve_perturbations). Returns (transfers, chi_star
    (C,), ThermoFuncs)."""
    kw = dict(n_step=n_step) if n_step else {}
    tf, tau0 = build_thermo_funcs(bg, yhe, th, zre, **kw)
    k = torch.as_tensor(np.asarray(k), dtype=tf.tau.dtype, device=tf.tau.device)
    po = evolve_perturbations(bg, tf, tau0, k, z_outputs,
                              massive_nu=massive_nu, de_perts=de_perts,
                              iso_cdm_amp=iso_cdm_amp)
    ipk = torch.argmax(tf.vis, dim=-1, keepdim=True)
    chi_star = tau0 - tf.tau.gather(-1, ipk)[:, 0]
    return po, chi_star, tf
