"""CMB theory assembly: thermal history -> Boltzmann transfers -> C_l.

Port of cosmomc_tpu/models/cmb.py (camb/camb.f90 CAMB_GetTransfers and
CAMB_TransfersToPowers): `compute_transfers` builds the evolution grid from
a recombination history and reionization redshift computed once by the
caller, evolves every k of every chain, and returns the distance to the
visibility peak; `cls_from_transfers` is the semi-slow stage in muK^2;
`compute_cmb_theory` runs the whole chain (K4, K1, K2a) for each chain.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.cls import CMBSpectra, compute_cls
from cosmomc_tpu_torch.models.perturbations import (PerturbationOutput,
                                                    build_thermo_funcs,
                                                    evolve_perturbations)
from cosmomc_tpu_torch.models.primordial import PrimordialParams
from cosmomc_tpu_torch.models.recfast import ThermoHistory, compute_thermo
from cosmomc_tpu_torch.models.reionization import zre_from_tau


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
                      iso_cdm_amp=0.0, remat_chunks: int = 0):
    """Slow stage: thermal tables + Boltzmann evolution for every chain;
    massive_nu / de_perts extend the evolved state and iso_cdm_amp (0.0
    or one amplitude a chain) adds the CDM-isocurvature admixture, and
    remat_chunks checkpoints the evolution's gradient
    (perturbations.evolve_perturbations). Returns (transfers, chi_star
    (C,), ThermoFuncs)."""
    kw = dict(n_step=n_step) if n_step else {}
    tf, tau0 = build_thermo_funcs(bg, yhe, th, zre, **kw)
    k = torch.as_tensor(np.asarray(k), dtype=tf.tau.dtype, device=tf.tau.device)
    po = evolve_perturbations(bg, tf, tau0, k, z_outputs,
                              massive_nu=massive_nu, de_perts=de_perts,
                              iso_cdm_amp=iso_cdm_amp, remat_chunks=remat_chunks)
    ipk = torch.argmax(tf.vis, dim=-1, keepdim=True)
    chi_star = tau0 - tf.tau.gather(-1, ipk)[:, 0]
    return po, chi_star, tf


class CMBTheory(NamedTuple):
    spectra: CMBSpectra            # l(l+1)C_l/2pi in muK^2, each (C, L)
    transfers: PerturbationOutput
    chi_star: torch.Tensor         # (C,)
    tau0: torch.Tensor             # (C,)


def cls_from_transfers(po: PerturbationOutput, chi_star: torch.Tensor,
                       pp: PrimordialParams, tcmb_k=2.7255, lmax: int = 2500,
                       tau0_hint: float = 14700.0, kmax_hint: float = 0.6,
                       points_per_osc: float = 4.0, coarse_k=None,
                       tau_stride: int = 1) -> CMBSpectra:
    """Semi-slow stage (TransfersToPowers): C_l in l(l+1)C_l/2pi muK^2
    (phi-phi unscaled). `tcmb_k` is a float or one temperature a chain
    (C, 1); `coarse_k` the host grid the sources were evolved on."""
    raw = compute_cls(po, pp, chi_star, lmax=lmax, tau0_hint=tau0_hint,
                      kmax_hint=kmax_hint, points_per_osc=points_per_osc,
                      coarse_k=coarse_k, tau_stride=tau_stride)
    muk2 = (tcmb_k * 1e6) ** 2
    return CMBSpectra(raw.ls, raw.tt * muk2, raw.te * muk2, raw.ee * muk2,
                      raw.pp)


def compute_cmb_theory(bg: BackgroundParams, pp: PrimordialParams,
                       tau_reion: torch.Tensor, yhe: torch.Tensor,
                       lmax: int = 2500, kmax: float = 0.45) -> CMBTheory:
    """Background + tau -> C_l for every chain: recombination (K4), z_re
    from tau, transfers on `source_k_grid(kmax)` (K1) and the LOS (K2a)."""
    k = source_k_grid(kmax)
    po, chi_star, _ = compute_transfers(bg, compute_thermo(bg, yhe),
                                        zre_from_tau(bg, tau_reion, yhe),
                                        yhe, k)
    spec = cls_from_transfers(po, chi_star, pp, tcmb_k=bg.tcmb[:, None],
                              lmax=lmax, coarse_k=k)
    return CMBTheory(spec, po, chi_star, po.tau0)
