"""Carry values computed by the JAX package (given as numpy arrays, or any
object with the same attribute names) into the port's tensors.

Used to feed one module at a time with the reference's intermediates, so a
mismatch points at one kernel. Unbatched reference values (one cosmology)
gain a leading chains axis of length 1; values already batched over chains
(outputs of a vmapped function) keep theirs.
"""

from __future__ import annotations

import numpy as np
import torch

from cosmomc_tpu_torch.models.background import (BG_FIELDS, BackgroundFunctions,
                                                 BackgroundParams)
from cosmomc_tpu_torch.models.bbn import BBNTable
from cosmomc_tpu_torch.models.cls import ClTransferCache
from cosmomc_tpu_torch.models.matterpower import MatterPower, MatterTransfers
from cosmomc_tpu_torch.models.perturbations import (PerturbationOutput,
                                                    ThermoFuncs)
from cosmomc_tpu_torch.models.recfast import ThermoHistory
from cosmomc_tpu_torch.models.tensors import TensorOutput, TensorTransferCache
from cosmomc_tpu_torch.models.theory import BackgroundTheory
from cosmomc_tpu_torch.sampling.metropolis import ChainState
from cosmomc_tpu_torch.sampling.staged import StagedChainState


def tensor(x, device=None, dtype=torch.float64) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def _batched(x, ndim: int, device, dtype) -> torch.Tensor:
    """`x` as a tensor with a leading chains axis: arrays of `ndim` axes
    are one chain's value and get a chains axis of length 1."""
    a = np.asarray(x)
    if a.ndim == ndim:
        a = a[None]
    return tensor(a, device, dtype)


def background_params(bg, device=None, dtype=torch.float64) -> BackgroundParams:
    return BackgroundParams(**{k: _batched(getattr(bg, k), 0, device, dtype)
                               for k in BG_FIELDS},
                            num_massive_nu=int(bg.num_massive_nu))


def bbn_table(tab) -> BBNTable:
    return BBNTable(float(tab.ombh2_0), float(tab.ombh2_step), float(tab.dn_0),
                    float(tab.dn_step), np.asarray(tab.yp), np.asarray(tab.ypbbn),
                    np.asarray(tab.dh), np.asarray(tab.sig_yp),
                    np.asarray(tab.sig_dh))


def thermo_history(th, device=None, dtype=torch.float64) -> ThermoHistory:
    return ThermoHistory(*[_batched(getattr(th, f), 1, device, dtype)
                           for f in ThermoHistory._fields])


def thermo_funcs(tf, device=None, dtype=torch.float64) -> ThermoFuncs:
    return ThermoFuncs(*[_batched(getattr(tf, f), 1, device, dtype)
                         for f in ThermoFuncs._fields])


def perturbation_output(po, device=None, dtype=torch.float64
                        ) -> PerturbationOutput:
    """JAX PerturbationOutput (k, tau layout) -> the port's (C, k, tau)."""
    one = np.asarray(po.s0).ndim == 2
    b = lambda x, nd: _batched(x, nd, device, dtype)
    k = np.asarray(po.k)
    return PerturbationOutput(
        tau=b(po.tau, 1), k=tensor(k if one else k[0], device, dtype),
        s0=b(po.s0, 2), s1=b(po.s1, 2), s2=b(po.s2, 2), spol=b(po.spol, 2),
        slens=b(po.slens, 2), delta_m=b(po.delta_m, 1), r_init=b(po.r_init, 1),
        tau0=b(po.tau0, 0), delta_m_z=b(po.delta_m_z, 2),
        growth_tau=b(po.growth_tau, 1), ddelta_m_z=b(po.ddelta_m_z, 2),
        weyl_z=b(po.weyl_z, 2), aH_z=b(po.aH_z, 1))


def _shared(x, device, dtype) -> torch.Tensor:
    """A grid shared by all chains, without a chains axis if it has one."""
    a = np.asarray(x)
    return tensor(a if a.ndim == 1 else a[0], device, dtype)


def cl_transfer_cache(clt, device=None, dtype=torch.float64) -> ClTransferCache:
    """Shared grids (ls, kf, wk) lose a chains axis if they carry one."""
    shared = lambda x: _shared(x, device, dtype)
    return ClTransferCache(shared(clt.ls), shared(clt.kf), shared(clt.wk),
                           *[_batched(getattr(clt, f), 2, device, dtype)
                             for f in ("dT", "dE", "dP")])


def tensor_output(to, device=None, dtype=torch.float64) -> TensorOutput:
    """JAX TensorOutput (k, tau layout) -> the port's (C, k, tau)."""
    b = lambda x, nd: _batched(x, nd, device, dtype)
    k = np.asarray(to.k)
    return TensorOutput(tau=b(to.tau, 1),
                        k=tensor(k if k.ndim == 1 else k[0], device, dtype),
                        sT=b(to.sT, 2), sP=b(to.sP, 2), tau0=b(to.tau0, 0),
                        ht=None if to.ht is None else b(to.ht, 2))


def tensor_transfer_cache(tc, device=None, dtype=torch.float64
                          ) -> TensorTransferCache:
    """Shared grids (ls, kf, wk) lose a chains axis if they carry one."""
    shared = lambda x: _shared(x, device, dtype)
    return TensorTransferCache(shared(tc.ls), shared(tc.kf), shared(tc.wk),
                               *[_batched(getattr(tc, f), 2, device, dtype)
                                 for f in ("dT", "dE", "dB")])


def matter_transfers(mt, device=None, dtype=torch.float64) -> MatterTransfers:
    """JAX MatterTransfers ((nz, nk) tables) -> the port's (C, nz, nk)."""
    b = lambda x, nd: _batched(x, nd, device, dtype)
    return MatterTransfers(_shared(mt.k, device, dtype),
                           _shared(mt.z, device, dtype), b(mt.delta_m_z, 2),
                           b(mt.weyl_z, 2), b(mt.v_z, 2), b(mt.h, 0))


def matter_power(mp, device=None, dtype=torch.float64) -> MatterPower:
    """JAX MatterPower ((nz, nk) tables, (nz,) sigma8) -> the port's."""
    b = lambda x, nd: _batched(x, nd, device, dtype)
    return MatterPower(_shared(mp.k, device, dtype), _shared(mp.z, device, dtype),
                       b(mp.lnP, 2), b(mp.lnP_nl, 2), b(mp.lnP_weyl, 2),
                       b(mp.sigma8_z, 1), b(mp.fsigma8_z, 1), b(mp.h, 0))


def background_functions(bf, device=None, dtype=torch.float64
                         ) -> BackgroundFunctions:
    return BackgroundFunctions(
        background_params(bf.bg, device, dtype),
        _shared(bf.lz_grid, device, dtype),
        _batched(bf.chi_grid, 1, device, dtype),
        _batched(bf.curvature_k, 0, device, dtype),
        _batched(bf.dchi_grid, 1, device, dtype))


def background_theory(th, device=None, dtype=torch.float64) -> BackgroundTheory:
    """A JAX BackgroundTheory (one cosmology or a vmapped batch)."""
    return BackgroundTheory(background_params(th.bg, device, dtype),
                            background_functions(th.bf, device, dtype),
                            _batched(th.rs_drag, 0, device, dtype))


def proposal_mapping(mapping, device=None) -> torch.Tensor:
    """The (n, n) proposal mapping, float32 as both packages keep it."""
    return tensor(mapping, device, torch.float32)


def _slow_cache(slow: dict, device, dtype) -> dict:
    out = {}
    for k, v in slow.items():
        if v is None:
            out[k] = None
        elif k == "bg":
            out[k] = background_params(v, device, dtype)
        elif k == "bf":
            out[k] = background_functions(v, device, dtype)
        elif k == "clt":
            out[k] = cl_transfer_cache(v, device, dtype)
        elif k == "tt_cache":
            out[k] = tensor_transfer_cache(v, device, dtype)
        elif k == "mt":
            out[k] = matter_transfers(v, device, dtype)
        else:
            out[k] = tensor(v, device, dtype)
    return out


def staged_chain_state(st, device=None, dtype=torch.float64) -> StagedChainState:
    """A JAX StagedChainState (chains already batched) -> the port's."""
    semi = {k: None if v is None else
            matter_power(v, device, dtype) if k == "mp" else
            tensor(v, device, dtype) for k, v in st.semi.items()}
    return StagedChainState(
        tensor(st.P, device, dtype), tensor(st.mloglike, device, dtype),
        tensor(st.derived, device, dtype),
        tensor(st.num_accept, device, torch.int32),
        proposal_mapping(st.mapping, device),
        _slow_cache(st.slow, device, dtype), semi)


def chain_state(st, device=None, dtype=torch.float64) -> ChainState:
    """A JAX ChainState (chains batched) -> the port's; the key stays
    behind (the port's randomness is the sampler's generator)."""
    return ChainState(tensor(st.P, device, dtype),
                      tensor(st.mloglike, device, dtype),
                      tensor(st.derived, device, dtype),
                      tensor(st.num_accept, device, torch.int32),
                      proposal_mapping(st.mapping, device))
