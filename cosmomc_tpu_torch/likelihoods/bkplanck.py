"""BICEP/Keck/Planck B-mode likelihood: CMBLikes plus dust and synchrotron
foregrounds, batched over chains.

Port of cosmomc_tpu/likelihoods/bkplanck.py (the reference's
source/CMB_BK_Planck.f90, TBK_planck). The foreground model is added to
the EE/BB required spectra before binning:

  * modified-blackbody dust scaled from its pivot frequency (353 GHz)
    through each map's bandpass (DustScaling);
  * power-law synchrotron from its pivot (23 GHz for BK15) (SyncScaling);
  * a correlated dust-synchrotron component;
  * frequency decorrelation of the cross-frequency spectra, with the BK15
    paper's exponential remapping (Decorrelation, BK15 App. F);
  * band-centre error parameters gamma_* scaling the effective
    frequencies.

Bandpass tables are read on the host and padded to one (nmaps_required,
nnu) table; the SED integrals over them are one batched sum a chain,
since the SED exponents are sampled. The 16 foreground parameters follow
the dataset's `.paramnames` order; fixed ones take their centres (the
BK15 defaults of batch3/BK15.ini), and `_fg_slice_pos` maps each DataParams
slot to its position among the varying nuisance parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cosmomc_tpu_torch.likelihoods.cmblikes import CMBLikes, FIELD_B, FIELD_E

T_CMB = 2.72548
GHZ_KELVIN = 6.62606957e-34 / 1.3806488e-23 * 1e9   # h nu / k_B per GHz

L_PIVOT = 80.0

#: the baseline BK15 parameter setup (batch3/BK15.ini): (centre,) = fixed,
#: 5-tuple = varying
BK15_PARAM_DEFAULTS: Dict[str, Sequence[float]] = {
    "BBdust": (3.0, 0.0, 15.0, 0.1, 0.1),
    "BBsync": (1.0, 0.0, 50.0, 1.0, 1.0),
    "BBalphadust": (-0.42, -1.0, 0.0, 0.01, 0.01),
    "BBbetadust": (1.59, 1.04, 2.14, 0.02, 0.02),
    "BBTdust": (19.6,),
    "BBalphasync": (-0.6, -1.0, 0.0, 0.01, 0.01),
    "BBbetasync": (-3.1, -4.5, -2.0, 0.02, 0.02),
    "BBdustsynccorr": (0.2, -1.0, 1.0, 0.01, 0.01),
    "EEtoBB_dust": (2.0,),
    "EEtoBB_sync": (2.0,),
    "Delta_dust": (1.0,),
    "Delta_sync": (1.0,),
    "gamma_corr": (0.0,),
    "gamma_95": (0.0,),
    "gamma_150": (0.0,),
    "gamma_220": (0.0,),
}
BK15_PRIORS = {"BBbetadust": (1.59, 0.11), "BBbetasync": (-3.1, 0.3)}


class Bandpass:
    """One map's bandpass table and its pivot conversions
    (TBandpass, TBK_planck_Read_Bandpass)."""

    def __init__(self, path: str, fpivot_dust: float, fpivot_sync: float):
        R = np.loadtxt(path)
        nu = R[:, 0]
        dnu = np.empty_like(nu)
        dnu[0] = nu[1] - nu[0]
        dnu[1:-1] = (nu[2:] - nu[:-2]) / 2
        dnu[-1] = nu[-1] - nu[-2]
        self.nu = nu
        self.resp = R[:, 1]
        self.dnu = dnu
        x = GHZ_KELVIN * nu / T_CMB
        th_int = np.sum(dnu * self.resp * nu ** 4 * np.exp(x)
                        / np.expm1(x) ** 2)
        th0 = lambda nu0: (nu0 ** 4 * np.exp(GHZ_KELVIN * nu0 / T_CMB)
                           / np.expm1(GHZ_KELVIN * nu0 / T_CMB) ** 2)
        self.th_dust = th_int / th0(fpivot_dust)
        self.th_sync = th_int / th0(fpivot_sync)
        self.nu_bar = np.sum(dnu * nu * self.resp) / np.sum(dnu * self.resp)


class BKPlanckLikelihood(CMBLikes):
    """BK15/BKPlanck-style B-mode likelihood with foregrounds."""

    def __init__(self, dataset_path: str, name: str = "",
                 dataset_overrides: Optional[Dict[str, str]] = None,
                 param_specs: Optional[Dict[str, Sequence[float]]] = None,
                 device="cuda", dtype=torch.float64):
        specs = dict(BK15_PARAM_DEFAULTS)
        specs.update(param_specs or {})
        super().__init__(dataset_path, name=name,
                         dataset_overrides=dataset_overrides,
                         param_specs=specs, device=device, dtype=dtype)

    def _read_ini(self, ini) -> None:
        super()._read_ini(ini)
        self.fpivot_dust = ini.float("fpivot_dust", 353.0)
        self.fpivot_sync = ini.float("fpivot_sync", 23.0)
        self.fpivot_dust_decorr = (ini.float("fpivot_dust_decorr(1)", 217.0),
                                   ini.float("fpivot_dust_decorr(2)", 353.0))
        self.fpivot_sync_decorr = (ini.float("fpivot_sync_decorr(1)", 23.0),
                                   ini.float("fpivot_sync_decorr(2)", 33.0))
        self.lform_dust_decorr = ini.string("lform_dust_decorr", "flat")
        self.lform_sync_decorr = ini.string("lform_sync_decorr", "flat")

        # nuisance parameters in .paramnames order = DataParams order
        pn_file = self._rel(ini, "nuisance_params", required=True)
        n_before = len(self.nuisance)
        self.add_nuisance_from_paramnames(pn_file)
        fg_params = self.nuisance[n_before:]
        self._fg_names = [p.name for p in fg_params]
        self._fg_centers = np.array([p.center for p in fg_params])
        # priors from the baseline ini (batch3/BK15.ini)
        for p in fg_params:
            if p.name in BK15_PRIORS and p.prior_std is None:
                p.prior_mean, p.prior_std = BK15_PRIORS[p.name]
        # DataParams slot -> position among the varying nuisance parameters,
        # which is what log_like's nuisance slice holds
        varying_before = sum(1 for p in self.nuisance[:n_before] if p.varying)
        pos = varying_before
        self._fg_slice_pos = np.full(len(fg_params), -1, int)
        for i, p in enumerate(fg_params):
            if p.varying:
                self._fg_slice_pos[i] = pos
                pos += 1

        # bandpasses of the required maps, in required order
        self.bandpasses: List[Bandpass] = []
        self._gamma_slot = np.zeros(self.nmaps_required, int)  # 0 none, 1..3
        for i, mi in enumerate(self.required_order):
            mname = self.map_names[mi]
            path = self._rel(ini, f"bandpass[{mname}]", required=True)
            self.bandpasses.append(
                Bandpass(path, self.fpivot_dust, self.fpivot_sync))
            if "95" in mname:
                self._gamma_slot[i] = 1
            elif "150" in mname:
                self._gamma_slot[i] = 2
            elif "220" in mname:
                self._gamma_slot[i] = 3
        # dense bandpass operands, padded to a common length
        nmax = max(len(b.nu) for b in self.bandpasses)
        pad = lambda a: np.pad(a, (0, nmax - len(a)))
        self._bp_nu = np.stack([pad(b.nu) for b in self.bandpasses])
        self._bp_w = np.stack([pad(b.dnu * b.resp) for b in self.bandpasses])
        self._bp_th_dust = np.array([b.th_dust for b in self.bandpasses])
        self._bp_th_sync = np.array([b.th_sync for b in self.bandpasses])
        self._bp_nu_bar = np.array([b.nu_bar for b in self.bandpasses])

        # the field class of each required pair, for the foreground add
        self._pair_is_EE = np.array([f1 == FIELD_E and f2 == FIELD_E
                                     for f1, f2 in self.req_theory_pairs])
        self._pair_is_BB = np.array([f1 == FIELD_B and f2 == FIELD_B
                                     for f1, f2 in self.req_theory_pairs])
        self._pair_i = np.array([i for i, _ in self.req_pairs])
        self._pair_j = np.array([j for _, j in self.req_pairs])

    def _to_device(self) -> None:
        super()._to_device()
        t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        it = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        self._t_bp_nu = t(self._bp_nu)
        self._t_bp_w = t(self._bp_w)
        self._t_bp_live = self._t_bp_nu > 0
        self._t_bp_th_dust = t(self._bp_th_dust)
        self._t_bp_th_sync = t(self._bp_th_sync)
        self._t_bp_nu_bar = t(self._bp_nu_bar)
        self._t_fg_centers = t(self._fg_centers)
        live = self._fg_slice_pos >= 0
        self._t_fg_slots = it(np.nonzero(live)[0])
        self._t_fg_pos = it(self._fg_slice_pos[live])
        self._t_gamma_slot = it(self._gamma_slot)
        self._t_has_gamma = t(self._gamma_slot > 0)
        self._t_pi, self._t_pj = it(self._pair_i), it(self._pair_j)
        self._t_is_EE = torch.as_tensor(self._pair_is_EE, device=self.device)
        self._t_is_BB = torch.as_tensor(self._pair_is_BB, device=self.device)
        self._t_auto = torch.as_tensor(self._pair_i == self._pair_j,
                                       device=self.device)[:, None]

    # ---------------------------------------------------------------- model

    def _data_params(self, nuisance: torch.Tensor) -> torch.Tensor:
        """The (C, 16) DataParams of each chain (fixed -> centres)."""
        vals = self._t_fg_centers.to(nuisance.dtype).expand(
            nuisance.shape[0], -1).clone()
        vals[:, self._t_fg_slots] = nuisance[:, self._t_fg_pos]
        return vals

    def _thermo_err(self, bce: torch.Tensor) -> torch.Tensor:
        """The thermodynamic conversion's band-centre error factor."""
        nub = self._t_bp_nu_bar.to(bce.dtype)
        return (bce ** 4
                * torch.exp(GHZ_KELVIN * nub * (bce - 1) / T_CMB)
                * torch.expm1(GHZ_KELVIN * nub / T_CMB) ** 2
                / torch.expm1(GHZ_KELVIN * nub * bce / T_CMB) ** 2)

    def _dust_scaling(self, beta: torch.Tensor, Tdust: torch.Tensor,
                      bandcenter_err: torch.Tensor) -> torch.Tensor:
        """Greybody scaling of each required map (DustScaling): beta and
        Tdust (C,), bandcenter_err (C, nmaps_required) -> (C, nmaps_required)."""
        nu = self._t_bp_nu.to(beta.dtype)
        w = self._t_bp_w.to(beta.dtype)
        live = self._t_bp_live
        b3 = (3 + beta)[:, None, None]
        gb_int = (w * torch.where(live, nu, 1.0) ** b3
                  / torch.expm1(GHZ_KELVIN * torch.clamp(nu, min=1e-3)
                                / Tdust[:, None, None]) * live).sum(-1)
        nu0 = self.fpivot_dust
        gb0 = nu0 ** (3 + beta) / torch.expm1(GHZ_KELVIN * nu0 / Tdust)
        nub = self._t_bp_nu_bar.to(beta.dtype)
        bce = bandcenter_err
        gb_err = (bce ** (3 + beta)[:, None]
                  * torch.expm1(GHZ_KELVIN * nub / Tdust[:, None])
                  / torch.expm1(GHZ_KELVIN * nub * bce / Tdust[:, None]))
        th = self._t_bp_th_dust.to(beta.dtype)
        return (gb_int / gb0[:, None]) / th * (gb_err / self._thermo_err(bce))

    def _sync_scaling(self, beta: torch.Tensor, bandcenter_err: torch.Tensor
                      ) -> torch.Tensor:
        """Power-law scaling of each required map (SyncScaling)."""
        nu = self._t_bp_nu.to(beta.dtype)
        w = self._t_bp_w.to(beta.dtype)
        live = self._t_bp_live
        pl_int = (w * torch.where(live, nu, 1.0) ** (2 + beta)[:, None, None]
                  * live).sum(-1)
        pl0 = self.fpivot_sync ** (2 + beta)
        bce = bandcenter_err
        pl_err = bce ** (2 + beta)[:, None]
        th = self._t_bp_th_sync.to(beta.dtype)
        return (pl_int / pl0[:, None]) / th * (pl_err / self._thermo_err(bce))

    @staticmethod
    def _decorrelation(Delta: torch.Tensor, nu_i: torch.Tensor,
                       nu_j: torch.Tensor, nupivot, lform: str,
                       ells: torch.Tensor) -> torch.Tensor:
        """Frequency-decorrelation factor (C, npair, nL) with the BK15
        exponential remapping (Decorrelation): Delta (C,), nu_i, nu_j
        (C, npair), ells (nL,)."""
        scl_nu = (torch.log(nu_i / nu_j) ** 2
                  / np.log(nupivot[0] / nupivot[1]) ** 2)
        if lform == "lin":
            scl_ell = ells / L_PIVOT
        elif lform == "quad":
            scl_ell = (ells / L_PIVOT) ** 2
        else:
            scl_ell = torch.ones_like(ells)
        arg = scl_nu[..., None] * scl_ell
        D = Delta[:, None, None]
        # Delta <= 1 -> exp(ln(Delta) s); Delta > 1 -> 2 - exp(ln(2-D) s)
        lo = torch.exp(torch.log(torch.clamp(D, 1e-10, 1.0)) * arg)
        hi = 2.0 - torch.exp(torch.log(torch.clamp(2.0 - D, min=1e-10)) * arg)
        return torch.where(D > 1.0, hi, lo)

    def add_foregrounds(self, cls_req: torch.Tensor, nuisance: torch.Tensor
                        ) -> torch.Tensor:
        """(TBK_planck_AddForegrounds)."""
        dp = self._data_params(nuisance)
        (Adust, Async, alphadust, betadust, Tdust, alphasync, betasync,
         dustsync_corr, EEtoBB_dust, EEtoBB_sync, Delta_dust, Delta_sync,
         gamma_corr, gamma_95, gamma_150, gamma_220) = dp.T

        gammas = torch.stack([torch.zeros_like(gamma_95), gamma_95, gamma_150,
                              gamma_220], 1)
        bce = (1.0 + self._t_has_gamma.to(dp.dtype) * gamma_corr[:, None]
               + gammas[:, self._t_gamma_slot])

        fdust = self._dust_scaling(betadust, Tdust, bce)   # (C, nmaps_req)
        fsync = self._sync_scaling(betasync, bce)

        ells = self._t_ells.to(dp.dtype)
        lr = ells / L_PIVOT
        col = lambda a: a[:, None]
        dustpow = col(Adust) * lr ** col(alphadust)
        syncpow = col(Async) * lr ** col(alphasync)
        dustsyncpow = (col(dustsync_corr * torch.sqrt(Adust * Async))
                       * lr ** col((alphadust + alphasync) / 2))

        i, j = self._t_pi, self._t_pj
        dust = fdust[:, i] * fdust[:, j]
        sync = fsync[:, i] * fsync[:, j]
        dustsync = fdust[:, i] * fsync[:, j] + fsync[:, i] * fdust[:, j]
        is_EE = self._t_is_EE
        dust = torch.where(is_EE, dust * col(EEtoBB_dust), dust)
        sync = torch.where(is_EE, sync * col(EEtoBB_sync), sync)
        dustsync = torch.where(is_EE, dustsync
                               * col(torch.sqrt(EEtoBB_dust * EEtoBB_sync)),
                               dustsync)

        # decorrelation on the cross-frequency spectra alone (i != j)
        nub = self._t_bp_nu_bar.to(dp.dtype) * bce
        dd = self._decorrelation(Delta_dust, nub[:, i], nub[:, j],
                                 self.fpivot_dust_decorr,
                                 self.lform_dust_decorr, ells)
        ds = self._decorrelation(Delta_sync, nub[:, i], nub[:, j],
                                 self.fpivot_sync_decorr,
                                 self.lform_sync_decorr, ells)
        dd = torch.where(self._t_auto, 1.0, dd)
        ds = torch.where(self._t_auto, 1.0, ds)

        fg = (dust[..., None] * dustpow[:, None, :] * dd
              + sync[..., None] * syncpow[:, None, :] * ds
              + dustsync[..., None] * dustsyncpow[:, None, :])
        add = torch.where((self._t_is_EE | self._t_is_BB)[:, None], fg, 0.0)
        return cls_req + add.to(cls_req.dtype)
