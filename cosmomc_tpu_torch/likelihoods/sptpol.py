"""SPTpol likelihoods: 500d TE/EE (Henning et al. 2018) and 500d BB (Sayre
et al. 2019), batched over chains.

Port of cosmomc_tpu/likelihoods/sptpol.py (the SouthPoleTelescope fork's
source/CMB_SPTpol_TEEE_2017.f90 SPTpolEELnLike and
CMB_SPTpol_BB_2019.f90 SPTpolBBLnLike).

TE/EE model, per spectrum X in {TE, EE} (DataParams order kappa,
czero_psTE, czero_psEE, ADust_TE, alphaDust_TE, ADust_EE, alphaDust_EE,
mapTcal, mapPcal, beam1, beam2):

  Dl_model = Dl_CMB
           + [czero_X / D3000 - kappa d(l^3 C_l)/dl / (2 l^2)] l(l+1)/2pi
           + aberration (-beta <cos> l dDl/dl)
           + ADust_X (l/80)^(alpha_X + 2)
  binned  = W_X^T Dl_model / CalFactor_X,  CalFactor = Tcal^2 Pcal^{1|2}
  delta   = binned * prod_i (1 + beam_err_i * beam_i) - bandpowers
  -logL   = 0.5 delta^T Cov^-1 delta + 0.5 ln det Cov + priors

BB model, per cross 150x150, 95x150, 95x95: CMB Abb + const + r template
+ Poisson_k l(l+1)/(3000*3001) + ADust ((l+1)/81)(80/l)^1.42 times a
greybody scaled from 150 GHz, calibrated by Bcal_i Bcal_j, beam-scaled,
Gaussian, with the correlated log-calibration prior.

Files are plain text: desc (nbin nfreq / lmin lmax), bandpowers (index,
value), a dense covariance, `window_<i>` per bandpower (l, weight) and
beam-error rows (index, value). The TE/EE l-derivatives read the theory
at lmin-1 .. lmax+1. Each likelihood computes in its own dtype (float64 by
default, as the JAX package).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.params.space import Param, Speed

D3000 = 3000.0 * 3001.0 / (2.0 * np.pi)
ABERRATION_BETA = 0.0012309
ABERRATION_COS = -0.4033
GHZ_KELVIN = 6.62606957e-34 / 1.3806488e-23 * 1e9
T_CMB = 2.72548


def _loadtxt(path: str) -> np.ndarray:
    out = np.loadtxt(path)
    return out[None, :] if out.ndim == 1 else out


class _SPTpolBase(Likelihood):
    """Shared plumbing: desc/cov/window/beam loading, nuisance layout, the
    Gaussian form."""

    kind = "CMB"
    speed = Speed.SLOW
    _prefix = ""
    PARAM_ORDER: Sequence[str] = ()
    PARAM_DEFAULTS: Dict[str, Sequence[float]] = {}

    def __init__(self, dataset_path: str, name: str,
                 dataset_overrides: Optional[Dict[str, str]],
                 param_specs: Optional[Dict[str, Sequence[float]]],
                 device, dtype, n_spectra: int):
        super().__init__(name)
        self.device = kernels.entry_device(device, type(self).__name__)
        self.dtype = dtype
        ini = read_dataset_ini(dataset_path)
        if dataset_overrides:
            ini.params.update(dataset_overrides)
        ddir = os.path.dirname(os.path.abspath(dataset_path))
        self._load_common(ini, ddir, n_spectra=n_spectra, n_beam=2)
        self._read_settings(ini, ddir)
        specs = dict(self.PARAM_DEFAULTS)
        specs.update(param_specs or {})
        self._register_nuisance(specs)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self._t_icov = t(self.inv_cov)
        self._t_W = t(self.windows)
        self._t_beam = t(self.beam_err)
        self._t_spec = t(self.spec[:n_spectra].reshape(-1))
        self._t_centers = t(self._centers)
        self._t_slot = torch.as_tensor(
            [i for i, s in enumerate(self._slot) if s >= 0], device=self.device)

    def _load_common(self, ini, ddir: str, n_spectra: int,
                     n_beam: int) -> None:
        def rel(k):
            v = ini.string(k, required=True)
            return v if os.path.isabs(v) else os.path.join(ddir, v)
        desc = np.loadtxt(rel(self._key("desc_file"))).ravel()
        self.nbin = int(desc[0])
        self.nfreq = int(desc[1])
        self.lmin = int(desc[2])
        self.lmax = int(desc[3])
        self.nall = self.nbin * n_spectra
        self.nL = self.lmax - self.lmin + 1

        bp = _loadtxt(rel(self._key("bp_file")))
        self.spec = bp[:, 1].reshape(-1, self.nbin)   # (nband, nbin)

        cov = _loadtxt(rel(self._key("cov_file")))
        if cov.shape != (self.nall, self.nall):
            raise ValueError(f"{self.name}: covariance {cov.shape}, expected "
                             f"{(self.nall, self.nall)}")
        self.inv_cov = np.linalg.inv(cov)
        _sign, logdet = np.linalg.slogdet(cov)
        self.half_logdet = 0.5 * logdet

        wdir = rel(self._key("window_dir"))
        W = np.zeros((self.nall, self.nL))
        for i in range(self.nall):
            dat = _loadtxt(os.path.join(wdir, f"window_{i + 1}"))
            L = dat[:, 0].astype(int)
            sel = (L >= self.lmin) & (L <= self.lmax)
            W[i, L[sel] - self.lmin] = dat[sel, 1]
        self.windows = W.reshape(n_spectra, self.nbin, self.nL)

        be = _loadtxt(rel(self._key("beam_file")))
        self.n_beam = n_beam
        self.beam_err = be[:, 1].reshape(n_beam, self.nall)

    def _key(self, suffix: str) -> str:
        return f"{self._prefix}_{suffix}"

    def _read_settings(self, ini, ddir: str) -> None:
        raise NotImplementedError

    def _register_nuisance(self, specs) -> None:
        """The DataParams in PARAM_ORDER: a 1-tuple spec fixes a parameter
        at its centre (slot -1), a 5-tuple varies it (its position among
        the varying ones)."""
        self._slot = []
        pos = 0
        self._centers = []
        for nm in self.PARAM_ORDER:
            spec = specs[nm]
            self._centers.append(spec[0])
            if len(spec) == 1:
                self.nuisance.append(Param(nm, spec[0], spec[0], spec[0],
                                           0.0, 0.0, speed=Speed.FAST))
                self._slot.append(-1)
            else:
                self.nuisance.append(Param(nm, *spec[:5], speed=Speed.FAST))
                self._slot.append(pos)
                pos += 1
        self._centers = np.array(self._centers, float)

    def _params(self, nuisance: torch.Tensor) -> torch.Tensor:
        """(C, n_varying) -> (C, len(PARAM_ORDER)) with the fixed centres."""
        vals = self._t_centers.expand(nuisance.shape[0], -1).clone()
        vals[:, self._t_slot] = nuisance[:, :len(self._t_slot)]
        return vals

    def _gaussian(self, delta: torch.Tensor) -> torch.Tensor:
        return 0.5 * ((delta @ self._t_icov) * delta).sum(-1) + self.half_logdet

    def _beam_factor(self, b1, b2) -> torch.Tensor:
        """prod_i (1 + beam_err_i beam_i), (C, nall)."""
        return ((1.0 + self._t_beam[0] * b1[:, None])
                * (1.0 + self._t_beam[1] * b2[:, None]))

    def model(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        """The calibrated, beam-scaled binned model of each chain,
        (C, nall): what the bandpowers are compared with."""
        return self._model_and_params(theory, nuisance)[0]

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        binned, p = self._model_and_params(theory, nuisance)
        return self._gaussian(binned - self._t_spec) + self._priors(p)

    def required_lmax(self) -> int:
        return self.lmax + 1


class SPTpolTEEELikelihood(_SPTpolBase):
    """SPTpol 500d TE+EE (CMB_SPTpol_TEEE_2017.f90)."""

    _prefix = "sptpol_TEEE"

    #: DataParams order (SPTpolEELnLike)
    PARAM_ORDER = ["kappa", "czero_psTE", "czero_psEE", "ADust_TE",
                   "alphaDust_TE", "ADust_EE", "alphaDust_EE",
                   "mapTcal", "mapPcal", "beam1", "beam2"]
    PARAM_DEFAULTS = {
        "kappa": (0.0, -0.01, 0.01, 0.001, 0.001),
        "czero_psTE": (0.0,),
        "czero_psEE": (0.1, 0.0, 10.0, 0.05, 0.05),
        "ADust_TE": (0.1, 0.0, 2.0, 0.05, 0.05),
        "alphaDust_TE": (-2.42,),
        "ADust_EE": (0.1, 0.0, 2.0, 0.05, 0.05),
        "alphaDust_EE": (-2.42,),
        "mapTcal": (1.0, 0.8, 1.2, 0.005, 0.005),
        "mapPcal": (1.0, 0.8, 1.2, 0.01, 0.01),
        "beam1": (0.0, -5.0, 5.0, 0.3, 0.3),
        "beam2": (0.0, -5.0, 5.0, 0.3, 0.3),
    }

    def __init__(self, dataset_path: str, name: str = "",
                 dataset_overrides: Optional[Dict[str, str]] = None,
                 param_specs: Optional[Dict[str, Sequence[float]]] = None,
                 device="cuda", dtype=torch.float64):
        super().__init__(dataset_path, name or "SPTpol_TEEE",
                         dataset_overrides, param_specs, device, dtype,
                         n_spectra=2)
        ells = torch.arange(self.lmin - 1, self.lmax + 2, dtype=dtype,
                            device=self.device)
        self._t_ells = ells
        self._t_lc = ells[1:-1]

    def _read_settings(self, ini, ddir: str) -> None:
        self.correct_aberration = ini.bool("correct_aberration", False)
        self.priors = {
            "tcal": (ini.bool("sptpol_tcal_prior", False),
                     ini.float("sptpol_meanTcal", 1.0),
                     np.log(1 + ini.float("sptpol_sigmaTcal", 0.005))),
            # the reference reuses sigmaTcal in the Pcal width
            # (CMB_SPTpol_TEEE_2017.f90 `sigmaPcal = log(1+sigmaTcal)`), an
            # upstream bug the JAX package keeps for parity
            "pcal": (ini.bool("sptpol_pcal_prior", False),
                     ini.float("sptpol_meanPcal", 1.0),
                     np.log(1 + np.log(1 + ini.float("sptpol_sigmaTcal",
                                                     0.005)))),
            "kappa": (ini.bool("sptpol_kappa_prior", False),
                      ini.float("sptpol_meankappa", 0.0),
                      ini.float("sptpol_sigmakappa", 0.001)),
            "alphaTE": (ini.bool("sptpol_alphaTE_prior", False),
                        ini.float("sptpol_meanAlphaTE", -2.42),
                        ini.float("sptpol_sigmaAlphaTE", 0.02)),
            "alphaEE": (ini.bool("sptpol_alphaEE_prior", False),
                        ini.float("sptpol_meanAlphaEE", -2.42),
                        ini.float("sptpol_sigmaAlphaEE", 0.02)),
        }

    def _model_and_params(self, theory, nuisance: torch.Tensor):
        p = self._params(nuisance.to(self.dtype))
        kappa, psTE, psEE, AdTE, alTE, AdEE, alEE, tcal, pcal = p[:, :9].T

        # theory Dl on lmin-1 .. lmax+1 (the derivatives' margins)
        cls = theory.cls
        sl = slice(self.lmin - 1, self.lmax + 2)
        dls = torch.stack([cls[:, 1, 0, sl], cls[:, 1, 1, sl]], 1).to(self.dtype)
        ells, lc = self._t_ells, self._t_lc
        cl2dl = ells * (ells + 1.0) / (2.0 * np.pi)
        raw = ells ** 3 / cl2dl * dls                     # l^3 C_l
        # d(l^3 C_l)/dl / (2 l^2)  (Manzotti et al. 2014 eq. 32 scaling)
        cl_deriv = (raw[..., 2:] - raw[..., :-2]) * (0.5 / lc ** 2)
        if self.correct_aberration:
            aberr = (-ABERRATION_BETA * ABERRATION_COS) * lc * \
                (dls[..., 2:] - dls[..., :-2]) / 2.0
        else:
            aberr = torch.zeros_like(cl_deriv)

        poisson = torch.stack([psTE, psEE], 1) / D3000     # (C, 2)
        Adust = torch.stack([AdTE, AdEE], 1)
        alpha = torch.stack([alTE, alEE], 1)
        cl2dl_c = lc * (lc + 1.0) / (2.0 * np.pi)
        dl_fgs = ((poisson[..., None] - kappa[:, None, None] * cl_deriv)
                  * cl2dl_c + dls[..., 1:-1] + aberr
                  + Adust[..., None] * (lc / 80.0) ** (alpha[..., None] + 2.0))

        binned = torch.einsum("kbl,ckl->ckb", self._t_W, dl_fgs)
        cal = torch.stack([tcal * tcal * pcal, tcal * tcal * pcal * pcal], 1)
        binned = (binned / cal[..., None]).reshape(binned.shape[0], -1)
        return binned * self._beam_factor(p[:, 9], p[:, 10]), p

    def _priors(self, p: torch.Tensor) -> torch.Tensor:
        """SPTpolEELnLike's priors: unit-Gaussian beams, log-normal
        calibrations, Gaussian kappa and dust indices (each switched by its
        ini flag)."""
        b1, b2 = p[:, 9], p[:, 10]
        lnl = 0.5 * (b1 * b1 + b2 * b2)
        for key, i in (("tcal", 7), ("pcal", 8), ("kappa", 0),
                       ("alphaTE", 4), ("alphaEE", 6)):
            on, mean, sig = self.priors[key]
            if on:
                val = p[:, i]
                if key in ("tcal", "pcal"):
                    lnl = lnl + 0.5 * (torch.log(val / mean) / sig) ** 2
                else:
                    lnl = lnl + 0.5 * ((val - mean) / sig) ** 2
        return lnl


def bnu_ratio(nu, nu0, T):
    """Planck function ratio B(nu, T)/B(nu0, T) (CMB_SPTpol_BB_2019.f90 Bnu)."""
    return (nu / nu0) ** 3 * np.expm1(GHZ_KELVIN * nu0 / T) \
        / np.expm1(GHZ_KELVIN * nu / T)


def dbdt_ratio(nu, nu0):
    """dB/dT(nu) / dB/dT(nu0) at T_CMB (reference dBdT)."""
    x = GHZ_KELVIN * nu / T_CMB
    x0 = GHZ_KELVIN * nu0 / T_CMB
    f = lambda y: y ** 4 * np.exp(y) / np.expm1(y) ** 2
    return f(x) / f(x0)


def dust_freq_scaling_from_150(nu1, nu2, beta=1.59, Tdust=19.6):
    """(CMB_SPTpol_BB_2019.f90 dustFreqScalingFrom150GHz)."""
    return ((nu1 * nu2) / 150.0 ** 2) ** beta \
        * bnu_ratio(nu1, 150.0, Tdust) * bnu_ratio(nu2, 150.0, Tdust) \
        / dbdt_ratio(nu1, 150.0) / dbdt_ratio(nu2, 150.0)


class SPTpolBBLikelihood(_SPTpolBase):
    """SPTpol 500d BB (CMB_SPTpol_BB_2019.f90); 150x150, 95x150, 95x95."""

    _prefix = "sptpol_BB"

    PARAM_ORDER = ["Abb", "r_tmpl", "const_bb", "ADust", "Poisson150",
                   "Poisson90x150", "Poisson90", "mapBcal150", "mapBcal90",
                   "beam1", "beam2"]
    PARAM_DEFAULTS = {
        "Abb": (1.0,),
        "r_tmpl": (0.0,),
        "const_bb": (0.0,),
        "ADust": (0.0094, 0.0, 1.0, 0.005, 0.005),
        "Poisson150": (0.1, 0.0, 10.0, 0.05, 0.05),
        "Poisson90x150": (0.1, 0.0, 10.0, 0.05, 0.05),
        "Poisson90": (0.1, 0.0, 10.0, 0.05, 0.05),
        "mapBcal150": (1.0, 0.5, 1.5, 0.01, 0.01),
        "mapBcal90": (1.0, 0.5, 1.5, 0.01, 0.01),
        "beam1": (0.0, -5.0, 5.0, 0.3, 0.3),
        "beam2": (0.0, -5.0, 5.0, 0.3, 0.3),
    }

    def __init__(self, dataset_path: str, name: str = "",
                 dataset_overrides: Optional[Dict[str, str]] = None,
                 param_specs: Optional[Dict[str, Sequence[float]]] = None,
                 device="cuda", dtype=torch.float64):
        super().__init__(dataset_path, name or "SPTpol_BB", dataset_overrides,
                         param_specs, device, dtype, n_spectra=3)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self._t_poisson = t(self.dls_poisson)
        self._t_dust = t(self.dust_scaling[:, None] * self.dls_galdust[None, :])
        self._t_tensor = t(self.dls_tensor)

    def _read_settings(self, ini, ddir: str) -> None:
        # effective dust frequencies per band -> per cross spectrum
        f150 = ini.float("sptpol_BB_eff_freq_150", 148.84)
        f95 = ini.float("sptpol_BB_eff_freq_95", 95.64)
        self.eff_freqs = [(f150, f150), (f95, f150), (f95, f95)]
        self.dust_scaling = np.array(
            [dust_freq_scaling_from_150(a, b) for a, b in self.eff_freqs])

        ells = np.arange(self.lmin, self.lmax + 1, dtype=float)
        self.dls_poisson = ells * (ells + 1.0) / (3000.0 * 3001.0)
        self.dls_galdust = ((ells + 1.0) / 81.0) * (80.0 / ells) ** 1.42

        # optional tensor template (r_template_file: l TT EE BB TE)
        self.dls_tensor = np.zeros(self.nL)
        tfile = ini.string(self._key("r_template_file"))
        if tfile:
            if not os.path.isabs(tfile):
                tfile = os.path.join(ddir, tfile)
            dat = _loadtxt(tfile)
            L = dat[:, 0].astype(int)
            sel = (L >= self.lmin) & (L <= self.lmax)
            self.dls_tensor[L[sel] - self.lmin] = dat[sel, 3]

        self.cal_prior = ini.bool("sptpol_cal_prior", False)
        cal_cov = np.array(
            [[ini.float("sptpol_calcov_90", 1e-4),
              ini.float("sptpol_calcov_90x150", 5e-5)],
             [ini.float("sptpol_calcov_90x150", 5e-5),
              ini.float("sptpol_calcov_150", 1e-4)]])
        self.inv_cal_cov = np.linalg.inv(cal_cov)
        self.add_prior = (ini.bool("sptpol_Add_prior", False),
                          ini.float("sptpol_meanAdd", 0.0094),
                          ini.float("sptpol_sigmaAdd", 0.0021))

    def _model_and_params(self, theory, nuisance: torch.Tensor):
        p = self._params(nuisance.to(self.dtype))
        Abb, r_t, const_bb, Add, ps150, ps90x150, ps90, cal150, cal90 = \
            p[:, :9].T
        dls_bb = (theory.cls[:, 2, 2, self.lmin:self.lmax + 1].to(self.dtype)
                  * Abb[:, None] + const_bb[:, None]
                  + r_t[:, None] * self._t_tensor)
        poisson = torch.stack([ps150, ps90x150, ps90], 1)
        dl_fgs = (poisson[..., None] * self._t_poisson
                  + Add[:, None, None] * self._t_dust + dls_bb[:, None, :])
        binned = torch.einsum("kbl,ckl->ckb", self._t_W, dl_fgs)
        cal = torch.stack([cal150 * cal150, cal90 * cal150, cal90 * cal90], 1)
        binned = (binned / cal[..., None]).reshape(binned.shape[0], -1)
        return binned * self._beam_factor(p[:, 9], p[:, 10]), p

    def _priors(self, p: torch.Tensor) -> torch.Tensor:
        b1, b2 = p[:, 9], p[:, 10]
        lnl = 0.5 * (b1 * b1 + b2 * b2)
        if self.cal_prior:
            y1, y2 = torch.log(p[:, 8]), torch.log(p[:, 7])
            ic = self.inv_cal_cov
            lnl = lnl + 0.5 * (ic[0, 0] * y1 * y1 + 2 * ic[0, 1] * y1 * y2
                               + ic[1, 1] * y2 * y2)
        on, mean, sig = self.add_prior
        if on:
            lnl = lnl + 0.5 * ((p[:, 3] - mean) / sig) ** 2
        return lnl
