"""Posterior assembly: parameterization + theory + likelihoods -> logpost.

Port of cosmomc_tpu/pipeline.py (GeneralSetup.f90 TSetup + calclike.f90),
batched over chains: every function takes the (C, n) parameter vectors of
C chains and returns per-chain tensors.

`BackgroundPosterior` is the background-only configuration (BAO, SN, H0):
distance tables and the fitted drag sound horizon, no kernel.
`CMBPosterior` runs in three stages:

  stage_slow   thermal history (K4, once), Boltzmann transfers (K1), the
               halofit lensing-source ratio, the line-of-sight Delta_l(k)
               (K2a table engine or K2b recurrence), with compute_tensors the
               tensor evolution (K5) and tensor Delta_l(k) (K6), with
               matter_power the matter transfers (K1 on the wide matter k
               grid), background tables and the slow derived scalars;
  stage_semi   primordial power on the cached transfers (plus the tensor
               TT/TE/EE/BB), lensing (K3), and with matter_power P(k, z),
               sigma8(z) and f sigma8(z);
  stage_fast   likelihoods and the derived-parameter list.

Covered: the flagship configuration (theta LCDM, halofit lensing, with
BAO in the likelihood list), LCDM+r (`compute_tensors=True`, r
semi-slow, nt = -r/8 or, without `inflation_consistency`, 0), matter
power with the sigma8 derived values,
LSS-only runs (`use_cmb=False`: no source evolution, LOS or lensing), and
the extended sectors: the massive-neutrino hierarchy and the dark-energy
fluid, switched on ("auto") when mnu, w or wa is sampled or set away from
its LCDM value, and correlated CDM isocurvature when alpha1 is. With
`lmax_computed` below the likelihoods' lmax, the Boltzmann C_l stop at
`lmax_computed` and the fiducial lensed template (`highl_template`) fills
the rest, scaled to the computed TT there. The BBN table is always passed
in.
`los_method="auto"` means the table engine on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.models.bbn import BBNTable, dh_bbn, yhe_bbn
from cosmomc_tpu_torch.models.cls import (cls_from_cl_transfers,
                                          compute_cl_transfers,
                                          compute_cl_transfers_recurrence)
from cosmomc_tpu_torch.models.cmb import compute_transfers, source_k_grid
from cosmomc_tpu_torch.models.lensing import lens_cls
from cosmomc_tpu_torch.models.matterpower import (LENS_NL_Z,
                                                  compute_matter_transfers,
                                                  lensing_nl_ratio,
                                                  matter_power_from_transfers)
from cosmomc_tpu_torch.models.perturbations import DEFAULT_REMAT_CHUNKS
from cosmomc_tpu_torch.models.primordial import PrimordialParams
from cosmomc_tpu_torch.models.recfast import compute_thermo
from cosmomc_tpu_torch.models.reionization import zre_from_tau
from cosmomc_tpu_torch.models.tensors import (compute_tensor_transfers,
                                              evolve_tensors, tensor_k_grid,
                                              tensor_cls_from_transfers)
from cosmomc_tpu_torch.models.theory import (BACKGROUND_DERIVED_NAMES,
                                             CMBTheoryProducts,
                                             background_derived,
                                             compute_background_theory)
from cosmomc_tpu_torch.models.thermo import compute_thermo_tables, thermo_derived
from cosmomc_tpu_torch.params.space import Param, ParameterSpace, Speed
from cosmomc_tpu_torch.sampling.metropolis import make_bounded_posterior
from cosmomc_tpu_torch.sampling.proposal import BlockedProposal
from cosmomc_tpu_torch.utils.interp import interp
from cosmomc_tpu_torch.utils.paramnames import ParamInfo, ParamNames

PRIMORDIAL_PARAMS = [
    Param("logA", 3.044, 1.61, 3.91, 0.001, 0.001,
          r"{\rm{ln}}(10^{10} A_s)", Speed.SEMISLOW),
    Param("ns", 0.965, 0.8, 1.2, 0.004, 0.002, "n_s", Speed.SEMISLOW),
]

CMB_DERIVED_NAMES = [
    ("H0", "H_0"), ("omegam", r"\Omega_m"), ("omegal", r"\Omega_\Lambda"),
    ("omegamh2", r"\Omega_m h^2"), ("omeganuh2", r"\Omega_\nu h^2"),
    ("omegamh3", r"\Omega_m h^3"),
    ("zrei", "z_{re}"), ("A", "10^9 A_s"), ("clamp", r"10^9 A_s e^{-2\tau}"),
    ("yheused", "Y_P"), ("YpBBN", r"Y_P^{\rm{BBN}}"), ("DHBBN", r"10^5D/H"),
    ("age", r"{\rm{Age}}/{\rm{Gyr}}"),
    ("zstar", "z_*"), ("rstar", "r_*"), ("thetastar", r"100\theta_*"),
    ("DAstar", r"D_{\rm{M}}(z_*)/{\rm{Gpc}}"),
    ("zdrag", r"z_{\rm{drag}}"), ("rdrag", r"r_{\rm drag}"),
    ("rdragh", r"r_{\rm drag} h"),
    ("kd", r"k_{\rm D}"), ("thetad", r"100\theta_{\rm{D}}"),
    ("zeq", r"z_{\rm{eq}}"), ("keq", r"k_{\rm{eq}}"),
    ("thetaeq", r"100\theta_{\rm{eq}}"),
    ("thetarseq", r"100\theta_{\rm{s,eq}}"),
]

CMB_DERIVED_MP_NAMES = [
    ("sigma8", r"\sigma_8"), ("S8", "S_8"),
    ("s8omegamp5", r"\sigma_8 \Omega_m^{0.5}"),
    ("s8omegamp25", r"\sigma_8 \Omega_m^{0.25}"),
    ("s8h5", r"\sigma_8/h^{0.5}"),
]

def _make_proposal(space: ParameterSpace, oversample_fast: int,
                   propose_scale: float) -> BlockedProposal:
    """Speed blocks, slow first; blocks of speed SLOW and SEMISLOW count as
    slow for the schedule."""
    blocks = space.speed_blocks()
    n_slow_blocks = max(1, sum(1 for b in blocks if b and
                               space.varying[b[0]].speed <= 1))
    return BlockedProposal(blocks, slow_block_max=n_slow_blocks,
                           oversample_fast=oversample_fast,
                           propose_scale=propose_scale)


def _start_positions(space: ParameterSpace, rng: np.random.Generator,
                     nchains: int) -> np.ndarray:
    """Gaussian around each centre with its start width, clipped to its
    bounds (BaseParameters.f90:85-105)."""
    var = space.varying
    out = np.empty((nchains, len(var)))
    for i, p in enumerate(var):
        vals = rng.normal(p.center, max(p.start_width, 1e-12), nchains)
        out[:, i] = np.clip(vals, p.min, p.max)
    return out


def _per_likelihood(post, P_varying, theory_of) -> Dict[str, float]:
    """Each likelihood's chi^2/2 at one varying-parameter point, by name;
    `theory_of` maps the (1, n) varying vector to the theory products."""
    P = torch.as_tensor(np.asarray(P_varying, np.float64)[None],
                        dtype=post.dtype, device=post.device)
    _, per = post.likes.total_log_like(theory_of(P), P, post.slices)
    return {like.name: float(v) for like, v in
            zip(post.likes.likes, per[0].double().cpu())}


@dataclass
class BackgroundPosterior:
    """Background-only posterior (BASELINE config 1: BAO + SN + H0)."""
    parameterization: object          # has .to_background(full_P)
    space: ParameterSpace
    likes: LikelihoodList
    fixed_rs: Optional[float] = None
    #: "cuda" (the default) or "cpu"; without a card only "cpu" is accepted
    device: object = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = kernels.entry_device(self.device, "BackgroundPosterior")
        self.slices = self.likes.add_nuisance_to_space(self.space)
        self.varying_idx = self.space.varying_indices
        self._full_template = np.array([p.center for p in self.space.params])
        # derived values that are also sampled (H0, omegam) are dropped
        sampled = {p.name for p in self.space.params}
        self._derived_keep = [i for i, (n, _) in
                              enumerate(BACKGROUND_DERIVED_NAMES)
                              if n not in sampled]
        self.derived_names = [BACKGROUND_DERIVED_NAMES[i]
                              for i in self._derived_keep]
        self.num_derived = len(self.derived_names)

    def embed_full(self, varying: torch.Tensor) -> torch.Tensor:
        """(C, n_varying) -> (C, n_full) with the fixed values filled in."""
        full = torch.as_tensor(self._full_template, dtype=varying.dtype,
                               device=varying.device).repeat(varying.shape[0], 1)
        full[:, torch.as_tensor(self.varying_idx, dtype=torch.int64,
                                device=varying.device)] = varying
        return full

    def compute_theory(self, P: torch.Tensor):
        bg = self.parameterization.to_background(self.embed_full(P))
        return compute_background_theory(bg, self.fixed_rs)

    def raw_logpost(self) -> Callable:
        """(C, n) -> (chi2/2 (C,), derived (C, nd)), before bounds and priors."""
        def fn(P):
            th = self.compute_theory(P)
            total, _per = self.likes.total_log_like(th, P, self.slices)
            return total, background_derived(th)[:, self._derived_keep]
        return fn

    def logpost(self) -> Callable:
        arr = self.space.device_arrays(self.device, self.dtype)
        return make_bounded_posterior(self.raw_logpost(), arr["lo"], arr["hi"],
                                      prior_arrays=arr,
                                      num_derived=self.num_derived)

    def per_likelihood(self, P_varying) -> Dict[str, float]:
        """chi^2/2 of each likelihood at one point (the action=4 table,
        GeneralSetup.f90:165-172)."""
        return _per_likelihood(self, P_varying, self.compute_theory)

    def paramnames(self) -> ParamNames:
        pn = self.space.param_names()
        for name, label in self.derived_names:
            pn.add(ParamInfo(name, label, derived=True))
        return pn

    def make_proposal(self, oversample_fast: int = 1,
                      propose_scale: float = 2.4) -> BlockedProposal:
        return _make_proposal(self.space, oversample_fast, propose_scale)

    def start_positions(self, rng: np.random.Generator, nchains: int) -> np.ndarray:
        return _start_positions(self.space, rng, nchains)


def _ztag(z: float) -> str:
    return f"{z:g}".replace(".", "")


@dataclass
class CMBPosterior:
    """Theta-parameterized LCDM -> Boltzmann C_l -> CMB likelihoods (or,
    with `use_cmb=False` and the astro parameterization, background +
    thermal history + matter power for LSS-only runs).

    Sampled blocks: SLOW ombh2, omch2, theta, tau; SEMISLOW logA, ns (and r
    with compute_tensors); FAST likelihood nuisance. YHe follows BBN
    consistency from `bbn_table`."""
    parameterization: object                 # ThetaParameterization
    space: ParameterSpace
    likes: LikelihoodList
    bbn_table: BBNTable = None
    lmax: int = 2508
    kmax: float = 0.5
    lens_margin: int = 150
    #: compute the Boltzmann C_l only to this l and fill (lmax_computed,
    #: lmax] with the fiducial lensed template scaled by TT at the boundary
    #: (Calculator_CAMB.f90 + LoadFiducialHighLTemplate); 0 = no splice
    lmax_computed: int = 0
    #: the template (HighL_lensedCls.dat format: l, TT, EE, BB, TE in
    #: l(l+1)C_l/2pi muK^2, CAMB lensedCls column order)
    highl_template: str = ""
    matter_power: bool = False
    #: the matter-power table's redshifts (extended to the likelihoods'
    #: required_zmax)
    z_pk: Tuple[float, ...] = (0.0, 0.2, 0.38, 0.51, 0.61, 1.0, 2.0)
    #: background/LSS derived-output redshifts
    z_outputs: Tuple[float, ...] = (0.38, 0.51, 0.61)
    n_step_boltzmann: int = 0
    source_nk: Optional[Tuple[int, int]] = None
    #: "table" (K2a), "recurrence" (K2b) or "auto" (= table on every
    #: device: the JAX package's "auto" picks the recurrence off the CPU)
    los_method: str = "auto"
    los_tau_stride: int = 4
    nonlinear_lens: bool = True
    massive_nu_hierarchy: object = "auto"
    de_perturbations: object = "auto"
    use_cmb: bool = True
    compute_tensors: bool = False            # r -> tensor TT/TE/EE/BB
    inflation_consistency: bool = True       # nt = -r/8, else nt = 0
    #: checkpoints of K1's gradient (JAX's remat_chunks): the CMB evolution
    #: takes it as JAX does; the matter path takes it too, or
    #: DEFAULT_REMAT_CHUNKS when 0, where JAX keeps every step (ROADMAP.md
    #: section 3); memory, not numbers
    remat_chunks: int = 0
    #: "cuda" (the default) or "cpu"; without a card only "cpu" is accepted
    device: object = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        self.device = kernels.entry_device(self.device, "CMBPosterior")
        if self.bbn_table is None:
            raise ValueError("CMBPosterior needs bbn_table= (load_bbn_table(path) "
                             "or synthetic_bbn_table())")
        if self.los_method not in ("table", "auto", "recurrence"):
            raise ValueError(f"unknown los_method {self.los_method!r}")
        for p in PRIMORDIAL_PARAMS:
            if p.name not in self.space:
                self.space.add(Param(**p.__dict__))
        if self.compute_tensors and "r" not in self.space:
            # test.ini's conventional range (compute_tensors=T + param[r])
            self.space.add(Param("r", 0.03, 0.0, 2.0, 0.04, 0.04, "r",
                                 Speed.SEMISLOW))
        self.slices = self.likes.add_nuisance_to_space(self.space)
        self.varying_idx = self.space.varying_indices
        self._full_template = np.array([p.center for p in self.space.params])
        self._i_logA = self.space.index("logA")
        self._i_ns = self.space.index("ns")
        self._i_tau = self.space.index("tau")
        self._i_r = self.space.index("r") if self.compute_tensors else None
        # fiducial primordial power for the halofit lensing ratio (fixed, so
        # the slow cache stays independent of the semi-slow parameters)
        self._fid_logA = float(self.space.get("logA").center)
        self._fid_ns = float(self.space.get("ns").center)
        self.bbn_table = self.bbn_table.to(self.device, self.dtype)
        # the likelihoods' requirements, before the derived names are fixed
        # (a matter_power auto-enable keeps sigma8 among them)
        zmax_req = 0.0
        for like in self.likes.likes:
            need = getattr(like, "required_lmax", lambda: 0)()
            if need > self.lmax:
                self.lmax = int(need)
            if getattr(like, "needs_matter_power", False):
                self.matter_power = True
            if getattr(like, "required_kmax", 0.0) > self.kmax:
                self.kmax = float(like.required_kmax)
            zmax_req = max(zmax_req, getattr(like, "required_zmax", 0.0))
        if zmax_req > max(self.z_pk):
            # a log(1+z) grid to the union max
            extra = np.expm1(np.linspace(
                np.log1p(max(self.z_pk)), np.log1p(zmax_req * 1.02), 24))[1:]
            self.z_pk = tuple(self.z_pk) + tuple(float(z) for z in extra)
        self._highl = self._load_highl_template()
        all_derived = list(CMB_DERIVED_NAMES)
        for z in self.z_outputs:
            t = _ztag(z)
            all_derived += [(f"Hubble{t}", f"H({z:g})"),
                            (f"DM{t}", f"D_{{\\rm{{M}}}}({z:g})")]
        if self.matter_power:
            all_derived += list(CMB_DERIVED_MP_NAMES)
            for z in self.z_outputs:
                t = _ztag(z)
                all_derived += [(f"fsigma8z{t}", f"f\\sigma_8({z:g})"),
                                (f"sigma8z{t}", f"\\sigma_8({z:g})")]
        sampled = {p.name for p in self.space.params}
        self._derived_keep = [i for i, (n, _) in enumerate(all_derived)
                              if n not in sampled]
        self.derived_names = [all_derived[i] for i in self._derived_keep]
        self.num_derived = len(self.derived_names)
        self._resolve_sectors()
        self._k = (source_k_grid(kmax=self.kmax, nk_log=self.source_nk[0],
                                 nk_lin=self.source_nk[1])
                   if self.source_nk is not None else source_k_grid(kmax=self.kmax))

    def _load_highl_template(self):
        """The template on (0..lmax) x (TT, EE, BB, TE), or None without a
        splice. After the likelihoods' requirements have raised lmax, as
        the reference's lmax_computed_cl = min(lmax, lmax_computed_cl): a
        cap at or above lmax means no splice."""
        if self.lmax_computed >= self.lmax:
            self.lmax_computed = 0
        if not 0 < self.lmax_computed < self.lmax:
            return None
        if not self.highl_template:
            raise ValueError("lmax_computed < lmax needs highl_template")
        raw = np.loadtxt(self.highl_template)
        tmpl = np.zeros((self.lmax + 1, 4))
        ls = raw[:, 0].astype(int)
        keep = ls <= self.lmax
        tmpl[ls[keep]] = raw[keep, 1:5]
        if tmpl[2, 0] < 100:
            raise ValueError("highl template must be in muK^2")
        if ls.max() < self.lmax:
            raise ValueError("highl template does not reach lmax")
        return torch.as_tensor(tmpl, dtype=self.dtype, device=self.device)

    def _resolve_sectors(self):
        """The extended sectors' static switches, as the JAX package sets
        them (pipeline.py:313-342): the massive-neutrino hierarchy when mnu
        is sampled or fixed above 0.2 eV, the DE fluid when w or wa is
        sampled or fixed away from -1 or 0, isocurvature when alpha1 is
        sampled or fixed nonzero."""
        def param(name):
            return self.space.get(name) if name in self.space else None

        def varies(name):
            return param(name) is not None and param(name).varying
        if self.massive_nu_hierarchy == "auto":
            p = param("mnu")
            self.massive_nu_hierarchy = bool(
                varies("mnu") or (p is not None and p.center > 0.2))
        if self.de_perturbations == "auto":
            pw, pwa = param("w"), param("wa")
            self.de_perturbations = bool(
                varies("w") or varies("wa")
                or (pw is not None and abs(pw.center + 1.0) > 1e-6)
                or (pwa is not None and abs(pwa.center) > 1e-6))
        self._iso_enabled = param("alpha1") is not None and (
            varies("alpha1") or abs(param("alpha1").center) > 1e-12)
        if self._iso_enabled:
            self._i_alpha1 = self.space.index("alpha1")

    def iso_amplitude(self, full_P: torch.Tensor):
        """alpha1 -> the isocurvature IC amplitude of each chain,
        sign(a) sqrt(|a| / (1 - |a|)) with |a| clipped to 0.99
        (Calculator_CAMB.f90:109-111); 0.0 without isocurvature."""
        if not self._iso_enabled:
            return 0.0
        a1 = full_P[:, self._i_alpha1]
        absa = torch.clamp(torch.abs(a1), 0.0, 0.99)
        return torch.sign(a1) * torch.sqrt(absa / (1.0 - absa))

    def embed_full(self, varying: torch.Tensor) -> torch.Tensor:
        """(C, n_varying) -> (C, n_full) with the fixed values filled in."""
        full = torch.as_tensor(self._full_template, dtype=varying.dtype,
                               device=varying.device).repeat(varying.shape[0], 1)
        full[:, torch.as_tensor(self.varying_idx, dtype=torch.int64,
                                device=varying.device)] = varying
        return full

    # ------------------------------------------------------------------
    # Staged theory pipeline
    # ------------------------------------------------------------------

    def gradient_unsupported(self) -> Optional[str]:
        """Why this configuration's slow stage has no gradient, or None when
        it has one: a kernel of its slow path without a reverse pass. K4,
        K1 in all four instantiations (base, the massive-neutrino
        hierarchy, the dark-energy fluid, both; with or without CDM
        isocurvature), K2a (the table line of sight), K3 (in the semi
        stage) and the tensor kernels K5 and K6 have theirs, so the
        flagship CMB path, LCDM+r, base_mnu, base_w_wa and the LSS-only
        path take gradients; the recurrence line of sight (K2b) has none,
        and its plain version runs under no_grad, so a gradient would come
        back partial. The action-2 and HMC dispatch of driver.py asks the
        same."""
        if self.use_cmb and self.los_method == "recurrence":
            return "los_method = recurrence (K2b)"
        return None

    def stage_slow(self, full_P: torch.Tensor) -> dict:
        """Everything independent of the primordial power and nuisance.

        Differentiable where `gradient_unsupported()` is None (the flagship
        CMB path, LCDM+r, base_mnu, base_w_wa with or without alpha1, and
        the LSS-only path: K4, K1 in each instantiation, K2a, and with
        compute_tensors K5 and K6, with their reverse kernels on the card,
        autograd of the plain versions on the CPU; halofit's k_sigma
        bisection carries no derivative, as in JAX); with the recurrence
        line of sight raises NotImplementedError when asked for a
        gradient, rather than return one that holds only part of the slow
        path. K1's and K5's gradients are checkpointed in `remat_chunks`
        chunks (the tensor evolution and the matter path in
        DEFAULT_REMAT_CHUNKS when it is 0)."""
        if torch.is_grad_enabled() and full_P.requires_grad:
            why = self.gradient_unsupported()
            if why is not None:
                raise NotImplementedError(
                    f"CMBPosterior.stage_slow has no gradient with {why}: "
                    "those kernels have no reverse pass yet (ROADMAP.md "
                    "queue 1 item 4); differentiate the semi and fast "
                    "stages with the slow cache held, on the CPU")
        bg = self.parameterization.to_background(full_P)
        tau_re = full_P[:, self._i_tau]
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, self.bbn_table)
        th = compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, tau_re, yhe)
        clt = tt_cache = mt = None
        if self.use_cmb:
            z_nl = LENS_NL_Z if self.nonlinear_lens else (0.0,)
            po, chi_star, tf = compute_transfers(
                bg, th, zre, yhe, self._k, z_outputs=z_nl,
                n_step=self.n_step_boltzmann,
                massive_nu=self.massive_nu_hierarchy,
                de_perts=self.de_perturbations,
                iso_cdm_amp=self.iso_amplitude(full_P),
                remat_chunks=self.remat_chunks)
            if self.nonlinear_lens:
                po = self._nonlinear_lensing(bg, po, tf, z_nl)
            los = (compute_cl_transfers_recurrence
                   if self.los_method == "recurrence" else compute_cl_transfers)
            clt = los(po, chi_star, coarse_k=self._k,
                      lmax=(self.lmax_computed or self.lmax) + self.lens_margin,
                      kmax_hint=self.kmax,
                      tau_stride=self.los_tau_stride)
            if self.compute_tensors:
                kt = tensor_k_grid()
                to = evolve_tensors(
                    bg, tf, po.tau0, kt,
                    remat_chunks=self.remat_chunks or DEFAULT_REMAT_CHUNKS)
                tt_cache = compute_tensor_transfers(
                    to, lmax=min(700, self.lmax), coarse_k=kt)
        if self.matter_power:
            mt = compute_matter_transfers(
                bg, th, zre, yhe, z_outputs=tuple(sorted(self.z_pk)),
                massive_nu=self.massive_nu_hierarchy,
                de_perts=self.de_perturbations,
                remat_chunks=self.remat_chunks or DEFAULT_REMAT_CHUNKS)
        tabs = compute_thermo_tables(bg, th, yhe)
        der = thermo_derived(bg, tabs)
        bf = bgm.background_functions(bg)
        dm_star = bgm.comoving_radial_distance(bf, der.z_star)
        z_eq = bgm.z_equality(bg)
        a_eq = 1.0 / (1.0 + z_eq)
        tau_eq = bgm.conformal_time(bg, a_eq)
        rs_eq = interp(torch.log1p(z_eq)[:, None], tabs.x, tabs.rs)[:, 0]
        return dict(bg=bg, yhe=yhe, clt=clt, tt_cache=tt_cache, bf=bf, mt=mt,
                    rs_drag=der.r_drag, z_star=der.z_star,
                    r_star=der.r_star, zre=zre, tau=tau_re, z_drag=der.z_drag, kd=der.kd, dm_star=dm_star, z_eq=z_eq,
                    keq=a_eq * bgm.hubble_mpc(bg, a_eq[:, None])[:, 0],
                    thetaeq=100.0 * tau_eq / dm_star,
                    thetarseq=100.0 * rs_eq / dm_star,
                    age=bgm.age_gyr(bg),
                    dhbbn=1e5 * dh_bbn(bg.ombh2, bg.nnu - 3.046,
                                       self.bbn_table))

    def _primordial(self, full_P: torch.Tensor) -> PrimordialParams:
        if self.compute_tensors:
            r = full_P[:, self._i_r]
            nt = -r / 8.0 if self.inflation_consistency else 0.0
        else:
            r, nt = 0.0, 0.0
        return PrimordialParams.make(logA=full_P[:, self._i_logA],
                                     ns=full_P[:, self._i_ns], r=r, nt=nt)

    def _nonlinear_lensing(self, bg, po, tf, z_nl):
        """CAMB MakeNonlinearSources: the lensing source times
        sqrt(P_NL/P_lin)(k, z(tau)) at the fiducial primordial power."""
        one = po.k.new_ones(bg.ombh2.shape[0])
        pp_fid = PrimordialParams.make(logA=one * self._fid_logA,
                                       ns=one * self._fid_ns)
        ratio = lensing_nl_ratio(bg, pp_fid, po.k, po.delta_m_z, z_nl)
        a_nl = torch.as_tensor([1.0 / (1.0 + z) for z in z_nl],
                               dtype=po.k.dtype, device=po.k.device)
        tau_nl = interp(a_nl.expand(tf.a.shape[0], -1), tf.a, tf.tau)
        # z ascending -> tau descending; the ratio is held at the z=10 node
        # (~1) above it
        mult = interp(po.tau[:, None, :], tau_nl.flip(-1)[:, None, :],
                      ratio.transpose(1, 2).flip(-1))        # (C, nk, ntau)
        return po._replace(slens=po.slens * mult)

    def stage_semi(self, full_P: torch.Tensor, slow: dict) -> dict:
        """Primordial power on the cached transfers, then lensing, and the
        P(k, z) / sigma8 tables. Differentiable (on the card K3's reverse
        kernel carries the gradient through lens_cls); the tensor C_l's
        transfers come from the slow stage (K6, with its reverse kernel),
        the tensor power from r and nt here."""
        pp = self._primordial(full_P)
        A9 = torch.exp(full_P[:, self._i_logA]) / 10.0        # 10^9 A_s
        mp = (matter_power_from_transfers(slow["bg"], pp, slow["mt"])
              if self.matter_power else None)
        if not self.use_cmb:
            return dict(cls=None, mp=mp, A9=A9)
        lm = self.lmax_computed or self.lmax
        raw = cls_from_cl_transfers(slow["clt"], pp, lmax=lm + self.lens_margin)
        muk2 = (2.7255e6) ** 2
        lensed = lens_cls(raw.ls, raw.tt * muk2, raw.te * muk2, raw.ee * muk2,
                          raw.pp, lmax_lensed=lm)
        C = full_P.shape[0]
        cls = torch.zeros(C, 4, 4, self.lmax + 1, dtype=self.dtype,
                          device=full_P.device)
        sl = slice(2, lm + 1)
        cls[:, 0, 0, sl] = lensed.tt
        cls[:, 1, 0, sl] = lensed.te
        cls[:, 0, 1, sl] = lensed.te
        cls[:, 1, 1, sl] = lensed.ee
        cls[:, 2, 2, sl] = lensed.bb
        cls[:, 3, 3, sl] = raw.pp[:, :lm - 1]
        if self._highl is not None:
            # fill (lm, lmax] of TT, EE, BB, TE with the template scaled by
            # TT at the boundary; phi-phi stays 0 there
            tmpl = self._highl
            norm = (cls[:, 0, 0, lm] / tmpl[lm, 0])[:, None]
            hi = slice(lm + 1, self.lmax + 1)
            for (i, j), col in (((0, 0), 0), ((1, 1), 1), ((2, 2), 2),
                                ((1, 0), 3), ((0, 1), 3)):
                cls[:, i, j, hi] = norm * tmpl[lm + 1:, col]
        if self.compute_tensors:
            lmax_t = min(700, self.lmax)
            tens = tensor_cls_from_transfers(slow["tt_cache"], pp, lmax=lmax_t)
            slt, nlt = slice(2, lmax_t + 1), lmax_t - 1
            cls[:, 0, 0, slt] += muk2 * tens.tt[:, :nlt]
            cls[:, 1, 0, slt] += muk2 * tens.te[:, :nlt]
            cls[:, 0, 1, slt] += muk2 * tens.te[:, :nlt]
            cls[:, 1, 1, slt] += muk2 * tens.ee[:, :nlt]
            cls[:, 2, 2, slt] += muk2 * tens.bb[:, :nlt]
        return dict(cls=cls, mp=mp, A9=A9)

    def assemble_theory(self, slow: dict, semi: dict) -> CMBTheoryProducts:
        mp = semi.get("mp")
        summaries = ({} if mp is None else
                     dict(z_pk=mp.z, sigma8_z=mp.sigma8_z,
                          fsigma8_z=mp.fsigma8_z, mp=mp))
        return CMBTheoryProducts(bg=slow["bg"], bf=slow["bf"],
                                 rs_drag=slow["rs_drag"], cls=semi["cls"],
                                 **summaries)

    def compute_theory(self, full_P: torch.Tensor):
        """One full theory pass: (CMBTheoryProducts, extras), extras the
        slow cache's z_star, r_star, yhe and zre (JAX pipeline.py:552-571)."""
        slow = self.stage_slow(full_P)
        theory = self.assemble_theory(slow, self.stage_semi(full_P, slow))
        return theory, {k: slow[k] for k in ("z_star", "r_star", "yhe", "zre")}

    def per_likelihood(self, P_varying) -> Dict[str, float]:
        """chi^2/2 of each likelihood at one point (the action=4 table,
        GeneralSetup.f90:165-172)."""
        return _per_likelihood(
            self, P_varying, lambda P: self.compute_theory(self.embed_full(P))[0])

    def stage_fast(self, P: torch.Tensor, slow: dict, semi: dict):
        """Likelihoods + derived parameters from the cached theory."""
        theory = self.assemble_theory(slow, semi)
        total, _per = self.likes.total_log_like(theory, P, self.slices)
        bg = theory.bg
        h = bg.H0 / 100.0
        omm = (bg.ombh2 + bg.omch2 + bg.omnuh2) / h ** 2
        A9 = semi["A9"]
        yhe = slow["yhe"]
        mr = 3.9715
        der = [bg.H0, omm, 1.0 - bg.omk - omm, omm * h ** 2, bg.omnuh2,
               omm * h ** 3, slow["zre"], A9, A9 * torch.exp(-2.0 * slow["tau"]),
               yhe, 4.0 * yhe / (mr - yhe * (mr - 4.0)), slow["dhbbn"],
               slow["age"], slow["z_star"], slow["r_star"],
               100.0 * slow["r_star"] / slow["dm_star"],
               slow["dm_star"] / 1000.0, slow["z_drag"], theory.rs_drag,
               theory.rs_drag * h, slow["kd"],
               100.0 * torch.pi / slow["kd"] / slow["dm_star"],
               slow["z_eq"], slow["keq"], slow["thetaeq"], slow["thetarseq"]]
        for z in self.z_outputs:
            der += [bgm.hofz_kms(bg, z),
                    bgm.comoving_radial_distance(slow["bf"], z)]
        if self.matter_power:
            s8 = theory.sigma8_z[:, 0]
            der += [s8, s8 * torch.sqrt(omm / 0.3), s8 * torch.sqrt(omm),
                    s8 * omm ** 0.25, s8 / torch.sqrt(h)]
            for z in self.z_outputs:
                der += [theory.fsigma8_at(z), theory.sigma8_at(z)]
        der = torch.stack([d.to(P.dtype) for d in der], -1)
        return total, der[:, self._derived_keep]

    def raw_logpost(self) -> Callable:
        def fn(P):
            full = self.embed_full(P)
            slow = self.stage_slow(full)
            return self.stage_fast(P, slow, self.stage_semi(full, slow))
        return fn

    def logpost(self) -> Callable:
        arr = self.space.device_arrays(self.device, self.dtype)
        return make_bounded_posterior(self.raw_logpost(), arr["lo"], arr["hi"],
                                      prior_arrays=arr,
                                      num_derived=self.num_derived)

    def paramnames(self) -> ParamNames:
        pn = self.space.param_names()
        for name, label in self.derived_names:
            pn.add(ParamInfo(name, label, derived=True))
        return pn

    def make_proposal(self, oversample_fast: int = 1,
                      propose_scale: float = 2.4) -> BlockedProposal:
        return _make_proposal(self.space, oversample_fast, propose_scale)

    def start_positions(self, rng: np.random.Generator, nchains: int) -> np.ndarray:
        return _start_positions(self.space, rng, nchains)
