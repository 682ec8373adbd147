"""Linear Einstein-Boltzmann evolution, synchronous gauge (kernel K1).

Port of cosmomc_tpu/models/perturbations.py: Ma & Bertschinger (1995)
equations for CDM, baryons, photon temperature and polarization
hierarchies, massless neutrinos and the metric (the base layout, NVAR =
37), per-lane tight-coupling (TCA) and radiation-streaming (RSA) switches,
classical RK4 on a shared conformal-time grid whose density follows the
opacity, lanes held on analytic ICs until k tau >= IC_RELEASE_KTAU or
tau >= 3, and source functions at every node normalized by the initial
curvature of the pure-adiabatic state.

Three static extensions, as in the JAX package:
  - `massive_nu`: the momentum-sampled massive-neutrino hierarchy
    Psi_l(q_i), l = 0..LMAXNU on NQ_NU Gauss nodes (NVAR_NU more state
    variables), with the background density and pressure of the massive
    eigenstate from the same 4-node quadrature;
  - `de_perts`: the c_s^2 = 1 dark-energy fluid [delta_de, (1+w) theta_de]
    (NVAR_DE more), its 1/(1+w) Tikhonov-regularized near w = -1;
  - `iso_cdm_amp`: a correlated CDM-isocurvature admixture in the ICs, one
    amplitude a chain.
The extended state is appended after the base layout.

Layout of the work:
  - `build_thermo_funcs` (plain torch) builds the tau grid and the thermal
    tables from a recombination history and reionization redshift that the
    caller computed once;
  - `_stage_tables` evaluates every k-independent quantity the RHS needs
    (a, opacity, c_s^2, local step, the species densities, conformal H,
    pressure, visibility, and the extended sectors' node factors and fluid
    coefficients) at the three RK4 stage times of every step, with
    jnp.interp's arithmetic, as one vectorized pass;
  - the per-(chain, k) recurrence runs as `_evolve_plain` (batched torch,
    the reference path and what CPU tensors take) or as the CUDA kernel
    csrc/perturbations.cu (one warp per (chain, k) lane, one multipole a
    thread), one instantiation per combination of the two state
    extensions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models.background import (BackgroundParams, H100_MPC,
                                                 densities, hubble_mpc)
from cosmomc_tpu_torch.models.neutrino import nu_pres, nu_rho
from cosmomc_tpu_torch.models.recfast import ThermoHistory
from cosmomc_tpu_torch.models.reionization import xe_reion
from cosmomc_tpu_torch.utils.interp import cumsum, gradient, interp, linspace
from cosmomc_tpu_torch.utils.remat import remat

LMAXG = 12        # photon temperature 0..LMAXG
LMAXGP = 8        # photon polarization 0..LMAXGP
LMAXNR = 10       # massless neutrinos 0..LMAXNR

_I_ETA, _I_DC, _I_DB, _I_TB, _I_DG, _I_TG = range(6)
_I_FG2 = 6
_I_GP0 = _I_FG2 + (LMAXG - 1)
_I_DN = _I_GP0 + (LMAXGP + 1)
_I_TN = _I_DN + 1
_I_FN2 = _I_TN + 1
NVAR = _I_FN2 + (LMAXNR - 1)

N_STEP = 8192
RSA_KTAU = 240.0
TC_KTAUC = 0.015
TC_OPACTAU = 200.0
TC_LAM_MAX = 150.0
IC_RELEASE_KTAU = 0.08

NQ_NU = 4          # momentum nodes of the massive-neutrino hierarchy
LMAXNU = 6         # Psi_l truncation
NVAR_NU = NQ_NU * (LMAXNU + 1)
NVAR_DE = 2


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    """numpy's trapezoid rule, written out (the same operations in the
    same order), so the constants do not depend on the numpy version."""
    return float(np.add.reduce(np.diff(x) * (y[1:] + y[:-1]) / 2.0))


def _nu_quadrature(nq: int = NQ_NU):
    """Gauss nodes and weights for int_0^inf dq q^3 f0(q) g(q), f0 =
    1/(e^q + 1), by discrete Stieltjes orthogonalization (host, float64);
    the weights sum to int q^3 f0 = 7 pi^4/120."""
    q = np.linspace(1e-6, 45.0, 30001)
    w = q ** 3 / (np.exp(q) + 1.0)
    a, b = np.zeros(nq), np.zeros(nq)
    p_prev, p = np.zeros_like(q), np.ones_like(q)
    norm_prev = 1.0
    for j in range(nq):
        norm = _trapezoid(w * p * p, q)
        a[j] = _trapezoid(w * q * p * p, q) / norm
        if j > 0:
            b[j] = norm / norm_prev
        p_next = (q - a[j]) * p - (b[j] if j > 0 else 0.0) * p_prev
        p_prev, p, norm_prev = p, p_next, norm
    J = np.diag(a) + np.diag(np.sqrt(b[1:]), 1) + np.diag(np.sqrt(b[1:]), -1)
    nodes, vecs = np.linalg.eigh(J)
    return nodes, _trapezoid(w, q) * vecs[0] ** 2


_NU_Q, _NU_W = _nu_quadrature()
_NU_WNORM = _NU_W / _NU_W.sum()                  # weights of the <.> average
#: d ln f0 / d ln q at the nodes, rescaled so that the quadrature gives
#: <dlnf0/dlnq> = -4 exactly: the am -> 0 limit of the hierarchy is then
#: the massless F_l equations to rounding
_NU_DLNF = -_NU_Q / (1.0 + np.exp(-_NU_Q))
_NU_DLNF = _NU_DLNF * (4.0 / abs(float((_NU_WNORM * _NU_DLNF).sum())))


def extra_state(massive_nu: bool, de_perts: bool) -> int:
    return (NVAR_NU if massive_nu else 0) + (NVAR_DE if de_perts else 0)


# fields of the per-stage table (chains, steps, 3 stages, q_fields(...))
(Q_TAU, Q_OPAC, Q_CSQB, Q_DTLOC, Q_GG, Q_GN, Q_GML, Q_GC, Q_GB, Q_ADOTOA,
 Q_GRHO, Q_GPRES, Q_R, Q_VIS, Q_EXPMK, Q_GNISW) = range(16)
NQ = 16
# with massive_nu, after the base fields: eps_q/q and q/eps_q at each node
# and (am < 2) as 1 or 0; with de_perts, after those: w, grho_de and dw/dtau
# times the regularized 1/(1 + w)
Q_EQ, Q_QE, Q_AMLT2 = NQ, NQ + NQ_NU, NQ + 2 * NQ_NU
NQ_NU_FIELDS = 2 * NQ_NU + 1
Q_WDE, Q_GDE, Q_WPR = range(3)         # offsets from q_de(massive_nu)
NQ_DE_FIELDS = 3


def q_de(massive_nu: bool) -> int:
    """The first dark-energy field of a stage-table row."""
    return NQ + (NQ_NU_FIELDS if massive_nu else 0)


def q_fields(massive_nu: bool, de_perts: bool) -> int:
    """Fields of a stage-table row with the given extensions."""
    return q_de(massive_nu) + (NQ_DE_FIELDS if de_perts else 0)


#: csrc/perturbations.cu: the first thread of a warp that holds a multipole
#: of each hierarchy (F_g 2..LMAXG, G 0..LMAXGP, F_nu 2..LMAXNR, one a thread)
MULTIPOLE_LANES = {"fg": 0, "gp": LMAXG - 1, "fn": LMAXG - 1 + LMAXGP + 1}
# output planes
PLANES = ("s0", "s1", "s2", "slens", "dm", "dmdot", "weyl")


class ThermoFuncs(NamedTuple):
    """Tables on the shared tau grid, each (C, N)."""
    tau: torch.Tensor
    a: torch.Tensor
    opac: torch.Tensor
    expmk: torch.Tensor
    vis: torch.Tensor
    csqb: torch.Tensor


class PerturbationOutput(NamedTuple):
    tau: torch.Tensor          # (C, N)
    k: torch.Tensor            # (nk,)
    s0: torch.Tensor           # (C, nk, N)
    s1: torch.Tensor
    s2: torch.Tensor
    spol: torch.Tensor
    slens: torch.Tensor
    delta_m: torch.Tensor      # (C, nk)
    r_init: torch.Tensor       # (C, nk)
    tau0: torch.Tensor         # (C,)
    delta_m_z: torch.Tensor    # (C, nz, nk)
    growth_tau: torch.Tensor   # (C, N)
    ddelta_m_z: torch.Tensor   # (C, nz, nk)
    weyl_z: torch.Tensor       # (C, nz, nk)
    aH_z: torch.Tensor         # (C, nz)


def _conformal_time_table(bg: BackgroundParams, n: int = 4096):
    """tau(a) on a fine log-a grid by cumulative trapezoid; (n,), (C, n)."""
    dtype, dev = bg.ombh2.dtype, bg.ombh2.device
    lna = linspace(float(torch.log(torch.tensor(1e-9, dtype=torch.float64))),
                   0.0, n, dtype=torch.float64, device=dev).to(dtype)
    a = torch.exp(lna).expand(bg.ombh2.shape[0], -1)
    f = 1.0 / (a * hubble_mpc(bg, a))
    dl = lna[1] - lna[0]
    seg = 0.5 * (f[:, 1:] + f[:, :-1]) * dl
    tau = torch.cat([torch.zeros_like(f[:, :1]), cumsum(seg)], -1)
    d = densities(bg)
    tau0_rad = a[:, 0] / (H100_MPC * torch.sqrt(
        d["ogh2"] + d["onu1"] * (d["massless_deg"] + d["massive_deg"])))
    return lna, tau + tau0_rad[:, None]


def build_thermo_funcs(bg: BackgroundParams, yhe: torch.Tensor,
                       th: ThermoHistory, zre: torch.Tensor,
                       n_step: int = N_STEP, kmax: float = 0.5,
                       rsa_ktau: float = RSA_KTAU
                       ) -> Tuple[ThermoFuncs, torch.Tensor]:
    """Thermal tables on the shared evolution grid from a recombination
    history `th` and reionization redshift `zre` (each computed once per
    slow step by the caller). Returns (ThermoFuncs, tau0)."""
    dtype = bg.ombh2.dtype
    c = lambda v: v[:, None]
    lna_tab, tau_tab = _conformal_time_table(bg)
    a_tab = torch.exp(lna_tab).expand_as(tau_tab)
    tau0 = tau_tab[:, -1]
    tau_start_val = min(0.03, IC_RELEASE_KTAU / kmax)

    fHe = yhe / (const.mass_ratio_He_H * (1.0 - yhe))
    z_t = th.z.flip(-1)
    xe_tot = th.xe.flip(-1) + xe_reion(z_t, c(zre), c(fHe))
    tm_t = th.tm.flip(-1)
    mu_H = 1.0 / (1.0 - yhe)
    Nnow = const.n_H_today(bg.ombh2, mu_H)
    akthom = c(const.sigma_thomson * Nnow * const.Mpc)

    def xe_of_z(z):
        return torch.where(z > 9000.0, c(1.0 + 2.0 * fHe), interp(z, z_t, xe_tot))

    def opac_of_z(z):
        return akthom * xe_of_z(z) * (1.0 + z) ** 2

    n_prov = 4096
    tau_start = torch.tensor(tau_start_val, dtype=dtype).item()
    lt = linspace(float(torch.log(torch.tensor(tau_start, dtype=dtype))),
                  torch.log(tau0), n_prov)
    tprov = torch.exp(lt)
    a_prov = interp(tprov, tau_tab, a_tab)
    z_prov = 1.0 / a_prov - 1.0
    opac_prov = opac_of_z(z_prov)
    d = densities(bg)
    R_prov = (4.0 / 3.0) * c(d["ogh2"]) / c(bg.ombh2) / a_prov
    lam = opac_prov * (1.0 + R_prov)
    lam_active = torch.where(lam <= TC_LAM_MAX, lam, 0.0)
    k_active = torch.clamp(rsa_ktau / tprov, max=kmax)
    dt_target = torch.minimum(
        torch.minimum(torch.clamp(0.9 / k_active, max=5.0),
                      1.2 / torch.clamp(lam_active, min=1e-10)),
        0.1 * tprov)
    dens = 1.0 / dt_target
    cum = torch.cat([torch.zeros_like(dens[:, :1]), cumsum(
        0.5 * (dens[:, 1:] + dens[:, :-1]) * (tprov[:, 1:] - tprov[:, :-1]),
        -1)], -1)
    cum = cum / cum[:, -1:] * (n_step - 1)
    idx = torch.arange(n_step, dtype=dtype, device=cum.device).expand(
        cum.shape[0], -1)
    tau_grid = interp(idx, cum, tprov)

    a_g = interp(tau_grid, tau_tab, a_tab)
    z_g = 1.0 / a_g - 1.0
    opac_g = opac_of_z(z_g)
    # kappa(tau) = int_tau^tau0 summed BACKWARDS, so small late-time values
    # are sums of small terms (float32-safe; perturbations.py:296-305)
    dk = 0.5 * (opac_g[:, 1:] + opac_g[:, :-1]) * (tau_grid[:, 1:]
                                                   - tau_grid[:, :-1])
    kappa = torch.cat([cumsum(dk.flip(-1)).flip(-1),
                       torch.zeros_like(dk[:, :1])], -1)
    expmk = torch.exp(-kappa)
    vis = opac_g * expmk

    tm_g = torch.where(z_g > 9000.0, c(bg.tcmb) * (1.0 + z_g),
                       interp(z_g, z_t, tm_t))
    lnT = torch.log(torch.clamp(tm_g, min=1e-10))
    dlnT = gradient(lnT, torch.log(a_g))
    xe_g = xe_of_z(z_g)
    mu_b = 1.0 / (1.0 - (1.0 - 1.0 / const.mass_ratio_He_H) * c(yhe)
                  + xe_g * (1.0 - c(yhe)))
    csqb = (const.k_B * tm_g / (mu_b * const.m_H * const.c ** 2)
            * (1.0 - dlnT / 3.0))
    return ThermoFuncs(tau_grid, a_g, opac_g, expmk, vis, csqb), tau0


def grho_terms(bg: BackgroundParams, a: torch.Tensor):
    """8 pi G a^2 rho_i in Mpc^-2 per species, a (C, M): (grho_g, grho_n,
    grho_num, gpres_num, grho_c, grho_b, grho_de, grho_k)."""
    d = {k: v[:, None] for k, v in densities(bg).items()}
    c = lambda v: v[:, None]
    C3 = 3.0 * H100_MPC ** 2
    grho_g = C3 * d["ogh2"] / a ** 2
    grho_n = C3 * d["onu1"] * d["massless_deg"] / a ** 2
    gml = C3 * d["onu1"] * d["massive_deg"] / a ** 2
    am = a * d["nu_mass"]
    grho_de = C3 * d["omdeh2"] * a ** (2.0 - 3.0 * (1.0 + c(bg.w) + c(bg.wa))) \
        * torch.exp(-3.0 * c(bg.wa) * (1.0 - a))
    return (grho_g, grho_n, gml * nu_rho(am), gml * nu_pres(am),
            C3 * c(bg.omch2) / a, C3 * c(bg.ombh2) / a, grho_de,
            (C3 * d["omkh2"]).expand_as(a))


def _stage_tables(bg: BackgroundParams, tf: ThermoFuncs,
                  massive_nu: bool = False, de_perts: bool = False
                  ) -> torch.Tensor:
    """Every k-independent RHS input at the RK4 stage times (tau_a, the
    midpoint, tau_b) of every step: (C, N-1, 3, q_fields(massive_nu,
    de_perts))."""
    taus = tf.tau
    dt = taus[:, 1:] - taus[:, :-1]
    ta = taus[:, :-1]
    stages = torch.stack([ta, ta + 0.5 * dt, taus[:, 1:]], dim=-1)  # (C,N-1,3)
    C, M = stages.shape[0], stages.shape[1] * 3
    ts = stages.reshape(C, M)
    dtau_tab = torch.cat([dt, dt[:, -1:]], -1)
    a = interp(ts, taus, tf.a)
    d = {k: v[:, None] for k, v in densities(bg).items()}
    c = lambda v: v[:, None]
    C3 = 3.0 * H100_MPC ** 2
    gg = C3 * d["ogh2"] / a ** 2
    gn = C3 * d["onu1"] * d["massless_deg"] / a ** 2
    gml = C3 * d["onu1"] * d["massive_deg"] / a ** 2
    gc = C3 * c(bg.omch2) / a
    gb = C3 * c(bg.ombh2) / a
    gde = C3 * d["omdeh2"] * a ** (2.0 - 3.0 * (1.0 + c(bg.w) + c(bg.wa))) \
        * torch.exp(-3.0 * c(bg.wa) * (1.0 - a))
    gk = C3 * d["omkh2"]
    extra = []
    if massive_nu:
        # the massive eigenstate's density and pressure from the same
        # 4-node quadrature as the Psi_l(q) sums (perturbations.py:383-392)
        nu_q = torch.as_tensor(_NU_Q, dtype=a.dtype, device=a.device)
        nu_wn = torch.as_tensor(_NU_WNORM, dtype=a.dtype, device=a.device)
        am = a * d["nu_mass"]
        eps_q = torch.sqrt(nu_q ** 2 + am[..., None] ** 2)    # (C, M, NQ_NU)
        eq, qe = eps_q / nu_q, nu_q / eps_q
        grho_m = gml * torch.sum(nu_wn * eq, -1)
        gpres_m = gml * torch.sum(nu_wn * qe, -1) / 3.0
        gn_isw = gn
        extra += [*eq.unbind(-1), *qe.unbind(-1), (am < 2.0).to(a.dtype)]
    else:
        # small-mnu layout: the massive eigenstate rides the massless
        # equations
        grho_m, gpres_m, gn_isw = gml, gml / 3.0, gn + gml
    grho = gg + gn + grho_m + gc + gb + gde
    adotoa = torch.sqrt((grho + gk) / 3.0)
    w_de = c(bg.w) + c(bg.wa) * (1.0 - a)
    gpres = (gg + gn) / 3.0 + gpres_m + w_de * gde
    if de_perts:
        opw = 1.0 + w_de
        extra += [w_de, gde,
                  (-c(bg.wa) * a * adotoa) * (opw / (opw * opw + 1e-4))]
    q = torch.stack([ts, interp(ts, taus, tf.opac), interp(ts, taus, tf.csqb),
                     interp(ts, taus, dtau_tab), gg, gn, gml, gc, gb, adotoa,
                     grho, gpres, (4.0 / 3.0) * gg / gb,
                     interp(ts, taus, tf.vis), interp(ts, taus, tf.expmk),
                     gn_isw, *extra], dim=-1)
    return q.reshape(C, M // 3, 3, q_fields(massive_nu, de_perts)).contiguous()


def _r_nu(bg: BackgroundParams) -> torch.Tensor:
    d = densities(bg)
    grho_n = d["onu1"] * (d["massless_deg"] + d["massive_deg"])
    return grho_n / (d["ogh2"] + grho_n)


def iso_inputs(bg: BackgroundParams, b: torch.Tensor) -> torch.Tensor:
    """Per chain (C, 3): the CDM-isocurvature amplitude b, the
    matter/radiation transition rate omega = 3 H100 (ombh2 + omch2) /
    sqrt(3 (grho_g + grho_n)) (1/Mpc) and R_c = omch2 / (ombh2 + omch2)
    (perturbations.py:722-724)."""
    d = densities(bg)
    om_m = bg.ombh2 + bg.omch2
    grho_r = d["ogh2"] + d["onu1"] * (d["massless_deg"] + d["massive_deg"])
    om = 3.0 * H100_MPC * om_m / torch.sqrt(3.0 * grho_r)
    b = torch.as_tensor(b, dtype=om.dtype, device=om.device).expand_as(om)
    return torch.stack([b, om, bg.omch2 / om_m], -1).contiguous()


def adiabatic_ics(k: torch.Tensor, tau: torch.Tensor, rnu: torch.Tensor,
                  massive_nu: bool = False, de_perts: bool = False,
                  iso: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MB95 eq (96) adiabatic ICs (C=1): k (nk,), tau and rnu (C, 1) ->
    state (C, nk, NVAR + extra_state(massive_nu, de_perts)). With `iso`
    (C, 3, from `iso_inputs`), the correlated CDM-isocurvature admixture
    of amplitude b (perturbations.py:718-737); with massive_nu, Psi_l(q)
    from the combined neutrino moments (MB95 eq 98); the DE fluid starts
    at zero."""
    kt = k * tau
    dg = -(2.0 / 3.0) * kt ** 2
    theta = -(1.0 / 18.0) * k * kt ** 3
    theta_n = theta * (23.0 + 4.0 * rnu) / (15.0 + 4.0 * rnu)
    fn2 = 2.0 * (2.0 * kt ** 2 / (3.0 * (15.0 + 4.0 * rnu)))
    eta = 2.0 - (5.0 + 4.0 * rnu) / (6.0 * (15.0 + 4.0 * rnu)) * kt ** 2
    dc = db = 0.75 * dg
    dn, tb = dg, theta
    if iso is not None:
        b, om, Rc = iso[:, 0:1], iso[:, 1:2], iso[:, 2:3]
        ot = om * tau
        dgi = Rc * ot * (4.0 / 3.0 - 0.5 * ot)
        dc = dc + b * (-2.0 + 0.75 * dgi)
        db = db + b * 0.75 * dgi
        dg = dg + b * dgi
        dn = dn + b * dgi
        ti = Rc * k * ot * kt / 6.0
        tb = tb + b * ti
        theta = theta + b * ti
        theta_n = theta_n + b * ti
        fn2 = fn2 + b * (Rc * ot * kt ** 2 / (3.0 * (2.0 * rnu + 15.0)))
        eta = eta + b * (Rc * ot * (1.0 / 3.0 - ot / 8.0))
    y = torch.zeros(kt.shape + (NVAR + extra_state(massive_nu, de_perts),),
                    dtype=kt.dtype, device=kt.device)
    y[..., _I_DG] = dg
    y[..., _I_DC] = dc
    y[..., _I_DB] = db
    y[..., _I_DN] = dn
    y[..., _I_TG] = theta
    y[..., _I_TB] = tb
    y[..., _I_TN] = theta_n
    y[..., _I_FN2] = fn2
    y[..., _I_ETA] = eta
    if massive_nu:
        dlnf = torch.as_tensor(_NU_DLNF, dtype=kt.dtype, device=kt.device)
        psi = y[..., NVAR:NVAR + NVAR_NU].view(kt.shape + (NQ_NU, LMAXNU + 1))
        psi[..., 0] = -(0.25 * dn)[..., None] * dlnf
        psi[..., 1] = -(theta_n / (3.0 * k))[..., None] * dlnf
        psi[..., 2] = -(0.25 * fn2)[..., None] * dlnf
    return y


def measure_curvature(bg: BackgroundParams, tf: ThermoFuncs, y: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """Comoving curvature R at the first grid node, (C, nk)."""
    a = tf.a[:, :1]
    grho_g, grho_n, grho_num, gpres_num, grho_c, grho_b, grho_de, grho_k = \
        grho_terms(bg, a)
    grho = grho_g + grho_n + grho_num + grho_c + grho_b + grho_de
    adotoa = torch.sqrt((grho + grho_k) / 3.0)
    wnu = (4.0 / 3.0) * grho_n + grho_num + gpres_num
    num = (4.0 / 3.0) * grho_g * y[..., _I_TG] + wnu * y[..., _I_TN] \
        + grho_b * y[..., _I_TB]
    den = (4.0 / 3.0) * grho_g + wnu + grho_b + grho_c
    return y[..., _I_ETA] - adotoa * num / (k * k * den)


def _rhs(y: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
         rsa_ktau: float, massive_nu: bool = False, de_perts: bool = False):
    """MB95 synchronous-gauge RHS (perturbations.py:375-683) for y (C, nk,
    NVAR + extra_state(massive_nu, de_perts)) at one stage; q (C,
    q_fields(massive_nu, de_perts)). Returns (dy, aux)."""
    Q = lambda f: q[:, f:f + 1]
    tau, opac, csqb, dt_loc = Q(Q_TAU), Q(Q_OPAC), Q(Q_CSQB), Q(Q_DTLOC)
    grho_g, grho_n, gml, grho_c, grho_b = (Q(Q_GG), Q(Q_GN), Q(Q_GML),
                                           Q(Q_GC), Q(Q_GB))
    adotoa, R = Q(Q_ADOTOA), Q(Q_R)
    eta, dc, db, tb = (y[..., _I_ETA], y[..., _I_DC], y[..., _I_DB],
                       y[..., _I_TB])
    dg, tg = y[..., _I_DG], y[..., _I_TG]
    fg = y[..., _I_FG2:_I_GP0]
    gp = y[..., _I_GP0:_I_DN]
    dn, tn = y[..., _I_DN], y[..., _I_TN]
    fn = y[..., _I_FN2:NVAR]
    k2 = k * k
    tau_safe = torch.clamp(tau, min=1e-10)

    tauc = 1.0 / torch.clamp(opac, min=1e-30)
    rsa = k * tau >= rsa_ktau
    lam = opac * (1.0 + R)
    tc_off = ((k * tauc >= TC_KTAUC) | (opac * tau <= TC_OPACTAU)) \
        & (lam * dt_loc <= 1.3)
    tc_on = ~tc_off & ~rsa

    dgrho_m = grho_c * dc + grho_b * db
    z_rsa = (0.5 * dgrho_m / k + k * eta) / adotoa
    dz_rsa = -adotoa * z_rsa - 0.5 * dgrho_m / k
    dn_rsa = -4.0 * dz_rsa / k
    tn_rsa = -k * z_rsa
    dg_rsa = dn_rsa - (4.0 / k) * opac * (tb / k + z_rsa)
    dg = torch.where(rsa, dg_rsa, dg)
    tg = torch.where(rsa, tn_rsa, tg)
    dn = torch.where(rsa, dn_rsa, dn)
    tn = torch.where(rsa, tn_rsa, tn)

    zero = torch.zeros_like(dg)
    sigma_n = torch.where(rsa, zero, fn[..., 0] / 2.0)
    if massive_nu:
        # MB95 eq 55 on the Gauss nodes; past the RSA boundary while
        # relativistic, or where the step cannot resolve the (q/eps) k
        # streaming, the species is slaved to the massless one
        # (perturbations.py:481-503)
        nu_wn = torch.as_tensor(_NU_WNORM, dtype=y.dtype, device=y.device)
        psi = y[..., NVAR:NVAR + NVAR_NU].unflatten(-1, (NQ_NU, LMAXNU + 1))
        eq = q[:, None, Q_EQ:Q_EQ + NQ_NU]                  # (C, 1, NQ_NU)
        qe = q[:, None, Q_QE:Q_QE + NQ_NU]
        nu_rel_rsa = rsa & ((Q(Q_AMLT2) != 0.0) | (k * dt_loc > 0.9))
        dgrho_m = torch.where(nu_rel_rsa, gml * dn_rsa,
                              gml * torch.sum(nu_wn * eq * psi[..., 0], -1))
        dgq_m = torch.where(nu_rel_rsa, (4.0 / 3.0) * gml * tn_rsa,
                            gml * k * torch.sum(nu_wn * psi[..., 1], -1))
        dgpi_m = torch.where(nu_rel_rsa, zero, (2.0 / 3.0) * gml * torch.sum(
            nu_wn * qe * psi[..., 2], -1))
    else:
        # radiation-equivalent weights on the massless hierarchy's shape
        wnu_m = (4.0 / 3.0) * gml
        dgrho_m, dgq_m, dgpi_m = gml * dn, wnu_m * tn, wnu_m * sigma_n
    dgrho = (grho_c * dc + grho_b * db + grho_g * dg + grho_n * dn
             + dgrho_m)
    dgq = ((4.0 / 3.0) * (grho_g * tg + grho_n * tn) + grho_b * tb
           + dgq_m)
    if de_perts:
        # the c_s^2 = 1 fluid, frozen past the RSA boundary
        i_de = NVAR + (NVAR_NU if massive_nu else 0)
        de_delta, de_V = y[..., i_de], y[..., i_de + 1]
        w_de, grho_de, wpr = (Q(q_de(massive_nu) + f)
                              for f in (Q_WDE, Q_GDE, Q_WPR))
        dgrho = dgrho + torch.where(rsa, zero, grho_de * de_delta)
        dgq = dgq + torch.where(rsa, zero, grho_de * de_V)
    hdot = (2.0 * k2 * eta + dgrho) / adotoa
    etadot = 0.5 * dgq / k2

    fg2_tca = (4.0 / 3.0) * tauc * ((8.0 / 15.0) * tg + (4.0 / 15.0) * hdot
                                    + (8.0 / 5.0) * etadot)
    fg2_eff = torch.where(rsa, zero, torch.where(tc_on, fg2_tca, fg[..., 0]))
    sigma_g = fg2_eff / 2.0
    pol_term = torch.where(rsa, zero, torch.where(
        tc_on, 2.5 * fg2_tca, fg[..., 0] + gp[..., 0] + gp[..., 2]))
    dgpi = (4.0 / 3.0) * (grho_g * sigma_g + grho_n * sigma_n) + dgpi_m

    sl = dg / 4.0 - sigma_g
    tbdot_full = -adotoa * tb + csqb * k2 * db + R * opac * (tg - tb)
    tgdot_full = k2 * sl + opac * (tb - tg)
    tbdot_tca = (-adotoa * tb + csqb * k2 * db + R * k2 * sl) / (1.0 + R)
    tbdot_rsa = -adotoa * tb + csqb * k2 * db
    tbdot = torch.where(rsa, tbdot_rsa, torch.where(tc_on, tbdot_tca,
                                                    tbdot_full))
    tgdot = torch.where(rsa, zero, torch.where(tc_on, tbdot_tca, tgdot_full))
    dgdot = torch.where(rsa, zero, -(4.0 / 3.0) * tg - (2.0 / 3.0) * hdot)
    dbdot = -tb - 0.5 * hdot
    dcdot = -0.5 * hdot
    dndot = torch.where(rsa, zero, -(4.0 / 3.0) * tn - (2.0 / 3.0) * hdot)
    tndot = torch.where(rsa, zero, k2 * (dn / 4.0 - sigma_n))

    kk = k[..., None]
    # photon temperature F_2..F_LMAXG
    ls_g = torch.arange(2, LMAXG + 1, dtype=y.dtype, device=y.device)
    f1 = 4.0 * tg / (3.0 * k)
    fg_prev = torch.cat([f1[..., None], fg[..., :-1]], -1)
    fg_next = torch.cat([fg[..., 1:], torch.zeros_like(fg[..., :1])], -1)
    fgdot = (kk / (2 * ls_g + 1)) * (ls_g * fg_prev - (ls_g + 1) * fg_next) \
        - opac[..., None] * fg
    fg2dot = (8.0 / 15.0) * tg - (3.0 / 5.0) * k * fg[..., 1] \
        + (4.0 / 15.0) * hdot + (8.0 / 5.0) * etadot \
        - opac * (0.9 * fg[..., 0] - 0.1 * (gp[..., 0] + gp[..., 2]))
    fg_last = k * fg[..., -2] - (LMAXG + 1) / tau_safe * fg[..., -1] \
        - opac * fg[..., -1]
    fgdot = torch.cat([fg2dot[..., None], fgdot[..., 1:-1], fg_last[..., None]],
                      -1)
    # photon polarization G_0..G_LMAXGP
    ls_p = torch.arange(0, LMAXGP + 1, dtype=y.dtype, device=y.device)
    gp_prev = torch.cat([torch.zeros_like(gp[..., :1]), gp[..., :-1]], -1)
    gp_next = torch.cat([gp[..., 1:], torch.zeros_like(gp[..., :1])], -1)
    gpdot = (kk / (2 * ls_p + 1)) * (ls_p * gp_prev - (ls_p + 1) * gp_next) \
        - opac[..., None] * gp
    gp_last = k * gp[..., -2] - (LMAXGP + 1) / tau_safe * gp[..., -1] \
        - opac * gp[..., -1]
    gpdot = torch.cat([(gpdot[..., 0] + opac * 0.5 * pol_term)[..., None],
                       gpdot[..., 1:2],
                       (gpdot[..., 2] + opac * 0.1 * pol_term)[..., None],
                       gpdot[..., 3:-1], gp_last[..., None]], -1)
    frozen = tc_on | rsa
    fgdot = torch.where(frozen[..., None], 0.0, fgdot)
    gpdot = torch.where(frozen[..., None], 0.0, gpdot)
    # massless neutrinos F_2..F_LMAXNR
    ls_n = torch.arange(2, LMAXNR + 1, dtype=y.dtype, device=y.device)
    f1n = 4.0 * tn / (3.0 * k)
    fn_prev = torch.cat([f1n[..., None], fn[..., :-1]], -1)
    fn_next = torch.cat([fn[..., 1:], torch.zeros_like(fn[..., :1])], -1)
    fndot = (kk / (2 * ls_n + 1)) * (ls_n * fn_prev - (ls_n + 1) * fn_next)
    fn2dot = (8.0 / 15.0) * tn - (3.0 / 5.0) * k * fn[..., 1] \
        + (4.0 / 15.0) * hdot + (8.0 / 5.0) * etadot
    fn_last = k * fn[..., -2] - (LMAXNR + 1) / tau_safe * fn[..., -1]
    fndot = torch.cat([fn2dot[..., None], fndot[..., 1:-1], fn_last[..., None]],
                      -1)
    fndot = torch.where(rsa[..., None], 0.0, fndot)

    parts = [torch.stack([etadot, dcdot, dbdot, tbdot, dgdot, tgdot], -1),
             fgdot, gpdot, torch.stack([dndot, tndot], -1), fndot]
    aux = dict(hdot=hdot, etadot=etadot, dgpi=dgpi, sigma_g=sigma_g,
               sigma_n=sigma_n,
               sigg_dot=torch.where(frozen, zero, fg2dot) / 2.0,
               sign_dot=torch.where(rsa, zero, fn2dot) / 2.0,
               pol_term=pol_term)
    if massive_nu:
        # MB95 eq 57 per node, closed by eq 58 (perturbations.py:619-640)
        dlnf = torch.as_tensor(_NU_DLNF, dtype=y.dtype, device=y.device)
        qke = qe * kk                                       # (C, nk, NQ_NU)
        ls = torch.arange(LMAXNU + 1, dtype=y.dtype, device=y.device)
        prev = torch.cat([torch.zeros_like(psi[..., :1]), psi[..., :-1]], -1)
        nxt = torch.cat([psi[..., 1:], torch.zeros_like(psi[..., :1])], -1)
        psid = (qke[..., None] / (2.0 * ls + 1.0)) * (ls * prev - (ls + 1.0) * nxt)
        e = lambda v: v[..., None]
        psid = torch.cat([
            e(psid[..., 0] + e(hdot / 6.0) * dlnf), psid[..., 1:2],
            e(psid[..., 2] - e(hdot / 15.0 + 2.0 * etadot / 5.0) * dlnf),
            psid[..., 3:LMAXNU],
            e(qke * psi[..., LMAXNU - 1]
              - e((LMAXNU + 1.0) / tau_safe) * psi[..., LMAXNU])], -1)
        psid = torch.where(nu_rel_rsa[..., None, None], 0.0, psid)
        parts.append(psid.flatten(-2))
        # d/dtau of the massive anisotropic-stress sum, for psi' (ISW):
        # gml' = -2 aH gml and (q/eps)' = -(q/eps) (am/eps)^2 aH, where
        # (am/eps)^2 = 1 - (q/eps)^2
        aux["dgpidot_extra"] = torch.where(nu_rel_rsa, zero, (2.0 / 3.0) * gml * torch.sum(
            nu_wn * (qe * psid[..., 2]
                     - (qe * (3.0 - qe * qe) * e(adotoa)) * psi[..., 2]), -1))
    if de_perts:
        # V = (1 + w) theta form (perturbations.py:649-662)
        de_ddot = (-de_V - (1.0 + w_de) * 0.5 * hdot
                   - 3.0 * adotoa * (1.0 - w_de) * de_delta
                   - (9.0 * adotoa ** 2 * (1.0 - w_de)
                      + 3.0 * adotoa * wpr) * de_V / k2)
        de_Vdot = 2.0 * adotoa * de_V + k2 * de_delta + wpr * de_V
        parts.append(torch.stack([torch.where(rsa, zero, de_ddot),
                                  torch.where(rsa, zero, de_Vdot)], -1))
    return torch.cat(parts, -1), aux


def _sources(y, dy, aux, q, k):
    """Newtonian-gauge sources and matter transfers at a node (the JAX
    sources_at + step tail); returns the 7 planes, each (C, nk)."""
    Q = lambda f: q[:, f:f + 1]
    adotoa, grho_g, grho_n = Q(Q_ADOTOA), Q(Q_GG), Q(Q_GNISW)
    vis, expmk = Q(Q_VIS), Q(Q_EXPMK)
    k2 = k * k
    alpha = (aux["hdot"] + 6.0 * aux["etadot"]) / (2.0 * k2)
    X = 1.5 * aux["dgpi"] / k2
    eta = y[..., _I_ETA]
    phi = eta - adotoa * alpha
    psi = phi - X
    dadotoa = -(Q(Q_GRHO) + 3.0 * Q(Q_GPRES)) / 6.0
    alphadot = eta - X - 2.0 * adotoa * alpha
    phidot = aux["etadot"] - dadotoa * alpha - adotoa * alphadot
    dgpidot = (4.0 / 3.0) * (
        -2.0 * adotoa * (grho_g * aux["sigma_g"] + grho_n * aux["sigma_n"])
        + grho_g * aux["sigg_dot"] + grho_n * aux["sign_dot"])
    if "dgpidot_extra" in aux:
        dgpidot = dgpidot + aux["dgpidot_extra"]
    psidot = phidot - 1.5 * dgpidot / k2
    theta0_N = y[..., _I_DG] / 4.0 - adotoa * alpha
    vb_N = (y[..., _I_TB] + k2 * alpha) / k
    Pi = aux["pol_term"] / 4.0
    s0 = vis * (theta0_N + psi + Pi / 4.0) + expmk * (phidot + psidot)
    s1 = vis * vb_N
    s2 = 0.75 * vis * Pi
    slens = expmk * (phi + psi)
    weyl = 0.5 * (phi + psi)
    gc, gb = Q(Q_GC), Q(Q_GB)
    wsum = gc + gb
    dm = (gc * y[..., _I_DC] + gb * y[..., _I_DB]) / wsum
    dmdot = (gc * dy[..., _I_DC] + gb * dy[..., _I_DB]) / wsum
    return s0, s1, s2, slens, dm, dmdot, weyl


def _step(y, qa, qm, qb, k, rnu, iso, rsa_ktau, massive_nu=False,
          de_perts=False):
    """One RK4 step of `_evolve_plain` from y (C, nk, NVAR + extra) over the
    stage rows qa, qm, qb (C, q_fields): the new state (the held ICs at
    tau_b before a lane's release) and the 7 planes at tau_b, (7, C, nk).
    csrc/boltzmann_adjoint.cuh's `step` and `step_vjp` repeat it."""
    sw = dict(massive_nu=massive_nu, de_perts=de_perts)
    tau_a, tau_b = qa[:, Q_TAU:Q_TAU + 1], qb[:, Q_TAU:Q_TAU + 1]
    dt = (tau_b - tau_a)[..., None]
    k1, _ = _rhs(y, qa, k, rsa_ktau, **sw)
    k2_, _ = _rhs(y + 0.5 * dt * k1, qm, k, rsa_ktau, **sw)
    k3_, _ = _rhs(y + 0.5 * dt * k2_, qm, k, rsa_ktau, **sw)
    k4_, _ = _rhs(y + dt * k3_, qb, k, rsa_ktau, **sw)
    y_new = y + (dt / 6.0) * (k1 + 2 * k2_ + 2 * k3_ + k4_)
    released = (k * tau_b >= IC_RELEASE_KTAU) | (tau_b >= 3.0)
    y = torch.where(released[..., None], y_new,
                    adiabatic_ics(k, tau_b, rnu, iso=iso, **sw))
    dy, aux = _rhs(y, qb, k, rsa_ktau, **sw)
    return y, torch.stack(_sources(y, dy, aux, qb, k))


def _evolve_plain(qtab: torch.Tensor, k: torch.Tensor, rnu: torch.Tensor,
                  rsa_ktau: float, massive_nu: bool = False,
                  de_perts: bool = False,
                  iso: Optional[torch.Tensor] = None,
                  remat_chunks: int = 0) -> torch.Tensor:
    """RK4 over the grid as batched torch; returns (7, C, N-1, nk). `iso`
    (C, 3, from `iso_inputs`) adds the CDM-isocurvature admixture to the
    ICs.

    Records a graph when grad is enabled and qtab, rnu or iso wants one;
    otherwise runs under no_grad. With `remat_chunks` > 0 the graph is
    checkpointed as JAX's remat_chunks does (perturbations.py:906-925):
    the steps fall into that many chunks of ceil((N-1)/remat_chunks) steps
    (JAX pads the last chunk with dt = 0 no-ops, which change nothing),
    only the state at each chunk's start is kept, and each chunk's interior
    is recomputed in the backward pass (utils/remat.py); the numbers do not
    depend on the chunk count."""
    C, S = qtab.shape[0], qtab.shape[1]
    rn = rnu[:, None]
    sw = dict(massive_nu=massive_nu, de_perts=de_perts)

    def ics(tau, rn, iso):
        return adiabatic_ics(k, tau, rn, iso=iso, **sw)

    def step(y, i, qtab, rn, iso):
        return _step(y, qtab[:, i, 0], qtab[:, i, 1], qtab[:, i, 2], k, rn,
                     iso, rsa_ktau, **sw)

    record = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (qtab, rnu, iso))
    if not record:
        out = torch.empty(len(PLANES), C, S, k.shape[0], dtype=qtab.dtype,
                          device=qtab.device)
        with torch.no_grad():
            y = ics(qtab[:, 0, 0, Q_TAU:Q_TAU + 1], rn, iso)
            for i in range(S):
                y, out[:, :, i] = step(y, i, qtab, rn, iso)
        return out

    def run(y, lo, hi, qtab, rn, iso):
        outs = []
        for i in range(lo, hi):
            y, o = step(y, i, qtab, rn, iso)
            outs.append(o)
        return y, torch.stack(outs, 2)

    y = ics(qtab[:, 0, 0, Q_TAU:Q_TAU + 1], rn, iso)
    if remat_chunks <= 0:
        return run(y, 0, S, qtab, rn, iso)[1]
    chunk = -(-S // remat_chunks)
    outs = []
    for lo in range(0, S, chunk):
        y, o = remat(run, y, lo, min(lo + chunk, S), qtab, rn, iso)
        outs.append(o)
    return torch.cat(outs, 2)


@functools.lru_cache(maxsize=None)
def _nu_constants(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(2, NQ_NU) on the device, once: the normalized node weights and
    d ln f0 / d ln q, as csrc/perturbations.cu reads them."""
    return torch.as_tensor(np.stack([_NU_WNORM, _NU_DLNF]), dtype=dtype,
                           device=device)


#: the kernel instantiation of each (massive_nu, de_perts)
VARIANTS = {(False, False): "boltzmann", (True, False): "boltzmann_nu",
            (False, True): "boltzmann_de", (True, True): "boltzmann_nu_de"}


def _evolve_launch(qtab, k, rnu, rsa_ktau, massive_nu, de_perts, iso,
                   chunk: int = 0):
    """The forward kernel: the planes (7, C, S, nk) and, with `chunk` > 0,
    the checkpoints (C, nk, ceil(S / chunk) + 1, NVAR + extra_state(
    massive_nu, de_perts)): the state before every chunk-th step and after
    the last, in the plain layout."""
    C, S = qtab.shape[0], qtab.shape[1]
    nk = k.shape[0]
    kernels.check(qtab, "qtab", (C, S, 3, q_fields(massive_nu, de_perts)))
    kernels.check(k, "k", (nk,), qtab.dtype)
    kernels.check(rnu, "rnu", (C,), qtab.dtype)
    if iso is None:
        iso = torch.zeros(C, 3, dtype=qtab.dtype, device=qtab.device)
    kernels.check(iso, "iso", (C, 3), qtab.dtype)
    nuc = _nu_constants(qtab.dtype, qtab.device)
    out = torch.empty(len(PLANES), C, S, nk, dtype=qtab.dtype,
                      device=qtab.device)
    name = VARIANTS[massive_nu, de_perts]
    if chunk <= 0:
        kernels.launch(name, qtab.dtype, qtab, k, rnu, iso, nuc, out, C, S, nk,
                       float(rsa_ktau))
        return out, None
    ck = torch.empty(C, nk, -(-S // chunk) + 1,
                     NVAR + extra_state(massive_nu, de_perts),
                     dtype=qtab.dtype, device=qtab.device)
    kernels.launch(name, qtab.dtype, qtab, k, rnu, iso, nuc, out, ck, C, S, nk,
                   float(rsa_ktau), chunk, entry=f"{name}_ck")
    return out, ck


def _bwd_lanes(nk: int):
    """The reverse kernel's blocks a chain and threads a block (csrc/
    boltzmann_bwd.cu bwd_blocks, bwd_threads): up to 256 k lanes a block,
    at least 64 threads."""
    return -(-nk // 256), max(64, -(-min(nk, 256) // 32) * 32)


#: the reverse kernel of each (massive_nu, de_perts)
BWD_VARIANTS = {sw: f"{name}_bwd" for sw, name in VARIANTS.items()}


def _boltzmann_bwd(qtab, k, rnu, iso, ck, g_out, rsa_ktau, chunk,
                   massive_nu: bool = False, de_perts: bool = False):
    """csrc/boltzmann_bwd.cu's reverse kernel of the instantiation
    (massive_nu, de_perts): the cotangents of qtab (C, S, 3, q_fields(
    massive_nu, de_perts)), rnu (C,) and iso (C, 3) from those of the
    planes, as `_evolve_plain` under autograd gives them. One thread a
    (chain, k) lane, the chunks in reverse, each recomputed from its
    checkpoint; the table's rows summed over the lanes in a fixed order."""
    C, S = qtab.shape[0], qtab.shape[1]
    nk = k.shape[0]
    nblk, threads = _bwd_lanes(nk)
    dev, dt = qtab.device, qtab.dtype
    nvx = NVAR + extra_state(massive_nu, de_perts)
    scratch = torch.empty(C, chunk, nvx, nblk * threads, dtype=dt, device=dev)
    g_q = torch.empty(C, nblk, S, 3, q_fields(massive_nu, de_perts), dtype=dt,
                      device=dev)
    g_rnu = torch.empty(C, nblk, dtype=dt, device=dev)
    g_iso = torch.empty(C, nblk, 3, dtype=dt, device=dev)
    kernels.launch(BWD_VARIANTS[massive_nu, de_perts], dt, qtab, k, rnu, iso,
                   _nu_constants(dt, dev), ck, g_out.contiguous(), scratch,
                   g_q, g_rnu, g_iso, C, S, nk, float(rsa_ktau), chunk)
    if nblk == 1:
        return g_q[:, 0], g_rnu[:, 0], g_iso[:, 0]
    return g_q.sum(1), g_rnu.sum(1), g_iso.sum(1)


class _Boltzmann(torch.autograd.Function):
    """K1 on the card with its reverse kernel, for every instantiation: the
    forward kernel also writes the chunk checkpoints, the backward launches
    `BWD_VARIANTS[massive_nu, de_perts]`."""

    @staticmethod
    def forward(ctx, qtab, k, rnu, iso, rsa_ktau, chunks, massive_nu,
                de_perts):
        chunk = -(-qtab.shape[1] // chunks)
        out, ck = _evolve_launch(qtab, k, rnu, rsa_ktau, massive_nu, de_perts,
                                 iso, chunk)
        ctx.save_for_backward(qtab, k, rnu, iso, ck)
        ctx.rsa_ktau, ctx.chunk = rsa_ktau, chunk
        ctx.switches = (massive_nu, de_perts)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        qtab, k, rnu, iso, ck = ctx.saved_tensors
        g_q, g_rnu, g_iso = _boltzmann_bwd(qtab, k, rnu, iso, ck, g_out,
                                           ctx.rsa_ktau, ctx.chunk,
                                           *ctx.switches)
        return g_q, None, g_rnu, g_iso, None, None, None, None


#: K1's checkpoint count on the card when a gradient is wanted and the
#: caller gives none: JAX's driver's default for HMC (driver.py:205)
DEFAULT_REMAT_CHUNKS = 64


def _evolve_cuda(qtab: torch.Tensor, k: torch.Tensor, rnu: torch.Tensor,
                 rsa_ktau: float, massive_nu: bool = False,
                 de_perts: bool = False,
                 iso: Optional[torch.Tensor] = None,
                 remat_chunks: int = 0) -> torch.Tensor:
    """csrc/perturbations.cu: one warp per (chain, k) lane runs the whole
    tau loop.

    Replaces cosmomc_tpu/models/perturbations.py:evolve_perturbations (the
    lax.scan at :928 over make_rhs.rhs and rk4_step). Bound: operations (5
    RHS evaluations a step, ~8191 dependent steps per lane), and in
    practice each lane's dependency chain. Every thread of the warp holds
    the eight fluid variables (ten with the DE fluid) and computes their
    derivatives alike; threads 0..28 hold one multipole each
    (`MULTIPOLE_LANES`) and, with massive_nu, threads 0..27 one Psi_l(q_i)
    each as well (thread 7 i + l), neighbours and the momentum sums by warp
    shuffles, so the RK4 state is 4 x 9 values a thread (4 x 12 with both
    extensions). A block is 8 warps of consecutive k of one chain: it
    stages the next tile of steps' qtab rows in shared memory by cp.async,
    computes their k-independent terms once, and collects its 8 lanes'
    sources to store (plane, chain, step, 8 consecutive k) at once. One
    launch a call, of the instantiation `VARIANTS[massive_nu, de_perts]`;
    `iso` (C, 3, from `iso_inputs`) gives each chain its CDM-isocurvature
    admixture in the held ICs.

    When qtab, rnu or iso wants a gradient (and grad is enabled), every
    instantiation runs as `_Boltzmann`: the forward stores the state at
    `remat_chunks` chunk boundaries (DEFAULT_REMAT_CHUNKS when 0) and the
    backward is `_boltzmann_bwd`. CPU tensors raise ValueError here as
    anywhere in the kernel wrappers: their plain version is
    `_evolve_plain`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (qtab, rnu, iso)):
        if iso is None:
            iso = torch.zeros(qtab.shape[0], 3, dtype=qtab.dtype,
                              device=qtab.device)
        return _Boltzmann.apply(qtab, k, rnu, iso, float(rsa_ktau),
                                remat_chunks or DEFAULT_REMAT_CHUNKS,
                                massive_nu, de_perts)
    return _evolve_launch(qtab, k, rnu, rsa_ktau, massive_nu, de_perts, iso)[0]


def evolve_perturbations(bg: BackgroundParams, tf: ThermoFuncs,
                         tau0: torch.Tensor, k: torch.Tensor,
                         z_outputs: Tuple[float, ...] = (0.0,),
                         rsa_ktau: float = RSA_KTAU,
                         massive_nu: bool = False, de_perts: bool = False,
                         iso_cdm_amp=0.0,
                         remat_chunks: int = 0) -> PerturbationOutput:
    """Evolve all k modes of every chain over the shared grid.
    `massive_nu` and `de_perts` extend the state (module docstring);
    `iso_cdm_amp`, 0.0 or one amplitude a chain ((C,) or a scalar), adds
    the correlated CDM-isocurvature admixture. `remat_chunks`: the
    checkpoint count of the evolution's gradient (JAX's remat_chunks; 0
    keeps every step on the CPU and takes DEFAULT_REMAT_CHUNKS on the
    card); it changes memory, not numbers."""
    dtype = tf.tau.dtype
    k = k.to(dtype=dtype, device=tf.tau.device).contiguous()
    C, N = tf.tau.shape
    qtab = _stage_tables(bg, tf, massive_nu, de_perts)
    rnu = _r_nu(bg).contiguous()
    iso = (None if isinstance(iso_cdm_amp, float) and iso_cdm_amp == 0.0
           else iso_inputs(bg, iso_cdm_amp))
    evolve = _evolve_plain if qtab.device.type == "cpu" else _evolve_cuda
    raw = evolve(qtab, k, rnu, rsa_ktau, massive_nu, de_perts, iso,
                 remat_chunks)

    # the curvature normalisation of the PURE-ADIABATIC start state, even
    # with an isocurvature admixture (perturbations.py:812-822)
    y0 = adiabatic_ics(k, tf.tau[:, :1], rnu[:, None])
    norm = measure_curvature(bg, tf, y0, k)               # (C, nk)
    planes = torch.cat([torch.zeros_like(raw[:, :, :1]), raw], 2)
    planes = planes.transpose(2, 3)                        # (7, C, nk, N)
    s0, s1, s2, slens, dm_t, dmdot_t, weyl_t = planes.unbind(0)

    lna_tab, tau_tab = _conformal_time_table(bg)
    a_out = torch.tensor([1.0 / (1.0 + z) for z in z_outputs], dtype=dtype,
                         device=tf.tau.device)
    tau_out = interp(torch.log(a_out).expand(C, -1), lna_tab.expand(C, -1),
                     tau_tab)                              # (C, nz)

    def snap(rows):                                        # (C, nk, N) -> (C, nz, nk)
        return interp(tau_out[:, None, :], tf.tau[:, None, :],
                      rows).transpose(1, 2)
    grhos = grho_terms(bg, a_out.expand(C, -1))
    aH_out = torch.sqrt((grhos[0] + grhos[1] + grhos[2] + grhos[4] + grhos[5]
                         + grhos[6] + grhos[7]) / 3.0)
    nrm = norm[:, :, None]
    return PerturbationOutput(
        tau=tf.tau, k=k, s0=s0 / nrm, s1=s1 / nrm, s2=s2 / nrm, spol=s2 / nrm,
        slens=slens / nrm, delta_m=dm_t[:, :, -1] / norm, r_init=norm,
        tau0=tau0, delta_m_z=snap(dm_t) / norm[:, None, :], growth_tau=tf.tau,
        ddelta_m_z=snap(dmdot_t) / norm[:, None, :],
        weyl_z=snap(weyl_t) / norm[:, None, :], aH_z=aH_out)
