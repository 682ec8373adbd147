"""Recombination history x_e(z): RECFAST 1.5.2 model (kernel K4).

Port of cosmomc_tpu/models/recfast.py:compute_thermo. The model is the
same: Peebles effective 3-level H with the recfast 1.5 fudge and double-
Gaussian K correction, the HeI singlet channel, Compton-coupled T_M, and
Saha phases for He++, He+ and H. Each step of the descending-z grid is a
Crank-Nicolson update with two Newton iterations, T_M first, then He (with
x_H frozen), then H (with the new x_He). The code, not the JAX docstring's
"backward Euler", is what is ported.

Layout of the work:
  - every quantity that depends on z alone (H(z), n_H(z), T_rad, the K
    correction and the three Saha solutions) is evaluated in one
    vectorized pass over the whole (chains, N_Z) grid by `_z_tables`;
  - the recurrence itself (T_M, x_He, x_H) runs either as a Python loop
    of batched torch ops (`_scan_plain`, the reference path, and what
    CPU tensors take) or as the CUDA kernel csrc/recfast.cu (one warp
    per chain, the z loop inside the kernel).

The Newton derivative of each Crank-Nicolson residual is written in
closed form (the JAX package takes jax.grad of the same expression); it is
exact, and both paths share it line for line.

Gradients: the plain version records a graph when its input wants one,
and autograd differentiates the unrolled map, the closed-form Newton
derivatives included, which is what jax.grad of the JAX scan gives. The
clips split the gradient at a tie as jnp.clip does (`_clip`). On the card
`_ThermoScan` pairs the kernel with its reverse kernel.

float32 hardening kept from the JAX package: the cancellation-free
quadratic root (`quad_root`), the clipped decaying exponential in the He
escape rate, and n_H from one folded prefactor (constants.n_H_today).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models.background import BackgroundParams, hubble_mpc
from cosmomc_tpu_torch.utils.remat import remat

# ---- atomic data (recfast 1.5.2 table) ------------------------------------
Lambda_H = 8.2245809
Lambda_He = 51.3
L_H_ion = 1.096787737e7
L_H_alpha = 8.225916453e6
L_He1_ion = 1.98310772e7
L_He2_ion = 4.389088863e7
L_He_2s = 1.66277434e7
L_He_2p = 1.71134891e7

a_PPB, b_PPB, c_PPB, d_PPB = 4.309, -0.6166, 0.6703, 0.5300
a_VF, b_VF = 10.0 ** (-16.744), 0.711
T_0_VF, T_1_VF = 10.0 ** 0.477121, 10.0 ** 5.114

FUDGE_H = 1.125
FUDGE_HE = 0.86
AGauss1, AGauss2 = -0.14, 0.079
zGauss1, zGauss2 = 7.28, 6.73
wGauss1, wGauss2 = 0.18, 0.33

_CR = 2.0 * np.pi * (const.m_e / const.h_planck) * (const.k_B / const.h_planck)
_CB1 = const.h_planck * const.c * L_H_ion / const.k_B
_CDB = const.h_planck * const.c * (L_H_ion - L_H_alpha) / const.k_B
_CL = const.h_planck * const.c * L_H_alpha / const.k_B
_CB1_He1 = const.h_planck * const.c * L_He1_ion / const.k_B
_CB1_He2 = const.h_planck * const.c * L_He2_ion / const.k_B
_CDB_He = const.h_planck * const.c * (L_He1_ion - L_He_2s) / const.k_B
_CL_He = const.h_planck * const.c * L_He_2s / const.k_B
_CK = (1.0 / L_H_alpha) ** 3 / (8.0 * np.pi)
_CK_He = (1.0 / L_He_2p) ** 3 / (8.0 * np.pi)
_CompT = (8.0 / 3.0) * (const.sigma_thomson / (const.m_e * const.c)) \
    * const.a_rad
_Bfact = const.h_planck * const.c * (L_He_2p - L_He_2s) / const.k_B

N_Z = 8000
Z_INIT = 1e4

#: the constants csrc/recfast.cu reads, folded as the Python expressions fold
KERNEL_CONSTS = (_CR, _CDB, _CL, _CDB_He, _CL_He, _CK_He, _CompT, _Bfact,
                 Lambda_H, Lambda_He, FUDGE_H * 1e-19 * a_PPB, b_PPB, c_PPB,
                 d_PPB, FUDGE_HE * a_VF, 1 - b_VF, 1 + b_VF, T_0_VF, T_1_VF)

# rows of the z table handed to both recurrence paths
(ZT_Z, ZT_TR, ZT_CT, ZT_HZ1, ZT_N, ZT_NHE, ZT_KHE, ZT_KH, ZT_XEEARLY,
 ZT_XHESAHA, ZT_XHSAHA, ZT_TMHOT) = range(12)
N_ZT = 12


class ThermoHistory(NamedTuple):
    z: torch.Tensor      # (C, N) descending
    xe: torch.Tensor     # (C, N) free-electron fraction n_e/n_H
    tm: torch.Tensor     # (C, N) matter temperature [K]


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip as min(max(x, lo), hi): the same values as torch.clamp, but
    at a tie (x_H = 1 from the table, the Saha solutions saturated at 1)
    half the gradient passes, as in the JAX package; torch.clamp passes
    all of it."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def z_grid(n_z: int, device, dtype) -> torch.Tensor:
    """The descending-z grid, log-spaced in (1+z) from Z_INIT to 0."""
    lz = torch.linspace(float(np.log(1.0 + Z_INIT)), 0.0, n_z,
                        dtype=torch.float64).to(device=device, dtype=dtype)
    return torch.exp(lz) - 1.0


def quad_root(B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Positive root of x^2 + B x - C = 0, cancellation-free for either
    sign of B (float32-safe)."""
    tiny = torch.finfo(B.dtype).tiny
    disc = torch.sqrt(B * B + 4.0 * C + tiny)
    den = torch.where(B > 0.0, disc + B, 1.0)
    return torch.where(B > 0.0, 2.0 * C / den, 0.5 * (disc - B))


def _z_tables(bg: BackgroundParams, zs: torch.Tensor, fHe: torch.Tensor,
              Nnow: torch.Tensor) -> torch.Tensor:
    """Every z-only quantity of the scan, (C, N_ZT, N): z, T_rad, the
    Compton factor CompT T_rad^4/(H (1+z)), H (1+z), n_H, n_He, the He and
    H escape factors, the capped He++ Saha x_e, the He+ and H Saha
    solutions, and the radiation-locked T_M."""
    C = fHe.shape[0]
    z = zs.expand(C, -1)
    c = lambda v: v[:, None]
    tr = c(bg.tcmb) * (1.0 + z)
    n = c(Nnow) * (1.0 + z) ** 3
    Hz = hubble_mpc(bg, 1.0 / (1.0 + z)) * const.c / const.Mpc
    hz1 = Hz * (1.0 + z)
    lz1 = torch.log(1.0 + z)
    corr = (1.0 + AGauss1 * torch.exp(-((lz1 - zGauss1) / wGauss1) ** 2)
            + AGauss2 * torch.exp(-((lz1 - zGauss2) / wGauss2) ** 2))
    lcr = 1.5 * torch.log(_CR * tr)
    rhs2 = torch.exp(lcr - _CB1_He2 / tr) / n
    xe_he2 = quad_root(rhs2 - 1.0 - c(fHe), (1.0 + 2.0 * c(fHe)) * rhs2)
    rhs1 = 4.0 * torch.exp(lcr - _CB1_He1 / tr) / n
    x0 = quad_root(rhs1 - 1.0, (1.0 + c(fHe)) * rhs1)
    rhsh = torch.exp(lcr - _CB1 / tr) / n
    return torch.stack([
        z, tr, _CompT * tr ** 4 / hz1, hz1, n, c(fHe) * n, _CK_He / Hz,
        _CK * corr / Hz, torch.minimum(xe_he2, 1.0 + 2.0 * c(fHe)),
        _clip((x0 - 1.0) / c(fHe), 0.0, 1.0), quad_root(rhsh, rhsh), tr],
        dim=1)


def _alpha_H(tm):
    t = tm / 1e4
    return FUDGE_H * 1e-19 * a_PPB * t ** b_PPB / (1.0 + c_PPB * t ** d_PPB)


def _alpha_He(tm):
    sq0 = torch.sqrt(tm / T_0_VF)
    sq1 = torch.sqrt(tm / T_1_VF)
    return FUDGE_HE * a_VF / (sq0 * (1 + sq0) ** (1 - b_VF)
                              * (1 + sq1) ** (1 + b_VF))


def _rate_coeffs(t):
    """The T_M-dependent rate coefficients of both channels at T_M = t:
    (He: rdown, rup, exp(-CL_He/t), -Bfact/t), (H: rdown, rup, exp(-CL/t))."""
    he_down = _alpha_He(t)
    he_up = 4.0 * he_down * (_CR * t) ** 1.5 * torch.exp(-_CDB_He / t)
    h_down = _alpha_H(t)
    h_up = h_down * (_CR * t) ** 1.5 * torch.exp(-_CDB / t)
    return ((he_down, he_up, torch.exp(-_CL_He / t), -_Bfact / t),
            (h_down, h_up, torch.exp(-_CL / t)))


def _he_rate(coeffs, r):
    """The He rate set at a node: coefficients at its T_M + the node's row."""
    return coeffs[0] + (r[ZT_KHE], r[ZT_N], r[ZT_NHE], r[ZT_HZ1])


def _h_rate(coeffs, r):
    return coeffs[1] + (r[ZT_KH], r[ZT_N], r[ZT_HZ1])


def _cn(x, f_prev, dz, rhs):
    """Crank-Nicolson step from x with two Newton iterations; rhs(x) gives
    the rate and its derivative."""
    xp = x + dz * f_prev
    for _ in range(2):
        v, d = rhs(xp)
        g = xp - x - 0.5 * dz * (f_prev + v)
        gp = 1.0 - 0.5 * dz * d
        xp = xp - g / torch.where(gp.abs() > 1e-12, gp, 1.0)
    return xp


def _tm_step(r0, r1, tm, xe_tot, fHe):
    """T_M at the next node: dTm/dz = A (tm - tr) + 2 tm/(1+z),
    A = CT xe/(1+xe+fHe)."""
    z = r1[ZT_Z]
    dz = z - r0[ZT_Z]
    xfac = xe_tot / (1.0 + xe_tot + fHe)
    A0, A1 = r0[ZT_CT] * xfac, r1[ZT_CT] * xfac
    tr1, zp1 = r1[ZT_TR], 1.0 + z
    fT = A0 * (tm - r0[ZT_TR]) + 2.0 * tm / (1.0 + r0[ZT_Z])
    return _cn(tm, fT, dz, lambda tt: (A1 * (tt - tr1) + 2.0 * tt / zp1,
                                       A1 + 2.0 / zp1))


def _dxhe(xx, xe, fHe, rate):
    """He singlet rate (xe = x_H + fHe xx) and its derivative in xx."""
    rdown, rup, ecl, bt, khe, n, nhe, hz1 = rate
    nhe1 = (1.0 - xx) * nhe
    live = nhe1 > 1e-30
    nhe1 = torch.where(live, nhe1, 1e-30)
    arg = bt - torch.log(khe * nhe1)
    u = torch.exp(torch.minimum(arg, arg.new_tensor(80.0)))
    du = torch.where(live & (arg < 80.0), u * nhe / nhe1, 0.0)
    den = u + Lambda_He + rup
    crate = (u + Lambda_He) / den
    dcrate = du * rup / (den * den)
    q = xe * xx * n * rdown - rup * (1.0 - xx) * ecl
    dq = (fHe * xx + xe) * n * rdown + rup * ecl
    return q * crate / hz1, (dq * crate + q * dcrate) / hz1


def _dxh(xx, xe, rate):
    """Peebles rate (xe = xx + fHe x_He) and its derivative in xx."""
    rdown, rup, ecl, K, n, hz1 = rate
    n1s = (1.0 - xx) * n
    live = n1s > 1e-30
    n1s = torch.where(live, n1s, 1e-30)
    den = 1.0 + K * (Lambda_H + rup) * n1s
    crate = (1.0 + K * Lambda_H * n1s) / den
    dcrate = torch.where(live, n * K * rup / (den * den), 0.0)
    q = xe * xx * n * rdown - rup * (1.0 - xx) * ecl
    dq = (xx + xe) * n * rdown + rup * ecl
    return q * crate / hz1, (dq * crate + q * dcrate) / hz1


def first_live_node(zt: torch.Tensor) -> torch.Tensor:
    """(C,) the first node j >= 1 of each chain where the regime selection
    can take an ODE value: not (z > 3000, x_He,Saha > 0.995 and
    x_H,Saha > 0.985); N where there is none. Before it the state is the
    table's whatever the ODE steps give, so the recurrence can start at
    the node before it (what csrc/recfast.cu does)."""
    N = zt.shape[-1]
    live = ~((zt[:, ZT_Z] > 3000.0) & (zt[:, ZT_XHESAHA] > 0.995)
             & (zt[:, ZT_XHSAHA] > 0.985))
    live[:, 0] = False
    idx = torch.arange(N, device=zt.device).expand_as(live)
    return torch.where(live, idx, N).amin(-1)


def table_prefix(zt: torch.Tensor, fHe: torch.Tensor, n: int):
    """(x_H, x_He, x_e, T_M) at nodes 0..n-1, each (C, n), where every one of
    them lies before the first live node: the selection's table branch;
    node 0 holds the scan's initial state (fully ionized, x_e = 1 + 2 fHe).
    Built without writing into the clips' outputs, so autograd runs
    through it."""
    node0 = torch.arange(n, device=zt.device) == 0
    xHe = torch.where(node0, 1.0, _clip(zt[:, ZT_XHESAHA, :n], 0.0, 1.0))
    xH = torch.where(node0, 1.0, _clip(zt[:, ZT_XHSAHA, :n], 0.0, 1.0))
    xe = torch.where(node0, 1.0 + 2.0 * fHe[:, None],
                     torch.where(zt[:, ZT_Z, :n] > 5500.0, zt[:, ZT_XEEARLY, :n],
                                 xH + fHe[:, None] * xHe))
    return xH, xHe, xe, zt[:, ZT_TMHOT, :n]


#: nodes a rematerialized chunk of `_scan_plain`'s recorded graph holds
SCAN_REMAT_NODES = 500


def _scan_plain(zt: torch.Tensor, fHe: torch.Tensor, start: int = 1):
    """The recurrence as batched torch ops; zt (C, N_ZT, N). Returns
    (xe, tm), each (C, N). `start`: the first node the recurrence computes
    (1: all of them); nodes before it take the table's state, which is the
    same result when start <= first_live_node(zt).min(). Records a graph
    when grad is enabled and zt or fHe wants one (the unrolled map, as
    jax.grad differentiates the scan), rematerialized in chunks of
    SCAN_REMAT_NODES nodes (utils/remat.py: only each chunk's starting
    state is kept and its interior is recomputed in the backward pass,
    which bounds the graph's host memory and changes no number); otherwise
    runs under no_grad."""
    C, _, N = zt.shape
    record = torch.is_grad_enabled() and (zt.requires_grad or fHe.requires_grad)
    start = max(1, min(int(start), N))
    xH, xHe, xe_pre, tm_pre = table_prefix(zt, fHe, start)
    state = (xH[:, -1], xHe[:, -1], tm_pre[:, -1])
    xe_out, tm_out = [xe_pre], [tm_pre]

    def run(i0, i1, xH, xHe, tm, zt, fHe):
        """Nodes i0 + 1 .. i1 from the state at node i0."""
        steps = zt[:, :, i0:i1 + 1].permute(2, 1, 0).unbind(0)
        xe_c, tm_c = [], []
        for j in range(i1 - i0):
            r0, r1 = steps[j], steps[j + 1]
            z = r1[ZT_Z]
            dz = z - r0[ZT_Z]
            xe_tot = xH + fHe * xHe
            tm_new = _tm_step(r0, r1, tm, xe_tot, fHe)
            c0, c1 = _rate_coeffs(tm), _rate_coeffs(tm_new)
            # He singlet channel, x_H frozen
            he1 = _he_rate(c1, r1)
            f_he = _dxhe(xHe, xe_tot, fHe, _he_rate(c0, r0))[0]
            xHe_ode = _cn(xHe, f_he, dz,
                          lambda xx: _dxhe(xx, xH + fHe * xx, fHe, he1))
            # H with the new x_He
            h1 = _h_rate(c1, r1)
            f_h = _dxh(xH, xe_tot, _h_rate(c0, r0))[0]
            xH_ode = _cn(xH, f_h, dz,
                         lambda xx: _dxh(xx, xx + fHe * xHe_ode, h1))
            # regime selection
            xhe_s, xh_s = r1[ZT_XHESAHA], r1[ZT_XHSAHA]
            xHe = _clip(torch.where(xhe_s > 0.995, xhe_s, xHe_ode), 0.0, 1.0)
            xH = _clip(torch.where(xh_s > 0.985, xh_s, xH_ode), 0.0, 1.0)
            xe_c.append(torch.where(z > 5500.0, r1[ZT_XEEARLY],
                                    xH + fHe * xHe))
            tm = torch.where(z > 3000.0, r1[ZT_TMHOT], tm_new)
            tm_c.append(tm)
        return xH, xHe, tm, torch.stack(xe_c, 1), torch.stack(tm_c, 1)

    if record:
        for i0 in range(start - 1, N - 1, SCAN_REMAT_NODES):
            *state, xe_c, tm_c = remat(
                run, i0, min(i0 + SCAN_REMAT_NODES, N - 1), *state, zt, fHe)
            xe_out.append(xe_c)
            tm_out.append(tm_c)
    elif start < N:
        with torch.no_grad():
            *_, xe_c, tm_c = run(start - 1, N - 1, *state, zt, fHe)
        xe_out.append(xe_c)
        tm_out.append(tm_c)
    return torch.cat(xe_out, 1), torch.cat(tm_out, 1)


def _recfast_launch(zt: torch.Tensor, fHe: torch.Tensor, store: bool):
    """The forward kernel: (xe, tm) and, with `store`, the walked state
    (x_H, x_He) of every node, (C, 2, N), for the reverse kernel."""
    C, nzt, N = zt.shape
    kernels.check(zt, "zt", (C, N_ZT, N))
    kernels.check(fHe, "fHe", (C,), zt.dtype)
    xe = torch.empty(C, N, dtype=zt.dtype, device=zt.device)
    tm = torch.empty_like(xe)
    kc = torch.tensor(KERNEL_CONSTS, dtype=zt.dtype, device=zt.device)
    if not store:
        kernels.launch("recfast", zt.dtype, zt, fHe, kc, xe, tm, C, N)
        return xe, tm, None
    st = torch.empty(C, 2, N, dtype=zt.dtype, device=zt.device)
    kernels.launch("recfast", zt.dtype, zt, fHe, kc, xe, tm, st, C, N,
                   entry="recfast_st")
    return xe, tm, st


def _recfast_bwd(zt, fHe, st, tm, g_xe, g_tm):
    """csrc/recfast.cu's reverse kernel: (grad_zt (C, N_ZT, N), grad_fHe
    (C,)) from the cotangents of xe and tm, the gradient of the unrolled
    map as `_scan_plain` under autograd gives it. One warp a chain walks
    back from the last node; lane d carries one column of a step's
    Jacobian in dual numbers (28 inputs: the state, both table rows, fHe)
    and dots it with the adjoint of the step's outputs."""
    C, _, N = zt.shape
    g_zt = torch.zeros_like(zt)
    g_fhe = torch.empty_like(fHe)
    kc = torch.tensor(KERNEL_CONSTS, dtype=zt.dtype, device=zt.device)
    kernels.launch("recfast_bwd", zt.dtype, zt, fHe, kc, st, tm,
                   g_xe.contiguous(), g_tm.contiguous(), g_zt, g_fhe, C, N)
    return g_zt, g_fhe


class _ThermoScan(torch.autograd.Function):
    """K4 on the card with its reverse kernel: the forward kernel stores the
    walked state, the backward launches `recfast_bwd`."""

    @staticmethod
    def forward(ctx, zt, fHe):
        xe, tm, st = _recfast_launch(zt, fHe, store=True)
        ctx.save_for_backward(zt, fHe, st, tm)
        return xe, tm

    @staticmethod
    @once_differentiable
    def backward(ctx, g_xe, g_tm):
        zt, fHe, st, tm = ctx.saved_tensors
        g_xe = torch.zeros_like(tm) if g_xe is None else g_xe
        g_tm = torch.zeros_like(tm) if g_tm is None else g_tm
        return _recfast_bwd(zt, fHe, st, tm, g_xe, g_tm)


def _scan_cuda(zt: torch.Tensor, fHe: torch.Tensor):
    """csrc/recfast.cu: one warp per chain walks the z grid.

    Replaces cosmomc_tpu/models/recfast.py:compute_thermo (the lax.scan at
    :279). Bound: the dependency chain of each chain's state, 7999 steps of
    about 300 flops, not bytes or operations. The kernel shortens the
    chain: the warp writes the nodes before `first_live_node` from the
    table in parallel and walks only the rest; the independent pow and exp
    of the rate coefficients are evaluated one per lane and gathered by
    shuffles; the coefficients at node j are kept for step j + 1; a solve
    whose result the selection discards is skipped; divisors that depend on
    z alone become reciprocals taken once per 32 nodes and quotients with
    a common divisor share it (18 divides a step where the plain version
    has 47); the table rows of the next 32 nodes are staged into shared
    memory while the current 32 are walked. One launch a call. When zt or
    fHe wants a gradient (and grad is enabled), `_ThermoScan`: the forward
    also stores the state, and the backward is `_recfast_bwd`."""
    if torch.is_grad_enabled() and (zt.requires_grad or fHe.requires_grad):
        return _ThermoScan.apply(zt, fHe)
    xe, tm, _ = _recfast_launch(zt, fHe, store=False)
    return xe, tm


def compute_thermo(bg: BackgroundParams, yhe: torch.Tensor,
                   n_z: int = N_Z) -> ThermoHistory:
    """Integrate the recombination history for every chain.
    Returns descending-z tables (C, n_z)."""
    dtype, dev = bg.ombh2.dtype, bg.ombh2.device
    mu_H = 1.0 / (1.0 - yhe)
    Nnow = const.n_H_today(bg.ombh2, mu_H)
    fHe = yhe / (const.mass_ratio_He_H * (1.0 - yhe))
    zs = z_grid(n_z, dev, dtype)
    zt = _z_tables(bg, zs, fHe, Nnow).contiguous()
    scan = _scan_plain if dev.type == "cpu" else _scan_cuda
    xe, tm = scan(zt, fHe.contiguous())
    return ThermoHistory(zs.expand(yhe.shape[0], -1), xe, tm)
