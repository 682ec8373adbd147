"""Lensed CMB spectra: curved-sky correlation-function method (kernel K3).

Port of cosmomc_tpu/models/lensing.py:lens_cls (camb/lensing.f90
CorrFuncFullSkyImpl, Challinor & Lewis astro-ph/0502425): non-perturbative
isotropic term with a second-order expansion in C_gl,2, three passes over l
with every theta a lane:

  pass 1: sigma^2(theta), C_gl2(theta) from C_l^phiphi;
  pass 2: the four lensed-minus-unlensed correlation deltas xi_i(theta);
  pass 3: project back, DeltaC_l = 2 pi int dtheta sin(theta) xi_i d^l(theta).

The high-spin Wigner-d functions are [exact sin/cos(theta/2) prefactor] x
[Jacobi polynomial from the stable upward recurrence], the float32 fix of
the JAX package (lensing.py:51-71); the closed forms in (P_l, P_l') are not
used for them.

`lens_cls` runs the passes as `_passes_plain` (batched torch loops over l,
the reference path and what CPU tensors take) or as csrc/lensing.cu. Units
in and out: l(l+1)C_l/2pi, [l(l+1)]^2 C_l^pp/2pi; every spectrum (C, L).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels

# rows of the theta table handed to both paths
TH_X, TH_SIN, TH_SIN2, TH_FAC1, TH_FAC2, TH_TAIL, TH_SW = range(7)
N_TH = 7


class LensedCls(NamedTuple):
    ls: torch.Tensor   # (nl,) multipoles 2..lmax_lensed
    tt: torch.Tensor   # (C, nl)
    te: torch.Tensor
    ee: torch.Tensor
    bb: torch.Tensor


def _jacobi_advance(n: float, a: float, b: float, x, Jm1, J):
    """P^{(a,b)}_n(x) from (P_{n-2}, P_{n-1}) = (Jm1, J), upward recurrence."""
    if n < 0.0:
        return torch.zeros_like(x)
    if n == 0.0:
        return torch.ones_like(x)
    apb = a + b
    if n == 1.0:
        return (a + 1.0) + (apb + 2.0) * (x - 1.0) / 2.0
    c1 = 2.0 * n * (n + apb) * (2.0 * n + apb - 2.0)
    c2 = (2.0 * n + apb - 1.0) * (a * a - b * b)
    c3 = (2.0 * n + apb - 1.0) * (2.0 * n + apb) * (2.0 * n + apb - 2.0)
    c4 = 2.0 * (n + a - 1.0) * (n + b - 1.0) * (2.0 * n + apb)
    return ((c2 + c3 * x) * J - c4 * Jm1) / (c1 if c1 != 0.0 else 1.0)


def _passes_plain(cl: torch.Tensor, th: torch.Tensor, nl_out: int
                  ) -> torch.Tensor:
    """The three l passes as batched torch. cl (C, 4, L) holds CTT, CTE,
    CEE, Cphil3 for l = 2..lmax; th (N_TH, ntheta) float64, read in cl's
    dtype. Returns the pass-3 sums over theta, (C, nl_out, 4): xi_T P,
    xi_+ d22, xi_- d2m2, xi_X d20."""
    C, _, L = cl.shape
    x, sinth, sin2, fac1, fac2, tail, sw = th.to(cl.dtype).unbind(0)
    sin2half, cos2half = fac1 / 2.0, fac2 / 2.0
    fac = fac1 / fac2
    ones, zeros = torch.ones_like(x), torch.zeros_like(x)
    CTT, CTE, CEE, Cphil3 = (cl[:, i, :, None] for i in range(4))

    # pass 1: sigma^2(theta), C_gl2(theta)
    sig = torch.zeros(C, x.shape[0], dtype=x.dtype, device=x.device)
    cg2 = torch.zeros_like(sig)
    pmm, pmmp1 = ones, x
    for il in range(L):
        l = float(il + 2)
        P = ((2 * l - 1) * x * pmmp1 - (l - 1) * pmm) / l
        pmm, pmmp1 = pmmp1, P
        l = l + 1.0
        dP = (l - 1.0) * (pmm - x * P) / sin2
        d11 = fac1 * dP / ((l - 1.0) * l) + P
        dm11 = fac2 * dP / ((l - 1.0) * l) - P
        sig = sig + (1.0 - d11) * Cphil3[:, il]
        cg2 = cg2 + dm11 * Cphil3[:, il]
    sigmasq, Cg2 = sig, cg2
    Cg2sq = Cg2 ** 2

    # pass 2: the lensed-correlation deltas
    xi = [torch.zeros_like(sig) for _ in range(4)]
    pmm, pmmp1 = ones, x
    jac = [[zeros, zeros], [zeros, zeros], [zeros, zeros]]
    for il in range(L):
        lc = float(il + 2)
        P = ((2 * lc - 1) * x * pmmp1 - (lc - 1) * pmm) / lc
        pmm, pmmp1 = pmmp1, P
        J40 = _jacobi_advance(lc - 2.0, 4.0, 0.0, x, *jac[0])
        J44 = _jacobi_advance(lc - 4.0, 4.0, 4.0, x, *jac[1])
        J80 = _jacobi_advance(lc - 4.0, 8.0, 0.0, x, *jac[2])
        jac = [[jac[0][1], J40], [jac[1][1], J44], [jac[2][1], J80]]
        llp1 = lc * (lc + 1.0)
        lfacs2 = (lc + 2.0) * (lc - 1.0)
        lrootfacs = math.sqrt(llp1 * lfacs2)
        rf1 = math.sqrt(lfacs2)
        rf2 = math.sqrt((lc + 3.0) * (lc - 2.0))
        rf3 = math.sqrt(max((lc - 3.0) * (lc + 4.0), 0.0))
        dP = lc * (pmm - x * P) / sin2
        d11 = fac1 * dP / llp1 + P
        dm11 = fac2 * dP / llp1 - P
        d22 = (((4.0 * x - 8.0) / fac2 + llp1) * P
               + 4.0 * fac * (fac2 + (x - 2.0) / llp1) * dP) / lfacs2
        d2m2 = sin2half ** 2 * J40
        d20 = (2.0 * x * dP - llp1 * P) / lrootfacs
        d1m2 = sinth / rf1 * (dP - 2.0 / fac1 * dm11)
        d12 = sinth / rf1 * (dP - 2.0 / fac2 * d11)
        sinfac = 4.0 / sinth
        if lc >= 3.0:
            d1m3 = (-(x + 0.5) * d1m2 * sinfac - lfacs2 * dm11 / rf1) / rf2
            d2m3 = (-fac2 * d2m2 * sinfac - rf1 * d1m2) / rf2
            d3m3 = (-(x + 1.5) * d2m3 * sinfac - rf1 * d1m3) / rf2
            d13 = ((x - 0.5) * d12 * sinfac - lfacs2 * d11 / rf1) / rf2
        else:
            d1m3 = d2m3 = d3m3 = d13 = zeros
        if lc >= 4.0:
            s4 = lc - 4.0
            norm04 = math.sqrt(((s4 + 5.0) * (s4 + 6.0) * (s4 + 7.0) * (s4 + 8.0))
                               / ((s4 + 1.0) * (s4 + 2.0) * (s4 + 3.0) * (s4 + 4.0)))
            d04 = norm04 * (sin2half * cos2half) ** 2 * J44
            d2m4 = (-(6.0 * x + 4.0) * d2m3 / sinth - rf2 * d2m2) / rf3
            d4m4 = sin2half ** 4 * J80
        else:
            d04 = d2m4 = d4m4 = zeros
        X000 = torch.exp(-llp1 * sigmasq / 4.0)
        X022 = X000 * (1.0 + sigmasq)
        X220 = lrootfacs / 4.0 * X000
        X121 = -0.5 * rf1 * X000
        X132 = -0.5 * rf2 * X000
        X242 = 0.25 * rf2 * rf3 * X022
        dX000 = -llp1 / 4.0 * X000
        dX022 = (1.0 - llp1 / 4.0) * X022
        fac1v = dX000 ** 2
        fac3 = X220 ** 2
        f = ((X000 ** 2 - 1.0) + Cg2sq * fac1v) * P \
            + Cg2sq * fac3 * d2m2 + 8.0 / llp1 * fac1v * Cg2 * dm11
        xi[0] = xi[0] + CTT[:, il] * f
        fac2v = (Cg2 * dX022) ** 2 + (X022 ** 2 - 1.0)
        f = 2.0 * Cg2 * X121 * X132 * d13 + fac2v * d22 \
            + Cg2sq * X242 * X220 * d04
        xi[1] = xi[1] + CEE[:, il] * f
        f = (fac3 * P + X242 ** 2 * d4m4) * Cg2sq / 2.0 \
            + Cg2 * (X121 ** 2 * dm11 + X132 ** 2 * d3m3) + fac2v * d2m2
        xi[2] = xi[2] + CEE[:, il] * f
        f = (X000 * X022 - 1.0) * d20 \
            + 2.0 * dX000 * Cg2 * (X121 * d11 + X132 * d1m3) / math.sqrt(llp1) \
            + Cg2sq * (X220 / 2.0 * d2m4 * X242
                       + (fac3 / 2.0 + dX022 * dX000) * d20)
        xi[3] = xi[3] + CTE[:, il] * f

    # pass 3: project back to DeltaC_l
    xi_t, xi_p, xi_m, xi_x = (v * tail * sw for v in xi)
    sums = []
    pmm, pmmp1 = ones, x
    j40m1, j40 = zeros, zeros
    for il in range(nl_out):
        lc = float(il + 2)
        P = ((2 * lc - 1) * x * pmmp1 - (lc - 1) * pmm) / lc
        pmm, pmmp1 = pmmp1, P
        llp1 = lc * (lc + 1.0)
        lfacs2 = (lc + 2.0) * (lc - 1.0)
        lrootfacs = math.sqrt(llp1 * lfacs2)
        dP = lc * (pmm - x * P) / sin2
        d22 = (((4.0 * x - 8.0) / fac2 + llp1) * P
               + 4.0 * fac * (fac2 + (x - 2.0) / llp1) * dP) / lfacs2
        J40 = _jacobi_advance(lc - 2.0, 4.0, 0.0, x, j40m1, j40)
        j40m1, j40 = j40, J40
        d2m2 = sin2half ** 2 * J40
        d20 = (2.0 * x * dP - llp1 * P) / lrootfacs
        sums.append(torch.stack([(xi_t * P).sum(-1), (xi_p * d22).sum(-1),
                                 (xi_m * d2m2).sum(-1), (xi_x * d20).sum(-1)],
                                -1))
    return torch.stack(sums, 1)


def _passes_cuda(cl: torch.Tensor, th: torch.Tensor, nl_out: int
                 ) -> torch.Tensor:
    """csrc/lensing.cu: one thread per (chain, theta) runs all three l
    passes with the Legendre and Jacobi recurrences in registers and C_l
    tiles in shared memory; pass 3 reduces over theta per warp (shuffles,
    fixed order) into per-warp partials, and a second kernel sums the
    partials in warp order, so repeated runs agree bit for bit. It computes
    in float64 for float32 inputs too (see the source note: float32 loses
    the lensed TE and BB at high l) and stores in the input's type.

    Replaces cosmomc_tpu/models/lensing.py:lens_cls (the lax.scans at
    :136, :247 and :287). Bound: ~2657 l x 5315 theta x ~250 flops per
    chain for pass 2, compute-bound; the sequential l dependence lives
    inside each thread, the theta lanes fill the card."""
    C, _, L = cl.shape
    nth = th.shape[1]
    kernels.check(cl, "cl", (C, 4, L))
    kernels.check(th, "theta table", (N_TH, nth), torch.float64)
    if nl_out > L:
        raise ValueError(f"nl_out {nl_out} > L {L}")
    threads = 128
    n_warps = -(-nth // threads) * (threads // 32)
    partial = torch.empty(C, n_warps, nl_out, 4, dtype=torch.float64,
                          device=cl.device)
    sums = torch.empty(C, nl_out, 4, dtype=cl.dtype, device=cl.device)
    kernels.launch("lensing", cl.dtype, cl, th, partial, sums, C, L, nth,
                   nl_out, n_warps)
    return sums


def lens_cls(ls: torch.Tensor, tt: torch.Tensor, te: torch.Tensor,
             ee: torch.Tensor, pp: torch.Tensor, lmax_lensed: int | None = None,
             n_theta: int | None = None, apodize: bool = True) -> LensedCls:
    """Lensed TT/TE/EE/BB from unlensed spectra + lensing potential, for
    every chain; ls is the dense range 2..lmax."""
    dtype, dev = tt.dtype, tt.device
    lmax = int(ls.shape[0]) + 1
    if lmax_lensed is None:
        lmax_lensed = lmax - 250
    if n_theta is None:
        n_theta = 2 * lmax
    nl_out = lmax_lensed - 1

    lf = ls.to(dtype)
    llp1 = lf * (lf + 1.0)
    two_l1_4pi = (2.0 * lf + 1.0) / (4.0 * torch.pi)
    conv = 2.0 * torch.pi / llp1
    cl = torch.stack([tt * conv * two_l1_4pi, te * conv * two_l1_4pi,
                      ee * conv * two_l1_4pi,
                      pp * (2.0 * torch.pi / llp1 ** 2) * llp1 * two_l1_4pi],
                     1).contiguous()

    # the theta table in float64 (1 - cos(theta) at the first nodes is
    # ~1e-7); the plain version reads it in the spectra's dtype
    dtheta = np.pi / n_theta
    theta = torch.arange(1, n_theta, dtype=torch.float64, device=dev) * dtheta
    x = torch.cos(theta)
    sinth = torch.sin(theta)
    if apodize:
        i = torch.arange(1, n_theta, dtype=torch.float64, device=dev)
        wid = max(int(0.003 / dtheta), 1)
        tail = torch.exp(-torch.clamp(i - (n_theta - 3.0 * wid), min=0.0) ** 2
                         / (2.0 * wid ** 2))
    else:
        tail = torch.ones_like(x)
    th = torch.stack([x, sinth, sinth ** 2, 1.0 - x, 1.0 + x, tail,
                      sinth * dtheta]).contiguous()
    passes = _passes_plain if dev.type == "cpu" else _passes_cuda
    s = passes(cl, th, nl_out)
    dctt = 2.0 * torch.pi * s[..., 0]
    dcee = 2.0 * torch.pi * 0.5 * (s[..., 1] + s[..., 2])
    dcbb = 2.0 * torch.pi * 0.5 * (s[..., 1] - s[..., 2])
    dcte = 2.0 * torch.pi * s[..., 3]
    lo = ls[:nl_out].to(dtype)
    back = lo * (lo + 1.0) / (2.0 * torch.pi)
    return LensedCls(ls[:nl_out], tt[:, :nl_out] + back * dctt,
                     te[:, :nl_out] + back * dcte, ee[:, :nl_out] + back * dcee,
                     back * dcbb)
