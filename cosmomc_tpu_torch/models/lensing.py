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

The kernel splits l into segments of SEG multipoles and starts each from
recurrence seeds (P_{l-2}, P_{l-1} and the three Jacobi pairs, per theta)
and reads every l-only constant from a per-l table; both are built here
once per (L, n_theta) in float64 by the plain recurrences and formulas.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels

# rows of the theta table handed to both paths
TH_X, TH_SIN, TH_SIN2, TH_FAC1, TH_FAC2, TH_TAIL, TH_SW = range(7)
N_TH = 7

SEG = 64            # multipoles per recurrence segment (csrc/lensing.cu SEG)
THETA_SPLITS = 6    # pass 3: theta ranges summed separately, then in order
#: seed rows per (segment, theta): the recurrence state before its first l
SEED_ROWS = ("pmm", "pmmp1", "j40m1", "j40", "j44m1", "j44", "j80m1", "j80")
#: the Jacobi families (a, b, n = l - shift) of the high-spin Wigner-d's
JACOBI = (("j40", 4.0, 0.0, 2), ("j44", 4.0, 4.0, 4), ("j80", 8.0, 0.0, 4))
#: columns of the per-l table (csrc/lensing.cu enum LC_*); for each Jacobi
#: family c2, c3, c4 and 1/c1 of its upward recurrence at n = l - shift
L_COLS = ("l", "inv_l", "two_lm1", "lm1", "llp1", "inv_llp1", "lfacs2",
          "inv_lfacs2", "inv_lrootfacs", "rf1", "inv_rf1", "rf2", "inv_rf2",
          "inv_rf3", "norm04", "inv_sqrt_llp1", "x220", "x121", "x132",
          "x242", "dx000", "dx022", "c8") + tuple(
              f"{name}_{c}" for name, *_ in JACOBI
              for c in ("c2", "c3", "c4", "ic1"))


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


def theta_table(n_theta: int, apodize: bool, device) -> torch.Tensor:
    """(N_TH, n_theta - 1) float64 rows x, sin, sin^2, 1 - x, 1 + x, the
    apodizing tail and sin(theta) dtheta at theta_i = i pi / n_theta. Built
    on the CPU and copied, so the kernel's seeds (built from the same x)
    and its theta nodes are the same numbers on every device; one cached
    tensor per (n_theta, apodize, device). 1 - cos at the first nodes is
    ~1e-7, hence float64; the plain version reads the table in the
    spectra's dtype."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _theta_table(n_theta, bool(apodize), str(dev))


@lru_cache(maxsize=8)
def _theta_table(n_theta: int, apodize: bool, device: str) -> torch.Tensor:
    dtheta = np.pi / n_theta
    i = torch.arange(1, n_theta, dtype=torch.float64)
    theta = i * dtheta
    x = torch.cos(theta)
    sinth = torch.sin(theta)
    if apodize:
        wid = max(int(0.003 / dtheta), 1)
        tail = torch.exp(-torch.clamp(i - (n_theta - 3.0 * wid), min=0.0) ** 2
                         / (2.0 * wid ** 2))
    else:
        tail = torch.ones_like(x)
    return torch.stack([x, sinth, sinth ** 2, 1.0 - x, 1.0 + x, tail,
                        sinth * dtheta]).contiguous().to(device)


@lru_cache(maxsize=4)
def l_table(L: int) -> np.ndarray:
    """(L, len(L_COLS)) float64: every quantity of passes 1-3 that depends
    on l alone, for l = 2..L+1, by the plain version's formulas; the
    kernel multiplies by the reciprocals where the plain version divides.
    A column is 0 at the l where the plain version does not use it (rf2
    below l = 3; rf3 and norm04 below l = 4; a Jacobi family below n = 2,
    where the kernel takes the closed forms)."""
    lc = np.arange(L, dtype=np.float64) + 2.0
    llp1 = lc * (lc + 1.0)
    lfacs2 = (lc + 2.0) * (lc - 1.0)
    lroot = np.sqrt(llp1 * lfacs2)
    rf1 = np.sqrt(lfacs2)
    rf2 = np.sqrt((lc + 3.0) * (lc - 2.0))
    rf3 = np.sqrt(np.maximum((lc - 3.0) * (lc + 4.0), 0.0))
    s4 = lc - 4.0
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = lambda v: np.where(v > 0.0, 1.0 / v, 0.0)
        norm04 = np.where(lc >= 4.0, np.sqrt(
            ((s4 + 5.0) * (s4 + 6.0) * (s4 + 7.0) * (s4 + 8.0))
            / ((s4 + 1.0) * (s4 + 2.0) * (s4 + 3.0) * (s4 + 4.0))), 0.0)
        cols = dict(l=lc, inv_l=1.0 / lc, two_lm1=2 * lc - 1, lm1=lc - 1,
                    llp1=llp1, inv_llp1=1.0 / llp1, lfacs2=lfacs2,
                    inv_lfacs2=1.0 / lfacs2, inv_lrootfacs=1.0 / lroot,
                    rf1=rf1, inv_rf1=1.0 / rf1, rf2=rf2, inv_rf2=inv(rf2),
                    inv_rf3=inv(rf3), norm04=norm04,
                    inv_sqrt_llp1=1.0 / np.sqrt(llp1), x220=lroot / 4.0,
                    x121=-0.5 * rf1, x132=-0.5 * rf2, x242=0.25 * rf2 * rf3,
                    dx000=-llp1 / 4.0, dx022=1.0 - llp1 / 4.0, c8=8.0 / llp1)
        for name, a, b, shift in JACOBI:
            n, apb = lc - shift, a + b
            use = n >= 2.0
            c1 = 2.0 * n * (n + apb) * (2.0 * n + apb - 2.0)
            cols[f"{name}_c2"] = np.where(use, (2.0 * n + apb - 1.0)
                                          * (a * a - b * b), 0.0)
            cols[f"{name}_c3"] = np.where(use, (2.0 * n + apb - 1.0)
                                          * (2.0 * n + apb)
                                          * (2.0 * n + apb - 2.0), 0.0)
            cols[f"{name}_c4"] = np.where(use, 2.0 * (n + a - 1.0)
                                          * (n + b - 1.0) * (2.0 * n + apb),
                                          0.0)
            cols[f"{name}_ic1"] = np.where(use, inv(c1), 0.0)
    return np.ascontiguousarray(np.stack([cols[c] for c in L_COLS], 1))


@lru_cache(maxsize=4)
def recurrence_seeds(L: int, n_theta: int) -> torch.Tensor:
    """(ceil(L / SEG), len(SEED_ROWS), n_theta - 1) float64 on the CPU: the
    state of the plain version's Legendre and Jacobi recurrences just
    before l index s * SEG, for every segment s, at the nodes of
    theta_table(n_theta, ...). Run by the plain version's own expressions,
    so a segment started from its seed continues the uninterrupted run."""
    x = theta_table(n_theta, False, "cpu")[TH_X]
    zeros = torch.zeros_like(x)
    pmm, pmmp1 = torch.ones_like(x), x
    jac = [(zeros, zeros) for _ in JACOBI]
    out = torch.empty(-(-L // SEG), len(SEED_ROWS), x.shape[0],
                      dtype=torch.float64)
    for il in range(L):
        if il % SEG == 0:
            out[il // SEG] = torch.stack([pmm, pmmp1] + [v for j in jac for v in j])
        lc = float(il + 2)
        P = ((2 * lc - 1) * x * pmmp1 - (lc - 1) * pmm) / lc
        pmm, pmmp1 = pmmp1, P
        jac = [(j[1], _jacobi_advance(lc - shift, a, b, x, *j))
               for j, (_, a, b, shift) in zip(jac, JACOBI)]
    return out


@lru_cache(maxsize=4)
def _kernel_tables(L: int, n_theta: int, device: str):
    return (torch.as_tensor(l_table(L), device=device),
            recurrence_seeds(L, n_theta).to(device))


def _passes_grid_plain(cl: torch.Tensor, n_theta: int, apodize: bool,
                       nl_out: int) -> torch.Tensor:
    """_passes_plain on theta_table(n_theta, apodize): the CPU's path, and
    the kernel's twin with the same signature."""
    return _passes_plain(cl, theta_table(n_theta, apodize, cl.device), nl_out)


def _passes_cuda(cl: torch.Tensor, n_theta: int, apodize: bool, nl_out: int
                 ) -> torch.Tensor:
    """csrc/lensing.cu, six launches on the stream: passes 1 and 2 give a
    thread one theta and one l segment (~14 segments, each started from
    its recurrence seeds) and do the chain-independent Legendre, Jacobi
    and Wigner-d work once for a register tile of 4 chains; a reduction
    after each adds the segments' partial sums in segment order. Pass 3
    generates P, d22, d2m2, d20 for 128 theta x 16 l in shared memory and
    contracts them with 8 chains' xi over theta on the FP64 tensor cores
    (mma.sync m8n8k4); its 6 theta ranges are added in order at the end.
    No atomics, so repeated runs agree bit for bit. It computes in float64
    for float32 inputs too (see the source note: float32 loses the lensed
    TE and BB at high l) and stores in the input's type. The theta nodes
    and the seeds both come from (n_theta, apodize), so they agree.

    Replaces cosmomc_tpu/models/lensing.py:lens_cls (the lax.scans at
    :136, :247 and :287); the bound and the design are in the source.

    Raises NotImplementedError when asked for a gradient: the kernel has
    no reverse pass, so the lensing deltas would carry none, silently."""
    if torch.is_grad_enabled() and cl.requires_grad:
        raise NotImplementedError(
            "lens_cls has no gradient on the card yet (K3's reverse pass is "
            "ROADMAP.md queue 1 item 4); the plain version on CPU tensors "
            "has one")
    C, _, L = cl.shape
    kernels.check(cl, "cl", (C, 4, L))
    if nl_out > L:
        raise ValueError(f"nl_out {nl_out} > L {L}")
    th = theta_table(n_theta, apodize, cl.device)
    nth = n_theta - 1
    lt, seeds = _kernel_tables(L, n_theta, str(th.device))
    seg12 = SEG * max(1, round(seeds.shape[0] / 14))
    nseg = -(-L // seg12)
    f64 = dict(dtype=torch.float64, device=cl.device)
    part1 = torch.empty(nseg, 2, C, nth, **f64)
    sgcg = torch.empty(2, C, nth, **f64)
    part2 = torch.empty(nseg, C, 4, nth, **f64)
    xi = torch.empty(4, nth, C, **f64)
    part3 = torch.empty(THETA_SPLITS, C, nl_out, 4, **f64)
    sums = torch.empty(C, nl_out, 4, dtype=cl.dtype, device=cl.device)
    kernels.launch("lensing", cl.dtype, cl, th, lt, seeds, part1, sgcg, part2,
                   xi, part3, sums, C, L, nth, nl_out, seg12, THETA_SPLITS)
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

    passes = _passes_grid_plain if dev.type == "cpu" else _passes_cuda
    s = passes(cl, n_theta, apodize, nl_out)
    dctt = 2.0 * torch.pi * s[..., 0]
    dcee = 2.0 * torch.pi * 0.5 * (s[..., 1] + s[..., 2])
    dcbb = 2.0 * torch.pi * 0.5 * (s[..., 1] - s[..., 2])
    dcte = 2.0 * torch.pi * s[..., 3]
    lo = ls[:nl_out].to(dtype)
    back = lo * (lo + 1.0) / (2.0 * torch.pi)
    return LensedCls(ls[:nl_out], tt[:, :nl_out] + back * dctt,
                     te[:, :nl_out] + back * dcte, ee[:, :nl_out] + back * dcee,
                     back * dcbb)
