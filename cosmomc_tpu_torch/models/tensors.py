"""Tensor modes: evolution (kernel K5) and line-of-sight transfers (K6).

Port of cosmomc_tpu/models/tensors.py (camb/equations.f90 tensor
evolution, cmbmain.f90 tensor transfers, power_tilt.f90 TensorPower).
Per comoving wavenumber k, one polarization (Seljak & Zaldarriaga 1996/97):

  metric      h'' + 2(a'/a) h' + k^2 h = (16/3)(grho_g pi_g + grho_nu pi_nu)
  photons     Dt' + i k mu Dt = -h' - kappa'(Dt - Psi)
              Dp' + i k mu Dp =       -kappa'(Dp + Psi)
  neutrinos   Dn' + i k mu Dn = -h'
  Psi = Dt0/10 + Dt2/7 + 3 Dt4/70 - 3 Dp0/5 + 6 Dp2/7 - 3 Dp4/70

with tight coupling slaving Psi to -h'/(3 kappa') while
opac (1 + R) > TC_LAM_MAX, the hierarchies frozen past k tau = 240, and
lanes held on h = 1 until k tau >= 0.05. Line of sight (ZS97 tensor
radial functions):

  DT_l(k) = sqrt((l+2)!/(l-2)!) int dtau [-h' e^-kappa + g Psi] j_l(x)/x^2
  DE_l(k) = int dtau g Psi [ -j_l + j_l'' + 2 j_l/x^2 + 4 j_l'/x ]
  DB_l(k) = int dtau g Psi [ 2 j_l' + 4 j_l/x ]
  C_l^X   = (1/16) 4 pi int dlnk P_T(k) |DX_l|^2

Everything carries a leading chains axis. `evolve_tensors` runs either
`_evolve_t_plain` (batched torch) or csrc/tensors.cu (K5);
`compute_tensor_transfers` runs `_tlos_plain` or csrc/tensor_los.cu (K6).
CPU tensors take the plain versions; CUDA tensors launch the kernels.
Both are differentiable, as JAX's are under jax.grad: on the CPU by
autograd of the plain versions (their graphs rematerialized in chunks,
utils/remat.py), on the card by the reverse kernels `tensors_bwd` and
`tensor_los_bwd` (`_Tensors`, `_TensorLos`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.bessel import build_bessel_table, default_l_samples
from cosmomc_tpu_torch.models.cls import LOS_KT, fine_k_grid, transposed_stencil
from cosmomc_tpu_torch.models.perturbations import (DEFAULT_REMAT_CHUNKS,
                                                    TC_LAM_MAX, ThermoFuncs,
                                                    grho_terms)
from cosmomc_tpu_torch.models.primordial import PrimordialParams, tensor_power
from cosmomc_tpu_torch.utils.interp import interp, spline_eval, spline_fit
from cosmomc_tpu_torch.utils.remat import remat

# hierarchy truncations (photon temperature / polarization / neutrinos)
LMAXT = 16
LMAXTP = 8
LMAXTN = 16

# state layout
_I_HT = 0                        # tensor amplitude h
_I_HTP = 1                       # h'
_I_DT0 = 2                       # photon intensity Dt_0..Dt_LMAXT
_I_DP0 = _I_DT0 + (LMAXT + 1)    # photon polarization Dp_0..Dp_LMAXTP
_I_DN0 = _I_DP0 + (LMAXTP + 1)   # neutrino Dn_0..Dn_LMAXTN
NVAR_T = _I_DN0 + (LMAXTN + 1)

RSA_KTAU_T = 240.0               # hierarchies frozen past k tau = 240
RELEASE_KTAU_T = 0.05            # lanes held on h = 1 below k tau = 0.05

# fields of the tensor stage table (chains, steps, rows, NQT)
QT_TAU, QT_OPAC, QT_GG, QT_GN, QT_ADOTOA, QT_TC, QT_VIS, QT_EXPMK = range(8)
NQT = 8
# output planes of the evolution
T_PLANES = ("sT", "sP", "ht")


class TensorOutput(NamedTuple):
    tau: torch.Tensor      # (C, N)
    k: torch.Tensor        # (nk,)
    sT: torch.Tensor       # (C, nk, N)  -h' e^-kappa + g Psi
    sP: torch.Tensor       # (C, nk, N)  g Psi
    tau0: torch.Tensor     # (C,)
    ht: torch.Tensor = None   # (C, nk, N) metric amplitude


class TensorSpectra(NamedTuple):
    """l(l+1)C_l/2pi, dimensionless (x (T0*1e6)^2 for muK^2), each (C, L)."""
    ls: torch.Tensor
    tt: torch.Tensor
    te: torch.Tensor
    ee: torch.Tensor
    bb: torch.Tensor


class TensorTransferCache(NamedTuple):
    """Tensor Delta^X_l(k): the primordial-independent slow cache."""
    ls: torch.Tensor       # (nl,)
    kf: torch.Tensor       # (nkf,)
    wk: torch.Tensor       # (nkf,) dlnk trapezoid weights
    dT: torch.Tensor       # (C, nl, nkf)
    dE: torch.Tensor
    dB: torch.Tensor


def tensor_k_grid(kmax: float = 0.065, nk: int = 96,
                  kmin: float = 3e-5) -> np.ndarray:
    """Coarse k grid for tensor sources (BB support is l <~ 700)."""
    return np.exp(np.linspace(np.log(kmin), np.log(kmax), nk))


def _stage_inputs(bg: BackgroundParams, tf: ThermoFuncs,
                  ts: torch.Tensor) -> torch.Tensor:
    """Every k-independent RHS input at times ts (C, M): (C, M, NQT). The
    tight-coupling flag is decided here, once, for kernel and plain alike."""
    a = interp(ts, tf.tau, tf.a)
    opac = interp(ts, tf.tau, tf.opac)
    grho_g, grho_n, grho_num, _gp, grho_c, grho_b, grho_de, grho_k = \
        grho_terms(bg, a)
    grho = grho_g + grho_n + grho_num + grho_c + grho_b + grho_de
    adotoa = torch.sqrt((grho + grho_k) / 3.0)
    R_bg = (4.0 / 3.0) * grho_g / grho_b
    tc_on = opac * (1.0 + R_bg) > TC_LAM_MAX
    return torch.stack([ts, opac, grho_g, grho_n, adotoa, tc_on.to(ts.dtype),
                        interp(ts, tf.tau, tf.vis), interp(ts, tf.tau, tf.expmk)],
                       -1)


def _stage_table(bg: BackgroundParams, tf: ThermoFuncs,
                 substeps: int) -> torch.Tensor:
    """(C, N-1, 3 substeps + 1, NQT): per step, the three RK4 stage times
    of each substep (jnp arithmetic of the JAX step: tau_a + f (tau_b -
    tau_a)), then tau_b itself, where the sources are read."""
    ta, tb = tf.tau[:, :-1], tf.tau[:, 1:]
    d = tb - ta
    rows = []
    for s in range(substeps):
        a_s = ta + (s / substeps) * d
        b_s = ta + ((s + 1) / substeps) * d
        rows += [a_s, a_s + 0.5 * (b_s - a_s), b_s]
    rows.append(tb)
    ts = torch.stack(rows, -1)                         # (C, N-1, R)
    C, S, R = ts.shape
    return _stage_inputs(bg, tf, ts.reshape(C, S * R)).reshape(
        C, S, R, NQT).contiguous()


def _tensor_rhs(y: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                feedback: bool):
    """dy/dtau for y (C, nk, NVAR_T) at one stage, q (C, NQT); returns
    (dy, psi) with psi (C, nk) zero past the freeze."""
    Q = lambda f: q[:, f:f + 1]
    tau, opac, grho_g, grho_n, adotoa = (Q(QT_TAU), Q(QT_OPAC), Q(QT_GG),
                                         Q(QT_GN), Q(QT_ADOTOA))
    tc_on = Q(QT_TC) > 0.5                              # (C, 1)
    ht, htp = y[..., _I_HT], y[..., _I_HTP]
    dt = y[..., _I_DT0:_I_DP0]
    dp = y[..., _I_DP0:_I_DN0]
    dn = y[..., _I_DN0:NVAR_T]
    tau_safe = torch.clamp(tau, min=1e-10)
    psi_tca = -htp / (3.0 * torch.clamp(opac, min=1e-30))
    psi_full = (dt[..., 0] / 10.0 + dt[..., 2] / 7.0 + 3.0 * dt[..., 4] / 70.0
                - 3.0 * dp[..., 0] / 5.0 + 6.0 * dp[..., 2] / 7.0
                - 3.0 * dp[..., 4] / 70.0)
    psi = torch.where(tc_on, psi_tca, psi_full)
    rsa = k * tau >= RSA_KTAU_T                          # (C, nk)
    zero = torch.zeros_like(psi)
    if feedback:
        pi_n = dn[..., 0] / 10.0 + dn[..., 2] / 7.0 + 3.0 * dn[..., 4] / 70.0
        pi_g = dt[..., 0] / 10.0 + dt[..., 2] / 7.0 + 3.0 * dt[..., 4] / 70.0
        pi_g = torch.where(tc_on, zero, pi_g)
        stress = torch.where(rsa, zero,
                             (16.0 / 3.0) * (grho_g * pi_g + grho_n * pi_n))
    else:
        stress = zero
    htpp = -2.0 * adotoa * htp - k * k * ht + stress

    kk = k[:, None]

    def ladder(D, lmax):
        ls = torch.arange(0, lmax + 1, dtype=y.dtype, device=y.device)
        prev = torch.cat([torch.zeros_like(D[..., :1]), D[..., :-1]], -1)
        nxt = torch.cat([D[..., 1:], torch.zeros_like(D[..., :1])], -1)
        return (kk / (2 * ls + 1)) * (ls * prev - (ls + 1) * nxt)

    op = opac[..., None]
    dtdot = ladder(dt, LMAXT) - op * dt
    dt0 = dtdot[..., 0] + (-htp + opac * psi)
    dtl = k * dt[..., -2] - (LMAXT + 1) / tau_safe * dt[..., -1] \
        - opac * dt[..., -1]
    dtdot = torch.cat([dt0[..., None], dtdot[..., 1:-1], dtl[..., None]], -1)
    dpdot = ladder(dp, LMAXTP) - op * dp
    dp0 = dpdot[..., 0] + (-opac * psi)
    dpl = k * dp[..., -2] - (LMAXTP + 1) / tau_safe * dp[..., -1] \
        - opac * dp[..., -1]
    dpdot = torch.cat([dp0[..., None], dpdot[..., 1:-1], dpl[..., None]], -1)
    frozen = (tc_on | rsa)[..., None]
    dtdot = torch.where(frozen, 0.0, dtdot)
    dpdot = torch.where(frozen, 0.0, dpdot)
    dndot = ladder(dn, LMAXTN)
    dn0 = dndot[..., 0] + (-htp)
    dnl = k * dn[..., -2] - (LMAXTN + 1) / tau_safe * dn[..., -1]
    dndot = torch.cat([dn0[..., None], dndot[..., 1:-1], dnl[..., None]], -1)
    dndot = torch.where(rsa[..., None], 0.0, dndot)
    dy = torch.cat([htp[..., None], htpp[..., None], dtdot, dpdot, dndot], -1)
    return dy, torch.where(rsa, zero, psi)


def make_tensor_rhs(bg: BackgroundParams, tf: ThermoFuncs,
                    anisotropic_feedback: bool = True):
    """rhs(tau (C,), y (C, nk, NVAR_T), k (nk,)) -> (dy, psi)."""
    def rhs(tau, y, k):
        q = _stage_inputs(bg, tf, tau[:, None])[:, 0]
        return _tensor_rhs(y, q, k, anisotropic_feedback)
    return rhs


def _initial_state(C: int, nk: int, dtype, device) -> torch.Tensor:
    y0 = torch.zeros(C, nk, NVAR_T, dtype=dtype, device=device)
    y0[..., _I_HT] = 1.0
    return y0


def _t_step(y, y0, i, qtab, k, substeps: int, feedback: bool):
    """Step i of `_evolve_t_plain` from y (C, nk, NVAR_T): the new state
    (y0 where the lane is not yet released at tau_b) and the three planes
    at tau_b, (3, C, nk). csrc/tensors.cu's `tensors_bwd` transposes it."""
    for s in range(substeps):
        qa, qm, qb = (qtab[:, i, 3 * s], qtab[:, i, 3 * s + 1],
                      qtab[:, i, 3 * s + 2])
        dt = (qb[:, QT_TAU] - qa[:, QT_TAU])[:, None, None]
        k1, _ = _tensor_rhs(y, qa, k, feedback)
        k2, _ = _tensor_rhs(y + 0.5 * dt * k1, qm, k, feedback)
        k3, _ = _tensor_rhs(y + 0.5 * dt * k2, qm, k, feedback)
        k4, _ = _tensor_rhs(y + dt * k3, qb, k, feedback)
        y = y + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    qf = qtab[:, i, 3 * substeps]
    released = k * qf[:, QT_TAU:QT_TAU + 1] >= RELEASE_KTAU_T
    y = torch.where(released[..., None], y, y0)
    _, psi = _tensor_rhs(y, qf, k, feedback)
    vis, expmk = qf[:, QT_VIS:QT_VIS + 1], qf[:, QT_EXPMK:QT_EXPMK + 1]
    return y, torch.stack([-y[..., _I_HTP] * expmk + vis * psi, vis * psi,
                           y[..., _I_HT]])


def _evolve_t_plain(qtab: torch.Tensor, k: torch.Tensor, substeps: int,
                    feedback: bool, remat_chunks: int = 0) -> torch.Tensor:
    """RK4 over the grid as batched torch; returns (3, C, N-1, nk).

    Records a graph when grad is enabled and qtab wants one (jax.grad
    differentiates JAX's scan); otherwise runs under no_grad. With
    `remat_chunks` > 0 the graph is checkpointed as
    perturbations._evolve_plain's: the steps fall into that many chunks of
    ceil((N-1)/remat_chunks) steps, only each chunk's starting state is
    kept and its interior is recomputed in the backward pass
    (utils/remat.py); the numbers do not depend on the chunk count."""
    C, S = qtab.shape[0], qtab.shape[1]
    y0 = _initial_state(C, k.shape[0], qtab.dtype, qtab.device)

    def run(y, lo, hi, qtab):
        outs = []
        for i in range(lo, hi):
            y, o = _t_step(y, y0, i, qtab, k, substeps, feedback)
            outs.append(o)
        return y, torch.stack(outs, 2)

    if not (torch.is_grad_enabled() and qtab.requires_grad):
        with torch.no_grad():
            return run(y0, 0, S, qtab)[1]
    if remat_chunks <= 0:
        return run(y0, 0, S, qtab)[1]
    chunk = -(-S // remat_chunks)
    y, outs = y0, []
    for lo in range(0, S, chunk):
        y, o = remat(run, y, lo, min(lo + chunk, S), qtab)
        outs.append(o)
    return torch.cat(outs, 2)


def _evolve_t_launch(qtab: torch.Tensor, k: torch.Tensor, substeps: int,
                     feedback: bool, chunk: int = 0):
    """The forward kernel: the planes (3, C, S, nk) and, with `chunk` > 0,
    the checkpoints (C, nk, ceil(S / chunk) + 1, NVAR_T): the state before
    every chunk-th step and after the last, in the plain layout."""
    C, S, R = qtab.shape[0], qtab.shape[1], qtab.shape[2]
    nk = k.shape[0]
    if R != 3 * substeps + 1:
        raise ValueError(f"stage table has {R} rows, not 3*{substeps}+1")
    kernels.check(qtab, "qtab", (C, S, R, NQT))
    kernels.check(k, "k", (nk,), qtab.dtype)
    out = torch.empty(len(T_PLANES), C, S, nk, dtype=qtab.dtype,
                      device=qtab.device)
    if chunk <= 0:
        kernels.launch("tensors", qtab.dtype, qtab, k, out, C, S, nk, substeps,
                       bool(feedback))
        return out, None
    ck = torch.empty(C, nk, -(-S // chunk) + 1, NVAR_T, dtype=qtab.dtype,
                     device=qtab.device)
    kernels.launch("tensors", qtab.dtype, qtab, k, out, ck, C, S, nk, substeps,
                   bool(feedback), chunk, entry="tensors_ck")
    return out, ck


#: k lanes (warps) a block of the reverse kernel (csrc/tensors.cu WARPS)
T_BWD_WARPS = 8


def _tensors_bwd(qtab, k, ck, g_out, substeps: int, feedback: bool,
                 chunk: int) -> torch.Tensor:
    """csrc/tensors.cu's reverse kernel: the cotangent of qtab (C, S, 3
    substeps + 1, NQT) from that of the planes (3, C, S, nk), as
    `_evolve_t_plain` under autograd gives it. A warp a (chain, k) lane in
    the forward's layout, the chunks in reverse, each recomputed from its
    checkpoint into a per-lane scratch; each block adds its 8 lanes' row
    cotangents in order and the blocks are added here in order."""
    C, S, R = qtab.shape[0], qtab.shape[1], qtab.shape[2]
    nk = k.shape[0]
    dev, dt = qtab.device, qtab.dtype
    g_out = g_out.contiguous()
    kernels.check(g_out, "g_out", (len(T_PLANES), C, S, nk), dt)
    kernels.check(ck, "checkpoints", (C, nk, -(-S // chunk) + 1, NVAR_T), dt)
    nblk = -(-nk // T_BWD_WARPS)
    scratch = torch.empty(C, nblk * T_BWD_WARPS, chunk * substeps + 1, NVAR_T,
                          dtype=dt, device=dev)
    g_q = torch.empty(C, nblk, S, R, NQT, dtype=dt, device=dev)
    kernels.launch("tensors_bwd", dt, qtab, k, ck, g_out, scratch, g_q, C, S,
                   nk, substeps, bool(feedback), chunk)
    return g_q[:, 0] if nblk == 1 else g_q.sum(1)


class _Tensors(torch.autograd.Function):
    """K5 on the card with its reverse kernel: the forward kernel also
    writes the chunk checkpoints (`tensors_ck`), the backward launches
    `tensors_bwd`."""

    @staticmethod
    def forward(ctx, qtab, k, substeps, feedback, chunks):
        chunk = -(-qtab.shape[1] // chunks)
        out, ck = _evolve_t_launch(qtab, k, substeps, feedback, chunk)
        ctx.save_for_backward(qtab, k, ck)
        ctx.substeps, ctx.feedback, ctx.chunk = substeps, feedback, chunk
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        qtab, k, ck = ctx.saved_tensors
        return (_tensors_bwd(qtab, k, ck, g_out, ctx.substeps, ctx.feedback,
                             ctx.chunk), None, None, None, None)


def _evolve_t_cuda(qtab: torch.Tensor, k: torch.Tensor, substeps: int,
                   feedback: bool, remat_chunks: int = 0) -> torch.Tensor:
    """csrc/tensors.cu: one warp per (chain, k) lane, blocks of 8 lanes of
    one chain; h, h' on every thread, Dt_l and Dn_l on thread l, Dp_l on
    thread 17 + l, neighbours by warp shuffles; stage rows staged in shared
    memory a tile of steps ahead; the source evaluation at tau_b reused as
    the next step's first where the rows repeat.

    Replaces cosmomc_tpu/models/tensors.py:evolve_tensors (the lax.scan at
    tensors.py:254 over make_tensor_rhs and rk4_step). Bound: 4 RHS
    evaluations a step (~300 flops each) over ~8191 dependent steps: the
    dependency chain of a lane. Outputs go to (plane, chain, step, k).

    When qtab wants a gradient (and grad is enabled) it runs as `_Tensors`:
    the forward stores the state at `remat_chunks` chunk boundaries
    (DEFAULT_REMAT_CHUNKS when 0) and the backward is `_tensors_bwd`."""
    if torch.is_grad_enabled() and qtab.requires_grad:
        return _Tensors.apply(qtab, k, substeps, bool(feedback),
                              remat_chunks or DEFAULT_REMAT_CHUNKS)
    return _evolve_t_launch(qtab, k, substeps, feedback)[0]


def evolve_tensors(bg: BackgroundParams, tf: ThermoFuncs, tau0: torch.Tensor,
                   k, anisotropic_feedback: bool = True,
                   substeps: int = 1, remat_chunks: int = 0) -> TensorOutput:
    """Evolve every tensor k lane of every chain on the shared tau grid and
    emit the LOS sources. ICs: h = 1, h' = 0, the hierarchies zero; a lane
    is held there until k tau >= 0.05. `substeps` sub-cycles each grid step
    (RK4 stability needs k dt / substeps <~ 2.8; 1 suffices for the
    production tensor grid, kmax 0.065). `remat_chunks`: the checkpoint
    count of the evolution's gradient (0 keeps every step on the CPU and
    takes DEFAULT_REMAT_CHUNKS on the card); it changes memory, not
    numbers."""
    dtype, dev = tf.tau.dtype, tf.tau.device
    k = torch.as_tensor(np.asarray(k) if not torch.is_tensor(k) else k,
                        dtype=dtype, device=dev).contiguous()
    qtab = _stage_table(bg, tf, substeps)
    evolve = _evolve_t_plain if dev.type == "cpu" else _evolve_t_cuda
    raw = evolve(qtab, k, substeps, anisotropic_feedback,
                 remat_chunks)                              # (3, C, N-1, nk)
    C, nk = tf.tau.shape[0], k.shape[0]
    first = torch.zeros(3, C, 1, nk, dtype=dtype, device=dev)
    first[2] = 1.0
    planes = torch.cat([first, raw], 2).transpose(2, 3)      # (3, C, nk, N)
    return TensorOutput(tau=tf.tau, k=k, sT=planes[0], sP=planes[1], tau0=tau0,
                        ht=planes[2])


def _k_stencil(lnk: torch.Tensor, lnkf: torch.Tensor):
    """jnp.interp's bracket and weight from the coarse ln k onto the fine:
    f = S[lo] + w (S[hi] - S[lo]), held at the end values outside."""
    n = lnk.shape[0]
    i = torch.searchsorted(lnk, lnkf.contiguous(), right=True).clamp(1, n - 1)
    w = (lnkf - lnk[i - 1]) / (lnk[i] - lnk[i - 1])
    lo, hi = i - 1, i.clone()
    below, above = lnkf < lnk[0], lnkf > lnk[-1]
    lo = torch.where(below, 0, torch.where(above, n - 1, lo))
    hi = torch.where(below, 0, torch.where(above, n - 1, hi))
    w = torch.where(below | above, 0.0, w)
    return lo.to(torch.int32), hi.to(torch.int32), w


def _tlos_plain(src, lo, hi, w, kf, chi, wt, jl_tab, jlp_tab, ls, inv_dx,
                k_chunk: int = 64):
    """Batched torch tensor LOS: src (C, 2, nk, N) -> (3, C, nl, nkf).
    Under autograd (grad enabled and src, chi or wt wanting one) each k
    chunk is rematerialized as cls._los_plain's (utils/remat.py: its per-l
    intermediates are recomputed in the backward pass rather than kept);
    the numbers do not change."""
    nl, nx = jl_tab.shape
    dtype = src.dtype
    jl_t, jlp_t = jl_tab.to(dtype), jlp_tab.to(dtype)

    def chunk(k0, src, chi, wt):             # -> (3, C, nl, kc)
        sl = slice(k0, k0 + k_chunk)
        l_, h_, w_ = lo[sl].long(), hi[sl].long(), w[sl][:, None]

        def k_interp(S):                     # (C, nk, N) -> (C, kc, N)
            return S[:, l_] + w_ * (S[:, h_] - S[:, l_])
        STw = k_interp(src[:, 0]) * wt[:, None]
        SPw = k_interp(src[:, 1]) * wt[:, None]
        x = kf[sl][None, :, None] * chi[:, None, :]
        t = x * inv_dx
        i = t.to(torch.int64).clamp(0, nx - 2)
        f = t - i.to(dtype)
        xs = torch.clamp(x, min=1e-8)
        xs2 = xs * xs
        out_t, out_e, out_b = [], [], []
        for il in range(nl):
            l = ls[il]
            jl = jl_t[il][i] * (1 - f) + jl_t[il][i + 1] * f
            jp = jlp_t[il][i] * (1 - f) + jlp_t[il][i + 1] * f
            jpp = -2.0 * jp / xs + (l * (l + 1) / xs2 - 1.0) * jl
            efac = torch.sqrt(torch.clamp((l + 2) * (l + 1) * l * (l - 1),
                                          min=0.0))
            out_t.append(efac * torch.sum(STw * jl / xs2, -1))
            wE = -jl + jpp + 2.0 * jl / xs2 + 4.0 * jp / xs
            wB = 2.0 * jp + 4.0 * jl / xs
            out_e.append(torch.sum(SPw * wE, -1))
            out_b.append(torch.sum(SPw * wB, -1))
        return torch.stack([torch.stack(o, 1) for o in (out_t, out_e, out_b)])

    starts = range(0, kf.shape[0], k_chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (src, chi, wt)):
        return torch.cat([remat(lambda *a: (chunk(*a),), k0, src, chi, wt)[0]
                          for k0 in starts], -1)
    out = torch.empty(3, chi.shape[0], nl, kf.shape[0], dtype=dtype,
                      device=src.device)
    for k0 in starts:
        out[..., k0:k0 + k_chunk] = chunk(k0, src, chi, wt)
    return out


TLOS_KT = LOS_KT  # fine k a K6 work item and reverse block (csrc/tensor_los.cu KT)
TLOS_OCT = 8      # sampled l's an octet: one 128-byte table line (OCT)
TLOS_GROUP = 3    # octets a K6 work item, all held by each lane (GROUP)
TLOS_KW = 8       # fine k a warp (KQ x KLANE)


def first_live_index(jl: np.ndarray, jlp: np.ndarray) -> np.ndarray:
    """n0(l): per table row, the first index where j_l or j_l' is non-zero
    (the row's width if none is). Below it both rows are exactly 0, so a
    point with table index i, i + 1 < n0(l), adds exactly 0. Raises unless
    n0 does not decrease from row to row: csrc/tensor_los.cu takes the
    live l's of a node to be a prefix of the sorted l's."""
    nz = (jl != 0) | (jlp != 0)
    n0 = np.where(nz.any(1), nz.argmax(1), jl.shape[1]).astype(np.int32)
    if (np.diff(n0) < 0).any():
        raise ValueError("the first non-zero table index decreases in l")
    return n0


def pair_table(jl: np.ndarray, jlp: np.ndarray):
    """The table csrc/tensor_los.cu reads: pairs[i, slot] = (j_l(x_i),
    j_l'(x_i), j_l(x_{i+1}), j_l'(x_{i+1})), float32 (nx - 1, nslot, 4),
    the rows padded with zeros to nslot, a multiple of TLOS_OCT (an octet
    of l's at one index is one aligned 128-byte line); and n0 per slot
    (`first_live_index`; nx for a pad, which is never live)."""
    nl, nx = jl.shape
    nslot = -(-nl // TLOS_OCT) * TLOS_OCT
    pairs = np.zeros((nx - 1, nslot, 4), np.float32)
    for j, (a, b) in enumerate(((jl, 0), (jlp, 0), (jl, 1), (jlp, 1))):
        pairs[:, :nl, j] = a[:, b:nx - 1 + b].T
    n0 = np.full(nslot, nx, np.int32)
    n0[:nl] = first_live_index(jl, jlp)
    return pairs, n0


_TLOS_TABLES: dict = {}     # (l's, xmax, device) -> tables
_TLOS_BY_TABLE: dict = {}   # id(the device jl table) -> tables


def tlos_tables(ls: tuple, xmax: float, device) -> dict:
    """The Bessel tables of one l set on a device, built on the host and
    uploaded once per (l set, xmax, device): `jl`, `jlp` (float32 (nl, nx),
    what the plain version reads), `pairs` and `n0` (`pair_table`, what the
    kernel reads) and the grid step `dx`. `_tlos_cuda` finds the kernel's
    tables from the `jl` it is given."""
    key = (tuple(int(l) for l in ls), float(xmax), str(torch.device(device)))
    tabs = _TLOS_TABLES.get(key)
    if tabs is None:
        tab = build_bessel_table(key[0], key[1])
        pairs, n0 = pair_table(tab.jl, tab.jlp)
        up = lambda a: torch.as_tensor(a, device=device)
        tabs = dict(jl=up(tab.jl), jlp=up(tab.jlp), pairs=up(pairs), n0=up(n0),
                    dx=tab.dx)
        _TLOS_TABLES[key] = tabs
        _TLOS_BY_TABLE[id(tabs["jl"])] = tabs
    return tabs


@lru_cache(maxsize=8)
def _tlos_grid(lmax: int, tau0_hint: float, kmax_hint: float,
               points_per_osc: float, coarse_k: tuple, device: str,
               dtype: torch.dtype) -> dict:
    """The sampled l's, the fine k grid, its dlnk weights and the ln-k
    stencil from the coarse grid `coarse_k`, on a device, once; and the
    reverse kernel's scatter of the stencil (`transposed_stencil` of
    models/cls.py on the 2-point bracket: `blk_off`, `row_kb`, `rtot`, and
    `rspan`, the most coarse rows a block of TLOS_KT fine k touches)."""
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    kf = f(fine_k_grid(tau0_hint, kmax_hint, points_per_osc))
    lnkf = torch.log(kf)
    lo, hi, w = _k_stencil(torch.log(f(np.asarray(coarse_k))), lnkf)
    dlnk = lnkf[1:] - lnkf[:-1]
    wk = torch.cat([dlnk[:1] / 2, (dlnk[1:] + dlnk[:-1]) / 2, dlnk[-1:] / 2])
    lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()
    blk_off, row_kb = transposed_stencil(np.stack([lo_h, lo_h, hi_h, hi_h], 1),
                                         len(coarse_k))
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
    return dict(ls=f(default_l_samples(lmax)), kf=kf, wk=wk, lo=lo, hi=hi,
                w=w.contiguous(), blk_off=i32(blk_off), row_kb=i32(row_kb),
                rtot=int(blk_off[-1]), rspan=int(np.diff(blk_off).max()))


def tlos_lattice(chi: torch.Tensor, kf: torch.Tensor, n0: torch.Tensor,
                 nl: int, nx: int, inv_dx: float) -> dict:
    """The (chain, l, k, tau) points of a tensor LOS problem, counted from
    its inputs with the kernel's arithmetic (x = kf chi, i = clamp(int(x
    inv_dx), 0, nx - 2)): `lattice` all of them; `live` those with i + 1 >=
    n0(l) (elsewhere the point adds exactly 0); `walked` the points
    csrc/tensor_los.cu computes: 64 for each of the item's octets (8 l's x
    8 k, pads and k past the grid included) for each (chain, 8-k column of
    a work item, group of octets, node) where the group's first l is live
    at the column's largest k."""
    C, N = chi.shape
    nkf = kf.shape[0]
    n0l = n0[:nl].contiguous()
    noct = n0.shape[0] // TLOS_OCT
    first = n0[::TLOS_OCT * TLOS_GROUP].contiguous()     # each group's first l
    octs = torch.tensor([min(TLOS_GROUP, noct - g * TLOS_GROUP)
                         for g in range(first.shape[0])], device=kf.device)
    kw = TLOS_KW
    kmax_w = kf[torch.clamp(torch.arange(kw - 1, nkf + kw - 1, kw,
                                         device=kf.device), max=nkf - 1)]
    live = walked = 0
    for c in range(C):
        def index(k):
            x = k[:, None] * chi[c][None, :]
            return (x * inv_dx).to(torch.int64).clamp(0, nx - 2).contiguous()
        live += int(torch.searchsorted(n0l, index(kf) + 1, right=True).sum())
        groups = torch.searchsorted(first, index(kmax_w) + 1, right=True)
        walked += TLOS_OCT * kw * int(torch.cumsum(octs, 0)[groups - 1]
                                      .masked_fill(groups == 0, 0).sum())
    return dict(lattice=C * nl * nkf * N, live=live, walked=walked)


def _tlos_cuda(src, lo, hi, w, kf, chi, wt, jl_tab, jlp_tab, ls, inv_dx,
               k_chunk: int = 64):
    """csrc/tensor_los.cu: a block per work item (chain, 32 fine k, a group
    of 3 octets of sampled l's), low l's first; 8 lanes of one fine k hold
    8 consecutive l's and read one 128-byte line of the packed table
    (`pair_table`), each lane for one l of every octet of the group; per
    tile of tau nodes the block writes one record per (k, tau) to shared
    memory (table index and fraction, the sources interpolated in ln k and
    folded into six coefficients with j_l''), and skips, with the same
    bits, the nodes where every point a warp would compute is dead (i + 1 <
    n0(l)). `jl_tab` and `jlp_tab` must be the tables of `tlos_tables`,
    whose packed form and n0 the kernel reads (no table is uploaded here).

    Replaces cosmomc_tpu/models/tensors.py:compute_tensor_transfers (the
    lax.map over l at tensors.py:352); the bound and the design are in the
    source. Each output has one owner, summed over tau in order; no
    atomics."""
    del k_chunk
    tabs = _TLOS_BY_TABLE.get(id(jl_tab))
    if tabs is None or tabs["jl"] is not jl_tab or tabs["jlp"] is not jlp_tab:
        raise ValueError("jl_tab and jlp_tab must be the tables of tlos_tables(): "
                         "the kernel reads their packed form")
    C, _, nk, N = src.shape
    nl, nx = jl_tab.shape
    nkf = kf.shape[0]
    nslot = tabs["pairs"].shape[1]
    dtype = src.dtype
    kernels.check(src, "sources", (C, 2, nk, N))
    kernels.check(lo, "k_lo", (nkf,), torch.int32)
    kernels.check(hi, "k_hi", (nkf,), torch.int32)
    for name, t in (("k_w", w), ("kf", kf)):
        kernels.check(t, name, (nkf,), dtype)
    for name, t in (("chi", chi), ("wt", wt)):
        kernels.check(t, name, (C, N), dtype)
    kernels.check(tabs["pairs"], "pair table", (nx - 1, nslot, 4), torch.float32)
    kernels.check(tabs["n0"], "n0", (nslot,), torch.int32)
    kernels.check(ls, "ls", (nl,), dtype)
    out = torch.empty(3, C, nl, nkf, dtype=dtype, device=src.device)
    kernels.launch("tensor_los", dtype, src, lo, hi, w, kf, chi, wt,
                   tabs["pairs"], tabs["n0"], ls, out, C, nk, N, nl, nslot, nx,
                   nkf, float(inv_dx))
    return out


def _tlos_bwd_cuda(src, lo, hi, w, kf, chi, wt, jl_tab, jlp_tab, ls, inv_dx,
                   grid: dict, g):
    """csrc/tensor_los.cu's reverse kernel: the cotangents of src (C, 2,
    nk, N), chi and wt (C, N) from that of the output g (3, C, nl, nkf), as
    autograd of `_tlos_plain` gives them: the derivative of j_l and j_l' in
    x is the slope of the table's linear interpolant (the index is
    truncated, as in JAX), max(x, 1e-8) passes nothing below 1e-8, and the
    source cotangent goes back to the coarse k through the transposed
    2-point stencil. A block owns (chain, 32 fine k, a tile of tau nodes),
    its lanes walk the live sampled l's; the sums over k and the scatter to
    the coarse rows go through partial buffers added in a fixed order (no
    atomics). `grid` is the `_tlos_grid` of lo, hi, w."""
    tabs = _TLOS_BY_TABLE.get(id(jl_tab))
    if tabs is None or tabs["jl"] is not jl_tab or tabs["jlp"] is not jlp_tab:
        raise ValueError("jl_tab and jlp_tab must be the tables of tlos_tables(): "
                         "the kernel reads their packed form")
    if grid["lo"] is not lo or grid["hi"] is not hi:
        raise ValueError("grid must be the _tlos_grid of the stencil lo, hi")
    C, _, nk, N = src.shape
    nl, nx = jl_tab.shape
    nkf = kf.shape[0]
    nslot = tabs["pairs"].shape[1]
    dtype = src.dtype
    g = g.contiguous()
    kernels.check(src, "sources", (C, 2, nk, N))
    for name, t in (("chi", chi), ("wt", wt)):
        kernels.check(t, name, (C, N), dtype)
    kernels.check(g, "g", (3, C, nl, nkf), dtype)
    nkb = -(-nkf // TLOS_KT)
    kernels.check(grid["blk_off"], "blk_off", (nkb + 1,), torch.int32)
    kernels.check(grid["row_kb"], "row_kb", (nk, 2), torch.int32)
    rtot = grid["rtot"]
    part_src = torch.empty(C, 2, rtot, N, dtype=dtype, device=src.device)
    part_w = torch.empty(C, nkb, 2, N, dtype=dtype, device=src.device)
    g_src = torch.empty_like(src)
    g_chi, g_wt = torch.empty_like(chi), torch.empty_like(wt)
    kernels.launch("tensor_los_bwd", dtype, src, lo, hi, w, kf, chi, wt,
                   tabs["pairs"], tabs["n0"], ls, g, grid["blk_off"],
                   grid["row_kb"], part_src, part_w, g_src, g_chi, g_wt, C, nk,
                   N, nl, nslot, nx, nkf, float(inv_dx), grid["rspan"], rtot)
    return g_src, g_chi, g_wt


class _TensorLos(torch.autograd.Function):
    """K6 on the card with its reverse kernel (`_tlos_bwd_cuda`); `rest` is
    `_tlos_cuda`'s other arguments (lo, hi, w, kf, jl_tab, jlp_tab, ls,
    inv_dx)."""

    @staticmethod
    def forward(ctx, src, chi, wt, rest, grid):
        ctx.save_for_backward(src, chi, wt)
        ctx.rest, ctx.grid = rest, grid
        lo, hi, w, kf, jl, jlp, ls, inv_dx = rest
        return _tlos_cuda(src, lo, hi, w, kf, chi, wt, jl, jlp, ls, inv_dx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        src, chi, wt = ctx.saved_tensors
        lo, hi, w, kf, jl, jlp, ls, inv_dx = ctx.rest
        return (*_tlos_bwd_cuda(src, lo, hi, w, kf, chi, wt, jl, jlp, ls,
                                inv_dx, ctx.grid, g), None, None)


def _tlos_inputs(to: TensorOutput, lmax: int, tau0_hint: float,
                 kmax_hint: float, points_per_osc: float, coarse_k):
    """The arguments of `_tlos_plain` / `_tlos_cuda` for the sources `to`,
    and the grid (`_tlos_grid`). The tables, the fine grid and the stencil
    are built once per grid and device and reused; `coarse_k` is the host
    grid the sources were evolved on (to.k's values; without it they are
    copied from to.k)."""
    dtype, dev = to.sT.dtype, to.sT.device
    if coarse_k is None:
        coarse_k = to.k.detach().cpu().numpy()
    grid = _tlos_grid(lmax, tau0_hint, kmax_hint, points_per_osc,
                      tuple(np.asarray(coarse_k, np.float64).tolist()), str(dev),
                      dtype)
    tabs = tlos_tables(tuple(default_l_samples(lmax).tolist()),
                       kmax_hint * tau0_hint * 1.02 + 10, dev)
    taus = to.tau
    dt = taus[:, 1:] - taus[:, :-1]
    wt = torch.cat([dt[:, :1] / 2, (dt[:, 1:] + dt[:, :-1]) / 2, dt[:, -1:] / 2],
                   -1)
    src = torch.stack([to.sT, to.sP], 1).contiguous()
    args = (src, grid["lo"], grid["hi"], grid["w"], grid["kf"],
            (to.tau0[:, None] - taus).contiguous(), wt.contiguous(), tabs["jl"],
            tabs["jlp"], grid["ls"],
            float(torch.tensor(1.0 / tabs["dx"], dtype=dtype)))
    return args, grid


def compute_tensor_cls(to: TensorOutput, pp: PrimordialParams,
                       lmax: int = 700, tau0_hint: float = 14700.0,
                       kmax_hint: float = 0.065, points_per_osc: float = 4.0,
                       coarse_k=None) -> TensorSpectra:
    """Tensor TT/TE/EE/BB in one call: the LOS transfers (K6), then the
    tensor power."""
    cache = compute_tensor_transfers(to, lmax=lmax, tau0_hint=tau0_hint,
                                     kmax_hint=kmax_hint,
                                     points_per_osc=points_per_osc,
                                     coarse_k=coarse_k)
    return tensor_cls_from_transfers(cache, pp, lmax=lmax)


def compute_tensor_transfers(to: TensorOutput, lmax: int = 700,
                             tau0_hint: float = 14700.0,
                             kmax_hint: float = 0.065,
                             points_per_osc: float = 4.0,
                             coarse_k=None) -> TensorTransferCache:
    """SLOW stage: tensor sources x Bessel (ZS97 window functions).
    `coarse_k` is the host grid the sources were evolved on (to.k's
    values); without it they are copied from to.k. The plain version on
    the CPU (autograd differentiates it), on the card the kernel, through
    `_TensorLos` when the sources, tau or tau0 want a gradient."""
    args, grid = _tlos_inputs(to, lmax, tau0_hint, kmax_hint, points_per_osc,
                              coarse_k)
    src, lo, hi, w, kf, chi, wt, jl, jlp, ls, inv_dx = args
    if src.device.type == "cpu":
        out = _tlos_plain(*args)
    elif torch.is_grad_enabled() and any(t.requires_grad for t in (src, chi, wt)):
        out = _TensorLos.apply(src, chi, wt, (lo, hi, w, kf, jl, jlp, ls, inv_dx),
                               grid)
    else:
        out = _tlos_cuda(*args)
    return TensorTransferCache(grid["ls"], grid["kf"], grid["wk"], out[0], out[1],
                               out[2])


def tensor_cls_from_transfers(cache: TensorTransferCache, pp: PrimordialParams,
                              lmax: int = 700) -> TensorSpectra:
    """SEMI-SLOW stage: apply the tensor primordial power to the cache.

    NORM = 1/16 for TT/TE/EE/BB alike, derived in the JAX package from
    cmbmain.f90 CalcTensCls (C_l = (pi/4) ctnorm int dlnk P_T Delta^2, with
    ctnorm inside dT as efac)."""
    dtype = cache.dT.dtype
    wP = (cache.wk * tensor_power(pp, cache.kf)).to(dtype)[:, None, :]
    tts = 4.0 * torch.pi * torch.sum(wP * cache.dT * cache.dT, -1)
    tes = 4.0 * torch.pi * torch.sum(wP * cache.dT * cache.dE, -1)
    ees = 4.0 * torch.pi * torch.sum(wP * cache.dE * cache.dE, -1)
    bbs = 4.0 * torch.pi * torch.sum(wP * cache.dB * cache.dB, -1)
    ls_f = cache.ls
    fac = ls_f * (ls_f + 1) / (2 * torch.pi)
    all_l = torch.arange(2, lmax + 1, dtype=dtype, device=ls_f.device)

    def fill(vals):
        return spline_eval(spline_fit(ls_f, vals), all_l)
    NORM = 1.0 / 16.0
    return TensorSpectra(all_l.to(torch.int32), NORM * fill(fac * tts),
                         NORM * fill(fac * tes), NORM * fill(fac * ees),
                         NORM * fill(fac * bbs))

