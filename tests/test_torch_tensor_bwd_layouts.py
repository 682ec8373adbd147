"""The reverse kernels of K5 (csrc/tensors.cu tensors_bwd) and K6
(csrc/tensor_los.cu tensor_los_bwd), transcribed into torch and held
against autograd of the plain versions they transpose (CPU, float64,
small sizes).

- K5: the forward's lane layout (h and h' on every thread, Dt_l and Dn_l
  on thread l, Dp_l on thread 17 + l; torch.roll-free shifts for the warp
  shuffles, sums over the 32 threads for the butterflies). One transposed
  RHS (`rhs_vjp`) against autograd of `_tensor_rhs` on rows in tight
  coupling, after it and past the freeze, 1e-12; then the whole reverse
  pass (the checkpoints a chunk apart, each chunk recomputed forward, the
  steps walked backward: the planes' vjp at the step's end state, the held
  steps' cotangent stopped, each substep's RK4 transposed stage by stage,
  the row cotangents summed over the k lanes) against autograd of
  `_evolve_t_plain` with a seeded cotangent on the three planes, with 1 and
  2 substeps, over steps that cross the release, tight coupling and the
  freeze, 1e-12 of the largest magnitude.
- K6: per (chain, fine k, tau) point the twelve sums over the live sampled
  l's against the table entries and their differences, the cotangents of
  the weighted sources and of x (the slope of the table's interpolant,
  max(x, 1e-8) passing none below), the sums over a block's 32 k, and the
  source cotangent scattered through the transposed 2-point stencil into
  per-block partial rows (`transposed_stencil`) added in block order;
  against autograd of `_tlos_plain`, also with x < 1e-8 at the last node,
  1e-12.
"""

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models import tensors as tten
from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.reionization import zre_from_tau

from test_torch_rec_tensor_layouts import (LANE_DP, _from_lanes, _lane_constants,
                                           _rhs_lanes, _to_lanes)

F64 = torch.float64
RTOL = 1e-12
#: the fields of a qtab row that get a cotangent (QT_TC is a flag)
Q_GRAD = (tten.QT_TAU, tten.QT_OPAC, tten.QT_GG, tten.QT_GN, tten.QT_ADOTOA)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


# ---- K5 ----

def _down(v):
    """__shfl_down_sync(v, 1): thread i reads thread i + 1 (31 itself)."""
    return torch.cat([v[..., 1:], v[..., -1:]], -1)


def _up(v):
    """__shfl_up_sync(v, 1): thread i reads thread i - 1 (0 itself)."""
    return torch.cat([v[..., :1], v[..., :-1]], -1)


def _coefs():
    """csrc/tensors.cu coef_t, coef_p: each thread's weight in pi_t, pi_n
    (Dt_{0,2,4}, Dn_{0,2,4}) and in Psi's Dp part."""
    ct, cp = torch.zeros(32, dtype=F64), torch.zeros(32, dtype=F64)
    ct[0], ct[2], ct[4] = 0.1, 1.0 / 7.0, 3.0 / 70.0
    cp[LANE_DP], cp[LANE_DP + 2], cp[LANE_DP + 4] = -0.6, 6.0 / 7.0, -3.0 / 70.0
    return ct, cp


def _rhs_vjp_lanes(st, q, k, fb, L, g, gpsi):
    """csrc/tensors.cu:rhs_vjp in torch: the cotangents of the state (h,
    h' (C, nk); the two slots (C, nk, 32)) and of the row's fields (C, nk)
    from g (the cotangent of dy in the same layout) and gpsi (of Psi, (C,
    nk)); each warp-uniform value is one (C, nk) entry."""
    ht, htp, m1, m2 = st
    g_ht, g_htp, g_m1, g_m2 = g
    Q = lambda f: q[:, f:f + 1]
    e = lambda v: v[..., None]
    opac, tau = Q(tten.QT_OPAC), Q(tten.QT_TAU)
    tau_safe = torch.clamp(tau, min=1e-10)
    inv3 = 1.0 / (3.0 * torch.clamp(opac, min=1e-30))
    clt, clp = (tten.LMAXT + 1) / tau_safe, (tten.LMAXTP + 1) / tau_safe
    rsa = k * tau >= tten.RSA_KTAU_T
    tc = Q(tten.QT_TC) > 0.5
    lane = torch.arange(32)
    pi_t = m1[..., 0] * 0.1 + m1[..., 2] * (1.0 / 7.0) + (3.0 / 70.0) * m1[..., 4]
    psi_full = pi_t - 0.6 * m1[..., LANE_DP] + (6.0 / 7.0) * m1[..., LANE_DP + 2] \
        - (3.0 / 70.0) * m1[..., LANE_DP + 4]
    psi = torch.where(tc, -htp * inv3, psi_full)
    pi_n = m2[..., 0] * 0.1 + m2[..., 2] * (1.0 / 7.0) + (3.0 / 70.0) * m2[..., 4]
    pi_g = torch.where(tc, 0.0, pi_t)

    e1 = torch.where(e(tc | rsa) | ~L["live1"], 0.0, g_m1)
    e2 = torch.where(e(rsa) | ~L["live2"], 0.0, g_m2)
    cl1 = torch.where(L["pol"], e(clp), e(clt))
    cl_l, cl_l1 = L["coef"] * L["l"], L["coef"] * L["lp1"]
    gm1 = torch.where(L["closure1"], -e1 * (cl1 + e(opac)), -e1 * e(opac))
    gprev1 = torch.where(L["first"], 0.0,
                         torch.where(L["closure1"], e1 * e(k), e1 * cl_l))
    gnext1 = torch.where(L["closure1"], 0.0, -e1 * cl_l1)
    src1 = L["first"] & ~L["closure1"]
    gop = -e1 * m1 + torch.where(src1, torch.where(L["pol"], -e1 * e(psi),
                                                   e1 * e(psi)), 0.0)
    gpsi_l = torch.where(src1, torch.where(L["pol"], -e1 * e(opac), e1 * e(opac)),
                         0.0)
    ghtp_l = torch.where(src1 & ~L["pol"], -e1, 0.0)
    gcl = torch.where(L["closure1"], -e1 * m1, 0.0)
    gm2 = torch.where(L["closure2"], -e2 * e(clt), 0.0)
    gprev2 = torch.where(L["first"], 0.0,
                         torch.where(L["closure2"], e2 * e(k), e2 * cl_l))
    gnext2 = torch.where(L["closure2"], 0.0, -e2 * cl_l1)
    gcl = gcl + torch.where(L["closure2"], -e2 * m2, 0.0)
    ghtp_l = ghtp_l + torch.where(L["first"] & ~L["closure2"], -e2, 0.0)
    gm1 = gm1 + torch.where(lane < 31, _down(gprev1), 0.0) \
        + torch.where(lane > 0, _up(gnext1), 0.0)
    gm2 = gm2 + torch.where(lane < 31, _down(gprev2), 0.0) \
        + torch.where(lane > 0, _up(gnext2), 0.0)

    G_psi = torch.where(rsa, 0.0, gpsi) + gpsi_l[..., 0] + gpsi_l[..., LANE_DP]
    ghtp = g_ht - 2.0 * Q(tten.QT_ADOTOA) * g_htp + ghtp_l[..., 0]
    ght = -k * k * g_htp
    G_clt, G_clp = gcl[..., tten.LMAXT], gcl[..., LANE_DP + tten.LMAXTP]
    G_op = gop.sum(-1)
    sw = ~rsa & fb
    G_pig = torch.where(sw, (16.0 / 3.0) * Q(tten.QT_GG) * g_htp, 0.0)
    G_pin = torch.where(sw, (16.0 / 3.0) * Q(tten.QT_GN) * g_htp, 0.0)
    gq = {tten.QT_GG: torch.where(sw, (16.0 / 3.0) * pi_g * g_htp, 0.0),
          tten.QT_GN: torch.where(sw, (16.0 / 3.0) * pi_n * g_htp, 0.0),
          tten.QT_ADOTOA: -2.0 * htp * g_htp}
    ghtp = ghtp + torch.where(tc, -G_psi * inv3, 0.0)
    G_inv3 = torch.where(tc, -G_psi * htp, 0.0)
    G_psf = torch.where(tc, 0.0, G_psi)
    G_pit = torch.where(tc, 0.0, G_pig)
    ct, cp = _coefs()
    gm1 = gm1 + ct * e(G_psf + G_pit) + cp * e(G_psf)
    gm2 = gm2 + ct * e(G_pin)
    G_op = G_op + torch.where(opac >= 1e-30, G_inv3 * (-3.0 * inv3 * inv3), 0.0)
    gq[tten.QT_OPAC] = G_op
    gq[tten.QT_TAU] = torch.where(tau >= 1e-10, -(G_clt * clt + G_clp * clp) / tau,
                                  0.0)
    return [ght, ghtp, gm1, gm2], torch.where(rsa, 0.0, psi), gq


def _ax(u, h, d):
    """axpy on a lane state, h (C, 1) per chain."""
    return [a + (h if a.dim() == 2 else h[..., None]) * b for a, b in zip(u, d)]


def _dot(a, b):
    """csrc/tensors.cu dot_local summed over the warp: (C, nk)."""
    return a[0] * b[0] + a[1] * b[1] + (a[2] * b[2]).sum(-1) + (a[3] * b[3]).sum(-1)


def _add(a, b):
    return [x + y for x, y in zip(a, b)]


def _scale(h, a):
    return [(h if x.dim() == 2 else h[..., None]) * x for x in a]


def _rk4_lanes(y, qa, qm, qb, k, fb, L):
    k1, _ = _rhs_lanes(y, qa, k, fb, L)
    dt = qb[:, tten.QT_TAU:tten.QT_TAU + 1] - qa[:, tten.QT_TAU:tten.QT_TAU + 1]
    h2 = 0.5 * dt
    acc = k1
    k2, _ = _rhs_lanes(_ax(y, h2, k1), qm, k, fb, L)
    acc = [a + 2.0 * b for a, b in zip(acc, k2)]
    k3, _ = _rhs_lanes(_ax(y, h2, k2), qm, k, fb, L)
    acc = [a + 2.0 * b for a, b in zip(acc, k3)]
    k4, _ = _rhs_lanes(_ax(y, dt, k3), qb, k, fb, L)
    return _ax(y, dt * (1.0 / 6.0), [a + b for a, b in zip(acc, k4)])


def _rk4_vjp_lanes(y, qa, qm, qb, k, fb, L, lam):
    """csrc/tensors.cu:rk4_vjp: the cotangent of the substep's start and
    those of its three rows (dicts of (C, nk))."""
    dt = qb[:, tten.QT_TAU:tten.QT_TAU + 1] - qa[:, tten.QT_TAU:tten.QT_TAU + 1]
    h2, h6 = 0.5 * dt, dt * (1.0 / 6.0)
    k1, _ = _rhs_lanes(y, qa, k, fb, L)
    y2 = _ax(y, h2, k1)
    k2, _ = _rhs_lanes(y2, qm, k, fb, L)
    y3 = _ax(y, h2, k2)
    k3, _ = _rhs_lanes(y3, qm, k, fb, L)
    y4 = _ax(y, dt, k3)
    k4, _ = _rhs_lanes(y4, qb, k, fb, L)
    ks = [a + 2.0 * b + 2.0 * c + d for a, b, c, d in zip(k1, k2, k3, k4)]
    zero = torch.zeros(y[0].shape, dtype=F64)
    gdt = _dot(lam, ks) * (1.0 / 6.0)
    gs, _, gb = _rhs_vjp_lanes(y4, qb, k, fb, L, _scale(h6, lam), zero)
    gdt = gdt + _dot(gs, k3)
    gy = _add(lam, gs)
    gs, _, gm = _rhs_vjp_lanes(y3, qm, k, fb, L,
                               _add(_scale(2.0 * h6, lam), _scale(dt, gs)), zero)
    gdt = gdt + 0.5 * _dot(gs, k2)
    gy = _add(gy, gs)
    gs, _, gm2 = _rhs_vjp_lanes(y2, qm, k, fb, L,
                                _add(_scale(2.0 * h6, lam), _scale(h2, gs)), zero)
    gm = {f: gm[f] + gm2[f] for f in gm}
    gdt = gdt + 0.5 * _dot(gs, k1)
    gy = _add(gy, gs)
    gs, _, ga = _rhs_vjp_lanes(y, qa, k, fb, L,
                               _add(_scale(h6, lam), _scale(h2, gs)), zero)
    gy = _add(gy, gs)
    ga[tten.QT_TAU] = ga[tten.QT_TAU] - gdt
    gb[tten.QT_TAU] = gb[tten.QT_TAU] + gdt
    return gy, ga, gm, gb


def _bwd_lanes(qtab, k, fb, g_out, chunk):
    """csrc/tensors.cu's tensors_ck + tensors_bwd in torch: the cotangent
    of qtab (C, S, R, NQT)."""
    C, S, R = qtab.shape[0], qtab.shape[1], qtab.shape[2]
    substeps = (R - 1) // 3
    nk = k.shape[0]
    L = _lane_constants(k)
    y0 = _to_lanes(tten._initial_state(C, nk, F64, "cpu"))
    released = lambda j: k * qtab[:, j, R - 1, tten.QT_TAU:tten.QT_TAU + 1] \
        >= tten.RELEASE_KTAU_T
    held = lambda r, a, b: [torch.where(r if x.dim() == 2 else r[..., None], x, z)
                            for x, z in zip(a, b)]
    # the forward with its checkpoints (a lane held on y0 until released)
    ck, y = [], y0
    for j in range(S):
        if j % chunk == 0:
            ck.append(y)
        yn = y
        for sub in range(substeps):
            yn = _rk4_lanes(yn, *(qtab[:, j, 3 * sub + r] for r in range(3)), k, fb, L)
        y = held(released(j), yn, y0)
    ck.append(y)
    gq = torch.zeros(C, S, R, tten.NQT, dtype=F64)
    lam = [torch.zeros_like(a) for a in y0]
    for ch in range(len(ck) - 2, -1, -1):
        s_lo, s_hi = ch * chunk, min(S, ch * chunk + chunk)
        states, y = {}, ck[ch]
        for j in range(s_lo, s_hi):
            for sub in range(substeps):
                states[j, sub] = y
                y = _rk4_lanes(y, *(qtab[:, j, 3 * sub + r] for r in range(3)), k, fb, L)
            y = held(released(j), y, y0)
        states[s_hi, 0] = y
        for j in range(s_hi - 1, s_lo - 1, -1):
            qf = qtab[:, j, R - 1]
            ye = states[j + 1, 0]
            gsT, gsP, ght = g_out[:, :, j]
            vis = qf[:, tten.QT_VIS:tten.QT_VIS + 1]
            expmk = qf[:, tten.QT_EXPMK:tten.QT_EXPMK + 1]
            lam = [lam[0] + ght, lam[1] - expmk * gsT, lam[2], lam[3]]
            zero = [torch.zeros_like(a) for a in y0]
            gy, psi, gf = _rhs_vjp_lanes(ye, qf, k, fb, L, zero, vis * (gsT + gsP))
            lam = _add(lam, gy)
            for f, v in gf.items():
                gq[:, j, R - 1, f] += v.sum(1)
            gq[:, j, R - 1, tten.QT_VIS] += (psi * (gsT + gsP)).sum(1)
            gq[:, j, R - 1, tten.QT_EXPMK] += (-ye[1] * gsT).sum(1)
            rel = released(j)
            for sub in range(substeps - 1, -1, -1):
                rows = [qtab[:, j, 3 * sub + r] for r in range(3)]
                lam_r, *grs = _rk4_vjp_lanes(states[j, sub], *rows, k, fb, L, lam)
                for r, gr in enumerate(grs):
                    for f, v in gr.items():
                        gq[:, j, 3 * sub + r, f] += torch.where(rel, v, 0.0).sum(1)
                lam = held(rel, lam_r, [torch.zeros_like(a) for a in lam_r])
    return gq


@pytest.fixture(scope="module")
def tensor_tables():
    """Two chains on a 2048-step grid; their stage tables (1 and 2
    substeps)."""
    bg = BackgroundParams.make(ombh2=np.array([0.02237, 0.0215]),
                               omch2=np.array([0.12, 0.115]),
                               H0=np.array([67.4, 66.0]), nchains=2,
                               device="cpu", dtype=F64)
    yhe = torch.tensor([0.245, 0.240], dtype=F64)
    th = trec.compute_thermo(bg, yhe, n_z=1500)
    zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64), yhe)
    tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=2048)
    return {s: tten._stage_table(bg, tf, s) for s in (1, 2)}


@pytest.mark.parametrize("step", [5, 300, 900, 2000])
@pytest.mark.parametrize("fb", [True, False])
def test_tensor_lane_rhs_vjp_matches_autograd(tensor_tables, step, fb):
    """rhs_vjp on a random state and random cotangents (of dy and Psi)
    against autograd of `_tensor_rhs` (rows in tight coupling, around
    recombination, free streaming, past the freeze for the top k)."""
    q = tensor_tables[1][:, step, 1].clone()
    k = torch.as_tensor(tten.tensor_k_grid(nk=16), dtype=F64)
    rng = np.random.default_rng(step + 7 * fb)
    y = torch.tensor(rng.standard_normal((2, 16, tten.NVAR_T)), dtype=F64)
    gdy = torch.tensor(rng.standard_normal((2, 16, tten.NVAR_T)), dtype=F64)
    gpsi = torch.tensor(rng.standard_normal((2, 16)), dtype=F64)
    yr, qr = y.clone().requires_grad_(True), q.clone().requires_grad_(True)
    dy, psi = tten._tensor_rhs(yr, qr, k, fb)
    ref_y, ref_q = torch.autograd.grad((dy * gdy).sum() + (psi * gpsi).sum(),
                                       [yr, qr])
    L = _lane_constants(k)
    gst, _, gq = _rhs_vjp_lanes(_to_lanes(y), q, k, fb, L, _to_lanes(gdy), gpsi)
    assert not gst[2][..., LANE_DP + tten.LMAXTP + 1:].any()
    assert not gst[3][..., tten.LMAXTN + 1:].any()
    got_y = _from_lanes(gst)
    assert rel_err(got_y, ref_y) <= RTOL
    for f in Q_GRAD:
        got = gq[f].sum(1)
        assert float((got - ref_q[:, f]).abs().max()) <= \
            RTOL * float(ref_q[:, f].abs().max()) + 1e-300, f
    assert float(ref_q[:, tten.QT_TC].abs().max()) == 0.0
    assert float(ref_q[:, tten.QT_VIS].abs().max()) == 0.0


@pytest.mark.parametrize("substeps,first,chunk", [(1, 0, 7), (1, 1240, 16),
                                                  (1, 1370, 40), (2, 1370, 9)])
def test_tensor_lane_bwd_matches_autograd(tensor_tables, substeps, first, chunk):
    """The reverse pass over 40 steps of 8 k from a seeded cotangent of the
    three planes: from the grid's start (the small k held, the large
    released, tight coupling ending), across the release of the smallest k
    and across the freeze of the largest; chunks of 7, 16, 40 and 9 steps
    (a ragged last chunk)."""
    q = tensor_tables[substeps][:, first:first + 40].contiguous()
    k = torch.as_tensor(tten.tensor_k_grid(nk=8), dtype=F64)
    g_out = torch.tensor(np.random.default_rng(first + substeps).standard_normal(
        (3, 2, 40, 8)), dtype=F64)
    qr = q.clone().requires_grad_(True)
    (ref,) = torch.autograd.grad((tten._evolve_t_plain(qr, k, substeps, True)
                                  * g_out).sum(), [qr])
    with torch.no_grad():
        got = _bwd_lanes(q, k, True, g_out, chunk)
    assert rel_err(got, ref) <= RTOL
    assert float(ref[..., tten.QT_TC].abs().max()) == 0.0
    assert float(got[..., tten.QT_TC].abs().max()) == 0.0
    assert float(ref[:, :, :-1, tten.QT_VIS:].abs().max()) == 0.0


def test_evolve_plain_remat_is_bit_for_bit(tensor_tables):
    """`_evolve_t_plain`'s gradient is the same in chunks of 9 steps as
    without checkpoints; without a gradient it records no graph."""
    q = tensor_tables[1][:, 1230:1270].contiguous()
    k = torch.as_tensor(tten.tensor_k_grid(nk=8), dtype=F64)
    g_out = torch.tensor(np.random.default_rng(3).standard_normal((3, 2, 40, 8)),
                         dtype=F64)
    grads = []
    for chunks in (0, 5):
        qr = q.clone().requires_grad_(True)
        out = tten._evolve_t_plain(qr, k, 1, True, remat_chunks=chunks)
        grads.append(torch.autograd.grad((out * g_out).sum(), [qr])[0])
    assert torch.equal(grads[0], grads[1])
    assert not tten._evolve_t_plain(q, k, 1, True).requires_grad


# ---- K6 ----

def _tlos_case(small_x: bool, lmax=120, nk=12, N=64, C=2, seed=0):
    """Arguments of `_tlos_plain` on the real tables of an lmax-`lmax` l
    set: smooth random sources on `nk` coarse k to 0.03/Mpc, C chains of N
    tau nodes; with `small_x` the last node of chain 1 sits a few ulps
    below its tau0 (x < 1e-8 there, as on the main path)."""
    rng = np.random.default_rng(seed)
    kmax, tau0_hint = 0.03, 14700.0
    coarse = tten.tensor_k_grid(kmax=kmax, nk=nk)
    grid = tten._tlos_grid(lmax, tau0_hint, kmax, 4.0, tuple(coarse.tolist()),
                           "cpu", F64)
    from cosmomc_tpu_torch.models.bessel import default_l_samples
    tabs = tten.tlos_tables(tuple(default_l_samples(lmax).tolist()),
                            kmax * tau0_hint * 1.02 + 10, "cpu")
    tau0 = np.array([14100.0, 13950.0])[:C]
    tau = np.stack([np.concatenate([np.geomspace(200.0, 1200.0, N // 2),
                                    np.linspace(1300.0, t0 - 30.0, N // 2)])
                    for t0 in tau0])
    if small_x:
        tau[-1, -1] = tau0[-1] * (1 - 4e-16)
    chi = torch.tensor(tau0[:, None] - tau, dtype=F64)
    dt = np.diff(tau, axis=1)
    wt = torch.tensor(np.concatenate([dt[:, :1] / 2, (dt[:, 1:] + dt[:, :-1]) / 2,
                                      dt[:, -1:] / 2], 1), dtype=F64)
    src = torch.tensor(np.cumsum(rng.standard_normal((C, 2, nk, N)), -1) / 10, dtype=F64)
    args = (src, grid["lo"], grid["hi"], grid["w"], grid["kf"], chi, wt,
            tabs["jl"], tabs["jlp"], grid["ls"], 1.0 / tabs["dx"])
    return args, grid, tabs


def _tlos_bwd_blocks(args, grid, tabs, g):
    """csrc/tensor_los.cu tensor_los_bwd in torch, block for block."""
    src, lo, hi, w, kf, chi, wt, jl, jlp, ls, inv_dx = args
    C, _, nk, N = src.shape
    nl, nx = jl.shape
    nkf = kf.shape[0]
    KT = tten.TLOS_KT
    pairs = torch.as_tensor(tabs["pairs"], dtype=F64)        # (nx - 1, nslot, 4)
    n0 = tabs["n0"].long()
    efac = torch.sqrt(torch.clamp((ls + 2) * (ls + 1) * ls * (ls - 1), min=0.0))
    G = torch.stack([g[0] * efac[:, None], g[1], g[2]])      # (3, C, nl, nkf)
    lp2 = ls * (ls + 1) + 2.0
    x = kf[None, :, None] * chi[:, None, :]                  # (C, nkf, N)
    tt = x * inv_dx
    i = tt.to(torch.int64).clamp(0, nx - 2)
    f = tt - i.to(F64)
    live = n0[None, None, None, :nl] <= (i + 1)[..., None]   # (C, nkf, N, nl)
    e = pairs[i][..., :nl, :] * live[..., None]              # (C, nkf, N, nl, 4)
    J0, P0 = e[..., 0], e[..., 1]
    dJ, dP = e[..., 2] - J0, e[..., 3] - P0
    Gt, Ge, Gb = (G[p].permute(0, 2, 1)[:, :, None, :] for p in range(3))
    sums = {}
    for name, gg, tab in (("1", Gt, (J0, dJ)), ("2", Ge * lp2, (J0, dJ)),
                          ("3", Ge, (J0, dJ)), ("4", Gb, (J0, dJ)),
                          ("5", Ge, (P0, dP)), ("6", Gb, (P0, dP))):
        sums["A" + name] = (gg * tab[0]).sum(-1)
        sums["B" + name] = (gg * tab[1]).sum(-1)
    a = {n: sums["A" + n] + f * sums["B" + n] for n in "123456"}
    B = {n: sums["B" + n] for n in "123456"}
    inv = 1.0 / torch.clamp(x, min=1e-8)
    inv2 = inv * inv
    dinv = torch.where(x >= 1e-8, -inv2, 0.0)
    l_, h_ = lo.long(), hi.long()
    Si = src[:, :, l_] + w[:, None] * (src[:, :, h_] - src[:, :, l_])   # (C, 2, nkf, N)
    STi, SPi = Si[:, 0], Si[:, 1]
    STw, SPw = STi * wt[:, None], SPi * wt[:, None]
    gSTw = inv2 * a["1"]
    gSPw = inv2 * a["2"] - 2 * a["3"] + 4 * inv * a["4"] + 2 * inv * a["5"] + 2 * a["6"]
    gx = inv_dx * (STw * inv2 * B["1"] + SPw * (inv2 * B["2"] - 2 * B["3"] + 4 * inv * B["4"]
                                                 + 2 * inv * B["5"] + 2 * B["6"])) \
        + dinv * (STw * 2 * inv * a["1"] + SPw * (2 * inv * a["2"] + 2 * a["5"] + 4 * a["4"]))
    nkb = -(-nkf // KT)
    blocks = [slice(b * KT, min(nkf, b * KT + KT)) for b in range(nkb)]
    # chi and wt: each block's 32 k summed, then the blocks in order
    g_chi = sum((kf[None, sl, None] * gx[:, sl]).sum(1) for sl in blocks)
    g_wt = sum((gSTw[:, sl] * STi[:, sl] + gSPw[:, sl] * SPi[:, sl]).sum(1)
               for sl in blocks)
    # the sources: per block, its share of each coarse row in lane order,
    # into the partial rows blk_off[b] + r - lo[b's first k]
    Bk = torch.stack([gSTw * wt[:, None], gSPw * wt[:, None]], 1)   # (C, 2, nkf, N)
    blk_off, row_kb = grid["blk_off"].tolist(), grid["row_kb"].tolist()
    part = torch.zeros(C, 2, int(grid["rtot"]), N, dtype=F64)
    for b, sl in enumerate(blocks):
        r_lo = int(lo[sl.start])
        for kk in range(sl.start, sl.stop):
            bk = Bk[:, :, kk]
            part[:, :, blk_off[b] + int(lo[kk]) - r_lo] += bk - w[kk] * bk
            part[:, :, blk_off[b] + int(hi[kk]) - r_lo] += w[kk] * bk
    g_src = torch.zeros_like(src)
    for r in range(nk):
        for b in range(row_kb[r][0], row_kb[r][1] + 1):
            g_src[:, :, r] += part[:, :, blk_off[b] + r - int(lo[b * KT])]
    return g_src, g_chi, g_wt


@pytest.mark.parametrize("small_x", [False, True])
def test_tlos_bwd_blocks_match_autograd(small_x):
    args, grid, tabs = _tlos_case(small_x)
    src, chi, wt = (args[i].clone().requires_grad_(True) for i in (0, 5, 6))
    out = tten._tlos_plain(src, *args[1:5], chi, wt, *args[7:])
    g = torch.tensor(np.random.default_rng(5).standard_normal(tuple(out.shape)),
                     dtype=F64)
    ref = torch.autograd.grad((out * g).sum(), [src, chi, wt])
    with torch.no_grad():
        got = _tlos_bwd_blocks(args, grid, tabs, g)
    for name, a, b in zip(("src", "chi", "wt"), got, ref):
        assert rel_err(a, b) <= RTOL, name
    x = args[4][None, :, None] * args[5][:, None, :]
    assert bool((x < 1e-8).any()) == small_x
    assert float(ref[0].abs().max()) > 0


def test_tlos_grid_stencil_plan():
    """The reverse kernel's scatter plan of the main path's grid (lmax 700,
    96 coarse k): a k block writes a partial row for each coarse row in its
    span (lo of its first k .. hi of its last), rtot of them in all, and
    row r adds the blocks whose span holds it (every row the 2-point
    stencil reaches has one); a span fits rspan."""
    kt = tten.tensor_k_grid()
    grid = tten._tlos_grid(700, 14700.0, 0.065, 4.0, tuple(kt.tolist()), "cpu", F64)
    lo, hi = grid["lo"].tolist(), grid["hi"].tolist()
    KT = tten.TLOS_KT
    spans = [(lo[b], hi[min(b + KT, len(lo)) - 1]) for b in range(0, len(lo), KT)]
    assert grid["rtot"] == sum(h - l + 1 for l, h in spans)
    assert grid["rspan"] == max(h - l + 1 for l, h in spans) <= len(kt)
    assert grid["blk_off"].tolist() == np.cumsum(
        [0] + [h - l + 1 for l, h in spans]).tolist()
    for r, (b0, b1) in enumerate(grid["row_kb"].tolist()):
        holds = [b for b, (l, h) in enumerate(spans) if l <= r <= h]
        assert (b0, b1) == ((holds[0], holds[-1]) if holds else (0, -1)), r
        if r in lo or r in hi:
            assert holds, r
