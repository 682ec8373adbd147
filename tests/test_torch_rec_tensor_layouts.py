"""The layouts of the K2b (csrc/los_recurrence.cu) and K5 (csrc/tensors.cu)
kernels, transcribed into torch and held against the plain versions they
must reproduce (CPU, float64, small sizes).

- K2b: L0, from the host's cut table in the kernel's dtype, past which the
  series branch only ever yields a value the Airy cut zeroes; the kernel's
  walk (warps owning contiguous tau nodes, each node's first dead l by
  bisection, the full step below L0 and the recurrence alone from it, no
  select below the warp's smallest first dead l, each warp stopped at its
  largest, the sampled-l terms from four per-node coefficients, per-warp
  slots summed in warp order) keeps the plain version's j_l states and
  predicates bit for bit, and its Delta_l are the plain version's to 1e-12
  of each maximum (only the order of the sums differs).
- K5: h and h' on every thread, Dt_l and Dn_l on thread l, Dp_l on thread
  17 + l, neighbours by torch.roll as the warp shuffles take them, constant
  reciprocals for the plain version's quotients, against `_tensor_rhs` and
  `_evolve_t_plain`, 1e-12 of each maximum; the source evaluation reused as
  the next step's first and the held steps left unintegrated give the same
  bits as evaluating and integrating them; and the stage table repeats a
  step's tau_b row as the next step's tau_a row.
"""

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models import tensors as tten
from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.bessel import default_l_samples
from cosmomc_tpu_torch.models.reionization import zre_from_tau

F64 = torch.float64
NWARP = tcls.REC_THREADS // 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores; torch's
    own thread pool on top of them oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def airy_cut(lmax):
    nu = np.arange(lmax + 1) + 0.5
    return np.maximum(nu - 2.5 * np.cbrt(nu), 0.0)


# ---- K2b ----

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_series_limit_from_host_table(dtype):
    """For every l >= L0 and every x on a dense grid of the dtype (all its
    values within 256 ulps of each sqrt(l+1), and 2e5 spread to
    sqrt(lmax+2)), x*x < l+1 (rounded in the dtype) implies x <= cut[l];
    at L0 - 1 an x breaks it, so L0 is the least such l. The kernel's
    wrapper takes L0 from `rec_l0`, made once per (lmax, dtype) from the
    cut `_rec_plan` builds, which does not decrease in l in the dtype."""
    lmax = 2658
    assert np.array_equal(tcls.airy_cut(lmax), airy_cut(lmax))
    cut = airy_cut(lmax).astype(dtype)
    assert (np.diff(cut[2:]) >= 0).all()
    L0 = tcls.rec_series_limit(cut)
    assert L0 == 8
    assert tcls.rec_l0(lmax, torch.float32 if dtype == np.float32 else F64) == L0
    one = dtype(1)
    grid = [np.linspace(0.0, np.sqrt(lmax + 2.0), 200_000).astype(dtype)]
    for r in np.sqrt(np.arange(L0, 200).astype(dtype) + one):
        up, down = [r], [r]
        for _ in range(256):
            up.append(np.nextafter(up[-1], dtype(np.inf)))
            down.append(np.nextafter(down[-1], dtype(0)))
        grid += [np.array(up, dtype), np.array(down, dtype)]
    x = np.unique(np.concatenate(grid))
    xx = x * x                                    # rounded in the dtype
    assert xx.dtype == dtype
    # x*x < l+1 holds from l = floor(xx) on, and the cut grows with l: each
    # x need only be checked at the first l >= L0 where the series is taken
    l_first = np.maximum(np.floor(xx).astype(np.int64), L0)
    hit = l_first <= lmax
    assert (x[hit] <= cut[l_first[hit]]).all()
    # the same, brute force over l = L0..199
    ls = np.arange(L0, 200)
    series = xx[None, :] < (ls[:, None] + 1).astype(dtype)
    assert not (series & (x[None, :] > cut[ls][:, None])).any()
    # at L0 - 1 the largest x with x*x < L0 lies above the cut
    l = L0 - 1
    xs = x[xx < dtype(l + 1)].max()
    assert xs > cut[l]


def _rec_args(chains, nkf, nt, lmax, x_lo, x_hi, seed=0):
    """Arguments of _los_rec_plain, made from a seed: random sources on 12
    coarse k, stencils onto nkf fine k, and tau0 - tau falling along tau so
    that every x = kf (tau0 - tau) lies in [x_lo, x_hi]."""
    rng = np.random.default_rng(seed)
    coarse = np.exp(np.linspace(np.log(1e-2), 0.0, 12))
    kf = np.linspace(coarse[0], coarse[-1], nkf)
    idx, w = tcls._cubic_k_weights(coarse, kf)
    chi = np.linspace(x_hi / kf[-1], x_lo / kf[0], nt)[None] \
        * np.linspace(1.0, 0.97, chains)[:, None]
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64)
    return (f(rng.standard_normal((chains, 4, 12, nt))),
            torch.as_tensor(idx, dtype=torch.int32), f(w), f(kf), f(chi),
            f(rng.uniform(0.5, 1.5, (chains, nt))), f(rng.uniform(0.0, 1.0, (chains, nt))),
            torch.as_tensor(default_l_samples(lmax), dtype=torch.int32),
            f(airy_cut(lmax)))


def _plain_step(l, x, xx, y2, inv_x, jm1, jl, pser, cut_l):
    """One l of models/cls.py:_los_rec_plain's walk, as it is written there."""
    lf = float(l)
    jnew = ((2.0 * lf - 1.0) * inv_x) * jl - jm1
    pser = torch.clamp(pser * (x / (2.0 * lf + 1.0)), max=1.0)
    poly = (1.0 - y2 / (2.0 * lf + 3.0)
            + y2 * y2 / (2.0 * (2.0 * lf + 3.0) * (2.0 * lf + 5.0)))
    series = xx < lf + 1.0
    jnew = torch.where(series, pser * poly, jnew)
    live = x > cut_l
    jnew = torch.where(live, jnew, 0.0)
    return jnew, pser, series, live


def _walk_as_kernel(src, idx, w, kf, chi, wt, wl, ls, cut):
    """csrc/los_recurrence.cu's walk for every block at once, beside the
    plain version's; checks the states and predicates as it goes and
    returns the kernel's Delta (3, C, nl, nkf) and its walked point count."""
    C, _, _, nt = src.shape
    nkf, lmax, nl = kf.shape[0], cut.shape[0] - 1, ls.shape[0]
    span = 32 * tcls.rec_nodes_per_thread(nt)
    pad = NWARP * span - nt
    ki, kw = idx.long(), w

    def k_interp(S):
        return (kw[:, 0:1] * S[:, ki[:, 0]] + kw[:, 1:2] * S[:, ki[:, 1]]
                + kw[:, 2:3] * S[:, ki[:, 2]] + kw[:, 3:4] * S[:, ki[:, 3]])
    P = lambda a: torch.nn.functional.pad(a, (0, pad))      # pad nodes: zeros
    sv = [P(k_interp(src[:, p]) * (wl if p == 3 else wt)[:, None]) for p in range(4)]
    real = P(torch.ones(C, nkf, nt, dtype=torch.bool))
    x = P(kf[None, :, None] * chi[:, None, :])
    inv_x = 1.0 / torch.clamp(x, min=1e-6)
    xx = x * x
    small = x < 1e-3
    jm1 = torch.where(small, 1.0 - x * x / 6.0, torch.sin(x) * inv_x)
    jl = torch.where(small, x / 3.0, torch.sin(x) * inv_x * inv_x - torch.cos(x) * inv_x)
    pser = torch.clamp(x / 3.0, max=1.0)
    jm1 = torch.where(real, jm1, 0.0)
    p_jm1, p_jl, p_pser = jm1.clone(), jl.clone(), pser.clone()     # the plain's
    # first dead l: the bisection's answer (first l >= 2 with cut[l] >= x)
    lcut = torch.where(real, torch.searchsorted(cut[2:].contiguous(), x) + 2, 2)
    Wv = lambda a: a.view(C, nkf, NWARP, span)
    lo = Wv(torch.where(real, lcut, lmax + 1)).amin(-1, keepdim=True)
    lend = Wv(torch.where(real, lcut, 2)).amax(-1, keepdim=True).clamp(max=lmax)
    L0 = tcls.rec_series_limit(cut.numpy())
    # the sampled-l coefficients of each node
    i2 = inv_x * inv_x
    ca, cb = sv[0] - sv[2], 2.0 * sv[2] * i2 - sv[1] * inv_x
    cd, ce = sv[2] * i2, sv[1] - 2.0 * sv[2] * inv_x
    slots = torch.zeros(nl, 3, C, nkf, NWARP, dtype=F64)
    a = 3.0
    s = 0
    walked = 0
    for l in range(2, lmax + 1):
        walking = Wv(torch.ones_like(real)) & (l <= lend)
        walking = walking.reshape(real.shape)
        # the plain version's step, at every node
        p_new, p_pser, series, live = _plain_step(l, x, xx, 0.5 * x * x, inv_x, p_jm1,
                                                  p_jl, p_pser, float(cut[l]))
        p_jm1, p_jl = p_jl, p_new
        # the kernel's step, where its warp walks
        if l < L0:
            lf = float(l)
            pser = torch.clamp(pser * (x / (2.0 * lf + 1.0)), max=1.0)
            y2 = 0.5 * xx
            poly = 1.0 - y2 / (2.0 * lf + 3.0) \
                + y2 * y2 / (2.0 * (2.0 * lf + 3.0) * (2.0 * lf + 5.0))
            jn = torch.where(xx < lf + 1.0, pser * poly, (a * inv_x) * jl - jm1)
            jn = torch.where(l < lcut, jn, 0.0)
        else:
            # the series is one the cut zeroes
            assert not (series & live & real).any()
            jn = (a * inv_x) * jl - jm1
            selects = Wv(torch.ones_like(real)) & (l >= lo)
            jn = torch.where(selects.reshape(real.shape) & (l >= lcut), 0.0, jn)
        assert torch.equal((l < lcut) & real, live & real), l
        jm1 = torch.where(walking, jl, jm1)
        jl = torch.where(walking, jn, jl)
        a += 2.0
        walked += int((walking & real).sum())
        # the state where the warp walks, the plain's; zero where it stopped
        assert torch.equal(torch.where(walking, jl, p_jl), p_jl), l
        assert torch.equal(torch.where(walking, jm1, p_jm1), p_jm1), l
        assert not torch.where(walking | ~real, 0.0, p_jl).any(), l
        assert not torch.where(walking | ~real, 0.0, p_jm1).any(), l
        if l != int(ls[s]):
            continue
        lf = float(l)
        ct = ca + (lf + 1.0) * cb + lf * (lf + 1.0) * cd
        for p, term in enumerate((ct * jl + ce * jm1, cd * jl, sv[3] * jl)):
            slots[s, p] = Wv(torch.where(walking, term, 0.0)).sum(-1)
        s += 1
    out = torch.zeros(3, C, nl, nkf, dtype=F64)
    for q in range(NWARP):                        # the warps in order
        out += slots[..., q].permute(1, 2, 0, 3)
    lsf = ls.to(F64)
    efac = torch.sqrt(torch.clamp((lsf + 2) * (lsf + 1) * lsf * (lsf - 1), min=0.0))
    out[1] *= efac[None, :, None]
    return out, walked


@pytest.mark.parametrize("nt,x_hi,lmax", [(256, 400.0, 300), (300, 250.0, 300)])
def test_rec_walk_matches_plain(nt, x_hi, lmax):
    """256 tau nodes (NPT = 2: warps 4..7 all pads) up to x = 400, past
    lmax (some warps never stop); 300 nodes (a ragged warp) up to x = 250
    (every warp stops before lmax)."""
    args = _rec_args(2, 64, nt, lmax, 0.0, x_hi)
    ref = tcls._los_rec_plain(*args, 16)
    with torch.no_grad():
        got, walked = _walk_as_kernel(*args)
    for p, name in enumerate(("dT", "dE", "dP")):
        assert rel_err(got[p], ref[p]) <= 1e-12, name
    lat = tcls.rec_lattice(args[4], args[3], args[8])
    assert lat["walked"] == walked
    assert lat["live"] < lat["walked"] < lat["lattice"]
    x = args[3][None, :, None] * args[4][:, None, :]
    assert lat["live"] == sum(int((x > args[8][l]).sum()) for l in range(2, lmax + 1))


def test_rec_nodes_per_thread():
    assert [tcls.rec_nodes_per_thread(n) for n in (1, 512, 513, 2048, 4096)] == \
        [2, 2, 4, 8, 16]
    with pytest.raises(ValueError):
        tcls.rec_nodes_per_thread(tcls.REC_MAX_NODES + 1)


# ---- K5 ----

LANE_DP = tten.LMAXT + 1


def _lane_constants(k):
    """What csrc/tensors.cu:ladder_of sets once per thread."""
    lane = torch.arange(32)
    l = torch.where(lane < LANE_DP, lane, lane - LANE_DP).to(F64)
    return dict(l=l, lp1=l + 1.0, coef=k[:, None] / (2.0 * l + 1.0), first=l == 0,
                pol=lane >= LANE_DP,
                closure1=(lane == tten.LMAXT) | (lane == LANE_DP + tten.LMAXTP),
                closure2=lane == tten.LMAXTN, live1=lane <= LANE_DP + tten.LMAXTP,
                live2=lane <= tten.LMAXTN)


def _to_lanes(y):
    """(C, nk, NVAR_T) -> h, h' (C, nk) and the two multipole slots (C, nk, 32)."""
    m1 = torch.zeros(y.shape[:-1] + (32,), dtype=y.dtype)
    m2 = torch.zeros_like(m1)
    m1[..., :LANE_DP] = y[..., tten._I_DT0:tten._I_DP0]
    m1[..., LANE_DP:LANE_DP + tten.LMAXTP + 1] = y[..., tten._I_DP0:tten._I_DN0]
    m2[..., :tten.LMAXTN + 1] = y[..., tten._I_DN0:]
    return [y[..., tten._I_HT], y[..., tten._I_HTP], m1, m2]


def _from_lanes(st):
    ht, htp, m1, m2 = st
    return torch.cat([ht[..., None], htp[..., None], m1[..., :LANE_DP],
                      m1[..., LANE_DP:LANE_DP + tten.LMAXTP + 1],
                      m2[..., :tten.LMAXTN + 1]], -1)


def _rhs_lanes(st, q, k, fb, L):
    """csrc/tensors.cu:rhs in torch: st = (h, h', slot 1, slot 2)."""
    ht, htp, m1, m2 = st
    Q = lambda f: q[:, f:f + 1]
    opac, tau = Q(tten.QT_OPAC), Q(tten.QT_TAU)
    tau_safe = torch.clamp(tau, min=1e-10)
    inv3opac = 1.0 / (3.0 * torch.clamp(opac, min=1e-30))     # the row's fields
    clt, clp = (tten.LMAXT + 1) / tau_safe, (tten.LMAXTP + 1) / tau_safe
    rsa = k * tau >= tten.RSA_KTAU_T
    tc = Q(tten.QT_TC) > 0.5
    e = lambda v: v[..., None]
    # broadcasts and neighbour shuffles
    dt0, dt2, dt4 = m1[..., 0], m1[..., 2], m1[..., 4]
    dp0, dp2, dp4 = m1[..., LANE_DP], m1[..., LANE_DP + 2], m1[..., LANE_DP + 4]
    dn0, dn2, dn4 = m2[..., 0], m2[..., 2], m2[..., 4]
    up1, next1 = torch.roll(m1, 1, -1), torch.roll(m1, -1, -1)
    up2, next2 = torch.roll(m2, 1, -1), torch.roll(m2, -1, -1)
    pi_t = dt0 * 0.1 + dt2 * (1.0 / 7.0) + (3.0 / 70.0) * dt4
    psi_full = pi_t - 0.6 * dp0 + (6.0 / 7.0) * dp2 - (3.0 / 70.0) * dp4
    psi = torch.where(tc, -htp * inv3opac, psi_full)
    pi_n = dn0 * 0.1 + dn2 * (1.0 / 7.0) + (3.0 / 70.0) * dn4
    pi_g = torch.where(tc, 0.0, pi_t)
    stress = (16.0 / 3.0) * (Q(tten.QT_GG) * pi_g + Q(tten.QT_GN) * pi_n)
    stress = torch.where(rsa | (not fb), 0.0, stress)
    dhtp = -2.0 * Q(tten.QT_ADOTOA) * htp - k * k * ht + stress
    prev1 = torch.where(L["first"], 0.0, up1)
    gen1 = L["coef"] * (L["l"] * prev1 - L["lp1"] * next1) - e(opac) * m1
    src1 = torch.where(L["pol"], e(-(opac * psi)), e(-htp + opac * psi))
    clo1 = e(k) * prev1 - torch.where(L["pol"], e(clp), e(clt)) * m1 - e(opac) * m1
    v1 = torch.where(L["closure1"], clo1, torch.where(L["first"], gen1 + src1, gen1))
    dm1 = torch.where(e(tc | rsa) | ~L["live1"], 0.0, v1)
    prev2 = torch.where(L["first"], 0.0, up2)
    gen2 = L["coef"] * (L["l"] * prev2 - L["lp1"] * next2)
    clo2 = e(k) * prev2 - e(clt) * m2
    v2 = torch.where(L["closure2"], clo2, torch.where(L["first"], gen2 + e(-htp), gen2))
    dm2 = torch.where(e(rsa) | ~L["live2"], 0.0, v2)
    return [htp, dhtp, dm1, dm2], torch.where(rsa, 0.0, psi)


def _evolve_lanes(qtab, k, fb, savings=True):
    """csrc/tensors.cu's step loop in the lane layout. With `savings` a step
    takes its first RHS evaluation from the step before's source evaluation
    where the rows repeat, and is not integrated where no lane is released
    at its tau_b (the kernel decides per warp, a lane); without, it
    evaluates and integrates every step, as the plain version does."""
    C, S, R = qtab.shape[0], qtab.shape[1], qtab.shape[2]
    substeps = (R - 1) // 3
    L = _lane_constants(k)
    out = torch.empty(len(tten.T_PLANES), C, S, k.shape[0], dtype=F64)
    y0 = _to_lanes(tten._initial_state(C, k.shape[0], F64, "cpu"))
    y = y0
    kd, reuse = None, False
    ax = lambda u, h, d: [a + hh * b for a, hh, b in zip(u, h, d)]
    ex = lambda h: [h, h, h[..., None], h[..., None]]
    for i in range(S):
        qf = qtab[:, i, R - 1]
        released = k * qf[:, tten.QT_TAU:tten.QT_TAU + 1] >= tten.RELEASE_KTAU_T
        if savings and not bool(released.any()):
            y = y0
        else:
            for sub in range(substeps):
                qa, qm, qb = (qtab[:, i, 3 * sub + r] for r in range(3))
                if not (savings and sub == 0 and reuse):
                    kd, _ = _rhs_lanes(y, qa, k, fb, L)
                dt = qb[:, tten.QT_TAU:tten.QT_TAU + 1] - qa[:, tten.QT_TAU:tten.QT_TAU + 1]
                h2, h6 = 0.5 * dt, dt * (1.0 / 6.0)
                acc = kd
                k2, _ = _rhs_lanes(ax(y, ex(h2), kd), qm, k, fb, L)
                acc = [a + 2.0 * b for a, b in zip(acc, k2)]
                k3, _ = _rhs_lanes(ax(y, ex(h2), k2), qm, k, fb, L)
                acc = [a + 2.0 * b for a, b in zip(acc, k3)]
                k4, _ = _rhs_lanes(ax(y, ex(dt), k3), qb, k, fb, L)
                y = [a + h * (b + c) for a, h, b, c in zip(y, ex(h6), acc, k4)]
            rel = [released, released, released[..., None], released[..., None]]
            y = [torch.where(r, a, b) for r, a, b in zip(rel, y, y0)]
        kd, psi = _rhs_lanes(y, qf, k, fb, L)
        reuse = i + 1 < S and torch.equal(qtab[:, i + 1, 0], qf)
        vis, expmk = qf[:, tten.QT_VIS:tten.QT_VIS + 1], qf[:, tten.QT_EXPMK:tten.QT_EXPMK + 1]
        out[0, :, i] = -y[1] * expmk + vis * psi
        out[1, :, i] = vis * psi
        out[2, :, i] = y[0]
    return out


@pytest.fixture(scope="module")
def tensor_tables():
    """Two chains on a 2048-step grid; their stage tables (1 and 2
    substeps)."""
    ombh2, omch2, H0 = np.array([0.02237, 0.0215]), np.array([0.12, 0.115]), \
        np.array([67.4, 66.0])
    bg = BackgroundParams.make(ombh2=ombh2, omch2=omch2, H0=H0, nchains=2,
                               device="cpu", dtype=F64)
    yhe = torch.tensor([0.245, 0.240], dtype=F64)
    th = trec.compute_thermo(bg, yhe, n_z=1500)
    zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64), yhe)
    tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=2048)
    return {s: tten._stage_table(bg, tf, s) for s in (1, 2)}


def test_tensor_stage_rows_repeat_across_steps(tensor_tables):
    """A step's first row is the row of the previous step's tau_b, field for
    field: there csrc/tensors.cu takes the step's first RHS evaluation from
    the previous step's source evaluation."""
    for substeps, q in tensor_tables.items():
        assert torch.equal(q[:, 1:, 0], q[:, :-1, -1]), substeps
        assert not torch.equal(q[:, 1:, 1], q[:, :-1, -1])


@pytest.mark.parametrize("step", [5, 300, 900, 2000])
@pytest.mark.parametrize("fb", [True, False])
def test_tensor_lane_rhs_matches_rhs(tensor_tables, step, fb):
    """Rows in tight coupling, around recombination, free streaming and late
    (past the freeze for the top k); a random state."""
    q = tensor_tables[1][:, step, 1]
    k = torch.as_tensor(tten.tensor_k_grid(nk=16), dtype=F64)
    rng = np.random.default_rng(step)
    y = torch.tensor(rng.standard_normal((2, 16, tten.NVAR_T)), dtype=F64)
    dy, psi = tten._tensor_rhs(y, q, k, fb)
    got, psi_l = _rhs_lanes(_to_lanes(y), q, k, fb, _lane_constants(k))
    assert not got[2][..., LANE_DP + tten.LMAXTP + 1:].any()
    assert not got[3][..., tten.LMAXTN + 1:].any()
    got = _from_lanes(got)
    for j in range(tten.NVAR_T):
        assert rel_err(got[..., j], dy[..., j]) <= 1e-12 or \
            float(dy[..., j].abs().max()) == 0.0 == float(got[..., j].abs().max()), j
    assert rel_err(psi_l, psi) <= 1e-12 or float(psi.abs().max()) == 0.0 == \
        float(psi_l.abs().max())
    ktau = k * q[:, tten.QT_TAU:tten.QT_TAU + 1]
    if step == 2000:
        assert bool((ktau >= tten.RSA_KTAU_T).any()) and \
            bool((ktau < tten.RSA_KTAU_T).any())


@pytest.mark.parametrize("substeps,first", [(1, 0), (1, 1240), (1, 1370), (2, 0),
                                            (2, 1370)])
def test_tensor_lane_steps_match_evolve_plain(tensor_tables, substeps, first):
    """40 RK4 steps of 8 k, with 1 and 2 substeps: from the grid's start
    (the small k held, the large released; tight coupling ending), across
    the release of the smallest k, and across the freeze of the largest;
    and the same bits without the kernel's two savings (the reused
    evaluation, the held steps not integrated)."""
    q = tensor_tables[substeps][:, first:first + 40].contiguous()
    k = torch.as_tensor(tten.tensor_k_grid(nk=8), dtype=F64)
    ref = tten._evolve_t_plain(q, k, substeps, True)
    with torch.no_grad():
        got = _evolve_lanes(q, k, True)
        full = _evolve_lanes(q, k, True, savings=False)
    assert torch.equal(got, full)
    for p, name in enumerate(tten.T_PLANES):
        assert rel_err(got[p], ref[p]) <= 1e-12, name
    ktau = k * q[:, :, -1, tten.QT_TAU:tten.QT_TAU + 1]
    regime = {0: (ktau < tten.RELEASE_KTAU_T) & (q[:, :, -1, tten.QT_TC:tten.QT_TC + 1] > 0.5),
              1240: ktau < tten.RELEASE_KTAU_T, 1370: ktau >= tten.RSA_KTAU_T}[first]
    assert bool(regime.any()) and not bool(regime.all())
