"""Port parity of K2a's gradient (the table line-of-sight integral), float64
on the CPU.

1. The port's `compute_cl_transfers` (the plain version under autograd, the
   CPU's path) against `jax.vjp` of the JAX package's
   `cosmomc_tpu/models/cls.py:compute_cl_transfers` along a seeded
   cotangent on Delta_T, Delta_E, Delta_P: the cotangents of every input
   (the four source planes on the coarse k grid, the tau grid, tau0 and
   chi_star), each to 1e-10 of its largest magnitude. Smooth sources from
   a seed: 2 chains, 16 coarse k to 0.03/Mpc, 96 tau nodes, lmax 300. In
   the "small_x" case the second chain's last tau node is its tau0, so x =
   k (tau0 - tau) = 0 < 1e-8 there (max(x, 1e-8) passes no gradient) and
   chi is held at 1e-6 in the lensing kernel.
2. The reverse kernel's algorithm (csrc/cls.cu los_bwd) transcribed in
   torch, block for block: the ten per-point sums over l against the table
   values and differences, the cotangents of the weighted sources and of
   x, the butterfly sums over a block's 32 k, the transposed stencil with
   its host-built partial rows (`transposed_stencil`) added in block order;
   against autograd of `_los_plan_plain` on the same inputs with a
   cotangent on every output entry (the padded l and k too), 1e-12.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import cls as jcls
from cosmomc_tpu.models.perturbations import PerturbationOutput as JPO

from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models.perturbations import PerturbationOutput as TPO

F64 = torch.float64
RTOL = 1e-10
LMAX = 300
KMAX = 0.03
TAU0_HINT = 14200.0
K = np.geomspace(2e-4, KMAX, 16)
NT = 96
INPUTS = ("s0", "s1", "s2", "slens", "tau", "tau0", "chi_star")
LOS = dict(lmax=LMAX, tau0_hint=TAU0_HINT, kmax_hint=KMAX)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(small_x: bool):
    """Two chains of smooth sources on their own tau grids, and seeded
    cotangents of the three transfer planes."""
    rng = np.random.default_rng(16 + small_x)
    C = 2
    tau0 = np.array([14100.0, 13950.0]) + rng.uniform(-20, 20, C)
    tau = np.stack([np.concatenate([np.geomspace(150.0, 900.0, NT // 2),
                                    np.linspace(1000.0, t0 - 30.0, NT // 2)])
                    for t0 in tau0])
    if small_x:
        tau[1, -1] = tau0[1]
    tt = tau[:, None, :]
    kk = K[None, :, None]
    src = {}
    for i, name in enumerate(("s0", "s1", "s2", "slens")):
        a = rng.uniform(0.5, 1.5, (C, 1, 1))
        ph = rng.uniform(0, 2 * np.pi, (C, 1, 1))
        src[name] = a * (np.exp(-((tt - 280.0) / (40.0 + 10 * i)) ** 2)
                         * np.cos(kk * tt / (3.0 + i) + ph)
                         + 0.05 * np.exp(-tt / 4000.0) * np.sin(kk * 500.0 + ph))
    chi_star = tau0 - 280.0 + rng.uniform(-5, 5, C)
    nl = len(tcls.default_l_samples(LMAX))
    nkf = len(tcls.fine_k_grid(TAU0_HINT, KMAX))
    g = rng.standard_normal((3, C, nl, nkf))
    return dict(tau=tau, tau0=tau0, chi_star=chi_star, g=g, **src)


def _jax_vjp(d):
    """jax.vjp of the JAX compute_cl_transfers, one chain at a time."""
    out = {n: [] for n in INPUTS}
    nk = len(K)
    for c in range(d["tau"].shape[0]):
        def f(s0, s1, s2, slens, tau, tau0, chi_star):
            z = jnp.zeros(nk)
            po = JPO(tau=tau, k=jnp.asarray(K), s0=s0, s1=s1, s2=s2, spol=s2,
                     slens=slens, delta_m=z, r_init=z, tau0=tau0,
                     delta_m_z=z[None], growth_tau=tau)
            clt = jcls.compute_cl_transfers(po, chi_star, coarse_k=K, **LOS)
            return clt.dT, clt.dE, clt.dP
        args = [jnp.asarray(d[n][c]) for n in INPUTS]
        _, vjp = jax.vjp(f, *args)
        grads = vjp(tuple(jnp.asarray(d["g"][q, c]) for q in range(3)))
        for n, gr in zip(INPUTS, grads):
            out[n].append(np.asarray(gr))
    return {n: np.stack(v) for n, v in out.items()}


def _port_grad(d):
    t = {n: torch.tensor(d[n], dtype=F64, requires_grad=True) for n in INPUTS}
    C = t["tau"].shape[0]
    z = torch.zeros(C, len(K), dtype=F64)
    po = TPO(tau=t["tau"], k=torch.tensor(K, dtype=F64), s0=t["s0"],
             s1=t["s1"], s2=t["s2"], spol=t["s2"], slens=t["slens"],
             delta_m=z, r_init=z, tau0=t["tau0"], delta_m_z=z[:, None],
             growth_tau=t["tau"], ddelta_m_z=z[:, None], weyl_z=z[:, None],
             aH_z=z[:, :1])
    clt = tcls.compute_cl_transfers(po, t["chi_star"], coarse_k=K, **LOS)
    g = torch.tensor(d["g"], dtype=F64)
    loss = (clt.dT * g[0]).sum() + (clt.dE * g[1]).sum() + (clt.dP * g[2]).sum()
    grads = torch.autograd.grad(loss, [t[n] for n in INPUTS])
    return {n: gr.numpy() for n, gr in zip(INPUTS, grads)}


@pytest.fixture(scope="module", params=["regular", "small_x"])
def both(request):
    d = _case(request.param == "small_x")
    return _port_grad(d), _jax_vjp(d)


@pytest.mark.parametrize("name", INPUTS)
def test_cotangent_matches_jax_vjp(both, name):
    port, ref = both
    a, b = port[name], ref[name]
    assert a.shape == b.shape
    scale = np.abs(b).max()
    assert scale > 0 and np.isfinite(a).all()
    err = np.abs(a - b).max() / scale
    assert err <= RTOL, f"{name}: rel err {err:.3e}"


# ---------------------------------------------------------------------------
# the reverse kernel's algorithm, transcribed


def _los_bwd_transcribed(src, dp, chi_arg, wt, wl, inv_dx, g):
    """csrc/cls.cu los_bwd in torch: blocks of LOS_KT fine k (the lanes),
    every tau node of a block at once, l walked in order."""
    C, _, nk, nt = src.shape
    idx, w, kf, ls, packed = dp["idx"].long(), dp["w"], dp["kf"], dp["ls"], dp["packed"]
    nl, nx, _ = packed.shape
    nkf, KT = kf.shape[0], tcls.LOS_KT
    nkb = -(-nkf // KT)
    blk_off, row_kb = dp["blk_off"].long(), dp["row_kb"].long()
    tab = packed.double()
    efac = torch.sqrt(torch.clamp((ls + 2) * (ls + 1) * ls * (ls - 1), min=0.0))
    llp1 = ls * (ls + 1)
    part_src = torch.zeros(C, 4, dp["rtot"], nt, dtype=F64)
    part_w = torch.zeros(C, nkb, 3, nt, dtype=F64)
    for c in range(C):
        for kb in range(nkb):
            k0 = kb * KT
            nkt = min(KT, nkf - k0)
            ks = torch.arange(k0, k0 + nkt)
            r_lo, r_hi = int(idx[k0, 0]), int(idx[k0 + nkt - 1, 3])
            x = kf[ks][:, None] * chi_arg[c][None, :]             # (nkt, nt)
            tt = x * inv_dx
            i = tt.to(torch.int64).clamp(0, nx - 2)
            f = tt - i.to(F64)
            GT = g[0, c][:, ks]                                   # (nl, nkt)
            GLE = GT * llp1[:, None] + g[1, c][:, ks] * efac[:, None]
            GP = g[2, c][:, ks]
            cs = torch.zeros(4, nkt, nt, dtype=F64)
            bs = torch.zeros(4, nkt, nt, dtype=F64)
            for il in range(nl):
                a, b = tab[il][i], tab[il][i + 1]                 # (nkt, nt, 2)
                dj, dpp = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
                gt, gle, gp = GT[il][:, None], GLE[il][:, None], GP[il][:, None]
                cs += torch.stack([gt * a[..., 0], gt * a[..., 1],
                                   gle * a[..., 0], gp * a[..., 0]])
                bs += torch.stack([gt * dj, gt * dpp, gle * dj, gp * dj])
            a1, a2, a3, a5 = cs + f * bs
            b1, b2, b3, b5 = bs
            inv = 1.0 / torch.clamp(x, min=1e-8)
            inv2 = inv * inv
            dinv = torch.where(x > 1e-8, -inv2, torch.zeros_like(x))
            s = [sum(w[ks, m][:, None] * src[c, p][idx[ks, m]]
                     for m in range(4)) for p in range(4)]
            wtt, wlt = wt[c][None, :], wl[c][None, :]
            A0, A1, AL = a1, a2, a5
            A2 = -2.0 * inv * a2 + inv2 * a3 - a1
            AX = inv_dx * (s[0] * wtt * b1 + s[1] * wtt * b2
                           + s[2] * wtt * (-2.0 * inv * b2 + inv2 * b3 - b1)
                           + s[3] * wlt * b5) \
                + s[2] * wtt * dinv * (-2.0 * a2 + 2.0 * inv * a3)
            part_w[c, kb, 0] = (kf[ks][:, None] * AX).sum(0)
            part_w[c, kb, 1] = (A0 * s[0] + A1 * s[1] + A2 * s[2]).sum(0)
            part_w[c, kb, 2] = (AL * s[3]).sum(0)
            B = torch.stack([A0 * wtt, A1 * wtt, A2 * wtt, AL * wlt])  # (4, nkt, nt)
            for rr in range(r_hi - r_lo + 1):
                acc = torch.zeros(4, nt, dtype=F64)
                for kl in range(nkt):
                    for m in range(4):
                        if int(idx[k0 + kl, m]) - r_lo == rr:
                            acc += w[k0 + kl, m] * B[:, kl]
                part_src[c, :, int(blk_off[kb]) + rr] = acc
    g_src = torch.zeros_like(src)
    for r in range(nk):
        for kb in range(int(row_kb[r, 0]), int(row_kb[r, 1]) + 1):
            g_src[:, :, r] += part_src[:, :, int(blk_off[kb]) + r - int(idx[kb * KT, 0])]
    g_chi, g_wt, g_wl = part_w.sum(1).unbind(1)
    return g_src, g_chi, g_wt, g_wl


@pytest.fixture(scope="module")
def transcribed():
    d = _case(True)
    key = (LMAX, TAU0_HINT, KMAX, 4.0, 256, tuple(K.tolist()))
    plan = tcls._plan(*key)
    dp = tcls._device_plan(key, "cpu", F64)
    C = d["tau"].shape[0]
    z = torch.zeros(C, len(K), dtype=F64)
    t = {n: torch.tensor(d[n], dtype=F64) for n in INPUTS}
    po = TPO(tau=t["tau"], k=torch.tensor(K, dtype=F64), s0=t["s0"],
             s1=t["s1"], s2=t["s2"], spol=t["s2"], slens=t["slens"],
             delta_m=z, r_init=z, tau0=t["tau0"], delta_m_z=z[:, None],
             growth_tau=t["tau"], ddelta_m_z=z[:, None], weyl_z=z[:, None],
             aH_z=z[:, :1])
    src, chi_arg, wt, wl = (a.detach().requires_grad_(True)
                            for a in tcls._los_inputs(po, t["chi_star"], 1))
    inv_dx = float(torch.tensor(1.0 / plan.dx, dtype=F64))
    out = tcls._los_plan_plain(src, dp, chi_arg, wt, wl, inv_dx)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(out.shape))
    ref = torch.autograd.grad((out * g).sum(), [src, chi_arg, wt, wl])
    with torch.no_grad():
        got = _los_bwd_transcribed(src, dp, chi_arg, wt, wl, inv_dx, g)
    return dict(zip(("src", "chi", "wt", "wl"), zip(got, ref)))


@pytest.mark.parametrize("name", ["src", "chi", "wt", "wl"])
def test_kernel_algorithm_matches_autograd(transcribed, name):
    got, ref = transcribed[name]
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 1e-12, f"{name}: rel err {err:.3e}"


def test_transposed_stencil_covers_each_stencil_once():
    """Every (fine k, stencil point) lands in exactly one block's partial
    row, and each coarse row's blocks are those whose range holds it."""
    plan = tcls._plan(LMAX, TAU0_HINT, KMAX, 4.0, 256, tuple(K.tolist()))
    idx = plan.idx
    blk_off, row_kb = tcls.transposed_stencil(idx, len(K))
    KT = tcls.LOS_KT
    nkb = -(-idx.shape[0] // KT)
    assert blk_off.shape == (nkb + 1,) and blk_off[0] == 0
    for r in range(len(K)):
        touching = [b for b in range(nkb)
                    if idx[b * KT, 0] <= r <= idx[min(b * KT + KT, idx.shape[0]) - 1, 3]]
        want = (touching[0], touching[-1]) if touching else (0, -1)
        assert tuple(row_kb[r]) == want
        assert touching == list(range(want[0], want[1] + 1))
    assert blk_off[-1] == sum(idx[min(b * KT + KT, idx.shape[0]) - 1, 3]
                              - idx[b * KT, 0] + 1 for b in range(nkb))
