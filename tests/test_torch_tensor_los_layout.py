"""The layout of the K6 kernel (csrc/tensor_los.cu), transcribed into torch
and held against the plain version it must reproduce (CPU, float64, small
sizes made from a numpy seed).

The transcription walks the kernel's work items in its order (octet groups
from the lowest l, k blocks from the top down, chains innermost), finds each
item's last live node as the kernel's block does, forms the per-(k, tau)
records of each tile of tau (table index and fraction, the six coefficients
with j_l'' folded in), and sums each (l, k) over the tiles in order, warp by
warp (the item's octets of 8 l's x 8 k), skipping the nodes where the
group's first l is dead at the warp's largest k. It must equal `_tlos_plain` to 1e-12 of
each maximum (the sums are taken in another order and j_l'' is folded), and
the walk with the skips must equal the walk without them bit for bit.
Also: n0(l), the first non-zero index of the real tables, and the packed
pair table; the live-lattice counter against a brute-force count; and the
tables and grids that `compute_tensor_transfers` passes to its LOS are the
same objects on a repeat call (nothing is built or uploaded again).
"""

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch.models import tensors as tten
from cosmomc_tpu_torch.models.bessel import build_bessel_table, default_l_samples

F64 = torch.float64
TT = 16          # tau nodes a tile in float64 (csrc/tensor_los.cu Tile)
KW = tten.TLOS_KW  # fine k a warp


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


def _problem(chains, nkf, nt, ls, seed=0):
    """Random sources on 10 coarse k, the fine grid kf in [1e-3, 0.02] (x
    up to ~300, so the high l's are mostly dead), tau0 - tau falling to 0
    at the last node (the chains' distances differ by up to 3%)."""
    rng = np.random.default_rng(seed)
    coarse = np.exp(np.linspace(np.log(5e-4), np.log(0.03), 10))
    kf = np.linspace(1e-3, 0.02, nkf)
    chi = np.linspace(15000.0, 0.0, nt)[None] * np.linspace(1.0, 0.97, chains)[:, None]
    tabs = tten.tlos_tables(tuple(ls), 0.02 * 15000.0 * 1.02 + 10, "cpu")
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64)
    lo, hi, w = tten._k_stencil(torch.log(f(coarse)), torch.log(f(kf)))
    return (f(rng.standard_normal((chains, 2, len(coarse), nt))), lo, hi, w, f(kf),
            f(chi), f(rng.uniform(0.5, 1.5, (chains, nt))), tabs["jl"], tabs["jlp"],
            f(np.asarray(ls, np.float64)), 1.0 / tabs["dx"]), tabs


def _index(x, inv_dx, nx):
    return (x * inv_dx).to(torch.int64).clamp(0, nx - 2)


def _walk_as_kernel(src, lo, hi, w, kf, chi, wt, jl, jlp, ls, inv_dx, tabs, skip=True):
    """csrc/tensor_los.cu in torch; returns (out (3, C, nl, nkf), the points
    walked: 64 per (warp, octet, node) computed)."""
    C, _, _, N = src.shape
    nl, nx = jl.shape
    nkf = kf.shape[0]
    pairs = tabs["pairs"].to(F64)
    n0 = tabs["n0"].long()
    nslot = pairs.shape[1]
    noct = nslot // tten.TLOS_OCT
    ngroups = -(-noct // tten.TLOS_GROUP)
    nkb = -(-nkf // tten.TLOS_KT)
    out = torch.zeros(3, C, nl, nkf, dtype=F64)
    walked = 0
    for item in range(C * nkb * ngroups):
        c, p = item % C, item // C
        g, kb = p // nkb, nkb - 1 - p % nkb
        k0 = kb * tten.TLOS_KT
        nkt = min(tten.TLOS_KT, nkf - k0)
        # the block's last node where its group's first l is live at its largest k
        n0g = n0[g * tten.TLOS_GROUP * tten.TLOS_OCT]
        live = torch.nonzero(_index(kf[k0 + nkt - 1] * chi[c], inv_dx, nx) + 1 >= n0g)
        t_end = (int(live.max()) + 1 if len(live) else 0) if skip else N
        # the records of the block's 32 k (k past the grid: zeros)
        kk = k0 + torch.arange(tten.TLOS_KT).clamp(max=nkt - 1)
        k_ok = torch.arange(tten.TLOS_KT) < nkt
        t = torch.arange(t_end)
        S = src[c][:, :, :t_end]
        a, b = S[0, lo[kk].long()], S[1, lo[kk].long()]           # (32, t)
        wk = w[kk][:, None]
        sTw = (a + wk * (S[0, hi[kk].long()] - a)) * wt[c, t]
        sPw = (b + wk * (S[1, hi[kk].long()] - b)) * wt[c, t]
        x = kf[kk][:, None] * chi[c, t]
        tt = x * inv_dx
        i = tt.to(torch.int64).clamp(0, nx - 2)
        inv = 1.0 / torch.clamp(x, min=1e-8)
        inv2 = inv * inv
        z = lambda v: torch.where(k_ok[:, None], v, 0.0)
        rec = dict(i=torch.where(k_ok[:, None], i, 0), f=z(tt - i.to(F64)), cT=z(sTw * inv2),
                   B=z(sPw * inv2), cE=z(sPw * (2.0 * inv2 - 2.0)), cPE=z(2.0 * sPw * inv),
                   cPB=z(2.0 * sPw), cJB=z(4.0 * sPw * inv))
        for warp in range(tten.TLOS_KT // KW):
            kw_lo, kw_hi = warp * KW, min(warp * KW + KW, nkt) - 1
            if kw_hi < kw_lo:
                continue
            ks = torch.arange(kw_lo, kw_lo + KW)                      # 8 local k
            for o in range(tten.TLOS_GROUP):
                oct_ = g * tten.TLOS_GROUP + o
                if oct_ >= noct:
                    continue
                slots = oct_ * tten.TLOS_OCT + torch.arange(tten.TLOS_OCT)
                l = torch.where(slots < nl, ls[slots.clamp(max=nl - 1)], 0.0)[:, None]
                llp1 = l * (l + 1.0)
                acc = torch.zeros(3, tten.TLOS_OCT, KW, dtype=F64)
                for t0 in range(0, t_end, TT):
                    for tl in range(min(TT, t_end - t0)):
                        tn = t0 + tl
                        if skip and rec["i"][kw_hi, tn] + 1 < n0g:
                            continue
                        walked += tten.TLOS_OCT * KW
                        r = {n: v[ks, tn][None] for n, v in rec.items()}
                        e = pairs[r["i"][0]][:, slots].permute(1, 0, 2)  # (8 l, 8 k, 4)
                        jv = e[..., 0] + r["f"] * (e[..., 2] - e[..., 0])
                        jp = e[..., 1] + r["f"] * (e[..., 3] - e[..., 1])
                        acc[0] += jv * r["cT"]
                        acc[1] += jv * (r["cE"] + llp1 * r["B"])
                        acc[1] += jp * r["cPE"]
                        acc[2] += jp * r["cPB"]
                        acc[2] += jv * r["cJB"]
                efac = torch.sqrt(torch.clamp((l + 2) * (l + 1) * l * (l - 1), min=0.0))
                kl = ks[ks < nkt]
                for s_ in range(tten.TLOS_OCT):
                    if slots[s_] >= nl:
                        continue
                    out[0, c, slots[s_], k0 + kl] = efac[s_] * acc[0, s_, kl - kw_lo]
                    out[1, c, slots[s_], k0 + kl] = acc[1, s_, kl - kw_lo]
                    out[2, c, slots[s_], k0 + kl] = acc[2, s_, kl - kw_lo]
    return out, walked


#: ~12 sampled l's (two octets, one group; several mostly or wholly dead at
#: x <= ~300), and 30 (four octets, two groups, the second part-filled)
L_SETS = {"12 l": [2, 3, 5, 8, 12, 20, 40, 80, 150, 250, 400, 700],
          "30 l": list(range(2, 22)) + [30, 45, 60, 90, 120, 160, 200, 260, 330, 420]}


@pytest.mark.parametrize("lset", sorted(L_SETS))
def test_kernel_walk_matches_plain(lset):
    """2 chains, 45 fine k (a 32-k item and a ragged one of 13), 40 tau
    nodes (tiles of 16, 16 and 8)."""
    args, tabs = _problem(2, 45, 40, L_SETS[lset])
    walk, walked = _walk_as_kernel(*args, tabs)
    full, walked_all = _walk_as_kernel(*args, tabs, skip=False)
    plain = tten._tlos_plain(*args)
    for p in range(3):
        assert rel_err(walk[p], plain[p]) <= 1e-12, (lset, p)
    assert torch.equal(walk, full), "the skips change no bit"
    # one group whose first l (2) is always live skips nothing; two do
    assert walked < walked_all if lset == "30 l" else walked == walked_all
    src, lo, hi, w, kf, chi, wt, jl, jlp, ls, inv_dx = args
    lat = tten.tlos_lattice(chi, kf, tabs["n0"], jl.shape[0], jl.shape[1], inv_dx)
    assert lat["walked"] == walked
    assert lat["live"] < lat["lattice"]


def test_first_live_index_of_the_main_path_tables():
    """n0(l) of the real tables (default_l_samples(700), the main path's
    xmax) is each row's first non-zero index and does not decrease; below
    it a point's four table entries are 0; the pair table holds (j_l(x_i),
    j_l'(x_i), j_l(x_{i+1}), j_l'(x_{i+1})) with zero pad slots."""
    ls = tuple(int(l) for l in default_l_samples(700))
    tab = build_bessel_table(ls, 0.065 * 14700.0 * 1.02 + 10)
    n0 = tten.first_live_index(tab.jl, tab.jlp)
    for r in range(len(ls)):
        assert n0[r] == np.flatnonzero((tab.jl[r] != 0) | (tab.jlp[r] != 0))[0]
    assert (np.diff(n0) >= 0).all()
    assert n0[0] == 1 and n0[-1] > 2000
    pairs, n0s = tten.pair_table(tab.jl, tab.jlp)
    nx = tab.jl.shape[1]
    assert pairs.shape == (nx - 1, 72, 4) and pairs.dtype == np.float32
    assert np.array_equal(n0s[:65], n0) and (n0s[65:] == nx).all()
    assert np.array_equal(pairs[:, :65, 0], tab.jl[:, :-1].T)
    assert np.array_equal(pairs[:, :65, 3], tab.jlp[:, 1:].T)
    assert not pairs[:, 65:].any()
    i = np.arange(nx - 1)
    dead = i[None, :] + 1 < n0[:, None]
    assert not pairs[:, :65][dead.T].any()


@pytest.mark.parametrize("lset", sorted(L_SETS))
def test_lattice_counter_matches_brute_force(lset):
    args, tabs = _problem(2, 45, 40, L_SETS[lset], seed=1)
    _, _, _, _, kf, chi, _, jl, jlp, ls, inv_dx = args
    nl, nx = jl.shape
    lat = tten.tlos_lattice(chi, kf, tabs["n0"], nl, nx, inv_dx)
    live = 0
    n0 = tabs["n0"].tolist()
    for c in range(chi.shape[0]):
        i = _index(kf[:, None] * chi[c][None, :], inv_dx, nx)   # (k, tau)
        for il in range(nl):
            is_live = i + 1 >= n0[il]
            live += int(is_live.sum())
            for tab in (jl, jlp):
                for j in (i, i + 1):
                    assert not tab[il][j][~is_live].any(), "a dead point reads 0"
    assert lat["live"] == live
    assert lat["lattice"] == chi.shape[0] * nl * kf.shape[0] * chi.shape[1]


def test_repeat_call_builds_and_uploads_nothing(monkeypatch):
    """Two compute_tensor_transfers calls hand their LOS the same table,
    grid and stencil tensors, and return the same ls, kf and wk."""
    seen = []
    real = tten._tlos_plain

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(tten, "_tlos_plain", spy)
    rng = np.random.default_rng(2)
    kt = tten.tensor_k_grid()
    N = 24
    tau = torch.as_tensor(np.linspace(1.0, 14000.0, N)[None], dtype=F64)
    to = tten.TensorOutput(tau=tau, k=torch.as_tensor(kt, dtype=F64),
                           sT=torch.as_tensor(rng.standard_normal((1, len(kt), N))),
                           sP=torch.as_tensor(rng.standard_normal((1, len(kt), N))),
                           tau0=torch.tensor([14000.0], dtype=F64))
    one = tten.compute_tensor_transfers(to, lmax=100, coarse_k=kt)
    two = tten.compute_tensor_transfers(to, lmax=100)
    assert len(seen) == 2
    for pos in (1, 2, 3, 4, 7, 8, 9):    # lo, hi, w, kf, jl, jlp, ls
        assert seen[0][pos] is seen[1][pos], pos
    for f in ("ls", "kf", "wk"):
        assert getattr(one, f) is getattr(two, f)
    assert torch.equal(one.dT, two.dT)
