"""The port's entry points default to the card, and the tables the host
builds for the K3 and K2a kernels, against the plain recurrences and
tables they replace (CPU, float64, small sizes).

- CMBPosterior and PlikLiteLikelihood built without device= take the card:
  without one they raise; device="cpu" builds them on the CPU.
- K3 (csrc/lensing.cu): the recurrence seeds continue the plain version's
  uninterrupted recurrences exactly, the per-l table holds the plain
  version's l-only quantities (1e-15 relative), and the kernel's algorithm
  (segments started from the seeds, per-l table, segment sums added in
  order) transcribed into torch reproduces _passes_plain to 1e-12 of each
  output's maximum.
- K2a (csrc/cls.cu): the packed Bessel table equals plan.jl / plan.jlp
  entry for entry, the row span that sizes the kernel's shared memory
  covers every block, and the kernel's folded j_l'' terms reproduce
  _los_plain to 1e-12.
"""

import math

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
from cosmomc_tpu_torch.models import cls as tcls
from cosmomc_tpu_torch.models import lensing as tlens
from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
from cosmomc_tpu_torch.models.cmb import source_k_grid
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
from cosmomc_tpu_torch.pipeline import CMBPosterior

F64 = torch.float64
L, N_THETA, NL_OUT = 300, 401, 240      # l = 2..301, 400 theta nodes


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


# ---- entry points ----

@pytest.fixture(scope="module")
def plik_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("plik_fid")
    l = np.arange(2, 2601, dtype=np.float64)
    damp = np.exp(-(l / 1400.0) ** 2)
    tt = 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0) ** 2)
    ee = 40.0 * damp * (l / 1000.0) * (1.0 + np.sin(np.pi * l / 300.0) ** 2)
    te = 0.4 * np.sqrt(tt * ee) * np.cos(np.pi * l / 150.0)
    path = str(d / "fid.theory_cl")
    np.savetxt(path, np.column_stack([l, tt, te, ee, 0 * l, 1e-7 + 0 * l]))
    return write_plik_lite_fiducial(str(d), path)


def _posterior(**kw):
    par = ThetaParameterization()
    return CMBPosterior(par, par.default_space(), LikelihoodList(),
                        bbn_table=synthetic_bbn_table(), **kw)


@pytest.mark.parametrize("entry", ["posterior", "plik_lite"])
def test_entry_points_default_to_the_card(entry, plik_dataset):
    build = ((lambda **kw: _posterior(**kw)) if entry == "posterior" else
             (lambda **kw: PlikLiteLikelihood(plik_dataset, **kw)))
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert build(device="cpu").device.type == "cpu"


# ---- K3 ----

def _spectra_cl(C=2):
    """(C, 4, L) CTT, CTE, CEE, Cphil3 as lens_cls hands them to the passes."""
    rng = np.random.default_rng(5)
    l = np.arange(2, L + 2, dtype=np.float64)
    out = []
    for a in 1.0 + 0.1 * rng.standard_normal(C):
        damp = np.exp(-(l / 1400.0) ** 2)
        tt = a * 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0) ** 2)
        ee = a * 40.0 * damp * (l / 1000.0) * (1 + np.sin(np.pi * l / 300.0) ** 2)
        te = 0.4 * np.sqrt(tt * ee) * np.cos(np.pi * l / 150.0)
        pp = a * 1.8e-7 * (l / 40.0) / (1.0 + (l / 40.0) ** 2) ** 1.2
        llp1, f = l * (l + 1), (2 * l + 1) / (4 * np.pi)
        conv = 2 * np.pi / llp1
        out.append([tt * conv * f, te * conv * f, ee * conv * f,
                    pp * (2 * np.pi / llp1 ** 2) * llp1 * f])
    return torch.tensor(np.array(out), dtype=F64)


def _advance(state, il, x):
    """One step of the plain version's recurrences (pass 2's expressions)."""
    pmm, pmmp1, *jac = state
    lc = float(il + 2)
    P = ((2 * lc - 1) * x * pmmp1 - (lc - 1) * pmm) / lc
    out = [pmmp1, P]
    for k, (_, a, b, shift) in enumerate(tlens.JACOBI):
        jm1, j = jac[2 * k], jac[2 * k + 1]
        out += [j, tlens._jacobi_advance(lc - shift, a, b, x, jm1, j)]
    return out


def test_lensing_seeds_continue_the_recurrence():
    seeds = tlens.recurrence_seeds(L, N_THETA)
    x = tlens.theta_table(N_THETA, True, "cpu")[tlens.TH_X]
    assert seeds.shape == (math.ceil(L / tlens.SEG), len(tlens.SEED_ROWS),
                           N_THETA - 1)
    assert torch.equal(seeds[0, 0], torch.ones_like(x))
    assert torch.equal(seeds[0, 1], x)
    for s in range(seeds.shape[0] - 1):
        state = list(seeds[s])
        for il in range(s * tlens.SEG, (s + 1) * tlens.SEG):
            state = _advance(state, il, x)
        assert torch.equal(torch.stack(state), seeds[s + 1]), s


def test_lensing_l_table_holds_the_plain_quantities():
    lt = tlens.l_table(L)
    col = {n: i for i, n in enumerate(tlens.L_COLS)}
    assert lt.shape == (L, len(tlens.L_COLS))
    for il in (0, 1, 2, 3, 57, L - 1):
        lc = float(il + 2)
        llp1, lfacs2 = lc * (lc + 1), (lc + 2) * (lc - 1)
        want = dict(l=lc, inv_l=1 / lc, llp1=llp1, inv_llp1=1 / llp1,
                    inv_lfacs2=1 / lfacs2,
                    inv_lrootfacs=1 / math.sqrt(llp1 * lfacs2),
                    rf1=math.sqrt(lfacs2), x220=math.sqrt(llp1 * lfacs2) / 4,
                    dx022=1 - llp1 / 4, c8=8 / llp1,
                    inv_sqrt_llp1=1 / math.sqrt(llp1))
        if lc >= 3:
            want["inv_rf2"] = 1 / math.sqrt((lc + 3) * (lc - 2))
        if lc >= 4:
            s4 = lc - 4
            want["inv_rf3"] = 1 / math.sqrt((lc - 3) * (lc + 4))
            want["norm04"] = math.sqrt(
                ((s4 + 5) * (s4 + 6) * (s4 + 7) * (s4 + 8))
                / ((s4 + 1) * (s4 + 2) * (s4 + 3) * (s4 + 4)))
        for name, v in want.items():
            assert abs(lt[il, col[name]] - v) <= 1e-15 * abs(v), (il, name)
    # each step of the Jacobi recurrences from the table's coefficients
    # (a product by 1/c1 where the plain version divides) against the plain
    # step on the same inputs
    x = torch.linspace(-0.999, 0.999, 57, dtype=F64)
    for name, a, b, shift in tlens.JACOBI:
        c2, c3, c4, ic1 = (lt[:, col[f"{name}_{c}"]] for c in
                           ("c2", "c3", "c4", "ic1"))
        jm1 = j = torch.zeros_like(x)
        for il in range(L):
            n = il + 2 - shift
            ref = tlens._jacobi_advance(float(n), a, b, x, jm1, j)
            if n >= 2:
                got = ((c2[il] + c3[il] * x) * j - c4[il] * jm1) * ic1[il]
                assert rel_err(got, ref) <= 1e-15, (name, il)
            else:
                assert ic1[il] == c2[il] == c3[il] == c4[il] == 0.0
            jm1, j = j, ref


def _passes_segmented(cl, th, nl_out, seg12):
    """csrc/lensing.cu's algorithm in torch: passes 1 and 2 per l segment
    from the seeds with the per-l table, segment sums added in order; pass
    3 per SEG block of l from the seeds."""
    C, _, Lc = cl.shape
    nth = th.shape[1]
    lt = torch.as_tensor(tlens.l_table(Lc))
    seeds = tlens.recurrence_seeds(Lc, nth + 1)
    col = {n: i for i, n in enumerate(tlens.L_COLS)}
    x, sinth, sin2, fac1, fac2, tail, sw = th
    inv_sin2, inv_fac1, inv_fac2, inv_sinth = 1 / sin2, 1 / fac1, 1 / fac2, 1 / sinth
    s2h2 = (fac1 / 2) ** 2
    sc2 = (fac1 / 2 * fac2 / 2) ** 2
    c4x8, fac4 = (4 * x - 8) / fac2, 4 * (fac1 / fac2)
    zeros = torch.zeros_like(x)

    def jac(n, a, b, jm1, j, r, name):
        if n < 0:
            return zeros
        if n == 0:
            return torch.ones_like(x)
        if n == 1:
            return (a + 1) + (a + b + 2) * (x - 1) / 2
        c = [r[col[f"{name}_{k}"]] for k in ("c2", "c3", "c4", "ic1")]
        return ((c[0] + c[1] * x) * j - c[2] * jm1) * c[3]

    def step(r, st):
        P = (r[col["two_lm1"]] * x * st[1] - r[col["lm1"]] * st[0]) * r[col["inv_l"]]
        return [st[1], P], P

    segs = range(0, Lc, seg12)
    p1 = []
    for il0 in segs:
        st = list(seeds[il0 // tlens.SEG, :2])
        sig = cg = torch.zeros(C, nth, dtype=F64)
        for il in range(il0, min(Lc, il0 + seg12)):
            r = lt[il]
            st, P = step(r, st)
            dP = r[col["l"]] * (st[0] - x * P) * inv_sin2
            d11 = fac1 * dP * r[col["inv_llp1"]] + P
            dm11 = fac2 * dP * r[col["inv_llp1"]] - P
            sig = sig + (1 - d11) * cl[:, 3, il, None]
            cg = cg + dm11 * cl[:, 3, il, None]
        p1.append((sig, cg))
    sg, g = p1[0]
    for a, b in p1[1:]:
        sg, g = sg + a, g + b

    p2 = []
    for il0 in segs:
        sd = seeds[il0 // tlens.SEG]
        st, jst = list(sd[:2]), [list(sd[2:4]), list(sd[4:6]), list(sd[6:8])]
        xi = [torch.zeros(C, nth, dtype=F64) for _ in range(4)]
        for il in range(il0, min(Lc, il0 + seg12)):
            r = lt[il]
            lci = il + 2
            st, P = step(r, st)
            J = []
            for k, (name, a, b, shift) in enumerate(tlens.JACOBI):
                v = jac(lci - shift, a, b, *jst[k], r, name)
                jst[k] = [jst[k][1], v]
                J.append(v)
            J40, J44, J80 = J
            g_ = lambda n: r[col[n]]
            dP = g_("l") * (st[0] - x * P) * inv_sin2
            d11 = fac1 * dP * g_("inv_llp1") + P
            dm11 = fac2 * dP * g_("inv_llp1") - P
            d22 = ((c4x8 + g_("llp1")) * P + fac4 * (fac2 + (x - 2) * g_("inv_llp1"))
                   * dP) * g_("inv_lfacs2")
            d2m2 = s2h2 * J40
            d20 = (2 * x * dP - g_("llp1") * P) * g_("inv_lrootfacs")
            sr1 = sinth * g_("inv_rf1")
            d1m2 = sr1 * (dP - 2 * inv_fac1 * dm11)
            d12 = sr1 * (dP - 2 * inv_fac2 * d11)
            sinfac = 4 * inv_sinth
            d1m3 = d2m3 = d3m3 = d13 = d04 = d2m4 = d4m4 = zeros
            if lci >= 3:
                d1m3 = (-(x + 0.5) * d1m2 * sinfac - g_("lfacs2") * dm11 * g_("inv_rf1")) * g_("inv_rf2")
                d2m3 = (-fac2 * d2m2 * sinfac - g_("rf1") * d1m2) * g_("inv_rf2")
                d3m3 = (-(x + 1.5) * d2m3 * sinfac - g_("rf1") * d1m3) * g_("inv_rf2")
                d13 = ((x - 0.5) * d12 * sinfac - g_("lfacs2") * d11 * g_("inv_rf1")) * g_("inv_rf2")
            if lci >= 4:
                d04 = g_("norm04") * sc2 * J44
                d2m4 = (-(6 * x + 4) * d2m3 * inv_sinth - g_("rf2") * d2m2) * g_("inv_rf3")
                d4m4 = s2h2 * s2h2 * J80
            X000 = torch.exp(-g_("llp1") * sg / 4)
            X022 = X000 * (1 + sg)
            X220, X121, X132 = g_("x220") * X000, g_("x121") * X000, g_("x132") * X000
            X242, dX000, dX022 = g_("x242") * X022, g_("dx000") * X000, g_("dx022") * X022
            fac1v, fac3, g2 = dX000 * dX000, X220 * X220, g * g
            f = ((X000 * X000 - 1) + g2 * fac1v) * P + g2 * fac3 * d2m2 + g_("c8") * fac1v * g * dm11
            xi[0] = xi[0] + cl[:, 0, il, None] * f
            fac2v = (g * dX022) ** 2 + (X022 * X022 - 1)
            f = 2 * g * X121 * X132 * d13 + fac2v * d22 + g2 * X242 * X220 * d04
            xi[1] = xi[1] + cl[:, 2, il, None] * f
            f = (fac3 * P + X242 * X242 * d4m4) * g2 / 2 + g * (X121 ** 2 * dm11 + X132 ** 2 * d3m3) + fac2v * d2m2
            xi[2] = xi[2] + cl[:, 2, il, None] * f
            f = ((X000 * X022 - 1) * d20 + 2 * dX000 * g * (X121 * d11 + X132 * d1m3) * g_("inv_sqrt_llp1")
                 + g2 * (X220 / 2 * d2m4 * X242 + (fac3 / 2 + dX022 * dX000) * d20))
            xi[3] = xi[3] + cl[:, 1, il, None] * f
        p2.append(xi)
    xis = p2[0]
    for part in p2[1:]:
        xis = [a + b for a, b in zip(xis, part)]
    xis = [v * tail * sw for v in xis]

    sums = torch.empty(C, nl_out, 4, dtype=F64)
    for il0 in range(0, nl_out, tlens.SEG):
        sd = seeds[il0 // tlens.SEG]
        st, jst = list(sd[:2]), list(sd[2:4])
        for il in range(il0, min(nl_out, il0 + tlens.SEG)):
            r = lt[il]
            st, P = step(r, st)
            dP = r[col["l"]] * (st[0] - x * P) * inv_sin2
            d22 = ((c4x8 + r[col["llp1"]]) * P + fac4 * (fac2 + (x - 2) * r[col["inv_llp1"]])
                   * dP) * r[col["inv_lfacs2"]]
            J40 = jac(il, 4.0, 0.0, *jst, r, "j40")
            jst = [jst[1], J40]
            d20 = (2 * x * dP - r[col["llp1"]] * P) * r[col["inv_lrootfacs"]]
            for q, D in enumerate((P, d22, s2h2 * J40, d20)):
                sums[:, il, q] = (xis[q] * D).sum(-1)
    return sums


def test_lensing_segmented_passes_match_plain():
    """2e-11: the algorithm multiplies by reciprocals where the plain
    version divides; at the last theta nodes d22 is the difference of two
    terms ~1/(1 + cos theta) large, which turns that last-ulp difference
    into ~1e-8 of d22 there (5e-12 of xi_+ d22's maximum at this size, where
    the apodizing tail leaves those nodes 0.14 of their weight)."""
    cl = _spectra_cl()
    th = tlens.theta_table(N_THETA, True, "cpu")
    ref = tlens._passes_plain(cl, th, NL_OUT)
    got = _passes_segmented(cl, th, NL_OUT, seg12=2 * tlens.SEG)
    for q in range(4):
        assert rel_err(got[..., q], ref[..., q]) <= 2e-11, q
    # lensed BB is the small difference of the xi_+ and xi_- projections
    assert rel_err(got[..., 1] - got[..., 2], ref[..., 1] - ref[..., 2]) <= 2e-11


# ---- K2a ----

KEY = (400, 14200.0, 0.1, 4.0, 256, tuple(source_k_grid(0.1, 8, 16).tolist()))


def test_packed_bessel_table_equals_plan_tables():
    plan = tcls._plan(*KEY)
    packed = tcls.packed_bessel(plan.jl, plan.jlp)
    assert packed.shape == plan.jl.shape + (2,) and packed.dtype == np.float32
    np.testing.assert_array_equal(packed[..., 0], plan.jl)
    np.testing.assert_array_equal(packed[..., 1], plan.jlp)
    dp = tcls._device_plan(KEY, "cpu", F64)
    np.testing.assert_array_equal(dp["packed"].numpy(), packed)
    np.testing.assert_array_equal(dp["jl"].numpy(), plan.jl)
    np.testing.assert_array_equal(dp["jlp"].numpy(), plan.jlp)


def test_los_row_span_covers_every_block():
    """The kernel's shared memory holds row_span coarse rows: the most that
    the stencils of any block of LOS_KT fine k touch, counted directly."""
    plan = tcls._plan(*KEY)
    nkf = len(plan.kf_pad)
    want = max(int(plan.idx[k0:k0 + tcls.LOS_KT].max()
                   - plan.idx[k0:k0 + tcls.LOS_KT].min()) + 1
               for k0 in range(0, nkf, tcls.LOS_KT))
    assert tcls.row_span(plan.idx, nkf) == want
    assert tcls._device_plan(KEY, "cpu", F64)["rspan"] == want


def test_los_folded_bessel_terms_match_plain():
    """csrc/cls.cu folds j_l'' into the j_l and j_l' coefficients per (k,
    tau); the same sums in torch against _los_plain."""
    plan = tcls._plan(*KEY)
    dp = tcls._device_plan(KEY, "cpu", F64)
    rng = np.random.default_rng(3)
    C, nt, nk = 2, 64, len(KEY[-1])
    src = torch.tensor(rng.standard_normal((C, 4, nk, nt)), dtype=F64)
    chi = torch.tensor(np.sort(rng.uniform(1e-3, 1.4e4, (C, nt)))[:, ::-1].copy(),
                       dtype=F64)
    wt = torch.tensor(rng.uniform(1, 10, (C, nt)), dtype=F64)
    wl = torch.tensor(rng.uniform(0, 1e-4, (C, nt)), dtype=F64)
    inv_dx = 1.0 / plan.dx
    ref = tcls._los_plain(src, dp["idx"], dp["w"], dp["kf"], chi, wt, wl,
                          dp["jl"], dp["jlp"], dp["ls"], inv_dx, 256)
    ki, kw = dp["idx"].long(), dp["w"]
    S = [sum(kw[:, j:j + 1] * src[:, p][:, ki[:, j]] for j in range(4))
         for p in range(4)]
    s0, s1, s2 = (S[p] * wt[:, None] for p in range(3))
    sL = S[3] * wl[:, None]
    x = dp["kf"][None, :, None] * chi[:, None, :]
    t = x * inv_dx
    i = t.to(torch.int64).clamp(0, plan.jl.shape[1] - 2)
    f = t - i
    inv = 1.0 / torch.clamp(x, min=1e-8)
    B, cJ, cP = s2 * inv * inv, s0 - s2, s1 - 2 * s2 * inv
    jl, jlp = torch.as_tensor(plan.jl, dtype=F64), torch.as_tensor(plan.jlp, dtype=F64)
    for il in range(0, len(plan.ls_pad), 7):
        lv = dp["ls"][il]
        jv = jl[il][i] * (1 - f) + jl[il][i + 1] * f
        jp = jlp[il][i] * (1 - f) + jlp[il][i + 1] * f
        dT = (jv * (cJ + lv * (lv + 1) * B) + jp * cP).sum(-1)
        efac = torch.sqrt(torch.clamp((lv + 2) * (lv + 1) * lv * (lv - 1), min=0.0))
        for got, want in ((dT, ref[0, :, il]), (efac * (B * jv).sum(-1), ref[1, :, il]),
                          ((sL * jv).sum(-1), ref[2, :, il])):
            assert rel_err(got, want) <= 1e-12, il
