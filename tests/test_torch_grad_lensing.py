"""Port parity of K3's gradient (curved-sky lensing), float64 on the CPU.

1. The port's `lens_cls` (the plain version under autograd, the CPU's
   path) against `jax.vjp` of the JAX package's
   `cosmomc_tpu/models/lensing.py:lens_cls` (vmapped over chains) along a
   seeded cotangent on the lensed TT, TE, EE and BB: the cotangents of the
   unlensed TT, TE, EE and C^phiphi, each to 1e-10 of its largest
   magnitude. Smooth spectra from a seed, 2 chains, lmax 400 (lensed to
   300, 799 theta nodes), with the apodizing tail on and off, and C^phiphi
   scaled by 0, 1 and 10 (sigma^2 = C_gl2 = 0; the main path's size; and
   exp(-l(l+1) sigma^2 / 4) far from 1).
2. The reverse kernel's arithmetic (csrc/lensing.cu lensing_bwd: pass 3T
   as a walk over l per theta, with the plain version's Legendre and J40
   recurrences, pass 2T with the hand-derived derivatives of the four xi
   terms in sigma^2 and C_gl2, pass 1T) transcribed in torch from the per-l
   table, against autograd of `_passes_plain` with a cotangent on every
   pass-3 sum, 1e-11 of each cotangent's maximum.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from cosmomc_tpu.models import lensing as jlens

from cosmomc_tpu_torch.models import lensing as tlens

F64 = torch.float64
RTOL = 1e-10
LMAX, LMAX_LENSED = 400, 300
FIELDS_IN = ("tt", "te", "ee", "pp")
FIELDS_OUT = ("tt", "te", "ee", "bb")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spectra(pp_scale, seed=21, C=2):
    """l(l+1)C_l/2pi-like shapes in muK^2 and a C^phiphi shape peaking near
    l ~ 40 ([l(l+1)]^2 C^pp / 2pi), one amplitude a chain."""
    rng = np.random.default_rng(seed)
    l = np.arange(2, LMAX + 1, dtype=np.float64)
    out = {f: [] for f in FIELDS_IN}
    for amp in 1.0 + 0.1 * rng.standard_normal(C):
        ph = rng.uniform(0, 0.3)
        damp = np.exp(-(l / 1400.0) ** 2)
        tt = amp * 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0 + ph) ** 2)
        ee = amp * 40.0 * damp * (l / 1000.0) * (1.0 + np.sin(np.pi * l / 300.0 + ph) ** 2)
        out["tt"].append(tt)
        out["ee"].append(ee)
        out["te"].append(0.4 * np.sqrt(tt * ee) * np.cos(np.pi * l / 150.0 + ph))
        out["pp"].append(pp_scale * amp * 1.8e-7 * (l / 40.0)
                         / (1.0 + (l / 40.0) ** 2) ** 1.2)
    return l, {f: np.array(v) for f, v in out.items()}


@pytest.fixture(scope="module",
                params=[(a, s) for a in (True, False) for s in (0.0, 1.0, 10.0)],
                ids=lambda p: f"apodize{int(p[0])}-pp{p[1]:g}")
def both(request):
    apodize, scale = request.param
    l, sp = spectra(scale)
    g = np.random.default_rng(7).standard_normal((4, 2, LMAX_LENSED - 1))
    t = {f: torch.tensor(sp[f], dtype=F64, requires_grad=True) for f in FIELDS_IN}
    out = tlens.lens_cls(torch.tensor(l.astype(np.int64)), *(t[f] for f in FIELDS_IN),
                         lmax_lensed=LMAX_LENSED, apodize=apodize)
    loss = sum((getattr(out, f) * torch.tensor(g[i])).sum()
               for i, f in enumerate(FIELDS_OUT))
    port = torch.autograd.grad(loss, [t[f] for f in FIELDS_IN])
    ls = jnp.asarray(l.astype(np.int32))

    def f(tt, te, ee, pp):
        r = jlens.lens_cls(ls, tt, te, ee, pp, lmax_lensed=LMAX_LENSED,
                           apodize=apodize)
        return r.tt, r.te, r.ee, r.bb
    _, vjp = jax.vjp(jax.vmap(f), *(jnp.asarray(sp[f]) for f in FIELDS_IN))
    ref = vjp(tuple(jnp.asarray(x) for x in g))
    return ({f: p.numpy() for f, p in zip(FIELDS_IN, port)},
            {f: np.asarray(r) for f, r in zip(FIELDS_IN, ref)})


@pytest.mark.parametrize("field", FIELDS_IN)
def test_cotangent_matches_jax_vjp(both, field):
    port, ref = both
    a, b = port[field], ref[field]
    assert a.shape == b.shape and np.isfinite(a).all()
    scale = np.abs(b).max()
    assert scale > 0
    err = np.abs(a - b).max() / scale
    assert err <= RTOL, f"{field}: rel err {err:.3e}"


# ---------------------------------------------------------------------------
# the reverse kernel's arithmetic, transcribed

L_T, N_THETA_T, NL_OUT_T = 180, 400, 150


def _passes_bwd_transcribed(cl, th, nl_out, g_sums):
    """csrc/lensing.cu's reverse kernels in torch, every theta and chain at
    once: pass 1 (the forward's sigma^2, C_gl2, which the kernel keeps),
    3T, 2T, 1T, with the per-l table's quantities."""
    C, _, Lc = cl.shape
    lt = torch.as_tensor(tlens.l_table(Lc))
    col = {n: i for i, n in enumerate(tlens.L_COLS)}
    x, sinth, sin2, fac1, fac2, tail, sw = th
    inv_sin2, inv_fac1, inv_fac2, inv_sinth = 1 / sin2, 1 / fac1, 1 / fac2, 1 / sinth
    s2h2, sc2 = (fac1 / 2) ** 2, (fac1 / 2 * fac2 / 2) ** 2
    c4x8, fac4 = (4 * x - 8) / fac2, 4 * (fac1 / fac2)
    ones, zeros = torch.ones_like(x), torch.zeros_like(x)

    def jac(n, a, b, jm1, j, r, name):
        if n < 0:
            return zeros
        if n == 0:
            return ones
        if n == 1:
            return (a + 1) + (a + b + 2) * (x - 1) / 2
        c = [r[col[f"{name}_{k}"]] for k in ("c2", "c3", "c4", "ic1")]
        return ((c[0] + c[1] * x) * j - c[2] * jm1) * c[3]

    def low_spin(r, P, pmm):
        dP = r[col["l"]] * (pmm - x * P) * inv_sin2
        d11 = fac1 * dP * r[col["inv_llp1"]] + P
        dm11 = fac2 * dP * r[col["inv_llp1"]] - P
        d22 = ((c4x8 + r[col["llp1"]]) * P + fac4 * (fac2 + (x - 2) * r[col["inv_llp1"]])
               * dP) * r[col["inv_lfacs2"]]
        d20 = (2 * x * dP - r[col["llp1"]] * P) * r[col["inv_lrootfacs"]]
        return dP, d11, dm11, d22, d20

    def legendre(r, pmm, pmmp1):
        return (r[col["two_lm1"]] * x * pmmp1 - r[col["lm1"]] * pmm) * r[col["inv_l"]]

    # pass 1 (forward)
    sg = torch.zeros(C, x.shape[0], dtype=F64)
    g = torch.zeros_like(sg)
    pmm, pmmp1 = ones, x
    for il in range(Lc):
        r = lt[il]
        P = legendre(r, pmm, pmmp1)
        pmm, pmmp1 = pmmp1, P
        _, d11, dm11, _, _ = low_spin(r, P, pmm)
        sg = sg + (1 - d11) * cl[:, 3, il, None]
        g = g + dm11 * cl[:, 3, il, None]

    # 3T, its Legendre and J40 recurrences in the plain version's operation
    # order (the kernel's legendre_plain, jacobi40_plain)
    gx = torch.zeros(4, C, x.shape[0], dtype=F64)
    pmm, pmmp1, j40m1, j40 = ones, x, zeros, zeros
    for il in range(nl_out):
        r = lt[il]
        lc = float(il + 2)
        P = ((2 * lc - 1) * x * pmmp1 - (lc - 1) * pmm) / lc
        pmm, pmmp1 = pmmp1, P
        _, _, _, d22, d20 = low_spin(r, P, pmm)
        J40 = tlens._jacobi_advance(float(il), 4.0, 0.0, x, j40m1, j40)
        j40m1, j40 = j40, J40
        for q, D in enumerate((P, d22, s2h2 * J40, d20)):
            gx[q] += g_sums[:, il, q, None] * D
    gx = gx * tail * sw

    # 2T
    g_cl = torch.zeros_like(cl)
    acc_s, acc_g = torch.zeros_like(sg), torch.zeros_like(sg)
    pmm, pmmp1 = ones, x
    jst = [[zeros, zeros] for _ in tlens.JACOBI]
    Cg2, Cg2sq = g, g * g
    for il in range(Lc):
        r = lt[il]
        v = lambda n: r[col[n]]
        lci = il + 2
        P = legendre(r, pmm, pmmp1)
        pmm, pmmp1 = pmmp1, P
        J = []
        for k, (name, a, b, shift) in enumerate(tlens.JACOBI):
            jv = jac(lci - shift, a, b, *jst[k], r, name)
            jst[k] = [jst[k][1], jv]
            J.append(jv)
        J40, J44, J80 = J
        dP, d11, dm11, d22, d20 = low_spin(r, P, pmm)
        d2m2 = s2h2 * J40
        sr1 = sinth * v("inv_rf1")
        d1m2 = sr1 * (dP - 2 * inv_fac1 * dm11)
        d12 = sr1 * (dP - 2 * inv_fac2 * d11)
        sinfac = 4 * inv_sinth
        d1m3 = d2m3 = d3m3 = d13 = d04 = d2m4 = d4m4 = zeros
        if lci >= 3:
            d1m3 = (-(x + 0.5) * d1m2 * sinfac - v("lfacs2") * dm11 * v("inv_rf1")) * v("inv_rf2")
            d2m3 = (-fac2 * d2m2 * sinfac - v("rf1") * d1m2) * v("inv_rf2")
            d3m3 = (-(x + 1.5) * d2m3 * sinfac - v("rf1") * d1m3) * v("inv_rf2")
            d13 = ((x - 0.5) * d12 * sinfac - v("lfacs2") * d11 * v("inv_rf1")) * v("inv_rf2")
        if lci >= 4:
            d04 = v("norm04") * sc2 * J44
            d2m4 = (-(6 * x + 4) * d2m3 * inv_sinth - v("rf2") * d2m2) * v("inv_rf3")
            d4m4 = s2h2 * s2h2 * J80
        x220, x121, x132 = v("x220"), v("x121"), v("x132")
        x242, dx000, dx022 = v("x242"), v("dx000"), v("dx022")
        c8, isq = v("c8"), v("inv_sqrt_llp1")
        X000 = torch.exp(-v("llp1") * sg / 4)
        X000_s = dx000 * X000
        X022 = X000 * (1 + sg)
        X022_s = dx000 * X022 + X000
        X220, X220_s = x220 * X000, x220 * X000_s
        X121, X121_s = x121 * X000, x121 * X000_s
        X132, X132_s = x132 * X000, x132 * X000_s
        X242, X242_s = x242 * X022, x242 * X022_s
        dX000, dX000_s = dx000 * X000, dx000 * X000_s
        dX022, dX022_s = dx022 * X022, dx022 * X022_s
        fac1v, fac1v_s = dX000 * dX000, 2 * dX000 * dX000_s
        fac3, fac3_s = X220 * X220, 2 * X220 * X220_s
        fac2v = (Cg2 * dX022) ** 2 + (X022 * X022 - 1)
        fac2v_s = 2 * Cg2sq * dX022 * dX022_s + 2 * X022 * X022_s
        fac2v_g = 2 * Cg2 * dX022 * dX022
        f0 = ((X000 * X000 - 1) + Cg2sq * fac1v) * P + Cg2sq * fac3 * d2m2 + c8 * fac1v * Cg2 * dm11
        f0_s = ((2 * X000 * X000_s + Cg2sq * fac1v_s) * P + Cg2sq * fac3_s * d2m2
                + c8 * fac1v_s * Cg2 * dm11)
        f0_g = 2 * Cg2 * fac1v * P + 2 * Cg2 * fac3 * d2m2 + c8 * fac1v * dm11
        f1 = 2 * Cg2 * X121 * X132 * d13 + fac2v * d22 + Cg2sq * X242 * X220 * d04
        f1_s = (2 * Cg2 * (X121_s * X132 + X121 * X132_s) * d13 + fac2v_s * d22
                + Cg2sq * (X242_s * X220 + X242 * X220_s) * d04)
        f1_g = 2 * X121 * X132 * d13 + fac2v_g * d22 + 2 * Cg2 * X242 * X220 * d04
        q2 = fac3 * P + X242 * X242 * d4m4
        q2_s = fac3_s * P + 2 * X242 * X242_s * d4m4
        m2 = X121 * X121 * dm11 + X132 * X132 * d3m3
        m2_s = 2 * (X121 * X121_s * dm11 + X132 * X132_s * d3m3)
        f2 = q2 * Cg2sq / 2 + Cg2 * m2 + fac2v * d2m2
        f2_s = q2_s * Cg2sq / 2 + Cg2 * m2_s + fac2v_s * d2m2
        f2_g = q2 * Cg2 + m2 + fac2v_g * d2m2
        h = X121 * d11 + X132 * d1m3
        h_s = X121_s * d11 + X132_s * d1m3
        k3 = X220 / 2 * d2m4 * X242 + (fac3 / 2 + dX022 * dX000) * d20
        k3_s = ((X220_s * X242 + X220 * X242_s) / 2 * d2m4
                + (fac3_s / 2 + dX022_s * dX000 + dX022 * dX000_s) * d20)
        f3 = (X000 * X022 - 1) * d20 + 2 * dX000 * Cg2 * h * isq + Cg2sq * k3
        f3_s = ((X000_s * X022 + X000 * X022_s) * d20
                + 2 * Cg2 * (dX000_s * h + dX000 * h_s) * isq + Cg2sq * k3_s)
        f3_g = 2 * dX000 * h * isq + 2 * Cg2 * k3
        ctt, cte, cee = (cl[:, q, il, None] for q in range(3))
        acc_s = acc_s + ctt * gx[0] * f0_s + cee * (gx[1] * f1_s + gx[2] * f2_s) + cte * gx[3] * f3_s
        acc_g = acc_g + ctt * gx[0] * f0_g + cee * (gx[1] * f1_g + gx[2] * f2_g) + cte * gx[3] * f3_g
        g_cl[:, 0, il] = (gx[0] * f0).sum(-1)
        g_cl[:, 1, il] = (gx[3] * f3).sum(-1)
        g_cl[:, 2, il] = (gx[1] * f1 + gx[2] * f2).sum(-1)

    # 1T
    pmm, pmmp1 = ones, x
    for il in range(Lc):
        r = lt[il]
        P = legendre(r, pmm, pmmp1)
        pmm, pmmp1 = pmmp1, P
        _, d11, dm11, _, _ = low_spin(r, P, pmm)
        g_cl[:, 3, il] = (acc_s * (1 - d11) + acc_g * dm11).sum(-1)
    return g_cl


def _cl(pp_scale):
    """(2, 4, L_T) CTT, CTE, CEE, Cphil3 as lens_cls hands them to the
    passes."""
    rng = np.random.default_rng(5)
    l = np.arange(2, L_T + 2, dtype=np.float64)
    out = []
    for a in 1.0 + 0.1 * rng.standard_normal(2):
        damp = np.exp(-(l / 1400.0) ** 2)
        tt = a * 5800.0 * damp * (0.35 + np.cos(np.pi * l / 300.0) ** 2)
        ee = a * 40.0 * damp * (l / 1000.0) * (1 + np.sin(np.pi * l / 300.0) ** 2)
        te = 0.4 * np.sqrt(tt * ee) * np.cos(np.pi * l / 150.0)
        pp = pp_scale * a * 1.8e-7 * (l / 40.0) / (1.0 + (l / 40.0) ** 2) ** 1.2
        llp1, f = l * (l + 1), (2 * l + 1) / (4 * np.pi)
        conv = 2 * np.pi / llp1
        out.append([tt * conv * f, te * conv * f, ee * conv * f,
                    pp * (2 * np.pi / llp1 ** 2) * llp1 * f])
    return torch.tensor(np.array(out), dtype=F64)


@pytest.mark.parametrize("pp_scale", [1.0, 30.0])
@pytest.mark.parametrize("q", range(4), ids=["TT", "TE", "EE", "phil3"])
def test_kernel_arithmetic_matches_autograd(pp_scale, q):
    cl = _cl(pp_scale).requires_grad_(True)
    th = tlens.theta_table(N_THETA_T, True, "cpu")
    sums = tlens._passes_plain(cl, th, NL_OUT_T)
    g_sums = torch.as_tensor(np.random.default_rng(9).standard_normal(sums.shape))
    (ref,) = torch.autograd.grad((sums * g_sums).sum(), [cl])
    with torch.no_grad():
        got = _passes_bwd_transcribed(cl, th, NL_OUT_T, g_sums)
    err = float((got[:, q] - ref[:, q]).abs().max() / ref[:, q].abs().max())
    assert err <= 1e-11, f"rel err {err:.3e}"
