"""The warp layouts of the K4 (csrc/recfast.cu) and K1
(csrc/perturbations.cu) kernels, transcribed into torch and held against
the plain versions they must reproduce (CPU, float64, small sizes).

- K4: the first live node, found from the z table alone, is where the
  regime selection can first take an ODE value; `_scan_plain` started there
  from the table's state equals the full `_scan_plain` bit for bit; the
  kernel's walk (coefficients at node j kept for step j + 1, solves the
  selection discards skipped) equals `_scan_plain` bit for bit, every kept
  coefficient set equals the recomputed one, and none is computed twice;
  the coefficients assembled from one pow or exp a lane equal
  `_rate_coeffs` (1e-13: torch's vector pow and exp against its scalar
  ones, a few ulp each).
- K1: the fluid variables replicated on every thread and one multipole a
  thread, neighbours by torch.roll as the warp shuffles take them, against
  `_rhs` (derivatives and the source terms) and `_evolve_plain` (RK4 steps
  with the IC hold), 1e-12 of each maximum; the tight-coupling threshold
  the block derives per row against the rule it replaces; and the stage
  table repeats tau_b's row as the next step's tau_a row, which lets the
  kernel reuse an RHS evaluation.
"""

import numpy as np
import pytest
import torch

from cosmomc_tpu_torch.models import perturbations as tpert
from cosmomc_tpu_torch.models import recfast as trec
from cosmomc_tpu_torch.models.background import BackgroundParams
from cosmomc_tpu_torch.models.cmb import source_k_grid
from cosmomc_tpu_torch.models.reionization import zre_from_tau

F64 = torch.float64
COSMOLOGIES = [(0.02237, 0.1200, 67.4, 0.245), (0.0215, 0.115, 66.0, 0.240),
               (0.0232, 0.125, 70.5, 0.250)]
N_Z = 1500


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


def _bg(rows):
    ombh2, omch2, H0, _ = (np.array(v) for v in zip(*rows))
    return BackgroundParams.make(ombh2=ombh2, omch2=omch2, H0=H0,
                                 nchains=len(rows), device="cpu", dtype=F64)


# ---- K4 ----

def _z_table(rows):
    bg = _bg(rows)
    yhe = torch.tensor([r[3] for r in rows], dtype=F64)
    fHe = yhe / (trec.const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = trec.const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt = trec._z_tables(bg, trec.z_grid(N_Z, "cpu", F64), fHe, Nnow)
    return zt.contiguous(), fHe


@pytest.fixture(scope="module", params=range(len(COSMOLOGIES)))
def chain(request):
    """One cosmology as a one-chain table, and the full plain scan of it."""
    zt, fHe = _z_table([COSMOLOGIES[request.param]])
    return zt, fHe, trec._scan_plain(zt, fHe)


def test_first_live_node_from_the_table_alone():
    zt, _ = _z_table(COSMOLOGIES)
    got = trec.first_live_node(zt)
    for c in range(zt.shape[0]):
        z, xhe, xh = (zt[c, f] for f in (trec.ZT_Z, trec.ZT_XHESAHA,
                                         trec.ZT_XHSAHA))
        want = next(j for j in range(1, N_Z)
                    if not (z[j] > 3000.0 and xhe[j] > 0.995 and xh[j] > 0.985))
        assert int(got[c]) == want
        assert 100 < want < N_Z // 4       # a real prefix, and a real walk
    # a table that never leaves the Saha/hot regime has no live node
    hot = zt[:1, :, :50].contiguous()
    assert int(trec.first_live_node(hot)[0]) == 50


def test_scan_started_at_first_live_node_equals_full(chain):
    zt, fHe, full = chain
    jlive = int(trec.first_live_node(zt)[0])
    started = trec._scan_plain(zt, fHe, start=jlive)
    assert torch.equal(started[0], full[0]) and torch.equal(started[1], full[1])
    # and no later: the node itself is live, so the table's state there differs
    late = trec._scan_plain(zt, fHe, start=jlive + 40)
    assert not torch.equal(late[1], full[1])


def _walk_as_kernel(zt, fHe):
    """csrc/recfast.cu's control flow for one chain: the table prefix, then
    the walk with the rate coefficients at node j kept for step j + 1 and
    the discarded solves skipped. Returns (xe, tm), whether each kept set
    equalled the recomputed one, and the counts of evaluations and steps."""
    N = zt.shape[-1]
    steps = zt.permute(2, 1, 0).unbind(0)
    jlive = int(trec.first_live_node(zt)[0])
    xH, xHe, xe_pre, tm_pre = trec.table_prefix(zt, fHe, jlive)
    xe_out = torch.empty(N, 1, dtype=F64)
    tm_out = torch.empty_like(xe_out)
    xe_out[:jlive], tm_out[:jlive] = xe_pre.T, tm_pre.T
    xH, xHe, tm = xH[:, -1], xHe[:, -1], tm_out[jlive - 1]
    held, kept_equal, evals, he_steps = None, [], 0, 0
    flat = lambda c: c[0] + c[1]
    for j in range(jlive, N):
        r0, r1 = steps[j - 1], steps[j]
        z, dz = r1[trec.ZT_Z], r1[trec.ZT_Z] - r0[trec.ZT_Z]
        xhe_s, xh_s = r1[trec.ZT_XHESAHA], r1[trec.ZT_XHSAHA]
        hot = bool(z > 3000.0)
        need_h = not bool(xh_s > 0.985)
        need_he = need_h or not bool(xhe_s > 0.995)
        xe_tot = xH + fHe * xHe
        tm_new = trec._tm_step(r0, r1, tm, xe_tot, fHe)
        xHe_ode, xH_ode, c1 = xHe, xH, None
        if need_he:
            he_steps += 1
            if held is None:
                c0, evals = trec._rate_coeffs(tm), evals + 1
            else:
                c0 = held
                kept_equal.append(all(torch.equal(a, b) for a, b in
                                      zip(flat(c0), flat(trec._rate_coeffs(tm)))))
            c1, evals = trec._rate_coeffs(tm_new), evals + 1
            he1 = trec._he_rate(c1, r1)
            f_he = trec._dxhe(xHe, xe_tot, fHe, trec._he_rate(c0, r0))[0]
            xHe_ode = trec._cn(xHe, f_he, dz, lambda xx: trec._dxhe(
                xx, xH + fHe * xx, fHe, he1))
            if need_h:
                h1 = trec._h_rate(c1, r1)
                f_h = trec._dxh(xH, xe_tot, trec._h_rate(c0, r0))[0]
                xH_ode = trec._cn(xH, f_h, dz, lambda xx: trec._dxh(
                    xx, xx + fHe * xHe_ode, h1))
        xHe = torch.where(xhe_s > 0.995, xhe_s, xHe_ode).clamp(0.0, 1.0)
        xH = torch.where(xh_s > 0.985, xh_s, xH_ode).clamp(0.0, 1.0)
        xe_out[j] = torch.where(z > 5500.0, r1[trec.ZT_XEEARLY], xH + fHe * xHe)
        tm = torch.where(z > 3000.0, r1[trec.ZT_TMHOT], tm_new)
        tm_out[j] = tm
        held = c1 if need_he and not hot else None
    return (xe_out.T, tm_out.T), kept_equal, evals, he_steps


def test_kernel_walk_equals_plain_and_keeps_its_coefficients(chain):
    zt, fHe, full = chain
    with torch.no_grad():
        (xe, tm), kept_equal, evals, he_steps = _walk_as_kernel(zt, fHe)
    assert torch.equal(xe, full[0]) and torch.equal(tm, full[1])
    # most steps take their node-i coefficients from the step before
    assert len(kept_equal) > 0.9 * he_steps and all(kept_equal)
    # one evaluation a step, plus one where nothing was held
    assert evals == he_steps + (he_steps - len(kept_equal))
    assert evals < 1.1 * he_steps < 2 * he_steps


def test_coefficients_from_one_transcendental_a_lane():
    """csrc/recfast.cu:coeffs: lanes 0..4 take one pow each, lanes 0..3 one
    exp, lanes 0..1 one sqrt, with per-lane operands; the rate coefficients
    assembled from them against _rate_coeffs."""
    k = dict(zip(("CR", "CDB", "CL", "CDB_HE", "CL_HE", "CK_HE", "COMPT",
                  "BFACT", "LAMBDA_H", "LAMBDA_HE", "AH", "B", "C", "D", "AHE",
                  "E0", "E1", "T0", "T1"), trec.KERNEL_CONSTS))
    for t in (2.9e4, 8.2e3, 3.1e3, 950.0, 41.0):
        tt = torch.tensor(t, dtype=F64)
        sq_div = torch.tensor([k["T0"], k["T1"], 1, 1, 1], dtype=F64)
        pexp = torch.tensor([k["E0"], k["E1"], 1.5, k["B"], k["D"]], dtype=F64)
        ecoef = torch.tensor([k["CDB_HE"], k["CL_HE"], k["CDB"], k["CL"], 0.0],
                             dtype=F64)
        sq = torch.sqrt(tt / sq_div)
        base = torch.stack([1 + sq[0], 1 + sq[1], k["CR"] * tt, tt / 1e4, tt / 1e4])
        pw, ex = base ** pexp, torch.exp(-ecoef / tt)
        he_down = k["AHE"] / (sq[0] * pw[0] * pw[1])
        he_up = 4.0 * he_down * pw[2] * ex[0]
        h_down = k["AH"] * pw[3] / (1.0 + k["C"] * pw[4])
        got = (he_down, he_up, ex[1], -k["BFACT"] / tt, h_down, h_down * pw[2] * ex[2],
               ex[3])
        he, h = trec._rate_coeffs(tt)
        for a, b in zip(got, he + h):
            assert abs(float(a) - float(b)) <= 1e-13 * abs(float(b)), t


# ---- K1 ----

GENERIC, L2, CLOSURE = 1, 2, 3
HIERARCHIES = (("fg", 2, tpert.LMAXG - 1), ("gp", 0, tpert.LMAXGP + 1),
               ("fn", 2, tpert.LMAXNR - 1))
FLUID = (tpert._I_ETA, tpert._I_DC, tpert._I_DB, tpert._I_TB, tpert._I_DG,
         tpert._I_TG, tpert._I_DN, tpert._I_TN)
LANE = tpert.MULTIPOLE_LANES


def _lane_constants(k):
    """What csrc/perturbations.cu:multipole_of sets once per thread."""
    kind = torch.zeros(32, dtype=torch.int64)
    l = torch.zeros(32, dtype=F64)
    photon, pol, nu, no_prev = (torch.zeros(32, dtype=torch.bool) for _ in range(4))
    polc = torch.zeros(32, dtype=F64)
    for name, l0, n in HIERARCHIES:
        for j in range(n):
            lane = LANE[name] + j
            l[lane] = j + l0
            kind[lane] = CLOSURE if j == n - 1 else (L2 if j == 0 and l0 == 2
                                                     else GENERIC)
            photon[lane], pol[lane], nu[lane] = name != "fn", name == "gp", name == "fn"
    no_prev[LANE["gp"]] = True
    polc[LANE["gp"]], polc[LANE["gp"] + 2] = 0.5, 0.1
    coef = torch.where(kind > 0, k[:, None] / (2 * l + 1), 0.0)     # (nk, 32)
    return dict(kind=kind, l=l, lp1=torch.where(kind > 0, l + 1, 0.0), coef=coef,
                photon=photon, pol=pol, nu=nu, no_prev=no_prev, polc=polc)


def _to_lanes(y):
    """(C, nk, NVAR) -> the 8 fluid variables and one multipole a lane."""
    ym = torch.zeros(y.shape[:-1] + (32,), dtype=y.dtype)
    ym[..., LANE["fg"]:LANE["gp"]] = y[..., tpert._I_FG2:tpert._I_GP0]
    ym[..., LANE["gp"]:LANE["fn"]] = y[..., tpert._I_GP0:tpert._I_DN]
    ym[..., LANE["fn"]:LANE["fn"] + tpert.LMAXNR - 1] = y[..., tpert._I_FN2:]
    return y[..., list(FLUID)], ym


def _from_lanes(yf, ym):
    y = torch.zeros(yf.shape[:-1] + (tpert.NVAR,), dtype=yf.dtype)
    y[..., list(FLUID)] = yf
    y[..., tpert._I_FG2:tpert._I_GP0] = ym[..., LANE["fg"]:LANE["gp"]]
    y[..., tpert._I_GP0:tpert._I_DN] = ym[..., LANE["gp"]:LANE["fn"]]
    y[..., tpert._I_FN2:] = ym[..., LANE["fn"]:LANE["fn"] + tpert.LMAXNR - 1]
    return y


NL1 = tpert.LMAXNU + 1


def _nu_lane_constants():
    """What csrc/perturbations.cu:nu_lane_of sets once per thread."""
    lane = torch.arange(32)
    live = lane < tpert.NQ_NU * NL1
    i = torch.where(live, lane // NL1, 0)
    l = torch.where(live, lane % NL1, -1)
    lf = l.to(F64)
    return dict(live=live, i=i, l=l, lf=lf, lp1=lf + 1.0,
                inv2l1=1.0 / (2.0 * lf + 1.0),
                dlnf=torch.as_tensor(tpert._NU_DLNF, dtype=F64)[i])


def _to_lanes_ext(y, sw):
    """(C, nk, NVAR + extra) -> the fluid variables (with the DE pair), one
    multipole a lane, and one Psi_l(q_i) a lane."""
    nu, de = sw
    yf, ym = _to_lanes(y[..., :tpert.NVAR])
    yn = torch.zeros_like(ym)
    if nu:
        yn[..., :tpert.NVAR_NU] = y[..., tpert.NVAR:tpert.NVAR + tpert.NVAR_NU]
    if de:
        yf = torch.cat([yf, y[..., -tpert.NVAR_DE:]], -1)
    return yf, ym, yn


def _from_lanes_ext(yf, ym, yn, sw):
    nu, de = sw
    parts = [_from_lanes(yf[..., :len(FLUID)], ym)]
    if nu:
        parts.append(yn[..., :tpert.NVAR_NU])
    if de:
        parts.append(yf[..., len(FLUID):])
    return torch.cat(parts, -1)


def _derived(q):
    """csrc/perturbations.cu:derive_row, per (chain) row q (C, NQ)."""
    Q = lambda f: q[:, f:f + 1]
    tau, opac, R = Q(tpert.Q_TAU), Q(tpert.Q_OPAC), Q(tpert.Q_R)
    tau_safe = torch.clamp(tau, min=1e-10)
    calm = opac * (1.0 + R) * Q(tpert.Q_DTLOC) <= 1.3
    thin = opac * tau <= tpert.TC_OPACTAU
    inf = torch.full_like(tau, float("inf"))
    return dict(tauc=1.0 / torch.clamp(opac, min=1e-30),
                tcthr=torch.where(~calm, inf, torch.where(
                    thin, -inf, torch.full_like(tau, tpert.TC_KTAUC))),
                inv_onepr=1.0 / (1.0 + R), inv_adotoa=1.0 / Q(tpert.Q_ADOTOA),
                inv_wsum=1.0 / (Q(tpert.Q_GC) + Q(tpert.Q_GB)), clg=(tpert.LMAXG + 1) / tau_safe,
                clp=(tpert.LMAXGP + 1) / tau_safe,
                cln=(tpert.LMAXNR + 1) / tau_safe,
                wnu=(4.0 / 3.0) * Q(tpert.Q_GML),
                dadotoa=-(Q(tpert.Q_GRHO) + 3.0 * Q(tpert.Q_GPRES)) / 6.0)


def _rhs_lanes(yf, ym, q, k, rsa_ktau, mp, yn=None, sw=(False, False)):
    """csrc/perturbations.cu:rhs in torch: yf (C, nk, 8, or 10 with the DE
    fluid) on every lane, ym (C, nk, 32) one multipole a lane and, with
    massive nu, yn (C, nk, 32) one Psi_l(q_i) a lane (lane 7 i + l)."""
    Q = lambda f: q[:, f:f + 1]
    d = _derived(q)
    nu, de = sw
    tau, opac, csqb = Q(tpert.Q_TAU), Q(tpert.Q_OPAC), Q(tpert.Q_CSQB)
    grho_g, grho_n, gml = Q(tpert.Q_GG), Q(tpert.Q_GN), Q(tpert.Q_GML)
    grho_c, grho_b, adotoa, R = (Q(tpert.Q_GC), Q(tpert.Q_GB),
                                 Q(tpert.Q_ADOTOA), Q(tpert.Q_R))
    eta, dc, db, tb, dg, tg, dn, tn = yf[..., :len(FLUID)].unbind(-1)
    # the loop divides by nothing: reciprocals once a thread and once a row
    k2, inv_k, inv_k2, inv_adotoa = k * k, 1.0 / k, 1.0 / (k * k), d["inv_adotoa"]
    rsa = k * tau >= rsa_ktau
    tc_on = ~(k * d["tauc"] >= d["tcthr"]) & ~rsa
    # broadcasts and neighbour shuffles
    fg0, gp0, gp2, fn0 = (ym[..., LANE["fg"]], ym[..., LANE["gp"]],
                          ym[..., LANE["gp"] + 2], ym[..., LANE["fn"]])
    up, nxt = torch.roll(ym, 1, -1), torch.roll(ym, -1, -1)
    prev = torch.where(mp["no_prev"], 0.0, up)

    dgrho_m = grho_c * dc + grho_b * db
    z_rsa = (0.5 * dgrho_m * inv_k + k * eta) * inv_adotoa
    dz_rsa = -adotoa * z_rsa - 0.5 * dgrho_m * inv_k
    dn_rsa = -4.0 * dz_rsa * inv_k
    tn_rsa = -k * z_rsa
    dg = torch.where(rsa, dn_rsa - (4.0 * inv_k) * opac * (tb * inv_k + z_rsa), dg)
    tg = torch.where(rsa, tn_rsa, tg)
    dn = torch.where(rsa, dn_rsa, dn)
    tn = torch.where(rsa, tn_rsa, tn)

    zero = torch.zeros_like(dg)
    sigma_n = torch.where(rsa, zero, fn0 / 2.0)
    if nu:
        # the 12 broadcasts (lanes 7 i + l, l = 0, 1, 2), summed in node order
        nu_rel = rsa & ((Q(tpert.Q_AMLT2) != 0.0) | (k * Q(tpert.Q_DTLOC) > 0.9))
        wn = tpert._NU_WNORM
        s0 = s1 = s2 = zero
        for i in range(tpert.NQ_NU):
            s0 = s0 + wn[i] * Q(tpert.Q_EQ + i) * yn[..., NL1 * i]
            s1 = s1 + wn[i] * yn[..., NL1 * i + 1]
            s2 = s2 + wn[i] * Q(tpert.Q_QE + i) * yn[..., NL1 * i + 2]
        dgrho = grho_c * dc + grho_b * db + grho_g * dg + grho_n * dn \
            + torch.where(nu_rel, gml * dn, gml * s0)
        dgq = (4.0 / 3.0) * (grho_g * tg + grho_n * tn) + grho_b * tb \
            + torch.where(nu_rel, (4.0 / 3.0) * gml * tn, gml * k * s1)
        dgpi_m = torch.where(nu_rel, zero, (2.0 / 3.0) * gml * s2)
    else:
        dgrho = grho_c * dc + grho_b * db + grho_g * dg + grho_n * dn + gml * dn
        dgq = (4.0 / 3.0) * (grho_g * tg + grho_n * tn) + grho_b * tb + d["wnu"] * tn
        dgpi_m = d["wnu"] * sigma_n
    if de:
        i0 = tpert.q_de(nu)
        w_de, gde, wpr = Q(i0 + tpert.Q_WDE), Q(i0 + tpert.Q_GDE), Q(i0 + tpert.Q_WPR)
        dgrho = dgrho + torch.where(rsa, zero, gde * yf[..., 8])
        dgq = dgq + torch.where(rsa, zero, gde * yf[..., 9])
    hdot = (2.0 * k2 * eta + dgrho) * inv_adotoa
    etadot = 0.5 * dgq * inv_k2
    fg2_tca = (4.0 / 3.0) * d["tauc"] * ((8.0 / 15.0) * tg + (4.0 / 15.0) * hdot
                                         + (8.0 / 5.0) * etadot)
    sigma_g = torch.where(rsa, zero, torch.where(tc_on, fg2_tca, fg0)) / 2.0
    pol_term = torch.where(rsa, zero, torch.where(tc_on, 2.5 * fg2_tca,
                                                  fg0 + gp0 + gp2))
    sl = dg / 4.0 - sigma_g
    base = -adotoa * tb + csqb * k2 * db
    tb_tca = (base + R * k2 * sl) * d["inv_onepr"]
    tbdot = torch.where(rsa, base, torch.where(tc_on, tb_tca,
                                               base + R * opac * (tg - tb)))
    tgdot = torch.where(rsa, zero, torch.where(tc_on, tb_tca,
                                               k2 * sl + opac * (tb - tg)))
    dyf = [etadot, -0.5 * hdot, -tb - 0.5 * hdot, tbdot,
           torch.where(rsa, zero, -(4.0 / 3.0) * tg - (2.0 / 3.0) * hdot), tgdot,
           torch.where(rsa, zero, -(4.0 / 3.0) * tn - (2.0 / 3.0) * hdot),
           torch.where(rsa, zero, k2 * (dn / 4.0 - sigma_n))]
    if de:
        # the three coefficients the block derives once a row
        a_ = adotoa
        d1, d2 = 3.0 * a_ * (1.0 - w_de), 9.0 * (a_ * a_) * (1.0 - w_de) + 3.0 * a_ * wpr
        dd, dv = yf[..., 8], yf[..., 9]
        dyf += [torch.where(rsa, zero, -dv - (1.0 + w_de) * 0.5 * hdot - d1 * dd
                            - d2 * dv * inv_k2),
                torch.where(rsa, zero, (2.0 * a_ + wpr) * dv + k2 * dd)]
    dyf = torch.stack(dyf, -1)

    # one multipole a lane: the three forms, one selected
    e = lambda v: v[..., None]
    damp = torch.where(mp["photon"], e(opac), 0.0)
    generic = mp["coef"] * (mp["l"] * prev - mp["lp1"] * nxt) - damp * ym \
        + e(opac) * mp["polc"] * e(pol_term)
    l2 = (8.0 / 15.0) * torch.where(mp["nu"], e(tn), e(tg)) \
        - (3.0 / 5.0) * e(k.expand_as(tg)) * nxt + (4.0 / 15.0) * e(hdot) \
        + (8.0 / 5.0) * e(etadot) - damp * (0.9 * ym - 0.1 * e(gp0 + gp2))
    clc = torch.where(mp["nu"], e(d["cln"]), torch.where(mp["pol"], e(d["clp"]),
                                                          e(d["clg"])))
    closure = e(k.expand_as(tg)) * prev - clc * ym - damp * ym
    zeroed = (mp["kind"] == 0) | e(rsa) | (mp["photon"] & e(tc_on))
    v = torch.where(mp["kind"] == L2, l2, torch.where(mp["kind"] == CLOSURE,
                                                      closure, generic))
    dym = torch.where(zeroed, 0.0, v)
    fg2dot, fn2dot = l2[..., LANE["fg"]], l2[..., LANE["fn"]]
    aux = dict(hdot=hdot, etadot=etadot, sigma_g=sigma_g, sigma_n=sigma_n,
               dgpi=(4.0 / 3.0) * (grho_g * sigma_g + grho_n * sigma_n) + dgpi_m,
               sigg_dot=torch.where(tc_on | rsa, zero, fg2dot) / 2.0,
               sign_dot=torch.where(rsa, zero, fn2dot) / 2.0, pol_term=pol_term)
    if nu:
        # a lane's own Psi_l(q_i): neighbours by the up/down shuffles, q/eps
        # of its node, the closure at l = LMAXNU, frozen under nu_rel_rsa
        nl = _nu_lane_constants()
        upn, nxn = torch.roll(yn, 1, -1), torch.roll(yn, -1, -1)
        prevn = torch.where(nl["l"] == 0, 0.0, upn)
        qe_own = q[:, None, tpert.Q_QE:tpert.Q_QE + tpert.NQ_NU][..., nl["i"]]
        qke = qe_own * e(k.expand_as(tg))
        gen = (qke * nl["inv2l1"]) * (nl["lf"] * prevn - nl["lp1"] * nxn)
        src = torch.where(nl["l"] == 0, e(hdot / 6.0) * nl["dlnf"], torch.where(
            nl["l"] == 2, -e(hdot / 15.0 + 2.0 * etadot / 5.0) * nl["dlnf"], 0.0))
        clo = qke * prevn - e((tpert.LMAXNU + 1) / torch.clamp(tau, min=1e-10)) * yn
        dyn = torch.where(~nl["live"] | e(nu_rel), 0.0,
                          torch.where(nl["l"] == tpert.LMAXNU, clo, gen + src))
        # d/dtau of the massive stress: the four dPsi_2/dtau by broadcast
        ext = zero
        for i in range(tpert.NQ_NU):
            qe = Q(tpert.Q_QE + i)
            ext = ext + wn[i] * (qe * dyn[..., NL1 * i + 2]
                                 - (qe * (3.0 - qe * qe) * adotoa) * yn[..., NL1 * i + 2])
        aux["dgpidot_extra"] = torch.where(nu_rel, zero, (2.0 / 3.0) * gml * ext)
        aux["dyn"] = dyn
    return dyf, dym, aux


@pytest.fixture(scope="module")
def small():
    """The small config: two chains, 2048 steps, 24 k to 0.1/Mpc."""
    rows = COSMOLOGIES[:2]
    bg = _bg(rows)
    yhe = torch.tensor([r[3] for r in rows], dtype=F64)
    th = trec.compute_thermo(bg, yhe, n_z=2000)
    zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64), yhe)
    tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=2048)
    k = torch.as_tensor(source_k_grid(0.1, 8, 16), dtype=F64)
    return tpert._stage_tables(bg, tf), k, tpert._r_nu(bg), _lane_constants(k)


def test_tight_coupling_threshold_is_the_rule(small):
    """On the grid's own rows, and on the same rows with the local step cut
    to 1%: there the stiffness bound holds while the plasma is still thick,
    which the 2048-step grid never shows, and the switch is the k tauc
    comparison itself."""
    qtab, k, _, _ = small
    seen, mixed = set(), False
    for step in range(0, qtab.shape[1], 37):
        for shrink in (1.0, 0.01):
            q = qtab[:, step, 1].clone()
            q[:, tpert.Q_DTLOC] *= shrink
            Q = lambda f: q[:, f:f + 1]
            opac, tau = Q(tpert.Q_OPAC), Q(tpert.Q_TAU)
            tauc = 1.0 / torch.clamp(opac, min=1e-30)
            rule = ((k * tauc >= tpert.TC_KTAUC) | (opac * tau <= tpert.TC_OPACTAU)) \
                & (opac * (1.0 + Q(tpert.Q_R)) * Q(tpert.Q_DTLOC) <= 1.3)
            d = _derived(q)
            assert torch.equal(k * d["tauc"] >= d["tcthr"], rule), step
            seen.update(d["tcthr"].flatten().tolist())
            mixed |= bool(rule.any() and not rule.all()
                          and (d["tcthr"] == tpert.TC_KTAUC).all())
    assert seen == {float("inf"), -float("inf"), tpert.TC_KTAUC} and mixed


def test_stage_rows_repeat_across_steps(small):
    """A step's first row is the row of the previous step's tau_b, field for
    field: where csrc/perturbations.cu finds that, it takes the step's first
    RHS evaluation from the previous step's last."""
    qtab = small[0]
    assert torch.equal(qtab[:, 1:, 0], qtab[:, :-1, 2])
    assert not torch.equal(qtab[:, 1:, 1], qtab[:, :-1, 2])


@pytest.mark.parametrize("step", [3, 400, 900, 1300, 2040])
def test_lane_rhs_matches_rhs(small, step):
    """Steps in tight coupling, around recombination, free streaming and
    (the top k, late) radiation streaming."""
    qtab, k, rnu, mp = small
    q = qtab[:, step, 2]
    rng = np.random.default_rng(step)
    y = tpert.adiabatic_ics(k, q[:, tpert.Q_TAU:tpert.Q_TAU + 1], rnu[:, None])
    y = y + torch.tensor(0.05 * rng.standard_normal(tuple(y.shape)), dtype=F64)
    dy, aux = tpert._rhs(y, q, k, tpert.RSA_KTAU)
    yf, ym = _to_lanes(y)
    dyf, dym, aux_l = _rhs_lanes(yf, ym, q, k, tpert.RSA_KTAU, mp)
    assert torch.equal(dym[..., 29:], torch.zeros_like(dym[..., 29:]))
    got = _from_lanes(dyf, dym)
    for j in range(tpert.NVAR):
        assert rel_err(got[..., j], dy[..., j]) <= 1e-12 or \
            float(dy[..., j].abs().max()) == 0.0 == float(got[..., j].abs().max()), j
    for name in aux:
        ref = aux[name]
        if float(ref.abs().max()) == 0.0:
            assert float(aux_l[name].abs().max()) == 0.0, name
        else:
            assert rel_err(aux_l[name], ref) <= 1e-12, name
    ktau = k * q[:, tpert.Q_TAU:tpert.Q_TAU + 1]
    if step == 2040:
        assert bool((ktau >= tpert.RSA_KTAU).any()) and bool((ktau < tpert.RSA_KTAU).any())


@pytest.fixture(scope="module")
def small_ext(small):
    """The small config's two chains with mnu 0.06 and 0.3 eV, w0 -0.9 and
    -1.1, wa -0.4 and 0.2: the stage table of each extended variant."""
    from cosmomc_tpu_torch.params.parameterizations import mnu_to_omnuh2
    rows = COSMOLOGIES[:2]
    ombh2, omch2, H0, yhe = (np.array(v) for v in zip(*rows))
    bg = BackgroundParams.make(ombh2=ombh2, omch2=omch2, H0=H0,
                               omnuh2=mnu_to_omnuh2(np.array([0.06, 0.3])),
                               w=np.array([-0.9, -1.1]), wa=np.array([-0.4, 0.2]),
                               nchains=2, device="cpu", dtype=F64)
    yhe = torch.as_tensor(yhe, dtype=F64)
    th = trec.compute_thermo(bg, yhe, n_z=2000)
    zre = zre_from_tau(bg, torch.full((2,), 0.055, dtype=F64), yhe)
    tf, _ = tpert.build_thermo_funcs(bg, yhe, th, zre, n_step=2048)
    return {sw: tpert._stage_tables(bg, tf, *sw)
            for sw in ((True, False), (False, True), (True, True))}, tpert._r_nu(bg)


@pytest.mark.parametrize("sw", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("step", [3, 900, 1300, 2040])
def test_lane_rhs_extended_matches_rhs(small, small_ext, step, sw):
    """The lane layout with the Psi_l(q_i) register (lane 7 i + l; the
    momentum sums by 12 broadcasts, q/eps of a lane's own node, the
    closure, dPsi_2/dtau by 4 broadcasts for the sources) and the DE pair
    on every lane, against `_rhs` with the extensions (1e-12); states
    perturbed around the ICs with their Psi_l and DE values."""
    _, k, _, mp = small
    tables, rnu = small_ext
    q = tables[sw][:, step, 2]
    rng = np.random.default_rng(step)
    y = tpert.adiabatic_ics(k, q[:, tpert.Q_TAU:tpert.Q_TAU + 1], rnu[:, None], *sw)
    y = y + torch.tensor(0.05 * rng.standard_normal(tuple(y.shape)), dtype=F64)
    dy, aux = tpert._rhs(y, q, k, tpert.RSA_KTAU, *sw)
    yf, ym, yn = _to_lanes_ext(y, sw)
    dyf, dym, aux_l = _rhs_lanes(yf, ym, q, k, tpert.RSA_KTAU, mp, yn, sw)
    got = _from_lanes_ext(dyf, dym, aux_l.get("dyn", torch.zeros_like(dym)), sw)
    assert got.shape == dy.shape
    for j in range(dy.shape[-1]):
        assert rel_err(got[..., j], dy[..., j]) <= 1e-12 or \
            float(dy[..., j].abs().max()) == 0.0 == float(got[..., j].abs().max()), j
    if sw[0]:
        assert torch.equal(aux_l["dyn"][..., tpert.NVAR_NU:],
                           torch.zeros_like(aux_l["dyn"][..., tpert.NVAR_NU:]))
    for name in aux:
        ref = aux[name]
        if float(ref.abs().max()) == 0.0:
            assert float(aux_l[name].abs().max()) == 0.0, name
        else:
            assert rel_err(aux_l[name], ref) <= 1e-12, name


def _evolve_lanes(qtab, k, rnu, rsa_ktau, mp):
    """csrc/perturbations.cu's step loop in the lane layout."""
    C, S = qtab.shape[0], qtab.shape[1]
    out = torch.empty(len(tpert.PLANES), C, S, k.shape[0], dtype=F64)

    def ics(tau):
        return _to_lanes(tpert.adiabatic_ics(k, tau, rnu[:, None]))
    yf, ym = ics(qtab[:, 0, 0, tpert.Q_TAU:tpert.Q_TAU + 1])
    for i in range(S):
        qa, qm, qb = qtab[:, i, 0], qtab[:, i, 1], qtab[:, i, 2]
        tau_b = qb[:, tpert.Q_TAU:tpert.Q_TAU + 1]
        dt = (tau_b - qa[:, tpert.Q_TAU:tpert.Q_TAU + 1])[..., None]
        f = lambda a, b, q: _rhs_lanes(a, b, q, k, rsa_ktau, mp)[:2]
        kf, km = f(yf, ym, qa)
        af, am = kf, km
        kf, km = f(yf + 0.5 * dt * kf, ym + 0.5 * dt * km, qm)
        af, am = af + 2 * kf, am + 2 * km
        kf, km = f(yf + 0.5 * dt * kf, ym + 0.5 * dt * km, qm)
        af, am = af + 2 * kf, am + 2 * km
        kf, km = f(yf + dt * kf, ym + dt * km, qb)
        released = ((k * tau_b >= tpert.IC_RELEASE_KTAU) | (tau_b >= 3.0))[..., None]
        icf, icm = ics(tau_b)
        yf = torch.where(released, yf + (dt / 6.0) * (af + kf), icf)
        ym = torch.where(released, ym + (dt / 6.0) * (am + km), icm)
        dyf, dym, aux = _rhs_lanes(yf, ym, qb, k, rsa_ktau, mp)
        out[:, :, i] = torch.stack(tpert._sources(
            _from_lanes(yf, ym), _from_lanes(dyf, dym), aux, qb, k))
    return out


@pytest.mark.parametrize("first", [0, 1000])
def test_lane_steps_match_evolve_plain(small, first):
    """48 RK4 steps from the ICs at the grid's start (held, then tightly
    coupled) and from ICs set mid-grid (released at once, free streaming)."""
    qtab, k, rnu, mp = small
    q = qtab[:, first:first + 48].contiguous()
    ref = tpert._evolve_plain(q, k, rnu, tpert.RSA_KTAU)
    with torch.no_grad():
        got = _evolve_lanes(q, k, rnu, tpert.RSA_KTAU, mp)
    for p, name in enumerate(tpert.PLANES):
        assert rel_err(got[p], ref[p]) <= 1e-12, name
