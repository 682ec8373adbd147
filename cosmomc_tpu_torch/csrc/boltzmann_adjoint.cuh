// K1's reverse pass, one (chain, k) lane at a time: the RHS, sources, ICs
// and RK4 step as serial code on one thread, and their vector-Jacobian
// products written out by hand, operation for operation in reverse. The
// forward functions repeat models/perturbations.py:_rhs, _sources,
// adiabatic_ics and _evolve_plain's step (divides as divides), so a reverse
// pass that walks these gives the gradient autograd gives of the plain
// version, and jax.grad of the JAX scan.
//
// Templated on the two state extensions, as the forward kernel is: NU, the
// massive-neutrino momentum hierarchy Psi_l(q_i) (NQNU nodes x l = 0..LMAXNU,
// appended after the 37 base variables at NV + NL1 i + l), and DE, the
// c_s^2 = 1 dark-energy fluid (delta_de, V = (1 + w) theta_de, after those).
// A stage-table row carries 16 base fields, then with NU eps/q and q/eps at
// each node and the (am < 2) flag, then with DE w, grho_de and dw/dtau
// times the regularized 1/(1 + w) (Layout below): 16 / 25 / 19 / 28 fields.
//
// Everything here is host and device code: csrc/perturbations.cu includes it
// for the reverse kernel, and csrc/boltzmann_adjoint_host.cpp builds it with
// a host compiler so that the adjoint is tested against autograd away from
// the card. It includes <math.h> alone.
#pragma once
#include <math.h>

#ifdef __CUDACC__
#define ADJ_HD __host__ __device__ __forceinline__
#else
#define ADJ_HD inline
#endif

namespace k1adj {

// the base state layout (models/perturbations.py _I_*)
constexpr int I_ETA = 0, I_DC = 1, I_DB = 2, I_TB = 3, I_DG = 4, I_TG = 5;
constexpr int LMAXG = 12, LMAXGP = 8, LMAXNR = 10;
constexpr int I_FG = 6, NFG = LMAXG - 1;        // F_g 2..12
constexpr int I_GP = I_FG + NFG, NGP = LMAXGP + 1;  // G 0..8
constexpr int I_DN = I_GP + NGP, I_TN = I_DN + 1;
constexpr int I_FN = I_TN + 1, NFN = LMAXNR - 1;  // F_nu 2..10
constexpr int NV = I_FN + NFN;
static_assert(NV == 37, "the base layout");
// the massive-neutrino hierarchy: NQNU nodes x l = 0..LMAXNU
constexpr int NQNU = 4, LMAXNU = 6, NL1 = LMAXNU + 1, NVNU = NQNU * NL1;
// base fields of a stage-table row (models/perturbations.py Q_*)
enum { Q_TAU, Q_OPAC, Q_CSQB, Q_DTLOC, Q_GG, Q_GN, Q_GML, Q_GC, Q_GB, Q_ADOTOA,
       Q_GRHO, Q_GPRES, Q_R, Q_VIS, Q_EXPMK, Q_GNISW, NQ };
constexpr int NPL = 7;  // source planes
constexpr double TC_KTAUC = 0.015, TC_OPACTAU = 200.0, IC_RELEASE_KTAU = 0.08;

// the state and row of an instantiation (models/perturbations.py
// extra_state, q_fields)
template <bool NU, bool DE>
struct Layout {
  static constexpr int I_NU = NV;                        // Psi_l(q_i) at I_NU + NL1 i + l
  static constexpr int I_DE = NV + (NU ? NVNU : 0);      // delta_de, V
  static constexpr int NVX = I_DE + (DE ? 2 : 0);
  static constexpr int Q_EQ = NQ, Q_QE = NQ + NQNU, Q_AMLT2 = NQ + 2 * NQNU;
  static constexpr int Q_WDE = NQ + (NU ? 2 * NQNU + 1 : 0);
  static constexpr int Q_GDE = Q_WDE + 1, Q_WPR = Q_WDE + 2;
  static constexpr int NQX = Q_WDE + (DE ? 3 : 0);
};
static_assert(Layout<false, false>::NQX == 16 && Layout<true, false>::NQX == 25 &&
                  Layout<false, true>::NQX == 19 && Layout<true, true>::NQX == 28,
              "the rows of models/perturbations.py:q_fields");
static_assert(Layout<true, true>::NVX == 67, "37 + 28 + 2 state variables");

template <typename T>
ADJ_HD T amax(T a, T b) { return a > b ? a : b; }

// what the sources read of an RHS evaluation (dgpi_extra: NU's d/dtau of
// the massive stress sum, 0 otherwise)
template <typename T>
struct Aux {
  T hdot, etadot, dgpi, sigma_g, sigma_n, sigg_dot, sign_dot, pol_term, dgpi_extra;
};

template <typename T>
ADJ_HD Aux<T> aux_zero() {
  return {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
}

// the switches of a lane at a row: they depend on (k, row) only. nu_rel
// (NU): the momentum hierarchy slaved to the massless one, rsa and (am < 2
// or k dt_loc > 0.9); the DE fluid is frozen under rsa
struct Switch {
  bool rsa, tc_on, frozen, nu_rel;
};

template <typename T, bool NU>
ADJ_HD Switch switches(const T* q, T k, T rsa_ktau) {
  const T tau = q[Q_TAU], opac = q[Q_OPAC];
  const T tauc = T(1) / amax(opac, T(1e-30));
  Switch s;
  s.rsa = k * tau >= rsa_ktau;
  const T lam = opac * (T(1) + q[Q_R]);
  const bool tc_off = ((k * tauc >= T(TC_KTAUC)) || (opac * tau <= T(TC_OPACTAU))) &&
                      (lam * q[Q_DTLOC] <= T(1.3));
  s.tc_on = !tc_off && !s.rsa;
  s.frozen = s.tc_on || s.rsa;
  s.nu_rel = false;
  if constexpr (NU) s.nu_rel = s.rsa && (q[Layout<true, false>::Q_AMLT2] != T(0) || k * q[Q_DTLOC] > T(0.9));
  return s;
}

// the node constants of the massive hierarchy: nuc[0..NQNU) the normalized
// weights, nuc[NQNU..2 NQNU) d ln f0 / d ln q (models/perturbations.py
// _nu_constants); unread without NU

// _rhs: dy and the sources' auxiliaries
template <typename T, bool NU, bool DE>
ADJ_HD void rhs(const T* y, const T* q, T k, T rsa_ktau, const T* nuc, T* dy, Aux<T>* aux) {
  using L = Layout<NU, DE>;
  const Switch sw = switches<T, NU>(q, k, rsa_ktau);
  const bool rsa = sw.rsa, tc_on = sw.tc_on;
  const T tau = q[Q_TAU], opac = q[Q_OPAC], csqb = q[Q_CSQB];
  const T gg = q[Q_GG], gn = q[Q_GN], gml = q[Q_GML], gc = q[Q_GC], gb = q[Q_GB];
  const T adotoa = q[Q_ADOTOA], R = q[Q_R];
  const T eta = y[I_ETA], dc = y[I_DC], db = y[I_DB], tb = y[I_TB];
  const T k2 = k * k;
  const T tau_safe = amax(tau, T(1e-10));
  const T tauc = T(1) / amax(opac, T(1e-30));
  const T dgrho_m = gc * dc + gb * db;
  const T z_rsa = (T(0.5) * dgrho_m / k + k * eta) / adotoa;
  const T dz_rsa = -adotoa * z_rsa - T(0.5) * dgrho_m / k;
  const T dn_rsa = -T(4) * dz_rsa / k;
  const T tn_rsa = -k * z_rsa;
  const T dg_rsa = dn_rsa - (T(4) / k) * opac * (tb / k + z_rsa);
  const T dg = rsa ? dg_rsa : y[I_DG], tg = rsa ? tn_rsa : y[I_TG];
  const T dn = rsa ? dn_rsa : y[I_DN], tn = rsa ? tn_rsa : y[I_TN];
  const T sigma_n = rsa ? T(0) : y[I_FN] / T(2);
  const T wnu_m = (T(4) / T(3)) * gml;
  // the massive species' share of the perturbed stress-energy
  T dgrho_nu, dgq_nu, dgpi_m;
  if constexpr (NU) {
    // MB95 eq 55 on the Gauss nodes, or slaved to the massless species
    const T* psi = y + L::I_NU;
    T s0 = T(0), s1 = T(0), s2 = T(0);
    for (int i = 0; i < NQNU; ++i) {
      s0 = s0 + nuc[i] * q[L::Q_EQ + i] * psi[NL1 * i];
      s1 = s1 + nuc[i] * psi[NL1 * i + 1];
      s2 = s2 + nuc[i] * q[L::Q_QE + i] * psi[NL1 * i + 2];
    }
    dgrho_nu = sw.nu_rel ? gml * dn_rsa : gml * s0;
    dgq_nu = sw.nu_rel ? (T(4) / T(3)) * gml * tn_rsa : gml * k * s1;
    dgpi_m = sw.nu_rel ? T(0) : (T(2) / T(3)) * gml * s2;
  } else {
    dgrho_nu = gml * dn;
    dgq_nu = wnu_m * tn;
    dgpi_m = wnu_m * sigma_n;
  }
  T dgrho = gc * dc + gb * db + gg * dg + gn * dn + dgrho_nu;
  T dgq = (T(4) / T(3)) * (gg * tg + gn * tn) + gb * tb + dgq_nu;
  if constexpr (DE) {
    const T gde = q[L::Q_GDE];
    dgrho = dgrho + (rsa ? T(0) : gde * y[L::I_DE]);
    dgq = dgq + (rsa ? T(0) : gde * y[L::I_DE + 1]);
  }
  const T hdot = (T(2) * k2 * eta + dgrho) / adotoa;
  const T etadot = T(0.5) * dgq / k2;
  const T fg0 = y[I_FG], gp0 = y[I_GP], gp2 = y[I_GP + 2];
  const T fg2_tca = (T(4) / T(3)) * tauc *
                    ((T(8) / T(15)) * tg + (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot);
  const T fg2_eff = rsa ? T(0) : (tc_on ? fg2_tca : fg0);
  const T sigma_g = fg2_eff / T(2);
  const T pol_term = rsa ? T(0) : (tc_on ? T(2.5) * fg2_tca : fg0 + gp0 + gp2);
  const T dgpi = (T(4) / T(3)) * (gg * sigma_g + gn * sigma_n) + dgpi_m;
  const T sl = dg / T(4) - sigma_g;
  T tbdot, tgdot;
  if (rsa) {
    tbdot = -adotoa * tb + csqb * k2 * db;
    tgdot = T(0);
  } else if (tc_on) {
    tbdot = (-adotoa * tb + csqb * k2 * db + R * k2 * sl) / (T(1) + R);
    tgdot = tbdot;
  } else {
    tbdot = -adotoa * tb + csqb * k2 * db + R * opac * (tg - tb);
    tgdot = k2 * sl + opac * (tb - tg);
  }
  dy[I_ETA] = etadot;
  dy[I_DC] = -T(0.5) * hdot;
  dy[I_DB] = -tb - T(0.5) * hdot;
  dy[I_TB] = tbdot;
  dy[I_DG] = rsa ? T(0) : -(T(4) / T(3)) * tg - (T(2) / T(3)) * hdot;
  dy[I_TG] = tgdot;
  dy[I_DN] = rsa ? T(0) : -(T(4) / T(3)) * tn - (T(2) / T(3)) * hdot;
  dy[I_TN] = rsa ? T(0) : k2 * (dn / T(4) - sigma_n);
  // photon temperature F_2..F_12
  const T fg2dot = (T(8) / T(15)) * tg - (T(3) / T(5)) * k * y[I_FG + 1] +
                   (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot -
                   opac * (T(0.9) * fg0 - T(0.1) * (gp0 + gp2));
  dy[I_FG] = sw.frozen ? T(0) : fg2dot;
  for (int j = 1; j < NFG - 1; ++j) {
    const T l = T(j + 2), c = k / (T(2) * l + T(1));
    const T v = c * (l * y[I_FG + j - 1] - (l + T(1)) * y[I_FG + j + 1]) - opac * y[I_FG + j];
    dy[I_FG + j] = sw.frozen ? T(0) : v;
  }
  {
    const T f = y[I_FG + NFG - 1];
    const T v = k * y[I_FG + NFG - 2] - T(LMAXG + 1) / tau_safe * f - opac * f;
    dy[I_FG + NFG - 1] = sw.frozen ? T(0) : v;
  }
  // photon polarization G_0..G_8
  for (int j = 0; j < NGP - 1; ++j) {
    const T l = T(j), c = k / (T(2) * l + T(1));
    const T prev = j == 0 ? T(0) : y[I_GP + j - 1];
    T v = c * (l * prev - (l + T(1)) * y[I_GP + j + 1]) - opac * y[I_GP + j];
    if (j == 0) v = v + opac * T(0.5) * pol_term;
    if (j == 2) v = v + opac * T(0.1) * pol_term;
    dy[I_GP + j] = sw.frozen ? T(0) : v;
  }
  {
    const T g = y[I_GP + NGP - 1];
    const T v = k * y[I_GP + NGP - 2] - T(LMAXGP + 1) / tau_safe * g - opac * g;
    dy[I_GP + NGP - 1] = sw.frozen ? T(0) : v;
  }
  // massless neutrinos F_2..F_10
  const T fn2dot = (T(8) / T(15)) * tn - (T(3) / T(5)) * k * y[I_FN + 1] +
                   (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot;
  dy[I_FN] = rsa ? T(0) : fn2dot;
  for (int j = 1; j < NFN - 1; ++j) {
    const T l = T(j + 2), c = k / (T(2) * l + T(1));
    const T v = c * (l * y[I_FN + j - 1] - (l + T(1)) * y[I_FN + j + 1]);
    dy[I_FN + j] = rsa ? T(0) : v;
  }
  {
    const T v = k * y[I_FN + NFN - 2] - T(LMAXNR + 1) / tau_safe * y[I_FN + NFN - 1];
    dy[I_FN + NFN - 1] = rsa ? T(0) : v;
  }
  T dgpi_extra = T(0);
  if constexpr (NU) {
    // MB95 eq 57 per node, closed by eq 58; frozen under nu_rel
    const T* psi = y + L::I_NU;
    T* dpsi = dy + L::I_NU;
    T e = T(0);
    for (int i = 0; i < NQNU; ++i) {
      const T qe = q[L::Q_QE + i], qke = qe * k, dl = nuc[NQNU + i];
      const T* p = psi + NL1 * i;
      T d2 = T(0);
      for (int l = 0; l < LMAXNU; ++l) {
        const T lf = T(l), prev = l == 0 ? T(0) : p[l - 1];
        T v = (qke / (T(2) * lf + T(1))) * (lf * prev - (lf + T(1)) * p[l + 1]);
        if (l == 0) v = v + (hdot / T(6)) * dl;
        if (l == 2) {
          v = v - (hdot / T(15) + T(2) * etadot / T(5)) * dl;
          d2 = v;
        }
        dpsi[NL1 * i + l] = sw.nu_rel ? T(0) : v;
      }
      const T v = qke * p[LMAXNU - 1] - (T(LMAXNU) + T(1)) / tau_safe * p[LMAXNU];
      dpsi[NL1 * i + LMAXNU] = sw.nu_rel ? T(0) : v;
      // d/dtau of the massive stress sum: gml' = -2 aH gml, (q/eps)' =
      // -(q/eps) (1 - (q/eps)^2) aH
      e = e + nuc[i] * (qe * d2 - (qe * (T(3) - qe * qe) * adotoa) * p[2]);
    }
    dgpi_extra = sw.nu_rel ? T(0) : (T(2) / T(3)) * gml * e;
  }
  if constexpr (DE) {
    // V = (1 + w) theta form, frozen under rsa
    const T de = y[L::I_DE], dv = y[L::I_DE + 1];
    const T w = q[L::Q_WDE], wpr = q[L::Q_WPR];
    const T ddot = -dv - (T(1) + w) * T(0.5) * hdot - T(3) * adotoa * (T(1) - w) * de -
                   (T(9) * adotoa * adotoa * (T(1) - w) + T(3) * adotoa * wpr) * dv / k2;
    const T vdot = T(2) * adotoa * dv + k2 * de + wpr * dv;
    dy[L::I_DE] = rsa ? T(0) : ddot;
    dy[L::I_DE + 1] = rsa ? T(0) : vdot;
  }
  if (aux != nullptr) {
    aux->hdot = hdot;
    aux->etadot = etadot;
    aux->dgpi = dgpi;
    aux->sigma_g = sigma_g;
    aux->sigma_n = sigma_n;
    aux->sigg_dot = (sw.frozen ? T(0) : fg2dot) / T(2);
    aux->sign_dot = (rsa ? T(0) : fn2dot) / T(2);
    aux->pol_term = pol_term;
    aux->dgpi_extra = dgpi_extra;
  }
}

// The vjp of rhs: w the cotangent of dy, ab that of aux (zero where the
// caller has none); adds the cotangents of y to yb and of the row to qb.
// The switches and the (am < 2) flag get none, as under autograd.
template <typename T, bool NU, bool DE>
ADJ_HD void rhs_vjp(const T* y, const T* q, T k, T rsa_ktau, const T* nuc, const T* w,
                    const Aux<T>& ab, T* yb, T* qb) {
  using L = Layout<NU, DE>;
  const Switch sw = switches<T, NU>(q, k, rsa_ktau);
  const bool rsa = sw.rsa, tc_on = sw.tc_on, frozen = sw.frozen, nu_rel = sw.nu_rel;
  const T tau = q[Q_TAU], opac = q[Q_OPAC], csqb = q[Q_CSQB];
  const T gg = q[Q_GG], gn = q[Q_GN], gml = q[Q_GML], gc = q[Q_GC], gb = q[Q_GB];
  const T adotoa = q[Q_ADOTOA], R = q[Q_R];
  const T eta = y[I_ETA], dc = y[I_DC], db = y[I_DB], tb = y[I_TB];
  const T k2 = k * k;
  const T tau_safe = amax(tau, T(1e-10));
  const T tauc = T(1) / amax(opac, T(1e-30));
  // the forward values the reverse reads
  const T dgrho_m = gc * dc + gb * db;
  const T z_rsa = (T(0.5) * dgrho_m / k + k * eta) / adotoa;
  const T dz_rsa = -adotoa * z_rsa - T(0.5) * dgrho_m / k;
  const T dn_rsa = -T(4) * dz_rsa / k;
  const T tn_rsa = -k * z_rsa;
  const T dg_rsa = dn_rsa - (T(4) / k) * opac * (tb / k + z_rsa);
  const T dg = rsa ? dg_rsa : y[I_DG], tg = rsa ? tn_rsa : y[I_TG];
  const T dn = rsa ? dn_rsa : y[I_DN], tn = rsa ? tn_rsa : y[I_TN];
  const T sigma_n = rsa ? T(0) : y[I_FN] / T(2);
  const T wnu_m = (T(4) / T(3)) * gml;
  T s0 = T(0), s1 = T(0), s2 = T(0), dgrho_nu, dgq_nu;
  if constexpr (NU) {
    const T* psi = y + L::I_NU;
    for (int i = 0; i < NQNU; ++i) {
      s0 = s0 + nuc[i] * q[L::Q_EQ + i] * psi[NL1 * i];
      s1 = s1 + nuc[i] * psi[NL1 * i + 1];
      s2 = s2 + nuc[i] * q[L::Q_QE + i] * psi[NL1 * i + 2];
    }
    dgrho_nu = nu_rel ? gml * dn_rsa : gml * s0;
    dgq_nu = nu_rel ? (T(4) / T(3)) * gml * tn_rsa : gml * k * s1;
  } else {
    dgrho_nu = gml * dn;
    dgq_nu = wnu_m * tn;
  }
  T dgrho = gc * dc + gb * db + gg * dg + gn * dn + dgrho_nu;
  T dgq = (T(4) / T(3)) * (gg * tg + gn * tn) + gb * tb + dgq_nu;
  if constexpr (DE) {
    const T gde = q[L::Q_GDE];
    dgrho = dgrho + (rsa ? T(0) : gde * y[L::I_DE]);
    dgq = dgq + (rsa ? T(0) : gde * y[L::I_DE + 1]);
  }
  const T hdot = (T(2) * k2 * eta + dgrho) / adotoa;
  const T etadot = T(0.5) * dgq / k2;
  const T fg0 = y[I_FG], gp0 = y[I_GP], gp2 = y[I_GP + 2];
  const T B = (T(8) / T(15)) * tg + (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot;
  const T fg2_tca = (T(4) / T(3)) * tauc * B;
  const T fg2_eff = rsa ? T(0) : (tc_on ? fg2_tca : fg0);
  const T sigma_g = fg2_eff / T(2);
  const T pol_term = rsa ? T(0) : (tc_on ? T(2.5) * fg2_tca : fg0 + gp0 + gp2);
  const T sl = dg / T(4) - sigma_g;

  T hdot_b = ab.hdot, etadot_b = ab.etadot + w[I_ETA], dgpi_b = ab.dgpi;
  T sigma_g_b = ab.sigma_g, sigma_n_b = ab.sigma_n, pol_b = ab.pol_term;
  T fg2dot_b = frozen ? T(0) : ab.sigg_dot / T(2);
  T fn2dot_b = rsa ? T(0) : ab.sign_dot / T(2);
  T tg_b = T(0), tn_b = T(0), dg_b = T(0), dn_b = T(0), sl_b = T(0), fg2_tca_b = T(0);
  T tau_safe_b = T(0), opac_b = T(0), adotoa_b = T(0), R_b = T(0), csqb_b = T(0);
  T gg_b = T(0), gn_b = T(0), gml_b = T(0), gc_b = T(0), gb_b = T(0);
  T eta_b = T(0), dc_b = T(0), db_b = T(0), tb_b = T(0);

  // the DE fluid's derivatives
  if constexpr (DE) {
    if (!rsa) {
      const T de = y[L::I_DE], dv = y[L::I_DE + 1];
      const T wde = q[L::Q_WDE], wpr = q[L::Q_WPR];
      const T wd = w[L::I_DE], wv = w[L::I_DE + 1];
      const T omw = T(1) - wde;
      T wde_b = T(0), wpr_b = T(0), de_b = T(0), dv_b = T(0);
      // ddot = -dv - (1 + w) hdot / 2 - 3 aH (1 - w) de - (9 aH^2 (1 - w) + 3 aH w') dv / k2
      dv_b -= wd;
      wde_b -= T(0.5) * hdot * wd;
      hdot_b -= (T(1) + wde) * T(0.5) * wd;
      adotoa_b -= T(3) * omw * de * wd;
      wde_b += T(3) * adotoa * de * wd;
      de_b -= T(3) * adotoa * omw * wd;
      const T c2 = T(9) * adotoa * adotoa * omw + T(3) * adotoa * wpr;
      const T c2_b = -(dv / k2) * wd;
      dv_b -= c2 / k2 * wd;
      adotoa_b += (T(18) * adotoa * omw + T(3) * wpr) * c2_b;
      wde_b -= T(9) * adotoa * adotoa * c2_b;
      wpr_b += T(3) * adotoa * c2_b;
      // vdot = 2 aH dv + k2 de + w' dv
      adotoa_b += T(2) * dv * wv;
      dv_b += (T(2) * adotoa + wpr) * wv;
      de_b += k2 * wv;
      wpr_b += dv * wv;
      yb[L::I_DE] += de_b;
      yb[L::I_DE + 1] += dv_b;
      qb[L::Q_WDE] += wde_b;
      qb[L::Q_WPR] += wpr_b;
    }
  }
  // the momentum hierarchy and the sources' d/dtau of its stress sum
  if constexpr (NU) {
    if (!nu_rel) {
      const T* psi = y + L::I_NU;
      T* psib = yb + L::I_NU;
      const T* wp = w + L::I_NU;
      T e = T(0), d2[NQNU];
      for (int i = 0; i < NQNU; ++i) {
        const T qe = q[L::Q_QE + i], qke = qe * k, dl = nuc[NQNU + i];
        const T* p = psi + NL1 * i;
        d2[i] = (qke / T(5)) * (T(2) * p[1] - T(3) * p[3]) -
                (hdot / T(15) + T(2) * etadot / T(5)) * dl;
        e = e + nuc[i] * (qe * d2[i] - (qe * (T(3) - qe * qe) * adotoa) * p[2]);
      }
      // dgpi_extra = 2/3 gml e
      const T e_b = (T(2) / T(3)) * gml * ab.dgpi_extra;
      gml_b += (T(2) / T(3)) * e * ab.dgpi_extra;
      for (int i = 0; i < NQNU; ++i) {
        const T qe = q[L::Q_QE + i], qke = qe * k, dl = nuc[NQNU + i];
        const T* p = psi + NL1 * i;
        T* pb = psib + NL1 * i;
        const T wn = nuc[i];
        const T cube = qe * (T(3) - qe * qe);
        T qe_b = wn * (d2[i] - (T(3) - T(3) * qe * qe) * adotoa * p[2]) * e_b;
        adotoa_b -= wn * cube * p[2] * e_b;
        pb[2] -= wn * cube * adotoa * e_b;
        T qke_b = T(0);
        for (int l = 0; l < LMAXNU; ++l) {
          const T lf = T(l), c = qke / (T(2) * lf + T(1));
          const T prev = l == 0 ? T(0) : p[l - 1];
          T W = wp[NL1 * i + l];
          if (l == 2) W = W + wn * qe * e_b;
          qke_b += (lf * prev - (lf + T(1)) * p[l + 1]) / (T(2) * lf + T(1)) * W;
          if (l > 0) pb[l - 1] += c * lf * W;
          pb[l + 1] -= c * (lf + T(1)) * W;
          if (l == 0) hdot_b += dl / T(6) * W;
          if (l == 2) {
            hdot_b -= dl / T(15) * W;
            etadot_b -= T(2) * dl / T(5) * W;
          }
        }
        {
          const T W = wp[NL1 * i + LMAXNU];
          const T cl = (T(LMAXNU) + T(1)) / tau_safe;
          qke_b += p[LMAXNU - 1] * W;
          pb[LMAXNU - 1] += qke * W;
          pb[LMAXNU] -= cl * W;
          tau_safe_b += cl / tau_safe * p[LMAXNU] * W;
        }
        qe_b += k * qke_b;
        qb[L::Q_QE + i] += qe_b;
      }
    }
  }

  // massless neutrinos
  if (!rsa) {
    fn2dot_b = fn2dot_b + w[I_FN];
    for (int j = 1; j < NFN - 1; ++j) {
      const T l = T(j + 2), c = k / (T(2) * l + T(1)), wj = w[I_FN + j];
      yb[I_FN + j - 1] += c * l * wj;
      yb[I_FN + j + 1] -= c * (l + T(1)) * wj;
    }
    const T wl = w[I_FN + NFN - 1], f = y[I_FN + NFN - 1];
    yb[I_FN + NFN - 2] += k * wl;
    yb[I_FN + NFN - 1] -= T(LMAXNR + 1) / tau_safe * wl;
    tau_safe_b += T(LMAXNR + 1) / (tau_safe * tau_safe) * f * wl;
  }
  tn_b += (T(8) / T(15)) * fn2dot_b;
  yb[I_FN + 1] -= (T(3) / T(5)) * k * fn2dot_b;
  hdot_b += (T(4) / T(15)) * fn2dot_b;
  etadot_b += (T(8) / T(5)) * fn2dot_b;
  // photon hierarchies
  if (!frozen) {
    fg2dot_b = fg2dot_b + w[I_FG];
    for (int j = 1; j < NFG - 1; ++j) {
      const T l = T(j + 2), c = k / (T(2) * l + T(1)), wj = w[I_FG + j];
      yb[I_FG + j - 1] += c * l * wj;
      yb[I_FG + j + 1] -= c * (l + T(1)) * wj;
      yb[I_FG + j] -= opac * wj;
      opac_b -= y[I_FG + j] * wj;
    }
    {
      const T wl = w[I_FG + NFG - 1], f = y[I_FG + NFG - 1];
      yb[I_FG + NFG - 2] += k * wl;
      yb[I_FG + NFG - 1] -= (T(LMAXG + 1) / tau_safe + opac) * wl;
      tau_safe_b += T(LMAXG + 1) / (tau_safe * tau_safe) * f * wl;
      opac_b -= f * wl;
    }
    for (int j = 0; j < NGP - 1; ++j) {
      const T l = T(j), c = k / (T(2) * l + T(1)), wj = w[I_GP + j];
      if (j > 0) yb[I_GP + j - 1] += c * l * wj;
      yb[I_GP + j + 1] -= c * (l + T(1)) * wj;
      yb[I_GP + j] -= opac * wj;
      opac_b -= y[I_GP + j] * wj;
    }
    opac_b += T(0.5) * pol_term * w[I_GP] + T(0.1) * pol_term * w[I_GP + 2];
    pol_b += T(0.5) * opac * w[I_GP] + T(0.1) * opac * w[I_GP + 2];
    {
      const T wl = w[I_GP + NGP - 1], g = y[I_GP + NGP - 1];
      yb[I_GP + NGP - 2] += k * wl;
      yb[I_GP + NGP - 1] -= (T(LMAXGP + 1) / tau_safe + opac) * wl;
      tau_safe_b += T(LMAXGP + 1) / (tau_safe * tau_safe) * g * wl;
      opac_b -= g * wl;
    }
  }
  tg_b += (T(8) / T(15)) * fg2dot_b;
  yb[I_FG + 1] -= (T(3) / T(5)) * k * fg2dot_b;
  hdot_b += (T(4) / T(15)) * fg2dot_b;
  etadot_b += (T(8) / T(5)) * fg2dot_b;
  opac_b -= (T(0.9) * fg0 - T(0.1) * (gp0 + gp2)) * fg2dot_b;
  yb[I_FG] -= T(0.9) * opac * fg2dot_b;
  yb[I_GP] += T(0.1) * opac * fg2dot_b;
  yb[I_GP + 2] += T(0.1) * opac * fg2dot_b;
  // the fluid derivatives
  if (!rsa) {
    const T w7 = w[I_TN], w6 = w[I_DN], w4 = w[I_DG];
    dn_b += k2 / T(4) * w7;
    sigma_n_b -= k2 * w7;
    tn_b -= (T(4) / T(3)) * w6;
    hdot_b -= (T(2) / T(3)) * w6;
    tg_b -= (T(4) / T(3)) * w4;
    hdot_b -= (T(2) / T(3)) * w4;
  }
  hdot_b -= T(0.5) * w[I_DC];
  tb_b -= w[I_DB];
  hdot_b -= T(0.5) * w[I_DB];
  {
    const T w3 = w[I_TB], w5 = w[I_TG];
    if (rsa) {
      adotoa_b -= tb * w3;
      tb_b -= adotoa * w3;
      csqb_b += k2 * db * w3;
      db_b += csqb * k2 * w3;
    } else if (tc_on) {
      const T X = -adotoa * tb + csqb * k2 * db + R * k2 * sl;
      const T Xb = (w3 + w5) / (T(1) + R);
      R_b -= X / ((T(1) + R) * (T(1) + R)) * (w3 + w5);
      adotoa_b -= tb * Xb;
      tb_b -= adotoa * Xb;
      csqb_b += k2 * db * Xb;
      db_b += csqb * k2 * Xb;
      R_b += k2 * sl * Xb;
      sl_b += R * k2 * Xb;
    } else {
      adotoa_b -= tb * w3;
      tb_b -= adotoa * w3;
      csqb_b += k2 * db * w3;
      db_b += csqb * k2 * w3;
      R_b += opac * (tg - tb) * w3;
      opac_b += R * (tg - tb) * w3;
      tg_b += R * opac * w3;
      tb_b -= R * opac * w3;
      sl_b += k2 * w5;
      opac_b += (tb - tg) * w5;
      tb_b += opac * w5;
      tg_b -= opac * w5;
    }
  }
  // sl, dgpi, pol_term, fg2_eff
  dg_b += sl_b / T(4);
  sigma_g_b -= sl_b;
  const T dgpi_m_b = dgpi_b;
  gg_b += (T(4) / T(3)) * sigma_g * dgpi_b;
  sigma_g_b += (T(4) / T(3)) * gg * dgpi_b;
  gn_b += (T(4) / T(3)) * sigma_n * dgpi_b;
  sigma_n_b += (T(4) / T(3)) * gn * dgpi_b;
  if (!rsa) {
    if (tc_on) {
      fg2_tca_b += T(2.5) * pol_b + sigma_g_b / T(2);
    } else {
      yb[I_FG] += pol_b + sigma_g_b / T(2);
      yb[I_GP] += pol_b;
      yb[I_GP + 2] += pol_b;
    }
  }
  // fg2_tca = 4/3 tauc B
  const T tauc_b = (T(4) / T(3)) * B * fg2_tca_b;
  const T B_b = (T(4) / T(3)) * tauc * fg2_tca_b;
  tg_b += (T(8) / T(15)) * B_b;
  hdot_b += (T(4) / T(15)) * B_b;
  etadot_b += (T(8) / T(5)) * B_b;
  // etadot, hdot
  const T dgq_b = T(0.5) * etadot_b / k2;
  eta_b += T(2) * k2 * hdot_b / adotoa;
  const T dgrho_b = hdot_b / adotoa;
  adotoa_b -= hdot / adotoa * hdot_b;
  // the DE fluid's density and flux
  if constexpr (DE) {
    if (!rsa) {
      const T gde = q[L::Q_GDE];
      qb[L::Q_GDE] += y[L::I_DE] * dgrho_b + y[L::I_DE + 1] * dgq_b;
      yb[L::I_DE] += gde * dgrho_b;
      yb[L::I_DE + 1] += gde * dgq_b;
    }
  }
  // the massive species' shares, dgq, dgrho
  if constexpr (NU) {
    if (nu_rel) {
      // gml dn_rsa and 4/3 gml tn_rsa: dn, tn hold the slaved values here
      gml_b += dn * dgrho_b + (T(4) / T(3)) * tn * dgq_b;
      dn_b += gml * dgrho_b;
      tn_b += (T(4) / T(3)) * gml * dgq_b;
    } else {
      const T* psi = y + L::I_NU;
      T* psib = yb + L::I_NU;
      gml_b += s0 * dgrho_b + k * s1 * dgq_b + (T(2) / T(3)) * s2 * dgpi_m_b;
      const T r_b = gml * dgrho_b, q_b = gml * k * dgq_b, p_b = (T(2) / T(3)) * gml * dgpi_m_b;
      for (int i = 0; i < NQNU; ++i) {
        const T wn = nuc[i];
        psib[NL1 * i] += wn * q[L::Q_EQ + i] * r_b;
        qb[L::Q_EQ + i] += wn * psi[NL1 * i] * r_b;
        psib[NL1 * i + 1] += wn * q_b;
        psib[NL1 * i + 2] += wn * q[L::Q_QE + i] * p_b;
        qb[L::Q_QE + i] += wn * psi[NL1 * i + 2] * p_b;
      }
    }
  } else {
    // dgpi_m = wnu_m sigma_n, dgq_m = wnu_m tn, dgrho_m = gml dn
    T wnu_m_b = sigma_n * dgpi_m_b;
    sigma_n_b += wnu_m * dgpi_m_b;
    wnu_m_b += tn * dgq_b;
    tn_b += wnu_m * dgq_b;
    gml_b += dn * dgrho_b;
    dn_b += gml * dgrho_b;
    gml_b += (T(4) / T(3)) * wnu_m_b;
  }
  gg_b += (T(4) / T(3)) * tg * dgq_b;
  tg_b += (T(4) / T(3)) * gg * dgq_b;
  gn_b += (T(4) / T(3)) * tn * dgq_b;
  tn_b += (T(4) / T(3)) * gn * dgq_b;
  gb_b += tb * dgq_b;
  tb_b += gb * dgq_b;
  gc_b += dc * dgrho_b;
  dc_b += gc * dgrho_b;
  gb_b += db * dgrho_b;
  db_b += gb * dgrho_b;
  gg_b += dg * dgrho_b;
  dg_b += gg * dgrho_b;
  gn_b += dn * dgrho_b;
  dn_b += gn * dgrho_b;
  if (!rsa) yb[I_FN] += sigma_n_b / T(2);
  // the RSA substitutions
  if (rsa) {
    const T dg_rsa_b = dg_b, tn_rsa_b = tg_b + tn_b;
    const T dn_rsa_b = dn_b + dg_rsa_b;
    opac_b -= (T(4) / k) * (tb / k + z_rsa) * dg_rsa_b;
    tb_b -= (T(4) / k) * opac * dg_rsa_b / k;
    T z_rsa_b = -(T(4) / k) * opac * dg_rsa_b - k * tn_rsa_b;
    const T dz_rsa_b = -T(4) * dn_rsa_b / k;
    adotoa_b -= z_rsa * dz_rsa_b;
    z_rsa_b -= adotoa * dz_rsa_b;
    T dgrho_m_b = -T(0.5) * dz_rsa_b / k;
    const T N_b = z_rsa_b / adotoa;
    adotoa_b -= z_rsa / adotoa * z_rsa_b;
    dgrho_m_b += T(0.5) * N_b / k;
    eta_b += k * N_b;
    gc_b += dc * dgrho_m_b;
    dc_b += gc * dgrho_m_b;
    gb_b += db * dgrho_m_b;
    db_b += gb * dgrho_m_b;
  } else {
    yb[I_DG] += dg_b;
    yb[I_TG] += tg_b;
    yb[I_DN] += dn_b;
    yb[I_TN] += tn_b;
  }
  yb[I_ETA] += eta_b;
  yb[I_DC] += dc_b;
  yb[I_DB] += db_b;
  yb[I_TB] += tb_b;
  if (opac > T(1e-30)) opac_b -= tauc * tauc * tauc_b;
  if (tau > T(1e-10)) qb[Q_TAU] += tau_safe_b;
  qb[Q_OPAC] += opac_b;
  qb[Q_CSQB] += csqb_b;
  qb[Q_GG] += gg_b;
  qb[Q_GN] += gn_b;
  qb[Q_GML] += gml_b;
  qb[Q_GC] += gc_b;
  qb[Q_GB] += gb_b;
  qb[Q_ADOTOA] += adotoa_b;
  qb[Q_R] += R_b;
}

// _sources: the 7 planes at a node from the state, its derivative and aux
template <typename T, bool NU>
ADJ_HD void sources(const T* y, const T* dy, const Aux<T>& a, const T* q, T k, T* s) {
  const T adotoa = q[Q_ADOTOA], gg = q[Q_GG], gni = q[Q_GNISW];
  const T vis = q[Q_VIS], expmk = q[Q_EXPMK];
  const T k2 = k * k;
  const T alpha = (a.hdot + T(6) * a.etadot) / (T(2) * k2);
  const T X = T(1.5) * a.dgpi / k2;
  const T eta = y[I_ETA];
  const T phi = eta - adotoa * alpha;
  const T psi = phi - X;
  const T dadotoa = -(q[Q_GRHO] + T(3) * q[Q_GPRES]) / T(6);
  const T alphadot = eta - X - T(2) * adotoa * alpha;
  const T phidot = a.etadot - dadotoa * alpha - adotoa * alphadot;
  T dgpidot = (T(4) / T(3)) * (-T(2) * adotoa * (gg * a.sigma_g + gni * a.sigma_n) +
                               gg * a.sigg_dot + gni * a.sign_dot);
  if (NU) dgpidot = dgpidot + a.dgpi_extra;
  const T psidot = phidot - T(1.5) * dgpidot / k2;
  const T theta0_N = y[I_DG] / T(4) - adotoa * alpha;
  const T vb_N = (y[I_TB] + k2 * alpha) / k;
  const T Pi = a.pol_term / T(4);
  s[0] = vis * (theta0_N + psi + Pi / T(4)) + expmk * (phidot + psidot);
  s[1] = vis * vb_N;
  s[2] = T(0.75) * vis * Pi;
  s[3] = expmk * (phi + psi);
  const T gc = q[Q_GC], gb = q[Q_GB], ws = gc + gb;
  s[4] = (gc * y[I_DC] + gb * y[I_DB]) / ws;
  s[5] = (gc * dy[I_DC] + gb * dy[I_DB]) / ws;
  s[6] = T(0.5) * (phi + psi);
}

// The vjp of sources for the cotangents g of the planes: adds to yb, to the
// row's qb, to the cotangent of dy (its DC and DB entries, dyb) and of aux
template <typename T, bool NU>
ADJ_HD void sources_vjp(const T* y, const T* dy, const Aux<T>& a, const T* q, T k,
                        const T* g, T* yb, T* dyb, Aux<T>* ab, T* qb) {
  const T adotoa = q[Q_ADOTOA], gg = q[Q_GG], gni = q[Q_GNISW];
  const T vis = q[Q_VIS], expmk = q[Q_EXPMK];
  const T k2 = k * k;
  const T alpha = (a.hdot + T(6) * a.etadot) / (T(2) * k2);
  const T X = T(1.5) * a.dgpi / k2;
  const T eta = y[I_ETA];
  const T phi = eta - adotoa * alpha;
  const T psi = phi - X;
  const T dadotoa = -(q[Q_GRHO] + T(3) * q[Q_GPRES]) / T(6);
  const T alphadot = eta - X - T(2) * adotoa * alpha;
  const T phidot = a.etadot - dadotoa * alpha - adotoa * alphadot;
  T dgpidot = (T(4) / T(3)) * (-T(2) * adotoa * (gg * a.sigma_g + gni * a.sigma_n) +
                               gg * a.sigg_dot + gni * a.sign_dot);
  if (NU) dgpidot = dgpidot + a.dgpi_extra;
  const T psidot = phidot - T(1.5) * dgpidot / k2;
  const T theta0_N = y[I_DG] / T(4) - adotoa * alpha;
  const T vb_N = (y[I_TB] + k2 * alpha) / k;
  const T Pi = a.pol_term / T(4);

  qb[Q_VIS] += (theta0_N + psi + Pi / T(4)) * g[0] + vb_N * g[1] + T(0.75) * Pi * g[2];
  qb[Q_EXPMK] += (phidot + psidot) * g[0] + (phi + psi) * g[3];
  const T theta0_N_b = vis * g[0];
  T psi_b = vis * g[0] + expmk * g[3] + T(0.5) * g[6];
  const T Pi_b = vis * g[0] / T(4) + T(0.75) * vis * g[2];
  T phidot_b = expmk * g[0];
  const T psidot_b = expmk * g[0];
  const T vb_N_b = vis * g[1];
  T phi_b = expmk * g[3] + T(0.5) * g[6];
  // the matter planes
  const T gc = q[Q_GC], gb = q[Q_GB], ws = gc + gb;
  const T n4 = gc * y[I_DC] + gb * y[I_DB], n5 = gc * dy[I_DC] + gb * dy[I_DB];
  const T w4 = g[4] / ws, w5 = g[5] / ws;
  const T ws_b = -(n4 / ws) * w4 - (n5 / ws) * w5;
  qb[Q_GC] += y[I_DC] * w4 + dy[I_DC] * w5 + ws_b;
  qb[Q_GB] += y[I_DB] * w4 + dy[I_DB] * w5 + ws_b;
  yb[I_DC] += gc * w4;
  yb[I_DB] += gb * w4;
  dyb[I_DC] += gc * w5;
  dyb[I_DB] += gb * w5;
  // the potentials
  ab->pol_term += Pi_b / T(4);
  yb[I_TB] += vb_N_b / k;
  T alpha_b = k2 * (vb_N_b / k);
  yb[I_DG] += theta0_N_b / T(4);
  T adotoa_b = -alpha * theta0_N_b;
  alpha_b -= adotoa * theta0_N_b;
  phidot_b += psidot_b;
  const T dgpidot_b = -T(1.5) * psidot_b / k2;
  if (NU) ab->dgpi_extra += dgpidot_b;
  const T D_b = (T(4) / T(3)) * dgpidot_b;
  adotoa_b += -T(2) * (gg * a.sigma_g + gni * a.sigma_n) * D_b;
  qb[Q_GG] += (-T(2) * adotoa * a.sigma_g + a.sigg_dot) * D_b;
  qb[Q_GNISW] += (-T(2) * adotoa * a.sigma_n + a.sign_dot) * D_b;
  ab->sigma_g += -T(2) * adotoa * gg * D_b;
  ab->sigma_n += -T(2) * adotoa * gni * D_b;
  ab->sigg_dot += gg * D_b;
  ab->sign_dot += gni * D_b;
  ab->etadot += phidot_b;
  const T dadotoa_b = -alpha * phidot_b;
  alpha_b -= dadotoa * phidot_b;
  adotoa_b -= alphadot * phidot_b;
  const T alphadot_b = -adotoa * phidot_b;
  T eta_b = alphadot_b;
  T X_b = -alphadot_b;
  adotoa_b -= T(2) * alpha * alphadot_b;
  alpha_b -= T(2) * adotoa * alphadot_b;
  qb[Q_GRHO] -= dadotoa_b / T(6);
  qb[Q_GPRES] -= T(3) * dadotoa_b / T(6);
  phi_b += psi_b;
  X_b -= psi_b;
  eta_b += phi_b;
  adotoa_b -= alpha * phi_b;
  alpha_b -= adotoa * phi_b;
  ab->dgpi += T(1.5) * X_b / k2;
  ab->hdot += alpha_b / (T(2) * k2);
  ab->etadot += T(6) * alpha_b / (T(2) * k2);
  yb[I_ETA] += eta_b;
  qb[Q_ADOTOA] += adotoa_b;
}

// the chain's CDM-isocurvature amplitude b, omega and R_c
template <typename T>
struct Iso {
  T b, om, rc;
};

// adiabatic_ics with the isocurvature admixture (taken also where b = 0, as
// the plain version does when it is given one, so d/db is there); with NU,
// Psi_0..2 of each node from the combined moments (MB95 eq 98); the DE
// fluid starts at zero
template <typename T, bool NU, bool DE>
ADJ_HD void ics(T k, T tau, T rnu, const Iso<T>& iso, const T* nuc, T* y) {
  using L = Layout<NU, DE>;
  const T kt = k * tau;
  T dg = -(T(2) / T(3)) * (kt * kt);
  T theta = -(T(1) / T(18)) * k * (kt * kt * kt);
  T tn = theta * (T(23) + T(4) * rnu) / (T(15) + T(4) * rnu);
  T fn2 = T(2) * (T(2) * (kt * kt) / (T(3) * (T(15) + T(4) * rnu)));
  T eta = T(2) - (T(5) + T(4) * rnu) / (T(6) * (T(15) + T(4) * rnu)) * (kt * kt);
  T dc = T(0.75) * dg, db = T(0.75) * dg, dn = dg, tb = theta;
  const T b = iso.b, ot = iso.om * tau;
  const T dgi = iso.rc * ot * (T(4) / T(3) - T(0.5) * ot);
  dc = dc + b * (-T(2) + T(0.75) * dgi);
  db = db + b * T(0.75) * dgi;
  dg = dg + b * dgi;
  dn = dn + b * dgi;
  const T ti = iso.rc * k * ot * kt / T(6);
  tb = tb + b * ti;
  theta = theta + b * ti;
  tn = tn + b * ti;
  fn2 = fn2 + b * (iso.rc * ot * (kt * kt) / (T(3) * (T(2) * rnu + T(15))));
  eta = eta + b * (iso.rc * ot * (T(1) / T(3) - ot / T(8)));
  for (int i = 0; i < L::NVX; ++i) y[i] = T(0);
  y[I_DG] = dg;
  y[I_DC] = dc;
  y[I_DB] = db;
  y[I_DN] = dn;
  y[I_TG] = theta;
  y[I_TB] = tb;
  y[I_TN] = tn;
  y[I_FN] = fn2;
  y[I_ETA] = eta;
  if constexpr (NU) {
    for (int i = 0; i < NQNU; ++i) {
      const T dl = nuc[NQNU + i];
      y[L::I_NU + NL1 * i] = -(T(0.25) * dn) * dl;
      y[L::I_NU + NL1 * i + 1] = -(tn / (T(3) * k)) * dl;
      y[L::I_NU + NL1 * i + 2] = -(T(0.25) * fn2) * dl;
    }
  }
}

// the vjp of ics: adds to *tau_b, *rnu_b and isob (b, om, rc)
template <typename T, bool NU, bool DE>
ADJ_HD void ics_vjp(T k, T tau, T rnu, const Iso<T>& iso, const T* nuc, const T* ybx,
                    T* tau_b, T* rnu_b, T* isob) {
  using L = Layout<NU, DE>;
  // the cotangents of the fluid values (dn, tn, fn2 also through Psi_0..2)
  T Ydn = ybx[I_DN], Ytn = ybx[I_TN], Yfn = ybx[I_FN];
  if constexpr (NU) {
    for (int i = 0; i < NQNU; ++i) {
      const T dl = nuc[NQNU + i];
      Ydn -= T(0.25) * dl * ybx[L::I_NU + NL1 * i];
      Ytn -= dl * ybx[L::I_NU + NL1 * i + 1] / (T(3) * k);
      Yfn -= T(0.25) * dl * ybx[L::I_NU + NL1 * i + 2];
    }
  }
  const T kt = k * tau, kt2 = kt * kt;
  const T d15 = T(15) + T(4) * rnu, d15b = T(2) * rnu + T(15);
  const T theta0 = -(T(1) / T(18)) * k * (kt2 * kt);
  const T b = iso.b, ot = iso.om * tau;
  const T dgi = iso.rc * ot * (T(4) / T(3) - T(0.5) * ot);
  const T ti = iso.rc * k * ot * kt / T(6);
  const T F = iso.rc * ot * kt2 / (T(3) * d15b);
  const T E = iso.rc * ot * (T(1) / T(3) - ot / T(8));
  const T Ydg = ybx[I_DG], Ydc = ybx[I_DC], Ydb = ybx[I_DB];
  const T Ytg = ybx[I_TG], Ytb = ybx[I_TB], Yeta = ybx[I_ETA];
  const T dg0_b = Ydg + T(0.75) * Ydc + T(0.75) * Ydb + Ydn;
  const T theta0_b = Ytg + Ytb + Ytn * (T(23) + T(4) * rnu) / d15;
  const T ti_b = b * (Ytg + Ytb + Ytn);
  const T dgi_b = b * (Ydg + T(0.75) * Ydc + T(0.75) * Ydb + Ydn);
  T kt_b = -(T(4) / T(3)) * kt * dg0_b - (T(3) / T(18)) * k * kt2 * theta0_b +
           T(8) * kt / (T(3) * d15) * Yfn - T(2) * kt * (T(5) + T(4) * rnu) / (T(6) * d15) * Yeta;
  T ot_b = iso.rc * (T(4) / T(3) - ot) * dgi_b;
  kt_b += iso.rc * k * ot / T(6) * ti_b;
  ot_b += iso.rc * k * kt / T(6) * ti_b;
  kt_b += b * Yfn * iso.rc * ot * T(2) * kt / (T(3) * d15b);
  ot_b += b * Yfn * iso.rc * kt2 / (T(3) * d15b);
  ot_b += b * Yeta * iso.rc * (T(1) / T(3) - ot / T(4));
  *rnu_b += Ytn * theta0 * (-T(32)) / (d15 * d15) - T(16) * kt2 / (T(3) * d15 * d15) * Yfn -
            T(40) * kt2 / (T(6) * d15 * d15) * Yeta -
            b * Yfn * T(2) * iso.rc * ot * kt2 / (T(3) * d15b * d15b);
  *tau_b += k * kt_b + iso.om * ot_b;
  isob[0] += dgi * (Ydg + T(0.75) * Ydb + Ydn) + (-T(2) + T(0.75) * dgi) * Ydc +
             ti * (Ytg + Ytb + Ytn) + F * Yfn + E * Yeta;
  isob[1] += tau * ot_b;
  isob[2] += ot * (T(4) / T(3) - T(0.5) * ot) * dgi_b + k * ot * kt / T(6) * ti_b +
             b * Yfn * ot * kt2 / (T(3) * d15b) + b * Yeta * ot * (T(1) / T(3) - ot / T(8));
}

// One step of _evolve_plain from y over the rows qa, qm, qb: the new state
// (the held ICs at tau_b before the lane's release)
template <typename T, bool NU, bool DE>
ADJ_HD void step(const T* y, const T* qa, const T* qm, const T* qb, T k, T rsa_ktau, T rnu,
                 const Iso<T>& iso, const T* nuc, T* yn) {
  constexpr int N = Layout<NU, DE>::NVX;
  const T tau_a = qa[Q_TAU], tau_b = qb[Q_TAU], dt = tau_b - tau_a;
  if (!(k * tau_b >= T(IC_RELEASE_KTAU) || tau_b >= T(3))) {
    ics<T, NU, DE>(k, tau_b, rnu, iso, nuc, yn);
    return;
  }
  T k1[N], k2[N], yt[N];
  rhs<T, NU, DE>(y, qa, k, rsa_ktau, nuc, k1, (Aux<T>*)nullptr);
  for (int i = 0; i < N; ++i) yt[i] = y[i] + T(0.5) * dt * k1[i];
  rhs<T, NU, DE>(yt, qm, k, rsa_ktau, nuc, k2, (Aux<T>*)nullptr);
  for (int i = 0; i < N; ++i) {
    yt[i] = y[i] + T(0.5) * dt * k2[i];
    k1[i] = k1[i] + T(2) * k2[i];
  }
  rhs<T, NU, DE>(yt, qm, k, rsa_ktau, nuc, k2, (Aux<T>*)nullptr);
  for (int i = 0; i < N; ++i) {
    yt[i] = y[i] + dt * k2[i];
    k1[i] = k1[i] + T(2) * k2[i];
  }
  rhs<T, NU, DE>(yt, qb, k, rsa_ktau, nuc, k2, (Aux<T>*)nullptr);
  for (int i = 0; i < N; ++i) yn[i] = y[i] + (dt / T(6)) * (k1[i] + k2[i]);
}

// The vjp of one step and of the sources it emits at tau_b. y: the state
// before the step, yn: after it; ynb: the cotangent of yn from the later
// steps; g: the cotangents of the step's 7 planes. Writes the cotangent of
// y to yb and adds the rows' cotangents to qab, qmb, qbb and the ICs' to
// *rnu_b and isob.
template <typename T, bool NU, bool DE>
ADJ_HD void step_vjp(const T* y, const T* yn, const T* qa, const T* qm, const T* qb, T k,
                     T rsa_ktau, T rnu, const Iso<T>& iso, const T* nuc, const T* ynb,
                     const T* g, T* yb, T* qab, T* qmb, T* qbb, T* rnu_b, T* isob) {
  constexpr int N = Layout<NU, DE>::NVX;
  // the sources at (yn, tau_b) and the RHS evaluation they read
  T dy[N], w[N], ybn[N];
  Aux<T> a, ab = aux_zero<T>();
  rhs<T, NU, DE>(yn, qb, k, rsa_ktau, nuc, dy, &a);
  for (int i = 0; i < N; ++i) {
    w[i] = T(0);
    ybn[i] = ynb[i];
  }
  sources_vjp<T, NU>(yn, dy, a, qb, k, g, ybn, w, &ab, qbb);
  rhs_vjp<T, NU, DE>(yn, qb, k, rsa_ktau, nuc, w, ab, ybn, qbb);
  const T tau_a = qa[Q_TAU], tau_b = qb[Q_TAU], dt = tau_b - tau_a;
  for (int i = 0; i < N; ++i) yb[i] = T(0);
  if (!(k * tau_b >= T(IC_RELEASE_KTAU) || tau_b >= T(3))) {
    ics_vjp<T, NU, DE>(k, tau_b, rnu, iso, nuc, ybn, &qbb[Q_TAU], rnu_b, isob);
    return;
  }
  // RK4: recompute the stages, then walk them back
  T k1[N], k2[N], k3[N], k4[N], y2[N], y3[N], y4[N];
  const Aux<T> none = aux_zero<T>();
  rhs<T, NU, DE>(y, qa, k, rsa_ktau, nuc, k1, (Aux<T>*)nullptr);
  for (int i = 0; i < N; ++i) y2[i] = y[i] + T(0.5) * dt * k1[i];
  rhs<T, NU, DE>(y2, qm, k, rsa_ktau, nuc, k2, (Aux<T>*)nullptr);
  for (int i = 0; i < N; ++i) y3[i] = y[i] + T(0.5) * dt * k2[i];
  rhs<T, NU, DE>(y3, qm, k, rsa_ktau, nuc, k3, (Aux<T>*)nullptr);
  for (int i = 0; i < N; ++i) y4[i] = y[i] + dt * k3[i];
  rhs<T, NU, DE>(y4, qb, k, rsa_ktau, nuc, k4, (Aux<T>*)nullptr);
  // yn = y + dt/6 (k1 + 2 k2 + 2 k3 + k4)
  T dt_b = T(0), kb[N], sb[N];
  for (int i = 0; i < N; ++i) {
    yb[i] = ybn[i];
    dt_b += ybn[i] * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]) / T(6);
    kb[i] = (dt / T(6)) * ybn[i];  // k4's
  }
  // k4 = f(y4, qb), y4 = y + dt k3
  for (int i = 0; i < N; ++i) sb[i] = T(0);
  rhs_vjp<T, NU, DE>(y4, qb, k, rsa_ktau, nuc, kb, none, sb, qbb);
  for (int i = 0; i < N; ++i) {
    yb[i] += sb[i];
    dt_b += sb[i] * k3[i];
    kb[i] = T(2) * (dt / T(6)) * ybn[i] + dt * sb[i];  // k3's
    sb[i] = T(0);
  }
  // k3 = f(y3, qm), y3 = y + dt/2 k2
  rhs_vjp<T, NU, DE>(y3, qm, k, rsa_ktau, nuc, kb, none, sb, qmb);
  for (int i = 0; i < N; ++i) {
    yb[i] += sb[i];
    dt_b += T(0.5) * sb[i] * k2[i];
    kb[i] = T(2) * (dt / T(6)) * ybn[i] + T(0.5) * dt * sb[i];  // k2's
    sb[i] = T(0);
  }
  // k2 = f(y2, qm), y2 = y + dt/2 k1
  rhs_vjp<T, NU, DE>(y2, qm, k, rsa_ktau, nuc, kb, none, sb, qmb);
  for (int i = 0; i < N; ++i) {
    yb[i] += sb[i];
    dt_b += T(0.5) * sb[i] * k1[i];
    kb[i] = (dt / T(6)) * ybn[i] + T(0.5) * dt * sb[i];  // k1's
  }
  // k1 = f(y, qa)
  rhs_vjp<T, NU, DE>(y, qa, k, rsa_ktau, nuc, kb, none, yb, qab);
  qbb[Q_TAU] += dt_b;
  qab[Q_TAU] -= dt_b;
}

}  // namespace k1adj
