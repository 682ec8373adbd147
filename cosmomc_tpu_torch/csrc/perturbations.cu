// K1: RK4 of the synchronous-gauge Boltzmann hierarchy, with the massive-
// neutrino and dark-energy extensions as template flags.
//
// Replaces cosmomc_tpu/models/perturbations.py:evolve_perturbations (the
// lax.scan at perturbations.py:928 over make_rhs.rhs :375-687 and rk4_step
// :869). Every k-independent input of the RHS (a, opacity, c_s^2, local
// step, species densities, conformal H, pressure, visibility) comes
// precomputed per (chain, step, stage) in `qtab`.
//
// Bound on this card: operations (5 RHS evaluations a step over 8191
// dependent steps for each (chain, k) lane), but what limits a lane is
// the dependency chain of its steps, and with one thread a lane the card
// has 62 warps to hide it with. The design: one warp owns one (chain, k)
// lane; a block is 8 warps of consecutive k of one chain.
// - The eight fluid variables (eta, delta_c, delta_b, theta_b, delta_g,
//   theta_g, delta_nu, theta_nu) are held by every thread of the warp and
//   their derivatives computed by every thread alike. Each of threads
//   0..28 holds one multipole of the three hierarchies: F_g 2..12 on
//   threads 0..10, G 0..8 on 11..19, F_nu 2..10 on 20..28; threads 29..31
//   hold zeros. State, RK4 accumulator, stage state and stage derivative
//   are 4 x 9 values a thread: nothing spills.
// - A multipole's neighbours come by __shfl_up_sync / __shfl_down_sync,
//   and F_g2, G_0, G_2, F_nu2 by broadcast: six shuffles an RHS. Each
//   thread's derivative keeps the plain version's expression for its l:
//   the three forms (generic l, the two l = 2 equations, the three
//   closures) are evaluated with per-thread constants set once (l, l + 1,
//   k/(2l + 1), whether opacity damps it, the polarization source weight)
//   and one is selected, so the warp does not diverge.
// - The TCA/RSA switches and the IC hold depend on (k, step) only, so a
//   warp decides them alike: real branches without divergence. Each switch
//   compares a single product, so FMA contraction cannot flip it against
//   the plain version.
// - The qtab rows of the next tile of steps (32 in float32, 16 in float64)
//   arrive in shared memory by cp.async while the current tile is
//   integrated (double buffer). What the RHS
//   needs of a row but not of k (1/opacity, the tight-coupling threshold,
//   the three closure coefficients, 4/3 grho_nu,massive, the derivative of
//   conformal H, and the reciprocals of 1 + R, of conformal H and of
//   grho_c + grho_b) is computed once a block into the row's spare fields,
//   not once a warp.
// - The last of a step's five RHS evaluations (at the new state and tau_b,
//   for the sources) has the inputs of the next step's first wherever the
//   table's row for tau_a repeats the row for the previous tau_b, which
//   the block checks field for field; there the next step takes the
//   derivative from registers: four evaluations a step, the same bits.
// - No divide is left in the RHS and the sources: where the plain version
//   divides by k, k^2, conformal H, 1 + R or grho_c + grho_b, the loop
//   multiplies by a reciprocal taken once a thread or once a row. An IEEE
//   divide is ~10 dependent instructions on every lane's chain five times
//   a step; the products differ from the quotients in the last bit only
//   (PERF.md has the float32 accuracy of the kernel beside the plain
//   version's).
// - The 7 source values of the block's 8 lanes are collected in shared
//   memory for a tile of steps and written as (plane, chain, step, 8
//   consecutive k): a whole 32-byte sector a store in float32.
// The two static extensions of perturbations.py:make_rhs are template
// flags, so that the base instantiation keeps its instructions and
// registers:
// - NU, the massive-neutrino momentum hierarchy Psi_l(q_i), 4 nodes x
//   l = 0..6: thread 7 i + l (threads 0..27) holds Psi_l(q_i) in a second
//   multipole register. Neighbours in l come by the same up/down shuffles
//   (l = 0 has no left neighbour, l = 6 is the closure); the three momentum
//   sums of Psi_0 eps/q, Psi_1 and Psi_2 q/eps that the fluid equations read
//   take 12 broadcasts, summed alike on every thread; the sources' d/dtau
//   of the massive stress takes the four dPsi_2/dtau by 4 more. The
//   switch nu_rel_rsa = rsa && (am < 2 || k dt_loc > 0.9) depends on (k,
//   row) only and compares single products, like the others. Per row the
//   table carries eps/q and q/eps at each node and (am < 2); a thread
//   takes q/eps of its own node by selects, so no register array is
//   indexed at run time. (q/eps)' = -(q/eps)(am/eps)^2 aH uses (am/eps)^2
//   = 1 - (q/eps)^2.
// - DE, the c_s^2 = 1 dark-energy fluid: two more fluid variables held by
//   every thread like the base eight; frozen under RSA. The row carries w,
//   grho_de and w' times the regularized 1/(1 + w); the block derives the
//   three k-independent coefficients of its equations once a row.
// - CDM isocurvature costs nothing in the loop: each chain's amplitude b
//   (with omega and R_c) enters the held-step ICs only, and a chain with
//   b = 0 takes the adiabatic ICs' instructions alone.
// With both extensions the RK4 state is 4 x 12 values a thread, the row
// 44 fields (33 KB of staged rows a block in float32; 36 fields, 27 KB,
// with massive nu alone).
// models/tensors.py's K5 (csrc/tensors.cu) has the same structure (fluid
// variables replicated, one multipole a thread, staged rows) and can take
// this layout as it stands.
//
// The arithmetic mirrors models/perturbations.py:_rhs/_sources.
//
// With a checkpoint buffer `ck` (the `*_ck` entry points), the kernel also
// stores the state in the plain layout before every `chunk`-th step and
// after the last, (C, nk, ceil(S / chunk) + 1, NVX) with NVX = 37, 65
// (massive nu), 39 (DE) or 67 (both), for the reverse kernel of
// csrc/boltzmann_bwd.cu.
#include "common.cuh"
#include "boltzmann_adjoint.cuh"

namespace {

constexpr int LMAXG = 12, LMAXGP = 8, LMAXNR = 10;
constexpr int NFG = LMAXG - 1, NGP = LMAXGP + 1, NFN = LMAXNR - 1;
// the fluid variables every thread holds; F_DE, F_DV with the DE fluid
enum { F_ETA, F_DC, F_DB, F_TB, F_DG, F_TG, F_DN, F_TN, F_DE, F_DV };
template <bool DE>
constexpr int NF = DE ? 10 : 8;
// first thread of each hierarchy
constexpr int LANE_FG = 0, LANE_GP = NFG, LANE_FN = NFG + NGP;
constexpr int N_MULTIPOLES = NFG + NGP + NFN;
static_assert(N_MULTIPOLES <= 32, "one multipole a thread of the warp");
// the massive-neutrino hierarchy: NQNU nodes x l = 0..LMAXNU, thread NL1 i + l
constexpr int NQNU = 4, LMAXNU = 6, NL1 = LMAXNU + 1;
static_assert(NQNU * NL1 <= 32, "one Psi_l(q_i) a thread of the warp");

// fields of qtab (models/perturbations.py Q_*), then the k-independent
// terms the block derives from them once per (step, stage)
enum { Q_TAU, Q_OPAC, Q_CSQB, Q_DTLOC, Q_GG, Q_GN, Q_GML, Q_GC, Q_GB,
       Q_ADOTOA, Q_GRHO, Q_GPRES, Q_R, Q_VIS, Q_EXPMK, Q_GNISW, NQ };
enum { D_TAUC, D_TCTHR, D_INV_ONEPR, D_CLG, D_CLP, D_CLN, D_WNU, D_DADOTOA,
       D_INV_ADOTOA, D_INV_WSUM, N_DERIVED };

// A row of the stage table with the extensions NU, DE: the raw fields as
// models/perturbations.py:_stage_tables writes them (NQX of them), then
// the derived ones, padded to whole 16-byte vectors (NQD)
template <bool NU, bool DE>
struct Row {
  // NU: eps/q and q/eps at each node, (am < 2)
  static constexpr int Q_EQ = NQ, Q_QE = NQ + NQNU, Q_AMLT2 = NQ + 2 * NQNU;
  // DE: w, grho_de, w' times the regularized 1/(1 + w)
  static constexpr int Q_WDE = NQ + (NU ? 2 * NQNU + 1 : 0);
  static constexpr int Q_GDE = Q_WDE + 1, Q_WPR = Q_WDE + 2;
  static constexpr int NQX = Q_WDE + (DE ? 3 : 0);
  // the base terms (D_*) from NQX on; NU: the Psi closure coefficient;
  // DE: 3 aH (1 - w), 9 aH^2 (1 - w) + 3 aH w'/(1 + w), 2 aH + w'/(1 + w)
  static constexpr int D0 = NQX, D_CLNU = D0 + N_DERIVED;
  static constexpr int D_DE1 = D_CLNU + (NU ? 1 : 0), D_DE2 = D_DE1 + 1,
                       D_DE3 = D_DE1 + 2;
  static constexpr int NQD = (D_DE1 + (DE ? 3 : 0) + 3) / 4 * 4;
};
static_assert(Row<false, false>::NQD == 28, "the base row");
static_assert(Row<true, false>::NQD == 36 && Row<true, true>::NQD == 44,
              "the massive-neutrino rows");
constexpr int NPLANE = 7;
constexpr int WARPS = 8;   // k lanes a block
// tau steps a shared-memory tile: 32 in float32, 16 in float64 (the same
// bytes; the two barriers and the store of a tile cost ~3000 clocks)
template <typename T>
constexpr int TILE_STEPS = sizeof(T) == 4 ? 32 : 16;

constexpr double TC_KTAUC = 0.015, TC_OPACTAU = 200.0;
constexpr double IC_RELEASE_KTAU = 0.08;

enum { KIND_NONE, KIND_GENERIC, KIND_L2, KIND_CLOSURE };

// a thread's multipole: which equation, and its l-only factors
template <typename T>
struct Multipole {
  int kind;
  bool photon, polarization, neutrino, no_prev;
  T l, lp1, coef, polc;
};

template <typename T>
__device__ __forceinline__ Multipole<T> multipole_of(int lane, T k) {
  Multipole<T> m = {KIND_NONE, false, false, false, false, T(0), T(0), T(0), T(0)};
  int j = -1, n = 0, l0 = 0;
  if (lane < LANE_GP) {
    j = lane - LANE_FG, n = NFG, l0 = 2;
    m.photon = true;
  } else if (lane < LANE_FN) {
    j = lane - LANE_GP, n = NGP, l0 = 0;
    m.photon = m.polarization = true;
    m.no_prev = j == 0;
    m.polc = j == 0 ? T(0.5) : (j == 2 ? T(0.1) : T(0));
  } else if (lane < N_MULTIPOLES) {
    j = lane - LANE_FN, n = NFN, l0 = 2;
    m.neutrino = true;
  }
  if (j < 0) return m;
  m.l = T(j + l0);
  m.lp1 = m.l + T(1);
  m.coef = k / (T(2) * m.l + T(1));
  m.kind = j == n - 1 ? KIND_CLOSURE
                      : (j == 0 && l0 == 2 ? KIND_L2 : KIND_GENERIC);
  return m;
}

// a thread's Psi_l(q_i) (NU): its node and l, the l-only factors, and the
// node constants (normalized weights, d ln f0 / d ln q) from `nuc`
template <typename T>
struct NuLane {
  int i, l;
  bool live;
  T lf, lp1, inv2l1, dlnf, wn[NQNU];
};

template <typename T>
__device__ __forceinline__ NuLane<T> nu_lane_of(int lane, const T* __restrict__ nuc) {
  NuLane<T> n;
  n.live = lane < NQNU * NL1;
  n.i = n.live ? lane / NL1 : 0;
  n.l = n.live ? lane % NL1 : -1;
  n.lf = T(n.l);
  n.lp1 = T(n.l + 1);
  n.inv2l1 = T(1) / (T(2) * n.lf + T(1));
#pragma unroll
  for (int j = 0; j < NQNU; ++j) n.wn[j] = nuc[j];
  n.dlnf = nuc[NQNU + n.i];
  return n;
}

// per chain: the CDM-isocurvature amplitude b, omega and R_c
template <typename T>
struct Iso {
  T b, om, rc;
};

template <typename T>
struct Aux {
  T hdot, etadot, dgpi, sigma_g, sigma_n, sigg_dot, sign_dot, pol_term, dgpi_extra;
};

template <int NQD>
__device__ __forceinline__ void load_row(const float* q, float (&r)[NQD]) {
  const float4* v = reinterpret_cast<const float4*>(q);
#pragma unroll
  for (int i = 0; i < NQD / 4; ++i) {
    const float4 x = v[i];
    r[4 * i] = x.x, r[4 * i + 1] = x.y, r[4 * i + 2] = x.z, r[4 * i + 3] = x.w;
  }
}
template <int NQD>
__device__ __forceinline__ void load_row(const double* q, double (&r)[NQD]) {
  const double2* v = reinterpret_cast<const double2*>(q);
#pragma unroll
  for (int i = 0; i < NQD / 2; ++i) {
    const double2 x = v[i];
    r[2 * i] = x.x, r[2 * i + 1] = x.y;
  }
}

// the k-independent terms of one (step, stage) row, in place
template <typename T, bool NU, bool DE>
__device__ __forceinline__ void derive_row(T* q) {
  using R = Row<NU, DE>;
  T* d = q + R::D0;
  const T tau = q[Q_TAU], opac = q[Q_OPAC], Rb = q[Q_R];
  const T tau_safe = xmax(tau, T(1e-10));
  d[D_TAUC] = T(1) / xmax(opac, T(1e-30));
  // tight coupling is off where (k tauc >= TC_KTAUC or opac tau <= 200) and
  // lam dt_loc <= 1.3: as one threshold for the thread's product k tauc
  const T lam = opac * (T(1) + Rb);
  const bool calm = lam * q[Q_DTLOC] <= T(1.3);
  const bool thin = opac * tau <= T(TC_OPACTAU);
  d[D_TCTHR] = !calm ? T(INFINITY) : (thin ? -T(INFINITY) : T(TC_KTAUC));
  d[D_INV_ONEPR] = T(1) / (T(1) + Rb);
  d[D_CLG] = T(LMAXG + 1) / tau_safe;
  d[D_CLP] = T(LMAXGP + 1) / tau_safe;
  d[D_CLN] = T(LMAXNR + 1) / tau_safe;
  d[D_WNU] = (T(4) / T(3)) * q[Q_GML];
  d[D_DADOTOA] = -(q[Q_GRHO] + T(3) * q[Q_GPRES]) / T(6);
  d[D_INV_ADOTOA] = T(1) / q[Q_ADOTOA];
  d[D_INV_WSUM] = T(1) / (q[Q_GC] + q[Q_GB]);
  if constexpr (NU) q[R::D_CLNU] = T(LMAXNU + 1) / tau_safe;
  if constexpr (DE) {
    const T adotoa = q[Q_ADOTOA], omw = T(1) - q[R::Q_WDE], wpr = q[R::Q_WPR];
    q[R::D_DE1] = T(3) * adotoa * omw;
    q[R::D_DE2] = T(9) * (adotoa * adotoa) * omw + T(3) * adotoa * wpr;
    q[R::D_DE3] = T(2) * adotoa + wpr;
  }
}

// a lane's wavenumber and the reciprocals the loop multiplies by
template <typename T>
struct Wavenumber {
  T k, k2, inv_k, inv_k2;
};

// initial conditions: the fluid variables (the adiabatic mode, plus the
// chain's CDM-isocurvature admixture where b != 0), F_nu2 on its thread,
// and with NU Psi_0..2 of each node from the combined moments (MB95 eq 98)
template <typename T, bool NU, bool DE>
__device__ __forceinline__ void ics(T k, T tau, T rnu, const Iso<T>& iso, int lane,
                                    const NuLane<T>& nl, T (&y)[NF<DE>], T& ym,
                                    T& yn) {
  const T kt = k * tau;
  T dg = -(T(2) / T(3)) * (kt * kt);
  T theta = -(T(1) / T(18)) * k * (kt * kt * kt);
  T dc = T(0.75) * dg, db = T(0.75) * dg, dn = dg, tb = theta;
  T tn = theta * (T(23) + T(4) * rnu) / (T(15) + T(4) * rnu);
  T eta = T(2) - (T(5) + T(4) * rnu) / (T(6) * (T(15) + T(4) * rnu)) * (kt * kt);
  T fn2 = T(2) * (T(2) * (kt * kt) / (T(3) * (T(15) + T(4) * rnu)));
  if (iso.b != T(0)) {
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
  }
  y[F_DG] = dg;
  y[F_DC] = dc;
  y[F_DB] = db;
  y[F_DN] = dn;
  y[F_TG] = theta;
  y[F_TB] = tb;
  y[F_TN] = tn;
  y[F_ETA] = eta;
  ym = lane == LANE_FN ? fn2 : T(0);
  if constexpr (DE) y[F_DE] = y[F_DV] = T(0);
  if constexpr (NU) {
    const T m = nl.l == 0 ? T(0.25) * dn
                          : (nl.l == 1 ? tn / (T(3) * k) : (nl.l == 2 ? T(0.25) * fn2 : T(0)));
    yn = -m * nl.dlnf;
  }
}

// q/eps of the thread's node, by selects (no run-time index into q)
template <typename T, bool NU, bool DE, int NQD>
__device__ __forceinline__ T own_qe(const T (&q)[NQD], int i) {
  using R = Row<NU, DE>;
  T v = q[R::Q_QE];
#pragma unroll
  for (int j = 1; j < NQNU; ++j) v = i == j ? q[R::Q_QE + j] : v;
  return v;
}

// One RHS evaluation: the fluid derivatives (every thread alike), the
// derivative of the thread's multipole and, with NU, of its Psi_l(q_i).
// Called by all 32 threads of a warp together. SRC: also the terms only
// the sources need.
template <typename T, bool NU, bool DE, bool SRC, int NQD>
__device__ __forceinline__ void rhs(const T (&y)[NF<DE>], T ym, T yn, const T (&q)[NQD],
                                    const Wavenumber<T>& kn, T rsa_ktau,
                                    const Multipole<T>& mp, const NuLane<T>& nl,
                                    T (&dy)[NF<DE>], T& dym, T& dyn, Aux<T>& aux) {
  using R = Row<NU, DE>;
  const T* d = q + R::D0;
  const T k = kn.k, k2 = kn.k2, inv_k = kn.inv_k;
  const T inv_adotoa = d[D_INV_ADOTOA];
  const T tau = q[Q_TAU], opac = q[Q_OPAC], csqb = q[Q_CSQB];
  const T grho_g = q[Q_GG], grho_n = q[Q_GN], gml = q[Q_GML];
  const T grho_c = q[Q_GC], grho_b = q[Q_GB], adotoa = q[Q_ADOTOA], Rb = q[Q_R];
  const T eta = y[F_ETA], dc = y[F_DC], db = y[F_DB], tb = y[F_TB];
  T dg = y[F_DG], tg = y[F_TG], dn = y[F_DN], tn = y[F_TN];

  const T tauc = d[D_TAUC];
  const bool rsa = k * tau >= rsa_ktau;
  const bool tc_off = k * tauc >= d[D_TCTHR];
  const bool tc_on = !tc_off && !rsa;

  // the multipoles the fluid equations read, and this thread's neighbours
  const T fg0 = __shfl_sync(FULL_WARP, ym, LANE_FG);
  const T gp0 = __shfl_sync(FULL_WARP, ym, LANE_GP);
  const T gp2 = __shfl_sync(FULL_WARP, ym, LANE_GP + 2);
  const T fn0 = __shfl_sync(FULL_WARP, ym, LANE_FN);
  const T up = __shfl_up_sync(FULL_WARP, ym, 1);
  const T next = __shfl_down_sync(FULL_WARP, ym, 1);
  const T prev = mp.no_prev ? T(0) : up;

  // NU: the momentum sums over the nodes (MB95 eq 55), alike on every thread
  bool nu_rel = false;
  T nsum0 = T(0), nsum1 = T(0), nsum2 = T(0), psi2[NQNU];
  if constexpr (NU) {
    nu_rel = rsa && (q[R::Q_AMLT2] != T(0) || k * q[Q_DTLOC] > T(0.9));
#pragma unroll
    for (int i = 0; i < NQNU; ++i) {
      const T p0 = __shfl_sync(FULL_WARP, yn, NL1 * i);
      const T p1 = __shfl_sync(FULL_WARP, yn, NL1 * i + 1);
      psi2[i] = __shfl_sync(FULL_WARP, yn, NL1 * i + 2);
      nsum0 = nsum0 + nl.wn[i] * q[R::Q_EQ + i] * p0;
      nsum1 = nsum1 + nl.wn[i] * p1;
      nsum2 = nsum2 + nl.wn[i] * q[R::Q_QE + i] * psi2[i];
    }
  }

  if (rsa) {
    const T dgrho_m = grho_c * dc + grho_b * db;
    const T z_rsa = (T(0.5) * dgrho_m * inv_k + k * eta) * inv_adotoa;
    const T dz_rsa = -adotoa * z_rsa - T(0.5) * dgrho_m * inv_k;
    const T dn_rsa = -T(4) * dz_rsa * inv_k;
    const T tn_rsa = -k * z_rsa;
    dg = dn_rsa - (T(4) * inv_k) * opac * (tb * inv_k + z_rsa);
    tg = tn_rsa;
    dn = dn_rsa;
    tn = tn_rsa;
  }

  const T wnu_m = d[D_WNU];
  const T sigma_n = rsa ? T(0) : fn0 / T(2);
  T dgrho, dgq, dgpi_m;
  if constexpr (NU) {
    // under nu_rel_rsa (so under rsa) dn and tn hold the slaved values
    dgrho = grho_c * dc + grho_b * db + grho_g * dg + grho_n * dn +
            (nu_rel ? gml * dn : gml * nsum0);
    dgq = (T(4) / T(3)) * (grho_g * tg + grho_n * tn) + grho_b * tb +
          (nu_rel ? (T(4) / T(3)) * gml * tn : gml * k * nsum1);
    dgpi_m = nu_rel ? T(0) : (T(2) / T(3)) * gml * nsum2;
  } else {
    dgrho = grho_c * dc + grho_b * db + grho_g * dg + grho_n * dn + gml * dn;
    dgq = (T(4) / T(3)) * (grho_g * tg + grho_n * tn) + grho_b * tb + wnu_m * tn;
    dgpi_m = wnu_m * sigma_n;
  }
  if constexpr (DE) {
    const T gde = q[R::Q_GDE];
    dgrho = dgrho + (rsa ? T(0) : gde * y[F_DE]);
    dgq = dgq + (rsa ? T(0) : gde * y[F_DV]);
  }
  const T hdot = (T(2) * k2 * eta + dgrho) * inv_adotoa;
  const T etadot = T(0.5) * dgq * kn.inv_k2;

  const T fg2_tca = (T(4) / T(3)) * tauc *
                    ((T(8) / T(15)) * tg + (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot);
  const T fg2_eff = rsa ? T(0) : (tc_on ? fg2_tca : fg0);
  const T sigma_g = fg2_eff / T(2);
  const T pol_term = rsa ? T(0) : (tc_on ? T(2.5) * fg2_tca : fg0 + gp0 + gp2);

  const T sl = dg / T(4) - sigma_g;
  T tbdot, tgdot;
  if (rsa) {
    tbdot = -adotoa * tb + csqb * k2 * db;
    tgdot = T(0);
  } else if (tc_on) {
    tbdot = (-adotoa * tb + csqb * k2 * db + Rb * k2 * sl) * d[D_INV_ONEPR];
    tgdot = tbdot;
  } else {
    tbdot = -adotoa * tb + csqb * k2 * db + Rb * opac * (tg - tb);
    tgdot = k2 * sl + opac * (tb - tg);
  }
  dy[F_ETA] = etadot;
  dy[F_DC] = -T(0.5) * hdot;
  dy[F_DB] = -tb - T(0.5) * hdot;
  dy[F_TB] = tbdot;
  dy[F_DG] = rsa ? T(0) : -(T(4) / T(3)) * tg - (T(2) / T(3)) * hdot;
  dy[F_TG] = tgdot;
  dy[F_DN] = rsa ? T(0) : -(T(4) / T(3)) * tn - (T(2) / T(3)) * hdot;
  dy[F_TN] = rsa ? T(0) : k2 * (dn / T(4) - sigma_n);
  if constexpr (DE) {
    // V = (1 + w) theta form; frozen under RSA
    const T de = y[F_DE], dv = y[F_DV];
    const T ddot = -dv - (T(1) + q[R::Q_WDE]) * T(0.5) * hdot - q[R::D_DE1] * de -
                   q[R::D_DE2] * dv * kn.inv_k2;
    const T vdot = q[R::D_DE3] * dv + k2 * de;
    dy[F_DE] = rsa ? T(0) : ddot;
    dy[F_DV] = rsa ? T(0) : vdot;
  }

  // this thread's multipole: generic l, an l = 2 equation, or a closure
  const T damp = mp.photon ? opac : T(0);
  const T generic = mp.coef * (mp.l * prev - mp.lp1 * next) - damp * ym +
                    opac * mp.polc * pol_term;
  const T l2 = (T(8) / T(15)) * (mp.neutrino ? tn : tg) - (T(3) / T(5)) * k * next +
               (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot -
               damp * (T(0.9) * ym - T(0.1) * (gp0 + gp2));
  const T clc = mp.neutrino ? d[D_CLN] : (mp.polarization ? d[D_CLP] : d[D_CLG]);
  const T closure = k * prev - clc * ym - damp * ym;
  const bool zeroed = mp.kind == KIND_NONE || rsa || (mp.photon && tc_on);
  const T v = mp.kind == KIND_L2 ? l2 : (mp.kind == KIND_CLOSURE ? closure : generic);
  dym = zeroed ? T(0) : v;

  // NU: this thread's Psi_l(q_i) (MB95 eqs 57, 58), frozen under nu_rel_rsa
  if constexpr (NU) {
    const T upn = __shfl_up_sync(FULL_WARP, yn, 1);
    const T nextn = __shfl_down_sync(FULL_WARP, yn, 1);
    const T prevn = nl.l == 0 ? T(0) : upn;
    const T qke = own_qe<T, NU, DE>(q, nl.i) * k;
    const T gen = (qke * nl.inv2l1) * (nl.lf * prevn - nl.lp1 * nextn);
    const T src = nl.l == 0 ? (hdot / T(6)) * nl.dlnf
                            : (nl.l == 2 ? -(hdot / T(15) + T(2) * etadot / T(5)) * nl.dlnf
                                         : T(0));
    const T clo = qke * prevn - q[R::D_CLNU] * yn;
    dyn = (!nl.live || nu_rel) ? T(0) : (nl.l == LMAXNU ? clo : gen + src);
  }

  if (SRC) {
    const T fg2dot = __shfl_sync(FULL_WARP, l2, LANE_FG);
    const T fn2dot = __shfl_sync(FULL_WARP, l2, LANE_FN);
    aux.hdot = hdot;
    aux.etadot = etadot;
    aux.dgpi = (T(4) / T(3)) * (grho_g * sigma_g + grho_n * sigma_n) + dgpi_m;
    aux.sigma_g = sigma_g;
    aux.sigma_n = sigma_n;
    aux.sigg_dot = ((tc_on || rsa) ? T(0) : fg2dot) / T(2);
    aux.sign_dot = (rsa ? T(0) : fn2dot) / T(2);
    aux.pol_term = pol_term;
    if constexpr (NU) {
      // d/dtau of the massive stress sum: d[gml (q/eps) Psi_2] with gml' =
      // -2 aH gml and (q/eps)' = -(q/eps)(1 - (q/eps)^2) aH
      T e = T(0);
#pragma unroll
      for (int i = 0; i < NQNU; ++i) {
        const T d2 = __shfl_sync(FULL_WARP, dyn, NL1 * i + 2);
        const T qe = q[R::Q_QE + i];
        e = e + nl.wn[i] * (qe * d2 - (qe * (T(3) - qe * qe) * adotoa) * psi2[i]);
      }
      aux.dgpi_extra = nu_rel ? T(0) : (T(2) / T(3)) * gml * e;
    }
  }
}

template <typename T, bool NU, bool DE, int NQD>
__device__ __forceinline__ void sources(const T (&y)[NF<DE>], const T (&dy)[NF<DE>],
                                        const Aux<T>& aux, const T (&q)[NQD],
                                        const Wavenumber<T>& kn, T (&s)[NPLANE]) {
  const T* d = q + Row<NU, DE>::D0;
  const T k2 = kn.k2, inv_k2 = kn.inv_k2;
  const T adotoa = q[Q_ADOTOA], grho_g = q[Q_GG], grho_n = q[Q_GNISW];
  const T vis = q[Q_VIS], expmk = q[Q_EXPMK];
  const T alpha = (aux.hdot + T(6) * aux.etadot) * (T(0.5) * inv_k2);
  const T X = T(1.5) * aux.dgpi * inv_k2;
  const T eta = y[F_ETA];
  const T phi = eta - adotoa * alpha;
  const T psi = phi - X;
  const T dadotoa = d[D_DADOTOA];
  const T alphadot = eta - X - T(2) * adotoa * alpha;
  const T phidot = aux.etadot - dadotoa * alpha - adotoa * alphadot;
  T dgpidot = (T(4) / T(3)) *
              (-T(2) * adotoa * (grho_g * aux.sigma_g + grho_n * aux.sigma_n) +
               grho_g * aux.sigg_dot + grho_n * aux.sign_dot);
  if constexpr (NU) dgpidot = dgpidot + aux.dgpi_extra;
  const T psidot = phidot - T(1.5) * dgpidot * inv_k2;
  const T theta0_N = y[F_DG] / T(4) - adotoa * alpha;
  const T vb_N = (y[F_TB] + k2 * alpha) * kn.inv_k;
  const T Pi = aux.pol_term / T(4);
  s[0] = vis * (theta0_N + psi + Pi / T(4)) + expmk * (phidot + psidot);
  s[1] = vis * vb_N;
  s[2] = T(0.75) * vis * Pi;
  s[3] = expmk * (phi + psi);
  const T gc = q[Q_GC], gb = q[Q_GB];
  s[4] = (gc * y[F_DC] + gb * y[F_DB]) * d[D_INV_WSUM];
  s[5] = (gc * dy[F_DC] + gb * dy[F_DB]) * d[D_INV_WSUM];
  s[6] = T(0.5) * (phi + psi);
}

// the raw rows of steps [t TS, (t + 1) TS) into one buffer, spread over the block
template <typename T, bool NU, bool DE>
__device__ __forceinline__ void stage_rows(T* buf, const T* Qc, int S, int t) {
  using R = Row<NU, DE>;
  const int s0 = t * TILE_STEPS<T>, n = min(TILE_STEPS<T>, S - s0) * 3 * R::NQX;
  const T* src = Qc + (size_t)s0 * 3 * R::NQX;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    cp_async(buf + (e / R::NQX) * R::NQD + e % R::NQX, src + e);
  cp_async_commit();
}

// The derived fields of a tile's rows, and for each of its steps whether
// its first row equals the last row of the step before (`prev_last`: that
// row of the previous tile, or null) field for field. Then the step's first
// RHS evaluation has the inputs of the previous step's last one, which
// evaluated the new state at tau_b for the sources, and is not repeated.
// models/perturbations.py:_stage_tables makes such rows: tau_a of a step is
// tau_b of the step before, and each field is a function of tau alone.
template <typename T, bool NU, bool DE>
__device__ __forceinline__ void derive_rows(T* buf, int S, int t, const T* prev_last,
                                            bool* same) {
  using R = Row<NU, DE>;
  const int ns = min(TILE_STEPS<T>, S - t * TILE_STEPS<T>);
  for (int e = threadIdx.x; e < ns * 3; e += blockDim.x)
    derive_row<T, NU, DE>(buf + e * R::NQD);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const T* a = buf + s * 3 * R::NQD;
    const T* p = s > 0 ? a - R::NQD : prev_last;
    bool eq = p != nullptr;
    if (eq) {
#pragma unroll
      for (int f = 0; f < R::NQX; ++f) eq = eq && a[f] == p[f];
    }
    same[s] = eq;
  }
}

template <typename T, bool NU, bool DE>
__global__ void __launch_bounds__(WARPS * 32, 2)
boltzmann_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
                 const T* __restrict__ rnu_in, const T* __restrict__ iso_in,
                 const T* __restrict__ nuc, T* __restrict__ out, int C, int S,
                 int nk, T rsa_ktau, T* __restrict__ ck, int chunk) {
  using R = Row<NU, DE>;
  constexpr int TS = TILE_STEPS<T>, NQD = R::NQD, NFV = NF<DE>;
  __shared__ __align__(16) T rows[2][TS * 3 * NQD];
  __shared__ T staged[TS][NPLANE][WARPS];
  __shared__ bool same[2][TS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.y, k0 = blockIdx.x * WARPS;
  // a warp past the last k repeats it, so that it keeps the block's barriers
  const T k = kvec[min(k0 + w, nk - 1)];
  const Wavenumber<T> kn = {k, k * k, T(1) / k, T(1) / (k * k)};
  const T rnu = rnu_in[c];
  const Iso<T> iso = {iso_in[3 * c], iso_in[3 * c + 1], iso_in[3 * c + 2]};
  const T* Qc = qtab + (size_t)c * S * 3 * R::NQX;
  const Multipole<T> mp = multipole_of(lane, k);
  NuLane<T> nl{};
  if constexpr (NU) nl = nu_lane_of(lane, nuc);
  const int ntiles = (S + TS - 1) / TS;

  stage_rows<T, NU, DE>(rows[0], Qc, S, 0);
  cp_async_wait<0>();
  __syncthreads();
  derive_rows<T, NU, DE>(rows[0], S, 0, (const T*)nullptr, same[0]);
  __syncthreads();

  T y[NFV], acc[NFV], yt[NFV], kd[NFV];
  T ym, accm, ytm, kdm;
  T yn = T(0), accn = T(0), ytn = T(0), kdn = T(0);
  Aux<T> aux;
  ics<T, NU, DE>(k, rows[0][Q_TAU], rnu, iso, lane, nl, y, ym, yn);
  // the checkpoints in the plain layout (k1adj::Layout): lane 0 the fluid
  // variables, lane j < 29 its multipole, with NU lane j < 28 its Psi_l(q_i)
  using LX = k1adj::Layout<NU, DE>;
  const int nck = ck == nullptr ? 0 : (S + chunk - 1) / chunk;
  T* ckl = ck == nullptr || k0 + w >= nk ? nullptr
                                         : ck + ((size_t)c * nk + k0 + w) * (nck + 1) * LX::NVX;
  const int mslot = lane < 20 ? 6 + lane : 8 + lane;
  auto store = [&](int m) {
    if (ckl == nullptr) return;
    T* d = ckl + (size_t)m * LX::NVX;
    if (lane == 0) {
      d[0] = y[F_ETA], d[1] = y[F_DC], d[2] = y[F_DB], d[3] = y[F_TB];
      d[4] = y[F_DG], d[5] = y[F_TG], d[26] = y[F_DN], d[27] = y[F_TN];
      if constexpr (DE) d[LX::I_DE] = y[F_DE], d[LX::I_DE + 1] = y[F_DV];
    }
    if (lane < N_MULTIPOLES) d[mslot] = ym;
    if constexpr (NU) {
      if (lane < NQNU * NL1) d[LX::I_NU + lane] = yn;
    }
  };
  for (int t = 0; t < ntiles; ++t) {
    const T* buf = rows[t & 1];
    if (t + 1 < ntiles) stage_rows<T, NU, DE>(rows[(t + 1) & 1], Qc, S, t + 1);
    const int ns = min(TS, S - t * TS);
    for (int s = 0; s < ns; ++s) {
      if (nck > 0 && (t * TS + s) % chunk == 0) store((t * TS + s) / chunk);
      T q[NQD];
      load_row(buf + (s * 3 + 0) * NQD, q);
      const T tau_a = q[Q_TAU];
      // unless kd, kdm, kdn already hold this evaluation (the step before's last)
      if (!same[t & 1][s])
        rhs<T, NU, DE, false>(y, ym, yn, q, kn, rsa_ktau, mp, nl, kd, kdm, kdn, aux);
      const T tau_b = buf[(s * 3 + 2) * NQD + Q_TAU];
      const T dt = tau_b - tau_a;
      load_row(buf + (s * 3 + 1) * NQD, q);
#pragma unroll
      for (int j = 0; j < NFV; ++j) {
        acc[j] = kd[j];
        yt[j] = y[j] + T(0.5) * dt * kd[j];
      }
      accm = kdm;
      ytm = ym + T(0.5) * dt * kdm;
      if constexpr (NU) {
        accn = kdn;
        ytn = yn + T(0.5) * dt * kdn;
      }
      rhs<T, NU, DE, false>(yt, ytm, ytn, q, kn, rsa_ktau, mp, nl, kd, kdm, kdn, aux);
#pragma unroll
      for (int j = 0; j < NFV; ++j) {
        acc[j] = acc[j] + T(2) * kd[j];
        yt[j] = y[j] + T(0.5) * dt * kd[j];
      }
      accm = accm + T(2) * kdm;
      ytm = ym + T(0.5) * dt * kdm;
      if constexpr (NU) {
        accn = accn + T(2) * kdn;
        ytn = yn + T(0.5) * dt * kdn;
      }
      rhs<T, NU, DE, false>(yt, ytm, ytn, q, kn, rsa_ktau, mp, nl, kd, kdm, kdn, aux);
#pragma unroll
      for (int j = 0; j < NFV; ++j) {
        acc[j] = acc[j] + T(2) * kd[j];
        yt[j] = y[j] + dt * kd[j];
      }
      accm = accm + T(2) * kdm;
      ytm = ym + dt * kdm;
      if constexpr (NU) {
        accn = accn + T(2) * kdn;
        ytn = yn + dt * kdn;
      }
      load_row(buf + (s * 3 + 2) * NQD, q);
      rhs<T, NU, DE, false>(yt, ytm, ytn, q, kn, rsa_ktau, mp, nl, kd, kdm, kdn, aux);
      if (k * tau_b >= T(IC_RELEASE_KTAU) || tau_b >= T(3)) {
#pragma unroll
        for (int j = 0; j < NFV; ++j) y[j] = y[j] + (dt / T(6)) * (acc[j] + kd[j]);
        ym = ym + (dt / T(6)) * (accm + kdm);
        if constexpr (NU) yn = yn + (dt / T(6)) * (accn + kdn);
      } else {
        ics<T, NU, DE>(k, tau_b, rnu, iso, lane, nl, y, ym, yn);
      }
      rhs<T, NU, DE, true>(y, ym, yn, q, kn, rsa_ktau, mp, nl, kd, kdm, kdn, aux);
      T src[NPLANE];
      sources<T, NU, DE>(y, kd, aux, q, kn, src);
      if (lane == 0) {
#pragma unroll
        for (int p = 0; p < NPLANE; ++p) staged[s][p][w] = src[p];
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the next rows have landed; this tile's sources are staged
    for (int e = threadIdx.x; e < ns * NPLANE * WARPS; e += blockDim.x) {
      const int kw = e % WARPS, p = (e / WARPS) % NPLANE, s = e / (WARPS * NPLANE);
      if (k0 + kw < nk)
        out[(((size_t)p * C + c) * S + (t * TS + s)) * nk + k0 + kw] = staged[s][p][kw];
    }
    if (t + 1 < ntiles)
      derive_rows<T, NU, DE>(rows[(t + 1) & 1], S, t + 1,
                             buf + ((TS - 1) * 3 + 2) * NQD, same[(t + 1) & 1]);
    __syncthreads();   // the derived fields are written; `staged` is free
  }
  if (nck > 0) store(nck);
}

template <typename T, bool NU, bool DE>
int launch(const void* qtab, const void* kvec, const void* rnu, const void* iso,
           const void* nuc, void* out, int C, int S, int nk, double rsa_ktau,
           void* ck, int chunk, void* stream) {
  dim3 grid((nk + WARPS - 1) / WARPS, C);
  boltzmann_kernel<T, NU, DE><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)qtab, (const T*)kvec, (const T*)rnu, (const T*)iso, (const T*)nuc,
      (T*)out, C, S, nk, (T)rsa_ktau, (T*)ck, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// one entry point per (extension, dtype): qtab (C, S, 3, NQX) with the
// variant's row, kvec (nk,), rnu (C,), iso (C, 3), nuc (2, 4): the node
// weights and d ln f0 / d ln q; out (7, C, S, nk)
#define BOLTZMANN_ENTRY(NAME, T, NU, DE)                                                \
  extern "C" int NAME(const void* qtab, const void* kvec, const void* rnu,             \
                      const void* iso, const void* nuc, void* out, int C, int S,       \
                      int nk, double rsa_ktau, void* stream) {                         \
    return launch<T, NU, DE>(qtab, kvec, rnu, iso, nuc, out, C, S, nk, rsa_ktau,       \
                             nullptr, 0, stream);                                       \
  }
BOLTZMANN_ENTRY(boltzmann_f32, float, false, false)
BOLTZMANN_ENTRY(boltzmann_f64, double, false, false)
BOLTZMANN_ENTRY(boltzmann_nu_f32, float, true, false)
BOLTZMANN_ENTRY(boltzmann_nu_f64, double, true, false)
BOLTZMANN_ENTRY(boltzmann_de_f32, float, false, true)
BOLTZMANN_ENTRY(boltzmann_de_f64, double, false, true)
BOLTZMANN_ENTRY(boltzmann_nu_de_f32, float, true, true)
BOLTZMANN_ENTRY(boltzmann_nu_de_f64, double, true, true)

// the forward kernel with checkpoints, one entry point per (extension,
// dtype): ck (C, nk, ceil(S / chunk) + 1, NVX), the state in the plain layout
// (37, 65, 39 or 67 variables)
#define BOLTZMANN_CK_ENTRY(NAME, T, NU, DE)                                              \
  extern "C" int NAME(const void* qtab, const void* kvec, const void* rnu,             \
                      const void* iso, const void* nuc, void* out, void* ck, int C,    \
                      int S, int nk, double rsa_ktau, int chunk, void* stream) {       \
    return launch<T, NU, DE>(qtab, kvec, rnu, iso, nuc, out, C, S, nk, rsa_ktau, ck,   \
                             chunk, stream);                                            \
  }
BOLTZMANN_CK_ENTRY(boltzmann_ck_f32, float, false, false)
BOLTZMANN_CK_ENTRY(boltzmann_ck_f64, double, false, false)
BOLTZMANN_CK_ENTRY(boltzmann_nu_ck_f32, float, true, false)
BOLTZMANN_CK_ENTRY(boltzmann_nu_ck_f64, double, true, false)
BOLTZMANN_CK_ENTRY(boltzmann_de_ck_f32, float, false, true)
BOLTZMANN_CK_ENTRY(boltzmann_de_ck_f64, double, false, true)
BOLTZMANN_CK_ENTRY(boltzmann_nu_de_ck_f32, float, true, true)
BOLTZMANN_CK_ENTRY(boltzmann_nu_de_ck_f64, double, true, true)
