// K1: RK4 of the synchronous-gauge Boltzmann hierarchy, base LCDM layout.
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
// models/tensors.py's K5 (csrc/tensors.cu) has the same structure (fluid
// variables replicated, one multipole a thread, staged rows) and can take
// this layout as it stands.
//
// The arithmetic mirrors models/perturbations.py:_rhs/_sources.
#include "common.cuh"

namespace {

constexpr int LMAXG = 12, LMAXGP = 8, LMAXNR = 10;
constexpr int NFG = LMAXG - 1, NGP = LMAXGP + 1, NFN = LMAXNR - 1;
// the fluid variables every thread holds
enum { F_ETA, F_DC, F_DB, F_TB, F_DG, F_TG, F_DN, F_TN, NF };
// first thread of each hierarchy
constexpr int LANE_FG = 0, LANE_GP = NFG, LANE_FN = NFG + NGP;
constexpr int N_MULTIPOLES = NFG + NGP + NFN;
static_assert(N_MULTIPOLES <= 32, "one multipole a thread of the warp");

// fields of qtab (models/perturbations.py Q_*), then the k-independent
// terms the block derives from them once per (step, stage)
enum { Q_TAU, Q_OPAC, Q_CSQB, Q_DTLOC, Q_GG, Q_GN, Q_GML, Q_GC, Q_GB,
       Q_ADOTOA, Q_GRHO, Q_GPRES, Q_R, Q_VIS, Q_EXPMK, Q_GNISW, NQ,
       D_TAUC = NQ, D_TCTHR, D_INV_ONEPR, D_CLG, D_CLP, D_CLN, D_WNU, D_DADOTOA,
       D_INV_ADOTOA, D_INV_WSUM, NQD = 28 };
static_assert(D_INV_WSUM < NQD, "the derived fields fit the padded row");
static_assert(NQD % 4 == 0, "rows are read as 16-byte vectors");
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

template <typename T>
struct Aux {
  T hdot, etadot, dgpi, sigma_g, sigma_n, sigg_dot, sign_dot, pol_term;
};

__device__ __forceinline__ void load_row(const float* q, float (&r)[NQD]) {
  const float4* v = reinterpret_cast<const float4*>(q);
#pragma unroll
  for (int i = 0; i < NQD / 4; ++i) {
    const float4 x = v[i];
    r[4 * i] = x.x, r[4 * i + 1] = x.y, r[4 * i + 2] = x.z, r[4 * i + 3] = x.w;
  }
}
__device__ __forceinline__ void load_row(const double* q, double (&r)[NQD]) {
  const double2* v = reinterpret_cast<const double2*>(q);
#pragma unroll
  for (int i = 0; i < NQD / 2; ++i) {
    const double2 x = v[i];
    r[2 * i] = x.x, r[2 * i + 1] = x.y;
  }
}

// the k-independent terms of one (step, stage) row, in place
template <typename T>
__device__ __forceinline__ void derive_row(T* q) {
  const T tau = q[Q_TAU], opac = q[Q_OPAC], R = q[Q_R];
  const T tau_safe = xmax(tau, T(1e-10));
  q[D_TAUC] = T(1) / xmax(opac, T(1e-30));
  // tight coupling is off where (k tauc >= TC_KTAUC or opac tau <= 200) and
  // lam dt_loc <= 1.3: as one threshold for the thread's product k tauc
  const T lam = opac * (T(1) + R);
  const bool calm = lam * q[Q_DTLOC] <= T(1.3);
  const bool thin = opac * tau <= T(TC_OPACTAU);
  q[D_TCTHR] = !calm ? T(INFINITY) : (thin ? -T(INFINITY) : T(TC_KTAUC));
  q[D_INV_ONEPR] = T(1) / (T(1) + R);
  q[D_CLG] = T(LMAXG + 1) / tau_safe;
  q[D_CLP] = T(LMAXGP + 1) / tau_safe;
  q[D_CLN] = T(LMAXNR + 1) / tau_safe;
  q[D_WNU] = (T(4) / T(3)) * q[Q_GML];
  q[D_DADOTOA] = -(q[Q_GRHO] + T(3) * q[Q_GPRES]) / T(6);
  q[D_INV_ADOTOA] = T(1) / q[Q_ADOTOA];
  q[D_INV_WSUM] = T(1) / (q[Q_GC] + q[Q_GB]);
}

// a lane's wavenumber and the reciprocals the loop multiplies by
template <typename T>
struct Wavenumber {
  T k, k2, inv_k, inv_k2;
};

// adiabatic initial conditions: the fluid variables, and F_nu2 on its thread
template <typename T>
__device__ __forceinline__ void ics(T k, T tau, T rnu, int lane, T (&y)[NF], T& ym) {
  const T kt = k * tau;
  const T dg = -(T(2) / T(3)) * (kt * kt);
  const T theta = -(T(1) / T(18)) * k * (kt * kt * kt);
  y[F_DG] = dg;
  y[F_DC] = T(0.75) * dg;
  y[F_DB] = T(0.75) * dg;
  y[F_DN] = dg;
  y[F_TG] = theta;
  y[F_TB] = theta;
  y[F_TN] = theta * (T(23) + T(4) * rnu) / (T(15) + T(4) * rnu);
  y[F_ETA] = T(2) - (T(5) + T(4) * rnu) / (T(6) * (T(15) + T(4) * rnu)) * (kt * kt);
  const T fn2 = T(2) * (T(2) * (kt * kt) / (T(3) * (T(15) + T(4) * rnu)));
  ym = lane == LANE_FN ? fn2 : T(0);
}

// One RHS evaluation: the fluid derivatives (every thread alike) and the
// derivative of the thread's multipole. Called by all 32 threads of a warp
// together. SRC: also the terms only the sources need.
template <typename T, bool SRC>
__device__ __forceinline__ void rhs(const T (&y)[NF], T ym, const T (&q)[NQD],
                                    const Wavenumber<T>& kn, T rsa_ktau,
                                    const Multipole<T>& mp, T (&dy)[NF], T& dym,
                                    Aux<T>& aux) {
  const T k = kn.k, k2 = kn.k2, inv_k = kn.inv_k;
  const T inv_adotoa = q[D_INV_ADOTOA];
  const T tau = q[Q_TAU], opac = q[Q_OPAC], csqb = q[Q_CSQB];
  const T grho_g = q[Q_GG], grho_n = q[Q_GN], gml = q[Q_GML];
  const T grho_c = q[Q_GC], grho_b = q[Q_GB], adotoa = q[Q_ADOTOA], R = q[Q_R];
  const T eta = y[F_ETA], dc = y[F_DC], db = y[F_DB], tb = y[F_TB];
  T dg = y[F_DG], tg = y[F_TG], dn = y[F_DN], tn = y[F_TN];

  const T tauc = q[D_TAUC];
  const bool rsa = k * tau >= rsa_ktau;
  const bool tc_off = k * tauc >= q[D_TCTHR];
  const bool tc_on = !tc_off && !rsa;

  // the multipoles the fluid equations read, and this thread's neighbours
  const T fg0 = __shfl_sync(FULL_WARP, ym, LANE_FG);
  const T gp0 = __shfl_sync(FULL_WARP, ym, LANE_GP);
  const T gp2 = __shfl_sync(FULL_WARP, ym, LANE_GP + 2);
  const T fn0 = __shfl_sync(FULL_WARP, ym, LANE_FN);
  const T up = __shfl_up_sync(FULL_WARP, ym, 1);
  const T next = __shfl_down_sync(FULL_WARP, ym, 1);
  const T prev = mp.no_prev ? T(0) : up;

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

  const T wnu_m = q[D_WNU];
  const T sigma_n = rsa ? T(0) : fn0 / T(2);
  const T dgrho = grho_c * dc + grho_b * db + grho_g * dg + grho_n * dn + gml * dn;
  const T hdot = (T(2) * k2 * eta + dgrho) * inv_adotoa;
  const T dgq = (T(4) / T(3)) * (grho_g * tg + grho_n * tn) + grho_b * tb + wnu_m * tn;
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
    tbdot = (-adotoa * tb + csqb * k2 * db + R * k2 * sl) * q[D_INV_ONEPR];
    tgdot = tbdot;
  } else {
    tbdot = -adotoa * tb + csqb * k2 * db + R * opac * (tg - tb);
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

  // this thread's multipole: generic l, an l = 2 equation, or a closure
  const T damp = mp.photon ? opac : T(0);
  const T generic = mp.coef * (mp.l * prev - mp.lp1 * next) - damp * ym +
                    opac * mp.polc * pol_term;
  const T l2 = (T(8) / T(15)) * (mp.neutrino ? tn : tg) - (T(3) / T(5)) * k * next +
               (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot -
               damp * (T(0.9) * ym - T(0.1) * (gp0 + gp2));
  const T clc = mp.neutrino ? q[D_CLN] : (mp.polarization ? q[D_CLP] : q[D_CLG]);
  const T closure = k * prev - clc * ym - damp * ym;
  const bool zeroed = mp.kind == KIND_NONE || rsa || (mp.photon && tc_on);
  const T v = mp.kind == KIND_L2 ? l2 : (mp.kind == KIND_CLOSURE ? closure : generic);
  dym = zeroed ? T(0) : v;

  if (SRC) {
    const T fg2dot = __shfl_sync(FULL_WARP, l2, LANE_FG);
    const T fn2dot = __shfl_sync(FULL_WARP, l2, LANE_FN);
    aux.hdot = hdot;
    aux.etadot = etadot;
    aux.dgpi = (T(4) / T(3)) * (grho_g * sigma_g + grho_n * sigma_n) + wnu_m * sigma_n;
    aux.sigma_g = sigma_g;
    aux.sigma_n = sigma_n;
    aux.sigg_dot = ((tc_on || rsa) ? T(0) : fg2dot) / T(2);
    aux.sign_dot = (rsa ? T(0) : fn2dot) / T(2);
    aux.pol_term = pol_term;
  }
}

template <typename T>
__device__ __forceinline__ void sources(const T (&y)[NF], const T (&dy)[NF],
                                        const Aux<T>& aux, const T (&q)[NQD],
                                        const Wavenumber<T>& kn, T (&s)[NPLANE]) {
  const T k2 = kn.k2, inv_k2 = kn.inv_k2;
  const T adotoa = q[Q_ADOTOA], grho_g = q[Q_GG], grho_n = q[Q_GNISW];
  const T vis = q[Q_VIS], expmk = q[Q_EXPMK];
  const T alpha = (aux.hdot + T(6) * aux.etadot) * (T(0.5) * inv_k2);
  const T X = T(1.5) * aux.dgpi * inv_k2;
  const T eta = y[F_ETA];
  const T phi = eta - adotoa * alpha;
  const T psi = phi - X;
  const T dadotoa = q[D_DADOTOA];
  const T alphadot = eta - X - T(2) * adotoa * alpha;
  const T phidot = aux.etadot - dadotoa * alpha - adotoa * alphadot;
  const T dgpidot = (T(4) / T(3)) *
                    (-T(2) * adotoa * (grho_g * aux.sigma_g + grho_n * aux.sigma_n) +
                     grho_g * aux.sigg_dot + grho_n * aux.sign_dot);
  const T psidot = phidot - T(1.5) * dgpidot * inv_k2;
  const T theta0_N = y[F_DG] / T(4) - adotoa * alpha;
  const T vb_N = (y[F_TB] + k2 * alpha) * kn.inv_k;
  const T Pi = aux.pol_term / T(4);
  s[0] = vis * (theta0_N + psi + Pi / T(4)) + expmk * (phidot + psidot);
  s[1] = vis * vb_N;
  s[2] = T(0.75) * vis * Pi;
  s[3] = expmk * (phi + psi);
  const T gc = q[Q_GC], gb = q[Q_GB];
  s[4] = (gc * y[F_DC] + gb * y[F_DB]) * q[D_INV_WSUM];
  s[5] = (gc * dy[F_DC] + gb * dy[F_DB]) * q[D_INV_WSUM];
  s[6] = T(0.5) * (phi + psi);
}

// the raw rows of steps [t TS, (t + 1) TS) into one buffer, spread over the block
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* Qc, int S, int t) {
  const int s0 = t * TILE_STEPS<T>, n = min(TILE_STEPS<T>, S - s0) * 3 * NQ;
  const T* src = Qc + (size_t)s0 * 3 * NQ;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    cp_async(buf + (e / NQ) * NQD + e % NQ, src + e);
  cp_async_commit();
}

// The derived fields of a tile's rows, and for each of its steps whether
// its first row equals the last row of the step before (`prev_last`: that
// row of the previous tile, or null) field for field. Then the step's first
// RHS evaluation has the inputs of the previous step's last one, which
// evaluated the new state at tau_b for the sources, and is not repeated.
// models/perturbations.py:_stage_tables makes such rows: tau_a of a step is
// tau_b of the step before, and each field is a function of tau alone.
template <typename T>
__device__ __forceinline__ void derive_rows(T* buf, int S, int t, const T* prev_last,
                                            bool* same) {
  const int ns = min(TILE_STEPS<T>, S - t * TILE_STEPS<T>);
  for (int e = threadIdx.x; e < ns * 3; e += blockDim.x) derive_row(buf + e * NQD);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const T* a = buf + s * 3 * NQD;
    const T* p = s > 0 ? a - NQD : prev_last;
    bool eq = p != nullptr;
    if (eq) {
#pragma unroll
      for (int f = 0; f < NQ; ++f) eq = eq && a[f] == p[f];
    }
    same[s] = eq;
  }
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32, 2)
boltzmann_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
                 const T* __restrict__ rnu_in, T* __restrict__ out, int C,
                 int S, int nk, T rsa_ktau) {
  constexpr int TS = TILE_STEPS<T>;
  __shared__ __align__(16) T rows[2][TS * 3 * NQD];
  __shared__ T staged[TS][NPLANE][WARPS];
  __shared__ bool same[2][TS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.y, k0 = blockIdx.x * WARPS;
  // a warp past the last k repeats it, so that it keeps the block's barriers
  const T k = kvec[min(k0 + w, nk - 1)];
  const Wavenumber<T> kn = {k, k * k, T(1) / k, T(1) / (k * k)};
  const T rnu = rnu_in[c];
  const T* Qc = qtab + (size_t)c * S * 3 * NQ;
  const Multipole<T> mp = multipole_of(lane, k);
  const int ntiles = (S + TS - 1) / TS;

  stage_rows(rows[0], Qc, S, 0);
  cp_async_wait<0>();
  __syncthreads();
  derive_rows(rows[0], S, 0, (const T*)nullptr, same[0]);
  __syncthreads();

  T y[NF], acc[NF], yt[NF], kd[NF];
  T ym, accm, ytm, kdm;
  Aux<T> aux;
  ics(k, rows[0][Q_TAU], rnu, lane, y, ym);
  for (int t = 0; t < ntiles; ++t) {
    const T* buf = rows[t & 1];
    if (t + 1 < ntiles) stage_rows(rows[(t + 1) & 1], Qc, S, t + 1);
    const int ns = min(TS, S - t * TS);
    for (int s = 0; s < ns; ++s) {
      T q[NQD];
      load_row(buf + (s * 3 + 0) * NQD, q);
      const T tau_a = q[Q_TAU];
      // unless kd, kdm already hold this evaluation (the step before's last)
      if (!same[t & 1][s]) rhs<T, false>(y, ym, q, kn, rsa_ktau, mp, kd, kdm, aux);
      const T tau_b = buf[(s * 3 + 2) * NQD + Q_TAU];
      const T dt = tau_b - tau_a;
      load_row(buf + (s * 3 + 1) * NQD, q);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        acc[j] = kd[j];
        yt[j] = y[j] + T(0.5) * dt * kd[j];
      }
      accm = kdm;
      ytm = ym + T(0.5) * dt * kdm;
      rhs<T, false>(yt, ytm, q, kn, rsa_ktau, mp, kd, kdm, aux);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        acc[j] = acc[j] + T(2) * kd[j];
        yt[j] = y[j] + T(0.5) * dt * kd[j];
      }
      accm = accm + T(2) * kdm;
      ytm = ym + T(0.5) * dt * kdm;
      rhs<T, false>(yt, ytm, q, kn, rsa_ktau, mp, kd, kdm, aux);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        acc[j] = acc[j] + T(2) * kd[j];
        yt[j] = y[j] + dt * kd[j];
      }
      accm = accm + T(2) * kdm;
      ytm = ym + dt * kdm;
      load_row(buf + (s * 3 + 2) * NQD, q);
      rhs<T, false>(yt, ytm, q, kn, rsa_ktau, mp, kd, kdm, aux);
      if (k * tau_b >= T(IC_RELEASE_KTAU) || tau_b >= T(3)) {
#pragma unroll
        for (int j = 0; j < NF; ++j) y[j] = y[j] + (dt / T(6)) * (acc[j] + kd[j]);
        ym = ym + (dt / T(6)) * (accm + kdm);
      } else {
        ics(k, tau_b, rnu, lane, y, ym);
      }
      rhs<T, true>(y, ym, q, kn, rsa_ktau, mp, kd, kdm, aux);
      T src[NPLANE];
      sources(y, kd, aux, q, kn, src);
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
      derive_rows(rows[(t + 1) & 1], S, t + 1, buf + ((TS - 1) * 3 + 2) * NQD,
                  same[(t + 1) & 1]);
    __syncthreads();   // the derived fields are written; `staged` is free
  }
}

template <typename T>
int launch(const void* qtab, const void* kvec, const void* rnu, void* out, int C,
           int S, int nk, double rsa_ktau, void* stream) {
  dim3 grid((nk + WARPS - 1) / WARPS, C);
  boltzmann_kernel<T><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)qtab, (const T*)kvec, (const T*)rnu, (T*)out, C, S, nk, (T)rsa_ktau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int boltzmann_f32(const void* qtab, const void* kvec, const void* rnu,
                             void* out, int C, int S, int nk, double rsa_ktau,
                             void* stream) {
  return launch<float>(qtab, kvec, rnu, out, C, S, nk, rsa_ktau, stream);
}

extern "C" int boltzmann_f64(const void* qtab, const void* kvec, const void* rnu,
                             void* out, int C, int S, int nk, double rsa_ktau,
                             void* stream) {
  return launch<double>(qtab, kvec, rnu, out, C, S, nk, rsa_ktau, stream);
}
