// K4: the RECFAST recurrence (T_M, x_He, x_H down the descending-z grid).
//
// Replaces cosmomc_tpu/models/recfast.py:compute_thermo (the lax.scan at
// recfast.py:279). Every z-only quantity (H(z), n_H, T_rad, the K
// correction, the Saha solutions) arrives precomputed in the (C, 12, N)
// table `zt`; the kernel does the state-dependent work: a Crank-Nicolson
// step with two Newton iterations for each of T_M, x_He and x_H, with the
// closed-form derivative of each residual, then the regime selection.
//
// Bound on this card: neither bytes (3.6 MB) nor operations (~300 a step)
// but the length of one chain's 7999-step dependency chain, so the design
// shortens what one step puts on that chain. One warp owns one chain (one
// block of 32 threads a chain, so every chain has a scheduler to itself):
// - the Saha/hot prefix is not serial: while z > 3000, x_He,Saha > 0.995
//   and x_H,Saha > 0.985 the selection takes the table's state whatever the
//   ODE step gave, so the 32 lanes write those nodes from the table in
//   parallel and find the first node where a selection can take an ODE
//   value (models/recfast.py:first_live_node); the walk starts there;
// - in the walk all lanes carry the same state and run the same
//   instructions; the transcendentals of the rate coefficients at
//   (node, T_M), five pow and four exp that do not depend on one another,
//   are evaluated one per lane (per-lane base, exponent and coefficient,
//   one powf and one expf instruction stream for the warp) and gathered by
//   __shfl_sync;
// - the rate coefficients at node j serve step j + 1 from registers; they
//   are evaluated again only where T_M was replaced by the radiation-
//   locked value (z > 3000) or the previous step did not need them;
// - a solve whose result the selection discards is skipped: H while
//   x_H,Saha > 0.985, He too while also x_He,Saha > 0.995 (warp-uniform
//   branches);
// - the 12 table rows of the next 32 nodes arrive in shared memory by
//   cp.async while the current 32 are walked (double buffer), so no global
//   load is on the chain; each lane keeps one node's outputs and the warp
//   stores 32 consecutive nodes at once.
// - an IEEE divide is ~60 clocks on the chain and ends a basic block (its
//   slow path is a branch), so the compiler overlaps nothing across one:
//   the 47 divides a step of a line-for-line transcription took more than
//   half of it. 18 are left. Divisors that depend on z alone (H (1+z) and
//   (1+z)/2) become reciprocals taken once a tile, one node a lane; the
//   capture factor and its derivative share 1/den; in the rate
//   coefficients the quotients with different operands (t/T_0, t/T_1,
//   t/1e4; the exp arguments and -Bfact/t; the two alpha's) are one divide
//   each with per-lane operands. Products by a reciprocal differ from the
//   plain version's quotients in the last bit (PERF.md has the accuracy).
// Each transcendental is the function the plain version calls (pow, exp,
// log, sqrt; no fast intrinsic), and the selections compare the same table
// values with the same constants.
//
// The arithmetic otherwise mirrors models/recfast.py:_scan_plain.
//
// With a state buffer `st` (C, 2, N) the walk also stores x_H and x_He at
// every node (T_M is the tm output itself), for the reverse kernel below.
//
// The reverse pass, recfast_bwd_kernel: the gradient of the unrolled map,
// as jax.grad of the JAX scan gives it (the two Newton iterations and the
// derivative of their closed-form Newton derivatives, the selections, the
// clips with jnp.clip's half gradient at a tie). One warp a chain walks the
// nodes back from N - 1 to the first live node. A step from node i to i + 1
// is a function of 28 inputs: the state (x_H, x_He, T_M) at i, the 12
// table rows at i and at i + 1, and fHe. Lane d evaluates the step once in
// dual numbers (value, derivative) seeded along input d: a forward-mode
// column of the step's Jacobian, through the same operations as the plain
// version's step (divides and all, not the forward kernel's reciprocals).
// Its dot with the adjoint of the step's outputs (the carried state and the
// cotangents of x_e and T_M at i + 1) is the adjoint of input d: lanes 0-2
// give the state's adjoint at i, passed to every lane by shuffles; lanes
// 3-14 and 15-26 the table's at i and i + 1; lane 27 fHe's. The primal state
// comes from `st` and tm, so nothing is recomputed along the chain. Nodes
// before the first live one take the table's state: their adjoints go to
// the table there, one node a lane. Bound: the 7999-step chain again, now
// of ~3x a plain step's operations (the dual arithmetic), one step a warp.
#include "common.cuh"

namespace {

// rows of the z table (models/recfast.py ZT_*)
enum { ZT_Z, ZT_TR, ZT_CT, ZT_HZ1, ZT_N, ZT_NHE, ZT_KHE, ZT_KH, ZT_XEEARLY,
       ZT_XHESAHA, ZT_XHSAHA, ZT_TMHOT, N_ZT };
// constants (models/recfast.py KERNEL_CONSTS order)
enum { K_CR, K_CDB, K_CL, K_CDB_HE, K_CL_HE, K_CK_HE, K_COMPT, K_BFACT,
       K_LAMBDA_H, K_LAMBDA_HE, K_AH, K_B_PPB, K_C_PPB, K_D_PPB, K_AHE,
       K_E0_VF, K_E1_VF, K_T0_VF, K_T1_VF, N_K };

constexpr int TILE = 32;   // z nodes per shared-memory tile: one a lane
// rows the warp adds to a staged tile: 1/(H (1+z)) and 2/(1+z)
enum { ROW_INV_HZ1 = N_ZT, ROW_TZ, N_ROWS };

template <typename T>
struct Consts {
  T k[N_K];
};

// what a lane evaluates of the rate coefficients: t / tdiv and its sqrt
// (lanes 0, 1: T_0, T_1; lanes 3, 4: 1e4), pow(base, pexp) (lanes 0..4),
// -ecoef / t (lanes 0..4) and its exp (lanes 0..3)
template <typename T>
struct LaneOps {
  T tdiv, pexp, ecoef;
};

// the T_M-dependent rate coefficients of both channels at one T_M
template <typename T>
struct Coeffs {
  T he_rdown, he_rup, he_ecl, he_bt, h_rdown, h_rup, h_ecl;
};

// the z-only part of a node's rates
template <typename T>
struct Node {
  T khe, kh, n, nhe, inv_hz1;
};

// rate coefficients at one (z node, T_M): He uses bt = -Bfact/T_M and the
// escape factor K_He; H uses the K-corrected escape factor K_H
template <typename T>
struct Rate {
  T rdown, rup, ecl, bt, K, n, nhe, inv_hz1;
};

template <typename T>
__device__ __forceinline__ LaneOps<T> lane_ops(int lane, const Consts<T>& c) {
  LaneOps<T> o = {T(1), T(0), T(0)};
  if (lane == 0) o = {c.k[K_T0_VF], c.k[K_E0_VF], c.k[K_CDB_HE]};
  if (lane == 1) o = {c.k[K_T1_VF], c.k[K_E1_VF], c.k[K_CL_HE]};
  if (lane == 2) o = {T(1), T(1.5), c.k[K_CDB]};
  if (lane == 3) o = {T(1e4), c.k[K_B_PPB], c.k[K_CL]};
  if (lane == 4) o = {T(1e4), c.k[K_D_PPB], c.k[K_BFACT]};
  return o;
}

// alpha_He, alpha_H, the two photoionization rates and the Boltzmann
// factors at T_M = t (models/recfast.py:_rate_coeffs), the independent
// quotients, pow and exp one per lane. Called by all 32 lanes with the
// same t.
template <typename T>
__device__ __forceinline__ Coeffs<T> coeffs(T t, int lane, const LaneOps<T>& o,
                                            const Consts<T>& c) {
  const T tq = t / o.tdiv;
  const T sq = xsqrt(tq);
  const T base = lane < 2 ? T(1) + sq : (lane == 2 ? c.k[K_CR] * t : tq);
  const T pw = xpow(base, o.pexp);
  const T arg = -o.ecoef / t;
  const T ex = xexp(arg);
  const T sq0 = __shfl_sync(FULL_WARP, sq, 0);
  const T p_e0 = __shfl_sync(FULL_WARP, pw, 0), p_e1 = __shfl_sync(FULL_WARP, pw, 1);
  const T p15 = __shfl_sync(FULL_WARP, pw, 2);
  const T p_b = __shfl_sync(FULL_WARP, pw, 3), p_d = __shfl_sync(FULL_WARP, pw, 4);
  // alpha_He on lane 0, alpha_H on lane 1
  const T alpha = (lane == 0 ? c.k[K_AHE] : c.k[K_AH] * p_b) /
                  (lane == 0 ? sq0 * p_e0 * p_e1 : T(1) + c.k[K_C_PPB] * p_d);
  Coeffs<T> r;
  r.he_rdown = __shfl_sync(FULL_WARP, alpha, 0);
  r.he_rup = T(4) * r.he_rdown * p15 * __shfl_sync(FULL_WARP, ex, 0);
  r.he_ecl = __shfl_sync(FULL_WARP, ex, 1);
  r.he_bt = __shfl_sync(FULL_WARP, arg, 4);
  r.h_rdown = __shfl_sync(FULL_WARP, alpha, 1);
  r.h_rup = r.h_rdown * p15 * __shfl_sync(FULL_WARP, ex, 2);
  r.h_ecl = __shfl_sync(FULL_WARP, ex, 3);
  return r;
}

template <typename T>
__device__ __forceinline__ Rate<T> he_rate(const Coeffs<T>& q, const Node<T>& n) {
  return {q.he_rdown, q.he_rup, q.he_ecl, q.he_bt, n.khe, n.n, n.nhe, n.inv_hz1};
}

template <typename T>
__device__ __forceinline__ Rate<T> h_rate(const Coeffs<T>& q, const Node<T>& n) {
  return {q.h_rdown, q.h_rup, q.h_ecl, T(0), n.kh, n.n, T(0), n.inv_hz1};
}

template <typename T>
__device__ __forceinline__ T row(const T* Z, int N, int f, int k) {
  return Z[(size_t)f * N + k];
}

// He singlet rate (xe = xH + fHe xx) and its derivative in xx
template <typename T>
__device__ __forceinline__ void dxhe(T xx, T xe, T fhe, const Rate<T>& r,
                                     const Consts<T>& c, T* v, T* d) {
  T nhe1 = (T(1) - xx) * r.nhe;
  bool live = nhe1 > T(1e-30);
  nhe1 = live ? nhe1 : T(1e-30);
  T arg = r.bt - xlog(r.K * nhe1);
  T u = xexp(xmin(arg, T(80)));
  T du = (live && arg < T(80)) ? u * r.nhe / nhe1 : T(0);
  T inv_den = T(1) / (u + c.k[K_LAMBDA_HE] + r.rup);
  T crate = (u + c.k[K_LAMBDA_HE]) * inv_den;
  T dcrate = du * r.rup * (inv_den * inv_den);
  T q = xe * xx * r.n * r.rdown - r.rup * (T(1) - xx) * r.ecl;
  T dq = (fhe * xx + xe) * r.n * r.rdown + r.rup * r.ecl;
  *v = q * crate * r.inv_hz1;
  *d = (dq * crate + q * dcrate) * r.inv_hz1;
}

// Peebles H rate (xe = xx + fHe xHe) and its derivative in xx
template <typename T>
__device__ __forceinline__ void dxh(T xx, T xe, const Rate<T>& r,
                                    const Consts<T>& c, T* v, T* d) {
  T n1s = (T(1) - xx) * r.n;
  bool live = n1s > T(1e-30);
  n1s = live ? n1s : T(1e-30);
  T inv_den = T(1) / (T(1) + r.K * (c.k[K_LAMBDA_H] + r.rup) * n1s);
  T crate = (T(1) + r.K * c.k[K_LAMBDA_H] * n1s) * inv_den;
  T dcrate = live ? r.n * r.K * r.rup * (inv_den * inv_den) : T(0);
  T q = xe * xx * r.n * r.rdown - r.rup * (T(1) - xx) * r.ecl;
  T dq = (xx + xe) * r.n * r.rdown + r.rup * r.ecl;
  *v = q * crate * r.inv_hz1;
  *d = (dq * crate + q * dcrate) * r.inv_hz1;
}

template <typename T>
__device__ __forceinline__ T newton_step(T xp, T x, T f_prev, T dz, T v, T d) {
  T g = xp - x - T(0.5) * dz * (f_prev + v);
  T gp = T(1) - T(0.5) * dz * d;
  return xp - g / (xabs(gp) > T(1e-12) ? gp : T(1));
}

template <typename T>
struct Step {
  T z0, z, tr0, tr1, ct0, ct1, tz0, tz1;   // tz = 2/(1+z)
  Node<T> n0, n1;
};

// T_M: dTm/dz = A (tm - tr) + 2 tm/(1+z), A = CT xe/(1+xe+fHe)
template <typename T>
__device__ __forceinline__ T tm_step(T tm, T xe_tot, T fhe, const Step<T>& st) {
  const T dz = st.z - st.z0;
  const T xfac = xe_tot / (T(1) + xe_tot + fhe);
  const T A0 = st.ct0 * xfac, A1 = st.ct1 * xfac;
  const T fT = A0 * (tm - st.tr0) + tm * st.tz0;
  T tm_new = tm + dz * fT;
#pragma unroll
  for (int it = 0; it < 2; ++it)
    tm_new = newton_step(tm_new, tm, fT, dz,
                         A1 * (tm_new - st.tr1) + tm_new * st.tz1, A1 + st.tz1);
  return tm_new;
}

// One Crank-Nicolson step of (T_M, x_He, x_H) from node i to node j: the
// He and H rates at node i from the held coefficients q0, the T_M solve,
// the coefficients at (j, T_M), then the He and the H Newton pairs.
// WITH_H: also the H solve; without it x_H,ode is not computed (the
// selection discards it).
template <typename T, bool WITH_H>
__device__ __forceinline__ void ode_step(T xH, T xHe, T tm, T fhe, const Step<T>& st,
                                         const Coeffs<T>& q0, int lane,
                                         const LaneOps<T>& ops, const Consts<T>& c,
                                         T* tm_out, T* xHe_out, T* xH_out,
                                         Coeffs<T>* q1_out) {
  const T dz = st.z - st.z0;
  const T xe_tot = xH + fhe * xHe;
  T v, d, f_he, f_h = T(0);
  dxhe(xHe, xe_tot, fhe, he_rate(q0, st.n0), c, &f_he, &d);
  if (WITH_H) dxh(xH, xe_tot, h_rate(q0, st.n0), c, &f_h, &d);

  const T tm_new = tm_step(tm, xe_tot, fhe, st);
  const Coeffs<T> q1 = coeffs(tm_new, lane, ops, c);
  // He singlet channel, x_H frozen
  const Rate<T> he1 = he_rate(q1, st.n1);
  T xHe_ode = xHe + dz * f_he;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    dxhe(xHe_ode, xH + fhe * xHe_ode, fhe, he1, c, &v, &d);
    xHe_ode = newton_step(xHe_ode, xHe, f_he, dz, v, d);
  }
  T xH_ode = xH;
  if (WITH_H) {
    // H with the new x_He
    const Rate<T> h1 = h_rate(q1, st.n1);
    xH_ode = xH + dz * f_h;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      dxh(xH_ode, xH_ode + fhe * xHe_ode, h1, c, &v, &d);
      xH_ode = newton_step(xH_ode, xH, f_h, dz, v, d);
    }
  }
  *tm_out = tm_new;
  *xHe_out = xHe_ode;
  *xH_out = xH_ode;
  *q1_out = q1;
}

// the 12 rows of nodes [t TILE, (t + 1) TILE) into one buffer, one node a lane
template <typename T>
__device__ __forceinline__ void stage_tile(T (*buf)[TILE], const T* Z, int N, int t,
                                           int lane) {
  const int node = t * TILE + lane;
  if (node < N) {
#pragma unroll
    for (int f = 0; f < N_ZT; ++f) cp_async(&buf[f][lane], Z + (size_t)f * N + node);
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(32)
recfast_kernel(const T* __restrict__ zt, const T* __restrict__ fhe_in,
               const T* __restrict__ kc, T* __restrict__ xe_out,
               T* __restrict__ tm_out, T* __restrict__ st, int C, int N) {
  __shared__ T tile[2][N_ROWS][TILE];
  const int ch = blockIdx.x, lane = threadIdx.x;
  if (ch >= C) return;
  Consts<T> c;
#pragma unroll
  for (int i = 0; i < N_K; ++i) c.k[i] = kc[i];
  const LaneOps<T> ops = lane_ops(lane, c);
  const T* Z = zt + (size_t)ch * N_ZT * N;
  T* xe_row = xe_out + (size_t)ch * N;
  T* tm_row = tm_out + (size_t)ch * N;
  T* st_row = st == nullptr ? nullptr : st + (size_t)ch * 2 * N;
  const T fhe = fhe_in[ch];

  // the prefix: nodes before the first live one take the table's state
  int jlive = N;
  for (int j0 = 0; j0 < N && jlive == N; j0 += TILE) {
    const int j = j0 + lane;
    bool live = false;
    T z = T(0), xhe_s = T(1), xh_s = T(1);
    if (j < N) {
      z = row(Z, N, ZT_Z, j);
      xhe_s = row(Z, N, ZT_XHESAHA, j);
      xh_s = row(Z, N, ZT_XHSAHA, j);
      live = j > 0 && !(z > T(3000) && xhe_s > T(0.995) && xh_s > T(0.985));
    }
    const unsigned m = __ballot_sync(FULL_WARP, live);
    if (m) jlive = j0 + __ffs(m) - 1;
    if (j < jlive) {   // jlive <= N
      const T xHe = xclamp(xhe_s, T(0), T(1)), xH = xclamp(xh_s, T(0), T(1));
      xe_row[j] = j == 0 ? T(1) + T(2) * fhe
                         : (z > T(5500) ? row(Z, N, ZT_XEEARLY, j) : xH + fhe * xHe);
      tm_row[j] = row(Z, N, ZT_TMHOT, j);
      if (st_row != nullptr) {
        st_row[j] = j == 0 ? T(1) : xH;
        st_row[N + j] = j == 0 ? T(1) : xHe;
      }
    }
  }
  if (jlive == N) return;

  // the walk, from the state at node jlive - 1
  const int i0 = jlive - 1;
  T xH = T(1), xHe = T(1);
  if (i0 > 0) {
    xHe = xclamp(row(Z, N, ZT_XHESAHA, i0), T(0), T(1));
    xH = xclamp(row(Z, N, ZT_XHSAHA, i0), T(0), T(1));
  }
  T tm = row(Z, N, ZT_TMHOT, i0);
  T z0 = row(Z, N, ZT_Z, i0), tr0 = row(Z, N, ZT_TR, i0), ct0 = row(Z, N, ZT_CT, i0);
  T tz0 = T(2) / (T(1) + z0);
  Node<T> n0 = {row(Z, N, ZT_KHE, i0), row(Z, N, ZT_KH, i0), row(Z, N, ZT_N, i0),
                row(Z, N, ZT_NHE, i0), T(1) / row(Z, N, ZT_HZ1, i0)};
  Coeffs<T> q0 = {};      // the coefficients at (node i, tm), when held
  bool held = false;
  T my_xe = T(0), my_tm = T(0), my_xH = T(0), my_xHe = T(0);

  const int t_first = jlive / TILE, t_last = (N - 1) / TILE;
  stage_tile(tile[t_first & 1], Z, N, t_first, lane);
  for (int t = t_first; t <= t_last; ++t) {
    T (*S)[TILE] = tile[t & 1];
    if (t < t_last) stage_tile(tile[(t + 1) & 1], Z, N, t + 1, lane);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    // the z-only reciprocals of the tile's nodes, one node a lane
    S[ROW_INV_HZ1][lane] = T(1) / S[ZT_HZ1][lane];
    S[ROW_TZ][lane] = T(2) / (T(1) + S[ZT_Z][lane]);
    __syncwarp();
    const int j_lo = max(jlive, t * TILE), j_hi = min(N, (t + 1) * TILE);
    for (int j = j_lo; j < j_hi; ++j) {
      const int s = j - t * TILE;
      const Step<T> st = {z0, S[ZT_Z][s], tr0, S[ZT_TR][s], ct0, S[ZT_CT][s], tz0,
                          S[ROW_TZ][s], n0,
                          {S[ZT_KHE][s], S[ZT_KH][s], S[ZT_N][s], S[ZT_NHE][s],
                           S[ROW_INV_HZ1][s]}};
      const T xhe_s = S[ZT_XHESAHA][s], xh_s = S[ZT_XHSAHA][s];
      const bool hot = st.z > T(3000);
      // the H solve is discarded while the selection takes x_H,Saha; the
      // He solve feeds the H solve, so it is discarded only if both are
      const bool need_h = !(xh_s > T(0.985));
      const bool need_he = need_h || !(xhe_s > T(0.995));
      T tm_new, xHe_ode = xHe, xH_ode = xH;
      Coeffs<T> q1 = {};
      if (need_he && !held) q0 = coeffs(tm, lane, ops, c);
      if (need_h)
        ode_step<T, true>(xH, xHe, tm, fhe, st, q0, lane, ops, c, &tm_new, &xHe_ode,
                          &xH_ode, &q1);
      else if (need_he)
        ode_step<T, false>(xH, xHe, tm, fhe, st, q0, lane, ops, c, &tm_new, &xHe_ode,
                           &xH_ode, &q1);
      else
        tm_new = tm_step(tm, xH + fhe * xHe, fhe, st);

      // regime selection
      xHe = xclamp(xhe_s > T(0.995) ? xhe_s : xHe_ode, T(0), T(1));
      xH = xclamp(xh_s > T(0.985) ? xh_s : xH_ode, T(0), T(1));
      const T xe = st.z > T(5500) ? S[ZT_XEEARLY][s] : xH + fhe * xHe;
      tm = hot ? S[ZT_TMHOT][s] : tm_new;
      if (lane == s) {
        my_xe = xe;
        my_tm = tm;
        my_xH = xH;
        my_xHe = xHe;
      }
      // the coefficients at (j, tm_new) are step j + 1's at (i, tm)
      held = need_he && !hot;
      q0 = q1;
      z0 = st.z;
      tr0 = st.tr1;
      ct0 = st.ct1;
      tz0 = st.tz1;
      n0 = st.n1;
    }
    const int node = t * TILE + lane;
    if (node >= j_lo && node < j_hi) {
      xe_row[node] = my_xe;
      tm_row[node] = my_tm;
      if (st_row != nullptr) {
        st_row[node] = my_xH;
        st_row[N + node] = my_xHe;
      }
    }
    __syncwarp();   // all lanes are done with this buffer before it is refilled
  }
}


// ---- the reverse pass ------------------------------------------------------

// a value and its derivative along one input direction
template <typename T>
struct Dual {
  T v, d;
};
template <typename T>
__device__ __forceinline__ Dual<T> cst(T v) { return {v, T(0)}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(T a, Dual<T> b) {
  const T q = a / b.v;
  return {q, -q * b.d / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> dexp(Dual<T> a) {
  const T e = xexp(a.v);
  return {e, e * a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> dlog(Dual<T> a) { return {xlog(a.v), a.d / a.v}; }
template <typename T>
__device__ __forceinline__ Dual<T> dsqrt(Dual<T> a) {
  const T r = xsqrt(a.v);
  return {r, a.d / (T(2) * r)};
}
// x ** e for a constant e: d = e x^(e-1) dx, as jax differentiates pow
template <typename T>
__device__ __forceinline__ Dual<T> dpow(Dual<T> a, T e) {
  return {xpow(a.v, e), e * xpow(a.v, e - T(1)) * a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> sel(bool c, Dual<T> a, Dual<T> b) { return c ? a : b; }
// jnp.minimum(a, b) against a constant: half the derivative at a tie
template <typename T>
__device__ __forceinline__ Dual<T> dmin(Dual<T> a, T b) {
  return a.v < b ? a : (a.v == b ? Dual<T>{b, T(0.5) * a.d} : cst(b));
}
template <typename T>
__device__ __forceinline__ Dual<T> dmax(Dual<T> a, T b) {
  return a.v > b ? a : (a.v == b ? Dual<T>{b, T(0.5) * a.d} : cst(b));
}
// jnp.clip(x, 0, 1) = min(max(x, 0), 1) (models/recfast.py:_clip)
template <typename T>
__device__ __forceinline__ Dual<T> dclip01(Dual<T> x) { return dmin(dmax(x, T(0)), T(1)); }
template <typename T>
__device__ __forceinline__ T clip01_slope(T x) {
  const T m = x > T(0) ? T(1) : (x == T(0) ? T(0.5) : T(0));
  const T mx = xmax(x, T(0));
  return m * (mx < T(1) ? T(1) : (mx == T(1) ? T(0.5) : T(0)));
}

// models/recfast.py:_rate_coeffs at T_M = t, in the plain version's order
template <typename T>
struct DCoeffs {
  Dual<T> he_down, he_up, he_ecl, he_bt, h_down, h_up, h_ecl;
};

template <typename T>
__device__ __forceinline__ DCoeffs<T> dcoeffs(Dual<T> t, const Consts<T>& c) {
  const Dual<T> sq0 = dsqrt(t / c.k[K_T0_VF]), sq1 = dsqrt(t / c.k[K_T1_VF]);
  const Dual<T> he_down = c.k[K_AHE] / (sq0 * dpow(T(1) + sq0, c.k[K_E0_VF]) *
                                        dpow(T(1) + sq1, c.k[K_E1_VF]));
  const Dual<T> tt = t / T(1e4);
  const Dual<T> h_down = c.k[K_AH] * dpow(tt, c.k[K_B_PPB]) /
                         (T(1) + c.k[K_C_PPB] * dpow(tt, c.k[K_D_PPB]));
  const Dual<T> p15 = dpow(c.k[K_CR] * t, T(1.5));
  DCoeffs<T> r;
  r.he_down = he_down;
  r.he_up = T(4) * he_down * p15 * dexp(-c.k[K_CDB_HE] / t);
  r.he_ecl = dexp(-c.k[K_CL_HE] / t);
  r.he_bt = -c.k[K_BFACT] / t;
  r.h_down = h_down;
  r.h_up = h_down * p15 * dexp(-c.k[K_CDB] / t);
  r.h_ecl = dexp(-c.k[K_CL] / t);
  return r;
}

// _dxhe: the He singlet rate (xe = x_H + fHe xx) and its derivative in xx
template <typename T>
__device__ __forceinline__ void ddxhe(Dual<T> xx, Dual<T> xe, Dual<T> fhe, const DCoeffs<T>& q,
                                      const Dual<T>* r, const Consts<T>& c, Dual<T>* v,
                                      Dual<T>* d) {
  const Dual<T> nhe = r[ZT_NHE], n = r[ZT_N], hz1 = r[ZT_HZ1];
  Dual<T> nhe1 = (T(1) - xx) * nhe;
  const bool live = nhe1.v > T(1e-30);
  nhe1 = sel(live, nhe1, cst(T(1e-30)));
  const Dual<T> arg = q.he_bt - dlog(r[ZT_KHE] * nhe1);
  const Dual<T> u = dexp(dmin(arg, T(80)));
  const Dual<T> du = sel(live && arg.v < T(80), u * nhe / nhe1, cst(T(0)));
  const Dual<T> den = u + c.k[K_LAMBDA_HE] + q.he_up;
  const Dual<T> crate = (u + c.k[K_LAMBDA_HE]) / den;
  const Dual<T> dcrate = du * q.he_up / (den * den);
  const Dual<T> qq = xe * xx * n * q.he_down - q.he_up * (T(1) - xx) * q.he_ecl;
  const Dual<T> dq = (fhe * xx + xe) * n * q.he_down + q.he_up * q.he_ecl;
  *v = qq * crate / hz1;
  *d = (dq * crate + qq * dcrate) / hz1;
}

// _dxh: the Peebles rate (xe = xx + fHe x_He) and its derivative in xx
template <typename T>
__device__ __forceinline__ void ddxh(Dual<T> xx, Dual<T> xe, const DCoeffs<T>& q,
                                     const Dual<T>* r, const Consts<T>& c, Dual<T>* v,
                                     Dual<T>* d) {
  const Dual<T> n = r[ZT_N], K = r[ZT_KH], hz1 = r[ZT_HZ1];
  Dual<T> n1s = (T(1) - xx) * n;
  const bool live = n1s.v > T(1e-30);
  n1s = sel(live, n1s, cst(T(1e-30)));
  const Dual<T> den = T(1) + K * (c.k[K_LAMBDA_H] + q.h_up) * n1s;
  const Dual<T> crate = (T(1) + K * c.k[K_LAMBDA_H] * n1s) / den;
  const Dual<T> dcrate = sel(live, n * K * q.h_up / (den * den), cst(T(0)));
  const Dual<T> qq = xe * xx * n * q.h_down - q.h_up * (T(1) - xx) * q.h_ecl;
  const Dual<T> dq = (xx + xe) * n * q.h_down + q.h_up * q.h_ecl;
  *v = qq * crate / hz1;
  *d = (dq * crate + qq * dcrate) / hz1;
}

// _cn's Newton update from xp
template <typename T>
__device__ __forceinline__ Dual<T> dnewton(Dual<T> xp, Dual<T> x, Dual<T> f_prev, Dual<T> dz,
                                           Dual<T> v, Dual<T> d) {
  const Dual<T> g = xp - x - T(0.5) * dz * (f_prev + v);
  const Dual<T> gp = T(1) - T(0.5) * dz * d;
  return xp - g / sel(xabs(gp.v) > T(1e-12), gp, cst(T(1)));
}

// One step of models/recfast.py:_scan_plain from node i (state xH, xHe, tm,
// row r0) to node i + 1 (row r1): the new state and x_e at i + 1
template <typename T>
__device__ __forceinline__ void dual_step(Dual<T> xH, Dual<T> xHe, Dual<T> tm, const Dual<T>* r0,
                                          const Dual<T>* r1, Dual<T> fhe, const Consts<T>& c,
                                          Dual<T>* xH_n, Dual<T>* xHe_n, Dual<T>* tm_n,
                                          Dual<T>* xe_n) {
  const Dual<T> z = r1[ZT_Z];
  const Dual<T> dz = z - r0[ZT_Z];
  const Dual<T> xe_tot = xH + fhe * xHe;
  // _tm_step
  const Dual<T> xfac = xe_tot / (T(1) + xe_tot + fhe);
  const Dual<T> A0 = r0[ZT_CT] * xfac, A1 = r1[ZT_CT] * xfac;
  const Dual<T> tr1 = r1[ZT_TR], zp1 = T(1) + z;
  const Dual<T> fT = A0 * (tm - r0[ZT_TR]) + T(2) * tm / (T(1) + r0[ZT_Z]);
  Dual<T> tm_new = tm + dz * fT;
#pragma unroll
  for (int it = 0; it < 2; ++it)
    tm_new = dnewton(tm_new, tm, fT, dz, A1 * (tm_new - tr1) + T(2) * tm_new / zp1,
                     A1 + T(2) / zp1);
  const DCoeffs<T> c0 = dcoeffs(tm, c), c1 = dcoeffs(tm_new, c);
  Dual<T> v, d, f_he, f_h;
  // He singlet channel, x_H frozen
  ddxhe(xHe, xe_tot, fhe, c0, r0, c, &f_he, &d);
  Dual<T> xHe_ode = xHe + dz * f_he;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    ddxhe(xHe_ode, xH + fhe * xHe_ode, fhe, c1, r1, c, &v, &d);
    xHe_ode = dnewton(xHe_ode, xHe, f_he, dz, v, d);
  }
  // H with the new x_He
  ddxh(xH, xe_tot, c0, r0, c, &f_h, &d);
  Dual<T> xH_ode = xH + dz * f_h;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    ddxh(xH_ode, xH_ode + fhe * xHe_ode, c1, r1, c, &v, &d);
    xH_ode = dnewton(xH_ode, xH, f_h, dz, v, d);
  }
  // regime selection
  const Dual<T> xhe_s = r1[ZT_XHESAHA], xh_s = r1[ZT_XHSAHA];
  *xHe_n = dclip01(sel(xhe_s.v > T(0.995), xhe_s, xHe_ode));
  *xH_n = dclip01(sel(xh_s.v > T(0.985), xh_s, xH_ode));
  *xe_n = sel(z.v > T(5500), r1[ZT_XEEARLY], *xH_n + fhe * *xHe_n);
  *tm_n = sel(z.v > T(3000), r1[ZT_TMHOT], tm_new);
}

// the seed of lane `dir` on input `me`
template <typename T>
__device__ __forceinline__ Dual<T> seed(T v, int dir, int me) {
  return {v, dir == me ? T(1) : T(0)};
}

constexpr int DIR_XH = 0, DIR_XHE = 1, DIR_TM = 2, DIR_R0 = 3, DIR_R1 = DIR_R0 + N_ZT,
              DIR_FHE = DIR_R1 + N_ZT;
static_assert(DIR_FHE < 32, "one input direction a lane");

template <typename T>
__global__ void __launch_bounds__(32)
recfast_bwd_kernel(const T* __restrict__ zt, const T* __restrict__ fhe_in,
                   const T* __restrict__ kc, const T* __restrict__ st,
                   const T* __restrict__ tm_in, const T* __restrict__ gxe,
                   const T* __restrict__ gtm, T* __restrict__ gzt, T* __restrict__ gfhe,
                   int C, int N) {
  const int ch = blockIdx.x, lane = threadIdx.x;
  if (ch >= C) return;
  Consts<T> c;
#pragma unroll
  for (int i = 0; i < N_K; ++i) c.k[i] = kc[i];
  const T* Z = zt + (size_t)ch * N_ZT * N;
  T* G = gzt + (size_t)ch * N_ZT * N;
  const T* sH = st + (size_t)ch * 2 * N;
  const T* sHe = sH + N;
  const T* tmr = tm_in + (size_t)ch * N;
  const T* gx = gxe + (size_t)ch * N;
  const T* gt = gtm + (size_t)ch * N;
  const T fhe = fhe_in[ch];

  // the first live node, as the forward kernel finds it
  int jlive = N;
  for (int j0 = 0; j0 < N && jlive == N; j0 += TILE) {
    const int j = j0 + lane;
    bool live = false;
    if (j < N)
      live = j > 0 && !(row(Z, N, ZT_Z, j) > T(3000) && row(Z, N, ZT_XHESAHA, j) > T(0.995) &&
                        row(Z, N, ZT_XHSAHA, j) > T(0.985));
    const unsigned m = __ballot_sync(FULL_WARP, live);
    if (m) jlive = j0 + __ffs(m) - 1;
  }

  // the walk back: (a0, a1, a2) the adjoint of (x_H, x_He, T_M) at node i + 1
  T a0 = T(0), a1 = T(0), a2 = T(0), pend = T(0), gf = T(0);
  const int i0 = jlive - 1;
  for (int i = N - 2; i >= i0 && jlive < N; --i) {
    const int j = i + 1;
    Dual<T> r0[N_ZT], r1[N_ZT];
#pragma unroll
    for (int f = 0; f < N_ZT; ++f) {
      r0[f] = seed(row(Z, N, f, i), lane, DIR_R0 + f);
      r1[f] = seed(row(Z, N, f, j), lane, DIR_R1 + f);
    }
    Dual<T> oH, oHe, oT, oX;
    dual_step(seed(sH[i], lane, DIR_XH), seed(sHe[i], lane, DIR_XHE), seed(tmr[i], lane, DIR_TM),
              r0, r1, seed(fhe, lane, DIR_FHE), c, &oH, &oHe, &oT, &oX);
    const T contrib = a0 * oH.d + a1 * oHe.d + (a2 + gt[j]) * oT.d + gx[j] * oX.d;
    a0 = __shfl_sync(FULL_WARP, contrib, DIR_XH);
    a1 = __shfl_sync(FULL_WARP, contrib, DIR_XHE);
    a2 = __shfl_sync(FULL_WARP, contrib, DIR_TM);
    // node j: its row's part as the step's r1 (from lane DIR_R1 + f) and as
    // the next step's r0 (held in pend since the last iteration)
    const T as_r1 = __shfl_down_sync(FULL_WARP, contrib, DIR_R1 - DIR_R0);
    if (lane >= DIR_R0 && lane < DIR_R1) G[(size_t)(lane - DIR_R0) * N + j] += pend + as_r1;
    pend = contrib;
    if (lane == DIR_FHE) gf += contrib;
  }
  if (jlive < N && lane >= DIR_R0 && lane < DIR_R1) G[(size_t)(lane - DIR_R0) * N + i0] += pend;
  __syncwarp();

  // the prefix: nodes before the first live one hold the table's state;
  // node i0 also carries the walk's adjoint of the state it started from
  for (int j = lane; j < min(jlive, N); j += 32) {
    const T gxj = gx[j];
    T gtmhot = gt[j] + (j == i0 ? a2 : T(0));
    if (j == 0) {
      gf += T(2) * gxj;
    } else {
      const T xhs = row(Z, N, ZT_XHSAHA, j), xhes = row(Z, N, ZT_XHESAHA, j);
      const bool early = row(Z, N, ZT_Z, j) > T(5500);
      const T gH = (early ? T(0) : gxj) + (j == i0 ? a0 : T(0));
      const T gHe = (early ? T(0) : gxj * fhe) + (j == i0 ? a1 : T(0));
      if (early) G[(size_t)ZT_XEEARLY * N + j] += gxj;
      else gf += gxj * xclamp(xhes, T(0), T(1));
      G[(size_t)ZT_XHSAHA * N + j] += gH * clip01_slope(xhs);
      G[(size_t)ZT_XHESAHA * N + j] += gHe * clip01_slope(xhes);
    }
    G[(size_t)ZT_TMHOT * N + j] += gtmhot;
  }
  // fHe: a fixed-order sum over the lanes
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) gf += __shfl_xor_sync(FULL_WARP, gf, o);
  if (lane == 0) gfhe[ch] = gf;
}

template <typename T>
int launch(const void* zt, const void* fhe, const void* kc,
           void* xe, void* tm, void* st, int C, int N, void* stream) {
  recfast_kernel<T><<<C, 32, 0, (cudaStream_t)stream>>>(
      (const T*)zt, (const T*)fhe, (const T*)kc, (T*)xe, (T*)tm, (T*)st,
      C, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* zt, const void* fhe, const void* kc, const void* st,
               const void* tm, const void* gxe, const void* gtm, void* gzt, void* gfhe,
               int C, int N, void* stream) {
  recfast_bwd_kernel<T><<<C, 32, 0, (cudaStream_t)stream>>>(
      (const T*)zt, (const T*)fhe, (const T*)kc, (const T*)st, (const T*)tm,
      (const T*)gxe, (const T*)gtm, (T*)gzt, (T*)gfhe, C, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int recfast_f32(const void* zt, const void* fhe, const void* kc, void* xe, void* tm, int C, int N,
                           void* stream) {
  return launch<float>(zt, fhe, kc, xe, tm, nullptr, C, N, stream);
}

extern "C" int recfast_f64(const void* zt, const void* fhe, const void* kc, void* xe, void* tm, int C, int N,
                           void* stream) {
  return launch<double>(zt, fhe, kc, xe, tm, nullptr, C, N, stream);
}

// the forward kernel that also stores x_H, x_He at every node: st (C, 2, N)
extern "C" int recfast_st_f32(const void* zt, const void* fhe, const void* kc, void* xe, void* tm,
                              void* st, int C, int N, void* stream) {
  return launch<float>(zt, fhe, kc, xe, tm, st, C, N, stream);
}

extern "C" int recfast_st_f64(const void* zt, const void* fhe, const void* kc, void* xe, void* tm,
                              void* st, int C, int N, void* stream) {
  return launch<double>(zt, fhe, kc, xe, tm, st, C, N, stream);
}

// the reverse kernel: gzt (C, 12, N) zeroed by the caller, gfhe (C,)
extern "C" int recfast_bwd_f32(const void* zt, const void* fhe, const void* kc, const void* st,
                               const void* tm, const void* gxe, const void* gtm, void* gzt,
                               void* gfhe, int C, int N, void* stream) {
  return launch_bwd<float>(zt, fhe, kc, st, tm, gxe, gtm, gzt, gfhe, C, N, stream);
}

extern "C" int recfast_bwd_f64(const void* zt, const void* fhe, const void* kc, const void* st,
                               const void* tm, const void* gxe, const void* gtm, void* gzt,
                               void* gfhe, int C, int N, void* stream) {
  return launch_bwd<double>(zt, fhe, kc, st, tm, gxe, gtm, gzt, gfhe, C, N, stream);
}
