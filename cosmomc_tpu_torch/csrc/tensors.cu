// K5: RK4 of the tensor-mode hierarchy (metric h, photon intensity and
// polarization, massless neutrinos; NVAR_T = 45).
//
// Replaces cosmomc_tpu/models/tensors.py:evolve_tensors (the lax.scan at
// tensors.py:254 over make_tensor_rhs.rhs and rk4_step). Every k-independent
// input of the RHS (opacity, photon and neutrino densities, conformal H, the
// tight-coupling flag, visibility, e^-kappa) comes precomputed per (chain,
// step, row) in `qtab` (models/tensors.py:_stage_table): rows 3s..3s+2 are the
// RK4 stage times of substep s, the last row is the step's end, where the
// sources are read.
//
// Bound on this card: operations (4 RHS evaluations of ~300 flops a step for
// each (chain, k) lane), but what limits a lane is the dependency chain of its
// 8191 steps. The design is csrc/perturbations.cu's (K1):
// - One warp owns one (chain, k) lane; a block is 8 warps of consecutive k
//   of one chain. h and h' are held and differentiated by every thread.
//   Thread l in 0..16 holds Dt_l and Dn_l (the same l, neighbours and
//   k/(2l+1)); threads 17..25 hold Dp_0..Dp_8; threads 26..31 hold zeros.
//   State, RK4 accumulator, stage state and stage derivative are 4 x 4
//   values a thread.
// - Neighbours come by __shfl_up_sync / __shfl_down_sync; Psi and the
//   anisotropic stress from broadcasts of Dt_{0,2,4}, Dp_{0,2,4} and
//   Dn_{0,2,4}. Each thread evaluates its forms (generic l, l = 0 with its
//   source, the closure) with per-thread constants and selects one: the
//   warp never diverges.
// - The switches depend on (k, row) only, so a warp decides them alike:
//   tight coupling comes from the row, the freeze (k tau >= 240) and the
//   release (k tau_b >= 0.05) are single products compared with a constant
//   (FMA contraction cannot move them). Within an evaluation they select,
//   with no branch (a branch there ends the basic block and serialises the
//   row loads, the shuffles and the arithmetic). One exact skip: a step
//   whose release test fails would discard its RK4 result (the lane is
//   reset to its initial state), so it is not integrated.
// - The qtab rows of the next tile of steps arrive in shared memory by
//   cp.async while the current tile is integrated (double buffer), and what
//   the RHS needs of a row but not of k (1/(3 opacity), the two closure
//   coefficients (l+1)/tau) is derived there once a block.
// - No divide in the RHS and the update: k/(2l+1) is taken once a thread,
//   /10, /7, /70, /5 are products with constant reciprocals, dt/6 a product
//   once a step. The products differ from the plain version's quotients in
//   the last bit only (PERF.md has the float32 accuracy beside the plain
//   version's).
// - The source evaluation at a step's tau_b (at the state the next step
//   starts from, after the release reset too) has the inputs of the next
//   step's first evaluation wherever the table's row for that tau_a equals
//   it field for field, which the block checks; there the next step takes
//   the derivative from registers: four evaluations a step, the same bits.
// - The three source planes of the block's 8 lanes are collected in shared
//   memory for a tile of steps and written as (plane, chain, step, 8
//   consecutive k): a whole 32-byte sector a store in float32.
//
// The arithmetic mirrors models/tensors.py:_tensor_rhs/_evolve_t_plain.
#include "common.cuh"

namespace {

constexpr int LMAXT = 16, LMAXTP = 8, LMAXTN = 16;
static_assert(LMAXTN == LMAXT, "Dt_l and Dn_l share a thread and a closure coefficient");
constexpr int LANE_DP = LMAXT + 1;   // the first Dp thread
static_assert(LANE_DP + LMAXTP < 32, "the three ladders fit one warp");
// fields of qtab (models/tensors.py QT_*), then the k-independent terms the
// block derives from them once per row
enum { Q_TAU, Q_OPAC, Q_GG, Q_GN, Q_ADOTOA, Q_TC, Q_VIS, Q_EXPMK, NQ,
       D_INV3OPAC = NQ, D_CLT, D_CLP, NQD = 12 };
static_assert(D_CLP < NQD, "the derived fields fit the padded row");
static_assert(NQD % 4 == 0, "rows are read as 16-byte vectors");
constexpr int NPLANE = 3;
constexpr int WARPS = 8;   // k lanes a block
// rows a shared-memory tile holds: 128 in float32, 64 in float64 (the same
// bytes); a tile is as many whole steps of 3 substeps + 1 rows as fit
template <typename T>
constexpr int TILE_ROWS = sizeof(T) == 4 ? 128 : 64;
template <typename T>
constexpr int MAX_TILE_STEPS = TILE_ROWS<T> / 4;
static_assert(MAX_TILE_STEPS<float> <= 32 && MAX_TILE_STEPS<double> <= 32,
              "a tile's steps fit a 32-bit mask");
constexpr double RSA_KTAU = 240.0, RELEASE_KTAU = 0.05;

// a thread's multipoles: slot 1 holds Dt_l (threads 0..16) or Dp_l (17..25),
// slot 2 Dn_l (threads 0..16)
template <typename T>
struct Ladder {
  T l, lp1, coef;
  bool first, pol, closure1, closure2, live1, live2;
};

template <typename T>
__device__ __forceinline__ Ladder<T> ladder_of(int lane, T k) {
  Ladder<T> m;
  const int l = lane < LANE_DP ? lane : lane - LANE_DP;
  m.l = T(l);
  m.lp1 = T(l + 1);
  m.coef = k / T(2 * l + 1);
  m.first = l == 0;
  m.pol = lane >= LANE_DP;
  m.closure1 = lane == LMAXT || lane == LANE_DP + LMAXTP;
  m.closure2 = lane == LMAXTN;
  m.live1 = lane <= LANE_DP + LMAXTP;
  m.live2 = lane <= LMAXTN;
  return m;
}

template <typename T>
struct State {
  T ht, htp, m1, m2;
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

// the k-independent terms of one row, in place
template <typename T>
__device__ __forceinline__ void derive_row(T* q) {
  const T tau_safe = xmax(q[Q_TAU], T(1e-10));
  q[D_INV3OPAC] = T(1) / (T(3) * xmax(q[Q_OPAC], T(1e-30)));
  q[D_CLT] = T(LMAXT + 1) / tau_safe;
  q[D_CLP] = T(LMAXTP + 1) / tau_safe;
}

// dy/dtau at one row, called by all 32 threads of a warp together; returns
// the source Psi (zero past the freeze). No branch: every form is evaluated
// and the switches select, so the row's loads, the shuffles and the
// arithmetic of one evaluation overlap.
template <typename T>
__device__ __forceinline__ T rhs(const State<T>& y, const T (&q)[NQD], T k, bool fb,
                                 const Ladder<T>& m, State<T>& dy) {
  const T opac = q[Q_OPAC];
  const bool rsa = k * q[Q_TAU] >= T(RSA_KTAU);
  const bool tc = q[Q_TC] > T(0.5);
  const T dt0 = __shfl_sync(FULL_WARP, y.m1, 0);
  const T dt2 = __shfl_sync(FULL_WARP, y.m1, 2);
  const T dt4 = __shfl_sync(FULL_WARP, y.m1, 4);
  const T dp0 = __shfl_sync(FULL_WARP, y.m1, LANE_DP);
  const T dp2 = __shfl_sync(FULL_WARP, y.m1, LANE_DP + 2);
  const T dp4 = __shfl_sync(FULL_WARP, y.m1, LANE_DP + 4);
  const T dn0 = __shfl_sync(FULL_WARP, y.m2, 0);
  const T dn2 = __shfl_sync(FULL_WARP, y.m2, 2);
  const T dn4 = __shfl_sync(FULL_WARP, y.m2, 4);
  const T up1 = __shfl_up_sync(FULL_WARP, y.m1, 1);
  const T next1 = __shfl_down_sync(FULL_WARP, y.m1, 1);
  const T up2 = __shfl_up_sync(FULL_WARP, y.m2, 1);
  const T next2 = __shfl_down_sync(FULL_WARP, y.m2, 1);

  const T pi_t = dt0 * T(0.1) + dt2 * T(1.0 / 7.0) + T(3.0 / 70.0) * dt4;
  const T psi_full = pi_t - T(0.6) * dp0 + T(6.0 / 7.0) * dp2 - T(3.0 / 70.0) * dp4;
  const T psi_tca = -y.htp * q[D_INV3OPAC];
  const T psi = tc ? psi_tca : psi_full;
  const T pi_n = dn0 * T(0.1) + dn2 * T(1.0 / 7.0) + T(3.0 / 70.0) * dn4;
  const T pi_g = tc ? T(0) : pi_t;
  const T stress = (fb && !rsa) ? T(16.0 / 3.0) * (q[Q_GG] * pi_g + q[Q_GN] * pi_n) : T(0);
  dy.ht = y.htp;
  dy.htp = -T(2) * q[Q_ADOTOA] * y.htp - k * k * y.ht + stress;

  // slot 1: Dt_l or Dp_l, damped by the opacity; frozen in tight coupling
  const T prev1 = m.first ? T(0) : up1;
  const T gen1 = m.coef * (m.l * prev1 - m.lp1 * next1) - opac * y.m1;
  const T src1 = m.pol ? -(opac * psi) : -y.htp + opac * psi;
  const T cl1 = m.pol ? q[D_CLP] : q[D_CLT];
  const T clo1 = k * prev1 - cl1 * y.m1 - opac * y.m1;
  const T v1 = m.closure1 ? clo1 : (m.first ? gen1 + src1 : gen1);
  dy.m1 = (tc || rsa || !m.live1) ? T(0) : v1;
  // slot 2: Dn_l, free streaming with the -h' source
  const T prev2 = m.first ? T(0) : up2;
  const T gen2 = m.coef * (m.l * prev2 - m.lp1 * next2);
  const T clo2 = k * prev2 - q[D_CLT] * y.m2;
  const T v2 = m.closure2 ? clo2 : (m.first ? gen2 + -y.htp : gen2);
  dy.m2 = (rsa || !m.live2) ? T(0) : v2;
  return rsa ? T(0) : psi;
}

// the raw rows of steps [t TS, (t + 1) TS) into one buffer, spread over the block
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* Qc, int S, int R, int TS, int t) {
  const int s0 = t * TS, n = min(TS, S - s0) * R * NQ;
  const T* src = Qc + (size_t)s0 * R * NQ;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    cp_async(buf + (e / NQ) * NQD + e % NQ, src + e);
  cp_async_commit();
}

// The derived fields of a tile's rows, and for each of its steps whether its
// first row equals the last row of the step before (`prev_last`: that row of
// the previous tile, or null) field for field. Then the step's first RHS
// evaluation has the inputs of the previous step's source evaluation.
// models/tensors.py:_stage_table makes such rows: tau_a + 0 (tau_b - tau_a)
// of a step is tau_b of the step before, and each field is a function of tau.
template <typename T>
__device__ __forceinline__ void derive_rows(T* buf, int S, int R, int TS, int t,
                                            const T* prev_last, bool* same) {
  const int ns = min(TS, S - t * TS);
  for (int e = threadIdx.x; e < ns * R; e += blockDim.x) derive_row(buf + e * NQD);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const T* a = buf + s * R * NQD;
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
__device__ __forceinline__ void axpy(State<T>& out, const State<T>& y, T h, const State<T>& d) {
  out.ht = y.ht + h * d.ht;
  out.htp = y.htp + h * d.htp;
  out.m1 = y.m1 + h * d.m1;
  out.m2 = y.m2 + h * d.m2;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
tensor_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
              T* __restrict__ out, int C, int S, int nk, int substeps, int feedback) {
  constexpr int MTS = MAX_TILE_STEPS<T>;
  __shared__ __align__(16) T rows[2][TILE_ROWS<T> * NQD];
  __shared__ T staged[MTS][NPLANE][WARPS];
  __shared__ bool same[2][MTS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.y, k0 = blockIdx.x * WARPS;
  // a warp past the last k repeats it, so that it keeps the block's barriers
  const T k = kvec[min(k0 + w, nk - 1)];
  const int R = 3 * substeps + 1;
  const int TS = TILE_ROWS<T> / R;
  const T* Qc = qtab + (size_t)c * S * R * NQ;
  const bool fb = feedback != 0;
  const Ladder<T> m = ladder_of(lane, k);
  const int ntiles = (S + TS - 1) / TS;

  stage_rows(rows[0], Qc, S, R, TS, 0);
  cp_async_wait<0>();
  __syncthreads();
  derive_rows(rows[0], S, R, TS, 0, (const T*)nullptr, same[0]);
  __syncthreads();

  State<T> y = {T(1), T(0), T(0), T(0)}, acc, yt, kd;
  const State<T> y0 = y;
  for (int t = 0; t < ntiles; ++t) {
    const T* buf = rows[t & 1];
    if (t + 1 < ntiles) stage_rows(rows[(t + 1) & 1], Qc, S, R, TS, t + 1);
    const int ns = min(TS, S - t * TS);
    // the tile's per-step decisions as bits in registers, so no step waits
    // on a shared-memory load before it branches: whether the first RHS
    // evaluation is the step before's last, and whether the lane is
    // released at tau_b (a step that is not would discard its RK4 result)
    unsigned reuse = 0, released = 0;
    for (int s = 0; s < ns; ++s) {
      reuse |= (unsigned)same[t & 1][s] << s;
      released |= (unsigned)(k * buf[(s * R + R - 1) * NQD + Q_TAU] >= T(RELEASE_KTAU)) << s;
    }
    for (int s = 0; s < ns; ++s) {
      const T* Qs = buf + s * R * NQD;
      T qf[NQD];
      load_row(Qs + (R - 1) * NQD, qf);
      if ((released >> s) & 1u) {
        for (int sub = 0; sub < substeps; ++sub) {
          T qa[NQD], qm[NQD], qb[NQD];
          load_row(Qs + (3 * sub + 0) * NQD, qa);
          load_row(Qs + (3 * sub + 1) * NQD, qm);
          load_row(Qs + (3 * sub + 2) * NQD, qb);
          // unless kd already holds this evaluation (the step before's last)
          if (sub > 0 || !((reuse >> s) & 1u)) rhs(y, qa, k, fb, m, kd);
          const T dt = qb[Q_TAU] - qa[Q_TAU];
          const T h2 = T(0.5) * dt;
          acc = kd;
          axpy(yt, y, h2, kd);
          rhs(yt, qm, k, fb, m, kd);
          acc.ht = acc.ht + T(2) * kd.ht, acc.htp = acc.htp + T(2) * kd.htp;
          acc.m1 = acc.m1 + T(2) * kd.m1, acc.m2 = acc.m2 + T(2) * kd.m2;
          axpy(yt, y, h2, kd);
          rhs(yt, qm, k, fb, m, kd);
          acc.ht = acc.ht + T(2) * kd.ht, acc.htp = acc.htp + T(2) * kd.htp;
          acc.m1 = acc.m1 + T(2) * kd.m1, acc.m2 = acc.m2 + T(2) * kd.m2;
          axpy(yt, y, dt, kd);
          rhs(yt, qb, k, fb, m, kd);
          const T h6 = dt * T(1.0 / 6.0);
          y.ht = y.ht + h6 * (acc.ht + kd.ht);
          y.htp = y.htp + h6 * (acc.htp + kd.htp);
          y.m1 = y.m1 + h6 * (acc.m1 + kd.m1);
          y.m2 = y.m2 + h6 * (acc.m2 + kd.m2);
        }
      } else {
        y = y0;
      }
      const T psi = rhs(y, qf, k, fb, m, kd);
      // every thread stores (no branch): lane 0 sT, lane 1 sP, the rest h,
      // which every thread holds alike
      const T sT = -y.htp * qf[Q_EXPMK] + qf[Q_VIS] * psi, sP = qf[Q_VIS] * psi;
      staged[s][min(lane, 2)][w] = lane == 0 ? sT : (lane == 1 ? sP : y.ht);
    }
    cp_async_wait<0>();
    __syncthreads();   // the next rows have landed; this tile's sources are staged
    for (int e = threadIdx.x; e < ns * NPLANE * WARPS; e += blockDim.x) {
      const int kw = e % WARPS, p = (e / WARPS) % NPLANE, s = e / (WARPS * NPLANE);
      if (k0 + kw < nk)
        out[(((size_t)p * C + c) * S + (t * TS + s)) * nk + k0 + kw] = staged[s][p][kw];
    }
    if (t + 1 < ntiles)
      derive_rows(rows[(t + 1) & 1], S, R, TS, t + 1, buf + ((TS - 1) * R + R - 1) * NQD,
                  same[(t + 1) & 1]);
    __syncthreads();   // the derived fields are written; `staged` is free
  }
}

template <typename T>
int launch(const void* qtab, const void* kvec, void* out, int C, int S, int nk,
           int substeps, int feedback, void* stream) {
  if (substeps < 1 || 3 * substeps + 1 > TILE_ROWS<T>) return (int)cudaErrorInvalidValue;
  dim3 grid((nk + WARPS - 1) / WARPS, C);
  tensor_kernel<T><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)qtab, (const T*)kvec, (T*)out, C, S, nk, substeps, feedback);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tensors_f32(const void* qtab, const void* kvec, void* out, int C,
                           int S, int nk, int substeps, int feedback, void* stream) {
  return launch<float>(qtab, kvec, out, C, S, nk, substeps, feedback, stream);
}

extern "C" int tensors_f64(const void* qtab, const void* kvec, void* out, int C,
                           int S, int nk, int substeps, int feedback, void* stream) {
  return launch<double>(qtab, kvec, out, C, S, nk, substeps, feedback, stream);
}
