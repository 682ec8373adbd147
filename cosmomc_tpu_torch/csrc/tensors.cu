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
//
// The same file holds the reverse pass (tensors_bwd, the reverse of JAX's
// scan under jax.grad) and the forward entry that stores its checkpoints
// (tensors_ck); its design is set out above tensor_bwd_kernel.
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
// the plain layout of a lane's state (models/tensors.py _I_*): h, h',
// Dt_0..16, Dp_0..8, Dn_0..16; thread l's slot 1 lands at 2 + l, its slot 2
// at I_DN0 + l
constexpr int I_DN0 = 2 + LANE_DP + LMAXTP + 1, NVAR = I_DN0 + LMAXTN + 1;
static_assert(NVAR == 45, "models/tensors.py NVAR_T");

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

// a lane's state to / from the plain layout (p: NVAR values); all 32
// threads call it. A load after a store by the same warp needs __syncwarp
template <typename T>
__device__ __forceinline__ void store_state(T* p, const State<T>& y, int lane) {
  if (lane == 0) p[0] = y.ht, p[1] = y.htp;
  if (lane <= LANE_DP + LMAXTP) p[2 + lane] = y.m1;
  if (lane <= LMAXTN) p[I_DN0 + lane] = y.m2;
}
template <typename T>
__device__ __forceinline__ State<T> load_state(const T* p, int lane) {
  State<T> y;
  y.ht = p[0];
  y.htp = p[1];
  y.m1 = lane <= LANE_DP + LMAXTP ? p[2 + lane] : T(0);
  y.m2 = lane <= LMAXTN ? p[I_DN0 + lane] : T(0);
  return y;
}

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

// CK: the instantiation that also stores the reverse pass's checkpoints
// (tensors_ck); the other compiles without them
template <typename T, bool CK>
__global__ void __launch_bounds__(WARPS * 32)
tensor_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
              T* __restrict__ out, T* __restrict__ ck, int C, int S, int nk, int substeps,
              int feedback, int chunk) {
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
  // the checkpoints of the reverse pass (tensors_ck): the lane's state
  // before every chunk-th step and after the last, (C, nk, nch + 1, NVAR)
  const int nch = CK ? (S + chunk - 1) / chunk : 0;
  T* ck_lane = CK && k0 + w < nk ? ck + ((size_t)c * nk + k0 + w) * (nch + 1) * NVAR : nullptr;
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
      if (CK && ck_lane && (t * TS + s) % chunk == 0)
        store_state(ck_lane + (size_t)((t * TS + s) / chunk) * NVAR, y, lane);
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
  if (CK && ck_lane) store_state(ck_lane + (size_t)nch * NVAR, y, lane);
}

template <typename T>
int launch(const void* qtab, const void* kvec, void* out, void* ck, int C, int S, int nk,
           int substeps, int feedback, int chunk, void* stream) {
  if (substeps < 1 || 3 * substeps + 1 > TILE_ROWS<T> || (ck && chunk < 1))
    return (int)cudaErrorInvalidValue;
  dim3 grid((nk + WARPS - 1) / WARPS, C);
  if (ck)
    tensor_kernel<T, true><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const T*)qtab, (const T*)kvec, (T*)out, (T*)ck, C, S, nk, substeps, feedback, chunk);
  else
    tensor_kernel<T, false><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const T*)qtab, (const T*)kvec, (T*)out, nullptr, C, S, nk, substeps, feedback, 0);
  return (int)cudaGetLastError();
}


// ===========================================================================
// The reverse pass (tensors_bwd): the cotangent of qtab (C, S, R, NQ) from
// those of the three planes (3, C, S, nk), as autograd of
// models/tensors.py:_evolve_t_plain gives it (jax.grad over JAX's scan).
//
// The forward's layout carries over: a warp owns a (chain, k) lane, h and h'
// and their adjoints on every thread, the adjoints of Dt_l and Dn_l on thread
// l and of Dp_l on thread 17 + l. The RHS is linear in the ladders, so its
// transpose moves each neighbour's term back by the opposite shuffle (a
// thread's cotangent of its `prev` goes to the thread below by
// __shfl_down_sync, of its `next` to the thread above by __shfl_up_sync);
// the broadcasts of Dt_{0,2,4}, Dp_{0,2,4}, Dn_{0,2,4} into Psi and the
// stress become per-thread coefficients of warp-uniform cotangents; the
// terms that gather over the lane's 45 variables (the opacity's, dt's) are
// warp sums (a fixed butterfly).
//
// The masks pass no cotangent: tight coupling, the freeze at k tau >= 240,
// the release at k tau_b >= 0.05 (a held lane is reset to its initial
// state, so the cotangent of the state before such a step is 0);
// max(tau, 1e-10) and max(opac, 1e-30) pass it at and above their bounds,
// as torch.clamp does. QT_TC is a flag and gets none; vis and e^-kappa are
// read at the step's last row only.
//
// Checkpoints: the forward (tensors_ck) stores the state before every
// chunk-th step. Per chunk, in reverse, the warp recomputes the chunk's
// states forward into its scratch (global, L2-resident: 128 steps x 45
// values a lane at the main path's 64 chunks), then walks the steps
// backward: the planes' vjp at the step's end state, then each substep's
// RK4 recomputed from its stored start and transposed stage by stage.
//
// The cotangent of a qtab row sums over the chain's k lanes: each warp's
// (uniform) row cotangents go to a shared-memory tile of steps, the block
// adds its 8 warps in order into a partial row of its own (g_q, (C, nblk,
// S, R, NQ)), and the wrapper adds the blocks in order (a torch sum): no
// atomics, repeated runs agree bit for bit.
//
// Bound: operations, reverse mode costing at least 3x the forward's (the
// forward's arithmetic again and twice it for the adjoint); in practice,
// as the forward, the dependency chain of a lane's steps: per step the
// chunk's recomputation (4 RHS), the step's stages again (4 RHS), 5
// transposed RHS and the warp sums.
// ===========================================================================

template <typename T>
struct RowG {
  T tau, opac, gg, gn, adotoa;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o);
  return v;
}

// one row of qtab from global memory, with the fields derive_row adds
template <typename T>
__device__ __forceinline__ void fetch_row(const T* q, T (&r)[NQD]) {
#pragma unroll
  for (int f = 0; f < NQ; ++f) r[f] = q[f];
  derive_row(r);
}

// the coefficients of thread `lane`'s slot 1 (Dt_{0,2,4}: cT; Dp_{0,2,4}: cP)
// and slot 2 (Dn_{0,2,4}: cT) in Psi, pi_g and pi_n
template <typename T>
__device__ __forceinline__ T coef_t(int lane) {
  return lane == 0 ? T(0.1) : (lane == 2 ? T(1.0 / 7.0) : (lane == 4 ? T(3.0 / 70.0) : T(0)));
}
template <typename T>
__device__ __forceinline__ T coef_p(int lane) {
  return lane == LANE_DP ? -T(0.6)
                         : (lane == LANE_DP + 2 ? T(6.0 / 7.0)
                                                : (lane == LANE_DP + 4 ? -T(3.0 / 70.0) : T(0)));
}

// The transpose of rhs at (y, q): adds to gy the cotangent of y and to gq
// that of the row, from g (the cotangent of dy; g.ht and g.htp uniform) and
// gpsi (of the returned Psi, uniform). Returns rhs's Psi. Called by all 32
// threads together; what it adds is uniform but for gy.m1 and gy.m2.
template <typename T>
__device__ __forceinline__ T rhs_vjp(const State<T>& y, const T (&q)[NQD], T k, bool fb,
                                     const Ladder<T>& m, int lane, const State<T>& g, T gpsi,
                                     State<T>& gy, RowG<T>& gq) {
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
  const T pi_t = dt0 * T(0.1) + dt2 * T(1.0 / 7.0) + T(3.0 / 70.0) * dt4;
  const T psi_full = pi_t - T(0.6) * dp0 + T(6.0 / 7.0) * dp2 - T(3.0 / 70.0) * dp4;
  const T psi = tc ? -y.htp * q[D_INV3OPAC] : psi_full;
  const T pi_n = dn0 * T(0.1) + dn2 * T(1.0 / 7.0) + T(3.0 / 70.0) * dn4;
  const T pi_g = tc ? T(0) : pi_t;

  // this thread's slots: the cotangents of v1, v2 where they are not masked
  const T e1 = (tc || rsa || !m.live1) ? T(0) : g.m1;
  const T e2 = (rsa || !m.live2) ? T(0) : g.m2;
  const T cl1 = m.pol ? q[D_CLP] : q[D_CLT];
  // slot 1: closure k prev - cl m - opac m; else coef (l prev - (l+1) next)
  // - opac m (+ the source on l = 0: -opac Psi for Dp, -h' + opac Psi for Dt)
  T gm1 = m.closure1 ? -e1 * (cl1 + opac) : -e1 * opac;
  const T gprev1 = m.first ? T(0) : (m.closure1 ? e1 * k : e1 * (m.coef * m.l));
  const T gnext1 = m.closure1 ? T(0) : -e1 * (m.coef * m.lp1);
  const bool src1 = m.first && !m.closure1;
  T gop = -e1 * y.m1 + (src1 ? (m.pol ? -e1 * psi : e1 * psi) : T(0));
  const T gpsi_l = src1 ? (m.pol ? -e1 * opac : e1 * opac) : T(0);
  T ghtp_l = (src1 && !m.pol) ? -e1 : T(0);
  // the closure coefficients (LMAXT + 1) / tau (threads 16: Dt, Dn) and
  // (LMAXTP + 1) / tau (thread 25: Dp)
  T gcl = m.closure1 ? -e1 * y.m1 : T(0);
  // slot 2: closure k prev - CLT m; else coef (l prev - (l+1) next) (- h' on l = 0)
  T gm2 = m.closure2 ? -e2 * q[D_CLT] : T(0);
  const T gprev2 = m.first ? T(0) : (m.closure2 ? e2 * k : e2 * (m.coef * m.l));
  const T gnext2 = m.closure2 ? T(0) : -e2 * (m.coef * m.lp1);
  if (m.closure2) gcl += -e2 * y.m2;
  if (m.first && !m.closure2) ghtp_l += -e2;

  // the neighbours' terms, moved back the other way
  const T from_above1 = __shfl_down_sync(FULL_WARP, gprev1, 1);
  const T from_below1 = __shfl_up_sync(FULL_WARP, gnext1, 1);
  const T from_above2 = __shfl_down_sync(FULL_WARP, gprev2, 1);
  const T from_below2 = __shfl_up_sync(FULL_WARP, gnext2, 1);
  gm1 += (lane < 31 ? from_above1 : T(0)) + (lane > 0 ? from_below1 : T(0));
  gm2 += (lane < 31 ? from_above2 : T(0)) + (lane > 0 ? from_below2 : T(0));

  // the uniform cotangents
  T G_psi = (rsa ? T(0) : gpsi) + __shfl_sync(FULL_WARP, gpsi_l, 0) +
            __shfl_sync(FULL_WARP, gpsi_l, LANE_DP);
  T ghtp = g.ht - T(2) * q[Q_ADOTOA] * g.htp + __shfl_sync(FULL_WARP, ghtp_l, 0);
  const T ght = -k * k * g.htp;
  const T G_clt = __shfl_sync(FULL_WARP, gcl, LMAXT);
  const T G_clp = __shfl_sync(FULL_WARP, gcl, LANE_DP + LMAXTP);
  T G_op = warp_sum(gop);
  const bool sw = fb && !rsa;
  const T G_pig = sw ? T(16.0 / 3.0) * q[Q_GG] * g.htp : T(0);
  const T G_pin = sw ? T(16.0 / 3.0) * q[Q_GN] * g.htp : T(0);
  gq.gg += sw ? T(16.0 / 3.0) * pi_g * g.htp : T(0);
  gq.gn += sw ? T(16.0 / 3.0) * pi_n * g.htp : T(0);
  gq.adotoa += -T(2) * y.htp * g.htp;
  T G_psf = G_psi, G_inv3 = T(0);
  if (tc) {
    ghtp += -G_psi * q[D_INV3OPAC];
    G_inv3 = -G_psi * y.htp;
    G_psf = T(0);
  }
  const T G_pit = tc ? T(0) : G_pig;
  gm1 += coef_t<T>(lane) * (G_psf + G_pit) + coef_p<T>(lane) * G_psf;
  gm2 += coef_t<T>(lane) * G_pin;
  if (opac >= T(1e-30)) G_op += G_inv3 * (-T(3) * q[D_INV3OPAC] * q[D_INV3OPAC]);
  const T tau = q[Q_TAU];
  gq.opac += G_op;
  if (tau >= T(1e-10)) gq.tau += -(G_clt * q[D_CLT] + G_clp * q[D_CLP]) / tau;
  gy.ht += ght;
  gy.htp += ghtp;
  gy.m1 += gm1;
  gy.m2 += gm2;
  return rsa ? T(0) : psi;
}

// the lane-wide dot product of two states (h, h' counted once)
template <typename T>
__device__ __forceinline__ T dot_local(const State<T>& a, const State<T>& b, int lane) {
  return (lane == 0 ? a.ht * b.ht + a.htp * b.htp : T(0)) + a.m1 * b.m1 + a.m2 * b.m2;
}

// one RK4 substep over the rows qa, qm, qb, as tensor_kernel takes it
template <typename T>
__device__ __forceinline__ void rk4(State<T>& y, const T (&qa)[NQD], const T (&qm)[NQD],
                                   const T (&qb)[NQD], T k, bool fb, const Ladder<T>& m) {
  State<T> kd, acc, yt;
  rhs(y, qa, k, fb, m, kd);
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

// the transpose of rk4 from y: lam, the cotangent of the substep's end
// state, becomes that of its start; the rows' cotangents add to ga, gm, gb
template <typename T>
__device__ __forceinline__ void rk4_vjp(const State<T>& y, const T (&qa)[NQD],
                                       const T (&qm)[NQD], const T (&qb)[NQD], T k, bool fb,
                                       const Ladder<T>& m, int lane, State<T>& lam,
                                       RowG<T>& ga, RowG<T>& gm, RowG<T>& gb) {
  const T dt = qb[Q_TAU] - qa[Q_TAU];
  const T h2 = T(0.5) * dt, h6 = dt * T(1.0 / 6.0);
  State<T> k1, k2, k3, k4, y2, y3, y4;
  rhs(y, qa, k, fb, m, k1);
  axpy(y2, y, h2, k1);
  rhs(y2, qm, k, fb, m, k2);
  axpy(y3, y, h2, k2);
  rhs(y3, qm, k, fb, m, k3);
  axpy(y4, y, dt, k3);
  rhs(y4, qb, k, fb, m, k4);
  State<T> ks;
  ks.ht = k1.ht + T(2) * k2.ht + T(2) * k3.ht + k4.ht;
  ks.htp = k1.htp + T(2) * k2.htp + T(2) * k3.htp + k4.htp;
  ks.m1 = k1.m1 + T(2) * k2.m1 + T(2) * k3.m1 + k4.m1;
  ks.m2 = k1.m2 + T(2) * k2.m2 + T(2) * k3.m2 + k4.m2;
  T gdt = dot_local(lam, ks, lane) * T(1.0 / 6.0);  // through h6
  State<T> gk, gs, gy = lam;
  // k4 = f(y + dt k3, qb)
  axpy(gk, State<T>{T(0), T(0), T(0), T(0)}, h6, lam);
  gs = State<T>{T(0), T(0), T(0), T(0)};
  rhs_vjp(y4, qb, k, fb, m, lane, gk, T(0), gs, gb);
  gdt += dot_local(gs, k3, lane);
  gy.ht += gs.ht, gy.htp += gs.htp, gy.m1 += gs.m1, gy.m2 += gs.m2;
  // k3 = f(y + h2 k2, qm): its cotangent 2 h6 lam + dt gs
  gk.ht = T(2) * h6 * lam.ht + dt * gs.ht, gk.htp = T(2) * h6 * lam.htp + dt * gs.htp;
  gk.m1 = T(2) * h6 * lam.m1 + dt * gs.m1, gk.m2 = T(2) * h6 * lam.m2 + dt * gs.m2;
  gs = State<T>{T(0), T(0), T(0), T(0)};
  rhs_vjp(y3, qm, k, fb, m, lane, gk, T(0), gs, gm);
  gdt += T(0.5) * dot_local(gs, k2, lane);
  gy.ht += gs.ht, gy.htp += gs.htp, gy.m1 += gs.m1, gy.m2 += gs.m2;
  // k2 = f(y + h2 k1, qm): 2 h6 lam + h2 gs
  gk.ht = T(2) * h6 * lam.ht + h2 * gs.ht, gk.htp = T(2) * h6 * lam.htp + h2 * gs.htp;
  gk.m1 = T(2) * h6 * lam.m1 + h2 * gs.m1, gk.m2 = T(2) * h6 * lam.m2 + h2 * gs.m2;
  gs = State<T>{T(0), T(0), T(0), T(0)};
  rhs_vjp(y2, qm, k, fb, m, lane, gk, T(0), gs, gm);
  gdt += T(0.5) * dot_local(gs, k1, lane);
  gy.ht += gs.ht, gy.htp += gs.htp, gy.m1 += gs.m1, gy.m2 += gs.m2;
  // k1 = f(y, qa): h6 lam + h2 gs
  gk.ht = h6 * lam.ht + h2 * gs.ht, gk.htp = h6 * lam.htp + h2 * gs.htp;
  gk.m1 = h6 * lam.m1 + h2 * gs.m1, gk.m2 = h6 * lam.m2 + h2 * gs.m2;
  rhs_vjp(y, qa, k, fb, m, lane, gk, T(0), gy, ga);
  gdt = warp_sum(gdt);
  ga.tau -= gdt;
  gb.tau += gdt;
  lam = gy;
}

// steps a reverse block's shared-memory tile of row cotangents holds
template <typename T>
__host__ __device__ constexpr int bwd_tile_steps(int R) {
  return (32768 / (R * NQ * WARPS * (int)sizeof(T))) > 0
             ? 32768 / (R * NQ * WARPS * (int)sizeof(T))
             : 1;
}

// lane 0 of warp w puts row r's cotangents of tile step `slot`
template <typename T>
__device__ __forceinline__ void put_row(T* tile, int slot, int R, int r, int w, const RowG<T>& g,
                                        T vis, T expmk) {
  T* p = tile + ((size_t)(slot * R + r) * NQ) * WARPS + w;
  p[Q_TAU * WARPS] = g.tau;
  p[Q_OPAC * WARPS] = g.opac;
  p[Q_GG * WARPS] = g.gg;
  p[Q_GN * WARPS] = g.gn;
  p[Q_ADOTOA * WARPS] = g.adotoa;
  p[Q_TC * WARPS] = T(0);
  p[Q_VIS * WARPS] = vis;
  p[Q_EXPMK * WARPS] = expmk;
}

// the block's share of the tile's steps [top - n, top): its valid warps
// added in order
template <typename T>
__device__ __forceinline__ void flush_tile(const T* tile, T* gq_blk, int n, int top, int R,
                                           int nvalid) {
  __syncthreads();
  for (int e = threadIdx.x; e < n * R * NQ; e += blockDim.x) {
    const int slot = e / (R * NQ), rf = e % (R * NQ);
    const T* p = tile + ((size_t)slot * R * NQ + rf) * WARPS;
    T acc = p[0];
    for (int w = 1; w < nvalid; ++w) acc += p[w];
    gq_blk[(size_t)(top - 1 - slot) * R * NQ + rf] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
tensor_bwd_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
                  const T* __restrict__ ck, const T* __restrict__ gout, T* __restrict__ scratch,
                  T* __restrict__ gq, int C, int S, int nk, int substeps, int feedback,
                  int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);  // [TSB][R][NQ][WARPS]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, k0 = blk * WARPS;
  const int kidx = min(k0 + w, nk - 1);  // a warp past the last k repeats it
  const int nvalid = min(WARPS, nk - k0);
  const T k = kvec[kidx];
  const int R = 3 * substeps + 1;
  const int TSB = bwd_tile_steps<T>(R);
  const bool fb = feedback != 0;
  const Ladder<T> m = ladder_of(lane, k);
  const T* Qc = qtab + (size_t)c * S * R * NQ;
  const int nch = (S + chunk - 1) / chunk;
  const int nrec = chunk * substeps + 1;  // states a lane's scratch holds
  T* scr = scratch + ((size_t)c * nblk * WARPS + k0 + w) * nrec * NVAR;
  const T* ckl = ck + ((size_t)c * nk + kidx) * (nch + 1) * NVAR;
  T* gq_blk = gq + ((size_t)c * nblk + blk) * S * R * NQ;
  const size_t plane = (size_t)C * S * nk;
  const State<T> y0 = {T(1), T(0), T(0), T(0)};
  const RowG<T> zero_row = {T(0), T(0), T(0), T(0), T(0)};
  const State<T> zero_state = {T(0), T(0), T(0), T(0)};

  State<T> lam = zero_state;
  int tile_n = 0, tile_top = S;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int s_lo = ch * chunk, s_hi = min(S, s_lo + chunk);
    // the chunk's states, forward from its checkpoint
    State<T> y = load_state(ckl + (size_t)ch * NVAR, lane);
    for (int j = s_lo; j < s_hi; ++j) {
      const T* Qs = Qc + (size_t)j * R * NQ;
      if (k * Qs[(R - 1) * NQ + Q_TAU] >= T(RELEASE_KTAU)) {
        for (int sub = 0; sub < substeps; ++sub) {
          store_state(scr + (size_t)((j - s_lo) * substeps + sub) * NVAR, y, lane);
          T qa[NQD], qm[NQD], qb[NQD];
          fetch_row(Qs + (3 * sub) * NQ, qa);
          fetch_row(Qs + (3 * sub + 1) * NQ, qm);
          fetch_row(Qs + (3 * sub + 2) * NQ, qb);
          rk4(y, qa, qm, qb, k, fb, m);
        }
      } else {
        store_state(scr + (size_t)((j - s_lo) * substeps) * NVAR, y, lane);
        y = y0;
      }
    }
    store_state(scr + (size_t)((s_hi - s_lo) * substeps) * NVAR, y, lane);
    __syncwarp();
    // the chunk's steps, backward
    for (int j = s_hi - 1; j >= s_lo; --j) {
      const T* Qs = Qc + (size_t)j * R * NQ;
      const int slot = tile_n;
      // the planes at the step's end state: sT = -h' e^-kappa + vis Psi,
      // sP = vis Psi, h
      T qf[NQD];
      fetch_row(Qs + (R - 1) * NQ, qf);
      const State<T> ye = load_state(scr + (size_t)((j + 1 - s_lo) * substeps) * NVAR, lane);
      const size_t o = ((size_t)c * S + j) * nk + kidx;
      const T gsT = gout[o], gsP = gout[plane + o], ght = gout[2 * plane + o];
      lam.ht += ght;
      lam.htp += -qf[Q_EXPMK] * gsT;
      RowG<T> gf = zero_row;
      const T psi = rhs_vjp(ye, qf, k, fb, m, lane, zero_state, qf[Q_VIS] * (gsT + gsP), lam, gf);
      if (lane == 0) put_row(tile, slot, R, R - 1, w, gf, psi * (gsT + gsP), -ye.htp * gsT);
      if (k * qf[Q_TAU] >= T(RELEASE_KTAU)) {
        for (int sub = substeps - 1; sub >= 0; --sub) {
          const State<T> ys = load_state(scr + (size_t)((j - s_lo) * substeps + sub) * NVAR,
                                         lane);
          T qa[NQD], qm[NQD], qb[NQD];
          fetch_row(Qs + (3 * sub) * NQ, qa);
          fetch_row(Qs + (3 * sub + 1) * NQ, qm);
          fetch_row(Qs + (3 * sub + 2) * NQ, qb);
          RowG<T> ga = zero_row, gm = zero_row, gb = zero_row;
          rk4_vjp(ys, qa, qm, qb, k, fb, m, lane, lam, ga, gm, gb);
          if (lane == 0) {
            put_row(tile, slot, R, 3 * sub, w, ga, T(0), T(0));
            put_row(tile, slot, R, 3 * sub + 1, w, gm, T(0), T(0));
            put_row(tile, slot, R, 3 * sub + 2, w, gb, T(0), T(0));
          }
        }
      } else {
        // held: the state before the step does not reach its end
        lam = zero_state;
        if (lane == 0)
          for (int r = 0; r < R - 1; ++r) put_row(tile, slot, R, r, w, zero_row, T(0), T(0));
      }
      if (++tile_n == TSB) {
        flush_tile(tile, gq_blk, tile_n, tile_top, R, nvalid);
        tile_top -= tile_n;
        tile_n = 0;
      }
    }
    __syncwarp();  // the scratch is rewritten by the next chunk
  }
  if (tile_n > 0) flush_tile(tile, gq_blk, tile_n, tile_top, R, nvalid);
}

template <typename T>
int launch_bwd(const void* qtab, const void* kvec, const void* ck, const void* g_out,
               void* scratch, void* g_q, int C, int S, int nk, int substeps, int feedback,
               int chunk, void* stream) {
  if (substeps < 1 || chunk < 1 || C < 1 || S < 1 || nk < 1) return (int)cudaErrorInvalidValue;
  const int R = 3 * substeps + 1;
  const size_t smem = (size_t)bwd_tile_steps<T>(R) * R * NQ * WARPS * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(tensor_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nk + WARPS - 1) / WARPS, C);
  tensor_bwd_kernel<T><<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const T*)qtab, (const T*)kvec, (const T*)ck, (const T*)g_out, (T*)scratch, (T*)g_q, C,
      S, nk, substeps, feedback, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tensors_f32(const void* qtab, const void* kvec, void* out, int C,
                           int S, int nk, int substeps, int feedback, void* stream) {
  return launch<float>(qtab, kvec, out, nullptr, C, S, nk, substeps, feedback, 0, stream);
}

extern "C" int tensors_f64(const void* qtab, const void* kvec, void* out, int C,
                           int S, int nk, int substeps, int feedback, void* stream) {
  return launch<double>(qtab, kvec, out, nullptr, C, S, nk, substeps, feedback, 0, stream);
}

// the forward with the reverse pass's checkpoints ck (C, nk, ceil(S / chunk) + 1,
// NVAR): the state before every chunk-th step and after the last
extern "C" int tensors_ck_f32(const void* qtab, const void* kvec, void* out, void* ck,
                              int C, int S, int nk, int substeps, int feedback, int chunk,
                              void* stream) {
  return launch<float>(qtab, kvec, out, ck, C, S, nk, substeps, feedback, chunk, stream);
}

extern "C" int tensors_ck_f64(const void* qtab, const void* kvec, void* out, void* ck,
                              int C, int S, int nk, int substeps, int feedback, int chunk,
                              void* stream) {
  return launch<double>(qtab, kvec, out, ck, C, S, nk, substeps, feedback, chunk, stream);
}

extern "C" int tensors_bwd_f32(const void* qtab, const void* kvec, const void* ck,
                               const void* g_out, void* scratch, void* g_q, int C, int S,
                               int nk, int substeps, int feedback, int chunk, void* stream) {
  return launch_bwd<float>(qtab, kvec, ck, g_out, scratch, g_q, C, S, nk, substeps, feedback,
                           chunk, stream);
}

extern "C" int tensors_bwd_f64(const void* qtab, const void* kvec, const void* ck,
                               const void* g_out, void* scratch, void* g_q, int C, int S,
                               int nk, int substeps, int feedback, int chunk, void* stream) {
  return launch_bwd<double>(qtab, kvec, ck, g_out, scratch, g_q, C, S, nk, substeps,
                            feedback, chunk, stream);
}
