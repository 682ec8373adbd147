// K3: lensed CMB spectra by the curved-sky correlation-function method.
//
// Replaces cosmomc_tpu/models/lensing.py:lens_cls (the lax.scans over l at
// lensing.py:136, :247 and :287): pass 1 accumulates sigma^2(theta) and
// C_gl2(theta) per chain, pass 2 the four correlation deltas xi_i(theta)
// with the Legendre recurrence and the stable upward Jacobi recurrences for
// the high-spin Wigner-d functions (the float32 fix; no closed forms in
// P_l, P_l'), pass 3 projects back, DeltaC_l[c, q] = sum_theta
// xi_q[c, theta] D_q[l, theta] with D = (P, d22, d2m2, d20).
//
// Bound (chip_smoke.py counts it from the shapes): the FP64 operations of
// models/lensing.py:_passes_plain, which does the chain-independent work
// once per (theta, l) (~160 operations) and the rest per (chain, theta, l)
// (~100): ~1.3e10 at 8 chains x 5315 theta x 2657 l. Pass 3's per-chain
// product (8.5e8 of them) is priced at the FP64 tensor-core rate, where
// this kernel runs it, the rest at the FP64 rate: ~0.37 ms, so
// compute-bound (its bytes are ~1 MB). The parent kernel did all
// of it per (chain, theta, l), ~25 of it divides and square roots of l
// alone.
//
// Design:
// - chain-independent work once per (theta, l) and chain tile: a thread
//   owns one theta and computes P_l, the three Jacobi recurrences and the
//   Wigner-d's, then applies them to a register tile of CT12 = 4 chains
//   through their sigma^2, C_gl2 and C_l (a tile of 4 was faster than 8 on
//   an H100: more blocks, fewer registers);
// - every l-only quantity (Jacobi coefficients with 1/c1, 1/l, 1/llp1,
//   1/lfacs2, rf1-rf3 and their reciprocals, lrootfacs, norm04, the X
//   prefactors) comes from a per-l float64 table staged through shared
//   memory beside the C_l tiles; theta-only reciprocals are computed once
//   per thread, so the l loop has no divide or square root;
// - parallelism: l is split into segments; each starts from recurrence
//   seeds (P_{l-2}, P_{l-1} and the three Jacobi pairs per theta; they do
//   not depend on the cosmology, so the host builds them once per (lmax,
//   n_theta) in float64). Passes 1 and 2 run (theta tile, segment, chain
//   group) blocks; a reduction adds the segments in segment order;
// - pass 3 is a contraction over theta on the FP64 tensor cores: a block
//   owns SEG multipoles, a sixth of the theta range and 8 chains; per
//   tile of 128 theta it generates D for LS multipoles into shared memory
//   and warp q runs mma.sync m8n8k4 (8 l x 8 chains x 4 theta) over the
//   tile; the sixths are added in order. D is generated in place: a
//   precomputed D table would be 4 x 2507 x 5315 doubles (426 MB), read once
//   a call at ~0.13 ms, against ~1.2e9 operations (~0.04 ms) to regenerate;
// - no atomics and fixed summation orders: repeated runs agree bit for bit.
//
// Precision: T is the storage type of the spectra and the output; the
// theta table, seeds and l table are float64, and every recurrence,
// Wigner-d function and sum is computed in float64. The low-spin d's in
// closed form (d11, d22, d20, ...) divide differences of P_l and P_l' by
// sin^2(theta); in float32 that loses the lensed TE and BB at high l
// (measured on an NVIDIA H100 at 700 W, smooth test spectra, lmax 2658 ->
// 2508: the plain float32 version misses float64 by 1.2e-3 of TE's maximum
// and 220% of BB's).
//
// The arithmetic mirrors models/lensing.py:_passes_plain, with products by
// the tabulated reciprocals where it divides. The file is built without FMA
// contraction (kernels.EXTRA_FLAGS: -fmad=false), every product and sum
// rounded on its own as in the plain version: the reverse pass's cotangent
// of C^EE at the top l is sensitive to the rounding of the recurrences
// (below).
#include "common.cuh"

namespace {

enum { TH_X, TH_SIN, TH_SIN2, TH_FAC1, TH_FAC2, TH_TAIL, TH_SW, N_TH };
// per-l table columns, models/lensing.py L_COLS
enum {
  LC_L, LC_INV_L, LC_TWO_LM1, LC_LM1, LC_LLP1, LC_INV_LLP1, LC_LFACS2, LC_INV_LFACS2,
  LC_INV_LROOT, LC_RF1, LC_INV_RF1, LC_RF2, LC_INV_RF2, LC_INV_RF3, LC_NORM04,
  LC_INV_SQRT_LLP1, LC_X220, LC_X121, LC_X132, LC_X242, LC_DX000, LC_DX022, LC_C8,
  LC_J40, LC_J44 = LC_J40 + 4, LC_J80 = LC_J44 + 4, N_LC = LC_J80 + 4
};
// seed rows, models/lensing.py SEED_ROWS
enum { SD_PMM, SD_PMMP1, SD_J40M1, SD_J40, SD_J44M1, SD_J44, SD_J80M1, SD_J80, N_SD };

constexpr int SEG = 64;       // multipoles per seed segment (models/lensing.py SEG)
constexpr int THREADS = 128;  // theta lanes per block
constexpr int CT12 = 4;       // passes 1 and 2: chains per block, in registers
constexpr int CT = 8;         // pass 3: chains per block (the mma's N)
constexpr int LS = 16;        // pass 3: multipoles per shared-memory sub-chunk
constexpr int TP3 = THREADS + 4;  // pass 3: padded theta row of the D tile
constexpr int XQ = THREADS * CT;  // pass 3: q stride of the xi tile
// pass 3: the l table columns it reads, staged in shared memory in this
// order: l, 1/l, 2l-1, l-1, llp1, 1/llp1, 1/lfacs2, 1/lrootfacs, J40's c
constexpr int N_P3 = 12;
__device__ __forceinline__ int p3_col(int k) {
  return k < 6 ? k : (k == 6 ? LC_INV_LFACS2 : (k == 7 ? LC_INV_LROOT : LC_J40 + k - 8));
}
static_assert(THREADS == 4 * 32 && CT == 8 && LS % 8 == 0,
              "pass 3: a warp per q, m8n8k4 tiles of 8 l x 8 chains");

using R = double;

struct Theta {
  R x, sinth, inv_sin2, fac1, fac2, inv_fac1, inv_fac2, inv_sinth, s2h2, sc2, s2h4, c4x8,
      fac4;
};

__device__ __forceinline__ Theta load_theta(const R* __restrict__ th, int nth, int j) {
  Theta t;
  t.x = th[TH_X * nth + j];
  t.sinth = th[TH_SIN * nth + j];
  t.fac1 = th[TH_FAC1 * nth + j];
  t.fac2 = th[TH_FAC2 * nth + j];
  t.inv_sin2 = R(1) / th[TH_SIN2 * nth + j];
  t.inv_fac1 = R(1) / t.fac1;
  t.inv_fac2 = R(1) / t.fac2;
  t.inv_sinth = R(1) / t.sinth;
  const R sin2half = t.fac1 / R(2), cos2half = t.fac2 / R(2);
  t.s2h2 = sin2half * sin2half;
  const R sc = sin2half * cos2half;
  t.sc2 = sc * sc;
  t.s2h4 = t.s2h2 * t.s2h2;
  t.c4x8 = (R(4) * t.x - R(8)) / t.fac2;
  t.fac4 = R(4) * (t.fac1 / t.fac2);
  return t;
}

// P^{(A,B)}_n(x) from (P_{n-2}, P_{n-1}) = (jm1, j); c = (c2, c3, c4, 1/c1)
template <int A, int B>
__device__ __forceinline__ R jacobi(int n, R x, R jm1, R j, const R* c) {
  if (n < 0) return R(0);
  if (n == 0) return R(1);
  if (n == 1) return R(A + 1) + R(A + B + 2) * (x - R(1)) / R(2);
  return ((c[0] + c[1] * x) * j - c[2] * jm1) * c[3];
}

// P_l from (P_{l-2}, P_{l-1}), l = il + 2
__device__ __forceinline__ R legendre(const R* r, R x, R pmm, R pmmp1) {
  return (r[LC_TWO_LM1] * x * pmmp1 - r[LC_LM1] * pmm) * r[LC_INV_L];
}

// rows il0 .. il0+n-1 of the l table into shared memory
__device__ __forceinline__ void stage_rows(R* dst, const R* __restrict__ lt, int il0, int n) {
  for (int e = threadIdx.x; e < n * N_LC; e += blockDim.x) dst[e] = lt[(size_t)il0 * N_LC + e];
}

// ---- pass 1: per-segment partial sigma^2 and C_gl2 ----
template <typename T>
__global__ void __launch_bounds__(THREADS)
pass1_kernel(const T* __restrict__ cl, const R* __restrict__ th, const R* __restrict__ lt,
             const R* __restrict__ seeds, R* __restrict__ part1, int C, int L, int nth,
             int seg12) {
  __shared__ R rows[SEG * N_LC];
  __shared__ R cp[CT12][SEG];
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int jj = j < nth ? j : nth - 1;  // lanes past the end run on a valid theta
  const int s = blockIdx.y, c0 = blockIdx.z * CT12;
  const int il_begin = s * seg12, il_end = min(L, il_begin + seg12);
  const Theta t = load_theta(th, nth, jj);
  const R* sd = seeds + (size_t)(il_begin / SEG) * N_SD * nth + jj;
  R pmm = sd[SD_PMM * nth], pmmp1 = sd[SD_PMMP1 * nth];
  R sig[CT12], cg[CT12];
#pragma unroll
  for (int c = 0; c < CT12; ++c) sig[c] = cg[c] = R(0);
  for (int il0 = il_begin; il0 < il_end; il0 += SEG) {
    const int n = min(SEG, il_end - il0);
    __syncthreads();
    stage_rows(rows, lt, il0, n);
    for (int e = threadIdx.x; e < CT12 * SEG; e += blockDim.x) {
      const int c = e / SEG, u = e % SEG;
      cp[c][u] = (c0 + c < C && u < n) ? R(cl[((size_t)(c0 + c) * 4 + 3) * L + il0 + u]) : R(0);
    }
    __syncthreads();
    for (int u = 0; u < n; ++u) {
      const R* r = rows + u * N_LC;
      const R P = legendre(r, t.x, pmm, pmmp1);
      pmm = pmmp1;
      pmmp1 = P;
      const R dP = r[LC_L] * (pmm - t.x * P) * t.inv_sin2;
      const R d11 = t.fac1 * dP * r[LC_INV_LLP1] + P;
      const R dm11 = t.fac2 * dP * r[LC_INV_LLP1] - P;
      const R om = R(1) - d11;
#pragma unroll
      for (int c = 0; c < CT12; ++c) {
        sig[c] = sig[c] + om * cp[c][u];
        cg[c] = cg[c] + dm11 * cp[c][u];
      }
    }
  }
  if (j >= nth) return;
#pragma unroll
  for (int c = 0; c < CT12; ++c) {
    if (c0 + c >= C) break;
    part1[(((size_t)s * 2 + 0) * C + c0 + c) * nth + j] = sig[c];
    part1[(((size_t)s * 2 + 1) * C + c0 + c) * nth + j] = cg[c];
  }
}

// sgcg[v, c, theta] = sum over segments, in order, of part1[s, v, c, theta]
__global__ void reduce1_kernel(const R* __restrict__ part1, R* __restrict__ sgcg, int C,
                               int nth, int nseg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = 2 * C * nth;
  if (i >= n) return;
  R s = R(0);
  for (int k = 0; k < nseg; ++k) s += part1[(size_t)k * n + i];
  sgcg[i] = s;
}

// ---- pass 2: per-segment partial xi_0..3 ----
template <typename T>
__global__ void __launch_bounds__(THREADS)
pass2_kernel(const T* __restrict__ cl, const R* __restrict__ th, const R* __restrict__ lt,
             const R* __restrict__ seeds, const R* __restrict__ sgcg, R* __restrict__ part2,
             int C, int L, int nth, int seg12) {
  __shared__ R rows[SEG * N_LC];
  __shared__ R ct[3][CT12][SEG];  // CTT, CTE, CEE
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int jj = j < nth ? j : nth - 1;
  const int s = blockIdx.y, c0 = blockIdx.z * CT12;
  const int il_begin = s * seg12, il_end = min(L, il_begin + seg12);
  const Theta t = load_theta(th, nth, jj);
  const R x = t.x;
  const R* sd = seeds + (size_t)(il_begin / SEG) * N_SD * nth + jj;
  R pmm = sd[SD_PMM * nth], pmmp1 = sd[SD_PMMP1 * nth];
  R j40m1 = sd[SD_J40M1 * nth], j40 = sd[SD_J40 * nth];
  R j44m1 = sd[SD_J44M1 * nth], j44 = sd[SD_J44 * nth];
  R j80m1 = sd[SD_J80M1 * nth], j80 = sd[SD_J80 * nth];
  R sg[CT12], g[CT12], xi0[CT12], xi1[CT12], xi2[CT12], xi3[CT12];
#pragma unroll
  for (int c = 0; c < CT12; ++c) {
    const bool on = c0 + c < C;
    sg[c] = on ? sgcg[(size_t)(c0 + c) * nth + jj] : R(0);
    g[c] = on ? sgcg[((size_t)C + c0 + c) * nth + jj] : R(0);
    xi0[c] = xi1[c] = xi2[c] = xi3[c] = R(0);
  }
  for (int il0 = il_begin; il0 < il_end; il0 += SEG) {
    const int n = min(SEG, il_end - il0);
    __syncthreads();
    stage_rows(rows, lt, il0, n);
    for (int e = threadIdx.x; e < 3 * CT12 * SEG; e += blockDim.x) {
      const int q = e / (CT12 * SEG), c = (e / SEG) % CT12, u = e % SEG;
      ct[q][c][u] = (c0 + c < C && u < n) ? R(cl[((size_t)(c0 + c) * 4 + q) * L + il0 + u])
                                          : R(0);
    }
    __syncthreads();
    for (int u = 0; u < n; ++u) {
      const R* r = rows + u * N_LC;
      const int lci = il0 + u + 2;
      const R P = legendre(r, x, pmm, pmmp1);
      pmm = pmmp1;
      pmmp1 = P;
      const R J40 = jacobi<4, 0>(lci - 2, x, j40m1, j40, r + LC_J40);
      const R J44 = jacobi<4, 4>(lci - 4, x, j44m1, j44, r + LC_J44);
      const R J80 = jacobi<8, 0>(lci - 4, x, j80m1, j80, r + LC_J80);
      j40m1 = j40; j40 = J40;
      j44m1 = j44; j44 = J44;
      j80m1 = j80; j80 = J80;
      const R llp1 = r[LC_LLP1], inv_llp1 = r[LC_INV_LLP1];
      const R lfacs2 = r[LC_LFACS2], rf1 = r[LC_RF1], rf2 = r[LC_RF2];
      const R inv_rf1 = r[LC_INV_RF1], inv_rf2 = r[LC_INV_RF2];
      const R dP = r[LC_L] * (pmm - x * P) * t.inv_sin2;
      const R d11 = t.fac1 * dP * inv_llp1 + P;
      const R dm11 = t.fac2 * dP * inv_llp1 - P;
      const R d22 = ((t.c4x8 + llp1) * P + t.fac4 * (t.fac2 + (x - R(2)) * inv_llp1) * dP) *
                    r[LC_INV_LFACS2];
      const R d2m2 = t.s2h2 * J40;
      const R d20 = (R(2) * x * dP - llp1 * P) * r[LC_INV_LROOT];
      const R sr1 = t.sinth * inv_rf1;
      const R d1m2 = sr1 * (dP - R(2) * t.inv_fac1 * dm11);
      const R d12 = sr1 * (dP - R(2) * t.inv_fac2 * d11);
      const R sinfac = R(4) * t.inv_sinth;
      R d1m3 = R(0), d2m3 = R(0), d3m3 = R(0), d13 = R(0);
      if (lci >= 3) {
        d1m3 = (-(x + R(0.5)) * d1m2 * sinfac - lfacs2 * dm11 * inv_rf1) * inv_rf2;
        d2m3 = (-t.fac2 * d2m2 * sinfac - rf1 * d1m2) * inv_rf2;
        d3m3 = (-(x + R(1.5)) * d2m3 * sinfac - rf1 * d1m3) * inv_rf2;
        d13 = ((x - R(0.5)) * d12 * sinfac - lfacs2 * d11 * inv_rf1) * inv_rf2;
      }
      R d04 = R(0), d2m4 = R(0), d4m4 = R(0);
      if (lci >= 4) {
        d04 = r[LC_NORM04] * t.sc2 * J44;
        d2m4 = (-(R(6) * x + R(4)) * d2m3 * t.inv_sinth - rf2 * d2m2) * r[LC_INV_RF3];
        d4m4 = t.s2h4 * J80;
      }
      const R x220 = r[LC_X220], x121 = r[LC_X121], x132 = r[LC_X132];
      const R x242 = r[LC_X242], dx000 = r[LC_DX000], dx022 = r[LC_DX022];
      const R c8 = r[LC_C8], isq = r[LC_INV_SQRT_LLP1];
#pragma unroll
      for (int c = 0; c < CT12; ++c) {
        const R sigmasq = sg[c], Cg2 = g[c], Cg2sq = g[c] * g[c];
        const R X000 = xexp(-llp1 * sigmasq / R(4));
        const R X022 = X000 * (R(1) + sigmasq);
        const R X220 = x220 * X000;
        const R X121 = x121 * X000;
        const R X132 = x132 * X000;
        const R X242 = x242 * X022;
        const R dX000 = dx000 * X000;
        const R dX022 = dx022 * X022;
        const R fac1v = dX000 * dX000;
        const R fac3 = X220 * X220;
        R f = ((X000 * X000 - R(1)) + Cg2sq * fac1v) * P + Cg2sq * fac3 * d2m2 +
              c8 * fac1v * Cg2 * dm11;
        xi0[c] = xi0[c] + ct[0][c][u] * f;
        const R fac2v = (Cg2 * dX022) * (Cg2 * dX022) + (X022 * X022 - R(1));
        f = R(2) * Cg2 * X121 * X132 * d13 + fac2v * d22 + Cg2sq * X242 * X220 * d04;
        xi1[c] = xi1[c] + ct[2][c][u] * f;
        f = (fac3 * P + X242 * X242 * d4m4) * Cg2sq / R(2) +
            Cg2 * (X121 * X121 * dm11 + X132 * X132 * d3m3) + fac2v * d2m2;
        xi2[c] = xi2[c] + ct[2][c][u] * f;
        f = (X000 * X022 - R(1)) * d20 + R(2) * dX000 * Cg2 * (X121 * d11 + X132 * d1m3) * isq +
            Cg2sq * (X220 / R(2) * d2m4 * X242 + (fac3 / R(2) + dX022 * dX000) * d20);
        xi3[c] = xi3[c] + ct[1][c][u] * f;
      }
    }
  }
  if (j >= nth) return;
#pragma unroll
  for (int c = 0; c < CT12; ++c) {
    if (c0 + c >= C) break;
    R* p = part2 + (((size_t)s * C + c0 + c) * 4) * nth + j;
    p[0] = xi0[c];
    p[(size_t)nth] = xi1[c];
    p[2 * (size_t)nth] = xi2[c];
    p[3 * (size_t)nth] = xi3[c];
  }
}

// xi[q, theta, c] = tail sw * sum over segments, in order, of part2[s, c, q, theta]
__global__ void reduce2_kernel(const R* __restrict__ part2, const R* __restrict__ th,
                               R* __restrict__ xi, int C, int nth, int nseg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = C * 4 * nth;
  if (i >= n) return;
  const int jt = i % nth, q = (i / nth) % 4, c = i / (4 * nth);
  R s = R(0);
  for (int k = 0; k < nseg; ++k) s += part2[(size_t)k * n + i];
  xi[((size_t)q * nth + jt) * C + c] = s * th[TH_TAIL * nth + jt] * th[TH_SW * nth + jt];
}

// D[m][n] += A[m][k] B[k][n] for an 8 x 8 x 4 float64 tile on the tensor
// cores; lane i holds A[i / 4][i % 4], B[i % 4][i / 4] and D[i / 4][2 (i % 4)
// + 0, 1]
__device__ __forceinline__ void dmma(R& d0, R& d1, R a, R b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// ---- pass 3: DeltaC partial sums over a sixth of theta ----
// DeltaC[q][l][c] = sum_theta D_q[l][theta] xi_q[theta][c]: warp q runs the
// m8n8k4 products over the tile's theta, 8 l x 8 chains a tile.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pass3_kernel(const R* __restrict__ th, const R* __restrict__ lt, const R* __restrict__ seeds,
             const R* __restrict__ xi, R* __restrict__ part3, int C, int nth, int nl_out,
             int tiles_per_split) {
  extern __shared__ __align__(16) R sm[];
  R* D = sm;                    // [4][LS][TP3]: D_q[l][theta]
  R* X = sm + 4 * LS * TP3;     // [4][XQ]: xi[q][theta][c]
  R* rows = X + 4 * XQ;         // [SEG][N_P3]: the block's l table columns
  const int tid = threadIdx.x, lane = tid & 31, q = tid >> 5;
  const int am = lane >> 2, ak = lane & 3;  // fragment row (l; chain for B) and k (theta)
  const int il_base = blockIdx.x * SEG, ts = blockIdx.y, c0 = blockIdx.z * CT;
  const int ntiles = (nth + THREADS - 1) / THREADS;
  const int tile_end = min(ntiles, (ts + 1) * tiles_per_split);
  for (int e = tid; e < SEG * N_P3; e += THREADS) {
    const int il = min(il_base + e / N_P3, nl_out - 1);
    rows[e] = lt[(size_t)il * N_LC + p3_col(e % N_P3)];
  }
  R acc[SEG / LS][LS / 8][2];
#pragma unroll
  for (int s = 0; s < SEG / LS; ++s)
#pragma unroll
    for (int mt = 0; mt < LS / 8; ++mt) acc[s][mt][0] = acc[s][mt][1] = R(0);

  for (int tile = ts * tiles_per_split; tile < tile_end; ++tile) {
    const int j = tile * THREADS + tid;
    const int jj = j < nth ? j : nth - 1;
    __syncthreads();  // the previous tile's products are done with X and D
    for (int e = tid; e < 4 * THREADS * CT; e += THREADS) {
      const int qq = e / (THREADS * CT), tl = (e / CT) % THREADS, c = e % CT;
      const int jg = tile * THREADS + tl;
      X[qq * XQ + tl * CT + c] =
          (jg < nth && c0 + c < C) ? xi[((size_t)qq * nth + jg) * C + c0 + c] : R(0);
    }
    const Theta t = load_theta(th, nth, jj);
    const R x = t.x;
    const R* sd = seeds + (size_t)blockIdx.x * N_SD * nth + jj;
    R pmm = sd[SD_PMM * nth], pmmp1 = sd[SD_PMMP1 * nth];
    R j40m1 = sd[SD_J40M1 * nth], j40 = sd[SD_J40 * nth];
#pragma unroll
    for (int s = 0; s < SEG / LS; ++s) {
      for (int u = 0; u < LS; ++u) {
        const int il = il_base + s * LS + u;
        R P = R(0), d22 = R(0), d2m2 = R(0), d20 = R(0);
        if (il < nl_out) {
          const R* r = rows + (s * LS + u) * N_P3;  // columns in p3_col order
          const R llp1 = r[4];
          P = (r[2] * x * pmmp1 - r[3] * pmm) * r[1];
          pmm = pmmp1;
          pmmp1 = P;
          const R dP = r[0] * (pmm - x * P) * t.inv_sin2;
          d22 = ((t.c4x8 + llp1) * P + t.fac4 * (t.fac2 + (x - R(2)) * r[5]) * dP) * r[6];
          const R J40 = jacobi<4, 0>(il, x, j40m1, j40, r + 8);
          j40m1 = j40;
          j40 = J40;
          d2m2 = t.s2h2 * J40;
          d20 = (R(2) * x * dP - llp1 * P) * r[7];
        }
        R* d = D + u * TP3 + tid;
        d[0] = P;
        d[LS * TP3] = d22;
        d[2 * LS * TP3] = d2m2;
        d[3 * LS * TP3] = d20;
      }
      __syncthreads();  // D (and, for s = 0, X) complete
      const R* dq = D + (q * LS + am) * TP3 + ak;
      const R* xq = X + q * XQ + ak * CT + am;
      for (int k0 = 0; k0 < THREADS; k0 += 4) {
        const R b = xq[k0 * CT];
#pragma unroll
        for (int mt = 0; mt < LS / 8; ++mt)
          dmma(acc[s][mt][0], acc[s][mt][1], dq[mt * 8 * TP3 + k0], b);
      }
      __syncthreads();  // D is rewritten by the next sub-chunk
    }
  }
#pragma unroll
  for (int s = 0; s < SEG / LS; ++s)
#pragma unroll
    for (int mt = 0; mt < LS / 8; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int il = il_base + s * LS + mt * 8 + am, c = c0 + 2 * ak + i;
        if (il < nl_out && c < C)
          part3[(((size_t)ts * C + c) * nl_out + il) * 4 + q] = acc[s][mt][i];
      }
}

// sums[c, l, q] = sum over the theta splits, in order, of part3[ts, c, l, q]
template <typename T>
__global__ void reduce3_kernel(const R* __restrict__ part3, T* __restrict__ sums, int n,
                               int nsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  R s = R(0);
  for (int k = 0; k < nsplit; ++k) s += part3[(size_t)k * n + i];
  sums[i] = T(s);
}

template <typename T>
int launch(const void* cl, const void* th, const void* lt, const void* seeds, void* part1,
           void* sgcg, void* part2, void* xi, void* part3, void* sums, int C, int L, int nth,
           int nl_out, int seg12, int nsplit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (seg12 <= 0 || seg12 % SEG != 0 || nsplit <= 0 || nl_out > L)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (nth + THREADS - 1) / THREADS;
  const int nseg = (L + seg12 - 1) / seg12;
  const int groups = (C + CT - 1) / CT, groups12 = (C + CT12 - 1) / CT12;
  cudaError_t err;
  const dim3 grid12(ntiles, nseg, groups12);
  pass1_kernel<T><<<grid12, THREADS, 0, st>>>((const T*)cl, (const R*)th, (const R*)lt,
                                              (const R*)seeds, (R*)part1, C, L, nth, seg12);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce1_kernel<<<(2 * C * nth + 255) / 256, 256, 0, st>>>((const R*)part1, (R*)sgcg, C, nth,
                                                            nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  pass2_kernel<T><<<grid12, THREADS, 0, st>>>((const T*)cl, (const R*)th, (const R*)lt,
                                              (const R*)seeds, (const R*)sgcg, (R*)part2, C,
                                              L, nth, seg12);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  reduce2_kernel<<<(4 * C * nth + 255) / 256, 256, 0, st>>>((const R*)part2, (const R*)th,
                                                            (R*)xi, C, nth, nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem3 = (size_t)(4 * LS * TP3 + 4 * XQ + SEG * N_P3) * sizeof(R);
  err = cudaFuncSetAttribute(pass3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return (int)err;
  const int tps = (ntiles + nsplit - 1) / nsplit;
  const dim3 grid3((nl_out + SEG - 1) / SEG, nsplit, groups);
  pass3_kernel<T><<<grid3, THREADS, smem3, st>>>((const R*)th, (const R*)lt, (const R*)seeds,
                                                 (const R*)xi, (R*)part3, C, nth, nl_out, tps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = C * nl_out * 4;
  reduce3_kernel<T><<<(n + 255) / 256, 256, 0, st>>>((const R*)part3, (T*)sums, n, nsplit);
  return (int)cudaGetLastError();
}

// ===========================================================================
// The reverse pass (lensing_bwd): the cotangent of cl (C, 4, L) from that of
// the pass-3 sums (C, nl_out, 4), as autograd of models/lensing.py:
// _passes_plain gives it. JAX's three scans transposed, in reverse order:
//
//   3T: g_xi[c, q, theta] = tail sw sum_l g_sums[c, l, q] D_q[l, theta], a
//       theta-major walk over l like the forward passes 1-2 (a thread a
//       theta, a register tile of chains, l segments from the seeds, the
//       segments added in order);
//   2T: per (theta, l) the forward's Wigner-d's, per chain the four xi
//       terms f_q and their derivatives in sigma^2 and C_gl2 (by hand: every
//       X factor is exp(-l(l+1) sigma^2 / 4) or it times (1 + sigma^2));
//       the cotangents of CTT, CTE, CEE are sums over theta of g_xi_q f_q
//       (warp butterflies, then the block's 4 warps in order, then the theta
//       tiles in order), those of sigma^2 and C_gl2 sums over l in
//       registers (the segments in order);
//   1T: the cotangent of Cphil3[l] = sum_theta g_sigma (1 - d11) + g_Cgl2
//       dm11, reduced over theta as in 2T.
//
// sigma^2(theta) and C_gl2(theta) are the forward's (its sgcg buffer, which
// the autograd Function keeps): not recomputed. Everything is float64, as
// in the forward; no atomics, every sum in a fixed order, so a chain's
// cotangent does not depend on the other chains and repeated runs agree bit
// for bit.
//
// Bound (chip_smoke.py counts it): ~3x the forward's operations, pass 3T
// per (chain, theta, l) in the FP64 units (no tensor cores here).
// ===========================================================================

constexpr int CH = 32;  // multipoles per staged chunk in the reverse kernels

// the sum over the warp's lanes, in a fixed order (lane 0's value is used)
__device__ __forceinline__ R warp_sum(R v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o);
  return v;
}

// The Legendre and J40 recurrences of pass 3T in the plain version's
// operation order, each operation rounded on its own and divided where it
// divides: g_xi sums D_l(theta) over ~2500 l, and the cotangent of C^EE at
// the top l agrees with the plain version's to 1e-9 of its maximum only
// when these recurrences round as the plain version's do (with the
// table's reciprocals it did not on an H100; scripts/k3_bwd_rounding.py
// measures the share of FMA contraction). P_l from (P_{l-2}, P_{l-1}),
// l = lci:
__device__ __forceinline__ R legendre_plain(int lci, R x, R pmm, R pmmp1) {
  const R lc = R(lci);
  return __ddiv_rn(__dsub_rn(__dmul_rn(__dmul_rn(__dsub_rn(__dmul_rn(R(2), lc), R(1)), x), pmmp1),
                             __dmul_rn(__dsub_rn(lc, R(1)), pmm)),
                   lc);
}
// P^{(4,0)}_n from (P_{n-2}, P_{n-1}); c = the table's (c2, c3, c4), exact
// integers, and c1 = 2n (n + 4)(2n + 2), exact too
__device__ __forceinline__ R jacobi40_plain(int n, R x, R jm1, R j, const R* c) {
  if (n < 0) return R(0);
  if (n == 0) return R(1);
  if (n == 1) return __dadd_rn(R(5), __ddiv_rn(__dmul_rn(R(6), __dsub_rn(x, R(1))), R(2)));
  const R nn = R(n);
  const R c1 = R(2) * nn * (nn + R(4)) * (R(2) * nn + R(2));
  return __ddiv_rn(__dsub_rn(__dmul_rn(__dadd_rn(c[0], __dmul_rn(c[1], x)), j),
                             __dmul_rn(c[2], jm1)),
                   c1);
}

// ---- 3T: per-segment partial g_xi (before the tail and sin weights) ----
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd3_kernel(const T* __restrict__ gsums, const R* __restrict__ th, const R* __restrict__ lt,
            const R* __restrict__ seeds, R* __restrict__ p3t, int C, int nth, int nl_out,
            int seg) {
  __shared__ R rows[CH * N_LC];
  __shared__ R gs[CT12][CH][4];
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int jj = j < nth ? j : nth - 1;
  const int s = blockIdx.y, c0 = blockIdx.z * CT12;
  const int il_begin = s * seg, il_end = min(nl_out, il_begin + seg);
  const Theta t = load_theta(th, nth, jj);
  const R x = t.x;
  const R* sd = seeds + (size_t)(il_begin / SEG) * N_SD * nth + jj;
  R pmm = sd[SD_PMM * nth], pmmp1 = sd[SD_PMMP1 * nth];
  R j40m1 = sd[SD_J40M1 * nth], j40 = sd[SD_J40 * nth];
  R acc[4][CT12];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int c = 0; c < CT12; ++c) acc[q][c] = R(0);
  for (int il0 = il_begin; il0 < il_end; il0 += CH) {
    const int n = min(CH, il_end - il0);
    __syncthreads();
    stage_rows(rows, lt, il0, n);
    for (int e = threadIdx.x; e < CT12 * CH * 4; e += blockDim.x) {
      const int c = e / (CH * 4), u = (e / 4) % CH, q = e % 4;
      gs[c][u][q] = (c0 + c < C && u < n)
                        ? R(gsums[((size_t)(c0 + c) * nl_out + il0 + u) * 4 + q])
                        : R(0);
    }
    __syncthreads();
    for (int u = 0; u < n; ++u) {
      const R* r = rows + u * N_LC;
      const int lci = il0 + u + 2;
      const R llp1 = r[LC_LLP1];
      const R P = legendre_plain(lci, x, pmm, pmmp1);
      pmm = pmmp1;
      pmmp1 = P;
      const R dP = r[LC_L] * (pmm - x * P) * t.inv_sin2;
      const R d22 = ((t.c4x8 + llp1) * P + t.fac4 * (t.fac2 + (x - R(2)) * r[LC_INV_LLP1]) * dP) *
                    r[LC_INV_LFACS2];
      const R J40 = jacobi40_plain(lci - 2, x, j40m1, j40, r + LC_J40);
      j40m1 = j40;
      j40 = J40;
      const R d2m2 = t.s2h2 * J40;
      const R d20 = (R(2) * x * dP - llp1 * P) * r[LC_INV_LROOT];
#pragma unroll
      for (int c = 0; c < CT12; ++c) {
        acc[0][c] += gs[c][u][0] * P;
        acc[1][c] += gs[c][u][1] * d22;
        acc[2][c] += gs[c][u][2] * d2m2;
        acc[3][c] += gs[c][u][3] * d20;
      }
    }
  }
  if (j >= nth) return;
#pragma unroll
  for (int c = 0; c < CT12; ++c) {
    if (c0 + c >= C) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) p3t[(((size_t)s * C + c0 + c) * 4 + q) * nth + j] = acc[q][c];
  }
}

// gxi[c, q, theta] = tail sw * sum over segments, in order, of p3t[s, c, q, theta]
__global__ void bwd3_reduce_kernel(const R* __restrict__ p3t, const R* __restrict__ th,
                                   R* __restrict__ gxi, int C, int nth, int nseg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = C * 4 * nth;
  if (i >= n) return;
  const int jt = i % nth;
  R s = R(0);
  for (int k = 0; k < nseg; ++k) s += p3t[(size_t)k * n + i];
  gxi[i] = s * th[TH_TAIL * nth + jt] * th[TH_SW * nth + jt];
}

// ---- 2T: the cotangents of CTT, CTE, CEE (partial over theta tiles) and of
// sigma^2, C_gl2 (partial over l segments) ----
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd2_kernel(const T* __restrict__ cl, const R* __restrict__ th, const R* __restrict__ lt,
            const R* __restrict__ seeds, const R* __restrict__ sgcg, const R* __restrict__ gxi,
            R* __restrict__ p2t_sg, R* __restrict__ p2t_cl, int C, int L, int nth, int seg12) {
  __shared__ R rows[CH * N_LC];
  __shared__ R ct[3][CT12][CH];              // CTT, CTE, CEE
  __shared__ R wsum[THREADS / 32][CH][CT12][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int jj = j < nth ? j : nth - 1;
  const int s = blockIdx.y, c0 = blockIdx.z * CT12;
  const int il_begin = s * seg12, il_end = min(L, il_begin + seg12);
  const Theta t = load_theta(th, nth, jj);
  const R x = t.x;
  const R* sd = seeds + (size_t)(il_begin / SEG) * N_SD * nth + jj;
  R pmm = sd[SD_PMM * nth], pmmp1 = sd[SD_PMMP1 * nth];
  R j40m1 = sd[SD_J40M1 * nth], j40 = sd[SD_J40 * nth];
  R j44m1 = sd[SD_J44M1 * nth], j44 = sd[SD_J44 * nth];
  R j80m1 = sd[SD_J80M1 * nth], j80 = sd[SD_J80 * nth];
  // lanes past the end carry zero cotangents, so they add nothing
  R sg[CT12], g[CT12], gx[4][CT12], acc_s[CT12], acc_g[CT12];
#pragma unroll
  for (int c = 0; c < CT12; ++c) {
    const bool on = c0 + c < C;
    sg[c] = on ? sgcg[(size_t)(c0 + c) * nth + jj] : R(0);
    g[c] = on ? sgcg[((size_t)C + c0 + c) * nth + jj] : R(0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gx[q][c] = (on && j < nth) ? gxi[((size_t)(c0 + c) * 4 + q) * nth + j] : R(0);
    acc_s[c] = acc_g[c] = R(0);
  }
  for (int il0 = il_begin; il0 < il_end; il0 += CH) {
    const int n = min(CH, il_end - il0);
    __syncthreads();
    stage_rows(rows, lt, il0, n);
    for (int e = threadIdx.x; e < 3 * CT12 * CH; e += blockDim.x) {
      const int q = e / (CT12 * CH), c = (e / CH) % CT12, u = e % CH;
      ct[q][c][u] = (c0 + c < C && u < n) ? R(cl[((size_t)(c0 + c) * 4 + q) * L + il0 + u])
                                          : R(0);
    }
    __syncthreads();
    for (int u = 0; u < n; ++u) {
      const R* r = rows + u * N_LC;
      const int lci = il0 + u + 2;
      const R P = legendre(r, x, pmm, pmmp1);
      pmm = pmmp1;
      pmmp1 = P;
      const R J40 = jacobi<4, 0>(lci - 2, x, j40m1, j40, r + LC_J40);
      const R J44 = jacobi<4, 4>(lci - 4, x, j44m1, j44, r + LC_J44);
      const R J80 = jacobi<8, 0>(lci - 4, x, j80m1, j80, r + LC_J80);
      j40m1 = j40; j40 = J40;
      j44m1 = j44; j44 = J44;
      j80m1 = j80; j80 = J80;
      const R llp1 = r[LC_LLP1], inv_llp1 = r[LC_INV_LLP1];
      const R lfacs2 = r[LC_LFACS2], rf1 = r[LC_RF1], rf2 = r[LC_RF2];
      const R inv_rf1 = r[LC_INV_RF1], inv_rf2 = r[LC_INV_RF2];
      const R dP = r[LC_L] * (pmm - x * P) * t.inv_sin2;
      const R d11 = t.fac1 * dP * inv_llp1 + P;
      const R dm11 = t.fac2 * dP * inv_llp1 - P;
      const R d22 = ((t.c4x8 + llp1) * P + t.fac4 * (t.fac2 + (x - R(2)) * inv_llp1) * dP) *
                    r[LC_INV_LFACS2];
      const R d2m2 = t.s2h2 * J40;
      const R d20 = (R(2) * x * dP - llp1 * P) * r[LC_INV_LROOT];
      const R sr1 = t.sinth * inv_rf1;
      const R d1m2 = sr1 * (dP - R(2) * t.inv_fac1 * dm11);
      const R d12 = sr1 * (dP - R(2) * t.inv_fac2 * d11);
      const R sinfac = R(4) * t.inv_sinth;
      R d1m3 = R(0), d2m3 = R(0), d3m3 = R(0), d13 = R(0);
      if (lci >= 3) {
        d1m3 = (-(x + R(0.5)) * d1m2 * sinfac - lfacs2 * dm11 * inv_rf1) * inv_rf2;
        d2m3 = (-t.fac2 * d2m2 * sinfac - rf1 * d1m2) * inv_rf2;
        d3m3 = (-(x + R(1.5)) * d2m3 * sinfac - rf1 * d1m3) * inv_rf2;
        d13 = ((x - R(0.5)) * d12 * sinfac - lfacs2 * d11 * inv_rf1) * inv_rf2;
      }
      R d04 = R(0), d2m4 = R(0), d4m4 = R(0);
      if (lci >= 4) {
        d04 = r[LC_NORM04] * t.sc2 * J44;
        d2m4 = (-(R(6) * x + R(4)) * d2m3 * t.inv_sinth - rf2 * d2m2) * r[LC_INV_RF3];
        d4m4 = t.s2h4 * J80;
      }
      const R x220 = r[LC_X220], x121 = r[LC_X121], x132 = r[LC_X132];
      const R x242 = r[LC_X242], dx000 = r[LC_DX000], dx022 = r[LC_DX022];
      const R c8 = r[LC_C8], isq = r[LC_INV_SQRT_LLP1];
#pragma unroll
      for (int c = 0; c < CT12; ++c) {
        const R sigmasq = sg[c], Cg2 = g[c], Cg2sq = g[c] * g[c];
        // the X factors and their derivatives (_s) in sigma^2
        const R X000 = xexp(-llp1 * sigmasq / R(4));
        const R X000_s = dx000 * X000;
        const R X022 = X000 * (R(1) + sigmasq);
        const R X022_s = dx000 * X022 + X000;
        const R X220 = x220 * X000, X220_s = x220 * X000_s;
        const R X121 = x121 * X000, X121_s = x121 * X000_s;
        const R X132 = x132 * X000, X132_s = x132 * X000_s;
        const R X242 = x242 * X022, X242_s = x242 * X022_s;
        const R dX000 = dx000 * X000, dX000_s = dx000 * X000_s;
        const R dX022 = dx022 * X022, dX022_s = dx022 * X022_s;
        const R fac1v = dX000 * dX000, fac1v_s = R(2) * dX000 * dX000_s;
        const R fac3 = X220 * X220, fac3_s = R(2) * X220 * X220_s;
        const R fac2v = (Cg2 * dX022) * (Cg2 * dX022) + (X022 * X022 - R(1));
        const R fac2v_s = R(2) * Cg2sq * dX022 * dX022_s + R(2) * X022 * X022_s;
        const R fac2v_g = R(2) * Cg2 * dX022 * dX022;
        // TT
        const R f0 = ((X000 * X000 - R(1)) + Cg2sq * fac1v) * P + Cg2sq * fac3 * d2m2 +
                     c8 * fac1v * Cg2 * dm11;
        const R f0_s = (R(2) * X000 * X000_s + Cg2sq * fac1v_s) * P + Cg2sq * fac3_s * d2m2 +
                       c8 * fac1v_s * Cg2 * dm11;
        const R f0_g = R(2) * Cg2 * fac1v * P + R(2) * Cg2 * fac3 * d2m2 + c8 * fac1v * dm11;
        // Q+U
        const R f1 = R(2) * Cg2 * X121 * X132 * d13 + fac2v * d22 + Cg2sq * X242 * X220 * d04;
        const R f1_s = R(2) * Cg2 * (X121_s * X132 + X121 * X132_s) * d13 + fac2v_s * d22 +
                       Cg2sq * (X242_s * X220 + X242 * X220_s) * d04;
        const R f1_g = R(2) * X121 * X132 * d13 + fac2v_g * d22 + R(2) * Cg2 * X242 * X220 * d04;
        // Q-U
        const R q2 = fac3 * P + X242 * X242 * d4m4;
        const R q2_s = fac3_s * P + R(2) * X242 * X242_s * d4m4;
        const R m2 = X121 * X121 * dm11 + X132 * X132 * d3m3;
        const R m2_s = R(2) * (X121 * X121_s * dm11 + X132 * X132_s * d3m3);
        const R f2 = q2 * Cg2sq / R(2) + Cg2 * m2 + fac2v * d2m2;
        const R f2_s = q2_s * Cg2sq / R(2) + Cg2 * m2_s + fac2v_s * d2m2;
        const R f2_g = q2 * Cg2 + m2 + fac2v_g * d2m2;
        // TE
        const R h = X121 * d11 + X132 * d1m3;
        const R h_s = X121_s * d11 + X132_s * d1m3;
        const R k3 = X220 / R(2) * d2m4 * X242 + (fac3 / R(2) + dX022 * dX000) * d20;
        const R k3_s = (X220_s * X242 + X220 * X242_s) / R(2) * d2m4 +
                       (fac3_s / R(2) + dX022_s * dX000 + dX022 * dX000_s) * d20;
        const R f3 = (X000 * X022 - R(1)) * d20 + R(2) * dX000 * Cg2 * h * isq + Cg2sq * k3;
        const R f3_s = (X000_s * X022 + X000 * X022_s) * d20 +
                       R(2) * Cg2 * (dX000_s * h + dX000 * h_s) * isq + Cg2sq * k3_s;
        const R f3_g = R(2) * dX000 * h * isq + R(2) * Cg2 * k3;
        const R ctt = ct[0][c][u], cte = ct[1][c][u], cee = ct[2][c][u];
        acc_s[c] += ctt * gx[0][c] * f0_s + cee * (gx[1][c] * f1_s + gx[2][c] * f2_s) +
                    cte * gx[3][c] * f3_s;
        acc_g[c] += ctt * gx[0][c] * f0_g + cee * (gx[1][c] * f1_g + gx[2][c] * f2_g) +
                    cte * gx[3][c] * f3_g;
        const R vtt = warp_sum(gx[0][c] * f0);
        const R vte = warp_sum(gx[3][c] * f3);
        const R vee = warp_sum(gx[1][c] * f1 + gx[2][c] * f2);
        if (lane == 0) {
          wsum[warp][u][c][0] = vtt;
          wsum[warp][u][c][1] = vte;
          wsum[warp][u][c][2] = vee;
        }
      }
    }
    __syncthreads();  // every warp's sums of this chunk are in
    for (int e = threadIdx.x; e < n * CT12 * 3; e += blockDim.x) {
      const int u = e / (CT12 * 3), c = (e / 3) % CT12, q = e % 3;
      if (c0 + c >= C) continue;
      R v = R(0);
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) v += wsum[w][u][c][q];
      p2t_cl[(((size_t)blockIdx.x * C + c0 + c) * L + il0 + u) * 3 + q] = v;
    }
  }
  if (j >= nth) return;
#pragma unroll
  for (int c = 0; c < CT12; ++c) {
    if (c0 + c >= C) break;
    p2t_sg[(((size_t)s * 2 + 0) * C + c0 + c) * nth + j] = acc_s[c];
    p2t_sg[(((size_t)s * 2 + 1) * C + c0 + c) * nth + j] = acc_g[c];
  }
}

// ---- 1T: the cotangent of Cphil3 (partial over theta tiles) ----
__global__ void __launch_bounds__(THREADS)
bwd1_kernel(const R* __restrict__ th, const R* __restrict__ lt, const R* __restrict__ seeds,
            const R* __restrict__ gsg, R* __restrict__ p1t, int C, int L, int nth, int seg12) {
  __shared__ R rows[CH * N_LC];
  __shared__ R wsum[THREADS / 32][CH][CT12];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * THREADS + threadIdx.x;
  const int jj = j < nth ? j : nth - 1;
  const int s = blockIdx.y, c0 = blockIdx.z * CT12;
  const int il_begin = s * seg12, il_end = min(L, il_begin + seg12);
  const Theta t = load_theta(th, nth, jj);
  const R* sd = seeds + (size_t)(il_begin / SEG) * N_SD * nth + jj;
  R pmm = sd[SD_PMM * nth], pmmp1 = sd[SD_PMMP1 * nth];
  R a[CT12], b[CT12];
#pragma unroll
  for (int c = 0; c < CT12; ++c) {
    const bool on = c0 + c < C && j < nth;
    a[c] = on ? gsg[(size_t)(c0 + c) * nth + j] : R(0);
    b[c] = on ? gsg[((size_t)C + c0 + c) * nth + j] : R(0);
  }
  for (int il0 = il_begin; il0 < il_end; il0 += CH) {
    const int n = min(CH, il_end - il0);
    __syncthreads();
    stage_rows(rows, lt, il0, n);
    __syncthreads();
    for (int u = 0; u < n; ++u) {
      const R* r = rows + u * N_LC;
      const R P = legendre(r, t.x, pmm, pmmp1);
      pmm = pmmp1;
      pmmp1 = P;
      const R dP = r[LC_L] * (pmm - t.x * P) * t.inv_sin2;
      const R d11 = t.fac1 * dP * r[LC_INV_LLP1] + P;
      const R dm11 = t.fac2 * dP * r[LC_INV_LLP1] - P;
      const R om = R(1) - d11;
#pragma unroll
      for (int c = 0; c < CT12; ++c) {
        const R v = warp_sum(a[c] * om + b[c] * dm11);
        if (lane == 0) wsum[warp][u][c] = v;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * CT12; e += blockDim.x) {
      const int u = e / CT12, c = e % CT12;
      if (c0 + c >= C) continue;
      R v = R(0);
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) v += wsum[w][u][c];
      p1t[((size_t)blockIdx.x * C + c0 + c) * L + il0 + u] = v;
    }
  }
}

// gsg[v, c, theta] = sum over segments, in order, of p2t_sg[s, v, c, theta]
__global__ void bwd2_reduce_kernel(const R* __restrict__ p2t_sg, R* __restrict__ gsg, int n,
                                   int nseg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  R s = R(0);
  for (int k = 0; k < nseg; ++k) s += p2t_sg[(size_t)k * n + i];
  gsg[i] = s;
}

// g_cl[c, q, l] = sum over theta tiles, in order: q < 3 from p2t_cl, q = 3 from p1t
template <typename T>
__global__ void bwd_cl_kernel(const R* __restrict__ p2t_cl, const R* __restrict__ p1t,
                              T* __restrict__ g_cl, int C, int L, int ntiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * 4 * L) return;
  const int il = i % L, q = (i / L) % 4, c = i / (4 * L);
  R s = R(0);
  if (q < 3) {
    for (int k = 0; k < ntiles; ++k) s += p2t_cl[(((size_t)k * C + c) * L + il) * 3 + q];
  } else {
    for (int k = 0; k < ntiles; ++k) s += p1t[((size_t)k * C + c) * L + il];
  }
  g_cl[i] = T(s);
}

template <typename T>
int launch_bwd(const void* cl, const void* th, const void* lt, const void* seeds,
               const void* sgcg, const void* gsums, void* p3t, void* gxi, void* p2t_sg,
               void* gsg, void* p2t_cl, void* p1t, void* g_cl, int C, int L, int nth,
               int nl_out, int seg12, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (seg12 <= 0 || seg12 % SEG != 0 || nl_out > L) return (int)cudaErrorInvalidValue;
  const int ntiles = (nth + THREADS - 1) / THREADS;
  const int nseg = (L + seg12 - 1) / seg12, nseg3 = (nl_out + seg12 - 1) / seg12;
  const int groups12 = (C + CT12 - 1) / CT12;
  cudaError_t err;
  bwd3_kernel<T><<<dim3(ntiles, nseg3, groups12), THREADS, 0, st>>>(
      (const T*)gsums, (const R*)th, (const R*)lt, (const R*)seeds, (R*)p3t, C, nth, nl_out,
      seg12);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd3_reduce_kernel<<<(4 * C * nth + 255) / 256, 256, 0, st>>>((const R*)p3t, (const R*)th,
                                                                 (R*)gxi, C, nth, nseg3);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd2_kernel<T><<<dim3(ntiles, nseg, groups12), THREADS, 0, st>>>(
      (const T*)cl, (const R*)th, (const R*)lt, (const R*)seeds, (const R*)sgcg,
      (const R*)gxi, (R*)p2t_sg, (R*)p2t_cl, C, L, nth, seg12);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd2_reduce_kernel<<<(2 * C * nth + 255) / 256, 256, 0, st>>>((const R*)p2t_sg, (R*)gsg,
                                                                 2 * C * nth, nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd1_kernel<<<dim3(ntiles, nseg, groups12), THREADS, 0, st>>>(
      (const R*)th, (const R*)lt, (const R*)seeds, (const R*)gsg, (R*)p1t, C, L, nth, seg12);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_cl_kernel<T><<<(C * 4 * L + 255) / 256, 256, 0, st>>>((const R*)p2t_cl, (const R*)p1t,
                                                             (T*)g_cl, C, L, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

#define LENS_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(const void* cl, const void* th, const void* lt, const void* seeds,   \
                      void* part1, void* sgcg, void* part2, void* xi, void* part3,          \
                      void* sums, int C, int L, int nth, int nl_out, int seg12, int nsplit, \
                      void* stream) {                                                       \
    return launch<T>(cl, th, lt, seeds, part1, sgcg, part2, xi, part3, sums, C, L, nth,    \
                     nl_out, seg12, nsplit, stream);                                        \
  }

LENS_ENTRY(lensing_f32, float)
LENS_ENTRY(lensing_f64, double)

#define LENS_BWD_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(const void* cl, const void* th, const void* lt, const void* seeds,    \
                      const void* sgcg, const void* gsums, void* p3t, void* gxi,             \
                      void* p2t_sg, void* gsg, void* p2t_cl, void* p1t, void* g_cl, int C,   \
                      int L, int nth, int nl_out, int seg12, void* stream) {                 \
    return launch_bwd<T>(cl, th, lt, seeds, sgcg, gsums, p3t, gxi, p2t_sg, gsg, p2t_cl, p1t, \
                         g_cl, C, L, nth, nl_out, seg12, stream);                            \
  }

LENS_BWD_ENTRY(lensing_bwd_f32, float)
LENS_BWD_ENTRY(lensing_bwd_f64, double)
