// K3: lensed CMB spectra by the curved-sky correlation-function method.
//
// Replaces cosmomc_tpu/models/lensing.py:lens_cls (the lax.scans over l at
// lensing.py:136, :247 and :287). One thread owns one (chain, theta) lane
// and runs the three passes over l in sequence: pass 1 accumulates
// sigma^2(theta) and C_gl2(theta), pass 2 the four correlation deltas
// xi_i(theta) with the Legendre recurrence and the stable upward Jacobi
// recurrences for the high-spin Wigner-d functions (the float32 fix; no
// closed forms in P_l, P_l'), pass 3 projects back: for every output l the
// lane's four products xi_i d^l(theta) are reduced over the warp with
// shuffles in a fixed order and lane 0 stores the warp's partial sums.
// A second kernel adds the partials of all warps in warp order, so the
// result does not depend on scheduling (no atomics). C_l values are staged
// through shared memory in tiles of TL multipoles.
//
// Precision: T is the storage type of the spectra and the output; the
// theta table is float64, and every recurrence, Wigner-d function and sum
// is computed in float64 (type R).
// The low-spin d's that stay in closed form (d11, d22, d20, ...) divide
// differences of P_l and P_l' by sin^2(theta); in float32 that loses the
// lensed TE and BB at high l (measured on an NVIDIA H100 at 700 W, smooth
// test spectra, lmax 2658 -> 2508: the plain float32 version misses
// float64 by 1.2e-3 of TE's maximum and 220% of BB's, a float32 kernel by
// 8.7e-3 and 320%), and float64 costs 9.9 ms against 6.1 ms for 8 chains.
// Bound: pass 2, ~250 flops per (l, theta) over 2657 l x 5315 theta per
// chain, compute-bound in FP64; the l recurrence is sequential inside each
// thread.
//
// The arithmetic mirrors models/lensing.py:_passes_plain.
#include "common.cuh"

namespace {

enum { TH_X, TH_SIN, TH_SIN2, TH_FAC1, TH_FAC2, TH_TAIL, TH_SW, N_TH };
constexpr int TL = 128;       // multipoles per shared-memory tile
constexpr int THREADS = 128;  // models/lensing.py:_passes_cuda threads

template <typename T>
__device__ __forceinline__ T jacobi(T n, T a, T b, T x, T jm1, T j) {
  if (n < T(0)) return T(0);
  if (n == T(0)) return T(1);
  const T apb = a + b;
  if (n == T(1)) return (a + T(1)) + (apb + T(2)) * (x - T(1)) / T(2);
  const T c1 = T(2) * n * (n + apb) * (T(2) * n + apb - T(2));
  const T c2 = (T(2) * n + apb - T(1)) * (a * a - b * b);
  const T c3 = (T(2) * n + apb - T(1)) * (T(2) * n + apb) * (T(2) * n + apb - T(2));
  const T c4 = T(2) * (n + a - T(1)) * (n + b - T(1)) * (T(2) * n + apb);
  return ((c2 + c3 * x) * j - c4 * jm1) / (c1 != T(0) ? c1 : T(1));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
lens_kernel(const T* __restrict__ cl, const double* __restrict__ th,
            double* __restrict__ partial, int L, int nth, int nl_out, int n_warps) {
  using R = double;
  __shared__ R tile[4][TL];
  const int c = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = j < nth;
  const int jj = active ? j : 0;  // inactive lanes run on a valid theta
  const R x = th[TH_X * nth + jj], sinth = th[TH_SIN * nth + jj];
  const R sin2 = th[TH_SIN2 * nth + jj], fac1 = th[TH_FAC1 * nth + jj];
  const R fac2 = th[TH_FAC2 * nth + jj];
  const R tail = th[TH_TAIL * nth + jj], sw = th[TH_SW * nth + jj];
  const R sin2half = fac1 / R(2), cos2half = fac2 / R(2);
  const R fac = fac1 / fac2;
  const T* clc = cl + (size_t)c * 4 * L;

  // ---- pass 1: sigma^2, C_gl2 ----
  R sig = R(0), cg2 = R(0), pmm = R(1), pmmp1 = x;
  for (int l0 = 0; l0 < L; l0 += TL) {
    __syncthreads();
    for (int u = threadIdx.x; u < TL; u += blockDim.x)
      tile[3][u] = (l0 + u < L) ? R(clc[3 * L + l0 + u]) : R(0);
    __syncthreads();
    const int n = min(TL, L - l0);
    for (int u = 0; u < n; ++u) {
      R l = R(l0 + u + 2);
      const R P = ((R(2) * l - R(1)) * x * pmmp1 - (l - R(1)) * pmm) / l;
      pmm = pmmp1;
      pmmp1 = P;
      l = l + R(1);
      const R dP = (l - R(1)) * (pmm - x * P) / sin2;
      const R d11 = fac1 * dP / ((l - R(1)) * l) + P;
      const R dm11 = fac2 * dP / ((l - R(1)) * l) - P;
      sig = sig + (R(1) - d11) * tile[3][u];
      cg2 = cg2 + dm11 * tile[3][u];
    }
  }
  const R sigmasq = sig, Cg2 = cg2, Cg2sq = cg2 * cg2;

  // ---- pass 2: xi_0..3 ----
  R xi0 = R(0), xi1 = R(0), xi2 = R(0), xi3 = R(0);
  R j40m1 = R(0), j40 = R(0), j44m1 = R(0), j44 = R(0), j80m1 = R(0), j80 = R(0);
  pmm = R(1);
  pmmp1 = x;
  for (int l0 = 0; l0 < L; l0 += TL) {
    __syncthreads();
    for (int u = threadIdx.x; u < TL; u += blockDim.x)
#pragma unroll
      for (int q = 0; q < 3; ++q) tile[q][u] = (l0 + u < L) ? R(clc[q * L + l0 + u]) : R(0);
    __syncthreads();
    const int n = min(TL, L - l0);
    for (int u = 0; u < n; ++u) {
      const R lc = R(l0 + u + 2);
      const R P = ((R(2) * lc - R(1)) * x * pmmp1 - (lc - R(1)) * pmm) / lc;
      pmm = pmmp1;
      pmmp1 = P;
      const R J40 = jacobi(lc - R(2), R(4), R(0), x, j40m1, j40);
      const R J44 = jacobi(lc - R(4), R(4), R(4), x, j44m1, j44);
      const R J80 = jacobi(lc - R(4), R(8), R(0), x, j80m1, j80);
      j40m1 = j40; j40 = J40;
      j44m1 = j44; j44 = J44;
      j80m1 = j80; j80 = J80;
      const R llp1 = lc * (lc + R(1));
      const R lfacs2 = (lc + R(2)) * (lc - R(1));
      const R lrootfacs = xsqrt(llp1 * lfacs2);
      const R rf1 = xsqrt(lfacs2);
      const R rf2 = xsqrt((lc + R(3)) * (lc - R(2)));
      const R rf3 = xsqrt(xmax((lc - R(3)) * (lc + R(4)), R(0)));
      const R dP = lc * (pmm - x * P) / sin2;
      const R d11 = fac1 * dP / llp1 + P;
      const R dm11 = fac2 * dP / llp1 - P;
      const R d22 = (((R(4) * x - R(8)) / fac2 + llp1) * P +
                     R(4) * fac * (fac2 + (x - R(2)) / llp1) * dP) / lfacs2;
      const R d2m2 = sin2half * sin2half * J40;
      const R d20 = (R(2) * x * dP - llp1 * P) / lrootfacs;
      const R d1m2 = sinth / rf1 * (dP - R(2) / fac1 * dm11);
      const R d12 = sinth / rf1 * (dP - R(2) / fac2 * d11);
      const R sinfac = R(4) / sinth;
      R d1m3 = R(0), d2m3 = R(0), d3m3 = R(0), d13 = R(0);
      if (lc >= R(3)) {
        d1m3 = (-(x + R(0.5)) * d1m2 * sinfac - lfacs2 * dm11 / rf1) / rf2;
        d2m3 = (-fac2 * d2m2 * sinfac - rf1 * d1m2) / rf2;
        d3m3 = (-(x + R(1.5)) * d2m3 * sinfac - rf1 * d1m3) / rf2;
        d13 = ((x - R(0.5)) * d12 * sinfac - lfacs2 * d11 / rf1) / rf2;
      }
      R d04 = R(0), d2m4 = R(0), d4m4 = R(0);
      if (lc >= R(4)) {
        const R s4 = lc - R(4);
        const R norm04 = xsqrt(((s4 + R(5)) * (s4 + R(6)) * (s4 + R(7)) * (s4 + R(8))) /
                               ((s4 + R(1)) * (s4 + R(2)) * (s4 + R(3)) * (s4 + R(4))));
        const R sc = sin2half * cos2half;
        d04 = norm04 * (sc * sc) * J44;
        d2m4 = (-(R(6) * x + R(4)) * d2m3 / sinth - rf2 * d2m2) / rf3;
        const R s2h2 = sin2half * sin2half;
        d4m4 = s2h2 * s2h2 * J80;
      }
      const R X000 = xexp(-llp1 * sigmasq / R(4));
      const R X022 = X000 * (R(1) + sigmasq);
      const R X220 = lrootfacs / R(4) * X000;
      const R X121 = -R(0.5) * rf1 * X000;
      const R X132 = -R(0.5) * rf2 * X000;
      const R X242 = R(0.25) * rf2 * rf3 * X022;
      const R dX000 = -llp1 / R(4) * X000;
      const R dX022 = (R(1) - llp1 / R(4)) * X022;
      const R fac1v = dX000 * dX000;
      const R fac3 = X220 * X220;
      R f = ((X000 * X000 - R(1)) + Cg2sq * fac1v) * P + Cg2sq * fac3 * d2m2 +
            R(8) / llp1 * fac1v * Cg2 * dm11;
      xi0 = xi0 + tile[0][u] * f;
      const R fac2v = (Cg2 * dX022) * (Cg2 * dX022) + (X022 * X022 - R(1));
      f = R(2) * Cg2 * X121 * X132 * d13 + fac2v * d22 + Cg2sq * X242 * X220 * d04;
      xi1 = xi1 + tile[2][u] * f;
      f = (fac3 * P + X242 * X242 * d4m4) * Cg2sq / R(2) +
          Cg2 * (X121 * X121 * dm11 + X132 * X132 * d3m3) + fac2v * d2m2;
      xi2 = xi2 + tile[2][u] * f;
      f = (X000 * X022 - R(1)) * d20 +
          R(2) * dX000 * Cg2 * (X121 * d11 + X132 * d1m3) / xsqrt(llp1) +
          Cg2sq * (X220 / R(2) * d2m4 * X242 + (fac3 / R(2) + dX022 * dX000) * d20);
      xi3 = xi3 + tile[1][u] * f;
    }
  }
  const R xt = xi0 * tail * sw, xp = xi1 * tail * sw;
  const R xm = xi2 * tail * sw, xx = xi3 * tail * sw;

  // ---- pass 3: per-warp partial sums of xi_i d^l ----
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  R* pw = partial + ((size_t)c * n_warps + warp) * nl_out * 4;
  pmm = R(1);
  pmmp1 = x;
  j40m1 = R(0);
  j40 = R(0);
  for (int il = 0; il < nl_out; ++il) {
    const R lc = R(il + 2);
    const R P = ((R(2) * lc - R(1)) * x * pmmp1 - (lc - R(1)) * pmm) / lc;
    pmm = pmmp1;
    pmmp1 = P;
    const R llp1 = lc * (lc + R(1));
    const R lfacs2 = (lc + R(2)) * (lc - R(1));
    const R lrootfacs = xsqrt(llp1 * lfacs2);
    const R dP = lc * (pmm - x * P) / sin2;
    const R d22 = (((R(4) * x - R(8)) / fac2 + llp1) * P +
                   R(4) * fac * (fac2 + (x - R(2)) / llp1) * dP) / lfacs2;
    const R J40 = jacobi(lc - R(2), R(4), R(0), x, j40m1, j40);
    j40m1 = j40;
    j40 = J40;
    const R d2m2 = sin2half * sin2half * J40;
    const R d20 = (R(2) * x * dP - llp1 * P) / lrootfacs;
    const R v0 = warp_sum(active ? xt * P : R(0));
    const R v1 = warp_sum(active ? xp * d22 : R(0));
    const R v2 = warp_sum(active ? xm * d2m2 : R(0));
    const R v3 = warp_sum(active ? xx * d20 : R(0));
    if (lane == 0) {
      pw[il * 4 + 0] = v0;
      pw[il * 4 + 1] = v1;
      pw[il * 4 + 2] = v2;
      pw[il * 4 + 3] = v3;
    }
  }
}

// sums[c, l, q] = sum over warps, in warp order, of partial[c, w, l, q]
template <typename T>
__global__ void reduce_kernel(const double* __restrict__ partial, T* __restrict__ sums,
                              int C, int nl_out, int n_warps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int per_chain = nl_out * 4;
  if (i >= C * per_chain) return;
  const int c = i / per_chain, r = i % per_chain;
  const double* p = partial + (size_t)c * n_warps * per_chain + r;
  double s = 0.0;
  for (int w = 0; w < n_warps; ++w) s += p[(size_t)w * per_chain];
  sums[i] = T(s);
}

template <typename T>
int launch(const void* cl, const void* th, void* partial, void* sums, int C, int L,
           int nth, int nl_out, int n_warps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((nth + THREADS - 1) / THREADS, C);
  if (grid.x * (THREADS / 32) != (unsigned)n_warps) return (int)cudaErrorInvalidValue;
  lens_kernel<T><<<grid, THREADS, 0, s>>>((const T*)cl, (const double*)th, (double*)partial,
                                          L, nth, nl_out, n_warps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = C * nl_out * 4;
  reduce_kernel<T><<<(n + 255) / 256, 256, 0, s>>>((const double*)partial, (T*)sums, C,
                                                   nl_out, n_warps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lensing_f32(const void* cl, const void* th, void* partial, void* sums,
                           int C, int L, int nth, int nl_out, int n_warps,
                           void* stream) {
  return launch<float>(cl, th, partial, sums, C, L, nth, nl_out, n_warps, stream);
}

extern "C" int lensing_f64(const void* cl, const void* th, void* partial, void* sums,
                           int C, int L, int nth, int nl_out, int n_warps,
                           void* stream) {
  return launch<double>(cl, th, partial, sums, C, L, nth, nl_out, n_warps, stream);
}
