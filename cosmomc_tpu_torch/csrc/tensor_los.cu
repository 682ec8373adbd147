// K6: tensor line-of-sight transfers Delta_l^{T,E,B}(k) (Zaldarriaga &
// Seljak 1997 tensor radial functions).
//
// Replaces cosmomc_tpu/models/tensors.py:compute_tensor_transfers (the
// lax.map over sampled l at tensors.py:352). One thread owns one (chain, fine
// k, batch of 4 sampled l) output and reduces over every tau node of the
// evolution grid: per node it interpolates the two sources linearly in ln k
// from the coarse tensor grid (bracket and weight host-built with jnp.interp's
// rule, so the fine (k, tau) source plane never exists in memory), then for
// each of its 4 l's gathers j_l and j_l' from the float32 tables by linear
// interpolation, forms j_l'' from the Bessel ODE and the three radial windows,
// and accumulates. Bound: 65 l x 610 k x 8192 tau per chain at ~40 flops and
// two table gathers each; the tables (2 x 68 x ~4930 floats, 2.7 MB) stay in
// L2, and a thread's 4 l's share one source interpolation. No atomics: each
// output has one owner, so results repeat bit for bit.
//
// The arithmetic mirrors models/tensors.py:_tlos_plain, except that 1/x and
// 1/x^2 are formed once per node and multiplied (the plain version divides).
#include "common.cuh"

namespace {

constexpr int LB = 4;  // sampled l's per thread (models/cls.py L_BATCH)

template <typename T>
__global__ void __launch_bounds__(128)
tlos_kernel(const T* __restrict__ src, const int* __restrict__ lo,
            const int* __restrict__ hi, const T* __restrict__ w,
            const T* __restrict__ kf, const T* __restrict__ chi,
            const T* __restrict__ wt, const float* __restrict__ jl,
            const float* __restrict__ jlp, const T* __restrict__ ls,
            T* __restrict__ out, int C, int nk, int N, int nl, int nx, int nkf,
            T inv_dx) {
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  const int lb = blockIdx.y;
  const int c = blockIdx.z;
  if (kk >= nkf) return;
  const T kc = kf[kk];
  const T wk = w[kk];
  const size_t plane = (size_t)nk * N;
  const T* S = src + (size_t)c * 2 * plane;
  const T* sT_lo = S + (size_t)lo[kk] * N;
  const T* sT_hi = S + (size_t)hi[kk] * N;
  const T* sP_lo = sT_lo + plane;
  const T* sP_hi = sT_hi + plane;
  const T* chi_c = chi + (size_t)c * N;
  const T* wt_c = wt + (size_t)c * N;
  T lv[LB], aT[LB], aE[LB], aB[LB];
  const float* J[LB];
  const float* Jp[LB];
#pragma unroll
  for (int u = 0; u < LB; ++u) {
    const int il = lb * LB + u;
    lv[u] = ls[il];
    J[u] = jl + (size_t)il * nx;
    Jp[u] = jlp + (size_t)il * nx;
    aT[u] = aE[u] = aB[u] = T(0);
  }
  for (int t = 0; t < N; ++t) {
    const T wtt = wt_c[t];
    const T sTw = (sT_lo[t] + wk * (sT_hi[t] - sT_lo[t])) * wtt;
    const T sPw = (sP_lo[t] + wk * (sP_hi[t] - sP_lo[t])) * wtt;
    const T x = kc * chi_c[t];
    const T tt = x * inv_dx;
    int i = (int)tt;
    i = i < 0 ? 0 : (i > nx - 2 ? nx - 2 : i);
    const T f = tt - T(i);
    const T inv = T(1) / xmax(x, T(1e-8));
    const T inv2 = inv * inv;
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const T jv = T(J[u][i]) * (T(1) - f) + T(J[u][i + 1]) * f;
      const T jp = T(Jp[u][i]) * (T(1) - f) + T(Jp[u][i + 1]) * f;
      const T l = lv[u];
      const T jpp = -T(2) * jp * inv + (l * (l + T(1)) * inv2 - T(1)) * jv;
      aT[u] += sTw * jv * inv2;
      aE[u] += sPw * (-jv + jpp + T(2) * jv * inv2 + T(4) * jp * inv);
      aB[u] += sPw * (T(2) * jp + T(4) * jv * inv);
    }
  }
  const size_t plane_out = (size_t)C * nl * nkf;
#pragma unroll
  for (int u = 0; u < LB; ++u) {
    const int il = lb * LB + u;
    const T l = lv[u];
    const T efac = xsqrt(xmax((l + T(2)) * (l + T(1)) * l * (l - T(1)), T(0)));
    const size_t o = ((size_t)c * nl + il) * nkf + kk;
    out[o] = efac * aT[u];
    out[plane_out + o] = aE[u];
    out[2 * plane_out + o] = aB[u];
  }
}

template <typename T>
int launch(const void* src, const void* lo, const void* hi, const void* w,
           const void* kf, const void* chi, const void* wt, const void* jl,
           const void* jlp, const void* ls, void* out, int C, int nk, int N, int nl,
           int nx, int nkf, double inv_dx, void* stream) {
  const int threads = 128;
  dim3 grid((nkf + threads - 1) / threads, nl / LB, C);
  tlos_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)src, (const int*)lo, (const int*)hi, (const T*)w, (const T*)kf,
      (const T*)chi, (const T*)wt, (const float*)jl, (const float*)jlp,
      (const T*)ls, (T*)out, C, nk, N, nl, nx, nkf, (T)inv_dx);
  return (int)cudaGetLastError();
}

}  // namespace

#define TLOS_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* src, const void* lo, const void* hi,             \
                      const void* w, const void* kf, const void* chi,              \
                      const void* wt, const void* jl, const void* jlp,             \
                      const void* ls, void* out, int C, int nk, int N, int nl,     \
                      int nx, int nkf, double inv_dx, void* stream) {               \
    return launch<T>(src, lo, hi, w, kf, chi, wt, jl, jlp, ls, out, C, nk, N, nl,  \
                     nx, nkf, inv_dx, stream);                                       \
  }

TLOS_ENTRY(tensor_los_f32, float)
TLOS_ENTRY(tensor_los_f64, double)
