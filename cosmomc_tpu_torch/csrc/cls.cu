// K2a: line-of-sight transfer functions Delta_l^{T,E,phi}(k), table engine.
//
// Replaces cosmomc_tpu/models/cls.py:compute_cl_transfers (the flat lax.map
// over (k-chunk, l-batch) at cls.py:285). One thread owns one (chain, fine
// k, batch of 4 sampled l) output and reduces over the strided tau nodes:
// per node it interpolates the four sources to its k with the host-built
// 4-point ln-k Lagrange stencil (fused, so the fine (k, tau) source plane
// never exists in memory), then for each of its 4 l's gathers j_l and j_l'
// from the float32 tables by linear interpolation, forms j_l'' from the
// Bessel ODE, and accumulates. Bound: ~1e9 (l, k, tau) points per chain at
// ~25 flops and two table gathers each; the tables (2 x 112 x 36264 floats,
// 32 MB) stay in the 50 MB L2, neighbouring k threads of a warp share most
// of their source rows, and a thread's 4 l's reuse one source
// interpolation. No atomics: each output has one owner.
//
// The arithmetic mirrors models/cls.py:_los_plain.
#include "common.cuh"

namespace {

constexpr int LB = 4;  // sampled l's per thread (models/cls.py L_BATCH)

template <typename T>
__global__ void __launch_bounds__(128)
los_kernel(const T* __restrict__ src, const int* __restrict__ idx,
           const T* __restrict__ w, const T* __restrict__ kf,
           const T* __restrict__ chi, const T* __restrict__ wt,
           const T* __restrict__ wl, const float* __restrict__ jl,
           const float* __restrict__ jlp, const T* __restrict__ ls,
           T* __restrict__ out, int C, int nk, int nt, int nl, int nx, int nkf,
           T inv_dx) {
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  const int lb = blockIdx.y;
  const int c = blockIdx.z;
  if (kk >= nkf) return;
  const T kc = kf[kk];
  T kw[4];
  const T* rows[4][4];  // [plane][stencil point]
  const size_t plane = (size_t)nk * nt;
  const T* S = src + (size_t)c * 4 * plane;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    kw[j] = w[kk * 4 + j];
    const int r = idx[kk * 4 + j];
#pragma unroll
    for (int p = 0; p < 4; ++p) rows[p][j] = S + p * plane + (size_t)r * nt;
  }
  const T* chi_c = chi + (size_t)c * nt;
  const T* wt_c = wt + (size_t)c * nt;
  const T* wl_c = wl + (size_t)c * nt;
  T lv[LB], aT[LB], aE[LB], aP[LB];
  const float* J[LB];
  const float* Jp[LB];
#pragma unroll
  for (int u = 0; u < LB; ++u) {
    const int il = lb * LB + u;
    lv[u] = ls[il];
    J[u] = jl + (size_t)il * nx;
    Jp[u] = jlp + (size_t)il * nx;
    aT[u] = aE[u] = aP[u] = T(0);
  }
  for (int t = 0; t < nt; ++t) {
    T s[4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      s[p] = kw[0] * rows[p][0][t] + kw[1] * rows[p][1][t] + kw[2] * rows[p][2][t] +
             kw[3] * rows[p][3][t];
    const T wtt = wt_c[t];
    const T s0 = s[0] * wtt, s1 = s[1] * wtt, s2 = s[2] * wtt, sL = s[3] * wl_c[t];
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
      aT[u] += s0 * jv + s1 * jp + s2 * jpp;
      aE[u] += s2 * jv * inv2;
      aP[u] += sL * jv;
    }
  }
  const size_t plane_out = (size_t)C * nl * nkf;
#pragma unroll
  for (int u = 0; u < LB; ++u) {
    const int il = lb * LB + u;
    const T l = lv[u];
    const T efac = xsqrt(xmax((l + T(2)) * (l + T(1)) * l * (l - T(1)), T(0)));
    const size_t o = ((size_t)c * nl + il) * nkf + kk;
    out[o] = aT[u];
    out[plane_out + o] = efac * aE[u];
    out[2 * plane_out + o] = aP[u];
  }
}

template <typename T>
int launch(const void* src, const void* idx, const void* w, const void* kf,
           const void* chi, const void* wt, const void* wl, const void* jl,
           const void* jlp, const void* ls, void* out, int C, int nk, int nt, int nl,
           int nx, int nkf, double inv_dx, void* stream) {
  const int threads = 128;
  dim3 grid((nkf + threads - 1) / threads, nl / LB, C);
  los_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)src, (const int*)idx, (const T*)w, (const T*)kf, (const T*)chi,
      (const T*)wt, (const T*)wl, (const float*)jl, (const float*)jlp, (const T*)ls,
      (T*)out, C, nk, nt, nl, nx, nkf, (T)inv_dx);
  return (int)cudaGetLastError();
}

}  // namespace

#define LOS_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* src, const void* idx, const void* w,             \
                      const void* kf, const void* chi, const void* wt,             \
                      const void* wl, const void* jl, const void* jlp,             \
                      const void* ls, void* out, int C, int nk, int nt, int nl,    \
                      int nx, int nkf, double inv_dx, void* stream) {               \
    return launch<T>(src, idx, w, kf, chi, wt, wl, jl, jlp, ls, out, C, nk, nt, nl, \
                     nx, nkf, inv_dx, stream);                                       \
  }

LOS_ENTRY(los_f32, float)
LOS_ENTRY(los_f64, double)
