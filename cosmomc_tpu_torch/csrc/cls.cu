// K2a: line-of-sight transfer functions Delta_l^{T,E,phi}(k), table engine.
//
// Replaces cosmomc_tpu/models/cls.py:compute_cl_transfers (the flat lax.map
// over (k-chunk, l-batch) at cls.py:285). For every (chain, sampled l, fine
// k) it sums over the strided tau nodes the four sources, interpolated to k
// with the host-built 4-point ln-k Lagrange stencil, times j_l and j_l'
// (linear interpolation in the float32 tables) and j_l'' from the Bessel
// ODE.
//
// Bound (chip_smoke.py counts it from the shapes): the least arithmetic
// that computes the function, 16 FP32 operations per (chain, l, k, tau)
// point (two lerps of 3, then five multiply-adds of 2 once j_l'' is
// folded in, below) and ~43 per (chain, k, tau) (interpolation, weights,
// the Bessel argument, the folded coefficients); ~8.1e9 points at 8
// chains x 109 l x 4521 k x 2048 tau: ~2.0 ms at the FP32 rate, so
// compute-bound (its inputs and outputs are ~145 MB, 0.04 ms).
// What sets the pace in practice is the load path: each point gathers a
// scattered table neighbour pair, and the 32 lanes of a warp (32 fine k,
// x = k (tau0 - tau) up to ~8 table entries apart) touch up to 32 sectors.
// Those sectors are reused by neighbouring lanes over the next tau nodes,
// so what decides the time is whether the SM's working set (warps x l's per
// warp x ~2 KB of table rows) stays in L1.
//
// Design:
// - a block owns (chain, KT = 32 fine k) and up to 8 warps of LPT = 8
//   sampled l's (7 warps, 56 l's at the main path's 112): a lane per k; the
//   sources are interpolated once per (chain, k, tau) for all the block's
//   l's, not once per 4 l's;
// - one block per SM (it asks for more than half of the shared memory), so
//   the SM's table working set is ~7 x 8 x 2 KB = 112 KB and stays in L1;
//   16 l's a warp, or two blocks an SM, double it and were slower on an
//   H100, as were 4 or 6 l's a warp (PERF.md);
// - per tile of TT tau nodes (64 in float32) the coarse source rows the
//   tile's stencils touch (a contiguous row range, idx is monotone in k)
//   arrive by cp.async into a double buffer while the previous tile is
//   computed; the tile's per-(k, tau) terms go to shared memory: the
//   coefficient of j_l without l, the coefficient of j_l', S2/x^2, the
//   lensing source and the table index and fraction of x;
// - the Bessel tables are packed as (j_l, j_l') float2 (models/cls.py
//   packed_bessel, built once with the plan; 32 MB, L2-resident), so a
//   point takes two 8-byte loads in place of four 4-byte ones, and j_l''
//   is folded into the j_l and j_l' coefficients: with B = S2/x^2,
//   S0 j + S1 j' + S2 j'' = j (S0 - S2 + l(l+1) B) + j' (S1 - 2 S2/x);
// - each output has one owner, summed over tau in order: no atomics.
//
// The arithmetic otherwise mirrors models/cls.py:_los_plain.
#include "common.cuh"

namespace {

constexpr int KT = 32;   // fine k per block (models/cls.py LOS_KT)
constexpr int LPT = 8;   // sampled l's per warp
constexpr int MAX_WARPS = 8;
// one block per SM: more than half of the 227 KB a block may take
constexpr size_t ONE_PER_SM = 114 * 1024 + 16;

// tau nodes per shared-memory tile (64 in float32, 32 in float64 to fit),
// and the padded coarse row
template <typename T>
struct Tile {
  static constexpr int TT = sizeof(T) == 4 ? 64 : 32;
  static constexpr int TP = TT + 1;
};

template <typename T>
size_t smem_bytes(int rspan) {
  constexpr int TT = Tile<T>::TT, TP = Tile<T>::TP;
  return (size_t)2 * 4 * rspan * TP * sizeof(T)   // coarse rows, double buffered
         + (size_t)5 * TT * KT * sizeof(T)         // per-(k, tau) terms
         + (size_t)TT * KT * sizeof(int)            // table index
         + (size_t)KT * (5 * sizeof(T) + 4 * sizeof(int));  // stencils, k
}

// The explicit 1 block per SM matters: without it ptxas holds the float32
// kernel to fewer registers, and it was slower on an H100 (PERF.md).
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
los_kernel(const T* __restrict__ src, const int* __restrict__ idx, const T* __restrict__ w,
           const T* __restrict__ kf, const T* __restrict__ chi, const T* __restrict__ wt,
           const T* __restrict__ wl, const float2* __restrict__ tab,
           const T* __restrict__ ls, T* __restrict__ out, int C, int nk, int nt, int nl, int nx,
           int nkf, T inv_dx, int rspan) {
  constexpr int TT = Tile<T>::TT, TP = Tile<T>::TP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rows = reinterpret_cast<T*>(smem_raw);         // [2][4][rspan][TP]
  T* sv = rows + 2 * 4 * rspan * TP;                // [5][TT][KT]: cJ, cP, B, sL, f
  T* kw_s = sv + 5 * TT * KT;                       // [KT][4]
  T* kf_s = kw_s + 4 * KT;                          // [KT]
  int* si = reinterpret_cast<int*>(kf_s + KT);      // [TT][KT]
  int* ki_s = si + TT * KT;                         // [KT][4], rows relative to r_lo

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int k0 = blockIdx.x * KT, c = blockIdx.z;
  const int nkt = min(KT, nkf - k0);
  const int r_lo = idx[k0 * 4], r_hi = idx[(k0 + nkt - 1) * 4 + 3];
  const int nr = r_hi - r_lo + 1;  // <= rspan (the wrapper's maximum)
  const size_t plane = (size_t)nk * nt;
  const T* S = src + (size_t)c * 4 * plane + (size_t)r_lo * nt;
  const T* chi_c = chi + (size_t)c * nt;
  const T* wt_c = wt + (size_t)c * nt;
  const T* wl_c = wl + (size_t)c * nt;

  for (int e = tid; e < KT * 4; e += nthreads) {
    const int kl = e >> 2, kk = k0 + (kl < nkt ? kl : nkt - 1);
    kw_s[e] = w[kk * 4 + (e & 3)];
    ki_s[e] = idx[kk * 4 + (e & 3)] - r_lo;
  }
  for (int kl = tid; kl < KT; kl += nthreads) kf_s[kl] = kf[k0 + (kl < nkt ? kl : nkt - 1)];

  auto stage = [&](int tile, int b) {
    const int t0 = tile * TT;
    for (int e = tid; e < 4 * nr * TT; e += nthreads) {
      const int tl = e % TT, rr = (e / TT) % nr, p = e / (TT * nr);
      if (t0 + tl < nt)
        cp_async(rows + ((b * 4 + p) * rspan + rr) * TP + tl,
                 S + p * plane + (size_t)rr * nt + t0 + tl);
    }
    cp_async_commit();
  };

  // this warp's sampled l's
  const int g = blockIdx.y * (nthreads >> 5) + warp;
  const int l_first = g * LPT;
  const bool busy = l_first < nl;
  T llp1[LPT], aT[LPT], aE[LPT], aP[LPT];
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const T l = ls[min(l_first + u, nl - 1)];
    llp1[u] = l * (l + T(1));
    aT[u] = aE[u] = aP[u] = T(0);
  }

  const int ntiles = (nt + TT - 1) / TT;
  stage(0, 0);
  for (int tile = 0; tile < ntiles; ++tile) {
    const int b = tile & 1, t0 = tile * TT;
    if (tile + 1 < ntiles) {
      stage(tile + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // rows[b] landed; the previous tile's terms are consumed
    const T* rb = rows + b * 4 * rspan * TP;
    for (int e = tid; e < KT * TT; e += nthreads) {
      const int kl = e % KT, tl = e / KT, t = t0 + tl;
      T cJ = T(0), cP = T(0), B = T(0), sL = T(0), f = T(0);
      int i = 0;
      if (kl < nkt && t < nt) {
        T s[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const T* rp = rb + p * rspan * TP + tl;
          s[p] = kw_s[kl * 4 + 0] * rp[ki_s[kl * 4 + 0] * TP] +
                 kw_s[kl * 4 + 1] * rp[ki_s[kl * 4 + 1] * TP] +
                 kw_s[kl * 4 + 2] * rp[ki_s[kl * 4 + 2] * TP] +
                 kw_s[kl * 4 + 3] * rp[ki_s[kl * 4 + 3] * TP];
        }
        const T wtt = wt_c[t];
        const T s0 = s[0] * wtt, s1 = s[1] * wtt, s2 = s[2] * wtt;
        sL = s[3] * wl_c[t];
        const T x = kf_s[kl] * chi_c[t];
        const T tt = x * inv_dx;
        i = (int)tt;
        i = i < 0 ? 0 : (i > nx - 2 ? nx - 2 : i);
        f = tt - T(i);
        const T inv = T(1) / xmax(x, T(1e-8));
        B = s2 * (inv * inv);
        cJ = s0 - s2;
        cP = s1 - T(2) * s2 * inv;
      }
      const int o = tl * KT + kl;
      sv[o] = cJ;
      sv[TT * KT + o] = cP;
      sv[2 * TT * KT + o] = B;
      sv[3 * TT * KT + o] = sL;
      sv[4 * TT * KT + o] = f;
      si[o] = i;
    }
    __syncthreads();  // the tile's terms are ready
    if (busy) {
      const int ntl = min(TT, nt - t0);
      for (int tl = 0; tl < ntl; ++tl) {
        const int o = tl * KT + lane;
        const T cJ = sv[o], cP = sv[TT * KT + o], B = sv[2 * TT * KT + o];
        const T sL = sv[3 * TT * KT + o], f = sv[4 * TT * KT + o];
        const T omf = T(1) - f;
        const float2* tp = tab + si[o];
#pragma unroll
        for (int u = 0; u < LPT; ++u) {
          const float2* row = tp + (size_t)min(l_first + u, nl - 1) * nx;
          const float2 a = row[0], b2 = row[1];
          const T jv = T(a.x) * omf + T(b2.x) * f;
          const T jp = T(a.y) * omf + T(b2.y) * f;
          aT[u] += jv * (cJ + llp1[u] * B) + jp * cP;
          aE[u] += B * jv;
          aP[u] += sL * jv;
        }
      }
    }
  }
  if (!busy || lane >= nkt) return;
  const int kk = k0 + lane;
  const size_t plane_out = (size_t)C * nl * nkf;
#pragma unroll
  for (int u = 0; u < LPT; ++u) {
    const int il = l_first + u;
    if (il >= nl) break;
    const T l = ls[il];
    const T efac = xsqrt(xmax((l + T(2)) * (l + T(1)) * l * (l - T(1)), T(0)));
    const size_t o = ((size_t)c * nl + il) * nkf + kk;
    out[o] = aT[u];
    out[plane_out + o] = efac * aE[u];
    out[2 * plane_out + o] = aP[u];
  }
}

template <typename T>
int launch(const void* src, const void* idx, const void* w, const void* kf, const void* chi,
           const void* wt, const void* wl, const void* tab, const void* ls, void* out, int C,
           int nk, int nt, int nl, int nx, int nkf, double inv_dx, int rspan, void* stream) {
  if (rspan <= 0 || rspan > nk || nl <= 0 || nkf <= 0 || nt <= 0)
    return (int)cudaErrorInvalidValue;
  const int groups = (nl + LPT - 1) / LPT;
  const int gy = (groups + MAX_WARPS - 1) / MAX_WARPS;
  const int warps = (groups + gy - 1) / gy;
  const size_t smem = smem_bytes<T>(rspan) > ONE_PER_SM ? smem_bytes<T>(rspan) : ONE_PER_SM;
  cudaError_t err = cudaFuncSetAttribute(los_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nkf + KT - 1) / KT, gy, C);
  los_kernel<T><<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)src, (const int*)idx, (const T*)w, (const T*)kf, (const T*)chi, (const T*)wt,
      (const T*)wl, (const float2*)tab, (const T*)ls, (T*)out, C, nk, nt, nl, nx, nkf,
      (T)inv_dx, rspan);
  return (int)cudaGetLastError();
}

}  // namespace

#define LOS_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(const void* src, const void* idx, const void* w, const void* kf,    \
                      const void* chi, const void* wt, const void* wl, const void* tab,   \
                      const void* ls, void* out, int C, int nk, int nt, int nl, int nx,   \
                      int nkf, double inv_dx, int rspan, void* stream) {                   \
    return launch<T>(src, idx, w, kf, chi, wt, wl, tab, ls, out, C, nk, nt, nl, nx, nkf,  \
                     inv_dx, rspan, stream);                                               \
  }

LOS_ENTRY(los_f32, float)
LOS_ENTRY(los_f64, double)
