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

// ===========================================================================
// The reverse pass (los_bwd): the cotangents of src (C, 4, nk, nt), chi
// (C, nt), wt (C, nt) and wl (C, nt) from those of the output g (3, C, nl,
// nkf), as autograd of models/cls.py:_los_plain gives them. j_l and j_l'
// are the table's linear interpolants in t = x inv_dx with the index
// truncated (no gradient through it), so their derivative in x is the
// interpolant's slope, (J[i+1] - J[i]) inv_dx; max(x, 1e-8) passes none
// below 1e-8.
//
// Per (chain, fine k, tau) point the backward needs eight sums over the
// sampled l of the cotangents times the table values and differences:
//   c_* = sum_l G_* J_l[i],  b_* = sum_l G_* (J_l[i+1] - J_l[i])
// for G_* in (G_T, G_T l(l+1) + G_E efac, G_P) against j_l and G_T against
// j_l'; then the interpolated sums are c + f b, and every cotangent of the
// point is a few products of them with the sources and 1/x (see below).
//
// Design: a block owns (chain, KT = 32 fine k, a tile of TT tau nodes), a
// lane a k, the 8 warps the tile's tau nodes; the block's cotangents G
// (3 x nl x 32) are staged in shared memory once. Each lane walks the nl
// sampled l for its (k, tau), gathering the packed (j_l, j_l') pairs as the
// forward does. The cotangents of chi, wt, wl are sums over k: a warp
// butterfly over the block's 32 k, then the k blocks in order (a second
// kernel). The source cotangent scatters from the fine k to the coarse rows
// through the transposed stencil: the block adds, per coarse row its
// stencils touch (a contiguous range, idx is monotone in k) and per tau,
// its lanes' contributions in lane order into a partial row of its own
// (`blk_off`, host-built); a third kernel adds the k blocks that touch a
// row (`row_kb`) in block order. No atomics: each output has one owner and
// its sums a fixed order, so a chain's cotangents do not depend on the
// other chains and repeated runs agree bit for bit.
//
// Bound (chip_smoke.py counts it): per (chain, l, k, tau) point two
// differences, G_T l(l+1) + G_E efac and eight multiply-adds (20
// operations), per (chain, k, tau) the interpolation, the forward's
// per-point terms and the products above (~88): ~1.8e11 FP32 operations at
// the flagship's shape, ~2.6 ms, compute-bound; in practice the table
// gathers, as in the forward.
// ===========================================================================

constexpr int BWD_THREADS = 256;  // 8 warps

// tau nodes a reverse block owns (16 in float64 so that two blocks fit an SM)
template <typename T>
struct BwdTile {
  static constexpr int TT = sizeof(T) == 4 ? 32 : 16;
};

template <typename T>
size_t bwd_smem_bytes(int nl, int rspan) {
  constexpr int TT = BwdTile<T>::TT;
  return (size_t)3 * nl * KT * sizeof(T)   // G_T, G_E efac, G_P
         + (size_t)nl * sizeof(T)          // l(l+1)
         + (size_t)4 * TT * KT * sizeof(T)  // cotangents of the interpolated sources
         + (size_t)KT * 5 * sizeof(T)      // stencil weights, k
         + (size_t)KT * 4 * sizeof(int)    // stencil rows
         + (size_t)2 * rspan * sizeof(int);  // each local row's first and last lane
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o);
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
los_bwd_kernel(const T* __restrict__ src, const int* __restrict__ idx, const T* __restrict__ w,
               const T* __restrict__ kf, const T* __restrict__ chi, const T* __restrict__ wt,
               const T* __restrict__ wl, const float2* __restrict__ tab,
               const T* __restrict__ ls, const T* __restrict__ g,
               const int* __restrict__ blk_off, T* __restrict__ part_src,
               T* __restrict__ part_w, int C, int nk, int nt, int nl, int nx, int nkf,
               T inv_dx, int rspan, int rtot) {
  constexpr int TT = BwdTile<T>::TT;
  constexpr int NW = BWD_THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* G = reinterpret_cast<T*>(smem_raw);  // [3][nl][KT]
  T* llp1 = G + 3 * nl * KT;              // [nl]
  T* Bs = llp1 + nl;                      // [4][TT][KT]
  T* kw_s = Bs + 4 * TT * KT;             // [KT][4]
  T* kf_s = kw_s + 4 * KT;                // [KT]
  int* ki_s = reinterpret_cast<int*>(kf_s + KT);  // [KT][4], rows relative to r_lo
  int* klo = ki_s + 4 * KT;               // [rspan]
  int* khi = klo + rspan;                 // [rspan]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = blockIdx.x, nkb = gridDim.x, k0 = kb * KT, t0 = blockIdx.y * TT;
  const int c = blockIdx.z;
  const int nkt = min(KT, nkf - k0);
  const int r_lo = idx[k0 * 4], r_hi = idx[(k0 + nkt - 1) * 4 + 3];
  const int nr = r_hi - r_lo + 1;  // <= rspan
  const size_t plane = (size_t)nk * nt, gplane = (size_t)C * nl * nkf;

  for (int e = tid; e < nl * KT; e += BWD_THREADS) {
    const int il = e / KT, kl = e % KT;
    T gT = T(0), gE = T(0), gP = T(0);
    if (kl < nkt) {
      const size_t o = ((size_t)c * nl + il) * nkf + k0 + kl;
      const T l = ls[il];
      gT = g[o];
      gE = g[gplane + o] * xsqrt(xmax((l + T(2)) * (l + T(1)) * l * (l - T(1)), T(0)));
      gP = g[2 * gplane + o];
    }
    G[e] = gT;
    G[nl * KT + e] = gE;
    G[2 * nl * KT + e] = gP;
  }
  for (int il = tid; il < nl; il += BWD_THREADS) {
    const T l = ls[il];
    llp1[il] = l * (l + T(1));
  }
  for (int e = tid; e < KT * 4; e += BWD_THREADS) {
    const int kl = e >> 2, kk = k0 + (kl < nkt ? kl : nkt - 1);
    kw_s[e] = w[kk * 4 + (e & 3)];
    ki_s[e] = idx[kk * 4 + (e & 3)] - r_lo;
  }
  for (int kl = tid; kl < KT; kl += BWD_THREADS) kf_s[kl] = kf[k0 + (kl < nkt ? kl : nkt - 1)];
  __syncthreads();
  for (int rr = tid; rr < nr; rr += BWD_THREADS) {
    int lo = KT, hi = -1;
    for (int kl = 0; kl < nkt; ++kl)
      if (ki_s[kl * 4] <= rr && rr <= ki_s[kl * 4 + 3]) {
        lo = min(lo, kl);
        hi = kl;
      }
    klo[rr] = lo;
    khi[rr] = hi;
  }

  const T* S = src + (size_t)c * 4 * plane;
  const T* chi_c = chi + (size_t)c * nt;
  const T* wt_c = wt + (size_t)c * nt;
  const T* wl_c = wl + (size_t)c * nt;
  const T kfl = kf_s[lane];
  for (int tl = warp; tl < TT; tl += NW) {
    const int t = t0 + tl;
    const bool on = lane < nkt && t < nt;
    const int tc = t < nt ? t : nt - 1;
    const T x = kfl * chi_c[tc];
    const T tt = x * inv_dx;
    int i = (int)tt;
    i = i < 0 ? 0 : (i > nx - 2 ? nx - 2 : i);
    const T f = tt - T(i);
    T c1 = T(0), c2 = T(0), c3 = T(0), c5 = T(0);
    T b1 = T(0), b2 = T(0), b3 = T(0), b5 = T(0);
    const float2* tp = tab + i;
    for (int il = 0; il < nl; ++il) {
      const float2 a = tp[(size_t)il * nx], bb = tp[(size_t)il * nx + 1];
      const T ax = T(a.x), ay = T(a.y);
      const T dj = T(bb.x) - ax, dp = T(bb.y) - ay;
      const T gT = G[il * KT + lane];
      const T gLE = gT * llp1[il] + G[(nl + il) * KT + lane];  // G_T l(l+1) + G_E efac
      const T gP = G[(2 * nl + il) * KT + lane];
      c1 += gT * ax;
      c2 += gT * ay;
      c3 += gLE * ax;
      c5 += gP * ax;
      b1 += gT * dj;
      b2 += gT * dp;
      b3 += gLE * dj;
      b5 += gP * dj;
    }
    // the sums against the interpolants j_l (a1, a3, a5) and j_l' (a2)
    const T a1 = c1 + f * b1, a2 = c2 + f * b2, a3 = c3 + f * b3, a5 = c5 + f * b5;
    const T inv = T(1) / xmax(x, T(1e-8));
    const T inv2 = inv * inv;
    const T dinv = x > T(1e-8) ? -inv2 : T(0);
    T s[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const T* sp = S + p * plane + (size_t)r_lo * nt + tc;
      s[p] = kw_s[lane * 4 + 0] * sp[(size_t)ki_s[lane * 4 + 0] * nt] +
             kw_s[lane * 4 + 1] * sp[(size_t)ki_s[lane * 4 + 1] * nt] +
             kw_s[lane * 4 + 2] * sp[(size_t)ki_s[lane * 4 + 2] * nt] +
             kw_s[lane * 4 + 3] * sp[(size_t)ki_s[lane * 4 + 3] * nt];
    }
    const T wtt = wt_c[tc], wlt = wl_c[tc];
    // the cotangents of the weighted sources S0w, S1w, S2w, SLw at (k, tau)
    const T A0 = a1, A1 = a2, A2 = -T(2) * inv * a2 + inv2 * a3 - a1, AL = a5;
    // and of x
    const T AX = inv_dx * (s[0] * wtt * b1 + s[1] * wtt * b2 +
                           s[2] * wtt * (-T(2) * inv * b2 + inv2 * b3 - b1) + s[3] * wlt * b5) +
                 s[2] * wtt * dinv * (-T(2) * a2 + T(2) * inv * a3);
    const T v_wt = warp_sum(on ? A0 * s[0] + A1 * s[1] + A2 * s[2] : T(0));
    const T v_wl = warp_sum(on ? AL * s[3] : T(0));
    const T v_chi = warp_sum(on ? kfl * AX : T(0));
    if (lane == 0 && t < nt) {
      T* pw = part_w + (((size_t)c * nkb + kb) * 3) * nt + t;
      pw[0] = v_chi;
      pw[nt] = v_wt;
      pw[2 * (size_t)nt] = v_wl;
    }
    const int o = tl * KT + lane;
    Bs[o] = on ? A0 * wtt : T(0);
    Bs[TT * KT + o] = on ? A1 * wtt : T(0);
    Bs[2 * TT * KT + o] = on ? A2 * wtt : T(0);
    Bs[3 * TT * KT + o] = on ? AL * wlt : T(0);
  }
  __syncthreads();
  // the transposed stencil: this block's share of each coarse row it touches
  for (int e = tid; e < 4 * nr * TT; e += BWD_THREADS) {
    const int tl = e % TT, rr = (e / TT) % nr, p = e / (TT * nr);
    const int t = t0 + tl;
    if (t >= nt) continue;
    T acc = T(0);
    for (int kl = klo[rr]; kl <= khi[rr]; ++kl) {
      const T b = Bs[(p * TT + tl) * KT + kl];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (ki_s[kl * 4 + m] == rr) acc += kw_s[kl * 4 + m] * b;
    }
    part_src[(((size_t)c * 4 + p) * rtot + blk_off[kb] + rr) * nt + t] = acc;
  }
}

// g_src[c, p, r, t] = sum over the k blocks that touch row r, in order
template <typename T>
__global__ void los_bwd_rows_kernel(const T* __restrict__ part_src,
                                    const int* __restrict__ blk_off,
                                    const int* __restrict__ row_kb, const int* __restrict__ idx,
                                    T* __restrict__ g_src, int C, int nk, int nt, int rtot) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)C * 4 * nk * nt) return;
  const int t = (int)(i % nt), r = (int)((i / nt) % nk);
  const size_t cp = i / ((size_t)nk * nt);
  T acc = T(0);
  for (int kb = row_kb[2 * r]; kb <= row_kb[2 * r + 1]; ++kb)
    acc += part_src[(cp * rtot + blk_off[kb] + r - idx[kb * KT * 4]) * nt + t];
  g_src[i] = acc;
}

// g_chi, g_wt, g_wl [c, t] = sum over the k blocks, in order
template <typename T>
__global__ void los_bwd_w_kernel(const T* __restrict__ part_w, T* __restrict__ g_chi,
                                 T* __restrict__ g_wt, T* __restrict__ g_wl, int C, int nkb,
                                 int nt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * nt) return;
  const int t = i % nt, c = i / nt;
  T s0 = T(0), s1 = T(0), s2 = T(0);
  for (int kb = 0; kb < nkb; ++kb) {
    const T* pw = part_w + (((size_t)c * nkb + kb) * 3) * nt + t;
    s0 += pw[0];
    s1 += pw[nt];
    s2 += pw[2 * (size_t)nt];
  }
  g_chi[i] = s0;
  g_wt[i] = s1;
  g_wl[i] = s2;
}

template <typename T>
int launch_bwd(const void* src, const void* idx, const void* w, const void* kf, const void* chi,
               const void* wt, const void* wl, const void* tab, const void* ls, const void* g,
               const void* blk_off, const void* row_kb, void* part_src, void* part_w,
               void* g_src, void* g_chi, void* g_wt, void* g_wl, int C, int nk, int nt, int nl,
               int nx, int nkf, double inv_dx, int rspan, int rtot, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rspan <= 0 || rspan > nk || nl <= 0 || nkf <= 0 || nt <= 0 || rtot <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int TT = BwdTile<T>::TT;
  const size_t smem = bwd_smem_bytes<T>(nl, rspan);
  cudaError_t err = cudaFuncSetAttribute(los_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (nkf + KT - 1) / KT;
  los_bwd_kernel<T><<<dim3(nkb, (nt + TT - 1) / TT, C), BWD_THREADS, smem, st>>>(
      (const T*)src, (const int*)idx, (const T*)w, (const T*)kf, (const T*)chi, (const T*)wt,
      (const T*)wl, (const float2*)tab, (const T*)ls, (const T*)g, (const int*)blk_off,
      (T*)part_src, (T*)part_w, C, nk, nt, nl, nx, nkf, (T)inv_dx, rspan, rtot);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t nsrc = (size_t)C * 4 * nk * nt;
  los_bwd_rows_kernel<T><<<(unsigned)((nsrc + 255) / 256), 256, 0, st>>>(
      (const T*)part_src, (const int*)blk_off, (const int*)row_kb, (const int*)idx, (T*)g_src,
      C, nk, nt, rtot);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  los_bwd_w_kernel<T><<<(C * nt + 255) / 256, 256, 0, st>>>((const T*)part_w, (T*)g_chi,
                                                           (T*)g_wt, (T*)g_wl, C, nkb, nt);
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

#define LOS_BWD_ENTRY(NAME, T)                                                                \
  extern "C" int NAME(const void* src, const void* idx, const void* w, const void* kf,       \
                      const void* chi, const void* wt, const void* wl, const void* tab,      \
                      const void* ls, const void* g, const void* blk_off, const void* row_kb, \
                      void* part_src, void* part_w, void* g_src, void* g_chi, void* g_wt,    \
                      void* g_wl, int C, int nk, int nt, int nl, int nx, int nkf,            \
                      double inv_dx, int rspan, int rtot, void* stream) {                    \
    return launch_bwd<T>(src, idx, w, kf, chi, wt, wl, tab, ls, g, blk_off, row_kb,         \
                         part_src, part_w, g_src, g_chi, g_wt, g_wl, C, nk, nt, nl, nx, nkf, \
                         inv_dx, rspan, rtot, stream);                                       \
  }

LOS_BWD_ENTRY(los_bwd_f32, float)
LOS_BWD_ENTRY(los_bwd_f64, double)
