// K2b: line-of-sight transfer functions Delta_l^{T,E,phi}(k), recurrence
// engine (no Bessel tables).
//
// Replaces cosmomc_tpu/models/cls.py:compute_cl_transfers_recurrence (the
// lax.scan at cls.py:473 over (k-chunk, l-superstep) pairs). One block owns
// one (chain, fine k); per tau node a thread interpolates the four sources to
// its k once (host-built 4-point ln-k Lagrange stencil) and then walks l =
// 2..lmax upward with (j_{l-1}, j_l) in registers:
//
//   j_l = ((2l-1)/x) j_{l-1} - j_{l-2}         (stable for x > l)
//   j_l = p_l (1 - y/(2l+3) + y^2/(2(2l+3)(2l+5))),  y = x^2/2,  where x^2 < l+1
//   j_l = 0                                      where x <= cut[l] = nu - 2.5 nu^(1/3)
//   p_l = min(p_{l-1} x/(2l+1), 1)
//
// starting from (j_0, j_1, min(x/3, 1)) with the x < 1e-3 small-x forms.
//
// Bound on this card: operations. Only the live lattice needs work: the
// (k, tau, l) points with x > cut[l]; below the cut every j is exactly 0.
// The design follows from that:
// - A warp owns a contiguous range of tau nodes: thread `lane` of warp w
//   holds nodes w 32 NPT + lane + 32 j. x = kf (tau0 - tau) falls along the
//   range, so a warp's nodes pass their cuts at nearby l.
// - Each node's first dead l, lcut = the first l >= 2 with cut[l] >= x, is
//   found once by bisection of the host-built cut table (non-decreasing in
//   l). `l < lcut` is the plain version's `x > cut[l]`, bit for bit.
// - A warp stops at l_stop = the largest lcut of its nodes: from there on
//   all its j are exactly 0, and so are its terms at every later sampled l.
//   Below the smallest lcut of its nodes, no select is needed: a step is one
//   product and one multiply-add a node.
// - The series branch is taken only below L0 (host-computed in the kernel's
//   dtype: from L0 on, x*x < l+1 implies x <= cut[l], so the series value is
//   one the cut always zeroes). Below L0 the step is the plain version's, its
//   divides included (L0 = 8 at the main path's lmax: six l's); from L0 on
//   the l loop holds no divide: 2l-1 is a float counter, exact.
// - A thread keeps only 1/x, (j_{l-1}, j_l) and lcut of its nodes in
//   registers (80 in float32: three 8-warp blocks an SM). What the sampled
//   l need of a node waits in shared memory: four coefficients into which
//   the weighted sources and 1/x fold (`coef_of`; six multiply-adds a node
//   at a sampled l) and the lensing source.
// - No block barrier in the l loop: at a sampled l each warp reduces its
//   three partial sums by shuffles, and lane 0 writes them to its (sample,
//   warp) slot in shared memory, zeroed first (a warp that stopped leaves
//   zeros). After the loop one pass adds the warps in warp order. No
//   atomics: results repeat bit for bit.
//
// The predicates match models/cls.py:_los_rec_plain bit for bit: x is one
// product kf * (tau0 - tau) in both, x*x < l+1 is a product and a compare,
// and the cut is the host table both read.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
// blocks an SM, which caps the registers a thread: three in float32 (85
// registers) and two in float64 (128), fewer where that many blocks' shared
// memory (at the main path's tables: lmax 2658, 109 sampled l; 1 KB
// reserved a block) exceeds an SM's 228 KB. From NPT = 8 on a float64 block
// holds ~123 KB, so one block an SM: a cap for two would only spill.
template <typename T, int NPT>
constexpr int min_blocks() {
  constexpr int fit = int((size_t)228 * 1024 /
                          (((size_t)5 * THREADS * NPT + 109 * NWARP * 3 + 2659) * sizeof(T) +
                           109 * sizeof(int) + 1024));
  constexpr int cap = sizeof(T) == 4 ? 3 : 2;
  return fit < 1 ? 1 : (fit < cap ? fit : cap);
}

__device__ __forceinline__ float xsin(float x) { return sinf(x); }
__device__ __forceinline__ double xsin(double x) { return sin(x); }
__device__ __forceinline__ float xcos(float x) { return cosf(x); }
__device__ __forceinline__ double xcos(double x) { return cos(x); }

// one thread's nodes: 1/x, the recurrence state and each node's first
// dead l (what the sampled l need waits in shared memory)
template <typename T, int NPT>
struct Nodes {
  T ix[NPT], jm1[NPT], jl[NPT];
  int lcut[NPT];
};

template <typename T>
struct alignas(4 * sizeof(T)) Coef {
  T a, b, d, e;
};

// A node's terms at a sampled l, with i = 1/x and the weighted sources s0,
// s1, s2 (T and E) and sL (phi):
//   s0 j_l + s1 j_l' + s2 j_l'' = j_l (a + (l+1) b + l(l+1) d) + j_{l-1} e,
//   s2 j_l / x^2 = d j_l,
// where j_l' = j_{l-1} - (l+1) i j_l, j_l'' = -2 i j_l' + (l(l+1) i^2 - 1) j_l
// and a = s0 - s2, b = 2 s2 i^2 - s1 i, d = s2 i^2, e = s1 - 2 s2 i: the
// least arithmetic at the sampled l (the plain version's sums, regrouped).
template <typename T>
__device__ __forceinline__ Coef<T> coef_of(const T (&sv)[4], T i1) {
  const T i2 = i1 * i1;
  return {sv[0] - sv[2], T(2) * sv[2] * i2 - sv[1] * i1, sv[2] * i2,
          sv[1] - T(2) * sv[2] * i1};
}

// the warp's three sums at the sampled l (the state holds j_{l-1}, j_l);
// `cw` and `lw` point at the thread's first node's coefficients and sL
template <typename T, int NPT>
__device__ __forceinline__ void sample(const Nodes<T, NPT>& n, int l, const Coef<T>* cw,
                                       const T* lw, T* slot) {
  const T lf = T(l), lp1 = lf + T(1), ll1 = lf * (lf + T(1));
  T pT = T(0), pE = T(0), pP = T(0);
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const Coef<T> q = cw[32 * j];
    const T ct = q.a + lp1 * q.b + ll1 * q.d;
    pT += ct * n.jl[j] + q.e * n.jm1[j];
    pE += q.d * n.jl[j];
    pP += lw[32 * j] * n.jl[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    pT += __shfl_down_sync(FULL_WARP, pT, off);
    pE += __shfl_down_sync(FULL_WARP, pE, off);
    pP += __shfl_down_sync(FULL_WARP, pP, off);
  }
  if ((threadIdx.x & 31) == 0) {
    slot[0] = pT;
    slot[1] = pE;
    slot[2] = pP;
  }
}

template <typename T, int NPT>
__global__ void __launch_bounds__(THREADS, (min_blocks<T, NPT>()))
los_rec_kernel(const T* __restrict__ src, const int* __restrict__ idx,
               const T* __restrict__ w, const T* __restrict__ kf,
               const T* __restrict__ chi, const T* __restrict__ wt,
               const T* __restrict__ wl, const int* __restrict__ ls,
               const T* __restrict__ cut, T* __restrict__ out, int C, int nk,
               int nt, int nl, int nkf, int lmax, int l0) {
  extern __shared__ __align__(32) unsigned char smem[];
  Coef<T>* coef_s = reinterpret_cast<Coef<T>*>(smem);    // [THREADS NPT]
  T* sl_s = reinterpret_cast<T*>(coef_s + THREADS * NPT);  // [THREADS NPT]
  T* slots = sl_s + THREADS * NPT;                         // [nl][NWARP][3]
  T* cut_s = slots + (size_t)nl * NWARP * 3;               // [lmax + 1]
  int* ls_s = reinterpret_cast<int*>(cut_s + lmax + 1);   // [nl]
  const int kk = blockIdx.x;
  const int c = blockIdx.y;
  for (int i = threadIdx.x; i < nl * NWARP * 3; i += THREADS) slots[i] = T(0);
  for (int i = threadIdx.x; i <= lmax; i += THREADS) cut_s[i] = cut[i];
  for (int i = threadIdx.x; i < nl; i += THREADS) ls_s[i] = ls[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T kc = kf[kk];
  const size_t plane = (size_t)nk * nt;
  const T* S = src + (size_t)c * 4 * plane;
  T kw[4];
  int row[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    kw[j] = w[kk * 4 + j];
    row[j] = idx[kk * 4 + j];
  }
  const T* chi_c = chi + (size_t)c * nt;
  const T* wt_c = wt + (size_t)c * nt;
  const T* wl_c = wl + (size_t)c * nt;

  Nodes<T, NPT> n;
  const Coef<T>* cw = coef_s + warp * 32 * NPT + lane;   // this thread's nodes
  const T* lw = sl_s + warp * 32 * NPT + lane;
  int lo_w = lmax + 1, hi_w = 2;   // this thread's smallest and largest lcut
  int l = 2, s = 0;
  T a = T(3);                      // 2l - 1
  {
    T xv[NPT], xx[NPT], ps[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int t = warp * 32 * NPT + lane + 32 * j;
      const bool real = t < nt;
      T sv[4] = {T(0), T(0), T(0), T(0)};
      T x = T(0);
      if (real) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const T* P = S + p * plane + t;
          sv[p] = kw[0] * P[(size_t)row[0] * nt] + kw[1] * P[(size_t)row[1] * nt] +
                  kw[2] * P[(size_t)row[2] * nt] + kw[3] * P[(size_t)row[3] * nt];
        }
        const T wtt = wt_c[t];
        sv[0] *= wtt;
        sv[1] *= wtt;
        sv[2] *= wtt;
        sv[3] *= wl_c[t];
        x = kc * chi_c[t];
      }
      // pad nodes: x = 0, zero sources and a zero state, so they add nothing
      const T inv = T(1) / xmax(x, T(1e-6));
      coef_s[t] = coef_of(sv, inv);
      sl_s[t] = sv[3];
      xv[j] = x;
      xx[j] = x * x;
      n.ix[j] = inv;
      const bool small = x < T(1e-3);
      const T sx = xsin(x), cx = xcos(x);
      n.jm1[j] = real ? (small ? T(1) - x * x / T(6) : sx * inv) : T(0);
      n.jl[j] = small ? x / T(3) : sx * (inv * inv) - cx * inv;
      ps[j] = xmin(x / T(3), T(1));
      // first l >= 2 with cut[l] >= x (lmax + 1 if none; 2 for a pad or NaN)
      int lo = 2, hi = lmax + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cut_s[mid] >= x) hi = mid;
        else lo = mid + 1;
      }
      n.lcut[j] = (real && x == x) ? lo : 2;
      if (real) {
        lo_w = min(lo_w, n.lcut[j]);
        hi_w = max(hi_w, n.lcut[j]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo_w = min(lo_w, __shfl_xor_sync(FULL_WARP, lo_w, off));
      hi_w = max(hi_w, __shfl_xor_sync(FULL_WARP, hi_w, off));
    }
    // the warp walks l = 2..lend; below lo_w no node of it is past its cut
    const int lend = min(hi_w, lmax);

    // below L0: the plain version's full step
    for (; l <= min(l0 - 1, lend); ++l) {
      const T lf = T(l), lp1 = lf + T(1);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const T x = xv[j];
        const T y2 = T(0.5) * xx[j];   // (x/2) x: scaling by 2 is exact
        T jn = (a * n.ix[j]) * n.jl[j] - n.jm1[j];
        ps[j] = xmin(ps[j] * (x / (T(2) * lf + T(1))), T(1));
        const T poly = T(1) - y2 / (T(2) * lf + T(3)) +
                       y2 * y2 / (T(2) * (T(2) * lf + T(3)) * (T(2) * lf + T(5)));
        jn = (xx[j] < lp1) ? ps[j] * poly : jn;
        jn = (l < n.lcut[j]) ? jn : T(0);
        n.jm1[j] = n.jl[j];
        n.jl[j] = jn;
      }
      a += T(2);
      if (s < nl && l == ls_s[s]) {
        sample(n, l, cw, lw, slots + ((size_t)s * NWARP + warp) * 3);
        ++s;
      }
    }
  }
  // from L0 on: the recurrence and the cut only, segment by segment
  const int lend = min(hi_w, lmax);
  for (; s < nl; ++s) {
    const int target = ls_s[s];
    const int stop = min(target, lend);
    const int fast_end = min(stop, lo_w - 1);
#pragma unroll 4
    for (; l <= fast_end; ++l) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const T jn = (a * n.ix[j]) * n.jl[j] - n.jm1[j];
        n.jm1[j] = n.jl[j];
        n.jl[j] = jn;
      }
      a += T(2);
    }
#pragma unroll 2
    for (; l <= stop; ++l) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        T jn = (a * n.ix[j]) * n.jl[j] - n.jm1[j];
        jn = (l < n.lcut[j]) ? jn : T(0);
        n.jm1[j] = n.jl[j];
        n.jl[j] = jn;
      }
      a += T(2);
    }
    if (target > lend) break;   // stopped: this and every later slot stay 0
    sample(n, target, cw, lw, slots + ((size_t)s * NWARP + warp) * 3);
  }
  __syncthreads();

  const size_t plane_out = (size_t)C * nl * nkf;
  for (int i = threadIdx.x; i < nl; i += THREADS) {
    T aT = T(0), aE = T(0), aP = T(0);
#pragma unroll
    for (int q = 0; q < NWARP; ++q) {
      const T* sl = slots + ((size_t)i * NWARP + q) * 3;
      aT += sl[0];
      aE += sl[1];
      aP += sl[2];
    }
    const double lf = ls_s[i];
    const T efac = (T)sqrt(fmax((lf + 2.0) * (lf + 1.0) * lf * (lf - 1.0), 0.0));
    const size_t o = ((size_t)c * nl + i) * nkf + kk;
    out[o] = aT;
    out[plane_out + o] = efac * aE;
    out[2 * plane_out + o] = aP;
  }
}

template <typename T, int NPT>
int start(dim3 grid, cudaStream_t st, const void* src, const void* idx,
          const void* w, const void* kf, const void* chi, const void* wt,
          const void* wl, const void* ls, const void* cut, void* out, int C,
          int nk, int nt, int nl, int nkf, int lmax, int l0) {
  const size_t smem = ((size_t)5 * THREADS * NPT + (size_t)nl * NWARP * 3 + lmax + 1) * sizeof(T) +
                      (size_t)nl * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        los_rec_kernel<T, NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  los_rec_kernel<T, NPT><<<grid, THREADS, smem, st>>>(
      (const T*)src, (const int*)idx, (const T*)w, (const T*)kf, (const T*)chi,
      (const T*)wt, (const T*)wl, (const int*)ls, (const T*)cut, (T*)out, C, nk,
      nt, nl, nkf, lmax, l0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* src, const void* idx, const void* w, const void* kf,
           const void* chi, const void* wt, const void* wl, const void* ls,
           const void* cut, void* out, int C, int nk, int nt, int nl, int nkf,
           int lmax, int l0, void* stream) {
  dim3 grid(nkf, C);
  cudaStream_t st = (cudaStream_t)stream;
  if (nt <= 2 * THREADS)
    return start<T, 2>(grid, st, src, idx, w, kf, chi, wt, wl, ls, cut, out, C, nk, nt, nl, nkf, lmax, l0);
  if (nt <= 4 * THREADS)
    return start<T, 4>(grid, st, src, idx, w, kf, chi, wt, wl, ls, cut, out, C, nk, nt, nl, nkf, lmax, l0);
  if (nt <= 8 * THREADS)
    return start<T, 8>(grid, st, src, idx, w, kf, chi, wt, wl, ls, cut, out, C, nk, nt, nl, nkf, lmax, l0);
  if (nt <= 16 * THREADS)
    return start<T, 16>(grid, st, src, idx, w, kf, chi, wt, wl, ls, cut, out, C, nk, nt, nl, nkf, lmax, l0);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define LOS_REC_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* src, const void* idx, const void* w,           \
                      const void* kf, const void* chi, const void* wt,           \
                      const void* wl, const void* ls, const void* cut, void* out, \
                      int C, int nk, int nt, int nl, int nkf, int lmax, int l0,   \
                      void* stream) {                                              \
    return launch<T>(src, idx, w, kf, chi, wt, wl, ls, cut, out, C, nk, nt, nl,  \
                     nkf, lmax, l0, stream);                                       \
  }

LOS_REC_ENTRY(los_rec_f32, float)
LOS_REC_ENTRY(los_rec_f64, double)
