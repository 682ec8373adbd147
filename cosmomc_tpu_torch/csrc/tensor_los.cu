// K6: tensor line-of-sight transfers Delta_l^{T,E,B}(k) (Zaldarriaga &
// Seljak 1997 tensor radial functions).
//
// Replaces cosmomc_tpu/models/tensors.py:compute_tensor_transfers (the
// lax.map over sampled l at tensors.py:352). For every (chain, sampled l,
// fine k) it sums over the tau nodes of the evolution grid the two sources,
// interpolated linearly in ln k from the coarse tensor grid (host-built
// bracket and weight, jnp.interp's rule), times the ZS97 windows of j_l and
// j_l' (linear interpolation in the float32 tables) and j_l'' from the
// Bessel ODE.
//
// Bound (chip_smoke.py counts it from the data): the least arithmetic that
// computes the function. With j_l'' folded into the j_l and j_l'
// coefficients (B = S_P w / x^2):
//   T: j (S_T w / x^2)
//   E: j (S_P w (2/x^2 - 2) + l(l+1) B) + j' (2 S_P w / x)
//   B: j' (2 S_P w) + j (4 S_P w / x)
// a point (chain, l, k, tau) costs two lerps (6 operations) and the five
// multiply-adds plus the coefficient's one (12): 18; a (chain, k, tau) node
// ~25 (the two source lerps and weights, x, the table index and fraction,
// 1/x and the six coefficients). Where the four bracketing float32 table
// entries of j_l and j_l' are all 0 (x far below l) a point adds exactly 0
// and needs no work: the bound counts the live points only.
//
// Design:
// - the table gathers: with a lane per fine k (the first version), the 32
//   lanes of a warp read table entries up to ~8 apart (adjacent fine k
//   differ by ~1.5 in x at tau0, dx = 0.2), up to 32 cache lines a load.
//   Here 8 lanes of one k hold 8 consecutive sampled l's, and the table is
//   packed as pairs[i][slot] = (j_l(x_i), j_l'(x_i), j_l(x_{i+1}),
//   j_l'(x_{i+1})), float4, the l's padded to a multiple of 8 slots
//   (models/tensors.py:pair_table, built once per l set, uploaded once per
//   device): an octet of l's at one index is one aligned 128-byte line, and
//   a warp-wide load (8 l's x 4 k) touches 4 lines;
// - a block takes a work item (chain, 32 fine k, a group of 3 octets): warp
//   w owns the k's [8w, 8w + 8); lane (l_in, kq) the l_in-th l of each of
//   the group's octets at the k's 8w + kq and 8w + kq + 4. A lane thus
//   reads one record (below) per (k, tau) for three l's;
// - per tile of TT tau nodes (32 in float32, 16 in float64) the block
//   writes one record per (k, tau) to shared memory: the table index and
//   fraction and six coefficients with j_l'' folded in, from the sources
//   interpolated once per (chain, k, tau) for the item's 24 l's; 1/x is
//   formed once, from max(x, 1e-8) as the plain version does;
// - dead points are skipped with the same bits: the host finds n0(l), the
//   first table index where either row is non-zero, and checks that it
//   does not decrease in l. A point is dead iff i + 1 < n0(l), and adds
//   exactly 0 there. A block scans tau for the last node where its group's
//   first l is live at its largest k and forms no tile past it; a warp
//   skips a node where the group's first l is dead at its largest k (a
//   warp-uniform test). Dead lanes of a live node add exact zeros;
// - the grid holds every item at once (480 at the main path's shape, four
//   blocks of 4 warps an SM), low-l groups first and in a group the k
//   blocks from the top down. On an H100 a persistent grid that took
//   items from a counter in that order ran 4.86 ms against the static
//   grid's 4.51, and holding one octet a lane (six warps an item) 4.51
//   against 3.73 (PERF.md);
// - each output has one owner and is summed over tau in order, tile by
//   tile: no atomics, and the results repeat bit for bit.
//
// The arithmetic otherwise mirrors models/tensors.py:_tlos_plain.
#include "common.cuh"

namespace {

constexpr int KT = 32;     // fine k a work item (models/tensors.py TLOS_KT)
constexpr int OCT = 8;     // sampled l's an octet (TLOS_OCT)
constexpr int GROUP = 3;   // octets a work item, all held by each lane (TLOS_GROUP)
constexpr int KQ = 32 / OCT;           // fine k a warp instruction
constexpr int KLANE = 2;               // fine k a lane
constexpr int WARPS = KT / (KQ * KLANE);
constexpr int THREADS = WARPS * 32;
constexpr int NREC = 8;    // words of a (k, tau) record
static_assert(THREADS % KT == 0, "a thread forms the records of one k");

template <typename T>
struct Tile {
  static constexpr int TT = sizeof(T) == 4 ? 32 : 16;   // tau nodes a tile
  static constexpr int RPT = TT * KT / THREADS;           // records a thread
  // blocks an SM, set by the registers (a block's 32 KB of records would
  // let 7 share an SM): 4 in float32 (up to 128 registers; 5 and 3 were
  // slower on an H100, PERF.md), 3 in float64 (its accumulators are twice
  // the size)
  static constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 4 : 3;
};

// the table index travels in the record: as its bits in float32, as an
// exact value in float64
__device__ __forceinline__ float pack_index(int i, float) { return __int_as_float(i); }
__device__ __forceinline__ double pack_index(int i, double) { return (double)i; }
__device__ __forceinline__ int unpack_index(float v) { return __float_as_int(v); }
__device__ __forceinline__ int unpack_index(double v) { return (int)v; }

__device__ __forceinline__ void store_rec(float* p, const float (&r)[NREC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(r[4], r[5], r[6], r[7]);
}
__device__ __forceinline__ void store_rec(double* p, const double (&r)[NREC]) {
#pragma unroll
  for (int j = 0; j < NREC / 2; ++j)
    reinterpret_cast<double2*>(p)[j] = make_double2(r[2 * j], r[2 * j + 1]);
}
__device__ __forceinline__ void load_rec(const float* p, float (&r)[NREC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}
__device__ __forceinline__ void load_rec(const double* p, double (&r)[NREC]) {
#pragma unroll
  for (int j = 0; j < NREC / 2; ++j) {
    const double2 a = reinterpret_cast<const double2*>(p)[j];
    r[2 * j] = a.x;
    r[2 * j + 1] = a.y;
  }
}

// the table index of x * inv_dx, as the plain version clamps it
template <typename T>
__device__ __forceinline__ int table_index(T tt, int nx) {
  const int i = (int)tt;
  return i < 0 ? 0 : (i > nx - 2 ? nx - 2 : i);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, Tile<T>::MIN_BLOCKS)
tlos_kernel(const T* __restrict__ src, const int* __restrict__ lo,
            const int* __restrict__ hi, const T* __restrict__ w,
            const T* __restrict__ kf, const T* __restrict__ chi,
            const T* __restrict__ wt, const float4* __restrict__ pairs,
            const int* __restrict__ n0, const T* __restrict__ ls,
            T* __restrict__ out, int C, int nk, int N, int nl, int nslot, int nx,
            int nkf, T inv_dx) {
  constexpr int TT = Tile<T>::TT;
  // records [TT][KT][NREC]: index, f, cT, B, cE, cPE, cPB, cJB
  __shared__ __align__(16) T rec[TT * KT * NREC];
  __shared__ int s_tend;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkb = (nkf + KT - 1) / KT;
  const int noct = nslot / OCT;
  // items: octet groups from the lowest l, in a group k blocks from the top
  // down, chains innermost
  const int c = blockIdx.x % C, p = blockIdx.x / C;
  const int g = p / nkb, kb = nkb - 1 - p % nkb;
  const int k0 = kb * KT, nkt = min(KT, nkf - k0);
  const T* chi_c = chi + (size_t)c * N;
  const T* wt_c = wt + (size_t)c * N;

  const int n0g = n0[g * GROUP * OCT];   // n0 of the group's first l

  // the last node where the group's first l is live at the largest k
  if (tid == 0) s_tend = 0;
  __syncthreads();
  {
    const T kmax_b = kf[k0 + nkt - 1];
    int last = 0;
    for (int t = tid; t < N; t += THREADS)
      if (table_index(kmax_b * chi_c[t] * inv_dx, nx) + 1 >= n0g) last = t + 1;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) last = max(last, __shfl_xor_sync(FULL_WARP, last, s));
    if (lane == 0 && last > 0) atomicMax(&s_tend, last);
  }
  __syncthreads();
  const int t_end = s_tend;

  // compute phase: warp `warp` owns the k's [kw_lo, kw_lo + 8), lane (l_in,
  // kq) the l_in-th l of each of the group's octets at k's kq and kq + 4
  const int l_in = lane % OCT, kq = lane / OCT;
  const int kw_lo = warp * KQ * KLANE;
  const int kw_hi = min(kw_lo + KQ * KLANE, nkt) - 1;
  const bool busy = kw_hi >= kw_lo;
  const int ngo = min(GROUP, noct - g * GROUP);   // the group's octets
  T llp1[GROUP];
  const float4* prow = pairs + g * GROUP * OCT + l_in;
#pragma unroll
  for (int o = 0; o < GROUP; ++o) {
    const int slot = (g * GROUP + o) * OCT + l_in;
    const T l = slot < nl ? ls[slot] : T(0);
    llp1[o] = l * (l + T(1));
  }
  T aT[KLANE][GROUP], aE[KLANE][GROUP], aB[KLANE][GROUP];
#pragma unroll
  for (int q = 0; q < KLANE; ++q)
#pragma unroll
    for (int o = 0; o < GROUP; ++o) aT[q][o] = aE[q][o] = aB[q][o] = T(0);

  // record phase: this thread's k is always tid % KT
  const int kr = tid % KT;
  const bool k_ok = kr < nkt;
  const int kk = k0 + (k_ok ? kr : nkt - 1);
  const T kc = kf[kk], wk = w[kk];
  const size_t plane = (size_t)nk * N;
  const T* sT_lo = src + (size_t)c * 2 * plane + (size_t)lo[kk] * N;
  const T* sT_hi = src + (size_t)c * 2 * plane + (size_t)hi[kk] * N;
  const T* sP_lo = sT_lo + plane;
  const T* sP_hi = sT_hi + plane;

  for (int t0 = 0; t0 < t_end; t0 += TT) {
    __syncthreads();  // the previous tile's records are consumed
#pragma unroll
    for (int j = 0; j < Tile<T>::RPT; ++j) {
      const int tl = tid / KT + j * (THREADS / KT), t = t0 + tl;
      T r[NREC];
      r[0] = pack_index(0, T(0));
#pragma unroll
      for (int m = 1; m < NREC; ++m) r[m] = T(0);
      if (k_ok && t < t_end) {
        const T wtt = wt_c[t];
        const T a = sT_lo[t], b = sP_lo[t];
        const T sTw = (a + wk * (sT_hi[t] - a)) * wtt;
        const T sPw = (b + wk * (sP_hi[t] - b)) * wtt;
        const T x = kc * chi_c[t];
        const T tt = x * inv_dx;
        const int i = table_index(tt, nx);
        const T inv = T(1) / xmax(x, T(1e-8));
        const T inv2 = inv * inv;
        r[0] = pack_index(i, T(0));
        r[1] = tt - T(i);
        r[2] = sTw * inv2;
        r[3] = sPw * inv2;
        r[4] = sPw * (T(2) * inv2 - T(2));
        r[5] = T(2) * sPw * inv;
        r[6] = T(2) * sPw;
        r[7] = T(4) * sPw * inv;
      }
      store_rec(rec + (tl * KT + kr) * NREC, r);
    }
    __syncthreads();  // the tile's records are ready
    if (!busy) continue;
    const int ntl = min(TT, t_end - t0);
#pragma unroll 2
    for (int tl = 0; tl < ntl; ++tl) {
      const T* rt = rec + tl * KT * NREC;
      // every point of the warp at this node is dead
      if (unpack_index(rt[kw_hi * NREC]) + 1 < n0g) continue;
#pragma unroll
      for (int q = 0; q < KLANE; ++q) {
        T r[NREC];
        load_rec(rt + (kw_lo + q * KQ + kq) * NREC, r);
        const float4* e_row = prow + (size_t)unpack_index(r[0]) * nslot;
#pragma unroll
        for (int o = 0; o < GROUP; ++o) {
          if (o >= ngo) continue;
          const float4 e = e_row[o * OCT];
          const T J0 = e.x, P0 = e.y;
          const T jv = J0 + r[1] * (T(e.z) - J0);
          const T jp = P0 + r[1] * (T(e.w) - P0);
          aT[q][o] += jv * r[2];
          aE[q][o] += jv * (r[4] + llp1[o] * r[3]);
          aE[q][o] += jp * r[5];
          aB[q][o] += jp * r[6];
          aB[q][o] += jv * r[7];
        }
      }
    }
  }

  if (!busy) return;
  const size_t plane_out = (size_t)C * nl * nkf;
#pragma unroll
  for (int o = 0; o < GROUP; ++o) {
    const int slot = (g * GROUP + o) * OCT + l_in;
    if (slot >= nl) continue;
    const T l = ls[slot];
    const T efac = xsqrt(xmax((l + T(2)) * (l + T(1)) * l * (l - T(1)), T(0)));
#pragma unroll
    for (int q = 0; q < KLANE; ++q) {
      const int kl = kw_lo + q * KQ + kq;
      if (kl >= nkt) continue;
      const size_t out_i = ((size_t)c * nl + slot) * nkf + k0 + kl;
      out[out_i] = efac * aT[q][o];
      out[plane_out + out_i] = aE[q][o];
      out[2 * plane_out + out_i] = aB[q][o];
    }
  }
}

template <typename T>
int launch(const void* src, const void* lo, const void* hi, const void* w,
           const void* kf, const void* chi, const void* wt, const void* pairs,
           const void* n0, const void* ls, void* out, int C, int nk, int N, int nl,
           int nslot, int nx, int nkf, double inv_dx, void* stream) {
  if (C <= 0 || nk <= 0 || N <= 0 || nl <= 0 || nkf <= 0 || nx < 2 ||
      nslot % OCT || nl > nslot)
    return (int)cudaErrorInvalidValue;
  const int n_items = C * ((nkf + KT - 1) / KT) * ((nslot / OCT + GROUP - 1) / GROUP);
  tlos_kernel<T><<<n_items, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)src, (const int*)lo, (const int*)hi, (const T*)w, (const T*)kf,
      (const T*)chi, (const T*)wt, (const float4*)pairs, (const int*)n0, (const T*)ls,
      (T*)out, C, nk, N, nl, nslot, nx, nkf, (T)inv_dx);
  return (int)cudaGetLastError();
}

}  // namespace

#define TLOS_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* src, const void* lo, const void* hi, const void* w, \
                      const void* kf, const void* chi, const void* wt,                \
                      const void* pairs, const void* n0, const void* ls, void* out,   \
                      int C, int nk, int N, int nl, int nslot, int nx, int nkf,       \
                      double inv_dx, void* stream) {                                  \
    return launch<T>(src, lo, hi, w, kf, chi, wt, pairs, n0, ls, out, C, nk, N, nl,   \
                     nslot, nx, nkf, inv_dx, stream);                                  \
  }

TLOS_ENTRY(tensor_los_f32, float)
TLOS_ENTRY(tensor_los_f64, double)
