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
//
// The same file holds the reverse pass (tensor_los_bwd, the reverse of
// JAX's lax.map under jax.grad); its design is set out above
// tlos_bwd_kernel.
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


// ===========================================================================
// The reverse pass (tensor_los_bwd): the cotangents of src (C, 2, nk, N), chi
// and wt (C, N) from that of the output g (3, C, nl, nkf), as autograd of
// models/tensors.py:_tlos_plain gives them (jax.vjp of JAX's lax.map). j_l
// and j_l' are the table's linear interpolants in t = x inv_dx with the
// index truncated (no gradient through it), so their derivative in x is the
// interpolant's slope, (J[i+1] - J[i]) inv_dx; max(x, 1e-8) passes the
// cotangent at and above 1e-8 and none below.
//
// With B = 1/x^2 (from max(x, 1e-8)), 1/x and the E window folded as the
// forward folds it, wE = j ((l(l+1) + 2)/x^2 - 2) + 2 j'/x, wB = 2 j' + 4 j/x,
// a (chain, fine k, tau) point needs twelve sums over the sampled l of the
// cotangents times the table entries and their differences:
//   A_* = sum_l G_* J_l[i], B_* = sum_l G_* (J_l[i+1] - J_l[i])
// for G_T efac, G_E (l(l+1) + 2), G_E, G_B against j_l and G_E, G_B against
// j_l'; the interpolated sums are A + f B, and each cotangent of the point
// is a few products of those with the sources and 1/x. Where the four
// table entries of an l are 0 (i + 1 < n0(l), the forward's dead points)
// its terms are exact zeros, so a lane walks only the live prefix of the
// sorted l's.
//
// Design: a block owns (chain, KT = 32 fine k, a tile of TT tau nodes), a
// lane a k, the 8 warps the tile's nodes; the block's cotangents (3 x nl x
// 32) sit in shared memory. Each lane walks the live l's of its (k, tau),
// reading the packed (j_l, j_l', j_l+, j_l'+) lines of the forward's table.
// The cotangents of chi and wt are sums over k: a warp butterfly over the
// block's 32 k, then the k blocks in order (a second kernel). The source
// cotangent goes back from the fine k to the coarse rows through the
// transposed 2-point ln-k stencil: per coarse row its stencils touch and per
// tau, the block adds its lanes' shares in lane order into a partial row of
// its own (`blk_off`); a third kernel adds the k blocks that touch a row
// (`row_kb`) in block order. The fine-k source cotangent (640 MB in float64
// at the main path's shape) is never stored; no atomics.
//
// Bound (chip_smoke.py counts it): reverse mode at 3x the forward's
// operations on the same live lattice; in practice the table gathers, a
// lane a k, as in the forward's first version.
// ===========================================================================

constexpr int BWD_THREADS = 256;  // 8 warps

template <typename T>
struct BwdTile {
  static constexpr int TT = sizeof(T) == 4 ? 32 : 16;   // tau nodes a block
};

template <typename T>
size_t bwd_smem_bytes(int nl, int rspan) {
  constexpr int TT = BwdTile<T>::TT;
  return (size_t)3 * nl * KT * sizeof(T)     // G_T efac, G_E, G_B
         + (size_t)nl * sizeof(T)            // l(l+1) + 2
         + (size_t)2 * TT * KT * sizeof(T)   // cotangents of the interpolated sources
         + (size_t)KT * 2 * sizeof(T)        // stencil weight, k
         + (size_t)KT * 2 * sizeof(int)      // stencil rows, relative to the block's first
         + (size_t)2 * rspan * sizeof(int);  // each local row's first and last lane
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_WARP, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
tlos_bwd_kernel(const T* __restrict__ src, const int* __restrict__ lo,
                const int* __restrict__ hi, const T* __restrict__ w,
                const T* __restrict__ kf, const T* __restrict__ chi,
                const T* __restrict__ wt, const float4* __restrict__ pairs,
                const int* __restrict__ n0, const T* __restrict__ ls,
                const T* __restrict__ g, const int* __restrict__ blk_off,
                T* __restrict__ part_src, T* __restrict__ part_w, int C, int nk, int N,
                int nl, int nslot, int nx, int nkf, T inv_dx, int rtot) {
  constexpr int TT = BwdTile<T>::TT;
  constexpr int NW = BWD_THREADS / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* G = reinterpret_cast<T*>(smem_raw);  // [3][nl][KT]
  T* lp2 = G + 3 * nl * KT;               // [nl]
  T* Bs = lp2 + nl;                       // [2][TT][KT]
  T* kw_s = Bs + 2 * TT * KT;             // [KT]
  T* kf_s = kw_s + KT;                    // [KT]
  int* klo_s = reinterpret_cast<int*>(kf_s + KT);  // [KT] rows relative to r_lo
  int* khi_s = klo_s + KT;                // [KT]
  int* rfirst = khi_s + KT;               // [rspan]
  int* rlast = rfirst + (blk_off[blockIdx.x + 1] - blk_off[blockIdx.x]);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kb = blockIdx.x, nkb = gridDim.x, k0 = kb * KT, t0 = blockIdx.y * TT;
  const int c = blockIdx.z;
  const int nkt = min(KT, nkf - k0);
  const int r_lo = lo[k0];
  const int nr = blk_off[kb + 1] - blk_off[kb];   // hi[k0 + nkt - 1] - r_lo + 1
  const size_t plane = (size_t)nk * N, gplane = (size_t)C * nl * nkf;

  for (int e = tid; e < nl * KT; e += BWD_THREADS) {
    const int il = e / KT, kl = e % KT;
    T gT = T(0), gE = T(0), gB = T(0);
    if (kl < nkt) {
      const size_t o = ((size_t)c * nl + il) * nkf + k0 + kl;
      const T l = ls[il];
      gT = g[o] * xsqrt(xmax((l + T(2)) * (l + T(1)) * l * (l - T(1)), T(0)));
      gE = g[gplane + o];
      gB = g[2 * gplane + o];
    }
    G[e] = gT;
    G[nl * KT + e] = gE;
    G[2 * nl * KT + e] = gB;
  }
  for (int il = tid; il < nl; il += BWD_THREADS) {
    const T l = ls[il];
    lp2[il] = l * (l + T(1)) + T(2);
  }
  for (int kl = tid; kl < KT; kl += BWD_THREADS) {
    const int kk = k0 + (kl < nkt ? kl : nkt - 1);
    kw_s[kl] = w[kk];
    kf_s[kl] = kf[kk];
    klo_s[kl] = lo[kk] - r_lo;
    khi_s[kl] = hi[kk] - r_lo;
  }
  __syncthreads();
  for (int rr = tid; rr < nr; rr += BWD_THREADS) {
    int a = KT, b = -1;
    for (int kl = 0; kl < nkt; ++kl)
      if (klo_s[kl] == rr || khi_s[kl] == rr) {
        a = min(a, kl);
        b = kl;
      }
    rfirst[rr] = a;
    rlast[rr] = b;
  }

  const T* chi_c = chi + (size_t)c * N;
  const T* wt_c = wt + (size_t)c * N;
  const T* sT = src + (size_t)c * 2 * plane;
  const T* sP = sT + plane;
  const T kfl = kf_s[lane], wk = kw_s[lane];
  const int rl = r_lo + klo_s[lane], rh = r_lo + khi_s[lane];
  for (int tl = warp; tl < TT; tl += NW) {
    const int t = t0 + tl;
    const bool on = lane < nkt && t < N;
    const int tc = t < N ? t : N - 1;
    const T x = kfl * chi_c[tc];
    const T tt = x * inv_dx;
    const int i = table_index(tt, nx);
    const T f = tt - T(i);
    T A1 = T(0), A2 = T(0), A3 = T(0), A4 = T(0), A5 = T(0), A6 = T(0);
    T B1 = T(0), B2 = T(0), B3 = T(0), B4 = T(0), B5 = T(0), B6 = T(0);
    const float4* row = pairs + (size_t)i * nslot;
    for (int il = 0; il < nl && n0[il] <= i + 1; ++il) {
      const float4 e = row[il];
      const T J0 = e.x, P0 = e.y;
      const T dJ = T(e.z) - J0, dP = T(e.w) - P0;
      const T gT = G[il * KT + lane];
      const T gE = G[(nl + il) * KT + lane];
      const T gB = G[(2 * nl + il) * KT + lane];
      const T gEL = gE * lp2[il];
      A1 += gT * J0;
      B1 += gT * dJ;
      A2 += gEL * J0;
      B2 += gEL * dJ;
      A3 += gE * J0;
      B3 += gE * dJ;
      A4 += gB * J0;
      B4 += gB * dJ;
      A5 += gE * P0;
      B5 += gE * dP;
      A6 += gB * P0;
      B6 += gB * dP;
    }
    const T a1 = A1 + f * B1, a2 = A2 + f * B2, a3 = A3 + f * B3;
    const T a4 = A4 + f * B4, a5 = A5 + f * B5, a6 = A6 + f * B6;
    const T inv = T(1) / xmax(x, T(1e-8));
    const T inv2 = inv * inv;
    const T dinv = x >= T(1e-8) ? -inv2 : T(0);
    const T wtt = wt_c[tc];
    const T sTl = sT[(size_t)rl * N + tc], sPl = sP[(size_t)rl * N + tc];
    const T STi = sTl + wk * (sT[(size_t)rh * N + tc] - sTl);
    const T SPi = sPl + wk * (sP[(size_t)rh * N + tc] - sPl);
    const T STw = STi * wtt, SPw = SPi * wtt;
    // the cotangents of the weighted sources and of x
    const T gSTw = inv2 * a1;
    const T gSPw = inv2 * a2 - T(2) * a3 + T(4) * inv * a4 + T(2) * inv * a5 + T(2) * a6;
    const T gx = inv_dx * (STw * inv2 * B1 + SPw * (inv2 * B2 - T(2) * B3 + T(4) * inv * B4 +
                                                     T(2) * inv * B5 + T(2) * B6)) +
                 dinv * (STw * T(2) * inv * a1 + SPw * (T(2) * inv * a2 + T(2) * a5 + T(4) * a4));
    const T v_chi = warp_sum(on ? kfl * gx : T(0));
    const T v_wt = warp_sum(on ? gSTw * STi + gSPw * SPi : T(0));
    if (lane == 0 && t < N) {
      T* pw = part_w + ((size_t)c * nkb + kb) * 2 * N + t;
      pw[0] = v_chi;
      pw[N] = v_wt;
    }
    const int o = tl * KT + lane;
    Bs[o] = on ? gSTw * wtt : T(0);
    Bs[TT * KT + o] = on ? gSPw * wtt : T(0);
  }
  __syncthreads();
  // the transposed stencil: this block's share of each coarse row it
  // touches, g_lo = g - w g, g_hi = w g, its lanes in order
  for (int e = tid; e < 2 * nr * TT; e += BWD_THREADS) {
    const int tl = e % TT, rr = (e / TT) % nr, p = e / (TT * nr);
    const int t = t0 + tl;
    if (t >= N) continue;
    T acc = T(0);
    for (int kl = rfirst[rr]; kl <= rlast[rr]; ++kl) {
      const T b = Bs[(p * TT + tl) * KT + kl];
      if (klo_s[kl] == rr) acc += b - kw_s[kl] * b;
      if (khi_s[kl] == rr) acc += kw_s[kl] * b;
    }
    part_src[(((size_t)c * 2 + p) * rtot + blk_off[kb] + rr) * N + t] = acc;
  }
}

// g_src[c, p, r, t] = sum over the k blocks that touch row r, in order
template <typename T>
__global__ void tlos_bwd_rows_kernel(const T* __restrict__ part_src,
                                     const int* __restrict__ blk_off,
                                     const int* __restrict__ row_kb, const int* __restrict__ lo,
                                     T* __restrict__ g_src, int C, int nk, int N, int rtot) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)C * 2 * nk * N) return;
  const int t = (int)(i % N), r = (int)((i / N) % nk);
  const size_t cp = i / ((size_t)nk * N);
  T acc = T(0);
  for (int kb = row_kb[2 * r]; kb <= row_kb[2 * r + 1]; ++kb)
    acc += part_src[(cp * rtot + blk_off[kb] + r - lo[kb * KT]) * N + t];
  g_src[i] = acc;
}

// g_chi, g_wt [c, t] = sum over the k blocks, in order
template <typename T>
__global__ void tlos_bwd_w_kernel(const T* __restrict__ part_w, T* __restrict__ g_chi,
                                  T* __restrict__ g_wt, int C, int nkb, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * N) return;
  const int t = i % N, c = i / N;
  T s0 = T(0), s1 = T(0);
  for (int kb = 0; kb < nkb; ++kb) {
    const T* pw = part_w + ((size_t)c * nkb + kb) * 2 * N + t;
    s0 += pw[0];
    s1 += pw[N];
  }
  g_chi[i] = s0;
  g_wt[i] = s1;
}

template <typename T>
int launch_bwd(const void* src, const void* lo, const void* hi, const void* w, const void* kf,
               const void* chi, const void* wt, const void* pairs, const void* n0,
               const void* ls, const void* g, const void* blk_off, const void* row_kb,
               void* part_src, void* part_w, void* g_src, void* g_chi, void* g_wt, int C,
               int nk, int N, int nl, int nslot, int nx, int nkf, double inv_dx, int rspan,
               int rtot, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C <= 0 || nk <= 0 || N <= 0 || nl <= 0 || nkf <= 0 || nx < 2 || nslot % OCT ||
      nl > nslot || rspan <= 0 || rspan > nk || rtot <= 0)
    return (int)cudaErrorInvalidValue;
  constexpr int TT = BwdTile<T>::TT;
  const size_t smem = bwd_smem_bytes<T>(nl, rspan);
  cudaError_t err = cudaFuncSetAttribute(tlos_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (nkf + KT - 1) / KT;
  tlos_bwd_kernel<T><<<dim3(nkb, (N + TT - 1) / TT, C), BWD_THREADS, smem, st>>>(
      (const T*)src, (const int*)lo, (const int*)hi, (const T*)w, (const T*)kf, (const T*)chi,
      (const T*)wt, (const float4*)pairs, (const int*)n0, (const T*)ls, (const T*)g,
      (const int*)blk_off, (T*)part_src, (T*)part_w, C, nk, N, nl, nslot, nx, nkf, (T)inv_dx,
      rtot);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t nsrc = (size_t)C * 2 * nk * N;
  tlos_bwd_rows_kernel<T><<<(unsigned)((nsrc + 255) / 256), 256, 0, st>>>(
      (const T*)part_src, (const int*)blk_off, (const int*)row_kb, (const int*)lo, (T*)g_src,
      C, nk, N, rtot);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tlos_bwd_w_kernel<T><<<(C * N + 255) / 256, 256, 0, st>>>((const T*)part_w, (T*)g_chi,
                                                          (T*)g_wt, C, nkb, N);
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

#define TLOS_BWD_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* src, const void* lo, const void* hi, const void* w,      \
                      const void* kf, const void* chi, const void* wt, const void* pairs,  \
                      const void* n0, const void* ls, const void* g, const void* blk_off,  \
                      const void* row_kb, void* part_src, void* part_w, void* g_src,       \
                      void* g_chi, void* g_wt, int C, int nk, int N, int nl, int nslot,    \
                      int nx, int nkf, double inv_dx, int rspan, int rtot, void* stream) { \
    return launch_bwd<T>(src, lo, hi, w, kf, chi, wt, pairs, n0, ls, g, blk_off, row_kb,   \
                         part_src, part_w, g_src, g_chi, g_wt, C, nk, N, nl, nslot, nx,    \
                         nkf, inv_dx, rspan, rtot, stream);                                 \
  }

TLOS_BWD_ENTRY(tensor_los_bwd_f32, float)
TLOS_BWD_ENTRY(tensor_los_bwd_f64, double)
