// K1's reverse pass: the gradient of csrc/perturbations.cu's RK4 map, with
// the TCA/RSA switches, nu_rel_rsa, the DE fluid's freeze and the IC hold,
// as jax.grad of the JAX scan (with remat_chunks) gives it.
//
// Replaces the reverse of cosmomc_tpu/models/perturbations.py:
// evolve_perturbations (jax.grad over the lax.scan at :928, with
// remat_chunks :906-925). Given the cotangents of the 7 planes at every
// step it returns those of the stage table qtab (C, S, 3, NQX with NQX =
// 16, 25, 19 or 28), of rnu and of the isocurvature inputs.
//
// One build a (massive_nu, de_perts) instantiation: K1_NU and K1_DE (0 or 1,
// cosmomc_tpu_torch/kernels.py EXTRA_FLAGS) select it, so the four build in
// parallel; each source's entry points are <variant>_bwd_f32|f64, the
// variant boltzmann, boltzmann_nu, boltzmann_de or boltzmann_nu_de.
// - One thread owns one (chain, k) lane, one block the k lanes of a chain
//   (up to 256; more lanes take more blocks and a partial table each). The
//   adjoint is serial code on the thread (csrc/boltzmann_adjoint.cuh): the
//   forward RHS, sources, ICs and step repeated as the plain version writes
//   them, and their vector-Jacobian products written out by hand. The
//   switches depend on (k, row) alone and compare single products, so the
//   recomputed steps take the forward's branches.
// - Checkpointed by chunks, as JAX's remat_chunks: the forward kernel
//   (csrc/perturbations.cu's `*_ck` entries) stores the state before every
//   chunk-th step; the chunks are taken in reverse, each recomputed from its
//   checkpoint with the step function, its states kept in a global scratch
//   (C, chunk, NVX, nk: a chunk's NVX x chunk states a lane, consecutive
//   lanes at consecutive addresses), then its steps are walked back. A
//   lane's states do not fit shared memory at the matter path's chunk of 96
//   steps (28 KB a lane in float64 for the base layout, 50 KB with both
//   extensions), so they live in device memory and the L2.
// - The table's cotangent is a sum over the k lanes of a chain: at every
//   step the block reduces its lanes' 3 NQX values (48 to 84) by warp
//   shuffles in a fixed order, then across its warps through shared memory,
//   each column summed by one thread: no atomics, the same bits on every run.
// Bound: the lane's dependency chain, ~3x the forward's work a step (a step
// recomputed in the chunk pass, then again with its four stages and the
// sources' RHS, and five vector-Jacobian products), with one thread a lane
// instead of a warp. The lanes' 37-67-value arrays live in local memory.
#include "common.cuh"
#include "boltzmann_adjoint.cuh"

#if !defined(K1_NU) || !defined(K1_DE)
#error "build with -DK1_NU=0|1 -DK1_DE=0|1 (cosmomc_tpu_torch/kernels.py)"
#endif

namespace {

constexpr int BWD_THREADS = 256;
// a step's three rows at the widest (NU and DE): the reduction's columns
constexpr int QB3_MAX = 3 * k1adj::Layout<true, true>::NQX;
// a chain's blocks and their threads: models/perturbations.py:_bwd_lanes
// repeats this
inline int bwd_blocks(int nk) { return (nk + BWD_THREADS - 1) / BWD_THREADS; }
inline int bwd_threads(int nk) {
  const int t = ((nk < BWD_THREADS ? nk : BWD_THREADS) + 31) / 32 * 32;
  return t < 64 ? 64 : t;
}

// a fixed-order sum over the block of n values a thread (n <= QB3_MAX), the
// result in red[0..n) after the call; every thread of the block calls it
template <typename T>
__device__ __forceinline__ void block_sum(T* v, int n, T (*red)[QB3_MAX]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = 0; i < n; ++i) {
    T x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_WARP, x, o);
    if (lane == 0) red[w][i] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    T x = red[0][i];
    for (int j = 1; j < nw; ++j) x += red[j][i];
    red[0][i] = x;   // column i is read by this thread only
  }
  __syncthreads();
}

template <typename T, bool NU, bool DE>
__global__ void __launch_bounds__(BWD_THREADS)
boltzmann_bwd_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
                     const T* __restrict__ rnu_in, const T* __restrict__ iso_in,
                     const T* __restrict__ nuc_in, const T* __restrict__ ck,
                     const T* __restrict__ gout, T* __restrict__ scratch, T* __restrict__ gq,
                     T* __restrict__ grnu, T* __restrict__ giso, int C, int S, int nk,
                     T rsa_ktau, int chunk) {
  namespace A = k1adj;
  using L = A::Layout<NU, DE>;
  constexpr int NV = L::NVX, NQB = L::NQX, QB3 = 3 * NQB;
  __shared__ T red[BWD_THREADS / 32][QB3_MAX];
  const int c = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int kidx = blk * blockDim.x + threadIdx.x;
  const bool active = kidx < nk;
  const int kk = min(kidx, nk - 1);
  const T k = kvec[kk], rnu = rnu_in[c];
  const A::Iso<T> iso = {iso_in[3 * c], iso_in[3 * c + 1], iso_in[3 * c + 2]};
  // the node weights and d ln f0 / d ln q (NU)
  T nuc[2 * A::NQNU];
  for (int i = 0; i < 2 * A::NQNU; ++i) nuc[i] = NU ? nuc_in[i] : T(0);
  const T* Qc = qtab + (size_t)c * S * QB3;
  const int nck = (S + chunk - 1) / chunk;
  const T* ckl = ck + ((size_t)c * nk + kk) * (nck + 1) * NV;
  // (j, v) of this lane at sc[(j NV + v) nkp], nkp the chain's padded lanes
  const int nkp = gridDim.x * blockDim.x;
  T* sc = scratch + (size_t)c * chunk * NV * nkp + kidx;
  T* gqb = gq + ((size_t)c * nblk + blk) * S * QB3;

  T y[NV], yn[NV], ynb[NV], yb[NV], qbar[QB3];
  T rnu_b = T(0), isob[3] = {T(0), T(0), T(0)};
  for (int i = 0; i < NV; ++i) ynb[i] = T(0);
  for (int m = nck - 1; m >= 0; --m) {
    const int lo = m * chunk, hi = min(lo + chunk, S);
    // the chunk's states, recomputed from its checkpoint
    for (int i = 0; i < NV; ++i) y[i] = ckl[(size_t)m * NV + i];
    for (int s = lo; s < hi; ++s) {
      const T* q = Qc + (size_t)s * QB3;
      for (int i = 0; i < NV; ++i) sc[((size_t)(s - lo) * NV + i) * nkp] = y[i];
      A::step<T, NU, DE>(y, q, q + NQB, q + 2 * NQB, k, rsa_ktau, rnu, iso, nuc, yn);
      for (int i = 0; i < NV; ++i) y[i] = yn[i];
    }
    // ... walked back
    for (int s = hi - 1; s >= lo; --s) {
      const T* q = Qc + (size_t)s * QB3;
      for (int i = 0; i < NV; ++i) y[i] = sc[((size_t)(s - lo) * NV + i) * nkp];
      T g[A::NPL];
      for (int p = 0; p < A::NPL; ++p)
        g[p] = active ? gout[(((size_t)p * C + c) * S + s) * nk + kidx] : T(0);
      for (int i = 0; i < QB3; ++i) qbar[i] = T(0);
      A::step_vjp<T, NU, DE>(y, yn, q, q + NQB, q + 2 * NQB, k, rsa_ktau, rnu, iso, nuc, ynb,
                             g, yb, qbar, qbar + NQB, qbar + 2 * NQB, &rnu_b, isob);
      if (!active) {
        for (int i = 0; i < QB3; ++i) qbar[i] = T(0);
        for (int i = 0; i < NV; ++i) yb[i] = T(0);
      }
      block_sum(qbar, QB3, red);
      for (int i = threadIdx.x; i < QB3; i += blockDim.x)
        gqb[(size_t)s * QB3 + i] = red[0][i];
      __syncthreads();
      for (int i = 0; i < NV; ++i) {
        ynb[i] = yb[i];
        yn[i] = y[i];
      }
    }
  }
  // the initial state: the ICs at tau_a of step 0
  T tail[5] = {T(0), rnu_b, isob[0], isob[1], isob[2]};
  if (active)
    A::ics_vjp<T, NU, DE>(k, Qc[A::Q_TAU], rnu, iso, nuc, ynb, &tail[0], &tail[1], &tail[2]);
  else
    tail[1] = tail[2] = tail[3] = tail[4] = T(0);
  block_sum(tail, 5, red);
  if (threadIdx.x == 0) {
    gqb[A::Q_TAU] += red[0][0];
    grnu[(size_t)c * nblk + blk] = red[0][1];
    for (int j = 0; j < 3; ++j) giso[((size_t)c * nblk + blk) * 3 + j] = red[0][2 + j];
  }
}

// blocks of up to BWD_THREADS lanes of one chain: ceil(nk / BWD_THREADS) a chain
template <typename T, bool NU, bool DE>
int launch_bwd(const void* qtab, const void* kvec, const void* rnu, const void* iso,
               const void* nuc, const void* ck, const void* gout, void* scratch, void* gq,
               void* grnu, void* giso, int C, int S, int nk, double rsa_ktau, int chunk,
               void* stream) {
  const int nblk = bwd_blocks(nk), threads = bwd_threads(nk);
  dim3 grid(nblk, C);
  boltzmann_bwd_kernel<T, NU, DE><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)qtab, (const T*)kvec, (const T*)rnu, (const T*)iso, (const T*)nuc,
      (const T*)ck, (const T*)gout, (T*)scratch, (T*)gq, (T*)grnu, (T*)giso, C, S, nk,
      (T)rsa_ktau, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// the entry points of this build's instantiation: nuc (2, 4) as the
// forward's (read with NU only); gout (7, C, S, nk) the planes' cotangents;
// scratch (C, chunk, NVX, nblk x threads); gq (C, nblk, S, 3, NQX), grnu (C,
// nblk), giso (C, nblk, 3) a partial of each block of k lanes (nblk =
// ceil(nk / 256))
#define BOLTZMANN_BWD_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const void* qtab, const void* kvec, const void* rnu,             \
                      const void* iso, const void* nuc, const void* ck,                \
                      const void* gout, void* scratch, void* gq, void* grnu,           \
                      void* giso, int C, int S, int nk, double rsa_ktau, int chunk,    \
                      void* stream) {                                                  \
    return launch_bwd<T, K1_NU != 0, K1_DE != 0>(qtab, kvec, rnu, iso, nuc, ck, gout,  \
                                                 scratch, gq, grnu, giso, C, S, nk,    \
                                                 rsa_ktau, chunk, stream);             \
  }
#if K1_NU && K1_DE
BOLTZMANN_BWD_ENTRY(boltzmann_nu_de_bwd_f32, float)
BOLTZMANN_BWD_ENTRY(boltzmann_nu_de_bwd_f64, double)
#elif K1_NU
BOLTZMANN_BWD_ENTRY(boltzmann_nu_bwd_f32, float)
BOLTZMANN_BWD_ENTRY(boltzmann_nu_bwd_f64, double)
#elif K1_DE
BOLTZMANN_BWD_ENTRY(boltzmann_de_bwd_f32, float)
BOLTZMANN_BWD_ENTRY(boltzmann_de_bwd_f64, double)
#else
BOLTZMANN_BWD_ENTRY(boltzmann_bwd_f32, float)
BOLTZMANN_BWD_ENTRY(boltzmann_bwd_f64, double)
#endif
