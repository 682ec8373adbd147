// K5: RK4 of the tensor-mode hierarchy (metric h, photon intensity and
// polarization, massless neutrinos; NVAR_T = 45).
//
// Replaces cosmomc_tpu/models/tensors.py:evolve_tensors (the lax.scan at
// tensors.py:254 over make_tensor_rhs.rhs and rk4_step). One thread owns one
// (chain, k) lane and runs the whole tau loop with the 45-variable state, the
// RK4 accumulator, the stage state and the stage derivative in registers
// (spilling in float64, as K1 does). Every k-independent RHS input (opacity,
// photon and neutrino densities, conformal H, the tight-coupling flag,
// visibility, e^-kappa) comes precomputed per (chain, step, row) in `qtab`
// (models/tensors.py:_stage_table): rows 3s..3s+2 are the RK4 stage times of
// substep s, the last row is the step's end, where the sources are read.
// Bound: 5 RHS evaluations of ~600 flops per step over ~8191 dependent steps:
// latency-bound; 8 chains x 96 k = 768 lanes fill ~24 blocks of 32 threads.
//
// Switches: the tight-coupling flag is decided in torch, once, for kernel and
// plain version alike; the freeze (k tau >= 240) and the release
// (k tau_b >= 0.05) are a single product compared with a constant, so FMA
// contraction cannot move them.
//
// The arithmetic mirrors models/tensors.py:_tensor_rhs/_evolve_t_plain.
#include "common.cuh"

namespace {

constexpr int LMAXT = 16, LMAXTP = 8, LMAXTN = 16;
constexpr int I_HT = 0, I_HTP = 1, I_DT0 = 2;
constexpr int I_DP0 = I_DT0 + LMAXT + 1;
constexpr int I_DN0 = I_DP0 + LMAXTP + 1;
constexpr int NVAR = I_DN0 + LMAXTN + 1;
// fields of qtab (models/tensors.py QT_*)
enum { Q_TAU, Q_OPAC, Q_GG, Q_GN, Q_ADOTOA, Q_TC, Q_VIS, Q_EXPMK, NQ };
constexpr double RSA_KTAU = 240.0, RELEASE_KTAU = 0.05;

// dy/dtau at one stage; returns the source Psi (zero past the freeze).
template <typename T>
__device__ __forceinline__ T rhs(const T* y, const T* __restrict__ q, T k,
                                 bool feedback, T* dy) {
  const T tau = q[Q_TAU], opac = q[Q_OPAC], gg = q[Q_GG], gn = q[Q_GN];
  const T adotoa = q[Q_ADOTOA];
  const bool tc = q[Q_TC] > T(0.5);
  const T ht = y[I_HT], htp = y[I_HTP];
  const T* dt = y + I_DT0;
  const T* dp = y + I_DP0;
  const T* dn = y + I_DN0;
  const T tau_safe = xmax(tau, T(1e-10));
  const T psi_tca = -htp / (T(3) * xmax(opac, T(1e-30)));
  const T psi_full = dt[0] / T(10) + dt[2] / T(7) + T(3) * dt[4] / T(70) -
                     T(3) * dp[0] / T(5) + T(6) * dp[2] / T(7) - T(3) * dp[4] / T(70);
  const T psi = tc ? psi_tca : psi_full;
  const bool rsa = k * tau >= T(RSA_KTAU);
  T stress = T(0);
  if (feedback && !rsa) {
    const T pi_n = dn[0] / T(10) + dn[2] / T(7) + T(3) * dn[4] / T(70);
    const T pi_g = tc ? T(0) : dt[0] / T(10) + dt[2] / T(7) + T(3) * dt[4] / T(70);
    stress = T(16.0 / 3.0) * (gg * pi_g + gn * pi_n);
  }
  dy[I_HT] = htp;
  dy[I_HTP] = -T(2) * adotoa * htp - k * k * ht + stress;

  const bool frozen = tc || rsa;
  // photon intensity Dt_0..Dt_LMAXT
#pragma unroll
  for (int l = 0; l < LMAXT; ++l) {
    const T prev = l == 0 ? T(0) : dt[l - 1];
    T v = (k / T(2 * l + 1)) * (T(l) * prev - T(l + 1) * dt[l + 1]) - opac * dt[l];
    if (l == 0) v = v + (-htp + opac * psi);
    dy[I_DT0 + l] = frozen ? T(0) : v;
  }
  dy[I_DT0 + LMAXT] =
      frozen ? T(0)
             : k * dt[LMAXT - 1] - T(LMAXT + 1) / tau_safe * dt[LMAXT] - opac * dt[LMAXT];
  // photon polarization Dp_0..Dp_LMAXTP
#pragma unroll
  for (int l = 0; l < LMAXTP; ++l) {
    const T prev = l == 0 ? T(0) : dp[l - 1];
    T v = (k / T(2 * l + 1)) * (T(l) * prev - T(l + 1) * dp[l + 1]) - opac * dp[l];
    if (l == 0) v = v + (-opac * psi);
    dy[I_DP0 + l] = frozen ? T(0) : v;
  }
  dy[I_DP0 + LMAXTP] =
      frozen ? T(0)
             : k * dp[LMAXTP - 1] - T(LMAXTP + 1) / tau_safe * dp[LMAXTP] -
                   opac * dp[LMAXTP];
  // neutrinos Dn_0..Dn_LMAXTN, free streaming with the -h' source
#pragma unroll
  for (int l = 0; l < LMAXTN; ++l) {
    const T prev = l == 0 ? T(0) : dn[l - 1];
    T v = (k / T(2 * l + 1)) * (T(l) * prev - T(l + 1) * dn[l + 1]);
    if (l == 0) v = v + (-htp);
    dy[I_DN0 + l] = rsa ? T(0) : v;
  }
  dy[I_DN0 + LMAXTN] =
      rsa ? T(0) : k * dn[LMAXTN - 1] - T(LMAXTN + 1) / tau_safe * dn[LMAXTN];
  return rsa ? T(0) : psi;
}

template <typename T>
__device__ __forceinline__ void initial(T* y) {
#pragma unroll
  for (int j = 0; j < NVAR; ++j) y[j] = T(0);
  y[I_HT] = T(1);
}

template <typename T>
__global__ void __launch_bounds__(32)
tensor_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
              T* __restrict__ out, int C, int S, int nk, int substeps, int feedback) {
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (kk >= nk || c >= C) return;
  const T k = kvec[kk];
  const int R = 3 * substeps + 1;
  const T* Qc = qtab + (size_t)c * S * R * NQ;
  const bool fb = feedback != 0;
  T y[NVAR], acc[NVAR], yt[NVAR], kd[NVAR];
  initial(y);
  for (int i = 0; i < S; ++i) {
    const T* Qi = Qc + (size_t)i * R * NQ;
    for (int s = 0; s < substeps; ++s) {
      const T* qa = Qi + (size_t)(3 * s) * NQ;
      const T* qm = qa + NQ;
      const T* qb = qa + 2 * NQ;
      const T dt = qb[Q_TAU] - qa[Q_TAU];
      rhs(y, qa, k, fb, kd);
#pragma unroll
      for (int j = 0; j < NVAR; ++j) {
        acc[j] = kd[j];
        yt[j] = y[j] + T(0.5) * dt * kd[j];
      }
      rhs(yt, qm, k, fb, kd);
#pragma unroll
      for (int j = 0; j < NVAR; ++j) {
        acc[j] = acc[j] + T(2) * kd[j];
        yt[j] = y[j] + T(0.5) * dt * kd[j];
      }
      rhs(yt, qm, k, fb, kd);
#pragma unroll
      for (int j = 0; j < NVAR; ++j) {
        acc[j] = acc[j] + T(2) * kd[j];
        yt[j] = y[j] + dt * kd[j];
      }
      rhs(yt, qb, k, fb, kd);
#pragma unroll
      for (int j = 0; j < NVAR; ++j) y[j] = y[j] + (dt / T(6)) * (acc[j] + kd[j]);
    }
    const T* qf = Qi + (size_t)(3 * substeps) * NQ;
    if (!(k * qf[Q_TAU] >= T(RELEASE_KTAU))) initial(y);
    const T psi = rhs(y, qf, k, fb, kd);
    const T vis = qf[Q_VIS], expmk = qf[Q_EXPMK];
    const size_t o = ((size_t)c * S + i) * nk + kk;
    const size_t plane = (size_t)C * S * nk;
    out[o] = -y[I_HTP] * expmk + vis * psi;
    out[plane + o] = vis * psi;
    out[2 * plane + o] = y[I_HT];
  }
}

template <typename T>
int launch(const void* qtab, const void* kvec, void* out, int C, int S, int nk,
           int substeps, int feedback, void* stream) {
  const int threads = 32;
  dim3 grid((nk + threads - 1) / threads, C);
  tensor_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)qtab, (const T*)kvec, (T*)out, C, S, nk, substeps, feedback);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tensors_f32(const void* qtab, const void* kvec, void* out, int C,
                           int S, int nk, int substeps, int feedback, void* stream) {
  return launch<float>(qtab, kvec, out, C, S, nk, substeps, feedback, stream);
}

extern "C" int tensors_f64(const void* qtab, const void* kvec, void* out, int C,
                           int S, int nk, int substeps, int feedback, void* stream) {
  return launch<double>(qtab, kvec, out, C, S, nk, substeps, feedback, stream);
}
