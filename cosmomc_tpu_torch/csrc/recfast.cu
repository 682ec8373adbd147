// K4: the RECFAST recurrence (T_M, x_He, x_H down the descending-z grid).
//
// Replaces cosmomc_tpu/models/recfast.py:compute_thermo (the lax.scan at
// recfast.py:279). One thread owns one chain and walks all N-1 steps; the
// state is three scalars in registers. Every z-only quantity (H(z), n_H,
// T_rad, the K correction, the Saha solutions) arrives precomputed in the
// (C, 12, N) table `zt`, so the thread does only the state-dependent work:
// a Crank-Nicolson step with two Newton iterations for each of T_M, x_He and
// x_H, with the closed-form derivative of each residual, then the regime
// selection. Bound: the 7999-step dependency chain (about 300 flops a step),
// i.e. latency, not bandwidth; the design keeps the chain as short as the
// algorithm allows and leaves throughput to the chains axis.
//
// The arithmetic mirrors models/recfast.py:_scan_plain line for line.
#include "common.cuh"

namespace {

// rows of the z table (models/recfast.py ZT_*)
enum { ZT_Z, ZT_TR, ZT_CT, ZT_HZ1, ZT_N, ZT_NHE, ZT_KHE, ZT_KH, ZT_XEEARLY,
       ZT_XHESAHA, ZT_XHSAHA, ZT_TMHOT, N_ZT };
// constants (models/recfast.py KERNEL_CONSTS order)
enum { K_CR, K_CDB, K_CL, K_CDB_HE, K_CL_HE, K_CK_HE, K_COMPT, K_BFACT,
       K_LAMBDA_H, K_LAMBDA_HE, K_AH, K_B_PPB, K_C_PPB, K_D_PPB, K_AHE,
       K_E0_VF, K_E1_VF, K_T0_VF, K_T1_VF, N_K };

template <typename T>
struct Consts {
  T k[N_K];
};

// rate coefficients at one (z node, T_M): He uses bt = -Bfact/T_M and the
// escape factor K_He; H uses the K-corrected escape factor K_H
template <typename T>
struct Rate {
  T rdown, rup, ecl, bt, K, n, nhe, hz1;
};

template <typename T>
__device__ __forceinline__ T alpha_h(T t_m, const Consts<T>& c) {
  T t = t_m / T(1e4);
  return c.k[K_AH] * xpow(t, c.k[K_B_PPB]) /
         (T(1) + c.k[K_C_PPB] * xpow(t, c.k[K_D_PPB]));
}

template <typename T>
__device__ __forceinline__ T alpha_he(T t_m, const Consts<T>& c) {
  T sq0 = xsqrt(t_m / c.k[K_T0_VF]);
  T sq1 = xsqrt(t_m / c.k[K_T1_VF]);
  return c.k[K_AHE] / (sq0 * xpow(T(1) + sq0, c.k[K_E0_VF]) *
                       xpow(T(1) + sq1, c.k[K_E1_VF]));
}

template <typename T>
__device__ __forceinline__ T row(const T* Z, int N, int f, int k) {
  return Z[(size_t)f * N + k];
}

template <typename T>
__device__ __forceinline__ Rate<T> he_rate(const T* Z, int N, int k, T t,
                                           const Consts<T>& c) {
  Rate<T> r;
  r.rdown = alpha_he(t, c);
  r.rup = T(4) * r.rdown * xpow(c.k[K_CR] * t, T(1.5)) * xexp(-c.k[K_CDB_HE] / t);
  r.ecl = xexp(-c.k[K_CL_HE] / t);
  r.bt = -c.k[K_BFACT] / t;
  r.K = row(Z, N, ZT_KHE, k);
  r.n = row(Z, N, ZT_N, k);
  r.nhe = row(Z, N, ZT_NHE, k);
  r.hz1 = row(Z, N, ZT_HZ1, k);
  return r;
}

template <typename T>
__device__ __forceinline__ Rate<T> h_rate(const T* Z, int N, int k, T t,
                                          const Consts<T>& c) {
  Rate<T> r;
  r.rdown = alpha_h(t, c);
  r.rup = r.rdown * xpow(c.k[K_CR] * t, T(1.5)) * xexp(-c.k[K_CDB] / t);
  r.ecl = xexp(-c.k[K_CL] / t);
  r.bt = T(0);
  r.K = row(Z, N, ZT_KH, k);
  r.n = row(Z, N, ZT_N, k);
  r.nhe = T(0);
  r.hz1 = row(Z, N, ZT_HZ1, k);
  return r;
}

// He singlet rate (xe = xH + fHe xx) and its derivative in xx
template <typename T>
__device__ __forceinline__ void dxhe(T xx, T xe, T fhe, const Rate<T>& r,
                                     const Consts<T>& c, T* v, T* d) {
  T nhe1 = (T(1) - xx) * r.nhe;
  bool live = nhe1 > T(1e-30);
  nhe1 = live ? nhe1 : T(1e-30);
  T arg = r.bt - xlog(r.K * nhe1);
  T u = xexp(xmin(arg, T(80)));
  T du = (live && arg < T(80)) ? u * r.nhe / nhe1 : T(0);
  T den = u + c.k[K_LAMBDA_HE] + r.rup;
  T crate = (u + c.k[K_LAMBDA_HE]) / den;
  T dcrate = du * r.rup / (den * den);
  T q = xe * xx * r.n * r.rdown - r.rup * (T(1) - xx) * r.ecl;
  T dq = (fhe * xx + xe) * r.n * r.rdown + r.rup * r.ecl;
  *v = q * crate / r.hz1;
  *d = (dq * crate + q * dcrate) / r.hz1;
}

// Peebles H rate (xe = xx + fHe xHe) and its derivative in xx
template <typename T>
__device__ __forceinline__ void dxh(T xx, T xe, const Rate<T>& r,
                                    const Consts<T>& c, T* v, T* d) {
  T n1s = (T(1) - xx) * r.n;
  bool live = n1s > T(1e-30);
  n1s = live ? n1s : T(1e-30);
  T den = T(1) + r.K * (c.k[K_LAMBDA_H] + r.rup) * n1s;
  T crate = (T(1) + r.K * c.k[K_LAMBDA_H] * n1s) / den;
  T dcrate = live ? r.n * r.K * r.rup / (den * den) : T(0);
  T q = xe * xx * r.n * r.rdown - r.rup * (T(1) - xx) * r.ecl;
  T dq = (xx + xe) * r.n * r.rdown + r.rup * r.ecl;
  *v = q * crate / r.hz1;
  *d = (dq * crate + q * dcrate) / r.hz1;
}

template <typename T>
__device__ __forceinline__ T newton_step(T xp, T x, T f_prev, T dz, T v, T d) {
  T g = xp - x - T(0.5) * dz * (f_prev + v);
  T gp = T(1) - T(0.5) * dz * d;
  return xp - g / (xabs(gp) > T(1e-12) ? gp : T(1));
}

template <typename T>
__global__ void recfast_kernel(const T* __restrict__ zt, const T* __restrict__ fhe_in,
                               const T* __restrict__ kc, T* __restrict__ xe_out,
                               T* __restrict__ tm_out, int C, int N) {
  int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= C) return;
  Consts<T> c;
#pragma unroll
  for (int i = 0; i < N_K; ++i) c.k[i] = kc[i];
  const T* Z = zt + (size_t)ch * N_ZT * N;
  T* xe_row = xe_out + (size_t)ch * N;
  T* tm_row = tm_out + (size_t)ch * N;
  const T fhe = fhe_in[ch];
  T xH = T(1), xHe = T(1);
  T tm = row(Z, N, ZT_TMHOT, 0);
  xe_row[0] = T(1) + T(2) * fhe;
  tm_row[0] = tm;
  for (int i = 0; i + 1 < N; ++i) {
    const int j = i + 1;
    const T z = row(Z, N, ZT_Z, j);
    const T dz = z - row(Z, N, ZT_Z, i);
    const T xe_tot = xH + fhe * xHe;

    // T_M: dTm/dz = A (tm - tr) + 2 tm/(1+z), A = CT xe/(1+xe+fHe)
    const T xfac = xe_tot / (T(1) + xe_tot + fhe);
    const T A0 = row(Z, N, ZT_CT, i) * xfac, A1 = row(Z, N, ZT_CT, j) * xfac;
    const T tr1 = row(Z, N, ZT_TR, j), zp1 = T(1) + z;
    const T fT = A0 * (tm - row(Z, N, ZT_TR, i)) +
                 T(2) * tm / (T(1) + row(Z, N, ZT_Z, i));
    T tm_new = tm + dz * fT;
#pragma unroll
    for (int it = 0; it < 2; ++it)
      tm_new = newton_step(tm_new, tm, fT, dz,
                           A1 * (tm_new - tr1) + T(2) * tm_new / zp1,
                           A1 + T(2) / zp1);

    // He singlet channel, x_H frozen
    T v, d, f_he, f_h;
    const Rate<T> he1 = he_rate(Z, N, j, tm_new, c);
    dxhe(xHe, xe_tot, fhe, he_rate(Z, N, i, tm, c), c, &f_he, &d);
    T xHe_ode = xHe + dz * f_he;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      dxhe(xHe_ode, xH + fhe * xHe_ode, fhe, he1, c, &v, &d);
      xHe_ode = newton_step(xHe_ode, xHe, f_he, dz, v, d);
    }

    // H with the new x_He
    const Rate<T> h1 = h_rate(Z, N, j, tm_new, c);
    dxh(xH, xe_tot, h_rate(Z, N, i, tm, c), c, &f_h, &d);
    T xH_ode = xH + dz * f_h;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      dxh(xH_ode, xH_ode + fhe * xHe_ode, h1, c, &v, &d);
      xH_ode = newton_step(xH_ode, xH, f_h, dz, v, d);
    }

    // regime selection
    const T xhe_s = row(Z, N, ZT_XHESAHA, j), xh_s = row(Z, N, ZT_XHSAHA, j);
    xHe = xclamp(xhe_s > T(0.995) ? xhe_s : xHe_ode, T(0), T(1));
    xH = xclamp(xh_s > T(0.985) ? xh_s : xH_ode, T(0), T(1));
    xe_row[j] = z > T(5500) ? row(Z, N, ZT_XEEARLY, j) : xH + fhe * xHe;
    tm = z > T(3000) ? row(Z, N, ZT_TMHOT, j) : tm_new;
    tm_row[j] = tm;
  }
}

template <typename T>
int launch(const void* zt, const void* fhe, const void* kc,
           void* xe, void* tm, int C, int N, void* stream) {
  const int threads = 32;
  const int blocks = (C + threads - 1) / threads;
  recfast_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)zt, (const T*)fhe, (const T*)kc, (T*)xe, (T*)tm,
      C, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int recfast_f32(const void* zt, const void* fhe, const void* kc, void* xe, void* tm, int C, int N,
                           void* stream) {
  return launch<float>(zt, fhe, kc, xe, tm, C, N, stream);
}

extern "C" int recfast_f64(const void* zt, const void* fhe, const void* kc, void* xe, void* tm, int C, int N,
                           void* stream) {
  return launch<double>(zt, fhe, kc, xe, tm, C, N, stream);
}
