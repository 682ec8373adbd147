// K1: RK4 of the synchronous-gauge Boltzmann hierarchy, base LCDM layout.
//
// Replaces cosmomc_tpu/models/perturbations.py:evolve_perturbations (the
// lax.scan at perturbations.py:928 over make_rhs.rhs :375-687 and rk4_step
// :869). One thread owns one (chain, k) lane and runs the whole tau loop:
// the 37-variable state, the RK4 accumulator, the stage state and the stage
// derivative live in registers (and spill to local memory: 4 x 37 values,
// 8 bytes each in float64, is more than the 255-register limit). Every
// k-independent input of the RHS (a, opacity, c_s^2, local step, species
// densities, conformal H, pressure, visibility) comes precomputed per
// (chain, step, stage) in `qtab`, read by all lanes of a chain alike.
// Bound: 5 RHS evaluations per step over ~8191 dependent steps, about 2.5e3
// flops a step per lane: latency- and compute-bound with the spills; the
// grid is (k blocks) x (chains), 248 lanes per chain on the main path.
//
// TCA/RSA switches are real branches per lane. Sources are written as
// (plane, chain, step, k) so a warp stores 32 consecutive k values.
//
// The arithmetic mirrors models/perturbations.py:_rhs/_sources.
#include "common.cuh"

namespace {

constexpr int LMAXG = 12, LMAXGP = 8, LMAXNR = 10;
constexpr int I_ETA = 0, I_DC = 1, I_DB = 2, I_TB = 3, I_DG = 4, I_TG = 5;
constexpr int I_FG2 = 6;
constexpr int I_GP0 = I_FG2 + (LMAXG - 1);
constexpr int I_DN = I_GP0 + (LMAXGP + 1);
constexpr int I_TN = I_DN + 1;
constexpr int I_FN2 = I_TN + 1;
constexpr int NVAR = I_FN2 + (LMAXNR - 1);
constexpr int NFG = LMAXG - 1, NGP = LMAXGP + 1, NFN = LMAXNR - 1;

// fields of qtab (models/perturbations.py Q_*)
enum { Q_TAU, Q_OPAC, Q_CSQB, Q_DTLOC, Q_GG, Q_GN, Q_GML, Q_GC, Q_GB,
       Q_ADOTOA, Q_GRHO, Q_GPRES, Q_R, Q_VIS, Q_EXPMK, Q_GNISW, NQ };
constexpr int NPLANE = 7;

constexpr double TC_KTAUC = 0.015, TC_OPACTAU = 200.0;
constexpr double IC_RELEASE_KTAU = 0.08;

template <typename T>
struct Aux {
  T hdot, etadot, dgpi, sigma_g, sigma_n, sigg_dot, sign_dot, pol_term;
};

template <typename T>
__device__ __forceinline__ void ics(T k, T tau, T rnu, T* y) {
#pragma unroll
  for (int j = 0; j < NVAR; ++j) y[j] = T(0);
  const T kt = k * tau;
  const T dg = -(T(2) / T(3)) * (kt * kt);
  const T theta = -(T(1) / T(18)) * k * (kt * kt * kt);
  y[I_DG] = dg;
  y[I_DC] = T(0.75) * dg;
  y[I_DB] = T(0.75) * dg;
  y[I_DN] = dg;
  y[I_TG] = theta;
  y[I_TB] = theta;
  y[I_TN] = theta * (T(23) + T(4) * rnu) / (T(15) + T(4) * rnu);
  y[I_FN2] = T(2) * (T(2) * (kt * kt) / (T(3) * (T(15) + T(4) * rnu)));
  y[I_ETA] = T(2) - (T(5) + T(4) * rnu) / (T(6) * (T(15) + T(4) * rnu)) * (kt * kt);
}

template <typename T>
__device__ __forceinline__ void rhs(const T* y, const T* __restrict__ q, T k,
                                    T rsa_ktau, T* dy, Aux<T>* aux) {
  const T tau = q[Q_TAU], opac = q[Q_OPAC], csqb = q[Q_CSQB], dt_loc = q[Q_DTLOC];
  const T grho_g = q[Q_GG], grho_n = q[Q_GN], gml = q[Q_GML];
  const T grho_c = q[Q_GC], grho_b = q[Q_GB], adotoa = q[Q_ADOTOA], R = q[Q_R];
  const T eta = y[I_ETA], dc = y[I_DC], db = y[I_DB], tb = y[I_TB];
  T dg = y[I_DG], tg = y[I_TG], dn = y[I_DN], tn = y[I_TN];
  const T k2 = k * k;
  const T tau_safe = xmax(tau, T(1e-10));

  const T tauc = T(1) / xmax(opac, T(1e-30));
  const bool rsa = k * tau >= rsa_ktau;
  const T lam = opac * (T(1) + R);
  const bool tc_off = (k * tauc >= T(TC_KTAUC) || opac * tau <= T(TC_OPACTAU)) &&
                      (lam * dt_loc <= T(1.3));
  const bool tc_on = !tc_off && !rsa;

  if (rsa) {
    const T dgrho_m = grho_c * dc + grho_b * db;
    const T z_rsa = (T(0.5) * dgrho_m / k + k * eta) / adotoa;
    const T dz_rsa = -adotoa * z_rsa - T(0.5) * dgrho_m / k;
    const T dn_rsa = -T(4) * dz_rsa / k;
    const T tn_rsa = -k * z_rsa;
    dg = dn_rsa - (T(4) / k) * opac * (tb / k + z_rsa);
    tg = tn_rsa;
    dn = dn_rsa;
    tn = tn_rsa;
  }

  const T wnu_m = (T(4) / T(3)) * gml;
  const T fg0 = y[I_FG2], fn0 = y[I_FN2];
  const T gp0 = y[I_GP0], gp2 = y[I_GP0 + 2];
  const T sigma_n = rsa ? T(0) : fn0 / T(2);
  const T dgrho = grho_c * dc + grho_b * db + grho_g * dg + grho_n * dn + gml * dn;
  const T hdot = (T(2) * k2 * eta + dgrho) / adotoa;
  const T dgq = (T(4) / T(3)) * (grho_g * tg + grho_n * tn) + grho_b * tb + wnu_m * tn;
  const T etadot = T(0.5) * dgq / k2;

  const T fg2_tca = (T(4) / T(3)) * tauc *
                    ((T(8) / T(15)) * tg + (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot);
  const T fg2_eff = rsa ? T(0) : (tc_on ? fg2_tca : fg0);
  const T sigma_g = fg2_eff / T(2);
  const T pol_term = rsa ? T(0) : (tc_on ? T(2.5) * fg2_tca : fg0 + gp0 + gp2);
  const T dgpi = (T(4) / T(3)) * (grho_g * sigma_g + grho_n * sigma_n) + wnu_m * sigma_n;

  const T sl = dg / T(4) - sigma_g;
  T tbdot, tgdot;
  if (rsa) {
    tbdot = -adotoa * tb + csqb * k2 * db;
    tgdot = T(0);
  } else if (tc_on) {
    tbdot = (-adotoa * tb + csqb * k2 * db + R * k2 * sl) / (T(1) + R);
    tgdot = tbdot;
  } else {
    tbdot = -adotoa * tb + csqb * k2 * db + R * opac * (tg - tb);
    tgdot = k2 * sl + opac * (tb - tg);
  }
  dy[I_ETA] = etadot;
  dy[I_DC] = -T(0.5) * hdot;
  dy[I_DB] = -tb - T(0.5) * hdot;
  dy[I_TB] = tbdot;
  dy[I_DG] = rsa ? T(0) : -(T(4) / T(3)) * tg - (T(2) / T(3)) * hdot;
  dy[I_TG] = tgdot;
  dy[I_DN] = rsa ? T(0) : -(T(4) / T(3)) * tn - (T(2) / T(3)) * hdot;
  dy[I_TN] = rsa ? T(0) : k2 * (dn / T(4) - sigma_n);

  const bool frozen = tc_on || rsa;
  const T* fg = y + I_FG2;
  const T* gp = y + I_GP0;
  const T* fn = y + I_FN2;
  // photon temperature F_2..F_LMAXG
  const T fg2dot = (T(8) / T(15)) * tg - (T(3) / T(5)) * k * fg[1] +
                   (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot -
                   opac * (T(0.9) * fg[0] - T(0.1) * (gp[0] + gp[2]));
#pragma unroll
  for (int j = 1; j < NFG - 1; ++j) {
    const T l = T(j + 2);
    const T v = (k / (T(2) * l + T(1))) * (l * fg[j - 1] - (l + T(1)) * fg[j + 1]) -
                opac * fg[j];
    dy[I_FG2 + j] = frozen ? T(0) : v;
  }
  dy[I_FG2] = frozen ? T(0) : fg2dot;
  dy[I_FG2 + NFG - 1] =
      frozen ? T(0)
             : k * fg[NFG - 2] - T(LMAXG + 1) / tau_safe * fg[NFG - 1] - opac * fg[NFG - 1];
  // photon polarization G_0..G_LMAXGP
#pragma unroll
  for (int j = 0; j < NGP - 1; ++j) {
    const T l = T(j);
    const T prev = j == 0 ? T(0) : gp[j - 1];
    T v = (k / (T(2) * l + T(1))) * (l * prev - (l + T(1)) * gp[j + 1]) - opac * gp[j];
    if (j == 0) v = v + opac * T(0.5) * pol_term;
    if (j == 2) v = v + opac * T(0.1) * pol_term;
    dy[I_GP0 + j] = frozen ? T(0) : v;
  }
  dy[I_GP0 + NGP - 1] =
      frozen ? T(0)
             : k * gp[NGP - 2] - T(LMAXGP + 1) / tau_safe * gp[NGP - 1] - opac * gp[NGP - 1];
  // massless neutrinos F_2..F_LMAXNR
  const T fn2dot = (T(8) / T(15)) * tn - (T(3) / T(5)) * k * fn[1] +
                   (T(4) / T(15)) * hdot + (T(8) / T(5)) * etadot;
#pragma unroll
  for (int j = 1; j < NFN - 1; ++j) {
    const T l = T(j + 2);
    const T v = (k / (T(2) * l + T(1))) * (l * fn[j - 1] - (l + T(1)) * fn[j + 1]);
    dy[I_FN2 + j] = rsa ? T(0) : v;
  }
  dy[I_FN2] = rsa ? T(0) : fn2dot;
  dy[I_FN2 + NFN - 1] =
      rsa ? T(0) : k * fn[NFN - 2] - T(LMAXNR + 1) / tau_safe * fn[NFN - 1];

  aux->hdot = hdot;
  aux->etadot = etadot;
  aux->dgpi = dgpi;
  aux->sigma_g = sigma_g;
  aux->sigma_n = sigma_n;
  aux->sigg_dot = (frozen ? T(0) : fg2dot) / T(2);
  aux->sign_dot = (rsa ? T(0) : fn2dot) / T(2);
  aux->pol_term = pol_term;
}

template <typename T>
__device__ __forceinline__ void sources(const T* y, const T* dy, const Aux<T>& aux,
                                        const T* __restrict__ q, T k, T* s) {
  const T adotoa = q[Q_ADOTOA], grho_g = q[Q_GG], grho_n = q[Q_GNISW];
  const T vis = q[Q_VIS], expmk = q[Q_EXPMK];
  const T k2 = k * k;
  const T alpha = (aux.hdot + T(6) * aux.etadot) / (T(2) * k2);
  const T X = T(1.5) * aux.dgpi / k2;
  const T eta = y[I_ETA];
  const T phi = eta - adotoa * alpha;
  const T psi = phi - X;
  const T dadotoa = -(q[Q_GRHO] + T(3) * q[Q_GPRES]) / T(6);
  const T alphadot = eta - X - T(2) * adotoa * alpha;
  const T phidot = aux.etadot - dadotoa * alpha - adotoa * alphadot;
  const T dgpidot = (T(4) / T(3)) *
                    (-T(2) * adotoa * (grho_g * aux.sigma_g + grho_n * aux.sigma_n) +
                     grho_g * aux.sigg_dot + grho_n * aux.sign_dot);
  const T psidot = phidot - T(1.5) * dgpidot / k2;
  const T theta0_N = y[I_DG] / T(4) - adotoa * alpha;
  const T vb_N = (y[I_TB] + k2 * alpha) / k;
  const T Pi = aux.pol_term / T(4);
  s[0] = vis * (theta0_N + psi + Pi / T(4)) + expmk * (phidot + psidot);
  s[1] = vis * vb_N;
  s[2] = T(0.75) * vis * Pi;
  s[3] = expmk * (phi + psi);
  const T gc = q[Q_GC], gb = q[Q_GB];
  const T wsum = gc + gb;
  s[4] = (gc * y[I_DC] + gb * y[I_DB]) / wsum;
  s[5] = (gc * dy[I_DC] + gb * dy[I_DB]) / wsum;
  s[6] = T(0.5) * (phi + psi);
}

template <typename T>
__global__ void __launch_bounds__(64)
boltzmann_kernel(const T* __restrict__ qtab, const T* __restrict__ kvec,
                 const T* __restrict__ rnu_in, T* __restrict__ out, int C,
                 int S, int nk, T rsa_ktau) {
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (kk >= nk || c >= C) return;
  const T k = kvec[kk];
  const T rnu = rnu_in[c];
  const T* Qc = qtab + (size_t)c * S * 3 * NQ;
  T y[NVAR], acc[NVAR], yt[NVAR], kd[NVAR];
  Aux<T> aux;
  ics(k, Qc[Q_TAU], rnu, y);
  for (int i = 0; i < S; ++i) {
    const T* qa = Qc + (size_t)i * 3 * NQ;
    const T* qm = qa + NQ;
    const T* qb = qa + 2 * NQ;
    const T tau_b = qb[Q_TAU];
    const T dt = tau_b - qa[Q_TAU];
    rhs(y, qa, k, rsa_ktau, kd, &aux);
#pragma unroll
    for (int j = 0; j < NVAR; ++j) {
      acc[j] = kd[j];
      yt[j] = y[j] + T(0.5) * dt * kd[j];
    }
    rhs(yt, qm, k, rsa_ktau, kd, &aux);
#pragma unroll
    for (int j = 0; j < NVAR; ++j) {
      acc[j] = acc[j] + T(2) * kd[j];
      yt[j] = y[j] + T(0.5) * dt * kd[j];
    }
    rhs(yt, qm, k, rsa_ktau, kd, &aux);
#pragma unroll
    for (int j = 0; j < NVAR; ++j) {
      acc[j] = acc[j] + T(2) * kd[j];
      yt[j] = y[j] + dt * kd[j];
    }
    rhs(yt, qb, k, rsa_ktau, kd, &aux);
    if (k * tau_b >= T(IC_RELEASE_KTAU) || tau_b >= T(3)) {
#pragma unroll
      for (int j = 0; j < NVAR; ++j) y[j] = y[j] + (dt / T(6)) * (acc[j] + kd[j]);
    } else {
      ics(k, tau_b, rnu, y);
    }
    rhs(y, qb, k, rsa_ktau, kd, &aux);
    T s[NPLANE];
    sources(y, kd, aux, qb, k, s);
#pragma unroll
    for (int p = 0; p < NPLANE; ++p)
      out[(((size_t)p * C + c) * S + i) * nk + kk] = s[p];
  }
}

template <typename T>
int launch(const void* qtab, const void* kvec, const void* rnu, void* out, int C,
           int S, int nk, double rsa_ktau, void* stream) {
  const int threads = 64;
  dim3 grid((nk + threads - 1) / threads, C);
  boltzmann_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T*)qtab, (const T*)kvec, (const T*)rnu, (T*)out, C, S, nk, (T)rsa_ktau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int boltzmann_f32(const void* qtab, const void* kvec, const void* rnu,
                             void* out, int C, int S, int nk, double rsa_ktau,
                             void* stream) {
  return launch<float>(qtab, kvec, rnu, out, C, S, nk, rsa_ktau, stream);
}

extern "C" int boltzmann_f64(const void* qtab, const void* kvec, const void* rnu,
                             void* out, int C, int S, int nk, double rsa_ktau,
                             void* stream) {
  return launch<double>(qtab, kvec, rnu, out, C, S, nk, rsa_ktau, stream);
}
