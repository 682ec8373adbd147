// Shared helpers for the cosmomc_tpu_torch kernels: precision-explicit math
// overloads (so a float kernel never silently promotes to double) and the
// plain C entry-point boilerplate.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xlog(float x) { return logf(x); }
__device__ __forceinline__ double xlog(double x) { return log(x); }
__device__ __forceinline__ float xpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double xpow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }
__device__ __forceinline__ float xmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double xmin(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float xmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double xmax(double a, double b) { return fmax(a, b); }

template <typename T>
__device__ __forceinline__ T xclamp(T x, T lo, T hi) {
  return xmin(xmax(x, lo), hi);
}

// jnp.interp-style linear interpolation between two bracketing nodes.
template <typename T>
__device__ __forceinline__ T lerp_nodes(T x, T x0, T x1, T f0, T f1) {
  return f0 + ((x - x0) / (x1 - x0)) * (f1 - f0);
}

constexpr unsigned FULL_WARP = 0xffffffffu;

// Asynchronous copy of one element from global to shared memory (cp.async),
// grouped by commit and awaited by group count: cp_async_wait<1>() returns
// when all but the newest committed group have landed. The copies of a
// thread are visible to other threads only after a barrier.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
