// Helpers shared by the kernels of tpulp_torch (flush.cu, inner_block.cu,
// fma.cu): exact-rounding arithmetic, and the (value, index) comparison
// whose ties go to the smallest index.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace tpulp {

constexpr int BIG_I = 1 << 30;

// Separate multiply and add, each rounded to nearest. nvcc contracts a*b+c
// into one fma by default; the decision arithmetic of a pivot must round
// as the plain PyTorch version does, so it spells the two roundings out.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T> __device__ __forceinline__ T pos_inf();
template <> __device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }

// A (value, index) candidate of an argmin/argmax.
template <typename V> struct VI {
  V v;
  int i;
};

// The better of two candidates. A NaN value wins and carries index BIG_I:
// jnp.min/max propagate NaN, after which no element compares <= or >= to
// the extreme, so the first-index search of the reference finds nothing.
// Among equal values the smaller index wins, whatever order the threads
// and blocks combine in: that is the reference's first-index tie rule.
template <typename V, bool MAX>
__device__ __forceinline__ VI<V> better(VI<V> a, VI<V> b) {
  if (is_nan(a.v)) return a;
  if (is_nan(b.v)) return b;
  const bool take = MAX ? (b.v > a.v) : (b.v < a.v);
  if (take || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

}  // namespace tpulp
