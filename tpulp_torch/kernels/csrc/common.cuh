// Helpers shared by the kernels of tpulp_torch (flush.cu, inner_block.cu,
// fma.cu, lanes.cu, bounded.cu): exact-rounding arithmetic, the (value,
// index) comparison whose ties go to the smallest index, and the
// block-wide reductions of the single-block simplex loops (lanes.cu,
// bounded.cu): torch's NaN-first argmin/argmax with first-index ties, two
// first-index minima and a sum in a fixed tree, in one pass.
#pragma once

#include <cfloat>

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


constexpr unsigned LANE_FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ bool finite_val(T v);
template <> __device__ __forceinline__ bool finite_val<float>(float v) { return fabsf(v) <= FLT_MAX; }
template <> __device__ __forceinline__ bool finite_val<double>(double v) { return fabs(v) <= DBL_MAX; }

// One block-wide reduction carries every quantity a scan needs: a
// (value, index) pick, two first-index minima and a sum.
template <typename V>
struct Red {
  V v;
  int i;
  int a;
  int b;
  V s;
};

template <typename V>
__device__ __forceinline__ Red<V> red_identity(bool mx) {
  Red<V> x;
  x.v = mx ? -pos_inf<V>() : pos_inf<V>();
  x.i = BIG_I;
  x.a = BIG_I;
  x.b = BIG_I;
  x.s = V(0);
  return x;
}

// torch's argmin (mx false) / argmax (mx true): the first NaN wins; else
// the extreme value, ties to the smaller index
template <typename V>
__device__ __forceinline__ void offer(Red<V>& x, V v, int i, bool mx) {
  const bool xn = is_nan(x.v), yn = is_nan(v);
  bool take;
  if (xn || yn)
    take = yn && (!xn || i < x.i);
  else
    take = (mx ? v > x.v : v < x.v) || (v == x.v && i < x.i);
  if (take) {
    x.v = v;
    x.i = i;
  }
}

template <typename V>
__device__ __forceinline__ void combine(Red<V>& x, const Red<V>& y, bool mx) {
  offer(x, y.v, y.i, mx);
  x.a = min(x.a, y.a);
  x.b = min(x.b, y.b);
  x.s = add_rn(x.s, y.s);
}

template <typename V>
__device__ __forceinline__ Red<V> warp_reduce(Red<V> x, bool mx) {
  for (int off = 16; off > 0; off >>= 1) {
    Red<V> y;
    y.v = __shfl_down_sync(LANE_FULL, x.v, off);
    y.i = __shfl_down_sync(LANE_FULL, x.i, off);
    y.a = __shfl_down_sync(LANE_FULL, x.a, off);
    y.b = __shfl_down_sync(LANE_FULL, x.b, off);
    y.s = __shfl_down_sync(LANE_FULL, x.s, off);
    combine(x, y, mx);
  }
  return x;
}

// The block's reduction, returned to every thread. The tree is fixed for a
// block size, so the sums come out the same in every run.
template <typename V>
__device__ Red<V> block_reduce(Red<V> x, Red<V>* scratch, bool mx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_reduce(x, mx);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < nw ? scratch[lane] : red_identity<V>(mx);
    x = warp_reduce(x, mx);
    if (lane == 0) scratch[32] = x;
  }
  __syncthreads();
  return scratch[32];
}

}  // namespace tpulp
