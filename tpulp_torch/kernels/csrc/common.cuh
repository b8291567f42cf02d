// Helpers shared by the kernels of tpulp_torch (flush.cu, inner_block.cu,
// fma.cu, lanes.cu, rank1.cu, blocked.cu, rank1_cluster.cu and,
// through grid.cuh, the grid walks): the grid barrier and the
// order-preserving keys of the cooperative kernels (inner_block.cu, the
// grid walks, lanes.cu's lane_primal and lane_bounded) with a warp's share
// of a reduction by keys, exact-rounding arithmetic, the (value, index)
// comparison whose ties go to the smallest index, the block-wide
// reductions of the single-block simplex loops
// (lanes.cu, rank1.cu, blocked.cu): torch's NaN-first
// argmin/argmax with first-index ties, two first-index minima and a sum in
// a fixed tree, in one pass; and what the stream-ordered walks (rank1.cu,
// blocked.cu) and the lane kernels share: the record's status
// gate, the clean-up scan, the ratio test over one column, the bounded
// step's pricing scan and ratio candidates (lanes.cu, bounded_grid.cu), the
// pivot's snapshot (with the redirected no-op pivot), the pivoted entry
// and the devex weights.
#pragma once

#include <cfloat>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace tpulp {

constexpr int BIG_I = 1 << 30;

// ---------------------------------------------------------------------------
// grid barriers
// ---------------------------------------------------------------------------

struct GridBarrier {
  unsigned* bar;
  unsigned target;
  int flag;

  __device__ __forceinline__ void sync() {
    if (!flag) {
      cg::this_grid().sync();
      return;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      target += gridDim.x;
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
      unsigned v;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
      } while (v < target);
    }
    __syncthreads();
  }
};

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

// Order-preserving unsigned keys of values, so that an argmin or argmax
// over a warp is a few redux.sync instructions: the extreme key, then the
// smallest index holding it. -0 folds into +0 (they compare equal), and a
// NaN takes the key that wins (the first of MIN, the last of MAX), as in
// better(), where a NaN carries index BIG_I. (inner_block.cu,
// bounded_grid.cu)
template <typename T> struct KeyOf;
template <> struct KeyOf<float> { using type = unsigned; };
template <> struct KeyOf<double> { using type = unsigned long long; };

__device__ __forceinline__ unsigned okey(float v, bool mx) {
  if (v != v) return mx ? 0xFFFFFFFFu : 0u;
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u >> 31) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ unsigned long long okey(double v, bool mx) {
  if (v != v) return mx ? ~0ull : 0ull;
  const unsigned long long u = (unsigned long long)__double_as_longlong(__dadd_rn(v, 0.0));
  return (u >> 63) ? ~u : (u | (1ull << 63));
}
__device__ __forceinline__ float key_value(unsigned k, bool mx) {
  if (k == (mx ? 0xFFFFFFFFu : 0u)) return __int_as_float(0x7fc00000);
  return __uint_as_float((k >> 31) ? (k & 0x7FFFFFFFu) : ~k);
}
__device__ __forceinline__ double key_value(unsigned long long k, bool mx) {
  if (k == (mx ? ~0ull : 0ull)) return __longlong_as_double(0x7ff8000000000000ll);
  return __longlong_as_double((long long)((k >> 63) ? (k & ~(1ull << 63)) : ~k));
}

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_IDX = 0xffffffffu;

__device__ __forceinline__ unsigned wred(unsigned x, bool mx) {
  return mx ? __reduce_max_sync(FULL, x) : __reduce_min_sync(FULL, x);
}

// (key, idx) <- the warp's extreme key and the smallest index holding it,
// the same in every lane
__device__ __forceinline__ void warp_arg(unsigned& key, unsigned& idx, bool mx) {
  const unsigned k = wred(key, mx);
  idx = __reduce_min_sync(FULL, key == k ? idx : NO_IDX);
  key = k;
}
__device__ __forceinline__ void warp_arg(unsigned long long& key, unsigned& idx, bool mx) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned h = wred(hi, mx);
  const unsigned l = wred(hi == h ? lo : (mx ? 0u : 0xFFFFFFFFu), mx);
  const unsigned long long k = ((unsigned long long)h << 32) | l;
  idx = __reduce_min_sync(FULL, key == k ? idx : NO_IDX);
  key = k;
}

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

// A warp's share of a block reduction by keys (okey and warp_arg: a few
// redux.sync instructions a pick): up to two (key, index) picks, two first
// indices and a sum (grid.cuh's key reductions; lanes.cu's).
template <typename T>
struct KeyRed {
  typename KeyOf<T>::type k1, k2;
  unsigned i1, i2, u1, u2;
  T s;
};

// The warp's shuffle tree of block_reduce's sums: the sum in lane 0.
template <typename T>
__device__ __forceinline__ T warp_tree_sum(T s) {
  for (int off = 16; off > 0; off >>= 1) s = add_rn(s, __shfl_down_sync(FULL, s, off));
  return s;
}

// ---------------------------------------------------------------------------
// the stream-ordered walks (rank1.cu, blocked.cu)
// ---------------------------------------------------------------------------

// The walk records open with the same int32 fields: phase, status, niter.
constexpr int REC_PHASE = 0, REC_STATUS = 1, REC_NITER = 2;
constexpr int WALK_RUNNING = 0;

// A launch works only while the walk runs below its budget: steps enqueued
// past the walk's exit are no-ops, and the budget holds exactly.
__device__ __forceinline__ bool live(const int* rec, int max_iters) {
  return rec[REC_STATUS] == WALK_RUNNING && rec[REC_NITER] < max_iters;
}

// torch.minimum / torch.maximum: NaN if either is NaN
template <typename T> __device__ __forceinline__ T nan_min(T a, T b) {
  return is_nan(a) ? a : is_nan(b) ? b : (b < a ? b : a);
}
template <typename T> __device__ __forceinline__ T nan_max(T a, T b) {
  return is_nan(a) ? a : is_nan(b) ? b : (b > a ? b : a);
}

// The clean-up scan: the first of the m rows whose basic column is
// artificial, BIG_I if none; returned to every thread of the block.
template <typename T>
__device__ int first_artificial_row(const int* basis, const unsigned char* art, int m,
                                    Red<T>* scratch) {
  Red<T> rows = red_identity<T>(false);
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    if (art[basis[i]]) rows.a = min(rows.a, i);
  rows = block_reduce(rows, scratch, false);
  return rows.a;
}

// driver.ratio_rows over one entering column of m rows (col[i * cs], the
// RHS b[i * bs]): whether an entry exceeds piv_tol (has_ratio), and the
// leaving row: among the tie set {b / col <= min} over col > piv_tol (the
// minimum NaN-propagating, so a NaN leaves no tie), Bland's smallest basic
// index (use_bland), else the largest pivot element (max_piv), else the
// first row; torch's argmin/argmax give 0 where nothing qualifies.
// Returned to every thread of the block.
template <typename T>
__device__ int ratio_row(const T* col, long long cs, const T* b, long long bs, const int* basis,
                         int m, T piv_tol, bool use_bland, bool max_piv, Red<T>* scratch,
                         bool& has_ratio) {
  const T inf = pos_inf<T>();
  // the NaN-first argmin of the ratios (v, i), the first row above piv_tol (a)
  Red<T> rq = red_identity<T>(false);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const T c = col[i * cs];
    const bool pos = c > piv_tol;
    if (pos) rq.a = min(rq.a, i);
    offer(rq, pos ? div_rn(b[i * bs], c) : inf, i, false);
  }
  rq = block_reduce(rq, scratch, false);
  has_ratio = rq.a != BIG_I;
  const bool min_nan = is_nan(rq.v);
  if (!use_bland && !max_piv) return min_nan ? 0 : rq.i;
  Red<T> rt = red_identity<T>(!use_bland);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const T c = col[i * cs];
    const T q = c > piv_tol ? div_rn(b[i * bs], c) : inf;
    const bool tie = !min_nan && q <= rq.v;
    if (use_bland)
      offer(rt, tie ? T(basis[i]) : T(BIG_I), i, false);
    else
      offer(rt, tie ? c : -inf, i, true);
  }
  rt = block_reduce(rt, scratch, !use_bland);
  return rt.i;
}

// ---------------------------------------------------------------------------
// the bounded-variable step (lanes.cu's lane_bounded, bounded_grid.cu)
// ---------------------------------------------------------------------------

// Pricing of solve/bounded.py::bounded_simplex_step over the n columns of
// the pricing row crow (entry k at crow[k * cs]; the columns k0 + k of the
// frame, which the results name): Dantzig's NaN-first argmin of c_eff (v,
// i), or devex's argmax of c^2 / gamma over the improving columns; the
// first improving column (a); the first column eligible for the clean-up
// pivot on row rowd (b); the sum of |crow| over the active columns (s):
// this thread's share. crow's entries are cs apart, rowd's cd apart (cs
// where cd is negative).
// One column k of the scan: its pricing entry c, whether it is active (a)
// and eligible for the clean-up pivot (elig: active, not artificial, its
// entry on rowd above piv_tol), its devex weight (read where devex).
template <typename T>
__device__ __forceinline__ void bounded_price_entry(Red<T>& cols, T c, bool a, bool elig,
                                                    T gamma, int k, bool devex, T opt_tol) {
  const T inf = pos_inf<T>();
  const T c_eff = a ? c : inf;
  const bool improving = c_eff < -opt_tol;
  if (improving) cols.a = min(cols.a, k);
  if (elig) cols.b = min(cols.b, k);
  if (a) cols.s = add_rn(cols.s, T(fabs(c)));
  if (devex)
    offer(cols, improving ? div_rn(mul_rn(c, c), gamma) : -inf, k, true);
  else
    offer(cols, c_eff, k, false);
}

template <typename T>
__device__ Red<T> bounded_price_scan(const T* crow, const T* rowd, const unsigned char* act,
                                     const unsigned char* art, const T* gamma, int n,
                                     bool devex, T opt_tol, T piv_tol, long long cs = 1,
                                     int k0 = 0, long long cd = -1) {
  const long long ds = cd < 0 ? cs : cd;
  Red<T> cols = red_identity<T>(devex);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const bool a = act[k] != 0;
    bounded_price_entry(cols, crow[k * cs], a,
                        a && !art[k] && T(fabs(rowd[k * ds])) > piv_tol,
                        devex ? gamma[k] : T(1), k0 + k, devex, opt_tol);
  }
  return cols;
}

// A row's candidates over the entering column (its entry c, its RHS b, its
// basic variable's span ub): a lower hit tl (c > piv_tol), an upper hit tu
// (neg: c < -piv_tol and a finite span), else +inf.
template <typename T>
__device__ __forceinline__ void bounded_ratios(T c, T b, T ub, T piv_tol, T& tl, T& tu,
                                               bool& neg) {
  const T inf = pos_inf<T>();
  tl = c > piv_tol ? div_rn(b, c) : inf;
  neg = c < -piv_tol && finite_val(ub);
  tu = neg ? div_rn(sub_rn(ub, b), -c) : inf;
}

struct BoundedRatio {
  bool has_ratio, kind_up, kind_flip;
  int r_price;
};

// The pivot of a step's update on the (M, N) tableau: (r + 2, j) when the
// step pivots; otherwise the plain step's redirected pivot on (row 2,
// basis0), unless that is an exact no-op (row 2 finite and column basis0
// exactly the unit vector on row 2: it could then change only the sign of
// a zero). Sets (rg, jp); when the update pivots (the result), snapshots
// the pivot's column into colj and its row times 1 / pivot into prow, so
// that the update runs in place. Called by every thread of one block.
template <typename T>
__device__ bool pivot_snapshot(const T* tab, int M, int N, bool do_pivot, int r, int j,
                               int basis0, T* colj, T* prow, Red<T>* scratch, int& rg,
                               int& jp) {
  rg = r + 2;
  jp = j;
  bool pv = do_pivot;
  if (!do_pivot) {
    rg = 2;
    jp = basis0;
    Red<T> chk = red_identity<T>(false);
    for (int k = threadIdx.x; k < N; k += blockDim.x)
      if (!finite_val(tab[2LL * N + k])) chk.a = min(chk.a, k);
    for (int i = threadIdx.x; i < M; i += blockDim.x)
      if (tab[(long long)i * N + jp] != (i == 2 ? T(1) : T(0))) chk.b = min(chk.b, i);
    chk = block_reduce(chk, scratch, false);
    pv = chk.a != BIG_I || chk.b != BIG_I;
  }
  if (pv) {
    const T rinv = div_rn(T(1), tab[(long long)rg * N + jp]);
    for (int i = threadIdx.x; i < M; i += blockDim.x) colj[i] = tab[(long long)i * N + jp];
    for (int k = threadIdx.x; k < N; k += blockDim.x)
      prow[k] = mul_rn(tab[(long long)rg * N + k], rinv);
  }
  return pv;
}

// Entry (i, k) after the pivot on (rg, jp), from its pre-step value t and
// the snapshot: fma(-col[i], prow[k], t), row rg set to prow, column jp to
// the exact unit vector.
template <typename T>
__device__ __forceinline__ T pivoted(const T* colj, const T* prow, int rg, int jp, int i, int k,
                                     T t) {
  if (i == rg) return k == jp ? T(1) : prow[k];
  return k == jp ? T(0) : fma(-colj[i], prow[k], t);
}

// The devex weights of the n columns in place after a step: on a pricing
// pivot (upd) gamma = max(gamma, alpha^2 gamma_q), alpha the post-pivot
// row (prow, column jp snapped to 1), then gamma[leaving] = max(gamma_q /
// piv^2, 1), with torch's NaN rules. Each weight is offered to x's
// NaN-first maximum (v), which the caller's reset reads.
template <typename T>
__device__ void devex_weights(T* gamma, const T* prow, int n, int jp, int leaving, bool upd, T gq,
                              T piv, Red<T>& x) {
  const T q = div_rn(gq, mul_rn(piv, piv));
  const T leave = is_nan(q) ? q : (q < T(1) ? T(1) : q);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    T g = gamma[k];
    if (upd) {
      const T a = k == jp ? T(1) : prow[k];
      g = nan_max(g, mul_rn(mul_rn(a, a), gq));
      if (k == leaving) g = leave;
    }
    gamma[k] = g;
    offer(x, g, k, true);
  }
}

}  // namespace tpulp
