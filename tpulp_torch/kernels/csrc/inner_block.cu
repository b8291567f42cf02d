// inner_block_kernel: up to K simplex pivots of the kernel engine in one
// launch, on the implicit tableau T0 + U^T V, without writing T.
//
// Replaces tpulp/kernels/pallas_block.py::blocked_inner_block (the TPU
// kernel body is _make_kernel). Per pivot: cleanup of basic artificials,
// pricing (Dantzig / Bland / devex, first index on ties), the phase-1 to
// phase-2 switch, the entering column T0[:, j] + V[:, j]^T U, the ratio
// test (first-index or Bland ties), the eta append U[t] = (e_r - col)/piv
// and V[t] = pivot row, the row0/row1/bvec updates, the basis and
// art-basic masks, devex weights (reset past 1e8), the stall switch to
// Bland, and the status with the non-finite guard. Every scalar stays on
// the device; the host reads ``iscal`` once per block.
//
// What bounds it on the H100: the dependency chain. A pivot needs at least
// two dependent reductions over the whole grid (the entering column's
// argmin over every row, then the next pricing argmin over every column),
// each a grid-wide barrier plus a round trip through L2 to gather the
// blocks' partials, and around them the loads of T0's column and row from
// device memory. The bytes (2K(M + N) values of U and V per block) and the
// K^2(M + N) operations of the eta corrections are a few microseconds of
// the card's rate.
//
// Design: one persistent cooperative block of 256 threads per SM. Block g
// owns a contiguous range of rows R_g and of columns C_g (RB and CB, from
// the wrapper's plan: ceil(M / G) and ceil(N / G), rounded up to 8). The
// owner alone prices C_g, runs the ratio test over R_g, builds the pivot
// row over C_g, updates row0/row1/gamma/ca over C_g and bvec/ab/basis over
// R_g, and appends U[t, R_g] and V[t, C_g]. Its running vectors live in
// shared memory (written through to global memory), and so do its eta
// slices U[0:K, R_g] and V[0:K, C_g] in the "resident" variant; the
// "streaming" variant keeps the same slices in a per-block scratch in
// global memory (read from L2) when they do not fit. Either way the slices
// are stored output-major (U[k, i] at [i * K + k]), so the 32 lanes of a
// warp read 32 consecutive k of one output.
//
// Two grid barriers per typical pivot: (1) after the entering column and
// the ratio test's partials, (2) after the pivot row, the appends, the
// running-vector updates AND the next pivot's pricing partials, which the
// owner of C_g computes from the values it has just updated. Everything
// the next pricing depends on is known before the barrier (the phase
// switch and the masking of ca, the art-basic mask at r); the devex reset
// depends on the grid-wide max of the new weights, so the pricing partials
// are published under both the new weights and all-ones, and every block
// picks one after the barrier. A cleanup pivot (B) and a Bland pivot (D)
// add one barrier each. Barrier: a flag barrier (a monotone counter,
// red.release.gpu add and ld.acquire.gpu spin), which barrier_probe_kernel
// timed faster than cooperative_groups' grid.sync() on the H100.
//
// Every block reduces the partials of a stage in the same fixed order, so
// all blocks hold the same scalars without a broadcast. Each (value,
// index) reduction keeps the smallest index among equal values, which
// reproduces the reference's _first_true_index / _argmin_first; no float
// atomics. Each eta correction is one warp's dot product in a canonical
// order: lane q accumulates k = q, q + 32, ... in double (also for float
// data), and the 32 sums are combined by an xor butterfly (every lane ends
// with the same bits); the element of T0 is added in double and the sum
// rounded once to T. v_last = vrow[N - 1], which every block needs for
// bvec, is that same dot computed by every block from its own copy of
// V[:, N - 1] (each block appends v_last to it): bit for bit the owner's
// value, with no extra barrier. The loads of a stage that do not depend on
// each other are issued together (T0's column or row with the eta
// coefficients); the ratio test's winner carries its pivot element and
// leaving column through the reduction, and z is read with the partials.
// The rest of
// the arithmetic rounds as the plain version does: a separate rounding per
// operation (no contraction), and one fused multiply-add for the running
// vectors. Column j of T is read straight from the row-major T: the TPU
// kernel's transposed copy Tt is not needed.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tpulp {

constexpr int IB_THREADS = 256;
constexpr int IB_WARPS = IB_THREADS / 32;
constexpr int IB_MAX_GRID = IB_THREADS;  // one partial per thread in a gather
constexpr int IB_MAX_K = 1024;
constexpr int IB_OUTS = 8;  // outputs per warp pass of the eta dot products

enum { S_RUNNING = 0, S_OPTIMAL = 1, S_UNBOUNDED = 2, S_INFEASIBLE = 3, S_NUMERIC = 5 };

// the stages that stage_cycles splits a pivot into (block 0's clock)
enum {
  ST_PICK,      // the pivot's choices from the gathered pricing, (B) cleanup
  ST_COL_LOAD,  // T0's column and the coefficients V[:, j] into shared memory
  ST_COL_DOT,   // the entering column's eta sums
  ST_COL_RED,   // the ratio test's partials, reduced in the block
  ST_BAR1,      // grid barrier 1
  ST_RATIO,     // gather of the ratio partials, (D) Bland
  ST_ROW_LOAD,  // T0's row and the coefficients U[:, r] into shared memory
  ST_ROW_DOT,   // v_last and the pivot row's eta sums
  ST_UPDATE,    // appends, running vectors, next pricing per thread
  ST_UPD_RED,   // the next pricing partials, reduced in the block
  ST_BAR2,      // grid barrier 2
  ST_GATHER,    // gather of the pricing partials
  ST_BOOK,      // the scalar bookkeeping
  IB_STAGES
};

// slots of the per-block partials
enum {
  P_RD, P_JBL, P_DZ, P_DZ1, P_CSUM, P_GMAX, P_BSUM, P_RATIO, P_PIV, P_LEAVE, P_POS, P_JD, P_RBL,
  P_NSLOT
};

template <typename T>
struct IBParams {
  const T* Tab;  // (M, N) row-major block-start tableau (read only)
  T* U;          // (K, M) zeroed by the caller
  T* V;          // (K, N) zeroed by the caller
  T* row0;       // (N,)
  T* row1;       // (N,)
  T* bvec;       // (M,)
  int* ca;       // (N,) col-active, 0 at the RHS column
  const int* ac; // (N,) artificial columns
  int* basis;    // (m,)
  int* ab;       // (m,) artificial-basic mask
  T* gamma;      // (N,) devex weights
  int* iscal;    // (8,) phase, status, niter, stuck, bland, t, -, -
  T* fscal;      // (2,) last_z, -
  T* colj;       // (M,) the entering column
  T* rowd;       // (N,) the cleanup row
  T* pv;         // (P_NSLOT, IB_MAX_GRID) partial values
  int* pk;       // (P_NSLOT, IB_MAX_GRID) partial integer keys
  int* pi;       // (P_NSLOT, IB_MAX_GRID) partial indices
  T* gslab;      // streaming: (G, RB + CB, K) eta slices; resident: null
  unsigned* bar; // flag barrier counter, zeroed by the caller
  long long* stage_cycles;  // (IB_STAGES,) SM cycles per stage (block 0), or null
  int M, N, m, K, RB, CB, stall_limit, bland_static, devex_static;
  T opt_tol, piv_tol, infeas_tol, degen_tol;
};

// (the grid barrier, GridBarrier, lives in common.cuh: bounded_grid.cu
// shares it)

// n grid barriers and nothing else: the latency floor of a pivot's stages
__global__ void __launch_bounds__(IB_THREADS, 1) barrier_probe_kernel(unsigned* bar, int n,
                                                                     int flag) {
  GridBarrier gb{bar, 0u, flag};
  for (int i = 0; i < n; ++i) gb.sync();
}

// ---------------------------------------------------------------------------
// reductions
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = add_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  return x;
}

// the eight warps' sums combined in a fixed order
template <typename T>
__device__ __forceinline__ T cross_sum(const T* sh) {
  T x = sh[0];
#pragma unroll
  for (int w = 1; w < IB_WARPS; ++w) x = add_rn(x, sh[w]);
  return x;
}

template <typename T>
__device__ __forceinline__ void put_v(const IBParams<T>& p, int slot, VI<T> x) {
  p.pv[slot * IB_MAX_GRID + blockIdx.x] = x.v;
  p.pi[slot * IB_MAX_GRID + blockIdx.x] = x.i;
}

template <typename T>
__device__ __forceinline__ void put_k(const IBParams<T>& p, int slot, VI<int> x) {
  p.pk[slot * IB_MAX_GRID + blockIdx.x] = x.v;
  p.pi[slot * IB_MAX_GRID + blockIdx.x] = x.i;
}

template <typename T>
__device__ __forceinline__ VI<T> get_v(const IBParams<T>& p, int slot, int g, VI<T> ident) {
  if (g >= int(gridDim.x)) return ident;
  return VI<T>{__ldcg(p.pv + slot * IB_MAX_GRID + g), __ldcg(p.pi + slot * IB_MAX_GRID + g)};
}

template <typename T>
__device__ __forceinline__ VI<int> get_k(const IBParams<T>& p, int slot, int g, VI<int> ident) {
  if (g >= int(gridDim.x)) return ident;
  return VI<int>{__ldcg(p.pk + slot * IB_MAX_GRID + g), __ldcg(p.pi + slot * IB_MAX_GRID + g)};
}

template <typename T>
__device__ __forceinline__ T get_s(const IBParams<T>& p, int slot, int g) {
  return g < int(gridDim.x) ? __ldcg(p.pv + slot * IB_MAX_GRID + g) : T(0);
}

// The pricing partials of one block (or of the grid): the first basic
// artificial, the first improving column, the Dantzig or devex choice
// (under the current weights and under all-ones), the sum |crow| over the
// active columns; with the devex max and the |bvec| sum of the pivot that
// produced them.
template <typename T>
struct Pricing {
  VI<int> rd, jb;
  VI<T> dz, dz1, gmax;
  T csum, bsum;
};

template <typename T>
__device__ __forceinline__ Pricing<T> pricing_ident(bool devex) {
  const T inf = pos_inf<T>();
  Pricing<T> x;
  x.rd = VI<int>{0, BIG_I};
  x.jb = VI<int>{0, BIG_I};
  x.dz = devex ? VI<T>{-inf, BIG_I} : VI<T>{inf, BIG_I};
  x.dz1 = VI<T>{-inf, BIG_I};
  x.gmax = VI<T>{-inf, BIG_I};
  x.csum = T(0);
  x.bsum = T(0);
  return x;
}

// (the order-preserving keys and warp_arg live in common.cuh, shared with
// bounded_grid.cu)

template <typename T>
struct RedShared {
  typename KeyOf<T>::type k[3][IB_WARPS];
  unsigned i[6][IB_WARPS];
  T s[2][IB_WARPS];
  T piv[IB_WARPS];
  int leave[IB_WARPS];
};

// one (value, index) field of a block reduction: the warp's winner into
// shared memory (lane 0), then, after the caller's __syncthreads, the
// block's winner from the eight warps' (every warp alike)
template <typename T>
__device__ __forceinline__ void arg_to_shared(VI<T> x, bool mx, RedShared<T>& sh, int f) {
  typename KeyOf<T>::type k = okey(x.v, mx);
  unsigned i = (unsigned)x.i;
  warp_arg(k, i, mx);
  if ((threadIdx.x & 31) == 0) {
    sh.k[f][threadIdx.x >> 5] = k;
    sh.i[f][threadIdx.x >> 5] = i;
  }
}
template <typename T>
__device__ __forceinline__ VI<T> arg_from_shared(bool mx, const RedShared<T>& sh, int f) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31;
  K k = lane < IB_WARPS ? sh.k[f][lane] : (mx ? K(0) : ~K(0));
  unsigned i = lane < IB_WARPS ? sh.i[f][lane] : NO_IDX;
  warp_arg(k, i, mx);
  return VI<T>{key_value(k, mx), (int)i};
}
// a first-index search (index only)
__device__ __forceinline__ unsigned first_warp(int i) { return __reduce_min_sync(FULL, (unsigned)i); }
template <typename T>
__device__ __forceinline__ int first_from_shared(const RedShared<T>& sh, int f) {
  const int lane = threadIdx.x & 31;
  return (int)__reduce_min_sync(FULL, lane < IB_WARPS ? sh.i[f][lane] : NO_IDX);
}

// Block-wide combination of Pricing values, the same result in every
// thread (two __syncthreads). The weight max and the all-ones choice are
// reduced only under devex (the only rule that reads them).
template <typename T>
__device__ Pricing<T> block_pricing(Pricing<T> x, bool devex, RedShared<T>& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned rd = first_warp(x.rd.i), jb = first_warp(x.jb.i);
  const T csum = warp_sum(x.csum), bsum = warp_sum(x.bsum);
  __syncthreads();
  arg_to_shared(x.dz, devex, sh, 0);
  if (devex) {
    arg_to_shared(x.dz1, true, sh, 1);
    arg_to_shared(x.gmax, true, sh, 2);
  }
  if (lane == 0) {
    sh.i[3][w] = rd;
    sh.i[4][w] = jb;
    sh.s[0][w] = csum;
    sh.s[1][w] = bsum;
  }
  __syncthreads();
  x.rd = VI<int>{0, first_from_shared(sh, 3)};
  x.jb = VI<int>{0, first_from_shared(sh, 4)};
  x.dz = arg_from_shared(devex, sh, 0);
  if (devex) {
    x.dz1 = arg_from_shared(true, sh, 1);
    x.gmax = arg_from_shared(true, sh, 2);
  }
  x.csum = cross_sum(sh.s[0]);
  x.bsum = cross_sum(sh.s[1]);
  return x;
}

template <typename T>
__device__ __forceinline__ void put_pricing(const IBParams<T>& p, const Pricing<T>& x) {
  if (threadIdx.x != 0) return;
  put_k(p, P_RD, x.rd);
  put_k(p, P_JBL, x.jb);
  put_v(p, P_DZ, x.dz);
  put_v(p, P_DZ1, x.dz1);
  put_v(p, P_GMAX, x.gmax);
  p.pv[P_CSUM * IB_MAX_GRID + blockIdx.x] = x.csum;
  p.pv[P_BSUM * IB_MAX_GRID + blockIdx.x] = x.bsum;
}

// The grid's Pricing, from every block's published partials.
template <typename T>
__device__ Pricing<T> grid_pricing(const IBParams<T>& p, bool devex, RedShared<T>& sh) {
  const Pricing<T> id = pricing_ident<T>(devex);
  const int g = threadIdx.x;
  Pricing<T> x;
  x.rd = get_k(p, P_RD, g, id.rd);
  x.jb = get_k(p, P_JBL, g, id.jb);
  x.dz = get_v(p, P_DZ, g, id.dz);
  x.dz1 = get_v(p, P_DZ1, g, id.dz1);
  x.gmax = get_v(p, P_GMAX, g, id.gmax);
  x.csum = get_s(p, P_CSUM, g);
  x.bsum = get_s(p, P_BSUM, g);
  return block_pricing(x, devex, sh);
}

// block-wide best of one (int key, index) pair (smallest key, then
// smallest index), the same in every thread
template <typename T>
__device__ VI<int> block_key(VI<int> x, RedShared<T>& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned k = (unsigned)x.v, i = (unsigned)x.i;
  warp_arg(k, i, false);
  __syncthreads();
  if (lane == 0) {
    sh.i[0][w] = k;
    sh.i[1][w] = i;
  }
  __syncthreads();
  k = lane < IB_WARPS ? sh.i[0][lane] : NO_IDX;
  i = lane < IB_WARPS ? sh.i[1][lane] : NO_IDX;
  warp_arg(k, i, false);
  return VI<int>{(int)k, (int)i};
}

// The ratio test's candidate: (ratio, row) with the pivot element and the
// basic column of that row riding along, and the first positive row.
template <typename T>
struct Ratio {
  VI<T> r;
  T piv;
  int leave;
  VI<int> pos;
};

// better<T, false> on .r, the payload following the winner
template <typename T>
__device__ __forceinline__ Ratio<T> ratio_best(Ratio<T> a, const Ratio<T>& b) {
  const VI<int> pos = better<int, false>(a.pos, b.pos);
  bool take;
  if (is_nan(a.r.v)) take = false;
  else if (is_nan(b.r.v)) take = true;
  else take = b.r.v < a.r.v || (b.r.v == a.r.v && b.r.i < a.r.i);
  Ratio<T> x = take ? b : a;
  x.pos = pos;
  return x;
}

// block-wide Ratio: the smallest ratio (first index on ties, a NaN first)
// with its payload, and the first positive row; the same in every thread
template <typename T>
__device__ Ratio<T> block_ratio(Ratio<T> x, RedShared<T>& sh) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  K k = okey(x.r.v, false), mine = k;
  unsigned i = (unsigned)x.r.i;
  const unsigned my_i = i;
  warp_arg(k, i, false);
  int src = __ffs(__ballot_sync(FULL, mine == k && my_i == i)) - 1;
  T piv = __shfl_sync(FULL, x.piv, src);
  int leave = __shfl_sync(FULL, x.leave, src);
  const unsigned pos = first_warp(x.pos.i);
  __syncthreads();
  if (lane == 0) {
    sh.k[0][w] = k;
    sh.i[0][w] = i;
    sh.piv[w] = piv;
    sh.leave[w] = leave;
    sh.i[1][w] = pos;
  }
  __syncthreads();
  const bool in = lane < IB_WARPS;
  k = in ? sh.k[0][lane] : ~K(0);
  i = in ? sh.i[0][lane] : NO_IDX;
  mine = k;
  const unsigned in_i = i;
  warp_arg(k, i, false);
  src = __ffs(__ballot_sync(FULL, in && mine == k && in_i == i)) - 1;
  piv = __shfl_sync(FULL, in ? sh.piv[lane] : T(0), src);
  leave = __shfl_sync(FULL, in ? sh.leave[lane] : -1, src);
  Ratio<T> out;
  out.r = VI<T>{key_value(k, false), (int)i};
  out.piv = piv;
  out.leave = leave;
  out.pos = VI<int>{0, first_from_shared(sh, 1)};
  return out;
}

// ---------------------------------------------------------------------------
// eta corrections
// ---------------------------------------------------------------------------

__device__ __forceinline__ double xor_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __dadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// a + s with a single rounding to T: an element of T0 plus its eta
// correction
__device__ __forceinline__ float plus_eta(float a, double s) {
  return __double2float_rn(__dadd_rn((double)a, s));
}
__device__ __forceinline__ double plus_eta(double a, double s) { return __dadd_rn(a, s); }

// sum_{k<t} coef[k] * x[k * stride] in the canonical order, for one warp;
// every lane returns the same value
template <typename T>
__device__ __forceinline__ double warp_dot(const T* coef, const T* x, size_t stride, int t) {
  double acc = 0.0;
  for (int k = threadIdx.x & 31; k < t; k += 32)
    acc = fma((double)coef[k], (double)x[(size_t)k * stride], acc);
  return xor_sum(acc);
}

// dst_a[x] = src_a(x) for x < na and dst_b[x] = src_b(x) for x < nb, with
// every thread's loads of both in flight before any store (the caller
// synchronises the block afterwards)
constexpr int IB_STAGE = 4;
template <typename T, typename FA, typename FB>
__device__ __forceinline__ void stage_two(T* dst_a, int na, FA src_a, T* dst_b, int nb, FB src_b) {
  T ra[IB_STAGE], rb[IB_STAGE];
#pragma unroll
  for (int q = 0; q < IB_STAGE; ++q) {
    const int x = threadIdx.x + q * IB_THREADS;
    ra[q] = x < na ? src_a(x) : T(0);
    rb[q] = x < nb ? src_b(x) : T(0);
  }
#pragma unroll
  for (int q = 0; q < IB_STAGE; ++q) {
    const int x = threadIdx.x + q * IB_THREADS;
    if (x < na) dst_a[x] = ra[q];
    if (x < nb) dst_b[x] = rb[q];
  }
  for (int x = threadIdx.x + IB_STAGE * IB_THREADS; x < na; x += IB_THREADS) dst_a[x] = src_a(x);
  for (int x = threadIdx.x + IB_STAGE * IB_THREADS; x < nb; x += IB_THREADS) dst_b[x] = src_b(x);
}

// The xor butterfly of eight per-lane sums at once, as a reduce-scatter:
// at distance 16, 8 and 4 each lane keeps half of its outputs and adds its
// partner's other half, then distances 2 and 1 finish one value. Every
// output is summed over the same tree as xor_sum's (pairs by lane bit 4,
// then 3, 2, 1, 0; a + b = b + a), so bit for bit the same, with 9
// shuffles instead of 40. Output lane >> 2 ends in lane, in every lane.
__device__ __forceinline__ double xor_sum8(double (&v)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hi = lane & 16;
    const double keep = hi ? v[i + 4] : v[i], send = hi ? v[i] : v[i + 4];
    v[i] = __dadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 16));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool hi = lane & 8;
    const double keep = hi ? v[i + 2] : v[i], send = hi ? v[i] : v[i + 2];
    v[i] = __dadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 8));
  }
  {
    const bool hi = lane & 4;
    const double keep = hi ? v[1] : v[0], send = hi ? v[0] : v[1];
    v[0] = __dadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 4));
  }
  double x = v[0];
  x = __dadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return __dadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

// For every output o < n of a slab (output o's K values at X + o * K):
// v = io[o] + sum_{k<t} coef[k] X[o * K + k], in the canonical order, with
// the warps of the block taking IB_OUTS outputs at a time; io[o] holds the
// element of T0 (staged with the coefficients), and lane 4u calls
// put(o0 + u, v), which may overwrite io[o0 + u].
static_assert(IB_OUTS == 8, "slab_dots reduces eight outputs at a time");
template <typename T, typename FP>
__device__ __forceinline__ void slab_dots(const T* coef, const T* X, int n, int K, int t,
                                          const T* io, FP put) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o0 = w * IB_OUTS; o0 < n; o0 += IB_WARPS * IB_OUTS) {
    const int mine = o0 + (lane >> 2);
    const bool reports = (lane & 3) == 0 && mine < n;
    const T a = reports ? io[mine] : T(0);
    const T* x[IB_OUTS];
    double acc[IB_OUTS];
#pragma unroll
    for (int u = 0; u < IB_OUTS; ++u) {
      x[u] = X + (size_t)min(o0 + u, n - 1) * K;
      acc[u] = 0.0;
    }
    for (int k = lane; k < t; k += 32) {
      const double c = (double)coef[k];
#pragma unroll
      for (int u = 0; u < IB_OUTS; ++u) acc[u] = fma(c, (double)x[u][k], acc[u]);
    }
    const double s = xor_sum8(acc);
    if (reports) put(mine, plus_eta(a, s));
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// one column's contribution to the pricing of a pivot
template <typename T>
__device__ __forceinline__ void price_col(Pricing<T>& pr, const IBParams<T>& p, int j, T crow,
                                          bool active, T gam) {
  const T inf = pos_inf<T>();
  const T ceff = active ? crow : inf;
  const bool imp = ceff < -p.opt_tol;
  if (imp && j < pr.jb.i) pr.jb.i = j;
  if (p.devex_static) {
    const T sq = mul_rn(crow, crow);
    const T score = imp ? div_rn(sq, gam) : -inf;
    pr.dz = better<T, true>(pr.dz, VI<T>{score, is_nan(score) ? BIG_I : j});
    const T score1 = imp ? sq : -inf;  // sq / 1
    pr.dz1 = better<T, true>(pr.dz1, VI<T>{score1, is_nan(score1) ? BIG_I : j});
  } else {
    pr.dz = better<T, false>(pr.dz, VI<T>{ceff, is_nan(ceff) ? BIG_I : j});
  }
  if (active) pr.csum = add_rn(pr.csum, fabs(crow));
}

template <typename T>
__global__ void __launch_bounds__(IB_THREADS, 1) inner_block_kernel(IBParams<T> p) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ RedShared<T> sh;
  __shared__ T v_last_sh;

  const int M = p.M, N = p.N, m = p.m, K = p.K, RB = p.RB, CB = p.CB;
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const bool devex = p.devex_static != 0;
  const int r_lo = g * RB, nr = max(0, min(M, r_lo + RB) - r_lo);
  const int c_lo = g * CB, nc = max(0, min(N, c_lo + CB) - c_lo);
  const T inf = pos_inf<T>();
  const VI<T> MIN_ID{inf, BIG_I};
  const VI<int> IDX_ID{0, BIG_I};  // first-index searches: key 0
  const VI<int> KEY_ID{BIG_I, BIG_I};
  GridBarrier gb{p.bar, 0u, 1};  // the flag barrier: the faster in the probe
  const bool timing = p.stage_cycles != nullptr;  // the same in every thread
  const bool timed = timing && g == 0 && tid == 0;
  long long cyc[IB_STAGES] = {};
  long long last = 0;
  auto mark = [&](int stage) {
    if (timed) {
      const long long now = clock64();
      cyc[stage] += now - last;
      last = now;
    }
  };

  // ---- shared memory: eta slices (resident), then the owner's vectors ---
  T* tp = reinterpret_cast<T*>(dsm);
  T* Us;
  if (p.gslab == nullptr) {
    Us = tp;
    tp += (size_t)(RB + CB) * K;
  } else {
    Us = p.gslab + (size_t)g * (RB + CB) * K;
  }
  T* Vs = Us + (size_t)RB * K;
  T* coef = tp;
  tp += K;
  T* vlast_s = tp;  // V[0:K, N - 1], which every block keeps
  tp += K;
  T* row0_s = tp;
  tp += CB;
  T* row1_s = tp;
  tp += CB;
  T* gam_s = tp;
  tp += CB;
  T* rowd_s = tp;
  tp += CB;
  T* vrow_s = tp;
  tp += CB;
  T* bvec_s = tp;
  tp += RB;
  T* colj_s = tp;
  tp += RB;
  int* ca_s = reinterpret_cast<int*>(tp);
  int* ac_s = ca_s + CB;
  int* ab_s = ac_s + CB;
  int* basis_s = ab_s + RB;

  for (size_t x = tid; x < (size_t)(RB + CB) * K; x += IB_THREADS) Us[x] = T(0);
  for (int k = tid; k < K; k += IB_THREADS) vlast_s[k] = T(0);
  for (int jl = tid; jl < nc; jl += IB_THREADS) {
    const int j = c_lo + jl;
    row0_s[jl] = p.row0[j];
    row1_s[jl] = p.row1[j];
    gam_s[jl] = p.gamma[j];
    ca_s[jl] = p.ca[j];
    ac_s[jl] = p.ac[j];
  }
  for (int il = tid; il < nr; il += IB_THREADS) {
    const int i = r_lo + il;
    bvec_s[il] = p.bvec[i];
    ab_s[il] = i >= 2 ? p.ab[i - 2] : 0;
    basis_s[il] = i >= 2 ? p.basis[i - 2] : -1;
  }

  int phase = p.iscal[0], status = p.iscal[1], niter = p.iscal[2];
  int stuck = p.iscal[3], bland = p.iscal[4], t = p.iscal[5];
  T last_z = p.fscal[0];

  // ---- the first pivot's pricing ----------------------------------------
  {
    __syncthreads();
    Pricing<T> pr = pricing_ident<T>(devex);
    for (int jl = tid; jl < nc; jl += IB_THREADS)
      price_col(pr, p, c_lo + jl, phase == 1 ? row1_s[jl] : row0_s[jl], ca_s[jl] > 0, gam_s[jl]);
    for (int il = tid; il < nr; il += IB_THREADS) {
      const int i = r_lo + il;
      if (i >= 2 && ab_s[il] > 0 && i - 2 < pr.rd.i) pr.rd.i = i - 2;
    }
    put_pricing(p, block_pricing(pr, devex, sh));
  }
  gb.sync();
  Pricing<T> cur = grid_pricing(p, devex, sh);
  bool reset_prev = false;
  T z1 = -__ldcg(p.row1 + N - 1);  // then carried from the bookkeeping

  if (timed) last = clock64();
  for (int it = 0; it < K && t < K && status == S_RUNNING; ++it) {
    const bool in_phase2 = phase == 2;
    const bool use_bland = bland != 0 || p.bland_static != 0;

    // ---- (A) this pivot's pricing, reduced at the end of the last one ---
    const int rd_raw = cur.rd.i;
    const int jbl_raw = cur.jb.i;
    const VI<T> dzg = cur.dz;
    const T crow_sum = cur.csum;
    const bool any_art = rd_raw < BIG_I;
    const int r_d = min(rd_raw, m - 1);
    const bool cleanup = any_art && in_phase2;
    const bool has_improving = jbl_raw < BIG_I;
    const int j_bl = min(jbl_raw, N - 2);
    // the Dantzig index is not clamped in the reference either
    const int j_dz = devex ? min(dzg.i, N - 2) : dzg.i;
    const int j_price = use_bland ? j_bl : j_dz;
    const bool phase1_done = phase == 1 && !has_improving;
    const bool became_infeasible = phase1_done && z1 > p.infeas_tol;
    const bool to_phase2 = phase1_done && !became_infeasible;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;

    // ---- (B) cleanup row T0[rg_d] + U[:, rg_d]^T V, eligible column -----
    bool has_elig = false;
    int j_d = N - 2;
    if (cleanup) {
      const int rg_d = r_d + 2;
      __syncthreads();
      stage_two(
          rowd_s, nc, [&](int jl) { return __ldg(p.Tab + (size_t)rg_d * N + c_lo + jl); }, coef, t,
          [&](int k) { return __ldcg(p.U + (size_t)k * M + rg_d); });
      __syncthreads();
      slab_dots<T>(coef, Vs, nc, K, t, rowd_s, [&](int jl, T v) {
        rowd_s[jl] = v;
        p.rowd[c_lo + jl] = v;
      });
      __syncthreads();
      VI<int> jd = IDX_ID;
      for (int jl = tid; jl < nc; jl += IB_THREADS) {
        const bool elig = ca_s[jl] > 0 && !(ac_s[jl] > 0) && fabs(rowd_s[jl]) > p.piv_tol;
        if (elig && c_lo + jl < jd.i) jd.i = c_lo + jl;
      }
      jd = block_key(jd, sh);
      if (tid == 0) put_k(p, P_JD, jd);
      gb.sync();
      const VI<int> jdg = block_key(get_k(p, P_JD, tid, IDX_ID), sh);
      has_elig = jdg.i < BIG_I;
      j_d = min(jdg.i, N - 2);
    }
    const bool retire = cleanup && !has_elig;

    const int j = cleanup ? j_d : j_price;
    // j reaches past the last column only when NaN poisoned pricing (the
    // step then reports NUMERIC); reads use a clamped copy
    const int jc = min(max(j, 0), N - 1);
    const bool j_in = j >= 0 && j < N;
    // the owner of j writes gamma[j] after the next barrier: read it now,
    // or take the reset weight the last pivot decided
    const T gamma_q = (devex && j_in) ? (reset_prev ? T(1) : __ldcg(p.gamma + j)) : T(0);
    const bool j_is_art = j_in && __ldg(p.ac + j) > 0;

    // ---- (C) entering column T0[:, j] + V[:, j]^T U, ratio test --------
    __syncthreads();
    mark(ST_PICK);
    stage_two(
        colj_s, nr, [&](int il) { return __ldg(p.Tab + (size_t)(r_lo + il) * N + jc); }, coef, t,
        [&](int k) { return __ldcg(p.V + (size_t)k * N + jc); });
    __syncthreads();
    mark(ST_COL_LOAD);
    slab_dots<T>(coef, Us, nr, K, t, colj_s, [&](int il, T v) {
      colj_s[il] = v;
      p.colj[r_lo + il] = v;
    });
    __syncthreads();
    mark(ST_COL_DOT);
    const Ratio<T> RATIO_ID{MIN_ID, T(0), -1, IDX_ID};
    {
      Ratio<T> x = RATIO_ID;
      for (int il = tid; il < nr; il += IB_THREADS) {
        const int i = r_lo + il;
        if (i < 2) continue;
        const T v = colj_s[il];
        const bool pos = v > p.piv_tol;
        if (pos && i - 2 < x.pos.i) x.pos.i = i - 2;
        const T ratio = pos ? div_rn(bvec_s[il], v) : inf;
        x = ratio_best(x, Ratio<T>{VI<T>{ratio, is_nan(ratio) ? BIG_I : i - 2}, v, basis_s[il],
                                   x.pos});
      }
      x = block_ratio(x, sh);
      if (tid == 0) {
        put_v(p, P_RATIO, x.r);
        p.pv[P_PIV * IB_MAX_GRID + g] = x.piv;
        p.pk[P_LEAVE * IB_MAX_GRID + g] = x.leave;
        put_k(p, P_POS, x.pos);
      }
    }
    mark(ST_COL_RED);
    gb.sync();
    mark(ST_BAR1);
    // rows 0 and 1 of the entering column (block 0's), with the gather
    const T colj0 = __ldcg(p.colj), colj1 = __ldcg(p.colj + 1);
    Ratio<T> rg_all = RATIO_ID;
    if (tid < int(gridDim.x))
      rg_all = Ratio<T>{get_v(p, P_RATIO, tid, MIN_ID), __ldcg(p.pv + P_PIV * IB_MAX_GRID + tid),
                        __ldcg(p.pk + P_LEAVE * IB_MAX_GRID + tid), get_k(p, P_POS, tid, IDX_ID)};
    rg_all = block_ratio(rg_all, sh);
    const VI<T> ratg = rg_all.r;
    const bool has_ratio = rg_all.pos.i < BIG_I;

    // ---- (D) Bland: smallest basic index among the min-ratio ties -------
    int r_price;
    if (use_bland) {
      VI<int> kb = KEY_ID;
      for (int il = tid; il < nr; il += IB_THREADS) {
        const int i = r_lo + il;
        if (i < 2) continue;
        const T v = colj_s[il];
        const bool pos = v > p.piv_tol;
        const T ratio = pos ? div_rn(bvec_s[il], v) : inf;
        const bool tie = ratio <= ratg.v;
        kb = better<int, false>(kb, VI<int>{tie ? basis_s[il] : BIG_I, i - 2});
      }
      kb = block_key(kb, sh);
      if (tid == 0) put_k(p, P_RBL, kb);
      gb.sync();
      r_price = min(block_key(get_k(p, P_RBL, tid, KEY_ID), sh).i, m - 1);
    } else {
      r_price = min(ratg.i, m - 1);
    }

    const bool became_unbounded = pricing_pivot && !has_ratio && in_phase2;
    const bool became_failed1 = pricing_pivot && !has_ratio && !in_phase2;
    const bool do_cleanup = cleanup && has_elig;
    const bool do_pricing = pricing_pivot && has_ratio;
    const bool act = do_cleanup || do_pricing;
    const T actf = act ? T(1) : T(0);
    const int r = do_cleanup ? r_d : r_price;
    const int rg = r + 2;
    // the ratio test's winner brought its pivot element and basic column;
    // a cleanup or Bland row is read back
    const bool carried = !do_cleanup && !use_bland && ratg.i < BIG_I;
    const T piv = carried ? rg_all.piv : __ldcg(p.colj + rg);
    const T safe_piv = act ? piv : T(1);
    const int leaving = carried ? rg_all.leave : __ldcg(p.basis + r);
    const T w0 = mul_rn(div_rn(sub_rn(T(rg == 0), colj0), safe_piv), actf);
    const T w1 = mul_rn(div_rn(sub_rn(T(rg == 1), colj1), safe_piv), actf);
    const T leave_val = fmax(div_rn(gamma_q, mul_rn(safe_piv, safe_piv)), T(1));
    const int phase_next = to_phase2 ? 2 : phase;

    // ---- (E) pivot row, eta append, running vectors, next pricing -------
    __syncthreads();
    mark(ST_RATIO);
    if (!do_cleanup) {
      const T t0_last = tid == 0 ? __ldg(p.Tab + (size_t)rg * N + N - 1) : T(0);
      stage_two(
          vrow_s, nc, [&](int jl) { return __ldg(p.Tab + (size_t)rg * N + c_lo + jl); }, coef, t,
          [&](int k) { return __ldcg(p.U + (size_t)k * M + rg); });
      if (tid == 0) v_last_sh = t0_last;
      __syncthreads();
      mark(ST_ROW_LOAD);
      // v_last = vrow[N - 1]: the owner's dot, over every block's copy of
      // V[:, N - 1], on the last warp (the one slab_dots gives the fewest
      // outputs)
      if (tid >= IB_THREADS - 32) {
        const double s = warp_dot(coef, vlast_s, (size_t)1, t);
        const T a = v_last_sh;
        __syncwarp();
        if (lane == 0) v_last_sh = mul_rn(plus_eta(a, s), actf);
      }
      slab_dots<T>(coef, Vs, nc, K, t, vrow_s,
                   [&](int jl, T v) { vrow_s[jl] = mul_rn(v, actf); });
    } else {
      if (tid == 0) v_last_sh = mul_rn(__ldcg(p.rowd + N - 1), actf);
      for (int jl = tid; jl < nc; jl += IB_THREADS) vrow_s[jl] = mul_rn(rowd_s[jl], actf);
    }
    __syncthreads();
    mark(ST_ROW_DOT);
    const T v_last = v_last_sh;
    if (tid == 0) vlast_s[t] = v_last;
    Pricing<T> pr = pricing_ident<T>(devex);
    for (int jl = tid; jl < nc; jl += IB_THREADS) {
      const int jj = c_lo + jl;
      const T vr = vrow_s[jl];
      p.V[(size_t)t * N + jj] = vr;
      Vs[(size_t)jl * K + t] = vr;
      const T r0 = fma(w0, vr, row0_s[jl]);
      const T r1 = fma(w1, vr, row1_s[jl]);
      row0_s[jl] = r0;
      row1_s[jl] = r1;
      if (jj == N - 1) {  // every block reads z from these
        p.row0[jj] = r0;
        p.row1[jj] = r1;
      }
      T gn = gam_s[jl];
      if (devex) {
        if (do_pricing) {
          const T alpha = div_rn(vr, safe_piv);
          const T cand = jj < N - 1 ? mul_rn(mul_rn(alpha, alpha), gamma_q) : T(0);
          gn = fmax(gn, cand);
          if (jj == leaving) gn = leave_val;
        }
        gam_s[jl] = gn;
        p.gamma[jj] = gn;  // gamma_q for every block
        pr.gmax = better<T, true>(pr.gmax, VI<T>{gn, 0});
      }
      int a = ca_s[jl];
      if (to_phase2 && ac_s[jl] > 0) {
        a = 0;
        ca_s[jl] = 0;
      }
      price_col(pr, p, jj, phase_next == 1 ? r1 : r0, a > 0, gn);
    }
    for (int il = tid; il < nr; il += IB_THREADS) {
      const int i = r_lo + il;
      const T wi = mul_rn(div_rn(sub_rn(T(i == rg), colj_s[il]), safe_piv), actf);
      p.U[(size_t)t * M + i] = wi;
      Us[(size_t)il * K + t] = wi;
      const T bn = fma(wi, v_last, bvec_s[il]);
      bvec_s[il] = bn;
      pr.bsum = add_rn(pr.bsum, fabs(bn));
      if (i < 2) continue;
      int a = ab_s[il];
      if (act && i == rg) {
        a = j_is_art ? 1 : 0;
        basis_s[il] = j;
      }
      if (retire && i == r_d + 2) a = 0;
      ab_s[il] = a;
      if (a > 0 && i - 2 < pr.rd.i) pr.rd.i = i - 2;
    }
    if (timing) __syncthreads();
    mark(ST_UPDATE);
    put_pricing(p, block_pricing(pr, devex, sh));
    mark(ST_UPD_RED);
    gb.sync();
    mark(ST_BAR2);

    // ---- scalar bookkeeping (the same in every block) --------------------
    const T zr0 = __ldcg(p.row0 + N - 1), zr1 = __ldcg(p.row1 + N - 1);
    const Pricing<T> nxt = grid_pricing(p, devex, sh);
    mark(ST_GATHER);
    const T z = phase == 1 ? -zr1 : -zr0;
    z1 = -zr1;
    const bool improved = sub_rn(last_z, z) > p.degen_tol;
    if (do_pricing && act) {
      stuck = improved ? 0 : stuck + 1;
      last_z = z;
    }
    bland = (bland != 0 || stuck >= p.stall_limit) ? 1 : 0;
    const bool reset = devex && (nxt.gmax.v > T(1e8) || to_phase2);
    if (to_phase2) {
      phase = 2;
      stuck = 0;
      last_z = inf;
    }
    const bool finished_opt = in_phase2 && !has_improving && !cleanup;
    const bool finite_ok = isfinite(z) && isfinite(nxt.bsum) && isfinite(crow_sum);
    status = !finite_ok ? S_NUMERIC
             : (became_infeasible || became_failed1) ? S_INFEASIBLE
             : became_unbounded ? S_UNBOUNDED
             : finished_opt ? S_OPTIMAL
             : S_RUNNING;
    // every block has read basis[r] (leaving) before the last barrier
    if (act && tid == 0 && rg >= r_lo && rg < r_lo + nr) p.basis[r] = j;
    if (reset)
      for (int jl = tid; jl < nc; jl += IB_THREADS) {
        gam_s[jl] = T(1);
        p.gamma[c_lo + jl] = T(1);
      }
    cur = nxt;
    if (reset) cur.dz = nxt.dz1;
    reset_prev = reset;
    niter += act ? 1 : 0;
    t += act ? 1 : 0;
    if (timing) __syncthreads();
    mark(ST_BOOK);
  }
  if (timed)
    for (int k = 0; k < IB_STAGES; ++k) p.stage_cycles[k] += cyc[k];

  // the owner's vectors back to global memory (gamma, basis, colj and
  // row0/row1 at N - 1 were written as they changed: other blocks read
  // them)
  for (int jl = tid; jl < nc; jl += IB_THREADS) {
    p.row0[c_lo + jl] = row0_s[jl];
    p.row1[c_lo + jl] = row1_s[jl];
    p.ca[c_lo + jl] = ca_s[jl];
  }
  for (int il = tid; il < nr; il += IB_THREADS) {
    const int i = r_lo + il;
    p.bvec[i] = bvec_s[il];
    if (i >= 2) p.ab[i - 2] = ab_s[il];
  }

  if (g == 0 && tid == 0) {
    p.iscal[0] = phase;
    p.iscal[1] = status;
    p.iscal[2] = niter;
    p.iscal[3] = stuck;
    p.iscal[4] = bland;
    p.iscal[5] = t;
    p.fscal[0] = last_z;
  }
}

// dynamic shared memory of a launch, as the kernel carves it; the caller's
// plan (inner_block_plan in kernels/block.py, which chooses the variant by
// it) passes its own figure, and a launch whose figure differs is refused
inline size_t inner_block_smem(int RB, int CB, int K, int resident, size_t tsize) {
  const size_t slab = resident ? (size_t)(RB + CB) * K : 0;
  return tsize * (slab + 2 * (size_t)K + 5 * (size_t)CB + 2 * (size_t)RB) +
         4 * (2 * (size_t)CB + 2 * (size_t)RB);
}

template <typename T>
int launch_inner_block(const void* Tab, void* U, void* V, void* row0, void* row1, void* bvec,
                       void* ca, const void* ac, void* basis, void* ab, void* gamma, void* iscal,
                       void* fscal, void* colj, void* rowd, void* pv, void* pint, void* gslab,
                       void* bar, void* stage_cycles, int M, int N, int m, int K, int grid,
                       int RB, int CB, int resident, int smem_plan, int stall_limit,
                       int bland_static, int devex_static, double opt_tol, double piv_tol,
                       double infeas_tol, double degen_tol, void* stream) {
  if (K < 1 || K > IB_MAX_K || m < 1 || N < 2 || grid < 1 || grid > IB_MAX_GRID)
    return (int)cudaErrorInvalidValue;
  if ((long long)RB * grid < M || (long long)CB * grid < N || RB % 8 || CB % 8)
    return (int)cudaErrorInvalidValue;
  if (!resident && gslab == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = inner_block_smem(RB, CB, K, resident, sizeof(T));
  if (smem != (size_t)smem_plan) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(inner_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, inner_block_kernel<T>, IB_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1 || grid > occ * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  IBParams<T> p;
  p.Tab = (const T*)Tab;
  p.U = (T*)U;
  p.V = (T*)V;
  p.row0 = (T*)row0;
  p.row1 = (T*)row1;
  p.bvec = (T*)bvec;
  p.ca = (int*)ca;
  p.ac = (const int*)ac;
  p.basis = (int*)basis;
  p.ab = (int*)ab;
  p.gamma = (T*)gamma;
  p.iscal = (int*)iscal;
  p.fscal = (T*)fscal;
  p.colj = (T*)colj;
  p.rowd = (T*)rowd;
  p.pv = (T*)pv;
  p.pk = (int*)pint;
  p.pi = (int*)pint + P_NSLOT * IB_MAX_GRID;
  p.gslab = resident ? nullptr : (T*)gslab;
  p.bar = (unsigned*)bar;
  p.stage_cycles = (long long*)stage_cycles;
  p.M = M;
  p.N = N;
  p.m = m;
  p.K = K;
  p.RB = RB;
  p.CB = CB;
  p.stall_limit = stall_limit;
  p.bland_static = bland_static;
  p.devex_static = devex_static;
  p.opt_tol = (T)opt_tol;
  p.piv_tol = (T)piv_tol;
  p.infeas_tol = (T)infeas_tol;
  p.degen_tol = (T)degen_tol;
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)inner_block_kernel<T>, dim3(grid),
                                  dim3(IB_THREADS), args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace tpulp

#define TPULP_INNER_BLOCK_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* Tab, void* U, void* V, void* row0, void* row1, void* bvec,   \
                      void* ca, const void* ac, void* basis, void* ab, void* gamma,            \
                      void* iscal, void* fscal, void* colj, void* rowd, void* pv, void* pint,  \
                      void* gslab, void* bar, void* stage_cycles, int M, int N, int m, int K, \
                      int grid, int RB, int CB, int resident, int smem_plan, int stall_limit,  \
                      int bland_static, int devex_static, double opt_tol, double piv_tol,      \
                      double infeas_tol, double degen_tol, void* stream) {                     \
    return tpulp::launch_inner_block<T>(Tab, U, V, row0, row1, bvec, ca, ac, basis, ab, gamma, \
                                        iscal, fscal, colj, rowd, pv, pint, gslab, bar,       \
                                        stage_cycles, M, N,                                    \
                                        m, K, grid, RB, CB, resident, smem_plan, stall_limit,  \
                                        bland_static, devex_static, opt_tol,                   \
                                        piv_tol, infeas_tol, degen_tol, stream);               \
  }

TPULP_INNER_BLOCK_ENTRY(tpulp_inner_block_f32, float)
TPULP_INNER_BLOCK_ENTRY(tpulp_inner_block_f64, double)

extern "C" int tpulp_inner_block_slots() { return tpulp::P_NSLOT * tpulp::IB_MAX_GRID; }

extern "C" int tpulp_inner_block_stages() { return tpulp::IB_STAGES; }

// n grid barriers of one kind (0: cooperative_groups grid.sync(), 1: the
// flag barrier) in a cooperative launch of ``grid`` blocks; ``bar`` zeroed
extern "C" int tpulp_barrier_probe(void* bar, int n, int flag, int grid, void* stream) {
  unsigned* b = (unsigned*)bar;
  void* args[] = {&b, &n, &flag};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)tpulp::barrier_probe_kernel, dim3(grid),
                                              dim3(tpulp::IB_THREADS), args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* tpulp_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// The library carries its own CUDA runtime: select the device the
// caller's tensors live on before a launch.
extern "C" int tpulp_set_device(int device) { return (int)cudaSetDevice(device); }
