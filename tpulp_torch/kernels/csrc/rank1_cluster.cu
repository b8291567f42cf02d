// rank1_cluster: the solo rank-1, devex and dual walks (solve/driver.py::
// simplex_step, solve/devex.py::devex_simplex_step, solve/dual.py::
// dual_simplex_step) of a frame that fits one thread-block cluster, stepped
// to the walk's exit or to max_iters in one launch, with the frame resident
// in the cluster's distributed shared memory; and with a lane axis
// (rank1_cluster_lanes: a grid of (C, B) blocks, cluster y = lane) the
// primal walks of a batch whose frames one block cannot hold, each lane
// to its own exit in one launch. A lane reads its inputs through lane
// strides (0: a row every lane shares, as the waves' broadcast masks), so
// nothing is expanded; a lane not RUNNING below its budget at the launch
// copies its input out and returns before any cluster barrier. The solo
// walk is the batch of one lane with every stride 0.
//
// Replaces no Pallas kernel: in tpulp these walks are XLA's compiled
// ``lax.while_loop`` over ``simplex_step`` (tpulp/solve/driver.py:74, the
// driver 286), over ``devex_simplex_step`` (tpulp/solve/devex.py:75, the
// driver 255) and over ``dual_simplex_step`` (tpulp/solve/dual.py:62, the
// driver 162). It is the redesign, for the frames that a cluster of at
// most 8 blocks holds, of the walks' first kernel, a stream-ordered step
// of four or five launches and one host enqueue a step (since retired:
// rank1_grid.cu takes every larger frame).
//
// What bounds it on the H100: a step reads and writes the frame once (2 x
// 258 x 769 x 8 B at the largest f64 frame of solve_lp's rank-1 range:
// 0.95 us at 3.35 TB/s from device memory; here the frame never leaves
// shared memory, whose rate is ~128 B a clock an SM), and its decisions
// are a chain of block reductions and two cluster barriers a step, whose
// latency, not the bytes, sets the pace at these sizes.
//
// Design: one cluster of C blocks (C = 1, 2, 4 or 8, the smallest that
// holds the frame; kernels/rank1_cluster.py::cluster_plan). Block b owns the
// column slab [b W, min(N, (b + 1) W)), W = ceil(N / C), of all M rows,
// column-major in its dynamic shared memory (a column is contiguous: its
// owner's peers read it in order, and the update keeps a row's entry of
// the pivot's column in a register), with its share of the active mask
// and of the devex weights. Every block holds the basis, the artificial
// mask and the RHS column alike, and every thread the walk's scalars: each
// computes them from the same reduction results, so every exit decision is
// the same in every block and no block leaves the step loop alone. A step:
// 1. price over the block's own columns (Dantzig's argmin of c_eff,
//    Bland's first improving column, devex's c^2 / gamma with its
//    half-period Dantzig probe and its exposed-ray scan, the greatest
//    increase's column pass, the clean-up's first eligible column; the
//    dual walk picks its leaving row from the replicated RHS and offers its
//    columns of that row to the dual ratio test), published in the block's
//    mailbox; cluster barrier A1 (arrive.release / wait.acquire);
// 2. every block combines the C candidates in rank order (column order:
//    the sequential argmin exactly, first-index ties and NaN first), reads
//    the entering column from its owner through distributed shared memory
//    (map_shared_rank), runs the ratio test on its copy, and computes its
//    segment of the pivot row times 1 / piv and, under devex, its weights;
//    cluster barrier A2 arrives;
// 3. the update in place of the block's slab except the pivot's column,
//    and of the replicated RHS; the basis, the retire, the phase change,
//    the stall counter, the Bland switch, the finiteness sums and the
//    status; A2 waits (every peer has read the pivot's column); the owner
//    writes the pivot's column, and the devex weights reset on the
//    cluster's maximum.
// A step that pivots nowhere but needs the plain step's redirected pivot
// on (row 2, basis[0]) (that pivot not an exact no-op) waits on A2 before
// its update. The slabs are loaded once and written back once, with the
// basis, the masks, the weights and the scalars; the launch ends with a
// cluster barrier, so no block leaves while a peer may read its shared
// memory. The arithmetic is the plain stages' (kernels/rank1.py): one rounding per
// product in the decisions, prow = row * (1 / piv), fma(-col[i], prow[k],
// T[i, k]), comparisons in the tableau's type against tolerances rounded
// to it, torch's NaN-first argmin / argmax with first-index ties, and
// status_select's precedence. The sums feed finiteness checks only: the
// |b| sum is taken by one block over the replicated RHS, the |c| sum per
// block (per thread, the warp tree, across warps) and then across blocks in
// rank order. A block has 512 threads: at 1,024 (64 registers a thread)
// the f64 walks spilled registers.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tpulp {
namespace rkc {

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
// pricing rules and tie breaks (tpulp_torch.core.state)
constexpr int RULE_BLAND_ = 1, RULE_MAX_INCREASE_ = 2, TIE_MAXPIV_ = 1;
constexpr int THREADS = 512;   // a block
constexpr int MAX_BLOCKS = 8;  // the portable cluster size
constexpr int SCAN_LANES = 8;  // lanes a column of the greatest increase's pass

// the walks (kernels/rank1.py's WALKS)
enum Walk { W_PRIMAL, W_DEVEX, W_DUAL };
// the wrapper's argument arrays (tpulp_torch/kernels/rank1_cluster.py)
enum Arg {
  A_T_IN, A_T_OUT, A_BASIS_IN, A_BASIS_OUT, A_ACT_IN, A_ACT_OUT, A_ART_IN, A_ART_OUT,
  A_GAMMA_IN, A_GAMMA_OUT, A_PHASE_IN, A_STATUS_IN, A_NITER_IN, A_STUCK_IN, A_BLAND_IN,
  A_LASTZ_IN, A_INTS_OUT, A_BLAND_OUT, A_LASTZ_OUT, A_CYCLES,
  // the lanes' (rank1_cluster_lanes): the inputs' lane strides in elements
  // (0: a row every lane shares) and the outputs' int32 fields' stride
  A_ST_T, A_ST_BASIS, A_ST_ACT, A_ST_ART, A_ST_GAMMA, A_ST_PHASE, A_ST_STATUS, A_ST_NITER,
  A_ST_STUCK, A_ST_BLAND, A_ST_LASTZ, A_OUT_FIELD, A_NARGS
};
enum Int {
  I_M, I_N, I_STALL, I_MAXIT, I_RULE, I_TIE, I_WALK, I_BLOCKS, I_THREADS, I_SMEM, I_RAY_EVERY,
  I_LANES, I_NINTS
};
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_FEAS, D_RESET, D_NTOLS };
// the int32 scalars written back (ints_out: field f of lane b at f x
// out_field + b)
enum Out { O_PHASE, O_STATUS, O_NITER, O_STUCK };
// the stages that ``cycles`` splits a walk into (block 0's clock; summed
// over the steps): the load, then a step's price, barrier A1, the combine
// and the ratio test, the pivot row (and devex's weights), the update,
// the finish, barrier A2's wait and what follows it; then the store
enum Stage { C_LOAD, C_PRICE, C_A1, C_RATIO, C_ROW, C_UPDATE, C_FINISH, C_A2, C_STORE, C_NSTAGES };

template <typename T>
struct Params {
  const T* T_in;
  T* T_out;
  const int* basis_in;
  int* basis_out;
  const unsigned char* act_in;
  unsigned char* act_out;
  const unsigned char* art_in;
  unsigned char* art_out;
  const T* gamma_in;  // devex only
  T* gamma_out;
  const int *phase_in, *status_in, *niter_in, *stuck_in;
  const unsigned char* bland_in;
  const T* lastz_in;
  int* ints_out;
  unsigned char* bland_out;
  T* lastz_out;
  long long* cycles;  // (C_NSTAGES,) SM cycles per stage (block 0), or null
  // the inputs' lane strides (a solo walk: one lane, every stride 0), the
  // outputs' int32 fields' stride
  long long st_T, st_basis, st_act, st_art, st_gamma, st_phase, st_status, st_niter, st_stuck,
      st_bland, st_lastz, out_field;
  int M, N, W, stall_limit, max_iters, ray_every;
  // Bland's rule, the greatest increase, largest-pivot ties (the primal
  // walk's; devex and the dual walk take none, as their steps)
  bool bland_rule, max_inc, max_piv;
  // the tolerances rounded to T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, feas_tol, reset_above;
};

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) / 16 * 16; }

// The dynamic shared memory of a block, each segment 16-byte aligned: the
// slab (M x W, column-major), the pivot's column and the RHS (M each), the pivot row's
// segment and the devex weights' (W each), the basis (m ints), the
// segment's active mask (W) and the artificial mask (n). The wrapper's
// cluster_plan counts the same bytes; the launch refuses a plan that
// disagrees.
template <typename T>
__host__ __device__ long long smem_bytes(int M, int N, int W) {
  const long long m = M - 2, n = N - 1, es = sizeof(T);
  return align16((long long)M * W * es) + 2 * align16((long long)M * es) +
         2 * align16((long long)W * es) + align16(4 * m) + align16(W) + align16(n);
}

template <typename T>
struct Layout {
  T* slab;
  T* colj;
  T* b;
  T* prow;
  T* gamma;
  int* basis;
  unsigned char* act;
  unsigned char* art;
};

template <typename T>
__device__ Layout<T> layout(int M, int N, int W, unsigned char* dyn) {
  Layout<T> L;
  const long long es = sizeof(T);
  long long off = 0;
  L.slab = (T*)(dyn + off);
  off += align16((long long)M * W * es);
  L.colj = (T*)(dyn + off);
  off += align16((long long)M * es);
  L.b = (T*)(dyn + off);
  off += align16((long long)M * es);
  L.prow = (T*)(dyn + off);
  off += align16((long long)W * es);
  L.gamma = (T*)(dyn + off);
  off += align16((long long)W * es);
  L.basis = (int*)(dyn + off);
  off += align16(4LL * (M - 2));
  L.act = dyn + off;
  off += align16(W);
  L.art = dyn + off;
  return L;
}

// What a block publishes after pricing: its candidate of the step's column
// reduction, the devex weights at its pick and at its first improving
// column (the entering column's weight, read by every block before anyone
// writes a weight), and whether its slab's row 2 has an entry that is not
// finite (the redirected pivot's no-op test).
template <typename T>
struct Mail {
  Red<T> red;
  T g_i, g_a;
  int row2_bad;
};

// The cluster barrier in two halves: arrive releases this thread's writes
// (shared memory included) to the cluster, wait acquires every peer's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Lighter block reductions than common.cuh's block_reduce, for the steps
// that need fewer of its fields; each takes the same tree (the warp tree,
// then across warps), so a sum comes out as block_reduce's. ``scratch`` is
// block_reduce's, reused: 33 values and 66 indices fit its bytes.
template <typename T>
__device__ void block_sum_min(T& s, int& a, Red<T>* scratch) {
  T* ss = (T*)scratch;
  int* sa = (int*)(ss + 33);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    s = add_rn(s, __shfl_down_sync(LANE_FULL, s, off));
    a = min(a, __shfl_down_sync(LANE_FULL, a, off));
  }
  if (lane == 0) {
    ss[warp] = s;
    sa[warp] = a;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < nw ? ss[lane] : T(0);
    a = lane < nw ? sa[lane] : BIG_I;
    for (int off = 16; off > 0; off >>= 1) {
      s = add_rn(s, __shfl_down_sync(LANE_FULL, s, off));
      a = min(a, __shfl_down_sync(LANE_FULL, a, off));
    }
    if (lane == 0) {
      ss[32] = s;
      sa[32] = a;
    }
  }
  __syncthreads();
  s = ss[32];
  a = sa[32];
  __syncthreads();  // scratch free again
}

// torch's argmin (mx false) / argmax (mx true) pick (v, i), as offer
// takes it, and a first index a.
template <typename T>
__device__ __forceinline__ void pick(T& v, int& i, T yv, int yi, bool mx) {
  Red<T> x;
  x.v = v;
  x.i = i;
  offer(x, yv, yi, mx);
  v = x.v;
  i = x.i;
}

template <typename T>
__device__ void block_pick(T& v, int& i, int& a, bool mx, Red<T>* scratch) {
  T* sv = (T*)scratch;
  int* si = (int*)(sv + 33);
  int* sa = si + 33;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const T yv = __shfl_down_sync(LANE_FULL, v, off);
    const int yi = __shfl_down_sync(LANE_FULL, i, off);
    const int ya = __shfl_down_sync(LANE_FULL, a, off);
    pick(v, i, yv, yi, mx);
    a = min(a, ya);
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
    sa[warp] = a;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? sv[lane] : (mx ? -pos_inf<T>() : pos_inf<T>());
    i = lane < nw ? si[lane] : BIG_I;
    a = lane < nw ? sa[lane] : BIG_I;
    for (int off = 16; off > 0; off >>= 1) {
      const T yv = __shfl_down_sync(LANE_FULL, v, off);
      const int yi = __shfl_down_sync(LANE_FULL, i, off);
      const int ya = __shfl_down_sync(LANE_FULL, a, off);
      pick(v, i, yv, yi, mx);
      a = min(a, ya);
    }
    if (lane == 0) {
      sv[32] = v;
      si[32] = i;
      sa[32] = a;
    }
  }
  __syncthreads();
  v = sv[32];
  i = si[32];
  a = sa[32];
  __syncthreads();
}

// torch.max's NaN-first maximum of the block's values.
template <typename T>
__device__ T block_nan_max(T v, Red<T>* scratch) {
  T* sv = (T*)scratch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_down_sync(LANE_FULL, v, off));
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? sv[lane] : -pos_inf<T>();
    for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_down_sync(LANE_FULL, v, off));
    if (lane == 0) sv[32] = v;
  }
  __syncthreads();
  v = sv[32];
  __syncthreads();
  return v;
}

// driver.ratio_rows over this block's copy of the entering column (colj)
// and the replicated RHS, as common.cuh's ratio_row takes it: whether an
// entry exceeds piv_tol (has_ratio) and the leaving row, among the tie set
// {b / col <= min} Bland's smallest basic index, else the largest pivot
// element, else the first row. Called by every thread of the block.
template <typename T>
__device__ int ratio_test(const T* col, const T* b, const int* basis, int m, T piv_tol,
                          bool use_bland, bool max_piv, Red<T>* scratch, bool& has_ratio) {
  const T inf = pos_inf<T>();
  T v = inf;
  int i = BIG_I, a = BIG_I;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const T c = col[r];
    const bool pos = c > piv_tol;
    if (pos) a = min(a, r);
    pick(v, i, pos ? div_rn(b[r], c) : inf, r, false);
  }
  block_pick(v, i, a, false, scratch);
  has_ratio = a != BIG_I;
  const bool min_nan = is_nan(v);
  if (!use_bland && !max_piv) return min_nan ? 0 : i;
  T v2 = use_bland ? inf : -inf;
  int i2 = BIG_I, none = BIG_I;
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    const T c = col[r];
    const T q = c > piv_tol ? div_rn(b[r], c) : inf;
    const bool tie = !min_nan && q <= v;
    if (use_bland)
      pick(v2, i2, tie ? T(basis[r]) : T(BIG_I), r, false);
    else
      pick(v2, i2, tie ? c : -inf, r, true);
  }
  block_pick(v2, i2, none, !use_bland, scratch);
  return i2;
}

// Over the m rows of the replicated RHS after a step (and before the
// first): the sum of |b| (s), and the first row whose basic column is
// artificial (a); on the dual walk the NaN-first argmin of b (v, i) and the
// first row below -feas_tol (a); the sum feeds the step's finiteness check.
// The result goes to ``out`` (read after the next block barrier); returns
// the sum.
template <typename T, bool DUAL>
__device__ T walk_rows(const Layout<T>& L, int m, T feas_tol, Red<T>* scratch, Red<T>* out) {
  Red<T> x = red_identity<T>(false);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const T bi = L.b[i + 2];
    x.s = add_rn(x.s, T(fabs(bi)));
    if (DUAL) {
      offer(x, bi, i, false);
      if (bi < -feas_tol) x.a = min(x.a, i);
    } else if (L.art[L.basis[i]]) {
      x.a = min(x.a, i);
    }
  }
  if (DUAL)
    x = block_reduce(x, scratch, false);
  else
    block_sum_min(x.s, x.a, scratch);
  if (threadIdx.x == 0) *out = x;
  return x.s;
}

// Block 0's clock, split by stage (Stage) when the caller asks for it:
// thread 0 of rank 0 adds the cycles since its last lap to the stage.
struct Laps {
  bool on;
  long long last;
  long long cyc[C_NSTAGES];
};

__device__ __forceinline__ void lap(Laps* t, int stage) {
  if (!t->on) return;
  const long long now = clock64();
  t->cyc[stage] += now - t->last;
  t->last = now;
}

// Column k of the frame, read from the shared memory of its owner into this
// block's colj (called by every thread; a barrier follows).
template <typename T>
__device__ void read_column(cg::cluster_group& cluster, const Layout<T>& L, int M, int W, int k) {
  const int owner = k / W;
  const T* src = cluster.map_shared_rank(L.slab, owner) + (long long)(k - owner * W) * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) L.colj[i] = src[i];
}

template <typename T, int WALK>
__global__ void __launch_bounds__(THREADS, 1) cluster_kernel(Params<T> p) {
  constexpr bool DEVEX = WALK == W_DEVEX, DUAL = WALK == W_DUAL;
  __shared__ Red<T> scratch[33];
  __shared__ Mail<T> mail;
  __shared__ Mail<T> peers[MAX_BLOCKS];
  __shared__ T gmax_mail;
  __shared__ T gmax_peers[MAX_BLOCKS];
  __shared__ Red<T> rows;  // walk_rows of the pre-step state
  __shared__ Red<T> comb;  // the cluster's combined candidate of a step
  __shared__ int comb_bad;
  __shared__ Laps laps;    // thread 0's, on block 0 only
  extern __shared__ __align__(16) unsigned char cluster_dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = THREADS / 32;
  const int M = p.M, N = p.N, W = p.W, m = M - 2, n = N - 1;
  // this block's columns [k0, k0 + wk)
  const int k0 = rank * W, wk = max(0, min(N, k0 + W) - k0);
  const Layout<T> L = layout<T>(M, N, W, cluster_dyn);
  const T inf = pos_inf<T>();
  // this block's lane (blockIdx.y; a solo walk is lane 0 of one): its
  // inputs (a lane stride of 0 is a row every lane shares) and outputs
  const long long b = blockIdx.y;
  const T* T_in = p.T_in + b * p.st_T;
  const int* basis_in = p.basis_in + b * p.st_basis;
  const unsigned char* act_in = p.act_in + b * p.st_act;
  const unsigned char* art_in = p.art_in + b * p.st_art;
  const T* gamma_in = DEVEX ? p.gamma_in + b * p.st_gamma : nullptr;
  T* T_out = p.T_out + b * M * N;
  unsigned char* act_out = p.act_out + b * n;
  unsigned char* art_out = p.art_out + b * n;
  T* gamma_out = DEVEX ? p.gamma_out + b * n : nullptr;
  int phase = p.phase_in[b * p.st_phase], status = p.status_in[b * p.st_status],
      niter = p.niter_in[b * p.st_niter], stuck = p.stuck_in[b * p.st_stuck];
  bool bland = p.bland_in[b * p.st_bland] != 0;
  T last_z = p.lastz_in[b * p.st_lastz];
  if (!(status == ST_RUNNING && niter < p.max_iters)) {
    // a lane not running within its budget: its input copied out, no step
    // and no read of a peer (so no cluster barrier)
    for (int i = warp; i < M; i += nw)
      for (int kk = lane; kk < wk; kk += 32)
        T_out[(long long)i * N + k0 + kk] = T_in[(long long)i * N + k0 + kk];
    for (int kk = tid; kk < wk; kk += THREADS) {
      const int k = k0 + kk;
      if (k >= n) continue;
      act_out[k] = act_in[k] != 0;
      art_out[k] = art_in[k] != 0;
      if (DEVEX) gamma_out[k] = gamma_in[k];
    }
    if (rank == 0) {
      for (int i = tid; i < m; i += THREADS) p.basis_out[b * m + i] = basis_in[i];
      if (tid == 0) {
        p.ints_out[O_PHASE * p.out_field + b] = phase;
        p.ints_out[O_STATUS * p.out_field + b] = status;
        p.ints_out[O_NITER * p.out_field + b] = niter;
        p.ints_out[O_STUCK * p.out_field + b] = stuck;
        p.bland_out[b] = bland;
        p.lastz_out[b] = last_z;
      }
    }
    return;
  }
  if (tid == 0) {
    laps.on = p.cycles != nullptr && rank == 0 && b == 0;
    laps.last = clock64();
    for (int k = 0; k < C_NSTAGES; ++k) laps.cyc[k] = 0;
  }

  // ---- load: the slab, the replicated vectors, the scalars ----
  for (int i = warp; i < M; i += nw)
    for (int kk = lane; kk < wk; kk += 32)
      L.slab[(long long)kk * M + i] = T_in[(long long)i * N + k0 + kk];
  for (int i = tid; i < M; i += THREADS) L.b[i] = T_in[(long long)i * N + N - 1];
  for (int i = tid; i < m; i += THREADS) L.basis[i] = basis_in[i];
  for (int k = tid; k < n; k += THREADS) L.art[k] = art_in[k] != 0;
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    L.act[kk] = k < n && act_in[k] != 0;
    L.gamma[kk] = DEVEX && k < n ? gamma_in[k] : T(1);
  }
  __syncthreads();
  // every peer running and loaded before any read of its shared memory
  cluster_arrive();
  cluster_wait();

  walk_rows<T, DUAL>(L, m, p.feas_tol, scratch, &rows);
  __syncthreads();
  if (tid == 0) lap(&laps, C_LOAD);
  while (status == ST_RUNNING && niter < p.max_iters) {
    // ---- 1. price over the own columns; published; A1 ----
    bool cleanup = false, scan_tick = false, mx = false;
    int r_d = 0, r = 0;
    bool feasible = false;
    Red<T> cols;
    bool bad2 = false;
    if (DUAL) {
      // the leaving row: the most negative b, the first negative under
      // Bland; the dual ratio c_j / -T[r, j] over the active T[r, j] <
      // -piv_tol (v, i), the first of them (a), the sum of the pre-step
      // |c| over the active columns (s)
      feasible = rows.a == BIG_I;
      r = bland ? (feasible ? m - 1 : rows.a) : rows.i;
      const T* row = L.slab + r + 2;
      cols = red_identity<T>(false);
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        bad2 = bad2 || !finite_val(L.slab[(long long)kk * M + 2]);
        if (k >= n) continue;
        const T c = L.slab[(long long)kk * M];
        const T a = row[(long long)kk * M];
        if (L.act[kk] && a < -p.piv_tol) {
          cols.a = min(cols.a, k);
          offer(cols, div_rn(c, -a), k, false);
        }
        if (L.act[kk]) cols.s = add_rn(cols.s, T(fabs(c)));
      }
      cols = block_reduce(cols, scratch, false);
    } else {
      cleanup = rows.a != BIG_I && phase == 2;
      r_d = rows.a != BIG_I ? rows.a : 0;
      // devex's ticks: the exposed-ray scan, the half-period Dantzig probe
      const int tick = niter % p.ray_every;
      scan_tick = DEVEX && tick == 0 && phase == 2 && !cleanup;
      const bool probe = DEVEX && tick == p.ray_every / 2 && phase == 2 && !cleanup;
      const bool by_score = DEVEX && !probe;
      mx = by_score || p.max_inc;
      // over the own columns: the pick (v, i); the first improving column
      // (a); the first clean-up-eligible column, else on a ray tick the
      // first improving column with no entry above piv_tol (b); the sum of
      // |crow| over the active columns (s)
      const T* rowd = L.slab + r_d + 2;
      const T* crow = L.slab + (phase == 1 ? 1 : 0);
      if (scan_tick) {
        // devex's exposed-ray scan: whether each own column has an entry
        // above piv_tol, SCAN_LANES lanes a column, into prow (1 or 0)
        const int g = tid / SCAN_LANES, l = tid % SCAN_LANES;
        for (int k1 = 0; k1 < wk; k1 += THREADS / SCAN_LANES) {
          const int kk = k1 + g;
          int has_pos = 0;
          if (kk < wk) {
            const T* col = L.slab + (long long)kk * M;
            for (int i = l; i < m && !has_pos; i += SCAN_LANES) has_pos = col[i + 2] > p.piv_tol;
          }
          for (int off = SCAN_LANES / 2; off > 0; off >>= 1)
            has_pos |= __shfl_xor_sync(LANE_FULL, has_pos, off, SCAN_LANES);
          if (kk < wk && l == 0) L.prow[kk] = has_pos ? T(1) : T(0);
        }
        __syncthreads();
      }
      if (p.max_inc) {
        // the greatest increase's column pass: every own column's minimum
        // ratio b_i / T[i, k] over T[i, k] > piv_tol (NaN-propagating, as
        // torch's min), SCAN_LANES lanes a column, each over every
        // SCAN_LANES-th row, then combined across the lanes (the minimum
        // does not depend on the order); into prow, which the step
        // writes only after barrier A1
        // (the loop's bound is the same in every lane: the shuffles need
        // the whole warp)
        const int g = tid / SCAN_LANES, l = tid % SCAN_LANES;
        for (int k1 = 0; k1 < wk; k1 += THREADS / SCAN_LANES) {
          const int kk = k1 + g;
          T ratio = inf;
          if (kk < wk) {
            const T* col = L.slab + (long long)kk * M;
            for (int i = l; i < m; i += SCAN_LANES) {
              const T a = col[i + 2];
              const T q = a > p.piv_tol ? div_rn(L.b[i + 2], a) : inf;
              if (!is_nan(ratio) && (is_nan(q) || q < ratio)) ratio = q;
            }
          }
          for (int off = SCAN_LANES / 2; off > 0; off >>= 1) {
            const T q = __shfl_xor_sync(LANE_FULL, ratio, off, SCAN_LANES);
            if (!is_nan(ratio) && (is_nan(q) || q < ratio)) ratio = q;
          }
          if (kk < wk && l == 0) L.prow[kk] = ratio;
        }
        __syncthreads();
      }
      cols = red_identity<T>(mx);
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        const T* col = L.slab + (long long)kk * M;  // column k
        bad2 = bad2 || !finite_val(col[2]);
        if (k >= n) continue;
        const bool act = L.act[kk] != 0;
        const T c = crow[(long long)kk * M];
        const T c_eff = act ? c : inf;
        const bool improving = c_eff < -p.opt_tol;
        if (improving) cols.a = min(cols.a, k);
        if (act) cols.s = add_rn(cols.s, T(fabs(c)));
        if (cleanup) {
          if (act && !L.art[k] && T(fabs(rowd[(long long)kk * M])) > p.piv_tol)
            cols.b = min(cols.b, k);
        } else if (scan_tick && improving && L.prow[kk] == T(0)) {
          cols.b = min(cols.b, k);
        }
        if (by_score) {
          offer(cols, improving ? div_rn(mul_rn(c, c), L.gamma[kk]) : -inf, k, true);
        } else if (p.max_inc) {
          const T ratio = L.prow[kk];
          offer(cols, improving ? (ratio < inf ? mul_rn(-c_eff, ratio) : inf) : -inf, k, true);
        } else {
          offer(cols, c_eff, k, false);
        }
      }
      cols = block_reduce(cols, scratch, mx);
    }
    bad2 = __syncthreads_or(bad2) != 0;
    if (tid == 0) {
      mail.red = cols;
      mail.g_i = DEVEX && cols.i >= k0 && cols.i < k0 + wk ? L.gamma[cols.i - k0] : T(0);
      mail.g_a = DEVEX && cols.a >= k0 && cols.a < k0 + wk ? L.gamma[cols.a - k0] : T(0);
      mail.row2_bad = bad2;
      lap(&laps, C_PRICE);
    }
    cluster_arrive();
    cluster_wait();
    if (tid == 0) lap(&laps, C_A1);

    // ---- 2. combine in rank order; the ratio test; the pivot ----
    if (warp == 0) {
      // lane q < C brings block q's mailbox; a shuffle tree takes the pick
      // (v, i) and the first indices (offer's order is total, so the tree
      // gives the rank-order combine exactly) and lane 0 adds the sums in
      // rank order
      Red<T> x = red_identity<T>(mx);
      int bad = 0;
      if (lane < C) {
        peers[lane] = *cluster.map_shared_rank(&mail, lane);
        x = peers[lane].red;
        bad = peers[lane].row2_bad;
      }
      const T sq = x.s;
      for (int off = MAX_BLOCKS / 2; off > 0; off >>= 1) {
        const T v = __shfl_down_sync(LANE_FULL, x.v, off);
        const int i = __shfl_down_sync(LANE_FULL, x.i, off);
        const int a = __shfl_down_sync(LANE_FULL, x.a, off);
        const int b = __shfl_down_sync(LANE_FULL, x.b, off);
        offer(x, v, i, mx);
        x.a = min(x.a, a);
        x.b = min(x.b, b);
      }
      T sum = __shfl_sync(LANE_FULL, sq, 0);
      for (int q = 1; q < C; ++q) sum = add_rn(sum, __shfl_sync(LANE_FULL, sq, q));
      bad = __any_sync(LANE_FULL, bad);
      if (lane == 0) {
        x.s = sum;
        comb = x;
        comb_bad = bad;
      }
    }
    __syncthreads();
    const Red<T> all = comb;
    const bool row2_bad = comb_bad != 0;
    const bool crow_ok = finite_val(all.s);
    int j;
    bool do_pivot, do_pricing = false, to_phase2 = false, retire = false, infeasible, unbounded = false;
    bool has_improving = false;
    T gq = T(0);
    if (DUAL) {
      const bool has_elig = all.a != BIG_I;
      // a NaN minimum leaves no tie, so the entering column is then 0
      j = has_elig && !is_nan(all.v) ? all.i : 0;
      do_pivot = !feasible && has_elig;
      infeasible = !feasible && !has_elig;
      read_column(cluster, L, M, W, j);
      __syncthreads();
    } else {
      has_improving = all.a != BIG_I;
      const bool has_elig = cleanup && all.b != BIG_I;
      const bool use_bland = bland || p.bland_rule;
      const int j_price = use_bland ? (has_improving ? all.a : n - 1) : all.i;
      const bool phase1_done = phase == 1 && !has_improving;
      const bool infeasible1 = phase1_done && -L.b[1] > p.infeas_tol;
      to_phase2 = phase1_done && !infeasible1;
      const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
      retire = cleanup && !has_elig;
      const bool ray = scan_tick && all.b != BIG_I;
      j = cleanup ? (has_elig ? all.b : n - 1) : j_price;
      if (DEVEX && has_improving) {
        // the entering column's weight, from its owner's mailbox
        const int jq = use_bland ? all.a : all.i;
        if (jq >= 0 && jq < n) gq = use_bland ? peers[jq / W].g_a : peers[jq / W].g_i;
      }
      // the ratio test over column j (driver.ratio_rows), on this block's
      // copy of it
      read_column(cluster, L, M, W, j);
      __syncthreads();
      bool has_ratio = false;
      int r_price = 0;
      if (pricing_pivot)
        r_price = ratio_test(L.colj + 2, L.b + 2, L.basis, m, p.piv_tol, use_bland, p.max_piv,
                             scratch, has_ratio);
      const bool do_cleanup = cleanup && has_elig;
      do_pricing = pricing_pivot && has_ratio;
      do_pivot = do_cleanup || do_pricing;
      r = do_cleanup ? r_d : r_price;
      unbounded = (pricing_pivot && !has_ratio && phase == 2) || ray;
      infeasible = infeasible1 || (pricing_pivot && !has_ratio && phase != 2);
    }
    if (tid == 0) lap(&laps, C_RATIO);
    const int leaving = L.basis[r];
    const T piv = L.colj[r + 2];
    // the update's pivot: (r + 2, j), else the plain step's redirected one
    // on (row 2, basis[0]) unless that is an exact no-op
    int rg = r + 2, jp = j;
    bool pv = do_pivot;
    if (!do_pivot) {
      rg = 2;
      jp = L.basis[0];
      __syncthreads();  // every read of column j done
      read_column(cluster, L, M, W, jp);
      __syncthreads();
      bool not_unit = false;
      for (int i = tid; i < M; i += THREADS)
        not_unit = not_unit || L.colj[i] != (i == 2 ? T(1) : T(0));
      pv = row2_bad || __syncthreads_or(not_unit) != 0;
    }
    T prhs = T(0);
    if (pv) {
      const T rinv = div_rn(T(1), L.colj[rg]);
      for (int kk = tid; kk < wk; kk += THREADS)
        L.prow[kk] = mul_rn(L.slab[(long long)kk * M + rg], rinv);
      prhs = mul_rn(L.b[rg], rinv);
    }
    if (DEVEX) {
      // the weights of the own columns (alpha: the post-pivot row, column
      // j snapped to 1; each thread reads the prow entries it wrote), and
      // their NaN-first maximum, published for A2
      const T qv = div_rn(gq, mul_rn(piv, piv));
      const T leave = is_nan(qv) ? qv : (qv < T(1) ? T(1) : qv);
      T g = -inf;
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        if (k >= n) continue;
        T gk = L.gamma[kk];
        if (do_pricing) {
          const T a = k == jp ? T(1) : L.prow[kk];
          gk = nan_max(gk, mul_rn(mul_rn(a, a), gq));
          if (k == leaving) gk = leave;
        }
        L.gamma[kk] = gk;
        g = nan_max(g, gk);
      }
      g = block_nan_max(g, scratch);
      if (tid == 0) gmax_mail = g;
    }
    __syncthreads();  // prow complete
    if (tid == 0) lap(&laps, C_ROW);
    cluster_arrive();

    // ---- 3. the update, the finish; A2 waits; the pivot's column ----
    if (pv && !do_pivot) cluster_wait();  // the redirected pivot may write any column
    if (pv) {
      // thread t takes row t % M of the columns t / M, t / M + R, ... (R =
      // THREADS / M), its entry of the pivot's column in a register;
      // taller slabs go column by column
      const T* colj = L.colj;
      if (M <= THREADS) {
        const int R = THREADS / M, i = tid % M, c0 = tid / M;
        if (c0 < R) {
          // four columns at a time, their loads issued before any store
          constexpr int UB = 4;
          const T nc = -colj[i];
          const bool on_r = i == rg;
          const long long stride = (long long)R * M;
          int kk = c0;
          for (; kk + (UB - 1) * R < wk; kk += UB * R) {
            T* e = L.slab + (long long)kk * M + i;
            T v[UB];
#pragma unroll
            for (int u = 0; u < UB; ++u) v[u] = e[u * stride];
#pragma unroll
            for (int u = 0; u < UB; ++u) {
              const T pk = L.prow[kk + u * R];
              v[u] = on_r ? pk : fma(nc, pk, v[u]);
            }
#pragma unroll
            for (int u = 0; u < UB; ++u)
              if (k0 + kk + u * R != jp) e[u * stride] = v[u];
          }
          for (; kk < wk; kk += R) {
            if (k0 + kk == jp) continue;
            T* e = L.slab + (long long)kk * M + i;
            *e = on_r ? L.prow[kk] : fma(nc, L.prow[kk], *e);
          }
        }
      } else {
        for (int kk = 0; kk < wk; ++kk) {
          if (k0 + kk == jp) continue;
          T* col = L.slab + (long long)kk * M;
          const T pk = L.prow[kk];
          for (int i = tid; i < M; i += THREADS)
            col[i] = i == rg ? pk : fma(-colj[i], pk, col[i]);
        }
      }
      for (int i = tid; i < M; i += THREADS)
        L.b[i] = i == rg ? prhs : fma(-colj[i], prhs, L.b[i]);
    }
    if (tid == 0) lap(&laps, C_UPDATE);
    if (tid == 0) {
      if (do_pivot) L.basis[r] = j;
      // a retire pivots nowhere: the basis is the pre-step one
      if (retire) L.art[L.basis[r_d]] = 0;
    }
    if (to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) L.act[kk] = L.act[kk] && !L.art[k0 + kk];
    __syncthreads();
    const T rows_s = walk_rows<T, DUAL>(L, m, p.feas_tol, scratch, &rows);
    // stall and the Bland switch against the current objective (the dual
    // objective on the dual walk), the phase change, the status
    const T z = DUAL ? -L.b[0] : -L.b[phase == 1 ? 1 : 0];
    if (DUAL ? do_pivot : do_pricing) {
      const T d = DUAL ? sub_rn(z, last_z) : sub_rn(last_z, z);
      stuck = d > p.degen_tol ? 0 : stuck + 1;
      last_z = z;
    }
    bland = bland || stuck >= p.stall_limit;
    const bool finished = DUAL ? feasible : phase == 2 && !has_improving && !cleanup;
    if (to_phase2) {
      phase = 2;
      stuck = 0;
      last_z = inf;
    }
    const bool finite_ok = finite_val(z) && finite_val(rows_s) && crow_ok;
    status = !finite_ok ? ST_NUMERIC
             : infeasible ? ST_INFEASIBLE
             : unbounded ? ST_UNBOUNDED
             : finished ? ST_OPTIMAL
                        : ST_RUNNING;
    niter += do_pivot;
    if (tid == 0) lap(&laps, C_FINISH);
    if (!(pv && !do_pivot)) cluster_wait();
    if (pv && jp >= k0 && jp < k0 + wk)
      for (int i = tid; i < M; i += THREADS)
        L.slab[(long long)(jp - k0) * M + i] = i == rg ? T(1) : T(0);
    if (DEVEX) {
      if (tid < C) gmax_peers[tid] = *cluster.map_shared_rank(&gmax_mail, tid);
      __syncthreads();
      T g = -inf;
      for (int q = 0; q < C; ++q) g = nan_max(g, gmax_peers[q]);
      if (g > p.reset_above || to_phase2)
        for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
    }
    __syncthreads();
    if (tid == 0) lap(&laps, C_A2);
  }

  // ---- write back: the slab, the masks' and weights' shares, the basis
  // and the scalars ----
  for (int i = warp; i < M; i += nw)
    for (int kk = lane; kk < wk; kk += 32)
      T_out[(long long)i * N + k0 + kk] = L.slab[(long long)kk * M + i];
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    if (k >= n) continue;
    act_out[k] = L.act[kk];
    art_out[k] = L.art[k];
    if (DEVEX) gamma_out[k] = L.gamma[kk];
  }
  if (rank == 0) {
    for (int i = tid; i < m; i += THREADS) p.basis_out[b * m + i] = L.basis[i];
    if (tid == 0) {
      p.ints_out[O_PHASE * p.out_field + b] = phase;
      p.ints_out[O_STATUS * p.out_field + b] = status;
      p.ints_out[O_NITER * p.out_field + b] = niter;
      p.ints_out[O_STUCK * p.out_field + b] = stuck;
      p.bland_out[b] = bland;
      p.lastz_out[b] = last_z;
    }
  }
  if (tid == 0 && laps.on) {
    lap(&laps, C_STORE);
    for (int k = 0; k < C_NSTAGES; ++k) p.cycles[k] += laps.cyc[k];
  }
  // no block leaves while a peer may still read its shared memory
  cluster_arrive();
  cluster_wait();
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
Params<T> make_params(const long long* a, const int* in, const double* tol) {
  Params<T> p;
  p.T_in = (const T*)a[A_T_IN];
  p.T_out = (T*)a[A_T_OUT];
  p.basis_in = (const int*)a[A_BASIS_IN];
  p.basis_out = (int*)a[A_BASIS_OUT];
  p.act_in = (const unsigned char*)a[A_ACT_IN];
  p.act_out = (unsigned char*)a[A_ACT_OUT];
  p.art_in = (const unsigned char*)a[A_ART_IN];
  p.art_out = (unsigned char*)a[A_ART_OUT];
  p.gamma_in = (const T*)a[A_GAMMA_IN];
  p.gamma_out = (T*)a[A_GAMMA_OUT];
  p.phase_in = (const int*)a[A_PHASE_IN];
  p.status_in = (const int*)a[A_STATUS_IN];
  p.niter_in = (const int*)a[A_NITER_IN];
  p.stuck_in = (const int*)a[A_STUCK_IN];
  p.bland_in = (const unsigned char*)a[A_BLAND_IN];
  p.lastz_in = (const T*)a[A_LASTZ_IN];
  p.ints_out = (int*)a[A_INTS_OUT];
  p.bland_out = (unsigned char*)a[A_BLAND_OUT];
  p.lastz_out = (T*)a[A_LASTZ_OUT];
  p.cycles = (long long*)a[A_CYCLES];
  p.st_T = a[A_ST_T];
  p.st_basis = a[A_ST_BASIS];
  p.st_act = a[A_ST_ACT];
  p.st_art = a[A_ST_ART];
  p.st_gamma = a[A_ST_GAMMA];
  p.st_phase = a[A_ST_PHASE];
  p.st_status = a[A_ST_STATUS];
  p.st_niter = a[A_ST_NITER];
  p.st_stuck = a[A_ST_STUCK];
  p.st_bland = a[A_ST_BLAND];
  p.st_lastz = a[A_ST_LASTZ];
  p.out_field = a[A_OUT_FIELD];
  p.M = in[I_M];
  p.N = in[I_N];
  const int C = in[I_BLOCKS];
  p.W = C > 0 ? (p.N + C - 1) / C : 0;
  p.stall_limit = in[I_STALL];
  p.max_iters = in[I_MAXIT];
  p.ray_every = in[I_RAY_EVERY];
  const bool primal = in[I_WALK] == W_PRIMAL;
  p.bland_rule = primal && in[I_RULE] == RULE_BLAND_;
  p.max_inc = primal && in[I_RULE] == RULE_MAX_INCREASE_;
  p.max_piv = primal && in[I_TIE] == TIE_MAXPIV_;
  p.opt_tol = (T)tol[D_OPT];
  p.piv_tol = (T)tol[D_PIV];
  p.degen_tol = (T)tol[D_DEGEN];
  p.infeas_tol = (T)tol[D_INFEAS];
  p.feas_tol = (T)tol[D_FEAS];
  p.reset_above = (T)tol[D_RESET];
  return p;
}

// The plan's figures against this layout: a cluster of 1, 2, 4 or 8 blocks
// of THREADS threads, the bytes smem_bytes counts.
template <typename T>
bool plan_ok(const int* in) {
  const int M = in[I_M], N = in[I_N], C = in[I_BLOCKS];
  if (M < 3 || N < 2 || in[I_THREADS] != THREADS || in[I_RAY_EVERY] < 1 || in[I_LANES] < 1 ||
      in[I_LANES] > 65535 ||
      (C != 1 && C != 2 && C != 4 && C != 8) || in[I_WALK] < W_PRIMAL || in[I_WALK] > W_DUAL)
    return false;
  return (long long)in[I_SMEM] == smem_bytes<T>(M, N, (N + C - 1) / C);
}

template <typename T>
bool pointers_ok(const Params<T>& p, int walk) {
  return p.T_in && p.T_out && p.basis_in && p.basis_out && p.act_in && p.act_out && p.art_in &&
         p.art_out && p.phase_in && p.status_in && p.niter_in && p.stuck_in && p.bland_in &&
         p.lastz_in && p.ints_out && p.bland_out && p.lastz_out &&
         (walk != W_DEVEX || (p.gamma_in && p.gamma_out));
}

template <typename T, int WALK>
cudaLaunchConfig_t config(int C, int lanes, int smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, lanes, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the instantiation's dynamic shared memory raised to smem where that is
// above what it allows
template <typename T, int WALK>
int raise_smem(int smem) {
  static int raised = 48 * 1024;  // per instantiation
  if (smem <= raised) return 0;
  const cudaError_t e = cudaFuncSetAttribute((const void*)cluster_kernel<T, WALK>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  raised = smem;
  return 0;
}

template <typename T, int WALK>
int launch_walk(const Params<T>& p, int C, int lanes, int smem, cudaStream_t s) {
  const int err = raise_smem<T, WALK>(smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, WALK>(C, lanes, smem, s, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_kernel<T, WALK>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int rank1_cluster(const long long* a, const int* in, const double* tol, void* stream) {
  if (!plan_ok<T>(in)) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(a, in, tol);
  const int walk = in[I_WALK];
  if (!pointers_ok(p, walk)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int C = in[I_BLOCKS], smem = in[I_SMEM], lanes = in[I_LANES];
  if (walk == W_DEVEX) return launch_walk<T, W_DEVEX>(p, C, lanes, smem, s);
  if (walk == W_DUAL) return launch_walk<T, W_DUAL>(p, C, lanes, smem, s);
  return launch_walk<T, W_PRIMAL>(p, C, lanes, smem, s);
}

template <typename T, int WALK>
int occupancy_of(int C, int smem, int* clusters) {
  const int err = raise_smem<T, WALK>(smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T, WALK>(C, 1, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)cluster_kernel<T, WALK>,
                                             &cfg);
}

// cudaOccupancyMaxActiveClusters of the plan's launch: how many such
// clusters the card can hold at once (0: the launch cannot run)
template <typename T>
int rank1_cluster_occupancy(const int* in, int* clusters) {
  if (!plan_ok<T>(in) || !clusters) return (int)cudaErrorInvalidValue;
  const int C = in[I_BLOCKS], smem = in[I_SMEM];
  switch (in[I_WALK]) {
    case W_DEVEX:
      return occupancy_of<T, W_DEVEX>(C, smem, clusters);
    case W_DUAL:
      return occupancy_of<T, W_DUAL>(C, smem, clusters);
    default:
      return occupancy_of<T, W_PRIMAL>(C, smem, clusters);
  }
}

}  // namespace rkc
}  // namespace tpulp

extern "C" int tpulp_rank1_cluster_f32(const long long* a, const int* in, const double* tol,
                                       void* stream) {
  return tpulp::rkc::rank1_cluster<float>(a, in, tol, stream);
}
extern "C" int tpulp_rank1_cluster_f64(const long long* a, const int* in, const double* tol,
                                       void* stream) {
  return tpulp::rkc::rank1_cluster<double>(a, in, tol, stream);
}
extern "C" int tpulp_rank1_cluster_occupancy_f32(const int* in, int* clusters) {
  return tpulp::rkc::rank1_cluster_occupancy<float>(in, clusters);
}
extern "C" int tpulp_rank1_cluster_occupancy_f64(const int* in, int* clusters) {
  return tpulp::rkc::rank1_cluster_occupancy<double>(in, clusters);
}
