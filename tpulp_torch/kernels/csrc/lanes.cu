// lane_dual_kernel / lane_primal_kernel / lane_bounded_kernel: the
// branch-and-bound waves', the rank-1 batch's and the bounded batch's
// simplex loops, one block per lane, each lane stepped to its own exit in
// one launch.
//
// Replaces no Pallas kernel: in tpulp these loops are XLA's compiled
// ``lax.while_loop`` over ``dual_simplex_step`` / ``simplex_step``, vmapped
// over the lanes (tpulp/solve/dual.py: _compiled_warm_carry,
// _compiled_warm_wave, _compiled_expand_generation and the batched warm
// start; tpulp/batch/vmap_driver.py: _batched_driver), and
// ``jax.jit(jax.vmap(_compiled_bounded_driver))`` over
// ``bounded_simplex_step`` (tpulp/solve/bounded.py: 308-330 the batch,
// 86-275 the step), which solve_lp_batch(simple_bounds=True) and the
// span-encoded branch-and-bound (milp/spans.py) run.
//
// What bounds it on the H100: the chain of dependent block-wide decisions
// in every step (the entering column, the leaving row, the pivot, the
// finiteness sums); the bytes (each lane's frame read and written once)
// are microseconds of the card's rate. The lanes are independent and
// small (a 59 x 114 f64 frame is 53.8 KB), so one block owns one lane: no
// grid barrier and no cooperative launch.
//
// Each step is the plain step's statement for statement: first-index ties
// in every (value, index) reduction, NaN-propagating argmin/argmax as
// torch's (the first NaN wins), comparisons in the tableau's type against
// the tolerances rounded to it, IEEE division and one rounding per
// product, and the pivot as the plain version computes it: prow = row *
// (1 / piv), fma(-col[i], prow[k], T[i, k]), row r set to prow, column j
// to the unit vector. The scalars are held by every thread alike (each
// computes them from the same reduction results). Block b loads lane b's
// frame, basis, masks and scalars, steps while status == RUNNING and niter
// < max_iters (every step pivots, retires an artificial, changes phase, or
// leaves RUNNING, so the budget bounds the launch), and writes the lane
// back once; with RESIDENT the frame lives in dynamic shared memory,
// otherwise the block works on its output frame in device memory (through
// L2), with the same code.
//
// The three kernels (lane_dual_kernel: solve/dual.py::dual_simplex_step;
// lane_primal_kernel: solve/driver.py::simplex_step; lane_bounded_kernel:
// solve/bounded.py::bounded_simplex_step) share one layout, one load and
// store, and take one barrier a decision:
// - Key reductions (common.cuh's okey and warp_arg over redux.sync: the
//   sequential argmin exactly, NaN first, ties to the first index) into
//   scratch owned by each call site; on a block of one warp no block
//   barrier at all. The finiteness sums are taken in block_reduce's tree
//   only where a term is near the overflow (otherwise finite in any
//   order).
// - The update has no barrier before it: each thread pivots its own
//   columns (k = its slot, slot + slots, ...; it reads its pivot-row entry
//   before it writes, and where the block's threads cover the columns
//   twice two lanes of one warp split a column's rows), and the thread of
//   row i writes that row's RHS into the other of two RHS buffers, its
//   basis entry into the other of two basis buffers, and adds |b| and the
//   first artificial row for the next step. The next step's price pass
//   (each column by the lane that updated its first rows) and those row
//   partials go into one reduction, after which the previous step's
//   objective, stall counter and status are finished: a Dantzig step
//   passes two block barriers.
// - The frame's n columns sit at an odd row pitch, the RHS and the pivot's
//   column in vectors of their own, so that a warp reading a column (a
//   thread a row) meets every bank once.
// - A block has 32 to 256 threads from the frame's width
//   (kernels/lanes.py::lane_threads), so 10c's 3 x 30 nodes run one warp.
//
// lane_dual_kernel folds the next step's row scan into the pivot: the
// leaving row's decision (the argmin of b, NaN first; the first row below
// -feas_tol for Bland; the |b| sum) is one key reduction over the rows'
// partials that the previous update left (the thread of row i writes the
// new b_i into the other RHS buffer and offers it), which also takes the
// objective row's |c| sum over the active columns (each column's owner adds
// its new entry as it pivots it). The entering column's decision (the
// first-index argmin of crow / -T[r, k] over the active T[r, k] < -piv_tol,
// NaN first, and the first eligible column) is the second reduction. The
// update reads the pivot's column where it stands in the frame: its owner
// leaves it until after the next reduction, then writes the unit vector.
// The pivot step's stall counter (against the dual objective) and status
// are finished after the next reduction; a step that does not pivot ends
// the lane at once (without the plain step's redirected pivot on (row 2,
// basis[0]), which on a unit column changes no value). A dual step passes
// two block barriers.
//
// lane_bounded_kernel steps the bounded step the same way: the clean-up
// and the retire; Dantzig or devex pricing (c^2 / gamma over the improving
// columns; the pass also prices under unit weights, for the previous
// step's reset on its largest weight, which that step leaves pending) with
// the Bland switch, every other rule priced as Dantzig; the three-way
// ratio test (a lower hit, then an upper hit, then the entering flip on
// exact ties; the winning kind's first index, or Bland's smallest basic
// index among its ties) with its two minima in one reduction; one pivot;
// the devex update and its two resets; one column flip (the RHS
// fma(-Tn[i, fcol], uf, Tn[i, -1]) with one rounding, then the column
// negated). While every basic column is the unit vector on its row (as
// bounded_grid.cu keeps it: checked at the launch, kept by every pivot
// whose column and 1 / pivot are finite) the flip's column and basis[0]'s
// are known without a read, so the row's thread computes its RHS whole;
// otherwise the rows snapshot both columns behind a barrier. Like
// bounded_grid.cu it skips the plain step's redirected pivot on (row 2,
// basis[0]) where that is an exact no-op (it could change only a zero's
// sign); elsewhere it runs it.

#include "common.cuh"

namespace tpulp {

constexpr int LANE_MAX_THREADS = 256;
// status codes and pricing rules (tpulp_torch.core.state)
constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
constexpr int RULE_BLAND_ = 1, RULE_MAX_INCREASE_ = 2, RULE_DEVEX_ = 3;
// re-anchor the devex frame past this weight (kernels/bounded.py:
// DEVEX_RESET_ABOVE)
constexpr double DEVEX_RESET_ABOVE_ = 1e8;

// the wrapper's argument arrays (tpulp_torch/kernels/lanes.py)
enum LanePtr {
  A_T_IN, A_T_OUT, A_BASIS_IN, A_BASIS_OUT, A_ACT_IN, A_ART_IN, A_ACT_OUT, A_ART_OUT,
  A_PHASE_IN, A_STATUS_IN, A_NITER_IN, A_STUCK_IN, A_BLAND_IN, A_LASTZ_IN,
  A_PHASE_OUT, A_STATUS_OUT, A_NITER_OUT, A_STUCK_OUT, A_BLAND_OUT, A_LASTZ_OUT,
  // lane strides in elements of the inputs
  A_ST_T, A_ST_BASIS, A_ST_ACT, A_ST_ART, A_ST_PHASE, A_ST_STATUS, A_ST_NITER, A_ST_STUCK,
  A_ST_BLAND, A_ST_LASTZ, A_NARGS
};
// the bounded lanes' arrays after those: the spans, the at-upper flags and
// the devex weights, in and out, and their lane strides
enum BoundedPtr {
  A_UPPER = A_NARGS, A_AT_IN, A_AT_OUT, A_GAMMA_IN, A_GAMMA_OUT, A_ST_UPPER, A_ST_AT,
  A_ST_GAMMA, A_BNARGS
};
// then (every kind) block 0's stage clock, or null
enum ClockPtr { A_CYCLES = A_BNARGS, A_ALLARGS };
enum LaneInt { I_B, I_M, I_N, I_STALL, I_MAXIT, I_RULE, I_TIE, I_RESIDENT, I_THREADS, I_SMEM, I_NINTS };
enum LaneTol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_FEAS, D_NTOLS };

template <typename T>
struct LaneParams {
  const T* T_in;
  T* T_out;
  const int* basis_in;
  int* basis_out;
  const unsigned char* act_in;
  const unsigned char* art_in;
  unsigned char* act_out;  // primal and bounded only
  unsigned char* art_out;  // primal and bounded only
  const int* phase_in;
  const int* status_in;
  const int* niter_in;
  const int* stuck_in;
  const unsigned char* bland_in;
  const T* lastz_in;
  int* phase_out;
  int* status_out;
  int* niter_out;
  int* stuck_out;
  unsigned char* bland_out;
  T* lastz_out;
  long long st_T, st_basis, st_act, st_art, st_phase, st_status, st_niter, st_stuck, st_bland,
      st_lastz;
  long long* cycles;  // (S_NSTAGES,) block 0's clock, or null
  int M, N, stall_limit, max_iters, rule, tie;
  // the tolerances rounded to T: the plain step compares T tensors with
  // Python floats, which torch rounds to the tensor's type
  T opt_tol, piv_tol, degen_tol, infeas_tol, feas_tol;
};

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) / 16 * 16; }

struct Scalars {
  int phase, status, niter, stuck;
  bool bland;
};

template <typename T>
__device__ void store_scalars(const LaneParams<T>& p, const Scalars& s, T last_z) {
  if (threadIdx.x != 0) return;
  const int lane = blockIdx.x;
  p.phase_out[lane] = s.phase;
  p.status_out[lane] = s.status;
  p.niter_out[lane] = s.niter;
  p.stuck_out[lane] = s.stuck;
  p.bland_out[lane] = s.bland;
  p.lastz_out[lane] = last_z;
}

template <typename T>
__device__ Scalars load_scalars(const LaneParams<T>& p, T& last_z) {
  const long long lane = blockIdx.x;
  Scalars s;
  s.phase = p.phase_in[lane * p.st_phase];
  s.status = p.status_in[lane * p.st_status];
  s.niter = p.niter_in[lane * p.st_niter];
  s.stuck = p.stuck_in[lane * p.st_stuck];
  s.bland = p.bland_in[lane * p.st_bland] != 0;
  last_z = p.lastz_in[lane * p.st_lastz];
  return s;
}

// ---------------------------------------------------------------------------
// the lane kernels' shared machinery: one barrier a decision
// ---------------------------------------------------------------------------

constexpr int LANE_MAX_WARPS = LANE_MAX_THREADS / 32;
// the stages that ``cycles`` splits a launch into (block 0's clock; summed
// over the steps), then the block barriers block 0 passed: the load; a
// step's price pass and its reduction (with the pending step's finish);
// the clean-up pass, the ratio test and the ties; the update; the store
enum WalkStage { S_LOAD, S_PRICE, S_RATIO, S_UPDATE, S_STORE, S_BARRIERS, S_NSTAGES };

// The block's barrier: a warp's where the block is one warp (its threads
// then need no block barrier, only the warp's memory order).
__device__ __forceinline__ void block_sync() {
  if (blockDim.x <= 32)
    __syncwarp();
  else
    __syncthreads();
}

// The row pitch of a resident frame's n columns: n rounded up to an odd
// number, so that a warp reading a column (a thread a row) meets every
// bank once.
__host__ __device__ __forceinline__ int walk_pitch(int N) { return (N - 1) | 1; }

// The dynamic shared memory of a primal or bounded lane (kernels/lanes.py's
// lane_plan and lane_bounded_plan count the same bytes), each segment
// 16-byte aligned: [the frame's n columns at walk_pitch (RESIDENT)], the
// RHS twice (a step reads one and writes the other), the pivot's column,
// the basis twice, the active and the artificial masks; a bounded lane's
// then the spans and the devex weights (n of T each), the at-upper flags
// (n bytes) and two columns of M (basis[0]'s and the flip's, snapshotted
// where a basic column is not a unit vector).
template <typename T>
__host__ __device__ __forceinline__ long long walk_smem_bytes(int M, int N, bool resident,
                                                             bool bounded) {
  const long long m = M - 2, n = N - 1, es = sizeof(T);
  long long bytes = 3 * align16(M * es) + 2 * align16(4 * m) + 2 * align16(n);
  if (bounded) bytes += 2 * align16(n * es) + align16(n) + 2 * align16(M * es);
  if (resident) bytes += align16((long long)M * walk_pitch(N) * es);
  return bytes;
}

template <typename T>
struct Walk {
  T* tab;     // the frame's n columns: shared memory (RESIDENT) or the output
              // in device memory (its column N - 1 written at the end)
  int pitch;  // the frame's row pitch in elements
  T* rhs[2];
  T* colv;
  int* basis[2];
  unsigned char* act;
  unsigned char* art;
  T* upper;  // bounded only
  T* gamma;
  unsigned char* at;
  T* colb;
  T* colf;
};

template <typename T, bool RESIDENT>
__device__ Walk<T> walk_layout(const LaneParams<T>& p, unsigned char* dyn, bool bounded) {
  Walk<T> L;
  const long long M = p.M, m = p.M - 2, n = p.N - 1, es = sizeof(T);
  long long off = 0;
  if (RESIDENT) {
    L.tab = (T*)dyn;
    L.pitch = walk_pitch(p.N);
    off = align16(M * L.pitch * es);
  } else {
    L.tab = p.T_out + (long long)blockIdx.x * M * p.N;
    L.pitch = p.N;
  }
  for (int q = 0; q < 2; ++q) {
    L.rhs[q] = (T*)(dyn + off);
    off += align16(M * es);
  }
  L.colv = (T*)(dyn + off);
  off += align16(M * es);
  for (int q = 0; q < 2; ++q) {
    L.basis[q] = (int*)(dyn + off);
    off += align16(4 * m);
  }
  L.act = dyn + off;
  off += align16(n);
  L.art = dyn + off;
  off += align16(n);
  L.upper = L.gamma = L.colb = L.colf = nullptr;
  L.at = nullptr;
  if (bounded) {
    L.upper = (T*)(dyn + off);
    off += align16(n * es);
    L.gamma = (T*)(dyn + off);
    off += align16(n * es);
    L.at = dyn + off;
    off += align16(n);
    L.colb = (T*)(dyn + off);
    off += align16(M * es);
    L.colf = (T*)(dyn + off);
  }
  return L;
}

// The rows a warp of load_walk has in flight: their loads are issued before
// any of their stores, so that a lane's load waits on device memory's
// latency a few times, not once a row.
constexpr int LOAD_ROWS = 8;

// The lane's frame (a warp a row: its n columns, and column N - 1 into the
// first RHS; LOAD_ROWS rows at a time), basis and masks from the inputs;
// the caller's barrier follows.
template <typename T>
__device__ void load_walk(const LaneParams<T>& p, const Walk<T>& L) {
  const long long lane = blockIdx.x;
  const int M = p.M, N = p.N, m = M - 2, n = N - 1;
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const T* src = p.T_in + lane * p.st_T;
  for (int i0 = warp; i0 < M; i0 += LOAD_ROWS * nw) {
    for (int k = ln; k < N; k += 32) {
      T v[LOAD_ROWS];
#pragma unroll
      for (int u = 0; u < LOAD_ROWS; ++u) {
        const int i = i0 + u * nw;
        v[u] = i < M ? src[(long long)i * N + k] : T(0);
      }
#pragma unroll
      for (int u = 0; u < LOAD_ROWS; ++u) {
        const int i = i0 + u * nw;
        if (i >= M) break;
        if (k < n)
          L.tab[(long long)i * L.pitch + k] = v[u];
        else
          L.rhs[0][i] = v[u];
      }
    }
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) L.basis[0][i] = p.basis_in[lane * p.st_basis + i];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    L.act[k] = p.act_in[lane * p.st_act + k] != 0;
    L.art[k] = p.art_in[lane * p.st_art + k] != 0;
  }
}

// The frame (RESIDENT: all of it; else its RHS column), the basis and the
// masks back to the outputs (the masks a thread its columns, as it owns
// them in the steps).
template <typename T, bool RESIDENT>
__device__ void store_walk(const LaneParams<T>& p, const Walk<T>& L, int cur) {
  const long long lane = blockIdx.x;
  const int M = p.M, N = p.N, m = M - 2, n = N - 1;
  const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  T* dst = p.T_out + lane * M * N;
  for (int i = warp; i < M; i += nw) {
    if (RESIDENT) {
      const T* row = L.tab + (long long)i * L.pitch;
      for (int k = ln; k < n; k += 32) dst[(long long)i * N + k] = row[k];
    }
    if (ln == 0) dst[(long long)i * N + N - 1] = L.rhs[cur][i];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) p.basis_out[lane * m + i] = L.basis[cur][i];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    p.act_out[lane * n + k] = L.act[k];
    p.art_out[lane * n + k] = L.art[k];
  }
}

// Block 0's clock by WalkStage when the caller asks for it (thread 0 adds
// the cycles since its last lap to the stage) and the barriers it passed.
struct WalkClock {
  bool on;
  long long last;
  long long cyc[S_NSTAGES];
};

__device__ __forceinline__ void walk_lap(WalkClock* t, int stage) {
  if (!t->on || threadIdx.x != 0) return;
  const long long now = clock64();
  t->cyc[stage] += now - t->last;
  t->last = now;
}

__device__ __forceinline__ void walk_bar(WalkClock* t) {
  if (t->on && threadIdx.x == 0) t->cyc[S_BARRIERS] += 1;
}

// A thread's share of a step's first reduction (and the block's result):
// the pick (v1, i1) and, under devex, the pick under unit weights (v2,
// i2); the first improving column (a); the pricing row's |c| sum over the
// active columns (sc); beside them the previous update's partials: the
// first row whose basic column is artificial (r), the |b| sum (sb), the
// devex weights' NaN-first maximum (g) and the first non-finite entry of
// row 2 (f, n for its RHS).
template <typename T>
struct StepRed {
  T v1, v2, g, sc, sb;
  int i1, i2;
  unsigned a, r, f;
  unsigned big;  // a |c| term (1) or a |b| term (2) not below sum_safe
};

template <typename T>
struct StepKeys {
  typename KeyOf<T>::type k1, k2, kg;
  unsigned i1, i2, a, r, f, big;
  T sc, sb;
};

// The sums feed finiteness checks only. Below this bound every term keeps
// a sum of at most 2^24 of them finite in any order, so block_reduce's sum
// is finite; a term at or above it (or not finite) makes the block take
// the sum in block_reduce's tree, behind a second barrier.
template <typename T> __device__ __forceinline__ T sum_safe();
template <> __device__ __forceinline__ float sum_safe<float>() { return FLT_MAX / 1073741824.0f; }
template <> __device__ __forceinline__ double sum_safe<double>() { return DBL_MAX / 1073741824.0; }

template <typename T>
__device__ __forceinline__ T add_term(T s, T v, unsigned& big, unsigned bit) {
  const T a = T(fabs(v));
  if (!(a < sum_safe<T>())) big |= bit;
  return add_rn(s, a);
}

template <typename T>
__device__ __forceinline__ StepRed<T> step_identity(bool mx) {
  StepRed<T> x;
  x.v1 = x.v2 = mx ? -pos_inf<T>() : pos_inf<T>();
  x.i1 = x.i2 = BIG_I;
  x.g = -pos_inf<T>();
  x.sc = x.sb = T(0);
  x.a = x.r = x.f = NO_IDX;
  x.big = 0;
  return x;
}

// torch's argmin (mx false) / argmax (mx true) as offer takes it
template <typename T>
__device__ __forceinline__ void pick_vi(T& v, int& i, T yv, int yi, bool mx) {
  const bool xn = is_nan(v), yn = is_nan(yv);
  const bool take = (xn || yn) ? yn && (!xn || yi < i) : (mx ? yv > v : yv < v) || (yv == v && yi < i);
  if (take) {
    v = yv;
    i = yi;
  }
}

// The block's StepRed, to every thread, by keys (common.cuh's okey and
// warp_arg) behind one barrier. sh (a slot a warp) is this call site's
// own. BOUNDED adds the second pick (under devex only), the weights'
// maximum and row 2's flag. A block of one warp has its result after the
// warp's own reductions. The sums: 0 where every term was below sum_safe
// (then block_reduce's sums are finite), else block_reduce's (the warp's
// tree, then the same over the warps' sums padded to 32).
template <typename T, bool BOUNDED>
__device__ StepRed<T> step_reduce(const StepRed<T>& x, bool mx, bool devex, StepKeys<T>* sh) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  K k1 = okey(x.v1, mx), k2 = 0, kg = 0;
  unsigned i1 = (unsigned)x.i1, i2 = NO_IDX, ig = 0, f = NO_IDX;
  warp_arg(k1, i1, mx);
  if (BOUNDED) {
    if (devex) {
      k2 = okey(x.v2, mx);
      i2 = (unsigned)x.i2;
      warp_arg(k2, i2, mx);
    }
    kg = okey(x.g, true);
    warp_arg(kg, ig, true);
    f = __reduce_min_sync(FULL, x.f);
  }
  unsigned a = __reduce_min_sync(FULL, x.a), r = __reduce_min_sync(FULL, x.r),
           big = __reduce_or_sync(FULL, x.big);
  if (nw > 1) {
    if (lane == 0) {
      StepKeys<T>& s = sh[warp];
      s.k1 = k1;
      s.k2 = k2;
      s.kg = kg;
      s.i1 = i1;
      s.i2 = i2;
      s.a = a;
      s.r = r;
      s.f = f;
      s.big = big;
    }
    __syncthreads();
    const bool in = lane < nw;
    const K lose = mx ? K(0) : ~K(0);
    k1 = in ? sh[lane].k1 : lose;
    i1 = in ? sh[lane].i1 : NO_IDX;
    warp_arg(k1, i1, mx);
    if (BOUNDED) {
      if (devex) {
        k2 = in ? sh[lane].k2 : lose;
        i2 = in ? sh[lane].i2 : NO_IDX;
        warp_arg(k2, i2, mx);
      }
      kg = in ? sh[lane].kg : K(0);
      ig = 0;
      warp_arg(kg, ig, true);
      f = __reduce_min_sync(FULL, in ? sh[lane].f : NO_IDX);
    }
    a = __reduce_min_sync(FULL, in ? sh[lane].a : NO_IDX);
    r = __reduce_min_sync(FULL, in ? sh[lane].r : NO_IDX);
    big = __reduce_or_sync(FULL, in ? sh[lane].big : 0u);
  } else {
    __syncwarp();
  }
  StepRed<T> out;
  out.sc = out.sb = T(0);
  if (big) {
    // a term near the overflow or not finite: the sums in block_reduce's
    // tree (the block's flag is the same in every thread)
    T sc = warp_tree_sum(x.sc), sb = warp_tree_sum(x.sb);
    if (nw > 1) {
      if (lane == 0) {
        sh[warp].sc = sc;
        sh[warp].sb = sb;
      }
      __syncthreads();
      const bool in = lane < nw;
      sc = warp_tree_sum(in ? sh[lane].sc : T(0));
      sb = warp_tree_sum(in ? sh[lane].sb : T(0));
    } else {
      // block_reduce's second level over one warp's sum: s + 0 + ... + 0
      sc = add_rn(sc, T(0));
      sb = add_rn(sb, T(0));
    }
    out.sc = __shfl_sync(FULL, sc, 0);
    out.sb = __shfl_sync(FULL, sb, 0);
  }
  out.v1 = key_value(k1, mx);
  out.i1 = (int)i1;
  out.v2 = BOUNDED && devex ? key_value(k2, mx) : out.v1;
  out.i2 = BOUNDED && devex ? (int)i2 : out.i1;
  out.g = BOUNDED ? key_value(kg, true) : -pos_inf<T>();
  out.a = a;
  out.r = r;
  out.f = f;
  out.big = big;
  return out;
}

// One NaN-first argmin / argmax pick (PICK) and one first index u over the
// block by keys, to every thread; one barrier (none on one warp), sh this
// call site's own.
template <typename T, bool PICK>
__device__ void pick_reduce(T& v, int& i, bool mx, unsigned& u, KeyRed<T>* sh) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  K k = 0;
  unsigned j = NO_IDX;
  if (PICK) {
    k = okey(v, mx);
    j = (unsigned)i;
    warp_arg(k, j, mx);
  }
  u = __reduce_min_sync(FULL, u);
  if (nw > 1) {
    if (lane == 0) {
      sh[warp].k1 = k;
      sh[warp].i1 = j;
      sh[warp].u1 = u;
    }
    __syncthreads();
    const bool in = lane < nw;
    if (PICK) {
      k = in ? sh[lane].k1 : (mx ? K(0) : ~K(0));
      j = in ? sh[lane].i1 : NO_IDX;
      warp_arg(k, j, mx);
    }
    u = __reduce_min_sync(FULL, in ? sh[lane].u1 : NO_IDX);
  } else {
    __syncwarp();
  }
  if (PICK) {
    v = key_value(k, mx);
    i = (int)j;
  }
}

// Two NaN-first argmins and a first index over the block by keys, to every
// thread: key_pick2 with a flag (u) beside it; one barrier (none on one
// warp).
template <typename T>
__device__ void pick2_flag(T& v1, int& i1, T& v2, int& i2, unsigned& u, KeyRed<T>* sh) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  K k1 = okey(v1, false), k2 = okey(v2, false);
  unsigned j1 = (unsigned)i1, j2 = (unsigned)i2;
  warp_arg(k1, j1, false);
  warp_arg(k2, j2, false);
  u = __reduce_min_sync(FULL, u);
  if (nw > 1) {
    if (lane == 0) {
      sh[warp].k1 = k1;
      sh[warp].k2 = k2;
      sh[warp].i1 = j1;
      sh[warp].i2 = j2;
      sh[warp].u1 = u;
    }
    __syncthreads();
    const bool in = lane < nw;
    k1 = in ? sh[lane].k1 : ~K(0);
    k2 = in ? sh[lane].k2 : ~K(0);
    j1 = in ? sh[lane].i1 : NO_IDX;
    j2 = in ? sh[lane].i2 : NO_IDX;
    warp_arg(k1, j1, false);
    warp_arg(k2, j2, false);
    u = __reduce_min_sync(FULL, in ? sh[lane].u1 : NO_IDX);
  } else {
    __syncwarp();
  }
  v1 = key_value(k1, false);
  v2 = key_value(k2, false);
  i1 = (int)j1;
  i2 = (int)j2;
}

__device__ __forceinline__ bool block_or(bool v) {
  if (blockDim.x <= 32) return __any_sync(FULL, v);
  return __syncthreads_or(v) != 0;
}

// The row slices of a column: where the block's threads cover the
// frame's n columns twice, a column's rows split over two lanes of one
// warp, lanes l and l + 16 (so that each half-warp still reads 16
// consecutive columns of a row: one f64 wavefront, no bank conflict). A
// thread takes column slot s (its warp's 16 or 32 slots) and rows rs, rs +
// R, ...; the slot's columns are k = s, s + slots, ... and its first lane
// owns their masks, spans and weights.
struct Slices {
  int R, slot, slots, rs;
  unsigned mask;  // the slot's lanes
};

__device__ __forceinline__ Slices row_slices(int n) {
  Slices s;
  const int nt = blockDim.x, ln = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s.R = nt / 2 >= n ? 2 : 1;
  const int per = 32 / s.R;  // a warp's slots
  s.slot = warp * per + ln % per;
  s.slots = nt / s.R;
  s.rs = ln / per;
  s.mask = s.R == 2 ? (1u << (ln % per)) | (1u << (ln % per + per)) : 1u << ln;
  return s;
}

// Column k of the frame (entries col[i * P]) after the pivot on row rg,
// rows rs, rs + R, ... of it: row rg set to pk (its entry times 1 / pivot,
// which every lane of the column read first), the others fma(-cp[i * cs],
// pk, T[i, k]) with cp the pivot's pre-step column at stride cs (null:
// e_2, the unit vector of a redirected pivot on a unit column); eight rows
// at a time, their loads issued before any store.
template <typename T, int R>
__device__ __forceinline__ void pivot_rows(T* __restrict__ col, int P, int M, int rg, T pk,
                                           const T* __restrict__ cp, int cs, int rs) {
  constexpr int U = 8;
  int i = rs;
  for (; i + (U - 1) * R < M; i += U * R) {
    T v[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = i + u * R;
      v[u] = col[(long long)r * P];
      c[u] = cp ? cp[(long long)r * cs] : T(r == 2);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = i + u * R == rg ? pk : fma(-c[u], pk, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) col[(long long)(i + u * R) * P] = v[u];
  }
  for (; i < M; i += R) {
    T* e = col + (long long)i * P;
    const T c = cp ? cp[(long long)i * cs] : T(i == 2);
    *e = i == rg ? pk : fma(-c, pk, *e);
  }
}

template <typename T>
__device__ __forceinline__ void pivot_column(T* col, int P, int M, int rg, T pk, const T* cp,
                                             const Slices& sl, int cs = 1) {
  if (sl.R == 2)
    pivot_rows<T, 2>(col, P, M, rg, pk, cp, cs, sl.rs);
  else
    pivot_rows<T, 1>(col, P, M, rg, pk, cp, cs, 0);
}

// The first column eligible for the clean-up's pivot on row r_d (active,
// not artificial, |T[r_d + 2, k]| > piv_tol), NO_IDX if none; one
// reduction (sh this call site's own).
template <typename T>
__device__ unsigned cleanup_column(const Walk<T>& L, int r_d, int n, T piv_tol, KeyRed<T>* sh) {
  const T* rowd = L.tab + (long long)(r_d + 2) * L.pitch;
  unsigned e = NO_IDX;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    if (L.act[k] && !L.art[k] && T(fabs(rowd[k])) > piv_tol) e = min(e, (unsigned)k);
  T ev = T(0);
  int ei = 0;
  pick_reduce<T, false>(ev, ei, false, e, sh);
  return e;
}

// This thread's rows' partials of the loaded state (the first RHS and
// basis): the |b| sum and its flag, the first row whose basic column is
// artificial.
template <typename T>
__device__ void row_partials(const Walk<T>& L, int M, T& sb, unsigned& sbig, unsigned& ra) {
  for (int g = threadIdx.x; g < M; g += blockDim.x) {
    if (g < 2) continue;
    sb = add_term(sb, L.rhs[0][g], sbig, 2u);
    if (L.art[L.basis[0][g - 2]]) ra = min(ra, (unsigned)(g - 2));
  }
}

// The pending step: decided and updated, its objective, stall counter and
// status waiting for the next reduction (the post-step |b| sum).
struct Pending {
  bool on, stall, infeasible, unbounded, optimal, crow_ok;
  int zrow;
};

// The pending step's finish (solve/driver.py::simplex_step's and
// solve/bounded.py::bounded_simplex_step's last lines): the stall counter
// and the Bland switch against its objective z (the RHS of row zrow after
// it), then its status from the |b| sum sb after it.
template <typename T>
__device__ __forceinline__ void finish_pending(Pending& pd, Scalars& s, T& last_z, T z, T sb,
                                               const LaneParams<T>& p) {
  if (pd.stall) {
    s.stuck = sub_rn(last_z, z) > p.degen_tol ? 0 : s.stuck + 1;
    last_z = z;
    s.bland = s.bland || s.stuck >= p.stall_limit;
  }
  const bool finite_ok = finite_val(z) && finite_val(sb) && pd.crow_ok;
  s.status = !finite_ok ? ST_NUMERIC
             : pd.infeasible ? ST_INFEASIBLE
             : pd.unbounded ? ST_UNBOUNDED
             : pd.optimal ? ST_OPTIMAL
                          : ST_RUNNING;
  pd.on = false;
}

// The step's end that needs no reduction: the pivot count, the Bland
// switch of a step that does not price-pivot (its counter unchanged), the
// phase change; the rest pends.
__device__ __forceinline__ void end_step(Pending& pd, Scalars& s, bool act, bool stall,
                                         bool to_phase2, int stall_limit) {
  s.niter += act;
  pd.stall = stall;
  if (!stall) s.bland = s.bland || s.stuck >= stall_limit;
  if (to_phase2) {
    s.phase = 2;
    s.stuck = 0;
  }
  pd.on = true;
}

// ---------------------------------------------------------------------------
// the dual simplex (solve/dual.py::dual_simplex_step)
// ---------------------------------------------------------------------------

// The frame (RESIDENT: its n columns; always its RHS) and the basis back to
// the outputs, each entry by the thread that last wrote it in the steps:
// a column's rows by its slot's lanes, a row's RHS and basis entry by the
// row's thread (what no step wrote, load_walk wrote before its barrier),
// so that no barrier goes before it. The masks are the input's.
template <typename T, bool RESIDENT>
__device__ void store_owned(const LaneParams<T>& p, const Walk<T>& L, int cur, const Slices& sl) {
  const long long lane = blockIdx.x;
  const int M = p.M, N = p.N, n = N - 1;
  T* dst = p.T_out + lane * M * N;
  if (RESIDENT)
    for (int k = sl.slot; k < n; k += sl.slots)
      for (int i = sl.rs; i < M; i += sl.R)
        dst[(long long)i * N + k] = L.tab[(long long)i * L.pitch + k];
  for (int g = threadIdx.x; g < M; g += blockDim.x) {
    dst[(long long)g * N + N - 1] = L.rhs[cur][g];
    if (g >= 2) p.basis_out[lane * (M - 2) + g - 2] = L.basis[0][g - 2];
  }
}

// This thread's rows' partials of the row decision over b = rhs[2:]: the
// NaN-first argmin (v1, i1), the first row below -feas_tol (a) and the |b|
// sum (sb).
template <typename T>
__device__ __forceinline__ void dual_row_offer(StepRed<T>& x, T b, int i, T feas_tol) {
  pick_vi(x.v1, x.i1, b, i, false);
  if (b < -feas_tol) x.a = min(x.a, (unsigned)i);
  x.sb = add_term(x.sb, b, x.big, 2u);
}

// A step of lane_dual_kernel: ONE reduction of the leaving row's decision
// (the argmin of b, the first row below -feas_tol, the |b| sum) that also
// takes the objective row's |c| sum over the active columns; the pending
// step's finish (its stall counter and status against the objective and
// the |b| sum after it); the dual ratio test over row r + 2 (each column by
// the slot's first lane) and ONE reduction (the argmin ratio, the first
// eligible column); then the update with no barrier before it: each thread
// pivots its own columns (reading its pivot-row entry before it writes,
// and column j where it stands: its owner leaves it until the next
// reduction, then sets it to the unit vector), adding the new objective
// row's |c| to the next reduction, and the thread of row i writes the new
// b_i into the other RHS buffer and offers it to the next step's row
// decision. A dual step passes two block barriers, the step that ends the
// lane one (optimal) or two (infeasible), and the store none (each thread
// stores what it wrote: store_owned).
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(LANE_MAX_THREADS) lane_dual_kernel(LaneParams<T> p) {
  __shared__ StepKeys<T> sh_rows[LANE_MAX_WARPS];
  __shared__ KeyRed<T> sh_cols[LANE_MAX_WARPS];
  __shared__ WalkClock clk;
  extern __shared__ __align__(16) unsigned char lane_dyn[];
  const Walk<T> L = walk_layout<T, RESIDENT>(p, lane_dyn, false);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int M = p.M, n = p.N - 1, P = L.pitch;
  const T inf = pos_inf<T>();
  const Slices sl = row_slices(n);
  if (tid == 0) {
    clk.on = p.cycles != nullptr && blockIdx.x == 0;
    clk.last = clock64();
    for (int k = 0; k < S_NSTAGES; ++k) clk.cyc[k] = 0;
  }
  load_walk(p, L);
  T last_z;
  Scalars s = load_scalars(p, last_z);
  block_sync();
  walk_lap(&clk, S_LOAD);
  int cur = 0;
  // this thread's partials of the loaded state: its rows' b, its columns'
  // |c| over the active ones
  StepRed<T> x = step_identity<T>(false);
  for (int g = tid; g < M; g += nt)
    if (g >= 2) dual_row_offer(x, L.rhs[0][g], g - 2, p.feas_tol);
  for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots)
    if (L.act[k]) x.sc = add_term(x.sc, L.tab[k], x.big, 1u);
  // the pending step (a pivot): its pre-step |c| sum's finiteness; the
  // column its owner sets to the unit vector e_prg after the next
  // reduction (none: -1)
  bool pending = false, crow_ok = true;
  int pj = -1, prg = 0;
  while (pending || (s.status == ST_RUNNING && s.niter < p.max_iters)) {
    // ---- the leaving row's decision and the |c| sum; one reduction ----
    const StepRed<T> R = step_reduce<T, false>(x, false, false, sh_rows);
    walk_bar(&clk);
    if (pj >= 0 && pj % sl.slots == sl.slot) {
      T* col = L.tab + pj;
      for (int i = sl.rs; i < M; i += sl.R) col[(long long)i * P] = T(i == prg);
    }
    pj = -1;
    __syncwarp();  // the slot's rows, from its other lanes
    const T z = -L.rhs[cur][0];
    if (pending) {
      // the pivot step's finish: stall detection against the dual
      // objective, NUMERIC on a non-finite z, |b| sum or pre-step |c| sum
      s.stuck = sub_rn(z, last_z) > p.degen_tol ? 0 : s.stuck + 1;
      last_z = z;
      s.bland = s.bland || s.stuck >= p.stall_limit;
      if (!(finite_val(z) && finite_val(R.sb) && crow_ok)) s.status = ST_NUMERIC;
      pending = false;
      if (!(s.status == ST_RUNNING && s.niter < p.max_iters)) break;
    }
    walk_lap(&clk, S_PRICE);
    // a step that does not pivot ends the lane: its state is the pre-step
    // one, so its sums are this reduction's
    const bool finite_ok = finite_val(z) && finite_val(R.sb) && finite_val(R.sc);
    const bool feasible = R.a == NO_IDX;
    if (feasible) {
      s.bland = s.bland || s.stuck >= p.stall_limit;
      s.status = finite_ok ? ST_OPTIMAL : ST_NUMERIC;
      break;
    }
    // leaving row: the most negative b; the first negative under Bland
    const int r = s.bland ? (int)R.a : R.i1;

    // ---- the entering column: the dual ratio crow / -row over the active
    // row < -piv_tol, ties to the first index; one reduction ----
    T cv = inf;
    int ci = BIG_I;
    unsigned first = NO_IDX;
    const T* rrow = L.tab + (long long)(r + 2) * P;
    for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) {
      const T a = rrow[k];
      if (L.act[k] && a < -p.piv_tol) {
        first = min(first, (unsigned)k);
        pick_vi(cv, ci, div_rn(L.tab[k], -a), k, false);
      }
    }
    pick_reduce<T, true>(cv, ci, false, first, sh_cols);
    walk_bar(&clk);
    walk_lap(&clk, S_RATIO);
    if (first == NO_IDX) {
      s.bland = s.bland || s.stuck >= p.stall_limit;
      s.status = finite_ok ? ST_INFEASIBLE : ST_NUMERIC;
      break;
    }
    // a NaN minimum leaves no tie (argmax -> 0)
    const int j = is_nan(cv) ? 0 : ci;

    // ---- the pivot (driver.pivot_update): no barrier before it ----
    const int rg = r + 2, nx = cur ^ 1;
    const T* colj = L.tab + j;  // column j at stride P, untouched this step
    const T rinv = div_rn(T(1), colj[(long long)rg * P]);
    x = step_identity<T>(false);
    for (int k = sl.slot; k < n; k += sl.slots) {
      if (k == j) continue;
      T* col = L.tab + k;
      const T pk = mul_rn(col[(long long)rg * P], rinv);
      __syncwarp(sl.mask);  // every lane of the slot has read row rg
      pivot_column(col, P, M, rg, pk, colj, sl, P);
      if (sl.rs == 0 && L.act[k]) x.sc = add_term(x.sc, col[0], x.big, 1u);
    }
    const T prhs = mul_rn(L.rhs[cur][rg], rinv);
    for (int g = tid; g < M; g += nt) {
      const T b = g == rg ? prhs : fma(-colj[(long long)g * P], prhs, L.rhs[cur][g]);
      L.rhs[nx][g] = b;
      if (g >= 2) dual_row_offer(x, b, g - 2, p.feas_tol);
      if (g == rg) L.basis[0][r] = j;  // one basis buffer: no step reads it
    }
    cur = nx;
    pj = j;
    prg = rg;
    crow_ok = finite_val(R.sc);
    s.niter += 1;
    pending = true;
    walk_lap(&clk, S_UPDATE);
  }
  walk_lap(&clk, S_PRICE);
  store_owned<T, RESIDENT>(p, L, cur, sl);
  store_scalars(p, s, last_z);
  if (clk.on && tid == 0) {
    walk_lap(&clk, S_STORE);
    for (int k = 0; k < S_NSTAGES; ++k) p.cycles[k] += clk.cyc[k];
  }
}

// ---------------------------------------------------------------------------
// the rank-1 primal simplex (solve/driver.py::simplex_step)
// ---------------------------------------------------------------------------

// A step of lane_primal_kernel: the price pass (a thread its columns: k =
// t, t + T, ...; the columns' masks are its own), then ONE reduction that
// also takes the previous update's row partials; the pending step's
// finish; the ratio test over column j (a thread its rows: g = t, t + T,
// ..., which snapshot column j) and one reduction (a second for Bland's or
// the largest pivot's ties); then the update with no barrier before it:
// each thread pivots its own columns (it reads its pivot-row entry before
// it writes the column), and its rows' RHS into the other RHS buffer with
// their basis entries, adding |b| and the first artificial row for the
// next reduction. A Dantzig step passes two barriers; the clean-up adds
// two, a retire one, and a step that takes neither the ratio test nor the
// clean-up one (so that no warp rewrites the first reduction's scratch
// while another still reads it).
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(LANE_MAX_THREADS) lane_primal_kernel(LaneParams<T> p) {
  __shared__ StepKeys<T> sh_step[LANE_MAX_WARPS];
  __shared__ KeyRed<T> sh_ratio[LANE_MAX_WARPS], sh_tie[LANE_MAX_WARPS], sh_clean[LANE_MAX_WARPS];
  __shared__ WalkClock clk;
  extern __shared__ __align__(16) unsigned char lane_dyn[];
  const Walk<T> L = walk_layout<T, RESIDENT>(p, lane_dyn, false);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int M = p.M, N = p.N, m = M - 2, n = N - 1, P = L.pitch;
  const T inf = pos_inf<T>();
  const bool max_inc = p.rule == RULE_MAX_INCREASE_;
  const bool max_piv = p.tie != 0;
  const Slices sl = row_slices(n);
  if (tid == 0) {
    clk.on = p.cycles != nullptr && blockIdx.x == 0;
    clk.last = clock64();
    for (int k = 0; k < S_NSTAGES; ++k) clk.cyc[k] = 0;
  }
  load_walk(p, L);
  T last_z;
  Scalars s = load_scalars(p, last_z);
  block_sync();
  walk_lap(&clk, S_LOAD);
  int cur = 0;
  // this thread's rows' partials of the current state: the |b| sum, the
  // first row whose basic column is artificial
  T sb = T(0);
  unsigned sbig = 0, ra = NO_IDX;
  row_partials(L, M, sb, sbig, ra);
  Pending pd = {false, false, false, false, false, true, 0};
  while (pd.on || (s.status == ST_RUNNING && s.niter < p.max_iters)) {
    // the greatest increase's column pass reads the rows' RHS
    if (max_inc) {
      block_sync();
      walk_bar(&clk);
    }
    // ---- the price pass over the own columns; one reduction ----
    StepRed<T> x = step_identity<T>(max_inc);
    x.sb = sb;
    x.big = sbig;
    x.r = ra;
    const T* crow = L.tab + (s.phase == 1 ? P : 0);
    __syncwarp();  // the slot's rows, from its other lanes
    for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) {
      const bool act = L.act[k];
      const T c = crow[k];
      const T c_eff = act ? c : inf;
      const bool improving = c_eff < -p.opt_tol;
      if (improving) x.a = min(x.a, (unsigned)k);
      if (act) x.sc = add_term(x.sc, c, x.big, 1u);
      if (max_inc) {
        // the column's minimum ratio (NaN-propagating, as torch's min)
        T ratio = inf;
        const T* col = L.tab + k;
        for (int i = 2; i < M; ++i) {
          const T a = col[(long long)i * P];
          const T q = a > p.piv_tol ? div_rn(L.rhs[cur][i], a) : inf;
          if (!is_nan(ratio) && (is_nan(q) || q < ratio)) ratio = q;
        }
        pick_vi(x.v1, x.i1, improving ? (ratio < inf ? mul_rn(-c_eff, ratio) : inf) : -inf, k, true);
      } else {
        pick_vi(x.v1, x.i1, c_eff, k, false);
      }
    }
    const StepRed<T> R = step_reduce<T, false>(x, max_inc, false, sh_step);
    walk_bar(&clk);
    if (pd.on) {
      finish_pending(pd, s, last_z, -L.rhs[cur][pd.zrow], R.sb, p);
      if (!(s.status == ST_RUNNING && s.niter < p.max_iters)) break;
    }
    walk_lap(&clk, S_PRICE);

    // ---- the decisions ----
    const bool in_phase2 = s.phase == 2;
    const bool cleanup = R.r != NO_IDX && in_phase2;
    const int r_d = R.r != NO_IDX ? (int)R.r : 0;
    const bool has_improving = R.a != NO_IDX;
    const bool use_bland = s.bland || p.rule == RULE_BLAND_;
    const int j_price = use_bland ? (has_improving ? (int)R.a : n - 1) : R.i1;
    // the clean-up's first eligible column: a pass over the own columns of
    // row r_d
    bool has_elig = false;
    int j_d = n - 1;
    if (cleanup) {
      const unsigned e = cleanup_column(L, r_d, n, p.piv_tol, sh_clean);
      walk_bar(&clk);
      has_elig = e != NO_IDX;
      if (has_elig) j_d = (int)e;
    }
    const bool retire = cleanup && !has_elig;
    const bool phase1_done = s.phase == 1 && !has_improving;
    const bool became_infeasible = phase1_done && -L.rhs[cur][1] > p.infeas_tol;
    const bool to_phase2 = phase1_done && !became_infeasible;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const int j = cleanup ? j_d : j_price;

    // ---- the ratio test over column j (driver.ratio_rows), its rows'
    // snapshot of the column ----
    bool has_ratio = false;
    int r_price = 0;
    if (pricing_pivot) {
      // (each row's ratio kept in the other RHS buffer for the ties: the
      // update overwrites it from the same thread)
      T* qs = L.rhs[cur ^ 1];
      T qv = inf;
      int qi = BIG_I;
      unsigned first_pos = NO_IDX;
      for (int g = tid; g < M; g += nt) {
        const T c = L.tab[(long long)g * P + j];
        L.colv[g] = c;
        if (g < 2) continue;
        const bool pos = c > p.piv_tol;
        if (pos) first_pos = min(first_pos, (unsigned)(g - 2));
        const T q = pos ? div_rn(L.rhs[cur][g], c) : inf;
        qs[g] = q;
        pick_vi(qv, qi, q, g - 2, false);
      }
      pick_reduce<T, true>(qv, qi, false, first_pos, sh_ratio);
      walk_bar(&clk);
      has_ratio = first_pos != NO_IDX;
      const bool nan_min = is_nan(qv);
      if (!use_bland && !max_piv) {
        r_price = nan_min ? 0 : qi;
      } else {
        // the tie set {ratio <= min}: Bland's smallest basic index, or the
        // largest pivot element
        T tv = use_bland ? inf : -inf;
        int ti = BIG_I;
        unsigned none = NO_IDX;
        for (int g = tid; g < M; g += nt) {
          if (g < 2) continue;
          const T c = L.colv[g];
          const bool tie = !nan_min && qs[g] <= qv;
          if (use_bland)
            pick_vi(tv, ti, tie ? T(L.basis[cur][g - 2]) : T(BIG_I), g - 2, false);
          else
            pick_vi(tv, ti, tie ? c : -inf, g - 2, true);
        }
        pick_reduce<T, true>(tv, ti, !use_bland, none, sh_tie);
        walk_bar(&clk);
        r_price = ti;
      }
    }
    const bool became_unbounded = pricing_pivot && !has_ratio && in_phase2;
    const bool became_failed1 = pricing_pivot && !has_ratio && !in_phase2;
    const bool do_cleanup = cleanup && has_elig;
    const bool do_pricing = pricing_pivot && has_ratio;
    const bool do_pivot = do_cleanup || do_pricing;
    const int r = do_cleanup ? r_d : r_price;

    // the retire and the phase change write the masks (never in one step:
    // a retire needs phase 2, the phase change phase 1); the clean-up's
    // pivot snapshots its column
    if (retire) {
      if (tid == 0) L.art[L.basis[cur][r_d]] = 0;
      block_sync();
      walk_bar(&clk);
      ra = NO_IDX;
      for (int g = tid; g < M; g += nt)
        if (g >= 2 && L.art[L.basis[cur][g - 2]]) ra = min(ra, (unsigned)(g - 2));
    }
    if (to_phase2)
      for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) L.act[k] = L.act[k] && !L.art[k];
    if (do_cleanup) {
      for (int g = tid; g < M; g += nt) L.colv[g] = L.tab[(long long)g * P + j];
      block_sync();
      walk_bar(&clk);
    }
    if (!pricing_pivot && !cleanup) {
      block_sync();
      walk_bar(&clk);
    }
    walk_lap(&clk, S_RATIO);

    // ---- the pivot (driver.pivot_update): no barrier before it ----
    if (do_pivot) {
      const int rg = r + 2, nx = cur ^ 1;
      const T rinv = div_rn(T(1), L.colv[rg]);
      for (int k = sl.slot; k < n; k += sl.slots) {
        T* col = L.tab + k;
        if (k == j) {
          for (int i = sl.rs; i < M; i += sl.R) col[(long long)i * P] = T(i == rg);
        } else {
          const T pk = mul_rn(col[(long long)rg * P], rinv);
          __syncwarp(sl.mask);  // every lane of the slot has read row rg
          pivot_column(col, P, M, rg, pk, L.colv, sl);
        }
      }
      const T prhs = mul_rn(L.rhs[cur][rg], rinv);
      sb = T(0);
      sbig = 0;
      ra = NO_IDX;
      for (int g = tid; g < M; g += nt) {
        const T b = g == rg ? prhs : fma(-L.colv[g], prhs, L.rhs[cur][g]);
        L.rhs[nx][g] = b;
        if (g < 2) continue;
        const int bv = g == rg ? j : L.basis[cur][g - 2];
        L.basis[nx][g - 2] = bv;
        sb = add_term(sb, b, sbig, 2u);
        if (L.art[bv]) ra = min(ra, (unsigned)(g - 2));
      }
      cur = nx;
    }
    walk_lap(&clk, S_UPDATE);
    pd.zrow = s.phase == 1 ? 1 : 0;
    pd.crow_ok = finite_val(R.sc);
    pd.infeasible = became_infeasible || became_failed1;
    pd.unbounded = became_unbounded;
    pd.optimal = in_phase2 && !has_improving && !cleanup;
    end_step(pd, s, do_pivot, do_pricing, to_phase2, p.stall_limit);
    if (to_phase2) last_z = inf;
  }
  walk_lap(&clk, S_PRICE);
  store_walk<T, RESIDENT>(p, L, cur);
  store_scalars(p, s, last_z);
  if (clk.on && tid == 0) {
    walk_lap(&clk, S_STORE);
    for (int k = 0; k < S_NSTAGES; ++k) p.cycles[k] += clk.cyc[k];
  }
}

// ---------------------------------------------------------------------------
// the bounded-variable simplex (solve/bounded.py::bounded_simplex_step)
// ---------------------------------------------------------------------------

template <typename T>
struct BoundedLaneParams {
  LaneParams<T> l;
  const T* upper;
  const unsigned char* at_in;
  unsigned char* at_out;
  const T* gamma_in;  // devex only
  T* gamma_out;       // devex only
  long long st_upper, st_at, st_gamma;
  bool devex;
  T reset_above;
};

// A step of lane_bounded_kernel: lane_primal_kernel's machinery. The first
// reduction also takes the largest devex weight after the previous update
// (whose reset the previous step left pending: the pass prices under the
// weights and under unit ones) and whether row 2 is finite (the redirected
// pivot's no-op test). The three-way ratio test runs every step, its two
// minima in one reduction: on ties the first index of the winning kind is
// its minimum's (Bland's ties take a second). The update needs no barrier
// while every basic column is the unit vector on its row (checked at the
// launch, kept by every pivot whose column and 1 / pivot are finite, as
// bounded_grid.cu keeps it): the flip's column (column j, or the leaving
// basic column e_{r+2}) and basis[0]'s (e_2) are then known without
// reading them, so a row's thread computes its RHS whole (the pivot's
// fma, then the flip's fma(-Tn[i, fcol], uf, b)) while the column's owner
// negates the column. Where a basic column is not a unit vector the rows
// snapshot both columns behind a barrier first (and the redirected pivot's
// no-op test takes a second).
template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(LANE_MAX_THREADS) lane_bounded_kernel(BoundedLaneParams<T> q) {
  __shared__ StepKeys<T> sh_step[LANE_MAX_WARPS];
  __shared__ KeyRed<T> sh_ratio[LANE_MAX_WARPS], sh_tie[LANE_MAX_WARPS], sh_clean[LANE_MAX_WARPS];
  __shared__ WalkClock clk;
  extern __shared__ __align__(16) unsigned char lane_dyn[];
  const LaneParams<T>& p = q.l;
  const Walk<T> L = walk_layout<T, RESIDENT>(p, lane_dyn, true);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int M = p.M, N = p.N, m = M - 2, n = N - 1, P = L.pitch;
  const long long lane = blockIdx.x;
  const T inf = pos_inf<T>();
  const bool devex = q.devex;
  const Slices sl = row_slices(n);
  if (tid == 0) {
    clk.on = p.cycles != nullptr && blockIdx.x == 0;
    clk.last = clock64();
    for (int k = 0; k < S_NSTAGES; ++k) clk.cyc[k] = 0;
  }
  // the spans, the flags and the weights, each slot's first lane its
  // columns'
  T gpart = -inf;  // the NaN-first maximum of the own weights
  for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) {
    L.upper[k] = q.upper[lane * q.st_upper + k];
    L.at[k] = q.at_in[lane * q.st_at + k] != 0;
    if (devex) {
      L.gamma[k] = q.gamma_in[lane * q.st_gamma + k];
      gpart = nan_max(gpart, L.gamma[k]);
    }
  }
  load_walk(p, L);
  T last_z;
  Scalars s = load_scalars(p, last_z);
  block_sync();
  // whether every basic column is the unit vector on its row (a thread the
  // basic columns of its rows)
  bool bad = false;
  for (int ii = tid; ii < m; ii += nt) {
    const T* col = L.tab + L.basis[0][ii];
    for (int i = 0; i < M && !bad; ++i) bad = col[(long long)i * P] != T(i == ii + 2);
  }
  bool units_ok = !block_or(bad);
  walk_lap(&clk, S_LOAD);
  int cur = 0;
  T sb = T(0);
  unsigned sbig = 0, ra = NO_IDX;
  row_partials(L, M, sb, sbig, ra);
  Pending pd = {false, false, false, false, false, true, 0};
  while (pd.on || (s.status == ST_RUNNING && s.niter < p.max_iters)) {
    // ---- the price pass (common.cuh's bounded_price_scan over the own
    // columns; devex also under unit weights) and row 2's finiteness; one
    // reduction ----
    StepRed<T> x = step_identity<T>(devex);
    x.sb = sb;
    x.big = sbig;
    x.r = ra;
    x.g = gpart;
    const T* crow = L.tab + (s.phase == 1 ? P : 0);
    const T* row2 = L.tab + 2LL * P;
    __syncwarp();  // the slot's rows, from its other lanes
    for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) {
      const bool a = L.act[k] != 0;
      const T c = crow[k];
      const T c_eff = a ? c : inf;
      const bool improving = c_eff < -p.opt_tol;
      if (improving) x.a = min(x.a, (unsigned)k);
      if (a) x.sc = add_term(x.sc, c, x.big, 1u);
      if (devex) {
        const T cc = mul_rn(c, c);
        pick_vi(x.v1, x.i1, improving ? div_rn(cc, L.gamma[k]) : -inf, k, true);
        pick_vi(x.v2, x.i2, improving ? div_rn(cc, T(1)) : -inf, k, true);
      } else {
        pick_vi(x.v1, x.i1, c_eff, k, false);
      }
      if (!finite_val(row2[k])) x.f = min(x.f, (unsigned)k);
    }
    if (tid == 2 && !finite_val(L.rhs[cur][2])) x.f = min(x.f, (unsigned)n);
    const StepRed<T> R = step_reduce<T, true>(x, devex, devex, sh_step);
    walk_bar(&clk);
    // the previous step's devex reset on its largest weight (NaN: none)
    bool reset = false;
    if (pd.on) {
      reset = devex && R.g > q.reset_above;
      if (reset) {
        for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) L.gamma[k] = T(1);
        gpart = sl.rs == 0 && sl.slot < n ? T(1) : -inf;
      }
      finish_pending(pd, s, last_z, -L.rhs[cur][pd.zrow], R.sb, p);
      if (!(s.status == ST_RUNNING && s.niter < p.max_iters)) break;
    }
    walk_lap(&clk, S_PRICE);

    // ---- the decisions ----
    const bool in_phase2 = s.phase == 2;
    const bool cleanup = R.r != NO_IDX && in_phase2;
    const int r_d = R.r != NO_IDX ? (int)R.r : 0;
    const bool has_improving = R.a != NO_IDX;
    const int j_price = s.bland ? (has_improving ? (int)R.a : n - 1) : (reset ? R.i2 : R.i1);
    bool has_elig = false;
    int j_d = n - 1;
    if (cleanup) {
      const unsigned e = cleanup_column(L, r_d, n, p.piv_tol, sh_clean);
      walk_bar(&clk);
      has_elig = e != NO_IDX;
      if (has_elig) j_d = (int)e;
    }
    const bool retire = cleanup && !has_elig;
    const bool phase1_done = s.phase == 1 && !has_improving;
    const bool became_infeasible = phase1_done && -L.rhs[cur][1] > p.infeas_tol;
    const bool to_phase2 = phase1_done && !became_infeasible;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const int j = cleanup ? j_d : j_price;

    // ---- the three-way ratio test over column j (common.cuh's
    // bounded_ratios), run on every step as the plain step runs it; its
    // rows' snapshot of the column and whether it is finite ----
    T lov = inf, upv = inf;
    int loi = BIG_I, upi = BIG_I;
    unsigned cbad = NO_IDX;
    for (int g = tid; g < M; g += nt) {
      const T c = L.tab[(long long)g * P + j];
      L.colv[g] = c;
      if (!finite_val(c)) cbad = min(cbad, (unsigned)g);
      if (g < 2) continue;
      T tl, tu;
      bool neg;
      bounded_ratios(c, L.rhs[cur][g], L.upper[L.basis[cur][g - 2]], p.piv_tol, tl, tu, neg);
      pick_vi(lov, loi, tl, g - 2, false);
      pick_vi(upv, upi, tu, g - 2, false);
    }
    pick2_flag(lov, loi, upv, upi, cbad, sh_ratio);
    walk_bar(&clk);
    const T t_star = nan_min(nan_min(lov, upv), L.upper[j]);
    const bool kind_lo = lov <= t_star;
    const bool kind_up = !kind_lo && upv <= t_star;
    const bool kind_flip = !kind_lo && !kind_up;
    const bool has_ratio = finite_val(t_star);
    // the leaving row among the winning kind's ties: its minimum's first
    // index (row 0 where none ties), or Bland's smallest basic index
    int r_price = kind_lo ? loi : kind_up ? upi : 0;
    if (s.bland) {
      T tv = inf;
      int ti = BIG_I;
      unsigned none = NO_IDX;
      for (int g = tid; g < M; g += nt) {
        if (g < 2) continue;
        const int bv = L.basis[cur][g - 2];
        T tl, tu;
        bool neg;
        bounded_ratios(L.colv[g], L.rhs[cur][g], L.upper[bv], p.piv_tol, tl, tu, neg);
        const bool t = kind_lo ? tl <= t_star : (neg && tu <= t_star);
        pick_vi(tv, ti, t ? T(bv) : T(BIG_I), g - 2, false);
      }
      pick_reduce<T, true>(tv, ti, false, none, sh_tie);
      walk_bar(&clk);
      r_price = ti;
    }
    const bool do_cleanup = cleanup && has_elig;
    const bool do_price = pricing_pivot && has_ratio;
    const bool do_pivot = do_cleanup || (do_price && !kind_flip);
    const bool do_flip_enter = do_price && kind_flip;
    const int r = do_cleanup ? r_d : r_price;
    const int leaving = L.basis[cur][r];
    const bool do_flip = (do_price && kind_up && !cleanup) || do_flip_enter;
    const int fcol = do_flip_enter ? j : leaving;
    const T uf = do_flip ? L.upper[fcol] : T(0);
    const T piv = L.colv[r + 2];
    const T gq = devex ? L.gamma[j] : T(0);
    const int basis0 = L.basis[cur][0];
    const bool became_unbounded = pricing_pivot && !has_ratio && in_phase2;
    const bool became_failed1 = pricing_pivot && !has_ratio && !in_phase2;

    if (retire) {
      if (tid == 0) L.art[L.basis[cur][r_d]] = 0;
      block_sync();
      walk_bar(&clk);
    }
    if (to_phase2)
      for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) L.act[k] = L.act[k] && !L.art[k];

    // ---- the update's pivot: (r + 2, j), else the plain step's redirected
    // one on (row 2, basis[0]) unless that is an exact no-op ----
    const int rg = do_pivot ? r + 2 : 2, jp = do_pivot ? j : basis0;
    bool pv = do_pivot || R.f != NO_IDX;
    if (!units_ok) {
      // the pre-step columns basis[0] and fcol, snapshotted by the rows
      for (int g = tid; g < M; g += nt) {
        L.colb[g] = L.tab[(long long)g * P + basis0];
        L.colf[g] = L.tab[(long long)g * P + fcol];
      }
      block_sync();
      walk_bar(&clk);
      if (!do_pivot && !pv) {
        bool not_unit = false;
        for (int g = tid; g < M; g += nt) not_unit = not_unit || L.colb[g] != T(g == 2);
        pv = block_or(not_unit);
        walk_bar(&clk);
      }
    }
    walk_lap(&clk, S_RATIO);
    // the pivot's pre-step column (null: e_2) and element, the flip's
    // pre-step column (null: e_{r+2})
    const T* cp = do_pivot ? L.colv : units_ok ? nullptr : L.colb;
    const T cjr = do_pivot ? piv : units_ok ? T(1) : L.colb[2];
    const T* cf = fcol == j ? L.colv : units_ok ? nullptr : L.colf;
    const T rinv = pv ? div_rn(T(1), cjr) : T(1);
    // the columns: a thread its own (the pivot, the flip's negation, the
    // at-upper flag, the devex weights and their maximum)
    const bool upd = devex && do_price && !kind_flip;
    const T qv = upd ? div_rn(gq, mul_rn(piv, piv)) : T(1);
    const T leave = is_nan(qv) ? qv : (qv < T(1) ? T(1) : qv);
    T gp = -inf;
    for (int k = sl.slot; k < n; k += sl.slots) {
      T* col = L.tab + k;
      T pk = T(0);
      if (pv) {
        if (k == jp) {
          for (int i = sl.rs; i < M; i += sl.R) col[(long long)i * P] = T(i == rg);
        } else {
          pk = mul_rn(col[(long long)rg * P], rinv);
          __syncwarp(sl.mask);  // every lane of the slot has read row rg
          pivot_column(col, P, M, rg, pk, cp, sl);
        }
      }
      if (do_flip && k == fcol) {
        for (int i = sl.rs; i < M; i += sl.R) col[(long long)i * P] = -col[(long long)i * P];
        if (sl.rs == 0) L.at[k] = !L.at[k];
      }
      if (devex && sl.rs == 0) {
        T gk = L.gamma[k];
        if (upd) {
          const T a = k == jp ? T(1) : pk;
          gk = nan_max(gk, mul_rn(mul_rn(a, a), gq));
          if (k == leaving) gk = leave;
        }
        if (to_phase2) gk = T(1);
        L.gamma[k] = gk;
        gp = nan_max(gp, gk);
      }
    }
    if (devex) gpart = gp;
    // the rows: a thread its own (the RHS after the pivot and the flip,
    // into the other buffer; the basis; the partials of the next state)
    const int nx = cur ^ 1;
    const T prhs = pv ? mul_rn(L.rhs[cur][rg], rinv) : T(0);
    const T cfr = cf ? cf[rg] : T(rg == r + 2);
    const T pf = pv ? mul_rn(cfr, rinv) : T(0);
    sb = T(0);
    sbig = 0;
    ra = NO_IDX;
    for (int g = tid; g < M; g += nt) {
      const T cfg = cf ? cf[g] : T(g == r + 2);
      const T cpg = cp ? cp[g] : T(g == 2);
      const T b0 = L.rhs[cur][g];
      T tnf = cfg, bp = b0;
      if (pv) {
        tnf = g == rg ? (fcol == jp ? T(1) : pf) : (fcol == jp ? T(0) : fma(-cpg, pf, cfg));
        bp = g == rg ? prhs : fma(-cpg, prhs, b0);
      }
      const T b = fma(-tnf, uf, bp);
      L.rhs[nx][g] = b;
      if (g < 2) continue;
      const int bv = do_pivot && g == rg ? j : L.basis[cur][g - 2];
      L.basis[nx][g - 2] = bv;
      sb = add_term(sb, b, sbig, 2u);
      if (L.art[bv]) ra = min(ra, (unsigned)(g - 2));
    }
    cur = nx;
    // a pivot keeps every basic column a unit vector while its column and
    // 1 / pivot are finite
    if (do_pivot && (cbad != NO_IDX || !finite_val(rinv))) units_ok = false;
    walk_lap(&clk, S_UPDATE);
    const bool act = do_pivot || do_flip_enter;
    pd.zrow = s.phase == 1 ? 1 : 0;
    pd.crow_ok = finite_val(R.sc);
    pd.infeasible = became_infeasible || became_failed1;
    pd.unbounded = became_unbounded;
    pd.optimal = in_phase2 && !has_improving && !cleanup;
    end_step(pd, s, act, do_price && act, to_phase2, p.stall_limit);
    if (to_phase2) last_z = inf;
  }
  walk_lap(&clk, S_PRICE);
  store_walk<T, RESIDENT>(p, L, cur);
  for (int k = sl.slot; sl.rs == 0 && k < n; k += sl.slots) {
    q.at_out[lane * n + k] = L.at[k];
    if (devex) q.gamma_out[lane * n + k] = L.gamma[k];
  }
  store_scalars(p, s, last_z);
  if (clk.on && tid == 0) {
    walk_lap(&clk, S_STORE);
    for (int k = 0; k < S_NSTAGES; ++k) p.cycles[k] += clk.cyc[k];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
LaneParams<T> lane_params(const long long* a, const int* in, const double* tol) {
  LaneParams<T> p;
  p.T_in = (const T*)a[A_T_IN];
  p.T_out = (T*)a[A_T_OUT];
  p.basis_in = (const int*)a[A_BASIS_IN];
  p.basis_out = (int*)a[A_BASIS_OUT];
  p.act_in = (const unsigned char*)a[A_ACT_IN];
  p.art_in = (const unsigned char*)a[A_ART_IN];
  p.act_out = (unsigned char*)a[A_ACT_OUT];
  p.art_out = (unsigned char*)a[A_ART_OUT];
  p.phase_in = (const int*)a[A_PHASE_IN];
  p.status_in = (const int*)a[A_STATUS_IN];
  p.niter_in = (const int*)a[A_NITER_IN];
  p.stuck_in = (const int*)a[A_STUCK_IN];
  p.bland_in = (const unsigned char*)a[A_BLAND_IN];
  p.lastz_in = (const T*)a[A_LASTZ_IN];
  p.phase_out = (int*)a[A_PHASE_OUT];
  p.status_out = (int*)a[A_STATUS_OUT];
  p.niter_out = (int*)a[A_NITER_OUT];
  p.stuck_out = (int*)a[A_STUCK_OUT];
  p.bland_out = (unsigned char*)a[A_BLAND_OUT];
  p.lastz_out = (T*)a[A_LASTZ_OUT];
  p.st_T = a[A_ST_T];
  p.st_basis = a[A_ST_BASIS];
  p.st_act = a[A_ST_ACT];
  p.st_art = a[A_ST_ART];
  p.st_phase = a[A_ST_PHASE];
  p.st_status = a[A_ST_STATUS];
  p.st_niter = a[A_ST_NITER];
  p.st_stuck = a[A_ST_STUCK];
  p.st_bland = a[A_ST_BLAND];
  p.st_lastz = a[A_ST_LASTZ];
  p.cycles = (long long*)a[A_CYCLES];
  p.M = in[I_M];
  p.N = in[I_N];
  p.stall_limit = in[I_STALL];
  p.max_iters = in[I_MAXIT];
  p.rule = in[I_RULE];
  p.tie = in[I_TIE];
  p.opt_tol = (T)tol[D_OPT];
  p.piv_tol = (T)tol[D_PIV];
  p.degen_tol = (T)tol[D_DEGEN];
  p.infeas_tol = (T)tol[D_INFEAS];
  p.feas_tol = (T)tol[D_FEAS];
  return p;
}

// ``kern`` over B blocks with the argument ``p``, its dynamic shared memory
// raised to ``smem`` where that is above what ``raised`` (one a kernel)
// records, the default 48 KB at first
template <typename P>
int launch_per_lane(const void* kern, int& raised, const P& p, int B, int threads, int smem,
                    cudaStream_t stream) {
  if (smem > raised) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    raised = smem;
  }
  P arg = p;
  void* args[] = {&arg};
  const cudaError_t e = cudaLaunchKernel(kern, dim3(B), dim3(threads), args, (size_t)smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the kernel for (PRIMAL, RESIDENT)
template <typename T, bool PRIMAL, bool RESIDENT>
int launch_lane_kernel(const LaneParams<T>& p, int B, int threads, int smem, cudaStream_t stream) {
  const void* kern = PRIMAL ? (const void*)lane_primal_kernel<T, RESIDENT>
                            : (const void*)lane_dual_kernel<T, RESIDENT>;
  static int raised = 48 * 1024;  // per instantiation
  return launch_per_lane(kern, raised, p, B, threads, smem, stream);
}

template <typename T, bool RESIDENT>
int launch_bounded_kernel(const BoundedLaneParams<T>& q, int B, int threads, int smem,
                          cudaStream_t stream) {
  static int raised = 48 * 1024;  // per instantiation
  return launch_per_lane((const void*)lane_bounded_kernel<T, RESIDENT>, raised, q, B, threads,
                         smem, stream);
}

// the launch's shape: the wrapper's plan must agree with the kernel's layout
inline bool lanes_shape_ok(int B, int M, int N, int threads) {
  return B > 0 && M >= 3 && N >= 2 && threads % 32 == 0 && threads >= 32 &&
         threads <= LANE_MAX_THREADS;
}

template <typename T, bool PRIMAL>
int launch_lanes(const long long* a, const int* in, const double* tol, void* stream) {
  const int B = in[I_B], M = in[I_M], N = in[I_N], threads = in[I_THREADS], smem = in[I_SMEM];
  const bool resident = in[I_RESIDENT] != 0;
  if (!lanes_shape_ok(B, M, N, threads) ||
      (long long)smem != walk_smem_bytes<T>(M, N, resident, false))
    return (int)cudaErrorInvalidValue;
  const LaneParams<T> p = lane_params<T>(a, in, tol);
  const cudaStream_t s = (cudaStream_t)stream;
  return resident ? launch_lane_kernel<T, PRIMAL, true>(p, B, threads, smem, s)
                  : launch_lane_kernel<T, PRIMAL, false>(p, B, threads, smem, s);
}

template <typename T>
int launch_bounded_lanes(const long long* a, const int* in, const double* tol, void* stream) {
  const int B = in[I_B], M = in[I_M], N = in[I_N], threads = in[I_THREADS], smem = in[I_SMEM];
  const bool resident = in[I_RESIDENT] != 0;
  if (!lanes_shape_ok(B, M, N, threads) ||
      (long long)smem != walk_smem_bytes<T>(M, N, resident, true))
    return (int)cudaErrorInvalidValue;
  BoundedLaneParams<T> q;
  q.l = lane_params<T>(a, in, tol);
  q.upper = (const T*)a[A_UPPER];
  q.at_in = (const unsigned char*)a[A_AT_IN];
  q.at_out = (unsigned char*)a[A_AT_OUT];
  q.gamma_in = (const T*)a[A_GAMMA_IN];
  q.gamma_out = (T*)a[A_GAMMA_OUT];
  q.st_upper = a[A_ST_UPPER];
  q.st_at = a[A_ST_AT];
  q.st_gamma = a[A_ST_GAMMA];
  q.devex = in[I_RULE] == RULE_DEVEX_;
  q.reset_above = (T)DEVEX_RESET_ABOVE_;
  if (!q.l.act_out || !q.l.art_out || !q.upper || !q.at_in || !q.at_out ||
      (q.devex && (!q.gamma_in || !q.gamma_out)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return resident ? launch_bounded_kernel<T, true>(q, B, threads, smem, s)
                  : launch_bounded_kernel<T, false>(q, B, threads, smem, s);
}

}  // namespace tpulp

#define TPULP_LANE_ENTRY(NAME, T, PRIMAL)                                                   \
  extern "C" int NAME(const long long* a, const int* in, const double* tol, void* stream) { \
    return tpulp::launch_lanes<T, PRIMAL>(a, in, tol, stream);                              \
  }

#if TPULP_F32
TPULP_LANE_ENTRY(tpulp_lane_dual_f32, float, false)
TPULP_LANE_ENTRY(tpulp_lane_primal_f32, float, true)
extern "C" int tpulp_lane_bounded_f32(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::launch_bounded_lanes<float>(a, in, tol, stream);
}
#endif
#if TPULP_F64
TPULP_LANE_ENTRY(tpulp_lane_dual_f64, double, false)
TPULP_LANE_ENTRY(tpulp_lane_primal_f64, double, true)
extern "C" int tpulp_lane_bounded_f64(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::launch_bounded_lanes<double>(a, in, tol, stream);
}
#endif
