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
// span-encoded branch-and-bound (milp/spans.py) run. The port ran them as
// eager vmapped steps of 100-250 small kernels each (the bounded step's
// pivot and flip two FMA launches), with a host read of "any lane
// running" before every chunk of steps.
//
// What bounds it on the H100: the chain of dependent block-wide
// reductions in every step (the leaving row, the entering column, the
// pivot, the finiteness sums), each a few __syncthreads; the bytes (each
// lane's frame read and written once) are microseconds of the card's
// rate. The lanes are independent and small (a 59 x 114 f64 frame is
// 53.8 KB), so one block owns one lane: no grid barrier and no cooperative
// launch.
//
// Design: block b loads lane b's frame, its basis and masks, and its
// scalars (phase, status, niter, stuck, bland, last_z), then steps while
// status == RUNNING and niter < max_iters, and writes the lane back once.
// Every step pivots, retires an artificial, changes phase, or leaves
// RUNNING, so the budget bounds the launch. With RESIDENT the frame lives
// in dynamic shared memory; otherwise the block works on its output frame
// in device memory (through L2), with the same code. Each step is the
// plain step's statement for statement: first-index ties in every
// (value, index) reduction, NaN-propagating argmin/argmax as torch's
// (the first NaN wins), comparisons in the tableau's type against the
// tolerances rounded to it, IEEE division and one rounding per product,
// and the pivot as the plain version computes it: prow = row * (1 / piv),
// fma(-col[i], prow[k], T[i, k]), row r set to prow, column j to the unit
// vector. The scalars are held by every thread alike (each computes them
// from the same reduction results); the finiteness sums are added in a
// fixed order (per thread, then the warp tree, then across warps) in the
// tableau's type. The block reductions (Red, offer, block_reduce,
// finite_val) live in common.cuh, which bounded.cu shares.
//
// lane_bounded_kernel steps bounded_simplex_step (solve/bounded.py) the
// same way: the clean-up scan and the retire; Dantzig or devex pricing
// (c^2 / gamma over the improving columns) with the Bland switch, every
// other rule priced as Dantzig; the three-way ratio test (a lower hit, then
// an upper hit, then the entering flip on exact ties; the first or Bland's
// smallest basic index among the winning kind's ties); one pivot; the devex
// update and its two resets; one column flip (the RHS fma(-Tn[i, fcol], uf,
// Tn[i, -1]) with one rounding, then the column negated); the stall
// counter, the Bland switch, the finiteness sums and the status. Its
// pricing and ratio test are bounded.cu's (common.cuh: bounded_price,
// bounded_ratio). The spans, the at-upper flags and the devex weights sit
// in shared memory beside the lane's vectors, resident or not. After the
// pivot's barrier the thread that owns row i updates T[i, -1] and
// T[i, fcol], so the flip needs no snapshot. Like bounded.cu it skips the
// plain step's redirected pivot on (row 2, basis[0]) where that is an
// exact no-op (it could change only a zero's sign); elsewhere it runs it.
// What bounds it is the same chain of reductions: a step makes the clean-up
// scan, the price, the two minima, the tie pick and the post-step sums
// (plus the no-op check on a step that does not pivot), six or seven
// block reductions of two barriers each, and three or four more barriers
// around the pivot and the flip; the bytes are each frame read and written
// once a launch (256 lanes of 66 x 193 f64: 0.016 ms at 3.35 TB/s).

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
  unsigned char* act_out;  // primal only
  unsigned char* art_out;  // primal only
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
  int M, N, stall_limit, max_iters, rule, tie;
  // the tolerances rounded to T: the plain step compares T tensors with
  // Python floats, which torch rounds to the tensor's type
  T opt_tol, piv_tol, degen_tol, infeas_tol, feas_tol;
};

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) / 16 * 16; }

// The dynamic shared memory of a lane: [frame (RESIDENT)] col, prow,
// basis, active mask, artificial mask; each segment 16-byte aligned.
template <typename T>
__host__ __device__ __forceinline__ long long lane_smem_bytes(int M, int N, bool resident) {
  const long long m = M - 2, n = N - 1;
  long long bytes = align16((long long)M * sizeof(T)) + align16((long long)N * sizeof(T)) +
                    align16(4 * m) + 2 * align16(n);
  if (resident) bytes += align16((long long)M * N * sizeof(T));
  return bytes;
}

// A bounded lane's shared memory: the lane's, then the spans and the devex
// weights (n of T each) and the at-upper flags (n bytes).
template <typename T>
__host__ __device__ __forceinline__ long long bounded_lane_smem_bytes(int M, int N, bool resident) {
  const long long n = N - 1;
  return lane_smem_bytes<T>(M, N, resident) + 2 * align16(n * (long long)sizeof(T)) + align16(n);
}

template <typename T>
struct Lane {
  T* tab;  // the frame: shared memory (RESIDENT) or the output in device memory
  T* colv;
  T* prow;
  int* basis;
  unsigned char* act;
  unsigned char* art;
};

template <typename T, bool RESIDENT>
__device__ Lane<T> lane_layout(const LaneParams<T>& p, unsigned char* dyn) {
  Lane<T> L;
  long long off = 0;
  if (RESIDENT) {
    L.tab = (T*)dyn;
    off = align16((long long)p.M * p.N * sizeof(T));
  } else {
    L.tab = p.T_out + (long long)blockIdx.x * p.M * p.N;
  }
  L.colv = (T*)(dyn + off);
  off += align16((long long)p.M * sizeof(T));
  L.prow = (T*)(dyn + off);
  off += align16((long long)p.N * sizeof(T));
  L.basis = (int*)(dyn + off);
  off += align16(4LL * (p.M - 2));
  L.act = dyn + off;
  off += align16(p.N - 1);
  L.art = dyn + off;
  return L;
}

// The lane's frame, basis and masks from the inputs; then a barrier.
template <typename T>
__device__ void load_lane(const LaneParams<T>& p, const Lane<T>& L) {
  const long long lane = blockIdx.x;
  const int MN = p.M * p.N, m = p.M - 2, n = p.N - 1;
  const T* src = p.T_in + lane * p.st_T;
  for (int e = threadIdx.x; e < MN; e += blockDim.x) L.tab[e] = src[e];
  for (int i = threadIdx.x; i < m; i += blockDim.x) L.basis[i] = p.basis_in[lane * p.st_basis + i];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    L.act[k] = p.act_in[lane * p.st_act + k] != 0;
    L.art[k] = p.art_in[lane * p.st_art + k] != 0;
  }
  __syncthreads();
}

// The frame and basis back to the outputs (the scalars are thread 0's).
template <typename T, bool RESIDENT>
__device__ void store_lane(const LaneParams<T>& p, const Lane<T>& L, bool masks) {
  const long long lane = blockIdx.x;
  const int MN = p.M * p.N, m = p.M - 2, n = p.N - 1;
  if (RESIDENT) {
    T* dst = p.T_out + lane * MN;
    for (int e = threadIdx.x; e < MN; e += blockDim.x) dst[e] = L.tab[e];
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) p.basis_out[lane * m + i] = L.basis[i];
  if (masks) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      p.act_out[lane * n + k] = L.act[k];
      p.art_out[lane * n + k] = L.art[k];
    }
  }
}

// The Gauss-Jordan pivot on global row rg, column j, as
// driver.pivot_update computes it; basis[rg - 2] = j. Starts after a
// barrier (every read of the frame done) and ends with one.
template <typename T>
__device__ void pivot(const Lane<T>& L, int M, int N, int rg, int j) {
  T* tab = L.tab;
  const T rinv = div_rn(T(1), tab[(long long)rg * N + j]);
  for (int i = threadIdx.x; i < M; i += blockDim.x) L.colv[i] = tab[(long long)i * N + j];
  for (int k = threadIdx.x; k < N; k += blockDim.x) L.prow[k] = mul_rn(tab[(long long)rg * N + k], rinv);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = warp; i < M; i += nw) {
    T* row = tab + (long long)i * N;
    const T nc = -L.colv[i];
    if (i == rg) {
      for (int k = lane; k < N; k += 32) row[k] = k == j ? T(1) : L.prow[k];
    } else {
      for (int k = lane; k < N; k += 32) row[k] = k == j ? T(0) : fma(nc, L.prow[k], row[k]);
    }
  }
  if (threadIdx.x == 0) L.basis[rg - 2] = j;
  __syncthreads();
}

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
// the dual simplex (solve/dual.py::dual_simplex_step)
// ---------------------------------------------------------------------------

// Over b = T[2:, -1]: argmin (v, i), the first row below -feas_tol (a) and
// the sum of |b| (s).
template <typename T>
__device__ Red<T> dual_rows(const LaneParams<T>& p, const Lane<T>& L, Red<T>* scratch) {
  const int N = p.N, m = p.M - 2;
  Red<T> x = red_identity<T>(false);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const T b = L.tab[(long long)(i + 2) * N + N - 1];
    offer(x, b, i, false);
    if (b < -p.feas_tol) x.a = min(x.a, i);
    x.s = add_rn(x.s, T(fabs(b)));
  }
  return block_reduce(x, scratch, false);
}

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(LANE_MAX_THREADS) lane_dual_kernel(LaneParams<T> p) {
  __shared__ Red<T> scratch[33];
  extern __shared__ __align__(16) unsigned char lane_dyn[];
  const Lane<T> L = lane_layout<T, RESIDENT>(p, lane_dyn);
  const int N = p.N, m = p.M - 2, n = p.N - 1;
  load_lane(p, L);
  T last_z;
  Scalars s = load_scalars(p, last_z);

  Red<T> rows = dual_rows(p, L, scratch);
  while (s.status == ST_RUNNING && s.niter < p.max_iters) {
    // leaving row: the most negative b; the first negative under Bland
    const bool feasible = rows.a == BIG_I;
    const int r = s.bland ? (feasible ? m - 1 : rows.a) : rows.i;
    // entering column: the dual ratio crow / -row over row < -piv_tol
    const T* rrow = L.tab + (long long)(r + 2) * N;
    Red<T> cols = red_identity<T>(false);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const T crow = L.tab[k];
      const bool act = L.act[k];
      const T rv = rrow[k];
      if (act && rv < -p.piv_tol) offer(cols, div_rn(crow, -rv), k, false);
      if (act) cols.s = add_rn(cols.s, T(fabs(crow)));
    }
    cols = block_reduce(cols, scratch, false);
    const bool has_elig = cols.i != BIG_I;
    // ties to the first index; a NaN minimum leaves no tie (argmax -> 0)
    const int j = (has_elig && !is_nan(cols.v)) ? cols.i : 0;
    const bool do_pivot = !feasible && has_elig;
    if (do_pivot) pivot(L, p.M, N, r + 2, j);
    // stall detection against the dual objective
    const T z = -L.tab[N - 1];
    if (do_pivot) {
      const bool improved = sub_rn(z, last_z) > p.degen_tol;
      s.stuck = improved ? 0 : s.stuck + 1;
      last_z = z;
      rows = dual_rows(p, L, scratch);
    }
    s.bland = s.bland || s.stuck >= p.stall_limit;
    const bool finite_ok = finite_val(z) && finite_val(rows.s) && finite_val(cols.s);
    s.status = !finite_ok ? ST_NUMERIC
               : (!feasible && !has_elig) ? ST_INFEASIBLE
               : feasible ? ST_OPTIMAL
                          : ST_RUNNING;
    s.niter += do_pivot;
  }
  store_lane<T, RESIDENT>(p, L, false);
  store_scalars(p, s, last_z);
}

// ---------------------------------------------------------------------------
// the rank-1 primal simplex (solve/driver.py::simplex_step)
// ---------------------------------------------------------------------------

// Over the rows: the sum of |b| (s) and the first row whose basic column
// is artificial (a).
template <typename T>
__device__ Red<T> primal_rows(const LaneParams<T>& p, const Lane<T>& L, Red<T>* scratch) {
  const int N = p.N, m = p.M - 2;
  Red<T> x = red_identity<T>(false);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    x.s = add_rn(x.s, T(fabs(L.tab[(long long)(i + 2) * N + N - 1])));
    if (L.art[L.basis[i]]) x.a = min(x.a, i);
  }
  return block_reduce(x, scratch, false);
}

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(LANE_MAX_THREADS) lane_primal_kernel(LaneParams<T> p) {
  __shared__ Red<T> scratch[33];
  extern __shared__ __align__(16) unsigned char lane_dyn[];
  const Lane<T> L = lane_layout<T, RESIDENT>(p, lane_dyn);
  const int M = p.M, N = p.N, m = p.M - 2, n = p.N - 1;
  const T inf = pos_inf<T>();
  const bool max_inc = p.rule == RULE_MAX_INCREASE_;
  const bool max_piv = p.tie != 0;
  load_lane(p, L);
  T last_z;
  Scalars s = load_scalars(p, last_z);

  Red<T> rows = primal_rows(p, L, scratch);
  while (s.status == ST_RUNNING && s.niter < p.max_iters) {
    // cleanup scan: a basic artificial in phase 2
    const bool in_phase2 = s.phase == 2;
    const bool cleanup = rows.a != BIG_I && in_phase2;
    const int r_d = rows.a != BIG_I ? rows.a : 0;
    const T* rowd = L.tab + (long long)(r_d + 2) * N;
    const T* crow = L.tab + (s.phase == 1 ? N : 0);
    // pricing over the columns: Dantzig's argmin of c_eff (devex priced
    // as Dantzig) or the greatest increase's argmax (v, i); the first
    // improving column (a); the first cleanup-eligible column (b); the sum
    // of |crow| over the active columns (s)
    Red<T> cols = red_identity<T>(max_inc);
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const bool act = L.act[k];
      const T c = crow[k];
      const T c_eff = act ? c : inf;
      const bool improving = c_eff < -p.opt_tol;
      if (improving) cols.a = min(cols.a, k);
      if (act) cols.s = add_rn(cols.s, T(fabs(c)));
      if (cleanup && act && !L.art[k] && T(fabs(rowd[k])) > p.piv_tol) cols.b = min(cols.b, k);
      if (max_inc) {
        // every column's minimum ratio (NaN-propagating, as torch's min)
        T ratio = inf;
        for (int i = 0; i < m; ++i) {
          const T a = L.tab[(long long)(i + 2) * N + k];
          const T q = a > p.piv_tol ? div_rn(L.tab[(long long)(i + 2) * N + N - 1], a) : inf;
          if (!is_nan(ratio) && (is_nan(q) || q < ratio)) ratio = q;
        }
        const T dec = improving ? (ratio < inf ? mul_rn(-c_eff, ratio) : inf) : -inf;
        offer(cols, dec, k, true);
      } else {
        offer(cols, c_eff, k, false);
      }
    }
    cols = block_reduce(cols, scratch, max_inc);
    const bool has_improving = cols.a != BIG_I;
    const bool use_bland = s.bland || p.rule == RULE_BLAND_;
    const int j_price = use_bland ? (has_improving ? cols.a : n - 1) : cols.i;
    const bool has_elig = cols.b != BIG_I;
    const int j_d = has_elig ? cols.b : n - 1;
    const bool retire = cleanup && !has_elig;

    // phase bookkeeping
    const T z1 = -L.tab[(long long)N + N - 1];
    const bool phase1_done = s.phase == 1 && !has_improving;
    const bool became_infeasible = phase1_done && z1 > p.infeas_tol;
    const bool to_phase2 = phase1_done && !became_infeasible;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const int j = cleanup ? j_d : j_price;

    // ratio test over column j (driver.ratio_rows)
    bool has_ratio = false;
    int r_price = 0;
    if (pricing_pivot) {
      Red<T> rq = red_identity<T>(false);
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const T c = L.tab[(long long)(i + 2) * N + j];
        const bool pos = c > p.piv_tol;
        if (pos) rq.a = min(rq.a, i);
        offer(rq, pos ? div_rn(L.tab[(long long)(i + 2) * N + N - 1], c) : inf, i, false);
      }
      rq = block_reduce(rq, scratch, false);
      has_ratio = rq.a != BIG_I;
      const bool nan_min = is_nan(rq.v);
      if (!use_bland && !max_piv) {
        r_price = nan_min ? 0 : rq.i;
      } else {
        // the tie set {ratio <= min}: Bland's smallest basic index, or the
        // largest pivot element
        Red<T> rt = red_identity<T>(!use_bland);
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
          const T c = L.tab[(long long)(i + 2) * N + j];
          const T q = c > p.piv_tol ? div_rn(L.tab[(long long)(i + 2) * N + N - 1], c) : inf;
          const bool tie = !nan_min && q <= rq.v;
          if (use_bland)
            offer(rt, tie ? T(L.basis[i]) : T(BIG_I), i, false);
          else
            offer(rt, tie ? c : -inf, i, true);
        }
        rt = block_reduce(rt, scratch, !use_bland);
        r_price = rt.i;
      }
    }
    const bool became_unbounded = pricing_pivot && !has_ratio && in_phase2;
    const bool became_failed1 = pricing_pivot && !has_ratio && !in_phase2;
    const bool do_cleanup = cleanup && has_elig;
    const bool do_pricing = pricing_pivot && has_ratio;
    const bool do_pivot = do_cleanup || do_pricing;
    const int r = do_cleanup ? r_d : r_price;

    // the retire and the phase change write the masks (never in one step:
    // a retire needs phase 2, the phase change phase 1)
    if (retire && threadIdx.x == 0) L.art[L.basis[r_d]] = 0;
    if (to_phase2)
      for (int k = threadIdx.x; k < n; k += blockDim.x) L.act[k] = L.act[k] && !L.art[k];
    __syncthreads();
    if (do_pivot) pivot(L, M, N, r + 2, j);

    // stall / Bland switch against the current objective
    const T z = s.phase == 1 ? -L.tab[(long long)N + N - 1] : -L.tab[N - 1];
    if (do_pricing) {
      const bool improved = sub_rn(last_z, z) > p.degen_tol;
      s.stuck = improved ? 0 : s.stuck + 1;
      last_z = z;
    }
    s.bland = s.bland || s.stuck >= p.stall_limit;
    if (to_phase2) {
      s.phase = 2;
      s.stuck = 0;
      last_z = inf;
    }
    const bool finished_opt = in_phase2 && !has_improving && !cleanup;
    rows = primal_rows(p, L, scratch);
    const bool finite_ok = finite_val(z) && finite_val(rows.s) && finite_val(cols.s);
    s.status = !finite_ok ? ST_NUMERIC
               : (became_infeasible || became_failed1) ? ST_INFEASIBLE
               : became_unbounded ? ST_UNBOUNDED
               : finished_opt ? ST_OPTIMAL
                              : ST_RUNNING;
    s.niter += do_pivot;
  }
  store_lane<T, RESIDENT>(p, L, true);
  store_scalars(p, s, last_z);
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

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(LANE_MAX_THREADS) lane_bounded_kernel(BoundedLaneParams<T> q) {
  __shared__ Red<T> scratch[33];
  extern __shared__ __align__(16) unsigned char lane_dyn[];
  const LaneParams<T>& p = q.l;
  const Lane<T> L = lane_layout<T, RESIDENT>(p, lane_dyn);
  const int M = p.M, N = p.N, m = p.M - 2, n = p.N - 1;
  const long long lane = blockIdx.x;
  const T inf = pos_inf<T>();
  // the spans, the devex weights and the at-upper flags after the lane's
  // own segments
  unsigned char* vec = lane_dyn + lane_smem_bytes<T>(M, N, RESIDENT);
  T* upper = (T*)vec;
  T* gamma = (T*)(vec + align16((long long)n * sizeof(T)));
  unsigned char* at_upper = vec + 2 * align16((long long)n * sizeof(T));
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    upper[k] = q.upper[lane * q.st_upper + k];
    at_upper[k] = q.at_in[lane * q.st_at + k] != 0;
    if (q.devex) gamma[k] = q.gamma_in[lane * q.st_gamma + k];
  }
  load_lane(p, L);
  T last_z;
  Scalars s = load_scalars(p, last_z);

  while (s.status == ST_RUNNING && s.niter < p.max_iters) {
    // the clean-up scan: a basic artificial in phase 2
    const bool in_phase2 = s.phase == 2;
    const int ra = first_artificial_row<T>(L.basis, L.art, m, scratch);
    const bool cleanup = ra != BIG_I && in_phase2;
    const int r_d = ra != BIG_I ? ra : 0;
    // pricing (v, i), the first improving column (a), the first clean-up-
    // eligible column (b), the pre-step |crow| sum over the active columns
    const Red<T> cols =
        bounded_price(L.tab + (s.phase == 1 ? N : 0), L.tab + (long long)(r_d + 2) * N, L.act,
                      L.art, gamma, n, q.devex, p.opt_tol, p.piv_tol, scratch);
    const bool has_improving = cols.a != BIG_I;
    const bool has_elig = cols.b != BIG_I;
    const int j_price = s.bland ? (has_improving ? cols.a : n - 1) : cols.i;
    const bool retire = cleanup && !has_elig;

    // phase bookkeeping
    const bool phase1_done = s.phase == 1 && !has_improving;
    const bool became_infeasible = phase1_done && -L.tab[(long long)N + N - 1] > p.infeas_tol;
    const bool to_phase2 = phase1_done && !became_infeasible;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const int j = cleanup ? (has_elig ? cols.b : n - 1) : j_price;

    // the three-way ratio test over column j, run on every step as the
    // plain step runs it: its row names the flip's column even where
    // nothing moves
    const BoundedRatio rt =
        bounded_ratio(L.tab, N, m, j, L.basis, upper, p.piv_tol, s.bland, scratch);
    const bool do_cleanup = cleanup && has_elig;
    const bool do_price = pricing_pivot && rt.has_ratio;
    const bool do_pivot = do_cleanup || (do_price && !rt.kind_flip);
    const bool do_flip_enter = do_price && rt.kind_flip;
    const int r = do_cleanup ? r_d : rt.r_price;
    const int leaving = L.basis[r];
    const bool do_flip = (do_price && rt.kind_up && !cleanup) || do_flip_enter;
    const int fcol = do_flip_enter ? j : leaving;
    const T uf = do_flip ? upper[fcol] : T(0);
    const T piv = L.tab[(long long)(r + 2) * N + j];
    const T gq = q.devex ? gamma[j] : T(0);
    const int basis0 = L.basis[0];
    const bool became_unbounded = pricing_pivot && !rt.has_ratio && in_phase2;
    const bool became_failed1 = pricing_pivot && !rt.has_ratio && !in_phase2;

    // the retire and the phase change write the masks (never in one step:
    // a retire needs phase 2, the phase change phase 1)
    if (retire && threadIdx.x == 0) L.art[L.basis[r_d]] = 0;
    if (to_phase2)
      for (int k = threadIdx.x; k < n; k += blockDim.x) L.act[k] = L.act[k] && !L.art[k];

    // one pivot in place from the snapshot of its column and row: the real
    // one, or the redirected one on (row 2, basis[0]) unless an exact no-op
    int rg, jp;
    const bool pv = pivot_snapshot(L.tab, M, N, do_pivot, r, j, basis0, L.colv, L.prow, scratch,
                                   rg, jp);
    __syncthreads();
    if (pv) {
      const int ln = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
      for (int i = warp; i < M; i += nw) {
        T* row = L.tab + (long long)i * N;
        for (int k = ln; k < N; k += 32) row[k] = pivoted(L.colv, L.prow, rg, jp, i, k, row[k]);
      }
      if (do_pivot && threadIdx.x == 0) L.basis[r] = j;
      __syncthreads();
    }

    // one column flip (uf = 0 where none: the RHS still takes the plain
    // step's fma), each thread on its rows; the post-step |b| sum (s) and
    // the devex weights' NaN-first maximum (v) in one reduction
    Red<T> x = red_identity<T>(true);
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      T* row = L.tab + (long long)i * N;
      const T tf = row[fcol];
      const T b = fma(-tf, uf, row[N - 1]);
      row[N - 1] = b;
      if (do_flip) row[fcol] = -tf;
      if (i >= 2) x.s = add_rn(x.s, T(fabs(b)));
    }
    if (do_flip && threadIdx.x == 0) at_upper[fcol] = !at_upper[fcol];
    // the weights move on a pricing pivot only (alpha: the post-pivot row r
    // before the flip, the weights being sign-invariant)
    if (q.devex) devex_weights(gamma, L.prow, n, jp, leaving, do_price && !rt.kind_flip, gq, piv, x);
    x = block_reduce(x, scratch, true);
    if (q.devex && (x.v > q.reset_above || to_phase2))
      for (int k = threadIdx.x; k < n; k += blockDim.x) gamma[k] = T(1);

    // stall / Bland switch against the step's objective, the phase, status
    const bool act = do_pivot || do_flip_enter;
    const T z = -L.tab[s.phase == 1 ? (long long)N + N - 1 : (long long)N - 1];
    if (do_price && act) {
      s.stuck = sub_rn(last_z, z) > p.degen_tol ? 0 : s.stuck + 1;
      last_z = z;
    }
    s.bland = s.bland || s.stuck >= p.stall_limit;
    if (to_phase2) {
      s.phase = 2;
      s.stuck = 0;
      last_z = inf;
    }
    const bool finished_opt = in_phase2 && !has_improving && !cleanup;
    const bool finite_ok = finite_val(z) && finite_val(x.s) && finite_val(cols.s);
    s.status = !finite_ok ? ST_NUMERIC
               : (became_infeasible || became_failed1) ? ST_INFEASIBLE
               : became_unbounded ? ST_UNBOUNDED
               : finished_opt ? ST_OPTIMAL
                              : ST_RUNNING;
    s.niter += act;
  }
  __syncthreads();
  store_lane<T, RESIDENT>(p, L, true);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    q.at_out[lane * n + k] = at_upper[k];
    if (q.devex) q.gamma_out[lane * n + k] = gamma[k];
  }
  store_scalars(p, s, last_z);
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
  if (!lanes_shape_ok(B, M, N, threads) || (long long)smem != lane_smem_bytes<T>(M, N, resident))
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
      (long long)smem != bounded_lane_smem_bytes<T>(M, N, resident))
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

TPULP_LANE_ENTRY(tpulp_lane_dual_f32, float, false)
TPULP_LANE_ENTRY(tpulp_lane_dual_f64, double, false)
TPULP_LANE_ENTRY(tpulp_lane_primal_f32, float, true)
TPULP_LANE_ENTRY(tpulp_lane_primal_f64, double, true)

extern "C" int tpulp_lane_bounded_f32(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::launch_bounded_lanes<float>(a, in, tol, stream);
}
extern "C" int tpulp_lane_bounded_f64(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::launch_bounded_lanes<double>(a, in, tol, stream);
}
