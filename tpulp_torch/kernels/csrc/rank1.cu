// rank1 scan / price / ratio / update / finish: the solo rank-1 simplex
// step (solve/driver.py::simplex_step, and solve/devex.py::
// devex_simplex_step with devex weights) and the solo dual simplex step
// (solve/dual.py::dual_simplex_step) as stream-ordered launches that read
// and write a walk record on the card.
//
// Replaces no Pallas kernel: in tpulp these walks are XLA's compiled
// ``lax.while_loop`` over ``simplex_step`` (tpulp/solve/driver.py:74, the
// driver 252-293), over ``devex_simplex_step`` (tpulp/solve/devex.py:75,
// the driver 240-262) and over ``dual_simplex_step`` (tpulp/solve/dual.py),
// a few fused kernels a step. The port ran the step as ~100-250 small eager
// kernels and one FMA launch, 1.6-2.1 ms of host time a pivot.
//
// What bounds it on the H100: the update reads and writes the whole
// tableau once a step (2 x 258 x 769 x 8 B at the rank-1 engine's largest
// f64 frame: 0.95 us at 3.35 TB/s; 2 x 1538 x 3073 x 8 B = 75.6 MB, 22.6
// us, at the 1536 x 1536 LP of driver="rank1"). The column pass reads it
// once more where a step needs it. The single-block launches work on
// vectors (<= n columns or <= m rows) and are bound by the latency of
// their block reductions; at the small frames the launches themselves and
// the host's enqueue set the pace.
//
// Design: the step is cut at its global dependencies (the
// entering column, the leaving row, the pivot) into ordinary launches; the
// stream's order is the barrier between them, so no launch is cooperative.
// - scan (the grid; enqueued for greatest-increase and devex walks only):
//   a column pass where the step needs one, else it returns at once: every
//   column's minimum ratio b_i / T[i, j] over T[i, j] > piv_tol (the
//   greatest increase, every step), or whether the column has an entry
//   above piv_tol (devex's exposed-ray scan, on its ray ticks in phase 2).
//   Rows are cut into scan_chunks chunks, one partial a chunk and column;
//   price combines them in chunk order;
// - price (one block): the clean-up scan for basic artificials, pricing
//   (Dantzig's argmin of c_eff, Bland's first improving column, the
//   greatest increase's argmax of -c_j ratio_j, or devex's argmax of c^2 /
//   gamma with the half-period Dantzig probe), the exposed ray, the phase
//   bookkeeping and the finiteness sum of the pre-step pricing row;
// - ratio (one block): the ratio test over the entering column with
//   first-index or largest-pivot ties (Bland's smallest basic index under
//   Bland), and the snapshot of the pivot's column and its normalised row,
//   so that the update runs in place (common.cuh's pivot_snapshot, which
//   skips the plain step's redirected pivot on (row 2, basis[0]) only where
//   that is an exact no-op);
// - update (the grid, elementwise): fma(-col[i], prow[k], T[i, k]), the
//   pivot row set to prow and the entering column to the exact unit vector
//   (driver.pivot_update);
// - finish (one block): the basis, the retire, the devex weights and their
//   resets, the stall counter and the Bland switch, the phase change, the
//   finiteness sums and the status in status_select's precedence.
// The dual walk has no scan: its price picks the leaving row (the most
// negative b_r, the first negative one under Bland) and sums the pre-step
// |c|, its ratio picks the entering column (the smallest c_j / -T[r, j]
// over T[r, j] < -piv_tol) and snapshots the pivot, the update is the
// primal's, and its finish sets the basis, the stall counter against the
// dual objective, the Bland switch and the status.
// Every launch returns at once unless the record's status is RUNNING and
// niter < max_iters (common.cuh's live), so steps enqueued past the walk's
// exit are no-ops and the budget holds exactly. The arithmetic is the plain
// step's (lanes.cu's rules): one rounding per product in the decisions
// (*_rn), IEEE division, prow = row * (1 / piv), comparisons in the
// tableau's type against tolerances rounded to it, torch's NaN-first
// argmin/argmax with first-index ties and fixed-order sums. The walk's
// constants (the ray-scan cadence, the scan's row chunks, the devex reset)
// come from kernels/rank1.py through the argument arrays.

#include <algorithm>

#include "common.cuh"

namespace tpulp {
namespace rk1 {

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
// pricing rules and tie breaks (tpulp_torch.core.state)
constexpr int RULE_BLAND_ = 1, RULE_MAX_INCREASE_ = 2, TIE_MAXPIV_ = 1;
constexpr int ONE_BLOCK = 1024;  // threads of the single-block launches
constexpr int GRID_THREADS = 256, UPD_ROWS = 8;

// the record (tpulp_torch/kernels/rank1.py): int32 fields (the first three
// as common.cuh's REC_*), values in the tableau's type, the wrapper's
// argument arrays
enum Field {
  PHASE, STATUS, NITER, STUCK, BLAND,
  CLEANUP, R_D, HAS_ELIG, J, HAS_IMPROVING, PHASE1_DONE, INFEASIBLE, TO_PHASE2, PRICING_PIVOT,
  CROW_OK, RETIRE, RAY,
  DO_PIVOT, DO_PRICING, R, LEAVING, PV, RG, JP, UNBOUNDED, FAILED1, FEASIBLE, NI
};
enum Val { LAST_Z, PIV, GAMMA_Q, NV };
enum Arg { A_T, A_BASIS, A_ACT, A_ART, A_GAMMA, A_INTS, A_VALS, A_SNAP, A_SCAN, A_NARGS };
enum Int {
  I_M, I_N, I_STALL, I_MAXIT, I_RULE, I_TIE, I_WALK, I_STAGE, I_RAY_EVERY, I_SCAN_CHUNKS, I_NINTS
};
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_FEAS, D_RESET, D_NTOLS };
// the walks (kernels/rank1.py's WALKS)
enum Walk { W_PRIMAL, W_DEVEX, W_DUAL };
enum Stage { S_SCAN, S_PRICE, S_RATIO, S_UPDATE, S_FINISH, S_NSTAGES };

template <typename T>
struct Params {
  T* tab;
  int* basis;
  unsigned char* act;
  unsigned char* art;
  T* gamma;  // devex only
  int* rec;
  T* vals;
  T* snap;  // column jp (M) | prow (N)
  T* scan;  // scan_chunks x n partials (greatest increase, devex)
  int M, N, stall_limit, max_iters;
  // devex's ray-scan and probe cadence, the column pass's row chunks
  int ray_every, scan_chunks;
  // devex pricing (rule and tie break unused, as in devex_simplex_step);
  // else Bland's rule, the greatest increase, largest-pivot ties; or the
  // dual walk
  bool devex, bland_rule, max_inc, max_piv, dual;
  // the tolerances rounded to T, as torch rounds a Python float against a
  // tensor of T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, feas_tol, reset_above;
};

// ---------------------------------------------------------------------------
// scan: the column pass
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(GRID_THREADS) scan_kernel(Params<T> p) {
  const int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  // devex scans on its ray ticks only (price reads the partials then)
  if (p.devex && (rec[NITER] % p.ray_every != 0 || rec[PHASE] != 2)) return;
  const int N = p.N, m = p.M - 2, n = p.N - 1;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int rows = (m + p.scan_chunks - 1) / p.scan_chunks;
  const int i0 = blockIdx.y * rows, i1 = min(m, i0 + rows);
  T out;
  if (p.devex) {
    bool has_pos = false;
    for (int i = i0; i < i1; ++i)
      has_pos = has_pos || p.tab[(long long)(i + 2) * N + k] > p.piv_tol;
    out = has_pos ? T(1) : T(0);
  } else {
    // the chunk's minimum ratio, NaN-propagating as torch's min
    T ratio = pos_inf<T>();
    for (int i = i0; i < i1; ++i) {
      const T* row = p.tab + (long long)(i + 2) * N;
      const T a = row[k];
      const T q = a > p.piv_tol ? div_rn(row[N - 1], a) : pos_inf<T>();
      if (!is_nan(ratio) && (is_nan(q) || q < ratio)) ratio = q;
    }
    out = ratio;
  }
  p.scan[(long long)blockIdx.y * n + k] = out;
}

// ---------------------------------------------------------------------------
// price: clean-up scan, pricing, the exposed ray, phase bookkeeping
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) price_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int N = p.N, m = p.M - 2, n = p.N - 1;
  const int phase = rec[PHASE], niter = rec[NITER];
  const bool use_bland = rec[BLAND] != 0 || p.bland_rule;
  const T inf = pos_inf<T>();

  const int ra = first_artificial_row<T>(p.basis, p.art, m, scratch);
  const bool cleanup = ra != BIG_I && phase == 2;
  const int r_d = ra != BIG_I ? ra : 0;
  // devex's ticks: the exposed-ray scan, the half-period Dantzig probe
  const int tick = niter % p.ray_every;
  const bool scan_tick = p.devex && tick == 0 && phase == 2 && !cleanup;
  const bool probe = p.devex && tick == p.ray_every / 2 && phase == 2 && !cleanup;
  const bool by_score = p.devex && !probe;
  const bool mx = by_score || p.max_inc;

  // over the columns: the pick (v, i), argmax of the devex score or of the
  // greatest increase, else argmin of c_eff; the first improving column
  // (a); the first clean-up-eligible column on a clean-up step, else on a
  // ray tick the first improving column with no entry above piv_tol (b);
  // the sum of |crow| over the active columns (s)
  const T* rowd = p.tab + (long long)(r_d + 2) * N;
  const T* crow = p.tab + (phase == 1 ? N : 0);
  Red<T> cols = red_identity<T>(mx);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const bool act = p.act[k] != 0;
    const T c = crow[k];
    const T c_eff = act ? c : inf;
    const bool improving = c_eff < -p.opt_tol;
    if (improving) cols.a = min(cols.a, k);
    if (act) cols.s = add_rn(cols.s, T(fabs(c)));
    if (cleanup) {
      if (act && !p.art[k] && T(fabs(rowd[k])) > p.piv_tol) cols.b = min(cols.b, k);
    } else if (scan_tick && improving) {
      bool has_pos = false;
      for (int g = 0; g < p.scan_chunks; ++g)
        has_pos = has_pos || p.scan[(long long)g * n + k] != T(0);
      if (!has_pos) cols.b = min(cols.b, k);
    }
    if (by_score) {
      offer(cols, improving ? div_rn(mul_rn(c, c), p.gamma[k]) : -inf, k, true);
    } else if (p.max_inc) {
      T ratio = inf;
      for (int g = 0; g < p.scan_chunks; ++g) {
        const T q = p.scan[(long long)g * n + k];
        if (!is_nan(ratio) && (is_nan(q) || q < ratio)) ratio = q;
      }
      offer(cols, improving ? (ratio < inf ? mul_rn(-c_eff, ratio) : inf) : -inf, k, true);
    } else {
      offer(cols, c_eff, k, false);
    }
  }
  cols = block_reduce(cols, scratch, mx);
  if (threadIdx.x != 0) return;
  const bool has_improving = cols.a != BIG_I;
  const bool has_elig = cleanup && cols.b != BIG_I;
  const int j_price = use_bland ? (has_improving ? cols.a : n - 1) : cols.i;
  const bool phase1_done = phase == 1 && !has_improving;
  const bool infeasible = phase1_done && -p.tab[(long long)N + N - 1] > p.infeas_tol;
  rec[CLEANUP] = cleanup;
  rec[R_D] = r_d;
  rec[HAS_ELIG] = has_elig;
  rec[J] = cleanup ? (has_elig ? cols.b : n - 1) : j_price;
  rec[HAS_IMPROVING] = has_improving;
  rec[PHASE1_DONE] = phase1_done;
  rec[INFEASIBLE] = infeasible;
  rec[TO_PHASE2] = phase1_done && !infeasible;
  rec[PRICING_PIVOT] = has_improving && !cleanup && !phase1_done;
  rec[CROW_OK] = finite_val(cols.s);
  rec[RETIRE] = cleanup && !has_elig;
  rec[RAY] = scan_tick && cols.b != BIG_I;
}

// ---------------------------------------------------------------------------
// ratio: the ratio test, the pivot, the snapshot
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) ratio_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int M = p.M, N = p.N, m = p.M - 2;
  const int j = rec[J], r_d = rec[R_D], phase = rec[PHASE];
  const bool use_bland = rec[BLAND] != 0 || p.bland_rule;
  const bool cleanup = rec[CLEANUP] != 0, has_elig = rec[HAS_ELIG] != 0;
  const bool pricing_pivot = rec[PRICING_PIVOT] != 0;

  // over column j (common.cuh's ratio_row)
  bool has_ratio = false;
  int r_price = 0;
  if (pricing_pivot) {
    const T* col = p.tab + 2LL * N;
    r_price = ratio_row(col + j, N, col + (N - 1), N, p.basis, m, p.piv_tol, use_bland, p.max_piv,
                        scratch, has_ratio);
  }
  const bool do_cleanup = cleanup && has_elig;
  const bool do_pricing = pricing_pivot && has_ratio;
  const bool do_pivot = do_cleanup || do_pricing;
  const int r = do_cleanup ? r_d : r_price;
  const int leaving = p.basis[r];
  int rg, jp;
  const bool pv = pivot_snapshot(p.tab, M, N, do_pivot, r, j, p.basis[0], p.snap, p.snap + M,
                                 scratch, rg, jp);
  if (threadIdx.x != 0) return;
  rec[DO_PIVOT] = do_pivot;
  rec[DO_PRICING] = do_pricing;
  rec[R] = r;
  rec[LEAVING] = leaving;
  rec[PV] = pv;
  rec[RG] = rg;
  rec[JP] = jp;
  rec[UNBOUNDED] = pricing_pivot && !has_ratio && phase == 2;
  rec[FAILED1] = pricing_pivot && !has_ratio && phase != 2;
  p.vals[PIV] = p.tab[(long long)(r + 2) * N + j];
  if (p.devex) p.vals[GAMMA_Q] = p.gamma[j];
}

// ---------------------------------------------------------------------------
// update: the pivot, in place
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(GRID_THREADS) update_kernel(Params<T> p) {
  const int* rec = p.rec;
  if (!live(rec, p.max_iters) || !rec[PV]) return;
  const int M = p.M, N = p.N;
  const int rg = rec[RG], jp = rec[JP];
  const T* colj = p.snap;
  const T* prow = p.snap + M;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  for (int i0 = blockIdx.y * UPD_ROWS; i0 < M; i0 += gridDim.y * UPD_ROWS) {
    const int i1 = min(M, i0 + UPD_ROWS);
    for (int i = i0; i < i1; ++i) {
      T* e = p.tab + (long long)i * N + k;
      *e = pivoted(colj, prow, rg, jp, i, k, *e);
    }
  }
}

// ---------------------------------------------------------------------------
// finish: basis, retire, devex weights, stall and Bland, phase, status
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) finish_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int M = p.M, N = p.N, n = p.N - 1;
  // every field read before the block's first barrier; thread 0 writes
  // the record after the last
  const int phase = rec[PHASE], niter = rec[NITER], r = rec[R], j = rec[J], r_d = rec[R_D];
  const int jp = rec[JP], leaving = rec[LEAVING];
  int stuck = rec[STUCK];
  bool bland = rec[BLAND] != 0;
  const bool do_pivot = rec[DO_PIVOT], do_pricing = rec[DO_PRICING];
  const bool to_phase2 = rec[TO_PHASE2], retire = rec[RETIRE], crow_ok = rec[CROW_OK];
  const bool infeasible = rec[INFEASIBLE] || rec[FAILED1];
  const bool unbounded = rec[UNBOUNDED] || rec[RAY];
  const bool finished_opt = phase == 2 && !rec[HAS_IMPROVING] && !rec[CLEANUP];
  T last_z = p.vals[LAST_Z];

  // the devex weights in place (v: their NaN-first maximum; alpha is the
  // post-pivot row r), the sum of the post-step |b| (s)
  Red<T> x = red_identity<T>(true);
  if (p.devex)
    devex_weights(p.gamma, p.snap + M, n, jp, leaving, do_pricing, p.vals[GAMMA_Q], p.vals[PIV],
                  x);
  for (int i = 2 + threadIdx.x; i < M; i += blockDim.x)
    x.s = add_rn(x.s, T(fabs(p.tab[(long long)i * N + N - 1])));
  x = block_reduce(x, scratch, true);
  if (p.devex && (x.v > p.reset_above || to_phase2))
    for (int k = threadIdx.x; k < n; k += blockDim.x) p.gamma[k] = T(1);
  if (to_phase2)
    for (int k = threadIdx.x; k < n; k += blockDim.x) p.act[k] = p.act[k] && !p.art[k];
  if (threadIdx.x != 0) return;

  // stall and the Bland switch against the current objective
  const T z = -p.tab[(phase == 1 ? (long long)N : 0LL) + N - 1];
  if (do_pricing) {
    stuck = sub_rn(last_z, z) > p.degen_tol ? 0 : stuck + 1;
    last_z = z;
  }
  bland = bland || stuck >= p.stall_limit;
  int new_phase = phase;
  if (to_phase2) {
    new_phase = 2;
    stuck = 0;
    last_z = pos_inf<T>();
  }
  const bool finite_ok = finite_val(z) && finite_val(x.s) && crow_ok;
  const int status = !finite_ok ? ST_NUMERIC
                     : infeasible ? ST_INFEASIBLE
                     : unbounded  ? ST_UNBOUNDED
                     : finished_opt ? ST_OPTIMAL
                                    : ST_RUNNING;
  if (do_pivot) p.basis[r] = j;
  // a retire pivots nowhere: the basis is the pre-step one
  if (retire) p.art[p.basis[r_d]] = 0;
  p.vals[LAST_Z] = last_z;
  rec[PHASE] = new_phase;
  rec[STUCK] = stuck;
  rec[BLAND] = bland;
  rec[NITER] = niter + do_pivot;
  rec[STATUS] = status;
}

// ---------------------------------------------------------------------------
// the dual walk: price (the leaving row), ratio (the entering column and
// the snapshot), finish (basis, stall, status); its update is update_kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) dual_price_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int N = p.N, m = p.M - 2, n = p.N - 1;
  // over the rows: the NaN-first argmin of b (v, i), the first row below
  // -feas_tol (a); over the active columns: the sum of the pre-step |c| (s)
  Red<T> x = red_identity<T>(false);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const T bi = p.tab[(long long)(i + 2) * N + N - 1];
    if (bi < -p.feas_tol) x.a = min(x.a, i);
    offer(x, bi, i, false);
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    if (p.act[k]) x.s = add_rn(x.s, T(fabs(p.tab[k])));
  x = block_reduce(x, scratch, false);
  if (threadIdx.x != 0) return;
  const bool feasible = x.a == BIG_I;
  rec[FEASIBLE] = feasible;
  rec[R] = rec[BLAND] ? (feasible ? m - 1 : x.a) : x.i;
  rec[CROW_OK] = finite_val(x.s);
}

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) dual_ratio_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int M = p.M, N = p.N, n = p.N - 1;
  const int r = rec[R];
  const bool feasible = rec[FEASIBLE] != 0;
  // over the columns eligible on row r (active, below -piv_tol): the
  // NaN-first argmin of c_j / -T[r, j] (v, i), the first of them (a). A NaN
  // minimum leaves no tie, so the entering column is then 0, as with none.
  const T* row = p.tab + (long long)(r + 2) * N;
  Red<T> x = red_identity<T>(false);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const T a = row[k];
    if (p.act[k] && a < -p.piv_tol) {
      x.a = min(x.a, k);
      offer(x, div_rn(p.tab[k], -a), k, false);
    }
  }
  x = block_reduce(x, scratch, false);
  const bool has_elig = x.a != BIG_I;
  const int j = has_elig && !is_nan(x.v) ? x.i : 0;
  const bool do_pivot = !feasible && has_elig;
  int rg, jp;
  const bool pv = pivot_snapshot(p.tab, M, N, do_pivot, r, j, p.basis[0], p.snap, p.snap + M,
                                 scratch, rg, jp);
  if (threadIdx.x != 0) return;
  rec[HAS_ELIG] = has_elig;
  rec[J] = j;
  rec[INFEASIBLE] = !feasible && !has_elig;
  rec[DO_PIVOT] = do_pivot;
  rec[PV] = pv;
  rec[RG] = rg;
  rec[JP] = jp;
}

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) dual_finish_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int M = p.M, N = p.N;
  const int r = rec[R], j = rec[J], niter = rec[NITER];
  int stuck = rec[STUCK];
  bool bland = rec[BLAND] != 0;
  const bool do_pivot = rec[DO_PIVOT], feasible = rec[FEASIBLE];
  const bool infeasible = rec[INFEASIBLE], crow_ok = rec[CROW_OK];
  T last_z = p.vals[LAST_Z];
  // the sum of the post-step |b| (s)
  Red<T> x = red_identity<T>(false);
  for (int i = 2 + threadIdx.x; i < M; i += blockDim.x)
    x.s = add_rn(x.s, T(fabs(p.tab[(long long)i * N + N - 1])));
  x = block_reduce(x, scratch, false);
  if (threadIdx.x != 0) return;

  // stall: the dual objective does not increase
  const T z = -p.tab[N - 1];
  if (do_pivot) {
    stuck = sub_rn(z, last_z) > p.degen_tol ? 0 : stuck + 1;
    last_z = z;
  }
  bland = bland || stuck >= p.stall_limit;
  const bool finite_ok = finite_val(z) && finite_val(x.s) && crow_ok;
  const int status = !finite_ok ? ST_NUMERIC
                     : infeasible ? ST_INFEASIBLE
                     : feasible   ? ST_OPTIMAL
                                  : ST_RUNNING;
  if (do_pivot) p.basis[r] = j;
  p.vals[LAST_Z] = last_z;
  rec[STUCK] = stuck;
  rec[BLAND] = bland;
  rec[NITER] = niter + do_pivot;
  rec[STATUS] = status;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
Params<T> make_params(const long long* a, const int* in, const double* tol) {
  Params<T> p;
  p.tab = (T*)a[A_T];
  p.basis = (int*)a[A_BASIS];
  p.act = (unsigned char*)a[A_ACT];
  p.art = (unsigned char*)a[A_ART];
  p.gamma = (T*)a[A_GAMMA];
  p.rec = (int*)a[A_INTS];
  p.vals = (T*)a[A_VALS];
  p.snap = (T*)a[A_SNAP];
  p.scan = (T*)a[A_SCAN];
  p.M = in[I_M];
  p.N = in[I_N];
  p.stall_limit = in[I_STALL];
  p.max_iters = in[I_MAXIT];
  p.ray_every = in[I_RAY_EVERY];
  p.scan_chunks = in[I_SCAN_CHUNKS];
  p.devex = in[I_WALK] == W_DEVEX;
  p.dual = in[I_WALK] == W_DUAL;
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

// the walks with a column pass: the greatest increase and devex (the dual
// walk has none)
template <typename T> bool scans(const Params<T>& p) { return p.devex || p.max_inc; }

template <typename T>
bool valid(const Params<T>& p) {
  return p.M >= 3 && p.N >= 2 && p.tab && p.basis && p.act && p.art && p.rec && p.vals &&
         p.snap && (!p.devex || p.gamma) && (!scans(p) || p.scan) && p.ray_every >= 1 &&
         p.scan_chunks >= 1 && p.scan_chunks <= 65535;
}

template <typename T>
int enqueue(const Params<T>& p, int stage, cudaStream_t s) {
  const int n = p.N - 1;
  switch (stage) {
    case S_SCAN:
      if (!scans(p)) return (int)cudaErrorInvalidValue;
      scan_kernel<T><<<dim3((n + GRID_THREADS - 1) / GRID_THREADS, p.scan_chunks), GRID_THREADS,
                       0, s>>>(p);
      break;
    case S_PRICE:
      if (p.dual)
        dual_price_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      else
        price_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    case S_RATIO:
      if (p.dual)
        dual_ratio_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      else
        ratio_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    case S_UPDATE: {
      const int gy = std::min((p.M + UPD_ROWS - 1) / UPD_ROWS, 65535);
      update_kernel<T><<<dim3((p.N + GRID_THREADS - 1) / GRID_THREADS, gy), GRID_THREADS, 0, s>>>(
          p);
      break;
    }
    case S_FINISH:
      if (p.dual)
        dual_finish_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      else
        finish_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int rank1_steps(const long long* a, const int* in, const double* tol, int nsteps, void* stream) {
  const Params<T> p = make_params<T>(a, in, tol);
  if (!valid(p) || nsteps < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int first = scans(p) ? S_SCAN : S_PRICE;
  for (int step = 0; step < nsteps; ++step)
    for (int stage = first; stage < S_NSTAGES; ++stage) {
      const int err = enqueue(p, stage, s);
      if (err) return err;
    }
  return 0;
}

template <typename T>
int rank1_stage(const long long* a, const int* in, const double* tol, void* stream) {
  const Params<T> p = make_params<T>(a, in, tol);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  return enqueue(p, in[I_STAGE], (cudaStream_t)stream);
}

}  // namespace rk1
}  // namespace tpulp

extern "C" int tpulp_rank1_steps_f32(const long long* a, const int* in, const double* tol,
                                     int nsteps, void* stream) {
  return tpulp::rk1::rank1_steps<float>(a, in, tol, nsteps, stream);
}
extern "C" int tpulp_rank1_steps_f64(const long long* a, const int* in, const double* tol,
                                     int nsteps, void* stream) {
  return tpulp::rk1::rank1_steps<double>(a, in, tol, nsteps, stream);
}
extern "C" int tpulp_rank1_stage_f32(const long long* a, const int* in, const double* tol,
                                     void* stream) {
  return tpulp::rk1::rank1_stage<float>(a, in, tol, stream);
}
extern "C" int tpulp_rank1_stage_f64(const long long* a, const int* in, const double* tol,
                                     void* stream) {
  return tpulp::rk1::rank1_stage<double>(a, in, tol, stream);
}
