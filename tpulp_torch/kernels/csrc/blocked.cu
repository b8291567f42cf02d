// blocked cleanup / price / column / ratio / row / finish / ray: the solo
// rank-K blocked simplex engine (solve/blocked.py: the eta pivot
// _blocked_pivot, and the per-block ray scan of run_simplex_blocked) as
// stream-ordered launches that read and write a walk record on the card.
// The rank-K flush between the blocks is B1 (flush.cu), launched by the
// host between a block's pivot slots and its ray launch.
//
// Replaces no Pallas kernel: in tpulp the engine is XLA's compiled
// lax.while_loop over _blocked_pivot (tpulp/solve/blocked.py:61-245, the
// driver 247-315), a few fused kernels a pivot. The port ran the pivot as
// ~200 small eager kernels and three FMA launches, 2.2-2.6 ms of host time a
// pivot.
//
// What bounds it on the H100: a pivot slot touches no tableau-sized data.
// It reads one column and one row of T0 and the eta factors' slots written
// so far, K (M + N) elements at most (64 x (514 + 1025) x 8 B = 0.79 MB at
// bench.py's 512 x 512 f64: 0.24 us at 3.35 TB/s), and the running vectors.
// Each launch is a small grid or one block, so a slot is set by the launch
// latency of its six launches and the latency of their block reductions,
// not by bytes or operations.
//
// Design: the retired rank-1 step's, on _blocked_pivot's arithmetic. The pivot is cut at its
// global dependencies (the clean-up row's eligible column, pricing, the
// entering column, the leaving row, the pivot row) into ordinary launches;
// the stream's order is the barrier between them, so no launch is
// cooperative:
// - cleanup (grid over the columns; returns at once unless a basic
//   artificial remains in phase 2): the clean-up row T0[r_d + 2] + sum_k
//   U[k, r_d + 2] V[k] and, per block, its first eligible column;
// - price (one block): the eligible column from those partials in block
//   order, the retire, pricing on the maintained row1 / row0 (Dantzig's
//   NaN-first argmin, devex's argmax of c^2 / gamma, Bland's first improving
//   column), the phase bookkeeping and the finiteness of the pre-step
//   pricing row; the entering column j;
// - column (grid over the rows): colj = T0[:, j] + sum_k V[k, j] U[k];
// - ratio (one block): common.cuh's ratio_row over colj[2:] and bvec[2:],
//   the pivot's slot flag act (the budget is in it), the row r and the
//   pivot element;
// - row (grid over max(M, N)): vrow = (T0[r + 2] + sum_k U[k, r + 2] V[k])
//   * act, w = (e_{r+2} - colj) / piv * act; row0, row1 and bvec by one fma
//   each, the devex weights, and per block the NaN-first maximum of the
//   weights and the sum of the post-step |bvec[2:]| (each block repeats the
//   scalar vrow[N - 1] in the same order);
// - finish (one block): the eta slot t (U[t] = w, V[t] = vrow), the partials
//   in block order, the basis, the retire, the devex resets (past
//   reset_above, then at the phase change), the stall counter and the Bland
//   switch, the phase change, the status in status_select's precedence, t
//   and niter, and the first row whose basic column is artificial (the next
//   slot's clean-up scan);
// - ray (grid; once a block, after B1's flush): the gated ray scan on B1's
//   scan columns (an improving active column with no entry above piv_tol,
//   no artificial basic, phase 2, running), and the next block's carry:
//   row0, row1 and bvec from the flushed T, the etas zero, t = 0. With a
//   lane axis (the batch on blocked_cluster.cu, blockIdx.y = lane, the
//   batched record contiguous with a leading lane axis) it acts only on a
//   lane whose record the block's cluster launch found live (LIVE); a
//   frozen lane keeps its whole record. The solo walk's record is always
//   live (make_record's LIVE, never cleared on a walk that still runs).
// Every slot launch returns at once unless the record's status is RUNNING:
// the eager pivot's own gate. The budget enters as in _blocked_pivot,
// through act (niter < max_iters), so a slot past the budget pivots nowhere
// but still records the verdicts _blocked_pivot records there (an optimal
// or unbounded exit, a phase change, a retire), as tpulp's fori_loop does.
// The arithmetic is the eager pivot's: one rounding per operation (*_rn),
// one fma per running-vector entry, IEEE division, comparisons in the
// tableau's type against tolerances rounded to it, torch's NaN-first
// argmin/argmax with first-index ties. The eta sums run over the slots in
// one fixed order, k = 0 .. t, one fma each (the slots past t are zero:
// they could change only the sign of a zero), accumulated in the
// tableau's type; kernels/blocked.py's plain stages repeat that order, so
// each launch equals its plain stage bit for bit.

#include <algorithm>

#include "common.cuh"

namespace tpulp {
namespace blk {

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
// pricing rules and tie breaks (tpulp_torch.core.state)
constexpr int RULE_BLAND_ = 1, RULE_DEVEX_ = 3, TIE_MAXPIV_ = 1;
constexpr int ONE_BLOCK = 1024;  // threads of the single-block launches
constexpr int GRID_THREADS = 256;
constexpr int MAX_K = 1024;   // eta slots of a block (kernels/blocked.py's MAX_K)
constexpr int RAY_GRID = 1024;  // most blocks of the ray launch (grid-stride)

// the record (tpulp_torch/kernels/blocked.py): int32 fields (the first
// three as common.cuh's REC_*), then one partial a cleanup block; values in
// the tableau's type; the wrapper's argument arrays
enum Field {
  PHASE, STATUS, NITER, STUCK, BLAND, SLOT, ART_ROW,
  CLEANUP, R_D, HAS_ELIG, J, HAS_IMPROVING, INFEASIBLE, TO_PHASE2, PRICING_PIVOT, CROW_OK, RETIRE,
  DO_CLEANUP, DO_PRICING, ACT, R, LEAVING, UNBOUNDED, FAILED1, RAY, LIVE, NI
};
enum Val { LAST_Z, PIV, GAMMA_Q, NV };
enum Arg {
  A_T, A_U, A_V, A_ROW0, A_ROW1, A_BVEC, A_GAMMA, A_BASIS, A_ACT, A_ART, A_INTS, A_VALS,
  A_SCRATCH, A_SCAN, A_NARGS
};
enum Int { I_M, I_N, I_K, I_STALL, I_MAXIT, I_RULE, I_TIE, I_STAGE, I_NINTS };
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_RESET, D_NTOLS };
enum Stage { S_CLEANUP, S_PRICE, S_COLUMN, S_RATIO, S_ROW, S_FINISH, S_RAY, S_NSTAGES };

template <typename T>
struct Params {
  T* tab;  // (M, N) T0, the block-start tableau
  T* U;    // (K, M) eta vectors
  T* V;    // (K, N) pivot rows
  T* row0;
  T* row1;
  T* bvec;
  T* gamma;  // (n,) devex weights (ones unless devex)
  int* basis;
  unsigned char* act;
  unsigned char* art;
  int* rec;
  T* vals;
  T* scratch;       // colj (M) | vrow (N) | G weight maxima | G |b| sums
  const int* scan;  // (2, N) B1's scan columns (the ray launch only)
  int M, N, K, stall_limit, max_iters;
  int G;  // blocks of the row launch: its partials
  bool devex, bland_rule, max_piv;
  // the tolerances rounded to T, as torch rounds a Python float against a
  // tensor of T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, reset_above;
};

// the eager pivot's gate: its status is RUNNING
__device__ __forceinline__ bool running(const int* rec) {
  return rec[REC_STATUS] == WALK_RUNNING;
}

// coef[k] = src[k * ld] for the slots k <= t, by the whole block, into
// shared memory; then a barrier
template <typename T>
__device__ void load_coef(T* coef, const T* src, long long ld, int t) {
  for (int k = threadIdx.x; k <= t; k += blockDim.x) coef[k] = src[k * ld];
  __syncthreads();
}

// sum_{k <= t} coef[k] x[k * ld]: one fma a slot, in slot order
template <typename T>
__device__ __forceinline__ T eta_dot(const T* coef, const T* x, long long ld, int t) {
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k <= t; ++k) acc = fma(coef[k], x[k * ld], acc);
  return acc;
}

// w[i] = (e_rg[i] - colj[i]) / safe_piv * actf, as the eager pivot rounds it
template <typename T>
__device__ __forceinline__ T w_at(const T* colj, int i, int rg, T spiv, T actf) {
  return mul_rn(div_rn(sub_rn(i == rg ? T(1) : T(0), colj[i]), spiv), actf);
}

// the slot being written this block: rec[SLOT] < K on every slot of a block
// (a block has K slots); a misuse past K sums over the K and writes no eta
__device__ __forceinline__ int slot_of(const int* rec, int K) { return min(rec[SLOT], K - 1); }

// ---------------------------------------------------------------------------
// cleanup: the clean-up row's first eligible column, per block
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(GRID_THREADS) cleanup_kernel(Params<T> p) {
  __shared__ T coef[MAX_K];
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!running(rec) || rec[ART_ROW] == BIG_I || rec[PHASE] != 2) return;
  const int M = p.M, N = p.N, n = p.N - 1, t = slot_of(rec, p.K);
  const int rg = rec[ART_ROW] + 2;
  load_coef(coef, p.U + rg, M, t);
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  Red<T> x = red_identity<T>(false);
  if (k < n) {
    const T rowd = add_rn(p.tab[(long long)rg * N + k], eta_dot(coef, p.V + k, N, t));
    if (p.act[k] && !p.art[k] && T(fabs(rowd)) > p.piv_tol) x.a = k;
  }
  x = block_reduce(x, scratch, false);
  if (threadIdx.x == 0) rec[NI + blockIdx.x] = x.a;
}

// ---------------------------------------------------------------------------
// price: the retire, pricing, the phase bookkeeping, the entering column
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) price_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!running(rec)) return;
  const int N = p.N, n = p.N - 1, phase = rec[PHASE], ar = rec[ART_ROW];
  const bool cleanup = ar != BIG_I && phase == 2;
  const bool use_bland = rec[BLAND] != 0 || p.bland_rule;
  const T inf = pos_inf<T>();

  // over the columns: the pick (v, i), devex's argmax of c^2 / gamma over
  // the improving columns, else the argmin of c_eff; the first improving
  // column (a); the sum of |crow| over the active columns (s)
  const T* crow = phase == 1 ? p.row1 : p.row0;
  Red<T> cols = red_identity<T>(p.devex);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const bool act = p.act[k] != 0;
    const T c = crow[k];
    const T c_eff = act ? c : inf;
    const bool improving = c_eff < -p.opt_tol;
    if (improving) cols.a = min(cols.a, k);
    if (act) cols.s = add_rn(cols.s, T(fabs(c)));
    if (p.devex)
      offer(cols, improving ? div_rn(mul_rn(c, c), p.gamma[k]) : -inf, k, true);
    else
      offer(cols, c_eff, k, false);
  }
  cols = block_reduce(cols, scratch, p.devex);
  if (threadIdx.x != 0) return;
  // the clean-up row's first eligible column: the cleanup launch's
  // partials, in block order
  int jd = BIG_I;
  if (cleanup)
    for (int b = 0; b < (n + GRID_THREADS - 1) / GRID_THREADS; ++b) jd = min(jd, rec[NI + b]);
  const bool has_elig = jd != BIG_I;
  const bool has_improving = cols.a != BIG_I;
  const int j_price = use_bland ? (has_improving ? cols.a : n - 1) : cols.i;
  const bool phase1_done = phase == 1 && !has_improving;
  const bool infeasible = phase1_done && -p.row1[N - 1] > p.infeas_tol;
  const int j = cleanup ? (has_elig ? jd : n - 1) : j_price;
  rec[CLEANUP] = cleanup;
  rec[R_D] = ar != BIG_I ? ar : 0;
  rec[HAS_ELIG] = has_elig;
  rec[J] = j;
  rec[HAS_IMPROVING] = has_improving;
  rec[INFEASIBLE] = infeasible;
  rec[TO_PHASE2] = phase1_done && !infeasible;
  rec[PRICING_PIVOT] = has_improving && !cleanup && phase != 0;
  rec[CROW_OK] = finite_val(cols.s);
  rec[RETIRE] = cleanup && !has_elig;
  p.vals[GAMMA_Q] = p.gamma[j];
}

// ---------------------------------------------------------------------------
// column: the entering column on the implicit tableau T0 + U^T V
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(GRID_THREADS) column_kernel(Params<T> p) {
  __shared__ T coef[MAX_K];
  const int* rec = p.rec;
  if (!running(rec)) return;
  const int M = p.M, N = p.N, j = rec[J], t = slot_of(rec, p.K);
  load_coef(coef, p.V + j, N, t);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  p.scratch[i] = add_rn(p.tab[(long long)i * N + j], eta_dot(coef, p.U + i, M, t));
}

// ---------------------------------------------------------------------------
// ratio: the ratio test, the slot's pivot
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) ratio_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!running(rec)) return;
  const T* colj = p.scratch;
  const bool use_bland = rec[BLAND] != 0 || p.bland_rule;
  // the eager pivot runs the ratio test whatever the slot does: its row
  // scales the (zero) eta of a slot that pivots nowhere
  bool has_ratio;
  const int r_price = ratio_row(colj + 2, 1, p.bvec + 2, 1, p.basis, p.M - 2, p.piv_tol,
                                use_bland, p.max_piv, scratch, has_ratio);
  if (threadIdx.x != 0) return;
  const bool pricing_pivot = rec[PRICING_PIVOT] != 0, in_phase2 = rec[PHASE] == 2;
  const bool do_cleanup = rec[CLEANUP] != 0 && rec[HAS_ELIG] != 0;
  const bool do_pricing = pricing_pivot && has_ratio;
  const int r = do_cleanup ? rec[R_D] : r_price;
  rec[DO_CLEANUP] = do_cleanup;
  rec[DO_PRICING] = do_pricing;
  rec[ACT] = (do_cleanup || do_pricing) && rec[NITER] < p.max_iters;
  rec[R] = r;
  rec[LEAVING] = p.basis[r];
  rec[UNBOUNDED] = pricing_pivot && !has_ratio && in_phase2;
  rec[FAILED1] = pricing_pivot && !has_ratio && !in_phase2;
  p.vals[PIV] = colj[r + 2];
}

// ---------------------------------------------------------------------------
// row: the pivot row, the running vectors, the devex weights
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(GRID_THREADS) row_kernel(Params<T> p) {
  __shared__ T coef[MAX_K];
  __shared__ T vlast_s;
  __shared__ Red<T> scratch[33];
  const int* rec = p.rec;
  if (!running(rec)) return;
  const int M = p.M, N = p.N, n = p.N - 1, t = slot_of(rec, p.K);
  const bool act = rec[ACT] != 0;
  const bool upd = p.devex && act && rec[DO_PRICING] != 0;
  const int rg = rec[R] + 2, leaving = rec[LEAVING];
  const T actf = act ? T(1) : T(0);
  const T spiv = act ? p.vals[PIV] : T(1);
  const T gq = p.vals[GAMMA_Q];
  const T* colj = p.scratch;
  const T* trow = p.tab + (long long)rg * N;
  load_coef(coef, p.U + rg, M, t);
  // the scalar vrow[N - 1] (bvec's factor), in every block in the same order
  if (threadIdx.x == 0)
    vlast_s = mul_rn(add_rn(trow[N - 1], eta_dot(coef, p.V + (N - 1), N, t)), actf);
  __syncthreads();
  const T vlast = vlast_s;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  // v: the weights' NaN-first maximum; s: the sum of the post-step
  // |bvec[2:]|
  Red<T> x = red_identity<T>(true);
  if (g < N) {
    const T v = mul_rn(add_rn(trow[g], eta_dot(coef, p.V + g, N, t)), actf);
    p.scratch[M + g] = v;
    p.row0[g] = fma(w_at(colj, 0, rg, spiv, actf), v, p.row0[g]);
    p.row1[g] = fma(w_at(colj, 1, rg, spiv, actf), v, p.row1[g]);
    if (p.devex && g < n) {
      // max(gamma, (vrow / piv)^2 gamma_q), then gamma[leaving] = max(gamma_q
      // / piv^2, 1), with torch's NaN rules
      T gk = p.gamma[g];
      if (upd && g == leaving) {
        const T q = div_rn(gq, mul_rn(spiv, spiv));
        gk = is_nan(q) ? q : (q < T(1) ? T(1) : q);
      } else if (upd) {
        const T a = div_rn(v, spiv);
        gk = nan_max(gk, mul_rn(mul_rn(a, a), gq));
      }
      p.gamma[g] = gk;
      offer(x, gk, g, true);
    }
  }
  if (g < M) {
    const T b = fma(w_at(colj, g, rg, spiv, actf), vlast, p.bvec[g]);
    p.bvec[g] = b;
    if (g >= 2) x.s = T(fabs(b));
  }
  x = block_reduce(x, scratch, true);
  if (threadIdx.x == 0) {
    p.scratch[M + N + blockIdx.x] = x.v;
    p.scratch[M + N + p.G + blockIdx.x] = x.s;
  }
}

// ---------------------------------------------------------------------------
// finish: the eta slot, basis, retire, devex resets, stall and Bland, phase,
// status, the next slot's clean-up row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) finish_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  __shared__ T gmax_s, bsum_s;
  int* rec = p.rec;
  if (!running(rec)) return;
  const int M = p.M, N = p.N, n = p.N - 1, m = p.M - 2;
  // every field read before the block's first barrier; thread 0 writes the
  // record after the last
  const int phase = rec[PHASE], niter = rec[NITER], slot = rec[SLOT], r = rec[R], j = rec[J];
  const int r_d = rec[R_D];
  int stuck = rec[STUCK];
  bool bland = rec[BLAND] != 0;
  const bool act = rec[ACT] != 0, do_pricing = rec[DO_PRICING] != 0;
  const bool to_phase2 = rec[TO_PHASE2] != 0, retire = rec[RETIRE] != 0;
  const bool crow_ok = rec[CROW_OK] != 0;
  const bool infeasible = rec[INFEASIBLE] || rec[FAILED1], unbounded = rec[UNBOUNDED] != 0;
  const bool finished_opt = phase == 2 && !rec[HAS_IMPROVING] && !rec[CLEANUP];
  const int rg = r + 2;
  const T actf = act ? T(1) : T(0);
  const T spiv = act ? p.vals[PIV] : T(1);
  T last_z = p.vals[LAST_Z];
  const T* colj = p.scratch;
  const T* vrow = p.scratch + M;

  // the eta slot: U[t] = w, V[t] = vrow
  if (slot < p.K) {
    for (int i = threadIdx.x; i < M; i += blockDim.x)
      p.U[(long long)slot * M + i] = w_at(colj, i, rg, spiv, actf);
    for (int k = threadIdx.x; k < N; k += blockDim.x) p.V[(long long)slot * N + k] = vrow[k];
  }
  if (threadIdx.x == 0) {
    // the row launch's partials, in block order
    T gmax = -pos_inf<T>(), bsum = T(0);
    for (int b = 0; b < p.G; ++b) {
      gmax = nan_max(gmax, p.scratch[M + N + b]);
      bsum = add_rn(bsum, p.scratch[M + N + p.G + b]);
    }
    gmax_s = gmax;
    bsum_s = bsum;
    if (act) p.basis[r] = j;
    // a retire pivots nowhere: the basis is the pre-step one
    if (retire) p.art[p.basis[r_d]] = 0;
  }
  __syncthreads();
  if (p.devex && (gmax_s > p.reset_above || to_phase2))
    for (int k = threadIdx.x; k < n; k += blockDim.x) p.gamma[k] = T(1);
  if (to_phase2)
    for (int k = threadIdx.x; k < n; k += blockDim.x) p.act[k] = p.act[k] && !p.art[k];
  // the next slot's clean-up scan, after the pivot and the retire
  const int ar = first_artificial_row<T>(p.basis, p.art, m, scratch);
  if (threadIdx.x != 0) return;

  // stall and the Bland switch against the current objective
  const T z = -(phase == 1 ? p.row1[N - 1] : p.row0[N - 1]);
  if (do_pricing && act) {
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
  const bool finite_ok = finite_val(z) && finite_val(bsum_s) && crow_ok;
  const int status = !finite_ok ? ST_NUMERIC
                     : infeasible ? ST_INFEASIBLE
                     : unbounded  ? ST_UNBOUNDED
                     : finished_opt ? ST_OPTIMAL
                                    : ST_RUNNING;
  p.vals[LAST_Z] = last_z;
  rec[PHASE] = new_phase;
  rec[STUCK] = stuck;
  rec[BLAND] = bland;
  rec[NITER] = niter + act;
  rec[SLOT] = slot + act;
  rec[ART_ROW] = ar;
  rec[STATUS] = status;
}

// ---------------------------------------------------------------------------
// ray: the per-block ray scan on B1's scan columns, the next block's carry
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(GRID_THREADS) ray_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  const int M = p.M, N = p.N;
  // lane blockIdx.y: its record (NI fields and the cleanup partials) and
  // arrays at the lane times their per-lane extents
  const long long ln = blockIdx.y, K = p.K;
  int* rec = p.rec + ln * (NI + (N - 1 + GRID_THREADS - 1) / GRID_THREADS);
  if (!rec[LIVE]) return;
  const T* tab = p.tab + ln * M * N;
  const int* scan = p.scan + ln * 2 * N;
  T* U = p.U + ln * K * M;
  T* V = p.V + ln * K * N;
  T* row0 = p.row0 + ln * N;
  T* row1 = p.row1 + ln * N;
  T* bvec = p.bvec + ln * M;
  if (blockIdx.x == 0) {
    // an improving active column (scan row 0) with no entry above piv_tol
    // (scan row 1), once no artificial is basic
    Red<T> x = red_identity<T>(false);
    for (int k = threadIdx.x; k < N; k += blockDim.x)
      if (scan[k] && !scan[N + k]) x.a = min(x.a, k);
    x = block_reduce(x, scratch, false);
    if (threadIdx.x == 0) {
      const bool ray = x.a != BIG_I && rec[ART_ROW] == BIG_I && rec[PHASE] == 2 &&
                       rec[STATUS] == ST_RUNNING;
      rec[RAY] = ray;
      if (ray) rec[STATUS] = ST_UNBOUNDED;
      rec[SLOT] = 0;
    }
  }
  // row0, row1 and bvec from the flushed tableau, the etas zero
  const long long KM = K * M, KN = K * N;
  const long long total = KM > KN ? KM : KN, stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    if (e < KM) U[e] = T(0);
    if (e < KN) V[e] = T(0);
    if (e < N) {
      row0[e] = tab[e];
      row1[e] = tab[N + e];
    }
    if (e < M) bvec[e] = tab[e * N + N - 1];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
Params<T> make_params(const long long* a, const int* in, const double* tol) {
  Params<T> p;
  p.tab = (T*)a[A_T];
  p.U = (T*)a[A_U];
  p.V = (T*)a[A_V];
  p.row0 = (T*)a[A_ROW0];
  p.row1 = (T*)a[A_ROW1];
  p.bvec = (T*)a[A_BVEC];
  p.gamma = (T*)a[A_GAMMA];
  p.basis = (int*)a[A_BASIS];
  p.act = (unsigned char*)a[A_ACT];
  p.art = (unsigned char*)a[A_ART];
  p.rec = (int*)a[A_INTS];
  p.vals = (T*)a[A_VALS];
  p.scratch = (T*)a[A_SCRATCH];
  p.scan = (const int*)a[A_SCAN];
  p.M = in[I_M];
  p.N = in[I_N];
  p.K = in[I_K];
  p.stall_limit = in[I_STALL];
  p.max_iters = in[I_MAXIT];
  p.G = (std::max(p.M, p.N) + GRID_THREADS - 1) / GRID_THREADS;
  p.devex = in[I_RULE] == RULE_DEVEX_;
  p.bland_rule = in[I_RULE] == RULE_BLAND_;
  p.max_piv = in[I_TIE] == TIE_MAXPIV_;
  p.opt_tol = (T)tol[D_OPT];
  p.piv_tol = (T)tol[D_PIV];
  p.degen_tol = (T)tol[D_DEGEN];
  p.infeas_tol = (T)tol[D_INFEAS];
  p.reset_above = (T)tol[D_RESET];
  return p;
}

template <typename T>
bool valid(const Params<T>& p) {
  return p.M >= 3 && p.N >= 2 && p.K >= 1 && p.K <= MAX_K && p.tab && p.U && p.V && p.row0 &&
         p.row1 && p.bvec && p.gamma && p.basis && p.act && p.art && p.rec && p.vals && p.scratch;
}

// one launch of ``stage``; the ray launch over ``lanes`` lanes of a batched
// record (1: a solo record)
template <typename T>
int enqueue(const Params<T>& p, int stage, cudaStream_t s, int lanes = 1) {
  const int n = p.N - 1;
  switch (stage) {
    case S_CLEANUP:
      cleanup_kernel<T><<<(n + GRID_THREADS - 1) / GRID_THREADS, GRID_THREADS, 0, s>>>(p);
      break;
    case S_PRICE:
      price_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    case S_COLUMN:
      column_kernel<T><<<(p.M + GRID_THREADS - 1) / GRID_THREADS, GRID_THREADS, 0, s>>>(p);
      break;
    case S_RATIO:
      ratio_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    case S_ROW:
      row_kernel<T><<<p.G, GRID_THREADS, 0, s>>>(p);
      break;
    case S_FINISH:
      finish_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    case S_RAY: {
      if (!p.scan) return (int)cudaErrorInvalidValue;
      const long long e = (long long)p.K * std::max(p.M, p.N);
      const int grid = (int)std::min<long long>((e + GRID_THREADS - 1) / GRID_THREADS, RAY_GRID);
      ray_kernel<T><<<dim3(grid, lanes), GRID_THREADS, 0, s>>>(p);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// nslots pivot slots (six launches each) with no host read; a block has K
template <typename T>
int blocked_steps(const long long* a, const int* in, const double* tol, int nslots,
                  void* stream) {
  const Params<T> p = make_params<T>(a, in, tol);
  if (!valid(p) || nslots < 0 || nslots > p.K) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  for (int slot = 0; slot < nslots; ++slot)
    for (int stage = S_CLEANUP; stage < S_RAY; ++stage) {
      const int err = enqueue(p, stage, s);
      if (err) return err;
    }
  return 0;
}

template <typename T>
int blocked_stage(const long long* a, const int* in, const double* tol, void* stream) {
  const Params<T> p = make_params<T>(a, in, tol);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  return enqueue(p, in[I_STAGE], (cudaStream_t)stream);
}

// the ray launch of every lane of a batched record (each lane's scan
// columns B1's of that lane)
template <typename T>
int blocked_ray_batch(const long long* a, const int* in, const double* tol, int lanes,
                      void* stream) {
  const Params<T> p = make_params<T>(a, in, tol);
  if (!valid(p) || lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  return enqueue(p, S_RAY, (cudaStream_t)stream, lanes);
}

}  // namespace blk
}  // namespace tpulp

extern "C" int tpulp_blocked_steps_f32(const long long* a, const int* in, const double* tol,
                                       int nslots, void* stream) {
  return tpulp::blk::blocked_steps<float>(a, in, tol, nslots, stream);
}
extern "C" int tpulp_blocked_steps_f64(const long long* a, const int* in, const double* tol,
                                       int nslots, void* stream) {
  return tpulp::blk::blocked_steps<double>(a, in, tol, nslots, stream);
}
extern "C" int tpulp_blocked_stage_f32(const long long* a, const int* in, const double* tol,
                                       void* stream) {
  return tpulp::blk::blocked_stage<float>(a, in, tol, stream);
}
extern "C" int tpulp_blocked_stage_f64(const long long* a, const int* in, const double* tol,
                                       void* stream) {
  return tpulp::blk::blocked_stage<double>(a, in, tol, stream);
}
extern "C" int tpulp_blocked_ray_batch_f32(const long long* a, const int* in, const double* tol,
                                           int lanes, void* stream) {
  return tpulp::blk::blocked_ray_batch<float>(a, in, tol, lanes, stream);
}
extern "C" int tpulp_blocked_ray_batch_f64(const long long* a, const int* in, const double* tol,
                                           int lanes, void* stream) {
  return tpulp::blk::blocked_ray_batch<double>(a, in, tol, lanes, stream);
}
