// bounded price / ratio / update / finish: the solo bounded-variable
// simplex step (solve/bounded.py::bounded_simplex_step) as four
// stream-ordered launches that read and write a walk record on the card.
//
// Replaces no Pallas kernel: in tpulp the walk is XLA's compiled
// ``lax.while_loop`` over ``bounded_simplex_step`` (tpulp/solve/bounded.py:
// 86-276 the step, 278-307 the driver), a few fused kernels a step. The
// port ran the step as ~250 small eager kernels and two FMA launches, with
// ~5 ms of host time a step for ~0.5 ms on the card.
//
// What bounds it on the H100: the update reads and writes the whole
// tableau once a step (2 x 1026 x 3073 x 8 B at the box LP's f64 shape:
// 15.1 us at 3.35 TB/s; the 25 MB tableau also fits the 50 MB L2). The
// three other launches work on vectors (<= n columns or <= m rows), one
// block each, and are bound by the latency of their block reductions.
//
// Design: the step is cut at its three global dependencies (the entering
// column, the leaving row, the pivot) into ordinary launches; the
// stream's order is the barrier between them, so no launch is
// cooperative and no grid barrier is needed.
// - price (one block): the clean-up scan, pricing (Dantzig's argmin of
//   c_eff, or devex's argmax of c^2 / gamma, with the Bland switch), the
//   phase bookkeeping and the finiteness sum of the pre-step pricing row;
// - ratio (one block): the three-way ratio test (a lower hit, then an
//   upper hit, then the entering flip, on exact ties), the pivot and the
//   flip, and a snapshot of the pivot's column, its row over the pivot
//   and the flip's column into scratch: with it the update runs in place;
// - update (the grid, elementwise): fma(-col[i], prow[k], T[i, k]), the
//   pivot row set to prow, the entering column to the exact unit vector,
//   the RHS fma(-Tn[i, fcol], uf, Tn[i, -1]) from the snapshot, and the
//   flipped column negated. A step that pivots nowhere skips the plain
//   step's redirected pivot on (row 2, basis[0]) where the ratio launch
//   found it an exact no-op (row 2 finite, that column the unit vector);
// - finish (one block): the basis, the at-upper flags, the devex weights
//   and their resets, the stall counter and the Bland switch, the phase
//   change, the finiteness sums, the status and the counters.
// Every launch returns at once unless the record's status is RUNNING and
// niter < max_iters, so steps enqueued past the walk's exit are no-ops.
// The shared parts (the status gate, the clean-up scan, the pricing and
// the three-way ratio test, the snapshot with the redirected pivot, the
// pivoted entry, the devex weights) live in common.cuh, which rank1.cu
// and lanes.cu's lane_bounded share. The arithmetic is the plain step's
// (lanes.cu's rules): one rounding per product in the decisions (*_rn),
// IEEE division, prow = row * (1 / piv),
// comparisons in the tableau's type against tolerances rounded to it,
// torch's NaN-first argmin/argmax with first-index ties and fixed-order
// sums (common.cuh's block reductions).

#include <algorithm>

#include "common.cuh"

namespace tpulp {
namespace bnd {

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
constexpr int ONE_BLOCK = 1024;  // threads of the single-block launches
constexpr int UPD_THREADS = 256, UPD_ROWS = 8;

// the record (tpulp_torch/kernels/bounded.py): int32 fields, values in
// the tableau's type, the wrapper's argument arrays
enum Field {
  PHASE, STATUS, NITER, STUCK, BLAND, N_ENTER, N_UPHIT,
  CLEANUP, R_D, HAS_ELIG, J, HAS_IMPROVING, PHASE1_DONE, INFEASIBLE, TO_PHASE2, PRICING_PIVOT,
  CROW_OK, RETIRE,
  DO_PIVOT, DO_PRICE, DO_FLIP, DO_FLIP_ENTER, KIND_FLIP, R, LEAVING, FCOL, PV, RG, JP, UNBOUNDED,
  FAILED1, NI = 32
};
enum Val { LAST_Z, UF, PIV, GAMMA_Q, NV };
enum Arg { A_T, A_BASIS, A_ACT, A_ART, A_AT_UPPER, A_UPPER, A_GAMMA, A_INTS, A_VALS, A_SNAP, A_NARGS };
enum Int { I_M, I_N, I_STALL, I_MAXIT, I_DEVEX, I_STAGE, I_NINTS };
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_NTOLS };

template <typename T>
struct Params {
  T* tab;
  int* basis;
  unsigned char* act;
  unsigned char* art;
  unsigned char* at_upper;
  const T* upper;
  T* gamma;  // devex only
  int* rec;
  T* vals;
  T* snap;  // column jp (M) | prow (N) | column fcol (M)
  int M, N, stall_limit, max_iters;
  bool devex;
  // the tolerances rounded to T, as torch rounds a Python float against a
  // tensor of T
  T opt_tol, piv_tol, degen_tol, infeas_tol, reset_above;
};

// ---------------------------------------------------------------------------
// price: clean-up scan, pricing, phase bookkeeping
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) price_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int N = p.N, m = p.M - 2, n = p.N - 1;
  const int phase = rec[PHASE];
  const bool bland = rec[BLAND] != 0;

  // the first row whose basic column is artificial
  const int ra = first_artificial_row<T>(p.basis, p.art, m, scratch);
  const bool cleanup = ra != BIG_I && phase == 2;
  const int r_d = ra != BIG_I ? ra : 0;

  // over the columns: Dantzig's argmin of c_eff or devex's argmax of the
  // score (v, i); the first improving column (a); the first clean-up-
  // eligible column (b); the sum of |crow| over the active columns (s)
  const Red<T> cols = bounded_price(p.tab + (phase == 1 ? N : 0), p.tab + (long long)(r_d + 2) * N,
                                    p.act, p.art, p.gamma, n, p.devex, p.opt_tol, p.piv_tol,
                                    scratch);
  if (threadIdx.x != 0) return;
  const bool has_improving = cols.a != BIG_I;
  const bool has_elig = cols.b != BIG_I;
  const int j_price = bland ? (has_improving ? cols.a : n - 1) : cols.i;
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
}

// ---------------------------------------------------------------------------
// ratio: the three-way ratio test, the pivot and the flip, the snapshot
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(ONE_BLOCK) ratio_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int M = p.M, N = p.N, m = p.M - 2;
  const int j = rec[J], r_d = rec[R_D], phase = rec[PHASE];
  const bool bland = rec[BLAND] != 0, cleanup = rec[CLEANUP] != 0;
  const bool has_elig = rec[HAS_ELIG] != 0, pricing_pivot = rec[PRICING_PIVOT] != 0;

  // the three-way ratio test: the kind and the leaving row
  const BoundedRatio rt =
      bounded_ratio(p.tab, N, m, j, p.basis, p.upper, p.piv_tol, bland, scratch);
  const bool has_ratio = rt.has_ratio, kind_up = rt.kind_up, kind_flip = rt.kind_flip;
  const int r_price = rt.r_price;

  const bool do_cleanup = cleanup && has_elig;
  const bool do_price = pricing_pivot && has_ratio;
  const bool do_pivot = do_cleanup || (do_price && !kind_flip);
  const bool do_flip_enter = do_price && kind_flip;
  const int r = do_cleanup ? r_d : r_price;
  const int leaving = p.basis[r];
  const bool do_flip = (do_price && kind_up && !cleanup) || do_flip_enter;
  const int fcol = do_flip_enter ? j : leaving;

  // the pivot of the update: the real one, or the plain step's redirected
  // one on (row 2, basis[0]) unless that is an exact no-op
  T* colf = p.snap + M + N;
  int rg, jp;
  const bool pv = pivot_snapshot(p.tab, M, N, do_pivot, r, j, p.basis[0], p.snap, p.snap + M,
                                 scratch, rg, jp);
  for (int i = threadIdx.x; i < M; i += blockDim.x) colf[i] = p.tab[(long long)i * N + fcol];
  if (threadIdx.x != 0) return;
  const bool in_phase2 = phase == 2;
  rec[DO_PIVOT] = do_pivot;
  rec[DO_PRICE] = do_price;
  rec[DO_FLIP] = do_flip;
  rec[DO_FLIP_ENTER] = do_flip_enter;
  rec[KIND_FLIP] = kind_flip;
  rec[R] = r;
  rec[LEAVING] = leaving;
  rec[FCOL] = fcol;
  rec[PV] = pv;
  rec[RG] = rg;
  rec[JP] = jp;
  rec[UNBOUNDED] = pricing_pivot && !has_ratio && in_phase2;
  rec[FAILED1] = pricing_pivot && !has_ratio && !in_phase2;
  p.vals[UF] = do_flip ? p.upper[fcol] : T(0);
  p.vals[PIV] = p.tab[(long long)(r + 2) * N + j];
  if (p.devex) p.vals[GAMMA_Q] = p.gamma[j];
}

// ---------------------------------------------------------------------------
// update: the pivot, the flip's RHS and the flipped column, in place
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(UPD_THREADS) update_kernel(Params<T> p) {
  const int* rec = p.rec;
  if (!live(rec, p.max_iters)) return;
  const int M = p.M, N = p.N;
  const bool pv = rec[PV] != 0, flip = rec[DO_FLIP] != 0;
  const int rg = rec[RG], jp = rec[JP], fcol = rec[FCOL];
  const T uf = p.vals[UF];
  const T* colj = p.snap;
  const T* prow = p.snap + M;
  const T* colf = p.snap + M + N;
  if (!pv) {
    // no pivot: only the RHS and the flipped column move
    const long long nthreads = (long long)gridDim.x * gridDim.y * blockDim.x;
    for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x;
         i < M; i += nthreads) {
      T* row = p.tab + i * N;
      const T tf = colf[i];
      row[N - 1] = fma(-tf, uf, row[N - 1]);
      if (flip) row[fcol] = -tf;
    }
    return;
  }
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N) return;
  for (int i0 = blockIdx.y * UPD_ROWS; i0 < M; i0 += gridDim.y * UPD_ROWS) {
    const int i1 = min(M, i0 + UPD_ROWS);
    for (int i = i0; i < i1; ++i) {
      T* e = p.tab + (long long)i * N + k;
      T v = pivoted(colj, prow, rg, jp, i, k, *e);
      if (k == N - 1)
        v = fma(-pivoted(colj, prow, rg, jp, i, fcol, colf[i]), uf, v);
      else if (flip && k == fcol)
        v = -v;
      *e = v;
    }
  }
}

// ---------------------------------------------------------------------------
// finish: basis, flags, devex weights, stall and Bland, phase, status
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
  const int jp = rec[JP], leaving = rec[LEAVING], fcol = rec[FCOL];
  int stuck = rec[STUCK];
  bool bland = rec[BLAND] != 0;
  const bool do_pivot = rec[DO_PIVOT], do_price = rec[DO_PRICE], do_flip = rec[DO_FLIP];
  const bool do_flip_enter = rec[DO_FLIP_ENTER], kind_flip = rec[KIND_FLIP];
  const bool to_phase2 = rec[TO_PHASE2], retire = rec[RETIRE], crow_ok = rec[CROW_OK];
  const bool infeasible = rec[INFEASIBLE] || rec[FAILED1], unbounded = rec[UNBOUNDED];
  const bool finished_opt = phase == 2 && !rec[HAS_IMPROVING] && !rec[CLEANUP];
  const int n_enter = rec[N_ENTER], n_uphit = rec[N_UPHIT];
  T last_z = p.vals[LAST_Z];

  // the devex weights in place (v: their NaN-first maximum; alpha is the
  // post-pivot row r before the flip), the sum of the post-step |b| (s)
  Red<T> x = red_identity<T>(true);
  if (p.devex)
    devex_weights(p.gamma, p.snap + M, n, jp, leaving, do_price && !kind_flip, p.vals[GAMMA_Q],
                  p.vals[PIV], x);
  for (int i = 2 + threadIdx.x; i < M; i += blockDim.x)
    x.s = add_rn(x.s, T(fabs(p.tab[(long long)i * N + N - 1])));
  x = block_reduce(x, scratch, true);
  if (p.devex && (x.v > p.reset_above || to_phase2))
    for (int k = threadIdx.x; k < n; k += blockDim.x) p.gamma[k] = T(1);
  if (to_phase2)
    for (int k = threadIdx.x; k < n; k += blockDim.x) p.act[k] = p.act[k] && !p.art[k];
  if (threadIdx.x != 0) return;

  const bool act = do_pivot || do_flip_enter;
  const T z = -p.tab[(phase == 1 ? (long long)N : 0LL) + N - 1];
  if (do_price && act) {
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
  if (do_flip) p.at_upper[fcol] = !p.at_upper[fcol];
  if (retire) p.art[p.basis[r_d]] = 0;
  p.vals[LAST_Z] = last_z;
  rec[PHASE] = new_phase;
  rec[STUCK] = stuck;
  rec[BLAND] = bland;
  rec[NITER] = niter + act;
  rec[N_ENTER] = n_enter + do_flip_enter;
  rec[N_UPHIT] = n_uphit + (do_pivot && do_flip);
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
  p.at_upper = (unsigned char*)a[A_AT_UPPER];
  p.upper = (const T*)a[A_UPPER];
  p.gamma = (T*)a[A_GAMMA];
  p.rec = (int*)a[A_INTS];
  p.vals = (T*)a[A_VALS];
  p.snap = (T*)a[A_SNAP];
  p.M = in[I_M];
  p.N = in[I_N];
  p.stall_limit = in[I_STALL];
  p.max_iters = in[I_MAXIT];
  p.devex = in[I_DEVEX] != 0;
  p.opt_tol = (T)tol[D_OPT];
  p.piv_tol = (T)tol[D_PIV];
  p.degen_tol = (T)tol[D_DEGEN];
  p.infeas_tol = (T)tol[D_INFEAS];
  p.reset_above = (T)1e8;  // kernels/bounded.py: DEVEX_RESET_ABOVE
  return p;
}

template <typename T>
bool valid(const Params<T>& p) {
  return p.M >= 3 && p.N >= 2 && p.tab && p.basis && p.act && p.art && p.at_upper && p.upper &&
         p.rec && p.vals && p.snap && (!p.devex || p.gamma);
}

template <typename T>
int enqueue(const Params<T>& p, int stage, cudaStream_t s) {
  switch (stage) {
    case 0:
      price_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    case 1:
      ratio_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    case 2: {
      const int gy = std::min((p.M + UPD_ROWS - 1) / UPD_ROWS, 65535);
      update_kernel<T><<<dim3((p.N + UPD_THREADS - 1) / UPD_THREADS, gy), UPD_THREADS, 0, s>>>(p);
      break;
    }
    case 3:
      finish_kernel<T><<<1, ONE_BLOCK, 0, s>>>(p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bounded_steps(const long long* a, const int* in, const double* tol, int nsteps, void* stream) {
  const Params<T> p = make_params<T>(a, in, tol);
  if (!valid(p) || nsteps < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  for (int step = 0; step < nsteps; ++step)
    for (int stage = 0; stage < 4; ++stage) {
      const int err = enqueue(p, stage, s);
      if (err) return err;
    }
  return 0;
}

template <typename T>
int bounded_stage(const long long* a, const int* in, const double* tol, void* stream) {
  const Params<T> p = make_params<T>(a, in, tol);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  return enqueue(p, in[I_STAGE], (cudaStream_t)stream);
}

}  // namespace bnd
}  // namespace tpulp

extern "C" int tpulp_bounded_steps_f32(const long long* a, const int* in, const double* tol,
                                       int nsteps, void* stream) {
  return tpulp::bnd::bounded_steps<float>(a, in, tol, nsteps, stream);
}
extern "C" int tpulp_bounded_steps_f64(const long long* a, const int* in, const double* tol,
                                       int nsteps, void* stream) {
  return tpulp::bnd::bounded_steps<double>(a, in, tol, nsteps, stream);
}
extern "C" int tpulp_bounded_stage_f32(const long long* a, const int* in, const double* tol,
                                       void* stream) {
  return tpulp::bnd::bounded_stage<float>(a, in, tol, stream);
}
extern "C" int tpulp_bounded_stage_f64(const long long* a, const int* in, const double* tol,
                                       void* stream) {
  return tpulp::bnd::bounded_stage<double>(a, in, tol, stream);
}
