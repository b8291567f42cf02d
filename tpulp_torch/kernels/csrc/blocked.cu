// blocked ray: the per-block ray scan of the solo rank-K blocked engine
// (solve/blocked.py: run_simplex_blocked's _flush after each block of
// _blocked_pivot) and the next block's carry, on a walk record kept on the
// card (kernels/blocked.py's BlockedRecord). The K slots of a block run in
// one launch of blocked_cluster.cu or blocked_grid.cu; B1 (flush.cu) then
// flushes T += U^T V and returns its scan columns, and this launch, once a
// block, ends it.
//
// Replaces no Pallas kernel: in tpulp the ray scan is part of XLA's
// compiled lax.while_loop over the blocks (tpulp/solve/blocked.py:247-315;
// the batch's vmapped loop 335-366).
//
// What bounds it on the H100: it reads B1's two scan columns (2 N int32)
// and T0's rows 0 and 1 and last column, and writes row0, row1, bvec and
// the K (M + N) zeros of the etas: bytes, a few microseconds at the
// blocked engine's shapes.
//
// Design: one grid, grid-stride over the etas; block 0 also reduces the
// scan (an improving active column, scan row 0, with no entry above
// piv_tol, scan row 1) to its first column and applies the gate of
// run_simplex_blocked's _flush (no artificial basic, phase 2, running).
// With a lane axis (the batch on blocked_cluster.cu, blockIdx.y = lane, the
// batched record contiguous with a leading lane axis) it acts only on a lane
// whose record the block's cluster launch found live (LIVE); a frozen lane
// keeps its whole record. The solo walk's record is always live
// (make_record's LIVE, never cleared on a walk that still runs).

#include <algorithm>

#include "common.cuh"

namespace tpulp {
namespace blk {

constexpr int ST_RUNNING = 0, ST_UNBOUNDED = 2;
constexpr int GRID_THREADS = 256;
constexpr int MAX_K = 1024;   // eta slots of a block (kernels/blocked.py's MAX_K)
constexpr int RAY_GRID = 1024;  // most blocks of the ray launch (grid-stride)

// the record (tpulp_torch/kernels/blocked.py): int32 fields, then one
// partial a cleanup block of the plain stages; the wrapper's argument
// arrays
enum Field {
  PHASE, STATUS, NITER, STUCK, BLAND, SLOT, ART_ROW,
  CLEANUP, R_D, HAS_ELIG, J, HAS_IMPROVING, INFEASIBLE, TO_PHASE2, PRICING_PIVOT, CROW_OK, RETIRE,
  DO_CLEANUP, DO_PRICING, ACT, R, LEAVING, UNBOUNDED, FAILED1, RAY, LIVE, NI
};
enum Arg {
  A_T, A_U, A_V, A_ROW0, A_ROW1, A_BVEC, A_GAMMA, A_BASIS, A_ACT, A_ART, A_INTS, A_VALS,
  A_SCRATCH, A_SCAN, A_NARGS
};
enum Int { I_M, I_N, I_K, I_STALL, I_MAXIT, I_RULE, I_TIE, I_NINTS };

template <typename T>
struct Params {
  const T* tab;  // (M, N) T0, the flushed tableau
  T* U;          // (K, M) eta vectors
  T* V;          // (K, N) pivot rows
  T* row0;
  T* row1;
  T* bvec;
  int* rec;
  const int* scan;  // (2, N) B1's scan columns
  int M, N, K;
};

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
Params<T> make_params(const long long* a, const int* in) {
  Params<T> p;
  p.tab = (const T*)a[A_T];
  p.U = (T*)a[A_U];
  p.V = (T*)a[A_V];
  p.row0 = (T*)a[A_ROW0];
  p.row1 = (T*)a[A_ROW1];
  p.bvec = (T*)a[A_BVEC];
  p.rec = (int*)a[A_INTS];
  p.scan = (const int*)a[A_SCAN];
  p.M = in[I_M];
  p.N = in[I_N];
  p.K = in[I_K];
  return p;
}

template <typename T>
bool valid(const Params<T>& p) {
  return p.M >= 3 && p.N >= 2 && p.K >= 1 && p.K <= MAX_K && p.tab && p.U && p.V && p.row0 &&
         p.row1 && p.bvec && p.rec && p.scan;
}

// the ray launch over ``lanes`` lanes of a record (1: a solo record; each
// lane's scan columns B1's of that lane)
template <typename T>
int blocked_ray(const long long* a, const int* in, int lanes, void* stream) {
  const Params<T> p = make_params<T>(a, in);
  if (!valid(p) || lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  const long long e = (long long)p.K * std::max(p.M, p.N);
  const int grid = (int)std::min<long long>((e + GRID_THREADS - 1) / GRID_THREADS, RAY_GRID);
  ray_kernel<T><<<dim3(grid, lanes), GRID_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace blk
}  // namespace tpulp

extern "C" int tpulp_blocked_ray_f32(const long long* a, const int* in, void* stream) {
  return tpulp::blk::blocked_ray<float>(a, in, 1, stream);
}
extern "C" int tpulp_blocked_ray_f64(const long long* a, const int* in, void* stream) {
  return tpulp::blk::blocked_ray<double>(a, in, 1, stream);
}
extern "C" int tpulp_blocked_ray_batch_f32(const long long* a, const int* in, int lanes,
                                           void* stream) {
  return tpulp::blk::blocked_ray<float>(a, in, lanes, stream);
}
extern "C" int tpulp_blocked_ray_batch_f64(const long long* a, const int* in, int lanes,
                                           void* stream) {
  return tpulp::blk::blocked_ray<double>(a, in, lanes, stream);
}
