// blocked_cluster: a block of K eta-pivot slots of the solo rank-K blocked
// engine (solve/blocked.py: K applications of _blocked_pivot, one block of
// run_simplex_blocked's loop) in one launch of one thread-block cluster,
// with the block's eta factors U and V in the cluster's distributed shared
// memory. The rank-K flush between the blocks stays B1 (flush.cu) and the
// per-block ray scan blocked.cu's ray launch, both launched by the host.
//
// Replaces no Pallas kernel: in tpulp the engine is XLA's compiled
// lax.while_loop over _blocked_pivot (tpulp/solve/blocked.py:61-245, one
// block of run_simplex_blocked's fori_loop 272-275). It is the redesign of
// blocked.cu's slot (six stream-ordered launches a slot, enqueued by the
// host) for the LPs whose factors a cluster of 8 (or 16) blocks holds;
// blocked.cu keeps the others.
//
// What bounds it on the H100: a slot reads one column and one or two rows
// of T0 and the factors' slots written so far (the eta sums: 2 t (M + N)
// operations at slot t) and writes one slot of each factor: 0.18 us a slot
// at 514 x 1537 f64, K = 64, from device memory. Here the factors never
// leave shared memory and T0 stays in the 50 MB L2, so a slot is set by the
// latency of its chain of decisions: three cluster barriers, the reads of a
// factor's column from a peer's shared memory, the eta dots (t + 1
// dependent fmas) and a few block reductions, not by bytes.
//
// Design: rank1_cluster.cu's (its header: the mailboxes, the rank-order
// combines, the lockstep rules), on _blocked_pivot's arithmetic. One
// cluster of C blocks (8, the portable size; 16, non-portable, where 8 do
// not hold the factors; kernels/blocked_cluster.py::blocked_cluster_plan).
// Block b owns the column slab [b W, (b + 1) W), W = ceil(N / C), with its
// entries of row0, row1, the devex weights and the active mask, and the
// row slab [b H, (b + 1) H), H = ceil(M / C), with its entries of bvec; its
// dynamic shared memory holds V[0..K, column slab] and U[0..K, row slab].
// Every block holds the basis, the artificial mask, the walk's scalars,
// row0[N - 1] and row1[N - 1] (the objectives), and the factors' entries
// that every slot reads (U's rows 0 and 1, V's column N - 1) alike, and
// computes them from the same values in the same order: so every exit
// decision is the same in every block and no block leaves the slot loop
// alone. T0 is never written; it stays in device memory (in L2). A slot:
// 1. the block prices its own columns (Dantzig's NaN-first argmin of c_eff,
//    Bland's first improving column, devex's c^2 / gamma) on the
//    maintained objective rows, and under a clean-up (an artificial basic
//    in phase 2) finds its first eligible column of the clean-up row T0[r_d
//    + 2] + sum_k U[k, r_d + 2] V[k], reading U[0..t, r_d + 2] from the
//    row's owner (map_shared_rank); it posts its candidates into every
//    block's inbox; cluster barrier A1 (arrive.release / wait.acquire);
// 2. every block combines the C candidates in rank order (offer's order is
//    total, so the shuffle tree gives the sequential argmin / argmax
//    exactly: NaN first, first-index ties; the |c| sum adds the blocks' sums
//    in rank order), which fixes the entering column j, the retire and the
//    phase bookkeeping; it reads V[0..t, j] from j's owner, forms its rows
//    of colj = T0[:, j] + sum_k V[k, j] U[k] and runs driver.ratio_rows'
//    rules on them: its minimum ratio (NaN first, first row), its first row
//    above piv_tol and, under Bland or largest-pivot ties, its pick among
//    its rows that tie with its own minimum; posted; barrier A2;
// 3. every block combines the ratio candidates (the global minimum; the
//    picks of the blocks whose minimum equals it: so the tie set is the
//    global one), which fixes r, the slot's act and the exits; it reads
//    U[0..t, r + 2] and colj[r + 2] (the pivot) from the row's owner, forms
//    its columns of vrow = (T0[r + 2] + sum_k U[k, r + 2] V[k]) * act,
//    updates its row0, row1, devex weights and bvec rows (one fma an entry),
//    writes V[t, own columns] = vrow and w = (e_{r+2} - colj) / piv * act
//    for its rows, and posts its weights' maximum and its |bvec[2:]| sum;
//    beside the pivot row one warp finds the first row whose basic column
//    is artificial after the pivot and the retire, on the replicated basis;
//    barrier A3; then every block runs the finish alike: the basis, the
//    retire, the devex resets (past reset_above, then at the phase change),
//    the stall counter and the Bland switch, the phase change, the status in
//    status_select's precedence, t and niter.
// A slot's eta slot U[t] is read by the peers of its owner in the same
// stage 3 that computes it, so the owner keeps the new w aside (wpend) and
// commits it into U in the next slot's stage 2 (after A1: every peer's
// stage-3 reads done; before A2: the next stage-3 reads see it); the next
// slot's stage-1 reads take slot t_prev from wpend. Each block pushes its
// candidate into every block's inbox for the stage (remote stores, released
// by the barrier's arrive), so a combine reads its own shared memory; an
// inbox is read only in the stage after its barrier and written again only
// after the two barriers that follow, so a fast block never overwrites an
// entry a slow peer still reads. The loop stops only once the status leaves RUNNING, a
// value every block holds alike: a slot past the budget pivots nowhere
// (act) and still records an exit, a phase change or a retire, as
// blocked.cu's. The factors' slabs are loaded once and written back once,
// with the running vectors, the basis, the masks, the weights and the
// scalars (what B1, the ray launch and record_state read); the launch ends
// with a cluster barrier, so no block of a live lane leaves while a peer
// may read its shared memory. The arithmetic is blocked.cu's: every eta
// sum runs k = 0 .. t, one fma a slot, in the tableau's type; one rounding
// per operation; comparisons against tolerances rounded to the tableau's
// type. The sums that feed finiteness checks only (the pre-step |c| over
// the active columns, the post-step |bvec[2:]|) are taken per block (per
// thread, the warp tree, across warps) and across blocks in rank order:
// kernels/blocked_cluster.py's plain version takes them in that order. A
// block has 512 threads (rank1_cluster.cu: at 1,024 the f64 walks
// spilled).
//
// The lane axis (solve/blocked.py's batch: tpulp's vmapped while_loop over
// _blocked_pivot, tpulp/solve/blocked.py:335-366): a launch of B lanes is a
// grid of (C, B) blocks with clusters of (C, 1, 1), so cluster y is lane y
// and its blocks' ranks are blockIdx.x. The batched record is contiguous
// with a leading lane axis: each of the lane's arrays sits at the lane
// times its per-lane extent (Lane, lane_arrays). A lane that is not live at
// the launch's start (status RUNNING and niter < max_iters, read by every
// block of its cluster alike before anything else) keeps its whole state
// through the block, as the vmapped loop's torch.where(live, new, old):
// its blocks return before the first cluster barrier and before any access
// to a peer's shared memory, since the slot loop below would otherwise let
// a slot past the budget record an exit. Rank 0 writes the verdict into
// the record (LIVE), where B1 and the ray launch read it. Lanes never wait
// on one another, so clusters past cudaOccupancyMaxActiveClusters simply
// wait for a free slot on the card. The solo launch is the case B = 1.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace tpulp {
namespace bkc {

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
// pricing rules and tie breaks (tpulp_torch.core.state)
constexpr int RULE_BLAND_ = 1, RULE_DEVEX_ = 3, TIE_MAXPIV_ = 1;
constexpr int THREADS = 512;     // a block
constexpr int MAX_BLOCKS = 16;   // the non-portable cluster size
constexpr int MAX_K = 1024;      // eta slots of a block (kernels/blocked.py's MAX_K)
// the warp that runs the next slot's clean-up scan while the others form
// the pivot row (idle there unless the column slab has more than 448
// columns)
constexpr int SCAN_WARP = 14;

// the record (kernels/blocked.py's BlockedRecord): its int32 scalars, the
// lane's verdict at the launch's start, and values
enum Field { PHASE, STATUS, NITER, STUCK, BLAND, SLOT, ART_ROW, LIVE = 25 };
enum Val { LAST_Z };
// the wrapper's argument arrays (tpulp_torch/kernels/blocked_cluster.py)
enum Arg {
  A_T, A_U, A_V, A_ROW0, A_ROW1, A_BVEC, A_GAMMA, A_BASIS, A_ACT, A_ART, A_INTS, A_VALS,
  A_CYCLES, A_NARGS
};
enum Int {
  I_M, I_N, I_K, I_STALL, I_MAXIT, I_RULE, I_TIE, I_BLOCKS, I_THREADS, I_SMEM, I_LANES,
  I_INTS_STRIDE, I_VALS_STRIDE, I_NINTS
};
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_RESET, D_NTOLS };
// the stages that ``cycles`` splits a launch into (block 0's clock; summed
// over the slots): the load, then a slot's clean-up and pricing, barrier
// A1, the combine and the read of V[0..t, j], the entering column's eta
// sums, the ratio test, barrier A2, the combine and the read of U[0..t, r +
// 2], the pivot row and the updates (and the clean-up scan beside them),
// the block's reduction, barrier A3, the finish; then the store
enum Stage {
  C_LOAD, C_PRICE, C_A1, C_FETCH1, C_COLUMN, C_RATIO, C_A2, C_FETCH2, C_ROW, C_REDUCE, C_A3,
  C_FINISH, C_STORE, C_NSTAGES
};

// a lane's arrays; Params holds lane 0's
template <typename T>
struct Lane {
  const T* tab;  // (M, N) T0, the block-start tableau (never written)
  T* U;          // (K, M) eta vectors
  T* V;          // (K, N) pivot rows
  T* row0;
  T* row1;
  T* bvec;
  T* gamma;  // (n,) devex weights (ones unless devex)
  int* basis;
  unsigned char* act;
  unsigned char* art;
  int* rec;
  T* vals;
};

template <typename T>
struct Params : Lane<T> {
  long long* cycles;  // (C_NSTAGES,) SM cycles per stage (block 0 of lane 0), or null
  long long ints_stride, vals_stride;  // the record's per-lane extents
  int M, N, K, W, H, stall_limit, max_iters;
  bool devex, bland_rule, max_piv;
  // the tolerances rounded to T, as torch rounds a Python float against a
  // tensor of T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, reset_above;
};

// lane b's arrays: lane 0's moved by b times each per-lane extent
template <typename T>
__device__ Lane<T> lane_arrays(const Params<T>& p, long long b) {
  const long long M = p.M, N = p.N, K = p.K, m = M - 2, n = N - 1;
  Lane<T> g;
  g.tab = p.tab + b * M * N;
  g.U = p.U + b * K * M;
  g.V = p.V + b * K * N;
  g.row0 = p.row0 + b * N;
  g.row1 = p.row1 + b * N;
  g.bvec = p.bvec + b * M;
  g.gamma = p.gamma + b * n;
  g.basis = p.basis + b * m;
  g.act = p.act + b * n;
  g.art = p.art + b * n;
  g.rec = p.rec + b * p.ints_stride;
  g.vals = p.vals + b * p.vals_stride;
  return g;
}

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) / 16 * 16; }

// The dynamic shared memory of a block, each segment 16-byte aligned: V's
// column slab (K x W) and U's row slab (K x H), slot-major; row0, row1 and
// the weights of the column slab (W each); bvec, colj and the pending w of
// the row slab (H each); U's rows 0 and 1, V's column N - 1 and the eta
// coefficients read from a peer (K each); the basis (m ints); the column
// slab's active mask (W); the artificial mask (n). The wrapper's
// blocked_cluster_plan counts the same bytes; the launch refuses a plan
// that disagrees.
template <typename T>
__host__ __device__ long long smem_bytes(int M, int N, int K, int W, int H) {
  const long long m = M - 2, n = N - 1, es = sizeof(T);
  return align16((long long)K * W * es) + align16((long long)K * H * es) +
         3 * align16((long long)W * es) + 3 * align16((long long)H * es) +
         4 * align16((long long)K * es) + align16(4 * m) + align16(W) + align16(n);
}

template <typename T>
struct Layout {
  T* V;
  T* U;
  T* row0;
  T* row1;
  T* gamma;
  T* bvec;
  T* colj;
  T* wpend;
  T* u0;    // U[., 0]
  T* u1;    // U[., 1]
  T* vlst;  // V[., N - 1]
  T* coef;
  int* basis;
  unsigned char* act;
  unsigned char* art;
};

// the next segment of ``bytes`` bytes at dyn + off; off moves past it
__device__ __forceinline__ unsigned char* segment(unsigned char* dyn, long long& off,
                                                  long long bytes) {
  unsigned char* at = dyn + off;
  off += align16(bytes);
  return at;
}

template <typename T>
__device__ Layout<T> layout(int M, int K, int W, int H, unsigned char* dyn) {
  Layout<T> L;
  const long long es = sizeof(T);
  long long off = 0;
  L.V = (T*)segment(dyn, off, (long long)K * W * es);
  L.U = (T*)segment(dyn, off, (long long)K * H * es);
  L.row0 = (T*)segment(dyn, off, W * es);
  L.row1 = (T*)segment(dyn, off, W * es);
  L.gamma = (T*)segment(dyn, off, W * es);
  L.bvec = (T*)segment(dyn, off, H * es);
  L.colj = (T*)segment(dyn, off, H * es);
  L.wpend = (T*)segment(dyn, off, H * es);
  L.u0 = (T*)segment(dyn, off, K * es);
  L.u1 = (T*)segment(dyn, off, K * es);
  L.vlst = (T*)segment(dyn, off, K * es);
  L.coef = (T*)segment(dyn, off, K * es);
  L.basis = (int*)segment(dyn, off, 4LL * (M - 2));
  L.act = segment(dyn, off, W);
  L.art = dyn + off;
  return L;
}

// What a block posts after pricing (A1): its candidate of the slot's column
// reduction (the pick (v, i), the first improving column a, the first
// eligible column of the clean-up row b, the |c| sum s) and the devex
// weights at its pick and at its first improving column (the entering
// column's weight rides in its owner's entry).
template <typename T>
struct MailA {
  Red<T> red;
  T g_i, g_a;
};

// What a block posts after its ratio test (A2): its minimum ratio m at row
// qi (NaN first, first row), its first row above piv_tol a, and its pick
// among the rows that tie with m (Bland's smallest basic index or the
// largest pivot element) (pv, pi).
template <typename T>
struct MailB {
  T m, pv;
  int qi, a, pi;
};

// What a block posts after its updates (A3): its weights' NaN-first
// maximum and its post-step |bvec[2:]| sum.
template <typename T>
struct MailC {
  T gmax, bsum;
};

// The cluster barrier in two halves: arrive releases this thread's writes
// (shared memory included) to the cluster, wait acquires every peer's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// sum_{k <= t} coef[k] x[k * ld]: one fma a slot, in slot order (blocked.cu's
// eta_dot)
template <typename T>
__device__ __forceinline__ T eta_dot(const T* coef, const T* x, int ld, int t) {
  T acc = T(0);
#pragma unroll 4
  for (int k = 0; k <= t; ++k) acc = fma(coef[k], x[k * ld], acc);
  return acc;
}

// w[i] = (e_rg[i] - colj[i]) / safe_piv * actf, as the eager pivot rounds it
template <typename T>
__device__ __forceinline__ T w_of(T colj_i, bool on_rg, T spiv, T actf) {
  return mul_rn(div_rn(sub_rn(on_rg ? T(1) : T(0), colj_i), spiv), actf);
}

// coef[k] = U[k, row] for the slots k <= t, read from the row's owner (slot
// pend_t from its pending w); called by every thread, a barrier follows
template <typename T>
__device__ void load_u_col(cg::cluster_group& cluster, const Layout<T>& L, int H, int row, int t,
                           int pend_t) {
  const int owner = row / H, ii = row - owner * H;
  const T* us = cluster.map_shared_rank(L.U, owner);
  const T* wp = cluster.map_shared_rank(L.wpend, owner);
  for (int k = threadIdx.x; k <= t; k += blockDim.x)
    L.coef[k] = k == pend_t ? wp[ii] : us[(long long)k * H + ii];
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

// The values a stage's combine hands to the whole block.
template <typename T>
struct Comb {
  Red<T> a;     // stage 2: the column candidates combined
  T colj0, colj1;  // stage 2: colj's rows 0 and 1
  int r_price, has_ratio;  // stage 3
  T piv, vlast;
  T gmax, bsum;  // the finish
  int art;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) cluster_kernel(Params<T> p) {
  __shared__ Red<T> scratch[33];
  // the blocks' candidates, entry q pushed by block q into every block's
  // shared memory (remote stores released by the barrier that follows), so
  // that each combine reads its own shared memory
  __shared__ MailA<T> inbox_a[MAX_BLOCKS];
  __shared__ MailB<T> inbox_b[MAX_BLOCKS];
  __shared__ MailC<T> inbox_c[MAX_BLOCKS];
  __shared__ Comb<T> comb;
  __shared__ Laps laps;  // thread 0's, on block 0 only
  // the layout's pointers live in shared memory, not in 30 registers a
  // thread, and so do the lane's arrays
  __shared__ Layout<T> L;
  __shared__ Lane<T> G;
  extern __shared__ __align__(16) unsigned char cluster_dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, N = p.N, K = p.K, W = p.W, H = p.H, m = M - 2, n = N - 1;
  // this block's columns [k0, k0 + wk) and rows [i0, i0 + hi)
  const int k0 = rank * W, wk = max(0, min(N, k0 + W) - k0);
  const int i0 = rank * H, hi = max(0, min(M, i0 + H) - i0);
  const T inf = pos_inf<T>();
  const bool devex = p.devex;
  {
    // the block-start freeze (the header): every block of the lane's
    // cluster reads the same two fields before any barrier; rank 0 records
    // the verdict
    int* rec = p.rec + (long long)blockIdx.y * p.ints_stride;
    const bool live = rec[STATUS] == ST_RUNNING && rec[NITER] < p.max_iters;
    if (rank == 0 && tid == 0) rec[LIVE] = live;
    if (!live) return;
  }
  if (tid == 0) {
    L = layout<T>(M, K, W, H, cluster_dyn);
    G = lane_arrays(p, blockIdx.y);
    laps.on = p.cycles != nullptr && rank == 0 && blockIdx.y == 0;
    laps.last = clock64();
    for (int k = 0; k < C_NSTAGES; ++k) laps.cyc[k] = 0;
  }
  __syncthreads();
  const T* tab = G.tab;

  // ---- load: the factors' slabs (element by element over the whole
  // slab, so that every thread's loads are in flight at once), the running
  // vectors, the replicated state, the scalars ----
  for (int e = tid; e < K * wk; e += THREADS) {
    const int k = e / wk, kk = e - k * wk;
    L.V[(long long)k * W + kk] = G.V[(long long)k * N + k0 + kk];
  }
  for (int e = tid; e < K * hi; e += THREADS) {
    const int k = e / hi, ii = e - k * hi;
    L.U[(long long)k * H + ii] = G.U[(long long)k * M + i0 + ii];
  }
  for (int k = tid; k < K; k += THREADS) {
    L.u0[k] = G.U[(long long)k * M];
    L.u1[k] = G.U[(long long)k * M + 1];
    L.vlst[k] = G.V[(long long)k * N + N - 1];
  }
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    L.row0[kk] = G.row0[k];
    L.row1[kk] = G.row1[k];
    L.gamma[kk] = k < n ? G.gamma[k] : T(1);
    L.act[kk] = k < n && G.act[k] != 0;
  }
  for (int ii = tid; ii < hi; ii += THREADS) L.bvec[ii] = G.bvec[i0 + ii];
  for (int i = tid; i < m; i += THREADS) L.basis[i] = G.basis[i];
  for (int k = tid; k < n; k += THREADS) L.art[k] = G.art[k] != 0;
  int phase = G.rec[PHASE], status = G.rec[STATUS], niter = G.rec[NITER];
  int stuck = G.rec[STUCK], slot = G.rec[SLOT], ar = G.rec[ART_ROW];
  bool bland = G.rec[BLAND] != 0;
  T last_z = G.vals[LAST_Z];
  // the objectives' entries, row0[N - 1] and row1[N - 1]
  T z0 = G.row0[N - 1], z1 = G.row1[N - 1];
  // the slot whose w waits in wpend (-1: none)
  int pend_t = -1;
  __syncthreads();
  // every peer running and loaded before any read of its shared memory
  cluster_arrive();
  cluster_wait();
  if (tid == 0) lap(&laps, C_LOAD);

  for (int s = 0; s < K && status == ST_RUNNING; ++s) {
    const int t = min(slot, K - 1);
    // ---- 1. the clean-up row and pricing over the own columns; A1 ----
    const bool cleanup = ar != BIG_I && phase == 2;
    const int r_d = ar != BIG_I ? ar : 0;
    const bool use_bland = bland || p.bland_rule;
    if (cleanup) {
      load_u_col(cluster, L, H, r_d + 2, t, pend_t);
      __syncthreads();
    }
    {
      // over the own columns: the pick (v, i), devex's argmax of c^2 /
      // gamma over the improving columns, else the argmin of c_eff; the
      // first improving column (a); the clean-up row's first eligible
      // column (b); the sum of |crow| over the active columns (s)
      const T* crow = phase == 1 ? L.row1 : L.row0;
      const T* trow = tab + (long long)(r_d + 2) * N;
      Red<T> cols = red_identity<T>(devex);
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        if (k >= n) continue;
        const bool act = L.act[kk] != 0;
        const T c = crow[kk];
        const T c_eff = act ? c : inf;
        const bool improving = c_eff < -p.opt_tol;
        if (improving) cols.a = min(cols.a, k);
        if (act) cols.s = add_rn(cols.s, T(fabs(c)));
        if (devex)
          offer(cols, improving ? div_rn(mul_rn(c, c), L.gamma[kk]) : -inf, k, true);
        else
          offer(cols, c_eff, k, false);
        if (cleanup) {
          const T rowd = add_rn(trow[k], eta_dot(L.coef, L.V + kk, W, t));
          if (act && !L.art[k] && T(fabs(rowd)) > p.piv_tol) cols.b = min(cols.b, k);
        }
      }
      cols = block_reduce(cols, scratch, devex);
      if (warp == 0 && lane < C) {
        // lane q pushes the candidate to block q
        MailA<T> mine;
        mine.red = cols;
        mine.g_i = cols.i >= k0 && cols.i < k0 + wk ? L.gamma[cols.i - k0] : T(0);
        mine.g_a = cols.a >= k0 && cols.a < k0 + wk ? L.gamma[cols.a - k0] : T(0);
        *cluster.map_shared_rank(&inbox_a[rank], lane) = mine;
      }
      if (tid == 0) lap(&laps, C_PRICE);
    }
    cluster_arrive();
    cluster_wait();
    if (tid == 0) lap(&laps, C_A1);

    // ---- 2. combine in rank order; the entering column; the ratio test;
    // A2 ----
    if (warp == 0) {
      // lane q < C brings block q's candidate; a shuffle tree takes the
      // pick and the first indices, and lane 0 adds the sums in rank order
      Red<T> x = red_identity<T>(devex);
      if (lane < C) x = inbox_a[lane].red;
      for (int off = MAX_BLOCKS / 2; off > 0; off >>= 1) {
        const T v = __shfl_down_sync(LANE_FULL, x.v, off);
        const int i = __shfl_down_sync(LANE_FULL, x.i, off);
        const int a = __shfl_down_sync(LANE_FULL, x.a, off);
        const int b = __shfl_down_sync(LANE_FULL, x.b, off);
        offer(x, v, i, devex);
        x.a = min(x.a, a);
        x.b = min(x.b, b);
      }
      if (lane == 0) {
        T sum = inbox_a[0].red.s;
        for (int q = 1; q < C; ++q) sum = add_rn(sum, inbox_a[q].red.s);
        x.s = sum;
        comb.a = x;
      }
    }
    // slot t_prev's w, kept aside while the peers read U in its stage 3,
    // into U (every peer is past that stage: A1)
    if (pend_t >= 0)
      for (int ii = tid; ii < hi; ii += THREADS) L.U[(long long)pend_t * H + ii] = L.wpend[ii];
    pend_t = -1;
    __syncthreads();
    const Red<T> all = comb.a;
    const bool crow_ok = finite_val(all.s);
    const bool has_improving = all.a != BIG_I;
    const bool has_elig = cleanup && all.b != BIG_I;
    const int j_price = use_bland ? (has_improving ? all.a : n - 1) : all.i;
    const bool phase1_done = phase == 1 && !has_improving;
    const bool infeasible1 = phase1_done && -z1 > p.infeas_tol;
    const bool to_phase2 = phase1_done && !infeasible1;
    const bool pricing_pivot = has_improving && !cleanup && phase != 0;
    const bool retire = cleanup && !has_elig;
    const int j = cleanup ? (has_elig ? all.b : n - 1) : j_price;
    // the entering column's weight (read only on a devex pricing pivot,
    // whose j is the pick or, under Bland, the first improving column)
    T gq = T(0);
    if (devex && has_improving) {
      const int jq = use_bland ? all.a : all.i;
      if (jq >= 0 && jq < n) gq = use_bland ? inbox_a[jq / W].g_a : inbox_a[jq / W].g_i;
    }
    // T0's entry of the thread's first row (the last two threads: rows 0
    // and 1), loaded while the peer's slots arrive
    const T t0_own = tid < hi ? tab[(long long)(i0 + tid) * N + j] : T(0);
    const T t0_01 = tid == THREADS - 1 ? tab[j] : tid == THREADS - 2 ? tab[N + j] : T(0);
    {
      // coef[k] = V[k, j] from j's owner
      const int owner = j / W;
      const T* vs = cluster.map_shared_rank(L.V, owner) + (j - owner * W);
      for (int k = tid; k <= t; k += THREADS) L.coef[k] = vs[(long long)k * W];
    }
    __syncthreads();
    if (tid == 0) lap(&laps, C_FETCH1);
    // the own rows of colj = T0[:, j] + sum_k V[k, j] U[k], and its rows 0
    // and 1 (replicated: the block's last two threads, idle unless the
    // slab has more rows than the block threads)
    for (int ii = tid; ii < hi; ii += THREADS)
      L.colj[ii] = add_rn(ii == tid ? t0_own : tab[(long long)(i0 + ii) * N + j],
                          eta_dot(L.coef, L.U + ii, H, t));
    if (tid == THREADS - 1) comb.colj0 = add_rn(t0_01, eta_dot(L.coef, L.u0, 1, t));
    if (tid == THREADS - 2) comb.colj1 = add_rn(t0_01, eta_dot(L.coef, L.u1, 1, t));
    __syncthreads();
    if (tid == 0) lap(&laps, C_COLUMN);
    {
      // driver.ratio_rows over the own rows >= 2 (ratio row i - 2): the
      // NaN-first argmin of the ratios (v, i) and the first row above
      // piv_tol (a); under Bland or largest-pivot ties, the pick among the
      // rows that tie with the block's own minimum
      const int ib = max(i0, 2);
      Red<T> rq = red_identity<T>(false);
      for (int i = ib + tid; i < i0 + hi; i += THREADS) {
        const T c = L.colj[i - i0];
        const bool pos = c > p.piv_tol;
        if (pos) rq.a = min(rq.a, i - 2);
        offer(rq, pos ? div_rn(L.bvec[i - i0], c) : inf, i - 2, false);
      }
      rq = block_reduce(rq, scratch, false);
      Red<T> rt = red_identity<T>(!use_bland);
      if (use_bland || p.max_piv) {
        const bool min_nan = is_nan(rq.v);
        for (int i = ib + tid; i < i0 + hi; i += THREADS) {
          const T c = L.colj[i - i0];
          const T q = c > p.piv_tol ? div_rn(L.bvec[i - i0], c) : inf;
          const bool tie = !min_nan && q <= rq.v;
          if (use_bland)
            offer(rt, tie ? T(L.basis[i - 2]) : T(BIG_I), i - 2, false);
          else
            offer(rt, tie ? c : -inf, i - 2, true);
        }
        rt = block_reduce(rt, scratch, !use_bland);
      }
      if (warp == 0 && lane < C) {
        MailB<T> mine;
        mine.m = rq.v;
        mine.qi = rq.i;
        mine.a = rq.a;
        mine.pv = rt.v;
        mine.pi = rt.i;
        *cluster.map_shared_rank(&inbox_b[rank], lane) = mine;
      }
      if (tid == 0) lap(&laps, C_RATIO);
    }
    cluster_arrive();
    cluster_wait();
    if (tid == 0) lap(&laps, C_A2);

    // ---- 3. combine the ratio tests; the pivot row; the updates; A3 ----
    if (warp == 0) {
      MailB<T> q;
      q.m = inf;
      q.qi = BIG_I;
      q.a = BIG_I;
      q.pv = use_bland ? inf : -inf;
      q.pi = BIG_I;
      if (lane < C) q = inbox_b[lane];
      // the global minimum (v, i) and first row above piv_tol (a)
      Red<T> x;
      x.v = q.m;
      x.i = q.qi;
      x.a = q.a;
      for (int off = MAX_BLOCKS / 2; off > 0; off >>= 1) {
        const T v = __shfl_down_sync(LANE_FULL, x.v, off);
        const int i = __shfl_down_sync(LANE_FULL, x.i, off);
        const int a = __shfl_down_sync(LANE_FULL, x.a, off);
        offer(x, v, i, false);
        x.a = min(x.a, a);
      }
      const T gmin = __shfl_sync(LANE_FULL, x.v, 0);
      const bool min_nan = is_nan(gmin);
      // the picks of the blocks whose minimum is the global one
      Red<T> y;
      y.v = use_bland ? inf : -inf;
      y.i = BIG_I;
      if (!min_nan && q.m <= gmin) {
        y.v = q.pv;
        y.i = q.pi;
      }
      for (int off = MAX_BLOCKS / 2; off > 0; off >>= 1) {
        const T v = __shfl_down_sync(LANE_FULL, y.v, off);
        const int i = __shfl_down_sync(LANE_FULL, y.i, off);
        offer(y, v, i, !use_bland);
      }
      if (lane == 0) {
        // torch's argmin / argmax give row 0 where the minimum is NaN
        comb.r_price = min_nan ? 0 : (use_bland || p.max_piv) ? y.i : x.i;
        comb.has_ratio = x.a != BIG_I;
      }
    }
    __syncthreads();
    const bool has_ratio = comb.has_ratio != 0;
    const bool do_cleanup = cleanup && has_elig;
    const bool do_pricing = pricing_pivot && has_ratio;
    const bool act = (do_cleanup || do_pricing) && niter < p.max_iters;
    const int r = do_cleanup ? r_d : comb.r_price;
    const int rg = r + 2, leaving = L.basis[r];
    const bool unbounded = pricing_pivot && !has_ratio && phase == 2;
    const bool failed1 = pricing_pivot && !has_ratio && phase != 2;
    // T0's entry of the thread's first column of row r + 2 (the last thread:
    // column N - 1), loaded while the peer's slots arrive
    const T* trow = tab + (long long)rg * N;
    const T t0_own3 = tid < wk ? trow[k0 + tid] : T(0);
    const T t0_last = tid == THREADS - 1 ? trow[N - 1] : T(0);
    // coef[k] = U[k, r + 2] and the pivot colj[r + 2], from the row's owner
    load_u_col(cluster, L, H, rg, t, -1);
    if (tid == 0) {
      const int owner = rg / H;
      comb.piv = cluster.map_shared_rank(L.colj, owner)[rg - owner * H];
    }
    __syncthreads();
    if (tid == 0) lap(&laps, C_FETCH2);
    const T actf = act ? T(1) : T(0);
    const T spiv = act ? comb.piv : T(1);
    const bool upd = devex && act && do_pricing;
    // w[0] and w[1] (row0's and row1's factors), in every block in the same
    // order
    const T w0 = w_of(comb.colj0, false, spiv, actf), w1 = w_of(comb.colj1, false, spiv, actf);
    const bool keep = slot < K;  // the eta slot is written (always, in a block)
    // v: the weights' NaN-first maximum; s: the post-step |bvec[2:]| sum;
    // a: the first row whose basic column is artificial
    Red<T> x = red_identity<T>(true);
    {
      const T qv = div_rn(gq, mul_rn(spiv, spiv));
      const T leave = is_nan(qv) ? qv : (qv < T(1) ? T(1) : qv);
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        const T v = mul_rn(add_rn(kk == tid ? t0_own3 : trow[k], eta_dot(L.coef, L.V + kk, W, t)),
                           actf);
        if (keep) L.V[(long long)slot * W + kk] = v;
        L.row0[kk] = fma(w0, v, L.row0[kk]);
        L.row1[kk] = fma(w1, v, L.row1[kk]);
        if (devex && k < n) {
          // max(gamma, (vrow / piv)^2 gamma_q), then gamma[leaving] =
          // max(gamma_q / piv^2, 1), with torch's NaN rules
          T gk = L.gamma[kk];
          if (upd && k == leaving) {
            gk = leave;
          } else if (upd) {
            const T a = div_rn(v, spiv);
            gk = nan_max(gk, mul_rn(mul_rn(a, a), gq));
          }
          L.gamma[kk] = gk;
          offer(x, gk, k, true);
        }
      }
      // vrow[N - 1] (bvec's factor), in every block in the same order: the
      // block's last thread, idle unless the slab has more columns than
      // the block threads
      if (tid == THREADS - 1)
        comb.vlast = mul_rn(add_rn(t0_last, eta_dot(L.coef, L.vlst, 1, t)), actf);
      if (warp == SCAN_WARP) {
        // the next slot's clean-up scan: the first row whose basic column
        // is artificial after the pivot (basis[r] = j) and the retire
        // (art[basis[r_d]] = 0), which the finish applies
        const int retired = retire ? L.basis[r_d] : -1;
        int a = BIG_I;
        for (int i = lane; i < m; i += 32) {
          const int b = act && i == r ? j : L.basis[i];
          if (L.art[b] && b != retired) {
            a = i;
            break;
          }
        }
        for (int off = 16; off > 0; off >>= 1) a = min(a, __shfl_down_sync(LANE_FULL, a, off));
        if (lane == 0) comb.art = a;
      }
      __syncthreads();
      const T vlast = comb.vlast;
      for (int ii = tid; ii < hi; ii += THREADS) {
        const int i = i0 + ii;
        const T w = w_of(L.colj[ii], i == rg, spiv, actf);
        const T b = fma(w, vlast, L.bvec[ii]);
        L.bvec[ii] = b;
        L.wpend[ii] = w;
        if (i >= 2) x.s = add_rn(x.s, T(fabs(b)));
      }
    }
    z0 = fma(w0, comb.vlast, z0);
    z1 = fma(w1, comb.vlast, z1);
    if (keep) pend_t = slot;
    if (tid == 0) lap(&laps, C_ROW);
    x = block_reduce(x, scratch, true);
    if (warp == 0 && lane < C) {
      MailC<T> mine;
      mine.gmax = x.v;
      mine.bsum = x.s;
      *cluster.map_shared_rank(&inbox_c[rank], lane) = mine;
    }
    if (tid == 0) lap(&laps, C_REDUCE);
    cluster_arrive();
    cluster_wait();
    if (tid == 0) lap(&laps, C_A3);

    // ---- the finish, in every block alike ----
    if (warp == 0) {
      T g = lane < C ? inbox_c[lane].gmax : -inf;
      for (int off = MAX_BLOCKS / 2; off > 0; off >>= 1)
        g = nan_max(g, __shfl_down_sync(LANE_FULL, g, off));
      if (lane == 0) {
        T sum = inbox_c[0].bsum;
        for (int q = 1; q < C; ++q) sum = add_rn(sum, inbox_c[q].bsum);
        comb.gmax = g;
        comb.bsum = sum;
      }
    } else if (tid == 32) {
      // the pivot, the retire (it pivots nowhere: the basis is the
      // pre-step one), the eta slot's replicated entries (every reader of
      // them is past A3)
      if (act) L.basis[r] = j;
      if (retire) L.art[L.basis[r_d]] = 0;
      if (keep) {
        L.u0[slot] = w0;
        L.u1[slot] = w1;
        L.vlst[slot] = comb.vlast;
      }
    }
    __syncthreads();
    if (devex && (comb.gmax > p.reset_above || to_phase2))
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
    if (to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) L.act[kk] = L.act[kk] && !L.art[k0 + kk];
    // stall and the Bland switch against the current objective
    const T z = -(phase == 1 ? z1 : z0);
    if (do_pricing && act) {
      stuck = sub_rn(last_z, z) > p.degen_tol ? 0 : stuck + 1;
      last_z = z;
    }
    bland = bland || stuck >= p.stall_limit;
    const bool finished_opt = phase == 2 && !has_improving && !cleanup;
    if (to_phase2) {
      phase = 2;
      stuck = 0;
      last_z = inf;
    }
    const bool finite_ok = finite_val(z) && finite_val(comb.bsum) && crow_ok;
    status = !finite_ok ? ST_NUMERIC
             : (infeasible1 || failed1) ? ST_INFEASIBLE
             : unbounded ? ST_UNBOUNDED
             : finished_opt ? ST_OPTIMAL
                            : ST_RUNNING;
    niter += act;
    slot += act;
    ar = comb.art;
    __syncthreads();
    if (tid == 0) lap(&laps, C_FINISH);
  }

  // ---- write back: the factors' slabs, the running vectors, the masks'
  // and weights' shares, the basis and the scalars ----
  if (pend_t >= 0)
    for (int ii = tid; ii < hi; ii += THREADS) L.U[(long long)pend_t * H + ii] = L.wpend[ii];
  __syncthreads();
  for (int e = tid; e < K * wk; e += THREADS) {
    const int k = e / wk, kk = e - k * wk;
    G.V[(long long)k * N + k0 + kk] = L.V[(long long)k * W + kk];
  }
  for (int e = tid; e < K * hi; e += THREADS) {
    const int k = e / hi, ii = e - k * hi;
    G.U[(long long)k * M + i0 + ii] = L.U[(long long)k * H + ii];
  }
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    G.row0[k] = L.row0[kk];
    G.row1[k] = L.row1[kk];
    if (k >= n) continue;
    G.gamma[k] = L.gamma[kk];
    G.act[k] = L.act[kk];
    G.art[k] = L.art[k];
  }
  for (int ii = tid; ii < hi; ii += THREADS) G.bvec[i0 + ii] = L.bvec[ii];
  if (rank == 0) {
    for (int i = tid; i < m; i += THREADS) G.basis[i] = L.basis[i];
    if (tid == 0) {
      G.rec[PHASE] = phase;
      G.rec[STATUS] = status;
      G.rec[NITER] = niter;
      G.rec[STUCK] = stuck;
      G.rec[BLAND] = bland;
      G.rec[SLOT] = slot;
      G.rec[ART_ROW] = ar;
      G.vals[LAST_Z] = last_z;
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
  p.tab = (const T*)a[A_T];
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
  p.cycles = (long long*)a[A_CYCLES];
  p.ints_stride = in[I_INTS_STRIDE];
  p.vals_stride = in[I_VALS_STRIDE];
  p.M = in[I_M];
  p.N = in[I_N];
  p.K = in[I_K];
  const int C = in[I_BLOCKS];
  p.W = C > 0 ? (p.N + C - 1) / C : 0;
  p.H = C > 0 ? (p.M + C - 1) / C : 0;
  p.stall_limit = in[I_STALL];
  p.max_iters = in[I_MAXIT];
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

// The plan's figures against this layout: a cluster of 1, 2, 4, 8 or 16
// blocks of THREADS threads, K eta slots, the bytes smem_bytes counts; 1
// to 65,535 lanes, each with its record past LIVE.
template <typename T>
bool plan_ok(const int* in) {
  const int M = in[I_M], N = in[I_N], K = in[I_K], C = in[I_BLOCKS];
  if (M < 3 || N < 2 || K < 1 || K > MAX_K || in[I_THREADS] != THREADS ||
      (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) || in[I_LANES] < 1 ||
      in[I_LANES] > 65535 || in[I_INTS_STRIDE] <= LIVE || in[I_VALS_STRIDE] <= LAST_Z)
    return false;
  return (long long)in[I_SMEM] == smem_bytes<T>(M, N, K, (N + C - 1) / C, (M + C - 1) / C);
}

template <typename T>
bool pointers_ok(const Params<T>& p) {
  return p.tab && p.U && p.V && p.row0 && p.row1 && p.bvec && p.gamma && p.basis && p.act &&
         p.art && p.rec && p.vals;
}

template <typename T>
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
// above what it allows, and its clusters of 16 (non-portable) allowed
template <typename T>
int prepare(int smem) {
  static int raised = 48 * 1024;  // per instantiation
  static bool wide = false;
  if (!wide) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)cluster_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    wide = true;
  }
  if (smem <= raised) return 0;
  const cudaError_t e = cudaFuncSetAttribute((const void*)cluster_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  raised = smem;
  return 0;
}

// one launch of in[I_LANES] lanes (the solo entries: 1)
template <typename T>
int blocked_cluster(const long long* a, const int* in, const double* tol, void* stream) {
  if (!plan_ok<T>(in)) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(a, in, tol);
  if (!pointers_ok(p)) return (int)cudaErrorInvalidValue;
  const int C = in[I_BLOCKS], smem = in[I_SMEM];
  const int err = prepare<T>(smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T>(C, in[I_LANES], smem, (cudaStream_t)stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_kernel<T>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of the plan's launch: how many such
// clusters the card can hold at once (0: the launch cannot run)
template <typename T>
int blocked_cluster_occupancy(const int* in, int* clusters) {
  if (!plan_ok<T>(in) || !clusters) return (int)cudaErrorInvalidValue;
  const int C = in[I_BLOCKS], smem = in[I_SMEM];
  const int err = prepare<T>(smem);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<T>(C, 1, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)cluster_kernel<T>, &cfg);
}

}  // namespace bkc
}  // namespace tpulp

extern "C" int tpulp_blocked_cluster_f32(const long long* a, const int* in, const double* tol,
                                         void* stream) {
  return in[tpulp::bkc::I_LANES] != 1 ? (int)cudaErrorInvalidValue
                                      : tpulp::bkc::blocked_cluster<float>(a, in, tol, stream);
}
extern "C" int tpulp_blocked_cluster_f64(const long long* a, const int* in, const double* tol,
                                         void* stream) {
  return in[tpulp::bkc::I_LANES] != 1 ? (int)cudaErrorInvalidValue
                                      : tpulp::bkc::blocked_cluster<double>(a, in, tol, stream);
}
extern "C" int tpulp_blocked_cluster_batch_f32(const long long* a, const int* in,
                                               const double* tol, void* stream) {
  return tpulp::bkc::blocked_cluster<float>(a, in, tol, stream);
}
extern "C" int tpulp_blocked_cluster_batch_f64(const long long* a, const int* in,
                                               const double* tol, void* stream) {
  return tpulp::bkc::blocked_cluster<double>(a, in, tol, stream);
}
extern "C" int tpulp_blocked_cluster_occupancy_f32(const int* in, int* clusters) {
  return tpulp::bkc::blocked_cluster_occupancy<float>(in, clusters);
}
extern "C" int tpulp_blocked_cluster_occupancy_f64(const int* in, int* clusters) {
  return tpulp::bkc::blocked_cluster_occupancy<double>(in, clusters);
}
