// bounded_grid: the solo bounded-variable walk (solve/bounded.py::
// bounded_simplex_step) stepped to its exit or to max_iters in one
// persistent cooperative launch of G blocks, each keeping a column slab of
// the tableau in its shared memory, or, past the shared memory, the slab's
// first R rows there and the rest streamed through device memory.
//
// Replaces no Pallas kernel: in tpulp the walk is XLA's compiled
// ``lax.while_loop`` over ``bounded_simplex_step`` (tpulp/solve/bounded.py:
// 86-276 the step, 278-307 the driver). It redesigns bounded.cu's four
// stream-ordered launches a step (price, ratio and finish on one block
// each, the whole tableau through device memory twice a step, one host
// enqueue a step) for every frame whose replicated vectors, first three
// rows and tile ring fit a block's shared memory
// (kernels/bounded_grid.py::bounded_grid_plan: up to 6,284 rows at f64
// with n = 2m); bounded.cu keeps the larger frames.
//
// What bounds it on the H100: the frame crosses device memory twice a walk
// (loaded, stored); a step reads and writes the resident rows once from
// shared memory (2 x 1026 x 3073 x 8 B = 50 MB at 8a's f64 frame: ~1.5 us
// at 128 B a clock on 132 SMs) with one fma an entry, and the streamed
// rows once from device memory (~50 MB each way at 2050 x 4097 f64: ~30 us
// at 3.35 TB/s). On resident frames what sets the pace is the chain of a
// step's decisions: two grid barriers (~1 us each on the H100), the block
// reductions and the L2 round trips around them; on streamed ones the
// streamed rows' bytes.
//
// Design: G blocks of 512 threads, one an SM. Block g owns the structural
// columns [g W, min(n, (g + 1) W)) of all M rows, with their active mask
// and devex weights. Rows [0, R) of its slab live column-major in its
// dynamic shared memory (a column is contiguous; R = M on a resident
// plan). Every block holds the RHS column, the basis, the basic
// variables' spans and the artificial mask alike, and every thread the
// walk's scalars, computed from the same values in every block: every
// branch, budget and exit is the same in every block, and no block leaves
// the step loop alone. A step:
// 1. price over the block's columns (common.cuh's bounded_price_scan:
//    Dantzig, or devex's c^2 / gamma, Bland's first improving column, the
//    clean-up's first eligible column, the |c| sum), row 2's finiteness
//    over them, and where needed the owner of basis[0] tests that column
//    against e_2 (the redirected pivot's no-op test); the candidate goes to
//    the block's mailbox in device memory. Grid barrier A.
// 2. every block reads the G mailboxes through L2 (__ldcg), warp 0 a lane
//    every 32 blocks, and combines them (offer's order is total: the
//    sequential argmin exactly, first index on ties, NaN first). Under
//    devex the previous step's reset on the grid's largest weight is
//    applied here (then a second pricing under unit weights and a barrier
//    A'). The owner of the entering column j publishes its pre-step column
//    j, runs the three-way ratio test on it (common.cuh's bounded_ratios
//    and bounded_ratio's rules, each thread's candidates kept in registers
//    between its two passes) with the replicated RHS, basis and spans, and
//    publishes the verdict: the step's row, the kinds, the pivot element.
//    Grid barrier B.
// 3. every block reads the verdict (one thread: a line every block reads
//    is a hot spot in L2) and column j (a thread the rows it updates) in
//    one round trip, and updates its slab in place (a thread a row:
//    fma(-col[i], prow[k], T[i, k]), the pivot row set to prow, the
//    entering column to the unit vector, the flipped column negated by its
//    owner) and its RHS copy alike (fma(-Tn[i, fcol], uf, Tn[i, -1]));
//    then the basis, the spans, the flags, the devex weights, the retire,
//    the phase change, the stall counter, the Bland switch, the |b| sum and
//    the status.
// A block reduction picks by order-preserving keys (common.cuh's okey and
// warp_arg: a few redux.sync instructions a pick) behind one barrier (on
// the H100 a shuffle tree of (value, index) pairs over a block of 512
// threads took ~1.5 us).
// The flip's column fcol is column j (published) on an entering flip, else
// the leaving basic column basis[r], whose pre-step column is the unit
// vector on row r + 2 as long as every basic column is one: the launch
// checks that once (each owner its basic columns), and a pivot keeps it
// while its column and 1 / pivot are finite (every block checks the same
// published column, so the verdict is the same everywhere). Where it does
// not hold, the owners of fcol and of basis[0] publish those columns and a
// third barrier (C) follows B. So the common step has two grid barriers.
// The plain step's redirected pivot on (row 2, basis[0]) runs where it is
// not an exact no-op, as in bounded.cu. A mailbox is written once a step
// and read before its reader arrives at the next barrier, so no slot is
// rewritten while a peer may still read it.
//
// The streamed rows (STREAMED; kernels/bounded_grid.py's plan gives R,
// the ring's S stages and TR, a power of two, rows a tile): rows [R, M) of
// block g's slab live in the wrapper's scratch buffer, one contiguous
// region a block, in tiles of TR rows x W columns (column-major within the
// tile, each tile contiguous, TS bytes). The launch's load copies them
// there and its store back to T_out, so the frame still crosses device
// memory twice a launch beyond the steps. A step's update runs the
// resident rows from shared memory as above, then walks the block's tiles
// through a ring of S tiles in shared memory: thread 0 moves a tile in with
// a 1-D bulk async copy (cp.async.bulk ... mbarrier::complete_tx::bytes,
// completion on the slot's mbarrier), every thread updates its entries with
// the same arithmetic (the update is per entry, so the tile's thread
// mapping changes no bit), and thread 0 writes it back with
// cp.async.bulk.global.shared::cta and reloads the slot with the tile S
// places on. The first S tiles are asked for at the step's start, so their
// loads overlap the decisions; the tiles go in the reverse order every
// other step, so that the first ones a step reads are the last ones the
// previous step wrote (the ones L2 still holds). A step that pivots nowhere
// leaves the tiles as they are (the flipped column, if the block owns it,
// is negated in place in the scratch). Every other read of a streamed row
// (the owner's column j and its pivot element, the pivot row, the columns
// of barrier C, the clean-up's row, the unit-column checks, the load and
// the store) goes through one accessor (Slab::at), through L2 (__ldcg:
// L1 is not coherent with the bulk copies' writes). Only a block reads its
// own scratch. Hazards, each where it is handled:
// - a generic-proxy write to shared memory that a bulk store then reads
//   needs fence.proxy.async.shared::cta (each writing thread, then the
//   block's barrier, then thread 0's store);
// - generic writes to the scratch (the load, an in-place flip) need
//   fence.proxy.async.global before the bulk loads that read them;
// - a bulk store must be complete (cp.async.bulk.wait_group 0, not .read)
//   before any thread reads those rows generically in the next step:
//   thread 0 waits at the step's start, before a barrier; a slot is
//   reloaded only after .read says the store has read it;
// - a slot's mbarrier completes one phase a use, so the parity a thread
//   waits for flips per tile through the steps (each thread keeps the
//   ring's slot and parity bits, the same in every thread);
// - every block still takes every barrier: the streamed part is local.
//
// The frame is loaded once and stored once, with the basis, the masks, the
// weights, the scalars and the two counters (entering flips, upper hits);
// the host reads them once a walk. The arithmetic is bounded.cu's
// (lanes.cu's rules): one rounding per product in the decisions, IEEE
// division, prow = row * (1 / piv), comparisons in the tableau's type
// against tolerances rounded to it, the sums of the finiteness checks in a
// fixed order (a block's as common.cuh's block_reduce takes it; the
// blocks' |c| sums lane by lane in slab order, then the warp's tree;
// kernels/bounded_grid.py takes them in the same order). The barrier is
// common.cuh's flag barrier (GridBarrier); the wrapper zeroes its counter
// before each launch. A block has 512 threads: at 1,024, f64 spilled in
// rank1_cluster.cu, the same shape of kernel.

#include "common.cuh"

namespace tpulp {
namespace bgr {

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
constexpr int THREADS = 512;  // a block
constexpr int WARPS = THREADS / 32;
constexpr int SLOT = 64;  // bytes of a mailbox slot
constexpr int MAX_STAGES = 8;  // the tile ring's slots, at most
// SM cycles a thread waits on a tile before it gives the launch up
// (__trap: an error the wrapper raises, not a hang): ~9 s at 1.98 GHz
constexpr long long TILE_TIMEOUT = 1LL << 34;

// the wrapper's argument arrays (tpulp_torch/kernels/bounded_grid.py)
enum Arg {
  A_T_IN, A_T_OUT, A_BASIS_IN, A_BASIS_OUT, A_ACT_IN, A_ACT_OUT, A_ART_IN, A_ART_OUT, A_UPPER,
  A_AT_UPPER_IN, A_AT_UPPER_OUT, A_GAMMA_IN, A_GAMMA_OUT, A_PHASE_IN, A_STATUS_IN, A_NITER_IN,
  A_STUCK_IN, A_BLAND_IN, A_LASTZ_IN, A_INTS_OUT, A_BLAND_OUT, A_LASTZ_OUT, A_MAIL, A_COLS,
  A_BAR, A_CYCLES, A_SCRATCH, A_NARGS
};
// I_ROWS: R, the slab's rows in shared memory (M on a resident plan);
// I_STAGES: the tile ring's slots; I_TROWS: TR, rows a tile; I_TILE: TS,
// bytes a tile (the last three 0 on a resident plan)
enum Int {
  I_M, I_N, I_STALL, I_MAXIT, I_DEVEX, I_BLOCKS, I_WIDTH, I_THREADS, I_SMEM, I_MAIL, I_ROWS,
  I_STAGES, I_TROWS, I_TILE, I_NINTS
};
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_RESET, D_NTOLS };
// the int32 fields written back (ints_out)
enum Out { O_PHASE, O_STATUS, O_NITER, O_STUCK, O_N_ENTER, O_N_UPHIT, O_NOUT };
// the stages that ``cycles`` splits a walk into (block 0's clock; summed
// over the steps): the load, then a step's price, barrier A (A' with it),
// the combine (and the repricing), the ratio test and the publication
// (where block 0 owns j), barrier B, barrier C, the fetch of the verdict
// and column j with the pivot row and the devex weights, the update of the
// resident rows (and the RHS), the streamed rows' update (STREAMED), the
// finish; then the store; and apart, the ratio test and the publication
// on the clock of the block that owns j, whichever it is
enum Stage {
  C_LOAD, C_PRICE, C_A, C_COMBINE, C_RATIO, C_B, C_C, C_FETCH, C_UPDATE, C_STREAM, C_FINISH,
  C_STORE, C_OWNER, C_NSTAGES
};
// a mailbox's flags: row 2 has an entry that is not finite; column basis[0]
// is not the unit vector on row 2; a basic column is not a unit vector
enum Flag { F_ROW2_BAD = 1, F_UNIT0_BAD = 2, F_UNITS_BAD = 4 };
// the mailbox regions, in slots: A (a step's candidates), R (the
// repricing after a devex reset), F (the final weights' maxima), then the
// verdict
enum Region { R_A, R_R, R_F, R_NREGIONS };

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
  const T* upper;
  const unsigned char* at_upper_in;
  unsigned char* at_upper_out;
  const T* gamma_in;  // devex only
  T* gamma_out;
  const int *phase_in, *status_in, *niter_in, *stuck_in;
  const unsigned char* bland_in;
  const T* lastz_in;
  int* ints_out;
  unsigned char* bland_out;
  T* lastz_out;
  unsigned char* mail;  // mail_bytes(G)
  T* cols;              // (3 M,): column j | column fcol | column basis[0]
  unsigned* bar;        // the grid barrier's counter, zeroed by the wrapper
  long long* cycles;    // (C_NSTAGES,) SM cycles per stage (block 0), or null
  T* scratch;           // STREAMED: G regions of NT tiles of TS bytes
  int M, N, W, stall_limit, max_iters;
  int R, S, TR;  // resident rows, the ring's slots, rows a tile (STREAMED)
  int TS;        // bytes a tile (STREAMED)
  // the tolerances rounded to T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, reset_above;
};

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) / 16 * 16; }

// The dynamic shared memory of a block, each segment 16-byte aligned: the
// slab's R resident rows (R x W, column-major), the tile ring (S tiles of
// TS bytes), the RHS and the pivot's column (M each), the pivot row's and
// the devex weights' segments (W each), the basic variables' spans (m),
// the basis (m ints), the segment's active mask (W), the artificial mask
// (n) and the ring's mbarriers (S). A resident plan has R = M and S = TS =
// 0. The wrapper's bounded_grid_plan counts the same bytes; the launch
// refuses a plan that disagrees.
template <typename T>
__host__ __device__ long long smem_bytes(int M, int N, int W, int R, int S, int TS) {
  const long long m = M - 2, n = N - 1, es = sizeof(T);
  return align16((long long)R * W * es) + (long long)S * TS + 2 * align16((long long)M * es) +
         2 * align16((long long)W * es) + align16(m * es) + align16(4 * m) + align16(W) +
         align16(n) + align16(8LL * S);
}

__host__ __device__ __forceinline__ long long mail_bytes(int G) {
  return (long long)SLOT * (R_NREGIONS * (long long)G + 1);
}

template <typename T>
struct Layout {
  T* slab;
  T* ring;
  T* b;
  T* colj;
  T* prow;
  T* gamma;
  T* ub;
  int* basis;
  unsigned char* act;
  unsigned char* art;
  unsigned long long* mbar;  // the ring's S mbarriers (STREAMED)
};

template <typename T>
__device__ Layout<T> layout(int M, int N, int W, int R, int S, int TS, unsigned char* dyn) {
  Layout<T> L;
  const long long es = sizeof(T);
  long long off = 0;
  L.slab = (T*)(dyn + off);
  off += align16((long long)R * W * es);
  L.ring = (T*)(dyn + off);
  off += (long long)S * TS;
  L.b = (T*)(dyn + off);
  off += align16((long long)M * es);
  L.colj = (T*)(dyn + off);
  off += align16((long long)M * es);
  L.prow = (T*)(dyn + off);
  off += align16((long long)W * es);
  L.gamma = (T*)(dyn + off);
  off += align16((long long)W * es);
  L.ub = (T*)(dyn + off);
  off += align16((long long)(M - 2) * es);
  L.basis = (int*)(dyn + off);
  off += align16(4LL * (M - 2));
  L.act = dyn + off;
  off += align16(W);
  L.art = dyn + off;
  off += align16(N - 1);
  L.mbar = (unsigned long long*)(dyn + off);
  return L;
}

// A block's mailbox: its candidate of the step's column reduction (v, i,
// a, b, s), the largest of its devex weights (NaN first) and its flags.
template <typename T>
struct alignas(16) Mail {
  T v, s, gmax;
  int i, a, b, flags;
};

// The owner of j's verdict: the step's row r (the ratio test's leaving
// row, or the clean-up's), the kinds, the entry of column j on row r + 2
// and the entering column's devex weight.
template <typename T>
struct alignas(16) Verdict {
  T piv, gq;
  int r, has_ratio, kind_up, kind_flip;
};

// A mailbox slot (Mail or Verdict) read through L2 in 16-byte pieces.
template <typename S>
__device__ __forceinline__ S load_cg(const S* src) {
  static_assert(sizeof(S) % 16 == 0, "a slot is read in 16-byte pieces");
  union {
    int4 w[sizeof(S) / 16];
    S s;
  } u;
#pragma unroll
  for (int k = 0; k < (int)(sizeof(S) / 16); ++k) u.w[k] = __ldcg((const int4*)src + k);
  return u.s;
}

template <typename T>
__device__ __forceinline__ Mail<T>* mail_slot(const Params<T>& p, int region, int g) {
  return (Mail<T>*)(p.mail + (long long)SLOT * ((long long)region * gridDim.x + g));
}

template <typename T>
__device__ __forceinline__ Verdict<T>* verdict_slot(const Params<T>& p) {
  return (Verdict<T>*)(p.mail + (long long)SLOT * R_NREGIONS * gridDim.x);
}

template <typename T>
__device__ __forceinline__ void post(Mail<T>* mb, const Red<T>& c, T gmax, int flags) {
  mb->v = c.v;
  mb->s = c.s;
  mb->gmax = gmax;
  mb->i = c.i;
  mb->a = c.a;
  mb->b = c.b;
  mb->flags = flags;
}

// A warp's share of a block reduction by keys (common.cuh's okey and
// warp_arg: a few redux.sync instructions a pick): up to two (key, index)
// picks, two first indices and a sum.
template <typename T>
struct KeyRed {
  typename KeyOf<T>::type k1, k2;
  unsigned i1, i2, u1, u2;
  T s;
};

// The sum of a block's values in common.cuh's block_reduce's tree (the
// warp's shuffle tree, then the same over the warps' sums padded to 32),
// from the warps' sums in sh; to every lane.
template <typename T>
__device__ __forceinline__ T warps_sum(const KeyRed<T>* sh) {
  const int lane = threadIdx.x & 31;
  T s = lane < WARPS ? sh[lane].s : T(0);
  for (int off = 16; off > 0; off >>= 1) s = add_rn(s, __shfl_down_sync(FULL, s, off));
  return __shfl_sync(FULL, s, 0);
}

template <typename T>
__device__ __forceinline__ T warp_tree_sum(T s) {
  for (int off = 16; off > 0; off >>= 1) s = add_rn(s, __shfl_down_sync(FULL, s, off));
  return s;
}

// common.cuh's block_reduce of a Red by keys, returned to every thread:
// the pick (v, i) (mx: argmax), the first indices a and b, the sum s in
// block_reduce's order. One barrier; sh (WARPS slots) is this call site's
// own, so that no later reduction overwrites it while a warp still reads.
template <typename T>
__device__ Red<T> key_reduce(Red<T> x, bool mx, KeyRed<T>* sh) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  K k = okey(x.v, mx);
  unsigned i = (unsigned)x.i;
  warp_arg(k, i, mx);
  const unsigned a = __reduce_min_sync(FULL, (unsigned)x.a);
  const unsigned b = __reduce_min_sync(FULL, (unsigned)x.b);
  const T s = warp_tree_sum(x.s);
  if (lane == 0) {
    sh[warp].k1 = k;
    sh[warp].i1 = i;
    sh[warp].u1 = a;
    sh[warp].u2 = b;
    sh[warp].s = s;
  }
  __syncthreads();
  // every warp takes the block's result from the warps' shares
  k = lane < WARPS ? sh[lane].k1 : (mx ? K(0) : ~K(0));
  i = lane < WARPS ? sh[lane].i1 : NO_IDX;
  warp_arg(k, i, mx);
  Red<T> out;
  out.v = key_value(k, mx);
  out.i = (int)i;
  out.a = (int)__reduce_min_sync(FULL, lane < WARPS ? sh[lane].u1 : NO_IDX);
  out.b = (int)__reduce_min_sync(FULL, lane < WARPS ? sh[lane].u2 : NO_IDX);
  out.s = warps_sum(sh);
  return out;
}

// Two NaN-first argmins (offer's order: ties to the smaller index) over the
// block by keys, returned to every thread; one barrier, sh this call
// site's own.
template <typename T>
__device__ void key_pick2(T& v1, int& i1, T& v2, int& i2, KeyRed<T>* sh) {
  using K = typename KeyOf<T>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  K k1 = okey(v1, false), k2 = okey(v2, false);
  unsigned j1 = (unsigned)i1, j2 = (unsigned)i2;
  warp_arg(k1, j1, false);
  warp_arg(k2, j2, false);
  if (lane == 0) {
    sh[warp].k1 = k1;
    sh[warp].k2 = k2;
    sh[warp].i1 = j1;
    sh[warp].i2 = j2;
  }
  __syncthreads();
  k1 = lane < WARPS ? sh[lane].k1 : ~K(0);
  k2 = lane < WARPS ? sh[lane].k2 : ~K(0);
  j1 = lane < WARPS ? sh[lane].i1 : NO_IDX;
  j2 = lane < WARPS ? sh[lane].i2 : NO_IDX;
  warp_arg(k1, j1, false);
  warp_arg(k2, j2, false);
  v1 = key_value(k1, false);
  v2 = key_value(k2, false);
  i1 = (int)j1;
  i2 = (int)j2;
}


// The grid's combined mailbox of a region, returned to every thread: lane
// l of warp 0 brings blocks l, l + 32, l + 64, ... (their loads issued
// together) and combines them in that order, then the warp by keys and
// the shuffle tree: the pick (v, i) (offer's order is total: the
// sequential argmin exactly),
// the first indices, the |c| sums (in kernels/bounded_grid.py::grid_sum's
// order), the largest weight (NaN first) and the flags. Called by every
// thread; the result is in out, gmax, flags after its barrier.
template <typename T, bool MX>
__device__ void combine(const Params<T>& p, int region, Red<T>* out, T* gmax, int* flags) {
  constexpr int U = 4;  // blocks a lane loads at once
  const int lane = threadIdx.x & 31, G = gridDim.x;
  if (threadIdx.x < 32) {
    Red<T> y = red_identity<T>(MX);
    T gm = -pos_inf<T>();
    int fl = 0;
    for (int q0 = 0; q0 < G; q0 += 32 * U) {
      Mail<T> mb[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * 32 + lane;
        if (q < G) mb[u] = load_cg(mail_slot(p, region, q));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (q0 + u * 32 + lane >= G) continue;
        offer(y, mb[u].v, mb[u].i, MX);
        y.a = min(y.a, mb[u].a);
        y.b = min(y.b, mb[u].b);
        y.s = add_rn(y.s, mb[u].s);
        gm = nan_max(gm, mb[u].gmax);
        fl |= mb[u].flags;
      }
    }
    // the warp's picks by keys, its |c| sums by the shuffle tree
    using K = typename KeyOf<T>::type;
    K k = okey(y.v, MX), kg = okey(gm, true);
    unsigned i = (unsigned)y.i, ig = 0;
    warp_arg(k, i, MX);
    warp_arg(kg, ig, true);
    const unsigned a = __reduce_min_sync(FULL, (unsigned)y.a);
    const unsigned b = __reduce_min_sync(FULL, (unsigned)y.b);
    const T sum = warp_tree_sum(y.s);
    fl = (int)__reduce_or_sync(FULL, (unsigned)fl);
    if (lane == 0) {
      out->v = key_value(k, MX);
      out->i = (int)i;
      out->a = (int)a;
      out->b = (int)b;
      out->s = sum;
      *gmax = key_value(kg, true);
      *flags = fl;
    }
  }
  __syncthreads();
}

// torch's NaN-first argmin as offer takes it (ties to the smaller index).
template <typename T>
__device__ __forceinline__ void pick(T& v, int& i, T yv, int yi) {
  const bool xn = is_nan(v), yn = is_nan(yv);
  const bool take = (xn || yn) ? yn && (!xn || yi < i) : yv < v || (yv == v && yi < i);
  if (take) {
    v = yv;
    i = yi;
  }
}

// common.cuh's bounded_ratio over the m rows of the block's column col
// (col[i], the replicated RHS b[i] and the basic variables' spans ub[i],
// all from row 2) with the same candidates (bounded_ratios) and tie rules:
// a thread keeps the candidates of its first RCACHE rows in registers
// between the two passes, and each pass is one reduction of two argmins by
// keys (the lower and the upper hits; then Bland's smallest basic index and
// the first tie). Called by every thread of the block.
constexpr int RCACHE = 2;

template <typename T>
__device__ BoundedRatio grid_ratio(const T* col, const T* b, const T* ub, int m, T t_flip,
                                   const int* basis, T piv_tol, bool bland, KeyRed<T>* sh1,
                                   KeyRed<T>* sh2) {
  const T inf = pos_inf<T>();
  const int tid = threadIdx.x;
  T tl[RCACHE], tu[RCACHE];
  bool ng[RCACHE];
  T lv = inf, uv = inf;
  int li = BIG_I, ui = BIG_I;
#pragma unroll
  for (int q = 0; q < RCACHE; ++q) {
    const int i = tid + q * THREADS;
    tl[q] = tu[q] = inf;
    ng[q] = false;
    if (i < m) {
      bounded_ratios(col[i], b[i], ub[i], piv_tol, tl[q], tu[q], ng[q]);
      pick(lv, li, tl[q], i);
      pick(uv, ui, tu[q], i);
    }
  }
  for (int i = tid + RCACHE * THREADS; i < m; i += THREADS) {
    T x, y;
    bool neg;
    bounded_ratios(col[i], b[i], ub[i], piv_tol, x, y, neg);
    pick(lv, li, x, i);
    pick(uv, ui, y, i);
  }
  key_pick2(lv, li, uv, ui, sh1);
  const T t_star = nan_min(nan_min(lv, uv), t_flip);
  const bool kind_lo = lv <= t_star;
  const bool kind_up = !kind_lo && uv <= t_star;
  // the winning kind's ties: Bland's smallest basic index (bv, bi; row 0
  // where none ties, as torch's argmin), the first tie (fi)
  T bv = inf, fv = inf;
  int bi = BIG_I, fi = BIG_I;
#pragma unroll
  for (int q = 0; q < RCACHE; ++q) {
    const int i = tid + q * THREADS;
    if (i < m) {
      const bool t = kind_lo ? tl[q] <= t_star : (ng[q] && tu[q] <= t_star);
      pick(bv, bi, t ? T(basis[i]) : T(BIG_I), i);
      if (t) pick(fv, fi, T(0), i);
    }
  }
  for (int i = tid + RCACHE * THREADS; i < m; i += THREADS) {
    T x, y;
    bool neg;
    bounded_ratios(col[i], b[i], ub[i], piv_tol, x, y, neg);
    const bool t = kind_lo ? x <= t_star : (neg && y <= t_star);
    pick(bv, bi, t ? T(basis[i]) : T(BIG_I), i);
    if (t) pick(fv, fi, T(0), i);
  }
  key_pick2(bv, bi, fv, fi, sh2);
  BoundedRatio out;
  out.has_ratio = finite_val(t_star);
  out.kind_up = kind_up;
  out.kind_flip = !kind_lo && !kind_up;
  out.r_price = bland ? bi : (fi != BIG_I ? fi : 0);
  return out;
}

// Entry (i, k) after the pivot on (rg, jp), from its pre-step value t, the
// pivot column's entry cj and the pivot row's pk: common.cuh's pivoted on
// values.
template <typename T>
__device__ __forceinline__ T pivot_entry(T cj, T pk, int rg, int jp, int i, int k, T t) {
  if (i == rg) return k == jp ? T(1) : pk;
  return k == jp ? T(0) : fma(-cj, pk, t);
}

// ---- the streamed rows: bulk async copies through a ring of tiles ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

// the mbarriers' initialisation made visible to the async proxy (then the
// block's barrier, before any copy completes on them)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0: ask for a tile of ``bytes`` from device memory into shared
// memory, completing on the slot's mbarrier (which expects the bytes).
__device__ __forceinline__ void tile_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// Thread 0: write a tile back from shared memory, as one bulk group.
__device__ __forceinline__ void tile_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// every bulk store of this thread complete: its writes done (not only its
// reads of shared memory)
__device__ __forceinline__ void stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// every bulk store of this thread has read its shared memory: the slot may
// be loaded again
__device__ __forceinline__ void stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's generic accesses to shared (global) memory ordered with
// later async-proxy accesses (the bulk copies), and the reverse
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Wait until the mbarrier's phase of parity ``parity`` has completed; past
// TILE_TIMEOUT cycles the launch traps (a lost copy would hang the grid).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned b = smem_addr(bar);
  long long t0 = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > TILE_TIMEOUT)
      __trap();
  }
}

// The block's slab: entry (i, kk) of its column kk, row i. Rows [0, R)
// live column-major in shared memory (stride R); on a streamed plan rows
// [R, M) in the block's tiles in device memory (row i in tile (i - R) / TR,
// at (i - R) mod TR of its column kk), read through L2. The one accessor of
// the slab outside the update's own loops.
template <typename T, bool STREAMED>
struct Slab {
  T* sh;
  T* scr;   // the block's first tile (STREAMED)
  int R;    // rows in shared memory (M when resident)
  int lg;   // log2 TR
  long long tse;  // elements a tile

  __device__ __forceinline__ T* tile_entry(int i, int kk) const {
    const int q = i - R;
    return scr + (long long)(q >> lg) * tse + ((long long)kk << lg) + (q & ((1 << lg) - 1));
  }
  __device__ __forceinline__ T at(int i, int kk) const {
    if (!STREAMED || i < R) return sh[(long long)kk * R + i];
    return __ldcg(tile_entry(i, kk));
  }
};

// Block 0's clock, split by stage (Stage) when the caller asks for it:
// thread 0 of block 0 adds the cycles since its last lap to the stage.
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

template <typename T, bool DEVEX, bool STREAMED>
__global__ void __launch_bounds__(THREADS, 1) grid_kernel(Params<T> p) {
  // the warps' shares of the price, ratio (two passes) and finish
  // reductions, each its own
  __shared__ KeyRed<T> kr[4][WARPS];
  __shared__ Red<T> comb;  // the grid's combined candidate of a step
  __shared__ T comb_g;
  __shared__ int comb_f;
  __shared__ Verdict<T> vsh;  // the step's verdict, read by thread 0
  __shared__ Laps laps;    // thread 0's, on block 0 only
  extern __shared__ __align__(16) unsigned char grid_dyn[];
  GridBarrier gb{p.bar, 0u, 1};
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, N = p.N, W = p.W, m = M - 2, n = N - 1;
  // this block's structural columns [k0, k0 + wk)
  const int k0 = g * W, wk = max(0, min(n, k0 + W) - k0);
  // the slab's rows in shared memory (its column stride); the ring
  const int R = STREAMED ? p.R : M;
  const int S = STREAMED ? p.S : 0, TR = STREAMED ? p.TR : 1;
  const int lg = STREAMED ? __ffs(TR) - 1 : 0;
  const long long tse = STREAMED ? p.TS / (long long)sizeof(T) : 0;
  // the block's tiles of rows [R, M)
  const int NT = STREAMED ? (M - R + TR - 1) / TR : 0;
  const Layout<T> L = layout<T>(M, N, W, R, S, STREAMED ? p.TS : 0, grid_dyn);
  const Slab<T, STREAMED> slab{L.slab, STREAMED ? p.scratch + (long long)g * NT * tse : nullptr,
                               R, lg, tse};
  const T inf = pos_inf<T>();
  T* const colJ = p.cols;          // column j, pre-step (the owner of j)
  T* const colF = p.cols + M;      // column fcol (its owner, on barrier C)
  T* const colP = p.cols + 2 * M;  // column basis[0] (its owner, on barrier C)
  if (tid == 0) {
    laps.on = p.cycles != nullptr && g == 0;
    laps.last = clock64();
    for (int k = 0; k < C_NSTAGES; ++k) laps.cyc[k] = 0;
    if (STREAMED) {
      for (int q = 0; q < S; ++q) mbar_init(L.mbar + q, 1);
      mbar_init_fence();
    }
  }

  // ---- load: the slab, the replicated vectors, the scalars ----
  for (int i = warp; i < R; i += WARPS)
    for (int kk = lane; kk < wk; kk += 32)
      L.slab[(long long)kk * R + i] = p.T_in[(long long)i * N + k0 + kk];
  if (STREAMED) {
    // the streamed rows into the block's tiles (generic writes that the
    // bulk loads read: the proxy fence, then the barrier below)
    for (int i = R + warp; i < M; i += WARPS)
      for (int kk = lane; kk < wk; kk += 32)
        *slab.tile_entry(i, kk) = p.T_in[(long long)i * N + k0 + kk];
    __threadfence_block();
    fence_async_global();
  }
  for (int i = tid; i < M; i += THREADS) L.b[i] = p.T_in[(long long)i * N + N - 1];
  for (int i = tid; i < m; i += THREADS) {
    L.basis[i] = p.basis_in[i];
    L.ub[i] = p.upper[p.basis_in[i]];
  }
  for (int k = tid; k < n; k += THREADS) L.art[k] = p.art_in[k] != 0;
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    L.act[kk] = p.act_in[k] != 0;
    L.gamma[kk] = DEVEX ? p.gamma_in[k] : T(1);
    p.at_upper_out[k] = p.at_upper_in[k];
  }
  int phase = *p.phase_in, status = *p.status_in, niter = *p.niter_in, stuck = *p.stuck_in;
  bool bland = *p.bland_in != 0;
  T last_z = *p.lastz_in;
  int n_enter = 0, n_uphit = 0;
  __syncthreads();
  // every basic column this block owns exactly the unit vector on its row
  // (a warp a row of the basis)
  bool units_bad = false;
  for (int i = warp; i < m; i += WARPS) {
    const int k = L.basis[i];
    if (k < k0 || k >= k0 + wk) continue;
    // (the column's resident rows through a hoisted pointer: the accessor
    // in this loop cost the resident instantiations registers)
    const T* col = L.slab + (long long)(k - k0) * R;
    for (int r = lane; r < M; r += 32)
      units_bad = units_bad ||
                  (STREAMED && r >= R ? slab.at(r, k - k0) : col[r]) != T(r == i + 2);
  }
  units_bad = __syncthreads_or(units_bad) != 0;

  // over the rows of the RHS and the own weights: the sum of |b| (s), the
  // first row whose basic column is artificial (a), the largest weight (v)
  Red<T> x = red_identity<T>(true);
  for (int i = tid; i < m; i += THREADS) {
    x.s = add_rn(x.s, T(fabs(L.b[i + 2])));
    if (L.art[L.basis[i]]) x.a = min(x.a, i);
  }
  if (DEVEX)
    for (int kk = tid; kk < wk; kk += THREADS) offer(x, L.gamma[kk], kk, true);
  x = key_reduce(x, true, kr[3]);
  int ra = x.a;
  T gmax_own = x.v;
  bool first = true, units_ok = true;
  // the ring: the slot of the next tile to update, each slot's parity, the
  // tiles' order this step (forward on even steps of the launch)
  int slot = 0;
  unsigned parity = 0;
  bool forward = true;
  if (tid == 0) lap(&laps, C_LOAD);

  while (status == ST_RUNNING && niter < p.max_iters) {
    // the first tiles of the step's update, asked for before its decisions:
    // the previous step's stores complete first (their rows are read
    // generically from here on)
    const int nload = min(S, NT);
    if (STREAMED) {
      if (tid == 0) {
        stores_done();
        fence_async_global();
        for (int t = 0; t < nload; ++t) {
          const int q = slot + t < S ? slot + t : slot + t - S;
          const int ti = forward ? t : NT - 1 - t;
          tile_load(L.ring + q * tse, slab.scr + ti * tse, (unsigned)p.TS, L.mbar + q);
        }
      }
      __syncthreads();
    }
    // ---- 1. price over the own columns; published; barrier A ----
    const bool cleanup = ra != BIG_I && phase == 2;
    const int r_d = ra != BIG_I ? ra : 0;
    const T* crow = L.slab + (phase == 1 ? 1 : 0);
    // the clean-up's row r_d + 2 (read where it decides: under clean-up);
    // a streamed one staged in the pivot row's segment, free until the
    // fetch
    const T* rowd = L.slab + r_d + 2;
    long long rstride = -1;  // rowd's entries R apart, as crow's
    if (STREAMED && r_d + 2 >= R) {
      rowd = L.slab + 2;
      if (cleanup) {
        for (int kk = tid; kk < wk; kk += THREADS) L.prow[kk] = slab.at(r_d + 2, kk);
        __syncthreads();
        rowd = L.prow;
        rstride = 1;
      }
    }
    Red<T> cols = key_reduce(bounded_price_scan(crow, rowd, L.act, L.art + k0, L.gamma, wk, DEVEX,
                                                p.opt_tol, p.piv_tol, (long long)R, k0, rstride),
                             DEVEX, kr[0]);
    bool bad2 = false, unit0 = false;
    for (int kk = tid; kk < wk; kk += THREADS)
      bad2 = bad2 || !finite_val(L.slab[(long long)kk * R + 2]);
    const int b0 = L.basis[0];
    if ((first || !units_ok) && b0 >= k0 && b0 < k0 + wk) {
      const T* col = L.slab + (long long)(b0 - k0) * R;
      for (int i = tid; i < M; i += THREADS)
        unit0 = unit0 || (STREAMED && i >= R ? slab.at(i, b0 - k0) : col[i]) != T(i == 2);
    }
    const int flags = (__syncthreads_or(bad2) ? F_ROW2_BAD : 0) |
                      (__syncthreads_or(unit0) ? F_UNIT0_BAD : 0) |
                      (first && units_bad ? F_UNITS_BAD : 0);
    if (tid == 0) {
      post(mail_slot(p, R_A, g), cols, gmax_own, flags);
      lap(&laps, C_PRICE);
    }
    gb.sync();
    if (tid == 0) lap(&laps, C_A);

    // ---- 2. the combine; the previous step's devex reset; the ratio
    // test by the owner of j; barrier B ----
    combine<T, DEVEX>(p, R_A, &comb, &comb_g, &comb_f);
    Red<T> all = comb;
    const int aflags = comb_f;
    if (first) units_ok = !(aflags & F_UNITS_BAD);
    if (DEVEX && !first && comb_g > p.reset_above) {
      // the plain step reset every weight after the previous step: price
      // again under unit weights (the pick alone changes)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
      __syncthreads();
      cols = key_reduce(
          bounded_price_scan(crow, STREAMED ? rowd : L.slab + r_d + 2, L.act, L.art + k0, L.gamma,
                             wk, true, p.opt_tol, p.piv_tol, (long long)R, k0, rstride),
          true, kr[1]);
      if (tid == 0) {
        post(mail_slot(p, R_R, g), cols, T(1), 0);
        lap(&laps, C_COMBINE);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_A);
      combine<T, true>(p, R_R, &comb, &comb_g, &comb_f);
      all.v = comb.v;
      all.i = comb.i;
    }
    const bool has_improving = all.a != BIG_I;
    const bool has_elig = all.b != BIG_I;
    const int j_price = bland ? (has_improving ? all.a : n - 1) : all.i;
    const bool phase1_done = phase == 1 && !has_improving;
    const bool infeasible1 = phase1_done && -L.b[1] > p.infeas_tol;
    const bool to_phase2 = phase1_done && !infeasible1;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const bool retire = cleanup && !has_elig;
    const bool crow_ok = finite_val(all.s);
    const bool finished_opt = phase == 2 && !has_improving && !cleanup;
    const int j = cleanup ? (has_elig ? all.b : n - 1) : j_price;
    if (tid == 0) lap(&laps, C_COMBINE);
    // the step's decisions the owner of j needs for r (the same in every
    // block)
    const bool do_cleanup = cleanup && has_elig;
    if (j >= k0 && j < k0 + wk) {
      const long long t0 = p.cycles && tid == 0 ? clock64() : 0;
      // the column the ratio test reads: the slab's (resident), or column
      // j gathered into L.colj, which every block overwrites from the
      // mailbox after barrier B with the same values (streamed)
      const T* col = L.slab + (long long)(j - k0) * R;
      if (STREAMED) {
        // the streamed rows through L2, four a thread at a time, their
        // loads issued before any store; then column j published whole
        for (int i0 = R + tid; i0 < M; i0 += 4 * THREADS) {
          T v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i0 + u * THREADS < M) v[u] = __ldcg(slab.tile_entry(i0 + u * THREADS, j - k0));
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i0 + u * THREADS < M) L.colj[i0 + u * THREADS] = v[u];
        }
        __syncthreads();
        for (int i = tid; i < M; i += THREADS) {
          if (i < R) L.colj[i] = col[i];
          colJ[i] = L.colj[i];
        }
        __syncthreads();
        col = L.colj;
      } else {
        for (int i = tid; i < M; i += THREADS) colJ[i] = col[i];
      }
      const BoundedRatio rt = grid_ratio(col + 2, L.b + 2, L.ub, m, p.upper[j], L.basis,
                                         p.piv_tol, bland, kr[1], kr[2]);
      if (tid == 0) {
        const int r = do_cleanup ? r_d : rt.r_price;
        Verdict<T>* vd = verdict_slot(p);
        vd->piv = col[r + 2];
        vd->gq = DEVEX ? L.gamma[j - k0] : T(0);
        vd->r = r;
        vd->has_ratio = rt.has_ratio;
        vd->kind_up = rt.kind_up;
        vd->kind_flip = rt.kind_flip;
        if (p.cycles)
          atomicAdd((unsigned long long*)p.cycles + C_OWNER,
                    (unsigned long long)(clock64() - t0));
      }
    }
    const T u_j = p.upper[j];
    if (tid == 0) lap(&laps, C_RATIO);
    gb.sync();
    if (tid == 0) lap(&laps, C_B);

    // ---- 3. the verdict; barrier C where needed; the update ----
    // (thread 0 reads the verdict for the block: a line that every block
    // reads is a hot spot in L2; each thread copies the rows of column j it
    // updates, the update's mapping)
    if (tid == 0) vsh = load_cg(verdict_slot(p));
    for (int i0 = tid; i0 < M; i0 += 4 * THREADS) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * THREADS < M) v[u] = __ldcg(colJ + i0 + u * THREADS);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * THREADS < M) L.colj[i0 + u * THREADS] = v[u];
    }
    __syncthreads();
    const int r = vsh.r;
    const bool has_ratio = vsh.has_ratio != 0, kind_up = vsh.kind_up != 0;
    const bool kind_flip = vsh.kind_flip != 0;
    const T gq = vsh.gq, piv = vsh.piv;
    const bool in_phase2 = phase == 2;
    const bool do_price = pricing_pivot && has_ratio;
    const bool do_pivot = do_cleanup || (do_price && !kind_flip);
    const bool do_flip_enter = do_price && kind_flip;
    const int leaving = L.basis[r];
    const T u_leave = L.ub[r];
    const bool do_flip = (do_price && kind_up && !cleanup) || do_flip_enter;
    const int fcol = do_flip_enter ? j : leaving;
    const bool unbounded = pricing_pivot && !has_ratio && in_phase2;
    const bool failed1 = pricing_pivot && !has_ratio && !in_phase2;
    // the update's pivot: (r + 2, j), else the plain step's redirected one
    // on (row 2, basis[0]) unless that is an exact no-op
    const bool noop = !(aflags & F_ROW2_BAD) && finite_val(L.b[2]) &&
                      (units_ok || !(aflags & F_UNIT0_BAD));
    const bool pv = do_pivot || !noop;
    const int rg = do_pivot ? r + 2 : 2, jp = do_pivot ? j : b0;
    const T uf = !do_flip ? T(0) : do_flip_enter ? u_j : u_leave;
    // the pre-step columns the update reads: the pivot's (column j, in
    // L.colj; or basis[0]: e_2 where every basic column is a unit vector)
    // and the flip's (column j; or the basic column basis[r]: e_{r+2}
    // likewise); else their owners publish them before barrier C, and
    // basis[0]'s goes to L.colj
    const bool own_p = pv && !do_pivot && !units_ok;
    const bool own_f = fcol != j && !units_ok;
    T cjr = do_pivot ? piv : T(1);  // the pivot element
    if (own_p || own_f) {
      if (own_p && b0 >= k0 && b0 < k0 + wk)
        for (int i = tid; i < M; i += THREADS) colP[i] = slab.at(i, b0 - k0);
      if (own_f && fcol >= k0 && fcol < k0 + wk)
        for (int i = tid; i < M; i += THREADS) colF[i] = slab.at(i, fcol - k0);
      gb.sync();
      if (tid == 0) lap(&laps, C_C);
      if (own_p) {
        for (int i = tid; i < M; i += THREADS) L.colj[i] = __ldcg(colP + i);
        cjr = __ldcg(colP + 2);
      }
    }
    const bool cj_sh = do_pivot || own_p;  // else e_2
    // column fcol, pre-step: column j (in L.colj on a pivot, else from the
    // mailbox), fcol's owner's copy, or e_{r+2}
    const int cf_from = fcol == j ? (do_pivot ? 1 : 2) : own_f ? 3 : 0;
    const auto cf_at = [&](int i) -> T {
      return cf_from == 1 ? L.colj[i]
             : cf_from == 2 ? __ldcg(colJ + i)
             : cf_from == 3 ? __ldcg(colF + i)
                            : T(i == r + 2);
    };
    T rinv = T(1), pf = T(0), prhs = T(0);
    if (pv) {
      rinv = div_rn(T(1), cjr);
      for (int kk = tid; kk < wk; kk += THREADS) L.prow[kk] = mul_rn(slab.at(rg, kk), rinv);
      // (column j's entry on row rg is the pivot element: L.colj's copy of
      // it belongs to another thread)
      pf = mul_rn(cf_from == 1 ? piv : cf_at(rg), rinv);
      prhs = mul_rn(L.b[rg], rinv);
    }
    // the devex weights of the own columns (alpha: the post-pivot row,
    // column j snapped to 1; each thread reads the prow entries it wrote)
    // and their NaN-first maximum (x.v)
    x = red_identity<T>(true);
    if (DEVEX)
      devex_weights(L.gamma, L.prow, wk, jp - k0, leaving - k0, do_price && !kind_flip, gq, piv,
                    x);
    __syncthreads();  // prow complete, and every read of the pre-step b[rg]
    if (tid == 0) lap(&laps, C_FETCH);
    // row i by thread i mod THREADS (the copy's mapping): the pivot over
    // the own columns (row rg set to prow, the other rows fma(-col[i],
    // prow[k], T[i, k])), then the pivot's column set to the unit vector
    // and the flipped column negated by their owners, then the RHS; the
    // resident rows only (the streamed ones tile by tile below)
    const bool jp_own = pv && jp >= k0 && jp < k0 + wk;
    const bool flip_own = do_flip && fcol >= k0 && fcol < k0 + wk;
    bool cj_bad = false;
    for (int i = tid; i < M; i += THREADS) {
      const T cj = !pv ? T(0) : cj_sh ? L.colj[i] : T(i == 2);
      cj_bad = cj_bad || !finite_val(cj);
      if (!STREAMED || i < R) {
        if (pv) {
          // four columns at a time, their loads issued before any store
          const T nc = -cj;
          const bool on_r = i == rg;
          T* e = L.slab + i;
          int kk = 0;
          for (; kk + 4 <= wk; kk += 4) {
            T v[4], pk[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              v[u] = e[(long long)(kk + u) * R];
              pk[u] = L.prow[kk + u];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
              e[(long long)(kk + u) * R] = on_r ? pk[u] : fma(nc, pk[u], v[u]);
          }
          for (; kk < wk; ++kk) {
            T* ek = e + (long long)kk * R;
            *ek = on_r ? L.prow[kk] : fma(nc, L.prow[kk], *ek);
          }
        }
        if (jp_own) L.slab[(long long)(jp - k0) * R + i] = T(i == rg);
        if (flip_own) {
          T* e = L.slab + (long long)(fcol - k0) * R + i;
          *e = -*e;
        }
      }
      const T cf = cf_at(i);
      const T tnf = pv ? pivot_entry(cj, pf, rg, jp, i, fcol, cf) : cf;
      const T bi = pv ? pivot_entry(cj, prhs, rg, jp, i, N - 1, L.b[i]) : L.b[i];
      L.b[i] = fma(-tnf, uf, bi);
    }
    // a pivot keeps every basic column a unit vector while its column and
    // 1 / pivot are finite (the same verdict in every block)
    const bool any_bad = __syncthreads_or(cj_bad) != 0;
    if (pv && (any_bad || !finite_val(rinv))) units_ok = false;
    if (tid == 0) lap(&laps, C_UPDATE);

    if (STREAMED) {
      // ---- the streamed rows: the block's tiles through the ring ----
      // (thread t takes row t mod TR of a tile and every (THREADS / TR)-th
      // column from t / TR; the same per-entry arithmetic as above)
      const int ii = tid & (TR - 1), kq = tid >> lg, ks = THREADS >> lg;
      const int jpk = jp_own ? jp - k0 : -1, fk = flip_own ? fcol - k0 : -1;
      const int nwait = pv ? NT : nload;
      for (int t = 0; t < nwait; ++t) {
        const int q = slot;
        mbar_wait(L.mbar + q, (parity >> q) & 1u);
        parity ^= 1u << q;
        slot = q + 1 == S ? 0 : q + 1;
        if (!pv) continue;  // the first tiles drained: nothing to update
        const int ti = forward ? t : NT - 1 - t;
        T* tile = L.ring + q * tse;
        const int i = R + ti * TR + ii;
        if (i < M) {
          const T cj = cj_sh ? L.colj[i] : T(i == 2);
          const T nc = -cj;
          const bool on_r = i == rg;
          for (int kk = kq; kk < wk; kk += ks) {
            T* e = tile + ((long long)kk << lg) + ii;
            T v = on_r ? L.prow[kk] : fma(nc, L.prow[kk], *e);
            if (kk == jpk) v = T(i == rg);
            if (kk == fk) v = -v;
            *e = v;
          }
        }
        // the tile's generic writes before the bulk store reads it
        fence_async_shared();
        __syncthreads();
        if (tid == 0) {
          tile_store(slab.scr + ti * tse, tile, (unsigned)p.TS);
          if (t + S < NT) {
            const int tn = t + S, tin = forward ? tn : NT - 1 - tn;
            stores_read();
            tile_load(tile, slab.scr + tin * tse, (unsigned)p.TS, L.mbar + q);
          }
        }
      }
      // a step that pivots nowhere: the flipped column's streamed rows
      // negated in place by its owner (the ring's loads have landed; the
      // next step's loads read the writes after the proxy fence and the
      // step's barriers)
      if (!pv && flip_own) {
        for (int q = tid; q < M - R; q += THREADS) {
          T* e = slab.tile_entry(R + q, fk);
          __stcg(e, -__ldcg(e));
        }
        fence_async_global();
      }
      forward = !forward;
      if (tid == 0) lap(&laps, C_STREAM);
    }

    // ---- the finish ----
    if (tid == 0) {
      if (do_pivot) {
        L.basis[r] = j;
        L.ub[r] = u_j;
      }
      // a retire pivots nowhere: the basis is the pre-step one
      if (retire) L.art[L.basis[r_d]] = 0;
      if (flip_own) p.at_upper_out[fcol] = !p.at_upper_out[fcol];
    }
    if (DEVEX && to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
    __syncthreads();
    if (to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) L.act[kk] = L.act[kk] && !L.art[k0 + kk];
    for (int i = tid; i < m; i += THREADS) {
      x.s = add_rn(x.s, T(fabs(L.b[i + 2])));
      if (L.art[L.basis[i]]) x.a = min(x.a, i);
    }
    x = key_reduce(x, true, kr[3]);
    ra = x.a;
    gmax_own = DEVEX && to_phase2 ? T(1) : x.v;
    const bool act = do_pivot || do_flip_enter;
    const T z = -L.b[phase == 1 ? 1 : 0];
    if (do_price && act) {
      stuck = sub_rn(last_z, z) > p.degen_tol ? 0 : stuck + 1;
      last_z = z;
    }
    bland = bland || stuck >= p.stall_limit;
    if (to_phase2) {
      phase = 2;
      stuck = 0;
      last_z = inf;
    }
    const bool finite_ok = finite_val(z) && finite_val(x.s) && crow_ok;
    status = !finite_ok                  ? ST_NUMERIC
             : infeasible1 || failed1    ? ST_INFEASIBLE
             : unbounded                 ? ST_UNBOUNDED
             : finished_opt              ? ST_OPTIMAL
                                         : ST_RUNNING;
    niter += act;
    n_enter += do_flip_enter;
    n_uphit += do_pivot && do_flip;
    first = false;
    if (tid == 0) lap(&laps, C_FINISH);
  }

  // ---- the last step's devex reset on the grid's largest weight ----
  if (DEVEX && !first) {
    if (tid == 0) post(mail_slot(p, R_F, g), red_identity<T>(true), gmax_own, 0);
    gb.sync();
    combine<T, true>(p, R_F, &comb, &comb_g, &comb_f);
    if (comb_g > p.reset_above)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
  }

  // ---- write back: the slab, the RHS, the masks' and weights' shares,
  // the basis and the scalars ----
  if (STREAMED) {
    // the last step's stores complete before the tiles are read back
    if (tid == 0) {
      stores_done();
      fence_async_global();
    }
    __syncthreads();
  }
  for (int i = warp; i < M; i += WARPS)
    for (int kk = lane; kk < wk; kk += 32)
      p.T_out[(long long)i * N + k0 + kk] = slab.at(i, kk);
  if (g == (int)gridDim.x - 1)
    for (int i = tid; i < M; i += THREADS) p.T_out[(long long)i * N + N - 1] = L.b[i];
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    p.act_out[k] = L.act[kk];
    p.art_out[k] = L.art[k];
    if (DEVEX) p.gamma_out[k] = L.gamma[kk];
  }
  if (g == 0) {
    for (int i = tid; i < m; i += THREADS) p.basis_out[i] = L.basis[i];
    if (tid == 0) {
      p.ints_out[O_PHASE] = phase;
      p.ints_out[O_STATUS] = status;
      p.ints_out[O_NITER] = niter;
      p.ints_out[O_STUCK] = stuck;
      p.ints_out[O_N_ENTER] = n_enter;
      p.ints_out[O_N_UPHIT] = n_uphit;
      *p.bland_out = bland;
      *p.lastz_out = last_z;
    }
  }
  if (tid == 0 && laps.on) {
    lap(&laps, C_STORE);
    for (int k = 0; k < C_NSTAGES; ++k) p.cycles[k] += laps.cyc[k];
  }
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
  p.upper = (const T*)a[A_UPPER];
  p.at_upper_in = (const unsigned char*)a[A_AT_UPPER_IN];
  p.at_upper_out = (unsigned char*)a[A_AT_UPPER_OUT];
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
  p.mail = (unsigned char*)a[A_MAIL];
  p.cols = (T*)a[A_COLS];
  p.bar = (unsigned*)a[A_BAR];
  p.cycles = (long long*)a[A_CYCLES];
  p.scratch = (T*)a[A_SCRATCH];
  p.M = in[I_M];
  p.N = in[I_N];
  p.W = in[I_WIDTH];
  p.stall_limit = in[I_STALL];
  p.max_iters = in[I_MAXIT];
  p.R = in[I_ROWS];
  p.S = in[I_STAGES];
  p.TR = in[I_TROWS];
  p.TS = in[I_TILE];
  p.opt_tol = (T)tol[D_OPT];
  p.piv_tol = (T)tol[D_PIV];
  p.degen_tol = (T)tol[D_DEGEN];
  p.infeas_tol = (T)tol[D_INFEAS];
  p.reset_above = (T)tol[D_RESET];
  return p;
}

// A streamed plan: R in [3, M), 1 to MAX_STAGES slots, TR a power of two
// up to THREADS, TS the tile's bytes rounded up to 16 (the bulk copies'
// unit).
bool streamed_ok(const int* in, long long es) {
  const int M = in[I_M], W = in[I_WIDTH], R = in[I_ROWS], S = in[I_STAGES], TR = in[I_TROWS];
  return R >= 3 && R < M && S >= 1 && S <= MAX_STAGES && TR >= 1 && TR <= THREADS &&
         (TR & (TR - 1)) == 0 && (long long)in[I_TILE] == align16((long long)TR * W * es);
}

// The plan's figures against this layout: G blocks of THREADS threads, W
// columns a block (G = ceil(n / W), at most one mailbox a thread), the
// slab's rows resident (all, or a streamed plan's), the bytes smem_bytes
// and mail_bytes count.
template <typename T>
bool plan_ok(const int* in) {
  const int M = in[I_M], N = in[I_N], G = in[I_BLOCKS], W = in[I_WIDTH];
  if (M < 3 || N < 2 || W < 1 || G < 1 || G > THREADS || in[I_THREADS] != THREADS)
    return false;
  if ((long long)G != ((long long)N - 1 + W - 1) / W) return false;
  const bool resident = in[I_ROWS] == M && in[I_STAGES] == 0 && in[I_TROWS] == 0 &&
                        in[I_TILE] == 0;
  if (!resident && !streamed_ok(in, sizeof(T))) return false;
  return (long long)in[I_SMEM] ==
             smem_bytes<T>(M, N, W, in[I_ROWS], in[I_STAGES], in[I_TILE]) &&
         (long long)in[I_MAIL] == mail_bytes(G);
}

template <typename T>
bool pointers_ok(const Params<T>& p, bool devex) {
  return p.T_in && p.T_out && p.basis_in && p.basis_out && p.act_in && p.act_out && p.art_in &&
         p.art_out && p.upper && p.at_upper_in && p.at_upper_out && p.phase_in && p.status_in &&
         p.niter_in && p.stuck_in && p.bland_in && p.lastz_in && p.ints_out && p.bland_out &&
         p.lastz_out && p.mail && p.cols && p.bar && (!devex || (p.gamma_in && p.gamma_out)) &&
         (p.R == p.M || p.scratch);
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the instantiation at
// smem bytes of dynamic shared memory, after raising its limit to them
template <typename T, bool DEVEX, bool STREAMED>
int occupancy_of(int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute((const void*)grid_kernel<T, DEVEX, STREAMED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, grid_kernel<T, DEVEX, STREAMED>,
                                                    THREADS, (size_t)smem);
  return (int)e;
}

template <typename T, bool DEVEX, bool STREAMED>
int launch_walk(const Params<T>& p, int G, int smem, cudaStream_t s) {
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int err = occupancy_of<T, DEVEX, STREAMED>(smem, &occ);
  if (err) return err;
  if (occ < 1 || G > occ * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<T> q = p;
  void* args[] = {&q};
  e = cudaLaunchCooperativeKernel((const void*)grid_kernel<T, DEVEX, STREAMED>, dim3(G),
                                  dim3(THREADS), args, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int bounded_grid(const long long* a, const int* in, const double* tol, void* stream) {
  if (!plan_ok<T>(in)) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(a, in, tol);
  const bool devex = in[I_DEVEX] != 0, streamed = in[I_ROWS] < in[I_M];
  if (!pointers_ok(p, devex)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = in[I_BLOCKS], smem = in[I_SMEM];
  if (streamed)
    return devex ? launch_walk<T, true, true>(p, G, smem, s)
                 : launch_walk<T, false, true>(p, G, smem, s);
  return devex ? launch_walk<T, true, false>(p, G, smem, s)
               : launch_walk<T, false, false>(p, G, smem, s);
}

template <typename T>
int bounded_grid_occupancy(const int* in, int* blocks) {
  if (!plan_ok<T>(in) || !blocks) return (int)cudaErrorInvalidValue;
  const bool devex = in[I_DEVEX] != 0, streamed = in[I_ROWS] < in[I_M];
  if (streamed)
    return devex ? occupancy_of<T, true, true>(in[I_SMEM], blocks)
                 : occupancy_of<T, false, true>(in[I_SMEM], blocks);
  return devex ? occupancy_of<T, true, false>(in[I_SMEM], blocks)
               : occupancy_of<T, false, false>(in[I_SMEM], blocks);
}

}  // namespace bgr
}  // namespace tpulp

extern "C" int tpulp_bounded_grid_f32(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::bgr::bounded_grid<float>(a, in, tol, stream);
}
extern "C" int tpulp_bounded_grid_f64(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::bgr::bounded_grid<double>(a, in, tol, stream);
}
// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the plan's launch: the
// blocks an SM holds at once (the grid must fit that times the SMs)
extern "C" int tpulp_bounded_grid_occupancy_f32(const int* in, int* blocks) {
  return tpulp::bgr::bounded_grid_occupancy<float>(in, blocks);
}
extern "C" int tpulp_bounded_grid_occupancy_f64(const int* in, int* blocks) {
  return tpulp::bgr::bounded_grid_occupancy<double>(in, blocks);
}
