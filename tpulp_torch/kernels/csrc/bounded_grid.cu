// bounded_grid: the solo bounded-variable walk (solve/bounded.py::
// bounded_simplex_step) stepped to its exit or to max_iters in one
// persistent cooperative launch of G blocks, each keeping a column slab of
// the tableau in its shared memory, or, past the shared memory, the slab's
// first R rows there and the rest streamed through device memory, or, past
// even a slab's first three rows, every row streamed (the wide plan).
//
// Replaces no Pallas kernel: in tpulp the walk is XLA's compiled
// ``lax.while_loop`` over ``bounded_simplex_step`` (tpulp/solve/bounded.py:
// 86-276 the step, 278-307 the driver). It takes the place of four
// stream-ordered launches a step (price, ratio and finish on one block
// each, the whole tableau through device memory twice a step, one host
// enqueue a step) for every frame the card's memory holds
// (kernels/bounded_grid.py::bounded_grid_plan): past the frames whose
// replicated vectors also fit (up to 6,284 rows at f64 with n = 2m), the
// per-row vectors live in device memory (DVEC, below); past the slabs
// whose first three rows and tile ring fit a block (3,098 columns at f64,
// 6,032 at f32), no row of a slab does (wide_kernel, below the grid
// kernel).
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
//    and the plain step's tie rules, each thread's candidates kept in
//    registers between its two passes) with the replicated RHS, basis and
//    spans, and publishes the verdict: the step's row, the kinds, the
//    pivot element.
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
// not an exact no-op, as in lanes.cu. A mailbox is written once a step
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
// The per-row vectors in device memory (DVEC, always streamed; the plan
// takes it where the replicated vectors leave rows 0-2 and the ring no
// room, or where it is forced): the RHS, the basis and the basic
// variables' spans live in device memory, two copies each (a step reads
// copy cur, which no block writes before barrier D, and its owners write
// copy cur ^ 1), and a block keeps only its own columns' artificial flags
// (the device copy is art_out). Block g owns the basic rows [g H, (g + 1)
// H), H = ceil(m / G) (block 0 the two objective rows too): it loads them,
// and in the finish updates their RHS entries with the same fma, operands
// and order as above, writes their basis and spans (row r the entering
// column's) and the retired artificial's flag where it owns r_d, and sums
// its rows' |b| in block_reduce's order with their first artificial basic
// row. It posts both to the mailbox; a fourth grid barrier (D) ends the
// step, and the combine adds the blocks' sums in grid_sum's order (the
// plain version's |b| check takes the same order: grid_sum over slabs of H
// rows). The ratio test is split over the blocks: the owner of j takes
// column j's resident rows [2, R) (and publishes rows [0, R) of it), every
// block its share's streamed rows, read through L2 from the owner's tiles
// (and publishes them); each block posts its two argmins (common.cuh's
// bounded_ratios, lower and upper hits), combined in block order by keys
// after barrier B, then its picks of the winning kind's ties (Bland's
// smallest basic index, the first tie), combined after barrier B' (the
// same picks as grid_ratio's two key reductions: pick's order is total).
// Every block then reads the pre-step column j entry, b[r + 2], basis[r],
// its span and basis[r_d] itself; the owner's mailbox brings j's devex
// weight and the blocks' flags whether column j is finite. Every block
// reads b[1] and b[2] after barrier A and the step's objective row after
// barrier D, and keeps basis[0] in a register. The update reads column j
// from device memory: a resident row its own entry, a tile its TR entries
// staged in shared memory by TR threads one tile ahead. The ring has a
// slot more, and a slot is reloaded a tile after its store, so that no
// thread waits for the store of the tile it has just updated. Every read
// of a vector that another block writes goes through L2 (__ldcg), after
// the barrier that orders the write.
//
// The frame is loaded once and stored once, with the basis, the masks, the
// weights, the scalars and the two counters (entering flips, upper hits);
// the host reads them once a walk. The arithmetic is lanes.cu's: one
// rounding per product in the decisions, IEEE division, prow = row * (1 /
// piv), comparisons in the tableau's type
// against tolerances rounded to it, the sums of the finiteness checks in a
// fixed order (a block's as common.cuh's block_reduce takes it; the
// blocks' |c| sums lane by lane in slab order, then the warp's tree;
// kernels/bounded_grid.py takes them in the same order). The barrier is
// common.cuh's flag barrier (GridBarrier); the wrapper zeroes its counter
// before each launch. A block has 512 threads: at 1,024, f64 spilled in
// rank1_cluster.cu, the same shape of kernel.

#include "grid.cuh"

namespace tpulp {
namespace bgr {

using namespace grid;

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
// the wrapper's argument arrays (tpulp_torch/kernels/bounded_grid.py)
enum Arg {
  A_T_IN, A_T_OUT, A_BASIS_IN, A_BASIS_OUT, A_ACT_IN, A_ACT_OUT, A_ART_IN, A_ART_OUT, A_UPPER,
  A_AT_UPPER_IN, A_AT_UPPER_OUT, A_GAMMA_IN, A_GAMMA_OUT, A_PHASE_IN, A_STATUS_IN, A_NITER_IN,
  A_STUCK_IN, A_BLAND_IN, A_LASTZ_IN, A_INTS_OUT, A_BLAND_OUT, A_LASTZ_OUT, A_MAIL, A_COLS,
  A_BAR, A_CYCLES, A_SCRATCH, A_BVEC, A_NARGS
};
// I_ROWS: R, the slab's rows in shared memory (M on a resident plan);
// I_STAGES: the tile ring's slots; I_TROWS: TR, rows a tile; I_TILE: TS,
// bytes a tile (the last three 0 on a resident plan); I_VECS: 1 where the
// per-row vectors live in device memory (DVEC), 2 on the wide plan (R 0)
enum Int {
  I_M, I_N, I_STALL, I_MAXIT, I_DEVEX, I_BLOCKS, I_WIDTH, I_THREADS, I_SMEM, I_MAIL, I_ROWS,
  I_STAGES, I_TROWS, I_TILE, I_VECS, I_NINTS
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
// finish (DVEC: with the RHS share), barrier D (DVEC); then the store; and
// apart, the ratio test and the publication on the clock of the block that
// owns j, whichever it is. DVEC: the ratio stage is the first pass over the
// block's rows, the combine stage takes the first pass's combine and the
// second pass too, barrier B is B and B', the fetch stage takes the second
// combine, the update stage leaves the RHS to the finish, and "owner" is
// the owner of j's first pass (bounded_grid.py's GRID_DEVICE_VECTOR_STAGES
// names these spans apart).
enum Stage {
  C_LOAD, C_PRICE, C_A, C_COMBINE, C_RATIO, C_B, C_C, C_FETCH, C_UPDATE, C_STREAM, C_FINISH,
  C_D, C_STORE, C_OWNER, C_NSTAGES
};

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
  T* cols;              // (3 M,): column j | column fcol | column basis[0];
                        // DVEC (5 M + 2 m,): then two copies of the RHS
                        // (M) and of the spans (m)
  unsigned* bar;        // the grid barrier's counter, zeroed by the wrapper
  long long* cycles;    // (C_NSTAGES,) SM cycles per stage (block 0), or null
  T* scratch;           // STREAMED: G regions of NT tiles of TS bytes;
                        // the wide plan: G regions of its chunks (WideSlab)
  int* bvec;            // DVEC and the wide plan: the basis, two copies of m
  int M, N, W, stall_limit, max_iters;
  int R, S, TR;  // resident rows, the ring's slots, rows a tile (STREAMED)
  int TS;        // bytes a tile (STREAMED)
  // the tolerances rounded to T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, reset_above;
};


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
  T* cjs;                    // DVEC: column j's entries of two tiles' rows
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

// The dynamic shared memory of a DVEC block: the slab's R resident rows,
// the tile ring, the pivot row's and the devex weights' segments (W each),
// column j's entries of two tiles (2 TR), the segment's active and
// artificial masks (W each) and the mbarriers.
template <typename T>
__host__ __device__ long long smem_bytes_dv(int W, int R, int S, int TS, int TR) {
  const long long es = sizeof(T);
  return align16((long long)R * W * es) + (long long)S * TS + 2 * align16((long long)W * es) +
         align16(2LL * TR * es) + 2 * align16(W) + align16(8LL * S);
}

template <typename T>
__device__ Layout<T> layout_dv(int W, int R, int S, int TS, int TR, unsigned char* dyn) {
  Layout<T> L;
  const long long es = sizeof(T);
  long long off = 0;
  L.slab = (T*)(dyn + off);
  off += align16((long long)R * W * es);
  L.ring = (T*)(dyn + off);
  off += (long long)S * TS;
  L.prow = (T*)(dyn + off);
  off += align16((long long)W * es);
  L.gamma = (T*)(dyn + off);
  off += align16((long long)W * es);
  L.cjs = (T*)(dyn + off);
  off += align16(2LL * TR * es);
  L.act = dyn + off;
  off += align16(W);
  L.art = dyn + off;
  off += align16(W);
  L.mbar = (unsigned long long*)(dyn + off);
  L.b = L.colj = L.ub = nullptr;
  L.basis = nullptr;
  return L;
}

// A DVEC step's verdict, the same in every block: the ratio test's row
// and kinds (from the two combines), column j's entry on row r + 2, the
// entering column's devex weight (from its owner's mailbox), and the
// pre-step basis[r], its span, b[r + 2] and basis[r_d]; whether column j
// has an entry that is not finite.
template <typename T>
struct DvVerdict {
  T piv, gq, brow, ulv;
  int r, leaving, bd, has_ratio, kind_up, kind_flip, colj_bad;
};

// Two NaN-first argmin picks over the G mailboxes of a region (DVEC's
// ratio test: each block's two candidates in v, i and s, a), combined as
// combine_mail combines its pick: lane l of warp 0 takes blocks l, l + 32,
// ... in turn, then the warp by keys; with the largest gmax (NaN first)
// and the flags' union. Called by every thread; the result is in out
// (v, i, s as the second pick's value, a as its index), gmax and flags
// after its barrier.
template <typename T>
__device__ void combine_picks(unsigned char* mail, int region, Red<T>* out, T* gmax,
                              int* flags) {
  constexpr int U = 4;  // blocks a lane loads at once
  const int lane = threadIdx.x & 31, G = gridDim.x;
  if (threadIdx.x < 32) {
    const T inf = pos_inf<T>();
    T v1 = inf, v2 = inf, gm = -inf;
    int i1 = BIG_I, i2 = BIG_I, fl = 0;
    for (int q0 = 0; q0 < G; q0 += 32 * U) {
      Mail<T> mb[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = q0 + u * 32 + lane;
        if (q < G) mb[u] = load_cg(mail_slot<T>(mail, region, q));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (q0 + u * 32 + lane >= G) continue;
        pick(v1, i1, mb[u].v, mb[u].i);
        pick(v2, i2, mb[u].s, mb[u].a);
        gm = nan_max(gm, mb[u].gmax);
        fl |= mb[u].flags;
      }
    }
    using K = typename KeyOf<T>::type;
    K k1 = okey(v1, false), k2 = okey(v2, false), kg = okey(gm, true);
    unsigned j1 = (unsigned)i1, j2 = (unsigned)i2, ig = 0;
    warp_arg(k1, j1, false);
    warp_arg(k2, j2, false);
    warp_arg(kg, ig, true);
    fl = (int)__reduce_or_sync(FULL, (unsigned)fl);
    if (lane == 0) {
      out->v = key_value(k1, false);
      out->i = (int)j1;
      out->s = key_value(k2, false);
      out->a = (int)j2;
      *gmax = key_value(kg, true);
      *flags = fl;
    }
  }
  __syncthreads();
}

// The plain step's three-way ratio test over the m rows of the block's
// column col (col[i], the replicated RHS b[i] and the basic variables'
// spans ub[i], all from row 2) with the same candidates (bounded_ratios)
// and tie rules:
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


template <typename T, bool DEVEX, bool STREAMED, bool DVEC>
__global__ void __launch_bounds__(THREADS, 1) grid_kernel(Params<T> p) {
  static_assert(STREAMED || !DVEC, "the per-row vectors in device memory stream the slab");
  // the warps' shares of the price, ratio (two passes) and finish
  // reductions, each its own
  __shared__ KeyRed<T> kr[4][WARPS];
  __shared__ Red<T> comb;  // the grid's combined candidate of a step
  __shared__ T comb_g;
  __shared__ int comb_f;
  __shared__ Verdict<T> vsh;  // the step's verdict, read by thread 0
  __shared__ DvVerdict<T> dsh;  // DVEC: the step's verdict
  // DVEC: b[1] and b[2] before the step's update, and the objective row
  // after it (thread 0's reads through L2)
  __shared__ T bsh[3];
  __shared__ Laps<C_NSTAGES> laps;    // thread 0's, on block 0 only
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
  const Layout<T> L = DVEC ? layout_dv<T>(W, R, S, p.TS, TR, grid_dyn)
                           : layout<T>(M, N, W, R, S, STREAMED ? p.TS : 0, grid_dyn);
  const Slab<T, STREAMED> slab{L.slab, STREAMED ? p.scratch + (long long)g * NT * tse : nullptr,
                               R, lg, tse};
  const T inf = pos_inf<T>();
  T* const colJ = p.cols;          // column j, pre-step (the owner of j)
  T* const colF = p.cols + M;      // column fcol (its owner, on barrier C)
  T* const colP = p.cols + 2 * M;  // column basis[0] (its owner, on barrier C)
  // DVEC: the RHS, the spans and the basis in device memory, two copies
  // each: a step reads copy cur and writes copy cur ^ 1; the basic rows
  // [q0, q1) this block owns
  T* const rhsV = p.cols + 3 * M;       // 2 x M
  T* const ubV = p.cols + 5 * M;        // 2 x m
  int cur = 0;
  const int H = DVEC ? (m + (int)gridDim.x - 1) / (int)gridDim.x : 0;
  const int q0 = DVEC ? min(m, g * H) : 0, q1 = DVEC ? min(m, q0 + H) : 0;
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
  if (DVEC) {
    // the own basic rows' RHS entries, basis and spans (block 0 the
    // objective rows' RHS too)
    for (int q = q0 + tid; q < q1; q += THREADS) {
      const int k = p.basis_in[q];
      p.bvec[q] = k;
      ubV[q] = p.upper[k];
      rhsV[q + 2] = p.T_in[(long long)(q + 2) * N + N - 1];
    }
    if (g == 0 && tid < 2) rhsV[tid] = p.T_in[(long long)tid * N + N - 1];
  } else {
    for (int i = tid; i < M; i += THREADS) L.b[i] = p.T_in[(long long)i * N + N - 1];
    for (int i = tid; i < m; i += THREADS) {
      L.basis[i] = p.basis_in[i];
      L.ub[i] = p.upper[p.basis_in[i]];
    }
    for (int k = tid; k < n; k += THREADS) L.art[k] = p.art_in[k] != 0;
  }
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    L.act[kk] = p.act_in[k] != 0;
    L.gamma[kk] = DEVEX ? p.gamma_in[k] : T(1);
    p.at_upper_out[k] = p.at_upper_in[k];
    if (DVEC) {
      // the own flags, and their device copy
      const unsigned char a = p.art_in[k] != 0;
      L.art[kk] = a;
      p.art_out[k] = a;
    }
  }
  int phase = *p.phase_in, status = *p.status_in, niter = *p.niter_in, stuck = *p.stuck_in;
  bool bland = *p.bland_in != 0;
  T last_z = *p.lastz_in;
  int n_enter = 0, n_uphit = 0;
  int b0d = DVEC ? p.basis_in[0] : 0;  // DVEC: basis[0], in every thread
  __syncthreads();
  // every basic column this block owns exactly the unit vector on its row
  // (a warp a row of the basis)
  bool units_bad = false;
  for (int i = warp; i < m; i += WARPS) {
    const int k = DVEC ? p.basis_in[i] : L.basis[i];
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
    if (DVEC) {
      // (the inputs: no block writes them)
      if (p.art_in[p.basis_in[i]]) x.a = min(x.a, i);
      continue;
    }
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
    Red<T> cols = key_reduce(bounded_price_scan(crow, rowd, L.act, DVEC ? L.art : L.art + k0, L.gamma, wk, DEVEX,
                                                p.opt_tol, p.piv_tol, (long long)R, k0, rstride),
                             DEVEX, kr[0]);
    bool bad2 = false, unit0 = false;
    for (int kk = tid; kk < wk; kk += THREADS)
      bad2 = bad2 || !finite_val(L.slab[(long long)kk * R + 2]);
    const int b0 = DVEC ? b0d : L.basis[0];
    if ((first || !units_ok) && b0 >= k0 && b0 < k0 + wk) {
      const T* col = L.slab + (long long)(b0 - k0) * R;
      for (int i = tid; i < M; i += THREADS)
        unit0 = unit0 || (STREAMED && i >= R ? slab.at(i, b0 - k0) : col[i]) != T(i == 2);
    }
    const int flags = (__syncthreads_or(bad2) ? F_ROW2_BAD : 0) |
                      (__syncthreads_or(unit0) ? F_UNIT0_BAD : 0) |
                      (first && units_bad ? F_UNITS_BAD : 0);
    if (tid == 0) {
      post(mail_slot<T>(p.mail, R_A, g), cols, gmax_own, flags);
      lap(&laps, C_PRICE);
    }
    gb.sync();
    if (tid == 0) lap(&laps, C_A);

    // ---- 2. the combine; the previous step's devex reset; the ratio
    // test by the owner of j; barrier B ----
    // (DVEC: this step's copy of the vectors, read-only until barrier D,
    // and the next step's, written by their owners in the finish)
    const T* const rhsC = rhsV + cur * M;
    T* const rhsN = rhsV + (cur ^ 1) * M;
    const T* const ubC = ubV + cur * m;
    T* const ubN = ubV + (cur ^ 1) * m;
    const int* const basC = p.bvec + cur * m;
    int* const basN = p.bvec + (cur ^ 1) * m;
    if (DVEC && tid == 0) {
      bsh[0] = __ldcg(rhsC + 1);
      bsh[1] = __ldcg(rhsC + 2);
    }
    combine_mail<T>(p.mail, R_A, DEVEX, &comb, &comb_g, &comb_f);
    Red<T> all = comb;
    const int aflags = comb_f;
    if (first) units_ok = !(aflags & F_UNITS_BAD);
    if (DEVEX && !first && comb_g > p.reset_above) {
      // the plain step reset every weight after the previous step: price
      // again under unit weights (the pick alone changes)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
      __syncthreads();
      cols = key_reduce(
          bounded_price_scan(crow, STREAMED ? rowd : L.slab + r_d + 2, L.act,
                             DVEC ? L.art : L.art + k0, L.gamma, wk, true, p.opt_tol,
                             p.piv_tol, (long long)R, k0, rstride),
          true, kr[1]);
      if (tid == 0) {
        post(mail_slot<T>(p.mail, R_R, g), cols, T(1), 0);
        lap(&laps, C_COMBINE);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_A);
      combine_mail<T>(p.mail, R_R, true, &comb, &comb_g, &comb_f);
      all.v = comb.v;
      all.i = comb.i;
    }
    const bool has_improving = all.a != BIG_I;
    const bool has_elig = all.b != BIG_I;
    const int j_price = bland ? (has_improving ? all.a : n - 1) : all.i;
    const bool phase1_done = phase == 1 && !has_improving;
    const bool infeasible1 = phase1_done && -(DVEC ? bsh[0] : L.b[1]) > p.infeas_tol;
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
    if (DVEC) {
      // the ratio test over the blocks' rows: the owner of j its resident
      // rows [2, R) (and publishes rows [0, R) of column j), every block its
      // share's streamed rows, read from the owner's tiles (and publishes
      // them); each block's two picks combined in block order after
      // barrier B (its region R_F), the winning kind's ties after a second
      // barrier B' (region A), as grid_ratio takes them
      const long long t0 = p.cycles && tid == 0 ? clock64() : 0;
      const bool own_j = j >= k0 && j < k0 + wk;
      const int go = j / W;
      const Slab<T, true> jslab{nullptr, p.scratch + (long long)go * NT * tse, R, lg, tse};
      const int kj = j - go * W;
      const T* const colr = L.slab + (long long)(j - k0) * R;  // own_j
      const int qs = max(q0, R - 2);  // the share's streamed rows [qs, q1)
      const T t_flip = p.upper[j];
      T lv = inf, uv = inf;
      int li = BIG_I, ui = BIG_I;
      bool bad = false;
      if (own_j)
        for (int i = tid; i < R; i += THREADS) {
          const T c = colr[i];
          colJ[i] = c;
          bad = bad || !finite_val(c);
          if (i >= 2) {
            T x, y;
            bool neg;
            bounded_ratios(c, __ldcg(rhsC + i), __ldcg(ubC + i - 2), p.piv_tol, x, y, neg);
            pick(lv, li, x, i - 2);
            pick(uv, ui, y, i - 2);
          }
        }
      for (int q = qs + tid; q < q1; q += THREADS) {
        const T c = __ldcg(jslab.tile_entry(q + 2, kj));
        colJ[q + 2] = c;
        bad = bad || !finite_val(c);
        T x, y;
        bool neg;
        bounded_ratios(c, __ldcg(rhsC + q + 2), __ldcg(ubC + q), p.piv_tol, x, y, neg);
        pick(lv, li, x, q);
        pick(uv, ui, y, q);
      }
      key_pick2(lv, li, uv, ui, kr[1]);
      const bool any = __syncthreads_or(bad) != 0;
      if (tid == 0) {
        Red<T> c1;
        c1.v = lv;
        c1.i = li;
        c1.s = uv;
        c1.a = ui;
        c1.b = BIG_I;
        post(mail_slot<T>(p.mail, R_F, g), c1, own_j && DEVEX ? L.gamma[j - k0] : -inf,
             any ? 1 : 0);
        if (p.cycles && own_j)
          atomicAdd((unsigned long long*)p.cycles + C_OWNER,
                    (unsigned long long)(clock64() - t0));
        lap(&laps, C_RATIO);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_B);
      combine_picks<T>(p.mail, R_F, &comb, &comb_g, &comb_f);
      const T t_star = nan_min(nan_min(comb.v, comb.s), t_flip);
      const bool kind_lo = comb.v <= t_star;
      const bool kind_up = !kind_lo && comb.s <= t_star;
      const T gq = comb_g;
      const int colj_bad = comb_f;
      // the winning kind's ties: Bland's smallest basic index (bv, bi; row
      // 0 where none ties), the first tie (fv, fi)
      T bv = inf, fv = inf;
      int bi = BIG_I, fi = BIG_I;
      const auto tie = [&](int q, T c) {
        T x, y;
        bool neg;
        bounded_ratios(c, __ldcg(rhsC + q + 2), __ldcg(ubC + q), p.piv_tol, x, y, neg);
        const bool t = kind_lo ? x <= t_star : (neg && y <= t_star);
        pick(bv, bi, t ? T(__ldcg(basC + q)) : T(BIG_I), q);
        if (t) pick(fv, fi, T(0), q);
      };
      if (own_j)
        for (int i = 2 + tid; i < R; i += THREADS) tie(i - 2, colr[i]);
      for (int q = qs + tid; q < q1; q += THREADS) tie(q, __ldcg(colJ + q + 2));
      key_pick2(bv, bi, fv, fi, kr[2]);
      if (tid == 0) {
        Red<T> c2;
        c2.v = bv;
        c2.i = bi;
        c2.s = fv;
        c2.a = fi;
        c2.b = BIG_I;
        post(mail_slot<T>(p.mail, R_A, g), c2, -inf, 0);
        lap(&laps, C_COMBINE);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_B);
      combine_picks<T>(p.mail, R_A, &comb, &comb_g, &comb_f);
      if (tid == 0) {
        const int r = do_cleanup ? r_d : bland ? comb.i : (comb.a != BIG_I ? comb.a : 0);
        // this step's copies: no block writes them before barrier D
        dsh.piv = __ldcg(colJ + r + 2);
        dsh.brow = __ldcg(rhsC + r + 2);
        dsh.ulv = __ldcg(ubC + r);
        dsh.leaving = __ldcg(basC + r);
        dsh.bd = __ldcg(basC + r_d);
        dsh.gq = gq;
        dsh.r = r;
        dsh.has_ratio = finite_val(t_star);
        dsh.kind_up = kind_up;
        dsh.kind_flip = !kind_lo && !kind_up;
        dsh.colj_bad = colj_bad;
      }
    }
    if (!DVEC && j >= k0 && j < k0 + wk) {
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
        Verdict<T>* vd = verdict_slot<T>(p.mail);
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
    if (!DVEC) {
      if (tid == 0) lap(&laps, C_RATIO);
      gb.sync();
      if (tid == 0) lap(&laps, C_B);
    }

    // ---- 3. the verdict; barrier C where needed; the update ----
    // (thread 0 reads the verdict for the block: a line that every block
    // reads is a hot spot in L2; each thread copies the rows of column j it
    // updates, the update's mapping)
    if (!DVEC && tid == 0) vsh = load_cg(verdict_slot<T>(p.mail));
    for (int i0 = tid; !DVEC && i0 < M; i0 += 4 * THREADS) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * THREADS < M) v[u] = __ldcg(colJ + i0 + u * THREADS);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * THREADS < M) L.colj[i0 + u * THREADS] = v[u];
    }
    __syncthreads();
    const int r = DVEC ? dsh.r : vsh.r;
    const bool has_ratio = (DVEC ? dsh.has_ratio : vsh.has_ratio) != 0;
    const bool kind_up = (DVEC ? dsh.kind_up : vsh.kind_up) != 0;
    const bool kind_flip = (DVEC ? dsh.kind_flip : vsh.kind_flip) != 0;
    const T gq = DVEC ? dsh.gq : vsh.gq, piv = DVEC ? dsh.piv : vsh.piv;
    const bool in_phase2 = phase == 2;
    const bool do_price = pricing_pivot && has_ratio;
    const bool do_pivot = do_cleanup || (do_price && !kind_flip);
    const bool do_flip_enter = do_price && kind_flip;
    const int leaving = DVEC ? dsh.leaving : L.basis[r];
    const T u_leave = DVEC ? dsh.ulv : L.ub[r];
    const bool do_flip = (do_price && kind_up && !cleanup) || do_flip_enter;
    const int fcol = do_flip_enter ? j : leaving;
    const bool unbounded = pricing_pivot && !has_ratio && in_phase2;
    const bool failed1 = pricing_pivot && !has_ratio && !in_phase2;
    // the update's pivot: (r + 2, j), else the plain step's redirected one
    // on (row 2, basis[0]) unless that is an exact no-op
    const bool noop = !(aflags & F_ROW2_BAD) && finite_val(DVEC ? bsh[1] : L.b[2]) &&
                      (units_ok || !(aflags & F_UNIT0_BAD));
    const bool pv = do_pivot || !noop;
    const int rg = do_pivot ? r + 2 : 2, jp = do_pivot ? j : b0;
    const T uf = !do_flip ? T(0) : do_flip_enter ? u_j : u_leave;
    // the pre-step columns the update reads: the pivot's (column j, in
    // L.colj; or basis[0]: e_2 where every basic column is a unit vector)
    // and the flip's (column j; or the basic column basis[r]: e_{r+2}
    // likewise); else their owners publish them before barrier C, and
    // basis[0]'s goes to L.colj (DVEC: read from colP)
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
        for (int i = tid; !DVEC && i < M; i += THREADS) L.colj[i] = __ldcg(colP + i);
        cjr = __ldcg(colP + 2);
      }
    }
    const bool cj_sh = do_pivot || own_p;  // else e_2
    const T* const cjd = own_p ? colP : colJ;  // DVEC: that column
    // column fcol, pre-step: column j (in L.colj on a pivot, else from the
    // mailbox; DVEC: from the mailbox), fcol's owner's copy, or e_{r+2}
    const int cf_from = fcol == j ? (do_pivot && !DVEC ? 1 : 2) : own_f ? 3 : 0;
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
      prhs = mul_rn(DVEC ? (do_pivot ? dsh.brow : bsh[1]) : L.b[rg], rinv);
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
    for (int i = tid; i < (DVEC ? R : M); i += THREADS) {
      const T cj = !pv ? T(0) : cj_sh ? (DVEC ? __ldcg(cjd + i) : L.colj[i]) : T(i == 2);
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
      if (DVEC) continue;  // the RHS: its owners', in the finish
      const T cf = cf_at(i);
      const T tnf = pv ? pivot_entry(cj, pf, rg, jp, i, fcol, cf) : cf;
      const T bi = pv ? pivot_entry(cj, prhs, rg, jp, i, N - 1, L.b[i]) : L.b[i];
      L.b[i] = fma(-tnf, uf, bi);
    }
    // DVEC: column j's entries of the first tile's rows, staged (the
    // streamed update reads them)
    if (DVEC && pv && cj_sh && tid < TR && NT > 0) {
      const int i = R + (forward ? 0 : NT - 1) * TR + tid;
      L.cjs[tid] = i < M ? __ldcg(cjd + i) : T(0);
    }
    // a pivot keeps every basic column a unit vector while its column and
    // 1 / pivot are finite (the same verdict in every block; DVEC: column
    // j's, from the blocks' flags, the only column that matters while
    // units_ok)
    bool any_bad;
    if (DVEC) {
      __syncthreads();
      any_bad = do_pivot && dsh.colj_bad != 0;
    } else {
      any_bad = __syncthreads_or(cj_bad) != 0;
    }
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
        // DVEC: column j's entries of the next tile's rows, asked for
        // before this tile's wait and staged after its update
        const bool stage = DVEC && pv && cj_sh && tid < TR && t + 1 < NT;
        T cj_next = T(0);
        if (stage) {
          const int in = R + (forward ? t + 1 : NT - 2 - t) * TR + tid;
          if (in < M) cj_next = __ldcg(cjd + in);
        }
        const int q = slot;
        mbar_wait(L.mbar + q, (parity >> q) & 1u);
        parity ^= 1u << q;
        slot = q + 1 == S ? 0 : q + 1;
        if (!pv) continue;  // the first tiles drained: nothing to update
        const int ti = forward ? t : NT - 1 - t;
        T* tile = L.ring + q * tse;
        const int i = R + ti * TR + ii;
        if (i < M) {
          const T cj = cj_sh ? (DVEC ? L.cjs[(t & 1) * TR + ii] : L.colj[i]) : T(i == 2);
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
        if (stage) L.cjs[((t + 1) & 1) * TR + tid] = cj_next;
        // the tile's generic writes before the bulk store reads it
        fence_async_shared();
        __syncthreads();
        if (tid == 0) {
          tile_store(slab.scr + ti * tse, tile, (unsigned)p.TS);
          if (DVEC) {
            // (DVEC) the previous tile's slot, reloaded once its store has
            // read it: this tile's store is not waited for
            if (t >= 1 && t - 1 + S < NT) {
              const int qp = q == 0 ? S - 1 : q - 1;
              const int tn = t - 1 + S, tin = forward ? tn : NT - 1 - tn;
              stores_read_but_one();
              tile_load(L.ring + qp * tse, slab.scr + tin * tse, (unsigned)p.TS, L.mbar + qp);
            }
          } else if (t + S < NT) {
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
      if (!DVEC && do_pivot) {
        L.basis[r] = j;
        L.ub[r] = u_j;
      }
      // a retire pivots nowhere: the basis is the pre-step one (DVEC: the
      // retired column's owner clears its flag, the row's its device copy)
      if (!DVEC && retire) L.art[L.basis[r_d]] = 0;
      if (DVEC && retire && dsh.bd >= k0 && dsh.bd < k0 + wk) L.art[dsh.bd - k0] = 0;
      if (flip_own) p.at_upper_out[fcol] = !p.at_upper_out[fcol];
    }
    if (DVEC && do_pivot && r == 0) b0d = j;
    if (DEVEX && to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
    __syncthreads();
    if (to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS)
        L.act[kk] = L.act[kk] && !L.art[DVEC ? kk : k0 + kk];
    if (DVEC) {
      // the own rows of the next copies: the RHS (the update above, row by
      // row: column j's and column fcol's entries through L2), the basis
      // and the spans (row r the entering column's); the retired
      // artificial's flag; the rows' |b| sum (in block_reduce's order) and
      // their first artificial basic row
      const auto rhs_row = [&](int i) -> T {
        const T b_i = __ldcg(rhsC + i);
        const T cj = !pv ? T(0) : cj_sh ? __ldcg(cjd + i) : T(i == 2);
        const T cf = cf_at(i);
        const T tnf = pv ? pivot_entry(cj, pf, rg, jp, i, fcol, cf) : cf;
        const T bi = pv ? pivot_entry(cj, prhs, rg, jp, i, N - 1, b_i) : b_i;
        const T v = fma(-tnf, uf, bi);
        rhsN[i] = v;
        return v;
      };
      if (g == 0 && tid < 2) rhs_row(tid);
      for (int q = q0 + tid; q < q1; q += THREADS) {
        x.s = add_rn(x.s, T(fabs(rhs_row(q + 2))));
        const bool in = do_pivot && q == r;
        const int k = in ? j : __ldcg(basC + q);
        basN[q] = k;
        ubN[q] = in ? u_j : __ldcg(ubC + q);
        bool a;
        if (retire && q == r_d) {
          p.art_out[k] = 0;
          a = false;
        } else {
          a = __ldcg(p.art_out + k) != 0;
        }
        if (a) x.a = min(x.a, q);
      }
    } else {
      for (int i = tid; i < m; i += THREADS) {
        x.s = add_rn(x.s, T(fabs(L.b[i + 2])));
        if (L.art[L.basis[i]]) x.a = min(x.a, i);
      }
    }
    x = key_reduce(x, true, kr[3]);
    if (DVEC) {
      // the blocks' sums and first rows, combined after barrier D (the
      // repricing's region: its next use follows barrier A); the step's
      // objective row, updated by block 0
      if (tid == 0) {
        post(mail_slot<T>(p.mail, R_R, g), x, T(0), 0);
        lap(&laps, C_FINISH);
      }
      gb.sync();
      if (tid == 0) {
        lap(&laps, C_D);
        bsh[2] = __ldcg(rhsN + (phase == 1 ? 1 : 0));
      }
      combine_mail<T>(p.mail, R_R, true, &comb, &comb_g, &comb_f);
      x.s = comb.s;
      x.a = comb.a;
    }
    ra = x.a;
    gmax_own = DEVEX && to_phase2 ? T(1) : x.v;
    const bool act = do_pivot || do_flip_enter;
    const T z = -(DVEC ? bsh[2] : L.b[phase == 1 ? 1 : 0]);
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
    if (DVEC) cur ^= 1;
    if (tid == 0) lap(&laps, C_FINISH);
  }

  // ---- the last step's devex reset on the grid's largest weight ----
  if (DEVEX && !first) {
    if (tid == 0) post(mail_slot<T>(p.mail, R_F, g), red_identity<T>(true), gmax_own, 0);
    gb.sync();
    combine_mail<T>(p.mail, R_F, true, &comb, &comb_g, &comb_f);
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
  if (DVEC) {
    // the own rows of the RHS and the basis, from the last copies
    for (int q = q0 + tid; q < q1; q += THREADS) {
      p.T_out[(long long)(q + 2) * N + N - 1] = __ldcg(rhsV + cur * M + q + 2);
      p.basis_out[q] = __ldcg(p.bvec + cur * m + q);
    }
    if (g == 0 && tid < 2) p.T_out[(long long)tid * N + N - 1] = __ldcg(rhsV + cur * M + tid);
  } else if (g == (int)gridDim.x - 1) {
    for (int i = tid; i < M; i += THREADS) p.T_out[(long long)i * N + N - 1] = L.b[i];
  }
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    p.act_out[k] = L.act[kk];
    p.art_out[k] = L.art[DVEC ? kk : k];
    if (DEVEX) p.gamma_out[k] = L.gamma[kk];
  }
  if (g == 0) {
    for (int i = tid; !DVEC && i < m; i += THREADS) p.basis_out[i] = L.basis[i];
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
// the wide plan (I_VECS 2): no row of a slab in shared memory
// ---------------------------------------------------------------------------

constexpr int WCH = THREADS;  // the wide plan's columns a chunk: one a thread

// The dynamic shared memory of a wide block: the ring (S tiles of TS
// bytes), column j's entries of two tiles (2 TR) and the ring's mbarriers.
template <typename T>
__host__ __device__ long long smem_bytes_wide(int S, int TS, int TR) {
  return (long long)S * TS + align16(2LL * TR * (long long)sizeof(T)) + align16(8LL * S);
}

// A block's slab on the wide plan: its region of the scratch buffer (M x
// ceil(W / WCH) WCH entries) and its wk columns, in chunks of WCH columns;
// chunk c (the columns [c WCH, c WCH + wc(c))) is an M x wp(c) row-major
// matrix at c M WCH entries of the region (wp: wc rounded up to 4, so that
// every row of it is 16-byte aligned), and a tile is TR of its rows,
// contiguous. Entries are read through L2 (L1 is not coherent with the
// bulk copies' writes).
template <typename T>
struct WideSlab {
  T* scr;
  int M, wk;

  __device__ __forceinline__ int nc() const { return (wk + WCH - 1) / WCH; }
  __device__ __forceinline__ int wc(int c) const { return min(WCH, wk - c * WCH); }
  __device__ __forceinline__ int wp(int c) const { return (wc(c) + 3) & ~3; }
  __device__ __forceinline__ T* row(int c, int i) const {
    return scr + (long long)c * M * WCH + (long long)i * wp(c);
  }
  __device__ __forceinline__ T* entry(int i, int kk) const {
    const int c = kk / WCH;
    return row(c, i) + (kk - c * WCH);
  }
  __device__ __forceinline__ T at(int i, int kk) const { return __ldcg(entry(i, kk)); }
};

// Block q's slab on the wide plan.
template <typename T>
__device__ __forceinline__ WideSlab<T> wide_slab(const Params<T>& p, int q) {
  const long long region = (long long)p.M * ((p.W + WCH - 1) / WCH) * WCH;
  const int k0 = q * p.W;
  return WideSlab<T>{p.scratch + q * region, p.M, min(p.N - 1, k0 + p.W) - k0};
}

// Tile s of a step's walk over a block's ns tiles (chunks of nt row
// tiles), chunk-major: (chunk c, row tile t); the reverse order where not
// forward.
__device__ __forceinline__ void wide_tile(int s, bool forward, int nt, int ns, int& c, int& t) {
  const int q = forward ? s : ns - 1 - s;
  c = q / nt;
  t = q - c * nt;
}

// The wide plan's price pass, this thread's share: its columns t, t + WCH,
// ... of the block in turn (bounded_price_scan's entries and order: the
// |c| sums are grid_sum's), four at a time with their loads issued first;
// the pricing row ci, the clean-up's row di (-1: row 2 stands in, its
// first eligible column unread), row 2's finiteness (bad2), the active and
// artificial masks and the weights (1 where ``unit``).
template <typename T, bool DEVEX>
__device__ Red<T> wide_price(const WideSlab<T>& sl, const Params<T>& p, int k0, int ci, int di,
                             bool unit, bool& bad2) {
  constexpr int U = 4;
  Red<T> cols = red_identity<T>(DEVEX);
  for (int kk0 = threadIdx.x; kk0 < sl.wk; kk0 += U * THREADS) {
    T c[U], d[U], r2[U], gm[U];
    bool a[U], ar[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kk0 + u * THREADS;
      c[u] = d[u] = r2[u] = gm[u] = T(0);
      a[u] = ar[u] = false;
      if (kk >= sl.wk) continue;
      c[u] = sl.at(ci, kk);
      r2[u] = sl.at(2, kk);
      d[u] = di >= 0 ? sl.at(di, kk) : r2[u];
      a[u] = p.act_out[k0 + kk] != 0;
      ar[u] = __ldcg(p.art_out + k0 + kk) != 0;
      gm[u] = DEVEX && !unit ? p.gamma_out[k0 + kk] : T(1);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kk0 + u * THREADS;
      if (kk >= sl.wk) continue;
      bounded_price_entry(cols, c[u], a[u], a[u] && !ar[u] && T(fabs(d[u])) > p.piv_tol, gm[u],
                          k0 + kk, DEVEX, p.opt_tol);
      bad2 = bad2 || !finite_val(r2[u]);
    }
  }
  return cols;
}

// The walk on the wide plan: the device-vector plan's steps (DVEC in
// grid_kernel: the same decisions, mailboxes, barriers, ratio test over
// the blocks' rows, |b| sums and finish) with every row of the slab in the
// scratch buffer (WideSlab). Thread t owns column t of each of the block's
// chunks: its pricing entries, its pivot row entry and devex weight (read
// from device memory at the chunk's first tile, the next chunk's asked for
// then), its active mask and weight, whose working copies are act_out and
// gamma_out (only their owner writes them); the artificial mask lives in
// art_out alone (a retired flag is cleared by its row's owner; read through
// L2). A step: the first S tiles asked for; the price pass (wide_price);
// barrier A; the combine (and devex's repricing); the owner of j publishes
// column j's rows 0-1 and every block its share's rows from the owner's
// chunks, with its two ratio picks; barriers B and B' (and C); then, where
// the step pivots, the update of every tile chunk by chunk, each entry one
// fma of its pre-step value as on the other plans (forward on even steps
// of the launch, backward on odd ones: the first tiles a step reads are
// the last the previous one wrote, the ones L2 still holds); the finish
// and barrier D. The price stays a pass of its own: an update that priced
// the next step as it wrote the pricing row (the |c| entries kept a chunk
// apart, so that their sum keeps the pass's order) was slower on the H100,
// at both types. The stage clock keeps grid_kernel's counters, named by
// kernels/bounded_grid.py's GRID_WIDE_STAGES: C_FETCH the verdict's
// scalars, C_UPDATE the first tile's staging.
template <typename T, bool DEVEX>
__global__ void __launch_bounds__(THREADS, 1) wide_kernel(Params<T> p) {
  __shared__ KeyRed<T> kr[4][WARPS];
  __shared__ Red<T> comb;
  __shared__ T comb_g;
  __shared__ int comb_f;
  __shared__ DvVerdict<T> dsh;
  // b[1] and b[2] before the step's update, and the objective row after it
  __shared__ T bsh[3];
  __shared__ Laps<C_NSTAGES> laps;
  extern __shared__ __align__(16) unsigned char grid_dyn[];
  GridBarrier gb{p.bar, 0u, 1};
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, N = p.N, W = p.W, m = M - 2, n = N - 1;
  const int k0 = g * W;
  const WideSlab<T> slab = wide_slab(p, g);
  const int wk = slab.wk, nc = slab.nc();
  const int S = p.S, TR = p.TR;
  const long long tse = p.TS / (long long)sizeof(T);
  // the row tiles of a chunk, the block's tiles
  const int NT = (M + TR - 1) / TR, NS = nc * NT;
  T* const ring = (T*)grid_dyn;
  T* const cjs = (T*)(grid_dyn + (long long)S * p.TS);
  unsigned long long* const mbar = (unsigned long long*)(grid_dyn + (long long)S * p.TS +
                                                         align16(2LL * TR * (long long)sizeof(T)));
  const T inf = pos_inf<T>();
  T* const colJ = p.cols;
  T* const colF = p.cols + M;
  T* const colP = p.cols + 2 * M;
  T* const rhsV = p.cols + 3 * M;
  T* const ubV = p.cols + 5 * M;
  int cur = 0;
  const int H = (m + (int)gridDim.x - 1) / (int)gridDim.x;
  const int q0 = min(m, g * H), q1 = min(m, q0 + H);
  const auto tile_bytes = [&](int c, int t) {
    return (unsigned)(min(TR, M - t * TR) * slab.wp(c) * (int)sizeof(T));
  };
  if (tid == 0) {
    laps.on = p.cycles != nullptr && g == 0;
    laps.last = clock64();
    for (int k = 0; k < C_NSTAGES; ++k) laps.cyc[k] = 0;
    for (int q = 0; q < S; ++q) mbar_init(mbar + q, 1);
    mbar_init_fence();
  }

  // ---- load: the slab into its chunks (generic writes that the bulk loads
  // read: the proxy fence, then the barriers below), the own basic rows'
  // vectors, the own columns' masks and weights, the scalars ----
  for (int c = 0; c < nc; ++c) {
    if (tid >= slab.wc(c)) continue;
    const T* src = p.T_in + k0 + c * WCH + tid;
    for (int i0 = 0; i0 < M; i0 += 4) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < M) v[u] = src[(long long)(i0 + u) * N];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < M) slab.row(c, i0 + u)[tid] = v[u];
    }
  }
  __threadfence_block();
  fence_async_global();
  for (int q = q0 + tid; q < q1; q += THREADS) {
    const int k = p.basis_in[q];
    p.bvec[q] = k;
    ubV[q] = p.upper[k];
    rhsV[q + 2] = p.T_in[(long long)(q + 2) * N + N - 1];
  }
  if (g == 0 && tid < 2) rhsV[tid] = p.T_in[(long long)tid * N + N - 1];
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    p.act_out[k] = p.act_in[k] != 0;
    p.art_out[k] = p.art_in[k] != 0;
    if (DEVEX) p.gamma_out[k] = p.gamma_in[k];
    p.at_upper_out[k] = p.at_upper_in[k];
  }
  int phase = *p.phase_in, status = *p.status_in, niter = *p.niter_in, stuck = *p.stuck_in;
  bool bland = *p.bland_in != 0;
  T last_z = *p.lastz_in;
  int n_enter = 0, n_uphit = 0;
  int b0 = p.basis_in[0];  // basis[0], in every thread
  __syncthreads();
  // every basic column this block owns exactly the unit vector on its row
  // (a warp a row of the basis)
  bool units_bad = false;
  for (int i = warp; i < m; i += WARPS) {
    const int k = p.basis_in[i];
    if (k < k0 || k >= k0 + wk) continue;
    for (int r = lane; r < M; r += 32)
      units_bad = units_bad || slab.at(r, k - k0) != T(r == i + 2);
  }
  units_bad = __syncthreads_or(units_bad) != 0;
  // the first row whose basic column is artificial (a), the largest own
  // weight (v)
  Red<T> x = red_identity<T>(true);
  for (int i = tid; i < m; i += THREADS)
    if (p.art_in[p.basis_in[i]]) x.a = min(x.a, i);
  if (DEVEX)
    for (int kk = tid; kk < wk; kk += THREADS) offer(x, p.gamma_out[k0 + kk], kk, true);
  x = key_reduce(x, true, kr[3]);
  int ra = x.a;
  T gmax_own = x.v;
  bool first = true, units_ok = true;
  // the ring: the slot of the next tile, each slot's parity, the tiles'
  // order this step
  int slot = 0;
  unsigned parity = 0;
  bool forward = true;
  if (tid == 0) lap(&laps, C_LOAD);

  while (status == ST_RUNNING && niter < p.max_iters) {
    // the first tiles of the step's update, asked for before its decisions
    // (the previous step's stores complete first: their rows are read
    // generically from here on)
    const int nload = min(S, NS);
    if (tid == 0) {
      stores_done();
      fence_async_global();
      for (int t = 0; t < nload; ++t) {
        const int q = slot + t < S ? slot + t : slot + t - S;
        int c, ti;
        wide_tile(t, forward, NT, NS, c, ti);
        tile_load(ring + q * tse, slab.row(c, ti * TR), tile_bytes(c, ti), mbar + q);
      }
    }
    __syncthreads();
    // ---- 1. price over the own columns; published; barrier A ----
    const bool cleanup = ra != BIG_I && phase == 2;
    const int r_d = ra != BIG_I ? ra : 0;
    const int ci = phase == 1 ? 1 : 0, di = cleanup ? r_d + 2 : -1;
    bool bad2 = false, unit0 = false;
    Red<T> cols = key_reduce(wide_price<T, DEVEX>(slab, p, k0, ci, di, false, bad2), DEVEX, kr[0]);
    if ((first || !units_ok) && b0 >= k0 && b0 < k0 + wk)
      for (int i = tid; i < M; i += THREADS) unit0 = unit0 || slab.at(i, b0 - k0) != T(i == 2);
    const int flags = (__syncthreads_or(bad2) ? F_ROW2_BAD : 0) |
                      (__syncthreads_or(unit0) ? F_UNIT0_BAD : 0) |
                      (first && units_bad ? F_UNITS_BAD : 0);
    if (tid == 0) {
      post(mail_slot<T>(p.mail, R_A, g), cols, gmax_own, flags);
      lap(&laps, C_PRICE);
    }
    gb.sync();
    if (tid == 0) lap(&laps, C_A);

    // ---- 2. the combine; the previous step's devex reset; the ratio
    // test over the blocks' rows; barriers B and B' ----
    // (this step's copy of the vectors, read-only until barrier D, and the
    // next step's, written by their owners in the finish)
    const T* const rhsC = rhsV + cur * M;
    T* const rhsN = rhsV + (cur ^ 1) * M;
    const T* const ubC = ubV + cur * m;
    T* const ubN = ubV + (cur ^ 1) * m;
    const int* const basC = p.bvec + cur * m;
    int* const basN = p.bvec + (cur ^ 1) * m;
    if (tid == 0) {
      bsh[0] = __ldcg(rhsC + 1);
      bsh[1] = __ldcg(rhsC + 2);
    }
    combine_mail<T>(p.mail, R_A, DEVEX, &comb, &comb_g, &comb_f);
    Red<T> all = comb;
    const int aflags = comb_f;
    if (first) units_ok = !(aflags & F_UNITS_BAD);
    if (DEVEX && !first && comb_g > p.reset_above) {
      // the plain step reset every weight after the previous step: price
      // again under unit weights (the pick alone changes)
      for (int kk = tid; kk < wk; kk += THREADS) p.gamma_out[k0 + kk] = T(1);
      bool unused = false;
      cols = key_reduce(wide_price<T, true>(slab, p, k0, ci, di, true, unused), true, kr[1]);
      if (tid == 0) {
        post(mail_slot<T>(p.mail, R_R, g), cols, T(1), 0);
        lap(&laps, C_COMBINE);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_A);
      combine_mail<T>(p.mail, R_R, true, &comb, &comb_g, &comb_f);
      all.v = comb.v;
      all.i = comb.i;
    }
    const bool has_improving = all.a != BIG_I;
    const bool has_elig = all.b != BIG_I;
    const int j_price = bland ? (has_improving ? all.a : n - 1) : all.i;
    const bool phase1_done = phase == 1 && !has_improving;
    const bool infeasible1 = phase1_done && -bsh[0] > p.infeas_tol;
    const bool to_phase2 = phase1_done && !infeasible1;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const bool retire = cleanup && !has_elig;
    const bool crow_ok = finite_val(all.s);
    const bool finished_opt = phase == 2 && !has_improving && !cleanup;
    const int j = cleanup ? (has_elig ? all.b : n - 1) : j_price;
    if (tid == 0) lap(&laps, C_COMBINE);
    const bool do_cleanup = cleanup && has_elig;
    {
      // the owner of j publishes column j's rows 0-1; every block its
      // share's rows from the owner's chunks, with its two picks, combined
      // in block order after barrier B (region R_F); the winning kind's
      // ties after barrier B' (region A)
      const long long t0 = p.cycles && tid == 0 ? clock64() : 0;
      const bool own_j = j >= k0 && j < k0 + wk;
      const WideSlab<T> jslab = wide_slab(p, j / W);
      const int kj = j - (j / W) * W;
      const T t_flip = p.upper[j];
      T lv = inf, uv = inf;
      int li = BIG_I, ui = BIG_I;
      bool bad = false;
      if (own_j && tid < 2) {
        const T c = slab.at(tid, j - k0);
        colJ[tid] = c;
        bad = !finite_val(c);
      }
      for (int q = q0 + tid; q < q1; q += THREADS) {
        const T c = jslab.at(q + 2, kj);
        colJ[q + 2] = c;
        bad = bad || !finite_val(c);
        T tl, tu;
        bool neg;
        bounded_ratios(c, __ldcg(rhsC + q + 2), __ldcg(ubC + q), p.piv_tol, tl, tu, neg);
        pick(lv, li, tl, q);
        pick(uv, ui, tu, q);
      }
      key_pick2(lv, li, uv, ui, kr[1]);
      const bool any = __syncthreads_or(bad) != 0;
      if (tid == 0) {
        Red<T> c1;
        c1.v = lv;
        c1.i = li;
        c1.s = uv;
        c1.a = ui;
        c1.b = BIG_I;
        post(mail_slot<T>(p.mail, R_F, g), c1, own_j && DEVEX ? __ldcg(p.gamma_out + j) : -inf,
             any ? 1 : 0);
        if (p.cycles && own_j)
          atomicAdd((unsigned long long*)p.cycles + C_OWNER,
                    (unsigned long long)(clock64() - t0));
        lap(&laps, C_RATIO);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_B);
      combine_picks<T>(p.mail, R_F, &comb, &comb_g, &comb_f);
      const T t_star = nan_min(nan_min(comb.v, comb.s), t_flip);
      const bool kind_lo = comb.v <= t_star;
      const bool kind_up = !kind_lo && comb.s <= t_star;
      const T gq = comb_g;
      const int colj_bad = comb_f;
      // the winning kind's ties: Bland's smallest basic index (bv, bi; row
      // 0 where none ties), the first tie (fv, fi)
      T bv = inf, fv = inf;
      int bi = BIG_I, fi = BIG_I;
      for (int q = q0 + tid; q < q1; q += THREADS) {
        T tl, tu;
        bool neg;
        bounded_ratios(__ldcg(colJ + q + 2), __ldcg(rhsC + q + 2), __ldcg(ubC + q), p.piv_tol, tl,
                       tu, neg);
        const bool t = kind_lo ? tl <= t_star : (neg && tu <= t_star);
        pick(bv, bi, t ? T(__ldcg(basC + q)) : T(BIG_I), q);
        if (t) pick(fv, fi, T(0), q);
      }
      key_pick2(bv, bi, fv, fi, kr[2]);
      if (tid == 0) {
        Red<T> c2;
        c2.v = bv;
        c2.i = bi;
        c2.s = fv;
        c2.a = fi;
        c2.b = BIG_I;
        post(mail_slot<T>(p.mail, R_A, g), c2, -inf, 0);
        lap(&laps, C_COMBINE);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_B);
      combine_picks<T>(p.mail, R_A, &comb, &comb_g, &comb_f);
      if (tid == 0) {
        const int r = do_cleanup ? r_d : bland ? comb.i : (comb.a != BIG_I ? comb.a : 0);
        // this step's copies: no block writes them before barrier D
        dsh.piv = __ldcg(colJ + r + 2);
        dsh.brow = __ldcg(rhsC + r + 2);
        dsh.ulv = __ldcg(ubC + r);
        dsh.leaving = __ldcg(basC + r);
        dsh.bd = __ldcg(basC + r_d);
        dsh.gq = gq;
        dsh.r = r;
        dsh.has_ratio = finite_val(t_star);
        dsh.kind_up = kind_up;
        dsh.kind_flip = !kind_lo && !kind_up;
        dsh.colj_bad = colj_bad;
      }
    }
    const T u_j = p.upper[j];
    __syncthreads();

    // ---- 3. the verdict; barrier C where needed; the update ----
    const int r = dsh.r;
    const bool has_ratio = dsh.has_ratio != 0;
    const bool kind_up = dsh.kind_up != 0;
    const bool kind_flip = dsh.kind_flip != 0;
    const T gq = dsh.gq, piv = dsh.piv;
    const bool in_phase2 = phase == 2;
    const bool do_price = pricing_pivot && has_ratio;
    const bool do_pivot = do_cleanup || (do_price && !kind_flip);
    const bool do_flip_enter = do_price && kind_flip;
    const int leaving = dsh.leaving;
    const T u_leave = dsh.ulv;
    const bool do_flip = (do_price && kind_up && !cleanup) || do_flip_enter;
    const int fcol = do_flip_enter ? j : leaving;
    const bool unbounded = pricing_pivot && !has_ratio && in_phase2;
    const bool failed1 = pricing_pivot && !has_ratio && !in_phase2;
    // the update's pivot: (r + 2, j), else the plain step's redirected one
    // on (row 2, basis[0]) unless that is an exact no-op
    const bool noop = !(aflags & F_ROW2_BAD) && finite_val(bsh[1]) &&
                      (units_ok || !(aflags & F_UNIT0_BAD));
    const bool pv = do_pivot || !noop;
    const int rg = do_pivot ? r + 2 : 2, jp = do_pivot ? j : b0;
    const T uf = !do_flip ? T(0) : do_flip_enter ? u_j : u_leave;
    // the pre-step columns the update reads: the pivot's (column j from the
    // mailbox; or basis[0]: e_2 where every basic column is a unit vector)
    // and the flip's (column j; or the basic column basis[r]: e_{r+2}
    // likewise); else their owners publish them before barrier C
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
      if (own_p) cjr = __ldcg(colP + 2);
    }
    const bool cj_sh = do_pivot || own_p;      // else e_2
    const T* const cjd = own_p ? colP : colJ;  // that column
    // column fcol, pre-step: column j (from the mailbox), fcol's owner's
    // copy, or e_{r+2}
    const int cf_from = fcol == j ? 2 : own_f ? 3 : 0;
    const auto cf_at = [&](int i) -> T {
      return cf_from == 2 ? __ldcg(colJ + i) : cf_from == 3 ? __ldcg(colF + i) : T(i == r + 2);
    };
    T rinv = T(1), pf = T(0), prhs = T(0);
    if (pv) {
      rinv = div_rn(T(1), cjr);
      pf = mul_rn(cf_at(rg), rinv);
      prhs = mul_rn(do_pivot ? dsh.brow : bsh[1], rinv);
    }
    const bool jp_own = pv && jp >= k0 && jp < k0 + wk;
    const bool flip_own = do_flip && fcol >= k0 && fcol < k0 + wk;
    // a pivot keeps every basic column a unit vector while column j (the
    // blocks' flags) and 1 / pivot are finite
    if (pv && ((do_pivot && dsh.colj_bad != 0) || !finite_val(rinv))) units_ok = false;
    // the devex weights' largest, NaN first (x.v)
    x = red_identity<T>(true);
    if (tid == 0) lap(&laps, C_FETCH);

    {
      // ---- the tiles, chunk by chunk through the ring ----
      const int jpk = jp_own ? jp - k0 : -1, fk = flip_own ? fcol - k0 : -1;
      const bool upd = do_price && !kind_flip;
      const T qd = div_rn(gq, mul_rn(piv, piv));
      const T leave = is_nan(qd) ? qd : (qd < T(1) ? T(1) : qd);
      const int nwait = pv ? NS : nload;
      // the first chunk's pivot row entry and weight (thread t: the chunk's
      // column t), column j's entries of the first tile's rows
      int c_cur = -1;
      T raw = T(0), gnext = T(1), pk = T(0);
      if (pv) {
        int c, t;
        wide_tile(0, forward, NT, NS, c, t);
        if (tid < slab.wc(c)) {
          raw = __ldcg(slab.row(c, rg) + tid);
          if (DEVEX) gnext = p.gamma_out[k0 + c * WCH + tid];
        }
        if (cj_sh && tid < TR) {
          const int i = t * TR + tid;
          cjs[tid] = i < M ? __ldcg(cjd + i) : T(0);
        }
      }
      __syncthreads();
      if (tid == 0) lap(&laps, C_UPDATE);
      for (int s = 0; s < nwait; ++s) {
        int c, t;
        wide_tile(s, forward, NT, NS, c, t);
        const int w = slab.wc(c);
        if (pv && c != c_cur) {
          // the chunk's first tile: its pivot row entry and the own
          // column's devex weight (common.cuh's devex_weights on it), then
          // the next chunk's asked for
          c_cur = c;
          pk = mul_rn(raw, rinv);
          if (DEVEX && tid < w) {
            const int kk = c * WCH + tid;
            T gw = gnext;
            if (upd) {
              const T a = kk == jp - k0 ? T(1) : pk;
              gw = nan_max(gw, mul_rn(mul_rn(a, a), gq));
              if (kk == leaving - k0) gw = leave;
            }
            p.gamma_out[k0 + kk] = gw;
            offer(x, gw, kk, true);
          }
          if (s + NT < NS) {
            int c2, t2;
            wide_tile(s + NT, forward, NT, NS, c2, t2);
            if (tid < slab.wc(c2)) {
              raw = __ldcg(slab.row(c2, rg) + tid);
              if (DEVEX) gnext = p.gamma_out[k0 + c2 * WCH + tid];
            }
          }
        }
        // column j's entries of the next tile's rows, asked for before this
        // tile's wait and staged after its update
        const bool stage = pv && cj_sh && tid < TR && s + 1 < NS;
        T cj_next = T(0);
        if (stage) {
          int c2, t2;
          wide_tile(s + 1, forward, NT, NS, c2, t2);
          const int in = t2 * TR + tid;
          if (in < M) cj_next = __ldcg(cjd + in);
        }
        const int q = slot;
        mbar_wait(mbar + q, (parity >> q) & 1u);
        parity ^= 1u << q;
        slot = q + 1 == S ? 0 : q + 1;
        if (!pv) continue;  // the first tiles drained: nothing to update
        // thread t: column t of the tile, every row (the same per-entry
        // arithmetic as grid_kernel's)
        T* const tile = ring + q * tse;
        if (tid < w) {
          const int kk = c * WCH + tid, wp = slab.wp(c), rows = min(TR, M - t * TR);
          for (int ii = 0; ii < rows; ++ii) {
            const int i = t * TR + ii;
            const T cj = cj_sh ? cjs[(s & 1) * TR + ii] : T(i == 2);
            T* e = tile + ii * wp + tid;
            T v = i == rg ? pk : fma(-cj, pk, *e);
            if (kk == jpk) v = T(i == rg);
            if (kk == fk) v = -v;
            *e = v;
          }
        }
        if (stage) cjs[((s + 1) & 1) * TR + tid] = cj_next;
        // the tile's generic writes before the bulk store reads it
        fence_async_shared();
        __syncthreads();
        if (tid == 0) {
          tile_store(slab.row(c, t * TR), tile, tile_bytes(c, t));
          // the previous tile's slot, reloaded once its store has read it:
          // this tile's store is not waited for
          if (s >= 1 && s - 1 + S < NS) {
            const int qp = q == 0 ? S - 1 : q - 1;
            int c2, t2;
            wide_tile(s - 1 + S, forward, NT, NS, c2, t2);
            stores_read_but_one();
            tile_load(ring + qp * tse, slab.row(c2, t2 * TR), tile_bytes(c2, t2), mbar + qp);
          }
        }
      }
      if (DEVEX && !pv)
        for (int kk = tid; kk < wk; kk += THREADS) offer(x, p.gamma_out[k0 + kk], kk, true);
      // a step that pivots nowhere: the flipped column negated in place by
      // its owner (the ring's loads have landed; the next step's loads read
      // the writes after the proxy fence and the step's barriers)
      if (!pv && flip_own) {
        for (int i = tid; i < M; i += THREADS) {
          T* e = slab.entry(i, fk);
          __stcg(e, -__ldcg(e));
        }
        fence_async_global();
      }
      forward = !forward;
      if (tid == 0) lap(&laps, C_STREAM);
    }

    // ---- the finish ----
    if (tid == 0 && flip_own) p.at_upper_out[fcol] = !p.at_upper_out[fcol];
    if (do_pivot && r == 0) b0 = j;
    if (to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        if (DEVEX) p.gamma_out[k] = T(1);
        p.act_out[k] = p.act_out[k] && !__ldcg(p.art_out + k);
      }
    {
      // the own rows of the next copies: the RHS (row by row: column j's
      // and column fcol's entries through L2), the basis and the spans (row
      // r the entering column's); the retired artificial's flag; the rows'
      // |b| sum (in block_reduce's order) and their first artificial basic
      // row
      const auto rhs_row = [&](int i) -> T {
        const T b_i = __ldcg(rhsC + i);
        const T cj = !pv ? T(0) : cj_sh ? __ldcg(cjd + i) : T(i == 2);
        const T cf = cf_at(i);
        const T tnf = pv ? pivot_entry(cj, pf, rg, jp, i, fcol, cf) : cf;
        const T bi = pv ? pivot_entry(cj, prhs, rg, jp, i, N - 1, b_i) : b_i;
        const T v = fma(-tnf, uf, bi);
        rhsN[i] = v;
        return v;
      };
      if (g == 0 && tid < 2) rhs_row(tid);
      for (int q = q0 + tid; q < q1; q += THREADS) {
        x.s = add_rn(x.s, T(fabs(rhs_row(q + 2))));
        const bool in = do_pivot && q == r;
        const int k = in ? j : __ldcg(basC + q);
        basN[q] = k;
        ubN[q] = in ? u_j : __ldcg(ubC + q);
        bool a;
        if (retire && q == r_d) {
          p.art_out[k] = 0;
          a = false;
        } else {
          a = __ldcg(p.art_out + k) != 0;
        }
        if (a) x.a = min(x.a, q);
      }
    }
    x = key_reduce(x, true, kr[3]);
    // the blocks' sums and first rows, combined after barrier D (the
    // repricing's region: its next use follows barrier A); the step's
    // objective row, updated by block 0
    if (tid == 0) {
      post(mail_slot<T>(p.mail, R_R, g), x, T(0), 0);
      lap(&laps, C_FINISH);
    }
    gb.sync();
    if (tid == 0) {
      lap(&laps, C_D);
      bsh[2] = __ldcg(rhsN + (phase == 1 ? 1 : 0));
    }
    const T gmax_step = x.v;
    combine_mail<T>(p.mail, R_R, true, &comb, &comb_g, &comb_f);
    ra = comb.a;
    gmax_own = DEVEX && to_phase2 ? T(1) : gmax_step;
    const bool act = do_pivot || do_flip_enter;
    const T z = -bsh[2];
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
    const bool finite_ok = finite_val(z) && finite_val(comb.s) && crow_ok;
    status = !finite_ok               ? ST_NUMERIC
             : infeasible1 || failed1 ? ST_INFEASIBLE
             : unbounded              ? ST_UNBOUNDED
             : finished_opt           ? ST_OPTIMAL
                                      : ST_RUNNING;
    niter += act;
    n_enter += do_flip_enter;
    n_uphit += do_pivot && do_flip;
    first = false;
    cur ^= 1;
    if (tid == 0) lap(&laps, C_FINISH);
  }

  // ---- the last step's devex reset on the grid's largest weight ----
  if (DEVEX && !first) {
    if (tid == 0) post(mail_slot<T>(p.mail, R_F, g), red_identity<T>(true), gmax_own, 0);
    gb.sync();
    combine_mail<T>(p.mail, R_F, true, &comb, &comb_g, &comb_f);
    if (comb_g > p.reset_above)
      for (int kk = tid; kk < wk; kk += THREADS) p.gamma_out[k0 + kk] = T(1);
  }

  // ---- write back: the slab (the masks and weights are in place), the
  // RHS and the basis from the last copies, the scalars ----
  if (tid == 0) {
    stores_done();
    fence_async_global();
  }
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    if (tid >= slab.wc(c)) continue;
    T* dst = p.T_out + k0 + c * WCH + tid;
    for (int i0 = 0; i0 < M; i0 += 4) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < M) v[u] = __ldcg(slab.row(c, i0 + u) + tid);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < M) dst[(long long)(i0 + u) * N] = v[u];
    }
  }
  for (int q = q0 + tid; q < q1; q += THREADS) {
    p.T_out[(long long)(q + 2) * N + N - 1] = __ldcg(rhsV + cur * M + q + 2);
    p.basis_out[q] = __ldcg(p.bvec + cur * m + q);
  }
  if (g == 0) {
    if (tid < 2) p.T_out[(long long)tid * N + N - 1] = __ldcg(rhsV + cur * M + tid);
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
  p.bvec = (int*)a[A_BVEC];
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
  if ((long long)in[I_MAIL] != mail_bytes(G) || in[I_VECS] < 0 || in[I_VECS] > 2) return false;
  if (in[I_VECS] == 2) {
    // the wide plan: no row in shared memory, a ring of at least two slots
    // of TR x WCH entries
    const int S = in[I_STAGES], TR = in[I_TROWS];
    return in[I_ROWS] == 0 && S >= 2 && S <= MAX_STAGES && TR >= 1 && TR <= THREADS &&
           (TR & (TR - 1)) == 0 && (long long)in[I_TILE] == (long long)TR * WCH * sizeof(T) &&
           (long long)in[I_SMEM] == smem_bytes_wide<T>(S, in[I_TILE], TR);
  }
  if (in[I_VECS])
    return streamed_ok(in, sizeof(T)) &&
           (long long)in[I_SMEM] ==
               smem_bytes_dv<T>(W, in[I_ROWS], in[I_STAGES], in[I_TILE], in[I_TROWS]);
  const bool resident = in[I_ROWS] == M && in[I_STAGES] == 0 && in[I_TROWS] == 0 &&
                        in[I_TILE] == 0;
  if (!resident && !streamed_ok(in, sizeof(T))) return false;
  return (long long)in[I_SMEM] == smem_bytes<T>(M, N, W, in[I_ROWS], in[I_STAGES], in[I_TILE]);
}

template <typename T>
bool pointers_ok(const Params<T>& p, bool devex, bool dvec) {
  return p.T_in && p.T_out && p.basis_in && p.basis_out && p.act_in && p.act_out && p.art_in &&
         p.art_out && p.upper && p.at_upper_in && p.at_upper_out && p.phase_in && p.status_in &&
         p.niter_in && p.stuck_in && p.bland_in && p.lastz_in && p.ints_out && p.bland_out &&
         p.lastz_out && p.mail && p.cols && p.bar && (!devex || (p.gamma_in && p.gamma_out)) &&
         (p.R == p.M || p.scratch) && (!dvec || p.bvec);
}

// The instantiation of a plan: the wide plan's kernel (I_VECS 2), else
// grid_kernel's for the kind of plan, Dantzig or devex.
template <typename T>
void (*kernel_of(const int* in))(Params<T>) {
  const bool devex = in[I_DEVEX] != 0, streamed = in[I_ROWS] < in[I_M];
  if (in[I_VECS] == 2) return devex ? wide_kernel<T, true> : wide_kernel<T, false>;
  if (in[I_VECS] == 1)
    return devex ? grid_kernel<T, true, true, true> : grid_kernel<T, false, true, true>;
  if (streamed)
    return devex ? grid_kernel<T, true, true, false> : grid_kernel<T, false, true, false>;
  return devex ? grid_kernel<T, true, false, false> : grid_kernel<T, false, false, false>;
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the instantiation at
// smem bytes of dynamic shared memory, after raising its limit to them
template <typename T>
int occupancy_of(void (*kernel)(Params<T>), int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, (size_t)smem);
  return (int)e;
}

template <typename T>
int launch_walk(void (*kernel)(Params<T>), const Params<T>& p, int G, int smem, cudaStream_t s) {
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int err = occupancy_of<T>(kernel, smem, &occ);
  if (err) return err;
  if (occ < 1 || G > occ * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<T> q = p;
  void* args[] = {&q};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(G), dim3(THREADS), args,
                                  (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int bounded_grid(const long long* a, const int* in, const double* tol, void* stream) {
  if (!plan_ok<T>(in)) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(a, in, tol);
  if (!pointers_ok(p, in[I_DEVEX] != 0, in[I_VECS] != 0)) return (int)cudaErrorInvalidValue;
  return launch_walk<T>(kernel_of<T>(in), p, in[I_BLOCKS], in[I_SMEM], (cudaStream_t)stream);
}

template <typename T>
int bounded_grid_occupancy(const int* in, int* blocks) {
  if (!plan_ok<T>(in) || !blocks) return (int)cudaErrorInvalidValue;
  return occupancy_of<T>(kernel_of<T>(in), in[I_SMEM], blocks);
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
