// rank1_grid: the solo rank-1, devex and dual walks (solve/driver.py::
// simplex_step, solve/devex.py::devex_simplex_step, solve/dual.py::
// dual_simplex_step) stepped to the walk's exit or to max_iters in one
// persistent cooperative launch of G blocks, each keeping a column slab of
// the tableau in its shared memory, or, past the shared memory, the slab's
// first R rows there and the rest streamed through device memory, or, past
// even a slab's first three rows, every row streamed (the wide plan).
//
// Replaces no Pallas kernel: in tpulp these walks are XLA's compiled
// ``lax.while_loop`` over ``simplex_step`` (tpulp/solve/driver.py:74, the
// driver 252-293), over ``devex_simplex_step`` (tpulp/solve/devex.py:75, the
// driver 240-262) and over ``dual_simplex_step`` (tpulp/solve/dual.py:62,
// the driver 143-170). It takes every frame that a thread-block cluster
// cannot hold (rank1_cluster.cu keeps those) and the card's memory does
// (kernels/rank1_grid.py::rank1_grid_plan): past the frames whose
// replicated vectors also fit a block (up to 8,978 rows at f64 with n =
// 2m), the per-row vectors live in device memory (DVEC, below); past the
// slabs whose first three rows and tile ring fit a block (3,098 columns at
// f64, 6,032 at f32), no row of a slab does (wide_kernel, below the grid
// kernel).
//
// What bounds it on the H100: the frame crosses device memory twice a walk
// (loaded, stored); a step reads and writes the resident rows once from
// shared memory with one fma an entry, and the streamed rows once from
// device memory (2 x 714 x 3072 x 8 B = 35.1 MB a step at 1538 x 3073 f64,
// whose slabs keep 824 rows resident: ~10.5 us at 3.35 TB/s, less where
// L2 holds the tiles). What sets the pace beside the bytes is the chain of
// a step's decisions: two grid barriers (~1 us each), the block reductions
// and the L2 round trips around them.
//
// Design (bounded_grid.cu's, whose machinery grid.cuh shares): G blocks of
// 512 threads, one an SM. Block g owns the structural columns [g W, min(n,
// (g + 1) W)) of all M rows, with their active mask and devex weights. Rows
// [0, R) of its slab live column-major in its dynamic shared memory (R = M
// on a resident plan). Every block holds the RHS column, the basis and the
// artificial mask alike, and every thread the walk's scalars, computed from
// the same values in every block: every branch, budget and exit is the same
// in every block, and no block leaves the step loop alone. A primal step:
// 1. where the step needs it, the column pass over the block's columns
//    (SCAN_LANES lanes a column, the streamed rows through L2): each
//    column's minimum ratio (the greatest increase, every step) or whether
//    it has an entry above piv_tol (devex's exposed-ray scan, every
//    ray_every steps in phase 2);
// 2. price over the block's columns (Dantzig's NaN-first argmin of c_eff,
//    Bland's first improving column, the greatest increase's argmax, devex's
//    c^2 / gamma with its half-period Dantzig probe, the clean-up's first
//    eligible column, the ray; the |c| sum), row 2's finiteness over them,
//    and where needed the owner of basis[0] tests that column against e_2
//    (the redirected pivot's no-op test); the candidate goes to the block's
//    mailbox. Grid barrier A;
// 3. every block combines the G mailboxes in block order (grid.cuh's
//    combine_mail: the sequential argmin exactly). Under devex the previous
//    step's reset on the grid's largest weight is applied here (then, where
//    the step prices by score, a second pricing under unit weights and a
//    barrier A'). The owner of the entering column j publishes column j and
//    runs the ratio test on it (first-index or largest-pivot ties, Bland's
//    smallest basic index; each thread's ratios kept in registers between
//    the two passes), and publishes the verdict: the step's row, whether a
//    row was found, the pivot element, the entering column's weight.
//    Grid barrier B;
// 4. every block reads the verdict and column j, computes its segment of
//    the pivot row times 1 / piv and (devex) its weights, updates its slab
//    in place (a thread a row: fma(-col[i], prow[k], T[i, k]), the pivot
//    row set to prow, the entering column to the unit vector by its owner)
//    and its RHS copy alike; then the basis, the retire, the phase change,
//    the stall counter, the Bland switch, the |b| sum and the status.
// A dual step: every block picks the leaving row r from its replicated RHS
// alike (the most negative b_r, the first negative one under Bland), prices
// the entering candidates c_j / -T[r, j] over its own columns (row r from
// the scratch where r >= R), posts its candidate; barrier A, the combine,
// the owner of j publishes column j and the pivot; barrier B; the update
// and the dual finish.
// The redirected pivot on (row 2, basis[0]) of a step that pivots nowhere
// runs where it is not an exact no-op, as in rank1_cluster.cu; its column is the
// unit vector e_2 while every basic column is a unit vector (checked at the
// launch, kept by finite pivots, as in bounded_grid.cu), else its owner
// publishes it before a third barrier (C).
//
// The streamed rows (STREAMED) as in bounded_grid.cu: rows [R, M) of block
// g's slab live in the wrapper's scratch, in tiles of TR rows x W columns;
// a step's update walks them through a ring of S tiles in shared memory
// (grid.cuh's bulk async copies completing on mbarriers, bulk stores), the
// first S tiles asked for at the step's start so that their loads overlap
// the decisions, the order reversed every other step for L2 reuse. Every
// other read of a streamed row goes through grid.cuh's Slab::at, through
// L2. The hazards and their handling are bounded_grid.cu's.
//
// The per-row vectors in device memory (DVEC, always streamed; the plan
// takes it where the replicated vectors leave rows 0-2 and the ring no
// room, or where it is forced), as in bounded_grid.cu: the RHS and the
// basis live in device memory, two copies each (a step reads copy cur,
// which no block writes before barrier D, and its owners write copy cur ^
// 1), and a block keeps only its own columns' artificial flags (the device
// copy is art_out). Block g owns the basic rows [g H, (g + 1) H), H =
// ceil(m / G) (block 0 the two objective rows too): in the finish it
// updates their RHS entries with the same fma and operands as above,
// writes their basis (row r the entering column), clears the retired
// artificial's flag where it owns r_d, and takes over its rows the |b| sum
// in block_reduce's order with, on the primal walks, the first artificial
// basic row, on the dual walk the argmin of b and the first row below
// -feas_tol; it posts them to the mailbox, a fourth grid barrier (D) ends
// the step, and the combine adds the blocks' sums in grid_sum's order and
// picks the dual walk's next leaving row (the plain version's |b| check
// takes the same order: grid_sum over slabs of H rows). Before the first
// step every block takes those picks from the inputs. The ratio test is
// split over the blocks: the owner of j takes column j's resident rows [2,
// R) (and publishes rows [0, R) of it), every block its share's streamed
// rows, read through L2 from the owner's tiles (and publishes them); each
// block posts its two argmins (the ratios, the first row above piv_tol),
// combined in block order by keys after barrier B; where Bland's index or
// the largest pivot breaks the ties, each block's pick of them follows,
// combined after barrier B' (grid_ratio's two key reductions: pick's
// order is total). The dual walk's leaving row is in the stream: each
// block reads its entries of row r + 2 through Slab::at. Every block then
// reads the pre-step column j entry, b[r + 2], basis[r] and basis[r_d]
// itself; the owner's mailbox brings j's devex weight and the blocks'
// flags whether column j is finite. The column pass reads b through L2;
// the update reads column j from device memory (a tile's TR entries staged
// one tile ahead), and the ring has a slot more, each slot reloaded a tile
// after its store.
//
// The arithmetic is rank1_cluster.cu's: one rounding per product in the decisions,
// IEEE division, prow = row * (1 / piv), comparisons in the tableau's type
// against tolerances rounded to it, torch's NaN-first argmin / argmax with
// first-index ties, status_select's precedence. The sums feed finiteness
// checks only: the |c| sum per block and then across blocks
// (kernels/sums.py::grid_sum's order), the |b| sum over the
// replicated RHS in one block's order (block_sum; on the DVEC and wide
// plans grid_sum over slabs of H rows).

#include "grid.cuh"

namespace tpulp {
namespace rgr {

using namespace grid;

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
// pricing rules and tie breaks (tpulp_torch.core.state)
constexpr int RULE_BLAND_ = 1, RULE_MAX_INCREASE_ = 2, TIE_MAXPIV_ = 1;
constexpr int SCAN_LANES = 8;  // lanes a column of the column pass
constexpr int RCACHE = 2;      // rows a thread keeps between the ratio test's passes

// the walks (kernels/rank1.py's WALKS)
enum Walk { W_PRIMAL, W_DEVEX, W_DUAL };
// the wrapper's argument arrays (tpulp_torch/kernels/rank1_grid.py)
enum Arg {
  A_T_IN, A_T_OUT, A_BASIS_IN, A_BASIS_OUT, A_ACT_IN, A_ACT_OUT, A_ART_IN, A_ART_OUT,
  A_GAMMA_IN, A_GAMMA_OUT, A_PHASE_IN, A_STATUS_IN, A_NITER_IN, A_STUCK_IN, A_BLAND_IN,
  A_LASTZ_IN, A_INTS_OUT, A_BLAND_OUT, A_LASTZ_OUT, A_MAIL, A_COLS, A_BAR, A_CYCLES, A_SCRATCH,
  A_BVEC, A_NARGS
};
// I_ROWS: R, the slab's rows in shared memory (M on a resident plan);
// I_STAGES: the tile ring's slots; I_TROWS: TR, rows a tile; I_TILE: TS,
// bytes a tile (the last three 0 on a resident plan); I_VECS: 1 where the
// per-row vectors live in device memory (DVEC), 2 on the wide plan (R 0)
enum Int {
  I_M, I_N, I_STALL, I_MAXIT, I_RULE, I_TIE, I_WALK, I_BLOCKS, I_WIDTH, I_THREADS, I_SMEM,
  I_MAIL, I_ROWS, I_STAGES, I_TROWS, I_TILE, I_RAY_EVERY, I_VECS, I_NINTS
};
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_FEAS, D_RESET, D_NTOLS };
// the int32 scalars written back (ints_out)
enum Out { O_PHASE, O_STATUS, O_NITER, O_STUCK, O_NOUT };
// the stages that ``cycles`` splits a walk into (block 0's clock; summed
// over the steps): the load, then a step's column pass, price, barrier A
// (A' with it), the combine (and the repricing), the ratio test and the
// publication (where block 0 owns j), barrier B, barrier C, the fetch of
// the verdict and column j with the pivot row and the devex weights, the
// update of the resident rows (and the RHS), the streamed rows' update
// (STREAMED), the finish (DVEC: with the RHS share), barrier D (DVEC);
// then the store; and apart, the ratio test and the publication on the
// clock of the block that owns j, whichever it is. DVEC: the ratio stage
// is the first pass over the block's rows, the combine stage takes the
// first pass's combine and the second pass too, barrier B is B and B', the
// fetch stage takes the second combine, the update stage leaves the RHS
// to the finish, and "owner" is the owner of j's first pass (the wide
// plan: the fetch stage the verdict's scalars, the update stage the first
// tile's staging; kernels/rank1_grid.py's grid stages name these spans
// apart)
enum Stage {
  C_LOAD, C_SCAN, C_PRICE, C_A, C_COMBINE, C_RATIO, C_B, C_C, C_FETCH, C_UPDATE, C_STREAM,
  C_FINISH, C_D, C_STORE, C_OWNER, C_NSTAGES
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
  const T* gamma_in;  // devex only
  T* gamma_out;
  const int *phase_in, *status_in, *niter_in, *stuck_in;
  const unsigned char* bland_in;
  const T* lastz_in;
  int* ints_out;
  unsigned char* bland_out;
  T* lastz_out;
  unsigned char* mail;  // mail_bytes(G)
  T* cols;              // (2 M,): column j | column basis[0]; DVEC and
                        // the wide plan (4 M,): then two copies of the RHS
  unsigned* bar;        // the grid barrier's counter, zeroed by the wrapper
  long long* cycles;    // (C_NSTAGES,) SM cycles per stage (block 0), or null
  T* scratch;           // STREAMED: G regions of NT tiles of TS bytes;
                        // the wide plan: G regions of its chunks (WideSlab)
  int* bvec;            // DVEC and the wide plan: the basis, two copies of m
  int M, N, W, stall_limit, max_iters, ray_every;
  int R, S, TR;  // resident rows, the ring's slots, rows a tile (STREAMED)
  int TS;        // bytes a tile (STREAMED)
  // Bland's rule, the greatest increase, largest-pivot ties (the primal
  // walk's; devex and the dual walk take none, as their steps)
  bool bland_rule, max_inc, max_piv;
  // the tolerances rounded to T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, feas_tol, reset_above;
};

// The dynamic shared memory of a block, each segment 16-byte aligned: the
// slab's R resident rows (R x W, column-major), the tile ring (S tiles of
// TS bytes), the RHS and the pivot's column (M each), the pivot row's and
// the devex weights' segments (W each), the basis (m ints), the segment's
// active mask (W), the artificial mask (n) and the ring's mbarriers (S). A
// resident plan has R = M and S = TS = 0. The wrapper's rank1_grid_plan
// counts the same bytes; the launch refuses a plan that disagrees.
template <typename T>
__host__ __device__ long long smem_bytes(int M, int N, int W, int R, int S, int TS) {
  const long long m = M - 2, n = N - 1, es = sizeof(T);
  return align16((long long)R * W * es) + (long long)S * TS + 2 * align16((long long)M * es) +
         2 * align16((long long)W * es) + align16(4 * m) + align16(W) + align16(n) +
         align16(8LL * S);
}

template <typename T>
struct Layout {
  T* slab;
  T* ring;
  T* b;
  T* colj;
  T* prow;
  T* gamma;
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
  L.basis = (int*)(dyn + off);
  off += align16(4LL * (M - 2));
  L.act = dyn + off;
  off += align16(W);
  L.art = dyn + off;
  off += align16(N - 1);
  L.mbar = (unsigned long long*)(dyn + off);
  L.cjs = nullptr;
  return L;
}

// The dynamic shared memory of a DVEC block (bounded_grid.cu's layout):
// the slab's R resident rows, the tile ring, the pivot row's and the devex
// weights' segments (W each), column j's entries of two tiles (2 TR), the
// segment's active and artificial masks (W each) and the mbarriers.
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
  L.b = L.colj = nullptr;
  L.basis = nullptr;
  return L;
}

// The greatest increase's and devex's column pass over the block's wk
// columns, rows 2 to M - 1 (the streamed ones through L2), SCAN_LANES lanes
// a column, each over every SCAN_LANES-th row, combined across the lanes:
// with ``ray``, whether the column has an entry above piv_tol (1 or 0);
// else its minimum ratio b_i / T[i, k] over T[i, k] > piv_tol
// (NaN-propagating, as torch's min; neither depends on the order). Into
// out[kk]. Called by every thread of the block; a barrier follows. DEV: b
// in device memory (read through L2).
template <typename T, bool STREAMED, bool DEV>
__device__ void column_pass(const Slab<T, STREAMED>& slab, const T* b, T* out, int M, int wk,
                            T piv_tol, bool ray) {
  const T inf = pos_inf<T>();
  const int gq = threadIdx.x / SCAN_LANES, l = threadIdx.x % SCAN_LANES;
  const int R = slab.R;
  // (the loop's bound is the same in every lane: the shuffles need the
  // whole warp)
  for (int k1 = 0; k1 < wk; k1 += THREADS / SCAN_LANES) {
    const int kk = k1 + gq;
    T acc = ray ? T(0) : inf;
    if (kk < wk) {
      const T* col = slab.sh + (long long)kk * R;
      const int top = STREAMED ? R : M;  // R >= 3: the streamed rows start past row 2
      if (ray) {
        bool has = false;
        for (int i = 2 + l; i < top && !has; i += SCAN_LANES) has = col[i] > piv_tol;
        if (STREAMED)
          for (int i = top + l; i < M && !has; i += SCAN_LANES)
            has = __ldcg(slab.tile_entry(i, kk)) > piv_tol;
        acc = has ? T(1) : T(0);
      } else {
        for (int i = 2 + l; i < top; i += SCAN_LANES) {
          const T a = col[i];
          const T q = a > piv_tol ? div_rn(DEV ? __ldcg(b + i) : b[i], a) : inf;
          if (!is_nan(acc) && (is_nan(q) || q < acc)) acc = q;
        }
        if (STREAMED)
          for (int i = top + l; i < M; i += SCAN_LANES) {
            const T a = __ldcg(slab.tile_entry(i, kk));
            const T q = a > piv_tol ? div_rn(DEV ? __ldcg(b + i) : b[i], a) : inf;
            if (!is_nan(acc) && (is_nan(q) || q < acc)) acc = q;
          }
      }
    }
    for (int off = SCAN_LANES / 2; off > 0; off >>= 1) {
      const T q = __shfl_xor_sync(FULL, acc, off, SCAN_LANES);
      if (ray)
        acc = q > acc ? q : acc;
      else if (!is_nan(acc) && (is_nan(q) || q < acc))
        acc = q;
    }
    if (kk < wk && l == 0) out[kk] = acc;
  }
}

// driver.ratio_rows over the m rows of the owner's column col (from row 2)
// and the replicated RHS b, as common.cuh's ratio_row takes it: whether an
// entry exceeds piv_tol (has_ratio) and the leaving row: among the tie set
// {b / col <= min} (none where the minimum is NaN) Bland's smallest basic
// index (use_bland), else the largest pivot element (max_piv; the argmax of
// col taken as the argmin of -col, first index on ties), else the first
// row; row 0 where nothing qualifies, as torch's argmin / argmax. A thread
// keeps the ratios of its first RCACHE rows in registers between the two
// passes; each pass is one reduction of two argmins by keys (the ratios
// and the first row above piv_tol, taken as an argmin of 0 over those
// rows). Returned to every thread; called by every thread of the block.
template <typename T>
__device__ int grid_ratio(const T* col, const T* b, const int* basis, int m, T piv_tol,
                          bool use_bland, bool max_piv, KeyRed<T>* sh1, KeyRed<T>* sh2,
                          bool& has_ratio) {
  const T inf = pos_inf<T>();
  const int tid = threadIdx.x;
  T qc[RCACHE];
  T lv = inf, pv = inf;
  int li = BIG_I, pi = BIG_I;
#pragma unroll
  for (int u = 0; u < RCACHE; ++u) {
    const int i = tid + u * THREADS;
    qc[u] = inf;
    if (i < m) {
      const T c = col[i];
      const bool pos = c > piv_tol;
      qc[u] = pos ? div_rn(b[i], c) : inf;
      pick(lv, li, qc[u], i);
      if (pos) pick(pv, pi, T(0), i);
    }
  }
  for (int i = tid + RCACHE * THREADS; i < m; i += THREADS) {
    const T c = col[i];
    const bool pos = c > piv_tol;
    pick(lv, li, pos ? div_rn(b[i], c) : inf, i);
    if (pos) pick(pv, pi, T(0), i);
  }
  key_pick2(lv, li, pv, pi, sh1);
  has_ratio = pi != BIG_I;
  const bool min_nan = is_nan(lv);
  if (!use_bland && !max_piv) return min_nan ? 0 : li;
  T tv = inf, none = inf;
  int ti = BIG_I, ni = BIG_I;
#pragma unroll
  for (int u = 0; u < RCACHE; ++u) {
    const int i = tid + u * THREADS;
    if (i < m) {
      const bool tie = !min_nan && qc[u] <= lv;
      pick(tv, ti, !tie ? inf : use_bland ? T(basis[i]) : -col[i], i);
    }
  }
  for (int i = tid + RCACHE * THREADS; i < m; i += THREADS) {
    const T c = col[i];
    const T q = c > piv_tol ? div_rn(b[i], c) : inf;
    const bool tie = !min_nan && q <= lv;
    pick(tv, ti, !tie ? inf : use_bland ? T(basis[i]) : -c, i);
  }
  key_pick2(tv, ti, none, ni, sh2);
  return ti;
}

// Over the m rows of the replicated RHS (after a step, and before the
// first): the |b| sum (s, in block_reduce's order); on the primal walks the
// first row whose basic column is artificial (a), on the dual walk the
// NaN-first argmin of b (v, i) and the first row below -feas_tol (a); x
// carries what the caller offered already (devex: the block's weights,
// picked by their maximum). Returned to every thread; one barrier, sh its
// own.
template <typename T, bool DUAL>
__device__ Red<T> walk_rows(Red<T> x, const Layout<T>& L, int m, T feas_tol, KeyRed<T>* sh) {
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const T bi = L.b[i + 2];
    x.s = add_rn(x.s, T(fabs(bi)));
    if (DUAL) {
      if (bi < -feas_tol) x.a = min(x.a, i);
      offer(x, bi, i, false);
    } else if (L.art[L.basis[i]]) {
      x.a = min(x.a, i);
    }
  }
  return key_reduce(x, !DUAL, sh);
}

template <typename T, int WALK, bool STREAMED, bool DVEC>
__global__ void __launch_bounds__(THREADS, 1) grid_kernel(Params<T> p) {
  static_assert(STREAMED || !DVEC, "the per-row vectors in device memory stream the slab");
  constexpr bool DEVEX = WALK == W_DEVEX, DUAL = WALK == W_DUAL;
  // the warps' shares of the price, ratio (two passes) and rows
  // reductions, each its own
  __shared__ KeyRed<T> kr[4][WARPS];
  __shared__ Red<T> comb;  // the grid's combined candidate of a step
  __shared__ T comb_g;
  __shared__ int comb_f;
  __shared__ Verdict<T> vsh;    // the step's verdict, read by thread 0
  __shared__ DvVerdict<T> dsh;  // DVEC: the step's verdict
  // DVEC: b[1] and b[2] before the step's update, and the objective row
  // after it (thread 0's reads through L2)
  __shared__ T bsh[3];
  __shared__ Laps<C_NSTAGES> laps;  // thread 0's, on block 0 only
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
  T* const colJ = p.cols;      // column j, pre-step (the owner of j)
  T* const colP = p.cols + M;  // column basis[0] (its owner, on barrier C)
  // DVEC: the RHS and the basis in device memory, two copies each: a step
  // reads copy cur and writes copy cur ^ 1; the basic rows [q0, q1) this
  // block owns
  T* const rhsV = p.cols + 2 * M;  // 2 x M
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
    // the own basic rows' RHS entries and basis (block 0 the objective
    // rows' RHS too)
    for (int q = q0 + tid; q < q1; q += THREADS) {
      p.bvec[q] = p.basis_in[q];
      rhsV[q + 2] = p.T_in[(long long)(q + 2) * N + N - 1];
    }
    if (g == 0 && tid < 2) rhsV[tid] = p.T_in[(long long)tid * N + N - 1];
  } else {
    for (int i = tid; i < M; i += THREADS) L.b[i] = p.T_in[(long long)i * N + N - 1];
    for (int i = tid; i < m; i += THREADS) L.basis[i] = p.basis_in[i];
    for (int k = tid; k < n; k += THREADS) L.art[k] = p.art_in[k] != 0;
  }
  for (int kk = tid; kk < wk; kk += THREADS) {
    L.act[kk] = p.act_in[k0 + kk] != 0;
    L.gamma[kk] = DEVEX ? p.gamma_in[k0 + kk] : T(1);
    if (DVEC) {
      // the own flags, and their device copy
      const unsigned char a = p.art_in[k0 + kk] != 0;
      L.art[kk] = a;
      p.art_out[k0 + kk] = a;
    }
  }
  int phase = *p.phase_in, status = *p.status_in, niter = *p.niter_in, stuck = *p.stuck_in;
  bool bland = *p.bland_in != 0;
  T last_z = *p.lastz_in;
  int b0d = DVEC ? p.basis_in[0] : 0;  // DVEC: basis[0], in every thread
  __syncthreads();
  // every basic column this block owns exactly the unit vector on its row
  // (a warp a row of the basis)
  bool units_bad = false;
  for (int i = warp; i < m; i += WARPS) {
    const int k = DVEC ? p.basis_in[i] : L.basis[i];
    if (k < k0 || k >= k0 + wk) continue;
    const T* col = L.slab + (long long)(k - k0) * R;
    for (int r = lane; r < M; r += 32)
      units_bad = units_bad ||
                  (STREAMED && r >= R ? slab.at(r, k - k0) : col[r]) != T(r == i + 2);
  }
  units_bad = __syncthreads_or(units_bad) != 0;

  // the rows before the first step (and the own weights' maximum); DVEC:
  // every block over every row of the inputs (no block writes them)
  Red<T> x = red_identity<T>(!DUAL);
  if (DEVEX)
    for (int kk = tid; kk < wk; kk += THREADS) offer(x, L.gamma[kk], kk, true);
  if (DVEC) {
    for (int i = tid; i < m; i += THREADS) {
      if (DUAL) {
        const T bi = p.T_in[(long long)(i + 2) * N + N - 1];
        if (bi < -p.feas_tol) x.a = min(x.a, i);
        offer(x, bi, i, false);
      } else if (p.art_in[p.basis_in[i]]) {
        x.a = min(x.a, i);
      }
    }
    x = key_reduce(x, !DUAL, kr[3]);
  } else {
    x = walk_rows<T, DUAL>(x, L, m, p.feas_tol, kr[3]);
  }
  T gmax_own = x.v;
  bool first = true, units_ok = true;
  // the ring: the slot of the next tile to update, each slot's parity, the
  // tiles' order this step (forward on even steps of the launch)
  int slot = 0;
  unsigned parity = 0;
  bool forward = true;
  if (tid == 0) lap(&laps, C_LOAD);

  while (status == ST_RUNNING && niter < p.max_iters) {
    // (DVEC: this step's copy of the vectors, read-only until barrier D,
    // and the next step's, written by their owners in the finish)
    const T* const rhsC = rhsV + cur * M;
    T* const rhsN = rhsV + (cur ^ 1) * M;
    const int* const basC = p.bvec + cur * m;
    int* const basN = p.bvec + (cur ^ 1) * m;
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
    // ---- 1. the column pass; price over the own columns; barrier A ----
    // the primal walks: the clean-up, devex's ticks (the exposed-ray scan,
    // the half-period Dantzig probe); the dual walk: the leaving row rq
    const bool cleanup = !DUAL && x.a != BIG_I && phase == 2;
    const int r_d = !DUAL && x.a != BIG_I ? x.a : 0;
    const bool feasible = DUAL && x.a == BIG_I;
    const int rq = !DUAL ? 0 : bland ? (feasible ? m - 1 : x.a) : x.i;
    const int tick = niter % p.ray_every;
    const bool scan_tick = DEVEX && tick == 0 && phase == 2 && !cleanup;
    const bool probe = DEVEX && tick == p.ray_every / 2 && phase == 2 && !cleanup;
    const bool by_score = DEVEX && !probe;
    const bool max_inc = !DEVEX && !DUAL && p.max_inc;
    const bool mx = by_score || max_inc;
    if (scan_tick || max_inc) {
      // into prow, which the step writes only after barrier B
      column_pass<T, STREAMED, DVEC>(slab, DVEC ? rhsC : L.b, L.prow, M, wk, p.piv_tol,
                                     scan_tick);
      __syncthreads();
    }
    if (tid == 0) lap(&laps, C_SCAN);
    // over the own columns: the pick (v, i); the first improving column
    // (a); the first clean-up-eligible column, else on a ray tick the first
    // improving column with no entry above piv_tol (b); the |c| sum over
    // the active columns (s); the dual walk: the NaN-first argmin of c_j /
    // -T[r, j] over the active T[r, j] < -piv_tol (v, i), the first of them
    // (a), the sum of the objective row's |c| (s)
    const int crow = DUAL || phase != 1 ? 0 : 1;
    Red<T> cols = red_identity<T>(mx);
    bool bad2 = false, unit0 = false;
    for (int kk = tid; kk < wk; kk += THREADS) {
      const int k = k0 + kk;
      const T* col = L.slab + (long long)kk * R;  // column k's resident rows
      bad2 = bad2 || !finite_val(col[2]);
      const bool act = L.act[kk] != 0;
      const T c = col[crow];
      if (act) cols.s = add_rn(cols.s, T(fabs(c)));
      if (DUAL) {
        const T a = slab.at(rq + 2, kk);
        if (act && a < -p.piv_tol) {
          cols.a = min(cols.a, k);
          offer(cols, div_rn(c, -a), k, false);
        }
        continue;
      }
      const T c_eff = act ? c : inf;
      const bool improving = c_eff < -p.opt_tol;
      if (improving) cols.a = min(cols.a, k);
      if (cleanup) {
        if (act && !L.art[DVEC ? kk : k] && T(fabs(slab.at(r_d + 2, kk))) > p.piv_tol)
          cols.b = min(cols.b, k);
      } else if (scan_tick && improving && L.prow[kk] == T(0)) {
        cols.b = min(cols.b, k);
      }
      if (by_score) {
        offer(cols, improving ? div_rn(mul_rn(c, c), L.gamma[kk]) : -inf, k, true);
      } else if (max_inc) {
        const T ratio = L.prow[kk];
        offer(cols, improving ? (ratio < inf ? mul_rn(-c_eff, ratio) : inf) : -inf, k, true);
      } else {
        offer(cols, c_eff, k, false);
      }
    }
    cols = key_reduce(cols, mx, kr[0]);
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
    // test by the owner of j (DVEC: over the blocks' rows); barrier B ----
    if (DVEC && tid == 0) {
      bsh[0] = __ldcg(rhsC + 1);
      bsh[1] = __ldcg(rhsC + 2);
    }
    combine_mail<T>(p.mail, R_A, mx, &comb, &comb_g, &comb_f);
    Red<T> all = comb;
    const int aflags = comb_f;
    if (first) units_ok = !(aflags & F_UNITS_BAD);
    if (DEVEX && !first && comb_g > p.reset_above) {
      // the plain step reset every weight after the previous step: where
      // the step prices by score, price again under unit weights (the pick
      // alone changes)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
      __syncthreads();
      if (by_score) {
        Red<T> re = red_identity<T>(true);
        for (int kk = tid; kk < wk; kk += THREADS) {
          const T c = L.slab[(long long)kk * R + crow];
          const bool improving = L.act[kk] && c < -p.opt_tol;
          offer(re, improving ? div_rn(mul_rn(c, c), L.gamma[kk]) : -inf, k0 + kk, true);
        }
        re = key_reduce(re, true, kr[1]);
        if (tid == 0) {
          post(mail_slot<T>(p.mail, R_R, g), re, T(1), 0);
          lap(&laps, C_COMBINE);
        }
        gb.sync();
        if (tid == 0) lap(&laps, C_A);
        combine_mail<T>(p.mail, R_R, true, &comb, &comb_g, &comb_f);
        all.v = comb.v;
        all.i = comb.i;
      }
    }
    const bool crow_ok = finite_val(all.s);
    const bool use_bland = !DUAL && (bland || p.bland_rule);
    // the step's decisions (the same in every block)
    const bool has_improving = !DUAL && all.a != BIG_I;
    const bool has_elig = DUAL ? all.a != BIG_I : cleanup && all.b != BIG_I;
    const int j_price = use_bland ? (has_improving ? all.a : n - 1) : all.i;
    const bool phase1_done = !DUAL && phase == 1 && !has_improving;
    const bool infeasible1 = phase1_done && -(DVEC ? bsh[0] : L.b[1]) > p.infeas_tol;
    const bool to_phase2 = phase1_done && !infeasible1;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const bool retire = cleanup && !has_elig;
    const bool ray = scan_tick && all.b != BIG_I;
    const bool finished_opt = !DUAL && phase == 2 && !has_improving && !cleanup;
    const bool do_cleanup = cleanup && has_elig;
    // the dual walk: a NaN minimum leaves no tie, so the entering column
    // is then 0, as with none
    const int j = DUAL ? (has_elig && !is_nan(all.v) ? all.i : 0)
                  : cleanup ? (has_elig ? all.b : n - 1)
                            : j_price;
    if (tid == 0) lap(&laps, C_COMBINE);
    if (DVEC) {
      // the ratio test over the blocks' rows: the owner of j its resident
      // rows [2, R) (and publishes rows [0, R) of column j), every block
      // its share's streamed rows, read from the owner's tiles (and
      // publishes them); each block's two argmins (the ratios, the first
      // row above piv_tol) combined in block order after barrier B (region
      // R_F); where ties are broken by Bland's index or the largest pivot,
      // the ties' picks after a second barrier B' (region A), as
      // grid_ratio takes them (pick's order is total)
      const long long t0 = p.cycles && tid == 0 ? clock64() : 0;
      const bool own_j = j >= k0 && j < k0 + wk;
      const int go = j / W;
      const Slab<T, true> jslab{nullptr, p.scratch + (long long)go * NT * tse, R, lg, tse};
      const int kj = j - go * W;
      const T* const colr = L.slab + (long long)(j - k0) * R;  // own_j
      const int qs = max(q0, R - 2);  // the share's streamed rows [qs, q1)
      T lv = inf, pv = inf;
      int li = BIG_I, pi = BIG_I;
      bool bad = false;
      const auto ratio = [&](int q, T c) {
        const bool pos = c > p.piv_tol;
        pick(lv, li, pos ? div_rn(__ldcg(rhsC + q + 2), c) : inf, q);
        if (pos) pick(pv, pi, T(0), q);
      };
      if (own_j)
        for (int i = tid; i < R; i += THREADS) {
          const T c = colr[i];
          colJ[i] = c;
          bad = bad || !finite_val(c);
          if (pricing_pivot && i >= 2) ratio(i - 2, c);
        }
      for (int q = qs + tid; q < q1; q += THREADS) {
        const T c = __ldcg(jslab.tile_entry(q + 2, kj));
        colJ[q + 2] = c;
        bad = bad || !finite_val(c);
        if (pricing_pivot) ratio(q, c);
      }
      key_pick2(lv, li, pv, pi, kr[1]);
      const bool any = __syncthreads_or(bad) != 0;
      if (tid == 0) {
        Red<T> c1;
        c1.v = lv;
        c1.i = li;
        c1.s = pv;
        c1.a = pi;
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
      const T lmin = comb.v;
      const bool min_nan = is_nan(lmin);
      const bool has_ratio = comb.a != BIG_I;
      const T gq = comb_g;
      const int colj_bad = comb_f;
      int r = DUAL ? rq : do_cleanup ? r_d : 0;
      if (pricing_pivot) r = min_nan ? 0 : comb.i;
      if (pricing_pivot && (use_bland || p.max_piv)) {
        // the ties: Bland's smallest basic index, else the largest pivot
        // element (the argmin of -col), first index on ties
        T tv = inf, none = inf;
        int ti = BIG_I, ni = BIG_I;
        const auto tie = [&](int q, T c) {
          const T qv = c > p.piv_tol ? div_rn(__ldcg(rhsC + q + 2), c) : inf;
          const bool t = !min_nan && qv <= lmin;
          pick(tv, ti, !t ? inf : use_bland ? T(__ldcg(basC + q)) : -c, q);
        };
        if (own_j)
          for (int i = 2 + tid; i < R; i += THREADS) tie(i - 2, colr[i]);
        for (int q = qs + tid; q < q1; q += THREADS) tie(q, __ldcg(colJ + q + 2));
        key_pick2(tv, ti, none, ni, kr[2]);
        if (tid == 0) {
          Red<T> c2;
          c2.v = tv;
          c2.i = ti;
          c2.s = inf;
          c2.a = BIG_I;
          c2.b = BIG_I;
          post(mail_slot<T>(p.mail, R_A, g), c2, -inf, 0);
          lap(&laps, C_COMBINE);
        }
        gb.sync();
        if (tid == 0) lap(&laps, C_B);
        combine_picks<T>(p.mail, R_A, &comb, &comb_g, &comb_f);
        r = comb.i;
      }
      if (tid == 0) {
        // this step's copies: no block writes them before barrier D
        dsh.piv = __ldcg(colJ + r + 2);
        dsh.brow = __ldcg(rhsC + r + 2);
        dsh.leaving = __ldcg(basC + r);
        dsh.bd = __ldcg(basC + r_d);
        dsh.gq = gq;
        dsh.r = r;
        dsh.has_ratio = has_ratio;
        dsh.colj_bad = colj_bad;
      }
    }
    if (!DVEC && j >= k0 && j < k0 + wk) {
      const long long t0 = p.cycles && tid == 0 ? clock64() : 0;
      // column j, published whole: the slab's (resident), or gathered into
      // L.colj, which every block overwrites from the mailbox after barrier
      // B with the same values (streamed)
      const T* col = L.slab + (long long)(j - k0) * R;
      if (STREAMED) {
        // the streamed rows through L2, four a thread at a time, their
        // loads issued before any store
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
      // the step's row: the dual walk's leaving row, the clean-up's, the
      // ratio test's on a pricing pivot, else 0
      bool has_ratio = false;
      int r = DUAL ? rq : do_cleanup ? r_d : 0;
      if (pricing_pivot)
        r = grid_ratio(col + 2, L.b + 2, L.basis, m, p.piv_tol, use_bland, p.max_piv, kr[1],
                       kr[2], has_ratio);
      if (tid == 0) {
        Verdict<T>* vd = verdict_slot<T>(p.mail);
        vd->piv = col[r + 2];
        vd->gq = DEVEX ? L.gamma[j - k0] : T(0);
        vd->r = r;
        vd->has_ratio = has_ratio;
        vd->kind_up = 0;
        vd->kind_flip = 0;
        if (p.cycles)
          atomicAdd((unsigned long long*)p.cycles + C_OWNER,
                    (unsigned long long)(clock64() - t0));
      }
    }
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
    const T gq = DVEC ? dsh.gq : vsh.gq, piv = DVEC ? dsh.piv : vsh.piv;
    const bool do_pricing = pricing_pivot && has_ratio;
    const bool do_pivot = DUAL ? !feasible && has_elig : do_cleanup || do_pricing;
    const bool infeasible = DUAL ? !feasible && !has_elig
                                 : infeasible1 || (pricing_pivot && !has_ratio && phase != 2);
    const bool unbounded = (pricing_pivot && !has_ratio && phase == 2) || ray;
    const int leaving = DVEC ? dsh.leaving : L.basis[r];
    // the update's pivot: (r + 2, j), else the plain step's redirected one
    // on (row 2, basis[0]) unless that is an exact no-op
    const bool noop = !(aflags & F_ROW2_BAD) && finite_val(DVEC ? bsh[1] : L.b[2]) &&
                      (units_ok || !(aflags & F_UNIT0_BAD));
    const bool pv = do_pivot || !noop;
    const int rg = do_pivot ? r + 2 : 2, jp = do_pivot ? j : b0;
    // the redirected pivot's column: e_2 where every basic column is a
    // unit vector, else its owner publishes it before barrier C (into
    // L.colj; DVEC: read from colP)
    const bool own_p = pv && !do_pivot && !units_ok;
    T cjr = do_pivot ? piv : T(1);  // the pivot element
    if (own_p) {
      if (b0 >= k0 && b0 < k0 + wk)
        for (int i = tid; i < M; i += THREADS) colP[i] = slab.at(i, b0 - k0);
      gb.sync();
      if (tid == 0) lap(&laps, C_C);
      for (int i = tid; !DVEC && i < M; i += THREADS) L.colj[i] = __ldcg(colP + i);
      cjr = __ldcg(colP + 2);
    }
    const bool cj_sh = do_pivot || own_p;      // else e_2
    const T* const cjd = own_p ? colP : colJ;  // DVEC: that column
    T rinv = T(1), prhs = T(0);
    if (pv) {
      rinv = div_rn(T(1), cjr);
      for (int kk = tid; kk < wk; kk += THREADS) L.prow[kk] = mul_rn(slab.at(rg, kk), rinv);
      prhs = mul_rn(DVEC ? (do_pivot ? dsh.brow : bsh[1]) : L.b[rg], rinv);
    }
    // the devex weights of the own columns (alpha: the post-pivot row,
    // column j snapped to 1; each thread reads the prow entries it wrote)
    // and their NaN-first maximum (x.v)
    x = red_identity<T>(!DUAL);
    if (DEVEX)
      devex_weights(L.gamma, L.prow, wk, jp - k0, leaving - k0, do_pricing, gq, piv, x);
    __syncthreads();  // prow complete, and every read of the pre-step b[rg]
    if (tid == 0) lap(&laps, C_FETCH);
    // row i by thread i mod THREADS (the copy's mapping): the pivot over
    // the own columns (row rg set to prow, the other rows fma(-col[i],
    // prow[k], T[i, k])), the pivot's column set to the unit vector by its
    // owner, then the RHS (DVEC: its owners', in the finish); the resident
    // rows only (the streamed ones tile by tile below)
    const bool jp_own = pv && jp >= k0 && jp < k0 + wk;
    bool cj_bad = false;
    if (pv) {
      for (int i = tid; i < (DVEC ? R : M); i += THREADS) {
        const T cj = cj_sh ? (DVEC ? __ldcg(cjd + i) : L.colj[i]) : T(i == 2);
        cj_bad = cj_bad || !finite_val(cj);
        if (!STREAMED || i < R) {
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
          if (jp_own) L.slab[(long long)(jp - k0) * R + i] = T(i == rg);
        }
        if (!DVEC) L.b[i] = i == rg ? prhs : fma(-cj, prhs, L.b[i]);
      }
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
      const int jpk = jp_own ? jp - k0 : -1;
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
      forward = !forward;
      if (tid == 0) lap(&laps, C_STREAM);
    }

    // ---- the finish ----
    if (tid == 0) {
      if (!DVEC && do_pivot) L.basis[r] = j;
      // a retire pivots nowhere: the basis is the pre-step one (DVEC: the
      // retired column's owner clears its flag, the row's its device copy)
      if (!DVEC && retire) L.art[L.basis[r_d]] = 0;
      if (DVEC && retire && dsh.bd >= k0 && dsh.bd < k0 + wk) L.art[dsh.bd - k0] = 0;
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
      // row: column j's entries through L2) and the basis (row r the
      // entering column); the retired artificial's flag; over the rows the
      // |b| sum (in block_reduce's order) and, on the primal walks, the
      // first row whose basic column is artificial, on the dual walk the
      // NaN-first argmin of b and the first row below -feas_tol
      const auto rhs_row = [&](int i) -> T {
        const T b_i = __ldcg(rhsC + i);
        T v = b_i;
        if (pv) {
          const T cj = cj_sh ? __ldcg(cjd + i) : T(i == 2);
          v = i == rg ? prhs : fma(-cj, prhs, b_i);
        }
        rhsN[i] = v;
        return v;
      };
      if (g == 0 && tid < 2) rhs_row(tid);
      for (int q = q0 + tid; q < q1; q += THREADS) {
        const T bi = rhs_row(q + 2);
        x.s = add_rn(x.s, T(fabs(bi)));
        const int k = do_pivot && q == r ? j : __ldcg(basC + q);
        basN[q] = k;
        if (DUAL) {
          if (bi < -p.feas_tol) x.a = min(x.a, q);
          offer(x, bi, q, false);
        } else if (retire && q == r_d) {
          p.art_out[k] = 0;
        } else if (__ldcg(p.art_out + k)) {
          x.a = min(x.a, q);
        }
      }
      x = key_reduce(x, !DUAL, kr[3]);
      // the blocks' sums and picks, combined after barrier D (the
      // repricing's region: its next use follows barrier A); the step's
      // objective row, updated by block 0
      if (tid == 0) {
        post(mail_slot<T>(p.mail, R_R, g), x, T(0), 0);
        lap(&laps, C_FINISH);
      }
      gb.sync();
      if (tid == 0) {
        lap(&laps, C_D);
        bsh[2] = __ldcg(rhsN + (DUAL || phase != 1 ? 0 : 1));
      }
      combine_mail<T>(p.mail, R_R, !DUAL, &comb, &comb_g, &comb_f);
      x.s = comb.s;
      x.a = comb.a;
      if (DUAL) {
        x.v = comb.v;
        x.i = comb.i;
      }
    } else {
      x = walk_rows<T, DUAL>(x, L, m, p.feas_tol, kr[3]);
    }
    gmax_own = DEVEX && to_phase2 ? T(1) : x.v;
    // stall and the Bland switch against the current objective (the dual
    // objective on the dual walk), the phase change, the status
    const T z = -(DVEC ? bsh[2] : L.b[DUAL || phase != 1 ? 0 : 1]);
    if (DUAL ? do_pivot : do_pricing) {
      const T d = DUAL ? sub_rn(z, last_z) : sub_rn(last_z, z);
      stuck = d > p.degen_tol ? 0 : stuck + 1;
      last_z = z;
    }
    bland = bland || stuck >= p.stall_limit;
    const bool finished = DUAL ? feasible : finished_opt;
    if (to_phase2) {
      phase = 2;
      stuck = 0;
      last_z = inf;
    }
    const bool finite_ok = finite_val(z) && finite_val(x.s) && crow_ok;
    status = !finite_ok   ? ST_NUMERIC
             : infeasible ? ST_INFEASIBLE
             : unbounded  ? ST_UNBOUNDED
             : finished   ? ST_OPTIMAL
                          : ST_RUNNING;
    niter += do_pivot;
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

// The wide plan's price pass, this thread's share: its columns t, t + WCH,
// ... of the block in turn (the grid kernel's entries and order: the |c|
// sums are grid_sum's), four at a time with their loads issued first; the
// pricing row crow, the dual walk's row rq + 2, the clean-up's row r_d + 2,
// row 2's finiteness (bad2), the active and artificial masks and the
// weights (1 where ``unit``); where the step has a column pass (``pass``:
// the greatest increase, devex's ray tick), each column's pass over its
// rows 2 to M - 1 (column_pass's values) taken in place, as its pricing
// reads it. ``scores``: devex's repricing under unit weights, the pick
// alone.
template <typename T, int WALK>
__device__ Red<T> wide_price(const WideSlab<T>& sl, const Params<T>& p, const T* rhsC, int k0,
                             int crow, int rq, int r_d, bool cleanup, bool scan_tick,
                             bool by_score, bool max_inc, bool unit, bool& bad2) {
  constexpr bool DEVEX = WALK == W_DEVEX, DUAL = WALK == W_DUAL;
  constexpr int U = 4;
  const T inf = pos_inf<T>();
  const bool mx = by_score || max_inc;
  const bool pass = scan_tick || max_inc;
  Red<T> cols = red_identity<T>(mx);
  for (int kk0 = threadIdx.x; kk0 < sl.wk; kk0 += U * THREADS) {
    T c[U], d[U], r2[U], gm[U];
    bool a[U], ar[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kk0 + u * THREADS;
      c[u] = d[u] = r2[u] = gm[u] = T(0);
      a[u] = ar[u] = false;
      if (kk >= sl.wk) continue;
      c[u] = sl.at(crow, kk);
      r2[u] = sl.at(2, kk);
      d[u] = DUAL ? sl.at(rq + 2, kk) : cleanup ? sl.at(r_d + 2, kk) : T(0);
      a[u] = p.act_out[k0 + kk] != 0;
      ar[u] = !DUAL && cleanup && __ldcg(p.art_out + k0 + kk) != 0;
      gm[u] = DEVEX && !unit ? p.gamma_out[k0 + kk] : T(1);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kk0 + u * THREADS, k = k0 + kk;
      if (kk >= sl.wk) continue;
      bad2 = bad2 || !finite_val(r2[u]);
      if (a[u]) cols.s = add_rn(cols.s, T(fabs(c[u])));
      if (DUAL) {
        if (a[u] && d[u] < -p.piv_tol) {
          cols.a = min(cols.a, k);
          offer(cols, div_rn(c[u], -d[u]), k, false);
        }
        continue;
      }
      const T c_eff = a[u] ? c[u] : inf;
      const bool improving = c_eff < -p.opt_tol;
      // the column's pass (column_pass's value, in any order)
      T ratio = scan_tick ? T(0) : inf;
      if (pass && improving) {
        for (int i = 2; i < sl.M; ++i) {
          const T e = sl.at(i, kk);
          if (scan_tick) {
            if (e > p.piv_tol) {
              ratio = T(1);
              break;
            }
          } else {
            const T q = e > p.piv_tol ? div_rn(__ldcg(rhsC + i), e) : inf;
            if (!is_nan(ratio) && (is_nan(q) || q < ratio)) ratio = q;
          }
        }
      }
      if (improving) cols.a = min(cols.a, k);
      if (cleanup) {
        if (a[u] && !ar[u] && T(fabs(d[u])) > p.piv_tol) cols.b = min(cols.b, k);
      } else if (scan_tick && improving && ratio == T(0)) {
        cols.b = min(cols.b, k);
      }
      if (by_score) {
        offer(cols, improving ? div_rn(mul_rn(c[u], c[u]), gm[u]) : -inf, k, true);
      } else if (max_inc) {
        offer(cols, improving ? (ratio < inf ? mul_rn(-c_eff, ratio) : inf) : -inf, k, true);
      } else {
        offer(cols, c_eff, k, false);
      }
    }
  }
  return cols;
}

// The walk on the wide plan: the device-vector plan's steps (DVEC in
// grid_kernel: the same decisions, mailboxes, barriers, ratio test over
// the blocks' rows, |b| sums and finish) with every row of the slab in the
// scratch buffer (grid.cuh's WideSlab), as bounded_grid.cu's wide_kernel
// walks it. Thread t owns column t of each of the block's chunks: its
// pricing entries (and its column pass, taken where the pricing reads
// it), its pivot row entry and devex weight (read from device memory at
// the chunk's first tile, the next chunk's asked for then), its active
// mask and weight, whose working copies are act_out and gamma_out (only
// their owner writes them); the artificial mask lives in art_out alone (a
// retired flag is cleared by its row's owner; read through L2). A step:
// the first S tiles asked for; the price pass (wide_price); barrier A; the
// combine (and devex's repricing); the owner of j publishes column j's
// rows 0-1 and every block its share's rows from the owner's chunks, with
// its ratio picks; barriers B (and B', C); then, where the step pivots,
// the update of every tile chunk by chunk, each entry one fma of its
// pre-step value as on the other plans (forward on even steps of the
// launch, backward on odd ones); the finish and barrier D.
template <typename T, int WALK>
__global__ void __launch_bounds__(THREADS, 1) wide_kernel(Params<T> p) {
  constexpr bool DEVEX = WALK == W_DEVEX, DUAL = WALK == W_DUAL;
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
  const WideSlab<T> slab = wide_slab<T>(p.scratch, M, N, W, g);
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
  T* const colP = p.cols + M;
  T* const rhsV = p.cols + 2 * M;
  int cur = 0;
  const int H = (m + (int)gridDim.x - 1) / (int)gridDim.x;
  const int q0 = min(m, g * H), q1 = min(m, q0 + H);
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
  wide_load(slab, p.T_in, N, k0);
  __threadfence_block();
  fence_async_global();
  for (int q = q0 + tid; q < q1; q += THREADS) {
    p.bvec[q] = p.basis_in[q];
    rhsV[q + 2] = p.T_in[(long long)(q + 2) * N + N - 1];
  }
  if (g == 0 && tid < 2) rhsV[tid] = p.T_in[(long long)tid * N + N - 1];
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    p.act_out[k] = p.act_in[k] != 0;
    p.art_out[k] = p.art_in[k] != 0;
    if (DEVEX) p.gamma_out[k] = p.gamma_in[k];
  }
  int phase = *p.phase_in, status = *p.status_in, niter = *p.niter_in, stuck = *p.stuck_in;
  bool bland = *p.bland_in != 0;
  T last_z = *p.lastz_in;
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
  // the rows before the first step (every block over every row of the
  // inputs) and the own weights' maximum
  Red<T> x = red_identity<T>(!DUAL);
  if (DEVEX)
    for (int kk = tid; kk < wk; kk += THREADS) offer(x, p.gamma_in[k0 + kk], kk, true);
  for (int i = tid; i < m; i += THREADS) {
    if (DUAL) {
      const T bi = p.T_in[(long long)(i + 2) * N + N - 1];
      if (bi < -p.feas_tol) x.a = min(x.a, i);
      offer(x, bi, i, false);
    } else if (p.art_in[p.basis_in[i]]) {
      x.a = min(x.a, i);
    }
  }
  x = key_reduce(x, !DUAL, kr[3]);
  T gmax_own = x.v;
  bool first = true, units_ok = true;
  // the ring: the slot of the next tile, each slot's parity, the tiles'
  // order this step
  int slot = 0;
  unsigned parity = 0;
  bool forward = true;
  if (tid == 0) lap(&laps, C_LOAD);

  while (status == ST_RUNNING && niter < p.max_iters) {
    // (this step's copy of the vectors, read-only until barrier D, and the
    // next step's, written by their owners in the finish)
    const T* const rhsC = rhsV + cur * M;
    T* const rhsN = rhsV + (cur ^ 1) * M;
    const int* const basC = p.bvec + cur * m;
    int* const basN = p.bvec + (cur ^ 1) * m;
    // the first tiles of the step's update, asked for before its decisions
    if (tid == 0) wide_first_tiles(slab, ring, tse, mbar, S, TR, NT, NS, slot, forward);
    __syncthreads();
    // ---- 1. price over the own columns (and their pass); barrier A ----
    const bool cleanup = !DUAL && x.a != BIG_I && phase == 2;
    const int r_d = !DUAL && x.a != BIG_I ? x.a : 0;
    const bool feasible = DUAL && x.a == BIG_I;
    const int rq = !DUAL ? 0 : bland ? (feasible ? m - 1 : x.a) : x.i;
    const int tick = niter % p.ray_every;
    const bool scan_tick = DEVEX && tick == 0 && phase == 2 && !cleanup;
    const bool probe = DEVEX && tick == p.ray_every / 2 && phase == 2 && !cleanup;
    const bool by_score = DEVEX && !probe;
    const bool max_inc = !DEVEX && !DUAL && p.max_inc;
    const bool mx = by_score || max_inc;
    const int crow = DUAL || phase != 1 ? 0 : 1;
    bool bad2 = false, unit0 = false;
    if (tid == 0) lap(&laps, C_SCAN);
    Red<T> cols = key_reduce(wide_price<T, WALK>(slab, p, rhsC, k0, crow, rq, r_d, cleanup,
                                                 scan_tick, by_score, max_inc, false, bad2),
                             mx, kr[0]);
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
    // test over the blocks' rows; barriers B (and B') ----
    if (tid == 0) {
      bsh[0] = __ldcg(rhsC + 1);
      bsh[1] = __ldcg(rhsC + 2);
    }
    combine_mail<T>(p.mail, R_A, mx, &comb, &comb_g, &comb_f);
    Red<T> all = comb;
    const int aflags = comb_f;
    if (first) units_ok = !(aflags & F_UNITS_BAD);
    if (DEVEX && !first && comb_g > p.reset_above) {
      // the plain step reset every weight after the previous step: where
      // the step prices by score, price again under unit weights (the pick
      // alone changes)
      for (int kk = tid; kk < wk; kk += THREADS) p.gamma_out[k0 + kk] = T(1);
      if (by_score) {
        bool unused = false;
        Red<T> re = key_reduce(wide_price<T, WALK>(slab, p, rhsC, k0, crow, rq, r_d, cleanup,
                                                   false, true, false, true, unused),
                               true, kr[1]);
        if (tid == 0) {
          post(mail_slot<T>(p.mail, R_R, g), re, T(1), 0);
          lap(&laps, C_COMBINE);
        }
        gb.sync();
        if (tid == 0) lap(&laps, C_A);
        combine_mail<T>(p.mail, R_R, true, &comb, &comb_g, &comb_f);
        all.v = comb.v;
        all.i = comb.i;
      }
    }
    const bool crow_ok = finite_val(all.s);
    const bool use_bland = !DUAL && (bland || p.bland_rule);
    const bool has_improving = !DUAL && all.a != BIG_I;
    const bool has_elig = DUAL ? all.a != BIG_I : cleanup && all.b != BIG_I;
    const int j_price = use_bland ? (has_improving ? all.a : n - 1) : all.i;
    const bool phase1_done = !DUAL && phase == 1 && !has_improving;
    const bool infeasible1 = phase1_done && -bsh[0] > p.infeas_tol;
    const bool to_phase2 = phase1_done && !infeasible1;
    const bool pricing_pivot = has_improving && !cleanup && !phase1_done;
    const bool retire = cleanup && !has_elig;
    const bool ray = scan_tick && all.b != BIG_I;
    const bool finished_opt = !DUAL && phase == 2 && !has_improving && !cleanup;
    const bool do_cleanup = cleanup && has_elig;
    const int j = DUAL ? (has_elig && !is_nan(all.v) ? all.i : 0)
                  : cleanup ? (has_elig ? all.b : n - 1)
                            : j_price;
    if (tid == 0) lap(&laps, C_COMBINE);
    {
      // the owner of j publishes column j's rows 0-1; every block its
      // share's rows from the owner's chunks, with its two ratio argmins,
      // combined in block order after barrier B (region R_F); the ties
      // after barrier B' (region A) where Bland or largest-pivot ties
      // break them
      const long long t0 = p.cycles && tid == 0 ? clock64() : 0;
      const bool own_j = j >= k0 && j < k0 + wk;
      const WideSlab<T> jslab = wide_slab<T>(p.scratch, M, N, W, j / W);
      const int kj = j - (j / W) * W;
      T lv = inf, pv = inf;
      int li = BIG_I, pi = BIG_I;
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
        if (pricing_pivot) {
          const bool pos = c > p.piv_tol;
          pick(lv, li, pos ? div_rn(__ldcg(rhsC + q + 2), c) : inf, q);
          if (pos) pick(pv, pi, T(0), q);
        }
      }
      key_pick2(lv, li, pv, pi, kr[1]);
      const bool any = __syncthreads_or(bad) != 0;
      if (tid == 0) {
        Red<T> c1;
        c1.v = lv;
        c1.i = li;
        c1.s = pv;
        c1.a = pi;
        c1.b = BIG_I;
        post(mail_slot<T>(p.mail, R_F, g), c1,
             own_j && DEVEX ? __ldcg(p.gamma_out + j) : -inf, any ? 1 : 0);
        if (p.cycles && own_j)
          atomicAdd((unsigned long long*)p.cycles + C_OWNER,
                    (unsigned long long)(clock64() - t0));
        lap(&laps, C_RATIO);
      }
      gb.sync();
      if (tid == 0) lap(&laps, C_B);
      combine_picks<T>(p.mail, R_F, &comb, &comb_g, &comb_f);
      const T lmin = comb.v;
      const bool min_nan = is_nan(lmin);
      const bool has_ratio = comb.a != BIG_I;
      const T gq = comb_g;
      const int colj_bad = comb_f;
      int r = DUAL ? rq : do_cleanup ? r_d : 0;
      if (pricing_pivot) r = min_nan ? 0 : comb.i;
      if (pricing_pivot && (use_bland || p.max_piv)) {
        T tv = inf, none = inf;
        int ti = BIG_I, ni = BIG_I;
        for (int q = q0 + tid; q < q1; q += THREADS) {
          const T c = __ldcg(colJ + q + 2);
          const T qv = c > p.piv_tol ? div_rn(__ldcg(rhsC + q + 2), c) : inf;
          const bool t = !min_nan && qv <= lmin;
          pick(tv, ti, !t ? inf : use_bland ? T(__ldcg(basC + q)) : -c, q);
        }
        key_pick2(tv, ti, none, ni, kr[2]);
        if (tid == 0) {
          Red<T> c2;
          c2.v = tv;
          c2.i = ti;
          c2.s = inf;
          c2.a = BIG_I;
          c2.b = BIG_I;
          post(mail_slot<T>(p.mail, R_A, g), c2, -inf, 0);
          lap(&laps, C_COMBINE);
        }
        gb.sync();
        if (tid == 0) lap(&laps, C_B);
        combine_picks<T>(p.mail, R_A, &comb, &comb_g, &comb_f);
        r = comb.i;
      }
      if (tid == 0) {
        // this step's copies: no block writes them before barrier D
        dsh.piv = __ldcg(colJ + r + 2);
        dsh.brow = __ldcg(rhsC + r + 2);
        dsh.leaving = __ldcg(basC + r);
        dsh.bd = __ldcg(basC + r_d);
        dsh.gq = gq;
        dsh.r = r;
        dsh.has_ratio = has_ratio;
        dsh.colj_bad = colj_bad;
      }
    }
    __syncthreads();

    // ---- 3. the verdict; barrier C where needed; the update ----
    const int r = dsh.r;
    const bool has_ratio = dsh.has_ratio != 0;
    const T gq = dsh.gq, piv = dsh.piv;
    const bool do_pricing = pricing_pivot && has_ratio;
    const bool do_pivot = DUAL ? !feasible && has_elig : do_cleanup || do_pricing;
    const bool infeasible = DUAL ? !feasible && !has_elig
                                 : infeasible1 || (pricing_pivot && !has_ratio && phase != 2);
    const bool unbounded = (pricing_pivot && !has_ratio && phase == 2) || ray;
    const int leaving = dsh.leaving;
    // the update's pivot: (r + 2, j), else the plain step's redirected one
    // on (row 2, basis[0]) unless that is an exact no-op
    const bool noop = !(aflags & F_ROW2_BAD) && finite_val(bsh[1]) &&
                      (units_ok || !(aflags & F_UNIT0_BAD));
    const bool pv = do_pivot || !noop;
    const int rg = do_pivot ? r + 2 : 2, jp = do_pivot ? j : b0;
    // the redirected pivot's column: e_2 where every basic column is a
    // unit vector, else its owner publishes it before barrier C
    const bool own_p = pv && !do_pivot && !units_ok;
    T cjr = do_pivot ? piv : T(1);  // the pivot element
    if (own_p) {
      if (b0 >= k0 && b0 < k0 + wk)
        for (int i = tid; i < M; i += THREADS) colP[i] = slab.at(i, b0 - k0);
      gb.sync();
      if (tid == 0) lap(&laps, C_C);
      cjr = __ldcg(colP + 2);
    }
    const bool cj_sh = do_pivot || own_p;      // else e_2
    const T* const cjd = own_p ? colP : colJ;  // that column
    T rinv = T(1), prhs = T(0);
    if (pv) {
      rinv = div_rn(T(1), cjr);
      prhs = mul_rn(do_pivot ? dsh.brow : bsh[1], rinv);
    }
    const bool jp_own = pv && jp >= k0 && jp < k0 + wk;
    // a pivot keeps every basic column a unit vector while column j (the
    // blocks' flags) and 1 / pivot are finite
    if (pv && ((do_pivot && dsh.colj_bad != 0) || !finite_val(rinv))) units_ok = false;
    // the devex weights' largest, NaN first (x.v)
    x = red_identity<T>(!DUAL);
    if (tid == 0) lap(&laps, C_FETCH);

    {
      // ---- the tiles, chunk by chunk through the ring ----
      const int jpk = jp_own ? jp - k0 : -1;
      const T qd = div_rn(gq, mul_rn(piv, piv));
      const T leave = is_nan(qd) ? qd : (qd < T(1) ? T(1) : qd);
      // the first chunk's pivot row entry and weight (thread t: the chunk's
      // column t), column j's entries of the first tile's rows
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
      wide_stream(
          slab, ring, cjs, mbar, S, TR, tse, NT, NS, pv, cj_sh, cjd, forward, slot, parity,
          [&](int c, int s) {
            // the chunk's first tile: its pivot row entry and the own
            // column's devex weight (common.cuh's devex_weights on it), then
            // the next chunk's asked for
            pk = mul_rn(raw, rinv);
            if (DEVEX && tid < slab.wc(c)) {
              const int kk = c * WCH + tid;
              T gw = gnext;
              if (do_pricing) {
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
          },
          // the same per-entry arithmetic as grid_kernel's
          [&](int i, int kk, T cj, T e) {
            T v = i == rg ? pk : fma(-cj, pk, e);
            if (kk == jpk) v = T(i == rg);
            return v;
          });
      if (DEVEX && !pv)
        for (int kk = tid; kk < wk; kk += THREADS) offer(x, p.gamma_out[k0 + kk], kk, true);
      forward = !forward;
      if (tid == 0) lap(&laps, C_STREAM);
    }

    // ---- the finish ----
    if (do_pivot && r == 0) b0 = j;
    if (to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        if (DEVEX) p.gamma_out[k] = T(1);
        p.act_out[k] = p.act_out[k] && !__ldcg(p.art_out + k);
      }
    {
      // the own rows of the next copies: the RHS (row by row: column j's
      // entries through L2) and the basis (row r the entering column); the
      // retired artificial's flag; over the rows the |b| sum (in
      // block_reduce's order) and the primal walks' first row whose basic
      // column is artificial, or the dual walk's argmin of b and first row
      // below -feas_tol
      const auto rhs_row = [&](int i) -> T {
        const T b_i = __ldcg(rhsC + i);
        T v = b_i;
        if (pv) {
          const T cj = cj_sh ? __ldcg(cjd + i) : T(i == 2);
          v = i == rg ? prhs : fma(-cj, prhs, b_i);
        }
        rhsN[i] = v;
        return v;
      };
      if (g == 0 && tid < 2) rhs_row(tid);
      for (int q = q0 + tid; q < q1; q += THREADS) {
        const T bi = rhs_row(q + 2);
        x.s = add_rn(x.s, T(fabs(bi)));
        const int k = do_pivot && q == r ? j : __ldcg(basC + q);
        basN[q] = k;
        if (DUAL) {
          if (bi < -p.feas_tol) x.a = min(x.a, q);
          offer(x, bi, q, false);
        } else if (retire && q == r_d) {
          p.art_out[k] = 0;
        } else if (__ldcg(p.art_out + k)) {
          x.a = min(x.a, q);
        }
      }
    }
    x = key_reduce(x, !DUAL, kr[3]);
    // the blocks' sums and picks, combined after barrier D (the repricing's
    // region: its next use follows barrier A); the step's objective row,
    // updated by block 0
    if (tid == 0) {
      post(mail_slot<T>(p.mail, R_R, g), x, T(0), 0);
      lap(&laps, C_FINISH);
    }
    gb.sync();
    if (tid == 0) {
      lap(&laps, C_D);
      bsh[2] = __ldcg(rhsN + (DUAL || phase != 1 ? 0 : 1));
    }
    const T gmax_step = x.v;
    combine_mail<T>(p.mail, R_R, !DUAL, &comb, &comb_g, &comb_f);
    x.s = comb.s;
    x.a = comb.a;
    if (DUAL) {
      x.v = comb.v;
      x.i = comb.i;
    }
    gmax_own = DEVEX && to_phase2 ? T(1) : gmax_step;
    const T z = -bsh[2];
    if (DUAL ? do_pivot : do_pricing) {
      const T d = DUAL ? sub_rn(z, last_z) : sub_rn(last_z, z);
      stuck = d > p.degen_tol ? 0 : stuck + 1;
      last_z = z;
    }
    bland = bland || stuck >= p.stall_limit;
    const bool finished = DUAL ? feasible : finished_opt;
    if (to_phase2) {
      phase = 2;
      stuck = 0;
      last_z = inf;
    }
    const bool finite_ok = finite_val(z) && finite_val(x.s) && crow_ok;
    status = !finite_ok   ? ST_NUMERIC
             : infeasible ? ST_INFEASIBLE
             : unbounded  ? ST_UNBOUNDED
             : finished   ? ST_OPTIMAL
                          : ST_RUNNING;
    niter += do_pivot;
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
  wide_store(slab, p.T_out, N, k0);
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
  p.ray_every = in[I_RAY_EVERY];
  p.R = in[I_ROWS];
  p.S = in[I_STAGES];
  p.TR = in[I_TROWS];
  p.TS = in[I_TILE];
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

// A streamed plan: R in [3, M), 1 to MAX_STAGES slots, TR a power of two
// up to THREADS, TS the tile's bytes rounded up to 16 (the bulk copies'
// unit).
inline bool streamed_ok(const int* in, long long es) {
  const int M = in[I_M], W = in[I_WIDTH], R = in[I_ROWS], S = in[I_STAGES], TR = in[I_TROWS];
  return R >= 3 && R < M && S >= 1 && S <= MAX_STAGES && TR >= 1 && TR <= THREADS &&
         (TR & (TR - 1)) == 0 && (long long)in[I_TILE] == align16((long long)TR * W * es);
}

// The plan's figures against this layout: G blocks of THREADS threads, W
// columns a block (G = ceil(n / W), at most one mailbox a thread), the
// slab's rows resident (all, or a streamed plan's), the bytes smem_bytes
// (smem_bytes_dv, smem_bytes_wide) and mail_bytes count; a walk, a ray
// cadence.
template <typename T>
bool plan_ok(const int* in) {
  const int M = in[I_M], N = in[I_N], G = in[I_BLOCKS], W = in[I_WIDTH];
  if (M < 3 || N < 2 || W < 1 || G < 1 || G > THREADS || in[I_THREADS] != THREADS ||
      in[I_RAY_EVERY] < 1 || in[I_WALK] < W_PRIMAL || in[I_WALK] > W_DUAL)
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
bool pointers_ok(const Params<T>& p, int walk, bool dvec) {
  return p.T_in && p.T_out && p.basis_in && p.basis_out && p.act_in && p.act_out && p.art_in &&
         p.art_out && p.phase_in && p.status_in && p.niter_in && p.stuck_in && p.bland_in &&
         p.lastz_in && p.ints_out && p.bland_out && p.lastz_out && p.mail && p.cols && p.bar &&
         (walk != W_DEVEX || (p.gamma_in && p.gamma_out)) && (p.R == p.M || p.scratch) &&
         (!dvec || p.bvec);
}

// The instantiation of a plan for a walk: the wide plan's kernel (I_VECS
// 2), else grid_kernel's for the kind of plan.
template <typename T, int WALK>
void (*walk_kernel(const int* in))(Params<T>) {
  if (in[I_VECS] == 2) return wide_kernel<T, WALK>;
  if (in[I_VECS] == 1) return grid_kernel<T, WALK, true, true>;
  return in[I_ROWS] < in[I_M] ? grid_kernel<T, WALK, true, false>
                              : grid_kernel<T, WALK, false, false>;
}

template <typename T>
void (*kernel_of(const int* in))(Params<T>) {
  if (in[I_WALK] == W_DEVEX) return walk_kernel<T, W_DEVEX>(in);
  if (in[I_WALK] == W_DUAL) return walk_kernel<T, W_DUAL>(in);
  return walk_kernel<T, W_PRIMAL>(in);
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
int rank1_grid(const long long* a, const int* in, const double* tol, void* stream) {
  if (!plan_ok<T>(in)) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(a, in, tol);
  if (!pointers_ok(p, in[I_WALK], in[I_VECS] != 0)) return (int)cudaErrorInvalidValue;
  return launch_walk<T>(kernel_of<T>(in), p, in[I_BLOCKS], in[I_SMEM], (cudaStream_t)stream);
}

template <typename T>
int rank1_grid_occupancy(const int* in, int* blocks) {
  if (!plan_ok<T>(in) || !blocks) return (int)cudaErrorInvalidValue;
  return occupancy_of<T>(kernel_of<T>(in), in[I_SMEM], blocks);
}

}  // namespace rgr
}  // namespace tpulp

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the plan's launch
// (*_occupancy_*): the blocks an SM holds at once (the grid must fit that
// times the SMs)
#if TPULP_F32
extern "C" int tpulp_rank1_grid_f32(const long long* a, const int* in, const double* tol,
                                    void* stream) {
  return tpulp::rgr::rank1_grid<float>(a, in, tol, stream);
}
extern "C" int tpulp_rank1_grid_occupancy_f32(const int* in, int* blocks) {
  return tpulp::rgr::rank1_grid_occupancy<float>(in, blocks);
}
#endif
#if TPULP_F64
extern "C" int tpulp_rank1_grid_f64(const long long* a, const int* in, const double* tol,
                                    void* stream) {
  return tpulp::rgr::rank1_grid<double>(a, in, tol, stream);
}
extern "C" int tpulp_rank1_grid_occupancy_f64(const int* in, int* blocks) {
  return tpulp::rgr::rank1_grid_occupancy<double>(in, blocks);
}
#endif
