// blocked_grid: a block of K eta-pivot slots of the solo rank-K blocked
// engine (solve/blocked.py: K applications of _blocked_pivot, one block of
// run_simplex_blocked's loop) in one persistent cooperative launch of G
// blocks, one an SM, with the block's eta factors U and V cut into slabs in
// the SMs' shared memory. The rank-K flush between the blocks stays B1
// (flush.cu) and the per-block ray scan blocked.cu's ray launch, both
// launched by the host, as on the cluster route.
//
// Replaces no Pallas kernel: in tpulp the engine is XLA's compiled
// lax.while_loop over _blocked_pivot (tpulp/solve/blocked.py:61-245, one
// block of run_simplex_blocked's fori_loop 272-275). It is the redesign of
// blocked.cu's slot (six stream-ordered launches a slot, its price and
// finish on one block each, enqueued by the host) for the LPs whose
// factors no cluster holds (blocked_cluster.cu keeps those) and whose slabs
// the grid's shared memory holds (kernels/blocked_grid.py::
// blocked_grid_plan; K = 64 at f64: M + N up to ~50,500 for a wide LP,
// ~39,500 with n = 2m); blocked.cu keeps the others.
//
// What bounds it on the H100: a slot reads one column and one row of T0
// (read-only, in the 50 MB L2 at the LPs of this range) and the factors'
// slots written so far (the eta sums: 2 t (M + N) operations at slot t);
// the launch loads and stores the factors once. At 258 x 14,257 f64, K =
// 64: 0.11 us a slot by bytes from device memory (each input once a
// launch), 0.22 with the eta sums' U and V entries read from shared memory
// at 128 bytes a clock on 131 SMs (chip_smoke.py's cluster_bound and
// grid_slot_bound). So a slot is set by the latency of its chain of
// decisions: two grid barriers (1.0-1.5 us each there, measured on an
// H100 by chip_smoke.py's grid_slot_us), the L2 round trips of the
// mailboxes around them and a few block reductions, not by bytes.
//
// Design: blocked_cluster.cu's layout, moved from one cluster to the grid,
// on grid.cuh's machinery (the flag barrier, mailboxes in device memory
// read through L2 and combined in block order, the key reductions, block
// 0's stage clock). Block g owns the column slab [g W, (g + 1) W), W =
// ceil(N / G), with its entries of row0, row1, the devex weights and the
// active mask, and the row slab [g H, (g + 1) H), H = ceil(M / G), with its
// entries of bvec and of the entering column; its dynamic shared memory
// holds V[0..K, column slab] and U[0..K, row slab]. Every block holds the
// basis, the artificial mask (a bit a column), the walk's scalars, row0[N -
// 1] and row1[N - 1] and the factors' entries that every slot reads (U's
// rows 0 and 1, V's column N - 1) alike, and computes them from the same
// values in the same order, so every decision is the same in every block.
// No block reads another's shared memory: what a slot needs across blocks
// goes through the mailboxes. T0 is never written. A slot:
// 1. (a clean-up slot only: the owner of the clean-up row posts U[0..t,
//    r_d + 2]; barrier C; every block reads it.) The block prices its own
//    columns (Dantzig's NaN-first argmin of c_eff, Bland's first improving
//    column, devex's c^2 / gamma and, beside it, c^2, its pick should the
//    previous slot's weights reset), the clean-up row's first eligible
//    column, the |c| sum; it posts its candidates with the V columns of
//    the ones that can enter (the mode's pick; under devex also the pick
//    under unit weights; column n - 1 from its owner where the mode finds
//    none), and the previous slot's largest weight and |bvec[2:]| sum.
//    Barrier A;
// 2. every block brings the G mailbox headers (contiguous in device
//    memory) into its shared memory with coalesced loads, one L2 round
//    trip, and one warp combines them in block order (offer's order is
//    total, so the lanes' folds and the shuffle tree give the sequential
//    argmin exactly; the sums in kernels/sums.py::grid_sum's order). First the previous slot's finish ends: its |bvec[2:]| sum not
//    finite makes it NUMERIC, its largest weight past reset_above resets
//    the weights (and this slot's devex pick is the unit one). Then the
//    entering column j, the retire and the phase bookkeeping; the block
//    reads V[0..t, j] (and, from the tail, its weight) from j's owner's
//    mailbox, forms its rows of colj =
//    T0[:, j] + sum_k V[k, j] U[k] and, in warp 0, runs driver.ratio_rows'
//    rules on them: its minimum ratio, its first row above piv_tol and its
//    pick among its rows that tie with its own minimum; it posts them with
//    its candidate row's U[0..t, q + 2] and, in the tail, its pivot colj[q +
//    2] (the owner of row 2 also row 2's, the owner of the clean-up row its
//    colj entry).
//    Barrier B;
// 3. every block combines the ratio candidates (one fold: the least
//    minimum, and over the blocks that hold it the tie picks), which fixes
//    r, the slot's act and the exits; it reads U[0..t, r + 2] and the
//    pivot from the owner of row r + 2 (the clean-up row's U entries are
//    already in hand), forms
//    its columns of vrow = (T0[r + 2] + sum_k U[k, r + 2] V[k]) * act,
//    updates its row0, row1, devex weights and bvec rows (one fma an
//    entry), writes V[t, own columns] = vrow and U[t, own rows] = w = (e_{r
//    + 2} - colj) / piv * act in its own shared memory, and reduces its
//    weights' maximum, its |bvec[2:]| sum and the first row whose basic
//    column is artificial after the pivot and the retire; then the finish
//    alike in every block: the basis, the retire, the phase change's reset,
//    the stall counter and the Bland switch, the phase change, the status in
//    status_select's precedence but the |bvec[2:]| sum's, t and niter. The
//    rest of the finish (that sum's NUMERIC, the reset on the grid's
//    largest weight) waits for the next slot's combine, or for one last
//    barrier after the block's last slot.
// So a slot meets at two grid barriers (three in a clean-up slot), against
// the cluster's three. A mailbox region is written again only after the
// barrier that follows every read of it. The loop stops only once the
// status leaves RUNNING, a value every block holds alike: a slot past the
// budget pivots nowhere (act) and still records an exit, a phase change or
// a retire, as blocked.cu's. The arithmetic is blocked.cu's: every eta sum
// runs k = 0 .. t, one fma a slot, in the tableau's type; one rounding per
// operation; comparisons against tolerances rounded to the tableau's type.
// The sums that feed finiteness checks only (the pre-step |c| over the
// active columns, the post-step |bvec[2:]|) are taken per block (per
// thread, the warp tree, across warps) and across blocks in grid_sum's
// order: kernels/blocked_grid.py's plain version takes them in that order.
//
// The block's start: a record that is not running within max_iters is
// left as it is, but LIVE = 0 (every block reads the same two fields before
// any barrier and returns), as blocked_cluster.cu's.

#include "grid.cuh"

namespace tpulp {
namespace bgd {

using namespace grid;

constexpr int ST_RUNNING = 0, ST_OPTIMAL = 1, ST_UNBOUNDED = 2, ST_INFEASIBLE = 3,
              ST_NUMERIC = 5;
// pricing rules and tie breaks (tpulp_torch.core.state)
constexpr int RULE_BLAND_ = 1, RULE_DEVEX_ = 3, TIE_MAXPIV_ = 1;
constexpr int MAX_K = 1024;  // eta slots of a block (kernels/blocked.py's MAX_K)
// the bytes of a block's mailbox headers, 32 a part so that a lane brings
// a part in one L2 sector: the price's (the picks at 0, the unit pick with
// the previous slot's sums at 32), the ratio test's; and of the tail after
// a slot's two factor columns (the price's: the weight of the column it
// posts; the ratio test's: the pivot of the row it posts, colj[2] from
// the owner of row 2, colj[r_d + 2] from the owner of the clean-up row),
// which only the readers of the winner's columns fetch
constexpr int HEAD_A = 64, HEAD_A2 = 32, HEAD_B = 32, TAIL = 32;

// the record (kernels/blocked.py's BlockedRecord): its int32 scalars, the
// lane's verdict at the launch's start, and values
enum Field { PHASE, STATUS, NITER, STUCK, BLAND, SLOT, ART_ROW, LIVE = 25 };
enum Val { LAST_Z };
// the wrapper's argument arrays (tpulp_torch/kernels/blocked_grid.py)
enum Arg {
  A_T, A_U, A_V, A_ROW0, A_ROW1, A_BVEC, A_GAMMA, A_BASIS, A_ACT, A_ART, A_INTS, A_VALS,
  A_MAIL, A_BAR, A_CYCLES, A_NARGS
};
enum Int {
  I_M, I_N, I_K, I_STALL, I_MAXIT, I_RULE, I_TIE, I_BLOCKS, I_WIDTH, I_HEIGHT, I_THREADS,
  I_SMEM, I_MAIL, I_NINTS
};
enum Tol { D_OPT, D_PIV, D_DEGEN, D_INFEAS, D_RESET, D_NTOLS };
// the stages that ``cycles`` splits a launch into (block 0's clock; summed
// over the slots): the load, then a slot's clean-up row (barrier C and its
// read), pricing and the post, barrier A, the combine with the read of
// V[0..t, j], the entering column's rows, the ratio test and its post,
// barrier B, the combine with the read of U[0..t, r + 2], the pivot row and
// the updates, the block's reduction, the finish; the last slot's sums
// (one barrier); the store
enum Stage {
  C_LOAD, C_CLEANUP, C_PRICE, C_A, C_COMBINE_A, C_COLUMN, C_RATIO, C_B, C_COMBINE_B, C_ROW,
  C_REDUCE, C_FINISH, C_FINAL, C_STORE, C_NSTAGES
};

template <typename T>
struct Params {
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
  unsigned char* mail;  // mail_bytes(G, K, sizeof(T))
  unsigned* bar;        // the grid barrier's counter (zeroed before the launch)
  long long* cycles;    // (C_NSTAGES,) SM cycles per stage (block 0), or null
  int M, N, K, W, H, stall_limit, max_iters;
  bool devex, bland_rule, max_piv;
  // the tolerances rounded to T, as torch rounds a Python float against a
  // tensor of T; devex's reset threshold
  T opt_tol, piv_tol, degen_tol, infeas_tol, reset_above;
};

// ---------------------------------------------------------------------------
// the layout of a block's shared memory and of the mailboxes
// ---------------------------------------------------------------------------

// The dynamic shared memory of a block, each segment 16-byte aligned: V's
// column slab (K x W) and U's row slab (K x H), slot-major; row0, row1 and
// the weights of the column slab (W each); bvec and colj of the row slab (H
// each); U's rows 0 and 1, V's column N - 1, the entering column's V
// entries, the pivot row's U entries and the clean-up row's (K each); the
// basis (m ints); the column slab's active mask (W); the artificial mask (a
// bit a column, in 32-bit words); the G mailbox headers a combine brings
// (HEAD_A each). The wrapper's blocked_grid_plan counts the same bytes; the
// launch refuses a plan that disagrees.
template <typename T>
__host__ __device__ long long smem_bytes(int M, int N, int K, int W, int H, int G) {
  const long long m = M - 2, n = N - 1, es = sizeof(T);
  return align16((long long)K * W * es) + align16((long long)K * H * es) +
         3 * align16((long long)W * es) + 2 * align16((long long)H * es) +
         6 * align16((long long)K * es) + align16(4 * m) + align16(W) +
         align16(4 * ((n + 31) / 32)) + align16((long long)HEAD_A * G);
}

// A mailbox vector of K values, 16-byte aligned.
__host__ __device__ __forceinline__ long long vec_bytes(int K, long long es) {
  return align16((long long)K * es);
}

// The mailboxes: the G price headers and the G ratio headers, each set
// contiguous (so that a block brings a set with coalesced loads), then each
// block's price columns (two V columns and a tail) and ratio columns (two U
// columns and a tail), then the clean-up row's U column.
__host__ __device__ __forceinline__ long long cols_bytes(int K, long long es) {
  return 2 * vec_bytes(K, es) + TAIL;
}
__host__ __device__ __forceinline__ long long mail_bytes(int G, int K, long long es) {
  return (long long)G * (HEAD_A + HEAD_B + 2 * cols_bytes(K, es)) + vec_bytes(K, es);
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
  T* u0;    // U[., 0]
  T* u1;    // U[., 1]
  T* vlst;  // V[., N - 1]
  T* vcol;  // V[., j]
  T* ucol;  // U[., r + 2]
  T* ucl;   // U[., r_d + 2]
  int* basis;
  unsigned char* act;
  unsigned* artb;
  unsigned char* hdr;  // the G mailbox headers a combine brings
};

__device__ __forceinline__ unsigned char* segment(unsigned char* dyn, long long& off,
                                                  long long bytes) {
  unsigned char* at = dyn + off;
  off += align16(bytes);
  return at;
}

template <typename T>
__device__ Layout<T> layout(int M, int N, int K, int W, int H, unsigned char* dyn) {
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
  L.u0 = (T*)segment(dyn, off, K * es);
  L.u1 = (T*)segment(dyn, off, K * es);
  L.vlst = (T*)segment(dyn, off, K * es);
  L.vcol = (T*)segment(dyn, off, K * es);
  L.ucol = (T*)segment(dyn, off, K * es);
  L.ucl = (T*)segment(dyn, off, K * es);
  L.basis = (int*)segment(dyn, off, 4LL * (M - 2));
  L.act = segment(dyn, off, W);
  L.artb = (unsigned*)segment(dyn, off, 4LL * ((N - 1 + 31) / 32));
  L.hdr = dyn + off;
  return L;
}

__device__ __forceinline__ bool art_of(const unsigned* artb, int k) {
  return (artb[k >> 5] >> (k & 31)) & 1u;
}

// What a block posts after pricing: the first part (its pick (v, i), its
// first improving column a, its clean-up row's first eligible column b,
// its |c| sum s) and the second (its pick under unit weights (v2, i2), the
// previous slot's largest weight and |bvec[2:]| sum); in the tail, the
// weight of the column whose V entries it posts first (the pick, or under
// Bland the first improving column: the entering column's weight when it
// wins).
template <typename T>
struct alignas(16) MailA1 {
  T v, s;
  int i, a, b, pad;
};
template <typename T>
struct alignas(16) MailA2 {
  T v2, gmax, bsum;
  int i2;
};
// What a block posts after its ratio test: its minimum ratio m at row qi
// (NaN first, first row), its pick among its rows that tie with m (pv, pi:
// Bland's smallest basic index or the largest pivot element), its first
// row above piv_tol a; in the tail, the pivots (the posted row's, the
// owners' colj[2] and colj[r_d + 2]).
template <typename T>
struct alignas(16) MailB {
  T m, pv;
  int qi, pi, a, pad;
};
static_assert(sizeof(MailA1<double>) <= HEAD_A2, "the price header's first part");
static_assert(HEAD_A2 + sizeof(MailA2<double>) <= HEAD_A, "the price header");
static_assert(sizeof(MailB<double>) <= HEAD_B, "the ratio header");
static_assert(3 * sizeof(double) <= TAIL, "the tails");

__device__ __forceinline__ unsigned char* head_a(unsigned char* mail, int g) {
  return mail + (long long)g * HEAD_A;
}
__device__ __forceinline__ unsigned char* head_b(unsigned char* mail, int g) {
  return mail + (long long)gridDim.x * HEAD_A + (long long)g * HEAD_B;
}
__device__ __forceinline__ unsigned char* cols_a(unsigned char* mail, int g, int K, int es) {
  return mail + (long long)gridDim.x * (HEAD_A + HEAD_B) + (long long)g * cols_bytes(K, es);
}
__device__ __forceinline__ unsigned char* cols_b(unsigned char* mail, int g, int K, int es) {
  return mail + (long long)gridDim.x * (HEAD_A + HEAD_B) +
         ((long long)gridDim.x + g) * cols_bytes(K, es);
}
__device__ __forceinline__ unsigned char* col_cl(unsigned char* mail, int K, int es) {
  return mail + (long long)gridDim.x * (HEAD_A + HEAD_B + 2 * cols_bytes(K, es));
}

// ---------------------------------------------------------------------------
// the combines, in block order
// ---------------------------------------------------------------------------

// offer's rule: whether (yv, yi) beats (xv, xi) in torch's NaN-first argmin
// (mx: argmax), ties to the smaller index
template <typename T>
__device__ __forceinline__ bool beats(T xv, int xi, T yv, int yi, bool mx) {
  const bool xn = is_nan(xv), yn = is_nan(yv);
  if (xn || yn) return yn && (!xn || yi < xi);
  return (mx ? yv > xv : yv < xv) || (yv == xv && yi < xi);
}

template <typename T>
struct CombA1 {
  T v, s;
  int i, a, b;
};
template <typename T>
struct CombA2 {
  T v2, gmax, bsum;
  int i2;
};

template <typename T>
__device__ __forceinline__ void fold_a1(CombA1<T>& x, T v, int i, int a, int b, bool mx) {
  if (beats(x.v, x.i, v, i, mx)) {
    x.v = v;
    x.i = i;
  }
  x.a = min(x.a, a);
  x.b = min(x.b, b);
}

template <typename T>
__device__ __forceinline__ void fold_a2(CombA2<T>& x, T v2, T gmax, int i2) {
  if (beats(x.v2, x.i2, v2, i2, true)) {
    x.v2 = v2;
    x.i2 = i2;
  }
  x.gmax = nan_max(x.gmax, gmax);
}

template <typename T>
__device__ __forceinline__ CombA1<T> ident_a1(bool mx) {
  CombA1<T> y;
  y.v = mx ? -pos_inf<T>() : pos_inf<T>();
  y.s = T(0);
  y.i = y.a = y.b = BIG_I;
  return y;
}

template <typename T>
__device__ __forceinline__ CombA2<T> ident_a2() {
  CombA2<T> y;
  y.v2 = y.gmax = -pos_inf<T>();
  y.bsum = T(0);
  y.i2 = BIG_I;
  return y;
}

// The ratio candidates' fold: the least minimum m (NaN first, first row
// qi), and over the blocks whose minimum it is the tie pick (pv, pi; mxp:
// the largest pivot's argmax, else Bland's argmin); the first row above
// piv_tol a. A total order on m with an
// associative tie fold: the fold in any grouping gives blocked_cluster.cu's
// two passes (the global minimum, then the picks of the blocks that hold
// it).
template <typename T>
__device__ __forceinline__ void fold_b(MailB<T>& x, T m, T pv, int qi, int pi, int a, bool mxp) {
  x.a = min(x.a, a);
  const bool xn = is_nan(x.m), yn = is_nan(m);
  bool take_all = false;
  if (xn || yn) {
    take_all = yn && (!xn || qi < x.qi);
  } else if (m < x.m) {
    take_all = true;
  } else if (m == x.m) {
    x.qi = min(x.qi, qi);
    if (beats(x.pv, x.pi, pv, pi, mxp)) {
      x.pv = pv;
      x.pi = pi;
    }
  }
  if (take_all) {
    x.m = m;
    x.qi = qi;
    x.pv = pv;
    x.pi = pi;
  }
}

template <typename T>
__device__ __forceinline__ MailB<T> ident_b(bool mxp) {
  MailB<T> y;
  y.m = pos_inf<T>();
  y.pv = mxp ? -pos_inf<T>() : pos_inf<T>();
  y.qi = y.pi = y.a = BIG_I;
  y.pad = 0;
  return y;
}

// A combine brings the G headers of a region (HEAD bytes each, contiguous in
// device memory) into shared memory with coalesced 16-byte loads over the
// whole block, one L2 round trip; then lane l of one warp folds blocks l, l +
// 32, ... in turn and the shuffle tree folds the lanes: offer's order is
// total, so this gives the sequential argmin exactly, and the sums are
// kernels/sums.py::grid_sum's order.
__device__ __forceinline__ void bring(const unsigned char* src, unsigned char* hdr, int bytes) {
  const int4* from = (const int4*)src;
  int4* to = (int4*)hdr;
  for (int e = threadIdx.x; e < bytes / 16; e += THREADS) to[e] = __ldcg(from + e);
  __syncthreads();
}

// The price mailboxes into *out1 (``first``: the block's last combine needs
// the second part alone) and *out2; called by every thread, a barrier ends
// it.
template <typename T>
__device__ void combine_a(unsigned char* mail, unsigned char* hdr, bool mx, bool first,
                          CombA1<T>* out1, CombA2<T>* out2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, G = gridDim.x;
  bring(mail, hdr, G * HEAD_A);
  if (warp == 0 && first) {
    CombA1<T> y = ident_a1<T>(mx);
    for (int q = lane; q < G; q += 32) {
      const MailA1<T>* mb = (const MailA1<T>*)(hdr + (long long)q * HEAD_A);
      fold_a1(y, mb->v, mb->i, mb->a, mb->b, mx);
      y.s = add_rn(y.s, mb->s);
    }
    for (int off = 16; off > 0; off >>= 1)
      fold_a1(y, __shfl_down_sync(FULL, y.v, off), __shfl_down_sync(FULL, y.i, off),
              __shfl_down_sync(FULL, y.a, off), __shfl_down_sync(FULL, y.b, off), mx);
    const T s = warp_tree_sum(y.s);
    if (lane == 0) {
      y.s = s;
      *out1 = y;
    }
  } else if (warp == 1) {
    CombA2<T> y = ident_a2<T>();
    for (int q = lane; q < G; q += 32) {
      const MailA2<T>* mb = (const MailA2<T>*)(hdr + (long long)q * HEAD_A + HEAD_A2);
      fold_a2(y, mb->v2, mb->gmax, mb->i2);
      y.bsum = add_rn(y.bsum, mb->bsum);
    }
    for (int off = 16; off > 0; off >>= 1)
      fold_a2(y, __shfl_down_sync(FULL, y.v2, off), __shfl_down_sync(FULL, y.gmax, off),
              __shfl_down_sync(FULL, y.i2, off));
    const T bs = warp_tree_sum(y.bsum);
    if (lane == 0) {
      y.bsum = bs;
      *out2 = y;
    }
  }
  __syncthreads();
}

// The ratio mailboxes into *out, as combine_a; called by every thread, a
// barrier ends it.
template <typename T>
__device__ void combine_b(unsigned char* mail, unsigned char* hdr, bool mxp, MailB<T>* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, G = gridDim.x;
  bring(head_b(mail, 0), hdr, G * HEAD_B);
  if (warp == 0) {
    MailB<T> y = ident_b<T>(mxp);
    for (int q = lane; q < G; q += 32) {
      const MailB<T>* mb = (const MailB<T>*)(hdr + (long long)q * HEAD_B);
      fold_b(y, mb->m, mb->pv, mb->qi, mb->pi, mb->a, mxp);
    }
    for (int off = 16; off > 0; off >>= 1)
      fold_b(y, __shfl_down_sync(FULL, y.m, off), __shfl_down_sync(FULL, y.pv, off),
             __shfl_down_sync(FULL, y.qi, off), __shfl_down_sync(FULL, y.pi, off),
             __shfl_down_sync(FULL, y.a, off), mxp);
    if (lane == 0) *out = y;
  }
  __syncthreads();
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

// The values a stage's combine hands to the whole block.
template <typename T>
struct Comb {
  CombA1<T> a1;
  CombA2<T> a2;
  MailB<T> b;
  T colj0, colj1, gq, piv, vlast;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) blocked_grid_kernel(Params<T> p) {
  // the warps' shares of the block's key reductions, each call site its own
  __shared__ KeyRed<T> kr[3][WARPS];
  __shared__ Comb<T> comb;
  __shared__ Laps<C_NSTAGES> laps;  // thread 0's, on block 0 only
  __shared__ Layout<T> L;  // the pointers in shared memory, not in registers
  extern __shared__ __align__(16) unsigned char grid_dyn[];
  GridBarrier gb{p.bar, 0u, 1};
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M, N = p.N, K = p.K, W = p.W, H = p.H, m = M - 2, n = N - 1;
  const int es = sizeof(T);
  const long long vstride = vec_bytes(K, es) / es;  // a mailbox vector, in values
  // this block's columns [k0, k0 + wk) and rows [i0, i0 + hi)
  const int k0 = g * W, wk = max(0, min(N, k0 + W) - k0);
  const int i0 = g * H, hi = max(0, min(M, i0 + H) - i0);
  const T inf = pos_inf<T>();
  const bool devex = p.devex;
  {
    // the block-start freeze: every block reads the same two fields before
    // any barrier; block 0 records the verdict
    const bool live = p.rec[STATUS] == ST_RUNNING && p.rec[NITER] < p.max_iters;
    if (g == 0 && tid == 0) p.rec[LIVE] = live;
    if (!live) return;
  }
  if (tid == 0) {
    L = layout<T>(M, N, K, W, H, grid_dyn);
    laps.on = p.cycles != nullptr && g == 0;
    laps.last = clock64();
    for (int k = 0; k < C_NSTAGES; ++k) laps.cyc[k] = 0;
  }
  __syncthreads();
  const T* tab = p.tab;

  // ---- load: the factors' slabs, the running vectors, the replicated
  // state, the scalars ----
  for (int e = tid; e < K * wk; e += THREADS) {
    const int k = e / wk, kk = e - k * wk;
    L.V[(long long)k * W + kk] = p.V[(long long)k * N + k0 + kk];
  }
  for (int e = tid; e < K * hi; e += THREADS) {
    const int k = e / hi, ii = e - k * hi;
    L.U[(long long)k * H + ii] = p.U[(long long)k * M + i0 + ii];
  }
  for (int k = tid; k < K; k += THREADS) {
    L.u0[k] = p.U[(long long)k * M];
    L.u1[k] = p.U[(long long)k * M + 1];
    L.vlst[k] = p.V[(long long)k * N + N - 1];
  }
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    L.row0[kk] = p.row0[k];
    L.row1[kk] = p.row1[k];
    L.gamma[kk] = k < n ? p.gamma[k] : T(1);
    L.act[kk] = k < n && p.act[k] != 0;
  }
  for (int ii = tid; ii < hi; ii += THREADS) L.bvec[ii] = p.bvec[i0 + ii];
  for (int i = tid; i < m; i += THREADS) L.basis[i] = p.basis[i];
  // the artificial mask, 32 columns a word (a warp a word)
  for (int w0 = warp * 32; w0 < n; w0 += THREADS) {
    const unsigned bits = __ballot_sync(FULL, w0 + lane < n && p.art[w0 + lane] != 0);
    if (lane == 0) L.artb[w0 >> 5] = bits;
  }
  int phase = p.rec[PHASE], status = p.rec[STATUS], niter = p.rec[NITER];
  int stuck = p.rec[STUCK], slot = p.rec[SLOT], ar = p.rec[ART_ROW];
  bool bland = p.rec[BLAND] != 0;
  T last_z = p.vals[LAST_Z];
  // the objectives' entries, row0[N - 1] and row1[N - 1]
  T z0 = p.row0[N - 1], z1 = p.row1[N - 1];
  // the previous slot's sums, waiting for the next combine (pending)
  bool pending = false;
  T gmax_own = -inf, bsum_own = T(0);
  __syncthreads();
  if (tid == 0) lap(&laps, C_LOAD);

  for (int s = 0; s < K && status == ST_RUNNING; ++s) {
    const int t = min(slot, K - 1);
    const bool keep = slot < K;  // the eta slot is written (always, in a block)
    // ---- 1. the clean-up row; pricing over the own columns; barrier A ----
    const bool cleanup = ar != BIG_I && phase == 2;
    const int r_d = ar != BIG_I ? ar : 0;
    const bool use_bland = bland || p.bland_rule;
    if (cleanup) {
      // U[0..t, r_d + 2] from the row's owner, through barrier C
      const int rgd = r_d + 2;
      T* cl = (T*)col_cl(p.mail, K, es);
      if (rgd >= i0 && rgd < i0 + hi)
        for (int k = tid; k <= t; k += THREADS) cl[k] = L.U[(long long)k * H + rgd - i0];
      gb.sync();
      for (int k = tid; k <= t; k += THREADS) L.ucl[k] = __ldcg(cl + k);
      __syncthreads();
      if (tid == 0) lap(&laps, C_CLEANUP);
    }
    {
      // over the own columns: the pick (v, i), devex's argmax of c^2 /
      // gamma over the improving columns (and of c^2: the pick under unit
      // weights), else the argmin of c_eff; the first improving column (a);
      // the clean-up row's first eligible column (b); the sum of |crow|
      // over the active columns (s)
      const T* crow = phase == 1 ? L.row1 : L.row0;
      const T* trow = tab + (long long)(r_d + 2) * N;
      Red<T> cols = red_identity<T>(devex), unit = red_identity<T>(true);
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        if (k >= n) continue;
        const bool act = L.act[kk] != 0;
        const T c = crow[kk];
        const T c_eff = act ? c : inf;
        const bool improving = c_eff < -p.opt_tol;
        if (improving) cols.a = min(cols.a, k);
        if (act) cols.s = add_rn(cols.s, T(fabs(c)));
        if (devex) {
          offer(cols, improving ? div_rn(mul_rn(c, c), L.gamma[kk]) : -inf, k, true);
          offer(unit, improving ? mul_rn(c, c) : -inf, k, true);
        } else {
          offer(cols, c_eff, k, false);
        }
        if (cleanup) {
          const T rowd = add_rn(trow[k], eta_dot(L.ucl, L.V + kk, W, t));
          if (act && !art_of(L.artb, k) && T(fabs(rowd)) > p.piv_tol) cols.b = min(cols.b, k);
        }
      }
      cols = key_reduce(cols, devex, kr[0]);
      if (devex) unit = key_reduce(unit, true, kr[1]);
      // the V columns of the candidates that can enter: the mode's pick
      // (c0; column n - 1 from its owner where the mode finds none) and,
      // under devex pricing, the pick under unit weights (c1)
      const bool own_last = n - 1 >= k0 && n - 1 < k0 + wk;
      const bool by_score = devex && !cleanup && !use_bland;
      int c0 = -1;
      if (cleanup)
        c0 = cols.b != BIG_I ? cols.b : own_last ? n - 1 : -1;
      else if (use_bland)
        c0 = cols.a != BIG_I ? cols.a : own_last ? n - 1 : -1;
      else
        c0 = cols.i < n ? cols.i : -1;
      const int c1 = by_score && unit.i < n ? unit.i : -1;
      unsigned char* sa = head_a(p.mail, g);
      T* v0 = (T*)cols_a(p.mail, g, K, es);
      for (int k = tid; k <= t; k += THREADS) {
        if (c0 >= 0) v0[k] = L.V[(long long)k * W + c0 - k0];
        if (c1 >= 0) v0[vstride + k] = L.V[(long long)k * W + c1 - k0];
      }
      if (tid == 0) {
        MailA1<T>* ma = (MailA1<T>*)sa;
        ma->v = cols.v;
        ma->i = cols.i;
        ma->a = cols.a;
        ma->b = cols.b;
        ma->s = cols.s;
        if (c0 >= 0) v0[2 * vstride] = L.gamma[c0 - k0];
      } else if (tid == 32) {
        MailA2<T>* mb = (MailA2<T>*)(sa + HEAD_A2);
        mb->v2 = devex ? unit.v : -inf;
        mb->i2 = devex ? unit.i : BIG_I;
        mb->gmax = pending ? gmax_own : -inf;
        mb->bsum = pending ? bsum_own : T(0);
      }
      if (tid == 0) lap(&laps, C_PRICE);
    }
    gb.sync();
    if (tid == 0) lap(&laps, C_A);

    // ---- 2. the combine; the previous slot's finish; the entering column;
    // the ratio test; barrier B ----
    combine_a(p.mail, L.hdr, devex, true, &comb.a1, &comb.a2);
    bool reset = false;
    if (pending) {
      // the previous slot's |bvec[2:]| sum and the reset on its largest
      // weight
      if (!finite_val(comb.a2.bsum)) status = ST_NUMERIC;
      reset = devex && comb.a2.gmax > p.reset_above;
      if (reset)
        for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
      pending = false;
    }
    if (status != ST_RUNNING) break;
    const bool crow_ok = finite_val(comb.a1.s);
    const bool has_improving = comb.a1.a != BIG_I;
    const bool has_elig = cleanup && comb.a1.b != BIG_I;
    const bool by_score = devex && !cleanup && !use_bland;
    const int ipick = by_score && reset ? comb.a2.i2 : comb.a1.i;
    const int j_price = use_bland ? (has_improving ? comb.a1.a : n - 1) : ipick;
    const bool phase1_done = phase == 1 && !has_improving;
    const bool infeasible1 = phase1_done && -z1 > p.infeas_tol;
    const bool to_phase2 = phase1_done && !infeasible1;
    const bool pricing_pivot = has_improving && !cleanup && phase != 0;
    const bool retire = cleanup && !has_elig;
    const int j = cleanup ? (has_elig ? comb.a1.b : n - 1) : j_price;
    // the entering column's weight (read only on a devex pricing pivot,
    // whose j is the pick or, under Bland, the first improving column):
    // 1 after the reset
    // T0's entry of the thread's first row (the last two threads: rows 0
    // and 1), loaded while the V column arrives
    const T t0_own = tid < hi ? tab[(long long)(i0 + tid) * N + j] : T(0);
    const T t0_01 = tid == THREADS - 1 ? tab[j] : tid == THREADS - 2 ? tab[N + j] : T(0);
    {
      // V[0..t, j] from j's owner (the unit pick's vector after a reset),
      // and the weight it posted beside it (read only on a devex pricing
      // pivot, whose j is its pick or, under Bland, its first improving
      // column: 1 after the reset)
      const T* vs = (const T*)cols_a(p.mail, j / W, K, es);
      for (int k = tid; k <= t; k += THREADS)
        L.vcol[k] = __ldcg(vs + (by_score && reset ? vstride : 0) + k);
      if (tid == THREADS - 3) comb.gq = reset ? T(1) : __ldcg(vs + 2 * vstride);
    }
    __syncthreads();
    const T gq = comb.gq;
    if (tid == 0) lap(&laps, C_COMBINE_A);
    // the own rows of colj = T0[:, j] + sum_k V[k, j] U[k], and its rows 0
    // and 1 (replicated: the block's last two threads, idle unless the
    // slab has more rows than the block threads)
    for (int ii = tid; ii < hi; ii += THREADS)
      L.colj[ii] = add_rn(ii == tid ? t0_own : tab[(long long)(i0 + ii) * N + j],
                          eta_dot(L.vcol, L.U + ii, H, t));
    if (tid == THREADS - 1) comb.colj0 = add_rn(t0_01, eta_dot(L.vcol, L.u0, 1, t));
    if (tid == THREADS - 2) comb.colj1 = add_rn(t0_01, eta_dot(L.vcol, L.u1, 1, t));
    __syncthreads();
    if (tid == 0) lap(&laps, C_COLUMN);
    unsigned char* sb = head_b(p.mail, g);
    T* ub = (T*)cols_b(p.mail, g, K, es);
    if (warp == 0) {
      // driver.ratio_rows over the own rows >= 2 (ratio row i - 2), a lane
      // a row: the NaN-first argmin of the ratios (v, i) and the first row
      // above piv_tol (a); under Bland or largest-pivot ties, the pick
      // among the rows that tie with the block's own minimum
      const int ib = max(i0, 2), ie = i0 + hi;
      T lv = inf;
      int li = BIG_I, la = BIG_I;
      for (int i = ib + lane; i < ie; i += 32) {
        const T c = L.colj[i - i0];
        const bool pos = c > p.piv_tol;
        if (pos) la = min(la, i - 2);
        const T q = pos ? div_rn(L.bvec[i - i0], c) : inf;
        if (beats(lv, li, q, i - 2, false)) {
          lv = q;
          li = i - 2;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T v = __shfl_down_sync(FULL, lv, off);
        const int i = __shfl_down_sync(FULL, li, off);
        if (beats(lv, li, v, i, false)) {
          lv = v;
          li = i;
        }
      }
      la = __reduce_min_sync(FULL, (unsigned)la);
      lv = __shfl_sync(FULL, lv, 0);
      li = __shfl_sync(FULL, li, 0);
      const bool mxp = !use_bland;
      T tv = mxp ? -inf : inf;
      int ti = BIG_I;
      if (use_bland || p.max_piv) {
        const bool min_nan = is_nan(lv);
        for (int i = ib + lane; i < ie; i += 32) {
          const T c = L.colj[i - i0];
          const T q = c > p.piv_tol ? div_rn(L.bvec[i - i0], c) : inf;
          const bool tie = !min_nan && q <= lv;
          const T v = use_bland ? (tie ? T(L.basis[i - 2]) : T(BIG_I)) : (tie ? c : -inf);
          if (beats(tv, ti, v, i - 2, mxp)) {
            tv = v;
            ti = i - 2;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const T v = __shfl_down_sync(FULL, tv, off);
          const int i = __shfl_down_sync(FULL, ti, off);
          if (beats(tv, ti, v, i, mxp)) {
            tv = v;
            ti = i;
          }
        }
        tv = __shfl_sync(FULL, tv, 0);
        ti = __shfl_sync(FULL, ti, 0);
      }
      // the candidate row whose U column and pivot the block posts: the
      // tie pick under Bland or largest-pivot ties, else the minimum's row
      const int q = use_bland || p.max_piv ? ti : li;
      if (q != BIG_I) {
        for (int k = lane; k <= t; k += 32) ub[k] = L.U[(long long)k * H + q + 2 - i0];
        if (lane == 0) ub[2 * vstride] = L.colj[q + 2 - i0];
      }
      if (lane == 0) {
        MailB<T>* mb = (MailB<T>*)sb;
        mb->m = lv;
        mb->qi = li;
        mb->a = la;
        mb->pv = tv;
        mb->pi = ti;
      }
    } else if (warp == 1) {
      // the owner of row 2: U[0..t, 2] and colj[2] (the row of a NaN
      // minimum); the owner of the clean-up row: colj[r_d + 2]
      if (2 >= i0 && 2 < i0 + hi) {
        for (int k = lane; k <= t; k += 32)
          ub[vstride + k] = L.U[(long long)k * H + 2 - i0];
        if (lane == 0) ub[2 * vstride + 1] = L.colj[2 - i0];
      }
      if (lane == 0 && cleanup && r_d + 2 >= i0 && r_d + 2 < i0 + hi)
        ub[2 * vstride + 2] = L.colj[r_d + 2 - i0];
    }
    if (tid == 0) lap(&laps, C_RATIO);
    gb.sync();
    if (tid == 0) lap(&laps, C_B);

    // ---- 3. combine the ratio tests; the pivot row; the updates ----
    combine_b(p.mail, L.hdr, !use_bland, &comb.b);
    const bool has_ratio = comb.b.a != BIG_I;
    const bool min_nan = is_nan(comb.b.m);
    const bool by_tie = use_bland || p.max_piv;
    // torch's argmin / argmax give row 0 where the minimum is NaN
    const int r_price = min_nan ? 0 : by_tie ? comb.b.pi : comb.b.qi;
    const bool do_cleanup = cleanup && has_elig;
    const bool do_pricing = pricing_pivot && has_ratio;
    const bool act = (do_cleanup || do_pricing) && niter < p.max_iters;
    const int r = do_cleanup ? r_d : r_price;
    const int rg = r + 2, leaving = L.basis[r];
    const bool unbounded = pricing_pivot && !has_ratio && phase == 2;
    const bool failed1 = pricing_pivot && !has_ratio && phase != 2;
    // T0's entry of the thread's first column of row r + 2 (the last
    // thread: column N - 1), loaded while U's column arrives
    const T* trow = tab + (long long)rg * N;
    const T t0_own3 = tid < wk ? trow[k0 + tid] : T(0);
    const T t0_last = tid == THREADS - 1 ? trow[N - 1] : T(0);
    // U[0..t, r + 2]: the clean-up row's in hand, else from the mailbox of
    // the block whose candidate won (row 2's owner's second vector for a
    // NaN minimum); the pivot from the tail of the row's owner: the
    // clean-up row's, row 2's, or the winning candidate's
    const T* us = (const T*)cols_b(p.mail, rg / H, K, es);
    const T* uc = L.ucl;
    if (!do_cleanup) {
      for (int k = tid; k <= t; k += THREADS)
        L.ucol[k] = __ldcg(us + (min_nan ? vstride : 0) + k);
      uc = L.ucol;
    }
    if (tid == THREADS - 3) comb.piv = __ldcg(us + 2 * vstride + (do_cleanup ? 2 : min_nan ? 1 : 0));
    __syncthreads();
    const T piv = comb.piv;
    if (tid == 0) lap(&laps, C_COMBINE_B);
    const T actf = act ? T(1) : T(0);
    const T spiv = act ? piv : T(1);
    const bool upd = devex && act && do_pricing;
    // w[0] and w[1] (row0's and row1's factors), in every block in the same
    // order
    const T w0 = w_of(comb.colj0, false, spiv, actf), w1 = w_of(comb.colj1, false, spiv, actf);
    // v: the weights' NaN-first maximum; s: the post-step |bvec[2:]| sum;
    // a: the first row whose basic column is artificial after the step
    Red<T> x = red_identity<T>(true);
    {
      const T qv = div_rn(gq, mul_rn(spiv, spiv));
      const T leave = is_nan(qv) ? qv : (qv < T(1) ? T(1) : qv);
      for (int kk = tid; kk < wk; kk += THREADS) {
        const int k = k0 + kk;
        const T v = mul_rn(add_rn(kk == tid ? t0_own3 : trow[k], eta_dot(uc, L.V + kk, W, t)),
                           actf);
        if (keep) L.V[(long long)t * W + kk] = v;
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
      if (tid == THREADS - 1) comb.vlast = mul_rn(add_rn(t0_last, eta_dot(uc, L.vlst, 1, t)), actf);
      __syncthreads();
      const T vlast = comb.vlast;
      for (int ii = tid; ii < hi; ii += THREADS) {
        const int i = i0 + ii;
        const T w = w_of(L.colj[ii], i == rg, spiv, actf);
        const T b = fma(w, vlast, L.bvec[ii]);
        L.bvec[ii] = b;
        if (keep) L.U[(long long)t * H + ii] = w;
        if (i >= 2) x.s = add_rn(x.s, T(fabs(b)));
      }
      // the next slot's clean-up scan over the replicated basis: the first
      // row whose basic column is artificial after the pivot (basis[r] = j)
      // and the retire (art[basis[r_d]] = 0), which the finish applies
      const int retired = retire ? L.basis[r_d] : -1;
      for (int i = tid; i < m; i += THREADS) {
        const int b = act && i == r ? j : L.basis[i];
        if (art_of(L.artb, b) && b != retired) x.a = min(x.a, i);
      }
    }
    z0 = fma(w0, comb.vlast, z0);
    z1 = fma(w1, comb.vlast, z1);
    if (tid == 0) lap(&laps, C_ROW);
    x = key_reduce(x, true, kr[2]);
    if (tid == 0) lap(&laps, C_REDUCE);

    // ---- the finish, in every block alike (but the |bvec[2:]| sum's
    // NUMERIC and the reset on the grid's largest weight: the next
    // combine's) ----
    if (tid == 0) {
      // the pivot, the retire (it pivots nowhere: the basis is the
      // pre-step one), the eta slot's replicated entries
      if (act) L.basis[r] = j;
      if (retire) {
        const int b = L.basis[r_d];
        L.artb[b >> 5] &= ~(1u << (b & 31));
      }
      if (keep) {
        L.u0[t] = w0;
        L.u1[t] = w1;
        L.vlst[t] = comb.vlast;
      }
    }
    __syncthreads();
    if (devex && to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
    if (to_phase2)
      for (int kk = tid; kk < wk; kk += THREADS)
        L.act[kk] = L.act[kk] && !art_of(L.artb, k0 + kk);
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
    const bool finite_ok = finite_val(z) && crow_ok;
    status = !finite_ok ? ST_NUMERIC
             : (infeasible1 || failed1) ? ST_INFEASIBLE
             : unbounded ? ST_UNBOUNDED
             : finished_opt ? ST_OPTIMAL
                            : ST_RUNNING;
    niter += act;
    slot += act;
    ar = x.a;
    gmax_own = x.v;
    bsum_own = x.s;
    pending = true;
    __syncthreads();
    if (tid == 0) lap(&laps, C_FINISH);
  }

  // ---- the last slot's sums: its NUMERIC and the reset on its largest
  // weight ----
  if (pending) {
    if (tid == 32) {
      MailA2<T>* mb = (MailA2<T>*)(head_a(p.mail, g) + HEAD_A2);
      mb->v2 = -inf;
      mb->i2 = BIG_I;
      mb->gmax = gmax_own;
      mb->bsum = bsum_own;
    }
    gb.sync();
    combine_a(p.mail, L.hdr, devex, false, &comb.a1, &comb.a2);
    if (!finite_val(comb.a2.bsum)) status = ST_NUMERIC;
    if (devex && comb.a2.gmax > p.reset_above)
      for (int kk = tid; kk < wk; kk += THREADS) L.gamma[kk] = T(1);
    __syncthreads();
    if (tid == 0) lap(&laps, C_FINAL);
  }

  // ---- write back: the factors' slabs, the running vectors, the masks'
  // and weights' shares, the basis and the scalars ----
  for (int e = tid; e < K * wk; e += THREADS) {
    const int k = e / wk, kk = e - k * wk;
    p.V[(long long)k * N + k0 + kk] = L.V[(long long)k * W + kk];
  }
  for (int e = tid; e < K * hi; e += THREADS) {
    const int k = e / hi, ii = e - k * hi;
    p.U[(long long)k * M + i0 + ii] = L.U[(long long)k * H + ii];
  }
  for (int kk = tid; kk < wk; kk += THREADS) {
    const int k = k0 + kk;
    p.row0[k] = L.row0[kk];
    p.row1[k] = L.row1[kk];
    if (k >= n) continue;
    p.gamma[k] = L.gamma[kk];
    p.act[k] = L.act[kk];
    p.art[k] = art_of(L.artb, k);
  }
  for (int ii = tid; ii < hi; ii += THREADS) p.bvec[i0 + ii] = L.bvec[ii];
  if (g == 0) {
    for (int i = tid; i < m; i += THREADS) p.basis[i] = L.basis[i];
    if (tid == 0) {
      p.rec[PHASE] = phase;
      p.rec[STATUS] = status;
      p.rec[NITER] = niter;
      p.rec[STUCK] = stuck;
      p.rec[BLAND] = bland;
      p.rec[SLOT] = slot;
      p.rec[ART_ROW] = ar;
      p.vals[LAST_Z] = last_z;
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
  p.mail = (unsigned char*)a[A_MAIL];
  p.bar = (unsigned*)a[A_BAR];
  p.cycles = (long long*)a[A_CYCLES];
  p.M = in[I_M];
  p.N = in[I_N];
  p.K = in[I_K];
  p.W = in[I_WIDTH];
  p.H = in[I_HEIGHT];
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

// The plan's figures against this layout: G blocks of THREADS threads, W =
// ceil(N / G) columns and H = ceil(M / G) rows a block, K eta slots, the
// bytes smem_bytes and mail_bytes count.
template <typename T>
bool plan_ok(const int* in) {
  const int M = in[I_M], N = in[I_N], K = in[I_K], G = in[I_BLOCKS];
  if (M < 3 || N < 2 || K < 1 || K > MAX_K || G < 1 || in[I_THREADS] != THREADS) return false;
  const int W = (N + G - 1) / G, H = (M + G - 1) / G;
  if (in[I_WIDTH] != W || in[I_HEIGHT] != H) return false;
  return (long long)in[I_SMEM] == smem_bytes<T>(M, N, K, W, H, G) &&
         (long long)in[I_MAIL] == mail_bytes(G, K, sizeof(T));
}

template <typename T>
bool pointers_ok(const Params<T>& p) {
  return p.tab && p.U && p.V && p.row0 && p.row1 && p.bvec && p.gamma && p.basis && p.act &&
         p.art && p.rec && p.vals && p.mail && p.bar;
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the instantiation at
// smem bytes of dynamic shared memory, after raising its limit to them
template <typename T>
int occupancy_of(int smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute((const void*)blocked_grid_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, blocked_grid_kernel<T>,
                                                            THREADS, (size_t)smem);
}

// one cooperative launch of a block's K slots, the barrier's counter zeroed
// on the stream before it
template <typename T>
int blocked_grid(const long long* a, const int* in, const double* tol, void* stream) {
  if (!plan_ok<T>(in)) return (int)cudaErrorInvalidValue;
  const Params<T> p = make_params<T>(a, in, tol);
  if (!pointers_ok(p)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int G = in[I_BLOCKS], smem = in[I_SMEM];
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int err = occupancy_of<T>(smem, &occ);
  if (err) return err;
  if (occ < 1 || G > occ * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaMemsetAsync(p.bar, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  Params<T> q = p;
  void* args[] = {&q};
  e = cudaLaunchCooperativeKernel((const void*)blocked_grid_kernel<T>, dim3(G), dim3(THREADS),
                                  args, (size_t)smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int blocked_grid_occupancy(const int* in, int* blocks) {
  if (!plan_ok<T>(in) || !blocks) return (int)cudaErrorInvalidValue;
  return occupancy_of<T>(in[I_SMEM], blocks);
}

}  // namespace bgd
}  // namespace tpulp

extern "C" int tpulp_blocked_grid_f32(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::bgd::blocked_grid<float>(a, in, tol, stream);
}
extern "C" int tpulp_blocked_grid_f64(const long long* a, const int* in, const double* tol,
                                      void* stream) {
  return tpulp::bgd::blocked_grid<double>(a, in, tol, stream);
}
// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the plan's launch: the
// blocks an SM holds at once (the grid must fit that times the SMs)
extern "C" int tpulp_blocked_grid_occupancy_f32(const int* in, int* blocks) {
  return tpulp::bgd::blocked_grid_occupancy<float>(in, blocks);
}
extern "C" int tpulp_blocked_grid_occupancy_f64(const int* in, int* blocks) {
  return tpulp::bgd::blocked_grid_occupancy<double>(in, blocks);
}
