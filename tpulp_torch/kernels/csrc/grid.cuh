// The machinery of the persistent cooperative walks (bounded_grid.cu,
// rank1_grid.cu): G blocks of THREADS threads, one an SM, each owning a
// column slab of the tableau, that meet at common.cuh's flag barrier twice
// a step. Shared here: the mailboxes in device memory (a slot a block and
// region, read through L2) and their combine in block order; the block
// reductions by order-preserving keys (common.cuh's okey and warp_arg);
// the slab's accessor (rows [0, R) in shared memory, rows [R, M) in the
// block's tiles in device memory); the bulk async copies, mbarriers and
// proxy fences of the streamed rows' tile ring; block 0's stage clock; the
// combine of the ratio test split over the blocks' rows (the plans whose
// per-row vectors live in device memory); the wide plan's slab in chunks
// and its walk over the chunks' tiles.
#pragma once

#include "common.cuh"

namespace tpulp {
namespace grid {


constexpr int THREADS = 512;  // a block
constexpr int WARPS = THREADS / 32;
constexpr int SLOT = 64;  // bytes of a mailbox slot
constexpr int MAX_STAGES = 8;  // the tile ring's slots, at most
// SM cycles a thread waits on a tile before it gives the launch up
// (__trap: an error the wrapper raises, not a hang): ~9 s at 1.98 GHz
constexpr long long TILE_TIMEOUT = 1LL << 34;

// a mailbox's flags: row 2 has an entry that is not finite; column basis[0]
// is not the unit vector on row 2; a basic column is not a unit vector
enum Flag { F_ROW2_BAD = 1, F_UNIT0_BAD = 2, F_UNITS_BAD = 4 };
// the mailbox regions, in slots: A (a step's candidates), R (the
// repricing after a devex reset), F (the final weights' maxima), then the
// verdict
enum Region { R_A, R_R, R_F, R_NREGIONS };

__host__ __device__ __forceinline__ long long align16(long long x) { return (x + 15) / 16 * 16; }

__host__ __device__ __forceinline__ long long mail_bytes(int G) {
  return (long long)SLOT * (R_NREGIONS * (long long)G + 1);
}

// A block's mailbox: its candidate of the step's column reduction (v, i,
// a, b, s), the largest of its devex weights (NaN first) and its flags.
template <typename T>
struct alignas(16) Mail {
  T v, s, gmax;
  int i, a, b, flags;
};

// The owner of j's verdict: the step's row r (the ratio test's leaving
// row, or the clean-up's), whether the ratio test found a row, the
// bounded step's kinds (0 on the rank-1 walks), the entry of column j on
// row r + 2 and the entering column's devex weight.
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
__device__ __forceinline__ Mail<T>* mail_slot(unsigned char* mail, int region, int g) {
  return (Mail<T>*)(mail + (long long)SLOT * ((long long)region * gridDim.x + g));
}

template <typename T>
__device__ __forceinline__ Verdict<T>* verdict_slot(unsigned char* mail) {
  return (Verdict<T>*)(mail + (long long)SLOT * R_NREGIONS * gridDim.x);
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
// the shuffle tree: the pick (v, i) (an argmax where MX; offer's order is
// total: the sequential argmin exactly), the first indices, the |c| sums
// (in kernels/sums.py::grid_sum's order), the largest weight (NaN
// first) and the flags. Called by every thread; the result is in out,
// gmax, flags after its barrier.
template <typename T>
__device__ void combine_mail(unsigned char* mail, int region, bool MX, Red<T>* out, T* gmax,
                             int* flags) {
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
        if (q < G) mb[u] = load_cg(mail_slot<T>(mail, region, q));
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

// every bulk store of this thread but the last has read its shared memory
__device__ __forceinline__ void stores_read_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
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

// Block 0's clock, split by the kernel's NS stages when the caller asks for
// it: thread 0 of block 0 adds the cycles since its last lap to the stage.
template <int NS>
struct Laps {
  bool on;
  long long last;
  long long cyc[NS];
};

template <int NS>
__device__ __forceinline__ void lap(Laps<NS>* t, int stage) {
  if (!t->on) return;
  const long long now = clock64();
  t->cyc[stage] += now - t->last;
  t->last = now;
}

// A step's verdict on the plans whose per-row vectors live in device
// memory (the device-vector and wide plans), the same in every block: the
// ratio test's row and kinds (from the combines; the kinds and the span
// ulv bounded_grid's only), column j's entry on row r + 2, the entering
// column's devex weight (from its owner's mailbox), and the pre-step
// basis[r], its span, b[r + 2] and basis[r_d]; whether column j has an
// entry that is not finite.
template <typename T>
struct DvVerdict {
  T piv, gq, brow, ulv;
  int r, leaving, bd, has_ratio, kind_up, kind_flip, colj_bad;
};

// Two NaN-first argmin picks over the G mailboxes of a region (the ratio
// test split over the blocks' rows: each block's two candidates in v, i
// and s, a), combined as
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


// ---- the wide plan: no row of a slab in shared memory ----

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
  // the bytes of row tile t of chunk c (TR rows; fewer in the last)
  __device__ __forceinline__ unsigned tile_bytes(int c, int t, int TR) const {
    return (unsigned)(min(TR, M - t * TR) * wp(c) * (int)sizeof(T));
  }
};

// Block q's slab on the wide plan of an (M, N) frame in slabs of W
// columns.
template <typename T>
__device__ __forceinline__ WideSlab<T> wide_slab(T* scratch, int M, int N, int W, int q) {
  const long long region = (long long)M * ((W + WCH - 1) / WCH) * WCH;
  const int k0 = q * W;
  return WideSlab<T>{scratch + q * region, M, min(N - 1, k0 + W) - k0};
}

// Tile s of a step's walk over a block's ns tiles (chunks of nt row
// tiles), chunk-major: (chunk c, row tile t); the reverse order where not
// forward.
__device__ __forceinline__ void wide_tile(int s, bool forward, int nt, int ns, int& c, int& t) {
  const int q = forward ? s : ns - 1 - s;
  c = q / nt;
  t = q - c * nt;
}

// The slab into its chunks from the frame T_in (N columns, the block's
// from k0): thread t takes column t of each chunk, four rows at a time,
// their loads issued first. Generic writes that the bulk loads read: the
// caller's proxy fence and barriers follow.
template <typename T>
__device__ void wide_load(const WideSlab<T>& slab, const T* T_in, int N, int k0) {
  for (int c = 0; c < slab.nc(); ++c) {
    if ((int)threadIdx.x >= slab.wc(c)) continue;
    const T* src = T_in + k0 + c * WCH + threadIdx.x;
    for (int i0 = 0; i0 < slab.M; i0 += 4) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < slab.M) v[u] = src[(long long)(i0 + u) * N];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < slab.M) slab.row(c, i0 + u)[threadIdx.x] = v[u];
    }
  }
}

// The slab's chunks written back into the frame T_out (read through L2,
// after the last stores have completed).
template <typename T>
__device__ void wide_store(const WideSlab<T>& slab, T* T_out, int N, int k0) {
  for (int c = 0; c < slab.nc(); ++c) {
    if ((int)threadIdx.x >= slab.wc(c)) continue;
    T* dst = T_out + k0 + c * WCH + threadIdx.x;
    for (int i0 = 0; i0 < slab.M; i0 += 4) {
      T v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < slab.M) v[u] = __ldcg(slab.row(c, i0 + u) + threadIdx.x);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u < slab.M) dst[(long long)(i0 + u) * N] = v[u];
    }
  }
}

// Thread 0, at a step's start: the previous step's stores complete (their
// rows are read generically from here on), then the first min(S, ns)
// tiles of the step's walk (wide_tile's order, nt row tiles of TR rows a
// chunk) asked for into the ring's slots from ``slot``.
template <typename T>
__device__ void wide_first_tiles(const WideSlab<T>& slab, T* ring, long long tse,
                                 unsigned long long* mbar, int S, int TR, int nt, int ns,
                                 int slot, bool forward) {
  stores_done();
  fence_async_global();
  const int nload = min(S, ns);
  for (int t = 0; t < nload; ++t) {
    const int q = slot + t < S ? slot + t : slot + t - S;
    int c, ti;
    wide_tile(t, forward, nt, ns, c, ti);
    tile_load(ring + q * tse, slab.row(c, ti * TR), slab.tile_bytes(c, ti, TR), mbar + q);
  }
}

// A step's walk over the block's ns tiles through the ring of S slots,
// chunk by chunk (wide_tile's order). Where the step pivots (``pv``): at
// each chunk's first tile ``chunk(c, s)`` (s the tile's place in the
// walk: the caller's pivot row entry and weights of the chunk), then
// thread t sets column t of the tile, every row i, to ``entry(i, kk, cj,
// v)`` from its pre-step value v (kk its column in the slab, cj column j's
// entry on row i: the staged one where ``cj_sh``, else e_2's); column j's
// entries of the next tile's rows (from ``cjd`` through L2) are asked for
// before this tile's wait and staged after its update (cjs: two tiles'
// rows, the first staged by the caller); the tile is stored, and the
// previous tile's slot is reloaded with the tile S - 1 places on once its
// store has read it (this tile's store is not waited for). Where the step
// pivots nowhere, the first tiles' loads are drained. ``slot`` and
// ``parity`` carry the ring's state across the steps.
template <typename T, typename Chunk, typename Entry>
__device__ void wide_stream(const WideSlab<T>& slab, T* ring, T* cjs, unsigned long long* mbar,
                            int S, int TR, long long tse, int nt, int ns, bool pv, bool cj_sh,
                            const T* cjd, bool forward, int& slot, unsigned& parity, Chunk chunk,
                            Entry entry) {
  const int tid = threadIdx.x, M = slab.M;
  const int nwait = pv ? ns : min(S, ns);
  int c_cur = -1;
  for (int s = 0; s < nwait; ++s) {
    int c, t;
    wide_tile(s, forward, nt, ns, c, t);
    const int w = slab.wc(c);
    if (pv && c != c_cur) {
      c_cur = c;
      chunk(c, s);
    }
    const bool stage = pv && cj_sh && tid < TR && s + 1 < ns;
    T cj_next = T(0);
    if (stage) {
      int c2, t2;
      wide_tile(s + 1, forward, nt, ns, c2, t2);
      const int in = t2 * TR + tid;
      if (in < M) cj_next = __ldcg(cjd + in);
    }
    const int q = slot;
    mbar_wait(mbar + q, (parity >> q) & 1u);
    parity ^= 1u << q;
    slot = q + 1 == S ? 0 : q + 1;
    if (!pv) continue;  // the first tiles drained: nothing to update
    T* const tile = ring + q * tse;
    if (tid < w) {
      const int kk = c * WCH + tid, wp = slab.wp(c), rows = min(TR, M - t * TR);
      for (int ii = 0; ii < rows; ++ii) {
        const int i = t * TR + ii;
        const T cj = cj_sh ? cjs[(s & 1) * TR + ii] : T(i == 2);
        T* e = tile + ii * wp + tid;
        *e = entry(i, kk, cj, *e);
      }
    }
    if (stage) cjs[((s + 1) & 1) * TR + tid] = cj_next;
    // the tile's generic writes before the bulk store reads it
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
      tile_store(slab.row(c, t * TR), tile, slab.tile_bytes(c, t, TR));
      if (s >= 1 && s - 1 + S < ns) {
        const int qp = q == 0 ? S - 1 : q - 1;
        int c2, t2;
        wide_tile(s - 1 + S, forward, nt, ns, c2, t2);
        stores_read_but_one();
        tile_load(ring + qp * tse, slab.row(c2, t2 * TR), slab.tile_bytes(c2, t2, TR),
                  mbar + qp);
      }
    }
  }
}


}  // namespace grid
}  // namespace tpulp
