// The machinery of the persistent cooperative walks (bounded_grid.cu,
// rank1_grid.cu): G blocks of THREADS threads, one an SM, each owning a
// column slab of the tableau, that meet at common.cuh's flag barrier twice
// a step. Shared here: the mailboxes in device memory (a slot a block and
// region, read through L2) and their combine in block order; the block
// reductions by order-preserving keys (common.cuh's okey and warp_arg);
// the slab's accessor (rows [0, R) in shared memory, rows [R, M) in the
// block's tiles in device memory); the bulk async copies, mbarriers and
// proxy fences of the streamed rows' tile ring; and block 0's stage clock.
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

}  // namespace grid
}  // namespace tpulp
