// flush_kernel: the once-per-block rank-K flush of the kernel engine.
//
// Replaces tpulp/kernels/pallas_block.py::fused_flush (the TPU kernel body
// is _make_flush_kernel): Tn = T + U^T V written in place over T, plus the
// (2, N) int32 ray-scan columns: row 0 is ``ca[j] and Tn[0, j] < -opt_tol``,
// row 1 is ``some i >= 2 has Tn[i, j] > piv_tol``.
//
// What bounds it on the H100: 2*M*N*K flops (17.2 GFLOP at the 4098 x 8193
// x K=256 bench shape) against one read and one write of T (269 MB at f32,
// 537 MB at f64). The TPU kept a full-precision matmul (Precision.HIGHEST),
// and lower-precision flushes broke walks within 200 pivots, so the f32
// kernel uses no TF32 and no 3xTF32 split (wgmma has no full-FP32 mode):
// it runs on the FP32 FMA pipes (~67 TFLOP/s, a floor of ~0.26 ms), and
// what bounds it is feeding them: an 8 x 8 micro-tile gets 4 FMAs per
// shared-memory wavefront, just the SM's ratio of FMA issue (4 warps per
// clock) to shared-memory wavefronts (1 per clock). At f64 the FP64 tensor
// cores (DMMA, ~67 TFLOP/s) take full IEEE doubles; their floor is ~0.26
// ms, and the T traffic alone (~0.16 ms) is ~60% of it, so the epilogue
// has to overlap other tiles' main loops.
//
// Design, both dtypes: each block owns one output tile and a ring of
// cp.async stages of the U and V k-chunks in dynamic shared memory; one
// __syncthreads per chunk, the next chunks in flight while this one
// computes. Nothing is padded (M = m + 2 and N = n + m + 1 are arbitrary,
// so rows of U, V and T are only 4- or 8-byte aligned): the copies move one
// element each, with the src-size operand zeroing masked k-rows and i/j
// columns. Masked i/j never reach T or the scan; masked k-rows add 0 * 0.
// * f32: 128 x 128 tiles, 256 threads, an 8 x 8 micro-tile per thread
//   arranged so that its A and B fragments are 16-byte shared loads: 16
//   FMAs per load instruction (the earlier 64 x 64 kernel did 2, and was
//   bound by shared-memory issue at 19 TFLOP/s). Fragments are double-
//   buffered in registers; <= 128 registers, so two blocks share an SM.
// * f64: mma.sync m16n8k8 f64 (DMMA), 64 x 64 tiles, four warps of 32 x
//   32; 8-byte shared rows padded to a stride of 4 mod 16 doubles, so every
//   fragment load is free of bank conflicts (there is no 8-byte ldmatrix).
//   <= 128 registers, so four blocks share an SM and the epilogues of some
//   overlap the main loops of the others. (64 x 128 tiles, two blocks per
//   SM, measured 3-15% slower at the bench and the main path's shapes.)
// Each element's product is summed over k in a fixed order (FMA chain at
// f32, DMMA at f64) and added to T with one rounding (add_rn), as before.
//
// Epilogue: each warp stages its accumulators through shared memory and
// then takes one column per lane: all of the warp's rows of T are loaded
// at once (one memory latency per tile, not one per row), added and
// stored, coalesced across the warp, each tile touching only its own
// elements (the in-place aliasing is safe). The scan of a column is then a
// per-lane OR: row 0 is written by the one lane that holds it, row 1 is
// ORed with one atomicOr per lane and warp. The result does not depend on
// the order.
//
// The TPU kernel also wrote Tt = Tn^T, because Mosaic could only DMA
// 8-row windows and needed the entering column as a row of Tt. The
// Hopper inner-block kernel reads column j of the row-major T directly,
// so Tt is gone: one M x N array less and half of the flush's writes.
// Tt was the bit-exact transpose, so the walk is the same without it.
//
// The lane axis (the blocked batch, kernels/blocked_cluster.py): the
// instantiation LANES = true flushes B lanes of a batched record in one
// launch, blockIdx.z = lane, each lane's T, U, V, ca and scan at the lane
// times its extent (M N, K M, K N, N, 2 N). A lane whose ``live`` flag is 0
// (the block's cluster launch found it frozen) is skipped whole, its tiles
// returning at once: even a flush of zero factors would turn a -0.0 of its
// T into +0.0. The tile code is the solo one's, so a lane's flush equals
// the solo flush of that lane bit for bit; the solo instantiation (LANES =
// false) has no lane arithmetic at all.

#include "common.cuh"

namespace tpulp {
namespace {

// One element (4 or 8 bytes) global -> shared, asynchronously; a masked
// element reads nothing and lands as zero.
template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Tile configuration. WM x WN is one warp's tile; the epilogue gives each
// lane one of a warp's WN = 32 columns.
template <typename T>
struct FlushCfg;

template <>
struct FlushCfg<float> {
  static constexpr int BM = 128, BN = 128, BK = 16, STAGES = 4;
  static constexpr int WARPS_M = 2, WARPS_N = 4, MIN_BLOCKS = 2;
  static constexpr int LDA = BM, LDB = BN;  // 16-byte fragment loads
  static constexpr int LDC = 36;            // 4 mod 8: float4 staging stores
};

template <>
struct FlushCfg<double> {
  static constexpr int BM = 64, BN = 64, BK = 16, STAGES = 3;
  static constexpr int WARPS_M = 2, WARPS_N = 2, MIN_BLOCKS = 4;
  static constexpr int LDA = BM + 4, LDB = BN + 4;  // 4 mod 16: 8-byte loads
  static constexpr int LDC = 40;                    // 8 mod 16: double2 stores
};

template <typename T>
struct Tile : FlushCfg<T> {
  using C = FlushCfg<T>;
  static constexpr int THREADS = 32 * C::WARPS_M * C::WARPS_N;
  static constexpr int WM = C::BM / C::WARPS_M;
  static constexpr int WN = C::BN / C::WARPS_N;
  static constexpr size_t RING =
      size_t(C::STAGES) * C::BK * (C::LDA + C::LDB) * sizeof(T);
  static constexpr size_t STAGING =
      size_t(C::WARPS_M * C::WARPS_N) * WM * C::LDC * sizeof(T);
  static constexpr size_t SMEM = RING > STAGING ? RING : STAGING;
  static_assert(WN == 32, "the epilogue maps lanes to a warp's columns");
  static_assert(THREADS % C::BM == 0 && THREADS % C::BN == 0, "loader");
  static_assert(C::BK % (THREADS / C::BM) == 0 &&
                    C::BK % (THREADS / C::BN) == 0, "loader");
};

// Issue the copies of k-chunk ``k0`` into one stage of the ring: As[k][i]
// from U (K, M) and Bs[k][j] from V (K, N), both k-major, so a warp copies
// 32 consecutive elements of one row.
template <typename T>
__device__ __forceinline__ void load_chunk(T* As, T* Bs, const T* U,
                                           const T* V, int M, int N, int K,
                                           int i0, int j0, int k0) {
  using G = Tile<T>;
  constexpr int A_STEP = G::THREADS / G::BM, B_STEP = G::THREADS / G::BN;
  {
    const int ii = threadIdx.x % G::BM, k1 = threadIdx.x / G::BM;
    const bool iv = i0 + ii < M;
#pragma unroll
    for (int p = 0; p < G::BK / A_STEP; ++p) {
      const int kk = k1 + p * A_STEP;
      const bool v = iv && k0 + kk < K;
      const T* src = v ? U + (size_t)(k0 + kk) * M + (i0 + ii) : U;
      cp_async_elem<sizeof(T)>(As + kk * G::LDA + ii, src, v);
    }
  }
  {
    const int jj = threadIdx.x % G::BN, k1 = threadIdx.x / G::BN;
    const bool jv = j0 + jj < N;
#pragma unroll
    for (int p = 0; p < G::BK / B_STEP; ++p) {
      const int kk = k1 + p * B_STEP;
      const bool v = jv && k0 + kk < K;
      const T* src = v ? V + (size_t)(k0 + kk) * N + (j0 + jj) : V;
      cp_async_elem<sizeof(T)>(Bs + kk * G::LDB + jj, src, v);
    }
  }
}

// f32: each thread holds an 8 x 8 micro-tile of its warp's 64 x 32 tile:
// rows {0, 32} + 4 * (lane / 4) + 0..3, columns {0, 16} + 4 * (lane % 4) +
// 0..3. A quarter-warp reads 2 distinct A float4s (broadcast) and 4
// distinct B float4s: one shared-memory wavefront each. (An 8 x 16
// micro-tile, 6 loads per 128 FMAs, needs more than 255 registers and
// spills: measured 20% slower.)
struct MathF32 {
  using G = Tile<float>;
  static_assert(G::WM == 64 && G::WN == 32, "the f32 warp tile");
  float acc[8][8];
  int a_off, b_off, lr, lc;

  __device__ __forceinline__ void init(int wr, int wc, int lane) {
    lr = lane >> 2;
    lc = lane & 3;
    a_off = wr * G::WM + lr * 4;
    b_off = wc * G::WN + lc * 4;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  }

  __device__ __forceinline__ void frag(const float* As, const float* Bs,
                                       int kk, float* a, float* b) const {
    const float* Ak = As + kk * G::LDA + a_off;
    const float* Bk = Bs + kk * G::LDB + b_off;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 va = *reinterpret_cast<const float4*>(Ak + 32 * h);
      const float4 vb = *reinterpret_cast<const float4*>(Bk + 16 * h);
      a[4 * h] = va.x; a[4 * h + 1] = va.y; a[4 * h + 2] = va.z; a[4 * h + 3] = va.w;
      b[4 * h] = vb.x; b[4 * h + 1] = vb.y; b[4 * h + 2] = vb.z; b[4 * h + 3] = vb.w;
    }
  }

  __device__ __forceinline__ void compute(const float* As, const float* Bs) {
    float a[2][8], b[2][8];
    frag(As, Bs, 0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < G::BK; ++kk) {
      if (kk + 1 < G::BK) frag(As, Bs, kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[r][c] = fmaf(a[kk & 1][r], b[kk & 1][c], acc[r][c]);
    }
  }

  // The warp's 64 x 32 tile into Cw[64][LDC]; with LDC = 4 mod 8, a
  // quarter-warp's float4 stores cover all 32 banks once.
  __device__ __forceinline__ void stage(float* Cw) const {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = (r >> 2) * 32 + lr * 4 + (r & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(Cw + row * G::LDC + h * 16 + lc * 4) =
            make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                        acc[r][4 * h + 3]);
    }
  }
};

// D = A B + D on the FP64 tensor cores. Fragments (g = lane / 4, t = lane
// % 4): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g],
// B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void dmma_16x8x8(double* d, const double* a,
                                            const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// f64: each warp holds its 64 x 32 tile as 4 x 4 m16n8 accumulators.
struct MathF64 {
  using G = Tile<double>;
  static constexpr int MT = G::WM / 16, NT = G::WN / 8;
  double acc[MT][NT][4];
  int g, t, m_off, n_off;

  __device__ __forceinline__ void init(int wr, int wc, int lane) {
    g = lane >> 2;
    t = lane & 3;
    m_off = wr * G::WM + g;
    n_off = wc * G::WN + g;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.0;
  }

  __device__ __forceinline__ void compute(const double* As, const double* Bs) {
#pragma unroll
    for (int ks = 0; ks < G::BK; ks += 8) {
      const double* Ak = As + (ks + t) * G::LDA + m_off;
      const double* Bk = Bs + (ks + t) * G::LDB + n_off;
      double a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = Ak[mt * 16];
        a[mt][1] = Ak[mt * 16 + 8];
        a[mt][2] = Ak[4 * G::LDA + mt * 16];
        a[mt][3] = Ak[4 * G::LDA + mt * 16 + 8];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = Bk[nt * 8];
        b[nt][1] = Bk[4 * G::LDB + nt * 8];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) dmma_16x8x8(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // The warp's tile into Cw[WM][LDC]; a quarter-warp's double2 stores
  // cover all 32 banks once.
  __device__ __forceinline__ void stage(double* Cw) const {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        double* p = Cw + (mt * 16 + g) * G::LDC + nt * 8 + 2 * t;
        *reinterpret_cast<double2*>(p) =
            make_double2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<double2*>(p + 8 * G::LDC) =
            make_double2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
};

template <typename T> struct Math;
template <> struct Math<float> { using type = MathF32; };
template <> struct Math<double> { using type = MathF64; };

template <typename T, bool LANES>
__global__ void __launch_bounds__(Tile<T>::THREADS, Tile<T>::MIN_BLOCKS)
flush_kernel(T* __restrict__ Tab, const T* __restrict__ U,
             const T* __restrict__ V, const int* __restrict__ ca,
             int* __restrict__ scan, int M, int N, int K, T opt_tol,
             T piv_tol, const int* __restrict__ live, long long live_stride) {
  using G = Tile<T>;
  if (LANES) {
    const long long z = blockIdx.z;
    if (!live[z * live_stride]) return;
    Tab += z * M * N;
    U += z * K * M;
    V += z * K * N;
    ca += z * N;
    scan += z * 2 * N;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* As = smem;                                   // [STAGES][BK][LDA]
  T* Bs = smem + G::STAGES * G::BK * G::LDA;      // [STAGES][BK][LDB]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp / G::WARPS_N, wc = warp % G::WARPS_N;
  const int i0 = blockIdx.y * G::BM, j0 = blockIdx.x * G::BN;

  typename Math<T>::type math;
  math.init(wr, wc, lane);

  // the ring: STAGES - 1 chunks ahead; one group committed per step (empty
  // past the end) keeps wait_group's count exact
  const int nk = (K + G::BK - 1) / G::BK;
#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nk)
      load_chunk<T>(As + s * G::BK * G::LDA, Bs + s * G::BK * G::LDB, U, V,
                    M, N, K, i0, j0, s * G::BK);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<G::STAGES - 2>();
    // chunk kc has landed for every thread, and every thread is done with
    // chunk kc - 1, whose stage the next copy overwrites
    __syncthreads();
    const int nx = kc + G::STAGES - 1;
    if (nx < nk) {
      const int s = nx % G::STAGES;
      load_chunk<T>(As + s * G::BK * G::LDA, Bs + s * G::BK * G::LDB, U, V,
                    M, N, K, i0, j0, nx * G::BK);
    }
    cp_async_commit();
    const int s = kc % G::STAGES;
    math.compute(As + s * G::BK * G::LDA, Bs + s * G::BK * G::LDB);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is reused as the staging area

  T* Cw = smem + warp * G::WM * G::LDC;
  math.stage(Cw);
  __syncwarp();

  // the warp's rows of column j: every load in flight at once (the
  // accumulators are dead, their registers hold T), then add and store
  const int j = j0 + wc * G::WN + lane;
  const int ib = i0 + wr * G::WM;
  if (j >= N) return;
  const int rows = M - ib;
  T tv[G::WM];
#pragma unroll
  for (int rr = 0; rr < G::WM; ++rr)
    if (rr < rows) tv[rr] = Tab[(size_t)(ib + rr) * N + j];
  int flag = 0;
#pragma unroll
  for (int rr = 0; rr < G::WM; ++rr) {
    if (rr >= rows) break;
    const int i = ib + rr;
    const T tn = add_rn(tv[rr], Cw[rr * G::LDC + lane]);
    Tab[(size_t)i * N + j] = tn;
    if (i == 0) scan[j] = (ca[j] > 0 && tn < -opt_tol) ? 1 : 0;
    if (i >= 2 && tn > piv_tol) flag = 1;
  }
  if (flag) atomicOr(&scan[N + j], 1);
}

constexpr int kMaxDevices = 64;

// lanes > 0: a batched record of that many lanes with their live flags at
// live[lane * live_stride]; 0: the solo flush
template <typename T>
int launch_flush(void* Tab, const void* U, const void* V, const void* ca,
                 void* scan, int M, int N, int K, double opt_tol,
                 double piv_tol, void* stream, int lanes = 0,
                 const void* live = nullptr, long long live_stride = 0) {
  using G = Tile<T>;
  if (lanes < 0 || lanes > 65535 || (lanes > 0 && !live))
    return (int)cudaErrorInvalidValue;
  // the ring and the staging area exceed the default 48 KB: raise the
  // kernel's dynamic shared-memory limit, and ask for the largest carveout
  // so that MIN_BLOCKS blocks fit on an SM, once per device
  static bool configured[2][kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const void* fn = lanes > 0 ? (const void*)flush_kernel<T, true>
                             : (const void*)flush_kernel<T, false>;
  if (!configured[lanes > 0][dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G::SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured[lanes > 0][dev] = true;
  }
  dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM, lanes > 0 ? lanes : 1);
  if (lanes > 0)
    flush_kernel<T, true><<<grid, G::THREADS, G::SMEM, (cudaStream_t)stream>>>(
        (T*)Tab, (const T*)U, (const T*)V, (const int*)ca, (int*)scan, M, N, K,
        (T)opt_tol, (T)piv_tol, (const int*)live, live_stride);
  else
    flush_kernel<T, false><<<grid, G::THREADS, G::SMEM, (cudaStream_t)stream>>>(
        (T*)Tab, (const T*)U, (const T*)V, (const int*)ca, (int*)scan, M, N, K,
        (T)opt_tol, (T)piv_tol, nullptr, 0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tpulp

extern "C" int tpulp_flush_f32(void* Tab, const void* U, const void* V,
                               const void* ca, void* scan, int M, int N,
                               int K, double opt_tol, double piv_tol,
                               void* stream) {
  return tpulp::launch_flush<float>(Tab, U, V, ca, scan, M, N, K, opt_tol,
                                    piv_tol, stream);
}

extern "C" int tpulp_flush_f64(void* Tab, const void* U, const void* V,
                               const void* ca, void* scan, int M, int N,
                               int K, double opt_tol, double piv_tol,
                               void* stream) {
  return tpulp::launch_flush<double>(Tab, U, V, ca, scan, M, N, K, opt_tol,
                                     piv_tol, stream);
}

extern "C" int tpulp_flush_batch_f32(void* Tab, const void* U, const void* V,
                                     const void* ca, void* scan,
                                     const void* live, long long live_stride,
                                     int M, int N, int K, int lanes,
                                     double opt_tol, double piv_tol,
                                     void* stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  return tpulp::launch_flush<float>(Tab, U, V, ca, scan, M, N, K, opt_tol,
                                    piv_tol, stream, lanes, live,
                                    live_stride);
}

extern "C" int tpulp_flush_batch_f64(void* Tab, const void* U, const void* V,
                                     const void* ca, void* scan,
                                     const void* live, long long live_stride,
                                     int M, int N, int K, int lanes,
                                     double opt_tol, double piv_tol,
                                     void* stream) {
  if (lanes < 1) return (int)cudaErrorInvalidValue;
  return tpulp::launch_flush<double>(Tab, U, V, ca, scan, M, N, K, opt_tol,
                                     piv_tol, stream, lanes, live,
                                     live_stride);
}
