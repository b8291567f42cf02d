// fma_kernel: out = c + value * a * b over a broadcast shape, with one
// rounding per element: fma(value * a, b, c), as torch's CPU addcmul and
// XLA's fusion compute it.
//
// Replaces no Pallas kernel: in tpulp this update is XLA's fusion of
// ``T - col * row`` (the rank-1 pivot, also vmapped over the B&B lanes),
// of the rank-K running vectors and of the B&B RHS rewrite. CUDA's
// torch.addcmul rounds the product first, so the port's walks on the card
// parted from tpulp's; this kernel is the fused update.
//
// What bounds it on the H100: bytes (three reads and one write per element,
// a few flops) and, at the sizes the engines give it (a few thousand to a
// million elements), the launch itself. Design: the broadcast shape is
// walked as rows (grid y) of its last dimension (grid x); each operand is
// read through its own strides over a rank-4 index (a broadcast operand has
// stride 0), so the wrapper never materialises an expanded copy, and a
// thread splits its row index once and walks the row with additions. The
// product value * a is rounded on its own (exact for value = +-1, the
// engines' values) and then fused.

#include "common.cuh"

namespace tpulp {

constexpr int FMA_RANK = 4;
constexpr int FMA_THREADS = 256;

template <typename T>
struct FmaParams {
  T* out;
  const T* c;
  const T* a;
  const T* b;
  T value;
  int rows;                  // dims[0] * dims[1] * dims[2]
  int dims[FMA_RANK];
  long long st[3][FMA_RANK];  // strides of c, a, b in elements
};

// rows of the broadcast shape along grid y, the last dimension along x:
// each thread splits its row index once (32-bit) and walks the row with
// additions only
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS) fma_kernel(FmaParams<T> p) {
  const int d3 = p.dims[3];
  for (int row = blockIdx.y; row < p.rows; row += gridDim.y) {
    const int i2 = row % p.dims[2], r = row / p.dims[2];
    const int i1 = r % p.dims[1], i0 = r / p.dims[1];
    const long long oc = i0 * p.st[0][0] + i1 * p.st[0][1] + i2 * p.st[0][2];
    const long long oa = i0 * p.st[1][0] + i1 * p.st[1][1] + i2 * p.st[1][2];
    const long long ob = i0 * p.st[2][0] + i1 * p.st[2][1] + i2 * p.st[2][2];
    T* out = p.out + (long long)row * d3;
    for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < d3; col += gridDim.x * blockDim.x)
      out[col] = fma(mul_rn(p.value, __ldg(p.a + oa + col * p.st[1][3])),
                     __ldg(p.b + ob + col * p.st[2][3]), __ldg(p.c + oc + col * p.st[0][3]));
  }
}

template <typename T>
int launch_fma(void* out, const void* c, const void* a, const void* b, double value,
               long long n, const long long* geom, void* stream) {
  if (n <= 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  FmaParams<T> p;
  p.out = (T*)out;
  p.c = (const T*)c;
  p.a = (const T*)a;
  p.b = (const T*)b;
  p.value = (T)value;
  for (int d = 0; d < FMA_RANK; ++d) {
    p.dims[d] = (int)geom[d];
    for (int k = 0; k < 3; ++k) p.st[k][d] = geom[(k + 1) * FMA_RANK + d];
  }
  p.rows = p.dims[0] * p.dims[1] * p.dims[2];
  const int bx = (p.dims[3] + FMA_THREADS - 1) / FMA_THREADS;
  const dim3 grid(bx < 64 ? bx : 64, p.rows < 65535 ? p.rows : 65535);
  fma_kernel<T><<<grid, FMA_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tpulp

#define TPULP_FMA_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(void* out, const void* c, const void* a, const void* b, double value, \
                      long long n, const long long* geom, void* stream) {                 \
    return tpulp::launch_fma<T>(out, c, a, b, value, n, geom, stream);                    \
  }

TPULP_FMA_ENTRY(tpulp_fma_f32, float)
TPULP_FMA_ENTRY(tpulp_fma_f64, double)
