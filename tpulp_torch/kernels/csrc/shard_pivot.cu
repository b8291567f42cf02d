// shard_pivot: the whole local pivot of one column block of the sharded
// drivers in one launch, and shard_vectors: the rank-K sharded pivot's
// running vectors in one launch.
//
// Replaces no Pallas kernel. In tpulp the sharded pivot is XLA's fusion of
// the statements of tpulp/shard/sharded.py:393-405 (and, for the bounded
// driver, tpulp/shard/sharded_bounded.py:218-248); the rank-K driver's
// running vectors are its fusion of tpulp/shard/sharded_blocked.py:242-244.
// The port ran them as separate passes over the block: an out-of-place FMA
// (fma.cu), two torch.where passes for the pivot row and the unit column, a
// second FMA for the RHS, and on the bounded driver a gate, the flip's RHS
// FMA and the flip's negated column, each a full read and write.
//
// What bounds shard_pivot on the H100: bytes, one read and one write of the
// block (37.8 MB at the 1538 x 3072 f64 block: 0.0226 ms at 3.35 TB/s).
// Design: out of place (the drivers are functional: the step's input is
// still read after it, and no row waits for another), the grid is column
// tiles x row chunks x lanes; a CTA reads its slice of the pivot row once
// into registers, then walks its rows with coalesced loads, 16-byte vector
// loads where every pitch is aligned (the frames' odd pitches take the
// scalar path), four rows in flight a thread. The first column tile's CTAs
// also write their rows of the RHS, into the output frame's last column
// when the output is a frame. The per-lane scalars (pivot row, entering
// column, the bounded step's gate and flip) are read from device tensors,
// so a launch needs no host read, and one launch serves every lane of the
// lane-sharded steps.
//
// Every product rounds as the plain composition rounds it: the update is
// fma(-1 * u[i], prow[k], T[i, k]) with -1 a runtime value (fma.cu's
// fma(value * a, b, c)), prow = mul_rn(T[rg, k], 1 / u[rg]) with the
// reciprocal rounded once, so the result equals the plain version bit for
// bit, NaN and inf entries travelling as they do there.
//
// shard_vectors is bound by its launch (a few thousand elements): row0 +=
// w[0] vrow, row1 += w[1] vrow and bvec += w vrow_rhs, each one fma an
// element, in one launch instead of three.

#include "common.cuh"

namespace tpulp {

constexpr int SP_THREADS = 256;
constexpr int SP_UNROLL = 4;  // rows in flight a thread

template <typename T>
struct PivotParams {
  const T* __restrict__ tab;    // (L, R, N) block, column stride 1
  const T* __restrict__ rhs;    // (L, R)
  const T* __restrict__ u;      // (L, R) the pivot column (u_eff)
  const long long* rg;          // (L,) pivot row
  const long long* jeff;        // (L,) entering column, global
  const bool* gate;             // (L,) do_pivot, or null: always pivot
  const bool* dflip;            // (L,) the flip's do_flip (flip only)
  const bool* enter;            // (L,) an entering flip (flip only)
  const long long* fcol;        // (L,) the flipped column, global
  const T* uf;                  // (L,) the flip's span (0 without a flip)
  const T* ucol;                // (L, R) the entering column (flip only)
  T* __restrict__ out;          // (L, R, N)
  T* __restrict__ orhs;         // (L, R)
  long long sTl, sTr, sbl, sbr, sul, sur, srg, sj, sg, sdf, sen, sfc, suf, sucl, sucr, soTl, soTr,
      sobl, sobr;
  int R, N, index, rows;  // rows: a CTA's row chunk
  int has_flip;
  T neg;  // -1: a runtime value, so that -1 * u rounds as fma.cu's
};

template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  Pack<T, VEC> x;
  if constexpr (VEC == 1) {
    x.v[0] = __ldg(p);
  } else if constexpr (sizeof(T) == 8) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    x.v[0] = d.x;
    x.v[1] = d.y;
  } else {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    x.v[0] = f.x;
    x.v[1] = f.y;
    x.v[2] = f.z;
    x.v[3] = f.w;
  }
  return x;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, VEC>& x) {
  if constexpr (VEC == 1) {
    *p = x.v[0];
  } else if constexpr (sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(x.v[0], x.v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  }
}

// Entry (i, k0 + v) of the output from its input t: the pivot (row rg set
// to prow, column jcol to the unit vector), unless the gate holds the block
// as it was; then the flipped column negated.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> pivot_pack(const Pack<T, VEC>& t, const Pack<T, VEC>& prow,
                                                   T nu, bool is_rg, bool gate, int k0, int jcol,
                                                   int fcol) {
  Pack<T, VEC> o;
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    T x = t.v[v];
    if (gate) {
      x = is_rg ? prow.v[v] : fma(nu, prow.v[v], t.v[v]);
      if (k0 + v == jcol) x = is_rg ? T(1) : T(0);
    }
    if (k0 + v == fcol) x = -x;
    o.v[v] = x;
  }
  return o;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(SP_THREADS) shard_pivot_kernel(PivotParams<T> p) {
  const long long lane = blockIdx.z;
  const long long rg = p.rg[lane * p.srg];
  const long long je = p.jeff[lane * p.sj];
  const bool gate = p.gate ? p.gate[lane * p.sg] : true;
  const bool flip = p.has_flip && p.dflip[lane * p.sdf];
  // the entering column and the flipped column on this shard (-1: not here)
  const int jcol = je / p.N == p.index ? (int)(je % p.N) : -1;
  int fcol = -1;
  if (flip) {
    const long long f = p.fcol[lane * p.sfc];
    fcol = f / p.N == p.index ? (int)(f % p.N) : -1;
  }
  const T* tab = p.tab + lane * p.sTl;
  const T* u = p.u + lane * p.sul;
  T* out = p.out + lane * p.soTl;
  const T invp = div_rn(T(1), u[rg * p.sur]);
  const int row0 = blockIdx.y * p.rows;
  const int row1 = min(p.R, row0 + p.rows);

  const int k0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (k0 < p.N) {
    Pack<T, VEC> prow = load_pack<T, VEC>(tab + rg * p.sTr + k0);
#pragma unroll
    for (int v = 0; v < VEC; ++v) prow.v[v] = mul_rn(prow.v[v], invp);
    const int dy = blockDim.y;
    int i = row0 + threadIdx.y;
    for (; i + (SP_UNROLL - 1) * dy < row1; i += SP_UNROLL * dy) {
      Pack<T, VEC> t[SP_UNROLL];
      T nu[SP_UNROLL];
#pragma unroll
      for (int r = 0; r < SP_UNROLL; ++r) {
        t[r] = load_pack<T, VEC>(tab + (long long)(i + r * dy) * p.sTr + k0);
        nu[r] = mul_rn(p.neg, __ldg(u + (long long)(i + r * dy) * p.sur));
      }
#pragma unroll
      for (int r = 0; r < SP_UNROLL; ++r)
        store_pack<T, VEC>(out + (long long)(i + r * dy) * p.soTr + k0,
                           pivot_pack<T, VEC>(t[r], prow, nu[r], i + r * dy == rg, gate, k0, jcol,
                                              fcol));
    }
    for (; i < row1; i += dy) {
      const Pack<T, VEC> t = load_pack<T, VEC>(tab + (long long)i * p.sTr + k0);
      const T nu = mul_rn(p.neg, __ldg(u + (long long)i * p.sur));
      store_pack<T, VEC>(out + (long long)i * p.soTr + k0,
                         pivot_pack<T, VEC>(t, prow, nu, i == rg, gate, k0, jcol, fcol));
    }
  }

  // the RHS: the first column tile's CTAs, each its row chunk
  if (blockIdx.x == 0) {
    const T* rhs = p.rhs + lane * p.sbl;
    T* orhs = p.orhs + lane * p.sobl;
    const T rpiv = mul_rn(rhs[rg * p.sbr], invp);
    const bool enter = p.has_flip && p.enter[lane * p.sen];
    const T uf = p.has_flip ? p.uf[lane * p.suf] : T(0);
    const T* uc = p.has_flip ? p.ucol + lane * p.sucl : nullptr;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    for (int i = row0 + tid; i < row1; i += blockDim.x * blockDim.y) {
      const T b = rhs[(long long)i * p.sbr];
      const T ui = u[(long long)i * p.sur];
      T x = b;
      if (gate) x = i == rg ? rpiv : fma(mul_rn(p.neg, ui), rpiv, b);
      if (p.has_flip) {
        // the flipped column's post-pivot values: the entering column as
        // fetched, or the leaving one in closed form
        const T colv = enter ? uc[(long long)i * p.sucr] : (i == rg ? invp : mul_rn(-ui, invp));
        x = fma(mul_rn(p.neg, colv), uf, x);
      }
      orhs[(long long)i * p.sobr] = x;
    }
  }
}

// a: the 13 pointers (tab, rhs, u, rg, jeff, gate, dflip, enter, fcol, uf,
// ucol, out, orhs), the 19 strides in PivotParams' order, then L, R, N,
// index, has_flip, vec, threads x, threads y, column tiles, row chunks and
// rows a chunk
template <typename T>
int launch_shard_pivot(const long long* a, void* stream) {
  PivotParams<T> p;
  p.tab = (const T*)a[0];
  p.rhs = (const T*)a[1];
  p.u = (const T*)a[2];
  p.rg = (const long long*)a[3];
  p.jeff = (const long long*)a[4];
  p.gate = (const bool*)a[5];
  p.dflip = (const bool*)a[6];
  p.enter = (const bool*)a[7];
  p.fcol = (const long long*)a[8];
  p.uf = (const T*)a[9];
  p.ucol = (const T*)a[10];
  p.out = (T*)a[11];
  p.orhs = (T*)a[12];
  const long long* s = a + 13;
  p.sTl = s[0], p.sTr = s[1], p.sbl = s[2], p.sbr = s[3], p.sul = s[4], p.sur = s[5];
  p.srg = s[6], p.sj = s[7], p.sg = s[8], p.sdf = s[9], p.sen = s[10], p.sfc = s[11];
  p.suf = s[12], p.sucl = s[13], p.sucr = s[14], p.soTl = s[15], p.soTr = s[16];
  p.sobl = s[17], p.sobr = s[18];
  const long long* d = a + 32;
  const long long L = d[0];
  p.R = (int)d[1];
  p.N = (int)d[2];
  p.index = (int)d[3];
  p.has_flip = (int)d[4];
  const int vec = (int)d[5];
  const dim3 block((unsigned)d[6], (unsigned)d[7]);
  const dim3 grid((unsigned)d[8], (unsigned)d[9], (unsigned)L);
  p.rows = (int)d[10];
  p.neg = T(-1);
  if (L < 1 || L > 65535 || p.R < 1 || p.N < 1 || block.x * block.y > SP_THREADS ||
      grid.y > 65535 || (p.has_flip && (!p.dflip || !p.enter || !p.fcol || !p.uf || !p.ucol)))
    return (int)cudaErrorInvalidValue;
  if (vec == 1) {
    shard_pivot_kernel<T, 1><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  } else if (vec == 16 / (int)sizeof(T)) {
    shard_pivot_kernel<T, 16 / sizeof(T)><<<grid, block, 0, (cudaStream_t)stream>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
struct VectorParams {
  const T* w;         // (M,) the eta vector
  const T* vrow;      // (n,) the pivot row's local slice
  const T* vrow_rhs;  // () its RHS entry
  const T* row0;      // (n,)
  const T* row1;      // (n,)
  const T* bvec;      // (M,)
  T* out;             // (2n + M,): row0, row1, bvec
  int n, M;
  T one;  // 1: a runtime value, so that 1 * w rounds as fma.cu's
};

template <typename T>
__global__ void __launch_bounds__(SP_THREADS) shard_vectors_kernel(VectorParams<T> p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < 2 * p.n) {
    const int k = e < p.n ? e : e - p.n;
    const T wr = mul_rn(p.one, p.w[e < p.n ? 0 : 1]);
    p.out[e] = fma(wr, p.vrow[k], (e < p.n ? p.row0 : p.row1)[k]);
  } else if (e < 2 * p.n + p.M) {
    const int i = e - 2 * p.n;
    p.out[e] = fma(mul_rn(p.one, p.w[i]), *p.vrow_rhs, p.bvec[i]);
  }
}

// a: the 7 pointers (w, vrow, vrow_rhs, row0, row1, bvec, out), then n, M
template <typename T>
int launch_shard_vectors(const long long* a, void* stream) {
  VectorParams<T> p;
  p.w = (const T*)a[0];
  p.vrow = (const T*)a[1];
  p.vrow_rhs = (const T*)a[2];
  p.row0 = (const T*)a[3];
  p.row1 = (const T*)a[4];
  p.bvec = (const T*)a[5];
  p.out = (T*)a[6];
  p.n = (int)a[7];
  p.M = (int)a[8];
  p.one = T(1);
  const long long total = 2LL * p.n + p.M;
  if (p.n < 1 || p.M < 2 || total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + SP_THREADS - 1) / SP_THREADS);
  shard_vectors_kernel<T><<<blocks, SP_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace tpulp

extern "C" int tpulp_shard_pivot_f32(const long long* a, void* stream) {
  return tpulp::launch_shard_pivot<float>(a, stream);
}
extern "C" int tpulp_shard_pivot_f64(const long long* a, void* stream) {
  return tpulp::launch_shard_pivot<double>(a, stream);
}
extern "C" int tpulp_shard_vectors_f32(const long long* a, void* stream) {
  return tpulp::launch_shard_vectors<float>(a, stream);
}
extern "C" int tpulp_shard_vectors_f64(const long long* a, void* stream) {
  return tpulp::launch_shard_vectors<double>(a, stream);
}
