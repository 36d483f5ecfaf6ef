// GF(2^8) constant-matrix product over packed byte rows, for sm_90a.
//
//   out[i] = XOR_j M[i][j] * in[j]   in GF(2^8) mod x^8+x^4+x^3+x^2+1 (0x11D)
//
// in  : C rows of `words` packed uint32 (4 bytes per word, any byte order:
//       every byte lane is independent), row pitch `in_pitch` words
// out : R rows of `words` uint32, row pitch `out_pitch` words
// M   : R x C bytes, given at run time by value in the kernel's parameters
//       (one launch takes up to 8 rows of M; the host entry point launches
//       once per group of 8 rows), so a new decode matrix for every
//       survivor pattern costs nothing: no JIT and no constant-memory
//       upload racing other streams.
//
// Replaces seaweedfs_tpu/ops/gf256.py::_gf_kernel (launched by
// _gf_matmul_pallas). The TPU kernel unrolled a static matrix into xtime
// chains on (512, 128) VMEM tiles; here the same arithmetic runs with one
// thread per 16-byte uint4 column (4 words of each input row), grid-stride
// over the row width:
//   - each input row j is loaded once per column (coalesced 16-byte loads);
//   - its xtime (multiply-by-2) chain runs only up to the highest bit set
//     in column j of M, and XOR-accumulates into R register accumulators
//     wherever M[i][j] has that bit, as gf_matmul_expr does;
//   - the bit tests read M, which is the same for every thread, so warps
//     never diverge on them;
//   - the last uint4 column of a ragged width is masked here, not padded.
//
// A second entry, gf256_verify, is the mesh's parity check (replaces the
// body of seaweedfs_tpu/parallel/sharded_ec.py::sharded_verify, :114-131):
// the same product recomputed in registers and compared with the stored
// parity rows, counting the 32-bit words that differ, as the JAX package
// counts `parity != packed[:, c:]` on uint32 words. The parity it computes
// never goes to HBM: each thread adds its mismatches, the warp sums them
// with one reduce, the block's warps through shared memory, and one
// atomicAdd per block lands in a 64-bit device counter.
//
// Bound on an H100 SXM: the larger of bytes / 3.35 TB/s and integer ops /
// (132 SMs x 64 INT32 lanes x SM clock). For the 10.4 encode each input
// byte moves 1.4 bytes (1 in, 0.4 out) and costs 12.8 i32 ops in the `mul`
// xtime form (count_expr_ops), so the kernel is bound by integer work, not
// by HBM. The design keeps that work at its count: no tables or gathers,
// one shared chain per input row, the 0x1D reduction folded into one
// multiply. Fusing XOR trees into LOP3 and staging loads with cp.async/TMA
// are later work; the measured time sits beside the bound in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 32;       // rows of M one host call takes
constexpr int kMaxCols = 32;       // columns of M (input rows)
constexpr int kRowsPerLaunch = 8;  // register accumulators per thread
constexpr int kThreads = 256;

// col[j] holds M[row0 + i][j] in byte i, for the launch's rows (zero past R)
struct GfColumns {
  unsigned long long col[kMaxCols];
};

__device__ __forceinline__ uint32_t xtime(uint32_t x) {
  // byte-parallel multiply by 2: shift, clear the carried bits, and fold
  // each byte's overflow into 0x1D with one multiply (0x01 * 0x1D < 256)
  return ((x << 1) & 0xFEFEFEFEu) ^ (((x >> 7) & 0x01010101u) * 0x1Du);
}

__device__ __forceinline__ uint4 xtime4(uint4 v) {
  return make_uint4(xtime(v.x), xtime(v.y), xtime(v.z), xtime(v.w));
}

__device__ __forceinline__ void xor4(uint4& a, const uint4& b) {
  a.x ^= b.x;
  a.y ^= b.y;
  a.z ^= b.z;
  a.w ^= b.w;
}

__device__ __forceinline__ uint4 load4(const uint32_t* p, int valid, int vec) {
  if (vec && valid == 4) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (valid > 0) v.x = __ldg(p);
  if (valid > 1) v.y = __ldg(p + 1);
  if (valid > 2) v.z = __ldg(p + 2);
  if (valid > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ void store4(uint32_t* p, const uint4& v, int valid,
                                       int vec) {
  if (vec && valid == 4) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  if (valid > 0) p[0] = v.x;
  if (valid > 1) p[1] = v.y;
  if (valid > 2) p[2] = v.z;
  if (valid > 3) p[3] = v.w;
}

// the kernel's parameter struct is read with static indices only; threads
// index the shared copy (a broadcast: every lane reads the same word)
__device__ __forceinline__ void load_columns(unsigned long long* s_col,
                                             const GfColumns& m) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) s_col[j] = m.col[j];
  }
  __syncthreads();
}

// acc[i] = XOR_j M[i][j] * src row j, over one uint4 column of `valid`
// words: each row loaded once, its xtime chain run only up to the highest
// bit set in column j of M
template <int R>
__device__ __forceinline__ void accumulate(uint4 (&acc)[R],
                                           const uint32_t* src,
                                           long long in_pitch, int cols,
                                           int valid, int vec,
                                           const unsigned long long* s_col) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int j = 0; j < cols; ++j, src += in_pitch) {
    const unsigned long long c = s_col[j];
    if (c == 0ull) continue;
    // bits set in any coefficient of this column: the chain stops at the
    // highest one
    uint32_t any = (uint32_t)c | (uint32_t)(c >> 32);
    any |= any >> 16;
    any |= any >> 8;
    any &= 0xFFu;
    uint4 t = load4(src, valid, vec);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if ((c >> (8 * i + k)) & 1ull) xor4(acc[i], t);
      }
      if ((any >> (k + 1)) == 0u) break;
      t = xtime4(t);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    gf_matmul_kernel(const uint32_t* __restrict__ in, long long in_pitch,
                     uint32_t* __restrict__ out, long long out_pitch,
                     long long words, int cols, int vec, GfColumns m) {
  __shared__ unsigned long long s_col[kMaxCols];
  load_columns(s_col, m);

  const long long n_vec = (words + 3) >> 2;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < n_vec;
       v += step) {
    const long long w0 = v << 2;
    const int valid = words - w0 < 4 ? (int)(words - w0) : 4;
    uint4 acc[R];
    accumulate<R>(acc, in + w0, in_pitch, cols, valid, vec, s_col);
    uint32_t* dst = out + w0;
#pragma unroll
    for (int i = 0; i < R; ++i) store4(dst + i * out_pitch, acc[i], valid, vec);
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    gf_verify_kernel(const uint32_t* __restrict__ in, long long in_pitch,
                     const uint32_t* __restrict__ par, long long par_pitch,
                     long long words, int cols, int vec, GfColumns m,
                     unsigned long long* __restrict__ count) {
  __shared__ unsigned long long s_col[kMaxCols];
  __shared__ unsigned int s_warp[kThreads / 32];
  load_columns(s_col, m);

  unsigned int mism = 0u;
  const long long n_vec = (words + 3) >> 2;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x; v < n_vec;
       v += step) {
    const long long w0 = v << 2;
    const int valid = words - w0 < 4 ? (int)(words - w0) : 4;
    uint4 acc[R];
    accumulate<R>(acc, in + w0, in_pitch, cols, valid, vec, s_col);
    // the ragged last column: load4 zero-fills the words past the width
    // and the recomputed words there are zero too, so they never count
    const uint32_t* stored = par + w0;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint4 p = load4(stored + i * par_pitch, valid, vec);
      mism += (acc[i].x != p.x) + (acc[i].y != p.y) + (acc[i].z != p.z) +
              (acc[i].w != p.w);
    }
  }
  // every thread reaches here: the warp sums with one reduce, warp 0 sums
  // the warps' sums, and one atomic per block lands in the counter
  mism = __reduce_add_sync(0xFFFFFFFFu, mism);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = mism;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned int w = threadIdx.x < kThreads / 32 ? s_warp[threadIdx.x] : 0u;
    w = __reduce_add_sync(0xFFFFFFFFu, w);
    if (threadIdx.x == 0 && w != 0u)
      atomicAdd(count, (unsigned long long)w);
  }
}

template <int R>
cudaError_t launch_verify(int blocks, cudaStream_t s, const uint32_t* in,
                          long long in_pitch, const uint32_t* par,
                          long long par_pitch, long long words, int cols,
                          int vec, const GfColumns& m,
                          unsigned long long* count) {
  gf_verify_kernel<R><<<blocks, kThreads, 0, s>>>(in, in_pitch, par, par_pitch,
                                                  words, cols, vec, m, count);
  return cudaGetLastError();
}

// M's rows r0 .. r0 + r - 1, packed one byte per row into each column's
// 64-bit word (zero past R)
GfColumns pack_columns(const unsigned char* matrix, int r0, int r, int cols) {
  GfColumns m;
  for (int j = 0; j < kMaxCols; ++j) {
    unsigned long long c = 0ull;
    if (j < cols) {
      for (int i = 0; i < r; ++i)
        c |= (unsigned long long)matrix[(r0 + i) * cols + j] << (8 * i);
    }
    m.col[j] = c;
  }
  return m;
}

// grid: enough 256-thread blocks for one uint4 column each, capped at 8
// resident blocks per SM (the loops stride over the rest)
cudaError_t grid_for(long long words, long long* blocks) {
  int dev = 0;
  int sm_count = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long n_vec = (words + 3) / 4;
  long long b = (n_vec + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count * (2048 / kThreads);
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  *blocks = b;
  return cudaSuccess;
}

template <int R>
cudaError_t launch(int blocks, cudaStream_t s, const uint32_t* in,
                   long long in_pitch, uint32_t* out, long long out_pitch,
                   long long words, int cols, int vec, const GfColumns& m) {
  gf_matmul_kernel<R><<<blocks, kThreads, 0, s>>>(in, in_pitch, out, out_pitch,
                                                  words, cols, vec, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gf256_max_rows() { return kMaxRows; }
extern "C" int gf256_max_cols() { return kMaxCols; }
extern "C" int gf256_rows_per_launch() { return kRowsPerLaunch; }

// Launches ceil(rows / 8) kernels on `stream`; does not synchronise.
// `matrix` is a host pointer to rows x cols bytes, row-major; it is copied
// into the launch parameters, so the caller may free it on return.
// Returns 0, or the CUDA error code of the first launch that failed.
extern "C" int gf256_matmul(const void* in, long long in_pitch, void* out,
                            long long out_pitch, long long words, int rows,
                            int cols, const unsigned char* matrix,
                            void* stream) {
  if (rows < 1 || rows > kMaxRows || cols < 1 || cols > kMaxCols ||
      words < 0 || in_pitch < words || out_pitch < words)
    return (int)cudaErrorInvalidValue;
  if (words == 0) return 0;
  long long blocks = 0;
  cudaError_t e = grid_for(words, &blocks);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((((uintptr_t)in) | ((uintptr_t)out)) % 16 == 0) &&
                  in_pitch % 4 == 0 && out_pitch % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)in;
  for (int r0 = 0; r0 < rows; r0 += kRowsPerLaunch) {
    const int r = rows - r0 < kRowsPerLaunch ? rows - r0 : kRowsPerLaunch;
    const GfColumns m = pack_columns(matrix, r0, r, cols);
    uint32_t* dst = (uint32_t*)out + (long long)r0 * out_pitch;
    const int b = (int)blocks;
    switch (r) {
      case 1: e = launch<1>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
      case 2: e = launch<2>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
      case 3: e = launch<3>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
      case 4: e = launch<4>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
      case 5: e = launch<5>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
      case 6: e = launch<6>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
      case 7: e = launch<7>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
      default: e = launch<8>(b, s, src, in_pitch, dst, out_pitch, words, cols, vec, m); break;
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Adds to *count (a device pointer to one 64-bit counter, which the caller
// zeroes) the number of 32-bit words in which `par` (rows x words, pitch
// par_pitch) differs from matrix (x) in. Launches ceil(rows / 8) kernels on
// `stream`, each comparing its 8 rows; does not synchronise. Returns 0, or
// the CUDA error code of the first launch that failed.
extern "C" int gf256_verify(const void* in, long long in_pitch,
                            const void* par, long long par_pitch,
                            long long words, int rows, int cols,
                            const unsigned char* matrix, void* count,
                            void* stream) {
  if (rows < 1 || rows > kMaxRows || cols < 1 || cols > kMaxCols ||
      words < 0 || in_pitch < words || par_pitch < words || count == nullptr)
    return (int)cudaErrorInvalidValue;
  if (words == 0) return 0;
  long long blocks = 0;
  cudaError_t e = grid_for(words, &blocks);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((((uintptr_t)in) | ((uintptr_t)par)) % 16 == 0) &&
                  in_pitch % 4 == 0 && par_pitch % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)in;
  unsigned long long* cnt = (unsigned long long*)count;
  for (int r0 = 0; r0 < rows; r0 += kRowsPerLaunch) {
    const int r = rows - r0 < kRowsPerLaunch ? rows - r0 : kRowsPerLaunch;
    const GfColumns m = pack_columns(matrix, r0, r, cols);
    const uint32_t* p = (const uint32_t*)par + (long long)r0 * par_pitch;
    const int b = (int)blocks;
    switch (r) {
      case 1: e = launch_verify<1>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
      case 2: e = launch_verify<2>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
      case 3: e = launch_verify<3>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
      case 4: e = launch_verify<4>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
      case 5: e = launch_verify<5>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
      case 6: e = launch_verify<6>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
      case 7: e = launch_verify<7>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
      default: e = launch_verify<8>(b, s, src, in_pitch, p, par_pitch, words, cols, vec, m, cnt); break;
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
