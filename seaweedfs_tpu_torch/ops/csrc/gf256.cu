// GF(2^8) constant-matrix product over packed byte rows, for sm_90a.
//
//   out[i] = XOR_j M[i][j] * in[j]   in GF(2^8) mod x^8+x^4+x^3+x^2+1 (0x11D)
//
// in  : C rows of `words` packed uint32 (4 bytes per word, any byte order:
//       every byte lane is independent), row pitch `in_pitch` words
// out : R rows of `words` uint32, row pitch `out_pitch` words
// M   : R x C bytes, given at run time by value in the kernel's parameters
//       (one launch takes up to 4 rows of M; the host entry point launches
//       once per group of 4 rows), so a new decode matrix for every
//       survivor pattern costs nothing: no JIT and no constant-memory
//       upload racing other streams.
//
// Replaces seaweedfs_tpu/ops/gf256.py::_gf_kernel (:129, launched by
// _gf_matmul_pallas, pallas_call at :149). The TPU kernel unrolled a static
// matrix into xtime chains on packed words, 12.8 i32 operations per input
// byte for the 10.4 encode. A second entry, gf256_verify, replaces the body
// of seaweedfs_tpu/parallel/sharded_ec.py::sharded_verify (:114-131): the
// same product, compared with the stored parity rows, counting the 32-bit
// words that differ, as the JAX package counts `parity != packed[:, c:]`.
//
// What bounds it on an H100 SXM: bytes. As a GF(2) matrix product of 8C
// input bits by 8R output bits per byte position it is 2 * 8C * 8R int8
// operations a position, 0.043 ms at 1,979 TOP/s for the 10.4 encode at 16
// MiB a shard, under the 0.07011 ms that its 14 x 16 MiB take at 3.35 TB/s
// (10 rows in, 4 out; gf_verify reads the 4 stored rows instead of writing
// them). So the design cuts the ALU work to the HBM time's size and keeps
// loads in flight:
//
//   - Bit-planes. Each lane takes 32 bytes of a row (two 16-byte pieces, 512
//     bytes apart, so each load instruction of a warp reads 512 contiguous
//     bytes) and transposes them into 8 planes with three stages of delta
//     swaps: plane k holds bit k of the 32 bytes (60 operations, 1.9 a byte).
//   - xtime on planes is three XORs for 32 bytes: multiplying by 2 renames
//     plane k to k+1 and XORs the old plane 7 into planes 2, 3 and 4 (and
//     it becomes plane 0): the bits of 0x1D. t_k = 2^k * in for k < 4 are
//     made first, then t_4..t_7 from t_3, so one half is live at a time.
//   - Accumulate. For each output row, each nibble of M[r][c] selects a
//     subset of t_0..t_3 (or t_4..t_7); a switch on the nibble (read from
//     the parameters, the same for every thread, so no warp diverges) XORs
//     that subset into the 8 accumulator planes, two sources a LOP3: 2.5
//     LOP3s a coefficient and plane on average (3.9 bits are set in a
//     coefficient of the 10.4 matrix), 2.5 operations an input byte, and a
//     decision tree of 4 compare-and-branch steps a nibble.
//   - The accumulator planes go back to bytes through the same network (it
//     is its own inverse) and are stored as 16-byte pieces.
//   About 7-8 operations an input byte in all for the 10.4 encode, branches
//   included, against 12.8 for the xtime chain on packed words.
//   - Loads are staged: each thread keeps a ring of 4 row pieces in shared
//     memory fed by cp.async (16-byte cp.async.cg, or 4-byte cp.async.ca for
//     views that are not 16-byte aligned or whose pitch is not a multiple of
//     4 words), so the next rows' loads are in flight while the ALUs work.
//     A thread reads only the slots it filled itself: no barrier. The ring
//     runs on across the thread's tiles, so a tile's first rows arrive while
//     the previous tile's parity is stored.
//   - A ragged last tile is zero-filled by cp.async's source size and
//     masked on store; gf_verify never counts its zero words (the recomputed
//     parity there is zero too). gf_verify keeps the recomputed parity in
//     registers: each thread adds its mismatches, the warp sums them with
//     one reduce, the block's warps through shared memory, and one atomicAdd
//     per block lands in a 64-bit device counter.
//   - 72 registers a thread at R = 4, so three 256-thread blocks fit an SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 32;       // rows of M one host call takes
constexpr int kMaxCols = 32;       // columns of M (input rows)
constexpr int kRowsPerLaunch = 4;  // accumulator plane sets per thread
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // resident blocks per SM: caps registers at 85
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = 256;  // one warp's tile: 32 lanes x 2 pieces x 4 words
constexpr int kStages = 4;       // rows in flight per thread

// nib[c][2r] is the low nibble of M[row0 + r][c], nib[c][2r + 1] the high
// one (zero past R and past C)
struct GfNibbles {
  unsigned char nib[kMaxCols][2 * kRowsPerLaunch];
};

__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, int s,
                                          uint32_t m) {
  const uint32_t t = ((a >> s) ^ b) & m;
  b ^= t;
  a ^= t << s;
}

// 8 words of 4 bytes <-> 8 bit-planes. Stage j swaps bit j of the word index
// with bit j of the bit's place in its byte, so afterwards word k holds bit
// k of every byte: bit 8b + w of plane k is bit k of byte b of word w. The
// stages touch disjoint index bits and each is its own inverse, so the
// network is its own inverse too.
__device__ __forceinline__ void transpose8(uint32_t (&x)[8]) {
  swap_bits(x[0], x[1], 1, 0x55555555u);
  swap_bits(x[2], x[3], 1, 0x55555555u);
  swap_bits(x[4], x[5], 1, 0x55555555u);
  swap_bits(x[6], x[7], 1, 0x55555555u);
  swap_bits(x[0], x[2], 2, 0x33333333u);
  swap_bits(x[1], x[3], 2, 0x33333333u);
  swap_bits(x[4], x[6], 2, 0x33333333u);
  swap_bits(x[5], x[7], 2, 0x33333333u);
  swap_bits(x[0], x[4], 4, 0x0F0F0F0Fu);
  swap_bits(x[1], x[5], 4, 0x0F0F0F0Fu);
  swap_bits(x[2], x[6], 4, 0x0F0F0F0Fu);
  swap_bits(x[3], x[7], 4, 0x0F0F0F0Fu);
}

// t[k] = 2 * t[k - 1] on planes, for k in [K0, K1): the old plane 7 becomes
// plane 0 and is XORed into planes 2, 3 and 4 (0x1D); the others move up
template <int K0, int K1>
__device__ __forceinline__ void xtime_planes(uint32_t (&t)[8][8]) {
#pragma unroll
  for (int k = K0; k < K1; ++k) {
    const uint32_t hi = t[k - 1][7];
    t[k][0] = hi;
    t[k][1] = t[k - 1][0];
    t[k][2] = t[k - 1][1] ^ hi;
    t[k][3] = t[k - 1][2] ^ hi;
    t[k][4] = t[k - 1][3] ^ hi;
    t[k][5] = t[k - 1][4];
    t[k][6] = t[k - 1][5];
    t[k][7] = t[k - 1][6];
  }
}

// acc ^= XOR of the t[K0 + k] whose bit k is set in S
template <int S, int K0>
__device__ __forceinline__ void add_subset(uint32_t (&acc)[8],
                                           const uint32_t (&t)[8][8]) {
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    uint32_t v = acc[p];
    if (S & 1) v ^= t[K0][p];
    if (S & 2) v ^= t[K0 + 1][p];
    if (S & 4) v ^= t[K0 + 2][p];
    if (S & 8) v ^= t[K0 + 3][p];
    acc[p] = v;
  }
}

// one nibble of a coefficient: t[K0 .. K0 + 3] selected by its bits
template <int K0>
__device__ __forceinline__ void add_nibble(uint32_t (&acc)[8],
                                           const uint32_t (&t)[8][8],
                                           uint32_t nib) {
  switch (nib) {
    case 0: break;
    case 1: add_subset<1, K0>(acc, t); break;
    case 2: add_subset<2, K0>(acc, t); break;
    case 3: add_subset<3, K0>(acc, t); break;
    case 4: add_subset<4, K0>(acc, t); break;
    case 5: add_subset<5, K0>(acc, t); break;
    case 6: add_subset<6, K0>(acc, t); break;
    case 7: add_subset<7, K0>(acc, t); break;
    case 8: add_subset<8, K0>(acc, t); break;
    case 9: add_subset<9, K0>(acc, t); break;
    case 10: add_subset<10, K0>(acc, t); break;
    case 11: add_subset<11, K0>(acc, t); break;
    case 12: add_subset<12, K0>(acc, t); break;
    case 13: add_subset<13, K0>(acc, t); break;
    case 14: add_subset<14, K0>(acc, t); break;
    case 15: add_subset<15, K0>(acc, t); break;
    default: __builtin_unreachable();
  }
}

// acc[r] ^= M[r][c] * x, with x input row c's planes and nib the column's
// 2R nibbles (in the kernel's parameters)
template <int R>
__device__ __forceinline__ void accumulate(uint32_t (&acc)[R][8],
                                           const uint32_t (&x)[8],
                                           const unsigned char* nib) {
  uint32_t t[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p) t[0][p] = x[p];
  xtime_planes<1, 4>(t);
#pragma unroll
  for (int r = 0; r < R; ++r) add_nibble<0>(acc[r], t, nib[2 * r]);
  xtime_planes<4, 8>(t);
#pragma unroll
  for (int r = 0; r < R; ++r) add_nibble<4>(acc[r], t, nib[2 * r + 1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one whole 4-word piece of a row into this thread's slot
template <bool VEC>
__device__ __forceinline__ void copy_piece(uint4* dst, const uint32_t* src) {
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    const uint32_t d = smem_addr(dst);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d + 4 * i),
                   "l"(src + i)
                   : "memory");
  }
}

// the same for a piece of the ragged last tile: `valid` words from src,
// zeros after them (cp.async's source size); src is only read where valid
template <bool VEC>
__device__ __forceinline__ void copy_piece_ragged(uint4* dst, const uint32_t* src,
                                                  int valid) {
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid * 4)
                 : "memory");
  } else {
    const uint32_t d = smem_addr(dst);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d + 4 * i),
                   "l"(src + (i < valid ? i : 0)), "r"(i < valid ? 4 : 0)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int piece_words(long long words, long long start) {
  const long long v = words - start;
  return v <= 0 ? 0 : (v >= 4 ? 4 : (int)v);
}

// The per-thread ring of rows. Items run over the thread's tiles in order,
// `rows` items a tile: the C input rows, then (gf_verify) the R stored
// parity rows; an item is the thread's two pieces of that row. take()
// issues the item kStages - 1 ahead into the slot freed last time, waits for
// the current one and reads it.
template <bool VEC>
struct Ring {
  uint4 (*slots)[2][kThreads];
  const uint32_t* in;
  long long in_pitch;
  const uint32_t* par;
  long long par_pitch;
  long long words;
  long long n_tiles;
  long long full_tiles;  // tiles with every piece whole
  long long tile_step;
  int cols;
  int rows;
  // the prefetch cursor: its tile and row, the row's first word, and this
  // lane's first word in the tile
  long long pf_tile;
  long long pf_off;
  const uint32_t* pf_base;
  int pf_row;
  int slot;

  // the cursor at this warp's first tile, and the first kStages - 1 items
  // issued
  __device__ __forceinline__ void start(int lane) {
    n_tiles = (words + kTileWords - 1) / kTileWords;
    full_tiles = words / kTileWords;
    tile_step = (long long)gridDim.x * kWarps;
    pf_tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    pf_off = pf_tile * kTileWords + 4 * lane;
    pf_base = in;
    pf_row = 0;
    slot = 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);
  }

  __device__ __forceinline__ void issue(int s) {
    if (pf_tile < full_tiles) {
      const uint32_t* src = pf_base + pf_off;
      copy_piece<VEC>(&slots[s][0][threadIdx.x], src);
      copy_piece<VEC>(&slots[s][1][threadIdx.x], src + 128);
    } else if (pf_tile < n_tiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int valid = piece_words(words, pf_off + 128 * h);
        copy_piece_ragged<VEC>(&slots[s][h][threadIdx.x],
                               valid ? pf_base + pf_off + 128 * h : pf_base, valid);
      }
    }
    cp_async_commit();
    if (++pf_row == rows) {
      pf_row = 0;
      pf_tile += tile_step;
      pf_off += tile_step * kTileWords;
      pf_base = in;
    } else if (pf_row == cols) {
      pf_base = par;
    } else {
      pf_base += pf_row < cols ? in_pitch : par_pitch;
    }
  }

  __device__ __forceinline__ void take(uint32_t (&x)[8]) {
    issue(slot == 0 ? kStages - 1 : slot - 1);
    cp_async_wait_ring();
    const uint4 a = slots[slot][0][threadIdx.x];
    const uint4 b = slots[slot][1][threadIdx.x];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    slot = slot == kStages - 1 ? 0 : slot + 1;
  }
};

// the C input rows of the ring's current tile, multiplied into acc and
// turned back into words
template <int R, bool VEC>
__device__ __forceinline__ void product(uint32_t (&acc)[R][8], Ring<VEC>& ring,
                                        int cols, const GfNibbles& m) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[r][p] = 0u;
  for (int c = 0; c < cols; ++c) {
    uint32_t x[8];
    ring.take(x);
    transpose8(x);
    accumulate<R>(acc, x, m.nib[c]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) transpose8(acc[r]);
}

template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gf_matmul_kernel(const uint32_t* __restrict__ in, long long in_pitch,
                     uint32_t* __restrict__ out, long long out_pitch,
                     long long words, int cols, GfNibbles m) {
  __shared__ __align__(16) uint4 s_ring[kStages][2][kThreads];
  Ring<VEC> ring;
  ring.slots = s_ring;
  ring.in = in;
  ring.in_pitch = in_pitch;
  ring.par = nullptr;
  ring.par_pitch = 0;
  ring.words = words;
  ring.cols = cols;
  ring.rows = cols;
  const int lane = threadIdx.x & 31;
  ring.start(lane);

  for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < ring.n_tiles; tile += ring.tile_step) {
    uint32_t acc[R][8];
    product<R, VEC>(acc, ring, cols, m);
    const long long w0 = tile * kTileWords + 4 * lane;
    const bool whole = tile < ring.full_tiles;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t* dst = out + r * out_pitch + w0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (VEC && whole) {
          *reinterpret_cast<uint4*>(dst + 128 * h) = make_uint4(
              acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
        } else {
          const int valid = whole ? 4 : piece_words(words, w0 + 128 * h);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (i < valid) dst[128 * h + i] = acc[r][4 * h + i];
        }
      }
    }
  }
  cp_async_wait_all();
}

template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gf_verify_kernel(const uint32_t* __restrict__ in, long long in_pitch,
                     const uint32_t* __restrict__ par, long long par_pitch,
                     long long words, int cols, GfNibbles m,
                     unsigned long long* __restrict__ count) {
  __shared__ __align__(16) uint4 s_ring[kStages][2][kThreads];
  __shared__ unsigned int s_warp[kWarps];
  Ring<VEC> ring;
  ring.slots = s_ring;
  ring.in = in;
  ring.in_pitch = in_pitch;
  ring.par = par;
  ring.par_pitch = par_pitch;
  ring.words = words;
  ring.cols = cols;
  ring.rows = cols + R;
  ring.start(threadIdx.x & 31);

  unsigned int mism = 0u;
  for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < ring.n_tiles; tile += ring.tile_step) {
    uint32_t acc[R][8];
    product<R, VEC>(acc, ring, cols, m);
    // compared after the inverse transpose, word by word; a ragged tile's
    // zero-filled words are zero on both sides
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t stored[8];
      ring.take(stored);
#pragma unroll
      for (int p = 0; p < 8; ++p) mism += acc[r][p] != stored[p];
    }
  }
  cp_async_wait_all();
  // every thread reaches here: the warp sums with one reduce, warp 0 sums
  // the warps' sums, and one atomic per block lands in the counter
  mism = __reduce_add_sync(0xFFFFFFFFu, mism);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = mism;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned int w = threadIdx.x < kWarps ? s_warp[threadIdx.x] : 0u;
    w = __reduce_add_sync(0xFFFFFFFFu, w);
    if (threadIdx.x == 0 && w != 0u) atomicAdd(count, (unsigned long long)w);
  }
}

// M's rows r0 .. r0 + r - 1 as nibbles (zero past R and C)
GfNibbles pack_nibbles(const unsigned char* matrix, int r0, int r, int cols) {
  GfNibbles m;
  for (int j = 0; j < kMaxCols; ++j)
    for (int i = 0; i < kRowsPerLaunch; ++i) {
      const unsigned char v =
          (j < cols && i < r) ? matrix[(r0 + i) * cols + j] : 0;
      m.nib[j][2 * i] = v & 15;
      m.nib[j][2 * i + 1] = v >> 4;
    }
  return m;
}

// grid: one warp a tile, capped at the blocks of this kernel that fit on
// the card at once (the loops stride over the rest)
template <typename K>
cudaError_t grid_for(K kernel, long long words, int* blocks) {
  int dev = 0, sm_count = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  const long long tiles = (words + kTileWords - 1) / kTileWords;
  long long b = (tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count * (per_sm > 0 ? per_sm : 1);
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  *blocks = (int)b;
  return cudaSuccess;
}

template <int R, bool VEC>
cudaError_t launch(cudaStream_t s, const uint32_t* in, long long in_pitch,
                   uint32_t* out, long long out_pitch, long long words,
                   int cols, const GfNibbles& m) {
  int blocks = 0;
  cudaError_t e = grid_for(gf_matmul_kernel<R, VEC>, words, &blocks);
  if (e != cudaSuccess) return e;
  gf_matmul_kernel<R, VEC><<<blocks, kThreads, 0, s>>>(in, in_pitch, out,
                                                       out_pitch, words, cols, m);
  return cudaGetLastError();
}

template <int R, bool VEC>
cudaError_t launch_verify(cudaStream_t s, const uint32_t* in, long long in_pitch,
                          const uint32_t* par, long long par_pitch,
                          long long words, int cols, const GfNibbles& m,
                          unsigned long long* count) {
  int blocks = 0;
  cudaError_t e = grid_for(gf_verify_kernel<R, VEC>, words, &blocks);
  if (e != cudaSuccess) return e;
  gf_verify_kernel<R, VEC><<<blocks, kThreads, 0, s>>>(
      in, in_pitch, par, par_pitch, words, cols, m, count);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_rows(int r, cudaStream_t s, const uint32_t* in,
                        long long in_pitch, uint32_t* out, long long out_pitch,
                        long long words, int cols, const GfNibbles& m) {
  switch (r) {
    case 1: return launch<1, VEC>(s, in, in_pitch, out, out_pitch, words, cols, m);
    case 2: return launch<2, VEC>(s, in, in_pitch, out, out_pitch, words, cols, m);
    case 3: return launch<3, VEC>(s, in, in_pitch, out, out_pitch, words, cols, m);
    default: return launch<4, VEC>(s, in, in_pitch, out, out_pitch, words, cols, m);
  }
}

template <bool VEC>
cudaError_t verify_rows(int r, cudaStream_t s, const uint32_t* in,
                        long long in_pitch, const uint32_t* par,
                        long long par_pitch, long long words, int cols,
                        const GfNibbles& m, unsigned long long* count) {
  switch (r) {
    case 1: return launch_verify<1, VEC>(s, in, in_pitch, par, par_pitch, words, cols, m, count);
    case 2: return launch_verify<2, VEC>(s, in, in_pitch, par, par_pitch, words, cols, m, count);
    case 3: return launch_verify<3, VEC>(s, in, in_pitch, par, par_pitch, words, cols, m, count);
    default: return launch_verify<4, VEC>(s, in, in_pitch, par, par_pitch, words, cols, m, count);
  }
}

// 16-byte pieces need 16-byte aligned rows: both pointers, and pitches of
// whole pieces
bool vec_ok(const void* a, long long a_pitch, const void* b, long long b_pitch) {
  return ((((uintptr_t)a) | ((uintptr_t)b)) % 16 == 0) && a_pitch % 4 == 0 &&
         b_pitch % 4 == 0;
}

}  // namespace

extern "C" int gf256_max_rows() { return kMaxRows; }
extern "C" int gf256_max_cols() { return kMaxCols; }
extern "C" int gf256_rows_per_launch() { return kRowsPerLaunch; }

// Launches ceil(rows / 4) kernels on `stream`; does not synchronise.
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
  const bool vec = vec_ok(in, in_pitch, out, out_pitch);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)in;
  for (int r0 = 0; r0 < rows; r0 += kRowsPerLaunch) {
    const int r = rows - r0 < kRowsPerLaunch ? rows - r0 : kRowsPerLaunch;
    const GfNibbles m = pack_nibbles(matrix, r0, r, cols);
    uint32_t* dst = (uint32_t*)out + (long long)r0 * out_pitch;
    const cudaError_t e =
        vec ? launch_rows<true>(r, s, src, in_pitch, dst, out_pitch, words, cols, m)
            : launch_rows<false>(r, s, src, in_pitch, dst, out_pitch, words, cols, m);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Adds to *count (a device pointer to one 64-bit counter, which the caller
// zeroes) the number of 32-bit words in which `par` (rows x words, pitch
// par_pitch) differs from matrix (x) in. Launches ceil(rows / 4) kernels on
// `stream`, each comparing its 4 rows; does not synchronise. Returns 0, or
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
  const bool vec = vec_ok(in, in_pitch, par, par_pitch);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)in;
  unsigned long long* cnt = (unsigned long long*)count;
  for (int r0 = 0; r0 < rows; r0 += kRowsPerLaunch) {
    const int r = rows - r0 < kRowsPerLaunch ? rows - r0 : kRowsPerLaunch;
    const GfNibbles m = pack_nibbles(matrix, r0, r, cols);
    const uint32_t* p = (const uint32_t*)par + (long long)r0 * par_pitch;
    const cudaError_t e =
        vec ? verify_rows<true>(r, s, src, in_pitch, p, par_pitch, words, cols, m, cnt)
            : verify_rows<false>(r, s, src, in_pitch, p, par_pitch, words, cols, m, cnt);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
