// K2: one ragged gate wakeup answered in one launch, for sm_90a.
//
// Replaces seaweedfs_tpu/ops/ragged_lookup.py::_ragged_dispatch together
// with the host work around it in that package's _dispatch_members: the
// packing of one probe slot per (key, run) into planes, and the
// newest-wins reduction of the slots' answers.
//
// A generation of the arena holds the sealed runs of many volumes (or of a
// filer's store), concatenated with page-aligned bases:
//
//   rows   [n] 16 bytes: word 0 the key's u64 bits, word 1 the offset in
//          its low and the size in its high 32 bits (IndexSnapshot's row)
//   tables int32: per bucketed run, nb + 1 bucket starts relative to the
//          run's base: starts[b] = the first row whose key is >= kmin +
//          b * bstep; at most one start per two rows
//   bloom  uint32: per filtered run, its bitmap as LE words
//
// A launch carries the flush's keys once each, one record per block
// (first key, keys, first run, runs R) and, per group of keys, the
// descriptors of its R runs newest first (RunDesc, copied by the host from
// the generation's table). Per key it writes found, rank (the index in the
// group's list of the first run that holds the key), and that run's
// offset and size; a key no run holds answers 0 in all four.
//
// Each (key, run) pair, from the key alone:
//   the bloom test: two words of the run's bitmap at the murmur3 finalizer's
//           positions (storage/needle_map/lsm_map.py, k = 2), loaded at
//           once; a run the filter rejects does not hold the key, and its
//           lane stops there;
//   the bucket: b = (max(k, kmin) - kmin) / bstep, clamped to nb - 1 (K1's
//           arithmetic); starts[b] and starts[b + 1], one load trip;
//   the rows: a bucket of at most 4 rows loads whole, at once; a wider one
//           (a dense bucket, or a run left unbucketed, searched over
//           [base, end)) is bisected down to 4 rows first.
// The answer is the first row of the bucket whose key is >= the probe,
// kept in registers from the rows already loaded: no load follows the
// search. Its key equals the probe or the run does not hold it. The search
// never reads outside [base, end), so no probe can match the next run's
// first row or a zero row that pads a run to its page. A run without a
// filter (the filer's) takes two trips after its key; a filtered one
// three, or one when the filter rejects, as for most runs of a needle map
// (a key lives in one of them). Loading the bucket's bounds beside the
// bloom words would save the middle trip but load bounds for every
// rejected run; on the H100 that cost more at 65,536 probes than it saved
// at the gates' flushes of tens to hundreds of keys.
//
// R lanes a key: the L = min(next power of two >= R, 32) lanes of a key
// are neighbours in one warp, lane j searching run j (and j + L, ... when R
// > 32, chunk by chunk). All of a key's runs then load at once and each
// lane holds one run's state in few registers (at most 32, so that an SM
// holds 2,048 threads), so a block keeps many keys in flight; the newest
// run holding the key is one ballot (its lowest set bit among the key's
// lanes) and two shuffles bring its offset and size to the key's first
// lane, which writes the answer. A block holds keys of one group, so every
// lane of a block shares R and the run descriptors, which the block stages
// in shared memory. One thread a key, searching the runs newest first and
// stopping at the first that holds it, loads less but chains a key's runs
// one after another: slower at the gates' flushes, where latency rules.
// With R = 5 or 6, 3 or 2 of a key's 8 lanes idle.
//
// What bounds it on an H100: the chain of dependent loads (the block's
// record, then its key and descriptors, then the trips above) at a gate's
// flush, and the rate of scattered loads at 65,536 probes; the bytes are
// far below either. The filer's generation is about 2 MB, far under the
// card's 50 MB L2.
//
// ragged_lookup_kernel below is the design this replaced, kept so that
// chip_smoke.py can time it beside the new one: one thread per probe slot
// over host-packed planes
//
//   u32p [4, P]: key hi, key lo, bloom mask 0, bloom mask 1
//   i32p [5, P]: row lo, row hi (the run's interpolation bucket, absolute),
//                end (the run's exclusive end row), bloom word 0, word 1
//
// and separate key, offset and size columns: two bloom words, a bisection
// of the key column, the key again and then the offset and size, five
// round trips or more a slot, reduced newest-wins on the host.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int kThreads = 128;  // the probe kernel's block: 4 warps
constexpr int kBlocksPerSM = 16;  // 2,048 threads an SM: at most 32 registers
constexpr int kWindow = 4;     // rows a run's search loads at once
constexpr int kPlaneThreads = 256;

// One run of a launch. The host writes these as 8 int64 words
// (ops/ragged_lookup.py, _DESC_WORDS).
struct RunDesc {
  unsigned long long kmin;   // the bucket table's first boundary
  unsigned long long bstep;  // keys a bucket spans
  long long nb;              // buckets: the table holds nb + 1 starts
  long long base;            // the run's first row in the generation
  long long end;             // one past its last row
  long long tbase;           // its table's first entry, -1: not bucketed
  long long bbase;           // its bitmap's first word, -1: no filter
  unsigned long long bmask;  // the bitmap's bits - 1
};
static_assert(sizeof(RunDesc) == 64, "a descriptor is 8 words");

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xFF51AFD7ED558CCDull;
  x ^= x >> 33;
  x *= 0xC4CEB9FE1A85EC53ull;
  x ^= x >> 33;
  return x;
}

// The first row of `key`'s bucket in the run whose key is >= key, or a row
// whose key is ~key (never key) when there is none or the filter rejects.
__device__ __forceinline__ ulonglong2 search_run(
    const ulonglong2* __restrict__ rows, const int* __restrict__ tables,
    const uint32_t* __restrict__ bloom, const RunDesc& d,
    unsigned long long key) {
  ulonglong2 last = make_ulonglong2(~key, 0ull);
  if (d.bbase >= 0) {
    const unsigned long long h = mix64(key);
    const unsigned long long p0 = h & d.bmask;
    const unsigned long long p1 = (p0 + ((h >> 32) | 1ull)) & d.bmask;
    const uint32_t w0 = __ldg(bloom + d.bbase + (long long)(p0 >> 5));
    const uint32_t w1 = __ldg(bloom + d.bbase + (long long)(p1 >> 5));
    if (((w0 >> (p0 & 31)) & (w1 >> (p1 & 31)) & 1u) == 0) return last;
  }
  int lo = (int)d.base;
  int hi = (int)d.end;
  if (d.tbase >= 0) {
    const unsigned long long q = key > d.kmin ? key : d.kmin;
    unsigned long long b = (q - d.kmin) / d.bstep;
    if (b > (unsigned long long)(d.nb - 1)) b = (unsigned long long)(d.nb - 1);
    const int* t = tables + d.tbase + (long long)b;
    lo += __ldg(t);
    hi = (int)d.base + __ldg(t + 1);
  }
  while (hi - lo > kWindow) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    const ulonglong2 row = __ldg(rows + mid);
    if (row.x < key) {
      lo = mid + 1;
    } else {
      hi = mid;
      last = row;
    }
  }
  ulonglong2 w[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j)
    w[j] = lo + j < hi ? __ldg(rows + lo + j) : make_ulonglong2(0ull, 0ull);
#pragma unroll
  for (int j = kWindow - 1; j >= 0; --j)
    if (lo + j < hi && w[j].x >= key) last = w[j];
  return last;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    ragged_probe_kernel(const ulonglong2* __restrict__ rows,
                        const int* __restrict__ tables,
                        const uint32_t* __restrict__ bloom,
                        const unsigned long long* __restrict__ keys,
                        const int4* __restrict__ blocks,
                        const RunDesc* __restrict__ descs,
                        int* __restrict__ out_rank,
                        uint32_t* __restrict__ out_off,
                        uint32_t* __restrict__ out_size,
                        uint8_t* __restrict__ out_found) {
  __shared__ RunDesc s_desc[32];
  const int4 blk = blocks[blockIdx.x];  // first key, keys, first run, runs
  const int runs = blk.w;
  const int lanes = runs >= 32 ? 32 : 1 << (32 - __clz(runs - 1));
  const int sub = threadIdx.x & (lanes - 1);  // this lane's run in a chunk
  const int slot = threadIdx.x / lanes;       // its key in the block
  const bool live = slot < blk.y;
  const unsigned long long key = live ? __ldg(keys + blk.x + slot) : 0ull;
  const int first = (threadIdx.x & 31) & ~(lanes - 1);  // the key's lane 0
  const unsigned mine = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1u;
  int rank = -1;
  unsigned long long answer = 0ull;
  for (int c = 0; c < runs; c += lanes) {
    const int n = runs - c < lanes ? runs - c : lanes;
    __syncthreads();  // the last chunk's readers are done with s_desc
    if (threadIdx.x < n) s_desc[threadIdx.x] = descs[blk.z + c + threadIdx.x];
    __syncthreads();
    ulonglong2 hit = make_ulonglong2(~key, 0ull);
    if (live && sub < n) hit = search_run(rows, tables, bloom, s_desc[sub], key);
    const unsigned bits =
        (__ballot_sync(0xFFFFFFFFu, hit.x == key) >> first) & mine;
    const int src = first + (bits ? __ffs(bits) - 1 : 0);
    const unsigned long long y = __shfl_sync(0xFFFFFFFFu, hit.y, src);
    if (rank < 0 && bits) {
      rank = c + __ffs(bits) - 1;
      answer = y;
    }
  }
  if (live && sub == 0) {
    const long long i = (long long)blk.x + slot;
    out_rank[i] = rank < 0 ? 0 : rank;
    out_off[i] = (uint32_t)answer;
    out_size[i] = (uint32_t)(answer >> 32);
    out_found[i] = rank >= 0 ? 1 : 0;
  }
}

// The replaced design, one thread per probe slot (see the header).
__global__ void __launch_bounds__(kPlaneThreads)
    ragged_lookup_kernel(const unsigned long long* __restrict__ keys,
                         const uint32_t* __restrict__ offs,
                         const uint32_t* __restrict__ sizes, int n,
                         const uint32_t* __restrict__ bloom,
                         const uint32_t* __restrict__ u32p,
                         const int* __restrict__ i32p, int p,
                         uint32_t* __restrict__ out_off,
                         uint32_t* __restrict__ out_size,
                         uint8_t* __restrict__ out_found) {
  const int i = blockIdx.x * kPlaneThreads + threadIdx.x;
  if (i >= p) return;
  const uint32_t bm0 = __ldg(u32p + 2 * (long long)p + i);
  const uint32_t bm1 = __ldg(u32p + 3 * (long long)p + i);
  const int bw0 = __ldg(i32p + 3 * (long long)p + i);
  const int bw1 = __ldg(i32p + 4 * (long long)p + i);
  const bool present = (__ldg(bloom + bw0) & bm0) == bm0 &&
                       (__ldg(bloom + bw1) & bm1) == bm1;
  bool found = false;
  int idx = 0;
  if (present) {
    const unsigned long long key =
        ((unsigned long long)__ldg(u32p + i) << 32) |
        (unsigned long long)__ldg(u32p + (long long)p + i);
    const int lo = __ldg(i32p + i);
    const int hi = __ldg(i32p + (long long)p + i);
    const int end = __ldg(i32p + 2 * (long long)p + i);
    found = found_at(keys, n, lower_bound_u64(keys, lo, hi, key), end, key,
                     &idx);
  }
  out_off[i] = found ? __ldg(offs + idx) : 0u;
  out_size[i] = found ? __ldg(sizes + idx) : 0u;
  out_found[i] = found ? 1 : 0;
}

}  // namespace

// Launches the probe kernel, one block a record, on `stream`; does not
// synchronise. `rows` is the generation's 16-byte aligned [n, 2] table,
// `blocks` int32 [nblocks, 4] (16-byte aligned), `descs` the launch's run
// descriptors. Returns 0, or the CUDA error code of the launch.
extern "C" int ragged_probe(const void* rows, const void* tables,
                            const void* bloom, const void* keys,
                            const void* blocks, int nblocks,
                            const void* descs, void* out_rank, void* out_off,
                            void* out_size, void* out_found, void* stream) {
  if (((uintptr_t)rows & 15) != 0 || ((uintptr_t)blocks & 15) != 0 ||
      ((uintptr_t)descs & 7) != 0 || nblocks < 0)
    return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return 0;
  ragged_probe_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const ulonglong2*)rows, (const int*)tables, (const uint32_t*)bloom,
      (const unsigned long long*)keys, (const int4*)blocks,
      (const RunDesc*)descs, (int*)out_rank, (uint32_t*)out_off,
      (uint32_t*)out_size, (uint8_t*)out_found);
  return (int)cudaGetLastError();
}

// Launches the replaced plane kernel on `stream`; does not synchronise.
// The planes are row-major [4, p] and [5, p]. Returns 0, or the CUDA error
// of the launch.
extern "C" int ragged_lookup(const void* keys, const void* offs,
                             const void* sizes, int n, const void* bloom,
                             const void* u32p, const void* i32p, int p,
                             void* out_off, void* out_size, void* out_found,
                             void* stream) {
  if (n < 1 || p < 0) return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  const int blocks = (int)(((long long)p + kPlaneThreads - 1) / kPlaneThreads);
  ragged_lookup_kernel<<<blocks, kPlaneThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (const uint32_t*)offs,
      (const uint32_t*)sizes, n, (const uint32_t*)bloom,
      (const uint32_t*)u32p, (const int*)i32p, p, (uint32_t*)out_off,
      (uint32_t*)out_size, (uint8_t*)out_found);
  return (int)cudaGetLastError();
}

// Registers per thread of the probe kernel as loaded, or -1 on a CUDA
// error.
extern "C" int ragged_probe_registers(void) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, ragged_probe_kernel) != cudaSuccess) return -1;
  return a.numRegs;
}
