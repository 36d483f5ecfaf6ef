// The mesh lookup's two kernels, for sm_90a: a bucket table built on the
// card (index_buckets, "A") and a search that reads it from L2
// (bucket_search, "B").
//
// Replaces seaweedfs_tpu/parallel/sharded_lookup.py::_compiled_body
// (:29-54), the shard_map body of sharded_bulk_lookup (:57-93): each place
// of the mesh finds, for each probe of its slice, the lower bound over the
// whole replicated table (index_kernel.py::_search_range, lo = 0, hi = n),
// and answers (offset, size, found) from that row. The JAX program bisects
// the whole table: about 25 dependent loads a probe at 29.6M rows, the last
// 10-12 of them round trips to HBM. The answers here are the same: the
// lower bound over the table always lies inside the probe's bucket, and
// with duplicate keys it is still the first row of the run.
//
// The table is one 16-byte row per entry (IndexSnapshot.rows): word 0 the
// key's u64 bits, word 1 the offset in its low and the size in its high
// 32 bits.
//
// A: starts[b] = the first row whose key is >= kmin + b * bstep, for b in
// [0, nb), and starts[nb] = n; that is np.searchsorted(keys, kmin +
// arange(nb) * bstep) with n appended. One thread a row: with b_i the
// (clamped) bucket of row i and b_{-1} = -1, thread i writes starts[b] = i
// for b in (b_{i-1}, b_i]; the empty buckets after the last row, (b_{n-1},
// nb], are written n by the whole grid, a few entries a thread. Every entry
// is written once, so no pass over the buckets and no search is needed. A
// gap of more than 32 empty buckets is written by its whole warp, 32
// entries a store, so neither sequential keys (whose table has about one
// bucket a row and its upper half empty) nor a skewed table leaves one
// thread with a long run of stores. The warp then measures the buckets
// that start in it: each runs to the next start (a ballot), and the last
// one to the first row of a later bucket, which the warp finds in the next
// 32 keys (one coalesced load, mostly L2 hits), galloping further only for
// a longer run. The largest occupancy comes back through a warp shuffle
// and at most one atomicMax a block. Bound: the rows' bytes (each 32-byte
// sector holds two keys) and the table's, once each.
//
// B: one probe per thread. Its bucket b from the u64 probe with K1's
// arithmetic (index_search.cu), then starts[b] and starts[b + 1]: the
// wrapper sizes the table to the card's persisting L2 and sets an access
// policy window over it on the launch's stream, so those two loads are L2
// hits. Then one round trip to HBM for the rows: the probe's place inside
// its bucket's key range, times the bucket's rows, guesses its row, and the
// thread loads the aligned group of 4 rows (64 bytes, two sectors) that
// holds the guess, all 4 loads at once. If the first row >= the probe lies
// inside the group, and is not the group's first row with rows of the
// bucket before it, that row is the answer. Otherwise the lower bound lies
// before or after the group, and the thread bisects that side of the
// bucket as K1 does. That keeps skewed keys and runs of duplicates right
// (the bisection finds a run's first row) at the cost of a second round
// trip; chip_smoke.py counts the probes that take it.
//
// What bounds B on an H100: HBM traffic of the rows, fetched in random
// order. The H100's persisting L2 (31.25 MiB) holds 2^22 buckets, about 7
// rows each on a full volume's index: reading a whole bucket costs 4-5
// sectors a probe, the guessed group two, and two more only when the guess
// misses. chip_smoke.py times B beside K1's bisection over the same table
// (PERF.md keeps the numbers). Variants tried in development were slower:
// every row of the bucket read at once (8 lanes a probe, with a ballot),
// and groups of 2 or 8 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;      // rows B reads first: 64 bytes, aligned
constexpr long long kLongGap = 32;  // empty buckets A leaves to a whole warp
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ unsigned long long bucket_of(
    unsigned long long key, unsigned long long kmin, unsigned long long bstep,
    unsigned long long nb) {
  const unsigned long long q = key > kmin ? key : kmin;
  const unsigned long long b = (q - kmin) / bstep;
  return b > nb - 1 ? nb - 1 : b;
}

// The first row after `lo` whose key is >= end, or n; keys[lo] < end. A
// galloping search from lo, then a bisection of the last step.
__device__ long long first_at_or_above(const unsigned long long* __restrict__ keys,
                                       long long n, long long lo,
                                       unsigned long long end) {
  long long hi = n;
  for (long long step = 1; lo + step < n; step <<= 1) {
    if (__ldg(keys + 2 * (lo + step)) >= end) {
      hi = lo + step;
      break;
    }
    lo += step;
  }
  while (hi - lo > 1) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + 2 * mid) >= end)
      hi = mid;
    else
      lo = mid;
  }
  return hi;
}

__global__ void __launch_bounds__(kThreads)
    index_buckets_kernel(const unsigned long long* __restrict__ keys, int n,
                         unsigned long long kmin, unsigned long long bstep,
                         unsigned long long nb, int* __restrict__ starts,
                         int* __restrict__ max_rows) {
  __shared__ int block_max;
  if (threadIdx.x == 0) block_max = 0;
  const int lane = threadIdx.x & 31;
  const long long base = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
  const long long i = base + lane;
  long long b = -1;
  if (i < n) b = (long long)bucket_of(__ldg(keys + 2 * i), kmin, bstep, nb);
  long long prev = __shfl_up_sync(kFull, b, 1);
  if (lane == 0)
    prev = (i > 0 && i < n) ? (long long)bucket_of(__ldg(keys + 2 * (i - 1)), kmin, bstep, nb) : -1;
  const bool start = i < n && prev < b;  // row i is its bucket's first
  const bool long_gap = i < n && b - prev > kLongGap;
  if (i < n && !long_gap)
    for (long long c = prev + 1; c <= b; ++c) starts[c] = (int)i;
  // a long gap is written by the whole warp, one gap after another
  for (unsigned gaps = __ballot_sync(kFull, long_gap); gaps; gaps &= gaps - 1) {
    const int src = __ffs(gaps) - 1;
    const long long to = __shfl_sync(kFull, b, src);
    for (long long c = __shfl_sync(kFull, prev, src) + 1 + lane; c <= to; c += 32)
      starts[c] = (int)(base + src);
  }
  // the buckets after the last row's: the whole grid, strided
  const long long last_b = (long long)bucket_of(__ldg(keys + 2 * (long long)(n - 1)), kmin, bstep, nb);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long c = last_b + 1 + (long long)blockIdx.x * kThreads + threadIdx.x;
       c <= (long long)nb; c += stride)
    starts[c] = n;

  // rows of each bucket that starts in this warp: up to the warp's next
  // start; the last one's run goes on past lane 31 unless the table or the
  // clamped last bucket ends it, and the warp reads the next 32 keys (one
  // coalesced load, mostly L2 hits) to find its end, galloping further
  // only for a longer run
  const unsigned first_rows = __ballot_sync(kFull, start);
  int rows = 0;
  if (first_rows) {
    const unsigned later = lane < 31 ? first_rows >> (lane + 1) : 0u;
    if (start && later) rows = __ffs(later);
    const int last = 31 - __clz(first_rows);
    const unsigned long long bl = (unsigned long long)__shfl_sync(kFull, b, last);
    long long end = n;
    if (base + 32 < n && bl != nb - 1) {
      const unsigned long long next = kmin + (bl + 1) * bstep;
      const long long j = base + 32 + lane;
      const unsigned past = __ballot_sync(kFull, j >= n || __ldg(keys + 2 * j) >= next);
      end = past ? base + 31 + __ffs(past) : first_at_or_above(keys, n, base + 63, next);
    }
    if (lane == last) rows = (int)(end - base - last);
  }
  for (int o = 16; o > 0; o >>= 1) rows = max(rows, __shfl_xor_sync(kFull, rows, o));
  __syncthreads();
  if (lane == 0) atomicMax(&block_max, rows);
  __syncthreads();
  // one atomic a block at most, none once a block finds no larger bucket
  if (threadIdx.x == 0 && block_max > *(volatile int*)max_rows) atomicMax(max_rows, block_max);
}

__global__ void __launch_bounds__(kThreads)
    bucket_search_kernel(const ulonglong2* __restrict__ rows,
                         const int* __restrict__ starts,
                         unsigned long long kmin, unsigned long long bstep,
                         unsigned long long nb,
                         const unsigned long long* __restrict__ probes,
                         long long p, uint32_t* __restrict__ out_off,
                         uint32_t* __restrict__ out_size,
                         uint8_t* __restrict__ out_found) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const unsigned long long key = __ldg(probes + i);
  const unsigned long long b = bucket_of(key, kmin, bstep, nb);
  int lo = __ldg(starts + b);
  int hi = __ldg(starts + b + 1);
  // the last row found >= key; ~key never equals key, so none reads absent
  ulonglong2 last = make_ulonglong2(~key, 0ull);
  if (lo < hi) {
    // the key's place in its bucket's range, in [0, 1) but in the clamped
    // last bucket, guesses its row; the guess's aligned group is loaded
    const unsigned long long q = key > kmin ? key : kmin;
    const double place = (double)(q - kmin - b * bstep) / (double)bstep;
    const int count = hi - lo;
    const int guess = lo + (int)fmin((double)(count - 1), place * (double)count);
    const int g0 = guess & ~(kGroup - 1);
    const int from = max(g0, lo);
    const int to = min(g0 + kGroup, hi);
    ulonglong2 got[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      got[k] = g0 + k >= from && g0 + k < to ? __ldg(rows + g0 + k) : make_ulonglong2(0ull, 0ull);
    int first = to;  // the first row >= key in [from, to), or `to`
#pragma unroll
    for (int k = kGroup - 1; k >= 0; --k) {
      if (g0 + k >= from && g0 + k < to && got[k].x >= key) {
        first = g0 + k;
        last = got[k];
      }
    }
    if (first == from && from > lo)
      hi = from;  // a row before the group may also be >= key
    else if (first == to && to < hi)
      lo = to;  // every row of the group is below key
    else
      lo = hi;  // the answer is `first`, or the bucket holds none
    // K1's bisection over what is left
    while (lo < hi) {
      const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
      const ulonglong2 row = __ldg(rows + mid);
      if (row.x < key) {
        lo = mid + 1;
      } else {
        hi = mid;
        last = row;
      }
    }
  }
  const bool found = last.x == key;
  out_off[i] = found ? (uint32_t)last.y : 0u;
  out_size[i] = found ? (uint32_t)(last.y >> 32) : 0u;
  out_found[i] = found ? 1 : 0;
}

bool bad_geometry(int n, unsigned long long kmin, unsigned long long bstep,
                  unsigned long long nb) {
  // nb + 1 int32 entries; every boundary below nb representable in u64
  return n < 1 || bstep == 0 || nb == 0 || nb > 0x7FFFFFFEull ||
         (nb - 1) > (~0ull - kmin) / bstep;
}

}  // namespace

// A: launches one kernel on `stream`; does not synchronise. `rows` is the
// 16-byte aligned [n, 2] table sorted by key; `starts` receives nb + 1
// int32 entries; `max_rows` is one int32 that must hold 0 (the largest
// bucket's rows are max'ed into it). Returns 0, or the CUDA error code.
extern "C" int index_buckets(const void* rows, int n, unsigned long long kmin,
                             unsigned long long bstep, unsigned long long nb,
                             void* starts, void* max_rows, void* stream) {
  if (((uintptr_t)rows & 15) != 0 || bad_geometry(n, kmin, bstep, nb))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  index_buckets_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)rows, n, kmin, bstep, nb, (int*)starts,
      (int*)max_rows);
  return (int)cudaGetLastError();
}

// B: launches one kernel on `stream`; does not synchronise. `starts` is
// A's table for these rows and geometry. With `window_bytes` > 0 the
// device's persisting L2 set-aside is raised to at least that size (up to
// `max_persist`), the stream gets an access policy window of that many
// bytes over `starts` (hits persisting) for this launch, and the window is
// reset right after it. Returns 0, or the CUDA error code of the first
// call that failed.
extern "C" int bucket_search(const void* rows, int n, const void* starts,
                             unsigned long long kmin, unsigned long long bstep,
                             unsigned long long nb, const void* probes,
                             long long p, void* out_off, void* out_size,
                             void* out_found, long long window_bytes,
                             long long max_persist, void* stream) {
  if (((uintptr_t)rows & 15) != 0 || p < 0 || window_bytes < 0 ||
      bad_geometry(n, kmin, bstep, nb))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  const long long blocks = (p + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  cudaStreamAttrValue attr = {};
  if (window_bytes > 0) {
    size_t limit = 0;
    if ((err = cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize)) != cudaSuccess)
      return (int)err;
    size_t want = (size_t)(window_bytes < max_persist ? window_bytes : max_persist);
    if (limit < want) {
      if ((err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, want)) != cudaSuccess)
        return (int)err;
      limit = want;
    }
    attr.accessPolicyWindow.base_ptr = const_cast<void*>(starts);
    attr.accessPolicyWindow.num_bytes = (size_t)window_bytes;
    attr.accessPolicyWindow.hitRatio =
        limit >= (size_t)window_bytes ? 1.0f : (float)limit / (float)window_bytes;
    attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    if ((err = cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr)) !=
        cudaSuccess)
      return (int)err;
  }
  bucket_search_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const ulonglong2*)rows, (const int*)starts, kmin, bstep, nb,
      (const unsigned long long*)probes, p, (uint32_t*)out_off,
      (uint32_t*)out_size, (uint8_t*)out_found);
  err = cudaGetLastError();
  if (window_bytes > 0) {
    attr.accessPolicyWindow.num_bytes = 0;
    const cudaError_t reset =
        cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr);
    if (err == cudaSuccess) err = reset;
  }
  return (int)err;
}

// The card's persisting L2 limits: the largest set-aside and the largest
// access policy window, in bytes. Returns 0, or the CUDA error code.
extern "C" int l2_persist_limits(int device, long long* max_persist,
                                 long long* max_window) {
  int persist = 0, window = 0;
  cudaError_t err = cudaDeviceGetAttribute(&persist, cudaDevAttrMaxPersistingL2CacheSize, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&window, cudaDevAttrMaxAccessPolicyWindowSize, device);
  *max_persist = persist;
  *max_window = window;
  return (int)err;
}

// Demotes every persisting L2 line of the current device to normal and
// sets its persisting set-aside back to 0. Returns 0, or the CUDA error code.
extern "C" int l2_persist_release(void) {
  cudaError_t err = cudaCtxResetPersistingL2Cache();
  if (err == cudaSuccess) err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
  return (int)err;
}

// Registers per thread of kernel A (which 0) or B (which 1) as loaded, or
// -1 on a CUDA error.
extern "C" int bucket_kernels_registers(int which) {
  cudaFuncAttributes a;
  const cudaError_t err = which == 0
                              ? cudaFuncGetAttributes(&a, index_buckets_kernel)
                              : cudaFuncGetAttributes(&a, bucket_search_kernel);
  return err == cudaSuccess ? a.numRegs : -1;
}
