// K1: bulk needle-index lookup over one sorted snapshot, for sm_90a.
//
//   for each probe key k:  i = lower bound of k in keys[lo, hi)
//                          found = i < n && keys[i] == k
//                          off, size = found ? offsets[i], sizes[i] : 0
//
// Replaces seaweedfs_tpu/ops/index_kernel.py::_bulk_lookup (:36-42; lo,
// hi = 0, n) and ::_bulk_lookup_bucketed (:80-86), whose range is the
// probe's interpolation bucket [starts[b], starts[b + 1]); both run the
// fixed-step search _search_range_bounded (:52-77). The JAX package
// computes the bucket on the host in u64 numpy because TPU lanes are
// 32-bit; here each thread computes it from its u64 probe with the same
// arithmetic (b = (max(k, kmin) - kmin) / bstep, clamped to nb - 1).
//
// The table is one 16-byte row per entry (IndexSnapshot.rows): word 0 the
// key's u64 bits, word 1 the offset in its low and the size in its high
// 32 bits. Each search step is one 16-byte load of a row, which brings the
// key to compare and the row's payload together.
//
// What bounds it on an H100: dependent random loads, not bandwidth or
// arithmetic. Over a full 29.5M-needle volume (451 MiB of rows and a
// 128 MiB `starts` table, far above the 50 MB L2) a probe is a chain of
// two round trips to HBM: `starts[b]` and `starts[b + 1]` (one 32-byte
// sector, two for about 1 probe in 8), then its bucket's rows, which at
// about 0.9 rows per bucket is usually one row, one sector. That is about
// 2.1 random sectors per probe. The column layout this replaced read the
// key column, then the key again and the offset and size from two more
// columns: about 3.9 sectors on a chain of three round trips.
//
// The design keeps that chain short:
//  - the answer is the last row the search compared >= the probe, held in
//    registers, so no load follows the search. The lower bound is the row
//    where the search last stepped left (hi = mid): after that step lo
//    only rises until lo == hi. If the search never stepped left, the lower
//    bound is the range end and the probe is absent: the rows at and after
//    starts[b + 1] hold keys >= that bucket boundary, kmin + (b + 1) * bstep,
//    which is above every probe of bucket b; the clamped last bucket ends
//    at n, as does the unbucketed range (starts == nullptr). The JAX step
//    counts cover the widest range (search.cuh gives that argument), so
//    the answers equal the fixed-step search's, whose `found` reads the key
//    at the lower bound; chip_smoke.py holds them equal on edge tables
//    (empty, one-row and 64-row buckets, keys 0 and 2^64 - 1, top-bit keys,
//    4,095 rows, a span too wide to bucket) and on 10M probes;
//  - one probe per thread at 256 threads a block keeps the card full of
//    independent chains: the kernel takes 22 registers
//    (index_search_registers), so every SM holds 2,048 threads (about
//    270K in flight), more than HBM's latency needs. The u64 divide for
//    the bucket stays: it is not what limits.
//
// Measured (chip_smoke.py phase 8, NVIDIA H100 80GB HBM3, 700.00 W power
// limit), 29,565,112 entries and 10M probes, bucketed: 0.715-0.727 ms of
// profiler device time against a 0.157 ms bytes bound for these rows
// (about 22 %); the column layout this replaced took 1.50-1.54 ms in the
// same runs. PERF.md keeps the numbers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    index_search_kernel(const ulonglong2* __restrict__ rows, int n,
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
  int lo = 0;
  int hi = n;
  if (starts != nullptr) {
    const unsigned long long q = key > kmin ? key : kmin;
    unsigned long long b = (q - kmin) / bstep;
    if (b > nb - 1) b = nb - 1;
    lo = __ldg(starts + b);
    hi = __ldg(starts + b + 1);
  }
  // the last row compared >= key; ~key never equals key, so a search that
  // never stepped left reads as absent
  ulonglong2 last = make_ulonglong2(~key, 0ull);
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
  const bool found = last.x == key;
  out_off[i] = found ? (uint32_t)last.y : 0u;
  out_size[i] = found ? (uint32_t)(last.y >> 32) : 0u;
  out_found[i] = found ? 1 : 0;
}

}  // namespace

// Launches one kernel on `stream`; does not synchronise. `rows` is the
// 16-byte aligned [n, 2] table; `starts` is null for an unbucketed
// snapshot (then kmin, bstep and nb are not read). Returns 0, or the CUDA
// error code of the launch.
extern "C" int index_search(const void* rows, int n, const void* starts,
                            unsigned long long kmin, unsigned long long bstep,
                            unsigned long long nb, const void* probes,
                            long long p, void* out_off, void* out_size,
                            void* out_found, void* stream) {
  if (n < 1 || p < 0 || ((uintptr_t)rows & 15) != 0 ||
      (starts != nullptr && (bstep == 0 || nb == 0)))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  const long long blocks = (p + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  index_search_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const ulonglong2*)rows, n, (const int*)starts, kmin, bstep, nb,
      (const unsigned long long*)probes, p, (uint32_t*)out_off,
      (uint32_t*)out_size, (uint8_t*)out_found);
  return (int)cudaGetLastError();
}

// Registers per thread of the kernel as loaded, or -1 on a CUDA error.
extern "C" int index_search_registers(void) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, index_search_kernel) != cudaSuccess) return -1;
  return a.numRegs;
}
