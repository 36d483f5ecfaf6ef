// K2: one ragged gate wakeup answered in one launch, for sm_90a.
//
// Replaces seaweedfs_tpu/ops/ragged_lookup.py::_ragged_dispatch. The
// generation's resident columns are the sealed runs of many volumes,
// concatenated with page-aligned bases; each probe slot (one key against
// one run) carries its own coordinates in two host-packed planes:
//
//   u32p [4, P]: key hi, key lo, bloom mask 0, bloom mask 1
//   i32p [5, P]: row lo, row hi (the run's interpolation bucket, absolute),
//                end (the run's exclusive end row), bloom word 0, word 1
//
//   present = (bloom[w0] & m0) == m0 && (bloom[w1] & m1) == m1
//             (a mask of 0 means the run has no filter: always present;
//             word 0 of `bloom` is a sentinel such probes address)
//   i       = present ? lower bound of the key in keys[lo, hi) : lo
//   found   = present && i < end && keys[min(i, n - 1)] == key
//
// `end` keeps a search that walks off its run's last row from matching an
// equal key at the start of the next run (or key 0 in the zero rows that
// pad a run to its page and the generation to a power of two).
//
// One thread per probe slot. Bound on an H100: as K1, dependent loads
// (two bloom words, then the search chain over the run's bucket); a probe
// the bloom filter rejects stops after its two bloom loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    ragged_lookup_kernel(const unsigned long long* __restrict__ keys,
                         const uint32_t* __restrict__ offs,
                         const uint32_t* __restrict__ sizes, int n,
                         const uint32_t* __restrict__ bloom,
                         const uint32_t* __restrict__ u32p,
                         const int* __restrict__ i32p, int p,
                         uint32_t* __restrict__ out_off,
                         uint32_t* __restrict__ out_size,
                         uint8_t* __restrict__ out_found) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
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

// Launches one kernel on `stream`; does not synchronise. The planes are
// row-major [4, p] and [5, p]. Returns 0, or the CUDA error of the launch.
extern "C" int ragged_lookup(const void* keys, const void* offs,
                             const void* sizes, int n, const void* bloom,
                             const void* u32p, const void* i32p, int p,
                             void* out_off, void* out_size, void* out_found,
                             void* stream) {
  if (n < 1 || p < 0) return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  const int blocks = (int)(((long long)p + kThreads - 1) / kThreads);
  ragged_lookup_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (const uint32_t*)offs,
      (const uint32_t*)sizes, n, (const uint32_t*)bloom,
      (const uint32_t*)u32p, (const int*)i32p, p, (uint32_t*)out_off,
      (uint32_t*)out_size, (uint8_t*)out_found);
  return (int)cudaGetLastError();
}
