// K1: bulk needle-index lookup over one sorted snapshot, for sm_90a.
//
//   for each probe key k:  i = lower bound of k in keys[lo, hi)
//                          found = i < n && keys[i] == k
//                          off, size = found ? offsets[i], sizes[i] : 0
//
// Replaces seaweedfs_tpu/ops/index_kernel.py::_bulk_lookup (lo, hi = 0, n)
// and ::_bulk_lookup_bucketed, whose range is the probe's interpolation
// bucket [starts[b], starts[b + 1]). The JAX package computes the bucket
// on the host in u64 numpy (`_stage`, index_kernel.py:212-219) because TPU
// lanes are 32-bit; here each thread computes it from its u64 probe with
// the same arithmetic (b = (max(k, kmin) - kmin) / bstep, clamped to
// nb - 1), so the host pass and its upload are gone.
//
// One thread per probe. What bounds it on an H100: memory latency, not
// bandwidth or arithmetic. A probe is a chain of dependent loads (2 of
// `starts`, about log2 of its bucket's occupancy of `keys`, then one of
// `offsets` and one of `sizes`); over a table larger than the 50 MB L2
// (a full 29.5M-needle volume is 451 MiB of columns and 128 MiB of
// `starts`) each of those loads is a 32-byte sector from HBM. The bound
// chip_smoke.py reports counts only the bytes every probe must touch
// (its probe, its outputs, its final row and bucket bounds, each sector
// once), so the kernel's time sits well above it: the gap is the search
// chain. Interleaving several probes per thread to keep more loads in
// flight is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    index_search_kernel(const unsigned long long* __restrict__ keys,
                        const uint32_t* __restrict__ offs,
                        const uint32_t* __restrict__ sizes, int n,
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
  lo = lower_bound_u64(keys, lo, hi, key);
  int idx;
  const bool found = found_at(keys, n, lo, n, key, &idx);
  out_off[i] = found ? __ldg(offs + idx) : 0u;
  out_size[i] = found ? __ldg(sizes + idx) : 0u;
  out_found[i] = found ? 1 : 0;
}

}  // namespace

// Launches one kernel on `stream`; does not synchronise. `starts` is null
// for an unbucketed snapshot (then kmin, bstep and nb are not read).
// Returns 0, or the CUDA error code of the launch.
extern "C" int index_search(const void* keys, const void* offs,
                            const void* sizes, int n, const void* starts,
                            unsigned long long kmin, unsigned long long bstep,
                            unsigned long long nb, const void* probes,
                            long long p, void* out_off, void* out_size,
                            void* out_found, void* stream) {
  if (n < 1 || p < 0 || (starts != nullptr && (bstep == 0 || nb == 0)))
    return (int)cudaErrorInvalidValue;
  if (p == 0) return 0;
  const long long blocks = (p + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  index_search_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (const uint32_t*)offs,
      (const uint32_t*)sizes, n, (const int*)starts, kmin, bstep, nb,
      (const unsigned long long*)probes, p, (uint32_t*)out_off,
      (uint32_t*)out_size, (uint8_t*)out_found);
  return (int)cudaGetLastError();
}
