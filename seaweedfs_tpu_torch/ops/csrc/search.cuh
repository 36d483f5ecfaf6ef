// The bounded lower-bound search over a u64 key column, used by
// ragged_lookup.cu's plane kernel (the K2 design that the 16-byte rows
// replaced, kept to be timed beside it), which reads keys, offsets and
// sizes from separate columns. (index_search.cu, K1, and ragged_lookup.cu's
// probe kernel search packed 16-byte rows with their own loops.)
//
// It replaces the body the JAX lookup programs share,
// seaweedfs_tpu/ops/index_kernel.py::_search_range_bounded: a fixed
// `steps`-round branchless binary search over (hi, lo) u32 key planes. On
// Hopper a thread compares 64-bit keys natively, so the key column is one
// u64 array, and the loop runs `while (lo < hi)` instead of a fixed count.
// The answers are the same: the JAX step counts are chosen to cover the
// widest row range a probe can get (index_kernel.py:173,
// ragged_lookup.py:223-231), so its loop has converged to the same lower
// bound by the time it stops, and the extra rounds it may run past
// convergence only ever move `lo` onto a row at or past the probe's range
// end, where `found` is false in both.

#pragma once

#include <stdint.h>

// First row in [lo, hi) whose key is >= key (hi when there is none).
__device__ __forceinline__ int lower_bound_u64(
    const unsigned long long* __restrict__ keys, int lo, int hi,
    unsigned long long key) {
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (__ldg(keys + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// found = lo < end and the key at min(lo, n - 1) equals the probe (the
// clamp keeps the read inside the column when lo == n).
__device__ __forceinline__ bool found_at(
    const unsigned long long* __restrict__ keys, int n, int lo, int end,
    unsigned long long key, int* idx) {
  *idx = lo < n - 1 ? lo : n - 1;
  return lo < end && __ldg(keys + *idx) == key;
}
