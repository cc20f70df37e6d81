// The 64-bit merge key of kernels B1 (splat_raster.cu) and B6
// (window_composite.cu).
//
// A sequential TPU composite keeps, at each pixel, the lexicographic maximum
// of (z, -seq) over the writes whose z beats the incoming depth (strict, so
// the incoming value wins ties and the first writer wins ties between
// writes). A 64-bit atomicMax on
//   key = order(z) << 32 | (0xFFFFFFFE - seq)
// computes the same maximum in any order, where order() maps f32 bits to an
// int32 of the same order; the incoming value's low bits are LOW_INIT, so no
// write's key can tie it. A decode pass turns the low bits back into seq.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned int LOW_INIT = 0xFFFFFFFFu;

__device__ __forceinline__ long long order_key(float f) {
  int b = __float_as_int(f);
  return (long long)(b >= 0 ? b : (b ^ 0x7FFFFFFF));
}

__device__ __forceinline__ float key_float(long long k) {
  // arithmetic floor of k / 2^32: the high 32 bits as a signed int
  int b = (int)(k >> 32);
  return __int_as_float(b >= 0 ? b : (b ^ 0x7FFFFFFF));
}

__device__ __forceinline__ long long make_key(float z, unsigned int low) {
  unsigned long long hi = (unsigned long long)order_key(z) << 32;
  return (long long)(hi | (unsigned long long)low);
}

// key[i] = the incoming depth's key; where `neg` is given (B1), also
// *neg = 1 if a depth is below 0 (*neg zeroed before)
__global__ void init_keys(const float* __restrict__ depth,
                          long long* __restrict__ key, int n,
                          int* __restrict__ neg) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  key[i] = make_key(depth[i], LOW_INIT);
  if (neg != nullptr && depth[i] < 0.0f) *neg = 1;
}

}  // namespace
