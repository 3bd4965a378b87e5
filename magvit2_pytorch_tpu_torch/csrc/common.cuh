// Shared device routines for the port's kernels: dtype conversion, a block
// sum and the shared-memory address of a pointer. The row RMSNorm and the
// projection GEMMs live in gemm.cu. Built for sm_90a by
// ops/kernels/_build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#define MV2_CHECK_LAUNCH()                  \
  do {                                      \
    cudaError_t err_ = cudaGetLastError();  \
    if (err_ != cudaSuccess) return err_;   \
  } while (0)

namespace mv2 {

typedef __nv_bfloat16 bf16;

// dtype codes shared with ops/kernels/_build.py
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// v as the working dtype stores it
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// the 32-bit shared-memory address that PTX's .shared operands take
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Sum over the block; every thread gets the result. blockDim.x is a
// multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  __syncthreads();  // warp_sums may still be read from a previous call
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = lane < nwarps ? warp_sums[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace mv2
