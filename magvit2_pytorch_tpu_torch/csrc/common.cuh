// Shared device routines for the port's kernels: dtype conversion, a block
// sum, a row RMSNorm and a shared-memory tiled GEMM with float32
// accumulation (CUDA-core FMAs for float32, tensor cores for bf16). Built
// for sm_90a by ops/kernels/_build.py.
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

// out[r] = T(x[r] / ||x[r]|| * sqrt(C)) * gamma, one block per row: the norm
// in float32, cast to the working dtype, then the gamma multiply in it
// (ops/pallas/axial_attention.py:38-43, taylor_attention.py:63-70).
template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ gamma,
                               T* __restrict__ out, int C) {
  const T* xr = x + (size_t)blockIdx.x * C;
  T* orow = out + (size_t)blockIdx.x * C;
  float ss = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = to_f32(xr[c]);
    ss += v * v;
  }
  ss = block_sum(ss);
  const float scale = sqrtf((float)C) / sqrtf(fmaxf(ss, 1e-24f));
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float n = round_to<T>(to_f32(xr[c]) * scale);
    orow[c] = from_f32<T>(n * to_f32(gamma[c]));
  }
}

constexpr int kRmsThreads = 256;

template <typename T>
cudaError_t launch_rmsnorm(const T* x, const T* gamma, T* out, int rows,
                           int C, cudaStream_t stream) {
  rmsnorm_kernel<T><<<rows, kRmsThreads, 0, stream>>>(x, gamma, out, C);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// C[M, N] = A[M, K] W[N, K]^T (the nn.Linear layout), float32 accumulate.
// The float32 path: 64x64 output tile per block of 256 threads, 4x4 outputs
// a thread, K in steps of 16 through shared memory, CUDA-core FMAs (no TF32,
// so results differ from float32 references only by summation order).
// static: this header is compiled into every .cu file.
constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 16, kGemmThreads = 256;

static __global__ void __launch_bounds__(kGemmThreads)
    gemm_nt_f32_kernel(const float* __restrict__ A,
                       const float* __restrict__ W, float* __restrict__ C,
                       int M, int N, int K) {
  __shared__ float As[kGemmBK][kGemmBM + 4];
  __shared__ float Ws[kGemmBK][kGemmBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kGemmBM, col0 = blockIdx.y * kGemmBN;
  // loader: thread -> (tile row lr, four consecutive k from lk)
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const int ar = row0 + lr, wr = col0 + lr;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGemmBK) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + lk + u;
      As[lk + u][lr] = (ar < M && k < K) ? A[(size_t)ar * K + k] : 0.f;
      Ws[lk + u][lr] = (wr < N && k < K) ? W[(size_t)wr * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * w[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) C[(size_t)r * N + c] = acc[i][j];
    }
  }
}

// The bf16 path on the tensor cores (warp-level mma.sync through WMMA):
// same 64x64 output tile, K in steps of 32 through shared memory, four warps
// with 32x32 each (2x2 fragments of 16x16x16), float32 accumulators staged
// through shared memory for the bounds-checked epilogue, which casts once
// to OutT (bf16, or float32 for the Taylor qkv).
constexpr int kWmmaBK = 32, kWmmaThreads = 128;
constexpr int kWmmaLd = kWmmaBK + 8;      // bf16 row stride, multiple of 8
constexpr int kWmmaCLd = kGemmBN + 4;     // float row stride, multiple of 4

template <typename OutT>
__global__ void __launch_bounds__(kWmmaThreads)
    gemm_nt_wmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                        OutT* __restrict__ C, int M, int N, int K) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[kGemmBM][kWmmaLd];
  __shared__ __align__(32) bf16 Ws[kGemmBN][kWmmaLd];
  __shared__ __align__(32) float Cs[kGemmBM][kWmmaCLd];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int row0 = blockIdx.x * kGemmBM, col0 = blockIdx.y * kGemmBN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const bf16 zero = __float2bfloat16(0.f);
  // 16-byte loads of 8 bf16 when every row starts 16-byte aligned
  const bool vec = (K % 8 == 0) && ((uintptr_t)A % 16 == 0) &&
                   ((uintptr_t)W % 16 == 0);

  for (int k0 = 0; k0 < K; k0 += kWmmaBK) {
    if (vec) {
      for (int idx = tid; idx < kGemmBM * kWmmaBK / 8; idx += kWmmaThreads) {
        const int r = idx / (kWmmaBK / 8), c = (idx % (kWmmaBK / 8)) * 8;
        const int k = k0 + c;  // K % 8 == 0: all 8 in range or none
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(&As[r][c]) =
            (row0 + r < M && k < K)
                ? *reinterpret_cast<const uint4*>(A + (size_t)(row0 + r) * K + k)
                : z;
        *reinterpret_cast<uint4*>(&Ws[r][c]) =
            (col0 + r < N && k < K)
                ? *reinterpret_cast<const uint4*>(W + (size_t)(col0 + r) * K + k)
                : z;
      }
    } else {
      for (int idx = tid; idx < kGemmBM * kWmmaBK; idx += kWmmaThreads) {
        const int r = idx / kWmmaBK, c = idx % kWmmaBK, k = k0 + c;
        As[r][c] = (row0 + r < M && k < K) ? A[(size_t)(row0 + r) * K + k] : zero;
        Ws[r][c] = (col0 + r < N && k < K) ? W[(size_t)(col0 + r) * K + k] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWmmaBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], kWmmaLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // W^T as a column-major (k, n) tile
        wmma::load_matrix_sync(b[j], &Ws[wn + 16 * j][kk], kWmmaLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              kWmmaCLd, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kGemmBM * kGemmBN; idx += kWmmaThreads) {
    const int r = row0 + idx / kGemmBN, c = col0 + idx % kGemmBN;
    if (r < M && c < N)
      C[(size_t)r * N + c] = from_f32<OutT>(Cs[idx / kGemmBN][idx % kGemmBN]);
  }
}

inline dim3 gemm_grid(int M, int N) {
  return dim3((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN);
}

inline cudaError_t launch_gemm_nt(const float* A, const float* W, float* C,
                                  int M, int N, int K, cudaStream_t stream) {
  gemm_nt_f32_kernel<<<gemm_grid(M, N), kGemmThreads, 0, stream>>>(A, W, C,
                                                                   M, N, K);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <typename OutT>
cudaError_t launch_gemm_nt(const bf16* A, const bf16* W, OutT* C, int M,
                           int N, int K, cudaStream_t stream) {
  gemm_nt_wmma_kernel<OutT><<<gemm_grid(M, N), kWmmaThreads, 0, stream>>>(
      A, W, C, M, N, K);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace mv2
