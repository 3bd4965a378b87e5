// int8 inference convs: K1 quantizes an activation to int8 (per-tensor
// scale), K2 runs the conv s8 x s8 -> s32 on the tensor cores and
// dequantizes in its epilogue. Replaces the int8 branches of the JAX
// package's convs, which XLA lowers on the TPU
// (magvit2_pytorch_tpu/ops/conv.py _quantize_per_tensor :87-93, the
// CausalConv3d branch :521-571, Conv3d1x1 :620-650; ops/resample.py
// SpatialDownsample2x :73-101, SpatialUpsample2x :216-227); none of them
// is a Pallas kernel. See ops/kernels/int8.py for the math and the cast
// points.
//
// K1 mv2_quantize_s8: with no scale given, absmax over the tensor (a grid
//   reduction: a block max each, then an atomicMax on the float's bits,
//   which orders like the float for values >= 0 and so does not depend on
//   the order of the blocks) and s = max(absmax, 1e-12) / 127 in float32;
//   then q = clip(rint(x / s), -127, 127), IEEE division and round half to
//   even (__float2int_rn), as jnp.round(x / s) rounds. Bound: bytes (reads
//   x twice when dynamic, writes a byte an element).
//
// K2 mv2_conv_s8: an implicit GEMM, M = output pixels (b, t, ho, wo),
//   N = output columns, K = kt * kh * kw * C tap-major (k = tap * C + c,
//   tap = (dt * kh + dh) * kw + dw) against the weight re-laid as (N, K)
//   int8. The causal conv's kt - 1 frames in front and the spatial pad
//   kh // 2, kw // 2 are zero taps folded into the index math: a 16-byte
//   chunk whose tap falls outside the clip is zero-filled by cp.async (a
//   zero quantizes to 0, so this is the padded conv), and no tap reaches
//   into the previous batch element. Strides (1, s, s). A 128 x 128 block
//   tile, 8 warps of 64 x 32, 64 bytes of K a stage in a 4-stage cp.async
//   ring (two blocks an SM, 128 registers a thread; the fastest of the
//   tiles tools/int8_conv_variants.py times), ldmatrix fragments and
//   mma.sync.m16n8k32 s8 with s32 accumulators in registers; where
//   C % 64 == 0 a stage lies in one tap, walked without a division. The epilogue forms s = xs * ks[n]
//   in float32 first (as JAX forms xs * ks), then T(float(acc) * s) with
//   one rounding, then adds T(bias) as PyTorch adds two tensors of dtype T
//   (in float32, one rounding), and stores column pairs. Modes: 0 the
//   output (B, T, Ho, Wo, N); 1 depth-to-space, columns in (p1, p2, c)
//   order to pixel (2 h + p1, 2 w + p2), channel c, of (B, T, 2 Ho, 2 Wo,
//   N / 4) (the spatial upsampler; its bias is the position's own); 2 the
//   raw int32 accumulators (M, N), a debug entry that chip_smoke.py holds
//   exactly against the plain version.
//   Bound: operations at the flagship's unit convs (2 * 27 C^2 per output
//   pixel over 1,979 dense int8 TOP/s), bytes at the 1x1s and resamplers.
//   This is the simple kernel: wgmma with s8 operands and TMA (B4's conv
//   pipeline, residual_unit.cu) are later work.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace mv2 {

// ---- K1 --------------------------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr int kQuantMaxBlocks = 1056;  // 8 blocks on each of 132 SMs

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(h);
    v[2 * i + 1] = __high2float(h);
  }
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    absmax_kernel(const T* __restrict__ x, long long n,
                  unsigned* __restrict__ amax_bits) {
  float m = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long groups = n / 8;
  for (long long i = start; i < groups; i += stride) {
    float v[8];
    load8(x + i * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  for (long long i = groups * 8 + start; i < n; i += stride)
    m = fmaxf(m, fabsf(to_f32(x[i])));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kQuantThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax_bits, __float_as_uint(m));
  }
}

__device__ __forceinline__ int quantize1(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(127, max(-127, q));
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_kernel(const T* __restrict__ x, long long n,
                    const float* __restrict__ scale_in,
                    const unsigned* __restrict__ amax_bits,
                    float* __restrict__ scale_out, int8_t* __restrict__ q) {
  const float s =
      scale_in ? *scale_in
               : __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-12f), 127.f);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (start == 0 && scale_out) *scale_out = s;
  const long long groups = n / 8;
  for (long long i = start; i < groups; i += stride) {
    float v[8];
    load8(x + i * 8, v);
    unsigned packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      packed[j / 4] |= (unsigned)(quantize1(v[j], s) & 0xff) << (8 * (j % 4));
    reinterpret_cast<uint2*>(q)[i] = make_uint2(packed[0], packed[1]);
  }
  for (long long i = groups * 8 + start; i < n; i += stride)
    q[i] = (int8_t)quantize1(to_f32(x[i]), s);
}

template <typename T>
cudaError_t launch_quantize(const T* x, long long n, const float* scale_in,
                            unsigned* amax, float* scale_out, int8_t* q,
                            cudaStream_t stream) {
  if (((uintptr_t)x % 16) || ((uintptr_t)q % 8) || n < 0)
    return cudaErrorInvalidValue;
  const long long want = (n / 8 + kQuantThreads - 1) / kQuantThreads;
  const int blocks = (int)std::max(1LL, std::min<long long>(want,
                                                            kQuantMaxBlocks));
  if (!scale_in) {
    if (!amax || !scale_out) return cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    absmax_kernel<T><<<blocks, kQuantThreads, 0, stream>>>(x, n, amax);
    MV2_CHECK_LAUNCH();
  }
  quantize_kernel<T><<<blocks, kQuantThreads, 0, stream>>>(
      x, n, scale_in, amax, scale_out, q);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// ---- K2 --------------------------------------------------------------------

constexpr int kS8BM = 128;     // block tile rows (output pixels)
constexpr int kS8BN = 128;     // block tile columns
constexpr int kS8BK = 64;      // K bytes a stage
constexpr int kS8Stages = 4;   // the cp.async ring
constexpr int kS8WarpsM = kS8BM / 64, kS8WarpsN = kS8BN / 32;  // 64 x 32 each
constexpr int kS8Threads = 32 * kS8WarpsM * kS8WarpsN;
constexpr int kS8Row = kS8BK + 16;  // padded: ldmatrix without conflicts
constexpr int kS8ATile = kS8BM * kS8Row, kS8BTile = kS8BN * kS8Row;
constexpr int kS8StageBytes = kS8ATile + kS8BTile;
constexpr int kS8Smem = kS8Stages * kS8StageBytes;
// 16-byte chunks of one row a thread loads a stage, of A and of B
constexpr int kS8AChunks = kS8BK / 16 / (kS8Threads / kS8BM);
constexpr int kS8BChunks = kS8BK / 16 / (kS8Threads / kS8BN);
constexpr int kS8Blocks = 232448 / kS8Smem;  // blocks an SM
static_assert(kS8Threads % kS8BM == 0 && kS8Threads % kS8BN == 0 &&
                  kS8AChunks >= 1 && kS8BChunks >= 1,
              "whole rows of A and B split among the threads");
static_assert(kS8Blocks >= 1 && kS8Blocks * kS8Threads <= 2048,
              "the ring fits an SM");

// ops/kernels/int8.py MODES
enum S8Mode { kS8Out = 0, kS8DepthToSpace = 1, kS8Raw = 2 };

struct S8Conv {
  const int8_t* x;  // (B, T, H, W, C)
  const int8_t* w;  // (N, K)
  const float* xs;  // the activation scale, 0-d
  const float* ks;  // (N,) the column scales
  const void* bias;  // (N,) in the output dtype, or null
  void* out;
  int B, T, H, W, C, N, kt, kh, kw, stride, Ho, Wo, mode;
  long long M, K;
};

__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where a 16-byte chunk of an A row reads: its channel offset c and its
// tap's (dt, dh, dw). kUniform (C % kS8BK == 0): a stage lies in one tap,
// walked from stage to stage without a division (next: c reaches C
// exactly, then the tap advances).
struct TapWalk {
  int c, dt, dh, dw;
  __device__ __forceinline__ void at(long long k, const S8Conv& p) {
    const int tap = (int)(k / p.C);
    c = (int)(k - (long long)tap * p.C);
    dw = tap % p.kw;
    dh = (tap / p.kw) % p.kh;
    dt = tap / (p.kw * p.kh);
  }
  __device__ __forceinline__ void next(const S8Conv& p) {  // k += kS8BK
    c += kS8BK;
    if (c < p.C) return;
    c = 0;
    if (++dw < p.kw) return;
    dw = 0;
    if (++dh < p.kh) return;
    dh = 0;
    ++dt;
  }
};

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float v0, float v1,
                                           const float (&s)[2],
                                           const float (&bias)[2],
                                           bool has_bias, bool pair) {
  // T(float(acc) * s), then + T(bias) as PyTorch adds two T tensors
  T o0 = from_f32<T>(__fmul_rn(v0, s[0]));
  T o1 = from_f32<T>(__fmul_rn(v1, s[1]));
  if (has_bias) {
    o0 = from_f32<T>(__fadd_rn(to_f32(o0), bias[0]));
    o1 = from_f32<T>(__fadd_rn(to_f32(o1), bias[1]));
  }
  if (pair) {
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162 v;
      v.x = o0;
      v.y = o1;
      *reinterpret_cast<__nv_bfloat162*>(dst) = v;
    } else {
      *reinterpret_cast<float2*>(dst) = make_float2(o0, o1);
    }
  } else {
    dst[0] = o0;
  }
}

template <typename T, bool kUniform>
__global__ void __launch_bounds__(kS8Threads, kS8Blocks)
    conv_s8_kernel(const S8Conv p) {
  extern __shared__ __align__(16) int8_t s8_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp / kS8WarpsN, warp_n = warp % kS8WarpsN;
  const long long m0 = (long long)blockIdx.x * kS8BM;
  const int n0 = blockIdx.y * kS8BN;

  // this thread loads consecutive 16-byte chunks of one row of A (an
  // output pixel) and of one row of B (an output column) a stage
  const int row = tid / (kS8Threads / kS8BM);
  const int chunk0 = tid % (kS8Threads / kS8BM) * kS8AChunks;
  const int brow = tid / (kS8Threads / kS8BN);
  const int bchunk0 = tid % (kS8Threads / kS8BN) * kS8BChunks;
  const long long m = m0 + row;
  const bool m_ok = m < p.M;
  int t = 0, h0 = 0, w0 = 0;
  long long b = 0;
  if (m_ok) {
    const int wo = (int)(m % p.Wo);
    long long r = m / p.Wo;
    const int ho = (int)(r % p.Ho);
    r /= p.Ho;
    t = (int)(r % p.T);
    b = r / p.T;
    h0 = ho * p.stride - p.kh / 2;
    w0 = wo * p.stride - p.kw / 2;
  }
  // x at (b, t - (kt - 1), h0, w0, 0): a tap (dt, dh, dw) and channel c
  // add ((dt * H + dh) * W + dw) * C + c
  const long long a_base =
      (((b * p.T + t - (p.kt - 1)) * p.H + h0) * (long long)p.W + w0) * p.C;
  const int n = n0 + brow;
  const bool n_ok = n < p.N;
  const int8_t* b_row = p.w + (long long)(n_ok ? n : 0) * p.K;

  TapWalk walk;  // kUniform: the tap of the stage's first byte of K
  walk.at(0, p);

  auto load_stage = [&](int stage, long long k0) {
    int8_t* sa = s8_smem + stage * kS8StageBytes + row * kS8Row;
    int8_t* sb = s8_smem + stage * kS8StageBytes + kS8ATile + brow * kS8Row;
#pragma unroll
    for (int j = 0; j < kS8AChunks; ++j) {
      const long long k = k0 + (chunk0 + j) * 16;
      const bool k_ok = k < p.K;
      TapWalk w;
      if (kUniform) {
        w = walk;
        w.c += (chunk0 + j) * 16;
      } else {
        w.at(k_ok ? k : 0, p);
      }
      const int ti = t + w.dt - (p.kt - 1), hi = h0 + w.dh, wi = w0 + w.dw;
      const bool a_ok = m_ok && k_ok && ti >= 0 && hi >= 0 && hi < p.H &&
                        wi >= 0 && wi < p.W;
      const long long off =
          a_base + (((long long)w.dt * p.H + w.dh) * p.W + w.dw) * p.C + w.c;
      cp_async16(sa + (chunk0 + j) * 16, a_ok ? p.x + off : p.x, a_ok);
    }
#pragma unroll
    for (int j = 0; j < kS8BChunks; ++j) {
      const long long k = k0 + (bchunk0 + j) * 16;
      const bool b_ok = n_ok && k < p.K;
      cp_async16(sb + (bchunk0 + j) * 16, b_ok ? b_row + k : p.w, b_ok);
    }
    if (kUniform) walk.next(p);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const long long ktiles = (p.K + kS8BK - 1) / kS8BK;
#pragma unroll
  for (int s = 0; s < kS8Stages - 1; ++s) {
    if (s < ktiles) load_stage(s, (long long)s * kS8BK);
    cp_async_commit();
  }

  int stage = 0;
  for (long long kk = 0; kk < ktiles; ++kk) {
    cp_async_wait<kS8Stages - 2>();
    __syncthreads();  // the stage refilled below was read last iteration
    const long long next = kk + kS8Stages - 1;
    if (next < ktiles)
      load_stage((stage + kS8Stages - 1) % kS8Stages, next * kS8BK);
    cp_async_commit();

    const int8_t* sa = s8_smem + stage * kS8StageBytes;
    const int8_t* sb = sa + kS8ATile;
#pragma unroll
    for (int ks = 0; ks < kS8BK; ks += 32) {
      unsigned a[4][4], bq[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = warp_m * 64 + mi * 16 + lane % 16;
        ldmatrix_x4(a[mi], sa + r * kS8Row + ks + (lane / 16) * 16);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int r = warp_n * 32 + nj * 16 + (lane / 16) * 8 + lane % 8;
        unsigned v[4];
        ldmatrix_x4(v, sb + r * kS8Row + ks + ((lane / 8) % 2) * 16);
        bq[2 * nj][0] = v[0];
        bq[2 * nj][1] = v[1];
        bq[2 * nj + 1][0] = v[2];
        bq[2 * nj + 1][1] = v[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8_16832(acc[mi][ni], a[mi], bq[ni][0], bq[ni][1]);
    }
    stage = (stage + 1) % kS8Stages;
  }
  cp_async_wait<0>();

  // epilogue: C fragment rows g and g + 8, columns 2 tig and 2 tig + 1
  const int g = lane / 4, tig = lane % 4;
  if (p.mode == kS8Raw) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long mm = m0 + warp_m * 64 + mi * 16 + g + half * 8;
        if (mm >= p.M) continue;
        int* dst = reinterpret_cast<int*>(p.out) + mm * p.N;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + warp_n * 32 + ni * 8 + tig * 2;
          if (col < p.N) dst[col] = acc[mi][ni][half * 2];
          if (col + 1 < p.N) dst[col + 1] = acc[mi][ni][half * 2 + 1];
        }
      }
    return;
  }
  // s = xs * ks[n] (the product first, as JAX forms xs * ks) and T(bias[n])
  const float xs = *p.xs;
  const bool has_bias = p.bias != nullptr;
  float scale[4][2], bias[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + warp_n * 32 + ni * 8 + tig * 2 + e;
      const bool ok = col < p.N;
      scale[ni][e] = ok ? __fmul_rn(xs, p.ks[col]) : 0.f;
      bias[ni][e] = ok && has_bias
                        ? to_f32(reinterpret_cast<const T*>(p.bias)[col])
                        : 0.f;
    }
  T* out = reinterpret_cast<T*>(p.out);
  const bool even_n = p.N % 2 == 0;
  const int cd = p.N / 4;  // depth-to-space: columns (p1, p2, c)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long mm = m0 + warp_m * 64 + mi * 16 + g + half * 8;
      if (mm >= p.M) continue;
      long long bt = 0;
      int h = 0, w = 0;
      if (p.mode == kS8DepthToSpace) {
        w = (int)(mm % p.Wo);
        const long long r = mm / p.Wo;
        h = (int)(r % p.Ho);
        bt = r / p.Ho;
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + warp_n * 32 + ni * 8 + tig * 2;
        if (col >= p.N) continue;
        const int* v = &acc[mi][ni][half * 2];
        const float f0 = __int2float_rn(v[0]), f1 = __int2float_rn(v[1]);
        if (p.mode == kS8Out) {
          T* dst = out + mm * p.N + col;
          if (even_n) {  // col + 1 < N too
            store_pair<T>(dst, f0, f1, scale[ni], bias[ni], has_bias, true);
          } else {
            store_pair<T>(dst, f0, f1, scale[ni], bias[ni], has_bias, false);
            if (col + 1 < p.N) {
              const float s1[2] = {scale[ni][1], 0.f};
              const float b1[2] = {bias[ni][1], 0.f};
              store_pair<T>(dst + 1, f1, 0.f, s1, b1, has_bias, false);
            }
          }
        } else {  // cd % 2 == 0: the pair is (c, c + 1) of one position
          const int q = col / cd, c = col - q * cd;
          T* dst = out + ((bt * 2 * p.Ho + 2 * h + q / 2) * (2LL * p.Wo) +
                          2 * w + q % 2) * cd + c;
          store_pair<T>(dst, f0, f1, scale[ni], bias[ni], has_bias, true);
        }
      }
    }
}

template <typename T, bool kUniform>
cudaError_t launch_conv_s8_tiles(const S8Conv& p, cudaStream_t stream) {
  static bool configured = false;  // the attribute, once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv_s8_kernel<T, kUniform>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kS8Smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long mtiles = (p.M + kS8BM - 1) / kS8BM;
  if (mtiles > 0x7fffffffLL || mtiles == 0) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)mtiles, (p.N + kS8BN - 1) / kS8BN);
  conv_s8_kernel<T, kUniform><<<grid, kS8Threads, kS8Smem, stream>>>(p);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_conv_s8(const S8Conv& p, cudaStream_t stream) {
  if (p.C % 16 || ((uintptr_t)p.x % 16) || ((uintptr_t)p.w % 16) ||
      ((uintptr_t)p.out % 8) || p.stride < 1 || p.N < 1 ||
      (p.mode == kS8DepthToSpace && p.N % 8))
    return cudaErrorInvalidValue;
  if (p.mode != kS8Raw && (!p.xs || !p.ks)) return cudaErrorInvalidValue;
  if (p.C % kS8BK == 0) return launch_conv_s8_tiles<T, true>(p, stream);
  return launch_conv_s8_tiles<T, false>(p, stream);
}

}  // namespace mv2

extern "C" {

// q = K1(x); scale_in null: the dynamic path (absmax into the 4-byte
// scratch amax, the scale written to scale_out)
int mv2_quantize_s8(const void* x, int dtype, long long n,
                    const void* scale_in, void* amax, void* scale_out,
                    void* q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sin = static_cast<const float*>(scale_in);
  unsigned* am = static_cast<unsigned*>(amax);
  float* sout = static_cast<float*>(scale_out);
  int8_t* qq = static_cast<int8_t*>(q);
  if (dtype == mv2::kFloat32)
    return mv2::launch_quantize((const float*)x, n, sin, am, sout, qq, s);
  if (dtype == mv2::kBFloat16)
    return mv2::launch_quantize((const mv2::bf16*)x, n, sin, am, sout, qq,
                                s);
  return cudaErrorInvalidValue;
}

// K2 on x (B, T, H, W, C) int8 and w (N, kt * kh * kw * C) int8; dtype is
// the output's (mode 2 writes int32 and ignores it)
int mv2_conv_s8(const void* x, const void* w, const void* xs, const void* ks,
                const void* bias, void* out, int dtype, int B, int T, int H,
                int W, int C, int N, int kt, int kh, int kw, int stride,
                int mode, void* stream) {
  mv2::S8Conv p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.xs = static_cast<const float*>(xs);
  p.ks = static_cast<const float*>(ks);
  p.bias = bias;
  p.out = out;
  p.B = B; p.T = T; p.H = H; p.W = W; p.C = C; p.N = N;
  p.kt = kt; p.kh = kh; p.kw = kw; p.stride = stride; p.mode = mode;
  if (stride < 1 || kh < 1 || kw < 1 || kt < 1) return cudaErrorInvalidValue;
  p.Ho = (H + 2 * (kh / 2) - kh) / stride + 1;
  p.Wo = (W + 2 * (kw / 2) - kw) / stride + 1;
  p.M = (long long)B * T * p.Ho * p.Wo;
  p.K = (long long)kt * kh * kw * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == mv2::kS8Raw || dtype == mv2::kFloat32)
    return mv2::launch_conv_s8<float>(p, s);
  if (dtype == mv2::kBFloat16) return mv2::launch_conv_s8<mv2::bf16>(p, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
