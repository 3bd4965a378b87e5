// Second-order Taylor linear attention block. Replaces the TPU kernel
// magvit2_pytorch_tpu/ops/pallas/taylor_attention.py _taylor_kernel /
// _taylor_frame; see ops/kernels/taylor_attention.py for the math and the
// design note.
//
// The wrapper makes four launches on scratch it allocates; the first, second
// and fourth are gemm.cu's, the third is this file's:
//   xn   = RMSNorm(x) * gamma                                 (B*N, C)
//   qkv  = xn Wqkv^T, float32                                 (B*N, 3*H*d)
//   attn = per (frame, head): moments over N, then per token  (B*N, H*d)
//   out  = attn Wout^T                                        (B*N, C)
#include "common.cuh"

namespace mv2 {

constexpr int kTaylorThreads = 256;
constexpr int kTaylorTile = 128;  // tokens staged in shared memory at a time

// Moments of one (frame, head), in this order in shared memory:
//   A0[e] = sum v_e                       d
//   A1[i][e] = sum k_i v_e                d*d
//   A2[i][j][e] = sum k_i k_j v_e / sqrt2 d*d*d
//   sk[i] = sum k_i                       d
//   skk[i][j] = sum k_i k_j / sqrt2       d*d
// Each is sum_n f[a] f[b] f[c] * coef over the token features
// f = [1, k_0..k_{d-1}, v_0..v_{d-1}] (f[0] = 0 for padding tokens).
template <int D>
__device__ __forceinline__ void moment_terms(int o, int& a, int& b, int& c,
                                             float& coef) {
  const float kInvSqrt2 = 0.70710678118654752f;
  const int K = 1, V = 1 + D;
  coef = 1.f;
  if (o < D) {  // A0
    a = 0; b = 0; c = V + o;
    return;
  }
  o -= D;
  if (o < D * D) {  // A1
    a = 0; b = K + o / D; c = V + o % D;
    return;
  }
  o -= D * D;
  if (o < D * D * D) {  // A2
    a = K + o / (D * D); b = K + (o / D) % D; c = V + o % D;
    coef = kInvSqrt2;
    return;
  }
  o -= D * D * D;
  if (o < D) {  // sk
    a = 0; b = 0; c = K + o;
    return;
  }
  o -= D;  // skk
  a = 0; b = K + o / D; c = K + o % D;
  coef = kInvSqrt2;
}

// One block per (frame, head). Phase 1 reduces the moments over the frame's
// N tokens: tokens are staged kTaylorTile at a time as float features in
// shared memory, and each moment has one owner thread, so there are no
// atomics. Phase 2 gives each token its output from the moments.
template <typename T, int D>
__global__ void __launch_bounds__(kTaylorThreads)
    taylor_core_kernel(const float* __restrict__ qkv, T* __restrict__ attn,
                       int N, int H, float eps) {
  constexpr int kMoments = D + D * D + D * D * D + D + D * D;
  constexpr int kFeat = 1 + 2 * D;
  extern __shared__ float smem[];
  float* mom = smem;                 // kMoments
  float* feat = smem + kMoments;     // kTaylorTile x kFeat
  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = H * D;
  const long long ld = 3LL * hd;
  const float* frame = qkv + (long long)g * N * ld;
  const float scale = 1.f / sqrtf((float)D);
  const float kInvSqrt2 = 0.70710678118654752f;

  for (int o = threadIdx.x; o < kMoments; o += blockDim.x) mom[o] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kTaylorTile) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kTaylorTile * kFeat; idx += blockDim.x) {
      const int t = idx / kFeat, f = idx % kFeat;
      const int n = n0 + t;
      float val = 0.f;
      if (n < N) {
        if (f == 0) {
          val = 1.f;
        } else if (f <= D) {
          val = round_to<T>(frame[n * ld + hd + h * D + (f - 1)]);
        } else {
          val = round_to<T>(frame[n * ld + 2 * hd + h * D + (f - 1 - D)]);
        }
      }
      feat[idx] = val;
    }
    __syncthreads();
    const int tiles = min(kTaylorTile, N - n0);
    for (int o = threadIdx.x; o < kMoments; o += blockDim.x) {
      int a, b, c;
      float coef;
      moment_terms<D>(o, a, b, c, coef);
      float s = 0.f;
      for (int t = 0; t < tiles; ++t) {
        const float* ft = feat + t * kFeat;
        s += ft[a] * ft[b] * ft[c];
      }
      mom[o] += coef * s;
    }
  }
  __syncthreads();

  // read through volatile: otherwise the compiler hoists all the moments
  // out of the token loop into registers (255 registers and spills in the
  // float32 build)
  const volatile float* A0 = mom;
  const volatile float* A1 = A0 + D;
  const volatile float* A2 = A1 + D * D;
  const volatile float* sk = A2 + D * D * D;
  const volatile float* skk = sk + D;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float q[D], num[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      q[i] = round_to<T>(frame[n * ld + h * D + i] * scale);
      num[i] = A0[i];
    }
    float den = (float)N;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      den += q[i] * sk[i];
#pragma unroll
      for (int e = 0; e < D; ++e) num[e] += q[i] * A1[i * D + e];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float qq = q[i] * q[j] * kInvSqrt2;
        den += qq * skk[i * D + j];
        const volatile float* a2 = A2 + (i * D + j) * D;
#pragma unroll
        for (int e = 0; e < D; ++e) num[e] += qq * a2[e];
      }
    }
    const float r = 1.f / (den + eps);
    T* orow = attn + ((long long)g * N + n) * hd + h * D;
#pragma unroll
    for (int e = 0; e < D; ++e) orow[e] = from_f32<T>(num[e] * r);
  }
}

template <typename T, int D>
cudaError_t launch_taylor_core(const float* qkv, T* attn, int frames, int N,
                               int H, float eps, cudaStream_t stream) {
  constexpr int kMoments = D + D * D + D * D * D + D + D * D;
  const size_t smem = sizeof(float) * (kMoments + kTaylorTile * (1 + 2 * D));
  taylor_core_kernel<T, D><<<frames * H, kTaylorThreads, smem, stream>>>(
      qkv, attn, N, H, eps);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace mv2

// the moment core of one Taylor block: qkv (frames * N, 3 * H * D) float32
// from the qkv GEMM, attn (frames * N, H * D) in the working dtype
extern "C" int mv2_taylor_core(const void* qkv, void* attn, int dtype,
                               int frames, int N, int H, int D, float eps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 8) return cudaErrorInvalidValue;  // linear_attn_dim_head of every
                                             // configuration
  if (dtype == mv2::kFloat32)
    return mv2::launch_taylor_core<float, 8>((const float*)qkv, (float*)attn,
                                             frames, N, H, eps, s);
  if (dtype == mv2::kBFloat16)
    return mv2::launch_taylor_core<mv2::bf16, 8>(
        (const float*)qkv, (mv2::bf16*)attn, frames, N, H, eps, s);
  return cudaErrorInvalidValue;
}
