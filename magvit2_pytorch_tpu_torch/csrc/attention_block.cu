// Pre-norm softmax attention block with learned memory KV, for the space
// (over a frame's pixels) and the time (causal, over a pixel's frames)
// attention of the tokenizer. Replaces the TPU kernels
// magvit2_pytorch_tpu/ops/pallas/axial_attention.py _kernel and
// _time_kernel; see ops/kernels/axial_attention.py for the design note.
//
// Four launches on scratch the caller allocates:
//   xn   = RMSNorm(x) * gamma                     (rows, C)
//   qkv  = xn Wqkv^T, f32 accumulate, cast to T   (rows, 3 * H * D)
//   attn = softmax attention per (group, head)    (rows, H * D)
//   out  = attn Wout^T                            (rows, C)
// A group is one attention sequence of length L: position i of group g is
// row (g / inner_groups) * outer_stride + (g % inner_groups) + i * pos_stride.
// Space: g = frame, row = g * N + i. Time on (B, T, S, C): g = b * S + s,
// row = (b * T + t) * S + s — attention over t with no transpose.
#include "common.cuh"

namespace mv2 {

// One thread per (group, head, query). The query row is held in registers;
// memory keys first, then the visible sequence keys, with an online softmax
// in float32 (running max m, denominator l, output accumulator acc). All
// threads of a warp that share (group, head) read the same key at the same
// time, so key and value loads are broadcasts served from L1.
template <typename T, int D>
__global__ void __launch_bounds__(256)
    attention_core_kernel(const T* __restrict__ qkv,
                          const T* __restrict__ mem_k,
                          const T* __restrict__ mem_v, T* __restrict__ out,
                          int groups, int L, int H, int M, int inner_groups,
                          long long outer_stride, long long pos_stride,
                          int causal, float scale) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)groups * H * L) return;
  const int i = (int)(tid % L);
  const long long gh = tid / L;
  const int h = (int)(gh % H);
  const long long g = gh / H;
  const long long base = (g / inner_groups) * outer_stride + (g % inner_groups);
  const int inner = H * D;
  const long long ld = 3LL * inner;

  const T* qrow = qkv + (base + i * pos_stride) * ld + h * D;
  float q[D], acc[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    q[e] = to_f32(qrow[e]);
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // one key: s = scale * q.k, then fold exp(s - m) * v into the running sum
  auto visit = [&](const T* __restrict__ kr, const T* __restrict__ vr) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e) s += q[e] * to_f32(kr[e]);
    s *= scale;
    if (s > m) {
      const float c = expf(m - s);
      l *= c;
#pragma unroll
      for (int e = 0; e < D; ++e) acc[e] *= c;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
#pragma unroll
    for (int e = 0; e < D; ++e) acc[e] += p * to_f32(vr[e]);
  };

  for (int j = 0; j < M; ++j)  // memory keys: visible to every query
    visit(mem_k + ((long long)h * M + j) * D, mem_v + ((long long)h * M + j) * D);
  const int jend = causal ? i + 1 : L;
  for (int j = 0; j < jend; ++j) {
    const T* row = qkv + (base + j * pos_stride) * ld + h * D;
    visit(row + inner, row + 2 * inner);
  }

  const float inv = 1.f / l;
  T* orow = out + (base + i * pos_stride) * (long long)inner + h * D;
#pragma unroll
  for (int e = 0; e < D; ++e) orow[e] = from_f32<T>(acc[e] * inv);
}

template <typename T, int D>
cudaError_t launch_attention_core(const T* qkv, const T* mem_k,
                                  const T* mem_v, T* attn, int groups, int L,
                                  int H, int M, int inner_groups,
                                  long long outer_stride, long long pos_stride,
                                  int causal, cudaStream_t stream) {
  const long long total = (long long)groups * H * L;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  attention_core_kernel<T, D><<<(unsigned)blocks, threads, 0, stream>>>(
      qkv, mem_k, mem_v, attn, groups, L, H, M, inner_groups, outer_stride,
      pos_stride, causal, 1.f / sqrtf((float)D));
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <typename T>
cudaError_t attention_block(const T* x, const T* gamma, const T* wqkv,
                            const T* mem_k, const T* mem_v, const T* wout,
                            T* out, T* xn, T* qkv, T* attn, int rows, int C,
                            int H, int D, int M, int groups, int L,
                            int inner_groups, long long outer_stride,
                            long long pos_stride, int causal,
                            cudaStream_t stream) {
  const int inner = H * D;
  cudaError_t err = launch_rmsnorm<T>(x, gamma, xn, rows, C, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm_nt(xn, wqkv, qkv, rows, 3 * inner, C, stream);
  if (err != cudaSuccess) return err;
  switch (D) {
#define MV2_CASE(DH)                                                        \
  case DH:                                                                  \
    err = launch_attention_core<T, DH>(qkv, mem_k, mem_v, attn, groups, L, \
                                       H, M, inner_groups, outer_stride,    \
                                       pos_stride, causal, stream);         \
    break;
    MV2_CASE(32)  // attn_dim_head of every configuration
#undef MV2_CASE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_gemm_nt(attn, wout, out, rows, C, inner, stream);
}

}  // namespace mv2

extern "C" {

int mv2_attention_block(const void* x, const void* gamma, const void* wqkv,
                        const void* mem_k, const void* mem_v, const void* wout,
                        void* out, void* xn, void* qkv, void* attn, int dtype,
                        int rows, int C, int H, int D, int M, int groups,
                        int L, int inner_groups, long long outer_stride,
                        long long pos_stride, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mv2::kFloat32) {
    typedef float T;
    return mv2::attention_block<T>(
        (const T*)x, (const T*)gamma, (const T*)wqkv, (const T*)mem_k,
        (const T*)mem_v, (const T*)wout, (T*)out, (T*)xn, (T*)qkv, (T*)attn,
        rows, C, H, D, M, groups, L, inner_groups, outer_stride, pos_stride,
        causal, s);
  }
  if (dtype == mv2::kBFloat16) {
    typedef mv2::bf16 T;
    return mv2::attention_block<T>(
        (const T*)x, (const T*)gamma, (const T*)wqkv, (const T*)mem_k,
        (const T*)mem_v, (const T*)wout, (T*)out, (T*)xn, (T*)qkv, (T*)attn,
        rows, C, H, D, M, groups, L, inner_groups, outer_stride, pos_stride,
        causal, s);
  }
  return cudaErrorInvalidValue;
}

const char* mv2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
