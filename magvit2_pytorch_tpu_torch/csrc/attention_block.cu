// The attention step of the pre-norm softmax attention block with learned
// memory KV, for the space (over a frame's pixels) and the time (causal,
// over a pixel's frames) attention of the tokenizer. Replaces, with the
// RMSNorm and GEMM launches of gemm.cu, the TPU kernel
// magvit2_pytorch_tpu/ops/pallas/axial_attention.py _kernel, and
// _time_kernel where the time block takes its 'launches' route (float32,
// and bf16 shapes time_attention.cu does not take; bf16 at the flagship
// runs the whole block there in one launch);
// ops/kernels/axial_attention.py holds the design note and makes the four
// launches of a block on scratch it allocates:
//   xn   = RMSNorm(x) * gamma                     (rows, C)       gemm.cu
//   qkv  = xn Wqkv^T, f32 accumulate, cast to T   (rows, 3 * H * D) gemm.cu
//   attn = softmax attention per (group, head)    (rows, H * D)   here
//   out  = attn Wout^T                            (rows, C)       gemm.cu
// A group is one attention sequence of length L: position i of group g is
// row (g / inner_groups) * outer_stride + (g % inner_groups) + i * pos_stride.
// Space: g = frame, row = g * N + i. Time on (B, T, S, C): g = b * S + s,
// row = (b * T + t) * S + s — attention over t with no transpose.
//
// Two cores, picked by the wrapper (ops/kernels/axial_attention.py
// core_route) and passed in as kCoreMma / kCoreScalar:
// - space_attention_core_mma_kernel: bf16, contiguous groups
//   (inner_groups == 1, pos_stride == 1), D == 32, at most kMmaMaxKeys keys.
//   The space block of the flagship: tensor cores through mma.sync.
// - attention_core_kernel: everything else (the time block's 'launches'
//   route, float32): one thread per query on the CUDA cores.
// What bounds the space block at the flagship shape (160 frames x 256
// tokens x 512 channels, 8 heads x 32, 4 memory keys): operations, 53.8
// GFLOP (42.9 in the projections), 0.0545 ms at the bf16 peak; the core
// alone moves qkv in and attn out, 85 MB, 0.025 ms. Left for later: one
// launch for the whole space block (the xn, qkv and attn scratch cross
// device memory, as time_attention.cu avoids for the time block), warp
// specialisation and persistent tiles in the GEMM.
#include "common.cuh"

namespace mv2 {

enum CoreRoute { kCoreScalar = 0, kCoreMma = 1 };

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

// ---- the tensor-core core of the space block -----------------------------

// One block of four warps owns up to 256 query rows of one (frame, head)
// (the whole frame at the flagship's 256 tokens), so the head's keys are
// read from device memory once. They are staged, memory keys first, with
// cp.async into shared memory (rows of 32 bf16 padded to 40, so the 8 rows
// an ldmatrix phase reads fall in 8 different bank groups); with causal
// only the keys the block's last row can see. Then each warp takes tiles of
// 16 query rows in turn (w, w + 4, ...) and walks the keys in tiles of 64,
// then the rest in steps of 16 (the 4 memory keys leave 4 at the flagship):
//   S = Q K^T          mma.sync m16n8k16, Q from registers, K by ldmatrix
//   online softmax     in float32 registers: the C fragment gives a thread
//                      two rows (lane/4 and lane/4 + 8), each reduced over
//                      the 4 lanes of its quad; one FMA and one ex2 a score
//   O += P V           P rounded to bf16 in registers as the A operand (the
//                      Pallas kernel's cast point), V by ldmatrix.trans
// No branch sits around an ldmatrix or mma (ptxas would otherwise guard
// them for divergent lanes): keys past the last one, and causally hidden
// ones, score -inf, and the staged rows past the last key are zeros. O is
// divided by the row sum in float32 and cast once.
constexpr int kMmaRows = 256, kMmaWarps = 4, kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaKeyTile = 64, kMmaD = 32, kMmaLd = 40;
constexpr int kMmaMaxKeys = 1280;  // 200 KB of K and V in shared memory

// One warp's running state for query rows row_a = r0 + lane/4 and
// row_b = row_a + 8 of a 16-row tile: Q's A fragments, O's C fragments
// (d blocks of 8), the running max (raw q.k) and denominator of each row.
struct RowState {
  unsigned qa[2][4];
  float o[4][4];
  float m_a, m_b, l_a, l_b;
  int row_a, row_b;
};

// Keys k0 .. k0 + 8 NB - 1 into the state: S = Q K^T on NB blocks of 8
// keys, the online softmax, O += P V on NB / 2 steps of 16 keys. Every
// lane runs every ldmatrix and mma (no branch around them); with masked,
// keys at or past wkeys and, with causal, keys a row may not see score
// -inf, and their staged rows hold zeros or finite keys.
template <int NB>
__device__ __forceinline__ void key_tile(RowState& st, const bf16* Ks,
                                         const bf16* Vs, int k0, int wkeys,
                                         int M, bool masked, int causal,
                                         float scale_log2) {
  const int lane = threadIdx.x % 32, tq = lane & 3;
  float s[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    unsigned b[4];  // keys k0 + 8j + 0..7, d in four chunks of 8
    ldmatrix_x4(b, Ks + (k0 + 8 * j + (lane & 7)) * kMmaLd + (lane >> 3) * 8);
    mma_16816(s[j], st.qa[0], b[0], b[1]);
    mma_16816(s[j], st.qa[1], b[2], b[3]);
  }
  if (masked) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * tq + e;
        const bool seen = key < wkeys;
        if (!(seen && (!causal || key - M <= st.row_a))) s[j][e] = -INFINITY;
        if (!(seen && (!causal || key - M <= st.row_b)))
          s[j][2 + e] = -INFINITY;
      }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
  }
  const float new_a = fmaxf(st.m_a, quad_max(mx_a));
  const float new_b = fmaxf(st.m_b, quad_max(mx_b));
  // p = 2^(s * scale_log2 - base), base the running max in the same units;
  // a row that has seen no key yet keeps 0 (no inf - inf)
  const float base_a = new_a == -INFINITY ? 0.f : new_a * scale_log2;
  const float base_b = new_b == -INFINITY ? 0.f : new_b * scale_log2;
  const float alpha_a = exp2_approx(fmaf(st.m_a, scale_log2, -base_a));
  const float alpha_b = exp2_approx(fmaf(st.m_b, scale_log2, -base_b));
  st.m_a = new_a;
  st.m_b = new_b;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    st.o[d][0] *= alpha_a;
    st.o[d][1] *= alpha_a;
    st.o[d][2] *= alpha_b;
    st.o[d][3] *= alpha_b;
  }
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[j][0] = exp2_approx(fmaf(s[j][0], scale_log2, -base_a));
    s[j][1] = exp2_approx(fmaf(s[j][1], scale_log2, -base_a));
    s[j][2] = exp2_approx(fmaf(s[j][2], scale_log2, -base_b));
    s[j][3] = exp2_approx(fmaf(s[j][3], scale_log2, -base_b));
    sum_a += s[j][0] + s[j][1];
    sum_b += s[j][2] + s[j][3];
  }
  st.l_a = st.l_a * alpha_a + sum_a;
  st.l_b = st.l_b * alpha_b + sum_b;
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    // P's A fragment for keys k0 + 16kk .. +15 from two C fragments
    const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      unsigned b[4];  // V^T for d blocks 2p and 2p + 1
      ldmatrix_x4_trans(b, Vs + (k0 + 16 * kk + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * kMmaLd +
                               (2 * p + (lane >> 4)) * 8);
      mma_16816(st.o[2 * p], pa, b[0], b[1]);
      mma_16816(st.o[2 * p + 1], pa, b[2], b[3]);
    }
  }
}

// One warp: the 16-row tile from r0 of a frame against its first wkeys
// staged keys, in full tiles of 64 keys and then steps of 16 (the staged
// rows are padded to a multiple of 16); out_frame is the frame's first
// output row.
__device__ __forceinline__ void attend_rows(
    const bf16* __restrict__ frame, const bf16* Ks, const bf16* Vs,
    bf16* __restrict__ out_frame, int r0, int L, int h, int inner, int M,
    int wkeys, int causal, float scale_log2) {
  const int lane = threadIdx.x % 32, tq = lane & 3;
  const long long ld = 3LL * inner;
  RowState st;
  st.row_a = r0 + (lane >> 2);
  st.row_b = st.row_a + 8;
  // Q's A fragments for d 0..15 and 16..31, straight from the qkv rows
  auto q32 = [&](int row, int col) -> unsigned {
    return row < L ? *reinterpret_cast<const unsigned*>(
                         frame + row * ld + h * kMmaD + col)
                   : 0u;
  };
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    st.qa[ks][0] = q32(st.row_a, 16 * ks + 2 * tq);
    st.qa[ks][1] = q32(st.row_b, 16 * ks + 2 * tq);
    st.qa[ks][2] = q32(st.row_a, 16 * ks + 8 + 2 * tq);
    st.qa[ks][3] = q32(st.row_b, 16 * ks + 8 + 2 * tq);
  }
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[d][e] = 0.f;
  st.m_a = st.m_b = -INFINITY;
  st.l_a = st.l_b = 0.f;

  int k0 = 0;
  for (; k0 + kMmaKeyTile <= wkeys; k0 += kMmaKeyTile)
    key_tile<kMmaKeyTile / 8>(st, Ks, Vs, k0, wkeys, M, causal, causal,
                              scale_log2);
  for (; k0 < wkeys; k0 += 16)
    key_tile<2>(st, Ks, Vs, k0, wkeys, M, true, causal, scale_log2);

  const float inv_a = 1.f / quad_sum(st.l_a), inv_b = 1.f / quad_sum(st.l_b);
  bf16* o_rows = out_frame + h * kMmaD + 2 * tq;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    if (st.row_a < L)
      *reinterpret_cast<__nv_bfloat162*>(o_rows + st.row_a * inner + 8 * d) =
          __floats2bfloat162_rn(st.o[d][0] * inv_a, st.o[d][1] * inv_a);
    if (st.row_b < L)
      *reinterpret_cast<__nv_bfloat162*>(o_rows + st.row_b * inner + 8 * d) =
          __floats2bfloat162_rn(st.o[d][2] * inv_b, st.o[d][3] * inv_b);
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    space_attention_core_mma_kernel(const bf16* __restrict__ qkv,
                                    const bf16* __restrict__ mem_k,
                                    const bf16* __restrict__ mem_v,
                                    bf16* __restrict__ out, int L, int H,
                                    int M, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char kv_smem[];
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y;
  const int qend = min(L, q0 + kMmaRows);
  const long long g = blockIdx.z;
  const int inner = H * kMmaD;
  const long long ld = 3LL * inner;
  const bf16* frame = qkv + g * L * ld;
  // keys this block stages: all, or with causal those its last row sees
  const int nkeys = M + (causal ? qend : L);
  const int kpad = (nkeys + 15) & ~15;  // PV steps take 16 keys
  bf16* Ks = reinterpret_cast<bf16*>(kv_smem);
  bf16* Vs = Ks + kpad * kMmaLd;

  for (int idx = threadIdx.x; idx < kpad * 4; idx += kMmaThreads) {
    const int j = idx >> 2, c = (idx & 3) * 8;
    bf16* kd = Ks + j * kMmaLd + c;
    bf16* vd = Vs + j * kMmaLd + c;
    if (j < M) {
      const long long off = ((long long)h * M + j) * kMmaD + c;
      cp_async16(kd, mem_k + off);
      cp_async16(vd, mem_v + off);
    } else if (j < nkeys) {
      const bf16* row = frame + (j - M) * ld + h * kMmaD + c;
      cp_async16(kd, row + inner);
      cp_async16(vd, row + 2 * inner);
    } else {  // pad rows: P is 0 there, and 0 * garbage may be NaN
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x / 32;
  for (int r0 = q0 + 16 * warp; r0 < qend; r0 += 16 * kMmaWarps)
    attend_rows(frame, Ks, Vs, out + g * L * inner, r0, L, h, inner, M,
                causal ? min(nkeys, M + r0 + 16) : nkeys, causal, scale_log2);
}

cudaError_t launch_space_attention_core_mma(const bf16* qkv, const bf16* mem_k,
                                            const bf16* mem_v, bf16* attn,
                                            int groups, int L, int H, int M,
                                            int causal, cudaStream_t stream) {
  if (M + L > kMmaMaxKeys || L < 1 ||
      ((uintptr_t)qkv | (uintptr_t)mem_k | (uintptr_t)mem_v) % 16)
    return cudaErrorInvalidValue;  // not this core's call: see core_route
  const int max_keys = M + L;
  const size_t smem = 2 * sizeof(bf16) * kMmaLd * ((max_keys + 15) & ~15);
  cudaError_t err = cudaFuncSetAttribute(
      space_attention_core_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kMmaRows - 1) / kMmaRows, H, groups);
  space_attention_core_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(
      qkv, mem_k, mem_v, attn, L, H, M, causal,
      kLog2e / sqrtf((float)kMmaD));
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace mv2

extern "C" {

int mv2_attention_core(const void* qkv, const void* mem_k, const void* mem_v,
                       void* attn, int dtype, int groups, int L, int H, int D,
                       int M, int inner_groups, long long outer_stride,
                       long long pos_stride, int causal, int route,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 32) return cudaErrorInvalidValue;  // attn_dim_head of every config
  if (route == mv2::kCoreMma) {
    if (dtype != mv2::kBFloat16 || inner_groups != 1 || pos_stride != 1 ||
        outer_stride != L)
      return cudaErrorInvalidValue;
    typedef mv2::bf16 T;
    return mv2::launch_space_attention_core_mma(
        (const T*)qkv, (const T*)mem_k, (const T*)mem_v, (T*)attn, groups, L,
        H, M, causal, s);
  }
  if (route != mv2::kCoreScalar) return cudaErrorInvalidValue;
  if (dtype == mv2::kFloat32) {
    typedef float T;
    return mv2::launch_attention_core<T, 32>(
        (const T*)qkv, (const T*)mem_k, (const T*)mem_v, (T*)attn, groups, L,
        H, M, inner_groups, outer_stride, pos_stride, causal, s);
  }
  if (dtype == mv2::kBFloat16) {
    typedef mv2::bf16 T;
    return mv2::launch_attention_core<T, 32>(
        (const T*)qkv, (const T*)mem_k, (const T*)mem_v, (T*)attn, groups, L,
        H, M, inner_groups, outer_stride, pos_stride, causal, s);
  }
  return cudaErrorInvalidValue;
}

const char* mv2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
