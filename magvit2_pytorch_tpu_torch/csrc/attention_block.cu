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
// Three cores, picked by the wrapper (ops/kernels/axial_attention.py
// core_route) and passed in as kCoreMma / kCoreMmaRing / kCoreScalar:
// - space_core_mma_kernel: bf16, contiguous groups (inner_groups == 1,
//   pos_stride == 1), every key and value of a (frame, head) resident in
//   shared memory. The space block of the flagship: tensor cores through
//   mma.sync.
// - space_core_ring_kernel: the same where the keys do not fit (config 4's
//   1028 keys at D = 64): K and V stream through a cp.async ring.
// - attention_core_kernel: everything else (the time block's 'launches'
//   route, float32): one thread per query on the CUDA cores.
// Head sizes: every D that is a multiple of 8 from 8 to 128. Each core is
// built at the padded widths DP = 16, 32, 64 and 128 and takes the true D
// at run time: the columns past D are zeros in shared memory (cp.async's
// zero fill) and in Q's registers, so they add nothing to a score, and the
// output columns past D are not stored. D % 16 == 8 pads QK^T's last k16
// step with zeros that way; the scale is D^-1/2 of the true D.
// What bounds the space block at the flagship shape (160 frames x 256
// tokens x 512 channels, 8 heads x 32, 4 memory keys): operations, 53.8
// GFLOP (42.9 in the projections), 0.0545 ms at the bf16 peak; the core
// alone moves qkv in and attn out, 85 MB, 0.025 ms. At a fixed inner width
// (heads x D) neither number depends on D. Left for later: one launch for
// the whole space block (the xn, qkv and attn scratch cross device memory,
// as time_attention.cu avoids for the time block), warp specialisation and
// persistent tiles in the GEMM.
#include "common.cuh"

namespace mv2 {

enum CoreRoute { kCoreScalar = 0, kCoreMma = 1, kCoreMmaRing = 2 };

// the padded width a head of D values runs at
inline int head_width(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128;
}

// One thread per (group, head, query). The query row is held in registers
// (DP values, the D past D zeros); memory keys first, then the visible
// sequence keys, with an online softmax in float32 (running max m,
// denominator l, output accumulator acc). All threads of a warp that share
// (group, head) read the same key at the same time, so key and value loads
// are broadcasts served from L1. At DP = 128 the two rows take 256
// registers and spill.
template <typename T, int DP>
__global__ void __launch_bounds__(256)
    attention_core_kernel(const T* __restrict__ qkv,
                          const T* __restrict__ mem_k,
                          const T* __restrict__ mem_v, T* __restrict__ out,
                          int groups, int L, int H, int D, int M,
                          int inner_groups, long long outer_stride,
                          long long pos_stride, int causal, float scale) {
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
  float q[DP], acc[DP];
#pragma unroll
  for (int e = 0; e < DP; ++e) {
    q[e] = e < D ? to_f32(qrow[e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  // one key: s = scale * q.k, then fold exp(s - m) * v into the running sum
  auto visit = [&](const T* __restrict__ kr, const T* __restrict__ vr) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < DP; ++e)
      if (e < D) s += q[e] * to_f32(kr[e]);
    s *= scale;
    if (s > m) {
      const float c = expf(m - s);
      l *= c;
#pragma unroll
      for (int e = 0; e < DP; ++e) acc[e] *= c;
      m = s;
    }
    const float p = expf(s - m);
    l += p;
#pragma unroll
    for (int e = 0; e < DP; ++e)
      if (e < D) acc[e] += p * to_f32(vr[e]);
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
  for (int e = 0; e < DP; ++e)
    if (e < D) orow[e] = from_f32<T>(acc[e] * inv);
}

template <typename T, int DP>
cudaError_t launch_attention_core(const T* qkv, const T* mem_k,
                                  const T* mem_v, T* attn, int groups, int L,
                                  int H, int D, int M, int inner_groups,
                                  long long outer_stride, long long pos_stride,
                                  int causal, cudaStream_t stream) {
  const long long total = (long long)groups * H * L;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  attention_core_kernel<T, DP><<<(unsigned)blocks, threads, 0, stream>>>(
      qkv, mem_k, mem_v, attn, groups, L, H, D, M, inner_groups, outer_stride,
      pos_stride, causal, (float)(1.0 / sqrt((double)D)));
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_attention_core_at(const T* qkv, const T* mem_k,
                                     const T* mem_v, T* attn, int groups,
                                     int L, int H, int D, int M,
                                     int inner_groups, long long outer_stride,
                                     long long pos_stride, int causal,
                                     cudaStream_t s) {
  switch (head_width(D)) {
#define MV2_SCALAR_CORE(DP)                                                  \
  case DP:                                                                   \
    return launch_attention_core<T, DP>(qkv, mem_k, mem_v, attn, groups, L, \
                                        H, D, M, inner_groups, outer_stride, \
                                        pos_stride, causal, s);
    MV2_SCALAR_CORE(16)
    MV2_SCALAR_CORE(32)
    MV2_SCALAR_CORE(64)
    MV2_SCALAR_CORE(128)
#undef MV2_SCALAR_CORE
  }
  return cudaErrorInvalidValue;
}

// ---- the tensor-core cores of the space block ----------------------------

// Both cores run four warps a block on one (frame, head); each warp takes
// tiles of 16 query rows and walks the keys, memory keys first, staged with
// cp.async in shared memory (rows of DP bf16 padded to DP + 8, so the 8
// rows an ldmatrix phase reads fall in 8 different bank groups); with
// causal only the keys the block's last row can see:
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
// - space_core_mma_kernel: a block owns up to 256 query rows (the whole
//   frame at the flagship's 256 tokens) and stages every key it needs
//   once; each warp takes its tiles (w, w + 4, ...) in turn, walking the
//   keys in tiles of 64, then the rest in steps of 16 (the 4 memory keys
//   leave 4 at the flagship). Taken where the keys fit in shared memory
//   (space_core_smem): up to 1440 keys at DP = 32, 800 at 64, 416 at 128.
// - space_core_ring_kernel: a block owns 64 query rows, one tile a warp,
//   and the keys come through a ring of kRingStages tiles of kRingKeys
//   keys: tile t + 1 is copied while tile t is multiplied.
constexpr int kMmaRows = 256, kMmaWarps = 4, kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaKeyTile = 64;
constexpr int kRingRows = 16 * kMmaWarps, kRingKeys = 64, kRingStages = 2;
constexpr int kMmaSmemMax = 232448;  // 227 KB of dynamic shared memory

// the resident core's shared memory for `keys` keys: K and V, rows padded
// to a multiple of 16 keys (the PV steps take 16)
inline size_t space_core_smem(int DP, int keys) {
  return 2 * sizeof(bf16) * (size_t)(DP + 8) * ((keys + 15) & ~15);
}

// One warp's running state for query rows row_a = r0 + lane/4 and
// row_b = row_a + 8 of a 16-row tile: Q's A fragments (DP / 16 k16 steps),
// O's C fragments (DP / 8 blocks of 8), the running max (raw q.k) and
// denominator of each row.
template <int DP>
struct RowState {
  unsigned qa[DP / 16][4];
  float o[DP / 8][4];
  float m_a, m_b, l_a, l_b;
  int row_a, row_b;
};

// Staged key rows [row0, row0 + 8 NB) into the state, keys k0 .. k0 + 8 NB
// - 1: S = Q K^T on NB blocks of 8 keys, the online softmax, O += P V on
// NB / 2 steps of 16 keys. Every lane runs every ldmatrix and mma (no
// branch around them); with masked, keys at or past wkeys and, with causal,
// keys a row may not see score -inf, and their staged rows hold zeros or
// finite keys.
template <int DP, int NB>
__device__ __forceinline__ void key_tile(RowState<DP>& st, const bf16* Ks,
                                         const bf16* Vs, int row0, int k0,
                                         int wkeys, int M, bool masked,
                                         int causal, float scale_log2) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x % 32, tq = lane & 3;
  float s[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* krow = Ks + (row0 + 8 * j + (lane & 7)) * LD;
    if constexpr (DP == 16) {
      unsigned b[2];  // keys row0 + 8j + 0..7, d in two chunks of 8
      ldmatrix_x2(b, krow + ((lane >> 3) & 1) * 8);
      mma_16816(s[j], st.qa[0], b[0], b[1]);
    } else {
#pragma unroll
      for (int kc = 0; kc < DP / 16; kc += 2) {
        unsigned b[4];  // d 16 kc .. 16 kc + 31 in four chunks of 8
        ldmatrix_x4(b, krow + 16 * kc + (lane >> 3) * 8);
        mma_16816(s[j], st.qa[kc], b[0], b[1]);
        mma_16816(s[j], st.qa[kc + 1], b[2], b[3]);
      }
    }
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
  for (int d = 0; d < DP / 8; ++d) {
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
    for (int p = 0; p < DP / 16; ++p) {
      unsigned b[4];  // V^T for d blocks 2p and 2p + 1
      ldmatrix_x4_trans(b, Vs + (row0 + 16 * kk + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * LD +
                               (2 * p + (lane >> 4)) * 8);
      mma_16816(st.o[2 * p], pa, b[0], b[1]);
      mma_16816(st.o[2 * p + 1], pa, b[2], b[3]);
    }
  }
}

// The state of the 16-row tile from r0 of a frame: Q's A fragments straight
// from the qkv rows (zeros past D and past L), O zero, no key seen.
template <int DP>
__device__ __forceinline__ void start_rows(RowState<DP>& st,
                                           const bf16* __restrict__ frame,
                                           int r0, int L, int h, int D,
                                           long long ld) {
  const int lane = threadIdx.x % 32, tq = lane & 3;
  st.row_a = r0 + (lane >> 2);
  st.row_b = st.row_a + 8;
  auto q32 = [&](int row, int col) -> unsigned {
    return row < L && col < D ? *reinterpret_cast<const unsigned*>(
                                    frame + row * ld + h * D + col)
                              : 0u;
  };
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    st.qa[ks][0] = q32(st.row_a, 16 * ks + 2 * tq);
    st.qa[ks][1] = q32(st.row_b, 16 * ks + 2 * tq);
    st.qa[ks][2] = q32(st.row_a, 16 * ks + 8 + 2 * tq);
    st.qa[ks][3] = q32(st.row_b, 16 * ks + 8 + 2 * tq);
  }
#pragma unroll
  for (int d = 0; d < DP / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[d][e] = 0.f;
  st.m_a = st.m_b = -INFINITY;
  st.l_a = st.l_b = 0.f;
}

// O / l of the tile's rows below L, cast once, the D columns of head h;
// out_frame is the frame's first output row.
template <int DP>
__device__ __forceinline__ void finish_rows(const RowState<DP>& st,
                                            bf16* __restrict__ out_frame,
                                            int L, int h, int D, int inner) {
  const int tq = (threadIdx.x % 32) & 3;
  const float inv_a = 1.f / quad_sum(st.l_a), inv_b = 1.f / quad_sum(st.l_b);
  bf16* o_rows = out_frame + h * D + 2 * tq;
#pragma unroll
  for (int d = 0; d < DP / 8; ++d) {
    if (8 * d >= D) break;
    if (st.row_a < L)
      *reinterpret_cast<__nv_bfloat162*>(o_rows + st.row_a * inner + 8 * d) =
          __floats2bfloat162_rn(st.o[d][0] * inv_a, st.o[d][1] * inv_a);
    if (st.row_b < L)
      *reinterpret_cast<__nv_bfloat162*>(o_rows + st.row_b * inner + 8 * d) =
          __floats2bfloat162_rn(st.o[d][2] * inv_b, st.o[d][3] * inv_b);
  }
}

// Keys j0 .. j0 + rows - 1 of head h (memory keys first, then the frame's
// rows) into staged rows 0 .. rows - 1 of Ks and Vs, in 16-byte cp.async
// pieces; pieces past D and rows past nkeys are zero-filled (P is 0 there,
// and 0 * garbage may be NaN). The caller commits the group.
template <int DP>
__device__ __forceinline__ void stage_keys(bf16* Ks, bf16* Vs, int j0,
                                           int rows, int nkeys,
                                           const bf16* __restrict__ frame,
                                           const bf16* __restrict__ mem_k,
                                           const bf16* __restrict__ mem_v,
                                           int h, int M, int D, int inner,
                                           long long ld) {
  constexpr int LD = DP + 8, kPieces = DP / 8;
  for (int idx = threadIdx.x; idx < rows * kPieces; idx += kMmaThreads) {
    const int i = idx / kPieces, c = idx % kPieces, j = j0 + i;
    const bool live = j < nkeys && 8 * c < D;
    const bf16 *ks = frame, *vs = frame;  // read nothing where not live
    if (live && j < M) {
      const long long off = ((long long)h * M + j) * D + 8 * c;
      ks = mem_k + off;
      vs = mem_v + off;
    } else if (live) {
      const bf16* row = frame + (j - M) * ld + h * D + 8 * c;
      ks = row + inner;
      vs = row + 2 * inner;
    }
    cp_async16(Ks + i * LD + 8 * c, ks, live);
    cp_async16(Vs + i * LD + 8 * c, vs, live);
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
    space_core_mma_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ mem_k,
                          const bf16* __restrict__ mem_v,
                          bf16* __restrict__ out, int L, int H, int D, int M,
                          int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char kv_smem[];
  const int q0 = blockIdx.x * kMmaRows, h = blockIdx.y;
  const int qend = min(L, q0 + kMmaRows);
  const long long g = blockIdx.z;
  const int inner = H * D;
  const long long ld = 3LL * inner;
  const bf16* frame = qkv + g * L * ld;
  // keys this block stages: all, or with causal those its last row sees
  const int nkeys = M + (causal ? qend : L);
  const int kpad = (nkeys + 15) & ~15;  // PV steps take 16 keys
  bf16* Ks = reinterpret_cast<bf16*>(kv_smem);
  bf16* Vs = Ks + kpad * (DP + 8);
  stage_keys<DP>(Ks, Vs, 0, kpad, nkeys, frame, mem_k, mem_v, h, M, D, inner,
                 ld);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32;
  for (int r0 = q0 + 16 * warp; r0 < qend; r0 += 16 * kMmaWarps) {
    RowState<DP> st;
    start_rows<DP>(st, frame, r0, L, h, D, ld);
    const int wkeys = causal ? min(nkeys, M + r0 + 16) : nkeys;
    int k0 = 0;
    for (; k0 + kMmaKeyTile <= wkeys; k0 += kMmaKeyTile)
      key_tile<DP, kMmaKeyTile / 8>(st, Ks, Vs, k0, k0, wkeys, M, causal,
                                    causal, scale_log2);
    for (; k0 < wkeys; k0 += 16)
      key_tile<DP, 2>(st, Ks, Vs, k0, k0, wkeys, M, true, causal, scale_log2);
    finish_rows<DP>(st, out + g * L * inner, L, h, D, inner);
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
    space_core_ring_kernel(const bf16* __restrict__ qkv,
                           const bf16* __restrict__ mem_k,
                           const bf16* __restrict__ mem_v,
                           bf16* __restrict__ out, int L, int H, int D, int M,
                           int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char kv_smem[];
  constexpr int kStage = 2 * kRingKeys * (DP + 8);  // bf16: K, then V
  const int q0 = blockIdx.x * kRingRows, h = blockIdx.y;
  const int qend = min(L, q0 + kRingRows);
  const long long g = blockIdx.z;
  const int inner = H * D;
  const long long ld = 3LL * inner;
  const bf16* frame = qkv + g * L * ld;
  const int nkeys = M + (causal ? qend : L);
  const int tiles = (nkeys + kRingKeys - 1) / kRingKeys;
  bf16* ring = reinterpret_cast<bf16*>(kv_smem);
  auto stage = [&](int t) {
    bf16* Ks = ring + (t % kRingStages) * kStage;
    stage_keys<DP>(Ks, Ks + kRingKeys * (DP + 8), t * kRingKeys, kRingKeys,
                   nkeys, frame, mem_k, mem_v, h, M, D, inner, ld);
    cp_async_commit();
  };

  const int r0 = q0 + 16 * (threadIdx.x / 32);
  const bool rows = r0 < qend;  // the same for the whole warp
  const int wkeys = causal ? min(nkeys, M + r0 + 16) : nkeys;
  RowState<DP> st;
  start_rows<DP>(st, frame, r0, L, h, D, ld);
  stage(0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {  // the next tile's copies overlap this tile's math
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kRingKeys;
    if (rows && k0 < wkeys) {
      const bf16* Ks = ring + (t % kRingStages) * kStage;
      key_tile<DP, kRingKeys / 8>(st, Ks, Ks + kRingKeys * (DP + 8), 0, k0,
                                  wkeys, M, causal || k0 + kRingKeys > wkeys,
                                  causal, scale_log2);
    }
    __syncthreads();  // the stage is refilled kRingStages tiles on
  }
  if (rows) finish_rows<DP>(st, out + g * L * inner, L, h, D, inner);
}

template <int DP>
cudaError_t launch_space_core_mma(const bf16* qkv, const bf16* mem_k,
                                  const bf16* mem_v, bf16* attn, int groups,
                                  int L, int H, int D, int M, int causal,
                                  int route, cudaStream_t stream) {
  const float scale_log2 = kLog2e / sqrtf((float)D);
  if (route == kCoreMma) {
    const size_t smem = space_core_smem(DP, M + L);
    if (smem > (size_t)kMmaSmemMax)
      return cudaErrorInvalidValue;  // the ring's call: see core_route
    cudaError_t err = cudaFuncSetAttribute(
        space_core_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kMmaRows - 1) / kMmaRows, H, groups);
    space_core_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
        qkv, mem_k, mem_v, attn, L, H, D, M, causal, scale_log2);
  } else {
    const size_t smem =
        sizeof(bf16) * (size_t)kRingStages * 2 * kRingKeys * (DP + 8);
    cudaError_t err = cudaFuncSetAttribute(
        space_core_ring_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kRingRows - 1) / kRingRows, H, groups);
    space_core_ring_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
        qkv, mem_k, mem_v, attn, L, H, D, M, causal, scale_log2);
  }
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
  // the head sizes of ops/kernels/axial_attention.py takes_dim_head
  if (D < 8 || D > 128 || D % 8) return cudaErrorInvalidValue;
  if (route == mv2::kCoreMma || route == mv2::kCoreMmaRing) {
    if (dtype != mv2::kBFloat16 || inner_groups != 1 || pos_stride != 1 ||
        outer_stride != L || L < 1 ||
        ((uintptr_t)qkv | (uintptr_t)mem_k | (uintptr_t)mem_v) % 16)
      return cudaErrorInvalidValue;  // not this core's call: see core_route
    typedef mv2::bf16 T;
    const T *q = (const T*)qkv, *mk = (const T*)mem_k, *mv = (const T*)mem_v;
    T* o = (T*)attn;
    switch (mv2::head_width(D)) {
      case 16:
        return mv2::launch_space_core_mma<16>(q, mk, mv, o, groups, L, H, D,
                                              M, causal, route, s);
      case 32:
        return mv2::launch_space_core_mma<32>(q, mk, mv, o, groups, L, H, D,
                                              M, causal, route, s);
      case 64:
        return mv2::launch_space_core_mma<64>(q, mk, mv, o, groups, L, H, D,
                                              M, causal, route, s);
      default:
        return mv2::launch_space_core_mma<128>(q, mk, mv, o, groups, L, H, D,
                                               M, causal, route, s);
    }
  }
  if (route != mv2::kCoreScalar) return cudaErrorInvalidValue;
  if (dtype == mv2::kFloat32) {
    typedef float T;
    return mv2::launch_attention_core_at<T>(
        (const T*)qkv, (const T*)mem_k, (const T*)mem_v, (T*)attn, groups, L,
        H, D, M, inner_groups, outer_stride, pos_stride, causal, s);
  }
  if (dtype == mv2::kBFloat16) {
    typedef mv2::bf16 T;
    return mv2::launch_attention_core_at<T>(
        (const T*)qkv, (const T*)mem_k, (const T*)mem_v, (T*)attn, groups, L,
        H, D, M, inner_groups, outer_stride, pos_stride, causal, s);
  }
  return cudaErrorInvalidValue;
}

const char* mv2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
