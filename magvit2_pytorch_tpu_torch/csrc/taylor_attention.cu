// Second-order Taylor linear attention block: the moment core. Replaces,
// with the RMSNorm and GEMM launches of gemm.cu, the TPU kernel
// magvit2_pytorch_tpu/ops/pallas/taylor_attention.py _taylor_kernel /
// _taylor_frame; ops/kernels/taylor_attention.py holds the math, the cast
// points and the design note.
//
// The wrapper makes four launches on scratch it allocates; the first, second
// and fourth are gemm.cu's, the third is this file's:
//   xn   = RMSNorm(x) * gamma                                 (B*N, C)
//   qkv  = xn Wqkv^T, q * d^-1/2, cast to T                   (B*N, 3*H*d)
//   attn = per (frame, head): moments over N, then per token  (B*N, H*d)
//   out  = attn Wout^T                                        (B*N, C)
//
// Cores, picked by the wrapper (taylor_core_route) and passed in:
// - kTaylorMma, bf16, head size 8: tensor cores (mma.sync m16n8k16), one
//   launch, below.
// - kTaylorMma, bf16, every other head up to 256 (a multiple of 8; the
//   wrapper pads the others; the conditioned stack's linear attention takes
//   the full attention's heads, 32 x 8 or 64 x 4): two launches on wgmma
//   with A in registers, TMA rings and each distinct product phi_ij once,
//   built at the padded widths 16, 32, 64, 128 and 256 with the true head
//   size at run time ("the wgmma core" further below).
// - kTaylorF32, float32, head sizes 8, 16, 32: CUDA cores, one block per
//   (frame, head); every other float32 head: two launches on the CUDA
//   cores at the end of the file.
// What bounds the core at the flagship shape (160 frames x 1024 tokens, 16
// heads x 8): bytes. It reads bf16 q, k and v (126 MB) and writes the
// attention (42 MB), 0.05 ms at 3.35 TB/s; its tensor-core work, 13.4
// GFLOP of m16n8k16 (a third of it padding), is a fraction of that. At
// heads of 32 (160 frames x 1024 tokens, 8 heads x 32) it is operations,
// barely: phi_ij == phi_ji, so the function needs F = 1 + d + d (d + 1) / 2
// = 561 features a head, 4 F (d + 1) + 2 d (d + 1) = 76 k FLOPs a token and
// head, 99.8 GFLOP, 0.101 ms at 989 TFLOP/s, against 0.100 ms of bytes
// (336 MB of q, k, v and the attention); at 4 heads of 64, 371 GFLOP,
// 0.375 ms, against 0.100 ms.
#include "hopper.cuh"

namespace mv2 {

enum TaylorRoute { kTaylorF32 = 0, kTaylorMma = 1 };

// ---- kTaylorF32: CUDA cores ------------------------------------------------

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

// One block per (frame, head), float32 qkv with q already scaled. Phase 1
// reduces the moments over the frame's N tokens: tokens are staged
// kTaylorTile at a time as features in shared memory, and each moment has
// one owner thread, so there are no atomics. Phase 2 gives each token its
// output from the moments.
template <int D>
__global__ void __launch_bounds__(kTaylorThreads)
    taylor_core_f32_kernel(const float* __restrict__ qkv,
                           float* __restrict__ attn, int N, int H,
                           float eps) {
  constexpr int kMoments = D + D * D + D * D * D + D + D * D;
  constexpr int kFeat = 1 + 2 * D;
  extern __shared__ float smem[];
  float* mom = smem;                 // kMoments
  float* feat = smem + kMoments;     // kTaylorTile x kFeat
  const int g = blockIdx.x / H, h = blockIdx.x % H;
  const int hd = H * D;
  const long long ld = 3LL * hd;
  const float* frame = qkv + (long long)g * N * ld;
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
          val = frame[n * ld + hd + h * D + (f - 1)];
        } else {
          val = frame[n * ld + 2 * hd + h * D + (f - 1 - D)];
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
  // out of the token loop into registers (255 registers and spills)
  const volatile float* A0 = mom;
  const volatile float* A1 = A0 + D;
  const volatile float* A2 = A1 + D * D;
  const volatile float* sk = A2 + D * D * D;
  const volatile float* skk = sk + D;
  // one thread a token; the loop over i stays rolled (D^2 FMAs a turn, D^3
  // unrolled would not build at D = 32), q_i read again from the row
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float* qrow = frame + n * ld + h * D;
    float q[D], num[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      q[i] = qrow[i];
      num[i] = A0[i];
    }
    float den = (float)N;
#pragma unroll 1
    for (int i = 0; i < D; ++i) {
      const float qi = qrow[i];
      den += qi * sk[i];
#pragma unroll
      for (int e = 0; e < D; ++e) num[e] += qi * A1[i * D + e];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float qq = qi * q[j] * kInvSqrt2;
        den += qq * skk[i * D + j];
        const volatile float* a2 = A2 + (i * D + j) * D;
#pragma unroll
        for (int e = 0; e < D; ++e) num[e] += qq * a2[e];
      }
    }
    const float r = 1.f / (den + eps);
    float* orow = attn + ((long long)g * N + n) * hd + h * D;
#pragma unroll
    for (int e = 0; e < D; ++e) orow[e] = num[e] * r;
  }
}

template <int D>
cudaError_t launch_taylor_core_f32(const float* qkv, float* attn, int frames,
                                   int N, int H, float eps,
                                   cudaStream_t stream) {
  constexpr int kMoments = D + D * D + D * D * D + D + D * D;
  const size_t smem = sizeof(float) * (kMoments + kTaylorTile * (1 + 2 * D));
  if (smem > 48 * 1024) {   // D = 32: 173 KB of moments and features
    cudaError_t err = cudaFuncSetAttribute(
        taylor_core_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  taylor_core_f32_kernel<D><<<frames * H, kTaylorThreads, smem, stream>>>(
      qkv, attn, N, H, eps);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// ---- kTaylorMma: tensor cores ----------------------------------------------
//
// A block of eight warps owns one frame and a group of up to four heads;
// warps w and w + 4 share head w of the group, each taking every other
// 16-token tile. The frame's tokens stream through a three-stage cp.async
// ring in chunks of 128, one barrier a chunk (at the flagship shape on an
// H100 80GB HBM3 at 700 W, two stages of 64 tokens took 0.153 ms, three
// 0.148; two of 128 0.131, three 0.126: tools/taylor_core_variants.py):
// first k and v (the group's 64 bytes of each a token), then q. For a head, phi has 80 feature rows: k_j (0-7),
// phi_ij = bf16(bf16(k_i k_j) * bf16(1/sqrt2)) at 8 + 8i + j (8-71), a
// constant 1 (72) and zeros (73-79).
// Phase 1, per 16-token tile: [A | S] (80 x 16) += phi(k)^T [v | 1], five
//   row tiles by two column tiles of m16n8k16, phi(k) built in registers
//   as the A operand (bf16x2 products), v and the ones column as B. Row 72
//   gives sum v (and the token count) in float32.
// Reduction: warp w + 4 leaves its float32 partial in shared memory and
//   warp w adds it (always in that order: no atomics, and a frame's output
//   does not depend on its batch), rounds A and S to bf16 into a
//   transposed [A | S] (16 x 80) in shared memory and keeps sum v in
//   float32.
// Phase 2, per 16-token tile: [num | den] = phi(q) [A | S] on five K steps
//   by two column tiles, phi(q) built in registers, [A | S] loaded once
//   into B fragments; then num + sum v, den + N, r = bf16(1 / (den + eps))
//   and out = bf16(num r).
// The 72 real features of 80 and the 9 real columns of 16 leave the
// tensor cores two thirds busy; they are not what bounds the kernel.
constexpr int kTcD = 8;                  // head size
constexpr int kTcHeads = 4;              // heads a block
constexpr int kTcWarps = 2 * kTcHeads;   // two a head
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcChunk = 128;            // tokens a ring stage
constexpr int kTcStages = 3;             // ring stages
constexpr int kTcTiles = kTcChunk / 16;
// a staged token row in bf16: k of the group's heads, then v, then 16
// bytes of padding, so the four tokens a quarter-warp reads fall in
// different banks (phase 2 stages only q, in rows of kTcQLd)
constexpr int kTcKvLd = 2 * kTcHeads * kTcD + 8;
constexpr int kTcQLd = kTcHeads * kTcD + 8;
constexpr int kTcStage = kTcChunk * kTcKvLd;    // bf16 a stage
constexpr int kTcFeat = 80;                     // phi rows, padded
constexpr int kTcConst = 72;                    // the constant feature
constexpr int kTcAcc = 5 * 2 * 4;               // float32 partials a lane
constexpr int kTcBtLd = kTcFeat + 8;            // [A | S]^T row, bf16
constexpr size_t kTcSmem =
    sizeof(bf16) * kTcStages * kTcStage                  // the ring
    + sizeof(float) * kTcHeads * kTcAcc * 32             // partials
    + sizeof(bf16) * kTcHeads * 16 * kTcBtLd             // [A | S]^T
    + sizeof(float) * kTcHeads * kTcD;                   // sum v

__device__ __forceinline__ unsigned bmul2(unsigned a, unsigned b) {
  // a * b on two bf16 lanes, each rounded once (round to nearest even)
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// lane 0 of a and lane 0 of b (hi = false), or lane 1 of each (hi = true),
// as one bf16 pair
__device__ __forceinline__ unsigned pair_of(unsigned a, unsigned b, bool hi) {
  return __byte_perm(a, b, hi ? 0x7632 : 0x5410);
}

__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element i of a row of 8 bf16, in both lanes
__device__ __forceinline__ unsigned bcast(const uint4& row, int i) {
  const unsigned w = word_of(row, i / 2);
  return __byte_perm(w, w, i % 2 ? 0x3232 : 0x1010);
}

__device__ __forceinline__ unsigned bits(bf16 v) {
  return static_cast<unsigned>(*reinterpret_cast<const unsigned short*>(&v));
}

// Phase 1 on one 16-token tile of a head: rows of kTcKvLd bf16 from `tile`,
// k of the head at hk, v at hk + kTcHeads * kTcD.
__device__ __forceinline__ void moments_tile(float (&acc)[5][2][4],
                                             const bf16* tile, int hk,
                                             unsigned inv_sqrt2) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  const int hv = hk + kTcHeads * kTcD;
  // this lane's tokens: the A operand's columns and the B operand's rows
  // 2tq, 2tq + 1 (pair 0) and 2tq + 8, 2tq + 9 (pair 1)
  uint4 k[4];
  unsigned kg[2], vg[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const bf16* r0 = tile + (2 * tq + 8 * p) * kTcKvLd;
    const bf16* r1 = r0 + kTcKvLd;
    k[2 * p] = *reinterpret_cast<const uint4*>(r0 + hk);
    k[2 * p + 1] = *reinterpret_cast<const uint4*>(r1 + hk);
    kg[p] = bits(r0[hk + g]) | bits(r1[hk + g]) << 16;
    vg[p] = bits(r0[hv + g]) | bits(r1[hv + g]) << 16;
  }
  // phi_ig of the two pairs: bf16(bf16(k_i k_g) / sqrt2)
  auto phi = [&](int i, int p) -> unsigned {
    const unsigned ki = pair_of(word_of(k[2 * p], i / 2),
                                word_of(k[2 * p + 1], i / 2), i % 2);
    return bmul2(bmul2(ki, kg[p]), inv_sqrt2);
  };
  const unsigned one2 = 0x3F803F80u;   // bf16 1.0 in both lanes
  const unsigned ones = g == 0 ? one2 : 0u;
#pragma unroll
  for (int mt = 0; mt < 5; ++mt) {
    // rows g and g + 8 of row tile mt (see the feature order above)
    unsigned a[4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      a[2 * p] = mt == 0 ? kg[p] : phi(2 * mt - 1, p);
      a[2 * p + 1] = mt < 4 ? phi(2 * mt, p) : ones;  // row 72: the constant
    }
    mma_16816(acc[mt][0], a, vg[0], vg[1]);
    mma_16816(acc[mt][1], a, ones, ones);   // column 8 (S): ones
  }
}

// Phase 2 on one 16-token tile of a head: rows of kTcQLd bf16 from `tile`,
// q of the head at hq; tokens tok0 + (0..15) of the frame, the first
// `valid` of them real.
__device__ __forceinline__ void output_tile(
    const unsigned (&bf)[5][2][2], float sv0, float sv1, const bf16* tile,
    int hq, bf16* __restrict__ out, int hd, int valid, int N, float eps,
    unsigned inv_sqrt2) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
  uint4 q[2];
  unsigned qp[2];   // q_{2tq}, q_{2tq+1} of tokens g and g + 8
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const bf16* row = tile + (g + 8 * p) * kTcQLd + hq;
    q[p] = *reinterpret_cast<const uint4*>(row);
    qp[p] = *reinterpret_cast<const unsigned*>(row + 2 * tq);
  }
  auto phi = [&](int i, int p) -> unsigned {   // phi_{i, 2tq (+1)}
    return bmul2(bmul2(bcast(q[p], i), qp[p]), inv_sqrt2);
  };
  float num[4] = {0.f, 0.f, 0.f, 0.f}, den[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < 5; ++ks) {
    // features 16ks + 2tq (+1) and 16ks + 2tq + 8 (+9)
    const unsigned a[4] = {ks == 0 ? qp[0] : phi(2 * ks - 1, 0),
                           ks == 0 ? qp[1] : phi(2 * ks - 1, 1),
                           ks < 4 ? phi(2 * ks, 0) : 0u,
                           ks < 4 ? phi(2 * ks, 1) : 0u};
    mma_16816(num, a, bf[ks][0][0], bf[ks][0][1]);
    mma_16816(den, a, bf[ks][1][0], bf[ks][1][1]);
  }
  // den sits in column 0 of the second tile: lanes with tq == 0
  const float n = (float)N;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const float d = __shfl_sync(0xffffffffu, den[2 * p], lane & ~3) + n;
    const float r = round_to<bf16>(1.f / (d + eps));
    const int t = g + 8 * p;
    if (t < valid)
      *reinterpret_cast<unsigned*>(out + (long long)t * hd + 2 * tq) =
          pack_bf16((num[2 * p] + sv0) * r, (num[2 * p + 1] + sv1) * r);
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
    taylor_core_mma_kernel(const bf16* __restrict__ qkv,
                           bf16* __restrict__ attn, int N, int H, float eps) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);
  float* part = reinterpret_cast<float*>(ring + kTcStages * kTcStage);
  bf16* bt = reinterpret_cast<bf16*>(part + kTcHeads * kTcAcc * 32);
  float* sv = reinterpret_cast<float*>(bt + kTcHeads * 16 * kTcBtLd);

  const int groups = (H + kTcHeads - 1) / kTcHeads;
  const long long frame = blockIdx.x / groups;
  const int h0 = (blockIdx.x % groups) * kTcHeads;
  const int hg = min(kTcHeads, H - h0);
  const int hd = H * kTcD;
  const long long ld = 3LL * hd;
  const bf16* fbase = qkv + frame * N * ld + h0 * kTcD;
  const int nch = (N + kTcChunk - 1) / kTcChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int hw = warp % kTcHeads, half = warp / kTcHeads;
  const bool active = hw < hg;   // warp-uniform
  const unsigned inv_sqrt2 = bits(__float2bfloat16(0.70710678118654752f)) *
                             0x10001u;

  // chunk c of 2 nch into stage c % kTcStages: k and v (c < nch) or q;
  // rows past N are zeros
  auto stage = [&](int c) {
    const bool kv = c < nch;
    const int t0 = (kv ? c : c - nch) * kTcChunk;
    const int pieces = kv ? 2 * hg : hg;   // 16 bytes a head and tensor
    const int row_ld = kv ? kTcKvLd : kTcQLd;
    bf16* buf = ring + (c % kTcStages) * kTcStage;
    for (int idx = threadIdx.x; idx < kTcChunk * pieces; idx += kTcThreads) {
      const int t = idx / pieces, p = idx % pieces;
      const int head = p % hg, which = kv ? 1 + p / hg : 0;  // q, k, v
      const int n = min(t0 + t, N - 1);
      cp_async16(buf + t * row_ld + (which == 2 ? kTcHeads * kTcD : 0) +
                     head * kTcD,
                 fbase + n * ld + which * hd + head * kTcD, t0 + t < N);
    }
  };

  float acc[5][2][4];
#pragma unroll
  for (int mt = 0; mt < 5; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the ring: chunk c lands in stage c % kTcStages; at chunk c the block
  // waits for it, meets (so every warp is done with chunk c - 1) and
  // refills chunk c - 1's stage with chunk c + kTcStages - 1
  const int chunks = 2 * nch;
  auto next = [&](int c) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();
    if (c + kTcStages - 1 < chunks) stage(c + kTcStages - 1);
    cp_async_commit();
    return ring + (c % kTcStages) * kTcStage;
  };
  for (int c = 0; c < kTcStages - 1; ++c) {
    if (c < chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    const bf16* buf = next(c);
    if (active)
      for (int tl = half; tl < kTcTiles && c * kTcChunk + 16 * tl < N;
           tl += 2)
        moments_tile(acc, buf + 16 * tl * kTcKvLd, hw * kTcD, inv_sqrt2);
  }

  // the two partials of a head, in a fixed order; then [A | S] in bf16,
  // transposed, and sum v in float32
  float* mine = part + (hw * kTcAcc) * 32 + lane;
  __syncthreads();   // every warp is past phase 1
  if (active && half == 1)
#pragma unroll
    for (int i = 0; i < kTcAcc; ++i) mine[32 * i] = (&acc[0][0][0])[i];
  __syncthreads();
  bf16* bth = bt + hw * 16 * kTcBtLd;
  if (active && half == 0) {
#pragma unroll
    for (int mt = 0; mt < 5; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float s =
              acc[mt][nt][e] + mine[32 * ((mt * 2 + nt) * 4 + e)];
          const int f = 16 * mt + g + 8 * (e / 2);
          const int col = 8 * nt + 2 * tq + e % 2;
          if (f == kTcConst && nt == 0) sv[hw * kTcD + col] = s;
          bth[col * kTcBtLd + f] = __float2bfloat16(f == kTcConst ? 0.f : s);
        }
  }
  __syncthreads();

  // [A | S] as the B operand: feature rows 16ks + 2tq (+1) and + 8 (+9),
  // column 8nt + g
  unsigned bf[5][2][2];
#pragma unroll
  for (int ks = 0; ks < 5; ++ks)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const bf16* src = bth + (8 * nt + g) * kTcBtLd + 16 * ks + 2 * tq;
      bf[ks][nt][0] = *reinterpret_cast<const unsigned*>(src);
      bf[ks][nt][1] = *reinterpret_cast<const unsigned*>(src + 8);
    }
  const float sv0 = sv[hw * kTcD + 2 * tq], sv1 = sv[hw * kTcD + 2 * tq + 1];
  bf16* out = attn + frame * N * hd + (h0 + hw) * kTcD;
  for (int c = nch; c < chunks; ++c) {
    const bf16* buf = next(c);
    const int t0 = (c - nch) * kTcChunk;
    if (active)
      for (int tl = half; tl < kTcTiles && t0 + 16 * tl < N; tl += 2)
        output_tile(bf, sv0, sv1, buf + 16 * tl * kTcQLd, hw * kTcD,
                    out + (long long)(t0 + 16 * tl) * hd, hd,
                    N - t0 - 16 * tl, N, eps, inv_sqrt2);
  }
}

cudaError_t launch_taylor_core_mma(const bf16* qkv, bf16* attn, int frames,
                                   int N, int H, float eps,
                                   cudaStream_t stream) {
  if (N < 1 || H < 1 || (uintptr_t)qkv % 16)
    return cudaErrorInvalidValue;  // cp.async takes 16-byte pieces
  cudaError_t err = cudaFuncSetAttribute(
      taylor_core_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTcSmem);
  if (err != cudaSuccess) return err;
  const int groups = (H + kTcHeads - 1) / kTcHeads;
  taylor_core_mma_kernel<<<frames * groups, kTcThreads, kTcSmem, stream>>>(
      qkv, attn, N, H, eps);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// ---- kTaylorMma at every other head: the wgmma core, two launches ---------
//
// Every bf16 head of 16 to 256 (a multiple of 8; the wrapper pads the
// others), built at the padded widths D = 16, 32, 64, 128, 256 with the true
// head size d at run time. Past d = 8 a head's [A | S] outgrows a block (at
// d = 32 its float32 moments are ~74 KB, at 256 ~35 MB), so two launches
// meet in scratch, with _taylor_frame's cast points (taylor_attention.py
// :55-107): phi_ij = bf16(bf16(k_i k_j) bf16(1/sqrt2)), [A | S] rounded to
// bf16, sum v and den + N in float32, r = bf16(1 / (den + eps)).
//
// Feature rows. phi_ij == phi_ji to the bit, so a row is built once for
// each pair i <= j; the wrapper hands both launches the rows as a table
// (ops/kernels/taylor_attention.py feature_pairs / pair_table), one word a
// row: the staged rows x | y << 16 of its two factors in [k | 1 | 0] (q in
// the second launch), bit 31 set on the product rows. First the constant
// (1 * 1) and the k_j (1 * k_j), zeros up to a multiple of 16, then the
// products phi = bf16(bf16(x y) bf16(1/sqrt2)), zeros up to a multiple of
// 64: F = 1 + d + d (d + 1) / 2 features in at most 1.05 F rows from d = 32
// on. Rows r and r + 8 of every 16-row step share their first factor, so a
// lane (which holds rows g and g + 8 in launch 1, features f and f + 8 in
// launch 2) loads it once. An off-diagonal row stands for phi_ij and
// phi_ji: launch 1 stores its [A | S] row doubled (exact in bf16).
//
// Launch 1 (taylor_moments_wg_kernel), grid (frame x head) x slab, slab
// fastest: [A | S] = phi(k)^T [v | 1] over the frame's N tokens, M =
// feature rows, N = the D + 8 columns [v | 1 | 0], K = tokens. A slab is
// 2 kMt tiles of 64 rows; each of two warpgroups keeps kMt tiles' float32
// accumulators over all N tokens (no sum crosses blocks). Thread 0 keeps
// the (frame, head)'s k and v in flight by TMA, kTok tokens a chunk, in an
// mbarrier ring (boxes of kTok tokens by D or 64 columns, swizzled; a 3-D
// map, so rows past the frame read 0). The block transposes each chunk
// once (ldmatrix.trans) into shared tiles: k feature-major, each lane's
// eight tokens of two 16-token steps in one 16-byte piece (rows permuted by
// kt_row against bank conflicts), and [v | 1] K-major with the 128-byte
// swizzle (wgmma's B), 64 tokens a step. Per 64-token step a warp builds
// its 16 rows of phi(k)^T of every tile in registers from three 16-byte
// loads of k a row pair and 32 tokens (bf16x2 products) and the warpgroup
// issues wgmma.m64n(D+8)k16 with A from registers, tile-interleaved (the
// tiles' accumulators are independent chains). At D = 16 a step's wgmmas
// run while the next step's A is built (A double-buffered); at the wider
// widths each step's group retires first, which measured faster. The
// epilogue stages each tile in shared memory and writes it, bf16 and
// transposed (K-major for launch 2), to scratch: d + 8 rows of the F rows
// rounded to 64, and sum v in float32 from the constant row (whose scratch
// row is 0).
// Launch 2 (taylor_apply_wg_kernel), grid (frame x head) x (kTokA
// tokens), tokens fastest: [num | den] = phi(q) [A | S], M = tokens, K =
// feature rows, N = D + 8. The block holds its tokens' q in shared memory
// as token pairs (the two rows of an A fragment's lane) per head dimension;
// thread 0 streams [A | S]^T in chunks of 64 feature rows by TMA (128-byte
// swizzle, wgmma's B) with the chunk's table words (bulk copy) through a
// kBStages ring. Per 16-row step a lane builds its four features of phi(q)
// for its tokens (bf16x2 products of six 4-byte loads, paired by byte_perm)
// while the previous step's wgmmas run (A double-buffered), and each
// warpgroup issues wgmma.m64n(D+8)k16 on its kMta tiles of 64 tokens. Then
// num + sum v, den + N, r = bf16(1 / (den + eps)), out = bf16(num r).
// What bounds it: operations, 4 F (d + 1) + 4 d (d + 1) / 2 FLOPs a token
// and head (chip_smoke.py taylor_core_flops), against the q, k, v and
// output bytes; the tensor cores do 4 F' (D + 8) (F' the rows). What holds
// it at 3-4x that (PERF.md, section 6): shared memory, which carries B at
// n = d + 8 (at n = 72 half its rate at the tensor cores' pace), the A
// operands' loads and the chunk transposes, and one or two blocks an SM to
// hide the latency of each step. The tile counts, rings and chunk sizes
// per width are tools/taylor_wg_variants.py's fastest.
template <int D>
struct WgTc {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256,
                "the wgmma core's widths");
  static constexpr int kOne = D, kZero = D + 1;   // staged rows of 1 and 0
  static constexpr int kRows = D + 2;             // staged rows a token
  static constexpr int kN = D + 8;                // wgmma n: [v | 1 | 0]
  static constexpr int kAcc = kN / 2;             // floats a lane a tile
  static constexpr int kThreads = 256;            // two warpgroups
  // launch 1
  static constexpr int kTok = D <= 64 ? 128 : 64;   // tokens a chunk
  static constexpr int kSub = kTok / 64;          // 64-token steps a chunk
  static constexpr int kSw = D <= 64 ? 2 * D : 128;   // box row bytes
  static constexpr int kBoxCols = kSw / 2;
  static constexpr int kAtomBytes = kTok * kSw;   // one box
  static constexpr int kAtoms = D / kBoxCols;     // boxes of k (and of v)
  static constexpr int kRawStages = D == 256 ? 1 : 2;   // ring stages
  static constexpr int kRawBytes = 2 * kAtoms * kAtomBytes;
  static constexpr int kVtStep = kN * 128;        // [v | 1 | 0]^T, 64 tokens
  static constexpr int kVtBytes = kSub * kVtStep;
  static constexpr int kKtPart = kRows * 64;      // k^T, 32 tokens a row
  static constexpr int kKtBytes = kTok / 32 * kKtPart;
  static constexpr int kMt = D == 16 ? 2 : D == 32 ? 5 : D == 64 ? 4
                           : D == 128 ? 2 : 1;    // tiles a warpgroup
  // a step's wgmmas run while the next step's A is built (D = 16), or
  // retire first (the wider widths measured faster so)
  static constexpr bool kOverlap = D == 16;
  static constexpr int kBlocks1 = D == 16 ? 3 : 1;   // blocks an SM
  static constexpr int kSlabRows = 2 * kMt * 64;
  static constexpr int kStageLd = 72;             // epilogue row, bf16
  static constexpr size_t kSmem1 =
      1024 + (size_t)kRawStages * kRawBytes + 2 * kVtBytes + 2 * kKtBytes +
      4 * kSlabRows;
  static_assert(2 * kN * kStageLd * 2 <= 2 * kVtBytes + 2 * kKtBytes,
                "the epilogue's staging fits the chunk tiles");
  // launch 2
  static constexpr int kMta = D == 256 ? 1 : 2;   // 64-token tiles a warpgroup
  static constexpr int kBlocks2 = D <= 64 ? 2 : 1;   // blocks an SM
  static constexpr int kTokA = 128 * kMta;        // tokens a block
  // words a staged q row: 2 mod 32, so the four rows a quad reads in a
  // step (j, j + 4, j + 8, j + 12: feature_pairs' twins) hit other banks
  static constexpr int kQpLd = kTokA / 2 + 2;
  static constexpr int kBStages = 3;
  static constexpr int kBBytes = kN * 128;        // 64 feature rows of B
  static constexpr size_t kSmem2 = 1024 + (size_t)kBStages * kBBytes +
                                   kBStages * 256 + 4 * kRows * kQpLd;
  static_assert(kSmem1 <= 232448 && kSmem2 <= 232448, "shared memory");
};

// the byte offset of byte a of a box whose rows are `sw` bytes, as TMA's
// swizzle places it (the box starting on a 1024-byte boundary)
__device__ __forceinline__ int swizzled(int a, int sw) {
  return a ^ (((a >> 7) & (sw / 16 - 1)) << 4);
}

// the place of staged k^T row x among 64-byte rows: rows x and x + 2 (the
// first rows of two neighbouring twins, read by one quarter-warp) fall in
// different halves of the 128-byte bank space
__device__ __forceinline__ int kt_row(int x) { return x ^ (x >> 1 & 1); }

// phi of two bf16 pairs: bf16(bf16(x y) c), each product rounded once
__device__ __forceinline__ unsigned phi2(unsigned x, unsigned y, unsigned c) {
  return bmul2(bmul2(x, y), c);
}

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int D>
__global__ void __launch_bounds__(WgTc<D>::kThreads, WgTc<D>::kBlocks1)
    taylor_moments_wg_kernel(const __grid_constant__ CUtensorMap map_qkv,
                             const unsigned* __restrict__ pairs,
                             bf16* __restrict__ mom,
                             float* __restrict__ sumv, int N, int H, int d,
                             int feats, int slabs) {
  using W = WgTc<D>;
  extern __shared__ unsigned char tg_smem[];
  __shared__ __align__(8) uint64_t full[W::kRawStages];
  unsigned char* raw = align1024(tg_smem);
  unsigned char* vt = raw + W::kRawStages * W::kRawBytes;
  unsigned char* kt = vt + 2 * W::kVtBytes;
  unsigned* tbl = reinterpret_cast<unsigned*>(kt + 2 * W::kKtBytes);
  // the slabs of a (frame, head) are neighbours in the grid: they run
  // together and read its k and v from L2
  const int fh = blockIdx.x / slabs, frame = fh / H, h = fh % H;
  const int tiles = feats / 64, tile0 = blockIdx.x % slabs * 2 * W::kMt;
  const int nch = (N + W::kTok - 1) / W::kTok;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // thread 0 keeps k and v of chunk c in flight by TMA into stage c % S,
  // refilling a stage once the block has transposed it
  const int atoms = (d + W::kBoxCols - 1) / W::kBoxCols;
  auto load = [&](int c) {
    const int s = c % W::kRawStages;
    const int ck = H * d + h * d, cv = 2 * H * d + h * d;
    unsigned char* st = raw + s * W::kRawBytes;
    mbar_expect_tx(&full[s], 2 * atoms * W::kAtomBytes);
    for (int a = 0; a < atoms; ++a) {
      tma_load_3d(st + a * W::kAtomBytes, &map_qkv, &full[s],
                  ck + a * W::kBoxCols, c * W::kTok, frame);
      tma_load_3d(st + (W::kAtoms + a) * W::kAtomBytes, &map_qkv, &full[s],
                  cv + a * W::kBoxCols, c * W::kTok, frame);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < W::kRawStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < W::kRawStages && c < nch; ++c) load(c);
  }
  __syncthreads();

  // constant rows: k^T's 1 and 0 rows, [v | 1 | 0]^T's zero rows past d
  // (row d, the ones, is written with each chunk); the slab's table
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  const uint4 ones4 = make_uint4(0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                                 0x3F803F80u);
  constexpr int kParts = 2 * W::kTok / 32;   // 32-token parts, both buffers
  for (int idx = tid; idx < kParts * 2 * 4; idx += 256) {   // part, row
    const int piece = idx % 4, row = (idx / 4) % 2, part = idx / 8;
    *reinterpret_cast<uint4*>(kt + part * W::kKtPart +
                              kt_row(W::kOne + row) * 64 + 16 * piece) =
        row == 0 ? ones4 : zero4;
  }
  const int zrows = W::kN - d - 1;   // per 64-token step of both buffers
  for (int idx = tid; idx < 2 * W::kSub * zrows * 8; idx += 256) {
    const int piece = idx % 8, e = d + 1 + (idx / 8) % zrows,
              step = idx / (8 * zrows);
    *reinterpret_cast<uint4*>(vt + step * W::kVtStep + e * 128 +
                              16 * piece) = zero4;
  }
  for (int r = tid; r < W::kSlabRows; r += 256) {
    const int row = tile0 * 64 + r;
    tbl[r] = row < feats ? pairs[row] : (unsigned)(W::kZero | W::kZero << 16);
  }

  const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
  const unsigned one2 = 0x3F803F80u;
  const unsigned inv2 = bits(__float2bfloat16(0.70710678118654752f)) *
                        0x10001u;
  float acc[W::kMt][W::kAcc];
#pragma unroll
  for (int m = 0; m < W::kMt; ++m)
#pragma unroll
    for (int i = 0; i < W::kAcc; ++i) acc[m][i] = 0.f;

  // chunk c: wait for its stage and transpose it once (ldmatrix.trans) into
  // buffer c & 1; item (fb, part) of k and of v is the 8 features 8fb.. at
  // the 32 tokens of a part; lane (g, tq) gets feature 8fb + g at tokens
  // 32 part + 8 m + 2tq, + 1 in register m
  auto transpose = [&](int c) {
    const int s = c % W::kRawStages;
    mbar_wait(&full[s], (c / W::kRawStages) & 1);
    const unsigned char* st = raw + s * W::kRawBytes;
    unsigned char* ktb = kt + (c & 1) * W::kKtBytes;
    unsigned char* vtb = vt + (c & 1) * W::kVtBytes;
    constexpr int kParts = W::kTok / 32;
    const int items = d / 8 * kParts;
    for (int it = warp; it < 2 * items; it += 8) {
      const bool is_v = it >= items;
      const int fb = (it % items) / kParts, part = it % kParts;
      const int t = 32 * part + 8 * (lane / 8) + lane % 8;
      const int off = swizzled(t * W::kSw + 16 * (fb % (W::kSw / 16)),
                               W::kSw);
      unsigned r[4];
      ldmatrix_x4_trans(r, st + (is_v ? W::kAtoms : 0) * W::kAtomBytes +
                               fb / (W::kSw / 16) * W::kAtomBytes + off);
      const int e = 8 * fb + g;
      if (!is_v) {   // k^T: one 16-byte piece a lane
        *reinterpret_cast<uint4*>(ktb + part * W::kKtPart + kt_row(e) * 64 +
                                  16 * tq) = make_uint4(r[0], r[1], r[2],
                                                        r[3]);
      } else {       // [v | 1]^T, K-major, 128-byte swizzle, 64 tokens a
                     // step
#pragma unroll
        for (int m = 0; m < 4; ++m)
          *reinterpret_cast<unsigned*>(
              vtb + part / 2 * W::kVtStep + e / 8 * 1024 + e % 8 * 128 +
              (((4 * (part % 2) + m) ^ (e % 8)) * 16) + 4 * tq) = r[m];
      }
    }
    if (tid < 8 * W::kSub) {   // row d: 1 at the chunk's real tokens
                               // (d % 8 == 0: the row is not swizzled)
      const int real = N - c * W::kTok - 8 * tid;
      unsigned w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (2 * k < real ? 0x3F80u : 0u) |
               (2 * k + 1 < real ? 0x3F800000u : 0u);
      *reinterpret_cast<uint4*>(vtb + tid / 8 * W::kVtStep + d * 128 +
                                16 * (tid % 8)) = make_uint4(w[0], w[1],
                                                             w[2], w[3]);
    }
    fence_proxy_async();
    __syncthreads();   // chunk c is transposed: its stage refills
    if (tid == 0 && c + W::kRawStages < nch) load(c + W::kRawStages);
  };

  // A of every tile of the warpgroup at chunk c: rows g and g + 8 of a
  // warp's 16 share their first factor (feature_pairs); tokens 2tq, 2tq + 1
  // (a0, a1) and 2tq + 8, 2tq + 9 (a2, a3) of steps 2 half and 2 half + 1.
  // Every tile slot builds and issues, past the last tile too (its rows are
  // the zero row): a wgmma behind a branch is serialized.
  auto build = [&](unsigned(&a)[W::kMt][4][4], int c, int step) {
    const unsigned char* ktb =
        kt + (c & 1) * W::kKtBytes + 2 * step * W::kKtPart;
#pragma unroll
    for (int m = 0; m < W::kMt; ++m) {
      const int rl = (wg * W::kMt + m) * 64 + wq * 16 + g;
      const unsigned e0 = tbl[rl], e1 = tbl[rl + 8];
      const unsigned cf = e0 >> 31 ? inv2 : one2;   // one kind a step
      const unsigned char* pi = ktb + kt_row(e0 & 0x7FFF) * 64 + 16 * tq;
      const unsigned char* pj0 =
          ktb + kt_row(e0 >> 16 & 0x7FFF) * 64 + 16 * tq;
      const unsigned char* pj1 =
          ktb + kt_row(e1 >> 16 & 0x7FFF) * 64 + 16 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = half * W::kKtPart;
        const uint4 i = *reinterpret_cast<const uint4*>(pi + o);
        const uint4 j0 = *reinterpret_cast<const uint4*>(pj0 + o);
        const uint4 j1 = *reinterpret_cast<const uint4*>(pj1 + o);
        unsigned(&s0)[4] = a[m][2 * half];
        unsigned(&s1)[4] = a[m][2 * half + 1];
        s0[0] = phi2(i.x, j0.x, cf);
        s0[1] = phi2(i.x, j1.x, cf);
        s0[2] = phi2(i.y, j0.y, cf);
        s0[3] = phi2(i.y, j1.y, cf);
        s1[0] = phi2(i.z, j0.z, cf);
        s1[1] = phi2(i.z, j1.z, cf);
        s1[2] = phi2(i.w, j0.w, cf);
        s1[3] = phi2(i.w, j1.w, cf);
      }
    }
  };
  // step-major: the tiles' accumulators are independent chains, so
  // consecutive wgmmas do not wait on each other
  auto issue = [&](const unsigned(&a)[W::kMt][4][4], int c, int step) {
    const uint64_t db =
        sw128_desc(vt + (c & 1) * W::kVtBytes + step * W::kVtStep);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int m = 0; m < W::kMt; ++m) wgmma_rs(acc[m], a[m][ks], db + 2 * ks);
    wgmma_commit();
  };
  // a 64-token step of chunk c; with kOverlap the previous step is in
  // flight while its A is built (A double-buffered: a wgmma's registers
  // stay untouched until its group retires) and retires after it issues,
  // else each step retires its own group
  auto step = [&](unsigned(&a)[W::kMt][4][4], int c, int s) {
    build(a, c, s);
    issue(a, c, s);
    if constexpr (W::kOverlap)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
  };
  // chunk c is transposed into buffer c & 1, whose readers (chunk c - 2's
  // steps) have retired and the block has met since; after its steps the
  // block meets again
  unsigned a0[W::kMt][4][4], a1[W::kMt][4][4];   // [tile][step][fragment]
  for (int c = 0; c < nch; ++c) {
    transpose(c);
    step(a0, c, 0);
    if constexpr (W::kSub == 2) {
      if constexpr (W::kOverlap)
        step(a1, c, 1);
      else   // step 0 has retired: its registers take step 1
        step(a0, c, 1);
    }
    __syncthreads();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < W::kMt; ++m) fence_acc(acc[m]);
  __syncthreads();   // every wgmma has read its tiles: they are free

  // per tile: rows g, g + 8 of the warp, columns 8j + 2tq (+1), staged in
  // bf16 as [column][row] (the constant row 0, doubled off-diagonal rows),
  // then written to scratch 16 bytes a thread
  bf16* stage = reinterpret_cast<bf16*>(vt) + wg * W::kN * W::kStageLd;
  const int cols = d + 8;
  bf16* mh = mom + (size_t)fh * cols * feats;
#pragma unroll
  for (int m = 0; m < W::kMt; ++m) {
    const int tile = tile0 + wg * W::kMt + m;
    if (tile >= tiles) break;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = wq * 16 + g + 8 * hr, f = tile * 64 + row;
      const unsigned e = tbl[(wg * W::kMt + m) * 64 + row];
      const float scale = f == 0 ? 0.f
                          : e >> 31 && (e & 0x7FFF) != (e >> 16 & 0x7FFF)
                              ? 2.f
                              : 1.f;
#pragma unroll
      for (int j = 0; j < W::kN / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        const float v0 = acc[m][4 * j + 2 * hr];
        const float v1 = acc[m][4 * j + 2 * hr + 1];
        if (f == 0 && col < d) {   // sum v, float32
          sumv[(size_t)fh * d + col] = v0;
          sumv[(size_t)fh * d + col + 1] = v1;
        }
        stage[col * W::kStageLd + row] = __float2bfloat16(v0 * scale);
        stage[(col + 1) * W::kStageLd + row] = __float2bfloat16(v1 * scale);
      }
    }
    bar_sync(2 + wg, 128);
    for (int idx = tid % 128; idx < cols * 8; idx += 128) {
      const int col = idx / 8, piece = idx % 8;
      *reinterpret_cast<uint4*>(mh + (size_t)col * feats + tile * 64 +
                                8 * piece) =
          *reinterpret_cast<const uint4*>(stage + col * W::kStageLd +
                                          8 * piece);
    }
    bar_sync(2 + wg, 128);
  }
}

template <int D>
__global__ void __launch_bounds__(WgTc<D>::kThreads, WgTc<D>::kBlocks2)
    taylor_apply_wg_kernel(const __grid_constant__ CUtensorMap map_mom,
                           const bf16* __restrict__ qkv,
                           const unsigned* __restrict__ pairs,
                           const float* __restrict__ sumv,
                           bf16* __restrict__ attn, int N, int H, int d,
                           int feats, float eps, int blocks) {
  using W = WgTc<D>;
  extern __shared__ unsigned char tg_smem[];
  __shared__ __align__(8) uint64_t full[W::kBStages], empty[W::kBStages];
  unsigned char* ring = align1024(tg_smem);
  unsigned* tring = reinterpret_cast<unsigned*>(ring + W::kBStages * W::kBBytes);
  unsigned char* qp = reinterpret_cast<unsigned char*>(tring + W::kBStages * 64);
  // the token blocks of a (frame, head) are neighbours in the grid: they
  // run together and read its [A | S] from L2
  const int fh = blockIdx.x / blocks, frame = fh / H, h = fh % H;
  const int t0 = blockIdx.x % blocks * W::kTokA;
  const int chunks = feats / 64, cols = d + 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // thread 0 keeps feature rows 64kc.. of [A | S]^T and their table words
  // in flight into stage kc % S, refilling a stage once both warpgroups'
  // wgmmas have read it (`empty`); boxes of all d + 8 columns, or of 88
  // three times at d = 256
  auto load = [&](int kc) {
    const int s = kc % W::kBStages, brows = cols <= 256 ? cols : 88;
    unsigned char* st = ring + s * W::kBBytes;
    mbar_expect_tx(&full[s], cols * 128 + 256);
    for (int r = 0; r < cols; r += brows)
      tma_load_3d(st + r * 128, &map_mom, &full[s], 64 * kc, r, fh);
    bulk_load(tring + s * 64, pairs + 64 * kc, 256, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < W::kBStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kc = 0; kc < W::kBStages && kc < chunks; ++kc) load(kc);
  }
  __syncthreads();

  // q as token pairs: word `slot` of row x holds q_x of tokens (t, t + 8),
  // t = t0 + 16 (slot / 8) + slot % 8, the two rows of an A fragment's lane;
  // rows kOne and kZero hold 1 and 0
  const long long ld = 3LL * H * d;
  const bf16* qb = qkv + (long long)frame * N * ld + (long long)h * d;
  unsigned* qw = reinterpret_cast<unsigned*>(qp);
  const int groups = d / 8, items = W::kTokA / 2 * groups;
  constexpr int kItems = (W::kTokA / 2 * (D / 8) + 255) / 256;   // a thread
  uint4 va[kItems], vb[kItems];   // every load in flight before any store
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = tid + 256 * k, slot = idx / groups, xg = idx % groups;
    const int ta = t0 + 16 * (slot / 8) + slot % 8, tb = ta + 8;
    const bool in = idx < items;
    va[k] = in && ta < N ? *reinterpret_cast<const uint4*>(
                               qb + ta * ld + 8 * xg)
                         : make_uint4(0u, 0u, 0u, 0u);
    vb[k] = in && tb < N ? *reinterpret_cast<const uint4*>(
                               qb + tb * ld + 8 * xg)
                         : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int idx = tid + 256 * k, slot = idx / groups, xg = idx % groups;
    if (idx < items)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qw[(8 * xg + e) * W::kQpLd + slot] =
            __byte_perm(word_of(va[k], e / 2), word_of(vb[k], e / 2),
                        e % 2 ? 0x7632 : 0x5410);
  }
  for (int slot = tid; slot < W::kTokA / 2; slot += 256) {
    qw[W::kOne * W::kQpLd + slot] = 0x3F803F80u;
    qw[W::kZero * W::kQpLd + slot] = 0u;
  }
  __syncthreads();

  const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
  const unsigned one2 = 0x3F803F80u;
  const unsigned inv2 = bits(__float2bfloat16(0.70710678118654752f)) *
                        0x10001u;
  float acc[W::kMta][W::kAcc];
#pragma unroll
  for (int mt = 0; mt < W::kMta; ++mt)
#pragma unroll
    for (int i = 0; i < W::kAcc; ++i) acc[mt][i] = 0.f;
  // this lane's word in a staged q row, per tile
  int slot[W::kMta];
#pragma unroll
  for (int mt = 0; mt < W::kMta; ++mt)
    slot[mt] = 4 * ((wg * W::kMta + mt) * 32 + wq * 8 + g);

  // A of 16-row step ks of chunk kc for every tile: features 16ks + 2tq,
  // + 1 (a0, a1) and 16ks + 2tq + 8, + 9 (a2, a3); features f and f + 8
  // share their first factor (feature_pairs), so a lane loads six q words
  // a step and tile
  auto build = [&](unsigned(&a)[W::kMta][4], const unsigned* te, int ks) {
    const uint2 ea = *reinterpret_cast<const uint2*>(te + 16 * ks + 2 * tq);
    const uint2 eb =
        *reinterpret_cast<const uint2*>(te + 16 * ks + 2 * tq + 8);
    const unsigned cf = ea.x >> 31 ? inv2 : one2;   // one kind a step
    const int pitch = 4 * W::kQpLd;   // bytes a staged q row
    const int xi0 = (ea.x & 0x7FFF) * pitch, xi1 = (ea.y & 0x7FFF) * pitch;
    const int xj[4] = {(int)(ea.x >> 16 & 0x7FFF) * pitch,
                       (int)(ea.y >> 16 & 0x7FFF) * pitch,
                       (int)(eb.x >> 16 & 0x7FFF) * pitch,
                       (int)(eb.y >> 16 & 0x7FFF) * pitch};
#pragma unroll
    for (int mt = 0; mt < W::kMta; ++mt) {
      const unsigned char* q = qp + slot[mt];
      const unsigned qi0 = lds32(q + xi0), qi1 = lds32(q + xi1);
      // phi of feature k at tokens (t, t + 8)
      const unsigned p0 = phi2(qi0, lds32(q + xj[0]), cf);
      const unsigned p1 = phi2(qi1, lds32(q + xj[1]), cf);
      const unsigned p2 = phi2(qi0, lds32(q + xj[2]), cf);
      const unsigned p3 = phi2(qi1, lds32(q + xj[3]), cf);
      a[mt][0] = pair_of(p0, p1, false);   // token t
      a[mt][1] = pair_of(p0, p1, true);    // token t + 8
      a[mt][2] = pair_of(p2, p3, false);
      a[mt][3] = pair_of(p2, p3, true);
    }
  };
  auto issue = [&](const unsigned(&a)[W::kMta][4], uint64_t db) {
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < W::kMta; ++mt) wgmma_rs(acc[mt], a[mt], db);
    wgmma_commit();
  };
  // A double-buffered by step: step s + 1 is built while step s runs (a
  // wgmma's registers stay untouched until its group retires); a chunk's
  // stage goes back once its last step has retired
  unsigned a0[W::kMta][4], a1[W::kMta][4];   // [tile][fragment]
  for (int kc = 0; kc < chunks; ++kc) {
    const int s = kc % W::kBStages;
    mbar_wait(&full[s], (kc / W::kBStages) & 1);
    const unsigned* te = tring + s * 64;
    const uint64_t db = sw128_desc(ring + s * W::kBBytes);
    build(a0, te, 0);
    issue(a0, db);
    wgmma_wait<1>();   // chunk kc - 1's last step: its stage is read
    if (kc > 0 && tid % 128 == 0) {
      const int sp = (kc - 1) % W::kBStages;
      mbar_arrive(&empty[sp]);
      if (tid == 0 && kc - 1 + W::kBStages < chunks) {
        mbar_wait(&empty[sp], (kc - 1) / W::kBStages & 1);
        load(kc - 1 + W::kBStages);
      }
    }
    build(a1, te, 1);
    issue(a1, db + 2);
    wgmma_wait<1>();
    build(a0, te, 2);
    issue(a0, db + 4);
    wgmma_wait<1>();
    build(a1, te, 3);
    issue(a1, db + 6);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < W::kMta; ++mt) fence_acc(acc[mt]);

  // den is column d: lanes with tq == 0 of 8-column block d / 8
  const float* sv = sumv + (size_t)fh * d;
  bf16* out = attn + (long long)frame * N * H * d + (long long)h * d;
  const float n = (float)N;
#pragma unroll
  for (int mt = 0; mt < W::kMta; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < W::kN / 8; ++j)
        if (8 * j == d) den = acc[mt][4 * j + 2 * hr];
      den = __shfl_sync(0xffffffffu, den, lane & ~3) + n;
      const float r = round_to<bf16>(1.f / (den + eps));
      const int t = t0 + (wg * W::kMta + mt) * 64 + wq * 16 + g + 8 * hr;
      if (t < N)
#pragma unroll
        for (int j = 0; j < W::kN / 8 - 1; ++j) {
          const int col = 8 * j + 2 * tq;
          if (col < d)
            *reinterpret_cast<unsigned*>(out + (long long)t * H * d + col) =
                pack_bf16((acc[mt][4 * j + 2 * hr] + sv[col]) * r,
                          (acc[mt][4 * j + 2 * hr + 1] + sv[col + 1]) * r);
        }
    }
}

// scratch: [A | S]^T in bf16, d + 8 columns of `feats` rows a (frame, head),
// then sum v in float32, d a (frame, head) (ops/kernels/taylor_attention.py
// wide_scratch_bytes); pairs: the feature rows (feature_pairs / pair_table),
// `feats` words, a multiple of 64
template <int D>
cudaError_t launch_taylor_core_wg(const bf16* qkv, bf16* attn, void* scratch,
                                  const unsigned* pairs, int frames, int N,
                                  int H, int d, int feats, float eps,
                                  cudaStream_t stream) {
  using W = WgTc<D>;
  if (N < 1 || H < 1 || d < 8 || d > D || d % 8 || feats < 64 ||
      feats % 64 || (uintptr_t)qkv % 16 || scratch == nullptr ||
      (uintptr_t)scratch % 16 || pairs == nullptr || (uintptr_t)pairs % 16)
    return cudaErrorInvalidValue;
  const int cols = d + 8;
  if (cols > 256 && cols % 88) return cudaErrorInvalidValue;
  bf16* mom = static_cast<bf16*>(scratch);
  float* sumv =
      reinterpret_cast<float*>(mom + (size_t)frames * H * cols * feats);
  CUtensorMap map_qkv, map_mom;
  const long long qdims[3] = {3LL * H * d, N, frames};
  const int qbox[3] = {W::kBoxCols, W::kTok, 1};   // kTok <= 256
  cudaError_t err = tensor_map(&map_qkv, qkv, 3, qdims, qbox, W::kSw);
  if (err != cudaSuccess) return err;
  const long long mdims[3] = {feats, cols, (long long)frames * H};
  const int mbox[3] = {kSw128Cols, cols <= 256 ? cols : 88, 1};
  err = tensor_map(&map_mom, mom, 3, mdims, mbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(taylor_moments_wg_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W::kSmem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(taylor_apply_wg_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W::kSmem2);
  if (err != cudaSuccess) return err;
  const int slabs = (feats / 64 + 2 * W::kMt - 1) / (2 * W::kMt);
  const int blocks = (N + W::kTokA - 1) / W::kTokA;
  if ((long long)frames * H * (slabs > blocks ? slabs : blocks) > 0x7FFFFFFF)
    return cudaErrorInvalidValue;
  taylor_moments_wg_kernel<D>
      <<<frames * H * slabs, W::kThreads, W::kSmem1, stream>>>(
          map_qkv, pairs, mom, sumv, N, H, d, feats, slabs);
  MV2_CHECK_LAUNCH();
  taylor_apply_wg_kernel<D>
      <<<frames * H * blocks, W::kThreads, W::kSmem2, stream>>>(
          map_mom, qkv, pairs, sumv, attn, N, H, d, feats, eps, blocks);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// registers, local bytes, static and dynamic shared memory and blocks an
// SM of launch 1 (launch = 0) or 2 (1) at width D, after setting its
// dynamic shared memory
template <int D>
cudaError_t wg_attributes(int launch, int* out) {
  using W = WgTc<D>;
  const void* fn = launch == 0
                       ? reinterpret_cast<const void*>(
                             taylor_moments_wg_kernel<D>)
                       : reinterpret_cast<const void*>(
                             taylor_apply_wg_kernel<D>);
  const int smem = (int)(launch == 0 ? W::kSmem1 : W::kSmem2);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      W::kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = smem;
  out[4] = blocks;
  return cudaSuccess;
}

// ---- kTaylorF32 at the other heads: two launches -------------------------
//
// Every float32 head up to 256 but 8, 16 and 32 (counted as
// taylor_core_wide_f32), two launches on the CUDA cores meeting in float32
// scratch. Features f < d + d^2: k_f, then
// phi_ij = k_i k_j / sqrt2 at d + i d + j, and the constant (f = d + d^2);
// columns v_e, then S at e = d, zero-padded to a multiple of kF32Cols.
// Launch 1 (taylor_moments_f32_kernel), grid (frame x head, features / 128,
// column groups): a thread owns one feature and kF32Cols columns, summing
// over the tokens staged kF32Tok at a time; it writes [A | S] (features x
// padded columns) in float32 to scratch. Launch 2 (taylor_apply_f32_kernel),
// grid (frame x head, tokens / kF32Tok2, column groups): a thread owns one
// token and kF32Cols columns (and den), phi(q) built per feature from q in
// shared memory, [A | S] streamed kF32Feat features at a time. No cast: the
// plain version's float32 math summed in another order.
constexpr int kF32Cols = 32;   // columns a thread
constexpr int kF32Tok = 32;    // tokens staged at a time (launch 1)
constexpr int kF32Tok2 = 128;  // tokens a block (launch 2), one a thread
constexpr int kF32Feat = 64;   // features staged at a time (launch 2)
constexpr int kF32Threads = 128;
static_assert(kF32Tok2 == kF32Threads, "a thread a token");

__host__ __device__ inline int f32_cols(int d) {
  return (d + 1 + kF32Cols - 1) / kF32Cols * kF32Cols;
}

__global__ void __launch_bounds__(kF32Threads)
    taylor_moments_f32_kernel(const float* __restrict__ qkv,
                              float* __restrict__ mom, int N, int H, int d) {
  extern __shared__ float tf_smem[];
  float* ks = tf_smem;                    // kF32Tok x (d + 1)
  float* vs = ks + kF32Tok * (d + 1);     // kF32Tok x (d + 1)
  const int fh = blockIdx.x;
  const long long frame = fh / H;
  const int h = fh % H;
  const int hd = H * d, cols = f32_cols(d);
  const long long ld = 3LL * hd;
  const float* kbase = qkv + frame * N * ld + hd + (long long)h * d;
  const int feats = d + d * d;
  const int f = blockIdx.y * kF32Threads + threadIdx.x;  // the constant: feats
  const int c0 = blockIdx.z * kF32Cols;
  const float kInvSqrt2 = 0.70710678118654752f;
  int i = -1, j = f;   // phi_ij, or k_j (i < 0), or the constant (j < 0)
  if (f >= feats) {
    j = -1;
  } else if (f >= d) {
    i = (f - d) / d;
    j = (f - d) % d;
  }
  float acc[kF32Cols];
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c) acc[c] = 0.f;
  for (int t0 = 0; t0 < N; t0 += kF32Tok) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF32Tok * d; idx += kF32Threads) {
      const int t = idx / d, e = idx % d;
      const bool ok = t0 + t < N;
      ks[t * (d + 1) + e] = ok ? kbase[(t0 + t) * ld + e] : 0.f;
      vs[t * (d + 1) + e] = ok ? kbase[(t0 + t) * ld + hd + e] : 0.f;
    }
    if (threadIdx.x < kF32Tok)   // column d of [v | 1]: 1 at real tokens
      vs[threadIdx.x * (d + 1) + d] = t0 + threadIdx.x < N ? 1.f : 0.f;
    __syncthreads();
    if (f > feats) continue;
    const int tokens = min(kF32Tok, N - t0);
    for (int t = 0; t < tokens; ++t) {
      const float* kt = ks + t * (d + 1);
      const float phi = j < 0 ? 1.f
                        : i < 0 ? kt[j]
                                : kt[i] * kt[j] * kInvSqrt2;
      const float* vt = vs + t * (d + 1) + c0;
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c)
        if (c0 + c <= d) acc[c] += phi * vt[c];
    }
  }
  if (f > feats) return;
  float* row = mom + ((long long)fh * (feats + 1) + f) * cols + c0;
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c) row[c] = c0 + c <= d ? acc[c] : 0.f;
}

__global__ void __launch_bounds__(kF32Threads)
    taylor_apply_f32_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ mom,
                            float* __restrict__ attn, int N, int H, int d,
                            float eps) {
  extern __shared__ float tf_smem[];
  float* qs = tf_smem;                    // kF32Tok2 x (d + 1)
  float* ms = qs + kF32Tok2 * (d + 1);    // kF32Feat x (kF32Cols + 1)
  float* ss = ms + kF32Feat * (kF32Cols + 1);  // kF32Feat: the S column
  const int fh = blockIdx.x;
  const long long frame = fh / H;
  const int h = fh % H;
  const int hd = H * d, cols = f32_cols(d);
  const long long ld = 3LL * hd;
  const int t0 = blockIdx.y * kF32Tok2, c0 = blockIdx.z * kF32Cols;
  const float* qbase = qkv + frame * N * ld + (long long)h * d;
  const int feats = d + d * d;
  const float* mh = mom + (long long)fh * (feats + 1) * cols;
  const float kInvSqrt2 = 0.70710678118654752f;
  for (int idx = threadIdx.x; idx < kF32Tok2 * d; idx += kF32Threads) {
    const int t = idx / d, e = idx % d;
    qs[t * (d + 1) + e] = t0 + t < N ? qbase[(t0 + t) * ld + e] : 0.f;
  }
  const int t = threadIdx.x;
  const bool real = t0 + t < N;
  const float* qt = qs + t * (d + 1);
  float acc[kF32Cols];
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c) acc[c] = 0.f;
  float den = 0.f;
  for (int f0 = 0; f0 < feats; f0 += kF32Feat) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF32Feat * kF32Cols;
         idx += kF32Threads) {
      const int fl = idx / kF32Cols, c = idx % kF32Cols;
      ms[fl * (kF32Cols + 1) + c] =
          f0 + fl < feats ? mh[(long long)(f0 + fl) * cols + c0 + c] : 0.f;
    }
    for (int fl = threadIdx.x; fl < kF32Feat; fl += kF32Threads)
      ss[fl] = f0 + fl < feats ? mh[(long long)(f0 + fl) * cols + d] : 0.f;
    __syncthreads();
    if (!real) continue;
    const int nf = min(kF32Feat, feats - f0);
    for (int fl = 0; fl < nf; ++fl) {
      const int f = f0 + fl;
      float phi;
      if (f < d) {
        phi = qt[f];
      } else {
        const int i = (f - d) / d, j = (f - d) % d;
        phi = qt[i] * qt[j] * kInvSqrt2;
      }
      den += phi * ss[fl];
      const float* mf = ms + fl * (kF32Cols + 1);
#pragma unroll
      for (int c = 0; c < kF32Cols; ++c) acc[c] += phi * mf[c];
    }
  }
  if (!real) return;
  const float* sv = mh + (long long)feats * cols;   // the constant's row
  const float r = 1.f / (den + (float)N + eps);
  float* orow = attn + (frame * N + t0 + t) * hd + (long long)h * d;
#pragma unroll
  for (int c = 0; c < kF32Cols; ++c)
    if (c0 + c < d) orow[c0 + c] = (acc[c] + sv[c0 + c]) * r;
}

// scratch: [A | S] in float32, (d + d^2 + 1) features x f32_cols(d) a
// (frame, head)
cudaError_t launch_taylor_core_stream_f32(const float* qkv, float* attn,
                                          void* scratch, int frames, int N,
                                          int H, int d, float eps,
                                          cudaStream_t stream) {
  if (N < 1 || H < 1 || d < 1 || d > 256 || scratch == nullptr ||
      (uintptr_t)scratch % 16)
    return cudaErrorInvalidValue;
  float* mom = static_cast<float*>(scratch);
  const int feats = d + d * d, groups = f32_cols(d) / kF32Cols;
  const size_t smem1 = sizeof(float) * 2 * kF32Tok * (d + 1);
  const size_t smem2 = sizeof(float) * (kF32Tok2 * (d + 1) +
                                        kF32Feat * (kF32Cols + 2));
  cudaError_t err = cudaFuncSetAttribute(
      taylor_moments_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(taylor_apply_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  taylor_moments_f32_kernel<<<
      dim3(frames * H, (feats + 1 + kF32Threads - 1) / kF32Threads, groups),
      kF32Threads, smem1, stream>>>(qkv, mom, N, H, d);
  MV2_CHECK_LAUNCH();
  taylor_apply_f32_kernel<<<
      dim3(frames * H, (N + kF32Tok2 - 1) / kF32Tok2, groups), kF32Threads,
      smem2, stream>>>(qkv, mom, attn, N, H, d, eps);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace mv2

// the moment core of one Taylor block: qkv (frames * N, 3 * H * D) in the
// working dtype, q already scaled, from the qkv GEMM; attn (frames * N,
// H * D). The route must fit the dtype: kTaylorMma bf16, kTaylorF32 float32.
// D is any multiple of 8 up to 256. The bf16 core past 8 takes `pairs`, its
// `feats` feature rows (ops/kernels/taylor_attention.py pair_table), and
// `scratch` (16-byte aligned, frames * H * (2 * (D + 8) * feats + 4 * D)
// bytes); the float32 core at heads other than 8, 16 and 32 `scratch` of
// its own (wide_scratch_bytes); the others neither.
extern "C" int mv2_taylor_core(const void* qkv, void* attn, void* scratch,
                               const void* pairs, int dtype, int frames,
                               int N, int H, int D, int feats, float eps,
                               int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == mv2::kTaylorMma && dtype == mv2::kBFloat16) {
    const mv2::bf16* q = static_cast<const mv2::bf16*>(qkv);
    mv2::bf16* o = static_cast<mv2::bf16*>(attn);
    const unsigned* t = static_cast<const unsigned*>(pairs);
    if (D == 8)
      return mv2::launch_taylor_core_mma(q, o, frames, N, H, eps, s);
    if (D <= 16)
      return mv2::launch_taylor_core_wg<16>(q, o, scratch, t, frames, N, H,
                                            D, feats, eps, s);
    if (D <= 32)
      return mv2::launch_taylor_core_wg<32>(q, o, scratch, t, frames, N, H,
                                            D, feats, eps, s);
    if (D <= 64)
      return mv2::launch_taylor_core_wg<64>(q, o, scratch, t, frames, N, H,
                                            D, feats, eps, s);
    if (D <= 128)
      return mv2::launch_taylor_core_wg<128>(q, o, scratch, t, frames, N, H,
                                             D, feats, eps, s);
    if (D <= 256)
      return mv2::launch_taylor_core_wg<256>(q, o, scratch, t, frames, N, H,
                                             D, feats, eps, s);
  }
  if (route == mv2::kTaylorF32 && dtype == mv2::kFloat32) {
    const float* q = static_cast<const float*>(qkv);
    float* o = static_cast<float*>(attn);
    if (D == 8)
      return mv2::launch_taylor_core_f32<8>(q, o, frames, N, H, eps, s);
    if (D == 16)
      return mv2::launch_taylor_core_f32<16>(q, o, frames, N, H, eps, s);
    if (D == 32)
      return mv2::launch_taylor_core_f32<32>(q, o, frames, N, H, eps, s);
    if (D % 8 == 0)
      return mv2::launch_taylor_core_stream_f32(q, o, scratch, frames, N, H,
                                                D, eps, s);
  }
  return cudaErrorInvalidValue;   // a head size or route no core takes
}

// what the runtime reports for the bf16 two-launch core at width 16, 32,
// 64, 128 or 256: launch 0 (moments) or 1 (apply); out: registers, local
// bytes a thread, static and dynamic shared memory, blocks an SM
extern "C" int mv2_taylor_core_attributes(int launch, int width, void* out) {
  int* o = static_cast<int*>(out);
  switch (width) {
    case 16: return mv2::wg_attributes<16>(launch, o);
    case 32: return mv2::wg_attributes<32>(launch, o);
    case 64: return mv2::wg_attributes<64>(launch, o);
    case 128: return mv2::wg_attributes<128>(launch, o);
    case 256: return mv2::wg_attributes<256>(launch, o);
  }
  return cudaErrorInvalidValue;
}
