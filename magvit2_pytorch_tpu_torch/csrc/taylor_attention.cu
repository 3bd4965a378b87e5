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
// - kTaylorMma, bf16, head sizes 16 and 32 (the conditioned stack's linear
//   attention takes the full attention's heads, 32 wide by default): two
//   launches on tensor cores, the "wide" core further below.
// - kTaylorF32, float32, head sizes 8, 16, 32: CUDA cores, one block per
//   (frame, head).
// - every other head up to 256 (a multiple of 8; the wrapper pads the
//   others), in bf16 and in float32: the streamed cores at the end of the
//   file, two launches on scratch, built at the padded widths 64, 128 and
//   256 with the true head size at run time.
// What bounds the core at the flagship shape (160 frames x 1024 tokens, 16
// heads x 8): bytes. It reads bf16 q, k and v (126 MB) and writes the
// attention (42 MB), 0.05 ms at 3.35 TB/s; its tensor-core work, 13.4
// GFLOP of m16n8k16 (a third of it padding), is a fraction of that. At
// heads of 32 (160 frames x 1024 tokens, 8 heads x 32) it is operations,
// barely: phi_ij == phi_ji, so the function needs F = 1 + d + d (d + 1) / 2
// = 561 features a head, 4 F (d + 1) + 2 d (d + 1) = 76 k FLOPs a token and
// head, 99.8 GFLOP, 0.101 ms at 989 TFLOP/s, against 0.100 ms of bytes
// (336 MB of q, k, v and the attention). The wide core below builds all
// d^2 products, about twice that work.
#include "common.cuh"

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

// ---- kTaylorMma at D = 16 and 32: the wide core, two launches --------------
//
// At D = 32 a head has 32 + 1024 phi features (and the constant): its
// float32 [A | S] (1056 x 33) is ~140 KB, past a block's registers, so the
// one-launch design above does not stretch. Two launches instead, with the
// same cast points (_taylor_frame, taylor_attention.py:55-107):
// Launch 1 (taylor_moments_mma_kernel), grid (frame x head, slab): the
//   feature rows of a head are cut into 16-row units: phi_ij for one i and
//   16 j (D * D / 16 units), k_j (D / 16 units) and the constant row (one
//   unit, which gives sum v). A warp owns kUpw units and a block kWarps1
//   warps, so a (frame, head) takes kSlabs blocks, each over all N tokens:
//   no sum crosses blocks. The block streams the head's k and v through a
//   three-stage cp.async ring; per 16-token tile a warp reads k and v as
//   mma.sync fragments (ldmatrix.trans), builds each unit's phi(k) rows in
//   registers (phi_ij = bf16(bf16(k_i k_j) bf16(1/sqrt2)), k_i taken from
//   the lane that holds it by a shuffle) and accumulates [A | S] +=
//   phi(k)^T [v | 1] over the tokens in float32. It writes [A | S]
//   transposed in bf16 (the JAX kernel's cast) to scratch, columns v_e,
//   then S, then zeros, and sum v in float32.
// Launch 2 (taylor_apply_mma_kernel), grid (frame x head, 256 tokens):
//   the block loads the head's [A | S]^T (86 KB at D = 32) and its q into
//   shared memory; a warp takes 32 tokens (two m16 tiles) and, per
//   16-feature step, builds phi(q) in registers and runs [num | den] +=
//   phi(q) [A | S] (ldmatrix B fragments, one load for both tiles). Then
//   num + sum v, den + N, r = bf16(1 / (den + eps)), out = bf16(num r).
// What bounds it is operations (the file's head note); padding costs the
// tensor cores 40 columns for 33 and the constant unit 1 of 67 rows. The
// symmetry phi_ij == phi_ji (to the bit) is not used: it would halve both
// launches' products.
template <int D>
struct WideTc {
  static_assert(D == 16 || D == 32, "the wide core takes heads of 16 or 32");
  static constexpr int kJb = D / 16;               // 16-row blocks of j
  static constexpr int kFeat = D + D * D;          // rows: k_j, then phi_ij
  static constexpr int kNt = D / 8 + 1;            // column tiles: v, then S
  static constexpr int kCols = 8 * kNt;            // [A | S], zero-padded
  static constexpr int kQuad = D * kJb;            // units of phi_ij rows
  static constexpr int kUnits = kQuad + kJb + 1;   // + k_j, + the constant
  static constexpr int kUpw = 4;                   // units a warp
  static constexpr int kSlabs = D == 32 ? 3 : 1;   // blocks a (frame, head)
  static constexpr int kWarps1 =
      ((kUnits + kUpw - 1) / kUpw + kSlabs - 1) / kSlabs;
  static constexpr int kChunk = 64;                // tokens a ring stage
  static constexpr int kStages = 3;
  // a staged token row: k, v, 16 bytes of padding (ldmatrix rows fall in
  // different banks)
  static constexpr int kKvLd = 2 * D + 8;
  static constexpr size_t kSmem1 = sizeof(bf16) * kStages * kChunk * kKvLd;
  static constexpr int kWarps2 = 8;
  static constexpr int kTok2 = 32 * kWarps2;       // tokens a block
  static constexpr int kAtLd = kFeat + 8;          // [A | S]^T row
  static constexpr int kQLd = D + 8;
  static constexpr size_t kSmem2 =
      sizeof(bf16) * (kCols * kAtLd + kTok2 * kQLd);
};

__device__ __forceinline__ unsigned phi_pair(unsigned a, unsigned b,
                                             unsigned inv_sqrt2) {
  return bmul2(bmul2(a, b), inv_sqrt2);
}

template <int D>
__global__ void __launch_bounds__(32 * WideTc<D>::kWarps1)
    taylor_moments_mma_kernel(const bf16* __restrict__ qkv,
                              bf16* __restrict__ mom,
                              float* __restrict__ sumv, int N, int H) {
  using W = WideTc<D>;
  extern __shared__ __align__(16) unsigned char tw_smem[];
  bf16* ring = reinterpret_cast<bf16*>(tw_smem);
  const int fh = blockIdx.x;
  const long long frame = fh / H;
  const int h = fh % H;
  const int hd = H * D;
  const long long ld = 3LL * hd;
  const bf16* kbase = qkv + frame * N * ld + hd + h * D;   // v at + hd
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int u0 = (blockIdx.y * W::kWarps1 + warp) * W::kUpw;
  const int nu = max(0, min(W::kUpw, W::kUnits - u0));   // warp-uniform
  const unsigned inv_sqrt2 = bits(__float2bfloat16(0.70710678118654752f)) *
                             0x10001u;
  const unsigned ones = g == 0 ? 0x3F803F80u : 0u;   // column / row 0: 1
  const int nch = (N + W::kChunk - 1) / W::kChunk;
  constexpr int kPieces = D / 4;   // 16-byte pieces a token: k, then v

  // chunk c into stage c % kStages; rows past N are zeros
  auto stage = [&](int c) {
    const int t0 = c * W::kChunk;
    bf16* buf = ring + (c % W::kStages) * W::kChunk * W::kKvLd;
    for (int idx = threadIdx.x; idx < W::kChunk * kPieces;
         idx += blockDim.x) {
      const int t = idx / kPieces, p = idx % kPieces;
      const int which = p / (D / 8), piece = p % (D / 8);
      const int n = min(t0 + t, N - 1);
      cp_async16(buf + t * W::kKvLd + which * D + piece * 8,
                 kbase + n * ld + which * hd + piece * 8, t0 + t < N);
    }
  };

  float acc[W::kUpw][W::kNt][4];
#pragma unroll
  for (int s = 0; s < W::kUpw; ++s)
#pragma unroll
    for (int nt = 0; nt < W::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][nt][e] = 0.f;

  // this lane's ldmatrix row: tokens 0-7 / 8-15 (matrices 0, 2 / 1, 3),
  // columns 0-7 / 8-15 (matrices 0, 1 / 2, 3)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  for (int c = 0; c < W::kStages - 1; ++c) {
    if (c < nch) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<W::kStages - 2>();
    __syncthreads();   // chunk c landed; every warp is done with c - 1
    if (c + W::kStages - 1 < nch) stage(c + W::kStages - 1);
    cp_async_commit();
    if (nu == 0) continue;
    const bf16* buf = ring + (c % W::kStages) * W::kChunk * W::kKvLd;
    for (int tl = 0; tl < W::kChunk / 16 && c * W::kChunk + 16 * tl < N;
         ++tl) {
      const bf16* row = buf + (16 * tl + lrow) * W::kKvLd + lcol;
      // kf[m]: k of features 16m + g (regs 0, 1) and 16m + g + 8 (2, 3) at
      // tokens 2tq, 2tq + 1 (regs 0, 2) and 2tq + 8, 2tq + 9 (1, 3); vf[m]:
      // the B fragments (b0, b1) of v's column tiles 2m and 2m + 1
      unsigned kf[W::kJb][4], vf[W::kJb][4];
#pragma unroll
      for (int m = 0; m < W::kJb; ++m) {
        ldmatrix_x4_trans(kf[m], row + 16 * m);
        ldmatrix_x4_trans(vf[m], row + D + 16 * m);
      }
#pragma unroll
      for (int s = 0; s < W::kUpw; ++s) {
        if (s >= nu) continue;   // warp-uniform
        const int u = u0 + s;
        unsigned a[4];
        if (u < W::kQuad) {   // phi_ij, i = u / kJb, j in block u % kJb
          const int i = u / W::kJb, jb = u % W::kJb, blk = i >> 3;
          unsigned s0 = 0u, s1 = 0u;
#pragma unroll
          for (int b = 0; b < D / 8; ++b)
            if (b == blk) {
              s0 = kf[b >> 1][2 * (b & 1)];
              s1 = kf[b >> 1][2 * (b & 1) + 1];
            }
          // k_i at this lane's tokens, from the lane with g = i % 8
          const int src = (i & 7) * 4 + tq;
          const unsigned ki0 = __shfl_sync(0xffffffffu, s0, src);
          const unsigned ki1 = __shfl_sync(0xffffffffu, s1, src);
          unsigned kj[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            kj[r] = jb == 0 ? kf[0][r] : kf[W::kJb - 1][r];
          a[0] = phi_pair(ki0, kj[0], inv_sqrt2);
          a[1] = phi_pair(ki0, kj[2], inv_sqrt2);
          a[2] = phi_pair(ki1, kj[1], inv_sqrt2);
          a[3] = phi_pair(ki1, kj[3], inv_sqrt2);
        } else if (u < W::kQuad + W::kJb) {   // k_j, j in block u - kQuad
          const int jb = u - W::kQuad;
#pragma unroll
          for (int m = 0; m < W::kJb; ++m)
            if (m == jb) {
              a[0] = kf[m][0];
              a[1] = kf[m][2];
              a[2] = kf[m][1];
              a[3] = kf[m][3];
            }
        } else {   // the constant row: 1 at row 0
          a[0] = ones;
          a[1] = 0u;
          a[2] = ones;
          a[3] = 0u;
        }
#pragma unroll
        for (int nt = 0; nt < W::kNt - 1; ++nt)
          mma_16816(acc[s][nt], a, vf[nt >> 1][2 * (nt & 1)],
                    vf[nt >> 1][2 * (nt & 1) + 1]);
        mma_16816(acc[s][W::kNt - 1], a, ones, ones);   // column D: S
      }
    }
  }

  // [A | S]^T in bf16 (column-major rows of features), sum v in float32
  bf16* mh = mom + (long long)fh * W::kCols * W::kFeat;
#pragma unroll
  for (int s = 0; s < W::kUpw; ++s) {
    if (s >= nu) continue;
    const int u = u0 + s;
    const bool konst = u == W::kUnits - 1;
    const int f0 = u < W::kQuad ? D + (u / W::kJb) * D + 16 * (u % W::kJb)
                                : 16 * (u - W::kQuad);
#pragma unroll
    for (int nt = 0; nt < W::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), col = 8 * nt + 2 * tq + (e & 1);
        if (konst) {
          if (r == 0 && col < D) sumv[(long long)fh * D + col] = acc[s][nt][e];
        } else {
          mh[col * W::kFeat + f0 + r] = __float2bfloat16(acc[s][nt][e]);
        }
      }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * WideTc<D>::kWarps2)
    taylor_apply_mma_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ mom,
                            const float* __restrict__ sumv,
                            bf16* __restrict__ attn, int N, int H,
                            float eps) {
  using W = WideTc<D>;
  extern __shared__ __align__(16) unsigned char tw_smem[];
  bf16* at = reinterpret_cast<bf16*>(tw_smem);   // kCols rows of kAtLd
  bf16* qs = at + W::kCols * W::kAtLd;           // kTok2 rows of kQLd
  const int fh = blockIdx.x;
  const long long frame = fh / H;
  const int h = fh % H;
  const int hd = H * D;
  const long long ld = 3LL * hd;
  const int t0 = blockIdx.y * W::kTok2;
  const bf16* qbase = qkv + frame * N * ld + h * D;
  const bf16* mh = mom + (long long)fh * W::kCols * W::kFeat;
  constexpr int kRowPieces = W::kFeat / 8;
  for (int idx = threadIdx.x; idx < W::kCols * kRowPieces;
       idx += blockDim.x) {
    const int r = idx / kRowPieces, p = idx % kRowPieces;
    cp_async16(at + r * W::kAtLd + 8 * p, mh + r * W::kFeat + 8 * p);
  }
  for (int idx = threadIdx.x; idx < W::kTok2 * (D / 8); idx += blockDim.x) {
    const int t = idx / (D / 8), p = idx % (D / 8);
    const int n = min(t0 + t, N - 1);
    cp_async16(qs + t * W::kQLd + 8 * p, qbase + n * ld + 8 * p, t0 + t < N);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wt = 32 * warp;   // the warp's first token in the block
  if (t0 + wt >= N) return;   // no real token (no barrier follows)
  const unsigned inv_sqrt2 = bits(__float2bfloat16(0.70710678118654752f)) *
                             0x10001u;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  // qf[mt][m]: the A fragment of q at tokens 16mt + (g, g + 8) and
  // features 16m + (2tq, 2tq + 1, 2tq + 8, 2tq + 9)
  unsigned qf[2][W::kJb][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int m = 0; m < W::kJb; ++m)
      ldmatrix_x4(qf[mt][m],
                  qs + (wt + 16 * mt + lrow) * W::kQLd + 16 * m + lcol);
  float acc[2][W::kNt][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // B fragments of [A | S] at k-step ks: an x4 over column tiles (nt,
  // nt + 1), low and high 8 features; an x2 for the last (S) tile
  const bf16* b4 = at + ((lane & 7) + 8 * (lane >> 4)) * W::kAtLd +
                   8 * ((lane >> 3) & 1);
  const bf16* b2 = at + ((lane & 7) + 8 * (W::kNt - 1)) * W::kAtLd +
                   8 * ((lane >> 3) & 1);
  auto kstep = [&](int ks, const unsigned (&a)[2][4]) {
#pragma unroll
    for (int np = 0; np < W::kNt / 2; ++np) {
      unsigned b[4];
      ldmatrix_x4(b, b4 + 16 * np * W::kAtLd + 16 * ks);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
    unsigned b[2];
    ldmatrix_x2(b, b2 + 16 * ks);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_16816(acc[mt][W::kNt - 1], a[mt], b[0], b[1]);
  };
#pragma unroll
  for (int m = 0; m < W::kJb; ++m) {   // the features k_j
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[mt][r] = qf[mt][m][r];
    kstep(m, a);
  }
#pragma unroll 1
  for (int i = 0; i < D; ++i) {   // the features phi_ij
    unsigned qi[2][2];   // q_i of tokens g and g + 8 of each tile, both lanes
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        qi[mt][p] = bits(qs[(wt + 16 * mt + g + 8 * p) * W::kQLd + i]) *
                    0x10001u;
#pragma unroll
    for (int m = 0; m < W::kJb; ++m) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = phi_pair(qi[mt][0], qf[mt][m][0], inv_sqrt2);
        a[mt][1] = phi_pair(qi[mt][1], qf[mt][m][1], inv_sqrt2);
        a[mt][2] = phi_pair(qi[mt][0], qf[mt][m][2], inv_sqrt2);
        a[mt][3] = phi_pair(qi[mt][1], qf[mt][m][3], inv_sqrt2);
      }
      kstep(W::kJb + i * W::kJb + m, a);
    }
  }

  // den sits in column 0 of the last tile: lanes with tq == 0
  const float* sv = sumv + (long long)fh * D;
  float svv[W::kNt - 1][2];
#pragma unroll
  for (int nt = 0; nt < W::kNt - 1; ++nt) {
    svv[nt][0] = sv[8 * nt + 2 * tq];
    svv[nt][1] = sv[8 * nt + 2 * tq + 1];
  }
  bf16* out = attn + frame * N * hd + h * D;
  const float n = (float)N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float d =
          __shfl_sync(0xffffffffu, acc[mt][W::kNt - 1][2 * p], lane & ~3) + n;
      const float r = round_to<bf16>(1.f / (d + eps));
      const int t = t0 + wt + 16 * mt + g + 8 * p;
      if (t < N)
#pragma unroll
        for (int nt = 0; nt < W::kNt - 1; ++nt)
          *reinterpret_cast<unsigned*>(out + (long long)t * hd + 8 * nt +
                                       2 * tq) =
              pack_bf16((acc[mt][nt][2 * p] + svv[nt][0]) * r,
                        (acc[mt][nt][2 * p + 1] + svv[nt][1]) * r);
    }
}

// scratch: [A | S]^T in bf16 for every (frame, head), then sum v in float32
// (ops/kernels/taylor_attention.py wide_scratch_bytes)
template <int D>
cudaError_t launch_taylor_core_wide(const bf16* qkv, bf16* attn,
                                    void* scratch, int frames, int N, int H,
                                    float eps, cudaStream_t stream) {
  using W = WideTc<D>;
  if (N < 1 || H < 1 || (uintptr_t)qkv % 16 || scratch == nullptr ||
      (uintptr_t)scratch % 16)
    return cudaErrorInvalidValue;
  bf16* mom = static_cast<bf16*>(scratch);
  float* sumv = reinterpret_cast<float*>(
      mom + (size_t)frames * H * W::kCols * W::kFeat);
  cudaError_t err = cudaFuncSetAttribute(
      taylor_apply_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)W::kSmem2);
  if (err != cudaSuccess) return err;
  taylor_moments_mma_kernel<D>
      <<<dim3(frames * H, W::kSlabs), 32 * W::kWarps1, W::kSmem1, stream>>>(
          qkv, mom, sumv, N, H);
  MV2_CHECK_LAUNCH();
  taylor_apply_mma_kernel<D>
      <<<dim3(frames * H, (N + W::kTok2 - 1) / W::kTok2), 32 * W::kWarps2,
         W::kSmem2, stream>>>(qkv, mom, sumv, attn, N, H, eps);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// ---- the other heads: the streamed cores, two launches each ----------------
//
// Every head of 1 to 256 values but 8, 16 and 32 (the wrapper pads a head to
// a multiple of 8 with zero columns: zero features add exact zeros). The
// kernels are built at the padded widths D = 64, 128, 256 and take the true
// d at run time; their feature rows are those of d. A head's phi has
// d + d^2 features: past d = 32 its [A | S] outgrows a block's shared memory
// (600 KB at d = 64 in bf16, ~35 MB at 256), so the moments go to scratch and
// the second launch streams them through a ring, like a GEMM's K loop.
//
// bf16 (kTaylorMma, counted as the wide core): the feature rows come in
// 16-row units: k_j for j in 16-blocks jb < JB = ceil(d / 16) (units
// 0 .. JB - 1), then phi_ij for i < d and j in block jb (unit JB + i JB + jb),
// and the constant row (unit U = JB (d + 1), which gives sum v).
// Launch 1 (taylor_moments_stream_kernel), grid (frame x head, slab): a warp
//   owns kUpw units and a block kWarps1 warps, each block over all N tokens
//   (no sum crosses blocks); the head's k and v stream through a cp.async
//   ring, a unit's phi(k) rows are built in registers per 16-token tile
//   (phi_ij = bf16(bf16(k_i k_j) bf16(1/sqrt2)), k_i by a shuffle), and
//   [A | S] += phi(k)^T [v | 1] accumulates on mma.sync in float32; then
//   [A | S]^T goes to scratch in bf16 (the JAX kernel's cast), 16 U feature
//   rows a column, and sum v in float32.
// Launch 2 (taylor_apply_stream_kernel), grid (frame x head, kTok2 tokens):
//   the block holds its tokens' q in shared memory and streams [A | S]^T in
//   chunks of kFk features through a three-stage ring; per 16-feature unit
//   a warp builds phi(q) of its kMt 16-token tiles in registers and runs
//   [num | den] += phi(q) [A | S] (its accumulators: kMt tiles x D + 8
//   columns, at D = 256 one tile, 132 floats a lane). Then num + sum v,
//   den + N, r = bf16(1 / (den + eps)), out = bf16(num r).
// Column tiles past d (zeros) are skipped in both launches. phi_ij ==
// phi_ji is not used (queue item B4 of ROADMAP.md): the work is
// 4 (d + d^2) (D + 8) a token and head in place of the 4 F (d + 1) the
// function needs (F = 1 + d + d (d + 1) / 2).
template <int D>
struct StreamTc {
  static_assert(D == 64 || D == 128 || D == 256, "the streamed core's widths");
  static constexpr int kNt = D / 8 + 1;            // column tiles: v, then S
  static constexpr int kCols = 8 * kNt;            // [A | S], zero-padded
  static constexpr int kUpw = D <= 64 ? 4 : D <= 128 ? 2 : 1;  // units a warp
  static constexpr int kWarps1 = 8;
  static constexpr int kChunk = D <= 128 ? 64 : 32;  // tokens a ring stage
  static constexpr int kStages = 3;
  static constexpr int kKvLd = 2 * D + 8;          // a staged token: k, v
  static constexpr size_t kSmem1 = sizeof(bf16) * kStages * kChunk * kKvLd;
  static constexpr int kWarps2 = 8;
  static constexpr int kMt = D <= 128 ? 2 : 1;     // 16-token tiles a warp
  static constexpr int kTok2 = 16 * kMt * kWarps2; // tokens a block
  static constexpr int kFk = 64;                   // features a ring stage
  static constexpr int kAtLd = kFk + 8;            // a staged [A | S]^T row
  static constexpr int kQLd = D + 8;
  static constexpr size_t kSmem2 =
      sizeof(bf16) * (kStages * kCols * kAtLd + kTok2 * kQLd);
  static_assert(kSmem1 <= 232448 && kSmem2 <= 232448, "shared memory");
};

// units of a head of d: JB k_j units and d JB phi_ij units (the constant's
// is the next)
__host__ __device__ inline int stream_units(int d) {
  return (d + 15) / 16 * (d + 1);
}

template <int D>
__global__ void __launch_bounds__(32 * StreamTc<D>::kWarps1)
    taylor_moments_stream_kernel(const bf16* __restrict__ qkv,
                                 bf16* __restrict__ mom,
                                 float* __restrict__ sumv, int N, int H,
                                 int d) {
  using W = StreamTc<D>;
  extern __shared__ __align__(16) unsigned char tw_smem[];
  bf16* ring = reinterpret_cast<bf16*>(tw_smem);
  const int fh = blockIdx.x;
  const long long frame = fh / H;
  const int h = fh % H;
  const int hd = H * d;
  const long long ld = 3LL * hd;
  const bf16* kbase = qkv + frame * N * ld + hd + (long long)h * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int jbs = (d + 15) / 16, units = stream_units(d);
  const int u0 = (blockIdx.y * W::kWarps1 + warp) * W::kUpw;
  const int nu = max(0, min(W::kUpw, units + 1 - u0));  // warp-uniform
  const unsigned inv_sqrt2 = bits(__float2bfloat16(0.70710678118654752f)) *
                             0x10001u;
  const unsigned ones = g == 0 ? 0x3F803F80u : 0u;   // column / row 0: 1
  const int nch = (N + W::kChunk - 1) / W::kChunk;
  constexpr int kPieces = D / 4;   // 16-byte pieces a staged token: k, v

  // chunk c into stage c % kStages; rows past N and columns past d are zeros
  auto stage = [&](int c) {
    const int t0 = c * W::kChunk;
    bf16* buf = ring + (c % W::kStages) * W::kChunk * W::kKvLd;
    for (int idx = threadIdx.x; idx < W::kChunk * kPieces;
         idx += blockDim.x) {
      const int t = idx / kPieces, p = idx % kPieces;
      const int which = p / (D / 8), col = 8 * (p % (D / 8));
      const bool ok = t0 + t < N && col < d;
      const int n = min(t0 + t, N - 1);
      cp_async16(buf + t * W::kKvLd + which * D + col,
                 kbase + n * ld + which * hd + (ok ? col : 0), ok);
    }
  };

  float acc[W::kUpw][W::kNt][4];
#pragma unroll
  for (int s = 0; s < W::kUpw; ++s)
#pragma unroll
    for (int nt = 0; nt < W::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][nt][e] = 0.f;

  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  for (int c = 0; c < W::kStages - 1; ++c) {
    if (c < nch) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<W::kStages - 2>();
    __syncthreads();   // chunk c landed; every warp is done with c - 1
    if (c + W::kStages - 1 < nch) stage(c + W::kStages - 1);
    cp_async_commit();
    if (nu == 0) continue;
    const bf16* buf = ring + (c % W::kStages) * W::kChunk * W::kKvLd;
    for (int tl = 0; tl < W::kChunk / 16 && c * W::kChunk + 16 * tl < N;
         ++tl) {
      const bf16* row = buf + (16 * tl + lrow) * W::kKvLd + lcol;
      // A fragments of the warp's units: rows features, columns tokens.
      // ldmatrix.trans of 16 features of k gives kf[0] (features g, tokens
      // 2tq, 2tq + 1), kf[1] (g, 2tq + 8, + 9), kf[2] (g + 8, 2tq ..),
      // kf[3] (g + 8, 2tq + 8 ..)
      unsigned a[W::kUpw][4];
#pragma unroll
      for (int s = 0; s < W::kUpw; ++s) {
        if (s >= nu) continue;   // warp-uniform
        const int u = u0 + s;
        if (u < jbs) {   // k_j, j in block u
          unsigned kf[4];
          ldmatrix_x4_trans(kf, row + 16 * u);
          a[s][0] = kf[0];
          a[s][1] = kf[2];
          a[s][2] = kf[1];
          a[s][3] = kf[3];
        } else if (u < units) {   // phi_ij, i = (u - jbs) / jbs
          const int i = (u - jbs) / jbs, jb = (u - jbs) % jbs;
          unsigned ki[4], kj[4];
          ldmatrix_x4_trans(ki, row + 16 * (i >> 4));
          ldmatrix_x4_trans(kj, row + 16 * jb);
          // k_i at this lane's tokens, from the lane with g = i % 8
          const bool hi = (i >> 3) & 1;
          const int src = (i & 7) * 4 + tq;
          const unsigned ki0 = __shfl_sync(0xffffffffu, hi ? ki[2] : ki[0],
                                           src);
          const unsigned ki1 = __shfl_sync(0xffffffffu, hi ? ki[3] : ki[1],
                                           src);
          a[s][0] = phi_pair(ki0, kj[0], inv_sqrt2);
          a[s][1] = phi_pair(ki0, kj[2], inv_sqrt2);
          a[s][2] = phi_pair(ki1, kj[1], inv_sqrt2);
          a[s][3] = phi_pair(ki1, kj[3], inv_sqrt2);
        } else {   // the constant row: 1 at row 0
          a[s][0] = ones;
          a[s][1] = 0u;
          a[s][2] = ones;
          a[s][3] = 0u;
        }
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (16 * np >= d) break;   // v's columns past d are zeros
        unsigned vf[4];
        ldmatrix_x4_trans(vf, row + D + 16 * np);
#pragma unroll
        for (int s = 0; s < W::kUpw; ++s) {
          if (s >= nu) continue;
          mma_16816(acc[s][2 * np], a[s], vf[0], vf[1]);
          mma_16816(acc[s][2 * np + 1], a[s], vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int s = 0; s < W::kUpw; ++s)
        if (s < nu) mma_16816(acc[s][W::kNt - 1], a[s], ones, ones);  // S
    }
  }
  cp_async_wait<0>();

  // [A | S]^T in bf16 (16 U feature rows a column), sum v in float32
  const int feats = 16 * units;
  bf16* mh = mom + (long long)fh * W::kCols * feats;
#pragma unroll
  for (int s = 0; s < W::kUpw; ++s) {
    if (s >= nu) continue;
    const int u = u0 + s;
#pragma unroll
    for (int nt = 0; nt < W::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), col = 8 * nt + 2 * tq + (e & 1);
        if (u == units) {
          if (r == 0 && col < D) sumv[(long long)fh * D + col] = acc[s][nt][e];
        } else {
          mh[(long long)col * feats + 16 * u + r] =
              __float2bfloat16(acc[s][nt][e]);
        }
      }
  }
}

template <int D>
__global__ void __launch_bounds__(32 * StreamTc<D>::kWarps2)
    taylor_apply_stream_kernel(const bf16* __restrict__ qkv,
                               const bf16* __restrict__ mom,
                               const float* __restrict__ sumv,
                               bf16* __restrict__ attn, int N, int H, int d,
                               float eps) {
  using W = StreamTc<D>;
  extern __shared__ __align__(16) unsigned char tw_smem[];
  bf16* ring = reinterpret_cast<bf16*>(tw_smem);  // kCols rows of kAtLd
  bf16* qs = ring + W::kStages * W::kCols * W::kAtLd;  // kTok2 of kQLd
  const int fh = blockIdx.x;
  const long long frame = fh / H;
  const int h = fh % H;
  const int hd = H * d;
  const long long ld = 3LL * hd;
  const int t0 = blockIdx.y * W::kTok2;
  const bf16* qbase = qkv + frame * N * ld + (long long)h * d;
  const int jbs = (d + 15) / 16, units = stream_units(d);
  const int feats = 16 * units;
  const bf16* mh = mom + (long long)fh * W::kCols * feats;
  const int steps = (feats + W::kFk - 1) / W::kFk;
  constexpr int kPieces = W::kFk / 8;

  for (int idx = threadIdx.x; idx < W::kTok2 * (D / 8); idx += blockDim.x) {
    const int t = idx / (D / 8), col = 8 * (idx % (D / 8));
    const bool ok = t0 + t < N && col < d;
    const int n = min(t0 + t, N - 1);
    cp_async16(qs + t * W::kQLd + col, qbase + n * ld + (ok ? col : 0), ok);
  }
  // features f0 .. f0 + kFk - 1 of every column into stage c % kStages;
  // zeros past the last feature
  auto stage = [&](int c) {
    bf16* buf = ring + (c % W::kStages) * W::kCols * W::kAtLd;
    const int f0 = c * W::kFk;
    for (int idx = threadIdx.x; idx < W::kCols * kPieces;
         idx += blockDim.x) {
      const int r = idx / kPieces, f = 8 * (idx % kPieces);
      const bool ok = f0 + f < feats;
      cp_async16(buf + r * W::kAtLd + f,
                 mh + (long long)r * feats + (ok ? f0 + f : 0), ok);
    }
  };
  for (int c = 0; c < W::kStages - 1; ++c) {   // q joins the first group
    if (c < steps) stage(c);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wt = 16 * W::kMt * warp;   // the warp's first token in the block
  const bool active = t0 + wt < N;     // warp-uniform
  const unsigned inv_sqrt2 = bits(__float2bfloat16(0.70710678118654752f)) *
                             0x10001u;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  float acc[W::kMt][W::kNt][4];
#pragma unroll
  for (int mt = 0; mt < W::kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < W::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // B fragments at k-step ks of a stage: an x4 over column tiles (nt,
  // nt + 1), low and high 8 features; an x2 for the last (S) tile
  const int b4 = ((lane & 7) + 8 * (lane >> 4)) * W::kAtLd +
                 8 * ((lane >> 3) & 1);
  const int b2 = ((lane & 7) + 8 * (W::kNt - 1)) * W::kAtLd +
                 8 * ((lane >> 3) & 1);

  for (int c = 0; c < steps; ++c) {
    cp_async_wait<W::kStages - 2>();
    __syncthreads();   // stage c (and q) landed; stage c - 1 is free
    if (c + W::kStages - 1 < steps) stage(c + W::kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const bf16* buf = ring + (c % W::kStages) * W::kCols * W::kAtLd;
#pragma unroll 1
    for (int ks = 0; ks < W::kFk / 16; ++ks) {
      const int u = c * (W::kFk / 16) + ks;
      if (u >= units) break;   // uniform
      // phi(q) of the warp's tiles as A fragments: rows tokens, columns
      // the unit's 16 features (ldmatrix of q: qf[0] tokens g, features
      // 2tq .. ; qf[1] g + 8; qf[2] g, 2tq + 8 ..; qf[3] g + 8, 2tq + 8 ..)
      unsigned a[W::kMt][4];
      const int i = u < jbs ? -1 : (u - jbs) / jbs;
      const int jb = u < jbs ? u : (u - jbs) % jbs;
#pragma unroll
      for (int mt = 0; mt < W::kMt; ++mt) {
        unsigned qf[4];
        ldmatrix_x4(qf, qs + (wt + 16 * mt + lrow) * W::kQLd + 16 * jb + lcol);
        if (i < 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[mt][r] = qf[r];
        } else {
          const unsigned qi0 =
              bits(qs[(wt + 16 * mt + g) * W::kQLd + i]) * 0x10001u;
          const unsigned qi1 =
              bits(qs[(wt + 16 * mt + g + 8) * W::kQLd + i]) * 0x10001u;
          a[mt][0] = phi_pair(qi0, qf[0], inv_sqrt2);
          a[mt][1] = phi_pair(qi1, qf[1], inv_sqrt2);
          a[mt][2] = phi_pair(qi0, qf[2], inv_sqrt2);
          a[mt][3] = phi_pair(qi1, qf[3], inv_sqrt2);
        }
      }
#pragma unroll
      for (int np = 0; np < W::kNt / 2; ++np) {
        if (16 * np >= d) break;   // [A]'s columns past d are zeros
        unsigned b[4];
        ldmatrix_x4(b, buf + b4 + 16 * np * W::kAtLd + 16 * ks);
#pragma unroll
        for (int mt = 0; mt < W::kMt; ++mt) {
          mma_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
      unsigned b[2];
      ldmatrix_x2(b, buf + b2 + 16 * ks);
#pragma unroll
      for (int mt = 0; mt < W::kMt; ++mt)
        mma_16816(acc[mt][W::kNt - 1], a[mt], b[0], b[1]);
    }
  }
  cp_async_wait<0>();
  if (!active) return;   // no barrier follows

  // den sits in column 0 of the last tile: lanes with tq == 0
  const float* sv = sumv + (long long)fh * D;
  bf16* out = attn + frame * N * hd + (long long)h * d;
  const float n = (float)N;
#pragma unroll
  for (int mt = 0; mt < W::kMt; ++mt)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float den =
          __shfl_sync(0xffffffffu, acc[mt][W::kNt - 1][2 * p], lane & ~3) + n;
      const float r = round_to<bf16>(1.f / (den + eps));
      const int t = t0 + wt + 16 * mt + g + 8 * p;
      if (t < N)
#pragma unroll
        for (int nt = 0; nt < W::kNt - 1; ++nt) {
          const int col = 8 * nt + 2 * tq;
          if (col < d)
            *reinterpret_cast<unsigned*>(out + (long long)t * hd + col) =
                pack_bf16((acc[mt][nt][2 * p] + sv[col]) * r,
                          (acc[mt][nt][2 * p + 1] + sv[col + 1]) * r);
        }
    }
}

// scratch: [A | S]^T in bf16 for every (frame, head), kCols columns of
// 16 U features, then sum v in float32, D a (frame, head)
// (ops/kernels/taylor_attention.py wide_scratch_bytes)
template <int D>
cudaError_t launch_taylor_core_stream(const bf16* qkv, bf16* attn,
                                      void* scratch, int frames, int N, int H,
                                      int d, float eps, cudaStream_t stream) {
  using W = StreamTc<D>;
  if (N < 1 || H < 1 || d < 1 || d > D || d % 8 || (uintptr_t)qkv % 16 ||
      scratch == nullptr || (uintptr_t)scratch % 16)
    return cudaErrorInvalidValue;
  const int units = stream_units(d);
  bf16* mom = static_cast<bf16*>(scratch);
  float* sumv = reinterpret_cast<float*>(
      mom + (size_t)frames * H * W::kCols * 16 * units);
  cudaError_t err = cudaFuncSetAttribute(
      taylor_moments_stream_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::kSmem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(taylor_apply_stream_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W::kSmem2);
  if (err != cudaSuccess) return err;
  const int warps = (units + 1 + W::kUpw - 1) / W::kUpw;
  const int slabs = (warps + W::kWarps1 - 1) / W::kWarps1;
  taylor_moments_stream_kernel<D>
      <<<dim3(frames * H, slabs), 32 * W::kWarps1, W::kSmem1, stream>>>(
          qkv, mom, sumv, N, H, d);
  MV2_CHECK_LAUNCH();
  taylor_apply_stream_kernel<D>
      <<<dim3(frames * H, (N + W::kTok2 - 1) / W::kTok2), 32 * W::kWarps2,
         W::kSmem2, stream>>>(qkv, mom, sumv, attn, N, H, d, eps);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// float32 (kTaylorF32, counted as taylor_core_wide_f32) at the same heads,
// the same two launches on the CUDA cores. Features f < d + d^2: k_f, then
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
// D is any multiple of 8 up to 256. The bf16 core at 16 and 32 needs
// `scratch` (16-byte aligned, frames * H * (2 * (8 * (D / 8 + 1)) *
// (D + D * D) + 4 * D) bytes), both cores at the other heads but 8 theirs
// (ops/kernels/taylor_attention.py wide_scratch_bytes), the others none.
extern "C" int mv2_taylor_core(const void* qkv, void* attn, void* scratch,
                               int dtype, int frames, int N, int H, int D,
                               float eps, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == mv2::kTaylorMma && dtype == mv2::kBFloat16) {
    const mv2::bf16* q = static_cast<const mv2::bf16*>(qkv);
    mv2::bf16* o = static_cast<mv2::bf16*>(attn);
    if (D == 8)
      return mv2::launch_taylor_core_mma(q, o, frames, N, H, eps, s);
    if (D == 16)
      return mv2::launch_taylor_core_wide<16>(q, o, scratch, frames, N, H,
                                              eps, s);
    if (D == 32)
      return mv2::launch_taylor_core_wide<32>(q, o, scratch, frames, N, H,
                                              eps, s);
    if (D <= 64)
      return mv2::launch_taylor_core_stream<64>(q, o, scratch, frames, N, H,
                                                D, eps, s);
    if (D <= 128)
      return mv2::launch_taylor_core_stream<128>(q, o, scratch, frames, N, H,
                                                 D, eps, s);
    if (D <= 256)
      return mv2::launch_taylor_core_stream<256>(q, o, scratch, frames, N, H,
                                                 D, eps, s);
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
