// Fused ResidualUnit: causal 3x3x3 conv -> ELU -> 1x1 -> ELU ->
// SqueezeExcite -> +x. Replaces the TPU kernels
// magvit2_pytorch_tpu/ops/pallas/residual_unit_wide.py _kernel and
// magvit2_pytorch_tpu/ops/pallas/residual_unit.py _kernel (the same unit on
// the lane-packed view of the same bytes); see
// ops/kernels/residual_unit.py for the math, the cast points and the order
// of the launches.
//
// Bound: compute. At C = 512, T = 20, 16 x 16, batch 8 the unit is 528
// GFLOP over the conv taps that read a real pixel (601 with the pads)
// against ~84 MB of activation I/O: 0.53 ms at 989 dense bf16 TFLOP/s,
// 0.03 ms at 3.35 TB/s. The conv is 94% of those operations.
//
// Entry points, each one launch or a short chain on scratch the wrapper
// allocates; x and every activation (B, T, H, W, C) channels-last:
//   mv2_ru_gemm           y = ELU(T(T(A Wt^T) + b)): the conv (K = 27 C,
//                         A gathered from x) or the 1x1 (K = C, A dense)
//   mv2_ru_se_logits      logits = float(T(T(y . k) + kb)), lanes a pixel
//   mv2_ru_se_gates       the SqueezeExcite reduction and gate MLP: frame
//                         softmax stats, partial contexts over (frame,
//                         pixel slice) blocks, then a block per frame sums
//                         them in order and runs the MLP (no atomics)
//   mv2_ru_gate_residual  out = T(T(out * gates) + x), in place
//
// The GEMM has three routes, picked by ops/kernels/residual_unit.py
// ru_conv_route and passed in; a route that does not fit the call returns
// cudaErrorInvalidValue (the wrapper raises, nothing falls back):
//   kRuWgmma  bf16, C % 64 == 0: TMA + wgmma. The conv is an implicit GEMM
//             with M = output pixels, N = C_out, K = 27 C_in tap-major
//             (k = tap * C + ci, tap = (dt * 3 + dh) * 3 + dw). An M tile
//             is a 16 w x 8 h box of one frame of one video; its A operand
//             for tap (dt, dh, dw) and channels c0..c0+63 is one TMA box
//             {64, 16, 8, 1, 1} of the 5-D map (C, W, H, T, B) over x at
//             (c0, w0 - 1 + dw, h0 - 1 + dh, t - 2 + dt, b). TMA's
//             out-of-bounds zero fill is the causal pad (t - 2 + dt < 0) and
//             the spatial pad, and since b is a dimension of its own no tap
//             reaches into batch element b - 1. A tile in frame 0 or 1
//             skips the taps before frame 0 outright (18 or 9 of 27), since
//             they multiply zeros. The box lands as 128 rows of 128 B, the
//             layout of a 2-D {64, 128} box, so one K-major swizzled
//             descriptor serves both. At C = 64 one halo box of 16 x 10
//             pixels serves the three dh taps of a (dt, dw) pair. The 1x1
//             runs the same mainloop on a 2-D map over y1 (M, C).
//   kRuWmma   bf16, C % 64 == 32: warp-level WMMA with a predicated
//             cp.async gather of the taps.
//   kRuF32    float32 on the CUDA cores (no TF32).
#include <algorithm>

#include "hopper.cuh"

namespace mv2 {

// ops/kernels/residual_unit.py RU_ROUTES
enum RuRoute { kRuF32 = 0, kRuWmma = 1, kRuWgmma = 2 };

// Shape of x: the conv's gather computes each tap's address from these.
struct Geom {
  int B, T, H, W, C;
  long long M;  // B * T * H * W output pixels
};

// Position of output pixel m inside its video: frame t, row h, column w.
struct Pix {
  int t, h, w;
  bool in;  // m < M
};

__device__ __forceinline__ Pix pixel_of(long long m, const Geom& g) {
  Pix p;
  p.in = m < g.M;
  p.w = (int)(m % g.W);
  const long long r = m / g.W;
  p.h = (int)(r % g.H);
  p.t = (int)((r / g.H) % g.T);
  return p;
}

// The epilogue of both GEMMs: round the float32 sum to the working dtype,
// add the bias in it, then ELU (max(v, 0) + expm1(min(v, 0)))
// (residual_unit_wide.py:136-138).
template <typename T>
__device__ __forceinline__ T bias_elu(float acc, T bias) {
  const float v = round_to<T>(round_to<T>(acc) + to_f32(bias));
  return from_f32<T>(v > 0.f ? v : expm1f(v));
}

// ---- kRuWmma: bf16 on warp-level WMMA, C % 64 == 32 ------------------------
// out[M, N] = epilogue(A[M, K] Wt[N, K]^T). kConv: A is gathered from x as
// above (K = 27 C); otherwise A is a dense (M, K) matrix. 128 x 64 output
// tile per block of 4 warps (each 64 x 32: 4 x 2 WMMA 16x16x16 fragments),
// K in steps of 32 through a 3-stage cp.async ring in dynamic shared
// memory; the float32 accumulators are staged through the same shared
// memory for the bounds-checked epilogue.
constexpr int kRuBM = 128, kRuBN = 64, kRuBK = 32, kRuThreads = 128;
constexpr int kRuStages = 3;
constexpr int kRuLd = kRuBK + 8;   // bf16 row stride (80 bytes)
constexpr int kRuCLd = kRuBN + 4;  // float row stride of the staged tile
constexpr int kRuSmemBytes = kRuStages * (kRuBM + kRuBN) * kRuLd * 2;
static_assert(kRuBM * kRuCLd * 4 <= kRuSmemBytes, "staged tile must fit");
static_assert(kRuSmemBytes <= 48 * 1024, "no opt-in shared memory needed");

template <bool kConv>
__global__ void __launch_bounds__(kRuThreads)
    ru_gemm_bf16_kernel(const bf16* __restrict__ A,
                        const bf16* __restrict__ Wt,
                        const bf16* __restrict__ bias, bf16* __restrict__ out,
                        Geom g, int N, int K) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);    // [stage][BM][Ld]
  bf16* Bs = As + kRuStages * kRuBM * kRuLd;   // [stage][BN][Ld]
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][CLd], after the loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / 2) * 64, wn = (warp % 2) * 32;
  const int ntiles = (N + kRuBN - 1) / kRuBN;
  // the N tiles of one M tile are neighbours, so they share its A in L2
  const long long row0 = (long long)(blockIdx.x / ntiles) * kRuBM;
  const int col0 = (int)(blockIdx.x % ntiles) * kRuBN;

  // loader: thread -> rows lr + 32 i of A (i < 4) and of B (i < 2), 8
  // values from column c8 of each K step
  const int lr = tid / 4, c8 = (tid % 4) * 8;
  Pix pix[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pix[i] = pixel_of(row0 + lr + 32 * i, g);

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * kRuBK;
    bf16* as = As + stage * kRuBM * kRuLd;
    bf16* bs = Bs + stage * kRuBN * kRuLd;
    if (kConv) {
      const int tap = k0 / g.C;
      const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
      const long long off =
          ((long long)(dt - 2) * g.H * g.W + (long long)(dh - 1) * g.W +
           (dw - 1)) * g.C + (k0 - tap * g.C) + c8;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Pix& p = pix[i];
        const int tt = p.t - 2 + dt, hh = p.h - 1 + dh, ww = p.w - 1 + dw;
        const bool ok = p.in && tt >= 0 && hh >= 0 && hh < g.H && ww >= 0 &&
                        ww < g.W;
        const long long m = row0 + lr + 32 * i;
        cp_async16(as + (lr + 32 * i) * kRuLd + c8,
                   ok ? A + m * g.C + off : A, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long m = row0 + lr + 32 * i;
        const bool ok = pix[i].in;
        cp_async16(as + (lr + 32 * i) * kRuLd + c8,
                   ok ? A + m * K + k0 + c8 : A, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = col0 + lr + 32 * i;
      const bool ok = n < N;
      cp_async16(bs + (lr + 32 * i) * kRuLd + c8,
                 ok ? Wt + (long long)n * K + k0 + c8 : Wt, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = K / kRuBK;
#pragma unroll
  for (int s = 0; s < kRuStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kRuStages - 2>();  // step kt has landed
    __syncthreads();                 // ... for every thread; kt - 1 is done
    const int next = kt + kRuStages - 1;
    if (next < KT) load_stage(next % kRuStages, next);
    cp_async_commit();
    const bf16* as = As + (kt % kRuStages) * kRuBM * kRuLd;
    const bf16* bs = Bs + (kt % kRuStages) * kRuBN * kRuLd;
#pragma unroll
    for (int kk = 0; kk < kRuBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * kRuLd + kk, kRuLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // Wt^T as a column-major (k, n) tile
        wmma::load_matrix_sync(b[j], bs + (wn + 16 * j) * kRuLd + kk, kRuLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the tile over it
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * kRuCLd + wn + 16 * j,
                              acc[i][j], kRuCLd, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < kRuBM * kRuBN; idx += kRuThreads) {
    const int r = idx / kRuBN, c = idx % kRuBN;
    const long long m = row0 + r;
    const int n = col0 + c;
    if (m < g.M && n < N)
      out[m * N + n] = bias_elu<bf16>(Cs[r * kRuCLd + c], bias[n]);
  }
}

// ---- kRuF32: float32 on the CUDA cores (no TF32) ----------------------------
// The float32 path of common.cuh's gemm_nt_f32_kernel with the same A
// operand as above: 64 x 64 tile, 256 threads with 4 x 4 outputs each, K in
// steps of 16 (inside one tap, as C % 32 == 0), 16-byte loads.
constexpr int kRuF32BM = 64, kRuF32BN = 64, kRuF32BK = 16, kRuF32Threads = 256;

template <bool kConv>
__global__ void __launch_bounds__(kRuF32Threads)
    ru_gemm_f32_kernel(const float* __restrict__ A,
                       const float* __restrict__ Wt,
                       const float* __restrict__ bias, float* __restrict__ out,
                       Geom g, int N, int K) {
  __shared__ float As[kRuF32BK][kRuF32BM + 4];
  __shared__ float Ws[kRuF32BK][kRuF32BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ntiles = (N + kRuF32BN - 1) / kRuF32BN;
  const long long row0 = (long long)(blockIdx.x / ntiles) * kRuF32BM;
  const int col0 = (int)(blockIdx.x % ntiles) * kRuF32BN;
  // loader: thread -> tile row lr, four consecutive k from lk
  const int lr = tid / 4, lk = (tid % 4) * 4;
  const long long am = row0 + lr;
  const Pix p = pixel_of(am, g);
  const int wn = col0 + lr;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kRuF32BK) {
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), wv = av;
    if (kConv) {
      const int tap = k0 / g.C;
      const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
      const int tt = p.t - 2 + dt, hh = p.h - 1 + dh, ww = p.w - 1 + dw;
      if (p.in && tt >= 0 && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W) {
        const long long off =
            ((long long)(dt - 2) * g.H * g.W + (long long)(dh - 1) * g.W +
             (dw - 1)) * g.C + (k0 - tap * g.C) + lk;
        av = *reinterpret_cast<const float4*>(A + am * g.C + off);
      }
    } else if (p.in) {
      av = *reinterpret_cast<const float4*>(A + am * K + k0 + lk);
    }
    if (wn < N)
      wv = *reinterpret_cast<const float4*>(Wt + (long long)wn * K + k0 + lk);
    As[lk + 0][lr] = av.x; As[lk + 1][lr] = av.y;
    As[lk + 2][lr] = av.z; As[lk + 3][lr] = av.w;
    Ws[lk + 0][lr] = wv.x; Ws[lk + 1][lr] = wv.y;
    Ws[lk + 2][lr] = wv.z; Ws[lk + 3][lr] = wv.w;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRuF32BK; ++kk) {
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
    const long long m = row0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n < N) out[m * N + n] = bias_elu<float>(acc[i][j], bias[n]);
    }
  }
}

template <bool kConv>
cudaError_t launch_ru_gemm(const bf16* A, const bf16* Wt, const bf16* bias,
                           bf16* out, const Geom& g, int N, int K,
                           cudaStream_t stream) {
  const long long tiles = ((g.M + kRuBM - 1) / kRuBM) *
                          (long long)((N + kRuBN - 1) / kRuBN);
  ru_gemm_bf16_kernel<kConv><<<(unsigned)tiles, kRuThreads, kRuSmemBytes,
                               stream>>>(A, Wt, bias, out, g, N, K);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <bool kConv>
cudaError_t launch_ru_gemm(const float* A, const float* Wt, const float* bias,
                           float* out, const Geom& g, int N, int K,
                           cudaStream_t stream) {
  const long long tiles = ((g.M + kRuF32BM - 1) / kRuF32BM) *
                          (long long)((N + kRuF32BN - 1) / kRuF32BN);
  ru_gemm_f32_kernel<kConv><<<(unsigned)tiles, kRuF32Threads, 0, stream>>>(
      A, Wt, bias, out, g, N, K);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// ---- kRuWgmma: TMA + wgmma --------------------------------------------------
// gemm.cu's pipeline: one block of two warpgroups owns a 128 x BN output
// tile (warpgroup w its rows 64w..64w+63, BN / 2 float32 registers a
// thread); K runs in tiles of 64 bf16, one 128-byte swizzle row. Thread 0
// keeps up to kStages (A, W) tile pairs in flight, each stage completing an
// mbarrier by its byte count; both warpgroups wait on a stage, issue four
// wgmmas on it, commit, and wait only for the previous stage's group,
// which thread 0 then refills. The epilogue (bias + ELU with the JAX
// kernel's cast points) stages the tile as bf16 in the idle ring and
// stores whole rows in 16-byte pieces, skipping rows outside the frame
// (conv) or past M (1x1). BN = 128, or 64 where C is not a multiple of
// 128 (the 64-channel stem). The ring takes 96 KB at BN = 128 (3 stages)
// and for a BN = 64 conv above C = 64 (4 stages): two blocks an SM, as 106
// registers a thread at BN = 128 allow. The 1x1 at BN = 64 has few K
// tiles (one at C = 64): two stages do, and four blocks an SM hide each
// other's loads.
//
// The stem's conv (C = 64, one K tile a tap) is bound by refilling shared
// memory, not by the tensor cores: a tap's 16 KB A box feeds only 1 MFLOP.
// There a stage holds a halo box {64, 16, 10, 1, 1} for one (dt, dw) pair,
// rows h0 - 1 .. h0 + 8, and the three dh taps read it at row offsets
// 0, 16 and 32 (multiples of 2048 B, so the swizzle's phase and the
// descriptor's base offset stay 0), beside the three taps' weight tiles:
// 9 stage loads of 44 KB a tile instead of 27 of 24 KB. Two stages
// (88 KB), two blocks an SM.
constexpr int kBoxW = 16, kBoxH = 8;   // a conv M tile: pixels of one frame
constexpr int kRuWgBM = kBoxW * kBoxH;
constexpr int kRuWgThreads = 256;

// kHalo: the conv at C = 64 (BN = 64, one channel chunk a tap)
template <int BN, bool kConv, bool kHalo>
struct RuWgTile {
  static_assert(!kHalo || (kConv && BN == 64), "the halo is the stem's");
  static constexpr int kHaloH = kBoxH + 2;
  static constexpr int kStages = BN == 128 ? 3 : (kConv && !kHalo ? 4 : 2);
  static constexpr int kTileA =  // bytes
      (kHalo ? kBoxW * kHaloH : kRuWgBM) * kSw128Cols * 2;
  static constexpr int kTileW = (kHalo ? 3 : 1) * BN * kSw128Cols * 2;
  static constexpr int kStageBytes = kTileA + kTileW;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
  static constexpr int kLd = BN + 8;  // staged row: 16 bytes of padding
  static_assert(kTileA % 1024 == 0 && kTileW % 1024 == 0,
                "every tile starts on a swizzle period");
  static_assert(kRuWgBM * kLd * 2 <= kStages * kStageBytes,
                "the staged tile fits in the ring");
};

template <int BN, bool kConv, bool kHalo>
__global__ void __launch_bounds__(kRuWgThreads, 2)
    ru_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_w,
                         const bf16* __restrict__ bias,
                         bf16* __restrict__ out, Geom g) {
  typedef RuWgTile<BN, kConv, kHalo> P;
  constexpr int S = P::kStages;
  extern __shared__ unsigned char ru_smem_raw[];
  __shared__ __align__(8) uint64_t full[S];
  unsigned char* ring = align1024(ru_smem_raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int chunks = g.C / kSw128Cols;  // K tiles of a tap (conv) or of K
  const int ntiles = g.C / BN;
  // the N tiles of one M tile are neighbours, so they share its A in L2
  const int n0 = (int)(blockIdx.x % ntiles) * BN;
  long long mt = blockIdx.x / ntiles;
  int b = 0, t = 0, h0 = 0, w0 = 0, first = 0, ktiles = chunks;
  long long m0 = 0;
  if (kConv) {
    const int wt = (g.W + kBoxW - 1) / kBoxW, ht = (g.H + kBoxH - 1) / kBoxH;
    w0 = (int)(mt % wt) * kBoxW;
    mt /= wt;
    h0 = (int)(mt % ht) * kBoxH;
    mt /= ht;
    t = (int)(mt % g.T);
    b = (int)(mt / g.T);
    // the causal skip: no tap before frame 0; a halo K step is a (dt, dw)
    // pair of the one channel chunk
    first = max(0, 2 - t) * (kHalo ? 3 : 9 * chunks);
    ktiles = kHalo ? 9 : 27 * chunks;
  } else {
    m0 = mt * kRuWgBM;
  }
  const int n = ktiles - first;  // K tiles this block multiplies, >= 1

  auto load = [&](int i) {  // thread 0: K tile first + i into stage i % S
    const int kt = first + i;
    unsigned char* st = ring + (i % S) * P::kStageBytes;
    uint64_t* bar = &full[i % S];
    mbar_expect_tx(bar, P::kStageBytes);
    if (kHalo) {
      const int dt = kt / 3, dw = kt % 3;
      tma_load_5d(st, &map_a, bar, 0, w0 - 1 + dw, h0 - 1, t - 2 + dt, b);
      for (int dh = 0; dh < 3; ++dh)
        tma_load_2d(st + P::kTileA + dh * (P::kTileW / 3), &map_w, bar,
                    ((dt * 3 + dh) * 3 + dw) * kSw128Cols, n0);
      return;
    }
    if (kConv) {
      const int tap = kt / chunks, c0 = (kt - tap * chunks) * kSw128Cols;
      const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
      tma_load_5d(st, &map_a, bar, c0, w0 - 1 + dw, h0 - 1 + dh, t - 2 + dt,
                  b);
    } else {
      tma_load_2d(st, &map_a, bar, kt * kSw128Cols, (int)m0);
    }
    tma_load_2d(st + P::kTileA, &map_w, bar, kt * kSw128Cols, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < S && i < n; ++i) load(i);
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    unsigned char* st = ring + s * P::kStageBytes;
    mbar_wait(&full[s], (i / S) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int dh = 0; dh < (kHalo ? 3 : 1); ++dh) {
      // the halo box's rows for tap dh start kBoxW rows further down
      const uint64_t da =
          sw128_desc(st + (wg * (kRuWgBM / 2) + dh * kBoxW) * 128);
      const uint64_t db =
          sw128_desc(st + P::kTileA + dh * (P::kTileW / 3));
#pragma unroll
      for (int kk = 0; kk < kSw128Cols / 16; ++kk)
        wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // tile i - 1's group is done: its stage may refill
    fence_acc(acc);
    __syncthreads();
    if (tid == 0 && i >= 1 && i - 1 + S < n) load(i - 1 + S);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();  // every wgmma has read its stage: the ring is free

  // accumulator layout of m64nNk16: warp q of the warpgroup holds rows
  // 16q + lane/4 (registers 4j, 4j+1) and 16q + lane/4 + 8 (4j+2, 4j+3) at
  // columns 8j + 2 (lane % 4) and the one after
  bf16* tile = reinterpret_cast<bf16*>(ring);
  const int lane = tid % 32, q = (tid % 128) / 32;
  const int r = wg * 64 + q * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    const bf16 b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
    *reinterpret_cast<__nv_bfloat162*>(tile + r * P::kLd + c) =
        __halves2bfloat162(bias_elu<bf16>(acc[4 * j], b0),
                           bias_elu<bf16>(acc[4 * j + 1], b1));
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * P::kLd + c) =
        __halves2bfloat162(bias_elu<bf16>(acc[4 * j + 2], b0),
                           bias_elu<bf16>(acc[4 * j + 3], b1));
  }
  __syncthreads();
  constexpr int per_row = BN * 2 / 16;
  for (int idx = tid; idx < kRuWgBM * per_row; idx += kRuWgThreads) {
    const int tr = idx / per_row, tc = (idx % per_row) * 8;
    long long m;
    bool in;
    if (kConv) {
      const int h = h0 + tr / kBoxW, w = w0 + tr % kBoxW;
      in = h < g.H && w < g.W;
      m = (((long long)b * g.T + t) * g.H + h) * g.W + w;
    } else {
      m = m0 + tr;
      in = m < g.M;
    }
    if (in)
      *reinterpret_cast<uint4*>(out + m * g.C + n0 + tc) =
          *reinterpret_cast<const uint4*>(tile + tr * P::kLd + tc);
  }
}

template <int BN, bool kConv, bool kHalo>
cudaError_t launch_ru_wgmma(const bf16* A, const bf16* Wt, const bf16* bias,
                            bf16* out, const Geom& g, cudaStream_t stream) {
  typedef RuWgTile<BN, kConv, kHalo> P;
  CUtensorMap map_a, map_w;
  cudaError_t err;
  long long mtiles;
  if (kConv) {
    const long long dims[5] = {g.C, g.W, g.H, g.T, g.B};
    const int box[5] = {kSw128Cols, kBoxW, kHalo ? P::kHaloH : kBoxH, 1,
                        1};
    err = tensor_map_5d(&map_a, A, dims, box);
    mtiles = (long long)g.B * g.T * ((g.H + kBoxH - 1) / kBoxH) *
             ((g.W + kBoxW - 1) / kBoxW);
  } else {
    err = tensor_map_2d(&map_a, A, g.M, g.C, kRuWgBM);
    mtiles = (g.M + kRuWgBM - 1) / kRuWgBM;
  }
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&map_w, Wt, g.C, (kConv ? 27LL : 1LL) * g.C, BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ru_gemm_wgmma_kernel<BN, kConv, kHalo>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = mtiles * (g.C / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ru_gemm_wgmma_kernel<BN, kConv, kHalo><<<(unsigned)blocks, kRuWgThreads,
                                           P::kSmem, stream>>>(
      map_a, map_w, bias, out, g);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the conv (kConv) or the 1x1 on the given route
template <bool kConv>
cudaError_t ru_gemm(const float* A, const float* Wt, const float* bias,
                    float* out, const Geom& g, int route,
                    cudaStream_t stream) {
  if (route != kRuF32) return cudaErrorInvalidValue;
  return launch_ru_gemm<kConv>(A, Wt, bias, out, g, g.C,
                               (kConv ? 27 : 1) * g.C, stream);
}

template <bool kConv>
cudaError_t ru_gemm(const bf16* A, const bf16* Wt, const bf16* bias,
                    bf16* out, const Geom& g, int route,
                    cudaStream_t stream) {
  if (route == kRuWmma)
    return launch_ru_gemm<kConv>(A, Wt, bias, out, g, g.C,
                                 (kConv ? 27 : 1) * g.C, stream);
  if (route != kRuWgmma || g.C % 64 ||
      ((uintptr_t)A | (uintptr_t)Wt | (uintptr_t)out) % 16)
    return cudaErrorInvalidValue;  // the rule is ru_conv_route
  if (g.C % 128 == 0)
    return launch_ru_wgmma<128, kConv, false>(A, Wt, bias, out, g, stream);
  if (kConv && g.C == 64)
    return launch_ru_wgmma<64, kConv, kConv>(A, Wt, bias, out, g, stream);
  return launch_ru_wgmma<64, kConv, false>(A, Wt, bias, out, g, stream);
}

// ---- SqueezeExcite ---------------------------------------------------------

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// logits[m] = float(T(T(sum_c y[m, c] k[c]) + kb)): float32 products and
// sums (residual_unit_wide.py:139-145). A group of L lanes takes a pixel (L
// the largest power of two <= min(32, C / 8), chosen by the launcher), each
// lane 8 channels at a time with 16-byte loads; the group's sums meet by
// shuffles, so at C = 64 a warp reads 4 pixels (512 B) a step.
constexpr int kLogitThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kLogitThreads)
    se_logits_kernel(const T* __restrict__ y, const T* __restrict__ k,
                     const T* __restrict__ kb, float* __restrict__ logits,
                     long long M, int C, int L) {
  const int sub = threadIdx.x % L;
  const long long m =
      ((long long)blockIdx.x * kLogitThreads + threadIdx.x) / L;
  const bool in = m < M;  // every lane still takes part in the shuffles
  float s = 0.f;
  if (in) {
    const T* row = y + m * C;
    for (int c = sub * 8; c < C; c += 8 * L) {
      float v[8], w[8];
      load8(row + c, v);
      load8(k + c, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[e] * w[e];
    }
  }
  for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (in && sub == 0)
    logits[m] = round_to<T>(round_to<T>(s) + to_f32(kb[0]));
}

__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[32];
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  __syncthreads();
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  v = lane < nwarps ? warp_max[lane] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}


// (a) one block per frame f: the max and the sum of exp(l - max) of its
// logits, in float32 (residual_unit_wide.py:147-150)
constexpr int kSeStatThreads = 256;

__global__ void __launch_bounds__(kSeStatThreads)
    se_stats_kernel(const float* __restrict__ logits,
                    float* __restrict__ stats, int HW) {
  const float* l = logits + (long long)blockIdx.x * HW;
  float mx = -INFINITY;
  for (int m = threadIdx.x; m < HW; m += blockDim.x) mx = fmaxf(mx, l[m]);
  mx = block_max(mx);
  float s = 0.f;
  for (int m = threadIdx.x; m < HW; m += blockDim.x) s += expf(l[m] - mx);
  s = block_sum(s);
  if (threadIdx.x == 0) {
    stats[2 * blockIdx.x] = mx;
    stats[2 * blockIdx.x + 1] = s;
  }
}

// (b) block (slice s, frame f): the partial context of the frame's pixels
// [s P, (s + 1) P), P = ceil(HW / slices), in float32: attn[m] =
// T(exp(l[m] - max) / sum), recomputed here (the JAX kernel's rounding),
// times y[m, c]. C / 8 threads cover a pixel's row with 16-byte loads, the
// block's other rows of threads take the following pixels; their sums meet
// in shared memory in a fixed order.
constexpr int kSePartThreads = 256;
constexpr int kSePartChunk = 1024;  // attention weights staged at a time

template <typename T>
__global__ void __launch_bounds__(kSePartThreads)
    se_partial_kernel(const T* __restrict__ y,
                      const float* __restrict__ logits,
                      const float* __restrict__ stats,
                      float* __restrict__ partial, int HW, int C,
                      int slices) {
  __shared__ float attn[kSePartChunk];
  __shared__ float part[kSePartThreads * 8];  // rows x C
  const int s = blockIdx.x;
  const long long f = blockIdx.y;
  const int per = (HW + slices - 1) / slices;
  const int p0 = s * per, p1 = min(HW, p0 + per);
  const float mx = stats[2 * f], sum = stats[2 * f + 1];
  const int G = C / 8, R = kSePartThreads / G;
  const int tid = threadIdx.x, row = tid / G, c8 = (tid % G) * 8;
  const bool active = row < R;
  const float* l = logits + f * HW;
  const T* yf = y + f * HW * (long long)C + c8;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int q0 = p0; q0 < p1; q0 += kSePartChunk) {
    const int q1 = min(p1, q0 + kSePartChunk);
    __syncthreads();  // the previous chunk's weights have been read
    for (int m = q0 + tid; m < q1; m += kSePartThreads)
      attn[m - q0] = round_to<T>(expf(l[m] - mx) / sum);
    __syncthreads();
    if (active) {
      for (int m = q0 + row; m < q1; m += R) {
        float v[8];
        load8(yf + (long long)m * C, v);
        const float a = attn[m - q0];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += v[e] * a;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int e = 0; e < 8; ++e) part[row * C + c8 + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < C; c += kSePartThreads) {
    float v = 0.f;
    for (int r = 0; r < R; ++r) v += part[r * C + c];
    partial[(f * slices + s) * C + c] = v;
  }
}

// (c) one block per frame f: context[c] = T(sum over the slices in order),
// then the gate MLP with its cast points (residual_unit_wide.py:151-153);
// writes gates[f, :].
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kSeThreads = 512;
constexpr int kSeMaxC = 1024;  // ops/kernels/residual_unit.py MAX_CHANNELS

template <typename T>
__global__ void __launch_bounds__(kSeThreads)
    se_gate_kernel(const float* __restrict__ partial,
                   const T* __restrict__ gi_w, const T* __restrict__ gi_b,
                   const T* __restrict__ go_w, const T* __restrict__ go_b,
                   T* __restrict__ gates, int C, int hidden, int slices) {
  __shared__ float ctx[kSeMaxC];
  __shared__ float hid[kSeMaxC];
  const int tid = threadIdx.x;
  const long long f = blockIdx.x;
  const float* pf = partial + f * slices * C;
  for (int c = tid; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < slices; ++s) acc += pf[(long long)s * C + c];
    ctx[c] = round_to<T>(acc);
  }
  __syncthreads();
  // a warp per output, its lanes along the weight row (coalesced)
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  for (int j = warp; j < hidden; j += nwarps) {
    const T* wr = gi_w + (long long)j * C;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) acc += ctx[c] * to_f32(wr[c]);
    acc = warp_sum(acc);
    const float v = round_to<T>(round_to<T>(acc) + to_f32(gi_b[j]));
    if (lane == 0) hid[j] = round_to<T>(v > 0.f ? v : 0.1f * v);  // leaky 0.1
  }
  __syncthreads();
  for (int c = warp; c < C; c += nwarps) {
    const T* wr = go_w + (long long)c * hidden;
    float acc = 0.f;
    for (int j = lane; j < hidden; j += 32) acc += hid[j] * to_f32(wr[j]);
    acc = warp_sum(acc);
    const float z = round_to<T>(round_to<T>(acc) + to_f32(go_b[c]));
    if (lane == 0) gates[f * C + c] = from_f32<T>(1.f / (1.f + expf(-z)));
  }
}

template <typename T>
cudaError_t se_gates(const T* y, const float* logits, const T* gi_w,
                     const T* gi_b, const T* go_w, const T* go_b,
                     float* stats, float* partial, T* gates, int frames,
                     int HW, int C, int hidden, int slices,
                     cudaStream_t stream) {
  if (frames < 1 || HW < 1 || slices < 1 || slices > 65535 || C < 8 ||
      C % 8 || C > kSeMaxC || hidden < 1 || hidden > kSeMaxC)
    return cudaErrorInvalidValue;
  se_stats_kernel<<<frames, kSeStatThreads, 0, stream>>>(logits, stats, HW);
  MV2_CHECK_LAUNCH();
  se_partial_kernel<T><<<dim3(slices, frames), kSePartThreads, 0, stream>>>(
      y, logits, stats, partial, HW, C, slices);
  MV2_CHECK_LAUNCH();
  se_gate_kernel<T><<<frames, kSeThreads, 0, stream>>>(
      partial, gi_w, gi_b, go_w, go_b, gates, C, hidden, slices);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// out[m, c] = T(T(out[m, c] * gates[frame(m), c]) + x[m, c]): eight
// channels a thread with 16-byte loads and stores (C % 8 == 0).
constexpr int kGateThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kGateThreads)
    gate_residual_kernel(T* __restrict__ out, const T* __restrict__ x,
                         const T* __restrict__ gates, long long M, int HW,
                         int C) {
  const int groups = C / 8;
  const long long total = M * groups;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long m = i / groups;
    const int c0 = (int)(i - m * groups) * 8;
    float o[8], g[8], xv[8];
    load8(out + m * C + c0, o);
    load8(gates + (m / HW) * C + c0, g);
    load8(x + m * C + c0, xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = round_to<T>(o[e] * g[e]) + xv[e];
    store8(out + m * C + c0, o);
  }
}

}  // namespace mv2

// The unit's launches (ops/kernels/residual_unit.py unit_launches). dtype
// is common.cuh's DType (RuT below); every tensor is of it but logits,
// stats and partial (float32).
#define MV2_RU_DISPATCH(CALL)                                   \
  do {                                                          \
    if (dtype == mv2::kFloat32) {                               \
      typedef float RuT;                                        \
      return CALL;                                              \
    }                                                           \
    if (dtype == mv2::kBFloat16) {                              \
      typedef mv2::bf16 RuT;                                    \
      return CALL;                                              \
    }                                                           \
    return cudaErrorInvalidValue;                               \
  } while (0)

extern "C" {

// out = ELU(T(T(A W^T) + bias)) over x (B, T, H, W, C): conv = 1 the
// causal 3x3x3 conv with w (C, 27 C) tap-major, conv = 0 the 1x1 of a
// (B * T * H * W, C) with w (C, C); on the given RuRoute
int mv2_ru_gemm(const void* a, const void* w, const void* bias, void* out,
                int dtype, int B, int T, int H, int W, int C, int conv,
                int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || W < 1 || C < 32 || C % 32)
    return cudaErrorInvalidValue;
  const mv2::Geom g{B, T, H, W, C, (long long)B * T * H * W};
#define MV2_RU_GEMM(TYPE)                                                 \
  (conv ? mv2::ru_gemm<true>((const TYPE*)a, (const TYPE*)w,             \
                             (const TYPE*)bias, (TYPE*)out, g, route, s)  \
        : mv2::ru_gemm<false>((const TYPE*)a, (const TYPE*)w,            \
                              (const TYPE*)bias, (TYPE*)out, g, route, s))
  MV2_RU_DISPATCH(MV2_RU_GEMM(RuT));
#undef MV2_RU_GEMM
}

// logits (M,) float32 of y (M, C)
int mv2_ru_se_logits(const void* y, const void* k_w, const void* k_b,
                     void* logits, int dtype, long long M, int C,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || C < 8 || C % 8 || (uintptr_t)k_w % 16)
    return cudaErrorInvalidValue;
  int L = 32;  // lanes a pixel
  while (L > C / 8) L /= 2;
  const long long blocks =
      (M * L + mv2::kLogitThreads - 1) / mv2::kLogitThreads;
#define MV2_RU_LOGITS(TYPE)                                                \
  (mv2::se_logits_kernel<TYPE><<<(unsigned)blocks, mv2::kLogitThreads, 0,  \
                                 s>>>((const TYPE*)y, (const TYPE*)k_w,    \
                                      (const TYPE*)k_b, (float*)logits, M, \
                                      C, L),                               \
   cudaGetLastError())
  MV2_RU_DISPATCH(MV2_RU_LOGITS(RuT));
#undef MV2_RU_LOGITS
}

// gates (frames, C) of y (frames * HW, C) and its logits; stats (frames, 2)
// and partial (frames, slices, C) float32 scratch
int mv2_ru_se_gates(const void* y, const void* logits, const void* gi_w,
                    const void* gi_b, const void* go_w, const void* go_b,
                    void* stats, void* partial, void* gates, int dtype,
                    int frames, int HW, int C, int hidden, int slices,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MV2_RU_SE(TYPE)                                                      \
  mv2::se_gates<TYPE>((const TYPE*)y, (const float*)logits,                 \
                      (const TYPE*)gi_w, (const TYPE*)gi_b,                 \
                      (const TYPE*)go_w, (const TYPE*)go_b, (float*)stats,  \
                      (float*)partial, (TYPE*)gates, frames, HW, C, hidden, \
                      slices, s)
  MV2_RU_DISPATCH(MV2_RU_SE(RuT));
#undef MV2_RU_SE
}

// out (M, C) = T(T(out * gates[frame]) + x), in place
int mv2_ru_gate_residual(void* out, const void* x, const void* gates,
                         int dtype, long long M, int HW, int C,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || HW < 1 || C % 8 ||
      ((uintptr_t)out | (uintptr_t)x | (uintptr_t)gates) % 16)
    return cudaErrorInvalidValue;
  const long long work = M * (C / 8);
  const unsigned blocks = (unsigned)std::min<long long>(
      (work + mv2::kGateThreads - 1) / mv2::kGateThreads, 132 * 32);
#define MV2_RU_GATE(TYPE)                                                   \
  (mv2::gate_residual_kernel<TYPE><<<blocks, mv2::kGateThreads, 0, s>>>(   \
       (TYPE*)out, (const TYPE*)x, (const TYPE*)gates, M, HW, C),          \
   cudaGetLastError())
  MV2_RU_DISPATCH(MV2_RU_GATE(RuT));
#undef MV2_RU_GATE
}

}  // extern "C"
