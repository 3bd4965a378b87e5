// The launches the attention blocks share (csrc/attention_block.cu,
// csrc/taylor_attention.cu, wrapped by ops/kernels/gemm.py): a row RMSNorm
// and the projection GEMM C[M, N] = A[M, K] W[N, K]^T (the nn.Linear
// layout) with float32 accumulation, cast once to the input's dtype. Every
// route's epilogue can scale the first scaled_cols columns in float32
// before that cast: the Taylor block's q * d^-1/2. The wrapper picks one of
// three routes by a static shape rule (ops/kernels/gemm.py gemm_route) and
// passes it in:
//   kRouteF32    float32 in and out: CUDA-core FMAs, 64x64 tiles, no TF32.
//   kRouteWmma   bf16 in, any shape: warp-level WMMA, 64x64 tiles.
//   kRouteWgmma  bf16 in, K and N multiples of 64, 16-byte aligned rows:
//                TMA + wgmma, 128x128 tiles through a 3-stage ring of
//                128-byte-swizzled shared memory. Every projection of the
//                flagship's attention blocks takes this route.
// A route that does not fit the call returns cudaErrorInvalidValue: the
// wrapper raises, nothing falls back. The TMA, mbarrier and wgmma helpers
// and the tensor maps are csrc/hopper.cuh's, shared with the fused
// ResidualUnit's conv and 1x1 (csrc/residual_unit.cu). Built for sm_90a.
#include "hopper.cuh"

namespace mv2 {

enum GemmRoute { kRouteF32 = 0, kRouteWmma = 1, kRouteWgmma = 2 };

// ---- row RMSNorm ---------------------------------------------------------

// out[r] = T(x[r] / ||x[r]|| * sqrt(C)) * gamma: the norm in float32, cast
// to the working dtype, then the gamma multiply in it
// (ops/pallas/axial_attention.py:38-43, taylor_attention.py:63-70). One
// warp per row, eight rows a block; a lane takes two neighbouring values at
// a time, so a warp's loads and stores cover 64 values of a row. The row is
// read twice (the second time from L1): a pass over x and out is the bound.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  typedef float2 type;
};
template <>
struct Pair<bf16> {
  typedef __nv_bfloat162 type;
};

constexpr int kRmsRows = 8, kRmsThreads = 32 * kRmsRows;

template <typename T>
__global__ void __launch_bounds__(kRmsThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   T* __restrict__ out, int rows, int C) {
  typedef typename Pair<T>::type P;
  const int row = blockIdx.x * kRmsRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  // C is even (the launcher's check): a row is C / 2 aligned pairs
  const P* xr = reinterpret_cast<const P*>(x + (size_t)row * C);
  const P* gr = reinterpret_cast<const P*>(gamma);
  P* orow = reinterpret_cast<P*>(out + (size_t)row * C);
  float ss = 0.f;
  for (int c = lane; c < C / 2; c += 32) {
    const P v = xr[c];
    const float a = to_f32(v.x), b = to_f32(v.y);
    ss += a * a + b * b;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float scale = sqrtf((float)C) / sqrtf(fmaxf(ss, 1e-24f));
  for (int c = lane; c < C / 2; c += 32) {
    const P v = xr[c], g = gr[c];
    P o;
    o.x = from_f32<T>(round_to<T>(to_f32(v.x) * scale) * to_f32(g.x));
    o.y = from_f32<T>(round_to<T>(to_f32(v.y) * scale) * to_f32(g.y));
    orow[c] = o;
  }
}

template <typename T>
cudaError_t launch_rmsnorm(const T* x, const T* gamma, T* out, int rows,
                           int C, cudaStream_t stream) {
  if (C % 2 || ((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)out) %
                   sizeof(typename Pair<T>::type))
    return cudaErrorInvalidValue;  // the wrapper passes even C, aligned
  rmsnorm_kernel<T><<<(rows + kRmsRows - 1) / kRmsRows, kRmsThreads, 0,
                      stream>>>(x, gamma, out, rows, C);
  return cudaGetLastError();
}

// ---- kRouteF32: CUDA-core FMAs -------------------------------------------

// 64x64 output tile per block of 256 threads, 4x4 outputs a thread, K in
// steps of 16 through shared memory (results differ from float32
// references only by summation order).
constexpr int kGemmBM = 64, kGemmBN = 64, kGemmBK = 16, kGemmThreads = 256;

__global__ void __launch_bounds__(kGemmThreads)
    gemm_nt_f32_kernel(const float* __restrict__ A,
                       const float* __restrict__ W, float* __restrict__ C,
                       int M, int N, int K, int scaled_cols, float col_scale) {
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
      if (c < N)
        C[(size_t)r * N + c] = c < scaled_cols ? acc[i][j] * col_scale
                                               : acc[i][j];
    }
  }
}

// ---- kRouteWmma: warp-level tensor cores, any shape ----------------------

// Same 64x64 output tile, K in steps of 32 through shared memory, four
// warps with 32x32 each (2x2 fragments of 16x16x16), float32 accumulators
// staged through shared memory for the bounds-checked epilogue.
constexpr int kWmmaBK = 32, kWmmaThreads = 128;
constexpr int kWmmaLd = kWmmaBK + 8;      // bf16 row stride, multiple of 8
constexpr int kWmmaCLd = kGemmBN + 4;     // float row stride, multiple of 4

__global__ void __launch_bounds__(kWmmaThreads)
    gemm_nt_wmma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                        bf16* __restrict__ C, int M, int N, int K,
                        int scaled_cols, float col_scale) {
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
    const float v = Cs[idx / kGemmBN][idx % kGemmBN];
    if (r < M && c < N)
      C[(size_t)r * N + c] =
          __float2bfloat16(c < scaled_cols ? v * col_scale : v);
  }
}

inline dim3 gemm_grid(int M, int N) {
  return dim3((M + kGemmBM - 1) / kGemmBM, (N + kGemmBN - 1) / kGemmBN);
}

// ---- kRouteWgmma: TMA + wgmma --------------------------------------------

// One block of two warpgroups owns a 128x128 output tile; warpgroup w owns
// rows 64w..64w+63 and keeps them in 64 float32 registers a thread. K runs
// in tiles of 64 bf16, exactly one 128-byte swizzle row: thread 0 keeps up
// to three (A, W) tile pairs in flight with TMA, each stage completing an
// mbarrier by its byte count. Both warpgroups wait on a stage's barrier,
// issue four m64n128k16 wgmmas on it and commit them, then wait only for
// the previous stage's group, so the tensor cores run while the block meets
// at a __syncthreads and thread 0 refills that previous stage. Rows and
// columns past M and N arrive as zeros from TMA. The epilogue stages the
// tile in the (then idle) ring in bf16 and writes it back row by row in
// 16-byte pieces, so a warp's stores cover whole rows. 96 KB of shared
// memory and <= 128 registers a thread: two blocks share an SM, and one
// block's epilogue overlaps the other's main loop.
constexpr int kWgBM = 128, kWgBN = 128, kWgBK = 64, kWgStages = 3;
constexpr int kWgThreads = 256;
constexpr int kWgTileA = kWgBM * kWgBK * 2;  // bytes
constexpr int kWgTileW = kWgBN * kWgBK * 2;
constexpr int kWgStageBytes = kWgTileA + kWgTileW;
constexpr int kWgSmem = kWgStages * kWgStageBytes + 1024;  // + 1024 B align
static_assert(kWgBK == kSw128Cols, "a K tile is one swizzle row");

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__global__ void __launch_bounds__(kWgThreads, 2)
    gemm_nt_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_w,
                         bf16* __restrict__ C, int M, int N, int K,
                         int scaled_cols, float col_scale) {
  extern __shared__ unsigned char wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages];
  unsigned char* ring = align1024(wg_smem_raw);
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * kWgBN, m0 = blockIdx.y * kWgBM;
  const int ktiles = K / kWgBK;

  auto load = [&](int kt) {  // thread 0: K tile kt into its stage
    unsigned char* st = ring + (kt % kWgStages) * kWgStageBytes;
    uint64_t* bar = &full[kt % kWgStages];
    mbar_expect_tx(bar, kWgStageBytes);
    tma_load_2d(st, &map_a, bar, kt * kWgBK, m0);
    tma_load_2d(st + kWgTileA, &map_w, bar, kt * kWgBK, n0);
  };
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kt = 0; kt < kWgStages && kt < ktiles; ++kt) load(kt);
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kWgStages;
    unsigned char* st = ring + s * kWgStageBytes;
    mbar_wait(&full[s], (kt / kWgStages) & 1);
    const uint64_t da = sw128_desc(st + wg * (kWgBM / 2) * 128);
    const uint64_t db = sw128_desc(st + kWgTileA);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's group is done: its stage may refill
    fence_acc(acc);
    __syncthreads();
    if (tid == 0 && kt >= 1 && kt - 1 + kWgStages < ktiles)
      load(kt - 1 + kWgStages);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  __syncthreads();  // every wgmma has read its stage: the ring is free

  // accumulator layout of m64nNk16: warp q of the warpgroup holds rows
  // 16q + lane/4 (registers 4j, 4j+1) and 16q + lane/4 + 8 (4j+2, 4j+3) at
  // columns 8j + 2 (lane % 4) and the one after
  // the staging row: 128 values and 16 bytes, so the 8 rows a warp's
  // fragment store touches fall in different banks
  constexpr int ld = kWgBN + 16 / (int)sizeof(bf16);
  bf16* tile = reinterpret_cast<bf16*>(ring);
  const int lane = tid % 32, q = (tid % 128) / 32;
  const int r = wg * 64 + q * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kWgBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    // the scaled columns come in pairs: scaled_cols is even
    const float s = n0 + c < scaled_cols ? col_scale : 1.f;
    store2(tile + r * ld + c, acc[4 * j] * s, acc[4 * j + 1] * s);
    store2(tile + (r + 8) * ld + c, acc[4 * j + 2] * s, acc[4 * j + 3] * s);
  }
  __syncthreads();
  // 16-byte pieces, consecutive threads along a row; N is a multiple of
  // 64, so a piece is wholly inside N or wholly past it
  constexpr int per_row = kWgBN * (int)sizeof(bf16) / 16;
  constexpr int vals = 16 / (int)sizeof(bf16);
  for (int idx = tid; idx < kWgBM * per_row; idx += kWgThreads) {
    const int tr = idx / per_row, tc = (idx % per_row) * vals;
    if (m0 + tr < M && n0 + tc < N)
      *reinterpret_cast<uint4*>(C + (size_t)(m0 + tr) * N + n0 + tc) =
          *reinterpret_cast<const uint4*>(tile + tr * ld + tc);
  }
}

cudaError_t launch_gemm_nt_wgmma(const bf16* A, const bf16* W, bf16* C, int M,
                                 int N, int K, int scaled_cols,
                                 float col_scale, cudaStream_t stream) {
  if (M < 1 || K % kWgBK || N % 64 || ((uintptr_t)A | (uintptr_t)W) % 16)
    return cudaErrorInvalidValue;  // not this route's shape: the rule is
                                   // ops/kernels/gemm.py gemm_route
  CUtensorMap map_a, map_w;
  cudaError_t err = tensor_map_2d(&map_a, A, M, K, kWgBM);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&map_w, W, N, K, kWgBN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_nt_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kWgBN - 1) / kWgBN, (M + kWgBM - 1) / kWgBM);
  gemm_nt_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      map_a, map_w, C, M, N, K, scaled_cols, col_scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

cudaError_t launch_gemm_nt_bf16(const bf16* A, const bf16* W, bf16* C, int M,
                                int N, int K, int route, int scaled_cols,
                                float col_scale, cudaStream_t stream) {
  if (route == kRouteWgmma)
    return launch_gemm_nt_wgmma(A, W, C, M, N, K, scaled_cols, col_scale,
                                stream);
  if (route != kRouteWmma) return cudaErrorInvalidValue;
  gemm_nt_wmma_kernel<<<gemm_grid(M, N), kWmmaThreads, 0, stream>>>(
      A, W, C, M, N, K, scaled_cols, col_scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace mv2

extern "C" {

int mv2_rmsnorm(const void* x, const void* gamma, void* out, int dtype,
                int rows, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mv2::kFloat32)
    return mv2::launch_rmsnorm((const float*)x, (const float*)gamma,
                               (float*)out, rows, C, s);
  if (dtype == mv2::kBFloat16) {
    typedef mv2::bf16 T;
    return mv2::launch_rmsnorm((const T*)x, (const T*)gamma, (T*)out, rows,
                               C, s);
  }
  return cudaErrorInvalidValue;
}

// C (M, N) = A (M, K) W (N, K)^T in A's dtype, on the given route; the
// first scaled_cols columns (even, 0 for none) times col_scale in float32
// before the one cast
int mv2_gemm_nt(const void* a, const void* w, void* c, int dtype, int M,
                int N, int K, int route, int scaled_cols, float col_scale,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scaled_cols < 0 || scaled_cols > N || scaled_cols % 2)
    return cudaErrorInvalidValue;
  if (dtype == mv2::kFloat32) {
    if (route != mv2::kRouteF32) return cudaErrorInvalidValue;
    mv2::gemm_nt_f32_kernel<<<mv2::gemm_grid(M, N), mv2::kGemmThreads, 0,
                              s>>>((const float*)a, (const float*)w,
                                   (float*)c, M, N, K, scaled_cols,
                                   col_scale);
    return cudaGetLastError();
  }
  if (dtype != mv2::kBFloat16) return cudaErrorInvalidValue;
  typedef mv2::bf16 T;
  return mv2::launch_gemm_nt_bf16((const T*)a, (const T*)w, (T*)c, M, N, K,
                                  route, scaled_cols, col_scale, s);
}

}  // extern "C"
