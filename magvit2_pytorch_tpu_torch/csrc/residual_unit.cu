// Fused ResidualUnit: causal 3x3x3 conv -> ELU -> 1x1 -> ELU ->
// SqueezeExcite -> +x. Replaces the TPU kernels
// magvit2_pytorch_tpu/ops/pallas/residual_unit_wide.py _kernel and
// magvit2_pytorch_tpu/ops/pallas/residual_unit.py _kernel (the same unit on
// the lane-packed view of the same bytes); see
// ops/kernels/residual_unit.py for the math, the cast points and the design
// note.
//
// Bound: compute. At C = 512, T = 20, 16 x 16, batch 8 the unit is 528
// GFLOP over the conv taps that read a real pixel (601 with the pads)
// against ~84 MB of activation I/O: 0.53 ms at 989 dense bf16 TFLOP/s,
// 0.03 ms at 3.35 TB/s.
//
// Five launches on scratch the caller allocates, x and out (B, T, H, W, C):
//   y1     = ELU(T(T(conv(x)) + conv_b))       implicit GEMM, K = 27 C
//   out    = ELU(T(T(y1 pw^T) + pw_b))         GEMM, K = C
//   logits = float(T(T(out . k) + kb))         one warp per pixel
//   gates  = SE MLP of the frame's context      one block per frame
//   out    = T(T(out * gates) + x)             elementwise, in place
//
// The conv's A operand: row m = output pixel (b, t, h, w), column
// k = tap * C + ci with tap = (dt * 3 + dh) * 3 + dw, reading
// x[b, t - 2 + dt, h - 1 + dh, w - 1 + dw, ci]. A tap before frame 0 (the
// causal pad) or outside the frame (the spatial pad) reads zero, so no tap
// reaches into batch element b - 1. C % 32 == 0 keeps every 32-wide K chunk
// inside one tap. The B operand is the weight re-laid by the wrapper as
// (C_out, 27 C_in) in the same tap-major order.
#include <algorithm>

#include "common.cuh"

namespace mv2 {

// ---- cp.async (16 bytes, zero-filled when the predicate is false) --------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shape of x: the conv's gather computes each tap's address from these.
struct Geom {
  int T, H, W, C;
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

// ---- bf16 GEMM on the tensor cores -----------------------------------------
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

// ---- float32 GEMM on the CUDA cores (no TF32) --------------------------------
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

// ---- SqueezeExcite ---------------------------------------------------------

// logits[m] = float(T(T(sum_c y[m, c] k[c]) + kb)): float32 products and
// sums (residual_unit_wide.py:139-145), one warp per pixel.
constexpr int kLogitThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kLogitThreads)
    se_logits_kernel(const T* __restrict__ y, const T* __restrict__ k,
                     const T* __restrict__ kb, float* __restrict__ logits,
                     long long M, int C) {
  const long long m =
      (long long)blockIdx.x * (kLogitThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;  // the whole warp leaves together
  const T* row = y + m * C;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f32(row[c]) * to_f32(k[c]);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) logits[m] = round_to<T>(round_to<T>(s) + to_f32(kb[0]));
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

// One block per frame f (residual_unit_wide.py:147-170): softmax of the
// frame's logits in float32 (the logits are overwritten with the attention
// weights, rounded to T), context[c] = T(sum_m attn[m] y[m, c]) with float32
// sums in a fixed order (P pixel slices, then the slices in turn: no
// atomics), then the gate MLP with its cast points; writes gates[f, :].
constexpr int kSeThreads = 512;
constexpr int kSeMaxC = 1024;  // ops/kernels/residual_unit.py MAX_CHANNELS

template <typename T>
__global__ void __launch_bounds__(kSeThreads)
    se_frame_kernel(const T* __restrict__ y, float* attn,
                    const T* __restrict__ gi_w, const T* __restrict__ gi_b,
                    const T* __restrict__ go_w, const T* __restrict__ go_b,
                    T* __restrict__ gates, int HW, int C, int hidden) {
  __shared__ float part[kSeMaxC];  // P * C <= max(C, kSeThreads)
  __shared__ float ctx[kSeMaxC];
  __shared__ float hid[kSeMaxC];
  const int tid = threadIdx.x;
  const long long f = blockIdx.x;
  float* a = attn + f * HW;  // no __restrict__: written, then re-read
  const T* yf = y + f * HW * (long long)C;

  float mx = -INFINITY;
  for (int m = tid; m < HW; m += blockDim.x) mx = fmaxf(mx, a[m]);
  mx = block_max(mx);
  float s = 0.f;
  for (int m = tid; m < HW; m += blockDim.x) s += expf(a[m] - mx);
  s = block_sum(s);
  __syncthreads();  // every thread has read its logits
  for (int m = tid; m < HW; m += blockDim.x)
    a[m] = round_to<T>(expf(a[m] - mx) / s);
  __syncthreads();

  const int P = max(1, (int)blockDim.x / C);
  for (int idx = tid; idx < P * C; idx += blockDim.x) {
    const int p = idx / C, c = idx % C;
    float acc = 0.f;
    for (int m = p; m < HW; m += P) acc += to_f32(yf[(long long)m * C + c]) * a[m];
    part[idx] = acc;
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += part[p * C + c];
    ctx[c] = round_to<T>(acc);
  }
  __syncthreads();
  for (int j = tid; j < hidden; j += blockDim.x) {
    const T* wr = gi_w + (long long)j * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc += ctx[c] * to_f32(wr[c]);
    const float v = round_to<T>(round_to<T>(acc) + to_f32(gi_b[j]));
    hid[j] = round_to<T>(v > 0.f ? v : 0.1f * v);  // leaky_relu(0.1)
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const T* wr = go_w + (long long)c * hidden;
    float acc = 0.f;
    for (int j = 0; j < hidden; ++j) acc += hid[j] * to_f32(wr[j]);
    const float z = round_to<T>(round_to<T>(acc) + to_f32(go_b[c]));
    gates[f * C + c] = from_f32<T>(1.f / (1.f + expf(-z)));
  }
}

// out[m, c] = T(T(out[m, c] * gates[frame(m), c]) + x[m, c]): eight
// channels a thread (C % 32 == 0).
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
    const T* gr = gates + (m / HW) * C + c0;
    T* o = out + m * C + c0;
    const T* xr = x + m * C + c0;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = from_f32<T>(round_to<T>(to_f32(o[e]) * to_f32(gr[e])) +
                         to_f32(xr[e]));
  }
}

template <typename T>
cudaError_t residual_unit(const T* x, const T* wr, const T* conv_b,
                          const T* pw_w, const T* pw_b, const T* k_w,
                          const T* k_b, const T* gi_w, const T* gi_b,
                          const T* go_w, const T* go_b, T* out, T* y1,
                          float* logits, T* gates, int B, int Tn, int H,
                          int W, int C, int hidden, cudaStream_t stream) {
  if (C % 32 != 0 || C > kSeMaxC || hidden > kSeMaxC || hidden < 1)
    return cudaErrorInvalidValue;
  const Geom g{Tn, H, W, C, (long long)B * Tn * H * W};
  const int HW = H * W;
  cudaError_t err = launch_ru_gemm<true>(x, wr, conv_b, y1, g, C, 27 * C,
                                         stream);
  if (err != cudaSuccess) return err;
  err = launch_ru_gemm<false>(y1, pw_w, pw_b, out, g, C, C, stream);
  if (err != cudaSuccess) return err;
  const long long lblocks = (g.M + kLogitThreads / 32 - 1) / (kLogitThreads / 32);
  se_logits_kernel<T><<<(unsigned)lblocks, kLogitThreads, 0, stream>>>(
      out, k_w, k_b, logits, g.M, C);
  MV2_CHECK_LAUNCH();
  se_frame_kernel<T><<<B * Tn, kSeThreads, 0, stream>>>(
      out, logits, gi_w, gi_b, go_w, go_b, gates, HW, C, hidden);
  MV2_CHECK_LAUNCH();
  const long long work = g.M * (C / 8);
  const long long gblocks =
      std::min<long long>((work + kGateThreads - 1) / kGateThreads, 132 * 32);
  gate_residual_kernel<T><<<(unsigned)gblocks, kGateThreads, 0, stream>>>(
      out, x, gates, g.M, HW, C);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace mv2

extern "C" int mv2_residual_unit(const void* x, const void* wr,
                                 const void* conv_b, const void* pw_w,
                                 const void* pw_b, const void* k_w,
                                 const void* k_b, const void* gi_w,
                                 const void* gi_b, const void* go_w,
                                 const void* go_b, void* out, void* y1,
                                 void* logits, void* gates, int dtype, int B,
                                 int T, int H, int W, int C, int hidden,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MV2_RU_CALL(TYPE)                                                    \
  mv2::residual_unit<TYPE>(                                                  \
      (const TYPE*)x, (const TYPE*)wr, (const TYPE*)conv_b,                  \
      (const TYPE*)pw_w, (const TYPE*)pw_b, (const TYPE*)k_w,                \
      (const TYPE*)k_b, (const TYPE*)gi_w, (const TYPE*)gi_b,                \
      (const TYPE*)go_w, (const TYPE*)go_b, (TYPE*)out, (TYPE*)y1,           \
      (float*)logits, (TYPE*)gates, B, T, H, W, C, hidden, s)
  if (dtype == mv2::kFloat32) return MV2_RU_CALL(float);
  if (dtype == mv2::kBFloat16) return MV2_RU_CALL(mv2::bf16);
#undef MV2_RU_CALL
  return cudaErrorInvalidValue;
}
