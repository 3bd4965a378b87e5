// Flash attention with a backward pass: softmax(scale Q K^T + bias) V over
// key tiles with an online softmax, so the (n, m) score matrix never exists
// in device memory in either direction. Replaces the three TPU kernels of
// magvit2_pytorch_tpu/ops/pallas/flash_attention.py: _flash_kernel (forward,
// also the per-row logsumexp), _bwd_dq_kernel (dQ, and dS as d_bias when
// there is a bias) and _bwd_dkv_kernel (dK, dV). See
// ops/kernels/flash_attention.py for the wrapper and the plain versions.
//
// q (bh, n, D), k and v (bh, m, D) with m >= n, read in place: no padded
// copies, the ragged last tile is predicated (key < m, row < n). Keys >= m
// and, with causal, keys > row + (m - n) are hidden (the mask is
// right-aligned: the m - n keys in front are visible to every query).
// bias, when given, is (groups, n, m) with groups in {1, h, b h}; program
// bh reads slice bh % groups, so a broadcast bias is never materialised.
//
// Two routes, one per dtype: ops/kernels/flash_attention.py flash_route
// picks it for all three kernels and passes it in, and the entry points
// refuse a route that does not fit the dtype.
// - 'mma' (bf16): every product on mma.sync m16n8k16 with float32
//   accumulators in registers. A block owns rows of its output (query rows
//   for the forward and dQ, key rows for dK/dV), holds its own operand rows
//   as A fragments in registers and streams tiles of the other side through
//   a cp.async ring in shared memory. A C fragment's columns are the next
//   product's reduction dimension, so P and dS go from one product's
//   accumulators to the next one's A operand in registers, rounded to bf16
//   there and only there; the forward's online softmax runs on the
//   accumulators too. With causal, a block visits only the tiles that hold
//   a pair it may see (see "the causal skip" below).
// - 'f32' (float32): the CUDA-core kernels (no TF32): one block of four
//   warps owns 64 rows, each warp 16 of them, and loops over 64-wide tiles
//   of the other side staged in shared memory.
// Either way every output tile has one owner: no atomics, the same sums in
// the same order on every run. Running max, sum, lse, P and dS are float32.
//
// What bounds it on the H100: operations. At the flagship's space stage at
// 512 px (bh = 136, n = 4096, m = 4100, D = 32, bf16) the forward is
// 4 bh n m D = 292 GFLOP (0.30 ms at 989 TFLOP/s) against 143 MB of q, k,
// v, o (0.04 ms at 3.35 TB/s); dQ does 6 bh n m D and dK/dV 8 bh n m D
// (each recomputes S), 0.44 and 0.59 ms. At D = 32 the exp of every pair
// weighs more than the products: 2.28e9 ex2 on the special-function unit,
// 16 a clock an SM, ~0.55 ms at 132 SMs and 1.98 GHz, once in the forward
// and once in each backward kernel.
#include "common.cuh"

namespace mv2 {
namespace flash {

// the routes (ops/kernels/flash_attention.py ROUTES); each takes one dtype
enum Route { kRouteF32 = 0, kRouteMma = 1 };

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.6931471805599453f;

// ---- the float32 kernels on the CUDA cores (the 'f32' route) --------------

constexpr int kTile = 64;      // rows a block owns; width of a streamed tile
constexpr int kRows = 16;      // rows a warp owns
constexpr int kThreads = 128;  // four warps
constexpr float kMasked = -1e30f;

// Row strides in shared memory, in floats: odd, so a warp reading one
// column of 32 rows hits 32 banks.
template <int D>
struct Cfg {
  static constexpr int ldt = D + 1;      // (64, D) input tile
  static constexpr int ldp = kTile + 1;  // (64, 64) tile: P or dS
  static constexpr int lds = kTile + 1;  // (64, 64) tile: S or dP
  static constexpr int lda = D + 1;      // (64, D) accumulator
};

__host__ __device__ constexpr size_t align_up(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

__device__ __forceinline__ float* carve(unsigned char*& p, int count) {
  float* out = reinterpret_cast<float*>(p);
  p += align_up(sizeof(float) * count);
  return out;
}

// bytes of `tiles` (64, D) input tiles, `accs` accumulators, one S and one
// P tile and `vectors` 64-float row vectors
template <int D>
constexpr size_t smem_bytes(int tiles, int accs, int vectors) {
  typedef Cfg<D> C;
  return tiles * align_up(sizeof(float) * kTile * C::ldt) +
         accs * align_up(sizeof(float) * kTile * C::lda) +
         align_up(sizeof(float) * kTile * C::lds) +
         align_up(sizeof(float) * kTile * C::ldp) +
         vectors * align_up(sizeof(float) * kTile);
}

// Rows row0 .. row0 + 63 of src (rows, D) into a shared tile; rows past the
// end are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int row0, int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, e = idx % D;
    dst[r * ld + e] =
        row0 + r < rows ? src[(size_t)(row0 + r) * D + e] : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows) {
  if (threadIdx.x < kTile)
    dst[threadIdx.x] =
        row0 + threadIdx.x < rows ? src[row0 + threadIdx.x] : 0.f;
}

__device__ __forceinline__ void fill(float* dst, int count, float value) {
  for (int idx = threadIdx.x; idx < count; idx += kThreads) dst[idx] = value;
}

// One warp: C (16, N) = [C +] A (16, K) op(B), all row-major in shared
// memory: with BT, B is (N, K) and op(B) = B^T; else B is (K, N). Lane l
// owns columns l and l + 32.
template <int N, int K, bool ACC, bool BT>
__device__ __forceinline__ void warp_mma(const float* A, int lda,
                                         const float* B, int ldb, float* C,
                                         int ldc) {
  const int lane = threadIdx.x % 32;
  constexpr int NC = (N + 31) / 32;
  float acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      acc[r][j] = (ACC && c < N) ? C[r * ldc + c] : 0.f;
    }
#pragma unroll 4
  for (int e = 0; e < K; ++e) {
    float b[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      b[j] = c < N ? (BT ? B[c * ldb + e] : B[e * ldb + c]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float a = A[r * lda + e];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] += a * b[j];
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c < N) C[r * ldc + c] = acc[r][j];
    }
}

// C = A B^T and C += A B, as the kernels below use them
template <int N, int K>
__device__ __forceinline__ void warp_mma_nt(const float* A, int lda,
                                            const float* B, int ldb, float* C,
                                            int ldc) {
  warp_mma<N, K, false, true>(A, lda, B, ldb, C, ldc);
}

template <int N, int K>
__device__ __forceinline__ void warp_acc_nn(const float* A, int lda,
                                            const float* B, int ldb, float* C,
                                            int ldc) {
  warp_mma<N, K, true, false>(A, lda, B, ldb, C, ldc);
}

// Forward: one block per (bh, 64 query rows). Per key tile and warp:
// S = Q K^T; then lane (row, half) of the warp owns 32 columns of one of its
// 16 rows: it updates the row's running max m and sum l (in registers, one
// shuffle with the lane of the other half), writes P = exp(S - m) and
// rescales its half of the row of O by exp(m_old - m_new); then O += P V.
// The lane walks its 32 columns starting at 16 half, so that the 32 lanes
// of a warp read 32 different banks of S. At the end O / max(l, 1e-30) and
// lse = m + log(l). Hidden pairs score -1e30.
template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ lse, int n, int m,
               int q_tiles, int bias_groups, int causal, float scale) {
  typedef Cfg<D> C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  float* Qs = carve(sp, kTile * C::ldt);
  float* Ks = carve(sp, kTile * C::ldt);
  float* Vs = carve(sp, kTile * C::ldt);
  float* Of = carve(sp, kTile * C::lda);
  float* Sf = carve(sp, kTile * C::lds);
  float* Pt = carve(sp, kTile * C::ldp);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int half = lane & 1, srow = r0 + (lane >> 1);  // the lane's row
  const int row = q0 + srow, rot = 16 * half;
  const int offset = m - n;
  const float* kb = k + (size_t)bh * m * D;
  const float* vb = v + (size_t)bh * m * D;
  const float* bb =
      bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  load_tile<D>(Qs, C::ldt, q + (size_t)bh * n * D, q0, n);
  fill(Of, kTile * C::lda, 0.f);
  float m_run = kMasked, l_run = 0.f;

  for (int k0 = 0; k0 < m; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, C::ldt, kb, k0, m);
    load_tile<D>(Vs, C::ldt, vb, k0, m);
    __syncthreads();
    warp_mma_nt<kTile, D>(Qs + r0 * C::ldt, C::ldt, Ks, C::ldt,
                          Sf + r0 * C::lds, C::lds);
    __syncwarp();
    float s[32];
    float mx = kMasked;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int c = 32 * half + ((t + rot) & 31), col = k0 + c;
      float x = Sf[srow * C::lds + c] * scale;
      if (bb && row < n && col < m) x += bb[(size_t)row * m + col];
      const bool ok = col < m && (!causal || col <= row + offset);
      s[t] = ok ? x : kMasked;
      mx = fmaxf(mx, s[t]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int c = 32 * half + ((t + rot) & 31);
      const float p = expf(s[t] - m_new);
      sum += p;
      Pt[srow * C::ldp + c] = p;
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + sum;
    m_run = m_new;
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      Of[srow * C::lda + half * (D / 2) + e] *= alpha;
    __syncwarp();
    warp_acc_nn<D, kTile>(Pt + r0 * C::ldp, C::ldp, Vs, C::ldt,
                          Of + r0 * C::lda, C::lda);
    __syncwarp();
  }

  if (row < n) {
    const float l = fmaxf(l_run, 1e-30f);
    const float inv = 1.f / l;
    float* orow = out + ((size_t)bh * n + row) * D + half * (D / 2);
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      orow[e] = Of[srow * C::lda + half * (D / 2) + e] * inv;
    if (half == 0) lse[(size_t)bh * n + row] = m_run + logf(l);
  }
}

// dQ: one block per (bh, 64 query rows). Per key tile and warp:
// P = exp(S - lse) on the visible keys, dP = dO V^T, dS = P (dP - delta),
// dQ += dS K; dS also goes to dbias (bh, n, m) when asked. dQ *= scale.
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  float* __restrict__ dbias, int n, int m, int q_tiles,
                  int bias_groups, int causal, float scale) {
  typedef Cfg<D> C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  float* Qs = carve(sp, kTile * C::ldt);
  float* dOs = carve(sp, kTile * C::ldt);
  float* Ks = carve(sp, kTile * C::ldt);
  float* Vs = carve(sp, kTile * C::ldt);
  float* dQf = carve(sp, kTile * C::lda);
  float* Sf = carve(sp, kTile * C::lds);
  float* Pt = carve(sp, kTile * C::ldp);
  float* lse_s = carve(sp, kTile);
  float* delta_s = carve(sp, kTile);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int offset = m - n;
  const float* kb = k + (size_t)bh * m * D;
  const float* vb = v + (size_t)bh * m * D;
  const float* bb =
      bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
  float* dbb = dbias ? dbias + (size_t)bh * n * m : nullptr;

  load_tile<D>(Qs, C::ldt, q + (size_t)bh * n * D, q0, n);
  load_tile<D>(dOs, C::ldt, dout + (size_t)bh * n * D, q0, n);
  load_rows(lse_s, lse + (size_t)bh * n, q0, n);
  load_rows(delta_s, delta + (size_t)bh * n, q0, n);
  fill(dQf, kTile * C::lda, 0.f);

  for (int k0 = 0; k0 < m; k0 += kTile) {
    __syncthreads();
    load_tile<D>(Ks, C::ldt, kb, k0, m);
    load_tile<D>(Vs, C::ldt, vb, k0, m);
    __syncthreads();
    warp_mma_nt<kTile, D>(Qs + r0 * C::ldt, C::ldt, Ks, C::ldt,
                          Sf + r0 * C::lds, C::lds);
    __syncwarp();
    float p[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        float x = Sf[(r0 + r) * C::lds + c] * scale;
        if (bb && row < n && col < m) x += bb[(size_t)row * m + col];
        const bool ok =
            row < n && col < m && (!causal || col <= row + offset);
        p[r][j] = ok ? expf(x - lse_s[r0 + r]) : 0.f;
      }
    }
    __syncwarp();  // S is read; dP takes its place
    warp_mma_nt<kTile, D>(dOs + r0 * C::ldt, C::ldt, Vs, C::ldt,
                          Sf + r0 * C::lds, C::lds);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        const float ds =
            p[r][j] * (Sf[(r0 + r) * C::lds + c] - delta_s[r0 + r]);
        Pt[(r0 + r) * C::ldp + c] = ds;
        if (dbb && row < n && col < m) dbb[(size_t)row * m + col] = ds;
      }
    }
    __syncwarp();
    warp_acc_nn<D, kTile>(Pt + r0 * C::ldp, C::ldp, Ks, C::ldt,
                          dQf + r0 * C::lda, C::lda);
    __syncwarp();
  }

  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= n) break;
    float* drow = dq + ((size_t)bh * n + row) * D;
    for (int e = lane; e < D; e += 32)
      drow[e] = dQf[(r0 + r) * C::lda + e] * scale;
  }
}

// dK, dV: one block per (bh, 64 key rows), each warp 16 keys. Per query
// tile the products are formed transposed, so the warp's rows stay keys:
// S^T = K Q^T, P^T = exp(S^T - lse[query]), dV += P^T dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - delta[query]), dK += dS^T Q. dK *= scale.
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int n, int m, int k_tiles,
                   int bias_groups, int causal, float scale) {
  typedef Cfg<D> C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  float* Ks = carve(sp, kTile * C::ldt);
  float* Vs = carve(sp, kTile * C::ldt);
  float* Qs = carve(sp, kTile * C::ldt);
  float* dOs = carve(sp, kTile * C::ldt);
  float* dKf = carve(sp, kTile * C::lda);
  float* dVf = carve(sp, kTile * C::lda);
  float* Sf = carve(sp, kTile * C::lds);
  float* Pt = carve(sp, kTile * C::ldp);
  float* lse_s = carve(sp, kTile);
  float* delta_s = carve(sp, kTile);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int offset = m - n;
  const float* qb = q + (size_t)bh * n * D;
  const float* dob = dout + (size_t)bh * n * D;
  const float* bb =
      bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  load_tile<D>(Ks, C::ldt, k + (size_t)bh * m * D, k0, m);
  load_tile<D>(Vs, C::ldt, v + (size_t)bh * m * D, k0, m);
  fill(dKf, kTile * C::lda, 0.f);
  fill(dVf, kTile * C::lda, 0.f);

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();
    load_tile<D>(Qs, C::ldt, qb, q0, n);
    load_tile<D>(dOs, C::ldt, dob, q0, n);
    load_rows(lse_s, lse + (size_t)bh * n, q0, n);
    load_rows(delta_s, delta + (size_t)bh * n, q0, n);
    __syncthreads();
    warp_mma_nt<kTile, D>(Ks + r0 * C::ldt, C::ldt, Qs, C::ldt,
                          Sf + r0 * C::lds, C::lds);
    __syncwarp();
    float p[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j, row = q0 + c;
        float x = Sf[(r0 + r) * C::lds + c] * scale;
        if (bb && row < n && key < m) x += bb[(size_t)row * m + key];
        const bool ok =
            row < n && key < m && (!causal || key <= row + offset);
        p[r][j] = ok ? expf(x - lse_s[c]) : 0.f;
        Pt[(r0 + r) * C::ldp + c] = p[r][j];
      }
    }
    __syncwarp();
    warp_acc_nn<D, kTile>(Pt + r0 * C::ldp, C::ldp, dOs, C::ldt,
                          dVf + r0 * C::lda, C::lda);
    warp_mma_nt<kTile, D>(Vs + r0 * C::ldt, C::ldt, dOs, C::ldt,
                          Sf + r0 * C::lds, C::lds);
    __syncwarp();  // P^T is read; dS^T takes its place
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        Pt[(r0 + r) * C::ldp + c] =
            p[r][j] * (Sf[(r0 + r) * C::lds + c] - delta_s[c]);
      }
    __syncwarp();
    warp_acc_nn<D, kTile>(Pt + r0 * C::ldp, C::ldp, Qs, C::ldt,
                          dKf + r0 * C::lda, C::lda);
    __syncwarp();
  }

  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + r0 + r;
    if (key >= m) break;
    float* krow = dk + ((size_t)bh * m + key) * D;
    float* vrow = dv + ((size_t)bh * m + key) * D;
    for (int e = lane; e < D; e += 32) {
      krow[e] = dKf[(r0 + r) * C::lda + e] * scale;
      vrow[e] = dVf[(r0 + r) * C::lda + e];
    }
  }
}

// ---- the bf16 kernels on the tensor cores (the 'mma' route) ---------------
//
// Three kernels. Each block of warps owns rows of its output, 16 or 32 a
// warp, and streams tiles of the other side through a ring of stages in
// shared memory, filled by cp.async (zero-filled past the last row) so that
// the next tile loads while this one runs its products, a chunk of its rows
// at a time (the fewer, the fewer registers). Every product is mma.sync
// m16n8k16 on bf16 with float32 accumulators in registers:
//   forward S = Q K^T                  Q: A fragments held in registers;
//                                      K by ldmatrix
//         online softmax               in the accumulators' registers: the
//                                      running max and sum of a row reduced
//                                      over the 4 lanes of its quad; exp as
//                                      ex2 with log2 e folded into the scale
//         O += P V                     P rounded to bf16 as the A operand,
//                                      V by ldmatrix.trans; O in registers
//   dQ    S = Q K^T, dP = dO V^T       Q, dO: A fragments held in registers;
//                                      K, V by ldmatrix
//         P = 2^(S scale log2e + bias log2e - lse log2e) on the visible keys
//         dS = P (dP - delta)          in the accumulators' registers
//         dQ += dS K                   dS rounded to bf16 as the A operand,
//                                      K by ldmatrix.trans
//   dK/dV S^T = K Q^T, dP^T = V dO^T   K, V: A fragments in registers; Q, dO
//                                      by ldmatrix
//         P^T, dS^T as above, with lse and delta per column (query)
//         dV += P^T dO, dK += dS^T Q   dO, Q by ldmatrix.trans
// Nothing but the streamed tiles touches shared memory. Rows are padded from
// D to D + 8 bf16, so the 8 rows an ldmatrix phase reads fall in 8
// different bank groups. The bias is read one bf16 at a time: a row of a
// (groups, n, m) bias is 4-byte aligned only when m is even.
//
// The causal skip (ops/kernels/flash_attention.py dq_key_tiles,
// dkv_query_tiles and tile_masked are its Python twin): the forward's and
// dQ's loops end at the last key tile their block's last row sees, the
// dK/dV loop starts at the first query tile whose last row sees the block's
// first key; only a tile that crosses the diagonal or a ragged edge
// (rows >= n, keys >= m) tests each element, and a hidden pair's exponent is
// -inf, so P = 0 before any use. No branch sits around an ldmatrix or mma.
// No atomics, one owner per output tile.

// tile (q0 .. q0 + nq - 1) x (k0 .. k0 + nk - 1) has a pair to mask: a ragged
// edge, or with causal a key past the diagonal of its first row
__device__ __forceinline__ bool tile_masked(int q0, int nq, int k0, int nk,
                                            int n, int m, int causal) {
  return q0 + nq > n || k0 + nk > m || (causal && k0 + nk - 1 > q0 + m - n);
}

// ROWS rows from row0 of src (rows, D) into a ring tile with rows of D + 8,
// zeros past the last row, by THREADS threads
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src,
                                           int row0, int rows) {
  constexpr int V = D / 8;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < ROWS * V; idx += THREADS) {
    const int r = idx / V, e = (idx % V) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * (D + 8) + e, src + (size_t)(ok ? row0 + r : 0) * D + e,
               ok);
  }
}

// A fragments of rows ra and ra + 8 of src (rows, D), straight from device
// memory: a[c] covers columns 16c .. 16c + 15; rows past the last are zero
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4],
                                       const bf16* src, int ra, int rows) {
  const int tq = threadIdx.x % 4;
  auto word = [&](int row, int col) -> unsigned {
    return row < rows
               ? *reinterpret_cast<const unsigned*>(src + (size_t)row * D + col)
               : 0u;
  };
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    a[c][0] = word(ra, 16 * c + 2 * tq);
    a[c][1] = word(ra + 8, 16 * c + 2 * tq);
    a[c][2] = word(ra, 16 * c + 8 + 2 * tq);
    a[c][3] = word(ra + 8, 16 * c + 8 + 2 * tq);
  }
}

// acc (16 x 8) = A (16 x D) B^T for rows r0 .. r0 + 7 of a ring tile as the
// 8 columns of B^T: ldmatrix without .trans gives B's fragments
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[4],
                                         const unsigned (&a)[D / 16][4],
                                         const bf16* tile, int r0) {
  const int lane = threadIdx.x % 32;
  unsigned b[D / 8];
  if constexpr (D == 16) {
    unsigned r[2];
    ldmatrix_x2(r, tile + (r0 + (lane & 7)) * (D + 8) + ((lane >> 3) & 1) * 8);
    b[0] = r[0];
    b[1] = r[1];
  } else {
#pragma unroll
    for (int h = 0; h < D / 32; ++h) {
      unsigned r[4];
      ldmatrix_x4(r, tile + (r0 + (lane & 7)) * (D + 8) + 32 * h +
                         (lane >> 3) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i) b[4 * h + i] = r[i];
    }
  }
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) mma_16816(acc, a[c], b[2 * c], b[2 * c + 1]);
}

// acc (16 x D) += A (16 x 16) B for rows r0 .. r0 + 15 of a ring tile as
// B's 16 rows: ldmatrix.trans gives B's fragments, two 8-column blocks a load
template <int D>
__device__ __forceinline__ void mma_acc_trans(float (&acc)[D / 8][4],
                                              const unsigned (&a)[4],
                                              const bf16* tile, int r0) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < D / 16; ++p) {
    unsigned b[4];
    ldmatrix_x4_trans(b, tile + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                    (D + 8) +
                             (2 * p + (lane >> 4)) * 8);
    mma_16816(acc[2 * p], a, b[0], b[1]);
    mma_16816(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// the A fragment of columns 16kk .. 16kk + 15 from C fragments 2kk, 2kk + 1
__device__ __forceinline__ void c_to_a(unsigned (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// rows ra and ra + 8 of a (rows, D) output from C fragments, times mul
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[D / 8][4],
                                           int ra, int rows, float mul) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int col = 8 * db + 2 * tq;
    if (ra < rows)
      *reinterpret_cast<unsigned*>(dst + (size_t)ra * D + col) =
          pack_bf16(acc[db][0] * mul, acc[db][1] * mul);
    if (ra + 8 < rows)
      *reinterpret_cast<unsigned*>(dst + (size_t)(ra + 8) * D + col) =
          pack_bf16(acc[db][2] * mul, acc[db][3] * mul);
  }
}

// The forward's geometry, from the sweep of tools/flash_fwd_variants.py
// (PERF.md §6 records it): kFwdWarps warps a block, 16 query rows a warp,
// kFwdStages key tiles in flight, kFwdTile keys a streamed tile, of which
// kFwdChunk keys' scores sit in registers at a time.
constexpr int kFwdWarps = 4;
constexpr int kFwdStages = 2;
constexpr int kFwdTile = 128;
constexpr int kFwdChunk = 64;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdBlockRows = 16 * kFwdWarps;  // query rows a block owns
static_assert(kFwdTile % kFwdChunk == 0 && kFwdChunk % 16 == 0 &&
                  kFwdStages >= 2,
              "forward geometry");

// Forward: one block per (bh, kFwdBlockRows query rows), streaming key tiles
// (K and V); heaviest blocks first, since with causal a block's key tiles
// grow with its rows. The lane owns rows ra = w0 + lane / 4 and ra + 8 of
// its warp's 16 (h = 0, 1 below), and of each chunk of keys the columns
// 8 j + 2 (lane % 4) + {0, 1}. Per chunk of scores s (raw, or in base-2
// units with the bias added, see mul below), -inf where hidden: the row's
// running max mx takes the chunk's, O and the lane's part of the row sum
// are rescaled by 2^(mul (mx_old - mx)), P = 2^(mul s - mul mx) in one FMA
// and an ex2, O += P V. At the end O / max(l, 1e-30) with l summed over the
// quad, and lse = mul mx ln 2 + log(l) in natural log, as the backward
// reads it. A row whose every score is -inf (a bias of -inf at every key it
// sees) gets O = 0 and lse = kMasked + log(1e-30), as the 'f32' route's
// floor gives it: finite, so that the backward's P = 2^(s - lse) is 0 there
// and not inf - inf.
template <int D>
__global__ void __launch_bounds__(kFwdThreads)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ bias,
                   bf16* __restrict__ out, float* __restrict__ lse, int n,
                   int m, int q_tiles, int bias_groups, int causal,
                   float scale) {
  constexpr int LD = D + 8, TILE = kFwdTile * LD, NB = kFwdChunk / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // a stage: K tile, V tile

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * kFwdBlockRows;
  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int w0 = q0 + 16 * (threadIdx.x / 32);  // the warp's first row
  const int ra = w0 + (lane >> 2);
  const int offset = m - n;
  const bf16* kb = k + (size_t)bh * m * D;
  const bf16* vb = v + (size_t)bh * m * D;
  const bf16* bb = bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles)
  const int k_end = causal ? min(m, min(q0 + kFwdBlockRows, n) + offset) : m;
  const int tiles = (k_end + kFwdTile - 1) / kFwdTile;
  auto load = [&](int t) {
    bf16* st = ring + (t % kFwdStages) * 2 * TILE;
    async_tile<D, kFwdTile, kFwdThreads>(st, kb, t * kFwdTile, m);
    async_tile<D, kFwdTile, kFwdThreads>(st + TILE, vb, t * kFwdTile, m);
  };
#pragma unroll
  for (int t = 0; t < kFwdStages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }

  unsigned qa[D / 16][4];
  load_a<D>(qa, q + (size_t)bh * n * D, ra, n);
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  // running max (base 2) and the lane's part of l, of rows ra and ra + 8
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // The row max is taken on the raw scores and the scale folded into the
  // exponent's FMA (mul = scale log2e), unless a bias or a scale <= 0 asks
  // for the scores in base-2 units first (mul = 1).
  const float scale_log2 = scale * kLog2e;
  const bool pre = bb != nullptr || !(scale > 0.f);
  const float mul = pre ? 1.f : scale_log2;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + kFwdStages - 1 < tiles) load(t + kFwdStages - 1);
    cp_async_commit();
    const bf16* Ks = ring + (t % kFwdStages) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < kFwdTile; c0 += kFwdChunk) {
      const int k0 = t * kFwdTile + c0;
      const bool masked = tile_masked(w0, 16, k0, kFwdChunk, n, m, causal);
      float s[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_rows<D>(s[j], qa, Ks, c0 + 8 * j);
      // C element e of block j is (row ra + 8 (e / 2), key k0 + 8 j + 2 tq +
      // e % 2). Uniform branches: the bias, and the element test of a masked
      // chunk.
      if (pre)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            s[j][e] *= scale_log2;
            if (bb && row < n && col < m)
              s[j][e] =
                  fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e, s[j][e]);
          }
      if (masked)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (!(row < n && col < m && (!causal || col <= row + offset)))
              s[j][e] = -INFINITY;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          cmax = fmaxf(cmax, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        const float mnew = fmaxf(mx[h], quad_max(cmax));
        // a row that has seen no visible key yet keeps 0: no inf - inf
        const float base = mnew == -INFINITY ? 0.f : mnew * mul;
        const float alpha = exp2_approx(fmaf(mx[h], mul, -base));
        mx[h] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[j][e] = exp2_approx(fmaf(s[j][e], mul, -base));
            sum += s[j][e];
          }
        l[h] = fmaf(l[h], alpha, sum);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          o[i][2 * h] *= alpha;
          o[i][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        mma_acc_trans<D>(o, pa, Vs, c0 + 16 * kk);
      }
    }
  }

  float* lse_rows = lse + (size_t)bh * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sum = fmaxf(quad_sum(l[h]), 1e-30f);
    const float inv = 1.f / sum;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][2 * h] *= inv;
      o[i][2 * h + 1] *= inv;
    }
    const int row = ra + 8 * h;
    if (tq == 0 && row < n)
      lse_rows[row] = mx[h] == -INFINITY ? kMasked + logf(sum)
                                         : fmaf(mx[h] * mul, kLn2, logf(sum));
  }
  store_rows<D>(out + (size_t)bh * n * D, o, ra, n, 1.f);
}

// The backward's geometry: kBwdWarps warps a block, 16 output rows a warp,
// kBwdStages streamed tiles of kBwdTile rows in flight; the products take
// kDqChunk or kDkvChunk rows of a tile at a time. From the sweep of
// tools/flash_bwd_variants.py (PERF.md §6 records it). dQ *= scale and
// dK *= scale at the end. The dQ kernel writes dS (when asked) in every tile
// it visits and zeros in the key tiles it skips, so every element of dS has
// one writer.
constexpr int kBwdWarps = 4;
constexpr int kBwdStages = 2;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;     // output rows a block owns
constexpr int kBwdTile = 64;
constexpr int kDqChunk = 32;
constexpr int kDkvChunk = 16;

// 64 floats from row0 of src (rows), zeros past the last
__device__ __forceinline__ void async_rows(float* dst, const float* src,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < kBwdTile; i += kBwdThreads) {
    const bool ok = row0 + i < rows;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// dQ: one block per (bh, kBwdRows query rows), streaming key tiles.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ bias,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      float* __restrict__ dbias, int n, int m, int q_tiles,
                      int bias_groups, int causal, float scale) {
  constexpr int LD = D + 8, TILE = kBwdTile * LD, NB = kDqChunk / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // a stage: K tile, V tile

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBwdRows;
  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int ra = q0 + 16 * (threadIdx.x / 32) + (lane >> 2), rb = ra + 8;
  const int offset = m - n;
  const bf16* kb = k + (size_t)bh * m * D;
  const bf16* vb = v + (size_t)bh * m * D;
  const bf16* bb = bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
  float* dbb = dbias ? dbias + (size_t)bh * n * m : nullptr;

  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles)
  const int k_end =
      causal ? min(m, min(q0 + kBwdRows, n) - 1 + offset + 1) : m;
  const int tiles = (k_end + kBwdTile - 1) / kBwdTile;
  auto load = [&](int t) {
    bf16* st = ring + (t % kBwdStages) * 2 * TILE;
    async_tile<D, kBwdTile, kBwdThreads>(st, kb, t * kBwdTile, m);
    async_tile<D, kBwdTile, kBwdThreads>(st + TILE, vb, t * kBwdTile, m);
  };
#pragma unroll
  for (int t = 0; t < kBwdStages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }

  unsigned qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, q + (size_t)bh * n * D, ra, n);
  load_a<D>(da, dout + (size_t)bh * n * D, ra, n);
  const float* lse_rows = lse + (size_t)bh * n;
  const float* delta_rows = delta + (size_t)bh * n;
  const float lse_a = ra < n ? lse_rows[ra] * kLog2e : 0.f;
  const float lse_b = rb < n ? lse_rows[rb] * kLog2e : 0.f;
  const float del_a = ra < n ? delta_rows[ra] : 0.f;
  const float del_b = rb < n ? delta_rows[rb] : 0.f;
  const float scale_log2 = scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + kBwdStages - 1 < tiles) load(t + kBwdStages - 1);
    cp_async_commit();
    const bf16* Ks = ring + (t % kBwdStages) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = t * kBwdTile;
    const bool masked =
        tile_masked(q0, kBwdRows, k0, kBwdTile, n, m, causal);
#pragma unroll 1
    for (int c0 = 0; c0 < kBwdTile; c0 += kDqChunk) {
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mma_rows<D>(s[j], qa, Ks, c0 + 8 * j);
        mma_rows<D>(dp[j], da, Vs, c0 + 8 * j);
      }
      // s becomes dS: C element e of block j is (row e < 2 ? ra : rb,
      // key k0 + c0 + 8j + 2tq + e % 2)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          const int col = k0 + c0 + 8 * j + 2 * tq + (e & 1);
          const bool inside = row < n && col < m;
          float x = fmaf(s[j][e], scale_log2, -(e < 2 ? lse_a : lse_b));
          if (bb && inside)
            x = fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e, x);
          if (masked && !(inside && (!causal || col <= row + offset)))
            x = -INFINITY;
          const float ds =
              exp2_approx(x) * (dp[j][e] - (e < 2 ? del_a : del_b));
          s[j][e] = ds;
          if (dbb && inside) dbb[(size_t)row * m + col] = ds;
        }
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        mma_acc_trans<D>(acc, a, Ks, c0 + 16 * kk);
      }
    }
  }
  store_rows<D>(dq + (size_t)bh * n * D, acc, ra, n, scale);
  // dS of the key tiles the causal skip passed over is 0
  const int skipped = m - tiles * kBwdTile;
  if (dbb && skipped > 0)
    for (int idx = threadIdx.x; idx < kBwdRows * skipped; idx += kBwdThreads) {
      const int row = q0 + idx / skipped;
      if (row < n) dbb[(size_t)row * m + m - skipped + idx % skipped] = 0.f;
    }
}

// dK, dV: one block per (bh, kBwdRows key rows), streaming query tiles
// (q, dO, lse, delta); the products transposed so the rows stay keys.
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int n, int m, int k_tiles,
                       int bias_groups, int causal, float scale) {
  constexpr int LD = D + 8, TILE = kBwdTile * LD, NB = kDkvChunk / 8;
  // a stage: Q tile, dO tile (bf16), lse, delta (floats)
  constexpr int STAGE = 2 * TILE * (int)sizeof(bf16) + 2 * kBwdTile * 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kBwdRows;
  const int lane = threadIdx.x % 32, tq = lane & 3;
  const int kr = k0 + 16 * (threadIdx.x / 32) + (lane >> 2);
  const int offset = m - n;
  const bf16* qb = q + (size_t)bh * n * D;
  const bf16* dob = dout + (size_t)bh * n * D;
  const float* lse_rows = lse + (size_t)bh * n;
  const float* delta_rows = delta + (size_t)bh * n;
  const bf16* bb = bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  // query tiles first .. tiles - 1: with causal, from the first whose last
  // row sees the block's first key (dkv_query_tiles)
  const int first = causal ? max(0, k0 - offset) / kBwdTile : 0;
  const int tiles = (n + kBwdTile - 1) / kBwdTile;
  auto stage = [&](int t) {
    return smem_raw + ((t - first) % kBwdStages) * STAGE;
  };
  auto load = [&](int t) {
    bf16* st = reinterpret_cast<bf16*>(stage(t));
    float* rows = reinterpret_cast<float*>(st + 2 * TILE);
    async_tile<D, kBwdTile, kBwdThreads>(st, qb, t * kBwdTile, n);
    async_tile<D, kBwdTile, kBwdThreads>(st + TILE, dob, t * kBwdTile, n);
    async_rows(rows, lse_rows, t * kBwdTile, n);
    async_rows(rows + kBwdTile, delta_rows, t * kBwdTile, n);
  };
#pragma unroll
  for (int t = 0; t < kBwdStages - 1; ++t) {
    if (first + t < tiles) load(first + t);
    cp_async_commit();
  }

  unsigned ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + (size_t)bh * m * D, kr, m);
  load_a<D>(va, v + (size_t)bh * m * D, kr, m);
  const float scale_log2 = scale * kLog2e;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int t = first; t < tiles; ++t) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + kBwdStages - 1 < tiles) load(t + kBwdStages - 1);
    cp_async_commit();
    const bf16* Qs = reinterpret_cast<const bf16*>(stage(t));
    const bf16* dOs = Qs + TILE;
    const float* lse_s = reinterpret_cast<const float*>(Qs + 2 * TILE);
    const float* delta_s = lse_s + kBwdTile;
    const int q0 = t * kBwdTile;
    const bool masked =
        tile_masked(q0, kBwdTile, k0, kBwdRows, n, m, causal);
#pragma unroll 1
    for (int c0 = 0; c0 < kBwdTile; c0 += kDkvChunk) {
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mma_rows<D>(s[j], ka, Qs, c0 + 8 * j);
        mma_rows<D>(dp[j], va, dOs, c0 + 8 * j);
      }
      // s becomes P^T and dp dS^T: C element e of block j is (key e < 2 ?
      // kr : kr + 8, query q0 + c), c = c0 + 8j + 2tq + e % 2
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? kr : kr + 8;
          const int c = c0 + 8 * j + 2 * tq + (e & 1), row = q0 + c;
          const bool inside = row < n && key < m;
          float x = fmaf(s[j][e], scale_log2, -lse_s[c] * kLog2e);
          if (bb && inside)
            x = fmaf(to_f32(bb[(size_t)row * m + key]), kLog2e, x);
          if (masked && !(inside && (!causal || key <= row + offset)))
            x = -INFINITY;
          const float p = exp2_approx(x);
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[c]);
        }
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned a[4];
        c_to_a(a, s[2 * kk], s[2 * kk + 1]);
        mma_acc_trans<D>(dv_acc, a, dOs, c0 + 16 * kk);
        c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
        mma_acc_trans<D>(dk_acc, a, Qs, c0 + 16 * kk);
      }
    }
  }
  store_rows<D>(dk + (size_t)bh * m * D, dk_acc, kr, m, scale);
  store_rows<D>(dv + (size_t)bh * m * D, dv_acc, kr, m, 1.f);
}

inline int tiles_of(int rows, int tile) { return (rows + tile - 1) / tile; }

// Blocks above 48 KB of shared memory need the attribute; set it always.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool grid_fits(int bh, int tiles) {
  return bh > 0 && tiles > 0 && (long long)bh * tiles <= 2147483647LL;
}

// the 'f32' route
template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* out, float* lse, int bh, int n,
                       int m, int groups, int causal, float scale,
                       cudaStream_t stream) {
  const int tiles = tiles_of(n, kTile);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<D>(3, 1, 0);
  cudaError_t err = allow_smem(fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, lse, n, m, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const float* lse,
                      const float* delta, void* dq, float* dbias, int bh,
                      int n, int m, int groups, int causal, float scale,
                      cudaStream_t stream) {
  const int tiles = tiles_of(n, kTile);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<D>(4, 1, 2);
  cudaError_t err = allow_smem(bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)dout, lse, delta, (float*)dq, dbias, n, m, tiles, groups,
      causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int n,
                       int m, int groups, int causal, float scale,
                       cudaStream_t stream) {
  const int tiles = tiles_of(m, kTile);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<D>(4, 2, 2);
  cudaError_t err = allow_smem(bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)dout, lse, delta, (float*)dk, (float*)dv, n, m, tiles,
      groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the 'mma' route
template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           const void* bias, void* out, float* lse, int bh,
                           int n, int m, int groups, int causal, float scale,
                           cudaStream_t stream) {
  const int tiles = tiles_of(n, kFwdBlockRows);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = kFwdStages * 2 * sizeof(bf16) * kFwdTile * (D + 8);
  cudaError_t err = allow_smem(fwd_mma_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  fwd_mma_kernel<D><<<(unsigned)(bh * tiles), kFwdThreads, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (bf16*)out, lse, n, m, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* bias, const void* dout,
                          const float* lse, const float* delta, void* dq,
                          float* dbias, int bh, int n, int m, int groups,
                          int causal, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(n, kBwdRows);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = kBwdStages * 2 * sizeof(bf16) * kBwdTile * (D + 8);
  cudaError_t err = allow_smem(bwd_dq_mma_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dq_mma_kernel<D><<<(unsigned)(bh * tiles), kBwdThreads, bytes,
                         stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (const bf16*)dout, lse, delta, (bf16*)dq, dbias, n, m, tiles, groups,
      causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* bias, const void* dout,
                           const float* lse, const float* delta, void* dk,
                           void* dv, int bh, int n, int m, int groups,
                           int causal, float scale, cudaStream_t stream) {
  const int tiles = tiles_of(m, kBwdRows);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = kBwdStages * (2 * sizeof(bf16) * kBwdTile * (D + 8) +
                                     2 * sizeof(float) * kBwdTile);
  cudaError_t err = allow_smem(bwd_dkv_mma_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dkv_mma_kernel<D><<<(unsigned)(bh * tiles), kBwdThreads, bytes,
                          stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
      (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv, n, m, tiles,
      groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the 'mma' kernels by number: 0 dQ, 1 dK/dV, 2 forward
template <int D>
cudaError_t mma_attributes(cudaFuncAttributes* a, int kernel) {
  if (kernel == 0) return cudaFuncGetAttributes(a, bwd_dq_mma_kernel<D>);
  if (kernel == 1) return cudaFuncGetAttributes(a, bwd_dkv_mma_kernel<D>);
  if (kernel == 2) return cudaFuncGetAttributes(a, fwd_mma_kernel<D>);
  return cudaErrorInvalidValue;
}

inline bool route_fits(int route, int dtype) {
  return (route == kRouteMma && dtype == kBFloat16) ||
         (route == kRouteF32 && dtype == kFloat32);
}

}  // namespace flash
}  // namespace mv2

// F32<D>(args) for float32 or MMA<D>(args) for bf16, at the head size given,
// once route_fits(route, dtype) holds; any other combination is
// cudaErrorInvalidValue.
#define MV2_FLASH_DISPATCH(F32, MMA, ...)                              \
  do {                                                                 \
    if (!mv2::flash::route_fits(route, dtype)) return cudaErrorInvalidValue; \
    if (dtype == mv2::kFloat32) {                                      \
      if (d == 16) return F32<16>(__VA_ARGS__);                        \
      if (d == 32) return F32<32>(__VA_ARGS__);                        \
      if (d == 64) return F32<64>(__VA_ARGS__);                        \
    } else {                                                           \
      if (d == 16) return MMA<16>(__VA_ARGS__);                        \
      if (d == 32) return MMA<32>(__VA_ARGS__);                        \
      if (d == 64) return MMA<64>(__VA_ARGS__);                        \
    }                                                                  \
    return cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" {

// q (bh, n, d), k and v (bh, m, d), bias (groups, n, m) or null, all of
// `dtype`; out (bh, n, d) of `dtype`, lse (bh, n) float32 in natural log.
// route is the wrapper's (Route) and must fit the dtype: kRouteMma bf16,
// kRouteF32 float32.
int mv2_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* lse, int dtype,
                            int bh, int n, int m, int d, int groups,
                            int causal, float scale, int route,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MV2_FLASH_DISPATCH(mv2::flash::launch_fwd, mv2::flash::launch_fwd_mma, q, k,
                     v, bias, out, (float*)lse, bh, n, m, groups, causal,
                     scale, s);
}

// dout (bh, n, d); lse and delta = rowsum(dout * out), (bh, n) float32;
// dq (bh, n, d); dbias (bh, n, m) float32 or null; route as for the forward.
int mv2_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               void* dbias, int dtype, int bh, int n, int m,
                               int d, int groups, int causal, float scale,
                               int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MV2_FLASH_DISPATCH(mv2::flash::launch_dq, mv2::flash::launch_dq_mma, q, k,
                     v, bias, dout, (const float*)lse, (const float*)delta,
                     dq, (float*)dbias, bh, n, m, groups, causal, scale, s);
}

// dk and dv (bh, m, d); route as for the forward.
int mv2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int dtype, int bh, int n, int m,
                                int d, int groups, int causal, float scale,
                                int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MV2_FLASH_DISPATCH(mv2::flash::launch_dkv, mv2::flash::launch_dkv_mma, q,
                     k, v, bias, dout, (const float*)lse, (const float*)delta,
                     dk, dv, bh, n, m, groups, causal, scale, s);
}

// What the CUDA runtime reports for the 'mma' kernel `kernel` (0 dQ, 1
// dK/dV, 2 forward) at head size d, into out (4 ints): registers a thread,
// local memory a thread (spills), static shared memory, and the dynamic
// shared memory its launcher last set (allow_smem sets it on every launch).
int mv2_flash_mma_attributes(int kernel, int d, void* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      d == 16   ? mv2::flash::mma_attributes<16>(&a, kernel)
      : d == 32 ? mv2::flash::mma_attributes<32>(&a, kernel)
      : d == 64 ? mv2::flash::mma_attributes<64>(&a, kernel)
                : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  o[2] = (int)a.sharedSizeBytes;
  o[3] = a.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

}  // extern "C"
