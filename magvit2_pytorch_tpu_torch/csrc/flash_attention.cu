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
// and, with causal, keys > row + (m - n) score -1e30 (the mask is
// right-aligned: the m - n keys in front are visible to every query).
// bias, when given, is (groups, n, m) with groups in {1, h, b h}; program
// bh reads slice bh % groups, so a broadcast bias is never materialised.
//
// Design of the forward and of the float32 backward (the 'f32' route): one
// block of four warps owns 64 rows of its output (query rows for the
// forward and dQ, key rows for dK/dV) and loops over 64-wide tiles of the
// other dimension staged in shared memory; each warp owns 16 of the rows
// for every product and every row statistic, so warps only meet at the
// tile loads, and every output tile has one owner: no atomics, the same
// sums in the same order on every run. The forward's products run on the
// tensor cores for bf16 (WMMA, float32 accumulators kept in shared memory
// so it can rescale its rows) and on the CUDA cores for float32 (no TF32).
// Running max, sum, lse, P and dS are float32; P and dS are rounded to the
// working dtype only as operands of the next product.
//
// The bf16 backward (the 'mma' route, ops/kernels/flash_attention.py
// flash_bwd_route, which passes the route in) has kernels of its own below:
// mma.sync with register accumulators, a cp.async ring and the causal tile
// skip; the same ownership, so it is as deterministic.
//
// What bounds it on the H100: operations. At the flagship's space stage at
// 512 px (bh = 136, n = 4096, m = 4100, D = 32, bf16) the forward is
// 4 bh n m D = 292 GFLOP (0.30 ms at 989 TFLOP/s) against 143 MB of q, k,
// v, o (0.04 ms at 3.35 TB/s); dQ does 6 bh n m D and dK/dV 8 bh n m D
// (each recomputes S), 0.44 and 0.59 ms. At D = 32 the exp of every pair
// (twice: once in each kernel) and the elementwise dS work on the CUDA
// cores weigh as much as the products.
#include "common.cuh"

namespace mv2 {
namespace flash {

constexpr int kTile = 64;      // rows a block owns; width of a streamed tile
constexpr int kRows = 16;      // rows a warp owns
constexpr int kThreads = 128;  // four warps
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// the backward's routes (ops/kernels/flash_attention.py BWD_ROUTES); each
// takes one dtype
enum BwdRoute { kBwdF32 = 0, kBwdMma = 1 };

// Row strides in shared memory, in elements. bf16: multiples of 8 (and of 4
// for the float tiles) as WMMA needs, off a multiple of 32 banks. float32:
// odd, so a warp reading one column of 32 rows hits 32 banks.
template <typename T, int D>
struct Cfg;
template <int D>
struct Cfg<float, D> {
  static constexpr int ldt = D + 1;      // (64, D) tile of T
  static constexpr int ldp = kTile + 1;  // (64, 64) tile of T: P or dS
  static constexpr int lds = kTile + 1;  // (64, 64) float tile: S or dP
  static constexpr int lda = D + 1;      // (64, D) float accumulator
  // first column of the forward's softmax lane (row, half), see fwd_kernel
  static __device__ __forceinline__ int rot(int row, int half) {
    return 16 * half;
  }
};
template <int D>
struct Cfg<bf16, D> {
  static constexpr int ldt = D + 8;
  static constexpr int ldp = kTile + 8;
  static constexpr int lds = kTile + 4;
  static constexpr int lda = D + 4;
  static __device__ __forceinline__ int rot(int row, int half) {
    return 2 * (row / 8) + half;
  }
};

__host__ __device__ constexpr size_t align_up(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

template <typename U>
__device__ __forceinline__ U* carve(unsigned char*& p, int count) {
  U* out = reinterpret_cast<U*>(p);
  p += align_up(sizeof(U) * count);
  return out;
}

// bytes of `tiles` (64, D) T tiles, `accs` float accumulators, one S and
// one P tile and `vectors` 64-float row vectors
template <typename T, int D>
constexpr size_t smem_bytes(int tiles, int accs, int vectors) {
  typedef Cfg<T, D> C;
  return tiles * align_up(sizeof(T) * kTile * C::ldt) +
         accs * align_up(sizeof(float) * kTile * C::lda) +
         align_up(sizeof(float) * kTile * C::lds) +
         align_up(sizeof(T) * kTile * C::ldp) +
         vectors * align_up(sizeof(float) * kTile);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

// bf16: 16-byte loads of 8 values (D % 8 == 0, src 16-byte aligned)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          int row0, int rows) {
  constexpr int V = D / 8;
  for (int idx = threadIdx.x; idx < kTile * V; idx += kThreads) {
    const int r = idx / V, e = (idx % V) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + e) =
        row0 + r < rows
            ? *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + e)
            : make_uint4(0, 0, 0, 0);
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
// memory: with BT, B is (N, K) and op(B) = B^T; else B is (K, N).
// float32 on the CUDA cores: lane l owns columns l and l + 32.
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

// B^T is the column-major (k, n) tile whose element (k, n) is B[n][k].
template <bool BT>
struct BLayout {
  typedef nvcuda::wmma::col_major type;
};
template <>
struct BLayout<false> {
  typedef nvcuda::wmma::row_major type;
};

// bf16 on the tensor cores: 16x16x16 fragments, float32 accumulators loaded
// from and stored to shared memory.
template <int N, int K, bool ACC, bool BT>
__device__ __forceinline__ void warp_mma(const bf16* A, int lda,
                                         const bf16* B, int ldb, float* C,
                                         int ldc) {
  using namespace nvcuda;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[K / 16];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wmma::load_matrix_sync(a[kk], A + 16 * kk, lda);
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (ACC)
      wmma::load_matrix_sync(c, C + n0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                     typename BLayout<BT>::type> b;
      wmma::load_matrix_sync(
          b, BT ? B + n0 * ldb + 16 * kk : B + 16 * kk * ldb + n0, ldb);
      wmma::mma_sync(c, a[kk], b, c);
    }
    wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
  }
}

// C = A B^T and C += A B, as the kernels below use them
template <int N, int K, typename T>
__device__ __forceinline__ void warp_mma_nt(const T* A, int lda, const T* B,
                                            int ldb, float* C, int ldc) {
  warp_mma<N, K, false, true>(A, lda, B, ldb, C, ldc);
}

template <int N, int K, typename T>
__device__ __forceinline__ void warp_acc_nn(const T* A, int lda, const T* B,
                                            int ldb, float* C, int ldc) {
  warp_mma<N, K, true, false>(A, lda, B, ldb, C, ldc);
}

// Forward: one block per (bh, 64 query rows). Per key tile and warp:
// S = Q K^T; then lane (row, half) of the warp owns 32 columns of one of its
// 16 rows: it updates the row's running max m and sum l (in registers, one
// shuffle with the lane of the other half), writes P = exp(S - m) and
// rescales its half of the row of O by exp(m_old - m_new); then O += P V.
// The lane walks its 32 columns starting at Cfg::rot, so that the 32 lanes
// of a warp read 32 different banks of S. At the end O / max(l, 1e-30) and
// lse = m + log(l).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ bias,
               T* __restrict__ out, float* __restrict__ lse, int n, int m,
               int q_tiles, int bias_groups, int causal, float scale) {
  typedef Cfg<T, D> C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  T* Qs = carve<T>(sp, kTile * C::ldt);
  T* Ks = carve<T>(sp, kTile * C::ldt);
  T* Vs = carve<T>(sp, kTile * C::ldt);
  float* Of = carve<float>(sp, kTile * C::lda);
  float* Sf = carve<float>(sp, kTile * C::lds);
  T* Pt = carve<T>(sp, kTile * C::ldp);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int half = lane & 1, srow = r0 + (lane >> 1);  // the lane's row
  const int row = q0 + srow, rot = C::rot(lane >> 1, half);
  const int offset = m - n;
  const T* kb = k + (size_t)bh * m * D;
  const T* vb = v + (size_t)bh * m * D;
  const T* bb =
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
      if (bb && row < n && col < m) x += to_f32(bb[(size_t)row * m + col]);
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
      Pt[srow * C::ldp + c] = from_f32<T>(p);
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
    T* orow = out + ((size_t)bh * n + row) * D + half * (D / 2);
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      orow[e] = from_f32<T>(Of[srow * C::lda + half * (D / 2) + e] * inv);
    if (half == 0) lse[(size_t)bh * n + row] = m_run + logf(l);
  }
}

// The float32 backward (the 'f32' route), on the CUDA cores.
// dQ: one block per (bh, 64 query rows). Per key tile and warp:
// P = exp(S - lse) on the visible keys, dP = dO V^T, dS = P (dP - delta),
// dQ += dS K; dS also goes to dbias (bh, n, m) when asked. dQ *= scale.
template <int D, typename T = float>
__global__ void __launch_bounds__(kThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ bias,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  float* __restrict__ dbias, int n, int m, int q_tiles,
                  int bias_groups, int causal, float scale) {
  typedef Cfg<T, D> C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  T* Qs = carve<T>(sp, kTile * C::ldt);
  T* dOs = carve<T>(sp, kTile * C::ldt);
  T* Ks = carve<T>(sp, kTile * C::ldt);
  T* Vs = carve<T>(sp, kTile * C::ldt);
  float* dQf = carve<float>(sp, kTile * C::lda);
  float* Sf = carve<float>(sp, kTile * C::lds);
  T* Pt = carve<T>(sp, kTile * C::ldp);
  float* lse_s = carve<float>(sp, kTile);
  float* delta_s = carve<float>(sp, kTile);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int offset = m - n;
  const T* kb = k + (size_t)bh * m * D;
  const T* vb = v + (size_t)bh * m * D;
  const T* bb =
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
        if (bb && row < n && col < m) x += to_f32(bb[(size_t)row * m + col]);
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
        Pt[(r0 + r) * C::ldp + c] = from_f32<T>(ds);
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
    T* drow = dq + ((size_t)bh * n + row) * D;
    for (int e = lane; e < D; e += 32)
      drow[e] = from_f32<T>(dQf[(r0 + r) * C::lda + e] * scale);
  }
}

// dK, dV: one block per (bh, 64 key rows), each warp 16 keys. Per query
// tile the products are formed transposed, so the warp's rows stay keys:
// S^T = K Q^T, P^T = exp(S^T - lse[query]), dV += P^T dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - delta[query]), dK += dS^T Q. dK *= scale.
template <int D, typename T = float>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ bias,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int n, int m, int k_tiles,
                   int bias_groups, int causal, float scale) {
  typedef Cfg<T, D> C;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  T* Ks = carve<T>(sp, kTile * C::ldt);
  T* Vs = carve<T>(sp, kTile * C::ldt);
  T* Qs = carve<T>(sp, kTile * C::ldt);
  T* dOs = carve<T>(sp, kTile * C::ldt);
  float* dKf = carve<float>(sp, kTile * C::lda);
  float* dVf = carve<float>(sp, kTile * C::lda);
  float* Sf = carve<float>(sp, kTile * C::lds);
  T* Pt = carve<T>(sp, kTile * C::ldp);
  float* lse_s = carve<float>(sp, kTile);
  float* delta_s = carve<float>(sp, kTile);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int offset = m - n;
  const T* qb = q + (size_t)bh * n * D;
  const T* dob = dout + (size_t)bh * n * D;
  const T* bb =
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
        if (bb && row < n && key < m) x += to_f32(bb[(size_t)row * m + key]);
        const bool ok =
            row < n && key < m && (!causal || key <= row + offset);
        p[r][j] = ok ? expf(x - lse_s[c]) : 0.f;
        Pt[(r0 + r) * C::ldp + c] = from_f32<T>(p[r][j]);
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
        Pt[(r0 + r) * C::ldp + c] = from_f32<T>(
            p[r][j] * (Sf[(r0 + r) * C::lds + c] - delta_s[c]));
      }
    __syncwarp();
    warp_acc_nn<D, kTile>(Pt + r0 * C::ldp, C::ldp, Qs, C::ldt,
                                dKf + r0 * C::lda, C::lda);
    __syncwarp();
  }

  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + r0 + r;
    if (key >= m) break;
    T* krow = dk + ((size_t)bh * m + key) * D;
    T* vrow = dv + ((size_t)bh * m + key) * D;
    for (int e = lane; e < D; e += 32) {
      krow[e] = from_f32<T>(dKf[(r0 + r) * C::lda + e] * scale);
      vrow[e] = from_f32<T>(dVf[(r0 + r) * C::lda + e]);
    }
  }
}

// ---- the bf16 backward on the tensor cores (the 'mma' route) --------------
//
// Two kernels, each one block of kBwdWarps warps that owns 16 rows a warp of
// its output (query rows for dQ, key rows for dK/dV) and streams 64-row tiles
// of the other side through a ring of kBwdStages stages in shared memory,
// filled by cp.async (zero-filled past the last row) so that tile j + 1
// loads while tile j runs its products, kDqChunk or kDkvChunk rows of it at
// a time (the fewer, the fewer registers). Every product is mma.sync
// m16n8k16 on bf16 with float32 accumulators in registers:
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
// A C fragment's columns are the reduction dimension of the next product
// (keys for dQ, queries for dK/dV), so P and dS go from one product's
// accumulators to the next one's A operand in registers, rounded to bf16
// there and only there; nothing but the streamed tiles touches shared
// memory. Rows are padded from D to D + 8 bf16, so the 8 rows an ldmatrix
// phase reads fall in 8 different bank groups.
//
// The causal skip (ops/kernels/flash_attention.py dq_key_tiles,
// dkv_query_tiles and tile_masked are its Python twin): the dQ loop ends at
// the last key tile its block's last row sees, the dK/dV loop starts at the
// first query tile whose last row sees the block's first key; only a tile
// that crosses the diagonal or a ragged edge (rows >= n, keys >= m) tests
// each element, and a hidden pair's exponent is -inf, so P = 0 before any
// use. No branch sits around an ldmatrix or mma. dQ *= scale and
// dK *= scale at the end; no atomics, one owner per output tile. The dQ
// kernel writes dS (when asked) in every tile it visits and zeros in the
// key tiles it skips, so every element of dS has one writer.
constexpr int kBwdWarps = 4;                 // warps a block: 16 rows each
constexpr int kBwdStages = 2;                // streamed tiles in flight
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;     // output rows a block owns
constexpr int kBwdTile = 64;                 // rows of a streamed tile
// rows of a streamed tile the products take at a time, from the sweep of
// tools/flash_bwd_variants.py (PERF.md §6 records it)
constexpr int kDqChunk = 32;
constexpr int kDkvChunk = 16;

// tile (q0 .. q0 + nq - 1) x (k0 .. k0 + nk - 1) has a pair to mask: a ragged
// edge, or with causal a key past the diagonal of its first row
__device__ __forceinline__ bool tile_masked(int q0, int nq, int k0, int nk,
                                            int n, int m, int causal) {
  return q0 + nq > n || k0 + nk > m || (causal && k0 + nk - 1 > q0 + m - n);
}

// 64 rows from row0 of src (rows, D) into a ring tile with rows of D + 8,
// zeros past the last row
template <int D>
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src,
                                           int row0, int rows) {
  constexpr int V = D / 8;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < kBwdTile * V; idx += kBwdThreads) {
    const int r = idx / V, e = (idx % V) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * (D + 8) + e, src + (size_t)(ok ? row0 + r : 0) * D + e,
               ok);
  }
}

// 64 floats from row0 of src (rows), zeros past the last
__device__ __forceinline__ void async_rows(float* dst, const float* src,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < kBwdTile; i += kBwdThreads) {
    const bool ok = row0 + i < rows;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
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
    async_tile<D>(st, kb, t * kBwdTile, m);
    async_tile<D>(st + TILE, vb, t * kBwdTile, m);
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
    async_tile<D>(st, qb, t * kBwdTile, n);
    async_tile<D>(st + TILE, dob, t * kBwdTile, n);
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

inline int tiles_of(int rows) { return (rows + kTile - 1) / kTile; }

// Blocks above 48 KB of shared memory need the attribute; set it always.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline bool grid_fits(int bh, int tiles) {
  return bh > 0 && tiles > 0 && (long long)bh * tiles <= 2147483647LL;
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* out, float* lse, int bh, int n,
                       int m, int groups, int causal, float scale,
                       cudaStream_t stream) {
  const int tiles = tiles_of(n);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T, D>(3, 1, 0);
  cudaError_t err = allow_smem(fwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  fwd_kernel<T, D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (T*)out, lse, n,
      m, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the 'f32' route (T is float)
template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const float* lse,
                      const float* delta, void* dq, float* dbias, int bh,
                      int n, int m, int groups, int causal, float scale,
                      cudaStream_t stream) {
  const int tiles = tiles_of(n);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T, D>(4, 1, 2);
  cudaError_t err = allow_smem(bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (const T*)dout,
      lse, delta, (T*)dq, dbias, n, m, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int n,
                       int m, int groups, int causal, float scale,
                       cudaStream_t stream) {
  const int tiles = tiles_of(m);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T, D>(4, 2, 2);
  cudaError_t err = allow_smem(bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (const T*)dout,
      lse, delta, (T*)dk, (T*)dv, n, m, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the 'mma' route (T is bf16)
template <typename T, int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* bias, const void* dout,
                          const float* lse, const float* delta, void* dq,
                          float* dbias, int bh, int n, int m, int groups,
                          int causal, float scale, cudaStream_t stream) {
  const int tiles = (n + kBwdRows - 1) / kBwdRows;
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

template <typename T, int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* bias, const void* dout,
                           const float* lse, const float* delta, void* dk,
                           void* dv, int bh, int n, int m, int groups,
                           int causal, float scale, cudaStream_t stream) {
  const int tiles = (m + kBwdRows - 1) / kBwdRows;
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

template <int D>
cudaError_t mma_attributes(cudaFuncAttributes* a, int kernel) {
  if (kernel == 0) return cudaFuncGetAttributes(a, bwd_dq_mma_kernel<D>);
  if (kernel == 1) return cudaFuncGetAttributes(a, bwd_dkv_mma_kernel<D>);
  return cudaErrorInvalidValue;
}

inline bool route_fits(int route, int dtype) {
  return (route == kBwdMma && dtype == kBFloat16) ||
         (route == kBwdF32 && dtype == kFloat32);
}

}  // namespace flash
}  // namespace mv2

// F32<float, D>(args) or BF16<bf16, D>(args) for the dtype code and head
// size given; any other combination is cudaErrorInvalidValue.
#define MV2_FLASH_DISPATCH(F32, BF16, ...)                          \
  do {                                                              \
    if (dtype == mv2::kFloat32) {                                   \
      if (d == 16) return F32<float, 16>(__VA_ARGS__);              \
      if (d == 32) return F32<float, 32>(__VA_ARGS__);              \
      if (d == 64) return F32<float, 64>(__VA_ARGS__);              \
    } else if (dtype == mv2::kBFloat16) {                           \
      if (d == 16) return BF16<mv2::bf16, 16>(__VA_ARGS__);         \
      if (d == 32) return BF16<mv2::bf16, 32>(__VA_ARGS__);         \
      if (d == 64) return BF16<mv2::bf16, 64>(__VA_ARGS__);         \
    }                                                               \
    return cudaErrorInvalidValue;                                   \
  } while (0)

extern "C" {

// q (bh, n, d), k and v (bh, m, d), bias (groups, n, m) or null, all of
// `dtype`; out (bh, n, d) of `dtype`, lse (bh, n) float32.
int mv2_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* lse, int dtype,
                            int bh, int n, int m, int d, int groups,
                            int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MV2_FLASH_DISPATCH(mv2::flash::launch_fwd, mv2::flash::launch_fwd, q, k, v,
                     bias, out, (float*)lse, bh, n, m, groups, causal, scale,
                     s);
}

// dout (bh, n, d); lse and delta = rowsum(dout * out), (bh, n) float32;
// dq (bh, n, d); dbias (bh, n, m) float32 or null. route is the wrapper's
// (BwdRoute) and must fit the dtype: kBwdMma bf16, kBwdF32 float32.
int mv2_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               void* dbias, int dtype, int bh, int n, int m,
                               int d, int groups, int causal, float scale,
                               int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mv2::flash::route_fits(route, dtype)) return cudaErrorInvalidValue;
  MV2_FLASH_DISPATCH(mv2::flash::launch_dq, mv2::flash::launch_dq_mma, q, k,
                     v, bias, dout, (const float*)lse, (const float*)delta,
                     dq, (float*)dbias, bh, n, m, groups, causal, scale, s);
}

// dk and dv (bh, m, d); route as for dQ.
int mv2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int dtype, int bh, int n, int m,
                                int d, int groups, int causal, float scale,
                                int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mv2::flash::route_fits(route, dtype)) return cudaErrorInvalidValue;
  MV2_FLASH_DISPATCH(mv2::flash::launch_dkv, mv2::flash::launch_dkv_mma, q,
                     k, v, bias, dout, (const float*)lse, (const float*)delta,
                     dk, dv, bh, n, m, groups, causal, scale, s);
}

// What the CUDA runtime reports for the 'mma' backward kernel `kernel`
// (0 dQ, 1 dK/dV) at head size d, into out (4 ints): registers a thread,
// local memory a thread (spills), static shared memory, and the dynamic
// shared memory its launcher last set (allow_smem sets it on every launch).
int mv2_flash_bwd_mma_attributes(int kernel, int d, void* out) {
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
