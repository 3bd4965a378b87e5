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
// Design: one block of four warps owns 64 rows of its output (query rows
// for the forward and dQ, key rows for dK/dV) and loops over 64-wide tiles
// of the other dimension staged in shared memory; each warp owns 16 of the
// rows for every product and every row statistic, so warps only meet at
// the tile loads, and every output tile has one owner: no atomics, the
// same sums in the same order on every run. The products run on the tensor
// cores for bf16 (WMMA mma.sync, float32 accumulators kept in shared memory
// so the forward can rescale its rows) and on the CUDA cores for float32
// (no TF32). Running max, sum, lse, P and dS are float32; P and dS are
// rounded to the working dtype only as operands of the next product.
//
// What bounds it on the H100: operations. At the flagship's space stage at
// 512 px (bh = 136, n = 4096, m = 4100, D = 32, bf16) the forward is
// 4 bh n m D = 292 GFLOP (0.30 ms at 989 TFLOP/s) against 143 MB of q, k,
// v, o (0.04 ms at 3.35 TB/s); dQ does 6 bh n m D and dK/dV 8 bh n m D
// (each recomputes S). This first version is far from that bound: wgmma,
// TMA, register accumulators, warp specialisation and skipping the key
// tiles a causal mask hides are later work.
#include "common.cuh"

namespace mv2 {
namespace flash {

constexpr int kTile = 64;      // rows a block owns; width of a streamed tile
constexpr int kRows = 16;      // rows a warp owns
constexpr int kThreads = 128;  // four warps
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// dQ: one block per (bh, 64 query rows). Per key tile and warp:
// P = exp(S - lse) on the visible keys, dP = dO V^T, dS = P (dP - delta),
// dQ += dS K; dS also goes to dbias (bh, n, m) when asked. dQ *= scale.
template <typename T, int D>
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
template <typename T, int D>
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

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const float* lse,
                      const float* delta, void* dq, float* dbias, int bh,
                      int n, int m, int groups, int causal, float scale,
                      cudaStream_t stream) {
  const int tiles = tiles_of(n);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T, D>(4, 1, 2);
  cudaError_t err = allow_smem(bwd_dq_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
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
  cudaError_t err = allow_smem(bwd_dkv_kernel<T, D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<T, D><<<(unsigned)(bh * tiles), kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)bias, (const T*)dout,
      lse, delta, (T*)dk, (T*)dv, n, m, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

}  // namespace flash
}  // namespace mv2

// LAUNCH<T, D>(args) for the dtype code and head size given; any other
// combination is cudaErrorInvalidValue.
#define MV2_FLASH_DISPATCH(LAUNCH, ...)                             \
  do {                                                              \
    if (dtype == mv2::kFloat32) {                                   \
      if (d == 16) return LAUNCH<float, 16>(__VA_ARGS__);           \
      if (d == 32) return LAUNCH<float, 32>(__VA_ARGS__);           \
      if (d == 64) return LAUNCH<float, 64>(__VA_ARGS__);           \
    } else if (dtype == mv2::kBFloat16) {                           \
      if (d == 16) return LAUNCH<mv2::bf16, 16>(__VA_ARGS__);       \
      if (d == 32) return LAUNCH<mv2::bf16, 32>(__VA_ARGS__);       \
      if (d == 64) return LAUNCH<mv2::bf16, 64>(__VA_ARGS__);       \
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
  MV2_FLASH_DISPATCH(mv2::flash::launch_fwd, q, k, v, bias, out, (float*)lse,
                     bh, n, m, groups, causal, scale, s);
}

// dout (bh, n, d); lse and delta = rowsum(dout * out), (bh, n) float32;
// dq (bh, n, d); dbias (bh, n, m) float32 or null.
int mv2_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               void* dbias, int dtype, int bh, int n, int m,
                               int d, int groups, int causal, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MV2_FLASH_DISPATCH(mv2::flash::launch_dq, q, k, v, bias, dout,
                     (const float*)lse, (const float*)delta, dq,
                     (float*)dbias, bh, n, m, groups, causal, scale, s);
}

// dk and dv (bh, m, d).
int mv2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int dtype, int bh, int n, int m,
                                int d, int groups, int causal, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MV2_FLASH_DISPATCH(mv2::flash::launch_dkv, q, k, v, bias, dout,
                     (const float*)lse, (const float*)delta, dk, dv, bh, n, m,
                     groups, causal, scale, s);
}

}  // extern "C"
