// Flash attention with a backward pass: softmax(scale Q K^T + bias) V over
// key tiles with an online softmax, so the (n, m) score matrix never exists
// in device memory in either direction. Replaces the three TPU kernels of
// magvit2_pytorch_tpu/ops/pallas/flash_attention.py: _flash_kernel (forward,
// also the per-row logsumexp), _bwd_dq_kernel (dQ, and dS as d_bias when
// there is a bias) and _bwd_dkv_kernel (dK, dV). See
// ops/kernels/flash_attention.py for the wrapper and the plain versions.
//
// q (bh, n, d), k and v (bh, m, d), any n, m >= 1, read in place: no padded
// copies, the ragged last tile is predicated (key < m, row < n). Keys >= m
// and, with causal, keys > row + (m - n) are hidden (the mask is
// right-aligned: with m > n the m - n keys in front are visible to every
// query). With causal and m < n the first n - m rows see no key; each gets
// what the plain attend's uniform softmax over m masked scores gives it:
// out = the mean of v, lse = -1e30 (kMasked + log m), dq = 0, no dS, no dK
// term, and dV_j gains dO_row / m (the forward and dK/dV kernels sum those
// columns, column_sum). bias, when given, is (groups, n, m) with groups in
// {1, h, b h}; program bh reads slice bh % groups, so a broadcast bias is
// never materialised.
//
// Head sizes: any multiple of 8 (the wrapper pads any other d up to one with
// zero columns), as the JAX kernel takes any head. Up to 256 each kernel is
// built at the padded widths
// D = 16, 32, 64, 128 and 256 (head_width): the 'f32' kernels and the
// 'mma' route's padded kernels (*_padded_kernel: d < D; above 64 the
// Hopper kernels at every d) take the true d at run time: the
// columns past d are zeros in shared memory (cp.async's or TMA's zero fill)
// and in registers, so they add nothing to a score or a product, and the
// output columns past d are not stored. A head of d = 96 thus does the products of 128 (4/3 of the
// work), d = 160 those of 256 (8/5). The 'mma' kernels at d == D <= 64 are
// built apart with d a constant, so the widths 16, 32 and 64 compile as
// before the run-time d. A head over 256 takes the wide kernels (see "heads
// over 256" below): its output in column chunks of 256, one a block, its
// scores summed over column slices; on the 'mma' route a head of 257 to 512
// runs its three kernels on the Hopper wide kernels instead (see "heads of
// 257 to 512"), two warpgroups splitting its output columns, and a head of
// 513 to 1024 its three kernels on two such blocks in a cluster, which
// split the head (see "heads of 513 to 1024").
//
// Two routes, one per dtype: ops/kernels/flash_attention.py flash_route
// picks it for all three kernels and passes it in, and the entry points
// refuse a route that does not fit the dtype.
// - 'mma' (bf16): every product on the tensor cores with float32
//   accumulators in registers; at the widths 128 and 256 all three are the
//   Hopper kernels (wgmma fed by TMA, a producer warpgroup; see "the Hopper
//   kernels" below), everything else mma.sync m16n8k16. An
//   mma.sync block owns rows of its output (query rows
//   for the forward and dQ, key rows for dK/dV), holds its own operand rows
//   as A fragments in registers and streams tiles of the other side through
//   a cp.async ring in shared memory. A C fragment's columns are the next
//   product's reduction dimension, so P and dS go from one product's
//   accumulators to the next one's A operand in registers, rounded to bf16
//   there and only there; the forward's online softmax runs on the
//   accumulators too. With causal, a block visits only the tiles that hold
//   a pair it may see (see "the causal skip" below).
// - 'f32' (float32): the CUDA-core kernels (no TF32): one block of warps
//   owns 64 rows (32 above D = 64, so that the tiles fit shared memory),
//   each warp 16 of them, and loops over tiles of the other side staged in
//   shared memory.
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
// and once in each backward kernel. At 4 heads of 128 (bh = 68) the same
// stage has the same FLOPs and a quarter of the exps.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace mv2 {
namespace flash {

// the routes (ops/kernels/flash_attention.py ROUTES); each takes one dtype
enum Route { kRouteF32 = 0, kRouteMma = 1 };

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = -1e30f;
constexpr size_t kSmemMax = 232448;  // 227 KB of dynamic shared memory
// the widest head the 'mma' kernels build apart at d == D (the sweeps'
// widths); wider ones take the run-time d at every head
constexpr int kExactWidth = 64;

// the padded width a head of d values runs at (d a multiple of 8, <= 256)
__host__ __device__ constexpr int head_width(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

inline bool head_fits(int d) { return d >= 8 && d <= 256 && d % 8 == 0; }

// ---- the float32 kernels on the CUDA cores (the 'f32' route) --------------

constexpr int kRows = 16;  // rows a warp owns

// At padded width D: a block of tile / 16 warps owns `tile` rows and streams
// tiles of `tile` rows of the other side. Row strides in shared memory, in
// floats, are odd, so a warp reading one column of 32 rows hits 32 banks.
template <int D>
struct Cfg {
  static constexpr int tile = D <= 64 ? 64 : 32;
  static constexpr int threads = 2 * tile;  // tile / 16 warps
  static constexpr int ldt = D + 1;         // (tile, D) input tile
  static constexpr int ldp = tile + 1;      // (tile, tile) tile: P or dS
  static constexpr int lds = tile + 1;      // (tile, tile) tile: S or dP
  static constexpr int lda = D + 1;         // (tile, D) accumulator
};

__host__ __device__ constexpr size_t align_up(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

__device__ __forceinline__ float* carve(unsigned char*& p, int count) {
  float* out = reinterpret_cast<float*>(p);
  p += align_up(sizeof(float) * count);
  return out;
}

// bytes of `tiles` (tile, D) input tiles, `accs` accumulators, one S and one
// P tile and `vectors` row vectors
template <int D>
constexpr size_t smem_bytes(int tiles, int accs, int vectors) {
  typedef Cfg<D> C;
  return tiles * align_up(sizeof(float) * C::tile * C::ldt) +
         accs * align_up(sizeof(float) * C::tile * C::lda) +
         align_up(sizeof(float) * C::tile * C::lds) +
         align_up(sizeof(float) * C::tile * C::ldp) +
         vectors * align_up(sizeof(float) * C::tile);
}

// Rows row0 .. row0 + tile - 1 of src (rows, d) into a shared tile of width
// D; rows past the end and columns past d are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int row0, int rows, int d) {
  typedef Cfg<D> C;
  for (int idx = threadIdx.x; idx < C::tile * D; idx += C::threads) {
    const int r = idx / D, e = idx % D;
    dst[r * ld + e] =
        row0 + r < rows && e < d ? src[(size_t)(row0 + r) * d + e] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows) {
  if (threadIdx.x < Cfg<D>::tile)
    dst[threadIdx.x] =
        row0 + threadIdx.x < rows ? src[row0 + threadIdx.x] : 0.f;
}

template <int D>
__device__ __forceinline__ void fill(float* dst, int count, float value) {
  for (int idx = threadIdx.x; idx < count; idx += Cfg<D>::threads)
    dst[idx] = value;
}

// One warp: C (16, N) = [C +] A (16, K) op(B), all row-major in shared
// memory: with BT, B is (N, K) and op(B) = B^T; else B is (K, N). Lane l
// owns columns l, l + 32, ...
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

// Forward: one block per (bh, tile query rows). Per key tile and warp:
// S = Q K^T; then lane (row, half) of the warp owns half the tile's columns
// of one of its 16 rows: it updates the row's running max m and sum l (in
// registers, one shuffle with the lane of the other half), writes
// P = exp(S - m) and rescales its half of the row of O by
// exp(m_old - m_new); then O += P V. The lanes walk their columns rotated
// so that the 32 lanes of a warp read 32 different banks of S. At the end
// O / max(l, 1e-30) and lse = m + log(l). Hidden pairs score -1e30; a row
// that sees no key scores 0 at every key < m, so that O is the mean of v,
// and its lse is kMasked + log(m).
template <int D>
__global__ void __launch_bounds__(Cfg<D>::threads, 1)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ lse, int n, int m,
               int d, int q_tiles, int bias_groups, int causal, float scale) {
  typedef Cfg<D> C;
  constexpr int T = C::tile, HALF = T / 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  float* Qs = carve(sp, T * C::ldt);
  float* Ks = carve(sp, T * C::ldt);
  float* Vs = carve(sp, T * C::ldt);
  float* Of = carve(sp, T * C::lda);
  float* Sf = carve(sp, T * C::lds);
  float* Pt = carve(sp, T * C::ldp);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * T;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int half = lane & 1, srow = r0 + (lane >> 1);  // the lane's row
  const int row = q0 + srow, rot = (16 * half) % HALF;
  const int offset = m - n;
  const bool no_key = causal && row < n - m;
  const float* kb = k + (size_t)bh * m * d;
  const float* vb = v + (size_t)bh * m * d;
  const float* bb =
      bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  load_tile<D>(Qs, C::ldt, q + (size_t)bh * n * d, q0, n, d);
  fill<D>(Of, T * C::lda, 0.f);
  float m_run = kMasked, l_run = 0.f;

  for (int k0 = 0; k0 < m; k0 += T) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, C::ldt, kb, k0, m, d);
    load_tile<D>(Vs, C::ldt, vb, k0, m, d);
    __syncthreads();
    warp_mma_nt<T, D>(Qs + r0 * C::ldt, C::ldt, Ks, C::ldt,
                      Sf + r0 * C::lds, C::lds);
    __syncwarp();
    float s[HALF];
    float mx = kMasked;
#pragma unroll
    for (int t = 0; t < HALF; ++t) {
      const int c = HALF * half + ((t + rot) & (HALF - 1)), col = k0 + c;
      float x = Sf[srow * C::lds + c] * scale;
      if (bb && row < n && col < m) x += bb[(size_t)row * m + col];
      bool ok = col < m && (!causal || col <= row + offset);
      if (no_key) {
        ok = col < m;
        x = 0.f;
      }
      s[t] = ok ? x : kMasked;
      mx = fmaxf(mx, s[t]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < HALF; ++t) {
      const int c = HALF * half + ((t + rot) & (HALF - 1));
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
    warp_acc_nn<D, T>(Pt + r0 * C::ldp, C::ldp, Vs, C::ldt, Of + r0 * C::lda,
                      C::lda);
    __syncwarp();
  }

  if (row < n) {
    const float l = fmaxf(l_run, 1e-30f);
    const float inv = 1.f / l;
    float* orow = out + ((size_t)bh * n + row) * d;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
      const int col = half * (D / 2) + e;
      if (col < d) orow[col] = Of[srow * C::lda + col] * inv;
    }
    if (half == 0)
      lse[(size_t)bh * n + row] = (no_key ? kMasked : m_run) + logf(l);
  }
}

// dQ: one block per (bh, tile query rows). Per key tile and warp:
// P = exp(S - lse) on the visible keys, dP = dO V^T, dS = P (dP - delta),
// dQ += dS K; dS also goes to dbias (bh, n, m) when asked. dQ *= scale.
// A row that sees no key has P = 0 at every key: dq = 0, dS = 0.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::threads, 1)
    bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  float* __restrict__ dbias, int n, int m, int d, int q_tiles,
                  int bias_groups, int causal, float scale) {
  typedef Cfg<D> C;
  constexpr int T = C::tile, NJ = T / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  float* Qs = carve(sp, T * C::ldt);
  float* dOs = carve(sp, T * C::ldt);
  float* Ks = carve(sp, T * C::ldt);
  float* Vs = carve(sp, T * C::ldt);
  float* dQf = carve(sp, T * C::lda);
  float* Sf = carve(sp, T * C::lds);
  float* Pt = carve(sp, T * C::ldp);
  float* lse_s = carve(sp, T);
  float* delta_s = carve(sp, T);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * T;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int offset = m - n;
  const float* kb = k + (size_t)bh * m * d;
  const float* vb = v + (size_t)bh * m * d;
  const float* bb =
      bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
  float* dbb = dbias ? dbias + (size_t)bh * n * m : nullptr;

  load_tile<D>(Qs, C::ldt, q + (size_t)bh * n * d, q0, n, d);
  load_tile<D>(dOs, C::ldt, dout + (size_t)bh * n * d, q0, n, d);
  load_rows<D>(lse_s, lse + (size_t)bh * n, q0, n);
  load_rows<D>(delta_s, delta + (size_t)bh * n, q0, n);
  fill<D>(dQf, T * C::lda, 0.f);

  for (int k0 = 0; k0 < m; k0 += T) {
    __syncthreads();
    load_tile<D>(Ks, C::ldt, kb, k0, m, d);
    load_tile<D>(Vs, C::ldt, vb, k0, m, d);
    __syncthreads();
    warp_mma_nt<T, D>(Qs + r0 * C::ldt, C::ldt, Ks, C::ldt,
                      Sf + r0 * C::lds, C::lds);
    __syncwarp();
    float p[kRows][NJ];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        float x = Sf[(r0 + r) * C::lds + c] * scale;
        if (bb && row < n && col < m) x += bb[(size_t)row * m + col];
        const bool ok =
            row < n && col < m && (!causal || col <= row + offset);
        p[r][j] = ok ? expf(x - lse_s[r0 + r]) : 0.f;
      }
    }
    __syncwarp();  // S is read; dP takes its place
    warp_mma_nt<T, D>(dOs + r0 * C::ldt, C::ldt, Vs, C::ldt,
                      Sf + r0 * C::lds, C::lds);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + r0 + r;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j, col = k0 + c;
        const float ds =
            p[r][j] * (Sf[(r0 + r) * C::lds + c] - delta_s[r0 + r]);
        Pt[(r0 + r) * C::ldp + c] = ds;
        if (dbb && row < n && col < m) dbb[(size_t)row * m + col] = ds;
      }
    }
    __syncwarp();
    warp_acc_nn<D, T>(Pt + r0 * C::ldp, C::ldp, Ks, C::ldt,
                      dQf + r0 * C::lda, C::lda);
    __syncwarp();
  }

  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + r0 + r;
    if (row >= n) break;
    float* drow = dq + ((size_t)bh * n + row) * d;
    for (int e = lane; e < d; e += 32)
      drow[e] = dQf[(r0 + r) * C::lda + e] * scale;
  }
}

// dK, dV: one block per (bh, tile key rows), each warp 16 keys. Per query
// tile the products are formed transposed, so the warp's rows stay keys:
// S^T = K Q^T, P^T = exp(S^T - lse[query]), dV += P^T dO, dP^T = V dO^T,
// dS^T = P^T (dP^T - delta[query]), dK += dS^T Q. dK *= scale. A query that
// sees no key weighs 1 / m in dV at every key < m and 0 in dS.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::threads, 1)
    bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int n, int m, int d, int k_tiles,
                   int bias_groups, int causal, float scale) {
  typedef Cfg<D> C;
  constexpr int T = C::tile, NJ = T / 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  float* Ks = carve(sp, T * C::ldt);
  float* Vs = carve(sp, T * C::ldt);
  float* Qs = carve(sp, T * C::ldt);
  float* dOs = carve(sp, T * C::ldt);
  float* dKf = carve(sp, T * C::lda);
  float* dVf = carve(sp, T * C::lda);
  float* Sf = carve(sp, T * C::lds);
  float* Pt = carve(sp, T * C::ldp);
  float* lse_s = carve(sp, T);
  float* delta_s = carve(sp, T);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * T;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int offset = m - n, blind = causal ? n - m : 0;
  const float inv_m = 1.f / m;
  const float* qb = q + (size_t)bh * n * d;
  const float* dob = dout + (size_t)bh * n * d;
  const float* bb =
      bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  load_tile<D>(Ks, C::ldt, k + (size_t)bh * m * d, k0, m, d);
  load_tile<D>(Vs, C::ldt, v + (size_t)bh * m * d, k0, m, d);
  fill<D>(dKf, T * C::lda, 0.f);
  fill<D>(dVf, T * C::lda, 0.f);

  for (int q0 = 0; q0 < n; q0 += T) {
    __syncthreads();
    load_tile<D>(Qs, C::ldt, qb, q0, n, d);
    load_tile<D>(dOs, C::ldt, dob, q0, n, d);
    load_rows<D>(lse_s, lse + (size_t)bh * n, q0, n);
    load_rows<D>(delta_s, delta + (size_t)bh * n, q0, n);
    __syncthreads();
    warp_mma_nt<T, D>(Ks + r0 * C::ldt, C::ldt, Qs, C::ldt,
                      Sf + r0 * C::lds, C::lds);
    __syncwarp();
    float p[kRows][NJ];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int key = k0 + r0 + r;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j, row = q0 + c;
        float x = Sf[(r0 + r) * C::lds + c] * scale;
        if (bb && row < n && key < m) x += bb[(size_t)row * m + key];
        const bool ok =
            row < n && key < m && (!causal || key <= row + offset);
        p[r][j] = ok ? expf(x - lse_s[c]) : 0.f;
        Pt[(r0 + r) * C::ldp + c] = row < blind && key < m ? inv_m : p[r][j];
      }
    }
    __syncwarp();
    warp_acc_nn<D, T>(Pt + r0 * C::ldp, C::ldp, dOs, C::ldt,
                      dVf + r0 * C::lda, C::lda);
    warp_mma_nt<T, D>(Vs + r0 * C::ldt, C::ldt, dOs, C::ldt,
                      Sf + r0 * C::lds, C::lds);
    __syncwarp();  // P^T is read; dS^T takes its place
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        Pt[(r0 + r) * C::ldp + c] =
            p[r][j] * (Sf[(r0 + r) * C::lds + c] - delta_s[c]);
      }
    __syncwarp();
    warp_acc_nn<D, T>(Pt + r0 * C::ldp, C::ldp, Qs, C::ldt,
                      dKf + r0 * C::lda, C::lda);
    __syncwarp();
  }

  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + r0 + r;
    if (key >= m) break;
    float* krow = dk + ((size_t)bh * m + key) * d;
    float* vrow = dv + ((size_t)bh * m + key) * d;
    for (int e = lane; e < d; e += 32) {
      krow[e] = dKf[(r0 + r) * C::lda + e] * scale;
      vrow[e] = dVf[(r0 + r) * C::lda + e];
    }
  }
}

// ---- the bf16 kernels on the tensor cores (the 'mma' route) ---------------
//
// Three mma.sync kernels up to D = 64 (above, the Hopper kernels further
// down). Each block of warps owns rows of its
// output, 16 a warp,
// and streams tiles of the other side through a ring of stages in shared
// memory, filled by cp.async (zero-filled past the last row and past d) so
// that the next tile loads while this one runs its products, a chunk of its
// rows at a time (the fewer, the fewer registers). Every product is mma.sync
// m16n8k16 on bf16 with float32 accumulators in registers:
//   forward S = Q K^T                  Q: A fragments (Rows16); K by
//                                      ldmatrix
//         online softmax               in the accumulators' registers: the
//                                      running max and sum of a row reduced
//                                      over the 4 lanes of its quad; exp as
//                                      ex2 with log2 e folded into the scale
//         O += P V                     P rounded to bf16 as the A operand,
//                                      V by ldmatrix.trans; O in registers
//   dQ    S = Q K^T, dP = dO V^T       Q, dO: A fragments; K, V by ldmatrix
//         P = 2^(S scale log2e + bias log2e - lse log2e) on the visible keys
//         dS = P (dP - delta)          in the accumulators' registers
//         dQ += dS K                   dS rounded to bf16 as the A operand,
//                                      K by ldmatrix.trans
//   dK/dV S^T = K Q^T, dP^T = V dO^T   K, V: A fragments; Q, dO by ldmatrix
//         P^T, dS^T as above, with lse and delta per column (query)
//         dV += P^T dO, dK += dS^T Q   dO, Q by ldmatrix.trans
// Rows are padded from D to D + 8 bf16 in shared memory, so the 8 rows an
// ldmatrix phase reads fall in 8 different bank groups. The bias is read one
// bf16 at a time: a row of a (groups, n, m) bias is 4-byte aligned only when
// m is even. The geometry of each kernel at each width (FwdGeo, DqGeo and
// DkvGeo) keeps the accumulators, the A fragments held in registers and a
// chunk of scores under 255 registers a thread, and its shared memory under
// kSmemMax (static_asserts below); chip_smoke.py reads registers, spills
// and shared memory of every width back from the card.
//
// The causal skip (ops/kernels/flash_attention.py dq_key_tiles,
// dkv_query_tiles and tile_masked are its Python twin): the forward's and
// dQ's loops end at the last key tile their block's last row sees (none,
// when that row sees no key), the dK/dV loop starts at the first query tile
// whose last row sees the block's first key; only a tile that crosses the
// diagonal or a ragged edge (rows >= n, keys >= m) tests each element, and a
// hidden pair's exponent is -inf, so P = 0 before any use. No branch sits
// around an ldmatrix or mma. No atomics, one owner per output tile.

// tile (q0 .. q0 + nq - 1) x (k0 .. k0 + nk - 1) has a pair to mask: a ragged
// edge, or with causal a key past the diagonal of its first row
__device__ __forceinline__ bool tile_masked(int q0, int nq, int k0, int nk,
                                            int n, int m, int causal) {
  return q0 + nq > n || k0 + nk > m || (causal && k0 + nk - 1 > q0 + m - n);
}

// ROWS rows from row0 of src (rows, d) into a ring tile with rows of D + 8,
// zeros past the last row and past d, by THREADS threads
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void async_tile(bf16* dst, const bf16* src,
                                           int row0, int rows, int d) {
  constexpr int V = D / 8;  // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < ROWS * V; idx += THREADS) {
    const int r = idx / V, e = (idx % V) * 8;
    const bool ok = row0 + r < rows && e < d;
    cp_async16(dst + r * (D + 8) + e,
               src + (ok ? (size_t)(row0 + r) * d + e : 0), ok);
  }
}

// An operand's 16 rows as the A side of mma.sync: fragments held in
// registers (a[c] covers columns 16c .. 16c + 15)
template <int D>
struct Rows16 {
  unsigned a[D / 16][4];
};

// A fragments of rows ra and ra + 8 of src (rows, d), straight from device
// memory; rows past the last and columns past d are zero
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4],
                                       const bf16* src, int ra, int rows,
                                       int d) {
  const int tq = threadIdx.x % 4;
  auto word = [&](int row, int col) -> unsigned {
    return row < rows && col < d
               ? *reinterpret_cast<const unsigned*>(src + (size_t)row * d + col)
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

// s[j] (16 x 8) = A (16 x D) B^T for B = rows br0 + 8 j .. br0 + 8 j + 7 of
// a ring tile, j < NB
template <int D, int NB>
__device__ __forceinline__ void mma_chunk(float (&s)[NB][4],
                                          const Rows16<D>& A,
                                          const bf16* tile, int br0) {
#pragma unroll
  for (int j = 0; j < NB; ++j) mma_rows<D>(s[j], A.a, tile, br0 + 8 * j);
}

// s = A1 B1^T and dp = A2 B2^T over the same rows of two ring tiles, block
// by block
template <int D, int NB>
__device__ __forceinline__ void mma_chunk_pair(
    float (&s)[NB][4], const Rows16<D>& a1, const bf16* t1,
    float (&dp)[NB][4], const Rows16<D>& a2, const bf16* t2, int br0) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    mma_rows<D>(s[j], a1.a, t1, br0 + 8 * j);
    mma_rows<D>(dp[j], a2.a, t2, br0 + 8 * j);
  }
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

// rows ra and ra + 8 of an output with rows of ld values from C fragments,
// times mul; the columns past d are not stored
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[D / 8][4],
                                           int ra, int rows, float mul, int d,
                                           int ld) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    const int col = 8 * db + 2 * tq;
    if (col >= d) continue;
    if (ra < rows)
      *reinterpret_cast<unsigned*>(dst + (size_t)ra * ld + col) =
          pack_bf16(acc[db][0] * mul, acc[db][1] * mul);
    if (ra + 8 < rows)
      *reinterpret_cast<unsigned*>(dst + (size_t)(ra + 8) * ld + col) =
          pack_bf16(acc[db][2] * mul, acc[db][3] * mul);
  }
}

// the same for a (rows, d) output
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[D / 8][4],
                                           int ra, int rows, float mul,
                                           int d) {
  store_rows<D>(dst, acc, ra, rows, mul, d, d);
}

// out[c] = the sum over rows 0 .. rows - 1 of column c of src (rows of ld
// values) in float32, for c < D (0 past d), by the block's first THREADS
// threads in a fixed order (every thread of the block calls it): thread
// t sums column pair t % (D / 2) over every R-th row from t / (D / 2),
// R = THREADS / (D / 2), into part; then the R partial sums of a column are
// added in order. out (D floats) and part (2 THREADS floats) are in shared
// memory; the block is synchronised at the end. The rows that see no key
// read it: the forward for the mean of v, dK/dV for the sum of their dO.
template <int D, int THREADS>
__device__ __forceinline__ void column_sum(float* out, float* part,
                                           const bf16* src, int rows, int d,
                                           int ld) {
  constexpr int P = D / 2, R = THREADS / P;
  static_assert(THREADS % P == 0, "a whole number of rows a pass");
  const int t = threadIdx.x, pair = t % P, phase = t / P;
  if (t < THREADS) {  // a block may hold more threads; they only meet
    float s0 = 0.f, s1 = 0.f;
    if (2 * pair < d) {
#pragma unroll 4
      for (int r = phase; r < rows; r += R) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            src + (size_t)r * ld + 2 * pair);
        s0 += __low2float(x);
        s1 += __high2float(x);
      }
    }
    part[phase * D + 2 * pair] = s0;
    part[phase * D + 2 * pair + 1] = s1;
  }
  __syncthreads();
  if (t < THREADS)
    for (int c = t; c < D; c += THREADS) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += part[r * D + c];
      out[c] = s;
    }
  __syncthreads();
}

template <int D, int THREADS>
__device__ __forceinline__ void column_sum(float* out, float* part,
                                           const bf16* src, int rows, int d) {
  column_sum<D, THREADS>(out, part, src, rows, d, d);
}

template <int D, int THREADS>
constexpr size_t column_sum_bytes() {
  return sizeof(float) * (D + 2 * THREADS);
}

// The forward up to D = 64 (the wider widths run fwd_wg_mma_kernel below):
// kFwdWarps warps a block, 16 query rows a warp (from the sweep of
// tools/flash_fwd_variants.py, PERF.md §6 records it), kFwdStages key tiles
// of kFwdTile keys in flight, kFwdChunk keys' scores in registers at a
// time, Q's A fragments held in registers (D / 4 a thread).
constexpr int kFwdWarps = 4;
constexpr int kFwdStages = 2;
constexpr int kFwdTile = 128;
constexpr int kFwdChunk = 64;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdBlockRows = 16 * kFwdWarps;  // query rows a block owns

template <int D>
struct FwdGeo {
  static_assert(D <= kExactWidth, "the mma.sync forward's widths");
  static constexpr int stages = kFwdStages;
  static constexpr int tile = kFwdTile;
  static constexpr int chunk = kFwdChunk;
  static constexpr size_t ring =
      (size_t)stages * 2 * sizeof(bf16) * tile * (D + 8);
  static constexpr size_t bytes = ring + column_sum_bytes<D, kFwdThreads>();
  static_assert(tile % chunk == 0 && chunk % 16 == 0 && stages >= 2,
                "forward geometry");
  static_assert(bytes <= kSmemMax, "forward shared memory");
};

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
// and not inf - inf. A row that sees no key at all (causal, m < n) gets the
// mean of v from column_sum and lse = kMasked + log(m).
#define MV2_FWD_PARAMS                                                    \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                 \
      const bf16 *__restrict__ v, const bf16 *__restrict__ bias,          \
      bf16 *__restrict__ out, float *__restrict__ lse, int n, int m, int dh, \
      int q_tiles, int bias_groups, int causal, float scale
#define MV2_FWD_ARGS \
  q, k, v, bias, out, lse, n, m, dh, q_tiles, bias_groups, causal, scale

template <int D, bool EXACT>
__device__ __forceinline__ void fwd_mma(MV2_FWD_PARAMS) {
  typedef FwdGeo<D> G;
  const int d = EXACT ? D : dh;
  constexpr int LD = D + 8, TILE = G::tile * LD, NB = G::chunk / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // a stage: K tile, V tile
  float* vsum = reinterpret_cast<float*>(smem_raw + G::ring);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * kFwdBlockRows;
  const int lane = threadIdx.x % 32, tq = lane & 3, warp = threadIdx.x / 32;
  const int w0 = q0 + 16 * warp;  // the warp's first row
  const int ra = w0 + (lane >> 2);
  const int offset = m - n;
  const bf16* qb = q + (size_t)bh * n * d;
  const bf16* kb = k + (size_t)bh * m * d;
  const bf16* vb = v + (size_t)bh * m * d;
  const bf16* bb = bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles)
  const int k_end = causal ? min(m, min(q0 + kFwdBlockRows, n) + offset) : m;
  const int tiles = (max(k_end, 0) + G::tile - 1) / G::tile;
  auto load = [&](int t) {
    bf16* st = ring + (t % G::stages) * 2 * TILE;
    async_tile<D, G::tile, kFwdThreads>(st, kb, t * G::tile, m, d);
    async_tile<D, G::tile, kFwdThreads>(st + TILE, vb, t * G::tile, m, d);
  };
#pragma unroll
  for (int t = 0; t < G::stages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }

  Rows16<D> qa;
  load_a<D>(qa.a, qb, ra, n, d);
  // rows < n - m see no key (causal): their mean of v
  if (causal && q0 < n - m)
    column_sum<D, kFwdThreads>(vsum, vsum + D, vb, m, d);
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
    cp_async_wait<G::stages - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + G::stages - 1 < tiles) load(t + G::stages - 1);
    cp_async_commit();
    const bf16* Ks = ring + (t % G::stages) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < G::tile; c0 += G::chunk) {
      const int k0 = t * G::tile + c0;
      const bool masked = tile_masked(w0, 16, k0, G::chunk, n, m, causal);
      float s[NB][4];
      mma_chunk<D, NB>(s, qa, Ks, c0);
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
  cp_async_wait<0>();  // no copy outlives the block (tiles may be 0)

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
  if (causal && q0 < n - m) {  // uniform: the rows that see no key
    const float inv_m = 1.f / m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ra + 8 * h;
      if (row >= n - m) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][2 * h] = vsum[8 * i + 2 * tq] * inv_m;
        o[i][2 * h + 1] = vsum[8 * i + 2 * tq + 1] * inv_m;
      }
      if (tq == 0) lse_rows[row] = kMasked + logf((float)m);
    }
  }
  store_rows<D>(out + (size_t)bh * n * d, o, ra, n, 1.f, d);
}

// Each kernel is built twice up to kExactWidth: for a head of exactly D (d
// a constant, with the launch bounds the sweeps tuned) and, as the padded
// kernel, for a narrower one (d at run time). The wider widths run the
// Hopper kernels.
template <int D>
__global__ void __launch_bounds__(kFwdThreads)
    fwd_mma_kernel(MV2_FWD_PARAMS) {
  fwd_mma<D, true>(MV2_FWD_ARGS);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_mma_padded_kernel(MV2_FWD_PARAMS) {
  fwd_mma<D, false>(MV2_FWD_ARGS);
}

// The backward up to D = 64 (the wider widths run the Hopper kernels):
// kBwdWarps warps a block, 16 output rows a warp; the products take a chunk
// of a streamed tile's rows at a time (from the sweep of
// tools/flash_bwd_variants.py, PERF.md §6 records it): kBwdStages tiles of
// kBwdTile rows in flight and chunks of kDqChunk and kDkvChunk rows. dQ *=
// scale and dK *= scale at the end. The dQ kernel writes dS (when asked) in
// every tile it visits and zeros in the key tiles it skips, so every
// element of dS has one writer.
constexpr int kBwdWarps = 4;
constexpr int kBwdStages = 2;
constexpr int kBwdTile = 64;
constexpr int kDqChunk = 32;
constexpr int kDkvChunk = 16;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;  // output rows a block owns

// dQ up to D = 64 (the wider widths run bwd_dq_wg_mma_kernel below): keys
// a streamed tile and a chunk; Q's and dO's A fragments held in registers
template <int D>
struct DqGeo {
  static_assert(D <= kExactWidth, "the mma.sync dQ's widths");
  static constexpr int stages = kBwdStages;
  static constexpr int tile = kBwdTile;
  static constexpr int chunk = kDqChunk;
  static constexpr size_t bytes =
      (size_t)stages * 2 * sizeof(bf16) * tile * (D + 8);
  static_assert(tile % chunk == 0 && chunk % 16 == 0 && stages >= 2,
                "dQ geometry");
  static_assert(bytes <= kSmemMax, "dQ shared memory");
};

// dK/dV up to D = 64 (the wider widths run bwd_dkv_wg_mma_kernel below):
// query rows a streamed tile and a chunk; K's and V's A fragments held in
// registers, dK and dV formed together in one sweep over the query tiles
template <int D>
struct DkvGeo {
  static_assert(D <= kExactWidth, "the mma.sync dK/dV's widths");
  static constexpr int stages = kBwdStages;
  static constexpr int tile = kBwdTile;
  static constexpr int chunk = kDkvChunk;
  // a stage: Q tile, dO tile (bf16), lse, delta (floats)
  static constexpr size_t stage =
      2 * sizeof(bf16) * tile * (D + 8) + 2 * sizeof(float) * tile;
  static constexpr size_t ring = stages * stage;
  static constexpr size_t bytes = ring + column_sum_bytes<D, kBwdThreads>();
  static_assert(tile % chunk == 0 && stage % 16 == 0 && stages >= 2,
                "dK/dV geometry");
  static_assert(bytes <= kSmemMax, "dK/dV shared memory");
};

// TILE floats from row0 of src (rows), zeros past the last
template <int TILE>
__device__ __forceinline__ void async_rows(float* dst, const float* src,
                                           int row0, int rows) {
  for (int i = threadIdx.x; i < TILE; i += kBwdThreads) {
    const bool ok = row0 + i < rows;
    cp_async4(dst + i, src + (ok ? row0 + i : 0), ok);
  }
}

// dQ: one block per (bh, kBwdRows query rows), streaming key tiles.
#define MV2_DQ_PARAMS                                                      \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                 \
      const bf16 *__restrict__ v, const bf16 *__restrict__ bias,          \
      const bf16 *__restrict__ dout, const float *__restrict__ lse,       \
      const float *__restrict__ delta, bf16 *__restrict__ dq,             \
      float *__restrict__ dbias, int n, int m, int dh, int q_tiles,       \
      int bias_groups, int causal, float scale
#define MV2_DQ_ARGS                                                       \
  q, k, v, bias, dout, lse, delta, dq, dbias, n, m, dh, q_tiles,          \
      bias_groups, causal, scale

template <int D, bool EXACT>
__device__ __forceinline__ void bwd_dq_mma(MV2_DQ_PARAMS) {
  typedef DqGeo<D> G;
  const int d = EXACT ? D : dh;
  constexpr int LD = D + 8, TILE = G::tile * LD, NB = G::chunk / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // a stage: K tile, V tile

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBwdRows;
  const int lane = threadIdx.x % 32, tq = lane & 3, warp = threadIdx.x / 32;
  const int ra = q0 + 16 * warp + (lane >> 2), rb = ra + 8;
  const int offset = m - n;
  const bf16* qb = q + (size_t)bh * n * d;
  const bf16* dob = dout + (size_t)bh * n * d;
  const bf16* kb = k + (size_t)bh * m * d;
  const bf16* vb = v + (size_t)bh * m * d;
  const bf16* bb = bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
  float* dbb = dbias ? dbias + (size_t)bh * n * m : nullptr;

  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles)
  const int k_end = causal ? min(m, min(q0 + kBwdRows, n) + offset) : m;
  const int tiles = (max(k_end, 0) + G::tile - 1) / G::tile;
  auto load = [&](int t) {
    bf16* st = ring + (t % G::stages) * 2 * TILE;
    async_tile<D, G::tile, kBwdThreads>(st, kb, t * G::tile, m, d);
    async_tile<D, G::tile, kBwdThreads>(st + TILE, vb, t * G::tile, m, d);
  };
#pragma unroll
  for (int t = 0; t < G::stages - 1; ++t) {
    if (t < tiles) load(t);
    cp_async_commit();
  }

  Rows16<D> qa, da;
  load_a<D>(qa.a, qb, ra, n, d);
  load_a<D>(da.a, dob, ra, n, d);
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
    cp_async_wait<G::stages - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + G::stages - 1 < tiles) load(t + G::stages - 1);
    cp_async_commit();
    const bf16* Ks = ring + (t % G::stages) * 2 * TILE;
    const bf16* Vs = Ks + TILE;
    const int k0 = t * G::tile;
    const bool masked = tile_masked(q0, kBwdRows, k0, G::tile, n, m, causal);
#pragma unroll 1
    for (int c0 = 0; c0 < G::tile; c0 += G::chunk) {
      float s[NB][4], dp[NB][4];
      mma_chunk_pair<D, NB>(s, qa, Ks, dp, da, Vs, c0);
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
  cp_async_wait<0>();  // no copy outlives the block (tiles may be 0)
  store_rows<D>(dq + (size_t)bh * n * d, acc, ra, n, scale, d);
  // dS of the key tiles the causal skip passed over is 0
  const int skipped = m - tiles * G::tile;
  if (dbb && skipped > 0)
    for (int idx = threadIdx.x; idx < kBwdRows * skipped; idx += kBwdThreads) {
      const int row = q0 + idx / skipped;
      if (row < n) dbb[(size_t)row * m + m - skipped + idx % skipped] = 0.f;
    }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_dq_mma_kernel(MV2_DQ_PARAMS) {
  bwd_dq_mma<D, true>(MV2_DQ_ARGS);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    bwd_dq_mma_padded_kernel(MV2_DQ_PARAMS) {
  bwd_dq_mma<D, false>(MV2_DQ_ARGS);
}

// A dK/dV block's sweep over the query tiles first .. tiles - 1, streamed
// through the ring (q, dO, lse, delta): dS^T Q into dk, P^T dO into dv.
template <int D>
__device__ __forceinline__ void dkv_sweep(
    float (&dk)[D / 8][4], float (&dv)[D / 8][4],
    const Rows16<D>& ka, const Rows16<D>& va,
    unsigned char* ring, const bf16* qb, const bf16* dob,
    const float* lse_rows, const float* delta_rows, const bf16* bb, int k0,
    int kr, int n, int m, int d, int first, int causal, float scale_log2) {
  typedef DkvGeo<D> G;
  constexpr int TILE = G::tile * (D + 8), NB = G::chunk / 8;
  const int tq = threadIdx.x % 4, offset = m - n;
  const int tiles = (n + G::tile - 1) / G::tile;
  auto stage = [&](int t) {
    return ring + ((t - first) % G::stages) * G::stage;
  };
  auto load = [&](int t) {
    bf16* st = reinterpret_cast<bf16*>(stage(t));
    float* rows = reinterpret_cast<float*>(st + 2 * TILE);
    async_tile<D, G::tile, kBwdThreads>(st, qb, t * G::tile, n, d);
    async_tile<D, G::tile, kBwdThreads>(st + TILE, dob, t * G::tile, n, d);
    async_rows<G::tile>(rows, lse_rows, t * G::tile, n);
    async_rows<G::tile>(rows + G::tile, delta_rows, t * G::tile, n);
  };
#pragma unroll
  for (int t = 0; t < G::stages - 1; ++t) {
    if (first + t < tiles) load(first + t);
    cp_async_commit();
  }

  for (int t = first; t < tiles; ++t) {
    cp_async_wait<G::stages - 2>();
    __syncthreads();  // tile t is in; tile t - 1's stage is free
    if (t + G::stages - 1 < tiles) load(t + G::stages - 1);
    cp_async_commit();
    const bf16* Qs = reinterpret_cast<const bf16*>(stage(t));
    const bf16* dOs = Qs + TILE;
    const float* lse_s = reinterpret_cast<const float*>(Qs + 2 * TILE);
    const float* delta_s = lse_s + G::tile;
    const int q0 = t * G::tile;
    const bool masked = tile_masked(q0, G::tile, k0, kBwdRows, n, m, causal);
#pragma unroll 1
    for (int c0 = 0; c0 < G::tile; c0 += G::chunk) {
      float s[NB][4], dp[NB][4];
      mma_chunk_pair<D, NB>(s, ka, Qs, dp, va, dOs, c0);
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
        mma_acc_trans<D>(dv, a, dOs, c0 + 16 * kk);
        c_to_a(a, dp[2 * kk], dp[2 * kk + 1]);
        mma_acc_trans<D>(dk, a, Qs, c0 + 16 * kk);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// dK, dV: one block per (bh, kBwdRows key rows), streaming query tiles
// (q, dO, lse, delta); the products transposed so the rows stay keys. The
// rows that see no key (causal, m < n) add the sum of their dO, over m, to
// every dV row.
#define MV2_DKV_PARAMS                                                     \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                 \
      const bf16 *__restrict__ v, const bf16 *__restrict__ bias,          \
      const bf16 *__restrict__ dout, const float *__restrict__ lse,       \
      const float *__restrict__ delta, bf16 *__restrict__ dk,             \
      bf16 *__restrict__ dv, int n, int m, int dh, int k_tiles,           \
      int bias_groups, int causal, float scale
#define MV2_DKV_ARGS                                                      \
  q, k, v, bias, dout, lse, delta, dk, dv, n, m, dh, k_tiles, bias_groups, \
      causal, scale

template <int D, bool EXACT>
__device__ __forceinline__ void bwd_dkv_mma(MV2_DKV_PARAMS) {
  typedef DkvGeo<D> G;
  const int d = EXACT ? D : dh;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* dosum = reinterpret_cast<float*>(smem_raw + G::ring);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kBwdRows;
  const int lane = threadIdx.x % 32, tq = lane & 3, warp = threadIdx.x / 32;
  const int kr = k0 + 16 * warp + (lane >> 2);
  const int offset = m - n;
  const int blind = causal ? n - m : 0;  // rows < blind see no key
  const bf16* qb = q + (size_t)bh * n * d;
  const bf16* dob = dout + (size_t)bh * n * d;
  const bf16* kb = k + (size_t)bh * m * d;
  const bf16* vb = v + (size_t)bh * m * d;
  const float* lse_rows = lse + (size_t)bh * n;
  const float* delta_rows = delta + (size_t)bh * n;
  const bf16* bb = bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;

  // query tiles first .. tiles - 1: with causal, from the first whose last
  // row sees the block's first key (dkv_query_tiles)
  const int first = causal ? max(0, k0 - offset) / G::tile : 0;
  Rows16<D> ka, va;
  load_a<D>(ka.a, kb, kr, m, d);
  load_a<D>(va.a, vb, kr, m, d);
  if (blind > 0) column_sum<D, kBwdThreads>(dosum, dosum + D, dob, blind, d);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  dkv_sweep<D>(dk_acc, dv_acc, ka, va, smem_raw, qb, dob, lse_rows,
               delta_rows, bb, k0, kr, n, m, d, first, causal,
               scale * kLog2e);
  if (blind > 0) {  // dV of the rows that see no key: their dO summed / m
    const float inv_m = 1.f / m;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv_acc[i][e] += dosum[8 * i + 2 * tq + (e & 1)] * inv_m;
  }
  store_rows<D>(dk + (size_t)bh * m * d, dk_acc, kr, m, scale, d);
  store_rows<D>(dv + (size_t)bh * m * d, dv_acc, kr, m, 1.f, d);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_dkv_mma_kernel(MV2_DKV_PARAMS) {
  bwd_dkv_mma<D, true>(MV2_DKV_ARGS);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    bwd_dkv_mma_padded_kernel(MV2_DKV_PARAMS) {
  bwd_dkv_mma<D, false>(MV2_DKV_ARGS);
}

// ---- the Hopper kernels at the padded widths 128 and 256 ('mma' route) ----
//
// A head of 72 to 256 values runs all three kernels here, built at D = 128
// and 256 with the true d at run time.
// Each block is a producer warpgroup and two consumer warpgroups
// (kWgThreads); setmaxnreg gives the producer's registers to the consumers,
// whose accumulators fill them. One warp of the producer warpgroup works,
// the other three leave at once; its lane 0 keeps TMA loads in flight
// through mbarrier rings: boxes of 64 columns (128 bytes, swizzled) of a 3-D
// tensor map (bh, rows, d), so rows past a head's n or m and columns past
// the true d (the map's inner dimension) arrive as zeros. Every product is
// wgmma on bf16 with float32 accumulators in registers:
//   forward S = Q K^T          both operands from shared memory, K-major
//           online softmax     on the accumulators, as fwd_mma: ex2 with
//                              log2 e folded into the scale, the row max
//                              and sum over the quad
//           O += P V           A = P in registers (rounded to bf16 there
//                              and only there), B = V straight from its
//                              TMA tile, MN-major (the transpose bit)
//   dQ      S = Q K^T, dP = dO V^T   both from shared memory, K-major
//           P, dS              as bwd_dq_mma, lse and delta per row
//           dQ += dS K         A = dS in registers, B = the same K tile
//                              read MN-major
//   dK/dV S^T = K Q^T, dP^T = V dO^T   both from shared memory, K-major
//           P^T, dS^T          as bwd_dkv_mma, lse and delta per column
//           dV += P^T dO, dK += dS^T Q  A in registers, B the same Q and
//                              dO tiles read MN-major
// The accumulator of a wgmma (rows g and g + 8 of each warp's 16, columns
// 8j + 2(lane % 4) + {0, 1}) is the mma.sync C layout per 8-column block,
// and two neighbouring blocks are the A fragment of a 16-deep step
// (frag_of), so P and dS go from one product to the next in registers.
// Masking, the bias (and `pre`), the causal skip, the rows that see no key,
// the dead rows and dS as d_bias are fwd_mma's, bwd_dq_mma's and
// bwd_dkv_mma's. One owner per output tile, no atomics: two calls are
// bit-identical.
//
// The forward (fwd_wg_mma_kernel): a block owns 128 query rows, 64 a
// consumer warpgroup, heaviest blocks first; Q arrives once, K and V tiles
// of WgFwdGeo::tile keys through rings of their own (K's stage returns once
// S is formed, V's once O += P V has read it). A warpgroup retires each
// product before the next step (issuing the next tile's S before this
// tile's P V, or the warpgroups taking turns to issue S, read slower on the
// card: PERF.md section 6).
// dK/dV (bwd_dkv_wg_mma_kernel): a block owns WgDkvGeo::keys keys, whose K
// and V arrive once, and streams tiles of 64 queries (Q, dO, and lse and
// delta written by the producer warp) through a ring. At D = 128 each
// warpgroup owns 64 keys and forms all four products. At D = 256 dK and dV
// (256 floats a thread together) do not fit one warpgroup, so both own the
// same 64 keys: warpgroup 0 forms S^T, P^T and dV and hands P^T over in
// float32 through shared memory (named barriers kPFull / kPEmpty),
// warpgroup 1 forms dP^T, dS^T = P^T (dP^T - delta) and dK: each product
// once, as today's float32 P in dS.
// dQ (bwd_dq_wg_mma_kernel): a block owns 128 query rows, 64 a consumer
// warpgroup, heaviest blocks first; Q and dO arrive once, K and V tiles of
// WgDqGeo::tile keys through rings of their own. S and dP are issued as two
// groups: P = 2^(S scale log2e - lse log2e) is formed while dP is still in
// flight; V's stage returns once dP is formed, K's once dQ += dS K has read
// it. With a bias, dS goes to d_bias (float32) from the accumulators while
// dQ's product runs, and the key tiles the causal skip passes over get
// zeros, so every element of d_bias has one writer.
// What bounds them on the H100: operations, 4 d (forward), 6 d (dQ) and 8 d
// (dK/dV) FLOPs a visible pair at D = 128 or 256 padded columns
// (chip_smoke.py flash_cost).

constexpr int kWgConsumers = 256;               // two warpgroups
constexpr int kWgThreads = kWgConsumers + 128;  // and the producer's
// registers a thread after setmaxnreg: the block starts at 168 (ptxas's
// count for three warpgroups at one block an SM), and what the producer
// warpgroup gives back, (168 - 24) x 128, is what the consumers take,
// (240 - 168) x 256 (wg_registers_fit). ptxas gives the consumers' code
// the 240 only while no block of it is shared with the producer's: a
// __trap() in the barrier wait of both roles left their loops at 168
// registers and spilling, so the waits are plain mbar_wait.
constexpr int kWgProducerRegs = 24, kWgConsumerRegs = 240;
constexpr int kPFull = 1, kPEmpty = 2;         // named barriers (dK/dV)

// the A fragment of a 16-deep step from accumulator blocks c[0..3], c[4..7]
__device__ __forceinline__ void frag_of(unsigned (&a)[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// keep registers live (an asynchronous wgmma still reads them) up to here
template <int N>
__device__ __forceinline__ void keep_live(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
}

// rows ra and ra + 8 of an output with rows of ld values from a wgmma
// accumulator of D columns, times mul; the columns past cols are not stored
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2],
                                          int ra, int rows, float mul,
                                          int cols, int ld) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (col >= cols) continue;
    if (ra < rows)
      *reinterpret_cast<unsigned*>(dst + (size_t)ra * ld + col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (ra + 8 < rows)
      *reinterpret_cast<unsigned*>(dst + (size_t)(ra + 8) * ld + col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// the same for a (rows, d) output
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[D / 2],
                                          int ra, int rows, float mul, int d) {
  store_acc<D>(dst, acc, ra, rows, mul, d, d);
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// The forward's geometry (ops/kernels/flash_attention.py WG_FWD_ROWS,
// WG_FWD_TILE): query rows a block, keys a tile, stages of each ring
template <int D>
struct WgFwdGeo {
  static_assert(D == 128 || D == 256, "the Hopper forward's widths");
  static constexpr int rows = 128;
  static constexpr int tile = D == 128 ? 128 : 64;
  static constexpr int stages = 2;
  static constexpr int panels = D / kSw128Cols;   // 64-column boxes a row
  static constexpr int q_panel = rows * 128;      // bytes
  static constexpr int kv_panel = tile * 128;
  static constexpr int kv_tile = panels * kv_panel;
  static constexpr size_t bytes = 1024 + (size_t)panels * q_panel +
                                  2 * (size_t)stages * kv_tile +
                                  sizeof(float) * D;
  static_assert(bytes <= kSmemMax, "Hopper forward shared memory");
  static_assert(stages * kv_tile >= column_sum_bytes<D, kWgConsumers>(),
                "column_sum's partial sums fit the K ring");
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wg_mma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ bias, bf16* __restrict__ out,
                      float* __restrict__ lse, int n, int m, int d,
                      int q_tiles, int bias_groups, int causal, float scale) {
  typedef WgFwdGeo<D> G;
  constexpr int T = G::tile, NB = T / 8;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t qbar, kfull[G::stages],
      kempty[G::stages], vfull[G::stages], vempty[G::stages];
  unsigned char* qs = align1024(wg_smem);
  unsigned char* ks = qs + G::panels * G::q_panel;
  unsigned char* vs = ks + G::stages * G::kv_tile;
  float* vsum = reinterpret_cast<float*>(vs + G::stages * G::kv_tile);

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * G::rows;
  const int offset = m - n;
  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles)
  const int k_end = causal ? min(m, min(q0 + G::rows, n) + offset) : m;
  const int tiles = (max(k_end, 0) + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool blind = causal && q0 < n - m;  // rows that see no key

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < G::stages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], kWgConsumers / 32);  // a consumer warp each
      mbar_init(&vempty[s], kWgConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (blind) {  // their mean of v, summed in the K ring before it fills
    column_sum<D, kWgConsumers>(vsum, reinterpret_cast<float*>(ks),
                                v + (size_t)bh * m * d, m, d);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {  // the producer warpgroup
    reg_dealloc<kWgProducerRegs>();
    if (warp == kWgConsumers / 32 && lane == 0) {
      mbar_expect_tx(&qbar, G::panels * G::q_panel);
      for (int p = 0; p < G::panels; ++p)
        tma_load_3d(qs + p * G::q_panel, &map_q, &qbar, p * kSw128Cols, q0,
                    bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % G::stages, use = t / G::stages;
        if (use > 0) mbar_wait(&kempty[s], (use - 1) & 1);
        mbar_expect_tx(&kfull[s], G::kv_tile);
        for (int p = 0; p < G::panels; ++p)
          tma_load_3d(ks + s * G::kv_tile + p * G::kv_panel, &map_k,
                      &kfull[s], p * kSw128Cols, t * T, bh);
        if (use > 0) mbar_wait(&vempty[s], (use - 1) & 1);
        mbar_expect_tx(&vfull[s], G::kv_tile);
        for (int p = 0; p < G::panels; ++p)
          tma_load_3d(vs + s * G::kv_tile + p * G::kv_panel, &map_v,
                      &vfull[s], p * kSw128Cols, t * T, bh);
      }
    }
  } else {  // two consumer warpgroups, 64 query rows each
    reg_alloc<kWgConsumerRegs>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
    const int w0 = q0 + 64 * wg + 16 * wq;  // the warp's first row
    const int ra = w0 + g;
    const bf16* bb =
        bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
    // as fwd_mma: the row max on the raw scores and the scale folded into
    // the exponent (mul = scale log2e), unless a bias or a scale <= 0 asks
    // for the scores in base-2 units first (mul = 1)
    const float scale_log2 = scale * kLog2e;
    const bool pre = bb != nullptr || !(scale > 0.f);
    const float mul = pre ? 1.f : scale_log2;
    const uint64_t qdesc = sw128_desc(qs + 64 * wg * 128);
    float o[D / 2];
    zero_acc(o);
    // running max (base 2) and the lane's part of l, of rows ra and ra + 8
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float alpha[2];
    float sc[T / 2];     // S, then P in float32
    unsigned pa[T / 16][4];   // P as the A operand of P V

    // S of tile t into sc (issued, not retired)
    auto issue_s = [&](int t) {
      const int s = t % G::stages;
      mbar_wait(&kfull[s], (t / G::stages) & 1);
      const uint64_t kdesc = sw128_desc(ks + s * G::kv_tile);
#pragma unroll
      for (int p = 0; p < G::panels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16(sc, qdesc + ((p * G::q_panel) >> 4) + 2 * kk,
                     kdesc + ((p * G::kv_panel) >> 4) + 2 * kk);
      wgmma_commit();
    };
    // O += P V of tile t (issued, not retired)
    auto issue_pv = [&](int t) {
      const int s = t % G::stages;
      mbar_wait(&vfull[s], (t / G::stages) & 1);
      const uint64_t vdesc =
          sw128_mn_desc(vs + s * G::kv_tile, G::kv_panel);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs_mn(o, pa[kk], vdesc + 128 * kk);
      wgmma_commit();
    };
    auto release = [&](uint64_t* bars, int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[t % G::stages]);
    };
    // the online softmax of tile t on sc (retired): P in float32, alpha,
    // the running max and sum
    auto softmax = [&](int t) {
      const int k0 = t * T;
      const bool masked = tile_masked(w0, 16, k0, T, n, m, causal);
      // element 4j + e is (row ra + 8 (e / 2), key k0 + 8j + 2tq + e % 2);
      // uniform branches: the bias, and the element test of a masked tile
      if (pre)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            float& x = sc[4 * j + e];
            x *= scale_log2;
            if (bb && row < n && col < m)
              x = fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e, x);
          }
      if (masked)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (!(row < n && col < m && (!causal || col <= row + offset)))
              sc[4 * j + e] = -INFINITY;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          cmax = fmaxf(cmax, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
        const float mnew = fmaxf(mx[h], quad_max(cmax));
        // a row that has seen no visible key yet keeps 0: no inf - inf
        const float base = mnew == -INFINITY ? 0.f : mnew * mul;
        alpha[h] = exp2_approx(fmaf(mx[h], mul, -base));
        mx[h] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], mul, -base));
            sum += sc[4 * j + e];
          }
        l[h] = fmaf(l[h], alpha[h], sum);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    };
    auto to_frags = [&]() {
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) frag_of(pa[kk], sc + 8 * kk);
    };

    mbar_wait(&qbar, 0);
    for (int t = 0; t < tiles; ++t) {
      zero_acc(sc);
      wgmma_fence();
      issue_s(t);
      wgmma_wait<0>();
      fence_acc(sc);
      release(kempty, t);
      softmax(t);
      rescale();
      to_frags();
      wgmma_fence();
      issue_pv(t);
      wgmma_wait<0>();
      fence_acc(o);
      keep_live(pa);
      release(vempty, t);
    }

    float* lse_rows = lse + (size_t)bh * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = fmaxf(quad_sum(l[h]), 1e-30f);
      const float inv = 1.f / sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * h] *= inv;
        o[4 * j + 2 * h + 1] *= inv;
      }
      const int row = ra + 8 * h;
      if (tq == 0 && row < n)
        lse_rows[row] = mx[h] == -INFINITY
                            ? kMasked + logf(sum)
                            : fmaf(mx[h] * mul, kLn2, logf(sum));
    }
    if (blind) {  // uniform: the rows that see no key
      const float inv_m = 1.f / m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ra + 8 * h;
        if (row >= n - m) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * h] = vsum[8 * j + 2 * tq] * inv_m;
          o[4 * j + 2 * h + 1] = vsum[8 * j + 2 * tq + 1] * inv_m;
        }
        if (tq == 0) lse_rows[row] = kMasked + logf((float)m);
      }
    }
    store_acc<D>(out + (size_t)bh * n * d, o, ra, n, 1.f, d);
  }
}

// dK/dV's geometry (ops/kernels/flash_attention.py WG_DKV_KEYS,
// WG_DKV_TILE): keys a block, queries a streamed tile, the ring's stages,
// and whether the two warpgroups split the products of the same keys
template <int D>
struct WgDkvGeo {
  static_assert(D == 128 || D == 256, "the Hopper dK/dV's widths");
  static constexpr bool split = D == 256;
  static constexpr int keys = split ? 64 : 128;
  static constexpr int tile = 64;
  static constexpr int stages = 2;
  static constexpr int panels = D / kSw128Cols;
  static constexpr int k_panel = keys * 128;       // bytes
  static constexpr int q_panel = tile * 128;
  static constexpr int q_tile = panels * q_panel;  // Q or dO
  static constexpr size_t bytes =
      1024 + 2 * (size_t)panels * k_panel + 2 * (size_t)stages * q_tile +
      sizeof(float) * (2 * stages * tile + (split ? 64 * tile : 0) + D);
  static_assert(bytes <= kSmemMax, "Hopper dK/dV shared memory");
  static_assert(2 * stages * q_tile >= column_sum_bytes<D, kWgConsumers>(),
                "column_sum's partial sums fit the ring");
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkv_wg_mma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const bf16* __restrict__ bias,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                          int m, int d, int k_tiles, int bias_groups,
                          int causal, float scale) {
  typedef WgDkvGeo<D> G;
  constexpr int T = G::tile;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t kvbar, full[G::stages], empty[G::stages];
  unsigned char* kv = align1024(wg_smem);  // K's boxes, then V's
  unsigned char* ring = kv + 2 * G::panels * G::k_panel;  // a stage: Q, dO
  // a stage's lse (base 2) and delta
  float* rows_s = reinterpret_cast<float*>(ring + 2 * G::stages * G::q_tile);
  float* pt = rows_s + 2 * G::stages * T;  // P^T handed over (split)
  float* dosum = pt + (G::split ? 64 * T : 0);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * G::keys;
  const int offset = m - n;
  const int blind = causal ? n - m : 0;  // rows < blind see no key
  // query tiles first .. tiles - 1: with causal, from the first whose last
  // row sees the block's first key (dkv_query_tiles)
  const int first = causal ? max(0, k0 - offset) / T : 0;
  const int tiles = (n + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&kvbar, 1);
    for (int s = 0; s < G::stages; ++s) {
      mbar_init(&full[s], 32);                   // the producer's lanes
      mbar_init(&empty[s], kWgConsumers / 32);  // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (blind > 0) {  // their dO summed, in the ring before it fills
    column_sum<D, kWgConsumers>(dosum, reinterpret_cast<float*>(ring),
                                dout + (size_t)bh * n * d, blind, d);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {  // the producer warpgroup
    reg_dealloc<kWgProducerRegs>();
    if (warp > kWgConsumers / 32) return;  // one warp loads
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * G::panels * G::k_panel);
      for (int p = 0; p < G::panels; ++p) {
        tma_load_3d(kv + p * G::k_panel, &map_k, &kvbar, p * kSw128Cols, k0,
                    bh);
        tma_load_3d(kv + (G::panels + p) * G::k_panel, &map_v, &kvbar,
                    p * kSw128Cols, k0, bh);
      }
    }
    const float* lse_b = lse + (size_t)bh * n;
    const float* delta_b = delta + (size_t)bh * n;
    for (int t = first; t < tiles; ++t) {
      const int i = t - first, s = i % G::stages, use = i / G::stages;
      // the tile's lse (base 2) and delta, 0 past n, read before the
      // stage is free (a bulk copy would need rows 16-byte aligned, n % 4
      // == 0, and would read past the head's n)
      float r[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = t * T + lane + 32 * h;
        r[h] = row < n ? lse_b[row] * kLog2e : 0.f;
        r[2 + h] = row < n ? delta_b[row] : 0.f;
      }
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      float* rs = rows_s + s * 2 * T;
      rs[lane] = r[0];
      rs[lane + 32] = r[1];
      rs[T + lane] = r[2];
      rs[T + lane + 32] = r[3];
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * G::q_tile);
        unsigned char* st = ring + s * 2 * G::q_tile;
        for (int p = 0; p < G::panels; ++p) {
          tma_load_3d(st + p * G::q_panel, &map_q, &full[s], p * kSw128Cols,
                      t * T, bh);
          tma_load_3d(st + G::q_tile + p * G::q_panel, &map_do, &full[s],
                      p * kSw128Cols, t * T, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {  // two consumer warpgroups
    reg_alloc<kWgConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
    const int kw = G::split ? 0 : 64 * wg;   // the warpgroup's keys
    const int kwarp = k0 + kw + 16 * wq;     // the warp's first key
    const int ka = kwarp + g;                // rows ka and ka + 8
    const bf16* bb =
        bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
    const float scale_log2 = scale * kLog2e;
    const uint64_t kdesc = sw128_desc(kv + kw * 128);
    const uint64_t vdesc = sw128_desc(kv + G::panels * G::k_panel + kw * 128);
    mbar_wait(&kvbar, 0);

    // DV: S^T, P^T and dV; DK: dP^T, dS^T and dK (both unless split)
    auto run = [&](auto dv_tag, auto dk_tag) {
      constexpr bool DV = decltype(dv_tag)::value;
      constexpr bool DK = decltype(dk_tag)::value;
      float acc_v[DV ? D / 2 : 1], acc_k[DK ? D / 2 : 1];
      zero_acc(acc_v);
      zero_acc(acc_k);
      for (int t = first; t < tiles; ++t) {
        const int i = t - first, s = i % G::stages;
        const int q0 = t * T;
        const unsigned char* qt = ring + s * 2 * G::q_tile;
        const unsigned char* dot = qt + G::q_tile;
        const float* lse_s = rows_s + s * 2 * T;
        const float* delta_s = lse_s + T;
        float sc[DV ? T / 2 : 1], dp[DK ? T / 2 : 1];
        zero_acc(sc);
        zero_acc(dp);
        mbar_wait(&full[s], (i / G::stages) & 1);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < G::panels; ++p)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t qd = sw128_desc(qt + p * G::q_panel) + 2 * kk;
            const uint64_t dd = sw128_desc(dot + p * G::q_panel) + 2 * kk;
            const int ko = ((p * G::k_panel) >> 4) + 2 * kk;
            if constexpr (DV) wgmma_bf16(sc, kdesc + ko, qd);
            if constexpr (DK) wgmma_bf16(dp, vdesc + ko, dd);
          }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);
        // element 4j + e is (key ka + 8 (e / 2), query q0 + c), c = 8j +
        // 2tq + e % 2; uniform branches: the bias, the element test of a
        // masked tile. dV's product is issued as soon as P^T is formed.
        const uint64_t qmn = sw128_mn_desc(qt, G::q_panel);
        const uint64_t dmn = sw128_mn_desc(dot, G::q_panel);
        unsigned pa[DV ? T / 16 : 1][4], da[DK ? T / 16 : 1][4];
        if constexpr (DV) {
#pragma unroll
          for (int j = 0; j < T / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * j + e] = fmaf(sc[4 * j + e], scale_log2,
                                   -lse_s[8 * j + 2 * tq + (e & 1)]);
          if (bb)
#pragma unroll
            for (int j = 0; j < T / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = ka + 8 * (e >> 1);
                const int row = q0 + 8 * j + 2 * tq + (e & 1);
                if (row < n && key < m)
                  sc[4 * j + e] = fmaf(to_f32(bb[(size_t)row * m + key]),
                                       kLog2e, sc[4 * j + e]);
              }
          if (tile_masked(q0, T, kwarp, 16, n, m, causal))
#pragma unroll
            for (int j = 0; j < T / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = ka + 8 * (e >> 1);
                const int row = q0 + 8 * j + 2 * tq + (e & 1);
                if (!(row < n && key < m && (!causal || key <= row + offset)))
                  sc[4 * j + e] = -INFINITY;
              }
#pragma unroll
          for (int e = 0; e < T / 2; ++e) sc[e] = exp2_approx(sc[e]);
          if constexpr (G::split) {  // P^T to warpgroup 1, in float32
            if (i > 0) bar_sync(kPEmpty, kWgConsumers);
#pragma unroll
            for (int e = 0; e < T / 2; ++e) pt[e * 128 + tid] = sc[e];
            bar_arrive(kPFull, kWgConsumers);
          }
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk) frag_of(pa[kk], sc + 8 * kk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk)
            wgmma_rs_mn(acc_v, pa[kk], dmn + 128 * kk);
          wgmma_commit();
        }
        if constexpr (DK) {
          if constexpr (!DV) bar_sync(kPFull, kWgConsumers);
#pragma unroll
          for (int j = 0; j < T / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p;
              if constexpr (DV)
                p = sc[4 * j + e];
              else
                p = pt[(4 * j + e) * 128 + tid];
              dp[4 * j + e] = p * (dp[4 * j + e] -
                                   delta_s[8 * j + 2 * tq + (e & 1)]);
            }
          if constexpr (!DV)
            if (t + 1 < tiles) bar_arrive(kPEmpty, kWgConsumers);
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk) frag_of(da[kk], dp + 8 * kk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < T / 16; ++kk)
            wgmma_rs_mn(acc_k, da[kk], qmn + 128 * kk);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_acc(acc_v);
        fence_acc(acc_k);
        if constexpr (DV) keep_live(pa);
        if constexpr (DK) keep_live(da);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      if constexpr (DV) {
        if (blind > 0) {  // dV of the rows that see no key: their dO / m
          const float inv_m = 1.f / m;
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc_v[4 * j + e] += dosum[8 * j + 2 * tq + (e & 1)] * inv_m;
        }
        store_acc<D>(dv + (size_t)bh * m * d, acc_v, ka, m, 1.f, d);
      }
      if constexpr (DK)
        store_acc<D>(dk + (size_t)bh * m * d, acc_k, ka, m, scale, d);
    };
    if constexpr (G::split) {
      if (wg == 0)
        run(std::true_type{}, std::false_type{});
      else
        run(std::false_type{}, std::true_type{});
    } else {
      run(std::true_type{}, std::true_type{});
    }
  }
}

// dQ's geometry (ops/kernels/flash_attention.py WG_DQ_ROWS, WG_DQ_TILE):
// query rows a block, keys a tile, stages of each ring. A consumer thread
// holds dQ (D / 2 floats), S and dP (tile / 2 each) and dS's A fragments
// (tile / 4 words): 144 at D = 128 on 64-key tiles, 168 at 256 on 32-key
// tiles, under the consumers' 240 registers; at 256 Q and dO take 128 KB.
template <int D>
struct WgDqGeo {
  static_assert(D == 128 || D == 256, "the Hopper dQ's widths");
  static constexpr int rows = 128;
  static constexpr int tile = D == 128 ? 64 : 32;
  static constexpr int stages = 2;
  static constexpr int panels = D / kSw128Cols;  // 64-column boxes a row
  static constexpr int q_panel = rows * 128;     // bytes
  static constexpr int kv_panel = tile * 128;
  static constexpr int kv_tile = panels * kv_panel;
  static constexpr size_t bytes =
      1024 + 2 * (size_t)panels * q_panel + 2 * (size_t)stages * kv_tile;
  static_assert(bytes <= kSmemMax, "Hopper dQ shared memory");
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dq_wg_mma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const bf16* __restrict__ bias,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, float* __restrict__ dbias,
                         int n, int m, int d, int q_tiles, int bias_groups,
                         int causal, float scale) {
  typedef WgDqGeo<D> G;
  constexpr int T = G::tile, NB = T / 8;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t qbar, kfull[G::stages],
      kempty[G::stages], vfull[G::stages], vempty[G::stages];
  unsigned char* qs = align1024(wg_smem);
  unsigned char* dos = qs + G::panels * G::q_panel;
  unsigned char* ks = dos + G::panels * G::q_panel;
  unsigned char* vs = ks + G::stages * G::kv_tile;

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (q_tiles - 1 - blockIdx.x % q_tiles) * G::rows;
  const int offset = m - n;
  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles)
  const int k_end = causal ? min(m, min(q0 + G::rows, n) + offset) : m;
  const int tiles = (max(k_end, 0) + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < G::stages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], kWgConsumers / 32);  // a consumer warp each
      mbar_init(&vempty[s], kWgConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {  // the producer warpgroup
    reg_dealloc<kWgProducerRegs>();
    if (warp == kWgConsumers / 32 && lane == 0) {
      mbar_expect_tx(&qbar, 2 * G::panels * G::q_panel);
      for (int p = 0; p < G::panels; ++p) {
        tma_load_3d(qs + p * G::q_panel, &map_q, &qbar, p * kSw128Cols, q0,
                    bh);
        tma_load_3d(dos + p * G::q_panel, &map_do, &qbar, p * kSw128Cols,
                    q0, bh);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % G::stages, use = t / G::stages;
        if (use > 0) mbar_wait(&kempty[s], (use - 1) & 1);
        mbar_expect_tx(&kfull[s], G::kv_tile);
        for (int p = 0; p < G::panels; ++p)
          tma_load_3d(ks + s * G::kv_tile + p * G::kv_panel, &map_k,
                      &kfull[s], p * kSw128Cols, t * T, bh);
        if (use > 0) mbar_wait(&vempty[s], (use - 1) & 1);
        mbar_expect_tx(&vfull[s], G::kv_tile);
        for (int p = 0; p < G::panels; ++p)
          tma_load_3d(vs + s * G::kv_tile + p * G::kv_panel, &map_v,
                      &vfull[s], p * kSw128Cols, t * T, bh);
      }
    }
  } else {  // two consumer warpgroups, 64 query rows each
    reg_alloc<kWgConsumerRegs>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
    const int w0 = q0 + 64 * wg + 16 * wq;  // the warp's first row
    const int ra = w0 + g;
    const bf16* bb =
        bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
    float* dbb = dbias ? dbias + (size_t)bh * n * m : nullptr;
    const float scale_log2 = scale * kLog2e;
    // lse (base 2) and delta of rows ra and ra + 8, 0 past n
    float lse2[2], del[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ra + 8 * h;
      lse2[h] = row < n ? lse[(size_t)bh * n + row] * kLog2e : 0.f;
      del[h] = row < n ? delta[(size_t)bh * n + row] : 0.f;
    }
    const uint64_t qdesc = sw128_desc(qs + 64 * wg * 128);
    const uint64_t ddesc = sw128_desc(dos + 64 * wg * 128);
    float acc[D / 2];
    zero_acc(acc);
    auto release = [&](uint64_t* bars, int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[s]);
    };

    mbar_wait(&qbar, 0);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % G::stages, parity = (t / G::stages) & 1;
      const int k0 = t * T;
      const unsigned char* kt = ks + s * G::kv_tile;
      const uint64_t kdesc = sw128_desc(kt);
      const uint64_t vdesc = sw128_desc(vs + s * G::kv_tile);
      float sc[T / 2], dp[T / 2];  // S, then P, then dS; dP
      zero_acc(sc);
      zero_acc(dp);
      mbar_wait(&kfull[s], parity);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < G::panels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16(sc, qdesc + ((p * G::q_panel) >> 4) + 2 * kk,
                     kdesc + ((p * G::kv_panel) >> 4) + 2 * kk);
      wgmma_commit();
      mbar_wait(&vfull[s], parity);
#pragma unroll
      for (int p = 0; p < G::panels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16(dp, ddesc + ((p * G::q_panel) >> 4) + 2 * kk,
                     vdesc + ((p * G::kv_panel) >> 4) + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // S is in; dP may still run
      fence_acc(sc);
      // element 4j + e is (row ra + 8 (e / 2), key k0 + 8j + 2tq + e % 2);
      // uniform branches: the bias, and the element test of a masked tile
#pragma unroll
      for (int e = 0; e < T / 2; ++e)
        sc[e] = fmaf(sc[e], scale_log2, -lse2[(e >> 1) & 1]);
      if (bb)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (row < n && col < m)
              sc[4 * j + e] = fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e,
                                   sc[4 * j + e]);
          }
      if (tile_masked(w0, 16, k0, T, n, m, causal))
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (!(row < n && col < m && (!causal || col <= row + offset)))
              sc[4 * j + e] = -INFINITY;
          }
#pragma unroll
      for (int e = 0; e < T / 2; ++e) sc[e] = exp2_approx(sc[e]);
      wgmma_wait<0>();
      fence_acc(dp);
      release(vempty, s);
#pragma unroll
      for (int e = 0; e < T / 2; ++e)
        sc[e] *= dp[e] - del[(e >> 1) & 1];
      unsigned da[T / 16][4];
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) frag_of(da[kk], sc + 8 * kk);
      wgmma_fence();
      const uint64_t kmn = sw128_mn_desc(kt, G::kv_panel);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs_mn(acc, da[kk], kmn + 128 * kk);
      wgmma_commit();
      if (dbb)  // dS as d_bias while dQ's product runs
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (row < n && col < m) dbb[(size_t)row * m + col] = sc[4 * j + e];
          }
      wgmma_wait<0>();
      fence_acc(acc);
      keep_live(da);
      release(kempty, s);
    }
    store_acc<D>(dq + (size_t)bh * n * d, acc, ra, n, scale, d);
    // dS of the key tiles the causal skip passed over is 0
    const int skipped = m - tiles * T;
    if (dbb && skipped > 0)
      for (int r = threadIdx.x / 32; r < G::rows; r += kWgConsumers / 32) {
        if (q0 + r >= n) break;
        float* row = dbb + (size_t)(q0 + r) * m + (m - skipped);
        for (int c = lane; c < skipped; c += 32) row[c] = 0.f;
      }
  }
}

// ---- heads of 257 to 512: the Hopper wide forward, dQ and dK/dV ('mma') --
//
// A head of 257 to 512 values runs its three kernels here, built at
// D = kWgWideMax with the true d at run time. The block is the Hopper
// kernels' (kWgThreads: a producer
// warpgroup whose one warp keeps TMA loads in flight, two consumer
// warpgroups at kWgConsumerRegs after setmaxnreg), but no warpgroup can
// hold 64 rows x 512 float32 accumulators (256 a thread): both consumer
// warpgroups own the same 64 rows, and warpgroup c owns output columns
// [kWgWideHalf c, kWgWideHalf (c + 1)), 128 floats a thread.
// With `exchange` in a geometry the scores are formed once a block:
// warpgroup c multiplies panels [P c / 2, P (c + 1) / 2) of the P = D / 64
// column panels (a head under 512 multiplies zero panels past its d, as
// TMA fills them), writes its partial sum to shared memory in float32 and
// adds the other's (named barriers kXFull: both partials are in, kXFree +
// c: c's buffer is free again); without it each warpgroup forms the whole
// scores itself, with no barrier between them. Either way both hold the
// same scores (a + b == b + a), run the same softmax on them, and multiply
// P or dS (P^T or dS^T in dK/dV) from registers by their own columns of the
// streamed tile, read MN-major:
//   forward  S = Q K^T (both from shared memory, K-major), the online
//            softmax of fwd_wg_mma_kernel, O += P V; warpgroup 0 alone
//            writes lse. A block owns 64 query rows, heaviest first; Q
//            arrives once (64 KB at D = 512), K and V tiles of
//            WgWideFwdGeo::tile keys through rings of their own. Each
//            warpgroup forms the whole S: in turns on the card the
//            exchange read slower here (PERF.md section 6).
//   dK/dV    a block owns 64 keys and one accumulator, grid z 0 dV, 1 dK,
//            as the wide kernels below. S^T = K Q^T (and dP^T = V dO^T in
//            the dK block), P^T and dS^T as bwd_dkv_wg_mma_kernel, dV +=
//            P^T dO or dK += dS^T Q. K arrives once (and V in the dK
//            block); Q and dO tiles of WgWideDkvGeo::tile queries, with
//            their lse and delta, through one ring.
//   dQ       a block owns 64 query rows, heaviest first; Q and dO arrive
//            once (64 KB each at D = 512), K and V tiles of
//            WgWideDqGeo::tile keys through rings of their own, K's two
//            stages deep. S = Q K^T and dP = dO V^T (both from shared
//            memory, K-major); their partial sums go over the V stage dP
//            read (exchange_in_stage: a warpgroup's S and dP fill the half
//            its dP read), which leaves room for K's second stage at
//            32-key tiles. P and dS = P (dP - delta) as
//            bwd_dq_wg_mma_kernel, dQ += dS K with dS in registers and the
//            warpgroup's columns of K's box read MN-major; warpgroup 0
//            alone writes dS as d_bias, from its accumulators while dQ's
//            product runs. Without the exchange S and dP are two commit
//            groups and P is formed while dP runs.
// tools/flash_heads_probe.py times both ways for all three kernels. The
// products against the narrow decomposition's: the forward 1.5x (S in
// both warpgroups), dK/dV 5/4 (S in both blocks), dQ 1x with the exchange
// and 5/3 without, as against 1.5x, 2x and 5/3 on the wide kernels, which
// also re-read their own rows from L2 a tile.
// Masking, the bias, the causal skip, the rows that see no key and the dead
// rows are the Hopper kernels'; one owner per output tile, no atomics.
// What bounds them on the H100: operations, as the Hopper kernels'.

constexpr int kWgWideMax = 512;               // the widest head here
constexpr int kWgWideHalf = kWgWideMax / 2;   // output columns a warpgroup
constexpr int kXFull = 3, kXFree = 4;         // named barriers (kXFree + c)
constexpr int kWgRetired = 6;                 // named barriers (+ c), dQ

// The wide forward's geometry (ops/kernels/flash_attention.py
// WG_WIDE_FWD_ROWS, WG_WIDE_FWD_TILE, WG_WIDE_FWD_EXCHANGE): query rows a
// block, keys a tile, stages of each ring, and whether S comes from two
// partial sums
struct WgWideFwdGeo {
  static constexpr int D = kWgWideMax;
  static constexpr int rows = 64;
  static constexpr int tile = 32;
  static constexpr int stages = 2;
  static constexpr bool exchange = false;
  static constexpr int panels = D / kSw128Cols;   // 64-column boxes a row
  static constexpr int q_panel = rows * 128;      // bytes
  static constexpr int kv_panel = tile * 128;
  static constexpr int kv_tile = panels * kv_panel;
  static constexpr int xfloats = exchange ? 2 * rows * tile : 0;
  static constexpr size_t bytes = 1024 + (size_t)panels * q_panel +
                                  2 * (size_t)stages * kv_tile +
                                  sizeof(float) * (xfloats + D);
  static_assert(bytes <= kSmemMax, "wide Hopper forward shared memory");
  static_assert(stages * kv_tile >= column_sum_bytes<D, kWgConsumers>(),
                "column_sum's partial sums fit the K ring");
};

// dK/dV's geometry (WG_WIDE_DKV_KEYS, WG_WIDE_DKV_TILE,
// WG_WIDE_DKV_EXCHANGE): keys a block, queries a streamed tile, the ring's
// stages, and whether S (and dP) come from two partial sums
struct WgWideDkvGeo {
  static constexpr int D = kWgWideMax;
  static constexpr int keys = 64;
  static constexpr int tile = 16;
  static constexpr int stages = 2;
  static constexpr bool exchange = true;
  static constexpr int panels = D / kSw128Cols;
  static constexpr int k_panel = keys * 128;       // bytes
  static constexpr int q_panel = tile * 128;
  static constexpr int q_tile = panels * q_panel;  // Q or dO
  static constexpr int xfloats = exchange ? 4 * keys * tile : 0;  // S, dP
  static constexpr size_t bytes =
      1024 + 2 * (size_t)panels * k_panel + 2 * (size_t)stages * q_tile +
      sizeof(float) * (2 * stages * tile + xfloats + D);
  static_assert(bytes <= kSmemMax, "wide Hopper dK/dV shared memory");
  static_assert(2 * stages * q_tile >= column_sum_bytes<D, kWgConsumers>(),
                "column_sum's partial sums fit the ring");
  static_assert(tile <= 32, "a producer lane stages a query's lse, delta");
};

// dQ's geometry (WG_WIDE_DQ_ROWS, WG_WIDE_DQ_TILE, WG_WIDE_DQ_EXCHANGE):
// query rows a block, keys a tile, the stages of K's ring and of V's, and
// whether S and dP come from two partial sums (exchanged over the V stage
// they were formed from: a warpgroup's S and dP partials fill the half of
// it that its dP read). A consumer thread holds its 256 columns of dQ (128
// floats), S and dP (tile / 2 each) and dS's A fragments.
struct WgWideDqGeo {
  static constexpr int D = kWgWideMax;
  static constexpr int rows = 64;
  static constexpr int tile = 32;
  static constexpr int k_stages = 2;
  static constexpr int v_stages = 1;
  static constexpr bool exchange = true;
  static constexpr bool v_first = false;
  static constexpr int panels = D / kSw128Cols;
  static constexpr int q_panel = rows * 128;       // bytes
  static constexpr int kv_panel = tile * 128;
  static constexpr int kv_tile = panels * kv_panel;
  static constexpr size_t bytes = 1024 + 2 * (size_t)panels * q_panel +
                                  (size_t)(k_stages + v_stages) * kv_tile;
  static_assert(bytes <= kSmemMax, "wide Hopper dQ shared memory");
  static_assert(2 * sizeof(float) * rows * tile == panels / 2 * kv_panel,
                "a warpgroup's S and dP partials fill its half of V's stage");
};

// acc[e] of this thread (tid of warpgroup wg) plus the other warpgroup's,
// through buffers of `count` floats a warpgroup in shared memory; `first`
// and `last`: the loop's first and last tile
template <int N>
__device__ __forceinline__ void exchange_sum(float (&acc)[N], float* xs,
                                             int count, int wg, int tid,
                                             bool first, bool last) {
  float* mine = xs + wg * count;
  const float* theirs = xs + (1 - wg) * count;
  if (!first) bar_sync(kXFree + wg, kWgConsumers);
#pragma unroll
  for (int e = 0; e < N; ++e) mine[e * 128 + tid] = acc[e];
  bar_sync(kXFull, kWgConsumers);
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] += theirs[e * 128 + tid];
  if (!last) bar_arrive(kXFree + 1 - wg, kWgConsumers);
}

// the same for two accumulators at once (the dK block's S and dP)
template <int N>
__device__ __forceinline__ void exchange_sum(float (&a)[N], float (&b)[N],
                                             float* xs, int count, int wg,
                                             int tid, bool first, bool last) {
  float* mine = xs + wg * count;
  const float* theirs = xs + (1 - wg) * count;
  if (!first) bar_sync(kXFree + wg, kWgConsumers);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    mine[e * 128 + tid] = a[e];
    mine[(N + e) * 128 + tid] = b[e];
  }
  bar_sync(kXFull, kWgConsumers);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    a[e] += theirs[e * 128 + tid];
    b[e] += theirs[(N + e) * 128 + tid];
  }
  if (!last) bar_arrive(kXFree + 1 - wg, kWgConsumers);
}

// a and b of this thread plus the other warpgroup's, through the stage of
// shared memory the two partial products read their B operand from:
// warpgroup wg writes its partials over its own half of the stage (`mine`,
// which only its products read) once all four of its warps have retired
// them, and reads the other's from `theirs`. The caller gives the stage back
// to the producer after; the fence orders these accesses before TMA's
// next writes to it.
template <int N>
__device__ __forceinline__ void exchange_in_stage(float (&a)[N],
                                                  float (&b)[N], float* mine,
                                                  const float* theirs, int wg,
                                                  int tid) {
  bar_sync(kWgRetired + wg, 128);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    mine[e * 128 + tid] = a[e];
    mine[(N + e) * 128 + tid] = b[e];
  }
  bar_sync(kXFull, kWgConsumers);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    a[e] += theirs[e * 128 + tid];
    b[e] += theirs[(N + e) * 128 + tid];
  }
  fence_proxy_async();
}

// ---- heads of 513 to 1024: the Hopper wide blocks in 2-block clusters -----
//
// A bf16 head of 513 to 1024 values runs its three kernels on the bodies
// of the wide forward, dK/dV and dQ, built for clusters of C =
// kPairCluster blocks (fwd_wg_pair_kernel, bwd_dkv_wg_pair_kernel,
// bwd_dq_wg_pair_kernel; C = 1 is the wide block alone). One
// block cannot own such a head: 64 rows x 1024 float32 output accumulators
// are the whole register file of an SM, and Q of 64 rows beside one K and
// one V tile of 32 keys is past kSmemMax. So the two blocks of a cluster
// (a cluster launch through cudaLaunchKernelEx) split the head: cluster
// rank r owns head columns [kWgWideMax r, kWgWideMax (r + 1)), which its
// TMA boxes load (zeros past d) and its output takes, and is the wide
// block on them, with its geometry (WgWideFwdGeo, WgWideDkvGeo) and an
// inbox for its peer's partial scores (WgPairFwdGeo, WgPairDkvGeo); dQ's
// wide block leaves no room for an inbox beside its rings, so a pair's dQ
// block takes stages of its own (WgPairDqGeo).
// The scores (and dP) are sums over the whole head: each block forms the
// partial sum over its own columns as the wide block forms its scores,
// pushes one copy into its peer's shared memory and adds the peer's copy
// from its own: own + peer in one block, peer + own in the other, which
// a + b == b + a makes bit for bit alike, so all four warpgroups run the
// same softmax on the same scores: the same row max, P, dS and lse.
// The hand-off (PairInbox): `buffers` inbox buffers of `pfloats` floats a
// block, element e of consumer thread tid at e * 128 + tid. The consumer
// threads write buffer b of the peer by st.async (an address from mapa),
// each store completing its bytes on the peer's pfull[b] mbarrier, which
// the peer's thread 0 arms with the bytes it expects; the peer waits on
// pfull[b], adds the buffer, and once all its consumer threads have read
// it (named barrier kPairRead) its thread 0 arrives on the writer's
// pread[b] (release at cluster scope), which the writer waits on before it
// writes buffer b again. The stores neither wait nor fence: in turns on the
// card, st.shared::cluster with a release arrival from every warp took as
// long again as the kernel without a hand-off (PERF.md section 6). The
// forward sends tile t + 1's partial before it adds the peer's of tile t
// (two buffers), so the peer's copy has a tile's time to arrive; dK/dV
// sends and adds in step (one buffer); dQ sends S and dP together as
// WgPairDqGeo says. Only the consumer warps take part:
// the producer warpgroup never waits on the peer. Both blocks take the
// same tiles (the causal skip, the masked tiles and the rows that see no
// key depend on the rows or keys a cluster owns, not on its rank), so
// every push meets its wait. A cluster barrier replaces the block barrier
// after the mbarriers are initialised (no remote arrival before), and
// another ends the kernel: no block leaves while its peer may still write
// or arrive in its shared memory. Rank 0 alone writes the forward's lse
// and dQ's d_bias (warpgroup 0, and the zeros of the tiles the causal skip
// passes over); the rows that see no key sum v (dO in dV) on each block's
// own columns, and get dq = 0 from P = 0.
// The products against the narrow decomposition's: the forward 1.5x (S in
// both warpgroups), dK/dV 5/4 and dQ 1x, as at 512, against 2.5x, about
// 3.5x and 3x on the wide kernels, whose four column chunks each form the
// whole S (and dP).

constexpr int kWgPairMax = 2 * kWgWideMax;  // the widest head here
constexpr int kPairCluster = 2;             // blocks a cluster

// A block of the paired forward: the wide forward's block
// (ops/kernels/flash_attention.py WG_WIDE_FWD_*) and the inbox buffers of
// the peer's partial S (WG_PAIR_FWD_BUFFERS; two: a block sends tile
// t + 1's partial before it adds the peer's of tile t)
struct WgPairFwdGeo : WgWideFwdGeo {
  static constexpr int buffers = 2;
  static constexpr int pfloats = rows * tile;     // an inbox buffer
  static constexpr size_t bytes =
      WgWideFwdGeo::bytes + sizeof(float) * buffers * pfloats;
  static_assert(bytes <= kSmemMax, "paired Hopper forward shared memory");
};

// A block of the paired dK/dV: the wide dK/dV's block (WG_WIDE_DKV_*) and
// the inbox buffers of the peer's partial S^T and dP^T
// (WG_PAIR_DKV_BUFFERS; one fits beside the ring)
struct WgPairDkvGeo : WgWideDkvGeo {
  static constexpr int buffers = 1;
  static constexpr int pfloats = 2 * keys * tile;  // an inbox buffer
  static constexpr size_t bytes =
      WgWideDkvGeo::bytes + sizeof(float) * buffers * pfloats;
  static_assert(bytes <= kSmemMax, "paired Hopper dK/dV shared memory");
};

// A block of the paired dQ: the wide dQ's block (WG_WIDE_DQ_ROWS, S and dP
// from the two warpgroups' partial sums over V's stage) on key tiles and
// stages of its own (WG_PAIR_DQ_TILE, WG_PAIR_DQ_K_STAGES,
// WG_PAIR_DQ_V_STAGES), which leave room for the inbox buffers of the
// peer's partial S and dP (WG_PAIR_DQ_BUFFERS), sent and added in step;
// `v_first`: V's stage, which the exchange frees before dQ's product frees
// K's, is loaded and multiplied first
struct WgPairDqGeo : WgWideDqGeo {
  static constexpr int tile = 32;
  static constexpr int k_stages = 1;
  static constexpr int v_stages = 1;
  static constexpr int buffers = 2;
  static constexpr bool exchange = true;
  static constexpr bool v_first = true;
  static constexpr int kv_panel = tile * 128;
  static constexpr int kv_tile = panels * kv_panel;
  static constexpr int pfloats = 2 * rows * tile;  // an inbox buffer
  static constexpr size_t bytes = 1024 + 2 * (size_t)panels * q_panel +
                                  (size_t)(k_stages + v_stages) * kv_tile +
                                  sizeof(float) * buffers * pfloats;
  static_assert(bytes <= kSmemMax, "paired Hopper dQ shared memory");
  static_assert(2 * sizeof(float) * rows * tile == panels / 2 * kv_panel,
                "a warpgroup's S and dP partials fill its half of V's stage");
};

constexpr int kPairRead = 8;  // named barrier: the consumers read the inbox

// Into the peer's inbox buffer at `dst`: a's elements, half from each
// warpgroup, each completing its bytes on the peer's pfull barrier at `full`
// (cluster addresses)
template <int N>
__device__ __forceinline__ void pair_send(unsigned dst, unsigned full,
                                          const float (&a)[N], int wg,
                                          int tid) {
#pragma unroll
  for (int e = 0; e < N; ++e)
    if ((2 * e < N) == (wg == 0))
      st_async(dst + 4u * (e * 128 + tid), a[e], full);
}

// the same for two accumulators: a from warpgroup 0, b from warpgroup 1
template <int N>
__device__ __forceinline__ void pair_send(unsigned dst, unsigned full,
                                          const float (&a)[N],
                                          const float (&b)[N], int wg,
                                          int tid) {
#pragma unroll
  for (int e = 0; e < N; ++e)
    st_async(dst + 4u * ((wg * N + e) * 128 + tid), wg == 0 ? a[e] : b[e],
             full);
}

// Once this block's pfull barrier `full` has completed the phase of
// `parity` (thread 0 arms it with the bytes the peer sends), a += the
// peer's copy in this block's inbox buffer `src`; then, once every consumer
// thread has read it, thread 0 arrives on the peer's pread barrier at
// `read` (a cluster address)
template <int N>
__device__ __forceinline__ void pair_receive(float (&a)[N], const float* src,
                                             uint64_t* full, unsigned parity,
                                             unsigned read, int tid) {
  if (threadIdx.x == 0) mbar_expect_tx(full, 4 * 128 * N);
  mbar_wait_cluster(full, parity);
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] += src[e * 128 + tid];
  bar_sync(kPairRead, kWgConsumers);
  if (threadIdx.x == 0) mbar_arrive_cluster(read);
}

// the same for two accumulators: b += the buffer's second half
template <int N>
__device__ __forceinline__ void pair_receive(float (&a)[N], float (&b)[N],
                                             const float* src,
                                             uint64_t* full, unsigned parity,
                                             unsigned read, int tid) {
  if (threadIdx.x == 0) mbar_expect_tx(full, 2 * 4 * 128 * N);
  mbar_wait_cluster(full, parity);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    a[e] += src[e * 128 + tid];
    b[e] += src[(N + e) * 128 + tid];
  }
  bar_sync(kPairRead, kWgConsumers);
  if (threadIdx.x == 0) mbar_arrive_cluster(read);
}

// The inbox of a pair: B buffers of P floats in this block's shared memory
// with their barriers pfull and pread, and the same in the peer, mapped;
// B = 0: a block without a peer, which maps nothing
template <int B, int P>
struct PairInbox {
  const float* mine;
  uint64_t* full;
  uint64_t* read;
  unsigned peer, peer_full, peer_read;  // cluster addresses

  __device__ __forceinline__ PairInbox(const float* inbox, uint64_t* pfull,
                                       uint64_t* pread, unsigned rank)
      : mine(inbox), full(pfull), read(pread),
        peer(B ? cluster_map(inbox, rank ^ 1u) : 0u),
        peer_full(B ? cluster_map(pfull, rank ^ 1u) : 0u),
        peer_read(B ? cluster_map(pread, rank ^ 1u) : 0u) {}

  // a (and b) to the peer at step i: the peer's buffer i % B is written
  // once the peer has read its step i - B
  template <int N>
  __device__ __forceinline__ void send(int i, const float (&a)[N], int wg,
                                       int tid) {
    const int k = i % B;
    if (i >= B) mbar_wait_cluster(&read[k], (i / B - 1) & 1);
    pair_send(peer + 4u * k * P, peer_full + 8u * k, a, wg, tid);
  }
  template <int N>
  __device__ __forceinline__ void send(int i, const float (&a)[N],
                                       const float (&b)[N], int wg,
                                       int tid) {
    const int k = i % B;
    if (i >= B) mbar_wait_cluster(&read[k], (i / B - 1) & 1);
    pair_send(peer + 4u * k * P, peer_full + 8u * k, a, b, wg, tid);
  }
  // the peer's step i added to a (and b)
  template <int N>
  __device__ __forceinline__ void receive(int i, float (&a)[N], int tid) {
    const int k = i % B;
    pair_receive(a, mine + k * P, &full[k], (i / B) & 1, peer_read + 8u * k,
                 tid);
  }
  template <int N>
  __device__ __forceinline__ void receive(int i, float (&a)[N],
                                          float (&b)[N], int tid) {
    const int k = i % B;
    pair_receive(a, b, mine + k * P, &full[k], (i / B) & 1,
                 peer_read + 8u * k, tid);
  }
};

// the inbox barriers: pfull completes on its local arming and the peer's
// bytes, pread on one arrival from the peer
template <int B>
__device__ __forceinline__ void pair_init(uint64_t* pfull, uint64_t* pread) {
  for (int b = 0; b < B; ++b) {
    mbar_init(&pfull[b], 1);
    mbar_init(&pread[b], 1);
  }
}

// The wide forward of one block: alone (C = 1) or rank r of a pair (C =
// kPairCluster) on head columns [kWgWideMax r, kWgWideMax (r + 1))
template <int C>
__device__ __forceinline__ void fwd_wg_block(
    const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const bf16* __restrict__ v,
    const bf16* __restrict__ bias, bf16* __restrict__ out,
    float* __restrict__ lse, int n, int m, int d, int q_tiles,
    int bias_groups, int causal, float scale) {
  typedef WgWideFwdGeo G;
  typedef WgPairFwdGeo PG;  // a pair's inbox
  constexpr bool pair = C > 1;
  constexpr int T = G::tile, NB = T / 8, H = kWgWideHalf;
  // the panels of a warpgroup's partial S
  constexpr int PW = G::exchange ? G::panels / 2 : G::panels;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t qbar, kfull[G::stages],
      kempty[G::stages], vfull[G::stages], vempty[G::stages],
      pfull[PG::buffers], pread[PG::buffers];
  unsigned char* qs = align1024(wg_smem);
  unsigned char* ks = qs + G::panels * G::q_panel;
  unsigned char* vs = ks + G::stages * G::kv_tile;
  float* xs = reinterpret_cast<float*>(vs + G::stages * G::kv_tile);
  float* inbox = xs + G::xfloats;  // the peer's partial S
  float* vsum = inbox + (pair ? PG::buffers * PG::pfloats : 0);

  const unsigned rank = pair ? cluster_rank() : 0u;
  const int cb = G::D * rank;        // the block's first head column
  const unsigned block = blockIdx.x / C;  // the cluster's index
  const int bh = block / q_tiles;
  const int q0 = (q_tiles - 1 - block % q_tiles) * G::rows;
  const int offset = m - n;
  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles); the same in both blocks of a pair
  const int k_end = causal ? min(m, min(q0 + G::rows, n) + offset) : m;
  const int tiles = (max(k_end, 0) + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool blind = causal && q0 < n - m;  // rows that see no key

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < G::stages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], kWgConsumers / 32);  // a consumer warp each
      mbar_init(&vempty[s], kWgConsumers / 32);
    }
    if constexpr (pair) pair_init<PG::buffers>(pfull, pread);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (blind) {  // their mean of v on the block's columns, in the K ring
    column_sum<G::D, kWgConsumers>(vsum, reinterpret_cast<float*>(ks),
                                   v + (size_t)bh * m * d + cb, m,
                                   pair ? min(d - cb, G::D) : d, d);
    fence_proxy_async();
  }
  if constexpr (pair)
    cluster_sync();
  else
    __syncthreads();

  if (warp >= kWgConsumers / 32) {  // the producer warpgroup
    reg_dealloc<kWgProducerRegs>();
    if (warp == kWgConsumers / 32 && lane == 0) {
      mbar_expect_tx(&qbar, G::panels * G::q_panel);
      for (int p = 0; p < G::panels; ++p)
        tma_load_3d(qs + p * G::q_panel, map_q, &qbar, cb + p * kSw128Cols,
                    q0, bh);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % G::stages, use = t / G::stages;
        if (use > 0) mbar_wait(&kempty[s], (use - 1) & 1);
        mbar_expect_tx(&kfull[s], G::kv_tile);
        for (int p = 0; p < G::panels; ++p)
          tma_load_3d(ks + s * G::kv_tile + p * G::kv_panel, map_k,
                      &kfull[s], cb + p * kSw128Cols, t * T, bh);
        if (use > 0) mbar_wait(&vempty[s], (use - 1) & 1);
        mbar_expect_tx(&vfull[s], G::kv_tile);
        for (int p = 0; p < G::panels; ++p)
          tma_load_3d(vs + s * G::kv_tile + p * G::kv_panel, map_v,
                      &vfull[s], cb + p * kSw128Cols, t * T, bh);
      }
    }
  } else {  // two consumer warpgroups on the same 64 rows
    reg_alloc<kWgConsumerRegs>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
    const int tid = threadIdx.x % 128;
    const int w0 = q0 + 16 * wq;  // the warp's first row
    const int ra = w0 + g;
    const int c0 = H * wg;        // the warpgroup's first column of the block
    const int p0 = G::exchange ? PW * wg : 0;  // its first score panel
    const bf16* bb =
        bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
    // as fwd_wg_mma_kernel: the row max on the raw scores and the scale
    // folded into the exponent, unless a bias or a scale <= 0 asks for the
    // scores in base-2 units first
    const float scale_log2 = scale * kLog2e;
    const bool pre = bb != nullptr || !(scale > 0.f);
    const float mul = pre ? 1.f : scale_log2;
    const uint64_t qdesc = sw128_desc(qs + p0 * G::q_panel);
    PairInbox<pair ? PG::buffers : 0, PG::pfloats> box(inbox, pfull, pread,
                                                        rank);
    float o[H / 2];
    zero_acc(o);
    // running max (base 2) and the lane's part of l, of rows ra and ra + 8
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float sc[T / 2];          // S, then P in float32
    float sn[T / 2];          // a pair's next partial S
    unsigned pa[T / 16][4];   // P as the A operand of P V
    // the block's S (a pair's partial S) of tile t into acc, K's stage
    // given back; a pair sends it to the peer
    auto scores = [&](int t, float (&acc)[T / 2]) {
      const int s = t % G::stages;
      zero_acc(acc);
      mbar_wait(&kfull[s], (t / G::stages) & 1);
      wgmma_fence();
      const uint64_t kdesc =
          sw128_desc(ks + s * G::kv_tile + p0 * G::kv_panel);
#pragma unroll
      for (int p = 0; p < PW; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16(acc, qdesc + ((p * G::q_panel) >> 4) + 2 * kk,
                     kdesc + ((p * G::kv_panel) >> 4) + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kempty[s]);
      if constexpr (G::exchange)
        exchange_sum(acc, xs, G::rows * T, wg, tid, t == 0, t + 1 == tiles);
      if constexpr (pair) box.send(t, acc, wg, tid);
    };

    mbar_wait(&qbar, 0);
    if (pair && tiles > 0) scores(0, sc);
    for (int t = 0; t < tiles; ++t) {
      const int s = t % G::stages, parity = (t / G::stages) & 1;
      const int k0 = t * T;
      if constexpr (pair) {
        if (t + 1 < tiles) scores(t + 1, sn);  // sent a tile ahead
        box.receive(t, sc, tid);               // S = own + peer
      } else {
        scores(t, sc);
      }

      // the online softmax: element 4j + e is (row ra + 8 (e / 2), key k0 +
      // 8j + 2tq + e % 2); uniform branches: the bias, and the element test
      // of a masked tile
      if (pre)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            float& x = sc[4 * j + e];
            x *= scale_log2;
            if (bb && row < n && col < m)
              x = fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e, x);
          }
      if (tile_masked(w0, 16, k0, T, n, m, causal))
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (!(row < n && col < m && (!causal || col <= row + offset)))
              sc[4 * j + e] = -INFINITY;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NB; ++j)
          cmax = fmaxf(cmax, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
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
            sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], mul, -base));
            sum += sc[4 * j + e];
          }
        l[h] = fmaf(l[h], alpha, sum);
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          o[4 * j + 2 * h] *= alpha;
          o[4 * j + 2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) frag_of(pa[kk], sc + 8 * kk);

      // O += P V on the warpgroup's columns of the V tile, read MN-major
      mbar_wait(&vfull[s], parity);
      wgmma_fence();
      const uint64_t vdesc = sw128_mn_desc(
          vs + s * G::kv_tile + (c0 / kSw128Cols) * G::kv_panel,
          G::kv_panel);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs_mn(o, pa[kk], vdesc + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      keep_live(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&vempty[s]);
      if constexpr (pair)
#pragma unroll
        for (int e = 0; e < T / 2; ++e) sc[e] = sn[e];
    }

    float* lse_rows = lse + (size_t)bh * n;
    const bool writes_lse = rank == 0 && wg == 0 && tq == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = fmaxf(quad_sum(l[h]), 1e-30f);
      const float inv = 1.f / sum;
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        o[4 * j + 2 * h] *= inv;
        o[4 * j + 2 * h + 1] *= inv;
      }
      const int row = ra + 8 * h;
      if (writes_lse && row < n)
        lse_rows[row] = mx[h] == -INFINITY
                            ? kMasked + logf(sum)
                            : fmaf(mx[h] * mul, kLn2, logf(sum));
    }
    if (blind) {  // uniform: the rows that see no key
      const float inv_m = 1.f / m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ra + 8 * h;
        if (row >= n - m) continue;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          o[4 * j + 2 * h] = vsum[c0 + 8 * j + 2 * tq] * inv_m;
          o[4 * j + 2 * h + 1] = vsum[c0 + 8 * j + 2 * tq + 1] * inv_m;
        }
        if (writes_lse) lse_rows[row] = kMasked + logf((float)m);
      }
    }
    store_acc<H>(out + (size_t)bh * n * d + cb + c0, o, ra, n, 1.f,
                 d - cb - c0, d);
  }
  if constexpr (pair) cluster_sync();  // the peer may still write here
}

#define MV2_FWD_WG_PARAMS                                                 \
  const __grid_constant__ CUtensorMap map_q,                              \
      const __grid_constant__ CUtensorMap map_k,                          \
      const __grid_constant__ CUtensorMap map_v, const bf16 *__restrict__ v, \
      const bf16 *__restrict__ bias, bf16 *__restrict__ out,              \
      float *__restrict__ lse, int n, int m, int d, int q_tiles,          \
      int bias_groups, int causal, float scale
#define MV2_FWD_WG_ARGS                                                    \
  &map_q, &map_k, &map_v, v, bias, out, lse, n, m, d, q_tiles, bias_groups, \
      causal, scale

__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wg_wide_kernel(MV2_FWD_WG_PARAMS) {
  fwd_wg_block<1>(MV2_FWD_WG_ARGS);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    fwd_wg_pair_kernel(MV2_FWD_WG_PARAMS) {
  fwd_wg_block<kPairCluster>(MV2_FWD_WG_ARGS);
}

// The wide dK/dV of one block, alone (C = 1) or rank r of a pair on head
// columns [kWgWideMax r, kWgWideMax (r + 1)): DK false forms dV (grid z 0),
// true dK (grid z 1)
template <bool DK, int C>
__device__ __forceinline__ void dkv_wg_block(
    const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const bf16* __restrict__ bias, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ grad, int n, int m, int d, int k_tiles,
    int bias_groups, int causal, float scale) {
  typedef WgWideDkvGeo G;
  typedef WgPairDkvGeo PG;  // a pair's inbox
  constexpr bool pair = C > 1;
  constexpr int T = G::tile, H = kWgWideHalf;
  constexpr int PW = G::exchange ? G::panels / 2 : G::panels;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t kvbar, full[G::stages], empty[G::stages],
      pfull[PG::buffers], pread[PG::buffers];
  unsigned char* kv = align1024(wg_smem);  // K's boxes, then V's
  unsigned char* ring = kv + 2 * G::panels * G::k_panel;  // a stage: Q, dO
  // a stage's lse (base 2) and delta
  float* rows_s = reinterpret_cast<float*>(ring + 2 * G::stages * G::q_tile);
  float* xs = rows_s + 2 * G::stages * T;  // the partial sums
  float* inbox = xs + G::xfloats;          // the peer's
  float* dosum = inbox + (pair ? PG::buffers * PG::pfloats : 0);

  const unsigned rank = pair ? cluster_rank() : 0u;
  const int cb = G::D * rank;        // the block's first head column
  const unsigned block = blockIdx.x / C;  // the cluster's index
  const int bh = block / k_tiles;
  const int k0 = (block % k_tiles) * G::keys;
  const int offset = m - n;
  const int blind = causal ? n - m : 0;  // rows < blind see no key
  // query tiles first .. tiles - 1: with causal, from the first whose last
  // row sees the block's first key (dkv_query_tiles); the same in both
  // blocks of a pair
  const int first = causal ? max(0, k0 - offset) / T : 0;
  const int tiles = (n + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&kvbar, 1);
    for (int s = 0; s < G::stages; ++s) {
      mbar_init(&full[s], 32);                   // the producer's lanes
      mbar_init(&empty[s], kWgConsumers / 32);  // a consumer warp each
    }
    if constexpr (pair) pair_init<PG::buffers>(pfull, pread);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!DK && blind > 0) {  // their dO on the block's columns, in the ring
    column_sum<G::D, kWgConsumers>(dosum, reinterpret_cast<float*>(ring),
                                   dout + (size_t)bh * n * d + cb, blind,
                                   pair ? min(d - cb, G::D) : d, d);
    fence_proxy_async();
  }
  if constexpr (pair)
    cluster_sync();
  else
    __syncthreads();

  if (warp >= kWgConsumers / 32) {  // the producer warpgroup
    reg_dealloc<kWgProducerRegs>();
    // one warp loads; the others leave (in a pair, after the cluster
    // barrier that ends the kernel)
    if (warp > kWgConsumers / 32) {
      if constexpr (pair) cluster_sync();
      return;
    }
    if (lane == 0) {
      mbar_expect_tx(&kvbar, (DK ? 2 : 1) * G::panels * G::k_panel);
      for (int p = 0; p < G::panels; ++p) {
        tma_load_3d(kv + p * G::k_panel, map_k, &kvbar,
                    cb + p * kSw128Cols, k0, bh);
        if (DK)
          tma_load_3d(kv + (G::panels + p) * G::k_panel, map_v, &kvbar,
                      cb + p * kSw128Cols, k0, bh);
      }
    }
    const float* lse_b = lse + (size_t)bh * n;
    const float* delta_b = delta + (size_t)bh * n;
    for (int t = first; t < tiles; ++t) {
      const int i = t - first, s = i % G::stages, use = i / G::stages;
      // the tile's lse (base 2) and delta, a lane a query, 0 past n,
      // read before the stage is free
      const int row = t * T + lane;
      const bool in = lane < T && row < n;
      const float r_lse = in ? lse_b[row] * kLog2e : 0.f;
      const float r_del = in ? delta_b[row] : 0.f;
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      float* rs = rows_s + s * 2 * T;
      if (lane < T) {
        rs[lane] = r_lse;
        rs[T + lane] = r_del;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * G::q_tile);
        unsigned char* st = ring + s * 2 * G::q_tile;
        for (int p = 0; p < G::panels; ++p) {
          tma_load_3d(st + p * G::q_panel, map_q, &full[s],
                      cb + p * kSw128Cols, t * T, bh);
          tma_load_3d(st + G::q_tile + p * G::q_panel, map_do, &full[s],
                      cb + p * kSw128Cols, t * T, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {  // two consumer warpgroups on the same 64 keys
    reg_alloc<kWgConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
    const int kwarp = k0 + 16 * wq;  // the warp's first key
    const int ka = kwarp + g;        // rows ka and ka + 8
    const int c0 = H * wg;           // the warpgroup's first block column
    const int p0 = G::exchange ? PW * wg : 0;  // its first score panel
    const bf16* bb =
        bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
    const float scale_log2 = scale * kLog2e;
    const uint64_t kdesc = sw128_desc(kv + p0 * G::k_panel);
    const uint64_t vdesc = sw128_desc(kv + (G::panels + p0) * G::k_panel);
    PairInbox<pair ? PG::buffers : 0, PG::pfloats> box(inbox, pfull, pread,
                                                        rank);
    float acc[H / 2];
    zero_acc(acc);
    mbar_wait(&kvbar, 0);

    for (int t = first; t < tiles; ++t) {
      const int i = t - first, s = i % G::stages;
      const int q0 = t * T;
      const unsigned char* qt = ring + s * 2 * G::q_tile;
      const unsigned char* dot = qt + G::q_tile;
      const float* lse_s = rows_s + s * 2 * T;
      const float* delta_s = lse_s + T;
      float sc[T / 2], dp[DK ? T / 2 : 1];
      zero_acc(sc);
      zero_acc(dp);
      mbar_wait(&full[s], (i / G::stages) & 1);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < PW; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ko = ((p * G::k_panel) >> 4) + 2 * kk;
          const int qo = (p0 + p) * G::q_panel;
          wgmma_bf16(sc, kdesc + ko, sw128_desc(qt + qo) + 2 * kk);
          if constexpr (DK)
            wgmma_bf16(dp, vdesc + ko, sw128_desc(dot + qo) + 2 * kk);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      if constexpr (G::exchange) {  // the two warpgroups' partial sums
        if constexpr (DK)
          exchange_sum(sc, dp, xs, 2 * G::keys * T, wg, tid, i == 0,
                       t + 1 == tiles);
        else
          exchange_sum(sc, xs, 2 * G::keys * T, wg, tid, i == 0,
                       t + 1 == tiles);
      }
      if constexpr (pair) {  // S^T (and dP^T) = own + peer
        if constexpr (DK)
          box.send(i, sc, dp, wg, tid), box.receive(i, sc, dp, tid);
        else
          box.send(i, sc, wg, tid), box.receive(i, sc, tid);
      }
      // P^T: element 4j + e is (key ka + 8 (e / 2), query q0 + c), c = 8j +
      // 2tq + e % 2; uniform branches: the bias, the element test of a
      // masked tile
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] = fmaf(sc[4 * j + e], scale_log2,
                               -lse_s[8 * j + 2 * tq + (e & 1)]);
      if (bb)
#pragma unroll
        for (int j = 0; j < T / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = ka + 8 * (e >> 1);
            const int row = q0 + 8 * j + 2 * tq + (e & 1);
            if (row < n && key < m)
              sc[4 * j + e] = fmaf(to_f32(bb[(size_t)row * m + key]), kLog2e,
                                   sc[4 * j + e]);
          }
      if (tile_masked(q0, T, kwarp, 16, n, m, causal))
#pragma unroll
        for (int j = 0; j < T / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = ka + 8 * (e >> 1);
            const int row = q0 + 8 * j + 2 * tq + (e & 1);
            if (!(row < n && key < m && (!causal || key <= row + offset)))
              sc[4 * j + e] = -INFINITY;
          }
#pragma unroll
      for (int e = 0; e < T / 2; ++e) sc[e] = exp2_approx(sc[e]);
      if constexpr (DK)  // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int j = 0; j < T / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] *= dp[4 * j + e] - delta_s[8 * j + 2 * tq + (e & 1)];
      // dV += P^T dO or dK += dS^T Q on the warpgroup's columns of the
      // streamed tile, read MN-major
      unsigned a[T / 16][4];
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) frag_of(a[kk], sc + 8 * kk);
      const uint64_t bmn = sw128_mn_desc(
          (DK ? qt : dot) + (c0 / kSw128Cols) * G::q_panel, G::q_panel);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs_mn(acc, a[kk], bmn + 128 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      keep_live(a);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    if (!DK && blind > 0) {  // dV of the rows that see no key: their dO / m
      const float inv_m = 1.f / m;
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] += dosum[c0 + 8 * j + 2 * tq + (e & 1)] * inv_m;
    }
    store_acc<H>(grad + (size_t)bh * m * d + cb + c0, acc, ka, m,
                 DK ? scale : 1.f, d - cb - c0, d);
  }
  if constexpr (pair) cluster_sync();  // the peer may still write here
}

#define MV2_DKV_WG_PARAMS                                                 \
  const __grid_constant__ CUtensorMap map_q,                              \
      const __grid_constant__ CUtensorMap map_k,                          \
      const __grid_constant__ CUtensorMap map_v,                          \
      const __grid_constant__ CUtensorMap map_do,                         \
      const bf16 *__restrict__ bias, const bf16 *__restrict__ dout,       \
      const float *__restrict__ lse, const float *__restrict__ delta,     \
      bf16 *__restrict__ dk, bf16 *__restrict__ dv, int n, int m, int d,  \
      int k_tiles, int bias_groups, int causal, float scale
#define MV2_DKV_WG_ARGS(GRAD)                                              \
  &map_q, &map_k, &map_v, &map_do, bias, dout, lse, delta, GRAD, n, m, d,  \
      k_tiles, bias_groups, causal, scale

__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkv_wg_wide_kernel(MV2_DKV_WG_PARAMS) {
  if (blockIdx.z == 0)
    dkv_wg_block<false, 1>(MV2_DKV_WG_ARGS(dv));
  else
    dkv_wg_block<true, 1>(MV2_DKV_WG_ARGS(dk));
}

__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dkv_wg_pair_kernel(MV2_DKV_WG_PARAMS) {
  if (blockIdx.z == 0)
    dkv_wg_block<false, kPairCluster>(MV2_DKV_WG_ARGS(dv));
  else
    dkv_wg_block<true, kPairCluster>(MV2_DKV_WG_ARGS(dk));
}

// The wide dQ of one block, alone (C = 1) or rank r of a pair on head
// columns [kWgWideMax r, kWgWideMax (r + 1)) with the pair's own stages
// (WgPairDqGeo)
template <int C>
__device__ __forceinline__ void dq_wg_block(
    const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const bf16* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    float* __restrict__ dbias, int n, int m, int d, int q_tiles,
    int bias_groups, int causal, float scale) {
  constexpr bool pair = C > 1;
  typedef std::conditional_t<pair, WgPairDqGeo, WgWideDqGeo> G;
  typedef WgPairDqGeo PG;  // a pair's inbox
  constexpr int T = G::tile, NB = T / 8, H = kWgWideHalf;
  // the panels of a warpgroup's partial S and dP
  constexpr int PW = G::exchange ? G::panels / 2 : G::panels;
  constexpr int KS = G::k_stages, VS = G::v_stages;
  extern __shared__ unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t qbar, kfull[KS], kempty[KS], vfull[VS],
      vempty[VS], pfull[PG::buffers], pread[PG::buffers];
  unsigned char* qs = align1024(wg_smem);
  unsigned char* dos = qs + G::panels * G::q_panel;
  unsigned char* ks = dos + G::panels * G::q_panel;
  unsigned char* vs = ks + KS * G::kv_tile;
  // the peer's partial S and dP
  float* inbox = reinterpret_cast<float*>(vs + VS * G::kv_tile);

  const unsigned rank = pair ? cluster_rank() : 0u;
  const int cb = G::D * rank;        // the block's first head column
  const unsigned block = blockIdx.x / C;  // the cluster's index
  const int bh = block / q_tiles;
  const int q0 = (q_tiles - 1 - block % q_tiles) * G::rows;
  const int offset = m - n;
  // key tiles 0 .. tiles - 1: with causal, up to the last one the block's
  // last row sees (dq_key_tiles); the same in both blocks of a pair
  const int k_end = causal ? min(m, min(q0 + G::rows, n) + offset) : m;
  const int tiles = (max(k_end, 0) + T - 1) / T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < KS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], kWgConsumers / 32);  // a consumer warp each
    }
    for (int s = 0; s < VS; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], kWgConsumers / 32);
    }
    if constexpr (pair) pair_init<PG::buffers>(pfull, pread);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (pair)
    cluster_sync();
  else
    __syncthreads();

  if (warp >= kWgConsumers / 32) {  // the producer warpgroup
    reg_dealloc<kWgProducerRegs>();
    if (warp == kWgConsumers / 32 && lane == 0) {
      mbar_expect_tx(&qbar, 2 * G::panels * G::q_panel);
      for (int p = 0; p < G::panels; ++p) {
        tma_load_3d(qs + p * G::q_panel, map_q, &qbar, cb + p * kSw128Cols,
                    q0, bh);
        tma_load_3d(dos + p * G::q_panel, map_do, &qbar, cb + p * kSw128Cols,
                    q0, bh);
      }
      for (int t = 0; t < tiles; ++t) {
        const int sk = t % KS, uk = t / KS, sv = t % VS, uv = t / VS;
        auto load_k = [&] {
          if (uk > 0) mbar_wait(&kempty[sk], (uk - 1) & 1);
          mbar_expect_tx(&kfull[sk], G::kv_tile);
          for (int p = 0; p < G::panels; ++p)
            tma_load_3d(ks + sk * G::kv_tile + p * G::kv_panel, map_k,
                        &kfull[sk], cb + p * kSw128Cols, t * T, bh);
        };
        if constexpr (!G::v_first) load_k();
        if (uv > 0) mbar_wait(&vempty[sv], (uv - 1) & 1);
        mbar_expect_tx(&vfull[sv], G::kv_tile);
        for (int p = 0; p < G::panels; ++p)
          tma_load_3d(vs + sv * G::kv_tile + p * G::kv_panel, map_v,
                      &vfull[sv], cb + p * kSw128Cols, t * T, bh);
        if constexpr (G::v_first) load_k();  // V's stage frees first
      }
    }
  } else {  // two consumer warpgroups on the same 64 rows
    reg_alloc<kWgConsumerRegs>();
    const int wg = warp / 4, wq = warp % 4, g = lane >> 2, tq = lane & 3;
    const int tid = threadIdx.x % 128;
    const int w0 = q0 + 16 * wq;  // the warp's first row
    const int ra = w0 + g;
    const int c0 = H * wg;        // the warpgroup's first dQ column
    const int p0 = G::exchange ? PW * wg : 0;  // its first score panel
    const bf16* bb =
        bias ? bias + (size_t)(bh % bias_groups) * n * m : nullptr;
    // d_bias from rank 0 alone
    float* dbb = dbias && rank == 0 ? dbias + (size_t)bh * n * m : nullptr;
    const float scale_log2 = scale * kLog2e;
    // lse (base 2) and delta of rows ra and ra + 8, 0 past n
    float lse2[2], del[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ra + 8 * h;
      lse2[h] = row < n ? lse[(size_t)bh * n + row] * kLog2e : 0.f;
      del[h] = row < n ? delta[(size_t)bh * n + row] : 0.f;
    }
    const uint64_t qdesc = sw128_desc(qs + p0 * G::q_panel);
    const uint64_t ddesc = sw128_desc(dos + p0 * G::q_panel);
    PairInbox<pair ? PG::buffers : 0, PG::pfloats> box(inbox, pfull, pread,
                                                        rank);
    float acc[H / 2];
    zero_acc(acc);
    auto release = [&](uint64_t* bars, int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars[s]);
    };
    // s += a b^T over the warpgroup's panels: S = Q K^T or dP = dO V^T
    auto product = [&](float (&s)[T / 2], uint64_t adesc, uint64_t bdesc) {
#pragma unroll
      for (int p = 0; p < PW; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16(s, adesc + ((p * G::q_panel) >> 4) + 2 * kk,
                     bdesc + ((p * G::kv_panel) >> 4) + 2 * kk);
      wgmma_commit();
    };

    mbar_wait(&qbar, 0);
    for (int t = 0; t < tiles; ++t) {
      const int sk = t % KS, sv = t % VS;
      const int k0 = t * T;
      const unsigned char* kt = ks + sk * G::kv_tile;
      unsigned char* vt = vs + sv * G::kv_tile;
      const uint64_t kdesc = sw128_desc(kt + p0 * G::kv_panel);
      const uint64_t vdesc = sw128_desc(vt + p0 * G::kv_panel);
      float sc[T / 2], dp[T / 2];  // S, then P, then dS; dP
      zero_acc(sc);
      zero_acc(dp);
      if constexpr (G::v_first) {
        mbar_wait(&vfull[sv], (t / VS) & 1);
        wgmma_fence();
        product(dp, ddesc, vdesc);
        mbar_wait(&kfull[sk], (t / KS) & 1);
        product(sc, qdesc, kdesc);
      } else {
        mbar_wait(&kfull[sk], (t / KS) & 1);
        wgmma_fence();
        product(sc, qdesc, kdesc);
        mbar_wait(&vfull[sv], (t / VS) & 1);
        product(dp, ddesc, vdesc);
      }
      if constexpr (G::exchange) {  // both partial sums, then the other's
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);
        exchange_in_stage(
            sc, dp, reinterpret_cast<float*>(vt + p0 * G::kv_panel),
            reinterpret_cast<const float*>(vt + (PW - p0) * G::kv_panel), wg,
            threadIdx.x % 128);
        release(vempty, sv);
      } else {
        wgmma_wait<1>();  // S is in; dP may still run
        fence_acc(sc);
      }
      if constexpr (pair) {  // S and dP = own + peer
        box.send(t, sc, dp, wg, tid);
        box.receive(t, sc, dp, tid);
      }
      // element 4j + e is (row ra + 8 (e / 2), key k0 + 8j + 2tq + e % 2);
      // uniform branches: the bias, and the element test of a masked tile
#pragma unroll
      for (int e = 0; e < T / 2; ++e)
        sc[e] = fmaf(sc[e], scale_log2, -lse2[(e >> 1) & 1]);
      if (bb)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (row < n && col < m)
              sc[4 * j + e] = fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e,
                                   sc[4 * j + e]);
          }
      if (tile_masked(w0, 16, k0, T, n, m, causal))
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (!(row < n && col < m && (!causal || col <= row + offset)))
              sc[4 * j + e] = -INFINITY;
          }
#pragma unroll
      for (int e = 0; e < T / 2; ++e) sc[e] = exp2_approx(sc[e]);
      if constexpr (!G::exchange) {
        wgmma_wait<0>();
        fence_acc(dp);
        release(vempty, sv);
      }
#pragma unroll
      for (int e = 0; e < T / 2; ++e)
        sc[e] *= dp[e] - del[(e >> 1) & 1];
      // dQ += dS K on the warpgroup's columns of the K tile, read MN-major
      unsigned da[T / 16][4];
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk) frag_of(da[kk], sc + 8 * kk);
      wgmma_fence();
      const uint64_t kmn =
          sw128_mn_desc(kt + (c0 / kSw128Cols) * G::kv_panel, G::kv_panel);
#pragma unroll
      for (int kk = 0; kk < T / 16; ++kk)
        wgmma_rs_mn(acc, da[kk], kmn + 128 * kk);
      wgmma_commit();
      if (dbb && wg == 0)  // dS as d_bias while dQ's product runs
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * tq + (e & 1);
            if (row < n && col < m) dbb[(size_t)row * m + col] = sc[4 * j + e];
          }
      wgmma_wait<0>();
      fence_acc(acc);
      keep_live(da);
      release(kempty, sk);
    }
    store_acc<H>(dq + (size_t)bh * n * d + cb + c0, acc, ra, n, scale,
                 d - cb - c0, d);
    // dS of the key tiles the causal skip passed over is 0
    const int skipped = m - tiles * T;
    if (dbb && skipped > 0)
      for (int r = warp; r < G::rows; r += kWgConsumers / 32) {
        if (q0 + r >= n) break;
        float* row = dbb + (size_t)(q0 + r) * m + (m - skipped);
        for (int c = lane; c < skipped; c += 32) row[c] = 0.f;
      }
  }
  if constexpr (pair) cluster_sync();  // the peer may still write here
}

#define MV2_DQ_WG_PARAMS                                                  \
  const __grid_constant__ CUtensorMap map_q,                              \
      const __grid_constant__ CUtensorMap map_k,                          \
      const __grid_constant__ CUtensorMap map_v,                          \
      const __grid_constant__ CUtensorMap map_do,                         \
      const bf16 *__restrict__ bias, const float *__restrict__ lse,       \
      const float *__restrict__ delta, bf16 *__restrict__ dq,             \
      float *__restrict__ dbias, int n, int m, int d, int q_tiles,        \
      int bias_groups, int causal, float scale
#define MV2_DQ_WG_ARGS                                                     \
  &map_q, &map_k, &map_v, &map_do, bias, lse, delta, dq, dbias, n, m, d,   \
      q_tiles, bias_groups, causal, scale

__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dq_wg_wide_kernel(MV2_DQ_WG_PARAMS) {
  dq_wg_block<1>(MV2_DQ_WG_ARGS);
}

__global__ void __launch_bounds__(kWgThreads, 1)
    bwd_dq_wg_pair_kernel(MV2_DQ_WG_PARAMS) {
  dq_wg_block<kPairCluster>(MV2_DQ_WG_ARGS);
}

// ---- heads over 256: the wide kernels, both routes -------------------------
//
// These take every head over 256 on the 'f32' route and, on the 'mma'
// route, dQ at every head over kWgWideMax and the forward and dK/dV over
// kWgPairMax (the Hopper wide kernels and the paired ones above take the
// rest).
// A head over 256 values does not fit a block's output accumulator (64 rows
// x 512 floats is 128 KB at d = 512), so its output columns are cut into
// chunks of kWideOut: a block owns one chunk (grid y) of its rows' output,
// O in the forward, dQ in dQ, dV or dK in dK/dV (grid z: 0 dV, 1 dK, one
// accumulator a block, both in one launch). It forms the whole scores
// S = Q K^T, and in the backward dP = dO V^T, by summing the products of
// column slices of kWideCols over the head, streamed with the rows they
// multiply, and then multiplies P (or dS) by its chunk of the streamed
// tile: V, K, dO or Q. Every chunk's block sums the same slices in the same
// order, so S, lse and dS are bit-equal across chunks; the blocks of chunk 0
// alone write lse and dS. The score products are done once per chunk: at
// d = 512 (two chunks) the forward does 1.5x the products of the narrow
// kernels' decomposition, dQ 5/3 and dK/dV 2x. Masking, the bias, the
// causal skip, the rows that see no key and the routes are the narrow
// kernels'.
constexpr int kNarrowMax = 256;  // the widest head of the kernels above
constexpr int kWideOut = 256;    // output columns a block owns
enum WideMode { kWideFwd = 0, kWideDq = 1, kWideDv = 2, kWideDk = 3 };

// what every wide kernel takes; out_a is out, dq or dv, out_b dk
struct WideArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out_a;
  void* out_b;
  float* lse_out;
  float* dbias;
  int n, m, d, own_tiles, groups, causal;
  float scale;
};

__host__ __device__ constexpr int wide_chunks(int d) {
  return (d + kWideOut - 1) / kWideOut;
}

// The 'mma' route: kBwdWarps warps own kWideRows rows, 16 a warp, and stream
// tiles of the other side (32 rows in the forward; 16 in the backward, whose
// two score accumulators would spill beside its 128 output floats a lane at
// 32; ptxas's lines in chip_smoke.py); a tile takes its score slices
// (own rows and streamed rows of kWideCols columns, of Q and K, and of dO
// and V when the backward needs dP) and then its chunk, each one stage of a
// cp.async ring. The own rows are re-read per tile, from L2: holding them
// whole in shared memory (133 KB for Q and dO at d = 512) leaves one block
// an SM, which ran slower on the card than two blocks re-reading them.
constexpr int kWideRows = 16 * kBwdWarps;
constexpr int kWideCols = 64;
constexpr int kWideStages = 3;

template <bool TWO>
struct WideGeo {
  static constexpr int tile = TWO ? 16 : 32;  // streamed rows a tile
  static constexpr int ld = kWideCols + 8;    // a slice's rows
  static constexpr int ldy = kWideOut + 8;    // a chunk's rows
  static constexpr size_t slice =
      (TWO ? 2 : 1) * sizeof(bf16) * (kWideRows + tile) * ld;
  static constexpr size_t chunk = sizeof(bf16) * tile * ldy;
  static constexpr size_t stage =
      align_up(slice > chunk ? slice : chunk);
  static constexpr size_t bytes =
      kWideStages * stage + column_sum_bytes<kWideOut, kBwdThreads>();
  static_assert(bytes <= kSmemMax, "wide shared memory");
};

// ROWS rows from row0 of src (rows, d), columns c0 .. c0 + W - 1, into a
// ring tile with rows of W + 8; zeros past the last row and past d
template <int W, int ROWS>
__device__ __forceinline__ void async_cols(bf16* dst, const bf16* src,
                                           int row0, int rows, int d,
                                           int c0) {
  constexpr int V = W / 8;
  for (int idx = threadIdx.x; idx < ROWS * V; idx += kBwdThreads) {
    const int r = idx / V, e = (idx % V) * 8;
    const bool ok = row0 + r < rows && c0 + e < d;
    cp_async16(dst + r * (W + 8) + e,
               src + (ok ? (size_t)(row0 + r) * d + c0 + e : 0), ok);
  }
}

// s[j] (16 x 8) += A (16 x kWideCols) B^T over one slice: A the warp's 16
// rows, B rows 8j .. 8j + 7 of the streamed rows
template <int NB>
__device__ __forceinline__ void slice_acc(float (&s)[NB][4], const bf16* a,
                                          const bf16* b) {
  constexpr int LD = kWideCols + 8;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < kWideCols / 16; ++c) {
    unsigned af[4];
    ldmatrix_x4(af, a + (lane & 15) * LD + 16 * c + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      unsigned bf[2];
      ldmatrix_x2(bf, b + (8 * j + (lane & 7)) * LD + 16 * c +
                          ((lane >> 3) & 1) * 8);
      mma_16816(s[j], af, bf[0], bf[1]);
    }
  }
}

template <int MODE, bool TWO_GEO>
__device__ __forceinline__ void wide_mma(const WideArgs& a) {
  constexpr bool ROWS_Q = MODE == kWideFwd || MODE == kWideDq;  // own: q
  constexpr bool TWO = MODE == kWideDq || MODE == kWideDk;      // and dP
  typedef WideGeo<TWO_GEO> G;
  constexpr int LD = G::ld, T = G::tile, NB = T / 8, R = kWideRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* csum = reinterpret_cast<float*>(smem_raw + kWideStages * G::stage);

  const int n = a.n, m = a.m, d = a.d, causal = a.causal;
  const int own_n = ROWS_Q ? n : m, other_n = ROWS_Q ? m : n;
  const int bh = blockIdx.x / a.own_tiles, tile = blockIdx.x % a.own_tiles;
  // the forward takes its heaviest blocks first, as the narrow one does
  const int own0 =
      (MODE == kWideFwd ? a.own_tiles - 1 - tile : tile) * R;
  const int c_out = blockIdx.y * kWideOut;
  const bool first_chunk = blockIdx.y == 0;
  const int lane = threadIdx.x % 32, tq = lane & 3, warp = threadIdx.x / 32;
  const int w0 = own0 + 16 * warp, ra = w0 + (lane >> 2), rb = ra + 8;
  const int offset = m - n;
  const size_t qo = (size_t)bh * n * d, ko = (size_t)bh * m * d;
  const bf16* qb = static_cast<const bf16*>(a.q) + qo;
  const bf16* kb = static_cast<const bf16*>(a.k) + ko;
  const bf16* vb = static_cast<const bf16*>(a.v) + ko;
  const bf16* dob = a.dout ? static_cast<const bf16*>(a.dout) + qo : nullptr;
  const bf16* bb = a.bias ? static_cast<const bf16*>(a.bias) +
                                (size_t)(bh % a.groups) * n * m
                          : nullptr;
  const bf16* a1 = ROWS_Q ? qb : kb;
  const bf16* b1 = ROWS_Q ? kb : qb;
  const bf16* a2 = ROWS_Q ? dob : vb;
  const bf16* b2 = ROWS_Q ? vb : dob;
  const bf16* y = MODE == kWideFwd  ? vb
                  : MODE == kWideDq ? kb
                  : MODE == kWideDv ? dob
                                    : qb;
  // the streamed tiles, as the narrow kernels' causal skip visits them
  int first = 0, last;
  if constexpr (ROWS_Q) {
    const int end = causal ? min(m, min(own0 + R, n) + offset) : m;
    last = (max(end, 0) + T - 1) / T;
  } else {
    first = causal ? max(0, own0 - offset) / T : 0;
    last = (n + T - 1) / T;
  }
  const int slices = (d + kWideCols - 1) / kWideCols;
  const int steps = slices + 1;  // a tile: its slices, then its chunk
  const int total = max(last - first, 0) * steps;
  auto stage = [&](int i) {
    return reinterpret_cast<bf16*>(smem_raw + (i % kWideStages) * G::stage);
  };
  // a stage's slices: A1 (own rows), B1, A2, B2 (streamed rows)
  const int ob1 = R * LD, oa2 = (R + T) * LD, ob2 = (2 * R + T) * LD;
  auto load = [&](int i) {
    bf16* st = stage(i);
    const int o0 = (first + i / steps) * T, j = i % steps;
    if (j < slices) {
      const int c0 = j * kWideCols;
      async_cols<kWideCols, R>(st, a1, own0, own_n, d, c0);
      async_cols<kWideCols, T>(st + ob1, b1, o0, other_n, d, c0);
      if constexpr (TWO) {
        async_cols<kWideCols, R>(st + oa2, a2, own0, own_n, d, c0);
        async_cols<kWideCols, T>(st + ob2, b2, o0, other_n, d, c0);
      }
    } else {
      async_cols<kWideOut, T>(st, y, o0, other_n, d, c_out);
    }
  };
#pragma unroll
  for (int i = 0; i < kWideStages - 1; ++i) {
    if (i < total) load(i);
    cp_async_commit();
  }
  // the rows that see no key (causal, m < n): the forward's mean of v, the
  // sum of their dO into every dV row
  const int blind = causal ? n - m : 0;
  if constexpr (MODE == kWideFwd)
    if (blind > 0 && own0 < blind)
      column_sum<kWideOut, kBwdThreads>(csum, csum + kWideOut, vb + c_out, m,
                                        d - c_out, d);
  if constexpr (MODE == kWideDv)
    if (blind > 0)
      column_sum<kWideOut, kBwdThreads>(csum, csum + kWideOut, dob + c_out,
                                        blind, d - c_out, d);

  const float scale_log2 = a.scale * kLog2e;
  const float* lse_rows = a.lse ? a.lse + (size_t)bh * n : nullptr;
  const float* delta_rows = a.delta ? a.delta + (size_t)bh * n : nullptr;
  float lse_a = 0.f, lse_b = 0.f, del_a = 0.f, del_b = 0.f;
  if constexpr (MODE == kWideDq) {
    lse_a = ra < n ? lse_rows[ra] * kLog2e : 0.f;
    lse_b = rb < n ? lse_rows[rb] * kLog2e : 0.f;
    del_a = ra < n ? delta_rows[ra] : 0.f;
    del_b = rb < n ? delta_rows[rb] : 0.f;
  }
  float* dbb = a.dbias && first_chunk ? a.dbias + (size_t)bh * n * m
                                      : nullptr;
  // the forward: running max (base 2) and the lane's part of the row sums
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const bool pre = bb != nullptr || !(a.scale > 0.f);
  const float mul = pre ? 1.f : scale_log2;

  float acc[kWideOut / 8][4];
#pragma unroll
  for (int i = 0; i < kWideOut / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float s[NB][4], dp[NB][4];

  for (int i = 0; i < total; ++i) {
    cp_async_wait<kWideStages - 2>();
    __syncthreads();  // step i is in; step i - 1's stage is free
    if (i + kWideStages - 1 < total) load(i + kWideStages - 1);
    cp_async_commit();
    const bf16* st = stage(i);
    const int j = i % steps, o0 = (first + i / steps) * T;
    if (j == 0)
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[b][e] = dp[b][e] = 0.f;
    if (j < slices) {
      slice_acc<NB>(s, st + 16 * warp * LD, st + ob1);
      if constexpr (TWO)
        slice_acc<NB>(dp, st + oa2 + 16 * warp * LD, st + ob2);
      continue;
    }
    // the tile's scores are whole; st holds its chunk of y
    if constexpr (MODE == kWideFwd) {
      const bool masked = tile_masked(w0, 16, o0, T, n, m, causal);
      if (pre)
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = o0 + 8 * b + 2 * tq + (e & 1);
            s[b][e] *= scale_log2;
            if (bb && row < n && col < m)
              s[b][e] =
                  fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e, s[b][e]);
          }
      if (masked)
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = o0 + 8 * b + 2 * tq + (e & 1);
            if (!(row < n && col < m && (!causal || col <= row + offset)))
              s[b][e] = -INFINITY;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cmax = -INFINITY;
#pragma unroll
        for (int b = 0; b < NB; ++b)
          cmax = fmaxf(cmax, fmaxf(s[b][2 * h], s[b][2 * h + 1]));
        const float mnew = fmaxf(mx[h], quad_max(cmax));
        const float base = mnew == -INFINITY ? 0.f : mnew * mul;
        const float alpha = exp2_approx(fmaf(mx[h], mul, -base));
        mx[h] = mnew;
        float sum = 0.f;
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[b][e] = exp2_approx(fmaf(s[b][e], mul, -base));
            sum += s[b][e];
          }
        l[h] = fmaf(l[h], alpha, sum);
#pragma unroll
        for (int c = 0; c < kWideOut / 8; ++c) {
          acc[c][2 * h] *= alpha;
          acc[c][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned pa[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        mma_acc_trans<kWideOut>(acc, pa, st, 16 * kk);
      }
    } else if constexpr (MODE == kWideDq) {
      const bool masked = tile_masked(own0, R, o0, T, n, m, causal);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? ra : rb;
          const int col = o0 + 8 * b + 2 * tq + (e & 1);
          const bool inside = row < n && col < m;
          float x = fmaf(s[b][e], scale_log2, -(e < 2 ? lse_a : lse_b));
          if (bb && inside)
            x = fmaf(to_f32(bb[(size_t)row * m + col]), kLog2e, x);
          if (masked && !(inside && (!causal || col <= row + offset)))
            x = -INFINITY;
          const float ds =
              exp2_approx(x) * (dp[b][e] - (e < 2 ? del_a : del_b));
          s[b][e] = ds;
          if (dbb && inside) dbb[(size_t)row * m + col] = ds;
        }
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned da[4];
        c_to_a(da, s[2 * kk], s[2 * kk + 1]);
        mma_acc_trans<kWideOut>(acc, da, st, 16 * kk);
      }
    } else {  // dV or dK: the rows are keys, the columns this tile's queries
      const bool masked = tile_masked(o0, T, own0, R, n, m, causal);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? ra : rb;
          const int row = o0 + 8 * b + 2 * tq + (e & 1);
          const bool inside = row < n && key < m;
          const float lse_c = row < n ? lse_rows[row] : 0.f;
          float x = fmaf(s[b][e], scale_log2, -lse_c * kLog2e);
          if (bb && inside)
            x = fmaf(to_f32(bb[(size_t)row * m + key]), kLog2e, x);
          if (masked && !(inside && (!causal || key <= row + offset)))
            x = -INFINITY;
          const float p = exp2_approx(x);
          s[b][e] = p;
          if constexpr (MODE == kWideDk)
            dp[b][e] = p * (dp[b][e] - (row < n ? delta_rows[row] : 0.f));
        }
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        unsigned pa[4];
        if constexpr (MODE == kWideDv)
          c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        else
          c_to_a(pa, dp[2 * kk], dp[2 * kk + 1]);
        mma_acc_trans<kWideOut>(acc, pa, st, 16 * kk);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (tiles may be 0)

  const int cols = d - c_out;  // of this chunk, stored up to kWideOut
  if constexpr (MODE == kWideFwd) {
    float* lse_out = a.lse_out + (size_t)bh * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sum = fmaxf(quad_sum(l[h]), 1e-30f);
      const float inv = 1.f / sum;
#pragma unroll
      for (int c = 0; c < kWideOut / 8; ++c) {
        acc[c][2 * h] *= inv;
        acc[c][2 * h + 1] *= inv;
      }
      const int row = ra + 8 * h;
      if (first_chunk && tq == 0 && row < n)
        lse_out[row] = mx[h] == -INFINITY
                           ? kMasked + logf(sum)
                           : fmaf(mx[h] * mul, kLn2, logf(sum));
    }
    if (blind > 0 && own0 < blind) {  // uniform: the rows that see no key
      const float inv_m = 1.f / m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = ra + 8 * h;
        if (row >= blind) continue;
#pragma unroll
        for (int c = 0; c < kWideOut / 8; ++c) {
          acc[c][2 * h] = csum[8 * c + 2 * tq] * inv_m;
          acc[c][2 * h + 1] = csum[8 * c + 2 * tq + 1] * inv_m;
        }
        if (first_chunk && tq == 0) lse_out[row] = kMasked + logf((float)m);
      }
    }
    store_rows<kWideOut>(static_cast<bf16*>(a.out_a) + qo + c_out, acc, ra,
                         n, 1.f, cols, d);
  } else if constexpr (MODE == kWideDq) {
    store_rows<kWideOut>(static_cast<bf16*>(a.out_a) + qo + c_out, acc, ra,
                         n, a.scale, cols, d);
    // dS of the key tiles the causal skip passed over is 0
    const int skipped = m - last * T;
    if (dbb && skipped > 0)
      for (int idx = threadIdx.x; idx < R * skipped; idx += kBwdThreads) {
        const int row = own0 + idx / skipped;
        if (row < n) dbb[(size_t)row * m + m - skipped + idx % skipped] = 0.f;
      }
  } else if constexpr (MODE == kWideDv) {
    if (blind > 0) {
      const float inv_m = 1.f / m;
#pragma unroll
      for (int c = 0; c < kWideOut / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c][e] += csum[8 * c + 2 * tq + (e & 1)] * inv_m;
    }
    store_rows<kWideOut>(static_cast<bf16*>(a.out_a) + ko + c_out, acc, ra,
                         m, 1.f, cols, d);
  } else {
    store_rows<kWideOut>(static_cast<bf16*>(a.out_b) + ko + c_out, acc, ra,
                         m, a.scale, cols, d);
  }
}

__global__ void __launch_bounds__(kBwdThreads, 2)
    fwd_wide_mma_kernel(WideArgs a) {
  wide_mma<kWideFwd, false>(a);
}

__global__ void __launch_bounds__(kBwdThreads, 2)
    bwd_dq_wide_mma_kernel(WideArgs a) {
  wide_mma<kWideDq, true>(a);
}

__global__ void __launch_bounds__(kBwdThreads, 2)
    bwd_dkv_wide_mma_kernel(WideArgs a) {
  if (blockIdx.z == 0)
    wide_mma<kWideDv, true>(a);
  else
    wide_mma<kWideDk, true>(a);
}

// The 'f32' route: two warps own 32 rows, 16 a warp, and stream tiles of
// 32 rows of the other side through shared memory, with the products of
// warp_mma (no TF32): the scores summed over slices of kWideColsF32
// columns, P or dS into the chunk's accumulator in shared memory. The
// narrow 'f32' kernels' softmax, masks and rows that see no key.
constexpr int kWideColsF32 = 64;

struct WideF32 {
  static constexpr int tile = 32, threads = 64;
  static constexpr int ldc = kWideColsF32 + 1;  // a slice
  static constexpr int lds = tile + 1;          // S, dP, P or dS
  static constexpr int ldy = kWideOut + 1;      // a chunk, the accumulator
  static constexpr size_t bytes =
      4 * align_up(sizeof(float) * tile * ldc) +
      3 * align_up(sizeof(float) * tile * lds) +
      2 * align_up(sizeof(float) * tile * ldy) +
      2 * align_up(sizeof(float) * tile);
  static_assert(bytes <= kSmemMax, "wide f32 shared memory");
};

// rows row0 .. row0 + 31 of src (rows, d), columns c0 .. c0 + W - 1, into a
// shared tile with rows of ld floats; zeros past the last row and past d
template <int W>
__device__ __forceinline__ void load_cols(float* dst, int ld, const float* src,
                                          int row0, int rows, int d, int c0) {
  for (int idx = threadIdx.x; idx < WideF32::tile * W;
       idx += WideF32::threads) {
    const int r = idx / W, e = idx % W;
    dst[r * ld + e] = row0 + r < rows && c0 + e < d
                          ? src[(size_t)(row0 + r) * d + c0 + e]
                          : 0.f;
  }
}

__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int rows) {
  for (int i = threadIdx.x; i < WideF32::tile; i += WideF32::threads)
    dst[i] = row0 + i < rows ? src[row0 + i] : 0.f;
}

template <int MODE>
__device__ __forceinline__ void wide_f32(const WideArgs& a) {
  typedef WideF32 C;
  constexpr bool ROWS_Q = MODE == kWideFwd || MODE == kWideDq;
  constexpr bool TWO = MODE == kWideDq || MODE == kWideDk;
  constexpr int T = C::tile, HALF = T / 2, KC = kWideColsF32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sp = smem_raw;
  float* A1 = carve(sp, T * C::ldc);
  float* B1 = carve(sp, T * C::ldc);
  float* A2 = carve(sp, T * C::ldc);
  float* B2 = carve(sp, T * C::ldc);
  float* Sf = carve(sp, T * C::lds);
  float* dPf = carve(sp, T * C::lds);
  float* Pt = carve(sp, T * C::lds);
  float* Ys = carve(sp, T * C::ldy);
  float* Acc = carve(sp, T * C::ldy);
  float* lse_s = carve(sp, T);
  float* delta_s = carve(sp, T);

  const int n = a.n, m = a.m, d = a.d, causal = a.causal;
  const int own_n = ROWS_Q ? n : m, other_n = ROWS_Q ? m : n;
  const int bh = blockIdx.x / a.own_tiles;
  const int own0 = (blockIdx.x % a.own_tiles) * T;
  const int c_out = blockIdx.y * kWideOut;
  const bool first_chunk = blockIdx.y == 0;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const int offset = m - n, blind = causal ? n - m : 0;
  const size_t qo = (size_t)bh * n * d, ko = (size_t)bh * m * d;
  const float* qb = static_cast<const float*>(a.q) + qo;
  const float* kb = static_cast<const float*>(a.k) + ko;
  const float* vb = static_cast<const float*>(a.v) + ko;
  const float* dob =
      a.dout ? static_cast<const float*>(a.dout) + qo : nullptr;
  const float* bb = a.bias ? static_cast<const float*>(a.bias) +
                                 (size_t)(bh % a.groups) * n * m
                           : nullptr;
  const float* a1 = ROWS_Q ? qb : kb;
  const float* b1 = ROWS_Q ? kb : qb;
  const float* a2 = ROWS_Q ? dob : vb;
  const float* b2 = ROWS_Q ? vb : dob;
  const float* y = MODE == kWideFwd  ? vb
                   : MODE == kWideDq ? kb
                   : MODE == kWideDv ? dob
                                     : qb;
  const float* lse_rows = a.lse ? a.lse + (size_t)bh * n : nullptr;
  const float* delta_rows = a.delta ? a.delta + (size_t)bh * n : nullptr;
  float* dbb = a.dbias && first_chunk ? a.dbias + (size_t)bh * n * m
                                      : nullptr;
  if constexpr (MODE == kWideDq) {
    load_vec(lse_s, lse_rows, own0, n);
    load_vec(delta_s, delta_rows, own0, n);
  }
  for (int i = threadIdx.x; i < T * C::ldy; i += C::threads) Acc[i] = 0.f;
  // the forward: the lane owns half of one row's columns of a tile
  const int half = lane & 1, srow = r0 + (lane >> 1), frow = own0 + srow;
  const bool no_key = causal && frow < n - m;
  float m_run = kMasked, l_run = 0.f;

  for (int o0 = 0; o0 < other_n; o0 += T) {
    for (int c0 = 0; c0 < d; c0 += KC) {
      __syncthreads();  // the previous readers of the slices are done
      load_cols<KC>(A1, C::ldc, a1, own0, own_n, d, c0);
      load_cols<KC>(B1, C::ldc, b1, o0, other_n, d, c0);
      if constexpr (TWO) {
        load_cols<KC>(A2, C::ldc, a2, own0, own_n, d, c0);
        load_cols<KC>(B2, C::ldc, b2, o0, other_n, d, c0);
      }
      __syncthreads();
      if (c0 == 0) {
        warp_mma<T, KC, false, true>(A1 + r0 * C::ldc, C::ldc, B1, C::ldc,
                                     Sf + r0 * C::lds, C::lds);
        if constexpr (TWO)
          warp_mma<T, KC, false, true>(A2 + r0 * C::ldc, C::ldc, B2, C::ldc,
                                       dPf + r0 * C::lds, C::lds);
      } else {
        warp_mma<T, KC, true, true>(A1 + r0 * C::ldc, C::ldc, B1, C::ldc,
                                    Sf + r0 * C::lds, C::lds);
        if constexpr (TWO)
          warp_mma<T, KC, true, true>(A2 + r0 * C::ldc, C::ldc, B2, C::ldc,
                                      dPf + r0 * C::lds, C::lds);
      }
    }
    __syncthreads();  // the chunk's tile takes the place of the last one
    load_cols<kWideOut>(Ys, C::ldy, y, o0, other_n, d, c_out);
    if constexpr (!ROWS_Q) {
      load_vec(lse_s, lse_rows, o0, n);
      load_vec(delta_s, delta_rows, o0, n);
    }
    __syncthreads();
    if constexpr (MODE == kWideFwd) {
      float s[HALF];
      float mx = kMasked;
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        const int c = HALF * half + t, col = o0 + c;
        float x = Sf[srow * C::lds + c] * a.scale;
        if (bb && frow < n && col < m) x += bb[(size_t)frow * m + col];
        bool ok = col < m && (!causal || col <= frow + offset);
        if (no_key) {
          ok = col < m;
          x = 0.f;
        }
        s[t] = ok ? x : kMasked;
        mx = fmaxf(mx, s[t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < HALF; ++t) {
        const float p = expf(s[t] - m_new);
        sum += p;
        Pt[srow * C::lds + HALF * half + t] = p;
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + sum;
      m_run = m_new;
      for (int e = 0; e < kWideOut / 2; ++e)
        Acc[srow * C::ldy + half * (kWideOut / 2) + e] *= alpha;
    } else if constexpr (MODE == kWideDq) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = own0 + r0 + r, col = o0 + lane;
        float x = Sf[(r0 + r) * C::lds + lane] * a.scale;
        if (bb && row < n && col < m) x += bb[(size_t)row * m + col];
        const bool ok =
            row < n && col < m && (!causal || col <= row + offset);
        const float p = ok ? expf(x - lse_s[r0 + r]) : 0.f;
        const float ds =
            p * (dPf[(r0 + r) * C::lds + lane] - delta_s[r0 + r]);
        Pt[(r0 + r) * C::lds + lane] = ds;
        if (dbb && row < n && col < m) dbb[(size_t)row * m + col] = ds;
      }
    } else {
      const float inv_m = 1.f / m;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = own0 + r0 + r, row = o0 + lane;
        float x = Sf[(r0 + r) * C::lds + lane] * a.scale;
        if (bb && row < n && key < m) x += bb[(size_t)row * m + key];
        const bool ok =
            row < n && key < m && (!causal || key <= row + offset);
        const float p = ok ? expf(x - lse_s[lane]) : 0.f;
        if constexpr (MODE == kWideDv)
          Pt[(r0 + r) * C::lds + lane] =
              row < blind && key < m ? inv_m : p;
        else
          Pt[(r0 + r) * C::lds + lane] =
              p * (dPf[(r0 + r) * C::lds + lane] - delta_s[lane]);
      }
    }
    __syncwarp();
    warp_acc_nn<kWideOut, T>(Pt + r0 * C::lds, C::lds, Ys, C::ldy,
                             Acc + r0 * C::ldy, C::ldy);
    __syncwarp();
  }

  __syncthreads();
  if constexpr (MODE == kWideFwd) {
    if (frow < n) {
      const float lsum = fmaxf(l_run, 1e-30f);
      const float inv = 1.f / lsum;
      float* orow = static_cast<float*>(a.out_a) + qo + (size_t)frow * d;
      for (int e = 0; e < kWideOut / 2; ++e) {
        const int col = half * (kWideOut / 2) + e;
        if (c_out + col < d)
          orow[c_out + col] = Acc[srow * C::ldy + col] * inv;
      }
      if (first_chunk && half == 0)
        a.lse_out[(size_t)bh * n + frow] =
            (no_key ? kMasked : m_run) + logf(lsum);
    }
  } else {
    const float mul = MODE == kWideDv ? 1.f : a.scale;
    float* dst = static_cast<float*>(MODE == kWideDk ? a.out_b : a.out_a) +
                 (ROWS_Q ? qo : ko);
    for (int r = 0; r < kRows; ++r) {
      const int row = own0 + r0 + r;
      if (row >= own_n) break;
      for (int e = lane; e < kWideOut && c_out + e < d; e += 32)
        dst[(size_t)row * d + c_out + e] = Acc[(r0 + r) * C::ldy + e] * mul;
    }
  }
}

__global__ void __launch_bounds__(WideF32::threads, 1)
    fwd_wide_f32_kernel(WideArgs a) {
  wide_f32<kWideFwd>(a);
}

__global__ void __launch_bounds__(WideF32::threads, 1)
    bwd_dq_wide_f32_kernel(WideArgs a) {
  wide_f32<kWideDq>(a);
}

__global__ void __launch_bounds__(WideF32::threads, 1)
    bwd_dkv_wide_f32_kernel(WideArgs a) {
  if (blockIdx.z == 0)
    wide_f32<kWideDv>(a);
  else
    wide_f32<kWideDk>(a);
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
                       int m, int d, int groups, int causal, float scale,
                       cudaStream_t stream) {
  typedef Cfg<D> C;
  const int tiles = tiles_of(n, C::tile);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<D>(3, 1, 0);
  static_assert(smem_bytes<D>(3, 1, 0) <= kSmemMax, "f32 forward");
  cudaError_t err = allow_smem(fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<(unsigned)(bh * tiles), C::threads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, lse, n, m, d, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const float* lse,
                      const float* delta, void* dq, float* dbias, int bh,
                      int n, int m, int d, int groups, int causal,
                      float scale, cudaStream_t stream) {
  typedef Cfg<D> C;
  const int tiles = tiles_of(n, C::tile);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<D>(4, 1, 2);
  static_assert(smem_bytes<D>(4, 1, 2) <= kSmemMax, "f32 dQ");
  cudaError_t err = allow_smem(bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<D><<<(unsigned)(bh * tiles), C::threads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)dout, lse, delta, (float*)dq, dbias, n, m, d, tiles,
      groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int n,
                       int m, int d, int groups, int causal, float scale,
                       cudaStream_t stream) {
  typedef Cfg<D> C;
  const int tiles = tiles_of(m, C::tile);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<D>(4, 2, 2);
  static_assert(smem_bytes<D>(4, 2, 2) <= kSmemMax, "f32 dK/dV");
  cudaError_t err = allow_smem(bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<D><<<(unsigned)(bh * tiles), C::threads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (const float*)dout, lse, delta, (float*)dk, (float*)dv, n, m, d, tiles,
      groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the Hopper kernels: setmaxnreg moves registers inside the block's own
// allocation, so what the producer warp gives back must cover what the
// consumers take (else their setmaxnreg.inc would wait forever): refused
// before any launch
template <typename Kernel>
cudaError_t wg_registers_fit(Kernel kernel) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  return (a.numRegs - kWgProducerRegs) * (kWgThreads - kWgConsumers) >=
                 (kWgConsumerRegs - a.numRegs) * kWgConsumers
             ? cudaSuccess
             : cudaErrorInvalidConfiguration;
}

// kernel on `grid` in clusters of kPairCluster blocks of kWgThreads threads
// and `bytes` of dynamic shared memory; a refused launch is returned
template <typename... Params, typename... Args>
cudaError_t launch_pair(void (*kernel)(Params...), dim3 grid, size_t bytes,
                        cudaStream_t stream, Args... args) {
  cudaError_t err = wg_registers_fit(kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kPairCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kWgThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the clusters of kernel (kPairCluster blocks of `bytes`) that the card
// can hold at once
template <typename Kernel>
cudaError_t pair_clusters(int* clusters, Kernel kernel, size_t bytes) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kPairCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kPairCluster);
  config.blockDim = dim3(kWgThreads);
  config.dynamicSmemBytes = bytes;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel,
                                        &config);
}

// the 3-D tensor map (bh, rows, d) of a bf16 operand in boxes of 64
// columns by box_rows rows: rows past `rows` and columns past d read 0
inline cudaError_t head_map(CUtensorMap* map, const void* ptr, int bh,
                            int rows, int d, int box_rows) {
  const long long dims[3] = {d, rows, bh};
  const int box[3] = {kSw128Cols, box_rows, 1};
  return tensor_map(map, static_cast<const bf16*>(ptr), 3, dims, box);
}

template <int D>
cudaError_t launch_fwd_wg(const void* q, const void* k, const void* v,
                          const void* bias, void* out, float* lse, int bh,
                          int n, int m, int d, int groups, int causal,
                          float scale, cudaStream_t stream) {
  typedef WgFwdGeo<D> G;
  const int tiles = tiles_of(n, G::rows);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const auto kernel = fwd_wg_mma_kernel<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::tile);
  if (err == cudaSuccess) err = wg_registers_fit(kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, G::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bh * tiles), kWgThreads, G::bytes, stream>>>(
      mq, mk, mv, (const bf16*)v, (const bf16*)bias, (bf16*)out, lse, n, m,
      d, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dkv_wg(const void* q, const void* k, const void* v,
                          const void* bias, const void* dout,
                          const float* lse, const float* delta, void* dk,
                          void* dv, int bh, int n, int m, int d, int groups,
                          int causal, float scale, cudaStream_t stream) {
  typedef WgDkvGeo<D> G;
  const int tiles = tiles_of(m, G::keys);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const auto kernel = bwd_dkv_wg_mma_kernel<D>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mdo, dout, bh, n, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::keys);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::keys);
  if (err == cudaSuccess) err = wg_registers_fit(kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, G::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bh * tiles), kWgThreads, G::bytes, stream>>>(
      mq, mk, mv, mdo, (const bf16*)bias, (const bf16*)dout, lse, delta,
      (bf16*)dk, (bf16*)dv, n, m, d, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq_wg(const void* q, const void* k, const void* v,
                         const void* bias, const void* dout, const float* lse,
                         const float* delta, void* dq, float* dbias, int bh,
                         int n, int m, int d, int groups, int causal,
                         float scale, cudaStream_t stream) {
  typedef WgDqGeo<D> G;
  const int tiles = tiles_of(n, G::rows);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const auto kernel = bwd_dq_wg_mma_kernel<D>;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mdo, dout, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::tile);
  if (err == cudaSuccess) err = wg_registers_fit(kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, G::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bh * tiles), kWgThreads, G::bytes, stream>>>(
      mq, mk, mv, mdo, (const bf16*)bias, lse, delta, (bf16*)dq, dbias, n, m,
      d, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// the 'mma' route
template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           const void* bias, void* out, float* lse, int bh,
                           int n, int m, int d, int groups, int causal,
                           float scale, cudaStream_t stream) {
  if constexpr (D > kExactWidth) {
    return launch_fwd_wg<D>(q, k, v, bias, out, lse, bh, n, m, d, groups,
                            causal, scale, stream);
  } else {
    const int tiles = tiles_of(n, kFwdBlockRows);
    if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
    const size_t bytes = FwdGeo<D>::bytes;
    const auto kernel = d == D ? fwd_mma_kernel<D> : fwd_mma_padded_kernel<D>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)(bh * tiles), kFwdThreads, bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
        (bf16*)out, lse, n, m, d, tiles, groups, causal, scale);
    MV2_CHECK_LAUNCH();
    return cudaSuccess;
  }
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* bias, const void* dout,
                          const float* lse, const float* delta, void* dq,
                          float* dbias, int bh, int n, int m, int d,
                          int groups, int causal, float scale,
                          cudaStream_t stream) {
  if constexpr (D > kExactWidth) {
    return launch_dq_wg<D>(q, k, v, bias, dout, lse, delta, dq, dbias, bh, n,
                           m, d, groups, causal, scale, stream);
  } else {
    const int tiles = tiles_of(n, kBwdRows);
    if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
    const size_t bytes = DqGeo<D>::bytes;
    const auto kernel =
        d == D ? bwd_dq_mma_kernel<D> : bwd_dq_mma_padded_kernel<D>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)(bh * tiles), kBwdThreads, bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
        (const bf16*)dout, lse, delta, (bf16*)dq, dbias, n, m, d, tiles,
        groups, causal, scale);
    MV2_CHECK_LAUNCH();
    return cudaSuccess;
  }
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* bias, const void* dout,
                           const float* lse, const float* delta, void* dk,
                           void* dv, int bh, int n, int m, int d, int groups,
                           int causal, float scale, cudaStream_t stream) {
  if constexpr (D > kExactWidth) {
    return launch_dkv_wg<D>(q, k, v, bias, dout, lse, delta, dk, dv, bh, n,
                            m, d, groups, causal, scale, stream);
  } else {
    const int tiles = tiles_of(m, kBwdRows);
    if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
    const size_t bytes = DkvGeo<D>::bytes;
    const auto kernel =
        d == D ? bwd_dkv_mma_kernel<D> : bwd_dkv_mma_padded_kernel<D>;
    cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)(bh * tiles), kBwdThreads, bytes, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias,
        (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv, n, m, d, tiles,
        groups, causal, scale);
    MV2_CHECK_LAUNCH();
    return cudaSuccess;
  }
}

// into out (7 ints): registers a thread, local memory a thread (spills),
// static shared memory, the dynamic shared memory its launcher sets (set
// here too), the blocks an SM at `threads` threads, the blocks a cluster
// (1: launched without clusters) and 0 (the clusters the card holds at
// once, pair_attributes)
template <typename Kernel>
cudaError_t attributes(int* out, Kernel kernel, int threads, size_t bytes) {
  cudaFuncAttributes a;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, bytes);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)bytes;
  out[4] = blocks;
  out[5] = 1;
  out[6] = 0;
  return cudaSuccess;
}

// attributes() of a paired kernel: out[5] kPairCluster, out[6] the clusters
// of it that the card holds at once
template <typename Kernel>
cudaError_t pair_attributes(int* out, Kernel kernel, size_t bytes) {
  cudaError_t err = attributes(out, kernel, kWgThreads, bytes);
  if (err == cudaSuccess) err = pair_clusters(&out[6], kernel, bytes);
  out[5] = kPairCluster;
  return err;
}

// the 'mma' kernels by number: 0 dQ, 1 dK/dV, 2 forward, the kernel a head
// of exactly D runs, and 3 + the number for the padded kernel (d < D); at
// the widths above kExactWidth every head runs the same kernels, the Hopper
// ones
template <int D>
cudaError_t mma_attributes(int* out, int kernel) {
  if constexpr (D <= kExactWidth) {
    constexpr int B = kBwdThreads, F = kFwdThreads;
    constexpr size_t dq = DqGeo<D>::bytes, dkv = DkvGeo<D>::bytes,
                     fwd = FwdGeo<D>::bytes;
    if (kernel == 0) return attributes(out, bwd_dq_mma_kernel<D>, B, dq);
    if (kernel == 1) return attributes(out, bwd_dkv_mma_kernel<D>, B, dkv);
    if (kernel == 2) return attributes(out, fwd_mma_kernel<D>, F, fwd);
    if (kernel == 3)
      return attributes(out, bwd_dq_mma_padded_kernel<D>, B, dq);
    if (kernel == 4)
      return attributes(out, bwd_dkv_mma_padded_kernel<D>, B, dkv);
    if (kernel == 5) return attributes(out, fwd_mma_padded_kernel<D>, F, fwd);
  } else if (kernel >= 0 && kernel < 6) {
    constexpr int W = kWgThreads;
    constexpr size_t dq = WgDqGeo<D>::bytes, dkv = WgDkvGeo<D>::bytes,
                     fwd = WgFwdGeo<D>::bytes;
    kernel %= 3;
    if (kernel == 0) return attributes(out, bwd_dq_wg_mma_kernel<D>, W, dq);
    if (kernel == 1) return attributes(out, bwd_dkv_wg_mma_kernel<D>, W, dkv);
    if (kernel == 2) return attributes(out, fwd_wg_mma_kernel<D>, W, fwd);
  }
  return cudaErrorInvalidValue;
}

// the wide 'mma' kernels by the same numbers: 0 dQ, 1 dK/dV, 2 forward
inline cudaError_t wide_attributes(int* out, int kernel) {
  constexpr int B = kBwdThreads;
  if (kernel == 0)
    return attributes(out, bwd_dq_wide_mma_kernel, B, WideGeo<true>::bytes);
  if (kernel == 1)
    return attributes(out, bwd_dkv_wide_mma_kernel, B, WideGeo<true>::bytes);
  if (kernel == 2)
    return attributes(out, fwd_wide_mma_kernel, B, WideGeo<false>::bytes);
  return cudaErrorInvalidValue;
}

// the wide 'mma' kernel `kernel` (0 dQ, 1 dK/dV, 2 forward) that a head of
// padded width `width` over kNarrowMax runs: the Hopper wide kernels up to
// kWgWideMax, the paired ones up to kWgPairMax, else the wide kernels
inline cudaError_t wide_attributes(int* out, int kernel, int width) {
  constexpr int W = kWgThreads;
  const bool pair = width > kWgWideMax && width <= kWgPairMax;
  if (pair && kernel == 0)
    return pair_attributes(out, bwd_dq_wg_pair_kernel, WgPairDqGeo::bytes);
  if (pair && kernel == 1)
    return pair_attributes(out, bwd_dkv_wg_pair_kernel, WgPairDkvGeo::bytes);
  if (pair && kernel == 2)
    return pair_attributes(out, fwd_wg_pair_kernel, WgPairFwdGeo::bytes);
  if (width <= kWgWideMax && kernel == 0)
    return attributes(out, bwd_dq_wg_wide_kernel, W, WgWideDqGeo::bytes);
  if (width <= kWgWideMax && kernel == 1)
    return attributes(out, bwd_dkv_wg_wide_kernel, W, WgWideDkvGeo::bytes);
  if (width <= kWgWideMax && kernel == 2)
    return attributes(out, fwd_wg_wide_kernel, W, WgWideFwdGeo::bytes);
  return wide_attributes(out, kernel);
}

inline bool route_fits(int route, int dtype) {
  return (route == kRouteMma && dtype == kBFloat16) ||
         (route == kRouteF32 && dtype == kFloat32);
}


// the wide kernels (heads over kNarrowMax): grid (bh x own tiles, chunks,
// zs), zs = 2 for dK/dV
template <typename Kernel>
cudaError_t launch_wide(Kernel kernel, WideArgs a, int bh, int own, int rows,
                        int threads, size_t bytes, int zs,
                        cudaStream_t stream) {
  a.own_tiles = tiles_of(own, rows);
  if (!grid_fits(bh, a.own_tiles)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)(bh * a.own_tiles), wide_chunks(a.d), zs), threads,
           bytes, stream>>>(a);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

inline cudaError_t launch_fwd_wide(const WideArgs& a, int bh, int dtype,
                                   cudaStream_t s) {
  if (dtype == kFloat32)
    return launch_wide(fwd_wide_f32_kernel, a, bh, a.n, WideF32::tile,
                       WideF32::threads, WideF32::bytes, 1, s);
  return launch_wide(fwd_wide_mma_kernel, a, bh, a.n, kWideRows, kBwdThreads,
                     WideGeo<false>::bytes, 1, s);
}

inline cudaError_t launch_dq_wide(const WideArgs& a, int bh, int dtype,
                                  cudaStream_t s) {
  if (dtype == kFloat32)
    return launch_wide(bwd_dq_wide_f32_kernel, a, bh, a.n, WideF32::tile,
                       WideF32::threads, WideF32::bytes, 1, s);
  return launch_wide(bwd_dq_wide_mma_kernel, a, bh, a.n, kWideRows,
                     kBwdThreads, WideGeo<true>::bytes, 1, s);
}

inline cudaError_t launch_dkv_wide(const WideArgs& a, int bh, int dtype,
                                   cudaStream_t s) {
  if (dtype == kFloat32)
    return launch_wide(bwd_dkv_wide_f32_kernel, a, bh, a.m, WideF32::tile,
                       WideF32::threads, WideF32::bytes, 2, s);
  return launch_wide(bwd_dkv_wide_mma_kernel, a, bh, a.m, kWideRows,
                     kBwdThreads, WideGeo<true>::bytes, 2, s);
}

// a wide head: the route fits the dtype, d a multiple of 8
inline bool wide_fits(int route, int dtype, int d) {
  return route_fits(route, dtype) && d > kNarrowMax && d % 8 == 0;
}

// a wide head the Hopper wide kernels take ('mma', d <= 512)
inline bool wg_wide(int route, int d) {
  return route == kRouteMma && d <= kWgWideMax;
}

inline cudaError_t launch_fwd_wg_wide(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, float* lse, int bh, int n,
                                      int m, int d, int groups, int causal,
                                      float scale, cudaStream_t stream) {
  typedef WgWideFwdGeo G;
  const int tiles = tiles_of(n, G::rows);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const auto kernel = fwd_wg_wide_kernel;
  CUtensorMap mq, mk, mv;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::tile);
  if (err == cudaSuccess) err = wg_registers_fit(kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, G::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bh * tiles), kWgThreads, G::bytes, stream>>>(
      mq, mk, mv, (const bf16*)v, (const bf16*)bias, (bf16*)out, lse, n, m,
      d, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// grid (bh x key blocks, 1, 2): z 0 the dV blocks, 1 the dK blocks
inline cudaError_t launch_dkv_wg_wide(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* dout, const float* lse,
                                      const float* delta, void* dk, void* dv,
                                      int bh, int n, int m, int d, int groups,
                                      int causal, float scale,
                                      cudaStream_t stream) {
  typedef WgWideDkvGeo G;
  const int tiles = tiles_of(m, G::keys);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const auto kernel = bwd_dkv_wg_wide_kernel;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mdo, dout, bh, n, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::keys);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::keys);
  if (err == cudaSuccess) err = wg_registers_fit(kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, G::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)(bh * tiles), 1, 2), kWgThreads, G::bytes,
           stream>>>(mq, mk, mv, mdo, (const bf16*)bias, (const bf16*)dout,
                     lse, delta, (bf16*)dk, (bf16*)dv, n, m, d, tiles, groups,
                     causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

inline cudaError_t launch_dq_wg_wide(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dq,
                                     float* dbias, int bh, int n, int m,
                                     int d, int groups, int causal,
                                     float scale, cudaStream_t stream) {
  typedef WgWideDqGeo G;
  const int tiles = tiles_of(n, G::rows);
  if (!grid_fits(bh, tiles)) return cudaErrorInvalidValue;
  const auto kernel = bwd_dq_wg_wide_kernel;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mdo, dout, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::tile);
  if (err == cudaSuccess) err = wg_registers_fit(kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, G::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)(bh * tiles), kWgThreads, G::bytes, stream>>>(
      mq, mk, mv, mdo, (const bf16*)bias, lse, delta, (bf16*)dq, dbias, n, m,
      d, tiles, groups, causal, scale);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

// a head the paired kernels take ('mma', kWgWideMax < d <= kWgPairMax)
inline bool wg_pair(int route, int d) {
  return route == kRouteMma && d > kWgWideMax && d <= kWgPairMax;
}

// grid (bh x query blocks x kPairCluster): a cluster a block of rows
inline cudaError_t launch_fwd_wg_pair(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, float* lse, int bh, int n,
                                      int m, int d, int groups, int causal,
                                      float scale, cudaStream_t stream) {
  typedef WgPairFwdGeo G;
  const int tiles = tiles_of(n, G::rows);
  if (!grid_fits(bh, kPairCluster * tiles)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::tile);
  if (err != cudaSuccess) return err;
  return launch_pair(fwd_wg_pair_kernel,
                     dim3((unsigned)(kPairCluster * bh * tiles)), G::bytes,
                     stream, mq, mk, mv, (const bf16*)v, (const bf16*)bias,
                     (bf16*)out, lse, n, m, d, tiles, groups, causal, scale);
}

// grid (bh x key blocks x kPairCluster, 1, 2): z 0 the dV blocks, 1 the dK
// blocks, a cluster a block of keys
inline cudaError_t launch_dkv_wg_pair(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* dout, const float* lse,
                                      const float* delta, void* dk, void* dv,
                                      int bh, int n, int m, int d, int groups,
                                      int causal, float scale,
                                      cudaStream_t stream) {
  typedef WgPairDkvGeo G;
  const int tiles = tiles_of(m, G::keys);
  if (!grid_fits(bh, kPairCluster * tiles)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mdo, dout, bh, n, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::keys);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::keys);
  if (err != cudaSuccess) return err;
  return launch_pair(bwd_dkv_wg_pair_kernel,
                     dim3((unsigned)(kPairCluster * bh * tiles), 1, 2),
                     G::bytes, stream, mq, mk, mv, mdo, (const bf16*)bias,
                     (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv, n,
                     m, d, tiles, groups, causal, scale);
}

// grid (bh x query blocks x kPairCluster): a cluster a block of rows
inline cudaError_t launch_dq_wg_pair(const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dq,
                                     float* dbias, int bh, int n, int m,
                                     int d, int groups, int causal,
                                     float scale, cudaStream_t stream) {
  typedef WgPairDqGeo G;
  const int tiles = tiles_of(n, G::rows);
  if (!grid_fits(bh, kPairCluster * tiles)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = head_map(&mq, q, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mdo, dout, bh, n, d, G::rows);
  if (err == cudaSuccess) err = head_map(&mk, k, bh, m, d, G::tile);
  if (err == cudaSuccess) err = head_map(&mv, v, bh, m, d, G::tile);
  if (err != cudaSuccess) return err;
  return launch_pair(bwd_dq_wg_pair_kernel,
                     dim3((unsigned)(kPairCluster * bh * tiles)), G::bytes,
                     stream, mq, mk, mv, mdo, (const bf16*)bias, lse, delta,
                     (bf16*)dq, dbias, n, m, d, tiles, groups, causal, scale);
}

}  // namespace flash
}  // namespace mv2

// KERNEL<W>(args) at the padded width W of head size d
#define MV2_FLASH_WIDTHS(KERNEL, ...)                                  \
  switch (mv2::flash::head_width(d)) {                                 \
    case 16: return KERNEL<16>(__VA_ARGS__);                           \
    case 32: return KERNEL<32>(__VA_ARGS__);                           \
    case 64: return KERNEL<64>(__VA_ARGS__);                           \
    case 128: return KERNEL<128>(__VA_ARGS__);                         \
    default: return KERNEL<256>(__VA_ARGS__);                          \
  }

// F32<W>(args) for float32 or MMA<W>(args) for bf16, at the padded width of
// head size d, once route_fits(route, dtype) and head_fits(d) hold; any
// other call is cudaErrorInvalidValue.
#define MV2_FLASH_DISPATCH(F32, MMA, ...)                              \
  do {                                                                 \
    if (!mv2::flash::route_fits(route, dtype)) return cudaErrorInvalidValue; \
    if (!mv2::flash::head_fits(d)) return cudaErrorInvalidValue;       \
    if (dtype == mv2::kFloat32) MV2_FLASH_WIDTHS(F32, __VA_ARGS__)     \
    MV2_FLASH_WIDTHS(MMA, __VA_ARGS__)                                 \
  } while (0)

extern "C" {

// q (bh, n, d), k and v (bh, m, d), bias (groups, n, m) or null, all of
// `dtype`; out (bh, n, d) of `dtype`, lse (bh, n) float32 in natural log.
// d is any multiple of 8 (over 256 the Hopper wide kernels to 512, the
// paired ones to 1024 on 'mma', else the wide kernels). route is the
// wrapper's (Route) and must fit the dtype: kRouteMma bf16, kRouteF32
// float32.
int mv2_flash_attention_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* out, void* lse, int dtype,
                            int bh, int n, int m, int d, int groups,
                            int causal, float scale, int route,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > mv2::flash::kNarrowMax) {
    if (!mv2::flash::wide_fits(route, dtype, d)) return cudaErrorInvalidValue;
    if (mv2::flash::wg_wide(route, d))
      return mv2::flash::launch_fwd_wg_wide(q, k, v, bias, out, (float*)lse,
                                            bh, n, m, d, groups, causal,
                                            scale, s);
    if (mv2::flash::wg_pair(route, d))
      return mv2::flash::launch_fwd_wg_pair(q, k, v, bias, out, (float*)lse,
                                            bh, n, m, d, groups, causal,
                                            scale, s);
    return mv2::flash::launch_fwd_wide(
        {q, k, v, bias, nullptr, nullptr, nullptr, out, nullptr, (float*)lse,
         nullptr, n, m, d, 0, groups, causal, scale},
        bh, dtype, s);
  }
  MV2_FLASH_DISPATCH(mv2::flash::launch_fwd, mv2::flash::launch_fwd_mma, q, k,
                     v, bias, out, (float*)lse, bh, n, m, d, groups, causal,
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
  if (d > mv2::flash::kNarrowMax) {
    if (!mv2::flash::wide_fits(route, dtype, d)) return cudaErrorInvalidValue;
    if (mv2::flash::wg_wide(route, d))
      return mv2::flash::launch_dq_wg_wide(
          q, k, v, bias, dout, (const float*)lse, (const float*)delta, dq,
          (float*)dbias, bh, n, m, d, groups, causal, scale, s);
    if (mv2::flash::wg_pair(route, d))
      return mv2::flash::launch_dq_wg_pair(
          q, k, v, bias, dout, (const float*)lse, (const float*)delta, dq,
          (float*)dbias, bh, n, m, d, groups, causal, scale, s);
    return mv2::flash::launch_dq_wide(
        {q, k, v, bias, dout, (const float*)lse, (const float*)delta, dq,
         nullptr, nullptr, (float*)dbias, n, m, d, 0, groups, causal, scale},
        bh, dtype, s);
  }
  MV2_FLASH_DISPATCH(mv2::flash::launch_dq, mv2::flash::launch_dq_mma, q, k,
                     v, bias, dout, (const float*)lse, (const float*)delta,
                     dq, (float*)dbias, bh, n, m, d, groups, causal, scale, s);
}

// dk and dv (bh, m, d); route as for the forward.
int mv2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int dtype, int bh, int n, int m,
                                int d, int groups, int causal, float scale,
                                int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > mv2::flash::kNarrowMax) {
    if (!mv2::flash::wide_fits(route, dtype, d)) return cudaErrorInvalidValue;
    if (mv2::flash::wg_wide(route, d))
      return mv2::flash::launch_dkv_wg_wide(
          q, k, v, bias, dout, (const float*)lse, (const float*)delta, dk,
          dv, bh, n, m, d, groups, causal, scale, s);
    if (mv2::flash::wg_pair(route, d))
      return mv2::flash::launch_dkv_wg_pair(
          q, k, v, bias, dout, (const float*)lse, (const float*)delta, dk,
          dv, bh, n, m, d, groups, causal, scale, s);
    return mv2::flash::launch_dkv_wide(
        {q, k, v, bias, dout, (const float*)lse, (const float*)delta, dv, dk,
         nullptr, nullptr, n, m, d, 0, groups, causal, scale},
        bh, dtype, s);
  }
  MV2_FLASH_DISPATCH(mv2::flash::launch_dkv, mv2::flash::launch_dkv_mma, q,
                     k, v, bias, dout, (const float*)lse, (const float*)delta,
                     dk, dv, bh, n, m, d, groups, causal, scale, s);
}

// What the CUDA runtime reports for the 'mma' kernel `kernel` (0 dQ, 1
// dK/dV, 2 forward; 3, 4, 5 the same kernels' padded instantiations, for
// d < width; 6, 7, 8 the kernels a head over 256 of padded width `width`
// runs: the Hopper wide kernels up to 512, the paired ones up to 1024, else
// the wide kernels)
// at the padded width `width` (16, 32, 64, 128 or 256, or the head over
// 256), into out (7 ints): registers a thread, local memory a thread
// (spills), static shared memory, the dynamic shared memory its launcher
// sets, the blocks an SM, the blocks a cluster, and for a paired kernel
// the clusters the card holds at once (else 0).
int mv2_flash_mma_attributes(int kernel, int width, void* out) {
  int* o = static_cast<int*>(out);
  if (kernel >= 6)  // a head over 256
    return mv2::flash::wide_attributes(o, kernel - 6, width);
  switch (width) {
    case 16: return mv2::flash::mma_attributes<16>(o, kernel);
    case 32: return mv2::flash::mma_attributes<32>(o, kernel);
    case 64: return mv2::flash::mma_attributes<64>(o, kernel);
    case 128: return mv2::flash::mma_attributes<128>(o, kernel);
    case 256: return mv2::flash::mma_attributes<256>(o, kernel);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
