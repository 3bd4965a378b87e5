// The time attention block in one launch: x (B, T, S, C) -> RMSNorm(gamma)
// -> x Wqkv^T -> for each (pixel, head), softmax attention over its T frames
// (causal: t' <= t) plus M memory keys in one joint softmax -> Wout^T, with
// no residual. Replaces the TPU kernel
// magvit2_pytorch_tpu/ops/pallas/axial_attention.py _time_kernel (:224);
// ops/kernels/axial_attention.py wraps it (route 'fused', time_block_route)
// and holds its plain version (time_attention_block_ref).
//
// What bounds it on the H100: operations. At the flagship shape (8, 5, 256,
// 512) bf16, 8 heads x 32, 4 memory keys, the two projections are 10.7
// GFLOP (0.0109 ms at 989 TFLOP/s) against 22 MB of x, output and weights
// (0.0066 ms at 3.35 TB/s); the attention itself is 0.7% of the FLOPs.
// The design keeps everything between x and the output on chip, as the
// Pallas kernel keeps it in VMEM:
//
// - A block owns one batch index b and P consecutive pixels s0 .. s0 + P -
//   1 over all T frames: R = T P <= 60 rows in one 64-row wgmma M tile
//   (60 rows keep two weight stages in shared memory at the widest shape
//   taken, kTbMaxRows). Panel row t P + p is frame t of pixel s0 + p. The
//   wrapper picks P (time_block_pixels): the fewest pixels that keep the
//   launch at its least number of waves, 8 at the flagship (256 blocks,
//   two waves on 132 SMs). The x tile is one TMA box {64 channels, P pixels, T frames} a
//   64-channel chunk, from a 3-D map of x as (B T, S, C): pixels past S
//   arrive as zeros (the last tile of a b is masked) and a box never
//   leaves its batch index. Each chunk is 64 rows of 128 bytes, 128-byte
//   swizzled: the K-major layout wgmma reads.
// - The norm runs in place on that panel, a warp a row: the sum of squares
//   in float32, x rsqrt(sum + 1e-24) sqrt(C) rounded to bf16, then times
//   gamma in bf16 (_rmsnorm's cast points, axial_attention.py:38-43).
// - qkv = xn Wqkv^T on wgmma: a weight tile is 256 rows x 64 K, and each
//   of two consumer warpgroups owns half its columns (m64n128k16), A the
//   panel in shared memory. A producer warp streams the tiles through a
//   TMA ring of 2 to 4 stages, as many as shared memory holds (3 at the
//   flagship; time_plan); a stage goes back to it when both consumer
//   warpgroups have released it (an empty barrier a stage), so no block
//   barrier sits in the loop. float32 accumulators, each chunk
//   rounded once to bf16 into the qkv rows in shared memory
//   (_time_kernel's .astype(dtype), :234-235).
// - The attention on the CUDA cores of every warp but the producer: a
//   (frame, head, pixel) takes G lanes of a warp, each up to 32 of the
//   head's D values of q and of the output (G = 1 up to D = 32, 2 at 64, 4
//   at 128), so a thread's registers do not grow with D; at G > 1 a score
//   is the lanes' partial sums added by G-lane butterfly shuffles, the same
//   value on every lane of the group. Scores
//   q.k in float32 times D^-1/2 over the M memory keys and the visible
//   frames, one max over both, e = exp(s - max) and den = sum e in float32,
//   e rounded to bf16 before the products with v and mem_v, those summed
//   in float32, o / den rounded to bf16 (_time_kernel :252-272). Each pixel
//   attends over its own T frames: no masked (T P)^2 score tile. Groups
//   next to each other take neighbouring pixels. The loops over the keys
//   stay rolled, the scores computed twice (for the max, then for e):
//   unrolled over up to 16 + 4 keys the code ran slower. The output goes
//   into the x panel's place (x is dead by then), in the layout wgmma
//   reads.
// - out = attn Wout^T on the same ring (the producer loads the first Wout
//   tiles while the attention runs), 256 columns at a time, staged in shared
//   memory and stored to the output rows in 16-byte pieces.
// x is read once and the output written once, but every block streams
// the ~1 MB of weights from L2 (256 blocks at the flagship, ~0.26 GB a
// call), and an SM takes in ~25-30 bytes a clock from L2 through TMA, as
// csrc/gemm.cu does: the pixels a block and the ring are chosen to keep
// that stream ahead of the two consumer warpgroups (PERF.md §6).
// Shared memory at the flagship: the x / attn panel 64 KB, the ring 96 KB,
// the qkv rows 61 KB, memory KV 4 KB: one block of 16 warps an SM. Built
// for sm_90a.
#include "hopper.cuh"

namespace mv2 {

// route codes shared with ops/kernels/axial_attention.py TIME_ROUTES: the
// 'launches' route is composed in Python (gemm.cu, attention_block.cu)
enum TimeRoute { kTimeLaunches = 0, kTimeFused = 1 };

constexpr int kTbRows = 64;        // the panel's rows: one wgmma M tile
constexpr int kTbThreads = 512;    // sixteen warps:
constexpr int kTbMmaThreads = 256; // two consumer warpgroups (wgmma),
constexpr int kTbProducerWarp = 15;  // a producer warp (the weight ring),
constexpr int kTbWorkThreads = 480;  // and all but it for the CUDA-core work
constexpr int kTbMaxStages = 4;    // the weight ring: the deepest that
constexpr int kTbMinStages = 2;    // fits, 4 down to 2 stages
constexpr int kTbN = 256;          // weight rows a ring tile (N a chunk)
// the shapes the kernel takes (ops/kernels/axial_attention.py TIME_MAX_*
// and takes_dim_head route no other): rows a block, frames (the module's
// gate takes no more), memory keys (the configurations use 4), channels,
// heads x dim_head and dim_head (a multiple of 8); at all of them at once
// two weight stages fit (the static_assert below)
constexpr int kTbMaxRows = 60, kTbMaxT = 16, kTbMaxMem = 4;
constexpr int kTbMaxC = 512, kTbMaxInner = 256, kTbMaxD = 128;
constexpr int kTbChunk = kTbRows * 128;           // a 64-channel panel chunk
constexpr int kTbQkvPad = 8;       // bf16 past a qkv row: rows 16 B apart
constexpr int kTbStagePad = 8;     // bf16 past a staged output row
// the dynamic shared memory a block may ask for: 227 KB less 1 KB for the
// static barriers
constexpr int kTbSmemMax = 232448 - 1024;

constexpr int kTbWTile = kTbN * kSw128Cols * 2;  // a ring tile's bytes

// byte offsets into the 1024-aligned dynamic shared memory
struct TimeSmem {
  int panel;  // x, then attn: max(C, inner) / 64 chunks of kTbChunk
  int ring;   // `stages` weight tiles
  int qkv;    // R rows of 3 inner + kTbQkvPad, then the staged output
  int small;  // mem_k, mem_v (H, M, D)
  int total;  // with the 1024 bytes of alignment slack
};

// the layout with R rows, `inner` = heads x dim_head and `stages` ring
// tiles
constexpr TimeSmem time_smem(int R, int C, int inner, int M, int stages) {
  TimeSmem l{};
  l.panel = 0;
  l.ring = 2 * kTbRows * (C > inner ? C : inner);
  l.qkv = l.ring + stages * kTbWTile;
  const int qkv_rows = R * (3 * inner + kTbQkvPad);
  const int stage = kTbRows * (kTbN + kTbStagePad);
  l.small = l.qkv + 2 * (qkv_rows > stage ? qkv_rows : stage);
  l.total = 1024 + l.small + 2 * 2 * inner * M;
  return l;
}
static_assert(time_smem(kTbMaxRows, kTbMaxC, kTbMaxInner, kTbMaxMem,
                        kTbMinStages)
                      .total <= kTbSmemMax,
              "every shape taken must fit two weight stages");

// the plan of a call: false if the kernel does not take the shape, else
// the deepest ring that fits (stages) and its layout; the launcher and
// mv2_time_block_plan share it
inline bool time_plan(int T, int P, int C, int H, int D, int M,
                      int* stages, TimeSmem* smem) {
  const int inner = H * D;
  if (T < 1 || T > kTbMaxT || P < 1 || T * P > kTbMaxRows || C < 1 ||
      C > kTbMaxC || C % kSw128Cols || H < 1 || D < 8 || D > kTbMaxD ||
      D % 8 || inner > kTbMaxInner || inner % kSw128Cols || M < 0 ||
      M > kTbMaxMem)
    return false;  // not this route's call: the rule is
                   // axial_attention.py time_block_route
  for (*stages = kTbMaxStages; *stages > kTbMinStages; --*stages)
    if (time_smem(T * P, C, inner, M, *stages).total <= kTbSmemMax) break;
  *smem = time_smem(T * P, C, inner, M, *stages);
  return true;
}

struct TimeArgs {
  const bf16* gamma;
  const bf16* mem_k;
  const bf16* mem_v;
  bf16* out;
  int T, S, C, H, D, M, P, causal, stages;
  int lanes;  // a (frame, head, pixel)'s lanes: a power of two >= D / 32
  float scale;
  TimeSmem smem;
};

// 16-byte piece j (8 channels) of panel row r: chunk j / 8, its 16-byte
// column (j % 8) swizzled by the row (TMA's 128-byte swizzle)
__device__ __forceinline__ int panel_piece(int r, int j) {
  return (j >> 3) * kTbChunk + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ float2 bf16x2_to_f2(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

constexpr int kTbLanePieces = 4;  // 16-byte pieces (8 values) a lane holds

// s + q . piece over 8 values of a head (one 16-byte piece), in float32, in
// the order of d
__device__ __forceinline__ float dot8(const float* q, const bf16* piece,
                                      float s) {
  const uint4 u = *reinterpret_cast<const uint4*>(piece);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = bf16x2_to_f2(w[e]);
    s = fmaf(q[2 * e], f.x, s);
    s = fmaf(q[2 * e + 1], f.y, s);
  }
  return s;
}

// o += p * piece over 8 values of a head, in float32
__device__ __forceinline__ void axpy8(float* o, float p, const bf16* piece) {
  const uint4 u = *reinterpret_cast<const uint4*>(piece);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = bf16x2_to_f2(w[e]);
    o[2 * e] = fmaf(p, f.x, o[2 * e]);
    o[2 * e + 1] = fmaf(p, f.y, o[2 * e + 1]);
  }
}

// acc = A B for this consumer warpgroup's 128 columns (64 rows x 128
// columns: 64 floats a thread): A the panel's
// first ktiles chunks (64 rows), B the next ktiles weight tiles of the
// ring. Each tile waits on its stage's full barrier; after a tile's wgmmas
// are issued only the previous tile's are waited for, and each consumer
// warp releases that tile's stage to the producer (one arrival on its
// empty barrier); after the last tile all are waited for and the last
// stage released. The waits do not depend on the iteration (a wait that
// does makes ptxas serialize every wgmma of the kernel), and no block
// barrier sits in the loop. tile (the ring's next tile) carries over from
// call to call.
__device__ __forceinline__ void ring_gemm(float (&acc)[kTbN / 4],
                                          const unsigned char* panel,
                                          const unsigned char* ring,
                                          uint64_t* full, uint64_t* empty,
                                          int stages, int ktiles, int& tile) {
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kTbN / 4; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt, ++tile) {
    const int s = tile % stages;
    mbar_wait(&full[s], (tile / stages) & 1);
    const uint64_t da = sw128_desc(panel + kt * kTbChunk);
    const uint64_t db = sw128_desc(ring + s * kTbWTile + wg * (kTbWTile / 2));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSw128Cols / 16; ++kk)
      wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's wgmmas are done
    fence_acc(acc);
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(tile - 1) % stages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(&empty[(tile - 1) % stages]);
}

// kGuard: 0 where every lane's pieces are the head's (D = 32, 64, 128: the
// flagship's heads run the code with no check a piece), 1 for the other D
template <int kGuard>
__global__ void __launch_bounds__(kTbThreads, 1)
    time_block_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_wqkv,
                      const __grid_constant__ CUtensorMap map_wout,
                      const TimeArgs a) {
  extern __shared__ unsigned char tb_smem_raw[];
  __shared__ __align__(8) uint64_t full[kTbMaxStages];
  __shared__ __align__(8) uint64_t empty[kTbMaxStages];
  __shared__ __align__(8) uint64_t xbar;
  unsigned char* base = align1024(tb_smem_raw);
  unsigned char* panel = base + a.smem.panel;
  unsigned char* ring = base + a.smem.ring;
  bf16* qkv_s = reinterpret_cast<bf16*>(base + a.smem.qkv);
  const int T = a.T, P = a.P, R = T * P, C = a.C, H = a.H, D = a.D, M = a.M;
  const int stages = a.stages;
  const int inner = H * D, ncols = 3 * inner, ldq = ncols + kTbQkvPad;
  bf16* mk_s = reinterpret_cast<bf16*>(base + a.smem.small);
  bf16* mv_s = mk_s + inner * M;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wg = tid / 128, qw = (tid % 128) / 32;
  const int b = blockIdx.y, s0 = blockIdx.x * P;
  constexpr int kHalfN = kTbN / 2, kStageLd = kTbN + kTbStagePad;
  // weight tiles: the qkv chunks (each C / 64 K tiles), then the out chunks
  // (each inner / 64); 256 weight rows a chunk, rows past N read zeros
  const int kq = C / kSw128Cols, nq = (ncols + kTbN - 1) / kTbN;
  const int ko = inner / kSw128Cols, no = (C + kTbN - 1) / kTbN;
  const int q_tiles = nq * kq, total = q_tiles + no * ko;
  const int pchunks = (C > inner ? C : inner) / kSw128Cols;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTbMmaThreads / 32);  // one arrival a consumer warp
    }
    mbar_init(&xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&xbar, kq * kSw128Cols * 2 * R);
    for (int kc = 0; kc < kq; ++kc)
      tma_load_3d(panel + kc * kTbChunk, &map_x, &xbar, kc * kSw128Cols, s0,
                  b * T);
  }
  {  // memory keys and values, in 16-byte pieces (both aligned)
    const int nm = inner * M / 8;
    uint4* dst = reinterpret_cast<uint4*>(mk_s);  // mk_s, mv_s in a row
    for (int i = tid; i < 2 * nm; i += kTbThreads)
      dst[i] = i < nm ? reinterpret_cast<const uint4*>(a.mem_k)[i]
                      : reinterpret_cast<const uint4*>(a.mem_v)[i - nm];
  }
  // rows R..63 of every panel chunk are zeros (TMA writes rows < R): their
  // products are never stored, and zeros keep them finite
  const int pad_pieces = (kTbRows - R) * 8;
  for (int i = tid; i < pchunks * pad_pieces; i += kTbThreads) {
    const int r = R + (i % pad_pieces) / 8;
    *reinterpret_cast<uint4*>(panel + (i / pad_pieces) * kTbChunk + r * 128 +
                              (i % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();  // the barriers are initialised: the last block barrier

  // ---- the producer warp: the weight ring, all tiles, then done ----
  if (warp == kTbProducerWarp) {
    if (lane == 0)
      for (int i = 0; i < total; ++i) {
        const int s = i % stages;
        if (i >= stages)  // the consumers released the stage's last tile
          mbar_wait(&empty[s], ((i / stages) + 1) & 1);
        mbar_expect_tx(&full[s], kTbWTile);
        unsigned char* st = ring + s * kTbWTile;
        if (i < q_tiles)
          tma_load_2d(st, &map_wqkv, &full[s], (i % kq) * kSw128Cols,
                      (i / kq) * kTbN);
        else
          tma_load_2d(st, &map_wout, &full[s],
                      ((i - q_tiles) % ko) * kSw128Cols,
                      ((i - q_tiles) / ko) * kTbN);
      }
    return;
  }
  // from here on the other warps meet at named barrier 1 (kTbWorkThreads),
  // the consumers alone at barrier 2 (kTbMmaThreads)
  mbar_wait(&xbar, 0);

  // ---- RMSNorm in place: a warp a row, two rows at a time ----
  const float sqrt_c = sqrtf((float)C);
  auto sumsq = [&](int r, int j) {
    const uint4 u = *reinterpret_cast<const uint4*>(panel + panel_piece(r, j));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = bf16x2_to_f2(w[e]);
      ss = fmaf(f.x, f.x, ss);
      ss = fmaf(f.y, f.y, ss);
    }
    return ss;
  };
  auto normed = [&](int r, int j, float inv) {
    uint4* pv = reinterpret_cast<uint4*>(panel + panel_piece(r, j));
    const uint4 u = *pv, gu = reinterpret_cast<const uint4*>(a.gamma)[j];
    unsigned w[4] = {u.x, u.y, u.z, u.w};
    const unsigned g[4] = {gu.x, gu.y, gu.z, gu.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = bf16x2_to_f2(w[e]), gf = bf16x2_to_f2(g[e]);
      w[e] = pack_bf16(round_to<bf16>(f.x * inv * sqrt_c) * gf.x,
                       round_to<bf16>(f.y * inv * sqrt_c) * gf.y);
    }
    *pv = make_uint4(w[0], w[1], w[2], w[3]);
  };
  constexpr int kWarps = kTbWorkThreads / 32;
  for (int r = warp; r < R; r += 2 * kWarps) {
    const int r2 = r + kWarps;
    const bool two = r2 < R;
    float ss = 0.f, ss2 = 0.f;
    for (int j = lane; j < C / 8; j += 32) {
      ss += sumsq(r, j);
      if (two) ss2 += sumsq(r2, j);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      ss2 += __shfl_xor_sync(0xffffffffu, ss2, o);
    }
    const float inv = 1.f / sqrtf(ss + 1e-24f);
    const float inv2 = 1.f / sqrtf(ss2 + 1e-24f);
    for (int j = lane; j < C / 8; j += 32) {
      normed(r, j, inv);
      if (two) normed(r2, j, inv2);
    }
  }
  fence_proxy_async();  // the normed panel is wgmma's A
  bar_sync(1, kTbWorkThreads);

  // ---- qkv = xn Wqkv^T, each chunk rounded once into the qkv rows ----
  int tile = 0;
  const int r0 = qw * 16 + lane / 4;  // accumulator rows r0 and r0 + 8
  if (tid < kTbMmaThreads) {
    for (int n = 0; n < nq; ++n) {
      float acc[kTbN / 4];
      ring_gemm(acc, panel, ring, full, empty, stages, kq, tile);
#pragma unroll
      for (int j = 0; j < kHalfN / 8; ++j) {
        const int col = n * kTbN + wg * kHalfN + 8 * j + 2 * (lane % 4);
        if (col >= ncols) continue;
        if (r0 < R)
          *reinterpret_cast<unsigned*>(qkv_s + r0 * ldq + col) =
              pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < R)
          *reinterpret_cast<unsigned*>(qkv_s + (r0 + 8) * ldq + col) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  bar_sync(1, kTbWorkThreads);

  // ---- attention: G lanes a (frame, head, pixel), pixels fastest ----
  // a warp takes 32 / G (frame, head, pixel)s at a time; lane gl of a group
  // holds pieces gl * 4 .. gl * 4 + 3 of the head, those past D / 8 add
  // nothing, and a lane past the last (frame, head, pixel) stores nothing.
  // At G > 1 every lane of the warp takes part in every shuffle: the loop
  // over the frames runs to the warp's furthest visible frame, and a lane
  // uses only the scores of its own visible ones
  constexpr int kV = 8 * kTbLanePieces;  // values a lane holds
  const int G = a.lanes, nd = D / 8, items = T * H * P;
  for (int slot0 = warp * 32; slot0 < items * G; slot0 += kTbWorkThreads) {
    const int slot = slot0 + lane, j0 = (lane & (G - 1)) * kTbLanePieces;
    const int it = min(slot / G, items - 1);
    const int p = it % P, h = (it / P) % H, t = it / (P * H);
    const int r = t * P + p;
    float q[kV];
    {
      const bf16* qr = qkv_s + r * ldq + h * D;
#pragma unroll
      for (int k = 0; k < kTbLanePieces; ++k) {
        uint4 u = make_uint4(0, 0, 0, 0);
        if (!kGuard || j0 + k < nd)
          u = *reinterpret_cast<const uint4*>(qr + 8 * (j0 + k));
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = bf16x2_to_f2(w[e]);
          q[8 * k + 2 * e] = f.x;
          q[8 * k + 2 * e + 1] = f.y;
        }
      }
    }
    const int visible = a.causal ? t + 1 : T;
    const int reach = G > 1 ? __reduce_max_sync(0xffffffffu, visible)
                            : visible;
    const bf16* mk = mk_s + h * M * D;
    const bf16* mv = mv_s + h * M * D;
    const bf16* kcol = qkv_s + p * ldq + inner + h * D;  // frame 0's k
    const bf16* vcol = kcol + inner;
    // the score of a key: this lane's products in the order of d, the
    // group's sum, the scale (__fmul_rn keeps the compiler from fusing it
    // into the subtraction, so both passes see the same value)
    auto score = [&](const bf16* key) {
      float sc = 0.f;
#pragma unroll
      for (int k = 0; k < kTbLanePieces; ++k)
        if (!kGuard || j0 + k < nd)
          sc = dot8(q + 8 * k, key + 8 * (j0 + k), sc);
      for (int off = G / 2; off > 0; off >>= 1)
        sc += __shfl_xor_sync(0xffffffffu, sc, off);
      return __fmul_rn(sc, a.scale);
    };
    auto axpy = [&](float (&o)[kV], float e, const bf16* val) {
#pragma unroll
      for (int k = 0; k < kTbLanePieces; ++k)
        if (!kGuard || j0 + k < nd) axpy8(o + 8 * k, e, val + 8 * (j0 + k));
    };
    // two passes over the keys, each a rolled loop: the max of the scores,
    // then each score again, its e, den and the products with v in float32
    float mx = -INFINITY;
#pragma unroll 1
    for (int j = 0; j < M; ++j) mx = fmaxf(mx, score(mk + j * D));
#pragma unroll 1
    for (int u = 0; u < reach; ++u) {
      const float sc = score(kcol + u * P * ldq);
      if (u < visible) mx = fmaxf(mx, sc);
    }
    float o[kV];
#pragma unroll
    for (int d = 0; d < kV; ++d) o[d] = 0.f;
    float den = 0.f;
#pragma unroll 1
    for (int u = 0; u < reach; ++u) {
      const float sc = score(kcol + u * P * ldq);
      if (u >= visible) continue;
      const float e = expf(sc - mx);
      den += e;
      axpy(o, round_to<bf16>(e), vcol + u * P * ldq);
    }
#pragma unroll 1
    for (int j = 0; j < M; ++j) {
      const float e = expf(score(mk + j * D) - mx);
      den += e;
      axpy(o, round_to<bf16>(e), mv + j * D);
    }
    if (slot < items * G) {
#pragma unroll
      for (int k = 0; k < kTbLanePieces; ++k)  // the pieces in the attn row
        if (!kGuard || j0 + k < nd)
          *reinterpret_cast<uint4*>(panel +
                                    panel_piece(r, h * nd + j0 + k)) =
              make_uint4(pack_bf16(o[8 * k] / den, o[8 * k + 1] / den),
                         pack_bf16(o[8 * k + 2] / den, o[8 * k + 3] / den),
                         pack_bf16(o[8 * k + 4] / den, o[8 * k + 5] / den),
                         pack_bf16(o[8 * k + 6] / den, o[8 * k + 7] / den));
    }
  }
  fence_proxy_async();  // the attn panel is wgmma's A
  bar_sync(1, kTbWorkThreads);

  // ---- out = attn Wout^T, a 256-column chunk at a time (the consumers) ----
  if (tid >= kTbMmaThreads) return;
  bf16* stage = qkv_s;  // the qkv rows are dead
  for (int n = 0; n < no; ++n) {
    float acc[kTbN / 4];
    ring_gemm(acc, panel, ring, full, empty, stages, ko, tile);
#pragma unroll
    for (int j = 0; j < kHalfN / 8; ++j) {
      const int c = wg * kHalfN + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<unsigned*>(stage + r0 * kStageLd + c) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<unsigned*>(stage + (r0 + 8) * kStageLd + c) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    bar_sync(2, kTbMmaThreads);
    // 16-byte pieces, consecutive threads along a row; C is a multiple of
    // 64, so a piece is wholly inside C or wholly past it
    constexpr int pieces = kTbN / 8;  // 16-byte pieces a staged row
    for (int i = tid; i < R * pieces; i += kTbMmaThreads) {
      const int r = i / pieces, col = n * kTbN + (i % pieces) * 8;
      const int t = r / P, s = s0 + r % P;
      if (s < a.S && col < C)
        *reinterpret_cast<uint4*>(a.out + ((size_t)(b * T + t) * a.S + s) * C +
                                  col) =
            *reinterpret_cast<const uint4*>(stage + r * kStageLd +
                                            (i % pieces) * 8);
    }
    bar_sync(2, kTbMmaThreads);  // the stage is rewritten by the next chunk
  }
}

template <int kGuard>
cudaError_t launch_time_kernel(const CUtensorMap& map_x,
                               const CUtensorMap& map_wqkv,
                               const CUtensorMap& map_wout, const TimeArgs& a,
                               dim3 grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      time_block_kernel<kGuard>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem.total);
  if (err != cudaSuccess) return err;
  time_block_kernel<kGuard><<<grid, kTbThreads, a.smem.total, stream>>>(
      map_x, map_wqkv, map_wout, a);
  MV2_CHECK_LAUNCH();
  return cudaSuccess;
}

cudaError_t launch_time_block(const bf16* x, const bf16* gamma,
                              const bf16* wqkv, const bf16* mem_k,
                              const bf16* mem_v, const bf16* wout, bf16* out,
                              int B, int T, int S, int C, int H, int D, int M,
                              int P, int causal, cudaStream_t stream) {
  TimeArgs a;
  if (B < 1 || S < 1 || !time_plan(T, P, C, H, D, M, &a.stages, &a.smem) ||
      ((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)wqkv | (uintptr_t)mem_k |
       (uintptr_t)mem_v | (uintptr_t)wout | (uintptr_t)out) %
          16)
    return cudaErrorInvalidValue;
  const int inner = H * D;
  a.gamma = gamma;
  a.mem_k = mem_k;
  a.mem_v = mem_v;
  a.out = out;
  a.T = T;
  a.S = S;
  a.C = C;
  a.H = H;
  a.D = D;
  a.lanes = 1;
  while (8 * kTbLanePieces * a.lanes < D) a.lanes *= 2;
  a.M = M;
  a.P = P;
  a.causal = causal;
  a.scale = (float)(1.0 / sqrt((double)D));  // Python's dim_head ** -0.5
  CUtensorMap map_x, map_wqkv, map_wout;
  const long long xdims[3] = {C, S, (long long)B * T};
  const int xbox[3] = {kSw128Cols, P, T};
  cudaError_t err = tensor_map(&map_x, x, 3, xdims, xbox);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&map_wqkv, wqkv, 3 * inner, C, kTbN);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&map_wout, wout, C, inner, kTbN);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + P - 1) / P, B);
  if (8 * kTbLanePieces * a.lanes == D)  // every lane's pieces are whole
    return launch_time_kernel<0>(map_x, map_wqkv, map_wout, a, grid, stream);
  return launch_time_kernel<1>(map_x, map_wqkv, map_wout, a, grid, stream);
}

}  // namespace mv2

extern "C" {

// out (B, T, S, C) = the time attention block of x on the fused route:
// bf16, `pixels` pixels a block (T * pixels <= 60), the shapes time_plan
// takes; any other route or call returns cudaErrorInvalidValue
int mv2_time_attention_block(const void* x, const void* gamma,
                             const void* wqkv, const void* mem_k,
                             const void* mem_v, const void* wout, void* out,
                             int dtype, int B, int T, int S, int C, int H,
                             int D, int M, int pixels, int causal, int route,
                             void* stream) {
  if (route != mv2::kTimeFused || dtype != mv2::kBFloat16)
    return cudaErrorInvalidValue;
  typedef mv2::bf16 T16;
  return mv2::launch_time_block(
      (const T16*)x, (const T16*)gamma, (const T16*)wqkv, (const T16*)mem_k,
      (const T16*)mem_v, (const T16*)wout, (T16*)out, B, T, S, C, H, D, M,
      pixels, causal, static_cast<cudaStream_t>(stream));
}

// What the launcher plans for a call of `pixels` pixels a block, into out
// (2 ints): the weight ring's stages and the dynamic shared memory it asks
// for; cudaErrorInvalidValue where the kernel does not take the shape.
int mv2_time_block_plan(int T, int pixels, int C, int H, int D, int M,
                        void* out) {
  int stages;
  mv2::TimeSmem smem;
  if (!mv2::time_plan(T, pixels, C, H, D, M, &stages, &smem))
    return cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  o[0] = stages;
  o[1] = smem.total;
  return cudaSuccess;
}

// What the CUDA runtime reports for time_block_kernel<0> (the flagship's
// heads), into out (4 ints): registers a thread, local memory a thread
// (spills), static shared memory, and the dynamic shared memory its
// launcher last set (on every launch).
int mv2_time_block_attributes(void* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, mv2::time_block_kernel<0>);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  o[2] = (int)a.sharedSizeBytes;
  o[3] = a.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

}  // extern "C"
