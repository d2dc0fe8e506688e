// Row-invariant GEMM for Hopper (sm_90a): y = x @ w (+ b) for every
// Linear of the port on the card, and the batched products beside them.
//
// Replaces no TPU kernel: the reference's products are XLA dots outside
// any Pallas kernel (src/repro/models/layers.py, `x @ w.astype(x.dtype)`).
// It exists for the reference's determinism contract (docs/serving.md): a
// seeded request's x0 depends only on the compiled shape, not on the rows
// beside it.  cuBLAS picks its kernel, its tile and any split of K from M
// (rows x seq), so a row's dot products were summed in another order at
// batch bucket 1 than at bucket 8.  Here the instance, the tile, the
// stages, the split of K and the order of the K loop are set by
// gemm_config(K, N, dtype) (kernels/gemm.py) and passed in; each output
// element is one chain over its K tiles in order (or, split, one chain a
// split summed by a second kernel in split order), no atomics; rows past M
// and K past its end read as exact zeros, which add nothing.  What depends
// on M (and on the batch G) is only which block computes which tile, which
// changes no value.  So row i of x[:m] @ w is bitwise row i of x @ w for
// every m, and batch g of a batched call is bitwise batch g alone.
//
// bf16 instance (x (M, K) and w (K, N) row-major, w in the (d_in, d_out)
// layout Linear stores; float32 accumulation; the product rounded to bf16,
// then the bias add rounded again, as `x @ w + b` rounds in PyTorch):
//   * one tile a block of one producer warp and two consumer warpgroups,
//     block b taking tile b of the grouped order (GROUP_M row tiles, column
//     by column) with the batch and the split of K folded into the order;
//     a persistent grid (min(tiles, SMs) blocks walking their tiles, one
//     ring across them) measured slower at every path shape;
//   * a tile is BM x BN = 128 x BN (BN 256 from N = 4096, 64 at N <= 64,
//     else 128) over its split's K tiles of BK = 64;
//   * the producer warp keeps STAGES stages of A (128 x 64) and B (64 x
//     BN) tiles in flight through an mbarrier ring; by TMA (2-D tensor
//     maps, 128-byte swizzle; B as 64-column boxes, read MN-major by wgmma,
//     so w is used as stored), or, where a row pitch breaks TMA's 16-byte
//     rule (hymba's dt_proj K = 100, xLSTM's gate N = 4), by guarded loads
//     the warp writes into the same swizzled layout (then a proxy fence and
//     its arrival);
//   * both warpgroups take every tile, 64 rows each, as wgmma m64nBNk16
//     products (A K-major, B MN-major, both from shared memory), one group
//     in flight while the next stage's products issue;
//   * the epilogue rounds and adds the bias in registers and stores bf16
//     pairs straight from registers; a split tile stores its float32
//     partial instead, and gemm_reduce_kernel sums the splits in order,
//     rounds, adds the bias.
// float32 instances, no TF32 (TimeMLP, the MoE router, the mLSTM and sLSTM
// products, Mamba's readout):
//   * tiled (N > 1): a 128 x 64 block tile, K staged 16 at a time through
//     a 3-stage cp.async ring; thread (ty, tx) holds rows ty + 16 g (g < 8)
//     and columns 4 tx .. 4 tx + 3, read as float4 from shared memory, one
//     fmaf chain an output over the split's K in order; a row group wholly
//     past M is skipped (a small M pays for its rows only); where
//     gemm_config splits K, the partials are summed in order by
//     gemm_reduce_kernel;
//   * dot (N = 1): one warp a row, lane l over float4 chunks l, l + 32, ...
//     of K in order, then a fixed shuffle tree; at K <= 32 one thread a
//     row, one in-order chain.
//
// Batched instances (bgemm: y[g] = x[g] @ w[g] (+ b[g]), x (G, M, K), w (G,
// K, N)): the same kernels, the batch folded into the bf16 kernel's tile
// order and a grid axis of the float32 one, at the same gemm_config(K, N,
// dtype), which takes neither M nor G.  Tiles past M or K read zeros
// inside their own batch: TMA through 3-D maps over (G, M, K) and (G, K,
// N), whose edges are per batch, or guarded loads from batch g's base.  A
// split tile writes its partial to its own batch's slice of the workspace
// (split, G, M, N).  The MoE experts (bf16, G = E), the mLSTM products, the
// sLSTM's recurrent product and Mamba's readout (float32) run here.
//
// Bound (NVIDIA H100 80GB HBM3: 989 TFLOP/s bf16, 67 TFLOP/s float32
// outside the tensor cores, 3.35 TB/s): qwen2-1.5b's ERA request at 8 x
// 256 (M = 2048): wg / wi (1536 -> 8960) 56.4 GFLOP, 0.0570 ms
// (operations); wo (8960 -> 1536) the same; wq (1536 -> 1536) 9.7 GFLOP,
// 0.0098 ms; wk / wv (1536 -> 256) 1.6 GFLOP against 7.3 MB: 0.0022 ms
// (bytes).  At M = 256 (a 1-row request) every shape is bound by bytes
// (the weight's): wg 27.5 MB, 0.0082 ms.  Batched: deepseek-v2-lite's
// experts at an 8 x 256 request (G 64, M 240, 2048 -> 1408) 0.1419 ms
// (bytes, the weights'), mixtral's (G 8, M 640, 4096 -> 14336) 0.6080 ms
// (operations).  float32: xlstm's mLSTM scores (G 32, M 256, 512 -> 256)
// 0.0321 ms and inter-chunk product (N 512) 0.0641 ms (operations); its
// `den` dot (G 8192, M 1, K 512, N 1) 33.5 MB, 0.0100 ms; TimeMLP's w2 at
// 8 rows (1536 -> 1536) 0.0028 ms and the sLSTM step (G 4, M 8, 256 ->
// 1024) 0.0013 ms (bytes); hymba's readout (G 2048, M 3200, K 16, N 1)
// 0.1331 ms (bytes).  What the design leaves: the last wave's tail (192
// tiles on 132 SMs take two tile times), the stage feed of 128 x 128
// tiles (32 KB a stage for 2.1 MFLOP), and at few tiles (a 1-row request)
// the load rate of the SMs that have one.

#include <algorithm>
#include <climits>

#include "flash_sm90.cuh"

using namespace flash;
using namespace flash::sm90;

namespace {

constexpr int BM = 128;             // rows of a tile: two warpgroups of 64
constexpr int BK = 64;              // K of a stage: one 128-byte swizzled row of bf16
constexpr int WG = 128;             // threads of a consumer warpgroup
constexpr int NC = 2 * WG;          // consumer threads
constexpr int NTHREADS = NC + 32;   // and the producer warp
constexpr int GROUP_M = 8;          // row tiles a group of the tile order takes together
constexpr size_t SMEM_MAX = 232448;
constexpr int MAX_DEVICES = 64;

struct Params {
  CUtensorMap ta, tb;  // x (M, K), box (64, BM); w (K, N), box (64, BK); each
                       // 3-D over the batch in a batched launch
  const bf16* x;
  const bf16* w;
  const bf16* bias;    // (N,) or (G, N), or null
  bf16* y;             // (G, M, N)
  float* ws;           // (split, G, M, N) partials of a split launch, else null
  int G, M, K, N;      // G matrices of (M, K) @ (K, N); G = 1 unbatched
  int k_tiles;         // ceil(K / BK)
  int kps;             // K tiles of a split
  int split;
  int tiles_m, tiles_n;
};

template <int BN, int STAGES>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr size_t bar_off = size_t(STAGES) * STAGE;
  // full and empty a stage
  static constexpr size_t BYTES = 1024 + bar_off + 2 * STAGES * 8;
  static_assert(BN == 64 || BN == 128 || BN == 256, "one to four 64-column boxes of B");
  static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0, "swizzle-aligned tiles");
  static_assert(BYTES <= SMEM_MAX, "a block's shared memory");
};

// byte offset of (row r, column c) in a tile of 128-byte rows as TMA's
// 128-byte swizzle lays it out: 16-byte chunk c / 8 of row r at chunk
// (c / 8) ^ (r % 8)
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return uint32_t(r) * 128u + ((uint32_t((c >> 3) ^ (r & 7))) << 4) + uint32_t(c & 7) * 2u;
}

__device__ __forceinline__ bf16 round_bf16(float v) { return __float2bfloat16_rn(v); }

// y's value at one element from its float32 sum: the product rounded to
// bf16, then (with a bias) the bias added in float32 and rounded again
__device__ __forceinline__ bf16 epilogue(float acc, const bf16* bias, int col) {
  bf16 y = round_bf16(acc);
  if (bias != nullptr) y = round_bf16(__bfloat162float(y) + __bfloat162float(bias[col]));
  return y;
}

// one tile: its batch, split, first row and column, and K tiles
struct Item {
  int gb, z, m0, n0, kt0, nk;
};

// tile t of the order: the batch and the split outermost, then groups of
// GROUP_M row tiles, column by column inside a group (the blocks in flight
// share their A rows and B columns in L2)
template <int BN>
__device__ __forceinline__ Item item_at(const Params& p, int t) {
  const int per = p.tiles_m * p.tiles_n;
  const int outer = t / per, tile = t % per;
  Item it;
  it.gb = outer / p.split;
  it.z = outer % p.split;
  const int in_group = GROUP_M * p.tiles_n;
  const int first_m = (tile / in_group) * GROUP_M;
  const int group_m = min(p.tiles_m - first_m, GROUP_M);
  it.n0 = ((tile % in_group) / group_m) * BN;
  it.m0 = (first_m + (tile % in_group) % group_m) * BM;
  it.kt0 = it.z * p.kps;
  it.nk = min(p.k_tiles, it.kt0 + p.kps) - it.kt0;  // >= 1: gemm_config's rule
  return it;
}

// -- the epilogue ---------------------------------------------------------------

// a warp's 16 rows of a warpgroup's 64 (from row0): n8 block j, rows g8
// and g8 + 8, columns 2 t4 and 2 t4 + 1, stored from registers: bf16 pairs,
// or a split's float32 partials
template <int BN>
__device__ __forceinline__ void store_rows(const Params& p, const float (&acc)[BN / 2],
                                           const Item& it, int row0, int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
  const size_t mn = size_t(p.M) * p.N;
  const bf16* bias = p.bias == nullptr ? nullptr : p.bias + size_t(it.gb) * p.N;
  bf16* y = p.y + size_t(it.gb) * mn;
  const bool pairs = (p.N & 1) == 0;  // bf16x2 / float2 stores stay aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g8 + 8 * r;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = it.n0 + 8 * j + 2 * t4;
      if (col >= p.N) continue;
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (p.ws != nullptr) {
        float* out = p.ws + (size_t(it.z) * p.G + it.gb) * mn + size_t(row) * p.N + col;
        if (pairs) {
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        } else {
          out[0] = v0;
          if (col + 1 < p.N) out[1] = v1;
        }
      } else {
        bf16* out = y + size_t(row) * p.N + col;
        const bf16 y0 = epilogue(v0, bias, col);
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __halves2bfloat162(y0, epilogue(v1, bias, col + 1));
        } else {
          out[0] = y0;
          if (col + 1 < p.N) out[1] = epilogue(v1, bias, col + 1);
        }
      }
    }
  }
}

// -- the kernel -----------------------------------------------------------------

template <int BN, int STAGES, bool TMA, bool BATCHED>
__global__ void __launch_bounds__(NTHREADS, 1) gemm_bf16_kernel(const __grid_constant__ Params p) {
  using L = Smem<BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;
  auto a_tile = [&](int s) { return smem + size_t(s) * L::STAGE; };
  auto b_tile = [&](int s) { return a_tile(s) + L::A_BYTES; };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);  // the expect_tx arrival, or the warp's lanes
      mbar_init(&empty[s], NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const Item it = item_at<BN>(p, blockIdx.x);
  if (warp == NC / 32) {
    // producer: stage n % STAGES takes the tile's n-th K tile once the
    // consumers have freed it
    const bf16* x = p.x + size_t(it.gb) * p.M * p.K;
    const bf16* w = p.w + size_t(it.gb) * p.K * p.N;
    for (int n = 0; n < it.nk; ++n) {
      const int s = n % STAGES;
      if (n >= STAGES) mbar_wait(&empty[s], ((n / STAGES) - 1) & 1);
      const int k0 = (it.kt0 + n) * BK;
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], L::STAGE);
          if constexpr (BATCHED) {
            tma_load_3d(a_tile(s), &p.ta, &full[s], k0, it.m0, it.gb);
#pragma unroll
            for (int cb = 0; cb < BN / 64; ++cb)
              tma_load_3d(b_tile(s) + cb * (BK * 128), &p.tb, &full[s], it.n0 + 64 * cb, k0,
                          it.gb);
          } else {
            tma_load_2d(a_tile(s), &p.ta, &full[s], k0, it.m0);
#pragma unroll
            for (int cb = 0; cb < BN / 64; ++cb)
              tma_load_2d(b_tile(s) + cb * (BK * 128), &p.tb, &full[s], it.n0 + 64 * cb, k0);
          }
        }
      } else {
        unsigned char* at = a_tile(s);
        for (int i = lane; i < BM * BK; i += 32) {
          const int r = i / BK, cc = i % BK;
          const int row = it.m0 + r, k = k0 + cc;
          const bf16 v = row < p.M && k < p.K ? x[size_t(row) * p.K + k] : round_bf16(0.f);
          *reinterpret_cast<bf16*>(at + swizzled(r, cc)) = v;
        }
        unsigned char* bt = b_tile(s);
        for (int i = lane; i < BK * BN; i += 32) {
          const int r = i / BN, cc = i % BN;
          const int k = k0 + r, col = it.n0 + cc;
          const bf16 v = k < p.K && col < p.N ? w[size_t(k) * p.N + col] : round_bf16(0.f);
          *reinterpret_cast<bf16*>(bt + (cc / 64) * (BK * 128) + swizzled(r, cc % 64)) = v;
        }
        fence_proxy_async();  // the generic stores, before wgmma reads them
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup c computes rows 64 c .. 64 c + 63 of the tile; its
  // warp wl holds rows 16 wl .. 16 wl + 15 of them
  const int c = warp / 4, wl = warp % 4;
  float acc[BN / 2];
#pragma unroll
  for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
  int prev = -1;
  for (int n = 0; n < it.nk; ++n) {
    const int s = n % STAGES;
    mbar_wait(&full[s], (n / STAGES) & 1);
    const uint32_t ab = smem_addr(a_tile(s)) + c * (64 * 128);
    const uint32_t bb = smem_addr(b_tile(s));
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_mn<BN>(acc, desc_k<BK, 64>(ab, kk), desc_mn<BN, BK>(bb, kk), 1);
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();  // the previous stage's products are done
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_rows<BN>(p, acc, it, it.m0 + 64 * c + 16 * wl, lane);
}

// y = the split partials summed in split order (ws[0] + ws[1] + ...); bf16:
// rounded, then the bias (batch g's row) added and rounded again; float32:
// the bias added
template <typename T, bool BATCHED>
__global__ void gemm_reduce_kernel(const float* ws, const T* bias, T* y, int G, int M, int N,
                                   int split) {
  const size_t mn = size_t(M) * N, total = mn * G;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    float acc = ws[i];
    for (int z = 1; z < split; ++z) acc += ws[size_t(z) * total + i];
    const T* b = bias;
    if constexpr (BATCHED) {
      if (b != nullptr) b += (i / mn) * N;
    }
    if constexpr (sizeof(T) == 2) {
      y[i] = epilogue(acc, b, int(i % N));
    } else {
      y[i] = b != nullptr ? acc + b[i % N] : acc;
    }
  }
}

// -- float32 ------------------------------------------------------------------

constexpr int F_BM = 128, F_BN = 64, F_BK = 16, F_STAGES = 3, F_THREADS = 256;
// the dot instance: rows a block (a warp each, or a thread each at K <=
// DOT_THREAD_MAX_K)
constexpr int DOT_WARP_ROWS = F_THREADS / 32, DOT_THREAD_ROWS = F_THREADS;
constexpr int DOT_THREAD_MAX_K = 32;

struct F32Params {
  const float* x;
  const float* w;
  const float* bias;  // (N,) or (G, N), or null
  float* y;
  float* ws;          // (split, G, M, N) partials of a split launch, else null
  int G, M, K, N;
  int k_tiles;        // ceil(K / F_BK)
  int kps;            // K tiles of a split
  int split;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// one stage's products: for k in the stage's F_BK in order, each of this
// thread's outputs (rows ty + 16 g of the first `groups` row groups,
// columns 4 tx .. 4 tx + 3) takes one fmaf; FULL (every group holds rows
// of x) loads all its A values ahead of the products, the same chain
template <bool FULL>
__device__ __forceinline__ void stage_products(const float (&As)[F_BM][F_BK],
                                               const float (&Bs)[F_BK][F_BN],
                                               float (&acc)[F_BM / 16][4], int groups, int tx,
                                               int ty) {
#pragma unroll
  for (int k4 = 0; k4 < F_BK / 4; ++k4) {
    float4 b[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) b[kk] = *reinterpret_cast<const float4*>(&Bs[4 * k4 + kk][4 * tx]);
    if constexpr (FULL) {
      float4 a[F_BM / 16];
#pragma unroll
      for (int g = 0; g < F_BM / 16; ++g)
        a[g] = *reinterpret_cast<const float4*>(&As[ty + 16 * g][4 * k4]);
      // k outer, the row groups inner: an output's next fmaf is 32 apart
#pragma unroll
      for (int g = 0; g < F_BM / 16; ++g) fma4(acc[g], a[g].x, b[0]);
#pragma unroll
      for (int g = 0; g < F_BM / 16; ++g) fma4(acc[g], a[g].y, b[1]);
#pragma unroll
      for (int g = 0; g < F_BM / 16; ++g) fma4(acc[g], a[g].z, b[2]);
#pragma unroll
      for (int g = 0; g < F_BM / 16; ++g) fma4(acc[g], a[g].w, b[3]);
    } else {
#pragma unroll
      for (int g = 0; g < F_BM / 16; ++g) {
        if (g >= groups) break;
        const float4 a = *reinterpret_cast<const float4*>(&As[ty + 16 * g][4 * k4]);
        fma4(acc[g], a.x, b[0]);
        fma4(acc[g], a.y, b[1]);
        fma4(acc[g], a.z, b[2]);
        fma4(acc[g], a.w, b[3]);
      }
    }
  }
}

// a block owns an F_BM x F_BN tile of batch blockIdx.z over split
// blockIdx.x / tiles_n of K; VEC: K and N multiples of 4 (float4 copies)
template <bool VEC, bool BATCHED>
__global__ void __launch_bounds__(F_THREADS) gemm_f32_kernel(const __grid_constant__ F32Params p) {
  __shared__ __align__(16) float As[F_STAGES][F_BM][F_BK];
  __shared__ __align__(16) float Bs[F_STAGES][F_BK][F_BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_n = (p.N + F_BN - 1) / F_BN;
  const int n0 = (blockIdx.x % tiles_n) * F_BN, z = blockIdx.x / tiles_n;
  const int m0 = blockIdx.y * F_BM;
  const int gb = BATCHED ? int(blockIdx.z) : 0;
  const float* x = p.x + size_t(gb) * p.M * p.K;
  const float* w = p.w + size_t(gb) * p.K * p.N;
  const int kt0 = z * p.kps;
  const int nk = min(p.k_tiles, kt0 + p.kps) - kt0;  // >= 1: gemm_config's rule
  const int k_end = min(p.K, (kt0 + nk) * F_BK);
  // row groups of 16 holding a row of x: the rest are neither computed nor stored
  const int groups = min(F_BM / 16, (p.M - m0 + 15) / 16);

  auto load = [&](int st, int kt) {
    const int k0 = kt * F_BK;
    if constexpr (VEC) {
#pragma unroll
      for (int u = 0; u < F_BM * F_BK / 4 / F_THREADS; ++u) {
        const int ch = tid + F_THREADS * u, r = ch / (F_BK / 4), q = ch % (F_BK / 4);
        const int row = m0 + r, k = k0 + 4 * q;
        const bool ok = row < p.M && k < k_end;
        cp_async16(&As[st][r][4 * q], ok ? x + size_t(row) * p.K + k : x, ok);
      }
      const int kr = tid / (F_BN / 4), q = tid % (F_BN / 4);
      const int k = k0 + kr, col = n0 + 4 * q;
      const bool ok = k < k_end && col < p.N;
      cp_async16(&Bs[st][kr][4 * q], ok ? w + size_t(k) * p.N + col : w, ok);
    } else {
#pragma unroll
      for (int u = 0; u < F_BM * F_BK / F_THREADS; ++u) {
        const int e = tid + F_THREADS * u, r = e / F_BK, kk = e % F_BK;
        const int row = m0 + r, k = k0 + kk;
        const bool ok = row < p.M && k < k_end;
        cp_async4(&As[st][r][kk], ok ? x + size_t(row) * p.K + k : x, ok);
      }
#pragma unroll
      for (int u = 0; u < F_BK * F_BN / F_THREADS; ++u) {
        const int e = tid + F_THREADS * u, kr = e / F_BN, cc = e % F_BN;
        const int k = k0 + kr, col = n0 + cc;
        const bool ok = k < k_end && col < p.N;
        cp_async4(&Bs[st][kr][cc], ok ? w + size_t(k) * p.N + col : w, ok);
      }
    }
  };

  float acc[F_BM / 16][4];
#pragma unroll
  for (int g = 0; g < F_BM / 16; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int j = 0; j < nk; ++j) {
    cp_async_wait<F_STAGES - 2>();  // tile j has landed
    __syncthreads();                // and every thread is done with tile j - 1
    const int jn = j + F_STAGES - 1;
    if (jn < nk) load(jn % F_STAGES, kt0 + jn);
    cp_async_commit();
    const int st = j % F_STAGES;
    if (groups == F_BM / 16)
      stage_products<true>(As[st], Bs[st], acc, groups, tx, ty);
    else
      stage_products<false>(As[st], Bs[st], acc, groups, tx, ty);
  }

  const size_t mn = size_t(p.M) * p.N;
  float* out = p.ws != nullptr ? p.ws + (size_t(z) * p.G + gb) * mn : p.y + size_t(gb) * mn;
  const float* bias =
      p.ws == nullptr && p.bias != nullptr ? p.bias + size_t(gb) * p.N : nullptr;
  const int col = n0 + 4 * tx;
#pragma unroll
  for (int g = 0; g < F_BM / 16; ++g) {
    const int row = m0 + ty + 16 * g;
    if (g >= groups || row >= p.M) break;
    float v[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      v[jj] = bias != nullptr && col + jj < p.N ? acc[g][jj] + bias[col + jj] : acc[g][jj];
    float* o = out + size_t(row) * p.N + col;
    if (VEC && col + 3 < p.N) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (col + jj < p.N) o[jj] = v[jj];
    }
  }
}

// N = 1, one warp a row r of the G * M rows: lane l sums K's float4 chunks
// l, l + 32, ... (VEC) or its values l, l + 32, ... in order, then the
// lanes' sums meet in a fixed tree
template <bool VEC>
__global__ void __launch_bounds__(F_THREADS) gemm_dot_warp_kernel(const float* __restrict__ x,
                                                                  const float* __restrict__ w,
                                                                  const float* __restrict__ bias,
                                                                  float* __restrict__ y, int M,
                                                                  size_t rows, int K) {
  const size_t r = size_t(blockIdx.x) * DOT_WARP_ROWS + threadIdx.x / 32;
  if (r >= rows) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const size_t gb = r / M;
  const float* xr = x + r * K;
  const float* wc = w + gb * K;
  float acc = 0.f;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* w4 = reinterpret_cast<const float4*>(wc);
#pragma unroll 4
    for (int ch = lane; ch < K / 4; ch += 32) {
      const float4 a = x4[ch], b = w4[ch];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < K; k += 32) acc = fmaf(xr[k], wc[k], acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) y[r] = bias != nullptr ? acc + bias[gb] : acc;
}

// N = 1 at K <= DOT_THREAD_MAX_K: one thread a row, one in-order chain
template <bool VEC>
__global__ void __launch_bounds__(F_THREADS) gemm_dot_thread_kernel(const float* __restrict__ x,
                                                                    const float* __restrict__ w,
                                                                    const float* __restrict__ bias,
                                                                    float* __restrict__ y, int M,
                                                                    size_t rows, int K) {
  const size_t r = size_t(blockIdx.x) * DOT_THREAD_ROWS + threadIdx.x;
  if (r >= rows) return;
  const size_t gb = r / M;
  const float* xr = x + r * K;
  const float* wc = w + gb * K;
  float acc = 0.f;
  if constexpr (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* w4 = reinterpret_cast<const float4*>(wc);
#pragma unroll
    for (int ch = 0; ch < DOT_THREAD_MAX_K / 4; ++ch) {
      if (ch >= K / 4) break;
      const float4 a = x4[ch], b = w4[ch];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int k = 0; k < K; ++k) acc = fmaf(xr[k], wc[k], acc);
  }
  y[r] = bias != nullptr ? acc + bias[gb] : acc;
}

// -- launches -------------------------------------------------------------------

// the (BN, STAGES) pairs with an instance, each with a TMA and a guarded-load
// loader, unbatched and batched
#define GEMM_INSTANCES(X) X(64, 8) X(128, 4) X(256, 4)

// Raise the instance's dynamic shared-memory cap, once per card.
template <int BN, int STAGES, bool TMA, bool BATCHED>
cudaError_t allow_smem() {
  static int done[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gemm_bf16_kernel<BN, STAGES, TMA, BATCHED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(Smem<BN, STAGES>::BYTES));
  if (err == cudaSuccess) done[dev] = 1;
  return err;
}

template <int BN, int STAGES, bool TMA, bool BATCHED>
cudaError_t launch(Params& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<BN, STAGES, TMA, BATCHED>();
  if (err != cudaSuccess) return err;
  if constexpr (TMA && BATCHED) {
    if (!encode_map_3d(&p.ta, p.x, p.K, p.M, p.G, BM) ||
        !encode_map_3d(&p.tb, p.w, p.N, p.K, p.G, BK))
      return cudaErrorInvalidValue;
  } else if constexpr (TMA) {
    if (!encode_map_2d(&p.ta, p.x, p.K, p.M, BM) || !encode_map_2d(&p.tb, p.w, p.N, p.K, BK))
      return cudaErrorInvalidValue;
  }
  p.tiles_m = (p.M + BM - 1) / BM;
  p.tiles_n = (p.N + BN - 1) / BN;
  // one block a tile
  const long long tiles = 1LL * p.G * p.split * p.tiles_m * p.tiles_n;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  gemm_bf16_kernel<BN, STAGES, TMA, BATCHED>
      <<<int(tiles), NTHREADS, Smem<BN, STAGES>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

// the second pass of a split launch: y = the G * M * N partials summed in order
template <typename T, bool BATCHED>
cudaError_t reduce(const float* ws, const T* bias, T* y, int G, int M, int N, int split,
                   cudaStream_t s) {
  const size_t total = size_t(G) * M * N;
  const int blocks = int(std::min<size_t>((total + 255) / 256, 132 * 16));
  gemm_reduce_kernel<T, BATCHED><<<blocks, 256, 0, s>>>(ws, bias, y, G, M, N, split);
  return cudaGetLastError();
}

// the bf16 launch (and the split sum) of G (M, K) @ (K, N) products
template <bool BATCHED>
int bf16_products(const void* x, const void* w, const void* bias, void* y, float* ws, int G,
                  int M, int K, int N, int bn, int stages, int split, int kps, int tma,
                  void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.y = static_cast<bf16*>(y);
  p.ws = split > 1 ? ws : nullptr;
  p.G = G;
  p.M = M;
  p.K = K;
  p.N = N;
  p.k_tiles = (K + BK - 1) / BK;
  p.kps = kps;
  p.split = split;
  if (G < 1 || G > 65535 || M < 1 || split < 1 || kps < 1 || (split - 1) * kps >= p.k_tiles ||
      (split > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define GEMM_LAUNCH(B, S)                                                  \
  if (bn == B && stages == S)                                              \
    err = tma ? launch<B, S, true, BATCHED>(p, s) : launch<B, S, false, BATCHED>(p, s);
  GEMM_INSTANCES(GEMM_LAUNCH)
#undef GEMM_LAUNCH
  if (err != cudaSuccess || split == 1) return int(err);
  return int(reduce<bf16, BATCHED>(ws, p.bias, p.y, G, M, N, split, s));
}

// the float32 launch (and the split sum) of G (M, K) @ (K, N) products:
// mode 0 tiled, 1 dot by warps, 2 dot by threads
template <bool BATCHED>
int f32_products(const float* x, const float* w, const float* bias, float* y, float* ws, int G,
                 int M, int K, int N, int split, int kps, int mode, void* stream) {
  if (G < 1 || G > 65535 || M < 1 || K < 1 || N < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1 || mode == 2) {
    if (N != 1 || split != 1 || (mode == 2 && K > DOT_THREAD_MAX_K))
      return int(cudaErrorInvalidValue);
    const size_t rows = size_t(G) * M;
    const bool vec = K % 4 == 0;
    const size_t per = mode == 1 ? DOT_WARP_ROWS : DOT_THREAD_ROWS;
    const size_t blocks = (rows + per - 1) / per;
    if (blocks > size_t(INT_MAX)) return int(cudaErrorInvalidValue);
    if (mode == 1) {
      if (vec)
        gemm_dot_warp_kernel<true><<<unsigned(blocks), F_THREADS, 0, s>>>(x, w, bias, y, M, rows, K);
      else
        gemm_dot_warp_kernel<false><<<unsigned(blocks), F_THREADS, 0, s>>>(x, w, bias, y, M, rows, K);
    } else {
      if (vec)
        gemm_dot_thread_kernel<true><<<unsigned(blocks), F_THREADS, 0, s>>>(x, w, bias, y, M, rows, K);
      else
        gemm_dot_thread_kernel<false><<<unsigned(blocks), F_THREADS, 0, s>>>(x, w, bias, y, M, rows, K);
    }
    return int(cudaGetLastError());
  }
  if (mode != 0) return int(cudaErrorInvalidValue);
  F32Params p;
  p.x = x;
  p.w = w;
  p.bias = bias;
  p.y = y;
  p.ws = split > 1 ? ws : nullptr;
  p.G = G;
  p.M = M;
  p.K = K;
  p.N = N;
  p.k_tiles = (K + F_BK - 1) / F_BK;
  p.kps = kps;
  p.split = split;
  const int tiles_m = (M + F_BM - 1) / F_BM, tiles_n = (N + F_BN - 1) / F_BN;
  if (split < 1 || kps < 1 || (split - 1) * kps >= p.k_tiles || (split > 1 && ws == nullptr) ||
      tiles_m > 65535 || 1LL * tiles_n * split > INT_MAX)
    return int(cudaErrorInvalidValue);
  const dim3 grid(tiles_n * split, tiles_m, G);
  if (K % 4 == 0 && N % 4 == 0)
    gemm_f32_kernel<true, BATCHED><<<grid, F_THREADS, 0, s>>>(p);
  else
    gemm_f32_kernel<false, BATCHED><<<grid, F_THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return int(err);
  return int(reduce<float, BATCHED>(ws, bias, y, G, M, N, split, s));
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns a cudaError_t: 0
// on a successful launch, asynchronous on `stream`.
//
// bf16: y (M, N) = x (M, K) @ w (K, N) (+ bias (N,)) with the tile width
// `bn`, `stages` and `split` of K (`kps` K tiles a split) that
// gemm_config chose; `tma` 0 takes the guarded-load loader.  With split >
// 1, `ws` holds split * M * N float32 partials and a second launch sums
// them.  The tensor maps are encoded on the host in every call.
extern "C" int repro_gemm_bf16(const void* x, const void* w, const void* bias, void* y,
                               float* ws, int M, int K, int N, int bn, int stages, int split,
                               int kps, int tma, void* stream) {
  return bf16_products<false>(x, w, bias, y, ws, 1, M, K, N, bn, stages, split, kps, tma,
                              stream);
}

// float32: y (M, N) = x (M, K) @ w (K, N) (+ bias (N,)), by the instance
// `mode` (0 tiled, 1 dot a warp a row, 2 dot a thread a row) at the split
// gemm_config chose (`ws` as for bf16).
extern "C" int repro_gemm_f32(const float* x, const float* w, const float* bias, float* y,
                              float* ws, int M, int K, int N, int split, int kps, int mode,
                              void* stream) {
  return f32_products<false>(x, w, bias, y, ws, 1, M, K, N, split, kps, mode, stream);
}

// Batched, G = 1..65535 products: y (G, M, N) = x (G, M, K) @ w (G, K, N)
// (+ bias (G, N)), all contiguous, each product as the unbatched entry
// points compute it (the same arguments from gemm_config; `ws` holds
// split * G * M * N partials).
extern "C" int repro_bgemm_bf16(const void* x, const void* w, const void* bias, void* y,
                                float* ws, int G, int M, int K, int N, int bn, int stages,
                                int split, int kps, int tma, void* stream) {
  return bf16_products<true>(x, w, bias, y, ws, G, M, K, N, bn, stages, split, kps, tma,
                             stream);
}

extern "C" int repro_bgemm_f32(const float* x, const float* w, const float* bias, float* y,
                               float* ws, int G, int M, int K, int N, int split, int kps,
                               int mode, void* stream) {
  return f32_products<true>(x, w, bias, y, ws, G, M, K, N, split, kps, mode, stream);
}

// The instances' constants, for the wrapper to check its table against:
// BM, BK (bf16), F_BM, F_BN, F_BK, F_STAGES (float32 tiled), DOT_WARP_ROWS,
// DOT_THREAD_ROWS, DOT_THREAD_MAX_K (float32 dot).
extern "C" void repro_gemm_constants(int* out) {
  out[0] = BM;
  out[1] = BK;
  out[2] = F_BM;
  out[3] = F_BN;
  out[4] = F_BK;
  out[5] = F_STAGES;
  out[6] = DOT_WARP_ROWS;
  out[7] = DOT_THREAD_ROWS;
  out[8] = DOT_THREAD_MAX_K;
}
