// Row-invariant GEMM for Hopper (sm_90a): y = x @ w (+ b) for every
// Linear of the port on the card.
//
// Replaces no TPU kernel: the reference's products are XLA dots outside
// any Pallas kernel (src/repro/models/layers.py, `x @ w.astype(x.dtype)`).
// It exists for the reference's determinism contract (docs/serving.md): a
// seeded request's x0 depends only on the compiled shape, not on the rows
// beside it.  cuBLAS picks its kernel, its tile and any split of K from M
// (rows x seq), so a row's dot products were summed in another order at
// batch bucket 1 than at bucket 8.  Here nothing of the launch but the
// grid's extent in M depends on M: the tile (BM, BN, BK), the stages, the
// split of K and the order of the K loop are set by gemm_config(K, N,
// dtype) (kernels/gemm.py) and passed in; each output element is one
// chain of wgmma k16 steps over its K tiles in order (or, split, one chain
// a split summed by the second kernel in split order), no atomics; rows
// past M and K past its end read as exact zeros (TMA's fill, or the
// guarded loads), which add nothing.  So row i of x[:m] @ w is bitwise
// row i of x @ w for every m.
//
// bf16 instance (x (M, K) and w (K, N) row-major, w in the (d_in, d_out)
// layout Linear stores; float32 accumulation; the product rounded to bf16,
// then the bias add rounded again, as `x @ w + b` rounds in PyTorch):
//   * a block owns a BM x BN = 128 x BN tile of y (BN 128, or 64 for
//     N <= 64) and its split's K tiles of BK = 64;
//   * a producer warp keeps STAGES stages of A (128 x 64) and B (64 x BN)
//     tiles in flight through an mbarrier ring: by TMA (2-D tensor maps,
//     128-byte swizzle; B as 64-column boxes, read MN-major by wgmma, so w
//     is used as stored), or, where a row pitch breaks TMA's 16-byte rule
//     (hymba's dt_proj K = 100, xLSTM's gate N = 4), by guarded loads the
//     warp writes into the same swizzled layout (then a proxy fence and
//     its arrival);
//   * two consumer warpgroups, 64 rows each, run wgmma m64nBNk16 products
//     (A K-major, B MN-major, both from shared memory), one group in
//     flight while the next stage's products issue, and free a stage once
//     the products that read it are done;
//   * the epilogue rounds and adds the bias in registers and stores bf16
//     pairs; a split block stores its float32 partial instead, and
//     gemm_reduce_kernel sums the splits in order, rounds, adds the bias.
// float32 instance (TimeMLP's w1 256 -> d and w2 d -> d at M = 1..64; the
// MoE router's shape): SIMT, no TF32, 16 rows and 32 columns a block, K in
// eight slices (a warp each, one fmaf chain over its slice in order), the
// slices summed in order.
//
// Batched instances (bgemm: y[g] = x[g] @ w[g] (+ b[g]), x (G, M, K), w (G,
// K, N)): the same kernels with the batch g as a further grid axis (y of
// the bf16 grid, z of the float32 one), at the same gemm_config(K, N,
// dtype), which takes neither M nor G; so row i of batch g depends only on
// row i of x[g] and on w[g].  Tiles past M or K read zeros inside their own
// batch: TMA through 3-D maps over (G, M, K) and (G, K, N), whose edges
// are per batch (a 2-D map over (G*K, N) would read batch g+1's K rows
// into batch g's sums), or guarded loads from batch g's base.  A split
// block writes its partial to its own batch's slice of the workspace
// (split, G, M, N), summed in split order as before.  The MoE experts
// (bf16, G = E), the mLSTM products and the sLSTM's recurrent product
// (float32, G = the batch times the heads, or the heads) run here: each was
// a cuBLAS bmm whose kernel chose by the batch.  The float32 instance keeps
// its 16 x 32 tile, so it is slow at these shapes (the mLSTM's N = 1 dot,
// its 256- and 512-wide products: 5.5-24x torch.bmm on the H100).
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
// (operations); xlstm's mLSTM scores in float32 (G 32, M 256, 512 -> 256)
// 0.0321 ms (operations).  The design spends its time
// where a simple kernel does: one tile a block (no persistence), the
// epilogue not overlapped with the next tile's loads.

#include <algorithm>

#include "flash_sm90.cuh"

using namespace flash;
using namespace flash::sm90;

namespace {

constexpr int BM = 128;             // rows of a block's tile: two warpgroups of 64
constexpr int BK = 64;              // K of a stage: one 128-byte swizzled row of bf16
constexpr int NC = 256;             // consumer threads
constexpr int NTHREADS = NC + 32;   // and the producer warp
constexpr int GROUP_M = 8;          // row tiles a group of the grid walks together
constexpr size_t SMEM_MAX = 232448;

struct Params {
  CUtensorMap ta, tb;  // x (M, K), box (64, BM); w (K, N), box (64, BK); each
                       // 3-D over the batch in a batched launch
  const bf16* x;
  const bf16* w;
  const bf16* bias;    // (N,) or null
  bf16* y;             // (M, N)
  float* ws;           // (split, G, M, N) partials of a split launch, else null
  int G, M, K, N;      // G matrices of (M, K) @ (K, N); G = 1 unbatched
  int k_tiles;         // ceil(K / BK)
  int kps;             // K tiles of a split
};

template <int BN, int STAGES>
struct Smem {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr size_t bar_off = size_t(STAGES) * STAGE;
  static constexpr size_t BYTES = 1024 + bar_off + 2 * STAGES * 8;
  static_assert(BN == 64 || BN == 128, "one or two 64-column boxes of B");
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
  // tiles in groups of GROUP_M row tiles, column by column inside a group:
  // the blocks in flight share their A rows and B columns in L2
  const int tiles_m = (p.M + BM - 1) / BM, tiles_n = (p.N + BN - 1) / BN;
  const int in_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / in_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int n0 = ((blockIdx.x % in_group) / group_m) * BN;
  const int m0 = (first_m + (blockIdx.x % in_group) % group_m) * BM;
  const int kt0 = blockIdx.z * p.kps;
  const int nk = min(p.k_tiles, kt0 + p.kps) - kt0;  // >= 1: gemm_config's rule
  // this block's batch, and its matrices
  const int gb = BATCHED ? int(blockIdx.y) : 0;
  const size_t mn = size_t(p.M) * p.N;
  const bf16* x = p.x + size_t(gb) * p.M * p.K;
  const bf16* w = p.w + size_t(gb) * p.K * p.N;
  const bf16* bias = p.bias == nullptr ? nullptr : p.bias + size_t(gb) * p.N;
  bf16* y = p.y + size_t(gb) * mn;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], TMA ? 1 : 32);  // the expect_tx arrival, or the warp's lanes
      mbar_init(&empty[s], NC);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NC / 32) {
    // producer: stage n % STAGES takes the split's K tile n once the
    // consumers have freed it
    for (int n = 0; n < nk; ++n) {
      const int s = n % STAGES;
      if (n >= STAGES) mbar_wait(&empty[s], ((n / STAGES) - 1) & 1);
      const int k0 = (kt0 + n) * BK;
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], L::STAGE);
          if constexpr (BATCHED) {
            tma_load_3d(a_tile(s), &p.ta, &full[s], k0, m0, gb);
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_3d(b_tile(s) + c * (BK * 128), &p.tb, &full[s], n0 + 64 * c, k0, gb);
          } else {
            tma_load_2d(a_tile(s), &p.ta, &full[s], k0, m0);
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(b_tile(s) + c * (BK * 128), &p.tb, &full[s], n0 + 64 * c, k0);
          }
        }
      } else {
        unsigned char* at = a_tile(s);
        for (int i = lane; i < BM * BK; i += 32) {
          const int r = i / BK, c = i % BK;
          const int row = m0 + r, k = k0 + c;
          const bf16 v = row < p.M && k < p.K ? x[size_t(row) * p.K + k] : round_bf16(0.f);
          *reinterpret_cast<bf16*>(at + swizzled(r, c)) = v;
        }
        unsigned char* bt = b_tile(s);
        for (int i = lane; i < BK * BN; i += 32) {
          const int r = i / BN, c = i % BN;
          const int k = k0 + r, col = n0 + c;
          const bf16 v = k < p.K && col < p.N ? w[size_t(k) * p.N + col] : round_bf16(0.f);
          *reinterpret_cast<bf16*>(bt + (c / 64) * (BK * 128) + swizzled(r, c % 64)) = v;
        }
        fence_proxy_async();  // the generic stores, before wgmma reads them
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup g computes rows 64 g .. 64 g + 63 of the tile
  const int g = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int n = 0; n < nk; ++n) {
    const int s = n % STAGES;
    mbar_wait(&full[s], (n / STAGES) & 1);
    const uint32_t ab = smem_addr(a_tile(s)) + g * (64 * 128);
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

  // this thread's elements: n8 block j, rows g8 and g8 + 8 of its warp's
  // 16, columns 2 t4 and 2 t4 + 1
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wrow = m0 + 64 * g + 16 * (warp % 4) + g8;
  const bool pairs = (p.N & 1) == 0;  // bf16x2 / float2 stores stay aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + 8 * r;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t4;
      if (col >= p.N) continue;
      const float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
      if (p.ws != nullptr) {
        float* out = p.ws + (size_t(blockIdx.z) * p.G + gb) * mn + size_t(row) * p.N + col;
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

// y = the split partials summed in split order (ws[0] + ws[1] + ...),
// rounded to bf16, then the bias (batch g's row, batched) added and
// rounded again
template <bool BATCHED>
__global__ void gemm_reduce_kernel(const float* ws, const bf16* bias, bf16* y, int G, int M,
                                   int N, int split) {
  const size_t mn = size_t(M) * N, total = mn * G;
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    float acc = ws[i];
    for (int z = 1; z < split; ++z) acc += ws[size_t(z) * total + i];
    const bf16* b = bias;
    if constexpr (BATCHED) {
      if (b != nullptr) b += (i / mn) * N;
    }
    y[i] = epilogue(acc, b, int(i % N));
  }
}

// float32: a block owns F_BM rows and F_BN columns; its F_KS warps each
// take one slice of K (ceil(K / F_KS) values), one fmaf chain over the
// slice in order an output, eight w loads in flight; then each output's
// slices are summed in slice order and the bias added.  All of it is fixed
// by K, so a row's result does not depend on M (nor, batched, on G: the
// block's batch is blockIdx.z).
constexpr int F_BM = 16, F_BN = 32, F_KS = 8;

template <bool BATCHED>
__global__ void __launch_bounds__(F_BN* F_KS) gemm_f32_kernel(const float* __restrict__ x,
                                                              const float* __restrict__ w,
                                                              const float* __restrict__ bias,
                                                              float* __restrict__ y, int M,
                                                              int K, int N) {
  __shared__ float part[F_KS][F_BM][F_BN + 1];
  if constexpr (BATCHED) {
    const size_t gb = blockIdx.z;
    x += gb * M * K;
    w += gb * K * N;
    y += gb * M * N;
    if (bias != nullptr) bias += gb * N;
  }
  const int c = threadIdx.x % F_BN, ks = threadIdx.x / F_BN;
  const int col = blockIdx.x * F_BN + c;
  const int m0 = blockIdx.y * F_BM;
  const int kc = (K + F_KS - 1) / F_KS;
  const int k0 = min(K, ks * kc), k1 = min(K, k0 + kc);
  const float* xr[F_BM];  // rows past M read row M - 1, and are not stored
#pragma unroll
  for (int r = 0; r < F_BM; ++r) xr[r] = x + size_t(min(m0 + r, M - 1)) * K;
  const float* wc = w + min(col, N - 1);
  float acc[F_BM];
#pragma unroll
  for (int r = 0; r < F_BM; ++r) acc[r] = 0.f;
  int k = k0;
  for (; k + 8 <= k1; k += 8) {
    float wv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) wv[u] = wc[size_t(k + u) * N];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int r = 0; r < F_BM; ++r) acc[r] = fmaf(xr[r][k + u], wv[u], acc[r]);
  }
  for (; k < k1; ++k) {
    const float wv = wc[size_t(k) * N];
#pragma unroll
    for (int r = 0; r < F_BM; ++r) acc[r] = fmaf(xr[r][k], wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < F_BM; ++r) part[ks][r][c] = acc[r];
  __syncthreads();
  // thread (ks, c) finishes rows ks, ks + F_KS, ...
  for (int r = ks; r < F_BM; r += F_KS) {
    if (m0 + r >= M || col >= N) continue;
    float sum = part[0][r][c];
#pragma unroll
    for (int q = 1; q < F_KS; ++q) sum += part[q][r][c];
    y[size_t(m0 + r) * N + col] = bias != nullptr ? sum + bias[col] : sum;
  }
}

constexpr int MAX_DEVICES = 64;

// the (BN, STAGES) pairs with an instance, each with a TMA and a guarded-load
// loader, unbatched and batched
#define GEMM_INSTANCES(X) X(64, 4) X(128, 4)

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
cudaError_t launch(Params& p, int split, cudaStream_t stream) {
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
  // one block a (row tile, column tile) of a batch; the row tiles' count
  // and the batch are checked by the wrapper (the grid's x and y extents)
  const dim3 grid(((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN), p.G, split);
  gemm_bf16_kernel<BN, STAGES, TMA, BATCHED>
      <<<grid, NTHREADS, Smem<BN, STAGES>::BYTES, stream>>>(p);
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
  if (G < 1 || G > 65535 || split < 1 || kps < 1 || (split - 1) * kps >= p.k_tiles ||
      (split > 1 && ws == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define GEMM_LAUNCH(B, S)                                                  \
  if (bn == B && stages == S)                                              \
    err = tma ? launch<B, S, true, BATCHED>(p, split, s)                   \
              : launch<B, S, false, BATCHED>(p, split, s);
  GEMM_INSTANCES(GEMM_LAUNCH)
#undef GEMM_LAUNCH
  if (err != cudaSuccess || split == 1) return int(err);
  const size_t total = size_t(G) * M * N;
  const int blocks = int(std::min<size_t>((total + 255) / 256, 132 * 16));
  gemm_reduce_kernel<BATCHED><<<blocks, 256, 0, s>>>(ws, p.bias, p.y, G, M, N, split);
  return int(cudaGetLastError());
}

// the float32 launch of G (M, K) @ (K, N) products
template <bool BATCHED>
int f32_products(const float* x, const float* w, const float* bias, float* y, int G, int M,
                 int K, int N, void* stream) {
  if (G < 1 || G > 65535) return int(cudaErrorInvalidValue);
  const dim3 grid((N + F_BN - 1) / F_BN, (M + F_BM - 1) / F_BM, G);
  gemm_f32_kernel<BATCHED><<<grid, F_BN * F_KS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, y, M, K, N);
  return int(cudaGetLastError());
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

// float32: y (M, N) = x (M, K) @ w (K, N) (+ bias (N,)).
extern "C" int repro_gemm_f32(const float* x, const float* w, const float* bias, float* y, int M,
                              int K, int N, void* stream) {
  return f32_products<false>(x, w, bias, y, 1, M, K, N, stream);
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
                               int G, int M, int K, int N, void* stream) {
  return f32_products<true>(x, w, bias, y, G, M, K, N, stream);
}

// The bf16 instance's tile constants and the float32 instance's, for the
// wrapper to check its table against: BM, BK, then F_BM, F_BN, F_KS.
extern "C" void repro_gemm_constants(int* out) {
  out[0] = BM;
  out[1] = BK;
  out[2] = F_BM;
  out[3] = F_BN;
  out[4] = F_KS;
}
