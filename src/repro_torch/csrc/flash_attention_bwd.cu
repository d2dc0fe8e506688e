// Flash attention backward for Hopper (sm_90a): bf16 inputs, f32 math.
//
// The gradient of flash_attention.cu's function with respect to q, k and v.
// The TPU reference has no backward kernel: it differentiates its naive or
// chunked SDPA with XLA autodiff (src/repro/models/attention.py).  The port
// sends every attention of the card to the forward kernel, so training
// needs this one (FlashAttention-2's backward, arXiv:2307.08691 alg. 2).
//
// With z = scale * q.k (or softcap * tanh(scale * q.k / softcap)), P =
// softmax over the valid keys, O = P V and dO the output's gradient:
//   D_q  = sum_d dO[q,d] O[q,d]                     (preprocess)
//   dV_k = sum_q P[q,k] dO[q]
//   dP   = dO V^T,  dS = P * (dP - D_q)
//   dz/draw = scale (or scale * (1 - tanh^2) with a softcap)
//   dQ_q = sum_k dS[q,k] dz K[k],  dK_k = sum_q dS[q,k] dz Q[q]
// P is recomputed from Q, K and the forward's per-row lse (base 2: p =
// exp2(x * mul - lse), +inf for a row with no valid key), never stored.
//
// Three launches, no atomics, so two runs are bitwise equal:
//  1. bwd_delta_kernel: D (B, H, Sq) float32, one warp a row of O.
//  2. bwd_dkdv_kernel: one block per (batch, kv head, 32-key tile).  Its K
//     and V tiles stay in shared memory; it walks the G query heads of the
//     group and their live 32-query tiles, so GQA's sum over the group is
//     a sum in registers.  The block's 4 warps are 2 key warps (16 keys
//     each) times 2 query splits (alternate (head, tile) items); the two
//     splits' partial dK / dV are added through shared memory at the end,
//     in a fixed order.  Each warp computes S^T = K Q^T and dP^T = V dO^T
//     (16 keys x 32 queries) with mma.sync m16n8k16, so P^T and dS^T come
//     out in the accumulator layout that is the A operand of dV += P^T dO
//     and dK += dS^T Q: no transpose through shared memory.
//  3. bwd_dq_kernel: one block per (batch * head, 64-query tile), 4 warps of
//     16 rows, walking 32-key tiles through a 2-stage cp.async ring like
//     the forward: S = Q K^T, dP = dO V^T, dS, dQ += dS K.
// Both main kernels skip tiles from positions (kv_pos, q_pos, kv_mask), as
// the forward does (its item 5): a tile no (query, key) pair can use is
// never loaded.  Masks are the forward's: kv_pos < 0, kv_mask, causal,
// window with protected sinks; keys past Sk and rows past Sq are zero.
//
// Bound.  At qwen2-1.5b's diffusion shape (B=8, S=256, H=12, KV=2, hd=128,
// non-causal) the gradient needs five S x S x hd products (Q K^T, dO V^T,
// P^T dO, dS^T Q, dS K): 2.5 * 4 * B*H*S*S*hd = 8.05e9 FLOP, 0.0081 ms at
// the bf16 tensor peak, against 29.5 MB of inputs and outputs (q, k, v, o,
// dO, lse, dq, dk, dv), 0.0088 ms at 3.35 TB/s: bytes bound it.  This
// design recomputes P in both kernels (seven products, 1.13e10 FLOP): a
// cost of the design, not of the bound.
//
// Instances: head dims (32, 32), (64, 64) and (128, 128).  A simple kernel
// first: mma.sync with operands from shared memory by ldmatrix, no wgmma
// or TMA yet.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int KW = 2;            // dK/dV kernel: warps along the keys
constexpr int QW = 2;            // dK/dV kernel: query splits
constexpr int BKV = KW * 16;     // keys of a dK/dV block
constexpr int BQT = 32;          // queries of a dK/dV item (one warp wide)
constexpr int NT_KV = KW * QW * 32;
constexpr int BQ = 64;           // dQ kernel: query rows of a block
constexpr int BK = 32;           // dQ kernel: keys of a kv tile
constexpr int NWARPS = BQ / 16;
constexpr int NT_Q = NWARPS * 32;
static_assert(BQT == 32, "one lane a query row of an item");
static_assert(2 * BK <= NT_Q, "one thread a kv_pos and a kv_mask entry");
static_assert(BKV <= NT_KV, "one thread a key position");

struct Params {
  const bf16* q;       // (B, Sq, H, hd)
  const bf16* k;       // (B, Sk, KV, hd)
  const bf16* v;       // (B, Sk, KV, hd)
  const bf16* o;       // (B, Sq, H, hd), the forward's output
  const bf16* dout;    // (B, Sq, H, hd)
  const float* lse;    // (B, H, Sq), the forward's, base 2
  float* delta;        // (B, H, Sq), written by bwd_delta_kernel
  bf16* dq;            // (B, Sq, H, hd)
  bf16* dk;            // (B, Sk, KV, hd)
  bf16* dv;            // (B, Sk, KV, hd)
  const int* q_pos;    // (Sq,)
  const int* kv_pos;   // (Sk,), < 0 = invalid slot
  const int* kv_mask;  // (B, Sk), 0 = masked key; may be null
  int B, H, KV, Sq, Sk;
  float scale, softcap;
  int window, causal, protected_;
};

__device__ __forceinline__ void split_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(128) bwd_delta_kernel(const Params p) {
  const long row = long(blockIdx.x) * 4 + threadIdx.x / 32;  // (b, q, h) order
  if (row >= long(p.B) * p.Sq * p.H) return;
  const int lane = threadIdx.x % 32;
  const bf16* o = p.o + row * HD;
  const bf16* d = p.dout + row * HD;
  float acc = 0.f;
  for (int c = lane * 2; c < HD; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
    acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = int(row % p.H);
    const long bq = row / p.H;
    const int qi = int(bq % p.Sq);
    const int b = int(bq / p.Sq);
    p.delta[(long(b) * p.H + h) * p.Sq + qi] = acc;
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV
// ---------------------------------------------------------------------------

// Shared memory of a dK/dV block: the K and V tiles (bf16, pitch LD), each
// split's Q and dO item (reused for the splits' reduction after the loop),
// each split's per-row lse, D and q_pos, the block's key positions (-1 =
// invalid), then a bitmask over the query tiles, sized at launch.
template <int HD>
struct KVSmem {
  static constexpr int LD = HD + 8;
  static constexpr size_t kv_tile = size_t(BKV) * LD * 2;
  static constexpr size_t item = size_t(BQT) * LD * 2;      // Q or dO
  static constexpr size_t q_off = 2 * kv_tile;
  static constexpr size_t items = size_t(QW) * 2 * item;
  // the KW warps of one split: dK and dV, HD floats a thread
  static constexpr size_t red = size_t(KW) * 32 * HD * 4;
  static constexpr size_t rows_off = q_off + (items > red ? items : red);
  static constexpr size_t kp_off = rows_off + size_t(QW) * BQT * 12;
  static constexpr size_t bits_off = kp_off + BKV * 4;
  static size_t bytes(int nq) { return bits_off + size_t((nq + 31) / 32) * 4; }
};

template <int HD>
__global__ void __launch_bounds__(NT_KV, 2) bwd_dkdv_kernel(const Params p) {
  using L = KVSmem<HD>;
  constexpr int LD = L::LD;
  constexpr int VPR = HD / 8;
  constexpr int SPLIT_T = KW * 32;  // threads of a split
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::kv_tile);
  int* Kp = reinterpret_cast<int*>(smem + L::kp_off);
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + L::bits_off);

  const int k0 = blockIdx.x * BKV;
  const int b = blockIdx.y / p.KV;
  const int kvh = blockIdx.y % p.KV;
  const int G = p.H / p.KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int split = warp / KW;
  const int kw = warp % KW;
  const int stid = tid % SPLIT_T;
  const int nq = (p.Sq + BQT - 1) / BQT;
  const int nwords = (nq + 31) / 32;
  const long kv_off = (long(b) * p.Sk * p.KV + kvh) * HD;
  const int kv_stride = p.KV * HD;
  const bool masked = p.kv_mask != nullptr;

  for (int idx = tid; idx < BKV * VPR; idx += NT_KV) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    const bool in = k0 + r < p.Sk;
    const long off = in ? kv_off + long(k0 + r) * kv_stride + c : 0;
    cp_async16(Ks + r * LD + c, p.k + off, in);
    cp_async16(Vs + r * LD + c, p.v + off, in);
  }
  cp_async_commit();
  if (tid < BKV) {
    const int j = k0 + tid;
    int kp = -1;
    if (j < p.Sk) {
      kp = p.kv_pos[j];
      if (masked && p.kv_mask[long(b) * p.Sk + j] == 0) kp = -1;
    }
    Kp[tid] = kp;
  }
  for (int w = tid; w < nwords; w += NT_KV) live[w] = 0u;
  __syncthreads();

  // the block's valid key positions, then one warp a query tile: live if
  // some (query, key) pair of the two can be valid (a superset: masked
  // pairs inside a live tile are masked one by one)
  int kmin = INT32_MAX, kmax = -1;
  for (int j = 0; j < BKV; ++j) {
    const int kp = Kp[j];
    if (kp >= 0) {
      kmin = min(kmin, kp);
      kmax = max(kmax, kp);
    }
  }
  if (kmax >= 0) {
    for (int t = warp; t < nq; t += NT_KV / 32) {
      const int qi = t * BQT + lane;
      const bool in = qi < p.Sq;
      const int qp = in ? p.q_pos[qi] : 0;
      int lo = in ? qp : INT32_MAX, hi = in ? qp : INT32_MIN;
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      bool lv = hi != INT32_MIN;
      if (lv && p.causal) lv = kmin <= hi;
      if (lv && p.window > 0) lv = kmax > lo - p.window || kmin < p.protected_;
      if (lane == 0 && lv) atomicOr(&live[t >> 5], 1u << (t & 31));
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off + split * 2 * L::item);
  bf16* dOs = Qs + BQT * LD;
  float* Ls = reinterpret_cast<float*>(smem + L::rows_off) + split * BQT * 3;
  float* Ds = Ls + BQT;
  int* Qp = reinterpret_cast<int*>(Ds + BQT);

  const int g8 = lane >> 2, t4 = lane & 3;
  const int row0 = kw * 16;  // this warp's keys in the block
  const bool capped = p.softcap > 0.f;
  const float mul = capped ? LOG2E : p.scale * LOG2E;
  const float cap_in = capped ? p.scale / p.softcap : 0.f;
  const int kp_lo = Kp[row0 + g8], kp_hi = Kp[row0 + g8 + 8];
  const bf16* k_row = Ks + (row0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* v_row = Vs + (row0 + (lane & 15)) * LD + (lane >> 4) * 8;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // items: (head g of the group, live query tile t), t fastest; split s
  // takes items s, s + QW, ...
  int g = 0;
  int t = next_tile(live, 0, nq);
  if (t >= nq) g = G;
  auto advance = [&]() {
    t = next_tile(live, t + 1, nq);
    if (t >= nq) {
      ++g;
      t = next_tile(live, 0, nq);
    }
  };
  for (int i = 0; i < split && g < G; ++i) advance();

  while (g < G) {
    const int h = kvh * G + g;
    const int q0 = t * BQT;
#pragma unroll 1
    for (int idx = stid; idx < BQT * VPR; idx += SPLIT_T) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      const bool in = q0 + r < p.Sq;
      const long off = in ? ((long(b) * p.Sq + q0 + r) * p.H + h) * HD + c : 0;
      cp_async16(Qs + r * LD + c, p.q + off, in);
      cp_async16(dOs + r * LD + c, p.dout + off, in);
    }
    cp_async_commit();
    if (stid < BQT) {
      const int qi = q0 + stid;
      const bool in = qi < p.Sq;
      const long row = (long(b) * p.H + h) * p.Sq + qi;
      Ls[stid] = in ? p.lse[row] : pos_inf();
      Ds[stid] = in ? p.delta[row] : 0.f;
      Qp[stid] = in ? p.q_pos[qi] : Q_PAD_POS;
    }
    cp_async_wait<0>();
    split_barrier(1 + split, SPLIT_T);

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x BQT queries a warp; element
    // e of st[j]: key row g8 + 8*(e/2), query 8j + 2*t4 + e%2
    float st[BQT / 8][4], dp[BQT / 8][4];
#pragma unroll
    for (int j = 0; j < BQT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, k_row + kk * 16);
      ldsm_x4(va, v_row + kk * 16);
#pragma unroll
      for (int jp = 0; jp < BQT / 16; ++jp) {
        const int off = (jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t qb[4], ob[4];
        ldsm_x4(qb, Qs + off);
        mma_bf16(st[2 * jp], ka, qb[0], qb[1]);
        mma_bf16(st[2 * jp + 1], ka, qb[2], qb[3]);
        ldsm_x4(ob, dOs + off);
        mma_bf16(dp[2 * jp], va, ob[0], ob[1]);
        mma_bf16(dp[2 * jp + 1], va, ob[2], ob[3]);
      }
    }
    // P^T into st, dS^T (times dz/draw / scale) into dp
#pragma unroll
    for (int j = 0; j < BQT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        float x = st[j][e];
        if (capped) x = p.softcap * tanhf(x * cap_in);
        const bool ok = key_valid((e >> 1) ? kp_hi : kp_lo, Qp[col], p);
        const float pr = ok ? exp2f(fmaf(x, mul, -Ls[col])) : 0.f;
        float ds = pr * (dp[j][e] - Ds[col]);
        if (capped) {
          const float tn = x / p.softcap;
          ds *= 1.f - tn * tn;
        }
        st[j][e] = pr;
        dp[j][e] = ds;
      }
    // dV += P^T dO, dK += dS^T Q (the reduction runs over the queries)
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(st[2 * kk][0], st[2 * kk][1]), pack_bf16(st[2 * kk][2], st[2 * kk][3]),
          pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {
          pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        const int off = (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8;
        uint32_t ob[4], qb[4];
        ldsm_x4_trans(ob, dOs + off);
        mma_bf16(dv[2 * np], pa, ob[0], ob[1]);
        mma_bf16(dv[2 * np + 1], pa, ob[2], ob[3]);
        ldsm_x4_trans(qb, Qs + off);
        mma_bf16(dk[2 * np], sa, qb[0], qb[1]);
        mma_bf16(dk[2 * np + 1], sa, qb[2], qb[3]);
      }
    }
    split_barrier(1 + split, SPLIT_T);  // the next item overwrites Q / dO
    for (int i = 0; i < QW && g < G; ++i) advance();
  }

  // the splits' partial sums, added in split order through shared memory
  // (the item buffers, free now), one float a register, lane-interleaved
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L::q_off) + kw * HD * 32 + lane;
  for (int s = 1; s < QW; ++s) {
    if (split == s) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(n * 4 + e) * 32] = dk[n][e];
          red[(HD / 2 + n * 4 + e) * 32] = dv[n][e];
        }
    }
    __syncthreads();
    if (split == 0) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[n][e] += red[(n * 4 + e) * 32];
          dv[n][e] += red[(HD / 2 + n * 4 + e) * 32];
        }
    }
    __syncthreads();
  }
  if (split != 0) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + row0 + g8 + 8 * r;
    if (key >= p.Sk) continue;
    const long off = kv_off + long(key) * kv_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + 8 * n) =
          __floats2bfloat162_rn(dk[n][2 * r] * p.scale, dk[n][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + 8 * n) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------------

// Shared memory of a dQ block: the K0 V0 K1 V1 ring, the block's Q and dO
// (read by ldmatrix each kv tile), the two tiles' kv_pos and kv_mask
// entries, the block's q positions and their min / max, then the live and
// full bitmasks over the kv tiles, sized at launch.
template <int HD>
struct QSmem {
  static constexpr int LD = HD + 8;
  static constexpr size_t ktile = size_t(BK) * LD * 2;
  static constexpr size_t stage = 2 * ktile;
  static constexpr size_t q_off = 2 * stage;
  static constexpr size_t do_off = q_off + size_t(BQ) * LD * 2;
  static constexpr size_t kp_off = do_off + size_t(BQ) * LD * 2;
  static constexpr size_t km_off = kp_off + 2 * BK * 4;
  static constexpr size_t qp_off = km_off + 2 * BK * 4;
  static constexpr size_t red_off = qp_off + BQ * 4;
  static constexpr size_t bits_off = red_off + 2 * NWARPS * 4;
  static size_t bytes(int nk) { return bits_off + 2 * size_t((nk + 31) / 32) * 4; }
};

template <int HD>
__global__ void __launch_bounds__(NT_Q, 2) bwd_dq_kernel(const Params p) {
  using L = QSmem<HD>;
  constexpr int LD = L::LD;
  constexpr int VPR = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  auto k_tile = [&](int s) { return reinterpret_cast<bf16*>(smem + s * L::stage); };
  auto v_tile = [&](int s) { return reinterpret_cast<bf16*>(smem + s * L::stage + L::ktile); };
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::do_off);
  int* Kp = reinterpret_cast<int*>(smem + L::kp_off);
  int* Km = reinterpret_cast<int*>(smem + L::km_off);
  int* Qp = reinterpret_cast<int*>(smem + L::qp_off);
  int* red = reinterpret_cast<int*>(smem + L::red_off);
  const int nk = (p.Sk + BK - 1) / BK;
  const int nwords = (nk + 31) / 32;
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + L::bits_off);  // then full

  // late query tiles first: under a causal mask they have the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_stride = p.H * HD;
  const int kv_stride = p.KV * HD;
  const long q_off = (long(b) * p.Sq * p.H + h) * HD;
  const long kv_off = (long(b) * p.Sk * p.KV + kvh) * HD;
  const long mask_off = long(b) * p.Sk;
  const bool masked = p.kv_mask != nullptr;

  for (int idx = tid; idx < BQ * VPR; idx += NT_Q) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    const bool in = q0 + r < p.Sq;
    const long off = in ? q_off + long(q0 + r) * q_stride + c : 0;
    cp_async16(Qs + r * LD + c, p.q + off, in);
    cp_async16(dOs + r * LD + c, p.dout + off, in);
  }
  cp_async_commit();

  // the block's q-position range, then the live / full bitmasks of the kv
  // tiles, as the forward decides them
  {
    const int qi = q0 + tid;
    const bool in = tid < BQ && qi < p.Sq;
    const int qp = in ? p.q_pos[qi] : Q_PAD_POS;
    if (tid < BQ) Qp[tid] = qp;
    int lo = in ? qp : INT32_MAX, hi = in ? qp : INT32_MIN;
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      red[warp] = lo;
      red[NWARPS + warp] = hi;
    }
    for (int w = tid; w < 2 * nwords; w += NT_Q) live[w] = 0u;
  }
  __syncthreads();
  int min_qp = red[0], max_qp = red[NWARPS];
  for (int w = 1; w < NWARPS; ++w) {
    min_qp = min(min_qp, red[w]);
    max_qp = max(max_qp, red[NWARPS + w]);
  }
  for (int t = warp; t < nk; t += NWARPS) {
    const int j = t * BK + lane;
    int kp = -1;
    if (j < p.Sk) {
      kp = p.kv_pos[j];
      if (masked && p.kv_mask[mask_off + j] == 0) kp = -1;
    }
    bool some = kp >= 0, every = kp >= 0;
    if (p.causal) {
      some = some && kp <= max_qp;
      every = every && kp <= min_qp;
    }
    if (p.window > 0) {
      const bool sink = kp < p.protected_;
      some = some && (kp > min_qp - p.window || sink);
      every = every && (kp > max_qp - p.window || sink);
    }
    const bool any = __any_sync(0xffffffffu, some);
    const bool all = __all_sync(0xffffffffu, every);
    if (lane == 0) {
      if (any) atomicOr(&live[t >> 5], 1u << (t & 31));
      if (all) atomicOr(&live[nwords + (t >> 5)], 1u << (t & 31));
    }
  }
  __syncthreads();

  auto load_tile = [&](int t, int s) {
    const int k0 = t * BK;
#pragma unroll 1
    for (int idx = tid; idx < BK * VPR; idx += NT_Q) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      const bool in = k0 + r < p.Sk;
      const long off = in ? kv_off + long(k0 + r) * kv_stride + c : 0;
      cp_async16(k_tile(s) + r * LD + c, p.k + off, in);
      cp_async16(v_tile(s) + r * LD + c, p.v + off, in);
    }
    const int j = k0 + (tid % BK);
    const bool in = j < p.Sk;
    if (tid < BK) cp_async4(Kp + s * BK + tid, p.kv_pos + (in ? j : 0), in);
    else if (tid < 2 * BK && masked)
      cp_async4(Km + s * BK + tid - BK, p.kv_mask + (in ? mask_off + j : 0), in);
  };

  int cur = next_tile(live, 0, nk);
  if (cur < nk) load_tile(cur, 0);
  cp_async_commit();

  const int row0 = warp * 16;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* q_row = Qs + (row0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* do_row = dOs + (row0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bool capped = p.softcap > 0.f;
  const float mul = capped ? LOG2E : p.scale * LOG2E;
  const float cap_in = capped ? p.scale / p.softcap : 0.f;
  // this thread's rows g and g + 8: lse and D
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    const bool in = qi < p.Sq;
    lse_r[r] = in ? p.lse[long(bh) * p.Sq + qi] : pos_inf();
    d_r[r] = in ? p.delta[long(bh) * p.Sq + qi] : 0.f;
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int stage = 0;
  while (cur < nk) {
    const int nxt = next_tile(live, cur + 1, nk);
    if (nxt < nk) {
      load_tile(nxt, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `cur` (and Q, dO) landed for every thread

    const bf16* Kt = k_tile(stage);
    const bf16* Vt = v_tile(stage);
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, q_row + kk * 16);
      ldsm_x4(oa, do_row + kk * 16);
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        const int off = (jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Kt + off);
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
        ldsm_x4(vb, Vt + off);
        mma_bf16(dp[2 * jp], oa, vb[0], vb[1]);
        mma_bf16(dp[2 * jp + 1], oa, vb[2], vb[3]);
      }
    }
    // element e of s[j]: row g + 8*(e/2), key 8j + 2*t4 + e%2
    const bool is_full = (live[nwords + (cur >> 5)] >> (cur & 31)) & 1u;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      int2 kp = *reinterpret_cast<const int2*>(Kp + stage * BK + col);
      if (masked) {
        const int2 km = *reinterpret_cast<const int2*>(Km + stage * BK + col);
        if (km.x == 0) kp.x = -1;
        if (km.y == 0) kp.y = -1;
      }
      if (cur * BK + col >= p.Sk) kp.x = -1;
      if (cur * BK + col + 1 >= p.Sk) kp.y = -1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        if (capped) x = p.softcap * tanhf(x * cap_in);
        const bool ok =
            is_full || key_valid((e & 1) ? kp.y : kp.x, Qp[row0 + g + 8 * (e >> 1)], p);
        const float pr = ok ? exp2f(fmaf(x, mul, -lse_r[e >> 1])) : 0.f;
        float ds = pr * (dp[j][e] - d_r[e >> 1]);
        if (capped) {
          const float tn = x / p.softcap;
          ds *= 1.f - tn * tn;
        }
        s[j][e] = ds;
      }
    }
    // dQ += dS K (the reduction runs over the keys)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t sa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, Kt + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
        mma_bf16(dq[2 * np], sa, kb[0], kb[1]);
        mma_bf16(dq[2 * np + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
    cur = nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= p.Sq) continue;
    const long off = q_off + long(qi) * q_stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(p.dq + off + 8 * n) =
          __floats2bfloat162_rn(dq[n][2 * r] * p.scale, dq[n][2 * r + 1] * p.scale);
  }
}

constexpr int MAX_DEVICES = 64;

// Raise both main kernels' dynamic shared-memory cap to the card's opt-in
// maximum, once per instance and card.
template <int HD>
cudaError_t allow_smem() {
  static int done[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done[dev] = 1;
  return err;
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<HD>();
  if (err != cudaSuccess) return err;
  const long rows = long(p.B) * p.Sq * p.H;
  bwd_delta_kernel<HD><<<unsigned((rows + 3) / 4), 128, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nq = (p.Sq + BQT - 1) / BQT;
  const dim3 grid_kv((p.Sk + BKV - 1) / BKV, p.B * p.KV);
  bwd_dkdv_kernel<HD><<<grid_kv, NT_KV, KVSmem<HD>::bytes(nq), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nk = (p.Sk + BK - 1) / BK;
  const dim3 grid_q((p.Sq + BQ - 1) / BQ, p.B * p.H);
  bwd_dq_kernel<HD><<<grid_q, NT_Q, QSmem<HD>::bytes(nk), stream>>>(p);
  return cudaGetLastError();
}

#define FLASH_BWD_INSTANCES(X) X(32) X(64) X(128)

}  // namespace

// Plain C entry point (bound with ctypes): the three launches on `stream`,
// asynchronous.  Returns a cudaError_t: 0 when every launch was accepted.
// `delta` is (B, H, Sq) float32 scratch; dq, dk and dv are written whole.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv,
    const int* q_pos, const int* kv_pos, const int* kv_mask,
    int B, int H, int KV, int Sq, int Sk, int hd,
    float scale, float softcap, int window, int causal, int protected_,
    void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_pos = q_pos;
  p.kv_pos = kv_pos;
  p.kv_mask = kv_mask;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  p.causal = causal;
  p.protected_ = protected_;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(D) \
  if (hd == D) return int(launch<D>(p, s));
  FLASH_BWD_INSTANCES(FLASH_BWD_LAUNCH)
#undef FLASH_BWD_LAUNCH
  return int(cudaErrorInvalidValue);
}
