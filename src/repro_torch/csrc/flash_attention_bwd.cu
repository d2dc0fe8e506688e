// Flash attention backward for Hopper (sm_90a): bf16 inputs, f32 math.
//
// The gradient of flash_attention.cu's function with respect to q, k and v.
// That forward replaces the TPU kernel repro.kernels.flash_attention.
// _flash_kernel (src/repro/kernels/flash_attention.py:34); the TPU reference
// has no backward kernel: it differentiates its naive or chunked SDPA with
// XLA autodiff (src/repro/models/attention.py).  The port sends every
// attention of the card to the forward kernel, so training needs this one
// (FlashAttention-2's backward, arXiv:2307.08691 alg. 2, laid out for Hopper
// as FlashAttention-3's, arXiv:2407.08608).
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
// Masks are the forward's: kv_pos < 0, kv_mask, causal, window with
// protected sinks; keys past Sk and rows past Sq are zero.
//
// Bound.  At qwen2-1.5b's diffusion shape (B=8, S=256, H=12, KV=2, hd=128,
// non-causal) the gradient needs five S x S x hd products (Q K^T, dO V^T,
// P^T dO, dS^T Q, dS K): 2.5 * 4 * B*H*S*S*hd = 8.05e9 FLOP, 0.0081 ms at
// the bf16 tensor peak, against 29.5 MB of inputs and outputs (q, k, v, o,
// dO, lse, dq, dk, dv), 0.0088 ms at 3.35 TB/s: bytes bound it.  At its
// causal 8x512 (the AR prefill's shape): 58.9 MB, 0.0176 ms.  This design
// recomputes S and dP in the dQ kernel (seven products, 1.13e10 FLOP at
// 8x256): the price of no atomics, not part of the bound.
//
// Three launches, no atomics, so two runs are bitwise equal:
//  1. bwd_prep_kernel: HDV/8 lanes a query row (16-byte loads of O and dO):
//     D, and each row's {lse, D} into a (B, H, Sq_pad) float2 array padded
//     to whole 64-row tiles (pad rows {+inf, 0}: P = 0); q_pos padded the
//     same way; and each batch row's key positions with kv_mask and Sk
//     folded in (-1 = no key), (B, Sk_pad).  The main kernels copy 64-row
//     slices of these by bulk TMA: aligned, nothing to mask at an edge.
//  2. bwd_dkdv_wgmma_kernel: dK, dV.
//  3. bwd_dq_wgmma_kernel: dQ.
// The previous design (mma.sync) ran at 5.6% of the bound: at 8x256 its
// dK/dV took 0.093 ms and its dQ 0.059 of 0.159 (PERF.md).  What held it back,
// and what this design does (numbers: NVIDIA H100 80GB HBM3, PERF.md):
//
//  a. Too little parallelism in dK/dV (one 4-warp block per 32 keys, one
//     block an SM).  A block now owns 64 keys with two consumer warpgroups,
//     each taking every other item of the block, so two warpgroups share
//     an SM and one's score math runs beside the other's products; their
//     partial dK / dV are added in shared memory, warpgroup 1's then 0's.
//     A thread block cluster of C blocks shares one key tile: block r takes
//     the tile's (head, query-tile) items r, r + C, ...  C is the host's
//     rule (kernels/flash_attention.py, bwd_cluster_size): the largest of
//     1, 2, 4, 8 that keeps the launch to one wave (a block's registers
//     fill its SM): 2 at 8x256 (128 blocks), 2 at causal 8x512, 1 at
//     hymba's 2x1280.  The smallest C that reaches 132 blocks took two
//     waves at 8x256: 0.0458 ms against 0.0243 for dK/dV.  Under a causal
//     mask a row's first key tile sees every query tile and its last one
//     only the last, so there a block takes key tiles j and nk - 1 - j in
//     two passes (`pair`), the ring and its barriers' phases running on:
//     at causal 8x512 the heaviest block went from 48 items to 27, and
//     dK/dV from 0.071 ms to 0.053.
//     At the end the C partial tiles are summed in rank order through
//     distributed shared memory (block r sums rows [r*64/C, (r+1)*64/C) of
//     every rank's partial and writes them), as decode_attention.cu merges
//     its cluster: no workspace in device memory, no atomics, one result
//     whatever order blocks run in.
//  b. No overlap of loads and products.  Tiles come by TMA into 128-byte
//     swizzled shared memory (64-byte at hd 32), one full and one empty
//     mbarrier a stage.  dK/dV: K and V once; a ring of four stages of Q,
//     dO, {lse, D} and q_pos, two a warpgroup, each refilled by its
//     warpgroup's first thread as soon as the warpgroup is done with it,
//     so an item's copies land while the one before it is computed.  (A
//     separate producer warp cost more than it gave: ptxas allots a block's
//     registers by whole warpgroups, so 288 threads ran at 168 registers a
//     thread and spilled, and setmaxnreg did not raise the consumers'
//     compiled budget.)  dQ: a producer warp loads Q and dO once, then
//     keeps the next live kv tiles' K, V and key positions in flight (two
//     stages at hd 128, three below) for one consumer warpgroup, two blocks
//     an SM.  Tensor maps are 4-D over (B, S, heads, hd), so a ragged S
//     zero-fills inside its own batch row; they are encoded on the host in
//     every call (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint: no -lcuda) and passed as __grid_constant__
//     parameters.
//  c. Warp-level products.  Every product is a warpgroup wgmma with f32
//     accumulators.  dK/dV: S^T = K Q^T and dP^T = V dO^T with both
//     operands in shared memory (64 keys x 64 queries; from hd 128 on two
//     steps of 32 queries, which keeps dK, dV, S^T and dP^T inside 255
//     registers a thread); P^T and dS^T are formed in the accumulator registers,
//     whose layout is that of wgmma's register A operand, and dV += P^T dO,
//     dK += dS^T Q take A from registers and B (dO or Q, rows = queries)
//     transposed from the same swizzled tile (an MN-major descriptor).  dQ:
//     S = Q K^T and dP = dO V^T (64 queries x 64 keys), dS in registers,
//     dQ += dS K (K transposed).  The score math was the bottleneck once
//     the products were wgmma (5,600 of 6,900 cycles an item, measured
//     with clock64 in a copy of the kernel): it is branch-free (the mask's
//     flags are uniform and the softcap and full-tile cases are template
//     instances picked outside the element loops) and takes exp2 from the
//     SFU alone (ex2.approx; P is rounded to bf16 for the products anyway).
//  d. Seven products where the gradient needs five: kept.  dQ recomputes S
//     and dP, which is what no atomics costs; at 8x256 that is 1.13e10
//     FLOP, 0.0114 ms at peak.
// Both main kernels skip tiles from positions, as the forward does: dK/dV
// lists the query tiles some (query, key) pair of its keys can use (from
// each tile's q_pos range and its keys' position range) and marks those
// where every pair is valid; dQ marks its kv tiles live and full per key
// as the forward does.  Dead tiles are never loaded; masked pairs inside a
// live tile are masked one by one, and a full tile skips the mask.
//
// Instances: the forward's head-dim pairs (q/k, v), (32, 32), (64, 64),
// (128, 128), DeepSeek's MLA (192, 128) and paligemma's (256, 256), all of
// this design: 64-row tiles; 128-byte swizzle and 64-column TMA boxes from
// hd 64 on (two, three and four boxes a row at 128, 192 and 256), 64-byte
// swizzle at hd 32.  Products that run over the query/key head dim (S^T =
// K Q^T, dK += dS^T Q, S = Q K^T, dQ += dS K) take HD, those over the
// value's (dP^T = V dO^T, dV += P^T dO, dP = dO V^T, D) take HDV.  Two
// register plans change past hd 128 (KVSmem, QSmem): at (256, 256) the two
// dK/dV warpgroups split dK's and dV's columns and both take every item,
// and from hd 192 on a dQ block runs alone on its SM.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;
using namespace flash::sm90;

constexpr int TILE = 64;           // rows of every tile: keys or queries
constexpr int WG = 128;            // threads of a warpgroup
constexpr int KV_WGS = 2;          // consumer warpgroups of a dK/dV block
constexpr int NT_KV = KV_WGS * WG;
constexpr int NT_Q = WG + 32;      // a dQ block: a consumer warpgroup, a producer warp
constexpr int MAX_CLUSTER = 8;     // portable cluster size
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block can have (227 KB)

struct Params {
  CUtensorMap tq, tk, tv, tdo;  // (B, S, heads, hd or hd_v) bf16, box (CB, 1, 64, 1)
  const bf16* o;                // (B, Sq, H, hd_v), the forward's output
  const bf16* dout;             // (B, Sq, H, hd_v)
  const float* lse;             // (B, H, Sq), the forward's, base 2
  float2* rows;                 // (B, H, Sq_pad): {lse, D}
  int* qp;                      // (Sq_pad,): q_pos, Q_PAD_POS past Sq
  int* kp;                      // (B, Sk_pad): key position, -1 = no key
  bf16* dq;                     // (B, Sq, H, hd)
  bf16* dk;                     // (B, Sk, KV, hd)
  bf16* dv;                     // (B, Sk, KV, hd_v)
  const int* q_pos;             // (Sq,)
  const int* kv_pos;            // (Sk,), < 0 = invalid slot
  const int* kv_mask;           // (B, Sk), 0 = masked key; may be null
  int B, H, KV, Sq, Sk, Sq_pad, Sk_pad;
  float scale, softcap;
  int window, causal, protected_;
  int cluster;                  // blocks of a dK/dV cluster (1, 2, 4, 8)
  int pair;                     // a dK/dV block takes key tiles j and nk - 1 - j
};

// The scale and masks of the scores: x = scale * q.k, or softcap *
// tanh(scale * q.k / softcap); p = exp2(x * mul - lse).  Only `mul` is
// held in a register across the loops; the masks' parameters are read
// where they are used, and the softcap's factors only by the capped code.
struct Scores {
  const Params& p;
  float mul;
  __device__ explicit Scores(const Params& p_)
      : p(p_), mul(p_.softcap > 0.f ? LOG2E : p_.scale * LOG2E) {}
  __device__ __forceinline__ bool valid(int kp, int qp) const { return key_valid(kp, qp, p); }
};

// the softcap's factors: x = softcap * tanh(raw * cap_in), tanh = x * inv
struct Cap {
  float softcap, cap_in, inv;
  __device__ explicit Cap(const Params& p)
      : softcap(p.softcap), cap_in(p.scale / p.softcap), inv(1.f / p.softcap) {}
};

// P (in place of the raw score x) and dS (in place of dP) of one element,
// `lse` and `d` its query row's; dS leaves out dz/draw's `scale`
template <bool CAPPED>
__device__ __forceinline__ void grad_score(float& x, float& dp, bool ok, float lse, float d,
                                           const Scores& sc, const Cap& cap) {
  if constexpr (CAPPED) x = cap.softcap * tanhf(x * cap.cap_in);
  const float pr = ok ? ex2_approx(fmaf(x, sc.mul, -lse)) : 0.f;
  float ds = pr * (dp - d);
  if constexpr (CAPPED) {
    const float tn = x * cap.inv;
    ds *= 1.f - tn * tn;
  }
  x = pr;
  dp = ds;
}

// P^T and dS^T of 2N queries of a dK/dV item in place of S^T and dP^T
// (64 keys x 2N queries): this thread's key rows have positions kp_lo and
// kp_hi, and R and Qp hold the queries' {lse, D} and q_pos; MASKED: some
// pair of the item may be invalid
template <bool CAPPED, bool MASKED, int N>
__device__ __forceinline__ void item_scores(float (&st)[N], float (&dp)[N], int kp_lo,
                                            int kp_hi, const float2* R, const int* Qp,
                                            int t4, const Scores& sc) {
  const Cap cap(sc.p);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + 2 * t4 + c;
      const float2 r = R[col];
      const int qp = MASKED ? Qp[col] : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        grad_score<CAPPED>(st[4 * j + 2 * h + c], dp[4 * j + 2 * h + c],
                           !MASKED || sc.valid(h ? kp_hi : kp_lo, qp), r.x, r.y, sc, cap);
    }
}

// P and dS of a dQ kv tile in place of S and dP (64 queries x 64 keys):
// this thread's query rows have {lse, D} rr and positions qp, and Kp holds
// the tile's key positions
template <bool CAPPED, bool MASKED>
__device__ __forceinline__ void tile_scores(float (&score)[32], float (&dp)[32],
                                            const float2 (&rr)[2], const int (&qp)[2],
                                            const int* Kp, int t4, const Scores& sc) {
  const Cap cap(sc.p);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int2 kp =
        MASKED ? *reinterpret_cast<const int2*>(Kp + 8 * j + 2 * t4) : make_int2(0, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const bool ok = !MASKED || sc.valid((e & 1) ? kp.y : kp.x, qp[r]);
      grad_score<CAPPED>(score[4 * j + e], dp[4 * j + e], ok, rr[r].x, rr[r].y, sc, cap);
    }
  }
}

// the four instances of a scores function, picked by two uniform flags
#define BWD_SCORES(fn, capped, masked, ...)                \
  do {                                                     \
    if (capped) {                                          \
      if (masked) fn<true, true>(__VA_ARGS__);             \
      else fn<true, false>(__VA_ARGS__);                   \
    } else {                                               \
      if (masked) fn<false, true>(__VA_ARGS__);            \
      else fn<false, false>(__VA_ARGS__);                  \
    }                                                      \
  } while (0)

// ---------------------------------------------------------------------------
// 1. D, the padded rows and the positions
// ---------------------------------------------------------------------------

template <int HD, int HDV>
__global__ void __launch_bounds__(128) bwd_prep_kernel(const __grid_constant__ Params p) {
  // LPR lanes a row of O and dO (HDV wide), 16 bytes (8 values) each a load
  constexpr int LPR = HDV / 8;
  static_assert(LPR <= 32, "a row's lanes inside one warp");
  constexpr int RPW = 32 / LPR;  // rows a warp
  const int lane = threadIdx.x % 32;
  const long row = (long(blockIdx.x) * 4 + threadIdx.x / 32) * RPW + lane / LPR;  // (b, h, q)
  const bool in = row < long(p.B) * p.H * p.Sq_pad;
  const int qi = in ? int(row % p.Sq_pad) : p.Sq;
  const long bh = row / p.Sq_pad;
  float acc = 0.f;
  if (qi < p.Sq) {
    const int h = int(bh % p.H), b = int(bh / p.H);
    const long off = ((long(b) * p.Sq + qi) * p.H + h) * HDV + (lane % LPR) * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(p.o + off);
    const uint4 y = *reinterpret_cast<const uint4*>(p.dout + off);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
      acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
    }
  }
  // a row's LPR lanes are adjacent: reduce within them (every lane takes part)
  for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (in && lane % LPR == 0)
    p.rows[row] = qi < p.Sq ? make_float2(p.lse[bh * p.Sq + qi], acc)
                            : make_float2(pos_inf(), 0.f);
  const long n = p.Sq_pad + long(p.B) * p.Sk_pad;
  for (long i = long(blockIdx.x) * 128 + threadIdx.x; i < n; i += long(gridDim.x) * 128) {
    if (i < p.Sq_pad) {
      p.qp[i] = i < p.Sq ? p.q_pos[i] : Q_PAD_POS;
    } else {
      const long j = i - p.Sq_pad;
      const int b = int(j / p.Sk_pad), key = int(j % p.Sk_pad);
      int kp = -1;
      if (key < p.Sk) {
        kp = p.kv_pos[key];
        if (p.kv_mask != nullptr && p.kv_mask[long(b) * p.Sk + key] == 0) kp = -1;
      }
      p.kp[j] = kp;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK, dV
// ---------------------------------------------------------------------------

// Shared memory of a dK/dV block (from a 1024-aligned base): K and V, the
// ring's Q and dO tiles, each stage's rows ({lse, D}) and q_pos, the
// block's key positions, the barriers, then the live query tiles' count
// and list and each query tile's q_pos range, sized at launch.  After the
// loop the partial dK (float32, rows of HD + 8) and dV (rows of HDV + 8)
// overlay K, V and the ring.
//
// Which warpgroup holds what.  A thread of a warpgroup holds its share of
// 64 keys' dK and dV, HD / 2 + HDV / 2 floats, beside S^T and dP^T of a
// sub-step of NQ queries (NQ / 2 each) and their bf16 A fragments.  Up to
// (192, 128) (96 + 64 + 32 + 16 at NQ 32) that fits 255 registers, and
// consumer warpgroup w takes the block's items w, w + KV_WGS, ..., so it
// owns stages w, w + KV_WGS, ... of the ring.  At (256, 256) dK and dV
// alone would take 256: there (SPLIT) each warpgroup owns half of dK's and
// half of dV's columns (whole 64-column blocks of the swizzled tiles) and
// both take every item, each computing the item's whole S^T and dP^T (the
// price: those two products and the score math twice an item), so both
// read every stage of a ring of two, refilled by the block's first thread
// once both are done with it.
template <int HD, int HDV>
struct KVSmem {
  using TQ = Tile<HD>;   // Q and K tiles
  using TV = Tile<HDV>;  // dO and V tiles
  static constexpr bool SPLIT = HD / 2 + HDV / 2 > 160;
  static constexpr int DKC = SPLIT ? HD / 2 : HD;    // dK columns a warpgroup holds
  static constexpr int DVC = SPLIT ? HDV / 2 : HDV;  // and dV columns
  static constexpr int STAGES = SPLIT ? 2 : 2 * KV_WGS;
  static constexpr int STEP = SPLIT ? 1 : KV_WGS;    // ring items from one of a warpgroup's to the next
  // queries of a sub-step of an item: from hd 128 on, 64 would put dK, dV,
  // S^T and dP^T with the rest past the 255 a thread has (at hd 128 ptxas
  // spilled 12-16 bytes)
  static constexpr int NQ = HD >= 128 ? 32 : 64;
  static constexpr int LDK = HD + 8;
  static constexpr int LDV = HDV + 8;
  static constexpr size_t STAGE = size_t(TQ::BYTES) + TV::BYTES;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = TQ::BYTES;
  static constexpr size_t ring_off = STAGE;  // stage s: Q, then dO
  static constexpr size_t rows_off = ring_off + size_t(STAGES) * STAGE;
  static constexpr size_t qp_off = rows_off + size_t(STAGES) * TILE * 8;
  static constexpr size_t kp_off = qp_off + size_t(STAGES) * TILE * 4;
  static constexpr size_t bar_off = kp_off + TILE * 4;
  static constexpr size_t list_off = bar_off + (1 + 2 * STAGES) * 8;
  static constexpr size_t red_bytes = size_t(TILE) * (LDK + LDV) * 4;
  static_assert(SPLIT || STAGES % KV_WGS == 0, "each warpgroup keeps to its own stages");
  static_assert(!SPLIT || (DKC % TQ::CB == 0 && DVC % TV::CB == 0),
                "a warpgroup's columns are whole column blocks");
  static_assert(TQ::BYTES % 1024 == 0 && TV::BYTES % 512 == 0, "tiles at swizzle-aligned offsets");
  static_assert(red_bytes <= rows_off, "the partials fit over K, V and the ring");
  static_assert(1024 + list_off + 1024 <= SMEM_MAX, "a block's shared memory");
  static size_t bytes(int nq) { return 1024 + list_off + 4 + size_t(nq) * 12; }
};

// this thread's elements of a 64-row accumulator of N columns (element e of
// n8 block j at [4j + e], row + 8 (e / 2), column 8j + 2 (t4) + e % 2) into a
// float32 tile of pitch LD at `mine`, its element (0, 0): stored times
// `mul`, or with ADD added to what is there first
template <bool ADD, int N>
__device__ __forceinline__ void acc_to_smem(float* mine, const float (&acc)[N / 2], int ld,
                                            float mul) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* d = reinterpret_cast<float2*>(mine + 8 * h * ld + 8 * j);
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if constexpr (ADD) {
        const float2 o = d[0];
        d[0] = make_float2((x + o.x) * mul, (y + o.y) * mul);
      } else {
        d[0] = make_float2(x * mul, y * mul);
      }
    }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(NT_KV, 1) bwd_dkdv_wgmma_kernel(
    const __grid_constant__ Params p) {
  using TQ = Tile<HD>;
  using TV = Tile<HDV>;
  using L = KVSmem<HD, HDV>;
  constexpr int S = L::STAGES;
  constexpr int NQ = L::NQ;
  constexpr int LDK = L::LDK;
  constexpr int LDV = L::LDV;
  constexpr int DKC = L::DKC;
  constexpr int DVC = L::DVC;
  constexpr int STEP = L::STEP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Kt = smem + L::k_off;
  unsigned char* Vt = smem + L::v_off;
  auto q_tile = [&](int s) { return smem + L::ring_off + size_t(s) * L::STAGE; };
  auto do_tile = [&](int s) { return q_tile(s) + TQ::BYTES; };
  float2* rows = reinterpret_cast<float2*>(smem + L::rows_off);
  int* qps = reinterpret_cast<int*>(smem + L::qp_off);
  int* Kp = reinterpret_cast<int*>(smem + L::kp_off);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;
  int* nlive_s = reinterpret_cast<int*>(smem + L::list_off);
  int* tiles = nlive_s + 1;  // live query tiles, as 2 t + (every pair valid)

  const int C = p.cluster;
  const int rank = cluster_rank();
  const int b = blockIdx.y / p.KV;
  const int kvh = blockIdx.y % p.KV;
  const int G = p.H / p.KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = warp / 4;
  // issues the copies: each warpgroup's first thread for its own stages,
  // or (SPLIT) the block's first for every stage
  const bool leader = L::SPLIT ? tid == 0 : tid % WG == 0;
  const int nq = p.Sq_pad / TILE;
  int* qlo = tiles + nq;
  int* qhi = qlo + nq;
  // the block's key tiles: one, or with `pair` tile j and tile nk - 1 - j
  // of its batch row (under a causal mask their items add up to about the
  // same count for every j), one pass each
  const int nk = p.Sk_pad / TILE;
  const int kt0 = blockIdx.x / C;
  const int passes = p.pair && nk - 1 - kt0 != kt0 ? 2 : 1;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::SPLIT ? NT_KV : WG);
    }
    fence_barrier_init();
  }
  // each query tile's q_pos range over its rows inside Sq, a warp a tile
  for (int t = warp; t < nq; t += NT_KV / 32) {
    int lo = INT32_MAX, hi = INT32_MIN;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = t * TILE + 32 * r + lane;
      if (qi < p.Sq) {
        const int qp = p.qp[qi];
        lo = min(lo, qp);
        hi = max(hi, qp);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      qlo[t] = lo;
      qhi[t] = hi;
    }
  }

  // r0: the ring position of the pass's first item (the ring and its
  // barriers' phases carry over from one pass to the next); item r of the
  // ring goes to stage r % S and warpgroup r % KV_WGS
  for (int pass = 0, r0 = 0; pass < passes; ++pass) {
    const int k0 = (pass == 0 ? kt0 : nk - 1 - kt0) * TILE;
    if (tid < TILE) Kp[tid] = p.kp[long(b) * p.Sk_pad + k0 + tid];
    __syncthreads();
    // the live query tiles, in order: some (query, key) pair of the tile
    // and this block's keys can be valid (a superset: masked pairs inside
    // a live tile are masked one by one); and whether every pair is
    if (warp == 0) {
      int kmin = INT32_MAX, kmax = -1;
      bool every = true;
      for (int j = lane; j < TILE; j += 32) {
        const int kp = Kp[j];
        every = every && kp >= 0;
        if (kp >= 0) {
          kmin = min(kmin, kp);
          kmax = max(kmax, kp);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
      }
      every = __all_sync(0xffffffffu, every);
      int n = 0;
      for (int base = 0; base < nq; base += 32) {
        const int t = base + lane;
        bool lv = t < nq && kmax >= 0, all = false;
        if (lv) {
          const int lo = qlo[t], hi = qhi[t];
          lv = hi != INT32_MIN;
          if (lv && p.causal) lv = kmin <= hi;
          if (lv && p.window > 0) lv = kmax > lo - p.window || kmin < p.protected_;
          all = lv && every && (!p.causal || kmax <= lo) &&
                (p.window <= 0 || kmin > hi - p.window || kmax < p.protected_);
        }
        const uint32_t m = __ballot_sync(0xffffffffu, lv);
        if (lv) tiles[n + __popc(m & ((1u << lane) - 1u))] = 2 * t + (all ? 1 : 0);
        n += __popc(m);
      }
      if (lane == 0) *nlive_s = n;
    }
    __syncthreads();
    const int nlive = *nlive_s;
    // the key tile's items (i: head i / nlive, query tile tiles[i % nlive]);
    // this block takes items rank, rank + C, ...: its n-th is rank + n C
    const int n_items = G * nlive;
    const int mine = n_items > rank ? (n_items - rank + C - 1) / C : 0;
    const int r_end = r0 + mine;

    // ring item r (this pass's item r - r0) into stage r % S, by one thread
    auto issue = [&](int r) {
      const int i = rank + (r - r0) * C;
      const int s = r % S;
      const int h = kvh * G + i / nlive;
      const int q0 = (tiles[i % nlive] >> 1) * TILE;
      mbar_expect_tx(&full[s], L::STAGE + TILE * 12);
      load_tile<HD>(q_tile(s), &p.tq, &full[s], h, q0, b);
      load_tile<HDV>(do_tile(s), &p.tdo, &full[s], h, q0, b);
      bulk_load(rows + s * TILE, p.rows + (long(b) * p.H + h) * p.Sq_pad + q0, TILE * 8,
                &full[s]);
      bulk_load(qps + s * TILE, p.qp + q0, TILE * 4, &full[s]);
    };
    // this warpgroup's first ring item of the pass
    const int r_first =
        L::SPLIT ? r0 : r0 + ((wg - r0) % KV_WGS + KV_WGS) % KV_WGS;
    if (tid == 0) {
      mbar_expect_tx(kv_full, L::STAGE);
      load_tile<HD>(Kt, &p.tk, kv_full, kvh, k0, b);
      load_tile<HDV>(Vt, &p.tv, kv_full, kvh, k0, b);
    }
    if (leader)
      for (int r = r_first; r < r_end && r < r0 + S; r += STEP) issue(r);

    const int w = warp % 4;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int kp_lo = Kp[16 * w + g8], kp_hi = Kp[16 * w + g8 + 8];
    const Scores sc(p);
    const bool capped = p.softcap > 0.f;
    const uint32_t k_base = smem_addr(Kt), v_base = smem_addr(Vt);
    // the first column block of this warpgroup's dK and dV columns (SPLIT)
    const uint32_t k_cols = L::SPLIT ? wg * (DKC / TQ::CB) * TQ::BLOCK_BYTES : 0;
    const uint32_t v_cols = L::SPLIT ? wg * (DVC / TV::CB) * TV::BLOCK_BYTES : 0;

    // 64 keys x DKC and x DVC: element e of n8 block j at [4j + e], key row
    // 16w + g8 + 8(e/2), column 8j + 2t4 + e%2 of the warpgroup's columns
    float dk[DKC / 2], dv[DVC / 2];
#pragma unroll
    for (int i = 0; i < DKC / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DVC / 2; ++i) dv[i] = 0.f;

    mbar_wait(kv_full, pass & 1);
    for (int r = r_first; r < r_end; r += STEP) {
      const int s = r % S;
      mbar_wait(&full[s], (r / S) & 1);
      const uint32_t q_base = smem_addr(q_tile(s)), do_base = smem_addr(do_tile(s));
      const bool masked = !(tiles[(rank + (r - r0) * C) % nlive] & 1);
#pragma unroll
      for (int h = 0; h < TILE / NQ; ++h) {
        const uint32_t kb = opaque(k_base), vb = opaque(v_base);
        // S^T = K Q^T (over HD) and dP^T = V dO^T (over HDV): 64 keys x NQ
        // queries (rows h NQ.. of the Q and dO tiles: a whole number of
        // 8-row swizzle groups)
        float st[NQ / 2], dp[NQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<NQ>(st, desc_k<HD>(kb, kk), desc_k<HD>(q_base + h * NQ * TQ::SW, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < HDV / 16; ++kk)
          wgmma_ss<NQ>(dp, desc_k<HDV>(vb, kk), desc_k<HDV>(do_base + h * NQ * TV::SW, kk),
                       kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);
        // P^T into st, dS^T (times dz/draw / scale) into dp
        BWD_SCORES(item_scores, capped, masked, st, dp, kp_lo, kp_hi, rows + s * TILE + h * NQ,
                   qps + s * TILE + h * NQ, t4, sc);
        // dV += P^T dO, dK += dS^T Q over this warpgroup's columns: the
        // reduction runs over the NQ queries
        uint32_t pa[NQ / 16][4], sa[NQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk) {
          a_frag(pa[kk], st, kk);
          a_frag(sa[kk], dp, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_rs<DVC>(dv, pa[kk], desc_mn<HDV>(do_base + v_cols, h * NQ / 16 + kk), 1);
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk)
          wgmma_rs<DKC>(dk, sa[kk], desc_mn<HD>(q_base + k_cols, h * NQ / 16 + kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < NQ / 16; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(sa[kk]);
        }
      }
      mbar_arrive(&empty[s]);
      // the stage's next item, once its warpgroup (SPLIT: both) is done
      // with this one
      if (leader && r + S < r_end) {
        mbar_wait(&empty[s], (r / S) & 1);
        issue(r + S);
      }
    }

    // the block's partial, over K, V and the ring once every product and
    // load of the pass has completed, dK times the scale: each warpgroup
    // its own columns (SPLIT), or warpgroup 1's, then warpgroup 0 adds its
    // own (a fixed order)
    static_assert(KV_WGS == 2, "the block's partial adds two warpgroups");
    __syncthreads();
    // this thread's element (0, 0), from the thread id again: kept live
    // through the loop, the index would cost a register there
    const int t_e = int(opaque(uint32_t(tid)));
    const int e_row = 16 * ((t_e / 32) % 4) + (t_e % 32) / 4, e_col = 2 * (t_e % 4);
    const int e_wg = L::SPLIT ? t_e / WG : 0;
    float* red_k = reinterpret_cast<float*>(smem);  // the partials
    float* red_v = red_k + TILE * LDK;
    float* k_mine = red_k + e_row * LDK + e_col + e_wg * DKC;
    float* v_mine = red_v + e_row * LDV + e_col + e_wg * DVC;
    if constexpr (L::SPLIT) {
      acc_to_smem<false, DKC>(k_mine, dk, LDK, p.scale);
      acc_to_smem<false, DVC>(v_mine, dv, LDV, 1.f);
    } else {
      if (wg == 1) {
        acc_to_smem<false, DKC>(k_mine, dk, LDK, 1.f);
        acc_to_smem<false, DVC>(v_mine, dv, LDV, 1.f);
      }
      __syncthreads();
      if (wg == 0) {
        acc_to_smem<true, DKC>(k_mine, dk, LDK, p.scale);
        acc_to_smem<true, DVC>(v_mine, dv, LDV, 1.f);
      }
    }
    cluster_sync();
    // rows [rank * per, (rank + 1) * per) of dK and dV, the cluster's
    // partials summed in rank order
    const int per = TILE / C;
    constexpr int K4 = HD / 4, V4 = HDV / 4;
    for (int idx = tid; idx < per * (K4 + V4); idx += NT_KV) {
      const int row = rank * per + idx / (K4 + V4);
      const int c = idx % (K4 + V4);
      const bool is_v = c >= K4;
      const int c4 = (is_v ? c - K4 : c) * 4;
      const float* src = is_v ? red_v + row * LDV + c4 : red_k + row * LDK + c4;
      float4 acc = ld_cluster_f4(cluster_map(src, 0));
      for (int cr = 1; cr < C; ++cr) {
        const float4 x = ld_cluster_f4(cluster_map(src, cr));
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      const int key = k0 + row;
      if (key < p.Sk) {
        const long kr = (long(b) * p.Sk + key) * p.KV + kvh;
        bf16* dst = is_v ? p.dv + kr * HDV + c4 : p.dk + kr * HD + c4;
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
      }
    }
    // no block leaves, or loads its next pass's tiles over its partial,
    // while another reads that partial (the fences order the partial's
    // ordinary loads and stores with the next pass's TMA writes)
    fence_proxy_async();
    cluster_sync();
    fence_proxy_async();
    r0 = r_end;
  }
}

// ---------------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------------

// Shared memory of a dQ block (from a 1024-aligned base): Q and dO, the
// ring's K and V tiles, each stage's key positions, the barriers, then the
// live and full bitmasks over the kv tiles, sized at launch.  Two blocks an
// SM up to hd 128 (two stages at 128, three below).  Past it a thread's dQ
// (HD / 2 floats) beside S and dP (32 each) needs more than the 168
// registers two blocks leave, and two blocks' tiles more than the SM's
// shared memory: one block an SM, with three stages at (192, 128) (40 KB
// each) and two at (256, 256) (64 KB each).
template <int HD, int HDV>
struct QSmem {
  using TQ = Tile<HD>;   // Q and K tiles
  using TV = Tile<HDV>;  // dO and V tiles
  static constexpr int STAGES = HD == 128 || HD == 256 ? 2 : 3;
  static constexpr int MIN_BLOCKS = HD > 128 ? 1 : 2;
  static constexpr size_t STAGE = size_t(TQ::BYTES) + TV::BYTES;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = TQ::BYTES;
  static constexpr size_t ring_off = STAGE;  // stage s: K, then V
  static constexpr size_t kp_off = ring_off + size_t(STAGES) * STAGE;
  static constexpr size_t bar_off = kp_off + size_t(STAGES) * TILE * 4;
  static constexpr size_t red_off = bar_off + (1 + 2 * STAGES) * 8;
  static constexpr size_t bits_off = red_off + 4 * 4;
  static_assert(1024 + bits_off + 256 <= SMEM_MAX, "a block's shared memory");
  static size_t bytes(int nk) { return 1024 + bits_off + 2 * size_t((nk + 31) / 32) * 4; }
};

template <int HD, int HDV>
__global__ void __launch_bounds__(NT_Q, QSmem<HD, HDV>::MIN_BLOCKS) bwd_dq_wgmma_kernel(
    const __grid_constant__ Params p) {
  using TQ = Tile<HD>;
  using L = QSmem<HD, HDV>;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qt = smem + L::q_off;
  unsigned char* dOt = smem + L::do_off;
  auto k_tile = [&](int s) { return smem + L::ring_off + size_t(s) * L::STAGE; };
  auto v_tile = [&](int s) { return k_tile(s) + TQ::BYTES; };
  int* kps = reinterpret_cast<int*>(smem + L::kp_off);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;
  int* red = reinterpret_cast<int*>(smem + L::red_off);
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + L::bits_off);  // then full

  // late query tiles first: under a causal mask they have the most work
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nk = p.Sk_pad / TILE;
  const int nwords = (nk + 31) / 32;
  const int* kp_b = p.kp + long(b) * p.Sk_pad;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    fence_barrier_init();
  }
  // the block's q-position range (rows inside Sq), then the live / full
  // bitmasks of the kv tiles, as the forward decides them
  if (warp < 2) {
    const int qi = q0 + tid;
    const bool in = qi < p.Sq;
    const int qp = in ? p.qp[qi] : 0;
    int lo = in ? qp : INT32_MAX, hi = in ? qp : INT32_MIN;
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      red[warp] = lo;
      red[2 + warp] = hi;
    }
  }
  for (int i = tid; i < 2 * nwords; i += NT_Q) live[i] = 0u;
  __syncthreads();
  const int min_qp = min(red[0], red[1]), max_qp = max(red[2], red[3]);
  for (int t = warp; t < nk; t += NT_Q / 32) {
    bool some = false, every = true;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      key_reach(kp_b[t * TILE + 32 * r + lane], min_qp, max_qp, p, some, every);
    const bool any = __any_sync(0xffffffffu, some);
    const bool all = __all_sync(0xffffffffu, every);
    if (lane == 0) {
      if (any) atomicOr(&live[t >> 5], 1u << (t & 31));
      if (all) atomicOr(&live[nwords + (t >> 5)], 1u << (t & 31));
    }
  }
  __syncthreads();

  if (tid >= WG) {
    // producer: Q and dO once, then the ring of live kv tiles
    if (tid == WG) {
      mbar_expect_tx(q_full, L::STAGE);
      load_tile<HD>(Qt, &p.tq, q_full, h, q0, b);
      load_tile<HDV>(dOt, &p.tdo, q_full, h, q0, b);
      int n = 0;
      for (int t = next_tile(live, 0, nk); t < nk; t = next_tile(live, t + 1, nk), ++n) {
        const int s = n % S;
        if (n >= S) mbar_wait(&empty[s], ((n / S) - 1) & 1);
        mbar_expect_tx(&full[s], L::STAGE + TILE * 4);
        load_tile<HD>(k_tile(s), &p.tk, &full[s], kvh, t * TILE, b);
        load_tile<HDV>(v_tile(s), &p.tv, &full[s], kvh, t * TILE, b);
        bulk_load(kps + s * TILE, kp_b + t * TILE, TILE * 4, &full[s]);
      }
    }
  } else {
    const int w = warp;
    const int g8 = lane >> 2, t4 = lane & 3;
    const Scores sc(p);
    const bool capped = p.softcap > 0.f;
    const uint32_t q_base = smem_addr(Qt), do_base = smem_addr(dOt);
    // this thread's rows 16w + g8 and 16w + g8 + 8: {lse, D} and q_pos
    float2 rr[2];
    int qp_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + 16 * w + g8 + 8 * r;
      rr[r] = p.rows[long(bh) * p.Sq_pad + qi];
      qp_r[r] = p.qp[qi];
    }
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    int n = 0;
    for (int t = next_tile(live, 0, nk); t < nk; t = next_tile(live, t + 1, nk), ++n) {
      const int s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      const uint32_t k_base = smem_addr(k_tile(s)), v_base = smem_addr(v_tile(s));
      const uint32_t qb = opaque(q_base), dob = opaque(do_base);
      // S = Q K^T (over HD) and dP = dO V^T (over HDV): 64 queries x 64 keys
      float score[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss_n64(score, desc_k<HD>(qb, kk), desc_k<HD>(k_base, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<HDV>(dob, kk), desc_k<HDV>(v_base, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(score);
      fence_regs(dp);
      const bool masked = !((live[nwords + (t >> 5)] >> (t & 31)) & 1u);
      BWD_SCORES(tile_scores, capped, masked, score, dp, rr, qp_r, kps + s * TILE, t4, sc);
      // dQ += dS K: the reduction runs over the 64 keys
      uint32_t sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_frag(sa[kk], dp, kk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dq, sa[kk], desc_mn<HD>(k_base, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(sa[kk]);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + 16 * w + g8 + 8 * r;
      if (qi >= p.Sq) continue;
      bf16* dst = p.dq + ((long(b) * p.Sq + qi) * p.H + h) * HD + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            dq[4 * j + 2 * r] * p.scale, dq[4 * j + 2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// Raise both main kernels' dynamic shared-memory cap to the card's opt-in
// maximum, once per instance and card.
template <int HD, int HDV>
cudaError_t prepare() {
  static int done[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkdv_wgmma_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done[dev] = 1;
  return err;
}

template <int HD, int HDV>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v,
                   cudaStream_t stream) {
  cudaError_t err = prepare<HD, HDV>();
  if (err != cudaSuccess) return err;
  const long rows = long(p.B) * p.H * p.Sq_pad;
  const long per_block = 4 * (32 / (HDV / 8));  // rows a block of the preparation
  bwd_prep_kernel<HD, HDV>
      <<<unsigned((rows + per_block - 1) / per_block), 128, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the maps after a runtime launch: the driver's encoder needs the
  // device's context current in this thread, which a thread that has made
  // no runtime call yet (autograd's backward thread) does not have
  if (!encode_map<HD>(&p.tq, q, p.B, p.Sq, p.H) ||
      !encode_map<HDV>(&p.tdo, p.dout, p.B, p.Sq, p.H) ||
      !encode_map<HD>(&p.tk, k, p.B, p.Sk, p.KV) || !encode_map<HDV>(&p.tv, v, p.B, p.Sk, p.KV))
    return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  const int nk = p.Sk_pad / TILE;
  cfg.gridDim = dim3((p.pair ? (nk + 1) / 2 : nk) * p.cluster, p.B * p.KV);
  cfg.blockDim = dim3(NT_KV);
  cfg.dynamicSmemBytes = KVSmem<HD, HDV>::bytes(p.Sq_pad / TILE);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_dkdv_wgmma_kernel<HD, HDV>, p);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid_q(p.Sq_pad / TILE, p.B * p.H);
  bwd_dq_wgmma_kernel<HD, HDV>
      <<<grid_q, NT_Q, QSmem<HD, HDV>::bytes(p.Sk_pad / TILE), stream>>>(p);
  return cudaGetLastError();
}

// the head-dim pairs (q/k, v): flash_attention.cu's, each with a forward
// instance that writes the log-sum-exp
#define FLASH_BWD_INSTANCES(X) X(32, 32) X(64, 64) X(128, 128) X(192, 128) X(256, 256)

}  // namespace

// Plain C entry point (bound with ctypes): the three launches on `stream`,
// asynchronous.  Returns a cudaError_t: 0 when every launch was accepted.
// Scratch, written whole by the first launch: `rows` (B, H, Sq_pad) float2,
// `qp` (Sq_pad,) int32, `kp` (B, Sk_pad) int32, with Sq_pad and Sk_pad Sq
// and Sk rounded up to 64.  q and k have head dim `hd`, v, out, dout and dv
// `hd_v`.  `cluster` (1, 2, 4 or 8) blocks of the dK/dV
// launch share a key tile; with `pair` a block takes two key tiles, j and
// nk - 1 - j.  dq, dk and dv are written whole.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, void* rows, int* qp, int* kp, void* dq, void* dk, void* dv,
    const int* q_pos, const int* kv_pos, const int* kv_mask,
    int B, int H, int KV, int Sq, int Sk, int hd, int hd_v,
    float scale, float softcap, int window, int causal, int protected_, int cluster,
    int pair, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0)
    return int(cudaErrorInvalidValue);
  Params p;
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.rows = static_cast<float2*>(rows);
  p.qp = qp;
  p.kp = kp;
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
  p.Sq_pad = (Sq + TILE - 1) / TILE * TILE;
  p.Sk_pad = (Sk + TILE - 1) / TILE * TILE;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  p.causal = causal;
  p.protected_ = protected_;
  p.cluster = cluster;
  p.pair = pair != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_LAUNCH(D, DV) \
  if (hd == D && hd_v == DV) return int(launch<D, DV>(p, q, k, v, s));
  FLASH_BWD_INSTANCES(FLASH_BWD_LAUNCH)
#undef FLASH_BWD_LAUNCH
  return int(cudaErrorInvalidValue);
}
