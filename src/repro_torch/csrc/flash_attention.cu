// Flash attention forward for Hopper (sm_90a): bf16 inputs, f32 math.
//
// Replaces the TPU kernel repro.kernels.flash_attention._flash_kernel
// (src/repro/kernels/flash_attention.py:34, pallas_call at :160).  It
// computes the same function: online-softmax GQA attention in which query
// head h reads kv head h / (H / KV), masked by positions (kv_pos < 0 is an
// invalid key; causal, sliding-window and protected-sink predicates), an
// optional per-row kv_mask, an optional tanh softcap, and zeros for a row
// whose every key is masked.  It reads and writes the model layout
// (B, S, H, hd) directly: no transposes, and kv heads are never replicated.
// The value head dim may differ from the query/key head dim: the instances
// are (32,32), (64,64), (128,128), for DeepSeek's MLA (192,128) (q and k of
// 128 "nope" + 64 rope dims, v of 128), and for paligemma's Gemma heads
// (256,256).  The reference pads v to 192 and slices the output back;
// keeping v at 128 reads a third fewer V bytes and holds a third fewer
// output accumulators.
//
// Bound (NVIDIA H100 80GB HBM3, 3.35 TB/s, 989 TFLOP/s bf16; each input
// read once and the output written once; the operations the masks leave).
//   qwen2 ERA 8x256, H 12 / KV 2, (128,128), non-causal: 14.7 MB, 3.2 GFLOP:
//     0.00438 ms (bytes) against 0.00326 (operations).
//   qwen2 ERA 8x128: 0.00219 ms (bytes).  AR prefill 8x512 causal: 29.4 MB,
//     6.5 GFLOP: 0.00876 ms (bytes) against 0.0066.
//   MLA 8x256 causal, H = KV = 16, (192,128): 0.01252 ms (bytes).
//   hymba 8x256, H 25 / KV 5, (64,64), row lengths: 0.00470 ms (bytes);
//     its prefill 8x640 causal, window 1024, 128 protected: 0.01174 (bytes).
//   paligemma 8x256, H 8 / KV 1, (256,256): 0.00563 ms (bytes); its
//     prefill 8x768 causal: 1.94e10 FLOP, 0.01957 ms (operations).
//   whisper encoder 8x1500, H = KV = 8, (64,64): 3.69e10 FLOP, 0.03727 ms
//     (operations); cross 8x512 over 1500 keys: 0.01272 ms (operations).
// Most path shapes sit near the ridge; the long prefills and whisper's
// encoder are bound by the tensor cores.
//
// What held the previous design back: FlashAttention-2 on warp-level
// mma.sync (4 warps of 16 query rows over 32-key tiles, a 2-stage cp.async
// ring), 1.15-2.61x SDPA at 8 of the 10 path shapes.  A clock64 copy of it
// (chip_smoke.py --flash-ab; NVIDIA H100 80GB HBM3, 700 W; PERF.md) split
// a warp's cycles: waiting for the next tile's copies and the block-wide
// barrier after them 0.15-0.30, its m16n8k16 products with the ldmatrix
// loads that feed them 0.19-0.36, mask and softmax 0.11-0.27, all in
// sequence: a warp computed nothing while it waited or copied.  This
// design (FlashAttention-3's plan, arXiv:2407.08608, laid out as the
// backward's dQ kernel, flash_attention_bwd.cu):
//
//  1. Loads by TMA.  A block owns one (batch, head, 64-query tile): a
//     producer warp loads Q once and keeps the block's live K and V tiles
//     in flight in a ring of STAGES stages, a full and an empty mbarrier a
//     stage for K and another pair for V: a tile's K is free once its
//     scores are computed, its V only a tile later (3.), so with separate
//     barriers two stages already keep one tile in flight.  Tile 0 is
//     loaded with Q, before the tiles are marked (4.): every ring starts
//     with it, and the consumers drop it if it is dead.  Tensor maps are
//     4-D over (B, S, heads, hd), so a ragged Sq or Sk zero-fills inside
//     its own batch row; tiles are 128-byte swizzled in 64-column boxes
//     from hd 64 up, 64-byte at hd 32 (Tile<HD, ROWS>, flash_sm90.cuh).
//     The maps are encoded on the host in every call and passed as
//     __grid_constant__ parameters: nothing is copied to device memory,
//     so a launch can be captured in a CUDA graph.  The producer also
//     writes each tile's key positions (kv_pos with kv_mask and Sk folded
//     in, -1 = no key) and its entry word (live, full) beside it in the
//     stage, and after the last live tile an entry with no tile (END),
//     which ends the consumers' loop.  The consumers' ring waits are now
//     0.03-0.11 of their cycles.
//  2. Products by wgmma.  One consumer warpgroup computes S = Q K^T with
//     both operands in shared memory (wgmma_ss, K-major), a 64 x BK tile in
//     its accumulator registers.  The online softmax runs there,
//     branch-free: the softcap and the per-element mask are template
//     instances picked outside the element loop (a full tile skips the
//     mask), and exp2 is the SFU's ex2.approx.  P is rounded to bf16 in
//     registers and is the register A operand of O += P V (wgmma_rs), with
//     V read through an MN-major descriptor.  O and the running max and
//     sum stay in registers.
//  3. Overlap inside the warpgroup.  The products of tile j+1's scores and
//     tile j's P V are issued together; the warpgroup waits for the scores
//     only, runs tile j+1's softmax while the tensor cores run P V (the
//     wait for P V behind it is 0.00-0.02 of the cycles), then rescales O
//     and frees tile j's V.  Across blocks an SM holds BLOCKS of them,
//     whose products and softmax interleave.
//  4. Tile skip from positions, not indices.  Before the loop the block
//     takes the min and max q_pos of its rows and, one warp a tile, marks
//     each kv tile live (some key can be valid for some row: kv_pos >= 0,
//     kv_mask set, kp <= max q_pos under causal, and kp > min q_pos -
//     window or kp < protected under a window) and full (every key valid
//     for every row), one byte a tile: no atomics.  The flags hold a chunk
//     of CHUNK tiles: the five warps mark the first before the loop, and
//     the producer warp marks each later one when it reaches it (past
//     32,768 keys at 32-key tiles, 65,536 at 64-key ones), so shared
//     memory does not grow with Sk and any Sk runs.  Only the producer
//     reads the flags; the consumers take a tile's full flag from its ring
//     entry.  Only live tiles are computed, which leaves (O, m, l) as an
//     all-masked tile would.  Ring slots, holes of -1 and queries offset
//     from keys are handled, since nothing is inferred from tile numbers.
//     A row with no valid key ends with l = 0 and writes exact zeros.  The grid is (B*H, query tiles)
//     with the last query tile first, so under a causal mask the blocks
//     with the most work are dispatched first.
//  5. Output.  O / l is written once as bf16 through shared memory (over Q
//     and the ring, once every product has read them), 16 bytes a thread,
//     never past row Sq.
//  6. Determinism.  No atomics; each (b, h, query tile) is one block's, its
//     kv tiles summed in order: two runs are bitwise equal.  The LSE
//     instance differs only in the store of each row's log-sum-exp, so its
//     O is bitwise the serving instance's.
//
// Per head dim (FLASH_FWD_CFG), chosen by --flash-ab at the ten path
// shapes and the training one (PERF.md): the key tile, the ring's stages
// and the blocks an SM the registers are set for.  Registers and shared
// memory (the same at every Sk), no spill anywhere:
//   hd 32 / 64: 64, 3 stages, 3 blocks: 128 registers, 31.6 / 60.3 KB.
//     4 blocks with 32-key tiles (94-96 registers) took 0.164 ms at
//     whisper's encoder against 0.132; with 64-key tiles they spill.
//   hd 128: 32, 3, 3: 127 registers (LSE 128), 68.1 KB.  The ERA
//     shape's 384 blocks fit one wave: 0.0144 ms against 0.0167 with
//     64-key tiles at 2 blocks (168 registers), which win the causal
//     8x512 prefill (0.0305 against 0.0327) and 8x128 (0.0069 / 0.0073).
//   hd 192 (MLA): 64, 2, 2: 168 registers, 109.2 KB.
//   hd 256: 64, 3, 1: 254 registers, 232.3 KB; paligemma's 8x768 prefill
//     0.075-0.078 ms against 0.082 at two stages.
// A block is one consumer warpgroup (64 query rows) and a producer warp.
// Two consumer warpgroups a block (128 query rows sharing each K/V tile:
// half the L2 reads; 288 threads, 161-168 registers, one block an SM) were
// slower or no faster at every shape (qwen2 ERA 0.0178 ms, whisper's
// encoder 0.162): fewer warps an SM hide less of the softmax's latency.
// Where the time goes now (a build with -DFLASH_CLOCKS, which --flash-ab
// makes: each consumer warp's clock64 sums): in the kv loop, mask and
// softmax take 0.12-0.37 of a consumer warp's cycles and the scores' wait
// 0.04-0.18; before and after it, 0.42-0.57 and 0.06-0.16 at the short
// shapes (the tile marking's loads, Q's and the first tile's arrival, the
// output's write), 0.26 and 0.03 at whisper's 1,500 keys.
//
// For training, a non-null `lse` takes each row's m * mul + log2(l) (base
// 2, the units the kernel's exp2 works in), or +inf for a row with no valid
// key; the backward (flash_attention_bwd.cu) recomputes P from it.  It is a
// separate instance (LSE true) of every pair.
//
// Numbers.  Scores are accumulated in f32; p = ex2.approx(x * mul - m *
// mul) with the scale folded into mul (about 2^-22 relative, far inside the
// 2^-7 relative tolerance the output is held to); the softcap uses the
// full-precision tanhf.  P is rounded to bf16 before P V; the row sum l
// adds the unrounded p.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;
using namespace flash::sm90;

constexpr int BQ = 64;              // query rows of a block: its consumer warpgroup's
constexpr int NC = 128;             // consumer threads
constexpr int NTHREADS = NC + 32;   // and the producer warp
constexpr int NWARPS = NTHREADS / 32;
constexpr int CHUNK = 1024;         // kv tiles whose flags a marking pass holds
constexpr int MARK = 8;             // tiles a warp marks at a time
constexpr size_t SMEM_MAX = 232448;     // dynamic shared memory a block can have
constexpr size_t SMEM_PER_SM = 233472;  // an SM's, every block's share counted

// a kv tile's flags, and its ring entry's word (END: the ring has no more tiles)
constexpr int LIVE = 1, FULL = 2, END = 4;

// Per q/k head dim: X(hd, keys a kv tile, stages of the ring, blocks an SM
// the register budget is set for).
#define FLASH_FWD_CFG(X) \
  X(32, 64, 3, 3) X(64, 64, 3, 3) X(128, 32, 3, 3) X(192, 64, 2, 2) X(256, 64, 3, 1)

template <int HD>
struct Cfg;
#define FLASH_FWD_CFG_DEF(D, K, S, NB) \
  template <>                          \
  struct Cfg<D> {                      \
    static constexpr int BK = K;       \
    static constexpr int STAGES = S;   \
    static constexpr int BLOCKS = NB;  \
  };
FLASH_FWD_CFG(FLASH_FWD_CFG_DEF)
#undef FLASH_FWD_CFG_DEF

// --flash-ab builds a copy with -DFLASH_CLOCKS: each consumer warp sums the
// clock64 cycles of its kv loop's parts, read back by repro_flash_clocks
#ifdef FLASH_CLOCKS
#define CLOCKED(...) __VA_ARGS__
constexpr int CLOCK_SLOTS = 5;  // ring wait, scores, mask and softmax, P V's tail, rescale
__device__ unsigned long long flash_clk[CLOCK_SLOTS + 2];  // then the loop's, all
#else
#define CLOCKED(...)
#endif

struct Params {
  CUtensorMap tq, tk, tv;  // (B, S, heads, hd or hd_v) bf16, boxes (CB, 1, BQ or BK, 1)
  bf16* o;                 // (B, Sq, H, hd_v)
  const int* q_pos;        // (Sq,)
  const int* kv_pos;       // (Sk,), < 0 = invalid slot
  const int* kv_mask;      // (B, Sk), 0 = masked key; may be null
  float* lse;              // (B, H, Sq) log2-sum-exp2 of each row; may be null
  int B, H, KV, Sq, Sk;
  float scale, softcap;
  int window, causal, protected_;
};

// Shared memory of a block (from a 1024-aligned base): Q, the ring's K and
// V tiles, each stage's key positions and entry word, the barriers (Q's,
// then each stage's K full, V full, K empty and V empty), the two q-range
// warps' min and max, then one byte a kv tile of a chunk (LIVE, FULL).
// After the loop the output is staged over Q and the ring (rows of HDV + 8).
template <int HD, int HDV>
struct Smem {
  static constexpr int BK = Cfg<HD>::BK;
  static constexpr int STAGES = Cfg<HD>::STAGES;
  using TQ = Tile<HD, BQ>;
  using TK = Tile<HD, BK>;
  using TV = Tile<HDV, BK>;
  static constexpr int LDO = HDV + 8;
  static constexpr size_t STAGE = size_t(TK::BYTES) + TV::BYTES;
  static constexpr size_t q_off = 0;
  static constexpr size_t ring_off = TQ::BYTES;  // stage s: K, then V
  static constexpr size_t kp_off = ring_off + size_t(STAGES) * STAGE;
  static constexpr size_t entry_off = kp_off + size_t(STAGES) * BK * 4;
  static constexpr size_t bar_off = entry_off + (STAGES * 4 + 7) / 8 * 8;
  static constexpr size_t red_off = bar_off + (1 + 4 * STAGES) * 8;
  static constexpr size_t flags_off = red_off + 4 * 4;
  // the base's alignment, the layout, the flags
  static constexpr size_t BYTES = 1024 + flags_off + CHUNK;
  static_assert(TQ::BYTES % (8 * TQ::SW) == 0 && TK::BYTES % (8 * TK::SW) == 0 &&
                    TV::BYTES % (8 * TV::SW) == 0,
                "tiles at swizzle-aligned offsets");
  static_assert(size_t(BQ) * LDO * 2 <= kp_off, "the output stages over Q and the ring");
  static_assert(BK == 32 || BK == 64, "whole warps of keys, one wgmma of scores");
  static_assert(BYTES <= SMEM_MAX, "a block's shared memory");
  static_assert(size_t(Cfg<HD>::BLOCKS) * (BYTES + 1024) <= SMEM_PER_SM,
                "BLOCKS blocks of this instance fit an SM's shared memory");
};

// The softcap, the mask and the online softmax of one kv tile, in place of
// its scores x (64 x BK, this thread's element e of n8 block j at [4j + e]:
// row g8 + 8 (e / 2) of its warp's 16, key 8j + 2 t4 + e % 2).  Kp holds the
// tile's key positions and qp this thread's two rows' positions; alpha
// takes the factor the running output is rescaled by.
template <bool CAPPED, bool MASKED, int BK>
__device__ __forceinline__ void online_softmax(float (&x)[BK / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2],
                                               const int* Kp, const int (&qp)[2], int t4,
                                               float mul, const Params& p) {
  if constexpr (CAPPED || MASKED) {
    const float cap_in = CAPPED ? p.scale / p.softcap : 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int2 kp =
          MASKED ? *reinterpret_cast<const int2*>(Kp + 8 * j + 2 * t4) : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = x[4 * j + e];
        if constexpr (CAPPED) v = p.softcap * tanhf(v * cap_in);
        if constexpr (MASKED) v = key_valid((e & 1) ? kp.y : kp.x, qp[e >> 1], p) ? v : NEG_INF;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m_run[r];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]));
    mx = quad_max(mx);
    // no valid key yet: subtract 0, so masked scores give exp2(-huge) = 0
    const float base = mx > NEG_INF / 2 ? mx * mul : 0.f;
    alpha[r] = ex2_approx(fmaf(m_run[r], mul, -base));
    m_run[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      x[4 * j + 2 * r] = ex2_approx(fmaf(x[4 * j + 2 * r], mul, -base));
      x[4 * j + 2 * r + 1] = ex2_approx(fmaf(x[4 * j + 2 * r + 1], mul, -base));
      sum += x[4 * j + 2 * r] + x[4 * j + 2 * r + 1];
    }
    l_run[r] = l_run[r] * alpha[r] + sum;  // this thread's columns only
  }
}

// the four instances of the softmax, picked by two uniform flags
#define FWD_SOFTMAX(capped, masked, ...)                        \
  do {                                                          \
    if (capped) {                                               \
      if (masked) online_softmax<true, true, BK>(__VA_ARGS__);  \
      else online_softmax<true, false, BK>(__VA_ARGS__);        \
    } else {                                                    \
      if (masked) online_softmax<false, true, BK>(__VA_ARGS__); \
      else online_softmax<false, false, BK>(__VA_ARGS__);       \
    }                                                           \
  } while (0)

// the consumer warpgroup's own barrier (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NC) : "memory");
}

// This lane's key positions in the MARK kv tiles t0, t0 + stride, ..
// (kv_mask and Sk folded in, -1 = no key).
template <int BK>
__device__ __forceinline__ void load_marks(int (&marks)[MARK][BK / 32], int t0, int stride,
                                           int lane, long mask_off, const Params& p) {
#pragma unroll
  for (int u = 0; u < MARK; ++u)
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {
      const int j = (t0 + u * stride) * BK + 32 * c + lane;
      marks[u][c] = j < p.Sk ? p.kv_pos[j] : -1;
      if (j < p.Sk && p.kv_mask != nullptr && p.kv_mask[mask_off + j] == 0) marks[u][c] = -1;
    }
}

// The flags of those tiles below `end`, for query positions in [lo, hi],
// into flags[t % CHUNK]: a warp's vote, stored by its first lane.
template <int BK>
__device__ __forceinline__ void store_marks(uint8_t* flags, const int (&marks)[MARK][BK / 32],
                                            int t0, int stride, int end, int lane, int lo, int hi,
                                            const Params& p) {
#pragma unroll
  for (int u = 0; u < MARK; ++u) {
    const int t = t0 + u * stride;
    if (t >= end) break;
    bool some = false, every = true;
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) key_reach(marks[u][c], lo, hi, p, some, every);
    const bool any = __any_sync(0xffffffffu, some);
    const bool all = __all_sync(0xffffffffu, every);
    if (lane == 0) flags[t % CHUNK] = uint8_t((any ? LIVE : 0) | (any && all ? FULL : 0));
  }
}

template <int HD, int HDV, bool LSE>
__global__ void __launch_bounds__(NTHREADS, Cfg<HD>::BLOCKS)
    flash_fwd_kernel(const __grid_constant__ Params p) {
  using L = Smem<HD, HDV>;
  constexpr int BK = L::BK;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* Qt = smem + L::q_off;
  auto k_tile = [&](int s) { return smem + L::ring_off + size_t(s) * L::STAGE; };
  auto v_tile = [&](int s) { return k_tile(s) + L::TK::BYTES; };
  int* kps = reinterpret_cast<int*>(smem + L::kp_off);
  int* entry = reinterpret_cast<int*>(smem + L::entry_off);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;
  int* red = reinterpret_cast<int*>(smem + L::red_off);
  uint8_t* flags = smem + L::flags_off;
  CLOCKED(const long long c_start = clock64();)

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  // the last query tile first: under a causal mask it has the most work
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nk = (p.Sk + BK - 1) / BK;
  const long mask_off = long(b) * p.Sk;

  // the producer's first thread: the barriers, then Q and tile 0's K and V,
  // in flight while the tiles are marked.  Every ring starts with tile 0:
  // live, it is the first tile computed; dead, the consumers drop it.
  if (tid == NC) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 32);  // the producer warp's lanes (the tile's key positions)
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], NC);
      mbar_init(&v_empty[s], NC);
    }
    fence_barrier_init();
    mbar_expect_tx(q_full, L::TQ::BYTES);
    load_tile<HD, BQ>(Qt, &p.tq, q_full, h, q0, b);
    // K's bytes without an arrival: the warp's 32 come with tile 0's key
    // positions, after the marking
    mbar_expect_tx_only(&k_full[0], L::TK::BYTES);
    load_tile<HD, BK>(k_tile(0), &p.tk, &k_full[0], kvh, 0, b);
    mbar_expect_tx(&v_full[0], L::TV::BYTES);
    load_tile<HDV, BK>(v_tile(0), &p.tv, &v_full[0], kvh, 0, b);
  }
  // this thread's rows as a consumer: 16 w + g8 and + 8
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row0 = 16 * warp + g8;
  int qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    qp[r] = qi < p.Sq && warp < NWARPS - 1 ? p.q_pos[qi] : Q_PAD_POS;
  }
  // The block's q-position range (rows inside Sq), then the live and full
  // flags of the first chunk's kv tiles, one warp a tile.  MARK tiles a
  // warp at a time: their loads are issued together, the first batch
  // before the q range is known, so the pass waits out about one load
  // latency per MARK * NWARPS tiles (against one tile a warp at a time: 4%
  // less time at whisper's cross prefill, 6% at MLA's 8x256, in one
  // --flash-ab process).
  int marks[MARK][BK / 32];
  load_marks<BK>(marks, warp, NWARPS, lane, mask_off, p);
  if (warp < 2) {
    const int qi = q0 + tid;
    const bool in = qi < p.Sq;
    const int qpos = in ? p.q_pos[qi] : 0;
    int lo = in ? qpos : INT32_MAX, hi = in ? qpos : INT32_MIN;
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      red[warp] = lo;
      red[2 + warp] = hi;
    }
  }
  __syncthreads();
  const int min_qp = min(red[0], red[1]), max_qp = max(red[2], red[3]);
  for (int t0 = warp, end = min(nk, CHUNK); t0 < end; t0 += MARK * NWARPS) {
    if (t0 != warp) load_marks<BK>(marks, t0, NWARPS, lane, mask_off, p);
    store_marks<BK>(flags, marks, t0, NWARPS, end, lane, min_qp, max_qp, p);
  }
  __syncthreads();

  if (warp == NWARPS - 1) {
    // producer: ring entries of tile 0 and the live kv tiles after it, K
    // with its key positions and entry word, then V, and last an END
    // entry; the consumers free a tile's K after its scores and its V
    // after its P V, a tile later, so each has its own barriers.  The
    // first live tile after t, or nk; the warp marks each chunk after the
    // first when it reaches it.
    auto next_live = [&](int t) {
      for (++t; t < nk; ++t) {
        if (t % CHUNK == 0) {
          for (int t0 = t, end = min(nk, t + CHUNK); t0 < end; t0 += MARK) {
            load_marks<BK>(marks, t0, 1, lane, mask_off, p);
            store_marks<BK>(flags, marks, t0, 1, end, lane, min_qp, max_qp, p);
          }
          __syncwarp();
        }
        if (flags[t % CHUNK] & LIVE) break;
      }
      return t;
    };
    for (int n = 0, t = 0;; t = next_live(t), ++n) {
      const int s = n % S;
      const uint32_t phase = ((n / S) - 1) & 1;
      if (n >= S) mbar_wait(&k_empty[s], phase);
      if (t == nk) {
        if (lane == 0) entry[s] = END;
        mbar_arrive(&k_full[s]);
        return;
      }
      for (int i = lane; i < BK; i += 32) {
        const int j = t * BK + i;
        int kp = -1;
        if (j < p.Sk) {
          kp = p.kv_pos[j];
          if (p.kv_mask != nullptr && p.kv_mask[mask_off + j] == 0) kp = -1;
        }
        kps[s * BK + i] = kp;
      }
      if (lane == 0) entry[s] = flags[t % CHUNK];
      if (n == 0) {  // tile 0's copies are in flight
        mbar_arrive(&k_full[0]);
        continue;
      }
      if (lane == 0) {
        mbar_expect_tx(&k_full[s], L::TK::BYTES);
        load_tile<HD, BK>(k_tile(s), &p.tk, &k_full[s], kvh, t * BK, b);
        if (n >= S) mbar_wait(&v_empty[s], phase);
        mbar_expect_tx(&v_full[s], L::TV::BYTES);
        load_tile<HDV, BK>(v_tile(s), &p.tv, &v_full[s], kvh, t * BK, b);
      } else {
        mbar_arrive(&k_full[s]);
      }
    }
  }

  // the consumer warpgroup
  const bool capped = p.softcap > 0.f;
  // p = exp2(x * mul - m * mul), x the (capped) score; raw scores are
  // unscaled, so without a cap the scale folds into mul
  const float mul = capped ? LOG2E : p.scale * LOG2E;

  float o[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};
  uint32_t pa[BK / 16][4];  // the previous tile's P, the A operand of O += P V

  // S = Q K^T of the tile in stage s, into x
  auto scores = [&](float (&x)[BK / 2], int s) {
    const uint32_t qb = opaque(smem_addr(Qt)), kb = smem_addr(k_tile(s));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BK>(x, desc_k<HD, BQ>(qb, kk), desc_k<HD, BK>(kb, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of the tile in stage s, P the A fragments in pa
  auto pv = [&](int s) {
    const uint32_t vb = smem_addr(v_tile(s));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<HDV>(o, pa[kk], desc_mn<HDV, BK>(vb, kk), 1);
    wgmma_commit();
  };
  // Every barrier wait comes before the wgmma.fence of the products it
  // guards: a wait is a spin loop, and a product issued behind one (or
  // behind a branch between the fence and it) makes ptxas serialise every
  // wgmma of the kernel (C7520).  So the first tile is peeled off the loop.
  mbar_wait(q_full, 0);
  CLOCKED(unsigned long long clk[CLOCK_SLOTS] = {0};)
  int n = 0;
  mbar_wait(&k_full[0], 0);
  int e = entry[0];
  if (!(e & LIVE)) {  // tile 0 is dead: drop the ring's first entry
    mbar_wait(&v_full[0], 0);
    mbar_arrive(&k_empty[0]);
    mbar_arrive(&v_empty[0]);
    n = 1;
    mbar_wait(&k_full[1 % S], (1 / S) & 1);
    e = entry[1 % S];
  }
  if (!(e & END)) {
    int prev = n % S;
    {
      float x[BK / 2];
      wgmma_fence();
      scores(x, prev);
      wgmma_wait<0>();
      fence_regs(x);
      float alpha[2];  // O is still 0: nothing to rescale
      FWD_SOFTMAX(capped, !(e & FULL), x, m_run, l_run, alpha, kps + prev * BK, qp, t4, mul,
                  p);
      mbar_arrive(&k_empty[prev]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_frag(pa[kk], x, kk);
    }
    for (++n;; ++n) {
      const int s = n % S;
      CLOCKED(const long long ca = clock64();)
      mbar_wait(&k_full[s], (n / S) & 1);
      e = entry[s];
      if (e & END) break;
      mbar_wait(&v_full[prev], ((n - 1) / S) & 1);
      CLOCKED(const long long cb = clock64();)
      // this tile's scores, and behind them the previous tile's P V
      float x[BK / 2];
      wgmma_fence();
      scores(x, s);
      pv(prev);
      wgmma_wait<1>();  // the scores; P V runs on
      fence_regs(x);
      CLOCKED(const long long cc = clock64();)
      float alpha[2];
      FWD_SOFTMAX(capped, !(e & FULL), x, m_run, l_run, alpha, kps + s * BK, qp, t4, mul, p);
      CLOCKED(const long long cd = clock64();)
      mbar_arrive(&k_empty[s]);  // this tile's K and key positions are read
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
      CLOCKED(const long long ce = clock64();)
      mbar_arrive(&v_empty[prev]);  // the previous tile's V is read
#pragma unroll
      for (int i = 0; i < HDV / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) a_frag(pa[kk], x, kk);
      prev = s;
      CLOCKED(const long long cf = clock64(); clk[0] += cb - ca; clk[1] += cc - cb;
              clk[2] += cd - cc; clk[3] += ce - cd; clk[4] += cf - ce;)
    }
    mbar_wait(&v_full[prev], ((n - 1) / S) & 1);
    wgmma_fence();
    pv(prev);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
  }
  CLOCKED(const long long c_loop = clock64();)

  // O / l as bf16, staged over Q and the ring once every product of the
  // warpgroup has read them, then written in 16-byte rows; for the
  // backward, each row's m * mul + log2(l) (so p = exp2(x * mul - lse)),
  // +inf for a row with no valid key (every p of the row is then 0)
  consumers_sync();
  constexpr int LDO = L::LDO;
  bf16* Os = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = row0 + 8 * r;
    if constexpr (LSE) {
      if (t4 == 0 && q0 + row < p.Sq)
        p.lse[long(bh) * p.Sq + q0 + row] = l > 0.f ? fmaf(m_run[r], mul, log2f(l)) : pos_inf();
    }
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(Os + row * LDO + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
  consumers_sync();
  constexpr int VPR = HDV / 8;  // 16-byte vectors a row
  const long o_off = (long(b) * p.Sq * p.H + h) * HDV;
  for (int idx = tid; idx < BQ * VPR; idx += NC) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    const int qi = q0 + r;
    if (qi < p.Sq)
      *reinterpret_cast<uint4*>(p.o + o_off + long(qi) * p.H * HDV + c) =
          *reinterpret_cast<const uint4*>(Os + r * LDO + c);
  }
#ifdef FLASH_CLOCKS
  if (lane == 0) {
    for (int i = 0; i < CLOCK_SLOTS; ++i) atomicAdd(&flash_clk[i], clk[i]);
    atomicAdd(&flash_clk[CLOCK_SLOTS], (unsigned long long)(c_loop - c_start));
    atomicAdd(&flash_clk[CLOCK_SLOTS + 1], (unsigned long long)(clock64() - c_start));
  }
#endif
}

constexpr int MAX_DEVICES = 64;

// Raise the instance's dynamic shared-memory cap to the card's opt-in
// maximum, once per card (a launch still asks only for Smem::BYTES).
template <int HD, int HDV, bool LSE>
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
  err = cudaFuncSetAttribute(flash_fwd_kernel<HD, HDV, LSE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) done[dev] = 1;
  return err;
}

template <int HD, int HDV, bool LSE>
cudaError_t launch(Params& p, const void* q, const void* k, const void* v,
                   cudaStream_t stream) {
  constexpr int BK = Cfg<HD>::BK;
  cudaError_t err = allow_smem<HD, HDV, LSE>();
  if (err != cudaSuccess) return err;
  if (!encode_map<HD, BQ>(&p.tq, q, p.B, p.Sq, p.H) ||
      !encode_map<HD, BK>(&p.tk, k, p.B, p.Sk, p.KV) ||
      !encode_map<HDV, BK>(&p.tv, v, p.B, p.Sk, p.KV))
    return cudaErrorInvalidValue;
  // (B*H, query tiles): the wrapper keeps the query tiles within 65,535
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<HD, HDV, LSE><<<grid, NTHREADS, Smem<HD, HDV>::BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int HD, int HDV>
int blocks_per_sm() {
  int blocks = -1;
  if (allow_smem<HD, HDV, false>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_kernel<HD, HDV, false>,
                                                    NTHREADS, Smem<HD, HDV>::BYTES) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// the head-dim pairs (q/k, v) with an instance; each also has an LSE
// instance, which the backward (flash_attention_bwd.cu) reads
#define FLASH_INSTANCES(X) X(32, 32) X(64, 64) X(128, 128) X(192, 128) X(256, 256)

}  // namespace

// Plain C entry point (bound with ctypes).  Returns a cudaError_t: 0 on a
// successful launch.  The launch is asynchronous on `stream`; the tensor
// maps of q, k and v are encoded on the host in every call.  `lse` (B, H,
// Sq) float32 takes each row's log-sum-exp for the backward
// (flash_attention_bwd.cu); serving calls pass null.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* q_pos, const int* kv_pos, const int* kv_mask,
    int B, int H, int KV, int Sq, int Sk, int hd, int hd_v,
    float scale, float softcap, int window, int causal, int protected_,
    float* lse, void* stream) {
  Params p;
  p.o = static_cast<bf16*>(o);
  p.q_pos = q_pos;
  p.kv_pos = kv_pos;
  p.kv_mask = kv_mask;
  p.lse = lse;
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
  if (lse == nullptr) {
#define FLASH_LAUNCH(D, DV) \
  if (hd == D && hd_v == DV) return int(launch<D, DV, false>(p, q, k, v, s));
    FLASH_INSTANCES(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  } else {
#define FLASH_LAUNCH_LSE(D, DV) \
  if (hd == D && hd_v == DV) return int(launch<D, DV, true>(p, q, k, v, s));
    FLASH_INSTANCES(FLASH_LAUNCH_LSE)
#undef FLASH_LAUNCH_LSE
  }
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block for head dims (`hd`, `hd_v`) and `Sk`
// keys (the same at every Sk), or -1 for an unsupported pair.
extern "C" long long repro_flash_attention_smem_bytes(int hd, int hd_v, int Sk) {
#define FLASH_SMEM(D, DV) \
  if (hd == D && hd_v == DV) return (long long)Smem<D, DV>::BYTES;
  FLASH_INSTANCES(FLASH_SMEM)
#undef FLASH_SMEM
  return -1;
}

// Blocks of head dims (`hd`, `hd_v`) and `Sk` keys that one SM holds at
// once (the CUDA occupancy API, on the current card), or -1 on an error.
extern "C" int repro_flash_attention_blocks_per_sm(int hd, int hd_v, int Sk) {
#define FLASH_OCC(D, DV) \
  if (hd == D && hd_v == DV) return blocks_per_sm<D, DV>();
  FLASH_INSTANCES(FLASH_OCC)
#undef FLASH_OCC
  return -1;
}

#ifdef FLASH_CLOCKS
// Copy the clock sums (CLOCK_SLOTS, then the kv loop's and all cycles of
// every consumer warp) to `out` and zero them; a cudaError_t.
extern "C" int repro_flash_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, flash_clk, sizeof(flash_clk));
  if (e != cudaSuccess) return int(e);
  static const unsigned long long zero[CLOCK_SLOTS + 2] = {0};
  return int(cudaMemcpyToSymbol(flash_clk, zero, sizeof(zero)));
}
#endif
