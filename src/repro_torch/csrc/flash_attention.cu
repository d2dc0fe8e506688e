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
// Bound.  At the ERA path's shape (B=8, S=256, H=12, KV=2, hd=128,
// non-causal) the work is 4*B*H*S*S*hd = 3.2 GFLOP against 14.7 MB of
// inputs and output, 0.00438 ms at 3.35 TB/s against 0.00326 ms at the
// bf16 tensor peak: bytes bound it, by a little.  In the AR prefill (B=8,
// S=512, causal) the causal half is 6.5 GFLOP against 29.4 MB: 0.00876 ms
// (bytes) against 0.0066 ms (operations).  Both sit close to the ridge, so
// the kernel must keep the tensor cores fed and move each byte once.
//
// Design (FlashAttention-2 on warp-level mma.sync).  One block of 4 warps
// owns one (batch*head, 64-query tile) and walks the kv axis in 32-key
// tiles, which takes the place of the TPU's sequential kv grid axis; each
// warp owns 16 query rows end to end.  What the first version (WMMA through
// shared memory) lost time on, and what this one does instead:
//  1. Products and softmax in registers.  Q.K^T and P.V are
//     mma.sync.m16n8k16 bf16 products with f32 accumulators, their operands
//     brought from shared memory by ldmatrix (.trans for V).  Q is loaded
//     into A fragments once and stays in registers.  The 16x32 score tile
//     stays in the accumulator registers; the online softmax runs there,
//     each thread holding two rows' columns, so a row's max takes two quad
//     shuffles, and the row sum is kept per thread and reduced once at the
//     end.  P is rounded to bf16 in registers: an m16n8 accumulator pair is
//     the A fragment of the next k16 step.
//  2. Output in registers.  The output accumulator (16 x hd f32 a warp, 64
//     registers a thread at hd=128) and the running max and sum stay in
//     registers for the whole kv loop; the output is written once, as bf16,
//     through shared memory in 16-byte stores.
//  3. Overlap.  K/V tiles are copied by cp.async.cg (16 bytes a thread)
//     into a 2-stage ring: tile t+1 is in flight while tile t is computed.
//     Rows are padded to hd+8 bf16, so the 8 row addresses of an ldmatrix
//     phase fall in 8 distinct 16-byte bank groups.  Keys past Sk are
//     zero-filled.  The tile's kv_pos and kv_mask entries come in with it,
//     by 4-byte cp.async, so no load waits in the loop.
//  4. Occupancy.  No score, probability or output tile lives in shared
//     memory: a block holds the 2-stage K/V ring (Q is staged in the second
//     stage before the loop, the output in the first after it) and the
//     positions, 35 KB at hd=128 against 113 KB before.  Registers set the
//     occupancy: at most 168 a thread (167 used at hd=128, no spill) let
//     three blocks, 12 warps, share an SM, so the ERA shape's 384 blocks
//     (S=256, 64-query tiles) run in one wave on 132 SMs, and its 192 at
//     S=128 in less.  32-key tiles keep the score tile small enough for
//     that budget; 64-key tiles at two blocks an SM measured slower at
//     S=256 (PERF.md).  Late query tiles, which a causal mask leaves the
//     most work, are dispatched first.
//  5. A tile skip from positions, not indices.  Before the loop the block
//     takes the min and max q_pos of its rows and, one warp per tile and a
//     warp vote, marks each kv tile live (some key can be valid for some
//     row: kv_pos >= 0, kv_mask set, kp <= max q_pos under causal, and
//     kp > min q_pos - window or kp < protected under a window) and full
//     (every key is valid for every row).  Dead tiles are never loaded or
//     computed, which leaves (O, m, l) as an all-masked tile would; full
//     tiles skip the per-element mask.  Arbitrary positions (ring slots,
//     holes of -1, queries offset from keys) are handled, since nothing is
//     inferred from tile numbers.  A row with no valid key ends with l = 0
//     and writes exact zeros.
//  6. Host.  The shared-memory attribute is set once per instance and card,
//     not on every launch.
//
//  7. Head dim 256: Q from shared memory.  Kept in registers, a warp's Q
//     fragments would take 64 registers a thread and its 16 x 256 output
//     accumulator 128, which with the score tile and addresses is past the
//     255 a thread can have: it would spill.  So the (256,256) instance
//     keeps Q in shared memory (64 x 264 bf16, 33 KB of its own, beside the
//     two 33 KB K/V stages: ~100 KB a block, two blocks an SM) and reads
//     each 16-dim A fragment by ldmatrix as the Q.K^T loop needs it, once a
//     kv tile: 16 more ldmatrix a warp and tile against 32 for K, and the
//     64 registers go to the accumulator.  The alternatives were an output
//     split over two warps that share each score tile (the scores computed
//     twice, or passed through shared memory) and 8 query rows a warp (half
//     of each m16 product wasted); both cost more than the reloads.  At
//     paligemma's ERA shape (B=8, S=256, H=8, KV=1, non-causal) the work is
//     4.3 GFLOP against 18.9 MB, 0.0056 ms at 3.35 TB/s against 0.0043 ms
//     at the bf16 peak: bytes bound it, as at hd 128.
//
//  8. For training, a non-null `lse` takes each row's m * mul + log2(l)
//     (base 2, the units the kernel's exp2 works in), or +inf for a row
//     with no valid key, written once after the loop; the backward
//     recomputes P from it.  It is a separate instance (LSE true) of every
//     pair, all of which the backward has: serving calls pass null and
//     launch the instances as they were, register for register.
//
// Numbers.  Scores are accumulated in f32; the softmax uses exp2f with the
// scale folded in by log2(e) (CUDA's exp2f: at most 2 ulp, far inside the
// 2^-7 relative tolerance the output is held to); the softcap uses the
// full-precision tanhf.  P is rounded to bf16 before P.V, as before; the
// row sum l adds the unrounded p.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per kv tile
constexpr int NWARPS = BQ / 16; // one warp per 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int MIN_BLOCKS = 3;   // blocks an SM must hold: <= 168 registers
// the (192,128) instance keeps 48 registers of Q fragments a thread more
// than (128,128), and (256,256) 64 more accumulators: two blocks an SM
// (<= 255 registers) keep them from spilling
constexpr int MIN_BLOCKS_WIDE = 2;
static_assert(2 * BK <= NTHREADS, "one thread a kv_pos and a kv_mask entry");

struct Params {
  const bf16* q;       // (B, Sq, H, hd)
  const bf16* k;       // (B, Sk, KV, hd)
  const bf16* v;       // (B, Sk, KV, hd_v)
  bf16* o;             // (B, Sq, H, hd_v)
  const int* q_pos;    // (Sq,)
  const int* kv_pos;   // (Sk,), < 0 = invalid slot
  const int* kv_mask;  // (B, Sk), 0 = masked key; may be null
  float* lse;          // (B, H, Sq) log2-sum-exp2 of each row; may be null
  int B, H, KV, Sq, Sk;
  float scale, softcap;
  int window, causal, protected_;
};

// Shared memory: the K0 V0 K1 V1 tiles (bf16, pitches LDK and LDV; Q is
// staged from stage 1 on before the loop, or kept in a buffer of its own
// after them where it is read each tile (QSMEM), the output in stage 0
// after the loop),
// the two tiles' kv_pos and kv_mask entries, the block's q positions and
// their min/max, then two bitmasks over the kv tiles (live, full), sized at
// launch.
template <int HD, int HDV>
struct Smem {
  // Q read from shared memory in the kv loop, not held in registers
  static constexpr bool QSMEM = HD > 192;
  static constexpr int LDK = HD + 8;
  static constexpr int LDV = HDV + 8;
  static constexpr size_t ktile = size_t(BK) * LDK * 2;
  static constexpr size_t stage = ktile + size_t(BK) * LDV * 2;
  static constexpr size_t qbytes = size_t(BQ) * LDK * 2;
  static constexpr size_t q_off = 2 * stage;  // Q's own buffer (QSMEM)
  static constexpr size_t kv_bytes =
      QSMEM ? q_off + qbytes : stage + (qbytes > stage ? qbytes : stage);
  static_assert(size_t(BQ) * LDV * 2 <= kv_bytes, "the output stages in the tiles");
  static constexpr size_t kp_off = kv_bytes;
  static constexpr size_t km_off = kp_off + 2 * BK * 4;
  static constexpr size_t qp_off = km_off + 2 * BK * 4;
  static constexpr size_t red_off = qp_off + BQ * 4;
  static constexpr size_t bits_off = red_off + 2 * NWARPS * 4;
  static size_t bytes(int nk) { return bits_off + 2 * size_t((nk + 31) / 32) * 4; }
};

// LSE: also write each row's log-sum-exp for the backward (training); the
// serving instances (LSE false) compile exactly as without it.  At hd 128
// the LSE instance keeps m past the loop, one value more than 168
// registers hold: it takes the wide budget (two blocks an SM) rather than
// spill
template <int HD, int HDV, bool LSE>
__global__ void __launch_bounds__(
    NTHREADS, HD > 128 || (LSE && HD == 128) ? MIN_BLOCKS_WIDE : MIN_BLOCKS)
    flash_fwd_kernel(const Params p) {
  using L = Smem<HD, HDV>;
  constexpr bool QSMEM = L::QSMEM;
  constexpr int LDK = L::LDK;
  constexpr int LDV = L::LDV;
  constexpr int VPR = HD / 8;    // 16-byte vectors per Q / K row
  constexpr int VPRV = HDV / 8;  // and per V / output row
  extern __shared__ __align__(128) unsigned char smem[];
  // stage s: K, then V (offsets, not a pointer array, so a run-time stage
  // index stays in registers)
  auto k_tile = [&](int s) { return reinterpret_cast<bf16*>(smem + s * L::stage); };
  auto v_tile = [&](int s) { return reinterpret_cast<bf16*>(smem + s * L::stage + L::ktile); };
  int* Kp = reinterpret_cast<int*>(smem + L::kp_off);  // [2][BK] kv_pos
  int* Km = reinterpret_cast<int*>(smem + L::km_off);  // [2][BK] kv_mask
  int* Qp = reinterpret_cast<int*>(smem + L::qp_off);  // [BQ] q_pos
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

  // element strides between rows and offsets of this (b, h) / (b, kvh);
  // few values are kept live through the kv loop, to leave registers to
  // the products
  const int q_stride = p.H * HD;
  const int kv_stride = p.KV * HD;
  const long q_off = (long(b) * p.Sq * p.H + h) * HD;
  const long kv_off = (long(b) * p.Sk * p.KV + kvh) * HD;
  const long v_off = (long(b) * p.Sk * p.KV + kvh) * HDV;
  const long mask_off = long(b) * p.Sk;
  const bool masked = p.kv_mask != nullptr;

  // Q from the second stage's K buffer on (or its own buffer); rows past
  // Sq are zeros
  bf16* Qs = QSMEM ? reinterpret_cast<bf16*>(smem + L::q_off) : k_tile(1);
  for (int idx = tid; idx < BQ * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    const bool in = q0 + r < p.Sq;
    cp_async16(Qs + r * LDK + c, p.q + (in ? q_off + long(q0 + r) * q_stride + c : 0), in);
  }
  cp_async_commit();

  // the block's q-position range, then the live / full bitmask of kv tiles
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
    for (int w = tid; w < 2 * nwords; w += NTHREADS) live[w] = 0u;
  }
  __syncthreads();
  int min_qp = red[0], max_qp = red[NWARPS];
  for (int w = 1; w < NWARPS; ++w) {
    min_qp = min(min_qp, red[w]);
    max_qp = max(max_qp, red[NWARPS + w]);
  }
  for (int t = warp; t < nk; t += NWARPS) {
    bool any = false, all = true;
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {
      const int j = t * BK + c * 32 + lane;
      int kp = -1;
      if (j < p.Sk) {
        kp = p.kv_pos[j];
        if (masked && p.kv_mask[mask_off + j] == 0) kp = -1;
      }
      // some row may see the key / every row sees it
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
      any = any || some;
      all = all && every;
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) {
      if (any) atomicOr(&live[t >> 5], 1u << (t & 31));
      if (all) atomicOr(&live[nwords + (t >> 5)], 1u << (t & 31));
    }
  }
  __syncthreads();

  // issue the cp.async copies of kv tile t into stage s: K, V, and the
  // tile's kv_pos and kv_mask entries (keys past Sk are zero-filled).  The
  // copy loop is not unrolled: its addresses would hold registers that the
  // products need.
  auto load_tile = [&](int t, int s) {
    const int k0 = t * BK;
#pragma unroll 1
    for (int idx = tid; idx < BK * VPR; idx += NTHREADS) {
      const int r = idx / VPR, c = (idx % VPR) * 8;
      const bool in = k0 + r < p.Sk;
      const long off = in ? kv_off + long(k0 + r) * kv_stride + c : 0;
      cp_async16(k_tile(s) + r * LDK + c, p.k + off, in);
      if (HDV == HD) cp_async16(v_tile(s) + r * LDV + c, p.v + off, in);
    }
    if (HDV != HD) {
#pragma unroll 1
      for (int idx = tid; idx < BK * VPRV; idx += NTHREADS) {
        const int r = idx / VPRV, c = (idx % VPRV) * 8;
        const bool in = k0 + r < p.Sk;
        const long off = in ? v_off + long(k0 + r) * p.KV * HDV + c : 0;
        cp_async16(v_tile(s) + r * LDV + c, p.v + off, in);
      }
    }
    const int j = k0 + (tid % BK);
    const bool in = j < p.Sk;
    if (tid < BK) cp_async4(Kp + s * BK + tid, p.kv_pos + (in ? j : 0), in);
    else if (tid < 2 * BK && masked)
      cp_async4(Km + s * BK + tid - BK, p.kv_mask + (in ? mask_off + j : 0), in);
  };

  int cur = next_tile(live, 0, nk);
  if (cur < nk) {
    load_tile(cur, 0);
    cp_async_commit();
    cp_async_wait<1>();  // Q has landed
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // this warp's Q rows as A fragments, kept for the whole loop (QSMEM:
  // one fragment, read from shared memory for each 16-dim step of a tile)
  const int row0 = warp * 16;
  const bf16* q_row = Qs + (row0 + (lane & 15)) * LDK + (lane >> 4) * 8;
  uint32_t qf[QSMEM ? 1 : HD / 16][4];
  if constexpr (!QSMEM) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], q_row + kk * 16);
  }
  __syncthreads();  // Q's buffer is the first prefetch's target

  // this thread's rows: g and g + 8 of the warp's 16; columns 2*t4, +1 of
  // each 8-wide block
  const int g = lane >> 2, t4 = lane & 3;
  const bool capped = p.softcap > 0.f;
  // p = exp2(x * mul - m * mul), x the (capped) score; raw scores are
  // unscaled, so without a cap the scale folds into mul
  const float mul = capped ? LOG2E : p.scale * LOG2E;
  const float cap_in = capped ? p.scale / p.softcap : 0.f;

  float o[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

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
    __syncthreads();  // tile `cur` is in stage `stage` for every thread

    const bf16* Kt = k_tile(stage);
    const bf16* Vt = v_tile(stage);

    // S = Q K^T, 16 x BK a warp, in registers
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      if constexpr (QSMEM) ldsm_x4(qf[0], q_row + kk * 16);
      const uint32_t(&qa)[4] = qf[QSMEM ? 0 : kk];
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, Kt + (jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * LDK + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
      }
    }

    // softcap, mask, online softmax; element e of s[j]: row g + 8*(e/2),
    // key 8j + 2*t4 + e%2
    if (capped) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = p.softcap * tanhf(s[j][e] * cap_in);
    }
    const bool is_full = (live[nwords + (cur >> 5)] >> (cur & 31)) & 1u;
    if (!is_full) {
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
          const int key = (e & 1) ? kp.y : kp.x;
          if (!key_valid(key, Qp[row0 + g + 8 * (e >> 1)], p)) s[j][e] = NEG_INF;
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = quad_max(mx);
      // no valid key yet: subtract 0, so masked scores give exp2(-huge) = 0
      const float base = mx > NEG_INF / 2 ? mx * mul : 0.f;
      alpha[r] = exp2f(m_run[r] * mul - base);
      m_run[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * r] = exp2f(fmaf(s[j][2 * r], mul, -base));
        s[j][2 * r + 1] = exp2f(fmaf(s[j][2 * r + 1], mul, -base));
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_run[r] = l_run[r] * alpha[r] + sum;  // this thread's columns only
    }
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HDV / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vt + (kk * 16 + (lane & 15)) * LDV + np * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }

    __syncthreads();  // the next iteration's prefetch overwrites stage `stage`
    cur = nxt;
    stage ^= 1;
  }

  // O / l as bf16, staged in the first stage's buffers (free after the
  // loop's last barrier), then written in 16-byte rows; for the backward,
  // each row's m * mul + log2(l) (so p = exp2(x * mul - lse)), +inf for a
  // row with no valid key (every p of the row is then 0)
  bf16* Os = k_tile(0) + row0 * LDV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    if constexpr (LSE) {
      // indices and mul re-derived here, not kept live through the loop
      const int qi = (gridDim.x - 1 - blockIdx.x) * BQ + row0 + g + 8 * r;
      const float mul_l = p.softcap > 0.f ? LOG2E : p.scale * LOG2E;
      if (t4 == 0 && qi < p.Sq)
        p.lse[long(blockIdx.y) * p.Sq + qi] =
            l > 0.f ? fmaf(m_run[r], mul_l, log2f(l)) : pos_inf();
    }
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8 * r) * LDV + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
  __syncwarp();
  const long o_off = (long(b) * p.Sq * p.H + h) * HDV;
  for (int idx = lane; idx < 16 * VPRV; idx += 32) {
    const int r = idx / VPRV, c = (idx % VPRV) * 8;
    const int qi = q0 + row0 + r;
    if (qi < p.Sq)
      *reinterpret_cast<uint4*>(p.o + o_off + long(qi) * p.H * HDV + c) =
          *reinterpret_cast<const uint4*>(Os + r * LDV + c);
  }
}

constexpr int MAX_DEVICES = 64;

// Raise the instance's dynamic shared-memory cap to the card's opt-in
// maximum, once per card (a launch still asks only for what its Sk needs).
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
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<HD, HDV, LSE>();
  if (err != cudaSuccess) return err;
  const int nk = (p.Sk + BK - 1) / BK;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<HD, HDV, LSE><<<grid, NTHREADS, Smem<HD, HDV>::bytes(nk), stream>>>(p);
  return cudaGetLastError();
}

template <int HD, int HDV>
int blocks_per_sm(int Sk) {
  int blocks = -1;
  if (allow_smem<HD, HDV, false>() != cudaSuccess) return -1;
  const size_t bytes = Smem<HD, HDV>::bytes((Sk + BK - 1) / BK);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_kernel<HD, HDV, false>,
                                                    NTHREADS, bytes) != cudaSuccess)
    return -1;
  return blocks;
}

// the head-dim pairs (q/k, v) with an instance; each also has an LSE
// instance, which the backward (flash_attention_bwd.cu) reads
#define FLASH_INSTANCES(X) X(32, 32) X(64, 64) X(128, 128) X(192, 128) X(256, 256)
#define FLASH_LSE_INSTANCES(X) FLASH_INSTANCES(X)

}  // namespace

// Plain C entry point (bound with ctypes).  Returns a cudaError_t: 0 on a
// successful launch.  The launch is asynchronous on `stream`.  `lse` (B, H,
// Sq) float32 takes each row's log-sum-exp for the backward
// (flash_attention_bwd.cu); serving calls pass null.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* q_pos, const int* kv_pos, const int* kv_mask,
    int B, int H, int KV, int Sq, int Sk, int hd, int hd_v,
    float scale, float softcap, int window, int causal, int protected_,
    float* lse, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
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
  if (hd == D && hd_v == DV) return int(launch<D, DV, false>(p, s));
    FLASH_INSTANCES(FLASH_LAUNCH)
#undef FLASH_LAUNCH
  } else {
#define FLASH_LAUNCH_LSE(D, DV) \
  if (hd == D && hd_v == DV) return int(launch<D, DV, true>(p, s));
    FLASH_LSE_INSTANCES(FLASH_LAUNCH_LSE)
#undef FLASH_LAUNCH_LSE
  }
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block for head dims (`hd`, `hd_v`) and `Sk`
// keys, or -1 for an unsupported pair.
extern "C" long long repro_flash_attention_smem_bytes(int hd, int hd_v, int Sk) {
  const int nk = (Sk + BK - 1) / BK;
#define FLASH_SMEM(D, DV) \
  if (hd == D && hd_v == DV) return (long long)Smem<D, DV>::bytes(nk);
  FLASH_INSTANCES(FLASH_SMEM)
#undef FLASH_SMEM
  return -1;
}

// Blocks of head dims (`hd`, `hd_v`) and `Sk` keys that one SM holds at
// once (the CUDA occupancy API, on the current card), or -1 on an error.
extern "C" int repro_flash_attention_blocks_per_sm(int hd, int hd_v, int Sk) {
#define FLASH_OCC(D, DV) \
  if (hd == D && hd_v == DV) return blocks_per_sm<D, DV>(Sk);
  FLASH_INSTANCES(FLASH_OCC)
#undef FLASH_OCC
  return -1;
}
