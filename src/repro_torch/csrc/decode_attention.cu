// Single-token GQA decode attention over a ring-buffer KV cache, for
// Hopper (sm_90a): bf16 inputs, f32 math.
//
// Replaces the TPU kernel repro.kernels.decode_attention._decode_kernel
// (src/repro/kernels/decode_attention.py:23, pallas_call at :103).  What it
// computes is the same: one query token per sequence, at the absolute
// position *q_pos (read from device memory, as the TPU kernel reads its
// qpos_ref), attends over every cache slot; query head h reads kv head
// h / G (G = H / KV); a slot is valid where kv_pos >= 0, kv_pos <= q_pos
// and, with a window, kv_pos > q_pos - window or kv_pos < protected
// (attention sinks); scale hd^-0.5; online softmax with f32 state; a query
// with no valid slot gives exact zeros.  A non-causal mode (causal = 0)
// drops kv_pos <= q_pos: whisper's decoder attends from one query over
// all of the encoder's keys (positions 0..F-1, most past the query's),
// the TPU kernel's function with its causal predicate left out, as the
// reference's cross-attention leaves it out.  Empty slots (-1) may sit anywhere
// in a wrapped ring, so validity is read from kv_pos, never inferred from
// slot numbers.
//
// Bound.  The function needs K and V of the valid slots (2*B*V*KV*hd bf16)
// plus q, out and kv_pos, and 4*B*H*V*hd flops: about G flops a byte, far
// below the H100's ridge, so bytes bound it.  At the AR path's shapes (B =
// 8, KV = 2, hd = 128, 1024 slots) that is 4.2 MB, about 1.27 us at 3.35
// TB/s, with the cache half full, and twice that when it is full.  At this
// size what keeps a kernel from that bound is latency: the time is the
// number of round trips a block waits on, one after another (to device
// memory, and across the blocks that share a group), plus the launch.
//
// Design.  The G query heads that share a kv head are processed together,
// so each K/V slot is read from device memory once per group (G <= 8, as in
// every model config of the repo; a larger G is cut into 8-head chunks,
// each of which reads the group's slots once).
//  1. One launch.  The slots of one (b, kv head) group are split over the C
//     blocks of a thread-block cluster (C = 8 at the AR shape: 16 groups x
//     8 = 128 blocks on 132 SMs, one wave; 4 and 16 measured slower,
//     PERF.md).  Each block merges its warps' softmax states in shared
//     memory.  Block c of the cluster combines a 1/C slice of the group's
//     output: every block stores its (m, l) into each block's shared memory
//     and each element of its state into the shared memory of the block
//     that combines it (16-byte distributed-shared-memory stores, which
//     nothing waits on); after one cluster barrier each block combines its
//     slice from its own shared memory and writes it.  No partial goes
//     through device memory and no second kernel runs.  A cluster was
//     chosen over a "last block combines" atomic: the merge costs one
//     barrier and no round trip to device memory, and no counter has to be
//     reset between launches.  Stores are pushed rather than the states
//     pulled after the barrier, since a pull waits on C remote reads a
//     thread and needs a second barrier before a block may exit.  Where
//     B*KV alone fills the card the cluster is one block.
//  2. All copies in flight at once.  A warp first reads q_pos and the
//     kv_pos entries of its slots (one round trip), decides each row's
//     validity, then issues the cp.async copies of all its valid tiles into
//     its own ring of up to 4 stages (at the AR shape a warp has at most 2
//     tiles, so every copy is issued before the first wait) and computes on
//     each tile as it lands.  A warp waits about two memory latencies.
//  3. Only valid rows read.  Validity is decided from kv_pos before any
//     copy: a 16-slot tile with no valid row is never loaded or computed
//     (warp vote), an invalid row of a live tile is zero-filled by cp.async
//     without a global read.  Tiles are dealt to the cluster's blocks and
//     the blocks' warps round robin (tile t to block t % C), so a half-full
//     cache or a window still gives every block and warp its share.  A
//     block with no valid slot stores m = -inf, l = 0 for the merge and
//     nothing else.
//  4. State in registers.  Each warp owns its tiles and its own (m, l,
//     acc).  The products are mma.sync m16n8k16 bf16 with f32 accumulators,
//     transposed so that the heads are the mma's N = 8 and nothing is
//     padded to 16: S^T = K Q^T (K tile by ldmatrix as A, Q^T's fragments
//     in registers for the whole kernel) and O^T = V^T P^T (V^T by
//     ldmatrix.trans as A, P^T as B after movmatrix transposes the score
//     fragments in registers): 24 products a 16-slot tile at hd=128.  The
//     scores, the online softmax and the output accumulator stay in
//     registers.  P is split into a bf16 high part and a bf16 remainder,
//     both multiplied by V, so P.V keeps ~16 bits of P (the plain version
//     keeps P in f32, and one bf16 P misses its tolerance near |o| ~ 0).
//  5. q_pos from device memory, so a captured CUDA graph can replay the
//     launch while the position changes.
// The cache is read in its own layout (B, S, KV, hd): no transpose, and no
// padding of G or hd in memory (hd 32, 64, 128 and 256 are template
// instances; G is a run-time value).  At hd 256 (paligemma's MQA heads,
// G = 8 in one chunk) Q^T's fragments take 32 registers a thread and
// O^T's accumulators 64, twice hd 128's; a warp's ring stage is 16.5 KB,
// so the wrapper gives a warp at most the stages that fit the block's
// 227 KB (2 at 4 warps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 16;        // cache slots a warp tile (mma M of Q.K^T)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int HEADS = 8;        // query heads a block (mma N)
constexpr int MAX_STAGES = 4;   // ring stages a warp
constexpr int MAX_CLUSTER = 16; // blocks a cluster (above 8: non-portable)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(MAX_CLUSTER * HEADS <= NTHREADS, "one (m, l) pair a thread in the merge");

struct Params {
  const bf16* q;       // (B, H, hd)
  const bf16* k;       // (B, S, KV, hd)
  const bf16* v;       // (B, S, KV, hd)
  bf16* o;             // (B, H, hd)
  const int* q_pos;    // (1,) on the device
  const int* kv_pos;   // (S,), < 0 = empty slot
  int B, H, KV, S, G;
  int MT;              // 8-head chunks of a group, ceil(G / 8)
  int stages;          // ring stages a warp
  int nloc;            // most tiles a block of the cluster holds
  int window, protected_;
  int causal;          // 0: no kv_pos <= q_pos (cross-attention)
  float scale;
};

// Shared memory: the validity masks of the block's tiles (one word a tile),
// the warps' K/V rings, the warps' partial states (m, l, acc), and the
// receive area into which each block of the cluster stores its (m, l) and
// the slice of its state that this block combines.
template <int HD>
struct Smem {
  static constexpr int LDB = HD + 8;   // bf16 pitch of a K / V row
  static constexpr int OPW = HD + 4;   // f32 pitch of a warp's partial output row
  static constexpr size_t stage = size_t(2) * TILE * LDB * 2;  // K and V
  static constexpr size_t part = size_t(NWARPS) * HEADS * (OPW + 2) * 4;
  // f32 elements of the chunk's output that one block combines, at most
  __host__ __device__ static int pitch(int C) { return ((HEADS * HD + C - 1) / C + 3) / 4 * 4; }
  __host__ __device__ static size_t ring_off(int nloc) {
    return (size_t(nloc) * 4 + 127) / 128 * 128;
  }
  __host__ __device__ static size_t part_off(int stages, int nloc) {
    return ring_off(nloc) + size_t(NWARPS) * stages * stage;
  }
  __host__ __device__ static size_t recv_off(int stages, int nloc) {
    return part_off(stages, nloc) + part;
  }
  __host__ __device__ static size_t bytes(int stages, int nloc, int C) {
    return recv_off(stages, nloc) + size_t(C) * (2 * HEADS + pitch(C)) * 4;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are pending (n < 4)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// the transpose of an 8x8 bf16 matrix held one row pair a thread, as the
// mma fragments hold it
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) as a bf16 pair `hi` and the pair of what rounding left, `lo`
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the cluster barrier in two halves: arrive (release, or relaxed) and wait
// (acquire); every thread of every block of the cluster takes part
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the address of `p` in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// max / sum over the 8 lanes that share lane % 4 (the slots of one head)
__device__ __forceinline__ float col_max(float x) {
  for (int o = 4; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float col_sum(float x) {
  for (int o = 4; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool slot_valid(int kp, int qp, const Params& p) {
  bool valid = kp >= 0 && (!p.causal || kp <= qp);
  if (p.window > 0) valid = valid && (kp > qp - p.window || kp < p.protected_);
  return valid;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) decode_attention_kernel(const Params p) {
  using L = Smem<HD>;
  constexpr int LDB = L::LDB;
  constexpr int OPW = L::OPW;
  constexpr int VPR = HD / 8;  // 16-byte vectors a row
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem);   // [nloc]
  bf16* rings = reinterpret_cast<bf16*>(smem + L::ring_off(p.nloc));

  // the first half of a cluster barrier: its wait, before the first store
  // into another block's shared memory, makes sure every block has started
  cluster_arrive_relaxed();
  const int C = gridDim.x;         // one cluster spans the x axis
  const int rank = blockIdx.x;     // the block's rank in its cluster
  const int grp = blockIdx.y;      // (b * KV + kvh) * MT + mt
  const int mt = grp % p.MT;
  const int b = grp / p.MT / p.KV;
  const int kvh = grp / p.MT % p.KV;
  const int hb = mt * HEADS;       // first head of this chunk in the group
  const int rows = min(HEADS, p.G - hb);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;

  const int ntiles = (p.S + TILE - 1) / TILE;
  const int nloc = (ntiles - rank + C - 1) / C;       // tiles of this block
  const int nw = (nloc - warp + NWARPS - 1) / NWARPS;  // tiles of this warp
  // this warp's k-th tile: local tile warp + NWARPS * k, cache tile
  // rank + C * (warp + NWARPS * k); its mask word is masks[warp + NWARPS*k]
  auto slot0 = [&](int k) { return (rank + C * (warp + NWARPS * k)) * TILE; };

  // one round trip: q_pos, this warp's kv_pos entries and Q^T's B
  // fragments (k = dims 2*t4, +1 and +8, +9 of the 16-dim step, n = head g)
  const int qp = *p.q_pos;
  const bf16* qg = p.q + (long(b) * p.H + long(kvh) * p.G + hb) * HD;
  uint32_t qb[HD / 16][2];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      qb[kk][e] = g < rows
          ? *reinterpret_cast<const uint32_t*>(qg + g * HD + kk * 16 + 2 * t4 + 8 * e) : 0u;
  // validity masks, two tiles a pass (lanes 0-15 and 16-31), four passes
  // a batch so that the loads of a batch are in flight together
  for (int k0 = 0; k0 < nw; k0 += 8) {
    int kp[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 2 * u + (lane >> 4);
      const int j = k < nw ? slot0(k) + (lane & 15) : p.S;
      kp[u] = j < p.S ? p.kv_pos[j] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t bits = __ballot_sync(0xffffffffu, slot_valid(kp[u], qp, p));
      const int k = k0 + 2 * u + (lane >> 4);
      if ((lane & 15) == 0 && k < nw) masks[warp + NWARPS * k] = (bits >> (lane & 16)) & 0xffffu;
    }
  }
  __syncwarp();

  const long kv_stride = long(p.KV) * HD;  // elements between slots
  const long kv_off = (long(b) * p.S * p.KV + kvh) * HD;
  const int NS = p.stages;
  bf16* ring = rings + size_t(warp) * NS * 2 * TILE * LDB;

  auto next_valid = [&](int k) {
    while (k < nw && masks[warp + NWARPS * k] == 0u) ++k;
    return k;
  };
  // cp.async copies of the warp's k-th tile into stage s: valid rows are
  // read, invalid rows zero-filled without a read
  auto load_tile = [&](int k, int s) {
    const uint32_t mk = masks[warp + NWARPS * k];
    const long row0 = kv_off + long(slot0(k)) * kv_stride;
    bf16* Kd = ring + size_t(s) * 2 * TILE * LDB;
    bf16* Vd = Kd + TILE * LDB;
#pragma unroll
    for (int u = 0; u < TILE * VPR / 32; ++u) {
      const int idx = lane + 32 * u;
      const int r = idx / VPR, c = (idx % VPR) * 8;
      const bool in = (mk >> r) & 1u;
      const long off = in ? row0 + r * kv_stride + c : 0;
      cp_async16(Kd + r * LDB + c, p.k + off, in);
      cp_async16(Vd + r * LDB + c, p.v + off, in);
    }
  };

  // O^T (hd x 8 heads) in registers: o[n] holds dims 16n + g (elements 0,
  // 1) and 16n + g + 8 (2, 3) of heads 2*t4 (0, 2) and 2*t4 + 1 (1, 3)
  float o[HD / 16][4];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};  // heads 2*t4, +1; log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's slots only
  const float mul = p.scale * LOG2E;

  // every valid tile's copies issued before the first wait, up to NS
  int kc = next_valid(0);  // tile to compute
  int kn = kc;             // tile to copy
  for (int s = 0; s < NS; ++s) {
    if (kn < nw) {
      load_tile(kn, s);
      kn = next_valid(kn + 1);
    }
    cp_async_commit();
  }
  int stage = 0;
  while (kc < nw) {
    cp_async_wait(NS - 1);
    __syncwarp();  // every lane's copies of tile kc have landed
    const bf16* Kt = ring + size_t(stage) * 2 * TILE * LDB;
    const bf16* Vt = Kt + TILE * LDB;
    const uint32_t mk = masks[warp + NWARPS * kc];

    // S^T = K Q^T: 16 slots x 8 heads, two chains of hd/32 products
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4];
      ldsm_x4(ka, Kt + (lane & 15) * LDB + kk * 16 + (lane >> 4) * 8);
      mma_bf16(kk & 1 ? s2 : s, ka, qb[kk][0], qb[kk][1]);
    }
    // element e: slot g + 8*(e/2), head 2*t4 + e%2; online softmax over
    // the slots of each head (the tile has a valid slot: the max is finite)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = (mk >> (g + 8 * (e >> 1))) & 1u ? (s[e] + s2[e]) * mul : NEG_INF;
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float mx = fmaxf(m_run[j], col_max(fmaxf(s[j], s[2 + j])));
      alpha[j] = exp2f(m_run[j] - mx);
      m_run[j] = mx;
      s[j] = exp2f(s[j] - mx);
      s[2 + j] = exp2f(s[2 + j] - mx);
      l_run[j] = l_run[j] * alpha[j] + s[j] + s[2 + j];
    }
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[1];
      o[n][2] *= alpha[0];
      o[n][3] *= alpha[1];
    }
    // P^T as B fragments: P = hi + lo in bf16, each 8-slot half transposed
    // in registers
    uint32_t h0, l0, h1, l1;
    split_bf16(s[0], s[1], h0, l0);
    split_bf16(s[2], s[3], h1, l1);
    const uint32_t bh0 = movmatrix_trans(h0), bh1 = movmatrix_trans(h1);
    const uint32_t bl0 = movmatrix_trans(l0), bl1 = movmatrix_trans(l1);
    // O^T += V^T P^T: V^T's A fragments by ldmatrix.trans from the V rows
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t va[4];
      ldsm_x4_trans(va, Vt + ((lane & 7) + ((lane >> 4) << 3)) * LDB + n * 16 +
                           ((lane >> 3) & 1) * 8);
      mma_bf16(o[n], va, bh0, bh1);
      mma_bf16(o[n], va, bl0, bl1);
    }

    __syncwarp();  // every lane is done with this stage before its refill
    if (kn < nw) {
      load_tile(kn, stage);
      kn = next_valid(kn + 1);
    }
    cp_async_commit();
    kc = next_valid(kc + 1);
    stage = stage + 1 == NS ? 0 : stage + 1;
  }
  cp_async_wait(0);

  // the block's state: the warps' (m, l, acc) into shared memory, merged
  float* Ow = reinterpret_cast<float*>(smem + L::part_off(NS, p.nloc));  // [NWARPS][HEADS][OPW]
  float* Mw = Ow + NWARPS * HEADS * OPW;                                 // [NWARPS][HEADS]
  float* Lw = Mw + NWARPS * HEADS;                                       // [NWARPS][HEADS]
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float l = col_sum(l_run[j]);
    if (g == 0) {
      Mw[warp * HEADS + 2 * t4 + j] = m_run[j];
      Lw[warp * HEADS + 2 * t4 + j] = l;
    }
  }
  {
    float* ow = Ow + (warp * HEADS + 2 * t4) * OPW + g;
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      ow[16 * n] = o[n][0];
      ow[OPW + 16 * n] = o[n][1];
      ow[16 * n + 8] = o[n][2];
      ow[OPW + 16 * n + 8] = o[n][3];
    }
  }
  __syncthreads();

  // the cluster's merge.  Block c combines elements [c*per, (c+1)*per) of
  // the chunk's rows x hd output.  Each block stores its (m, l) into every
  // block's receive area and each element of its merged state into the
  // area of the block that combines it (16-byte stores into another SM's
  // shared memory, which nothing waits on); one cluster barrier later each
  // block combines its slice from its own shared memory.
  const int pitch = L::pitch(C);
  float* Rm = reinterpret_cast<float*>(smem + L::recv_off(NS, p.nloc));  // [C][HEADS]
  float* Rl = Rm + C * HEADS;                                          // [C][HEADS]
  float* Ra = Rl + C * HEADS;                                          // [C][pitch]
  const int total = rows * HD;
  const int per = ((total + C - 1) / C + 3) / 4 * 4;
  cluster_wait();  // every block of the cluster has started
  // the block's (m, l) of each head into every block: one pair a thread
  if (tid < C * rows) {
    const int head = tid % rows, c = tid / rows;
    float mw[NWARPS], m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      mw[w] = Mw[w * HEADS + head];
      m = fmaxf(m, mw[w]);
    }
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      if (mw[w] > NEG_INF / 2) l += exp2f(mw[w] - m) * Lw[w * HEADS + head];
    st_cluster(cluster_addr(Rm + rank * HEADS + head, c), m);
    st_cluster(cluster_addr(Rl + rank * HEADS + head, c), l);
  }
  // the block's merged output, four elements a thread, into the block
  // that combines them
  for (int e = 4 * tid; e < total; e += 4 * NTHREADS) {
    const int head = e / HD, d = e % HD;
    float mw[NWARPS], m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      mw[w] = Mw[w * HEADS + head];
      m = fmaxf(m, mw[w]);
    }
    if (m <= NEG_INF / 2) continue;  // a block with no valid slot sends no output
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      if (mw[w] > NEG_INF / 2) {  // a warp with no valid slot adds nothing
        const float wt = exp2f(mw[w] - m);
        const float4 ow = *reinterpret_cast<const float4*>(Ow + (w * HEADS + head) * OPW + d);
        acc.x += wt * ow.x;
        acc.y += wt * ow.y;
        acc.z += wt * ow.z;
        acc.w += wt * ow.w;
      }
    }
    const int c = e / per;
    st_cluster(cluster_addr(Ra + rank * pitch + e - c * per, c), acc);
  }
  cluster_arrive();  // release: this block's stores
  cluster_wait();    // acquire: every block's stores into this one

  // this block's slice: each source block weighed by exp2(m_c - max) in
  // its head; the loops run to MAX_CLUSTER so that their loads are issued
  // together
  bf16* og = p.o + (long(b) * p.H + long(kvh) * p.G + hb) * HD;
  const int e0 = rank * per;
  const int e1 = min(total, e0 + per);
  for (int e = e0 + 4 * tid; e < e1; e += 4 * NTHREADS) {
    const int head = e / HD;
    float wc[MAX_CLUSTER], m = NEG_INF;
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      wc[c] = c < C ? Rm[c * HEADS + head] : NEG_INF;
      m = fmaxf(m, wc[c]);
    }
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c >= C) break;
      const float wt = wc[c] > NEG_INF / 2 ? exp2f(wc[c] - m) : 0.f;
      const float lc = Rl[c * HEADS + head];
      const float4 a = *reinterpret_cast<const float4*>(Ra + c * pitch + e - e0);
      if (wt != 0.f) {  // a source with no valid slot left no output here
        l += wt * lc;
        acc.x += wt * a.x;
        acc.y += wt * a.y;
        acc.z += wt * a.z;
        acc.w += wt * a.w;
      }
    }
    const float inv = l > 0.f ? 1.f / l : 0.f;  // no valid slot: zeros
    acc.x *= inv;
    acc.y *= inv;
    acc.z *= inv;
    acc.w *= inv;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(og + e) = packed;
  }
}

constexpr int MAX_DEVICES = 64;

// Raise the instance's dynamic shared-memory cap to the card's opt-in
// maximum and allow clusters above 8 blocks, once per card.
template <int HD>
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
  err = cudaFuncSetAttribute(decode_attention_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(decode_attention_kernel<HD>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done[dev] = 1;
  return err;
}

template <int HD>
cudaError_t launch(const Params& p, int cluster, cudaStream_t stream) {
  cudaError_t err = prepare<HD>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, p.B * p.KV * p.MT);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = Smem<HD>::bytes(p.stages, p.nloc, cluster);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<HD>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
int blocks_per_sm(long long bytes) {
  int blocks = -1;
  if (prepare<HD>() != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, decode_attention_kernel<HD>,
                                                    NTHREADS, size_t(bytes)) != cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// Shared memory one block needs, in bytes, for a ring of `stages` stages a
// warp, at most `nloc` tiles a block and `cluster` blocks a cluster (the
// wrapper checks it against the card's limit before launching); -1 for an
// unsupported head dim.
extern "C" long long repro_decode_attention_smem_bytes(int hd, int stages, int nloc,
                                                       int cluster) {
  switch (hd) {
    case 32: return (long long)Smem<32>::bytes(stages, nloc, cluster);
    case 64: return (long long)Smem<64>::bytes(stages, nloc, cluster);
    case 128: return (long long)Smem<128>::bytes(stages, nloc, cluster);
    case 256: return (long long)Smem<256>::bytes(stages, nloc, cluster);
    default: return -1;
  }
}

// Blocks of the hd instance that one SM holds at `bytes` of shared memory.
extern "C" int repro_decode_attention_blocks_per_sm(int hd, long long bytes) {
  switch (hd) {
    case 32: return blocks_per_sm<32>(bytes);
    case 64: return blocks_per_sm<64>(bytes);
    case 128: return blocks_per_sm<128>(bytes);
    case 256: return blocks_per_sm<256>(bytes);
    default: return -1;
  }
}

// Plain C entry point (bound with ctypes).  q_pos points to one int32 on
// the device.  `cluster` blocks (1..16) split each group's slots; `stages`
// (1..4) is the ring depth a warp; `causal` 0 drops kv_pos <= q_pos.
// Returns a cudaError_t: 0 on a successful launch, which is asynchronous
// on `stream`.
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* q_pos,
    const int* kv_pos, int B, int H, int KV, int S, int hd, int cluster, int stages,
    int window, int protected_, int causal, float scale, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || stages < 1 || stages > MAX_STAGES ||
      KV < 1 || H % KV != 0 || S < 1)
    return int(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.q_pos = q_pos;
  p.kv_pos = kv_pos;
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.G = H / KV;
  p.MT = (p.G + HEADS - 1) / HEADS;
  p.stages = stages;
  p.nloc = ((S + TILE - 1) / TILE + cluster - 1) / cluster;
  p.window = window;
  p.protected_ = protected_;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return int(launch<32>(p, cluster, s));
    case 64: return int(launch<64>(p, cluster, s));
    case 128: return int(launch<128>(p, cluster, s));
    case 256: return int(launch<256>(p, cluster, s));
    default: return int(cudaErrorInvalidValue);
  }
}
