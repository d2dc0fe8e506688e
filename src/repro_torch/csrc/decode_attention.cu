// Single-token GQA decode attention over a ring-buffer KV cache, for
// Hopper (sm_90a): bf16 inputs, f32 math.
//
// Replaces the TPU kernel repro.kernels.decode_attention._decode_kernel.
// What it computes is the same: one query token per sequence attends over
// every cache slot, query head h reads kv head h / G (G = H / KV), a slot
// is valid where kv_pos >= 0, kv_pos <= q_pos and, with a window, kv_pos >
// q_pos - window or kv_pos < protected (attention sinks); scale hd^-0.5;
// online softmax with f32 state; a query with no valid slot gives zeros.
// Empty slots (-1) may sit anywhere in a wrapped ring, so every slot is
// tested and nothing stops early.
//
// Bound.  The function needs K and V of the V valid slots (2*B*V*KV*hd
// bf16) plus q, out and kv_pos, and 4*B*H*V*hd flops: about G flops a
// byte, far below the H100's ridge (~295 for bf16 tensor cores, ~20 for
// the float32 units this kernel uses), so memory bytes bound it.  At the
// AR path's shapes (B = 8, KV = 2, hd = 128, 1024 slots) that is 4.2 MB,
// about 1.27 us at 3.35 TB/s, with the cache half full, and twice that
// when it is full.  The kernel stages every slot's K/V: its time on the
// H100 is set by each block's serial chain over its tile (stage, scores,
// softmax, P.V), not by bytes, and reading only the valid slots' K/V
// does not shorten that chain.
//
// Design.  The TPU kernel's one idea is kept: the G query heads that share
// a kv head are processed together, so each K/V slot is read from device
// memory once per group, not G times.  One block of B*KV such groups would
// give only 16 blocks at B = 8 on 132 SMs, so the slots are split across
// blocks (flash-decoding): block (split, b*KV + kvh) stages 64-slot K/V
// tiles of its share into shared memory with 16-byte loads, computes the
// G x 64 scores from there, runs the online softmax with its (m, l, acc)
// state in shared memory, and writes its partial (m, l, acc).  A second,
// small kernel combines the partials of every split.  With one split the
// first kernel writes the normalized output itself.  The cache is read in
// its own layout (B, S, KV, hd): no transpose, and no padding of G or hd
// (hd 32, 64 and 128 are template instances; G is a run-time value).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 64;        // cache slots per staged tile
constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -1e30f;

struct Params {
  const bf16* q;       // (B, H, hd)
  const bf16* k;       // (B, S, KV, hd)
  const bf16* v;       // (B, S, KV, hd)
  bf16* o;             // (B, H, hd)
  const int* kv_pos;   // (S,), < 0 = empty slot
  float* part_acc;     // (nsplit, B*KV, G, hd) when nsplit > 1
  float* part_ml;      // (nsplit, B*KV, G, 2) when nsplit > 1
  int B, H, KV, S, G;
  int nsplit, chunk;   // slots [split*chunk, min(S, (split+1)*chunk))
  int q_pos, window, protected_;
  float scale;
};

// Shared-memory layout; regions start on 16-byte boundaries.
template <int HD>
struct Smem {
  static constexpr int LDB = HD + 8;  // bf16 pitch of the K / V tiles
  __host__ __device__ static size_t q_off() { return 0; }
  __host__ __device__ static size_t k_off(int G) { return q_off() + size_t(G) * HD * 4; }
  __host__ __device__ static size_t v_off(int G) { return k_off(G) + size_t(TILE) * LDB * 2; }
  __host__ __device__ static size_t s_off(int G) { return v_off(G) + size_t(TILE) * LDB * 2; }
  __host__ __device__ static size_t o_off(int G) { return s_off(G) + size_t(G) * TILE * 4; }
  __host__ __device__ static size_t m_off(int G) { return o_off(G) + size_t(G) * HD * 4; }
  __host__ __device__ static size_t l_off(int G) { return m_off(G) + size_t(G) * 4; }
  __host__ __device__ static size_t a_off(int G) { return l_off(G) + size_t(G) * 4; }
  __host__ __device__ static size_t kp_off(int G) { return a_off(G) + size_t(G) * 4; }
  __host__ __device__ static size_t bytes(int G) { return kp_off(G) + size_t(TILE) * 4; }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool slot_valid(int kp, const Params& p) {
  bool valid = kp >= 0 && kp <= p.q_pos;
  if (p.window > 0) {
    bool in_w = kp > p.q_pos - p.window;
    if (p.protected_ > 0) in_w = in_w || kp < p.protected_;
    valid = valid && in_w;
  }
  return valid;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) decode_split_kernel(const Params p) {
  using L = Smem<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = p.G;
  float* Qs = reinterpret_cast<float*>(smem + L::q_off());
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off(G));
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off(G));
  float* Ss = reinterpret_cast<float*>(smem + L::s_off(G));
  float* Os = reinterpret_cast<float*>(smem + L::o_off(G));
  float* Ms = reinterpret_cast<float*>(smem + L::m_off(G));
  float* Ls = reinterpret_cast<float*>(smem + L::l_off(G));
  float* As = reinterpret_cast<float*>(smem + L::a_off(G));
  int* Kp = reinterpret_cast<int*>(smem + L::kp_off(G));

  const int split = blockIdx.x;
  const int bk = blockIdx.y;  // b * KV + kvh
  const int b = bk / p.KV;
  const int kvh = bk % p.KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the G query heads of this kv head are contiguous: heads kvh*G .. +G
  const bf16* qg = p.q + (long(b) * p.H + long(kvh) * G) * HD;
  const long kv_stride = long(p.KV) * HD;  // elements between slots
  const bf16* kg = p.k + (long(b) * p.S * p.KV + kvh) * HD;
  const bf16* vg = p.v + (long(b) * p.S * p.KV + kvh) * HD;

  for (int i = tid; i < G * HD; i += NTHREADS) {
    Qs[i] = __bfloat162float(qg[i]);
    Os[i] = 0.f;
  }
  for (int g = tid; g < G; g += NTHREADS) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }

  constexpr int VEC = 8;         // bf16 per 16-byte load
  constexpr int VPR = HD / VEC;  // 16-byte vectors per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int s_begin = split * p.chunk;
  const int s_end = min(p.S, s_begin + p.chunk);

  for (int t0 = s_begin; t0 < s_end; t0 += TILE) {
    __syncthreads();  // the previous tile is consumed; first pass: Q/O ready
    for (int idx = tid; idx < TILE * VPR; idx += NTHREADS) {
      const int r = idx / VPR, c = (idx % VPR) * VEC;
      uint4 kv = zero, vv = zero;
      if (t0 + r < s_end) {
        kv = *reinterpret_cast<const uint4*>(kg + (t0 + r) * kv_stride + c);
        vv = *reinterpret_cast<const uint4*>(vg + (t0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::LDB + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * L::LDB + c) = vv;
    }
    if (tid < TILE) {
      const int j = t0 + tid;
      Kp[tid] = (j < s_end && slot_valid(p.kv_pos[j], p)) ? 1 : 0;
    }
    __syncthreads();

    // scores: thread takes (g, j) pairs, j fastest, full dot over hd
    for (int i = tid; i < G * TILE; i += NTHREADS) {
      const int g = i / TILE, j = i % TILE;
      float s = NEG_INF;
      if (Kp[j]) {
        const float* qrow = Qs + g * HD;
        const bf16* krow = Ks + j * L::LDB;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < HD; c += VEC) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float4 qa = *reinterpret_cast<const float4*>(qrow + c);
          const float4 qb = *reinterpret_cast<const float4*>(qrow + c + 4);
          const float qv[VEC] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int u = 0; u < VEC / 2; ++u) {
            const float2 kf = __bfloat1622float2(k2[u]);
            acc = fmaf(qv[2 * u], kf.x, acc);
            acc = fmaf(qv[2 * u + 1], kf.y, acc);
          }
        }
        s = acc * p.scale;
      }
      Ss[g * TILE + j] = s;
    }
    __syncthreads();

    // online softmax, one head row per warp at a time
    for (int g = warp; g < G; g += NWARPS) {
      float s[TILE / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < TILE / 32; ++c) {
        s[c] = Ss[g * TILE + lane + 32 * c];
        mx = fmaxf(mx, s[c]);
      }
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < TILE / 32; ++c) {
        const float pr = s[c] > NEG_INF / 2 ? expf(s[c] - m_new) : 0.f;
        psum += pr;
        Ss[g * TILE + lane + 32 * c] = pr;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
        As[g] = alpha;
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + psum;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread owns column e of heads g = first, +step..
    {
      constexpr int STEP = NTHREADS / HD;  // 1, 2 or 4 heads apart
      const int e = tid % HD;
      for (int g = tid / HD; g < G; g += STEP) {
        float acc = Os[g * HD + e] * As[g];
        const float* prow = Ss + g * TILE;
#pragma unroll 4
        for (int j = 0; j < TILE; j += 4) {
          const float4 pr = *reinterpret_cast<const float4*>(prow + j);
          acc = fmaf(pr.x, __bfloat162float(Vs[j * L::LDB + e]), acc);
          acc = fmaf(pr.y, __bfloat162float(Vs[(j + 1) * L::LDB + e]), acc);
          acc = fmaf(pr.z, __bfloat162float(Vs[(j + 2) * L::LDB + e]), acc);
          acc = fmaf(pr.w, __bfloat162float(Vs[(j + 3) * L::LDB + e]), acc);
        }
        Os[g * HD + e] = acc;
      }
    }
  }
  __syncthreads();

  if (p.nsplit == 1) {
    bf16* og = p.o + (long(b) * p.H + long(kvh) * G) * HD;
    for (int i = tid; i < G * HD; i += NTHREADS) {
      const float l = Ls[i / HD];
      og[i] = __float2bfloat16(Os[i] / (l > 0.f ? l : 1.f));
    }
  } else {
    const long base = long(split) * p.B * p.KV + bk;
    float* pa = p.part_acc + base * G * HD;
    float* pml = p.part_ml + base * G * 2;
    for (int i = tid; i < G * HD; i += NTHREADS) pa[i] = Os[i];
    for (int g = tid; g < G; g += NTHREADS) {
      pml[2 * g] = Ms[g];
      pml[2 * g + 1] = Ls[g];
    }
  }
}

// Combine the splits' partial (m, l, acc): block (b*KV + kvh, g), one
// thread per output element; every thread weighs the splits itself (the
// partial m and l of one head are a few hundred bytes, read from cache).
template <int HD>
__global__ void __launch_bounds__(HD) decode_combine_kernel(const Params p) {
  const int bk = blockIdx.x;
  const int g = blockIdx.y;
  const int e = threadIdx.x;
  const int b = bk / p.KV;
  const int kvh = bk % p.KV;
  const int G = p.G;
  const long stride = long(p.B) * p.KV;  // partial rows between splits
  const float* ml = p.part_ml + (long(bk) * G + g) * 2;
  const float* acc_in = p.part_acc + (long(bk) * G + g) * HD + e;
  float m = NEG_INF;
  for (int s = 0; s < p.nsplit; ++s) m = fmaxf(m, ml[s * stride * G * 2]);
  float l = 0.f, acc = 0.f;
  if (m > NEG_INF / 2) {
#pragma unroll 4
    for (int s = 0; s < p.nsplit; ++s) {
      const float ms = ml[s * stride * G * 2];
      const float w = ms > NEG_INF / 2 ? expf(ms - m) : 0.f;
      l += w * ml[s * stride * G * 2 + 1];
      acc += w * acc_in[s * stride * G * HD];
    }
  }
  p.o[(long(b) * p.H + long(kvh) * G + g) * HD + e] =
      __float2bfloat16(acc / (l > 0.f ? l : 1.f));
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = Smem<HD>::bytes(p.G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  decode_split_kernel<HD><<<dim3(p.nsplit, p.B * p.KV), NTHREADS, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.nsplit == 1) return err;
  decode_combine_kernel<HD><<<dim3(p.B * p.KV, p.G), HD, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper checks it against
// the card's limit before launching).
extern "C" long long repro_decode_attention_smem_bytes(int hd, int G) {
  switch (hd) {
    case 32: return (long long)Smem<32>::bytes(G);
    case 64: return (long long)Smem<64>::bytes(G);
    case 128: return (long long)Smem<128>::bytes(G);
    default: return -1;
  }
}

// Plain C entry point (bound with ctypes).  Returns a cudaError_t: 0 on a
// successful launch.  The launches are asynchronous on `stream`.
extern "C" int repro_decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_pos,
    void* part_acc, void* part_ml,
    int B, int H, int KV, int S, int hd, int nsplit, int chunk,
    int q_pos, int window, int protected_, float scale, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.kv_pos = kv_pos;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.S = S;
  p.G = H / KV;
  p.nsplit = nsplit;
  p.chunk = chunk;
  p.q_pos = q_pos;
  p.window = window;
  p.protected_ = protected_;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return int(launch<32>(p, s));
    case 64: return int(launch<64>(p, s));
    case 128: return int(launch<128>(p, s));
    default: return int(cudaErrorInvalidValue);
  }
}
