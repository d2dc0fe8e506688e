// Flash attention forward for Hopper (sm_90a): bf16 inputs, f32 math.
//
// Replaces the TPU kernel repro.kernels.flash_attention._flash_kernel.
// What it computes is the same: online-softmax GQA attention in which query
// head h reads kv head h / (H / KV), masked by positions (kv_pos < 0 is an
// invalid key; causal, sliding-window and protected-sink predicates), an
// optional per-row kv_mask, an optional tanh softcap, and zeros for a row
// whose every key is masked.
//
// Design.  The TPU walks the kv axis as a sequential grid dimension and
// keeps (acc, m, l) in VMEM scratch between grid steps.  Here one thread
// block owns one (batch*head, 64-query tile) and loops over 64-key tiles
// itself, keeping the running state in shared memory, so nothing carries
// between blocks.  Each of the 4 warps owns 16 query rows end to end
// (scores, softmax, P.V), so after a kv tile is staged only warp-level
// synchronisation is needed.  Q.K^T and P.V run on the tensor cores through
// WMMA 16x16x16 bf16 tiles with f32 accumulation; the softmax runs in f32
// on the scores, and P is rounded to bf16 for the P.V product (the one
// place the numbers differ from an all-f32 reference).  GQA is by index:
// kv heads are never replicated.  The kernel reads and writes the model
// layout (B, S, H, hd) directly, so there are no transpose copies.
//
// Bound.  At the sampling path's shapes (S = 256, hd = 128) the work is
// 4*B*H*S*S*hd flops against (2*B*S*H*hd + 2*B*S*KV*hd) * 2 bytes, about
// 220 flops a byte: below the H100's ~295 bf16 ridge, so memory bytes bound
// it.  This first version is the simple, correct one (WMMA through shared
// memory, no TMA or wgmma, no pipelining of the kv loads); its measured
// time stands beside the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int NWARPS = BQ / 16; // one warp per 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr int Q_PAD_POS = -1000000000;  // position of a query row past Sq

struct Params {
  const bf16* q;       // (B, Sq, H, hd)
  const bf16* k;       // (B, Sk, KV, hd)
  const bf16* v;       // (B, Sk, KV, hd)
  bf16* o;             // (B, Sq, H, hd)
  const int* q_pos;    // (Sq,)
  const int* kv_pos;   // (Sk,), < 0 = invalid slot
  const int* kv_mask;  // (B, Sk), 0 = masked key; may be null
  int B, H, KV, Sq, Sk;
  float scale, softcap;
  int window, causal, protected_;
};

// Shared-memory layout; every region starts on a 32-byte boundary and
// every WMMA tile pointer is 32-byte aligned (row pitches below keep
// 16-row offsets multiples of 32 bytes).
template <int HD>
struct Smem {
  static constexpr int LDB = HD + 8;  // bf16 pitch of Q, K, V tiles
  static constexpr int LDS = BK + 4;  // f32 pitch of the score tile
  static constexpr int LDP = BK + 8;  // bf16 pitch of the probability tile
  static constexpr int LDO = HD + 4;  // f32 pitch of the output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LDB * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LDB * 2;
  static constexpr size_t s_off = v_off + size_t(BK) * LDB * 2;
  static constexpr size_t p_off = s_off + size_t(BQ) * LDS * 4;
  static constexpr size_t o_off = p_off + size_t(BQ) * LDP * 2;
  static constexpr size_t m_off = o_off + size_t(BQ) * LDO * 4;
  static constexpr size_t l_off = m_off + size_t(BQ) * 4;
  static constexpr size_t kp_off = l_off + size_t(BQ) * 4;
  static constexpr size_t bytes = kp_off + size_t(BK) * 4;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  using L = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* Ms = reinterpret_cast<float*>(smem + L::m_off);
  float* Ls = reinterpret_cast<float*>(smem + L::l_off);
  int* Kp = reinterpret_cast<int*>(smem + L::kp_off);

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const long q_stride = long(p.H) * HD;    // elements between query rows
  const long kv_stride = long(p.KV) * HD;  // elements between key rows
  const bf16* qg = p.q + (long(b) * p.Sq * p.H + h) * HD;
  const bf16* kg = p.k + (long(b) * p.Sk * p.KV + kvh) * HD;
  const bf16* vg = p.v + (long(b) * p.Sk * p.KV + kvh) * HD;
  bf16* og = p.o + (long(b) * p.Sq * p.H + h) * HD;

  constexpr int VEC = 8;          // bf16 per 16-byte load
  constexpr int VPR = HD / VEC;   // 16-byte vectors per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < BQ * VPR; idx += NTHREADS) {
    const int r = idx / VPR, c = (idx % VPR) * VEC;
    uint4 val = zero;
    if (q0 + r < p.Sq) val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * q_stride + c);
    *reinterpret_cast<uint4*>(Qs + r * L::LDB + c) = val;
  }
  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) Os[(idx / HD) * L::LDO + idx % HD] = 0.f;
  if (tid < BQ) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }

  const int row0 = warp * 16;  // this warp's first query row in the tile
  const int nk = (p.Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed; first pass: Q/O ready
    for (int idx = tid; idx < BK * VPR; idx += NTHREADS) {
      const int r = idx / VPR, c = (idx % VPR) * VEC;
      uint4 kv = zero, vv = zero;
      if (k0 + r < p.Sk) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * kv_stride + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::LDB + c) = kv;
      *reinterpret_cast<uint4*>(Vs + r * L::LDB + c) = vv;
    }
    if (tid < BK) {
      const int j = k0 + tid;
      int pos = -1;  // out of range or masked: invalid
      if (j < p.Sk) {
        pos = p.kv_pos[j];
        if (p.kv_mask != nullptr && p.kv_mask[long(b) * p.Sk + j] == 0) pos = -1;
      }
      Kp[tid] = pos;
    }
    __syncthreads();

    // scores S = Q K^T for this warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + row0 * L::LDB + kk, L::LDB);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          // K^T as a column-major (hd x keys) operand is K row-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + j * 16 * L::LDB + kk, L::LDB);
          wmma::mma_sync(sacc[j], a, bk, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(Ss + row0 * L::LDS + j * 16, sacc[j], L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lane owns keys lane and lane + 32
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const int qi = q0 + row;
      const int qp = qi < p.Sq ? p.q_pos[qi] : Q_PAD_POS;
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        float x = Ss[row * L::LDS + col] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const int kp = Kp[col];
        bool valid = kp >= 0;
        if (p.causal) valid = valid && kp <= qp;
        if (p.window > 0) {
          bool in_w = kp > qp - p.window;
          if (p.protected_ > 0) in_w = in_w || kp < p.protected_;
          valid = valid && in_w;
        }
        s[c] = valid ? x : NEG_INF;
      }
      const float m_prev = Ms[row];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float pr = s[c] > NEG_INF / 2 ? expf(s[c] - m_new) : 0.f;
        psum += pr;
        Ps[row * L::LDP + lane + 32 * c] = __float2bfloat16(pr);
      }
      psum = warp_sum(psum);
      const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
      for (int c = lane; c < HD; c += 32) Os[row * L::LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        Ms[row] = m_new;
        Ls[row] = Ls[row] * alpha + psum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], Ps + row0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        wmma::load_matrix_sync(oacc, Os + row0 * L::LDO + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
          wmma::load_matrix_sync(vb, Vs + kk * 16 * L::LDB + n * 16, L::LDB);
          wmma::mma_sync(oacc, pa[kk], vb, oacc);
        }
        wmma::store_matrix_sync(Os + row0 * L::LDO + n * 16, oacc, L::LDO, wmma::mem_row_major);
      }
    }
    __syncwarp();
  }

  // finalize this warp's rows: acc / l, zeros where no key was valid
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= p.Sq) break;
    const float l = Ls[row];
    const float den = l > 0.f ? l : 1.f;
    for (int c = lane * 2; c < HD; c += 64) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(Os[row * L::LDO + c] / den,
                                                        Os[row * L::LDO + c + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(og + qi * q_stride + c) = pair;
    }
  }
}

template <int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.B * p.H);
  flash_fwd_kernel<HD><<<grid, NTHREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns a cudaError_t: 0 on a
// successful launch.  The launch is asynchronous on `stream`.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* q_pos, const int* kv_pos, const int* kv_mask,
    int B, int H, int KV, int Sq, int Sk, int hd,
    float scale, float softcap, int window, int causal, int protected_,
    void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
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
  switch (hd) {
    case 32: return int(launch<32>(p, s));
    case 64: return int(launch<64>(p, s));
    case 128: return int(launch<128>(p, s));
    default: return int(cudaErrorInvalidValue);
  }
}
