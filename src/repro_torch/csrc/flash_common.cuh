// Device helpers shared by the flash attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) kernels for
// Hopper (sm_90a): constants, bf16 packing, quad reductions over an
// accumulator row, the positional mask predicates and the tile-bitmask
// walk.  The Hopper instructions
// (TMA, mbarriers, wgmma) are in flash_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int Q_PAD_POS = -1000000000;  // position of a query row past Sq

// +inf: the lse of a row with no valid key (exp2 of anything minus it is 0)
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// is key position kp visible to query position qp (kp < 0: no key)?  No
// branches, so that an unrolled tile of elements is one straight run of
// code.  P is a parameter block with causal, window and protected_.
template <class P>
__device__ __forceinline__ bool key_valid(int kp, int qp, const P& p) {
  return (kp >= 0) & ((p.causal == 0) | (kp <= qp)) &
         ((p.window <= 0) | (kp > qp - p.window) | (kp < p.protected_));
}

// can some query position in [lo, hi] see key position kp / can every one?
// (the live and full marks of a kv tile, a key at a time)
template <class P>
__device__ __forceinline__ void key_reach(int kp, int lo, int hi, const P& p, bool& some,
                                          bool& every) {
  bool sm = kp >= 0, ev = kp >= 0;
  if (p.causal) {
    sm = sm && kp <= hi;
    ev = ev && kp <= lo;
  }
  if (p.window > 0) {
    const bool sink = kp < p.protected_;
    sm = sm && (kp > lo - p.window || sink);
    ev = ev && (kp > hi - p.window || sink);
  }
  some = some || sm;
  every = every && ev;
}

// first tile >= t whose bit is set, or nk
__device__ __forceinline__ int next_tile(const uint32_t* bits, int t, int nk) {
  while (t < nk) {
    const uint32_t w = bits[t >> 5] >> (t & 31);
    if (w) return t + __ffs(w) - 1;
    t = (t | 31) + 1;
  }
  return nk;
}

}  // namespace flash
