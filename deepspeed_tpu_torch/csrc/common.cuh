// Small helpers shared by the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ds {

// -1e30: masked logits (exp/exp2 underflow to exactly 0), the TPU kernels'
// _MASKED / _NEG constant.
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// Two floats rounded to T and packed into one 32-bit register, ``lo`` in the
// low half (the element with the smaller column index in an mma fragment).
template <typename T> __device__ __forceinline__ uint32_t pack_f32(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack_f32<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack_f32<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the SFU in one instruction (ex2.approx.ftz: a result below 2^-126
// flushes to 0, where exp2f would return a subnormal; a p that small adds
// nothing at bf16 / fp16 precision, nor to an fp32 sum of terms >= 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The log2-domain additive bias of one (query, key) logit, the TPU kernels'
// _block_bias: ALiBi (slope already times log2 e), -1e30 for a key past S or
// above the causal diagonal, plus the key-side mask bias.
__device__ __forceinline__ float attn_bias(int qpos, int kpos, int S, int causal, float slope,
                                           const float* maskb) {
  const bool valid = kpos < S && (!causal || qpos >= kpos);
  float bias = valid ? slope * (float)(kpos - qpos) : kMasked;
  if (maskb != nullptr && kpos < S) bias += maskb[kpos] * kLog2e;
  return bias;
}

}  // namespace ds
