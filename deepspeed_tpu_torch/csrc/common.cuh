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

// Two 16-bit values packed into one 32-bit register without conversion.
template <typename T>
__device__ __forceinline__ uint32_t pack_raw(T lo, T hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// D += A (16x16, row-major) * B (16x8, column-major), fp32 accumulators, on
// the tensor cores: mma.sync m16n8k16. Fragment ownership for lane
// (g = lane / 4, t = lane % 4):
//   a[0] (g, 2t..2t+1)   a[1] (g+8, 2t..2t+1)   a[2] (g, 2t+8..)   a[3] (g+8, 2t+8..)
//   b[0] (k 2t..2t+1, n g)   b[1] (k 2t+8..2t+9, n g)
//   c[0..1] (g, 2t..2t+1)    c[2..3] (g+8, 2t..2t+1)
template <typename T> __device__ __forceinline__ void mma16816(float* c, const uint32_t* a, const uint32_t* b);
template <> __device__ __forceinline__ void mma16816<__nv_bfloat16>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <> __device__ __forceinline__ void mma16816<__half>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [row0, row0 + ROWS) of a [S, row_stride] slab into a [ROWS,
// PITCH] shared tile with 16-byte vectors (HD elements per row); rows past S
// are zero. All THREADS threads of the block take part.
template <typename T, int HD, int PITCH, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int S,
                                          long row_stride, int tid) {
  constexpr int kVec = 8;
  constexpr int kPerRow = HD / kVec;
  for (int i = tid; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * PITCH + c) = val;
  }
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

// One 32-bit word (two adjacent 16-bit elements) from shared memory.
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace ds
