// Vector loads and stores shared by the port's elementwise kernels (fused
// LAMB, stochastic-rounding quantization): eight elements of T in one 16-byte
// access, or one element, converted to and from fp32.
#pragma once

#include "common.cuh"

namespace ds {

template <typename T> __device__ __forceinline__ void load8(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = to_float(e[i]);
}
template <> __device__ __forceinline__ void load8<float>(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T> __device__ __forceinline__ void store8(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}
template <> __device__ __forceinline__ void store8<float>(float* p, const float* in) {
  reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

template <typename T> __device__ __forceinline__ float load1(const T* p) { return to_float(*p); }
template <> __device__ __forceinline__ float load1<float>(const float* p) { return *p; }
template <typename T> __device__ __forceinline__ void store1(T* p, float x) { *p = from_float<T>(x); }
template <> __device__ __forceinline__ void store1<float>(float* p, float x) { *p = x; }

}  // namespace ds
