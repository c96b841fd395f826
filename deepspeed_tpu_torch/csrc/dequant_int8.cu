// Int8 weight-only dequantisation for Hopper (sm_90a): w = q * scale, one
// fp32 product rounded once to bf16 or fp16, for int8 q [R, C] with fp32
// scales [R, groups] grouped over the last axis (group g of a row covers
// columns g * C / groups ..).
//
// Replaces no pallas_call site. It is the card's counterpart of what XLA
// does with deepspeed_tpu/ops/quant.py Quantized8.dequant (:35): the JAX
// package leaves (q.astype(f32) * scale).astype(bf16) to XLA, which fuses
// it into the consuming matmul's operand read. Eager PyTorch would write an
// fp32 copy of the matrix and then a second, bf16 one; this kernel reads
// the int8 payload and the scales once and writes the bf16 matrix once.
// The matmul that follows stays torch.matmul, as the JAX package's product
// is an XLA dot. A weight-only int8 GEMM that dequantises inside its main
// loop would not write the bf16 matrix at all (ROADMAP.md, Hopper work).
//
// Bound on the H100: bytes. R * C int8 read, R * groups fp32 read, R * C
// 16-bit written, one multiply an element: 3 bytes an element over 3.35
// TB/s. Design: each thread takes 16 consecutive elements of a row (one
// 16-byte load of q, two 16-byte stores, the bytes unpacked and the
// results packed in registers), neighbouring threads on
// neighbouring vectors, a grid-stride loop over the matrix; the scale is
// read once for the vector where the 16 columns share a group (a group of
// 16 columns or more, aligned), else per element. Rows whose width is not
// a multiple of 16 take the scalar kernel, one element a thread.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_int8_vec_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                        T* __restrict__ out, long n16, int C, int groups, int gsize) {
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < n16;
       i += (long)gridDim.x * kThreads) {
    const long e0 = i * 16;
    const long row = e0 / C;
    const int col = (int)(e0 - row * C);
    const float* srow = scale + row * groups;
    const int4 raw = *reinterpret_cast<const int4*>(q + e0);
    const int words[4] = {raw.x, raw.y, raw.z, raw.w};
    float f[16];
#pragma unroll
    for (int u = 0; u < 16; ++u)   // byte u of the vector, sign-extended (in registers)
      f[u] = (float)(signed char)(words[u / 4] >> (8 * (u % 4)));
    const int g0 = col / gsize;
    if (g0 == (col + 15) / gsize) {
      const float s = srow[g0];
#pragma unroll
      for (int u = 0; u < 16; ++u) f[u] *= s;
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) f[u] *= srow[(col + u) / gsize];
    }
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = ds::pack_f32<T>(f[2 * j], f[2 * j + 1]);
    uint4* dst = reinterpret_cast<uint4*>(out + e0);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_int8_scalar_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                           T* __restrict__ out, long n, int C, int groups, int gsize) {
  for (long e = (long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (long)gridDim.x * kThreads) {
    const long row = e / C;
    const int col = (int)(e - row * C);
    out[e] = ds::from_float<T>((float)q[e] * scale[row * groups + col / gsize]);
  }
}

template <typename T>
int launch(const void* q, const float* scale, void* out, long R, int C, int groups,
           cudaStream_t stream) {
  const long n = R * C;
  const int gsize = C / groups;
  const bool vec = C % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long work = vec ? n / 16 : n;
  const long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  if (blocks == 0) return (int)cudaSuccess;
  if (vec)
    dequant_int8_vec_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), scale, static_cast<T*>(out), work, C, groups, gsize);
  else
    dequant_int8_scalar_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(q), scale, static_cast<T*>(out), work, C, groups, gsize);
  return (int)cudaGetLastError();
}

}  // namespace

// q [R, C] int8 and scale [R, groups] fp32, both contiguous; out [R, C] in
// dtype 0 = fp16 or 1 = bf16; C % groups == 0. Launches on ``stream`` and
// returns cudaGetLastError() (cudaErrorInvalidValue for a shape or dtype
// it does not take).
extern "C" int ds_dequant_int8(const void* q, const float* scale, void* out, long long R, int C,
                               int groups, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 0 || C <= 0 || groups <= 0 || C % groups != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch<__nv_bfloat16>(q, scale, out, (long)R, C, groups, st);
  if (dtype == 0) return launch<__half>(q, scale, out, (long)R, C, groups, st);
  return (int)cudaErrorInvalidValue;
}
