// Grouped symmetric fake quantization with stochastic rounding for Hopper
// (sm_90a): the port of the TPU kernel deepspeed_tpu/ops/quantizer/kernels.py
// _sr_kernel (K8).
//
// out = clamp(floor(x / scale[g] + u), -qmax - 1, qmax) * scale[g], in fp32,
// rounded to x's dtype, with u uniform in [0, 1). The TPU kernel draws u from
// the core's PRNG, seeded per grid block; here u comes from a counter-based
// Philox4x32-10 written below: the key is the mixed seed, the counter is the
// element's quad index (index / 4) in the stacked view, and the element takes
// word index % 4 of the quad's draw, masked to 24 bits and scaled by 2^-24 as
// the TPU kernel does (& 0xFFFFFF). So the noise of an element depends on its
// stacked index and the seed only, not on the launch geometry: one JAX leaf
// stored as several per-layer port leaves is quantized by one launch per leaf
// (``offset`` = the leaf's first index in the stacked view, group = stacked
// index / group_size) and gives the same values as one launch over the
// stacked tensor, and a seed repeats bit for bit. The per-group scales
// (max |x| / qmax over the group, 1 where that is 0) are computed by the
// wrapper, as the TPU wrapper computes them in XLA outside its kernel.
//
// Bound on the H100: memory. It reads x and writes the output once (4 bytes
// an element in bf16, in place); Philox costs ~40 integer operations for
// four elements.
#include <algorithm>

#include "elementwise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // Philox4x32 multipliers
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // Weyl key increments

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sr_quantize_kernel(const T* x, T* out, long n, long offset, long group_size,
                   const float* __restrict__ scale, float qmax, unsigned k0, unsigned k1) {
  const long stride = (long)gridDim.x * kThreads;
  const long q_first = offset / 4, q_end = (offset + n + 3) / 4;
  for (long q = q_first + (long)blockIdx.x * kThreads + threadIdx.x; q < q_end; q += stride) {
    const uint4 r = philox4x32_10(make_uint4((unsigned)q, (unsigned)(q >> 32), 0u, 0u), k0, k1);
    const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long idx = 4 * q + j;
      if (idx < offset || idx >= offset + n) continue;
      const long e = idx - offset;
      const float s = scale[idx / group_size];
      const float u = (float)(words[j] & 0x00FFFFFFu) * (1.0f / 16777216.0f);
      float t = floorf(__fadd_rn(__fdiv_rn(ds::load1<T>(x + e), s), u));
      t = fminf(fmaxf(t, -qmax - 1.0f), qmax);
      ds::store1<T>(out + e, __fmul_rn(t, s));
    }
  }
}

template <typename T>
int launch(const void* x, void* out, long n, long offset, long group_size, const float* scale,
           float qmax, unsigned k0, unsigned k1, cudaStream_t st) {
  const long quads = (offset + n + 3) / 4 - offset / 4;
  const int blocks = (int)std::min<long>(std::max<long>((quads + kThreads - 1) / kThreads, 1),
                                         kMaxBlocks);
  sr_quantize_kernel<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                     static_cast<T*>(out), n, offset, group_size,
                                                     scale, qmax, k0, k1);
  return (int)cudaGetLastError();
}

}  // namespace

// Stochastic-rounding fake quantization of n elements of x (dtype 0 = fp16,
// 1 = bf16, 2 = fp32) into out (same dtype; may be x). The elements are
// indices [offset, offset + n) of a stacked view of group_size-element groups
// whose fp32 scales are ``scale``; (k0, k1) is the Philox key. Returns
// cudaGetLastError() after the launch.
extern "C" int ds_sr_quantize(const void* x, void* out, int dtype, long n, long offset,
                              long group_size, const float* scale, float qmax, unsigned k0,
                              unsigned k1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || offset < 0 || group_size < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (dtype == 0) return launch<__half>(x, out, n, offset, group_size, scale, qmax, k0, k1, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, n, offset, group_size, scale, qmax, k0, k1, st);
  if (dtype == 2) return launch<float>(x, out, n, offset, group_size, scale, qmax, k0, k1, st);
  return (int)cudaErrorInvalidValue;
}
