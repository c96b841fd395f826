// Fused LAMB step for Hopper (sm_90a): the port of the TPU kernel
// deepspeed_tpu/ops/lamb/fused_lamb_kernel.py _lamb_kernel (K7).
//
// LAMB is Adam's update u = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p scaled
// by a trust ratio ||p|| / ||u|| taken over one whole JAX leaf, which in the
// port is a group of per-layer leaves (the JAX package stacks the layers into
// one [n_layer, ...] leaf). The TPU kernel accumulates sum(p^2) and sum(u^2)
// in SMEM across a sequential grid; blocks on Hopper run in no order, so the
// step is three kernels without atomics:
//
//   lamb_moments_kernel  one launch per leaf, grid-stride: m and v updated in
//                        place, u computed in registers, and each block's
//                        (sum p^2, sum u^2) written to its own slot of the
//                        group's fp64 partial buffer (the wrapper gives each
//                        leaf its slice);
//   lamb_ratio_kernel    one block: the group's partials summed in a fixed
//                        order, the ratio written to a device scalar (1 where
//                        either norm is 0, as optax and the TPU wrapper do)
//                        and, when asked, ratio * ||u|| to a second one (the
//                        health sentinel's update norm is lr times it);
//   lamb_apply_kernel    one launch per leaf: u recomputed from the updated m,
//                        v and the unchanged p with the same expression, so it
//                        is bit-identical to the first pass's, and
//                        p - lr * (ratio * u) written in place.
//
// Recomputing u costs a second read of p, m, v but needs no u-sized buffer
// (the largest group, 8 x 4096 x 11008 fp32, would hold 1.44 GB of u). The
// block and warp reductions run in a fixed order, so a step repeats bit for
// bit. The arithmetic uses the round-to-nearest intrinsics in the TPU
// kernel's order (one rounding per operation, no fused multiply-add), as the
// plain PyTorch version does op by op; the squares are fp32 products summed
// in fp64.
//
// Bound on the H100: memory. A step must read p, g, m, v and write p, m, v
// once, 28 bytes an element with fp32 p and g; the two passes move 40 (p, g,
// m, v read and m, v written; then p, m, v read and p written).
#include <algorithm>

#include "elementwise.cuh"

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct LambArgs {
  float bc1, bc2, b1, b2, one_minus_b1, one_minus_b2, eps, wd;
};

// The unscaled LAMB update of one element from its new moments.
__device__ __forceinline__ float lamb_u(float p, float m, float v, const LambArgs& a) {
  float u = __fdiv_rn(__fdiv_rn(m, a.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
  if (a.wd != 0.f) u = __fadd_rn(u, __fmul_rn(a.wd, p));
  return u;
}

// m, v <- new moments of one element; returns u and adds p^2, u^2.
__device__ __forceinline__ void lamb_moment(float p, float g, float& m, float& v,
                                            const LambArgs& a, double& sp, double& su) {
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.one_minus_b2, __fmul_rn(g, g)));
  const float u = lamb_u(p, m, v, a);
  sp += (double)__fmul_rn(p, p);
  su += (double)__fmul_rn(u, u);
}

// Sum of (x, y) over the block in a fixed order; the result is valid in
// thread 0.
__device__ __forceinline__ void block_sum2(double& x, double& y) {
  __shared__ double sx[kWarps], sy[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sx[warp] = x;
    sy[warp] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    x = 0.0;
    y = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      x += sx[w];
      y += sy[w];
    }
  }
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
lamb_moments_kernel(const P* __restrict__ p, const G* __restrict__ g, float* m, float* v, long n,
                    LambArgs a, double* partials) {
  const long stride = (long)gridDim.x * kThreads;
  const long first = (long)blockIdx.x * kThreads + threadIdx.x;
  const long nvec = n / kVec;
  double sp = 0.0, su = 0.0;
  for (long i = first; i < nvec; i += stride) {
    const long base = i * kVec;
    float pf[8], gf[8], mf[8], vf[8];
    ds::load8<P>(p + base, pf);
    ds::load8<G>(g + base, gf);
    ds::load8<float>(m + base, mf);
    ds::load8<float>(v + base, vf);
#pragma unroll
    for (int j = 0; j < 8; ++j) lamb_moment(pf[j], gf[j], mf[j], vf[j], a, sp, su);
    ds::store8<float>(m + base, mf);
    ds::store8<float>(v + base, vf);
  }
  for (long i = nvec * kVec + first; i < n; i += stride) {   // scalar tail
    float mi = m[i], vi = v[i];
    lamb_moment(ds::load1<P>(p + i), ds::load1<G>(g + i), mi, vi, a, sp, su);
    m[i] = mi;
    v[i] = vi;
  }
  block_sum2(sp, su);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = sp;
    partials[2 * blockIdx.x + 1] = su;
  }
}

__global__ void __launch_bounds__(kThreads)
lamb_ratio_kernel(const double* partials, int count, float* ratio, float* unorm) {
  double sp = 0.0, su = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    sp += partials[2 * i];
    su += partials[2 * i + 1];
  }
  block_sum2(sp, su);
  if (threadIdx.x == 0) {
    const float pn = (float)sqrt(sp), un = (float)sqrt(su);
    const float r = (pn > 0.f && un > 0.f) ? __fdiv_rn(pn, un) : 1.f;
    *ratio = r;
    if (unorm != nullptr) *unorm = __fmul_rn(r, un);   // ||ratio * u||: the update norm / lr
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
lamb_apply_kernel(P* p, const float* __restrict__ m, const float* __restrict__ v, long n,
                  LambArgs a, float lr, const float* __restrict__ ratio) {
  const float r = *ratio;
  const long stride = (long)gridDim.x * kThreads;
  const long first = (long)blockIdx.x * kThreads + threadIdx.x;
  const long nvec = n / kVec;
  for (long i = first; i < nvec; i += stride) {
    const long base = i * kVec;
    float pf[8], mf[8], vf[8];
    ds::load8<P>(p + base, pf);
    ds::load8<float>(m + base, mf);
    ds::load8<float>(v + base, vf);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pf[j] = __fsub_rn(pf[j], __fmul_rn(lr, __fmul_rn(r, lamb_u(pf[j], mf[j], vf[j], a))));
    ds::store8<P>(p + base, pf);
  }
  for (long i = nvec * kVec + first; i < n; i += stride) {
    const float pi = ds::load1<P>(p + i);
    ds::store1<P>(p + i, __fsub_rn(pi, __fmul_rn(lr, __fmul_rn(r, lamb_u(pi, m[i], v[i], a)))));
  }
}

template <typename P>
int moments_g(const void* p, const void* g, int g_dtype, float* m, float* v, long n, int blocks,
              double* partials, const LambArgs& a, cudaStream_t st) {
  const P* pp = static_cast<const P*>(p);
  if (g_dtype == 0)
    lamb_moments_kernel<P, __half><<<blocks, kThreads, 0, st>>>(
        pp, static_cast<const __half*>(g), m, v, n, a, partials);
  else if (g_dtype == 1)
    lamb_moments_kernel<P, __nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        pp, static_cast<const __nv_bfloat16*>(g), m, v, n, a, partials);
  else if (g_dtype == 2)
    lamb_moments_kernel<P, float><<<blocks, kThreads, 0, st>>>(
        pp, static_cast<const float*>(g), m, v, n, a, partials);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// Pass 1 over one leaf of n elements: p (p_dtype) and g (g_dtype; 0 = fp16,
// 1 = bf16, 2 = fp32) read, m and v (fp32) updated in place, and each of the
// ``blocks`` blocks' (sum p^2, sum u^2) written to partials[2 b], [2 b + 1]
// (fp64). All element pointers 16-byte aligned. bc1 / bc2 are 1 - b^step
// (1 when bias correction is off); one_minus_b* are 1 - b rounded to fp32.
extern "C" int ds_lamb_moments(const void* p, int p_dtype, const void* g, int g_dtype, float* m,
                               float* v, long n, int blocks, double* partials, float bc1,
                               float bc2, float b1, float b2, float one_minus_b1,
                               float one_minus_b2, float eps, float wd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LambArgs a{bc1, bc2, b1, b2, one_minus_b1, one_minus_b2, eps, wd};
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  if (p_dtype == 0) return moments_g<__half>(p, g, g_dtype, m, v, n, blocks, partials, a, st);
  if (p_dtype == 1)
    return moments_g<__nv_bfloat16>(p, g, g_dtype, m, v, n, blocks, partials, a, st);
  if (p_dtype == 2) return moments_g<float>(p, g, g_dtype, m, v, n, blocks, partials, a, st);
  return (int)cudaErrorInvalidValue;
}

// The trust ratio of a group from its ``count`` partial pairs, written to
// ``ratio`` (one fp32 on the device), and, when ``unorm`` is not null,
// ratio * ||u|| there (the norm of the group's applied direction).
extern "C" int ds_lamb_ratio(const double* partials, int count, float* ratio, float* unorm,
                             void* stream) {
  lamb_ratio_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(partials, count,
                                                                            ratio, unorm);
  return (int)cudaGetLastError();
}

// Pass 2 over one leaf: p <- p - lr * (ratio * u) in place, u from the new m,
// v (fp32) and p; ``ratio`` is the device scalar of ds_lamb_ratio.
extern "C" int ds_lamb_apply(void* p, int p_dtype, const float* m, const float* v, long n,
                             int blocks, const float* ratio, float lr, float bc1, float bc2,
                             float eps, float wd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LambArgs a{bc1, bc2, 0.f, 0.f, 0.f, 0.f, eps, wd};
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  if (p_dtype == 0)
    lamb_apply_kernel<__half><<<blocks, kThreads, 0, st>>>(static_cast<__half*>(p), m, v, n, a,
                                                           lr, ratio);
  else if (p_dtype == 1)
    lamb_apply_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(p), m, v, n, a, lr, ratio);
  else if (p_dtype == 2)
    lamb_apply_kernel<float><<<blocks, kThreads, 0, st>>>(static_cast<float*>(p), m, v, n, a, lr,
                                                          ratio);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
