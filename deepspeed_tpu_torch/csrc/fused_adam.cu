// Fused Adam / AdamW step for Hopper (sm_90a): the port of the TPU kernel
// deepspeed_tpu/ops/adam/fused_adam_kernel.py _adam_kernel (K4). One
// grid-stride elementwise pass over one flat parameter leaf: every element of
// p, g, m and v is read once and the update (or the new param) and the new
// moments are written once, with all arithmetic in fp32 registers.
//
// Layout: 256 threads a block, 8 elements a thread per step, moved as
// 16-byte vectors (two float4 for an fp32 operand, one uint4 for a 16-bit
// one); the n % 8 tail runs element by element. The moments are fp32 and
// updated in place; ``out`` may alias p (emit = param, in place) or be a
// separate fp32 buffer for the descent direction (emit = update, which the
// engine applies as master - lr * u).
//
// The arithmetic uses the round-to-nearest intrinsics, one rounding per
// operation and no fused multiply-add, in the TPU kernel's order, so the
// kernel equals the plain PyTorch version (one framework op per step) to
// the bit.
//
// With a caller-given ``sq`` buffer each block also writes its partial sum
// of u^2 (fp32; u the full direction applied as p - lr * u, weight decay
// included) to sq[blockIdx.x]: a warp-shuffle tree and the warps in order,
// no atomics, so the slots (and the sentinel's update norm the caller
// reduces from them in a fixed order) repeat to the bit from run to run.
//
// Bound on the H100: memory. Per element it moves p and g in their dtypes,
// m and v in fp32 both ways and the output once, about 28 bytes for fp32
// p and g; at 3.35 TB/s that is the whole story, the FLOPs are negligible.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kVec = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

struct AdamArgs {
  float lr, bc1, bc2, b1, b2, one_minus_b1, one_minus_b2, eps, wd;
};

template <typename T> __device__ __forceinline__ void load8(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = ds::to_float(e[i]);
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
  for (int i = 0; i < 8; ++i) e[i] = ds::from_float<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}
template <> __device__ __forceinline__ void store8<float>(float* p, const float* in) {
  reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
}

template <typename T> __device__ __forceinline__ float load1(const T* p) { return ds::to_float(*p); }
template <> __device__ __forceinline__ float load1<float>(const float* p) { return *p; }
template <typename T> __device__ __forceinline__ void store1(T* p, float x) { *p = ds::from_float<T>(x); }
template <> __device__ __forceinline__ void store1<float>(float* p, float x) { *p = x; }

// One element of _adam_kernel: m, v updated in place, u set to the
// direction, returns the output.
template <bool EMIT_PARAM, bool ADAM_W>
__device__ __forceinline__ float adam(float p, float g, float& m, float& v, float& u,
                                      const AdamArgs& a) {
  if (!ADAM_W && a.wd != 0.f) g = __fadd_rn(g, __fmul_rn(a.wd, p));   // L2 into the gradient
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.one_minus_b2, __fmul_rn(g, g)));
  float upd = __fdiv_rn(__fdiv_rn(m, a.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, a.bc2)), a.eps));
  if (ADAM_W && a.wd != 0.f) upd = __fadd_rn(upd, __fmul_rn(a.wd, p));  // decoupled decay
  u = upd;
  return EMIT_PARAM ? __fsub_rn(p, __fmul_rn(a.lr, upd)) : upd;
}

// The block's sum of x (every thread's) on thread 0, in a fixed order.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float sx[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, off));
  if (threadIdx.x % 32 == 0) sx[threadIdx.x / 32] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    x = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) x = __fadd_rn(x, sx[w]);
  }
  return x;
}

template <typename P, typename G, bool EMIT_PARAM, bool ADAM_W>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const P* p, const G* __restrict__ g, float* m, float* v, void* out, long n,
                  AdamArgs a, float* __restrict__ sq) {
  using O = typename std::conditional<EMIT_PARAM, P, float>::type;
  O* o = static_cast<O*>(out);
  const long stride = (long)gridDim.x * kThreads;
  const long first = (long)blockIdx.x * kThreads + threadIdx.x;
  const long nvec = n / kVec;
  float s = 0.f;                       // this thread's sum of u^2
  for (long i = first; i < nvec; i += stride) {
    const long base = i * kVec;
    float pf[8], gf[8], mf[8], vf[8], of[8];
    load8<P>(p + base, pf);
    load8<G>(g + base, gf);
    load8<float>(m + base, mf);
    load8<float>(v + base, vf);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float u;
      of[j] = adam<EMIT_PARAM, ADAM_W>(pf[j], gf[j], mf[j], vf[j], u, a);
      s = __fadd_rn(s, __fmul_rn(u, u));
    }
    store8<float>(m + base, mf);
    store8<float>(v + base, vf);
    store8<O>(o + base, of);
  }
  for (long i = nvec * kVec + first; i < n; i += stride) {   // scalar tail
    float mi = m[i], vi = v[i], u;
    const float oi = adam<EMIT_PARAM, ADAM_W>(load1<P>(p + i), load1<G>(g + i), mi, vi, u, a);
    m[i] = mi;
    v[i] = vi;
    store1<O>(o + i, oi);
    s = __fadd_rn(s, __fmul_rn(u, u));
  }
  if (sq != nullptr) {                 // uniform across the block
    s = block_sum(s);
    if (threadIdx.x == 0) sq[blockIdx.x] = s;
  }
}

template <typename P, typename G>
int launch(const void* p, const void* g, float* m, float* v, void* out, long n, int emit_param,
           int adam_w, const AdamArgs& a, float* sq, cudaStream_t stream) {
  const long work = n / kVec + (n % kVec);
  const int blocks = (int)std::min<long>(std::max<long>((work + kThreads - 1) / kThreads, 1),
                                         kMaxBlocks);
  const P* pp = static_cast<const P*>(p);
  const G* gp = static_cast<const G*>(g);
  if (emit_param && adam_w)
    fused_adam_kernel<P, G, true, true><<<blocks, kThreads, 0, stream>>>(pp, gp, m, v, out, n, a, sq);
  else if (emit_param)
    fused_adam_kernel<P, G, true, false><<<blocks, kThreads, 0, stream>>>(pp, gp, m, v, out, n, a, sq);
  else if (adam_w)
    fused_adam_kernel<P, G, false, true><<<blocks, kThreads, 0, stream>>>(pp, gp, m, v, out, n, a, sq);
  else
    fused_adam_kernel<P, G, false, false><<<blocks, kThreads, 0, stream>>>(pp, gp, m, v, out, n, a, sq);
  return (int)cudaGetLastError();
}

template <typename P>
int dispatch_g(const void* p, const void* g, int g_dtype, float* m, float* v, void* out, long n,
               int emit_param, int adam_w, const AdamArgs& a, float* sq, cudaStream_t st) {
  if (g_dtype == 0) return launch<P, __half>(p, g, m, v, out, n, emit_param, adam_w, a, sq, st);
  if (g_dtype == 1)
    return launch<P, __nv_bfloat16>(p, g, m, v, out, n, emit_param, adam_w, a, sq, st);
  if (g_dtype == 2) return launch<P, float>(p, g, m, v, out, n, emit_param, adam_w, a, sq, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One Adam/AdamW step over n elements of a flat leaf. p: dtype p_dtype, g:
// g_dtype (0 = fp16, 1 = bf16, 2 = fp32), m/v fp32 (updated in place), all
// 16-byte aligned. emit_param = 1 writes p - lr * u in p's dtype to out (out
// may be p); emit_param = 0 writes u in fp32. bc1/bc2 are the bias
// corrections 1 - b^step (1 when off); one_minus_b* are 1 - b rounded to fp32
// as the TPU kernel's constants. sq: null, or fp32 slots, one a block
// (ds_fused_adam_blocks(n) of them), each written with its block's sum of
// u^2. Returns cudaGetLastError() after the launch.
extern "C" int ds_fused_adam(const void* p, int p_dtype, const void* g, int g_dtype, float* m,
                             float* v, void* out, long n, int emit_param, int adam_w, float lr,
                             float bc1, float bc2, float b1, float b2, float one_minus_b1,
                             float one_minus_b2, float eps, float wd, float* sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamArgs a{lr, bc1, bc2, b1, b2, one_minus_b1, one_minus_b2, eps, wd};
  if (p_dtype == 0)
    return dispatch_g<__half>(p, g, g_dtype, m, v, out, n, emit_param, adam_w, a, sq, st);
  if (p_dtype == 1)
    return dispatch_g<__nv_bfloat16>(p, g, g_dtype, m, v, out, n, emit_param, adam_w, a, sq, st);
  if (p_dtype == 2)
    return dispatch_g<float>(p, g, g_dtype, m, v, out, n, emit_param, adam_w, a, sq, st);
  return (int)cudaErrorInvalidValue;
}
