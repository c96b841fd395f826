// NHWC bias adds for Hopper (sm_90a), kernel S: the three forms of the
// diffusers spatial ops over an activation [N, H, W, C] seen as [R, C] with
// R = N * H * W and a per-channel bias [C]:
//   mode 0  out = a + bias
//   mode 1  out = (a + bias) + other
//   mode 2  out = (a + bias) + (other + other_bias)
// Each add is done in fp32 and rounded to the dtype after it, the order of
// the plain chain in deepspeed_tpu_torch/ops/spatial/kernels.py (and of the
// JAX package's bf16 chain), so the kernel and the plain version agree bit
// for bit.
//
// Replaces no pallas_call site. It is the card's counterpart of what XLA
// does with deepspeed_tpu/ops/spatial/kernels.py:17-30 (nhwc_bias_add,
// nhwc_bias_add_add, nhwc_bias_add_bias_add): XLA fuses each chain into one
// elementwise pass, where eager PyTorch pays one full pass over the
// activation for every add. The reference DeepSpeed has CUDA kernels for
// the same three forms (csrc/spatial/csrc/opt_bias_add.cu).
//
// Bound on the H100: bytes. Mode 0 reads a and writes out (4 bytes an
// element in bf16), modes 1 and 2 read other too (6 bytes), over 3.35 TB/s;
// one or three adds an element. Design: each thread moves 16-byte vectors
// (8 bf16 / fp16 elements or 4 fp32), neighbouring threads on neighbouring
// vectors, a grid-stride loop over the whole [R, C] matrix; each CTA stages
// bias (and other_bias) in shared memory once, so the loop reads the bias
// vectors of its columns from there. C must be a multiple of the vector
// width and every pointer 16-byte aligned (the wrapper checks both).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;
constexpr int kMaxSmem = 48 * 1024;   // the biases staged a CTA, without the opt-in

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 rnd<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half rnd<__half>(float x) { return __float2half_rn(x); }

// a + b rounded to T, and back to fp32 for the next add
template <typename T> __device__ __forceinline__ float add_rnd(float a, float b) {
  return f32(rnd<T>(a + b));
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
spatial_bias_add_kernel(const T* __restrict__ a, const T* __restrict__ bias,
                        const T* __restrict__ other, const T* __restrict__ other_bias,
                        T* __restrict__ out, long nvec, int cvec) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* sb = reinterpret_cast<uint4*>(smem);
  uint4* sob = sb + cvec;
  for (int i = threadIdx.x; i < cvec; i += kThreads) {
    sb[i] = reinterpret_cast<const uint4*>(bias)[i];
    if (MODE == 2) sob[i] = reinterpret_cast<const uint4*>(other_bias)[i];
  }
  __syncthreads();
  const uint4* av = reinterpret_cast<const uint4*>(a);
  const uint4* ov = reinterpret_cast<const uint4*>(other);
  uint4* outv = reinterpret_cast<uint4*>(out);
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += (long)gridDim.x * kThreads) {
    const int c = (int)(i % cvec);
    // 16-byte vectors in registers, read element by element as T
    const uint4 xr = av[i], br = sb[c];
    const uint4 orr = MODE >= 1 ? ov[i] : xr;
    const uint4 obr = MODE == 2 ? sob[c] : br;
    const T* x = reinterpret_cast<const T*>(&xr);
    const T* b = reinterpret_cast<const T*>(&br);
    const T* o = reinterpret_cast<const T*>(&orr);
    const T* ob = reinterpret_cast<const T*>(&obr);
    uint4 yr;
    T* y = reinterpret_cast<T*>(&yr);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      float r = add_rnd<T>(f32(x[u]), f32(b[u]));
      if (MODE == 1) r = add_rnd<T>(r, f32(o[u]));
      if (MODE == 2) r = add_rnd<T>(r, add_rnd<T>(f32(o[u]), f32(ob[u])));
      y[u] = rnd<T>(r);
    }
    outv[i] = yr;
  }
}

template <typename T, int MODE>
int launch_mode(const void* a, const void* bias, const void* other, const void* other_bias,
                void* out, long R, int C, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int cvec = C / V;
  const long nvec = R * (long)cvec;
  const int smem = cvec * 16 * (MODE == 2 ? 2 : 1);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long want = (nvec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  if (blocks == 0) return (int)cudaSuccess;
  spatial_bias_add_kernel<T, MODE><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bias), static_cast<const T*>(other),
      static_cast<const T*>(other_bias), static_cast<T*>(out), nvec, cvec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int mode, const void* a, const void* bias, const void* other,
           const void* other_bias, void* out, long R, int C, cudaStream_t stream) {
  if (C % (16 / (int)sizeof(T)) != 0) return (int)cudaErrorInvalidValue;
  if (mode == 0) return launch_mode<T, 0>(a, bias, other, other_bias, out, R, C, stream);
  if (mode == 1) return launch_mode<T, 1>(a, bias, other, other_bias, out, R, C, stream);
  if (mode == 2) return launch_mode<T, 2>(a, bias, other, other_bias, out, R, C, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, other and out [R, C], bias and other_bias [C], contiguous, 16-byte
// aligned, one dtype: 0 = fp16, 1 = bf16, 2 = fp32; C a multiple of 8
// (fp16 / bf16) or 4 (fp32). other is read in modes 1 and 2, other_bias in
// mode 2. Launches on ``stream`` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape, mode or dtype it does not take).
extern "C" int ds_spatial_bias_add(int mode, const void* a, const void* bias, const void* other,
                                   const void* other_bias, void* out, long long R, int C,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 0 || C <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch<__nv_bfloat16>(mode, a, bias, other, other_bias, out, (long)R, C, st);
  if (dtype == 0) return launch<__half>(mode, a, bias, other, other_bias, out, (long)R, C, st);
  if (dtype == 2) return launch<float>(mode, a, bias, other, other_bias, out, (long)R, C, st);
  return (int)cudaErrorInvalidValue;
}
