// Dense decode attention for Hopper (sm_90a): the port of the TPU kernel
// deepspeed_tpu/ops/pallas/decode_attention.py _kernel (K5). One new query
// token per batch row attends a dense KV workspace ck / cv [B, Smax, KV, Hd]
// (static generate's cache), with ONE position pos for the whole batch:
// keys past pos are masked with -1e30; an optional pad bias [B, Smax] f32
// and ALiBi slopes [H] apply over key positions.
//
// The TPU grid walked (row, 512/256/128-key block) with the running softmax
// in VMEM and a clamped index map so dead tail blocks cost no DMA. Here the
// live prefix [0, pos] of every row is cut into pos / 128 + 1 splits of 128
// keys, spread over CTAs (grid KV x B x Z), each streaming its K/V tiles
// through a cp.async ring and writing one fp32 partial; a second kernel
// merges each row's partials in split order (decode_attention.cuh, shared
// with the paged kernel B, TPU K6, which differs only in where a key row
// lives). pos is a host int: the decode loop knows it, so the split count
// is known on the host and the launch needs no device sync.
//
// Bound on the H100: a decode step reads every live K/V byte once and does
// 4 * G FLOPs per 4 bytes of K/V, far below the bf16 ridge (about 295
// FLOP/byte), so it is bound by the live K/V bytes over 3.35 TB/s (at the
// static-generate shape, 8 rows x 576 keys x 32 heads x 128 x 2 x 2 B =
// 75.5 MB, about 22.5 us). Splitting the keys puts 5 CTAs on each (kv head,
// row) there, 1280 in all, each with up to 48 KB of loads in flight.
#include "decode_attention.cuh"

namespace {

constexpr int kThreads = ds::kDecodeThreads;

// Logical key ``key`` of row b lives at workspace row b * Smax + key.
struct DenseRows {
  long row0;
  __device__ long operator()(int key) const { return row0 + key; }
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck, const T* __restrict__ cv,
                    const float* __restrict__ bias, const float* __restrict__ slopes,
                    float* __restrict__ part, float scale, int B, int H, int KV, int smax,
                    int pos) {
  extern __shared__ __align__(16) char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int splits = pos / ds::kSplitKeys + 1;
  const long row = (long)b * KV + kvh;
  ds::decode_split<T, HD, G>(q + (long)b * H * HD, scale, ck + (long)kvh * HD,
                             cv + (long)kvh * HD, DenseRows{(long)b * smax}, (long)KV * HD, pos,
                             splits, bias ? bias + (long)b * smax : nullptr, slopes, kvh,
                             part + row * splits * G * HD,
                             part + (long)B * H * splits * HD + row * splits * G * 2, smem);
}

// One CTA of Hd threads per (query head h, row b): the row's partials merged.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(HD)
dense_decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int B, int H,
                            int KV, int pos) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int splits = pos / ds::kSplitKeys + 1;
  const long row = (long)b * KV + h / G;
  ds::decode_combine<T, HD, G>(part + row * splits * G * HD,
                               part + (long)B * H * splits * HD + row * splits * G * 2, splits,
                               h % G, out + ((long)b * H + h) * HD);
}

template <typename T, int HD, int G>
int launch(const void* q, const void* ck, const void* cv, const float* bias,
           const float* slopes, void* out, float* part, float scale, int B, int H, int KV,
           int smax, int pos, cudaStream_t stream) {
  constexpr size_t smem = ds::decode_smem_bytes<HD, G>();
  auto kern = dense_decode_kernel<T, HD, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(KV, B, ds::decode_grid_z(pos / ds::kSplitKeys + 1, KV, B));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv), bias,
      slopes, part, scale, B, H, KV, smax, pos);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_decode_combine_kernel<T, HD, G><<<dim3(H, B), HD, 0, stream>>>(
      part, static_cast<T*>(out), B, H, KV, pos);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_group(int G, const void* q, const void* ck, const void* cv, const float* bias,
                   const float* slopes, void* out, float* part, float scale, int B, int H,
                   int KV, int smax, int pos, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
    case 2: return launch<T, HD, 2>(q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
    case 4: return launch<T, HD, 4>(q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
    case 8: return launch<T, HD, 8>(q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Hd] (scaled here by ``scale`` and rounded to its dtype, as the TPU
// kernel's caller does); ck/cv [B,Smax,KV,Hd] with the new k/v written at
// pos; bias [B,Smax] f32 or null; slopes [H] f32 or null; out [B,H,Hd];
// part: fp32 scratch of B * H * (pos / 128 + 1) * (Hd + 2) floats;
// 0 <= pos < Smax, Smax % 128 == 0. dtype 0 = fp16, 1 = bf16; head_dim 64, 96,
// 128 or 256; H / KV in {1, 2, 4, 8}. Launches the split kernel and the combine
// kernel on ``stream``; returns cudaGetLastError().
extern "C" int ds_dense_decode_attention(const void* q, const void* ck, const void* cv,
                                         const float* bias, const float* slopes, void* out,
                                         float* part, float scale, int B, int H, int KV,
                                         int head_dim, int smax, int pos, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (pos < 0 || pos >= smax || smax % ds::kSplitKeys != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 64)
    return dispatch_group<__nv_bfloat16, 64>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  if (dtype == 1 && head_dim == 128)
    return dispatch_group<__nv_bfloat16, 128>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  if (dtype == 1 && head_dim == 96)
    return dispatch_group<__nv_bfloat16, 96>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  if (dtype == 1 && head_dim == 256)
    return dispatch_group<__nv_bfloat16, 256>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  if (dtype == 0 && head_dim == 64)
    return dispatch_group<__half, 64>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  if (dtype == 0 && head_dim == 128)
    return dispatch_group<__half, 128>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  if (dtype == 0 && head_dim == 96)
    return dispatch_group<__half, 96>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  if (dtype == 0 && head_dim == 256)
    return dispatch_group<__half, 256>(G, q, ck, cv, bias, slopes, out, part, scale, B, H, KV, smax, pos, st);
  return (int)cudaErrorInvalidValue;
}
