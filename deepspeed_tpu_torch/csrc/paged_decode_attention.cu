// Paged decode attention for Hopper (sm_90a): the port of the TPU kernel
// deepspeed_tpu/ops/pallas/paged_decode_attention.py _kernel (K6). One new
// query token per request attends its cached keys through a block table
// over a pool shared by every request: k/v pools [num_blocks, bs, KV, Hd],
// block_tables [B, nmax] int32, per-request positions pos [B] int32 on the
// card.
//
// Bound on the H100: the live K/V bytes (every request's pos[b] + 1 keys,
// once per kv group) over 3.35 TB/s; the math, 4 * G FLOPs per 4 bytes, is
// far below the ridge. What the design does about it (decode_attention.cuh):
// a request's keys are cut into 128-key splits spread over CTAs, each CTA
// streams its tiles through a cp.async ring with the loads running ahead of
// the math, and a second kernel merges a request's fp32 partials in split
// order. The split count, nmax * bs / 128, and the
// grid come from shapes only; each CTA reads pos[b] itself and returns at
// once when its splits lie past pos[b] / 128, so a launch never waits on the
// device and the decode step can be captured in a CUDA graph.
#include "decode_attention.cuh"

namespace {

constexpr int kThreads = ds::kDecodeThreads;

// Logical key ``key`` of a request lives at pool row table[key / bs] * bs + key % bs.
struct PagedRows {
  const int* table;
  int bs;
  __device__ long operator()(int key) const {
    return (long)table[key / bs] * bs + key % bs;
  }
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ block_tables, const int* __restrict__ pos_arr,
                    const float* __restrict__ bias, const float* __restrict__ slopes,
                    float* __restrict__ part, float scale, int B, int H, int KV, int bs,
                    int nmax, int splits) {
  extern __shared__ __align__(16) char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pos = pos_arr[b];
  const int n_live = min(pos / ds::kSplitKeys + 1, splits);
  const long row = (long)b * KV + kvh;
  ds::decode_split<T, HD, G>(q + (long)b * H * HD, scale, kp + (long)kvh * HD,
                             vp + (long)kvh * HD, PagedRows{block_tables + (long)b * nmax, bs},
                             (long)KV * HD, pos, n_live,
                             bias ? bias + (long)b * nmax * bs : nullptr, slopes, kvh,
                             part + row * splits * G * HD,
                             part + (long)B * H * splits * HD + row * splits * G * 2, smem);
}

// One CTA of Hd threads per (query head h, row b): the row's partials merged.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(HD)
paged_decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos_arr,
                            T* __restrict__ out, int B, int H, int KV, int splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_live = min(pos_arr[b] / ds::kSplitKeys + 1, splits);
  const long row = (long)b * KV + h / G;
  ds::decode_combine<T, HD, G>(part + row * splits * G * HD,
                               part + (long)B * H * splits * HD + row * splits * G * 2, n_live,
                               h % G, out + ((long)b * H + h) * HD);
}

template <typename T, int HD, int G>
int launch(const void* q, const void* kp, const void* vp, const int* bt, const int* pos,
           const float* bias, const float* slopes, void* out, float* part, float scale, int B,
           int H, int KV, int bs, int nmax, cudaStream_t stream) {
  constexpr size_t smem = ds::decode_smem_bytes<HD, G>();
  auto kern = paged_decode_kernel<T, HD, G>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int splits = nmax * (bs / ds::kSplitKeys);
  dim3 grid(KV, B, ds::decode_grid_z(splits, KV, B));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, pos,
      bias, slopes, part, scale, B, H, KV, bs, nmax, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<T, HD, G><<<dim3(H, B), HD, 0, stream>>>(
      part, pos, static_cast<T*>(out), B, H, KV, splits);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_group(int G, const void* q, const void* kp, const void* vp, const int* bt,
                   const int* pos, const float* bias, const float* slopes, void* out,
                   float* part, float scale, int B, int H, int KV, int bs, int nmax,
                   cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, kp, vp, bt, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
    case 2: return launch<T, HD, 2>(q, kp, vp, bt, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
    case 4: return launch<T, HD, 4>(q, kp, vp, bt, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
    case 8: return launch<T, HD, 8>(q, kp, vp, bt, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Hd] (scaled here by ``scale`` and rounded to its dtype, as the TPU
// kernel's caller does); pools [Nb,bs,KV,Hd]; block_tables [B,nmax] int32;
// pos [B] int32; bias [B,nmax*bs] f32 or null; slopes [H] f32 or null; out
// [B,H,Hd]; part: fp32 scratch of B * H * splits * (Hd + 2) floats with
// splits = nmax * bs / 128. dtype 0 = fp16, 1 = bf16; head_dim 64, 96, 128 or 256;
// H / KV in {1, 2, 4, 8}; bs % 128 == 0. Launches the split kernel and the
// combine kernel on ``stream``; returns cudaGetLastError().
extern "C" int ds_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const int* block_tables, const int* pos,
                                         const float* bias, const float* slopes, void* out,
                                         float* part, float scale, int B, int H, int KV,
                                         int head_dim, int bs, int nmax, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (bs % ds::kSplitKeys != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 64)
    return dispatch_group<__nv_bfloat16, 64>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  if (dtype == 1 && head_dim == 128)
    return dispatch_group<__nv_bfloat16, 128>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  if (dtype == 1 && head_dim == 96)
    return dispatch_group<__nv_bfloat16, 96>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  if (dtype == 1 && head_dim == 256)
    return dispatch_group<__nv_bfloat16, 256>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  if (dtype == 0 && head_dim == 64)
    return dispatch_group<__half, 64>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  if (dtype == 0 && head_dim == 128)
    return dispatch_group<__half, 128>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  if (dtype == 0 && head_dim == 96)
    return dispatch_group<__half, 96>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  if (dtype == 0 && head_dim == 256)
    return dispatch_group<__half, 256>(G, q, kp, vp, block_tables, pos, bias, slopes, out, part, scale, B, H, KV, bs, nmax, st);
  return (int)cudaErrorInvalidValue;
}
