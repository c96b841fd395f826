// Paged decode attention for Hopper (sm_90a): the port of the TPU kernel
// deepspeed_tpu/ops/pallas/paged_decode_attention.py _kernel (K6). One new
// query token per request attends its cached keys through a block table
// over a pool shared by every request: k/v pools [num_blocks, bs, KV, Hd],
// block_tables [B, nmax] int32, per-request positions pos [B] int32.
//
// The CTA reads block_tables[b, j] itself and walks only the live blocks
// j <= pos[b] / bs. Layout and per-block steps are in decode_attention.cuh,
// the device body this kernel shares with the dense one (TPU K5).
//
// Bound on the H100: a decode step moves every live K/V byte once and does
// 4 * G FLOPs per 4 bytes of K/V, far below the bf16 ridge (about 295
// FLOP/byte), so it is bound by the live K/V bytes over 3.35 TB/s. The
// simple design reads each live byte once per kv group with 16-byte vector
// loads for K and coalesced row reads for V, and skips dead blocks; it does
// no split over the sequence (one CTA walks a request's whole history),
// which is the first thing to change when it is made fast.
#include "decode_attention.cuh"

namespace {

constexpr int kThreads = ds::kDecodeThreads;

// Block j of a request lives at pool block block_tables[b, j].
struct PagedBlocks {
  const int* table;
  long block_stride;     // elements between pool blocks
  __device__ long operator()(int j) const { return (long)table[j] * block_stride; }
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ block_tables, const int* __restrict__ pos_arr,
                    const float* __restrict__ bias, const float* __restrict__ slopes,
                    T* __restrict__ out, int H, int KV, int bs, int nmax) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pos = pos_arr[b];
  const long slot_stride = (long)KV * HD;      // elements between slots of a block
  const PagedBlocks blocks{block_tables + (long)b * nmax, bs * slot_stride};
  ds::decode_attention<T, HD, G>(q + (long)b * H * HD, kp + (long)kvh * HD,
                                 vp + (long)kvh * HD, blocks, bs, slot_stride,
                                 min(pos / bs + 1, nmax), pos,
                                 bias ? bias + (long)b * nmax * bs : nullptr, slopes, kvh,
                                 out + (long)b * H * HD, smem);
}

template <typename T, int HD, int G>
int launch(const void* q, const void* kp, const void* vp, const int* bt, const int* pos,
           const float* bias, const float* slopes, void* out, int B, int H, int KV, int bs,
           int nmax, cudaStream_t stream) {
  const size_t smem = ds::decode_smem_bytes<HD, G>(bs);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(KV, B);
  paged_decode_kernel<T, HD, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, pos,
      bias, slopes, static_cast<T*>(out), H, KV, bs, nmax);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_group(int G, const void* q, const void* kp, const void* vp, const int* bt,
                   const int* pos, const float* bias, const float* slopes, void* out, int B,
                   int H, int KV, int bs, int nmax, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, kp, vp, bt, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
    case 2: return launch<T, HD, 2>(q, kp, vp, bt, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
    case 4: return launch<T, HD, 4>(q, kp, vp, bt, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
    case 8: return launch<T, HD, 8>(q, kp, vp, bt, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Hd] already multiplied by the softmax scale; pools [Nb,bs,KV,Hd];
// block_tables [B,nmax] int32; pos [B] int32; bias [B,nmax*bs] f32 or null;
// slopes [H] f32 or null; out [B,H,Hd]. dtype 0 = fp16, 1 = bf16; head_dim
// 64 or 128; H / KV in {1, 2, 4, 8}. Returns cudaGetLastError().
extern "C" int ds_paged_decode_attention(const void* q, const void* kp, const void* vp,
                                         const int* block_tables, const int* pos,
                                         const float* bias, const float* slopes, void* out,
                                         int B, int H, int KV, int head_dim, int bs, int nmax,
                                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (dtype == 1 && head_dim == 64)
    return dispatch_group<__nv_bfloat16, 64>(G, q, kp, vp, block_tables, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
  if (dtype == 1 && head_dim == 128)
    return dispatch_group<__nv_bfloat16, 128>(G, q, kp, vp, block_tables, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
  if (dtype == 0 && head_dim == 64)
    return dispatch_group<__half, 64>(G, q, kp, vp, block_tables, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
  if (dtype == 0 && head_dim == 128)
    return dispatch_group<__half, 128>(G, q, kp, vp, block_tables, pos, bias, slopes, out, B, H, KV, bs, nmax, st);
  return (int)cudaErrorInvalidValue;
}
