// Dense decode attention for Hopper (sm_90a): the port of the TPU kernel
// deepspeed_tpu/ops/pallas/decode_attention.py _kernel (K5). One new query
// token per batch row attends a dense KV workspace ck / cv [B, Smax, KV, Hd]
// (static generate's cache), with ONE position pos for the whole batch:
// keys past pos are masked with -1e30; an optional pad bias [B, Smax] f32
// and ALiBi slopes [H] apply over key positions.
//
// The TPU grid walked (row, 512/256/128-key block) with the running softmax
// in VMEM and a clamped index map so dead tail blocks cost no DMA. Here one
// CTA of 128 threads serves one (kv head, batch row) with all G = H / KV
// query heads and loops over 128-key blocks up to pos / 128 only; the loop
// body is decode_attention.cuh, shared with the paged kernel (B, TPU K6),
// which differs only in where a block lives. pos is a host int: the decode
// loop knows it, so the launch needs no device sync.
//
// Bound on the H100: a decode step reads every live K/V byte once and does
// 4 * G FLOPs per 4 bytes of K/V, far below the bf16 ridge (about 295
// FLOP/byte), so it is bound by the live K/V bytes over 3.35 TB/s (at the
// static-generate shape, 8 rows x 576 keys x 32 heads x 128 x 2 x 2 B =
// 75.5 MB, about 22.5 us). The simple design reads each live byte once per
// kv group and skips the dead tail; with KV x B CTAs (256 at Llama-7B, B 8)
// and no split of the keys over CTAs, it is the split that makes it fast.
#include "decode_attention.cuh"

namespace {

constexpr int kThreads = ds::kDecodeThreads;
constexpr int kBlock = 128;        // keys per block (the envelope's Smax % 128)

// Block j of row b starts at slot b * Smax + j * kBlock of the workspace.
struct DenseBlocks {
  long row_base;          // element offset of row b's slot 0
  long block_stride;      // elements between blocks of a row
  __device__ long operator()(int j) const { return row_base + (long)j * block_stride; }
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ ck, const T* __restrict__ cv,
                    const float* __restrict__ bias, const float* __restrict__ slopes,
                    T* __restrict__ out, int H, int KV, int smax, int pos) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const long slot_stride = (long)KV * HD;
  const DenseBlocks blocks{(long)b * smax * slot_stride, kBlock * slot_stride};
  ds::decode_attention<T, HD, G>(q + (long)b * H * HD, ck + (long)kvh * HD,
                                 cv + (long)kvh * HD, blocks, kBlock, slot_stride,
                                 min(pos / kBlock + 1, smax / kBlock), pos,
                                 bias ? bias + (long)b * smax : nullptr, slopes, kvh,
                                 out + (long)b * H * HD, smem);
}

template <typename T, int HD, int G>
int launch(const void* q, const void* ck, const void* cv, const float* bias,
           const float* slopes, void* out, int B, int H, int KV, int smax, int pos,
           cudaStream_t stream) {
  const size_t smem = ds::decode_smem_bytes<HD, G>(kBlock);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(KV, B);
  dense_decode_kernel<T, HD, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv), bias,
      slopes, static_cast<T*>(out), H, KV, smax, pos);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_group(int G, const void* q, const void* ck, const void* cv, const float* bias,
                   const float* slopes, void* out, int B, int H, int KV, int smax, int pos,
                   cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, HD, 1>(q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
    case 2: return launch<T, HD, 2>(q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
    case 4: return launch<T, HD, 4>(q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
    case 8: return launch<T, HD, 8>(q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Hd] already multiplied by the softmax scale; ck/cv [B,Smax,KV,Hd]
// with the new k/v written at pos; bias [B,Smax] f32 or null; slopes [H] f32
// or null; out [B,H,Hd]; 0 <= pos < Smax, Smax % 128 == 0. dtype 0 = fp16,
// 1 = bf16; head_dim 64 or 128; H / KV in {1, 2, 4, 8}. Returns
// cudaGetLastError().
extern "C" int ds_dense_decode_attention(const void* q, const void* ck, const void* cv,
                                         const float* bias, const float* slopes, void* out,
                                         int B, int H, int KV, int head_dim, int smax, int pos,
                                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (pos < 0 || pos >= smax || smax % kBlock != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 64)
    return dispatch_group<__nv_bfloat16, 64>(G, q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
  if (dtype == 1 && head_dim == 128)
    return dispatch_group<__nv_bfloat16, 128>(G, q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
  if (dtype == 0 && head_dim == 64)
    return dispatch_group<__half, 64>(G, q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
  if (dtype == 0 && head_dim == 128)
    return dispatch_group<__half, 128>(G, q, ck, cv, bias, slopes, out, B, H, KV, smax, pos, st);
  return (int)cudaErrorInvalidValue;
}
