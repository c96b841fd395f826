// Flash-attention forward for Hopper (sm_90a): the port of the TPU kernels
// deepspeed_tpu/ops/pallas/flash_attention.py _fwd_kernel (general, K1) and
// _packed_fwd_kernel (packed heads for Hd < 128, K2). One kernel serves
// both: it reads q [B,S,H,Hd] and k/v [B,S,KV,Hd] in place, so the TPU's
// lane packing has no counterpart here.
//
// Layout: one CTA of 4 warps per (64-row q tile, head, batch row). Each warp
// owns 16 q rows as mma.sync A fragments (loaded once) and streams 64-key
// k/v tiles through shared memory up to the causal diagonal. The running
// max, running sum and the [16, Hd] output accumulator stay in fp32
// registers; S = Q K^T and O += P V are bf16/fp16 m16n8k16 tensor-core
// products, and P is re-packed from the S accumulators straight into A
// fragments (no shared-memory round trip). The softmax runs in the log2
// domain with the TPU kernel's conventions: logits scaled by scale*log2(e),
// masked entries set to -1e30, exp2, lse written as m + log2(l) (+1e30 for a
// row with no mass) so the backward slice can recompute p from it.
//
// Bound on the H100: at prefill lengths (S <= 2048, Hd = 128) attention does
// 2*S*Hd/2 causal FLOPs per q row against 8*Hd bytes of q/k/v/o per token,
// which puts it near the ridge (about 295 FLOP/byte for bf16) only at
// S ~ 1000; shorter prompts are memory-bound on the q/k/v/o bytes. The
// simple design reads each q tile once, each k/v tile once per q tile (so
// k/v are re-read S/64 times, from L2 in practice) and never writes the
// S x S scores; making it fast (wgmma, TMA, a k/v pipeline) is later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per CTA (4 warps x 16)
constexpr int kBK = 64;        // keys per k/v tile
constexpr int kThreads = 128;

template <typename T, int HD, int PITCH>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int S,
                                          long row_stride, int tid) {
  ds::load_tile<T, HD, PITCH, kBK, kThreads>(dst, src, row0, S, row_stride, tid);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse,
                 const float* __restrict__ mask, const float* __restrict__ slopes,
                 int S, int H, int KV, int causal, float scale_log2) {
  constexpr int PITCH = HD + 8;   // shared row pitch in elements: staggers banks
  __shared__ __align__(16) T ks[kBK * PITCH];
  __shared__ __align__(16) T vs[kBK * PITCH];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);                 // GQA: kv head h // G
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBQ;
  const long q_stride = (long)H * HD;           // elements between positions
  const long kv_stride = (long)KV * HD;
  const T* qb = q + (long)b * S * q_stride + (long)h * HD;
  const T* kb = k + (long)b * S * kv_stride + (long)kvh * HD;
  const T* vb = v + (long)b * S * kv_stride + (long)kvh * HD;

  // stage the q tile through ks and keep this warp's 16 rows as A fragments
  load_tile<T, HD, PITCH>(ks, qb, q0, S, q_stride, tid);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const T* base = ks + r0 * PITCH + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * PITCH);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * PITCH + 8);
  }
  __syncthreads();

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {ds::kMasked, ds::kMasked}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  const float slope = slopes ? slopes[h] * ds::kLog2e : 0.f;
  const float* maskb = mask ? mask + (long)b * S : nullptr;

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);   // tiles up to the diagonal

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    load_tile<T, HD, PITCH>(ks, kb, k0, S, kv_stride, tid);
    load_tile<T, HD, PITCH>(vs, vb, k0, S, kv_stride, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const T* kr = ks + (nt * 8 + g) * PITCH + kk * 16 + 2 * t;
        uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr),
                          *reinterpret_cast<const uint32_t*>(kr + 8)};
        ds::mma16816<T>(s[nt], qf[kk], bf);
      }
    }

    // log2-domain logits + bias: alibi, causal / out-of-range mask, key mask
    float rowmax[2] = {ds::kMasked, ds::kMasked};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = s[nt][e] * scale_log2 +
                        ds::attn_bias(qpos[row], kpos, S, causal, slope, maskb);
        s[nt][e] = x;
        rowmax[row] = fmaxf(rowmax[row], x);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      rowmax[row] = fmaxf(rowmax[row], __shfl_xor_sync(0xffffffffu, rowmax[row], 1));
      rowmax[row] = fmaxf(rowmax[row], __shfl_xor_sync(0xffffffffu, rowmax[row], 2));
      const float m_new = fmaxf(m[row], rowmax[row]);
      alpha[row] = exp2f(m[row] - m_new);
      m[row] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        rowsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      rowsum[row] += __shfl_xor_sync(0xffffffffu, rowsum[row], 1);
      rowsum[row] += __shfl_xor_sync(0xffffffffu, rowsum[row], 2);
      l[row] = l[row] * alpha[row] + rowsum[row];
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[d][0] *= alpha[0]; acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1]; acc[d][3] *= alpha[1];
    }

    // O += P V: P (16 x 64, rounded to T as the TPU kernel casts p to v's
    // dtype) comes straight from the S accumulators in A-fragment order
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = ds::pack_f32<T>(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = ds::pack_f32<T>(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = ds::pack_f32<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = ds::pack_f32<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* vr = vs + (kk * 16 + 2 * t) * PITCH + g;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const T* vd = vr + d * 8;
        uint32_t bf[2] = {ds::pack_raw<T>(vd[0], vd[PITCH]),
                          ds::pack_raw<T>(vd[8 * PITCH], vd[9 * PITCH])};
        ds::mma16816<T>(acc[d], pa, bf);
      }
    }
    __syncthreads();   // the next tile overwrites ks / vs
  }

  // epilogue: o = acc / l (l = 1 where a row has no mass), lse in log2 domain
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int sq = qpos[row];
    if (sq >= S) continue;
    const float inv = l[row] > 0.f ? 1.f / l[row] : 1.f;
    T* orow = o + ((long)b * S + sq) * q_stride + (long)h * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(orow + d * 8) =
          ds::pack_f32<T>(acc[d][2 * row] * inv, acc[d][2 * row + 1] * inv);
    if (t == 0)
      lse[((long)b * H + h) * S + sq] = l[row] > 0.f ? m[row] + log2f(l[row]) : -ds::kMasked;
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            const float* mask, const float* slopes, int B, int S, int H, int KV,
            int causal, float scale_log2, cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, mask, slopes, S, H, KV, causal, scale_log2);
}

}  // namespace

// q/o [B,S,H,Hd], k/v [B,S,KV,Hd] contiguous; lse [B,H,S] f32; mask [B,S]
// f32 additive key bias or null; slopes [H] f32 or null. dtype 0 = fp16,
// 1 = bf16; head_dim 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const float* mask, const float* slopes,
                                      int B, int S, int H, int KV, int head_dim, int causal,
                                      float scale_log2, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && head_dim == 64)
    launch<__nv_bfloat16, 64>(q, k, v, o, lse, mask, slopes, B, S, H, KV, causal, scale_log2, st);
  else if (dtype == 1 && head_dim == 128)
    launch<__nv_bfloat16, 128>(q, k, v, o, lse, mask, slopes, B, S, H, KV, causal, scale_log2, st);
  else if (dtype == 0 && head_dim == 64)
    launch<__half, 64>(q, k, v, o, lse, mask, slopes, B, S, H, KV, causal, scale_log2, st);
  else if (dtype == 0 && head_dim == 128)
    launch<__half, 128>(q, k, v, o, lse, mask, slopes, B, S, H, KV, causal, scale_log2, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
