// The device body shared by the two decode-attention kernels: the paged one
// (paged_decode_attention.cu, kernel B, TPU K6) and the dense one
// (dense_decode_attention.cu, TPU K5). Both attend one new query token per
// batch row against its cached keys, walked in blocks of ``bs`` key rows;
// they differ only in where block j of a row lives, which the ``Blocks``
// functor answers (an element offset into the k / v cache):
//   paged: block_tables[b, j] * bs * KV * Hd   (a pool shared by every row)
//   dense: (b * Smax + j * bs) * KV * Hd       (the row's own [Smax, KV, Hd])
//
// Layout: one CTA of 128 threads per (kv head, batch row). It computes all
// G = H / KV query heads of the kv group at once, so each K/V block is read
// from device memory once per group, as the TPU kernels do, and it walks only
// the live blocks j <= pos / bs; inside the last one the keys past pos are
// masked with -1e30. Per block: each thread scores one key row against the G
// (pre-scaled) query vectors held in shared memory; one warp per head folds
// the block into the fp32 running max / sum (natural exp, as the TPU
// kernels); then the threads split the head dim in pairs and the keys in
// lanes to accumulate P V in fp32 registers, reduced across key lanes at the
// end. ALiBi and the additive pad bias apply over LOGICAL positions
// (j * bs + offset).
#pragma once

#include "common.cuh"

namespace ds {

constexpr int kDecodeThreads = 128;

// Dynamic shared memory of one CTA, in bytes.
template <int HD, int G>
constexpr size_t decode_smem_bytes(int bs) {
  constexpr int NKL = kDecodeThreads / (HD / 2);
  return sizeof(float) * ((size_t)G * HD + (size_t)G * bs + (size_t)NKL * G * HD + 3 * G);
}

// q_row: this row's [H, HD] query (pre-scaled); kc / vc: the caches offset to
// this kv head (element kvh * HD of slot 0); bias_row: this row's logical
// pad bias or null; out_row: this row's [H, HD] output.
template <typename T, int HD, int G, class Blocks>
__device__ __forceinline__ void decode_attention(const T* __restrict__ q_row,
                                                 const T* __restrict__ kc,
                                                 const T* __restrict__ vc, const Blocks& blocks,
                                                 int bs, long slot_stride, int n_live, int pos,
                                                 const float* __restrict__ bias_row,
                                                 const float* __restrict__ slopes, int kvh,
                                                 T* __restrict__ out_row, float* smem) {
  constexpr int kThreads = kDecodeThreads;
  constexpr int kWarps = kThreads / 32;
  constexpr int DP = HD / 2;             // threads per key lane in the P V phase
  constexpr int NKL = kThreads / DP;     // key lanes
  float* q_s = smem;                     // [G][HD]  pre-scaled query, fp32
  float* p_s = q_s + G * HD;             // [G][bs]  block scores, then probabilities
  float* red = p_s + G * bs;             // [NKL][G][HD] key-lane partial outputs
  float* m_s = red + NKL * G * HD;       // [G] running max, sum, rescale
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qg = q_row + (long)kvh * G * HD;
  for (int i = tid; i < G * HD; i += kThreads) q_s[i] = to_float(qg[i]);
  if (tid < G) { m_s[tid] = kMasked; l_s[tid] = 0.f; }

  const int dp = tid % DP, kl = tid / DP;
  float acc[G][2];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) acc[gg][0] = acc[gg][1] = 0.f;
  __syncthreads();

  for (int j = 0; j < n_live; ++j) {
    const long off = blocks(j);
    const T* kblk = kc + off;
    const T* vblk = vc + off;

    // scores of this block: one key row per thread, G dot products
    for (int r = tid; r < bs; r += kThreads) {
      const int kpos = j * bs + r;
      float dot[G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) dot[gg] = 0.f;
      const T* krow = kblk + r * slot_stride;
#pragma unroll 4
      for (int c = 0; c < HD; c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float kf = to_float(e[u]);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) dot[gg] += q_s[gg * HD + c + u] * kf;
        }
      }
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        float s = dot[gg];
        if (slopes != nullptr) s += slopes[kvh * G + gg] * (float)(kpos - pos);
        if (bias_row != nullptr) s += bias_row[kpos];
        p_s[gg * bs + r] = kpos <= pos ? s : kMasked;
      }
    }
    __syncthreads();

    // fold the block into each head's running max / sum; p_s becomes p
    for (int gg = warp; gg < G; gg += kWarps) {
      float* row = p_s + gg * bs;
      float mx = kMasked;
      for (int r = lane; r < bs; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_s[gg], mx);
      float sum = 0.f;
      for (int r = lane; r < bs; r += 32) {
        const float p = expf(row[r] - m_new);
        row[r] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_s[gg] - m_new);
        alpha_s[gg] = alpha;
        l_s[gg] = l_s[gg] * alpha + sum;
        m_s[gg] = m_new;
      }
    }
    __syncthreads();

    // acc += P V over this block's keys (dims 2*dp, 2*dp+1; keys kl::NKL)
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      acc[gg][0] *= alpha_s[gg];
      acc[gg][1] *= alpha_s[gg];
    }
    for (int r = kl; r < bs; r += NKL) {
      const T* vrow = vblk + r * slot_stride + 2 * dp;
      const float v0 = to_float(vrow[0]), v1 = to_float(vrow[1]);
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        const float p = p_s[gg * bs + r];
        acc[gg][0] += p * v0;
        acc[gg][1] += p * v1;
      }
    }
    __syncthreads();   // the next block overwrites p_s
  }

#pragma unroll
  for (int gg = 0; gg < G; ++gg) {
    red[(kl * G + gg) * HD + 2 * dp] = acc[gg][0];
    red[(kl * G + gg) * HD + 2 * dp + 1] = acc[gg][1];
  }
  __syncthreads();
  T* ob = out_row + (long)kvh * G * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int gg = i / HD, d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int lk = 0; lk < NKL; ++lk) sum += red[(lk * G + gg) * HD + d];
    ob[i] = from_float<T>(sum / l_s[gg]);
  }
}

}  // namespace ds
