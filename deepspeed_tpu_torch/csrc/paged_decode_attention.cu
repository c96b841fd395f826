// Paged decode attention for Hopper (sm_90a): the port of the TPU kernel
// deepspeed_tpu/ops/pallas/paged_decode_attention.py _kernel (K6). One new
// query token per request attends its cached keys through a block table
// over a pool shared by every request: k/v pools [num_blocks, bs, KV, Hd],
// block_tables [B, nmax] int32, per-request positions pos [B] int32.
//
// Layout: one CTA of 128 threads per (kv head, request). It computes all
// G = H / KV query heads of the kv group at once, so each K/V block is read
// from device memory once per group, as the TPU kernel does. The CTA reads
// block_tables[b, j] itself and walks only the live blocks
// j <= pos[b] / bs; inside the last one the keys past pos[b] are masked.
// Per block: each thread scores one key row against the G (pre-scaled) query
// vectors held in shared memory; one warp per head folds the block into the
// fp32 running max / sum (natural exp, as the TPU kernel); then the threads
// split the head dim in pairs and the keys in lanes to accumulate P V in
// fp32 registers, reduced across key lanes at the end. ALiBi and the
// additive pad bias apply over LOGICAL positions (j * bs + offset).
//
// Bound on the H100: a decode step moves every live K/V byte once and does
// 4 * G FLOPs per 4 bytes of K/V, far below the bf16 ridge (about 295
// FLOP/byte), so it is bound by the live K/V bytes over 3.35 TB/s. The
// simple design reads each live byte once per kv group with 16-byte vector
// loads for K and coalesced row reads for V, and skips dead blocks; it does
// no split over the sequence (one CTA walks a request's whole history),
// which is the first thing to change when it is made fast.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ block_tables, const int* __restrict__ pos_arr,
                    const float* __restrict__ bias, const float* __restrict__ slopes,
                    T* __restrict__ out, int H, int KV, int bs, int nmax) {
  constexpr int DP = HD / 2;             // threads per key lane in the P V phase
  constexpr int NKL = kThreads / DP;     // key lanes
  extern __shared__ float smem[];
  float* q_s = smem;                     // [G][HD]  pre-scaled query, fp32
  float* p_s = q_s + G * HD;             // [G][bs]  block scores, then probabilities
  float* red = p_s + G * bs;             // [NKL][G][HD] key-lane partial outputs
  __shared__ float m_s[G], l_s[G], alpha_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = pos_arr[b];
  const int n_live = min(pos / bs + 1, nmax);
  const long slot_stride = (long)KV * HD;      // elements between slots of a block
  const int* table = block_tables + (long)b * nmax;
  const float* bias_b = bias ? bias + (long)b * nmax * bs : nullptr;

  const T* qg = q + ((long)b * H + (long)kvh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) q_s[i] = ds::to_float(qg[i]);
  if (tid < G) { m_s[tid] = ds::kMasked; l_s[tid] = 0.f; }

  const int dp = tid % DP, kl = tid / DP;
  float acc[G][2];
#pragma unroll
  for (int gg = 0; gg < G; ++gg) acc[gg][0] = acc[gg][1] = 0.f;
  __syncthreads();

  for (int j = 0; j < n_live; ++j) {
    const long blk = table[j];
    const T* kblk = kp + blk * bs * slot_stride + (long)kvh * HD;
    const T* vblk = vp + blk * bs * slot_stride + (long)kvh * HD;

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
          const float kf = ds::to_float(e[u]);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) dot[gg] += q_s[gg * HD + c + u] * kf;
        }
      }
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        float s = dot[gg];
        if (slopes != nullptr) s += slopes[kvh * G + gg] * (float)(kpos - pos);
        if (bias_b != nullptr) s += bias_b[kpos];
        p_s[gg * bs + r] = kpos <= pos ? s : ds::kMasked;
      }
    }
    __syncthreads();

    // fold the block into each head's running max / sum; p_s becomes p
    for (int gg = warp; gg < G; gg += kWarps) {
      float* row = p_s + gg * bs;
      float mx = ds::kMasked;
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
      const float v0 = ds::to_float(vrow[0]), v1 = ds::to_float(vrow[1]);
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
  T* ob = out + ((long)b * H + (long)kvh * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) {
    const int gg = i / HD, d = i % HD;
    float sum = 0.f;
#pragma unroll
    for (int lk = 0; lk < NKL; ++lk) sum += red[(lk * G + gg) * HD + d];
    ob[i] = ds::from_float<T>(sum / l_s[gg]);
  }
}

template <typename T, int HD, int G>
int launch(const void* q, const void* kp, const void* vp, const int* bt, const int* pos,
           const float* bias, const float* slopes, void* out, int B, int H, int KV, int bs,
           int nmax, cudaStream_t stream) {
  constexpr int NKL = kThreads / (HD / 2);
  const size_t smem = sizeof(float) * ((size_t)G * HD + (size_t)G * bs + (size_t)NKL * G * HD);
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
