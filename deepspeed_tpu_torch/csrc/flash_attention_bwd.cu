// Flash-attention backward for Hopper (sm_90a): the port of the TPU kernels
// deepspeed_tpu/ops/pallas/flash_attention.py _dq_kernel (K1 dq) and
// _dkv_kernel (K1 dkv), and of their packed-heads twins _packed_dq_kernel /
// _packed_dkv_kernel (K2, MHA at Hd < 128): both kernels here read
// q/do [B,S,H,Hd] and k/v [B,S,KV,Hd] in place, so one pair serves every
// call site. The forward (flash_attention_fwd.cu) saved o and the log2-domain
// lse; p is recomputed as exp2(s - lse), so no S x S tensor is ever stored.
//
// flash_bwd_dq_kernel (kernel C): one CTA of 4 warps per (64-row q tile,
// query head, batch row). Each warp keeps its 16 q rows and 16 do rows as
// mma.sync A fragments (loaded once) and streams 64-key k/v tiles through
// shared memory up to the causal diagonal, 16 keys at a time:
//   s  = q k^T * scale * log2e + bias,  p = exp2(s - lse)
//   dp = do v^T,  ds = p * (dp - delta) * scale   (rounded to k's dtype)
//   dq += ds k                                     (fp32 registers)
// ds is re-packed from the accumulators straight into A fragments.
//
// flash_bwd_dkv_kernel (kernel D): one CTA of 4 warps per (64-row k tile,
// kv head, batch row). The k and v tiles stay in shared memory for the whole
// CTA; the loop runs over the G query heads of the kv group and, for each,
// over the q tiles from the causal diagonal down, with q/do tiles and the
// tile's lse/delta streamed through shared memory. Each warp owns 16 keys
// and computes S^T = k q^T directly (keys as rows), so p^T and ds^T come out
// of the accumulators already in A-fragment order:
//   p^T rounded to do's dtype;  dv += p^T do
//   ds^T = p^T * (dp^T - delta) * scale, rounded to q's dtype;  dk += ds^T q
// dk and dv sum over the whole group inside the CTA: no atomics, and each
// dq tile is written once by C, so the gradients repeat bit for bit from run
// to run.
//
// Rounding points are the TPU kernels': in dq, p stays fp32 and ds is cast
// to k's dtype (_dq_kernel :205); in dkv, p is cast to do's dtype and that
// rounded p feeds both p^T do and ds, which is cast to q's dtype
// (_dkv_kernel :246-251). Every product accumulates in fp32.
//
// Bound on the H100: at training lengths (S = 2048, Hd = 128) the backward is
// compute-bound (C does 3 and D 4 causal S x S x Hd products against 2 bytes
// per element of q/k/v/do/dq/dk/dv). This simple design keeps the products
// on the tensor cores (mma.sync) and never writes an S x S tile; wgmma, TMA
// and a pipelined k/v ring are later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // q rows per tile (4 warps x 16)
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dO, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ mask,
                    const float* __restrict__ slopes, T* __restrict__ dq, int S, int H, int KV,
                    int causal, float scale_log2, float scale) {
  constexpr int PITCH = HD + 8;   // shared row pitch in elements: staggers banks
  __shared__ __align__(16) T ks[kBK * PITCH];
  __shared__ __align__(16) T vs[kBK * PITCH];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBQ;
  const long q_stride = (long)H * HD;
  const long kv_stride = (long)KV * HD;
  const long qoff = (long)b * S * q_stride + (long)h * HD;
  const T* kb = k + (long)b * S * kv_stride + (long)kvh * HD;
  const T* vb = v + (long)b * S * kv_stride + (long)kvh * HD;

  // stage the q and do tiles through ks / vs; keep this warp's rows as A fragments
  ds::load_tile<T, HD, PITCH, kBQ, kThreads>(ks, q + qoff, q0, S, q_stride, tid);
  ds::load_tile<T, HD, PITCH, kBQ, kThreads>(vs, dO + qoff, q0, S, q_stride, tid);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qf[HD / 16][4], df[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int o = r0 * PITCH + kk * 16 + 2 * t;
    qf[kk][0] = ds::ld32(ks + o);
    qf[kk][1] = ds::ld32(ks + o + 8 * PITCH);
    qf[kk][2] = ds::ld32(ks + o + 8);
    qf[kk][3] = ds::ld32(ks + o + 8 * PITCH + 8);
    df[kk][0] = ds::ld32(vs + o);
    df[kk][1] = ds::ld32(vs + o + 8 * PITCH);
    df[kk][2] = ds::ld32(vs + o + 8);
    df[kk][3] = ds::ld32(vs + o + 8 * PITCH + 8);
  }
  __syncthreads();

  float acc[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const bool in = qpos[row] < S;
    const long i = ((long)b * H + h) * S + qpos[row];
    lse_r[row] = in ? lse[i] : -ds::kMasked;     // rows past S get p = 0
    delta_r[row] = in ? delta[i] : 0.f;
  }
  const float slope = slopes ? slopes[h] * ds::kLog2e : 0.f;
  const float* maskb = mask ? mask + (long)b * S : nullptr;

  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    ds::load_tile<T, HD, PITCH, kBK, kThreads>(ks, kb, k0, S, kv_stride, tid);
    ds::load_tile<T, HD, PITCH, kBK, kThreads>(vs, vb, k0, S, kv_stride, tid);
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {       // 16 keys at a time
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        const int o = (c * 16 + j * 8 + g) * PITCH + 2 * t;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t bk[2] = {ds::ld32(ks + o + kk * 16), ds::ld32(ks + o + kk * 16 + 8)};
          ds::mma16816<T>(s[j], qf[kk], bk);
          uint32_t bv[2] = {ds::ld32(vs + o + kk * 16), ds::ld32(vs + o + kk * 16 + 8)};
          ds::mma16816<T>(dp[j], df[kk], bv);
        }
      }
      // ds = p * (dp - delta) * scale, p = exp2(s - lse) in fp32
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e >> 1;
          const int kpos = k0 + c * 16 + j * 8 + 2 * t + (e & 1);
          const float x = s[j][e] * scale_log2 +
                          ds::attn_bias(qpos[row], kpos, S, causal, slope, maskb);
          const float p = exp2f(x - lse_r[row]);
          s[j][e] = p * (dp[j][e] - delta_r[row]) * scale;
        }
      }
      // dq += ds k: ds (16 q x 16 keys, rounded to T) from the accumulators
      uint32_t pa[4];
      pa[0] = ds::pack_f32<T>(s[0][0], s[0][1]);
      pa[1] = ds::pack_f32<T>(s[0][2], s[0][3]);
      pa[2] = ds::pack_f32<T>(s[1][0], s[1][1]);
      pa[3] = ds::pack_f32<T>(s[1][2], s[1][3]);
      const T* kr = ks + (c * 16 + 2 * t) * PITCH + g;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        const T* kd = kr + d * 8;
        uint32_t bf[2] = {ds::pack_raw<T>(kd[0], kd[PITCH]),
                          ds::pack_raw<T>(kd[8 * PITCH], kd[9 * PITCH])};
        ds::mma16816<T>(acc[d], pa, bf);
      }
    }
    __syncthreads();   // the next tile overwrites ks / vs
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int sq = qpos[row];
    if (sq >= S) continue;
    T* out = dq + ((long)b * S + sq) * q_stride + (long)h * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(out + d * 8) =
          ds::pack_f32<T>(acc[d][2 * row], acc[d][2 * row + 1]);
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ds::to_float(ds::from_float<T>(x));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dO, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ mask,
                     const float* __restrict__ slopes, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, int KV, int causal, float scale_log2, float scale) {
  constexpr int PITCH = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);        // [kBK, PITCH], fixed for the CTA
  T* vs = ks + kBK * PITCH;
  T* qs = vs + kBK * PITCH;                  // [kBQ, PITCH], one q tile at a time
  T* dos = qs + kBQ * PITCH;
  float* lse_s = reinterpret_cast<float*>(dos + kBQ * PITCH);   // [kBQ]
  float* delta_s = lse_s + kBQ;

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kBK;
  const long q_stride = (long)H * HD;
  const long kv_stride = (long)KV * HD;
  const long kvoff = (long)b * S * kv_stride + (long)kvh * HD;

  ds::load_tile<T, HD, PITCH, kBK, kThreads>(ks, k + kvoff, k0, S, kv_stride, tid);
  ds::load_tile<T, HD, PITCH, kBK, kThreads>(vs, v + kvoff, k0, S, kv_stride, tid);

  const int r0 = warp * 16 + g;                 // this thread's key rows r0, r0 + 8
  const int kpos[2] = {k0 + r0, k0 + r0 + 8};
  const float* maskb = mask ? mask + (long)b * S : nullptr;

  float adk[HD / 8][4], adv[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    adk[d][0] = adk[d][1] = adk[d][2] = adk[d][3] = 0.f;
    adv[d][0] = adv[d][1] = adv[d][2] = adv[d][3] = 0.f;
  }
  const int nq = (S + kBQ - 1) / kBQ;
  const int qt0 = causal ? k0 / kBQ : 0;        // q tiles from the diagonal down

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float slope = slopes ? slopes[h] * ds::kLog2e : 0.f;
    const long qoff = (long)b * S * q_stride + (long)h * HD;
    const long row_off = ((long)b * H + h) * S;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();   // every warp is done with the previous q / do tile
      ds::load_tile<T, HD, PITCH, kBQ, kThreads>(qs, q + qoff, q0, S, q_stride, tid);
      ds::load_tile<T, HD, PITCH, kBQ, kThreads>(dos, dO + qoff, q0, S, q_stride, tid);
      for (int i = tid; i < kBQ; i += kThreads) {
        const bool in = q0 + i < S;
        lse_s[i] = in ? lse[row_off + q0 + i] : -ds::kMasked;   // rows past S: p = 0
        delta_s[i] = in ? delta[row_off + q0 + i] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int c = 0; c < kBQ / 16; ++c) {     // 16 q rows at a time
        // S^T = k q^T and dP^T = v do^T for this warp's 16 keys x 16 q rows
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
          dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int ao = r0 * PITCH + kk * 16 + 2 * t;
          uint32_t ka[4] = {ds::ld32(ks + ao), ds::ld32(ks + ao + 8 * PITCH),
                            ds::ld32(ks + ao + 8), ds::ld32(ks + ao + 8 * PITCH + 8)};
          uint32_t va[4] = {ds::ld32(vs + ao), ds::ld32(vs + ao + 8 * PITCH),
                            ds::ld32(vs + ao + 8), ds::ld32(vs + ao + 8 * PITCH + 8)};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int bo = (c * 16 + j * 8 + g) * PITCH + kk * 16 + 2 * t;
            uint32_t bq[2] = {ds::ld32(qs + bo), ds::ld32(qs + bo + 8)};
            ds::mma16816<T>(st[j], ka, bq);
            uint32_t bd[2] = {ds::ld32(dos + bo), ds::ld32(dos + bo + 8)};
            ds::mma16816<T>(dpt[j], va, bd);
          }
        }
        // p^T rounded to do's dtype; ds^T = p^T (dp^T - delta) scale
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e >> 1;
            const int qi = c * 16 + j * 8 + 2 * t + (e & 1);
            const float x = st[j][e] * scale_log2 +
                            ds::attn_bias(q0 + qi, kpos[row], S, causal, slope, maskb);
            const float p = round_to<T>(exp2f(x - lse_s[qi]));
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - delta_s[qi]) * scale;
          }
        }
        uint32_t pa[4], da[4];
        pa[0] = ds::pack_f32<T>(st[0][0], st[0][1]);
        pa[1] = ds::pack_f32<T>(st[0][2], st[0][3]);
        pa[2] = ds::pack_f32<T>(st[1][0], st[1][1]);
        pa[3] = ds::pack_f32<T>(st[1][2], st[1][3]);
        da[0] = ds::pack_f32<T>(dpt[0][0], dpt[0][1]);
        da[1] = ds::pack_f32<T>(dpt[0][2], dpt[0][3]);
        da[2] = ds::pack_f32<T>(dpt[1][0], dpt[1][1]);
        da[3] = ds::pack_f32<T>(dpt[1][2], dpt[1][3]);
        // dv += p^T do, dk += ds^T q over these 16 q rows
        const int ro = (c * 16 + 2 * t) * PITCH + g;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const T* dd = dos + ro + d * 8;
          uint32_t bdo[2] = {ds::pack_raw<T>(dd[0], dd[PITCH]),
                             ds::pack_raw<T>(dd[8 * PITCH], dd[9 * PITCH])};
          ds::mma16816<T>(adv[d], pa, bdo);
          const T* qd = qs + ro + d * 8;
          uint32_t bqq[2] = {ds::pack_raw<T>(qd[0], qd[PITCH]),
                             ds::pack_raw<T>(qd[8 * PITCH], qd[9 * PITCH])};
          ds::mma16816<T>(adk[d], da, bqq);
        }
      }
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (kpos[row] >= S) continue;
    const long o = ((long)b * S + kpos[row]) * kv_stride + (long)kvh * HD + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      *reinterpret_cast<uint32_t*>(dk + o + d * 8) =
          ds::pack_f32<T>(adk[d][2 * row], adk[d][2 * row + 1]);
      *reinterpret_cast<uint32_t*>(dv + o + d * 8) =
          ds::pack_f32<T>(adv[d][2 * row], adv[d][2 * row + 1]);
    }
  }
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dO, const float* lse,
              const float* delta, const float* mask, const float* slopes, void* dq, int B,
              int S, int H, int KV, int causal, float scale_log2, float scale,
              cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), lse, delta, mask, slopes, static_cast<T*>(dq), S, H, KV,
      causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO, const float* lse,
               const float* delta, const float* mask, const float* slopes, void* dk, void* dv,
               int B, int S, int H, int KV, int causal, float scale_log2, float scale,
               cudaStream_t stream) {
  constexpr int PITCH = HD + 8;
  constexpr int smem = (2 * kBK + 2 * kBQ) * PITCH * (int)sizeof(T) + 2 * kBQ * (int)sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBK - 1) / kBK, KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), lse, delta, mask, slopes, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, KV, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/do/dq [B,S,H,Hd], k/v [B,S,KV,Hd] contiguous; lse/delta [B,H,S] f32
// (lse log2-domain, as the forward wrote it; delta = sum(do * o) over Hd);
// mask [B,S] f32 additive key bias or null; slopes [H] f32 or null.
// scale_log2 = scale * log2(e). dtype 0 = fp16, 1 = bf16; head_dim 64 or
// 128. Each returns cudaGetLastError() after its launch.
extern "C" int ds_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                         const void* dO, const float* lse, const float* delta,
                                         const float* mask, const float* slopes, void* dq,
                                         int B, int S, int H, int KV, int head_dim, int causal,
                                         float scale_log2, float scale, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_DQ(T, HD) launch_dq<T, HD>(q, k, v, dO, lse, delta, mask, slopes, dq, B, S, H, KV, \
                                      causal, scale_log2, scale, st)
  if (dtype == 1 && head_dim == 128) return DS_DQ(__nv_bfloat16, 128);
  if (dtype == 1 && head_dim == 64) return DS_DQ(__nv_bfloat16, 64);
  if (dtype == 0 && head_dim == 128) return DS_DQ(__half, 128);
  if (dtype == 0 && head_dim == 64) return DS_DQ(__half, 64);
#undef DS_DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int ds_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                          const void* dO, const float* lse,
                                          const float* delta, const float* mask,
                                          const float* slopes, void* dk, void* dv, int B, int S,
                                          int H, int KV, int head_dim, int causal,
                                          float scale_log2, float scale, int dtype,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_DKV(T, HD) launch_dkv<T, HD>(q, k, v, dO, lse, delta, mask, slopes, dk, dv, B, S, \
                                        H, KV, causal, scale_log2, scale, st)
  if (dtype == 1 && head_dim == 128) return DS_DKV(__nv_bfloat16, 128);
  if (dtype == 1 && head_dim == 64) return DS_DKV(__nv_bfloat16, 64);
  if (dtype == 0 && head_dim == 128) return DS_DKV(__half, 128);
  if (dtype == 0 && head_dim == 64) return DS_DKV(__half, 64);
#undef DS_DKV
  return (int)cudaErrorInvalidValue;
}
