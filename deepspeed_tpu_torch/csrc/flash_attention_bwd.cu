// Flash-attention backward for Hopper (sm_90a): the port of the TPU kernels
// deepspeed_tpu/ops/pallas/flash_attention.py _dq_kernel (K1 dq) and
// _dkv_kernel (K1 dkv), and of their packed-heads twins _packed_dq_kernel /
// _packed_dkv_kernel (K2, MHA at Hd < 128): both kernels here read
// q/do [B,S,H,Hd] and k/v [B,S,KV,Hd] in place, so one pair serves every
// call site. The forward (flash_attention_fwd.cu) saved o and the log2-domain
// lse; p is recomputed as exp2(s - lse), so no S x S tensor is ever stored.
// Both kernels are warp-specialised on the Hopper pieces of
// wgmma_attention.cuh: three warpgroups, the third's first warp the
// producer (TMA through 3-D maps over (head columns, S, B), so rows past S
// arrive as zeros), two consumer warpgroups running wgmma with fp32
// register accumulators, and a ring of stages guarded by "full" (TMA bytes)
// and "empty" (one arrive per consumer warp) mbarriers.
//
// flash_bwd_dq_kernel (kernel C), q-stationary, the mirror of D: one CTA
// per (128-row q tile, query head, batch row), launched longest tile first
// so the causal triangle's heavy tiles start in the first wave. The
// producer brings the q and do tiles by TMA once, then streams 64-key k/v
// tiles of the kv head h / G through a four-stage ring, from key 0 up to
// the causal diagonal. Each consumer warpgroup owns 64 q rows, with their
// lse and delta in registers, and per k/v tile computes
//   s = q k^T, dp = do v^T      wgmma m64n64k16, all operands K-major
//   p = exp2(s scale log2e + bias - lse)   in fp32
//   ds = p (dp - delta) scale   rounded to k's dtype, as register-A fragments
//   dq += ds k                  wgmma m64n{Hd}k16, k MN-major (the stage
//                               that served s, read the other way)
// The bias runs only on tiles that have one (alibi, a key mask, keys past
// S, the causal diagonal: a warp-uniform branch); a warpgroup skips a tile
// wholly above its rows (causal), after the tile's full barrier, so that its
// release counts toward the right phase. 64-key stages keep s, dp and the
// ds fragments at 32 + 32 + 16 registers beside dq's Hd / 2.
//
// flash_bwd_dkv_kernel (kernel D), k-stationary: one CTA per (128-key
// tile, kv head, batch row). The producer warp brings the k and v tiles by
// TMA once, then streams, for each of the G query heads of the kv group and
// each 64-row q tile from the causal diagonal down, the q and do tiles
// (TMA) and the tile's lse and delta rows (plain loads by its lanes)
// through a two-stage ring. Each consumer warpgroup owns 64 keys and
// computes S^T = k q^T directly (keys as rows), so p^T and ds^T come out of
// the accumulators already as register-A fragments:
//   s^T = k q^T, dp^T = v do^T      wgmma m64n64k16, all operands K-major
//   p^T = exp2(s^T - lse) rounded to do's dtype
//   ds^T = p^T (dp^T - delta) scale, rounded to q's dtype
//   dv += p^T do, dk += ds^T q      wgmma m64n{Hd}k16, A from registers,
//                                   do and q MN-major (the same smem tiles)
// A warpgroup skips a q tile wholly above its keys (causal) as C does.
// dk and dv stay in fp32 registers (setmaxnreg gives the consumers 240) and
// sum over the whole group inside the CTA, in a fixed order.
//
// No atomics and no split over keys or q tiles in either kernel: each dq
// tile is written once by C, each dk / dv tile once by D, so the gradients
// repeat bit for bit from run to run. Keys past S are masked by the bias and
// never stored; q rows past S read lse = +1e30 (p = 0) and are never stored.
//
// Rounding points are the TPU kernels': in dq, p stays fp32 and ds is cast
// to k's dtype (_dq_kernel :205); in dkv, p is cast to do's dtype and that
// rounded p feeds both p^T do and ds, which is cast to q's dtype
// (_dkv_kernel :246-251). Every product accumulates in fp32; exp2 is one
// ex2.approx.ftz (a p below 2^-126 flushes to 0).
//
// Bound on the H100: at training lengths (S = 2048, Hd = 128) the backward is
// compute-bound (C does 3 and D 4 causal S x S x Hd products against 2 bytes
// per element of q/k/v/do/dq/dk/dv): wgmma on TMA-fed tiles, with the
// producer a ring ahead of the products, is what both designs do about it.
#include "common.cuh"
#include "wgmma_attention.cuh"
#include "wgmma_gemm.cuh"

namespace {

// Kernel C's tiles: 128 q rows a CTA (64 per consumer warpgroup) and 64
// keys a ring stage; every box is 64 columns (128 B) wide.
constexpr int kDqBQ = 128;
constexpr int kDqBK = 64;
constexpr int kDqStages = 4;
constexpr int kDqThreads = 384;        // warpgroups 0, 1 consume; 2 produces
constexpr int kDqConsumers = 256;
constexpr int kDqQBox = kDqBQ * 128;   // one 64-column box of q or do, 16 KB
constexpr int kDqKvBox = kDqBK * 128;  // one 64-column box of k or v, 8 KB

template <int HD>
struct DqShape {
  static constexpr int kQBytes = kDqQBox * (HD / 64);     // one of q, do
  static constexpr int kKvBytes = kDqKvBox * (HD / 64);   // one of k, v
  static constexpr int kStageBytes = 2 * kKvBytes;        // k and v
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + kDqStages * kStageBytes + (2 * kDqStages + 1) * 8;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ mask,
                    const float* __restrict__ slopes, T* __restrict__ dq, int S, int H, int KV,
                    int causal, float scale_log2, float scale) {
  using Sh = DqShape<HD>;
  extern __shared__ unsigned char dq_smem_raw[];
  unsigned char* smem = ds::align_1024(dq_smem_raw);
  unsigned char* qs = smem;                     // [128 q rows, Hd], fixed for the CTA
  unsigned char* dos = qs + Sh::kQBytes;
  unsigned char* ring = dos + Sh::kQBytes;      // k and v of one key tile a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDqStages * Sh::kStageBytes);
  uint64_t* empty = full + kDqStages;
  uint64_t* qbar = empty + kDqStages;

  // the q tiles of one (head, batch row) are neighbours, so the blocks that
  // run together share their k/v tiles in L2; each head's last (longest)
  // tile first
  const int nqt = (S + kDqBQ - 1) / kDqBQ;
  const int qt = nqt - 1 - (int)blockIdx.x % nqt;
  const int r = (int)blockIdx.x / nqt;
  const int h = r % H, b = r / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kDqBQ;
  int n_kt = (S + kDqBK - 1) / kDqBK;
  if (causal) n_kt = min(n_kt, (q0 + kDqBQ - 1) / kDqBK + 1);   // tiles up to the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      ds::mbar_init(&full[s], 1);
      ds::mbar_init(&empty[s], kDqConsumers / 32);
    }
    ds::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kDqConsumers) {   // producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kDqConsumers) {
      ds::mbar_expect_tx(qbar, 2 * Sh::kQBytes);
#pragma unroll
      for (int j = 0; j < HD / 64; ++j) {
        ds::tma_load_3d(qs + j * kDqQBox, &qmap, qbar, h * HD + 64 * j, q0, b);
        ds::tma_load_3d(dos + j * kDqQBox, &domap, qbar, h * HD + 64 * j, q0, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kDqStages;
        ds::mbar_wait(&empty[s], ((kt / kDqStages) & 1) ^ 1);   // first pass: free
        unsigned char* st = ring + s * Sh::kStageBytes;
        ds::mbar_expect_tx(&full[s], Sh::kStageBytes);
#pragma unroll
        for (int j = 0; j < HD / 64; ++j) {
          ds::tma_load_3d(st + j * kDqKvBox, &kmap, &full[s], kvh * HD + 64 * j, kt * kDqBK, b);
          ds::tma_load_3d(st + Sh::kKvBytes + j * kDqKvBox, &vmap, &full[s], kvh * HD + 64 * j,
                          kt * kDqBK, b);
        }
      }
    }
  } else {   // consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, lane = tid & 31;
    const int t = lane & 3;
    const int row0 = q0 + wg * 64;                             // the warpgroup's first row
    const int qpos[2] = {row0 + tid / 32 % 4 * 16 + (lane >> 2),
                         row0 + tid / 32 % 4 * 16 + (lane >> 2) + 8};
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
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t q_base = ds::smem_u32(qs) + wg * 64 * 128;
    const uint32_t do_base = ds::smem_u32(dos) + wg * 64 * 128;

    ds::mbar_wait(qbar, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kDqStages, k0 = kt * kDqBK;
      ds::mbar_wait(&full[s], (kt / kDqStages) & 1);
      // a key tile wholly above this warpgroup's rows adds nothing
      if (causal && k0 > row0 + 63) {
        if (lane == 0) ds::mbar_arrive(&empty[s]);
        continue;
      }
      const uint32_t k_base = ds::smem_u32(ring + s * Sh::kStageBytes);
      const uint32_t v_base = k_base + Sh::kKvBytes;

      // s = q k^T and dp = do v^T: 64 q rows x 64 keys, 16-deep steps along Hd
      float sc[kDqBK / 2], dp[kDqBK / 2];
      ds::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t qa = kk / 4 * kDqQBox + kk % 4 * 32, ka = kk / 4 * kDqKvBox + kk % 4 * 32;
        ds::wgmma_ss<T, kDqBK, 0, 0>(sc, ds::gmma_desc(q_base + qa, 16, 1024),
                                     ds::gmma_desc(k_base + ka, 16, 1024), kk > 0);
        ds::wgmma_ss<T, kDqBK, 0, 0>(dp, ds::gmma_desc(do_base + qa, 16, 1024),
                                     ds::gmma_desc(v_base + ka, 16, 1024), kk > 0);
      }
      ds::wgmma_commit();
      ds::wgmma_wait<0>();
      ds::fence_regs(sc);
      ds::fence_regs(dp);

      // log2-domain logits + bias (only where a tile has any: alibi, a key
      // mask, keys past S or the causal diagonal)
      const bool biased = slopes != nullptr || mask != nullptr || k0 + kDqBK > S ||
                          (causal && k0 + kDqBK - 1 > row0);
      if (biased) {
#pragma unroll
        for (int i = 0; i < kDqBK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * i + e] = sc[4 * i + e] * scale_log2 +
                            ds::attn_bias(qpos[e >> 1], k0 + 8 * i + 2 * t + (e & 1), S, causal,
                                          slope, maskb);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kDqBK / 2; ++i) sc[i] *= scale_log2;
      }
      // ds = p (dp - delta) scale with p = exp2(s - lse) in fp32
#pragma unroll
      for (int i = 0; i < kDqBK / 2; ++i) {
        const int row = (i >> 1) & 1;
        const float p = ds::exp2_ftz(sc[i] - lse_r[row]);
        sc[i] = p * (dp[i] - delta_r[row]) * scale;
      }
      uint32_t da[kDqBK / 16][4];
      ds::acc_to_a<T, kDqBK>(sc, da);   // ds rounded to k's dtype

      // dq += ds k: k [keys, Hd] MN-major, 64-row boxes 8 KB apart
      ds::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqBK / 16; ++kk)
        ds::wgmma_rs<T, HD, 1>(acc, da[kk], ds::gmma_desc(k_base + kk * 16 * 128, kDqKvBox, 1024));
      ds::wgmma_commit();
      ds::wgmma_wait<0>();
      ds::fence_regs(acc);
      if (lane == 0) ds::mbar_arrive(&empty[s]);
    }

    // epilogue: dq cast once to k's dtype; rows past S are not stored
    const long q_stride = (long)H * HD;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      if (qpos[row] >= S) continue;
      T* out = dq + ((long)b * S + qpos[row]) * q_stride + (long)h * HD + 2 * t;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(out + 8 * i) =
            ds::pack_f32<T>(acc[4 * i + 2 * row], acc[4 * i + 2 * row + 1]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return ds::to_float(ds::from_float<T>(x));
}

// Kernel D's tiles: 128 keys a CTA (64 per consumer warpgroup) and 64 q
// rows a ring stage; every box is 64 columns (128 B) wide.
constexpr int kDkvBK = 128;
constexpr int kDkvBQ = 64;
constexpr int kDkvStages = 2;
constexpr int kDkvThreads = 384;       // warpgroups 0, 1 consume; 2 produces
constexpr int kDkvConsumers = 256;
constexpr int kKvBox = kDkvBK * 128;   // one 64-column box of k or v, 16 KB
constexpr int kQBox = kDkvBQ * 128;    // one 64-column box of q or do, 8 KB

template <int HD>
struct DkvShape {
  static constexpr int kKvBytes = kKvBox * (HD / 64);     // one of k, v
  static constexpr int kQBytes = kQBox * (HD / 64);       // one of q, do
  // q, do, then the tile's lse and delta rows (64 floats each), 1 KB aligned
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  static constexpr size_t kSmem =
      1024 + 2 * kKvBytes + kDkvStages * kStageBytes + (2 * kDkvStages + 1) * 8;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ mask,
                     const float* __restrict__ slopes, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int H, int KV, int causal, float scale_log2, float scale) {
  using Sh = DkvShape<HD>;
  extern __shared__ unsigned char dkv_smem_raw[];
  unsigned char* smem = ds::align_1024(dkv_smem_raw);
  unsigned char* ks = smem;                     // [128 keys, Hd], fixed for the CTA
  unsigned char* vs = ks + Sh::kKvBytes;
  unsigned char* ring = vs + Sh::kKvBytes;      // q, do, lse, delta of one q tile a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDkvStages * Sh::kStageBytes);
  uint64_t* empty = full + kDkvStages;
  uint64_t* kvbar = empty + kDkvStages;

  // the key tiles of one (kv head, batch row) are neighbours, so the blocks
  // that run together share their q / do tiles in L2; key tile 0, which sees
  // every q tile under causal attention, first
  const int nkt = (S + kDkvBK - 1) / kDkvBK;
  const int kt = (int)blockIdx.x % nkt;
  const int kvh = (int)blockIdx.x / nkt % KV, b = (int)blockIdx.x / nkt / KV;
  const int G = H / KV;
  const int k0 = kt * kDkvBK;
  const int nq = (S + kDkvBQ - 1) / kDkvBQ;
  const int qt0 = causal ? k0 / kDkvBQ : 0;    // q tiles from the diagonal down
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kDkvStages; ++s) {
      ds::mbar_init(&full[s], 32);                        // the producer warp's lanes
      ds::mbar_init(&empty[s], kDkvConsumers / 32);       // one arrive per consumer warp
    }
    ds::mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kDkvConsumers) {   // producer warpgroup: its first warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid < kDkvConsumers + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        ds::mbar_expect_tx(kvbar, 2 * Sh::kKvBytes);
#pragma unroll
        for (int j = 0; j < HD / 64; ++j) {
          ds::tma_load_3d(ks + j * kKvBox, &kmap, kvbar, kvh * HD + 64 * j, k0, b);
          ds::tma_load_3d(vs + j * kKvBox, &vmap, kvbar, kvh * HD + 64 * j, k0, b);
        }
      }
      int it = 0;
      for (int gi = 0; gi < G; ++gi) {
        const int h = kvh * G + gi;
        const long row_off = ((long)b * H + h) * S;
        for (int qt = qt0; qt < nq; ++qt, ++it) {
          const int s = it % kDkvStages, q0 = qt * kDkvBQ;
          ds::mbar_wait(&empty[s], ((it / kDkvStages) & 1) ^ 1);   // first pass: free
          unsigned char* st = ring + s * Sh::kStageBytes;
          float* lse_s = reinterpret_cast<float*>(st + 2 * Sh::kQBytes);
          for (int i = lane; i < kDkvBQ; i += 32) {
            const bool in = q0 + i < S;
            lse_s[i] = in ? lse[row_off + q0 + i] : -ds::kMasked;   // rows past S: p = 0
            lse_s[kDkvBQ + i] = in ? delta[row_off + q0 + i] : 0.f;
          }
          if (lane == 0) {
            ds::mbar_expect_tx(&full[s], 2 * Sh::kQBytes);
#pragma unroll
            for (int j = 0; j < HD / 64; ++j) {
              ds::tma_load_3d(st + j * kQBox, &qmap, &full[s], h * HD + 64 * j, q0, b);
              ds::tma_load_3d(st + Sh::kQBytes + j * kQBox, &domap, &full[s], h * HD + 64 * j,
                              q0, b);
            }
          } else {
            ds::mbar_arrive(&full[s]);
          }
        }
      }
    }
  } else {   // consumer warpgroups: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128, lane = tid & 31;
    const int t = lane & 3;
    const int kw0 = k0 + wg * 64;                              // the warpgroup's first key
    const int kpos[2] = {kw0 + tid / 32 % 4 * 16 + (lane >> 2),
                         kw0 + tid / 32 % 4 * 16 + (lane >> 2) + 8};
    const float* maskb = mask ? mask + (long)b * S : nullptr;
    float adk[HD / 2], adv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) adk[i] = adv[i] = 0.f;
    const uint32_t k_base = ds::smem_u32(ks) + wg * 64 * 128;
    const uint32_t v_base = ds::smem_u32(vs) + wg * 64 * 128;

    ds::mbar_wait(kvbar, 0);
    int it = 0;
    for (int gi = 0; gi < G; ++gi) {
      const int h = kvh * G + gi;
      const float slope = slopes ? slopes[h] * ds::kLog2e : 0.f;
      for (int qt = qt0; qt < nq; ++qt, ++it) {
        const int s = it % kDkvStages, q0 = qt * kDkvBQ;
        ds::mbar_wait(&full[s], (it / kDkvStages) & 1);
        // a q tile wholly above this warpgroup's keys adds nothing
        if (causal && q0 + kDkvBQ - 1 < kw0) {
          if (lane == 0) ds::mbar_arrive(&empty[s]);
          continue;
        }
        const uint32_t q_base = ds::smem_u32(ring + s * Sh::kStageBytes);
        const uint32_t do_base = q_base + Sh::kQBytes;
        const float* lse_s = reinterpret_cast<const float*>(ring + s * Sh::kStageBytes +
                                                            2 * Sh::kQBytes);
        const float* delta_s = lse_s + kDkvBQ;

        // s^T = k q^T and dp^T = v do^T: 64 keys x 64 q rows, 16-deep steps along Hd
        float st[kDkvBQ / 2], dpt[kDkvBQ / 2];
        ds::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t ka = kk / 4 * kKvBox + kk % 4 * 32, qa = kk / 4 * kQBox + kk % 4 * 32;
          ds::wgmma_ss<T, kDkvBQ, 0, 0>(st, ds::gmma_desc(k_base + ka, 16, 1024),
                                        ds::gmma_desc(q_base + qa, 16, 1024), kk > 0);
          ds::wgmma_ss<T, kDkvBQ, 0, 0>(dpt, ds::gmma_desc(v_base + ka, 16, 1024),
                                        ds::gmma_desc(do_base + qa, 16, 1024), kk > 0);
        }
        ds::wgmma_commit();
        ds::wgmma_wait<0>();
        ds::fence_regs(st);
        ds::fence_regs(dpt);

        // p^T rounded to do's dtype; ds^T = p^T (dp^T - delta) scale
        const bool biased = slopes != nullptr || mask != nullptr || kw0 + 64 > S ||
                            (causal && q0 < kw0 + 63);
        if (biased) {
#pragma unroll
          for (int i = 0; i < kDkvBQ / 8; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              st[4 * i + e] = st[4 * i + e] * scale_log2 +
                              ds::attn_bias(q0 + 8 * i + 2 * t + (e & 1), kpos[e >> 1], S,
                                            causal, slope, maskb);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kDkvBQ / 2; ++i) st[i] *= scale_log2;
        }
#pragma unroll
        for (int i = 0; i < kDkvBQ / 8; ++i) {
          // this thread's two q columns 8 i + 2 t, + 1
          const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + 8 * i + 2 * t);
          const float2 delta2 = *reinterpret_cast<const float2*>(delta_s + 8 * i + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = round_to<T>(ds::exp2_ftz(st[4 * i + e] - ((e & 1) ? lse2.y : lse2.x)));
            st[4 * i + e] = p;
            dpt[4 * i + e] = p * (dpt[4 * i + e] - ((e & 1) ? delta2.y : delta2.x)) * scale;
          }
        }
        uint32_t pa[kDkvBQ / 16][4], da[kDkvBQ / 16][4];
        ds::acc_to_a<T, kDkvBQ>(st, pa);
        ds::acc_to_a<T, kDkvBQ>(dpt, da);

        // dv += p^T do, dk += ds^T q: do and q [q rows, Hd] MN-major, 64-row boxes 8 KB apart
        ds::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkvBQ / 16; ++kk) {
          ds::wgmma_rs<T, HD, 1>(adv, pa[kk], ds::gmma_desc(do_base + kk * 16 * 128, kQBox, 1024));
          ds::wgmma_rs<T, HD, 1>(adk, da[kk], ds::gmma_desc(q_base + kk * 16 * 128, kQBox, 1024));
        }
        ds::wgmma_commit();
        ds::wgmma_wait<0>();
        ds::fence_regs(adv);
        ds::fence_regs(adk);
        if (lane == 0) ds::mbar_arrive(&empty[s]);
      }
    }

    // epilogue: dk and dv cast once to k's dtype; keys past S are not stored
    const long kv_stride = (long)KV * HD;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      if (kpos[row] >= S) continue;
      const long off = ((long)b * S + kpos[row]) * kv_stride + (long)kvh * HD + 2 * t;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
            ds::pack_f32<T>(adk[4 * i + 2 * row], adk[4 * i + 2 * row + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
            ds::pack_f32<T>(adv[4 * i + 2 * row], adv[4 * i + 2 * row + 1]);
      }
    }
  }
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dO, const float* lse,
              const float* delta, const float* mask, const float* slopes, void* dq, int B,
              int S, int H, int KV, int causal, float scale_log2, float scale,
              cudaStream_t stream) {
  using Sh = DqShape<HD>;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!ds::make_tma_map_bsc<T>(&qmap, q, B, S, (long)H * HD, kDqBQ) ||
      !ds::make_tma_map_bsc<T>(&domap, dO, B, S, (long)H * HD, kDqBQ) ||
      !ds::make_tma_map_bsc<T>(&kmap, k, B, S, (long)KV * HD, kDqBK) ||
      !ds::make_tma_map_bsc<T>(&vmap, v, B, S, (long)KV * HD, kDqBK))
    return (int)cudaErrorNotSupported;
  auto kern = flash_bwd_dq_kernel<T, HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (S + kDqBQ - 1) / kDqBQ * H * B;
  kern<<<grid, kDqThreads, Sh::kSmem, stream>>>(qmap, kmap, vmap, domap, lse, delta, mask,
                                                slopes, static_cast<T*>(dq), S, H, KV, causal,
                                                scale_log2, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dO, const float* lse,
               const float* delta, const float* mask, const float* slopes, void* dk, void* dv,
               int B, int S, int H, int KV, int causal, float scale_log2, float scale,
               cudaStream_t stream) {
  using Sh = DkvShape<HD>;
  CUtensorMap qmap, kmap, vmap, domap;
  if (!ds::make_tma_map_bsc<T>(&qmap, q, B, S, (long)H * HD, kDkvBQ) ||
      !ds::make_tma_map_bsc<T>(&domap, dO, B, S, (long)H * HD, kDkvBQ) ||
      !ds::make_tma_map_bsc<T>(&kmap, k, B, S, (long)KV * HD, kDkvBK) ||
      !ds::make_tma_map_bsc<T>(&vmap, v, B, S, (long)KV * HD, kDkvBK))
    return (int)cudaErrorNotSupported;
  auto kern = flash_bwd_dkv_kernel<T, HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (S + kDkvBK - 1) / kDkvBK * KV * B;
  kern<<<grid, kDkvThreads, Sh::kSmem, stream>>>(
      qmap, kmap, vmap, domap, lse, delta, mask, slopes, static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, KV, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/do/dq [B,S,H,Hd], k/v [B,S,KV,Hd] contiguous; lse/delta [B,H,S] f32
// (lse log2-domain, as the forward wrote it; delta = sum(do * o) over Hd);
// mask [B,S] f32 additive key bias or null; slopes [H] f32 or null.
// scale_log2 = scale * log2(e). dtype 0 = fp16, 1 = bf16; head_dim 64 or
// 128. Each returns cudaGetLastError() after its launch
// (cudaErrorNotSupported when the TMA maps cannot be made).
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

// Dynamic shared memory of one kernel-C block at head_dim.
extern "C" int ds_flash_dq_smem_bytes(int head_dim) {
  return (int)(head_dim == 128 ? DqShape<128>::kSmem : DqShape<64>::kSmem);
}

// Dynamic shared memory of one kernel-D block at head_dim.
extern "C" int ds_flash_dkv_smem_bytes(int head_dim) {
  return (int)(head_dim == 128 ? DkvShape<128>::kSmem : DkvShape<64>::kSmem);
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
