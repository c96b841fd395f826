// Flash-attention forward for Hopper (sm_90a): the port of the TPU kernels
// deepspeed_tpu/ops/pallas/flash_attention.py _fwd_kernel (general, K1) and
// _packed_fwd_kernel (packed heads for Hd < 128, K2). One kernel serves
// both: it reads q [B,S,H,Hd] and k/v [B,S,KV,Hd] in place, so the TPU's
// lane packing has no counterpart here.
//
// Design (q-stationary, warp-specialised; the pieces are in
// wgmma_attention.cuh and wgmma_gemm.cuh): one CTA per (128-row q tile,
// head, batch row), 64 rows to each of two consumer warpgroups; a third
// warpgroup's first thread is the producer. The producer brings the q tile
// by TMA once, then streams 128-key k and v tiles through a two-stage ring
// of shared memory up to the causal diagonal, each stage guarded by a
// "full" mbarrier (TMA bytes) and an "empty" one (one arrive per consumer
// warp). Each consumer warpgroup, per k/v tile:
//
//   s = q k^T                  wgmma m64n128k16, both from shared memory
//                              (q and k K-major, 64-column boxes with the
//                              128-byte swizzle)
//   bias, online softmax       on the fp32 accumulators, in the log2 domain;
//                              the bias only on tiles that have one (alibi,
//                              a mask, the diagonal, keys past S), exp2 as
//                              one SFU instruction (ex2.approx.ftz): the
//                              softmax, not the products, limited the
//                              first version of this design
//   o = o * alpha + p v        p rounded to v's dtype straight from the s
//                              accumulators into register-A fragments;
//                              v MN-major; m64n{Hd}k16 with fp32 o
//
// and then releases the stage. TMA maps are 3-D (head columns, S, B), so
// rows past S arrive as zeros and never carry another batch row's tokens:
// keys past S are masked by the bias (-1e30), q rows past S are never
// stored. The q tiles of one head launch together, longest first, so they
// share each k/v tile in L2.
//
// The TPU kernel's conventions: logits scaled by scale*log2(e) plus the
// bias, masked entries -1e30, running max from -1e30, exp2, p cast to v's
// dtype before p v, o = acc / l (l = 1 where a row has no mass), lse = m +
// log2(l) or +1e30 for a row with no mass, so the backward can recompute p.
//
// Bound on the H100: at the training shape (S 2048, Hd 128) the causal
// triangle's 4 S^2/2 Hd FLOPs a head bound it (0.139 ms at B 4, H 32 on
// 989 TFLOP/s); short prompts (S 512 at B 1) are bound by the q/k/v/o
// bytes. wgmma at the tensor cores' full rate with TMA loads that overlap
// the products is what the design does about the first.
#include "common.cuh"
#include "wgmma_attention.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int kBQ = 128;          // q rows of a tile: two consumer warpgroups of 64
constexpr int kBK = 128;          // keys per k/v tile
constexpr int kStages = 2;        // k/v ring depth
constexpr int kThreads = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumers = 256;
constexpr int kBox = 128 * 128;   // one 128-row x 64-column box of q, k or v, bytes

template <int HD>
struct FwdShape {
  static constexpr int kTileBytes = kBox * (HD / 64);   // one of q, k, v
  static constexpr int kStageBytes = 2 * kTileBytes;    // k and v
  static constexpr size_t kSmem =
      1024 + kTileBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ mask,
                 const float* __restrict__ slopes, int S, int H, int KV, int causal,
                 float scale_log2) {
  using Sh = FwdShape<HD>;
  extern __shared__ unsigned char fwd_smem_raw[];
  unsigned char* smem = ds::align_1024(fwd_smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + Sh::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * Sh::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  // the q tiles of one (head, batch row) are neighbours, so the blocks that
  // run together share their k/v tiles in L2; each head's last (longest)
  // tile first
  const int nqt = (S + kBQ - 1) / kBQ;
  const int qt = nqt - 1 - (int)blockIdx.x % nqt;
  const int r = (int)blockIdx.x / nqt;
  const int h = r % H, b = r / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  int n_kt = (S + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);   // tiles up to the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      ds::mbar_init(&full[s], 1);
      ds::mbar_init(&empty[s], kConsumers / 32);
    }
    ds::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {   // producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      ds::mbar_expect_tx(qbar, Sh::kTileBytes);
#pragma unroll
      for (int j = 0; j < HD / 64; ++j)
        ds::tma_load_3d(qs + j * kBox, &qmap, qbar, h * HD + 64 * j, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        ds::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);   // first pass: free
        unsigned char* ks = ring + s * Sh::kStageBytes;
        ds::mbar_expect_tx(&full[s], Sh::kStageBytes);
#pragma unroll
        for (int j = 0; j < HD / 64; ++j) {
          ds::tma_load_3d(ks + j * kBox, &kmap, &full[s], kvh * HD + 64 * j, kt * kBK, b);
          ds::tma_load_3d(ks + Sh::kTileBytes + j * kBox, &vmap, &full[s], kvh * HD + 64 * j,
                          kt * kBK, b);
        }
      }
    }
  } else {   // consumer warpgroups: 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, lane = tid & 31;
    const int t = lane & 3;
    const int row0 = q0 + wg * 64;                             // the warpgroup's first row
    const int qpos[2] = {row0 + tid / 32 % 4 * 16 + (lane >> 2),
                         row0 + tid / 32 % 4 * 16 + (lane >> 2) + 8};
    const float slope = slopes ? slopes[h] * ds::kLog2e : 0.f;
    const float* maskb = mask ? mask + (long)b * S : nullptr;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {ds::kMasked, ds::kMasked}, l[2] = {0.f, 0.f};
    const uint32_t q_base = ds::smem_u32(qs) + wg * 64 * 128;

    ds::mbar_wait(qbar, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages, k0 = kt * kBK;
      const uint32_t k_base = ds::smem_u32(ring + s * Sh::kStageBytes);
      const uint32_t v_base = k_base + Sh::kTileBytes;
      ds::mbar_wait(&full[s], (kt / kStages) & 1);

      // s = q k^T: 64 rows x 128 keys, 16-deep steps along Hd
      float sc[kBK / 2];
      ds::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = ds::gmma_desc(q_base + kk / 4 * kBox + kk % 4 * 32, 16, 1024);
        const uint64_t db = ds::gmma_desc(k_base + kk / 4 * kBox + kk % 4 * 32, 16, 1024);
        ds::wgmma_ss<T, kBK, 0, 0>(sc, da, db, kk > 0);
      }
      ds::wgmma_commit();
      ds::wgmma_wait<0>();
      ds::fence_regs(sc);
      // log2-domain logits + bias (only where a tile has any: alibi, a key
      // mask, keys past S or the causal diagonal)
      const bool biased = slopes != nullptr || mask != nullptr || k0 + kBK > S ||
                          (causal && k0 + kBK - 1 > row0);
      float rowmax[2] = {ds::kMasked, ds::kMasked};
      if (biased) {
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e >> 1;
            sc[4 * i + e] = sc[4 * i + e] * scale_log2 +
                            ds::attn_bias(qpos[row], k0 + 8 * i + 2 * t + (e & 1), S, causal,
                                          slope, maskb);
            rowmax[row] = fmaxf(rowmax[row], sc[4 * i + e]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          sc[i] *= scale_log2;
          rowmax[(i >> 1) & 1] = fmaxf(rowmax[(i >> 1) & 1], sc[i]);
        }
      }
      float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        rowmax[row] = fmaxf(rowmax[row], __shfl_xor_sync(0xffffffffu, rowmax[row], 1));
        rowmax[row] = fmaxf(rowmax[row], __shfl_xor_sync(0xffffffffu, rowmax[row], 2));
        const float m_new = fmaxf(m[row], rowmax[row]);
        alpha[row] = ds::exp2_ftz(m[row] - m_new);
        m[row] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const float p = ds::exp2_ftz(sc[i] - m[(i >> 1) & 1]);
        sc[i] = p;
        rowsum[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        rowsum[row] += __shfl_xor_sync(0xffffffffu, rowsum[row], 1);
        rowsum[row] += __shfl_xor_sync(0xffffffffu, rowsum[row], 2);
        l[row] = l[row] * alpha[row] + rowsum[row];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // o += p v: p (rounded to T, as the TPU kernel casts p to v's dtype)
      // from the accumulators; v [keys, Hd] MN-major, 128-row boxes 16 KB apart
      uint32_t pa[kBK / 16][4];
      ds::acc_to_a<T, kBK>(sc, pa);
      ds::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        ds::wgmma_rs<T, HD, 1>(acc, pa[kk], ds::gmma_desc(v_base + kk * 16 * 128, kBox, 1024));
      ds::wgmma_commit();
      ds::wgmma_wait<0>();
      ds::fence_regs(acc);
      if (lane == 0) ds::mbar_arrive(&empty[s]);
    }

    // epilogue: o = acc / l (l = 1 where a row has no mass), lse in log2 domain
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int sq = qpos[row];
      if (sq >= S) continue;
      const float inv = l[row] > 0.f ? 1.f / l[row] : 1.f;
      T* orow = o + ((long)b * S + sq) * ((long)H * HD) + (long)h * HD + 2 * t;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            ds::pack_f32<T>(acc[4 * i + 2 * row] * inv, acc[4 * i + 2 * row + 1] * inv);
      if (t == 0)
        lse[((long)b * H + h) * S + sq] = l[row] > 0.f ? m[row] + log2f(l[row]) : -ds::kMasked;
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const float* mask,
           const float* slopes, int B, int S, int H, int KV, int causal, float scale_log2,
           cudaStream_t stream) {
  using Sh = FwdShape<HD>;
  CUtensorMap qmap, kmap, vmap;
  if (!ds::make_tma_map_bsc<T>(&qmap, q, B, S, (long)H * HD, kBQ) ||
      !ds::make_tma_map_bsc<T>(&kmap, k, B, S, (long)KV * HD, kBK) ||
      !ds::make_tma_map_bsc<T>(&vmap, v, B, S, (long)KV * HD, kBK))
    return (int)cudaErrorNotSupported;
  auto kern = flash_fwd_kernel<T, HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (S + kBQ - 1) / kBQ * H * B;
  kern<<<grid, kThreads, Sh::kSmem, stream>>>(qmap, kmap, vmap, static_cast<T*>(o), lse, mask,
                                              slopes, S, H, KV, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block at head_dim.
extern "C" int ds_flash_fwd_smem_bytes(int head_dim) {
  return (int)(head_dim == 128 ? FwdShape<128>::kSmem : FwdShape<64>::kSmem);
}

// q/o [B,S,H,Hd], k/v [B,S,KV,Hd] contiguous and 16-byte aligned; lse
// [B,H,S] f32; mask [B,S] f32 additive key bias or null; slopes [H] f32 or
// null. dtype 0 = fp16, 1 = bf16; head_dim 64 or 128. Returns
// cudaGetLastError() after the launch (cudaErrorNotSupported when the TMA
// maps cannot be made).
extern "C" int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const float* mask, const float* slopes,
                                      int B, int S, int H, int KV, int head_dim, int causal,
                                      float scale_log2, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_FWD(T, HD) launch<T, HD>(q, k, v, o, lse, mask, slopes, B, S, H, KV, causal, \
                                    scale_log2, st)
  if (dtype == 1 && head_dim == 128) return DS_FWD(__nv_bfloat16, 128);
  if (dtype == 1 && head_dim == 64) return DS_FWD(__nv_bfloat16, 64);
  if (dtype == 0 && head_dim == 128) return DS_FWD(__half, 128);
  if (dtype == 0 && head_dim == 64) return DS_FWD(__half, 64);
#undef DS_FWD
  return (int)cudaErrorInvalidValue;
}
