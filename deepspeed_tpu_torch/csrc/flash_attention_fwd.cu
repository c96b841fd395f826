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
// Block-sparse attention (the TPU kernel's has_layout mode): the wrapper
// passes each (head, q tile)'s live k tiles (ds::TileList), and the producer
// and the consumers walk that list in place of 0 .. the diagonal, both
// counting ring phases by list position, so a dead tile costs neither TMA
// bytes nor products and an empty list leaves o = 0, lse = +1e30 (the rule
// below). A tile that straddles layout blocks (blocks below 128, or not
// aligned to 128) comes flagged partial and takes the layout per element
// (ds::keep_bits: -inf, not -1e30, so a row with nothing live yet in it
// adds no mass); a whole tile runs as the dense kernel does.
//
// The TPU kernel's conventions: logits scaled by scale*log2(e) plus the
// bias, masked entries -1e30, running max from -1e30, exp2, p cast to v's
// dtype before p v, o = acc / l (l = 1 where a row has no mass), lse = m +
// log2(l) or +1e30 for a row with no mass, so the backward can recompute p.
//
// Head dim 256 (GPT-J): the plan above needs 1 KB + 64 KB of q + two
// stages of 128-key k and v (2 x 128 KB), past the 227 KB a block can
// have. At Hd 256 the k/v tiles take 64 keys (FwdShape::kBK): q 64 KB +
// two stages of 64 KB = 193 KB, and the score tile shrinks to 64 x 64
// (m64n64k16), so a consumer thread holds o (128 fp32) beside 32 scores
// and 16 packed p registers under setmaxnreg's 232. p v is one m64n256k16
// (register A, v MN-major over four 64-column boxes). A block layout's
// lists keep their 128-key tiles: each entry is walked as its two halves.
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
constexpr int kListTile = 128;    // keys of a tile in a block layout's lists
constexpr int kStages = 2;        // k/v ring depth
constexpr int kThreads = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumers = 256;
constexpr int kQBox = kBQ * 128;  // one 128-row x 64-column box of q, bytes

template <int HD>
struct FwdShape {
  static constexpr int kBK = HD > 128 ? 64 : 128;      // keys per k/v tile
  static constexpr int kSub = kListTile / kBK;         // k/v tiles of a list tile
  static constexpr int kKBox = kBK * 128;              // one kBK-row x 64-column box
  static constexpr int kQBytes = kQBox * (HD / 64);
  static constexpr int kTileBytes = kKBox * (HD / 64);   // one of k, v
  static constexpr int kStageBytes = 2 * kTileBytes;     // k and v
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                 float* __restrict__ lse, const float* __restrict__ mask,
                 const float* __restrict__ slopes, int S, int H, int KV, int causal,
                 float scale_log2, const ds::TileList tl) {
  using Sh = FwdShape<HD>;
  constexpr int kBK = Sh::kBK;
  extern __shared__ unsigned char fwd_smem_raw[];
  unsigned char* smem = ds::align_1024(fwd_smem_raw);
  unsigned char* qs = smem;
  unsigned char* ring = smem + Sh::kQBytes;
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
  // with a layout: this (head, q tile)'s live k tiles; producer and consumers
  // walk the same list, so their ring phases agree whatever its length
  // (kSub k/v tiles to each of its 128-key entries)
  int n_it;
  const int* walk = ds::tile_walk(tl, h * nqt + qt, n_kt, n_it);
  const int n_walked = n_it;
  if (walk) n_it *= Sh::kSub;
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
      ds::mbar_expect_tx(qbar, Sh::kQBytes);
#pragma unroll
      for (int j = 0; j < HD / 64; ++j)
        ds::tma_load_3d(qs + j * kQBox, &qmap, qbar, h * HD + 64 * j, q0, b);
      for (int it = 0; it < n_it; ++it) {
        const int kt = walk ? (walk[it / Sh::kSub] >> 1) * Sh::kSub + it % Sh::kSub : it;
        const int s = it % kStages;
        ds::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);   // first pass: free
        unsigned char* ks = ring + s * Sh::kStageBytes;
        ds::mbar_expect_tx(&full[s], Sh::kStageBytes);
#pragma unroll
        for (int j = 0; j < HD / 64; ++j) {
          ds::tma_load_3d(ks + j * Sh::kKBox, &kmap, &full[s], kvh * HD + 64 * j, kt * kBK, b);
          ds::tma_load_3d(ks + Sh::kTileBytes + j * Sh::kKBox, &vmap, &full[s],
                          kvh * HD + 64 * j, kt * kBK, b);
        }
      }
      if (tl.walked != nullptr) atomicAdd(tl.walked, (unsigned long long)n_walked);
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
    for (int it = 0; it < n_it; ++it) {
      const int e = walk ? walk[it / Sh::kSub] : 0;
      const bool partial = e & 1;
      const int kt = walk ? (e >> 1) * Sh::kSub + it % Sh::kSub : it;
      const int s = it % kStages, k0 = kt * kBK;
      const uint32_t k_base = ds::smem_u32(ring + s * Sh::kStageBytes);
      const uint32_t v_base = k_base + Sh::kTileBytes;
      ds::mbar_wait(&full[s], (it / kStages) & 1);

      // s = q k^T: 64 rows x kBK keys, 16-deep steps along Hd
      float sc[kBK / 2];
      ds::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = ds::gmma_desc(q_base + kk / 4 * kQBox + kk % 4 * 32, 16, 1024);
        const uint64_t db = ds::gmma_desc(k_base + kk / 4 * Sh::kKBox + kk % 4 * 32, 16, 1024);
        ds::wgmma_ss<T, kBK, 0, 0>(sc, da, db, kk > 0);
      }
      ds::wgmma_commit();
      ds::wgmma_wait<0>();
      ds::fence_regs(sc);
      // log2-domain logits + bias (only where a tile has any: alibi, a key
      // mask, keys past S, the causal diagonal or a partial layout tile)
      const bool biased = slopes != nullptr || mask != nullptr || k0 + kBK > S ||
                          (causal && k0 + kBK - 1 > row0) || partial;
      float rowmax[2] = {ds::kMasked, ds::kMasked};
      if (biased) {
        const uint32_t keep = partial ? ds::keep_bits<kBK / 8>(tl, h, qpos, true, k0, S) : ~0u;
#pragma unroll
        for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int row = c >> 1;
            const float bias = (keep >> (2 * i + row)) & 1
                                   ? ds::attn_bias(qpos[row], k0 + 8 * i + 2 * t + (c & 1), S,
                                                   causal, slope, maskb)
                                   : ds::neg_inf();
            sc[4 * i + c] = sc[4 * i + c] * scale_log2 + bias;
            rowmax[row] = fmaxf(rowmax[row], sc[4 * i + c]);
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
      // from the accumulators; v [keys, Hd] MN-major, kBK-row boxes kKBox apart
      uint32_t pa[kBK / 16][4];
      ds::acc_to_a<T, kBK>(sc, pa);
      ds::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        ds::wgmma_rs<T, HD, 1>(acc, pa[kk],
                               ds::gmma_desc(v_base + kk * 16 * 128, Sh::kKBox, 1024));
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
           const ds::TileList& tl, cudaStream_t stream) {
  using Sh = FwdShape<HD>;
  CUtensorMap qmap, kmap, vmap;
  if (!ds::make_tma_map_bsc<T>(&qmap, q, B, S, (long)H * HD, kBQ) ||
      !ds::make_tma_map_bsc<T>(&kmap, k, B, S, (long)KV * HD, Sh::kBK) ||
      !ds::make_tma_map_bsc<T>(&vmap, v, B, S, (long)KV * HD, Sh::kBK))
    return (int)cudaErrorNotSupported;
  auto kern = flash_fwd_kernel<T, HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (S + kBQ - 1) / kBQ * H * B;
  kern<<<grid, kThreads, Sh::kSmem, stream>>>(qmap, kmap, vmap, static_cast<T*>(o), lse, mask,
                                              slopes, S, H, KV, causal, scale_log2, tl);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block at head_dim.
extern "C" int ds_flash_fwd_smem_bytes(int head_dim) {
  return (int)(head_dim == 256   ? FwdShape<256>::kSmem
               : head_dim == 128 ? FwdShape<128>::kSmem
                                 : FwdShape<64>::kSmem);
}

// q/o [B,S,H,Hd], k/v [B,S,KV,Hd] contiguous and 16-byte aligned; lse
// [B,H,S] f32; mask [B,S] f32 additive key bias or null; slopes [H] f32 or
// null. dtype 0 = fp16, 1 = bf16; head_dim 64, 128 or 256. tile_offsets /
// tile_entries: the live-tile lists of a block layout, one per (head, q
// tile) (ds::TileList), blocks its kept blocks [H, nb, nb] uint8, walked a
// counter of the tiles walked; all null (nb 0) without a layout. Returns
// cudaGetLastError() after the launch (cudaErrorNotSupported when the TMA
// maps cannot be made).
extern "C" int ds_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                      float* lse, const float* mask, const float* slopes,
                                      int B, int S, int H, int KV, int head_dim, int causal,
                                      float scale_log2, int dtype, const int* tile_offsets,
                                      const int* tile_entries, const unsigned char* blocks,
                                      int nb, unsigned long long* walked, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ds::TileList tl{tile_offsets, tile_entries, blocks, nb, walked};
#define DS_FWD(T, HD) launch<T, HD>(q, k, v, o, lse, mask, slopes, B, S, H, KV, causal, \
                                    scale_log2, tl, st)
  if (dtype == 1 && head_dim == 256) return DS_FWD(__nv_bfloat16, 256);
  if (dtype == 1 && head_dim == 128) return DS_FWD(__nv_bfloat16, 128);
  if (dtype == 1 && head_dim == 64) return DS_FWD(__nv_bfloat16, 64);
  if (dtype == 0 && head_dim == 256) return DS_FWD(__half, 256);
  if (dtype == 0 && head_dim == 128) return DS_FWD(__half, 128);
  if (dtype == 0 && head_dim == 64) return DS_FWD(__half, 64);
#undef DS_FWD
  return (int)cudaErrorInvalidValue;
}
