// The device bodies shared by the two decode-attention kernels: the paged one
// (paged_decode_attention.cu, kernel B, TPU K6) and the dense one
// (dense_decode_attention.cu, TPU K5). Both attend one new query token per
// batch row against its cached keys; they differ only in which cache row
// holds logical key ``key`` of a row, which the ``Rows`` functor answers:
//   paged: block_tables[b, key / bs] * bs + key % bs   (a pool shared by every row)
//   dense: b * Smax + key                               (the row's own [Smax, KV, Hd])
// Either way the cache is a 2-D view [rows, KV * Hd] and a row's slice for
// kv head kvh starts at column kvh * Hd.
//
// Bound on the H100: a decode step reads every live K/V byte once and does
// 4 * G FLOPs per 4 bytes of K/V (G = H / KV query heads per kv head), far
// below the bf16 ridge (about 295 FLOP/byte): the live K/V bytes over
// 3.35 TB/s bound it. Every live byte has to be in flight early, on every SM.
//
// Design (flash-decoding):
// * Split. A row's live keys are cut into splits of kSplitKeys (128) keys,
//   one fp32 partial (m, l, acc[G][Hd]) each. The grid is (KV, B, Z); the CTA
//   (kvh, b, z) takes splits z, z + Z, ... of row b below its live count
//   pos / 128 + 1, for all G query heads of the kv group, so each K/V byte is
//   still read once per group. Z is chosen on the host from shapes alone
//   (the paged n_max * bs / 128 splits, the dense host pos) so that a launch
//   has about kDecodeTargetCtas CTAs; a CTA with no live split returns at
//   once. A second kernel (decode_combine, one CTA per query head and row)
//   merges a row's partials in split order, with no atomics, so two
//   launches give the same bits whatever Z is. (Merging in the CTA that
//   finishes a row's last split, found through an integer counter, saved
//   that launch but cost each CTA a fence: 4-7 us more at the slices.)
// * Ring. The CTA's tiles (decode_tile_keys<G, HD>() keys of K and of V) stream
//   through a kDecodeStages-deep shared-memory ring filled by cp.async.cg
//   16-byte copies, neighbouring threads on neighbouring chunks of a row; the
//   copies run kDecodeStages - 1 tiles ahead of the math, across split
//   boundaries. cp.async rather than TMA: the paged rows of a tile come from
//   a block the CTA looks up itself, and a TMA map would have to be encoded on
//   the host for every pool pointer (32 layers a step on a host-bound path)
//   and passed as a __grid_constant__; cp.async needs no descriptor.
// * Math from shared memory. Each warp owns a quarter of a tile's keys. Hd / 8
//   lanes split a key row (32 at Hd 256, 16 at Hd 128, 12 at Hd 96, 8 at Hd
//   64), each on a 16-byte slice; a row takes a power-of-two group of lanes
//   (a whole warp at Hd 256; 16 at Hd 96, whose last four hold zeros and
//   load nothing), so the shuffle reductions
//   stay butterflies, with q (pre-scaled in T, then fp32) held in registers for that
//   slice: the score is a shuffle reduction over the row's lanes, and P V
//   reuses the same lane-to-slice map, so a lane multiplies its own V slice
//   by the probabilities its row group already holds. Each warp keeps its own
//   fp32 running (m, l, acc) with natural exp, as the TPU kernels; at the end
//   of a split the four warps merge in warp order through shared memory.
// * Masking: keys past pos score -1e30 (the TPU kernels' constant); ALiBi and
//   the additive pad bias apply over LOGICAL positions.
#pragma once

#include "common.cuh"

namespace ds {

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kSplitKeys = 128;          // keys of one split (one partial)
// tiles in the shared-memory ring: three keep a CTA at 48 KB + 2 KB at
// Hd 128, so four CTAs fit on an SM (as many as 127 registers allow)
constexpr int kDecodeStages = 3;
// CTAs a launch aims for (32 per SM of 132): a long row's splits spread over
// every SM, with one split per CTA at the slices' depths (pos < 2176 at
// Llama-7B's 32 kv heads and 8 rows); CTAs past a row's pos exit at once
constexpr int kDecodeTargetCtas = 32 * 132;

// Keys of one ring tile: 8 a warp, 4 at G 8 (q and acc take 128 registers
// there); half that at Hd 256, so a tile holds the bytes it holds at Hd 128
// and the ring stays at 48 KB.
template <int G, int HD>
__host__ __device__ constexpr int decode_tile_keys() {
  return (G >= 8 ? 16 : 32) / (HD > 128 ? 2 : 1);
}

// Dynamic shared memory of one split CTA, in bytes: the ring (K and V tiles
// of 2-byte elements) and the warps' merge area.
template <int HD, int G>
constexpr size_t decode_smem_bytes() {
  return (size_t)kDecodeStages * 2 * decode_tile_keys<G, HD>() * HD * 2 +
         (size_t)kDecodeWarps * G * (HD + 2) * sizeof(float);
}

// The grid's Z for rows of ``splits`` splits.
inline int decode_grid_z(int splits, int kv, int batch) {
  const int want = (kDecodeTargetCtas + kv * batch - 1) / (kv * batch);
  return want < splits ? (want < 1 ? 1 : want) : splits;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight 2-byte elements of one 16-byte load, as floats.
template <typename T>
__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < 8; ++u) f[u] = to_float(e[u]);
}

// The combine kernel's body for query head h = kvh * G + g of row b, one
// thread per head dim d (blockDim.x == HD): the row's n_live partials merged
// in split order, out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M) with
// M = max_s m_s. part_acc / part_ml: this (b, kvh)'s partials as in
// decode_split; out_head: the [HD] output of head h of row b.
template <typename T, int HD, int G>
__device__ __forceinline__ void decode_combine(const float* __restrict__ part_acc,
                                               const float* __restrict__ part_ml, int n_live,
                                               int g, T* __restrict__ out_head) {
  const int d = threadIdx.x;
  float mm = kMasked;
  for (int s = 0; s < n_live; ++s) mm = fmaxf(mm, part_ml[(s * G + g) * 2]);
  float a = 0.f, ll = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float wt = expf(part_ml[(s * G + g) * 2] - mm);
    a += part_acc[((long)s * G + g) * HD + d] * wt;
    ll += part_ml[(s * G + g) * 2 + 1] * wt;
  }
  out_head[d] = from_float<T>(a / ll);
}

// The split kernel's body for CTA (kvh, b, blockIdx.z).
// q_row: row b's [H, HD] query, not yet scaled; kc / vc: the caches offset to
// kv head kvh (element kvh * HD of row 0); rows(key): the cache row of
// logical key ``key`` (tiles never cross a paged block: bs % 128 == 0);
// row_stride: elements between cache rows (KV * HD); n_live: live splits of
// this row (pos / 128 + 1, at most the row's split count); bias_row: the
// row's logical pad bias or null; part_acc / part_ml: this (b, kvh)'s
// partials, [splits][G][HD] and [splits][G][2] fp32.
template <typename T, int HD, int G, class Rows>
__device__ __forceinline__ void decode_split(const T* __restrict__ q_row, float scale,
                                             const T* __restrict__ kc,
                                             const T* __restrict__ vc, const Rows& rows,
                                             long row_stride, int pos, int n_live,
                                             const float* __restrict__ bias_row,
                                             const float* __restrict__ slopes, int kvh,
                                             float* __restrict__ part_acc,
                                             float* __restrict__ part_ml, char* smem) {
  constexpr int TK = decode_tile_keys<G, HD>();
  constexpr int VPR = HD / 8;                  // 16-byte slices of one key row
  // lanes on one key row (a power of two; a whole warp at Hd 256)
  constexpr int LPR = VPR <= 8 ? 8 : VPR <= 16 ? 16 : 32;
  constexpr int RPW = 32 / LPR;                // rows a warp reads at once
  constexpr int KPW = TK / kDecodeWarps;       // keys of a tile per warp
  constexpr int NP = KPW / RPW;                // passes of a warp over its keys
  constexpr int TILES = kSplitKeys / TK;       // tiles of a full split
  constexpr int CHUNKS = TK * VPR;             // 16-byte chunks of a K (or V) tile
  static_assert(HD % 8 == 0 && VPR <= LPR && NP >= 1 && KPW % RPW == 0, "tile shape");

  const int split0 = blockIdx.z, zstep = gridDim.z;
  if (split0 >= n_live) return;                // an empty CTA costs one compare

  T* ring = reinterpret_cast<T*>(smem);        // [stage][K|V][TK][HD]
  float* red_acc = reinterpret_cast<float*>(ring + kDecodeStages * 2 * TK * HD);
  float* red_m = red_acc + kDecodeWarps * G * HD;        // [warp][G]
  float* red_l = red_m + kDecodeWarps * G;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / LPR, sub = lane % LPR;
  const bool slice = sub < VPR;                // the lane holds a slice of the row

  // tiles of split s: up to the one holding pos
  auto n_tiles = [&](int s) { return min(TILES, (pos - s * kSplitKeys) / TK + 1); };
  auto load_tile = [&](int s, int t, int stage) {
    const int key0 = s * kSplitKeys + t * TK;
    const long r0 = rows(key0);
    T* sk = ring + stage * 2 * TK * HD;
    T* sv = sk + TK * HD;
#pragma unroll
    for (int i = 0; i < (CHUNKS + kDecodeThreads - 1) / kDecodeThreads; ++i) {
      const int c = tid + i * kDecodeThreads;
      if (CHUNKS % kDecodeThreads != 0 && c >= CHUNKS) break;
      const int r = c / VPR, ch = c % VPR;
      const long g_off = (r0 + r) * row_stride + ch * 8;
      cp_async16(sk + r * HD + ch * 8, kc + g_off);
      cp_async16(sv + r * HD + ch * 8, vc + g_off);
    }
  };

  // q for this lane's slice, pre-scaled in T as the TPU kernel, then fp32
  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = slice ? *reinterpret_cast<const uint4*>(q_row + (long)(kvh * G + g) * HD +
                                                               sub * 8)
                            : make_uint4(0, 0, 0, 0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < 8; ++u) qf[g][u] = to_float(from_float<T>(to_float(e[u]) * scale));
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kMasked;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[g][u] = 0.f;
  }

  // producer cursor runs kDecodeStages - 1 tiles ahead of the consumer's
  int ps = split0, pt = 0, cs = split0, ct = 0;
  auto advance = [&](int& s, int& t) {
    if (++t == n_tiles(s)) { t = 0; s += zstep; }
  };
#pragma unroll
  for (int i = 0; i < kDecodeStages - 1; ++i) {
    if (ps < n_live) { load_tile(ps, pt, i); advance(ps, pt); }
    cp_async_commit();
  }

  int stage = 0;
  while (cs < n_live) {
    if (ps < n_live) {
      load_tile(ps, pt, (stage + kDecodeStages - 1) % kDecodeStages);
      advance(ps, pt);
    }
    cp_async_commit();
    cp_async_wait<kDecodeStages - 1>();
    __syncthreads();

    const T* sk = ring + stage * 2 * TK * HD;
    const T* sv = sk + TK * HD;
    const int key0 = cs * kSplitKeys + ct * TK;
    float s[NP][G];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int kt = warp * KPW + p * RPW + grp;
      float kf[8];
      unpack8<T>(slice ? *reinterpret_cast<const uint4*>(sk + kt * HD + sub * 8)
                       : make_uint4(0, 0, 0, 0), kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) d = fmaf(qf[g][u], kf[u], d);
        s[p][g] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int g = 0; g < G; ++g) s[p][g] += __shfl_xor_sync(0xffffffffu, s[p][g], off);

    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = kMasked;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int kpos = key0 + warp * KPW + p * RPW + grp;
      const float rel = (float)(kpos - pos);
      const float bias = bias_row != nullptr ? bias_row[kpos] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = s[p][g];
        if (slopes != nullptr) v += slopes[kvh * G + g] * rel;
        if (bias_row != nullptr) v += bias;
        v = kpos <= pos ? v : kMasked;
        s[p][g] = v;
        mx[g] = fmaxf(mx[g], v);
      }
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));

    float alpha[G], psum[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      alpha[g] = expf(m[g] - m_new);
      m[g] = m_new;
      psum[g] = 0.f;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        s[p][g] = expf(s[p][g] - m_new);
        psum[g] += s[p][g];
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[g][u] *= alpha[g];
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) psum[g] += __shfl_xor_sync(0xffffffffu, psum[g], off);
#pragma unroll
    for (int g = 0; g < G; ++g) l[g] = l[g] * alpha[g] + psum[g];

#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int kt = warp * KPW + p * RPW + grp;
      float vf[8];
      unpack8<T>(slice ? *reinterpret_cast<const uint4*>(sv + kt * HD + sub * 8)
                       : make_uint4(0, 0, 0, 0), vf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[g][u] = fmaf(s[p][g], vf[u], acc[g][u]);
    }

    if (ct + 1 == n_tiles(cs)) {
      // the split is done: the row groups of each warp share its m, so their
      // acc add; then the warps merge in warp order into the split's partial
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int u = 0; u < 8; ++u) acc[g][u] += __shfl_xor_sync(0xffffffffu, acc[g][u], off);
      if (grp == 0 && slice) {
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int u = 0; u < 8; ++u) red_acc[(warp * G + g) * HD + sub * 8 + u] = acc[g][u];
      }
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          red_m[warp * G + g] = m[g];
          red_l[warp * G + g] = l[g];
        }
      }
      __syncthreads();
      float* pa = part_acc + (long)cs * G * HD;
      float* pm = part_ml + (long)cs * G * 2;
      for (int i = tid; i < G * HD; i += kDecodeThreads) {
        const int g = i / HD, d = i % HD;
        float mm = kMasked;
#pragma unroll
        for (int w = 0; w < kDecodeWarps; ++w) mm = fmaxf(mm, red_m[w * G + g]);
        float a = 0.f, ll = 0.f;
#pragma unroll
        for (int w = 0; w < kDecodeWarps; ++w) {
          const float wt = expf(red_m[w * G + g] - mm);
          a += red_acc[(w * G + g) * HD + d] * wt;
          ll += red_l[w * G + g] * wt;
        }
        pa[i] = a;
        if (d == 0) {
          pm[2 * g] = mm;
          pm[2 * g + 1] = ll;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        m[g] = kMasked;
        l[g] = 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[g][u] = 0.f;
      }
    }
    __syncthreads();          // the next load overwrites this stage
    advance(cs, ct);
    stage = (stage + 1) % kDecodeStages;
  }
  cp_async_wait<0>();
}

}  // namespace ds
