// Fused logits-free cross-entropy for Hopper (sm_90a): the port of the TPU
// kernels deepspeed_tpu/ops/pallas/fused_cross_entropy.py _fwd_kernel (K3
// fwd), _dh_kernel (K3 dh) and _dw_kernel (K3 dW). The vocab head's loss
// mean CE(h W + b, labels), h [N, D], W [D, V], never forms the [N, V]
// logits in the forward, and forms them in the backward only as ds, once, in
// h's dtype.
//
// Why the TPU structure does not carry over: the TPU grid kept a [bt, D]
// fp32 dh accumulator and a [D, bv] fp32 dW accumulator in VMEM (>= 1 MB
// each at D = 4096) and accumulated across a sequential grid axis. A Hopper
// CTA has <= 227 KB of shared memory and <= 255 registers a thread, and
// CTAs run in no order: splitting D over CTAs would recompute the logits
// D / Dt times, and atomics would add ~32 GB of fp32 a micro-step in an
// order that changes from run to run. So the work is split into five
// kernels, every one deterministic:
//
//   fused_ce_fwd_kernel (F)  one CTA per (128-token tile, vocab split of ~8
//       tiles): for each 128-column vocab tile, s = (h W + b) log2e from
//       bf16 mma.sync with fp32 accumulators (K loop over D through a
//       cp.async ring), staged in shared memory; two threads per token fold
//       the tile into the running (max, sum, gold) in registers. Writes one
//       (m, l, gold) triple per token and split.
//   fused_ce_combine_kernel  merges the splits: lse = log2-domain logsumexp,
//       nll = (lse - gold) / log2e, both [N] fp32.
//   fused_ce_ds_kernel (G)   one CTA per (128-token, 256-vocab) tile:
//       recomputes s as F does, ds = (exp2(s - lse) - onehot) coef in fp32
//       from the accumulator registers, written once in h's dtype to ds
//       [N, V] (row stride padded to 8), and the tile's fp32 column sums of
//       ds (db partials, one row per token tile).
//   fused_ce_db_kernel       db[v] = sum of the partials over token tiles, in
//       order.
//   ce_dh_gemm_kernel, ce_dw_gemm_kernel  dh = ds W^T and dW = h^T ds (or,
//       for a tied head stored [V, D], dE = ds^T h), cast once at the end.
//
// Memory: the forward holds nothing of size N x V; the backward holds ds,
// N x V x 2 B (0.52 GB at N 8192, V 32000), where the plain path holds the
// bf16 logits, the fp32 logits and their fp32 softmax (about 2.5 GB).
//
// Rounding points are the TPU kernels': s from storage-dtype operands with
// fp32 accumulation, the softmax in the log2 domain, ds cast to W's dtype
// for dh (_dh_kernel :131-132) and to h's dtype for dW (:157-158), which
// are one type because the wrapper casts W to h's dtype; db sums the fp32
// ds. Rows >= N and columns >= V are masked in-kernel (zero operands,
// skipped columns), which equals the TPU package's -1e30 pad bias.
//
// Bound on the H100: each kernel does one 2 N D V product (2.15e12 FLOPs
// at N 8192, D 4096, V 32000: 2.2 ms at 989 TFLOP/s); the backward does
// three (6.5 ms) and moves ds three times (~0.5 ms): all bound by
// operations, so the tensor cores' rate is the design's target.
//
// G, dh and dW run on the Hopper mainloop of wgmma_gemm.cuh: 128 x 256
// output tiles, 64-deep K chunks brought by TMA (128-byte swizzle) into a
// four-stage ring guarded by mbarriers, one producer warp, two consumer
// warpgroups running m64n256k16 wgmma from shared memory with fp32 register
// accumulators. The three products take each operand as it lies in memory,
// K-major (rows of the reduction) or MN-major:
//
//   G    A = h [N, D] K-major; B = W [D, V] MN-major, tied W stored [V, D]
//        K-major
//   dh   A = ds [N, V] K-major; B = W^T: stored [D, V] K-major, tied [V, D]
//        MN-major
//   dW   A = h^T and B = ds, both MN-major (tied: A = ds^T, B = h)
//
// TMA needs 16-byte aligned rows: the wrapper copies an operand whose row
// stride is not a multiple of 8 elements into padded rows first (an untied
// W with V = 50257, h with D % 8 != 0); a tied head is read in place.
//
// F still runs the first design's mainloop: mma.sync m16n8k16 on 128 x 128
// x 32 tiles fed by ldmatrix from a three-stage cp.async ring in which all
// 256 threads copy and compute (16-byte copies where the row stride allows,
// else element by element); its redesign on the Hopper mainloop is next.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int kBM = 128;          // F's tile rows (tokens)
constexpr int kBN = 128;          // F's tile columns (vocab)
constexpr int kBK = 32;           // reduction chunk
constexpr int kThreads = 256;     // 8 warps: 4 along M x 2 along N, 32 x 64 each
constexpr int kPitchK = kBK + 8;  // a K-contiguous tile: [128][kPitchK]
constexpr int kPitchMN = 128 + 8; // an M/N-contiguous tile: [kBK][kPitchMN]
constexpr int kSPitch = kBN + 4;  // staged fp32 logits [kBM][kSPitch]
constexpr int kStages = 3;        // cp.async pipeline depth of the reduction loop

template <bool KC>
constexpr int kTileElems = KC ? 128 * kPitchK : kBK * kPitchMN;   // elements of a tile

// One 16-byte cp.async from global to shared memory (bypassing L1).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Start copying the ROWS x COLS window at (row0, col0) of a row-major matrix
// with row stride ld into dst (pitch PITCH); elements outside [0, row_lim)
// x [0, col_lim) read as zero. 16-byte cp.async where vec_ok (ld % 8 == 0
// and a 16-byte aligned base) and the vector lies inside; else element-wise
// loads stored at once (an untied W with V = 50257, ragged edges).
template <typename T, int ROWS, int COLS, int PITCH>
__device__ __forceinline__ void load_window(T* dst, const T* __restrict__ src, long ld, int row0,
                                            int col0, int row_lim, int col_lim, bool vec_ok,
                                            int tid) {
  constexpr int kVec = 8;
  constexpr int kPerRow = COLS / kVec;
  for (int i = tid; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const int gr = row0 + r, gc = col0 + c;
    T* d = dst + r * PITCH + c;
    const T* p = src + (long)gr * ld + gc;
    if (vec_ok && gr < row_lim && gc + kVec <= col_lim) {
      cp_async16(d, p);
      continue;
    }
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < row_lim && gc < col_lim) {
      T* e = reinterpret_cast<T*>(&val);
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        if (gc + u < col_lim) e[u] = p[u];
    }
    *reinterpret_cast<uint4*>(d) = val;
  }
}

// Four 8x8 16-bit matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give matrix i's rows); .trans delivers them transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The mma A fragment of the 16 x 16 block at (m0, k0) of a tile stored
// K-contiguous ([m][k]). Fragment i = (rows m0 + 8 (i & 1), columns k0 + 8
// (i >> 1)).
template <typename T>
__device__ __forceinline__ void a_frag(uint32_t* a, const T* As, int m0, int k0, int lane) {
  const int i = lane >> 3, j = lane & 7;
  ldmatrix_x4<false>(a, As + (m0 + 8 * (i & 1) + j) * kPitchK + k0 + 8 * (i >> 1));
}

// The mma B fragments of two 16 x 8 blocks, columns n0 .. n0 + 15 at k0,
// from a tile stored K-contiguous ([n][k]) or N-contiguous ([k][n]):
// b[0..1] columns n0 .. n0 + 7, b[2..3] columns n0 + 8 .. n0 + 15.
template <typename T, bool KC>
__device__ __forceinline__ void b_frag2(uint32_t* b, const T* Bs, int n0, int k0, int lane) {
  const int i = lane >> 3, j = lane & 7;
  if (KC) ldmatrix_x4<false>(b, Bs + (n0 + 8 * (i >> 1) + j) * kPitchK + k0 + 8 * (i & 1));
  else ldmatrix_x4<true>(b, Bs + (k0 + 8 * (i & 1) + j) * kPitchMN + n0 + 8 * (i >> 1));
}

// acc = A[m0:m0+128, :K] B[:K, n0:n0+128] in fp32 on the tensor cores (F's
// mainloop). A is [M, K] stored K-contiguous (row stride lda); B is [N, K]
// stored K-contiguous (B_KC) or [K, N] stored N-contiguous. As / Bs hold
// kStages chunks each: the next chunks load
// (cp.async) while the tensor cores run on this one. Warp (wm, wn) owns
// rows wm*32 + [0, 32) and columns wn*64 + [0, 64): acc[mt][nt][e] is row
// wm*32 + mt*16 + g + 8*(e >= 2), column wn*64 + nt*8 + 2t + (e & 1), with
// g = lane / 4, t = lane % 4.
template <typename T, bool B_KC>
__device__ __forceinline__ void tile_product(float (&acc)[2][8][4], const T* __restrict__ A,
                                             long lda, bool a_vec, const T* __restrict__ B,
                                             long ldb, bool b_vec, int m0, int n0, int M, int N,
                                             int K, T* As, T* Bs) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  auto load = [&](int stage, int k0) {
    T* as = As + stage * kTileElems<true>;
    T* bs = Bs + stage * kTileElems<B_KC>;
    load_window<T, kBM, kBK, kPitchK>(as, A, lda, m0, k0, M, K, a_vec, tid);
    if (B_KC) load_window<T, kBN, kBK, kPitchK>(bs, B, ldb, n0, k0, N, K, b_vec, tid);
    else load_window<T, kBK, kBN, kPitchMN>(bs, B, ldb, k0, n0, K, N, b_vec, tid);
  };

  const int nk = (K + kBK - 1) / kBK;
  __syncthreads();   // every warp is done with the caller's earlier use of this memory
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {   // one commit group per chunk, empty past nk
    if (st < nk) load(st, st * kBK);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kStages - 2>();   // chunk kc has landed (its group and all before it)
    __syncthreads();                // ... for every thread; and chunk kc - 1's stage is free
    if (kc + kStages - 1 < nk) load((kc + kStages - 1) % kStages, (kc + kStages - 1) * kBK);
    cp_async_commit();
    const T* as = As + (kc % kStages) * kTileElems<true>;
    const T* bs = Bs + (kc % kStages) * kTileElems<B_KC>;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) a_frag<T>(a[mt], as, wm * 32 + mt * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np)
        b_frag2<T, B_KC>(&b[2 * np][0], bs, wn * 64 + np * 16, kk, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) ds::mma16816<T>(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the stages: the caller may reuse the memory
}

// S[r][c] = (acc + b[v0 + c]) * log2e for the tile's rows r and columns c
// (the TPU kernels' _block_logits).
__device__ __forceinline__ void stage_logits(const float (&acc)[2][8][4], float* S,
                                             const float* __restrict__ bias, int v0, int V) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = wn * 64 + nt * 8 + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (v0 + c < V) b0 = bias[v0 + c];
      if (v0 + c + 1 < V) b1 = bias[v0 + c + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm * 32 + mt * 16 + g;
      *reinterpret_cast<float2*>(S + r * kSPitch + c) =
          make_float2((acc[mt][nt][0] + b0) * ds::kLog2e, (acc[mt][nt][1] + b1) * ds::kLog2e);
      *reinterpret_cast<float2*>(S + (r + 8) * kSPitch + c) =
          make_float2((acc[mt][nt][2] + b0) * ds::kLog2e, (acc[mt][nt][3] + b1) * ds::kLog2e);
    }
  }
}

// Dynamic shared memory of a tile product's pipeline.
template <typename T, bool B_KC>
constexpr size_t pipeline_bytes() {
  return kStages * sizeof(T) * (kTileElems<true> + kTileElems<B_KC>);
}

// F stages the fp32 logits over the pipeline's memory once the product is
// done (tile_product ends and starts with a barrier).
template <typename T, bool W_KC>
constexpr size_t head_smem_bytes() {
  return sizeof(float) * kBM * kSPitch > pipeline_bytes<T, W_KC>()
             ? sizeof(float) * kBM * kSPitch : pipeline_bytes<T, W_KC>();
}

// F. part [3][vsplit][N]: the running max, sum and gold logit (log2 domain)
// of each token over its split's vocab tiles vt = split, split + vsplit, ...
template <typename T, bool W_KC>
__global__ void __launch_bounds__(kThreads)
fused_ce_fwd_kernel(const T* __restrict__ h, int h_vec, const T* __restrict__ w, long ldw,
                    int w_vec, const float* __restrict__ bias, const int* __restrict__ labels,
                    float* __restrict__ part, int N, int D, int V, int vsplit) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);            // kStages chunks each
  T* Bs = As + kStages * kTileElems<true>;
  float* S = reinterpret_cast<float*>(smem);     // after each product, over the stages
  const int m0 = blockIdx.x * kBM, split = blockIdx.y;
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;   // two threads per token
  const int row = m0 + r;
  const int lab = row < N ? labels[row] : -1;
  const float* srow = S + r * kSPitch;
  float m_run = ds::kMasked, l_run = 0.f, g_run = 0.f;
  const int nvt = (V + kBN - 1) / kBN;

  for (int vt = split; vt < nvt; vt += vsplit) {
    const int v0 = vt * kBN;
    float acc[2][8][4];
    tile_product<T, W_KC>(acc, h, D, h_vec, w, ldw, w_vec, m0, v0, N, V, D, As, Bs);
    stage_logits(acc, S, bias, v0, V);
    __syncthreads();
    const int ncol = min(kBN, V - v0);
    float mx = ds::kMasked;
    for (int c = half; c < ncol; c += 2) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
    for (int c = half; c < ncol; c += 2) sum += exp2f(srow[c] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * exp2f(m_run - m_new) + sum;
    m_run = m_new;
    const int lc = lab - v0;
    if (lc >= 0 && lc < ncol && (lc & 1) == half) g_run += srow[lc];
    // the next tile_product's leading __syncthreads() guards S
  }
  g_run += __shfl_xor_sync(0xffffffffu, g_run, 1);
  if (half == 0 && row < N) {
    part[(long)split * N + row] = m_run;
    part[(long)(vsplit + split) * N + row] = l_run;
    part[(long)(2 * vsplit + split) * N + row] = g_run;
  }
}

__global__ void fused_ce_combine_kernel(const float* __restrict__ part, float* __restrict__ nll,
                                        float* __restrict__ lse, int N, int vsplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float m = ds::kMasked;
  for (int s = 0; s < vsplit; ++s) m = fmaxf(m, part[(long)s * N + i]);
  float l = 0.f, gold = 0.f;
  for (int s = 0; s < vsplit; ++s) {
    l += part[(long)(vsplit + s) * N + i] * exp2f(part[(long)s * N + i] - m);
    gold += part[(long)(2 * vsplit + s) * N + i];
  }
  const float lse2 = m + log2f(l);   // every token saw >= 1 live column, so l >= 1
  lse[i] = lse2;
  nll[i] = (lse2 - gold) / ds::kLog2e;
}

// G. ds [N, ld_ds] in T (columns V .. ld_ds - 1 zero) and db_part
// [ceil(N / 128)][V] fp32, one row per token tile (null without a bias).
// The logits tile from the wgmma mainloop (A = h [N, D] K-major; B = W
// [D, V] MN-major, or a tied head stored [V, D] K-major), then ds from the
// registers, staged in shared memory and stored as 16-byte rows.
template <typename T, bool W_KC>
__global__ void __launch_bounds__(ds::kGemmThreads, 1)
fused_ce_ds_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ bias, const int* __restrict__ labels,
                   const float* __restrict__ lse, const float* __restrict__ coef,
                   T* __restrict__ dsout, long ld_ds, float* __restrict__ db_part, int N, int D,
                   int V) {
  ds::gemm_tile_run<T, true, W_KC>(&hmap, &wmap, N, V, D, [=](float (&acc)[128],
                                                              unsigned char* smem,
                                                              const ds::GemmTile& tile) {
    const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
    const int r0 = tile.m0 + tid / 128 * 64 + tid / 32 % 4 * 16 + (lane >> 2);
    bool live[2];
    float lse_r[2], c_r[2];
    int lab[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {   // this thread's rows r0 and r0 + 8
      const int row = r0 + 8 * h2;
      live[h2] = row < N;
      lse_r[h2] = live[h2] ? lse[row] : 0.f;
      c_r[h2] = live[h2] ? coef[row] : 0.f;
      lab[h2] = live[h2] ? labels[row] : -1;
    }
    // ds = (exp2(s - lse) - onehot) * coef in fp32 with s = (acc + b) log2e
    // (the TPU kernels' _block_logits and _softmax_minus_onehot); zero
    // outside rows < N and columns < V
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = tile.n0 + 8 * i + 2 * t + e;
        const float b = bias != nullptr && col < V ? bias[col] : 0.f;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float& a = acc[4 * i + 2 * h2 + e];
          a = live[h2] && col < V
                  ? (exp2f((a + b) * ds::kLog2e - lse_r[h2]) - (col == lab[h2] ? 1.f : 0.f)) * c_r[h2]
                  : 0.f;
        }
      }
    T* out = reinterpret_cast<T*>(smem);
    float* colsum = reinterpret_cast<float*>(smem + ds::kGemmBM * ds::kOutPitch * sizeof(T));
    ds::consumer_sync();   // both warpgroups are done reading the ring
    ds::stage_out_tile<T>(acc, out);
    if (db_part != nullptr) {
      // the fp32 ds summed down each column: the thread's two rows, the 8
      // lanes of the column (16 rows a warp), then the 8 warps in order
#pragma unroll
      for (int i = 0; i < 32; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[4 * i + e] + acc[4 * i + 2 + e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4) colsum[tid / 32 * ds::kGemmBN + 8 * i + 2 * t + e] = v;
        }
    }
    ds::consumer_sync();
    ds::store_out_tile<T>(out, dsout, ld_ds, tile.m0, tile.n0, N, (int)ld_ds);
    if (db_part != nullptr && tile.n0 + tid < V) {   // thread tid sums column tid
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < ds::kGemmConsumers / 32; ++w) s += colsum[w * ds::kGemmBN + tid];
      db_part[(long)tile.mt * V + tile.n0 + tid] = s;
    }
  });
}

// C [M, N] (row stride ldc) from the accumulators, rounded once to T.
template <typename T>
__device__ __forceinline__ void store_product(const float (&acc)[128], unsigned char* smem,
                                              T* __restrict__ C, long ldc,
                                              const ds::GemmTile& tile, int M, int N) {
  T* out = reinterpret_cast<T*>(smem);
  ds::consumer_sync();   // both warpgroups are done reading the ring
  ds::stage_out_tile<T>(acc, out);
  ds::consumer_sync();
  ds::store_out_tile<T>(out, C, ldc, tile.m0, tile.n0, M, N);
}

// dh [N, D] = ds [N, V] W^T: A = ds (K-major); B = W^T, stored [D, V]
// (K-major) or, for a tied head, [V, D] (MN-major).
template <typename T, bool B_K>
__global__ void __launch_bounds__(ds::kGemmThreads, 1)
ce_dh_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  T* __restrict__ C, long ldc, int M, int N, int K) {
  ds::gemm_tile_run<T, true, B_K>(&amap, &bmap, M, N, K, [=](float (&acc)[128], unsigned char* smem,
                                                             const ds::GemmTile& tile) {
    store_product<T>(acc, smem, C, ldc, tile, M, N);
  });
}

// dW [D, V] = h^T ds (A = h^T, B = ds), or for a tied head stored [V, D],
// dE [V, D] = ds^T h (A = ds^T, B = h): both operands MN-major.
template <typename T>
__global__ void __launch_bounds__(ds::kGemmThreads, 1)
ce_dw_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                  T* __restrict__ C, long ldc, int M, int N, int K) {
  ds::gemm_tile_run<T, false, false>(&amap, &bmap, M, N, K, [=](float (&acc)[128],
                                                                unsigned char* smem,
                                                                const ds::GemmTile& tile) {
    store_product<T>(acc, smem, C, ldc, tile, M, N);
  });
}

__global__ void fused_ce_db_kernel(const float* __restrict__ db_part, float* __restrict__ db,
                                   int n_tiles, int V) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  float s = 0.f;
  for (int i = 0; i < n_tiles; ++i) s += db_part[(long)i * V + v];
  db[v] = s;
}

template <typename T, bool W_KC>
int launch_fwd(const void* h, int h_vec, const void* w, long ldw, int w_vec, const float* bias,
               const int* labels, float* part, float* nll, float* lse, int N, int D, int V,
               int vsplit, cudaStream_t st) {
  constexpr size_t smem = head_smem_bytes<T, W_KC>();
  auto kern = fused_ce_fwd_kernel<T, W_KC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kBM - 1) / kBM, vsplit);
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(h), h_vec, static_cast<const T*>(w), ldw,
                                     w_vec, bias, labels, part, N, D, V, vsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_ce_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, nll, lse, N, vsplit);
  return (int)cudaGetLastError();
}

// One launch of a wgmma product kernel over the ceil(M / 128) x ceil(N /
// 256) output tiles.
template <typename Kern, typename... Args>
int launch_tiles(Kern kern, int M, int N, cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)ds::kGemmSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<ds::gemm_grid(M, N), ds::kGemmThreads, ds::kGemmSmemBytes, st>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, bool W_KC>
int launch_ds(const void* h, long ldh, const void* w, long ldw, const float* bias,
              const int* labels, const float* lse, const float* coef, void* dsout, long ld_ds,
              float* db_part, float* db, int N, int D, int V, cudaStream_t st) {
  CUtensorMap hmap, wmap;
  if (!ds::make_gemm_maps<T, true, W_KC>(&hmap, &wmap, h, ldh, w, ldw, N, V, D))
    return (int)cudaErrorInvalidValue;
  int err = launch_tiles(fused_ce_ds_kernel<T, W_KC>, N, V, st, hmap, wmap, bias, labels, lse,
                         coef, static_cast<T*>(dsout), ld_ds, db_part, N, D, V);
  if (err != 0 || db_part == nullptr) return err;
  const int n_tiles = (N + ds::kGemmBM - 1) / ds::kGemmBM;
  fused_ce_db_kernel<<<(V + 255) / 256, 256, 0, st>>>(db_part, db, n_tiles, V);
  return (int)cudaGetLastError();
}

// The dh product (A K-major) or the dW product (A and B MN-major).
template <typename T, bool A_K, bool B_K>
int launch_gemm(const void* A, long lda, const void* B, long ldb, void* C, long ldc, int M, int N,
                int K, cudaStream_t st) {
  CUtensorMap amap, bmap;
  if (!ds::make_gemm_maps<T, A_K, B_K>(&amap, &bmap, A, lda, B, ldb, M, N, K))
    return (int)cudaErrorInvalidValue;
  T* c = static_cast<T*>(C);
  if constexpr (A_K) return launch_tiles(ce_dh_gemm_kernel<T, B_K>, M, N, st, amap, bmap, c, ldc, M, N, K);
  else return launch_tiles(ce_dw_gemm_kernel<T>, M, N, st, amap, bmap, c, ldc, M, N, K);
}

}  // namespace

// dtype 0 = fp16, 1 = bf16 (every operand). w_kc: W is stored [V, D] (a tied
// head, W = embed.T) rather than [D, V]; ldw its row stride. F's *_vec: the
// operand's row stride is a multiple of 8 elements and its base 16-byte
// aligned. Each returns cudaGetLastError() after its launches.

// F: h [N, D] contiguous, bias [V] f32 or null, labels [N] int32 in [0, V);
// part [3, vsplit, N] f32 scratch; nll, lse [N] f32 out.
extern "C" int ds_fused_ce_fwd(const void* h, int h_vec, const void* w, int w_kc, long ldw,
                               int w_vec, const float* bias, const int* labels, float* part,
                               float* nll, float* lse, int N, int D, int V, int vsplit, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_FWD(T, KC) launch_fwd<T, KC>(h, h_vec, w, ldw, w_vec, bias, labels, part, nll, lse, N, \
                                        D, V, vsplit, st)
  if (dtype == 1) return w_kc ? DS_FWD(__nv_bfloat16, true) : DS_FWD(__nv_bfloat16, false);
  if (dtype == 0) return w_kc ? DS_FWD(__half, true) : DS_FWD(__half, false);
#undef DS_FWD
  return (int)cudaErrorInvalidValue;
}

// G: h [N, D] (row stride ldh); W as for F; lse [N] (log2 domain, from
// F), coef [N] f32 (the nll cotangent); dsout [N, ld_ds] out; db_part
// [N / 128 rounded up, V] f32 scratch and db [V] f32 out, both null without
// a bias. TMA reads h and W: their row strides must be multiples of 8
// elements and their bases 16-byte aligned (else cudaErrorInvalidValue).
extern "C" int ds_fused_ce_ds(const void* h, long ldh, const void* w, int w_kc, long ldw,
                              const float* bias, const int* labels, const float* lse,
                              const float* coef, void* dsout, long ld_ds, float* db_part,
                              float* db, int N, int D, int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_DS(T, KC) launch_ds<T, KC>(h, ldh, w, ldw, bias, labels, lse, coef, dsout, ld_ds, \
                                      db_part, db, N, D, V, st)
  if (dtype == 1) return w_kc ? DS_DS(__nv_bfloat16, true) : DS_DS(__nv_bfloat16, false);
  if (dtype == 0) return w_kc ? DS_DS(__half, true) : DS_DS(__half, false);
#undef DS_DS
  return (int)cudaErrorInvalidValue;
}

// dh [M, N] = A [M, K] (K-major, row stride lda) times B, stored [N, K]
// (K-major, b_kc) or [K, N] (MN-major), row stride ldb; the same alignment
// as G.
extern "C" int ds_ce_dh_gemm(const void* A, long lda, const void* B, long ldb, int b_kc, void* C,
                             long ldc, int M, int N, int K, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_DH(T, KC) launch_gemm<T, true, KC>(A, lda, B, ldb, C, ldc, M, N, K, st)
  if (dtype == 1) return b_kc ? DS_DH(__nv_bfloat16, true) : DS_DH(__nv_bfloat16, false);
  if (dtype == 0) return b_kc ? DS_DH(__half, true) : DS_DH(__half, false);
#undef DS_DH
  return (int)cudaErrorInvalidValue;
}

// C [M, N] = A^T B with A stored [K, M] and B stored [K, N] (row strides
// lda, ldb; the same alignment as G): dW = h^T ds, or dE = ds^T h for a tied
// head.
extern "C" int ds_ce_dw_gemm(const void* A, long lda, const void* B, long ldb, void* C, long ldc,
                             int M, int N, int K, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_DW(T) launch_gemm<T, false, false>(A, lda, B, ldb, C, ldc, M, N, K, st)
  if (dtype == 1) return DS_DW(__nv_bfloat16);
  if (dtype == 0) return DS_DW(__half);
#undef DS_DW
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of each launch of G, dh and dW (for the build log).
extern "C" int ds_ce_gemm_smem_bytes() { return (int)ds::kGemmSmemBytes; }
