// Fused logits-free cross-entropy for Hopper (sm_90a): the port of the TPU
// kernels deepspeed_tpu/ops/pallas/fused_cross_entropy.py _fwd_kernel (K3
// fwd), _dh_kernel (K3 dh) and _dw_kernel (K3 dW). The vocab head's loss
// mean CE(h W + b, labels), h [N, D], W [D, V], never forms the [N, V]
// logits in the forward, and forms them in the backward only as ds, once, in
// h's dtype.
//
// Why the TPU structure does not carry over: the TPU grid kept a [bt, D]
// fp32 dh accumulator and a [D, bv] fp32 dW accumulator in VMEM (>= 1 MB
// each at D = 4096) and accumulated across a sequential grid axis, and its
// forward carried the running (max, sum, gold) of a token tile across the
// vocab axis. A Hopper CTA has <= 227 KB of shared memory and <= 255
// registers a thread, and CTAs run in no order: splitting D over CTAs would
// recompute the logits D / Dt times, and atomics would add ~32 GB of fp32 a
// micro-step in an order that changes from run to run. So the work is split
// into six kernels, every one deterministic:
//
//   fused_ce_fwd_kernel (F)  one CTA per (128-token, 256-vocab) tile: s =
//       (h W + b) log2e from the wgmma mainloop, folded straight from the
//       accumulator registers into the tile's (max, sum of exp2, gold) per
//       token, written once to part[3][ceil(V / 256)][N].
//   fused_ce_combine_kernel  merges a token's vocab tiles in order: lse =
//       log2-domain logsumexp, nll = (lse - gold) / log2e, both [N] fp32.
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
// Memory: the forward holds nothing of size N x V (its partials are 12 B a
// token and 256-wide vocab tile: 12.3 MB at N 8192, V 32000); the backward
// holds ds, N x V x 2 B (0.52 GB), where the plain path holds the bf16
// logits, the fp32 logits and their fp32 softmax (about 2.5 GB).
//
// Rounding points are the TPU kernels': s from storage-dtype operands with
// fp32 accumulation, the softmax in the log2 domain, ds cast to W's dtype
// for dh (_dh_kernel :131-132) and to h's dtype for dW (:157-158), which
// are one type because the wrapper casts W to h's dtype; db sums the fp32
// ds. Rows >= N and columns >= V arrive as zeros from TMA and are masked
// in-kernel (F: s = -1e30; G: ds = 0), which equals the TPU package's -1e30
// pad bias. F's exp2 is ex2.approx.ftz: a term below 2^-126 adds nothing to
// a sum that is >= 1.
//
// Bound on the H100: each of F, G, dh and dW does one 2 N D V product
// (2.15e12 FLOPs at N 8192, D 4096, V 32000: 2.2 ms at 989 TFLOP/s) and
// moves at most ds beside its operands (~0.2 ms): all bound by operations,
// so the tensor cores' rate is the design's target.
//
// All four run on the Hopper mainloop of wgmma_gemm.cuh: 128 x 256 output
// tiles, 64-deep K chunks brought by TMA (128-byte swizzle) into a
// four-stage ring guarded by mbarriers, one producer warp, two consumer
// warpgroups running m64n256k16 wgmma from shared memory with fp32 register
// accumulators. The products take each operand as it lies in memory,
// K-major (rows of the reduction) or MN-major:
//
//   F, G  A = h [N, D] K-major; B = W [D, V] MN-major, tied W stored [V, D]
//         K-major
//   dh    A = ds [N, V] K-major; B = W^T: stored [D, V] K-major, tied [V, D]
//         MN-major
//   dW    A = h^T and B = ds, both MN-major (tied: A = ds^T, B = h)
//
// TMA needs 16-byte aligned rows: the wrapper copies an operand whose row
// stride is not a multiple of 8 elements into padded rows first (an untied
// W with V = 50257, h with D % 8 != 0), once a forward and backward; a tied
// head is read in place.
#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace {

// F. part [3][nvt][N] (nvt = ceil(V / 256)): the max, the sum of exp2(s -
// max) and the gold logit (log2 domain) of each token over the CTA's vocab
// tile. Each row of the accumulator tile lives in one quad of lanes (the
// thread's 64 columns of rows r and r + 8; wgmma_gemm.cuh's layout), so a
// row's reductions are the thread's own values and two shuffles; the quad's
// first lane writes.
template <typename T, bool W_KC>
__global__ void __launch_bounds__(ds::kGemmThreads, 1)
fused_ce_fwd_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap wmap,
                    const float* __restrict__ bias, const int* __restrict__ labels,
                    float* __restrict__ part, int N, int D, int V) {
  ds::gemm_tile_run<T, true, W_KC>(&hmap, &wmap, N, V, D, [=](float (&acc)[128], unsigned char*,
                                                              const ds::GemmTile& tile) {
    const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
    const int r0 = tile.m0 + tid / 128 * 64 + tid / 32 % 4 * 16 + (lane >> 2);
    int lab[2];
    float mx[2] = {ds::kMasked, ds::kMasked}, gold[2] = {0.f, 0.f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) lab[h2] = r0 + 8 * h2 < N ? labels[r0 + 8 * h2] : -1;
    // s = (acc + b) log2e (the TPU kernels' _block_logits); -1e30 past V.
    // Three passes over the registers (s, then max and gold, then the sum):
    // folded into one, ptxas spills.
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = tile.n0 + 8 * i + 2 * t + e;
        const float b = bias != nullptr && col < V ? bias[col] : 0.f;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float& a = acc[4 * i + 2 * h2 + e];
          a = col < V ? (a + b) * ds::kLog2e : ds::kMasked;
        }
      }
#pragma unroll
    for (int i = 0; i < 128; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
          if (tile.n0 + 8 * i + 2 * t + e == lab[h2]) gold[h2] = acc[4 * i + 2 * h2 + e];
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) l[(i >> 1) & 1] += ds::exp2_ftz(acc[i] - mx[(i >> 1) & 1]);
    const int nvt = (V + ds::kGemmBN - 1) / ds::kGemmBN, vt = tile.n0 / ds::kGemmBN;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      // the gold logit sits in at most one lane of the quad; the others add 0
      l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
      l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
      gold[h2] += __shfl_xor_sync(0xffffffffu, gold[h2], 1);
      gold[h2] += __shfl_xor_sync(0xffffffffu, gold[h2], 2);
      const int row = r0 + 8 * h2;
      if (t == 0 && row < N) {
        part[(long)vt * N + row] = mx[h2];
        part[(long)(nvt + vt) * N + row] = l[h2];
        part[(long)(2 * nvt + vt) * N + row] = gold[h2];
      }
    }
  });
}

__global__ void fused_ce_combine_kernel(const float* __restrict__ part, float* __restrict__ nll,
                                        float* __restrict__ lse, int N, int nvt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float m = ds::kMasked;
  for (int s = 0; s < nvt; ++s) m = fmaxf(m, part[(long)s * N + i]);
  float l = 0.f, gold = 0.f;
  for (int s = 0; s < nvt; ++s) {
    l += part[(long)(nvt + s) * N + i] * exp2f(part[(long)s * N + i] - m);
    gold += part[(long)(2 * nvt + s) * N + i];
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
    // (the bias in a pass of its own: folded into the softmax's, ptxas spills)
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = tile.n0 + 8 * i + 2 * t + e;
        const float b = bias != nullptr && col < V ? bias[col] : 0.f;
        acc[4 * i + e] = (acc[4 * i + e] + b) * ds::kLog2e;
        acc[4 * i + 2 + e] = (acc[4 * i + 2 + e] + b) * ds::kLog2e;
      }
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = tile.n0 + 8 * i + 2 * t + e;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float& a = acc[4 * i + 2 * h2 + e];
          a = live[h2] && col < V
                  ? (exp2f(a - lse_r[h2]) - (col == lab[h2] ? 1.f : 0.f)) * c_r[h2]
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
int launch_fwd(const void* h, long ldh, const void* w, long ldw, const float* bias,
               const int* labels, float* part, float* nll, float* lse, int N, int D, int V,
               cudaStream_t st) {
  CUtensorMap hmap, wmap;
  if (!ds::make_gemm_maps<T, true, W_KC>(&hmap, &wmap, h, ldh, w, ldw, N, V, D))
    return (int)cudaErrorInvalidValue;
  int err = launch_tiles(fused_ce_fwd_kernel<T, W_KC>, N, V, st, hmap, wmap, bias, labels, part,
                         N, D, V);
  if (err != 0) return err;
  const int nvt = (V + ds::kGemmBN - 1) / ds::kGemmBN;
  fused_ce_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, nll, lse, N, nvt);
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
// head, W = embed.T) rather than [D, V]; ldw its row stride. TMA reads h and
// W: their row strides must be multiples of 8 elements and their bases
// 16-byte aligned (else cudaErrorInvalidValue). Each returns
// cudaGetLastError() after its launches.

// F: h [N, D] (row stride ldh), bias [V] f32 or null, labels [N] int32 in
// [0, V); part [3, ceil(V / 256), N] f32 scratch; nll, lse [N] f32 out.
extern "C" int ds_fused_ce_fwd(const void* h, long ldh, const void* w, int w_kc, long ldw,
                               const float* bias, const int* labels, float* part, float* nll,
                               float* lse, int N, int D, int V, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_FWD(T, KC) launch_fwd<T, KC>(h, ldh, w, ldw, bias, labels, part, nll, lse, N, D, V, st)
  if (dtype == 1) return w_kc ? DS_FWD(__nv_bfloat16, true) : DS_FWD(__nv_bfloat16, false);
  if (dtype == 0) return w_kc ? DS_FWD(__half, true) : DS_FWD(__half, false);
#undef DS_FWD
  return (int)cudaErrorInvalidValue;
}

// G: h [N, D] (row stride ldh); W as for F; lse [N] (log2 domain, from
// F), coef [N] f32 (the nll cotangent); dsout [N, ld_ds] out; db_part
// [N / 128 rounded up, V] f32 scratch and db [V] f32 out, both null without
// a bias.
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
