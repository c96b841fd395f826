// A Hopper (sm_90a) tile product for the port's hand-written kernels: TMA
// loads into a ring of shared-memory stages guarded by mbarriers, one
// producer warp, two consumer warpgroups running wgmma with fp32 register
// accumulators. Inline PTX only: no CUTLASS, and nothing links against
// libcuda (the host side looks cuTensorMapEncodeTiled up at run time,
// through cudaGetDriverEntryPoint).
//
// C[m0:m0+128, n0:n0+256] = A[M, K] B[K, N] for one CTA of kGemmThreads:
//
//   A is K-major (stored [M, K], rows of K) or MN-major (stored [K, M]);
//   B is K-major (stored [N, K]) or MN-major (stored [K, N]).
//
// Every operand is read through a TMA map of its row-major storage
// (make_tma_map) in boxes 64 elements (128 bytes) wide on the contiguous
// axis, swizzled with CU_TENSOR_MAP_SWIZZLE_128B: a box row is 128 bytes,
// and the 16-byte chunks of row r sit XOR (r % 8). Per 64-deep K chunk a
// stage holds
//
//   A K-major:  one box [128 rows of M][64 K]       (warpgroup w at +8 KB w)
//   A MN-major: two boxes [64 rows of K][64 M]      (box w at +8 KB w)
//   B K-major:  one box [256 rows of N][64 K]
//   B MN-major: four boxes [64 rows of K][64 N]     (box i at +8 KB i)
//
// and wgmma reads them through descriptors whose offsets match the swizzle:
//
//   K-major:  SBO = 1024 B (the next 8 rows of M or N), LBO unused; the
//             16-deep step kk starts 32 B further along the 128-byte row.
//   MN-major: SBO = 1024 B (the next 8 rows of K), LBO = 8 KB (the next
//             64-wide box along M or N); step kk starts 16 rows = 2 KB on.
//
// Rows and columns past the operands' extents (ragged M, N and K) arrive
// as zeros from TMA, so the product needs no masking; the epilogue masks
// its stores. No split-K, no atomics: every output element is one fp32
// sum in a fixed order, so results repeat bit for bit.
//
// Roles: warpgroups 0 and 1 consume (rows 0-63 and 64-127 of the tile:
// m64n256k16, 128 fp32 accumulators a thread); warpgroup 2 produces (one
// thread starts every TMA load). setmaxnreg moves registers from the
// producer (40) to the consumers (232). A stage is refilled once all 8
// consumer warps have released it through its "empty" mbarrier, which each
// does when wgmma.wait_group 1 shows that stage's products are done; so one
// group of products is always queued behind the running one.
//
// The accumulator layout (the epilogue's view): consumer thread tid in
// [0, 256) (warpgroup wg = tid / 128, warp w = tid / 32 % 4, g = lane / 4,
// t = lane % 4) holds acc[4 i + e] = C[row, col] with
//   row = wg * 64 + w * 16 + g + 8 (e >= 2),  col = 8 i + 2 t + (e & 1).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only)
#include <type_traits>

#include "common.cuh"

namespace ds {

constexpr int kGemmBM = 128;             // output tile rows: two consumer warpgroups of 64
constexpr int kGemmBN = 256;             // output tile columns: one m64n256k16 a 16-deep step
constexpr int kGemmBK = 64;              // K chunk: one 128-byte swizzle row of 16-bit values
constexpr int kGemmStages = 4;           // ring depth: 4 x 48 KB
constexpr int kGemmThreads = 384;        // warpgroups 0, 1 consume; 2 produces
constexpr int kGemmConsumers = 256;
constexpr int kGemmGroupM = 8;           // raster: 8 M tiles walk the N tiles together
constexpr int kATileBytes = kGemmBM * kGemmBK * 2;      // 16 KB
constexpr int kBTileBytes = kGemmBN * kGemmBK * 2;      // 32 KB
constexpr int kStageBytes = kATileBytes + kBTileBytes;
constexpr int kBoxBytes = 64 * 64 * 2;                  // one MN-major box, 8 KB
// dynamic shared memory of a product: 1 KB alignment slack (the swizzle
// atoms are 1024-byte aligned), the ring, a full and an empty barrier a stage
constexpr size_t kGemmSmemBytes = 1024 + kGemmStages * kStageBytes + 2 * kGemmStages * 8;
// the epilogue's 16-bit output tile [kGemmBM][kOutPitch] over the ring
constexpr int kOutPitch = kGemmBN + 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// One TMA box at element coordinates (c0 along the contiguous axis, c1
// along rows) into dst; completion is counted on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler the accumulators change here, so no read or write of
// them moves across an asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define DS_WGMMA_DREGS                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "          \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "          \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "    \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
  "%126, %127}"
#define DS_ACC8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define DS_ACC128                                                                             \
  DS_ACC8(0), DS_ACC8(8), DS_ACC8(16), DS_ACC8(24), DS_ACC8(32), DS_ACC8(40), DS_ACC8(48),    \
      DS_ACC8(56), DS_ACC8(64), DS_ACC8(72), DS_ACC8(80), DS_ACC8(88), DS_ACC8(96),           \
      DS_ACC8(104), DS_ACC8(112), DS_ACC8(120)

// d += A (64 x 16) B (16 x 256) on the tensor cores, both from shared memory;
// TA / TB = 1 for an MN-major (transposed) operand.
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " DS_WGMMA_DREGS
        ", %128, %129, p, 1, 1, %131, %132;\n}\n"
        : DS_ACC128
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 " DS_WGMMA_DREGS
        ", %128, %129, p, 1, 1, %131, %132;\n}\n"
        : DS_ACC128
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
  }
}
#undef DS_ACC128
#undef DS_ACC8
#undef DS_WGMMA_DREGS

// The CTA's output tile: linear block ids walk kGemmGroupM M tiles down
// each N tile before moving on, so the CTAs resident together share their
// B panels (and the group's A panels) in L2.
struct GemmTile {
  int m0, n0, mt;
};

__device__ __forceinline__ GemmTile gemm_tile(int M, int N) {
  const int tm = (M + kGemmBM - 1) / kGemmBM, tn = (N + kGemmBN - 1) / kGemmBN;
  const int group = kGemmGroupM * tn;
  const int b = blockIdx.x;
  const int first = b / group * kGemmGroupM;
  const int gm = min(tm - first, kGemmGroupM);
  const int r = b % group;
  const int mt = first + r % gm;
  return {mt * kGemmBM, r / gm * kGemmBN, mt};
}

inline int gemm_grid(int M, int N) {
  return ((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN);
}

// The 256 consumer threads only (the producer warpgroup has left).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Runs the product of this CTA's tile and hands the accumulators to
// epi(acc, smem, tile) in the consumer threads (threadIdx.x < 256), with
// the ring's memory free for the epilogue's use after a consumer_sync().
// Call from a kernel launched with kGemmThreads threads and kGemmSmemBytes
// of dynamic shared memory; amap / bmap are __grid_constant__ parameters.
template <typename T, bool A_K, bool B_K, typename Epi>
__device__ __forceinline__ void gemm_tile_run(const CUtensorMap* amap, const CUtensorMap* bmap,
                                              int M, int N, int K, Epi epi) {
  extern __shared__ unsigned char gemm_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(gemm_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmStages * kStageBytes);
  uint64_t* empty = full + kGemmStages;
  const int tid = threadIdx.x;
  const GemmTile tile = gemm_tile(M, N);
  const int nk = (K + kGemmBK - 1) / kGemmBK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);                      // the producer's arrive + the TMA bytes
      mbar_init(&empty[s], kGemmConsumers / 32);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kGemmConsumers) {   // producer warpgroup: one thread starts every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kGemmConsumers) {
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % kGemmStages;
        mbar_wait(&empty[s], ((kc / kGemmStages) & 1) ^ 1);   // first pass: free
        unsigned char* a = smem + s * kStageBytes;
        unsigned char* b = a + kATileBytes;
        const int k0 = kc * kGemmBK;
        mbar_expect_tx(&full[s], kStageBytes);
        if (A_K) {
          tma_load(a, amap, &full[s], k0, tile.m0);
        } else {
          tma_load(a, amap, &full[s], tile.m0, k0);
          tma_load(a + kBoxBytes, amap, &full[s], tile.m0 + 64, k0);
        }
        if (B_K) {
          tma_load(b, bmap, &full[s], k0, tile.n0);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) tma_load(b + i * kBoxBytes, bmap, &full[s], tile.n0 + 64 * i, k0);
        }
      }
    }
  } else {   // consumer warpgroups 0 and 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = tid / 128, lane = tid & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_acc(acc);
    const uint32_t a_base = smem_u32(smem) + wg * (A_K ? 64 * 128 : kBoxBytes);
    const uint32_t b_base = smem_u32(smem) + kATileBytes;
    constexpr uint32_t kStepA = A_K ? 32 : 16 * 128, kStepB = B_K ? 32 : 16 * 128;
    constexpr uint32_t kLboA = A_K ? 16 : kBoxBytes, kLboB = B_K ? 16 : kBoxBytes;
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc % kGemmStages;
      mbar_wait(&full[s], (kc / kGemmStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk) {
        const uint64_t da = gmma_desc(a_base + s * kStageBytes + kk * kStepA, kLboA, 1024);
        const uint64_t db = gmma_desc(b_base + s * kStageBytes + kk * kStepB, kLboB, 1024);
        wgmma_m64n256k16<T, A_K ? 0 : 1, B_K ? 0 : 1>(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous chunk's products are done: release its stage
      if (kc > 0 && lane == 0) mbar_arrive(&empty[(kc - 1) % kGemmStages]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    epi(acc, smem, tile);
  }
}

// Stage the consumer threads' accumulators, rounded once to T, as the
// 128 x 256 tile out[kGemmBM][kOutPitch] in shared memory (conflict-free:
// a row's 4-byte words land 4 banks on from the previous row's).
template <typename T>
__device__ __forceinline__ void stage_out_tile(const float (&acc)[128], T* out) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = tid / 128 * 64 + tid / 32 % 4 * 16 + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * i + 2 * t;
    *reinterpret_cast<uint32_t*>(out + row * kOutPitch + c) = pack_f32<T>(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(out + (row + 8) * kOutPitch + c) =
        pack_f32<T>(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// Copy the staged tile to C[m0 + r, n0 + c] (row stride ldc) for rows < M
// and columns < n_store: 16-byte stores along rows where ldc and C allow,
// else element by element. The 256 consumer threads take part.
template <typename T>
__device__ __forceinline__ void store_out_tile(const T* out, T* __restrict__ C, long ldc, int m0,
                                               int n0, int M, int n_store) {
  const bool vec = ldc % 8 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  constexpr int kPerRow = kGemmBN / 8;
  for (int i = threadIdx.x; i < kGemmBM * kPerRow; i += kGemmConsumers) {
    const int r = i / kPerRow, c = i % kPerRow * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= n_store) continue;
    const T* s = out + r * kOutPitch + c;
    T* d = C + (long)row * ldc + col;
    if (vec && col + 8 <= n_store) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int u = 0; u < 8 && col + u < n_store; ++u) d[u] = s[u];
    }
  }
}

// ---------------------------------------------------------------------- //
// Host side

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time so nothing links against
// libcuda; null when the installed CUDA has none.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The TMA map of a row-major [rows, cols] matrix of 16-bit T with row
// stride ld elements, read in boxes of 64 columns x box_rows rows with the
// 128-byte swizzle; reads past rows or cols fill zeros. False when TMA
// cannot read it: ld not a multiple of 8 elements, a base not 16-byte
// aligned (the wrapper copies such an operand into padded rows first).
template <typename T>
bool make_tma_map(CUtensorMap* map, const void* base, long rows, long cols, long ld, int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || ld % 8 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0 || rows <= 0 ||
      cols <= 0 || ld < cols)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(T)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return enc(map, dt, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of a product's operands: A K-major is stored [M, K], MN-major
// [K, M]; B K-major [N, K], MN-major [K, N].
template <typename T, bool A_K, bool B_K>
bool make_gemm_maps(CUtensorMap* amap, CUtensorMap* bmap, const void* A, long lda, const void* B,
                    long ldb, int M, int N, int K) {
  const bool a_ok = A_K ? make_tma_map<T>(amap, A, M, K, lda, kGemmBM)
                        : make_tma_map<T>(amap, A, K, M, lda, 64);
  const bool b_ok = B_K ? make_tma_map<T>(bmap, B, N, K, ldb, kGemmBN)
                        : make_tma_map<T>(bmap, B, K, N, ldb, 64);
  return a_ok && b_ok;
}

}  // namespace ds
