// Hopper (sm_90a) pieces of the flash-attention kernels A (forward), C (dq)
// and D (dk, dv), on top of wgmma_gemm.cuh's mbarrier, TMA, descriptor and
// setmaxnreg helpers:
//
//   - wgmma at N = 64 and N = 128 (m64n64k16, m64n128k16), with A from
//     shared memory (SS) or from registers (RS);
//   - a 3-D TMA map (head_cols, S, B) over a [B, S, heads, Hd] tensor, so
//     that a box of rows past S arrives as zeros instead of the next batch
//     row's tokens;
//   - the conversion of an fp32 accumulator into the register-A fragments
//     of the next product (two floats rounded into one packed 16-bit pair).
//
// Accumulator layout (as wgmma_gemm.cuh): in a warpgroup, thread (warp w,
// g = lane / 4, t = lane % 4) holds d[4 i + e] = C[w * 16 + g + 8 (e >= 2),
// 8 i + 2 t + (e & 1)]. The register-A fragment of a 64 x 16 slice at
// columns 16 kk.. holds, for each warp's 16 rows, four packed pairs:
// a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g, 2t+8..), a[3] (g+8, 2t+8..),
// which are exactly d[8 kk + 0..1], d[8 kk + 2..3], d[8 kk + 4..5] and
// d[8 kk + 6..7]: the accumulator of a product is the A operand of the next
// one without a trip through shared memory.
#pragma once

#include "common.cuh"
#include "wgmma_gemm.cuh"

namespace ds {

// Tell the compiler the registers change here (after a wgmma.wait_group),
// so no read of them moves above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The register-A fragments of every 16-column step of a 64 x N fp32
// accumulator, rounded to T: a[kk] feeds the product's step kk.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_f32<T>(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
  }
}

#define DS_ATT_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DS_ATT_D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define DS_ATT_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define DS_ATT_ACC32 DS_ATT_F8(0), DS_ATT_F8(8), DS_ATT_F8(16), DS_ATT_F8(24)
#define DS_ATT_ACC64 DS_ATT_ACC32, DS_ATT_F8(32), DS_ATT_F8(40), DS_ATT_F8(48), DS_ATT_F8(56)
// One wgmma whose scale-d predicate comes from operand SC (0: d = A B,
// else d += A B); REST lists the A and B operands and the immediates.
#define DS_ATT_WGMMA(SHAPE_TY, DREGS, SC, REST, ACC, ...)                                 \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"                            \
               "wgmma.mma_async.sync.aligned." SHAPE_TY " " DREGS ", " REST ";\n}\n"      \
               : ACC : __VA_ARGS__)

// d (+)= A (64 x 16) B (16 x N), both from shared memory through
// descriptors; TA / TB = 1 for an MN-major operand; ACC = 0 overwrites d.
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64 && kBf16) {
    DS_ATT_WGMMA("m64n64k16.f32.bf16.bf16", DS_ATT_D32, "%34", "%32, %33, p, 1, 1, %35, %36",
                 DS_ATT_ACC32, "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    DS_ATT_WGMMA("m64n64k16.f32.f16.f16", DS_ATT_D32, "%34", "%32, %33, p, 1, 1, %35, %36",
                 DS_ATT_ACC32, "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else if constexpr (kBf16) {
    DS_ATT_WGMMA("m64n128k16.f32.bf16.bf16", DS_ATT_D64, "%66", "%64, %65, p, 1, 1, %67, %68",
                 DS_ATT_ACC64, "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  } else {
    DS_ATT_WGMMA("m64n128k16.f32.f16.f16", DS_ATT_D64, "%66", "%64, %65, p, 1, 1, %67, %68",
                 DS_ATT_ACC64, "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
}

// d += A (64 x 16, register fragment a) B (16 x N, shared memory); TB = 1
// for an MN-major B (the only transpose the register-A form has).
template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128, "N is 64 or 128");
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 64 && kBf16) {
    DS_ATT_WGMMA("m64n64k16.f32.bf16.bf16", DS_ATT_D32, "%37",
                 "{%32, %33, %34, %35}, %36, p, 1, 1, %38", DS_ATT_ACC32, "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  } else if constexpr (N == 64) {
    DS_ATT_WGMMA("m64n64k16.f32.f16.f16", DS_ATT_D32, "%37",
                 "{%32, %33, %34, %35}, %36, p, 1, 1, %38", DS_ATT_ACC32, "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  } else if constexpr (kBf16) {
    DS_ATT_WGMMA("m64n128k16.f32.bf16.bf16", DS_ATT_D64, "%69",
                 "{%64, %65, %66, %67}, %68, p, 1, 1, %70", DS_ATT_ACC64, "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  } else {
    DS_ATT_WGMMA("m64n128k16.f32.f16.f16", DS_ATT_D64, "%69",
                 "{%64, %65, %66, %67}, %68, p, 1, 1, %70", DS_ATT_ACC64, "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
}
#undef DS_ATT_WGMMA
#undef DS_ATT_ACC64
#undef DS_ATT_ACC32
#undef DS_ATT_F8
#undef DS_ATT_D64
#undef DS_ATT_D32

// One TMA box of a 3-D map at (c0 along the head columns, c1 along S, c2
// along B) into dst; completion is counted on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}

// 1024-byte alignment of the dynamic shared memory (the swizzle atoms').
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The TMA map of a contiguous [B, S, cols] tensor of 16-bit T (cols =
// heads x Hd), read in boxes of 64 columns x box_rows positions of one
// batch row with the 128-byte swizzle; positions past S read as zeros.
// False when TMA cannot read it (cols not a multiple of 8, a base not
// 16-byte aligned, or no cuTensorMapEncodeTiled).
template <typename T>
bool make_tma_map_bsc(CUtensorMap* map, const void* base, long B, long S, long cols,
                      int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr || cols % 8 != 0 || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      B <= 0 || S <= 0)
    return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * sizeof(T),
                                 static_cast<cuuint64_t>(S * cols) * sizeof(T)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return enc(map, dt, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace ds
