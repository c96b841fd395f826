// Grouped symmetric fake quantization with stochastic rounding for Hopper
// (sm_90a): the port of the TPU kernel deepspeed_tpu/ops/quantizer/kernels.py
// _sr_kernel (K8), and of the group scales that the JAX package computes in
// XLA before it (_sym_scale: max |x| / qmax over each group, 1 where that is
// 0; not a pallas_call there, XLA fuses the reduction into one read).
//
//   sr_absmax_kernel    one launch per leaf: max |x| of each group piece the
//                       leaf holds, folded into the span's [groups] buffer
//                       with an integer atomicMax on the bits of |x| (a
//                       non-negative float orders as its bits, so any order
//                       of the folds gives the same bits);
//   sr_scale_kernel     after the span's last leaf: amax -> amax / qmax
//                       (__fdiv_rn, correctly rounded as the JAX package
//                       divides; 1 where it is 0), in place;
//   sr_quantize_kernel  one launch per leaf:
//                       out = clamp(floor(x / s + u), -qmax - 1, qmax) * s in
//                       fp32, rounded to x's dtype.
//
// u is uniform in [0, 1): word (index % 4) of a counter-based Philox4x32-10
// written below, with the mixed seed as its key and the element's quad index
// (index / 4) in the stacked view as its counter, masked to 24 bits and scaled
// by 2^-24 as the TPU kernel does (& 0xFFFFFF). The noise of an element
// depends on its stacked index and the seed only, not on the launch geometry:
// one JAX leaf stored as several per-layer port leaves is quantized by one
// launch per leaf (``offset`` = the leaf's first index in the stacked view,
// group = stacked index / group_size) and gives the same values as one launch
// over the stacked tensor, and a seed repeats bit for bit.
//
// Bound on the H100: memory, 4 bytes an element for the quantization in bf16
// in place and 2 for the absmax; but Philox and the IEEE division make the
// quantization bound by instruction issue, so nothing else runs per element:
// no 64-bit division for the group, no scale load, no 64-bit bounds compare,
// no 2-byte access. A thread takes whole 16-byte vectors (8 elements; two
// float4 in fp32) of a contiguous chunk of its block, two in flight, and
// keeps the group of its next vector as a running (group, position) pair: a
// 64-bit division runs only when the pair crosses a group, and the scale is
// reloaded only then. A vector that straddles a group, or the leaf's ends,
// takes a per-element path. Vectors start where x is 16-byte aligned, so a
// leaf at any offset and any address takes the vector path; when x and out
// are aligned differently the same loop runs with one-element accesses.
// Philox runs twice a vector when the vector starts on a quad of the stacked
// view, three times otherwise (the shift is a template argument, so every
// word stays in a register). The rounding keeps the IEEE __fdiv_rn /
// __fadd_rn / __fmul_rn and the floor and clamp order of the plain version,
// which it matches bit for bit.
#include <algorithm>

#include "elementwise.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                                    // elements a vector
constexpr int kQuantUnroll = 2, kAbsUnroll = 2;            // vectors in flight a thread
constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;   // Philox4x32 multipliers
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;   // Weyl key increments

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kW0;
      k1 += kW1;
    }
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// One leaf in the stacked view, cut into vectors: vector v holds the leaf's
// elements [8 v - lead, 8 v - lead + 8) (those inside [0, n)), and block b
// walks vectors [b chunk, (b + 1) chunk).
struct Leaf {
  long n, offset, group_size, lead, vectors, chunk;
};

// The group of a vector's first element and that element's position in it,
// advanced as the vector index grows (floor division: the first vector of a
// leaf with a lead may start before stacked index 0).
struct GroupPos {
  long g, r;
  __device__ __forceinline__ void init(long idx, long gs) {
    g = idx >= 0 ? idx / gs : -((gs - 1 - idx) / gs);
    r = idx - g * gs;
  }
  __device__ __forceinline__ void advance(long d, long gs) {
    r += d;
    if (r < gs) return;
    const long k = r / gs;
    g += k;
    r -= k * gs;
  }
};

template <typename T, bool kVecIO>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (kVecIO) {
    ds::load8<T>(p, f);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[j] = ds::load1<T>(p + j);
  }
}

template <typename T, bool kVecIO>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (kVecIO) {
    ds::store8<T>(p, f);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) ds::store1<T>(p + j, f[j]);
  }
}

__device__ __forceinline__ float sr_round(float x, float s, unsigned word, float qmax) {
  const float u = (float)(word & 0x00FFFFFFu) * (1.0f / 16777216.0f);
  const float t = floorf(__fadd_rn(__fdiv_rn(x, s), u));
  return __fmul_rn(fminf(fmaxf(t, -qmax - 1.0f), qmax), s);
}

// kShift = (offset - lead) mod 4: where a vector starts in its first Philox
// quad. The vector's 8 words are words kShift .. kShift + 7 of the 2 or 3
// quads it touches.
template <typename T, int kShift, bool kVecIO>
__global__ void __launch_bounds__(kThreads)
sr_quantize_kernel(const T* x, T* out, Leaf leaf, const float* __restrict__ scale, float qmax,
                   unsigned k0, unsigned k1) {
  constexpr int kQuads = kShift == 0 ? 2 : 3;
  constexpr long kStep = (long)kThreads * kQuantUnroll;
  const long gs = leaf.group_size, n = leaf.n;
  const long vbeg = (long)blockIdx.x * leaf.chunk;
  const long vend = min(leaf.vectors, vbeg + leaf.chunk);
  const long base = leaf.offset - leaf.lead;      // stacked index of vector 0's first slot
  GroupPos pos[kQuantUnroll];
  long sg[kQuantUnroll];       // the group whose scale s holds
  float s[kQuantUnroll];
#pragma unroll
  for (int k = 0; k < kQuantUnroll; ++k) {
    pos[k].init(base + kVec * (vbeg + threadIdx.x + k * kThreads), gs);
    sg[k] = -1;
    s[k] = 1.f;
  }
  for (long v0 = vbeg + threadIdx.x; v0 < vend; v0 += kStep) {
    float f[kQuantUnroll][kVec];
    bool fast[kQuantUnroll];
#pragma unroll
    for (int k = 0; k < kQuantUnroll; ++k) {
      const long v = v0 + k * kThreads, e0 = kVec * v - leaf.lead;
      fast[k] = v < vend && e0 >= 0 && e0 + kVec <= n && pos[k].r + kVec <= gs;
      if (fast[k]) load_vec<T, kVecIO>(x + e0, f[k]);
    }
#pragma unroll
    for (int k = 0; k < kQuantUnroll; ++k) {
      const long v = v0 + k * kThreads, e0 = kVec * v - leaf.lead;
      if (v < vend) {
        const long q = (base + kVec * v - kShift) >> 2;
        unsigned w[4 * kQuads];
#pragma unroll
        for (int i = 0; i < kQuads; ++i) {
          const uint4 r = philox4x32_10(
              make_uint4((unsigned)(q + i), (unsigned)((q + i) >> 32), 0u, 0u), k0, k1);
          w[4 * i] = r.x;
          w[4 * i + 1] = r.y;
          w[4 * i + 2] = r.z;
          w[4 * i + 3] = r.w;
        }
        if (fast[k]) {
          if (pos[k].g != sg[k]) {
            sg[k] = pos[k].g;
            s[k] = scale[sg[k]];
          }
#pragma unroll
          for (int j = 0; j < kVec; ++j) f[k][j] = sr_round(f[k][j], s[k], w[kShift + j], qmax);
          store_vec<T, kVecIO>(out + e0, f[k]);
        } else {   // a leaf end or a group boundary inside the vector
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const long e = e0 + j;
            if (e < 0 || e >= n) continue;
            long g = pos[k].g, r = pos[k].r + j;
            while (r >= gs) {
              r -= gs;
              ++g;
            }
            ds::store1<T>(out + e, sr_round(ds::load1<T>(x + e), scale[g], w[kShift + j], qmax));
          }
        }
      }
      pos[k].advance(kVec * kStep, gs);
    }
  }
}

// Bits of |x|: a non-negative float orders as its bits (NaN above inf).
__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(x) & 0x7FFFFFFFu; }

// Folds max |x| of the thread's current group into amax[g].
__device__ __forceinline__ void fold(unsigned* amax, long g, unsigned& m) {
  if (m != 0u) atomicMax(amax + g, m);
  m = 0u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sr_absmax_kernel(const T* x, Leaf leaf, unsigned* amax) {
  constexpr long kStep = (long)kThreads * kAbsUnroll;
  const long gs = leaf.group_size, n = leaf.n;
  const long vbeg = (long)blockIdx.x * leaf.chunk;
  const long vend = min(leaf.vectors, vbeg + leaf.chunk);
  const long base = leaf.offset - leaf.lead;
  GroupPos pos[kAbsUnroll];
#pragma unroll
  for (int k = 0; k < kAbsUnroll; ++k)
    pos[k].init(base + kVec * (vbeg + threadIdx.x + k * kThreads), gs);
  // the thread's vectors run in stacked order, so its groups only grow: one
  // running max, folded when the group changes
  long gcur = max(pos[0].g, 0L);
  unsigned m = 0u;
  for (long v0 = vbeg + threadIdx.x; v0 < vend; v0 += kStep) {
    float f[kAbsUnroll][kVec];
    bool fast[kAbsUnroll];
#pragma unroll
    for (int k = 0; k < kAbsUnroll; ++k) {
      const long v = v0 + k * kThreads, e0 = kVec * v - leaf.lead;
      fast[k] = v < vend && e0 >= 0 && e0 + kVec <= n && pos[k].r + kVec <= gs;
      if (fast[k]) ds::load8<T>(x + e0, f[k]);
    }
#pragma unroll
    for (int k = 0; k < kAbsUnroll; ++k) {
      const long v = v0 + k * kThreads, e0 = kVec * v - leaf.lead;
      if (fast[k]) {
        if (pos[k].g != gcur) {
          fold(amax, gcur, m);
          gcur = pos[k].g;
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) m = max(m, abs_bits(f[k][j]));
      } else if (v < vend) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const long e = e0 + j;
          if (e < 0 || e >= n) continue;
          long g = pos[k].g, r = pos[k].r + j;
          while (r >= gs) {
            r -= gs;
            ++g;
          }
          if (g != gcur) {
            fold(amax, gcur, m);
            gcur = g;
          }
          m = max(m, abs_bits(ds::load1<T>(x + e)));
        }
      }
      pos[k].advance(kVec * kStep, gs);
    }
  }
  // one fold a warp where the whole warp ends in one group
  const unsigned full = 0xFFFFFFFFu;
  const bool uniform = __all_sync(full, gcur == __shfl_sync(full, gcur, 0));
  if (uniform) {
    m = __reduce_max_sync(full, m);
    if ((threadIdx.x & 31) == 0) fold(amax, gcur, m);
  } else {
    fold(amax, gcur, m);
  }
}

__global__ void __launch_bounds__(kThreads)
sr_scale_kernel(float* scale, long groups, float qmax) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= groups) return;
  const float s = __fdiv_rn(scale[i], qmax);      // scale[i] holds amax's bits
  scale[i] = s == 0.f ? 1.f : s;
}

template <typename K> int blocks_per_sm(K kernel) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return std::max(per_sm, 1);
}

// The grid over the leaf's vectors for a kernel that fits ``per_sm`` blocks
// on an SM and ``unroll``s: as many blocks as the card holds at once (one
// wave), each walking a contiguous chunk that is a multiple of its stride.
int grid_for(Leaf& leaf, int per_sm, int unroll) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long most = std::max(1L, (long)sms * per_sm);
  const long stride = (long)kThreads * unroll;
  leaf.chunk = ((leaf.vectors + most - 1) / most + stride - 1) / stride * stride;
  return (int)((leaf.vectors + leaf.chunk - 1) / leaf.chunk);
}

// Elements between the 16-byte boundary at or before p and p.
template <typename T> long lead_of(const void* p) {
  return (long)((reinterpret_cast<uintptr_t>(p) % 16) / sizeof(T));
}

template <typename T>
Leaf make_leaf(long n, long offset, long group_size, long lead) {
  return Leaf{n, offset, group_size, lead, (n + lead + kVec - 1) / kVec, 0};
}

template <typename T, int kShift, bool kVecIO>
int launch_quantize(const void* x, void* out, Leaf leaf, const float* scale, float qmax,
                    unsigned k0, unsigned k1, cudaStream_t st) {
  auto kernel = sr_quantize_kernel<T, kShift, kVecIO>;
  static const int per_sm = blocks_per_sm(kernel);
  const int blocks = grid_for(leaf, per_sm, kQuantUnroll);
  kernel<<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), static_cast<T*>(out), leaf,
                                      scale, qmax, k0, k1);
  return (int)cudaGetLastError();
}

template <typename T, bool kVecIO>
int quantize_shift(const void* x, void* out, Leaf leaf, const float* scale, float qmax,
                   unsigned k0, unsigned k1, cudaStream_t st) {
  switch ((leaf.offset - leaf.lead) & 3) {
    case 0: return launch_quantize<T, 0, kVecIO>(x, out, leaf, scale, qmax, k0, k1, st);
    case 1: return launch_quantize<T, 1, kVecIO>(x, out, leaf, scale, qmax, k0, k1, st);
    case 2: return launch_quantize<T, 2, kVecIO>(x, out, leaf, scale, qmax, k0, k1, st);
    default: return launch_quantize<T, 3, kVecIO>(x, out, leaf, scale, qmax, k0, k1, st);
  }
}

template <typename T>
int quantize(const void* x, void* out, long n, long offset, long group_size, const float* scale,
             float qmax, unsigned k0, unsigned k1, cudaStream_t st) {
  if (lead_of<T>(x) == lead_of<T>(out))   // in place, or x and out aligned alike
    return quantize_shift<T, true>(x, out, make_leaf<T>(n, offset, group_size, lead_of<T>(x)),
                                   scale, qmax, k0, k1, st);
  return quantize_shift<T, false>(x, out, make_leaf<T>(n, offset, group_size, 0), scale, qmax,
                                  k0, k1, st);
}

template <typename T>
int absmax(const void* x, long n, long offset, long group_size, unsigned* amax, cudaStream_t st) {
  Leaf leaf = make_leaf<T>(n, offset, group_size, lead_of<T>(x));
  auto kernel = sr_absmax_kernel<T>;
  static const int per_sm = blocks_per_sm(kernel);
  const int blocks = grid_for(leaf, per_sm, kAbsUnroll);
  kernel<<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x), leaf, amax);
  return (int)cudaGetLastError();
}

}  // namespace

// Stochastic-rounding fake quantization of n elements of x (dtype 0 = fp16,
// 1 = bf16, 2 = fp32) into out (same dtype; may be x). The elements are
// indices [offset, offset + n) of a stacked view of group_size-element groups
// whose fp32 scales are ``scale``; (k0, k1) is the Philox key. Returns
// cudaGetLastError() after the launch.
extern "C" int ds_sr_quantize(const void* x, void* out, int dtype, long n, long offset,
                              long group_size, const float* scale, float qmax, unsigned k0,
                              unsigned k1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || offset < 0 || group_size < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (dtype == 0) return quantize<__half>(x, out, n, offset, group_size, scale, qmax, k0, k1, st);
  if (dtype == 1)
    return quantize<__nv_bfloat16>(x, out, n, offset, group_size, scale, qmax, k0, k1, st);
  if (dtype == 2) return quantize<float>(x, out, n, offset, group_size, scale, qmax, k0, k1, st);
  return (int)cudaErrorInvalidValue;
}

// The scale pass over one leaf of a span: max |x| of the leaf's n elements
// (stacked indices [offset, offset + n), groups of group_size) folded into
// scale[groups] as the bits of an fp32. ``first``: zero the buffer before;
// ``last``: then turn every group's max into its scale, max / qmax (1 where
// that is 0), in place. Returns the first CUDA error of the calls.
extern "C" int ds_sr_absmax(const void* x, int dtype, long n, long offset, long group_size,
                            float* scale, long groups, int first, int last, float qmax,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 0 || offset < 0 || group_size < 1 || groups < 1 || dtype < 0 || dtype > 2 ||
      offset + n > groups * group_size)
    return (int)cudaErrorInvalidValue;
  if (first) {
    const cudaError_t rc = cudaMemsetAsync(scale, 0, groups * sizeof(float), st);
    if (rc != cudaSuccess) return (int)rc;
  }
  unsigned* amax = reinterpret_cast<unsigned*>(scale);
  if (n > 0) {
    const int rc = dtype == 0 ? absmax<__half>(x, n, offset, group_size, amax, st)
                 : dtype == 1 ? absmax<__nv_bfloat16>(x, n, offset, group_size, amax, st)
                              : absmax<float>(x, n, offset, group_size, amax, st);
    if (rc != 0) return rc;
  }
  if (last) {
    sr_scale_kernel<<<(int)((groups + kThreads - 1) / kThreads), kThreads, 0, st>>>(scale, groups,
                                                                                   qmax);
    return (int)cudaGetLastError();
  }
  return 0;
}
