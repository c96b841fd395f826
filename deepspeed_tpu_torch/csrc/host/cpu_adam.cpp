// Host-side vectorized Adam/AdamW for ZeRO-Offload.
//
// Reference parity: csrc/adam/cpu_adam.cpp:304 + csrc/includes/cpu_adam.h
// (AVX intrinsics + OpenMP, exports ds_adam_step / ds_adam_step_plus_copy).
// TPU-native rebuild: plain C++ with OpenMP worksharing and `omp simd`
// auto-vectorization (compiled -O3 -march=native, so the compiler emits
// AVX2/AVX-512 or NEON for the TPU-VM host CPU without hand intrinsics),
// plus a fused bf16 store of updated params into the device-bound staging
// buffer (the reference's `_plus_copy` overlap, csrc/adam/cpu_adam.cpp:290).
//
// All entry points use a C ABI and are loaded via ctypes (no torch, no
// pybind11). Buffers are caller-owned; bf16 is passed as uint16 words.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

inline float bf16_to_f32(uint16_t h) {
    uint32_t bits = static_cast<uint32_t>(h) << 16;
    float f;
    std::memcpy(&f, &bits, sizeof(f));
    return f;
}

// round-to-nearest-even, matching XLA's f32->bf16 convert
inline uint16_t f32_to_bf16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, sizeof(bits));
    uint32_t lsb = (bits >> 16) & 1u;
    bits += 0x7fffu + lsb;
    return static_cast<uint16_t>(bits >> 16);
}

// One fused Adam update for element i. bias_c1/bias_c2 are the caller's
// precomputed 1-beta^t corrections so the inner loop stays branch-free.
inline float adam_update(float param, float grad, float& m, float& v,
                         float beta1, float beta2, float eps, float lr,
                         float weight_decay, int adamw_mode, float bias_c1,
                         float bias_c2) {
    if (!adamw_mode && weight_decay > 0.0f) grad += weight_decay * param;
    m = beta1 * m + (1.0f - beta1) * grad;
    v = beta2 * v + (1.0f - beta2) * grad * grad;
    float mhat = m / bias_c1;
    float vhat = v / bias_c2;
    float update = mhat / (std::sqrt(vhat) + eps);
    if (adamw_mode && weight_decay > 0.0f) update += weight_decay * param;
    return param - lr * update;
}

}  // namespace

extern "C" {

// fp32 params/grads in place.
void ds_adam_step(float* params, const float* grads, float* exp_avg,
                  float* exp_avg_sq, int64_t n, float lr, float beta1,
                  float beta2, float eps, float weight_decay, int adamw_mode,
                  float bias_c1, float bias_c2) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        params[i] = adam_update(params[i], grads[i], exp_avg[i], exp_avg_sq[i],
                                beta1, beta2, eps, lr, weight_decay, adamw_mode,
                                bias_c1, bias_c2);
    }
}

// fp32 master params, bf16 grads (as produced on device), fused bf16 store of
// the updated params into `param_out_bf16` — the staging buffer the engine
// transfers back to HBM, overlapping convert+copy with the update itself.
// A null `param_out_bf16` skips the store (update-only).
void ds_adam_step_bf16(float* params, const uint16_t* grads_bf16,
                       float* exp_avg, float* exp_avg_sq,
                       uint16_t* param_out_bf16, int64_t n, float lr,
                       float beta1, float beta2, float eps, float weight_decay,
                       int adamw_mode, float bias_c1, float bias_c2) {
    if (param_out_bf16 != nullptr) {
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; ++i) {
            float p = adam_update(params[i], bf16_to_f32(grads_bf16[i]), exp_avg[i],
                                  exp_avg_sq[i], beta1, beta2, eps, lr,
                                  weight_decay, adamw_mode, bias_c1, bias_c2);
            params[i] = p;
            param_out_bf16[i] = f32_to_bf16(p);
        }
    } else {
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; ++i) {
            params[i] = adam_update(params[i], bf16_to_f32(grads_bf16[i]), exp_avg[i],
                                    exp_avg_sq[i], beta1, beta2, eps, lr,
                                    weight_decay, adamw_mode, bias_c1, bias_c2);
        }
    }
}

// fp32 update + fused bf16 copy-out (reference ds_adam_step_plus_copy).
void ds_adam_step_plus_copy(float* params, const float* grads, float* exp_avg,
                            float* exp_avg_sq, uint16_t* param_out_bf16,
                            int64_t n, float lr, float beta1, float beta2,
                            float eps, float weight_decay, int adamw_mode,
                            float bias_c1, float bias_c2) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float p = adam_update(params[i], grads[i], exp_avg[i], exp_avg_sq[i],
                              beta1, beta2, eps, lr, weight_decay, adamw_mode,
                              bias_c1, bias_c2);
        params[i] = p;
        param_out_bf16[i] = f32_to_bf16(p);
    }
}

}  // extern "C"
