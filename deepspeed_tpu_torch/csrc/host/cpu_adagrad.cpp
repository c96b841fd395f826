// Host-side vectorized Adagrad for ZeRO-Offload.
//
// Reference parity: csrc/adagrad/cpu_adagrad.cpp:238 + cpu_adagrad.h —
// same SIMD/OpenMP pattern as cpu_adam, exported over a C ABI for ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline uint16_t f32_to_bf16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, sizeof(bits));
    uint32_t lsb = (bits >> 16) & 1u;
    bits += 0x7fffu + lsb;
    return static_cast<uint16_t>(bits >> 16);
}

}  // namespace

extern "C" {

void ds_adagrad_step(float* params, const float* grads, float* exp_avg_sq,
                     int64_t n, float lr, float eps, float weight_decay) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = grads[i];
        if (weight_decay > 0.0f) grad += weight_decay * params[i];
        exp_avg_sq[i] += grad * grad;
        params[i] -= lr * grad / (std::sqrt(exp_avg_sq[i]) + eps);
    }
}

void ds_adagrad_step_plus_copy(float* params, const float* grads,
                               float* exp_avg_sq, uint16_t* param_out_bf16,
                               int64_t n, float lr, float eps,
                               float weight_decay) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float grad = grads[i];
        if (weight_decay > 0.0f) grad += weight_decay * params[i];
        exp_avg_sq[i] += grad * grad;
        params[i] -= lr * grad / (std::sqrt(exp_avg_sq[i]) + eps);
        param_out_bf16[i] = f32_to_bf16(params[i]);
    }
}

}  // extern "C"
