// Causal batch FIR of a bfloat16 signal on the tensor cores, for sm_90a.
//
// Replaces the TPU kernels _fir_lanes_bf16_kernel (:418) and
// _fir_lanes_bf16_nonscratch_kernel (:384) of njw_tpu/signal/fir_pallas.py,
// launched by fir_batch_pallas_bf16 (:508, K8): bf16 signal in, float32
// accumulation, output rounded to bf16 (round to nearest even) or kept in
// float32. The signal is used as it is (no split); taps_passes = 1 is
// x B_hi, 2 adds x B_lo, the taps' bf16 residual. Same kernel as
// fir_band.cu (the template in fir_band.cuh, which holds the design); bound
// by memory: 4 B per sample with a bf16 output (0.4 GB for 1000 x 100000,
// 0.119 ms at the H100 SXM's 3.35 TB/s).

#include "fir_band.cuh"

// y[rows, n] (bf16, or float32 when out_f32) = causal FIR of the bf16
// x[rows, n] with k taps whose [H1; H0] band terms are h (bf16 planes hi,
// lo), on `stream`. Returns the CUDA error code of the launch.
extern "C" int fir_band_bf16_launch(const void* x, const void* h, void* y,
                                    int rows, long long n, int k,
                                    int taps_passes, int out_f32,
                                    void* stream) {
    using fir::bf16;
    using fir::launch;
    const auto* xb = static_cast<const bf16*>(x);
    const auto* hb = static_cast<const bf16*>(h);
    const auto s = static_cast<cudaStream_t>(stream);
    if (out_f32) {
        auto* yf = static_cast<float*>(y);
        if (taps_passes == 1) return launch<bf16, float, 2, 1, 1, 1>(xb, hb, yf, rows, n, k, s);
        if (taps_passes == 2) return launch<bf16, float, 2, 2, 1, 2>(xb, hb, yf, rows, n, k, s);
    } else {
        auto* yb = static_cast<bf16*>(y);
        if (taps_passes == 1) return launch<bf16, bf16, 2, 1, 1, 1>(xb, hb, yb, rows, n, k, s);
        if (taps_passes == 2) return launch<bf16, bf16, 2, 2, 1, 2>(xb, hb, yb, rows, n, k, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// The built kernel of (taps_passes, out_f32), as fir_band_attributes.
extern "C" int fir_band_bf16_attributes(int taps_passes, int out_f32,
                                        int* vals) {
    using fir::attributes;
    using fir::bf16;
    if (out_f32) {
        if (taps_passes == 1) return attributes<bf16, float, 2, 1, 1, 1>(vals);
        if (taps_passes == 2) return attributes<bf16, float, 2, 2, 1, 2>(vals);
    } else {
        if (taps_passes == 1) return attributes<bf16, bf16, 2, 1, 1, 1>(vals);
        if (taps_passes == 2) return attributes<bf16, bf16, 2, 2, 1, 2>(vals);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* fir_band_bf16_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
