// Causal batch FIR of a float32 signal on the tensor cores, for sm_90a.
//
// Replaces the TPU kernels of njw_tpu/signal/fir_pallas.py that compute the
// same function with a float32 signal: _fir_lanes_scratch_kernel (:192)
// and _fir_lanes_kernel (:250), launched by fir_batch_pallas_lanes (:364,
// K7, the kernel of fir_apply's batch branch); _fir_batch_kernel (:37,
// fir_batch_pallas, K9); _fir_flat_kernel (:110, fir_batch_pallas_flat,
// K10). The three differ only in how the TPU lays the frames out; here one
// kernel serves them all. The design, the bound and the split of the
// operands into bf16 terms are in fir_band.cuh.
//
// passes (the JAX kernels' parameter): 1 = x_hi B_hi; 2 = + x_lo B_hi;
// 3 and 6 = + x_hi B_lo (bf16 x 3, what Precision.HIGH runs on the TPU);
// 0 = the six products of three-term splits (bf16 x 6, what
// Precision.HIGHEST runs), float32 accuracy.

#include "fir_band.cuh"

// y[rows, n] = causal FIR of x[rows, n] with k taps whose [H1; H0] band
// terms are h (three (256, 128) bf16 planes: hi, lo, and the third term),
// on `stream`. Returns the CUDA error code of the launch (0 on success).
extern "C" int fir_band_launch(const float* x, const void* h, float* y,
                               int rows, long long n, int k, int passes,
                               void* stream) {
    using fir::launch;
    const auto* hb = static_cast<const fir::bf16*>(h);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (passes) {
        case 0: return launch<float, float, 0, 6, 3, 3>(x, hb, y, rows, n, k, s);
        case 1: return launch<float, float, 1, 1, 1, 1>(x, hb, y, rows, n, k, s);
        case 2: return launch<float, float, 1, 2, 2, 1>(x, hb, y, rows, n, k, s);
        case 3:
        case 6: return launch<float, float, 1, 3, 2, 2>(x, hb, y, rows, n, k, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The built kernel of `passes` (fir::attributes: registers, local bytes,
// dynamic and static shared bytes, threads, blocks an SM, frames a tile,
// ring stages into vals[0..8)). Returns a CUDA error code.
extern "C" int fir_band_attributes(int passes, int* vals) {
    using fir::attributes;
    switch (passes) {
        case 0: return attributes<float, float, 0, 6, 3, 3>(vals);
        case 1: return attributes<float, float, 1, 1, 1, 1>(vals);
        case 2: return attributes<float, float, 1, 2, 2, 1>(vals);
        case 3:
        case 6: return attributes<float, float, 1, 3, 2, 2>(vals);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* fir_band_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
