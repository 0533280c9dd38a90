// One RK stage of the periodic barotropic vorticity equation, for sm_90a.
//
// Replaces the TPU kernel _baro_stage_kernel (njw_tpu/ops/baro_stencil.py:34,
// launched by baro_stage_pallas at :143):
//
//   out = base + c_dt * ( -(J1 + J2 + J3) / (12 dx dy)
//                         - beta (psiE - psiW) / (2 dx)
//                         + nu Laplacian(zeta) )
//
// with Arakawa's (1966) 9-point Jacobian of psi and zeta and periodic wrap
// on both axes, for float32 (ny, nx) fields. The arithmetic is the Pallas
// kernel's: multiply by -1/(12 dx dy), divide by dx^2 and dy^2 in the
// Laplacian, constants folded in double on the host and rounded to float32
// once.
//
// Bound on this card: memory. The stage must read psi, zeta and base once
// and write out once, 16 B/point: 16.8 MB at 1024^2, 5.0 us at the H100
// SXM's 3.35 TB/s. The arithmetic is about 48 flop/point, 0.05 GFLOP at
// 1024^2, under 1 us at 67 TFLOP/s fp32.
//
// Design against that bound: each block owns a 32 x 32 output tile and
// loads a 34 x 34 tile of psi and zeta (a one-point halo, periodic wrap by
// modular index, so any ny, nx >= 3 works, including grids smaller than a
// tile) into shared memory once: 9.2 KB, so several blocks fit on an SM.
// Each of the 256 threads then computes four output points of one column
// from shared memory, reading base and writing out once, coalesced along
// x. Ragged edge tiles mask their loads' targets and their stores. The
// halo is re-read by the neighbouring tiles (34^2/32^2 = 1.13x the psi and
// zeta bytes), which L2 absorbs.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;             // output tile width (x, contiguous)
constexpr int TY = 32;             // output tile height
constexpr int PX = TX + 2;         // shared tile pitch with the halo: 34
constexpr int PY = TY + 2;         // 34
constexpr int NTY = 8;             // thread rows: each thread does TY/NTY
constexpr int NT = TX * NTY;       // 256 threads per block

struct Consts {
    float m12;        // -1/(12 dx dy)
    float cx;         // 0.5/dx (the beta term's d/dx)
    float beta;
    float dx2, dy2;   // dx^2, dy^2 (the Laplacian divides by them)
    float nu;
    float c_dt;
    int has_beta, has_nu;
};

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

__global__ void __launch_bounds__(NT) baro_stage_kernel(
    const float* __restrict__ psi, const float* __restrict__ zeta,
    const float* base, float* out, int ny, int nx, Consts k) {
    // base and out may alias (each point is read before it is written, by
    // the same thread), so neither is __restrict__
    __shared__ float sp[PY * PX];
    __shared__ float sz[PY * PX];

    const int y0 = blockIdx.y * TY - 1;
    const int x0 = blockIdx.x * TX - 1;
    const int tid = threadIdx.y * TX + threadIdx.x;
    for (int i = tid; i < PY * PX; i += NT) {
        const int r = i / PX, c = i % PX;
        const size_t g = static_cast<size_t>(wrap(y0 + r, ny)) * nx
                         + wrap(x0 + c, nx);
        sp[i] = psi[g];
        sz[i] = zeta[g];
    }
    __syncthreads();

    const int gx = blockIdx.x * TX + threadIdx.x;
    if (gx >= nx) return;
    const int c = threadIdx.x + 1;
#pragma unroll
    for (int rr = 0; rr < TY / NTY; ++rr) {
        const int ty = threadIdx.y + rr * NTY;
        const int gy = blockIdx.y * TY + ty;
        if (gy >= ny) break;
        const int j = (ty + 1) * PX + c;      // north is +y: j + PX
        const float pE = sp[j + 1], pW = sp[j - 1];
        const float pN = sp[j + PX], pS = sp[j - PX];
        const float pNE = sp[j + PX + 1], pNW = sp[j + PX - 1];
        const float pSE = sp[j - PX + 1], pSW = sp[j - PX - 1];
        const float zc = sz[j];
        const float zE = sz[j + 1], zW = sz[j - 1];
        const float zN = sz[j + PX], zS = sz[j - PX];
        const float zNE = sz[j + PX + 1], zNW = sz[j + PX - 1];
        const float zSE = sz[j - PX + 1], zSW = sz[j - PX - 1];

        const float j1 = (pE - pW) * (zN - zS) - (pN - pS) * (zE - zW);
        const float j2 = pE * (zNE - zSE) - pW * (zNW - zSW)
                         - pN * (zNE - zNW) + pS * (zSE - zSW);
        const float j3 = zN * (pNE - pNW) - zS * (pSE - pSW)
                         - zE * (pNE - pSE) + zW * (pNW - pSW);
        float dz = (j1 + j2 + j3) * k.m12;
        if (k.has_beta) dz = dz - k.beta * ((pE - pW) * k.cx);
        if (k.has_nu) {
            const float lap = (zE - 2.0f * zc + zW) / k.dx2
                              + (zN - 2.0f * zc + zS) / k.dy2;
            dz = dz + k.nu * lap;
        }
        const size_t g = static_cast<size_t>(gy) * nx + gx;
        out[g] = base[g] + k.c_dt * dz;
    }
}

}  // namespace

// Launch one stage on `stream`. `out` must not alias psi or zeta (it may
// alias base). Returns the CUDA error code of the launch (0 on success).
extern "C" int baro_stage_launch(
    const float* psi, const float* zeta, const float* base, float* out,
    int ny, int nx, float m12, float cx, float beta, float dx2, float dy2,
    float nu, float c_dt, int has_beta, int has_nu, void* stream) {
    const Consts k{m12, cx, beta, dx2, dy2, nu, c_dt, has_beta, has_nu};
    const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
    const dim3 block(TX, NTY);
    baro_stage_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        psi, zeta, base, out, ny, nx, k);
    return static_cast<int>(cudaGetLastError());
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* baro_stage_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
