// The banded-product FIR kernel shared by fir_band.cu (float32 signal) and
// fir_band_bf16.cu (bfloat16 signal), for sm_90a.
//
// Causal FIR with zero initial state, y[b, t] = sum_{d<k} h[d] x[b, t-d],
// k <= 128, over a batch of rows. Time is cut into 128-sample frames; frame
// f of the output is one K = 256 product of the window [x frame f-1 |
// x frame f] with the band matrix Hcat = [H1; H0] (256 x 128, row-major):
// H0 is the in-frame band h[j-s], H1 the previous-frame band
// (njw_tpu/signal/filters.py:111 _fir_band_matrices). The products run on
// the tensor cores as bf16 x bf16 with float32 accumulation (nvcuda::wmma
// m16n16k16); a float32 operand is first split into bf16 terms in
// float32 (round to nearest even, as astype(bfloat16)), a_0 = bf16(a),
// a_1 = bf16(a - a_0), a_2 = bf16(a - a_0 - a_1), and the frame output is
// the sum of the products of terms that the plan lists:
//
//   plan 0 (f32 "HIGHEST", six products): x0 B0 + x0 B1 + x1 B0 + x0 B2
//                                        + x1 B1 + x2 B0
//   plan 1 (passes 1-3): x0 B0 [+ x1 B0] [+ x0 B1]
//   plan 2 (bf16 signal, taps passes 1-2): x B0 [+ x B1]
//
// where x_i are the terms of the signal and B_i those of Hcat. The taps'
// terms are made once by the wrapper, not here.
//
// Layout. One block takes one row and a run of FR = 64 frames. It stages
// the FR frames and the frame before them (zero before t = 0: causal zero
// state) in shared memory as bf16 terms, one frame per row of pitch 144
// (32 B of padding per 256 B row, so that the rows of a 16 x 16 tile do
// not all fall on the same shared-memory banks). Samples at or past n
// (the ragged last frame) are zero and never loaded: a stray NaN times a
// zero band entry would poison the valid outputs of its frame. Every
// block reads its own previous frame from the input, so blocks share no
// state. Each of the 8 warps owns one 16-column tile of the output frame
// and keeps the accumulators of the block's 4 frame tiles (16 frames
// each) in registers. The band is nonzero only in k-tiles jt + c .. jt + 8
// of the warp's column tile jt, with c = (129 - k) / 16, so the warp
// multiplies only those (9 - c of 16: half of them at k = 101). The
// band's fragments come from device memory (64 KB per term, held in
// L1/L2 across blocks). Each finished 16 x 16 tile goes through a 1 KB
// per-warp staging tile in shared memory to masked stores (16 B vector
// stores where the row is aligned and the tile is inside the row).
//
// Bound on this card: memory. The function reads x once and writes y once:
// 8 B per sample in float32 (0.8 GB for 1000 x 100000, 0.239 ms at the
// H100 SXM's 3.35 TB/s), 4 B in bf16 (or 6 B with float32 output). The
// tensor work of three passes over the dense band is 3 x 2 x 256 x 128
// flop per frame, 154 GFLOP at that shape, 0.155 ms at 989 TFLOP/s bf16;
// the band skip halves it at k = 101. The block re-reads one frame in 65
// (1.5%). Measured (PERF.md): the time grows with the number of products,
// so today the wmma products, not the bytes, set it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace fir {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int F = 128;                 // frame length
constexpr int FR = 64;                 // frames per block
constexpr int MT = FR / 16;            // 16-frame tiles per block
constexpr int WARPS = F / 16;          // one warp per 16-column tile
constexpr int NT = WARPS * 32;         // 256 threads
constexpr int PITCH = F + 16;          // shared row pitch, in bf16
constexpr int ROWS = FR + 1;           // staged frames: the previous one too
constexpr int PLANE = ROWS * PITCH;    // one term's staged frames, in bf16
constexpr int KT = 2 * F / 16;         // k-tiles of Hcat: 16
constexpr int HPLANE = 2 * F * F;      // one term of Hcat, in bf16

// the (signal term, band term) of product i of each plan
__host__ __device__ constexpr int plan_a(int plan, int i) {
    return plan == 0 ? (i == 2 || i == 4 ? 1 : (i == 5 ? 2 : 0))
                     : (plan == 1 && i == 1 ? 1 : 0);
}
__host__ __device__ constexpr int plan_b(int plan, int i) {
    return plan == 0 ? (i == 1 || i == 4 ? 1 : (i == 3 ? 2 : 0))
                     : (i == (plan == 1 ? 2 : 1) ? 1 : 0);
}

constexpr int smem_bytes(int na) {
    return na * PLANE * 2 + WARPS * 256 * 4;
}

// x value at t of a row, zero outside [0, n), split into NA bf16 terms
template <int NA>
__device__ __forceinline__ void split_store(float v, bf16* xs, int at) {
    const bf16 a0 = __float2bfloat16_rn(v);
    xs[at] = a0;
    if (NA > 1) {
        const float r1 = v - __bfloat162float(a0);
        const bf16 a1 = __float2bfloat16_rn(r1);
        xs[PLANE + at] = a1;
        if (NA > 2)
            xs[2 * PLANE + at] = __float2bfloat16_rn(r1 - __bfloat162float(a1));
    }
}

__device__ __forceinline__ int slot(int i) {   // staged sample i -> shared
    return (i / F) * PITCH + (i % F);
}

// Stage x[t_start, t_start + ROWS * F) of one float32 row as NA terms.
// Each thread first starts all its loads (VEC of 16 B), then splits and
// stores: the loads are in flight together.
template <int NA>
__device__ void stage(const float* __restrict__ xr, long long n,
                      long long t_start, bf16* xs) {
    constexpr int G = ROWS * F / 4;              // 16 B groups
    constexpr int VEC = (G + NT - 1) / NT;       // groups per thread
    if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
        float4 q[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const int g = threadIdx.x + j * NT;
            const long long t = t_start + 4 * g;
            if (g < G && t >= 0 && t + 4 <= n) {
                q[j] = *reinterpret_cast<const float4*>(xr + t);
            } else {
                float v[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    v[e] = (g < G && t + e >= 0 && t + e < n) ? xr[t + e] : 0.0f;
                q[j] = make_float4(v[0], v[1], v[2], v[3]);
            }
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const int g = threadIdx.x + j * NT;
            if (g < G) {
                split_store<NA>(q[j].x, xs, slot(4 * g));
                split_store<NA>(q[j].y, xs, slot(4 * g + 1));
                split_store<NA>(q[j].z, xs, slot(4 * g + 2));
                split_store<NA>(q[j].w, xs, slot(4 * g + 3));
            }
        }
    } else {
        for (int i = threadIdx.x; i < ROWS * F; i += NT) {
            const long long t = t_start + i;
            split_store<NA>((t >= 0 && t < n) ? xr[t] : 0.0f, xs, slot(i));
        }
    }
}

// Stage one bfloat16 row as it is (one term), loads first as above.
template <int NA>
__device__ void stage(const bf16* __restrict__ xr, long long n,
                      long long t_start, bf16* xs) {
    static_assert(NA == 1, "a bf16 signal is used as it is");
    constexpr int G = ROWS * F / 8;              // 16 B groups
    constexpr int VEC = (G + NT - 1) / NT;
    const bf16 zero = __float2bfloat16_rn(0.0f);
    if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
        uint4 q[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const int g = threadIdx.x + j * NT;
            const long long t = t_start + 8 * g;
            if (g < G && t >= 0 && t + 8 <= n) {
                q[j] = *reinterpret_cast<const uint4*>(xr + t);
            } else {
                alignas(16) bf16 v[8];
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    v[e] = (g < G && t + e >= 0 && t + e < n) ? xr[t + e] : zero;
                q[j] = *reinterpret_cast<const uint4*>(v);
            }
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
            const int g = threadIdx.x + j * NT;
            if (g < G) *reinterpret_cast<uint4*>(xs + slot(8 * g)) = q[j];
        }
    } else {
        for (int i = threadIdx.x; i < ROWS * F; i += NT) {
            const long long t = t_start + i;
            xs[slot(i)] = (t >= 0 && t < n) ? xr[t] : zero;
        }
    }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// Eight outputs st[0..8) to yr[t..t+8): one or two 16 B stores when they
// are all inside the row and aligned, else masked scalar stores.
__device__ __forceinline__ void store8(float* yr, long long n, long long t,
                                       const float* st) {
    float* p = yr + t;
    if (t + 8 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        reinterpret_cast<float4*>(p)[0] = make_float4(st[0], st[1], st[2], st[3]);
        reinterpret_cast<float4*>(p)[1] = make_float4(st[4], st[5], st[6], st[7]);
    } else {
        for (int e = 0; e < 8 && t + e < n; ++e) p[e] = st[e];
    }
}
__device__ __forceinline__ void store8(bf16* yr, long long n, long long t,
                                       const float* st) {
    bf16* p = yr + t;
    if (t + 8 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        alignas(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(st[e]);
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
    } else {
        for (int e = 0; e < 8 && t + e < n; ++e) put(p + e, st[e]);
    }
}

// grid: rows * runs blocks (runs = ceil(frames / FR)); NT threads;
// smem_bytes(NA) bytes of dynamic shared memory. h holds NB terms of Hcat,
// each (256, 128) row-major bf16.
template <typename In, typename Out, int PLAN, int NPROD, int NA, int NB>
__global__ void __launch_bounds__(NT) band_kernel(
    const In* __restrict__ x, const bf16* __restrict__ h, Out* __restrict__ y,
    long long n, int runs, int kt_first) {
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = reinterpret_cast<bf16*>(smem);
    float* tiles = reinterpret_cast<float*>(smem + NA * PLANE * 2);

    const long long row = blockIdx.x / runs;
    const long long t0 = static_cast<long long>(blockIdx.x % runs) * FR * F;
    const In* xr = x + row * n;
    Out* yr = y + row * n;

    stage<NA>(xr, n, t0 - F, xs);
    __syncthreads();

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int jt = warp;                                   // column tile
    const long long left = n - t0;                         // > 0
    const int mt_valid = left >= MT * 16 * F
                             ? MT : static_cast<int>((left + 16 * F - 1) / (16 * F));

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) wmma::fill_fragment(acc[m], 0.0f);

    for (int kt = jt + kt_first; kt <= jt + KT / 2; ++kt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> hb[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j)
            wmma::load_matrix_sync(hb[j], h + j * HPLANE + kt * 16 * F + jt * 16, F);
        // k-tile kt of frame f's window is 16-sample piece kt % 8 of
        // staged row f + kt / 8 (row 0 is the frame before the run)
        const bf16* a_at = xs + (kt / 8) * PITCH + (kt % 8) * 16;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            if (m < mt_valid) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> xa[NA];
#pragma unroll
                for (int i = 0; i < NA; ++i)
                    wmma::load_matrix_sync(xa[i], a_at + i * PLANE + m * 16 * PITCH,
                                           PITCH);
#pragma unroll
                for (int p = 0; p < NPROD; ++p)
                    wmma::mma_sync(acc[m], xa[plan_a(PLAN, p)], hb[plan_b(PLAN, p)],
                                   acc[m]);
            }
        }
    }

    float* st = tiles + warp * 256;
    const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
        if (m < mt_valid) {
            wmma::store_matrix_sync(st, acc[m], 16, wmma::mem_row_major);
            __syncwarp();
            const long long t = t0 + static_cast<long long>(m * 16 + r) * F
                                + jt * 16 + c;
            if (t < n) store8(yr, n, t, st + r * 16 + c);
            __syncwarp();
        }
    }
}

// Launch one instance on `stream`; returns the CUDA error code.
template <typename In, typename Out, int PLAN, int NPROD, int NA, int NB>
int launch(const In* x, const bf16* h, Out* y, int rows, long long n, int k,
           cudaStream_t stream) {
    if (rows <= 0 || n <= 0) return 0;
    const long long frames = (n + F - 1) / F;
    const long long runs = (frames + FR - 1) / FR;
    if (runs * rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = band_kernel<In, Out, PLAN, NPROD, NA, NB>;
    constexpr int smem = smem_bytes(NA);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int kt_first = (F + 1 - k) / 16;   // first nonzero k-tile - jt
    kernel<<<static_cast<unsigned>(runs * rows), NT, smem, stream>>>(
        x, h, y, n, static_cast<int>(runs), kt_first);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace fir
