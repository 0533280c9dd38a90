// The banded-product FIR kernel shared by fir_band.cu (float32 signal) and
// fir_band_bf16.cu (bfloat16 signal), for sm_90a.
//
// Replaces the TPU kernels of njw_tpu/signal/fir_pallas.py:
// _fir_lanes_scratch_kernel (:192) and _fir_lanes_kernel (:250) (K7),
// _fir_batch_kernel (:37, K9), _fir_flat_kernel (:110, K10),
// _fir_lanes_bf16_kernel (:418) and _fir_lanes_bf16_nonscratch_kernel
// (:384) (K8).
//
// Function. Causal FIR with zero initial state, y[b, t] = sum_{d<k} h[d]
// x[b, t-d], k <= 128, over a batch of rows. Time is cut into 128-sample
// frames; frame f of the output is one K = 256 product of the window
// [x frame f-1 | x frame f] with the band matrix Hcat = [H1; H0] (256 x
// 128, row-major; njw_tpu/signal/filters.py:111 _fir_band_matrices). The
// products run on the tensor cores as bf16 x bf16 with float32
// accumulation; a float32 operand is first split into bf16 terms in
// float32 (round to nearest even, as astype(bfloat16)), a_0 = bf16(a),
// a_1 = bf16(a - a_0), a_2 = bf16(a - a_0 - a_1), and the frame output is
// the sum of the products of terms that the plan lists:
//
//   plan 0 (f32 "HIGHEST", six products): x0 B0 + x0 B1 + x1 B0 + x0 B2
//                                        + x1 B1 + x2 B0
//   plan 1 (passes 1-3): x0 B0 [+ x1 B0] [+ x0 B1]
//   plan 2 (bf16 signal, taps passes 1-2): x B0 [+ x B1]
//
// where x_i are the terms of the signal and B_i those of Hcat (made once
// per taps by the wrapper, signal/filters.py fir_bands).
//
// Bound on this card. The function reads x once and writes y once: 8 B a
// sample in float32 (0.8 GB for 1000 x 100000: 0.239 ms at the H100 SXM's
// 3.35 TB/s; a device copy of x takes 0.267 ms), 4 B in bf16 (6 B with
// float32 output). The tensor work over the band's nonzero k-tiles is 8
// of 16 at k = 101: 77 GFLOP for three products at that shape, 0.08 ms at
// 989 TFLOP/s. So bytes bound it, if the products and the staging overlap
// the stream; the design before this one ran its phases in series and
// paid ~0.13 ms a product (PERF.md).
//
// Design.
// * A persistent grid (BPSM blocks an SM) walks tiles of FR = 64 frames of
//   one row; block b takes the contiguous tiles [b T / G, (b+1) T / G) of
//   the T = rows x runs tiles in row order, so a tile's previous frame is
//   the last frame of the tile the block just did. Only a block's first
//   tile, when it starts inside a row, reads its previous frame from
//   device memory; the first tile of a row has zeros (causal zero state).
// * x streams through a ring of STAGES tiles in shared memory, filled by
//   TMA (a 2-D tensor map over (rows, n), boxes of 256 samples of one
//   row). The zero fill of a box past n gives the ragged last frame its
//   zeros without reading a sample at or past n. Warp 0 keeps tiles in
//   flight: a stage is refilled, with the tile STAGES on, as soon as its
//   tile's y has left it (below), so the loads overlap the splits,
//   products and stores of the tiles before. Rows TMA cannot take (an x
//   or y base or row stride not a multiple of 16 bytes, n < 256) take a
//   staging branch in the same kernel: masked loads straight into the
//   term planes.
// * Each sample is split into its bf16 terms once, after it lands: the
//   ring feeds term planes of FR + 1 frames (the previous frame in row
//   0), 136 bf16 a frame row so that ldmatrix's eight 16-byte rows fall
//   on distinct banks.
// * The band is Toeplitz: Hcat[i][j] depends on j - i only, so its 16 x 16
//   tiles take 9 distinct values, d = kt - jt = 0..8 (k-tile kt, column
//   tile jt). Every warp holds those 9 tiles of each band term as
//   mma.sync B fragments in registers, loaded once per block (36 registers
//   a term).
// * Each of the 4 warps owns 16 frames of a tile and all 128 output
//   columns (64 accumulator registers). It loads each A fragment (16
//   frames x 16 samples of the window) once per term with ldmatrix and
//   feeds it to every (column tile, product) that uses it: mma.sync
//   m16n8k16 over only the k-tiles with d in [c, 8], c = (129 - k) / 16.
// * The epilogue pairs lanes by one shuffle so that each lane holds 4
//   adjacent outputs. Streamed, they go into the tile's own ring stage
//   (free once split), and each warp has TMA store its 16 frames, 8 KB of
//   y contiguous in the row: the box holding n is clipped, boxes past it
//   are not issued. The stage is refilled with the tile STAGES on once
//   those stores have read it (at the next tile's first barrier), so each
//   load has a whole tile's work to land in. Storing from registers
//   instead (8 frames x 64 bytes an instruction) ran at ~1 TB/s and made
//   the first form of this kernel store-bound (PERF.md). The staging
//   branch stores from registers: 16 bytes (8 for bf16 output) a lane,
//   scalar where a row end or a misaligned row cuts a group of 4.
// * mma.sync, not wgmma: a wgmma form (the 64 frames as M, the window and
//   a Toeplitz strip of the band both in shared memory) was slower on
//   every main path (PERF.md) and is not built.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md §6, in one process with
// the design before): fir_batch (1000 x 100000, passes 3) 0.761 -> 0.314
// ms, a device copy of x 0.267; fir_suite (16 x 10^6) 0.129 -> 0.064;
// fir_bf16 0.392 -> 0.156. The outputs equal the earlier design's.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

#ifndef FIR_PROBE
#define FIR_PROBE 0  // profiling only: 1 no products; 2 no loads or splits;
                     // 3 loads and splits alone
#endif

namespace fir {

using bf16 = __nv_bfloat16;

constexpr int F = 128;                 // frame length
constexpr int FR = 64;                 // frames a tile
constexpr int WARPS = 4;               // 16 frames of the tile each
constexpr int NT = WARPS * 32;         // 128 threads
constexpr int PITCH = 136;             // term plane row pitch, in bf16
constexpr int PLANE = (FR + 1) * PITCH;  // one term's frames, in bf16
constexpr int KT = 2 * F / 16;         // k-tiles of Hcat: 16
constexpr int DT = KT / 2 + 1;         // distinct band tiles: d = 0..8
constexpr int HPLANE = 2 * F * F;      // one term of Hcat, in bf16
constexpr int BOX = 256;               // samples a TMA box
constexpr int BOXES = FR * F / BOX;    // boxes a tile: 32
constexpr int SMEM_PER_SM = 233472;    // shared bytes an SM, 1 KB a block reserved

static_assert(FR == 16 * WARPS, "a warp owns 16 frames of a tile");
static_assert(BOXES == 32, "one box a lane of warp 0");
static_assert((PITCH * 2) % 16 == 0 && (PITCH * 2 / 4) % 32 == 4,
              "ldmatrix rows 16-byte aligned and on distinct banks");

// The launch geometry of one instantiation (signal/fir_cuda.py fir_layout
// mirrors it): the bytes of a ring stage (a tile of x in, then the same
// tile of y out), the ring's depth in tiles and the blocks an SM.
__host__ __device__ constexpr int stage_bytes(int in_bytes, int out_bytes) {
    return FR * F * (in_bytes > out_bytes ? in_bytes : out_bytes);
}
__host__ __device__ constexpr int ring_stages(int in_bytes, int out_bytes,
                                              int na) {
    return in_bytes == 2 ? (out_bytes == 2 ? 3 : 2) : (na == 3 ? 1 : 2);
}
__host__ __device__ constexpr int blocks_per_sm(int in_bytes, int out_bytes,
                                                int na) {
    return in_bytes == 2 && out_bytes == 2 ? 3 : 2;
}
__host__ __device__ constexpr int smem_bytes(int in_bytes, int out_bytes,
                                             int na) {
    return ring_stages(in_bytes, out_bytes, na)
               * (stage_bytes(in_bytes, out_bytes) + 8)
           + na * PLANE * 2;
}

// the (signal term, band term) of product i of each plan
__host__ __device__ constexpr int plan_a(int plan, int i) {
    return plan == 0 ? (i == 2 || i == 4 ? 1 : (i == 5 ? 2 : 0))
                     : (plan == 1 && i == 1 ? 1 : 0);
}
__host__ __device__ constexpr int plan_b(int plan, int i) {
    return plan == 0 ? (i == 1 || i == 4 ? 1 : (i == 3 ? 2 : 0))
                     : (i == (plan == 1 ? 2 : 1) ? 1 : 0);
}

// ----------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "FIR_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra FIR_DONE;\n"
        "bra FIR_WAIT;\n"
        "FIR_DONE:\n"
        "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int t, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(t), "r"(row) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int t, int row) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
        "[%0, {%2, %3}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
           "r"(t), "r"(row) : "memory");
}

// this thread's bulk stores: commit those issued; wait until those
// committed have read shared memory (or, at the end, completed)
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes, seen by the async proxy (TMA)
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                 : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
    return __bfloat16_as_ushort(v.x)
           | (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// ------------------------------------------------------- staging x in

// Sample s of plane frame p (0: the previous frame) in a term plane.
__host__ __device__ constexpr int slot(int p, int s) { return p * PITCH + s; }

// Samples a 16-byte group of the ring, and groups a frame.
template <typename In> constexpr int EPG = 16 / sizeof(In);
template <typename In> constexpr int GPF = F / EPG<In>;

// Four float32 samples into NA bf16 terms at `at` (term 0's plane).
template <int NA>
__device__ __forceinline__ void put_terms(float v0, float v1, float v2,
                                          float v3, bf16* at) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
        const __nv_bfloat162 q = __floats2bfloat162_rn(v2, v3);
        *reinterpret_cast<uint2*>(at + i * PLANE) = make_uint2(bits(p), bits(q));
        if (i + 1 < NA) {
            v0 -= __low2float(p);
            v1 -= __high2float(p);
            v2 -= __low2float(q);
            v3 -= __high2float(q);
        }
    }
}

// Group g (EPG samples) of a tile, from the ring, into its terms.
template <int NA>
__device__ __forceinline__ void split_group(const float* ring, int g,
                                            bf16* planes) {
    const float4 v = reinterpret_cast<const float4*>(ring)[g];
    put_terms<NA>(v.x, v.y, v.z, v.w,
                  planes + slot(g / GPF<float> + 1, (g % GPF<float>) * 4));
}
template <int NA>
__device__ __forceinline__ void split_group(const bf16* ring, int g,
                                            bf16* planes) {
    *reinterpret_cast<uint4*>(planes + slot(g / GPF<bf16> + 1, (g % GPF<bf16>) * 8))
        = reinterpret_cast<const uint4*>(ring)[g];
}

// Group g of a tile straight from the row (no alignment assumed), zero at
// and past n: the staging branch.
__device__ __forceinline__ float at_or_zero(const float* xr, long long t,
                                            long long n) {
    return t < n ? xr[t] : 0.0f;
}
__device__ __forceinline__ bf16 at_or_zero(const bf16* xr, long long t,
                                           long long n) {
    return t < n ? xr[t] : __float2bfloat16_rn(0.0f);
}
template <int NA>
__device__ __forceinline__ void stage_group(const float* xr, long long n,
                                            long long t, int g, bf16* planes) {
    put_terms<NA>(at_or_zero(xr, t, n), at_or_zero(xr, t + 1, n),
                  at_or_zero(xr, t + 2, n), at_or_zero(xr, t + 3, n),
                  planes + slot(g / GPF<float> + 1, (g % GPF<float>) * 4));
}
template <int NA>
__device__ __forceinline__ void stage_group(const bf16* xr, long long n,
                                            long long t, int g, bf16* planes) {
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
        v[e] = bits(__halves2bfloat162(at_or_zero(xr, t + 2 * e, n),
                                       at_or_zero(xr, t + 2 * e + 1, n)));
    *reinterpret_cast<uint4*>(planes + slot(g / GPF<bf16> + 1, (g % GPF<bf16>) * 8))
        = make_uint4(v[0], v[1], v[2], v[3]);
}

// One sample of the previous frame (0 <= t < n) into plane row 0.
template <int NA>
__device__ __forceinline__ void put_prev(float v, int col, bf16* planes) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
        const bf16 a = __float2bfloat16_rn(v);
        planes[i * PLANE + slot(0, col)] = a;
        v -= __bfloat162float(a);
    }
}
template <int NA>
__device__ __forceinline__ void put_prev(bf16 v, int col, bf16* planes) {
    planes[slot(0, col)] = v;
}

// ------------------------------------------------------------ storing y

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// Four adjacent outputs at yr[t..t+4): one vector store where they are
// inside the row and aligned, else masked scalar stores.
__device__ __forceinline__ void store4(float* yr, long long n, long long t,
                                       float a, float b, float c, float d) {
    float* p = yr + t;
    if (t + 4 <= n && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
    } else {
        const float v[4] = {a, b, c, d};
        for (int e = 0; e < 4 && t + e < n; ++e) p[e] = v[e];
    }
}
__device__ __forceinline__ void store4(bf16* yr, long long n, long long t,
                                       float a, float b, float c, float d) {
    bf16* p = yr + t;
    if (t + 4 <= n && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        *reinterpret_cast<uint2*>(p) = make_uint2(
            bits(__floats2bfloat162_rn(a, b)), bits(__floats2bfloat162_rn(c, d)));
    } else {
        const float v[4] = {a, b, c, d};
        for (int e = 0; e < 4 && t + e < n; ++e) put(p + e, v[e]);
    }
}

// Four adjacent outputs into a tile staged in shared memory.
__device__ __forceinline__ void stage4(float* p, float a, float b, float c,
                                       float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void stage4(bf16* p, float a, float b, float c,
                                       float d) {
    *reinterpret_cast<uint2*>(p) = make_uint2(
        bits(__floats2bfloat162_rn(a, b)), bits(__floats2bfloat162_rn(c, d)));
}

// ---------------------------------------------------------------- kernel

// Whether TMA streams the rows of x in and of y out: the bases and the row
// strides multiples of 16 bytes, a row at least one box long, coordinates
// in int. Other rows take the staging branch.
template <typename In, typename Out>
inline bool streamed(const In* x, const Out* y, long long n) {
    return (reinterpret_cast<uintptr_t>(x) & 15) == 0
           && (reinterpret_cast<uintptr_t>(y) & 15) == 0
           && (n * static_cast<long long>(sizeof(In))) % 16 == 0
           && (n * static_cast<long long>(sizeof(Out))) % 16 == 0
           && n >= BOX && n <= 0x7fffffffLL - FR * F;
}

// grid: min(tiles, BPSM x SMs) blocks of NT threads, smem_bytes(...) of
// dynamic shared memory; xmap, ymap: the tensor maps of x and y (unused
// unless stream); h holds NB terms of Hcat, each (256, 128) row-major
// bf16; k the number of taps.
template <typename In, typename Out, int PLAN, int NPROD, int NA, int NB>
__global__ void __launch_bounds__(NT, blocks_per_sm(sizeof(In), sizeof(Out), NA))
band_kernel(const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap ymap, const In* __restrict__ x,
            const bf16* __restrict__ h, Out* __restrict__ y, long long n,
            long long runs, long long tiles, int k, int stream) {
    constexpr int STAGES = ring_stages(sizeof(In), sizeof(Out), NA);
    constexpr int SB = stage_bytes(sizeof(In), sizeof(Out));
    constexpr int RING = FR * F;                       // samples a tile
    extern __shared__ __align__(1024) unsigned char smem[];
    bf16* planes = reinterpret_cast<bf16*>(smem + STAGES * SB);
    uint64_t* full = reinterpret_cast<uint64_t*>(planes + NA * PLANE);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const long long lo = tiles * blockIdx.x / gridDim.x;
    const long long hi = tiles * (blockIdx.x + 1) / gridDim.x;
    const int count = static_cast<int>(hi - lo);

    // the band's 9 distinct 16 x 16 tiles (kt = d, jt = 0) as B fragments:
    // b[j][d][half][reg] holds Hcat_j[16 d + 2 (lane % 4) + 8 reg + {0, 1}]
    // [8 half + lane / 4]
    uint32_t b[NB][DT][2][2];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int d = 0; d < DT; ++d)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const bf16* p = h + j * HPLANE
                                    + (16 * d + 2 * (lane % 4) + 8 * r) * F
                                    + 8 * half + lane / 4;
                    b[j][d][half][r] = bits(__halves2bfloat162(p[0], p[F]));
                }

    if (stream && tid == 0) {
        for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // warp 0: tile lo + li of the walk into stage li % STAGES
    auto issue = [&](int li) {
        const long long i = lo + li;
        const long long t0 = (i % runs) * RING;
        const int row = static_cast<int>(i / runs);
        const int boxes = static_cast<int>(
            min(static_cast<long long>(BOXES), (n - t0 + BOX - 1) / BOX));
        uint64_t* bar = full + li % STAGES;
        In* dst = reinterpret_cast<In*>(smem + (li % STAGES) * SB);
        if (lane == 0) mbar_expect(bar, boxes * BOX * sizeof(In));
        __syncwarp();
        if (lane < boxes)
            tma_load(dst + lane * BOX, &xmap, bar,
                     static_cast<int>(t0) + lane * BOX, row);
    };
    if (stream && warp == 0 && FIR_PROBE != 2)
        for (int li = 0; li < STAGES && li < count; ++li) issue(li);

    const int c = (F + 1 - k) / 16;   // a column tile's first band k-tile
                                      // less the column tile
    for (int li = 0; li < count; ++li) {
        const long long i = lo + li;
        const long long row = i / runs, run = i % runs;
        const long long t0 = run * RING;
        const int vf = static_cast<int>(
            min(static_cast<long long>(FR), (n - t0 + F - 1) / F));
        const In* xr = x + row * n;

        // every warp is done with the planes' last tile, and TMA has read
        // the last tile's y out of its stage: refill that stage
        bulk_wait_read();
        __syncthreads();
        if (stream && warp == 0 && FIR_PROBE != 2 && li > 0
            && li - 1 + STAGES < count)
            issue(li - 1 + STAGES);
        if (FIR_PROBE != 2) {
            // the previous frame into plane row 0
            if (run == 0) {
                for (int e = tid; e < NA * F; e += NT)
                    planes[(e / F) * PLANE + slot(0, e % F)] = __float2bfloat16_rn(0.0f);
            } else if (li == 0) {
                put_prev<NA>(xr[t0 - F + tid], tid, planes);
            } else {
                // the last tile's frame FR - 1, by the threads that will
                // overwrite it (so no barrier is needed between the two)
                const int r = tid - ((FR - 1) * GPF<In>) % NT;
                if (r >= 0 && r < GPF<In>) {
                    constexpr int W = EPG<In> * 2;   // bytes a term
                    for (int a = 0; a < NA; ++a) {
                        bf16* row0 = planes + a * PLANE + slot(0, r * EPG<In>);
                        const bf16* last = planes + a * PLANE + slot(FR, r * EPG<In>);
                        if (W == 8)
                            *reinterpret_cast<uint2*>(row0) =
                                *reinterpret_cast<const uint2*>(last);
                        else
                            *reinterpret_cast<uint4*>(row0) =
                                *reinterpret_cast<const uint4*>(last);
                    }
                }
            }
            // the tile's frames into planes rows 1..FR, split once
            const int groups = vf * GPF<In>;
            if (stream) {
                mbar_wait(full + li % STAGES, (li / STAGES) & 1);
                const In* src = reinterpret_cast<const In*>(smem + (li % STAGES) * SB);
#pragma unroll 4
                for (int g = tid; g < groups; g += NT)
                    split_group<NA>(src, g, planes);
            } else {
#pragma unroll 2
                for (int g = tid; g < groups; g += NT)
                    stage_group<NA>(xr, n, t0 + g * EPG<In>, g, planes);
            }
        }
        __syncthreads();   // planes complete; the tile's stage takes its y

        if (16 * warp >= vf) continue;
        float acc[KT / 2][2][4];
#pragma unroll
        for (int jt = 0; jt < KT / 2; ++jt)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[jt][half][e] = 0.0f;

        // A of k-tile kt for frame f is 16 samples of plane row f + kt / 8
        // at column 16 (kt % 8); lane l gives the row of matrix l / 8
        const bf16* a_at = planes + (16 * warp + lane % 16) * PITCH + (lane / 16) * 8;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
            if (FIR_PROBE == 1 || FIR_PROBE == 3 || kt < c) continue;
            uint32_t a[NA][4];
#pragma unroll
            for (int i2 = 0; i2 < NA; ++i2)
                ldmatrix_x4(a[i2], a_at + i2 * PLANE + (kt / 8) * PITCH + (kt % 8) * 16);
#pragma unroll
            for (int jt = 0; jt < KT / 2; ++jt) {
                const int d = kt - jt;
                if (d < 0 || d >= DT || d < c) continue;
#pragma unroll
                for (int p = 0; p < NPROD; ++p)
#pragma unroll
                    for (int half = 0; half < 2; ++half)
                        mma(acc[jt][half], a[plan_a(PLAN, p)],
                            b[plan_b(PLAN, p)][d][half]);
            }
        }

        // lanes q, q ^ 1 of a quad swap halves so that each holds 4
        // adjacent outputs: even q columns 2q.., odd q columns 8 + 2q - 2..
        // Streamed: into the tile's stage (frame f at f F), then TMA stores
        // this warp's 16 frames (boxes past n skipped, the box holding n
        // clipped); else straight to y.
        constexpr bool TMA_OUT = FIR_PROBE != 3;
        Out* yr = y + row * n;
        Out* out = reinterpret_cast<Out*>(smem + (li % STAGES) * SB);
        const int q = lane % 4, odd = q & 1;
        const int f0 = 16 * warp + lane / 4;
#pragma unroll
        for (int jt = 0; jt < KT / 2; ++jt) {
            const int col = 16 * jt + (odd ? 8 + 2 * q - 2 : 2 * q);
#pragma unroll
            for (int rh = 0; rh < 2; ++rh) {
                const float* h0 = acc[jt][0] + 2 * rh;   // columns 2q, 2q + 1
                const float* h1 = acc[jt][1] + 2 * rh;   // columns 8 + 2q, ..
                const float r0 = __shfl_xor_sync(0xffffffffu, odd ? h0[0] : h1[0], 1);
                const float r1 = __shfl_xor_sync(0xffffffffu, odd ? h0[1] : h1[1], 1);
                const float v0 = odd ? r0 : h0[0], v1 = odd ? r1 : h0[1];
                const float v2 = odd ? h1[0] : r0, v3 = odd ? h1[1] : r1;
                const int f = f0 + 8 * rh;
                if (stream && TMA_OUT) {
                    stage4(out + f * F + col, v0, v1, v2, v3);
                } else if (FIR_PROBE != 3 && f < vf) {
                    const long long t = t0 + static_cast<long long>(f) * F + col;
                    if (t < n) store4(yr, n, t, v0, v1, v2, v3);
                }
            }
        }
        if (stream && TMA_OUT) {
            fence_async_shared();
            __syncwarp();
            const long long t = t0 + 16 * warp * F + lane * BOX;
            if (lane < 16 * F / BOX && t < n)
                tma_store(&ymap, out + 16 * warp * F + lane * BOX,
                          static_cast<int>(t), static_cast<int>(row));
            bulk_commit();
        }
    }
    bulk_wait_all();
}

// ----------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once in the loaded libcuda
// (static functions: each library that includes this header keeps its own
// local statics; an inline function's would be one for the whole process)
static EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
        return lib ? reinterpret_cast<EncodeTiled>(
                         dlsym(lib, "cuTensorMapEncodeTiled"))
                   : nullptr;
    }();
    return fn;
}

// The tensor map of x or y (rows, n): boxes of BOX samples of one row;
// loads fill past n with zeros, stores skip it. Returns a CUDA error code.
template <typename T>
int encode_map(CUtensorMap* map, const T* a, int rows, long long n) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * sizeof(T)};
    const cuuint32_t box[2] = {BOX, 1};
    const cuuint32_t estr[2] = {1, 1};
    const CUresult r = encode(
        map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        2, const_cast<T*>(a), dims, strides, box, estr,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The persistent grid: BPSM blocks on each SM, at most one a tile.
inline int grid_blocks(long long tiles, int bpsm) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long most = static_cast<long long>(bpsm) * sms;
    return static_cast<int>(tiles < most ? tiles : most);
}

// Set the kernel's shared memory and check that BPSM blocks fit an SM
// (once an instantiation). Returns a CUDA error code.
template <typename In, typename Out, int PLAN, int NPROD, int NA, int NB>
static int prepare() {
    constexpr int smem = smem_bytes(sizeof(In), sizeof(Out), NA);
    constexpr int bpsm = blocks_per_sm(sizeof(In), sizeof(Out), NA);
    static_assert(bpsm * (smem + 1024) <= SMEM_PER_SM,
                  "the layout's blocks fit an SM's shared memory");
    static const int err = [] {
        auto kernel = band_kernel<In, Out, PLAN, NPROD, NA, NB>;
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        int resident = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, NT,
                                                          smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        return resident >= bpsm ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
    }();
    return err;
}

// Launch one instance on `stream`; returns the CUDA error code.
template <typename In, typename Out, int PLAN, int NPROD, int NA, int NB>
int launch(const In* x, const bf16* h, Out* y, int rows, long long n, int k,
           cudaStream_t stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (k < 1 || k > F) return static_cast<int>(cudaErrorInvalidValue);
    const long long frames = (n + F - 1) / F;
    const long long runs = (frames + FR - 1) / FR;
    const long long tiles = runs * rows;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int err = prepare<In, Out, PLAN, NPROD, NA, NB>();
    if (err != 0) return err;
    CUtensorMap xmap{}, ymap{};
    const bool tma = streamed(x, y, n);
    if (tma) {
        int e = encode_map(&xmap, x, rows, n);
        if (e == 0) e = encode_map(&ymap, y, rows, n);
        if (e != 0) return e;
    }
    band_kernel<In, Out, PLAN, NPROD, NA, NB>
        <<<grid_blocks(tiles, blocks_per_sm(sizeof(In), sizeof(Out), NA)), NT,
           smem_bytes(sizeof(In), sizeof(Out), NA), stream>>>(
        xmap, ymap, x, h, y, n, runs, tiles, k, tma ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}

// What was built for one instantiation: registers and local (spill) bytes
// a thread, dynamic and static shared bytes, threads, resident blocks an
// SM, frames a tile and ring stages, into vals[0..8).
template <typename In, typename Out, int PLAN, int NPROD, int NA, int NB>
int attributes(int* vals) {
    const int err = prepare<In, Out, PLAN, NPROD, NA, NB>();
    if (err != 0) return err;
    cudaFuncAttributes a{};
    auto kernel = band_kernel<In, Out, PLAN, NPROD, NA, NB>;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    constexpr int smem = smem_bytes(sizeof(In), sizeof(Out), NA);
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, NT, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    vals[0] = a.numRegs;
    vals[1] = static_cast<int>(a.localSizeBytes);
    vals[2] = smem;
    vals[3] = NT;
    vals[4] = resident;
    vals[5] = static_cast<int>(a.sharedSizeBytes);
    vals[6] = FR;
    vals[7] = ring_stages(sizeof(In), sizeof(Out), NA);
    return 0;
}

}  // namespace fir
