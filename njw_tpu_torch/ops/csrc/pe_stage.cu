// One RK stage of the periodic primitive equations (sigma levels), sm_90a.
//
// Replaces the TPU kernel _pe_stage_kernel (njw_tpu/ops/pe_stencil.py:55)
// for all its launchers: pe_stage_pallas (:370, the whole periodic domain)
// and the sharded pe_stage_pallas_local (:462) and _local2d (:1353), which
// run it on a halo-padded block:
//
//   out = sum_g coef_g * base_g + c_dt * T(cur),   g < nbase <= 4,
//
// for u, v, T, q of shape (L, ny, nx) and ps of shape (ny, nx), float32,
// with an optional surface geopotential phi_s (terrain). The multi-base
// form lets the RK4 combine ride in the last stage. The column arithmetic
// (pe_column.cuh) is the Pallas kernel's strength-reduced form. Scalars
// are folded in double on the host and rounded to float32 once; the
// per-level constants (layer thickness factor, 1/(k + 1/2)) come from a
// small device array built once per level count.
//
// Bound on this card: memory. A stage must read cur (4L + 1 planes) and
// each base (4L + 1 planes) once, read phi_s once when given, and write
// out (4L + 1 planes) once: 3 (4L + 1) x 4 B = 972 B per column with one
// base at L = 20, 255 MB at 512^2, 76 us at the H100 SXM's 3.35 TB/s (510
// MB and 152 us with four distinct bases). The arithmetic is about 116
// flop per column and level (140 with four bases), 0.61 GFLOP per stage at
// 512^2 x 20, 9 us at 67 TFLOP/s fp32.
//
// Design against that bound: one thread per (y, x) column, 32 x 4 threads
// per block with x contiguous, so each level's loads and stores are
// coalesced. The thread loops over the levels twice (top-down, then
// bottom-up). The stencil needs only the four side neighbours (no
// corners), read straight from device memory: they are the neighbouring
// threads' own columns, so L1 and L2 serve them and device memory sees
// each plane about once. The thread carries phi for its four neighbour
// columns (d/dx and d/dy of phi need only those) and the three centre
// values of each field around the current level. cum_k lives in dynamic
// shared memory, L floats per thread (10 KB per block at L = 20), so L is
// bounded only by shared memory. Ragged edges mask whole threads.
//
// Addressing (one launch for every launcher): cur, the bases and out are
// each a view (base pointer, row pitch, plane pitch, origin of the (ny, nx)
// interior), so the bases and out may be interior-shaped arrays or the
// interiors of padded blocks while cur is padded. Per axis (a template
// parameter) cur either wraps (the whole periodic domain, and x of a row
// decomposition: a select on each neighbour index) or holds at least one
// halo row (column) of neighbour data around the interior, read in place
// of the wrap. The whole-domain instantiation is the code it was before.

#include <cuda_runtime.h>

#include "pe_column.cuh"

namespace {

constexpr int BX = 32;             // threads along x (contiguous)
constexpr int BY = 4;              // threads along y
constexpr int NT = BX * BY;        // 128 threads per block
constexpr int MAXB = 4;            // most bases

// Element (k, y, x) of a view is p[k * plane + (oy + y) * pitch + ox + x];
// the 2-D field ps of the same view drops the plane term.
struct Layout {
    long long pitch, plane;
    int oy, ox;
};

struct Ptrs {
    const float* cur[5];            // u, v, T, q, ps
    const float* phi_s;             // (ny, nx) or null (whole domain only)
    const float* base[MAXB][5];
    float* out[5];
    const float* levc;              // thick[0..L), inv_kh[0..L)
    Layout lcur, lout;              // cur's view; out's and the bases'
};

struct Consts {
    pe::Consts col;
    float c_dt;
    float coef[MAXB];
    int nbase;
    int L, ny, nx;
};

// Bases may alias the output, so they are read with plain loads.
__device__ __forceinline__ float base_sum(const Ptrs& p, const Consts& k,
                                          int field, size_t i) {
    float acc = k.coef[0] * p.base[0][field][i];
#pragma unroll
    for (int g = 1; g < MAXB; ++g)
        if (g < k.nbase) acc = acc + k.coef[g] * p.base[g][field][i];
    return acc;
}

// out = sum_g coef_g base_g + c_dt d at each level of the column.
struct StageEmit {
    const Ptrs& p;
    const Consts& k;
    size_t P, ic;
    __device__ __forceinline__ void level(int kk, float du, float dv,
                                          float dT, float dq) {
        const size_t o = kk * P + ic;
        p.out[0][o] = base_sum(p, k, 0, o) + k.c_dt * du;
        p.out[1][o] = base_sum(p, k, 1, o) + k.c_dt * dv;
        p.out[2][o] = base_sum(p, k, 2, o) + k.c_dt * dT;
        p.out[3][o] = base_sum(p, k, 3, o) + k.c_dt * dq;
    }
};

// The stage at column (y, x) of the whole periodic domain: cur, the bases
// and out are (ny, nx) planes (the code of the kernel before the padded
// forms, so that the whole-domain instantiation compiles as it did).
__device__ __forceinline__ void whole_column(const Ptrs& p, const Consts& k,
                                             int y, int x) {
    extern __shared__ float cum_smem[];
    const int nx = k.nx, ny = k.ny;

    const size_t row = static_cast<size_t>(y) * nx;
    const pe::Nbrs i{
        row + x, row + (x + 1 == nx ? 0 : x + 1),
        row + (x == 0 ? nx - 1 : x - 1),
        static_cast<size_t>(y + 1 == ny ? 0 : y + 1) * nx + x,
        static_cast<size_t>(y == 0 ? ny - 1 : y - 1) * nx + x};
    float phisE = 0.0f, phisW = 0.0f, phisN = 0.0f, phisS = 0.0f;
    if (p.phi_s != nullptr) {
        phisE = __ldg(p.phi_s + i.e);
        phisW = __ldg(p.phi_s + i.w);
        phisN = __ldg(p.phi_s + i.n);
        phisS = __ldg(p.phi_s + i.s);
    }
    const size_t P = static_cast<size_t>(ny) * nx;
    StageEmit emit{p, k, P, i.c};
    // cur never aliases out (the wrapper refuses it): read-only loads
    const float dps = pe::column_tendency<true, 2>(
        p.cur[0], p.cur[1], p.cur[2], p.cur[3], p.cur[4], P, i, phisE, phisW,
        phisN, phisS, cum_smem + threadIdx.y * BX + threadIdx.x, NT, p.levc,
        k.L, k.col, emit);
    p.out[4][i.c] = base_sum(p, k, 4, i.c) + k.c_dt * dps;
}

// The stage at column (y, x) of the interior of a padded cur: the rows
// above and below come from its halo, and so do the columns where kHaloX
// (x wraps otherwise). out and the bases share one view (interior-shaped
// arrays, or the interiors of padded blocks of one shape); phi_s is null.
template <bool kHaloX>
__device__ __forceinline__ void padded_column(const Ptrs& p,
                                              const Consts& k, int y,
                                              int x) {
    extern __shared__ float cum_smem[];
    const int nx = k.nx;
    const Layout& c = p.lcur;
    const size_t pitch = static_cast<size_t>(c.pitch);
    const size_t row = static_cast<size_t>(c.oy + y) * pitch + c.ox;
    const size_t ic = row + x;
    const pe::Nbrs i{
        ic, kHaloX ? ic + 1 : row + (x + 1 == nx ? 0 : x + 1),
        kHaloX ? ic - 1 : row + (x == 0 ? nx - 1 : x - 1), ic + pitch,
        ic - pitch};
    const size_t o = static_cast<size_t>(y) * p.lout.pitch + x;
    StageEmit emit{p, k, static_cast<size_t>(p.lout.plane), o};
    const float dps = pe::column_tendency<true, 2>(
        p.cur[0], p.cur[1], p.cur[2], p.cur[3], p.cur[4],
        static_cast<size_t>(c.plane), i, 0.0f, 0.0f, 0.0f, 0.0f,
        cum_smem + threadIdx.y * BX + threadIdx.x, NT, p.levc, k.L, k.col,
        emit);
    p.out[4][o] = base_sum(p, k, 4, o) + k.c_dt * dps;
}

template <bool kHaloY, bool kHaloX>
__global__ void __launch_bounds__(NT) pe_stage_kernel(Ptrs p, Consts k) {
    const int x = blockIdx.x * BX + threadIdx.x;
    const int y = blockIdx.y * BY + threadIdx.y;
    if (x >= k.nx || y >= k.ny) return;   // no barriers below
    if constexpr (kHaloY) {
        padded_column<kHaloX>(p, k, y, x);
    } else {
        whole_column(p, k, y, x);
    }
}

template <bool kHaloY, bool kHaloX>
int launch(const Ptrs& p, const Consts& k, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(k.L) * NT * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            pe_stage_kernel<kHaloY, kHaloX>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid((k.nx + BX - 1) / BX, (k.ny + BY - 1) / BY);
    const dim3 block(BX, BY);
    pe_stage_kernel<kHaloY, kHaloX><<<grid, block, smem, stream>>>(p, k);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one stage of the (L, ny, nx) interior on `stream`. cur (u, v, T,
// q, ps; phi_s on the whole domain only) is given as the base pointers of
// its fields, their row pitch and plane pitch (3-D fields) and the origin
// (row, column) of the interior; out and the bases as their pointers and
// the row and plane pitch they share. halo_y, halo_x: 1 where cur holds at
// least one row (column) of neighbour data around the interior, 0 where
// that axis wraps; a halo in x needs one in y. Base pointers beyond
// `nbase` may be null. The outputs must not alias cur (they may alias a
// base, read at the same point first). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int pe_stage_launch(
    const float* u, const float* v, const float* T, const float* q,
    const float* ps, const float* phi_s, long long cur_pitch,
    long long cur_plane, int cur_oy, int cur_ox,
    const float* b0u, const float* b0v, const float* b0T, const float* b0q,
    const float* b0ps,
    const float* b1u, const float* b1v, const float* b1T, const float* b1q,
    const float* b1ps,
    const float* b2u, const float* b2v, const float* b2T, const float* b2q,
    const float* b2ps,
    const float* b3u, const float* b3v, const float* b3T, const float* b3q,
    const float* b3ps,
    int nbase, float c0, float c1, float c2, float c3,
    float* ou, float* ov, float* oT, float* oq, float* ops,
    long long out_pitch, long long out_plane,
    const float* levc, int L, int ny, int nx, int halo_y, int halo_x,
    float cx, float cy, float f, float dsig, float r_dry, float kappa,
    float phibot, float c_dt, void* stream) {
    if (nbase < 1 || nbase > MAXB || L < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Ptrs p{{u, v, T, q, ps}, phi_s,
                 {{b0u, b0v, b0T, b0q, b0ps}, {b1u, b1v, b1T, b1q, b1ps},
                  {b2u, b2v, b2T, b2q, b2ps}, {b3u, b3v, b3T, b3q, b3ps}},
                 {ou, ov, oT, oq, ops}, levc,
                 {cur_pitch, cur_plane, cur_oy, cur_ox},
                 {out_pitch, out_plane, 0, 0}};
    const Consts k{{cx, cy, f, dsig, r_dry, kappa, phibot}, c_dt,
                   {c0, c1, c2, c3}, nbase, L, ny, nx};
    const auto s = static_cast<cudaStream_t>(stream);
    if (!halo_y && !halo_x) return launch<false, false>(p, k, s);
    if (phi_s != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (halo_y && !halo_x) return launch<true, false>(p, k, s);
    if (halo_y && halo_x) return launch<true, true>(p, k, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* pe_stage_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
