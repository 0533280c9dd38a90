// One RK stage of the periodic barotropic vorticity equation, for sm_90a.
//
// Replaces the TPU kernel _baro_stage_kernel (njw_tpu/ops/baro_stencil.py:34,
// launched by baro_stage_pallas :111 -> :143):
//
//   out = base + c_dt * ( -(J1 + J2 + J3) / (12 dx dy)
//                         - beta (psiE - psiW) / (2 dx)
//                         + nu Laplacian(zeta) )
//
// with Arakawa's (1966) 9-point Jacobian of psi and zeta and periodic wrap
// on both axes, for float32 (ny, nx) fields, any ny, nx >= 3. The
// arithmetic is the Pallas kernel's: multiply by -1/(12 dx dy), divide by
// dx^2 and dy^2 in the Laplacian, constants folded in double on the host
// and rounded to float32 once.
//
// Bound on this card: memory. The stage must read psi, zeta and base once
// and write out once, 16 B/point: 16.8 MB at 1024^2, 5.0 us at the H100
// SXM's 3.35 TB/s. The arithmetic is about 48 flop/point, 0.05 GFLOP at
// 1024^2, under 1 us at 67 TFLOP/s fp32. At that size the launch's own
// fixed cost (a few us: scripts/profile_torch.py times an empty launch) is
// of the order of the bound, so what counts is how soon the loads are in
// flight and how few instructions surround them.
//
// Design against that bound: no shared memory and no barrier. Each warp
// owns a strip of H = 4 rows of 32 V columns (V = 4 where nx % 4 == 0 and
// the fields are 16-byte aligned: one float4 a lane and row; else V = 1),
// and issues every load of its strip at once: the H + 2 rows of psi and
// zeta it reads (one wrapped row above and below), the two halo columns
// (lane 0 the west one, lane 31 the east one) and the H rows of base, so
// each lane has all its bytes in flight before it computes. The side
// neighbours come from the next lanes by warp shuffles, the rows above and
// below from the lane's own registers. Rows and columns wrap by a modulo
// once a row and once a lane when the strip starts; lanes past a ragged
// edge read wrapped columns (so the last column's east neighbour is column
// 0) and store nothing, and so do rows past the last. The halo rows are
// re-read by the neighbouring strips ((H + 2) / H of the psi and zeta
// bytes), which L2 serves. A block is four independent warps. Where dx =
// dy = 1 (the main path) the divisions by dx^2 and dy^2 are identities and
// are left out (an instantiation of its own): nvcc's IEEE division takes
// its slow path on a subnormal numerator, and most of the main path's far
// field is subnormal or zero. Each point's
// arithmetic is kept apart from its neighbour's (opaque() below), so nvcc
// contracts it as it does one point alone: the outputs equal those of the
// earlier one-point-a-thread tile kernel bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;           // warps a block
constexpr int NT = 32 * WARPS;     // 128 threads
constexpr unsigned FULL = 0xffffffffu;

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

// V consecutive floats at p (a float4 where V = 4); read-only data takes
// the read-only path, base (which may alias out) plain loads.
template <int V, bool kReadOnly>
__device__ __forceinline__ void load(const float* p, float (&c)[V]) {
    if constexpr (V == 4) {
        const float4 t = kReadOnly ? __ldg(reinterpret_cast<const float4*>(p))
                                   : *reinterpret_cast<const float4*>(p);
        c[0] = t.x; c[1] = t.y; c[2] = t.z; c[3] = t.w;
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j) c[j] = kReadOnly ? __ldg(p + j) : p[j];
    }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&c)[V]) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j) p[j] = c[j];
    }
}

// Values the compiler may not relate to any other: an empty asm that
// claims to change them.
__device__ __forceinline__ void opaque1(float& x) {
    asm volatile("" : "+f"(x));
}

template <class... F>
__device__ __forceinline__ void opaque(F&... x) {
    (opaque1(x), ...);
}

// One row of a field around a lane's V columns: the columns, and the
// columns just west and east of them.
template <int V>
struct Row {
    float c[V];
    float w, e;
    __device__ __forceinline__ float at(int j) const {   // j in [-1, V]
        return j < 0 ? w : j >= V ? e : c[j];
    }
};

template <int V, int H, bool kUnit>
__global__ void __launch_bounds__(NT) baro_stage_kernel(
    const float* __restrict__ psi, const float* __restrict__ zeta,
    const float* base, float* out, int ny, int nx, Consts k) {
    // base and out may alias (each point is read before it is written, by
    // the same thread), so neither is __restrict__
    const int lane = threadIdx.x % 32;
    const int y0 = (blockIdx.y * WARPS + threadIdx.x / 32) * H;
    if (y0 >= ny) return;   // the whole warp: no shuffle waits for it
    const int x0 = blockIdx.x * 32 * V;
    const bool live_x = x0 + V * lane < nx;
    const int xl = wrap(x0 + V * lane, nx);
    // lane 0 reads the strip's west halo column, lane 31 its east one
    const int xh = lane == 0 ? wrap(x0 - 1, nx) : wrap(x0 + 32 * V, nx);
    const bool halo_lane = lane == 0 || lane == 31;

    // every load of the strip, before any arithmetic
    Row<V> p[H + 2], z[H + 2];   // rows y0 - 1 .. y0 + H
    float b[H][V];
#pragma unroll
    for (int i = 0; i < H + 2; ++i) {
        const size_t row = static_cast<size_t>(wrap(y0 - 1 + i, ny)) * nx;
        load<V, true>(psi + row + xl, p[i].c);
        load<V, true>(zeta + row + xl, z[i].c);
        p[i].w = z[i].w = 0.0f;
        if (halo_lane) {
            p[i].w = __ldg(psi + row + xh);
            z[i].w = __ldg(zeta + row + xh);
        }
    }
#pragma unroll
    for (int i = 0; i < H; ++i) {
        if (live_x && y0 + i < ny) {
            load<V, false>(base + static_cast<size_t>(y0 + i) * nx + xl, b[i]);
        }
    }
    // the side neighbours from the next lanes; the halo lanes' own columns
#pragma unroll
    for (int i = 0; i < H + 2; ++i) {
        const float ph = p[i].w, zh = z[i].w;
        p[i].w = __shfl_up_sync(FULL, p[i].c[V - 1], 1);
        p[i].e = __shfl_down_sync(FULL, p[i].c[0], 1);
        z[i].w = __shfl_up_sync(FULL, z[i].c[V - 1], 1);
        z[i].e = __shfl_down_sync(FULL, z[i].c[0], 1);
        if (lane == 0) { p[i].w = ph; z[i].w = zh; }
        if (lane == 31) { p[i].e = ph; z[i].e = zh; }
    }

#pragma unroll
    for (int i = 0; i < H; ++i) {
        if (!live_x || y0 + i >= ny) continue;
        // rows south (i), centre (i + 1) and north (i + 2: north is +y)
        const Row<V>& ps_ = p[i];
        const Row<V>& pc_ = p[i + 1];
        const Row<V>& pn_ = p[i + 2];
        const Row<V>& zs_ = z[i];
        const Row<V>& zc_ = z[i + 1];
        const Row<V>& zn_ = z[i + 2];
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
            float pE = pc_.at(j + 1), pW = pc_.at(j - 1);
            float pN = pn_.at(j), pS = ps_.at(j);
            float pNE = pn_.at(j + 1), pNW = pn_.at(j - 1);
            float pSE = ps_.at(j + 1), pSW = ps_.at(j - 1);
            float zc = zc_.at(j);
            float zE = zc_.at(j + 1), zW = zc_.at(j - 1);
            float zN = zn_.at(j), zS = zs_.at(j);
            float zNE = zn_.at(j + 1), zNW = zn_.at(j - 1);
            float zSE = zs_.at(j + 1), zSW = zs_.at(j - 1);
            // each point's arithmetic on its own (no expression shared with
            // the next point's), so that nvcc contracts it as it does one
            // point alone
            opaque(pE, pW, pN, pS, pNE, pNW, pSE, pSW, zc);
            opaque(zE, zW, zN, zS, zNE, zNW, zSE, zSW, zc);

            const float j1 = (pE - pW) * (zN - zS) - (pN - pS) * (zE - zW);
            const float j2 = pE * (zNE - zSE) - pW * (zNW - zSW)
                             - pN * (zNE - zNW) + pS * (zSE - zSW);
            const float j3 = zN * (pNE - pNW) - zS * (pSE - pSW)
                             - zE * (pNE - pSE) + zW * (pNW - pSW);
            float dz = (j1 + j2 + j3) * k.m12;
            if (k.has_beta) dz = dz - k.beta * ((pE - pW) * k.cx);
            if (k.has_nu) {
                // kUnit: dx = dy = 1, and x / 1 is x, subnormal x too
                const float lx = zE - 2.0f * zc + zW;
                const float ly = zN - 2.0f * zc + zS;
                const float lap = kUnit ? lx + ly : lx / k.dx2 + ly / k.dy2;
                dz = dz + k.nu * lap;
            }
            o[j] = b[i][j] + k.c_dt * dz;
        }
        store<V>(out + static_cast<size_t>(y0 + i) * nx + xl, o);
    }
}

// The strips built: {V, H}, the fastest the H100 timed at 1024^2 (and on
// odd grids for V = 1) among 4 x 4, 4 x 2, 1 x 8 and 1 x 4 (PERF.md).
// Entry 0 is the rule's where nx % 4 == 0 and the fields are 16-byte
// aligned, entry 1 otherwise.
constexpr int kStrips[][2] = {{4, 4}, {1, 4}};
constexpr int kNumStrips = sizeof(kStrips) / sizeof(kStrips[0]);

template <int V, int H, bool kUnit>
int launch(const float* psi, const float* zeta, const float* base,
           float* out, int ny, int nx, const Consts& k,
           cudaStream_t stream) {
    const int strips = (ny + H - 1) / H;
    const dim3 grid((nx + 32 * V - 1) / (32 * V),
                    (strips + WARPS - 1) / WARPS);
    baro_stage_kernel<V, H, kUnit><<<grid, NT, 0, stream>>>(
        psi, zeta, base, out, ny, nx, k);
    return static_cast<int>(cudaGetLastError());
}

// Run f.run<V, H, kUnit>() for strip `index` of kStrips; kUnit where dx =
// dy = 1.
template <class F>
int with_strip(int index, bool unit, const F& f) {
    switch (index * 2 + unit) {
        case 0: return f.template run<kStrips[0][0], kStrips[0][1], false>();
        case 1: return f.template run<kStrips[0][0], kStrips[0][1], true>();
        case 2: return f.template run<kStrips[1][0], kStrips[1][1], false>();
        case 3: return f.template run<kStrips[1][0], kStrips[1][1], true>();
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
static_assert(kNumStrips == 2, "with_strip names every strip");

struct Launch {
    const float *psi, *zeta, *base;
    float* out;
    int ny, nx;
    Consts k;
    cudaStream_t stream;
    template <int V, int H, bool kUnit>
    int run() const {
        return launch<V, H, kUnit>(psi, zeta, base, out, ny, nx, k, stream);
    }
};

struct AttributeQuery {
    int* out;
    template <int V, int H, bool kUnit>
    int run() const {
        const auto kernel = baro_stage_kernel<V, H, kUnit>;
        cudaFuncAttributes a;
        cudaError_t err = cudaFuncGetAttributes(&a, kernel);
        if (err != cudaSuccess) return static_cast<int>(err);
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            NT, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
        out[0] = a.numRegs;
        out[1] = static_cast<int>(a.localSizeBytes);
        out[2] = static_cast<int>(a.sharedSizeBytes);
        out[3] = NT;
        out[4] = per_sm;
        out[5] = V;
        out[6] = H;
        return 0;
    }
};

bool aligned16(const void* q) {
    return reinterpret_cast<unsigned long long>(q) % 16 == 0;
}

}  // namespace

// Launch one stage on `stream`. `out` must not alias psi or zeta (it may
// alias base). strip: -1 for the rule's (4 columns a lane and 4 rows a
// warp where nx % 4 == 0 and every field is 16-byte aligned, else 1 and
// 4), or an index of kStrips (one with 4 columns a lane needs what the
// rule needs for it). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int baro_stage_launch(
    const float* psi, const float* zeta, const float* base, float* out,
    int ny, int nx, float m12, float cx, float beta, float dx2, float dy2,
    float nu, float c_dt, int has_beta, int has_nu, int strip,
    void* stream) {
    const bool vec = nx % 4 == 0 && aligned16(psi) && aligned16(zeta)
                     && aligned16(base) && aligned16(out);
    if (strip < 0) strip = vec ? 0 : 1;
    if (ny < 3 || nx < 3 || strip >= kNumStrips
        || (kStrips[strip][0] == 4 && !vec)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Consts k{m12, cx, beta, dx2, dy2, nu, c_dt, has_beta, has_nu};
    return with_strip(strip, dx2 == 1.0f && dy2 == 1.0f,
                      Launch{psi, zeta, base, out, ny, nx, k,
                             static_cast<cudaStream_t>(stream)});
}

// The built kernel of strip index `strip` (of kStrips), unit: 1 for the
// dx = dy = 1 instantiation: registers, spill bytes, static shared bytes,
// threads, blocks per SM, columns a lane and rows a warp into out[7].
// Returns the CUDA error code.
extern "C" int baro_stage_attributes(int strip, int unit, int* out) {
    return with_strip(strip, unit != 0, AttributeQuery{out});
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* baro_stage_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
