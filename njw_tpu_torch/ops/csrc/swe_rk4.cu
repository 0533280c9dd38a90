// Fused RK4 steps of the periodic shallow-water equations, for sm_90a.
//
// Replaces three TPU kernels of njw_tpu/ops/stencil.py with one source:
//   K1       swe_rk4_kernel (njw_tpu/ops/stencil.py:60), float32, for all
//            its launchers:
//            swe_rk4_step_pallas (:245, the whole periodic domain) and the
//            sharded ones on a halo-padded block, swe_rk4_step_pallas_local
//            (:359), _carry (:416) and _local2d (:471);
//   K1-bf16  the same kernel's variant="bf16"/"bf16s" tendency (:155-174),
//            launched through swe_rk4_step_pallas(variant=...);
//   K2       _swe_rk4_multi_kernel (:484), launched by
//            swe_rk4_multistep_pallas (:584): N = 1 or 2 chained RK4 steps
//            in one pass, no viscosity.
// One whole RK4 step (N steps for K2) for float32 (ny, nx) fields u, v, h
// in a single pass over device memory.
//
// Addressing (one launch for every launcher). The input is a view: the
// base pointer of a (possibly padded) block, its row pitch and the origin
// (row, column) of the (ny, nx) interior inside it. Each axis is either
//   wrap  the interior is the whole periodic extent: neighbour indices are
//         taken modulo ny (nx); the whole-domain step, and x of a 1-D
//         (row) decomposition;
//   halo  the block holds at least HALO = 4 rows (columns) of neighbour
//         data on each side of the interior, exchanged by the caller; the
//         kernel reads them in place of the wrap.
// The output is a view too (pointer, pitch, origin), so the _local forms
// write a (ny, nx) array and the _carry forms the interior of the next
// padded block. Wrap or halo is a template parameter, so the whole-domain
// instantiation is the code it was before the sharded forms. The bf16
// tendency and the two-step form take the whole periodic domain only (the
// JAX package has no padded launcher for them).
//
// Bound on this card: memory. A step must read u, v, h once and write
// them once, 24 B/point: 100.7 MB at 2048^2, about 30 us at the H100 SXM's
// 3.35 TB/s. The arithmetic is about 156 flop/point (4 stages of ~33 plus
// the combines), 0.65 GFLOP at 2048^2, about 10 us at 67 TFLOP/s fp32.
// K2 with N = 2 moves the same 24 B/point for two steps (12 B/point per
// step) and does twice the arithmetic, so its bound per step is half K1's
// bytes bound (still above the fp32 operations bound). The bf16 tendency
// does the same work in bf16 scalars: Hopper's CUDA cores run scalar bf16
// no faster than fp32, so its bound is K1's.
//
// Design against that bound: each block owns a TY x TX output tile and
// loads a (TY+8N) x (TX+8N) tile of u, v, h (by modular index on a wrap
// axis, so any ny, nx >= 3 works, including grids smaller than the tile;
// from the halo on a halo axis) into shared memory once. The 4N RK4 stages
// then run in shared memory over a valid region that shrinks by one point
// per side per stage (N = 1: 40^2 -> 38^2 -> 36^2 -> 34^2 -> 32^2): the
// halo is recomputed instead of exchanged, and no stage touches device
// memory. The combine is the TPU kernel's accumulator form, which keeps
// only {s, current stage, accumulator} live: 9 tile buffers, 57,600 B of
// dynamic shared memory at N = 1 and 82,944 B at N = 2 (above the 48 KB
// default, so the launch raises the opt-in limit).
//   s1 = s + dt/2 T(s);   acc = s1 - s
//   s2 = s + dt/2 T(s1);  acc += 2 s2
//   s3 = s + dt T(s2);    acc += s3
//   s' = acc/3 + dt/6 T(s3)
// With N = 2 the first step's s' is written over s in shared memory and
// the second step starts from it. Both steps run the same tendency() and
// stage() code as K1, so the same expressions get the same contractions:
// K2 with N = 2 equals two K1 launches (float32, no viscosity) bit for bit.
// Ragged edge tiles compute on the periodic extension and mask the store;
// on a halo axis the load index is clamped to the last halo row (column),
// so a ragged tile never reads outside the block: the clamped points feed
// only outputs past the interior, which are masked.
//
// The bf16 tendency (tendency_bf16 of the TPU kernel) rounds u, v, h to
// bf16 and computes the differences, their products with bf16(cx) and
// bf16(cy), and the three advection sums in bf16, each operation rounded
// (the _rn intrinsics of cuda_bf16.h, which nvcc does not contract into
// fma.bf16); g h_x (from the bf16 h_x), f v, the viscosity, the shared
// tiles and every stage state stay float32.
// Making it fast (TMA loads, larger tiles, register blocking) is later
// work; this is the simple, correct first form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;                 // output tile width (x, contiguous)
constexpr int TY = 32;                 // output tile height
constexpr int HALO = 4;                // one point per chained stencil stage
constexpr int NT = 256;                // threads per block

// Shared tile geometry of N fused steps: 4N halo points per side.
template <int N>
struct Tile {
    static constexpr int H = HALO * N;
    static constexpr int PX = TX + 2 * H;   // shared tile pitch: 40, 48
    static constexpr int PY = TY + 2 * H;
    static constexpr int SIZE = PX * PY;    // points per shared tile buffer
    static constexpr int SMEM_BYTES = 9 * SIZE * static_cast<int>(sizeof(float));
};

// A float32 field view: element (y, x) of the interior, -HALO <= y, x on a
// halo axis, is p[(oy + y) * pitch + ox + x].
struct View {
    const float* u;
    const float* v;
    const float* h;
    long long pitch;
    int oy, ox;
};

struct OutView {
    float* u;
    float* v;
    float* h;
    long long pitch;
    int oy, ox;
};

struct Consts {
    float cx, cy;     // 0.5/dx, 0.5/dy
    float g, f;       // gravity, constant Coriolis parameter
    float half, dt;   // dt/2, dt
    float sixth;      // dt/6
    float third;      // 1/3
    float ix2, iy2;   // nu/dx^2, nu/dy^2 (used when visc != 0)
    float bcx, bcy;   // bf16(0.5/dx), bf16(0.5/dy): exact bf16 values
    int visc;
};

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

__device__ __forceinline__ __nv_bfloat16 bf(float x) {
    return __float2bfloat16_rn(x);
}

// bf16 central difference (a - b) * c, each operation rounded.
__device__ __forceinline__ __nv_bfloat16 bdiff(float a, float b,
                                               __nv_bfloat16 c) {
    return __hmul_rn(__hsub_rn(bf(a), bf(b)), c);
}

// Tendency of (u, v, h) at shared-tile index j of a tile of pitch P.
template <int P, bool kBf16>
__device__ __forceinline__ void tendency(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ h, int j, const Consts& k,
    float& du, float& dv, float& dh) {
    const float uc = u[j], vc = v[j], hc = h[j];
    if constexpr (kBf16) {
        const __nv_bfloat16 bcx = bf(k.bcx), bcy = bf(k.bcy);
        const __nv_bfloat16 ub = bf(uc), vb = bf(vc), hb = bf(hc);
        const __nv_bfloat16 u_x = bdiff(u[j + 1], u[j - 1], bcx);
        const __nv_bfloat16 u_y = bdiff(u[j + P], u[j - P], bcy);
        const __nv_bfloat16 v_x = bdiff(v[j + 1], v[j - 1], bcx);
        const __nv_bfloat16 v_y = bdiff(v[j + P], v[j - P], bcy);
        const __nv_bfloat16 h_x = bdiff(h[j + 1], h[j - 1], bcx);
        const __nv_bfloat16 h_y = bdiff(h[j + P], h[j - P], bcy);
        // -ub u_x - vb u_y, -ub v_x - vb v_y,
        // -hb (u_x + v_y) - ub h_x - vb h_y, in the TPU kernel's order
        const __nv_bfloat16 au = __hsub_rn(__hmul_rn(__hneg(ub), u_x),
                                           __hmul_rn(vb, u_y));
        const __nv_bfloat16 av = __hsub_rn(__hmul_rn(__hneg(ub), v_x),
                                           __hmul_rn(vb, v_y));
        const __nv_bfloat16 ah = __hsub_rn(
            __hsub_rn(__hmul_rn(__hneg(hb), __hadd_rn(u_x, v_y)),
                      __hmul_rn(ub, h_x)),
            __hmul_rn(vb, h_y));
        du = __bfloat162float(au) - k.g * __bfloat162float(h_x) + k.f * vc;
        dv = __bfloat162float(av) - k.g * __bfloat162float(h_y) - k.f * uc;
        dh = __bfloat162float(ah);
    } else {
        const float u_x = (u[j + 1] - u[j - 1]) * k.cx;
        const float u_y = (u[j + P] - u[j - P]) * k.cy;
        const float v_x = (v[j + 1] - v[j - 1]) * k.cx;
        const float v_y = (v[j + P] - v[j - P]) * k.cy;
        const float h_x = (h[j + 1] - h[j - 1]) * k.cx;
        const float h_y = (h[j + P] - h[j - P]) * k.cy;
        du = -uc * u_x - vc * u_y - k.g * h_x + k.f * vc;
        dv = -uc * v_x - vc * v_y - k.g * h_y - k.f * uc;
        dh = -hc * (u_x + v_y) - uc * h_x - vc * h_y;
    }
    if (k.visc) {
        du = du + (u[j + 1] + u[j - 1] - 2.0f * uc) * k.ix2
                + (u[j + P] + u[j - P] - 2.0f * uc) * k.iy2;
        dv = dv + (v[j + 1] + v[j - 1] - 2.0f * vc) * k.ix2
                + (v[j + P] + v[j - P] - 2.0f * vc) * k.iy2;
    }
}

// RK4 stage S (0 <= S < 4N; stage S % 4 of step S / 4) over the centred
// R x R region of the tile. The last stage of the last step stores to the
// output view; the last stage of an earlier step writes the step's result
// over s in shared memory.
template <int N, bool kBf16, int S>
__device__ __forceinline__ void stage(
    float* su, float* sv, float* sh, float* cu, float* cv, float* ch,
    float* au, float* av, float* ah, const Consts& k, const OutView& o,
    int ny, int nx) {
    using T = Tile<N>;
    constexpr int Q = S % 4;            // stage within its step
    constexpr bool kLast = S == 4 * N - 1;
    constexpr int O = S + 1;            // region offset inside the tile
    constexpr int R = T::PX - 2 * O;    // N = 1: 38, 36, 34, 32
    constexpr int NP = (R * R + NT - 1) / NT;
    const float* iu = Q == 0 ? su : cu;  // stage input: s, then s1, s2, s3
    const float* iv = Q == 0 ? sv : cv;
    const float* ih = Q == 0 ? sh : ch;
    float nu_[NP], nv_[NP], nh_[NP];

#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const int i = threadIdx.x + p * NT;
        if (i >= R * R) continue;       // last round: fewer points than threads
        const int r = i / R + O, c = i % R + O;
        const int j = r * T::PX + c;
        float du, dv, dh;
        tendency<T::PX, kBf16>(iu, iv, ih, j, k, du, dv, dh);
        if (Q == 0) {                   // s1; acc = -s + s1
            const float s_u = su[j], s_v = sv[j], s_h = sh[j];
            nu_[p] = s_u + k.half * du;
            nv_[p] = s_v + k.half * dv;
            nh_[p] = s_h + k.half * dh;
            au[j] = nu_[p] - s_u;
            av[j] = nv_[p] - s_v;
            ah[j] = nh_[p] - s_h;
        } else if (Q == 1) {            // s2; acc += 2 s2
            nu_[p] = su[j] + k.half * du;
            nv_[p] = sv[j] + k.half * dv;
            nh_[p] = sh[j] + k.half * dh;
            au[j] = au[j] + 2.0f * nu_[p];
            av[j] = av[j] + 2.0f * nv_[p];
            ah[j] = ah[j] + 2.0f * nh_[p];
        } else if (Q == 2) {            // s3; acc += s3
            nu_[p] = su[j] + k.dt * du;
            nv_[p] = sv[j] + k.dt * dv;
            nh_[p] = sh[j] + k.dt * dh;
            au[j] = au[j] + nu_[p];
            av[j] = av[j] + nv_[p];
            ah[j] = ah[j] + nh_[p];
        } else if (!kLast) {            // s' = acc/3 + dt/6 T(s3), kept
            nu_[p] = au[j] * k.third + k.sixth * du;
            nv_[p] = av[j] * k.third + k.sixth * dv;
            nh_[p] = ah[j] * k.third + k.sixth * dh;
        } else {                        // s' = acc/3 + dt/6 T(s3), stored
            const int gy = blockIdx.y * TY + (r - T::H);
            const int gx = blockIdx.x * TX + (c - T::H);
            if (gy < ny && gx < nx) {
                const size_t g = static_cast<size_t>(o.oy + gy) * o.pitch
                                 + (o.ox + gx);
                o.u[g] = au[j] * k.third + k.sixth * du;
                o.v[g] = av[j] * k.third + k.sixth * dv;
                o.h[g] = ah[j] * k.third + k.sixth * dh;
            }
        }
    }
    if constexpr (!kLast) {
        float* wu = Q == 3 ? su : cu;   // a step's result becomes its s
        float* wv = Q == 3 ? sv : cv;
        float* wh = Q == 3 ? sh : ch;
        if (S > 0) __syncthreads();     // every read of the old values done
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            const int i = threadIdx.x + p * NT;
            if (i >= R * R) continue;
            const int j = (i / R + O) * T::PX + (i % R + O);
            wu[j] = nu_[p];
            wv[j] = nv_[p];
            wh[j] = nh_[p];
        }
        __syncthreads();                // the new values are visible
    }
}

// Index of the loaded row (column) i, -H <= i < extent rounded up to the
// tile + H, inside the interior's frame.
template <bool kHalo, int H>
__device__ __forceinline__ int load_index(int i, int n) {
    if constexpr (kHalo) {
        return i < n + H ? i : n + H - 1;
    } else {
        return wrap(i, n);
    }
}

template <int N, bool kBf16, bool kHaloY, bool kHaloX>
__global__ void __launch_bounds__(NT) swe_rk4_kernel(
    View in, OutView out, int ny, int nx, Consts k) {
    using T = Tile<N>;
    extern __shared__ float smem[];
    float* su = smem;
    float* sv = su + T::SIZE;
    float* sh = sv + T::SIZE;
    float* cu = sh + T::SIZE;
    float* cv = cu + T::SIZE;
    float* ch = cv + T::SIZE;
    float* au = ch + T::SIZE;
    float* av = au + T::SIZE;
    float* ah = av + T::SIZE;

    const int y0 = blockIdx.y * TY - T::H;
    const int x0 = blockIdx.x * TX - T::H;
    for (int i = threadIdx.x; i < T::SIZE; i += NT) {
        const int r = i / T::PX, c = i % T::PX;
        const size_t g =
            static_cast<size_t>(in.oy + load_index<kHaloY, T::H>(y0 + r, ny))
                * in.pitch
            + (in.ox + load_index<kHaloX, T::H>(x0 + c, nx));
        su[i] = __ldg(in.u + g);
        sv[i] = __ldg(in.v + g);
        sh[i] = __ldg(in.h + g);
    }
    __syncthreads();

    stage<N, kBf16, 0>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    stage<N, kBf16, 1>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    stage<N, kBf16, 2>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    stage<N, kBf16, 3>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    if constexpr (N == 2) {
        stage<N, kBf16, 4>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
        stage<N, kBf16, 5>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
        stage<N, kBf16, 6>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
        stage<N, kBf16, 7>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    }
}

template <int N, bool kBf16, bool kHaloY, bool kHaloX>
int launch(const View& in, const OutView& out, int ny, int nx,
           const Consts& k, cudaStream_t stream) {
    constexpr int smem = Tile<N>::SMEM_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        swe_rk4_kernel<N, kBf16, kHaloY, kHaloX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
    swe_rk4_kernel<N, kBf16, kHaloY, kHaloX><<<grid, NT, smem, stream>>>(
        in, out, ny, nx, k);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch n_steps (1 or 2) fused RK4 steps of the (ny, nx) interior on
// `stream`. u, v, h: the input block's base pointers (row pitch in_pitch,
// interior origin (in_oy, in_ox)); uo, vo, ho: the output's (out_pitch,
// (out_oy, out_ox)). halo_y, halo_x: 1 where the block holds HALO rows
// (columns) of neighbour data around the interior, 0 where that axis
// wraps; a halo in x needs one in y. bf16: 1 for the bf16 tendency
// (bcx, bcy its bf16 constants). The bf16 tendency and n_steps = 2 take
// the whole periodic domain only (halo_y = halo_x = 0), and not together.
// Outputs must not alias inputs. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int swe_rk4_launch(
    const float* u, const float* v, const float* h, long long in_pitch,
    int in_oy, int in_ox, float* uo, float* vo, float* ho,
    long long out_pitch, int out_oy, int out_ox, int ny, int nx,
    int halo_y, int halo_x, float cx, float cy, float g, float f,
    float half, float dt, float sixth, float third, float ix2, float iy2,
    int visc, int n_steps, int bf16, float bcx, float bcy, void* stream) {
    const View in{u, v, h, in_pitch, in_oy, in_ox};
    const OutView out{uo, vo, ho, out_pitch, out_oy, out_ox};
    const Consts k{cx, cy, g, f, half, dt, sixth, third, ix2, iy2, bcx, bcy,
                   visc};
    const auto s = static_cast<cudaStream_t>(stream);
    const bool whole = !halo_y && !halo_x;
    if (n_steps == 2 && whole && !bf16)
        return launch<2, false, false, false>(in, out, ny, nx, k, s);
    if (n_steps != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (bf16) {
        if (!whole) return static_cast<int>(cudaErrorInvalidValue);
        return launch<1, true, false, false>(in, out, ny, nx, k, s);
    }
    if (whole) return launch<1, false, false, false>(in, out, ny, nx, k, s);
    if (halo_y && !halo_x) return launch<1, false, true, false>(in, out, ny, nx, k, s);
    if (halo_y && halo_x) return launch<1, false, true, true>(in, out, ny, nx, k, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* swe_rk4_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
