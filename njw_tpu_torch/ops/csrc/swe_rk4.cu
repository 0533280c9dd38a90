// Fused RK4 step of the periodic shallow-water equations, for sm_90a.
//
// Replaces the TPU kernel swe_rk4_kernel (njw_tpu/ops/stencil.py:60) for
// all its float32 launchers: swe_rk4_step_pallas (:245, the whole periodic
// domain) and the sharded ones on a halo-padded block,
// swe_rk4_step_pallas_local (:359), _carry (:416) and _local2d (:471). One
// whole RK4 step for float32 (ny, nx) fields u, v, h in a single pass over
// device memory.
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
// instantiation is the code it was before the sharded forms.
//
// Bound on this card: memory. The step must read u, v, h once and write
// them once, 24 B/point: 100.7 MB at 2048^2, about 30 us at the H100 SXM's
// 3.35 TB/s. The arithmetic is about 156 flop/point (4 stages of ~33 plus
// the combines), 0.65 GFLOP at 2048^2, about 10 us at 67 TFLOP/s fp32.
//
// Design against that bound: each block owns a TY x TX output tile and
// loads a (TY+8) x (TX+8) tile of u, v, h (by modular index on a wrap
// axis, so any ny, nx >= 3 works, including grids smaller than the tile;
// from the halo on a halo axis) into shared memory once. The four RK4 stages then run in shared
// memory over a valid region that shrinks by one point per side per stage
// (40^2 -> 38^2 -> 36^2 -> 34^2 -> 32^2): the halo is recomputed instead
// of exchanged, and no stage touches device memory. The combine is the
// TPU kernel's accumulator form, which keeps only {s, current stage,
// accumulator} live: 9 tile buffers, 57,600 B of dynamic shared memory
// (above the 48 KB default, so the launch raises the opt-in limit).
//   s1 = s + dt/2 T(s);   acc = s1 - s
//   s2 = s + dt/2 T(s1);  acc += 2 s2
//   s3 = s + dt T(s2);    acc += s3
//   s' = acc/3 + dt/6 T(s3)
// Ragged edge tiles compute on the periodic extension and mask the store;
// on a halo axis the load index is clamped to the last halo row (column),
// so a ragged tile never reads outside the block: the clamped points feed
// only outputs past the interior, which are masked.
// Making it fast (TMA loads, larger tiles, register blocking) is later
// work; this is the simple, correct first form.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;                 // output tile width (x, contiguous)
constexpr int TY = 32;                 // output tile height
constexpr int HALO = 4;                // one point per chained stencil stage
constexpr int PX = TX + 2 * HALO;      // shared tile pitch: 40
constexpr int PY = TY + 2 * HALO;      // 40
constexpr int TILE = PX * PY;          // points per shared tile buffer
constexpr int NT = 256;                // threads per block
constexpr int SMEM_BYTES = 9 * TILE * static_cast<int>(sizeof(float));

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
    int visc;
};

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

// Tendency of (u, v, h) at shared-tile index j.
__device__ __forceinline__ void tendency(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ h, int j, const Consts& k,
    float& du, float& dv, float& dh) {
    const float uc = u[j], vc = v[j], hc = h[j];
    const float u_x = (u[j + 1] - u[j - 1]) * k.cx;
    const float u_y = (u[j + PX] - u[j - PX]) * k.cy;
    const float v_x = (v[j + 1] - v[j - 1]) * k.cx;
    const float v_y = (v[j + PX] - v[j - PX]) * k.cy;
    const float h_x = (h[j + 1] - h[j - 1]) * k.cx;
    const float h_y = (h[j + PX] - h[j - PX]) * k.cy;
    du = -uc * u_x - vc * u_y - k.g * h_x + k.f * vc;
    dv = -uc * v_x - vc * v_y - k.g * h_y - k.f * uc;
    dh = -hc * (u_x + v_y) - uc * h_x - vc * h_y;
    if (k.visc) {
        du = du + (u[j + 1] + u[j - 1] - 2.0f * uc) * k.ix2
                + (u[j + PX] + u[j - PX] - 2.0f * uc) * k.iy2;
        dv = dv + (v[j + 1] + v[j - 1] - 2.0f * vc) * k.ix2
                + (v[j + PX] + v[j - PX] - 2.0f * vc) * k.iy2;
    }
}

// One RK4 stage S over the centred R x R region of the tile.
template <int S>
__device__ __forceinline__ void stage(
    const float* __restrict__ su, const float* __restrict__ sv,
    const float* __restrict__ sh, float* cu, float* cv, float* ch,
    float* au, float* av, float* ah, const Consts& k, const OutView& o,
    int ny, int nx) {
    constexpr int O = S + 1;            // region offset inside the tile
    constexpr int R = PX - 2 * O;       // 38, 36, 34, 32
    constexpr int NP = (R * R + NT - 1) / NT;
    const float* iu = S == 0 ? su : cu;  // stage input: s, then s1, s2, s3
    const float* iv = S == 0 ? sv : cv;
    const float* ih = S == 0 ? sh : ch;
    float nu_[NP], nv_[NP], nh_[NP];

#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const int i = threadIdx.x + p * NT;
        if (i >= R * R) continue;       // last round: fewer points than threads
        const int r = i / R + O, c = i % R + O;
        const int j = r * PX + c;
        float du, dv, dh;
        tendency(iu, iv, ih, j, k, du, dv, dh);
        const float s_u = su[j], s_v = sv[j], s_h = sh[j];
        if (S == 0) {                   // s1; acc = -s + s1
            nu_[p] = s_u + k.half * du;
            nv_[p] = s_v + k.half * dv;
            nh_[p] = s_h + k.half * dh;
            au[j] = nu_[p] - s_u;
            av[j] = nv_[p] - s_v;
            ah[j] = nh_[p] - s_h;
        } else if (S == 1) {            // s2; acc += 2 s2
            nu_[p] = s_u + k.half * du;
            nv_[p] = s_v + k.half * dv;
            nh_[p] = s_h + k.half * dh;
            au[j] = au[j] + 2.0f * nu_[p];
            av[j] = av[j] + 2.0f * nv_[p];
            ah[j] = ah[j] + 2.0f * nh_[p];
        } else if (S == 2) {            // s3; acc += s3
            nu_[p] = s_u + k.dt * du;
            nv_[p] = s_v + k.dt * dv;
            nh_[p] = s_h + k.dt * dh;
            au[j] = au[j] + nu_[p];
            av[j] = av[j] + nv_[p];
            ah[j] = ah[j] + nh_[p];
        } else {                        // s' = acc/3 + dt/6 T(s3)
            const int gy = blockIdx.y * TY + (r - HALO);
            const int gx = blockIdx.x * TX + (c - HALO);
            if (gy < ny && gx < nx) {
                const size_t g = static_cast<size_t>(o.oy + gy) * o.pitch
                                 + (o.ox + gx);
                o.u[g] = au[j] * k.third + k.sixth * du;
                o.v[g] = av[j] * k.third + k.sixth * dv;
                o.h[g] = ah[j] * k.third + k.sixth * dh;
            }
        }
    }
    if (S < 3) {
        if (S > 0) __syncthreads();     // every read of the old stage done
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            const int i = threadIdx.x + p * NT;
            if (i >= R * R) continue;
            const int j = (i / R + O) * PX + (i % R + O);
            cu[j] = nu_[p];
            cv[j] = nv_[p];
            ch[j] = nh_[p];
        }
        __syncthreads();                // the new stage is visible
    }
}

// Index of the loaded row (column) i, -HALO <= i < extent rounded up to
// the tile + HALO, inside the interior's frame.
template <bool kHalo>
__device__ __forceinline__ int load_index(int i, int n) {
    if constexpr (kHalo) {
        return i < n + HALO ? i : n + HALO - 1;
    } else {
        return wrap(i, n);
    }
}

template <bool kHaloY, bool kHaloX>
__global__ void __launch_bounds__(NT) swe_rk4_kernel(
    View in, OutView out, int ny, int nx, Consts k) {
    extern __shared__ float smem[];
    float* su = smem;
    float* sv = su + TILE;
    float* sh = sv + TILE;
    float* cu = sh + TILE;
    float* cv = cu + TILE;
    float* ch = cv + TILE;
    float* au = ch + TILE;
    float* av = au + TILE;
    float* ah = av + TILE;

    const int y0 = blockIdx.y * TY - HALO;
    const int x0 = blockIdx.x * TX - HALO;
    for (int i = threadIdx.x; i < TILE; i += NT) {
        const int r = i / PX, c = i % PX;
        const size_t g =
            static_cast<size_t>(in.oy + load_index<kHaloY>(y0 + r, ny))
                * in.pitch
            + (in.ox + load_index<kHaloX>(x0 + c, nx));
        su[i] = __ldg(in.u + g);
        sv[i] = __ldg(in.v + g);
        sh[i] = __ldg(in.h + g);
    }
    __syncthreads();

    stage<0>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    stage<1>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    stage<2>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
    stage<3>(su, sv, sh, cu, cv, ch, au, av, ah, k, out, ny, nx);
}

template <bool kHaloY, bool kHaloX>
int launch(const View& in, const OutView& out, int ny, int nx,
           const Consts& k, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        swe_rk4_kernel<kHaloY, kHaloX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
    swe_rk4_kernel<kHaloY, kHaloX><<<grid, NT, SMEM_BYTES, stream>>>(
        in, out, ny, nx, k);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch one fused RK4 step of the (ny, nx) interior on `stream`. u, v, h:
// the input block's base pointers (row pitch in_pitch, interior origin
// (in_oy, in_ox)); uo, vo, ho: the output's (out_pitch, (out_oy,
// out_ox)). halo_y, halo_x: 1 where the block holds HALO rows (columns) of
// neighbour data around the interior, 0 where that axis wraps; a halo in
// x needs one in y. Outputs must not alias inputs. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int swe_rk4_launch(
    const float* u, const float* v, const float* h, long long in_pitch,
    int in_oy, int in_ox, float* uo, float* vo, float* ho,
    long long out_pitch, int out_oy, int out_ox, int ny, int nx,
    int halo_y, int halo_x, float cx, float cy, float g, float f,
    float half, float dt, float sixth, float third, float ix2, float iy2,
    int visc, void* stream) {
    const View in{u, v, h, in_pitch, in_oy, in_ox};
    const OutView out{uo, vo, ho, out_pitch, out_oy, out_ox};
    const Consts k{cx, cy, g, f, half, dt, sixth, third, ix2, iy2, visc};
    const auto s = static_cast<cudaStream_t>(stream);
    if (!halo_y && !halo_x) return launch<false, false>(in, out, ny, nx, k, s);
    if (halo_y && !halo_x) return launch<true, false>(in, out, ny, nx, k, s);
    if (halo_y && halo_x) return launch<true, true>(in, out, ny, nx, k, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* swe_rk4_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
