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
//   wrap  the interior is the whole periodic extent: neighbour indices wrap
//         around ny (nx); the whole-domain step, and x of a 1-D (row)
//         decomposition;
//   halo  the block holds at least HALO = 4 rows (columns) of neighbour
//         data on each side of the interior, exchanged by the caller; the
//         kernel reads them in place of the wrap.
// The output is a view too (pointer, pitch, origin), so the _local forms
// write a (ny, nx) array and the _carry forms the interior of the next
// padded block. Wrap or halo is a template parameter. The bf16 tendency and
// the two-step form take the whole periodic domain only (the JAX package
// has no padded launcher for them).
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
// Design against that bound. Each block owns a TX x TY output tile and
// its (TX + 8N) x (TY + 8N) region: 4N halo points per side, one per
// chained stage, recomputed instead of exchanged (the valid part of the
// region shrinks by one point per side per stage). What limits such a
// kernel on this card is the issue of instructions, shared-memory accesses
// among them, not the bytes (PERF.md: the stages alone take three
// quarters of its time), so the work is laid out to keep values in
// registers and the code free of branches:
//   * Each thread owns one column of the region and a run of R rows of it
//     for all 4N stages. Its s, its RK4 accumulator and its points' current
//     stage state live in registers; walking down its run, the rows above
//     and below a point come from registers. Only the x-neighbours, the two
//     rows just outside the run and a stage's new state pass through shared
//     memory: 9 + 6/R shared accesses per point and stage.
//   * Every stage computes every point of the region, branch-free: the
//     points outside its valid part hold values no output depends on.
//     Skipping them cost more in branches and divergence than it saved.
//   * Shared memory holds four (u, v, h) region buffers: two for s (this
//     tile's and the next one's, loading) and two stage states in turn, so
//     a stage needs one barrier (it writes the buffer the stage before it
//     did not read).
//   * The grid is persistent: each block walks tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ... and, as it starts a tile, starts copying
//     the next tile's region in with cp.async, in flight while all 4N
//     stages of this one run. An interior tile comes in as 16-byte copies
//     of whole rows; only a tile whose columns wrap (or reach past the
//     halo) takes 4-byte copies with a wrapped index. Index wrapping is a
//     compare-and-add, never a runtime %.
//   * The layout (TX, TY, R, blocks per SM) is one per form: Step1 for K1
//     in every form (float32, bf16, padded), Step2 for K2 (below, mirrored
//     by njw_tpu_torch.ops.stencil.swe_layout), the fastest the H100 timed
//     at 2048^2 (PERF.md).
// The combine is the TPU kernel's accumulator form, which keeps only
// {s, current stage, accumulator} live:
//   s1 = s + dt/2 T(s);   acc = s1 - s
//   s2 = s + dt/2 T(s1);  acc += 2 s2
//   s3 = s + dt T(s2);    acc += s3
//   s' = acc/3 + dt/6 T(s3)
// With N = 2 the first step's s' becomes s and the second step's first
// state. Both steps run the same tendency() and combine() code as K1, so
// the same expressions get the same contractions: K2 with N = 2 equals two
// K1 launches (float32, no viscosity) bit for bit, and every form
// computes each point by the same expressions. The viscosity stays a
// runtime branch (k.visc): as a template parameter it let nvcc contract
// the float32 arithmetic otherwise, which moved the bf16 kernel's distance
// from its plain version past chip_smoke.py's gate.
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
// buffers and every stage state stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int HALO = 4;                // one point per chained stencil stage
constexpr int SMEM_MAX = 232448;       // the most a block may opt in to
constexpr int MAX_DEVICES = 64;

// A block layout: output tile TX x TY, R rows of the region per thread,
// at least MINB blocks resident per SM (the register cap of
// __launch_bounds__).
template <int TX_, int TY_, int R_, int MINB_>
struct Layout {
    static constexpr int TX = TX_, TY = TY_, R = R_, MINB = MINB_;
};

// Region geometry of N fused steps in layout Lay.
template <int N, class Lay>
struct Geo {
    static constexpr int H = HALO * N;
    static constexpr int PX = Lay::TX + 2 * H;   // region width: its pitch
    static constexpr int PY = Lay::TY + 2 * H;
    static constexpr int R = Lay::R;
    static constexpr int NT = PX * (PY / R);   // one thread per column run
    static constexpr int PLANE = PX * PY;
    static constexpr int BUF = 3 * PLANE;        // one (u, v, h) state
    static constexpr int SMEM_BYTES = 4 * BUF * static_cast<int>(sizeof(float));
    static_assert(PX % 32 == 0, "a warp's lanes share a run: PX % 32 == 0");
    static_assert(PY % R == 0, "whole runs");
    static_assert(NT <= 1024, "threads per block");
    static_assert(Lay::TX % 4 == 0, "16-byte rows");
    static_assert(SMEM_BYTES <= SMEM_MAX, "shared memory");
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
    int stages;       // 4N: the step; fewer run only the first stages and
                      // store nothing, 0 only the loads (for profiling)
};

// A point's value and its four neighbours in one field.
struct Pt {
    float c, e, w, n, s;   // centre, x + 1, x - 1, y + 1, y - 1
};

__device__ __forceinline__ __nv_bfloat16 bf(float x) {
    return __float2bfloat16_rn(x);
}

// bf16 central difference (a - b) * c, each operation rounded.
__device__ __forceinline__ __nv_bfloat16 bdiff(float a, float b,
                                               __nv_bfloat16 c) {
    return __hmul_rn(__hsub_rn(bf(a), bf(b)), c);
}

// Tendency of (u, v, h) at a point.
template <bool kBf16>
__device__ __forceinline__ void tendency(const Pt& u, const Pt& v,
                                         const Pt& h, const Consts& k,
                                         float& du, float& dv, float& dh) {
    const float uc = u.c, vc = v.c, hc = h.c;
    if constexpr (kBf16) {
        const __nv_bfloat16 bcx = bf(k.bcx), bcy = bf(k.bcy);
        const __nv_bfloat16 ub = bf(uc), vb = bf(vc), hb = bf(hc);
        const __nv_bfloat16 u_x = bdiff(u.e, u.w, bcx);
        const __nv_bfloat16 u_y = bdiff(u.n, u.s, bcy);
        const __nv_bfloat16 v_x = bdiff(v.e, v.w, bcx);
        const __nv_bfloat16 v_y = bdiff(v.n, v.s, bcy);
        const __nv_bfloat16 h_x = bdiff(h.e, h.w, bcx);
        const __nv_bfloat16 h_y = bdiff(h.n, h.s, bcy);
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
        const float u_x = (u.e - u.w) * k.cx;
        const float u_y = (u.n - u.s) * k.cy;
        const float v_x = (v.e - v.w) * k.cx;
        const float v_y = (v.n - v.s) * k.cy;
        const float h_x = (h.e - h.w) * k.cx;
        const float h_y = (h.n - h.s) * k.cy;
        du = -uc * u_x - vc * u_y - k.g * h_x + k.f * vc;
        dv = -uc * v_x - vc * v_y - k.g * h_y - k.f * uc;
        dh = -hc * (u_x + v_y) - uc * h_x - vc * h_y;
    }
    if (k.visc) {
        du = du + (u.e + u.w - 2.0f * uc) * k.ix2
                + (u.n + u.s - 2.0f * uc) * k.iy2;
        dv = dv + (v.e + v.w - 2.0f * vc) * k.ix2
                + (v.n + v.s - 2.0f * vc) * k.iy2;
    }
}

// The values a thread keeps for the R points of its run: s, the RK4
// accumulator and the current stage state, each (u, v, h).
template <int R>
struct Own {
    float su[R], sv[R], sh[R];
    float au[R], av[R], ah[R];
    float cu[R], cv[R], ch[R];
};

// The 5-point values of one field at row i of a run: the centre and the
// rows above and below from the run's registers (south, the row below's
// value before this stage overwrote it; north_edge, the row past the run's
// end, from shared memory), the x-neighbours (columns ce, cw) from the
// stage's input row `row` in shared memory.
template <int R>
__device__ __forceinline__ Pt point(const float (&x)[R], int i, float south,
                                    float north_edge, const float* row,
                                    int ce, int cw) {
    return Pt{x[i], row[ce], row[cw], i + 1 < R ? x[i + 1] : north_edge,
              south};
}

// Stage S's new value at one point from its s, accumulator and tendency
// (stage S % 4 of step S / 4); the accumulator is updated in place.
// Returns the step's result at the last stage of a step.
template <int Q>
__device__ __forceinline__ float combine(float s, float& acc, float d,
                                         const Consts& k) {
    if constexpr (Q == 0) {            // s1; acc = -s + s1
        const float n = s + k.half * d;
        acc = n - s;
        return n;
    } else if constexpr (Q == 1) {     // s2; acc += 2 s2
        const float n = s + k.half * d;
        acc = acc + 2.0f * n;
        return n;
    } else if constexpr (Q == 2) {     // s3; acc += s3
        const float n = s + k.dt * d;
        acc = acc + n;
        return n;
    } else {                           // s' = acc/3 + dt/6 T(s3)
        return acc * k.third + k.sixth * d;
    }
}

// RK4 stage S (0 <= S < 4N) of the thread's run: rows r0 .. r0 + R - 1 of
// column c of the region, reading the stage's input state `in` (shared,
// three planes) and writing its new state to `outb`; the last stage of the
// last step stores to the output view instead, the last stage of an
// earlier step also makes the result the next step's s. Every point of the
// run is computed, branch-free: only those in the valid region [S + 1,
// P - S - 1) in each axis hold values an output depends on, and neighbour
// indices are clamped to the region, so the others never read outside the
// buffers.
template <int N, bool kBf16, class Lay, int S>
__device__ __forceinline__ void stage(Own<Lay::R>& m, const float* in,
                                      float* outb, int c, int r0,
                                      const Consts& k, const OutView& o,
                                      int gy0, int gx0, int ny, int nx) {
    using G = Geo<N, Lay>;
    constexpr int R = G::R, PX = G::PX, PY = G::PY, PL = G::PLANE;
    constexpr int H = G::H;
    constexpr int Q = S % 4;
    constexpr bool kLast = S == 4 * N - 1;
    const int ce = c < PX - 1 ? c + 1 : c, cw = c > 0 ? c - 1 : c;
    // the rows just outside the run (rows r0 - 1 and r0 + R)
    const int jb = (r0 > 0 ? r0 - 1 : r0) * PX + c;
    const int jt = (r0 + R < PY ? r0 + R : PY - 1) * PX + c;
    float bu = in[jb], bv = in[PL + jb], bh = in[2 * PL + jb];
    const float tu = in[jt], tv = in[PL + jt], th = in[2 * PL + jt];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int r = r0 + i;
        const float* row = in + r * PX;
        const Pt U = point(m.cu, i, bu, tu, row, ce, cw);
        const Pt V = point(m.cv, i, bv, tv, row + PL, ce, cw);
        const Pt W = point(m.ch, i, bh, th, row + 2 * PL, ce, cw);
        bu = U.c;                       // this row, as the next one's south
        bv = V.c;
        bh = W.c;
        float du, dv, dh;
        tendency<kBf16>(U, V, W, k, du, dv, dh);
        const float nu = combine<Q>(m.su[i], m.au[i], du, k);
        const float nv = combine<Q>(m.sv[i], m.av[i], dv, k);
        const float nh = combine<Q>(m.sh[i], m.ah[i], dh, k);
        if constexpr (kLast) {          // the output tile: [H, P - H)
            const int gy = gy0 + r, gx = gx0 + c;
            const bool in_tile = r >= H && r < PY - H && c >= H
                                 && c < PX - H;
            if (in_tile && gy < ny && gx < nx) {
                const size_t g = static_cast<size_t>(o.oy + gy) * o.pitch
                                 + (o.ox + gx);
                o.u[g] = nu;
                o.v[g] = nv;
                o.h[g] = nh;
            }
        } else {
            if constexpr (Q == 3) {     // the next step's s
                m.su[i] = nu;
                m.sv[i] = nv;
                m.sh[i] = nh;
            }
            m.cu[i] = nu;
            m.cv[i] = nv;
            m.ch[i] = nh;
            const int j = r * PX + c;
            outb[j] = nu;
            outb[PL + j] = nv;
            outb[2 * PL + j] = nh;
        }
    }
}

// Stages S .. 4N - 1, or up to k.stages. Stage S >= 1 reads the buffer
// stage S - 1 wrote (a at odd S, b at even S) and writes the other one.
template <int N, bool kBf16, class Lay, int S>
__device__ __forceinline__ void stages_from(Own<Lay::R>& m, float* a,
                                            float* b, int c, int r0,
                                            const Consts& k, const OutView& o,
                                            int gy0, int gx0, int ny,
                                            int nx) {
    if constexpr (S < 4 * N) {
        if (S >= k.stages) return;
        constexpr bool kOdd = S % 2 == 1;
        stage<N, kBf16, Lay, S>(m, kOdd ? a : b, kOdd ? b : a, c, r0, k, o,
                                gy0, gx0, ny, nx);
        if constexpr (S < 4 * N - 1) __syncthreads();
        stages_from<N, kBf16, Lay, S + 1>(m, a, b, c, r0, k, o, gy0, gx0,
                                          ny, nx);
    }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

// Index of the loaded row (column) i, -H <= i < extent rounded up to the
// tile + H, inside the interior's frame: clamped to the last halo row on a
// halo axis, wrapped by compare-and-add on a wrap axis (more than once
// only on a grid narrower than the region).
template <bool kHalo, int H>
__device__ __forceinline__ int load_index(int i, int n) {
    if constexpr (kHalo) {
        return i < n + H ? i : n + H - 1;
    } else {
        while (i < 0) i += n;
        while (i >= n) i -= n;
        return i;
    }
}

// Start copying tile t's region of s into dst (three planes) and commit
// the copies as one group. `vec`: the three fields' rows are 16-byte
// aligned at the interior's column 0 (pointers, pitch and origin).
template <int N, bool kHaloY, bool kHaloX, class Lay>
__device__ __forceinline__ void load_region(float* dst, const View& in,
                                            int t, int tiles_x, int ny,
                                            int nx, bool vec) {
    using G = Geo<N, Lay>;
    constexpr int PX = G::PX, PL = G::PLANE, H = G::H;
    const int by = t / tiles_x, bx = t - by * tiles_x;
    const int y0 = by * Lay::TY - H, x0 = bx * Lay::TX - H;
    const bool rows_whole = kHaloX ? x0 + PX <= nx + H
                                   : x0 >= 0 && x0 + PX <= nx;
    if (vec && rows_whole) {
        constexpr int CH = PX / 4;      // 16-byte chunks per region row
        for (int i = threadIdx.x; i < G::PY * CH; i += G::NT) {
            const int r = i / CH, q = i - r * CH;
            const long long g =
                static_cast<long long>(in.oy + load_index<kHaloY, H>(y0 + r, ny))
                    * in.pitch + in.ox + x0 + 4 * q;
            const int d = r * PX + 4 * q;
            cp_async16(dst + d, in.u + g);
            cp_async16(dst + PL + d, in.v + g);
            cp_async16(dst + 2 * PL + d, in.h + g);
        }
    } else {
        for (int i = threadIdx.x; i < PL; i += G::NT) {
            const int r = i / PX, cc = i - r * PX;
            const long long g =
                static_cast<long long>(in.oy + load_index<kHaloY, H>(y0 + r, ny))
                    * in.pitch + in.ox + load_index<kHaloX, H>(x0 + cc, nx);
            cp_async4(dst + i, in.u + g);
            cp_async4(dst + PL + i, in.v + g);
            cp_async4(dst + 2 * PL + i, in.h + g);
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N, bool kBf16, bool kHaloY, bool kHaloX, class Lay>
__global__ void __launch_bounds__(Geo<N, Lay>::NT, Lay::MINB)
swe_rk4_kernel(View in, OutView out, int ny, int nx, int tiles_x,
               int ntiles, int vec, Consts k) {
    using G = Geo<N, Lay>;
    constexpr int R = G::R, PX = G::PX, PL = G::PLANE;
    extern __shared__ __align__(16) float smem[];
    float* lbuf = smem;                    // the loaded region of s
    float* nbuf = smem + G::BUF;           // the next tile's, loading
    float* const abuf = smem + 2 * G::BUF; // stage states, in turn
    float* const bbuf = smem + 3 * G::BUF;

    const int c = threadIdx.x % PX;
    const int r0 = threadIdx.x / PX * R;
    int t = blockIdx.x;
    if (t < ntiles) {
        load_region<N, kHaloY, kHaloX, Lay>(lbuf, in, t, tiles_x, ny, nx,
                                            vec);
    }
    for (; t < ntiles; t += gridDim.x) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();                // s is in; the last tile is done
        const int next = t + gridDim.x;
        const bool fetch = next < ntiles;
        if (fetch) {                    // in flight through all 4N stages
            load_region<N, kHaloY, kHaloX, Lay>(nbuf, in, next, tiles_x, ny,
                                                nx, vec);
        }
        if (k.stages == 0) {
            if (fetch) {
                float* const tmp = lbuf;
                lbuf = nbuf;
                nbuf = tmp;
            }
            continue;
        }
        const int by = t / tiles_x, bx = t - by * tiles_x;
        const int gy0 = by * Lay::TY - G::H, gx0 = bx * Lay::TX - G::H;
        Own<R> m;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int j = (r0 + i) * PX + c;
            m.su[i] = m.cu[i] = lbuf[j];
            m.sv[i] = m.cv[i] = lbuf[PL + j];
            m.sh[i] = m.ch[i] = lbuf[2 * PL + j];
        }
        stage<N, kBf16, Lay, 0>(m, lbuf, abuf, c, r0, k, out, gy0, gx0, ny,
                                nx);
        __syncthreads();                // s1 is in
        stages_from<N, kBf16, Lay, 1>(m, abuf, bbuf, c, r0, k, out, gy0,
                                      gx0, ny, nx);
        if (fetch) {                    // the next tile's region is s
            float* const tmp = lbuf;
            lbuf = nbuf;
            nbuf = tmp;
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- layouts

// The layout of each form (njw_tpu_torch.ops.stencil.swe_layout mirrors
// them): K1 in every form, and K2.
using Step1 = Layout<56, 56, 8, 1>;
using Step2 = Layout<48, 48, 8, 1>;

// Persistent blocks of one instantiation on the current device: resident
// blocks per SM x SMs, found once per device (the shared-memory opt-in is
// set with it).
template <class F>
int persistent_blocks(F kernel, int nt, int smem, int* cache) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (dev < MAX_DEVICES && cache[dev] > 0) return cache[dev];
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, nt,
                                                        smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
    if (dev < MAX_DEVICES) cache[dev] = per_sm * sms;
    return per_sm * sms;
}

template <int N, bool kBf16, bool kHaloY, bool kHaloX, class Lay>
int launch(const View& in, const OutView& out, int ny, int nx,
           const Consts& k, cudaStream_t stream) {
    using G = Geo<N, Lay>;
    static int cache[MAX_DEVICES] = {};
    auto kernel = swe_rk4_kernel<N, kBf16, kHaloY, kHaloX, Lay>;
    const int blocks = persistent_blocks(kernel, G::NT, G::SMEM_BYTES, cache);
    if (blocks < 0) return -blocks;
    const int tiles_x = (nx + Lay::TX - 1) / Lay::TX;
    const int ntiles = tiles_x * ((ny + Lay::TY - 1) / Lay::TY);
    const auto addr = [](const float* p) {
        return reinterpret_cast<std::uintptr_t>(p);
    };
    const int vec = (addr(in.u) | addr(in.v) | addr(in.h)) % 16 == 0
                    && in.pitch % 4 == 0 && in.ox % 4 == 0;
    kernel<<<ntiles < blocks ? ntiles : blocks, G::NT, G::SMEM_BYTES,
             stream>>>(in, out, ny, nx, tiles_x, ntiles, vec, k);
    return static_cast<int>(cudaGetLastError());
}

// The instantiation's attributes on the current device into out[6]:
// registers per thread, local (spill) bytes per thread, dynamic shared
// bytes, threads per block, resident blocks per SM, static shared bytes.
template <int N, bool kBf16, bool kHaloY, bool kHaloX, class Lay>
int attributes(int* out) {
    using G = Geo<N, Lay>;
    auto kernel = swe_rk4_kernel<N, kBf16, kHaloY, kHaloX, Lay>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        G::NT, G::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = G::SMEM_BYTES;
    out[3] = G::NT;
    out[4] = per_sm;
    out[5] = static_cast<int>(a.sharedSizeBytes);
    return 0;
}

// Run f.run<N, kBf16, kHaloY, kHaloX, Lay>() for a form (N, bf16, halo)
// and its layout; cudaErrorInvalidValue for a form that is not built.
template <class F>
int with_form(int n_steps, int bf16, int halo_y, int halo_x, const F& f) {
    const bool whole = !halo_y && !halo_x;
    if (n_steps == 2 && whole && !bf16) {
        return f.template run<2, false, false, false, Step2>();
    }
    if (n_steps != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (bf16) {
        if (!whole) return static_cast<int>(cudaErrorInvalidValue);
        return f.template run<1, true, false, false, Step1>();
    }
    if (whole) return f.template run<1, false, false, false, Step1>();
    if (!halo_y) return static_cast<int>(cudaErrorInvalidValue);
    if (halo_x) return f.template run<1, false, true, true, Step1>();
    return f.template run<1, false, true, false, Step1>();
}

struct Launcher {
    View in;
    OutView out;
    int ny, nx;
    Consts k;
    cudaStream_t stream;
    template <int N, bool kBf16, bool kHaloY, bool kHaloX, class L>
    int run() const {
        return launch<N, kBf16, kHaloY, kHaloX, L>(in, out, ny, nx, k,
                                                   stream);
    }
};

struct AttributeQuery {
    int* out;
    template <int N, bool kBf16, bool kHaloY, bool kHaloX, class L>
    int run() const {
        return attributes<N, kBf16, kHaloY, kHaloX, L>(out);
    }
};

}  // namespace

// Launch n_steps (1 or 2) fused RK4 steps of the (ny, nx) interior on
// `stream`. u, v, h: the input block's base pointers (row pitch in_pitch,
// interior origin (in_oy, in_ox)); uo, vo, ho: the output's (out_pitch,
// (out_oy, out_ox)). halo_y, halo_x: 1 where the block holds HALO rows
// (columns) of neighbour data around the interior, 0 where that axis
// wraps; a halo in x needs one in y. bf16: 1 for the bf16 tendency
// (bcx, bcy its bf16 constants). The bf16 tendency and n_steps = 2 take
// the whole periodic domain only (halo_y = halo_x = 0), and not together.
// stages: 4 n_steps (the step); fewer run only the first stages and write
// nothing, 0 only the region loads (scripts/profile_torch.py times the
// parts so). Outputs must not alias inputs. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int swe_rk4_launch(
    const float* u, const float* v, const float* h, long long in_pitch,
    int in_oy, int in_ox, float* uo, float* vo, float* ho,
    long long out_pitch, int out_oy, int out_ox, int ny, int nx,
    int halo_y, int halo_x, float cx, float cy, float g, float f,
    float half, float dt, float sixth, float third, float ix2, float iy2,
    int visc, int n_steps, int bf16, float bcx, float bcy, int stages,
    void* stream) {
    if (ny < 1 || nx < 1 || stages < 0 || stages > 4 * n_steps) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const View in{u, v, h, in_pitch, in_oy, in_ox};
    const OutView out{uo, vo, ho, out_pitch, out_oy, out_ox};
    const Consts k{cx, cy, g, f, half, dt, sixth, third, ix2, iy2, bcx, bcy,
                   visc, stages};
    return with_form(n_steps, bf16, halo_y, halo_x,
                     Launcher{in, out, ny, nx, k,
                              static_cast<cudaStream_t>(stream)});
}

// The attributes of a form's built instantiation on the current device
// (see attributes() above: registers, spill bytes, shared bytes, threads,
// blocks per SM, static shared bytes) into out[6]. Returns the CUDA error
// code; cudaErrorInvalidValue for a form that is not built.
extern "C" int swe_rk4_attributes(int n_steps, int bf16, int halo_y,
                                  int halo_x, int* out) {
    return with_form(n_steps, bf16, halo_y, halo_x, AttributeQuery{out});
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* swe_rk4_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
