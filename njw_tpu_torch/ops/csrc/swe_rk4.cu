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
// region shrinks by one point per side per stage). What bounds such a
// kernel on this card is not the bytes but the issue of the stages'
// instructions and the latency of their shared-memory accesses: with one
// column a thread and every stage state passed through shared memory (9 +
// 6/R shared accesses per point and stage, R rows a thread, 16 warps an
// SM), the stages took three quarters of the time (PERF.md). So a stage's
// state stays in registers, and only what crosses a warp goes through
// shared memory:
//   * A warp owns a band of R rows of the region, its whole width, and
//     each lane C = PX / 32 adjacent columns of the band. A thread keeps
//     its R x C points' s, RK4 accumulator and current stage state in
//     registers for all 4N stages. The neighbours inside its columns and
//     rows are registers; the x-neighbours in the lanes beside it are warp
//     shuffles (two a row and field); only the rows just outside the band
//     cross warps, through shared memory as C-float words. Per point and
//     stage that is 6/C shuffles and 12/(R C) shared accesses (3 and 1.5
//     at C = 2, R = 4), and nothing else of a stage state is stored. The
//     shuffles read registers, so the next rows' neighbours are in flight
//     while a row computes.
//   * Every stage computes every point of the region, branch-free: the
//     points outside its valid part hold values no output depends on.
//     Skipping them cost more in branches and divergence than it saved.
//     A lane at the region's side takes its own value for the missing
//     neighbour, a band at its top or bottom another band row: both only
//     feed points outside the valid part.
//   * Shared memory holds two (u, v, h) region buffers, this tile's s and
//     the next one's (loading), and the bands' first and last rows, twice
//     (by stage parity), so a stage needs one barrier: a band writes the
//     next stage's edges into the copy the stage before it did not read.
//   * The grid is persistent: each block walks tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ... and, as it starts a tile, starts copying
//     the next tile's region in with cp.async, in flight while all 4N
//     stages of this one run. An interior tile comes in as 16-byte copies
//     of whole rows; only a tile whose columns wrap (or reach past the
//     halo) takes 4-byte copies with a wrapped index. Index wrapping is a
//     compare-and-add, never a runtime %. The step's result goes out as
//     C-float words where the output view is aligned for them.
//   * The layout (TX, TY, R, C, blocks per SM) is one per form: Step1 for
//     K1 in every form (float32, bf16, padded), Step2 for K2 (below,
//     mirrored by njw_tpu_torch.ops.stencil.swe_layout), the fastest the
//     H100 timed at 2048^2 (PERF.md).
// What bounds this design (scripts/profile_torch.py swe_parts, PERF.md):
// at 2048^2 the stages alone take about 34 us (about 39 issued
// instructions per point and stage, 30 of them the float32 arithmetic
// every point keeps bit for bit), the region loads alone about 32 us, and
// the two overlap for about one stage a tile, so a launch takes about
// 64 us, against 68 for one column a thread. Tried and slower or no
// faster (PERF.md): three region buffers, the copy engine's bulk and 2-D
// tensor copies, a loading warp of its own, loads spread over the stages,
// barriers on an mbarrier, 56 x 24 tiles two blocks an SM, 56 x 40,
// 56 x 60, 56 x 64 and 120 x 24 tiles.
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
#include <cstring>

namespace {

constexpr int HALO = 4;                // one point per chained stencil stage
constexpr int SMEM_MAX = 232448;       // the most a block may opt in to
constexpr int MAX_DEVICES = 64;

// A block layout: output tile TX x TY, R rows of the region per warp's
// band, C columns per lane, at least MINB blocks resident per SM (the
// register cap of __launch_bounds__).
template <int TX_, int TY_, int R_, int C_, int MINB_>
struct Layout {
    static constexpr int TX = TX_, TY = TY_, R = R_, C = C_, MINB = MINB_;
};

// Region geometry of N fused steps in layout Lay.
template <int N, class Lay>
struct Geo {
    static constexpr int H = HALO * N;
    static constexpr int PX = Lay::TX + 2 * H;   // region width: its pitch
    static constexpr int PY = Lay::TY + 2 * H;
    static constexpr int R = Lay::R, C = Lay::C;
    static constexpr int NW = PY / R;            // warps: one a band
    static constexpr int NT = 32 * NW;
    static constexpr int PLANE = PX * PY;
    static constexpr int BUF = 3 * PLANE;        // one (u, v, h) region
    static constexpr int EDGE = 3 * NW * PX;     // one row a band, u, v, h
    // two regions; first and last band rows, for two stage parities
    static constexpr int SMEM_BYTES =
        (2 * BUF + 4 * EDGE) * static_cast<int>(sizeof(float));
    static_assert(PX == 32 * C, "a warp's lanes span the region's width");
    static_assert(C == 1 || C == 2 || C == 4, "a lane's columns: one word");
    static_assert(H % C == 0, "a lane's columns are all in the tile or none");
    static_assert(PY % R == 0, "whole bands");
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

// The values a thread keeps for the R x C points of its band and columns:
// s, the RK4 accumulator and the current stage state, each (u, v, h).
template <int R, int C>
struct Own {
    float su[R][C], sv[R][C], sh[R][C];
    float au[R][C], av[R][C], ah[R][C];
    float cu[R][C], cv[R][C], ch[R][C];
};

// One row of a lane's C columns of u, v and h: the band's neighbour rows.
template <int C>
struct Edge {
    float u[C], v[C], h[C];
};

// C floats from (to) p, one shared or global word (p aligned to C floats).
template <int C>
__device__ __forceinline__ void ldw(float (&x)[C], const float* p) {
    if constexpr (C == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        x[0] = t.x;
        x[1] = t.y;
        x[2] = t.z;
        x[3] = t.w;
    } else if constexpr (C == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        x[0] = t.x;
        x[1] = t.y;
    } else {
        x[0] = *p;
    }
}

template <int C>
__device__ __forceinline__ void stw(float* p, const float (&x)[C]) {
    if constexpr (C == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else if constexpr (C == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
    } else {
        *p = x[0];
    }
}

// Row (i, columns 0 .. C - 1) of (u, v, h) planes `p` (pitch PX, PL floats
// apart), one word a field.
template <int C, int PL>
__device__ __forceinline__ void ld_edge(Edge<C>& e, const float* p) {
    ldw<C>(e.u, p);
    ldw<C>(e.v, p + PL);
    ldw<C>(e.h, p + 2 * PL);
}

// The 5-point values of one field at point (i, j) of a thread's block x
// (the stage's input state): the centre and the neighbours inside the
// block from its registers, the rows past its first and last (s, n) from
// the bands beside it, the columns past its first and last (w, e) from
// the lanes beside it.
template <int R, int C>
__device__ __forceinline__ Pt point(const float (&x)[R][C], int i, int j,
                                    const float (&s)[C], const float (&n)[C],
                                    float w, float e) {
    return Pt{x[i][j], j + 1 < C ? x[i][j + 1] : e, j > 0 ? x[i][j - 1] : w,
              i + 1 < R ? x[i + 1][j] : n[j], i > 0 ? x[i - 1][j] : s[j]};
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

// RK4 stage S (0 <= S < 4N) of the thread's block: rows r0 = w R ..
// r0 + R - 1 (warp w's band) and columns c0 .. c0 + C - 1 of the region,
// from the stage's input state in m.c* and the rows just outside the band
// (sth, nth). Its new state replaces m.c* and its band's first and last
// rows go to `edge` (the next stage's sth and nth); the last stage of the
// last step stores to the output view instead, the last stage of an
// earlier step also makes the result the next step's s. Every point is
// computed, branch-free: only those in the valid region [S + 1,
// P - S - 1) in each axis hold values an output depends on.
template <int N, bool kBf16, class Lay, int S>
__device__ __forceinline__ void stage(Own<Lay::R, Lay::C>& m,
                                      const Edge<Lay::C>& sth,
                                      const Edge<Lay::C>& nth, float* edge,
                                      int w, int c0, const Consts& k,
                                      const OutView& o, int gy0, int gx0,
                                      int ny, int nx, bool vec_out) {
    using G = Geo<N, Lay>;
    constexpr int R = G::R, C = G::C, PX = G::PX, PY = G::PY, H = G::H;
    constexpr int Q = S % 4;
    constexpr bool kLast = S == 4 * N - 1;
    constexpr unsigned kAll = 0xffffffffu;
    float nu[R][C], nv[R][C], nh[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        // the columns just outside the lane's: the neighbour lanes' last
        // and first (a lane at the region's side takes its own)
        const float wu = __shfl_up_sync(kAll, m.cu[i][C - 1], 1);
        const float eu = __shfl_down_sync(kAll, m.cu[i][0], 1);
        const float wv = __shfl_up_sync(kAll, m.cv[i][C - 1], 1);
        const float ev = __shfl_down_sync(kAll, m.cv[i][0], 1);
        const float wh = __shfl_up_sync(kAll, m.ch[i][C - 1], 1);
        const float eh = __shfl_down_sync(kAll, m.ch[i][0], 1);
#pragma unroll
        for (int j = 0; j < C; ++j) {
            const Pt U = point(m.cu, i, j, sth.u, nth.u, wu, eu);
            const Pt V = point(m.cv, i, j, sth.v, nth.v, wv, ev);
            const Pt W = point(m.ch, i, j, sth.h, nth.h, wh, eh);
            float du, dv, dh;
            tendency<kBf16>(U, V, W, k, du, dv, dh);
            nu[i][j] = combine<Q>(m.su[i][j], m.au[i][j], du, k);
            nv[i][j] = combine<Q>(m.sv[i][j], m.av[i][j], dv, k);
            nh[i][j] = combine<Q>(m.sh[i][j], m.ah[i][j], dh, k);
        }
    }
    if constexpr (kLast) {              // the output tile: [H, P - H)
        const int gx = gx0 + c0;
        const bool cols_in = c0 >= H && c0 < PX - H;
#pragma unroll
        for (int i = 0; i < R; ++i) {
            const int r = w * R + i, gy = gy0 + r;
            if (!(cols_in && r >= H && r < PY - H && gy < ny)) continue;
            const size_t g = static_cast<size_t>(o.oy + gy) * o.pitch
                             + (o.ox + gx);
            if (vec_out && gx + C <= nx) {
                stw<C>(o.u + g, nu[i]);
                stw<C>(o.v + g, nv[i]);
                stw<C>(o.h + g, nh[i]);
            } else {
#pragma unroll
                for (int j = 0; j < C; ++j) {
                    if (gx + j < nx) {
                        o.u[g + j] = nu[i][j];
                        o.v[g + j] = nv[i][j];
                        o.h[g + j] = nh[i][j];
                    }
                }
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int j = 0; j < C; ++j) {
                if constexpr (Q == 3) {     // the next step's s
                    m.su[i][j] = nu[i][j];
                    m.sv[i][j] = nv[i][j];
                    m.sh[i][j] = nh[i][j];
                }
                m.cu[i][j] = nu[i][j];
                m.cv[i][j] = nv[i][j];
                m.ch[i][j] = nh[i][j];
            }
        }
        // the band's first row (the band above's nth), its last (the band
        // below's sth)
        constexpr int RW = G::NW * PX;      // one field's rows of a kind
        float* const top = edge + w * PX + c0;
        float* const bot = top + G::EDGE;
        stw<C>(top, nu[0]);
        stw<C>(top + RW, nv[0]);
        stw<C>(top + 2 * RW, nh[0]);
        stw<C>(bot, nu[R - 1]);
        stw<C>(bot + RW, nv[R - 1]);
        stw<C>(bot + 2 * RW, nh[R - 1]);
    }
}

// Stages S .. 4N - 1, or up to k.stages. Stage S writes its band edges
// into copy (S + 1) % 2 of `edges`, which stage S + 1 reads after the
// barrier: a copy is written again only after a barrier that every band
// passes once it has read it.
template <int N, bool kBf16, class Lay, int S>
__device__ __forceinline__ void stages_from(Own<Lay::R, Lay::C>& m,
                                            Edge<Lay::C>& sth,
                                            Edge<Lay::C>& nth, float* edges,
                                            int w, int c0, const Consts& k,
                                            const OutView& o, int gy0,
                                            int gx0, int ny, int nx,
                                            bool vec_out) {
    if constexpr (S < 4 * N) {
        using G = Geo<N, Lay>;
        if (S >= k.stages) return;
        float* const e = edges + ((S + 1) % 2) * 2 * G::EDGE;
        stage<N, kBf16, Lay, S>(m, sth, nth, e, w, c0, k, o, gy0, gx0, ny,
                                nx, vec_out);
        if constexpr (S < 4 * N - 1) {
            __syncthreads();
            constexpr int RW = G::NW * G::PX;
            // the band below's last row, the band above's first (a band at
            // the region's edge takes one of its own)
            const int ws = w > 0 ? w - 1 : w;
            const int wn = w + 1 < G::NW ? w + 1 : w;
            ld_edge<Lay::C, RW>(sth, e + G::EDGE + ws * G::PX + c0);
            ld_edge<Lay::C, RW>(nth, e + wn * G::PX + c0);
            stages_from<N, kBf16, Lay, S + 1>(m, sth, nth, edges, w, c0, k,
                                              o, gy0, gx0, ny, nx, vec_out);
        }
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
               int ntiles, int vec, int vec_out, Consts k) {
    using G = Geo<N, Lay>;
    constexpr int R = G::R, C = G::C, PX = G::PX, PY = G::PY;
    constexpr int PL = G::PLANE;
    extern __shared__ __align__(16) float smem[];
    float* lbuf = smem;                    // the loaded region of s
    float* nbuf = smem + G::BUF;           // the next tile's, loading
    float* const edges = smem + 2 * G::BUF;

    const int w = threadIdx.x / 32;        // the band of rows w R ..
    const int c0 = threadIdx.x % 32 * C;   // the lane's first column
    const int r0 = w * R;
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
        if (k.stages > 0) {
            const int by = t / tiles_x, bx = t - by * tiles_x;
            const int gy0 = by * Lay::TY - G::H, gx0 = bx * Lay::TX - G::H;
            Own<R, C> m;
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const float* row = lbuf + (r0 + i) * PX + c0;
                ldw<C>(m.su[i], row);
                ldw<C>(m.sv[i], row + PL);
                ldw<C>(m.sh[i], row + 2 * PL);
#pragma unroll
                for (int j = 0; j < C; ++j) {
                    m.cu[i][j] = m.su[i][j];
                    m.cv[i][j] = m.sv[i][j];
                    m.ch[i][j] = m.sh[i][j];
                }
            }
            // stage 0's rows outside the band: s, clamped to the region
            Edge<C> sth, nth;
            ld_edge<C, PL>(sth, lbuf + (r0 > 0 ? r0 - 1 : r0) * PX + c0);
            ld_edge<C, PL>(nth, lbuf + (r0 + R < PY ? r0 + R : PY - 1) * PX
                                    + c0);
            stages_from<N, kBf16, Lay, 0>(m, sth, nth, edges, w, c0, k, out,
                                          gy0, gx0, ny, nx, vec_out != 0);
        }
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
using Step1 = Layout<56, 56, 4, 2, 1>;
using Step2 = Layout<48, 48, 4, 2, 1>;

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
    const int vec_out = (addr(out.u) | addr(out.v) | addr(out.h))
                                % (4 * Lay::C) == 0
                        && out.pitch % Lay::C == 0 && out.ox % Lay::C == 0;
    kernel<<<ntiles < blocks ? ntiles : blocks, G::NT, G::SMEM_BYTES,
             stream>>>(in, out, ny, nx, tiles_x, ntiles, vec, vec_out, k);
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

// All of a launch but its six field pointers and its stream.
struct Prepared {
    View in;
    OutView out;
    int ny, nx, n_steps, bf16, halo_y, halo_x;
    Consts k;
};

int launch_prepared(Prepared q, const float* u, const float* v,
                    const float* h, float* uo, float* vo, float* ho,
                    void* stream) {
    q.in.u = u;
    q.in.v = v;
    q.in.h = h;
    q.out.u = uo;
    q.out.v = vo;
    q.out.h = ho;
    return with_form(q.n_steps, q.bf16, q.halo_y, q.halo_x,
                     Launcher{q.in, q.out, q.ny, q.nx, q.k,
                              static_cast<cudaStream_t>(stream)});
}

}  // namespace

// Bytes of a prepared launch: the buffer swe_rk4_prepare fills.
extern "C" int swe_rk4_prepared_bytes() {
    return static_cast<int>(sizeof(Prepared));
}

// Check the arguments of a launch of n_steps (1 or 2) fused RK4 steps of
// the (ny, nx) interior, all but its field pointers and its stream, and
// keep them in `dst` (swe_rk4_prepared_bytes() bytes, any alignment) for
// swe_rk4_launch_prepared. The input block has row pitch in_pitch and its
// interior at (in_oy, in_ox); the output's is (out_pitch, (out_oy,
// out_ox)). halo_y, halo_x: 1 where the block holds HALO rows (columns) of
// neighbour data around the interior, 0 where that axis wraps; a halo in
// x needs one in y. bf16: 1 for the bf16 tendency (bcx, bcy its bf16
// constants). The bf16 tendency and n_steps = 2 take the whole periodic
// domain only (halo_y = halo_x = 0), and not together. stages: 4 n_steps
// (the step); fewer run only the first stages and write nothing, 0 only
// the region loads (scripts/profile_torch.py times the parts so). Returns
// 0, or cudaErrorInvalidValue for arguments it refuses.
extern "C" int swe_rk4_prepare(
    void* dst, long long in_pitch, int in_oy, int in_ox,
    long long out_pitch, int out_oy, int out_ox, int ny, int nx,
    int halo_y, int halo_x, float cx, float cy, float g, float f,
    float half, float dt, float sixth, float third, float ix2, float iy2,
    int visc, int n_steps, int bf16, float bcx, float bcy, int stages) {
    if (ny < 1 || nx < 1 || stages < 0 || stages > 4 * n_steps) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Prepared q{
        View{nullptr, nullptr, nullptr, in_pitch, in_oy, in_ox},
        OutView{nullptr, nullptr, nullptr, out_pitch, out_oy, out_ox},
        ny, nx, n_steps, bf16, halo_y, halo_x,
        Consts{cx, cy, g, f, half, dt, sixth, third, ix2, iy2, bcx, bcy,
               visc, stages}};
    std::memcpy(dst, &q, sizeof q);
    return 0;
}

// Launch a prepared call (swe_rk4_prepare) on fields u, v, h (the input
// block's base pointers) into uo, vo, ho (the output's) on `stream`.
// Outputs must not alias inputs. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int swe_rk4_launch_prepared(const void* prepared, const float* u,
                                       const float* v, const float* h,
                                       float* uo, float* vo, float* ho,
                                       void* stream) {
    Prepared q;
    std::memcpy(&q, prepared, sizeof q);
    return launch_prepared(q, u, v, h, uo, vo, ho, stream);
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
