// One whole RK4 step of the periodic primitive equations, sm_90a.
//
// Replaces the TPU kernel _pe_rk4_kernel (njw_tpu/ops/pe_stencil.py:617)
// for all its launchers: pe_rk4_step_pallas (:826, the whole periodic
// domain), the sharded pe_rk4_pallas_local (:935), _carry (:1057) and
// _local2d (:1195) on a halo-padded block, and the 2-D carry kernel K6,
// _pe_rk4_carry2d_kernel (:1376, launched by pe_rk4_pallas_carry2d at
// :1487), which is this kernel on a persistent padded block with its
// output written into the next block's interior. The four stages of
//
//   s1 = s + dt/2 T(s);  s2 = s + dt/2 T(s1);  s3 = s + dt T(s2)
//   s' = (s1 - s + 2 s2 + s3)/3 + dt/6 T(s3)
//
// in one launch, for u, v, T, q of shape (L, ny, nx) and ps of shape
// (ny, nx), float32, with an optional surface geopotential phi_s. The
// accumulator is the Pallas kernel's (_rk4_chain): acc = s1 - s, then
// acc + 2 s2, then acc + s3, then acc/3 + dt/6 T(s3). The arithmetic of
// each column and level is that of pe_column.cuh's walk (the stage
// kernel's), term by term; only the walk is cut up.
//
// Bound on this card. Bytes: s (4L + 1 planes) and phi_s read once, s'
// written once: 2 (4L + 1) x 4 B = 648 B per column at L = 20, 170 MB at
// 512^2, 51 us at the H100 SXM's 3.35 TB/s. Operations: about 4 x 116 flop
// per column and level plus the combine, 2.6 GFLOP at 512^2 x 20 (38 us at
// 67 TFLOP/s fp32) without recompute; with this design's halo recompute
// (1.97x at tile 8, below) 5.1 GFLOP, 77 us: the operations are the floor.
// Device memory per step (reckoned): s's regions come from device memory
// about once (a tile's source region is 4x its own columns at tile 8; the
// re-reads of adjacent tiles' halos, which run together, and of the bases
// of stages 2 and 3 hit L2) and s' is written once: about 170 MB at
// 512^2 x 20, against about 1.8 GB for the earlier design (stage states in
// a per-block scratch in device memory). The L2-to-SM traffic is about
// 0.66 GB.
//
// Design. A cluster of C blocks (C = 1, 2, 4 or 8; a thread-block cluster
// when C > 1) per output tile of T x T columns, one cluster per tile, the
// tiles in row-major order so that neighbours run together. The C blocks
// split the levels: block c holds levels [c L / C, (c + 1) L / C) of u,
// v, T, q and the surface plane ps, lc = ceil(L / C) levels in its
// layout. Everything a tile needs between its stages stays in the
// cluster's shared memory; each block holds, in 4 B words:
//   S     s on the (T+8)^2 source region, 4 lc + 1 planes; after stage 1
//         it holds the auxiliaries of stages 2-4
//   A     s1 on the (T+6)^2 region, then s3 on (T+2)^2
//   B     stage 1's auxiliaries, then s2 on (T+4)^2
//   acc   the RK4 accumulator on the T^2 own columns
//   goff  s's offset of each source-region column (ints); the 2L level
//         constants
// The auxiliaries of a stage are phi (the geopotential of its source
// region, lc planes), cum (the flux divergence of its region summed down
// the column, lc planes) and five per-column planes (d lnps/dx, d lnps/dy,
// 1/ps, dps/ps, dps). The base s of stages 2 and 3 is re-read at each
// column from device memory, where the tile's s sits in L2. Words:
//   (4lc+1) ((T+8)^2 + (T+6)^2 + T^2) + max((4lc+1)(T+4)^2,
//     lc ((T+8)^2 + (T+6)^2) + 5 (T+6)^2) + (T+8)^2 + 2L:
// 215,024 B at L = 20, C = 1, T = 8. At config 5's L = 40 one block holds
// T = 4 at most (209,552 B; 3.4x halo recompute and 9x region loads per
// output column); a cluster of two holds T = 8 (lc = 20, 215,184 B a
// block). Of the three ways to serve L = 40, the H100 timed this cluster
// faster than the one-block tile 4 (1.5x) and than PR 2's design, and
// slower than the stage path, which the stepper's auto choice takes there
// (PERF.md). The wrapper's rule (rk4_layout) takes the smallest C that
// keeps T = 8 with at most RK4_LEVELS_PER_BLOCK = 21 levels a block (more
// blocks a tile timed slower), then smaller tiles at C = 8; a one-column
// tile at C = 8 holds L <= 688.
//
// Every stage is two rounds over its region, a barrier after each:
//   1. the level sums, one thread per column, in the plain version's
//      order and rounding (no contraction): the geopotential bottom-up
//      over the source region (once per column, not once per neighbour),
//      and over the region the ps terms and the flux divergence summed
//      top-down; each walk is lc dependent adds in shared memory, its
//      loads issued in groups of 8 ahead of the adds. The blocks of a
//      cluster take C turns, a cluster barrier after each: in turn t
//      block C-1-t carries phi up from the next block's first level (read
//      from that block's shared memory; block C-1 starts at the surface)
//      and block t carries the flux sum down from the previous block's
//      last level, so each sum is one sequential chain over the L levels
//      whatever C is; then each block takes dps from the last block's
//      total. A block works in two of the C turns and waits in the rest
//      (at C = 8 K4 timed 2-5x the stage path, PERF.md). Summed in any
//      other order, phi (about 5e5 at L = 680, one ulp 0.06) moved u by
//      2e-4 in a step, over the 1e-4 the kernel is held to; a warp-shuffle
//      scan per column (a lane per level, log2 steps) was also timed
//      2.1-2.3x slower than the serial walk at configs 4 and 5 (PERF.md):
//      it runs one column a warp where the walk runs a whole region's
//      columns in one round of threads;
//   2. (column, run of levels) items over the block's levels, the runs
//      sized per stage so that the rounds of the block's threads times the
//      levels of a run are fewest (level_runs); a thread walks its run
//      top-down carrying the centre values of the level above and
//      sigma-dot at the upper interface, so a level costs 25 shared loads
//      (the level below, the four side neighbours of u, v, T, q, phi's
//      four, cum) and the tendency (pe_column.cuh's body at one level),
//      then y = s + c T into the next state and the accumulator on the own
//      columns, or in stage 4 s' = acc/3 + dt/6 T on the own columns
//      inside the grid. The level above a block's first level and below
//      its last, and cum above its first, are read from the neighbouring
//      blocks' shared memory.
// A stage ends in the cluster barrier when C > 1 (its planes are read
// across the cluster until then). The regions shrink by one column per
// side per stage (halo recompute: (196 + 144 + 100 + 64) / 4 / 64 = 1.97x
// the stage work at T = 8).
//
// Loads. s's region comes in with cp.async, every copy in flight at once
// and none through a register: 16 B where four columns of a row lie
// together in s and are 16 B aligned (the interior tiles of an aligned
// view), else 4 B a column. With a one-block instantiation free of the
// cluster code (fewer registers), this took config 4 from 1.22 to 1.00 ms
// (PERF.md). A block has no room to bring the next tile's region in
// while it computes (83 KB at L = 20, T = 8, and S holds the auxiliaries
// of stages 2-4), so a load overlaps compute only across resident blocks;
// two blocks an SM (256 threads, the levels split over more blocks) timed
// slower than one of 512 threads. One cluster per tile, not a persistent
// grid: with nothing to prefetch, the hardware starting the next tile's
// blocks as others finish does what a tile loop would.
//
// Against the three costs of the earlier design (stage states in a
// per-block scratch in device memory, one thread walking a whole column,
// registers capped at 64 for four blocks an SM). Bytes: no stage state
// and no accumulator leaves the chip (above). Latency: no thread walks a
// column through device memory; the heavy work is independent (column,
// run) items over the region, and the level sums are lc adds in shared
// memory. Occupancy: one 512-thread block per SM at T = 8 (its shared
// memory), no register cap below 128.
//
// Addressing (one launch for every launcher): s and out are each a view
// (base pointer, row pitch, plane pitch, origin of the (ny, nx) interior).
// Per axis (a template parameter) s either wraps (the whole periodic
// domain, and x of a row decomposition) or holds at least HALO = 4 rows
// (columns) of neighbour data around the interior, read in place of the
// wrap; there the source region's columns past the last halo row
// (column) are clamped to it: stage n's values are exact up to 4 - n
// rows past the interior, so the clamped ones feed only columns outside
// it. out may be an interior-shaped array or the interior of the next
// padded block. Every column's arithmetic is the same in every
// instantiation and at every tile position (the split of the levels and
// the level runs depend on L, C and T only; the sums are sequential;
// sigma-dot's fma is explicit), so a sharded run equals the whole-domain
// run bit for bit. A one-block cluster is its own instantiation
// (kCluster false), with no exchange code.
//
// ptxas -v (nvcc 12.9, sm_90a): chip_smoke.py's build phase and
// kernel_time line print the registers, shared memory and blocks per SM
// anew; PERF.md keeps the last reading. No spills.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pe_column.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;            // threads per block
constexpr int HALO = 4;            // one column per stage
constexpr int NCOL = 5;            // col planes: lnps_x, lnps_y, 1/ps, dps/ps, dps
constexpr int NCTA_MAX = 8;        // blocks per cluster, at most (portable)
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SMEM_MAX = 232448;  // the most a block may have (sm_90)

// Element (k, y, x) of a view is p[k * plane + (oy + y) * pitch + ox + x];
// a 2-D field (ps, phi_s) of the same view drops the plane term.
struct Layout {
    long long pitch, plane;
    int oy, ox;

    __device__ __forceinline__ size_t at(int y, int x) const {
        return static_cast<size_t>(oy + y) * pitch + (ox + x);
    }
};

struct Ptrs {
    const float* s[5];              // u, v, T, q, ps
    const float* phi_s;             // s's layout, or null
    float* out[5];
    const float* levc;              // thick[0..L), inv_kh[0..L)
    Layout ls, lout;
};

struct Consts {
    pe::Consts col;
    float c_half, c_full;           // dt/2, dt
    float third, sixth;             // 1/3, dt/6
    int L, ny, nx, tile;
    int ncta, lc;                   // blocks per cluster, levels per block
    int stages;                     // 4; fewer only to time the parts
    int runs[4];                    // level runs per column, each stage
};

// This block's share of the levels.
struct Part {
    int me;                         // rank in the cluster
    int lv0, nl;                    // first level, number of levels
    int nl_up;                      // levels of the block above
    int nl_last;                    // levels of the cluster's last block
};

int levels_per_block(int L, int ncta) { return (L + ncta - 1) / ncta; }

// Floats of the stage-1 auxiliaries (phi over the (T+8)^2 source region,
// cum and col over the (T+6)^2 region), which live in B until stage 2
// writes it.
long long aux1_floats(int lc, int T) {
    const long long a = T + 6LL, w = T + 8LL;
    return static_cast<long long>(lc) * (w * w + a * a) + NCOL * a * a;
}

// Floats of shared memory a block takes (goff's ints counted as floats).
long long smem_floats(int L, int ncta, int T) {
    const int lc = levels_per_block(L, ncta);
    const long long F = 4LL * lc + 1;
    const long long a = T + 6LL, b = T + 4LL, w = T + 8LL;
    const long long B = F * b * b > aux1_floats(lc, T) ? F * b * b
                                                       : aux1_floats(lc, T);
    return F * (w * w + a * a + static_cast<long long>(T) * T) + B + w * w
           + 2LL * L;
}

struct Smem {
    float* S;      // s on the (T+8)^2 source region; stages 2-4's aux
    float* A;      // s1 on (T+6)^2, then s3 on (T+2)^2
    float* B;      // stage 1's aux, then s2 on (T+4)^2
    float* acc;    // the accumulator on the T^2 own columns
    int* goff;     // s's offset (in a plane) of each source-region column
    float* levc;   // thick[0..L), 1/(k + 1/2) for k < L
};

__device__ __forceinline__ Smem carve(float* base, int L, int lc, int T) {
    const int F = 4 * lc + 1;
    const int a = (T + 6) * (T + 6), b = (T + 4) * (T + 4);
    const int w = (T + 8) * (T + 8);
    const int aux1 = lc * (w + a) + NCOL * a;
    Smem m;
    m.S = base;
    m.A = m.S + F * w;
    m.B = m.A + F * a;
    m.acc = m.B + (F * b > aux1 ? F * b : aux1);
    m.goff = reinterpret_cast<int*>(m.acc + F * T * T);
    m.levc = reinterpret_cast<float*>(m.goff + w);
    return m;
}

// The same word in block `rank` of the cluster (distributed shared memory).
template <class P>
__device__ __forceinline__ P* peer(P* local, int rank) {
    return cg::this_cluster().map_shared_rank(local, rank);
}

// The barrier a stage's data needs: the block's, or the cluster's when
// other blocks read this one's shared memory.
template <bool kCluster>
__device__ __forceinline__ void sync_part() {
    if constexpr (kCluster) {
        cg::this_cluster().sync();
    } else {
        __syncthreads();
    }
}

__device__ __forceinline__ int wrap(int a, int n) {
    a %= n;
    return a < 0 ? a + n : a;
}

// The row (column) of s that holds the unwrapped index a: modulo n on a
// wrap axis; on a halo axis a itself, at most n + HALO - 1 (the last halo
// row; the region never starts before -HALO).
template <bool kHalo>
__device__ __forceinline__ int column_index(int a, int n) {
    if constexpr (kHalo) {
        return a < n + HALO - 1 ? a : n + HALO - 1;
    } else {
        return wrap(a, n);
    }
}

// sigma-dot (scaled by L/2) at the upper interface of level kk of a
// column, from the flux divergence summed down to level kk - 1; one
// rounding order wherever it is evaluated (the fma is explicit).
__device__ __forceinline__ float sigma_dot(int kk, float dps_over_ps,
                                           float cum_above, float inv_ps) {
    return kk == 0 ? 0.0f
        : -0.5f * __fmaf_rn(static_cast<float>(kk), dps_over_ps,
                            cum_above * inv_ps);
}

// Asynchronous copies of 4 and 16 bytes from device to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                    "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                    "l"(src)
                 : "memory");
}

// Surface geopotential at source column j of stage kStage (its region
// edge Es, the source region's W).
template <int kStage>
__device__ __forceinline__ float surface_phi(const Ptrs& p, const Smem& m,
                                             int j, int Es, int W) {
    if (p.phi_s == nullptr) return 0.0f;
    const int r = j / Es, c = j - r * Es;
    return __ldg(p.phi_s + m.goff[(r + kStage - 1) * W + c + kStage - 1]);
}

// Stage kStage (1..4) of the tile at (y0, x0). Its region has edge
// E = T + 2h, h = HALO - kStage, and its source region edge E + 2, both
// centred on the tile; the source is s's region S (stage 1) or the
// previous stage's buffer, field f at local level kl of source column j
// at src[(f lc + kl) Es^2 + j]. The auxiliaries phi (the source region's
// geopotential, lc planes), cum (the region's flux divergence summed down
// the column, lc planes) and col (d lnps/dx, d lnps/dy, 1/ps, dps/ps, dps
// on the region) live in B in stage 1 and in S after it.
template <int kStage, bool kHaloY, bool kHaloX, bool kCluster>
__device__ __forceinline__ void run_stage(const Ptrs& p, const Consts& k,
                                          const Smem& m, const Part& pt,
                                          int y0, int x0) {
    // one block (kCluster false): all L levels, no exchange
    const int T = k.tile, L = k.L;
    const int lc = kCluster ? k.lc : L, nc = kCluster ? k.ncta : 1;
    const int nl = kCluster ? pt.nl : L, lv0 = kCluster ? pt.lv0 : 0;
    const int me = kCluster ? pt.me : 0;
    const int h = HALO - kStage;
    const int E = T + 2 * h, Es = E + 2, W = T + 2 * HALO;
    const int E2 = E * E, Es2 = Es * Es, T2 = T * T;
    const int FS = lc * Es2;                // field stride of the source
    const float cx = k.col.cx, cy = k.col.cy;
    const size_t gP = static_cast<size_t>(p.ls.plane);
    const float* src = kStage == 1 ? m.S : kStage == 3 ? m.B : m.A;
    float* dst = kStage == 2 ? m.B : m.A;           // stages 1-3
    float* const phi = kStage == 1 ? m.B : m.S;
    float* const cum = phi + lc * Es2;
    float* const col = cum + lc * E2;
    constexpr int U = 8;                    // loads grouped ahead of a chain

    // 1: the level sums, in the plain version's order and rounding (no
    //    contraction): phi bottom-up over the source region; over the
    //    region the ps terms and the flux divergence div(ps u_k) summed
    //    top-down. The blocks of a cluster take turns: in turn t block
    //    C-1-t carries phi up from the next block's first level (block
    //    C-1 from the surface) and block t carries the flux sum down from
    //    the previous block's last level, so every sum is one sequential
    //    chain over the L levels, whatever C is.
    for (int turn = 0; turn < nc; ++turn) {
        const bool do_phi = me == nc - 1 - turn, do_cum = me == turn;
        for (int idx = threadIdx.x; idx < Es2 + E2; idx += NT) {
            if (idx < Es2) {
                if (!do_phi) continue;
                const int j = idx;
                const float* Tj = src + 2 * FS + j;
                float Tk = Tj[(nl - 1) * Es2];
                float ph;
                if (!kCluster || me == nc - 1) {
                    ph = __fadd_rn(__fmul_rn(k.col.phibot, Tk),
                                   surface_phi<kStage>(p, m, j, Es, W));
                } else {
                    // the next block's first level: its phi and T
                    const float Tn = *peer(Tj, me + 1);
                    ph = __fadd_rn(*peer(phi + j, me + 1),
                                   __fmul_rn(m.levc[lv0 + nl],
                                             __fadd_rn(Tk, Tn)));
                }
                phi[(nl - 1) * Es2 + j] = ph;
                for (int k0 = nl - 1; k0 > 0; k0 -= U) {
                    float th[U], tc[U];
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int kk = k0 - u;
                        th[u] = kk > 0 ? Tj[(kk - 1) * Es2] : 0.0f;
                        tc[u] = kk > 0 ? m.levc[lv0 + kk] : 0.0f;
                    }
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int kk = k0 - u;
                        if (kk > 0) {
                            const float t = __fadd_rn(th[u], Tk);
                            ph = __fadd_rn(ph, __fmul_rn(tc[u], t));
                            phi[(kk - 1) * Es2 + j] = ph;
                            Tk = th[u];
                        }
                    }
                }
            } else {
                if (!do_cum) continue;
                const int i = idx - Es2;
                const int r = i / E;
                const int j = (r + 1) * Es + (i - r * E) + 1;
                const float* pps = src + 4 * FS + j;
                const float psE = pps[1], psW = pps[-1];
                const float psN = pps[Es], psS = pps[-Es];
                const float inv_ps = 1.0f / pps[0];
                col[i] = (logf(psE) - logf(psW)) * cx;
                col[E2 + i] = (logf(psN) - logf(psS)) * cy;
                col[2 * E2 + i] = inv_ps;
                const float* pu = src + j;
                const float* pv = pu + FS;
                const bool above = kCluster && me > 0;
                float flux = above
                    ? *peer(cum + (pt.nl_up - 1) * E2 + i, me - 1) : 0.0f;
                for (int k0 = 0; k0 < nl; k0 += U) {
                    float fd[U];
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int o = (k0 + u) * Es2;
                        if (k0 + u >= nl) {
                            fd[u] = 0.0f;
                            continue;
                        }
                        const float fx = __fsub_rn(__fmul_rn(psE, pu[o + 1]),
                                                   __fmul_rn(psW, pu[o - 1]));
                        const float fy = __fsub_rn(__fmul_rn(psN, pv[o + Es]),
                                                   __fmul_rn(psS, pv[o - Es]));
                        fd[u] = __fadd_rn(__fmul_rn(fx, cx),
                                          __fmul_rn(fy, cy));
                    }
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int kk = k0 + u;
                        if (kk < nl) {
                            flux = kk == 0 && !above ? fd[u]
                                                     : __fadd_rn(flux, fd[u]);
                            cum[kk * E2 + i] = flux;
                        }
                    }
                }
                if (!kCluster) {
                    const float dps = -flux * k.col.dsig;
                    col[3 * E2 + i] = dps * inv_ps;
                    col[4 * E2 + i] = dps;
                }
            }
        }
        sync_part<kCluster>();
    }
    if constexpr (kCluster) {
        // dps from the flux summed over all L levels: the last block's
        for (int i = threadIdx.x; i < E2; i += NT) {
            const float dps =
                -*peer(cum + (pt.nl_last - 1) * E2 + i, nc - 1) * k.col.dsig;
            col[3 * E2 + i] = dps * col[2 * E2 + i];
            col[4 * E2 + i] = dps;
        }
        __syncthreads();
    }

    // 2: (column, run of levels) items, the surface as "level" nl of the
    //    last run: the tendency, then the next state and the accumulator,
    //    or s'. A thread walks its run top-down, carrying the centre
    //    values of the level above and sigma-dot at the upper interface.
    const float c_n = kStage == 3 ? k.c_full : k.c_half;
    const int runs = k.runs[kStage - 1];
    const pe::Consts& kc = k.col;
    for (int idx = threadIdx.x; idx < E2 * runs; idx += NT) {
        const int q = idx / E2, i = idx - q * E2;
        const int r = i / E, c = i - r * E;
        const int k0 = q * (nl + 1) / runs, k1 = (q + 1) * (nl + 1) / runs;
        const int j = (r + 1) * Es + c + 1;
        const bool own = r >= h && r < h + T && c >= h && c < h + T;
        const int o = (r - h) * T + (c - h);
        // s's offset of this column (the base of stages 2 and 3)
        const size_t gb = (kStage == 2 || kStage == 3)
            ? static_cast<size_t>(m.goff[(r + kStage) * W + c + kStage])
            : 0;
        // out's offset of this column (stage 4), -1 outside the grid
        long long go = -1;
        if (kStage == 4 && y0 + r < k.ny && x0 + c < k.nx) {
            go = static_cast<long long>(p.lout.at(y0 + r, x0 + c));
        }
        // plane (field f, global level lv) of the next state from the
        // source centre xc (stage 1) or s (stages 2, 3), and its tendency
        // d; in stage 4 the bottom block writes ps'
        auto emit = [&](int plane, int f, int lv, float xc, float d) {
            if constexpr (kStage == 4) {
                if (go >= 0 && (!kCluster || f < 4 || me == nc - 1)) {
                    p.out[f][lv * static_cast<size_t>(p.lout.plane) + go] =
                        m.acc[plane * T2 + o] * k.third + k.sixth * d;
                }
            } else {
                const float x = kStage == 1
                    ? xc : __ldg(p.s[f] + lv * gP + gb);
                const float y = x + c_n * d;
                dst[plane * E2 + i] = y;
                if (own) {
                    float* a = m.acc + plane * T2 + o;
                    if (kStage == 1) {
                        *a = y - x;
                    } else if (kStage == 2) {
                        *a = *a + 2.0f * y;
                    } else {
                        *a = *a + y;
                    }
                }
            }
        };
        const float lnps_x = col[i], lnps_y = col[E2 + i];
        const float inv_ps = col[2 * E2 + i];
        const float dps_over_ps = col[3 * E2 + i];
        const float* p0 = src + j;
        float uk = 0.0f, vk = 0.0f, Tk = 0.0f, qk = 0.0f;
        float u_hi = 0.0f, v_hi = 0.0f, T_hi = 0.0f, q_hi = 0.0f;
        float sd_up = 0.0f;
        if (k0 < nl) {
            const float* pk = p0 + k0 * Es2;
            uk = pk[0];
            vk = pk[FS];
            Tk = pk[2 * FS];
            qk = pk[3 * FS];
            if (k0 > 0 || (kCluster && me > 0)) {
                // the level above: this block's, or the last of the block
                // above
                const float* pa = k0 > 0 ? pk - Es2
                    : peer(p0, me - 1) + (pt.nl_up - 1) * Es2;
                u_hi = pa[0];
                v_hi = pa[FS];
                T_hi = pa[2 * FS];
                q_hi = pa[3 * FS];
                sd_up = sigma_dot(
                    lv0 + k0, dps_over_ps,
                    k0 > 0 ? cum[(k0 - 1) * E2 + i]
                           : *peer(cum + (pt.nl_up - 1) * E2 + i, me - 1),
                    inv_ps);
            }
        }
        for (int kl = k0; kl < k1; ++kl) {
            if (kl == nl) {
                emit(4 * lc, 4, 0, kStage == 1 ? src[4 * FS + j] : 0.0f,
                     col[4 * E2 + i]);
                break;
            }
            const int kk = lv0 + kl;
            const bool top = kk == 0, bottom = kk == L - 1;
            const float* pk = p0 + kl * Es2;
            float u_lo = 0.0f, v_lo = 0.0f, T_lo = 0.0f, q_lo = 0.0f;
            float sd_dn = 0.0f;
            if (!bottom) {
                // the level below: this block's, or the first of the block
                // below
                const float* pb = !kCluster || kl + 1 < nl ? pk + Es2
                                                            : peer(p0, me + 1);
                u_lo = pb[0];
                v_lo = pb[FS];
                T_lo = pb[2 * FS];
                q_lo = pb[3 * FS];
                sd_dn = sigma_dot(kk + 1, dps_over_ps, cum[kl * E2 + i],
                                  inv_ps);
            }
            const float* pu = pk;
            const float* pv = pk + FS;
            const float* pT = pk + 2 * FS;
            const float* pq = pk + 3 * FS;
            const float TE = pT[1], TW = pT[-1], TN = pT[Es], TS = pT[-Es];
            const float u_x = (pu[1] - pu[-1]) * cx;
            const float u_y = (pu[Es] - pu[-Es]) * cy;
            const float v_x = (pv[1] - pv[-1]) * cx;
            const float v_y = (pv[Es] - pv[-Es]) * cy;
            const float T_x = (TE - TW) * cx;
            const float T_y = (TN - TS) * cy;
            const float q_x = (pq[1] - pq[-1]) * cx;
            const float q_y = (pq[Es] - pq[-Es]) * cy;
            const float* ph = phi + kl * Es2 + j;
            const float phi_x = (ph[1] - ph[-1]) * cx;
            const float phi_y = (ph[Es] - ph[-Es]) * cy;

            const float u_up = top ? 0.0f : uk - u_hi;
            const float u_dn = bottom ? 0.0f : u_lo - uk;
            const float v_up = top ? 0.0f : vk - v_hi;
            const float v_dn = bottom ? 0.0f : v_lo - vk;
            const float T_up = top ? 0.0f : Tk - T_hi;
            const float T_dn = bottom ? 0.0f : T_lo - Tk;
            const float q_up = top ? 0.0f : qk - q_hi;
            const float q_dn = bottom ? 0.0f : q_lo - qk;
            const float vadv_u = sd_dn * u_dn + sd_up * u_up;
            const float vadv_v = sd_dn * v_dn + sd_up * v_up;
            const float vadv_T = sd_dn * T_dn + sd_up * T_up;
            const float vadv_q = sd_dn * q_dn + sd_up * q_up;

            const float du = -uk * u_x - vk * u_y - vadv_u + kc.f * vk
                             - phi_x - kc.r_dry * Tk * lnps_x;
            const float dv = -uk * v_x - vk * v_y - vadv_v - kc.f * uk
                             - phi_y - kc.r_dry * Tk * lnps_y;
            const float dlnps_adv = dps_over_ps + uk * lnps_x + vk * lnps_y;
            const float omega_over_p = (sd_up + sd_dn) * m.levc[L + kk]
                                       + dlnps_adv;
            const float dT = -uk * T_x - vk * T_y - vadv_T
                             + kc.kappa * Tk * omega_over_p;
            const float dq = -uk * q_x - vk * q_y - vadv_q;
            emit(kl, 0, kk, uk, du);
            emit(lc + kl, 1, kk, vk, dv);
            emit(2 * lc + kl, 2, kk, Tk, dT);
            emit(3 * lc + kl, 3, kk, qk, dq);

            sd_up = sd_dn;
            u_hi = uk; v_hi = vk; T_hi = Tk; q_hi = qk;
            uk = u_lo; vk = v_lo; Tk = T_lo; qk = q_lo;
        }
    }
    sync_part<kCluster>();
}

template <bool kHaloY, bool kHaloX, bool kCluster>
__global__ void __launch_bounds__(NT, 1) pe_rk4_kernel(Ptrs p, Consts k) {
    extern __shared__ float smem[];
    const int nc = kCluster ? k.ncta : 1, L = k.L;
    const int lc = kCluster ? k.lc : L, T = k.tile;
    const Smem m = carve(smem, L, lc, T);
    Part pt;
    pt.me = kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
    pt.lv0 = pt.me * L / nc;
    pt.nl = (pt.me + 1) * L / nc - pt.lv0;
    pt.nl_up = pt.me > 0 ? pt.lv0 - (pt.me - 1) * L / nc : 0;
    pt.nl_last = L - (nc - 1) * L / nc;
    const int W = T + 2 * HALO, W2 = W * W;
    const size_t gP = static_cast<size_t>(p.ls.plane);
    const int tiles_x = (k.nx + T - 1) / T;
    const int t = blockIdx.x / nc;
    const int y0 = (t / tiles_x) * T, x0 = (t % tiles_x) * T;
    for (int i = threadIdx.x; i < 2 * L; i += NT) m.levc[i] = p.levc[i];
    // the source region's offsets in s, then s on it (this block's 4 nl
    // levels and ps, the region's columns of a plane contiguous in S)
    for (int idx = threadIdx.x; idx < W2; idx += NT) {
        const int r = idx / W, c = idx - (idx / W) * W;
        const int gy = column_index<kHaloY>(y0 - HALO + r, k.ny);
        const int gx = column_index<kHaloX>(x0 - HALO + c, k.nx);
        m.goff[idx] = static_cast<int>(p.ls.at(gy, gx));
    }
    __syncthreads();
    {
        // cp.async, every copy in flight at once and none through a
        // register: 16 B where four columns of a row lie together in s
        // and are 16 B aligned (the interior tiles of an aligned view),
        // else 4 B a column
        const int nl = kCluster ? pt.nl : L, lv0 = kCluster ? pt.lv0 : 0;
        const int nplanes = 4 * nl + 1;
        const int step = W % 4 == 0 ? 4 : 1;
        for (int u = threadIdx.x; u < nplanes * (W2 / step); u += NT) {
            const int q = u / (W2 / step), j = (u - q * (W2 / step)) * step;
            const int f = q < 4 * nl ? q / nl : 4;
            const int kl = q - f * nl;
            const float* src = (f == 0 ? p.s[0] : f == 1 ? p.s[1]
                : f == 2 ? p.s[2] : f == 3 ? p.s[3] : p.s[4])
                + (f < 4 ? static_cast<size_t>(lv0 + kl) * gP : 0);
            float* dst = m.S + (f * lc + kl) * W2 + j;
            const int g0 = m.goff[j];
            if (step == 4 && m.goff[j + 3] - g0 == 3
                && (reinterpret_cast<size_t>(src + g0) & 15) == 0) {
                cp_async16(dst, src + g0);
            } else {
                for (int e = 0; e < step; ++e) {
                    cp_async4(dst + e, src + m.goff[j + e]);
                }
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    sync_part<kCluster>();
    run_stage<1, kHaloY, kHaloX, kCluster>(p, k, m, pt, y0, x0);
    if (k.stages < 2) return;
    run_stage<2, kHaloY, kHaloX, kCluster>(p, k, m, pt, y0, x0);
    if (k.stages < 3) return;
    run_stage<3, kHaloY, kHaloX, kCluster>(p, k, m, pt, y0, x0);
    if (k.stages < 4) return;
    run_stage<4, kHaloY, kHaloX, kCluster>(p, k, m, pt, y0, x0);
}

// Runs of levels per column in a stage over E x E columns, lc levels and
// the surface: the count that takes the fewest rounds of the block's NT
// threads times levels per run, a run's setup counted as half a level.
int level_runs(int lc, int E) {
    const long long E2 = static_cast<long long>(E) * E;
    int best = 1;
    long long best_cost = -1;
    for (int n = 1; n <= lc + 1; ++n) {
        const long long rounds = (E2 * n + NT - 1) / NT;
        const long long cost = rounds * (2 * ((lc + n) / n) + 1);
        if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            best = n;
        }
    }
    return best;
}

template <bool kHaloY, bool kHaloX, bool kCluster>
int allow_smem(size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        pe_rk4_kernel<kHaloY, kHaloX, kCluster>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

cudaLaunchConfig_t launch_config(int blocks, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* cluster, int ncta) {
    cluster->id = cudaLaunchAttributeClusterDimension;
    cluster->val.clusterDim.x = ncta;
    cluster->val.clusterDim.y = 1;
    cluster->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    return cfg;
}

template <bool kHaloY, bool kHaloX, bool kCluster>
int launch(const Ptrs& p, const Consts& k, cudaStream_t stream) {
    const size_t smem =
        static_cast<size_t>(4 * smem_floats(k.L, k.ncta, k.tile));
    const int err = allow_smem<kHaloY, kHaloX, kCluster>(smem);
    if (err != 0) return err;
    const long long tiles =
        static_cast<long long>((k.ny + k.tile - 1) / k.tile)
        * ((k.nx + k.tile - 1) / k.tile);
    if (tiles * k.ncta > 0x7fffffffLL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg = launch_config(
        static_cast<int>(tiles * k.ncta), smem, stream, &cluster,
        k.ncta);
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, pe_rk4_kernel<kHaloY, kHaloX, kCluster>, p,
                           k);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

bool valid_layout(int L, int ncta, int tile) {
    const bool pow2 = ncta == 1 || ncta == 2 || ncta == 4 || ncta == 8;
    return L >= 1 && tile >= 1 && pow2 && ncta <= NCTA_MAX && ncta <= L
           && 4 * smem_floats(L, ncta, tile) <= SMEM_MAX;
}

}  // namespace

// Bytes of shared memory a block of the kernel takes at L levels, ncta
// blocks per cluster and output tile `tile`
// (njw_tpu_torch.ops.pe_stencil.rk4_smem_bytes).
extern "C" long long pe_rk4_smem_bytes(int L, int ncta, int tile) {
    return 4 * smem_floats(L, ncta, tile);
}

// How many blocks of the kernel one SM of the current device holds at once
// (into *blocks) and how many clusters the device runs at once (into
// *clusters). Returns the CUDA error code.
extern "C" int pe_rk4_occupancy(int L, int ncta, int tile, int* blocks,
                                int* clusters) {
    if (!valid_layout(L, ncta, tile)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = static_cast<size_t>(4 * smem_floats(L, ncta, tile));
    // every halo instantiation has the occupancy of the whole-domain one
    // (chip_smoke.py prints each one's ptxas registers)
    auto query = [&](auto kernel, int err) {
        if (err != 0) return err;
        err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, kernel, NT, smem));
        if (err != 0) return err;
        cudaLaunchAttribute cluster;
        const cudaLaunchConfig_t cfg =
            launch_config(ncta, smem, nullptr, &cluster, ncta);
        return static_cast<int>(
            cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
    };
    return ncta > 1
        ? query(pe_rk4_kernel<false, false, true>,
                allow_smem<false, false, true>(smem))
        : query(pe_rk4_kernel<false, false, false>,
                allow_smem<false, false, false>(smem));
}

// Launch one step of the (L, ny, nx) interior on `stream`: a cluster of
// `ncta` blocks per tile x tile output tile. s (u, v, T, q, ps, phi_s) and
// out are each given as the base pointers of their fields and a
// layout: row pitch, plane pitch of the 3-D fields, origin (row, column)
// of the interior. halo_y, halo_x: 1 where s holds at least HALO rows
// (columns) of neighbour data around the interior, 0 where that axis
// wraps; a halo in x needs one in y. out must not alias s. stages: 4 (the
// step); 1-3 run only the first stages and write no output
// (scripts/profile_torch.py times the parts so). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int pe_rk4_launch(
    const float* u, const float* v, const float* T, const float* q,
    const float* ps, const float* phi_s, long long s_pitch,
    long long s_plane, int s_oy, int s_ox,
    float* ou, float* ov, float* oT, float* oq, float* ops,
    long long out_pitch, long long out_plane,
    const float* levc, int ncta, int tile,
    int L, int ny, int nx, int halo_y, int halo_x,
    float cx, float cy, float f, float dsig, float r_dry, float kappa,
    float phibot, float c_half, float c_full, float third, float sixth,
    int stages, void* stream) {
    if (!valid_layout(L, ncta, tile) || ny < 1 || nx < 1
        || stages < 1 || stages > 4) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int lc = levels_per_block(L, ncta);
    const Ptrs p{{u, v, T, q, ps}, phi_s, {ou, ov, oT, oq, ops}, levc,
                 {s_pitch, s_plane, s_oy, s_ox}, {out_pitch, out_plane, 0, 0}};
    const Consts k{{cx, cy, f, dsig, r_dry, kappa, phibot}, c_half, c_full,
                   third, sixth, L, ny, nx, tile, ncta, lc,
                   stages,
                   {level_runs(lc, tile + 6), level_runs(lc, tile + 4),
                    level_runs(lc, tile + 2), level_runs(lc, tile)}};
    const auto st = static_cast<cudaStream_t>(stream);
    const bool c = ncta > 1;
    if (!halo_y && !halo_x) {
        return c ? launch<false, false, true>(p, k, st)
                 : launch<false, false, false>(p, k, st);
    }
    if (halo_y && !halo_x) {
        return c ? launch<true, false, true>(p, k, st)
                 : launch<true, false, false>(p, k, st);
    }
    if (halo_y && halo_x) {
        return c ? launch<true, true, true>(p, k, st)
                 : launch<true, true, false>(p, k, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* pe_rk4_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
