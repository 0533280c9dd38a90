// One RK stage of the periodic primitive equations (sigma levels), sm_90a.
//
// Replaces the TPU kernel _pe_stage_kernel (njw_tpu/ops/pe_stencil.py:55)
// for all its launchers: pe_stage_pallas (:323 -> :370, the whole periodic
// domain) and the sharded pe_stage_pallas_local (:397 -> :462) and
// pe_stage_pallas_local2d (:1271 -> :1353), which run it on a halo-padded
// block:
//
//   out = sum_g coef_g * base_g + c_dt * T(cur),   g < nbase <= 4,
//
// for u, v, T, q of shape (L, ny, nx) and ps of shape (ny, nx), float32,
// with an optional surface geopotential phi_s (terrain). The multi-base
// form lets the RK4 combine ride in the last stage. The column arithmetic
// is pe_column.cuh's (the Pallas kernel's strength-reduced form). Scalars
// are folded in double on the host and rounded to float32 once; the
// per-level constants (layer thickness factor, 1/(k + 1/2)) come from a
// small device array built once per level count.
//
// Bound on this card: memory. A stage must read cur (4L + 1 planes) and
// each base (4L + 1 planes) once, read phi_s once when given, and write
// out (4L + 1 planes) once: 3 (4L + 1) x 4 B per column with one base, 255
// MB at 512^2 x 20 (76 us at the H100 SXM's 3.35 TB/s) and 2.03 GB on a
// config-5 shard of 512 x 2048 or 1024 x 1024 columns at L = 40 (606 us;
// 1.21 ms with four distinct bases). The arithmetic is about 116 flop per
// column and level (140 with four bases), 9 us at 512^2 x 20 at 67 TFLOP/s
// fp32; the instructions around it (about 150 a column and level) take a
// third of the bytes' time at one a cycle per scheduler.
//
// Design against that bound. A block owns a tile of 64 x TY columns (two
// warps a row of the tile, x contiguous) and walks the levels twice: top
// down for the flux divergence (cum_k, L floats a column in shared memory),
// then bottom up for the tendencies. Each level plane of the tile with its
// one-point halo ((TY + 2) rows of 66 columns) is staged into shared memory
// by cp.async, in a ring of SLOTS levels: the top-down walk keeps the next
// 2 SLOTS - 1 levels of u and v in flight, the bottom-up walk the next
// SLOTS - 2 levels of u, v, T and q beyond the two it reads (level k and
// k - 1), so each byte of cur leaves device memory about once a walk (u and
// v twice: L2 holds part of the second read), every neighbour comes from
// shared memory, and there is one barrier a level. A region row whose 66
// columns lie side by side in cur goes as the aligned 16-byte chunks that
// hold it, shifted in shared memory as it is in cur (so the 1026-float
// rows of a block padded in x go 16 bytes a copy too); a row that wraps
// (the first and last tiles of a periodic x) takes 16-byte chunks for its
// interior where cur's rows are aligned and 4-byte copies for the rest.
// The thread carries phi at its four neighbour columns, T around the column
// at level k - 1 (the next level's neighbours), the centre values and
// sigma-dot from one level to the next; its bases are loaded a level ahead,
// in flight through a level's work.
//
// Where each halo row and column lies in cur is worked out once a block
// (a table in shared memory): a periodic axis wraps there (whole domain;
// x of a row-sharded block), a padded one reads its halo row or column, so
// one kernel serves every launcher and no index wraps per level. Ragged
// tiles clamp their halo indices into cur and store only their interior
// columns. The tile height is the rule's (tile_rows below, mirrored by
// pe_stencil.stage_tile_rows): of 4, 2 and 1 rows, the one whose blocks
// (ring and cum) let an SM hold the most threads, the taller on a tie: 4
// at the main paths' L = 20 and 40, 1 at the reach, L = 454.
// The register cap gives one-base launches 24 warps an SM at 4 rows, the
// others 16 (the four-base sums take more registers). So placed, the walks
// move device memory at about a plain copy's rate on the H100; what the
// kernel still pays over the bound is mostly the second read of u and v
// (keeping them in shared memory costs the occupancy that hides latency).
//
// Addressing: cur, the bases and out are each a view (base pointer, row
// pitch, plane pitch, origin of the (ny, nx) interior), so the bases and
// out may be interior-shaped arrays or the interiors of padded blocks while
// cur is padded. Bases may alias out (each point is read before the same
// thread writes it); cur must not.

#include <cuda_runtime.h>

#include <type_traits>

#include "pe_column.cuh"

// Profiling only (scripts/profile_torch.py builds it so): 1 runs the
// top-down walk alone, 2 the bottom-up walk alone.
#ifndef PE_STAGE_PROBE
#define PE_STAGE_PROBE 0
#endif

namespace {

constexpr int TX = 64;             // tile columns: two warps a tile row
constexpr int PX = TX + 8;         // shared row pitch (floats)
constexpr int SLOTS = 5;           // levels of u, v, T, q in the ring
constexpr int NF = 4;              // fields a level holds: u, v, T, q
constexpr int MAXB = 4;            // most bases
constexpr int kMaxLevels = 454;    // the stage path's reach
constexpr long long kSmemMax = 232448;   // shared bytes a block may have

// Shared bytes of a block of TY tile rows at L levels: the ring, cum (L
// floats a column), the halo region's row offsets into cur and shifts
// (12 B a row) and its column offsets (4 B a column).
__host__ __device__ constexpr long long smem_bytes(int ty, int L) {
    return 4LL * SLOTS * NF * (ty + 2) * PX + 4LL * L * TX * ty
           + 12LL * (ty + 2) + 4LL * (TX + 2);
}

// Threads an SM holds at TY rows and L levels as shared memory allows it
// (233,472 bytes an SM, 1 KB of them reserved a block); 0 where a block
// does not fit.
constexpr int resident_threads(int ty, int L) {
    return smem_bytes(ty, L) > kSmemMax ? 0
           : static_cast<int>(233472 / (smem_bytes(ty, L) + 1024)) * TX * ty;
}

// The rule: of 4, 2 and 1 rows, the tile with the most threads an SM (the
// taller on a tie), 0 past the reach.
constexpr int tile_rows(int L) {
    return L < 1 || L > kMaxLevels ? 0
           : resident_threads(4, L) >= resident_threads(2, L)
                     && resident_threads(4, L) >= resident_threads(1, L)
                 ? 4
           : resident_threads(2, L) >= resident_threads(1, L) ? 2 : 1;
}
static_assert(tile_rows(20) == 4 && tile_rows(40) == 4,
              "4 rows at the main paths' L = 20 and 40");
static_assert(tile_rows(41) == 2 && tile_rows(80) == 2 && tile_rows(193) == 1
              && tile_rows(232) == 2, "fewer rows where more threads fit");
static_assert(tile_rows(kMaxLevels) == 1, "the reach takes 1-row tiles");
static_assert(tile_rows(kMaxLevels + 1) == 0, "nothing past the reach");

// Resident blocks an SM each form is built for (its register cap): 24
// warps at 4 rows with one base, 16 otherwise.
constexpr int min_blocks(int ty, int nb) {
    return (nb == 1 && ty == 4 ? 768 : 512) / (TX * ty);
}

struct Ptrs {
    const float* cur[5];            // u, v, T, q, ps
    const float* phi_s;             // (ny, nx) or null (whole domain only)
    const float* base[MAXB][5];
    float* out[5];
    const float* levc;              // thick[0..L), inv_kh[0..L)
    long long cur_pitch, cur_plane; // cur's row and plane pitch
    long long out_pitch, out_plane; // out's and the bases'
};

struct Consts {
    pe::Consts col;
    float c_dt;
    float coef[MAXB];
    int nbase;
    int L, ny, nx;
    int cur_oy, cur_ox;             // origin of the interior in cur
    int halo_y, halo_x;             // 1: cur holds that axis' halo
    int chunks;                     // u, v, T, q lie alike against 16 B
    int aligned;                    // ... and each row starts on 16 B
    int shift0;                     // (u's address / 4) % 4
};

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

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

// sum_g coef_g base_g of one field at one point, from values loaded
// before (the bases may alias out, so they are read with plain loads). NB:
// 1 for one base, MAXB for up to k.nbase.
template <int NB>
__device__ __forceinline__ float base_sum(const float (&b)[NB],
                                          const Consts& k) {
    float acc = k.coef[0] * b[0];
#pragma unroll
    for (int g = 1; g < NB; ++g)
        if (g < k.nbase) acc = acc + k.coef[g] * b[g];
    return acc;
}

// The bases of field f at element i of out's view.
template <int NB>
__device__ __forceinline__ void load_bases(const Ptrs& p, const Consts& k,
                                           int f, long long i,
                                           float (&b)[NB]) {
#pragma unroll
    for (int g = 0; g < NB; ++g)
        b[g] = g == 0 || g < k.nbase ? p.base[g][f][i] : 0.0f;
}

template <int TY, int NB>
__global__ void __launch_bounds__(TX * TY, min_blocks(TY, NB))
pe_stage_kernel(Ptrs p, Consts k) {
    constexpr int NT = TX * TY;           // threads: one a column
    constexpr int RY = TY + 2;            // halo region rows
    constexpr int PLANE = RY * PX;        // floats of one field's plane
    constexpr int SLOT = NF * PLANE;      // floats of one level

    extern __shared__ __align__(16) float smem[];
    const int L = k.L;
    float* const ring = smem;
    float* const cum = ring + SLOTS * SLOT;
    long long* const rowoff = reinterpret_cast<long long*>(cum + L * NT);
    int* const coloff = reinterpret_cast<int*>(rowoff + RY);
    int* const shift = coloff + TX + 2;

    const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
    const int x = x0 + tx, y = y0 + ty;
    const bool inside = x < k.nx && y < k.ny;

    // where row r (column c) of the halo region, interior row y0 + r - 1
    // (column x0 + c - 1), lies in cur: wrapped on a periodic axis, the
    // halo row (column) of a padded one, clamped past a ragged edge
    for (int r = tid; r < RY; r += NT) {
        const int gy = y0 + r - 1;
        rowoff[r] = static_cast<long long>(
            k.cur_oy + (k.halo_y ? min(gy, k.ny) : wrap(gy, k.ny)))
            * p.cur_pitch;
    }
    for (int c = tid; c < TX + 2; c += NT) {
        const int gx = x0 + c - 1;
        coloff[c] = k.cur_ox + (k.halo_x ? min(gx, k.nx) : wrap(gx, k.nx));
    }
    __syncthreads();
    // how the rows come in: 1, whole rows as the aligned 16-byte chunks
    // that hold them (each chunk holds one of the row's columns, so none
    // reaches outside cur's allocation), column x0 + c - 1 of row r at
    // shift[r] + c in shared memory; 2, the interior's TX columns in
    // aligned chunks and the two halo columns 4 bytes at a time; 0, every
    // column 4 bytes at a time. Modes 0 and 2 put column x0 + c - 1 at
    // 3 + c.
    const int mode = k.chunks && coloff[TX + 1] - coloff[0] == TX + 1 ? 1
        : k.aligned && coloff[TX] - coloff[1] == TX - 1 ? 2 : 0;
    for (int r = tid; r < RY; r += NT) {
        shift[r] = mode == 1 ? static_cast<int>(
            (k.shift0 + rowoff[r] + coloff[0]) & 3) : 3;
    }
    __syncthreads();

    // level kk of nf fields of cur from field f0 into the ring at dst0 (nf
    // planes of PLANE floats); per row, OPS copies of which copy(f, r, c,
    // src, dst) issues copy c
    auto each_copy = [&](auto ops, int kk, float* dst0, int f0, int nf,
                         auto copy) {
        constexpr int OPS = decltype(ops)::value;
        const long long lofs = static_cast<long long>(kk) * p.cur_plane;
        for (int j = tid; j < nf * RY * OPS; j += NT) {
            const int f = j / (RY * OPS), rem = j - f * (RY * OPS);
            const int r = rem / OPS, c = rem - r * OPS;
            const int g = f0 + f;
            const float* src = (g == 0 ? p.cur[0] : g == 1 ? p.cur[1]
                                : g == 2 ? p.cur[2] : p.cur[3])
                               + lofs + rowoff[r];
            copy(r, c, src, dst0 + f * PLANE + r * PX);
        }
    };
    auto load_level = [&](int kk, float* dst0, int f0, int nf) {
        if (mode == 1) {   // up to PX / 4 aligned chunks a row
            each_copy(std::integral_constant<int, PX / 4>(), kk, dst0, f0, nf,
                      [&](int r, int c, const float* src, float* dst) {
                          if (4 * c < shift[r] + TX + 2) {
                              cp_async16(dst + 4 * c,
                                         src + coloff[0] - shift[r] + 4 * c);
                          }
                      });
        } else if (mode == 2) {   // TX / 4 chunks and the halo columns
            each_copy(std::integral_constant<int, TX / 4 + 2>(), kk, dst0, f0,
                      nf, [&](int, int c, const float* src, float* dst) {
                          if (c < TX / 4) {
                              cp_async16(dst + 4 + 4 * c,
                                         src + coloff[1] + 4 * c);
                          } else {
                              const int cc = c == TX / 4 ? 0 : TX + 1;
                              cp_async4(dst + 3 + cc, src + coloff[cc]);
                          }
                      });
        } else {           // TX + 2 columns
            each_copy(std::integral_constant<int, TX + 2>(), kk, dst0, f0, nf,
                      [&](int, int c, const float* src, float* dst) {
                          cp_async4(dst + 3 + c, src + coloff[c]);
                      });
        }
    };

    // ps (and phi_s) around the column, from device memory once
    const long long rc = rowoff[ty + 1];
    const float* ps = p.cur[4];
    pe::Cross psx;
    psx.c = __ldg(ps + rc + coloff[tx + 1]);
    psx.e = __ldg(ps + rc + coloff[tx + 2]);
    psx.w = __ldg(ps + rc + coloff[tx]);
    psx.n = __ldg(ps + rowoff[ty + 2] + coloff[tx + 1]);
    psx.s = __ldg(ps + rowoff[ty] + coloff[tx + 1]);
    float phisE = 0.0f, phisW = 0.0f, phisN = 0.0f, phisS = 0.0f;
    if (p.phi_s != nullptr) {   // whole domain: cur's own layout
        phisE = __ldg(p.phi_s + rc + coloff[tx + 2]);
        phisW = __ldg(p.phi_s + rc + coloff[tx]);
        phisN = __ldg(p.phi_s + rowoff[ty + 2] + coloff[tx + 1]);
        phisS = __ldg(p.phi_s + rowoff[ty] + coloff[tx + 1]);
    }
    const pe::Consts& kc = k.col;
    pe::ColumnTerms col;
    col.lnps_x = (logf(psx.e) - logf(psx.w)) * kc.cx;
    col.lnps_y = (logf(psx.n) - logf(psx.s)) * kc.cy;

    // the column in a plane, and the steps to its north and south
    // neighbours
    const int ci = (ty + 1) * PX + shift[ty + 1] + 1 + tx;
    const int dN = PX + shift[ty + 2] - shift[ty + 1];
    const int dS = -PX + shift[ty] - shift[ty + 1];
    float* const my_cum = cum + tid;

    // top-down: flux divergence of (ps u, ps v), cumulative over levels;
    // the ring holds TD levels of u and v, TD - 1 of them in flight
    constexpr int TD = SLOTS * NF / 2;
    float flux = 0.0f;
#pragma unroll 1
    for (int j = 0; j < TD - 1; ++j) {
        if (j < L && PE_STAGE_PROBE != 2) {
            load_level(j, ring + j * 2 * PLANE, 0, 2);
        }
        cp_async_commit();
    }
#pragma unroll 1
    for (int kk = 0; kk < L && PE_STAGE_PROBE != 2; ++kk) {
        cp_async_wait<TD - 2>();
        __syncthreads();
        const int nxt = kk + TD - 1;
        if (nxt < L) load_level(nxt, ring + (nxt % TD) * 2 * PLANE, 0, 2);
        cp_async_commit();
        const float* s = ring + (kk % TD) * 2 * PLANE;
        const float fd = pe::flux_divergence(psx, s[ci + 1], s[ci - 1],
                                             s[PLANE + ci + dN],
                                             s[PLANE + ci + dS], kc);
        flux = kk == 0 ? fd : flux + fd;
        my_cum[kk * NT] = flux;
    }
    cp_async_wait<0>();
    __syncthreads();    // the ring is free again

    const float dps = -flux * kc.dsig;
    const float inv_ps = 1.0f / psx.c;
    col.dps_over_ps = dps * inv_ps;
    const long long o = static_cast<long long>(y) * p.out_pitch + x;

    // bottom-up: phi at the four neighbour columns, sigma-dot carried;
    // levels kk and kk - 1 are read, the ring's other levels in flight
#pragma unroll 1
    for (int j = 0; j < SLOTS - 1; ++j) {
        const int lv = L - 1 - j;
        if (lv >= 0 && PE_STAGE_PROBE != 1) {
            load_level(lv, ring + (lv % SLOTS) * SLOT, 0, NF);
        }
        cp_async_commit();
    }
    float phiE = 0.0f, phiW = 0.0f, phiN = 0.0f, phiS = 0.0f;
    pe::Cross T;                               // T around the column at kk
    float uk = 0.0f, vk = 0.0f, qk = 0.0f;
    float sd_dn = 0.0f;
    float u_lo = 0.0f, v_lo = 0.0f, T_lo = 0.0f, q_lo = 0.0f;  // level kk+1
    // the bases' sums at level kk; the loads of level kk - 1 are in flight
    // through level kk's work
    float bu[NB], bv[NB], bT[NB], bq[NB];
    float au = 0.0f, av = 0.0f, aT = 0.0f, aq = 0.0f;
    if (inside) {
        const long long ok = (L - 1) * p.out_plane + o;
        load_bases(p, k, 0, ok, bu);
        load_bases(p, k, 1, ok, bv);
        load_bases(p, k, 2, ok, bT);
        load_bases(p, k, 3, ok, bq);
        au = base_sum(bu, k);
        av = base_sum(bv, k);
        aT = base_sum(bT, k);
        aq = base_sum(bq, k);
    }
#pragma unroll 1
    for (int kk = L - 1; kk >= 0 && PE_STAGE_PROBE != 1; --kk) {
        const long long ok = kk * p.out_plane + o;
        if (inside && kk > 0) {
            load_bases(p, k, 0, ok - p.out_plane, bu);
            load_bases(p, k, 1, ok - p.out_plane, bv);
            load_bases(p, k, 2, ok - p.out_plane, bT);
            load_bases(p, k, 3, ok - p.out_plane, bq);
        }
        cp_async_wait<SLOTS - 3>();
        __syncthreads();    // levels kk and kk - 1 are in the ring
        const int nxt = kk - (SLOTS - 1);
        if (nxt >= 0) load_level(nxt, ring + (nxt % SLOTS) * SLOT, 0, NF);
        cp_async_commit();

        const float* su = ring + (kk % SLOTS) * SLOT;
        const float* sv = su + PLANE;
        const float* sT = su + 2 * PLANE;
        const float* sq = su + 3 * PLANE;
        if (kk == L - 1) {
            T = {sT[ci], sT[ci + 1], sT[ci - 1], sT[ci + dN], sT[ci + dS]};
            phiE = kc.phibot * T.e + phisE;
            phiW = kc.phibot * T.w + phisW;
            phiN = kc.phibot * T.n + phisN;
            phiS = kc.phibot * T.s + phisS;
            uk = su[ci];
            vk = sv[ci];
            qk = sq[ci];
        }
        // level kk - 1: the centres, and T around the column
        pe::Cross Th = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float u_hi = 0.0f, v_hi = 0.0f, q_hi = 0.0f;
        if (kk > 0) {
            const float* h = ring + ((kk - 1) % SLOTS) * SLOT;
            const float* hT = h + 2 * PLANE;
            u_hi = h[ci];
            v_hi = h[PLANE + ci];
            q_hi = h[3 * PLANE + ci];
            Th = {hT[ci], hT[ci + 1], hT[ci - 1], hT[ci + dN], hT[ci + dS]};
        }
        const float sd_up = kk == 0 ? 0.0f
            : -0.5f * (static_cast<float>(kk) * col.dps_over_ps
                       + my_cum[(kk - 1) * NT] * inv_ps);
        const pe::Cross u = {uk, su[ci + 1], su[ci - 1], su[ci + dN],
                             su[ci + dS]};
        const pe::Cross v = {vk, sv[ci + 1], sv[ci - 1], sv[ci + dN],
                             sv[ci + dS]};
        const pe::Cross q = {qk, sq[ci + 1], sq[ci - 1], sq[ci + dN],
                             sq[ci + dS]};
        const float phi_x = (phiE - phiW) * kc.cx;
        const float phi_y = (phiN - phiS) * kc.cy;
        const pe::Tendency d = pe::level_tendency(
            u, v, T, q, u_hi, v_hi, Th.c, q_hi, u_lo, v_lo, T_lo, q_lo, phi_x,
            phi_y, sd_up, sd_dn, __ldg(p.levc + L + kk), kk == 0,
            kk == L - 1, col, kc);
        if (inside) {
            p.out[0][ok] = au + k.c_dt * d.du;
            p.out[1][ok] = av + k.c_dt * d.dv;
            p.out[2][ok] = aT + k.c_dt * d.dT;
            p.out[3][ok] = aq + k.c_dt * d.dq;
            if (kk > 0) {
                au = base_sum(bu, k);
                av = base_sum(bv, k);
                aT = base_sum(bT, k);
                aq = base_sum(bq, k);
            }
        }
        if (kk > 0) {
            const float thick = __ldg(p.levc + kk);
            phiE = phiE + thick * (Th.e + T.e);
            phiW = phiW + thick * (Th.w + T.w);
            phiN = phiN + thick * (Th.n + T.n);
            phiS = phiS + thick * (Th.s + T.s);
            sd_dn = sd_up;
            u_lo = uk; v_lo = vk; T_lo = T.c; q_lo = qk;
            uk = u_hi; vk = v_hi; qk = q_hi;
            T = Th;
        }
    }
    cp_async_wait<0>();
    if (inside) {
        float b[NB];
        load_bases(p, k, 4, o, b);
        p.out[4][o] = base_sum(b, k) + k.c_dt * dps;
    }
}

template <int TY, int NB>
cudaError_t prepare(int L) {
    const long long smem = smem_bytes(TY, L);
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(pe_stage_kernel<TY, NB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

template <int TY, int NB>
int launch(const Ptrs& p, const Consts& k, cudaStream_t stream) {
    cudaError_t err = prepare<TY, NB>(k.L);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((k.nx + TX - 1) / TX, (k.ny + TY - 1) / TY);
    const size_t smem = smem_bytes(TY, k.L);
    pe_stage_kernel<TY, NB><<<grid, TX * TY, smem, stream>>>(p, k);
    return static_cast<int>(cudaGetLastError());
}

// The built kernel of TY rows and NB bases at L levels: registers, local
// (spill) bytes a thread, dynamic shared bytes, threads, blocks per SM,
// static shared bytes.
template <int TY, int NB>
int attributes(int L, int* out) {
    cudaError_t err = prepare<TY, NB>(L);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes a;
    err = cudaFuncGetAttributes(&a, pe_stage_kernel<TY, NB>);
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pe_stage_kernel<TY, NB>, TX * TY, smem_bytes(TY, L));
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(smem_bytes(TY, L));
    out[3] = TX * TY;
    out[4] = per_sm;
    out[5] = static_cast<int>(a.sharedSizeBytes);
    return 0;
}

// Run f.run<TY, NB>() for tile rows `rows` (4, 2 or 1) and nbase bases (one
// instantiation for one base, one for 2 to 4).
template <class F>
int with_form(int rows, int nbase, const F& f) {
    const bool one = nbase == 1;
    switch (rows) {
        case 4: return one ? f.template run<4, 1>()
                           : f.template run<4, MAXB>();
        case 2: return one ? f.template run<2, 1>()
                           : f.template run<2, MAXB>();
        case 1: return one ? f.template run<1, 1>()
                           : f.template run<1, MAXB>();
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

struct Launch {
    const Ptrs& p;
    const Consts& k;
    cudaStream_t stream;
    template <int TY, int NB>
    int run() const { return launch<TY, NB>(p, k, stream); }
};

struct AttributeQuery {
    int L;
    int* out;
    template <int TY, int NB>
    int run() const { return attributes<TY, NB>(L, out); }
};

// tile_rows 0: the rule's; 4, 2 or 1 where the block fits; 0 otherwise.
int checked_rows(int L, int rows) {
    if (rows == 0) return tile_rows(L);
    if ((rows != 4 && rows != 2 && rows != 1) || L < 1 || L > kMaxLevels
        || smem_bytes(rows, L) > kSmemMax) {
        return 0;
    }
    return rows;
}

unsigned long long address(const void* q) {
    return reinterpret_cast<unsigned long long>(q);
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
// base, read at the same point first). tile_rows: 0 for the rule's tile
// height, or 4, 2 or 1 where that block fits. Returns the CUDA error code
// of the launch (0 on success).
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
    float phibot, float c_dt, int tile_rows, void* stream) {
    const int rows = checked_rows(L, tile_rows);
    if (nbase < 1 || nbase > MAXB || rows == 0 || ny < 1 || nx < 1
        || (halo_x && !halo_y) || (phi_s != nullptr && (halo_y || halo_x))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Ptrs p{{u, v, T, q, ps}, phi_s,
                 {{b0u, b0v, b0T, b0q, b0ps}, {b1u, b1v, b1T, b1q, b1ps},
                  {b2u, b2v, b2T, b2q, b2ps}, {b3u, b3v, b3T, b3q, b3ps}},
                 {ou, ov, oT, oq, ops}, levc, cur_pitch, cur_plane,
                 out_pitch, out_plane};
    // 16-byte chunks need the four fields at one offset from a 16-byte
    // boundary and whole 16-byte steps between planes; mode 2 also rows
    // and the interior's first column on 16-byte boundaries
    const unsigned long long a = address(u) % 16;
    const int chunks = a % 4 == 0 && address(v) % 16 == a
                       && address(T) % 16 == a && address(q) % 16 == a
                       && cur_plane % 4 == 0;
    const int aligned = chunks && a == 0 && cur_pitch % 4 == 0
                        && cur_ox % 4 == 0;
    const Consts k{{cx, cy, f, dsig, r_dry, kappa, phibot}, c_dt,
                   {c0, c1, c2, c3}, nbase, L, ny, nx, cur_oy, cur_ox,
                   halo_y, halo_x, chunks, aligned, static_cast<int>(a / 4)};
    return with_form(rows, nbase,
                     Launch{p, k, static_cast<cudaStream_t>(stream)});
}

// The built kernel the launch takes at L levels, tile_rows (as
// pe_stage_launch) and nbase bases: registers, spill bytes, dynamic shared
// bytes, threads, blocks per SM, static shared bytes and the tile's rows
// into out[7]. Returns the CUDA error code; cudaErrorInvalidValue where no
// block fits.
extern "C" int pe_stage_attributes(int L, int tile_rows, int nbase,
                                   int* out) {
    const int rows = checked_rows(L, tile_rows);
    out[6] = rows;
    if (nbase < 1 || nbase > MAXB) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return with_form(rows, nbase, AttributeQuery{L, out});
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* pe_stage_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
