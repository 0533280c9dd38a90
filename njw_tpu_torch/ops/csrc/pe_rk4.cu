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
// acc + 2 s2, then acc + s3, then acc/3 + dt/6 T(s3). The column arithmetic
// is pe_column.cuh's, the stage kernel's.
//
// Bound on this card: memory. The step must read s (4L + 1 planes) and
// phi_s once and write s' once: 2 (4L + 1) x 4 B = 648 B per column at
// L = 20, 170 MB at 512^2, 51 us at the H100 SXM's 3.35 TB/s. The four
// tendencies are about 4 x 116 flop per column and level plus the combine,
// 2.6 GFLOP at 512^2 x 20, 38 us at 67 TFLOP/s fp32.
//
// Why not the Pallas design: that kernel keeps three padded states of all
// 4L + 1 planes in VMEM for a whole tile. With the 4-point halo that is
// 3 x 81 x 16^2 x 4 B = 243 KB at an 8 x 8 output tile and L = 20, over the
// 227 KB of shared memory a block may have, so the stage states cannot
// live in shared memory.
//
// Design: the stage states live in a per-block scratch area in device
// memory. Each block takes output tiles of tile x tile columns in turn (a
// persistent grid: one block, and one scratch slot, for each block the
// device holds at once) and runs the four stages over shrinking regions,
// recomputing the halo as the Pallas kernel does:
//   stage 1  reads s from device memory (wrapped), writes s1 over the tile
//            and a 3-column halo into scratch A;
//   stage 2  reads A, writes s2 over a 2-column halo into scratch B;
//   stage 3  reads B, writes s3 over a 1-column halo into A (s1 is dead);
//   stage 4  reads A and finishes s' on the tile.
// The accumulator lives in the output itself: each block owns its tile's
// columns of s', so stages 1-3 add into them and stage 4 finishes them. A
// barrier separates the stages; scratch and output are read with plain
// (coherent) loads, s and phi_s through the read-only path. Every stage
// gives one thread one column at a time, as the stage kernel does; cum
// lives in shared memory, L floats per thread. Ragged tiles compute their
// wrapped columns but write only the columns inside the grid.
//
// Addressing (one launch for every launcher): s and out are each a view
// (base pointer, row pitch, plane pitch, origin of the (ny, nx) interior).
// Per axis (a template parameter) s either wraps (the whole periodic
// domain, and x of a row decomposition) or holds at least HALO = 4 rows
// (columns) of neighbour data around the interior, read in place of the
// wrap; there a ragged tile's columns past the last halo row (column) are
// clamped to it, and they feed only columns outside the interior. out may
// be an interior-shaped array or the interior of the next padded block.
// The whole-domain instantiation is the code it was before.
//
// What this costs on the H100: the stage work is bound by instruction
// issue and load latency, not by device memory (the stage kernel moves
// about half the card's memory rate: chip_smoke.py's pe_stage timing), so
// the device-memory passes the fusion saves buy little and
// the halo recompute (1.43x the stage work at tile 16) is paid in full.
// The registers are capped at 64 so that four blocks share an SM; that
// and tile 16 were the fastest of the layouts timed
// (scripts/profile_torch.py --model primitive).

#include <cuda_runtime.h>

#include "pe_column.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int MIN_BLOCKS = 4;      // blocks per SM the registers allow
constexpr int HALO = 4;            // one column per stage

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
    float* scratch;                 // gridDim.x x slot_floats
    Layout ls, lout;
};

struct Consts {
    pe::Consts col;
    float c_half, c_full;           // dt/2, dt
    float third, sixth;             // 1/3, dt/6
    int L, ny, nx, tile;
};

__device__ __forceinline__ int wrap(int a, int n) {
    a %= n;
    return a < 0 ? a + n : a;
}

// The row (column) a stage computes for the unwrapped index a, and its
// neighbours: modulo n on a wrap axis; on a halo axis a itself, at most
// n + HALO - 2 (so that its neighbours stay inside the block).
template <bool kHalo>
__device__ __forceinline__ int column_index(int a, int n) {
    if constexpr (kHalo) {
        return a < n + HALO - 2 ? a : n + HALO - 2;
    } else {
        return wrap(a, n);
    }
}

template <bool kHalo>
__device__ __forceinline__ int next(int a, int n) {
    return kHalo ? a + 1 : wrap(a + 1, n);
}

template <bool kHalo>
__device__ __forceinline__ int prev(int a, int n) {
    return kHalo ? a - 1 : wrap(a - 1, n);
}

// Stages 1-3: y = s + c d into scratch, and the accumulator on the tile.
template <int kStage>
struct StageEmit {
    const Ptrs& p;
    const Consts& k;
    float* dst;          // scratch region of this stage
    size_t dstP, dl;     // its plane size, this column's offset in it
    size_t gc, oc;       // this column's offset in s's and out's planes
    bool own;            // this column is one of the block's outputs

    __device__ __forceinline__ void put(int plane, int field, size_t gi,
                                        size_t go, float d) {
        const float c = kStage == 3 ? k.c_full : k.c_half;
        const float x = __ldg(p.s[field] + gi);
        const float y = x + c * d;
        dst[plane * dstP + dl] = y;
        if (own) {
            float* a = p.out[field] + go;
            if (kStage == 1) {
                *a = y - x;
            } else if (kStage == 2) {
                *a = *a + 2.0f * y;
            } else {
                *a = *a + y;
            }
        }
    }
    __device__ __forceinline__ void level(int kk, float du, float dv,
                                          float dT, float dq) {
        const size_t gi = kk * p.ls.plane + gc;
        const size_t go = kk * p.lout.plane + oc;
        put(kk, 0, gi, go, du);
        put(k.L + kk, 1, gi, go, dv);
        put(2 * k.L + kk, 2, gi, go, dT);
        put(3 * k.L + kk, 3, gi, go, dq);
    }
    __device__ __forceinline__ void surface(float dps) {
        put(4 * k.L, 4, gc, oc, dps);
    }
};

// Stage 4: s' = acc/3 + dt/6 d on the block's own columns.
struct FinalEmit {
    const Ptrs& p;
    const Consts& k;
    size_t oc;           // this column's offset in out's planes

    __device__ __forceinline__ void put(int field, size_t go, float d) {
        float* a = p.out[field] + go;
        *a = *a * k.third + k.sixth * d;
    }
    __device__ __forceinline__ void level(int kk, float du, float dv,
                                          float dT, float dq) {
        const size_t go = kk * p.lout.plane + oc;
        put(0, go, du);
        put(1, go, dv);
        put(2, go, dT);
        put(3, go, dq);
    }
    __device__ __forceinline__ void surface(float dps) { put(4, oc, dps); }
};

// One stage over the square region of edge E = tile + 2 h whose corner is
// (y0 - h, x0 - h). The source is s in device memory (kStage == 1) or the
// previous stage's region of edge E + 2 in scratch `src`.
template <int kStage, bool kHaloY, bool kHaloX>
__device__ __forceinline__ void run_stage(const Ptrs& p, const Consts& k,
                                          int y0, int x0, const float* src,
                                          float* dst, float* cum) {
    const int h = HALO - kStage;
    const int E = k.tile + 2 * h;
    const int Es = E + 2;                       // the source region's edge
    const int ny = k.ny, nx = k.nx, L = k.L;
    const size_t gP = static_cast<size_t>(p.ls.plane);
    const size_t sP = static_cast<size_t>(Es) * Es;
    for (int idx = threadIdx.x; idx < E * E; idx += NT) {
        const int r = idx / E, c = idx - (idx / E) * E;
        const int yr = y0 - h + r, xr = x0 - h + c;   // unwrapped
        const int gy = column_index<kHaloY>(yr, ny);
        const int gx = column_index<kHaloX>(xr, nx);
        const bool own = r >= h && r < h + k.tile && c >= h
                         && c < h + k.tile && yr < ny && xr < nx;
        if (kStage == 4 && !own) continue;
        const Layout& ls = p.ls;
        const pe::Nbrs g{ls.at(gy, gx), ls.at(gy, next<kHaloX>(gx, nx)),
                         ls.at(gy, prev<kHaloX>(gx, nx)),
                         ls.at(next<kHaloY>(gy, ny), gx),
                         ls.at(prev<kHaloY>(gy, ny), gx)};
        // out's offset of the column; meaningful where own
        const size_t oc = p.lout.at(yr, xr);
        float phisE = 0.0f, phisW = 0.0f, phisN = 0.0f, phisS = 0.0f;
        if (p.phi_s != nullptr) {
            phisE = __ldg(p.phi_s + g.e);
            phisW = __ldg(p.phi_s + g.w);
            phisN = __ldg(p.phi_s + g.n);
            phisS = __ldg(p.phi_s + g.s);
        }
        float dps;
        if constexpr (kStage == 1) {
            StageEmit<1> emit{p, k, dst, static_cast<size_t>(E) * E,
                              static_cast<size_t>(idx), g.c, oc, own};
            dps = pe::column_tendency<true, 1>(
                p.s[0], p.s[1], p.s[2], p.s[3], p.s[4], gP, g, phisE, phisW,
                phisN, phisS, cum, NT, p.levc, L, k.col, emit);
            emit.surface(dps);
        } else {
            const size_t lc = static_cast<size_t>(r + 1) * Es + (c + 1);
            const pe::Nbrs l{lc, lc + 1, lc - 1, lc + Es, lc - Es};
            const float* su = src;
            const float* sv = src + L * sP;
            const float* sT = src + 2 * L * sP;
            const float* sq = src + 3 * L * sP;
            const float* sps = src + 4 * L * sP;
            if constexpr (kStage == 4) {
                FinalEmit emit{p, k, oc};
                dps = pe::column_tendency<false, 1>(
                    su, sv, sT, sq, sps, sP, l, phisE, phisW, phisN, phisS,
                    cum, NT, p.levc, L, k.col, emit);
                emit.surface(dps);
            } else {
                StageEmit<kStage> emit{p, k, dst, static_cast<size_t>(E) * E,
                                       static_cast<size_t>(idx), g.c, oc,
                                       own};
                dps = pe::column_tendency<false, 1>(
                    su, sv, sT, sq, sps, sP, l, phisE, phisW, phisN, phisS,
                    cum, NT, p.levc, L, k.col, emit);
                emit.surface(dps);
            }
        }
    }
}

template <bool kHaloY, bool kHaloX>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) pe_rk4_kernel(
        Ptrs p, Consts k, size_t slot_floats) {
    extern __shared__ float cum_smem[];
    float* cum = cum_smem + threadIdx.x;        // stride NT
    const int fields = 4 * k.L + 1;
    float* A = p.scratch + blockIdx.x * slot_floats;
    float* B = A + static_cast<size_t>(fields) * (k.tile + 6) * (k.tile + 6);
    const int tiles_x = (k.nx + k.tile - 1) / k.tile;
    const int tiles = tiles_x * ((k.ny + k.tile - 1) / k.tile);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int y0 = (t / tiles_x) * k.tile, x0 = (t % tiles_x) * k.tile;
        run_stage<1, kHaloY, kHaloX>(p, k, y0, x0, nullptr, A, cum);
        __syncthreads();
        run_stage<2, kHaloY, kHaloX>(p, k, y0, x0, A, B, cum);
        __syncthreads();
        run_stage<3, kHaloY, kHaloX>(p, k, y0, x0, B, A, cum);
        __syncthreads();
        run_stage<4, kHaloY, kHaloX>(p, k, y0, x0, A, nullptr, cum);
        __syncthreads();                        // A is refilled next tile
    }
}

size_t smem_bytes(int L) { return static_cast<size_t>(L) * NT * sizeof(float); }

}  // namespace

// Floats of scratch one slot needs: the stage-1 and stage-2 regions.
extern "C" long long pe_rk4_slot_floats(int L, int tile) {
    const long long fields = 4LL * L + 1;
    return fields * ((tile + 6LL) * (tile + 6) + (tile + 4LL) * (tile + 4));
}

namespace {

template <bool kHaloY, bool kHaloX>
int allow_smem(size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        pe_rk4_kernel<kHaloY, kHaloX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <bool kHaloY, bool kHaloX>
int launch(const Ptrs& p, const Consts& k, int slots, cudaStream_t stream) {
    const size_t smem = smem_bytes(k.L);
    const int err = allow_smem<kHaloY, kHaloX>(smem);
    if (err != 0) return err;
    const long long tiles =
        static_cast<long long>((k.nx + k.tile - 1) / k.tile)
        * ((k.ny + k.tile - 1) / k.tile);
    const int grid = static_cast<int>(tiles < slots ? tiles : slots);
    pe_rk4_kernel<kHaloY, kHaloX><<<grid, NT, smem, stream>>>(
        p, k, static_cast<size_t>(pe_rk4_slot_floats(k.L, k.tile)));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many blocks of the kernel one SM of the current device holds at once
// (into *blocks). Returns the CUDA error code.
extern "C" int pe_rk4_blocks_per_sm(int L, int* blocks) {
    const size_t smem = smem_bytes(L);
    const int err = allow_smem<false, false>(smem);
    if (err != 0) return err;
    // every instantiation has the occupancy of the whole-domain one
    // (chip_smoke.py prints each one's ptxas registers)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, pe_rk4_kernel<false, false>, NT, smem));
}

// Launch one step of the (L, ny, nx) interior on `stream`: `slots` blocks
// (one scratch slot each, at most one per tile). s (u, v, T, q, ps, phi_s)
// and out are each given as the base pointers of their fields and a
// layout: row pitch, plane pitch of the 3-D fields, origin (row, column) of
// the interior. halo_y, halo_x: 1 where s holds at least HALO rows
// (columns) of neighbour data around the interior, 0 where that axis
// wraps; a halo in x needs one in y. out must not alias s. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int pe_rk4_launch(
    const float* u, const float* v, const float* T, const float* q,
    const float* ps, const float* phi_s, long long s_pitch,
    long long s_plane, int s_oy, int s_ox,
    float* ou, float* ov, float* oT, float* oq, float* ops,
    long long out_pitch, long long out_plane,
    const float* levc, float* scratch, int slots, int tile,
    int L, int ny, int nx, int halo_y, int halo_x,
    float cx, float cy, float f, float dsig, float r_dry, float kappa,
    float phibot, float c_half, float c_full, float third, float sixth,
    void* stream) {
    if (L < 1 || tile < 1 || slots < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Ptrs p{{u, v, T, q, ps}, phi_s, {ou, ov, oT, oq, ops}, levc,
                 scratch, {s_pitch, s_plane, s_oy, s_ox},
                 {out_pitch, out_plane, 0, 0}};
    const Consts k{{cx, cy, f, dsig, r_dry, kappa, phibot}, c_half, c_full,
                   third, sixth, L, ny, nx, tile};
    const auto st = static_cast<cudaStream_t>(stream);
    if (!halo_y && !halo_x) return launch<false, false>(p, k, slots, st);
    if (halo_y && !halo_x) return launch<true, false>(p, k, slots, st);
    if (halo_y && halo_x) return launch<true, true>(p, k, slots, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// Name of a CUDA error code, for the Python wrapper's messages.
extern "C" const char* pe_rk4_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
